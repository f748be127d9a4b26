"""Discriminative fine-tuning: MLP classifiers warm-started from RBM/DBM
weights (the JAX package's ``finetune.py``; the Keras + MultiAdam stage of
the reference examples), in PyTorch.

The network is an ``nn.Module`` whose dense kernels are kept as the JAX
package keeps them, ``W`` of shape (in, out), so warm starts, `get_weights`
and ``convert.mlp_from_jax`` move arrays without a transpose.  Batch norm
is written out (``nn.BatchNorm1d`` would update its running variance with
the unbiased batch variance; the JAX package uses the biased one).  The
training loop is plain Python over tensors on the model's device: Adam with
per-layer learning-rate multipliers on the dense ``W`` and ``b``
(``utils/optimizers.multi_adam``; batch-norm gamma/beta at the full rate),
L2 on the hidden kernels in the loss, early stopping and
reduce-LR-on-plateau.  The device is the card unless the caller asks for
the CPU (``device='cpu'``).
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .base.mixin import make_generator
from .base.torch_model import resolve_device
from .utils import one_hot, batch_iter
from .utils.optimizers import multi_adam, set_learning_rate
from .utils.rng import RNG

_ACTIVATIONS = {'sigmoid': torch.sigmoid, 'relu': torch.relu,
                'tanh': torch.tanh}

# running stats: 0.99 * old + 0.01 * batch statistic; eps inside rsqrt
BN_DECAY, BN_RATE, BN_EPS = 0.99, 0.01, 1e-5


def _activation(name):
    return _ACTIVATIONS.get(name) or getattr(F, name)


class Dense(nn.Module):
    """One dense layer ``h @ W + b`` (W of shape (in, out)), with optional
    batch norm: ``gamma``, ``beta`` and the running ``mean`` / ``var``."""

    def __init__(self, W, b, batch_norm=False, mean=None, var=None):
        super(Dense, self).__init__()
        self.W = nn.Parameter(W)
        self.b = nn.Parameter(b)
        self.batch_norm = bool(batch_norm)
        if self.batch_norm:
            self.gamma = nn.Parameter(torch.ones_like(b))
            self.beta = nn.Parameter(torch.zeros_like(b))
            self.register_buffer('mean', torch.zeros_like(b)
                                 if mean is None else mean)
            self.register_buffer('var', torch.ones_like(b)
                                 if var is None else var)

    def forward(self, h, train):
        h = h @ self.W + self.b
        if self.batch_norm:
            if train:
                mean = torch.mean(h, dim=0)
                var = torch.var(h, dim=0, unbiased=False)
                with torch.no_grad():
                    self.mean.copy_(BN_DECAY * self.mean + BN_RATE * mean)
                    self.var.copy_(BN_DECAY * self.var + BN_RATE * var)
            else:
                mean, var = self.mean, self.var
            h = self.gamma * (h - mean) * torch.rsqrt(var + BN_EPS) \
                + self.beta
        return h


class MLP(nn.Module):
    """Hidden `Dense` layers with their activations and dropout, and a
    linear head."""

    def __init__(self, dense, cfgs):
        super(MLP, self).__init__()
        self.dense = nn.ModuleList(dense)
        self.cfgs = cfgs

    def forward(self, X, train=False, generator=None):
        h = X
        for layer, cfg in zip(self.dense, self.cfgs):
            h = _activation(cfg.get('activation', 'sigmoid'))(
                layer(h, train))
            drop = cfg.get('dropout', 0.)
            if train and drop:
                keep = 1. - drop
                mask = torch.rand(h.shape, generator=generator,
                                  dtype=h.dtype, device=h.device) < keep
                h = torch.where(mask, h / keep, torch.zeros_like(h))
        return self.dense[-1](h, train)


def glorot_uniform(generator, shape, device):
    fan_in, fan_out = shape
    limit = np.sqrt(6. / (fan_in + fan_out))
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=device)
    return u * (2. * limit) - limit


class MLPClassifier(object):
    """Dense softmax classifier with per-layer warm starts.

    Parameters
    ----------
    layers : list of dict
        One per hidden layer:
          units : int
          activation : 'sigmoid' | 'relu' | 'tanh'
          weights : optional (W (in, out), b) warm-start arrays
          batch_norm : bool (default False)
          dropout : float drop-probability after the activation (default 0)
          lr_multiplier : float (default 1.) -- per-layer Adam multiplier
    n_classes : int
    l2 : weight-decay coefficient on hidden kernels (in the loss)
    learning_rate : base Adam learning rate
    early_stopping_patience / reduce_lr_patience / reduce_lr_factor /
    min_lr : Keras-style callbacks semantics (monitor = val accuracy or
    val loss via `val_metric`)
    device : the model's device (default: the CUDA device; raises where
    there is none)

    ``history_`` holds one dict per epoch of the last `fit`: ``epoch``,
    ``lr`` (the rate the epoch trained at), ``loss`` and, with validation
    data, ``val_loss`` and ``val_acc`` -- the numbers of the verbose lines.
    """

    def __init__(self, n_inputs, layers, n_classes=10, l2=1e-5,
                 learning_rate=1e-3, max_epoch=100, batch_size=128,
                 val_metric='val_acc', early_stopping_patience=12,
                 reduce_lr_patience=6, reduce_lr_factor=0.2, min_lr=1e-5,
                 random_seed=1337, verbose=True, device=None):
        self.n_inputs = n_inputs
        self.layers = layers
        self.n_classes = n_classes
        self.l2 = l2
        self.learning_rate = learning_rate
        self.max_epoch = max_epoch
        self.batch_size = batch_size
        self.val_metric = val_metric
        self.early_stopping_patience = early_stopping_patience
        self.reduce_lr_patience = reduce_lr_patience
        self.reduce_lr_factor = reduce_lr_factor
        self.min_lr = min_lr
        self.verbose = verbose
        self._device = resolve_device(device)
        self._rng = RNG(random_seed)
        self._net = None
        self.history_ = []

    # ------------------------------------------------------------------ #
    def _init_params(self):
        """Warm-start arrays where a layer has them, glorot-uniform kernels
        and zero biases elsewhere (the head included)."""
        g = make_generator(int(self._rng.randint(2 ** 31 - 1)),
                           self._device)
        params = []
        fan_in = self.n_inputs
        for cfg in self.layers + [dict(units=self.n_classes)]:
            units = cfg['units']
            if cfg.get('weights') is not None:
                W, b = cfg['weights']
            else:
                W = glorot_uniform(g, (fan_in, units), self._device)
                b = torch.zeros((units,), dtype=torch.float32)
            params.append({'W': W, 'b': b})
            fan_in = units
        self._build_net(params)

    def _build_net(self, params, bn_stats=None):
        """The network from per-layer ``{'W', 'b'[, 'gamma', 'beta']}``
        arrays and running batch-norm stats (``{'mean', 'var'}`` or None per
        layer), on the model's device."""
        def tensor(x):
            if not torch.is_tensor(x):
                x = np.array(x, dtype=np.float32)
            return torch.as_tensor(x, dtype=torch.float32,
                                   device=self._device).clone()

        cfgs = self.layers + [dict(units=self.n_classes)]
        bn_stats = bn_stats or [None] * len(cfgs)
        dense = []
        for cfg, p, st in zip(cfgs, params, bn_stats):
            bn = bool(cfg.get('batch_norm'))
            layer = Dense(tensor(p['W']), tensor(p['b']), batch_norm=bn,
                          mean=tensor(st['mean']) if bn and st else None,
                          var=tensor(st['var']) if bn and st else None)
            if bn and 'gamma' in p:
                with torch.no_grad():
                    layer.gamma.copy_(tensor(p['gamma']))
                    layer.beta.copy_(tensor(p['beta']))
            dense.append(layer)
        self._net = MLP(dense, self.layers)

    def _multipliers(self):
        """Per-layer lr multipliers on the dense kernel/bias only --
        batch-norm gamma/beta train at the full rate, as in the reference
        recipe where BN is a separate (unmatched) Keras layer."""
        mults = {}
        for i, cfg in enumerate(self.layers):
            m = float(cfg.get('lr_multiplier', 1.))
            mults['dense/{0}/W'.format(i)] = m
            mults['dense/{0}/b'.format(i)] = m
        return mults

    def _l2(self):
        return sum(torch.sum(torch.square(self._net.dense[i].W)) * self.l2
                   for i in range(len(self.layers)))

    def _train_step(self, opt, X, Y, generator):
        opt.zero_grad(set_to_none=True)
        logits = self._net(X, train=True, generator=generator)
        loss = F.cross_entropy(logits, Y) + self._l2()
        loss.backward()
        opt.step()
        return loss.detach()

    @torch.no_grad()
    def _evaluate(self, X, Y):
        logits = self._net(X, train=False)
        # the L2 term included, matching Keras' val_loss semantics
        loss = F.cross_entropy(logits, Y) + self._l2()
        acc = torch.mean((torch.argmax(logits, 1) ==
                          torch.argmax(Y, 1)).to(torch.float32))
        return float(loss), float(acc)

    def _tensor(self, X):
        return torch.as_tensor(np.asarray(X, np.float32), device=self._device)

    # ------------------------------------------------------------------ #
    def fit(self, X, y, X_val=None, y_val=None):
        """Train from the current parameters (a new Adam state each call):
        the first ``n // batch_size`` batches in order, then one step on the
        remainder rows, every epoch."""
        if self._net is None:
            self._init_params()
        X = np.asarray(X, np.float32)
        Y = one_hot(np.asarray(y), self.n_classes).astype(np.float32)
        B = self.batch_size
        nb = len(X) // B
        Xb, Yb = self._tensor(X[:nb * B]), self._tensor(Y[:nb * B])
        X_rem = self._tensor(X[nb * B:]) if len(X) % B else None
        Y_rem = self._tensor(Y[nb * B:]) if len(X) % B else None
        if X_val is not None:
            Xv = self._tensor(X_val)
            Yv = self._tensor(one_hot(np.asarray(y_val),
                                      self.n_classes).astype(np.float32))

        lr = self.learning_rate
        opt = multi_adam(self._net, learning_rate=lr,
                         lr_multipliers=self._multipliers())
        best = -np.inf
        stall_es = stall_rlr = 0
        g = make_generator(int(self._rng.randint(2 ** 31 - 1)), self._device)
        self.history_ = []
        for epoch in range(1, self.max_epoch + 1):
            losses = [self._train_step(opt, Xb[i * B:(i + 1) * B],
                                       Yb[i * B:(i + 1) * B], g)
                      for i in range(nb)]
            loss = torch.stack(losses).mean() if nb else None
            if X_rem is not None:
                rem_loss = self._train_step(opt, X_rem, Y_rem, g)
                if nb == 0:
                    loss = rem_loss
            loss = float(loss) if loss is not None else 0.
            record = {'epoch': epoch, 'lr': lr, 'loss': loss}
            self.history_.append(record)
            msg = 'mlp epoch {0}/{1}: loss {2:.4f}'.format(
                epoch, self.max_epoch, loss)
            if X_val is not None:
                vloss, vacc = self._evaluate(Xv, Yv)
                record.update(val_loss=vloss, val_acc=vacc)
                msg += '; val_loss {0:.4f}; val_acc {1:.4f}'.format(vloss,
                                                                   vacc)
                score = vacc if self.val_metric == 'val_acc' else -vloss
                if score > best + 1e-6:
                    best = score
                    stall_es = stall_rlr = 0
                else:
                    stall_es += 1
                    stall_rlr += 1
                if stall_rlr >= self.reduce_lr_patience and lr > self.min_lr:
                    lr = max(lr * self.reduce_lr_factor, self.min_lr)
                    set_learning_rate(opt, lr)
                    stall_rlr = 0
                    msg += '; reducing lr to {0:.2e}'.format(lr)
                if stall_es >= self.early_stopping_patience:
                    if self.verbose:
                        print(msg + '; early stopping')
                    break
            if self.verbose:
                print(msg)
        return self

    @torch.no_grad()
    def predict_proba(self, X):
        """Class probabilities, in batches of 4096 rows, with batch norm on
        its running stats and dropout off."""
        X = np.asarray(X, np.float32)
        out = [torch.softmax(self._net(self._tensor(Xb), train=False),
                             dim=-1).cpu().numpy()
               for Xb in batch_iter(X, batch_size=4096)]
        return np.concatenate(out, 0)

    def predict(self, X):
        return np.argmax(self.predict_proba(X), axis=1)

    def score(self, X, y):
        return float(np.mean(self.predict(X) == np.asarray(y)))

    def get_weights(self, layer):
        """(W (in, out), b) of `layer` as numpy arrays."""
        d = self._net.dense[layer]
        return (d.W.detach().cpu().numpy(), d.b.detach().cpu().numpy())
