"""Generic RBM with k-step Contrastive Divergence, in PyTorch.

The counterpart of the JAX package's ``rbm/base_rbm.py``:

* model state is an ``RBMState`` module with buffers {W, vb, hb, dW, dvb,
  dhb, q_means} on the model's device (``convert.py``);
* the pure ops below (chain, CD statistics, update, metrics) are plain
  tensor functions -- the generic path, the counterpart of JAX's XLA path;
* on a CUDA device a float32 model without dropout, with Bernoulli or
  Gaussian visible and Bernoulli or multinomial hidden units, trains
  through the hand-written CD epoch kernels (``ops/cd_epoch.py``) at any
  size, as the JAX package picks its fused Pallas kernels on a TPU (where
  a big W takes the tiled kernel and loses PLL, and a multinomial one
  too big for VMEM the XLA path);
* with a data-parallel mesh (``set_mesh(parallel.make_mesh())``, one
  process per device, every process calling ``fit`` with the whole data)
  each rank trains on its rows of every minibatch: the CD-k sums of its
  rows (the stats kernels of ``ops/cd_stats.py`` on CUDA, else the generic
  body), one ``all_reduce`` of them per step, and the same update on every
  rank -- the JAX package's shard_map epoch.  Only rank 0 writes
  checkpoints, summaries and the verbose lines;
* randomness: each ``fit`` draws one op seed from the persisted host RNG
  (on a mesh, rank 0's, with its state broadcast to every rank); per-epoch
  seeds derive from it, seeding a ``torch.Generator`` (generic path) or
  keying the kernels' Philox stream.

Semantics follow the reference exactly: the momentum rule
``acc <- lr * (m * acc + grad); param += acc``, the EMA sparsity penalty on
summed hidden means, dbm_first/dbm_last input doubling, PLL via a single
randomly flipped unit scaled by n_visible, and the free-energy gap.
Histogram and image summaries are not ported yet: ``display_filters`` or
``display_hidden_activations`` above 0 makes ``fit`` raise.
"""

import numpy as np
import torch
import torch.nn.functional as F

from ..base import is_attribute_name
from ..base.mixin import make_generator
from ..convert import RBMState, state_from_jax_arrays, state_to_numpy
from ..ebm import EnergyBasedModel
from ..layers import BernoulliLayer, GaussianLayer, MultinomialLayer
from ..ops.cd_epoch import make_cd_epoch_kernel, pll_flip_index
from ..ops.cd_stats import make_cd_stats_kernel, split_stats
from ..parallel.mesh import replicate
from ..utils import (make_list_from, epoch_iter, schedule_value,
                     write_during_training)
from ..utils.testing import assert_len, assert_shape

# seed salts of the per-epoch streams (the JAX package folds the same
# offsets into its fit key); a rank's generic stream on the mesh salts the
# epoch seed with its rank
_VAL_SALT = 100000
_FEG_SALT = 200000
_SHARD_SALT = 300000


def derive_seed(seed, salt):
    """A 31-bit seed derived from (`seed`, `salt`)."""
    ss = np.random.SeedSequence([int(seed), int(salt)])
    return int(ss.generate_state(1, np.uint32)[0]) & 0x7FFFFFFF


class BaseRBM(EnergyBasedModel):
    """A generic Restricted Boltzmann Machine trained with CD-k.

    Parameters mirror the JAX package's ``BaseRBM`` (and so the reference);
    highlights:

    n_visible, n_hidden : positive int
    W_init : float (stddev of zero-centered Gaussian) or (V, H) array
    vb_init, hb_init : float or array
    n_gibbs_steps, learning_rate, momentum : value or per-epoch schedule
    max_epoch, batch_size, l2 : training params
    sample_v_states, sample_h_states : bool
    dropout : None or float -- keep-probability of visible units.
    sparsity_target, sparsity_cost, sparsity_damping : EMA sparsity penalty.
    dbm_first, dbm_last : double inputs to compensate single-sided evidence
        during DBM pre-training (Salakhutdinov & Hinton 2009).
    metrics_config : dict -- which metrics (msre/pll/l2_loss/feg), formats,
        and cadences to compute.
    kernel : 'auto' picks the CUDA CD epoch kernels when the model is
        eligible; 'xla' forces the generic path; 'pallas' forces the
        kernels (the JAX values, kept so checkpoints load both ways).
    device : torch device of the model state (private, never persisted);
        default: the CUDA device (without one, pass ``device='cpu'``).
    """

    def __init__(self,
                 n_visible=784, v_layer_cls=None, v_layer_params=None,
                 n_hidden=256, h_layer_cls=None, h_layer_params=None,
                 W_init=0.01, vb_init=0., hb_init=0., n_gibbs_steps=1,
                 learning_rate=0.01, momentum=0.9, max_epoch=10, batch_size=10,
                 l2=1e-4, sample_v_states=False, sample_h_states=True,
                 dropout=None,
                 sparsity_target=0.1, sparsity_cost=0., sparsity_damping=0.9,
                 dbm_first=False, dbm_last=False,
                 metrics_config=None, verbose=True, save_after_each_epoch=True,
                 checkpoint_every_epoch=1, summaries_every_epoch=1,
                 display_filters=0, display_hidden_activations=0,
                 v_shape=(28, 28), kernel='auto',
                 model_path='rbm_model/', *args, **kwargs):
        super(BaseRBM, self).__init__(model_path=model_path, *args, **kwargs)
        self.n_visible = n_visible
        self.n_hidden = n_hidden

        v_layer_params = v_layer_params or {}
        v_layer_params.setdefault('n_units', self.n_visible)
        v_layer_params.setdefault('dtype', self.dtype)
        h_layer_params = h_layer_params or {}
        h_layer_params.setdefault('n_units', self.n_hidden)
        h_layer_params.setdefault('dtype', self.dtype)
        self._v_layer = v_layer_cls(**v_layer_params)
        self._h_layer = h_layer_cls(**h_layer_params)

        self.W_init = W_init
        if hasattr(self.W_init, '__iter__'):
            self.W_init = np.asarray(self.W_init)
            assert_shape(self, 'W_init', (self.n_visible, self.n_hidden))

        self.vb_init = vb_init
        if hasattr(self.vb_init, '__iter__'):
            self.vb_init = np.asarray(self.vb_init)
            assert_len(self, 'vb_init', self.n_visible)

        self.hb_init = hb_init
        if hasattr(self.hb_init, '__iter__'):
            self.hb_init = np.asarray(self.hb_init)
            assert_len(self, 'hb_init', self.n_hidden)

        # set by `init_from`
        self._dW_init = None
        self._dvb_init = None
        self._dhb_init = None

        self.n_gibbs_steps = make_list_from(n_gibbs_steps)
        self.learning_rate = make_list_from(learning_rate)
        self.momentum = make_list_from(momentum)
        self.max_epoch = max_epoch
        self.batch_size = batch_size
        self.l2 = l2

        self.sample_h_states = sample_h_states
        self.sample_v_states = sample_v_states
        self.dropout = dropout

        self.sparsity_target = sparsity_target
        self.sparsity_cost = sparsity_cost
        self.sparsity_damping = sparsity_damping

        self.dbm_first = dbm_first
        self.dbm_last = dbm_last

        self.metrics_config = dict(metrics_config or {})
        self.metrics_config.setdefault('l2_loss', False)
        self.metrics_config.setdefault('msre', False)
        self.metrics_config.setdefault('pll', False)
        self.metrics_config.setdefault('feg', False)
        self.metrics_config.setdefault('l2_loss_fmt', '.2e')
        self.metrics_config.setdefault('msre_fmt', '.4f')
        self.metrics_config.setdefault('pll_fmt', '.3f')
        self.metrics_config.setdefault('feg_fmt', '.2f')
        self.metrics_config.setdefault('train_metrics_every_iter', 10)
        self.metrics_config.setdefault('val_metrics_every_epoch', 1)
        self.metrics_config.setdefault('feg_every_epoch', 2)
        self.metrics_config.setdefault('n_batches_for_feg', 10)

        self.verbose = verbose
        self.save_after_each_epoch = save_after_each_epoch
        self.checkpoint_every_epoch = int(checkpoint_every_epoch)
        self.summaries_every_epoch = int(summaries_every_epoch)

        assert self.n_hidden >= display_filters
        self.display_filters = display_filters
        assert self.n_hidden >= display_hidden_activations
        self.display_hidden_activations = display_hidden_activations

        self.v_shape = tuple(v_shape)
        if len(self.v_shape) == 2:
            self.v_shape = (self.v_shape[0], self.v_shape[1], 1)

        if kernel not in ('auto', 'xla', 'pallas'):
            raise ValueError("kernel must be 'auto', 'xla' or 'pallas'")
        self.kernel = kernel

        # current epoch and iteration
        self.epoch_ = 0
        self.iter_ = 0

        # RBMState module (None until first init/fit/load)
        self._state = None
        # data-parallel mesh (parallel.make_mesh()), None for one device
        self._mesh = None
        # cache of built epoch programs, invalidated when hyperparams change
        self._programs = {}

    # ================================================================== #
    # state management                                                    #
    # ================================================================== #
    def _init_state(self):
        # params.json drops arrays >1e6 elements (base/base_model.py); after
        # load_model those live only in model.npz
        for name in ('W_init', 'vb_init', 'hb_init'):
            if getattr(self, name) is None:
                raise RuntimeError(
                    '`{0}` is None: it was too large for params.json and '
                    'must be restored from the model.npz checkpoint '
                    '(missing or corrupt?) before initializing state'
                    .format(name))
        dtype, dev = self._torch_dtype, self._device
        _, g = self.make_generator(dev)
        V, H = self.n_visible, self.n_hidden

        def tensor(x):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

        def param(init, n):
            if hasattr(init, '__iter__'):
                return tensor(init)
            return torch.full((n,), float(init), dtype=dtype, device=dev)

        def acc(init, shape):
            if init is not None:
                return tensor(init)
            return torch.zeros(shape, dtype=dtype, device=dev)

        if hasattr(self.W_init, '__iter__'):
            W = tensor(self.W_init)
        else:
            W = float(self.W_init) * torch.randn((V, H), generator=g,
                                                 dtype=dtype, device=dev)
        self._state = RBMState({
            'W': W, 'vb': param(self.vb_init, V), 'hb': param(self.hb_init, H),
            'dW': acc(self._dW_init, (V, H)), 'dvb': acc(self._dvb_init, (V,)),
            'dhb': acc(self._dhb_init, (H,)),
            'q_means': torch.zeros((H,), dtype=dtype, device=dev),
        })

    def _ensure_state(self):
        if self._state is None:
            self._init_state()

    def _get_state_arrays(self):
        self._ensure_state()
        return state_to_numpy(self._state)

    def _set_state_arrays(self, arrays):
        self._state = state_from_jax_arrays(arrays, self._device,
                                            self._torch_dtype)

    def set_params(self, **params):
        self._programs = {}  # hyperparams may have changed -> rebuild
        return super(BaseRBM, self).set_params(**params)

    def set_mesh(self, mesh, data_axis='data', model_axis=None):
        """Attach a data-parallel mesh (``parallel.make_mesh()``): training
        batches are split over its ranks along `data_axis`, their CD
        statistics summed by ``all_reduce``.  A `model_axis` (tensor-parallel
        W) is not ported."""
        if model_axis is not None:
            raise NotImplementedError('model_axis: tensor-parallel W is not '
                                      'ported yet (ROADMAP.md Queue A9)')
        if data_axis not in mesh.axis_names:
            raise ValueError('the mesh has no axis {0!r}'.format(data_axis))
        self._mesh = mesh
        self._programs = {}
        return self

    def _writes_files(self):
        return self._mesh is None or self._mesh.rank == 0

    # ================================================================== #
    # pure ops (the generic path)                                         #
    # ================================================================== #
    @property
    def _propup_multiplier(self):
        return 2. if self.dbm_first else 1.

    @property
    def _propdown_multiplier(self):
        return 2. if self.dbm_last else 1.

    def _means_h_given_v(self, state, v):
        m = self._propup_multiplier
        x = m * (v @ state['W'])
        return self._h_layer.activation(x, m * state['hb'])

    def _means_v_given_h(self, state, h):
        m = self._propdown_multiplier
        x = m * (h @ state['W'].T)
        return self._v_layer.activation(x, m * state['vb'])

    def _gibbs_chain(self, state, h_states, k, generator):
        """Run `k` block-Gibbs steps starting from hidden states; returns
        the final (v_states, v_means, h_states, h_means)."""
        B = h_states.shape[0]
        v_states = v_means = h_states.new_zeros((B, self.n_visible))
        h_means = torch.zeros_like(h_states)
        for _ in range(k):
            v_means = self._means_v_given_h(state, h_states)
            v_states = (self._v_layer.sample(generator, v_means)
                        if self.sample_v_states else v_means)
            h_means = self._means_h_given_v(state, v_states)
            h_states = (self._h_layer.sample(generator, h_means)
                        if self.sample_h_states else h_means)
        return v_states, v_means, h_states, h_means

    def _maybe_dropout(self, generator, X):
        """Dropout on the input, seen by every consumer (reference
        base_rbm.py:417-418)."""
        if self.dropout is None:
            return X
        keep = float(self.dropout)
        mask = torch.rand(X.shape, generator=generator, dtype=X.dtype,
                          device=X.device) < keep
        return torch.where(mask, X / keep, torch.zeros_like(X))

    def _h_states0(self, state, X, generator):
        h0_means = self._means_h_given_v(state, X)
        h_states = (self._h_layer.sample(generator, h0_means)
                    if self.sample_h_states else h0_means)
        return h0_means, h_states

    def _cd_stats(self, state, X_batch, k, generator):
        """CD-k sufficient statistics of one minibatch: the raw *sums*.
        Returns (stats, aux); `_apply_cd_update` completes the update."""
        X = self._maybe_dropout(generator, X_batch)
        h0_means, h_states = self._h_states0(state, X, generator)
        v_states, v_means, _, h_means = self._gibbs_chain(state, h_states, k,
                                                          generator)
        stats = {
            'assoc': X.T @ h0_means - v_states.T @ h_means,
            'dvb_sum': torch.sum(X - v_states, dim=0),
            'dhb_sum': torch.sum(h0_means - h_means, dim=0),
            'h_sum': torch.sum(h_means, dim=0),
        }
        aux = {'X': X, 'v_means': v_means}
        return stats, aux

    def _apply_cd_update(self, state, stats, N, lr, momentum):
        """The reference momentum rule ``acc <- lr * (m * acc + grad);
        param += acc`` with L2 on dW and the EMA sparsity penalty on summed
        hidden means."""
        dW = stats['assoc'] / N - self.l2 * state['W']
        dvb = stats['dvb_sum'] / N
        dhb = stats['dhb_sum'] / N

        damping = self.sparsity_damping
        q_new = damping * state['q_means'] + (1. - damping) * stats['h_sum']
        penalty = self.sparsity_cost * (q_new - self.sparsity_target)
        dhb = dhb - penalty
        dW = dW - penalty  # broadcast over visible rows

        lr, momentum = float(lr), float(momentum)
        dW_acc = lr * (momentum * state['dW'] + dW)
        dvb_acc = lr * (momentum * state['dvb'] + dvb)
        dhb_acc = lr * (momentum * state['dhb'] + dhb)
        return {
            'W': state['W'] + dW_acc,
            'vb': state['vb'] + dvb_acc,
            'hb': state['hb'] + dhb_acc,
            'dW': dW_acc, 'dvb': dvb_acc, 'dhb': dhb_acc,
            'q_means': q_new,
        }

    def _cd_step(self, state, X_batch, lr, momentum, k, generator):
        """One CD-k parameter update; returns (new_state, aux)."""
        stats, aux = self._cd_stats(state, X_batch, k, generator)
        new_state = self._apply_cd_update(state, stats, X_batch.shape[0],
                                          lr, momentum)
        return new_state, aux

    def _pll(self, state, X, generator):
        """Pseudo-log-likelihood proxy: corrupt one random unit per sample,
        PLL = n_visible * log_sigmoid(FE(x~) - FE(x)) with batch-mean free
        energies."""
        B = X.shape[0]
        idx = torch.randint(0, self.n_visible, (B,), generator=generator,
                            device=X.device)
        rows = torch.arange(B, device=X.device)
        flipped = X.clone()
        flipped[rows, idx] = 1. - X[rows, idx]
        fe_x = self._free_energy(state, X, generator)
        fe_flipped = self._free_energy(state, flipped, generator)
        return self.n_visible * F.logsigmoid(fe_flipped - fe_x)

    def _metrics(self, state, X, v_means, generator):
        out = {'msre': torch.mean(torch.square(X - v_means))}
        out['pll'] = (self._pll(state, X, generator)
                      if self.metrics_config['pll'] else torch.zeros_like(
                          out['msre']))
        out['l2_loss'] = self.l2 * 0.5 * torch.sum(torch.square(state['W']))
        return out

    # ================================================================== #
    # training epochs                                                     #
    # ================================================================== #
    def _program(self, name, make):
        if name not in self._programs:
            self._programs[name] = make()
        return self._programs[name]

    def _kernel_flavours(self):
        """(visible, sigma, hidden, n_samples) of the CD epoch kernels, or
        None for unit types they do not take."""
        v, h = self._v_layer, self._h_layer
        if isinstance(v, BernoulliLayer):
            visible, sigma = 'bernoulli', None
        elif isinstance(v, GaussianLayer):
            visible, sigma = 'gaussian', np.asarray(v.sigma, np.float32)
        else:
            return None
        if isinstance(h, BernoulliLayer):
            return visible, sigma, 'bernoulli', None
        if isinstance(h, MultinomialLayer):
            return visible, sigma, 'multinomial', int(h.n_samples)
        return None

    def _kernel_eligible(self):
        """The CUDA CD epoch kernels cover Bernoulli or Gaussian visible
        units with Bernoulli or multinomial hidden units, in float32 without
        dropout, on a CUDA device, at any size and with PLL -- decided once
        per fit from the configuration."""
        if self.kernel == 'xla':
            return False
        ok = (self._kernel_flavours() is not None
              and self.dtype == 'float32'
              and self.dropout is None
              and self._device.type == 'cuda')
        if self.kernel == 'pallas' and not ok:
            raise ValueError('kernel="pallas" requested but the model is '
                             'not eligible for the CUDA CD epoch kernels')
        return ok

    def _cd_epoch_program(self, k):
        visible, sigma, hidden, n_samples = self._kernel_flavours()
        return make_cd_epoch_kernel(
            self.n_visible, self.n_hidden, self.batch_size, k,
            sample_v_states=self.sample_v_states,
            sample_h_states=self.sample_h_states,
            propup_mult=self._propup_multiplier,
            propdown_mult=self._propdown_multiplier,
            l2=float(self.l2), sparsity_target=float(self.sparsity_target),
            sparsity_cost=float(self.sparsity_cost),
            sparsity_damping=float(self.sparsity_damping),
            metrics_every=int(self.metrics_config['train_metrics_every_iter']),
            compute_pll=bool(self.metrics_config['pll']),
            visible=visible, sigma=sigma, hidden=hidden, n_samples=n_samples)

    def _train_epoch_kernel(self, full, rem, lr, mom, k, seed):
        """One epoch through the CD epoch kernels: the full batches in one
        call, then the remainder batch with its own row count.  Returns the
        (msre, pll, l2) rows of every iteration."""
        epoch = self._program(('cd_epoch', k),
                              lambda: self._cd_epoch_program(k))
        rows = []
        for X_batches in (full, None if rem is None else rem[None]):
            if X_batches is None or not X_batches.shape[0]:
                continue
            state, msre, pll, l2 = epoch(self._state.as_dict(), X_batches,
                                         lr, mom, seed, self.iter_)
            self._state.update(state)
            self.iter_ += int(X_batches.shape[0])
            rows.append(torch.stack([msre, pll, l2]))
        return rows

    # ------------------- data-parallel (mesh) epoch --------------------- #
    def _shardmap_eligible(self):
        """Mesh training runs the data-parallel epoch (per-rank CD sums, an
        all_reduce, a replicated update) unless the user forced
        kernel='xla' or the batch does not split over the ranks; then every
        rank trains the whole batches through the single-device path (JAX
        base_rbm.py:503-526, whose GSPMD fallback gives that result)."""
        if self._mesh is None or self.kernel == 'xla':
            return False
        return self.batch_size % self._mesh.size == 0

    def _stats_kernel_eligible(self):
        """The CUDA stats kernels take Bernoulli or Gaussian visible units
        with Bernoulli hidden units, float32, no dropout, on a CUDA device
        (JAX base_rbm.py:528-568 without its VMEM budgets); otherwise the
        epoch runs the generic ``_cd_stats`` body, as the JAX package runs
        its lax body."""
        flavours = self._kernel_flavours()
        return (self.kernel != 'xla' and flavours is not None
                and flavours[2] == 'bernoulli'
                and self.dtype == 'float32' and self.dropout is None
                and self._device.type == 'cuda')

    def _cd_stats_program(self, k):
        visible, sigma, _, _ = self._kernel_flavours()
        return make_cd_stats_kernel(
            self.n_visible, self.n_hidden,
            self.batch_size // self._mesh.size, k,
            sample_v_states=self.sample_v_states,
            sample_h_states=self.sample_h_states,
            propup_mult=self._propup_multiplier,
            propdown_mult=self._propdown_multiplier,
            visible=visible, sigma=sigma)

    def _train_epoch_shardmap(self, full, rem, lr, mom, k, seed):
        """One epoch over the mesh (JAX `_shardmap_epoch_core`,
        base_rbm.py:570-739).  `full` holds this rank's rows of every full
        batch.  Per batch: the CD-k sums of the local rows, written into one
        flat buffer [assoc | dvb_sum | dhb_sum | h_sum], one all_reduce(SUM)
        of it, and the update with N = batch_size on every rank.  On a
        cadence iteration the local sum of squared reconstruction errors
        and the local batch-mean free energies of x and of x with one unit
        per row flipped (Philox, per (it, rank)) are kept; they are reduced
        in one all_reduce per epoch.  The remainder batch runs replicated
        through the single-device step (on CUDA the CD epoch kernels, shard
        0).  Returns the (msre, pll, l2) rows of every iteration."""
        import torch.distributed as dist
        mesh = self._mesh
        every = int(self.metrics_config['train_metrics_every_iter'])
        want_pll = bool(self.metrics_config['pll'])
        V, H, N = self.n_visible, self.n_hidden, self.batch_size
        dev, dtype = self._device, self._torch_dtype
        nb = int(full.shape[0])
        stats_fn = self._program(('cd_stats', k),
                                 lambda: self._cd_stats_program(k)) \
            if self._stats_kernel_eligible() else None
        g = make_generator(derive_seed(seed, _SHARD_SALT + mesh.rank), dev)
        flat = torch.empty(V * H + V + 2 * H, dtype=dtype, device=dev)
        sums = split_stats(flat, V, H)
        # local metric parts per batch: sum of squares, fe(x), fe(x flipped)
        parts = torch.zeros((3, nb), dtype=dtype, device=dev)
        l2_row = torch.zeros(nb, dtype=dtype, device=dev)
        iters = self.iter_ + 1 + np.arange(nb)
        state = self._state.as_dict()
        for i in range(nb):
            self.iter_ += 1
            it = self.iter_
            if stats_fn is not None:
                _, aux = stats_fn(state, full[i], seed, it, mesh.rank,
                                  out=flat)
            else:
                stats, aux = self._cd_stats(state, full[i], k, g)
                for key, view in sums.items():
                    view.copy_(stats[key])
            dist.all_reduce(flat, group=mesh.group)
            state = self._apply_cd_update(state, sums, N, lr, mom)
            if it % every:
                continue
            X = aux['X']
            parts[0, i] = torch.sum(torch.square(X - aux['v_means']))
            if want_pll:
                rows = torch.arange(X.shape[0], device=dev)
                flip = pll_flip_index(seed, it, X.shape[0], V, dev,
                                      mesh.rank)
                Xf = X.clone()
                Xf[rows, flip] = 1. - X[rows, flip]
                parts[1, i] = self._free_energy(state, X, g)
                parts[2, i] = self._free_energy(state, Xf, g)
            l2_row[i] = self.l2 * 0.5 * torch.sum(torch.square(state['W']))
        self._state.update(state)
        out = []
        if nb:
            dist.all_reduce(parts, group=mesh.group)
            msre = parts[0] / (N * V)
            pll = torch.zeros_like(msre)
            if want_pll:
                # batch-mean free energies over equal shards: the mean of
                # the ranks' means
                fe_x, fe_f = parts[1] / mesh.size, parts[2] / mesh.size
                logged = torch.as_tensor(iters % every == 0, device=dev)
                pll = torch.where(logged, V * F.logsigmoid(fe_f - fe_x), pll)
            out.append(torch.stack([msre, pll, l2_row]))
        if rem is not None:
            out += self._train_epoch_kernel(None, rem, lr, mom, k, seed) \
                if self._kernel_eligible() else \
                self._train_epoch_generic((), rem, lr, mom, k, seed)
        return out

    def _train_epoch_generic(self, full, rem, lr, mom, k, seed):
        """One epoch on the generic path (the JAX package's XLA epoch plus
        its remainder step)."""
        every = int(self.metrics_config['train_metrics_every_iter'])
        g = make_generator(seed, self._device)
        state = self._state.as_dict()
        batches = list(full) + ([] if rem is None else [rem])
        rows = torch.zeros((3, len(batches)), dtype=self._torch_dtype,
                           device=self._device)
        for i, X_batch in enumerate(batches):
            self.iter_ += 1
            state, aux = self._cd_step(state, X_batch, lr, mom, k, g)
            if self.iter_ % every == 0:
                m = self._metrics(state, aux['X'], aux['v_means'], g)
                rows[:, i] = torch.stack([m['msre'], m['pll'], m['l2_loss']])
        self._state.update(state)
        return [rows]

    def _reduce_train_metrics(self, rows, mask):
        """Means of the logged iterations' metric rows."""
        results = {}
        for i, name in enumerate(('msre', 'pll', 'l2_loss')):
            if self.metrics_config[name]:
                results[name] = float(rows[i][mask].mean())
        return results

    # ================================================================== #
    # data staging                                                        #
    # ================================================================== #
    def _preprocess(self, X):
        """Input hook (GaussianRBM divides by sigma)."""
        return np.asarray(X, dtype=self._np_dtype)

    def _stage_batches(self, X, rows=None):
        """Split X into (full_batches, remainder, n_full) tensors on the
        model's device; `rows` (a slice) keeps only those rows of every
        full batch (a rank's share on the mesh)."""
        X = self._preprocess(X)
        B = self.batch_size
        n_full = len(X) // B
        full = X[:n_full * B].reshape(n_full, B, self.n_visible)
        if rows is not None:
            full = full[:, rows]
        full = torch.as_tensor(np.ascontiguousarray(full),
                               device=self._device)
        rem = X[n_full * B:]
        rem = torch.as_tensor(np.ascontiguousarray(rem),
                              device=self._device) if len(rem) else None
        return full, rem, n_full

    def _batches(self, staged):
        full, rem, _ = staged
        return list(full) + ([] if rem is None else [rem])

    # ================================================================== #
    # fit / metrics loops                                                 #
    # ================================================================== #
    def _val_metrics(self, staged_val, k):
        """Validation msre (and pll) over the staged validation set."""
        g = make_generator(derive_seed(self._fit_seed,
                                       _VAL_SALT + self.epoch_),
                           self._device)
        state = self._state.as_dict()
        msres, plls = [], []
        for X_batch in self._batches(staged_val):
            X = self._maybe_dropout(g, X_batch)
            _, h_states = self._h_states0(state, X, g)
            _, v_means, _, _ = self._gibbs_chain(state, h_states, k, g)
            msres.append(torch.mean(torch.square(X - v_means)))
            if self.metrics_config['pll']:
                plls.append(self._pll(state, X, g))
        results = {}
        if self.metrics_config['msre']:
            results['msre'] = float(np.mean(torch.stack(msres).cpu().numpy()))
        if self.metrics_config['pll']:
            results['pll'] = float(np.mean(torch.stack(plls).cpu().numpy()))
        return results

    def _feg(self, staged_train, staged_val):
        """Free-energy gap between a fixed number of train and validation
        batches -- an overfitting monitor (reference base_rbm.py:592-621)."""
        g = make_generator(derive_seed(self._fit_seed,
                                       _FEG_SALT + self.epoch_),
                           self._device)
        n = self.metrics_config['n_batches_for_feg']
        state = self._state.as_dict()

        def side(staged):
            full, rem, _ = staged
            nb = min(n, int(full.shape[0]))
            batches = list(full[:nb])
            if nb < n and rem is not None:
                batches.append(rem)
            fes = [self._free_energy(state, self._maybe_dropout(g, X), g)
                   for X in batches]
            return np.mean(torch.stack(fes).cpu().numpy())

        val_fe = side(staged_val)
        train_fe = side(staged_train)
        return float(val_fe - train_fe)

    def _init_writers(self):
        from ..utils.summary_writer import SummaryWriter
        if getattr(self, '_train_writer', None) is None:
            self._train_writer = SummaryWriter(self._train_summary_dirpath)
            self._val_writer = SummaryWriter(self._val_summary_dirpath)

    _metrics_names_map = {
        'feg': 'free_energy_gap',
        'l2_loss': 'l2_loss',
        'msre': 'mean_squared_reconstruction_error',
        'pll': 'pseudo_loglikelihood',
    }

    def _fit(self, X, X_val=None, *args, **kwargs):
        if self.display_filters or self.display_hidden_activations:
            raise NotImplementedError(
                'display_filters / display_hidden_activations: image '
                'summaries are not ported yet (ROADMAP.md Queue A10)')
        self._fit_seed = self.make_random_seed()
        mesh = self._mesh
        if mesh is not None:
            # every rank starts from rank 0's state and seed
            seed = torch.tensor([self._fit_seed], device=self._device)
            replicate(mesh, [seed] + list(self._state.as_dict().values()))
            self._fit_seed = int(seed)
        writes = self._writes_files()
        if writes:
            self._init_writers()
        use_kernel = self._kernel_eligible()
        mc = self.metrics_config
        # a one-rank mesh keeps the single-device kernels, as the JAX
        # package keeps its whole-epoch kernel on a one-device mesh
        shardmap = self._shardmap_eligible() and \
            not (use_kernel and mesh.size == 1)
        if shardmap:
            b = self.batch_size // mesh.size
            staged_train = self._stage_batches(
                X, rows=slice(mesh.rank * b, (mesh.rank + 1) * b))
            train_epoch = self._train_epoch_shardmap
        else:
            staged_train = self._stage_batches(X)
            train_epoch = self._train_epoch_kernel if use_kernel \
                else self._train_epoch_generic
        full, rem, n_full = staged_train
        staged_val = self._stage_batches(X_val) if X_val is not None \
            else None
        staged_feg = staged_train
        if shardmap and X_val is not None and mc['feg']:
            # the FEG reads whole training batches, the same on every rank
            n, B = mc['n_batches_for_feg'], self.batch_size
            staged_feg = self._stage_batches(
                X if n_full < n else np.asarray(X)[:n * B])
        every = int(mc['train_metrics_every_iter'])

        for self.epoch_ in epoch_iter(start_epoch=self.epoch_,
                                      max_epoch=self.max_epoch,
                                      verbose=self.verbose and writes):
            lr = float(schedule_value(self.learning_rate, self.epoch_))
            mom = float(schedule_value(self.momentum, self.epoch_))
            k = int(schedule_value(self.n_gibbs_steps, self.epoch_))
            iter0 = self.iter_
            rows = train_epoch(full, rem, lr, mom, k,
                               derive_seed(self._fit_seed, self.epoch_))
            rows = torch.cat(rows, dim=1).cpu().numpy() if rows \
                else np.zeros((3, 0), self._np_dtype)
            mask = (iter0 + 1 + np.arange(rows.shape[1])) % every == 0
            train_results = self._reduce_train_metrics(rows, mask) \
                if mask.any() else {}

            val_results = {}
            feg = None
            if X_val is not None and \
                    self.epoch_ % mc['val_metrics_every_epoch'] == 0:
                val_results = self._val_metrics(staged_val, k)
            if X_val is not None and mc['feg'] and \
                    self.epoch_ % mc['feg_every_epoch'] == 0:
                feg = self._feg(staged_feg, staged_val)
            if writes:
                self._log_epoch(train_results, val_results, feg)
            if self.save_after_each_epoch and \
                    self.epoch_ % self.checkpoint_every_epoch == 0:
                self._save_model()

    def _log_epoch(self, train_results, val_results, feg):
        """Scalar summaries and the verbose line of one epoch."""
        mc = self.metrics_config
        step = self.iter_
        for m, v in train_results.items():
            self._train_writer.add_scalar(self._metrics_names_map[m], v,
                                          step)
        for m, v in val_results.items():
            self._val_writer.add_scalar(self._metrics_names_map[m], v,
                                        step)
        if feg is not None:
            self._val_writer.add_scalar(self._metrics_names_map['feg'],
                                        feg, step)
        self._train_writer.flush()
        self._val_writer.flush()

        if self.verbose:
            s = 'epoch: {0:{1}}/{2}'.format(
                self.epoch_, len(str(self.max_epoch)), self.max_epoch)
            for m, v in sorted(train_results.items()):
                s += '; {0}: {1:{2}}'.format(m, v, mc[m + '_fmt'])
            for m, v in sorted(val_results.items()):
                s += '; val.{0}: {1:{2}}'.format(m, v, mc[m + '_fmt'])
            if feg is not None:
                s += ' ; feg: {0:{1}}'.format(feg, mc['feg_fmt'])
            write_during_training(s)

    # ================================================================== #
    # public API                                                          #
    # ================================================================== #
    def init_from(self, rbm):
        """Warm-start from another RBM of the same class: copies weights,
        momentum accumulators, and trailing-underscore attributes
        (reference base_rbm.py:668-685)."""
        if type(self) is not type(rbm):
            raise ValueError('an attempt to initialize `{0}` from `{1}`'
                             .format(self.__class__.__name__,
                                     rbm.__class__.__name__))
        weights = rbm.get_params_arrays(scope='weights')
        self.W_init = weights['W']
        self.vb_init = weights['vb']
        self.hb_init = weights['hb']

        accs = rbm.get_params_arrays(scope='grads_accumulators')
        self._dW_init = accs['dW']
        self._dvb_init = accs['dvb']
        self._dhb_init = accs['dhb']

        for k, v in vars(rbm).items():
            if is_attribute_name(k):
                setattr(self, k, v)
        self._state = None
        self._programs = {}

    def transform(self, X, np_dtype=None):
        """Hidden activation probabilities after the k-step chain
        (reference base_rbm.py:437-440: chain-final h_means; stochastic when
        intermediate hidden states are sampled)."""
        self._ensure_state()
        np_dtype = np_dtype or self._np_dtype
        _, g = self.make_generator(self._device)
        k = int(schedule_value(self.n_gibbs_steps, self.epoch_))
        state = self._state.as_dict()
        H = []
        for X_batch in self._batches(self._stage_batches(X)):
            X_b = self._maybe_dropout(g, X_batch)
            _, h_states = self._h_states0(state, X_b, g)
            _, _, _, h_means = self._gibbs_chain(state, h_states, k, g)
            H.append(h_means)
        if not H:
            return np.zeros((0, self.n_hidden), dtype=np_dtype)
        return torch.cat(H).cpu().numpy().astype(np_dtype)

    def free_energy(self, X):
        """Batch-mean free energy of `X` (host-facing convenience)."""
        self._ensure_state()
        _, g = self.make_generator(self._device)
        X = torch.as_tensor(self._preprocess(X), device=self._device)
        X = self._maybe_dropout(g, X)
        return float(self._free_energy(self._state.as_dict(), X, g))
