"""Deep Boltzmann Machine with PCD and mean-field inference, in PyTorch.

The counterpart of the JAX package's ``dbm.py`` for all-Bernoulli DBMs:

* the model is stacked from pretrained ``BernoulliRBM``s (halving the middle
  layers, averaging shared biases) and its state is a ``DBMState`` module
  holding the JAX package's pytree (``convert.py``): weights, momentum
  accumulators, sparsity EMAs and the persistent chains;
* training, ``sample_v`` and ``log_Z`` run the device programs of
  ``ops/dbm_ops.py``: on a CUDA device a float32 model goes through the
  hand-written kernels (decided once from the configuration, as the JAX
  package picks its Pallas kernels on a TPU), otherwise through their plain
  versions.  Mean-field for validation, ``transform``, ``reconstruct`` and
  ``log_proba`` is plain PyTorch, as the JAX package leaves it to XLA;
* randomness: each call draws one op seed from the persisted host RNG;
  per-epoch seeds derive from it and key the Philox streams of
  ``ops/philox.py``.

Not ported yet (ROADMAP.md): Gaussian and multinomial layers, the
``adaptive`` beta ladder, ``base_rate`` and BDMC of ``log_Z``, histogram and
image summaries (``display_filters`` or ``display_particles`` above 0 make
``fit`` raise) and device meshes (``set_mesh`` raises).  One deliberate
difference: ``load_rbms`` on a model that is already initialized (trained,
or loaded from a checkpoint) keeps its state; the JAX package discards it,
so its ``examples/dbm_mnist.py`` would re-stack a cached DBM from the
RBMs.
"""

import math

import numpy as np
import torch

from .convert import DBMState, dbm_state_from_jax_arrays, dbm_state_to_numpy
from .ebm import EnergyBasedModel
from .layers import BaseLayer, BernoulliLayer
from .ops.dbm_ops import (AISConfig, DBMEpochConfig, DBMSampleConfig, ais,
                          ais_reference, dbm_epoch, dbm_epoch_reference,
                          dbm_sample, dbm_sample_reference, mean_field,
                          reconstruction_means)
from .rbm.base_rbm import derive_seed
from .utils import (make_list_from, epoch_iter, schedule_value,
                    write_during_training, log_sum_exp, log_diff_exp,
                    log_mean_exp, log_std_exp)

_AIS_SALT = 1


class DBM(EnergyBasedModel):
    """Deep Boltzmann Machine trained by PCD with mean-field inference.

    Parameters mirror the JAX package's ``DBM`` (and so the reference):
    built from a list of pretrained RBMs, trained with `n_particles`
    persistent chains, per-epoch `learning_rate` / `momentum` /
    `n_gibbs_steps` schedules, L2 and max-norm regularization, and per-layer
    sparsity targets.  `kernel`: 'auto' picks the CUDA kernels when the
    model is eligible, 'xla' forces the plain versions, 'pallas' forces the
    kernels (the JAX values, kept so checkpoints load both ways).  `device`
    is the torch device of the state (private, never persisted).
    """

    def __init__(self, rbms=None,
                 n_particles=100, v_particle_init=None, h_particles_init=None,
                 n_gibbs_steps=5, max_mf_updates=10, mf_tol=1e-7,
                 learning_rate=0.0005, momentum=0.9, max_epoch=10,
                 batch_size=100, l2=0., max_norm=np.inf,
                 sample_v_states=True, sample_h_states=None,
                 sparsity_target=0.1, sparsity_cost=0., sparsity_damping=0.9,
                 train_metrics_every_iter=10, val_metrics_every_epoch=1,
                 verbose=False, save_after_each_epoch=True,
                 checkpoint_every_epoch=1, summaries_every_epoch=1,
                 display_filters=0, display_particles=0, v_shape=(28, 28),
                 kernel='auto', model_path='dbm_model/', *args, **kwargs):
        super(DBM, self).__init__(model_path=model_path, *args, **kwargs)
        self.n_layers_ = len(rbms) if rbms is not None else None
        self.n_visible_ = None
        self.n_hiddens_ = []
        self.layers_config_ = None
        self._v_layer = None
        self._h_layers = None
        self._W_init = self._vb_init = self._hb_init = None
        self._state = None
        self.load_rbms(rbms)

        self.n_particles = n_particles
        self._v_particle_init = v_particle_init
        self._h_particles_init = h_particles_init

        self.n_gibbs_steps = make_list_from(n_gibbs_steps)
        self.max_mf_updates = max_mf_updates
        self.mf_tol = mf_tol

        self.learning_rate = make_list_from(learning_rate)
        self.momentum = make_list_from(momentum)
        self.max_epoch = max_epoch
        self.batch_size = batch_size
        self.l2 = l2
        self.max_norm = max_norm

        self.sample_v_states = sample_v_states
        self.sample_h_states = sample_h_states or \
            ([True] * self.n_layers_ if self.n_layers_ else None)

        self.sparsity_target = make_list_from(sparsity_target)
        self.sparsity_cost = make_list_from(sparsity_cost)
        if self.n_layers_ is not None and self.n_layers_ > 1:
            for x in (self.sparsity_target, self.sparsity_cost):
                if len(x) == 1:
                    x *= self.n_layers_
        self.sparsity_damping = sparsity_damping

        self.train_metrics_every_iter = train_metrics_every_iter
        self.val_metrics_every_epoch = val_metrics_every_epoch
        self.verbose = verbose
        self.save_after_each_epoch = save_after_each_epoch
        self.checkpoint_every_epoch = int(checkpoint_every_epoch)
        self.summaries_every_epoch = int(summaries_every_epoch)

        for nh in self.n_hiddens_:
            assert nh >= display_filters
        self.display_filters = display_filters
        assert display_particles <= self.n_particles
        self.display_particles = display_particles

        self.v_shape = tuple(v_shape)
        if len(self.v_shape) == 2:
            self.v_shape = (self.v_shape[0], self.v_shape[1], 1)

        if kernel not in ('auto', 'xla', 'pallas'):
            raise ValueError("kernel must be 'auto', 'xla' or 'pallas'")
        self.kernel = kernel

        self.epoch_ = 0
        self.iter_ = 0
        self.n_samples_generated_ = 0

    # ================================================================== #
    # construction from pretrained RBMs                                   #
    # ================================================================== #
    def load_rbms(self, rbms):
        """Bind pretrained RBMs: record their weights as stacking inits and
        adopt their unit layers (JAX dbm.py:169-195).  A model that is
        already initialized keeps its state (see the module docstring)."""
        if rbms is None:
            return
        for r in rbms:
            if not (isinstance(r._v_layer, BernoulliLayer)
                    and isinstance(r._h_layer, BernoulliLayer)):
                raise NotImplementedError(
                    'DBMs with Gaussian or multinomial layers are not ported '
                    'yet (ROADMAP.md Queue A6)')
        sizes = [rbms[0].n_visible] + [r.n_hidden for r in rbms]
        keep = self._state is not None and self.initialized_
        if keep and sizes != [self.n_visible_] + list(self.n_hiddens_):
            raise ValueError('RBMs of sizes {0} do not match the initialized '
                             'DBM {1}'.format(sizes, [self.n_visible_] +
                                              list(self.n_hiddens_)))
        self._rbms = rbms
        self.n_layers_ = len(rbms)
        self.n_visible_ = rbms[0].n_visible
        self.n_hiddens_ = [r.n_hidden for r in rbms]

        self._W_init, self._vb_init, self._hb_init = [], [], []
        for r in rbms:
            w = r.get_params_arrays(scope='weights')
            self._W_init.append(np.asarray(w['W']))
            self._vb_init.append(np.asarray(w['vb']))
            self._hb_init.append(np.asarray(w['hb']))

        self._v_layer = rbms[0]._v_layer
        self._h_layers = [r._h_layer for r in rbms]
        for layer in [self._v_layer] + self._h_layers:
            layer.dtype = self.dtype
        self.layers_config_ = [layer.get_config()
                               for layer in [self._v_layer] + self._h_layers]
        if getattr(self, 'sample_h_states', None) is None:
            self.sample_h_states = [True] * self.n_layers_
        if not keep:
            self._state = None

    def _ensure_layers(self):
        """Layers rebuilt from ``layers_config_`` when no RBMs are bound (a
        loaded checkpoint; JAX dbm.py:197-204)."""
        if self._v_layer is None:
            if self.layers_config_ is None:
                raise RuntimeError('DBM has no layers: construct with '
                                   '`rbms=[...]` or call `load_rbms`')
            layers = [BaseLayer.from_config(c) for c in self.layers_config_]
            if not all(isinstance(layer, BernoulliLayer) for layer in layers):
                raise NotImplementedError(
                    'DBMs with Gaussian or multinomial layers are not ported '
                    'yet (ROADMAP.md Queue A6)')
            self._v_layer = layers[0]
            self._h_layers = layers[1:]

    def _stacked_init(self):
        """Compose DBM weights from RBM weights, halving intermediate layers
        and averaging shared biases (JAX dbm.py:206-225)."""
        W_init, hb_init = [], []
        vb_init = self._vb_init[0].copy()
        for i in range(self.n_layers_):
            W = self._W_init[i].copy()
            vb = self._vb_init[i].copy()
            hb = self._hb_init[i].copy()
            if 0 < i < self.n_layers_ - 1:
                W *= 0.5
                vb *= 0.5
                hb *= 0.5
            W_init.append(W)
            if i == 0:
                hb_init.append(0.5 * hb)
            else:
                hb_init[i - 1] = hb_init[i - 1] + 0.5 * vb
                hb_init.append(0.5 * hb if i < self.n_layers_ - 1 else hb)
        return W_init, vb_init, hb_init

    def _init_state(self):
        self._ensure_layers()
        if self._W_init is None:
            raise RuntimeError('DBM state requires pretrained RBM weights; '
                               'construct with `rbms=[...]`')
        W_init, vb_init, hb_init = self._stacked_init()
        dtype, dev = self._torch_dtype, self._device
        _, g = self.make_generator(dev)

        def tensor(x):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

        if self._v_particle_init is not None:
            v = tensor(self._v_particle_init)
        else:
            v = self._v_layer.init(g, self.n_particles, self.dtype, dev)
        H = []
        for i in range(self.n_layers_):
            if self._h_particles_init is not None and \
                    self._h_particles_init[i] is not None:
                H.append(tensor(self._h_particles_init[i]))
            else:
                H.append(self._h_layers[i].init(g, self.n_particles,
                                                self.dtype, dev))
        W = tuple(tensor(w) for w in W_init)
        hb = tuple(tensor(b) for b in hb_init)
        vb = tensor(vb_init)
        self._state = DBMState({
            'vb': vb, 'hb': hb, 'W': W,
            'dvb': torch.zeros_like(vb),
            'dhb': tuple(torch.zeros_like(b) for b in hb),
            'dW': tuple(torch.zeros_like(w) for w in W),
            'q_means': tuple(torch.zeros_like(b) for b in hb),
            'mu_means': tuple(torch.zeros_like(b) for b in hb),
            'v': v, 'H': tuple(H),
        })

    def _ensure_state(self):
        self._ensure_layers()
        if self._state is None:
            self._init_state()

    def _get_state_arrays(self):
        self._ensure_state()
        return dbm_state_to_numpy(self._state)

    def _set_state_arrays(self, arrays):
        self._state = dbm_state_from_jax_arrays(arrays, self._device,
                                                self._torch_dtype)

    # ================================================================== #
    # device programs                                                     #
    # ================================================================== #
    def set_mesh(self, mesh, data_axis='data'):
        """The DBM's data-parallel epoch (sharded batch and particles, the
        mean-field test as an all_reduce(MAX)) is not ported yet."""
        raise NotImplementedError('DBM.set_mesh: the DBM mesh epoch is not '
                                  'ported yet (ROADMAP.md Queue A6.4)')

    def _kernel_eligible(self):
        """The CUDA DBM kernels cover all-Bernoulli float32 DBMs on a CUDA
        device -- decided from the configuration (JAX
        ``_pallas_epoch_eligible``, dbm.py:605-618), never from a
        failure."""
        self._ensure_layers()
        if self.kernel == 'xla':
            return False
        ok = self.dtype == 'float32' and self._device.type == 'cuda'
        if self.kernel == 'pallas' and not ok:
            raise ValueError('kernel="pallas" requested but the model is '
                             'not eligible for the CUDA DBM kernels')
        return ok

    def _layer_sizes(self):
        return tuple([self.n_visible_] + list(self.n_hiddens_))

    def _epoch_config(self, k):
        return DBMEpochConfig(
            self._layer_sizes(), int(k), int(self.max_mf_updates),
            float(self.mf_tol), bool(self.sample_v_states),
            tuple(bool(s) for s in self.sample_h_states), float(self.l2),
            float(self.max_norm), tuple(float(t) for t in
                                        self.sparsity_target),
            tuple(float(c) for c in self.sparsity_cost),
            float(self.sparsity_damping))

    def _mf(self, X):
        state = self._state.as_dict()
        return mean_field(X, state['W'], state['hb'],
                          int(self.max_mf_updates), float(self.mf_tol))

    # ================================================================== #
    # fit loop                                                            #
    # ================================================================== #
    def _stage_batches(self, X):
        """Split X into (full_batches, remainder, n_full) tensors on the
        model's device."""
        X = np.asarray(X, dtype=self._np_dtype)
        B = self.batch_size
        n_full = len(X) // B
        full = torch.as_tensor(
            X[:n_full * B].reshape(n_full, B, self.n_visible_),
            device=self._device)
        rem = X[n_full * B:]
        rem = torch.as_tensor(np.ascontiguousarray(rem),
                              device=self._device) if len(rem) else None
        return full, rem, n_full

    @staticmethod
    def _batches(staged):
        full, rem, _ = staged
        return list(full) + ([] if rem is None else [rem])

    def _init_writers(self):
        from .utils.summary_writer import SummaryWriter
        if getattr(self, '_train_writer', None) is None:
            self._train_writer = SummaryWriter(self._train_summary_dirpath)
            self._val_writer = SummaryWriter(self._val_summary_dirpath)

    def _val_metrics(self, staged_val):
        """Mean msre and mean-field update count over the validation
        batches (JAX ``_val_metrics_program``)."""
        msres, n_mfs = [], []
        state = self._state.as_dict()
        for X in self._batches(staged_val):
            mu, n_mf = self._mf(X)
            v_means = reconstruction_means(state, mu[0])
            msres.append(float(torch.mean(torch.square(X - v_means))))
            n_mfs.append(n_mf)
        if not msres:
            return float('nan'), float('nan')
        return float(np.mean(msres)), float(np.mean(n_mfs))

    def _fit(self, X, X_val=None, *args, **kwargs):
        if self.display_filters or self.display_particles:
            raise NotImplementedError(
                'display_filters / display_particles: image summaries are '
                'not ported yet (ROADMAP.md Queue A10)')
        self._fit_seed = self.make_random_seed()
        self._init_writers()
        epoch_fn = dbm_epoch if self._kernel_eligible() \
            else dbm_epoch_reference
        full, rem, _ = self._stage_batches(X)
        staged_val = self._stage_batches(X_val) if X_val is not None \
            else None
        every = int(self.train_metrics_every_iter)

        for self.epoch_ in epoch_iter(start_epoch=self.epoch_,
                                      max_epoch=self.max_epoch,
                                      verbose=self.verbose):
            lr = float(schedule_value(self.learning_rate, self.epoch_))
            mom = float(schedule_value(self.momentum, self.epoch_))
            k = int(schedule_value(self.n_gibbs_steps, self.epoch_))
            cfg = self._epoch_config(k)
            seed = derive_seed(self._fit_seed, self.epoch_)
            iter0 = self.iter_
            rows = []
            # the full batches in one call, then the remainder batch with
            # its own row count
            for X_batches in (full, None if rem is None else rem[None]):
                if X_batches is None or not X_batches.shape[0]:
                    continue
                state, msre, n_mf = epoch_fn(cfg, self._state.as_dict(),
                                             X_batches, lr, mom, seed,
                                             self.iter_)
                self._state.update(state)
                self.iter_ += int(X_batches.shape[0])
                rows.append(torch.stack([msre, n_mf]))
            rows = torch.cat(rows, dim=1).cpu().numpy() if rows \
                else np.zeros((2, 0), self._np_dtype)
            mask = (iter0 + 1 + np.arange(rows.shape[1])) % every == 0

            train_msre = train_n_mf = None
            if mask.any():
                train_msre = float(rows[0][mask].mean())
                train_n_mf = float(rows[1][mask].mean())
            val_msre = val_n_mf = None
            if X_val is not None and \
                    self.epoch_ % self.val_metrics_every_epoch == 0:
                val_msre, val_n_mf = self._val_metrics(staged_val)

            step = self.iter_
            if train_msre is not None:
                self._train_writer.add_scalar('mean_squared_recon_error',
                                              train_msre, step)
                self._train_writer.add_scalar('n_mf_updates', train_n_mf,
                                              step)
            if val_msre is not None and np.isfinite(val_msre):
                self._val_writer.add_scalar('mean_squared_recon_error',
                                            val_msre, step)
                self._val_writer.add_scalar('n_mf_updates', val_n_mf, step)
            self._train_writer.flush()
            self._val_writer.flush()

            if self.verbose:
                s = 'epoch: {0:{1}}/{2}'.format(
                    self.epoch_, len(str(self.max_epoch)), self.max_epoch)
                if train_msre is not None:
                    s += '; msre: {0:.5f}'.format(train_msre)
                    s += '; n_mf_upds: {0:.1f}'.format(train_n_mf)
                if val_msre is not None and np.isfinite(val_msre):
                    s += '; val.msre: {0:.5f}'.format(val_msre)
                    s += '; val.n_mf_upds: {0:.1f}'.format(val_n_mf)
                write_during_training(s)

            if self.save_after_each_epoch and \
                    self.epoch_ % self.checkpoint_every_epoch == 0:
                self._save_model()

    # ================================================================== #
    # public API                                                          #
    # ================================================================== #
    def _per_batch(self, X, fn, width, np_dtype=None):
        """`fn(X_batch)` over the batches of X (full batches, then the
        remainder: mean-field convergence is per batch, as in the JAX
        package), concatenated on the host."""
        self._ensure_state()
        out = [fn(X_b) for X_b in self._batches(self._stage_batches(X))]
        if not out:
            return np.zeros((0,) + width, dtype=np_dtype or self._np_dtype)
        out = torch.cat(out).cpu().numpy()
        return out.astype(np_dtype) if np_dtype else out

    def transform(self, X, np_dtype=None):
        """Last-layer variational activations mu_L (JAX dbm.py:1491)."""
        np_dtype = np_dtype or self._np_dtype
        return self._per_batch(X, lambda X_b: self._mf(X_b)[0][-1],
                               (self.n_hiddens_[-1],), np_dtype)

    def reconstruct(self, X):
        """p(v | h0 = mu0(x)) reconstruction means (JAX dbm.py:1520)."""
        return self._per_batch(
            X, lambda X_b: reconstruction_means(self._state.as_dict(),
                                                self._mf(X_b)[0][0]),
            (self.n_visible_,))

    def sample_v(self, n_gibbs_steps=0, save_model=False):
        """Visible activation means of the persistent chains after
        `n_gibbs_steps` sampled sweeps (JAX dbm.py:1537-1560).  Mutates (and
        with `save_model` persists) the chains."""
        self._ensure_state()
        seed = self.make_random_seed()
        cfg = DBMSampleConfig(self._layer_sizes(), bool(self.sample_v_states),
                              tuple(bool(s) for s in self.sample_h_states))
        fn = dbm_sample if self._kernel_eligible() else dbm_sample_reference
        state, v = fn(cfg, self._state.as_dict(), int(n_gibbs_steps), seed)
        self._state.update(state)
        v = v.cpu().numpy()
        if save_model:
            self.n_samples_generated_ += int(n_gibbs_steps)
            self._save_model()
        return v

    def log_Z(self, n_betas=100, n_runs=100, n_gibbs_steps=5,
              beta_schedule='linear', base_rate=None,
              bdmc=False, bdmc_burn_in=200):
        """AIS estimate of the log partition function of a 2-layer DBM,
        annealed on h1 with v and h2 summed out, along the linear beta
        ladder from the uniform base (JAX dbm.py:1562-1658).  Returns
        (log_mean, (log_low, log_high), values) with low / high
        log(Z_mean -+ std(Z))."""
        if beta_schedule != 'linear' or base_rate is not None or bdmc:
            raise NotImplementedError(
                "log_Z: beta_schedule='adaptive', base_rate and bdmc are "
                'not ported yet (ROADMAP.md Queue A6)')
        self._ensure_state()
        if self.n_layers_ != 2:
            raise ValueError('log_Z needs a 2-layer DBM')
        V, H1, H2 = self.n_visible_, self.n_hiddens_[0], self.n_hiddens_[1]
        seed, g = self.make_generator(self._device)
        x0 = (torch.rand((n_runs, H1), generator=g, dtype=self._torch_dtype,
                         device=self._device) < 0.5).to(self._torch_dtype)
        cfg = AISConfig(V, H1, H2, int(n_betas), int(n_gibbs_steps),
                        bool(self.sample_v_states),
                        bool(self.sample_h_states[0]),
                        bool(self.sample_h_states[1]))
        fn = ais if self._kernel_eligible() else ais_reference
        log_w = fn(cfg, self._state.as_dict(), derive_seed(seed, _AIS_SALT),
                   x0)
        values = log_w.cpu().numpy().astype(np.float64) + \
            (V + H1 + H2) * math.log(2.)
        log_mean = log_mean_exp(values)
        log_std = log_std_exp(values, log_mean_exp_x=log_mean)
        log_high = log_sum_exp([log_std, log_mean])
        log_low = log_diff_exp([log_std, log_mean])[0]
        return log_mean, (log_low, log_high), values

    def _log_proba_batch(self, X):
        """Variational lower bound -E(x, mu) + H(mu) (JAX dbm.py:1198)."""
        state = self._state.as_dict()
        (W0, W1), (hb0, hb1) = state['W'], state['hb']
        mu, _ = self._mf(X)
        minus_E = torch.sum((X @ W0) * mu[0], dim=1)
        minus_E = minus_E + torch.sum((mu[0] @ W1) * mu[1], dim=1)
        minus_E = minus_E + X @ state['vb']
        minus_E = minus_E + mu[0] @ hb0
        minus_E = minus_E + mu[1] @ hb1
        ent = 0.
        for m in mu:
            s = torch.clamp(m, 1e-7, 1. - 1e-7)
            ent = ent + torch.sum(-s * torch.log(s) -
                                  (1. - s) * torch.log(1. - s), dim=1)
        return minus_E + ent

    def log_proba(self, X_test, log_Z):
        """Variational lower bound on log p(x) minus `log_Z` (JAX
        dbm.py:1660-1677)."""
        self._ensure_state()
        if self.n_layers_ != 2:
            raise ValueError('log_proba needs a 2-layer DBM')
        P = self._per_batch(X_test, self._log_proba_batch, ())
        return P.astype(np.float64) - log_Z
