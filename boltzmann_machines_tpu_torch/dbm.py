"""Deep Boltzmann Machine with PCD and mean-field inference, in PyTorch.

The counterpart of the JAX package's ``dbm.py``:

* the model is stacked from pretrained RBMs (halving the middle layers,
  averaging shared biases) and adopts their unit layers: Bernoulli,
  Gaussian (a ``GaussianRBM``'s visible layer, its sigma) or multinomial
  (a ``MultinomialRBM``'s hidden layer, its n_samples), as in the CIFAR
  pipelines' Gaussian-Bernoulli-Multinomial DBM.  Its state is a
  ``DBMState`` module holding the JAX package's pytree (``convert.py``):
  weights, momentum accumulators, sparsity EMAs and the persistent chains;
* training, ``sample_v`` and ``log_Z`` run the device programs of
  ``ops/dbm_ops.py``: on a CUDA device a float32 all-Bernoulli model goes
  through the hand-written kernels (decided once from the configuration,
  as the JAX package picks its Pallas kernels on a TPU), otherwise through
  their plain versions.  A float32 model with Gaussian or multinomial
  layers on a CUDA device trains on the same kernels where its visible
  units are Bernoulli or Gaussian and its hidden layers Bernoulli or
  multinomial (the CIFAR pipelines' Gaussian-Bernoulli-Multinomial DBM:
  the Gaussian epilogue, a multinomial layer's softmax rows, the
  mean-field graph), else on the plain epoch there; its ``sample_v`` runs
  the plain program there (as the JAX package runs it on XLA), its sampled
  layers drawn by the standalone sampler kernels.  Mean-field for
  validation, ``transform``, ``reconstruct`` and
  ``log_proba`` is plain PyTorch, as the JAX package leaves it to XLA.  The
  DBM takes its inputs raw: a Gaussian layer's mean is x sigma + b (no
  division by sigma, unlike ``GaussianRBM``);
* randomness: each call draws one op seed from the persisted host RNG;
  per-epoch seeds derive from it and key the Philox streams of
  ``ops/philox.py``;
* every summary epoch (a train step logged in it, and the epoch a multiple
  of ``summaries_every_epoch``) writes histograms of vb and of each W_l and
  hb_l, reduced on the device (``device_histogram``), the first
  ``display_filters`` columns of each cumulative filter W_0 @ ... @ W_l as
  a grid, and the first ``display_particles`` persistent chains as an
  image;
* with a data-parallel mesh (``set_mesh(parallel.make_mesh())``, one
  process a rank, every rank calling ``fit`` with the whole data) each
  rank keeps its contiguous ``n_particles / size`` rows of the chains and
  takes its rows of every batch: mean-field stops at the sweep the whole
  batch would (the change reduced by all_reduce(MAX)), the raw statistics
  are summed in one all_reduce a step and every rank applies the same
  update (``ops/dbm_ops.dbm_mesh_epoch``; its draws by the standalone
  samplers, keyed with the rank).  ``sample_v`` and ``log_Z`` run the
  ranks' rows and gather them; checkpoints hold the gathered chains, and
  only the mesh's rank 0 writes.  On a 2-D ('data', 'model') mesh the DBM
  trains data-parallel over the data axis and the model axis's ranks
  repeat the same work, as JAX's shard_map over such a mesh does; its W
  stays whole (JAX ``DBM.set_mesh`` takes no model axis).  Built from
  tensor-parallel RBMs it takes their gathered weights (``load_rbms``
  reads ``get_params_arrays``, a collective that every rank calls); a W
  that is a column block in its state is refused.

``log_Z`` (the linear or ``adaptive`` ladder, a ``base_rate``, BDMC) and
``log_proba`` take all-Bernoulli 2-layer DBMs, as the JAX package's do; on
a CUDA device a float32 model runs every ``log_Z`` option on the AIS
kernels.  One deliberate difference: ``load_rbms`` on a model that is
already initialized (trained, or loaded from a checkpoint) keeps its
state; the JAX package discards it, so its ``examples/dbm_mnist.py`` would
re-stack a cached DBM from the RBMs.
"""

import math

import numpy as np
import torch

from .base.mixin import make_generator
from .base.torch_model import device_histogram, to_host
from .convert import DBMState, dbm_state_from_jax_arrays, dbm_state_to_numpy
from .ebm import EnergyBasedModel
from .layers import BaseLayer
from .ops.dbm_ops import (AISConfig, DBMEpochConfig, DBMSampleConfig, ais,
                          ais_burn_in, ais_burn_in_reference, ais_reference,
                          all_bernoulli, dbm_epoch, dbm_epoch_reference,
                          dbm_mesh_epoch, dbm_sample, dbm_sample_reference,
                          mean_field, reconstruction_means, reverse_ais,
                          reverse_ais_reference, tile_h1)
from .parallel.mesh import all_gather_rows, replicate
from .rbm.base_rbm import derive_seed
from .utils import (make_list_from, epoch_iter, schedule_value,
                    write_during_training, log_sum_exp, log_diff_exp,
                    log_mean_exp, log_std_exp)
from .utils.profiler import annotate, profiling

# salts of the seeds derived from one call's seed: the forward AIS run, the
# BDMC burn-in and reverse run, and (plus the rank) a mesh rank's draws
_AIS_SALT, _BURN_SALT, _RAIS_SALT, _RANK_SALT = 1, 2, 3, 1000


def make_beta_schedule(n_betas, kind='linear'):
    """Inverse-temperature ladder (length n_betas + 1, 0 -> 1) for AIS
    (JAX dbm.py:48-73).

    'linear' is the reference's uniform spacing.  'adaptive' allocates
    betas as Salakhutdinov & Murray (2008) do for their large runs --
    sparse early, dense near beta = 1 where the importance-weight variance
    concentrates (~3.5% of betas on [0, 0.5), ~27.5% on [0.5, 0.9), ~69% on
    [0.9, 1])."""
    if kind == 'linear':
        return np.linspace(0., 1., n_betas + 1)
    if kind != 'adaptive':
        raise ValueError("beta_schedule must be 'linear' or 'adaptive'")
    if n_betas < 3:  # too few steps for three bands; uniform is exact
        return np.linspace(0., 1., n_betas + 1)
    n1 = max(int(round(0.035 * n_betas)), 1)
    n3 = max(int(round(0.69 * n_betas)), 1)
    n2 = n_betas - n1 - n3
    if n2 < 1:  # small ladders: keep the total exactly n_betas
        n3 = max(n_betas - n1 - 1, 1)
        n2 = n_betas - n1 - n3
    return np.concatenate([
        np.linspace(0., 0.5, n1, endpoint=False),
        np.linspace(0.5, 0.9, n2, endpoint=False),
        np.linspace(0.9, 1., n3 + 1)])


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

    # the data-parallel mesh (``set_mesh``), and whether the state holds
    # only this rank's rows of the particles
    _mesh = None
    _sharded = False

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
        """The state's arrays, the particles whole (gathered from every
        rank of a mesh: every rank must call this then)."""
        self._ensure_state()
        return dbm_state_to_numpy(self._full_state())

    def _set_state_arrays(self, arrays):
        self._state = dbm_state_from_jax_arrays(arrays, self._device,
                                                self._torch_dtype)
        self._sharded = False

    # ================================================================== #
    # device programs                                                     #
    # ================================================================== #
    def set_mesh(self, mesh, data_axis='data'):
        """Attach a data-parallel mesh (``parallel.make_mesh()``; JAX
        dbm.py:313-328): minibatch rows, persistent particles and AIS runs
        are split over its ranks along `data_axis`, the statistics summed by
        all_reduce; returns the model."""
        if data_axis != mesh.axis_names[0]:
            raise ValueError('the mesh has no axis {0!r} (its data axis is '
                             '{1!r})'.format(data_axis, mesh.axis_names[0]))
        self._unshard()
        self._mesh = mesh
        return self

    def _writes_files(self):
        """The mesh's rank 0 alone writes checkpoints and summaries."""
        return self._mesh is None or self._mesh.global_rank == 0

    def _check_whole_weights(self):
        """Refuse a state whose W is not whole: the port has no sharded
        tensor, so a column block of a tensor-parallel W (where JAX routes
        a hand-sharded W to its GSPMD epoch, dbm.py:620-647) would train
        silently as a smaller model."""
        sizes = self._layer_sizes()
        for i, W in enumerate(self._state.as_dict()['W']):
            want = (sizes[i], sizes[i + 1])
            if tuple(W.shape) != want:
                raise ValueError(
                    'W_{0} has shape {1}, the DBM\'s layers need {2}: a '
                    'column block of a tensor-parallel W? The DBM takes '
                    'whole weights (get_params_arrays gathers them)'.format(
                        i, tuple(W.shape), want))

    def _shardmap_eligible(self):
        """Mesh training runs the data-parallel epoch (per-rank rows of the
        batch and of the particles, all_reduced statistics) unless the user
        forced kernel='xla' or the batch or the particles do not split over
        the ranks; then every rank trains whole batches through the
        single-device path (JAX ``_shardmap_eligible``, dbm.py:620-647,
        whose GSPMD fallback gives that result)."""
        if self._mesh is None or self.kernel == 'xla':
            return False
        n = self._mesh.size
        return self.batch_size % n == 0 and self.n_particles % n == 0

    def _splits_particles(self):
        """Whether this mesh runs the data-parallel epoch on the ranks'
        rows: a one-rank mesh keeps the single-device kernels, as the JAX
        package keeps its Pallas epoch on a one-device mesh."""
        return self._shardmap_eligible() and not (
            self._mesh.size == 1 and self._kernel_eligible())

    def _rows(self, n):
        """This rank's contiguous block of `n` rows split over the mesh."""
        m = n // self._mesh.size
        return slice(self._mesh.rank * m, (self._mesh.rank + 1) * m)

    def _rank_seed(self, seed):
        return derive_seed(seed, _RANK_SALT + self._mesh.rank)

    def _set_layout(self):
        """Bring the chains to the layout this configuration trains in:
        this rank's rows where the mesh splits them (a collective if they
        were split before), else whole; returns whether they are split."""
        split = self._splits_particles()
        if not split:
            self._unshard()
        elif not self._sharded:
            self._keep_rows(self._state.as_dict())
            self._sharded = True
        return split

    def _keep_rows(self, state):
        """`state` as the model's, with only this rank's rows of its
        (whole) chains."""
        rows = self._rows(self.n_particles)
        self._state.update(dict(state, v=state['v'][rows].clone(),
                                H=tuple(h[rows].clone() for h in state['H'])))

    def _full_state(self):
        """The state dict with the particles whole (gathered on a mesh:
        a collective while they are split)."""
        state = self._state.as_dict()
        if not self._sharded:
            return state
        return dict(state, v=all_gather_rows(self._mesh, state['v']),
                    H=tuple(all_gather_rows(self._mesh, h)
                            for h in state['H']))

    def _unshard(self):
        if self._sharded:
            self._state.update(self._full_state())
            self._sharded = False

    def _replicated_seed(self, seed):
        """`seed`, or on a mesh rank 0's."""
        if self._mesh is None:
            return seed
        t = torch.tensor([seed], device=self._device)
        replicate(self._mesh, t)
        return int(t)

    def _units(self):
        """The layer objects, visible first (``ops/dbm_ops``' ``units``)."""
        self._ensure_layers()
        return tuple([self._v_layer] + list(self._h_layers))

    def _kernel_eligible(self):
        """Whether training and ``sample_v`` take the device programs'
        wrappers (``dbm_epoch``, ``dbm_sample``) rather than their plain
        versions: a float32 model on a CUDA device -- the DBM kernels for
        training one whose units they take (``dbm_ops.kernel_units``: the
        Gaussian-Bernoulli-Multinomial DBM among them), and for
        ``sample_v`` of an all-Bernoulli one; the standalone sampler
        kernels' draws for ``sample_v`` of one with Gaussian or multinomial
        layers -- decided from the configuration (JAX
        ``_pallas_epoch_eligible``, dbm.py:605-618), never from a failure.
        ``kernel='pallas'`` asks for the DBM kernels as the JAX API does,
        for all-Bernoulli float32 models on a CUDA device alone: a model
        with Gaussian or multinomial layers raises."""
        self._ensure_layers()
        if self.kernel == 'xla':
            return False
        ok = self.dtype == 'float32' and self._device.type == 'cuda'
        if self.kernel == 'pallas' and not (ok and self._all_bernoulli()):
            raise ValueError('kernel="pallas" requested but the model is '
                             'not eligible for the CUDA DBM kernels')
        return ok

    def _all_bernoulli(self):
        return all_bernoulli(self._units())

    def _require_bernoulli(self, name):
        """``log_Z`` and ``log_proba`` take all-Bernoulli 2-layer DBMs, as
        the JAX package asserts (dbm.py:1585-1587, :1663-1665)."""
        if self.n_layers_ != 2:
            raise ValueError('{0} needs a 2-layer DBM'.format(name))
        if not self._all_bernoulli():
            raise ValueError('{0} needs Bernoulli layers, got {1}'.format(
                name, [type(u).__name__ for u in self._units()]))

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
            float(self.sparsity_damping), self._units())

    def _mf(self, X):
        state = self._state.as_dict()
        return mean_field(X, state['W'], state['hb'],
                          int(self.max_mf_updates), float(self.mf_tol),
                          self._units())

    # ================================================================== #
    # fit loop                                                            #
    # ================================================================== #
    def _stage_batches(self, X, rows=None):
        """Split X into (full_batches, remainder, n_full) tensors on the
        model's device; `rows` (a slice) keeps only those rows of every
        full batch (a rank's share on the mesh)."""
        X = np.asarray(X, dtype=self._np_dtype)
        B = self.batch_size
        n_full = len(X) // B
        full = X[:n_full * B].reshape(n_full, B, self.n_visible_)
        if rows is not None:
            full = full[:, rows]
        full = torch.as_tensor(np.ascontiguousarray(full),
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
            v_means = reconstruction_means(state, mu[0], self._units())
            msres.append(float(torch.mean(torch.square(X - v_means))))
            n_mfs.append(n_mf)
        if not msres:
            return float('nan'), float('nan')
        return float(np.mean(msres)), float(np.mean(n_mfs))

    def _summary_device_stats(self, state):
        """Device-side reduction for the epoch summaries, fetched to the
        host: bucketed histograms of the weights and biases, per-layer
        cumulative-filter columns (the W_0 @ ... @ W_l products stay on the
        device, only the first ``display_filters`` visible-space columns
        come back), and the first ``display_particles`` persistent
        chains."""
        out = {'vb': device_histogram(state['vb']),
               'W': [device_histogram(w) for w in state['W']],
               'hb': [device_histogram(b) for b in state['hb']]}
        if self.display_filters:
            cum = state['W'][0]
            filters = [cum[:, :self.display_filters]]
            for l in range(1, self.n_layers_):
                cum = cum @ state['W'][l]
                filters.append(cum[:, :self.display_filters])
            out['W_filters'] = filters
        if self.display_particles:
            out['particles'] = state['v'][:self.display_particles]
        return to_host(out)

    def _write_epoch_summaries(self, s, step):
        """Per-epoch weight/bias histograms, cumulative-filter images per
        layer (reference dbm.py:312-322), and negative-particle images
        (dbm.py:531-547)."""
        from .utils.plot_utils import filter_grid_image
        w = self._train_writer
        w.add_device_histogram('vb', s['vb'], step)
        for l in range(self.n_layers_):
            w.add_device_histogram('W_{0}'.format(l), s['W'][l], step)
            w.add_device_histogram('hb_{0}'.format(l), s['hb'][l], step)
        if self.display_filters:
            for l in range(self.n_layers_):
                img = filter_grid_image(s['W_filters'][l], self.v_shape,
                                        self.display_filters)
                w.add_image('W_filters_{0}'.format(l), img, step)
        if self.display_particles:
            img = filter_grid_image(s['particles'].T, self.v_shape,
                                    self.display_particles)
            w.add_image('negative_particles', img, step)

    def _train_epoch_shardmap(self, full, rem, lr, mom, k, seed, epoch_fn):
        """One epoch over the mesh (JAX ``_shardmap_epoch_core`` and its
        remainder step, dbm.py:648-735): `full` holds this rank's rows of
        every full batch, run by ``dbm_mesh_epoch`` with this rank's seed;
        the local squared errors are reduced in one all_reduce an epoch.
        The remainder batch runs replicated: `epoch_fn`, the single-device
        step, on the whole chains with the epoch's seed, the same on every
        rank.  Returns the (msre, n_mf) rows of every iteration."""
        import torch.distributed as dist
        mesh = self._mesh
        cfg = self._epoch_config(k)

        def reduce_sum(t):
            dist.all_reduce(t, group=mesh.group)

        def reduce_max(t):
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)

        rows = []
        nb = int(full.shape[0])
        if nb:
            state, sq, n_mf = dbm_mesh_epoch(
                cfg, self._state.as_dict(), full, lr, mom,
                self._rank_seed(seed), self.iter_, self.batch_size,
                self.n_particles, reduce_sum, reduce_max)
            self._state.update(state)
            self.iter_ += nb
            reduce_sum(sq)
            rows.append(torch.stack(
                [sq / (self.batch_size * self.n_visible_), n_mf]))
        if rem is not None:
            state, msre, n_mf = epoch_fn(cfg, self._full_state(), rem[None],
                                         lr, mom, seed, self.iter_)
            self._keep_rows(state)
            self.iter_ += 1
            rows.append(torch.stack([msre, n_mf]))
        return rows

    def _train_epoch(self, full, rem, lr, mom, k, seed, epoch_fn):
        """One epoch on one device: the full batches in one call of
        `epoch_fn`, then the remainder batch with its own row count.
        Returns the (msre, n_mf) rows of every iteration."""
        cfg = self._epoch_config(k)
        rows = []
        for X_batches in (full, None if rem is None else rem[None]):
            if X_batches is None or not X_batches.shape[0]:
                continue
            state, msre, n_mf = epoch_fn(cfg, self._state.as_dict(),
                                         X_batches, lr, mom, seed,
                                         self.iter_)
            self._state.update(state)
            self.iter_ += int(X_batches.shape[0])
            rows.append(torch.stack([msre, n_mf]))
        return rows

    def _fit(self, X, X_val=None, *args, **kwargs):
        self._check_whole_weights()
        self._fit_seed = self.make_random_seed()
        if self._mesh is not None:
            # every rank starts from rank 0's state (the chains whole) and
            # seed
            self._unshard()
            replicate(self._mesh, list(self._state.as_dict().values()))
            self._fit_seed = self._replicated_seed(self._fit_seed)
        writes = self._writes_files()
        if writes:
            self._init_writers()
        epoch_fn = dbm_epoch if self._kernel_eligible() \
            else dbm_epoch_reference
        split = self._set_layout()
        train_epoch = self._train_epoch_shardmap if split \
            else self._train_epoch
        with annotate('fit/stage'):
            staged = self._stage_batches(
                X, rows=self._rows(self.batch_size) if split else None)
            staged_val = self._stage_batches(X_val) if X_val is not None \
                else None

        for self.epoch_ in epoch_iter(start_epoch=self.epoch_,
                                      max_epoch=self.max_epoch,
                                      verbose=self.verbose and writes):
            with annotate('fit/epoch'):
                self._fit_epoch(staged, staged_val, train_epoch, epoch_fn,
                                writes)

    def _fit_epoch(self, staged, staged_val, train_epoch, epoch_fn, writes):
        """Epoch ``self.epoch_`` of ``_fit``, its parts in spans of their
        own.  The steps' mean-field sweeps, read from the n_mf row the
        epoch copies to the host anyway, count in
        ``dbm_epoch.sweeps['mf_sweeps']``, and with the epoch's steps and
        enqueued sweeps in ``dbm_epoch.profiled_sweeps`` while a profiler
        session is active."""
        full, rem, _ = staged
        every = int(self.train_metrics_every_iter)
        lr = float(schedule_value(self.learning_rate, self.epoch_))
        mom = float(schedule_value(self.momentum, self.epoch_))
        k = int(schedule_value(self.n_gibbs_steps, self.epoch_))
        iter0 = self.iter_
        sweeps = dbm_epoch.sweeps
        enqueued = sweeps['mf_sweeps_enqueued']
        with annotate('fit/epoch/train'):
            rows = train_epoch(full, rem, lr, mom, k,
                               derive_seed(self._fit_seed, self.epoch_),
                               epoch_fn)
        with annotate('fit/epoch/readback'):
            rows = torch.cat(rows, dim=1).cpu().numpy() if rows \
                else np.zeros((2, 0), self._np_dtype)
            ran = int(rows[1].astype(np.int64).sum())
            sweeps['mf_sweeps'] += ran
            if profiling():
                profiled = dbm_epoch.profiled_sweeps
                profiled['steps'] += rows.shape[1]
                profiled['mf_sweeps_enqueued'] += \
                    sweeps['mf_sweeps_enqueued'] - enqueued
                profiled['mf_sweeps'] += ran
            mask = (iter0 + 1 + np.arange(rows.shape[1])) % every == 0
            train_msre = train_n_mf = None
            if mask.any():
                train_msre = float(rows[0][mask].mean())
                train_n_mf = float(rows[1][mask].mean())
        val_msre = val_n_mf = None
        if staged_val is not None and \
                self.epoch_ % self.val_metrics_every_epoch == 0:
            with annotate('fit/epoch/val'):
                val_msre, val_n_mf = self._val_metrics(staged_val)

        with annotate('fit/epoch/summaries'):
            step = self.iter_
            if writes and train_msre is not None:
                self._train_writer.add_scalar('mean_squared_recon_error',
                                              train_msre, step)
                self._train_writer.add_scalar('n_mf_updates', train_n_mf,
                                              step)
            if writes and val_msre is not None and np.isfinite(val_msre):
                self._val_writer.add_scalar('mean_squared_recon_error',
                                            val_msre, step)
                self._val_writer.add_scalar('n_mf_updates', val_n_mf, step)
            if mask.any() and self.epoch_ % self.summaries_every_epoch == 0:
                # the chains gathered on every rank of a mesh, if shown
                state = self._full_state() if self.display_particles \
                    else self._state.as_dict()
                if writes:
                    self._write_epoch_summaries(
                        self._summary_device_stats(state), step)
            if writes:
                self._train_writer.flush()
                self._val_writer.flush()

            if self.verbose and writes:
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
            with annotate('fit/epoch/checkpoint'):
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
                                                self._mf(X_b)[0][0],
                                                self._units()),
            (self.n_visible_,))

    def sample_v(self, n_gibbs_steps=0, save_model=False):
        """Visible activation means of the persistent chains after
        `n_gibbs_steps` sampled sweeps (JAX dbm.py:1537-1560).  Mutates (and
        with `save_model` persists) the chains.  On a mesh each rank runs
        its rows of the chains with the rank in the seed, and every rank
        returns the whole (n_particles, V) means."""
        self._ensure_state()
        seed = self._replicated_seed(self.make_random_seed())
        cfg = DBMSampleConfig(self._layer_sizes(), bool(self.sample_v_states),
                              tuple(bool(s) for s in self.sample_h_states),
                              self._units())
        fn = dbm_sample if self._kernel_eligible() else dbm_sample_reference
        split = self._set_layout()
        if split:
            seed = self._rank_seed(seed)
        state, v = fn(cfg, self._state.as_dict(), int(n_gibbs_steps), seed)
        self._state.update(state)
        if split:
            v = all_gather_rows(self._mesh, v)
        v = v.cpu().numpy()
        if save_model:
            self.n_samples_generated_ += int(n_gibbs_steps)
            self._save_model()
        return v

    def _base_rate(self, base_rate):
        """The base rate b0 of ``log_Z`` as a tensor, or None."""
        if isinstance(base_rate, str):
            if base_rate != 'hidden_bias':
                raise ValueError("base_rate must be an array, None, or "
                                 "'hidden_bias'")
            return self._state.as_dict()['hb'][0].clone()
        if base_rate is None:
            return None
        b0 = np.asarray(base_rate, dtype=self._np_dtype)
        if b0.shape != (self.n_hiddens_[0],):
            raise ValueError('base_rate must have shape ({0},), got {1}'
                             .format(self.n_hiddens_[0], b0.shape))
        return torch.as_tensor(b0, device=self._device)

    def _ais_log_Z0(self, b0=None):
        """log Z of the AIS base distribution p0 (v, h2 uniform; h1 uniform
        or base-rate biased; JAX dbm.py:1129-1136)."""
        log_Z0 = (self.n_visible_ + self.n_hiddens_[1]) * math.log(2.)
        if b0 is None:
            return log_Z0 + self.n_hiddens_[0] * math.log(2.)
        return log_Z0 + float(np.sum(np.logaddexp(
            0., b0.cpu().numpy().astype(np.float64))))

    def _runs(self, n_runs):
        """This rank's runs of a mesh, where `n_runs` splits over its ranks;
        else None (every rank runs them all)."""
        if self._mesh is None or self._mesh.size == 1 or \
                n_runs % self._mesh.size:
            return None
        return self._rows(n_runs)

    def _run_ais(self, fn, cfg, seed, x0, runs, b0):
        """`fn` (an AIS wrapper or plain version) on the runs `x0`: this
        rank's rows `runs` of a mesh, with the rank in the seed, gathered;
        or all of them (`runs` None).  Returns the per-run values on the
        host, float64."""
        if runs is None:
            out = fn(cfg, self._state.as_dict(), seed, x0, b0)
        else:
            out = all_gather_rows(self._mesh, fn(
                cfg, self._state.as_dict(), self._rank_seed(seed), x0, b0))
        return out.cpu().numpy().astype(np.float64)

    def _model_h1_samples(self, n_runs, burn_in, seed, runs=None):
        """Approximate samples from p1(h1) (JAX ``_model_h1_samples``,
        dbm.py:1182-1196): the persistent particles' h1 tiled to `n_runs`,
        binarized where h1 is sampled, then `burn_in` tempered Gibbs steps
        at beta = 1 under `seed` (the AIS kernels' transition launches on a
        CUDA float32 model); `runs`: this rank's rows, the rank in the
        seed."""
        cfg = self._ais_config(1, 1)
        x0 = tile_h1(self._full_state()['H'][0], n_runs,
                     bool(self.sample_h_states[0]))
        if runs is not None:
            x0, seed = x0[runs].contiguous(), self._rank_seed(seed)
        if burn_in <= 0:
            return x0
        fn = ais_burn_in if self._kernel_eligible() else ais_burn_in_reference
        return fn(cfg, self._state.as_dict(), seed, x0, int(burn_in))

    def _ais_config(self, n_betas, n_gibbs_steps, ladder=None):
        return AISConfig(self.n_visible_, self.n_hiddens_[0],
                         self.n_hiddens_[1], int(n_betas), int(n_gibbs_steps),
                         bool(self.sample_v_states),
                         bool(self.sample_h_states[0]),
                         bool(self.sample_h_states[1]), ladder)

    def log_Z(self, n_betas=100, n_runs=100, n_gibbs_steps=5,
              beta_schedule='linear', base_rate=None,
              bdmc=False, bdmc_burn_in=200):
        """AIS estimate of the log partition function of a 2-layer
        all-Bernoulli DBM, annealed on h1 with v and h2 summed out (JAX
        dbm.py:1562-1658).

        `beta_schedule='adaptive'` takes the Salakhutdinov-Murray ladder
        (``make_beta_schedule``); `base_rate` anneals from p0(h1) propto
        exp(h1.b0) -- an (H1,) array, or 'hidden_bias' for the model's hb0
        -- instead of the uniform base; `bdmc=True` also runs the annealing
        backward from (approximate) model samples, the particles' h1 after
        `bdmc_burn_in` steps at beta = 1 (bidirectional Monte Carlo), whose
        estimate is a stochastic upper bound on log Z.  The forward run, the
        burn-in and the reverse run draw under seeds of their own.

        Returns (log_mean, (log_low, log_high), values) with low / high
        log(Z_mean -+ std(Z)); with bdmc=True the interval is the BDMC
        sandwich (log_mean, log_upper) and `values` a dict of the forward
        values, the reverse log-weights and both bounds.  On a mesh the
        runs split over the ranks where they divide (each rank's with the
        rank in its seed), and every rank returns the same values.  Spans:
        ``log_Z``, the forward run ``log_Z/ais``, BDMC's ``log_Z/bdmc``."""
        with annotate('log_Z'):
            self._ensure_state()
            self._require_bernoulli('log_Z')
            ladder = make_beta_schedule(n_betas, beta_schedule)
            b0 = self._base_rate(base_rate)
            H1 = self.n_hiddens_[0]
            seed = self._replicated_seed(self.make_random_seed())
            g = make_generator(seed, self._device)
            # x0 from the base distribution itself
            p0 = 0.5 if b0 is None else torch.sigmoid(b0)
            x0 = (torch.rand((n_runs, H1), generator=g,
                             dtype=self._torch_dtype, device=self._device)
                  < p0).to(self._torch_dtype)
            # the linear ladder in the JAX kernel's float32 arithmetic
            cfg = self._ais_config(n_betas, n_gibbs_steps, None
                                   if beta_schedule == 'linear' else ladder)
            eligible = self._kernel_eligible()
            runs = self._runs(n_runs)
            with annotate('log_Z/ais'):
                values = self._run_ais(
                    ais if eligible else ais_reference, cfg,
                    derive_seed(seed, _AIS_SALT),
                    x0 if runs is None else x0[runs].contiguous(), runs,
                    b0) + self._ais_log_Z0(b0)
                log_mean = log_mean_exp(values)
            if bdmc:
                with annotate('log_Z/bdmc'):
                    x1 = self._model_h1_samples(
                        n_runs, bdmc_burn_in, derive_seed(seed, _BURN_SALT),
                        runs)
                    w_rev = self._run_ais(
                        reverse_ais if eligible else reverse_ais_reference,
                        cfg, derive_seed(seed, _RAIS_SALT), x1, runs, b0)
                    log_upper = self._ais_log_Z0(b0) - log_mean_exp(w_rev)
                return log_mean, (log_mean, log_upper), {
                    'forward': values, 'reverse': w_rev,
                    'log_Z_lower': log_mean, 'log_Z_upper': log_upper,
                    'bdmc_gap': log_upper - log_mean,
                }
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
        self._require_bernoulli('log_proba')
        P = self._per_batch(X_test, self._log_proba_batch, ())
        return P.astype(np.float64) - log_Z
