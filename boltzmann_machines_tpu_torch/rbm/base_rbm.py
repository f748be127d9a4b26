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
  too big for VMEM the XLA path), and validates, and measures the
  free-energy gap, in whole-set passes on the same kernels
  (``ops/cd_val.py``);
* with a data-parallel mesh (``set_mesh(parallel.make_mesh())``, one
  process per device, every process calling ``fit`` with the whole data)
  each rank trains on its rows of every minibatch: the CD-k sums of its
  rows (the stats kernels of ``ops/cd_stats.py`` on CUDA, else the generic
  body), one ``all_reduce`` of them per step, and the same update on every
  rank -- the JAX package's shard_map epoch.  Only the mesh's rank 0 writes
  checkpoints, summaries and the verbose lines;
* with a model axis (``set_mesh(make_mesh(shape=(D, M)),
  model_axis='model')``) W's hidden columns, with hb, dW, dhb and q_means,
  are split over the M ranks of the axis (``parallel.column_blocks``) --
  the JAX package's tensor-parallel W, which it trains on its GSPMD epoch.
  Here the generic body runs on this rank's rows and columns with explicit
  collectives (``_train_epoch_tensor_parallel``); every rank draws the
  one-process stream and keeps its block of each draw, so the fit is the
  one-process generic fit.  ``get_params_arrays``, checkpoints,
  ``transform`` and the summaries gather the columns: collectives that
  every rank of the mesh calls;
* randomness: each ``fit`` draws one op seed from the persisted host RNG
  (on a mesh, rank 0's, with its state broadcast to every rank); per-epoch
  seeds derive from it, seeding a ``torch.Generator`` (generic path) or
  keying the kernels' Philox stream.

Semantics follow the reference exactly: the momentum rule
``acc <- lr * (m * acc + grad); param += acc``, the EMA sparsity penalty on
summed hidden means, dbm_first/dbm_last input doubling, PLL via a single
randomly flipped unit scaled by n_visible, and the free-energy gap.
Every summary epoch (a train metric logged in it, and the epoch a multiple
of ``summaries_every_epoch``) writes histograms of W, vb, hb, dW, dvb and
dhb, reduced on the device (``device_histogram``), the first
``display_filters`` columns of W as a filter grid, and the hidden
activation means of the first batch's first ``display_hidden_activations``
units as an image.
"""

import numpy as np
import torch
import torch.nn.functional as F

from ..base import is_attribute_name
from ..base.mixin import make_generator
from ..base.torch_model import device_histogram, to_host
from ..convert import RBMState, state_from_jax_arrays, state_to_numpy
from ..ebm import EnergyBasedModel
from ..layers import (Block, BernoulliLayer, GaussianLayer,
                      MultinomialLayer, draw)
from ..ops.cd_epoch import (cd_epoch_config, make_cd_epoch_kernel,
                            pll_flip_index)
from ..ops.cd_stats import make_cd_stats_kernel, split_stats
from ..ops.cd_val import cd_feg, cd_val
from ..parallel.mesh import all_gather_columns, column_block, replicate
from ..utils import (make_list_from, epoch_iter, schedule_value,
                     write_during_training)
from ..utils.profiler import annotate
from ..utils.testing import assert_len, assert_shape

# seed salts of the per-epoch streams (the JAX package folds the same
# offsets into its fit key); a rank's generic stream on the mesh salts the
# epoch seed with its rank
_VAL_SALT = 100000
_FEG_SALT = 200000
_SHARD_SALT = 300000
_HIDDEN_SALT = 400000

# the state tensors whose last dimension is the hidden units: a
# tensor-parallel rank holds its block of their columns
_COLUMN_KEYS = ('W', 'dW', 'hb', 'dhb', 'q_means')


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
        # this rank's hidden columns (a slice) on a tensor-parallel mesh
        self._tp = None
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
            # contiguous whatever the init's layout (a transposed W_init,
            # as examples/dbm_cifar.py's quilted one): the kernels take
            # contiguous state
            return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                                   device=dev)

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
        self._keep_columns()

    def _ensure_state(self):
        if self._state is None:
            self._init_state()

    def _get_state_arrays(self):
        """The state's arrays, the columns whole (gathered on a
        tensor-parallel mesh: every rank must call this then)."""
        self._ensure_state()
        return state_to_numpy(self._whole_state())

    def _set_state_arrays(self, arrays):
        self._state = state_from_jax_arrays(arrays, self._device,
                                            self._torch_dtype)
        self._keep_columns()

    def _keep_columns(self):
        """On a tensor-parallel mesh, cut the (whole) state to this rank's
        columns."""
        if self._tp is not None:
            self._state.update({
                k: v[..., self._tp].contiguous() if k in _COLUMN_KEYS else v
                for k, v in self._state.as_dict().items()})

    def _whole_state(self):
        """The state dict with the columns whole (gathered over the model
        axis: a collective on a tensor-parallel mesh)."""
        state = self._state.as_dict()
        if self._tp is None:
            return state
        return {k: all_gather_columns(self._mesh, v, self.n_hidden)
                if k in _COLUMN_KEYS else v for k, v in state.items()}

    def set_params(self, **params):
        self._programs = {}  # hyperparams may have changed -> rebuild
        return super(BaseRBM, self).set_params(**params)

    def set_mesh(self, mesh, data_axis='data', model_axis=None):
        """Attach a mesh (``parallel.make_mesh()``): training batches are
        split over its ranks along `data_axis`, their CD statistics summed
        by ``all_reduce``.  With `model_axis`, W's hidden columns (and hb,
        dW, dhb and q_means) are split over that axis's ranks and the state
        is cut to this rank's block now; vb and dvb stay whole (JAX
        base_rbm.py:261-281).  Returns the model."""
        names = tuple(mesh.axis_names)
        if data_axis != names[0]:
            raise ValueError('the mesh has no axis {0!r} (its data axis is '
                             '{1!r})'.format(data_axis, names[0]))
        if model_axis is not None and names[1:] != (model_axis,):
            raise ValueError('the mesh has no axis {0!r} (its axes are {1})'
                             .format(model_axis, names))
        if model_axis is not None:
            self._ensure_state()
        # a state split by an earlier mesh is gathered first
        whole = self._whole_state() if self._state is not None else None
        self._mesh = mesh
        self._tp = slice(*column_block(mesh, self.n_hidden)) \
            if model_axis is not None else None
        if whole is not None:
            self._state.update(whole)
            self._keep_columns()
        self._programs = {}
        return self

    def _writes_files(self):
        """The mesh's rank 0 alone writes checkpoints and summaries."""
        return self._mesh is None or self._mesh.global_rank == 0

    # ------------------- tensor-parallel collectives -------------------- #
    def _model_sum(self, t):
        """`t` summed over the model axis, in place (a tensor-parallel
        rank's partial sum over its hidden columns); `t` elsewhere."""
        if self._tp is not None and self._mesh.model_size > 1:
            import torch.distributed as dist
            dist.all_reduce(t, group=self._mesh.model_group)
        return t

    def _data_sum(self, t):
        """`t` summed over the data axis, in place (a rank's partial sum
        over its rows of the batch)."""
        if self._mesh.size > 1:
            import torch.distributed as dist
            dist.all_reduce(t, group=self._mesh.group)
        return t

    def _local_columns(self, t):
        return t if self._tp is None else t[..., self._tp]

    def _whole_columns(self, t):
        return t if self._tp is None else \
            all_gather_columns(self._mesh, t, self.n_hidden)

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
        if self._tp is not None and isinstance(self._h_layer,
                                               MultinomialLayer):
            # the softmax spans the whole row: the layer runs at full width
            # on the gathered inputs, and this rank keeps its columns
            whole = self._whole_columns(x + m * state['hb'])
            return self._local_columns(self._h_layer.activation(whole, 0.))
        return self._h_layer.activation(x, m * state['hb'])

    def _means_v_given_h(self, state, h):
        m = self._propdown_multiplier
        x = m * self._model_sum(h @ state['W'].T)
        return self._v_layer.activation(x, m * state['vb'])

    # Draws.  `rows` (a (batch, slice) pair, or None for a whole batch)
    # names the rows of the one-process batch that a rank of a
    # tensor-parallel mesh's data axis holds; a tensor-parallel rank keeps
    # its columns of each hidden draw.
    def _sample_v(self, generator, means, rows=None):
        block = None if rows is None else Block(rows[0], rows[1], None, None)
        return self._v_layer.sample(generator, means, block)

    def _sample_h(self, generator, means, rows=None):
        if self._tp is None:
            return self._h_layer.sample(generator, means)
        batch, r = rows if rows is not None else (None, None)
        if isinstance(self._h_layer, MultinomialLayer):
            states = self._h_layer.sample(generator,
                                          self._whole_columns(means),
                                          Block(batch, r, None, None))
            return self._local_columns(states)
        return self._h_layer.sample(generator, means,
                                    Block(batch, r, self.n_hidden, self._tp))

    def _gibbs_chain(self, state, h_states, k, generator, rows=None):
        """Run `k` block-Gibbs steps starting from hidden states; returns
        the final (v_states, v_means, h_states, h_means)."""
        B = h_states.shape[0]
        v_states = v_means = h_states.new_zeros((B, self.n_visible))
        h_means = torch.zeros_like(h_states)
        for _ in range(k):
            v_means = self._means_v_given_h(state, h_states)
            v_states = (self._sample_v(generator, v_means, rows)
                        if self.sample_v_states else v_means)
            h_means = self._means_h_given_v(state, v_states)
            h_states = (self._sample_h(generator, h_means, rows)
                        if self.sample_h_states else h_means)
        return v_states, v_means, h_states, h_means

    def _maybe_dropout(self, generator, X, rows=None):
        """Dropout on the input, seen by every consumer (reference
        base_rbm.py:417-418)."""
        if self.dropout is None:
            return X
        keep = float(self.dropout)
        block = None if rows is None else Block(rows[0], rows[1], None, None)
        mask = draw(torch.rand, generator, X.shape, X, block) < keep
        return torch.where(mask, X / keep, torch.zeros_like(X))

    def _h_states0(self, state, X, generator, rows=None):
        h0_means = self._means_h_given_v(state, X)
        h_states = (self._sample_h(generator, h0_means, rows)
                    if self.sample_h_states else h0_means)
        return h0_means, h_states

    def _cd_stats(self, state, X_batch, k, generator, rows=None):
        """CD-k sufficient statistics of one minibatch (or of this rank's
        `rows` of it): the raw *sums*.  Returns (stats, aux);
        `_apply_cd_update` completes the update."""
        X = self._maybe_dropout(generator, X_batch, rows)
        h0_means, h_states = self._h_states0(state, X, generator, rows)
        v_states, v_means, _, h_means = self._gibbs_chain(state, h_states, k,
                                                          generator, rows)
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

    def _free_energy_terms(self, state, v, generator=None):
        """Per row of `v`: the free energy's visible term and its hidden
        term over this rank's hidden units (all of them off a
        tensor-parallel mesh)."""
        raise NotImplementedError('`_free_energy_terms` is not implemented')

    def _free_energy_constant(self):
        return 0.

    def _free_energy(self, state, v, generator=None, rows=None):
        """Batch-mean free energy of `v` (or of the whole batch whose
        `rows` this rank holds): the hidden term summed over the model
        axis, the rows over the data axis."""
        visible, hidden = self._free_energy_terms(state, v, generator)
        fe = visible + self._model_sum(hidden)
        mean = torch.mean(fe, dim=0) if rows is None else \
            self._data_sum(torch.sum(fe, dim=0)) / rows[0]
        return mean + self._free_energy_constant()

    def _pll(self, state, X, generator, rows=None):
        """Pseudo-log-likelihood proxy: corrupt one random unit per sample,
        PLL = n_visible * log_sigmoid(FE(x~) - FE(x)) with batch-mean free
        energies."""
        B = X.shape[0]
        batch, mine = rows if rows is not None else (B, slice(None))
        idx = torch.randint(0, self.n_visible, (batch,), generator=generator,
                            device=X.device)[mine]
        r = torch.arange(B, device=X.device)
        flipped = X.clone()
        flipped[r, idx] = 1. - X[r, idx]
        fe_x = self._free_energy(state, X, generator, rows)
        fe_flipped = self._free_energy(state, flipped, generator, rows)
        return self.n_visible * F.logsigmoid(fe_flipped - fe_x)

    def _metrics(self, state, X, v_means, generator, rows=None):
        sq = torch.square(X - v_means)
        out = {'msre': torch.mean(sq) if rows is None else
               self._data_sum(torch.sum(sq)) / (rows[0] * self.n_visible)}
        out['pll'] = (self._pll(state, X, generator, rows)
                      if self.metrics_config['pll'] else torch.zeros_like(
                          out['msre']))
        out['l2_loss'] = self.l2 * 0.5 * self._model_sum(
            torch.sum(torch.square(state['W'])))
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
        dropout, on a CUDA device, at any size and with PLL, W whole (not
        on a tensor-parallel mesh, as JAX base_rbm.py:891-902 asks for one
        device) -- decided once per fit from the configuration."""
        if self.kernel == 'xla':
            return False
        ok = (self._kernel_flavours() is not None
              and self.dtype == 'float32'
              and self.dropout is None
              and self._device.type == 'cuda'
              and self._tp is None)
        if self.kernel == 'pallas' and not ok:
            raise ValueError('kernel="pallas" requested but the model is '
                             'not eligible for the CUDA CD epoch kernels')
        return ok

    def _cd_kwargs(self, k):
        """The CD kernels' static configuration at `k` Gibbs steps, as the
        keyword arguments of ``cd_epoch_config``."""
        visible, sigma, hidden, n_samples = self._kernel_flavours()
        return dict(
            n_visible=self.n_visible, n_hidden=self.n_hidden, k=k,
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

    def _cd_epoch_program(self, k):
        return make_cd_epoch_kernel(batch_size=self.batch_size,
                                    **self._cd_kwargs(k))

    def _cd_config(self, k):
        return self._program(('cd_config', k),
                             lambda: cd_epoch_config(**self._cd_kwargs(k)))

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
        base_rbm.py:503-526, whose GSPMD fallback gives that result).  A
        tensor-parallel W takes its own epoch, as JAX keeps it on GSPMD."""
        if self._mesh is None or self.kernel == 'xla' or self._tp is not None:
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

    def _train_epoch_tensor_parallel(self, full, rem, lr, mom, k, seed):
        """One epoch on a tensor-parallel mesh (JAX's GSPMD epoch of a W
        whose hidden columns are split over 'model').  `full` holds this
        rank's rows of every full batch (all of them where the batch does
        not split over 'data'), `rem` the whole remainder batch.  Every rank
        seeds the one-process generator and draws the whole batch's shapes
        in the one-process order, keeping its rows and columns, so the fit
        is the one-process generic fit up to the order of its sums.  Per
        batch: the chain on this rank's rows and columns (the visible input
        one all_reduce over 'model' a half-step), the CD sums of its rows
        in one flat buffer [assoc | dvb_sum | dhb_sum | h_sum] summed over
        'data', and the update of its columns.  Returns the (msre, pll, l2)
        rows of every iteration."""
        import torch.distributed as dist
        mesh = self._mesh
        every = int(self.metrics_config['train_metrics_every_iter'])
        V, B = self.n_visible, self.batch_size
        Hr = self._tp.stop - self._tp.start
        dev, dtype = self._device, self._torch_dtype
        g = make_generator(seed, dev)
        split = full.shape[1] != B
        b = int(full.shape[1])
        rows = (B, slice(mesh.rank * b, (mesh.rank + 1) * b)) if split \
            else None
        if split:
            flat = torch.empty(V * Hr + V + 2 * Hr, dtype=dtype, device=dev)
            sums = split_stats(flat, V, Hr)
        batches = [(X, rows) for X in full] + \
            ([] if rem is None else [(rem, None)])
        out = torch.zeros((3, len(batches)), dtype=dtype, device=dev)
        state = self._state.as_dict()
        for i, (X, r) in enumerate(batches):
            self.iter_ += 1
            stats, aux = self._cd_stats(state, X, k, g, r)
            if r is not None:
                for key, view in sums.items():
                    view.copy_(stats[key])
                dist.all_reduce(flat, group=mesh.group)
                stats = sums
            state = self._apply_cd_update(state, stats,
                                          B if r is not None else X.shape[0],
                                          lr, mom)
            if self.iter_ % every == 0:
                m = self._metrics(state, aux['X'], aux['v_means'], g, r)
                out[:, i] = torch.stack([m['msre'], m['pll'], m['l2_loss']])
        self._state.update(state)
        return [out]

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

    def _stage_rows(self, X):
        """X as one contiguous (rows, n_visible) tensor on the model's
        device: the set that the whole-set passes read."""
        return torch.as_tensor(np.ascontiguousarray(self._preprocess(X)),
                               device=self._device)

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

    def _val_pass(self, X_val, k):
        """``_val_metrics`` on the kernel path: one whole-set pass over the
        staged validation rows (``ops/cd_val.py``), one readback."""
        mc = self.metrics_config
        if not (mc['msre'] or mc['pll']):
            return {}
        out = cd_val(self._cd_config(k), self._state.as_dict(), X_val,
                     self.batch_size,
                     derive_seed(self._fit_seed, _VAL_SALT + self.epoch_),
                     msre=mc['msre'], pll=mc['pll'])
        return {name: float(v) for name, v in zip(('msre', 'pll'),
                                                  out.cpu().numpy())
                if mc[name]}

    def _feg_pass(self, train_rows, X_val):
        """``_feg`` on the kernel path: the probe rows of both sides (the
        training set's as staged) in whole-set passes, one readback."""
        n, B = self.metrics_config['n_batches_for_feg'], self.batch_size
        # the free energies read no chain: the configuration at k = 0
        fe = cd_feg(self._cd_config(0), self._state.as_dict(), X_val[:n * B],
                    train_rows, B,
                    derive_seed(self._fit_seed, _FEG_SALT + self.epoch_))
        val_fe, train_fe = fe.cpu().numpy()
        return float(val_fe - train_fe)

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

    _summary_tensor_names = ('W', 'vb', 'hb', 'dW', 'dvb', 'dhb')

    def _any_train_metric(self):
        """True when at least one train scalar metric is enabled -- the
        summaries cadence keys off a metric having been logged (as in the
        reference, where summaries ride the merged train-metric op)."""
        m = self.metrics_config
        return bool(m['msre'] or m['pll'] or m['l2_loss'])

    def _summary_device_stats(self, state):
        """Device-side reduction for the epoch summaries: bucketed
        histograms of every learned tensor plus the first
        ``display_filters`` weight columns, fetched to the host -- a few KB
        instead of the full (V, H) state."""
        out = {name: device_histogram(state[name])
               for name in self._summary_tensor_names}
        if self.display_filters:
            out['W_filters'] = state['W'][:, :self.display_filters]
        return to_host(out)

    def _write_epoch_summaries(self, stats, step):
        """Per-epoch histograms of all learned tensors and (optionally)
        filter-grid images (reference base_rbm.py:295-323, 300-306)."""
        for name in self._summary_tensor_names:
            self._train_writer.add_device_histogram(name, stats[name], step)
        if self.display_filters:
            from ..utils.plot_utils import filter_grid_image
            img = filter_grid_image(stats['W_filters'], self.v_shape,
                                    self.display_filters)
            self._train_writer.add_image('W_filters', img, step)

    def _hidden_activations(self, X_probe):
        """The hidden-activation probe: ``transform``'s chain on the first
        batch, from a seed of this epoch (the host RNG is not drawn), its
        first ``display_hidden_activations`` units (reference
        base_rbm.py:429-435)."""
        g = make_generator(derive_seed(self._fit_seed,
                                       _HIDDEN_SALT + self.epoch_),
                           self._device)
        k = int(schedule_value(self.n_gibbs_steps, self.epoch_))
        h = self._transform_batch(self._state.as_dict(), X_probe, k, g)
        return h[:, :self.display_hidden_activations]

    def _write_hidden_activations_img(self, h, step):
        h = to_host(h)
        mx = float(h.max())
        if mx > 1.:  # e.g. multinomial expected counts
            h = h / mx
        img = (np.clip(h, 0., 1.) * 255.).astype(np.uint8)
        self._train_writer.add_image('hidden_activation_means', img, step)

    def _fit(self, X, X_val=None, *args, **kwargs):
        self._fit_seed = self.make_random_seed()
        mesh = self._mesh
        tp = self._tp is not None
        if mesh is not None:
            # every rank starts from the mesh's rank 0's seed and state; a
            # tensor-parallel rank takes its columns from the data axis's
            # rank 0, which holds the same ones
            state = self._state.as_dict()
            seed = torch.tensor([self._fit_seed], device=self._device)
            replicate(mesh, [seed] + [v for k, v in state.items()
                                      if not (tp and k in _COLUMN_KEYS)])
            if tp:
                replicate(mesh, [state[k] for k in _COLUMN_KEYS], axis='data')
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
        # a tensor-parallel mesh splits rows over 'data' where they split
        split = shardmap or (tp and mesh.size > 1 and
                             self.batch_size % mesh.size == 0)
        with annotate('fit/stage'):
            if split:
                b = self.batch_size // mesh.size
                staged_train = self._stage_batches(
                    X, rows=slice(mesh.rank * b, (mesh.rank + 1) * b))
                train_epoch = self._train_epoch_tensor_parallel if tp \
                    else self._train_epoch_shardmap
            elif tp:
                staged_train = self._stage_batches(X)
                train_epoch = self._train_epoch_tensor_parallel
            else:
                staged_train = self._stage_batches(X)
                train_epoch = self._train_epoch_kernel if use_kernel \
                    else self._train_epoch_generic
            n_full = staged_train[2]
            n, B = mc['n_batches_for_feg'], self.batch_size
            staged_val = staged_feg = None
            if use_kernel:
                # the whole-set passes read the validation set, and the
                # FEG's training probe rows (the first n batches, or all
                # rows where there are fewer), each as one tensor
                val_fn, feg_fn = self._val_pass, self._feg_pass
                if X_val is not None:
                    staged_val = self._stage_rows(X_val)
                    if mc['feg']:
                        staged_feg = self._stage_rows(np.asarray(X)[:n * B])
            else:
                val_fn, feg_fn = self._val_metrics, self._feg
                staged_val = self._stage_batches(X_val) \
                    if X_val is not None else None
                staged_feg = staged_train
                if split and X_val is not None and mc['feg']:
                    # the FEG reads whole training batches, the same on
                    # every rank
                    staged_feg = self._stage_batches(
                        X if n_full < n else np.asarray(X)[:n * B])

        for self.epoch_ in epoch_iter(start_epoch=self.epoch_,
                                      max_epoch=self.max_epoch,
                                      verbose=self.verbose and writes):
            with annotate('fit/epoch'):
                self._fit_epoch(X, staged_train, staged_val, staged_feg,
                                train_epoch, val_fn, feg_fn, writes)

    def _fit_epoch(self, X, staged_train, staged_val, staged_feg,
                   train_epoch, val_fn, feg_fn, writes):
        """Epoch ``self.epoch_`` of ``_fit``, its parts in spans of their
        own; `val_fn` and `feg_fn` validate and measure the free-energy gap
        (whole-set passes on the kernel path)."""
        mc = self.metrics_config
        full, rem, _ = staged_train
        every = int(mc['train_metrics_every_iter'])
        lr = float(schedule_value(self.learning_rate, self.epoch_))
        mom = float(schedule_value(self.momentum, self.epoch_))
        k = int(schedule_value(self.n_gibbs_steps, self.epoch_))
        iter0 = self.iter_
        with annotate('fit/epoch/train'):
            rows = train_epoch(full, rem, lr, mom, k,
                               derive_seed(self._fit_seed, self.epoch_))
        with annotate('fit/epoch/readback'):
            rows = torch.cat(rows, dim=1).cpu().numpy() if rows \
                else np.zeros((3, 0), self._np_dtype)
            mask = (iter0 + 1 + np.arange(rows.shape[1])) % every == 0
            train_results = self._reduce_train_metrics(rows, mask) \
                if mask.any() else {}

        val_results = {}
        feg = None
        if staged_val is not None and \
                self.epoch_ % mc['val_metrics_every_epoch'] == 0:
            with annotate('fit/epoch/val'):
                val_results = val_fn(staged_val, k)
        if staged_val is not None and mc['feg'] and \
                self.epoch_ % mc['feg_every_epoch'] == 0:
            with annotate('fit/epoch/feg'):
                feg = feg_fn(staged_feg, staged_val)
        want_summaries = bool(mask.any()) and \
            self._any_train_metric() and \
            self.epoch_ % self.summaries_every_epoch == 0
        hidden = stats = None
        with annotate('fit/epoch/summaries'):
            # on a tensor-parallel mesh the probe and the summaries gather
            # columns: every rank takes part, and rank 0 writes
            if want_summaries and (writes or self._tp is not None):
                if self.display_hidden_activations:
                    # the first batch of the whole data (a rank on the mesh
                    # holds only its rows of it)
                    probe = torch.as_tensor(
                        self._preprocess(np.asarray(X)[:self.batch_size]),
                        device=self._device)
                    hidden = self._hidden_activations(probe)
                stats = self._summary_device_stats(self._whole_state())
            if writes:
                if hidden is not None:
                    self._write_hidden_activations_img(hidden, self.iter_)
                self._log_epoch(train_results, val_results, feg)
                if want_summaries:
                    self._write_epoch_summaries(stats, self.iter_)
                    self._train_writer.flush()
        if self.save_after_each_epoch and \
                self.epoch_ % self.checkpoint_every_epoch == 0:
            with annotate('fit/epoch/checkpoint'):
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

    def _transform_batch(self, state, X_batch, k, generator):
        """Chain-final hidden means of one batch, all the columns."""
        X_b = self._maybe_dropout(generator, X_batch)
        _, h_states = self._h_states0(state, X_b, generator)
        return self._whole_columns(
            self._gibbs_chain(state, h_states, k, generator)[3])

    def transform(self, X, np_dtype=None):
        """Hidden activation probabilities after the k-step chain
        (reference base_rbm.py:437-440: chain-final h_means; stochastic when
        intermediate hidden states are sampled).  On a tensor-parallel mesh
        every rank calls it and gets all the columns."""
        self._ensure_state()
        np_dtype = np_dtype or self._np_dtype
        _, g = self.make_generator(self._device)
        k = int(schedule_value(self.n_gibbs_steps, self.epoch_))
        state = self._state.as_dict()
        H = [self._transform_batch(state, X_batch, k, g)
             for X_batch in self._batches(self._stage_batches(X))]
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
