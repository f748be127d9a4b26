"""The CD-k training epoch of an RBM: Bernoulli or Gaussian visible units,
Bernoulli or multinomial hidden units.

Port of the TPU's fused epoch kernels ``make_cd_epoch_kernel`` /
``_cd_epoch_kernel`` (boltzmann_machines_tpu/ops/pallas_ops.py:1266, body
:262-509) and ``make_tiled_cd_epoch_kernel`` / ``_tiled_cd_epoch_kernel``
(:726, body :512-723; the same function for a W too big for VMEM, which on
Hopper is no special case), with the contract of the first::

    epoch = make_cd_epoch_kernel(n_visible, n_hidden, batch_size, k, ...)
    state, msre_rows, pll_rows, l2_rows = epoch(state, X_batches, lr,
                                                momentum, seed, iter0)

`state` is the dict {W, vb, hb, dW, dvb, dhb, q_means}; `X_batches` is
(n_batches, batch_size, n_visible) float32; the rows are (n_batches,) and
hold the metrics of every iteration ``it = iter0 + i + 1`` with
``it % metrics_every == 0`` (zero elsewhere).  The input state is not
modified.  Gaussian inputs arrive divided by sigma and vb is raw
(ROADMAP.md Queue C5); the PLL free energies omit the multinomial lgamma
constant (Queue C6), as the TPU kernels do.

Three parts:

* ``cd_epoch_reference`` -- the plain PyTorch version (torch.matmul);
* ``cd_epoch`` -- the wrapper: a CPU tensor runs the plain version, a CUDA
  tensor launches the hand-written kernels of ``csrc/cd_epoch.cu`` (built
  on first use) or raises;
* ``cd_epoch.launches`` -- how many times each kernel was launched (the
  whole-set passes of ``ops/cd_val.py`` count theirs here too), and
  ``cd_epoch.loop`` -- the calls of the C step loop and the steps they ran.

On CUDA one C call an epoch call, ``bm_cd_epoch_loop``, issues every
step's launches: ``epoch_launches`` counts them.

Random draws (sampled states, the PLL flip and count vectors) come from the
Philox stream of ``ops/philox.py``, which the kernels reproduce exactly.
"""

import ctypes
from collections import namedtuple

import numpy as np
import torch
import torch.nn.functional as F

from .gemm import (TILE_M, assoc_k_tiles, assoc_plan, check_operand,
                   count_stages, launch_plan, num_sms, reset_stages)
from .philox import (STREAM_H0, STREAM_PLL, STREAM_PLL_HHAT,
                     STREAM_PLL_HHAT_FLIP, bernoulli, multinomial_counts,
                     normal, philox_uniform, stream_h, stream_v)

STATE_KEYS = ('W', 'vb', 'hb', 'dW', 'dvb', 'dhb', 'q_means')
KERNELS = ('cd_gemm_act', 'cd_softmax_sample', 'cd_bias_stats',
           'cd_assoc_update', 'cd_metrics', 'cd_val_reduce')
VISIBLE = ('bernoulli', 'gaussian')
HIDDEN = ('bernoulli', 'multinomial')

CDEpochConfig = namedtuple('CDEpochConfig', (
    'n_visible', 'n_hidden', 'k', 'sample_v_states', 'sample_h_states',
    'propup_mult', 'propdown_mult', 'l2', 'sparsity_target', 'sparsity_cost',
    'sparsity_damping', 'metrics_every', 'compute_pll', 'visible', 'sigma',
    'hidden', 'n_samples'),
    defaults=('bernoulli', None, 'bernoulli', None))


def check_flavour(visible, hidden, n_samples):
    """Raise unless the unit types are ones the kernels take (and
    multinomial hidden units come with n_samples >= 1)."""
    if visible not in VISIBLE or hidden not in HIDDEN:
        raise ValueError('visible must be one of {0} and hidden one of {1}, '
                         'got {2!r} and {3!r}'.format(VISIBLE, HIDDEN,
                                                      visible, hidden))
    if hidden == 'multinomial' and (n_samples is None or int(n_samples) < 1):
        raise ValueError('multinomial hidden units need n_samples >= 1')


def cd_epoch_config(n_visible, n_hidden, k, sample_v_states,
                    sample_h_states, propup_mult, propdown_mult, l2,
                    sparsity_target, sparsity_cost, sparsity_damping,
                    metrics_every, compute_pll=True, visible='bernoulli',
                    sigma=None, hidden='bernoulli', n_samples=None):
    """The checked static configuration of the CD kernels (the epoch's, and
    the whole-set passes' of ``ops/cd_val.py``).  `sigma` (Gaussian visible
    units) is a scalar or a (n_visible,) array, `n_samples` (multinomial
    hidden units) the number of tied softmax draws."""
    check_flavour(visible, hidden, n_samples)
    if int(k) < 0 or int(metrics_every) < 1:
        raise ValueError('need k >= 0 and metrics_every >= 1')
    return CDEpochConfig(
        int(n_visible), int(n_hidden), int(k), bool(sample_v_states),
        bool(sample_h_states), float(propup_mult), float(propdown_mult),
        float(l2), float(sparsity_target), float(sparsity_cost),
        float(sparsity_damping), int(metrics_every), bool(compute_pll),
        visible, sigma if visible == 'gaussian' else None, hidden,
        None if hidden == 'bernoulli' else int(n_samples))


def make_cd_epoch_kernel(n_visible, n_hidden, batch_size, k,
                         sample_v_states, sample_h_states,
                         propup_mult, propdown_mult,
                         l2, sparsity_target, sparsity_cost,
                         sparsity_damping, metrics_every,
                         compute_pll=True, visible='bernoulli', sigma=None,
                         hidden='bernoulli', n_samples=None):
    """Build ``epoch(state, X_batches, lr, momentum, seed, iter0)`` with the
    static configuration of the JAX factory (``cd_epoch_config``).
    `batch_size` is kept for that signature; the epoch takes any batch size
    (the remainder batch of a fit runs through it with its own row
    count)."""
    cfg = cd_epoch_config(
        n_visible, n_hidden, k, sample_v_states, sample_h_states,
        propup_mult, propdown_mult, l2, sparsity_target, sparsity_cost,
        sparsity_damping, metrics_every, compute_pll, visible, sigma, hidden,
        n_samples)

    def epoch(state, X_batches, lr, momentum, seed, iter0):
        return cd_epoch(cfg, state, X_batches, lr, momentum, seed, iter0)

    return epoch


# ---------------------------------------------------------------------- #
# plain version                                                           #
# ---------------------------------------------------------------------- #
def sigma_tensor(sigma, n_visible, device):
    """A scalar or per-unit sigma (None: 1) as a (V,) float32 tensor."""
    return torch.as_tensor(np.broadcast_to(
        np.asarray(1. if sigma is None else sigma, np.float32).reshape(-1),
        (n_visible,)).copy(), device=device)


def sigma_row(cfg, device):
    """The (V,) sigma of Gaussian visible units (None otherwise)."""
    if cfg.visible != 'gaussian':
        return None
    return sigma_tensor(cfg.sigma, cfg.n_visible, device)


def free_energy_sum(X, act, vb, hb, visible='bernoulli', hidden='bernoulli',
                    sigma=None, h_hat=None):
    """Batch-SUM free energy given ``act = X @ W`` -- the counterpart of the
    JAX kernels' ``_free_energy_sum`` (pallas_ops.py:185): Gaussian inputs
    already divided by `sigma` with vb raw, ``h_hat`` the drawn count
    vector of multinomial hidden units, no lgamma constant."""
    if visible == 'gaussian':
        d = X - vb / sigma
        t_vis = 0.5 * torch.sum(d * d)
    else:
        t_vis = -torch.sum(X * vb)
    if hidden == 'multinomial':
        t_hid = -torch.sum(act * h_hat)
    else:
        t_hid = -torch.sum(F.softplus(act + hb))
    return t_vis + t_hid


def uniform_h_hat(n_samples, n_hidden, seed, it, stream, device):
    """One (1, H) count vector of the uniform Multinomial(n, 1/H): the
    Monte Carlo hidden draw of the multinomial free energy, from the means
    ``float32(n) / float32(H)`` that the kernels use."""
    m = np.float32(n_samples) / np.float32(n_hidden)
    means = torch.full((1, n_hidden), float(m), dtype=torch.float32,
                       device=device)
    return multinomial_counts(means, n_samples, seed, it, stream)


def pll_from_flip(X, flip_idx, W, vb, hb, visible='bernoulli',
                  hidden='bernoulli', sigma=None, h_hats=(None, None)):
    """PLL proxy of one batch given the flipped unit of each row:
    ``n_visible * log_sigmoid(fe(X_flip) - fe(X))`` with batch-MEAN free
    energies and no dbm doubling (ROADMAP.md Queue C4); `h_hats` are the
    count vectors of fe(X) and fe(X_flip) for multinomial hidden units."""
    B, V = X.shape
    rows = torch.arange(B, device=X.device)
    Xf = X.clone()
    Xf[rows, flip_idx] = 1. - X[rows, flip_idx]
    kw = dict(visible=visible, hidden=hidden, sigma=sigma)
    fe = free_energy_sum(X, X @ W, vb, hb, h_hat=h_hats[0], **kw) / B
    fe_f = free_energy_sum(Xf, Xf @ W, vb, hb, h_hat=h_hats[1], **kw) / B
    return V * F.logsigmoid(fe_f - fe)


def pll_flip_index(seed, it, batch_size, n_visible, device, shard=0):
    """The flipped unit of each row at iteration `it`: ``floor(u * V)``
    (the local rows of `shard` in the data-parallel epoch)."""
    u = philox_uniform(seed, it, STREAM_PLL, (batch_size,), device, shard)
    return (u * n_visible).to(torch.int64)


def pll_h_hats(cfg, seed, it, device):
    """The two independent count vectors of the multinomial PLL at
    iteration `it` (pallas_ops.py:484-496), None for Bernoulli hidden."""
    if cfg.hidden != 'multinomial':
        return None, None
    return tuple(uniform_h_hat(cfg.n_samples, cfg.n_hidden, seed, it, s,
                               device)
                 for s in (STREAM_PLL_HHAT, STREAM_PLL_HHAT_FLIP))


def metrics_reference(cfg, X, W, vb, hb, msre_col, seed, it):
    """The metric rows of one logged step in torch ops -- K4's function
    (``_launch_metrics``): (msre, pll, l2) given the batch `X`, the updated
    `W`, `vb`, `hb` and ``msre_col``, K2's column sums of (X - v_means)^2;
    pll is 0 without ``compute_pll``."""
    B, V = X.shape
    msre = torch.sum(msre_col) / (B * V)
    l2 = cfg.l2 * 0.5 * torch.sum(W * W)
    pll = torch.zeros((), dtype=X.dtype, device=X.device)
    if cfg.compute_pll:
        pll = pll_from_flip(X, pll_flip_index(seed, it, B, V, X.device), W,
                            vb, hb, cfg.visible, cfg.hidden,
                            sigma_row(cfg, X.device),
                            pll_h_hats(cfg, seed, it, X.device))
    return msre, pll, l2


def h_means_reference(cfg, v, W, hb):
    """Hidden means given visible rows: sigmoid or n softmax of
    ``up * (v W + hb)``."""
    pre = cfg.propup_mult * (v @ W + hb)
    if cfg.hidden == 'multinomial':
        return float(cfg.n_samples) * torch.softmax(pre, dim=1)
    return torch.sigmoid(pre)


def h_sample_reference(cfg, means, seed, it, stream, shard=0):
    if cfg.hidden == 'multinomial':
        return multinomial_counts(means, cfg.n_samples, seed, it, stream)
    return bernoulli(means, seed, it, stream, shard)


def v_means_reference(cfg, h, W, vb, sigma):
    """Visible means given hidden rows: ``down (h W^T) sigma + down vb``
    (GaussianLayer.activation of the doubled input) or
    sigmoid(down (h W^T + vb))."""
    down = cfg.propdown_mult
    if sigma is not None:
        return (down * (h @ W.T)) * sigma + down * vb
    return torch.sigmoid(down * (h @ W.T + vb))


def v_sample_reference(cfg, means, sigma, seed, it, stream, shard=0):
    if sigma is not None:
        return means + normal(seed, it, stream, means.shape,
                              means.device, shard) * sigma
    return bernoulli(means, seed, it, stream, shard)


def bias_stats_reference(X, v_states, h0, h_means, p, lr, mom, damp, cost,
                         target, v_means=None):
    """K2's function (``bm_cd_bias_stats``) in torch ops: one step's bias
    updates from p's vb, dvb, hb, dhb and q.  Sparsity acts on the batch SUM
    of the chain-end hidden means (Queue C2); ``pen`` is the penalty that
    the association update also subtracts.  With ``v_means``, also
    ``msre_col``, the msre's column sums over the batch."""
    dvb = lr * (mom * p['dvb'] + torch.mean(X - v_states, dim=0))
    q = damp * p['q'] + (1. - damp) * torch.sum(h_means, dim=0)
    pen = cost * (q - target)
    dhb = lr * (mom * p['dhb'] + torch.mean(h0 - h_means, dim=0) - pen)
    out = {'vb': p['vb'] + dvb, 'dvb': dvb, 'hb': p['hb'] + dhb,
           'dhb': dhb, 'q': q, 'pen': pen}
    if v_means is not None:
        out['msre_col'] = torch.sum(torch.square(X - v_means), dim=0)
    return out


def cd_epoch_reference(cfg, state, X_batches, lr, momentum, seed, iter0):
    """The plain PyTorch version of the epoch (see module docstring)."""
    W, vb, hb, dW, dvb, dhb, q = (state[key] for key in STATE_KEYS)
    NB, B, V = X_batches.shape
    lr, mom = float(lr), float(momentum)
    damp = cfg.sparsity_damping
    sigma = sigma_row(cfg, X_batches.device)
    rows = [torch.zeros(NB, dtype=X_batches.dtype, device=X_batches.device)
            for _ in range(3)]
    msre_rows, pll_rows, l2_rows = rows
    for i in range(NB):
        X = X_batches[i]
        it = int(iter0) + i + 1
        h0 = h_means_reference(cfg, X, W, hb)
        h_states = h_sample_reference(cfg, h0, seed, it, STREAM_H0) \
            if cfg.sample_h_states else h0
        # k = 0 follows the TPU kernels: v_states = X and h_means = h0
        v_means, v_states, h_means = X, X, h0
        for s in range(cfg.k):
            v_means = v_means_reference(cfg, h_states, W, vb, sigma)
            v_states = v_sample_reference(cfg, v_means, sigma, seed, it,
                                          stream_v(s)) \
                if cfg.sample_v_states else v_means
            h_means = h_means_reference(cfg, v_states, W, hb)
            h_states = h_sample_reference(cfg, h_means, seed, it,
                                          stream_h(s)) \
                if cfg.sample_h_states else h_means

        dW_grad = (X.T @ h0 - v_states.T @ h_means) / B - cfg.l2 * W
        bias = bias_stats_reference(
            X, v_states, h0, h_means,
            {'vb': vb, 'dvb': dvb, 'hb': hb, 'dhb': dhb, 'q': q}, lr, mom,
            damp, cfg.sparsity_cost, cfg.sparsity_target)
        # the penalty is also subtracted from every row of dW (Queue C2)
        dW = lr * (mom * dW + dW_grad - bias['pen'])
        W = W + dW
        vb, dvb, hb, dhb, q = (bias[key]
                               for key in ('vb', 'dvb', 'hb', 'dhb', 'q'))

        # metrics read the UPDATED parameters (Queue C3)
        if it % cfg.metrics_every == 0:
            msre_rows[i] = torch.mean(torch.square(X - v_means))
            l2_rows[i] = cfg.l2 * 0.5 * torch.sum(W * W)
            if cfg.compute_pll:
                flip = pll_flip_index(seed, it, B, V, X.device)
                pll_rows[i] = pll_from_flip(
                    X, flip, W, vb, hb, cfg.visible, cfg.hidden, sigma,
                    pll_h_hats(cfg, seed, it, X.device))
    new_state = dict(zip(STATE_KEYS, (W, vb, hb, dW, dvb, dhb, q)))
    return new_state, msre_rows, pll_rows, l2_rows


# ---------------------------------------------------------------------- #
# CUDA kernels                                                            #
# ---------------------------------------------------------------------- #
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_U = ctypes.c_uint
_F = ctypes.c_float


class EpochLoop(ctypes.Structure):
    """The ``CdEpochLoop`` struct of csrc/cd_epoch.cu (same field order):
    one ``cd_epoch`` call's launches, for ``bm_cd_epoch_loop``."""
    _fields_ = (
        [(n, _P) for n in (
            'X', 'sigma', 'streams', 'W', 'vb', 'hb', 'dW', 'dvb', 'dhb', 'q',
            'h0', 'v_means', 'h_means', 'h_samp', 'v_samp', 'pre', 'pen',
            'msre_col', 'h_ws', 'h_counters', 'v_ws', 'v_counters',
            'met_rows', 'met_hh', 'met_partials', 'met_counter', 'msre_rows',
            'pll_rows', 'l2_rows')] +
        [('metrics_every', _L)] +
        [(n, _I) for n in (
            'NB', 'B', 'V', 'H', 'k', 'n', 'sample_v', 'sample_h',
            'compute_pll', 'h_tile', 'h_splits', 'v_tile', 'v_splits',
            'assoc_tile', 'w_rows')] +
        [(n, _F) for n in ('up', 'down', 'l2', 'lr', 'mom', 'damp',
                           'one_minus_damp', 'cost', 'target')] +
        [(n, _U) for n in ('seed', 'iter0')])


#: the kernels whose launches ``bm_cd_epoch_loop`` counts, in its order
LOOP_KERNELS = KERNELS[:5]
_ARGTYPES = {
    'bm_cd_epoch_loop': [ctypes.POINTER(EpochLoop), ctypes.POINTER(_L),
                         ctypes.POINTER(_I), _P],
    'bm_cd_gemm_act': [_P, _L, _L, _P, _L, _L, _P, _P, _F, _I, _I, _I, _I,
                       _P, _P, _U, _U, _U, _U, _I, _I, _P, _P, _P],
    'bm_cd_softmax_sample': [_P, _I, _I, _I, _I, _P, _P, _U, _U, _U, _P],
    'bm_cd_bias_stats': [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P,
                         _P, _P, _F, _F, _F, _F, _F, _F, _P],
    'bm_cd_assoc_update': [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _F, _F,
                           _F, _I, _P],
    'bm_cd_metrics_fe': [_P, _P, _P, _I, _I, _I, _U, _U, _I, _I, _P, _P, _P,
                         _P],
    'bm_cd_metrics_draw': [_I, _I, _U, _U, _P, _P],
    'bm_cd_metrics': [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _P, _P,
                      _I, _U, _U, _P, _P, _P, _P, _P, _P],
    'bm_cd_stats_sums': [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P],
    'bm_cd_assoc_stats': [_P, _P, _P, _P, _I, _I, _I, _P, _I, _P],
    'bm_bernoulli_sample': [_P, _P, _U, _U, _U, _P],
    'bm_normal_sample': [_P, _U, _U, _P],
    'bm_fe_probe': [_P, _P, _P, _P, _P, _I, _I, _I, _I, _U, _I, _I, _I, _P,
                    _P, _P, _P, _P, _P, _P, _P],
    'bm_cd_val_fe': [_P, _P, _P, _I, _I, _I, _I, _U, _U, _I, _I, _P, _P, _P,
                     _P],
    'bm_cd_val_draw': [_I, _I, _I, _I, _U, _U, _P, _P],
    'bm_cd_val_reduce': [_P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I,
                         _I, _U, _U, _L, _I, _I, _P, _P, _P, _P, _P, _P],
}
# epilogues of cd_gemm_act (csrc/cd_epoch.cu)
ACT_SIGMOID, ACT_GAUSSIAN, ACT_PRE = 0, 1, 2
#: cd_metrics' pass over W (csrc/cd_epoch.cu): at most this many rows of W
#: a block (the kernel's kMaxWRows), about this many blocks an SM
METRICS_MAX_ROWS = 64
METRICS_BLOCKS_PER_SM = 4
_BOUND = {}


def library():
    """The built kernel library with its C signatures declared."""
    if 'lib' not in _BOUND:
        from ._build import load_library
        lib = load_library('cd_epoch')
        for name, argtypes in _ARGTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _BOUND['lib'] = lib
    return _BOUND['lib']


def check_launch(err, name):
    if err != 0:
        raise RuntimeError('{0} launch failed: CUDA error {1}'.format(name,
                                                                     err))


def ptr(t, offset=0):
    return None if t is None else t.data_ptr() + 4 * offset


def check_tensors(pairs, device, shapes):
    """Raise unless every (tensor, name) is a contiguous float32 tensor on
    `device` with the shape `shapes` gives its name (if any)."""
    for t, name in pairs:
        if t.device != device or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError('{0} must be a contiguous float32 tensor on {1}'
                             .format(name, device))
        if name in shapes and tuple(t.shape) != shapes[name]:
            raise ValueError('{0} has shape {1}, expected {2}'.format(
                name, tuple(t.shape), shapes[name]))


def _launch_gemm_act(lib, stream, A, W, transposed_w, bias, sigma, mult,
                     act, means, states, seed, it, stream_id, shard=0,
                     launches=None, splits=None):
    """cd_gemm_act on A (M, K) with unit column stride and W (V, H): A.W
    (K = V, N = H) or A.W^T (K = H, N = V), with the epilogue `act`, on the
    tensor-core tile with the plan of ``ops/gemm.py`` (`splits` K slices
    instead of the plan's, where given); the launch counts in `launches`
    (default: the epoch's)."""
    V, H = W.shape
    M = A.shape[0]
    N, K = (V, H) if transposed_w else (H, V)
    sam, (sbk, sbn) = check_operand(A, W, transposed_w)
    plan, ws, counters = launch_plan(M, N, K, A.device, stream, splits)
    check_launch(lib.bm_cd_gemm_act(
        ptr(A), sam, 1, ptr(W), sbk, sbn, ptr(bias), ptr(sigma), mult, act, M,
        N, K, ptr(means), ptr(states), seed, it, stream_id, shard,
        plan.n_tile, plan.splits, ptr(ws), ptr(counters), stream),
        'cd_gemm_act')
    (cd_epoch.launches if launches is None else launches)['cd_gemm_act'] += 1
    count_stages('gemm_act', plan.k_tiles, plan.splits)


def _launch_h_pass(lib, stream, cfg, A, W, hb, means, states, pre, seed, it,
                   stream_id, shard=0, launches=None):
    if cfg.hidden != 'multinomial':
        _launch_gemm_act(lib, stream, A, W, False, hb, None, cfg.propup_mult,
                         ACT_SIGMOID, means, states, seed, it, stream_id,
                         shard, launches)
        return
    # the softmax needs whole rows: the GEMM writes up * (A.W + hb), a row
    # kernel turns it into means and counts
    _launch_gemm_act(lib, stream, A, W, False, hb, None, cfg.propup_mult,
                     ACT_PRE, pre, None, seed, it, stream_id)
    check_launch(lib.bm_cd_softmax_sample(
        ptr(pre), 1, A.shape[0], W.shape[1], cfg.n_samples, ptr(means),
        ptr(states), seed, it, stream_id, stream), 'cd_softmax_sample')
    cd_epoch.launches['cd_softmax_sample'] += 1


def _launch_v_pass(lib, stream, cfg, A, W, vb, sigma, means, states, seed,
                   it, stream_id, shard=0, launches=None):
    act = ACT_SIGMOID if sigma is None else ACT_GAUSSIAN
    _launch_gemm_act(lib, stream, A, W, True, vb, sigma, cfg.propdown_mult,
                     act, means, states, seed, it, stream_id, shard, launches)


def metrics_plan(V, n_sm):
    """(rows of W a block, blocks) of cd_metrics' pass over W on a card of
    `n_sm` SMs: a multiple of 8 rows (one a warp) that gives about
    METRICS_BLOCKS_PER_SM blocks an SM, at most METRICS_MAX_ROWS."""
    rows = min(METRICS_MAX_ROWS,
               8 * -(-V // (8 * METRICS_BLOCKS_PER_SM * n_sm)))
    return rows, -(-V // rows)


def metrics_workspace(V, H, B, device):
    """The scratch of cd_metrics' launches at batch B: the first launch's
    row sums (Bernoulli hidden units) or count vectors (multinomial), six
    partial sums per block of the pass over W, and its zeroed counter."""
    rows, blocks = metrics_plan(V, num_sms(device))

    def empty(n):
        return torch.empty(n, dtype=torch.float32, device=device)
    return {'w_rows': rows, 'rows': empty(2 * B * -(-H // TILE_M)),
            'hh': empty(2 * H), 'partials': empty(6 * blocks),
            'counter': torch.zeros(1, dtype=torch.int32, device=device)}


def _launch_metrics(lib, stream, cfg, X, W, vb, hb, sigma, msre_col, seed,
                    it, ws, outs, launches=None):
    """cd_metrics of one logged step on the contiguous batch `X` (B, V):
    with the PLL, first X.W on the tensor-core tile with the free-energy
    epilogue (Bernoulli hidden units; the plan of ``ops/gemm.py``) or the
    two count vectors (multinomial), then the pass over W, whose last block
    writes msre, pll and l2 to the addresses `outs`.  `ws` is
    ``metrics_workspace``'s; each launch counts in `launches` (default: the
    epoch's)."""
    B, V = X.shape
    H = W.shape[1]
    n = cfg.n_samples if cfg.hidden == 'multinomial' else 0
    count = cd_epoch.launches if launches is None else launches
    fe_tiles = 0
    if cfg.compute_pll and n:
        check_launch(lib.bm_cd_metrics_draw(H, n, seed, it, ptr(ws['hh']),
                                            stream), 'cd_metrics')
        count['cd_metrics'] += 1
    elif cfg.compute_pll:
        plan, tws, counters = launch_plan(B, H, V, X.device, stream)
        check_launch(lib.bm_cd_metrics_fe(
            ptr(X), ptr(W), ptr(hb), B, V, H, seed, it, plan.n_tile,
            plan.splits, ptr(tws), ptr(counters), ptr(ws['rows']), stream),
            'cd_metrics')
        count['cd_metrics'] += 1
        count_stages('fe_rows', plan.k_tiles, plan.splits)
        fe_tiles = plan.model_tiles
    check_launch(lib.bm_cd_metrics(
        ptr(X), ptr(W), ptr(vb), ptr(sigma), ptr(msre_col), B, V, H,
        ws['w_rows'], cfg.l2, int(cfg.compute_pll), n, ptr(ws['hh']),
        ptr(ws['rows']), fe_tiles, seed, it, ptr(ws['partials']),
        ptr(ws['counter']), *outs, stream), 'cd_metrics')
    count['cd_metrics'] += 1


def _metrics(cfg, X, W, vb, hb, msre_col, seed, it):
    """(msre, pll, l2) of one logged step -- on CUDA tensors by K4's
    launches (``_launch_metrics``), on CPU tensors by
    ``metrics_reference``.  A test hook; the epoch launches K4 itself."""
    dev = X.device
    if dev.type == 'cpu':
        return metrics_reference(cfg, X, W, vb, hb, msre_col, seed, it)
    B, V = X.shape
    H = cfg.n_hidden
    check_tensors([(X, 'X'), (W, 'W'), (vb, 'vb'), (hb, 'hb'),
                   (msre_col, 'msre_col')], dev,
                  {'X': (B, V), 'W': (V, H), 'vb': (V,), 'hb': (H,),
                   'msre_col': (V,)})
    out = torch.zeros(3, dtype=torch.float32, device=dev)
    _launch_metrics(library(), torch.cuda.current_stream(dev).cuda_stream,
                    cfg, X, W, vb, hb, sigma_row(cfg, dev), msre_col,
                    int(seed), int(it), metrics_workspace(V, H, B, dev),
                    [ptr(out, j) for j in range(3)])
    return out[0], out[1], out[2]


# test hooks: one pass of the chain, kernel vs plain, draw by draw; no
# library code calls them
def _gibbs_pass_reference(cfg, layer, A, W, bias, seed, it, stream_id,
                          sample=True, shard=0):
    """The plain version of ``_gibbs_pass``, on any device."""
    if layer == 'h':
        means = h_means_reference(cfg, A, W, bias)
        return means, (h_sample_reference(cfg, means, seed, it, stream_id,
                                          shard) if sample else None)
    sigma = sigma_row(cfg, A.device)
    means = v_means_reference(cfg, A, W, bias, sigma)
    return means, (v_sample_reference(cfg, means, sigma, seed, it, stream_id,
                                      shard) if sample else None)


def _gibbs_pass(cfg, layer, A, W, bias, seed, it, stream_id, sample=True,
                shard=0):
    """One pass of the epoch's chain on the rows `A`: layer 'h' gives the
    hidden (means, states) given visible rows, 'v' the visible ones given
    hidden rows (states None unless `sample`) -- on CUDA tensors by the
    epoch's own kernels and launch helpers, on CPU tensors by the plain
    version; `shard` is the data-parallel stats kernels' counter word.
    Lets a caller hold the kernels' sampled states against the plain
    version's on the same inputs."""
    dev = A.device
    if dev.type == 'cpu':
        return _gibbs_pass_reference(cfg, layer, A, W, bias, seed, it,
                                     stream_id, sample, shard)
    sigma = sigma_row(cfg, dev) if layer == 'v' else None
    V, H = W.shape
    check_tensors([(A, 'A'), (W, 'W'), (bias, 'bias')], dev,
                  {'A': (A.shape[0], V if layer == 'h' else H),
                   'bias': (H if layer == 'h' else V,)})
    n = A.shape[0], (H if layer == 'h' else V)
    means = torch.empty(n, dtype=torch.float32, device=dev)
    states = torch.empty(n, dtype=torch.float32, device=dev) \
        if sample else None
    lib, stream = library(), torch.cuda.current_stream(dev).cuda_stream
    if layer == 'h':
        pre = torch.empty(n, dtype=torch.float32, device=dev) \
            if cfg.hidden == 'multinomial' else None
        _launch_h_pass(lib, stream, cfg, A, W, bias, means, states, pre,
                       int(seed), int(it), int(stream_id), int(shard))
    else:
        _launch_v_pass(lib, stream, cfg, A, W, bias, sigma, means, states,
                       int(seed), int(it), int(stream_id), int(shard))
    return means, states


def _cd_epoch_cuda(cfg, state, X_batches, lr, momentum, seed, iter0):
    """Launch the kernels of ``csrc/cd_epoch.cu`` for every minibatch: one
    call of ``bm_cd_epoch_loop`` issues every step's launches, from the
    plans, buffers and Philox streams worked out here once."""
    V, H = cfg.n_visible, cfg.n_hidden
    if X_batches.dim() != 3 or X_batches.shape[2] != V \
            or X_batches.shape[0] < 1 or X_batches.shape[1] < 1:
        raise ValueError('X_batches must be (n_batches, batch_size, {0}), '
                         'got {1}'.format(V, tuple(X_batches.shape)))
    check_tensors([(X_batches, 'X_batches')] +
                  [(state[key], key) for key in STATE_KEYS],
                  X_batches.device,
                  {'W': (V, H), 'vb': (V,), 'hb': (H,), 'dW': (V, H),
                   'dvb': (V,), 'dhb': (H,), 'q_means': (H,)})
    NB, B = int(X_batches.shape[0]), int(X_batches.shape[1])
    multinomial = cfg.hidden == 'multinomial'
    n = cfg.n_samples if multinomial else 0
    if not (0 <= int(seed) < 2 ** 32 and 0 <= int(iter0)
            and int(iter0) + NB < 2 ** 32
            and B * max(V, H, n) < 2 ** 32):
        raise ValueError('seed, iterations and draw indices must fit in 32 '
                         'bits')

    lib = library()
    dev = X_batches.device
    # the epoch updates copies of the state in place, batch after batch
    W, vb, hb, dW, dvb, dhb, q = (state[key].clone() for key in STATE_KEYS)
    sigma = sigma_row(cfg, dev)

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    h0, v_means, h_means = empty(B, H), empty(B, V), empty(B, H)
    h_samp = empty(B, H) if cfg.sample_h_states else None
    v_samp = empty(B, V) if cfg.sample_v_states else None
    pre = empty(B, H) if multinomial else None
    pen, msre_col = empty(H), empty(V)
    met_ws = metrics_workspace(V, H, B, dev)
    msre_rows, pll_rows, l2_rows = (torch.zeros(NB, dtype=torch.float32,
                                                device=dev)
                                    for _ in range(3))
    stream = torch.cuda.current_stream(dev).cuda_stream
    h_plan, h_ws, h_counters = launch_plan(B, H, V, dev, stream)
    v_plan, v_ws, v_counters = launch_plan(B, V, H, dev, stream)
    # the Philox stream of every pass of a step, in the order of its passes
    ids = [STREAM_H0] + [sid for s in range(cfg.k)
                         for sid in (stream_v(s), stream_h(s))]
    streams = (ctypes.c_uint * len(ids))(*ids)
    damp = cfg.sparsity_damping
    args = EpochLoop(
        X=ptr(X_batches), sigma=ptr(sigma), streams=ctypes.addressof(streams),
        W=ptr(W), vb=ptr(vb), hb=ptr(hb), dW=ptr(dW), dvb=ptr(dvb),
        dhb=ptr(dhb), q=ptr(q), h0=ptr(h0), v_means=ptr(v_means),
        h_means=ptr(h_means), h_samp=ptr(h_samp), v_samp=ptr(v_samp),
        pre=ptr(pre), pen=ptr(pen), msre_col=ptr(msre_col), h_ws=ptr(h_ws),
        h_counters=ptr(h_counters), v_ws=ptr(v_ws),
        v_counters=ptr(v_counters), met_rows=ptr(met_ws['rows']),
        met_hh=ptr(met_ws['hh']), met_partials=ptr(met_ws['partials']),
        met_counter=ptr(met_ws['counter']), msre_rows=ptr(msre_rows),
        pll_rows=ptr(pll_rows), l2_rows=ptr(l2_rows), NB=NB, B=B, V=V, H=H,
        k=cfg.k, n=n, sample_v=int(cfg.sample_v_states),
        sample_h=int(cfg.sample_h_states),
        compute_pll=int(cfg.compute_pll), metrics_every=cfg.metrics_every,
        h_tile=h_plan.n_tile, h_splits=h_plan.splits, v_tile=v_plan.n_tile,
        v_splits=v_plan.splits,
        assoc_tile=assoc_plan(V, H, num_sms(dev)).n_tile,
        w_rows=met_ws['w_rows'], up=cfg.propup_mult, down=cfg.propdown_mult,
        l2=cfg.l2, lr=float(lr), mom=float(momentum), damp=damp,
        one_minus_damp=1. - damp, cost=cfg.sparsity_cost,
        target=cfg.sparsity_target, seed=int(seed), iter0=int(iter0))
    made = (ctypes.c_longlong * len(LOOP_KERNELS))()
    failed = (ctypes.c_int * 2)()
    err = lib.bm_cd_epoch_loop(ctypes.byref(args), made, failed, stream)
    for name, count in zip(LOOP_KERNELS, made):
        cd_epoch.launches[name] += count
    if err:
        check_launch(err, "step {0}'s {1}".format(failed[0],
                                                  LOOP_KERNELS[failed[1]]))
    # the loop's plans are fixed for the call: its products, free-energy
    # rows and associations walk these k-tiles a block
    sched = epoch_launches(cfg, NB, iter0)
    count_stages('gemm_act', h_plan.k_tiles, h_plan.splits, NB * (1 + cfg.k))
    count_stages('gemm_act', v_plan.k_tiles, v_plan.splits, NB * cfg.k)
    if cfg.compute_pll and not multinomial:
        count_stages('fe_rows', h_plan.k_tiles, h_plan.splits,
                     sched['cd_metrics'] // 2)
    count_stages('assoc', assoc_k_tiles(B, B), 1, sched['cd_assoc_update'])
    cd_epoch.loop['calls'] += 1
    cd_epoch.loop['steps'] += NB
    new_state = dict(zip(STATE_KEYS, (W, vb, hb, dW, dvb, dhb, q)))
    return new_state, msre_rows, pll_rows, l2_rows


def cd_epoch(cfg, state, X_batches, lr, momentum, seed, iter0):
    """One CD-k epoch: the CUDA kernels for a CUDA tensor, the plain version
    for a CPU tensor."""
    if X_batches.device.type == 'cuda':
        return _cd_epoch_cuda(cfg, state, X_batches, lr, momentum, seed,
                              iter0)
    if X_batches.device.type == 'cpu':
        return cd_epoch_reference(cfg, state, X_batches, lr, momentum, seed,
                                  iter0)
    raise ValueError('cd_epoch runs on CUDA (kernels) or the CPU (plain '
                     'version), not on {0}'.format(X_batches.device))


cd_epoch.launches = dict.fromkeys(KERNELS, 0)
cd_epoch.loop = {'calls': 0, 'steps': 0}


def epoch_launches(cfg, NB, iter0):
    """{kernel: launches} of `NB` CD steps from iteration ``iter0 + 1`` on
    CUDA, as ``bm_cd_epoch_loop`` issues them: a step's 1 + 2k products
    (each hidden one followed by a softmax row launch for multinomial hidden
    units), K2 and K3, and on the steps with ``it % metrics_every == 0`` the
    pass over W, after a first metrics launch where the PLL is on."""
    multinomial = cfg.hidden == 'multinomial'
    logged = (iter0 + NB) // cfg.metrics_every - iter0 // cfg.metrics_every
    out = dict.fromkeys(KERNELS, 0)
    out.update(cd_gemm_act=NB * (1 + 2 * cfg.k),
               cd_softmax_sample=NB * (1 + cfg.k) if multinomial else 0,
               cd_bias_stats=NB, cd_assoc_update=NB,
               cd_metrics=logged * (1 + int(cfg.compute_pll)))
    return out


def reset_launches():
    """Zero every launch count, the C step loop's counts, the whole-set
    pass counts of ``ops/cd_val.py`` beside them and the tile's k-tile
    counts (``gemm.tile_stages``)."""
    from .cd_val import cd_val
    reset_stages()
    for name in KERNELS:
        cd_epoch.launches[name] = 0
    for name in cd_epoch.loop:
        cd_epoch.loop[name] = 0
    for name in cd_val.passes:
        cd_val.passes[name] = 0
