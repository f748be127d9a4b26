"""The CD-k training epoch of a Bernoulli x Bernoulli RBM.

Port of the TPU's fused epoch kernel ``make_cd_epoch_kernel`` /
``_cd_epoch_kernel`` (boltzmann_machines_tpu/ops/pallas_ops.py:1266,
body :262-509), with the same contract::

    epoch = make_cd_epoch_kernel(n_visible, n_hidden, batch_size, k, ...)
    state, msre_rows, pll_rows, l2_rows = epoch(state, X_batches, lr,
                                                momentum, seed, iter0)

`state` is the dict {W, vb, hb, dW, dvb, dhb, q_means}; `X_batches` is
(n_batches, batch_size, n_visible) float32; the rows are (n_batches,) and
hold the metrics of every iteration ``it = iter0 + i + 1`` with
``it % metrics_every == 0`` (zero elsewhere).  The input state is not
modified.

Three parts:

* ``cd_epoch_reference`` -- the plain PyTorch version (torch.matmul);
* ``cd_epoch`` -- the wrapper: a CPU tensor runs the plain version, a CUDA
  tensor launches the hand-written kernels of ``csrc/cd_epoch.cu`` (built
  on first use) or raises;
* ``cd_epoch.launches`` -- how many times each kernel was launched.

Random draws (sampled states, the PLL flip) come from the Philox stream of
``ops/philox.py``, which the kernels reproduce exactly.
"""

import ctypes
from collections import namedtuple

import torch
import torch.nn.functional as F

from .philox import (STREAM_H0, STREAM_PLL, bernoulli, philox_uniform,
                     stream_h, stream_v)

STATE_KEYS = ('W', 'vb', 'hb', 'dW', 'dvb', 'dhb', 'q_means')
KERNELS = ('cd_gemm_act', 'cd_bias_stats', 'cd_assoc_update', 'cd_metrics')

CDEpochConfig = namedtuple('CDEpochConfig', (
    'n_visible', 'n_hidden', 'k', 'sample_v_states', 'sample_h_states',
    'propup_mult', 'propdown_mult', 'l2', 'sparsity_target', 'sparsity_cost',
    'sparsity_damping', 'metrics_every', 'compute_pll'))


def make_cd_epoch_kernel(n_visible, n_hidden, batch_size, k,
                         sample_v_states, sample_h_states,
                         propup_mult, propdown_mult,
                         l2, sparsity_target, sparsity_cost,
                         sparsity_damping, metrics_every,
                         compute_pll=True, visible='bernoulli', sigma=None,
                         hidden='bernoulli', n_samples=None):
    """Build ``epoch(state, X_batches, lr, momentum, seed, iter0)`` with the
    static configuration of the JAX factory.  `batch_size` is kept for that
    signature; the epoch takes any batch size (the remainder batch of a fit
    runs through it with its own row count)."""
    if visible != 'bernoulli':
        raise NotImplementedError(
            'Gaussian visible units: the CD epoch kernel covers Bernoulli x '
            'Bernoulli only (ROADMAP.md Queue B2, Gaussian variant)')
    if hidden != 'bernoulli':
        raise NotImplementedError(
            'multinomial hidden units: the CD epoch kernel covers Bernoulli '
            'x Bernoulli only (ROADMAP.md Queue B2, multinomial variant)')
    if int(k) < 0 or int(metrics_every) < 1:
        raise ValueError('need k >= 0 and metrics_every >= 1')
    cfg = CDEpochConfig(
        int(n_visible), int(n_hidden), int(k), bool(sample_v_states),
        bool(sample_h_states), float(propup_mult), float(propdown_mult),
        float(l2), float(sparsity_target), float(sparsity_cost),
        float(sparsity_damping), int(metrics_every), bool(compute_pll))

    def epoch(state, X_batches, lr, momentum, seed, iter0):
        return cd_epoch(cfg, state, X_batches, lr, momentum, seed, iter0)

    return epoch


# ---------------------------------------------------------------------- #
# plain version                                                           #
# ---------------------------------------------------------------------- #
def free_energy_sum(X, act, vb, hb):
    """Batch-SUM free energy of Bernoulli visibles and hidden units given
    ``act = X @ W`` -- the counterpart of the JAX kernel's
    ``_free_energy_sum`` (pallas_ops.py:185) for this flavour."""
    return -torch.sum(X * vb) - torch.sum(F.softplus(act + hb))


def pll_from_flip(X, flip_idx, W, vb, hb):
    """PLL proxy of one batch given the flipped unit of each row:
    ``n_visible * log_sigmoid(fe(X_flip) - fe(X))`` with batch-MEAN free
    energies and no dbm doubling (ROADMAP.md Queue C4)."""
    B, V = X.shape
    rows = torch.arange(B, device=X.device)
    Xf = X.clone()
    Xf[rows, flip_idx] = 1. - X[rows, flip_idx]
    fe = free_energy_sum(X, X @ W, vb, hb) / B
    fe_f = free_energy_sum(Xf, Xf @ W, vb, hb) / B
    return V * F.logsigmoid(fe_f - fe)


def pll_flip_index(seed, it, batch_size, n_visible, device):
    """The flipped unit of each row at iteration `it`: ``floor(u * V)``."""
    u = philox_uniform(seed, it, STREAM_PLL, (batch_size,), device)
    return (u * n_visible).to(torch.int64)


def cd_epoch_reference(cfg, state, X_batches, lr, momentum, seed, iter0):
    """The plain PyTorch version of the epoch (see module docstring)."""
    W, vb, hb, dW, dvb, dhb, q = (state[key] for key in STATE_KEYS)
    NB, B, V = X_batches.shape
    up, down = cfg.propup_mult, cfg.propdown_mult
    lr, mom = float(lr), float(momentum)
    damp = cfg.sparsity_damping
    rows = [torch.zeros(NB, dtype=X_batches.dtype, device=X_batches.device)
            for _ in range(3)]
    msre_rows, pll_rows, l2_rows = rows
    for i in range(NB):
        X = X_batches[i]
        it = int(iter0) + i + 1
        h0 = torch.sigmoid(up * (X @ W + hb))
        h_states = bernoulli(h0, seed, it, STREAM_H0) \
            if cfg.sample_h_states else h0
        # k = 0 follows the TPU kernels: v_states = X and h_means = h0
        v_means, v_states, h_means = X, X, h0
        for s in range(cfg.k):
            v_means = torch.sigmoid(down * (h_states @ W.T + vb))
            v_states = bernoulli(v_means, seed, it, stream_v(s)) \
                if cfg.sample_v_states else v_means
            h_means = torch.sigmoid(up * (v_states @ W + hb))
            h_states = bernoulli(h_means, seed, it, stream_h(s)) \
                if cfg.sample_h_states else h_means

        dW_grad = (X.T @ h0 - v_states.T @ h_means) / B - cfg.l2 * W
        dvb_grad = torch.mean(X - v_states, dim=0)
        dhb_grad = torch.mean(h0 - h_means, dim=0)
        # sparsity acts on the batch SUM of the chain-end hidden means, and
        # the penalty is subtracted from every row of dW (Queue C2)
        q = damp * q + (1. - damp) * torch.sum(h_means, dim=0)
        penalty = cfg.sparsity_cost * (q - cfg.sparsity_target)
        dW = lr * (mom * dW + dW_grad - penalty)
        dvb = lr * (mom * dvb + dvb_grad)
        dhb = lr * (mom * dhb + dhb_grad - penalty)
        W = W + dW
        vb = vb + dvb
        hb = hb + dhb

        # metrics read the UPDATED parameters (Queue C3)
        if it % cfg.metrics_every == 0:
            msre_rows[i] = torch.mean(torch.square(X - v_means))
            l2_rows[i] = cfg.l2 * 0.5 * torch.sum(W * W)
            if cfg.compute_pll:
                flip = pll_flip_index(seed, it, B, V, X.device)
                pll_rows[i] = pll_from_flip(X, flip, W, vb, hb)
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
_ARGTYPES = {
    'bm_cd_gemm_act': [_P, _L, _L, _P, _L, _L, _P, _F, _I, _I, _I, _P, _P,
                       _U, _U, _U, _P],
    'bm_cd_bias_stats': [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P,
                         _P, _P, _F, _F, _F, _F, _F, _F, _P],
    'bm_cd_assoc_update': [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _F, _F,
                           _F, _P],
    'bm_cd_metrics': [_P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _U, _U, _P, _P,
                      _P, _P, _P, _P],
}
_BOUND = {}


def _library():
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


def _check(err, name):
    if err != 0:
        raise RuntimeError('{0} launch failed: CUDA error {1}'.format(name,
                                                                     err))


def _ptr(t, offset=0):
    return None if t is None else t.data_ptr() + 4 * offset


def _cd_epoch_cuda(cfg, state, X_batches, lr, momentum, seed, iter0):
    """Launch the kernels of ``csrc/cd_epoch.cu`` for every minibatch."""
    V, H = cfg.n_visible, cfg.n_hidden
    if X_batches.dim() != 3 or X_batches.shape[2] != V \
            or X_batches.shape[0] < 1 or X_batches.shape[1] < 1:
        raise ValueError('X_batches must be (n_batches, batch_size, {0}), '
                         'got {1}'.format(V, tuple(X_batches.shape)))
    shapes = {'W': (V, H), 'vb': (V,), 'hb': (H,), 'dW': (V, H),
              'dvb': (V,), 'dhb': (H,), 'q_means': (H,)}
    for t, name in [(X_batches, 'X_batches')] + \
            [(state[key], key) for key in STATE_KEYS]:
        if t.device != X_batches.device or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError('{0} must be a contiguous float32 tensor on {1}'
                             .format(name, X_batches.device))
        if name in shapes and tuple(t.shape) != shapes[name]:
            raise ValueError('{0} has shape {1}, expected {2}'.format(
                name, tuple(t.shape), shapes[name]))
    if not (0 <= int(seed) < 2 ** 32 and 0 <= int(iter0)
            and int(iter0) + X_batches.shape[0] < 2 ** 32):
        raise ValueError('seed and iterations must fit in 32 bits')

    lib = _library()
    launches = cd_epoch.launches
    dev = X_batches.device
    NB, B = int(X_batches.shape[0]), int(X_batches.shape[1])
    # the epoch updates copies of the state in place, batch after batch
    W, vb, hb, dW, dvb, dhb, q = (state[key].clone() for key in STATE_KEYS)

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    h0, v_means, h_means = empty(B, H), empty(B, V), empty(B, H)
    h_samp = empty(B, H) if cfg.sample_h_states else None
    v_samp = empty(B, V) if cfg.sample_v_states else None
    pen, msre_col = empty(H), empty(V)
    partials = empty(3 * B)
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    msre_rows, pll_rows, l2_rows = (torch.zeros(NB, dtype=torch.float32,
                                                device=dev)
                                    for _ in range(3))
    stream = torch.cuda.current_stream(dev).cuda_stream
    lr, mom = float(lr), float(momentum)
    up, down = cfg.propup_mult, cfg.propdown_mult
    seed = int(seed)

    def gemm_act(A, transposed_w, bias, mult, M, N, K, means, states, it,
                 stream_id):
        # A (M, K) row-major; B = W (K = V, N = H) or W^T (K = H, N = V)
        sbk, sbn = (1, H) if transposed_w else (H, 1)
        _check(lib.bm_cd_gemm_act(
            _ptr(A), K, 1, _ptr(W), sbk, sbn, _ptr(bias), mult, M, N, K,
            _ptr(means), _ptr(states), seed, it, stream_id, stream),
            'cd_gemm_act')
        launches['cd_gemm_act'] += 1

    for i in range(NB):
        X = X_batches[i]
        it = int(iter0) + i + 1
        gemm_act(X, False, hb, up, B, H, V, h0, h_samp, it, STREAM_H0)
        h_states = h_samp if cfg.sample_h_states else h0
        v_states, v_m, h_m = X, X, h0
        for s in range(cfg.k):
            gemm_act(h_states, True, vb, down, B, V, H, v_means, v_samp, it,
                     stream_v(s))
            v_m = v_means
            v_states = v_samp if cfg.sample_v_states else v_means
            gemm_act(v_states, False, hb, up, B, H, V, h_means, h_samp, it,
                     stream_h(s))
            h_m = h_means
            h_states = h_samp if cfg.sample_h_states else h_means

        damp = cfg.sparsity_damping
        _check(lib.bm_cd_bias_stats(
            _ptr(X), _ptr(v_states), _ptr(v_m), _ptr(h0), _ptr(h_m), B, V, H,
            _ptr(vb), _ptr(dvb), _ptr(hb), _ptr(dhb), _ptr(q), _ptr(pen),
            _ptr(msre_col), lr, mom, damp, 1. - damp, cfg.sparsity_cost,
            cfg.sparsity_target, stream), 'cd_bias_stats')
        launches['cd_bias_stats'] += 1

        _check(lib.bm_cd_assoc_update(
            _ptr(X), _ptr(h0), _ptr(v_states), _ptr(h_m), _ptr(pen), B, V, H,
            _ptr(W), _ptr(dW), lr, mom, cfg.l2, stream), 'cd_assoc_update')
        launches['cd_assoc_update'] += 1

        if it % cfg.metrics_every == 0:
            _check(lib.bm_cd_metrics(
                _ptr(X), _ptr(W), _ptr(vb), _ptr(hb), _ptr(msre_col), B, V, H,
                cfg.l2, int(cfg.compute_pll), seed, it, _ptr(partials),
                _ptr(counter), _ptr(msre_rows, i), _ptr(pll_rows, i),
                _ptr(l2_rows, i), stream), 'cd_metrics')
            launches['cd_metrics'] += 1
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


def reset_launches():
    for name in KERNELS:
        cd_epoch.launches[name] = 0
