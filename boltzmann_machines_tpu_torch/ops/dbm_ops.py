"""The all-Bernoulli DBM's device programs: the PCD / mean-field training
epoch, the particle sampler and the AIS sweep.

Port of the TPU's kernels of boltzmann_machines_tpu/ops/pallas_dbm.py, with
the same factory names and contracts::

    epoch = make_dbm_epoch_kernel(layer_sizes, batch_size, n_particles, k,
                                  max_mf_updates, mf_tol, sample_v, sample_h,
                                  l2, max_norm, sparsity_target,
                                  sparsity_cost, sparsity_damping)
    state, msre_rows, n_mf_rows = epoch(state, X_batches, lr, momentum,
                                        seed, iter0)

    sample = make_dbm_sample_kernel(layer_sizes, n_particles, sample_v,
                                    sample_h)
    state, v_means = sample(state, n_steps, seed)

    ais = make_ais_kernel(n_visible, n_h1, n_h2, n_betas, k, n_runs,
                          sample_v, sample_h0, sample_h1)
    log_w = ais(state, seed, x0)          # (n_runs,), before + log Z0

`state` is the JAX package's DBM pytree: {vb, hb, W, dvb, dhb, dW, q_means,
mu_means, v, H} with per-layer tuples.  The epoch follows the CD epoch's
``iter0`` convention (ops/cd_epoch.py): minibatch ``i`` is global iteration
``it = iter0 + i + 1``, which keys its random draws; the rows hold every
minibatch's msre and mean-field update count.  The epoch takes any batch
size (a fit's remainder batch runs through it with its own row count).
Input states are not modified.  ``n_runs`` may be any positive number (the
TPU's multiple-of-8 rule was a sublane limit).

Each program has three parts:

* a plain PyTorch version (``dbm_epoch_reference``, ``dbm_sample_reference``,
  ``ais_reference``), which the fit path runs on the CPU and the tests hold
  against the JAX package;
* a wrapper (``dbm_epoch``, ``dbm_sample``, ``ais``): a CPU tensor runs the
  plain version, a CUDA tensor launches the hand-written kernels of
  ``csrc/dbm_ops.cu`` (built on first use) or raises;
* ``<wrapper>.launches``: how many times the wrapper launched each kernel.

Random draws come from the Philox streams of ``ops/philox.py``, which the
kernels reproduce exactly, so kernel and plain version draw the same
uniforms.
"""

import ctypes
import math
from collections import namedtuple

import numpy as np
import torch
import torch.nn.functional as F

from .gemm import check_operand, launch_plan
from .philox import AIS_H1, AIS_H2, AIS_V, bernoulli, stream_ais, stream_dbm

STATE_KEYS = ('vb', 'hb', 'W', 'dvb', 'dhb', 'dW', 'q_means', 'mu_means',
              'v', 'H')
#: keys whose value is a tuple with one tensor per layer
LAYER_KEYS = ('hb', 'W', 'dhb', 'dW', 'q_means', 'mu_means', 'H')

EPOCH_KERNELS = ('dbm_gemm_act', 'dbm_bias_update', 'dbm_assoc_update',
                 'dbm_max_norm', 'dbm_msre')
SAMPLE_KERNELS = ('dbm_gemm_act',)
AIS_KERNELS = ('dbm_gemm_act', 'ais_logw')

DBMEpochConfig = namedtuple('DBMEpochConfig', (
    'layer_sizes', 'k', 'max_mf_updates', 'mf_tol', 'sample_v', 'sample_h',
    'l2', 'max_norm', 'sparsity_target', 'sparsity_cost',
    'sparsity_damping'))
DBMSampleConfig = namedtuple('DBMSampleConfig', (
    'layer_sizes', 'sample_v', 'sample_h'))
AISConfig = namedtuple('AISConfig', (
    'n_visible', 'n_h1', 'n_h2', 'n_betas', 'k', 'sample_v', 'sample_h0',
    'sample_h1'))


def make_dbm_epoch_kernel(layer_sizes, batch_size, n_particles, k,
                          max_mf_updates, mf_tol, sample_v, sample_h,
                          l2, max_norm, sparsity_target, sparsity_cost,
                          sparsity_damping):
    """Build ``epoch(state, X_batches, lr, momentum, seed, iter0)`` with the
    static configuration of the JAX factory.  `batch_size` and
    `n_particles` are kept for that signature: the epoch reads both from
    its inputs."""
    layer_sizes = tuple(int(n) for n in layer_sizes)
    L = len(layer_sizes) - 1
    if L < 1 or len(sample_h) != L or len(sparsity_target) != L \
            or len(sparsity_cost) != L:
        raise ValueError('need one sample_h / sparsity entry per hidden '
                         'layer of {0}'.format(layer_sizes))
    if int(k) < 0 or int(max_mf_updates) < 0:
        raise ValueError('need k >= 0 and max_mf_updates >= 0')
    cfg = DBMEpochConfig(
        layer_sizes, int(k), int(max_mf_updates), float(mf_tol),
        bool(sample_v), tuple(bool(s) for s in sample_h), float(l2),
        math.inf if max_norm is None else float(max_norm),
        tuple(float(t) for t in sparsity_target),
        tuple(float(c) for c in sparsity_cost), float(sparsity_damping))

    def epoch(state, X_batches, lr, momentum, seed, iter0):
        return dbm_epoch(cfg, state, X_batches, lr, momentum, seed, iter0)

    return epoch


def make_dbm_sample_kernel(layer_sizes, n_particles, sample_v, sample_h):
    """Build ``sample(state, n_steps, seed) -> (state, v_means)``: `n_steps`
    sampled Gibbs sweeps of the persistent chains, then one sweep on means;
    the v particles take the visible means, H keeps the last sampled
    states."""
    cfg = DBMSampleConfig(tuple(int(n) for n in layer_sizes), bool(sample_v),
                          tuple(bool(s) for s in sample_h))

    def sample(state, n_steps, seed):
        return dbm_sample(cfg, state, n_steps, seed)

    return sample


def make_ais_kernel(n_visible, n_h1, n_h2, n_betas, k, n_runs,
                    sample_v=True, sample_h0=True, sample_h1=True):
    """Build ``ais(state, seed, x0) -> (n_runs,)`` raw log importance
    weights of a 2-layer DBM annealed on h1 along the linear ladder of
    `n_betas` steps (before the ``+ log Z0`` offset)."""
    if int(n_betas) < 1 or int(k) < 0 or int(n_runs) < 1:
        raise ValueError('need n_betas >= 1, k >= 0 and n_runs >= 1')
    cfg = AISConfig(int(n_visible), int(n_h1), int(n_h2), int(n_betas),
                    int(k), bool(sample_v), bool(sample_h0), bool(sample_h1))

    def run(state, seed, x0):
        return ais(cfg, state, seed, x0)

    return run


# ---------------------------------------------------------------------- #
# plain version                                                           #
# ---------------------------------------------------------------------- #
def mean_field(X, W, hb, max_mf_updates, mf_tol):
    """Mean-field fixed point of the hidden layers given `X` (JAX
    ``DBM._mf``, dbm.py:412-481): the bottom-up init with doubled inputs
    below the top layer, then sweeps until the largest change of any unit
    is <= `mf_tol` (compared in X's dtype) or `max_mf_updates` sweeps ran.
    Returns (mu, n_updates); syncs with the host once per sweep."""
    L = len(W)
    T0 = X @ W[0]  # loop-invariant, hoisted as in the JAX package
    mu = [torch.sigmoid(2. * T0 + hb[0])]
    for l in range(1, L):
        T = mu[-1] @ W[l]
        if l < L - 1:
            T = 2. * T
        mu.append(torch.sigmoid(T + hb[l]))
    tol = float(torch.tensor(mf_tol, dtype=X.dtype))
    n, delta = 0, math.inf
    while n < max_mf_updates and delta > tol:
        new = list(mu)
        T = T0 + mu[1] @ W[1].T if L >= 2 else T0
        new[0] = torch.sigmoid(T + hb[0])
        for l in range(1, L - 1):
            T = new[l - 1] @ W[l] + mu[l + 1] @ W[l + 1].T
            new[l] = torch.sigmoid(T + hb[l])
        if L >= 2:
            new[L - 1] = torch.sigmoid(new[L - 2] @ W[L - 1] + hb[L - 1])
        delta = float(torch.stack([torch.max(torch.abs(a - b))
                                   for a, b in zip(new, mu)]).max())
        mu, n = new, n + 1
    return mu, n


def gibbs_sweep(W, vb, hb, v, H, draw=None):
    """One layer-parallel block-Gibbs sweep of the chains (v, H) (JAX
    ``DBM._particles_gibbs_step``, dbm.py:356-388): layer l sees the fresh
    layer l-1 and the stale layer l+1; v is drawn last from the fresh
    H[0].  ``draw(means, layer)`` returns the states of hidden layer
    `layer` (``len(W)`` for v); without it the sweep keeps the means."""
    L = len(W)
    if draw is None:
        def draw(p, _):
            return p
    Hn = list(H)
    T = v @ W[0]
    if L >= 2:
        T = T + H[1] @ W[1].T
    Hn[0] = draw(torch.sigmoid(T + hb[0]), 0)
    for l in range(1, L - 1):
        T = Hn[l - 1] @ W[l] + H[l + 1] @ W[l + 1].T
        Hn[l] = draw(torch.sigmoid(T + hb[l]), l)
    if L >= 2:
        Hn[L - 1] = draw(torch.sigmoid(Hn[L - 2] @ W[L - 1] + hb[L - 1]),
                         L - 1)
    vn = draw(torch.sigmoid(Hn[0] @ W[0].T + vb), L)
    return vn, tuple(Hn)


def philox_draw(sample_v, sample_h, seed, it, stream_of_layer):
    """``draw`` for `gibbs_sweep`: Bernoulli states of the layers whose
    sampling is on, from key (`seed`, `it`) on ``stream_of_layer(l)``."""
    L = len(sample_h)

    def draw(p, l):
        on = sample_v if l == L else sample_h[l]
        return bernoulli(p, seed, it, stream_of_layer(l)) if on else p

    return draw


def apply_max_norm(W, max_norm):
    """Per-column max-norm constraint (JAX ``DBM._apply_max_norm``)."""
    if not math.isfinite(max_norm):
        return W
    norm = torch.linalg.norm(W, dim=0)
    mx = torch.tensor(max_norm, dtype=W.dtype, device=W.device)
    return W * torch.minimum(norm, mx) / torch.clamp(norm, min=1e-8)


def dbm_update(cfg, state, X, mu, v, H, lr, momentum):
    """The parameter update of one minibatch (JAX ``DBM._dbm_stats`` and
    ``_apply_dbm_update``, dbm.py:494-586): data statistics / N minus
    particle statistics / M with L2, the per-layer sparsity EMAs of the
    batch sums of both H and mu with their penalty on every row of dW and
    on dhb, the momentum rule ``acc <- lr (m acc + g); param += acc``, and
    the column max-norm of the new W."""
    L = len(state['W'])
    N, M = X.shape[0], v.shape[0]
    W = state['W']
    dvb = X.sum(0) / N - v.sum(0) / M
    pos = [X.T @ mu[0]] + [mu[l - 1].T @ mu[l] for l in range(1, L)]
    neg = [v.T @ H[0]] + [H[l - 1].T @ H[l] for l in range(1, L)]
    dW = [pos[l] / N - neg[l] / M - cfg.l2 * W[l] for l in range(L)]
    dhb = [mu[l].sum(0) / N - H[l].sum(0) / M for l in range(L)]
    # 1 - damping in the model's dtype, as the JAX package computes it
    damp = torch.tensor(cfg.sparsity_damping, dtype=X.dtype, device=X.device)
    q_means, mu_means = [], []
    for l in range(L):
        q_new = damp * state['q_means'][l] + (1. - damp) * H[l].sum(0)
        m_new = damp * state['mu_means'][l] + (1. - damp) * mu[l].sum(0)
        cost, target = cfg.sparsity_cost[l], cfg.sparsity_target[l]
        penalty = cost * (q_new - target) + cost * (m_new - target)
        dW[l] = dW[l] - penalty
        dhb[l] = dhb[l] - penalty
        q_means.append(q_new)
        mu_means.append(m_new)
    lr, momentum = float(lr), float(momentum)
    dvb_acc = lr * (momentum * state['dvb'] + dvb)
    dW_acc = [lr * (momentum * state['dW'][l] + dW[l]) for l in range(L)]
    dhb_acc = [lr * (momentum * state['dhb'][l] + dhb[l]) for l in range(L)]
    return {
        'vb': state['vb'] + dvb_acc,
        'hb': tuple(state['hb'][l] + dhb_acc[l] for l in range(L)),
        'W': tuple(apply_max_norm(W[l] + dW_acc[l], cfg.max_norm)
                   for l in range(L)),
        'dvb': dvb_acc, 'dhb': tuple(dhb_acc), 'dW': tuple(dW_acc),
        'q_means': tuple(q_means), 'mu_means': tuple(mu_means),
        'v': v, 'H': tuple(H),
    }


def reconstruction_means(state, mu0):
    """p(v | h0 = mu0) means (JAX ``DBM._reconstruction_means``)."""
    return torch.sigmoid(mu0 @ state['W'][0].T + state['vb'])


def dbm_step(cfg, state, X, lr, momentum, seed, it):
    """One PCD / mean-field update on minibatch `X` at iteration `it`
    (JAX ``DBM._train_step``, dbm.py:587-595); returns (state, msre,
    n_mf).  msre reads the UPDATED W0 and vb."""
    L = len(cfg.layer_sizes) - 1
    mu, n_mf = mean_field(X, state['W'], state['hb'], cfg.max_mf_updates,
                          cfg.mf_tol)
    v, H = state['v'], state['H']
    for s in range(cfg.k):
        draw = philox_draw(cfg.sample_v, cfg.sample_h, seed, it,
                           lambda l, s=s: stream_dbm(s, l, L))
        v, H = gibbs_sweep(state['W'], state['vb'], state['hb'], v, H, draw)
    state = dbm_update(cfg, state, X, mu, v, H, lr, momentum)
    msre = torch.mean(torch.square(X - reconstruction_means(state, mu[0])))
    return state, msre, n_mf


def dbm_epoch_reference(cfg, state, X_batches, lr, momentum, seed, iter0):
    """The plain PyTorch version of the epoch (see module docstring)."""
    NB = X_batches.shape[0]
    rows = torch.zeros((2, NB), dtype=X_batches.dtype,
                       device=X_batches.device)
    for i in range(NB):
        state, msre, n_mf = dbm_step(cfg, state, X_batches[i], lr, momentum,
                                     seed, int(iter0) + i + 1)
        rows[0, i] = msre
        rows[1, i] = n_mf
    return state, rows[0], rows[1]


def dbm_sample_reference(cfg, state, n_steps, seed):
    """The plain PyTorch version of the sampler (JAX ``_sample_v_program``,
    dbm.py:1027-1039): sweep ``s`` draws from key (`seed`, `s`), layer l on
    stream l."""
    v, H = state['v'], state['H']
    W, vb, hb = state['W'], state['vb'], state['hb']
    for s in range(int(n_steps)):
        draw = philox_draw(cfg.sample_v, cfg.sample_h, seed, s, lambda l: l)
        v, H = gibbs_sweep(W, vb, hb, v, H, draw)
    v_means, _ = gibbs_sweep(W, vb, hb, v, H)
    return dict(state, v=v_means, H=tuple(H)), v_means


def ais_schedule(n_betas):
    """(n_betas, 3) float32 array: row ``j - 1`` holds the beta of the
    transition that makes x_j and the pair (beta_lo, beta_hi) at which
    log p~(x_j) is subtracted, then added.  In float32 exactly as the JAX
    kernel computes them: delta = f32(1 / n_betas), beta_i = f32(i) delta,
    transition at beta_i + delta, and the last beta_hi is 1 (so these
    differ from ``make_beta_schedule``'s float64 linspace by rounding)."""
    M = int(n_betas)
    f32 = np.float32
    delta = f32(1. / M)
    j = np.arange(1, M + 1, dtype=f32)
    prev = (j - f32(1)) * delta                   # beta_{j-1}
    out = np.empty((M, 3), dtype=f32)
    out[:, 0] = prev + delta
    out[0, 0] = delta
    out[:, 1] = prev
    out[:, 2] = j * delta
    out[-1, 2] = f32(1)
    return out


def ais_log_p(x, beta, W0, W1, vb, hb0, hb1):
    """log p~_beta(h1 = x) with v and h2 summed out (JAX
    ``_ais_unnorm_log_prob_h1``, dbm.py:1042-1055), per run."""
    lp = beta * (x @ hb0)
    lp = lp + torch.sum(F.softplus(beta * (x @ W0.T + vb)), dim=1)
    return lp + torch.sum(F.softplus(beta * (x @ W1 + hb1)), dim=1)


def ais_transition(x, beta, k, W0, W1, vb, hb0, hb1, draw=None):
    """k-step tempered Gibbs transition on h1 (JAX ``_ais_transition``,
    dbm.py:1057-1078); ``draw(means, step, group)`` samples."""
    if draw is None:
        def draw(p, *_):
            return p
    for s in range(k):
        v = draw(torch.sigmoid(beta * (x @ W0.T) + beta * vb), s, AIS_V)
        h2 = draw(torch.sigmoid(beta * (x @ W1) + beta * hb1), s, AIS_H2)
        T = v @ W0 + h2 @ W1.T
        x = draw(torch.sigmoid(beta * T + beta * hb0), s, AIS_H1)
    return x


def ais_reference(cfg, state, seed, x0):
    """The plain PyTorch version of the AIS sweep, in the JAX kernel's
    order: x1 = T(x0, delta), log_w = -log p~(x1, 0); then per beta
    log_w += log p~(x, beta_i), x <- T(x, beta_i + delta),
    log_w -= log p~(x, beta_i); finally log_w += log p~(x, 1)."""
    W0, W1 = state['W']
    hb0, hb1 = state['hb']
    vb = state['vb']
    on = {AIS_V: cfg.sample_v, AIS_H2: cfg.sample_h1, AIS_H1: cfg.sample_h0}
    log_w = torch.zeros(x0.shape[0], dtype=x0.dtype, device=x0.device)
    x = x0
    for j, (beta_t, beta_lo, beta_hi) in enumerate(
            ais_schedule(cfg.n_betas).tolist(), start=1):
        def draw(p, s, g, j=j):
            return bernoulli(p, seed, j, stream_ais(s, g)) if on[g] else p
        x = ais_transition(x, beta_t, cfg.k, W0, W1, vb, hb0, hb1, draw)
        log_w = log_w - ais_log_p(x, beta_lo, W0, W1, vb, hb0, hb1)
        log_w = log_w + ais_log_p(x, beta_hi, W0, W1, vb, hb0, hb1)
    return log_w


# ---------------------------------------------------------------------- #
# CUDA kernels                                                            #
# ---------------------------------------------------------------------- #
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_U = ctypes.c_uint
_F = ctypes.c_float

ACT_IDENTITY, ACT_SIGMOID, ACT_SIGMOID_DELTA, ACT_SOFTPLUS_ROWS = range(4)
#: the most blocks of a dbm_msre launch: the floats of its partials buffer
MSRE_BLOCKS = 256
#: the most bias vectors of one dbm_bias_update launch (kMaxBias)
MAX_BIAS = 8


class GemmArgs(ctypes.Structure):
    """The ``GemmArgs`` struct of csrc/dbm_ops.cu (same field order)."""
    _fields_ = (
        [(n, _P) for n in ('a1', 'b1', 'a2', 'b2', 'c', 'bias', 'out',
                           'delta_bits', 'done', 'ws', 'counters')] +
        [(n, _L) for n in ('sam1', 'sak1', 'sbk1', 'sbn1',
                           'sam2', 'sak2', 'sbk2', 'sbn2')] +
        [(n, _I) for n in ('k1', 'k2', 'M', 'N', 'act', 'sample', 'n_tile',
                           'splits')] +
        [(n, _F) for n in ('alpha', 'alpha2', 'gamma')] +
        [(n, _U) for n in ('seed', 'it', 'stream_id')])


class AisLogw(ctypes.Structure):
    """The ``AisLogw`` struct of csrc/dbm_ops.cu (same field order): the
    log-weight update of one AIS beta."""
    _fields_ = ([(n, _P) for n in ('x', 'hb0', 'part_v', 'part_h2',
                                   'log_w')] +
                [(n, _I) for n in ('R', 'H1', 'nblk_v', 'nblk_h2')] +
                [(n, _F) for n in ('beta_lo', 'beta_hi')])


class BiasVec(ctypes.Structure):
    """The ``BiasVec`` struct of csrc/dbm_ops.cu (same field order): one
    bias vector of a ``dbm_bias_update`` launch."""
    _fields_ = ([(n, _P) for n in ('D', 'P', 'b', 'db', 'q', 'mu_m', 'pen')] +
                [('n', _I), ('cost', _F), ('target', _F)])


_ARGTYPES = {
    'bm_dbm_gemm_col_blocks': [_I],
    'bm_dbm_gemm_act': [ctypes.POINTER(GemmArgs), _P],
    'bm_ais_gemm_act': [ctypes.POINTER(GemmArgs), ctypes.POINTER(AisLogw),
                        _P],
    'bm_dbm_mf_reset': [_P, _P],
    'bm_dbm_mf_loop': [ctypes.POINTER(GemmArgs), _I, _I, _P, _F, _I, _P],
    'bm_dbm_bias_update': [ctypes.POINTER(BiasVec), _I, _I, _I, _F, _F, _F,
                           _F, _P],
    'bm_dbm_assoc_update': [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _F,
                            _F, _F, _P],
    'bm_dbm_max_norm': [_P, _I, _I, _F, _P],
    'bm_dbm_msre': [_P, _P, _L, _P, _P, _I, _P, _P, _P, _P],
    'bm_ais_logw': [_P, _P, _I, _I, _P, _I, _P, _I, _F, _F, _P, _P],
}
_BOUND = {}


def _library():
    """The built kernel library with its C signatures declared."""
    if 'lib' not in _BOUND:
        from ._build import load_library
        lib = load_library('dbm_ops')
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


def _ptr(t):
    return None if t is None else t.data_ptr()


def _gemm_args(out, A=(), c=None, bias=None, act=ACT_SIGMOID, alpha=1.,
               gamma=1., *, stream, splits=None):
    """Arguments of one ``dbm_gemm_act`` launch writing `out` (M, N) on the
    CUDA stream `stream` (the handle).  `A` holds up to two products ``(lhs,
    W, transposed)``: lhs (M, K) with unit column stride times W (K, N), or
    W^T for a W of shape (N, K).  The tensor-core tile's plan
    (``ops/gemm.py``) covers both products' K; `splits`, where given,
    replaces its slice count."""
    a = GemmArgs()
    a.out = out.data_ptr()
    a.M, a.N = int(out.shape[0]), int(out.shape[1])
    for slot, (lhs, W, transposed) in enumerate(A, start=1):
        K = int(lhs.shape[1])
        sam, (sbk, sbn) = check_operand(lhs, W, transposed,
                                        'A{0}'.format(slot))
        for name, value in (('a', lhs.data_ptr()), ('b', W.data_ptr()),
                            ('sam', sam), ('sak', 1), ('sbk', sbk),
                            ('sbn', sbn), ('k', K)):
            setattr(a, '{0}{1}'.format(name, slot), value)
    plan, ws, counters = launch_plan(a.M, a.N,
                                     [int(lhs.shape[1]) for lhs, _, _ in A],
                                     out.device, stream, splits)
    a.n_tile, a.splits = plan.n_tile, plan.splits
    a.ws, a.counters = _ptr(ws), _ptr(counters)
    a.c, a.bias = _ptr(c), _ptr(bias)
    a.act = act
    a.alpha, a.gamma = alpha, gamma
    return a


def _validate(tensors, device):
    """Each (name, tensor, shape) must be a contiguous float32 tensor of
    that shape on `device`."""
    for name, t, shape in tensors:
        if t.device != device or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError('{0} must be a contiguous float32 tensor on {1}'
                             .format(name, device))
        if tuple(t.shape) != tuple(shape):
            raise ValueError('{0} has shape {1}, expected {2}'.format(
                name, tuple(t.shape), tuple(shape)))


def _state_specs(state, sizes, n_particles, keys=STATE_KEYS):
    """(name, tensor, shape) of every state tensor named in `keys`."""
    L = len(sizes) - 1
    hs = sizes[1:]
    shapes = {'vb': (sizes[0],), 'dvb': (sizes[0],),
              'v': (n_particles, sizes[0]),
              'hb': [(h,) for h in hs], 'dhb': [(h,) for h in hs],
              'q_means': [(h,) for h in hs], 'mu_means': [(h,) for h in hs],
              'W': [(sizes[l], hs[l]) for l in range(L)],
              'dW': [(sizes[l], hs[l]) for l in range(L)],
              'H': [(n_particles, h) for h in hs]}
    out = []
    for key in keys:
        if key in LAYER_KEYS:
            if len(state[key]) != L:
                raise ValueError('state[{0!r}] needs {1} layers'.format(key,
                                                                        L))
            out += [('{0}[{1}]'.format(key, l), state[key][l],
                     shapes[key][l]) for l in range(L)]
        else:
            out.append((key, state[key], shapes[key]))
    return out


def _check_seed(seed, steps):
    if not (0 <= int(seed) < 2 ** 32 and 0 <= int(steps) < 2 ** 32):
        raise ValueError('seed and iterations must fit in 32 bits')


def _clone_state(state):
    return {key: (tuple(t.clone() for t in state[key]) if key in LAYER_KEYS
                  else state[key].clone()) for key in STATE_KEYS}


def _dbm_epoch_cuda(cfg, state, X_batches, lr, momentum, seed, iter0):
    """Launch the kernels of ``csrc/dbm_ops.cu`` for every minibatch."""
    sizes = cfg.layer_sizes
    L, V, hs = len(sizes) - 1, sizes[0], sizes[1:]
    dev = X_batches.device
    if X_batches.dim() != 3 or X_batches.shape[2] != V \
            or X_batches.shape[0] < 1 or X_batches.shape[1] < 1:
        raise ValueError('X_batches must be (n_batches, batch_size, {0}), '
                         'got {1}'.format(V, tuple(X_batches.shape)))
    NB, B = int(X_batches.shape[0]), int(X_batches.shape[1])
    M = int(state['v'].shape[0])
    _validate([('X_batches', X_batches, X_batches.shape)] +
              _state_specs(state, sizes, M), dev)
    _check_seed(seed, int(iter0) + NB)

    lib = _library()
    launches = dbm_epoch.launches
    stream = torch.cuda.current_stream(dev).cuda_stream
    # the epoch updates copies of the state in place, batch after batch
    s = _clone_state(state)
    W, hb, H = s['W'], s['hb'], s['H']

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    T0 = empty(B, hs[0])
    mu = [empty(B, h) for h in hs]
    pen = [empty(h) for h in hs]
    v_means = empty(B, V)
    # the mean-field loop's control words of the current minibatch: the
    # done flag, n_mf, and the max |change| of each sweep as float bits, in
    # one of three words by the sweep (csrc/dbm_ops.cu mf_change)
    ctrl = torch.zeros(5, dtype=torch.int32, device=dev)
    # dbm_msre's block sums and its last-block counter (re-armed by it)
    msre_part = empty(MSRE_BLOCKS)
    msre_count = torch.zeros(1, dtype=torch.int32, device=dev)
    rows = torch.zeros((2, NB), dtype=torch.float32, device=dev)
    lr, mom = float(lr), float(momentum)
    one_minus_damp = float(1. - torch.tensor(cfg.sparsity_damping,
                                             dtype=torch.float32))
    tol = float(np.float32(cfg.mf_tol))

    def launch(args):
        _check(lib.bm_dbm_gemm_act(ctypes.byref(args), stream),
               'dbm_gemm_act')
        launches['dbm_gemm_act'] += 1

    # launch arguments shared by every minibatch (X's pointer and the
    # iteration are set per minibatch)
    t0_args = _gemm_args(T0, [(X_batches[0], W[0], False)], act=ACT_IDENTITY,
                         stream=stream)
    # mean-field init: sigmoid(2 X.W0 + hb0) doubles the product only
    init_args = [_gemm_args(mu[0], c=T0, bias=hb[0], alpha=2., stream=stream)]
    for l in range(1, L):
        init_args.append(_gemm_args(mu[l], [(mu[l - 1], W[l], False)],
                                    bias=hb[l], alpha=2. if l < L - 1 else 1.,
                                    stream=stream))
    sweep = (GemmArgs * L)()
    for l in range(L):
        A = [(mu[l - 1], W[l], False)] if l else []
        if l + 1 < L:
            A.append((mu[l + 1], W[l + 1], True))
        sweep[l] = _gemm_args(mu[l], A, c=T0 if l == 0 else None, bias=hb[l],
                              act=ACT_SIGMOID_DELTA, stream=stream)
    gibbs = []
    for step in range(cfg.k):
        for l in range(L + 1):
            if l == L:
                A, out, bias, on = [(H[0], W[0], True)], s['v'], s['vb'], \
                    cfg.sample_v
            else:
                A = [(s['v'], W[0], False)] if l == 0 else \
                    [(H[l - 1], W[l], False)]
                if l + 1 < L:
                    A.append((H[l + 1], W[l + 1], True))
                out, bias, on = H[l], hb[l], cfg.sample_h[l]
            a = _gemm_args(out, A, bias=bias, stream=stream)
            a.sample, a.seed = int(on), int(seed)
            a.stream_id = stream_dbm(step, l, L)
            gibbs.append(a)
    recon_args = _gemm_args(v_means, [(mu[0], W[0], True)], bias=s['vb'],
                            stream=stream)
    # vb and every hb_l: (data side, particle side, bias, its accumulator,
    # sparsity EMAs q and mu, penalty, cost, target), at most MAX_BIAS a
    # launch; the data side of vb is X, set per minibatch
    vecs = [BiasVec(_ptr(D), _ptr(P), _ptr(b), _ptr(db), _ptr(q), _ptr(mm),
                    _ptr(p), int(P.shape[1]), cost, target)
            for D, P, b, db, q, mm, p, cost, target in
            [(None, s['v'], s['vb'], s['dvb'], None, None, None, 0., 0.)] +
            [(mu[l], H[l], hb[l], s['dhb'][l], s['q_means'][l],
              s['mu_means'][l], pen[l], cfg.sparsity_cost[l],
              cfg.sparsity_target[l]) for l in range(L)]]
    chunks = [vecs[j:j + MAX_BIAS] for j in range(0, L + 1, MAX_BIAS)]
    bias_launches = [(BiasVec * len(c))(*c) for c in chunks]

    for i in range(NB):
        X = X_batches[i]
        it = int(iter0) + i + 1
        t0_args.a1 = X.data_ptr()
        launch(t0_args)
        for a in init_args:
            launch(a)
        # the mean-field loop, on the device: max_mf_updates sweeps are
        # enqueued, those after convergence return at once; each sweep's
        # first layer launch runs the check of the sweep before
        _check(lib.bm_dbm_mf_reset(ctrl.data_ptr(), stream), 'dbm_mf_reset')
        _check(lib.bm_dbm_mf_loop(sweep, L, cfg.max_mf_updates,
                                  ctrl.data_ptr(), tol, cfg.max_mf_updates,
                                  stream), 'dbm_mf_loop')
        launches['dbm_gemm_act'] += L * cfg.max_mf_updates
        for a in gibbs:
            a.it = it
            launch(a)
        # bias statistics, sparsity and the bias updates of every vector
        # in one launch (the penalty vectors feed the association update)
        bias_launches[0][0].D = X.data_ptr()
        for vs in bias_launches:
            _check(lib.bm_dbm_bias_update(
                vs, len(vs), B, M, lr, mom, cfg.sparsity_damping,
                one_minus_damp, stream), 'dbm_bias_update')
            launches['dbm_bias_update'] += 1
        for l in range(L):
            Ad, Ap = (X, s['v']) if l == 0 else (mu[l - 1], H[l - 1])
            _check(lib.bm_dbm_assoc_update(
                _ptr(Ad), _ptr(mu[l]), _ptr(Ap), _ptr(H[l]), _ptr(pen[l]), B,
                M, sizes[l], hs[l], _ptr(W[l]), _ptr(s['dW'][l]), lr, mom,
                cfg.l2, stream), 'dbm_assoc_update')
            launches['dbm_assoc_update'] += 1
            if math.isfinite(cfg.max_norm):
                _check(lib.bm_dbm_max_norm(_ptr(W[l]), sizes[l], hs[l],
                                           cfg.max_norm, stream),
                       'dbm_max_norm')
                launches['dbm_max_norm'] += 1
        # msre on the mean-field mu0 with the UPDATED W0 and vb
        launch(recon_args)
        _check(lib.bm_dbm_msre(_ptr(X), _ptr(v_means), B * V, _ptr(ctrl),
                               _ptr(msre_part), MSRE_BLOCKS,
                               _ptr(msre_count), rows[0].data_ptr() + 4 * i,
                               rows[1].data_ptr() + 4 * i, stream),
               'dbm_msre')
        launches['dbm_msre'] += 1
    return s, rows[0], rows[1]


def _dbm_sample_cuda(cfg, state, n_steps, seed):
    """Launch the kernels of ``csrc/dbm_ops.cu``: L + 1 per sampled sweep,
    two for the final sweep on means (only H[0]'s means feed v)."""
    sizes = cfg.layer_sizes
    L, hs = len(sizes) - 1, sizes[1:]
    v0 = state['v']
    dev, M = v0.device, int(v0.shape[0])
    if M < 1:
        raise ValueError('need at least one particle')
    _validate(_state_specs(state, sizes, M, ('vb', 'hb', 'W', 'v', 'H')),
              dev)
    _check_seed(seed, n_steps)
    lib = _library()
    launches = dbm_sample.launches
    stream = torch.cuda.current_stream(dev).cuda_stream
    W, hb, vb = state['W'], state['hb'], state['vb']
    v = v0.clone()
    H = tuple(h.clone() for h in state['H'])

    def layer_args(l, out):
        if l == L:
            return _gemm_args(out, [(H[0], W[0], True)], bias=vb,
                              stream=stream)
        A = [(v, W[0], False)] if l == 0 else [(H[l - 1], W[l], False)]
        if l + 1 < L:
            A.append((H[l + 1], W[l + 1], True))
        return _gemm_args(out, A, bias=hb[l], stream=stream)

    sweep = [layer_args(l, v if l == L else H[l]) for l in range(L + 1)]
    for l, a in enumerate(sweep):
        a.sample = int(cfg.sample_v if l == L else cfg.sample_h[l])
        a.seed, a.stream_id = int(seed), l
    for step in range(int(n_steps)):
        for a in sweep:
            a.it = step
            _check(lib.bm_dbm_gemm_act(ctypes.byref(a), stream),
                   'dbm_gemm_act')
            launches['dbm_gemm_act'] += 1
    h0_means = torch.empty((M, hs[0]), dtype=torch.float32, device=dev)
    for a in (layer_args(0, h0_means),
              _gemm_args(v, [(h0_means, W[0], True)], bias=vb,
                         stream=stream)):
        _check(lib.bm_dbm_gemm_act(ctypes.byref(a), stream), 'dbm_gemm_act')
        launches['dbm_gemm_act'] += 1
    return dict(state, v=v, H=H), v


def _ais_cuda(cfg, state, seed, x0):
    """Launch the kernels of ``csrc/dbm_ops.cu``: per beta, 3 per Gibbs step
    of the transition and 2 for the pair of log p~ evaluations (GEMMs with
    softplus row sums at beta_lo and beta_hi); each beta's log-weight
    update rides on the next beta's first launch, and one ``ais_logw``
    launch applies the last beta's."""
    V, H1, H2 = cfg.n_visible, cfg.n_h1, cfg.n_h2
    dev = x0.device
    if x0.dim() != 2 or x0.shape[1] != H1 or x0.shape[0] < 1:
        raise ValueError('x0 must be (n_runs, {0}), got {1}'.format(
            H1, tuple(x0.shape)))
    R = int(x0.shape[0])
    if len(state['W']) != 2:
        raise ValueError('AIS needs a 2-layer DBM')
    _validate([('x0', x0, (R, H1))] +
              _state_specs(state, (V, H1, H2), 1, ('vb', 'hb', 'W')), dev)
    _check_seed(seed, cfg.n_betas)
    lib = _library()
    launches = ais.launches
    stream = torch.cuda.current_stream(dev).cuda_stream
    (W0, W1), (hb0, hb1), vb = state['W'], state['hb'], state['vb']

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    x, v, h2 = x0.clone(), empty(R, V), empty(R, H2)
    nblk_v = lib.bm_dbm_gemm_col_blocks(V)
    nblk_h2 = lib.bm_dbm_gemm_col_blocks(H2)
    # the softplus partials of beta j in set j % 2: beta j + 1's launches
    # write the other set while the first of them reads beta j's
    part_v, part_h2 = empty(2, 2 * R * nblk_v), empty(2, 2 * R * nblk_h2)
    log_w = torch.zeros(R, dtype=torch.float32, device=dev)
    trans = []
    for step in range(cfg.k):
        for out, A, bias, g, on in (
                (v, [(x, W0, True)], vb, AIS_V, cfg.sample_v),
                (h2, [(x, W1, False)], hb1, AIS_H2, cfg.sample_h1),
                (x, [(v, W0, False), (h2, W1, True)], hb0, AIS_H1,
                 cfg.sample_h0)):
            a = _gemm_args(out, A, bias=bias, stream=stream)
            a.sample, a.seed = int(on), int(seed)
            a.stream_id = stream_ais(step, g)
            trans.append(a)
    # softplus(beta (x.W0^T + vb)) and softplus(beta (x.W1 + hb1)), row sums
    # at both betas of the pair from one product each
    lp_v = _gemm_args(v, [(x, W0, True)], bias=vb, act=ACT_SOFTPLUS_ROWS,
                      stream=stream)
    lp_h2 = _gemm_args(h2, [(x, W1, False)], bias=hb1, act=ACT_SOFTPLUS_ROWS,
                       stream=stream)
    pending = None  # the update of the beta before
    for j, (beta_t, beta_lo, beta_hi) in enumerate(
            ais_schedule(cfg.n_betas).tolist(), start=1):
        for a in trans:
            a.alpha = a.gamma = beta_t
            a.it = j
        for a in (lp_v, lp_h2):
            a.alpha, a.alpha2 = beta_lo, beta_hi
        lp_v.out, lp_h2.out = part_v[j % 2].data_ptr(), \
            part_h2[j % 2].data_ptr()
        first, *rest = trans + [lp_v, lp_h2]
        _check(lib.bm_ais_gemm_act(ctypes.byref(first), pending, stream),
               'dbm_gemm_act')
        for a in rest:
            _check(lib.bm_dbm_gemm_act(ctypes.byref(a), stream),
                   'dbm_gemm_act')
        launches['dbm_gemm_act'] += len(trans) + 2
        pending = AisLogw(_ptr(x), _ptr(hb0), part_v[j % 2].data_ptr(),
                          part_h2[j % 2].data_ptr(), _ptr(log_w), R, H1,
                          nblk_v, nblk_h2, beta_lo, beta_hi)
    p = pending
    _check(lib.bm_ais_logw(p.x, p.hb0, R, H1, p.part_v, nblk_v, p.part_h2,
                           nblk_h2, beta_lo, beta_hi, p.log_w, stream),
           'ais_logw')
    launches['ais_logw'] += 1
    return log_w


# ---------------------------------------------------------------------- #
# wrappers                                                                #
# ---------------------------------------------------------------------- #
def _route(device, name):
    if device.type in ('cuda', 'cpu'):
        return device.type
    raise ValueError('{0} runs on CUDA (kernels) or the CPU (plain version), '
                     'not on {1}'.format(name, device))


def dbm_epoch(cfg, state, X_batches, lr, momentum, seed, iter0):
    """One PCD / mean-field DBM epoch: the CUDA kernels for a CUDA tensor,
    the plain version for a CPU tensor."""
    if _route(X_batches.device, 'dbm_epoch') == 'cuda':
        return _dbm_epoch_cuda(cfg, state, X_batches, lr, momentum, seed,
                               iter0)
    return dbm_epoch_reference(cfg, state, X_batches, lr, momentum, seed,
                               iter0)


def dbm_sample(cfg, state, n_steps, seed):
    """The particle sampler: the CUDA kernels for CUDA particles, the plain
    version for CPU particles."""
    if _route(state['v'].device, 'dbm_sample') == 'cuda':
        return _dbm_sample_cuda(cfg, state, n_steps, seed)
    return dbm_sample_reference(cfg, state, n_steps, seed)


def ais(cfg, state, seed, x0):
    """The AIS sweep: the CUDA kernels for a CUDA `x0`, the plain version
    for a CPU one."""
    if _route(x0.device, 'ais') == 'cuda':
        return _ais_cuda(cfg, state, seed, x0)
    return ais_reference(cfg, state, seed, x0)


dbm_epoch.launches = dict.fromkeys(EPOCH_KERNELS, 0)
dbm_sample.launches = dict.fromkeys(SAMPLE_KERNELS, 0)
ais.launches = dict.fromkeys(AIS_KERNELS, 0)


def reset_launches():
    for fn in (dbm_epoch, dbm_sample, ais):
        for name in fn.launches:
            fn.launches[name] = 0
