"""Philox4x32-10 counter-based random numbers, in plain torch arithmetic.

The CUDA kernels draw their uniforms from the device function in
``csrc/philox.cuh``; this module computes the same rounds on int64 tensors
(every product split so that no intermediate exceeds 2^49), so the plain
version of a kernel draws exactly the same numbers.

Stream layout of the CD epoch (one key per training iteration):

* key     = (epoch seed, global iteration ``it``);
* counter = (element index ``row * n_cols + col``, stream id, shard, 0);
  the shard is 0 except in the data-parallel epoch, where each rank draws
  its local rows (element index local to the shard) under its rank, as the
  TPU's stats kernels mix the shard into their seed
  (pallas_ops.py:1096-1100);
* stream ids: ``STREAM_H0`` for the data-driven hidden sample, then for
  Gibbs step ``s`` (0-based) ``stream_v(s)`` and ``stream_h(s)``, and
  ``STREAM_PLL`` for the PLL flip position of each row;
* Gaussian visible units draw step ``s`` on ``stream_v(s)`` too, with two
  uniforms per element (words 0 and 1 of its counter) for Box-Muller;
* multinomial hidden units draw ``n`` uniforms per row on ``STREAM_H0``
  (h0) and ``stream_h(s)``, draw ``j`` of row ``b`` at element index
  ``b * n + j``;
* the multinomial PLL draws one uniform-multinomial count vector for
  fe(x) on ``STREAM_PLL_HHAT`` and an independent one for fe(x_flipped)
  on ``STREAM_PLL_HHAT_FLIP``.

The standalone samplers (``ops/samplers.py``) draw under key (seed, 0) on
stream 0 (``bernoulli_sample`` also under a two-word key (w0, w1)); the
free-energy probe draws its count vector under key (seed, 0) on
``STREAM_PLL_HHAT``.  The data-parallel epoch draws the PLL flip of its
local rows on ``STREAM_PLL`` under its shard.

The DBM kernels (``ops/dbm_ops.py``) keep the same rule -- the key is
(seed, step), the counter is (element index, stream id):

* DBM epoch: key (epoch seed, global iteration ``it``); Gibbs sweep ``s``
  of a minibatch draws hidden layer ``l`` on ``stream_dbm(s, l, L)`` and
  the visible units (drawn last) on ``stream_dbm(s, L, L)``;
* ``sample_v``: key (seed, sampled sweep ``s``); layer ``l`` on stream
  ``l`` (visible: ``L``);
* AIS: key (seed, index ``j`` of the transition's beta, 1-based); Gibbs
  step ``s`` of the transition draws v, h2 and h1 on ``stream_ais(s, g)``
  with ``g`` = ``AIS_V``, ``AIS_H2``, ``AIS_H1``.

A uniform is built from the first output word with the mantissa trick of
the TPU kernels (``bitcast((bits >> 9) | 0x3f800000) - 1``), which equals
``(bits >> 9) * 2^-23`` exactly.
"""

import torch

PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85
MASK32 = 0xFFFFFFFF
N_ROUNDS = 10

STREAM_H0 = 0
STREAM_PLL = 0xFFFF
STREAM_PLL_HHAT = 0xFFFE
STREAM_PLL_HHAT_FLIP = 0xFFFD

#: 2 pi rounded to float32, the constant the kernels multiply by
TWO_PI_F32 = 6.2831854820251465


def stream_v(step):
    return 1 + 2 * step


def stream_h(step):
    return 2 + 2 * step


def stream_dbm(step, layer, n_layers):
    """Stream of hidden layer `layer` (``n_layers`` for the visible units)
    in Gibbs sweep `step` of a DBM minibatch."""
    return step * (n_layers + 1) + layer


AIS_V, AIS_H2, AIS_H1 = 0, 1, 2


def stream_ais(step, group):
    """Stream of unit group `group` (``AIS_V``, ``AIS_H2``, ``AIS_H1``) in
    Gibbs step `step` of an AIS transition."""
    return 3 * step + group


def _mulhilo(m, x):
    """(hi, lo) 32-bit words of the 64-bit product of the constant `m` and
    the int64 tensor `x` (values in [0, 2^32))."""
    p_lo = m * (x & 0xFFFF)        # < 2^48
    p_hi = m * (x >> 16)           # < 2^48
    lo = (((p_hi & 0xFFFF) << 16) + p_lo) & MASK32
    hi = (p_hi + (p_lo >> 16)) >> 16
    return hi, lo


def philox4x32(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 of the counter words (int64 tensors or ints in
    [0, 2^32)) under the key (k0, k1) (ints); returns the four output words
    as int64 tensors."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64)
                      for c in (c0, c1, c2, c3))
    k0, k1 = int(k0) & MASK32, int(k1) & MASK32
    for r in range(N_ROUNDS):
        if r:
            k0 = (k0 + PHILOX_W0) & MASK32
            k1 = (k1 + PHILOX_W1) & MASK32
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _words(seed, it, stream, shape, device, shard):
    n = 1
    for d in shape:
        n *= int(d)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return philox4x32(idx, stream, shard, 0, seed, it)


def _to_uniform(bits, shape):
    return ((bits >> 9).to(torch.float32) * (2. ** -23)).reshape(shape)


def philox_uniform(seed, it, stream, shape, device='cpu', shard=0):
    """float32 uniforms in [0, 1) of the given `shape`, element ``j`` (in
    row-major order) drawn from counter (j, stream, shard, 0) under key
    (seed, it)."""
    bits, _, _, _ = _words(seed, it, stream, shape, device, shard)
    return _to_uniform(bits, shape)


def philox_uniform2(seed, it, stream, shape, device='cpu', shard=0):
    """Two float32 uniforms per element, from words 0 and 1 of the same
    counter as ``philox_uniform`` (whose uniforms are the first of the
    pair)."""
    w0, w1, _, _ = _words(seed, it, stream, shape, device, shard)
    return _to_uniform(w0, shape), _to_uniform(w1, shape)


def normal(seed, it, stream, shape, device='cpu', shard=0):
    """float32 standard normals by Box-Muller on the uniform pairs of
    ``philox_uniform2``, as the TPU kernels' ``_normal_from_bits``
    (pallas_ops.py:46-51): ``sqrt(-2 ln max(u1, 1e-7)) cos(2 pi u2)``.

    The log is taken in float64 and rounded to float32: torch's CPU float32
    ``log`` sometimes takes a path, on the first large call of a process,
    that is off by ~1e-4 relative; float64's worst case there (~2e-10)
    rounds away."""
    u1, u2 = philox_uniform2(seed, it, stream, shape, device, shard)
    u1 = torch.clamp(u1, min=1e-7)
    r = torch.sqrt(-2. * torch.log(u1.to(torch.float64)).to(torch.float32))
    return r * torch.cos(TWO_PI_F32 * u2)


def bernoulli(means, seed, it, stream, shard=0):
    """States ``1[u < means]`` with the uniforms of (`seed`, `it`,
    `stream`, `shard`), as the kernels' epilogues draw them."""
    u = philox_uniform(seed, it, stream, means.shape, means.device, shard)
    return (u.to(means.dtype) < means).to(means.dtype)


def multinomial_counts(means, n_samples, seed, it, stream):
    """Exact Multinomial(n, means / n) counts per row of the (B, H)
    expected counts `means`, as the kernels draw them: the CDF of
    ``means / n`` accumulated in float64 and rounded to float32, its last
    entry set to +inf (the last bucket absorbs rounding); draw ``j`` of row
    ``b`` is the uniform at element ``b * n + j`` and lands in the first
    bucket whose CDF exceeds it.  Integer counts, summed exactly."""
    B, H = means.shape
    n = int(n_samples)
    cdf = torch.cumsum(means.to(torch.float64) / n, dim=1).to(torch.float32)
    cdf[:, -1] = float('inf')
    u = philox_uniform(seed, it, stream, (B, n), means.device)
    idx = torch.searchsorted(cdf, u, right=True)
    counts = torch.zeros((B, H), dtype=means.dtype, device=means.device)
    return counts.scatter_add_(1, idx, torch.ones_like(u, dtype=means.dtype))
