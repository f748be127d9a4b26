"""Philox4x32-10 uniforms in plain torch integer arithmetic.

A frozen copy of the stream the port's kernels draw from (its documented
layout: key (seed, iteration), counter (element index, stream id, 0, 0),
uniform ``(bits >> 9) * 2^-23`` from the first output word), so that the
reference draws the same uniforms as the program without importing it.
"""

import torch

M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
MASK32 = 0xFFFFFFFF

STREAM_H0 = 0


def stream_v(step):
    return 1 + 2 * step


def stream_h(step):
    return 2 + 2 * step


def stream_dbm(step, layer, n_layers):
    """Hidden layer `layer` (``n_layers`` for the visible units) in Gibbs
    sweep `step` of a DBM minibatch."""
    return step * (n_layers + 1) + layer


def _mulhilo(m, x):
    p_lo = m * (x & 0xFFFF)
    p_hi = m * (x >> 16)
    lo = (((p_hi & 0xFFFF) << 16) + p_lo) & MASK32
    hi = (p_hi + (p_lo >> 16)) >> 16
    return hi, lo


def uniform(seed, it, stream, shape, device):
    """float32 uniforms in [0, 1): element j (row-major) from counter
    (j, stream, 0, 0) under key (seed, it)."""
    n = 1
    for d in shape:
        n *= int(d)
    c0 = torch.arange(n, dtype=torch.int64, device=device)
    c1 = torch.full_like(c0, int(stream))
    c2 = torch.zeros_like(c0)
    c3 = torch.zeros_like(c0)
    k0, k1 = int(seed) & MASK32, int(it) & MASK32
    for r in range(10):
        if r:
            k0 = (k0 + W0) & MASK32
            k1 = (k1 + W1) & MASK32
        hi0, lo0 = _mulhilo(M0, c0)
        hi1, lo1 = _mulhilo(M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return ((c0 >> 9).to(torch.float32) * (2. ** -23)).reshape(shape)
