"""Plain reference of a Gaussian-visible RBM trained by CD-k (the
configuration family ``gaussian_rbm``).

It follows the reference library's update (yell/boltzmann-machines
``BaseRBM`` with ``GaussianRBM``'s layers): inputs divided by sigma on
ingestion and vb kept raw; hidden means ``sigmoid(up (X W + hb))``, with
``up`` 2 for ``dbm_first``; their states drawn; k Gibbs steps, each
visible mean ``down (h W^T) sigma + down vb`` (``down`` 2 for
``dbm_last``) and, with ``sample_v_states``, the visible state ``mean +
sigma z`` for a standard normal z; ``dW = (X^T h0_means - v^T h_means) /
B - l2 W`` less the sparsity penalty on the EMA of the chain-end hidden
means' batch sums; momentum ``acc <- lr (m acc + g); param += acc``.  It
imports nothing of the program.

Departures from the library's description, all as the program draws:

- the hidden states are Bernoulli draws on the program's Philox uniforms
  (``philox.py``, through ``common.Draws``, so that ties to rounding are
  followed), not TensorFlow's generators;
- z is Box-Muller on words 0 and 1 of the program's Philox counter on the
  visible stream, ``sqrt(-2 ln max(u0, 1e-7)) cos(2 pi u1)`` (``normal``
  below, a frozen copy of the stream's layout), not TensorFlow's normal;
- the last Gibbs step's hidden states are not drawn: nothing reads them;
- the sparsity penalty acts on the batch sum of the hidden means, as the
  program's does (its ``sparsity_cost`` is 0 in the configuration).

Every step is computed in the precision it is handed (float64 for the
reference that judges), the normal's logarithm and cosine included.
"""

import math

import torch

from . import philox

PARAMS = ('W', 'vb', 'hb')
ACCUMULATORS = {'W': 'dW', 'vb': 'dvb', 'hb': 'dhb'}

#: the least uniform that Box-Muller's logarithm takes
NORMAL_CLAMP = 1e-7


def _words01(seed, it, stream, n, device):
    """Words 0 and 1 of Philox4x32-10 at counters (j, stream, 0, 0), j <
    n, under key (seed, it)."""
    c0 = torch.arange(n, dtype=torch.int64, device=device)
    c1 = torch.full_like(c0, int(stream))
    c2 = torch.zeros_like(c0)
    c3 = torch.zeros_like(c0)
    k0, k1 = int(seed) & philox.MASK32, int(it) & philox.MASK32
    for r in range(10):
        if r:
            k0 = (k0 + philox.W0) & philox.MASK32
            k1 = (k1 + philox.W1) & philox.MASK32
        hi0, lo0 = philox._mulhilo(philox.M0, c0)
        hi1, lo1 = philox._mulhilo(philox.M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1


def normal(seed, it, stream, shape, device, dtype=torch.float64):
    """Standard normals of the given `shape` in `dtype`: element j
    (row-major) by Box-Muller on the uniforms ``(bits >> 9) 2^-23`` of
    words 0 and 1 of counter (j, stream, 0, 0) under key (seed, it)."""
    n = 1
    for d in shape:
        n *= int(d)
    w0, w1 = _words01(seed, it, stream, n, device)
    u0 = torch.clamp((w0 >> 9).to(dtype) * 2. ** -23, min=NORMAL_CLAMP)
    u1 = (w1 >> 9).to(dtype) * 2. ** -23
    z = torch.sqrt(-2. * torch.log(u0)) * torch.cos(2. * math.pi * u1)
    return z.reshape(shape)


def initial_state(inputs, prec, device):
    cfg = inputs['config']
    V, H = cfg['n_visible'], cfg['n_hidden']
    full = lambda n, x: torch.full((n,), float(x), dtype=prec.dtype,
                                   device=device)
    zeros = lambda *s: torch.zeros(s, dtype=prec.dtype, device=device)
    return {'W': prec.tensor(inputs['W0'], device),
            'vb': full(V, cfg['vb_init']), 'hb': full(H, cfg['hb_init']),
            'dW': zeros(V, H), 'dvb': zeros(V), 'dhb': zeros(H),
            'q': zeros(H)}


def step(s, X, lr, mom, seed, it, cfg, prec, draws):
    """One CD-k step on the batch X (as the user hands it, not yet divided
    by sigma); returns the new state."""
    up = 2. if cfg.get('dbm_first') else 1.
    down = 2. if cfg.get('dbm_last') else 1.
    sigma = float(cfg['sigma'])
    k = int(cfg['n_gibbs_steps'])
    X = X / sigma
    B = X.shape[0]
    W, vb, hb = s['W'], s['vb'], s['hb']

    def h_means(v):
        return torch.sigmoid(up * (prec.mm(v, W) + hb))

    def sample_h(p, stream, on):
        return draws.bernoulli(p, seed, it, stream, (it, stream)) if on \
            else p

    h0 = h_means(X)
    h = sample_h(h0, philox.STREAM_H0, cfg['sample_h_states'])
    v, hm = X, h0
    for g in range(k):
        vm = down * prec.mm(h, W.T) * sigma + down * vb
        v = vm + sigma * normal(seed, it, philox.stream_v(g), vm.shape,
                                vm.device, vm.dtype) \
            if cfg['sample_v_states'] else vm
        hm = h_means(v)
        # the last step's hidden states feed nothing
        h = sample_h(hm, philox.stream_h(g),
                     cfg['sample_h_states'] and g < k - 1)
    damp = cfg['sparsity_damping']
    q = damp * s['q'] + (1. - damp) * torch.sum(hm, dim=0)
    pen = cfg['sparsity_cost'] * (q - cfg['sparsity_target'])
    gW = (prec.mm(X.T, h0) - prec.mm(v.T, hm)) / B - cfg['l2'] * W - pen
    dW = lr * (mom * s['dW'] + gW)
    dvb = lr * (mom * s['dvb'] + torch.mean(X - v, dim=0))
    dhb = lr * (mom * s['dhb'] + torch.mean(h0 - hm, dim=0) - pen)
    return {'W': W + dW, 'vb': vb + dvb, 'hb': hb + dhb, 'dW': dW,
            'dvb': dvb, 'dhb': dhb, 'q': q}
