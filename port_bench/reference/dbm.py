"""Plain reference of a two-layer Bernoulli DBM trained by PCD with
mean-field (the configuration family ``dbm``).

It follows the reference library's ``DBM`` (Salakhutdinov and Hinton
2009): the DBM's weights stacked from two RBMs (W as they are; the middle
layer's bias the mean of the lower RBM's hidden and the upper RBM's
visible bias), mean-field from the doubled bottom-up pass until no unit
moves by more than ``mf_tol`` or ``max_mf_updates`` sweeps, k sampled
Gibbs sweeps of the persistent particles (h1 from v and the old h2, then
h2, then v from the new h1), the data statistics over the mean-field means
less the particles', L2, the sparsity penalty on the EMAs of the batch
sums of both the particles' and the mean-field means, momentum, and the
column max-norm of the new W.  The draws take the program's Philox
uniforms under the keys its seed plumbing gives.  It imports nothing of
the program.
"""

import math

import torch

from . import philox

PARAMS = ('W0', 'W1', 'vb', 'hb0', 'hb1')
#: faults of this family that the calibration reads besides the common
#: ones: mean-field stopped one sweep before it meets its tolerance
EXTRA_FAULTS = ('early_mean_field',)
ACCUMULATORS = {'W0': 'dW0', 'W1': 'dW1', 'vb': 'dvb', 'hb0': 'dhb0',
                'hb1': 'dhb1'}


def initial_state(inputs, prec, device):
    """The DBM's state stacked from the two RBMs' arrays, and the
    particles' initial values."""
    t = lambda x: prec.tensor(x, device)
    r1, r2 = inputs['rbms']
    s = {'W0': t(r1['W']), 'W1': t(r2['W']), 'vb': t(r1['vb']),
         'hb0': 0.5 * t(r1['hb']) + 0.5 * t(r2['vb']), 'hb1': t(r2['hb']),
         'v': t(inputs['v0']), 'H0': t(inputs['H0']), 'H1': t(inputs['H1'])}
    for k in ('W0', 'W1', 'vb', 'hb0', 'hb1'):
        s['d' + k] = torch.zeros_like(s[k])
    for l in (0, 1):
        s['q%d' % l] = torch.zeros_like(s['hb%d' % l])
        s['m%d' % l] = torch.zeros_like(s['hb%d' % l])
    return s


def mean_field(X, s, cfg, prec):
    """The mean-field means of the batch X and the sweeps taken.  With
    ``mf_stop_early`` in `cfg` (a fault the calibration plants) it returns
    the means of the sweep before the one that met the tolerance."""
    W0, W1, hb0, hb1 = s['W0'], s['W1'], s['hb0'], s['hb1']
    T0 = prec.mm(X, W0)
    mu0 = torch.sigmoid(2. * T0 + hb0)
    mu1 = torch.sigmoid(prec.mm(mu0, W1) + hb1)
    tol = float(torch.tensor(cfg['mf_tol'], dtype=X.dtype))
    n, delta, before = 0, math.inf, (mu0, mu1)
    while n < cfg['max_mf_updates'] and delta > tol:
        new0 = torch.sigmoid(T0 + prec.mm(mu1, W1.T) + hb0)
        new1 = torch.sigmoid(prec.mm(new0, W1) + hb1)
        delta = float(torch.maximum(torch.max(torch.abs(new0 - mu0)),
                                    torch.max(torch.abs(new1 - mu1))))
        before = (mu0, mu1)
        mu0, mu1, n = new0, new1, n + 1
    if cfg.get('mf_stop_early') and n > 1:
        return before[0], before[1], n - 1
    return mu0, mu1, n


def _max_norm(W, max_norm):
    if not math.isfinite(max_norm):
        return W
    norm = torch.linalg.vector_norm(W, dim=0)
    return W * torch.clamp(norm, max=max_norm) / torch.clamp(norm, min=1e-8)


def step(s, X, lr, mom, seed, it, cfg, prec, draws):
    """One PCD step on the batch X; returns the new state."""
    W0, W1 = s['W0'], s['W1']
    mu0, mu1, n = mean_field(X, s, cfg, prec)
    draws.sweeps.append(n)
    v, H0, H1 = s['v'], s['H0'], s['H1']

    def sample(p, sweep, layer, on):
        stream = philox.stream_dbm(sweep, layer, 2)
        return draws.bernoulli(p, seed, it, stream, (it, stream)) if on \
            else p

    sample_h0, sample_h1 = cfg['sample_h_states']
    for g in range(int(cfg['n_gibbs_steps'])):
        H0 = sample(torch.sigmoid(prec.mm(v, W0) + prec.mm(H1, W1.T) +
                                  s['hb0']), g, 0, sample_h0)
        H1 = sample(torch.sigmoid(prec.mm(H0, W1) + s['hb1']), g, 1,
                    sample_h1)
        v = sample(torch.sigmoid(prec.mm(H0, W0.T) + s['vb']), g, 2,
                   cfg['sample_v_states'])
    N, M = X.shape[0], v.shape[0]
    damp = cfg['sparsity_damping']
    grads = {'vb': X.sum(0) / N - v.sum(0) / M,
             'W0': prec.mm(X.T, mu0) / N - prec.mm(v.T, H0) / M -
             cfg['l2'] * W0,
             'W1': prec.mm(mu0.T, mu1) / N - prec.mm(H0.T, H1) / M -
             cfg['l2'] * W1,
             'hb0': mu0.sum(0) / N - H0.sum(0) / M,
             'hb1': mu1.sum(0) / N - H1.sum(0) / M}
    out = {'v': v, 'H0': H0, 'H1': H1}
    for l, (mu, H) in enumerate(((mu0, H0), (mu1, H1))):
        q = damp * s['q%d' % l] + (1. - damp) * H.sum(0)
        m = damp * s['m%d' % l] + (1. - damp) * mu.sum(0)
        cost, target = cfg['sparsity_cost'][l], cfg['sparsity_target'][l]
        pen = cost * (q - target) + cost * (m - target)
        grads['W%d' % l] = grads['W%d' % l] - pen
        grads['hb%d' % l] = grads['hb%d' % l] - pen
        out['q%d' % l], out['m%d' % l] = q, m
    for k, g in grads.items():
        acc = lr * (mom * s['d' + k] + g)
        out['d' + k] = acc
        out[k] = s[k] + acc
    for k in ('W0', 'W1'):
        out[k] = _max_norm(out[k], cfg['max_norm'])
    return out
