"""Plain reference of a Bernoulli RBM trained by CD-k (the configuration
family ``bernoulli_rbm``).

It follows the reference library's update (yell/boltzmann-machines
``BaseRBM``): hidden means of the data, their states drawn, k Gibbs
steps, ``dW = (X^T h0_means - v^T h_means) / B - l2 W`` less the sparsity
penalty on the EMA of the chain-end hidden means' batch sums, momentum
``acc <- lr (m acc + g); param += acc``.  The draws take the program's
Philox uniforms (``philox.py``) under the keys its seed plumbing gives
(``common.op_seeds``, ``derive_seed``).  It imports nothing of the
program.
"""

import numpy as np
import torch

from . import philox

PARAMS = ('W', 'vb', 'hb')
ACCUMULATORS = {'W': 'dW', 'vb': 'dvb', 'hb': 'dhb'}


def logit_mean(X):
    p = np.clip(np.mean(np.asarray(X, np.float64), axis=0), 1e-7, 1 - 1e-7)
    return np.log(p / (1. - p))


def initial_state(inputs, prec, device):
    cfg = inputs['config']
    V, H = cfg['n_visible'], cfg['n_hidden']
    t = lambda x: prec.tensor(x, device)
    vb = logit_mean(inputs['X']) if cfg['vb_init'] == 'logit_mean' \
        else np.full(V, cfg['vb_init'])
    zeros = lambda *s: torch.zeros(s, dtype=prec.dtype, device=device)
    hb = np.full(H, cfg['hb_init'])
    return {'W': t(inputs['W0']), 'vb': t(vb), 'hb': t(hb),
            'dW': zeros(V, H), 'dvb': zeros(V), 'dhb': zeros(H),
            'q': zeros(H)}


def step(s, X, lr, mom, seed, it, cfg, prec, draws):
    """One CD-k step on the batch X; returns the new state."""
    up = 2. if cfg.get('dbm_first') else 1.
    down = 2. if cfg.get('dbm_last') else 1.
    k = int(cfg['n_gibbs_steps'])
    B = X.shape[0]
    W, vb, hb = s['W'], s['vb'], s['hb']

    def h_means(v):
        return torch.sigmoid(up * (prec.mm(v, W) + hb))

    def sample(p, stream, on):
        return draws.bernoulli(p, seed, it, stream, (it, stream)) if on \
            else p

    h0 = h_means(X)
    h = sample(h0, philox.STREAM_H0, cfg['sample_h_states'])
    v, hm = X, h0
    for g in range(k):
        vm = torch.sigmoid(down * (prec.mm(h, W.T) + vb))
        v = sample(vm, philox.stream_v(g), cfg['sample_v_states'])
        hm = h_means(v)
        # the last step's hidden states feed nothing
        h = sample(hm, philox.stream_h(g),
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
