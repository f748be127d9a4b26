"""Plain reference of a multinomial RBM trained by CD-k (the configuration
family ``multinomial_rbm``).

It follows the reference library's ``MultinomialRBM`` (yell/boltzmann-
machines ``BaseRBM`` with a Bernoulli visible layer and one multinomial
hidden unit of ``n_samples`` tied softmax units): hidden means
``n softmax(up (v W + hb))``, ``up`` 2 for ``dbm_first``; their counts
drawn; k Gibbs steps, each visible mean ``sigmoid(down (h W^T + vb))``
(``down`` 2 for ``dbm_last``) and, with ``sample_v_states``, its Bernoulli
state; ``dW = (X^T h0_means - v^T h_means) / B - l2 W`` less the sparsity
penalty on the EMA of the chain-end hidden means' batch sums; momentum
``acc <- lr (m acc + g); param += acc``.  It imports nothing of the
program, and neither JAX nor its package.

Departures from the library's description, all as the program draws:

- the counts are Multinomial(n, means / n) draws on the program's Philox
  uniforms, draw j of row b the uniform at element ``b n + j`` landing in
  the first bucket whose CDF exceeds it (``gbm_dbm.multinomial``, not
  TensorFlow's sampler); the visible states are Bernoulli draws on the
  same stream's uniforms (``common.Draws``);
- the last Gibbs step's hidden counts are not drawn: nothing reads them;
- the sparsity penalty acts on the batch sum of the hidden means (counts,
  up to n a row), as the program's does.

Draws near an edge.  A row of n = 512 draws over 511 bucket edges holds
a few draws a step that float32 rounding of the logits moves across an
edge: too many to search one by one.  The judging reference takes them
from the program's counts, as the ``gbm_dbm`` family does: the
configuration it steps by carries, by global iteration and stream, the
counts the program drew in every judged step (``program_counts``; the
benchmark's session reads them from the program's own kernels), and each
draw that the program's counts ask to cross an edge crosses it only from
within that edge's band (TIE_BAND + ``gbm_dbm.SHOWN_FACTOR`` x 2 delta
min(e, 1 - e), delta the row's float32 rounding of its logits).
``taken`` records, by (iteration, stream), the draws taken and how close
they came to their band.  Bernoulli ties are searched by
``common.follow``.

Faults the calibration plants besides the common ones (``EXTRA_FAULTS``):
``short_chain`` in the configuration (k 1 in place of the configured k)
and ``draw_shift`` (every uniform of the softmax rows' draws moved up by
this, as a program whose draws are off would be).  ``drawn`` keeps, by
iteration and stream, the counts of the steps computed in a precision
other than float64 (a reference put in the program's place), so that a
calibration can judge such a run with its own counts.

Every step is computed in the precision it is handed (float64 for the
reference that judges).
"""

import torch

from . import gbm_dbm, philox
from .bernoulli_rbm import ACCUMULATORS, PARAMS  # noqa: F401

# the reference's products are float64 or emulate TF32 by hand
# (``common.to_tf32``): never the tensor cores' TF32 mode
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

EXTRA_FAULTS = ('short_chain', 'draw_shift')
#: the planted draw fault's shift of every uniform of the softmax rows
DRAW_SHIFT = 5e-5
#: by (iteration, stream), of the last judged step that took draws from
#: the program's counts: (draws taken, draws asked for outside their band,
#: the farthest asked for over what float32 rounding moves its edge)
taken = {}
#: {iteration: {stream: counts}} of the steps computed below float64
drawn = {}


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
    """One CD-k step on the batch X; returns the new state."""
    up = 2. if cfg.get('dbm_first') else 1.
    down = 2. if cfg.get('dbm_last') else 1.
    n = int(cfg['n_samples'])
    k = 1 if cfg.get('short_chain') else int(cfg['n_gibbs_steps'])
    shift = DRAW_SHIFT if cfg.get('draw_shift') else 0.
    B = X.shape[0]
    W, vb, hb = s['W'], s['vb'], s['hb']
    judge = prec.name == 'float64'
    shown = cfg.get('program_counts', {}).get(it, {}) if judge else {}

    def h_means(v):
        return float(n) * torch.softmax(up * (prec.mm(v, W) + hb), dim=1)

    def counts(v, means, stream):
        show = shown.get(stream)
        # counts of other rows (a run that left rows out) show nothing of
        # this draw
        if show is not None and tuple(show.shape) != tuple(means.shape):
            show = None
        delta = None if show is None else \
            up * gbm_dbm.logit_rounding(v, W, hb)
        out = gbm_dbm.multinomial(means, n, seed, it, stream, show,
                                  draws if judge else None, (it, stream),
                                  delta, shift)
        if show is not None and it in gbm_dbm.taken:
            taken[(it, stream)] = gbm_dbm.taken.pop(it)
        if not judge:
            drawn.setdefault(it, {})[stream] = out
        return out

    h0 = h_means(X)
    h = counts(X, h0, philox.STREAM_H0) if cfg['sample_h_states'] else h0
    v, hm = X, h0
    for g in range(k):
        vm = torch.sigmoid(down * (prec.mm(h, W.T) + vb))
        sv = philox.stream_v(g)
        v = draws.bernoulli(vm, seed, it, sv, (it, sv)) \
            if cfg['sample_v_states'] else vm
        hm = h_means(v)
        # the last step's hidden counts feed nothing
        if cfg['sample_h_states'] and g < k - 1:
            h = counts(v, hm, philox.stream_h(g))
        else:
            h = hm
    damp = cfg['sparsity_damping']
    q = damp * s['q'] + (1. - damp) * torch.sum(hm, dim=0)
    pen = cfg['sparsity_cost'] * (q - cfg['sparsity_target'])
    gW = (prec.mm(X.T, h0) - prec.mm(v.T, hm)) / B - cfg['l2'] * W - pen
    dW = lr * (mom * s['dW'] + gW)
    dvb = lr * (mom * s['dvb'] + torch.mean(X - v, dim=0))
    dhb = lr * (mom * s['dhb'] + torch.mean(h0 - hm, dim=0) - pen)
    return {'W': W + dW, 'vb': vb + dvb, 'hb': hb + dhb, 'dW': dW,
            'dvb': dvb, 'dhb': dhb, 'q': q}
