"""Plain reference of a two-layer Gaussian-Bernoulli-Multinomial DBM trained
by PCD with mean-field (the configuration family ``gbm_dbm``).

It follows the reference library's ``DBM`` with the layers of
``examples/dbm_cifar_naive.py``: Gaussian visible units of a fixed sigma
whose mean is ``h W^T sigma + vb`` (the DBM takes its inputs raw: no
division by sigma), a Bernoulli hidden layer, and a multinomial top layer
of ``n_samples`` tied softmax units whose means are the expected counts
``n softmax(x + b)``.  The step is the ``dbm`` family's (``dbm.py``): the
weights stacked from the two RBMs, mean-field from the doubled bottom-up
pass (the Bernoulli layer's product doubled inside its sigmoid, the top
layer's not) until no unit moves by more than ``mf_tol`` -- in counts for
the top layer -- or ``max_mf_updates`` sweeps, k sampled Gibbs sweeps of
the persistent particles (h1 from v and the old h2, then h2, then v from
the new h1), the data statistics over the mean-field means less the
particles' (the top layer's in counts), L2, the sparsity penalty on the
EMAs of the batch sums, momentum, and the column max-norm of the new W.
It imports nothing of the program.

The draws, all on the program's Philox stream of the layer (key (seed,
iteration), counter (element, stream)):

- h1: Bernoulli states on the uniforms (``common.Draws``);
- h2: Multinomial(n, means / n) counts per row: draw j of row b is the
  uniform at element ``b n + j`` and lands in the first bucket whose CDF
  exceeds it, the CDF of means / n summed in this precision with its last
  entry +inf (``multinomial``; the program accumulates it in float64 and
  rounds each entry to float32);
- v: ``mean + sigma z``, z Box-Muller on words 0 and 1 of the element's
  counter (``gaussian_rbm.normal``, computed in this precision).

A Bernoulli draw whose uniform lies within ``common.TIE_BAND`` of its mean
is a tie to rounding, which ``common.follow`` takes on the program's side
by its search.  So is a multinomial draw that lies close enough to a
bucket's edge, but a row of n = 1000 draws over 999 edges holds hundreds
of such draws a step: too many to search one by one.  The judging
reference takes them from the program's counts instead, where the
program's state shows them: the configuration it steps by carries the
program's h1 states and top-layer counts after each step that ends a
``fit`` call (``program_h0``, ``program_h1``, by global iteration: the
set-up's steps 1 and 3 and the late steps), and the float64 step's last
draw of such a step moves, in each row, as many draws across an edge as
the program's counts need, each only from within that edge's band
(``multinomial``).  The band is what the program's float32 rounding can
move the edge: the row's logits computed here in float32 differ from
float64's by at most delta, which moves edge e by at most 2 delta
min(e, 1 - e); the band is SHOWN_FACTOR times that, plus TIE_BAND.
``taken`` records, by iteration, how many draws each judged step took
from the program's counts and how close they came to their band (of the
run ``common.follow`` keeps, under ``recording``).
The set-up's step 2, which no state shows, draws on float64's sides, and
its draws within TIE_BAND of an edge join ``common.follow``'s search only
in the rows whose h1 states differ from the program's in step 3 (a count
moved in step 2 moves that row's h1 means in step 3): a handful of sites.

Faults the calibration plants: ``mf_stop_early`` in the configuration
(mean-field stops a sweep before it meets its tolerance, as in the
``dbm`` family) and ``draw_shift`` (every uniform of the multinomial
draws moved up by this, as a program whose draws are off would be).
"""

import contextlib
import math

import torch

from . import common, philox
from .dbm import ACCUMULATORS, PARAMS, _max_norm, initial_state  # noqa: F401
from .gaussian_rbm import normal

#: faults of this family that the calibration reads besides the common
#: ones: mean-field stopped one sweep before it meets its tolerance
EXTRA_FAULTS = ('early_mean_field',)
#: how many times the float32 rounding of its logits a draw may lie from
#: an edge and still be taken to the program's side where the program's
#: counts show it there (the program's products are 3xTF32 sums of 5000
#: terms in another order than the float32 product here)
SHOWN_FACTOR = 8.
#: counts that differ from the program's at more edges than this are no
#: tie's doing (a tie moves a count across an edge or two): it keeps
#: float64's sides, and a judge of a program that draws otherwise (an
#: older one, through other streams) stays cheap
SHOWN_EDGES = 256
#: the rows of an earlier step searched at most: a count moved there moves
#: one row's h1 states in the next step; more rows are no tie's doing
SEARCH_ROWS = 8
#: by iteration, of the last judged step that took draws from the
#: program's counts: (draws taken, draws that the counts asked for but lay
#: outside their band, the largest distance of a draw asked for from its
#: edge, less TIE_BAND, over what float32 rounding can move that edge)
taken = {}


def multinomial(means, n, seed, it, stream, shown=None, draws=None,
                tag=None, delta=None, shift=0.):
    """Multinomial(n, means / n) counts of each row of `means` (expected
    counts, in their precision), draw j of row b the uniform at element
    ``b n + j`` of (`seed`, `it`, `stream`) (plus `shift`, a planted
    fault), in the first bucket whose CDF exceeds it.

    With `shown` (the program's counts of the same draw, differing at no
    more than SHOWN_EDGES edges) and `delta` (each row's float32 rounding
    of its logits), draws near an edge take the program's side: the net
    draws that cross edge e upwards in the program and not here are minus
    the prefix sum to e of (shown - counts), and that many of the draws
    nearest below e (above it, where negative) move across it, those
    within the edge's band (TIE_BAND + SHOWN_FACTOR 2 delta min(e, 1 - e))
    (upward crossings by rising e, then downward ones by falling e, so
    that a draw may cross the edges of narrow buckets); ``taken[it]``
    records them.

    Without it, with `draws` (a ``common.Draws``): the draws within
    TIE_BAND of their nearer edge are kept in ``draws.multinomial_ties``
    as ((`tag`, b n + j), b), and those named in ``draws.flips`` cross
    that edge."""
    B, H = means.shape
    n = int(n)
    edges = torch.cumsum(means / n, dim=1)[:, :H - 1].contiguous()
    u = philox.uniform(seed, it, stream, (B, n), means.device).to(
        means.dtype)
    if shift:
        u = torch.clamp(u + shift, max=1. - torch.finfo(u.dtype).eps / 2)
    # the bucket: the number of finite edges <= u (the last is +inf)
    pos = torch.searchsorted(edges, u, right=True)

    def counts():
        return torch.zeros_like(means).scatter_add_(1, pos,
                                                    torch.ones_like(u))
    if shown is not None:
        shown = torch.as_tensor(shown, device=means.device).to(means.dtype)
        cross = -torch.cumsum(shown - counts(), dim=1).round().to(
            torch.int64)
        sites = torch.nonzero(cross).tolist()
        if len(sites) > SHOWN_EDGES:
            taken[it] = (0, int(cross.abs().sum()), math.inf)
            return counts()
        up = sorted((e, b) for b, e in sites if cross[b, e] > 0)
        down = sorted(((e, b) for b, e in sites if cross[b, e] < 0),
                      reverse=True)
        moved, missed, worst = 0, 0, 0.
        for e, b in up + down:
            need = int(cross[b, e])
            # each draw's distance from edge e, on the side it leaves
            gap = edges[b, e] - u[b] if need > 0 else u[b] - edges[b, e]
            reach = 2. * float(delta[b]) * max(min(
                float(edges[b, e]), 1. - float(edges[b, e])), 0.)
            at = torch.nonzero(pos[b] == (e if need > 0 else e + 1))
            at = at.flatten()
            at = at[torch.argsort(gap[at])][:abs(need)]
            far = float(gap[at].max()) - common.TIE_BAND if len(at) else \
                math.inf
            worst = max(worst, far / reach if reach > 0. else
                        (0. if far <= 0. else math.inf))
            at = at[gap[at] < common.TIE_BAND + SHOWN_FACTOR * reach]
            missed += abs(need) - len(at)
            moved += len(at)
            pos[b, at] += 1 if need > 0 else -1
        taken[it] = (moved, missed, worst)
        return counts()
    if draws is None:
        return counts()
    inf = torch.full_like(u, math.inf)
    lo = torch.where(pos > 0, edges.gather(1, (pos - 1).clamp(min=0)), -inf)
    hi = torch.where(pos < H - 1,
                     edges.gather(1, pos.clamp(max=max(H - 2, 0))), inf)
    below = (hi - u) < (u - lo)   # the nearer edge is the bucket's upper
    near = torch.nonzero((torch.minimum(hi - u, u - lo) <
                          common.TIE_BAND).reshape(-1)).flatten().tolist()
    draws.multinomial_ties = getattr(draws, 'multinomial_ties', []) + [
        ((tag, j), j // n) for j in near]
    flat = pos.view(-1)
    for t, j in draws.flips:
        if t == tag:
            flat[j] += 1 if bool(below.view(-1)[j]) else -1
    return counts()


@contextlib.contextmanager
def recording():
    """While open, ``common.follow`` leaves in ``taken`` the record of the
    run it returns, not of the last run it tried: it draws that run once
    more."""
    follow = common.follow

    def again(run, target, **kw):
        state, draws = follow(run, target, **kw)
        run(common.Draws(draws.flips))
        return state, draws
    common.follow = again
    try:
        yield
    finally:
        common.follow = follow


def _search_rows(draws, H0, shown0):
    """Offer ``common.follow`` the earlier steps' multinomial ties of the
    rows whose h1 states `H0` differ from the program's `shown0`, where
    at most SEARCH_ROWS rows do."""
    shown0 = torch.as_tensor(shown0, device=H0.device).to(H0.dtype)
    rows = set(torch.nonzero((H0 != shown0).any(1)).flatten().tolist())
    if len(rows) > SEARCH_ROWS:
        return
    for site, b in getattr(draws, 'multinomial_ties', []):
        if b in rows and site not in draws.ties:
            draws.ties.append(site)


def top_means(x, n):
    """The multinomial layer's expected counts n softmax(x)."""
    return float(n) * torch.softmax(x, dim=1)


def mean_field(X, s, cfg, prec):
    """The mean-field means of the batch X and the sweeps taken.  With
    ``mf_stop_early`` in `cfg` (a fault the calibration plants) it returns
    the means of the sweep before the one that met the tolerance."""
    W0, W1, hb0, hb1 = s['W0'], s['W1'], s['hb0'], s['hb1']
    n = cfg['n_samples']
    T0 = prec.mm(X, W0)
    mu0 = torch.sigmoid(2. * T0 + hb0)
    mu1 = top_means(prec.mm(mu0, W1) + hb1, n)
    tol = float(torch.tensor(cfg['mf_tol'], dtype=X.dtype))
    k, delta, before = 0, math.inf, (mu0, mu1)
    while k < cfg['max_mf_updates'] and delta > tol:
        new0 = torch.sigmoid(T0 + prec.mm(mu1, W1.T) + hb0)
        new1 = top_means(prec.mm(new0, W1) + hb1, n)
        delta = float(torch.maximum(torch.max(torch.abs(new0 - mu0)),
                                    torch.max(torch.abs(new1 - mu1))))
        before = (mu0, mu1)
        mu0, mu1, k = new0, new1, k + 1
    if cfg.get('mf_stop_early') and k > 1:
        return before[0], before[1], k - 1
    return mu0, mu1, k


def logit_rounding(H, W, b):
    """Each row's largest difference between the logits ``H W + b``
    computed in float32 and in float64."""
    f32 = H.to(torch.float32) @ W.to(torch.float32) + b.to(torch.float32)
    x = H.to(torch.float64) @ W.to(torch.float64) + b.to(torch.float64)
    return (f32.to(torch.float64) - x).abs().amax(1)


def step(s, X, lr, mom, seed, it, cfg, prec, draws):
    """One PCD step on the batch X; returns the new state."""
    W0, W1 = s['W0'], s['W1']
    n, sigma = cfg['n_samples'], float(cfg['sigma'])
    mu0, mu1, n_mf = mean_field(X, s, cfg, prec)
    draws.sweeps.append(n_mf)
    v, H0, H1 = s['v'], s['H0'], s['H1']
    sample_h0, sample_h1 = cfg['sample_h_states']
    # the program's h1 states and counts after this step, for the judge
    # alone (None where no state of the program shows them)
    judge = prec.name == 'float64'
    shown0, shown = ((cfg.get(key, {}).get(it) if judge else None)
                     for key in ('program_h0', 'program_h1'))
    k = int(cfg['n_gibbs_steps'])
    for g in range(k):
        st = [philox.stream_dbm(g, l, 2) for l in range(3)]
        p0 = torch.sigmoid(prec.mm(v, W0) + prec.mm(H1, W1.T) + s['hb0'])
        H0 = draws.bernoulli(p0, seed, it, st[0], (it, st[0])) \
            if sample_h0 else p0
        if g == k - 1 and shown0 is not None:
            _search_rows(draws, H0, shown0)
        m1 = top_means(prec.mm(H0, W1) + s['hb1'], n)
        show = shown if g == k - 1 else None
        H1 = multinomial(
            m1, n, seed, it, st[1], show, draws if judge else None,
            (it, st[1]), None if show is None else
            logit_rounding(H0, W1, s['hb1']),
            cfg.get('draw_shift', 0.)) if sample_h1 else m1
        vm = prec.mm(H0, W0.T) * sigma + s['vb']
        v = vm + sigma * normal(seed, it, st[2], vm.shape, vm.device,
                                vm.dtype) if cfg['sample_v_states'] else vm
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
