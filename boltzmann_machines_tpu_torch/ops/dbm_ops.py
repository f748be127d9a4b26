"""The DBM's device programs: the PCD / mean-field training epoch, the
particle sampler and the AIS sweep.

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

The AIS wrappers also run ``log_Z``'s options (JAX dbm.py:1042-1196, which
computes them on XLA): any beta ladder (``AISConfig.ladder``), a base rate
``b0`` (the base distribution p0(h1) propto exp(h1.b0)), the reverse run of
BDMC (``reverse_ais``) and the burn-in of its start at beta = 1
(``ais_burn_in``), on the same kernels.

`state` is the JAX package's DBM pytree: {vb, hb, W, dvb, dhb, dW, q_means,
mu_means, v, H} with per-layer tuples.  The epoch follows the CD epoch's
``iter0`` convention (ops/cd_epoch.py): minibatch ``i`` is global iteration
``it = iter0 + i + 1``, which keys its random draws; the rows hold every
minibatch's msre and mean-field update count.  The epoch takes any batch
size (a fit's remainder batch runs through it with its own row count).
Input states are not modified.  ``n_runs`` may be any positive number (the
TPU's multiple-of-8 rule was a sublane limit).

``dbm_mesh_epoch`` is one rank's data-parallel epoch (the JAX package's
shard_map epoch): the plain program on the rank's rows of every batch and
of the particles, its draws through the standalone samplers, the raw
statistics summed over the ranks in one buffer.

Each program has three parts:

* a plain PyTorch version (``dbm_epoch_reference``, ``dbm_sample_reference``,
  ``ais_reference``), which the fit path runs on the CPU and the tests hold
  against the JAX package;
* a wrapper (``dbm_epoch``, ``dbm_sample``, ``ais``): a CPU tensor runs the
  plain version, a CUDA tensor launches the hand-written kernels of
  ``csrc/dbm_ops.cu`` (built on first use) or raises;
* ``<wrapper>.launches``: how many times the wrapper launched each kernel.

On the kernels, a step's mean-field loop is one launch of a CUDA graph
(``bm_dbm_mf_graph_*``) whose WHILE node runs turns of ``MF_BODY_SWEEPS``
sweeps, each sweep L ``dbm_gemm_act`` layer launches (and a ``dbm_softmax``
launch after a multinomial layer's), and a ``dbm_mf_check`` launch after
each turn, until mean-field stops.  The graph counts its turns in a
control word; ``dbm_epoch`` reads it once the epoch's steps are enqueued
and adds the kernels the turns ran to ``dbm_epoch.launches``
(``mf_graph_launches``: L x ``MF_BODY_SWEEPS`` ``dbm_gemm_act``, a
multinomial layer's ``dbm_softmax`` a sweep, and one ``dbm_mf_check`` a
turn, those of sweeps after the stop included: they run and return at
once).  ``dbm_epoch.graph_launches`` counts the graph's
launches, one a step, apart from the kernels.

Beside the epoch's launches and not among them, ``dbm_epoch.sweeps``
counts the training steps' mean-field sweeps: ``mf_sweeps_enqueued``, the
budget the epochs offered (``max_mf_updates`` a step on the kernels; the
sweeps run on the plain paths), and ``mf_sweeps``, the sweeps the steps
ran, which ``DBM.fit`` adds from the n_mf row it copies to the host every
epoch.  ``dbm_epoch.profiled_sweeps`` holds the same two counts and the
``steps`` of the training epochs that ran while a ``torch.profiler``
session was active: what a trace covers.

Random draws come from the Philox streams of ``ops/philox.py``, which the
kernels reproduce exactly, so kernel and plain version draw the same
uniforms.

A DBM with Gaussian or multinomial layers (the CIFAR pipelines'
Gaussian-Bernoulli-Multinomial DBM, which the JAX package runs on XLA)
names its layers in the configs' ``units`` (the layer objects of
``layers.py``, visible first; None, the default, is all-Bernoulli), each
layer's activation its unit's (sigmoid(x + b), n softmax(x + b), x sigma +
b).  The epoch's kernels take every float32 DBM whose visible units are
Bernoulli or Gaussian and whose hidden layers are Bernoulli or multinomial
(``kernel_units``): a Gaussian layer's launches are ``dbm_gemm_act``'s
Gaussian instance (the mean x sigma + b, the state mean + sigma eps with eps
Box-Muller on the layer's Philox counter), and a multinomial layer is an
identity ``dbm_gemm_act`` launch writing its pre-activations, then a
``dbm_softmax`` launch that writes n softmax and, in the mean-field graph,
folds the change in counts into the sweep's change word, or draws the
counts on the layer's Philox stream (``philox.multinomial_counts``).  The
plain epoch draws the same numbers (``philox_draw``), so kernel and plain
version compare state by state.  Other layouts run the plain epoch on
their device.  ``dbm_sample`` of a DBM with Gaussian or multinomial layers
runs the plain program on its device, its sampled layers drawn through the
standalone samplers of ``ops/samplers.py`` (``bernoulli_sample``,
``normal_sample`` for ``means + sigma eps``, ``multinomial_sample``), each
under a key of its own (``draw_key``): on CUDA tensors the wrapper
launches the samplers' kernels, one launch a sampled layer a sweep; the
plain version draws the same numbers through the samplers' ``*_reference``
functions.  So does the mesh's epoch (``dbm_mesh_epoch``).
"""

import ctypes
import math
from collections import namedtuple

import numpy as np
import torch
import torch.nn.functional as F

from ..layers import BernoulliLayer, GaussianLayer, MultinomialLayer
from . import samplers
from .gemm import (TILE_K, assoc_k_tiles, assoc_plan, check_operand,
                   count_stages, launch_plan, num_sms, reset_stages)
from .philox import (AIS_H1, AIS_H2, AIS_V, bernoulli, multinomial_counts,
                     normal, stream_ais, stream_dbm)

STATE_KEYS = ('vb', 'hb', 'W', 'dvb', 'dhb', 'dW', 'q_means', 'mu_means',
              'v', 'H')
#: keys whose value is a tuple with one tensor per layer
LAYER_KEYS = ('hb', 'W', 'dhb', 'dW', 'q_means', 'mu_means', 'H')

EPOCH_KERNELS = ('dbm_gemm_act', 'dbm_bias_update', 'dbm_assoc_update',
                 'dbm_max_norm', 'dbm_msre', 'dbm_mf_check', 'dbm_softmax')
SAMPLE_KERNELS = ('dbm_gemm_act',)
AIS_KERNELS = ('dbm_gemm_act', 'ais_logw')
#: the mean-field sweep counts of ``dbm_epoch.sweeps``, and of
#: ``dbm_epoch.profiled_sweeps`` with its steps
SWEEP_COUNTS = ('mf_sweeps_enqueued', 'mf_sweeps')
PROFILED_COUNTS = ('steps',) + SWEEP_COUNTS

# `units`: the layer objects (layers.py) of the visible and each hidden
# layer, or None (the default) for an all-Bernoulli DBM
DBMEpochConfig = namedtuple('DBMEpochConfig', (
    'layer_sizes', 'k', 'max_mf_updates', 'mf_tol', 'sample_v', 'sample_h',
    'l2', 'max_norm', 'sparsity_target', 'sparsity_cost',
    'sparsity_damping', 'units'), defaults=(None,))
DBMSampleConfig = namedtuple('DBMSampleConfig', (
    'layer_sizes', 'sample_v', 'sample_h', 'units'), defaults=(None,))
#: the standalone samplers a DBM with Gaussian or multinomial layers draws
#: through, one launch a sampled layer a sweep on CUDA tensors
SAMPLER_KERNELS = ('bernoulli_sample', 'normal_sample', 'multinomial_sample')
# `ladder`: the float64 beta ladder 0 = b_0 < ... < b_n_betas = 1
# (``make_beta_schedule``), or None (the default) for the linear ladder in
# the JAX kernel's float32 arithmetic (``ais_schedule``)
AISConfig = namedtuple('AISConfig', (
    'n_visible', 'n_h1', 'n_h2', 'n_betas', 'k', 'sample_v', 'sample_h0',
    'sample_h1', 'ladder'), defaults=(None,))


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
def all_bernoulli(units):
    """Whether `units` (a config's ``units``) is an all-Bernoulli stack."""
    return units is None or all(isinstance(u, BernoulliLayer) for u in units)


def kernel_units(units):
    """Whether the epoch's kernels take a DBM of `units` (a config's
    ``units``): Bernoulli or Gaussian visible units, Bernoulli or
    multinomial hidden layers."""
    if units is None:
        return True
    return isinstance(units[0], (BernoulliLayer, GaussianLayer)) and all(
        isinstance(u, (BernoulliLayer, MultinomialLayer)) for u in units[1:])


def activation(unit, x, b):
    """Mean activation of a layer of `unit` (a layer object of
    ``layers.py``, None for Bernoulli) given the total input `x` and the
    bias `b` (JAX layers.py:54, :82, :135): sigmoid(x + b), n softmax(x +
    b), or x sigma + b -- the DBM does not divide by sigma."""
    if unit is None or isinstance(unit, BernoulliLayer):
        return torch.sigmoid(x + b)
    return unit.activation(x, b)


def _hidden_units(units, L):
    return (None,) * L if units is None else tuple(units[1:])


def mean_field(X, W, hb, max_mf_updates, mf_tol, units=None,
               reduce_max=None):
    """Mean-field fixed point of the hidden layers given `X` (JAX
    ``DBM._mf``, dbm.py:412-481): the bottom-up init with doubled inputs
    below the top layer (inside each layer's activation), then sweeps until
    the largest change of any unit -- in its own scale, counts for a
    multinomial layer -- is <= `mf_tol` (compared in X's dtype) or
    `max_mf_updates` sweeps ran.  Returns (mu, n_updates); syncs with the
    host once per sweep.  `reduce_max` (a mesh's rows of one batch) takes
    each sweep's change, a (1,) tensor, to its max over the ranks in place,
    so that every rank stops where the whole batch would (JAX's pmax)."""
    L = len(W)
    hu = _hidden_units(units, L)
    T0 = X @ W[0]  # loop-invariant, hoisted as in the JAX package
    mu = [activation(hu[0], 2. * T0, hb[0])]
    for l in range(1, L):
        T = mu[-1] @ W[l]
        if l < L - 1:
            T = 2. * T
        mu.append(activation(hu[l], T, hb[l]))
    tol = float(torch.tensor(mf_tol, dtype=X.dtype))
    n, delta = 0, math.inf
    while n < max_mf_updates and delta > tol:
        new = list(mu)
        T = T0 + mu[1] @ W[1].T if L >= 2 else T0
        new[0] = activation(hu[0], T, hb[0])
        for l in range(1, L - 1):
            T = new[l - 1] @ W[l] + mu[l + 1] @ W[l + 1].T
            new[l] = activation(hu[l], T, hb[l])
        if L >= 2:
            new[L - 1] = activation(hu[L - 1], new[L - 2] @ W[L - 1],
                                    hb[L - 1])
        d = torch.stack([torch.max(torch.abs(a - b))
                         for a, b in zip(new, mu)]).max()
        if reduce_max is not None:
            d = d.reshape(1)
            reduce_max(d)
        delta = float(d)
        mu, n = new, n + 1
    return mu, n


def gibbs_sweep(W, vb, hb, v, H, draw=None, units=None):
    """One layer-parallel block-Gibbs sweep of the chains (v, H) (JAX
    ``DBM._particles_gibbs_step``, dbm.py:356-388): layer l sees the fresh
    layer l-1 and the stale layer l+1; v is drawn last from the fresh
    H[0].  ``draw(means, layer)`` returns the states of hidden layer
    `layer` (``len(W)`` for v); without it the sweep keeps the means."""
    L = len(W)
    hu = _hidden_units(units, L)
    if draw is None:
        def draw(p, _):
            return p
    Hn = list(H)
    T = v @ W[0]
    if L >= 2:
        T = T + H[1] @ W[1].T
    Hn[0] = draw(activation(hu[0], T, hb[0]), 0)
    for l in range(1, L - 1):
        T = Hn[l - 1] @ W[l] + H[l + 1] @ W[l + 1].T
        Hn[l] = draw(activation(hu[l], T, hb[l]), l)
    if L >= 2:
        Hn[L - 1] = draw(activation(hu[L - 1], Hn[L - 2] @ W[L - 1],
                                    hb[L - 1]), L - 1)
    vn = draw(activation(None if units is None else units[0],
                         Hn[0] @ W[0].T, vb), L)
    return vn, tuple(Hn)


def philox_draw(sample_v, sample_h, seed, it, stream_of_layer, units=None):
    """``draw`` for `gibbs_sweep`: the states of the layers whose sampling
    is on, from key (`seed`, `it`) on ``stream_of_layer(l)``, as the
    kernels draw them: Bernoulli states, ``means + sigma eps`` with eps
    ``philox.normal`` for a Gaussian layer, ``philox.multinomial_counts``
    for a multinomial one (`units`: a config's ``units``)."""
    L = len(sample_h)

    def draw(p, l):
        if not (sample_v if l == L else sample_h[l]):
            return p
        unit = None if units is None else units[0 if l == L else l + 1]
        stream = stream_of_layer(l)
        if isinstance(unit, GaussianLayer):
            eps = normal(seed, it, stream, p.shape, p.device).to(p.dtype)
            return p + eps * unit._sigma(p)
        if isinstance(unit, MultinomialLayer):
            return multinomial_counts(p, unit.n_samples, seed, it, stream)
        return bernoulli(p, seed, it, stream)

    return draw


def draw_key(seed, it, sweep, layer):
    """The 32-bit key of one layer's draw in one Gibbs sweep of a DBM with
    Gaussian or multinomial layers: the standalone samplers take one key
    word and count from 0, so each (seed, iteration, sweep, layer) hashes
    (numpy's SeedSequence) to a key of its own."""
    ss = np.random.SeedSequence([int(seed), int(it), int(sweep), int(layer)])
    return int(ss.generate_state(1, np.uint32)[0])


def sample_states(unit, means, key, reference=False):
    """States of a layer of `unit` with these means under `key`, through
    the standalone samplers (JAX ``layer.sample``): Bernoulli thresholds,
    ``means + sigma eps`` with standard normals eps, or per-row
    Multinomial(n, means / n) counts.  The wrappers launch their kernels on
    CUDA tensors; `reference` takes the plain versions (the same numbers)
    on any device."""
    if unit is None or isinstance(unit, BernoulliLayer):
        fn = samplers.bernoulli_sample_reference if reference \
            else samplers.bernoulli_sample
        return fn(key, means)
    if hasattr(unit, 'sigma'):
        if reference:
            eps = samplers.normal_sample_reference(key, means.shape,
                                                   means.device)
        else:
            eps = samplers.normal_sample(key, means.shape, means.device)
        return means + eps * unit._sigma(means)
    fn = samplers.multinomial_sample_reference if reference \
        else samplers.multinomial_sample
    return fn(key, means, unit.n_samples)


def unit_draw(units, sample_v, sample_h, key_of_layer, reference=False):
    """``draw`` for `gibbs_sweep` of a DBM with Gaussian or multinomial
    layers: the states of each layer whose sampling is on, by
    `sample_states` under ``key_of_layer(l)``."""
    L = len(sample_h)

    def draw(p, l):
        on = sample_v if l == L else sample_h[l]
        if not on:
            return p
        return sample_states(units[0] if l == L else units[l + 1], p,
                             key_of_layer(l), reference)

    return draw


def _sample_draw(cfg, seed, sweep, reference):
    """The draws of ``sample_v``'s sampled sweep `sweep`: the kernels'
    Philox streams for an all-Bernoulli DBM, the standalone samplers
    otherwise."""
    if all_bernoulli(cfg.units):
        return philox_draw(cfg.sample_v, cfg.sample_h, seed, sweep,
                           lambda l: l)
    return unit_draw(cfg.units, cfg.sample_v, cfg.sample_h,
                     lambda l: draw_key(seed, sweep, sweep, l), reference)


def apply_max_norm(W, max_norm):
    """Per-column max-norm constraint (JAX ``DBM._apply_max_norm``)."""
    if not math.isfinite(max_norm):
        return W
    norm = torch.linalg.norm(W, dim=0)
    mx = torch.tensor(max_norm, dtype=W.dtype, device=W.device)
    return W * torch.minimum(norm, mx) / torch.clamp(norm, min=1e-8)


#: the raw statistics of a minibatch, in the order of a mesh's buffer
SUM_KEYS = ('sum_X', 'sum_v', 'pos', 'neg', 'sum_mu', 'sum_H')


def dbm_sums(X, mu, v, H):
    """The raw sums of one minibatch's statistics (JAX ``DBM._dbm_stats``,
    dbm.py:494-527), which add over a mesh's ranks to the whole batch's:
    sum_X, sum_v, the associations pos (data) and neg (particles) of each
    layer, and each layer's sums of mu and of H."""
    L = len(H)
    return {'sum_X': X.sum(0), 'sum_v': v.sum(0),
            'pos': [X.T @ mu[0]] + [mu[l - 1].T @ mu[l] for l in range(1, L)],
            'neg': [v.T @ H[0]] + [H[l - 1].T @ H[l] for l in range(1, L)],
            'sum_mu': [m.sum(0) for m in mu],
            'sum_H': [h.sum(0) for h in H]}


def flatten_sums(sums):
    """`sums` as one flat tensor and a function that views a flat tensor
    of that layout as such a dict (a mesh's one all_reduce a step)."""
    leaves = [(key, l, t) for key in SUM_KEYS
              for l, t in (enumerate(sums[key]) if isinstance(sums[key], list)
                           else [(None, sums[key])])]
    flat = torch.cat([t.reshape(-1) for _, _, t in leaves])

    def view(buf):
        out = {key: ([] if isinstance(sums[key], list) else None)
               for key in SUM_KEYS}
        i = 0
        for key, l, t in leaves:
            part = buf[i:i + t.numel()].view(t.shape)
            i += t.numel()
            if l is None:
                out[key] = part
            else:
                out[key].append(part)
        return out

    return flat, view


def dbm_update(cfg, state, X, mu, v, H, lr, momentum):
    """The parameter update of one minibatch (JAX ``DBM._dbm_stats`` and
    ``_apply_dbm_update``, dbm.py:494-586) from its data `X`, mean-field
    `mu` and advanced particles (v, H)."""
    return apply_dbm_update(cfg, state, dbm_sums(X, mu, v, H), X.shape[0],
                            v.shape[0], v, H, lr, momentum)


def apply_dbm_update(cfg, state, sums, N, M, v, H, lr, momentum):
    """The update from a minibatch's raw sums (``dbm_sums``, over N data
    rows and M particles; JAX ``_apply_dbm_update``, dbm.py:529-586): data
    statistics / N minus particle statistics / M with L2, the per-layer
    sparsity EMAs of the batch sums of both H and mu with their penalty on
    every row of dW and on dhb, the momentum rule ``acc <- lr (m acc + g);
    param += acc``, and the column max-norm of the new W.  (v, H) become
    the particles."""
    L = len(state['W'])
    W = state['W']
    dvb = sums['sum_X'] / N - sums['sum_v'] / M
    dW = [sums['pos'][l] / N - sums['neg'][l] / M - cfg.l2 * W[l]
          for l in range(L)]
    dhb = [sums['sum_mu'][l] / N - sums['sum_H'][l] / M for l in range(L)]
    # 1 - damping in the model's dtype, as the JAX package computes it
    vb = state['vb']
    damp = torch.tensor(cfg.sparsity_damping, dtype=vb.dtype,
                        device=vb.device)
    q_means, mu_means = [], []
    for l in range(L):
        q_new = damp * state['q_means'][l] + (1. - damp) * sums['sum_H'][l]
        m_new = damp * state['mu_means'][l] + \
            (1. - damp) * sums['sum_mu'][l]
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


def reconstruction_means(state, mu0, units=None):
    """p(v | h0 = mu0) means (JAX ``DBM._reconstruction_means``); a
    Gaussian visible layer's are mu0 W0^T sigma + vb."""
    return activation(None if units is None else units[0],
                      mu0 @ state['W'][0].T, state['vb'])


def dbm_step(cfg, state, X, lr, momentum, seed, it):
    """One PCD / mean-field update on minibatch `X` at iteration `it`
    (JAX ``DBM._train_step``, dbm.py:587-595); returns (state, msre,
    n_mf).  msre reads the UPDATED W0 and vb.  Sweep s draws layer l from
    key (`seed`, `it`) on ``stream_dbm(s, l, L)``, as the kernels do."""
    L = len(cfg.layer_sizes) - 1
    mu, n_mf = mean_field(X, state['W'], state['hb'], cfg.max_mf_updates,
                          cfg.mf_tol, cfg.units)
    v, H = state['v'], state['H']
    for s in range(cfg.k):
        draw = philox_draw(cfg.sample_v, cfg.sample_h, seed, it,
                           lambda l, s=s: stream_dbm(s, l, L), cfg.units)
        v, H = gibbs_sweep(state['W'], state['vb'], state['hb'], v, H, draw,
                           cfg.units)
    state = dbm_update(cfg, state, X, mu, v, H, lr, momentum)
    msre = torch.mean(torch.square(
        X - reconstruction_means(state, mu[0], cfg.units)))
    return state, msre, n_mf


def dbm_epoch_reference(cfg, state, X_batches, lr, momentum, seed, iter0):
    """The plain PyTorch version of the epoch (see module docstring), on
    the device of its inputs."""
    NB = X_batches.shape[0]
    rows = torch.zeros((2, NB), dtype=X_batches.dtype,
                       device=X_batches.device)
    for i in range(NB):
        state, msre, n_mf = dbm_step(cfg, state, X_batches[i], lr, momentum,
                                     seed, int(iter0) + i + 1)
        dbm_epoch.sweeps['mf_sweeps_enqueued'] += n_mf
        rows[0, i] = msre
        rows[1, i] = n_mf
    return state, rows[0], rows[1]


def _dbm_sample_plain(cfg, state, n_steps, seed, reference):
    v, H = state['v'], state['H']
    W, vb, hb = state['W'], state['vb'], state['hb']
    for s in range(int(n_steps)):
        v, H = gibbs_sweep(W, vb, hb, v, H, _sample_draw(cfg, seed, s,
                                                         reference),
                           cfg.units)
    v_means, _ = gibbs_sweep(W, vb, hb, v, H, units=cfg.units)
    return dict(state, v=v_means, H=tuple(H)), v_means


def dbm_sample_reference(cfg, state, n_steps, seed):
    """The plain PyTorch version of the sampler (JAX ``_sample_v_program``,
    dbm.py:1027-1039): sweep ``s`` of an all-Bernoulli DBM draws from key
    (`seed`, `s`), layer l on stream l; a DBM with Gaussian or multinomial
    layers under ``draw_key(seed, s, s, l)``."""
    return _dbm_sample_plain(cfg, state, n_steps, seed, True)


def ais_schedule(ladder):
    """(n_betas, 3) float32 array: row ``j - 1`` holds the beta of the
    transition that makes x_j and the pair (beta_lo, beta_hi) at which
    log p~(x_j) is subtracted, then added.  `ladder` is n_betas, the linear
    ladder in float32 exactly as the JAX kernel computes it: delta = f32(1 /
    n_betas), beta_i = f32(i) delta, transition at beta_i + delta, and the
    last beta_hi is 1 (so these differ from ``make_beta_schedule``'s float64
    linspace by rounding); or a float64 ladder b_0, ..., b_n, whose row
    ``j - 1`` is (b_j, b_{j-1}, b_j) rounded to float32 (a descending one
    is the reverse run's)."""
    if np.ndim(ladder):
        b = np.asarray(ladder, dtype=np.float64).astype(np.float32)
        return np.stack([b[1:], b[:-1], b[1:]], axis=1)
    M = int(ladder)
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


def _ais_rows(cfg, reverse=False):
    """The schedule of `cfg`'s forward run, or of its reverse run (its
    ladder descending, the linear one as the float64 linspace, as the JAX
    package's ``_reverse_ais_program`` takes it)."""
    if not reverse:
        return ais_schedule(cfg.n_betas if cfg.ladder is None
                            else cfg.ladder)
    ladder = np.linspace(0., 1., cfg.n_betas + 1) if cfg.ladder is None \
        else np.asarray(cfg.ladder, dtype=np.float64)
    return ais_schedule(ladder[::-1])


def ais_log_p(x, beta, W0, W1, vb, hb0, hb1, b0=None):
    """log p~_beta(h1 = x) with v and h2 summed out (JAX
    ``_ais_unnorm_log_prob_h1``, dbm.py:1042-1055), per run; a base rate
    `b0` adds (1 - beta) x.b0."""
    lp = beta * (x @ hb0)
    if b0 is not None:
        lp = lp + (1. - beta) * (x @ b0)
    lp = lp + torch.sum(F.softplus(beta * (x @ W0.T + vb)), dim=1)
    return lp + torch.sum(F.softplus(beta * (x @ W1 + hb1)), dim=1)


def ais_transition(x, beta, k, W0, W1, vb, hb0, hb1, draw=None, b0=None):
    """k-step tempered Gibbs transition on h1 (JAX ``_ais_transition``,
    dbm.py:1057-1078); ``draw(means, step, group)`` samples.  With a base
    rate `b0` the h1 bias is beta hb0 + (1 - beta) b0."""
    if draw is None:
        def draw(p, *_):
            return p
    bias = beta * hb0 if b0 is None else beta * hb0 + (1. - beta) * b0
    for s in range(k):
        v = draw(torch.sigmoid(beta * (x @ W0.T) + beta * vb), s, AIS_V)
        h2 = draw(torch.sigmoid(beta * (x @ W1) + beta * hb1), s, AIS_H2)
        T = v @ W0 + h2 @ W1.T
        x = draw(torch.sigmoid(beta * T + bias), s, AIS_H1)
    return x


def _ais_draw(cfg, seed, j):
    """``draw`` of the transitions keyed (`seed`, `j`), as the kernels
    draw them."""
    on = {AIS_V: cfg.sample_v, AIS_H2: cfg.sample_h1, AIS_H1: cfg.sample_h0}

    def draw(p, s, g):
        return bernoulli(p, seed, j, stream_ais(s, g)) if on[g] else p
    return draw


def _ais_params(state):
    (W0, W1), (hb0, hb1), vb = state['W'], state['hb'], state['vb']
    return W0, W1, vb, hb0, hb1


def ais_reference(cfg, state, seed, x0, b0=None):
    """The plain PyTorch version of the AIS sweep, in the JAX kernel's
    order: x1 = T(x0, beta_1), log_w = -log p~(x1, 0); then per beta
    log_w += log p~(x, beta_i), x <- T(x, beta_{i+1}),
    log_w -= log p~(x, beta_i); finally log_w += log p~(x, 1).  The
    transition of beta j draws from key (`seed`, j).  `b0`: the base rate,
    or None for the uniform base."""
    params = _ais_params(state)
    log_w = torch.zeros(x0.shape[0], dtype=x0.dtype, device=x0.device)
    x = x0
    for j, (beta_t, beta_lo, beta_hi) in enumerate(_ais_rows(cfg).tolist(),
                                                   start=1):
        x = ais_transition(x, beta_t, cfg.k, *params,
                           _ais_draw(cfg, seed, j), b0)
        log_w = log_w - ais_log_p(x, beta_lo, *params, b0)
        log_w = log_w + ais_log_p(x, beta_hi, *params, b0)
    return log_w


def reverse_ais_reference(cfg, state, seed, x0, b0=None):
    """The plain PyTorch version of the reverse run of BDMC (JAX
    ``_reverse_ais_program``, dbm.py:1137-1180): from (approximate) model
    samples `x0`, along the ladder g descending from 1 to 0, step j does
    w += log p~(x, g_j) - log p~(x, g_{j-1}), then x <- T(x, g_j) with the
    draws of key (`seed`, j).  log Z0 - log mean exp(w) is a stochastic
    upper bound on log Z."""
    params = _ais_params(state)
    w = torch.zeros(x0.shape[0], dtype=x0.dtype, device=x0.device)
    x = x0
    for j, (g_next, g, _) in enumerate(_ais_rows(cfg, True).tolist(),
                                       start=1):
        w = w + ais_log_p(x, g_next, *params, b0) - \
            ais_log_p(x, g, *params, b0)
        x = ais_transition(x, g_next, cfg.k, *params,
                           _ais_draw(cfg, seed, j), b0)
    return w


def ais_burn_in_reference(cfg, state, seed, x0, n_steps):
    """The plain version of the BDMC start's burn-in (JAX
    ``_model_h1_samples``, dbm.py:1182-1196): `n_steps` tempered Gibbs
    steps on h1 at beta = 1, the draws of key (`seed`, 0)."""
    return ais_transition(x0, 1., int(n_steps), *_ais_params(state),
                          _ais_draw(cfg, seed, 0))


def tile_h1(H0, n_runs, binarize):
    """The start of the reverse run: the particles' h1 rows tiled to
    `n_runs`, states above 0.5 where `binarize` (JAX dbm.py:1188-1193)."""
    reps = -(-int(n_runs) // H0.shape[0])
    x0 = H0.repeat(reps, 1)[:int(n_runs)]
    return (x0 > 0.5).to(x0.dtype) if binarize else x0.clone()


def dbm_mesh_epoch(cfg, state, X_batches, lr, momentum, seed, iter0, N, M,
                   reduce_sum, reduce_max):
    """One rank's epoch of a data-parallel mesh (JAX
    ``_shardmap_epoch_core``, dbm.py:648-700).  `X_batches` holds the rank's
    rows of every full batch and state's v and H its rows of the particles;
    `reduce_sum` / `reduce_max` take a tensor to its sum / max over the
    ranks in place.  Per minibatch ``it = iter0 + i + 1``: mean-field on the
    local rows, each sweep's change reduced to the ranks' max; `k` sampled
    sweeps of the local particles, each layer drawn by the standalone
    samplers (their kernels on CUDA tensors) under ``draw_key(seed, it,
    sweep, layer)`` -- `seed` is the rank's; the raw sums (``dbm_sums``) in
    one buffer, summed over the ranks; the update with the whole batch's N
    and the whole chain's M, the same on every rank.  Returns (state, the
    local rows' sums of squared reconstruction errors, n_mf rows)."""
    L = len(cfg.layer_sizes) - 1
    units = cfg.units if cfg.units is not None else (None,) * (L + 1)
    NB = X_batches.shape[0]
    sq = torch.zeros(NB, dtype=X_batches.dtype, device=X_batches.device)
    n_mf_rows = torch.zeros_like(sq)
    for i in range(NB):
        X, it = X_batches[i], int(iter0) + i + 1
        mu, n_mf = mean_field(X, state['W'], state['hb'], cfg.max_mf_updates,
                              cfg.mf_tol, cfg.units, reduce_max)
        dbm_epoch.sweeps['mf_sweeps_enqueued'] += n_mf
        v, H = state['v'], state['H']
        for s in range(cfg.k):
            draw = unit_draw(units, cfg.sample_v, cfg.sample_h,
                             lambda l, s=s: draw_key(seed, it, s, l))
            v, H = gibbs_sweep(state['W'], state['vb'], state['hb'], v, H,
                               draw, cfg.units)
        flat, view = flatten_sums(dbm_sums(X, mu, v, H))
        reduce_sum(flat)
        state = apply_dbm_update(cfg, state, view(flat), N, M, v, H, lr,
                                 momentum)
        sq[i] = torch.sum(torch.square(
            X - reconstruction_means(state, mu[0], cfg.units)))
        n_mf_rows[i] = n_mf
    return state, sq, n_mf_rows


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
#: the sweeps of one turn of the mean-field graph's WHILE node (the
#: `body` of bm_dbm_mf_graph_create): a turn costs a check launch and the
#: node's turn, a sweep after the stop a launch's floor a layer
MF_BODY_SWEEPS = 4
#: the mean-field control words ahead of a turn's change words (kMfChange):
#: the stop word and n_mf (word 1, which dbm_msre reads); the graph's turn
#: count follows the change words
MF_CHANGE_WORD = 2


class GemmArgs(ctypes.Structure):
    """The ``GemmArgs`` struct of csrc/dbm_ops.cu (same field order)."""
    _fields_ = (
        [(n, _P) for n in ('a1', 'b1', 'a2', 'b2', 'c', 'bias', 'out',
                           'delta_bits', 'ws', 'counters')] +
        [(n, _L) for n in ('sam1', 'sak1', 'sbk1', 'sbn1',
                           'sam2', 'sak2', 'sbk2', 'sbn2')] +
        [(n, _I) for n in ('k1', 'k2', 'M', 'N', 'act', 'sample', 'n_tile',
                           'splits')] +
        [(n, _F) for n in ('alpha', 'alpha2', 'gamma')] +
        [(n, _U) for n in ('seed', 'it', 'stream_id')] +
        [('bias2', _P), ('gamma2', _F), ('sigma', _P)])


class SoftmaxArgs(ctypes.Structure):
    """The ``SoftmaxArgs`` struct of csrc/dbm_ops.cu (same field order): one
    ``dbm_softmax`` launch, the rows of a multinomial layer."""
    _fields_ = ([(n, _P) for n in ('pre', 'out', 'delta_bits', 'mf')] +
                [(n, _I) for n in ('rows', 'H', 'n', 'sample')] +
                [(n, _U) for n in ('seed', 'it', 'stream_id')])


class AisLogw(ctypes.Structure):
    """The ``AisLogw`` struct of csrc/dbm_ops.cu (same field order): the
    log-weight update of one AIS beta."""
    _fields_ = ([(n, _P) for n in ('x', 'hb0', 'part_v', 'part_h2',
                                   'log_w')] +
                [(n, _I) for n in ('R', 'H1', 'nblk_v', 'nblk_h2')] +
                [(n, _F) for n in ('beta_lo', 'beta_hi')] + [('b0', _P)])


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
    'bm_dbm_mf_graph_create': [ctypes.POINTER(GemmArgs), _I, _P, _F, _I,
                               _I, ctypes.POINTER(SoftmaxArgs),
                               ctypes.POINTER(_P)],
    'bm_dbm_softmax': [ctypes.POINTER(SoftmaxArgs), _P],
    'bm_dbm_mf_graph_launch': [_P, _P],
    'bm_dbm_mf_graph_destroy': [_P],
    'bm_dbm_bias_update': [ctypes.POINTER(BiasVec), _I, _I, _I, _F, _F, _F,
                           _F, _P],
    'bm_dbm_assoc_update': [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _F,
                            _F, _F, _I, _P],
    'bm_dbm_max_norm': [_P, _I, _I, _F, _P],
    'bm_dbm_msre': [_P, _P, _L, _P, _P, _I, _P, _P, _P, _P],
    'bm_ais_logw': [_P, _P, _I, _I, _P, _I, _P, _I, _F, _F, _P, _P, _P],
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


def _stream(device):
    """torch's current stream on the CUDA `device`, as a handle."""
    return torch.cuda.current_stream(device).cuda_stream


def count_mf_graph(n_mf, body=None):
    """The turns of the mean-field graph's WHILE node behind steps whose
    n_mf rows are `n_mf` (host numbers), at `body` sweeps a turn
    (``MF_BODY_SWEEPS`` where None): a turn ends where mean-field stopped,
    so a step runs ceil(n_mf / body).  What the graph's turn count should
    read; the host counts the graph's kernels from the count itself."""
    body = MF_BODY_SWEEPS if body is None else int(body)
    n = np.rint(np.asarray(n_mf, dtype=np.float64)).astype(np.int64)
    return int((-(-n // body)).sum())


def mf_graph_launches(turns, n_layers, n_rows=0, body=None):
    """The kernels that `turns` turns of the mean-field graph run, by
    ``dbm_epoch.launches``' names: a turn is `body` sweeps
    (``MF_BODY_SWEEPS`` where None) of `n_layers` ``dbm_gemm_act``
    launches and `n_rows` ``dbm_softmax`` launches (one a multinomial
    layer, after its product), then one ``dbm_mf_check``."""
    body = MF_BODY_SWEEPS if body is None else int(body)
    return {'dbm_gemm_act': n_layers * body * turns,
            'dbm_softmax': n_rows * body * turns, 'dbm_mf_check': turns}


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


def _count_stages(args, launches=1):
    """Count `launches` dbm_gemm_act launches of `args` (a ``GemmArgs``) in
    ``gemm.tile_stages``: both products' k-tiles over the plan's slices."""
    k_tiles = sum(-(-int(k) // TILE_K) for k in (args.k1, args.k2))
    count_stages('gemm_act', k_tiles, args.splits, launches)


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


def _softmax_args(pre, out, n_samples):
    """One ``dbm_softmax`` launch: the n softmax means of `pre`'s rows
    into `out`, neither sampled nor folding a change (the caller sets
    that)."""
    a = SoftmaxArgs()
    a.pre, a.out = pre.data_ptr(), out.data_ptr()
    a.rows, a.H = int(out.shape[0]), int(out.shape[1])
    a.n = int(n_samples)
    return a


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
    stream = _stream(dev)
    n_tiles = [assoc_plan(sizes[l], hs[l], num_sms(dev)).n_tile
               for l in range(L)]
    # the epoch updates copies of the state in place, batch after batch
    s = _clone_state(state)
    W, hb, H = s['W'], s['hb'], s['H']

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    # each hidden layer's multinomial n (0: Bernoulli) and, for a
    # multinomial layer, the pre-activations of its mean-field and Gibbs
    # products, which dbm_softmax reads; a Gaussian visible layer's sigma
    n_of = [u.n_samples if isinstance(u, MultinomialLayer) else 0
            for u in _hidden_units(cfg.units, L)]
    pre_mf = [empty(B, h) if n else None for h, n in zip(hs, n_of)]
    pre_gibbs = [empty(M, h) if n else None for h, n in zip(hs, n_of)]
    v_unit = None if cfg.units is None else cfg.units[0]
    sigma = torch.as_tensor(v_unit.sigma, dtype=torch.float32).expand(
        V).contiguous().to(dev) if isinstance(v_unit, GaussianLayer) else None

    T0 = empty(B, hs[0])
    mu = [empty(B, h) for h in hs]
    pen = [empty(h) for h in hs]
    v_means = empty(B, V)
    # the mean-field loop's control words (csrc/dbm_ops.cu kMfStop): the
    # stop word, n_mf, each sweep's max |change| of a turn as float bits,
    # which the graph zeroes at each launch, then its turns of the call
    body = MF_BODY_SWEEPS
    ctrl = torch.zeros(MF_CHANGE_WORD + body + 1, dtype=torch.int32,
                       device=dev)
    # dbm_msre's block sums and its last-block counter (re-armed by it)
    msre_part = empty(MSRE_BLOCKS)
    msre_count = torch.zeros(1, dtype=torch.int32, device=dev)
    rows = torch.zeros((2, NB), dtype=torch.float32, device=dev)
    lr, mom = float(lr), float(momentum)
    one_minus_damp = float(1. - torch.tensor(cfg.sparsity_damping,
                                             dtype=torch.float32))
    tol = float(np.float32(cfg.mf_tol))

    def launch(args):
        if isinstance(args, SoftmaxArgs):
            _check(lib.bm_dbm_softmax(ctypes.byref(args), stream),
                   'dbm_softmax')
            launches['dbm_softmax'] += 1
            return
        _check(lib.bm_dbm_gemm_act(ctypes.byref(args), stream),
               'dbm_gemm_act')
        launches['dbm_gemm_act'] += 1
        _count_stages(args)

    def layer(out, l, A, pre, **kw):
        """The launches that update hidden layer l into `out`: one
        dbm_gemm_act, or for a multinomial layer an identity one into
        `pre` and its dbm_softmax."""
        if not n_of[l]:
            return [_gemm_args(out, A, bias=hb[l], stream=stream, **kw)]
        kw.pop('act', None)
        return [_gemm_args(pre, A, bias=hb[l], act=ACT_IDENTITY,
                           stream=stream, **kw),
                _softmax_args(pre, out, n_of[l])]

    # launch arguments shared by every minibatch (X's pointer and the
    # iteration are set per minibatch)
    t0_args = _gemm_args(T0, [(X_batches[0], W[0], False)], act=ACT_IDENTITY,
                         stream=stream)
    # mean-field init: act(2 X.W0 + hb0) doubles the product only, and so
    # does every layer below the top
    init_args = layer(mu[0], 0, [], pre_mf[0], c=T0, alpha=2.)
    for l in range(1, L):
        init_args += layer(mu[l], l, [(mu[l - 1], W[l], False)], pre_mf[l],
                           alpha=2. if l < L - 1 else 1.)
    sweep = (GemmArgs * L)()
    sweep_rows = (SoftmaxArgs * L)() if any(n_of) else None
    for l in range(L):
        A = [(mu[l - 1], W[l], False)] if l else []
        if l + 1 < L:
            A.append((mu[l + 1], W[l + 1], True))
        launched = layer(mu[l], l, A, pre_mf[l], c=T0 if l == 0 else None,
                         act=ACT_SIGMOID_DELTA)
        sweep[l] = launched[0]
        if n_of[l]:
            sweep_rows[l] = launched[1]
    gibbs = []
    for step in range(cfg.k):
        for l in range(L + 1):
            if l == L:
                a = _gemm_args(s['v'], [(H[0], W[0], True)], bias=s['vb'],
                               stream=stream)
                a.sigma = _ptr(sigma)
                launched, on = [a], cfg.sample_v
            else:
                A = [(s['v'], W[0], False)] if l == 0 else \
                    [(H[l - 1], W[l], False)]
                if l + 1 < L:
                    A.append((H[l + 1], W[l + 1], True))
                launched, on = layer(H[l], l, A, pre_gibbs[l]), \
                    cfg.sample_h[l]
            # the draws: the last launch of the layer's
            a = launched[-1]
            a.sample, a.seed = int(on), int(seed)
            a.stream_id = stream_dbm(step, l, L)
            gibbs += launched
    recon_args = _gemm_args(v_means, [(mu[0], W[0], True)], bias=s['vb'],
                            stream=stream)
    recon_args.sigma = _ptr(sigma)
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
    # the mean-field loop as a CUDA graph over the sweep's buffers, fixed
    # for the call
    graph = _P()
    _check(lib.bm_dbm_mf_graph_create(sweep, L, ctrl.data_ptr(), tol,
                                      cfg.max_mf_updates, body, sweep_rows,
                                      ctypes.byref(graph)),
           'dbm_mf_graph_create')

    for i in range(NB):
        X = X_batches[i]
        it = int(iter0) + i + 1
        t0_args.a1 = X.data_ptr()
        launch(t0_args)
        for a in init_args:
            launch(a)
        # the mean-field loop on the device: the graph runs turns of sweeps
        # until mean-field stops or the budget ran out; its kernels count
        # after the last step, from its turns
        _check(lib.bm_dbm_mf_graph_launch(graph, stream),
               'dbm_mf_graph_launch')
        dbm_epoch.graph_launches += 1
        dbm_epoch.sweeps['mf_sweeps_enqueued'] += cfg.max_mf_updates
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
                cfg.l2, n_tiles[l], stream), 'dbm_assoc_update')
            launches['dbm_assoc_update'] += 1
            count_stages('assoc', assoc_k_tiles(B, M), 1)
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
    # the graph's turns, read once the stream has passed its last launch
    turns = int(ctrl[MF_CHANGE_WORD + body])
    for name, n in mf_graph_launches(turns, L, sum(map(bool, n_of)),
                                     body).items():
        launches[name] += n
    for l in range(L):
        _count_stages(sweep[l], turns * body)
    _check(lib.bm_dbm_mf_graph_destroy(graph), 'dbm_mf_graph_destroy')
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
            _count_stages(a)
    h0_means = torch.empty((M, hs[0]), dtype=torch.float32, device=dev)
    for a in (layer_args(0, h0_means),
              _gemm_args(v, [(h0_means, W[0], True)], bias=vb,
                         stream=stream)):
        _check(lib.bm_dbm_gemm_act(ctypes.byref(a), stream), 'dbm_gemm_act')
        launches['dbm_gemm_act'] += 1
        _count_stages(a)
    return dict(state, v=v, H=H), v


def _ais_setup(cfg, state, x0, b0):
    """Validate the inputs of an AIS launch sequence; returns the library,
    the stream, the parameters and the buffers x (a copy of `x0`), v, h2."""
    V, H1, H2 = cfg.n_visible, cfg.n_h1, cfg.n_h2
    dev = x0.device
    if x0.dim() != 2 or x0.shape[1] != H1 or x0.shape[0] < 1:
        raise ValueError('x0 must be (n_runs, {0}), got {1}'.format(
            H1, tuple(x0.shape)))
    R = int(x0.shape[0])
    if len(state['W']) != 2:
        raise ValueError('AIS needs a 2-layer DBM')
    _validate([('x0', x0, (R, H1))] +
              _state_specs(state, (V, H1, H2), 1, ('vb', 'hb', 'W')) +
              ([] if b0 is None else [('b0', b0, (H1,))]), dev)
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    return (lib, stream, _ais_params(state), x0.clone(), empty(R, V),
            empty(R, H2))


def _transition_args(cfg, k, params, x, v, h2, b0, seed, stream):
    """The 3 k launches of a k-step transition (v, h2, then h1 of each
    step), its betas set by ``_set_beta``; with a base rate, the h1
    launches' second bias is b0."""
    W0, W1, vb, hb0, hb1 = params
    trans = []
    for step in range(k):
        for out, A, bias, g, on in (
                (v, [(x, W0, True)], vb, AIS_V, cfg.sample_v),
                (h2, [(x, W1, False)], hb1, AIS_H2, cfg.sample_h1),
                (x, [(v, W0, False), (h2, W1, True)], hb0, AIS_H1,
                 cfg.sample_h0)):
            a = _gemm_args(out, A, bias=bias, stream=stream)
            a.sample, a.seed = int(on), int(seed)
            a.stream_id = stream_ais(step, g)
            if g == AIS_H1 and b0 is not None:
                a.bias2 = b0.data_ptr()
            trans.append(a)
    return trans


def _set_beta(trans, beta, it):
    """A transition at `beta`, its draws keyed by iteration `it`:
    sigmoid(beta (product + bias) [+ (1 - beta) b0])."""
    for a in trans:
        a.alpha = a.gamma = beta
        a.gamma2 = 1. - beta
        a.it = it


def _ais_cuda(cfg, state, seed, x0, b0=None, reverse=False):
    """Launch the kernels of ``csrc/dbm_ops.cu``: per beta, 3 per Gibbs step
    of the transition and 2 for the pair of log p~ evaluations (GEMMs with
    softplus row sums at beta_lo and beta_hi).  Each pair's log-weight
    update rides on the launch after it, which reads x and writes v (or a
    softplus row pair, at k = 0): in the forward run the next beta's first
    launch, and one ``ais_logw`` launch applies the last beta's; in the
    reverse run (`reverse`: the pair before the transition) its own
    transition's first launch, so no ``ais_logw`` launch but at k = 0."""
    V, H1, H2 = cfg.n_visible, cfg.n_h1, cfg.n_h2
    lib, stream, params, x, v, h2 = _ais_setup(cfg, state, x0, b0)
    W0, W1, vb, hb0, hb1 = params
    R, dev = int(x0.shape[0]), x0.device
    rows = _ais_rows(cfg, reverse)
    _check_seed(seed, len(rows))
    launches = ais.launches
    nblk_v = lib.bm_dbm_gemm_col_blocks(V)
    nblk_h2 = lib.bm_dbm_gemm_col_blocks(H2)
    # the softplus partials of beta j in set j % 2: beta j + 1's launches
    # write the other set while the first of them reads beta j's
    part_v = torch.empty((2, 2 * R * nblk_v), dtype=torch.float32,
                         device=dev)
    part_h2 = torch.empty((2, 2 * R * nblk_h2), dtype=torch.float32,
                          device=dev)
    log_w = torch.zeros(R, dtype=torch.float32, device=dev)
    trans = _transition_args(cfg, cfg.k, params, x, v, h2, b0, seed, stream)
    # softplus(beta (x.W0^T + vb)) and softplus(beta (x.W1 + hb1)), row sums
    # at both betas of the pair from one product each
    lp_v = _gemm_args(v, [(x, W0, True)], bias=vb, act=ACT_SOFTPLUS_ROWS,
                      stream=stream)
    lp_h2 = _gemm_args(h2, [(x, W1, False)], bias=hb1, act=ACT_SOFTPLUS_ROWS,
                       stream=stream)
    pending = None  # the update of the last pair
    for j, (beta_t, beta_lo, beta_hi) in enumerate(rows.tolist(), start=1):
        _set_beta(trans, beta_t, j)
        for a in (lp_v, lp_h2):
            a.alpha, a.alpha2 = beta_lo, beta_hi
        lp_v.out, lp_h2.out = part_v[j % 2].data_ptr(), \
            part_h2[j % 2].data_ptr()
        # None: the pair's update is pending from here
        seq = [lp_v, lp_h2, None] + trans if reverse \
            else trans + [lp_v, lp_h2, None]
        for a in seq:
            if a is None:
                pending = AisLogw(_ptr(x), _ptr(hb0), part_v[j % 2].data_ptr(),
                                  part_h2[j % 2].data_ptr(), _ptr(log_w), R,
                                  H1, nblk_v, nblk_h2, beta_lo, beta_hi,
                                  _ptr(b0))
                continue
            if pending is None:
                _check(lib.bm_dbm_gemm_act(ctypes.byref(a), stream),
                       'dbm_gemm_act')
            else:
                _check(lib.bm_ais_gemm_act(ctypes.byref(a),
                                           ctypes.byref(pending), stream),
                       'dbm_gemm_act')
                pending = None
            launches['dbm_gemm_act'] += 1
            _count_stages(a)
    if pending is not None:
        p = pending
        _check(lib.bm_ais_logw(p.x, p.hb0, R, H1, p.part_v, nblk_v,
                               p.part_h2, nblk_h2, p.beta_lo, p.beta_hi,
                               p.log_w, p.b0, stream), 'ais_logw')
        launches['ais_logw'] += 1
    return log_w


def _ais_burn_in_cuda(cfg, state, seed, x0, n_steps):
    """The burn-in's 3 `n_steps` transition launches at beta = 1."""
    lib, stream, params, x, v, h2 = _ais_setup(cfg, state, x0, None)
    _check_seed(seed, 0)
    trans = _transition_args(cfg, int(n_steps), params, x, v, h2, None, seed,
                             stream)
    _set_beta(trans, 1., 0)
    for a in trans:
        _check(lib.bm_dbm_gemm_act(ctypes.byref(a), stream), 'dbm_gemm_act')
        ais.launches['dbm_gemm_act'] += 1
        _count_stages(a)
    return x


# ---------------------------------------------------------------------- #
# wrappers                                                                #
# ---------------------------------------------------------------------- #
def _route(device, name):
    if device.type in ('cuda', 'cpu'):
        return device.type
    raise ValueError('{0} runs on CUDA (kernels) or the CPU (plain version), '
                     'not on {1}'.format(name, device))


def dbm_epoch(cfg, state, X_batches, lr, momentum, seed, iter0):
    """One PCD / mean-field DBM epoch: the CUDA kernels for a CUDA tensor
    of a DBM they take (``kernel_units``), the plain version otherwise, on
    the device of the inputs."""
    if _route(X_batches.device, 'dbm_epoch') == 'cuda' and \
            kernel_units(cfg.units):
        return _dbm_epoch_cuda(cfg, state, X_batches, lr, momentum, seed,
                               iter0)
    return dbm_epoch_reference(cfg, state, X_batches, lr, momentum, seed,
                               iter0)


def dbm_sample(cfg, state, n_steps, seed):
    """The particle sampler: the CUDA kernels for CUDA particles, the plain
    version for CPU particles; a DBM with Gaussian or multinomial layers
    as ``dbm_epoch`` runs it."""
    if _route(state['v'].device, 'dbm_sample') == 'cpu':
        return dbm_sample_reference(cfg, state, n_steps, seed)
    if all_bernoulli(cfg.units):
        return _dbm_sample_cuda(cfg, state, n_steps, seed)
    return _dbm_sample_plain(cfg, state, n_steps, seed, False)


def ais(cfg, state, seed, x0, b0=None):
    """The AIS sweep: the CUDA kernels for a CUDA `x0`, the plain version
    for a CPU one.  `b0`: a base rate (H1,), or None."""
    if _route(x0.device, 'ais') == 'cuda':
        return _ais_cuda(cfg, state, seed, x0, b0)
    return ais_reference(cfg, state, seed, x0, b0)


def reverse_ais(cfg, state, seed, x0, b0=None):
    """The reverse run of BDMC on the AIS kernels (a CUDA `x0`) or its
    plain version (a CPU one); its launches count in ``ais.launches``."""
    if _route(x0.device, 'reverse_ais') == 'cuda':
        return _ais_cuda(cfg, state, seed, x0, b0, reverse=True)
    return reverse_ais_reference(cfg, state, seed, x0, b0)


def ais_burn_in(cfg, state, seed, x0, n_steps):
    """The BDMC start's burn-in on the AIS kernels' transition launches (a
    CUDA `x0`) or its plain version (a CPU one); its launches count in
    ``ais.launches``."""
    if _route(x0.device, 'ais_burn_in') == 'cuda':
        return _ais_burn_in_cuda(cfg, state, seed, x0, n_steps)
    return ais_burn_in_reference(cfg, state, seed, x0, n_steps)


dbm_epoch.launches = dict.fromkeys(EPOCH_KERNELS, 0)
dbm_sample.launches = dict.fromkeys(SAMPLE_KERNELS, 0)
ais.launches = dict.fromkeys(AIS_KERNELS, 0)
dbm_epoch.graph_launches = 0
dbm_epoch.sweeps = dict.fromkeys(SWEEP_COUNTS, 0)
dbm_epoch.profiled_sweeps = dict.fromkeys(PROFILED_COUNTS, 0)


def reset_launches():
    """Zero every launch count, the graph's launches and the sweep counts
    beside them, and the tile's k-tile counts (``gemm.tile_stages``)."""
    reset_stages()
    for fn in (dbm_epoch, dbm_sample, ais):
        for name in fn.launches:
            fn.launches[name] = 0
    dbm_epoch.graph_launches = 0
    for counts in (dbm_epoch.sweeps, dbm_epoch.profiled_sweeps):
        for name in counts:
            counts[name] = 0
