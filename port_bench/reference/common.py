"""What the plain references share: the program's seed plumbing (a frozen
copy), the precisions a reference computes in, Bernoulli draws on the
program's uniforms, and the numbers that decide ``correct``.

Precisions: ``float64`` is the reference that judges; ``float32`` is the
program's stated precision (a fault planted in the reference runs in it);
``tf32`` is the control, the nearest precision below float32 with TF32
off: every product's operands rounded to TF32 (10 mantissa bits, to
nearest even) and accumulated in float32, as the tensor cores' TF32 mode
computes, on any device.
"""

import math

import numpy as np
import torch

from . import philox

#: a draw whose uniform lies within this of its float64 mean is a tie to
#: rounding: the program, in float32, may take either side.  The program's
#: means differ from float64's by under 3e-7 (float32 products of at most
#: 1024 terms); TF32's by ~1e-5.
TIE_BAND = 2e-6
#: leaves whose step-1 gradient norm in the reference is under this share
#: of the median leaf's are left out (moved by round-off alone)
NOUGHT_SHARE = 1e-3


# ---- the program's seed plumbing (frozen copy) -------------------------
def op_seeds(random_seed, n):
    """The first `n` op seeds a model of `random_seed` draws from its host
    RNG (numpy's RandomState, ``randint(2**31 - 1)``)."""
    rng = np.random.RandomState(random_seed)
    return [int(rng.randint(2 ** 31 - 1)) for _ in range(n)]


def derive_seed(seed, salt):
    ss = np.random.SeedSequence([int(seed), int(salt)])
    return int(ss.generate_state(1, np.uint32)[0]) & 0x7FFFFFFF


def schedule_value(schedule, epoch):
    return schedule[min(epoch, len(schedule) - 1)]


# ---- precision -----------------------------------------------------------
def to_tf32(x):
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


class Precision(object):
    def __init__(self, name):
        if name not in ('float64', 'float32', 'tf32'):
            raise ValueError('precision {0!r}'.format(name))
        self.name = name
        self.dtype = torch.float64 if name == 'float64' else torch.float32

    def mm(self, a, b):
        if self.name == 'tf32':
            a, b = to_tf32(a), to_tf32(b)
        return a @ b

    def tensor(self, x, device):
        return torch.as_tensor(np.asarray(x), device=device).to(self.dtype)


# ---- draws -----------------------------------------------------------------
class Draws(object):
    """Bernoulli states ``u < p`` on the program's Philox uniforms.  Every
    draw whose uniform lies within TIE_BAND of its mean is recorded in
    ``ties`` as (tag, flat index); the draws named in `flips` take the
    other side.  A reference with mean-field appends each step's sweeps to
    ``sweeps``."""

    def __init__(self, flips=()):
        self.flips = frozenset(flips)
        self.ties = []
        self.sweeps = []

    def bernoulli(self, p, seed, it, stream, tag):
        u = philox.uniform(seed, it, stream, p.shape, p.device).to(p.dtype)
        states = (u < p).reshape(-1)
        near = torch.nonzero((torch.abs(u - p) < TIE_BAND).reshape(-1))
        self.ties.extend((tag, int(j)) for j in near.flatten().tolist())
        mine = [j for t, j in self.flips if t == tag]
        if mine:
            idx = torch.tensor(mine, device=p.device)
            states[idx] = ~states[idx]
        return states.reshape(p.shape).to(p.dtype)


def distance(prog, ref):
    """Sum over the state's leaves of |prog - ref|^2 / |ref|^2."""
    total = 0.
    for k, r in ref.items():
        d = float(torch.sum((prog[k].to(r.dtype) - r) ** 2))
        total += d / max(float(torch.sum(r * r)), 1e-30)
    return total


def follow(run, target, max_runs=64):
    """The reference's state after the steps `run(draws)` computes, with
    each tie to rounding taken on the side that the program's state
    `target` shows: starting from float64's sides, flip the tie that
    brings the state closest to the target while one does.  Returns (state,
    the Draws of the run that gave it)."""
    flips = frozenset()
    draws = Draws(flips)
    state = run(draws)
    best = distance(target, state)
    runs = 1
    while runs < max_runs:
        trial = None
        for site in draws.ties:
            if site in flips or runs >= max_runs:
                continue
            d = Draws(flips | {site})
            s = run(d)
            runs += 1
            dist = distance(target, s)
            if dist < best and (trial is None or dist < trial[0]):
                trial = (dist, site, s, d)
        if trial is None:
            break
        best, site, state, draws = trial
        flips = flips | {site}
    return state, draws


# ---- the numbers -----------------------------------------------------------
def _worst(x):
    return x if math.isfinite(x) else math.inf


def _norm(t):
    return float(torch.linalg.vector_norm(t.to(torch.float64)))


def leaf_numbers(prog, ref, grad_ref):
    """(gap of norms, norm of the difference) of the worst leaf, each over
    the larger of the reference's norm of that leaf and of the median
    leaf; leaves whose reference gradient (`grad_ref`) is nought to
    rounding are left out."""
    gnorms = {k: _norm(v) for k, v in grad_ref.items()}
    gmed = float(np.median(list(gnorms.values())))
    keep = [k for k in ref if gnorms[k] >= NOUGHT_SHARE * gmed]
    norms = {k: _norm(ref[k]) for k in keep}
    med = float(np.median(list(norms.values())))
    gap = diff = 0.
    for k in keep:
        scale = max(norms[k], med, 1e-30)
        p = prog[k].to(torch.float64)
        # a NaN reads as infinitely far, never as 0
        gap = max(gap, _worst(abs(_norm(p) - norms[k]) / scale))
        diff = max(diff, _worst(_norm(p - ref[k].to(torch.float64)) / scale))
    return gap, diff


def training_numbers(grads_prog, grads_ref, change_prog, change_ref):
    """The numbers of a training cell: ``grad_gap`` and ``grad_diff`` of
    the first step's gradient as the optimizer got it, ``change_gap`` of
    the parameters' change after three steps."""
    grad_gap, grad_diff = leaf_numbers(grads_prog, grads_ref, grads_ref)
    change_gap, _ = leaf_numbers(change_prog, change_ref, grads_ref)
    return {'grad_gap': grad_gap, 'change_gap': change_gap,
            'grad_diff': grad_diff}


# ---- a training cell's set-up steps ----------------------------------------
#: the set-up's two fit calls: (epoch, first global iteration, batches)
FITS = ((1, 1, 1), (2, 2, 2))


def config_of(inputs, fault):
    """The configuration the reference steps by: with `fault`
    'early_mean_field', mean-field stops a sweep early."""
    cfg = inputs['config']
    return dict(cfg, mf_stop_early=True) if fault == 'early_mean_field' \
        else cfg


def run_fit(family, state, inputs, fit, prec, draws, fault=None):
    """The steps of the set-up's fit call `fit` (0 or 1) from `state`, by
    the reference module `family`; `fault` 'half_batch' leaves out the
    second half of every batch."""
    cfg, B = config_of(inputs, fault), inputs['batch_size']
    epoch, it0, n = FITS[fit]
    seeds = op_seeds(inputs['random_seed'], 1 + len(FITS))
    seed = derive_seed(seeds[1 + fit], epoch)
    lr = float(schedule_value(inputs['learning_rate'], epoch))
    mom = float(schedule_value(inputs['momentum'], epoch))
    device = next(iter(state.values())).device
    rows = prec.tensor(inputs['rows'], device)
    for i in range(n):
        it = it0 + i
        X = rows[(it - 1) * B:it * B]
        if fault == 'half_batch':
            X = X[:B // 2]
        state = family.step(state, X, lr, mom, seed, it, cfg, prec, draws)
    return state


def as_program(family, inputs, device, precision, fault=None):
    """The snapshots (after the set-up's first and second fit call) of the
    reference `family` put in the program's place, at `precision`, with
    `fault` planted ('unchanged', 'half_batch', one of the family's
    EXTRA_FAULTS or None)."""
    prec = Precision(precision)
    s0 = family.initial_state(inputs, prec, device)
    if fault == 'unchanged':
        return s0, s0
    s1 = run_fit(family, s0, inputs, 0, prec, Draws(), fault)
    return s1, run_fit(family, s1, inputs, 1, prec, Draws(), fault)


def judge(family, inputs, snapshots, device):
    """The numbers of the program's snapshots (state dicts after the
    set-up's first and second fit call) against the float64 reference
    `family`, which takes each tie to rounding on the program's side."""
    prec = Precision('float64')
    s0 = family.initial_state(inputs, prec, device)
    p1, p3 = snapshots
    r1, d1 = follow(lambda d: run_fit(family, s0, inputs, 0, prec, d), p1)
    r3, d3 = follow(lambda d: run_fit(family, r1, inputs, 1, prec, d), p3)
    lr = float(schedule_value(inputs['learning_rate'], FITS[0][0]))
    grads = lambda s: {k: s[a] / lr for k, a in family.ACCUMULATORS.items()}
    change = lambda s: {k: s[k] - s0[k] for k in family.PARAMS}
    numbers = training_numbers(grads(p1), grads(r1), change(p3), change(r3))
    return numbers, {'ties_flipped': len(d1.flips) + len(d3.flips)}


# ---- the late check: steps from the state the window left --------------------
def as64(x, device):
    """A float64 tensor on `device` of a host array or a tensor."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float64)
    return torch.as_tensor(np.asarray(x), device=device).to(torch.float64)


def late_key(inputs, key):
    """(learning rate, momentum, seed of the epoch's draws) of a late step,
    from the fit call, epoch and step of its `key`."""
    seeds = op_seeds(inputs['random_seed'], 2 + key['fit'])
    seed = derive_seed(seeds[1 + key['fit']], key['epoch'])
    lr = float(schedule_value(inputs['learning_rate'], key['epoch']))
    mom = float(schedule_value(inputs['momentum'], key['epoch']))
    return lr, mom, seed


def late_step(family, state, inputs, key, prec, draws, fault=None):
    """The late step of `key` from `state`; `fault` 'half_batch' leaves out
    the second half of its batch."""
    lr, mom, seed = late_key(inputs, key)
    X = prec.tensor(key['rows'], next(iter(state.values())).device)
    if fault == 'half_batch':
        X = X[:X.shape[0] // 2]
    return family.step(state, X, lr, mom, seed, key['it'],
                       config_of(inputs, fault), prec, draws)


def late_as_program(family, inputs, pre, keys, device, precision,
                    fault=None):
    """The late steps of `keys` by the reference `family` put in the
    program's place from the program's state `pre`, at `precision`, with
    `fault` planted ('unchanged', 'half_batch' or None): [(state after
    the step, its key with the step's sweeps as ``n_mf``)]."""
    prec = Precision(precision)
    s = {k: prec.tensor(v, device) for k, v in pre.items()}
    out = []
    for key in keys:
        d = Draws()
        post = late_step(family, s, inputs, key, prec, d,
                         None if fault == 'unchanged' else fault)
        if fault == 'unchanged':
            post = s
        out.append((post, dict(key, n_mf=float(d.sweeps[0]) if d.sweeps
                               else None)))
        s = post
    return out


def judge_late(family, inputs, pre, steps, device):
    """The late check's numbers: each step followed by the float64
    reference from the program's state before it (`pre`, then the state
    after the step before), its ties to rounding taken on the program's
    side.  ``late_grad_diff``: the worst step's and leaf's norm of the
    difference of the gradient as the optimizer got it (the step's
    accumulator over the learning rate, less the momentum's share of the
    one before), over the larger of the reference's leaf norm and the
    median leaf's; ``late_n_mf_gap`` (a reference with mean-field): the
    widest gap between the program's sweeps of a step and the
    reference's.  Returns (numbers, [(program sweeps, reference sweeps,
    ties flipped) of each step])."""
    prec = Precision('float64')
    before = {k: as64(v, device) for k, v in pre.items()}
    diff, gap, rows = 0., None, []
    for post, key in steps:
        post = {k: as64(v, device) for k, v in post.items()}
        lr, mom, _ = late_key(inputs, key)
        s0 = before
        ref, d = follow(lambda dr: late_step(family, s0, inputs, key, prec,
                                             dr), post)
        grads = lambda s: {k: s[a] / lr - mom * s0[a]
                           for k, a in family.ACCUMULATORS.items()}
        diff = max(diff, leaf_numbers(grads(post), grads(ref),
                                      grads(ref))[1])
        ref_n = d.sweeps[0] if d.sweeps else None
        if ref_n is not None:
            prog_n = key.get('n_mf')
            g = abs(float(prog_n) - ref_n) if prog_n is not None else math.nan
            gap = max(gap or 0., _worst(g))
        rows.append((key.get('n_mf'), ref_n, len(d.flips)))
        before = post
    numbers = {'late_grad_diff': diff}
    if gap is not None:
        numbers['late_n_mf_gap'] = gap
    return numbers, rows
