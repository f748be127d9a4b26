"""The benchmark's Gaussian-Bernoulli-Multinomial DBM cell
(``gbm-dbm-cifar.pcd-b100``) and the port's epoch behind it, on the CPU.

The port's plain G-B-M epoch (``dbm_epoch_reference``, the plain version
of the kernels' path, drawing their Philox numbers) is held step by step
against the benchmark's float64 reference (``port_bench/reference/
gbm_dbm.py``) at 48-30-20 with n 20 and B = M = 8, sampling off and on
under the same draws (each tie to rounding taken on the port's side).

A tiny cell is built from the cell's real configuration, its widths cut
to 48-30-20 (4x4 pixels of 3 channels; the multinomial n 20), 64 training
and 16 validation rows, a batch and 8 particles, under the real cell's
limits.  The program is judged correct, and its judged steps ask for no
multinomial draw outside its band; the TF32 control and the faults of
every training cell are not, nor is a whole run with a fault planted in
the port's epoch (the top layer's or the visible layer's states taken as
their means; mean-field stopped before it meets its tolerance).  At the
real layer's n 1000 the reference takes from the program's counts draws
that rounding of the logits moves, and not draws on shifted uniforms.
"""

import importlib

import numpy as np
import pytest
import torch

from boltzmann_machines_tpu_torch import (BernoulliLayer, GaussianLayer,
                                          MultinomialLayer)
from boltzmann_machines_tpu_torch.ops import dbm_ops
from port_bench import calibrate_gbm_dbm as calibrate
from port_bench.harness import runner
from port_bench.harness.spec import Cell
from port_bench.reference import common
from port_bench.reference import gbm_dbm as reference
from port_bench.reference import philox as rphilox
from port_bench.tests import cells

NAME, REAL = 'gbm-dbm-tiny.b8', 'gbm-dbm-cifar.pcd-b100'
SIZES, N_SAMPLES, B = (48, 30, 20), 20, 8


# ---- the port's epoch against the reference --------------------------------
def ref_cfg(sample, mf_tol=1e-11):
    return {'n_samples': N_SAMPLES, 'sigma': 1.3, 'mf_tol': mf_tol,
            'max_mf_updates': 50, 'n_gibbs_steps': 1,
            'sample_v_states': sample, 'sample_h_states': [sample, sample],
            'l2': 1e-4, 'max_norm': 4., 'sparsity_target': [0.1, 0.2],
            'sparsity_cost': [1e-3, 1e-4], 'sparsity_damping': 0.9}


def port_cfg(c):
    units = (GaussianLayer(SIZES[0], sigma=c['sigma']),
             BernoulliLayer(SIZES[1]),
             MultinomialLayer(SIZES[2], n_samples=c['n_samples']))
    return dbm_ops.DBMEpochConfig(
        SIZES, c['n_gibbs_steps'], c['max_mf_updates'], c['mf_tol'],
        c['sample_v_states'], tuple(c['sample_h_states']), c['l2'],
        c['max_norm'], tuple(c['sparsity_target']),
        tuple(c['sparsity_cost']), c['sparsity_damping'], units)


#: the reference's state names of the port's state (key, layer or None)
NAMES = {'W0': ('W', 0), 'W1': ('W', 1), 'vb': ('vb', None),
         'hb0': ('hb', 0), 'hb1': ('hb', 1), 'dW0': ('dW', 0),
         'dW1': ('dW', 1), 'dvb': ('dvb', None), 'dhb0': ('dhb', 0),
         'dhb1': ('dhb', 1), 'q0': ('q_means', 0), 'q1': ('q_means', 1),
         'm0': ('mu_means', 0), 'm1': ('mu_means', 1), 'v': ('v', None),
         'H0': ('H', 0), 'H1': ('H', 1)}


def as_reference(state):
    return {k: (state[key] if l is None else state[key][l]).to(
        torch.float64) for k, (key, l) in NAMES.items()}


def port_state(seed):
    """A G-B-M state at 48-30-20: stacked weights of the published scale
    times 20, zero accumulators and EMAs, Gaussian visible particles and
    count particles of the top layer."""
    rng = np.random.RandomState(seed)
    V, H1, H2 = SIZES

    def f32(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float32))
    z = lambda *s: torch.zeros(s)
    p = rng.dirichlet(np.ones(H2), size=B)
    return {'vb': f32(rng.randn(V) * 0.1), 'dvb': z(V),
            'hb': (f32(rng.randn(H1) * 0.1), f32(rng.randn(H2) * 0.1)),
            'W': (f32(rng.randn(V, H1) * 0.016), f32(rng.randn(H1, H2) * 0.2)),
            'dhb': (z(H1), z(H2)), 'dW': (z(V, H1), z(H1, H2)),
            'q_means': (z(H1), z(H2)), 'mu_means': (z(H1), z(H2)),
            'v': f32(rng.randn(B, V)),
            'H': (f32(rng.rand(B, H1) < 0.5), f32(N_SAMPLES * p))}


@pytest.mark.parametrize('sample', [False, True], ids=['means', 'sampled'])
def test_port_epoch_follows_the_reference(sample, one_thread):
    """Three steps of the port's plain G-B-M epoch, each from the state
    the step before left, against the float64 reference from the same
    state: every leaf within 2e-5 of the reference's norm (the Gaussian
    particles within Box-Muller's float32 rounding), the sampled
    Bernoulli and multinomial particles equal, every row of counts
    summing to n, and the mean-field sweeps within one."""
    c = ref_cfg(sample)
    cfg, prec = port_cfg(c), common.Precision('float64')
    state = port_state(3)
    X = torch.as_tensor(np.random.RandomState(4).randn(3, B, SIZES[0])
                        .astype(np.float32))
    seed, lr, mom = 2 ** 31 + 17, 0.05, 0.5
    for i in range(3):
        got, _, n_mf = dbm_ops.dbm_epoch_reference(cfg, state, X[i:i + 1],
                                                   lr, mom, seed, i)
        port = as_reference(got)
        before = as_reference(state)
        shown = dict(c, program_h0={i + 1: port['H0']},
                     program_h1={i + 1: port['H1']})
        ref, draws = common.follow(
            lambda d: reference.step(before, X[i].to(torch.float64), lr,
                                     mom, seed, i + 1, shown, prec, d),
            port)
        for k in NAMES:
            scale = max(float(torch.linalg.vector_norm(ref[k])), 1e-30)
            gap = float(torch.linalg.vector_norm(port[k] - ref[k])) / scale
            assert gap <= 2e-5, (i, k, gap)
        if sample:
            assert torch.equal(port['H0'], ref['H0'])
            assert torch.equal(port['H1'], ref['H1'])
            assert bool((port['H1'].sum(1) == N_SAMPLES).all())
            assert not torch.equal(port['v'], before['v'])
        assert abs(float(n_mf[0]) - draws.sweeps[0]) <= 1
        state = got


def test_multinomial_draws_are_the_ports(one_thread):
    """The reference's multinomial counts on float64 means are the port's
    ``philox.multinomial_counts`` on the same means in float32 but for
    draws within TIE_BAND of a bucket's edge; with the program's counts
    given and logits without rounding, a draw put just below its bucket's
    upper edge crosses it where the counts show it there, one put five
    TIE_BANDs below does not, and nothing moves where they agree."""
    from boltzmann_machines_tpu_torch.ops import philox
    rng = np.random.RandomState(5)
    means = torch.as_tensor(N_SAMPLES * rng.dirichlet(np.ones(SIZES[2]),
                                                      size=40))
    port = philox.multinomial_counts(means.to(torch.float32), N_SAMPLES,
                                     7, 3, 1).to(torch.float64)
    ref = reference.multinomial(means, N_SAMPLES, 7, 3, 1)
    assert bool((ref.sum(1) == N_SAMPLES).all())
    assert float((port - ref).abs().sum()) <= 2.
    # draw 0 of row 0 moved to just below its bucket's upper edge (the
    # means shifted, their sum kept)
    cdf = torch.cumsum(means[0] / N_SAMPLES, 0)
    u = rphilox.uniform(7, 3, 1, (40, N_SAMPLES), 'cpu')[0, 0].double()
    bucket = int(torch.searchsorted(cdf[:-1], u, right=True))
    assert bucket < SIZES[2] - 1
    delta = float(u + 0.5 * common.TIE_BAND - cdf[bucket]) * N_SAMPLES
    shift = means.clone()
    shift[0, bucket] += delta
    shift[0, bucket + 1] -= delta
    a = reference.multinomial(shift, N_SAMPLES, 7, 3, 1)
    crossed = a.clone()
    crossed[0, bucket:bucket + 2] += torch.tensor([-1., 1.],
                                                  dtype=a.dtype)
    none = torch.zeros(40, dtype=torch.float64)
    assert torch.equal(reference.multinomial(shift, N_SAMPLES, 7, 3, 1,
                                             crossed, delta=none), crossed)
    assert torch.equal(reference.multinomial(shift, N_SAMPLES, 7, 3, 1, a,
                                             delta=none), a)
    # nor where the draw lies beyond the band (TIE_BAND where the logits
    # are exact)
    delta = float(u + 5 * common.TIE_BAND - cdf[bucket]) * N_SAMPLES
    far_shift = means.clone()
    far_shift[0, bucket] += delta
    far_shift[0, bucket + 1] -= delta
    b = reference.multinomial(far_shift, N_SAMPLES, 7, 3, 1)
    crossed = b.clone()
    crossed[0, bucket:bucket + 2] += torch.tensor([-1., 1.],
                                                  dtype=b.dtype)
    assert torch.equal(reference.multinomial(far_shift, N_SAMPLES, 7, 3, 1,
                                             crossed, delta=none), b)
    # counts that no tie explains keep the reference's own
    far = a.clone()
    far[1, 0] += 1.
    far[1, SIZES[2] - 1] -= 1.
    assert torch.equal(reference.multinomial(shift, N_SAMPLES, 7, 3, 1,
                                             far, delta=none)[1], a[1])


@pytest.mark.parametrize('collapsed', [False, True],
                         ids=['spread', 'collapsed'])
def test_multinomial_takes_rounding_from_the_program_not_a_shift(
        collapsed, one_thread):
    """At the real layer's n = 1000 over 1000 units: counts drawn from
    logits each moved by up to the rows' rounding delta are taken whole,
    while counts drawn on uniforms shifted by 5e-5 (a planted draw fault)
    are not, in rows whose means are spread and in rows that put nearly
    all their mass on one unit, as the cell's late steps do."""
    rows, H, n = 40, 1000, 1000
    rng = np.random.RandomState(9)
    x = torch.as_tensor(rng.randn(rows, H) * 3.)
    if collapsed:
        x[torch.arange(rows), torch.as_tensor(rng.randint(H, size=rows))] \
            += 18.
    delta = torch.full((rows,), 1e-4, dtype=torch.float64)
    means = reference.top_means(x, n)
    moved = reference.top_means(
        x + delta[:, None] * torch.as_tensor(rng.uniform(-1, 1, (rows, H))),
        n)
    rounded = reference.multinomial(moved, n, 11, 7, 1)
    own = reference.multinomial(means, n, 11, 7, 1)
    assert not torch.equal(rounded, own)
    assert torch.equal(reference.multinomial(means, n, 11, 7, 1, rounded,
                                             delta=delta), rounded)
    shifted = reference.multinomial(means, n, 11, 7, 1, shift=5e-5)
    assert not torch.equal(shifted, own)
    judged = reference.multinomial(means, n, 11, 7, 1, shifted,
                                   delta=delta)
    assert torch.equal((judged != shifted).any(1), (own != shifted).any(1))
    moved_draws, missed, worst = reference.taken[7]
    assert missed > 0 and worst > reference.SHOWN_FACTOR


# ---- the tiny cell ---------------------------------------------------------
@pytest.fixture
def one_thread():
    """torch on one CPU thread while the test runs: a softmax of a few
    rows on several threads of a loaded machine waits ~1000x longer."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def tiny(tmp_path, monkeypatch, one_thread):
    """(bench_dir, BENCHMARK.json) of the tiny cells, the tiny G-B-M DBM
    cell among them (the train metrics logged every 16 steps, so that the
    warm-up reaches a logged step in two epochs).  As the tiny all-Bernoulli
    DBM's (port_bench/tests/cells.py), 8 rows a step move the tiny model's
    few parameters unevenly: the gap of the change after three steps reads
    up to ~1e-5 in sound runs there, above the real cell's limit; the
    control and the faults still fail their other numbers."""
    monkeypatch.setitem(cells.TINY, NAME, (
        'gbm-dbm-cifar-3072-5000-1000', 'gbm_dbm',
        dict(n_visible=48, n_hiddens=[30, 20], n_samples=N_SAMPLES,
             n_particles=B, rbm_W_init=[0.016, 0.2],
             train_metrics_every_iter=16), 64, 16, B, REAL,
        {'change_gap': 2e-4}))
    # this test process loaded JAX before the run (the JAX package's
    # tests share it): hold the run to the modules it loads itself
    before = set(runner.forbidden_modules())
    found = runner.forbidden_modules
    monkeypatch.setattr(runner, 'forbidden_modules',
                        lambda: sorted(set(found()) - before))
    return str(tmp_path), cells.make_tiny_cells(str(tmp_path))


def readings(tiny, kind):
    bench_dir, bench_json = tiny
    cell = Cell(NAME, bench_dir=bench_dir, benchmark_json=bench_json)
    return calibrate.readings(cell, 5, 'cpu', [kind], 0.2)[kind], \
        cell.limits


def failed(numbers, limits):
    return [k for k, lim in limits.items() if not numbers[k] <= lim]


def test_program_is_correct_under_the_real_limits(tiny):
    numbers, limits = readings(tiny, 'program')
    assert failed(numbers, limits) == [], numbers
    # the judged steps asked for no draw outside its band
    assert len(numbers['taken']) == 4
    assert all(t[1] == 0 for t in numbers['taken'].values())


@pytest.mark.parametrize('kind', ['control_tf32', 'fault_unchanged',
                                  'fault_half_batch'])
def test_control_and_faults_fail(tiny, kind):
    numbers, limits = readings(tiny, kind)
    assert failed(numbers, limits), numbers


def _planted(original, fault):
    """The port's plain epoch with `fault` planted in its
    configuration."""
    change = {'mean_top': lambda c: dict(sample_h=(c.sample_h[0], False)),
              'mean_visible': lambda c: dict(sample_v=False),
              # stopped at a change of 1e-2 in counts of n 20 (at 1e-3
              # it reads ~1e-4, at the limits)
              'early_mean_field': lambda c: dict(mf_tol=c.mf_tol * 1e9)}[fault]

    def epoch(cfg, *args):
        return original(cfg._replace(**change(cfg)), *args)
    return epoch


@pytest.mark.parametrize('fault', ['mean_top', 'mean_visible',
                                   'early_mean_field'])
def test_run_with_a_planted_fault_is_not_correct(tiny, capsys, monkeypatch,
                                                 fault):
    module = importlib.import_module('boltzmann_machines_tpu_torch.dbm')
    monkeypatch.setattr(module, 'dbm_epoch_reference',
                        _planted(module.dbm_epoch_reference, fault))
    rc, result, _ = cells.run_tiny(tiny, NAME, capsys)
    assert rc == 0
    assert result['correct'] is False


def test_same_seed_gives_the_same_numbers(tiny, capsys):
    runs = [cells.run_tiny(tiny, NAME, capsys, seed=2 ** 40 + 11)
            for _ in range(2)]
    (rc0, first, _), (rc1, second, _) = runs
    assert rc0 == rc1 == 0
    assert first['correct'] is True
    assert first['attempted'] == second['attempted']
    assert first['checks'] == second['checks']
