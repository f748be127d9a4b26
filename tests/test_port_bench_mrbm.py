"""The benchmark's multinomial RBM cell (``mrbm-cifar.cd2-b100``) and the
port's CD epoch behind it, on the CPU.

The port's ``MultinomialRBM.fit`` on the CD epoch's plain version (which
draws the kernels' Philox numbers, as a CUDA model takes the kernels) is
held step by step against the benchmark's float64 reference
(``port_bench/reference/multinomial_rbm.py``) at 48x16, n 16, B 8, CD-2,
``dbm_last``, the sparsity penalty on: sampling off, and sampling on with
the reference taking the port's counts near an edge (read by the
benchmark's session from the port's passes).  The reference's planted
faults, a short chain and shifted uniforms, read outside those
tolerances; the shifted uniforms at the cell's 512 units and n 512,
since over 15 bucket edges a shift of 5e-5 moves hardly a draw.

A tiny cell is built from the cell's real configuration, its widths cut to
48x16 (features of 4x4 pixels of 3 channels; n 512 as published, W_init
0.3 so that a moved count moves the chain), 64 training and 16 validation
rows, a batch of 8, train metrics every 16 steps, under the real cell's
limits.  The program is judged correct; the TF32 control and the faults
are not, nor is a whole run with a fault planted in the port's epoch (the
chain cut to one step; the hidden counts taken as their means).
"""

import importlib

import numpy as np
import pytest
import torch

from port_bench import calibrate, calibrate_mrbm
from port_bench.harness import runner
from port_bench.harness.spec import Cell
from port_bench.models import multinomial_rbm as family
from port_bench.reference import common
from port_bench.reference import multinomial_rbm as reference
from port_bench.tests import cells

NAME, REAL = 'mrbm-tiny.b8', 'mrbm-cifar.cd2-b100'
V, H, N, B, K = 48, 16, 16, 8, 2
LR, MOM = 0.05, [0.5, 0.7, 0.9]
#: float32 against float64 over three steps, of each leaf's largest
#: entry: products of at most 48 terms, a softmax and batch means of 8
#: round to a few 1e-7 of the sums' scale, and an entry that is a
#: difference of large terms (a gradient of counts up to n a row) keeps
#: their absolute rounding, so the bound is on the leaf's scale, not the
#: entry's; RTOL is ~4x the worst reading (2.6e-6, n 512)
RTOL, ATOL = 1e-5, 1e-9


# ---- the port's steps against the reference ----------------------------
def ref_config(sample, n=N, h=H):
    return {'n_visible': V, 'n_hidden': h, 'n_samples': n,
            'n_gibbs_steps': K, 'vb_init': 0., 'hb_init': 0.,
            'sample_v_states': sample, 'sample_h_states': sample,
            'dbm_last': True, 'l2': 0.005, 'sparsity_target': 0.2,
            'sparsity_cost': 0.01, 'sparsity_damping': 0.9}


def port_steps(tmp_path, cfg, W0, X, random_seed):
    """The port's state (under the reference's names) before and after
    each of three one-batch ``fit`` calls (epochs 1-3), its model, and the
    op seed of each step's epoch."""
    from boltzmann_machines_tpu_torch import MultinomialRBM
    model = MultinomialRBM(
        n_visible=V, n_hidden=cfg['n_hidden'], n_samples=cfg['n_samples'],
        W_init=W0,
        vb_init=0., hb_init=0., n_gibbs_steps=K, learning_rate=LR,
        momentum=MOM, max_epoch=0, batch_size=B, l2=cfg['l2'],
        sample_v_states=cfg['sample_v_states'],
        sample_h_states=cfg['sample_h_states'],
        sparsity_target=cfg['sparsity_target'],
        sparsity_cost=cfg['sparsity_cost'],
        sparsity_damping=cfg['sparsity_damping'], dbm_last=True,
        metrics_config=dict(msre=True, pll=True, train_metrics_every_iter=2),
        verbose=False, save_after_each_epoch=False,
        random_seed=random_seed, dtype='float32', device='cpu',
        model_path=str(tmp_path / 'mrbm') + '/')

    def snapshot():
        arrays = model.get_params_arrays()
        return {k: arrays[v] for k, v in family.Session.STATE.items()}
    states = [snapshot()]
    for e in range(1, 4):
        model.max_epoch = e
        model.fit(X[e - 1])
        states.append(snapshot())
    seeds = common.op_seeds(random_seed, 4)
    return states, model, [common.derive_seed(seeds[e], e)
                           for e in range(1, 4)]


def session_of(model, cfg):
    """The benchmark's session around `model`, for its reading of the
    program's counts."""
    session = object.__new__(family.Session)
    session.model, session.config, session.device = model, cfg, 'cpu'
    return session


def reference_steps(states, cfg, W0, X, seeds, session=None):
    """The float64 reference's state after each step from the port's state
    before it; with `session`, each step's draws near an edge taken from
    the port's counts and its Bernoulli ties on the port's side."""
    prec = common.Precision('float64')
    out = []
    for i in range(3):
        it = i + 1
        s = {k: torch.as_tensor(v, dtype=torch.float64)
             for k, v in states[i].items()}
        Xi = torch.as_tensor(X[i], dtype=torch.float64)
        mom = common.schedule_value(MOM, it)
        if session is None:
            out.append(reference.step(s, Xi, LR, mom, seeds[i], it, cfg,
                                      prec, common.Draws()))
            continue
        shown = dict(cfg, program_counts={it: session.chain_counts(
            states[i], X[i], seeds[i], it)})
        target = {k: torch.as_tensor(v) for k, v in states[i + 1].items()}
        out.append(common.follow(
            lambda d: reference.step(s, Xi, LR, mom, seeds[i], it, shown,
                                     prec, d), target)[0])
    return out


def inputs(seed, n=N, h=H):
    """W0 (V, h) and three batches: W0 of std 0.3 at n 16, and as much
    less at a larger n as keeps the visible logits, sums over the n counts
    of a row, as spread (saturated logits would hide a moved count)."""
    rng = np.random.RandomState(seed)
    W0 = (rng.randn(V, h) * 0.3 * N / n).astype(np.float32)
    X = rng.rand(3, B, V).astype(np.float32)
    return W0, X


def worst(prog, ref):
    """The largest max |prog - ref| over ATOL + RTOL max |ref| of any
    leaf."""
    return max(float(torch.max(torch.abs(
        torch.as_tensor(prog[k], dtype=torch.float64) - r)) /
        (ATOL + RTOL * torch.max(torch.abs(r)))) for k, r in ref.items())


@pytest.fixture
def kernel_path(monkeypatch):
    """``fit`` on the CD epoch's plain version, as a CUDA model on the
    kernels."""
    from boltzmann_machines_tpu_torch import BaseRBM
    monkeypatch.setattr(BaseRBM, '_kernel_eligible', lambda self: True)


def test_port_steps_match_reference_sampling_off(tmp_path, kernel_path):
    cfg = ref_config(False)
    W0, X = inputs(1)
    states, _, seeds = port_steps(tmp_path, cfg, W0, X, 11)
    for i, ref in enumerate(reference_steps(states, cfg, W0, X, seeds)):
        assert worst(states[i + 1], ref) <= 1., i
    # the steps moved the state: the check reads something
    assert float(np.abs(states[3]['W'] - states[0]['W']).max()) > 1e-3


@pytest.mark.parametrize('n', [N, 512])
def test_reference_follows_port_draws_sampling_on(tmp_path, kernel_path, n):
    """The port's counts of each step, read by the benchmark's session
    from the port's passes, are the reference's within its bands: no
    draw asked for outside its band."""
    cfg = ref_config(True, n)
    W0, X = inputs(2, n)
    states, model, seeds = port_steps(tmp_path, cfg, W0, X, 12)
    reference.taken.clear()
    refs = reference_steps(states, cfg, W0, X, seeds,
                           session_of(model, cfg))
    for i, ref in enumerate(refs):
        assert worst(states[i + 1], ref) <= 1., i
    assert all(missed == 0 for _, missed, _ in reference.taken.values())


@pytest.mark.parametrize('fault,n,h', [('short_chain', N, H),
                                       ('draw_shift', 512, 512)])
def test_planted_faults_read_outside_the_tolerances(tmp_path, kernel_path,
                                                    fault, n, h):
    """The reference with `fault` planted, in float32 as the program
    computes, against the float64 reference that follows the port: far
    outside the tolerances that the port keeps."""
    cfg = ref_config(True, n, h)
    W0, X = inputs(3, n, h)
    states, model, seeds = port_steps(tmp_path, cfg, W0, X, 13)
    refs = reference_steps(states, cfg, W0, X, seeds,
                           session_of(model, cfg))
    prec = common.Precision('float32')
    planted = dict(cfg, **{fault: True})
    far = 0.
    for i, ref in enumerate(refs):
        s = {k: torch.as_tensor(v) for k, v in states[i].items()}
        got = reference.step(s, torch.as_tensor(X[i]), LR,
                             common.schedule_value(MOM, i + 1), seeds[i],
                             i + 1, planted, prec, common.Draws())
        far = max(far, worst(got, ref))
    assert far > 100., far


# ---- the tiny cell through the harness ------------------------------------
TINY = ('mrbm-cifar-7800x512', 'multinomial_rbm', None, 64, 16, B, REAL)


def tiny_sizes():
    real = cells.read(cells.BENCH_DIR, 'configs', 'mrbm-cifar-7800x512.json')
    return dict(n_visible=V, n_hidden=H, W_init=0.3,
                data=dict(real['data'], n_features=V),
                metrics_config=dict(real['metrics_config'],
                                    train_metrics_every_iter=16))


@pytest.fixture(scope='module')
def tiny_cell(tmp_path_factory):
    """(bench_dir, BENCHMARK.json) of the tiny cells, the tiny M-RBM cell
    among them, and the patches a CPU run of it needs."""
    from boltzmann_machines_tpu_torch import BaseRBM
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(BaseRBM, '_kernel_eligible', lambda self: True)
        entry = list(TINY)
        entry[2] = tiny_sizes()
        mp.setitem(cells.TINY, NAME, tuple(entry))
        # this test process loaded JAX before the run (the JAX package's
        # tests share it): hold the run to the modules it loads itself
        before = set(runner.forbidden_modules())
        found = runner.forbidden_modules
        mp.setattr(runner, 'forbidden_modules',
                   lambda: sorted(set(found()) - before))
        root = tmp_path_factory.mktemp('mrbm_cells')
        yield str(root), cells.make_tiny_cells(str(root)), mp


@pytest.fixture(scope='module')
def tiny_readings(tiny_cell):
    bench_dir, bench_json, _ = tiny_cell
    cell = Cell(NAME, bench_dir=bench_dir, benchmark_json=bench_json)
    kinds = ['program'] + [c[0] for c in calibrate.controls_of(reference)]
    return calibrate_mrbm.readings(cell, 5, 'cpu', kinds, 0.2), cell.limits


def failed(numbers, limits):
    return [k for k, lim in limits.items() if not numbers[k] <= lim]


def test_program_is_correct_under_the_real_limits(tiny_readings):
    readings, limits = tiny_readings
    assert failed(readings['program'], limits) == [], readings['program']
    # every judged step's draws near an edge lay within their bands
    taken = readings['program']['taken']
    assert taken and all(missed == 0 for _, missed, _ in taken.values())


@pytest.mark.parametrize('kind', ['control_tf32', 'fault_unchanged',
                                  'fault_half_batch', 'fault_short_chain',
                                  'fault_draw_shift'])
def test_control_and_faults_fail(tiny_readings, kind):
    readings, limits = tiny_readings
    assert failed(readings[kind], limits), readings[kind]


def _planted(original, change):
    """The port's epoch with `change` planted in its configuration."""
    def epoch(cfg, *args):
        return original(cfg._replace(**change), *args)
    for key in ('launches', 'loop', 'softmax_rows'):
        setattr(epoch, key, getattr(original, key))
    return epoch


@pytest.mark.parametrize('change', [dict(k=1), dict(sample_h_states=False)],
                         ids=['short_chain', 'mean_hidden'])
def test_run_with_a_planted_fault_is_not_correct(tiny_cell, capsys, change):
    bench_dir, bench_json, mp = tiny_cell
    module = importlib.import_module(
        'boltzmann_machines_tpu_torch.ops.cd_epoch')
    original = module.cd_epoch
    mp.setattr(module, 'cd_epoch', _planted(original, change))
    try:
        rc, result, _ = cells.run_tiny((bench_dir, bench_json), NAME, capsys)
    finally:
        mp.setattr(module, 'cd_epoch', original)
    assert rc == 0
    assert result['correct'] is False


def test_tiny_cell_runs_correct(tiny_cell, capsys):
    bench_dir, bench_json, _ = tiny_cell
    rc, result, _ = cells.run_tiny((bench_dir, bench_json), NAME, capsys,
                                   seed=2 ** 40 + 7)
    assert rc == 0 and result['correct'] is True
    assert result['metrics']['train_samples_per_s']['value'] > 0
    assert set(result['checks']) == {'grad_gap', 'change_gap', 'grad_diff',
                                     'late_grad_diff'}
