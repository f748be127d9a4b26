"""The benchmark's Gaussian RBM cell (``grbm-cifar.cd1-b100``) on the CPU.

A tiny cell is built from the cell's real configuration, its widths cut
to 48x12 (4x4 pixels of 3 channels), 64 training and 16 validation rows
and a batch of 5, under the real cell's limits.  On the CPU the port's
``fit`` takes the CD epoch's plain version, which draws the kernels'
Philox numbers, as a CUDA model takes the kernels.  The program is judged
correct; the TF32 control and the faults of every training cell are not,
nor is a whole run with a fault planted in the port's epoch (the visible
states taken as their means; the ``dbm_first`` doubling dropped).  The
plain reference's frozen Box-Muller draws the port's normals, and the
``cifar_like`` rows are standardised as the example standardises them.
"""

import importlib

import pytest
import torch

from port_bench import calibrate
from port_bench.harness import data, runner
from port_bench.harness.data import make_rows
from port_bench.harness.spec import Cell
from port_bench.models import gaussian_rbm as family
from port_bench.reference import gaussian_rbm as reference
from port_bench.tests import cells

NAME, REAL = 'grbm-tiny.b5', 'grbm-cifar.cd1-b100'


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    """(bench_dir, BENCHMARK.json) of the tiny cells, the tiny G-RBM cell
    among them."""
    from boltzmann_machines_tpu_torch import BaseRBM
    monkeypatch.setattr(BaseRBM, '_kernel_eligible', lambda self: True)
    monkeypatch.setitem(cells.TINY, NAME, (
        'grbm-cifar-3072x5000', 'gaussian_rbm',
        dict(n_visible=48, n_hidden=12), 64, 16, 5, REAL))
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


@pytest.mark.parametrize('kind', ['control_tf32', 'fault_unchanged',
                                  'fault_half_batch'])
def test_control_and_faults_fail(tiny, kind):
    numbers, limits = readings(tiny, kind)
    assert failed(numbers, limits), numbers


def _planted(original, fault):
    """The port's epoch with `fault` planted in its configuration."""
    change = {'mean_visible': dict(sample_v_states=False),
              'no_doubling': dict(propup_mult=1.)}[fault]

    def epoch(cfg, *args):
        return original(cfg._replace(**change), *args)
    epoch.launches = original.launches
    return epoch


@pytest.mark.parametrize('fault', ['mean_visible', 'no_doubling'])
def test_run_with_a_planted_fault_is_not_correct(tiny, capsys, monkeypatch,
                                                 fault):
    module = importlib.import_module(
        'boltzmann_machines_tpu_torch.ops.cd_epoch')
    monkeypatch.setattr(module, 'cd_epoch', _planted(module.cd_epoch, fault))
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


@pytest.mark.parametrize('seed, it, stream, shape', [
    (0, 1, 1, (1, 1)), (1234567, 3, 1, (7, 33)),
    (2 ** 31 - 1, 490, 3, (100, 48)), (99, 2 ** 32 - 1, 1, (3, 3072))])
def test_reference_normal_is_the_ports(seed, it, stream, shape):
    from boltzmann_machines_tpu_torch.ops import philox
    port = philox.normal(seed, it, stream, shape)
    ref = reference.normal(seed, it, stream, shape, 'cpu')
    assert ref.dtype == torch.float64 and ref.shape == port.shape
    # float32 rounding of values up to sqrt(-2 ln 1e-7) = 5.7: the port
    # rounds 2 pi u1 and the cosine to float32
    torch.testing.assert_close(ref.to(torch.float32), port, rtol=1e-6,
                               atol=2e-6)


def cifar_spec(**kw):
    spec = cells.read(cells.BENCH_DIR, 'configs',
                      'grbm-cifar-3072x5000.json')['data']
    return dict(spec, **kw)


def test_cifar_like_rows_are_standardised_over_the_training_rows():
    spec = cifar_spec(n_train=400, n_val=100, side=8)
    X = make_rows(500, spec, 17, 'cpu').to(torch.float64)
    assert X.shape == (500, 8 * 8 * 3) and X.dtype == torch.float64
    train = X[:400]
    torch.testing.assert_close(train.mean(0), torch.zeros(192,
                                                          dtype=X.dtype),
                               rtol=0, atol=1e-5)
    torch.testing.assert_close(train.std(0, unbiased=False),
                               torch.ones(192, dtype=X.dtype), rtol=0,
                               atol=1e-4)
    # the validation rows take the training rows' mean and std, not their
    # own
    assert float(torch.abs(X[400:].mean(0)).max()) > 1e-3
    # every row differs, and neighbouring pixels move together (smooth)
    assert len(torch.unique(X, dim=0)) == 500
    img = train.reshape(400, 8, 8, 3)
    near = torch.corrcoef(torch.stack([img[:, 3, 3, 0], img[:, 3, 4, 0]]))
    assert float(near[0, 1]) > 0.5


def test_cifar_like_rows_follow_the_seed():
    spec = cifar_spec(n_train=40, n_val=10, side=4)
    a, b = (make_rows(50, spec, 3, 'cpu') for _ in range(2))
    c = make_rows(50, spec, 4, 'cpu')
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert data.DATA['cifar_like'] is family.cifar_like
