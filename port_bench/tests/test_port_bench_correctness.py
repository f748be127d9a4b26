"""The comparison that decides ``correct`` fails what it has to.

The control (the reference put in the program's place, in TF32) and every
fault a training cell can have (a step that returns its state unchanged;
half of every batch left out, the mean taken over the rest) are judged not
correct under each real cell's limits, at a size a test run holds; the
program itself is judged correct.  The faults are also planted under a
whole run: the run skips the look for a card, drives the port's epoch on
the CPU with the fault inside it, and its result reads ``correct`` false;
so do a fault in the epoch's remainder step alone, which only the late
check's steps see, and a mean-field that stops before it meets its
tolerance.
"""

import importlib

import pytest
import torch

from port_bench.harness.spec import Cell
from port_bench.reference import common
from port_bench.tests.cells import TINY, run_tiny, tiny  # noqa: F401


def readings(tiny, name, kind):
    """The numbers of `kind` ('program', or a reference in the program's
    place: 'control_tf32', 'fault_unchanged', 'fault_half_batch') on the
    tiny cell, and the limits of the real cell it stands for."""
    from port_bench import calibrate
    bench_dir, bench_json = tiny
    cell = Cell(name, bench_dir=bench_dir, benchmark_json=bench_json)
    return calibrate.readings(cell, 5, 'cpu', [kind], 0.2)[kind], \
        cell.limits


def failed(numbers, limits):
    return [k for k, lim in limits.items() if not numbers[k] <= lim]


@pytest.mark.parametrize('name', sorted(TINY))
def test_program_is_correct(tiny, name):
    numbers, limits = readings(tiny, name, 'program')
    assert failed(numbers, limits) == []


@pytest.mark.parametrize('kind', ['control_tf32', 'fault_unchanged',
                                  'fault_half_batch'])
@pytest.mark.parametrize('name', sorted(TINY))
def test_control_and_faults_fail(tiny, name, kind):
    numbers, limits = readings(tiny, name, kind)
    assert failed(numbers, limits), numbers


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1. + 2. ** -10, 1. + 2. ** -11, 1. + 3 * 2. ** -11,
                      -(1. + 2. ** -12)], dtype=torch.float32)
    assert common.to_tf32(x).tolist() == [1. + 2. ** -10, 1.,
                                          1. + 2. ** -9, -1.]


# ---- faults planted under a whole run ---------------------------------------
def _broken(original, fault, B):
    def epoch(cfg, state, X_batches, *args):
        if fault == 'half_batch':
            X_batches = X_batches[:, :X_batches.shape[1] // 2].contiguous()
        if fault == 'early_mean_field':
            cfg = cfg._replace(mf_tol=cfg.mf_tol * 1e4)
        out = original(cfg, state, X_batches, *args)
        unchanged = fault == 'unchanged' or (
            fault == 'remainder_unchanged' and X_batches.shape[1] != B)
        return (state,) + tuple(out[1:]) if unchanged else out
    epoch.launches = getattr(original, 'launches', {})
    return epoch


#: the function each family's fit runs its epoch through on the CPU
EPOCH = {'rbm-tiny.b5': ('boltzmann_machines_tpu_torch.ops.cd_epoch',
                         'cd_epoch'),
         'dbm-tiny.b10': ('boltzmann_machines_tpu_torch.dbm',
                          'dbm_epoch_reference')}


@pytest.mark.parametrize('name, fault', [
    (name, fault) for name in sorted(TINY)
    for fault in ('unchanged', 'half_batch')] + [
    ('rbm-tiny.b5', 'remainder_unchanged'),
    ('dbm-tiny.b10', 'early_mean_field')])
def test_run_with_a_broken_step_is_not_correct(tiny, capsys, monkeypatch,
                                               name, fault):
    module, attr = EPOCH[name]
    module = importlib.import_module(module)
    B = TINY[name][5]
    monkeypatch.setattr(module, attr, _broken(getattr(module, attr), fault,
                                              B))
    rc, result, _ = run_tiny(tiny, name, capsys)
    assert rc == 0
    assert result['correct'] is False
    if fault == 'remainder_unchanged':
        # only the late check's steps see it
        failed = [k for k, c in result['checks'].items()
                  if not c['value'] <= c['limit']]
        assert failed and all(k.startswith('late_') for k in failed)
