"""The DBM's sweep-use reader (``metrics/mf_sweep_use_pct.py``) on the
port's counts over the profiled epochs, and the launch counts left as they
were beside them."""

import importlib.util
import json
import sys
import types

import pytest

from port_bench.harness import readers
from port_bench.harness.spec import BENCH_DIR, reader_path
from port_bench.tests.cells import tiny  # noqa: F401


class Ctx(object):
    def __init__(self, launches, steps):
        self.launches, self.window = launches, {'steps': steps}


def load(metric):
    spec = importlib.util.spec_from_file_location(
        'reader_' + metric.replace('.', '_'), reader_path(BENCH_DIR, metric))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_sweep_use_reader(monkeypatch):
    reader = load('mf_sweep_use_pct.train')
    assert reader.KERNELS == ()
    ops = types.SimpleNamespace(dbm_epoch=types.SimpleNamespace(
        profiled_sweeps={'steps': 1000, 'mf_sweeps_enqueued': 50000,
                         'mf_sweeps': 2900}))
    monkeypatch.setitem(sys.modules,
                        'boltzmann_machines_tpu_torch.ops.dbm_ops', ops)
    assert reader.read(Ctx({}, 1000)) == pytest.approx(5.8)
    # counts over other steps than the slices' (a profiler session outside
    # them, or counts left from before)
    assert reader.read(Ctx({}, 999)) is None
    # a program without the counts (the parent), or none enqueued
    ops.dbm_epoch.profiled_sweeps = {'steps': 1000, 'mf_sweeps_enqueued': 0,
                                     'mf_sweeps': 0}
    assert reader.read(Ctx({}, 1000)) is None
    del ops.dbm_epoch.profiled_sweeps
    assert reader.read(Ctx({}, 1000)) is None
    monkeypatch.delitem(sys.modules,
                        'boltzmann_machines_tpu_torch.ops.dbm_ops')
    assert reader.read(Ctx({}, 1000)) is None


def test_launches_per_step_leaves_the_sweep_counts_out():
    """The DBM session's launch counts are ``dbm_epoch.launches`` alone:
    the sweep counts beside them move no launch count."""
    from boltzmann_machines_tpu_torch.ops.dbm_ops import dbm_epoch
    from port_bench.models.dbm import Session
    counts = Session.counters(None)
    assert set(counts) == set(dbm_epoch.launches)
    assert not set(counts) & (set(dbm_epoch.sweeps) |
                              set(dbm_epoch.profiled_sweeps))
    ctx = Ctx(dict.fromkeys(counts, 0), 10)
    ctx.launches['dbm_gemm_act'] = 1070
    ctx.launches['dbm_msre'] = 60
    assert readers.launches_per_step(ctx) == 113.


def test_traced_tiny_dbm_reads_sweep_use(tiny, capsys):
    """A traced run of the tiny DBM on the CPU reports the sweep share,
    over the traced slices' steps alone (the reader reads None otherwise):
    100% on the plain path, which runs every sweep it enqueues; the tiny
    RBM does not report it."""
    from boltzmann_machines_tpu_torch.ops import dbm_ops
    from port_bench.harness.runner import main
    bench_dir, bench_json = tiny
    results = {}
    for name in ('dbm-tiny.b10', 'rbm-tiny.b5'):
        dbm_ops.reset_launches()   # a fresh process's counts
        rc = main(['--workload', name, '--seed', str(2 ** 40 + 3),
                   '--seconds', '0.2', '--trace', '1'], bench_dir=bench_dir,
                  benchmark_json=bench_json, device='cpu')
        assert rc == 0
        out, _ = capsys.readouterr()
        results[name] = json.loads(out.strip().splitlines()[-1])
        if name.startswith('dbm'):
            # the first steps, warm-up and late steps ran outside the
            # profiler: the whole run swept more than the slices
            whole = dict(dbm_ops.dbm_epoch.sweeps)
            profiled = dict(dbm_ops.dbm_epoch.profiled_sweeps)
    assert 0 < profiled['mf_sweeps'] < whole['mf_sweeps']
    dbm = results['dbm-tiny.b10']['metrics']
    assert dbm['mf_sweep_use_pct.train']['value'] == pytest.approx(100.)
    assert 'mf_sweep_use_pct.train' not in \
        results['rbm-tiny.b5']['metrics']
