"""The port's profiling hooks (boltzmann_machines_tpu_torch/utils/
profiler.py) on the CPU, mirroring tests/test_aux.py:14-38: a trace file
that TensorBoard or Perfetto opens, and the annotation and step timer."""

import json
import os

import torch

from boltzmann_machines_tpu_torch.utils import profiler


def test_profiler_trace_writes_events(tmp_path):
    """`profiler.trace` writes a non-empty Chrome trace into logdir, naming
    the ops of the block and the region of `annotate`."""
    logdir = str(tmp_path / 'prof')
    with profiler.trace(logdir):
        with profiler.annotate('bm_step'):
            x = torch.ones((128, 128))
            float(torch.sum(x @ x))
    found = []
    for root, _, files in os.walk(logdir):
        found += [os.path.join(root, f) for f in files]
    assert found, 'profiler trace produced no files'
    assert any(os.path.getsize(f) > 0 for f in found)
    assert all(f.endswith('.pt.trace.json') for f in found)
    with open(found[0]) as f:
        names = {e.get('name') for e in json.load(f)['traceEvents']}
    assert 'bm_step' in names and 'aten::mm' in names


def test_profiler_annotate_and_timer():
    t = profiler.StepTimer()
    with profiler.annotate('step'):
        t.start()
        x = torch.ones((64, 64)) @ torch.ones((64, 64))
        dt = t.stop(sync_value=x)
    assert dt >= 0.
    assert t.mean() >= 0.
    assert len(t.times) == 1
    assert profiler.StepTimer().mean() == 0.
