"""The port's profiling hooks (boltzmann_machines_tpu_torch/utils/
profiler.py) on the CPU, mirroring tests/test_aux.py:14-38: a trace file
that TensorBoard or Perfetto opens, and the spans of `annotate`, off, in a
recording and in a profiler's trace."""

import json
import os

import pytest
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
    """`annotate` records nothing with no recording and no profiler open;
    inside `recording()` it keeps each span's interval, parent and call,
    and the recording ends with its block."""
    assert profiler.annotate('step') is profiler.annotate('other')
    with profiler.annotate('step'):
        x = torch.ones((64, 64)) @ torch.ones((64, 64))
    with profiler.recording() as spans:
        with profiler.annotate('fit'):
            with profiler.annotate('fit/epoch'):
                x = x @ x
            with profiler.annotate('fit/save'):
                pass
        with profiler.annotate('log_Z'):
            with profiler.annotate('log_Z/ais'):
                pass
        with pytest.raises(RuntimeError):
            with profiler.recording():
                pass
    assert [(s.name, s.parent, s.call) for s in spans] == [
        ('fit', None, 0), ('fit/epoch', 0, 0), ('fit/save', 0, 0),
        ('log_Z', None, 3), ('log_Z/ais', 3, 3)]
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    assert spans[1].end_ns <= spans[2].start_ns
    with profiler.annotate('fit'):
        pass
    assert len(spans) == 5 and profiler._recorder is None


def test_span_holds_the_profiler_events_run_inside_it():
    """The spans and torch.profiler's host events share a clock
    (``time.time_ns()``, since the epoch): an op run inside a span lies
    inside the span's recorded interval, and the span is a region of the
    profiler's trace."""
    from torch.profiler import ProfilerActivity, profile
    x = torch.ones((256, 256))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiler.recording() as spans:
            with profiler.annotate('fit'):
                for _ in range(5):
                    x = x @ torch.ones((256, 256)) / 256.
    events = prof.profiler.kineto_results.events()
    mm = [e for e in events if e.name() == 'aten::mm']
    assert len(mm) == 5
    (span,) = spans
    for e in mm:
        assert span.start_ns <= e.start_ns()
        assert e.start_ns() + e.duration_ns() <= span.end_ns
    assert any(e.name() == 'fit' for e in events)
