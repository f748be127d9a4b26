"""Profiling hooks: traces on ``torch.profiler`` viewable in TensorBoard or
Perfetto, and the port's spans, the named regions of its fit loops (the
counterpart of the JAX package's ``utils/profiler.py``).

``annotate(name)`` opens a span.  It does nothing unless a recording or a
profiler session is open, so the fit loops keep their spans in every run:

* inside ``recording()`` each span is kept in memory with its host
  wall-clock interval (``time.time_ns()``, the clock ``torch.profiler``
  stamps its host and device events with), its parent and the call it
  belongs to;
* while a ``torch.profiler`` session is active (``trace()`` below, or the
  caller's own) it is also a ``record_function`` region of the trace.

A span's name is a path: ``fit``, ``fit/epoch``, ``fit/epoch/train``.  A
name without a slash names a call (``fit``, ``log_Z``): the spans under it
belong to it.  Spans are recorded from one thread at a time.
"""

import contextlib
import os
import time

from torch.autograd import _profiler_enabled

#: the open ``Recorder``, or None: recording is off
_recorder = None
_OFF = contextlib.nullcontext()


@contextlib.contextmanager
def trace(logdir, name='bmtpu'):
    """Capture a trace of the enclosed block -- host ops, and the kernels
    of the CUDA device when there is one (every kernel of the process, the
    port's ctypes launches included) -- and write it into `logdir` as
    ``<name>.<pid>.pt.trace.json`` (Chrome trace format: TensorBoard's
    profiler plugin and Perfetto open it).  The port's spans in the block
    (``fit/...``, ``log_Z/...``) are regions of it.  Yields the
    ``torch.profiler.profile`` object.

    >>> with trace('/tmp/prof'):     # doctest: +SKIP
    ...     rbm.fit(X)
    """
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        logdir, '{0}.{1}.pt.trace.json'.format(name, os.getpid())))


class Span(object):
    """A recorded span: `name`, `start_ns` and `end_ns` (``time.time_ns()``;
    `end_ns` None while it is open), `parent` (the index of the enclosing
    span in the recording, or None) and `call` (the index of the span that
    names its call: the nearest enclosing one, itself included, whose name
    has no slash; None where there is none)."""

    __slots__ = ('name', 'start_ns', 'end_ns', 'parent', 'call')

    def __init__(self, name, start_ns, parent, call):
        self.name, self.start_ns, self.end_ns = name, start_ns, None
        self.parent, self.call = parent, call


class Recorder(object):
    """The spans of one ``recording()``, in the order they opened."""

    def __init__(self):
        self.spans = []
        self._open = []

    @contextlib.contextmanager
    def span(self, name):
        parent = self._open[-1] if self._open else None
        i = len(self.spans)
        call = i if '/' not in name else \
            None if parent is None else self.spans[parent].call
        s = Span(name, time.time_ns(), parent, call)
        self.spans.append(s)
        self._open.append(i)
        try:
            yield
        finally:
            s.end_ns = time.time_ns()
            self._open.pop()


@contextlib.contextmanager
def recording():
    """Keep the spans opened in the block; yields their list (``Span``s,
    in the order they opened), complete once the block ends.  Recordings
    do not nest."""
    global _recorder
    if _recorder is not None:
        raise RuntimeError('a recording is already open')
    _recorder = Recorder()
    try:
        yield _recorder.spans
    finally:
        _recorder = None


@contextlib.contextmanager
def _span(name, recorder, in_session):
    from torch.profiler import record_function
    with record_function(name) if in_session else _OFF:
        with recorder.span(name) if recorder is not None else _OFF:
            yield


def profiling():
    """Whether a ``torch.profiler`` session is active."""
    return _profiler_enabled()


def annotate(name):
    """A span named `name` around the enclosed block: kept by the open
    ``recording()``, and a ``record_function`` region while a profiler
    session is active; nothing otherwise."""
    recorder = _recorder
    in_session = _profiler_enabled()
    if recorder is None and not in_session:
        return _OFF
    return _span(name, recorder, in_session)
