"""Profiling hooks on ``torch.profiler``: traces viewable in TensorBoard or
Perfetto, named regions inside them, and a step timer (the counterpart of
the JAX package's ``utils/profiler.py``)."""

import contextlib
import os
import time


@contextlib.contextmanager
def trace(logdir, name='bmtpu'):
    """Capture a trace of the enclosed block -- host ops, and the kernels
    of the CUDA device when there is one (every kernel of the process, the
    port's ctypes launches included) -- and write it into `logdir` as
    ``<name>.<pid>.pt.trace.json`` (Chrome trace format: TensorBoard's
    profiler plugin and Perfetto open it).  Yields the
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


@contextlib.contextmanager
def annotate(name):
    """Named region inside a trace."""
    from torch.profiler import record_function
    with record_function(name):
        yield


class StepTimer(object):
    """Lightweight wall-clock step timer that syncs with the device by a
    scalar readback of `sync_value` (its sum)."""

    def __init__(self):
        self.times = []
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, sync_value=None):
        if sync_value is not None:
            float(sync_value if not hasattr(sync_value, 'sum')
                  else sync_value.sum())
        self.times.append(time.perf_counter() - self._t0)
        return self.times[-1]

    def mean(self):
        return sum(self.times) / max(len(self.times), 1)
