"""The device trace of a window (``torch.profiler`` with CUDA activity
alone: the device's operations and the host's CUDA API calls, not every
host operation, which would lengthen the window the idle share and
``mfu`` divide by) and its reduction: the device operations with their
times, the busy time as the union of their intervals, and the longest
idle gaps by the CUDA API call the host was in meanwhile, if any.
"""

import bisect
import re
import time
from collections import Counter, defaultdict

import torch

_TEMPLATE = re.compile(r'<[^<>]*>')
#: idle gaps attributed to host activity: the longest this many
N_GAPS = 5000
#: what an idle gap is put down to where the host was in no CUDA API call:
#: the program's own host code (Python, the fit loop)
HOST_CODE = 'host code outside CUDA calls'


def short_name(name):
    """A device operation's name without its namespace, template arguments
    and signature: ``void bm::dbm_gemm_act_kernel<...>(GemmArgs)`` ->
    ``dbm_gemm_act_kernel``; a copy or set keeps its kind (``Memcpy
    HtoD``)."""
    if name.startswith(('Memcpy', 'Memset')):
        return ' '.join(name.split()[:2])
    bare = name.replace('(anonymous namespace)', 'anonymous')
    while True:
        shorter = _TEMPLATE.sub('', bare)
        if shorter == bare:
            break
        bare = shorter
    head = bare.split('(', 1)[0].split()
    if not head:
        return name or '(unnamed)'
    parts = head[-1].split('::')
    # a bare `kernel` keeps its namespace: gemvx::kernel
    return '::'.join(parts[-2:]) if parts[-1] == 'kernel' else parts[-1]


def _span_ns(e):
    if hasattr(e, 'start_ns'):
        return e.start_ns(), e.duration_ns()
    return e.start_us() * 1000, e.duration_us() * 1000


class Trace(object):
    """``device``: (name, start_s, seconds) of every device operation;
    ``host``: (name, start_s, end_s) of every traced host event (the CUDA
    API calls); ``window_s``: the traced window's length on the host
    clock."""

    def __init__(self, device, host, window_s):
        self.device = sorted(device, key=lambda r: r[1])
        self.host = sorted(host, key=lambda r: r[1])
        self.window_s = window_s
        self._busy = None

    def intervals(self):
        """The union of the device operations' intervals, sorted."""
        if self._busy is None:
            out = []
            for _, s, d in self.device:
                e = s + d
                if out and s <= out[-1][1]:
                    if e > out[-1][1]:
                        out[-1][1] = e
                else:
                    out.append([s, e])
            self._busy = out
        return self._busy

    def busy_s(self):
        return sum(e - s for s, e in self.intervals())

    def time_by_name(self):
        t = defaultdict(float)
        for name, _, d in self.device:
            t[name] += d
        return dict(t)

    def count_by_name(self):
        return Counter(name for name, _, _ in self.device)

    def kernel_seconds(self, names):
        names = set(names)
        return sum(d for n, _, d in self.device if n in names)

    def idle_gaps(self):
        """(host activity, seconds) of the idle gaps between device
        operations, the longest N_GAPS of them, summed by what the host
        was doing at each gap's middle (the innermost host event running
        then; HOST_CODE where none ran); and the idle time before the
        first and after the last operation of the window."""
        busy = self.intervals()
        gaps = sorted(((b[0] - a[1], a[1]) for a, b in zip(busy, busy[1:])),
                      reverse=True)[:N_GAPS]
        starts = [h[1] for h in self.host]
        out = defaultdict(float)
        for length, t0 in gaps:
            mid = t0 + length / 2
            name = HOST_CODE
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(i - 200, -1), -1):
                if self.host[j][2] >= mid:
                    name = self.host[j][0]
                    break
            out[name] += length
        edges = self.window_s - (busy[-1][1] - busy[0][0]) if busy else \
            self.window_s
        out['window edges'] += max(edges, 0.)
        return sorted(out.items(), key=lambda kv: -kv[1])


class Traces(object):
    """The traced slices of one window, read as one trace: lengths, busy
    times, device times, counts and idle gaps summed over the slices."""

    def __init__(self, traces):
        self.traces = list(traces)
        self.device = [r for t in self.traces for r in t.device]
        self.window_s = sum(t.window_s for t in self.traces)

    def busy_s(self):
        return sum(t.busy_s() for t in self.traces)

    def time_by_name(self):
        out = defaultdict(float)
        for t in self.traces:
            for k, v in t.time_by_name().items():
                out[k] += v
        return dict(out)

    def count_by_name(self):
        return sum((t.count_by_name() for t in self.traces), Counter())

    def kernel_seconds(self, names):
        return sum(t.kernel_seconds(names) for t in self.traces)

    def idle_gaps(self):
        out = defaultdict(float)
        for t in self.traces:
            for k, v in t.idle_gaps():
                out[k] += v
        return sorted(out.items(), key=lambda kv: -kv[1])


def capture(fn, device):
    """Run `fn()` under the profiler; returns (fn's result, Trace).  On a
    device other than CUDA (the harness's tests) it traces the host."""
    from torch.profiler import ProfilerActivity, profile
    cuda_device = torch.device(device).type == 'cuda'
    activity = ProfilerActivity.CUDA if cuda_device else ProfilerActivity.CPU
    with profile(activities=[activity]) as prof:
        t0 = time.perf_counter()
        result = fn()
        if cuda_device:
            torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
    events = prof.profiler.kineto_results.events()
    spans = [_span_ns(e) for e in events]
    # seconds from the first event: nanoseconds since the epoch do not fit
    # a double's mantissa
    base = min((s for s, _ in spans), default=0)
    cuda = torch.autograd.DeviceType.CUDA
    dev_rows, host_rows = [], []
    for e, (start, dur) in zip(events, spans):
        t = (start - base) * 1e-9
        if e.device_type() == cuda:
            if getattr(e, 'is_user_annotation', lambda: False)():
                continue
            dev_rows.append((short_name(e.name()), t, dur * 1e-9))
        else:
            host_rows.append((e.name(), t, t + dur * 1e-9))
    return result, Trace(dev_rows, host_rows, window_s)
