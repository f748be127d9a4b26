"""Where a benchmark cell's idle card time goes, by the port's fit-loop
spans.  One cell of BENCHMARK.json, set up as ``port_bench/run.py`` sets it
up, then its traced window twice, as ``--trace 1`` cuts it into pieces:
first with the port's span recorder on (``capture_spans`` below), then with
it off (the benchmark's own ``trace.capture``).  Run from the root of a
checkout, on one CUDA card:

    python3 tools/torch_fit_spans.py --workload <cell> --seed <n> \\
        [--seconds 30] [--out FILE]

The spans are stamped with ``time.time_ns()``, the clock ``torch.profiler``
stamps its events with (nanoseconds since the epoch), so they go onto the
trace's own time base beside the device operations, and so do the slice's
start and end.  ``idle_by_span`` gives each idle interval of a slice, its
two edges included, to the innermost span running meanwhile, by overlap:
a gap that crosses two spans is split between them.  Where the host was
also inside a CUDA API call, it notes that call.

Prints one JSON line (and writes it to FILE):

- ``setup_s`` and ``build``: the seconds from the start to the window, and
  ``ops/_build.counts`` (nvcc runs, library loads and their seconds);
- ``on`` / ``off``: the traced slices' ``window_s``, their busy seconds,
  ``untraced_s`` (the timed parts beside them, without the profiler) and
  the idle share of ``window_s``, per run of the window;
- ``on`` also: ``by_span``, each span's idle seconds, the part of them
  inside a CUDA API call and that part by call; ``launch_path``,
  ``fit_loop`` and ``outside``, the idle seconds inside
  ``fit/epoch/train``, inside ``fit`` but not ``fit/epoch/train``, and in
  no span, in % of ``window_s``; ``launches_outside_fit``, the kernel
  launches of the slices outside every ``fit`` span (0 where the spans and
  the trace share a clock); ``host_events``, the most frequent host event
  names of the trace;
- a DBM cell: ``mf_sweep_use_pct``, 100 x the sweeps the traced slices'
  steps ran over those they enqueued (``dbm_epoch.sweeps``), beside
  ``logged_n_mf``, the mean of the ``n_mf_updates`` that ``fit`` logged in
  the same slices; ``mf_graph``, per traced slice, the mean-field graph's
  launches (``dbm_epoch.graph_launches``) and the turns of its WHILE node
  (``dbm_epoch.launches['dbm_mf_check']``, a check a turn), and
  ``mf_turns_a_step``;
- an RBM cell: ``val_passes``, the whole-set validation and FEG passes of
  the traced slices (``ops/cd_val.cd_val.passes``: 'val' one a validation,
  'feg' one a side of a gap), and ``epoch_loop``, per traced slice, the
  calls of the CD epoch's C step loop and the steps they ran
  (``ops/cd_epoch.cd_epoch.loop``; absent where the port has no such
  loop).
"""

import argparse
import importlib
import json
import os
import shutil
import sys
import tempfile
import time
from collections import Counter, defaultdict

_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

#: the idle time inside no span
OUTSIDE = '(no span)'
#: the launch path: the span of the fit loop's ``train_epoch`` call
LAUNCH_PATH = 'fit/epoch/train'
#: host events that launch a kernel (cudaLaunchKernel*, cuLaunchKernel*)
LAUNCHES = ('cudaLaunchKernel', 'cuLaunchKernel')


def capture_spans(fn, device):
    """Run `fn()` under the profiler and the port's span recorder; returns
    (fn's result, Trace).  The Trace is ``trace.capture``'s and carries
    besides ``start_s``, the window's start, and ``spans``, (name,
    start_s, end_s, parent, call) of every span, on the trace's base."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from boltzmann_machines_tpu_torch.utils import profiler
    from port_bench.harness.trace import Trace, _span_ns, short_name
    cuda_device = torch.device(device).type == 'cuda'
    activity = ProfilerActivity.CUDA if cuda_device else ProfilerActivity.CPU
    with profile(activities=[activity]) as prof:
        with profiler.recording() as recorded:
            t0_ns = time.time_ns()
            t0 = time.perf_counter()
            result = fn()
            if cuda_device:
                torch.cuda.synchronize(device)
            window_s = time.perf_counter() - t0
    events = prof.profiler.kineto_results.events()
    stamps = [_span_ns(e) for e in events]
    base = min([s for s, _ in stamps] + [t0_ns])
    cuda = torch.autograd.DeviceType.CUDA
    dev_rows, host_rows = [], []
    for e, (start, dur) in zip(events, stamps):
        t = (start - base) * 1e-9
        if e.device_type() == cuda:
            if getattr(e, 'is_user_annotation', lambda: False)():
                continue
            dev_rows.append((short_name(e.name()), t, dur * 1e-9))
        else:
            host_rows.append((e.name(), t, t + dur * 1e-9))
    trace = Trace(dev_rows, host_rows, window_s)
    trace.start_s = (t0_ns - base) * 1e-9
    trace.spans = [(s.name, (s.start_ns - base) * 1e-9,
                    (s.end_ns - base) * 1e-9, s.parent, s.call)
                   for s in recorded]
    return result, trace


def innermost(intervals):
    """The union of `intervals` ((start, end) pairs that nest or follow one
    another) as disjoint, sorted (start, end, i) pieces, each given to the
    innermost interval i covering it: of those that cover it, the last to
    start."""
    order = sorted(range(len(intervals)),
                   key=lambda i: (intervals[i][0], -intervals[i][1]))
    out, stack, t = [], [], None

    def run_to(x):
        # close the open intervals that end by x; the one below takes over
        nonlocal t
        while stack and stack[-1][0] <= x:
            end, j = stack.pop()
            if end > t:
                out.append((t, end, j))
                t = end
        if stack and x > t:
            out.append((t, x, stack[-1][1]))
            t = x

    for i in order:
        s, e = intervals[i]
        if t is not None:
            run_to(s)
        t = s if t is None else max(t, s)
        stack.append((e, i))
    if stack:
        run_to(float('inf'))
    return out


def overlaps(a, b):
    """(start, end, label of a, label of b) of every overlap of two sorted
    lists of disjoint (start, end, label) pieces."""
    i = j = 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if s < e:
            yield s, e, a[i][2], b[j][2]
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1


def idle_intervals(trace):
    """The idle intervals of a slice: its window, from ``start_s`` for
    ``window_s``, less the union of the device operations, as sorted
    (start, end, None) pieces; the two edges are among them."""
    w0 = trace.start_s
    w1 = w0 + trace.window_s
    out, t = [], w0
    for s, e in trace.intervals():
        if s > t:
            out.append((t, min(s, w1), None))
        t = max(t, e)
        if t >= w1:
            break
    if t < w1:
        out.append((t, w1, None))
    return [p for p in out if p[1] > p[0]]


def idle_by_span(trace):
    """{span name: [idle seconds, seconds of them inside a CUDA API call,
    {call: seconds}]} of one slice traced by ``capture_spans``; the idle
    time inside no span under ``OUTSIDE``.  The seconds add up to the
    window's idle time, ``window_s`` less the busy time inside it."""
    w0, w1 = trace.start_s, trace.start_s + trace.window_s
    names = [OUTSIDE] + [s[0] for s in trace.spans]
    # the window as the outermost interval: its pieces in no span are
    # OUTSIDE's
    whole = (min([w0] + [s[1] for s in trace.spans]),
             max([w1] + [s[2] for s in trace.spans]))
    spans = innermost([whole] + [(s[1], s[2]) for s in trace.spans])
    pieces = [(s, e, names[i])
              for s, e, _, i in overlaps(idle_intervals(trace), spans)]
    calls = innermost([(h[1], h[2]) for h in trace.host])
    out = defaultdict(lambda: [0., 0., defaultdict(float)])
    for s, e, name in pieces:
        out[name][0] += e - s
    for s, e, name, k in overlaps(pieces, calls):
        out[name][1] += e - s
        out[name][2][trace.host[k][0]] += e - s
    return {k: [v[0], v[1], dict(v[2])] for k, v in out.items()}


def launches_outside_fit(trace):
    """The kernel launches (host events) of a slice outside every ``fit``
    span: 0 where the spans and the trace share a clock."""
    fits = sorted((s[1], s[2]) for s in trace.spans if s[0] == 'fit')
    n = 0
    for name, s, e in trace.host:
        if name.startswith(LAUNCHES) and \
                not any(a <= s and e <= b for a, b in fits):
            n += 1
    return n


def idle_split(traces):
    """Over the slices of `traces` (each from ``capture_spans``): the
    seconds of ``idle_by_span`` summed by span, and the shares of the
    slices' length (``window_s``), in %: ``launch_path`` (idle inside
    ``fit/epoch/train``), ``fit_loop`` (inside a ``fit`` call but outside
    ``fit/epoch/train``) and ``outside`` (inside no span)."""
    by_span = defaultdict(lambda: [0., 0., defaultdict(float)])
    for tr in traces:
        for name, (idle, in_call, calls) in idle_by_span(tr).items():
            row = by_span[name]
            row[0] += idle
            row[1] += in_call
            for k, v in calls.items():
                row[2][k] += v
    window = sum(tr.window_s for tr in traces)
    pct = lambda s: 100. * s / window if window > 0 else None
    launch = by_span[LAUNCH_PATH][0] if LAUNCH_PATH in by_span else 0.
    outside = by_span[OUTSIDE][0] if OUTSIDE in by_span else 0.
    loop = sum(v[0] for k, v in by_span.items()
               if k.split('/')[0] == 'fit' and k != LAUNCH_PATH)
    return {'by_span': {k: [v[0], v[1], dict(v[2])]
                        for k, v in by_span.items()},
            'launch_path': pct(launch), 'fit_loop': pct(loop),
            'outside': pct(outside)}


def slice_counts():
    """The DBM's sweep counts, the RBM's whole-set pass counts and the CD
    epoch's C step loop counts (``loop_calls``, ``loop_steps``), of the
    modules a cell has loaded."""
    dbm = sys.modules.get('boltzmann_machines_tpu_torch.ops.dbm_ops')
    val = sys.modules.get('boltzmann_machines_tpu_torch.ops.cd_val')
    epoch = sys.modules.get('boltzmann_machines_tpu_torch.ops.cd_epoch')
    counts = dict(val.cd_val.passes if val is not None else {})
    loop = getattr(getattr(epoch, 'cd_epoch', None), 'loop', None)
    if loop is not None:
        counts.update(loop_calls=loop['calls'], loop_steps=loop['steps'])
    if dbm is not None:
        counts.update(dbm.dbm_epoch.sweeps,
                      graph_launches=dbm.dbm_epoch.graph_launches,
                      mf_turns=dbm.dbm_epoch.launches['dbm_mf_check'])
    return counts


def epoch_loop(grown):
    """Per slice of `grown` (``slice_counts``' growth over each), the CD
    epoch's C step loop calls and the steps they ran; None where no slice
    ran the loop."""
    if not any(g.get('loop_calls') for g in grown):
        return None
    return [{'calls': g.get('loop_calls', 0), 'steps': g.get('loop_steps', 0)}
            for g in grown]


def traced_window(session, units, plan, capture, device):
    """The traced window of `units` epochs by `plan`, each slice traced by
    `capture(fn, device)`; returns the window and, per slice, the sweep
    and pass counts' growth over it."""
    grown = []

    def slice_capture(fn):
        before = slice_counts()
        result = capture(fn, device)
        after = slice_counts()
        grown.append({k: after[k] - before[k] for k in after})
        return result

    window = session.traced_window(
        units, plan, lambda fn: session.traced(fn, slice_capture))
    return window, grown


def describe(window, traces):
    from port_bench.harness.trace import Traces
    tr = Traces(traces)
    records = [r for r, _ in window['pieces']]
    untraced = [r['untraced_s'] for r in records]
    return {'window_s': tr.window_s, 'busy_s': tr.busy_s(),
            'untraced_s': None if None in untraced else sum(untraced),
            'idle_pct': 100. * (1. - tr.busy_s() / tr.window_s),
            'epochs': sum(r['epochs'] for r in records),
            'steps': sum(r['steps'] for r in records)}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, default=30.)
    p.add_argument('--out')
    args = p.parse_args(argv)
    import torch

    from boltzmann_machines_tpu_torch.ops import _build
    from port_bench.harness.runner import nvidia_smi
    from port_bench.harness.spec import Cell
    from port_bench.harness.trace import capture
    device = 'cuda'
    cell = Cell(args.workload)
    family = importlib.import_module('port_bench.models.' +
                                     cell.config['family'])
    workdir = tempfile.mkdtemp(prefix='fit_spans_')
    try:
        session = family.Session(cell.config, cell.traffic, args.seed,
                                 device, workdir)
        out = {'workload': args.workload, 'seed': args.seed,
               'device': torch.cuda.get_device_name(device),
               'nvidia_smi': nvidia_smi(), 'prepare': session.prepare()}
        out['setup_s'] = time.perf_counter() - _START
        out['build'] = dict(_build.counts)
        units = session.units(args.seconds, cell.workload)
        plan = session.plan(units)
        out.update(units=units, plan=plan)

        window, grown = traced_window(session, units, plan, capture_spans,
                                      device)
        traces = [t for _, t in window['pieces']]
        on = describe(window, traces)
        on.update(idle_split(traces))
        on['launches_outside_fit'] = sum(launches_outside_fit(t)
                                         for t in traces)
        on['host_events'] = Counter(h[0] for t in traces
                                    for h in t.host).most_common(12)
        on['spans'] = len([s for t in traces for s in t.spans])
        if hasattr(session, 'logged_n_mf'):
            enq = sum(g['mf_sweeps_enqueued'] for g in grown)
            ran = sum(g['mf_sweeps'] for g in grown)
            logged = [v for r, _ in window['pieces']
                      for v in session.logged_n_mf(r['iter0'], r['iter1'])]
            on['mf_sweep_use_pct'] = 100. * ran / enq if enq else None
            on['mf_sweeps_a_step'] = ran / on['steps']
            on['logged_n_mf'] = sum(logged) / len(logged) if logged \
                else None
            on['mf_graph'] = [{k: g.get(k, 0) for k in (
                'graph_launches', 'mf_turns')} for g in grown]
            on['mf_turns_a_step'] = sum(
                g.get('mf_turns', 0) for g in grown) / on['steps']
        if any('val' in g for g in grown):
            on['val_passes'] = {k: sum(g.get(k, 0) for g in grown)
                                for k in ('val', 'feg')}
        loop = epoch_loop(grown)
        if loop is not None:
            on['epoch_loop'] = loop
        out['on'] = on
        del window, traces

        window, _ = traced_window(session, units, plan, capture, device)
        out['off'] = describe(window, [t for _, t in window['pieces']])
        del window
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, 'w') as f:
            f.write(line + '\n')
    print(line, flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
