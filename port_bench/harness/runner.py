"""One run of one cell: set-up, the measured (or traced) window, the
correctness check, and the result line.

A run prints facts about the device and the trace on earlier lines of
standard output, the numbers of its correctness check beside their limits
as the last lines of standard error, and the result as the last line of
standard output: one JSON object with ``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``.
"""

import argparse
import gc
import importlib
import json
import shutil
import subprocess
import sys
import tempfile
import time

import torch

from .spec import Cell
from .trace import Traces, capture

#: modules that no run may hold once its window has closed, compared by
#: the top-level name whole (the port's own name begins with the last)
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'boltzmann_machines_tpu')


def say(*parts):
    print(*parts, flush=True)


def parse(argv):
    p = argparse.ArgumentParser(description='Run one cell of BENCHMARK.json '
                                'once and print its result line.')
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules():
    return sorted({m.split('.')[0] for m in sys.modules} & set(FORBIDDEN))


def nvidia_smi():
    """The card's name, power limit and clocks, as nvidia-smi reads them
    (an empty string where it cannot run)."""
    try:
        return subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit,clocks.sm,'
             'clocks.max.sm', '--format=csv,noheader'], capture_output=True,
            text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ''


class Context(object):
    """What a per-layer metric's reader reads: the traced slices of the
    window (``window``: their ``epochs``, ``steps``, ``rows``), their
    ``trace``, the port's launch counts over them (``launches``), and the
    work of their steps by kernel group (``work``, ``work.Work``
    values)."""

    def __init__(self, window, trace, launches, work):
        self.window, self.trace = window, trace
        self.launches, self.work = launches, work


def kernel_counts(trace, launches, kernel_of_counter):
    """(counter, launches counted, kernels traced) of every counter that
    moved in the window."""
    counts = trace.count_by_name()
    out = []
    for counter, n in sorted(launches.items()):
        if not n:
            continue
        names = kernel_of_counter.get(counter, ())
        names = (names,) if isinstance(names, str) else names
        out.append((counter, n, sum(counts.get(k, 0) for k in names)))
    return out


def run_cell(cell, args, device, workdir, process_start):
    """Set-up, window and checks of a cell, through its family's session
    (``models/<family>.py``) and plain reference
    (``reference/<family>.py``); returns (result dict without
    ``checks``, the checks' numbers)."""
    family = importlib.import_module('port_bench.models.' +
                                     cell.config['family'])
    ref = importlib.import_module('port_bench.reference.' +
                                  cell.config['family'])
    cuda = torch.device(device).type == 'cuda'
    session = family.Session(cell.config, cell.traffic, args.seed, device,
                             workdir)
    say(session.prepare())
    units = session.units(args.seconds, cell.workload)
    setup_s = time.perf_counter() - process_start
    if args.trace:
        plan = session.plan(units)
        say('trace: the window of {0} as {1} pieces of (untraced, timed, '
            'traced): '
            '{2}'.format(units, len(plan), plan))
        window = session.traced_window(units, plan, lambda fn: session.traced(
            fn, lambda f: capture(f, device)))
    else:
        t0 = time.perf_counter()
        window = session.window(units)
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    for line in session.describe(window):
        say(line)
    session.after_window()

    result = {'correct': None, 'attempted': window['steps'], 'failed': 0,
              'metrics': {},
              'device': {'platform': 'gpu' if cuda else 'cpu',
                         'kind': torch.cuda.get_device_name(device) if cuda
                         else 'cpu',
                         'count': int(cell.entry['chips']),
                         'memory_peak_bytes': int(peak)}}
    if args.trace:
        trace = Traces([t for _, t in window['pieces']])
        done, launches, work, lines = session.traced_context(window)
        lines.append('trace: {0} of the window\'s {1} traced in {2:.6f} s, '
                     'busy {3:.6f} s'.format(done, units, trace.window_s,
                                            trace.busy_s()))
        for line in lines:
            say(line)
        result['device'].update(busy_s=trace.busy_s(),
                                window_s=trace.window_s)
        read_per_layer(cell, result, Context(done, trace, launches, work),
                       family)
    else:
        values = dict(session.end_to_end(window, wall), setup_s=setup_s)
        say('window: {0} in {1:.6f} s; set-up {2:.6f} s'.format(
            {k: window[k] for k in ('epochs', 'steps', 'rows')}, wall,
            setup_s))
        for m in cell.end_to_end:
            result['metrics'][m['name']] = {
                'value': values[m['name']], 'unit': m['unit']}
    session.free()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers, lines = session.judge(ref, device)
    for line in lines:
        say(line)
    return result, numbers


def read_per_layer(cell, result, ctx, family):
    named = set()
    for m in cell.per_layer:
        reader = cell.reader(m['name'])
        named.update(reader.KERNELS)
        value = reader.read(ctx)
        if value is not None:
            result['metrics'][m['name']] = {'value': value, 'unit': m['unit']}
    trace = ctx.trace
    times = trace.time_by_name()
    counts = trace.count_by_name()
    for name, t in sorted(times.items(), key=lambda kv: -kv[1]):
        if name not in named:
            say('device op no metric names: {0}: {1} s in {2} ops'.format(
                name, t, counts[name]))
    rows = kernel_counts(trace, ctx.launches, family.KERNEL_OF_COUNTER)
    for counter, n, traced in rows:
        say('trace capture: {0}: {1} traced of {2} launched'.format(
            counter, traced, n))
    if rows:
        share = min(traced / n for _, n, traced in rows)
        say('trace capture: the idle share and rooflines rest on {0:.6%} of '
            'the launches (the least share of any kernel)'.format(share))
    result['breakdown'] = {
        'device_ops': [[k, v] for k, v in sorted(
            times.items(), key=lambda kv: -kv[1])[:10]],
        'idle_gaps': [[k, v] for k, v in trace.idle_gaps()[:10]]}


def main(argv=None, process_start=None, bench_dir=None,
         benchmark_json=None, device=None):
    """Run one cell once.  `device` None is the command line's run: it
    needs CUDA devices for the cell and fails without them; tests pass
    another `bench_dir`, ``BENCHMARK.json`` and device."""
    process_start = time.perf_counter() if process_start is None \
        else process_start
    args = parse(argv)
    kw = {} if bench_dir is None else {'bench_dir': bench_dir}
    cell = Cell(args.workload, benchmark_json=benchmark_json, **kw)
    if device is None:
        chips = int(cell.entry['chips'])
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < chips:
            print('this cell needs {0} CUDA device(s); found {1}'.format(
                chips, torch.cuda.device_count()
                if torch.cuda.is_available() else 0), file=sys.stderr)
            return 2
        device = 'cuda'
    if torch.device(device).type == 'cuda':
        say('device: {0} x {1}; nvidia-smi: {2}'.format(
            torch.cuda.get_device_name(device), torch.cuda.device_count(),
            nvidia_smi()))
    workdir = tempfile.mkdtemp(prefix='port_bench_')
    try:
        result, numbers = run_cell(cell, args, device, workdir,
                                   process_start)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    found = forbidden_modules()
    if found:
        print('modules of JAX or the JAX package were loaded: ' +
              ', '.join(found), file=sys.stderr)
        return 3
    checks = {k: {'value': numbers[k], 'limit': lim}
              for k, lim in sorted(cell.limits.items())}
    result['correct'] = all(c['value'] <= c['limit'] for c in
                            checks.values())
    result['checks'] = checks
    sys.stdout.flush()
    for k, c in checks.items():
        print('check {0}: {1!r} (limit {2!r})'.format(k, c['value'],
                                                      c['limit']),
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0

