"""Finding a cell's files by name.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix; the
harness reads ``workloads/<cell>.json``, ``configs/<config>.json`` and
``traffic/<traffic>.json`` under the benchmark's directory, and loads the
reader of each per-layer metric from ``metrics/<metric>.py`` or, where a
metric ``<quantity>.<qualifier>`` has no file of its own, the reader of
its quantity, ``metrics/<quantity>.py``.  Which
metrics a cell reports comes from ``BENCHMARK.json``: a metric with a
``workloads`` list in the cells it lists, one without it in every cell
that reports the end-to-end metric it ``moves``.
"""

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_DIR = os.path.dirname(BENCH_DIR)


def read_json(path):
    with open(path) as f:
        return json.load(f)


def reader_path(bench_dir, metric):
    """The reader file of a per-layer metric: its own, else its
    quantity's (the name before the first dot)."""
    own = os.path.join(bench_dir, 'metrics', metric + '.py')
    if os.path.isfile(own):
        return own
    return os.path.join(bench_dir, 'metrics', metric.split('.')[0] + '.py')


class Cell(object):
    """Everything one cell names: its entry in ``BENCHMARK.json``, its
    workload, configuration and traffic files, and the end-to-end and
    per-layer metrics it reports."""

    def __init__(self, name, bench_dir=BENCH_DIR, benchmark_json=None):
        self.name = name
        self.bench_dir = bench_dir
        bench = read_json(benchmark_json or
                          os.path.join(REPO_DIR, 'BENCHMARK.json'))
        entries = {w['name']: w for w in bench['workloads']}
        if name not in entries:
            raise KeyError('no workload {0!r} in BENCHMARK.json (it has {1})'
                           .format(name, ', '.join(sorted(entries))))
        self.entry = entries[name]
        self.workload = self._file('workloads', name)
        for key in ('config', 'traffic'):
            if self.workload[key] != self.entry[key]:
                raise ValueError('workloads/{0}.json names {1} {2!r}, '
                                 'BENCHMARK.json {3!r}'.format(
                                     name, key, self.workload[key],
                                     self.entry[key]))
        self.config = self._file('configs', self.entry['config'])
        self.traffic = self._file('traffic', self.entry['traffic'])
        self.limits = dict(self.workload['limits'])
        self.end_to_end = [m for m in bench['end_to_end']
                           if name in m.get('workloads', [name])]
        e2e = {m['name'] for m in self.end_to_end}
        self.per_layer = [m for m in bench['per_layer']
                          if (name in m['workloads'] if 'workloads' in m
                              else m['moves'] in e2e)]

    def _file(self, kind, name):
        return read_json(os.path.join(self.bench_dir, kind, name + '.json'))

    def reader(self, metric):
        """The module of ``metrics/<metric>.py``, else of
        ``metrics/<quantity>.py``: ``KERNELS`` (the kernel names whose
        device time it reads, possibly none) and ``read(ctx)``, which
        returns the metric's value or None when there is nothing to
        read."""
        path = reader_path(self.bench_dir, metric)
        spec = importlib.util.spec_from_file_location(
            'port_bench_metric_' + metric.replace('.', '_').replace('-', '_'),
            path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module
