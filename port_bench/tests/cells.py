"""Tiny cells for the harness's tests on the CPU: each family's real
configuration with its sizes cut, written as new files into a directory
of the test's own beside a copy of ``BENCHMARK.json`` that lists them."""

import json
import os

import pytest

from port_bench.harness.spec import BENCH_DIR, REPO_DIR

TINY = {
    'rbm-tiny.b5': ('rbm-mnist-784x1024', 'bernoulli_rbm',
                    dict(n_visible=16, n_hidden=12), 64, 16, 5,
                    'rbm-mnist.cd1-b10'),
    # 10 rows a step move the tiny DBM's few parameters unevenly: the gap
    # of the change after three steps reads up to ~1e-5 in sound runs
    # there, above the real cell's limit; the control still fails its
    # grad_gap
    'dbm-tiny.b10': ('dbm-mnist-784-512-1024', 'dbm',
                     dict(n_visible=16, n_hiddens=[12, 8], n_particles=10,
                          rbm_W_init=[0.3, 0.3]), 60, 20, 10,
                     'dbm-mnist.pcd-b100', {'change_gap': 2e-4}),
}


def read(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def write(obj, *parts):
    os.makedirs(os.path.dirname(os.path.join(*parts)), exist_ok=True)
    with open(os.path.join(*parts), 'w') as f:
        json.dump(obj, f)


def make_tiny_cells(root):
    """Write the TINY cells' files under `root` and a BENCHMARK.json that
    lists them with the real metrics; returns the BENCHMARK.json path.
    Each tiny cell takes the limits and the nominal epoch time of the real
    cell it stands for."""
    bench = read(REPO_DIR, 'BENCHMARK.json')
    bench['workloads'] = []
    for name, (config, family, sizes, n_train, n_val, B, real, *limits) in \
            TINY.items():
        cfg = read(BENCH_DIR, 'configs', config + '.json')
        cfg.update(sizes, name=name + '-config')
        cfg['data'] = dict(cfg['data'], n_train=n_train, n_val=n_val, side=4)
        if 'metrics_config' in cfg:
            cfg['metrics_config']['n_batches_for_feg'] = 2
        write(cfg, root, 'configs', name + '-config.json')
        write({'kind': 'fit', 'batch_size': B}, root, 'traffic',
              name + '-traffic.json')
        workload = read(BENCH_DIR, 'workloads', real + '.json')
        workload.update(config=name + '-config', traffic=name + '-traffic')
        for extra in limits:
            workload['limits'].update(extra)
        write(workload, root, 'workloads', name + '.json')
        bench['workloads'].append({
            'name': name, 'config': name + '-config',
            'traffic': name + '-traffic', 'chips': 1, 'why': 'a test'})
        # the tiny cell reports the metrics of the real cell it stands for
        for m in bench['end_to_end'] + bench['per_layer']:
            if real in m.get('workloads', ()):
                m['workloads'].append(name)
    os.symlink(os.path.join(BENCH_DIR, 'metrics'),
               os.path.join(root, 'metrics'))
    path = os.path.join(root, 'BENCHMARK.json')
    write(bench, path)
    return path


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    """(bench_dir, BENCHMARK.json) of the tiny cells.  On the CPU the RBM
    takes the CD epoch's plain version, which draws the kernels' Philox
    numbers, as a CUDA model takes the kernels."""
    from boltzmann_machines_tpu_torch import BaseRBM
    monkeypatch.setattr(BaseRBM, '_kernel_eligible', lambda self: True)
    return str(tmp_path), make_tiny_cells(str(tmp_path))


def run_tiny(tiny, name, capsys, seed=7, seconds=0.3):
    """Run the tiny cell `name` once on the CPU; returns (rc, result line
    as a dict or None, stderr)."""
    from port_bench.harness.runner import main
    bench_dir, bench_json = tiny
    rc = main(['--workload', name, '--seed', str(seed), '--seconds',
               str(seconds), '--trace', '0'], bench_dir=bench_dir,
              benchmark_json=bench_json, device='cpu')
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    result = json.loads(lines[-1]) if rc == 0 and lines else None
    return rc, result, err
