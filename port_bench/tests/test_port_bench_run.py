"""A run of a tiny cell on the CPU: a cell added as files alone runs, its
result line holds the contract's keys, no module of JAX or the JAX
package is loaded, and a run without a card or without the program
fails without a result."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from port_bench.harness.runner import forbidden_modules
from port_bench.harness.spec import BENCH_DIR, REPO_DIR
from port_bench.tests.cells import TINY, run_tiny, tiny  # noqa: F401

KEYS = ['correct', 'attempted', 'failed', 'metrics', 'device', 'checks']


@pytest.mark.parametrize('name', sorted(TINY))
def test_a_cell_added_as_files_runs(tiny, capsys, name):
    rc, result, err = run_tiny(tiny, name, capsys, seed=2 ** 33 + 5)
    assert rc == 0
    assert list(result) == KEYS
    assert result['correct'] is True
    assert sorted(k.split('.')[0] for k in result['metrics']) == [
        'setup_s', 'train_samples_per_s']
    for m in result['metrics'].values():
        assert m['value'] > 0
    assert set(result['device']) == {'platform', 'kind', 'count',
                                     'memory_peak_bytes'}
    assert result['attempted'] > 0 and result['failed'] == 0
    checks = err.strip().splitlines()[-len(result['checks']):]
    assert [c.split(':')[0] for c in checks] == [
        'check ' + k for k in sorted(result['checks'])]


def test_same_seed_same_numbers(tiny, capsys):
    a = run_tiny(tiny, 'rbm-tiny.b5', capsys, seed=11)[1]['checks']
    b = run_tiny(tiny, 'rbm-tiny.b5', capsys, seed=11)[1]['checks']
    assert a == b


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, 'boltzmann_machines_tpu_torch_x',
                        sys.modules[__name__])
    assert 'boltzmann_machines_tpu' not in forbidden_modules()
    monkeypatch.setitem(sys.modules, 'jaxlib.fake', sys.modules[__name__])
    assert 'jaxlib' in forbidden_modules()


SCRIPT = '''
import json, sys
sys.path.insert(0, {repo!r})
from boltzmann_machines_tpu_torch import BaseRBM
BaseRBM._kernel_eligible = lambda self: True
from port_bench.harness.runner import main, forbidden_modules
from port_bench.tests.cells import make_tiny_cells
bench = make_tiny_cells({root!r})
rc = main(['--workload', 'dbm-tiny.b10', '--seed', '3', '--seconds', '0.2',
           '--trace', '0'], bench_dir={root!r}, benchmark_json=bench,
          device='cpu')
print(json.dumps({{'rc': rc, 'loaded': sorted(
    {{m.split('.')[0] for m in sys.modules}})}}))
'''


def test_no_module_of_jax_in_a_run(tmp_path):
    out = subprocess.run(
        [sys.executable, '-c', SCRIPT.format(repo=REPO_DIR,
                                             root=str(tmp_path))],
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path),
        env=dict(os.environ, JAX_PLATFORMS='cpu'))
    assert out.returncode == 0, out.stderr[-2000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last['rc'] == 0
    assert not {'jax', 'jaxlib', 'flax', 'boltzmann_machines_tpu'} & \
        set(last['loaded'])
    assert 'boltzmann_machines_tpu_torch' in last['loaded']


def test_without_a_card_no_result():
    out = subprocess.run(
        [sys.executable, 'port_bench/run.py', '--workload',
         'rbm-mnist.cd1-b10', '--seed', '1', '--seconds', '1', '--trace',
         '0'], capture_output=True, text=True, timeout=300, cwd=REPO_DIR,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=''))
    assert out.returncode != 0
    assert '"correct"' not in out.stdout


def test_without_the_program_no_result(tmp_path):
    shutil.copy(os.path.join(REPO_DIR, 'BENCHMARK.json'), str(tmp_path))
    shutil.copytree(BENCH_DIR, str(tmp_path / 'port_bench'))
    out = subprocess.run(
        [sys.executable, '-c',
         'import sys; sys.path.insert(0, "."); '
         'from port_bench.harness.runner import main; '
         'sys.exit(main(["--workload", "rbm-mnist.cd1-b10", "--seed", "1", '
         '"--seconds", "1", "--trace", "0"], device="cpu"))'],
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path))
    assert out.returncode != 0
    assert 'boltzmann_machines_tpu_torch' in out.stderr
    assert '"correct"' not in out.stdout
