"""One run of a real cell on the card, through the command line (skips
without a CUDA device)."""

import json
import subprocess
import sys

import pytest

from port_bench.harness.spec import REPO_DIR


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')


@pytest.mark.requires_cuda
@pytest.mark.parametrize('trace', [0, 1])
def test_cell_runs_on_the_card(card, trace):
    out = subprocess.run(
        [sys.executable, 'port_bench/run.py', '--workload',
         'rbm-mnist.cd1-b256', '--seed', str(2 ** 32 + 9), '--seconds', '2',
         '--trace', str(trace)], capture_output=True, text=True,
        timeout=1200, cwd=REPO_DIR)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result['correct'] is True
    assert result['device']['platform'] == 'gpu'
    if trace:
        assert 0 < result['device']['busy_s'] <= result['device']['window_s']
        assert 'breakdown' in result
