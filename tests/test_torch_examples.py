"""examples/torch_rbm_mnist.py and examples/torch_dbm_mnist.py end to end
on the CPU (``--device cpu``) at cut widths and depths, on the synthetic
stand-in data: each pipeline runs through its last stage, writes its
outputs, and a second run resumes from the cached stages."""

import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CUT = ['--device', 'cpu', '--n-train', '300', '--n-val', '100',
       '--mlp-epochs', '1']


def run(script, args, cwd):
    env = dict(os.environ)
    env.pop('BMT_DATA_DIR', None)          # the synthetic stand-in data
    out = subprocess.run([sys.executable, os.path.join(REPO, 'examples',
                                                       script)] + args,
                         cwd=cwd, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    assert 'Test accuracy' in out.stdout
    return out.stdout


def test_torch_rbm_mnist(tmp_path):
    d = str(tmp_path) + '/'
    args = CUT + ['--n-hidden', '32', '--epochs', '1',
                  '--model-dirpath', d + 'rbm/',
                  '--mlp-save-prefix', d + 'out/rbm_']
    first = run('torch_rbm_mnist.py', args, d)
    assert 'Training model' in first
    for name in ('y_pred', 'y_test', 'W_finetuned'):
        assert os.path.isfile(d + 'out/rbm_%s.npy' % name)
    assert np.load(d + 'out/rbm_W_finetuned.npy').shape == (784, 32)
    assert len(np.load(d + 'out/rbm_y_pred.npy')) == 2048
    second = run('torch_rbm_mnist.py', args, d)
    assert 'Loading model' in second and 'Training model' not in second


def test_torch_dbm_mnist(tmp_path):
    """Hidden 32 and 24 (RBM #2's display_hidden_activations=24 needs 24
    units), one epoch a stage (RBM #2's schedule step cut to 1 epoch),
    AIS at 50 betas x 8 runs."""
    d = str(tmp_path) + '/'
    args = CUT + ['--n-hiddens', '32', '24', '--epochs', '1', '1', '1',
                  '--increase-n-gibbs-steps-every', '1',
                  '--n-betas', '50', '--n-ais-runs', '8',
                  '--rbm1-dirpath', d + 'rbm1/', '--rbm2-dirpath', d + 'rbm2/',
                  '--dbm-dirpath', d + 'dbm/',
                  '--ais-save-path', d + 'out/ais.npz',
                  '--mlp-save-prefix', d + 'out/dbm_']
    first = run('torch_dbm_mnist.py', args, d)
    for stage in ('RBM #1', 'RBM #2', 'DBM'):
        assert 'Training %s' % stage in first
    assert 'log Z = ' in first and 'average test ELBO' in first
    for name in ('y_pred', 'y_test', 'W1_finetuned', 'W2_finetuned'):
        assert os.path.isfile(d + 'out/dbm_%s.npy' % name)
    assert np.load(d + 'out/dbm_W2_finetuned.npy').shape == (32, 24)
    ais = np.load(d + 'out/ais.npz')
    assert np.isfinite(ais['log_Z']) and np.isfinite(ais['avg_test_elbo'])
    second = run('torch_dbm_mnist.py', args, d)
    for stage in ('RBM #1', 'RBM #2', 'DBM'):
        assert 'Loading %s' % stage in second
        assert 'Training %s' % stage not in second
    # the cached DBM and its saved host RNG give the same AIS estimate
    assert np.load(d + 'out/ais.npz')['log_Z'] == ais['log_Z']
