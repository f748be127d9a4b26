"""examples/torch_rbm_mnist.py, torch_dbm_mnist.py, torch_dbm_cifar_naive.py,
torch_dbm_cifar.py and torch_semi_supervised.py end to end on the CPU
(``--device cpu``) at cut widths and depths, on the synthetic stand-in
data: each pipeline runs through its last stage, writes its outputs, and a
second run resumes from the cached stages."""

import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CUT = ['--device', 'cpu', '--n-train', '300', '--n-val', '100',
       '--mlp-epochs', '1']


def run(script, args, cwd, marker='Test accuracy'):
    env = dict(os.environ)
    env.pop('BMT_DATA_DIR', None)          # the synthetic stand-in data
    out = subprocess.run([sys.executable, os.path.join(REPO, 'examples',
                                                       script)] + args,
                         cwd=cwd, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    assert marker in out.stdout
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


def test_torch_dbm_cifar_naive(tmp_path):
    """Widths 3072-24-100 (the M-RBM's display_hidden_activations=100 needs
    100 units; n_samples 100), one epoch a stage, 1200 rows so that the SVD
    smoothing keeps 200 of its singular values (it zeroes the 1000
    smallest); the caches (X_s, Q, G) under --data-path."""
    d = str(tmp_path) + '/'
    args = ['--device', 'cpu', '--n-train', '1200', '--n-val', '200',
            '--n-hiddens', '24', '100', '--epochs', '1', '1', '1',
            '--mlp-epochs', '1', '--data-path', d + 'data',
            '--grbm-dirpath', d + 'grbm/', '--mrbm-dirpath', d + 'mrbm/',
            '--dbm-dirpath', d + 'dbm/', '--mlp-save-prefix', d + 'out/n_']
    first = run('torch_dbm_cifar_naive.py', args, d)
    for stage in ('G-RBM', 'M-RBM', 'DBM'):
        assert 'Training %s' % stage in first
    assert '[stage] composite end-to-end' in first
    for name in ('y_pred', 'y_test', 'W_finetuned'):
        assert os.path.isfile(d + 'out/n_%s.npy' % name)
    assert np.load(d + 'out/n_W_finetuned.npy').shape == (3072, 24)
    assert len(np.load(d + 'out/n_y_pred.npy')) == 1024
    for cache in ('X_s', 'Q_train_naive', 'Q_val_naive', 'G_train_naive'):
        assert os.path.isfile(d + 'data/%s.npy' % cache)
    second = run('torch_dbm_cifar_naive.py', args, d)
    for stage in ('G-RBM', 'M-RBM', 'DBM'):
        assert 'Loading %s' % stage in second
        assert 'Training %s' % stage not in second
    assert 'Smoothing data' not in second


def test_torch_dbm_cifar(tmp_path):
    """x10 augmentation of 200 rows, 26 small RBMs 192-36 (their
    display_hidden_activations=36), the quilted G-RBM 3072-936, the M-RBM
    936-100 (n_samples 100) on float16 features, the DBM, the MLP; one
    epoch a stage."""
    d = str(tmp_path) + '/'
    args = ['--device', 'cpu', '--n-train', '200', '--n-val', '100',
            '--n-small-hidden', '36', '--n-hiddens', '100',
            '--small-epochs', '1', '--epochs', '1', '1', '1',
            '--increase-n-gibbs-steps-every', '1', '--mlp-epochs', '1',
            '--data-path', d + 'data',
            '--small-dirpath-prefix', d + 'small_',
            '--grbm-dirpath', d + 'grbm/', '--mrbm-dirpath', d + 'mrbm/',
            '--dbm-dirpath', d + 'dbm/', '--mlp-save-prefix', d + 'out/c_']
    first = run('torch_dbm_cifar.py', args, d)
    assert first.count('Training small RBM') == 26
    for stage in ('G-RBM', 'M-RBM', 'DBM'):
        assert 'Training %s' % stage in first
    assert '[stage] composite end-to-end' in first
    assert np.load(d + 'data/X_aug.npy').shape == (2000, 3072)
    Q = np.load(d + 'data/Q_train_cifar.npy')
    assert Q.shape == (2000, 936) and Q.dtype == np.float16
    assert np.load(d + 'out/c_W_finetuned.npy').shape == (3072, 936)
    second = run('torch_dbm_cifar.py', args, d)
    assert second.count('Loading small RBM') == 26
    for stage in ('G-RBM', 'M-RBM', 'DBM'):
        assert 'Loading %s' % stage in second
        assert 'Training %s' % stage not in second
    assert 'Augmenting data' not in second


def test_torch_semi_supervised(tmp_path):
    """--quick with the RBM at 784-32 and two of the four label subsets:
    the markdown table and its JSON, and the cached RBM on a second run."""
    d = str(tmp_path) + '/'
    args = ['--device', 'cpu', '--quick', '--n-hidden', '32',
            '--subsets', '1000', '100', '--model-dirpath', d + 'rbm/',
            '--data-path', d + 'data', '--out', d + 'out/semi.md']
    first = run('torch_semi_supervised.py', args, d, marker='wrote ')
    assert 'Training model' in first
    with open(d + 'out/semi.md') as f:
        table = f.read()
    assert table.startswith('| number of labeled data pairs')
    assert '| 1k (900 + 100) |' in table and '| 100 (90 + 10) |' in table
    with open(d + 'out/semi.json') as f:
        rows = json.load(f)['rows']
    assert [r['subset'] for r in rows] == ['1k (900 + 100)', '100 (90 + 10)']
    assert all(0. <= r[k] <= 1. for r in rows for k in ('warm', 'cold'))
    second = run('torch_semi_supervised.py', args, d, marker='wrote ')
    assert 'Loading model' in second and 'Training model' not in second
