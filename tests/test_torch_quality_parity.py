"""Quality parity of the port (boltzmann_machines_tpu_torch) with the
reference's published numbers (README.md:155-193, :256), on the card: the
gates of tests/test_quality_parity.py.

They run the real training recipes, so they enable only when the genuine
dataset is on disk (MNIST: data/mnist/ or $BMT_DATA_DIR/mnist/; CIFAR-10:
the python batches under data/cifar-10-batches-py/ or
$BMT_DATA_DIR/cifar-10-batches-py/) and a CUDA device is present; without
either they skip.  This file imports no JAX:

    BMT_TEST_TPU=1 python -m pytest tests/test_torch_quality_parity.py -q

Targets (reference, GTX 1060):
* RBM-MNIST fine-tuned test error 1.27% -> assert <= 1.6%;
* DBM log Z-hat: two independent AIS estimates (fresh seeds; the port runs
  the linear ladder only) agree within +-0.5 nats, and the full
  examples/torch_dbm_mnist.py recipe reproduces log Z-hat = 1040.39 within
  +-0.5 nats and the average test ELBO -86.37 within 1 nat;
* CIFAR-10, examples/torch_dbm_cifar_naive.py's G-RBM and fine-tuned MLP:
  59.78% test accuracy -> assert >= 58%.
"""

import json

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from boltzmann_machines_tpu_torch.utils.dataset import (
    load_mnist, real_cifar_available, real_mnist_available)

pytestmark = pytest.mark.requires_cuda
requires_real_mnist = pytest.mark.skipif(
    not (real_mnist_available() and torch.cuda.is_available()),
    reason='quality-parity tests need the genuine MNIST IDX files '
           '(data/mnist/ or $BMT_DATA_DIR/mnist/) and a CUDA device')

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope='module')
def mnist():
    from boltzmann_machines_tpu_torch.utils import RNG
    X, y = load_mnist(mode='train')
    X_test, y_test = load_mnist(mode='test')
    X, X_test = X / 255., X_test / 255.
    RNG(seed=42).shuffle(X)
    RNG(seed=42).shuffle(y)
    return X[:55000], y[:55000], X[55000:], y[55000:], X_test, y_test


@requires_real_mnist
def test_rbm_mnist_finetuned_error(mnist, tmp_path):
    """examples/torch_rbm_mnist.py recipe: 784x1024 CD-1, 120 epochs, then
    a 784-1024-10 MLP warm-started from (W, hb).  Reference: 1.27%."""
    from boltzmann_machines_tpu_torch import BernoulliRBM, logit_mean
    from boltzmann_machines_tpu_torch.finetune import MLPClassifier
    from boltzmann_machines_tpu_torch.utils import (
        one_hot_decision_function, unhot)
    X, y, X_val, y_val, X_test, y_test = mnist

    rbm = BernoulliRBM(
        n_visible=784, n_hidden=1024, W_init=0.01,
        vb_init=logit_mean(X), hb_init=0., n_gibbs_steps=1,
        learning_rate=0.05,
        momentum=np.geomspace(0.5, 0.9, 8).tolist(),
        max_epoch=120, batch_size=10, l2=1e-5, random_seed=1337,
        verbose=False, save_after_each_epoch=False,
        metrics_config=dict(msre=True, pll=True,
                            train_metrics_every_iter=1000),
        device='cuda', model_path=str(tmp_path) + '/rbm/')
    rbm.fit(X, X_val)

    w = rbm.get_params_arrays('weights')
    mlp = MLPClassifier(
        n_inputs=784,
        layers=[dict(units=1024, activation='sigmoid',
                     weights=(w['W'], w['hb']), lr_multiplier=0.1)],
        n_classes=10, l2=1e-5, learning_rate=1e-3, max_epoch=100,
        batch_size=128, val_metric='val_acc', random_seed=1111,
        verbose=False, device='cuda')
    mlp.fit(X, y, X_val, y_val)
    y_pred = unhot(one_hot_decision_function(mlp.predict_proba(X_test)),
                   n_classes=10)
    error = 1. - float(np.mean(y_pred == np.asarray(y_test)))
    print('RBM-MNIST fine-tuned test error: {0:.4f}'.format(error))
    assert error <= 0.016


@requires_real_mnist
def test_dbm_mnist_logZ_self_consistency(mnist, tmp_path):
    """Shortened dbm_mnist recipe, then two independent AIS estimates
    (fresh seeds) within +-0.5 nats, each interval under 1 nat."""
    from boltzmann_machines_tpu_torch import BernoulliRBM, DBM
    X, y, X_val, y_val, _, _ = mnist
    X, X_val = X[:10000], X_val[:2000]

    r1 = BernoulliRBM(n_visible=784, n_hidden=512, dbm_first=True,
                      n_gibbs_steps=1, learning_rate=0.05, momentum=0.5,
                      max_epoch=20, batch_size=48, l2=1e-3, random_seed=688,
                      verbose=False, save_after_each_epoch=False,
                      device='cuda', model_path=str(tmp_path) + '/r1/')
    r1.fit(X)
    Q = r1.transform(X)
    r2 = BernoulliRBM(n_visible=512, n_hidden=1024, dbm_last=True,
                      n_gibbs_steps=1, learning_rate=0.01, momentum=0.5,
                      max_epoch=20, batch_size=48, l2=1e-3, random_seed=66,
                      verbose=False, save_after_each_epoch=False,
                      device='cuda', model_path=str(tmp_path) + '/r2/')
    r2.fit(Q)
    dbm = DBM(rbms=[r1, r2], n_particles=100,
              v_particle_init=X[:100].copy(),
              h_particles_init=(Q[:100].copy(), r2.transform(Q[:100])),
              n_gibbs_steps=1, max_mf_updates=50, mf_tol=1e-7,
              learning_rate=2e-5, momentum=0.5, max_epoch=30,
              batch_size=100, l2=1e-7, max_norm=6., random_seed=1337,
              verbose=False, save_after_each_epoch=False,
              device='cuda', model_path=str(tmp_path) + '/dbm/')
    dbm.fit(X, X_val)

    lm_a, (lo_a, hi_a), _ = dbm.log_Z(n_betas=20000, n_runs=128,
                                      n_gibbs_steps=5)
    lm_b, (lo_b, hi_b), _ = dbm.log_Z(n_betas=20000, n_runs=128,
                                      n_gibbs_steps=5)
    print('log Z {0:.2f} [{1:.2f}, {2:.2f}]; {3:.2f} [{4:.2f}, {5:.2f}]'
          .format(lm_a, lo_a, hi_a, lm_b, lo_b, hi_b))
    assert abs(lm_a - lm_b) < 0.5
    assert (hi_a - lo_a) < 1.0


@requires_real_mnist
def test_dbm_mnist_published_logZ_and_elbo(tmp_path):
    """The full examples/torch_dbm_mnist.py recipe (RBM1 64 epochs, RBM2
    120 with the stepped CD-k/lr schedule, DBM 500 epochs), then AIS at
    200k betas: log Z-hat = 1040.39 +-0.5 and average test ELBO -86.37
    +-1 (reference README.md:192)."""
    out_npz = str(tmp_path / 'ais.npz')
    r = subprocess.run(
        [sys.executable, 'torch_dbm_mnist.py',
         '--rbm1-dirpath', str(tmp_path / 'r1') + '/',
         '--rbm2-dirpath', str(tmp_path / 'r2') + '/',
         '--dbm-dirpath', str(tmp_path / 'dbm') + '/',
         '--mlp-save-prefix', str(tmp_path / 'mlp_'),
         '--checkpoint-every', '50', '--summaries-every', '50',
         '--n-betas', '200000', '--n-ais-runs', '128',
         '--ais-save-path', out_npz],
        cwd=os.path.join(REPO, 'examples'), capture_output=True, text=True,
        timeout=7200)
    assert r.returncode == 0, r.stderr[-4000:]
    data = np.load(out_npz)
    log_Z, elbo = float(data['log_Z']), float(data['avg_test_elbo'])
    print('FULL torch_dbm_mnist: log Z {0:.2f} (target 1040.39 +-0.5), '
          'ELBO {1:.2f} (target -86.37 +-1)'.format(log_Z, elbo))
    assert abs(log_Z - 1040.39) <= 0.5
    assert abs(elbo - (-86.37)) <= 1.0


def test_cifar_naive_grbm_accuracy(tmp_path):
    """CIFAR gate: examples/torch_dbm_cifar_naive.py's G-RBM + fine-tune
    recipe (120 G-RBM epochs, the M-RBM and DBM stages skipped) must reach
    >= 58% test accuracy (reference README.md:256 reports 59.78%;
    tests/test_quality_parity.py:169 holds the JAX package to the same)."""
    if not (real_cifar_available() and torch.cuda.is_available()):
        pytest.skip('the CIFAR gate needs the genuine CIFAR-10 python '
                    'batches (data/cifar-10-batches-py/ or '
                    '$BMT_DATA_DIR/cifar-10-batches-py/) and a CUDA device')
    r = subprocess.run(
        [sys.executable, 'torch_dbm_cifar_naive.py',
         '--grbm-dirpath', str(tmp_path / 'grbm') + '/',
         '--mrbm-dirpath', str(tmp_path / 'mrbm') + '/',
         '--dbm-dirpath', str(tmp_path / 'dbm') + '/',
         '--mlp-save-prefix', str(tmp_path / 'mlp_'),
         '--checkpoint-every', '25', '--summaries-every', '25',
         '--epochs', '120', '0', '0'],  # G-RBM + fine-tune only
        cwd=os.path.join(REPO, 'examples'), capture_output=True, text=True,
        timeout=10800)
    assert r.returncode == 0, r.stderr[-4000:]
    with open(str(tmp_path / 'mlp_') + 'accuracy.json') as f:
        acc = json.load(f)['test_accuracy']
    print('CIFAR naive G-RBM fine-tuned accuracy: {0:.4f} '
          '(target >= 0.58)'.format(acc))
    assert acc >= 0.58
