"""The port's BernoulliRBM (boltzmann_machines_tpu_torch) against the JAX
package's, at a small size on the CPU, and its own seeded-determinism,
resume and learning checks (mirroring tests/test_rbm.py)."""

import json
import os

import numpy as np
import pytest

from boltzmann_machines_tpu import BernoulliRBM as JaxBernoulliRBM
from boltzmann_machines_tpu_torch import BernoulliRBM, logit_mean
from boltzmann_machines_tpu_torch.utils import RNG

N_VISIBLE, N_HIDDEN = 12, 8

RBM_CONFIG = dict(n_visible=N_VISIBLE, n_hidden=N_HIDDEN,
                  sample_v_states=True, sample_h_states=True,
                  verbose=False, random_seed=1337,
                  max_epoch=2, batch_size=6)


@pytest.fixture
def X():
    return RNG(seed=1337).rand(16, N_VISIBLE)


@pytest.fixture
def X_val():
    return RNG(seed=42).rand(8, N_VISIBLE)


def weights_of(rbm):
    return rbm.get_params_arrays(scope='weights')


def assert_weights_equal(a, b):
    wa, wb = weights_of(a), weights_of(b)
    for key in ('W', 'vb', 'hb'):
        np.testing.assert_array_equal(wa[key], wb[key])


def read_scalars(logdir):
    """(tag, step) -> value from a logdir's scalars.jsonl sidecar."""
    with open(os.path.join(logdir, 'scalars.jsonl')) as f:
        return {(r['tag'], r['step']): r['value'] for r in map(json.loads, f)}


def test_fit_matches_jax(tmp_path):
    """The whole slice: port fit against JAX fit (its XLA path on the CPU)
    with sampling off, an explicit W_init, a remainder batch, momentum and
    lr schedules, l2 and sparsity.  State atol 2e-5 (f32 sums in another
    order, as tests/test_pallas_ops.py:485); the msre / feg scalar streams
    and transform to 1e-5."""
    rng = np.random.RandomState(0)
    V, H = 20, 12
    X = (rng.rand(45, V) < 0.4).astype(np.float32)   # 5 batches of 8 + 5
    X_val = (rng.rand(13, V) < 0.4).astype(np.float32)
    cfg = dict(n_visible=V, n_hidden=H, W_init=rng.randn(V, H) * 0.1,
               vb_init=logit_mean(X), hb_init=-0.5, batch_size=8,
               max_epoch=3, learning_rate=[0.05, 0.1, 0.02],
               momentum=[0.5, 0.9], l2=1e-4, sparsity_target=0.1,
               sparsity_cost=1e-2, sparsity_damping=0.9,
               sample_v_states=False, sample_h_states=False,
               metrics_config=dict(msre=True, l2_loss=True, feg=True,
                                   train_metrics_every_iter=2,
                                   feg_every_epoch=1, n_batches_for_feg=2),
               random_seed=3, verbose=False)
    pj, pt = str(tmp_path) + '/jax/', str(tmp_path) + '/torch/'
    jrbm = JaxBernoulliRBM(model_path=pj, **cfg).fit(X, X_val)
    trbm = BernoulliRBM(device='cpu', model_path=pt, **cfg).fit(X, X_val)
    assert trbm.iter_ == jrbm.iter_ == 18 and trbm.epoch_ == 3

    sj, st = jrbm.get_params_arrays(), trbm.get_params_arrays()
    assert set(sj) == set(st) and len(st) == 7
    for key in sj:
        np.testing.assert_allclose(st[key], sj[key], atol=2e-5, err_msg=key)
    for sub in ('logs/train', 'logs/val'):
        a, b = read_scalars(pj + sub), read_scalars(pt + sub)
        assert sorted(a) == sorted(b) and a
        for tag_step in a:
            np.testing.assert_allclose(b[tag_step], a[tag_step], rtol=1e-5,
                                       atol=1e-5, err_msg=str(tag_step))
    np.testing.assert_allclose(trbm.transform(X_val), jrbm.transform(X_val),
                               atol=1e-5)


@pytest.mark.parametrize('doubling', ['dbm_first', 'dbm_last'])
def test_dbm_pretraining_fit_matches_jax(tmp_path, doubling):
    """The pretraining half of the DBM slice: a fit with the input and bias
    doubling of `doubling` and a per-epoch CD-k schedule, sampling off,
    against JAX (state atol 2e-5, transform 1e-5)."""
    rng = np.random.RandomState(2)
    V, H = 20, 12
    X = (rng.rand(44, V) < 0.4).astype(np.float32)   # 5 batches of 8 + 4
    cfg = dict(n_visible=V, n_hidden=H, W_init=rng.randn(V, H) * 0.1,
               batch_size=8, max_epoch=4, n_gibbs_steps=[1, 1, 2, 2],
               learning_rate=0.05, momentum=[0.5, 0.9], l2=1e-4,
               sample_v_states=False, sample_h_states=False,
               random_seed=4, verbose=False, **{doubling: True})
    jrbm = JaxBernoulliRBM(model_path=str(tmp_path) + '/j/', **cfg).fit(X)
    trbm = BernoulliRBM(device='cpu', model_path=str(tmp_path) + '/t/',
                        **cfg).fit(X)
    assert trbm.iter_ == jrbm.iter_ == 24
    for key, v in jrbm.get_params_arrays().items():
        np.testing.assert_allclose(trbm.get_params_arrays()[key], v,
                                   atol=2e-5, err_msg=key)
    np.testing.assert_allclose(trbm.transform(X), jrbm.transform(X),
                               atol=1e-5)


def test_fewer_rows_than_a_batch_matches_jax(tmp_path):
    """No full batch: each epoch trains on the remainder alone, in both
    packages (base_rbm.py:1005-1008)."""
    rng = np.random.RandomState(1)
    X = (rng.rand(5, 10) < 0.5).astype(np.float32)
    cfg = dict(n_visible=10, n_hidden=6, W_init=rng.randn(10, 6) * 0.1,
               batch_size=8, max_epoch=2, sample_h_states=False,
               random_seed=1, verbose=False)
    jrbm = JaxBernoulliRBM(model_path=str(tmp_path) + '/j/', **cfg).fit(X)
    trbm = BernoulliRBM(device='cpu', model_path=str(tmp_path) + '/t/',
                        **cfg).fit(X)
    assert trbm.iter_ == jrbm.iter_ == 2
    for key, v in jrbm.get_params_arrays().items():
        np.testing.assert_allclose(trbm.get_params_arrays()[key], v,
                                   atol=2e-5, err_msg=key)


def test_consistency(X, X_val, tmp_path):
    """Same-seed models are bitwise-identical through fit, extra fit,
    reload-from-disk and another fit; sampling on (tests/test_rbm.py:73)."""
    d = str(tmp_path) + '/'
    r1 = BernoulliRBM(device='cpu', model_path=d + 'r1/', **RBM_CONFIG)
    r2 = BernoulliRBM(device='cpu', model_path=d + 'r2/', **RBM_CONFIG)
    r1.fit(X)
    r2.fit(X)
    assert_weights_equal(r1, r2)
    H1, H2 = r1.transform(X_val), r2.transform(X_val)
    assert H1.shape == (len(X_val), N_HIDDEN)
    np.testing.assert_array_equal(H1, H2)

    r1.set_params(max_epoch=r1.max_epoch + 1).fit(X)
    r2.set_params(max_epoch=r2.max_epoch + 1).fit(X)
    assert_weights_equal(r1, r2)

    r1 = BernoulliRBM.load_model(d + 'r1/', device='cpu')
    r2 = BernoulliRBM.load_model(d + 'r2/', device='cpu')
    assert_weights_equal(r1, r2)
    np.testing.assert_array_equal(r1.transform(X_val), r2.transform(X_val))

    r1.set_params(max_epoch=r1.max_epoch + 1).fit(X)
    r2.set_params(max_epoch=r2.max_epoch + 1).fit(X)
    assert_weights_equal(r1, r2)
    np.testing.assert_array_equal(r1.transform(X_val), r2.transform(X_val))


def test_resume_is_trajectory_identical(X, X_val, tmp_path):
    """A model saved after its first fit and loaded back continues exactly
    as the one kept in memory (the host RNG state is persisted)."""
    d = str(tmp_path) + '/'
    cfg = dict(RBM_CONFIG, metrics_config=dict(msre=True, pll=True,
                                               train_metrics_every_iter=2))
    a = BernoulliRBM(device='cpu', model_path=d + 'a/', **cfg).fit(X, X_val)
    b = BernoulliRBM.load_model(d + 'a/', device='cpu')
    b.update_working_paths(model_path=d + 'b/')
    a.set_params(max_epoch=4).fit(X, X_val)
    b.set_params(max_epoch=4).fit(X, X_val)
    assert_weights_equal(a, b)
    assert a.iter_ == b.iter_ == 12 and a.epoch_ == b.epoch_ == 4
    sa, sb = a.get_params_arrays(), b.get_params_arrays()
    for key in sa:
        np.testing.assert_array_equal(sa[key], sb[key], err_msg=key)


def test_learning_decreases_msre(tmp_path):
    """CD-1 on separable binary data must reduce reconstruction error
    (tests/test_rbm.py:209)."""
    rng = RNG(seed=7)
    protos = (rng.rand(2, N_VISIBLE) < 0.5).astype(float)
    X = protos[rng.randint(0, 2, 128)]
    flip = rng.rand(*X.shape) < 0.05
    X = np.abs(X - flip)

    def recon_msre(rbm):
        w = weights_of(rbm)
        Hm = 1. / (1. + np.exp(-(X @ w['W'] + w['hb'])))
        Vm = 1. / (1. + np.exp(-(Hm @ w['W'].T + w['vb'])))
        return float(np.mean((X - Vm) ** 2))

    rbm = BernoulliRBM(device='cpu', n_visible=N_VISIBLE, n_hidden=N_HIDDEN,
                       max_epoch=1, batch_size=16, learning_rate=0.1,
                       momentum=0.5, l2=0., random_seed=1337, verbose=False,
                       save_after_each_epoch=False,
                       metrics_config=dict(msre=True,
                                           train_metrics_every_iter=1),
                       model_path=str(tmp_path) + '/')
    rbm.fit(X)
    msre_after_1 = recon_msre(rbm)
    rbm.set_params(max_epoch=30)
    rbm.fit(X)
    assert recon_msre(rbm) < msre_after_1

    fe_trained = rbm.free_energy(X)
    fe_random = rbm.free_energy(
        (RNG(3).rand(128, N_VISIBLE) < 0.5).astype(float))
    assert fe_trained < fe_random


def test_init_from(X, tmp_path):
    """Weights, accumulators and progress attributes are copied
    (tests/test_rbm.py:246)."""
    d = str(tmp_path) + '/'
    r1 = BernoulliRBM(device='cpu', model_path=d + 'r1/', **RBM_CONFIG)
    r1.fit(X)
    r2 = BernoulliRBM(device='cpu', model_path=d + 'r2/', **RBM_CONFIG)
    r2.init_from(r1)
    r2.init()
    assert_weights_equal(r1, r2)
    a1 = r1.get_params_arrays('grads_accumulators')
    a2 = r2.get_params_arrays('grads_accumulators')
    np.testing.assert_array_equal(a1['dW'], a2['dW'])
    assert r2.epoch_ == r1.epoch_ and r2.iter_ == r1.iter_

    class Other(BernoulliRBM):
        pass

    with pytest.raises(ValueError):
        Other(n_visible=N_VISIBLE, n_hidden=N_HIDDEN,
              device='cpu').init_from(r1)


def test_display_summaries_raise(X, tmp_path):
    """Image summaries are ported: asking for them no longer raises, and
    the fit writes the filter grid and the hidden-activation image
    (tests/test_torch_summaries.py holds them against the JAX package)."""
    rbm = BernoulliRBM(device='cpu', n_visible=N_VISIBLE, n_hidden=N_HIDDEN,
                       display_filters=2, display_hidden_activations=3,
                       v_shape=(3, 4), verbose=False,
                       metrics_config=dict(msre=True,
                                           train_metrics_every_iter=1),
                       model_path=str(tmp_path) + '/')
    rbm.fit(X)
    logdir = rbm._train_summary_dirpath
    data = b''.join(open(os.path.join(logdir, p), 'rb').read()
                    for p in os.listdir(logdir) if p.startswith('events'))
    assert b'W_filters' in data and b'hidden_activation_means' in data
