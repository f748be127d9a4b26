"""The port's DBM (boltzmann_machines_tpu_torch) against the JAX package's on
the CPU -- fit, transform, reconstruct, log_proba with sampling off -- and
its own statistics with sampling on, mirroring tests/test_dbm.py: AIS
against a brute-force log Z, the variational bound, determinism,
save/load/resume, max-norm, and checkpoints that cross-load."""

import itertools
import json
import os

import numpy as np
import pytest
import torch

from boltzmann_machines_tpu import BernoulliRBM as JaxBernoulliRBM
from boltzmann_machines_tpu import DBM as JaxDBM
from boltzmann_machines_tpu_torch import BernoulliRBM, DBM, load_model
from boltzmann_machines_tpu_torch.utils import RNG, log_sum_exp

V, H1, H2 = 6, 5, 4


def read_scalars(logdir):
    with open(os.path.join(logdir, 'scalars.jsonl')) as f:
        return {(r['tag'], r['step']): r['value'] for r in map(json.loads, f)}


@pytest.fixture(scope='module')
def data():
    return (RNG(1337).rand(40, V) < 0.4).astype('float32')


def pretrain_rbms(X, tmp, seed=1):
    r1 = BernoulliRBM(n_visible=V, n_hidden=H1, dbm_first=True, max_epoch=2,
                      batch_size=8, random_seed=seed, verbose=False,
                      device='cpu', model_path=tmp + 'r1/')
    r1.fit(X)
    r2 = BernoulliRBM(n_visible=H1, n_hidden=H2, dbm_last=True, max_epoch=2,
                      batch_size=8, random_seed=seed + 1, verbose=False,
                      device='cpu', model_path=tmp + 'r2/')
    r2.fit(r1.transform(X))
    return r1, r2


def make_dbm(rbms, tmp, seed=3, **kw):
    cfg = dict(n_particles=16, n_gibbs_steps=2, max_mf_updates=20,
               mf_tol=1e-7, learning_rate=0.01, momentum=0.5, max_epoch=3,
               batch_size=8, max_norm=4., random_seed=seed, verbose=False)
    cfg.update(kw)
    return DBM(rbms=list(rbms), device='cpu', model_path=tmp + 'dbm/', **cfg)


@pytest.fixture(scope='module')
def trained(tmp_path_factory, data):
    tmp = str(tmp_path_factory.mktemp('tdbm')) + '/'
    dbm = make_dbm(pretrain_rbms(data, tmp), tmp)
    dbm.fit(data)
    return dbm, tmp


def exact_log_Z(dbm):
    """Enumerate h1; v and h2 summed out analytically."""
    s = dbm.get_params_arrays()
    W0, W1 = s['weights/W_0'], s['weights/W_1']
    vb, hb0, hb1 = s['weights/vb'], s['weights/hb_0'], s['weights/hb_1']
    H = np.array(list(itertools.product([0., 1.], repeat=W0.shape[1])))
    logp = H @ hb0
    logp = logp + np.log1p(np.exp(H @ W0.T + vb)).sum(1)
    logp = logp + np.log1p(np.exp(H @ W1 + hb1)).sum(1)
    return log_sum_exp(logp)


def test_fit_matches_jax(tmp_path):
    """The whole slice with sampling off: port DBM.fit against JAX DBM.fit
    (its XLA path on the CPU) from RBMs with the same weights (the port's
    loaded from the JAX checkpoints through the convert functions) and the
    same explicit particle inits, with a remainder batch, max-norm,
    per-layer sparsity, lr / momentum / k schedules, L2 and a validation
    set.  State atol 2e-5 (f32 sums in another order); the msre and
    n_mf_updates streams, transform, reconstruct and log_proba 1e-5."""
    d = str(tmp_path) + '/'
    rng = np.random.RandomState(0)
    X = (rng.rand(37, 12) < 0.4).astype(np.float32)    # 4 batches of 8 + 5
    X_val = (rng.rand(11, 12) < 0.4).astype(np.float32)
    jr1 = JaxBernoulliRBM(n_visible=12, n_hidden=8, dbm_first=True,
                          max_epoch=1, batch_size=8, random_seed=1,
                          verbose=False, model_path=d + 'r1/').fit(X)
    jr2 = JaxBernoulliRBM(n_visible=8, n_hidden=6, dbm_last=True,
                          max_epoch=1, batch_size=8, random_seed=2,
                          verbose=False, model_path=d + 'r2/')
    jr2.fit(jr1.transform(X))
    tr1 = BernoulliRBM.load_model(d + 'r1/', device='cpu')
    tr2 = BernoulliRBM.load_model(d + 'r2/', device='cpu')
    cfg = dict(n_particles=10,
               v_particle_init=rng.rand(10, 12).astype(np.float32),
               h_particles_init=(rng.rand(10, 8).astype(np.float32),
                                 rng.rand(10, 6).astype(np.float32)),
               n_gibbs_steps=[1, 2], max_mf_updates=10, mf_tol=1e-7,
               learning_rate=[0.05, 0.02, 0.01], momentum=[0.5, 0.9],
               max_epoch=3, batch_size=8, l2=1e-4, max_norm=1.5,
               sample_v_states=False, sample_h_states=[False, False],
               sparsity_target=[0.2, 0.1], sparsity_cost=[1e-2, 5e-3],
               train_metrics_every_iter=2, val_metrics_every_epoch=2,
               random_seed=3, verbose=False)
    jd = JaxDBM(rbms=[jr1, jr2], model_path=d + 'jd/', **cfg).fit(X, X_val)
    td = DBM(rbms=[tr1, tr2], device='cpu', model_path=d + 'td/',
             **cfg).fit(X, X_val)
    assert td.iter_ == jd.iter_ == 15 and td.epoch_ == 3

    sj, st = jd.get_params_arrays(), td.get_params_arrays()
    assert set(sj) == set(st) and len(st) == 17
    for key in sj:
        np.testing.assert_allclose(st[key], sj[key], atol=2e-5, err_msg=key)
    for sub in ('logs/train', 'logs/val'):
        a, b = read_scalars(d + 'jd/' + sub), read_scalars(d + 'td/' + sub)
        assert sorted(a) == sorted(b) and a
        for tag_step in a:
            np.testing.assert_allclose(b[tag_step], a[tag_step], rtol=0,
                                       atol=1e-5, err_msg=str(tag_step))
    np.testing.assert_allclose(td.transform(X_val), jd.transform(X_val),
                               atol=1e-5)
    np.testing.assert_allclose(td.reconstruct(X_val), jd.reconstruct(X_val),
                               atol=1e-5)
    np.testing.assert_allclose(td.log_proba(X_val, 3.),
                               jd.log_proba(X_val, 3.), atol=1e-5)


def test_fit_and_api(trained, data):
    dbm, _ = trained
    G = dbm.transform(data)
    assert G.shape == (len(data), H2) and G.dtype == np.float32
    assert np.all(G >= 0.) and np.all(G <= 1.)
    R = dbm.reconstruct(data)
    assert R.shape == data.shape
    assert np.mean((data - R) ** 2) < 0.3
    v = dbm.sample_v(n_gibbs_steps=3)
    assert v.shape == (dbm.n_particles, V)
    np.testing.assert_array_equal(
        dbm.get_params_arrays('negative_particles')['v'], v)
    assert dbm.iter_ == 15 and dbm.epoch_ == dbm.max_epoch


def test_stacking_init_two_layer(data, tmp_path):
    """hb0 = (hb(r1) + vb(r2)) / 2, W and hb1 untouched (JAX
    dbm.py:206-225)."""
    tmp = str(tmp_path) + '/'
    r1, r2 = pretrain_rbms(data, tmp)
    s = make_dbm((r1, r2), tmp).init().get_params_arrays('weights')
    w1, w2 = r1.get_params_arrays('weights'), r2.get_params_arrays('weights')
    np.testing.assert_array_equal(s['W_0'], w1['W'])
    np.testing.assert_array_equal(s['W_1'], w2['W'])
    np.testing.assert_allclose(s['hb_0'], 0.5 * w1['hb'] + 0.5 * w2['vb'],
                               rtol=1e-6)
    np.testing.assert_array_equal(s['hb_1'], w2['hb'])


def test_determinism(data, tmp_path):
    """Same seeds, sampling on: identical weights and transforms."""
    tmp = str(tmp_path) + '/'
    rbms = pretrain_rbms(data, tmp)
    d1 = make_dbm(rbms, tmp + 'a').fit(data)
    d2 = make_dbm(rbms, tmp + 'b').fit(data)
    s1, s2 = d1.get_params_arrays(), d2.get_params_arrays()
    for k in s1:
        np.testing.assert_array_equal(s1[k], s2[k], err_msg=k)
    np.testing.assert_array_equal(d1.transform(data), d2.transform(data))


def test_save_load_resume(trained, data, tmp_path):
    """Loaded without RBMs (layers rebuilt from ``layers_config_``): same
    transform and particles; resuming one epoch continues exactly as the
    model kept in memory."""
    dbm, tmp = trained
    dbm._save_model()
    dbm2 = DBM.load_model(tmp + 'dbm/', device='cpu')
    assert dbm2.epoch_ == dbm.epoch_ and dbm2.n_layers_ == 2
    assert dbm2.n_hiddens_ == [H1, H2]
    np.testing.assert_array_equal(dbm.transform(data), dbm2.transform(data))
    s1 = dbm.get_params_arrays('negative_particles')
    s2 = dbm2.get_params_arrays('negative_particles')
    for k in s1:
        np.testing.assert_array_equal(s1[k], s2[k])
    dbm3 = DBM.load_model(tmp + 'dbm/', device='cpu')
    dbm2.update_working_paths(model_path=str(tmp_path) + '/a/')
    dbm3.update_working_paths(model_path=str(tmp_path) + '/b/')
    for d in (dbm2, dbm3):
        d.set_params(max_epoch=d.max_epoch + 1).fit(data)
        assert d.epoch_ == dbm.max_epoch + 1
    s2, s3 = dbm2.get_params_arrays(), dbm3.get_params_arrays()
    for k in s2:
        np.testing.assert_array_equal(s2[k], s3[k], err_msg=k)


def test_ais_matches_bruteforce(trained):
    """AIS log Z within 0.1 nats of the enumerated value (sampling on)."""
    dbm, _ = trained
    exact = exact_log_Z(dbm)
    log_mean, (log_low, log_high), values = dbm.log_Z(
        n_betas=200, n_runs=64, n_gibbs_steps=1)
    assert values.shape == (64,)
    assert abs(log_mean - exact) < 0.1
    assert log_low <= log_mean <= log_high


def test_log_proba_is_lower_bound(trained, data):
    """The variational bound minus the exact log Z lower-bounds the exact
    marginal log-likelihood."""
    dbm, _ = trained
    exact = exact_log_Z(dbm)
    elbo = dbm.log_proba(data[:8], exact)
    s = dbm.get_params_arrays()
    W0, W1 = s['weights/W_0'], s['weights/W_1']
    vb, hb0, hb1 = s['weights/vb'], s['weights/hb_0'], s['weights/hb_1']
    H = np.array(list(itertools.product([0., 1.], repeat=H1)))
    for i in range(8):
        x = data[i]
        logp = H @ (W0.T @ x + hb0) + x @ vb
        logp = logp + np.log1p(np.exp(H @ W1 + hb1)).sum(1)
        assert elbo[i] <= log_sum_exp(logp) - exact + 1e-4


def test_max_norm_constraint(data, tmp_path):
    tmp = str(tmp_path) + '/'
    dbm = make_dbm(pretrain_rbms(data, tmp), tmp, max_norm=0.1,
                   learning_rate=0.5, max_epoch=2).fit(data)
    s = dbm.get_params_arrays('weights')
    for k in ('W_0', 'W_1'):
        assert np.all(np.linalg.norm(s[k], axis=0) <= 0.1 + 1e-5)


def test_unported_options_raise(trained, data, tmp_path):
    dbm, _ = trained
    for kw in (dict(beta_schedule='adaptive'), dict(base_rate='hidden_bias'),
               dict(bdmc=True)):
        with pytest.raises(NotImplementedError, match='ROADMAP'):
            dbm.log_Z(n_betas=10, n_runs=8, **kw)
    tmp = str(tmp_path) + '/'
    d = make_dbm(pretrain_rbms(data, tmp), tmp, display_particles=2)
    with pytest.raises(NotImplementedError, match='display'):
        d.fit(data)
    with pytest.raises(ValueError, match='pallas'):
        make_dbm(pretrain_rbms(data, tmp), tmp, kernel='pallas').fit(data)


def jax_trained(data, tmp):
    r1 = JaxBernoulliRBM(n_visible=V, n_hidden=H1, dbm_first=True,
                         max_epoch=2, batch_size=8, random_seed=1,
                         verbose=False, model_path=tmp + 'r1/').fit(data)
    r2 = JaxBernoulliRBM(n_visible=H1, n_hidden=H2, dbm_last=True,
                         max_epoch=2, batch_size=8, random_seed=2,
                         verbose=False, model_path=tmp + 'r2/')
    r2.fit(r1.transform(data))
    dbm = JaxDBM(rbms=[r1, r2], n_particles=16, n_gibbs_steps=1,
                 max_mf_updates=20, max_epoch=2, batch_size=8,
                 random_seed=3, verbose=False, model_path=tmp + 'dbm/')
    return dbm.fit(data)


def test_jax_checkpoint_loads_in_torch_then_load_rbms(data, tmp_path):
    """A JAX DBM checkpoint loads in the port (also through the
    class-dispatching loader); after ``load_rbms`` with the port's copies of
    the RBMs, transform and the particles are those of the JAX model."""
    tmp = str(tmp_path) + '/'
    jd = jax_trained(data, tmp)
    td = load_model(tmp + 'dbm/', device='cpu')
    assert isinstance(td, DBM) and td.epoch_ == jd.epoch_ == 2
    td.load_rbms([BernoulliRBM.load_model(tmp + 'r1/', device='cpu'),
                  BernoulliRBM.load_model(tmp + 'r2/', device='cpu')])
    sj, st = jd.get_params_arrays(), td.get_params_arrays()
    assert set(sj) == set(st)
    for k in sj:
        np.testing.assert_array_equal(st[k], sj[k], err_msg=k)
    np.testing.assert_allclose(td.transform(data), jd.transform(data),
                               atol=1e-6)
    assert td._serialize(td.get_params()) == jd._serialize(jd.get_params())


def test_torch_checkpoint_loads_in_jax(trained, data):
    """The port's checkpoint loads in the JAX package with the same state,
    transform and particles (the JAX ``load_rbms`` would discard a loaded
    state, so the JAX side rebuilds its layers from the config)."""
    dbm, tmp = trained
    dbm._save_model()
    jd = JaxDBM.load_model(tmp + 'dbm/')
    sj, st = jd.get_params_arrays(), dbm.get_params_arrays()
    for k in st:
        np.testing.assert_array_equal(np.asarray(sj[k]), st[k], err_msg=k)
    np.testing.assert_allclose(jd.transform(data), dbm.transform(data),
                               atol=1e-6)
    with open(tmp + 'dbm/params.json') as f:
        assert 'device' not in f.read()
    # the port's load_rbms keeps a loaded state
    td = DBM.load_model(tmp + 'dbm/', device='cpu')
    before = td.get_params_arrays()
    td.load_rbms(dbm._rbms)
    for k, v in td.get_params_arrays().items():
        np.testing.assert_array_equal(v, before[k], err_msg=k)
