"""``log_Z``'s options in the port (boltzmann_machines_tpu_torch): the
adaptive beta ladder, the base rate and BDMC, against the JAX package on the
CPU.  With sampling off, from the same state and start, the plain versions
of ``ops/dbm_ops.py`` (the forward run on any ladder with or without a base
rate, the reverse run, the burn-in of its start) against the JAX XLA
programs; then ``DBM.log_Z`` with sampling on against a brute-force log Z
on a 6-5-4 DBM, with the thresholds of tests/test_dbm.py:250-270 and
:319-362."""

import itertools

import jax
import numpy as np
import pytest
import torch

from boltzmann_machines_tpu import BernoulliRBM as JaxBernoulliRBM
from boltzmann_machines_tpu import DBM as JaxDBM
from boltzmann_machines_tpu.dbm import \
    make_beta_schedule as jax_make_beta_schedule
from boltzmann_machines_tpu_torch import BernoulliRBM, DBM
from boltzmann_machines_tpu_torch.dbm import make_beta_schedule
from boltzmann_machines_tpu_torch.ops.dbm_ops import (
    AISConfig, ais_reference, reverse_ais_reference)
from boltzmann_machines_tpu_torch.utils import RNG, log_sum_exp

V, H1, H2 = 6, 5, 4


@pytest.mark.parametrize('n', [1, 2, 3, 4, 7, 10, 200, 1000])
def test_make_beta_schedule_equals_jax(n):
    """Both ladders, bit for bit; anything else raises ValueError."""
    for kind in ('linear', 'adaptive'):
        want = jax_make_beta_schedule(n, kind)
        got = make_beta_schedule(n, kind)
        assert got.dtype == np.float64 and len(got) == n + 1
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        make_beta_schedule(n, 'quadratic')


def jax_and_port(tmp, sample=False):
    """A JAX DBM over pretrained JAX RBMs (6-5-4) with its state
    initialized, and the port's DBM over the same RBMs (loaded from their
    checkpoints) holding the same state."""
    X = (RNG(1337).rand(40, V) < 0.4).astype(np.float32)
    rk = dict(max_epoch=2, batch_size=8, verbose=False)
    r1 = JaxBernoulliRBM(n_visible=V, n_hidden=H1, dbm_first=True,
                         random_seed=1, model_path=tmp + 'r1/', **rk).fit(X)
    r2 = JaxBernoulliRBM(n_visible=H1, n_hidden=H2, dbm_last=True,
                         random_seed=2, model_path=tmp + 'r2/', **rk)
    r2.fit(r1.transform(X))
    cfg = dict(n_particles=4, n_gibbs_steps=1, max_mf_updates=10,
               learning_rate=0.01, momentum=0.5, max_epoch=1, batch_size=8,
               sample_v_states=sample, sample_h_states=[sample, sample],
               random_seed=3, verbose=False, save_after_each_epoch=False)
    jd = JaxDBM(rbms=[r1, r2], model_path=tmp + 'jd/', **cfg).fit(X)
    td = DBM(rbms=[BernoulliRBM.load_model(tmp + 'r1/', device='cpu'),
                   BernoulliRBM.load_model(tmp + 'r2/', device='cpu')],
             device='cpu', model_path=tmp + 'td/', **cfg)
    td._set_state_arrays(jd._get_state_arrays())
    return jd, td


@pytest.fixture(scope='module')
def models(tmp_path_factory):
    return jax_and_port(str(tmp_path_factory.mktemp('ais_opt')) + '/')


def base_rates(jd):
    """None, an array, and the model's hb0 ('hidden_bias')."""
    hb0 = np.asarray(jd._get_state_arrays()['weights/hb_0'])
    return {'none': None,
            'array': np.linspace(-1., 1., H1).astype(np.float32),
            'hidden_bias': hb0}


@pytest.mark.parametrize('base', ['none', 'array', 'hidden_bias'])
@pytest.mark.parametrize('kind', ['adaptive', 'linear'])
def test_forward_run_matches_jax(models, kind, base):
    """The forward run, sampling off, k = 2, 200 betas: ``ais_reference``
    (the float64 ladder in float32, the linear one in the JAX kernel's
    float32 arithmetic) plus log Z0 of the base distribution against
    ``_ais_program(betas, base_rate)``; atol 1e-4 (~1 ulp apart betas,
    sums of 400 log p~ terms of ~10 nats)."""
    jd, td = models
    b0 = base_rates(jd)[base]
    x0 = (np.random.RandomState(5).rand(10, H1) < 0.5).astype(np.float32)
    betas = jax_make_beta_schedule(200, kind)
    want = np.asarray(jd._ais_program(betas, b0)(
        jd._state, 2, jax.random.PRNGKey(0), x0))
    cfg = AISConfig(V, H1, H2, 200, 2, False, False, False,
                    None if kind == 'linear' else tuple(betas))
    tb0 = None if b0 is None else torch.tensor(b0)
    got = ais_reference(cfg, td._state.as_dict(), 9, torch.tensor(x0),
                        tb0).numpy() + td._ais_log_Z0(tb0)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize('base', ['none', 'array', 'hidden_bias'])
@pytest.mark.parametrize('kind', ['adaptive', 'linear'])
def test_reverse_run_matches_jax(models, kind, base):
    """The reverse run of BDMC, sampling off, k = 2, 200 betas:
    ``reverse_ais_reference`` against ``_reverse_ais_program``; atol 1e-4."""
    jd, td = models
    b0 = base_rates(jd)[base]
    x1 = (np.random.RandomState(6).rand(10, H1) < 0.5).astype(np.float32)
    betas = jax_make_beta_schedule(200, kind)
    want = np.asarray(jd._reverse_ais_program(betas, b0)(
        jd._state, 2, jax.random.PRNGKey(0), x1))
    cfg = AISConfig(V, H1, H2, 200, 2, False, False, False,
                    None if kind == 'linear' else tuple(betas))
    got = reverse_ais_reference(cfg, td._state.as_dict(), 9,
                                torch.tensor(x1),
                                None if b0 is None else torch.tensor(b0))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize('n_runs', [3, 10])
def test_model_h1_samples_match_jax(tmp_path, models, n_runs):
    """The reverse run's start: the particles' h1 tiled to n_runs.  Without
    burn-in equal to JAX's (binarized where h1 is sampled, means where
    not); with 5 burn-in steps at beta = 1, sampling off, within 1e-6."""
    jd, td = models
    for burn_in, tol in ((0, 0.), (5, 1e-6)):
        want = np.asarray(jd._model_h1_samples(n_runs, burn_in,
                                               jax.random.PRNGKey(0)))
        got = td._model_h1_samples(n_runs, burn_in, 11).numpy()
        assert got.shape == (n_runs, H1)
        np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    js, ts = jax_and_port(str(tmp_path) + '/', sample=True)
    want = np.asarray(js._model_h1_samples(n_runs, 0, jax.random.PRNGKey(0)))
    got = ts._model_h1_samples(n_runs, 0, 11).numpy()
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got)) <= {0., 1.}


# ------------------------------------------------------------------------ #
# DBM.log_Z against brute force (sampling on)                               #
# ------------------------------------------------------------------------ #
@pytest.fixture(scope='module')
def data():
    return (RNG(1337).rand(40, V) < 0.4).astype('float32')


def port_dbm(X, tmp, **kw):
    rk = dict(max_epoch=2, batch_size=8, verbose=False, device='cpu')
    r1 = BernoulliRBM(n_visible=V, n_hidden=H1, dbm_first=True,
                      random_seed=1, model_path=tmp + 'r1/', **rk).fit(X)
    r2 = BernoulliRBM(n_visible=H1, n_hidden=H2, dbm_last=True,
                      random_seed=2, model_path=tmp + 'r2/', **rk)
    r2.fit(r1.transform(X))
    cfg = dict(n_particles=16, n_gibbs_steps=2, max_mf_updates=20,
               mf_tol=1e-7, learning_rate=0.01, momentum=0.5, max_epoch=3,
               batch_size=8, max_norm=4., random_seed=3, verbose=False)
    cfg.update(kw)
    return DBM(rbms=[r1, r2], device='cpu', model_path=tmp + 'dbm/',
               **cfg).fit(X)


@pytest.fixture(scope='module')
def trained(tmp_path_factory, data):
    return port_dbm(data, str(tmp_path_factory.mktemp('ais_bf')) + '/')


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


@pytest.mark.parametrize('kw', [dict(beta_schedule='adaptive'),
                                dict(base_rate='hidden_bias'),
                                dict(base_rate=np.zeros(H1, np.float32))],
                         ids=['adaptive', 'hidden_bias', 'uniform_array'])
def test_options_match_bruteforce(trained, kw):
    """The adaptive ladder and both base rates within 0.1 nats of the
    enumerated log Z (tests/test_dbm.py:250-270)."""
    exact = exact_log_Z(trained)
    log_mean, _, values = trained.log_Z(n_betas=200, n_runs=64,
                                        n_gibbs_steps=1, **kw)
    assert values.shape == (64,) and np.all(np.isfinite(values))
    assert abs(log_mean - exact) < 0.1


def test_bdmc_brackets_exact_log_Z(trained):
    """BDMC: the forward estimate and the reverse run's upper bound bracket
    the enumerated log Z within 0.15, with a gap below 1
    (tests/test_dbm.py:319-339)."""
    exact = exact_log_Z(trained)
    log_mean, (low, up), info = trained.log_Z(
        n_betas=200, n_runs=64, n_gibbs_steps=1, bdmc=True, bdmc_burn_in=50)
    assert np.isfinite(low) and np.isfinite(up)
    assert low == pytest.approx(log_mean)
    assert info['forward'].shape == (64,) and info['reverse'].shape == (64,)
    assert info['log_Z_lower'] == low and info['log_Z_upper'] == up
    assert info['bdmc_gap'] == pytest.approx(up - low)
    assert low <= exact + 0.15
    assert up >= exact - 0.15
    assert info['bdmc_gap'] < 1.0


def test_bdmc_defined_on_peaked_model(data, tmp_path):
    """On an over-concentrated model the sigma-interval can be undefined,
    but the BDMC bounds are finite and ordered (tests/test_dbm.py:342-362)."""
    dbm = port_dbm(data, str(tmp_path) + '/')
    s = dbm.get_params_arrays()
    for k in ('weights/W_0', 'weights/W_1', 'weights/hb_0'):
        s[k] = s[k] * 12.
    dbm._set_state_arrays(s)
    _, _, info = dbm.log_Z(n_betas=100, n_runs=32, n_gibbs_steps=1,
                           bdmc=True, bdmc_burn_in=50)
    assert np.isfinite(info['log_Z_lower'])
    assert np.isfinite(info['log_Z_upper'])
    assert info['log_Z_upper'] >= info['log_Z_lower']


def test_bad_base_rate_raises(trained):
    for bad in ('visible_bias', np.zeros(H1 + 1, np.float32)):
        with pytest.raises(ValueError):
            trained.log_Z(n_betas=10, n_runs=8, base_rate=bad)
    with pytest.raises(ValueError):
        trained.log_Z(n_betas=10, n_runs=8, beta_schedule='quadratic')


def test_log_Z_repeats_from_the_same_rng_state(trained):
    """Every draw of a BDMC call (x0, the forward run, the burn-in, the
    reverse run) derives from the one seed the call takes from the host
    RNG: from the same RNG state a call repeats bit for bit."""
    state = trained._rng.get_state()
    a = trained.log_Z(n_betas=20, n_runs=8, n_gibbs_steps=1, bdmc=True,
                      bdmc_burn_in=5)[2]
    trained._rng.set_state(state)
    b = trained.log_Z(n_betas=20, n_runs=8, n_gibbs_steps=1, bdmc=True,
                      bdmc_burn_in=5)[2]
    np.testing.assert_array_equal(a['forward'], b['forward'])
    np.testing.assert_array_equal(a['reverse'], b['reverse'])
