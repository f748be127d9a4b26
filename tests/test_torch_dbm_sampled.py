"""Sampled DBM learning, the port against the JAX package on the CPU.

``tests/test_torch_dbm.py::test_fit_matches_jax`` holds the two packages'
``DBM.fit`` together with sampling off, state by state.  With the particles
sampled (``sample_v_states=True``, ``sample_h_states=[True, True]``) their
draws differ (a Philox stream against ``jax.random``), so no single fit can
be compared draw by draw (ROADMAP Queue C9).  Here each package fits the
same 12-8-6 DBM, from the same pretrained RBMs (the port's loaded from the
JAX checkpoints), on the same data, at five seeds; the two packages' means
over the seeds of the final validation msre and of mean |W_0 - W_0 at
init| must agree within 3 standard errors of their difference.

The spread over the seeds is held too: the ratio of the two packages'
variances of mean |W_0 - W_0 at init| must lie within the 0.1% and 99.9%
points of F(4, 4).  A port whose negative phase is wrong fails: particle
statistics not divided by the number of particles move the mean by many
standard errors; particles taken as means instead of states leave the fits
almost deterministic, so their spread collapses (a scratch copy of the
port with each fault planted fails here).
"""

import numpy as np
import pytest

from boltzmann_machines_tpu import BernoulliRBM as JaxBernoulliRBM
from boltzmann_machines_tpu import DBM as JaxDBM
from boltzmann_machines_tpu_torch import BernoulliRBM, DBM

SEEDS = range(5)
#: F(4, 4)'s 99.9% point: the variance ratio of two samples of 5
F_999 = 53.44
CFG = dict(n_particles=16, n_gibbs_steps=1, max_mf_updates=10, mf_tol=1e-7,
           learning_rate=0.05, momentum=0.5, max_epoch=4, batch_size=8,
           l2=1e-4, sample_v_states=True, sample_h_states=[True, True],
           verbose=False)


def summary(dbm, X_val, W0_init):
    """(final validation msre, mean |W_0 - W_0 at init|) of a fitted DBM."""
    W0 = dbm.get_params_arrays()['weights/W_0']
    msre = float(np.mean((X_val - dbm.reconstruct(X_val)) ** 2))
    return msre, float(np.mean(np.abs(W0 - W0_init)))


@pytest.fixture(scope='module')
def sampled_fits(tmp_path_factory):
    """{package: (n_seeds, 2) array of summary() over SEEDS}."""
    d = str(tmp_path_factory.mktemp('dbm_sampled')) + '/'
    rng = np.random.RandomState(0)
    X = (rng.rand(64, 12) < 0.4).astype(np.float32)
    X_val = (rng.rand(32, 12) < 0.4).astype(np.float32)
    jr1 = JaxBernoulliRBM(n_visible=12, n_hidden=8, dbm_first=True,
                          max_epoch=1, batch_size=8, random_seed=1,
                          verbose=False, model_path=d + 'r1/').fit(X)
    jr2 = JaxBernoulliRBM(n_visible=8, n_hidden=6, dbm_last=True,
                          max_epoch=1, batch_size=8, random_seed=2,
                          verbose=False, model_path=d + 'r2/')
    jr2.fit(jr1.transform(X))
    tr1 = BernoulliRBM.load_model(d + 'r1/', device='cpu')
    tr2 = BernoulliRBM.load_model(d + 'r2/', device='cpu')
    W0_init = jr1.get_params_arrays()['weights/W']
    out = {'jax': [], 'torch': []}
    for seed in SEEDS:
        jd = JaxDBM(rbms=[jr1, jr2], model_path=d + 'jd%d/' % seed,
                    random_seed=seed, **CFG).fit(X, X_val)
        td = DBM(rbms=[tr1, tr2], device='cpu', model_path=d + 'td%d/' % seed,
                 random_seed=seed, **CFG).fit(X, X_val)
        out['jax'].append(summary(jd, X_val, W0_init))
        out['torch'].append(summary(td, X_val, W0_init))
    return {k: np.array(v) for k, v in out.items()}


@pytest.mark.parametrize('stat', ['val_msre', 'mean_abs_dW0'])
def test_sampled_fit_matches_jax_in_distribution(sampled_fits, stat):
    col = ('val_msre', 'mean_abs_dW0').index(stat)
    a, b = sampled_fits['jax'][:, col], sampled_fits['torch'][:, col]
    assert np.all(np.isfinite(a)) and np.all(np.isfinite(b))
    se = np.sqrt(a.var(ddof=1) / len(a) + b.var(ddof=1) / len(b))
    assert abs(b.mean() - a.mean()) <= 3. * se, (
        '%s: JAX %.5g +- %.2g, port %.5g +- %.2g over %d seeds' % (
            stat, a.mean(), a.std(ddof=1), b.mean(), b.std(ddof=1), len(a)))


def test_sampled_fit_spread_matches_jax(sampled_fits):
    a, b = sampled_fits['jax'][:, 1], sampled_fits['torch'][:, 1]
    ratio = b.var(ddof=1) / a.var(ddof=1)
    assert 1. / F_999 <= ratio <= F_999, (
        'variance of mean |dW0| over the seeds: port / JAX = %.3g' % ratio)


# The same checks for the CIFAR pipelines' Gaussian-Bernoulli-Multinomial
# DBM: Gaussian v 12 with a per-unit sigma other than 1, Bernoulli 8,
# multinomial 6 with n 5; the port's draws through the standalone
# samplers' plain versions (ops/dbm_ops.py ``unit_draw``), JAX's through
# its layers' ``sample``.
GBM_SIGMA = np.linspace(0.5, 2., 12).astype(np.float32)


@pytest.fixture(scope='module')
def sampled_gbm_fits(tmp_path_factory):
    """{package: (n_seeds, 2) array of summary() over SEEDS} of the G-B-M
    DBM."""
    from boltzmann_machines_tpu import GaussianRBM as JaxGaussianRBM
    from boltzmann_machines_tpu import MultinomialRBM as JaxMultinomialRBM
    from boltzmann_machines_tpu_torch import GaussianRBM, MultinomialRBM
    d = str(tmp_path_factory.mktemp('dbm_gbm_sampled')) + '/'
    rng = np.random.RandomState(0)
    X = rng.randn(64, 12).astype(np.float32)
    X_val = rng.randn(32, 12).astype(np.float32)
    jr1 = JaxGaussianRBM(n_visible=12, n_hidden=8, sigma=GBM_SIGMA.tolist(),
                         dbm_first=True, max_epoch=1, batch_size=8,
                         random_seed=1, verbose=False,
                         model_path=d + 'r1/').fit(X)
    jr2 = JaxMultinomialRBM(n_visible=8, n_hidden=6, n_samples=5,
                            dbm_last=True, max_epoch=1, batch_size=8,
                            random_seed=2, verbose=False,
                            model_path=d + 'r2/')
    jr2.fit(jr1.transform(X))
    tr1 = GaussianRBM.load_model(d + 'r1/', device='cpu')
    tr2 = MultinomialRBM.load_model(d + 'r2/', device='cpu')
    W0_init = jr1.get_params_arrays()['weights/W']
    cfg = dict(CFG, learning_rate=0.01)
    out = {'jax': [], 'torch': []}
    for seed in SEEDS:
        jd = JaxDBM(rbms=[jr1, jr2], model_path=d + 'jd%d/' % seed,
                    random_seed=seed, **cfg).fit(X, X_val)
        td = DBM(rbms=[tr1, tr2], device='cpu', model_path=d + 'td%d/' % seed,
                 random_seed=seed, **cfg).fit(X, X_val)
        out['jax'].append(summary(jd, X_val, W0_init))
        out['torch'].append(summary(td, X_val, W0_init))
    return {k: np.array(v) for k, v in out.items()}


@pytest.mark.parametrize('stat', ['val_msre', 'mean_abs_dW0'])
def test_sampled_gbm_fit_matches_jax_in_distribution(sampled_gbm_fits,
                                                     stat):
    test_sampled_fit_matches_jax_in_distribution(sampled_gbm_fits, stat)


def test_sampled_gbm_fit_spread_matches_jax(sampled_gbm_fits):
    test_sampled_fit_spread_matches_jax(sampled_gbm_fits)
