"""DBMs with Gaussian, Bernoulli and multinomial layers (the CIFAR
pipelines' Gaussian-Bernoulli-Multinomial DBM), the port against the JAX
package on the CPU at small widths: Gaussian v 12 with a per-unit sigma
other than 1, Bernoulli 10, multinomial 6 with n 5.

* sampling off: ``DBM.fit`` of both packages from the same stacked RBMs
  (the port's loaded from the JAX checkpoints) and batches, state by
  state, the msre / n_mf rows of training and validation, ``transform``,
  ``reconstruct`` and ``sample_v(n)``, over layouts that pin each unit kind
  in each position it can take;
* one sweep's draws per unit kind, in moments (Gaussian residual variance
  sigma^2, multinomial row sums n), and the key of every draw its own;
* checkpoints both ways, ``log_Z`` / ``log_proba`` refused as in JAX, the
  image summaries at v_shape (32, 32, 3), and ``utils.augmentation`` equal
  to the JAX package's.

The sampled fit against JAX in distribution is in
tests/test_torch_dbm_sampled.py."""

import json
import os

import numpy as np
import pytest
import torch

from boltzmann_machines_tpu import BernoulliRBM as JaxBernoulliRBM
from boltzmann_machines_tpu import DBM as JaxDBM
from boltzmann_machines_tpu import GaussianRBM as JaxGaussianRBM
from boltzmann_machines_tpu import MultinomialRBM as JaxMultinomialRBM
from boltzmann_machines_tpu.utils import augmentation as jax_augmentation
from boltzmann_machines_tpu_torch import (DBM, BernoulliRBM, GaussianLayer,
                                          GaussianRBM, MultinomialLayer,
                                          MultinomialRBM, BernoulliLayer,
                                          load_model)
from boltzmann_machines_tpu_torch.ops import dbm_ops, samplers
from boltzmann_machines_tpu_torch.utils import augmentation

V, N_SAMPLES = 12, 5
#: a per-unit sigma other than 1, so that a division by sigma copied from
#: GaussianRBM into the DBM shows
SIGMA = np.linspace(0.5, 2., V).astype(np.float32)

# an RBM of a layout: (its hidden unit kind, JAX class, port class, kwargs)
G = ('G', JaxGaussianRBM, GaussianRBM, dict(sigma=SIGMA.tolist(),
                                            dbm_first=True))
B_FIRST = ('B', JaxBernoulliRBM, BernoulliRBM, dict(dbm_first=True))
M = ('M', JaxMultinomialRBM, MultinomialRBM, dict(n_samples=N_SAMPLES))
B_LAST = ('B', JaxBernoulliRBM, BernoulliRBM, dict(dbm_last=True))
M_LAST = ('M', JaxMultinomialRBM, MultinomialRBM,
          dict(n_samples=N_SAMPLES, dbm_last=True))
#: each layout's RBM stack and hidden widths; the DBM's layers are the
#: first RBM's visible layer and every RBM's hidden layer
LAYOUTS = {
    'G-B-M': ((G, M_LAST), (10, 6)),
    'G-B-B': ((G, B_LAST), (10, 6)),
    'B-B-M': ((B_FIRST, M_LAST), (10, 6)),
    # a multinomial layer below the top: its mean-field init doubles the
    # product inside the softmax
    'G-B-M-B': ((G, M, B_LAST), (10, 6, 4)),
}


def data(kind, n, seed):
    rng = np.random.RandomState(seed)
    if kind == 'G':
        return rng.randn(n, V).astype(np.float32)
    return (rng.rand(n, V) < 0.4).astype(np.float32)


def pretrain(layout, X, d):
    """The JAX RBMs of `layout` fitted one epoch each, and the port's
    copies loaded from their checkpoints."""
    stack, hiddens = LAYOUTS[layout]
    jr, tr = [], []
    Q, n_in = X, V
    for i, ((_, jcls, tcls, kw), nh) in enumerate(zip(stack, hiddens)):
        path = d + 'r%d/' % i
        r = jcls(n_visible=n_in, n_hidden=nh, max_epoch=1, batch_size=8,
                 random_seed=i + 1, verbose=False, model_path=path, **kw)
        r.fit(Q)
        jr.append(r)
        tr.append(tcls.load_model(path, device='cpu'))
        Q = r.transform(Q)
        if isinstance(r, JaxMultinomialRBM):
            Q = (Q > 1. / nh).astype(np.float32)
        n_in = nh
    return jr, tr


def dbm_cfg(layout, rng, **kw):
    """Sampling off, explicit particle inits (the CIFAR scripts'), a
    remainder batch, lr / momentum / k schedules, L2, max-norm, per-layer
    sparsity, validation every 2 epochs."""
    stack, hiddens = LAYOUTS[layout]
    L = len(hiddens)

    def init(kind, n):
        if kind == 'G':
            return rng.randn(10, n).astype(np.float32)
        p = rng.rand(10, n).astype(np.float32)
        return N_SAMPLES * p / p.sum(1, keepdims=True) if kind == 'M' else p

    cfg = dict(n_particles=10, v_particle_init=init(stack[0][0], V),
               h_particles_init=tuple(init(s[0], h) for s, h in
                                      zip(stack, hiddens)),
               n_gibbs_steps=[1, 2], max_mf_updates=10, mf_tol=1e-7,
               learning_rate=[0.05, 0.02, 0.01], momentum=[0.5, 0.9],
               max_epoch=3, batch_size=8, l2=1e-4, max_norm=1.5,
               sample_v_states=False, sample_h_states=[False] * L,
               sparsity_target=[0.2, 0.1, 0.3][:L],
               sparsity_cost=[1e-2, 5e-3, 1e-3][:L],
               train_metrics_every_iter=2, val_metrics_every_epoch=2,
               random_seed=3, verbose=False)
    cfg.update(kw)
    return cfg


def read_scalars(logdir):
    with open(os.path.join(logdir, 'scalars.jsonl')) as f:
        return {(r['tag'], r['step']): r['value'] for r in map(json.loads, f)}


@pytest.mark.parametrize('layout', sorted(LAYOUTS))
def test_fit_matches_jax(tmp_path, layout):
    """Sampling off: every state field within atol 5e-5 (f32 sums in
    another order over 15 steps; the multinomial layer's counts are n = 5
    times probabilities), the msre rows of training and validation within
    5e-5 (relative to the msre, which a Gaussian layer puts at ~1), the
    n_mf_updates rows within 1 sweep (a change of counts near n = 5 moves
    in ulps of 4.8e-7, above mf_tol 1e-7, so mean-field stops where a sweep
    changes nothing, and the two sum orders may reach that a sweep apart;
    the extra sweep moves no mean by more than a few ulps), transform,
    reconstruct and sample_v(3) within 5e-5."""
    d = str(tmp_path) + '/'
    stack = LAYOUTS[layout][0]
    X = data(stack[0][0], 37, 0)                     # 4 batches of 8 + 5
    X_val = data(stack[0][0], 11, 1)
    jr, tr = pretrain(layout, X, d)
    rng = np.random.RandomState(2)
    cfg = dbm_cfg(layout, rng)
    jd = JaxDBM(rbms=jr, model_path=d + 'jd/', **cfg).fit(X, X_val)
    td = DBM(rbms=tr, device='cpu', model_path=d + 'td/', **cfg).fit(
        X, X_val)
    assert td.iter_ == jd.iter_ == 15
    assert td.layers_config_ == jd.layers_config_
    assert [type(u).__name__[0] for u in td._units()] == \
        layout.split('-')

    sj, st = jd.get_params_arrays(), td.get_params_arrays()
    assert set(sj) == set(st)
    for key in sj:
        np.testing.assert_allclose(st[key], sj[key], atol=5e-5, err_msg=key)
    for sub in ('logs/train', 'logs/val'):
        a, b = read_scalars(d + 'jd/' + sub), read_scalars(d + 'td/' + sub)
        assert sorted(a) == sorted(b) and a
        for tag_step in a:
            atol = 1. if tag_step[0] == 'n_mf_updates' else 5e-5
            np.testing.assert_allclose(b[tag_step], a[tag_step], rtol=5e-5,
                                       atol=atol, err_msg=str(tag_step))
    np.testing.assert_allclose(td.transform(X_val), jd.transform(X_val),
                               atol=5e-5)
    np.testing.assert_allclose(td.reconstruct(X_val), jd.reconstruct(X_val),
                               atol=5e-5)
    np.testing.assert_allclose(td.sample_v(3), jd.sample_v(3), atol=5e-5)


def test_gaussian_layer_takes_inputs_raw(tmp_path):
    """The DBM's Gaussian layer: reconstruction means mu0 W0^T sigma + vb
    on raw X (GaussianRBM divides its inputs by sigma; the DBM does not)."""
    d = str(tmp_path) + '/'
    X = data('G', 16, 0)
    _, tr = pretrain('G-B-M', X, d)
    td = DBM(rbms=tr, n_particles=4, max_mf_updates=10, batch_size=8,
             device='cpu', model_path=d + 'td/', random_seed=1)
    s = td.init().get_params_arrays()
    mu, _ = td._mf(torch.as_tensor(X))
    want = mu[0].numpy() @ s['weights/W_0'].T * SIGMA + s['weights/vb']
    np.testing.assert_allclose(td.reconstruct(X), want, rtol=1e-5, atol=1e-5)
    T0 = X @ s['weights/W_0']
    assert not np.allclose(T0, (X / SIGMA) @ s['weights/W_0'], atol=1e-3)


def test_one_sweep_draws_per_unit_kind():
    """One sampled sweep of a G-B-M stack through the samplers' plain
    versions: Gaussian states are means + sigma eps (residuals of variance
    sigma^2 per unit), multinomial rows sum to n, Bernoulli states are 0 / 1
    with their means' rate; each layer's key its own."""
    rng = np.random.RandomState(0)
    M_ = 4000
    units = (GaussianLayer(V, sigma=SIGMA), BernoulliLayer(10),
             MultinomialLayer(6, n_samples=N_SAMPLES))
    W = (torch.as_tensor(0.3 * rng.randn(V, 10), dtype=torch.float32),
         torch.as_tensor(0.3 * rng.randn(10, 6), dtype=torch.float32))
    vb = torch.as_tensor(rng.randn(V), dtype=torch.float32)
    hb = (torch.as_tensor(rng.randn(10), dtype=torch.float32),
          torch.as_tensor(rng.randn(6), dtype=torch.float32))
    v = torch.as_tensor(rng.randn(M_, V), dtype=torch.float32)
    H = (torch.as_tensor((rng.rand(M_, 10) < 0.5), dtype=torch.float32),
         torch.zeros(M_, 6))
    keys = {}

    def key_of(l):
        keys[l] = dbm_ops.draw_key(7, 1, 0, l)
        return keys[l]

    draw = dbm_ops.unit_draw(units, True, (True, True), key_of,
                             reference=True)
    vn, (h0, h1) = dbm_ops.gibbs_sweep(W, vb, hb, v, H, draw, units)
    assert len(set(keys.values())) == 3
    # the means the draws were made from
    p0 = torch.sigmoid(v @ W[0] + H[1] @ W[1].T + hb[0])
    m1 = N_SAMPLES * torch.softmax(h0 @ W[1] + hb[1], dim=1)
    mv = h0 @ W[0].T * torch.as_tensor(SIGMA) + vb
    assert set(torch.unique(h0).tolist()) <= {0., 1.}
    assert abs(float(h0.mean() - p0.mean())) < 4. * 0.5 / np.sqrt(h0.numel())
    assert bool((h1.sum(1) == N_SAMPLES).all())
    assert bool((h1 == h1.round()).all())
    np.testing.assert_allclose(h1.mean(0).numpy(), m1.mean(0).numpy(),
                               atol=0.1)
    resid = ((vn - mv) / torch.as_tensor(SIGMA)).numpy()
    # per-unit variance 1 within 4 standard errors (sqrt(2 / M) for normals)
    assert np.all(np.abs(resid.var(0) - 1.) < 4. * np.sqrt(2. / M_))
    assert np.all(np.abs(resid.mean(0)) < 4. / np.sqrt(M_))
    # the same keys through sample_states give the same states
    np.testing.assert_array_equal(
        dbm_ops.sample_states(units[2], m1, keys[1], reference=True).numpy(),
        h1.numpy())
    eps = samplers.normal_sample_reference(keys[2], (M_, V))
    np.testing.assert_allclose((vn - mv).numpy(),
                               (eps * torch.as_tensor(SIGMA)).numpy(),
                               atol=1e-5)


def test_draw_keys_differ_across_the_fit():
    """No two (seed, iteration, sweep, layer) of a fit share a key."""
    keys = {dbm_ops.draw_key(s, it, sw, l) for s in (0, 1)
            for it in range(1, 40) for sw in range(3) for l in range(3)}
    assert len(keys) == 2 * 39 * 3 * 3


@pytest.mark.parametrize('layout', ['G-B-M', 'B-B-M'])
def test_checkpoints_cross_load(tmp_path, layout):
    """A JAX G-B-M checkpoint (layers_config_ with a per-unit sigma list and
    n_samples) loads in the port, with the same state and transform; the
    port's loads in the JAX package."""
    d = str(tmp_path) + '/'
    stack = LAYOUTS[layout][0]
    X = data(stack[0][0], 24, 0)
    jr, tr = pretrain(layout, X, d)
    cfg = dbm_cfg(layout, np.random.RandomState(1), max_epoch=1,
                  sample_v_states=True, sample_h_states=[True, True])
    jd = JaxDBM(rbms=jr, model_path=d + 'jd/', **cfg).fit(X)
    td = load_model(d + 'jd/', device='cpu')
    assert isinstance(td, DBM) and td.layers_config_ == jd.layers_config_
    assert [type(u).__name__ for u in td._units()] == \
        [type(u).__name__ for u in [jd._v_layer] + jd._h_layers]
    sj, st = jd.get_params_arrays(), td.get_params_arrays()
    for k in sj:
        np.testing.assert_array_equal(st[k], np.asarray(sj[k]), err_msg=k)
    np.testing.assert_allclose(td.transform(X), jd.transform(X), atol=2e-5)

    td2 = DBM(rbms=tr, device='cpu', model_path=d + 'td/', **cfg).fit(X)
    jd2 = JaxDBM.load_model(d + 'td/')
    assert jd2.layers_config_ == td2.layers_config_
    s1, s2 = td2.get_params_arrays(), jd2.get_params_arrays()
    for k in s1:
        np.testing.assert_array_equal(np.asarray(s2[k]), s1[k], err_msg=k)
    np.testing.assert_allclose(jd2.transform(X), td2.transform(X), atol=2e-5)
    # and back: the port's own checkpoint, its sampled fit resumed
    td3 = DBM.load_model(d + 'td/', device='cpu')
    np.testing.assert_array_equal(td3.transform(X), td2.transform(X))


def test_log_Z_and_log_proba_refused_as_in_jax(tmp_path):
    """JAX asserts Bernoulli layers in log_Z and log_proba; the port
    raises."""
    d = str(tmp_path) + '/'
    X = data('G', 16, 0)
    jr, tr = pretrain('G-B-M', X, d)
    jd = JaxDBM(rbms=jr, n_particles=4, batch_size=8, model_path=d + 'jd/')
    td = DBM(rbms=tr, n_particles=4, batch_size=8, device='cpu',
             model_path=d + 'td/')
    with pytest.raises(AssertionError):
        jd.log_Z(n_betas=5, n_runs=4)
    with pytest.raises(AssertionError):
        jd.log_proba(X, 0.)
    with pytest.raises(ValueError, match='Bernoulli'):
        td.log_Z(n_betas=5, n_runs=4)
    with pytest.raises(ValueError, match='Bernoulli'):
        td.log_proba(X, 0.)


def test_pallas_kernel_refused_by_configuration(tmp_path):
    """kernel='pallas' asks for the all-Bernoulli DBM kernels: a G-B-M
    model is refused from its configuration; 'auto' and 'xla' take the
    plain program on the CPU."""
    d = str(tmp_path) + '/'
    X = data('G', 16, 0)
    _, tr = pretrain('G-B-M', X, d)
    with pytest.raises(ValueError, match='pallas'):
        DBM(rbms=tr, n_particles=4, batch_size=8, kernel='pallas',
            device='cpu', model_path=d + 'p/').fit(X)
    for kernel in ('auto', 'xla'):
        dbm = DBM(rbms=tr, n_particles=4, batch_size=8, kernel=kernel,
                  max_epoch=1, device='cpu', model_path=d + kernel + '/')
        assert not dbm._kernel_eligible()
        dbm.fit(X)


def test_summaries_at_cifar_shape(tmp_path):
    """A G-B-M DBM at v_shape (32, 32, 3) writes the JAX package's tags:
    histograms, the cumulative filters of each layer and the Gaussian
    negative particles as images."""
    d = str(tmp_path) + '/'
    rng = np.random.RandomState(0)
    X = rng.randn(16, 3072).astype(np.float32)
    g = GaussianRBM(n_visible=3072, n_hidden=8, max_epoch=1, batch_size=8,
                    dbm_first=True, device='cpu', model_path=d + 'g/',
                    verbose=False).fit(X)
    m = MultinomialRBM(n_visible=8, n_hidden=6, n_samples=N_SAMPLES,
                       max_epoch=1, batch_size=8, dbm_last=True,
                       device='cpu', model_path=d + 'm/',
                       verbose=False).fit(g.transform(X))
    dbm = DBM(rbms=[g, m], n_particles=6, batch_size=8, max_epoch=1,
              train_metrics_every_iter=1, display_filters=4,
              display_particles=6, v_shape=(32, 32, 3), device='cpu',
              model_path=d + 'dbm/', verbose=False).fit(X)
    data_ = b''
    logdir = dbm._train_summary_dirpath
    for name in os.listdir(logdir):
        if name.startswith('events'):
            with open(os.path.join(logdir, name), 'rb') as f:
                data_ += f.read()
    for tag in ('vb', 'W_0', 'hb_0', 'W_1', 'hb_1', 'W_filters_0',
                'W_filters_1', 'negative_particles'):
        assert tag.encode() in data_, tag
    assert data_.count(b'\x89PNG') == 3


@pytest.mark.parametrize('shape', [(8, 8, 3), (32, 32, 3), (5, 7)])
def test_augmentation_matches_jax(shape):
    rng = np.random.RandomState(0)
    X = rng.rand(*shape).astype(np.float32)
    for offset in ((1, 0), (-1, 0), (0, 1), (0, -1), (2, -3), (0, 0)):
        got = augmentation.shift(X, offset)
        np.testing.assert_array_equal(got, jax_augmentation.shift(X, offset))
        assert got.dtype == X.dtype and got.shape == X.shape
    np.testing.assert_array_equal(augmentation.horizontal_mirror(X),
                                  jax_augmentation.horizontal_mirror(X))
