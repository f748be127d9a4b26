"""The port's GaussianRBM and MultinomialRBM (boltzmann_machines_tpu_torch)
against the JAX package's, at a small size on the CPU: fits with the
dbm_cifar_naive stages' doubling, checkpoints both ways, and their own
seeded-determinism, resume and free-energy checks."""

import json
import math
import os

import numpy as np
import pytest
import torch

from boltzmann_machines_tpu import (GaussianRBM as JaxGaussianRBM,
                                    MultinomialRBM as JaxMultinomialRBM)
from boltzmann_machines_tpu_torch import (GaussianRBM, MultinomialRBM,
                                          load_model)
from boltzmann_machines_tpu_torch.base.mixin import make_generator
from boltzmann_machines_tpu_torch.ops.cd_epoch import free_energy_sum

V, H, M = 20, 12, 30


def read_scalars(logdir):
    with open(os.path.join(logdir, 'scalars.jsonl')) as f:
        return {(r['tag'], r['step']): r['value'] for r in map(json.loads, f)}


def gaussian_data(seed, n):
    rng = np.random.RandomState(seed)
    protos = rng.randn(3, V)
    return (protos[rng.randint(0, 3, n)] + 0.5 * rng.randn(n, V)) \
        .astype(np.float32)


def binary_data(seed, n):
    return (np.random.RandomState(seed).rand(n, V) < 0.4).astype(np.float32)


def sigma_of(kind):
    return 1. if kind == 'scalar' else \
        (np.random.RandomState(5).rand(V) + 0.5).astype(np.float32)


def grbm_config(sigma, **kw):
    rng = np.random.RandomState(0)
    cfg = dict(n_visible=V, n_hidden=H, sigma=sigma,
               W_init=rng.randn(V, H) * 0.05, vb_init=0., hb_init=0.,
               batch_size=8, max_epoch=2, learning_rate=[5e-3, 2e-3],
               momentum=np.geomspace(0.5, 0.9, 8), l2=0.01,
               sample_v_states=False, sample_h_states=False,
               sparsity_cost=0., dbm_first=True,
               metrics_config=dict(msre=True, feg=True,
                                   train_metrics_every_iter=2,
                                   feg_every_epoch=1, n_batches_for_feg=2),
               random_seed=3, verbose=False)
    cfg.update(kw)
    return cfg


def mrbm_config(**kw):
    rng = np.random.RandomState(1)
    cfg = dict(n_visible=V, n_hidden=H, n_samples=M,
               W_init=rng.randn(V, H) * 0.05, vb_init=0., hb_init=0.,
               batch_size=8, max_epoch=2, learning_rate=0.01,
               momentum=np.geomspace(0.5, 0.9, 8), l2=0.05,
               sample_v_states=False, sample_h_states=False,
               sparsity_cost=0., dbm_last=True,
               metrics_config=dict(msre=True, pll=True, feg=True,
                                   train_metrics_every_iter=2,
                                   feg_every_epoch=1, n_batches_for_feg=2),
               random_seed=1337, verbose=False)
    cfg.update(kw)
    return cfg


def assert_states_close(a, b, atol=2e-5):
    sa, sb = a.get_params_arrays(), b.get_params_arrays()
    assert set(sa) == set(sb) and len(sa) == 7
    for key in sa:
        np.testing.assert_allclose(sa[key], sb[key], atol=atol, err_msg=key)


def assert_same_model(a, b):
    sa, sb = a.get_params_arrays(), b.get_params_arrays()
    assert set(sa) == set(sb) and len(sa) == 7
    for key in sa:
        np.testing.assert_array_equal(sa[key], sb[key], err_msg=key)
    assert a._serialize(a.get_params()) == b._serialize(b.get_params())
    assert a._rng.get_state() == b._rng.get_state()


@pytest.mark.parametrize('sigma', ['scalar', 'per_unit'])
def test_grbm_fit_matches_jax(tmp_path, sigma):
    """Stage 1 of dbm_cifar_naive at a small size: `dbm_first`, momentum
    geomspace(0.5, 0.9, 8), 2 epochs with a remainder batch, sampling off.
    State atol 2e-5; the msre and feg streams, `transform` and
    `free_energy` (inputs divided by sigma, vb raw) within 1e-5."""
    X, X_val = gaussian_data(0, 45), gaussian_data(1, 21)
    cfg = grbm_config(sigma_of(sigma))
    pj, pt = str(tmp_path) + '/jax/', str(tmp_path) + '/torch/'
    jrbm = JaxGaussianRBM(model_path=pj, **cfg).fit(X, X_val)
    trbm = GaussianRBM(device='cpu', model_path=pt, **cfg).fit(X, X_val)
    assert trbm.iter_ == jrbm.iter_ == 12
    assert_states_close(trbm, jrbm)
    for sub in ('logs/train', 'logs/val'):
        a, b = read_scalars(pj + sub), read_scalars(pt + sub)
        assert sorted(a) == sorted(b) and a
        for key in a:
            np.testing.assert_allclose(b[key], a[key], rtol=1e-5, atol=1e-5,
                                       err_msg=str(key))
    np.testing.assert_allclose(trbm.transform(X_val), jrbm.transform(X_val),
                               atol=1e-5)
    np.testing.assert_allclose(trbm.free_energy(X_val),
                               jrbm.free_energy(X_val), rtol=1e-5, atol=1e-5)


def fe_bounds(arrays, X, C):
    """Interval of the Monte Carlo multinomial free energy of batch X for
    any count vector h (h >= 0, sum h = M): -mean(X vb) - mean(X W).h + C."""
    a = (X @ arrays['weights/W']).mean(0)
    t1 = -(X @ arrays['weights/vb']).mean()
    return t1 - M * a.max() + C, t1 - M * a.min() + C


def test_mrbm_fit_matches_jax(tmp_path):
    """Stage 2 of dbm_cifar_naive at a small size: `dbm_last`, 2 epochs
    with a remainder batch, sampling off.  State atol 2e-5, the msre stream
    and `transform` (counts / n_samples) within 1e-5.  PLL and FEG are
    Monte Carlo in both packages (each draws its own count vectors), so
    they are checked as bounds: every PLL row finite and <= 0, and the last
    FEG of each package inside the interval that any count vectors allow
    on the final state."""
    X, X_val = binary_data(2, 44), binary_data(3, 20)
    cfg = mrbm_config()
    pj, pt = str(tmp_path) + '/jax/', str(tmp_path) + '/torch/'
    jrbm = JaxMultinomialRBM(model_path=pj, **cfg).fit(X, X_val)
    trbm = MultinomialRBM(device='cpu', model_path=pt, **cfg).fit(X, X_val)
    assert trbm.iter_ == jrbm.iter_ == 12
    assert_states_close(trbm, jrbm)
    a, b = read_scalars(pj + 'logs/train'), read_scalars(pt + 'logs/train')
    assert sorted(a) == sorted(b)
    tag = 'mean_squared_reconstruction_error'
    for key in a:
        if key[0] == tag:
            np.testing.assert_allclose(b[key], a[key], rtol=1e-5, atol=1e-5)
        else:
            assert key[0] == 'pseudo_loglikelihood'
            assert math.isfinite(a[key]) and a[key] <= 0
            assert math.isfinite(b[key]) and b[key] <= 0
    Tj, Tt = jrbm.transform(X_val), trbm.transform(X_val)
    np.testing.assert_allclose(Tt, Tj, atol=1e-5)
    np.testing.assert_allclose(Tt.sum(1), 1., atol=1e-5)

    arrays = trbm.get_params_arrays()
    C = trbm._lgamma_constant()
    lo_t, hi_t = zip(*[fe_bounds(arrays, X[i:i + 8], C) for i in (0, 8)])
    lo_v, hi_v = zip(*[fe_bounds(arrays, X_val[i:i + 8], C) for i in (0, 8)])
    lo, hi = np.mean(lo_v) - np.mean(hi_t), np.mean(hi_v) - np.mean(lo_t)
    last = max(step for t, step in read_scalars(pt + 'logs/val'))
    for p in (pj, pt):
        feg = read_scalars(p + 'logs/val')[('free_energy_gap', last)]
        assert lo - 1e-3 <= feg <= hi + 1e-3, (feg, lo, hi)


@pytest.mark.parametrize('flavour', ['gaussian', 'multinomial'])
def test_kernel_path_matches_generic_path(tmp_path, monkeypatch, flavour):
    """The fit's kernel path (the CD epoch op with the model's sigma or
    n_samples, here its plain version on the CPU) against the generic path,
    sampling off: the same states within 2e-5 and the same msre rows."""
    from boltzmann_machines_tpu_torch.rbm.base_rbm import BaseRBM
    if flavour == 'gaussian':
        cls, cfg = GaussianRBM, grbm_config(sigma_of('per_unit'))
        X = gaussian_data(4, 45)
    else:
        cls, cfg = MultinomialRBM, mrbm_config()
        X = binary_data(4, 45)
    cfg['metrics_config'] = dict(msre=True, train_metrics_every_iter=2)
    generic = cls(device='cpu', model_path=str(tmp_path) + '/g/', **cfg).fit(X)
    monkeypatch.setattr(BaseRBM, '_kernel_eligible', lambda self: True)
    kernel = cls(device='cpu', model_path=str(tmp_path) + '/k/', **cfg).fit(X)
    assert_states_close(kernel, generic)
    a = read_scalars(str(tmp_path) + '/g/logs/train')
    b = read_scalars(str(tmp_path) + '/k/logs/train')
    assert sorted(a) == sorted(b)
    for key in a:
        np.testing.assert_allclose(b[key], a[key], rtol=1e-5, atol=1e-6)


def test_default_device_is_the_card_when_there_is_one(monkeypatch):
    """Entry points run on the card unless the caller asks for the CPU:
    with a CUDA device visible the default device is CUDA (nothing is
    allocated until a fit or init); without one a model given no device
    raises, naming device='cpu'."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    for cls, kw in ((GaussianRBM, {}), (MultinomialRBM, dict(n_samples=3))):
        assert cls(n_visible=4, n_hidden=2, **kw)._device.type == 'cuda'
        assert cls(n_visible=4, n_hidden=2, device='cpu',
                   **kw)._device.type == 'cpu'
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GaussianRBM(n_visible=4, n_hidden=2)


def test_kernel_eligibility():
    """On a CUDA device both classes take the kernels (any size, PLL on);
    dropout, float64 or kernel='xla' keep the generic path."""
    g = GaussianRBM(n_visible=3072, n_hidden=5000, device='cuda')
    m = MultinomialRBM(n_visible=5000, n_hidden=1000, n_samples=1000,
                       metrics_config=dict(pll=True), device='cuda')
    assert g._kernel_eligible() and m._kernel_eligible()
    assert g._kernel_flavours()[:1] == ('gaussian',) and \
        m._kernel_flavours()[2:] == ('multinomial', 1000)
    assert not GaussianRBM(n_visible=4, n_hidden=2, dropout=0.5,
                           device='cuda')._kernel_eligible()
    assert not MultinomialRBM(n_visible=4, n_hidden=2, dtype='float64',
                              device='cuda')._kernel_eligible()
    assert not GaussianRBM(n_visible=4, n_hidden=2, kernel='xla',
                           device='cuda')._kernel_eligible()
    assert not GaussianRBM(n_visible=4, n_hidden=2,
                           device='cpu')._kernel_eligible()


CHECKPOINT_CASES = {
    'grbm_scalar': (GaussianRBM, JaxGaussianRBM,
                    lambda: grbm_config(1.5, sample_v_states=True,
                                        sample_h_states=True)),
    'grbm_per_unit': (GaussianRBM, JaxGaussianRBM,
                      lambda: grbm_config(sigma_of('per_unit'))),
    'mrbm': (MultinomialRBM, JaxMultinomialRBM,
             lambda: mrbm_config(sample_h_states=True)),
}


def data_for(cls):
    return gaussian_data(6, 20) if cls is GaussianRBM else binary_data(6, 20)


@pytest.mark.parametrize('case', sorted(CHECKPOINT_CASES))
def test_jax_checkpoint_loads_in_torch(tmp_path, case):
    cls, jcls, cfg = CHECKPOINT_CASES[case]
    d = str(tmp_path) + '/jax/'
    jrbm = jcls(model_path=d, **cfg()).fit(data_for(cls))
    trbm = cls.load_model(d, device='cpu')
    assert_same_model(jrbm, trbm)
    assert_same_model(jrbm, load_model(d, device='cpu'))
    assert type(load_model(d, device='cpu')) is cls
    np.testing.assert_array_equal(trbm._v_layer.sigma
                                  if cls is GaussianRBM else
                                  trbm._h_layer.n_samples,
                                  jrbm._v_layer.sigma
                                  if cls is GaussianRBM else
                                  jrbm._h_layer.n_samples)


@pytest.mark.parametrize('case', sorted(CHECKPOINT_CASES))
def test_torch_checkpoint_loads_in_jax(tmp_path, case):
    cls, jcls, cfg = CHECKPOINT_CASES[case]
    d = str(tmp_path) + '/torch/'
    trbm = cls(device='cpu', model_path=d, **cfg()).fit(data_for(cls))
    jrbm = jcls.load_model(d)
    assert_same_model(trbm, jrbm)
    if cls is GaussianRBM:
        np.testing.assert_array_equal(jrbm._sigma_arr, trbm._sigma_arr)


@pytest.mark.parametrize('case', ['grbm_scalar', 'mrbm'])
def test_consistency_and_resume(tmp_path, case):
    """Sampling on: same-seed models are bitwise-identical through fit and
    reload; a model saved and loaded back continues exactly as the one
    kept in memory."""
    cls, _, cfg = CHECKPOINT_CASES[case]
    X = data_for(cls)
    d = str(tmp_path) + '/'
    r1 = cls(device='cpu', model_path=d + 'r1/', **cfg()).fit(X)
    r2 = cls(device='cpu', model_path=d + 'r2/', **cfg()).fit(X)
    assert_same_model(r1, r2)
    np.testing.assert_array_equal(r1.transform(X), r2.transform(X))
    b = cls.load_model(d + 'r1/', device='cpu')
    b.update_working_paths(model_path=d + 'b/')
    r1 = cls.load_model(d + 'r1/', device='cpu')
    r1.set_params(max_epoch=4).fit(X)
    b.set_params(max_epoch=4).fit(X)
    assert r1.epoch_ == b.epoch_ == 4
    sa, sb = r1.get_params_arrays(), b.get_params_arrays()
    for key in sa:
        np.testing.assert_array_equal(sa[key], sb[key], err_msg=key)
    c = cls(device='cpu', model_path=d + 'c/',
            **dict(cfg(), random_seed=99)).fit(X)
    assert not np.array_equal(c.get_params_arrays()['weights/W'],
                              r2.get_params_arrays()['weights/W'])


@pytest.mark.parametrize('case', ['grbm_per_unit', 'mrbm'])
def test_init_from(tmp_path, case):
    cls, _, cfg = CHECKPOINT_CASES[case]
    d = str(tmp_path) + '/'
    r1 = cls(device='cpu', model_path=d + 'r1/', **cfg()).fit(data_for(cls))
    r2 = cls(device='cpu', model_path=d + 'r2/', **cfg())
    r2.init_from(r1)
    r2.init()
    for scope in ('weights', 'grads_accumulators'):
        a1, a2 = r1.get_params_arrays(scope), r2.get_params_arrays(scope)
        for key in a1:
            np.testing.assert_array_equal(a1[key], a2[key])
    assert r2.epoch_ == r1.epoch_ and r2.iter_ == r1.iter_
    other = GaussianRBM if cls is MultinomialRBM else MultinomialRBM
    with pytest.raises(ValueError):
        other(n_visible=V, n_hidden=H, device='cpu').init_from(r1)


def test_multinomial_free_energy_adds_lgamma_constant():
    """ROADMAP.md Queue C6: `MultinomialRBM._free_energy` (FEG, PLL of the
    generic path) draws a fresh count vector on every call and ADDS
    -lgamma(M+K) + lgamma(M+1) + lgamma(K); the kernels' free energy
    (`free_energy_sum`, the epoch's PLL and the probe) omits it, given the
    same draw the two differ by exactly that constant."""
    rbm = MultinomialRBM(device='cpu', n_visible=V, n_hidden=H, n_samples=M,
                         random_seed=2, verbose=False)
    rbm._ensure_state()
    state = rbm._state.as_dict()
    X = torch.as_tensor(binary_data(7, 8))
    fe = rbm._free_energy(state, X, make_generator(11))
    h_hat = rbm._draw_h_hat(make_generator(11), X)
    assert float(h_hat.sum()) == M
    C = -math.lgamma(M + H) + math.lgamma(M + 1.) + math.lgamma(H)
    assert rbm._lgamma_constant() == pytest.approx(C, rel=1e-12) and C < -10
    kernel_fe = free_energy_sum(X, X @ state['W'], state['vb'], state['hb'],
                                hidden='multinomial', h_hat=h_hat) / len(X)
    np.testing.assert_allclose(float(fe) - float(kernel_fe), C, rtol=1e-5)
    # fresh counts on every call
    g = make_generator(12)
    fes = {float(rbm._free_energy(state, X, g)) for _ in range(6)}
    assert len(fes) > 1
