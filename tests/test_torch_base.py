"""Checkpoints and state conversion between the JAX package and the port
(boltzmann_machines_tpu_torch), the copied utils' doctests, and the port's
independence from JAX."""

import doctest
import subprocess
import sys

import numpy as np
import pytest
import torch

from boltzmann_machines_tpu import BernoulliRBM as JaxBernoulliRBM
from boltzmann_machines_tpu_torch import BernoulliRBM, load_model
from boltzmann_machines_tpu_torch.convert import (
    RBMState, state_from_jax_arrays, state_to_numpy)
from boltzmann_machines_tpu_torch.utils import rng as rng_mod
from boltzmann_machines_tpu_torch.utils import utils as utils_mod

CFG = dict(n_visible=12, n_hidden=8, batch_size=6, max_epoch=2,
           momentum=[0.5, 0.9], random_seed=1337, verbose=False,
           metrics_config=dict(msre=True, train_metrics_every_iter=2))


@pytest.fixture
def X():
    return np.random.RandomState(0).rand(16, 12)


def assert_same_model(a, b):
    sa, sb = a.get_params_arrays(), b.get_params_arrays()
    assert set(sa) == set(sb)
    for key in sa:
        np.testing.assert_array_equal(sa[key], sb[key], err_msg=key)
    # as params.json holds them (tuples and arrays become lists)
    assert a._serialize(a.get_params()) == b._serialize(b.get_params())
    assert a._rng.get_state() == b._rng.get_state()


def test_jax_checkpoint_loads_in_torch(X, tmp_path):
    d = str(tmp_path) + '/jax/'
    jrbm = JaxBernoulliRBM(model_path=d, **CFG).fit(X)
    trbm = BernoulliRBM.load_model(d, device='cpu')
    assert_same_model(jrbm, trbm)
    assert isinstance(trbm._state, RBMState)
    assert trbm._device == torch.device('cpu')
    # the class-dispatching loader reads it unchanged too
    assert_same_model(jrbm, load_model(d, device='cpu'))


def test_torch_checkpoint_loads_in_jax(X, tmp_path):
    d = str(tmp_path) + '/torch/'
    trbm = BernoulliRBM(device='cpu', model_path=d, **CFG).fit(X)
    jrbm = JaxBernoulliRBM.load_model(d)
    assert_same_model(trbm, jrbm)
    # the device never enters params.json
    with open(d + 'params.json') as f:
        assert 'device' not in f.read()


def test_state_conversion_round_trip(X, tmp_path):
    jrbm = JaxBernoulliRBM(model_path=str(tmp_path) + '/', **CFG).fit(X)
    arrays = jrbm._get_state_arrays()
    state = state_from_jax_arrays(arrays, device='cpu', dtype=torch.float32)
    assert set(dict(state.named_buffers())) == {
        'W', 'vb', 'hb', 'dW', 'dvb', 'dhb', 'q_means'}
    assert state.W.shape == (12, 8) and state.vb.dtype == torch.float32
    back = state_to_numpy(state)
    assert set(back) == set(arrays)
    for key in arrays:
        np.testing.assert_array_equal(back[key], np.asarray(arrays[key]))
    # state_dict round-trips through a fresh module
    other = state_from_jax_arrays({k: np.zeros_like(np.asarray(v))
                                   for k, v in arrays.items()}, device='cpu')
    other.load_state_dict(state.state_dict())
    for key, v in state_to_numpy(other).items():
        np.testing.assert_array_equal(v, np.asarray(arrays[key]))


@pytest.mark.parametrize('module', [rng_mod, utils_mod],
                         ids=['rng', 'utils'])
def test_copied_utils_doctests(module):
    failures, tried = doctest.testmod(module, verbose=False)
    assert tried > 0 and failures == 0


def test_import_does_not_load_jax():
    """Every module of the port (found by walking the package, so a new
    module is covered when it lands), and models of each class."""
    code = ('import importlib, pkgutil, sys; '
            'import boltzmann_machines_tpu_torch as m; '
            'mods = [i.name for i in pkgutil.walk_packages(m.__path__, '
            '"boltzmann_machines_tpu_torch.")]; '
            'assert "boltzmann_machines_tpu_torch.ops.samplers" in mods; '
            'assert "boltzmann_machines_tpu_torch.parallel.mesh" in mods; '
            '[importlib.import_module(n) for n in mods]; '
            'cpu = dict(device="cpu"); '
            'r = m.BernoulliRBM(n_visible=4, n_hidden=2, **cpu); '
            'm.GaussianRBM(n_visible=4, n_hidden=2, sigma=[1., 2., 1., 1.], '
            '**cpu); '
            'm.MultinomialRBM(n_visible=4, n_hidden=2, n_samples=3, **cpu); '
            'm.DBM(rbms=[r, m.BernoulliRBM(n_visible=2, n_hidden=2, **cpu)], '
            '**cpu); '
            'bad = [k for k in sys.modules if k == "jax" or '
            'k.startswith("jax.") or k == "boltzmann_machines_tpu" or '
            'k.startswith("boltzmann_machines_tpu.")]; '
            'assert not bad, bad')
    subprocess.run([sys.executable, '-c', code], check=True, timeout=120)


def test_no_device_without_cuda_raises(X, tmp_path, monkeypatch):
    """The port runs on the card unless asked otherwise: where there is no
    CUDA device, a model, ``load_model`` or a state converter given no
    device raises (naming device='cpu') instead of running on the CPU."""
    from boltzmann_machines_tpu_torch import DBM, GaussianRBM
    from boltzmann_machines_tpu_torch.convert import dbm_state_from_jax_arrays
    d = str(tmp_path) + '/cpu/'
    rbm = BernoulliRBM(model_path=d, device='cpu', **CFG).fit(X)
    arrays = rbm._get_state_arrays()
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    calls = [lambda: BernoulliRBM(**CFG),
             lambda: GaussianRBM(n_visible=4, n_hidden=2),
             lambda: DBM(rbms=[rbm]),
             lambda: BernoulliRBM.load_model(d),
             lambda: load_model(d),
             lambda: state_from_jax_arrays(arrays),
             lambda: dbm_state_from_jax_arrays({})]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert load_model(d, device='cpu')._state.W.device.type == 'cpu'
    assert state_from_jax_arrays(arrays, device='cpu').W.device.type == 'cpu'
