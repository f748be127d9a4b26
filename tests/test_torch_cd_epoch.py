"""The port's CD epoch op (boltzmann_machines_tpu_torch/ops/cd_epoch.py)
against the JAX package's fused epoch kernel, run in interpret mode on the
CPU, at a small size.  Inputs are made with numpy from a seed and handed to
both.  The CUDA kernels are held against the plain version in
tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from boltzmann_machines_tpu import BernoulliRBM as JaxBernoulliRBM
from boltzmann_machines_tpu.ops.pallas_ops import (
    _free_energy_sum, make_cd_epoch_kernel as jax_make_cd_epoch_kernel)
from boltzmann_machines_tpu_torch import BernoulliRBM
from boltzmann_machines_tpu_torch.ops.cd_epoch import (
    CDEpochConfig, cd_epoch, cd_epoch_reference, free_energy_sum,
    make_cd_epoch_kernel, pll_flip_index, pll_from_flip)
from boltzmann_machines_tpu_torch.ops.philox import (
    philox4x32, philox_uniform)

V, H, B, NB = 24, 16, 8, 4
CONFIG = dict(propup_mult=1., propdown_mult=1., l2=1e-5,
              sparsity_target=0.1, sparsity_cost=1e-2,
              sparsity_damping=0.9, metrics_every=2)


def make_inputs(seed=0):
    rng = np.random.RandomState(seed)
    X = (rng.rand(NB, B, V) < 0.3).astype(np.float32)
    state = {
        'W': (rng.randn(V, H) * 0.1).astype(np.float32),
        'vb': (rng.randn(V) * 0.1).astype(np.float32),
        'hb': (rng.randn(H) * 0.1).astype(np.float32),
        'dW': (rng.randn(V, H) * 0.01).astype(np.float32),
        'dvb': (rng.randn(V) * 0.01).astype(np.float32),
        'dhb': (rng.randn(H) * 0.01).astype(np.float32),
        'q_means': rng.rand(H).astype(np.float32),
    }
    return X, state


def torch_state(state):
    return {k: torch.as_tensor(v) for k, v in state.items()}


@pytest.mark.parametrize('k', [1, 2])
def test_reference_matches_jax_kernel(k):
    """Sampling off: the plain version equals the JAX epoch kernel in
    interpret mode.  Tolerances of tests/test_pallas_ops.py:485-492 (f32
    sums in a different order): atol 2e-5 on state, 1e-5 on msre, rtol 1e-4
    on l2; q_means is a batch SUM, so its atol scales by B."""
    X, state = make_inputs()
    epoch = jax_make_cd_epoch_kernel(
        V, H, B, k, sample_v_states=False, sample_h_states=False,
        compute_pll=False, interpret=True, **CONFIG)
    s_jax, msre_jax, _, l2_jax = epoch(
        {key: jnp.asarray(v) for key, v in state.items()}, jnp.asarray(X),
        0.05, 0.9, 7, 0)
    cfg = make_cd_epoch_kernel(V, H, B, k, False, False, compute_pll=False,
                               **CONFIG)
    s, msre, pll, l2 = cfg(torch_state(state), torch.as_tensor(X), 0.05, 0.9,
                           7, 0)
    for key in ('W', 'vb', 'hb', 'dW', 'dvb', 'dhb'):
        np.testing.assert_allclose(s[key].numpy(), np.asarray(s_jax[key]),
                                   atol=2e-5, err_msg=key)
    np.testing.assert_allclose(s['q_means'].numpy(),
                               np.asarray(s_jax['q_means']), atol=2e-5 * B)
    np.testing.assert_allclose(msre.numpy(), np.asarray(msre_jax), atol=1e-5)
    np.testing.assert_allclose(l2.numpy(), np.asarray(l2_jax), rtol=1e-4)
    # rows are zero off the metric cadence (it = 1, 3)
    assert msre[0] == 0 and msre[2] == 0 and msre[1] > 0
    assert torch.all(pll == 0)


def test_input_state_not_modified():
    X, state = make_inputs()
    ts = torch_state(state)
    make_cd_epoch_kernel(V, H, B, 1, True, True, **CONFIG)(
        ts, torch.as_tensor(X), 0.05, 0.9, 3, 0)
    for key, v in state.items():
        np.testing.assert_array_equal(ts[key].numpy(), v)


def test_free_energy_matches_jax():
    """The port's batch-sum free energy against JAX `_free_energy_sum` (a
    pure jnp function) on the same inputs; rtol 1e-6 (f32 sums of ~400
    terms in another order)."""
    X, state = make_inputs(1)
    Xb = X[0]
    act = Xb @ state['W']
    fe_jax = _free_energy_sum(jnp.asarray(Xb), jnp.asarray(act),
                              jnp.asarray(state['vb'])[None],
                              jnp.asarray(state['hb'])[None], None,
                              'bernoulli', 'bernoulli', None)
    fe = free_energy_sum(torch.as_tensor(Xb), torch.as_tensor(act),
                         torch.as_tensor(state['vb']),
                         torch.as_tensor(state['hb']))
    np.testing.assert_allclose(float(fe), float(fe_jax), rtol=1e-6)


def test_pll_given_flip_matches_jax_formula():
    """PLL for a fixed flip vector: V * log_sigmoid(fe(X_flip) - fe(X)) with
    batch-MEAN free energies from JAX `_free_energy_sum`; atol 1e-4 (a
    difference of two f32 free energies, times V)."""
    X, state = make_inputs(2)
    Xb = X[0]
    flip = np.random.RandomState(3).randint(0, V, size=B)
    Xf = Xb.copy()
    Xf[np.arange(B), flip] = 1. - Xf[np.arange(B), flip]

    def fe_jax(Xv):
        return _free_energy_sum(
            jnp.asarray(Xv), jnp.asarray(Xv) @ jnp.asarray(state['W']),
            jnp.asarray(state['vb'])[None], jnp.asarray(state['hb'])[None],
            None, 'bernoulli', 'bernoulli', None) / B

    import jax
    pll_jax = V * jax.nn.log_sigmoid(fe_jax(Xf) - fe_jax(Xb))
    ts = torch_state(state)
    pll = pll_from_flip(torch.as_tensor(Xb), torch.as_tensor(flip),
                        ts['W'], ts['vb'], ts['hb'])
    np.testing.assert_allclose(float(pll), float(pll_jax), atol=1e-4)


def test_pll_row_uses_philox_flip_on_updated_params():
    """The epoch's PLL row equals pll_from_flip at the Philox flip, on the
    parameters after that iteration's update (ROADMAP.md Queue C3/C4)."""
    X, state = make_inputs(4)
    epoch = make_cd_epoch_kernel(V, H, B, 1, False, False, **CONFIG)
    s1, _, pll, _ = epoch(torch_state(state), torch.as_tensor(X[:2]), 0.05,
                          0.9, 11, 0)
    flip = pll_flip_index(11, 2, B, V, 'cpu')
    assert int(flip.min()) >= 0 and int(flip.max()) < V
    expect = pll_from_flip(torch.as_tensor(X[1]), flip, s1['W'], s1['vb'],
                           s1['hb'])
    assert float(pll[0]) == 0.
    np.testing.assert_allclose(float(pll[1]), float(expect), rtol=1e-6)


def _philox_python(ctr, key):
    """Philox4x32-10 on Python ints (Salmon et al., SC'11)."""
    m0, m1, w0, w1, mask = 0xD2511F53, 0xCD9E8D57, 0x9E3779B9, 0xBB67AE85, \
        0xFFFFFFFF
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for r in range(10):
        if r:
            k0, k1 = (k0 + w0) & mask, (k1 + w1) & mask
        p0, p1 = m0 * c0, m1 * c2
        c0, c1, c2, c3 = ((p1 >> 32) ^ c1 ^ k0, p1 & mask,
                          (p0 >> 32) ^ c3 ^ k1, p0 & mask)
    return c0, c1, c2, c3


def test_philox_matches_python_reference():
    """The int64-masked torch Philox against a pure-Python one, on random
    counters and keys, plus Random123's known-answer vectors."""
    rng = np.random.RandomState(5)
    ctr = rng.randint(0, 2 ** 32, size=(64, 4), dtype=np.uint64)
    for key in [(0, 0), (0xFFFFFFFF, 0xFFFFFFFF), (1337, 42)]:
        out = philox4x32(*[torch.as_tensor(ctr[:, j].astype(np.int64))
                           for j in range(4)], *key)
        for n in range(len(ctr)):
            expect = _philox_python(tuple(int(c) for c in ctr[n]), key)
            assert tuple(int(o[n]) for o in out) == expect
    kat = philox4x32(0, 0, 0, 0, 0, 0)
    assert [int(o) for o in kat] == [0x6627e8d5, 0xe169c58d, 0xbc57ac4c,
                                     0x9b00dbd8]
    u = philox_uniform(9, 3, 1, (4, 5))
    bits = [_philox_python((j, 1, 0, 0), (9, 3))[0] for j in range(20)]
    np.testing.assert_array_equal(
        u.reshape(-1).numpy(),
        np.asarray([(b >> 9) * 2. ** -23 for b in bits], np.float32))
    assert u.dtype == torch.float32 and float(u.min()) >= 0. \
        and float(u.max()) < 1.


def test_sampled_epoch_is_deterministic():
    """Sampling on: the same (seed, iter0) gives the same epoch; another
    seed gives another."""
    X, state = make_inputs(6)
    epoch = make_cd_epoch_kernel(V, H, B, 1, True, True, **CONFIG)
    a = epoch(torch_state(state), torch.as_tensor(X), 0.05, 0.9, 5, 10)
    b = epoch(torch_state(state), torch.as_tensor(X), 0.05, 0.9, 5, 10)
    c = epoch(torch_state(state), torch.as_tensor(X), 0.05, 0.9, 6, 10)
    torch.testing.assert_close(a[0]['W'], b[0]['W'], rtol=0, atol=0)
    assert not torch.equal(a[0]['W'], c[0]['W'])


def test_unported_variants_raise():
    """The epoch takes Bernoulli or Gaussian visible and Bernoulli or
    multinomial hidden units (tests/test_torch_cd_flavours.py); any other
    unit type, or multinomial units without a draw count, is refused, as
    the JAX factory asserts."""
    with pytest.raises(ValueError, match='visible'):
        make_cd_epoch_kernel(V, H, B, 1, False, False, visible='multinomial',
                             **CONFIG)
    with pytest.raises(ValueError, match='hidden'):
        make_cd_epoch_kernel(V, H, B, 1, False, False, hidden='gaussian',
                             **CONFIG)
    with pytest.raises(ValueError, match='n_samples'):
        make_cd_epoch_kernel(V, H, B, 1, False, False, hidden='multinomial',
                             **CONFIG)
    make_cd_epoch_kernel(V, H, B, 1, False, False, visible='gaussian',
                         hidden='multinomial', n_samples=4, **CONFIG)


def test_kernel_pallas_on_cpu_raises(tmp_path):
    """kernel='pallas' forces the CUDA kernels: a CPU model is not eligible
    and fit raises, as the JAX package does off the TPU."""
    X, _ = make_inputs()
    rbm = BernoulliRBM(n_visible=V, n_hidden=H, batch_size=B, kernel='pallas',
                       verbose=False, device='cpu',
                       model_path=str(tmp_path) + '/')
    with pytest.raises(ValueError, match='pallas'):
        rbm.fit(X.reshape(-1, V))
    jrbm = JaxBernoulliRBM(n_visible=V, n_hidden=H, batch_size=B,
                           kernel='pallas', verbose=False,
                           model_path=str(tmp_path) + '/jax/')
    with pytest.raises(ValueError, match='pallas'):
        jrbm.fit(X.reshape(-1, V))


def test_cpu_tensor_runs_plain_version():
    X, state = make_inputs()
    cfg = make_cd_epoch_kernel(V, H, B, 1, True, False, **CONFIG)
    before = dict(cd_epoch.launches)
    got = cfg(torch_state(state), torch.as_tensor(X), 0.05, 0.9, 1, 0)
    want = cd_epoch_reference(CDEpochConfig(
        V, H, 1, True, False, 1., 1., 1e-5, 0.1, 1e-2, 0.9, 2, True),
        torch_state(state), torch.as_tensor(X), 0.05, 0.9, 1, 0)
    torch.testing.assert_close(got[0]['W'], want[0]['W'], rtol=0, atol=0)
    assert cd_epoch.launches == before
