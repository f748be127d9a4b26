"""The port's per-shard CD stats op (boltzmann_machines_tpu_torch/ops/
cd_stats.py) and ``bernoulli_sample`` (ops/samplers.py) on the CPU: the
plain versions against the JAX package's stats kernels run in interpret
mode, at a small size, from numpy seeds.  The CUDA kernels are held against
the plain versions in tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from boltzmann_machines_tpu.ops.pallas_ops import (
    make_cd_stats_kernel as jax_make_cd_stats_kernel,
    make_tiled_cd_stats_kernel as jax_make_tiled_cd_stats_kernel)
from boltzmann_machines_tpu_torch.ops.cd_epoch import (
    CDEpochConfig, cd_epoch_reference)
from boltzmann_machines_tpu_torch.ops.cd_stats import (
    cd_stats, cd_stats_reference, make_cd_stats_kernel,
    make_tiled_cd_stats_kernel, stats_buffer)
from boltzmann_machines_tpu_torch.ops.samplers import (
    bernoulli_sample, bernoulli_sample_reference)

V, H, B = 24, 16, 8


def make_inputs(V, H, B, visible, seed=0):
    rng = np.random.RandomState(seed)
    if visible == 'bernoulli':
        X = (rng.rand(B, V) < 0.3).astype(np.float32)
    else:
        X = rng.randn(B, V).astype(np.float32)
    state = {'W': (rng.randn(V, H) * 0.1).astype(np.float32),
             'vb': (rng.randn(V) * 0.1).astype(np.float32),
             'hb': (rng.randn(H) * 0.1).astype(np.float32)}
    return X, state


def torch_state(state):
    return {k: torch.as_tensor(v) for k, v in state.items()}


def jax_state(state):
    return {k: jnp.asarray(v) for k, v in state.items()}


SIGMAS = {'bernoulli': None, 'gaussian_scalar': 1.5,
          'gaussian_per_unit': np.linspace(0.5, 2., V).astype(np.float32)}


@pytest.mark.parametrize('k', [0, 1, 2])
@pytest.mark.parametrize('flavour', sorted(SIGMAS))
@pytest.mark.parametrize('mults', [(2., 1.), (1., 2.)])
def test_reference_matches_jax_stats_kernel(k, flavour, mults):
    """Sampling off: the plain version equals the JAX stats kernel in
    interpret mode, atol 2e-5 (f32 sums in another order, as
    tests/test_pallas_ops.py:746)."""
    visible = 'bernoulli' if flavour == 'bernoulli' else 'gaussian'
    sigma = SIGMAS[flavour]
    X, state = make_inputs(V, H, B, visible)
    up, down = mults
    jfn = jax_make_cd_stats_kernel(V, H, B, k, False, False, up, down,
                                   visible=visible, sigma=sigma,
                                   interpret=True)
    want, jaux = jfn(jax_state(state), jnp.asarray(X), 7, 1, 0)
    fn = make_cd_stats_kernel(V, H, B, k, False, False, up, down,
                              visible=visible, sigma=sigma)
    got, aux = fn(torch_state(state), torch.as_tensor(X), 7, 1, 0)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=2e-5, err_msg=key)
    np.testing.assert_allclose(aux['v_means'].numpy(),
                               np.asarray(jaux['v_means']), atol=2e-5)


def test_reference_matches_jax_tiled_stats_kernel():
    """The JAX W-streaming twin (tile 128, H = 200 lane-padded to 256 and
    sliced back) computes the same function: atol 3e-5, as
    tests/test_pallas_ops.py:811."""
    V, H, B = 32, 200, 8
    X, state = make_inputs(V, H, B, 'gaussian', seed=3)
    jfn = jax_make_tiled_cd_stats_kernel(
        V, H, B, 2, False, False, 1., 1., visible='gaussian', sigma=1.,
        tile=128, interpret=True)
    want, jaux = jfn(jax_state(state), jnp.asarray(X), 7, 1, 0)
    assert make_tiled_cd_stats_kernel is make_cd_stats_kernel
    fn = make_tiled_cd_stats_kernel(V, H, B, 2, False, False, 1., 1.,
                                    visible='gaussian', sigma=1.)
    got, aux = fn(torch_state(state), torch.as_tensor(X), 7, 1, 0)
    for key in want:
        assert tuple(got[key].shape) == tuple(want[key].shape), key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=3e-5, err_msg=key)
    np.testing.assert_allclose(aux['v_means'].numpy(),
                               np.asarray(jaux['v_means']), atol=2e-5)


def test_k0_gives_zero_association():
    """k = 0 follows the TPU stats kernels (tests/test_parallel.py:397):
    v_states = X and h_means = h0, so the association and both bias sums
    are exactly zero, sampling on or off; h_sum is the sum of h0."""
    X, state = make_inputs(12, 8, 8, 'bernoulli')
    for sample in (False, True):
        fn = make_cd_stats_kernel(12, 8, 8, 0, sample, sample, 1., 1.)
        got, aux = fn(torch_state(state), torch.as_tensor(X), 7, 1, 3)
        for key in ('assoc', 'dvb_sum', 'dhb_sum'):
            assert not bool(got[key].any()), key
        assert torch.equal(aux['v_means'], torch.as_tensor(X))
        h0 = torch.sigmoid(torch.as_tensor(X) @ torch_state(state)['W']
                           + torch_state(state)['hb'])
        torch.testing.assert_close(got['h_sum'], h0.sum(0), rtol=0,
                                   atol=1e-6)


def test_two_shards_sum_to_the_whole_batch():
    """Sampling off: the sums of two halves, each written into its own flat
    buffer, add up to the whole batch's within 1e-5 -- what the
    all_reduce of the data-parallel epoch relies on."""
    X, state = make_inputs(V, H, B, 'bernoulli', seed=2)
    ts, X = torch_state(state), torch.as_tensor(X)
    fn = make_cd_stats_kernel(V, H, B, 1, False, False, 1., 1.)
    flats = [stats_buffer(V, H, 'cpu') for _ in range(2)]
    fn(ts, X[:B // 2], 7, 1, 0, out=flats[0])
    fn(ts, X[B // 2:], 7, 1, 1, out=flats[1])
    whole, _ = fn(ts, X, 7, 1, 0)
    total = flats[0] + flats[1]
    got = torch.cat([whole[k].reshape(-1) for k in
                     ('assoc', 'dvb_sum', 'dhb_sum', 'h_sum')])
    torch.testing.assert_close(total, got, rtol=0, atol=1e-5)


def test_shard0_draws_are_the_epoch_draws():
    """Sampling on: at shard 0 one step draws what the CD epoch draws at the
    same (seed, it) -- the epoch at lr 1, momentum 0, no L2 or sparsity
    leaves dW = assoc / B, dvb = dvb_sum / B and q = h_sum, exact for
    B = 8 -- and shard 1 draws other states."""
    X, state = make_inputs(V, H, B, 'bernoulli', seed=4)
    ts, X = torch_state(state), torch.as_tensor(X)
    fn = make_cd_stats_kernel(V, H, B, 1, True, True, 1., 1.)
    s0, _ = fn(ts, X, 11, 5, 0)
    cfg = CDEpochConfig(V, H, 1, True, True, 1., 1., 0., 0.1, 0., 0., 10 ** 6,
                        False)
    zero = {k: torch.zeros_like(v) for k, v in ts.items()}
    zero.update(dW=torch.zeros((V, H)), dvb=torch.zeros(V),
                dhb=torch.zeros(H), q_means=torch.zeros(H))
    ep = cd_epoch_reference(cfg, dict(zero, **ts), X[None], 1., 0., 11, 4)[0]
    assert torch.equal(ep['dW'] * B, s0['assoc'])
    assert torch.equal(ep['dvb'] * B, s0['dvb_sum'])
    assert torch.equal(ep['q_means'], s0['h_sum'])
    s1, _ = fn(ts, X, 11, 5, 1)
    assert not torch.equal(s1['assoc'], s0['assoc'])


def test_cpu_tensor_runs_plain_version():
    X, state = make_inputs(V, H, B, 'bernoulli')
    fn = make_cd_stats_kernel(V, H, B, 1, True, False, 1., 1.)
    before = dict(cd_stats.launches)
    got, _ = fn(torch_state(state), torch.as_tensor(X), 3, 2, 1)
    want, _ = cd_stats_reference(fn.config, torch_state(state),
                                 torch.as_tensor(X), 3, 2, 1)
    for key in want:
        assert torch.equal(got[key], want[key])
    assert cd_stats.launches == before
    with pytest.raises(ValueError, match='visible'):
        make_cd_stats_kernel(V, H, B, 1, False, False, 1., 1.,
                             visible='multinomial')


def test_bernoulli_sample_statistics():
    """tests/test_pallas_ops.py:76 (the TPU kernel's statistics test, which
    needs the chip) on the plain version: states in {0, 1} with mean
    within 0.01 of p, another seed other states, a two-word key accepted;
    an int seed is the key (seed, 0); a CPU tensor runs the plain version
    and launches nothing."""
    p = torch.full((1024, 256), 0.3)
    s = bernoulli_sample(12345, p)
    assert set(torch.unique(s).tolist()) <= {0., 1.}
    assert abs(float(s.mean()) - 0.3) < 0.01
    assert not torch.equal(s, bernoulli_sample(54321, p))
    s3 = bernoulli_sample(np.array([0, 7], np.uint32), p)
    assert abs(float(s3.mean()) - 0.3) < 0.01
    assert torch.equal(bernoulli_sample((12345, 0), p), s)
    assert not torch.equal(bernoulli_sample((12345, 1), p), s)
    before = dict(bernoulli_sample.launches)
    assert torch.equal(bernoulli_sample_reference(12345, p), s)
    probs = torch.rand((100, 7800), generator=torch.Generator().manual_seed(1))
    got = bernoulli_sample(3, probs)
    assert abs(float((got - probs).mean())) < 0.02
    assert bernoulli_sample.launches == before
    with pytest.raises(ValueError, match='seed'):
        bernoulli_sample((1, 2, 3), p)
