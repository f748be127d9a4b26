"""The port's DBM device programs (boltzmann_machines_tpu_torch/ops/dbm_ops.py)
against the JAX package on the CPU: the epoch op against the TPU kernel run in
interpret mode, the sampler and AIS against the JAX XLA programs (those two
TPU kernels have no interpret mode), all with sampling off; and the Philox
streams the plain versions draw from."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boltzmann_machines_tpu import BernoulliRBM as JaxBernoulliRBM
from boltzmann_machines_tpu import DBM as JaxDBM
from boltzmann_machines_tpu.dbm import make_beta_schedule
from boltzmann_machines_tpu.ops.pallas_dbm import \
    make_dbm_epoch_kernel as jax_make_dbm_epoch_kernel
from boltzmann_machines_tpu_torch.convert import dbm_state_from_jax_arrays
from boltzmann_machines_tpu_torch.ops import dbm_ops
from boltzmann_machines_tpu_torch.ops.dbm_ops import (
    DBMSampleConfig, ais_reference, ais_schedule, dbm_epoch, dbm_sample,
    dbm_sample_reference, make_ais_kernel, make_dbm_epoch_kernel)
from boltzmann_machines_tpu_torch.ops.philox import philox_uniform, stream_dbm


def jax_dbm(sizes, tmp, n_particles=8, seed=0, **kw):
    """A JAX DBM over quickly pretrained JAX RBMs of `sizes` (V, H1, H2),
    with its state initialized."""
    V, H1, H2 = sizes
    rng = np.random.RandomState(seed)
    X = (rng.rand(32, V) < 0.4).astype(np.float32)
    r1 = JaxBernoulliRBM(n_visible=V, n_hidden=H1, dbm_first=True,
                         max_epoch=1, batch_size=8, random_seed=1,
                         verbose=False, model_path=tmp + 'r1/').fit(X)
    r2 = JaxBernoulliRBM(n_visible=H1, n_hidden=H2, dbm_last=True,
                         max_epoch=1, batch_size=8, random_seed=2,
                         verbose=False, model_path=tmp + 'r2/')
    r2.fit(r1.transform(X))
    cfg = dict(n_particles=n_particles, n_gibbs_steps=2, max_mf_updates=10,
               mf_tol=1e-7, learning_rate=0.01, momentum=0.5, max_epoch=1,
               batch_size=8, max_norm=4., sample_v_states=False,
               sample_h_states=[False, False], random_seed=3, verbose=False,
               save_after_each_epoch=False)
    cfg.update(kw)
    dbm = JaxDBM(rbms=[r1, r2], model_path=tmp + 'dbm/', **cfg)
    dbm._ensure_state()
    return dbm, X


def torch_state(jdbm):
    return dbm_state_from_jax_arrays(jdbm._get_state_arrays(),
                                     device='cpu').as_dict()


def assert_state_close(jax_state, state, atol, keys=dbm_ops.STATE_KEYS):
    for key in keys:
        a, b = jax_state[key], state[key]
        pairs = zip(a, b) if isinstance(b, tuple) else [(a, b)]
        for i, (x, y) in enumerate(pairs):
            np.testing.assert_allclose(y.numpy(), np.asarray(x), atol=atol,
                                       rtol=0, err_msg='{0}[{1}]'.format(
                                           key, i))


# (layer sizes, max_mf_updates, mf_tol): the mean-field loop's edges
MF_EDGES = [
    ((12, 8, 6), 10, 1e-7),    # runs its budget or converges
    ((12, 8, 6), 1, 1e-7),     # a budget of one sweep
    ((12, 8, 6), 0, 1e-7),     # no sweep: the bottom-up init alone
    ((12, 8, 6), 10, 0.),      # tol 0: stops only at a change of exactly 0
    ((12, 8, 6), 10, 1.),      # every change is below 1: stops after one
    ((13, 9, 7), 10, 1e-7),    # widths no multiples of 4
]


@pytest.mark.parametrize('sizes,max_mf,tol', MF_EDGES)
def test_epoch_matches_jax_kernel_interpret(tmp_path, sizes, max_mf, tol):
    """#9: the epoch op's plain version against ``make_dbm_epoch_kernel(...,
    interpret=True)`` (the setup of tests/test_pallas_ops.py:495, with L2
    and sparsity on) at the mean-field loop's edges (MF_EDGES): state with
    particles atol 2e-5, msre 1e-5, the n_mf rows equal."""
    jdbm, X = jax_dbm(sizes, str(tmp_path) + '/')
    full, rem, _ = jdbm._stage_batches(X)
    assert rem is None
    args = (list(sizes), 8, 8, 2, max_mf, tol, False, [False, False], 1e-4,
            4., [0.2, 0.1], [1e-2, 5e-3], 0.9)
    state = torch_state(jdbm)
    s_j, msre_j, nmf_j = jax_make_dbm_epoch_kernel(*args, interpret=True)(
        jax.tree_util.tree_map(jnp.copy, jdbm._state), full, 0.01, 0.5, 7)
    s_t, msre_t, nmf_t = make_dbm_epoch_kernel(*args)(
        state, torch.tensor(np.asarray(full)), 0.01, 0.5, 7, 0)
    assert_state_close(s_j, s_t, 2e-5)
    np.testing.assert_allclose(msre_t.numpy(), np.asarray(msre_j), atol=1e-5)
    np.testing.assert_array_equal(nmf_t.numpy(), np.asarray(nmf_j))
    want = {1: [1.] * 4, 0: [0.] * 4}.get(max_mf)
    if tol == 1.:
        want = [1.] * 4
    if want is not None:
        assert nmf_t.tolist() == want
    # the input state is not modified
    assert_state_close(jdbm._state, state, 0.)


@pytest.mark.parametrize('n_steps', [0, 5])
def test_sample_matches_jax_xla(tmp_path, n_steps):
    """#10: n sweeps, then one on means; v takes the means, H keeps the last
    sweep's values (here means too: sampling off).  v and H atol 1e-5."""
    jdbm, _ = jax_dbm((12, 8, 6), str(tmp_path) + '/')
    prog = jdbm._program('sample_v', jdbm._sample_v_program)
    s_j, v_j = prog(jdbm._state, n_steps, jax.random.PRNGKey(0))
    cfg = DBMSampleConfig((12, 8, 6), False, (False, False))
    s_t, v_t = dbm_sample(cfg, torch_state(jdbm), n_steps, 3)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), atol=1e-5)
    assert_state_close(s_j, s_t, 1e-5, keys=('v', 'H'))
    assert s_t['v'] is v_t


def test_ais_matches_jax_xla(tmp_path):
    """#11 on 6-5-4 with 200 betas, k=2, sampling off: the plain AIS sweep
    against ``DBM._ais_program``.  The JAX kernel (and this port) take
    beta_i = f32(i) * f32(1/M) and anneal at beta_i + delta, the XLA
    program a float64 linspace cast to f32: the betas differ by ~1 ulp,
    which moves the log-weights (sums of 400 log p~ terms of ~10 nats) by
    ~1e-5; atol 1e-4."""
    jdbm, _ = jax_dbm((6, 5, 4), str(tmp_path) + '/', n_particles=4)
    x0 = (np.random.RandomState(5).rand(10, 5) < 0.5).astype(np.float32)
    prog = jdbm._ais_program(make_beta_schedule(200))
    want = np.asarray(prog(jdbm._state, 2, jax.random.PRNGKey(0), x0))
    ais = make_ais_kernel(6, 5, 4, 200, 2, 10, sample_v=False,
                          sample_h0=False, sample_h1=False)
    got = ais(torch_state(jdbm), 9, torch.tensor(x0)).numpy() + \
        15 * np.log(2.)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_ais_schedule_follows_the_jax_kernel():
    """x_1 = T(x_0, delta) is weighed at (0, delta); x_j at (beta_{j-1},
    beta_j); the last at (beta_{M-1}, 1); all in float32."""
    sched = ais_schedule(7)
    d = np.float32(1. / 7)
    assert sched.dtype == np.float32 and sched.shape == (7, 3)
    assert sched[0, 0] == d and sched[0, 1] == 0 and sched[0, 2] == d
    assert sched[3, 0] == np.float32(np.float32(3) * d + d)
    assert sched[3, 1] == np.float32(3) * d
    assert sched[-1, 2] == 1. and sched[-2, 2] == np.float32(6) * d
    one = ais_schedule(1)
    assert one.tolist() == [[1., 0., 1.]]


def test_sampling_draws_the_documented_streams(tmp_path):
    """With visible sampling on, the sampled v of the plain sampler is
    exactly 1[u < means] with the uniforms of key (seed, sweep), stream
    L; the sampled epoch differs from the means-only one."""
    jdbm, X = jax_dbm((12, 8, 6), str(tmp_path) + '/')
    state = torch_state(jdbm)
    W, vb, hb = state['W'], state['vb'], state['hb']
    H0 = torch.sigmoid(state['v'] @ W[0] + state['H'][1] @ W[1].T + hb[0])
    H1 = torch.sigmoid(H0 @ W[1] + hb[1])
    p_v = torch.sigmoid(H0 @ W[0].T + vb)
    cfg = DBMSampleConfig((12, 8, 6), True, (False, False))
    s, v_means = dbm_sample_reference(cfg, state, 1, 11)
    u = philox_uniform(11, 0, 2, p_v.shape)
    np.testing.assert_allclose(s['H'][1].numpy(), H1.numpy(), atol=1e-6)
    v_states = (u < p_v).float()
    expect = torch.sigmoid(torch.sigmoid(
        v_states @ W[0] + s['H'][1] @ W[1].T + hb[0]) @ W[0].T + vb)
    np.testing.assert_allclose(v_means.numpy(), expect.numpy(), atol=1e-6)
    assert stream_dbm(1, 2, 2) == 5

    X_b = torch.tensor(X.reshape(4, 8, 12))
    args = ((12, 8, 6), 8, 8, 1, 10, 1e-7)
    rest = (0., 4., [0.1, 0.1], [0., 0.], 0.9)
    on = make_dbm_epoch_kernel(*args, True, [True, True], *rest)
    off = make_dbm_epoch_kernel(*args, False, [False, False], *rest)
    s_on = on(state, X_b, 0.01, 0.5, 5, 0)[0]
    s_off = off(state, X_b, 0.01, 0.5, 5, 0)[0]
    assert set(np.unique(s_on['v'].numpy())) <= {0., 1.}
    assert not torch.equal(s_on['W'][0], s_off['W'][0])
    # same seed, same draws
    again = on(state, X_b, 0.01, 0.5, 5, 0)[0]
    assert torch.equal(again['W'][0], s_on['W'][0])


def test_ais_plain_version_sampled_is_seeded(tmp_path):
    """The sampled AIS sweep is a function of (state, seed, x0)."""
    jdbm, _ = jax_dbm((6, 5, 4), str(tmp_path) + '/', n_particles=4)
    state = torch_state(jdbm)
    x0 = torch.tensor((np.random.RandomState(1).rand(6, 5) < 0.5)
                      .astype(np.float32))
    ais = make_ais_kernel(6, 5, 4, 20, 1, 6)
    a, b, c = ais(state, 4, x0), ais(state, 4, x0), ais(state, 5, x0)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.all(torch.isfinite(a))


def test_wrappers_route_by_device_and_factories_check_config():
    """A CPU tensor runs the plain version and counts no launch; other
    devices raise; bad configurations raise."""
    before = dict(dbm_epoch.launches)
    sizes = (6, 5, 4)
    state = {'vb': torch.zeros(6), 'hb': (torch.zeros(5), torch.zeros(4)),
             'W': (torch.zeros(6, 5), torch.zeros(5, 4)),
             'dvb': torch.zeros(6), 'dhb': (torch.zeros(5), torch.zeros(4)),
             'dW': (torch.zeros(6, 5), torch.zeros(5, 4)),
             'q_means': (torch.zeros(5), torch.zeros(4)),
             'mu_means': (torch.zeros(5), torch.zeros(4)),
             'v': torch.full((3, 6), 0.5),
             'H': (torch.full((3, 5), 0.5), torch.full((3, 4), 0.5))}
    epoch = make_dbm_epoch_kernel(sizes, 2, 3, 1, 5, 1e-7, False,
                                  [False, False], 0., None, [0.1, 0.1],
                                  [0., 0.], 0.9)
    s, msre, nmf = epoch(state, torch.ones(2, 2, 6), 0.1, 0.5, 1, 0)
    assert dbm_epoch.launches == before
    # zero weights: one sweep changes nothing, so mean-field stops at 1
    # (the second minibatch sees the updated weights)
    assert nmf[0] == 1. and nmf[1] >= 1. and torch.all(msre > 0)
    with pytest.raises(ValueError, match='meta'):
        epoch(state, torch.ones(2, 2, 6, device='meta'), 0.1, 0.5, 1, 0)
    with pytest.raises(ValueError):
        make_dbm_epoch_kernel(sizes, 2, 3, 1, 5, 1e-7, False, [False], 0.,
                              None, [0.1, 0.1], [0., 0.], 0.9)
    with pytest.raises(ValueError):
        make_ais_kernel(6, 5, 4, 0, 1, 8)
    # the TPU's multiple-of-8 rule on n_runs is gone
    out = make_ais_kernel(6, 5, 4, 3, 1, 3)(state, 1, torch.zeros(3, 5))
    assert out.shape == (3,)
