"""The port's CUDA kernels (boltzmann_machines_tpu_torch/csrc/cd_epoch.cu and
csrc/dbm_ops.cu) against their plain PyTorch versions, on the card.  This
file imports no JAX, so it runs where the card is:

    BMT_TEST_TPU=1 python -m pytest tests/test_torch_cuda.py -q

(``BMT_TEST_TPU=1`` keeps tests/conftest.py from importing JAX.)  Without a
CUDA device every test skips."""

import numpy as np
import pytest
import torch

from boltzmann_machines_tpu_torch.ops import dbm_ops
from boltzmann_machines_tpu_torch.ops.cd_epoch import (
    CDEpochConfig, cd_epoch, cd_epoch_reference)

pytestmark = pytest.mark.requires_cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    # the plain version in true f32, as the kernels compute
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


def make_inputs(V, H, B, NB, dev, seed=0):
    rng = np.random.RandomState(seed)
    X = torch.as_tensor((rng.rand(NB, B, V) < 0.3).astype(np.float32),
                        device=dev)
    state = {
        'W': rng.randn(V, H) * 0.1, 'vb': rng.randn(V) * 0.1,
        'hb': rng.randn(H) * 0.1, 'dW': rng.randn(V, H) * 0.01,
        'dvb': rng.randn(V) * 0.01, 'dhb': rng.randn(H) * 0.01,
        'q_means': rng.rand(H),
    }
    return X, {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
               for k, v in state.items()}


# (V, H, B): the CPU tests' shape, and ragged ones that leave partial
# 64-wide tiles on every edge, with a batch of 1 and one above a tile
SHAPES = [(24, 16, 8), (37, 70, 3), (130, 65, 1), (50, 129, 67)]


@pytest.mark.parametrize('V,H,B', SHAPES)
@pytest.mark.parametrize('k', [0, 1, 2])
def test_kernels_match_plain_version_sampling_off(cuda, V, H, B, k):
    """atol 1e-5 on state (f32 sums in another order; q_means is a batch
    sum, so its atol scales by B), 1e-6 on msre, rtol 1e-5 on l2, 1e-3 on
    pll (V x a difference of two free energies)."""
    X, state = make_inputs(V, H, B, 5, cuda)
    cfg = CDEpochConfig(V, H, k, False, False, 1., 1., 1e-4, 0.1, 1e-2, 0.9,
                        2, True)
    got = cd_epoch(cfg, state, X, 0.05, 0.9, 3, 0)
    want = cd_epoch_reference(cfg, state, X, 0.05, 0.9, 3, 0)
    torch.cuda.synchronize()
    for key in got[0]:
        atol = 1e-5 * (B if key == 'q_means' else 1)
        torch.testing.assert_close(got[0][key], want[0][key], rtol=1e-5,
                                   atol=atol, msg=key)
    msre, pll, l2 = got[1:]
    torch.testing.assert_close(msre, want[1], rtol=0, atol=1e-6)
    torch.testing.assert_close(pll, want[2], rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(l2, want[3], rtol=1e-5, atol=0)
    assert float(l2[3]) > 0 and float(msre[0]) == 0
    assert (float(msre[1]) > 0) == (k > 0)  # k = 0: v_means = X


@pytest.mark.parametrize('V,H,B', SHAPES)
def test_kernels_match_plain_version_sampling_on(cuda, V, H, B):
    """Both sample visible and hidden states from the same Philox
    uniforms; at these sizes (~1e3 draws per step) a threshold flip is
    unlikely (~1e-4), so the epochs agree to the sampling-off tolerance."""
    X, state = make_inputs(V, H, B, 4, cuda, seed=1)
    cfg = CDEpochConfig(V, H, 1, True, True, 2., 1., 1e-4, 0.1, 1e-2, 0.9, 1,
                        True)
    got = cd_epoch(cfg, state, X, 0.05, 0.9, 17, 100)
    want = cd_epoch_reference(cfg, state, X, 0.05, 0.9, 17, 100)
    torch.cuda.synchronize()
    for key in got[0]:
        atol = 1e-5 * (B if key == 'q_means' else 1)
        torch.testing.assert_close(got[0][key], want[0][key], rtol=1e-5,
                                   atol=atol, msg=key)
    for a, b in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-5)


def test_launch_counts(cuda):
    V, H, B, NB, k = 24, 16, 8, 6, 2
    X, state = make_inputs(V, H, B, NB, cuda)
    cfg = CDEpochConfig(V, H, k, False, True, 1., 1., 1e-4, 0.1, 0., 0.9, 4,
                        False)
    before = dict(cd_epoch.launches)
    cd_epoch(cfg, state, X, 0.05, 0.9, 3, 1)
    diff = {n: cd_epoch.launches[n] - before[n] for n in before}
    # iterations 2..7; metrics where it % 4 == 0 (it = 4)
    assert diff == {'cd_gemm_act': NB * (1 + 2 * k), 'cd_bias_stats': NB,
                    'cd_assoc_update': NB, 'cd_metrics': 1}


def test_wrapper_rejects_bad_inputs(cuda):
    V, H, B = 24, 16, 8
    X, state = make_inputs(V, H, B, 2, cuda)
    cfg = CDEpochConfig(V, H, 1, False, False, 1., 1., 1e-4, 0.1, 0., 0.9, 2,
                        True)
    bad = dict(state, W=state['W'].T.contiguous().T)  # not contiguous
    with pytest.raises(ValueError, match='contiguous'):
        cd_epoch(cfg, bad, X, 0.05, 0.9, 3, 0)
    with pytest.raises(ValueError, match='float32'):
        cd_epoch(cfg, state, X.double(), 0.05, 0.9, 3, 0)
    with pytest.raises(ValueError, match='shape'):
        cd_epoch(cfg, dict(state, hb=state['hb'][:-1]), X, 0.05, 0.9, 3, 0)
    with pytest.raises(ValueError, match='X_batches'):
        cd_epoch(cfg, state, X[:, :, :-1], 0.05, 0.9, 3, 0)


# ---------------------------------------------------------------------- #
# DBM kernels (csrc/dbm_ops.cu)                                           #
# ---------------------------------------------------------------------- #
def make_dbm_inputs(sizes, B, M, NB, dev, seed=0):
    """A random DBM state, minibatches and particles of `sizes`."""
    rng = np.random.RandomState(seed)
    L = len(sizes) - 1

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=dev)

    hs = sizes[1:]
    state = {
        'vb': t(rng.randn(sizes[0]) * 0.1),
        'hb': tuple(t(rng.randn(h) * 0.1) for h in hs),
        'W': tuple(t(rng.randn(sizes[l], hs[l]) * 0.3) for l in range(L)),
        'dvb': t(rng.randn(sizes[0]) * 0.01),
        'dhb': tuple(t(rng.randn(h) * 0.01) for h in hs),
        'dW': tuple(t(rng.randn(sizes[l], hs[l]) * 0.01) for l in range(L)),
        'q_means': tuple(t(rng.rand(h) * B) for h in hs),
        'mu_means': tuple(t(rng.rand(h) * B) for h in hs),
        'v': t(rng.rand(M, sizes[0])),
        'H': tuple(t(rng.rand(M, h)) for h in hs),
    }
    X = t(rng.rand(NB, B, sizes[0]) < 0.3)
    return X, state


def dbm_config(sizes, k, max_mf, tol, sample, max_norm=2.):
    L = len(sizes) - 1
    return dbm_ops.DBMEpochConfig(
        tuple(sizes), k, max_mf, tol, sample, (sample,) * L, 1e-4, max_norm,
        (0.2,) * L, (1e-2,) * L, 0.9)


def assert_dbm_state_close(got, want, B, M, atol=1e-5):
    """atol 1e-5 on parameters and particles (f32 sums in another order);
    the sparsity EMAs are batch sums, so their atol scales by B + M."""
    for key in dbm_ops.STATE_KEYS:
        a, b = got[key], want[key]
        pairs = zip(a, b) if isinstance(b, tuple) else [(a, b)]
        scale = B + M if key in ('q_means', 'mu_means') else 1
        for x, y in pairs:
            torch.testing.assert_close(x, y, rtol=1e-5, atol=atol * scale,
                                       msg=key)


# (layer sizes, B, M): ragged tile edges everywhere, a 3-layer DBM
DBM_SHAPES = [((24, 16, 12), 8, 8), ((70, 37, 65, 20), 5, 67)]


@pytest.mark.parametrize('sizes,B,M', DBM_SHAPES)
@pytest.mark.parametrize('sample', [False, True])
@pytest.mark.parametrize('max_mf,tol', [(50, 1e-4), (3, 0.)])
def test_dbm_epoch_kernels_match_plain_version(cuda, sizes, B, M, sample,
                                               max_mf, tol):
    """Mean-field that converges before its budget (tol 1e-4) and one that
    never does (tol 0, 3 sweeps): same n_mf rows; msre atol 1e-6.  With
    sampling on (~1e3 draws per step) a threshold flip is unlikely, so the
    sampling-off tolerances hold."""
    X, state = make_dbm_inputs(sizes, B, M, 4, cuda)
    cfg = dbm_config(sizes, 2, max_mf, tol, sample)
    got = dbm_ops.dbm_epoch(cfg, state, X, 0.05, 0.5, 3, 10)
    want = dbm_ops.dbm_epoch_reference(cfg, state, X, 0.05, 0.5, 3, 10)
    torch.cuda.synchronize()
    assert_dbm_state_close(got[0], want[0], B, M)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-6)
    assert torch.equal(got[2], want[2])
    if tol:
        assert float(got[2].max()) < max_mf
    else:
        assert got[2].tolist() == [float(max_mf)] * 4


def test_dbm_epoch_launch_counts(cuda):
    """Every minibatch enqueues the whole mean-field budget; the sweeps
    after convergence return at once, and n_mf counts those that ran."""
    sizes, B, M, NB, k, max_mf = (24, 16, 12), 8, 8, 3, 2, 20
    X, state = make_dbm_inputs(sizes, B, M, NB, cuda)
    cfg = dbm_config(sizes, k, max_mf, 1e-4, False)
    dbm_ops.reset_launches()
    _, _, n_mf = dbm_ops.dbm_epoch(cfg, state, X, 0.05, 0.5, 3, 0)
    L = 2
    assert dbm_ops.dbm_epoch.launches == {
        'dbm_gemm_act': NB * (1 + L + L * max_mf + k * (L + 1) + 1),
        'dbm_mf_check': NB * max_mf, 'dbm_bias_update': NB * (L + 1),
        'dbm_assoc_update': NB * L, 'dbm_max_norm': NB * L,
        'dbm_msre': NB}
    assert 1 <= float(n_mf.min()) and float(n_mf.max()) < max_mf
    # no max-norm pass when max_norm is infinite
    dbm_ops.reset_launches()
    dbm_ops.dbm_epoch(dbm_config(sizes, k, max_mf, 1e-4, False,
                                 max_norm=float('inf')), state, X, 0.05,
                      0.5, 3, 0)
    assert dbm_ops.dbm_epoch.launches['dbm_max_norm'] == 0


@pytest.mark.parametrize('sizes,B,M', DBM_SHAPES)
@pytest.mark.parametrize('sample', [False, True])
def test_dbm_sample_kernel_matches_plain_version(cuda, sizes, B, M, sample):
    _, state = make_dbm_inputs(sizes, B, M, 1, cuda, seed=2)
    L = len(sizes) - 1
    cfg = dbm_ops.DBMSampleConfig(tuple(sizes), sample, (sample,) * L)
    dbm_ops.reset_launches()
    got = dbm_ops.dbm_sample(cfg, state, 4, 21)
    want = dbm_ops.dbm_sample_reference(cfg, state, 4, 21)
    torch.cuda.synchronize()
    assert dbm_ops.dbm_sample.launches['dbm_gemm_act'] == 4 * (L + 1) + 2
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-5)
    for a, b in zip(got[0]['H'], want[0]['H']):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    assert got[0]['v'] is got[1]


@pytest.mark.parametrize('sizes,R', [((24, 16, 12), 8), ((70, 37, 65), 13)])
@pytest.mark.parametrize('sample', [False, True])
def test_ais_kernel_matches_plain_version(cuda, sizes, R, sample):
    """Log-weights atol 2e-3: each log p~ is a sum of ~1e2 softplus terms
    of magnitude ~1e2 taken in another order, and 2 x 50 of them
    accumulate."""
    _, state = make_dbm_inputs(sizes, 4, 4, 1, cuda, seed=3)
    V, H1, H2 = sizes
    cfg = dbm_ops.AISConfig(V, H1, H2, 50, 2, sample, sample, sample)
    x0 = (torch.rand((R, H1), device=cuda) < 0.5).float()
    dbm_ops.reset_launches()
    got = dbm_ops.ais(cfg, state, 5, x0)
    want = dbm_ops.ais_reference(cfg, state, 5, x0)
    torch.cuda.synchronize()
    assert dbm_ops.ais.launches == {'dbm_gemm_act': 50 * (3 * 2 + 2),
                                    'ais_logw': 50}
    torch.testing.assert_close(got, want, rtol=0, atol=2e-3)


def test_dbm_wrappers_reject_bad_inputs(cuda):
    sizes = (24, 16, 12)
    X, state = make_dbm_inputs(sizes, 8, 8, 2, cuda)
    cfg = dbm_config(sizes, 1, 5, 1e-4, False)
    W0 = state['W'][0]
    bad = dict(state, W=(W0.T.contiguous().T, state['W'][1]))
    with pytest.raises(ValueError, match='contiguous'):
        dbm_ops.dbm_epoch(cfg, bad, X, 0.05, 0.5, 3, 0)
    with pytest.raises(ValueError, match='float32'):
        dbm_ops.dbm_epoch(cfg, state, X.double(), 0.05, 0.5, 3, 0)
    with pytest.raises(ValueError, match='shape'):
        dbm_ops.dbm_epoch(cfg, dict(state, vb=state['vb'][:-1]), X, 0.05,
                          0.5, 3, 0)
    with pytest.raises(ValueError, match='X_batches'):
        dbm_ops.dbm_epoch(cfg, state, X[:, :, :-1], 0.05, 0.5, 3, 0)
    with pytest.raises(ValueError, match='shape'):
        dbm_ops.dbm_sample(dbm_ops.DBMSampleConfig(sizes, False,
                                                   (False, False)),
                           dict(state, H=(state['H'][0][:, :-1].contiguous(),
                                          state['H'][1])), 2, 1)
    acfg = dbm_ops.AISConfig(24, 16, 12, 5, 1, False, False, False)
    with pytest.raises(ValueError, match='x0'):
        dbm_ops.ais(acfg, state, 1, torch.zeros((4, 15), device=cuda))
