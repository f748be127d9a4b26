"""The port's CUDA kernels (boltzmann_machines_tpu_torch/csrc/cd_epoch.cu)
against their plain PyTorch version, on the card.  This file imports no
JAX, so it runs where the card is:

    BMT_TEST_TPU=1 python -m pytest tests/test_torch_cuda.py -q

(``BMT_TEST_TPU=1`` keeps tests/conftest.py from importing JAX.)  Without a
CUDA device every test skips."""

import numpy as np
import pytest
import torch

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
