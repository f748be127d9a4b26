"""How far float32 rounding alone moves the port's PLL: the plain version
(``ops/cd_epoch.metrics_reference``) in float32 against the same function
in float64 on the same inputs and flips, at small widths on the CPU.

Both sides flip the same units (drawn from the seed, not from the
inputs).  The PLL is V log sigmoid(fe(x_f) - fe(x)), a difference of two
batch-mean free energies whose visible and hidden parts have magnitude S =
(|t_vis| + |t_hid|) / B each.  Rounding either sum to float32 moves it by
a few ulps of S, and log sigmoid passes a change of the difference on at a
slope below 1, so the PLL moves by a few V eps S.  At the G-RBM's 3072 x 5000
(S ~ 1e3-1e4) that is ~0.4-4 nats: the scale of the kernels' error against
the plain float32 version there (``chip_smoke.py --pll-readings`` reads
both against float64 on the card)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from boltzmann_machines_tpu_torch.ops.cd_epoch import (
    CDEpochConfig, metrics_reference, pll_h_hats, sigma_row)

EPS32 = float(np.finfo(np.float32).eps)
#: |pll f32 - pll f64| <= ULPS V eps S; the largest seen at these widths
#: over 30 seeds is 5.6 (multinomial hidden units, 24 x 16), 0.9 with
#: Bernoulli ones
ULPS = 16.
FLAVOURS = [('bernoulli', 'bernoulli', None), ('gaussian', 'bernoulli', None),
            ('bernoulli', 'multinomial', 50)]


def magnitude(X, W, vb, hb, cfg, h_hat):
    """S: |visible part| + |hidden part| of the batch-mean free energy of X
    (the terms of ops/cd_epoch.free_energy_sum)."""
    if cfg.visible == 'gaussian':
        d = X - vb / sigma_row(cfg, X.device).to(X.dtype)
        t_vis = 0.5 * torch.sum(d * d)
    else:
        t_vis = -torch.sum(X * vb)
    act = X @ W
    t_hid = -torch.sum(act * h_hat) if cfg.hidden == 'multinomial' else \
        -torch.sum(F.softplus(act + hb))
    return (abs(float(t_vis)) + abs(float(t_hid))) / X.shape[0]


@pytest.mark.parametrize('V,H,B', [(24, 16, 8), (48, 40, 8), (96, 80, 16)])
@pytest.mark.parametrize('visible,hidden,n', FLAVOURS)
def test_plain_pll_float32_within_rounding_of_float64(V, H, B, visible,
                                                      hidden, n):
    for seed in range(5):
        rng = np.random.RandomState(seed)
        W = (rng.randn(V, H) * 0.1).astype(np.float32)
        vb = (rng.randn(V) * 0.5).astype(np.float32)
        hb = (rng.randn(H) * 0.5).astype(np.float32)
        X = (rng.randn(B, V) if visible == 'gaussian'
             else rng.rand(B, V) < 0.3).astype(np.float32)
        sigma = (0.5 + rng.rand(V)).astype(np.float32) \
            if visible == 'gaussian' else None
        cfg = CDEpochConfig(V, H, 1, False, False, 1., 1., 0., 0.1, 0., 0.9,
                            1, True, visible, sigma, hidden, n)
        t32 = [torch.as_tensor(a) for a in (X, W, vb, hb)] + \
            [torch.zeros(V)]
        t64 = [a.double() for a in t32]
        pll32 = float(metrics_reference(cfg, *t32, 7, 3)[1])
        pll64 = float(metrics_reference(cfg, *t64, 7, 3)[1])
        h_hat = pll_h_hats(cfg, 7, 3, 'cpu')[0]
        S = magnitude(*t64[:4], cfg,
                      None if h_hat is None else h_hat.double())
        assert pll64 < 0 and np.isfinite(pll32)
        assert abs(pll32 - pll64) <= ULPS * V * EPS32 * S, (seed, pll32,
                                                            pll64, S)
