"""The metrics of a logged CD step (the port's cd_metrics kernels,
boltzmann_machines_tpu_torch/csrc/cd_epoch.cu, K4) written in plain torch as
the kernels decompose them, against the JAX package's fused epoch kernel in
interpret mode and against the port's plain version (``pll_from_flip``), at
a small size on the CPU, for Bernoulli and Gaussian visible units x
Bernoulli and multinomial hidden units.

The decomposition: the flipped row's product is ``x_f.W = x.W + d W[flip]``
with ``d = 1 - 2 x[flip]`` (no second product); the multinomial hidden term
``-(x.W).h_hat`` is ``-x.(W h_hat)`` (no B x V x H product); the softplus
terms are summed per (row, 128-column tile) and the rest per block of rows
of W, and those partial sums are added in a fixed order.  Inputs are made
with numpy from a seed and handed to both packages.  The kernels are held
against the plain version on the card in tests/test_torch_cuda.py."""

import itertools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from boltzmann_machines_tpu.ops.pallas_ops import (
    _free_energy_sum, make_cd_epoch_kernel as jax_make_cd_epoch_kernel)
from boltzmann_machines_tpu_torch.ops.cd_epoch import (
    CDEpochConfig, h_means_reference, metrics_reference, pll_flip_index,
    pll_h_hats, sigma_row, v_means_reference)

FLAVOURS = [('bernoulli', 'bernoulli'), ('gaussian', 'bernoulli'),
            ('bernoulli', 'multinomial'), ('gaussian', 'multinomial')]
N_SAMPLES = 12
TILE = 128      # model columns of one tile of the product (csrc/gemm_tc.cuh)
W_ROWS = 8      # rows of W a block of the pass over W (a small plan)


def config(V, H, visible, hidden, l2=1e-4, sigma=1.5):
    return CDEpochConfig(V, H, 1, False, False, 1., 1., l2, 0.1, 0., 0.9, 1,
                         True, visible, sigma if visible == 'gaussian'
                         else None, hidden,
                         N_SAMPLES if hidden == 'multinomial' else None)


def flipped(X, flip):
    rows = torch.arange(X.shape[0])
    x = X[rows, flip]
    Xf = X.clone()
    Xf[rows, flip] = 1. - x
    return Xf, (1. - x) - x


def fe_parts(cfg, X, W, vb, hb, flip, h_hats, w_rows=W_ROWS):
    """The kernels' six sums, each added over its partials in a fixed
    order: |W|^2 is not formed here; (visible term of x, of x_f, hidden
    term of x, of x_f), the visible terms per block of `w_rows` columns of
    X, the hidden ones per (row, tile) of the product (Bernoulli) or per
    block of rows of W (multinomial: x.u with u = W h_hat)."""
    B, V = X.shape
    H = W.shape[1]
    sigma = sigma_row(cfg, X.device)
    Xf, d = flipped(X, flip)
    blocks = []
    for v0 in range(0, V, w_rows):
        s = slice(v0, v0 + w_rows)
        if sigma is not None:
            c = vb[s] / sigma[s]
            tv, tvf = (torch.sum(torch.square(A[:, s] - c)) for A in (X, Xf))
        else:
            tv, tvf = (torch.sum(A[:, s] * vb[s]) for A in (X, Xf))
        th = thf = torch.zeros(())
        if cfg.hidden == 'multinomial':
            u, uf = (W[s] @ hh[0] for hh in h_hats)
            th, thf = torch.sum(X[:, s] @ u), torch.sum(Xf[:, s] @ uf)
        blocks.append(torch.stack([tv, tvf, th, thf]))
    tv, tvf, th, thf = torch.stack(blocks).sum(0)
    if cfg.hidden == 'bernoulli':
        A = X @ W
        Af = A + d[:, None] * W[flip]
        rows = [torch.stack([F.softplus(P[:, t:t + TILE] + hb[t:t + TILE])
                             .sum(1) for t in range(0, H, TILE)], 1)
                for P in (A, Af)]
        th, thf = rows[0].sum(), rows[1].sum()
    return tv, tvf, th, thf


def metrics_by_parts(cfg, X, W, vb, hb, msre_col, seed, it, w_rows=W_ROWS):
    """(msre, pll, l2) of a logged step as the kernels compute them."""
    B, V = X.shape
    flip = pll_flip_index(seed, it, B, V, X.device)
    h_hats = pll_h_hats(cfg, seed, it, X.device)
    sq = torch.stack([torch.sum(W[v0:v0 + w_rows] ** 2)
                      for v0 in range(0, V, w_rows)]).sum()
    ms = torch.stack([torch.sum(msre_col[v0:v0 + w_rows])
                      for v0 in range(0, V, w_rows)]).sum()
    tv, tvf, th, thf = fe_parts(cfg, X, W, vb, hb, flip, h_hats, w_rows)
    gaussian = cfg.visible == 'gaussian'
    fe = ((0.5 * tv if gaussian else -tv) - th) / B
    fe_f = ((0.5 * tvf if gaussian else -tvf) - thf) / B
    return ms / (B * V), V * F.logsigmoid(fe_f - fe), cfg.l2 * 0.5 * sq


def inputs(V, H, B, visible, seed):
    rng = np.random.RandomState(seed)
    X = (1.5 * rng.randn(B, V) if visible == 'gaussian'
         else rng.rand(B, V) < 0.3).astype(np.float32)
    W = (0.1 * rng.randn(V, H)).astype(np.float32)
    vb = (0.1 * rng.randn(V)).astype(np.float32)
    hb = (0.1 * rng.randn(H)).astype(np.float32)
    vm = rng.rand(B, V).astype(np.float32)
    return X, W, vb, hb, vm


@pytest.mark.parametrize('V,H,B', [(24, 16, 8), (37, 300, 5), (130, 65, 1)])
@pytest.mark.parametrize('visible,hidden', FLAVOURS)
def test_decomposition_matches_plain_version(V, H, B, visible, hidden):
    """The decomposition against ``metrics_reference`` (``pll_from_flip``:
    both products formed, the batch's free energies summed whole) on the
    same inputs: the pieces (x_f.W, x.(W h_hat)) within 1e-6 of the plain
    products, msre within 1e-6, pll within 1e-4 (rtol and atol: V x a
    difference of two f32 free energies summed in another order), l2 within
    rtol 1e-5.  (37, 300) cuts H into three tiles, the last one short."""
    X, W, vb, hb, vm = (torch.as_tensor(a) for a in inputs(
        V, H, B, visible, V + H + B))
    cfg = config(V, H, visible, hidden)
    msre_col = torch.sum(torch.square(X - vm), 0)
    flip = pll_flip_index(5, 3, B, V, 'cpu')
    Xf, d = flipped(X, flip)
    torch.testing.assert_close(X @ W + d[:, None] * W[flip], Xf @ W,
                               rtol=0, atol=1e-6)
    if hidden == 'multinomial':
        hh = pll_h_hats(cfg, 5, 3, 'cpu')[0]
        torch.testing.assert_close(X @ (W @ hh[0]), (X @ W) @ hh[0],
                                   rtol=1e-6, atol=1e-6)
    got = metrics_by_parts(cfg, X, W, vb, hb, msre_col, 5, 3)
    want = metrics_reference(cfg, X, W, vb, hb, msre_col, 5, 3)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-6)
    torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=0)
    assert float(got[1]) < 0


def jax_epoch_rows(V, H, B, visible, hidden, X, state):
    """One logged step of the JAX epoch kernel in interpret mode, sampling
    off, k = 1, PLL on: (post-update state, msre, pll, l2)."""
    epoch = jax_make_cd_epoch_kernel(
        V, H, B, 1, sample_v_states=False, sample_h_states=False,
        propup_mult=1., propdown_mult=1., l2=1e-4, sparsity_target=0.1,
        sparsity_cost=0., sparsity_damping=0.9, metrics_every=1,
        compute_pll=True, visible=visible,
        sigma=1.5 if visible == 'gaussian' else None, hidden=hidden,
        n_samples=N_SAMPLES if hidden == 'multinomial' else None,
        interpret=True)
    s, msre, pll, l2 = epoch({k: jnp.asarray(v) for k, v in state.items()},
                             jnp.asarray(X[None]), 0.01, 0.9, 7, 0)
    row = [float(np.asarray(r).reshape(-1)[0]) for r in (msre, pll, l2)]
    return {k: torch.as_tensor(np.array(v)) for k, v in s.items()}, row


@pytest.mark.parametrize('visible,hidden', FLAVOURS)
def test_decomposition_matches_jax_kernel_rows(visible, hidden):
    """The JAX kernel's metric rows of one logged step (interpret mode):
    the decomposition on the kernel's post-update state gives its msre
    (atol 1e-5; msre_col from the plain chain's v_means on the state before
    the update) and its l2 (rtol 1e-4), the tolerances of
    tests/test_torch_cd_epoch.py.  The JAX kernel flips units (and, for
    multinomial hidden units, draws count vectors) from its own generator:
    with Bernoulli hidden units its PLL equals the decomposition's
    V log_sigmoid(mean over rows of fe(x_f) - fe(x)) for SOME assignment
    of flipped units (within 5e-4; the assignments lie far enough apart
    that a wrong sign or term could not hide), with multinomial ones it is
    finite and negative, and the decomposition equals the JAX package's
    ``_free_energy_sum`` on the port's flips and count vectors (rtol
    1e-5)."""
    V, H, B = 8, 8, 4
    X, W, vb, hb, _ = inputs(V, H, B, visible, 11)
    rng = np.random.RandomState(12)
    state = {'W': W, 'vb': vb, 'hb': hb,
             'dW': (0.01 * rng.randn(V, H)).astype(np.float32),
             'dvb': (0.01 * rng.randn(V)).astype(np.float32),
             'dhb': (0.01 * rng.randn(H)).astype(np.float32),
             'q_means': rng.rand(H).astype(np.float32)}
    s, (msre_jax, pll_jax, l2_jax) = jax_epoch_rows(V, H, B, visible, hidden,
                                                    X, state)
    cfg = config(V, H, visible, hidden)
    Xt = torch.as_tensor(X)
    t0 = {k: torch.as_tensor(v) for k, v in state.items()}
    sigma = sigma_row(cfg, 'cpu')
    h0 = h_means_reference(cfg, Xt, t0['W'], t0['hb'])
    v_means = v_means_reference(cfg, h0, t0['W'], t0['vb'], sigma)
    msre_col = torch.sum(torch.square(Xt - v_means), 0)
    msre, pll, l2 = metrics_by_parts(cfg, Xt, s['W'], s['vb'], s['hb'],
                                     msre_col, 7, 1)
    np.testing.assert_allclose(float(msre), msre_jax, atol=1e-5)
    np.testing.assert_allclose(float(l2), l2_jax, rtol=1e-4)
    assert np.isfinite(pll_jax) and pll_jax < 0

    if hidden == 'bernoulli':
        # per row r and unit j: the decomposition's fe(x_f) - fe(x)
        delta = np.empty((B, V))
        for r, j in itertools.product(range(B), range(V)):
            parts = fe_parts(cfg, Xt[r:r + 1], s['W'], s['vb'], s['hb'],
                             torch.tensor([j]), (None, None))
            tv, tvf, th, thf = (float(p) for p in parts)
            k = 0.5 if visible == 'gaussian' else -1.
            delta[r, j] = (k * tvf - thf) - (k * tv - th)
        grids = np.meshgrid(*[delta[r] for r in range(B)], indexing='ij')
        cand = V * -np.log1p(np.exp(-sum(grids) / float(B)))
        dist = np.sort(np.abs(cand.ravel() - pll_jax))
        assert dist[0] < 5e-4, (pll_jax, dist[:3])
        assert np.median(dist) > 5e-2
        return

    flip = pll_flip_index(7, 1, B, V, 'cpu')
    Xf, _ = flipped(Xt, flip)
    h_hats = pll_h_hats(cfg, 7, 1, 'cpu')
    sig = jnp.asarray(sigma.numpy())[None] if sigma is not None else None

    def fe_jax(A, hh):
        A = jnp.asarray(A.numpy())
        return float(_free_energy_sum(
            A, A @ jnp.asarray(s['W'].numpy()),
            jnp.asarray(s['vb'].numpy())[None],
            jnp.asarray(s['hb'].numpy())[None], sig, visible, hidden,
            jnp.asarray(hh.numpy()))) / B

    want = V * float(jax.nn.log_sigmoid(fe_jax(Xf, h_hats[1])
                                        - fe_jax(Xt, h_hats[0])))
    np.testing.assert_allclose(float(pll), want, rtol=1e-5, atol=1e-5)
