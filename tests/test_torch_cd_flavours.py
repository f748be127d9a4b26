"""The Gaussian-visible and multinomial-hidden CD epoch of the port
(boltzmann_machines_tpu_torch/ops/cd_epoch.py), its samplers and its
free-energy probe (ops/samplers.py) against the JAX package's Pallas
kernels in interpret mode, and their own statistics, at a small size on the
CPU.  Inputs are made with numpy from a seed and handed to both packages.
The CUDA kernels are held against the plain versions in
tests/test_torch_cuda.py."""

import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from boltzmann_machines_tpu.ops.pallas_ops import (
    _free_energy_sum, make_cd_epoch_kernel as jax_make_cd_epoch_kernel,
    make_free_energy_probe as jax_make_free_energy_probe,
    make_tiled_cd_epoch_kernel as jax_make_tiled_cd_epoch_kernel)
from boltzmann_machines_tpu_torch.ops.cd_epoch import (
    CDEpochConfig, cd_epoch_reference, free_energy_sum, make_cd_epoch_kernel,
    pll_flip_index, pll_from_flip, pll_h_hats, uniform_h_hat)
from boltzmann_machines_tpu_torch.ops.philox import (
    multinomial_counts, normal, philox_uniform, philox_uniform2)
from boltzmann_machines_tpu_torch.ops.samplers import (
    make_free_energy_probe, multinomial_sample, normal_sample)

V, H, B, NB = 24, 16, 8, 4
CONFIG = dict(propup_mult=1., propdown_mult=1., l2=1e-5,
              sparsity_target=0.1, sparsity_cost=1e-2,
              sparsity_damping=0.9, metrics_every=2)
LR, MOMENTUM = 0.01, 0.9


def make_state(V, H, seed):
    rng = np.random.RandomState(seed)
    return {
        'W': (rng.randn(V, H) * 0.1).astype(np.float32),
        'vb': (rng.randn(V) * 0.1).astype(np.float32),
        'hb': (rng.randn(H) * 0.1).astype(np.float32),
        'dW': (rng.randn(V, H) * 0.01).astype(np.float32),
        'dvb': (rng.randn(V) * 0.01).astype(np.float32),
        'dhb': (rng.randn(H) * 0.01).astype(np.float32),
        'q_means': rng.rand(H).astype(np.float32),
    }


def make_X(visible, shape, seed):
    rng = np.random.RandomState(seed)
    if visible == 'gaussian':
        return rng.randn(*shape).astype(np.float32)
    return (rng.rand(*shape) < 0.3).astype(np.float32)


def torch_state(state):
    return {k: torch.as_tensor(v) for k, v in state.items()}


def jax_state(state):
    return {k: jnp.asarray(v) for k, v in state.items()}


def assert_epochs_close(got, want, B):
    """Tolerances of tests/test_pallas_ops.py:599-601: atol 2e-5 on state
    (f32 sums in another order), q_means a batch SUM so its atol scales by
    B, msre atol 1e-5, l2 rtol 1e-4."""
    s, msre, _, l2 = got
    s_jax, msre_jax, _, l2_jax = want
    for key in ('W', 'vb', 'hb', 'dW', 'dvb', 'dhb'):
        np.testing.assert_allclose(s[key].numpy(), np.asarray(s_jax[key]),
                                   atol=2e-5, err_msg=key)
    np.testing.assert_allclose(s['q_means'].numpy(),
                               np.asarray(s_jax['q_means']), atol=2e-5 * B)
    np.testing.assert_allclose(msre.numpy(), np.asarray(msre_jax), atol=1e-5)
    np.testing.assert_allclose(l2.numpy(), np.asarray(l2_jax), rtol=1e-4)


FLAVOURS = {
    'gaussian_scalar': dict(visible='gaussian', sigma=1.5),
    'gaussian_per_unit': dict(
        visible='gaussian',
        sigma=(np.random.RandomState(9).rand(V) + 0.5).astype(np.float32)),
    'multinomial': dict(hidden='multinomial', n_samples=12),
}


@pytest.mark.parametrize('k', [1, 2])
@pytest.mark.parametrize('flavour', sorted(FLAVOURS))
def test_reference_matches_jax_kernel(flavour, k):
    """Sampling off: the plain version of each new flavour equals the JAX
    epoch kernel in interpret mode, with dbm doubling on the side it
    scales (propup for multinomial hiddens, propdown for Gaussian
    visibles: the multiplier scales the product only through sigma)."""
    kw = FLAVOURS[flavour]
    config = dict(CONFIG, **({'propdown_mult': 2.} if 'sigma' in kw
                             else {'propup_mult': 2.}))
    X = make_X(kw.get('visible'), (NB, B, V), 1)
    state = make_state(V, H, 2)
    epoch = jax_make_cd_epoch_kernel(
        V, H, B, k, sample_v_states=False, sample_h_states=False,
        compute_pll=False, interpret=True, **config, **kw)
    want = epoch(jax_state(state), jnp.asarray(X), LR, MOMENTUM, 7, 0)
    got = make_cd_epoch_kernel(V, H, B, k, False, False, compute_pll=False,
                               **config, **kw)(
        torch_state(state), torch.as_tensor(X), LR, MOMENTUM, 7, 0)
    assert_epochs_close(got, want, B)
    assert float(got[1][1]) > 0 and float(got[1][0]) == 0


@pytest.mark.parametrize('visible', ['bernoulli', 'gaussian'])
def test_reference_matches_jax_tiled_kernel(visible):
    """The TPU's hidden-tiled epoch (W streamed in 128-wide tiles, H = 200
    padded to 256) computes the same function as the port's one kernel
    family; msre on the logged iterations."""
    H2 = 200
    kw = dict(visible=visible, sigma=1. if visible == 'gaussian' else None)
    X = make_X('gaussian', (NB, B, V), 3)   # the tiled kernel's test data
    state = make_state(V, H2, 4)
    epoch = jax_make_tiled_cd_epoch_kernel(
        V, H2, B, 1, sample_v_states=False, sample_h_states=False,
        tile=128, interpret=True, **CONFIG, **kw)
    want = epoch(jax_state(state), jnp.asarray(X), LR, MOMENTUM, 7, 0)
    got = make_cd_epoch_kernel(V, H2, B, 1, False, False, compute_pll=False,
                               **CONFIG, **kw)(
        torch_state(state), torch.as_tensor(X), LR, MOMENTUM, 7, 0)
    assert_epochs_close(got, want, B)
    logged = (np.arange(1, NB + 1) % CONFIG['metrics_every']) == 0
    np.testing.assert_allclose(got[1].numpy()[logged],
                               np.asarray(want[1])[logged], atol=1e-5)


def test_gaussian_pll_matches_some_flip_assignment():
    """The flip-assignment golden of tests/test_pallas_ops.py:1000-1059 on
    the port: with sampling off the epoch's PLL equals V log_sigmoid of the
    mean over rows of FE(x with unit j_r flipped) - FE(x) (JAX
    `_free_energy_sum` per row, on the port's post-update state) for SOME
    assignment (j_1..j_B), within 5e-4; the assignments are spaced widely
    enough that a wrong constant or sign could not hide."""
    V, H, B = 8, 8, 4
    X = (np.random.RandomState(0).randn(1, B, V) * 1.5).astype(np.float32)
    state = make_state(V, H, 5)
    epoch = make_cd_epoch_kernel(V, H, B, 1, False, False, propup_mult=1.,
                                 propdown_mult=1., l2=0.,
                                 sparsity_target=0.1, sparsity_cost=0.,
                                 sparsity_damping=0.9, metrics_every=1,
                                 visible='gaussian', sigma=1.)
    s, _, pll, _ = epoch(torch_state(state), torch.as_tensor(X), 1e-2, 0.9,
                         7, 0)
    pll = float(pll[0])
    assert np.isfinite(pll) and pll < 0
    W, vb, hb = (jnp.asarray(s[k].numpy()) for k in ('W', 'vb', 'hb'))
    ones = jnp.ones((1, V), jnp.float32)

    def fe_row(v):
        v = jnp.asarray(v)[None, :]
        return float(_free_energy_sum(v, v @ W, vb[None], hb[None], ones,
                                      'gaussian', 'bernoulli', None))

    base = np.array([fe_row(X[0, r]) for r in range(B)])
    delta = np.empty((B, V))
    for r, j in itertools.product(range(B), range(V)):
        xf = X[0, r].copy()
        xf[j] = 1. - xf[j]
        delta[r, j] = fe_row(xf) - base[r]
    grids = np.meshgrid(*[delta[r] for r in range(B)], indexing='ij')
    cand = V * -np.log1p(np.exp(-sum(grids) / float(B)))
    dist = np.sort(np.abs(cand.ravel() - pll))
    assert dist[0] < 5e-4, (pll, dist[:3])
    assert np.median(dist) > 5e-2
    # and it is the assignment of the Philox flip of iteration 1
    flip = pll_flip_index(7, 1, B, V, 'cpu').numpy()
    np.testing.assert_allclose(
        V * -np.log1p(np.exp(-delta[np.arange(B), flip].mean())), pll,
        atol=5e-4)


@pytest.mark.parametrize('sigma', [1., 'per_unit'])
def test_gaussian_free_energy_sum_matches_jax(sigma):
    """`free_energy_sum(gaussian)` against JAX `_free_energy_sum` on the
    same inputs, rtol 1e-5 (inputs of std 3, so that the quadratic term
    dominates and the sum does not cancel to near zero)."""
    rng = np.random.RandomState(6)
    X = (3. * rng.randn(B, V)).astype(np.float32)
    st = make_state(V, H, 7)
    sig = np.full(V, 1., np.float32) if sigma == 1. \
        else (rng.rand(V) + 0.5).astype(np.float32)
    act = X @ st['W']
    fe_jax = _free_energy_sum(jnp.asarray(X), jnp.asarray(act),
                              jnp.asarray(st['vb'])[None],
                              jnp.asarray(st['hb'])[None],
                              jnp.asarray(sig)[None], 'gaussian', 'bernoulli',
                              None)
    fe = free_energy_sum(torch.as_tensor(X), torch.as_tensor(act),
                         torch.as_tensor(st['vb']), torch.as_tensor(st['hb']),
                         'gaussian', 'bernoulli', torch.as_tensor(sig))
    np.testing.assert_allclose(float(fe), float(fe_jax), rtol=1e-5)


def test_multinomial_pll_given_draw_matches_jax():
    """The multinomial PLL row, given the port's two count vectors: both
    packages' `_free_energy_sum` on the same h_hats agree within rtol 1e-5,
    and each h_hat holds non-negative integers summing to n."""
    n = 12
    rng = np.random.RandomState(8)
    X = (rng.rand(1, B, V) < 0.3).astype(np.float32)
    st = make_state(V, H, 9)
    epoch = make_cd_epoch_kernel(V, H, B, 1, False, False, hidden='multinomial',
                                 n_samples=n, **dict(CONFIG, metrics_every=1))
    s, _, pll, _ = epoch(torch_state(st), torch.as_tensor(X), LR, MOMENTUM,
                         5, 0)
    cfg = CDEpochConfig(V, H, 1, False, False, 1., 1., 0., 0., 0., 0., 1,
                        True, hidden='multinomial', n_samples=n)
    h_hats = pll_h_hats(cfg, 5, 1, 'cpu')
    for hh in h_hats:
        assert hh.shape == (1, H) and float(hh.sum()) == n
        assert bool((hh >= 0).all()) and torch.equal(hh, torch.round(hh))
    assert not torch.equal(h_hats[0], h_hats[1])   # independent draws
    flip = pll_flip_index(5, 1, B, V, 'cpu')
    Xb = torch.as_tensor(X[0])
    Xf = Xb.clone()
    Xf[torch.arange(B), flip] = 1. - Xf[torch.arange(B), flip]
    W, vb, hb = s['W'], s['vb'], s['hb']

    def fe_jax(Xv, hh):
        Xv = jnp.asarray(Xv.numpy())
        return float(_free_energy_sum(
            Xv, Xv @ jnp.asarray(W.numpy()), jnp.asarray(vb.numpy())[None],
            jnp.asarray(hb.numpy())[None], None, 'bernoulli', 'multinomial',
            jnp.asarray(hh.numpy()))) / B

    pll_jax = V * float(jax.nn.log_sigmoid(fe_jax(Xf, h_hats[1])
                                           - fe_jax(Xb, h_hats[0])))
    np.testing.assert_allclose(float(pll[0]), pll_jax, rtol=1e-5, atol=1e-5)
    expect = pll_from_flip(Xb, flip, W, vb, hb, 'bernoulli', 'multinomial',
                           None, h_hats)
    np.testing.assert_allclose(float(pll[0]), float(expect), rtol=1e-6)


@pytest.mark.parametrize('S', [100, 513])
def test_multinomial_sampler_distribution(S):
    """tests/test_pallas_ops.py:226-260 on the port's sampler: every row
    sums exactly to S, no count is negative, and the mean counts are within
    6 standard errors of the expected counts (n = 513 is above bf16's
    integer range, the TPU's trap)."""
    rows, Hs = 512, 128
    probs = np.random.RandomState(0).dirichlet(np.ones(Hs))
    means = torch.as_tensor(np.broadcast_to(S * probs, (rows, Hs))
                            .astype(np.float32).copy())
    draws = torch.cat([multinomial_sample(seed, means, S)
                       for seed in (1, 2, 3, 4)]).numpy()
    assert (draws.sum(-1) == S).all() and (draws >= 0).all()
    np.testing.assert_array_equal(draws, np.round(draws))
    se = np.sqrt(S * probs * (1 - probs) / len(draws))
    assert (np.abs(draws.mean(0) - S * probs) < 6 * se + 1e-9).all()
    var_ratio = draws.var(0) / (S * probs * (1 - probs))
    assert np.abs(var_ratio[probs > 0.01] - 1).max() < 0.3


def check_box_muller(z):
    """Mean and variance of the (512, 512) normals `z` of seed 3 within 6
    standard errors of 0 and 1, and each normal the Box-Muller of its
    counter's two uniforms evaluated in float64 (Python's math, not a
    vectorised loop) on the port's float32 arguments -- u1 clamped to 1e-7,
    the cos argument float32(2 pi) u2 rounded to float32 as the port rounds
    it -- within 4e-6 (1 + |z|), a few float32 ulps of log and cos, with room
    for a rounding mode other than to-nearest."""
    import math
    z = z.astype(np.float64)
    n = z.size
    assert abs(z.mean()) < 6 / np.sqrt(n)
    assert abs(z.var() - 1.) < 6 * np.sqrt(2. / n)
    u1, u2 = (u.numpy() for u in philox_uniform2(3, 0, 0, (512, 512)))
    arg = (np.float32(2 * np.pi) * u2).astype(np.float32)
    u1 = np.maximum(u1, np.float32(1e-7))
    r = np.array([math.sqrt(-2. * math.log(x)) for x in u1.ravel().tolist()])
    c = np.array([math.cos(x) for x in arg.ravel().tolist()])
    z64 = (r * c).reshape(z.shape)
    excess = np.abs(z - z64) - 4e-6 * (1. + np.abs(z64))
    worst = np.unravel_index(np.argmax(excess), z.shape)
    assert excess.max() <= 0., (
        '%d of %d normals beyond the tolerance; worst %s: port %r, float64 '
        '%r (u1 %r, u2 %r)' % ((excess > 0).sum(), n, worst, z[worst],
                               z64[worst], u1[worst], u2[worst]))


def test_box_muller_moments():
    """Box-Muller on the port's Philox words: 2^18 draws held to
    `check_box_muller`'s moments and per-element tolerance."""
    check_box_muller(normal_sample(3, (512, 512), device='cpu').numpy())
    # word 0 is the uniform every other draw uses
    torch.testing.assert_close(philox_uniform2(3, 0, 0, (64,))[0],
                               philox_uniform(3, 0, 0, (64,)), rtol=0,
                               atol=0)


# The normals as the first torch call of a fresh process, written to stdout
# as a .npy: torch's CPU float32 log has been seen to go wrong by ~1e-4
# relative on that first large call in one process in 10 to 30, and nowhere
# after it (ROADMAP Queue C20).
FIRST_CALL = (
    'import sys, numpy as np; '
    'from boltzmann_machines_tpu_torch.ops.samplers import normal_sample; '
    'z = normal_sample(3, (512, 512), device="cpu").numpy(); '
    'np.save(sys.stdout.buffer, z)')


def test_box_muller_first_call_of_a_process():
    """The same draws as `test_box_muller_moments`, made as the first call
    of each of six fresh processes, one after another, are held to the same
    check."""
    import io
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    for _ in range(6):
        out = subprocess.run([sys.executable, '-c', FIRST_CALL], cwd=repo,
                             env=env, capture_output=True, timeout=240)
        assert out.returncode == 0, out.stderr[-3000:].decode()
        check_box_muller(np.load(io.BytesIO(out.stdout)))


def test_cdf_order_trap():
    """ROADMAP.md Queue C: kernel and plain counts agree only if both build
    the same float32 CDF.  Summed in float32, a sequential cumsum and the
    kernel's 32-chunk scan differ; summed in float64 and rounded per entry,
    they round to the same float32 CDF, so the counts are equal."""
    rng = np.random.RandomState(11)
    Hs, n = 1000, 1000
    means = (n * rng.dirichlet(np.ones(Hs) * 0.3, size=8)).astype(np.float32)

    def chunked_scan_cdf(m, dtype):
        """The kernel's order: 32 chunk totals, their exclusive prefix,
        then each chunk re-walked from its prefix."""
        p = m.astype(dtype) / dtype(n)
        chunk = (Hs + 31) // 32
        totals = [np.sum(p[lo:lo + chunk], dtype=dtype)
                  for lo in range(0, Hs, chunk)]
        out, base = np.empty(Hs, dtype), dtype(0)
        for c, lo in enumerate(range(0, Hs, chunk)):
            run = base
            for i in range(lo, min(lo + chunk, Hs)):
                run = dtype(run + p[i])
                out[i] = run
            base = dtype(base + totals[c])
        return out

    seq32 = np.stack([np.cumsum(m / np.float32(n), dtype=np.float32)
                      for m in means])
    scan32 = np.stack([chunked_scan_cdf(m, np.float32) for m in means])
    assert (seq32 != scan32).any()        # the trap: f32 order matters
    scan64 = np.stack([chunked_scan_cdf(m, np.float64) for m in means])
    counts = multinomial_counts(torch.as_tensor(means), n, 4, 2, 0)
    cdf = scan64.astype(np.float32)
    cdf[:, -1] = np.inf
    u = philox_uniform(4, 2, 0, (8, n)).numpy()
    idx = np.stack([np.searchsorted(cdf[r], u[r], side='right')
                    for r in range(8)])
    want = np.stack([np.bincount(idx[r], minlength=Hs) for r in range(8)])
    np.testing.assert_array_equal(counts.numpy(), want)


@pytest.mark.parametrize('visible', ['bernoulli', 'gaussian'])
def test_free_energy_probe_matches_jax(visible):
    """tests/test_pallas_ops.py:908 on the port's probe: its batch-mean free
    energy equals JAX's probe in interpret mode (rtol 1e-5), and a flipped
    vb sign moves it visibly."""
    Vp, Hp, Bp = 8, 8, 4
    rng = np.random.RandomState(3)
    W = (rng.randn(Vp, Hp) * 0.3).astype(np.float32)
    vb = (rng.randn(Vp) * 0.5).astype(np.float32)
    hb = (rng.randn(Hp) * 0.5).astype(np.float32)
    X = make_X(visible, (Bp, Vp), 1)
    sigma = 1. if visible == 'gaussian' else None
    fe_jax, _ = jax_make_free_energy_probe(Vp, Hp, Bp, visible, 'bernoulli',
                                           interpret=True)(X, W, vb, hb,
                                                           sigma, 0)
    probe = make_free_energy_probe(Vp, Hp, Bp, visible, 'bernoulli')
    t = [torch.as_tensor(a) for a in (X, W, vb, hb)]
    fe, h_hat = probe(*t, sigma, 0)
    np.testing.assert_allclose(float(fe), float(fe_jax), rtol=1e-5,
                               atol=1e-5)
    assert float(h_hat.abs().sum()) == 0.
    fe_bad, _ = probe(t[0], t[1], -t[2], t[3], sigma, 0)
    assert abs(float(fe_bad) - float(fe_jax)) > 1e-2


# the widths of the probe's edge tests on the card (tests/test_torch_cuda.py
# PROBE_EDGE_SHAPES): H not a multiple of 4, V not a multiple of the pass's
# rows of W a block, B above one tile's 128 rows
@pytest.mark.parametrize('Vp,Hp,Bp', [(70, 65, 37), (37, 130, 131)])
@pytest.mark.parametrize('visible', ['bernoulli', 'gaussian'])
def test_free_energy_probe_matches_jax_at_edge_widths(Vp, Hp, Bp, visible):
    """The port's probe against JAX's in interpret mode at the card tests'
    edge widths, Gaussian visible units with a per-unit sigma: the
    batch-mean free energy within rtol 1e-5 (a sum of B (V + H) terms in
    another order), zero count vector."""
    rng = np.random.RandomState(5)
    W = (rng.randn(Vp, Hp) * 0.1).astype(np.float32)
    vb = (rng.randn(Vp) * 0.5).astype(np.float32)
    hb = (rng.randn(Hp) * 0.5).astype(np.float32)
    X = make_X(visible, (Bp, Vp), 6)
    sigma = (0.5 + rng.rand(Vp)).astype(np.float32) \
        if visible == 'gaussian' else None
    fe_jax, hh_jax = jax_make_free_energy_probe(
        Vp, Hp, Bp, visible, 'bernoulli', interpret=True)(X, W, vb, hb,
                                                          sigma, 0)
    probe = make_free_energy_probe(Vp, Hp, Bp, visible, 'bernoulli')
    fe, h_hat = probe(*[torch.as_tensor(a) for a in (X, W, vb, hb)],
                      sigma, 0)
    np.testing.assert_allclose(float(fe), float(fe_jax), rtol=1e-5,
                               atol=1e-5)
    assert float(h_hat.abs().sum()) == 0. == float(np.abs(hh_jax).sum())


def test_free_energy_probe_multinomial_exact_given_draw():
    """tests/test_pallas_ops.py:947 on the port: given the probe's own
    count vector, fe == mean(-X vb) - mean((X W) h_hat), which JAX's
    `_free_energy_sum` reproduces on that vector; h_hat is a valid count
    vector, drawn anew for another seed."""
    Vp, Hp, Bp, M = 8, 8, 4, 24
    rng = np.random.RandomState(3)
    W = (rng.randn(Vp, Hp) * 0.3).astype(np.float32)
    vb = (rng.randn(Vp) * 0.5).astype(np.float32)
    hb = (rng.randn(Hp) * 0.5).astype(np.float32)
    X = (np.random.RandomState(4).rand(Bp, Vp) < 0.5).astype(np.float32)
    probe = make_free_energy_probe(Vp, Hp, Bp, 'bernoulli', 'multinomial',
                                   n_samples=M)
    t = [torch.as_tensor(a) for a in (X, W, vb, hb)]
    fe, h_hat = probe(*t, None, 0)
    hh = h_hat.numpy()
    assert (hh >= 0).all() and hh.sum() == M
    np.testing.assert_array_equal(hh, np.round(hh))
    expect = float(np.mean(-X @ vb) - np.mean((X @ W) @ hh))
    np.testing.assert_allclose(float(fe), expect, rtol=1e-5, atol=1e-4)
    fe_jax = _free_energy_sum(jnp.asarray(X), jnp.asarray(X @ W),
                              jnp.asarray(vb)[None], jnp.asarray(hb)[None],
                              None, 'bernoulli', 'multinomial',
                              jnp.asarray(hh)[None]) / Bp
    np.testing.assert_allclose(float(fe), float(fe_jax), rtol=1e-5)
    torch.testing.assert_close(
        h_hat, uniform_h_hat(M, Hp, 0, 0, 0xFFFE, 'cpu')[0], rtol=0, atol=0)
    draws = [probe(*t, None, s)[1] for s in range(1, 9)]
    assert any(not torch.equal(d, h_hat) for d in draws)


@pytest.mark.parametrize('flavour', ['gaussian_scalar', 'multinomial'])
def test_sampled_epoch_is_deterministic(flavour):
    """Sampling on (Box-Muller visibles, multinomial counts): the same
    (seed, iter0) gives the same epoch, another seed another one; with
    multinomial hiddens every PLL row is finite and <= 0 on logged
    iterations."""
    kw = FLAVOURS[flavour]
    X = make_X(kw.get('visible'), (NB, B, V), 12)
    epoch = make_cd_epoch_kernel(V, H, B, 1, True, True, **CONFIG, **kw)
    st = make_state(V, H, 13)
    a = epoch(torch_state(st), torch.as_tensor(X), LR, MOMENTUM, 5, 10)
    b = epoch(torch_state(st), torch.as_tensor(X), LR, MOMENTUM, 5, 10)
    c = epoch(torch_state(st), torch.as_tensor(X), LR, MOMENTUM, 6, 10)
    for key in a[0]:
        torch.testing.assert_close(a[0][key], b[0][key], rtol=0, atol=0)
    assert not torch.equal(a[0]['W'], c[0]['W'])
    logged = (np.arange(11, 11 + NB) % 2) == 0
    pll = a[2].numpy()
    assert np.isfinite(pll).all() and (pll[logged] <= 0).all() \
        and (pll[~logged] == 0).all()


def test_gaussian_states_are_means_plus_sigma_normals():
    """The sampled Gaussian visible state of the first Gibbs step is
    v_means + sigma * the Box-Muller normal of (seed, it, stream_v(0)), per
    element and with a per-unit sigma."""
    sig = FLAVOURS['gaussian_per_unit']['sigma']
    X = make_X('gaussian', (1, B, V), 14)
    st = torch_state(make_state(V, H, 15))
    # one step, no hidden sampling, v sampled: dvb = lr * (mom dvb +
    # mean(X - v_states)) reveals the mean of the sampled states
    cfg = CDEpochConfig(V, H, 1, True, False, 1., 1., 0., 0.1, 0., 0.9, 1,
                        False, 'gaussian', sig)
    s, _, _, _ = cd_epoch_reference(cfg, st, torch.as_tensor(X), 1., 0., 3,
                                    0)
    Xb = torch.as_tensor(X[0])
    h0 = torch.sigmoid(Xb @ st['W'] + st['hb'])
    v_means = (h0 @ st['W'].T) * torch.as_tensor(sig) + st['vb']
    v_states = v_means + normal(3, 1, 1, (B, V)) * torch.as_tensor(sig)
    torch.testing.assert_close(s['dvb'], torch.mean(Xb - v_states, dim=0),
                               rtol=1e-6, atol=1e-6)
