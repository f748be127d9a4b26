"""The port's CUDA kernels (boltzmann_machines_tpu_torch/csrc/cd_epoch.cu and
csrc/dbm_ops.cu, behind ops/cd_epoch.py, ops/cd_stats.py, ops/samplers.py
and ops/dbm_ops.py) against their plain PyTorch versions, on the card: at
small ragged shapes that leave partial tiles on every edge, and at the
widths of the paths (examples/rbm_mnist.py, dbm_mnist.py, dbm_cifar_naive.py
and dbm_cifar.py; marked ``path_width``).  This is the one place where a
kernel is held against its plain version; chip_smoke.py runs the
``path_width`` cases, drives the paths and times the kernels.  On the card:

    python3 -m pytest -m requires_cuda tests/

This file imports no JAX (``BMT_TEST_TPU=1`` keeps tests/conftest.py from
importing it too, for a run of this file alone).  Without a CUDA device
every test skips."""

import numpy as np
import pytest
import torch

from boltzmann_machines_tpu_torch.ops import dbm_ops
from boltzmann_machines_tpu_torch.ops.cd_epoch import (
    CDEpochConfig, bias_stats_reference, cd_epoch, cd_epoch_reference)

pytestmark = pytest.mark.requires_cuda
# a case at the widths of a path (examples/rbm_mnist.py, dbm_mnist.py,
# dbm_cifar_naive.py and dbm_cifar.py); chip_smoke.py runs these on the card
# (``-m path_width``), so its run holds every kernel of the paths against
# its plain version at the paths' own shapes
PATH = pytest.mark.path_width


def at_path(*cases):
    """`cases`, each a tuple of a test's arguments, marked `path_width`."""
    return [pytest.param(*case, marks=PATH) for case in cases]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    # the plain version in true f32, as the kernels compute
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


def make_inputs(V, H, B, NB, dev, seed=0, w_std=0.1):
    """Binary batches and a random CD state, W of std `w_std`."""
    rng = np.random.RandomState(seed)
    X = torch.as_tensor((rng.rand(NB, B, V) < 0.3).astype(np.float32),
                        device=dev)
    state = {
        'W': rng.randn(V, H) * w_std, 'vb': rng.randn(V) * 0.1,
        'hb': rng.randn(H) * 0.1, 'dW': rng.randn(V, H) * 0.01,
        'dvb': rng.randn(V) * 0.01, 'dhb': rng.randn(H) * 0.01,
        'q_means': rng.rand(H),
    }
    return X, {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
               for k, v in state.items()}


# (V, H, B): the CPU tests' shape, and ragged ones that leave partial
# 64-wide tiles on every edge, with a batch of 1 and one above a tile
SHAPES = [(24, 16, 8), (37, 70, 3), (130, 65, 1), (50, 129, 67)]
# examples/rbm_mnist.py's RBM at the batches of its two benchmark cells
PATH_SHAPES = [(784, 1024, 10), (784, 1024, 256)]


@pytest.mark.parametrize('V,H,B', SHAPES + at_path(*PATH_SHAPES))
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
    # iterations 2..7; metrics where it % 4 == 0 (it = 4), PLL off: the
    # pass over W alone
    assert diff == {'cd_gemm_act': NB * (1 + 2 * k), 'cd_softmax_sample': 0,
                    'cd_bias_stats': NB, 'cd_assoc_update': NB,
                    'cd_metrics': 1, 'cd_val_reduce': 0}


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
# Gaussian-visible and multinomial-hidden CD kernels, samplers, probe      #
# ---------------------------------------------------------------------- #
def flavour_config(V, H, k, sample, flavour, metrics_every=2):
    """The config of a flavour: Gaussian visible units with a scalar or
    per-unit sigma (dbm_first's doubling), multinomial hidden units with
    n = 12 (dbm_last's), or Bernoulli units both (rbm_mnist's, no
    multipliers)."""
    rng = np.random.RandomState(7)
    kw = {'gaussian': dict(visible='gaussian', sigma=np.float32(1.5)),
          'gaussian_per_unit': dict(visible='gaussian', sigma=(
              rng.rand(V) + 0.5).astype(np.float32)),
          'multinomial': dict(hidden='multinomial', n_samples=12),
          'bernoulli': {}}[flavour]
    up, down = (2., 1.) if 'sigma' in kw else (1., 2.) if kw else (1., 1.)
    return CDEpochConfig(V, H, k, sample, sample, up, down, 1e-4, 0.1, 1e-2,
                         0.9, metrics_every, True, **kw)


def flavour_inputs(V, H, B, NB, dev, flavour, seed=0, w_std=0.1):
    X, state = make_inputs(V, H, B, NB, dev, seed, w_std)
    if flavour not in ('multinomial', 'bernoulli'):
        X = torch.as_tensor(np.random.RandomState(seed).randn(NB, B, V),
                            dtype=torch.float32, device=dev)
    return X, state


FLAVOURS = ['gaussian', 'gaussian_per_unit', 'multinomial']


@pytest.mark.parametrize('V,H,B', SHAPES)
@pytest.mark.parametrize('k', [0, 1, 2])
@pytest.mark.parametrize('flavour', FLAVOURS)
def test_flavour_kernels_match_plain_version_sampling_off(cuda, V, H, B, k,
                                                          flavour):
    """The tolerances of the Bernoulli kernels; the PLL (with the same two
    multinomial count vectors on both sides) within 1e-3."""
    X, state = flavour_inputs(V, H, B, 5, cuda, flavour)
    cfg = flavour_config(V, H, k, False, flavour)
    got = cd_epoch(cfg, state, X, 0.01, 0.9, 3, 0)
    want = cd_epoch_reference(cfg, state, X, 0.01, 0.9, 3, 0)
    torch.cuda.synchronize()
    for key in got[0]:
        atol = 1e-5 * (B if key == 'q_means' else 1)
        torch.testing.assert_close(got[0][key], want[0][key], rtol=1e-5,
                                   atol=atol, msg=key)
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got[2], want[2], rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(got[3], want[3], rtol=1e-5, atol=0)
    assert float(got[2][1]) < 0 and float(got[2][0]) == 0


# the flavours at the ragged shapes, and the Bernoulli RBM at its paths'
# widths, where ~7e5 draws a step (B 256) meet a threshold within the
# means' rounding ~0.02 times a step
SAMPLED_CASES = [(flavour,) + shape for shape in SHAPES
                 for flavour in FLAVOURS] + at_path(*[
                     ('bernoulli',) + shape for shape in PATH_SHAPES])


@pytest.mark.parametrize('flavour,V,H,B', SAMPLED_CASES)
def test_flavour_kernels_match_plain_version_sampling_on(cuda, V, H, B,
                                                         flavour):
    """Sampled, each step from the same state: the Box-Muller normals
    differ from torch's by an ulp or two (a Gaussian state by ~1e-6) and
    the softmax means by an ulp, which can move a multinomial draw across a
    CDF boundary or a Bernoulli threshold now and then; so all but one of
    the 6 steps agree within rtol 1e-4, atol 1e-4 (x B for q_means)."""
    X, state = flavour_inputs(V, H, B, 6, cuda, flavour, seed=1)
    cfg = flavour_config(V, H, 1, True, flavour, metrics_every=1)
    bad = 0
    for i in range(6):
        got = cd_epoch(cfg, state, X[i:i + 1], 0.01, 0.9, 17, i)
        want = cd_epoch_reference(cfg, state, X[i:i + 1], 0.01, 0.9, 17, i)
        ok = all(torch.allclose(got[0][key], want[0][key], rtol=1e-4,
                                atol=1e-4 * (B if key == 'q_means' else 1))
                 for key in got[0])
        bad += not ok
        state = got[0]
    assert bad <= 1


def test_flavour_launch_counts(cuda):
    """Multinomial hidden units: every hidden GEMM is followed by one row
    kernel; PLL every 2 iterations, two cd_metrics launches each."""
    V, H, B, NB, k = 24, 16, 8, 6, 2
    X, state = flavour_inputs(V, H, B, NB, cuda, 'multinomial')
    cfg = flavour_config(V, H, k, True, 'multinomial')
    before = dict(cd_epoch.launches)
    cd_epoch(cfg, state, X, 0.01, 0.9, 3, 0)
    diff = {n: cd_epoch.launches[n] - before[n] for n in before}
    # the PLL on: the metrics draw their two count vectors, then pass over
    # W -- two launches a logged step
    assert diff == {'cd_gemm_act': NB * (1 + 2 * k),
                    'cd_softmax_sample': NB * (1 + k), 'cd_bias_stats': NB,
                    'cd_assoc_update': NB, 'cd_metrics': 2 * (NB // 2),
                    'cd_val_reduce': 0}


def python_step_loop(cfg, state, X_batches, lr, momentum, seed, iter0):
    """The epoch's launches issued step by step from Python through the
    launch helpers of ops/cd_epoch.py -- the loop that ``bm_cd_epoch_loop``
    replaced, kept as its oracle: the same kernels on the same arguments in
    the same order, so the same bits."""
    from boltzmann_machines_tpu_torch.ops.cd_epoch import (
        STATE_KEYS, _launch_h_pass, _launch_metrics, _launch_v_pass,
        check_launch, library, metrics_workspace, ptr, sigma_row)
    from boltzmann_machines_tpu_torch.ops.gemm import assoc_plan, num_sms
    from boltzmann_machines_tpu_torch.ops.philox import (
        STREAM_H0, stream_h, stream_v)
    V, H = cfg.n_visible, cfg.n_hidden
    NB, B = int(X_batches.shape[0]), int(X_batches.shape[1])
    multinomial = cfg.hidden == 'multinomial'
    lib = library()
    launches = cd_epoch.launches
    dev = X_batches.device
    # the epoch updates copies of the state in place, batch after batch
    W, vb, hb, dW, dvb, dhb, q = (state[key].clone() for key in STATE_KEYS)
    sigma = sigma_row(cfg, dev)

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    h0, v_means, h_means = empty(B, H), empty(B, V), empty(B, H)
    h_samp = empty(B, H) if cfg.sample_h_states else None
    v_samp = empty(B, V) if cfg.sample_v_states else None
    pre = empty(B, H) if multinomial else None
    pen, msre_col = empty(H), empty(V)
    met_ws = metrics_workspace(V, H, B, dev)
    msre_rows, pll_rows, l2_rows = (torch.zeros(NB, dtype=torch.float32,
                                                device=dev)
                                    for _ in range(3))
    stream = torch.cuda.current_stream(dev).cuda_stream
    lr, mom = float(lr), float(momentum)
    seed = int(seed)
    n_tile = assoc_plan(V, H, num_sms(dev)).n_tile

    for i in range(NB):
        X = X_batches[i]
        it = int(iter0) + i + 1
        _launch_h_pass(lib, stream, cfg, X, W, hb, h0, h_samp, pre, seed, it,
                       STREAM_H0)
        h_states = h_samp if cfg.sample_h_states else h0
        v_states, v_m, h_m = X, X, h0
        for s in range(cfg.k):
            _launch_v_pass(lib, stream, cfg, h_states, W, vb, sigma, v_means,
                           v_samp, seed, it, stream_v(s))
            v_m = v_means
            v_states = v_samp if cfg.sample_v_states else v_means
            _launch_h_pass(lib, stream, cfg, v_states, W, hb, h_means, h_samp,
                           pre, seed, it, stream_h(s))
            h_m = h_means
            h_states = h_samp if cfg.sample_h_states else h_means

        damp = cfg.sparsity_damping
        check_launch(lib.bm_cd_bias_stats(
            ptr(X), ptr(v_states), ptr(v_m), ptr(h0), ptr(h_m), B, V, H,
            ptr(vb), ptr(dvb), ptr(hb), ptr(dhb), ptr(q), ptr(pen),
            ptr(msre_col), lr, mom, damp, 1. - damp, cfg.sparsity_cost,
            cfg.sparsity_target, stream), 'cd_bias_stats')
        launches['cd_bias_stats'] += 1

        check_launch(lib.bm_cd_assoc_update(
            ptr(X), ptr(h0), ptr(v_states), ptr(h_m), ptr(pen), B, V, H,
            ptr(W), ptr(dW), lr, mom, cfg.l2, n_tile, stream),
            'cd_assoc_update')
        launches['cd_assoc_update'] += 1

        if it % cfg.metrics_every == 0:
            _launch_metrics(lib, stream, cfg, X, W, vb, hb, sigma, msre_col,
                            seed, it, met_ws, [ptr(msre_rows, i),
                                               ptr(pll_rows, i),
                                               ptr(l2_rows, i)])
    new_state = dict(zip(STATE_KEYS, (W, vb, hb, dW, dvb, dhb, q)))
    return new_state, msre_rows, pll_rows, l2_rows


def loop_config(flavour, V, H, k, pll, metrics_every):
    """rbm_mnist's RBM (hidden states sampled, no multipliers), the G-RBM
    of dbm_cifar_naive (Gaussian visibles, per-unit sigma, both layers
    sampled, dbm_first's doubling) or multinomial hidden units (n = 12,
    both layers sampled)."""
    if flavour == 'bernoulli':
        return CDEpochConfig(V, H, k, False, True, 1., 1., 1e-4, 0.1, 1e-2,
                             0.9, metrics_every, pll)
    cfg = flavour_config(V, H, k, True, flavour, metrics_every)
    return cfg._replace(compute_pll=pll)


# (flavour, V, H, B, NB, k, PLL, metrics_every, iter0): rbm_mnist's RBM at
# both cells' batches, logging inside the call with the PLL on and off; the
# G-RBM at its cell's shape for a few steps; multinomial hidden units and
# k = 2 at ragged shapes; a one-row remainder call that logs
LOOP_CASES = at_path(
    ('bernoulli', 784, 1024, 10, 12, 1, True, 5, 3),
    ('bernoulli', 784, 1024, 256, 6, 1, False, 4, 0),
    ('gaussian_per_unit', 3072, 5000, 100, 3, 1, True, 2, 0),
    ('bernoulli', 784, 1024, 1, 1, 1, True, 1, 214)) + [
    ('multinomial', 50, 129, 67, 5, 1, True, 2, 0),
    ('multinomial', 37, 70, 3, 4, 2, False, 3, 1),
    ('bernoulli', 130, 65, 8, 5, 2, True, 2, 0),
    ('gaussian', 24, 16, 8, 6, 2, False, 1, 7)]


@pytest.mark.parametrize('flavour,V,H,B,NB,k,pll,every,iter0', LOOP_CASES)
def test_epoch_loop_matches_python_step_loop(cuda, flavour, V, H, B, NB, k,
                                             pll, every, iter0):
    """``cd_epoch``'s C step loop against the Python step loop it replaced
    (``python_step_loop``) bit for bit: the new state and the three metric
    rows.  Its launches as it reports them equal ``epoch_launches``'s
    schedule and the Python loop's; one loop call of NB steps."""
    from boltzmann_machines_tpu_torch.ops.cd_epoch import epoch_launches
    cfg = loop_config(flavour, V, H, k, pll, every)
    X, state = flavour_inputs(V, H, B, NB, cuda, flavour,
                              w_std=8e-4 if V == 3072 else 0.01)
    before, loop = dict(cd_epoch.launches), dict(cd_epoch.loop)
    got = cd_epoch(cfg, state, X, 0.01, 0.9, 3000000019, iter0)
    diff = {n: cd_epoch.launches[n] - before[n] for n in before}
    assert diff == epoch_launches(cfg, NB, iter0)
    assert {n: cd_epoch.loop[n] - loop[n] for n in loop} == {
        'calls': 1, 'steps': NB}
    before = dict(cd_epoch.launches)
    want = python_step_loop(cfg, state, X, 0.01, 0.9, 3000000019, iter0)
    torch.cuda.synchronize()
    assert {n: cd_epoch.launches[n] - before[n] for n in before} == diff
    for key in got[0]:
        assert torch.equal(got[0][key], want[0][key]), key
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a, b)
    logged = [i for i in range(NB) if (iter0 + i + 1) % every == 0]
    assert logged and all(float(got[3][i]) > 0 for i in logged)
    assert all((float(got[2][i]) != 0) == pll for i in logged)


# (flavour, layer, V, H, B, std of W): one pass of each sampled layer at
# 300 x 1000; the dbm_cifar_naive M-RBM's hidden pass (5000 x 1000, n 1000,
# B 100) at its W_init; and both passes of a rank of the data-parallel
# 3072 x 7800 G-RBM (50 rows of 100 on two ranks), the hidden one at its
# W_init and the visible one at ten times it
GIBBS_CASES = [(flavour, layer, 300, 1000, 64, 0.1)
               for flavour, layer in (('gaussian', 'v'), ('gaussian', 'h'),
                                      ('multinomial', 'h'))] + at_path(
    ('multinomial', 'h', 5000, 1000, 100, 0.01),
    ('gaussian', 'h', 3072, 7800, 50, 8e-4),
    ('gaussian', 'v', 3072, 7800, 50, 8e-3))


@pytest.mark.parametrize('flavour,layer,V,H,B,w_std', GIBBS_CASES)
@pytest.mark.parametrize('shard', [0, 1])
def test_gibbs_pass_states_match_plain_version(cuda, flavour, layer, V, H, B,
                                               w_std, shard):
    """The sampled states of one pass of the epoch's kernels on the same
    inputs as the plain version, under the data-parallel counter word
    `shard` (the stats kernels' rank 1 draws under 1): Gaussian states
    within 1e-5 (1 + |v|) (Box-Muller ulps), Bernoulli states in <= 1e-5 of
    draws and multinomial counts in <= 1e-3 of draws (a draw moves where
    its uniform lies between the two versions' CDF entries, which differ by
    the means' rounding), every count row summing to n."""
    from boltzmann_machines_tpu_torch.ops.cd_epoch import (
        _gibbs_pass, _gibbs_pass_reference)
    cfg = flavour_config(V, H, 1, True, flavour)
    if flavour == 'multinomial':
        cfg = cfg._replace(n_samples=1000)
    X, state = flavour_inputs(V, H, B, 1, cuda, flavour, w_std=w_std)
    A = X[0] if layer == 'h' else \
        (torch.rand((B, H), device=cuda) < 0.5).float()
    bias = state['hb'] if layer == 'h' else state['vb']
    mk, sk = _gibbs_pass(cfg, layer, A, state['W'], bias, 5, 2, 3,
                         shard=shard)
    mp, sp = _gibbs_pass_reference(cfg, layer, A, state['W'], bias, 5, 2, 3,
                                   shard=shard)
    torch.cuda.synchronize()
    torch.testing.assert_close(mk, mp, rtol=1e-5, atol=1e-5)
    if layer == 'v':
        assert float(((sk - sp).abs() / (1. + sp.abs())).max()) <= 1e-5
    elif flavour == 'multinomial':
        assert bool((sk.sum(1) == 1000).all())
        assert float((sk - sp).abs().sum()) / 2 <= 1e-3 * B * 1000
    else:
        assert int((sk != sp).sum()) <= 1e-5 * sk.numel() + 1


@pytest.mark.parametrize('H,n', [(16, 12), *at_path((1000, 1000)),
                                 (7800, 513)])
def test_multinomial_sample_kernel_matches_plain_version(cuda, H, n):
    """Given the same means both build the CDF in float64 (in another
    order) and round it to float32, so the counts are equal; every row
    sums to n.  H = 7800 takes 62 KB of dynamic shared memory."""
    from boltzmann_machines_tpu_torch.ops.samplers import (
        multinomial_sample, multinomial_sample_reference)
    rng = np.random.RandomState(H)
    means = torch.as_tensor(n * rng.dirichlet(np.ones(H), size=50),
                            dtype=torch.float32, device=cuda)
    before = multinomial_sample.launches['multinomial_sample']
    got = multinomial_sample(5, means, n)
    want = multinomial_sample_reference(5, means, n)
    torch.cuda.synchronize()
    assert multinomial_sample.launches['multinomial_sample'] == before + 1
    assert torch.equal(got, want)
    assert bool((got.sum(1) == n).all())


@pytest.mark.parametrize('H,n', [(5, 3), (1500, 1000), (7800, 513),
                                 *at_path((1000, 1000), (512, 512))])
def test_cd_softmax_sample_matches_plain_version(cuda, H, n):
    """K1b from pre-activations, as the epoch's multinomial hidden pass
    launches it: the means within 1e-5 of n softmax(pre) (the row's sums in
    another order), the counts equal to ``multinomial_counts`` on the
    kernel's own means (both build the CDF in float64, so they differ only
    at float64 ties), every row summing to n, a rerun bit for bit.  H = 5
    is below a warp, 1500 not a multiple of the block's 1024 threads
    (chunks of 2, the last ones short or empty), 7800 the widest path's
    (62 KB of dynamic shared memory); 1000 and 512 the M-RBMs' of
    dbm_cifar_naive.py and dbm_cifar.py at their n."""
    from boltzmann_machines_tpu_torch.ops.cd_epoch import (
        check_launch, library, ptr)
    from boltzmann_machines_tpu_torch.ops.philox import multinomial_counts
    rows = 37
    rng = np.random.RandomState(H)
    pre = torch.as_tensor(2. * rng.randn(rows, H), dtype=torch.float32,
                          device=cuda)
    lib, stream = library(), torch.cuda.current_stream().cuda_stream

    def run():
        means = torch.full((rows, H), float('nan'), device=cuda)
        states = torch.full((rows, H), float('nan'), device=cuda)
        check_launch(lib.bm_cd_softmax_sample(
            ptr(pre), 1, rows, H, n, ptr(means), ptr(states), 9, 3, 2,
            stream), 'cd_softmax_sample')
        return means, states
    (means, states), (m2, s2) = run(), run()
    want = float(n) * torch.softmax(pre, dim=1)
    counts = multinomial_counts(means, n, 9, 3, 2)
    torch.cuda.synchronize()
    torch.testing.assert_close(means, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(states, counts)
    assert bool((states.sum(1) == n).all())
    assert torch.equal(means, m2) and torch.equal(states, s2)


# (V, H, B): a batch of 1, one above a batch tile (two tiles of 128 rows),
# V and H not multiples of 4, and a split-K plan (K = 1000 in 32 k-tiles,
# three model tiles) at widths that take the 16-byte loads of W; and the
# logged steps of the paths: rbm_mnist's, the G-RBM's and the M-RBM's
METRICS_SHAPES = [(37, 70, 1), (130, 65, 131), (50, 129, 67),
                  (1000, 300, 10), *at_path(
                      (784, 1024, 10), (3072, 5000, 100), (5000, 1000, 100))]
METRICS_FLAVOURS = [('bernoulli', 'bernoulli'), ('gaussian', 'bernoulli'),
                    ('bernoulli', 'multinomial'),
                    ('gaussian', 'multinomial')]


@pytest.mark.parametrize('V,H,B', METRICS_SHAPES)
@pytest.mark.parametrize('visible,hidden', METRICS_FLAVOURS)
def test_cd_metrics_matches_plain_version(cuda, V, H, B, visible, hidden):
    """K4 (the product's free-energy epilogue or the two count vectors,
    then the pass over W) against ``metrics_reference`` -- ``pll_from_flip``
    on the same flips and count vectors, the plain L2 and msre -- on the
    same inputs, with the tolerances of the epoch tests: pll rtol 1e-3,
    atol 1e-3; msre atol 1e-6 (and rtol 1e-5 for Gaussian rows, ~1); l2
    rtol 1e-5.  Two launches a logged step; a rerun bit for bit."""
    from boltzmann_machines_tpu_torch.ops.cd_epoch import (
        _metrics, metrics_reference)
    from boltzmann_machines_tpu_torch.ops.gemm import gemm_plan, num_sms
    rng = np.random.RandomState(V + H + B)
    gaussian = visible == 'gaussian'
    sigma = (rng.rand(V) + 0.5).astype(np.float32) if gaussian else None
    cfg = CDEpochConfig(V, H, 1, False, False, 1., 1., 1e-4, 0.1, 0., 0.9, 1,
                        True, visible, sigma, hidden,
                        40 if hidden == 'multinomial' else None)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=cuda)
    X = t(rng.randn(B, V) if gaussian else rng.rand(B, V) < 0.3)
    W, vb, hb = t(0.1 * rng.randn(V, H)), t(0.1 * rng.randn(V)), \
        t(0.1 * rng.randn(H))
    msre_col = torch.sum(torch.square(X - t(rng.rand(B, V))), 0)
    before = cd_epoch.launches['cd_metrics']
    got = _metrics(cfg, X, W, vb, hb, msre_col, 7, 1000)
    again = _metrics(cfg, X, W, vb, hb, msre_col, 7, 1000)
    want = metrics_reference(cfg, X, W, vb, hb, msre_col, 7, 1000)
    torch.cuda.synchronize()
    assert cd_epoch.launches['cd_metrics'] == before + 4
    torch.testing.assert_close(got[0], want[0], rtol=1e-5 if gaussian else 0,
                               atol=1e-6)
    torch.testing.assert_close(got[1], want[1], rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=0)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert float(got[1]) < 0
    if V == 1000:
        assert gemm_plan(B, H, V, num_sms(cuda)).splits > 1


def test_cd_metrics_without_pll(cuda):
    """PLL off: the pass over W alone (one launch), msre and l2 as above,
    the pll row untouched (0)."""
    from boltzmann_machines_tpu_torch.ops.cd_epoch import (
        _metrics, metrics_reference)
    V, H, B = 50, 129, 67
    rng = np.random.RandomState(2)
    cfg = CDEpochConfig(V, H, 1, False, False, 1., 1., 1e-4, 0.1, 0., 0.9, 1,
                        False)
    X, W, vb, hb, vm = (torch.as_tensor(a, dtype=torch.float32, device=cuda)
                        for a in (rng.rand(B, V) < 0.3, rng.randn(V, H),
                                  rng.randn(V), rng.randn(H), rng.rand(B, V)))
    msre_col = torch.sum(torch.square(X - vm), 0)
    before = cd_epoch.launches['cd_metrics']
    got = _metrics(cfg, X, W, vb, hb, msre_col, 7, 1000)
    want = metrics_reference(cfg, X, W, vb, hb, msre_col, 7, 1000)
    torch.cuda.synchronize()
    assert cd_epoch.launches['cd_metrics'] == before + 1
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-6)
    torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=0)
    assert float(got[1]) == 0.


# ---------------------------------------------------------------------- #
# the fit loop's whole-set passes (ops/cd_val.py)                          #
# ---------------------------------------------------------------------- #
# (visible, hidden, B) at 5000 x 784 x 1024: the RBM cells' two batches,
# and a Gaussian and a multinomial flavour
VAL_CASES = at_path(('bernoulli', 'bernoulli', 10),
                    ('bernoulli', 'bernoulli', 256)) + [
    ('gaussian', 'bernoulli', 100), ('bernoulli', 'multinomial', 100)]
VAL_SEED = 3000000019


def val_inputs(visible, hidden, k, sample, N=5000, V=784, H=1024, seed=0):
    """(config, X, state on the card, state on the CPU) of a pass: Gaussian
    units with a per-unit sigma and dbm_first's doubling, multinomial ones
    with n = 40 and dbm_last's."""
    from boltzmann_machines_tpu_torch.ops.cd_epoch import cd_epoch_config
    rng = np.random.RandomState(seed + N + V)
    gaussian = visible == 'gaussian'
    sigma = (rng.rand(V) + 0.5).astype(np.float32) if gaussian else None
    cfg = cd_epoch_config(
        V, H, k, sample, sample, 2. if gaussian else 1.,
        2. if hidden == 'multinomial' else 1., 1e-4, 0.1, 0., 0.9, 1, True,
        visible, sigma, hidden, 40 if hidden == 'multinomial' else None)
    X = rng.randn(N, V) / sigma if gaussian else rng.rand(N, V) < 0.3
    state = {'W': 0.05 * rng.randn(V, H), 'vb': 0.1 * rng.randn(V),
             'hb': 0.1 * rng.randn(H)}
    cpu = {key: torch.as_tensor(v, dtype=torch.float32)
           for key, v in state.items()}
    X = torch.as_tensor(X, dtype=torch.float32)
    return cfg, X, cpu


def val_launches(cfg, chunks=1, feg=False):
    """The launches of a validation pass (msre and PLL), or of the FEG's
    two sides, over `chunks` chunks."""
    multi = cfg.hidden == 'multinomial'
    if feg:
        one = {'cd_gemm_act': int(multi), 'cd_metrics': 1,
               'cd_val_reduce': 1}
        chunks *= 2
    else:
        one = {'cd_gemm_act': 2 * cfg.k + multi,
               'cd_softmax_sample': cfg.k * multi, 'cd_metrics': 1,
               'cd_val_reduce': 1}
    return {name: chunks * one.get(name, 0) for name in cd_epoch.launches}


@pytest.mark.parametrize('visible,hidden,B', VAL_CASES)
@pytest.mark.parametrize('sample', [False, True])
def test_whole_set_passes_match_plain_version(cuda, visible, hidden, B,
                                              sample):
    """The validation pass (msre, PLL) and the FEG's free energies of 5000
    x 784 x 1024 on the card against the plain version on the CPU, draw by
    draw (sampled: k = 2, so the chain draws both layers): msre rtol 1e-5,
    atol 1e-6; pll rtol 1e-3, atol 1e-3 (the training metrics'); free
    energies rtol 1e-5.  The launches as ``val_launches`` counts them, one
    chunk; a rerun bit for bit."""
    from boltzmann_machines_tpu_torch.ops.cd_val import cd_feg, cd_val
    cfg, X, cpu = val_inputs(visible, hidden, 2 if sample else 1, sample)
    state = {key: v.to(cuda) for key, v in cpu.items()}
    Xd = X.to(cuda)
    before = dict(cd_epoch.launches)
    got = cd_val(cfg, state, Xd, B, VAL_SEED)
    torch.cuda.synchronize()
    diff = {n: cd_epoch.launches[n] - before[n] for n in before}
    assert diff == val_launches(cfg)
    before = dict(cd_epoch.launches)
    fe = cd_feg(cfg, state, Xd[:1234], Xd[1234:], B, VAL_SEED)
    torch.cuda.synchronize()
    diff = {n: cd_epoch.launches[n] - before[n] for n in before}
    assert diff == val_launches(cfg, feg=True)
    again = cd_val(cfg, state, Xd, B, VAL_SEED)
    want = cd_val(cfg, cpu, X, B, VAL_SEED)
    want_fe = cd_feg(cfg, cpu, X[:1234], X[1234:], B, VAL_SEED)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got[1].cpu(), want[1], rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(fe.cpu(), want_fe, rtol=1e-5, atol=0)
    assert 0 < float(got[0]) and float(got[1]) < 0


# Sampled multinomial chains part between the card and the plain version
# where a draw falls within float32 rounding of a bucket edge of the CDF,
# whose sums the two take in another order: on an H100, 2-4 of 1000 rows
# at n = 40, k = 2, in one chunk as in chunks (12 seeds), none with
# Bernoulli hidden units.  A parting row moves the msre by at most ~1.5%
# of the mean / N (4.3e-5 relative from 3 rows of 1000, the most read), so
# with at most 1% of the rows parting the msre stays within 1.5e-4; a draw
# keyed to the wrong chunk parts nearly every row.
MAX_PARTING_SHARE = 0.01
PARTED_MSRE_RTOL = 1.5e-4


@pytest.mark.parametrize('visible,hidden', [('bernoulli', 'bernoulli'),
                                            ('bernoulli', 'multinomial')])
def test_whole_set_passes_in_chunks(cuda, visible, hidden, monkeypatch):
    """CHUNK_BYTES cut so that 1000 rows at batch 64 run as chunks of a
    few batches, the last one short, k = 2, both layers sampled: each
    chunk's chain on the card against the plain version's under the
    chunk's key, row by row (at most MAX_PARTING_SHARE of the rows part by
    more than 1e-4, none with Bernoulli hidden units); the pass's msre and
    PLL against the plain version under the same cut (msre rtol 1e-5, or
    PARTED_MSRE_RTOL where rows part; PLL as above); the launches a
    chunk."""
    from boltzmann_machines_tpu_torch.ops import cd_val as cd_val_mod
    from boltzmann_machines_tpu_torch.ops.cd_epoch import library, sigma_row
    cfg, X, cpu = val_inputs(visible, hidden, 2, True, N=1000)
    monkeypatch.setattr(cd_val_mod, 'CHUNK_BYTES', 3 << 20)
    rows = cd_val_mod.chunk_rows(cfg, 1000, 64, True, True, True)
    chunks = -(-1000 // rows)
    assert 64 <= rows < 1000 and chunks >= 3
    state = {key: v.to(cuda) for key, v in cpu.items()}
    parted = 0
    for c, c0 in enumerate(range(0, 1000, rows)):
        Xc = X[c0:c0 + rows]
        card = cd_val_mod._chain_cuda(
            library(), torch.cuda.current_stream().cuda_stream, cfg,
            Xc.to(cuda), state['W'], state['vb'], state['hb'],
            sigma_row(cfg, cuda), VAL_SEED, c,
            lambda *shape: torch.empty(shape, device=cuda))
        plain = cd_val_mod._chain_reference(
            cfg, Xc, cpu['W'], cpu['vb'], cpu['hb'], sigma_row(cfg, 'cpu'),
            VAL_SEED, c)
        parted += int(((card.cpu() - plain).abs().amax(1) > 1e-4).sum())
    assert parted <= MAX_PARTING_SHARE * 1000
    if hidden == 'bernoulli':
        assert parted == 0
    before = dict(cd_epoch.launches)
    got = cd_val_mod.cd_val(cfg, state, X.to(cuda), 64, VAL_SEED)
    torch.cuda.synchronize()
    diff = {n: cd_epoch.launches[n] - before[n] for n in before}
    assert diff == val_launches(cfg, chunks)
    want = cd_val_mod.cd_val(cfg, cpu, X, 64, VAL_SEED)
    torch.testing.assert_close(got[0].cpu(), want[0], atol=1e-6,
                               rtol=PARTED_MSRE_RTOL if parted else 1e-5)
    torch.testing.assert_close(got[1].cpu(), want[1], rtol=1e-3, atol=1e-3)


# the standalone samplers' shapes: the path's, one element (the scalar
# path alone), and tails of 3 after the 16-byte path
SAMPLER_SHAPES = [(1, 1), (3, 5), (7, 1001)]


@pytest.mark.parametrize('shape', [pytest.param((100, 3072), marks=PATH)]
                         + SAMPLER_SHAPES)
def test_normal_sample_kernel_matches_plain_version(cuda, shape):
    """Box-Muller in the kernel (logf, cosf, sqrtf without fast math) and
    in torch agree within a few ulps: 4e-6; one launch a call."""
    from boltzmann_machines_tpu_torch.ops.samplers import (
        normal_sample, normal_sample_reference)
    before = normal_sample.launches['normal_sample']
    got = normal_sample(9, shape)
    assert normal_sample.launches['normal_sample'] == before + 1
    want = normal_sample_reference(9, shape, cuda)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=4e-6, atol=4e-6)
    assert abs(float(got.mean())) < 6 / np.sqrt(got.numel())


# (V, H, B): a small shape, and the probe at the M-RBM's and the G-RBM's
@pytest.mark.parametrize('V,H,B', [(70, 65, 37), *at_path(
    (5000, 1000, 100), (3072, 5000, 100))])
@pytest.mark.parametrize('visible,hidden', [
    ('bernoulli', 'bernoulli'), ('gaussian', 'bernoulli'),
    ('bernoulli', 'multinomial')])
def test_free_energy_probe_kernel_matches_plain_version(cuda, V, H, B,
                                                        visible, hidden):
    from boltzmann_machines_tpu_torch.ops.samplers import (
        make_free_energy_probe)
    X, state = flavour_inputs(V, H, B, 1, cuda,
                              'gaussian' if visible == 'gaussian'
                              else 'multinomial')
    probe = make_free_energy_probe(V, H, B, visible, hidden, n_samples=40)
    args = (X[0], state['W'], state['vb'], state['hb'],
            1.5 if visible == 'gaussian' else None, 4)
    fe, h_hat = probe(*args)
    fe_p, h_hat_p = probe.reference(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(fe, fe_p, rtol=1e-5, atol=1e-5)
    assert torch.equal(h_hat, h_hat_p.reshape(-1))


# (V, H, B) at the probe's edges: H not a multiple of 4 (scalar loads of W
# and the counts), V not a multiple of the pass's rows of W a block (8 at
# these widths: ops/cd_epoch.metrics_plan), B above one tile's 128 rows
PROBE_EDGE_SHAPES = [(70, 65, 37), (37, 130, 131), (300, 66, 200)]


@pytest.mark.parametrize('V,H,B', PROBE_EDGE_SHAPES)
@pytest.mark.parametrize('visible,hidden', [
    ('bernoulli', 'bernoulli'), ('gaussian', 'bernoulli'),
    ('bernoulli', 'multinomial')])
def test_free_energy_probe_edge_shapes(cuda, V, H, B, visible, hidden):
    """The probe's two launches at ragged shapes: fe within rtol / atol
    1e-5 of plain, the count vector equal (zeros for Bernoulli hidden
    units), two launches a call, and a second call the same bits."""
    from boltzmann_machines_tpu_torch.ops.cd_epoch import metrics_plan
    from boltzmann_machines_tpu_torch.ops.gemm import num_sms
    from boltzmann_machines_tpu_torch.ops.samplers import (
        make_free_energy_probe)
    rows, _ = metrics_plan(V, num_sms(cuda))
    assert H % 4 or V % rows or B > 128
    X, state = flavour_inputs(V, H, B, 1, cuda,
                              'gaussian' if visible == 'gaussian'
                              else 'multinomial')
    probe = make_free_energy_probe(V, H, B, visible, hidden, n_samples=90)
    args = (X[0], state['W'], state['vb'], state['hb'],
            0.7 if visible == 'gaussian' else None, 11)
    before = make_free_energy_probe.launches['fe_probe']
    fe, h_hat = probe(*args)
    fe2, h_hat2 = probe(*args)
    fe_p, h_hat_p = probe.reference(*args)
    torch.cuda.synchronize()
    assert make_free_energy_probe.launches['fe_probe'] == before + 4
    torch.testing.assert_close(fe, fe_p, rtol=1e-5, atol=1e-5)
    assert torch.equal(h_hat, h_hat_p.reshape(-1))
    assert torch.equal(fe, fe2) and torch.equal(h_hat, h_hat2)
    if hidden == 'multinomial':
        assert float(h_hat.sum()) == 90.
    else:
        assert float(h_hat.abs().sum()) == 0.


def test_free_energy_probe_multinomial_seeded_mean(cuda):
    """tests/test_pallas_ops.py:979-997 on the card: seeded probe
    estimates vary and their mean is within 6 standard errors of the closed
    form E[fe] = mean(-X vb) - (M / K) mean(sum(X W))."""
    from boltzmann_machines_tpu_torch.ops.samplers import (
        make_free_energy_probe)
    V, H, B, M = 8, 8, 4, 24
    rng = np.random.RandomState(3)
    W = (rng.randn(V, H) * 0.3).astype(np.float32)
    vb = (rng.randn(V) * 0.5).astype(np.float32)
    hb = (rng.randn(H) * 0.5).astype(np.float32)
    X = (np.random.RandomState(4).rand(B, V) < 0.5).astype(np.float32)
    t = [torch.as_tensor(a, device=cuda) for a in (X, W, vb, hb)]
    probe = make_free_energy_probe(V, H, B, 'bernoulli', 'multinomial',
                                   n_samples=M)
    fes = np.array([float(probe(*t, None, s)[0]) for s in range(64)])
    closed = float(np.mean(-X @ vb) - (M / float(H)) *
                   np.mean(np.sum(X @ W, axis=1)))
    sem = fes.std(ddof=1) / np.sqrt(len(fes))
    assert fes.std() > 0
    assert abs(fes.mean() - closed) < 6 * sem + 1e-4


def test_sampler_wrappers_reject_bad_inputs(cuda):
    from boltzmann_machines_tpu_torch.ops.samplers import (
        make_free_energy_probe, multinomial_sample)
    means = torch.full((4, 8), 1.5, device=cuda)
    with pytest.raises(ValueError, match='float32'):
        multinomial_sample(1, means.double(), 12)
    with pytest.raises(ValueError, match='rows'):
        multinomial_sample(1, means[0], 12)
    probe = make_free_energy_probe(8, 8, 4, 'bernoulli', 'bernoulli')
    with pytest.raises(ValueError, match='shape'):
        probe(means, torch.zeros((8, 8), device=cuda),
              torch.zeros(8, device=cuda), torch.zeros(7, device=cuda),
              None, 0)


# ---------------------------------------------------------------------- #
# data-parallel stats kernels and bernoulli_sample (csrc/cd_epoch.cu)     #
# ---------------------------------------------------------------------- #
def stats_fn(V, H, k, sample, visible='bernoulli', sigma=None, up=1.,
             down=1.):
    from boltzmann_machines_tpu_torch.ops.cd_stats import make_cd_stats_kernel
    return make_cd_stats_kernel(V, H, 0, k, sample, sample, up, down,
                                visible=visible, sigma=sigma)


# (V, H, B, atol of the sums, std of W): the ragged shapes, and the local
# batches of the two data-parallel paths' ranks -- rbm_mnist's 256 rows and
# the 3072 x 7800 G-RBM's 100 over two -- at their paths' W_init, whose
# sums run over more rows, each term within a few ulps: atol 1e-5 a row
STATS_CASES = [shape + (1e-5, 0.1) for shape in SHAPES] + at_path(
    (784, 1024, 128, 1e-5 * 128, 0.01), (3072, 7800, 50, 1e-5 * 50, 8e-4))


@pytest.mark.parametrize('V,H,B,atol,w_std', STATS_CASES)
@pytest.mark.parametrize('k', [0, 1, 2])
@pytest.mark.parametrize('visible', ['bernoulli', 'gaussian'])
def test_cd_stats_kernels_match_plain_version(cuda, V, H, B, atol, w_std, k,
                                              visible):
    """Sampling off: the stats kernels (3 + 2k launches) against the plain
    version on the same inputs, rtol 1e-5 and the case's atol on the sums,
    rtol / atol 1e-5 on v_means (true f32, sums in another order); at k = 0
    the association and the two bias sums are exactly zero."""
    from boltzmann_machines_tpu_torch.ops.cd_stats import (
        cd_stats, cd_stats_reference)
    X, state = make_inputs(V, H, B, 1, cuda, w_std=w_std)
    sigma = np.linspace(0.5, 2., V) if visible == 'gaussian' else None
    fn = stats_fn(V, H, k, False, visible, sigma, up=2.)
    before = dict(cd_stats.launches)
    got, aux = fn(state, X[0], 7, 3, 1)
    torch.cuda.synchronize()
    assert {n: cd_stats.launches[n] - before[n] for n in before} == {
        'cd_gemm_act': 1 + 2 * k, 'cd_stats_sums': 1, 'cd_assoc_stats': 1}
    want, aux_p = cd_stats_reference(fn.config, state, X[0], 7, 3, 1)
    for key in want:
        torch.testing.assert_close(got[key], want[key], rtol=1e-5, atol=atol)
    torch.testing.assert_close(aux['v_means'], aux_p['v_means'], rtol=1e-5,
                               atol=1e-5)
    if k == 0:
        for key in ('assoc', 'dvb_sum', 'dhb_sum'):
            assert not bool(got[key].any())


@pytest.mark.parametrize('V,H,B,w_std', [(130, 129, 64, 0.1)] + at_path(
    (3072, 7800, 50, 8e-4)))
@pytest.mark.parametrize('visible', ['bernoulli', 'gaussian'])
def test_cd_stats_shard0_draws_equal_the_epoch_kernels(cuda, V, H, B, w_std,
                                                       visible):
    """Sampling on: at shard 0 one step's draws are the CD epoch kernels'
    at the same (seed, it), at a ragged shape and at a rank's share of the
    data-parallel 3072 x 7800 G-RBM (W at its W_init).  The epoch at lr 1,
    momentum 0, no L2 or sparsity leaves dW = assoc / B, dvb = dvb_sum / B,
    q = h_sum, bit for bit; shard 1 draws other states, the same in kernel
    and plain version (a hidden state that flips, odds ~1e-7 a draw, moves
    one row's visible means by a column of W, and h_sum by far less than
    the tolerance)."""
    from boltzmann_machines_tpu_torch.ops.cd_stats import cd_stats_reference
    X, state = make_inputs(V, H, B, 1, cuda, w_std=w_std)
    sigma = 1. if visible == 'gaussian' else None
    fn = stats_fn(V, H, 1, True, visible, sigma)
    s0, _ = fn(state, X[0], 11, 5, 0)
    s0 = {key: v.clone() for key, v in s0.items()}
    cfg = CDEpochConfig(V, H, 1, True, True, 1., 1., 0., 0.1, 0., 0., 10 ** 6,
                        False, visible, sigma)
    zero = {key: torch.zeros_like(v) for key, v in state.items()}
    ep = cd_epoch(cfg, dict(zero, W=state['W'], vb=state['vb'],
                            hb=state['hb']), X, 1., 0., 11, 4)[0]
    # the quotient by B, held on the card (torch divides a CUDA tensor by a
    # Python number as a product with its reciprocal, which can round
    # otherwise)
    n = torch.tensor(float(B), device=cuda)
    assert torch.equal(ep['dW'], s0['assoc'] / n)
    assert torch.equal(ep['dvb'], s0['dvb_sum'] / n)
    assert torch.equal(ep['q_means'], s0['h_sum'])
    s1, _ = fn(state, X[0], 11, 5, 1)
    assert not torch.equal(s1['h_sum'], s0['h_sum'])
    p1, _ = cd_stats_reference(fn.config, state, X[0], 11, 5, 1)
    torch.testing.assert_close(s1['h_sum'], p1['h_sum'], rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize('shape', [pytest.param(s, marks=PATH) for s in (
    (10, 1024), (100, 7800))] + SAMPLER_SHAPES)
@pytest.mark.parametrize('offset', [0, 1])
def test_bernoulli_sample_kernel_matches_plain_version(cuda, shape, offset):
    """Bit for bit, under an int seed and a two-word key, on probabilities at
    a 16-byte boundary and on a contiguous view `offset` floats past it
    (the scalar path); one launch a call."""
    from boltzmann_machines_tpu_torch.ops.samplers import (
        bernoulli_sample, bernoulli_sample_reference)
    n = shape[0] * shape[1]
    probs = torch.rand(n + offset, device=cuda)[offset:].view(shape)
    assert probs.is_contiguous() and probs.storage_offset() == offset
    for seed in (12345, (7, 99)):
        before = bernoulli_sample.launches['bernoulli_sample']
        got = bernoulli_sample(seed, probs)
        assert bernoulli_sample.launches['bernoulli_sample'] == before + 1
        want = bernoulli_sample_reference(seed, probs)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    if n >= 10000:  # the path's shapes: the draws' mean
        assert abs(float(got.mean()) - float(probs.mean())) < 0.02


def test_cd_stats_wrapper_rejects_bad_inputs(cuda):
    X, state = make_inputs(24, 16, 8, 1, cuda)
    fn = stats_fn(24, 16, 1, False)
    with pytest.raises(ValueError, match='X_local'):
        fn(state, X[0][:, :10], 1, 1, 0)
    with pytest.raises(ValueError, match='float32'):
        fn(dict(state, W=state['W'].double()), X[0], 1, 1, 0)
    with pytest.raises(ValueError, match='out'):
        fn(state, X[0], 1, 1, 0, out=torch.empty(7, device=cuda))


# ---------------------------------------------------------------------- #
# DBM kernels (csrc/dbm_ops.cu)                                           #
# ---------------------------------------------------------------------- #
def make_dbm_inputs(sizes, B, M, NB, dev, seed=0, w_std=0.3):
    """A random DBM state, minibatches and particles of `sizes`: W of std
    `w_std`, or, given a pair (lo, hi), each W's columns scaled to norms
    spaced evenly from lo to hi."""
    rng = np.random.RandomState(seed)
    L = len(sizes) - 1

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=dev)

    def weights(n_in, n_out):
        W = rng.randn(n_in, n_out)
        if isinstance(w_std, tuple):
            return W * np.linspace(*w_std, n_out) / np.linalg.norm(W, axis=0)
        return W * w_std

    hs = sizes[1:]
    state = {
        'vb': t(rng.randn(sizes[0]) * 0.1),
        'hb': tuple(t(rng.randn(h) * 0.1) for h in hs),
        'W': tuple(t(weights(sizes[l], hs[l])) for l in range(L)),
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
# (layer sizes, B, M, sample, std of W or its column norms' range): those
# sampled and not; examples/dbm_mnist.py's DBM at B = M = 100, sampling off
# (its 2.3e5 draws a sweep would part the chains: the *_sampled_* tests
# below), with small weights and with column norms around the epoch test's
# max_norm of 2, which then caps 356 of 512 and 488 of 1024 columns in the
# first step (173 and 45 from the small weights; the plain version, CPU)
DBM_CASES = [shape + (sample, 0.3) for shape in DBM_SHAPES
             for sample in (False, True)] + at_path(
                 ((784, 512, 1024), 100, 100, False, 0.03),
                 ((784, 512, 1024), 100, 100, False, (0.5, 2.5)))


@pytest.mark.parametrize('sizes,B,M,sample,w_std', DBM_CASES)
@pytest.mark.parametrize('max_mf,tol', [(50, 1e-4), (3, 0.)])
def test_dbm_epoch_kernels_match_plain_version(cuda, sizes, B, M, sample,
                                               w_std, max_mf, tol):
    """Mean-field that converges before its budget (tol 1e-4) and one that
    never does (tol 0, 3 sweeps): same n_mf rows; msre atol 1e-6.  With
    sampling on (~1e3 draws per step) a threshold flip is unlikely, so the
    sampling-off tolerances hold."""
    X, state = make_dbm_inputs(sizes, B, M, 4, cuda, w_std=w_std)
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
    """Every minibatch launches the mean-field graph once, which runs
    turns of sweeps on the device until mean-field stops; the host counts
    its other launches, and the graph's kernels from the turns it counted
    (ceil(n_mf / MF_BODY_SWEEPS) a step).  The budget is what
    ``mf_sweeps_enqueued`` counts.  One bias launch updates vb and every
    hb."""
    sizes, B, M, NB, k, max_mf = (24, 16, 12), 8, 8, 3, 2, 20
    X, state = make_dbm_inputs(sizes, B, M, NB, cuda)
    cfg = dbm_config(sizes, k, max_mf, 1e-4, False)
    dbm_ops.reset_launches()
    _, _, n_mf = dbm_ops.dbm_epoch(cfg, state, X, 0.05, 0.5, 3, 0)
    L, body = 2, dbm_ops.MF_BODY_SWEEPS
    turns = dbm_ops.count_mf_graph(n_mf.cpu())
    assert dbm_ops.dbm_epoch.launches == {
        'dbm_gemm_act': NB * (1 + L + k * (L + 1) + 1) + L * body * turns,
        'dbm_bias_update': NB, 'dbm_assoc_update': NB * L,
        'dbm_max_norm': NB * L, 'dbm_msre': NB, 'dbm_mf_check': turns,
        'dbm_softmax': 0}
    assert dbm_ops.dbm_epoch.graph_launches == NB
    assert dbm_ops.dbm_epoch.sweeps['mf_sweeps_enqueued'] == NB * max_mf
    assert 1 <= float(n_mf.min()) and float(n_mf.max()) < max_mf
    # no max-norm pass when max_norm is infinite
    dbm_ops.reset_launches()
    dbm_ops.dbm_epoch(dbm_config(sizes, k, max_mf, 1e-4, False,
                                 max_norm=float('inf')), state, X, 0.05,
                      0.5, 3, 0)
    assert dbm_ops.dbm_epoch.launches['dbm_max_norm'] == 0


@pytest.mark.parametrize('sizes,B,M,sample,w_std', DBM_CASES)
def test_dbm_sample_kernel_matches_plain_version(cuda, sizes, B, M, sample,
                                                 w_std):
    _, state = make_dbm_inputs(sizes, B, M, 1, cuda, seed=2, w_std=w_std)
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


def dbm_step_exact(got, want, B, M):
    """Whether a step's kernel and plain results agree within the
    sampling-off tolerances: state atol 1e-5 + rtol 1e-5, the EMAs of batch
    sums atol 1e-5 (B + M) + rtol 1e-4, msre atol 1e-6, n_mf within a sweep
    (at mf_tol 1e-7 the change sits at the means' f32 rounding, so two sum
    orders may stop a sweep apart, which then moves mu by <= 1e-7)."""
    for key in dbm_ops.STATE_KEYS:
        a, b = got[0][key], want[0][key]
        sums = key in ('q_means', 'mu_means')
        atol, rtol = (1e-5 * (B + M), 1e-4) if sums else (1e-5, 1e-5)
        for x, y in zip(a, b) if isinstance(b, tuple) else [(a, b)]:
            if not torch.allclose(x, y, rtol=rtol, atol=atol):
                return False
    return (float((got[1] - want[1]).abs().max()) <= 1e-6
            and float((got[2] - want[2]).abs().max()) <= 1)


@PATH
def test_dbm_epoch_sampled_steps_at_path_width(cuda):
    """examples/dbm_mnist.py's step (k 1, 50 sweeps at mf_tol 1e-7, its
    l2, max_norm, sparsity and the first lr and momentum of its schedules),
    sampling on: both draw the same Philox uniforms, and a state
    differs only where a mean lies within rounding of its uniform (~0.01
    such draws a step among 2.3e5), after which the chains part.  So each
    of 20 steps starts both from the kernel's state: a step is exact
    (dbm_step_exact) or holds a flip, which moves dW by at most lr / M a
    flipped unit; at least 15 of 20 exact, dW of the others within
    4 lr / M."""
    sizes, B, M, lr, nb = (784, 512, 1024), 100, 100, 2e-3, 20
    X, state = make_dbm_inputs(sizes, B, M, nb, cuda, seed=11, w_std=0.03)
    cfg = dbm_ops.DBMEpochConfig(sizes, 1, 50, 1e-7, True, (True, True),
                                 1e-7, 6., (0.2, 0.1), (1e-4, 5e-5), 0.9)
    exact = 0
    for i in range(nb):
        got = dbm_ops.dbm_epoch(cfg, state, X[i:i + 1], lr, 0.5, 13, i)
        want = dbm_ops.dbm_epoch_reference(cfg, state, X[i:i + 1], lr, 0.5,
                                           13, i)
        if dbm_step_exact(got, want, B, M):
            exact += 1
        else:
            d_dw = max(float((a - b).abs().max())
                       for a, b in zip(got[0]['dW'], want[0]['dW']))
            assert d_dw <= 4 * lr / M + 1e-5, (i, d_dw)
        state = got[0]
    assert exact >= 15


@PATH
def test_dbm_sample_sampled_sweeps_at_path_width(cuda):
    """dbm_mnist's sampled sweeps of 100 particles (sample_v's), 20 single
    sweeps, each from the kernel's state: a sweep is exact (v and H within
    1e-4) unless a uniform lies within rounding of its mean; at least 15 of
    20 exact, and at most 1e-4 of the hidden states differ."""
    sizes, M, nb = (784, 512, 1024), 100, 20
    _, state = make_dbm_inputs(sizes, M, M, 1, cuda, seed=2, w_std=0.03)
    cfg = dbm_ops.DBMSampleConfig(sizes, True, (True, True))
    exact, n_diff = 0, 0
    for i in range(nb):
        got = dbm_ops.dbm_sample(cfg, state, 1, 100 + i)
        want = dbm_ops.dbm_sample_reference(cfg, state, 1, 100 + i)
        n = sum(int(((a - b).abs() > 1e-4).sum())
                for a, b in zip(got[0]['H'], want[0]['H']))
        exact += n == 0 and bool(((got[1] - want[1]).abs() <= 1e-4).all())
        n_diff += n
        state = got[0]
    assert exact >= 15
    assert n_diff <= 1e-4 * nb * M * sum(sizes[1:])


# (sizes, runs, sample, atol of the log-weights): small shapes sampled and
# not, and dbm_mnist.py's log_Z (784-512-1024, 100 runs) with sampling off
# (a threshold flip would part a run), where each log p~ sums ~2e3
# softplus terms to ~5e3 (f32 ulp 5e-4) and 2 x 50 of them accumulate
AIS_CASES = [(sizes, R, sample, 2e-3)
             for sizes, R in (((24, 16, 12), 8), ((70, 37, 65), 13))
             for sample in (False, True)] + at_path(
                 ((784, 512, 1024), 100, False, 0.05))


@pytest.mark.parametrize('sizes,R,sample,atol', AIS_CASES)
def test_ais_kernel_matches_plain_version(cuda, sizes, R, sample, atol):
    """Log-weights within `atol`: at the small shapes 2e-3, each log p~ a
    sum of ~1e2 softplus terms of magnitude ~1e2 taken in another order,
    and 2 x 50 of them accumulate."""
    _, state = make_dbm_inputs(sizes, 4, 4, 1, cuda, seed=3)
    V, H1, H2 = sizes
    cfg = dbm_ops.AISConfig(V, H1, H2, 50, 2, sample, sample, sample)
    x0 = (torch.rand((R, H1), device=cuda) < 0.5).float()
    dbm_ops.reset_launches()
    got = dbm_ops.ais(cfg, state, 5, x0)
    want = dbm_ops.ais_reference(cfg, state, 5, x0)
    torch.cuda.synchronize()
    assert dbm_ops.ais.launches == {'dbm_gemm_act': 50 * (3 * 2 + 2),
                                    'ais_logw': 1}
    torch.testing.assert_close(got, want, rtol=0, atol=atol)


# (sizes, R): V and H2 with other column-block counts (3 and 2 blocks of
# 128), runs not a multiple of the 8 warps of a block
AIS_EDGE_SHAPES = [((300, 37, 140), 13), ((24, 16, 12), 8)]


@pytest.mark.parametrize('sizes,R', AIS_EDGE_SHAPES)
@pytest.mark.parametrize('n_betas,k', [(1, 2), (2, 2), (50, 2), (3, 0)])
def test_ais_fused_update_edges(cuda, sizes, R, n_betas, k):
    """Each beta's log-weight update rides on the next beta's first launch
    and the last one runs alone: at n_betas 1 (no next beta), 2 and 50, and
    at k = 0 (the next beta's first launch is its log p~ product, which
    writes the other set of partials), log_w within the atol 2e-3 of
    test_ais_kernel_matches_plain_version; 3k + 2 launches a beta and one
    ais_logw a call; a second call on the same stream the same bits.
    Sampling off: a draw within rounding of its mean would part a run from
    its plain twin, and the update is what is tested here."""
    _, state = make_dbm_inputs(sizes, 4, 4, 1, cuda, seed=3)
    cfg = dbm_ops.AISConfig(*sizes, n_betas, k, False, False, False)
    x0 = (torch.rand((R, sizes[1]), device=cuda) < 0.5).float()
    dbm_ops.reset_launches()
    got = dbm_ops.ais(cfg, state, 7, x0)
    assert dbm_ops.ais.launches == {'dbm_gemm_act': n_betas * (3 * k + 2),
                                    'ais_logw': 1}
    again = dbm_ops.ais(cfg, state, 7, x0)
    want = dbm_ops.ais_reference(cfg, state, 7, x0)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=2e-3)
    assert torch.equal(got, again)


@PATH
def test_ais_logw_fused_equals_alone(cuda):
    """One beta's log-weight update at dbm_mnist.py's log_Z (784-512-1024,
    100 runs): launched alone (an AIS run's last beta) and riding on the
    next beta's first launch (``bm_ais_gemm_act``, v = sigmoid(beta
    (x.W0^T + vb))), the same bits; both against the plain update, within
    1e-4 of the largest log-weight; a rerun of the launch alone bit for
    bit."""
    import ctypes
    lib = dbm_ops._library()
    R, (V, H1, H2) = 100, (784, 512, 1024)
    nblk_v, nblk_h2 = (lib.bm_dbm_gemm_col_blocks(n) for n in (V, H2))
    rng = np.random.RandomState(11)

    def t(*shape, scale=1.):
        return torch.as_tensor(rng.randn(*shape) * scale,
                               dtype=torch.float32, device=cuda)
    x, hb0 = (t(R, H1) > 0).float(), t(H1, scale=0.1)
    part_v, part_h2, log_w0 = t(2 * R * nblk_v), t(2 * R * nblk_h2), t(R)
    W0, vb, v = t(V, H1, scale=0.03), t(V, scale=0.1), torch.empty(
        R, V, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream

    def update(log_w):
        return dbm_ops.AisLogw(
            x.data_ptr(), hb0.data_ptr(), part_v.data_ptr(),
            part_h2.data_ptr(), log_w.data_ptr(), R, H1, nblk_v, nblk_h2,
            0.37, 0.38)

    def alone(log_w):
        u = update(log_w)
        dbm_ops._check(lib.bm_ais_logw(
            u.x, u.hb0, R, H1, u.part_v, nblk_v, u.part_h2, nblk_h2, 0.37,
            0.38, u.log_w, None, stream), 'ais_logw')
        return log_w

    got, again, fused = alone(log_w0.clone()), alone(log_w0.clone()), \
        log_w0.clone()
    a = dbm_ops._gemm_args(v, [(x, W0, True)], bias=vb, stream=stream)
    a.alpha = a.gamma = 0.4
    pending = update(fused)
    dbm_ops._check(lib.bm_ais_gemm_act(ctypes.byref(a), ctypes.byref(
        pending), stream), 'dbm_gemm_act')
    pv, ph = part_v.view(2, R, nblk_v), part_h2.view(2, R, nblk_h2)
    xh = x @ hb0
    want = log_w0 - (0.37 * xh + pv[0].sum(1) + ph[0].sum(1)) + \
        (0.38 * xh + pv[1].sum(1) + ph[1].sum(1))
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
    assert torch.equal(got, again) and torch.equal(got, fused)


def ais_options(sizes, option, dev):
    """The ladder (AISConfig.ladder) and base rate of a log_Z option at 50
    betas."""
    from boltzmann_machines_tpu_torch.dbm import make_beta_schedule
    ladder = tuple(make_beta_schedule(50, 'adaptive')) \
        if option in ('adaptive', 'both') else None
    b0 = None
    if option in ('base_rate', 'both'):
        rng = np.random.RandomState(4)
        b0 = torch.as_tensor((rng.randn(sizes[1]) * 0.5).astype(np.float32),
                             device=dev)
    return ladder, b0


@pytest.mark.parametrize('sizes,R', [((24, 16, 12), 8), ((70, 37, 65), 13)])
@pytest.mark.parametrize('option', ['adaptive', 'base_rate', 'both'])
@pytest.mark.parametrize('sample', [False, True])
def test_ais_options_kernel_matches_plain_version(cuda, sizes, R, option,
                                                  sample):
    """log_Z's options on the AIS kernels: the adaptive ladder (the host
    sets each launch's betas) and the base rate (the h1 launches' second
    bias (1 - beta) b0, (1 - beta) x.b0 in the log-weight update) against
    the plain version, the same Philox draws: log-weights within the atol
    2e-3 of test_ais_kernel_matches_plain_version, 3k + 2 launches a beta
    and one ais_logw, a rerun the same bits."""
    _, state = make_dbm_inputs(sizes, 4, 4, 1, cuda, seed=3)
    ladder, b0 = ais_options(sizes, option, cuda)
    cfg = dbm_ops.AISConfig(*sizes, 50, 2, sample, sample, sample, ladder)
    x0 = (torch.rand((R, sizes[1]), device=cuda) < 0.5).float()
    dbm_ops.reset_launches()
    got = dbm_ops.ais(cfg, state, 5, x0, b0)
    assert dbm_ops.ais.launches == {'dbm_gemm_act': 50 * (3 * 2 + 2),
                                    'ais_logw': 1}
    again = dbm_ops.ais(cfg, state, 5, x0, b0)
    want = dbm_ops.ais_reference(cfg, state, 5, x0, b0)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=2e-3)
    assert torch.equal(got, again)


@pytest.mark.parametrize('sizes,R', AIS_EDGE_SHAPES)
@pytest.mark.parametrize('k', [0, 1, 2])
@pytest.mark.parametrize('option', ['linear', 'both'])
def test_reverse_ais_kernel_matches_plain_version(cuda, sizes, R, k, option):
    """The reverse run of BDMC on the AIS kernels: each step's softplus pair
    before its transition, the pair's update riding on the transition's
    first launch (no ais_logw) or, at k = 0, on the next step's pair (one
    ais_logw for the last step).  Sampling on at k = 2; log-weights within
    atol 2e-3 of the plain version; 3k + 2 launches a step."""
    _, state = make_dbm_inputs(sizes, 4, 4, 1, cuda, seed=3)
    ladder, b0 = ais_options(sizes, option, cuda)
    sample = k == 2
    cfg = dbm_ops.AISConfig(*sizes, 50, k, sample, sample, sample, ladder)
    x0 = (torch.rand((R, sizes[1]), device=cuda) < 0.5).float()
    dbm_ops.reset_launches()
    got = dbm_ops.reverse_ais(cfg, state, 9, x0, b0)
    assert dbm_ops.ais.launches == {'dbm_gemm_act': 50 * (3 * k + 2),
                                    'ais_logw': int(k == 0)}
    want = dbm_ops.reverse_ais_reference(cfg, state, 9, x0, b0)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=2e-3)


@pytest.mark.parametrize('sample', [False, True])
def test_ais_burn_in_kernel_matches_plain_version(cuda, sample):
    """The BDMC start's burn-in: 20 transition steps at beta = 1 on the
    AIS kernels (60 launches) against the plain version, the same Philox
    draws: states within 1e-5."""
    sizes = (70, 37, 65)
    _, state = make_dbm_inputs(sizes, 4, 4, 1, cuda, seed=3)
    cfg = dbm_ops.AISConfig(*sizes, 1, 1, sample, sample, sample)
    x0 = (torch.rand((13, sizes[1]), device=cuda) < 0.5).float()
    dbm_ops.reset_launches()
    got = dbm_ops.ais_burn_in(cfg, state, 11, x0, 20)
    assert dbm_ops.ais.launches == {'dbm_gemm_act': 60, 'ais_logw': 0}
    want = dbm_ops.ais_burn_in_reference(cfg, state, 11, x0, 20)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize('sample', [False, True])
def test_dbm_mesh_step_one_rank_nccl(cuda, tmp_path, sample):
    """The DBM mesh epoch driven directly on a one-rank NCCL group (the
    plain program on the card, its draws by the sampler kernels, the
    change's MAX and the sums' SUM all_reduce) against the single-device
    DBM kernels, sampling off: the state within assert_dbm_state_close,
    msre within 1e-6, the n_mf rows equal.  Sampling on: one
    bernoulli_sample launch a sampled layer a sweep, a finite state."""
    import torch.distributed as dist
    from boltzmann_machines_tpu_torch import parallel
    from boltzmann_machines_tpu_torch.ops import samplers
    sizes, B, M = (24, 16, 12), 8, 8
    X, state = make_dbm_inputs(sizes, B, M, 3, cuda)
    cfg = dbm_config(sizes, 2, 50, 1e-4, sample)
    parallel.initialize('file://' + str(tmp_path) + '/store', 1, 0)
    try:
        group = parallel.make_mesh().group

        def reduce(op):
            return lambda t: dist.all_reduce(t, op=op, group=group)
        samplers.reset_launches()
        got, sq, n_mf = dbm_ops.dbm_mesh_epoch(
            cfg, state, X, 0.05, 0.5, 3, 10, B, M,
            reduce(dist.ReduceOp.SUM), reduce(dist.ReduceOp.MAX))
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    if sample:
        assert samplers.bernoulli_sample.launches == {
            'bernoulli_sample': 3 * 2 * 3}
        assert all(bool(torch.isfinite(t).all()) for t in got['W'])
        return
    want = dbm_ops.dbm_epoch(cfg, state, X, 0.05, 0.5, 3, 10)
    torch.cuda.synchronize()
    assert_dbm_state_close(got, want[0], B, M)
    torch.testing.assert_close(sq / (B * sizes[0]), want[1], rtol=0,
                               atol=1e-6)
    assert torch.equal(n_mf, want[2])


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


def test_dbm_epoch_bias_vectors_past_one_launch(cuda):
    """A DBM of 8 hidden layers has 9 bias vectors, one more than a
    dbm_bias_update launch takes (MAX_BIAS): each minibatch updates them in
    two launches, and the state equals the plain version's within its
    tolerance."""
    sizes, B, M, NB, k, max_mf = (20, 9, 13, 7, 5, 11, 6, 10, 4), 6, 5, 2, 1, 5
    L = len(sizes) - 1
    assert L + 1 > dbm_ops.MAX_BIAS
    X, state = make_dbm_inputs(sizes, B, M, NB, cuda, seed=8)
    cfg = dbm_config(sizes, k, max_mf, 1e-4, False)
    dbm_ops.reset_launches()
    got = dbm_ops.dbm_epoch(cfg, state, X, 0.05, 0.5, 3, 0)
    want = dbm_ops.dbm_epoch_reference(cfg, state, X, 0.05, 0.5, 3, 0)
    torch.cuda.synchronize()
    assert dbm_ops.dbm_epoch.launches['dbm_bias_update'] == NB * 2
    assert dbm_ops.dbm_epoch.launches['dbm_gemm_act'] == \
        NB * (1 + L + k * (L + 1) + 1) + \
        L * dbm_ops.MF_BODY_SWEEPS * dbm_ops.count_mf_graph(got[2].cpu())
    assert dbm_ops.dbm_epoch.graph_launches == NB
    assert torch.equal(got[2], want[2])
    assert_dbm_state_close(got[0], want[0], B, M)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-6)


# (case, max_mf_updates, mf_tol) of the mean-field loop's edges
MF_CASES = [('converges', 50, 1e-4), ('tol_0', 4, 0.), ('budget_0', 0, 1e-4),
            ('budget_1', 1, 1e-4), ('change_at_tol', 4, 0.),
            ('nan_change', 10, 1e-4)]


@pytest.mark.parametrize('sizes', [(70, 37), (70, 37, 65), (70, 37, 65, 20)])
@pytest.mark.parametrize('case,max_mf,tol', MF_CASES)
@pytest.mark.parametrize('splits', [None, 3])
def test_dbm_mf_fused_check_edges(cuda, monkeypatch, sizes, case, max_mf,
                                  tol, splits):
    """The mean-field check, after each sweep of the mean-field graph,
    at L = 1, 2, 3 and with the plan's split-K or 3 K slices everywhere (the
    first layer's launch, mu1.W1^T + T0, then has 3 at L >= 2; at L = 1 it
    has no product): the n_mf rows equal the plain version's, and the state
    is within its tolerance.  Zero weights and biases change nothing after
    the init, so the first change is exactly 0 = tol (change_at_tol); at
    L = 1 a sweep reads no hidden layer, so at tol 0 its second sweep stops
    the loop the same way; a NaN weight makes the change NaN, which stops
    the loop after one sweep, as in the JAX loop.  (The expected count is
    checked on the first minibatch: the update moves the zero weights
    before the second.)"""
    L = len(sizes) - 1
    B, M = 5, 7
    X, state = make_dbm_inputs(sizes, B, M, 2, cuda, seed=L)
    if case == 'change_at_tol':
        state = dict(state, W=tuple(torch.zeros_like(w) for w in state['W']),
                     hb=tuple(torch.zeros_like(h) for h in state['hb']))
    if case == 'nan_change':
        W = [w.clone() for w in state['W']]
        W[-1][0, 0] = float('nan')
        state = dict(state, W=tuple(W))
    if splits:
        plan = dbm_ops.launch_plan
        monkeypatch.setattr(dbm_ops, 'launch_plan',
                            lambda *a: plan(*a[:-1], splits))
        if L > 1:
            stream = torch.cuda.current_stream().cuda_stream
            assert plan(B, sizes[1], [sizes[2]], cuda, stream,
                        splits)[0].splits > 1
    cfg = dbm_config(sizes, 1, max_mf, tol, False)
    got = dbm_ops.dbm_epoch(cfg, state, X, 0.05, 0.5, 3, 10)
    want = dbm_ops.dbm_epoch_reference(cfg, state, X, 0.05, 0.5, 3, 10)
    torch.cuda.synchronize()
    assert torch.equal(got[2], want[2]), (got[2], want[2])
    expect = {'budget_0': 0., 'budget_1': 1., 'change_at_tol': 1.,
              'nan_change': 1., 'tol_0': 2. if L == 1 else 4.}.get(case)
    if expect is not None:
        assert float(got[2][0]) == expect
    if case != 'nan_change':
        assert_dbm_state_close(got[0], want[0], B, M)
        torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-6)


def mf_graph(layers, ctrl, tol, budget, body=None):
    """The mean-field graph of `layers` (GemmArgs) over `ctrl`, `body`
    sweeps a turn (MF_BODY_SWEEPS where None)."""
    import ctypes
    lib = dbm_ops._library()
    arr = (dbm_ops.GemmArgs * len(layers))(*layers)
    graph = ctypes.c_void_p()
    dbm_ops._check(lib.bm_dbm_mf_graph_create(
        arr, len(layers), ctrl.data_ptr(), tol, budget,
        dbm_ops.MF_BODY_SWEEPS if body is None else body, None,
        ctypes.byref(graph)), 'dbm_mf_graph_create')
    return graph


def mf_ctrl(body, fill, device):
    """The control words of a graph of `body` sweeps a turn, each `fill`,
    but the turn count 0."""
    ctrl = torch.full((dbm_ops.MF_CHANGE_WORD + body + 1,), fill,
                      dtype=torch.int32, device=device)
    ctrl[-1] = 0
    return ctrl


def run_mf_graph(graph, times=1):
    lib = dbm_ops._library()
    stream = torch.cuda.current_stream().cuda_stream
    for _ in range(times):
        dbm_ops._check(lib.bm_dbm_mf_graph_launch(graph, stream),
                       'dbm_mf_graph_launch')
    torch.cuda.synchronize()


def free_mf_graph(graph):
    torch.cuda.synchronize()
    dbm_ops._check(dbm_ops._library().bm_dbm_mf_graph_destroy(graph),
                   'dbm_mf_graph_destroy')


@pytest.mark.parametrize('splits', [1, 3])
def test_dbm_mf_check_stops_at_tol(cuda, splits):
    """One layer launch through the mean-field graph, zero weights and
    bias, so every mean is sigmoid(0) = 0.5 exactly: from means of 0.25 the
    first change is 0.25 exactly.  At tol 0.25 the loop stops after that
    sweep (n_mf 1, in ctrl word 1); at the float below 0.25 it runs a
    second, whose change is 0 (n_mf 2); at a budget of 1 it stops after one
    whatever the change; and at a budget of 3 with tol -1 it runs all
    three.  With the plan's one K slice and with 3, and 1 to 4 sweeps a
    turn, so that each stop falls at each place of a turn: the turn count
    reads ceil(n_mf / body), and the sweeps of a turn after the stop
    change nothing."""
    stream = torch.cuda.current_stream().cuda_stream
    x = torch.rand((30, 256), device=cuda)
    W = torch.zeros((256, 200), device=cuda)
    below = float(np.nextafter(np.float32(0.25), np.float32(0)))
    for body in (1, 2, 3, 4):
        for tol, budget, n_want in ((0.25, 5, 1), (below, 5, 2),
                                    (below, 1, 1), (-1., 3, 3)):
            out = torch.full((30, 200), 0.25, device=cuda)
            ctrl = mf_ctrl(body, 7, cuda)
            a = dbm_ops._gemm_args(out, [(x, W, False)],
                                   act=dbm_ops.ACT_SIGMOID_DELTA,
                                   stream=stream, splits=splits)
            assert a.splits == splits
            graph = mf_graph([a], ctrl, tol, budget, body)
            try:
                run_mf_graph(graph)
            finally:
                free_mf_graph(graph)
            case = (body, tol, budget, ctrl)
            assert int(ctrl[1]) == n_want, case
            assert int(ctrl[-1]) == -(-n_want // body), case
            assert bool((out == 0.5).all())


def test_dbm_mf_loop_rejects_bad_layers(cuda):
    """Every layer of the mean-field graph must fold its change (the
    mean-field epilogue), or the check could never stop it; no layer at
    all is refused too, and so are a negative budget, no sweep a turn, no
    control words and nowhere to put the graph.  A graph refused is none
    (null)."""
    import ctypes
    stream = torch.cuda.current_stream().cuda_stream
    lib = dbm_ops._library()
    out = torch.zeros((8, 16), device=cuda)
    ctrl = mf_ctrl(dbm_ops.MF_BODY_SWEEPS, 0, cuda)
    a = dbm_ops._gemm_args(out, [(torch.rand((8, 24), device=cuda),
                                  torch.rand((24, 16), device=cuda), False)],
                           stream=stream)
    graph = ctypes.c_void_p(1)
    body = dbm_ops.MF_BODY_SWEEPS

    def create(layers, n, ctrl_ptr, budget, body, out, rows=None):
        return lib.bm_dbm_mf_graph_create(layers, n, ctrl_ptr, 0., budget,
                                          body, rows, out)
    ref, c = ctypes.byref(a), ctrl.data_ptr()
    assert create(ref, 1, c, 1, body, ctypes.byref(graph)) != 0
    assert graph.value is None
    a.act = dbm_ops.ACT_SIGMOID_DELTA
    assert create(None, 0, c, 1, body, ctypes.byref(graph)) != 0
    assert create(ref, 0, c, 1, body, ctypes.byref(graph)) != 0
    assert create(ref, 1, c, -1, body, ctypes.byref(graph)) != 0
    assert create(ref, 1, c, 1, 0, ctypes.byref(graph)) != 0
    assert create(ref, 1, None, 1, body, ctypes.byref(graph)) != 0
    assert create(ref, 1, c, 1, body, None) != 0
    assert lib.bm_dbm_mf_graph_launch(None, stream) != 0
    assert lib.bm_dbm_mf_graph_destroy(None) == 0
    graph = mf_graph([a], ctrl, 0., 1)
    try:
        run_mf_graph(graph)
    finally:
        free_mf_graph(graph)
    assert int(ctrl[1]) == 1


def mf_layers(mu, Ws, hbs, T0, stream):
    """The sweep's layer launches of a mean-field loop over `mu`."""
    L = len(mu)
    layers = []
    for l in range(L):
        A = [(mu[l - 1], Ws[l], False)] if l else []
        if l + 1 < L:
            A.append((mu[l + 1], Ws[l + 1], True))
        layers.append(dbm_ops._gemm_args(
            mu[l], A, c=T0 if l == 0 else None, bias=hbs[l],
            act=dbm_ops.ACT_SIGMOID_DELTA, stream=stream))
    return layers


def mf_by_launches(layers, tol, budget):
    """The mean-field loop from the host, one bm_dbm_gemm_act launch a
    layer of each sweep, the sweep's change read after it: (n_mf, the
    changes).  The same kernel on the same arguments, so the same bits, as
    the graph's."""
    import ctypes
    lib = dbm_ops._library()
    stream = torch.cuda.current_stream().cuda_stream
    word = torch.zeros(1, dtype=torch.int32, device='cuda')
    n, changes = 0, []
    while n < budget:
        word.zero_()
        for a in layers:
            a.delta_bits = word.data_ptr()
            dbm_ops._check(lib.bm_dbm_gemm_act(ctypes.byref(a), stream),
                           'dbm_gemm_act')
        n += 1
        changes.append(float(word.view(torch.float32)))
        if not changes[-1] > tol:
            break
    return n, changes


def graph_kernels(run):
    """The kernels the card ran in `run()` by the device trace's short
    names (copies and sets left out): a Counter."""
    from collections import Counter
    from torch.profiler import ProfilerActivity, profile
    from port_bench.harness.trace import short_name
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    names = [short_name(e.name) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return Counter(n for n in names if n.endswith('_kernel'))


@pytest.mark.parametrize('body', sorted({1, 5, dbm_ops.MF_BODY_SWEEPS}))
@pytest.mark.parametrize('case', ['budget', 'converges', 'one_sweep',
                                  'nan_change', 'twice'])
def test_dbm_mf_graph_matches_host_loop(cuda, case, body):
    """The mean-field graph at the DBM step's widths (784-512-1024, 100
    rows) against the same layer launches run from the host and the plain
    ``mean_field``: tol -1 runs the whole budget (n_mf = budget); a tol
    between the second and third changes stops after three sweeps; a tol
    at the first change stops after one; a NaN change stops after one; and
    the graph launched again re-arms its words and gives the same bits.  mu
    is the host loop's bit for bit (NaN included), so the sweeps of a turn
    after the stop change nothing; n_mf (ctrl word 1, which dbm_msre
    reads) is its rule's, and the card runs ceil(n_mf / body) turns, the
    count in the last control word: L x body launches a turn that a device
    trace names dbm_gemm_act_kernel and one dbm_mf_check_kernel.  With 1,
    5 and MF_BODY_SWEEPS sweeps a turn (12 sweeps: turns of 5 stop inside
    their third)."""
    from boltzmann_machines_tpu_torch.ops.dbm_ops import mean_field
    stream = torch.cuda.current_stream().cuda_stream
    rng = np.random.RandomState(11)
    V, H1, H2, B, budget = 784, 512, 1024, 100, 12

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=cuda)
    X = t(rng.rand(B, V) < 0.3)
    Ws = [t(rng.randn(V, H1) * 0.03), t(rng.randn(H1, H2) * 0.03)]
    if case == 'nan_change':
        Ws[1][0, 0] = float('nan')
    hbs = [t(np.full(H1, -0.5)), t(np.full(H2, -0.5))]
    T0 = X @ Ws[0]
    mu0 = [torch.sigmoid(2. * T0 + hbs[0])]
    mu0.append(torch.sigmoid(mu0[0] @ Ws[1] + hbs[1]))
    mu = [m.clone() for m in mu0]
    layers = mf_layers(mu, Ws, hbs, T0, stream)
    _, changes = mf_by_launches(layers, -1., 4)
    if case == 'converges':
        tol = (changes[1] + changes[2]) / 2.
    elif case == 'one_sweep':
        tol = changes[0]
    else:
        tol = -1. if case == 'budget' else 1e-4
    for m, m0 in zip(mu, mu0):
        m.copy_(m0)
    n_host, _ = mf_by_launches(layers, tol, budget)
    want = [m.clone() for m in mu]
    n_want = {'budget': budget, 'converges': 3, 'one_sweep': 1,
              'nan_change': 1}.get(case, n_host)
    assert n_host == n_want
    if case in ('budget', 'converges'):
        # the plain version's sums in another order: its changes lie far
        # from these two tolerances
        _, n_plain = mean_field(X, tuple(Ws), tuple(hbs), budget, tol)
        assert int(n_plain) == n_want
    for m, m0 in zip(mu, mu0):
        m.copy_(m0)
    ctrl = mf_ctrl(body, 9, cuda)
    made = []

    def first_run():
        # made inside the trace, as the port makes its graph each epoch
        made.append(mf_graph(mf_layers(mu, Ws, hbs, T0, stream), ctrl, tol,
                             budget, body))
        run_mf_graph(made[0])
    turns = -(-n_want // body)
    try:
        kernels = graph_kernels(first_run)
        graph = made[0]
        if case == 'twice':
            first = [m.clone() for m in mu] + [ctrl[:-1].clone()]
            for m, m0 in zip(mu, mu0):
                m.copy_(m0)
            run_mf_graph(graph)
            again = [m.clone() for m in mu] + [ctrl[:-1].clone()]
            assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                       for a, b in zip(first, again))
            turns *= 2
    finally:
        for g in made:
            free_mf_graph(g)
    for got, exp in zip(mu, want):
        assert torch.equal(got.view(torch.int32), exp.view(torch.int32))
    assert int(ctrl[1]) == n_want
    assert int(ctrl[-1]) == turns
    n_turns = -(-n_want // body)
    assert kernels == {'dbm_gemm_act_kernel': 2 * body * n_turns,
                       'dbm_mf_check_kernel': n_turns}, kernels


@pytest.mark.parametrize('L', [1, 2, 3])
def test_dbm_mf_graph_budget_0_runs_nothing(cuda, L):
    """A budget of 0 runs no sweep: the graph zeroes its words and its
    loop, unarmed, leaves mu as it was (n_mf 0, no turn); a budget of 1
    runs one, whatever the change, in one turn whose later sweeps return
    at once."""
    stream = torch.cuda.current_stream().cuda_stream
    sizes = (70, 37, 65, 20)[:L + 1]
    torch.manual_seed(L)
    X = (torch.rand((5, sizes[0]), device=cuda) < 0.3).float()
    Ws = [0.3 * torch.randn((sizes[l], sizes[l + 1]), device=cuda)
          for l in range(L)]
    hbs = [0.1 * torch.randn(h, device=cuda) for h in sizes[1:]]
    T0 = X @ Ws[0]
    mu0 = [torch.rand((5, h), device=cuda) for h in sizes[1:]]
    for budget in (0, 1):
        mu = [m.clone() for m in mu0]
        ctrl = mf_ctrl(dbm_ops.MF_BODY_SWEEPS, 3, cuda)
        made = []

        def run():
            made.append(mf_graph(mf_layers(mu, Ws, hbs, T0, stream), ctrl,
                                 1e-4, budget))
            run_mf_graph(made[0])
        try:
            kernels = graph_kernels(run)
        finally:
            for g in made:
                free_mf_graph(g)
        assert int(ctrl[1]) == budget and int(ctrl[-1]) == budget
        assert kernels == ({'dbm_gemm_act_kernel':
                            L * dbm_ops.MF_BODY_SWEEPS * budget,
                            'dbm_mf_check_kernel': budget} if budget
                           else {}), kernels
        assert all(torch.equal(a, b) for a, b in zip(mu, mu0)) == \
            (budget == 0)


# ---------------------------------------------------------------------- #
# the tensor-core tile of cd_gemm_act and dbm_gemm_act (csrc/gemm_tc.cuh) #
# ---------------------------------------------------------------------- #
# (B, V, H): the ragged SHAPES and every product of the paths
GEMM_SHAPES = [(B, V, H) for V, H, B in SHAPES] + at_path(
    (10, 784, 1024), (128, 784, 1024), (100, 3072, 5000), (100, 5000, 1000),
    (50, 3072, 7800))


def cd_gemm(A, W, transposed, bias, sigma, mult, act, states, seed=5, it=2,
            stream_id=3, shard=0, splits=None):
    """One cd_gemm_act launch: (means, states) of act(mult (A.W^(T) + b)),
    with `splits` K slices instead of the plan's where given."""
    from boltzmann_machines_tpu_torch.ops.cd_epoch import (
        _launch_gemm_act, library)
    N = W.shape[0] if transposed else W.shape[1]
    means = torch.empty((A.shape[0], N), device=A.device)
    st = torch.empty_like(means) if states else None
    counts = {'cd_gemm_act': 0}
    _launch_gemm_act(library(), torch.cuda.current_stream().cuda_stream, A,
                     W, transposed, bias, sigma, mult, act, means, st, seed,
                     it, stream_id, shard, launches=counts, splits=splits)
    assert counts == {'cd_gemm_act': 1}
    return means, st


def cd_gemm_plain(A, W, transposed, bias, sigma, mult, act, seed=5, it=2,
                  stream_id=3, shard=0):
    from boltzmann_machines_tpu_torch.ops.cd_epoch import (
        ACT_GAUSSIAN, ACT_PRE)
    from boltzmann_machines_tpu_torch.ops.philox import bernoulli, normal
    acc = A @ (W.T if transposed else W)
    if act == ACT_GAUSSIAN:
        mu = mult * (acc * sigma + bias)
        return mu, mu + normal(seed, it, stream_id, mu.shape, A.device,
                               shard) * sigma
    if act == ACT_PRE:
        return mult * (acc + bias), None
    mu = torch.sigmoid(mult * (acc + bias))
    return mu, bernoulli(mu, seed, it, stream_id, shard)


def gemm_operands(B, V, H, transposed, dev, seed=0):
    rng = np.random.RandomState(seed)
    K, N = (H, V) if transposed else (V, H)
    W = torch.as_tensor(rng.randn(V, H) * 0.05, dtype=torch.float32,
                        device=dev)
    A = torch.as_tensor(rng.randn(B, K), dtype=torch.float32, device=dev)
    bias = torch.as_tensor(rng.randn(N) * 0.1, dtype=torch.float32,
                           device=dev)
    sigma = torch.as_tensor(rng.rand(N) + 0.5, dtype=torch.float32,
                            device=dev)
    return A, W, bias, sigma


# The tile's error against the plain product in true f32, per element of
# A.W: at most 2^-22 (gemm.ERR_SUM |A|.|W| + |A.W|).  Read on the H100 by
# `python3 chip_smoke.py --readings` on this file's operands: the committed
# tile needs at most 0.69 (50 x 3072 -> 7800); the tile with one
# accumulator per slice (the tensor cores truncate its sum, ROADMAP Queue
# C8) needs 5.7-19.6 at every product of the paths (K >= 784), so this
# bound fails it there.


def assert_gemm_close(got, want, act, A, W, transposed, bias, sigma, mult):
    """Each element within the bound its own terms give: the product's
    error E = 2^-22 (gemm.ERR_SUM |A|.|W| + |A.W|) carried through the
    epilogue with the bias's rounding -- times mult for the
    pre-activation, mult sigma for the Gaussian mean, mult / 4 for the
    sigmoid (plus 2^-20 of the mean: its exp); Gaussian states within the
    mean's bound plus 1e-5 sigma (1 + |n|) for the Box-Muller draw n (C15)
    and 2^-22 |v|; Bernoulli states in <= 1e-5 of draws plus one (a mean
    within rounding of its uniform)."""
    from boltzmann_machines_tpu_torch.ops import gemm
    from boltzmann_machines_tpu_torch.ops.cd_epoch import (
        ACT_GAUSSIAN, ACT_PRE)
    u = 2. ** -22
    Wk = W.T if transposed else W
    E = u * (gemm.ERR_SUM * (A.abs() @ Wk.abs()) + (A @ Wk).abs())
    b = u * bias.abs()
    if act == ACT_PRE:
        tol = mult * (E + b)
    elif act == ACT_GAUSSIAN:
        tol = mult * (sigma * E + b)
    else:
        tol = mult / 4. * (E + b) + 2. ** -20 * want[0].abs()
    excess = (got[0] - want[0]).abs() - tol
    assert float(excess.max()) <= 0., 'means off by %.3g over the bound' % \
        float(excess.max())
    if want[1] is None:
        assert got[1] is None
    elif act == ACT_GAUSSIAN:
        n = (want[1] - want[0]) / sigma
        tol_v = tol + 1e-5 * sigma * (1. + n.abs()) + u * want[1].abs()
        assert bool(((got[1] - want[1]).abs() <= tol_v).all())
    else:
        assert int((got[1] != want[1]).sum()) <= 1e-5 * want[1].numel() + 1


@pytest.mark.parametrize('B,V,H', GEMM_SHAPES)
@pytest.mark.parametrize('transposed', [False, True])
@pytest.mark.parametrize('act', [0, 1, 2])
def test_cd_gemm_act_matches_plain_version(cuda, B, V, H, transposed, act):
    """Every epilogue (sigmoid with Bernoulli states, Gaussian with
    Box-Muller states, the pre-activation) in both directions of W, at the
    ragged shapes and the paths' products; a second same-seed launch is bit
    for bit the first."""
    A, W, bias, sigma = gemm_operands(B, V, H, transposed, cuda)
    sigma = sigma if act == 1 else None
    states = act != 2
    got = cd_gemm(A, W, transposed, bias, sigma, 2., act, states)
    again = cd_gemm(A, W, transposed, bias, sigma, 2., act, states)
    want = cd_gemm_plain(A, W, transposed, bias, sigma, 2., act)
    torch.cuda.synchronize()
    assert_gemm_close(got, want, act, A, W, transposed, bias, sigma, 2.)
    assert torch.equal(got[0], again[0])
    assert not states or torch.equal(got[1], again[1])


@pytest.mark.parametrize('B,V,H', [(67, 50, 129), *at_path(
    (10, 784, 1024), (100, 5000, 1000), (50, 3072, 7800))])
@pytest.mark.parametrize('transposed', [False, True])
def test_cd_gemm_act_split_counts(cuda, B, V, H, transposed):
    """Split-K with 1, 2, 3 and 7 slices and the plan's: each within the
    plain tolerance, each bit for bit the same on a same-seed rerun."""
    A, W, bias, _ = gemm_operands(B, V, H, transposed, cuda, seed=1)
    want = cd_gemm_plain(A, W, transposed, bias, None, 1., 0)
    for splits in (1, 2, 3, 7, None):
        runs = [cd_gemm(A, W, transposed, bias, None, 1., 0, True,
                        splits=splits) for _ in range(2)]
        torch.cuda.synchronize()
        assert_gemm_close(runs[0], want, 0, A, W, transposed, bias, None, 1.)
        assert torch.equal(runs[0][0], runs[1][0])
        assert torch.equal(runs[0][1], runs[1][1])


# The K loop's edges, per batch width of the tile (gemm.N_TILES): the batch
# rows that give each width at an output of 4100 columns (33 model tiles,
# so the plan keeps the width), and the ring's depth at that width
# (csrc/gemm_tc.cuh stages(n_tile)).
TILE_BATCH = {8: 5, 16: 12, 32: 30, 56: 50, 64: 60, 104: 100, 128: 128}
TILE_RING = {8: 6, 16: 6, 32: 6, 56: 6, 64: 6, 104: 4, 128: 4}
K_LOOP_EDGES = {'one': lambda S: 1, 'two': lambda S: 2,
                'ring_less_one': lambda S: S - 1,
                'ring_plus_one': lambda S: S + 1,
                'many_rings': lambda S: 4 * S + 1}


@pytest.mark.parametrize('n_tile', sorted(TILE_BATCH))
@pytest.mark.parametrize('edge', sorted(K_LOOP_EDGES))
@pytest.mark.parametrize('transposed', [False, True])
def test_cd_gemm_act_k_loop_edges(cuda, n_tile, edge, transposed):
    """The pipelined K loop at every batch width, with a block walking one
    k-tile, two, one less than the ring, one more, and many rings (one
    slice, the last k-tile ragged by 5), in both directions of W: within
    the plain tolerance, and bit for bit the same on a same-seed rerun; the
    many-ring case also at 3 and 7 slices."""
    from boltzmann_machines_tpu_torch.ops import gemm
    B, N = TILE_BATCH[n_tile], 4100
    K = 32 * K_LOOP_EDGES[edge](TILE_RING[n_tile]) - 5
    V, H = (N, K) if transposed else (K, N)
    plan = gemm.gemm_plan(B, N, K, gemm.num_sms(cuda))
    assert plan.n_tile == n_tile
    A, W, bias, _ = gemm_operands(B, V, H, transposed, cuda, seed=n_tile)
    want = cd_gemm_plain(A, W, transposed, bias, None, 1., 2)
    for splits in (1, 3, 7) if edge == 'many_rings' else (1,):
        runs = [cd_gemm(A, W, transposed, bias, None, 1., 2, False,
                        splits=splits) for _ in range(2)]
        torch.cuda.synchronize()
        assert_gemm_close(runs[0], want, 2, A, W, transposed, bias, None, 1.)
        assert torch.equal(runs[0][0], runs[1][0])


@pytest.mark.parametrize('K', [37, 37 + 32 * 9])
def test_cd_gemm_act_cp_async_path(cuda, K):
    """Row strides that are no multiple of 16 bytes (TMA cannot take them)
    fill the same ring by cp.async: a (B, K) view of a wider buffer, and W
    of K columns; a base address 4 bytes off a 16-byte boundary too.  K of
    2 k-tiles, and of 11 (more than the ring holds at this width)."""
    A0, W, bias, _ = gemm_operands(9, K, 70, False, cuda, seed=2)
    wide = torch.zeros((9, K + 4), device=cuda)
    wide[:, 1:K + 1] = A0
    for A in (wide[:, 1:K + 1], wide[:, :K].copy_(A0)):
        assert A.stride() == (K + 4, 1)
        got = cd_gemm(A, W, False, bias, None, 1., 0, True)
        want = cd_gemm_plain(A, W, False, bias, None, 1., 0)
        torch.cuda.synchronize()
        assert_gemm_close(got, want, 0, A, W, False, bias, None, 1.)
    Wt = W.T.contiguous()  # (70, K): h.W^T with rows of K floats
    h = (torch.rand((9, K), device=cuda) < 0.5).float()
    got = cd_gemm(h, Wt, True, bias, None, 1., 2, False)
    want = cd_gemm_plain(h, Wt, True, bias, None, 1., 2)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-5)


def test_cd_gemm_act_rejects_a_strided_operand(cuda):
    """The tile reads activation rows K-major: a column stride other than
    1 raises in the wrapper (check_operand), before any launch."""
    A, W, bias, _ = gemm_operands(8, 24, 16, False, cuda)
    with pytest.raises(ValueError, match='unit column stride'):
        cd_gemm(A.T.contiguous().T, W, False, bias, None, 1., 0, False)


def dbm_launch(out, A, c=None, bias=None, act=dbm_ops.ACT_SIGMOID, alpha=1.,
               sample=False, ctrl=None, partials=None):
    import ctypes
    a = dbm_ops._gemm_args(out, A, c=c, bias=bias, act=act, alpha=alpha,
                           gamma=alpha,
                           stream=torch.cuda.current_stream().cuda_stream)
    a.alpha2 = 0.5
    a.sample, a.seed, a.it, a.stream_id = int(sample), 9, 4, 2
    if ctrl is not None:
        a.delta_bits = ctrl.data_ptr()
    if partials is not None:
        a.out = partials.data_ptr()
    lib = dbm_ops._library()
    dbm_ops._check(lib.bm_dbm_gemm_act(
        ctypes.byref(a), torch.cuda.current_stream().cuda_stream),
        'dbm_gemm_act')


DBM_GEMM_SHAPES = [((24, 16, 12), 8), ((70, 37, 65), 13), ((6, 5, 4), 100),
                   *at_path(((784, 512, 1024), 100))]


@pytest.mark.parametrize('sizes,M', DBM_GEMM_SHAPES)
@pytest.mark.parametrize('act', ['identity', 'sigmoid', 'sample', 'delta',
                                 'softplus'])
@pytest.mark.parametrize('products', ['two', 'none'])
def test_dbm_gemm_act_matches_plain_version(cuda, sizes, M, act, products):
    """The middle layer's two-product form x0.W0 + x2.W1^T with the addend
    C, every epilogue: identity, sigmoid, sigmoid with Philox states, the
    mean-field change (max |new - old| into the control word), and the
    softplus row sums at two betas (per column block of the tile,
    ``bm_dbm_gemm_col_blocks`` of them); same-seed reruns bit for bit.
    With no products (the mean-field init's launch on C alone) a block
    walks no k-tile."""
    import torch.nn.functional as F
    from boltzmann_machines_tpu_torch.ops.philox import bernoulli
    V, H1, H2 = sizes
    rng = np.random.RandomState(V + M)

    def t(*shape, scale=1.):
        return torch.as_tensor(rng.randn(*shape) * scale,
                               dtype=torch.float32, device=cuda)

    W0, W1 = t(V, H1, scale=0.1), t(H1, H2, scale=0.1)
    x0 = (t(M, V) > 0).float()
    x2 = (t(M, H2) > 0).float()
    c, bias, old = t(M, H1), t(H1, scale=0.1), torch.rand((M, H1),
                                                           device=cuda)
    A = [(x0, W0, False), (x2, W1, True)] if products == 'two' else []
    code = {'identity': dbm_ops.ACT_IDENTITY, 'sigmoid': dbm_ops.ACT_SIGMOID,
            'sample': dbm_ops.ACT_SIGMOID,
            'delta': dbm_ops.ACT_SIGMOID_DELTA,
            'softplus': dbm_ops.ACT_SOFTPLUS_ROWS}[act]
    nblk = dbm_ops._library().bm_dbm_gemm_col_blocks(H1)
    runs = []
    for _ in range(2):
        out = old.clone()
        ctrl = torch.zeros(1, dtype=torch.int32, device=cuda)
        part = torch.empty(2 * M * nblk, device=cuda)
        dbm_launch(out, A, c=c, bias=bias, act=code, alpha=0.7,
                   sample=act == 'sample', ctrl=ctrl,
                   partials=part if act == 'softplus' else None)
        runs.append((out, ctrl, part))
    acc = x0 @ W0 + x2 @ W1.T + c if A else c
    torch.cuda.synchronize()
    (out, ctrl, part), again = runs
    if act == 'softplus':
        got = part.view(2, M, nblk).sum(2)
        want = torch.stack([F.softplus(b * (acc + bias)).sum(1)
                            for b in (0.7, 0.5)])
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
        assert torch.equal(part, again[2])
        return
    pre = 0.7 * acc + 0.7 * bias
    want = pre if act == 'identity' else torch.sigmoid(pre)
    if act == 'sample':
        st = bernoulli(want, 9, 4, 2)
        assert int((out != st).sum()) <= 1e-5 * st.numel() + 1
    else:
        torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    if act == 'delta':
        delta = float(ctrl.view(torch.float32))
        assert abs(delta - float((want - old).abs().max())) <= 1e-5
    assert torch.equal(out, again[0]) and torch.equal(ctrl, again[1])


@pytest.mark.parametrize('N', [1, 4, 65, 128, 129, 512, 784, 1024, 7800])
def test_dbm_gemm_col_blocks_is_the_tiling(cuda, N):
    """The softplus partials are sized by the kernel's column blocks: the
    plan's model tiles, 128 columns each."""
    from boltzmann_machines_tpu_torch.ops import gemm
    n = dbm_ops._library().bm_dbm_gemm_col_blocks(N)
    assert n == -(-N // gemm.TILE_M) == gemm.gemm_plan(100, N, 64, 132) \
        .model_tiles


# ---------------------------------------------------------------------- #
# the association kernel (csrc/assoc_tc.cuh): cd_assoc_update,            #
# cd_assoc_stats and dbm_assoc_update against their plain versions        #
# ---------------------------------------------------------------------- #
# (B, V, H): the paths' associations (rbm_mnist at B = 10 and 256, the
# G-RBM and M-RBM steps, the stats calls at 128 and 50 rows) and ragged
# ones: V and H no multiples of 64 (and H of 4: the cp.async path), B from
# 1 to 256
ASSOC_SHAPES = at_path((10, 784, 1024), (256, 784, 1024),
                       (100, 3072, 5000), (100, 5000, 1000)) + [
    (1, 24, 16), (7, 37, 70), (50, 130, 65), (100, 50, 129), (256, 65, 36),
    # the K loop's edges at n_tile 32 (a ring of 4): 4, 6 and 32 k-tiles
    (33, 40, 200), (65, 130, 300), (500, 70, 45)]
ASSOC_STATS_SHAPES = at_path((50, 3072, 7800), (128, 784, 1024)) + [
    (7, 37, 70), (1, 130, 65), (256, 50, 132)]
# (N data rows, M particles, n_in, n_out): the dbm_mnist layers, and N != M
DBM_ASSOC_SHAPES = at_path((100, 100, 784, 512), (100, 100, 512, 1024)) + [
    (7, 10, 37, 70), (50, 100, 130, 65), (1, 256, 24, 16)]


def assoc_sides(K, V, H, dev, rng, gaussian):
    """(A, B): K rows of visible activations (Gaussian or 0/1) and of hidden
    means in (0, 1)."""
    A = rng.randn(K, V) if gaussian else (rng.rand(K, V) < 0.3)
    return (torch.as_tensor(A, dtype=torch.float32, device=dev),
            torch.as_tensor(rng.rand(K, H), dtype=torch.float32, device=dev))


def assoc_bound(pairs, scales, assoc):
    """The association's per-element bound: 2^-22 (gemm.ERR_SUM sum_i
    |s_i| |A_i|^T |B_i| + |assoc|)."""
    from boltzmann_machines_tpu_torch.ops import gemm
    l1 = sum(abs(s) * (A.abs().T @ B.abs()) for (A, B), s in zip(pairs,
                                                                  scales))
    return 2. ** -22 * (gemm.ERR_SUM * l1 + assoc.abs())


def assert_update_close(got, want, E, terms, lr):
    """W and dW within the association's bound E carried through the
    update: lr E; plus the roundings of the update's f32 operations, seven
    on either side, each within 2^-24 of the terms' sum (2^-20 > 14 x
    2^-24); plus 2^-22 of the results."""
    u = 2. ** -22
    tol_dw = lr * (E + 2. ** -20 * terms) + u * want[1].abs()
    tol_w = tol_dw + u * want[0].abs()
    for g, w, tol, name in ((got[0], want[0], tol_w, 'W'),
                            (got[1], want[1], tol_dw, 'dW')):
        excess = float(((g - w).abs() - tol).max())
        assert excess <= 0., '%s off by %.3g over the bound' % (name, excess)


def assoc_n_tile(V, H, dev):
    """The association's columns per block, as the wrappers pass them."""
    from boltzmann_machines_tpu_torch.ops import gemm
    return gemm.assoc_plan(V, H, gemm.num_sms(dev)).n_tile


def cd_assoc_update_launch(X, h0, v, h, pen, W, dW, lr, mom, l2):
    from boltzmann_machines_tpu_torch.ops.cd_epoch import (
        check_launch, library, ptr)
    W, dW = W.clone(), dW.clone()
    (B, V), H = X.shape, W.shape[1]
    check_launch(library().bm_cd_assoc_update(
        ptr(X), ptr(h0), ptr(v), ptr(h), ptr(pen), B, V, H, ptr(W), ptr(dW),
        lr, mom, l2, assoc_n_tile(V, H, X.device),
        torch.cuda.current_stream().cuda_stream), 'cd_assoc_update')
    return W, dW


@pytest.mark.parametrize('B,V,H', ASSOC_SHAPES)
@pytest.mark.parametrize('sparsity', [False, True])
def test_cd_assoc_update_matches_plain_version(cuda, B, V, H, sparsity):
    """W += dW = lr (mom dW + (X^T h0 - v^T h) / B - l2 W - pen) against
    the plain version's arithmetic (ops/cd_epoch.py), each element within
    the association's bound carried through the update; a same-input rerun
    bit for bit."""
    rng = np.random.RandomState(B + V + H)
    X, h0 = assoc_sides(B, V, H, cuda, rng, gaussian=V == 3072)
    v, h = assoc_sides(B, V, H, cuda, rng, gaussian=V == 3072)
    W = torch.as_tensor(rng.randn(V, H) * 0.05, dtype=torch.float32,
                        device=cuda)
    dW = torch.as_tensor(rng.randn(V, H) * 0.01, dtype=torch.float32,
                         device=cuda)
    pen = torch.as_tensor(rng.randn(H) * 1e-3 if sparsity else np.zeros(H),
                          dtype=torch.float32, device=cuda)
    lr, mom, l2 = 0.05, 0.9, 1e-4
    got = cd_assoc_update_launch(X, h0, v, h, pen, W, dW, lr, mom, l2)
    again = cd_assoc_update_launch(X, h0, v, h, pen, W, dW, lr, mom, l2)
    assoc = X.T @ h0 - v.T @ h
    g = assoc / B - l2 * W
    want_dw = lr * (mom * dW + g - pen)
    want = (W + want_dw, want_dw)
    torch.cuda.synchronize()
    E = assoc_bound([(X, h0), (v, h)], (1., 1.), assoc) / B
    terms = (mom * dW).abs() + (assoc / B).abs() + (l2 * W).abs() + pen.abs()
    assert_update_close(got, want, E, terms, lr)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


def cd_assoc_stats_launch(X, h0, v, h):
    from boltzmann_machines_tpu_torch.ops.cd_epoch import (
        check_launch, library, ptr)
    B, V = X.shape
    H = h0.shape[1]
    out = torch.full((V, H), float('nan'), device=X.device)
    check_launch(library().bm_cd_assoc_stats(
        ptr(X), ptr(h0), ptr(v), ptr(h), B, V, H, ptr(out),
        assoc_n_tile(V, H, X.device),
        torch.cuda.current_stream().cuda_stream), 'cd_assoc_stats')
    return out


@pytest.mark.parametrize('B,V,H', ASSOC_STATS_SHAPES)
def test_cd_assoc_stats_matches_plain_version(cuda, B, V, H):
    """X^T h0 - v^T h written as it is, each element within the bound, a
    rerun bit for bit; at k = 0 (v = X, h = h0) exactly zero."""
    rng = np.random.RandomState(B * V + H)
    X, h0 = assoc_sides(B, V, H, cuda, rng, gaussian=True)
    v, h = assoc_sides(B, V, H, cuda, rng, gaussian=False)
    got = cd_assoc_stats_launch(X, h0, v, h)
    again = cd_assoc_stats_launch(X, h0, v, h)
    zero = cd_assoc_stats_launch(X, h0, X, h0)
    want = X.T @ h0 - v.T @ h
    torch.cuda.synchronize()
    excess = (got - want).abs() - assoc_bound([(X, h0), (v, h)], (1., 1.),
                                              want)
    assert float(excess.max()) <= 0.
    assert torch.equal(got, again)
    assert not bool(zero.any())


def dbm_assoc_update_launch(Ad, Bd, Ap, Bp, pen, W, dW, lr, mom, l2):
    W, dW = W.clone(), dW.clone()
    (N, n_in), M, n_out = Ad.shape, Ap.shape[0], W.shape[1]
    dbm_ops._check(dbm_ops._library().bm_dbm_assoc_update(
        dbm_ops._ptr(Ad), dbm_ops._ptr(Bd), dbm_ops._ptr(Ap),
        dbm_ops._ptr(Bp), dbm_ops._ptr(pen), N, M, n_in, n_out,
        dbm_ops._ptr(W), dbm_ops._ptr(dW), lr, mom, l2,
        assoc_n_tile(n_in, n_out, Ad.device),
        torch.cuda.current_stream().cuda_stream), 'dbm_assoc_update')
    return W, dW


@pytest.mark.parametrize('N,M,n_in,n_out', DBM_ASSOC_SHAPES)
@pytest.mark.parametrize('sparsity', [False, True])
def test_dbm_assoc_update_matches_plain_version(cuda, N, M, n_in, n_out,
                                                sparsity):
    """W += dW = lr (mom dW + Ad^T Bd / N - Ap^T Bp / M - l2 W - pen) (the
    penalty optional) against the plain version's arithmetic
    (ops/dbm_ops.py dbm_update), within the bound; a rerun bit for bit."""
    rng = np.random.RandomState(N + M + n_in + n_out)
    Ad, Bd = assoc_sides(N, n_in, n_out, cuda, rng, gaussian=False)
    Ap, Bp = assoc_sides(M, n_in, n_out, cuda, rng, gaussian=False)
    W = torch.as_tensor(rng.randn(n_in, n_out) * 0.1, dtype=torch.float32,
                        device=cuda)
    dW = torch.as_tensor(rng.randn(n_in, n_out) * 0.01, dtype=torch.float32,
                         device=cuda)
    pen = torch.as_tensor(rng.randn(n_out) * 1e-3, dtype=torch.float32,
                          device=cuda) if sparsity else None
    lr, mom, l2 = 2e-3, 0.5, 1e-3
    got = dbm_assoc_update_launch(Ad, Bd, Ap, Bp, pen, W, dW, lr, mom, l2)
    again = dbm_assoc_update_launch(Ad, Bd, Ap, Bp, pen, W, dW, lr, mom, l2)
    assoc = (Ad.T @ Bd) / N - (Ap.T @ Bp) / M
    g = assoc - l2 * W
    if pen is not None:
        g = g - pen
    want_dw = lr * (mom * dW + g)
    want = (W + want_dw, want_dw)
    torch.cuda.synchronize()
    E = assoc_bound([(Ad, Bd), (Ap, Bp)], (1. / N, 1. / M), assoc)
    terms = (mom * dW).abs() + assoc.abs() + (l2 * W).abs()
    if pen is not None:
        terms = terms + pen.abs()
    assert_update_close(got, want, E, terms, lr)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


# ---------------------------------------------------------------------- #
# the column walks: cd_bias_stats (K2) and dbm_max_norm                   #
# ---------------------------------------------------------------------- #
def aligned_or_not(t, aligned):
    """`t` itself, or a copy of it that starts 4 bytes past a 16-byte
    boundary (the kernels' scalar path)."""
    if aligned:
        return t
    buf = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
    out = buf[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    return out


def bias_stats_launch(X, vs, vm, h0, hm, p, lr, mom, damp, cost, target):
    """One cd_bias_stats launch on copies of the parameters `p`."""
    from boltzmann_machines_tpu_torch.ops.cd_epoch import (
        check_launch, library, ptr)
    p = {k: v.clone() for k, v in p.items()}
    (B, V), H = X.shape, h0.shape[1]
    check_launch(library().bm_cd_bias_stats(
        ptr(X), ptr(vs), ptr(vm), ptr(h0), ptr(hm), B, V, H, ptr(p['vb']),
        ptr(p['dvb']), ptr(p['hb']), ptr(p['dhb']), ptr(p['q']),
        ptr(p['pen']), ptr(p['msre_col']), lr, mom, damp, 1. - damp, cost,
        target, torch.cuda.current_stream().cuda_stream), 'cd_bias_stats')
    return p


@pytest.mark.parametrize('B', [1, 10, 48, 100, 256])
@pytest.mark.parametrize('V,H', [(37, 70), (130, 65), (24, 16), *at_path(
    (784, 1024), (784, 512), (512, 1024), (3072, 5000), (5000, 1000))])
@pytest.mark.parametrize('sparsity', [False, True])
@pytest.mark.parametrize('visible', ['bernoulli', 'gaussian'])
def test_cd_bias_stats_matches_plain_version(cuda, B, V, H, sparsity,
                                             visible):
    """Every output of K2 (vb, dvb, hb, dhb, q, pen, msre_col) against the
    plain arithmetic, at every RBM path's widths (rbm_mnist's, dbm_mnist's
    two RBMs, the CIFAR G-RBM and M-RBM) and ragged ones: atol 1e-5 + rtol
    1e-5 on the updates and the penalty, atol 1e-5 B + rtol 1e-4 on q (an
    EMA of batch sums), atol 1e-5 + rtol 1e-5 on the column sums msre_col;
    a same-input rerun bit for bit."""
    rng = np.random.RandomState(B * 7 + V + H)

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=cuda)
    if visible == 'gaussian':
        X, vs, vm = (t(rng.randn(B, V)) for _ in range(3))
    else:
        X, vs = (t(rng.rand(B, V) < 0.3) for _ in range(2))
        vm = t(rng.rand(B, V))
    h0, hm = t(rng.rand(B, H)), t(rng.rand(B, H))
    p = {'vb': t(rng.randn(V) * 0.1), 'dvb': t(rng.randn(V) * 0.01),
         'hb': t(rng.randn(H) * 0.1), 'dhb': t(rng.randn(H) * 0.01),
         'q': t(rng.rand(H) * B * 0.3),
         'pen': t(np.full(H, np.nan)), 'msre_col': t(np.full(V, np.nan))}
    args = (0.05, 0.9, 0.9, 1e-2 if sparsity else 0., 0.1)
    got = bias_stats_launch(X, vs, vm, h0, hm, p, *args)
    again = bias_stats_launch(X, vs, vm, h0, hm, p, *args)
    want = bias_stats_reference(X, vs, h0, hm, p, *args, v_means=vm)
    torch.cuda.synchronize()
    for key in want:
        atol, rtol = {'q': (1e-5 * B, 1e-4)}.get(key, (1e-5, 1e-5))
        torch.testing.assert_close(got[key], want[key], rtol=rtol, atol=atol,
                                   msg=key)
        assert torch.equal(got[key], again[key]), key
    assert bool((got['pen'] != 0).any()) == sparsity


@pytest.mark.parametrize('B', [1, 10, 48, 50, 100, 128, 256])
@pytest.mark.parametrize('V,H', [*at_path((784, 1024)), (37, 70), (130, 65)])
@pytest.mark.parametrize('aligned', [True, False])
def test_cd_bias_stats_sums_are_cd_stats_sums(cuda, B, V, H, aligned):
    """K2 adds the batch in row order, as K2s (cd_stats_sums) does: at lr 1,
    momentum 0, no sparsity and damping 0 its outputs are the stats' sums
    bit for bit -- dvb = dvb_sum / B, dhb = dhb_sum / B, q = h_sum -- on
    both load paths and across its 128-row chunks (B = 256); 50 and 128 are
    the stats calls' local batches."""
    from boltzmann_machines_tpu_torch.ops.cd_epoch import (
        check_launch, library, ptr)
    rng = np.random.RandomState(B + V + H)
    ins = [torch.as_tensor(rng.randn(B, n).astype(np.float32), device=cuda)
           for n in (V, V, V, H, H)]
    X, vs, vm, h0, hm = (aligned_or_not(x, aligned) for x in ins)
    p = {key: torch.as_tensor(rng.rand(n).astype(np.float32), device=cuda)
         for key, n in (('vb', V), ('dvb', V), ('hb', H), ('dhb', H),
                        ('q', H), ('pen', H), ('msre_col', V))}
    got = bias_stats_launch(X, vs, vm, h0, hm, p, 1., 0., 0., 0., 0.1)
    sums = torch.empty(V + 2 * H, device=cuda)
    check_launch(library().bm_cd_stats_sums(
        ptr(X), ptr(vs), ptr(h0), ptr(hm), B, V, H, ptr(sums),
        ptr(sums, V), ptr(sums, V + H),
        torch.cuda.current_stream().cuda_stream), 'cd_stats_sums')
    # a tensor divisor: torch divides by a Python number through its
    # reciprocal, one rounding more than the kernel's division
    n = torch.tensor(float(B), device=cuda)
    torch.cuda.synchronize()
    assert torch.equal(got['dvb'], sums[:V] / n)
    assert torch.equal(got['dhb'], sums[V:V + H] / n)
    assert torch.equal(got['q'], sums[V + H:])


@pytest.mark.parametrize('aligned', [True, False])
def test_cd_bias_stats_scalar_path(cuda, aligned):
    """Inputs whose rows are not 16-byte aligned (widths multiples of 4,
    the buffer 4 bytes off) take the scalar path: the same outputs as the
    aligned launch on the same values, within the plain tolerance (the
    two paths group the rows differently)."""
    rng = np.random.RandomState(5)
    B, V, H = 48, 784, 512
    ins = [torch.as_tensor(rng.rand(B, n).astype(np.float32), device=cuda)
           for n in (V, V, V, H, H)]
    p = {key: torch.as_tensor(rng.rand(n).astype(np.float32), device=cuda)
         for key, n in (('vb', V), ('dvb', V), ('hb', H), ('dhb', H),
                        ('q', H), ('pen', H), ('msre_col', V))}
    args = (0.05, 0.9, 0.9, 1e-2, 0.1)
    ref = bias_stats_launch(*ins, p, *args)
    got = bias_stats_launch(*(aligned_or_not(x, aligned) for x in ins), p,
                            *args)
    torch.cuda.synchronize()
    for key in got:
        atol, rtol = {'q': (1e-5 * B, 1e-4)}.get(key, (1e-5, 1e-5))
        torch.testing.assert_close(got[key], ref[key], rtol=rtol, atol=atol,
                                   msg=key)


def stats_sums_launch(X, vs, h0, hm):
    """One cd_stats_sums launch: [dvb_sum | dhb_sum | h_sum]."""
    from boltzmann_machines_tpu_torch.ops.cd_epoch import (
        check_launch, library, ptr)
    (B, V), H = X.shape, h0.shape[1]
    sums = torch.full((V + 2 * H,), float('nan'), device=X.device)
    check_launch(library().bm_cd_stats_sums(
        ptr(X), ptr(vs), ptr(h0), ptr(hm), B, V, H, ptr(sums), ptr(sums, V),
        ptr(sums, V + H), torch.cuda.current_stream().cuda_stream),
        'cd_stats_sums')
    return sums


@pytest.mark.parametrize('B,V,H,aligned', at_path(
    (128, 784, 1024, True), (50, 3072, 7800, True), (50, 3072, 7800, False))
    + [(3, 37, 70, True), (129, 130, 65, True)])
def test_cd_stats_sums_matches_plain_version(cuda, B, V, H, aligned):
    """K2s against the plain sums of ``cd_stats_reference`` -- sum(X -
    v_states), sum(h0 - h_means), sum(h_means) over the rows -- within atol
    1e-5 x rows, rtol 1e-5 (f32 sums in another order), and a same-input
    rerun bit for bit.  The stats calls'
    local shapes (784x1024 / 128 rows, 3072x7800 / 50), the latter also 4
    bytes off a 16-byte boundary (the scalar path); ragged widths, and 129
    rows (two of K2's 128-row chunks)."""
    rng = np.random.RandomState(B + V + H)
    ins = [torch.as_tensor(f(B, n).astype(np.float32), device=cuda)
           for f, n in ((rng.randn, V), (rng.randn, V), (rng.rand, H),
                        (rng.rand, H))]
    X, vs, h0, hm = (aligned_or_not(x, aligned) for x in ins)
    got, again = stats_sums_launch(X, vs, h0, hm), stats_sums_launch(
        X, vs, h0, hm)
    want = torch.cat([torch.sum(X - vs, 0), torch.sum(h0 - hm, 0),
                      torch.sum(hm, 0)])
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * B)
    assert torch.equal(got, again)


def msre_launch(X, vm, ctrl, part, count):
    """One dbm_msre launch: (msre, n_mf) as a 2-vector."""
    out = torch.full((2,), float('nan'), device=X.device)
    dbm_ops._check(dbm_ops._library().bm_dbm_msre(
        dbm_ops._ptr(X), dbm_ops._ptr(vm), X.numel(), dbm_ops._ptr(ctrl),
        dbm_ops._ptr(part), part.numel(), dbm_ops._ptr(count),
        dbm_ops._ptr(out), dbm_ops._ptr(out) + 4,
        torch.cuda.current_stream().cuda_stream), 'dbm_msre')
    return out


@pytest.mark.parametrize('rows,cols,aligned', [
    *at_path((100, 784, True), (100, 784, False)), (1, 1, True), (3, 7, True),
    (2, 8, True), (256, 3072, True), (256, 3072, False)])
def test_dbm_msre_matches_plain_version(cuda, rows, cols, aligned):
    """mean((X - v_means)^2) against torch.mean(torch.square(X - vm)), atol
    1e-6 (the DBM epoch's msre tolerance: f32 sums in another order), and
    n_mf copied from ctrl[1].  A rerun gives the same bits and two launches
    in a row both finish (the last block re-arms the counter to 0).  The
    DBM step's 100x784, n = 1, n not a multiple of 4 (21), fewer elements
    than one block's threads (16), 256x3072 (more elements than the grid
    takes in one load a thread), and the scalar path (inputs 4 bytes off a
    16-byte boundary)."""
    rng = np.random.RandomState(rows + cols)
    X = torch.as_tensor((rng.rand(rows, cols) < 0.3).astype(np.float32),
                        device=cuda)
    vm = torch.as_tensor(rng.rand(rows, cols).astype(np.float32),
                         device=cuda)
    X, vm = aligned_or_not(X, aligned), aligned_or_not(vm, aligned)
    ctrl = torch.tensor([1, 23], dtype=torch.int32, device=cuda)
    part = torch.empty(dbm_ops.MSRE_BLOCKS, device=cuda)
    count = torch.zeros(1, dtype=torch.int32, device=cuda)
    got = msre_launch(X, vm, ctrl, part, count)
    again = msre_launch(X, vm, ctrl, part, count)
    want = torch.mean(torch.square(X - vm))
    torch.cuda.synchronize()
    assert abs(float(got[0]) - float(want)) <= 1e-6
    assert float(got[1]) == 23.
    assert torch.equal(got, again)
    assert int(count[0]) == 0


def test_dbm_msre_grid_is_capped(cuda):
    """A partials buffer smaller than the grid the elements ask for caps
    the grid (each block walks more elements): the same msre within the
    plain tolerance, and never a write past the buffer."""
    rng = np.random.RandomState(7)
    X = torch.as_tensor(rng.rand(100, 784).astype(np.float32), device=cuda)
    vm = torch.as_tensor(rng.rand(100, 784).astype(np.float32), device=cuda)
    ctrl = torch.zeros(dbm_ops.MF_CHANGE_WORD, dtype=torch.int32,
                       device=cuda)
    count = torch.zeros(1, dtype=torch.int32, device=cuda)
    buf = torch.full((6,), -7., device=cuda)
    got = msre_launch(X, vm, ctrl, buf[:3], count)
    want = torch.mean(torch.square(X - vm))
    torch.cuda.synchronize()
    assert abs(float(got[0]) - float(want)) <= 1e-6
    assert torch.equal(buf[3:], torch.full((3,), -7., device=cuda))
    assert int(count[0]) == 0


def max_norm_launch(W, max_norm):
    W = W.clone()
    dbm_ops._check(dbm_ops._library().bm_dbm_max_norm(
        dbm_ops._ptr(W), W.shape[0], W.shape[1], max_norm,
        torch.cuda.current_stream().cuda_stream), 'dbm_max_norm')
    return W


@pytest.mark.parametrize('n_in,n_out', [*at_path((784, 512), (512, 1024)),
                                        (37, 101), (130, 66), (1100, 40),
                                        (6, 5), (1, 3)])
def test_dbm_max_norm_matches_plain_version(cuda, n_in, n_out):
    """W[:, j] *= min(|w_j|, c) / max(|w_j|, 1e-8) against apply_max_norm,
    columns from 0.5 to 1.5 c (and one of zeros), atol 1e-5 + rtol 1e-5
    (the norms are sums of n_in squares in another order); a rerun bit for
    bit.  (1100, 40) has more rows than the kernel holds in registers;
    101 and 66 columns take the scalar path."""
    rng = np.random.RandomState(n_in + n_out)
    c = 2.
    scale = c * (0.5 + np.arange(n_out) / n_out) / np.sqrt(n_in)
    W = rng.randn(n_in, n_out) * scale
    W[:, n_out // 2] = 0.
    W = torch.as_tensor(W.astype(np.float32), device=cuda)
    got, again = max_norm_launch(W, c), max_norm_launch(W, c)
    want = dbm_ops.apply_max_norm(W, c)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, again)
    norms = torch.linalg.norm(got, dim=0)
    assert float(norms.max()) <= c * (1. + 1e-5)
    assert not bool(got[:, n_out // 2].any())


@pytest.mark.parametrize('aligned', [True, False])
def test_dbm_max_norm_scalar_path(cuda, aligned):
    """W 4 bytes past a 16-byte boundary (n_out a multiple of 4) takes the
    scalar path, within the plain tolerance of the aligned launch."""
    rng = np.random.RandomState(3)
    W = torch.as_tensor((rng.randn(784, 512) * 0.2).astype(np.float32),
                        device=cuda)
    ref = max_norm_launch(W, 3.)
    got = max_norm_launch(aligned_or_not(W, aligned), 3.)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


def test_dbm_max_norm_infinite_leaves_w(cuda):
    """max_norm = inf (or NaN) leaves W as it is, bit for bit, as
    apply_max_norm does."""
    W = torch.randn(784, 512, device=cuda)
    for c in (float('inf'), float('nan')):
        got = max_norm_launch(W, c)
        torch.cuda.synchronize()
        assert torch.equal(got, W)
        assert torch.equal(dbm_ops.apply_max_norm(W, c), W)


# ---------------------------------------------------------------------- #
# dbm_bias_update: every bias vector of the DBM step in one launch        #
# ---------------------------------------------------------------------- #
def bias_vectors(widths, N, M, sparse, dev, seed=0):
    """Inputs of one dbm_bias_update per width: data rows D (N, n),
    particle rows P (M, n) and the parameters; with sparsity (sparse[i]) q,
    mu and a penalty vector, and a cost and target."""
    rng = np.random.RandomState(seed)

    def t(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=dev)
    out = []
    for i, n in enumerate(widths):
        v = {'D': t(rng.rand(N, n)), 'P': t(rng.rand(M, n) < 0.3),
             'b': t(rng.randn(n) * 0.1), 'db': t(rng.randn(n) * 0.01),
             'cost': 0., 'target': 0.}
        if sparse[i]:
            v.update(q=t(rng.rand(n) * M * 0.3), mu=t(rng.rand(n) * N * 0.5),
                     pen=t(np.full(n, np.nan)), cost=1e-2 * (i + 1),
                     target=0.1 * (i + 1))
        out.append(v)
    return out


def bias_update_launch(vecs, N, M, lr, mom, damp):
    """One dbm_bias_update launch over `vecs` on copies of the parameters;
    returns them."""
    keys = ('b', 'db', 'q', 'mu', 'pen')
    vecs = [dict(v, **{k: v[k].clone() for k in keys if k in v})
            for v in vecs]
    arr = (dbm_ops.BiasVec * len(vecs))(*[dbm_ops.BiasVec(
        *(dbm_ops._ptr(v.get(k)) for k in ('D', 'P', 'b', 'db', 'q', 'mu',
                                           'pen')),
        v['b'].numel(), v['cost'], v['target']) for v in vecs])
    one_minus = float(1. - torch.tensor(damp, dtype=torch.float32))
    dbm_ops._check(dbm_ops._library().bm_dbm_bias_update(
        arr, len(vecs), N, M, lr, mom, damp, one_minus,
        torch.cuda.current_stream().cuda_stream), 'dbm_bias_update')
    return [{k: v[k] for k in keys if k in v} for v in vecs]


def bias_update_plain(v, N, M, lr, mom, damp):
    """dbm_update's arithmetic for one bias vector."""
    sd, sp = v['D'].sum(0), v['P'].sum(0)
    grad = sd / N - sp / M
    out = {}
    if 'q' in v:
        d = torch.tensor(damp, dtype=torch.float32)
        out['q'] = d * v['q'] + (1. - d) * sp
        out['mu'] = d * v['mu'] + (1. - d) * sd
        out['pen'] = v['cost'] * (out['q'] - v['target']) + \
            v['cost'] * (out['mu'] - v['target'])
        grad = grad - out['pen']
    out['db'] = lr * (mom * v['db'] + grad)
    out['b'] = v['b'] + out['db']
    return out


# (widths, N, M, sparsity per vector): the DBM step's three vectors at
# 784-512-1024; vb alone and hb with sparsity alone, ragged (no multiple of
# 4 or 32) with N != M; more rows than one staged chunk (128); a DBM of 7
# layers (8 vectors, the most of one launch)
BIAS_CASES = [*at_path(((784, 512, 1024), 100, 100, (False, True, True))),
              ((37,), 7, 10, (False,)), ((70,), 50, 100, (True,)),
              ((130, 65, 33), 129, 300, (False, True, True)),
              ((5, 3, 9, 2, 31, 64, 1, 40), 3, 2, (False,) + (True,) * 7)]


@pytest.mark.parametrize('widths,N,M,sparse', BIAS_CASES)
def test_dbm_bias_update_matches_plain_version(cuda, widths, N, M, sparse):
    """Every output (b, db, and with sparsity q, mu and the penalty) against
    the plain arithmetic with the DBM epoch's tolerances: atol 1e-5 +
    rtol 1e-5 on b, db and the penalty, atol 1e-5 (N + M) + rtol 1e-4 on q
    and mu (EMAs of batch sums); a same-input rerun bit for bit, and each
    vector launched alone equal to it in the launch of all, bit for bit."""
    vecs = bias_vectors(widths, N, M, sparse, cuda, seed=N + M)
    args = (N, M, 0.05, 0.5, 0.9)
    got = bias_update_launch(vecs, *args)
    again = bias_update_launch(vecs, *args)
    alone = [bias_update_launch([v], *args)[0] for v in vecs]
    torch.cuda.synchronize()
    for i, v in enumerate(vecs):
        want = bias_update_plain(v, *args)
        for key in want:
            atol, rtol = (1e-5 * (N + M), 1e-4) if key in ('q', 'mu') \
                else (1e-5, 1e-5)
            torch.testing.assert_close(got[i][key], want[key], rtol=rtol,
                                       atol=atol, msg='%d %s' % (i, key))
            assert torch.equal(got[i][key], again[i][key]), (i, key)
            assert torch.equal(got[i][key], alone[i][key]), (i, key)


@pytest.mark.parametrize('aligned', [True, False])
def test_dbm_bias_update_scalar_path(cuda, aligned):
    """D and P 4 bytes past a 16-byte boundary (widths multiples of 4) take
    the scalar path: its sums are added in the same row order, so its
    outputs equal the aligned launch's bit for bit."""
    vecs = bias_vectors((784, 512), 100, 100, (False, True), cuda, seed=3)
    args = (100, 100, 0.05, 0.5, 0.9)
    ref = bias_update_launch(vecs, *args)
    moved = [dict(v, D=aligned_or_not(v['D'], aligned),
                  P=aligned_or_not(v['P'], aligned)) for v in vecs]
    got = bias_update_launch(moved, *args)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        for key in a:
            assert torch.equal(a[key], b[key]), key


def test_dbm_bias_update_sums_in_row_order(cuda):
    """At lr 1, momentum 0 and no sparsity db is sum D / N - sum P / M
    exactly, and each column sum is the one of adding the rows in order
    (float32 np.cumsum), on both load paths."""
    N, M = 100, 150
    for n in (784, 37):
        v = bias_vectors((n,), N, M, (False,), cuda, seed=n)[0]
        got = bias_update_launch([v], N, M, 1., 0., 0.9)[0]
        torch.cuda.synchronize()
        sd = np.cumsum(v['D'].cpu().numpy(), 0, dtype=np.float32)[-1]
        sp = np.cumsum(v['P'].cpu().numpy(), 0, dtype=np.float32)[-1]
        want = sd / np.float32(N) - sp / np.float32(M)
        assert np.array_equal(got['db'].cpu().numpy(), want), n



# ---------------------------------------------------------------------- #
# the CIFAR pipelines: the CD kernels at examples/torch_dbm_cifar.py's    #
# new shapes, and the Gaussian-Bernoulli-Multinomial DBM                   #
# ---------------------------------------------------------------------- #
# (V, H, B, flavour config): the 26 small patch RBMs (Gaussian, sigma 1,
# dbm_first, batch 48) and the M-RBM 7800 -> 512 (n_samples 512, dbm_last,
# both layers sampled), examples/dbm_cifar.py:135-152 and :305-321; its
# G-RBM 3072 -> 7800 (:266); and examples/dbm_cifar_naive.py's G-RBM
# 3072 -> 5000 (a per-unit sigma of ones, dbm_first) and M-RBM 5000 -> 1000
# (n_samples 1000, dbm_last), :103-163, all at batch 100
CIFAR_RBM_SHAPES = [
    (192, 300, 48, dict(visible='gaussian', sigma=np.float32(1.)), (2., 1.)),
    (7800, 512, 100, dict(hidden='multinomial', n_samples=512), (1., 2.)),
    (3072, 7800, 100, dict(visible='gaussian', sigma=np.float32(1.)),
     (2., 1.)),
    (3072, 5000, 100, dict(visible='gaussian',
                           sigma=np.ones(3072, np.float32)), (2., 1.)),
]
# each shape sampled and not; the M-RBM 5000 -> 1000 with sampling off
# only: its 1e5 draws a pass move a few across the CDF's bucket edges
# every step (the means' rounding, trap C14), more than this test's one
# tolerance lets pass, so test_cd_epoch_sampled_steps_at_cifar_widths holds
# its sampled steps and test_gibbs_pass_states_match_plain_version its
# draws pass by pass
CIFAR_RBM_CASES = at_path(*[shape + (sample,) for shape in CIFAR_RBM_SHAPES
                            for sample in (False, True)], (
    5000, 1000, 100, dict(hidden='multinomial', n_samples=1000), (1., 2.),
    False))


@pytest.mark.parametrize('V,H,B,kw,mult,sample', CIFAR_RBM_CASES)
def test_cd_kernels_at_cifar_rbm_shapes(cuda, V, H, B, kw, mult, sample):
    """Sampling off, over 3 steps: the state within the flavour tests'
    tolerances, msre within atol 1e-6, rtol 1e-5 (a Gaussian msre is ~1),
    l2 within rtol 1e-5, the PLL within atol 1 + rtol 1e-3 (V x the
    difference of two batch-mean free energies of up to ~1e3, each a sum of
    V + H terms in another order); every metric row written (msre and l2
    above 0, the PLL below).  Sampling on, each step from the same state:
    all but one of 4 steps within rtol 1e-4, atol 1e-4 (x B for q_means) --
    a multinomial draw moves across a CDF boundary now and then (the means'
    rounding, trap C14)."""
    rng = np.random.RandomState(V)
    X = torch.as_tensor(rng.randn(4, B, V) if 'sigma' in kw
                        else rng.rand(4, B, V), dtype=torch.float32,
                        device=cuda)
    _, state = make_inputs(V, H, B, 1, cuda, seed=2)
    state['W'] = state['W'] * 0.1
    cfg = CDEpochConfig(V, H, 1, sample, sample, mult[0], mult[1], 1e-3,
                        0.1, 1e-3, 0.9, 1, True, **kw)
    if not sample:
        got = cd_epoch(cfg, state, X[:3], 1e-3, 0.9, 3, 0)
        want = cd_epoch_reference(cfg, state, X[:3], 1e-3, 0.9, 3, 0)
        torch.cuda.synchronize()
        for key in got[0]:
            atol = 1e-5 * (B if key == 'q_means' else 1)
            torch.testing.assert_close(got[0][key], want[0][key], rtol=1e-5,
                                       atol=atol, msg=key)
        torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(got[2], want[2], rtol=1e-3, atol=1.)
        torch.testing.assert_close(got[3], want[3], rtol=1e-5, atol=0)
        assert float(got[1].min()) > 0 and float(got[3].min()) > 0
        assert float(got[2].max()) < 0
        return
    bad = 0
    for i in range(4):
        got = cd_epoch(cfg, state, X[i:i + 1], 1e-3, 0.9, 17, i)
        want = cd_epoch_reference(cfg, state, X[i:i + 1], 1e-3, 0.9, 17, i)
        bad += not all(torch.allclose(
            got[0][key], want[0][key], rtol=1e-4,
            atol=1e-4 * (B if key == 'q_means' else 1)) for key in got[0])
        state = got[0]
    assert bad <= 1


# (atol, rtol) of a CD step's state and metric rows, kernel against plain,
# on the same inputs (the tests above; q_means' atol is a row's); where
# draws moved, the parameters stay there (lr <= 5e-4 scales a moved draw
# far below it), while a moved draw changes a row's chain means by a few
# per cent, so msre and q_means (a sum over 100 rows) by <= 1e-2 relative
SAMPLED_TOL = {'state': (1e-5, 1e-5), 'q_means': (1e-5, 1e-2),
               'msre': (1e-6, 1e-2), 'pll': (1., 1e-3), 'l2': (0., 1e-5)}


def step_within(got, want, B, tols):
    """Whether a CD step's state and metric rows are within `tols`."""
    pairs = [(key, got[0][key], want[0][key]) for key in got[0]]
    pairs += zip(('msre', 'pll', 'l2'), got[1:], want[1:])
    return all(torch.allclose(a, b, rtol=tols.get(key, tols['state'])[1],
                              atol=tols.get(key, tols['state'])[0]
                              * (B if key == 'q_means' else 1))
               for key, a, b in pairs)


# (V, H, lr, W_init, the config from sample_v_states on):
# examples/dbm_cifar_naive.py's G-RBM (Gaussian, sigma 1, dbm_first) and
# M-RBM (n_samples 1000, hidden states sampled, dbm_last), :103-163
CIFAR_SAMPLED_CASES = at_path(
    (3072, 5000, 5e-4, 8e-4, (True, True, 2., 1., 0.01, 0.1, 0., 0.9, 1,
                              True, 'gaussian', np.ones(3072, np.float32))),
    (5000, 1000, 1e-4, 0.01, (False, True, 1., 2., 0.05, 0.1, 0., 0.9, 1,
                              True, 'bernoulli', None, 'multinomial',
                              1000)))


@pytest.mark.parametrize('V,H,lr,w_init,args', CIFAR_SAMPLED_CASES)
def test_cd_epoch_sampled_steps_at_cifar_widths(cuda, V, H, lr, w_init,
                                                args):
    """Sampled, B 100, 20 steps, each from the kernel's state: the draws
    agree but where a uniform lies within rounding of its threshold or CDF
    entry (a multinomial draw of an M-RBM pass's 1e5 moves with odds
    ~5e-5), so each step is within SAMPLED_TOL.  A probe step (lr 1,
    momentum 0, no metrics) counts the moved draws: dvb = mean(X -
    v_states) moves by <= max|W| sigma / B a draw, within 20 of them."""
    B = 100
    rng = np.random.RandomState(V)
    X = torch.as_tensor(rng.randn(20, B, V) if args[10] == 'gaussian'
                        else rng.rand(20, B, V), dtype=torch.float32,
                        device=cuda)
    state = {key: torch.zeros(shape, device=cuda) for key, shape in (
        ('vb', V), ('hb', H), ('dW', (V, H)), ('dvb', V), ('dhb', H),
        ('q_means', H))}
    state['W'] = torch.as_tensor(rng.randn(V, H) * w_init,
                                 dtype=torch.float32, device=cuda)
    cfg = CDEpochConfig(V, H, 1, *args)
    probe = cfg._replace(metrics_every=10 ** 6)
    for i in range(20):
        got = cd_epoch(cfg, state, X[i:i + 1], lr, 0.9, 11, i)
        want = cd_epoch_reference(cfg, state, X[i:i + 1], lr, 0.9, 11, i)
        assert step_within(got, want, B, SAMPLED_TOL), i
        pg = cd_epoch(probe, state, X[i:i + 1], 1., 0., 13, i)[0]
        pw = cd_epoch_reference(probe, state, X[i:i + 1], 1., 0., 13, i)[0]
        # sigma 1, and no Bernoulli visible draw (which would move 1 / B)
        per_draw = float(state['W'].abs().max()) / B
        assert float((pg['dvb'] - pw['dvb']).abs().max()) <= 20 * per_draw, i
        state = got[0]


def gbm_setup(dev, sizes=(24, 16, 12), B=8, M=8, NB=3, n=7, seed=0):
    """A Gaussian (per-unit sigma) - Bernoulli - multinomial (n) DBM: its
    layers, a random state with count particles, standardized batches."""
    from boltzmann_machines_tpu_torch import (BernoulliLayer, GaussianLayer,
                                              MultinomialLayer)
    V, H1, H2 = sizes
    rng = np.random.RandomState(seed)
    units = (GaussianLayer(V, sigma=(rng.rand(V) + 0.5).astype(np.float32)),
             BernoulliLayer(H1), MultinomialLayer(H2, n_samples=n))
    _, state = make_dbm_inputs(sizes, B, M, 1, dev, seed=seed)
    state['v'] = torch.as_tensor(rng.randn(M, V), dtype=torch.float32,
                                 device=dev)
    p = rng.dirichlet(np.ones(H2), size=M)
    state['H'] = (state['H'][0], torch.as_tensor(
        n * p, dtype=torch.float32, device=dev))
    X = torch.as_tensor(rng.randn(NB, B, V), dtype=torch.float32, device=dev)
    return units, state, X


def gbm_config(sizes, units, sample, k=1, max_mf=20, tol=1e-7):
    return dbm_ops.DBMEpochConfig(
        tuple(sizes), k, max_mf, tol, sample, (sample, sample), 1e-4, 2.,
        (0.2, 0.2), (1e-2, 1e-3), 0.9, units)


def gbm_launches(NB, turns, k=1, max_norm=True):
    """The DBM kernels' launches of NB steps of a G-B-M DBM (L = 2, the top
    layer multinomial) whose mean-field graphs ran `turns` turns."""
    L = 2
    want = {'dbm_gemm_act': NB * (1 + L + k * (L + 1) + 1),
            'dbm_softmax': NB * (1 + k), 'dbm_bias_update': NB,
            'dbm_assoc_update': NB * L,
            'dbm_max_norm': NB * L if max_norm else 0, 'dbm_msre': NB}
    for name, n in dbm_ops.mf_graph_launches(turns, L, 1).items():
        want[name] = want.get(name, 0) + n
    return want


def test_gbm_dbm_epoch_card_matches_cpu_sampling_off(cuda):
    """Sampling off, the DBM kernels on the card (the Gaussian epilogue,
    the multinomial layer's dbm_softmax rows, the mean-field graph)
    against the plain version on the CPU: the DBM state tolerances (the
    EMAs are batch sums, of counts up to n for the multinomial layer),
    msre atol 1e-5, n_mf within one sweep; the DBM kernels' launches as
    the schedule implies."""
    units, state, X = gbm_setup(cuda)
    cfg = gbm_config((24, 16, 12), units, False)
    dbm_ops.reset_launches()
    got = dbm_ops.dbm_epoch(cfg, state, X, 0.05, 0.5, 3, 10)
    cpu = {k: (tuple(t.cpu() for t in v) if isinstance(v, tuple)
               else v.cpu()) for k, v in state.items()}
    want = dbm_ops.dbm_epoch_reference(cfg, cpu, X.cpu(), 0.05, 0.5, 3, 10)
    assert dbm_ops.dbm_epoch.launches == gbm_launches(
        3, dbm_ops.dbm_epoch.launches['dbm_mf_check'])
    got_cpu = {k: (tuple(t.cpu() for t in v) if isinstance(v, tuple)
                   else v.cpu()) for k, v in got[0].items()}
    assert_dbm_state_close(got_cpu, want[0], 8, 8 * 7, atol=1e-5)
    torch.testing.assert_close(got[1].cpu(), want[1], rtol=1e-5, atol=1e-5)
    assert float((got[2].cpu() - want[2]).abs().max()) <= 1.


def test_gbm_dbm_sampler_kernels_match_reference_draws(cuda):
    """Sampling on: the DBM kernels against the plain version, both on the
    card, each step from the same state, both drawing the same Philox
    numbers: no standalone sampler launched; the Bernoulli and
    multinomial states equal (the means agree to rounding, far from any
    uniform or bucket edge at these few draws), the Gaussian ones within
    the means' rounding and the Box-Muller's 4e-6 (1 + |v|) sigma, so the
    state within rtol 1e-4."""
    from boltzmann_machines_tpu_torch.ops import samplers
    units, state, X = gbm_setup(cuda, NB=4, seed=1)
    cfg = gbm_config((24, 16, 12), units, True, k=2)
    for i in range(4):
        samplers.reset_launches()
        got = dbm_ops.dbm_epoch(cfg, state, X[i:i + 1], 0.05, 0.5, 5, i)
        assert not any(getattr(samplers, name).launches[name]
                       for name in dbm_ops.SAMPLER_KERNELS)
        want = dbm_ops.dbm_epoch_reference(cfg, state, X[i:i + 1], 0.05, 0.5,
                                           5, i)
        torch.cuda.synchronize()
        assert torch.equal(got[0]['H'][0], want[0]['H'][0])
        assert torch.equal(got[0]['H'][1], want[0]['H'][1])
        assert bool((got[0]['H'][1].sum(1) == 7).all())
        assert float(((got[0]['v'] - want[0]['v']).abs()
                      / (1. + want[0]['v'].abs())).max()) <= 1e-5
        assert_dbm_state_close(got[0], want[0], 8, 8 * 7, atol=1e-4)
        state = got[0]


#: examples/dbm_cifar_naive.py's DBM stage: 3072-5000-1000, n 1000, B = M
#: = 100, k 1, 50 sweeps at mf_tol 1e-11, l2 1e-8, max_norm 4, the first
#: lr and momentum of its schedules
GBM_PATH = ((3072, 5000, 1000), 1000, 100, 8e-5)
#: the tolerances of chip_smoke.py's GBM_TOL: state atol, rtol; msre atol,
#: rtol; n_mf (mf_tol 1e-11 lies below every unit's f32 rounding, so two
#: sum orders may stop a sweep apart)
GBM_TOL = {'state': (1e-5, 1e-4), 'msre': (1e-6, 1e-5), 'n_mf': 1}


def gbm_path_inputs(dev, nb, seed):
    """Standardized Gaussian rows of 3072 columns and a G-B-M state at
    GBM_PATH: W0 and W1 of the published scales, zero biases, particles
    from rows, uniform h0 means and count vectors of the top layer."""
    from boltzmann_machines_tpu_torch import (BernoulliLayer, GaussianLayer,
                                              MultinomialLayer)
    (V, H1, H2), n, B, _ = GBM_PATH
    rng = np.random.RandomState(seed)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)
    z = [torch.zeros(h, device=dev) for h in (H1, H2)]
    p = rng.dirichlet(np.ones(H2), size=B)
    state = {'vb': torch.zeros(V, device=dev), 'hb': tuple(z),
             'W': (t(8e-4 * rng.randn(V, H1)), t(0.01 * rng.randn(H1, H2))),
             'dvb': torch.zeros(V, device=dev), 'dhb': tuple(z),
             'dW': (torch.zeros((V, H1), device=dev),
                    torch.zeros((H1, H2), device=dev)),
             'q_means': tuple(z), 'mu_means': tuple(z),
             'v': t(rng.randn(B, V)), 'H': (t(rng.rand(B, H1)), t(n * p))}
    units = (GaussianLayer(V, sigma=1.), BernoulliLayer(H1),
             MultinomialLayer(H2, n_samples=n))
    return units, state, t(rng.randn(nb, B, V))


def gbm_path_config(units, sample):
    sizes, _, _, _ = GBM_PATH
    return dbm_ops.DBMEpochConfig(sizes, 1, 50, 1e-11, sample,
                                  (sample, sample), 1e-8, 4., (0.1, 0.1),
                                  (0., 0.), 0.9, units)


def gbm_step_exact(got, want):
    """Whether two epoch results agree within GBM_TOL: the EMAs' atol
    scaled by (B + M) n, the batch sums of counts."""
    _, n, B, _ = GBM_PATH
    for key in dbm_ops.STATE_KEYS:
        a, b = got[0][key], want[0][key]
        atol, rtol = GBM_TOL['state']
        if key in ('q_means', 'mu_means'):
            atol *= 2 * B * n
        for x, y in zip(a, b) if isinstance(b, tuple) else [(a, b)]:
            if not torch.allclose(x, y, rtol=rtol, atol=atol):
                return False
    atol, rtol = GBM_TOL['msre']
    return (torch.allclose(got[1], want[1], rtol=rtol, atol=atol) and
            float((got[2] - want[2]).abs().max()) <= GBM_TOL['n_mf'])


@PATH
def test_gbm_dbm_epoch_kernels_match_plain_version_at_path_width(cuda):
    """examples/dbm_cifar_naive.py's DBM step on the DBM kernels, sampling
    off, two steps against the plain version on the card, every field
    within GBM_TOL; the DBM kernels' launches as the schedule implies."""
    units, state, X = gbm_path_inputs(cuda, 2, 5)
    cfg = gbm_path_config(units, False)
    lr = GBM_PATH[3]
    dbm_ops.reset_launches()
    got = dbm_ops.dbm_epoch(cfg, state, X, lr, 0.5, 7, 0)
    want = dbm_ops.dbm_epoch_reference(cfg, state, X, lr, 0.5, 7, 0)
    torch.cuda.synchronize()
    assert dbm_ops.dbm_epoch.launches == gbm_launches(
        2, dbm_ops.dbm_epoch.launches['dbm_mf_check'])
    assert gbm_step_exact(got, want)
    assert 1 <= float(got[2].min())


@PATH
def test_gbm_dbm_epoch_sampled_steps_at_path_width(cuda):
    """examples/dbm_cifar_naive.py's DBM step, sampling on: the kernels
    and the plain version draw the same Philox numbers, and a state
    differs only where a mean lies within rounding of its uniform or a
    uniform within rounding of a bucket's edge, after which the chains
    part.  So each of 20 steps starts both from the kernel's state: at
    least 15 of 20 within GBM_TOL (``gbm_step_exact``), dW of the others
    within 4 lr / M times the largest state a flip moves (|v|, a count)."""
    units, state, X = gbm_path_inputs(cuda, 20, 6)
    cfg = gbm_path_config(units, True)
    _, n, M, lr = GBM_PATH
    exact = 0
    for i in range(20):
        got = dbm_ops.dbm_epoch(cfg, state, X[i:i + 1], lr, 0.5, 13, i)
        want = dbm_ops.dbm_epoch_reference(cfg, state, X[i:i + 1], lr, 0.5,
                                           13, i)
        assert bool((got[0]['H'][1].sum(1) == n).all())
        if gbm_step_exact(got, want):
            exact += 1
        else:
            big = max(1., float(got[0]['v'].abs().max()),
                      float(got[0]['H'][1].max()))
            d_dw = max(float((a - b).abs().max())
                       for a, b in zip(got[0]['dW'], want[0]['dW']))
            assert d_dw <= 4 * lr / M * big + 1e-5, (i, d_dw)
        state = got[0]
    assert exact >= 15


def softmax_launch(pre, out, n, sample=False, ctrl=None, delta=None):
    """One bm_dbm_softmax launch on `pre`'s rows into `out`, drawn under
    (9, 4, stream 2) where `sample`."""
    import ctypes
    a = dbm_ops._softmax_args(pre, out, n)
    a.sample, a.seed, a.it, a.stream_id = int(sample), 9, 4, 2
    if ctrl is not None:
        a.mf = ctrl.data_ptr()
    if delta is not None:
        a.delta_bits = delta.data_ptr()
    dbm_ops._check(dbm_ops._library().bm_dbm_softmax(
        ctypes.byref(a), torch.cuda.current_stream().cuda_stream),
        'dbm_softmax')


@pytest.mark.parametrize('H,n,rows', [(5, 3, 7), (1500, 1000, 37),
                                      (7800, 513, 5),
                                      *at_path((1000, 1000, 100),
                                               (512, 512, 100))])
def test_dbm_softmax_matches_plain_version(cuda, H, n, rows):
    """A DBM's multinomial layer: the means within 1e-5 of n softmax(pre)
    and the change (max |new - old|, folded into its word) that of the
    kernel's own means; the counts drawn equal to ``multinomial_counts``
    on the kernel's own means (both build the CDF in float64), every row
    summing to n; a stopped mean-field (a control word's stop set) leaves
    the rows as they are; reruns bit for bit.  H = 5 is below a warp, 1500
    not a multiple of the block's 512 threads, 7800 the widest path's (62
    KB of dynamic shared memory); 1000 and 512 the top layers of
    dbm_cifar_naive.py and dbm_cifar.py at 100 rows."""
    from boltzmann_machines_tpu_torch.ops.philox import multinomial_counts
    rng = np.random.RandomState(H + rows)
    pre = torch.as_tensor(2. * rng.randn(rows, H), dtype=torch.float32,
                          device=cuda)
    old = torch.as_tensor(n * rng.dirichlet(np.ones(H), size=rows),
                          dtype=torch.float32, device=cuda)
    runs = []
    for _ in range(2):
        means, delta = old.clone(), torch.zeros(1, dtype=torch.int32,
                                                device=cuda)
        softmax_launch(pre, means, n, delta=delta)
        counts = torch.full((rows, H), float('nan'), device=cuda)
        softmax_launch(pre, counts, n, sample=True)
        runs.append((means, delta, counts))
    stopped = old.clone()
    ctrl = torch.zeros(dbm_ops.MF_CHANGE_WORD + 2, dtype=torch.int32,
                       device=cuda)
    ctrl[0] = 1
    softmax_launch(pre, stopped, n, ctrl=ctrl, delta=ctrl[2:3])
    (means, delta, counts), again = runs
    want = float(n) * torch.softmax(pre, dim=1)
    torch.cuda.synchronize()
    torch.testing.assert_close(means, want, rtol=1e-5, atol=1e-5)
    assert float(delta.view(torch.float32)) == \
        float((means - old).abs().max())
    assert torch.equal(counts, multinomial_counts(means, n, 9, 4, 2))
    assert bool((counts.sum(1) == n).all())
    assert torch.equal(stopped, old) and int(ctrl[2]) == 0
    for a, b in zip(runs[0], again):
        assert torch.equal(a, b)


@pytest.mark.parametrize('M,K,N', [(8, 16, 24), (13, 37, 70),
                                   *at_path((100, 5000, 3072),
                                            (100, 7800, 3072))])
@pytest.mark.parametrize('sample', [False, True], ids=['means', 'sampled'])
def test_dbm_gemm_act_gaussian_epilogue(cuda, M, K, N, sample):
    """A Gaussian visible layer's launch (sigma given: the kernel's
    Gaussian instance): the means h.W^T sigma + vb, raw, within 1e-5 of
    the plain version's, and the states means + sigma eps with eps
    ``philox.normal`` of the launch's key, within the means' rounding and
    Box-Muller's ulps, 4e-6 (1 + |v|) sigma; a per-unit sigma; reruns bit
    for bit."""
    import ctypes
    from boltzmann_machines_tpu_torch.ops.philox import normal
    rng = np.random.RandomState(M + K + N)
    h = torch.as_tensor(rng.rand(M, K) < 0.5, dtype=torch.float32,
                        device=cuda)
    W = torch.as_tensor(0.01 * rng.randn(N, K), dtype=torch.float32,
                        device=cuda)
    vb = torch.as_tensor(0.1 * rng.randn(N), dtype=torch.float32,
                         device=cuda)
    sigma = torch.as_tensor(rng.rand(N) + 0.5, dtype=torch.float32,
                            device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    outs = []
    for _ in range(2):
        out = torch.full((M, N), float('nan'), device=cuda)
        a = dbm_ops._gemm_args(out, [(h, W, True)], bias=vb, stream=stream)
        a.sigma = sigma.data_ptr()
        a.sample, a.seed, a.it, a.stream_id = int(sample), 9, 4, 2
        dbm_ops._check(dbm_ops._library().bm_dbm_gemm_act(
            ctypes.byref(a), stream), 'dbm_gemm_act')
        outs.append(out)
    means = (h @ W.T) * sigma + vb
    want = means + normal(9, 4, 2, (M, N), cuda) * sigma if sample \
        else means
    torch.cuda.synchronize()
    if sample:
        err = ((outs[0] - want).abs() / (1. + want.abs())) / sigma
        assert float(err.max()) <= 4e-6 + 1e-5
    else:
        torch.testing.assert_close(outs[0], want, rtol=1e-5, atol=1e-5)
    assert torch.equal(outs[0], outs[1])


def test_dbm_mf_graph_refuses_bad_softmax_rows(cuda):
    """A multinomial layer of the mean-field graph is an identity launch
    into its row node's pre-activations: a row node after a layer that
    folds its change, one whose pre-activations are not the layer's
    output or whose shape differs, and a Gaussian layer are refused."""
    import ctypes
    stream = torch.cuda.current_stream().cuda_stream
    lib = dbm_ops._library()
    pre, mu = torch.zeros((8, 16), device=cuda), torch.zeros((8, 16),
                                                             device=cuda)
    ctrl = mf_ctrl(dbm_ops.MF_BODY_SWEEPS, 0, cuda)
    a = dbm_ops._gemm_args(pre, [(torch.rand((8, 24), device=cuda),
                                  torch.rand((24, 16), device=cuda), False)],
                           act=dbm_ops.ACT_IDENTITY, stream=stream)
    rows = (dbm_ops.SoftmaxArgs * 1)(dbm_ops._softmax_args(pre, mu, 5))

    def create():
        graph = ctypes.c_void_p()
        err = lib.bm_dbm_mf_graph_create(
            ctypes.byref(a), 1, ctrl.data_ptr(), 0., 3,
            dbm_ops.MF_BODY_SWEEPS, rows, ctypes.byref(graph))
        if not err:
            lib.bm_dbm_mf_graph_destroy(graph)
        return err
    assert create() == 0
    rows[0].pre = mu.data_ptr()
    assert create() != 0
    rows[0].pre, rows[0].H = pre.data_ptr(), 15
    assert create() != 0
    rows[0].H = 16
    a.act = dbm_ops.ACT_SIGMOID_DELTA
    assert create() != 0
    a.act, a.sigma = dbm_ops.ACT_IDENTITY, pre.data_ptr()
    assert create() != 0


def test_gbm_dbm_sample_launches_the_samplers(cuda):
    """sample_v's sweeps: one launch of each sampler a sampled sweep, none
    of the DBM kernels; the visible means against the plain version's."""
    from boltzmann_machines_tpu_torch.ops import samplers
    units, state, _ = gbm_setup(cuda, seed=2)
    cfg = dbm_ops.DBMSampleConfig((24, 16, 12), True, (True, True), units)
    samplers.reset_launches()
    dbm_ops.reset_launches()
    got = dbm_ops.dbm_sample(cfg, state, 3, 21)
    want = dbm_ops.dbm_sample_reference(cfg, state, 3, 21)
    torch.cuda.synchronize()
    assert samplers.normal_sample.launches['normal_sample'] == 3
    assert samplers.bernoulli_sample.launches['bernoulli_sample'] == 3
    assert samplers.multinomial_sample.launches['multinomial_sample'] == 3
    assert not any(dbm_ops.dbm_sample.launches.values())
    torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=1e-4)
