"""The tensor-core GEMM tile's host side (boltzmann_machines_tpu_torch/ops/
gemm.py) and its arithmetic, on the CPU:

* the split-K plan of ``cd_gemm_act`` / ``dbm_gemm_act``: every slice
  non-empty, the slices covering [0, K) of every product exactly once, the
  block count within the card, the workspace the plan's size, the same plan
  on every call;
* a numpy emulation of the 3xTF32 products (tf32 rounding by bit masks, the
  hi / lo split, the three partial products in f32) against the float64
  product, within the card tests' bound (per element, 2^-22 (gemm.ERR_SUM
  |A|.|W| + |A.W|)), where plain TF32 is not (ROADMAP Queue C8); and an
  emulation of the tile's accumulation (each wgmma's sum truncated to f32):
  each 32-deep stage apart, as the tile does, within the bound, one
  accumulator for a whole K of 784-5000 not.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_gemm.py -q

The kernels themselves run only on the card (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

from boltzmann_machines_tpu_torch.ops import gemm

N_SM = 132  # an H100 SXM

# (M batch rows, N output columns, K depths): every product the paths
# launch -- rbm_mnist's CD step, the stats call at 128 rows, the G-RBM and
# M-RBM steps, the 3072 x 7800 stats call, the DBM / sample_v / AIS products
# (one with two products, 784 + 1024) -- in both directions
PATH_SHAPES = [
    (10, 1024, (784,)), (10, 784, (1024,)), (128, 1024, (784,)),
    (128, 784, (1024,)), (256, 1024, (784,)), (100, 5000, (3072,)),
    (100, 3072, (5000,)), (100, 1000, (5000,)), (100, 5000, (1000,)),
    (50, 7800, (3072,)), (50, 3072, (7800,)), (100, 512, (784,)),
    (100, 1024, (512,)), (100, 784, (512,)), (100, 512, (784, 1024)),
    (100, 512, ()),
]
RAGGED_M = (1, 3, 10, 67, 100, 256)
RAGGED_N = (16, 65, 784, 7800)
RAGGED_K = (8, 24, 784, 1808, 5000)


def slice_tiles(plan):
    """[(first, end)) k-tile ranges of the plan's slices over the k-tiles of
    all its products, in the kernel's arithmetic (csrc/gemm_tc.cuh,
    tile_product): slice s takes [s T / S, (s + 1) T / S)."""
    T, S = plan.k_tiles, plan.splits
    return [(s * T // S, (s + 1) * T // S) for s in range(S)]


def slice_ranges(plan, ks):
    """Per slice, the element ranges [(product, k0, k1)] it covers: product
    i's k-tiles come after those of products 0..i-1, and a k-tile covers
    [32 j, min(32 (j + 1), K_i)) of its product."""
    bounds, start = [], 0
    for i, k in enumerate(ks):
        n = -(-k // gemm.TILE_K)
        bounds.append((i, start, start + n, k))
        start += n
    out = []
    for first, end in slice_tiles(plan):
        parts = []
        for i, t0, t1, k in bounds:
            a, b = max(first, t0), min(end, t1)
            if a < b:
                parts.append((i, (a - t0) * gemm.TILE_K,
                              min((b - t0) * gemm.TILE_K, k)))
        out.append(parts)
    return out



def check_plan(M, N, ks, n_sm=N_SM):
    plan = gemm.gemm_plan(M, N, ks, n_sm)
    assert plan == gemm.gemm_plan(M, N, list(ks), n_sm)  # the same plan
    assert plan.n_tile in gemm.N_TILES
    # batch tiles of at most 128 rows, each within one wgmma width
    assert plan.batch_tiles * plan.n_tile >= M
    assert (plan.batch_tiles - 1) * plan.n_tile < M
    assert plan.model_tiles * gemm.TILE_M >= N > (plan.model_tiles - 1) * \
        gemm.TILE_M
    assert plan.tiles == plan.batch_tiles * plan.model_tiles
    assert plan.k_tiles == sum(-(-k // gemm.TILE_K) for k in ks)
    # one wave of one block per SM, split only where the tiles leave at
    # least half of the SMs idle, at least two k-tiles per slice
    blocks = plan.tiles * plan.splits
    if plan.splits > 1:
        assert blocks <= n_sm and 2 * plan.tiles <= n_sm
        assert plan.splits <= plan.k_tiles // 2
        assert blocks > n_sm - plan.tiles or \
            plan.splits == plan.k_tiles // 2
    else:
        assert 2 * plan.tiles > n_sm or plan.k_tiles < 4
    assert plan.workspace == (plan.tiles * plan.splits * gemm.TILE_M *
                              plan.n_tile if plan.splits > 1 else 0)
    # the slices: k-tile ranges non-empty, in order, covering all k-tiles;
    # in elements, each product's [0, K) exactly once
    tiles = slice_tiles(plan)
    assert len(tiles) == plan.splits
    assert tiles[0][0] == 0 and tiles[-1][1] == plan.k_tiles
    for (a, b), (c, _) in zip(tiles, tiles[1:]):
        assert b == c
    if plan.k_tiles:
        assert all(b > a for a, b in tiles)
    covered = [np.zeros(k, dtype=int) for k in ks]
    for parts in slice_ranges(plan, ks):
        if plan.k_tiles:
            assert parts, 'empty slice'
        for i, k0, k1 in parts:
            assert 0 <= k0 < k1 <= ks[i]
            covered[i][k0:k1] += 1
    for c in covered:
        assert np.all(c == 1)
    return plan


@pytest.mark.parametrize('M,N,ks', PATH_SHAPES)
def test_plan_of_the_paths_products(M, N, ks):
    plan = check_plan(M, N, ks)
    # the paths' products fill the card: one block per SM at most, and at
    # least half of them busy where K allows it
    if plan.k_tiles >= 8:
        assert plan.tiles * plan.splits >= N_SM // 3


@pytest.mark.parametrize('M', RAGGED_M)
@pytest.mark.parametrize('K', RAGGED_K)
def test_plan_of_ragged_shapes(M, K):
    for N in RAGGED_N:
        check_plan(M, N, (K,))
        check_plan(M, N, (K, 24))
    # other cards: a PCIe H100 (114 SMs) and a single SM
    for n_sm in (114, 1):
        check_plan(M, 784, (K,), n_sm)


def test_plan_batch_widths():
    """The smallest wgmma width that holds the batch tile: 16 for rbm_mnist's
    10 rows, 56 for 50, 104 for 100, 128 for 128; 256 rows in two tiles of
    128, 300 in three; where the model tiles alone are few (a 512-wide
    output is 4 of them) the batch tiles narrow down to 16 rows, never below,
    until there are 32 tiles."""
    wide = {M: gemm.gemm_plan(M, 5000, 784, N_SM) for M in
            (1, 10, 50, 67, 100, 128, 256, 300)}
    assert {M: (p.n_tile, p.batch_tiles) for M, p in wide.items()} == {
        1: (8, 1), 10: (16, 1), 50: (56, 1), 67: (104, 1), 100: (104, 1),
        128: (128, 1), 256: (128, 2), 300: (128, 3)}
    narrow = {M: gemm.gemm_plan(M, 512, 784, N_SM) for M in (10, 100, 256)}
    assert {M: (p.n_tile, p.batch_tiles) for M, p in narrow.items()} == {
        10: (16, 1), 100: (16, 7), 256: (32, 8)}
    # a W too large to read once per narrow tile keeps the batch whole
    assert gemm.gemm_plan(100, 1000, 5000, N_SM).batch_tiles == 1


def test_plan_rejects_bad_shapes():
    with pytest.raises(ValueError, match='gemm_plan'):
        gemm.gemm_plan(0, 10, 10, N_SM)
    with pytest.raises(ValueError, match='gemm_plan'):
        gemm.gemm_plan(10, 10, -1, N_SM)


def test_forced_splits_clip_and_restore(monkeypatch):
    """A launch given `splits` takes that many K slices (clipped to 1..the
    k-tiles, its workspace sized to match); one given none takes the
    plan's."""
    monkeypatch.setattr(gemm, 'num_sms', lambda device: N_SM)
    monkeypatch.setattr(gemm, 'workspace',
                        lambda plan, device, stream: (None, None))
    base = gemm.launch_plan(100, 512, [784, 1024], 'cpu', 0)[0]
    assert gemm.launch_plan(100, 512, [784, 1024], 'cpu', 0, 1)[0].splits == 1
    p = gemm.launch_plan(100, 512, [784, 1024], 'cpu', 0, 10 ** 6)[0]
    assert p.splits == p.k_tiles == 57
    assert p.workspace == p.tiles * 57 * gemm.TILE_M * p.n_tile
    assert gemm.launch_plan(100, 512, [784, 1024], 'cpu', 0)[0] == base
    assert gemm.launch_plan(100, 512, [784, 1024], 'cpu', 0, None)[0] == base


def test_workspace_per_stream(monkeypatch):
    """Launches on one stream share a workspace and its counters (they run
    in order); a launch on another stream gets its own, so two streams
    never race on a tile's counter.  A one-slice plan needs none."""
    monkeypatch.setattr(gemm, '_WORKSPACES', {})
    plan = gemm.gemm_plan(10, 1024, 784, N_SM)
    assert plan.splits > 1
    ws, counters = gemm.workspace(plan, 'cpu', 7)
    assert ws.numel() == plan.workspace and counters.numel() == plan.tiles
    assert bool((counters == 0).all())
    again = gemm.workspace(plan, 'cpu', 7)
    assert again[0] is ws and again[1] is counters
    other = gemm.workspace(plan, 'cpu', 8)
    assert other[0] is not ws and other[1] is not counters
    assert gemm.workspace(plan._replace(splits=1), 'cpu', 7) == (None, None)


def test_check_operand_strides():
    """The tile reads each activation row K-major: a unit column stride is
    required (a row stride above K is taken), W must be contiguous."""
    A = torch.zeros((10, 40))
    W = torch.zeros((30, 20))
    assert gemm.check_operand(A[:, :30], W, False) == (40, (20, 1))
    assert gemm.check_operand(A[:, :20], W, True) == (40, (1, 20))
    with pytest.raises(ValueError, match='unit column stride'):
        gemm.check_operand(A.T, W, False)
    with pytest.raises(ValueError, match='unit column stride'):
        gemm.check_operand(A[:, ::2], W, False)
    with pytest.raises(ValueError, match='contiguous'):
        gemm.check_operand(A[:, :30], W.T.contiguous().T, False)


# ---------------------------------------------------------------------- #
# 3xTF32 arithmetic                                                       #
# ---------------------------------------------------------------------- #
def tf32(x):
    """Round float32 to tf32 (10 explicit mantissa bits), to nearest with
    ties away from zero -- cvt.rna.tf32.f32 -- by bit masks."""
    u = np.asarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def product_3xtf32(A, W):
    """The tile's arithmetic: lo.hi + hi.lo + hi.hi, each a product of tf32
    values (exact in f32) summed in f32."""
    a_hi, a_lo = split(A)
    w_hi, w_lo = split(W)
    return (a_lo @ w_hi + a_hi @ w_lo) + a_hi @ w_hi


def operands(K, dist, seed=0):
    rng = np.random.RandomState(seed + K)
    A = (rng.rand(100, K) < 0.3) if dist == 'bernoulli' else rng.randn(100, K)
    W = 0.05 * rng.randn(K, 64)
    return A.astype(np.float32), W.astype(np.float32)


def excess_over_bound(got, A, W):
    """max over elements of |got - A.W| (float64) less the card tests' bound
    2^-22 (gemm.ERR_SUM |A|.|W| + |A.W|); <= 0 within it."""
    A64, W64 = A.astype(np.float64), W.astype(np.float64)
    exact = A64 @ W64
    bound = 2. ** -22 * (gemm.ERR_SUM * (np.abs(A64) @ np.abs(W64))
                         + np.abs(exact))
    return float((np.abs(got - exact) - bound).max())


@pytest.mark.parametrize('K', [784, 3072, 5000])
@pytest.mark.parametrize('dist', ['bernoulli', 'gaussian'])
def test_3xtf32_within_the_card_tolerance(K, dist):
    A, W = operands(K, dist)
    got = product_3xtf32(A, W)
    assert got.dtype == np.float32
    assert excess_over_bound(got, A, W) <= 0.
    # the split is exact up to the dropped lo.lo and lo's own rounding
    a_hi, a_lo = split(A)
    assert np.all(np.abs(A - (a_hi + a_lo)) <= 2. ** -21 * np.abs(A))


@pytest.mark.parametrize('K', [784, 3072, 5000])
@pytest.mark.parametrize('dist', ['bernoulli', 'gaussian'])
def test_1xtf32_misses_the_card_tolerance(K, dist):
    """Plain TF32 (one product of the rounded operands) keeps ~3 decimal
    digits: off by more than the bound (trap C8)."""
    A, W = operands(K, dist)
    assert excess_over_bound(tf32(A) @ tf32(W), A, W) > 0.


def truncate(x):
    """float64 to float32, rounded toward zero."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def tile_3xtf32(A, W, per_stage):
    """The tile's arithmetic in the order csrc/gemm_tc.cuh issues it: per
    32-deep stage, the lo.hi and hi.lo wgmmas of each 8-deep step, then the
    hi.hi ones; each wgmma adds its exact sum of 8 products to the
    accumulator and truncates the result to f32.  `per_stage`: each stage
    into a zeroed accumulator, added to the block's sum rounded to nearest
    (the tile); else one accumulator for the whole K."""
    (a_hi, a_lo), (w_hi, w_lo) = split(A), split(W)
    d = np.zeros((A.shape[0], W.shape[1]), np.float32)

    def wgmma(acc, a, w, k):
        return truncate(acc.astype(np.float64) + a[:, k:k + 8].astype(
            np.float64) @ w[k:k + 8].astype(np.float64))

    for s0 in range(0, A.shape[1], gemm.TILE_K):
        ks = range(s0, min(s0 + gemm.TILE_K, A.shape[1]), 8)
        c = np.zeros_like(d) if per_stage else d
        for k in ks:
            c = wgmma(wgmma(c, a_hi, w_lo, k), a_lo, w_hi, k)
        for k in ks:
            c = wgmma(c, a_hi, w_hi, k)
        d = d + c if per_stage else c
    return d


@pytest.mark.parametrize('K', [784, 3072, 5000])
@pytest.mark.parametrize('dist', ['bernoulli', 'gaussian'])
def test_single_accumulator_misses_the_card_tolerance(K, dist):
    """The tensor cores truncate their f32 sums: one accumulator over all of
    K drifts past the bound (on the card it needs 5.7-19.6 where the bound
    allows gemm.ERR_SUM = 2); each 32-deep stage accumulated apart and added
    rounded to nearest, as the tile does, stays within it (trap C8)."""
    A, W = operands(K, dist)
    assert excess_over_bound(tile_3xtf32(A, W, True), A, W) <= 0.
    assert excess_over_bound(tile_3xtf32(A, W, False), A, W) > 0.


# ---------------------------------------------------------------------- #
# the association kernel (csrc/assoc_tc.cuh)                              #
# ---------------------------------------------------------------------- #
# (V, H): the paths' associations -- rbm_mnist and the 784 x 1024 stats,
# the DBM's two layers, the G-RBM, M-RBM and 3072 x 7800 stats -- and ragged
# ones
ASSOC_PATH = [(784, 1024), (784, 512), (512, 1024), (3072, 5000),
              (5000, 1000), (3072, 7800)]
ASSOC_RAGGED = [(1, 1), (24, 16), (37, 70), (130, 65), (50, 129), (129, 33),
                (7800, 3072)]


@pytest.mark.parametrize('V,H', ASSOC_PATH + ASSOC_RAGGED)
@pytest.mark.parametrize('n_sm', [N_SM, 114, 1])
def test_assoc_plan_covers_the_output_once(V, H, n_sm):
    """A width the kernel is built for; the blocks tile V x H exactly (128
    rows of V, n_tile columns of H each, every element one owner); 32-wide
    only where that still fits in one wave and the 64-wide tiles would
    leave more than a quarter of the SMs idle."""
    p = gemm.assoc_plan(V, H, n_sm)
    assert p.n_tile in gemm.ASSOC_N_TILES
    assert p.row_tiles * gemm.TILE_M >= V > (p.row_tiles - 1) * gemm.TILE_M
    assert p.col_tiles * p.n_tile >= H > (p.col_tiles - 1) * p.n_tile
    assert p.blocks == p.row_tiles * p.col_tiles
    wide = p.row_tiles * -(-H // 64)
    if p.n_tile == 32:
        assert p.blocks <= n_sm and 4 * wide < 3 * n_sm
    else:
        assert p.blocks == wide


def test_assoc_plan_of_the_paths():
    """About one wave at the small shapes (784 x 1024: 112 blocks; the DBM's
    784 x 512 and 512 x 1024 narrowed to 32 columns: 112 and 128), 64
    columns at the CIFAR shapes (many waves)."""
    got = {vh: gemm.assoc_plan(*vh, N_SM) for vh in ASSOC_PATH}
    assert {vh: (p.n_tile, p.blocks) for vh, p in got.items()} == {
        (784, 1024): (64, 112), (784, 512): (32, 112), (512, 1024): (32, 128),
        (3072, 5000): (64, 1896), (5000, 1000): (64, 640),
        (3072, 7800): (64, 2928)}
    with pytest.raises(ValueError, match='assoc_plan'):
        gemm.assoc_plan(0, 10, N_SM)


def assoc_3xtf32(pairs, scales):
    """The association kernel's arithmetic: the products' 32-deep k-tiles
    interleaved (tile j of product 0, then tile j of product 1), each stage
    in 3xTF32 by tile_3xtf32's wgmma order into a zeroed accumulator, added
    to the sum times its product's scale, rounded to nearest once (an
    FMA)."""
    d = np.zeros((pairs[0][0].shape[1], pairs[0][1].shape[1]), np.float32)
    tiles = [[(A[k:k + gemm.TILE_K].T, B[k:k + gemm.TILE_K])
              for k in range(0, A.shape[0], gemm.TILE_K)] for A, B in pairs]
    order = []
    for j in range(max(len(t) for t in tiles)):
        order += [(i, j) for i in range(len(pairs)) if j < len(tiles[i])]
    for i, j in order:
        c = tile_3xtf32(*tiles[i][j], per_stage=False)
        d = (d.astype(np.float64) +
             c.astype(np.float64) * np.float64(np.float32(scales[i]))
             ).astype(np.float32)
    return d


@pytest.mark.parametrize('B', [1, 10, 50, 100, 256])
@pytest.mark.parametrize('dist', ['bernoulli', 'gaussian'])
def test_stacked_association_within_the_card_tolerance(B, dist):
    """X^T h0 - v^T h as one K loop of 2B (the sign as the second product's
    scale, -1): each element within 2^-22 (ERR_SUM (|X|^T|h0| + |v|^T|h|) +
    |assoc|) of the float64 association; and where v = X, h = h0 (k = 0)
    exactly zero."""
    rng = np.random.RandomState(B)
    V, H = 40, 24
    X = (rng.rand(B, V) < 0.3) if dist == 'bernoulli' else rng.randn(B, V)
    v = (rng.rand(B, V) < 0.3) if dist == 'bernoulli' else rng.randn(B, V)
    X, v = X.astype(np.float32), v.astype(np.float32)
    h0, h = (rng.rand(B, H).astype(np.float32) for _ in range(2))
    got = assoc_3xtf32([(X, h0), (v, h)], (1., -1.))
    f = [a.astype(np.float64) for a in (X, h0, v, h)]
    exact = f[0].T @ f[1] - f[2].T @ f[3]
    l1 = np.abs(f[0]).T @ np.abs(f[1]) + np.abs(f[2]).T @ np.abs(f[3])
    bound = 2. ** -22 * (gemm.ERR_SUM * l1 + np.abs(exact))
    assert float((np.abs(got - exact) - bound).max()) <= 0.
    assert not assoc_3xtf32([(X, h0), (X, h0)], (1., -1.)).any()


def test_dbm_association_scales_within_the_card_tolerance():
    """Ad^T Bd / N - Ap^T Bp / M with N != M: the scales 1/N and -1/M
    (rounded to f32) applied to each stage as it is added stay within the
    bound of the scaled terms."""
    rng = np.random.RandomState(7)
    N, M, V, H = 37, 100, 30, 20
    Ad, Ap = ((rng.rand(n, V) < 0.5).astype(np.float32) for n in (N, M))
    Bd, Bp = (rng.rand(n, H).astype(np.float32) for n in (N, M))
    got = assoc_3xtf32([(Ad, Bd), (Ap, Bp)], (1. / N, -1. / M))
    f = [a.astype(np.float64) for a in (Ad, Bd, Ap, Bp)]
    exact = f[0].T @ f[1] / N - f[2].T @ f[3] / M
    l1 = np.abs(f[0]).T @ np.abs(f[1]) / N + np.abs(f[2]).T @ np.abs(f[3]) / M
    bound = 2. ** -22 * (gemm.ERR_SUM * l1 + np.abs(exact))
    assert float((np.abs(got - exact) - bound).max()) <= 0.
