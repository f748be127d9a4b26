"""Launch plans of the tensor-core GEMM tile (``csrc/gemm_tc.cuh``), the
main loop of ``cd_gemm_act`` and ``dbm_gemm_act``, and of the association
kernel (``csrc/assoc_tc.cuh``, ``assoc_plan``) on the same main loop.

The tile computes ``out (B x N) = A (B x K) . W`` (or ``W^T``) with the
model dimension N as wgmma's 64-row M and the batch B as its N.  The plan
picks, per launch:

* ``n_tile``: wgmma's N, the batch rows of one tile: the smallest of
  ``N_TILES`` that holds the batch (up to 128 rows a tile), narrowed (down to
  16) while the output tiles number fewer than ``TARGET_TILES``;
* ``splits``: how many slices K is cut into (deterministic split-K); a
  block takes one SM (its registers), so the plan fills the card in one
  wave: 1 when the output tiles fill at least half of the SMs, else as many
  slices as fit in ``n_sm`` blocks, at most one slice per two 32-deep
  k-tiles;
* the workspace the slices need: ``splits x 128 x n_tile`` floats per
  output tile, and one counter per tile.

The plan is plain integer arithmetic, so the CPU tests hold it; the wrappers
(``ops/cd_epoch.py``, ``ops/cd_stats.py``, ``ops/dbm_ops.py``) pass it in the
launch arguments, and ``workspace`` keeps one workspace and one zeroed
counter array per plan size, device and stream.
"""

from collections import namedtuple
from functools import lru_cache

import torch

TILE_M = 128   # model rows per block (two warpgroups of wgmma's 64)
TILE_K = 32    # K per shared-memory stage (128 bytes of f32)
MAX_N = 128    # the widest batch tile (wgmma's N; two accumulators fit)
#: the batch widths the kernels are built for (csrc/wgmma_tf32.cuh)
N_TILES = (8, 16, 32, 56, 64, 104, 128)
#: the tile's accuracy: against the product in true f32, each element of
#: A.W is within 2^-22 (ERR_SUM (|A|.|W|) + |A.W|).  On an H100 the tile
#: needs at most 0.69 there, a tile with one accumulator per K slice 5.7-19.6
#: (``python3 chip_smoke.py --readings``); the card tests hold it to this.
ERR_SUM = 2.

GemmPlan = namedtuple('GemmPlan', (
    'n_tile', 'batch_tiles', 'model_tiles', 'k_tiles', 'splits',
    'workspace', 'tiles'))


def _ceil(a, b):
    return -(-a // b)


#: batch tiles are cut below 128 rows (down to 16) while the model tiles
#: alone leave most SMs idle: each tile's epilogue (activation, draws) and
#: split-K sum run on one block, so more, narrower tiles spread them, at the
#: cost of reading W once per batch tile (from L2), kept under this many
#: bytes
REREAD_BYTES = 16 << 20
TARGET_TILES = 32


@lru_cache(maxsize=None)
def _plan(M, N, ks, n_sm):
    if M < 1 or N < 1 or n_sm < 1 or any(k < 0 for k in ks):
        raise ValueError('gemm_plan needs M, N, n_sm >= 1 and K >= 0, got '
                         '{0}'.format((M, N, ks, n_sm)))
    model_tiles = _ceil(N, TILE_M)
    w_bytes = 4 * N * sum(ks)
    n_tile = next(n for n in N_TILES if n >= min(M, MAX_N))
    while _ceil(M, n_tile) * model_tiles < TARGET_TILES:
        narrower = [n for n in N_TILES if 16 <= n < n_tile]
        if not narrower or _ceil(M, narrower[-1]) * w_bytes > REREAD_BYTES:
            break
        n_tile = narrower[-1]
    batch_tiles = _ceil(M, n_tile)
    tiles = batch_tiles * model_tiles
    k_tiles = sum(_ceil(k, TILE_K) for k in ks)
    splits = 1
    if 2 * tiles <= n_sm and k_tiles >= 4:
        splits = min(n_sm // tiles, k_tiles // 2)
    workspace = tiles * splits * TILE_M * n_tile if splits > 1 else 0
    return GemmPlan(n_tile, batch_tiles, model_tiles, k_tiles, splits,
                    workspace, tiles)


def gemm_plan(M, N, K, n_sm):
    """The plan of a launch with `M` batch rows, `N` output (model) columns
    and depth `K` -- an int, or a sequence of the depths of the products
    summed in one accumulator -- on a card of `n_sm` SMs."""
    ks = (int(K),) if isinstance(K, int) else tuple(int(k) for k in K)
    return _plan(int(M), int(N), ks, int(n_sm))


AssocPlan = namedtuple('AssocPlan', ('n_tile', 'row_tiles', 'col_tiles',
                                     'blocks'))
#: the association kernel's widths (csrc/assoc_tc.cuh): columns of H per
#: block; V is wgmma's M, TILE_M rows per block
ASSOC_N_TILES = (32, 64)


def assoc_plan(V, H, n_sm):
    """The plan of an association launch (``cd_assoc_update``,
    ``cd_assoc_stats``, ``dbm_assoc_update``: a V x H output contracted
    over the batch) on a card of `n_sm` SMs: 64 columns per block, or 32
    where 64-wide tiles would leave more than a quarter of the SMs idle and
    32-wide ones still fit in one wave.  No split-K: every element has one
    owner.  The wrappers pass ``n_tile`` to the three entry points, as they
    pass the tile's plan to the products."""
    V, H, n_sm = int(V), int(H), int(n_sm)
    if V < 1 or H < 1 or n_sm < 1:
        raise ValueError('assoc_plan needs V, H, n_sm >= 1, got {0}'.format(
            (V, H, n_sm)))
    rows = _ceil(V, TILE_M)
    wide, narrow = rows * _ceil(H, 64), rows * _ceil(H, 32)
    n_tile = 32 if 4 * wide < 3 * n_sm and narrow <= n_sm else 64
    cols = _ceil(H, n_tile)
    return AssocPlan(n_tile, rows, cols, rows * cols)


#: the families of the tile's kernels: the products ('gemm_act':
#: cd_gemm_act, dbm_gemm_act and its AIS and graph launches), the
#: free-energy rows ('fe_rows': cd_metrics_fe, cd_val_fe, the probe's
#: product) and the associations ('assoc')
TILE_FAMILIES = ('gemm_act', 'fe_rows', 'assoc')
#: per family, the launches and the k-tiles a block walks, summed over them
#: (a launch's k_tiles / splits, from the plan its wrapper passes): the K
#: loop overlaps one stage's split with the stage before's wgmmas only
#: where a block walks more than one.
#: Zeroed with the launch counters (``reset_launches`` of ``cd_epoch``,
#: ``cd_stats``, ``dbm_ops`` and ``samplers``).
tile_stages = {f: {'launches': 0, 'k_tiles': 0.} for f in TILE_FAMILIES}


def count_stages(family, k_tiles, splits, launches=1):
    """Count `launches` launches of `family` whose blocks walk `k_tiles` /
    `splits` k-tiles each (`k_tiles` over both products of a launch)."""
    c = tile_stages[family]
    c['launches'] += int(launches)
    c['k_tiles'] += int(launches) * int(k_tiles) / int(splits)


def assoc_k_tiles(K0, K1):
    """The k-tiles of an association launch over batches of K0 and K1 rows
    (no split-K: a block walks them all)."""
    return _ceil(int(K0), TILE_K) + _ceil(int(K1), TILE_K)


def mean_stages():
    """{family: the mean k-tiles a block walks}, None for a family with no
    launch."""
    return {f: (c['k_tiles'] / c['launches'] if c['launches'] else None)
            for f, c in tile_stages.items()}


def reset_stages():
    for c in tile_stages.values():
        c['launches'], c['k_tiles'] = 0, 0.


@lru_cache(maxsize=None)
def num_sms(device):
    """The SM count of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


_WORKSPACES = {}


def workspace(plan, device, stream):
    """(workspace, counters) tensors for `plan` on `device`, kept per size,
    device and CUDA stream (the handle) and shared by every launch with
    that key: launches on one stream run in order, and each leaves its
    counters at zero.  (None, None) when the plan has one slice."""
    if plan.splits == 1:
        return None, None
    key = (str(device), int(stream or 0), plan.workspace, plan.tiles)
    if key not in _WORKSPACES:
        _WORKSPACES[key] = (
            torch.empty(plan.workspace, dtype=torch.float32, device=device),
            torch.zeros(plan.tiles, dtype=torch.int32, device=device))
    return _WORKSPACES[key]


def launch_plan(M, N, K, device, stream, splits=None):
    """(plan, workspace, counters) of a launch on `device` and the CUDA
    stream `stream`; `splits`, when given, replaces the plan's slice count
    (clipped to 1..k-tiles), so a test can hold the kernels at several."""
    plan = gemm_plan(M, N, K, num_sms(device))
    if splits is not None:
        s = max(1, min(int(splits), max(plan.k_tiles, 1)))
        plan = plan._replace(
            splits=s, workspace=(plan.tiles * s * TILE_M * plan.n_tile
                                 if s > 1 else 0))
    ws, counters = workspace(plan, device, stream)
    return plan, ws, counters


def check_operand(lhs, W, transposed, name='A'):
    """Raise unless `lhs` (rows, K) has unit column stride -- the tile reads
    its rows K-major -- and `W` is contiguous; returns (row stride of lhs,
    (sbk, sbn) of W as the kernels' C interface takes them)."""
    if lhs.dim() != 2 or lhs.stride(1) != 1 or lhs.stride(0) < lhs.shape[1]:
        raise ValueError('{0} must be (rows, K) with unit column stride, got '
                         'strides {1}'.format(name, tuple(lhs.stride())))
    if not W.is_contiguous():
        raise ValueError('W must be contiguous')
    sbk, sbn = (1, W.shape[1]) if transposed else (W.shape[1], 1)
    return lhs.stride(0), (sbk, sbn)

