// All-Bernoulli DBM kernels, hand-written for Hopper (sm_90a): the PCD /
// mean-field training epoch, the particle sampler and the AIS sweep.
//
// Replaces the TPU's three kernels of boltzmann_machines_tpu/ops/pallas_dbm.py:
//   make_dbm_epoch_kernel / _dbm_epoch_kernel   (pallas_call at :373)
//   make_dbm_sample_kernel / _dbm_sample_kernel (pallas_call at :481)
//   make_ais_kernel / _ais_kernel               (pallas_call at :516)
// Each of those is one pallas_call with every weight, accumulator and chain
// resident in VMEM for the whole run.  Hopper has no such memory: here W, dW,
// the particles and the mean-field buffers live in device memory (and the
// 50 MB L2), and each minibatch (sweep, beta) is an ordered sequence of
// launches on one stream, with no host synchronisation inside a call of the
// wrapper (ops/dbm_ops.py).
//
// Kernels:
//   dbm_gemm_act     out = act(alpha (A1.B1 + A2.B2 + C) + gamma bias), the
//                    one GEMM of every layer update (the tensor-core tile
//                    of gemm_tc.cuh): two products summed in one K loop
//                    (a middle layer reads "up from below
//                    plus down from above"), an optional addend C (the
//                    hoisted X.W0 of mean-field), the bias scaled by gamma
//                    apart from the product (mean-field init doubles the
//                    product only: sigmoid(2 X.W0 + hb0); AIS scales both by
//                    beta), except in the softplus epilogue, which adds it
//                    inside the scale (AIS log p~: softplus(beta (x.W + b))).
//                    Epilogues: identity, sigmoid with optional Philox
//                    states, sigmoid with the mean-field change
//                    max |new - old| folded into a device scalar, and per-row
//                    softplus sums at two betas written as per-block partials.
//                    The mean-field loop's check rides on the layer
//                    launches: each block of a sweep's first layer launch
//                    reads the change of the sweep before (complete, as that
//                    sweep's launches have ended) and returns at once when
//                    it is <= tol or NaN, block 0 raising the `done` flag
//                    and writing n_mf; the budget is the number of sweeps
//                    the host enqueues (every sweep launch returns at once
//                    when `done` is set), so the mean-field loop stays on
//                    the device with no launch of its own for the check.
//                    Three change words, one per sweep modulo 3: a sweep
//                    folds into its own, its first launch reads the word of
//                    the sweep before and re-arms the word of the sweep
//                    after.  (A check launched on its own costs a launch's
//                    floor, 1.2-1.3 us, once per sweep; one run by the last
//                    block of a sweep's last launch to finish, after an
//                    arrival counter over the output tiles, costs as much:
//                    three dependent trips to L2, PERF.md.)
//   dbm_bias_update  the bias statistics (data / N - particles / M), the
//                    per-layer sparsity EMAs of batch sums with their
//                    penalty, and the momentum update of every bias vector
//                    of the step (vb and each hb_l) in one launch.  Bound by
//                    its bytes, the (N + M) x n rows read once (0.2-0.3 us
//                    per vector at 100 + 100 rows), so by a launch's
//                    latency: one grid of blocks of 32 columns over all the
//                    vectors (73 at 784-512-1024), whose eight warps load
//                    the rows 16 bytes a lane (colwalk.cuh) and stage them
//                    in shared memory; one warp adds the data rows, another
//                    the particle rows, each column in row order (the bits
//                    of one thread walking the column).
//   dbm_assoc_update data^T.data / N - particles^T.particles / M - l2 W -
//                    penalty, and the momentum update of dW and W in place.
//   dbm_max_norm     per-column max-norm of W after the update (a reduction
//                    over rows, so its own pass): the max-norm of
//                    _dbm_epoch_kernel (pallas_dbm.py:271-274).  Bound by
//                    W's bytes, read once and written once (1.6 MB at
//                    784x512, 0.96 us at 3.35 TB/s; 2.1 MB, 1.25 us at
//                    512x1024), W just written by the association, so in
//                    L2.  A block per 8 columns holds all their rows (64
//                    blocks for 784x512, 128 for 512x1024); its eight warps
//                    split the rows, two lanes of 16 bytes reading each
//                    row's 32 bytes (colwalk.cuh), and keep their values in
//                    registers between the norm and the scale, so W is read
//                    once; the column sums are added in a fixed order.  A
//                    cluster of 8 blocks per 32 columns, adding the partial
//                    norms over distributed shared memory, took longer on
//                    the card (PERF.md).
//   dbm_msre         the minibatch's msre, mean((X - v_means)^2), and its
//                    mean-field update count: JAX's jnp.mean(jnp.square(X -
//                    v_means)) (pallas_dbm.py:287).  Bound by its bytes,
//                    X and v_means read once (627 KB at 100x784, 0.19 us
//                    at 3.35 TB/s), so by a launch's latency.  A grid
//                    reduction: ~B V / 1024 blocks of 256 threads (77 at
//                    100x784, at most 256) read 16 bytes a lane of each,
//                    one trip to memory, and the last block to finish adds
//                    the block sums in a fixed order (the last-block test
//                    of cd_metrics); no float atomics, so a rerun is bit
//                    for bit.
//   ais_logw         the log-weight update of an AIS beta: per run r,
//                    log_w[r] -= lp(beta_lo); log_w[r] += lp(beta_hi), lp
//                    from x_r . hb0 and the softplus partials of the beta's
//                    two kSoftplusRows launches.  Bound by a launch's
//                    latency (its bytes, ~0.2 MB at 100 runs, take 0.07
//                    us), so it has no launch of its own but one per AIS
//                    run: beta j's update rides on beta j + 1's first
//                    dbm_gemm_act launch (which reads x and writes v only;
//                    the partials alternate between two buffers by the
//                    beta's parity, so beta j + 1's launches never write
//                    what the update reads), and one standalone launch
//                    applies the last beta's.  Both run one device
//                    function, one warp a run: each lane adds its strided
//                    terms in order, then a shuffle tree, so log-weights
//                    are the same bits wherever a run's warp sits.  In
//                    the GEMM launch (ais_gemm_act_kernel, the
//                    dbm_gemm_act body in a kernel of its own, so that the
//                    other launches keep their registers) the warps of the
//                    runs are spread over the blocks (one warp of each
//                    block while runs <= blocks) and run once the ring's
//                    first loads are issued, while they are in flight.
//
// Mean-field without a ping-pong buffer: the update of layer l reads layers
// l-1 and l+1 but never l, so each element's owner reads its old value,
// writes the new one and folds |new - old| into the change, race-free, and
// layer 0 still reads the old mu1 (layer 1's launch comes after it).
//
// What bounds it on an H100: at dbm_mnist's shapes (784-512-1024, 100 rows)
// each product is 40-100 MFLOP and reads 1.6-3.2 MB of W: a microsecond of
// either, so a launch is bound by its latency, and a DBM step (107
// dbm_gemm_act launches at 50 mean-field sweeps) or an AIS beta (17) by the
// chain of launches.  dbm_gemm_act runs on the tensor-core tile of
// gemm_tc.cuh: swap-AB wgmma in 3xTF32 with the two products of a middle
// layer in one K loop, narrow batch tiles and deterministic split-K so that
// ~100-130 blocks share each product instead of 8-16, and the epilogues
// above on the summed tile.  dbm_assoc_update (K = rows, an n_in x n_out
// output) is the association kernel of assoc_tc.cuh: both products in one
// tensor-core K loop, each scaled as its stages are added (1/N, -1/M), the
// update of W and dW as a TMA-fed epilogue.  CUDA graphs for the launch
// chain are later work.
//
// C interface (bound with ctypes by ops/dbm_ops.py): every entry launches on
// the given stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() (the first error of a multi-launch entry).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <vector>

#include "assoc_tc.cuh"
#include "colwalk.cuh"
#include "gemm.cuh"
#include "gemm_tc.cuh"
#include "philox.cuh"

namespace {

using bm::block_sum;
using bm::sigmoid;
using bm::softplus;

enum Act { kIdentity = 0, kSigmoid = 1, kSigmoidDelta = 2, kSoftplusRows = 3 };

// max that keeps a NaN, as jnp.max does (a NaN change ends mean-field)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (b != b || b > a) ? b : a;
}

}  // namespace

// Arguments of one dbm_gemm_act launch; ops/dbm_ops.py mirrors the layout
// (ctypes.Structure, natural alignment).  A(m, k) = a[m*sam + k*sak] with
// sak == 1, B(k, n) = b[k*sbk + n*sbn] with sbn == 1 (W) or sbk == 1 (W^T);
// a2 == nullptr (or k2 == 0) drops the second product, c (row-major M x N)
// and bias (N) may be null.  The tile's plan (ops/gemm.py): n_tile, splits,
// and for splits > 1 a workspace of splits x 128 x n_tile floats and one
// zeroed counter per output tile.
struct GemmArgs {
  const float* a1;
  const float* b1;
  const float* a2;
  const float* b2;
  const float* c;
  const float* bias;
  float* out;             // means or states; kSoftplusRows: partials
  unsigned* delta_bits;   // kSigmoidDelta: max |new - old| as float bits
  const int* done;        // launch is a no-op while *done != 0; may be null
  float* ws;              // split-K workspace
  unsigned* counters;     // split-K per-tile counters
  long long sam1, sak1, sbk1, sbn1;
  long long sam2, sak2, sbk2, sbn2;
  int k1, k2, M, N;
  int act, sample;
  int n_tile, splits;
  float alpha, alpha2, gamma;
  unsigned seed, it, stream_id;
};

// The log-weight update of one AIS beta (ais_logw); ops/dbm_ops.py mirrors
// the layout.  x (R, H1) the runs' states, part_v and part_h2 the partials
// of the beta's two kSoftplusRows launches (2 x R x nblk floats each: the
// rows at beta_lo, then at beta_hi).  log_w == nullptr: none pending.
struct AisLogw {
  const float* x;
  const float* hb0;
  const float* part_v;
  const float* part_h2;
  float* log_w;
  int R, H1, nblk_v, nblk_h2;
  float beta_lo, beta_hi;
};

// The kernel's parameter: the launch's arguments and its tile (tensor maps
// in parameter space).
struct DbmGemmArgs {
  bm::tc::Tile t;
  GemmArgs a;
  // the first layer launch of mean-field sweep `sweep` of bm_dbm_mf_loop:
  // the control words (mf_change), and the check's tolerance and budget;
  // null in every other launch
  unsigned* ctrl;
  int sweep, max_updates;
  float tol;
  // the first launch of an AIS beta: the update of the beta before
  AisLogw pending;
};

// One bias vector of a dbm_bias_update launch; ops/dbm_ops.py mirrors the
// layout.  D (N, n) holds the data-side rows, P (M, n) the particles';
// q == nullptr: no sparsity (mu_m and pen unused).
struct BiasVec {
  const float* D;
  const float* P;
  float* b;
  float* db;
  float* q;
  float* mu_m;
  float* pen;
  int n;
  float cost, target;
};

constexpr int kMaxBias = 8;  // bias vectors per launch: a DBM of <= 7 layers

struct BiasArgs {
  BiasVec v[kMaxBias];
  int first[kMaxBias + 1];  // the first block of each vector, then the grid
  int n_vecs, N, M;
  float lr, mom, damp, one_minus_damp;
};

namespace {

constexpr int kRedThreads = 256;
// dbm_max_norm: columns per block, and the floats of W each thread keeps
// in registers between its two passes (7 rows of 4 at VW = 4: 896 rows)
constexpr int kNormTile = 8;
constexpr int kNormHold = 28;
// dbm_bias_update: rows of each side staged per pass
constexpr int kBiasChunk = 128;

// The mean-field control words, zeroed before the first sweep: the change
// of sweep s (max |new - old| as float bits, folded by atomicMax) in word
// mf_change(s), the done flag in word 1, n_mf in word 2 (dbm_msre reads
// it).
__host__ __device__ __forceinline__ int mf_change(int sweep) {
  return sweep % 3 == 0 ? 0 : 2 + sweep % 3;
}

// The check of sweep s - 1, at the start of sweep s's first layer launch,
// in every block alike (no block of this launch writes the change word it
// reads): whether sweep s runs.  The JAX loop runs while n < max and
// delta > tol, so a NaN change stops it too; the budget is the sweeps the
// host enqueues.
// Block 0 writes what the launch decides: done and n_mf = s when the loop
// stopped; else it re-arms the word of sweep s + 1 (that of sweep s - 2,
// which sweep s - 1's check read in an earlier launch) and, in the budget's
// last sweep, writes n_mf = max.
__device__ __forceinline__ bool mf_sweep_runs(unsigned* ctrl, int s, float tol,
                                              int max_updates) {
  const bool lead = blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 &&
                    threadIdx.x == 0;
  if (s > 0 && !(__uint_as_float(ctrl[mf_change(s - 1)]) > tol)) {
    if (lead) {
      ctrl[1] = 1u;
      ctrl[2] = (unsigned)s;
    }
    return false;
  }
  if (lead) {
    ctrl[mf_change(s + 1)] = 0u;
    if (s == max_updates - 1) ctrl[2] = (unsigned)max_updates;
  }
  return true;
}

// Run r's log-weight update by the calling warp (all its lanes):
//   lp(beta) = beta (x_r . hb0) + sum_v softplus(beta (x.W0^T + vb))_r
//              + sum_h2 softplus(beta (x.W1 + hb1))_r,
// the sums from the per-block partials at beta_lo and beta_hi; then
// log_w -= lp(beta_lo); log_w += lp(beta_hi), the JAX kernel's order of
// operations.  Each lane adds the terms at its lane + 32 i in order, then a
// shuffle tree adds the lanes: the same bits in any warp of any launch.
// In two parts: logw_load issues the loads of the lane's first terms (all
// of them where H1 <= 32 kLogwHold and each partial count <= 32) into
// registers, logw_finish adds them (and loads any others), so that the
// loads can be in flight while the caller does other work.
constexpr int kLogwHold = 16;

struct LogwTerms {
  float x[kLogwHold], h[kLogwHold];  // x_r and hb0 at lane + 32 i
  float pv[2], ph[2];  // the partials at lane, at beta_lo and beta_hi
  float w0;            // log_w[r] (lane 0)
};

__device__ __forceinline__ void logw_load(const AisLogw& u, int r,
                                          LogwTerms& t) {
  const int lane = threadIdx.x & 31;
  const float* xr = u.x + (long long)r * u.H1;
#pragma unroll
  for (int i = 0; i < kLogwHold; ++i) {
    const int j = lane + 32 * i;
    t.x[i] = j < u.H1 ? xr[j] : 0.f;
    t.h[i] = j < u.H1 ? u.hb0[j] : 0.f;
  }
  const bool v = lane < u.nblk_v, h2 = lane < u.nblk_h2;
  t.pv[0] = v ? u.part_v[(long long)r * u.nblk_v + lane] : 0.f;
  t.pv[1] = v ? u.part_v[((long long)u.R + r) * u.nblk_v + lane] : 0.f;
  t.ph[0] = h2 ? u.part_h2[(long long)r * u.nblk_h2 + lane] : 0.f;
  t.ph[1] = h2 ? u.part_h2[((long long)u.R + r) * u.nblk_h2 + lane] : 0.f;
  t.w0 = lane == 0 ? u.log_w[r] : 0.f;
}

__device__ __forceinline__ void logw_finish(const AisLogw& u, int r,
                                            const LogwTerms& t) {
  const int lane = threadIdx.x & 31;
  const float* xr = u.x + (long long)r * u.H1;
  // x.hb0, v lo, v hi, h2 lo, h2 hi
  float s[5] = {0.f, t.pv[0], t.pv[1], t.ph[0], t.ph[1]};
#pragma unroll
  for (int i = 0; i < kLogwHold; ++i) s[0] = fmaf(t.x[i], t.h[i], s[0]);
  for (int j = lane + 32 * kLogwHold; j < u.H1; j += 32)
    s[0] = fmaf(xr[j], u.hb0[j], s[0]);
  for (int b = lane + 32; b < u.nblk_v; b += 32) {
    s[1] += u.part_v[(long long)r * u.nblk_v + b];
    s[2] += u.part_v[((long long)u.R + r) * u.nblk_v + b];
  }
  for (int b = lane + 32; b < u.nblk_h2; b += 32) {
    s[3] += u.part_h2[(long long)r * u.nblk_h2 + b];
    s[4] += u.part_h2[((long long)u.R + r) * u.nblk_h2 + b];
  }
#pragma unroll
  for (int k = 0; k < 5; ++k)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      s[k] += __shfl_xor_sync(0xffffffffu, s[k], o);
  if (lane == 0) {
    const float lp_lo = u.beta_lo * s[0] + s[1] + s[3];
    const float lp_hi = u.beta_hi * s[0] + s[2] + s[4];
    const float w = t.w0 - lp_lo;
    u.log_w[r] = w + lp_hi;
  }
}

// The tile's prologue in an AIS beta's first launch (gemm_tc.cuh
// tile_accumulate): the update of the beta before, run r on warp 7 - r /
// blocks of block r % blocks (and so on past 8 runs a block), so the runs
// spread over the blocks first.  start() issues the loads of the warp's
// first run before the ring's first loads; finish(), after them, adds and
// writes it, then runs any other run of the warp whole.
struct PendingLogw {
  const AisLogw& u;
  int r0;
  LogwTerms t;

  __device__ explicit PendingLogw(const AisLogw& pending) : u(pending) {
    const int blocks = gridDim.x * gridDim.y * gridDim.z;
    const int b =
        blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
    r0 = (kWarpsPerBlock - 1 - (int)(threadIdx.x >> 5)) * blocks + b;
  }
  static constexpr int kWarpsPerBlock = bm::tc::kThreads / 32;

  __device__ void start() {
    if (r0 < u.R) logw_load(u, r0, t);
  }
  __device__ void finish() {
    if (r0 >= u.R) return;
    logw_finish(u, r0, t);
    const int step = kWarpsPerBlock * gridDim.x * gridDim.y * gridDim.z;
    for (int r = r0 + step; r < u.R; r += step) {
      LogwTerms more;
      logw_load(u, r, more);
      logw_finish(u, r, more);
    }
  }
};

// out(m, n) = act(pre), pre = alpha (acc + C) + gamma bias, acc = A1.B1 +
// A2.B2 by the tensor-core tile (gemm_tc.cuh), with the tile's prologue
// `pro`; kSoftplusRows sums softplus(alpha (acc + C + bias)) and the same at
// alpha2 over the row's 128 columns of this block instead.
template <int NT, class Prologue>
__device__ __forceinline__ void gemm_act(const DbmGemmArgs& p,
                                         Prologue& pro) {
  const GemmArgs& a = p.a;
  if (a.done != nullptr && *a.done != 0) return;  // mean-field converged
  if (p.ctrl != nullptr &&
      !mf_sweep_runs(p.ctrl, p.sweep, p.tol, p.max_updates))
    return;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  __shared__ float rows[2][NT][4];  // kSoftplusRows: per row, per warp
  float* T;
  if (!bm::tc::tile_product<NT>(p.t, tc_smem, T, pro)) return;
  const int m0 = blockIdx.y * NT, n0 = blockIdx.x * bm::tc::kTileM;
  const int warp = threadIdx.x >> 5;
  float dmax = 0.f;
  // 256 threads cover two rows of 128 columns per pass: warps 0-3 the
  // first, warps 4-7 the second
  for (int e = threadIdx.x; e < bm::tc::kTileM * NT; e += bm::tc::kThreads) {
    const int n = n0 + e % bm::tc::kTileM, m = m0 + e / bm::tc::kTileM;
    const bool in = m < a.M && n < a.N;
    const long long idx = (long long)m * a.N + n;
    float t =
        T[(e / bm::tc::kTileM) * bm::tc::kTileStride + e % bm::tc::kTileM];
    if (in && a.c != nullptr) t += a.c[idx];
    const float b = in && a.bias != nullptr ? a.bias[n] : 0.f;
    if (a.act == kSoftplusRows) {
      // bias inside the scale: softplus(beta (x.W + b)) at two betas; the
      // row's sums in a fixed order (a shuffle tree, then the two halves)
      const float u = t + b;
      float r1 = in ? softplus(a.alpha * u) : 0.f;
      float r2 = in ? softplus(a.alpha2 * u) : 0.f;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        r1 += __shfl_xor_sync(0xffffffffu, r1, o);
        r2 += __shfl_xor_sync(0xffffffffu, r2, o);
      }
      if ((threadIdx.x & 31) == 0) {
        rows[0][e / bm::tc::kTileM][warp & 3] = r1;
        rows[1][e / bm::tc::kTileM][warp & 3] = r2;
      }
      continue;
    }
    if (!in) continue;
    const float pre = a.alpha * t + a.gamma * b;
    if (a.act == kIdentity) {
      a.out[idx] = pre;
      continue;
    }
    float q = sigmoid(pre);
    if (a.act == kSigmoidDelta) dmax = nan_max(dmax, fabsf(q - a.out[idx]));
    if (a.sample) {
      const float r = bm::philox_uniform(a.seed, a.it, a.stream_id,
                                         (unsigned)idx);
      q = r < q ? 1.f : 0.f;
    }
    a.out[idx] = q;
  }
  if (a.act == kSigmoidDelta) {
    // max over the warp, then one atomic per warp; atomicMax on the bits of
    // non-negative floats is exact and independent of the order (a NaN's
    // bits, 0x7fc00000, exceed those of +inf, so a NaN wins too)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      dmax = nan_max(dmax, __shfl_xor_sync(0xffffffffu, dmax, o));
    if ((threadIdx.x & 31) == 0)
      atomicMax(a.delta_bits, __float_as_uint(dmax));
  } else if (a.act == kSoftplusRows) {
    // one write per (row, column block)
    __syncthreads();
    const int nblk = gridDim.x;
    for (int r = threadIdx.x; r < NT; r += bm::tc::kThreads) {
      const int m = m0 + r;
      if (m >= a.M) continue;
      a.out[(long long)m * nblk + blockIdx.x] =
          (rows[0][r][0] + rows[0][r][1]) + (rows[0][r][2] + rows[0][r][3]);
      a.out[((long long)a.M + m) * nblk + blockIdx.x] =
          (rows[1][r][0] + rows[1][r][1]) + (rows[1][r][2] + rows[1][r][3]);
    }
  }
}

template <int NT>
__global__ void __launch_bounds__(bm::tc::kThreads, 1)
    dbm_gemm_act_kernel(const __grid_constant__ DbmGemmArgs p) {
  bm::tc::NoPrologue pro;
  gemm_act<NT>(p, pro);
}

// An AIS beta's first launch: the update of the beta before (p.pending) in
// the tile's prologue, while the ring's first loads are in flight.  A
// kernel of its own, so that the prologue's registers stay out of every
// other launch's main loop.
template <int NT>
__global__ void __launch_bounds__(bm::tc::kThreads, 1)
    ais_gemm_act_kernel(const __grid_constant__ DbmGemmArgs p) {
  PendingLogw pro(p.pending);
  gemm_act<NT>(p, pro);
}

// Block b owns kColTile consecutive columns of one bias vector (the
// vectors' blocks follow each other: a.first).  Its row groups (colwalk.cuh)
// load a chunk of up to kBiasChunk rows of D and of P and stage them in
// shared memory; then warp 0 adds D's column values in row order and warp 1
// P's, the order of one thread walking each column, so the sums are those
// bits.  Then, per column: grad = sum D / N - sum P / M; with sparsity the
// EMAs of the batch sums and the penalty cost (q - t) + cost (mu - t),
// subtracted from grad and written to pen for the association update; and
// the momentum update of the bias.
template <int VW>
__global__ void __launch_bounds__(bm::col::kColThreads)
    dbm_bias_update_kernel(const __grid_constant__ BiasArgs a) {
  using Map = bm::col::Map<VW>;
  constexpr int T = bm::col::kColTile, G = Map::kGroups;
  __shared__ __align__(16) float stage[2][kBiasChunk][T];
  __shared__ float sum_p[T];
  int v = 0;
  while (v + 1 < a.n_vecs && (int)blockIdx.x >= a.first[v + 1]) ++v;
  const BiasVec& d = a.v[v];
  const int n = d.n, j0 = ((int)blockIdx.x - a.first[v]) * T;
  const int g = Map::group(), c = Map::col();
  // with VW = 4 the width is a multiple of 4: a lane's columns are all in
  // or all out
  const bool in = j0 + c < n;
  const int side = threadIdx.x / T, t = threadIdx.x % T;  // side < 2: adds
  // the column's parameters, loaded while the rows are
  const int j = j0 + t;
  const bool owner = side == 0 && j < n;
  float db = 0.f, bj = 0.f, qj = 0.f, mj = 0.f;
  if (owner) {
    db = d.db[j];
    bj = d.b[j];
    if (d.q != nullptr) {
      qj = d.q[j];
      mj = d.mu_m[j];
    }
  }
  float S = 0.f;
  for (int r0 = 0; r0 < a.N || r0 < a.M; r0 += kBiasChunk) {
    const int nd = min(kBiasChunk, a.N - r0), np = min(kBiasChunk, a.M - r0);
#pragma unroll 4
    for (int r = g; in && r < nd; r += G) {
      float x[VW];
      bm::col::load<VW>(d.D + (long long)(r0 + r) * n + j0 + c, x);
#pragma unroll
      for (int k = 0; k < VW; ++k) stage[0][r][c + k] = x[k];
    }
#pragma unroll 4
    for (int r = g; in && r < np; r += G) {
      float x[VW];
      bm::col::load<VW>(d.P + (long long)(r0 + r) * n + j0 + c, x);
#pragma unroll
      for (int k = 0; k < VW; ++k) stage[1][r][c + k] = x[k];
    }
    __syncthreads();
    if (side < 2) {
      // unrolled, so the shared-memory loads of 16 rows are in flight
      // before their adds, which keep their order
      const int rows = side == 0 ? nd : np;
#pragma unroll 16
      for (int r = 0; r < rows; ++r) S += stage[side][r][t];
    }
    __syncthreads();
  }
  if (side == 1) sum_p[t] = S;
  __syncthreads();
  if (!owner) return;
  const float sd = S, sp = sum_p[t];
  float grad = sd / (float)a.N - sp / (float)a.M;
  if (d.q != nullptr) {
    const float qn = a.damp * qj + a.one_minus_damp * sp;
    const float mn = a.damp * mj + a.one_minus_damp * sd;
    const float p = d.cost * (qn - d.target) + d.cost * (mn - d.target);
    d.q[j] = qn;
    d.mu_m[j] = mn;
    d.pen[j] = p;
    grad = grad - p;
  }
  const float acc = a.lr * (a.mom * db + grad);
  d.db[j] = acc;
  d.b[j] = bj + acc;
}

// W[:, j] *= min(|w_j|, c) / max(|w_j|, 1e-8), per column.  A block owns
// kNormTile columns and all n_in rows; its row groups (colwalk.cuh: 2 lanes
// of 16 bytes per row, 16 rows per warp) split the rows.  Pass 1 keeps up
// to kNormHold of each thread's values in registers and sums their squares;
// the lanes of a warp that hold the same columns add their sums by a
// shuffle tree, the warps' sums are added in order in shared memory, and
// one thread per column takes the norm.  Pass 2 scales the held values and
// stores them; rows beyond what a thread holds (n_in > 896) are read a
// second time.
template <int VW>
__global__ void __launch_bounds__(bm::col::kColThreads)
    dbm_max_norm_kernel(float* W, int n_in, int n_out, float max_norm) {
  using Map = bm::col::Map<VW, kNormTile>;
  constexpr int T = kNormTile, G = Map::kGroups;
  constexpr int LPR = Map::kLanesPerRow, P = kNormHold / VW;
  __shared__ float red[bm::col::kColThreads / 32][T];
  __shared__ float num[T], den[T];
  const int j0 = (int)blockIdx.x * T;
  const int g = Map::group(), c = Map::col();
  const bool in = j0 + c < n_out;
  float* col = W + j0 + c;

  float held[P][VW], sq[VW];
#pragma unroll
  for (int k = 0; k < VW; ++k) sq[k] = 0.f;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int r = p * G + g;
    if (!in || r >= n_in) continue;
    bm::col::load<VW>(col + (long long)r * n_out, held[p]);
#pragma unroll
    for (int k = 0; k < VW; ++k) sq[k] = fmaf(held[p][k], held[p][k], sq[k]);
  }
  for (int r = P * G + g; in && r < n_in; r += G) {
    float w[VW];
    bm::col::load<VW>(col + (long long)r * n_out, w);
#pragma unroll
    for (int k = 0; k < VW; ++k) sq[k] = fmaf(w[k], w[k], sq[k]);
  }
  // lanes l and l ^ o (o >= LPR) hold the same columns of other rows
#pragma unroll
  for (int o = 16; o >= LPR; o >>= 1)
#pragma unroll
    for (int k = 0; k < VW; ++k)
      sq[k] += __shfl_xor_sync(0xffffffffu, sq[k], o);
  if ((threadIdx.x & 31) < LPR)
#pragma unroll
    for (int k = 0; k < VW; ++k) red[threadIdx.x >> 5][c + k] = sq[k];
  __syncthreads();
  if (threadIdx.x < T) {
    float t = 0.f;
    for (int w = 0; w < bm::col::kColThreads / 32; ++w)
      t += red[w][threadIdx.x];
    const float norm = sqrtf(t);
    num[threadIdx.x] = fminf(norm, max_norm);
    den[threadIdx.x] = fmaxf(norm, 1e-8f);
  }
  __syncthreads();
  float f_num[VW], f_den[VW];
#pragma unroll
  for (int k = 0; k < VW; ++k) {
    f_num[k] = num[c + k];
    f_den[k] = den[c + k];
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int r = p * G + g;
    if (!in || r >= n_in) continue;
#pragma unroll
    for (int k = 0; k < VW; ++k) held[p][k] = held[p][k] * f_num[k] / f_den[k];
    bm::col::store<VW>(col + (long long)r * n_out, held[p]);
  }
  for (int r = P * G + g; in && r < n_in; r += G) {
    float w[VW];
    bm::col::load<VW>(col + (long long)r * n_out, w);
#pragma unroll
    for (int k = 0; k < VW; ++k) w[k] = w[k] * f_num[k] / f_den[k];
    bm::col::store<VW>(col + (long long)r * n_out, w);
  }
}

// msre = mean((X - v_means)^2) over the n = B x V elements, and the
// mean-field update count of the minibatch.  A grid of up to `max_blocks`
// blocks walks the elements, VW at a time (16-byte loads with VW = 4); each
// block adds its threads' sums by block_sum and writes one partial; the
// last block to finish adds the partials in a fixed order (one a thread,
// then block_sum), writes both outputs and re-arms the counter.  The grid
// depends only on n, VW and max_blocks, and no float is added atomically,
// so two launches on the same inputs give the same bits.
template <int VW>
__global__ void __launch_bounds__(kRedThreads)
    dbm_msre_kernel(const float* __restrict__ X,
                    const float* __restrict__ vm, long long n,
                    const unsigned* ctrl, float* partials, unsigned* counter,
                    float* msre_out, float* nmf_out) {
  __shared__ float red[kRedThreads / 32];
  __shared__ bool is_last;
  float s = 0.f;
#pragma unroll 4
  for (long long e = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * VW;
       e < n; e += (long long)gridDim.x * blockDim.x * VW) {
    float x[VW], m[VW];
    bm::col::load<VW>(X + e, x);
    bm::col::load<VW>(vm + e, m);
#pragma unroll
    for (int k = 0; k < VW; ++k) {
      const float d = x[k] - m[k];
      s = fmaf(d, d, s);
    }
  }
  const float t = block_sum(s, red);
  if (threadIdx.x == 0) partials[blockIdx.x] = t;
  if (!bm::last_block(counter, &is_last)) return;
  float p = 0.f;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += blockDim.x)
    p += __ldcg(&partials[b]);
  const float total = block_sum(p, red);
  if (threadIdx.x == 0) {
    *msre_out = total / (float)n;
    *nmf_out = (float)reinterpret_cast<const int*>(ctrl)[2];
    *counter = 0u;
  }
}

// The last beta's update of an AIS run, launched alone: one warp a run.
__global__ void __launch_bounds__(kRedThreads)
    ais_logw_kernel(const __grid_constant__ AisLogw u) {
  const int r = blockIdx.x * (kRedThreads / 32) + (int)(threadIdx.x >> 5);
  if (r >= u.R) return;
  LogwTerms t;
  logw_load(u, r, t);
  logw_finish(u, r, t);
}

// The products of `a` as the tile's operands, and its plan.
int setup(DbmGemmArgs* p, const GemmArgs& a) {
  bm::tc::Operand ops[2];
  int n = 0;
  const float* as[2] = {a.a1, a.a2};
  const float* bs[2] = {a.b1, a.b2};
  const long long sam[2] = {a.sam1, a.sam2}, sak[2] = {a.sak1, a.sak2};
  const long long sbk[2] = {a.sbk1, a.sbk2}, sbn[2] = {a.sbn1, a.sbn2};
  const int ks[2] = {a.k1, a.k2};
  for (int i = 0; i < 2; ++i) {
    if (as[i] == nullptr || ks[i] <= 0) continue;
    if (sak[i] != 1 || (sbn[i] != 1 && sbk[i] != 1))
      return (int)cudaErrorInvalidValue;
    const int w_trans = sbn[i] != 1;
    ops[n++] = {as[i], bs[i], sam[i], w_trans ? sbn[i] : sbk[i], ks[i],
                w_trans};
  }
  p->a = a;
  p->ctrl = nullptr;
  p->sweep = p->max_updates = 0;
  p->tol = 0.f;
  p->pending = AisLogw();
  return bm::tc::setup_tile(&p->t, ops, n, a.M, a.N, a.n_tile, a.splits,
                            a.ws, a.counters);
}

int launch(const DbmGemmArgs& p, cudaStream_t stream) {
  int err = 0;
  BM_TC_DISPATCH(dbm_gemm_act_kernel, p.t, p, stream, err);
  return err;
}

int launch_ais(const DbmGemmArgs& p, cudaStream_t stream) {
  int err = 0;
  BM_TC_DISPATCH(ais_gemm_act_kernel, p.t, p, stream, err);
  return err;
}

}  // namespace

extern "C" {

// Number of column blocks of a launch (the tile's 128 model columns per
// block): the partials of kSoftplusRows hold 2 * M * gemm_col_blocks(N)
// floats.
int bm_dbm_gemm_col_blocks(int N) {
  return (N + bm::tc::kTileM - 1) / bm::tc::kTileM;
}

int bm_dbm_gemm_act(const GemmArgs* a, void* stream) {
  DbmGemmArgs p;
  const int err = setup(&p, *a);
  return err ? err : launch(p, (cudaStream_t)stream);
}

// The first launch of an AIS beta: bm_dbm_gemm_act with the log-weight
// update of the beta before (`pending`, may be null: none) in its prologue.
// The update must read nothing that this launch writes.
int bm_ais_gemm_act(const GemmArgs* a, const AisLogw* pending, void* stream) {
  DbmGemmArgs p;
  const int err = setup(&p, *a);
  if (err) return err;
  if (pending == nullptr) return launch(p, (cudaStream_t)stream);
  p.pending = *pending;
  return launch_ais(p, (cudaStream_t)stream);
}

// Zero the mean-field control words (five: mf_change).
int bm_dbm_mf_reset(unsigned* ctrl, void* stream) {
  cudaMemsetAsync(ctrl, 0, 5 * sizeof(unsigned), (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// `n_sweeps` mean-field sweeps: per sweep the `n_layers` layer launches of
// `layers` (each kSigmoidDelta), which fold their change into the sweep's
// word of ctrl and return at once when ctrl's done flag is set; the first
// of them also runs the check of the sweep before (tol, max_updates).  The
// layers' tiles are set up once for all sweeps.  The budget is the sweeps
// enqueued, so max_updates must equal n_sweeps.
int bm_dbm_mf_loop(const GemmArgs* layers, int n_layers, int n_sweeps,
                   unsigned* ctrl, float tol, int max_updates, void* stream) {
  if (n_layers < 1 || ctrl == nullptr || n_sweeps < 0 ||
      max_updates != n_sweeps)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  std::vector<DbmGemmArgs> p(n_layers);
  for (int l = 0; l < n_layers; ++l) {
    if (layers[l].act != kSigmoidDelta) return (int)cudaErrorInvalidValue;
    const int e = setup(&p[l], layers[l]);
    if (e) return e;
    p[l].a.done = reinterpret_cast<const int*>(ctrl + 1);
  }
  p[0].ctrl = ctrl;
  p[0].tol = tol;
  p[0].max_updates = max_updates;
  for (int it = 0; it < n_sweeps; ++it) {
    p[0].sweep = it;
    for (int l = 0; l < n_layers; ++l) {
      p[l].a.delta_bits = ctrl + mf_change(it);
      const int e = launch(p[l], s);
      if (e) return e;
    }
  }
  return 0;
}

// The bias updates of `n_vecs` vectors (1 <= n_vecs <= kMaxBias) in one
// launch: a block per 32 columns of each; 16 bytes a lane where every width
// is a multiple of 4 and every D and P 16-byte aligned.
int bm_dbm_bias_update(const BiasVec* vecs, int n_vecs, int N, int M,
                       float lr, float mom, float damp, float one_minus_damp,
                       void* stream) {
  if (n_vecs < 1 || n_vecs > kMaxBias || N < 1 || M < 1)
    return (int)cudaErrorInvalidValue;
  BiasArgs a;
  a.first[0] = 0;
  bool vec = true;
  for (int i = 0; i < n_vecs; ++i) {
    a.v[i] = vecs[i];
    const void* ptrs[] = {vecs[i].D, vecs[i].P};
    vec = vec && vecs[i].n % 4 == 0 && bm::col::aligned16(ptrs, 2);
    a.first[i + 1] =
        a.first[i] + (vecs[i].n + bm::col::kColTile - 1) / bm::col::kColTile;
  }
  a.n_vecs = n_vecs;
  a.N = N;
  a.M = M;
  a.lr = lr;
  a.mom = mom;
  a.damp = damp;
  a.one_minus_damp = one_minus_damp;
  const int blocks = a.first[n_vecs];
  if (blocks < 1) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (vec)
    dbm_bias_update_kernel<4><<<blocks, bm::col::kColThreads, 0, s>>>(a);
  else
    dbm_bias_update_kernel<1><<<blocks, bm::col::kColThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

int bm_dbm_assoc_update(const float* Ad, const float* Bd, const float* Ap,
                        const float* Bp, const float* pen, int N, int M,
                        int n_in, int n_out, float* W, float* dW, float lr,
                        float mom, float l2, void* stream) {
  // Ad^T Bd / N - Ap^T Bp / M: each stage of a product scaled as it is
  // added to the block's sum (1/N, -1/M, rounded once each)
  return bm::tc::launch_assoc(Ad, Bd, N, 1.f / (float)N, Ap, Bp, M,
                              -1.f / (float)M, n_in, n_out, bm::tc::kAssocDbm,
                              W, dW, pen, 1.f, lr, mom, l2,
                              (cudaStream_t)stream);
}

// One block per kNormTile columns; 16 bytes a lane where n_out is a
// multiple of 4 and W 16-byte aligned.  A max-norm that is not finite
// leaves W as it is (the plain version's rule) and launches nothing.
int bm_dbm_max_norm(float* W, int n_in, int n_out, float max_norm,
                    void* stream) {
  if (!isfinite(max_norm) || n_in <= 0 || n_out <= 0) return 0;
  const int blocks = (n_out + kNormTile - 1) / kNormTile;
  const void* w[] = {W};
  const bool vec = n_out % 4 == 0 && bm::col::aligned16(w, 1);
  if (vec)
    dbm_max_norm_kernel<4><<<blocks, bm::col::kColThreads, 0,
                             (cudaStream_t)stream>>>(W, n_in, n_out, max_norm);
  else
    dbm_max_norm_kernel<1><<<blocks, bm::col::kColThreads, 0,
                             (cudaStream_t)stream>>>(W, n_in, n_out, max_norm);
  return (int)cudaGetLastError();
}

// `partials` holds max_blocks floats, `counter` one zeroed unsigned (left
// at zero).  16 bytes a lane where n is a multiple of 4 and X and vm are
// 16-byte aligned; blocks enough for one load a thread, at most max_blocks.
int bm_dbm_msre(const float* X, const float* vm, long long n,
                const unsigned* ctrl, float* partials, int max_blocks,
                unsigned* counter, float* msre_out, float* nmf_out,
                void* stream) {
  if (n < 1 || max_blocks < 1) return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {X, vm};
  const int vw = n % 4 == 0 && bm::col::aligned16(ptrs, 2) ? 4 : 1;
  const long long per_block = (long long)kRedThreads * vw;
  const long long want = (n + per_block - 1) / per_block;
  const int blocks = (int)(want < max_blocks ? want : max_blocks);
  const cudaStream_t s = (cudaStream_t)stream;
  if (vw == 4)
    dbm_msre_kernel<4><<<blocks, kRedThreads, 0, s>>>(
        X, vm, n, ctrl, partials, counter, msre_out, nmf_out);
  else
    dbm_msre_kernel<1><<<blocks, kRedThreads, 0, s>>>(
        X, vm, n, ctrl, partials, counter, msre_out, nmf_out);
  return (int)cudaGetLastError();
}

// The update of one AIS beta alone (the last of a run): kRedThreads / 32
// runs a block.
int bm_ais_logw(const float* x, const float* hb0, int R, int H1,
                const float* part_v, int nblk_v, const float* part_h2,
                int nblk_h2, float beta_lo, float beta_hi, float* log_w,
                void* stream) {
  if (R < 1) return (int)cudaErrorInvalidValue;
  const AisLogw u = {x,  hb0,    part_v,  part_h2, log_w,
                     R,  H1,     nblk_v,  nblk_h2, beta_lo, beta_hi};
  constexpr int kRuns = kRedThreads / 32;
  ais_logw_kernel<<<(R + kRuns - 1) / kRuns, kRedThreads, 0,
                    (cudaStream_t)stream>>>(u);
  return (int)cudaGetLastError();
}

}  // extern "C"
