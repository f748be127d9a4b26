// CD-k epoch of an RBM, hand-written for Hopper (sm_90a): Bernoulli or
// Gaussian visible units, Bernoulli or multinomial hidden units.
//
// Replaces the TPU's fused epoch kernel `make_cd_epoch_kernel` /
// `_cd_epoch_kernel` (boltzmann_machines_tpu/ops/pallas_ops.py:1266, body
// :262-509, `sub_tiles == 1` branch) and its hidden-tiled twin
// `make_tiled_cd_epoch_kernel` / `_tiled_cd_epoch_kernel` (:726, body
// :512-723).  On the TPU one pallas_call runs the whole epoch with W resident
// in VMEM, and the tiled twin exists only because a 3072x5000 W + dW does
// not fit there: it streams (V, 1024) tiles of W through double-buffered DMA
// and pads H to 128.  Hopper has no such memory, so W and dW always live in
// device memory (and the 50 MB L2); the kernels below compute both TPU
// kernels' function at any V and H, with no tiling and no padding.  Each
// minibatch runs as a short sequence of launches on one stream:
//
//   K1 cd_gemm_act      1 + 2k per step.  The tensor-core tile of
//                       gemm_tc.cuh (X.W, h.W^T and v.W alike: W is read
//                       as it lies, either way).  Epilogues:
//                       sigmoid(mult*(acc + bias)) with Philox-thresholded
//                       states (Bernoulli);
//                       mult*(acc*sigma + vb) with states + sigma*Box-Muller
//                       (Gaussian visible, pallas_ops.py:321-330); or the
//                       pre-activation mult*(acc + bias) for K1b.  Replaces
//                       the chain of :300-345 (tiled: :584-633).
//   K1b cd_softmax_sample  multinomial hidden units only, after each hidden
//                       K1: one block per row computes means = n softmax(pre)
//                       (:307-314) and, when sampling, exact Multinomial(n,
//                       means/n) counts (`_multinomial_sample_bits`, :130-182,
//                       the body of the TPU's `multinomial_sample`).
//   K2 cd_bias_stats    column sums over the batch (dvb, dhb, h_sum, msre
//                       partial), the sparsity EMA and penalty, and the
//                       vb/hb/dvb/dhb/q updates.  Replaces :353-356, :425-441
//                       (tiled: :635-651).  Bound by its bytes: X, v_states
//                       and v_means (B x V), h0 and h_means (B x H) read
//                       once, 7.7 MB at 3072x5000 and B = 100 (2.3 us at
//                       3.35 TB/s), 176 KB at 784x1024 and B = 10, where
//                       the launch's latency is the floor.  A block owns 32
//                       columns, all visible or all hidden, and its eight
//                       warps load the batch's rows at once, 16 bytes a
//                       lane along rows (colwalk.cuh), so (V + H) / 32
//                       blocks (253 at 3072x5000) share the loads that one
//                       thread per column made in a chain; the terms are
//                       staged in shared memory and added in row order, so
//                       the sums keep the bits of that walk.  K2s runs the
//                       same body, so its sums are K2's bit for bit (the
//                       data-parallel checks pin it).
//   K3 cd_assoc_update  X^T h0 - v^T h (contraction over the batch) on the
//                       tensor cores, with the momentum update of dW and W
//                       in place as epilogue (assoc_tc.cuh); each (i, j) has
//                       one owner, and it reads the old W for the L2 term.
//                       Replaces :348-352, :425, :433-439 (tiled: :653-714).
//   K4 cd_metrics       only where it % every == 0 (the host knows `it`, so
//                       no readback): L2 of the new W, msre, and the PLL with
//                       one flipped unit per row on the new parameters, with
//                       the per-flavour free energy of `_free_energy_sum`
//                       (:185-205, the body of `make_free_energy_probe`):
//                       Gaussian 0.5 sum (x - vb/sigma)^2, multinomial
//                       -x.vb - (xW).h_hat with one uniform-multinomial h_hat
//                       per evaluation drawn by K1b's device functions.
//                       Replaces :443-509 (the tiled kernel had no PLL).
//
// The data-parallel epoch's per-shard statistics (the TPU's
// `make_cd_stats_kernel` / `_cd_stats_kernel`, :1206, body :1086-1151, and
// its W-streaming twin `make_tiled_cd_stats_kernel` /
// `_tiled_cd_stats_kernel`, :991, body :840-988, which exists on the TPU only
// because a 3072x7800 W and its association overflow VMEM) are the same
// chain without the update, 3 + 2k launches per local minibatch:
//
//   K1 cd_gemm_act      1 + 2k, as above, drawing under the shard word of
//                       the counter (philox.cuh), so each rank's rows get
//                       their own stream (the TPU mixes the shard into the
//                       seed, :1096-1100).  Shard 0 draws what the epoch
//                       kernels draw.
//   K2s cd_stats_sums   dvb_sum = sum(X - v_states), dhb_sum = sum(h0 -
//                       h_means), h_sum = sum(h_means) over the local batch,
//                       the column sums K2 takes, without the update
//                       (:1148-1150): K2's kernel body with the update, the
//                       v_means loads and the msre term compiled out, on
//                       K2's grid ((V + H) / 32 blocks: 57 at 784x1024, 340
//                       at 3072x7800).  Bound by its bytes, the four (B, .)
//                       inputs read once: 1.86 MB at 784x1024 / 128 rows
//                       (0.56 us at 3.35 TB/s), 4.4 MB at 3072x7800 / 50.
//   K3s cd_assoc_stats  X^T h0 - v^T h (:1142-1147): K3's contraction without
//                       the momentum epilogue.
//
// Both write straight into the caller's flat buffer [assoc | dvb_sum |
// dhb_sum | h_sum], which is all-reduced across the ranks as one block;
// the update then runs replicated in torch ops, as the TPU left it to XLA.
// No padding and no tiling: H = 7800 needs only the GEMM's edge masks.
// What bounds it: at 3072x7800 and a local batch of 50 (two ranks of the
// G-RBM's 100), the five products are 2BVH operations each, 12 GFLOP in all
// (0.07 ms at 3xTF32's 165 TFLOP/s), against W read once and the
// association written once (192 MB, 0.057 ms).  K1 runs on the tensor-core
// tile, K3s on the association kernel, as in the epoch.
//
// Three standalone launchers share these device functions: bm_normal_sample
// (the TPU's `normal_sample`, :95), bm_bernoulli_sample (`bernoulli_sample`,
// :74, the threshold of K1's Bernoulli epilogue) and bm_fe_probe
// (`make_free_energy_probe`, :208); bm_cd_softmax_sample on given means is
// `multinomial_sample` (:106).
//
// Ordering: every K1 of a step reads the old vb/hb before K2 writes them; K3
// needs K2's penalty vector; K4 reads the new W, vb, hb.  One stream, in
// order, no host synchronisation inside an epoch.
//
// What bounds it on an H100.  At 784x1024 the step is a few MFLOP (batch 10)
// to ~2 GFLOP (batch 256); at the CIFAR shapes (3072x5000 and 5000x1000,
// batch 100) ~15 and ~5 GFLOP, and W + dW (123 MB and 40 MB) are read and
// written once per step: ~0.13 ms of bytes at 3072x5000 (PERF.md).  K1's
// products run on the tensor-core tile of gemm_tc.cuh (swap-AB wgmma in
// 3xTF32, a TMA-fed ring, deterministic split-K; its note says what bounds
// each product and what the design does about it).  K3's contraction over
// the batch is another shape (K = B, a V x H output, bound by W and dW's
// bytes): the association kernel of assoc_tc.cuh, the same main loop with
// its operands transposed and the update as a TMA-fed epilogue.  CUDA
// graphs or one persistent kernel per epoch are later work.
//
// The multinomial pass is bound by neither: per row it scans H entries and
// binary-searches n draws.  Its design choices are about exactness, not
// speed.  The CDF of means/n is accumulated in float64 (warp 0, 32 chunks)
// and rounded to float32 per entry, as the plain version does with a float64
// cumsum, so both build the same CDF except in ties at float64 rounding; the
// counts are integers in a shared-memory histogram (atomicAdd), exact and
// independent of order.  This replaces the TPU's n*B*H bucket compares and
// its two HIGHEST-precision matmuls, whose bf16 default broke the counts
// (:138-147): integer histograms cannot round.
//
// K4 and bm_fe_probe give each of B blocks one row x and let each thread
// walk whole columns of W (from L2): 2BVH operations against a bound of
// ~15 us at 5000x1000, B = 100, but each thread's column walk waits on its
// loads.  The loop is unrolled 8 deep to keep eight loads in flight, and
// the probe (no flipped row) skips the flipped sums.  Turning the walk into
// a GEMM over the batch is later work.
//
// The Gaussian epilogue writes fl(fl(acc*sigma) + vb) times the multiplier
// (1 or 2, so exact) with __fmul_rn/__fadd_rn, and the sample
// fl(means + fl(z*sigma)), the plain version's operations in its order.  The
// library is built without --use_fast_math, so Box-Muller's logf, cosf and
// sqrtf stay within an ulp or two of torch's.
//
// The activations and the block reduction live in gemm.cuh, the
// tensor-core tile (K1) in gemm_tc.cuh, the association kernel (K3, K3s) in
// assoc_tc.cuh; all are shared with dbm_ops.cu.
//
// C interface (bound with ctypes by ops/cd_epoch.py, ops/cd_stats.py and
// ops/samplers.py):
// every entry launches on the given stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "assoc_tc.cuh"
#include "colwalk.cuh"
#include "gemm.cuh"
#include "gemm_tc.cuh"
#include "philox.cuh"

namespace {

using bm::block_sum;
using bm::sigmoid;
using bm::softplus;

constexpr int kMetThreads = 256;
constexpr int kRowThreads = 256;
// K2: batch rows staged in shared memory at a time (2 x 128 x 32 floats)
constexpr int kK2Chunk = 128;
constexpr int kStaticSmemLimit = 48 * 1024;

// epilogues of cd_gemm_act (ops/cd_epoch.py ACT_*)
constexpr int kActSigmoid = 0, kActGaussian = 1, kActPre = 2;

__device__ __forceinline__ float log_sigmoid(float x) {
  return x < 0.f ? x - log1pf(expf(x)) : -log1pf(expf(-x));
}

// Max (is_max) or sum over the block, returned to every thread.  `red`
// holds one float per warp plus one.  Must be called by all threads.
__device__ float block_reduce_all(float v, float* red, bool is_max) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float t = __shfl_down_sync(0xffffffffu, v, o);
    v = is_max ? fmaxf(v, t) : v + t;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = (int)(blockDim.x >> 5);
  __syncthreads();  // `red` may still be read by a previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = red[0];
    for (int w = 1; w < n_warps; ++w) t = is_max ? fmaxf(t, red[w]) : t + red[w];
    red[n_warps] = t;
  }
  __syncthreads();
  return red[n_warps];
}

// In place: buf[0..H) holds expected counts (means), leaves the float32 CDF
// of means/n with buf[H-1] = +inf (the last bucket absorbs rounding).  The
// running sum is float64, as the plain version's float64 cumsum; warp 0
// sums 32 contiguous chunks and scans their totals.  All threads call it.
__device__ void build_cdf(float* buf, int H, int n) {
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int chunk = (H + 31) / 32;
    const int lo = min(lane * chunk, H), hi = min(lo + chunk, H);
    const double dn = (double)n;
    double s = 0.0;
    for (int i = lo; i < hi; ++i) s += (double)buf[i] / dn;
    double incl = s;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double t = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += t;
    }
    double run = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) run = 0.0;
    for (int i = lo; i < hi; ++i) {
      run += (double)buf[i] / dn;
      buf[i] = (float)run;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) buf[H - 1] = INFINITY;
  __syncthreads();
}

// The uniform-multinomial CDF of the Monte Carlo free energy: means
// float32(n) / float32(H) in every bucket.
__device__ void uniform_cdf(float* buf, int H, int n) {
  const float m = (float)n / (float)H;
  for (int h = threadIdx.x; h < H; h += blockDim.x) buf[h] = m;
  build_cdf(buf, H, n);
}

// counts[0..H) = histogram of n draws over `cdf`: draw j is the Philox
// uniform at element idx0 + j and lands in the first bucket whose CDF
// exceeds it (binary search; cdf[H-1] = +inf).  All threads call it.
__device__ void multinomial_draw(const float* cdf, int H, int n,
                                 unsigned seed, unsigned it, unsigned stream,
                                 unsigned idx0, int* counts) {
  for (int h = threadIdx.x; h < H; h += blockDim.x) counts[h] = 0;
  __syncthreads();
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const float u = bm::philox_uniform(seed, it, stream, idx0 + (unsigned)j);
    int lo = 0, hi = H - 1;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (u < cdf[mid])
        hi = mid;
      else
        lo = mid + 1;
    }
    atomicAdd(&counts[lo], 1);
  }
  __syncthreads();
}

// Free energy of the row x and, when kFlip, of x with unit `flip` set to
// 1 - x, block-wide, valid in thread 0 -- `_free_energy_sum` for one row:
// visible term -x.vb (Bernoulli, sigma == nullptr) or 0.5 sum (x -
// vb/sigma)^2 (Gaussian), hidden term -sum softplus(xW + hb) (Bernoulli,
// hhat == nullptr) or -(xW).hhat (multinomial; hhat_f for the flipped row).
// Without kFlip (the probe) the flipped sums are not formed at all.
template <bool kFlip>
__device__ void row_free_energies(const float* __restrict__ x, int flip,
                                  const float* __restrict__ W,
                                  const float* __restrict__ vb,
                                  const float* __restrict__ hb,
                                  const float* __restrict__ sigma,
                                  const int* hhat, const int* hhat_f, int V,
                                  int H, float* red, float* fe, float* fef) {
  const int tid = threadIdx.x;
  float tv = 0.f, tvf = 0.f;
  for (int v = tid; v < V; v += blockDim.x) {
    const float xv = x[v], xf = v == flip ? 1.f - xv : xv;
    if (sigma) {
      const float c = vb[v] / sigma[v], d = xv - c, df = xf - c;
      tv = fmaf(d, d, tv);
      if (kFlip) tvf = fmaf(df, df, tvf);
    } else {
      tv = fmaf(xv, vb[v], tv);
      if (kFlip) tvf = fmaf(xf, vb[v], tvf);
    }
  }
  float th = 0.f, thf = 0.f;
  for (int h = tid; h < H; h += blockDim.x) {
    float a = 0.f, af = 0.f;
    // the walk down column h of W is bound by the latency of its loads, not
    // by the FMAs: unrolled 8 deep, eight loads are in flight per thread
    // (the sums keep their order, so the result bits do not change)
#pragma unroll 8
    for (int v = 0; v < V; ++v) {
      const float xv = x[v], w = W[(long long)v * H + h];
      a = fmaf(xv, w, a);
      if (kFlip) af = fmaf(v == flip ? 1.f - xv : xv, w, af);
    }
    if (hhat) {
      th = fmaf(a, (float)hhat[h], th);
      if (kFlip) thf = fmaf(af, (float)hhat_f[h], thf);
    } else {
      th += softplus(a + hb[h]);
      if (kFlip) thf += softplus(af + hb[h]);
    }
  }
  const float s_tv = block_sum(tv, red), s_th = block_sum(th, red);
  *fe = sigma ? 0.5f * s_tv - s_th : -s_tv - s_th;
  if (kFlip) {
    const float s_tvf = block_sum(tvf, red), s_thf = block_sum(thf, red);
    *fef = sigma ? 0.5f * s_tvf - s_thf : -s_tvf - s_thf;
  }
}

// Arguments of one cd_gemm_act launch (a kernel parameter, so the tensor
// maps of the tile sit in parameter space).
struct CdGemmArgs {
  bm::tc::Tile t;
  const float* bias;
  const float* sigma;
  float* means;
  float* states;
  float mult;
  int act;
  unsigned seed, it, stream_id, shard;
};

// K1: means = act(A.B) per the epilogue `act`; states drawn if given.  The
// product is the tensor-core tile (gemm_tc.cuh); element (m, n) of the
// batch-major output is the Philox element m * N + n, as before the swap.
template <int NT>
__global__ void __launch_bounds__(bm::tc::kThreads, 1)
    cd_gemm_act_kernel(const __grid_constant__ CdGemmArgs a) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  float* T;
  if (!bm::tc::tile_product<NT>(a.t, tc_smem, T)) return;
  const int N = a.t.nm, m0 = blockIdx.x * bm::tc::kTileM, b0 = blockIdx.y * NT;
  for (int e = threadIdx.x; e < bm::tc::kTileM * NT; e += bm::tc::kThreads) {
    const int n = m0 + e % bm::tc::kTileM, m = b0 + e / bm::tc::kTileM;
    if (n >= N || m >= a.t.nb) continue;
    const float acc =
        T[(e / bm::tc::kTileM) * bm::tc::kTileStride + e % bm::tc::kTileM];
    const long long idx = (long long)m * N + n;
    if (a.act == kActGaussian) {
      // GaussianLayer.activation(mult x, mult vb) = mult (x sigma + vb)
      const float s = a.sigma[n];
      const float mu = a.mult * __fadd_rn(__fmul_rn(acc, s), a.bias[n]);
      a.means[idx] = mu;
      if (a.states)
        a.states[idx] = __fadd_rn(
            mu, __fmul_rn(bm::philox_normal(a.seed, a.it, a.stream_id,
                                            (unsigned)idx, a.shard),
                          s));
    } else if (a.act == kActPre) {
      a.means[idx] = a.mult * (acc + a.bias[n]);
    } else {
      const float p = sigmoid(a.mult * (acc + a.bias[n]));
      a.means[idx] = p;
      if (a.states) {
        const float u = bm::philox_uniform(a.seed, a.it, a.stream_id,
                                           (unsigned)idx, a.shard);
        a.states[idx] = u < p ? 1.f : 0.f;
      }
    }
  }
}

// K1b: block b owns row b.  from_pre: `in` holds pre-activations and the
// means n softmax(pre) go to `means`; else `in` holds the means.  With
// `states`, Multinomial(n, means/n) counts of the draws at elements b*n + j.
// Dynamic shared memory: H floats and H ints.
__global__ void __launch_bounds__(kRowThreads)
    cd_softmax_sample_kernel(const float* __restrict__ in, int from_pre,
                             int H, int n, float* __restrict__ means,
                             float* __restrict__ states, unsigned seed,
                             unsigned it, unsigned stream_id) {
  extern __shared__ float smem[];
  __shared__ float red[kRowThreads / 32 + 1];
  float* buf = smem;
  int* counts = reinterpret_cast<int*>(smem + H);
  const long long row = (long long)blockIdx.x * H;
  if (from_pre) {
    float m = -INFINITY;
    for (int h = threadIdx.x; h < H; h += blockDim.x) {
      const float x = in[row + h];
      buf[h] = x;
      m = fmaxf(m, x);
    }
    m = block_reduce_all(m, red, true);
    float s = 0.f;
    for (int h = threadIdx.x; h < H; h += blockDim.x) {
      const float e = expf(buf[h] - m);
      buf[h] = e;
      s += e;
    }
    s = block_reduce_all(s, red, false);
    const float fn = (float)n;
    for (int h = threadIdx.x; h < H; h += blockDim.x) {
      const float mu = fn * (buf[h] / s);
      buf[h] = mu;
      means[row + h] = mu;
    }
  } else {
    for (int h = threadIdx.x; h < H; h += blockDim.x) buf[h] = in[row + h];
  }
  if (!states) return;
  build_cdf(buf, H, n);
  multinomial_draw(buf, H, n, seed, it, stream_id,
                   (unsigned)blockIdx.x * (unsigned)n, counts);
  for (int h = threadIdx.x; h < H; h += blockDim.x)
    states[row + h] = (float)counts[h];
}

// K2: block b owns kColTile consecutive columns, all visible (b < nv) or
// all hidden.  Its row groups (colwalk.cuh) load a chunk of up to kK2Chunk
// rows at once and stage each element's terms in shared memory; then one
// thread per column adds them in row order, the order in which one thread
// per column walked the batch before, so the sums are those bits.  Visible:
// s = sum(X - v_states), e = sum((X - v_means)^2); hidden: s = sum(h0 -
// h_means), u = sum(h_means).  Then the update, one thread per column.
//
// K2s (kSums, cd_stats_sums) is the same body without the update and
// without v_means and e: it writes s and u as they are, into dvb (dvb_sum),
// dhb (dhb_sum) and q (h_sum).  So K2's sums equal K2s' bit for bit by
// construction (the data-parallel checks pin it).
template <int VW, bool kSums>
__global__ void __launch_bounds__(bm::col::kColThreads)
    cd_bias_stats_kernel(const float* __restrict__ X,
                         const float* __restrict__ vs,
                         const float* __restrict__ vm,
                         const float* __restrict__ h0,
                         const float* __restrict__ hm, int B, int V, int H,
                         float* vb, float* dvb, float* hb, float* dhb,
                         float* q, float* __restrict__ pen,
                         float* __restrict__ msre_col, float lr, float mom,
                         float damp, float one_minus_damp, float cost,
                         float target) {
  using Map = bm::col::Map<VW>;
  constexpr int T = bm::col::kColTile, G = Map::kGroups;
  // [0]: x - v_states or h0 - h_means; [1]: x - v_means or h_means
  __shared__ __align__(16) float stage[2][kK2Chunk][T];
  const int nv = (V + T - 1) / T;
  const bool visible = (int)blockIdx.x < nv;
  const int n = visible ? V : H;
  const int j0 = (visible ? (int)blockIdx.x : (int)blockIdx.x - nv) * T;
  const int g = Map::group(), c = Map::col();
  // with VW = 4 the width is a multiple of 4: a lane's columns are all in
  // or all out
  const bool in = j0 + c < n;
  const float* A = visible ? X : h0;
  const float* Bm = visible ? vs : hm;
  float S = 0.f, U = 0.f;  // column threadIdx.x's sums (threads < T)
  for (int b0 = 0; b0 < B; b0 += kK2Chunk) {
    const int rows = min(kK2Chunk, B - b0);
#pragma unroll 4
    for (int r = g; in && r < rows; r += G) {
      const long long idx = (long long)(b0 + r) * n + j0 + c;
      float a[VW], x[VW];
      bm::col::load<VW>(A + idx, a);
      bm::col::load<VW>(Bm + idx, x);
      if (visible) {
        if constexpr (kSums) {
#pragma unroll
          for (int k = 0; k < VW; ++k) stage[0][r][c + k] = a[k] - x[k];
        } else {
          float m[VW];
          bm::col::load<VW>(vm + idx, m);
#pragma unroll
          for (int k = 0; k < VW; ++k) {
            stage[0][r][c + k] = a[k] - x[k];
            stage[1][r][c + k] = a[k] - m[k];
          }
        }
      } else {
#pragma unroll
        for (int k = 0; k < VW; ++k) {
          stage[0][r][c + k] = a[k] - x[k];
          stage[1][r][c + k] = x[k];
        }
      }
    }
    __syncthreads();
    if (threadIdx.x < T) {
      // unrolled, so the shared-memory loads of 16 rows are in flight
      // before their adds, which keep their order
      const int t = threadIdx.x;
      if (visible) {
        if constexpr (kSums) {
#pragma unroll 16
          for (int r = 0; r < rows; ++r) S += stage[0][r][t];
        } else {
#pragma unroll 16
          for (int r = 0; r < rows; ++r) {
            S += stage[0][r][t];
            U = fmaf(stage[1][r][t], stage[1][r][t], U);
          }
        }
      } else {
#pragma unroll 16
        for (int r = 0; r < rows; ++r) {
          S += stage[0][r][t];
          U += stage[1][r][t];
        }
      }
    }
    __syncthreads();
  }
  const int j = j0 + (int)threadIdx.x;
  if (threadIdx.x >= T || j >= n) return;
  if constexpr (kSums) {
    if (visible) {
      dvb[j] = S;
    } else {
      dhb[j] = S;
      q[j] = U;
    }
    return;
  }
  const float nb = (float)B;
  if (visible) {
    const float acc = lr * (mom * dvb[j] + S / nb);
    dvb[j] = acc;
    vb[j] += acc;
    msre_col[j] = U;
  } else {
    // sparsity acts on the batch SUM of the chain-end hidden means
    const float qn = damp * q[j] + one_minus_damp * U;
    const float p = cost * (qn - target);
    q[j] = qn;
    pen[j] = p;
    const float acc = lr * (mom * dhb[j] + S / nb - p);
    dhb[j] = acc;
    hb[j] += acc;
  }
}

// K4: grid of B blocks (block b owns batch row b for the PLL); every block
// also sums a grid-strided slice of W^2.  The last block to finish reduces
// the per-block partials in a fixed order (deterministic) and writes the
// three metric rows, then re-arms the counter for the next launch.  With a
// multinomial PLL (n > 0) every block draws the same two count vectors
// (deterministic Philox) into dynamic shared memory: H floats, 2H ints.
__global__ void __launch_bounds__(kMetThreads)
    cd_metrics_kernel(const float* __restrict__ X, const float* __restrict__ W,
                      const float* __restrict__ vb,
                      const float* __restrict__ hb,
                      const float* __restrict__ sigma,
                      const float* __restrict__ msre_col, int B, int V, int H,
                      float l2, int compute_pll, int n, unsigned seed,
                      unsigned it, float* partials, unsigned* counter,
                      float* msre_out, float* pll_out, float* l2_out) {
  extern __shared__ float smem[];
  __shared__ float red[kMetThreads / 32];
  __shared__ int flip;
  __shared__ bool is_last;
  const int tid = threadIdx.x;

  const long long nw = (long long)V * H;
  float sq = 0.f;
  for (long long e = (long long)blockIdx.x * blockDim.x + tid; e < nw;
       e += (long long)gridDim.x * blockDim.x) {
    const float w = W[e];
    sq = fmaf(w, w, sq);
  }
  const float block_sq = block_sum(sq, red);

  float fe_row = 0.f, fef_row = 0.f;
  if (compute_pll && (int)blockIdx.x < B) {
    const int b = blockIdx.x;
    int *hhat = nullptr, *hhat_f = nullptr;
    if (n > 0) {
      // independent draws for fe(x) and fe(x_flipped) (pallas_ops.py:484)
      hhat = reinterpret_cast<int*>(smem + H);
      hhat_f = hhat + H;
      uniform_cdf(smem, H, n);
      multinomial_draw(smem, H, n, seed, it, bm::kStreamPllHhat, 0u, hhat);
      multinomial_draw(smem, H, n, seed, it, bm::kStreamPllHhatFlip, 0u,
                       hhat_f);
    }
    if (tid == 0) {
      const float u = bm::philox_uniform(seed, it, bm::kStreamPll, b);
      flip = (int)(u * (float)V);
    }
    __syncthreads();
    row_free_energies<true>(X + (long long)b * V, flip, W, vb, hb, sigma,
                            hhat, hhat_f, V, H, red, &fe_row, &fef_row);
  }

  if (tid == 0) {
    partials[3 * blockIdx.x + 0] = block_sq;
    partials[3 * blockIdx.x + 1] = fe_row;
    partials[3 * blockIdx.x + 2] = fef_row;
  }
  if (!bm::last_block(counter, &is_last)) return;

  float p_sq = 0.f, p_fe = 0.f, p_fef = 0.f, p_msre = 0.f;
  for (int g = tid; g < (int)gridDim.x; g += blockDim.x) {
    p_sq += __ldcg(&partials[3 * g + 0]);
    p_fe += __ldcg(&partials[3 * g + 1]);
    p_fef += __ldcg(&partials[3 * g + 2]);
  }
  for (int v = tid; v < V; v += blockDim.x) p_msre += msre_col[v];
  const float t_sq = block_sum(p_sq, red), t_fe = block_sum(p_fe, red);
  const float t_fef = block_sum(p_fef, red), t_msre = block_sum(p_msre, red);
  if (tid == 0) {
    *msre_out = t_msre / ((float)B * (float)V);
    *l2_out = l2 * 0.5f * t_sq;
    if (compute_pll) {
      // batch-MEAN free energies, x n_visible, no dbm doubling
      const float fe = t_fe / (float)B, fef = t_fef / (float)B;
      *pll_out = (float)V * log_sigmoid(fef - fe);
    }
    *counter = 0u;
  }
}

// The TPU's `normal_sample`: out[i] = Box-Muller of counter (i, stream).
__global__ void normal_sample_kernel(float* __restrict__ out,
                                     long long count, unsigned seed,
                                     unsigned it, unsigned stream_id) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < count; i += (long long)gridDim.x * blockDim.x)
    out[i] = bm::philox_normal(seed, it, stream_id, (unsigned)i);
}

// The TPU's `bernoulli_sample`: out[i] = 1 if the Philox uniform of counter
// (i, 0) under key (w0, w1) is below p[i], else 0 -- K1's Bernoulli draw.
__global__ void bernoulli_sample_kernel(const float* __restrict__ p,
                                        float* __restrict__ out,
                                        long long count, unsigned w0,
                                        unsigned w1) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < count; i += (long long)gridDim.x * blockDim.x)
    out[i] = bm::philox_uniform(w0, w1, 0u, (unsigned)i) < p[i] ? 1.f : 0.f;
}

// The TPU's `make_free_energy_probe`: block b owns row b; the last block
// reduces the row free energies in a fixed order and writes the batch mean
// and the count vector (every block drew the same one; zeros for Bernoulli
// hidden units).  Dynamic shared memory for n > 0: H floats and H ints.
__global__ void __launch_bounds__(kMetThreads)
    fe_probe_kernel(const float* __restrict__ X, const float* __restrict__ W,
                    const float* __restrict__ vb,
                    const float* __restrict__ hb,
                    const float* __restrict__ sigma, int B, int V, int H,
                    int n, unsigned seed, float* partials, unsigned* counter,
                    float* fe_out, float* hhat_out) {
  extern __shared__ float smem[];
  __shared__ float red[kMetThreads / 32];
  __shared__ bool is_last;
  const int tid = threadIdx.x;
  int* hhat = nullptr;
  if (n > 0) {
    hhat = reinterpret_cast<int*>(smem + H);
    uniform_cdf(smem, H, n);
    multinomial_draw(smem, H, n, seed, 0u, bm::kStreamPllHhat, 0u, hhat);
  }
  float fe;
  row_free_energies<false>(X + (long long)blockIdx.x * V, -1, W, vb, hb,
                           sigma, hhat, nullptr, V, H, red, &fe, nullptr);
  if (tid == 0) partials[blockIdx.x] = fe;
  if (!bm::last_block(counter, &is_last)) return;
  float p = 0.f;
  for (int g = tid; g < B; g += blockDim.x) p += __ldcg(&partials[g]);
  const float t = block_sum(p, red);
  for (int h = tid; h < H; h += blockDim.x)
    hhat_out[h] = hhat ? (float)hhat[h] : 0.f;
  if (tid == 0) {
    *fe_out = t / (float)B;
    *counter = 0u;
  }
}

// Dynamic shared memory above the 48 KB default must be granted per kernel.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= (size_t)kStaticSmemLimit) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// K2 or K2s: one block per kColTile columns of V, then of H; 16 bytes a
// lane where V and H are multiples of 4 and the batch-major inputs (vm
// only where K2 reads it) are 16-byte aligned.
template <bool kSums>
int launch_k2(const float* X, const float* vs, const float* vm,
              const float* h0, const float* hm, int B, int V, int H,
              float* vb, float* dvb, float* hb, float* dhb, float* q,
              float* pen, float* msre_col, float lr, float mom, float damp,
              float one_minus_damp, float cost, float target,
              cudaStream_t s) {
  constexpr int T = bm::col::kColTile;
  const int blocks = (V + T - 1) / T + (H + T - 1) / T;
  const void* rows[] = {X, vs, h0, hm, vm};
  const bool vec = V % 4 == 0 && H % 4 == 0 &&
                   bm::col::aligned16(rows, kSums ? 4 : 5);
  if (vec)
    cd_bias_stats_kernel<4, kSums><<<blocks, bm::col::kColThreads, 0, s>>>(
        X, vs, vm, h0, hm, B, V, H, vb, dvb, hb, dhb, q, pen, msre_col, lr,
        mom, damp, one_minus_damp, cost, target);
  else
    cd_bias_stats_kernel<1, kSums><<<blocks, bm::col::kColThreads, 0, s>>>(
        X, vs, vm, h0, hm, B, V, H, vb, dvb, hb, dhb, q, pen, msre_col, lr,
        mom, damp, one_minus_damp, cost, target);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// A(m, k) = A[m*sam + k*sak] with sak == 1; B(k, n) = Bm[k*sbk + n*sbn]
// with sbn == 1 (W as it is) or sbk == 1 (W^T).  The plan (n_tile, splits)
// comes from ops/gemm.py; `ws` holds splits x 128 x n_tile floats per output
// tile and `counters` one zeroed unsigned per tile (both unused at splits 1).
int bm_cd_gemm_act(const float* A, long long sam, long long sak,
                   const float* Bm, long long sbk, long long sbn,
                   const float* bias, const float* sigma, float mult, int act,
                   int M, int N, int K, float* means, float* states,
                   unsigned seed, unsigned it, unsigned stream_id,
                   unsigned shard, int n_tile, int splits, float* ws,
                   unsigned* counters, void* stream) {
  if (sak != 1 || (sbn != 1 && sbk != 1)) return (int)cudaErrorInvalidValue;
  const int w_trans = sbn != 1;
  const bm::tc::Operand op = {A, Bm, sam, w_trans ? sbn : sbk, K, w_trans};
  CdGemmArgs a;
  int err = bm::tc::setup_tile(&a.t, &op, 1, M, N, n_tile, splits, ws,
                               counters);
  if (err) return err;
  a.bias = bias;
  a.sigma = sigma;
  a.means = means;
  a.states = states;
  a.mult = mult;
  a.act = act;
  a.seed = seed;
  a.it = it;
  a.stream_id = stream_id;
  a.shard = shard;
  BM_TC_DISPATCH(cd_gemm_act_kernel, a.t, a, (cudaStream_t)stream, err);
  return err;
}

// `in` and the outputs are (rows, H); draws of row b at elements b*n + j.
int bm_cd_softmax_sample(const float* in, int from_pre, int rows, int H,
                         int n, float* means, float* states, unsigned seed,
                         unsigned it, unsigned stream_id, void* stream) {
  const size_t smem = (size_t)H * (sizeof(float) + sizeof(int));
  const cudaError_t err = allow_smem(cd_softmax_sample_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cd_softmax_sample_kernel<<<rows, kRowThreads, smem,
                             (cudaStream_t)stream>>>(
      in, from_pre, H, n, means, states, seed, it, stream_id);
  return (int)cudaGetLastError();
}

// One block per kColTile columns of V, then of H; 16 bytes a lane where V
// and H are multiples of 4 and the batch-major inputs 16-byte aligned.
int bm_cd_bias_stats(const float* X, const float* vs, const float* vm,
                     const float* h0, const float* hm, int B, int V, int H,
                     float* vb, float* dvb, float* hb, float* dhb, float* q,
                     float* pen, float* msre_col, float lr, float mom,
                     float damp, float one_minus_damp, float cost,
                     float target, void* stream) {
  return launch_k2<false>(X, vs, vm, h0, hm, B, V, H, vb, dvb, hb, dhb, q,
                          pen, msre_col, lr, mom, damp, one_minus_damp, cost,
                          target, (cudaStream_t)stream);
}

// X^T h0 - v^T h by the association kernel (assoc_tc.cuh), with the CD
// momentum update of W and dW in place as its epilogue.
int bm_cd_assoc_update(const float* X, const float* h0, const float* vs,
                       const float* hm, const float* pen, int B, int V, int H,
                       float* W, float* dW, float lr, float mom, float l2,
                       void* stream) {
  return bm::tc::launch_assoc(X, h0, B, 1.f, vs, hm, B, -1.f, V, H,
                              bm::tc::kAssocCd, W, dW, pen, (float)B,
                              lr, mom, l2, (cudaStream_t)stream);
}

// Slices of the caller's flat statistics buffer: dvb_sum (V), dhb_sum and
// h_sum (H each).  K2's grid and load paths (bm_cd_bias_stats).
int bm_cd_stats_sums(const float* X, const float* vs, const float* h0,
                     const float* hm, int B, int V, int H, float* dvb_sum,
                     float* dhb_sum, float* h_sum, void* stream) {
  return launch_k2<true>(X, vs, nullptr, h0, hm, B, V, H, nullptr, dvb_sum,
                         nullptr, dhb_sum, h_sum, nullptr, nullptr, 0.f, 0.f,
                         0.f, 0.f, 0.f, 0.f, (cudaStream_t)stream);
}

// `assoc` is the (V, H) head of the caller's flat statistics buffer.
int bm_cd_assoc_stats(const float* X, const float* h0, const float* vs,
                      const float* hm, int B, int V, int H, float* assoc,
                      void* stream) {
  return bm::tc::launch_assoc(X, h0, B, 1.f, vs, hm, B, -1.f, V, H,
                              bm::tc::kAssocStats, assoc, nullptr, nullptr,
                              1.f, 0.f, 0.f, 0.f, (cudaStream_t)stream);
}

// The association kernel's columns per block at V x H on n_sm SMs (the
// plan that ops/gemm.py's assoc_plan mirrors).
int bm_assoc_n_tile(int V, int H, int n_sm) {
  return bm::tc::assoc_n_tile(V, H, n_sm);
}

// `partials` holds 3 * B floats; `counter` one zeroed unsigned.  sigma ==
// nullptr: Bernoulli visible units; n == 0: Bernoulli hidden units.
int bm_cd_metrics(const float* X, const float* W, const float* vb,
                  const float* hb, const float* sigma, const float* msre_col,
                  int B, int V, int H, float l2, int compute_pll, int n,
                  unsigned seed, unsigned it, float* partials,
                  unsigned* counter, float* msre_out, float* pll_out,
                  float* l2_out, void* stream) {
  const size_t smem =
      compute_pll && n > 0 ? (size_t)H * (sizeof(float) + 2 * sizeof(int))
                           : 0;
  const cudaError_t err = allow_smem(cd_metrics_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cd_metrics_kernel<<<B, kMetThreads, smem, (cudaStream_t)stream>>>(
      X, W, vb, hb, sigma, msre_col, B, V, H, l2, compute_pll, n, seed, it,
      partials, counter, msre_out, pll_out, l2_out);
  return (int)cudaGetLastError();
}

int bm_normal_sample(float* out, long long count, unsigned seed, unsigned it,
                     unsigned stream_id, void* stream) {
  const int threads = 256;
  const long long want = (count + threads - 1) / threads;
  const int blocks = (int)(want < 132 * 16 ? (want > 0 ? want : 1)
                                           : 132 * 16);
  normal_sample_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      out, count, seed, it, stream_id);
  return (int)cudaGetLastError();
}

int bm_bernoulli_sample(const float* p, float* out, long long count,
                        unsigned w0, unsigned w1, void* stream) {
  const int threads = 256;
  const long long want = (count + threads - 1) / threads;
  const int blocks = (int)(want < 132 * 16 ? (want > 0 ? want : 1)
                                           : 132 * 16);
  bernoulli_sample_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      p, out, count, w0, w1);
  return (int)cudaGetLastError();
}

// `partials` holds B floats; `counter` one zeroed unsigned; `hhat_out` H
// floats.  sigma == nullptr: Bernoulli visible; n == 0: Bernoulli hidden.
int bm_fe_probe(const float* X, const float* W, const float* vb,
                const float* hb, const float* sigma, int B, int V, int H,
                int n, unsigned seed, float* partials, unsigned* counter,
                float* fe_out, float* hhat_out, void* stream) {
  const size_t smem = n > 0 ? (size_t)H * (sizeof(float) + sizeof(int)) : 0;
  const cudaError_t err = allow_smem(fe_probe_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  fe_probe_kernel<<<B, kMetThreads, smem, (cudaStream_t)stream>>>(
      X, W, vb, hb, sigma, B, V, H, n, seed, partials, counter, fe_out,
      hhat_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
