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
//                       K1: one block of 512 threads per row computes means
//                       = n softmax(pre) (:307-314) and, when sampling, exact
//                       Multinomial(n, means/n) counts
//                       (`_multinomial_sample_bits`, :130-182, the body of
//                       the TPU's `multinomial_sample`).
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
//                       per evaluation.  Replaces :443-509 (the tiled kernel
//                       had no PLL).  One launch without the PLL, two with:
//                       Bernoulli hidden units first run X.W on K1's tile
//                       with a free-energy epilogue (the flipped row's
//                       product is x.W plus one row of W), multinomial ones
//                       first draw the two count vectors; then one pass over
//                       W adds |W|^2, the multinomial hidden terms x.(W
//                       h_hat), the visible terms and the msre, and its last
//                       block writes the rows.
// The fit loop's validation and free-energy gap run as whole-set passes on
// the same kernels (ops/cd_val.py), a chunk of whole batches at a time: K1
// (and K1b) for the chain over every row at once, K4's first launch on
// every row (bm_cd_val_fe, bm_cd_val_draw), then
//
//   K5 cd_val_reduce    each row's squared error and free energies, and on
//                       the last chunk the means over the batch segments
//                       (below, at the kernel), so a pass reads back three
//                       numbers where the host ran ~50 torch ops a batch.
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
// Standalone launchers: bm_normal_sample (the TPU's `normal_sample`, :95)
// and bm_bernoulli_sample (`bernoulli_sample`, :74, the threshold of K1's
// Bernoulli epilogue), kernels of their own on the epoch's Philox and
// Box-Muller device functions (philox.cuh); bm_fe_probe
// (`make_free_energy_probe`, :208) on K4's kernels; bm_cd_softmax_sample on
// given means is `multinomial_sample` (:106).
//
// Ordering: every K1 of a step reads the old vb/hb before K2 writes them; K3
// needs K2's penalty vector; K4 reads the new W, vb, hb.  One stream, in
// order, no host synchronisation inside an epoch.  One host call an epoch
// call, bm_cd_epoch_loop, issues every step's launches through the entry
// points below, so the host spends a launch's own cost a kernel and no
// interpreter time a step.
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
// binary-searches n draws, so its time is the latency of its chain (the
// row's loads, two block reductions, the CDF's scan, the draws).  All 512
// threads of a row's block share every step: each owns a contiguous chunk
// of the row, which it alone reads and writes, so the row needs five
// barriers; the CDF of means/n is accumulated in float64 (each chunk's
// total, then a block-wide exclusive scan of the totals) and rounded to
// float32 per entry, as the plain version does with a float64 cumsum, so
// both build the same CDF except in ties at float64 rounding; each thread
// takes n / 512 draws; the counts are integers in a shared-memory
// histogram (atomicAdd), exact and independent of order.  This replaces the
// TPU's n*B*H bucket compares and its two HIGHEST-precision matmuls, whose
// bf16 default broke the counts (:138-147): integer histograms cannot round.
//
// K4 is bound by W's bytes (3072x5000: 61 MB, 18 us at 3.35 TB/s) and, with
// Bernoulli hidden units, by the product X.W (as K1's propup).  The product
// runs on the tile, where each block streams its own rows of W once; the
// pass over W gives each warp whole rows of W (16 bytes a lane), ~3 blocks
// per SM, and adds the (B, V) terms per block of columns; no block reads W
// or the batch twice.  bm_fe_probe is the same two launches for one batch
// without the flipped rows: Bernoulli hidden units X.W on the tile with the
// softplus-row epilogue, multinomial ones one block drawing the count
// vector; then the pass over W in its probe mode (u = W.hh where there
// are counts; no |W|^2, msre or flips), whose last block writes the
// batch-mean free energy.
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
// C interface (bound with ctypes by ops/cd_epoch.py, ops/cd_stats.py,
// ops/cd_val.py and ops/samplers.py):
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
// K1b and cd_metrics' draws: threads per row (one block a row; 512 beat
// 1024 and 256 at 100x1000, n 1000: chip_smoke.py --softmax-readings)
constexpr int kRowThreads = 512;
// K4's pass over W: most rows of W per block (ops/cd_epoch.py metrics_plan)
constexpr int kMaxWRows = 64;
// K2: batch rows staged in shared memory at a time (2 x 128 x 32 floats)
constexpr int kK2Chunk = 128;
constexpr int kStaticSmemLimit = 48 * 1024;

// epilogues of cd_gemm_act (ops/cd_epoch.py ACT_*)
constexpr int kActSigmoid = 0, kActGaussian = 1, kActPre = 2;

__device__ __forceinline__ float log_sigmoid(float x) {
  return x < 0.f ? x - log1pf(expf(x)) : -log1pf(expf(-x));
}

// The PLL's flipped unit of batch row b: floor(u V), u the Philox uniform
// of element b on kStreamPll (ops/cd_epoch.py pll_flip_index).
__device__ __forceinline__ int pll_flip(unsigned seed, unsigned it, int b,
                                        int V) {
  return (int)(bm::philox_uniform(seed, it, bm::kStreamPll, (unsigned)b) *
               (float)V);
}

// Max (is_max) or sum over the block, returned to every thread: a shuffle
// tree per warp, one __syncthreads, then every warp combines the warps'
// results by the same shuffle tree, a lane each (commutative steps, so every
// lane of every warp holds the same bits).  `red` holds 32 floats and serves
// this one call.  All threads call it.
__device__ __forceinline__ float block_allreduce(float v, float* red,
                                                 bool is_max) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float t = __shfl_xor_sync(0xffffffffu, v, o);
    v = is_max ? fmaxf(v, t) : v + t;
  }
  if (lane == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = lane < (int)(blockDim.x >> 5) ? red[lane] : (is_max ? -INFINITY : 0.f);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float t = __shfl_xor_sync(0xffffffffu, v, o);
    v = is_max ? fmaxf(v, t) : v + t;
  }
  return v;
}

// This thread's contiguous chunk [lo, hi) of a row of H entries: c =
// ceil(H / blockDim.x) entries (returned), the last chunks short or empty.
__device__ __forceinline__ int row_chunk(int H, int& lo, int& hi) {
  const int c = (H + (int)blockDim.x - 1) / (int)blockDim.x;
  lo = min((int)threadIdx.x * c, H);
  hi = min(lo + c, H);
  return c;
}

// Exclusive scan over the block, in thread order, of every thread's float64
// s: shuffles within each warp, one __syncthreads, then each warp adds the
// totals of the warps before it by a shuffle tree, a lane each.  `tot`
// holds 32 doubles and serves this one call.  All threads call it.
__device__ __forceinline__ double block_exclusive_scan(double s,
                                                       double* tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  double incl = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  double excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.0;
  if (lane == 31) tot[warp] = incl;
  __syncthreads();
  double pre = lane < warp ? tot[lane] : 0.0;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) pre += __shfl_xor_sync(0xffffffffu, pre, o);
  return pre + excl;
}

// Dynamic shared memory of a row's sampling: the CDF (H floats) and the
// counts (H ints).
__host__ __device__ __forceinline__ size_t row_smem(int H) {
  return (size_t)H * (sizeof(float) + sizeof(int));
}

// In place: buf[0..H) holds a row's expected counts (means); leaves the
// float32 CDF of means/n with buf[H-1] = +inf (the last bucket absorbs
// rounding).  The running sum is float64, as the plain version's float64
// cumsum, and each term is the true float64 quotient means/n, as there.
// The whole block builds it: each thread sums the quotients of its chunk
// (row_chunk; up to kHold of them kept in registers, so each is divided
// once), a block-wide exclusive scan gives every chunk its start, and the
// thread writes its chunk's running sums rounded to float32.  A thread
// touches only its own chunk, so the caller needs no barrier before (the
// chunk holds what this thread wrote); ends with __syncthreads.
constexpr int kHold = 16;
__device__ __forceinline__ void build_cdf(float* buf, int H, int n,
                                          double* tot) {
  int lo, hi;
  const int c = row_chunk(H, lo, hi);
  const double dn = (double)n;
  double s = 0.0;
  if (c <= kHold) {  // the same for every thread
    double q[kHold];
#pragma unroll
    for (int k = 0; k < kHold; ++k)
      if (lo + k < hi) {
        q[k] = (double)buf[lo + k] / dn;
        s += q[k];
      }
    double run = block_exclusive_scan(s, tot);
#pragma unroll
    for (int k = 0; k < kHold; ++k)
      if (lo + k < hi) {
        run += q[k];
        buf[lo + k] = lo + k == H - 1 ? INFINITY : (float)run;
      }
  } else {
    for (int i = lo; i < hi; ++i) s += (double)buf[i] / dn;
    double run = block_exclusive_scan(s, tot);
    for (int i = lo; i < hi; ++i) {
      run += (double)buf[i] / dn;
      buf[i] = i == H - 1 ? INFINITY : (float)run;
    }
  }
  __syncthreads();
}

// The uniform-multinomial CDF of the Monte Carlo free energy (means
// float32(n) / float32(H) in every bucket), with this thread's chunk of
// `counts` zeroed for multinomial_draw.  All threads call it.
__device__ __forceinline__ void uniform_cdf(float* buf, int* counts, int H,
                                            int n, double* tot) {
  const float m = (float)n / (float)H;
  int lo, hi;
  row_chunk(H, lo, hi);
  for (int h = lo; h < hi; ++h) {
    buf[h] = m;
    counts[h] = 0;
  }
  build_cdf(buf, H, n, tot);
}

// counts[0..H) += the histogram of n draws over `cdf` (counts zeroed and
// the CDF complete before the last __syncthreads): draw j is the Philox
// uniform at element idx0 + j and lands in the first bucket whose CDF
// exceeds it, the number of entries <= it (a search of a fixed number of
// steps, log2 of `top`, the largest power of two <= H; cdf[H-1] = +inf is
// never <= u).  Each thread takes its draws two at a time, j and j +
// blockDim.x, whose two searches run side by side.  Integer counts in
// shared memory, exact in any order.  Ends with __syncthreads.  All
// threads call it.
__device__ __forceinline__ void multinomial_draw(const float* cdf, int H,
                                                 int n, unsigned seed,
                                                 unsigned it, unsigned stream,
                                                 unsigned idx0, int* counts) {
  int top = 1;
  while (2 * top <= H) top *= 2;
  const int T = blockDim.x;
  for (int j = threadIdx.x; j < n; j += 2 * T) {
    const bool two = j + T < n;
    const float u = bm::philox_uniform(seed, it, stream, idx0 + (unsigned)j);
    const float u2 = two ? bm::philox_uniform(seed, it, stream,
                                              idx0 + (unsigned)(j + T))
                         : 0.f;
    int pos = 0, pos2 = 0;
    for (int s = top; s > 0; s >>= 1) {
      if (pos + s < H && cdf[pos + s - 1] <= u) pos += s;
      if (pos2 + s < H && cdf[pos2 + s - 1] <= u2) pos2 += s;
    }
    atomicAdd(&counts[pos], 1);
    if (two) atomicAdd(&counts[pos2], 1);
  }
  __syncthreads();
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

// K1b: block b owns row b, each of its kRowThreads threads a contiguous
// chunk of it (row_chunk).  from_pre: `in` holds pre-activations and the
// means n softmax(pre) go to `means`; else `in` holds the means.  With
// `states`, Multinomial(n, means/n) counts of the draws at elements b*n + j.
// Every pass but the two reductions and the CDF's scan touches only the
// thread's own chunk, so the row takes five barriers: the max, the sum, the
// scan, the finished CDF, the finished counts.  Dynamic shared memory:
// row_smem(H).
__global__ void __launch_bounds__(kRowThreads)
    cd_softmax_sample_kernel(const float* __restrict__ in, int from_pre,
                             int H, int n, float* __restrict__ means,
                             float* __restrict__ states, unsigned seed,
                             unsigned it, unsigned stream_id) {
  extern __shared__ float smem[];
  __shared__ float red[2][32];
  __shared__ double tot[32];
  float* buf = smem;
  int* counts = reinterpret_cast<int*>(smem + H);
  const long long row = (long long)blockIdx.x * H;
  int lo, hi;
  row_chunk(H, lo, hi);
  float m = -INFINITY;
  for (int h = lo; h < hi; ++h) {
    const float x = in[row + h];
    buf[h] = x;
    m = fmaxf(m, x);
  }
  if (from_pre) {
    m = block_allreduce(m, red[0], true);
    float s = 0.f;
    for (int h = lo; h < hi; ++h) {
      const float e = expf(buf[h] - m);
      buf[h] = e;
      s += e;
    }
    s = block_allreduce(s, red[1], false);
    const float fn = (float)n;
    for (int h = lo; h < hi; ++h) {
      const float mu = fn * (buf[h] / s);
      buf[h] = mu;
      means[row + h] = mu;
    }
  }
  if (!states) return;
  for (int h = lo; h < hi; ++h) counts[h] = 0;
  build_cdf(buf, H, n, tot);
  multinomial_draw(buf, H, n, seed, it, stream_id,
                   (unsigned)blockIdx.x * (unsigned)n, counts);
  for (int h = lo; h < hi; ++h) states[row + h] = (float)counts[h];
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

// K4's first launch with Bernoulli hidden units and the PLL on: the
// product A = X.W on the tensor-core tile (as K1's propup), with a
// free-energy epilogue.  Row x_f of the PLL differs from x in its flipped
// unit f alone, so its product is a_f = a + d W[f, .] with d = x_f[f] -
// x[f] = 1 - 2 x[f]: no second product.  Element (b, h) adds softplus(a +
// hb[h]) and softplus(a_f + hb[h]); each row's 128 columns of the block are
// summed in a fixed order (a shuffle tree, then the four warps' sums, as
// dbm_gemm_act's softplus rows) into rows[b * tiles + tile] and, flipped,
// rows[(B + b) * tiles + tile], tiles = the grid's model tiles.  With flip
// == 0 (the free-energy probe) only the rows of x.
struct CdMetricsFeArgs {
  bm::tc::Tile t;
  const float* X;  // (B, V), rows V apart
  const float* W;  // (V, H)
  const float* hb;
  int V, flip;
  unsigned seed, it;
  float* rows;
};

template <int NT>
__global__ void __launch_bounds__(bm::tc::kThreads, 1)
    cd_metrics_fe_kernel(const __grid_constant__ CdMetricsFeArgs a) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  __shared__ float part[2][NT][4];  // per row, per warp of its 128 columns
  __shared__ float d_s[NT];
  __shared__ int flip_s[NT];
  constexpr int TM = bm::tc::kTileM;
  // the staged product and, after it, the rows W[flip, m0 .. m0 + 128)
  // fit in the ring's memory, free once the product is staged
  static_assert(NT * (bm::tc::kTileStride + TM) * 4 <=
                    bm::tc::ring_bytes(NT, false),
                "the staged rows of W do not fit");
  float* T;
  if (!bm::tc::tile_product<NT>(a.t, tc_smem, T)) return;
  const int H = a.t.nm, B = a.t.nb;
  const int m0 = blockIdx.x * TM, b0 = blockIdx.y * NT;
  const int warp = threadIdx.x >> 5;
  float* Wf = T + NT * bm::tc::kTileStride;
  if (a.flip) {
    for (int r = threadIdx.x; r < NT; r += bm::tc::kThreads) {
      const int b = b0 + r;
      int f = 0;
      float d = 0.f;
      if (b < B) {
        f = pll_flip(a.seed, a.it, b, a.V);
        const float x = a.X[(long long)b * a.V + f];
        d = (1.f - x) - x;
      }
      flip_s[r] = f;
      d_s[r] = d;
    }
    __syncthreads();
    // each row's flipped row of W, gathered by asynchronous copies that
    // are all in flight at once (zeros past the edges)
    for (int e = threadIdx.x; e < TM * NT; e += bm::tc::kThreads) {
      const int h = m0 + e % TM, r = e / TM;
      const bool ok = h < H && b0 + r < B;
      bm::tc::cp_async4(Wf + e,
                        ok ? a.W + (long long)flip_s[r] * H + h : a.W, ok);
    }
    bm::tc::cp_async_commit();
    bm::tc::cp_async_wait<0>();
    __syncthreads();
  }
  // 256 threads cover two rows of 128 columns per pass: warps 0-3 the
  // first, warps 4-7 the second
  for (int e = threadIdx.x; e < TM * NT; e += bm::tc::kThreads) {
    const int c = e % TM, r = e / TM;
    const int h = m0 + c, b = b0 + r;
    float s = 0.f, sf = 0.f;
    if (h < H && b < B) {
      const float acc = T[r * bm::tc::kTileStride + c], bias = a.hb[h];
      s = softplus(acc + bias);
      if (a.flip) sf = softplus(__fmaf_rn(d_s[r], Wf[e], acc) + bias);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      sf += __shfl_xor_sync(0xffffffffu, sf, o);
    }
    if ((threadIdx.x & 31) == 0) {
      part[0][r][warp & 3] = s;
      part[1][r][warp & 3] = sf;
    }
  }
  __syncthreads();
  const int tiles = gridDim.x;
  for (int r = threadIdx.x; r < NT; r += bm::tc::kThreads) {
    const int b = b0 + r;
    if (b >= B) continue;
    a.rows[(long long)b * tiles + blockIdx.x] =
        (part[0][r][0] + part[0][r][1]) + (part[0][r][2] + part[0][r][3]);
    if (a.flip)
      a.rows[((long long)B + b) * tiles + blockIdx.x] =
          (part[1][r][0] + part[1][r][1]) + (part[1][r][2] + part[1][r][3]);
  }
}

// K4's first launch with multinomial hidden units and the PLL on: block z
// draws the count vector of fe(x) (z = 0, stream kStreamPllHhat) or of
// fe(x_f) (z = 1, kStreamPllHhatFlip), n draws at elements 0..n-1 of the
// uniform CDF, into hh[z H .. z H + H) as floats -- once per logged step,
// where every block of the row walk drew both before.  The free-energy
// probe launches block 0 alone at it = 0.  The whole-set passes
// (bm_cd_val_draw) draw `per` vectors for each batch segment s of a chunk:
// block z = s per + j, j = 1 the flipped rows' (per 2), at elements s n ..
// s n + n - 1.  Dynamic shared memory: row_smem(H).
__global__ void __launch_bounds__(kRowThreads)
    cd_metrics_draw_kernel(int per, int H, int n, unsigned seed, unsigned it,
                           float* __restrict__ hh) {
  extern __shared__ float smem[];
  __shared__ double tot[32];
  float* buf = smem;
  int* counts = reinterpret_cast<int*>(smem + H);
  const unsigned seg = blockIdx.x / (unsigned)per;
  uniform_cdf(buf, counts, H, n, tot);
  multinomial_draw(buf, H, n, seed, it,
                   blockIdx.x % (unsigned)per ? bm::kStreamPllHhatFlip
                                              : bm::kStreamPllHhat,
                   seg * (unsigned)n, counts);
  int lo, hi;
  row_chunk(H, lo, hi);
  for (int h = lo; h < hi; ++h)
    hh[(long long)blockIdx.x * H + h] = (float)counts[h];
}

// Six sums over the block at once, valid in thread 0 (in v): a shuffle tree
// per warp, one __syncthreads, then warp 0 adds the warps' sums by a shuffle
// tree.  `red` holds 6 x kWarps floats.  All threads call it.
template <int kWarps>
__device__ __forceinline__ void block_sums6(float (&v)[6],
                                            float (&red)[6][kWarps]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      v[k] += __shfl_xor_sync(0xffffffffu, v[k], o);
    if (lane == 0) red[k][warp] = v[k];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      v[k] = lane < kWarps ? red[k][lane] : 0.f;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        v[k] += __shfl_xor_sync(0xffffffffu, v[k], o);
    }
  }
}

// K4's pass over W, the metrics' last launch: block j owns rows [j R, j R +
// R) of W (R = w_rows) and the same columns of X.  One warp a row of W, VW
// floats a lane: |W|^2 and, multinomial PLL, u = W.hh and u_f = W.hh_f
// (the hidden terms x.W.hh = x.u).  Then one thread a batch row over the
// block's columns: the visible terms of x and x_f (-x.vb, or 0.5 (x -
// vb/sigma)^2), and the multinomial hidden terms x.u and x_f.u_f; with
// Bernoulli hidden units instead a grid-strided slice of the first
// launch's row sums.  fe and fe(x_f) stay two sums, visible and hidden
// parts apart, as the plain version forms them.  Each block writes six
// sums (|W|^2, msre_col, the two visible and two hidden terms); the last
// block to finish adds them in block order (deterministic), writes the
// metric rows and re-arms the counter.
//
// kProbe (the free-energy probe, bm_fe_probe): the same pass for one batch
// with no |W|^2, msre or flipped rows -- W is read only for u = W.hh with
// multinomial hidden units (n > 0) -- and the last block writes the
// batch-mean free energy to fe_out; with Bernoulli hidden units the blocks
// write zeros into the H floats of zeros_out (the probe's count vector).
template <int VW, bool kProbe>
__global__ void __launch_bounds__(kMetThreads)
    cd_metrics_kernel(const float* __restrict__ X, const float* __restrict__ W,
                      const float* __restrict__ vb,
                      const float* __restrict__ sigma,
                      const float* __restrict__ msre_col, int B, int V, int H,
                      int w_rows, float l2, int compute_pll, int n,
                      const float* __restrict__ hh,
                      const float* __restrict__ fe_rows, int fe_tiles,
                      unsigned seed, unsigned it, float* partials,
                      unsigned* counter, float* msre_out, float* pll_out,
                      float* l2_out, float* fe_out, float* zeros_out) {
  __shared__ float red[6][kMetThreads / 32];
  __shared__ float u_s[2][kMaxWRows];
  __shared__ bool is_last;
  constexpr int kWarps = kMetThreads / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int v0 = blockIdx.x * w_rows, v1 = min(v0 + w_rows, V);
  const bool multi = compute_pll && n > 0;

  if (kProbe && !multi)
    for (int h = blockIdx.x * kMetThreads + tid; h < H;
         h += gridDim.x * kMetThreads)
      zeros_out[h] = 0.f;
  float sq = 0.f;
  for (int v = v0 + warp; v < v1 && (!kProbe || multi); v += kWarps) {
    const float* w = W + (long long)v * H;
    float a = 0.f, af = 0.f;
#pragma unroll 4
    for (int h = lane * VW; h < H; h += 32 * VW) {
      float x[VW];
      bm::col::load<VW>(w + h, x);
      if (!kProbe)
#pragma unroll
        for (int k = 0; k < VW; ++k) sq = fmaf(x[k], x[k], sq);
      if (multi) {
        float p[VW];
        bm::col::load<VW>(hh + h, p);
#pragma unroll
        for (int k = 0; k < VW; ++k) a = fmaf(x[k], p[k], a);
        if (!kProbe) {
          float q[VW];
          bm::col::load<VW>(hh + H + h, q);
#pragma unroll
          for (int k = 0; k < VW; ++k) af = fmaf(x[k], q[k], af);
        }
      }
    }
    if (multi) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        a += __shfl_xor_sync(0xffffffffu, a, o);
        af += __shfl_xor_sync(0xffffffffu, af, o);
      }
      if (lane == 0) {
        u_s[0][v - v0] = a;
        u_s[1][v - v0] = af;
      }
    }
  }
  __syncthreads();

  float ms = 0.f, tv = 0.f, tvf = 0.f, th = 0.f, thf = 0.f;
  if (!kProbe)
    for (int v = v0 + tid; v < v1; v += kMetThreads) ms += msre_col[v];
  if (compute_pll) {
    for (int b = tid; b < B; b += kMetThreads) {
      const int f = kProbe ? -1 : pll_flip(seed, it, b, V);
      const float* x = X + (long long)b * V;
      for (int v = v0; v < v1; ++v) {
        const float xv = x[v], xf = v == f ? 1.f - xv : xv;
        if (sigma) {
          const float c = vb[v] / sigma[v], d = xv - c, df = xf - c;
          tv = fmaf(d, d, tv);
          if (!kProbe) tvf = fmaf(df, df, tvf);
        } else {
          tv = fmaf(xv, vb[v], tv);
          if (!kProbe) tvf = fmaf(xf, vb[v], tvf);
        }
        if (multi) {
          th = fmaf(xv, u_s[0][v - v0], th);
          if (!kProbe) thf = fmaf(xf, u_s[1][v - v0], thf);
        }
      }
    }
    if (!multi) {
      const long long nr = (long long)B * fe_tiles;
      for (long long e = (long long)blockIdx.x * kMetThreads + tid; e < nr;
           e += (long long)gridDim.x * kMetThreads) {
        th += fe_rows[e];
        if (!kProbe) thf += fe_rows[nr + e];
      }
    }
  }
  float sums[6] = {sq, ms, tv, tvf, th, thf};
  const int G = gridDim.x;
  block_sums6(sums, red);
  if (tid == 0)
    for (int k = 0; k < 6; ++k) partials[k * G + blockIdx.x] = sums[k];
  if (!bm::last_block(counter, &is_last)) return;

  float tot[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int g = tid; g < G; g += kMetThreads)
#pragma unroll
    for (int k = 0; k < 6; ++k) tot[k] += __ldcg(&partials[k * G + g]);
  block_sums6(tot, red);
  if (kProbe) {
    if (tid == 0) {
      const float vis = sigma ? 0.5f * tot[2] : -tot[2];
      *fe_out = (vis - tot[4]) / (float)B;
      *counter = 0u;
    }
    return;
  }
  if (tid == 0) {
    *msre_out = tot[1] / ((float)B * (float)V);
    *l2_out = l2 * 0.5f * tot[0];
    if (compute_pll) {
      // batch-MEAN free energies, x n_visible, no dbm doubling
      const float vis = sigma ? 0.5f * tot[2] : -tot[2];
      const float vis_f = sigma ? 0.5f * tot[3] : -tot[3];
      const float fe = (vis - tot[4]) / (float)B;
      const float fef = (vis_f - tot[5]) / (float)B;
      *pll_out = (float)V * log_sigmoid(fef - fe);
    }
    *counter = 0u;
  }
}

// The whole-set passes' reduction (ops/cd_val.py: the validation msre and
// PLL, the FEG's free energies), one launch a chunk of the set.  Warp w of
// block j owns row b = 8 j + w of the chunk, 32 columns at a time: its
// squared reconstruction error against the chain's v_means (vm; zeros
// where null), and its free energy and, with `flip`, that of the row with
// unit pll_flip(seed, it, b) flipped -- the visible terms (-x.vb, or 0.5
// (x - vb/sigma)^2) beside the hidden ones: K4's first launch's softplus
// row sums (fe_rows, Bernoulli hidden units) or x.u with u = W.hh of the
// row's batch segment (multinomial; `u` holds `per` rows of V a segment).
// Each row's three numbers go to row_out at its place in the whole set.
// With `final_pass`, the last block to finish then walks the batch
// segments -- rows [s B, s B + B) of the set, the remainder a segment of
// its own -- a warp a segment, in a fixed order: per segment the msre
// (sum / (rows V)), the batch-mean free energies fe and fe_f and the PLL V
// log_sigmoid(fe_f - fe), and writes their means over the segments to
// those of msre_out, pll_out and fe_out that are given, re-arming the
// counter.  Bound by its bytes:
// X and vm read once (31 MB at 5000 x 784), the segment walk's 12 bytes a
// row from L2.
constexpr int kValThreads = 256;

__global__ void __launch_bounds__(kValThreads)
    cd_val_reduce_kernel(const float* __restrict__ X,
                         const float* __restrict__ vm,
                         const float* __restrict__ vb,
                         const float* __restrict__ sigma,
                         const float* __restrict__ fe_rows, int fe_tiles,
                         const float* __restrict__ u, int per, int rows,
                         int V, int B, int msre, int fe, int flip,
                         unsigned seed, unsigned it, long long row0,
                         int n_total, int final_pass, float* row_out,
                         unsigned* counter, float* msre_out, float* pll_out,
                         float* fe_out) {
  constexpr int kWarps = kValThreads / 32;
  __shared__ float red[3][kWarps];
  __shared__ bool is_last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kWarps + warp;
  if (b < rows) {
    const float* x = X + (long long)b * V;
    const float* m = vm ? vm + (long long)b * V : nullptr;
    const int f = flip ? pll_flip(seed, it, b, V) : -1;
    const float* us = u ? u + (long long)(b / B) * per * V : nullptr;
    float s[5] = {0.f, 0.f, 0.f, 0.f, 0.f};  // sq, tv, tv_f, th, th_f
    for (int v = lane; v < V; v += 32) {
      const float xv = x[v], xf = v == f ? 1.f - xv : xv;
      if (msre) {
        const float d = m ? xv - m[v] : xv;
        s[0] = fmaf(d, d, s[0]);
      }
      if (!fe) continue;
      if (sigma) {
        const float c = vb[v] / sigma[v], d = xv - c, df = xf - c;
        s[1] = fmaf(d, d, s[1]);
        s[2] = fmaf(df, df, s[2]);
      } else {
        s[1] = fmaf(xv, vb[v], s[1]);
        s[2] = fmaf(xf, vb[v], s[2]);
      }
      if (us) {
        s[3] = fmaf(xv, us[v], s[3]);
        if (flip) s[4] = fmaf(xf, us[V + v], s[4]);
      }
    }
#pragma unroll
    for (int k = 0; k < 5; ++k)
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        s[k] += __shfl_xor_sync(0xffffffffu, s[k], o);
    if (lane == 0) {
      if (fe && !us)
        for (int t = 0; t < fe_tiles; ++t) {
          s[3] += fe_rows[(long long)b * fe_tiles + t];
          if (flip) s[4] += fe_rows[((long long)rows + b) * fe_tiles + t];
        }
      float* o = row_out + (row0 + b) * 3;
      o[0] = s[0];
      o[1] = (sigma ? 0.5f * s[1] : -s[1]) - s[3];
      o[2] = (sigma ? 0.5f * s[2] : -s[2]) - s[4];
      __threadfence();
    }
  }
  if (!final_pass) return;
  __syncthreads();
  if (!bm::last_block(counter, &is_last)) return;

  const int nseg = (n_total + B - 1) / B;
  float acc[3] = {0.f, 0.f, 0.f};
  for (int sg = warp; sg < nseg; sg += kWarps) {
    const long long r0 = (long long)sg * B;
    const int c = min(B, n_total - sg * B);
    float t[3] = {0.f, 0.f, 0.f};
    for (int r = lane; r < c; r += 32)
#pragma unroll
      for (int k = 0; k < 3; ++k) t[k] += __ldcg(&row_out[(r0 + r) * 3 + k]);
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        t[k] += __shfl_xor_sync(0xffffffffu, t[k], o);
    // batch-MEAN free energies, x n_visible, no dbm doubling
    const float fe_s = t[1] / (float)c, fef_s = t[2] / (float)c;
    acc[0] += t[0] / ((float)c * (float)V);
    if (flip) acc[1] += (float)V * log_sigmoid(fef_s - fe_s);
    acc[2] += fe_s;
  }
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < 3; ++k) red[k][warp] = acc[k];
  __syncthreads();
  if (threadIdx.x == 0) {
    float tot[3] = {0.f, 0.f, 0.f};
    for (int w = 0; w < kWarps; ++w)
#pragma unroll
      for (int k = 0; k < 3; ++k) tot[k] += red[k][w];
    if (msre_out) *msre_out = tot[0] / (float)nseg;
    if (pll_out) *pll_out = tot[1] / (float)nseg;
    if (fe_out) *fe_out = tot[2] / (float)nseg;
    *counter = 0u;
  }
}

// The standalone samplers, bernoulli_sample_kernel and normal_sample_kernel.
// They replace the TPU's `bernoulli_sample` and `normal_sample`
// (boltzmann_machines_tpu/ops/pallas_ops.py:74-103, `_bernoulli_kernel` and
// `_normal_kernel`).  Element i (row-major) takes Philox counter (i, 0, 0, 0):
// the stream id and the shard are 0 at compile time here, unlike in the epoch
// kernels' draws, so the first round's products of the zero words fold away.
//
// What bounds them on an H100: each element costs one Philox4x32-10, ten
// rounds of two 32x32->64-bit products and two three-way xors: 36 integer
// SASS instructions in the Bernoulli kernel, 32 in the normal one (whose key
// word 1 is 0), on the SM's 64 INT32 lanes (read from this library's SASS
// by chip_smoke.py's `--sampler-readings`).  At (100, 7800) Bernoulli draws
// move 6.2 MB (1.86 us at 3.35 TB/s) and run 28 M integer instructions
// (1.68 us at 64 x 132 lanes x 1.98 GHz): bytes bound them, integers close
// behind.  At (100, 3072) normals move 1.2 MB (0.37 us) and run 9.8 M
// integer instructions (0.59 us) beside Box-Muller's ~30 f32 operations an
// element: integers bound them.
//
// The design: four consecutive elements a thread, in one wave (count / 512
// blocks of 128 threads: no grid-stride loop, 32-bit indices, count < 2^32
// checked by the wrapper; 128 rather than 256 threads a block spread the
// normals' 600 blocks more evenly over the 132 SMs: 2.82-3.01 against
// 3.02-3.49 us, `--sampler-readings`); the thread starts its 16-byte load
// of p before any Philox work, then runs four independent Philox chains,
// which hide each other's latency, and writes one 16-byte store.  Where a
// pointer is not 16 bytes aligned (a contiguous view at a storage offset)
// or the thread holds the tail (count % 4), the same thread takes the
// scalar path: guarded 4-byte loads and stores of the same elements.
constexpr int kSampleThreads = 128;
constexpr int kSamplePerThread = 4;

// Whether the thread at `base` (< count) holds four whole elements at
// 16-byte aligned addresses of a and b.
__device__ __forceinline__ bool sample_vector(const void* a, const void* b,
                                              unsigned base,
                                              unsigned count) {
  return count - base >= kSamplePerThread &&
         ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) &
          15u) == 0;
}

// out[i] = 1 if the uniform of counter (i, 0, 0, 0) under key (w0, w1) is
// below p[i], else 0 -- K1's Bernoulli draw.
__global__ void __launch_bounds__(kSampleThreads)
    bernoulli_sample_kernel(const float* __restrict__ p,
                            float* __restrict__ out, unsigned count,
                            unsigned w0, unsigned w1) {
  const unsigned base =
      kSamplePerThread * (blockIdx.x * kSampleThreads + threadIdx.x);
  if (base >= count) return;
  const bool vec = sample_vector(p, out, base, count);
  float pv[kSamplePerThread];
  if (vec) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p + base));
    pv[0] = q.x, pv[1] = q.y, pv[2] = q.z, pv[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < kSamplePerThread; ++j)
      pv[j] = base + j < count ? __ldg(p + base + j) : 0.f;
  }
  unsigned idx[kSamplePerThread], r0[kSamplePerThread], r1[kSamplePerThread];
#pragma unroll
  for (int j = 0; j < kSamplePerThread; ++j) idx[j] = base + j;
  bm::philox_zero_words(idx, make_uint2(w0, w1), r0, r1);
  float s[kSamplePerThread];
#pragma unroll
  for (int j = 0; j < kSamplePerThread; ++j)
    s[j] = bm::uniform_from_bits(r0[j]) < pv[j] ? 1.f : 0.f;
  if (vec) {
    *reinterpret_cast<float4*>(out + base) = make_float4(s[0], s[1], s[2],
                                                         s[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kSamplePerThread; ++j)
      if (base + j < count) out[base + j] = s[j];
  }
}

// out[i] = Box-Muller of counter (i, 0, 0, 0) under key (seed, 0).
__global__ void __launch_bounds__(kSampleThreads)
    normal_sample_kernel(float* __restrict__ out, unsigned count,
                         unsigned seed) {
  const unsigned base =
      kSamplePerThread * (blockIdx.x * kSampleThreads + threadIdx.x);
  if (base >= count) return;
  unsigned idx[kSamplePerThread], r0[kSamplePerThread], r1[kSamplePerThread];
#pragma unroll
  for (int j = 0; j < kSamplePerThread; ++j) idx[j] = base + j;
  bm::philox_zero_words(idx, make_uint2(seed, 0u), r0, r1);
  float z[kSamplePerThread];
#pragma unroll
  for (int j = 0; j < kSamplePerThread; ++j)
    z[j] = bm::box_muller(r0[j], r1[j]);
  if (sample_vector(out, out, base, count)) {
    *reinterpret_cast<float4*>(out + base) = make_float4(z[0], z[1], z[2],
                                                         z[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kSamplePerThread; ++j)
      if (base + j < count) out[base + j] = z[j];
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

// K4's product X (B, V) . W (V, H) on the tensor-core tile with the
// free-energy epilogue (cd_metrics_fe_kernel): `rows` holds (flip ? 2 : 1)
// x B x ceil(H / 128) floats.
int launch_fe_rows(const float* X, const float* W, const float* hb, int B,
                   int V, int H, int flip, unsigned seed, unsigned it,
                   int n_tile, int splits, float* ws, unsigned* counters,
                   float* rows, cudaStream_t s) {
  const bm::tc::Operand op = {X, W, V, H, V, 0};
  CdMetricsFeArgs a;
  int err = bm::tc::setup_tile(&a.t, &op, 1, B, H, n_tile, splits, ws,
                               counters);
  if (err) return err;
  a.X = X;
  a.W = W;
  a.hb = hb;
  a.V = V;
  a.flip = flip;
  a.seed = seed;
  a.it = it;
  a.rows = rows;
  BM_TC_DISPATCH(cd_metrics_fe_kernel, a.t, a, s, err);
  return err;
}

// K4's draws: `blocks` count vectors into hh, `per` a segment (block z on
// stream kStreamPllHhat, or kStreamPllHhatFlip where z % per is 1).
int launch_draws(int blocks, int per, int H, int n, unsigned seed,
                 unsigned it, float* hh, cudaStream_t s) {
  if (blocks < 1 || per < 1 || per > 2) return (int)cudaErrorInvalidValue;
  const size_t smem = row_smem(H);
  const cudaError_t err = allow_smem(cd_metrics_draw_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cd_metrics_draw_kernel<<<blocks, kRowThreads, smem, s>>>(per, H, n, seed,
                                                           it, hh);
  return (int)cudaGetLastError();
}

// K4's pass over W (cd_metrics_kernel): ceil(V / w_rows) blocks, 16-byte
// loads of W (and hh) where H is a multiple of 4 and they are 16-byte
// aligned.
template <bool kProbe>
int launch_w_pass(const float* X, const float* W, const float* vb,
                  const float* sigma, const float* msre_col, int B, int V,
                  int H, int w_rows, float l2, int compute_pll, int n,
                  const float* hh, const float* fe_rows, int fe_tiles,
                  unsigned seed, unsigned it, float* partials,
                  unsigned* counter, float* msre_out, float* pll_out,
                  float* l2_out, float* fe_out, float* zeros_out,
                  cudaStream_t s) {
  if (w_rows < 1 || w_rows > kMaxWRows) return (int)cudaErrorInvalidValue;
  const int blocks = (V + w_rows - 1) / w_rows;
  const void* ptrs[] = {W, hh};
  const bool vec = H % 4 == 0 &&
                   bm::col::aligned16(ptrs, compute_pll && n > 0 ? 2 : 1);
  if (vec)
    cd_metrics_kernel<4, kProbe><<<blocks, kMetThreads, 0, s>>>(
        X, W, vb, sigma, msre_col, B, V, H, w_rows, l2, compute_pll, n, hh,
        fe_rows, fe_tiles, seed, it, partials, counter, msre_out, pll_out,
        l2_out, fe_out, zeros_out);
  else
    cd_metrics_kernel<1, kProbe><<<blocks, kMetThreads, 0, s>>>(
        X, W, vb, sigma, msre_col, B, V, H, w_rows, l2, compute_pll, n, hh,
        fe_rows, fe_tiles, seed, it, partials, counter, msre_out, pll_out,
        l2_out, fe_out, zeros_out);
  return (int)cudaGetLastError();
}

}  // namespace

// One cd_epoch call's launches, which bm_cd_epoch_loop issues step by step
// (ctypes mirror ops/cd_epoch.py's EpochLoop, same field order).  Everything
// here holds for the whole call: the wrapper's plans, workspaces and
// buffers.  X is (NB, B, V); `streams` the Philox stream ids, h0's first,
// then stream_v(s) and stream_h(s) for each s < k; null sigma: Bernoulli
// visible units; n 0: Bernoulli hidden units, else the multinomial draws.
// The products of the hidden passes and the metrics' free-energy product
// (the same M, N and K) share the plan (h_tile, h_splits, h_ws,
// h_counters), the visible passes' is (v_tile, ...).
struct CdEpochLoop {
  const float* X;
  const float* sigma;
  const unsigned* streams;
  float* W;
  float* vb;
  float* hb;
  float* dW;
  float* dvb;
  float* dhb;
  float* q;
  float* h0;
  float* v_means;
  float* h_means;
  float* h_samp;   // null unless hidden states are sampled
  float* v_samp;   // null unless visible states are sampled
  float* pre;      // multinomial hidden units' pre-activations
  float* pen;
  float* msre_col;
  float* h_ws;
  unsigned* h_counters;
  float* v_ws;
  unsigned* v_counters;
  float* met_rows;  // metrics_workspace: rows, hh, partials, counter
  float* met_hh;
  float* met_partials;
  unsigned* met_counter;
  float* msre_rows;  // (NB,) each
  float* pll_rows;
  float* l2_rows;
  long long metrics_every;
  int NB, B, V, H, k, n;
  int sample_v, sample_h, compute_pll;
  int h_tile, h_splits, v_tile, v_splits, assoc_tile, w_rows;
  float up, down, l2, lr, mom, damp, one_minus_damp, cost, target;
  unsigned seed, iter0;
};

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
  const size_t smem = row_smem(H);
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
                       int n_tile, void* stream) {
  return bm::tc::launch_assoc(X, h0, B, 1.f, vs, hm, B, -1.f, V, H,
                              bm::tc::kAssocCd, W, dW, pen, (float)B,
                              lr, mom, l2, n_tile, (cudaStream_t)stream);
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
                      int n_tile, void* stream) {
  return bm::tc::launch_assoc(X, h0, B, 1.f, vs, hm, B, -1.f, V, H,
                              bm::tc::kAssocStats, assoc, nullptr, nullptr,
                              1.f, 0.f, 0.f, 0.f, n_tile,
                              (cudaStream_t)stream);
}

// K4's first launch, Bernoulli hidden units, PLL on: X (B, V) . W (V, H)
// on the tensor-core tile with the plan (n_tile, splits, ws, counters) of
// ops/gemm.py, as bm_cd_gemm_act's propup; `rows` holds 2 x B x
// ceil(H / 128) floats.
int bm_cd_metrics_fe(const float* X, const float* W, const float* hb, int B,
                     int V, int H, unsigned seed, unsigned it, int n_tile,
                     int splits, float* ws, unsigned* counters, float* rows,
                     void* stream) {
  return launch_fe_rows(X, W, hb, B, V, H, 1, seed, it, n_tile, splits, ws,
                        counters, rows, (cudaStream_t)stream);
}

// K4's first launch, multinomial hidden units, PLL on: the two count
// vectors into `hh` (2 x H floats).
int bm_cd_metrics_draw(int H, int n, unsigned seed, unsigned it, float* hh,
                       void* stream) {
  return launch_draws(2, 2, H, n, seed, it, hh, (cudaStream_t)stream);
}

// K4's pass over W and the metric rows: ceil(V / w_rows) blocks (w_rows <=
// kMaxWRows).  `hh` (multinomial PLL: bm_cd_metrics_draw's counts) or
// `fe_rows` with its `fe_tiles` (Bernoulli PLL: bm_cd_metrics_fe's row
// sums) come from the first launch; `partials` holds 6 floats per block,
// `counter` one zeroed unsigned.  sigma == nullptr: Bernoulli visible
// units; n == 0: Bernoulli hidden units.  16-byte loads of W (and hh)
// where H is a multiple of 4 and they are 16-byte aligned.
int bm_cd_metrics(const float* X, const float* W, const float* vb,
                  const float* sigma, const float* msre_col, int B, int V,
                  int H, int w_rows, float l2, int compute_pll, int n,
                  const float* hh, const float* fe_rows, int fe_tiles,
                  unsigned seed, unsigned it, float* partials,
                  unsigned* counter, float* msre_out, float* pll_out,
                  float* l2_out, void* stream) {
  return launch_w_pass<false>(
      X, W, vb, sigma, msre_col, B, V, H, w_rows, l2, compute_pll, n, hh,
      fe_rows, fe_tiles, seed, it, partials, counter, msre_out, pll_out,
      l2_out, nullptr, nullptr, (cudaStream_t)stream);
}

// The whole-set passes (ops/cd_val.py), per chunk of `rows` rows of the
// set.  K4's first launch on the chunk: X (rows, V) . W on the tensor-core
// tile with the free-energy epilogue, the flipped rows' too where `flip`;
// `fe_rows` holds (flip ? 2 : 1) x rows x ceil(H / 128) floats.
int bm_cd_val_fe(const float* X, const float* W, const float* hb, int rows,
                 int V, int H, int flip, unsigned seed, unsigned it,
                 int n_tile, int splits, float* ws, unsigned* counters,
                 float* fe_rows, void* stream) {
  return launch_fe_rows(X, W, hb, rows, V, H, flip ? 1 : 0, seed, it,
                        n_tile, splits, ws, counters, fe_rows,
                        (cudaStream_t)stream);
}

// Multinomial hidden units: `vectors` count vectors into hh (vectors x H
// floats), `per` (1 or 2) for each batch segment of the chunk.
int bm_cd_val_draw(int vectors, int per, int H, int n, unsigned seed,
                   unsigned it, float* hh, void* stream) {
  return launch_draws(vectors, per, H, n, seed, it, hh,
                      (cudaStream_t)stream);
}

// cd_val_reduce_kernel over the chunk's rows, 8 a block; its rows' numbers
// into row_out (3 floats a row of the whole set, from row row0), and with
// final_pass the means over the set's segments into those of msre_out,
// pll_out and fe_out that are not null.  `counter`: one zeroed unsigned,
// re-armed by the final launch.
int bm_cd_val_reduce(const float* X, const float* vm, const float* vb,
                     const float* sigma, const float* fe_rows, int fe_tiles,
                     const float* u, int per, int rows, int V, int B,
                     int msre, int fe, int flip, unsigned seed, unsigned it,
                     long long row0, int n_total, int final_pass,
                     float* row_out, unsigned* counter, float* msre_out,
                     float* pll_out, float* fe_out, void* stream) {
  if (rows < 1 || B < 1 || per < 1 || per > 2 || row0 < 0 ||
      row0 + rows > n_total)
    return (int)cudaErrorInvalidValue;
  constexpr int kWarps = kValThreads / 32;
  cd_val_reduce_kernel<<<(rows + kWarps - 1) / kWarps, kValThreads, 0,
                         (cudaStream_t)stream>>>(
      X, vm, vb, sigma, fe_rows, fe_tiles, u, per, rows, V, B, msre, fe,
      flip, seed, it, row0, n_total, final_pass, row_out, counter, msre_out,
      pll_out, fe_out);
  return (int)cudaGetLastError();
}

// The standalone samplers: one wave of ceil(count / 512) blocks (at least
// one, so that a call is always one launch); count < 2^32.
static unsigned sample_blocks(unsigned count) {
  const unsigned long long per_block = kSampleThreads * kSamplePerThread;
  return count ? (unsigned)((count + per_block - 1) / per_block) : 1u;
}

int bm_normal_sample(float* out, unsigned count, unsigned seed,
                     void* stream) {
  normal_sample_kernel<<<sample_blocks(count), kSampleThreads, 0,
                         (cudaStream_t)stream>>>(out, count, seed);
  return (int)cudaGetLastError();
}

int bm_bernoulli_sample(const float* p, float* out, unsigned count,
                        unsigned w0, unsigned w1, void* stream) {
  bernoulli_sample_kernel<<<sample_blocks(count), kSampleThreads, 0,
                            (cudaStream_t)stream>>>(p, out, count, w0, w1);
  return (int)cudaGetLastError();
}

// The TPU's make_free_energy_probe in two launches of K4's kernels.
// Bernoulli hidden units (n == 0): X.W on the tensor-core tile with the
// softplus-row epilogue and the plan (n_tile, splits, ws, counters) of
// ops/gemm.py, `rows` holding B x ceil(H / 128) floats; multinomial ones:
// one block draws the count vector under key (seed, 0) on kStreamPllHhat
// straight into `hhat_out` (H floats).  Then the pass over W in its probe
// mode (w_rows as ops/cd_epoch.py's metrics_plan; `partials` 6 floats per
// block, `counter` one zeroed unsigned, re-armed): fe_out gets the
// batch-mean free energy and, with Bernoulli hidden units, hhat_out zeros.
// sigma == nullptr: Bernoulli visible units.
int bm_fe_probe(const float* X, const float* W, const float* vb,
                const float* hb, const float* sigma, int B, int V, int H,
                int n, unsigned seed, int w_rows, int n_tile, int splits,
                float* ws, unsigned* counters, float* rows, float* partials,
                unsigned* counter, float* fe_out, float* hhat_out,
                void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int err = n > 0 ? launch_draws(1, 1, H, n, seed, 0u, hhat_out, s)
                        : launch_fe_rows(X, W, hb, B, V, H, 0, seed, 0u,
                                         n_tile, splits, ws, counters, rows,
                                         s);
  if (err) return err;
  return launch_w_pass<true>(
      X, W, vb, sigma, nullptr, B, V, H, w_rows, 0.f, 1, n, hhat_out, rows,
      (H + bm::tc::kTileM - 1) / bm::tc::kTileM, seed, 0u, partials,
      counter, nullptr, nullptr, nullptr, fe_out, hhat_out, s);
}

// The launches of one cd_epoch call: for step i (it = iter0 + i + 1, X's
// rows i*B*V on) the hidden pass on X, k visible and hidden passes, K2, K3
// and, where it % metrics_every == 0, K4 into row i of the metric rows,
// through the entry points above with the arguments ops/cd_epoch.py's
// launch helpers give them.  launches[0..4] gain the launches made of
// cd_gemm_act, cd_softmax_sample, cd_bias_stats, cd_assoc_update and
// cd_metrics; the loop stops at the first launch that fails and returns
// its error, with failed[0] the step and failed[1] the kernel's index in
// `launches`.
int bm_cd_epoch_loop(const CdEpochLoop* a, long long* launches, int* failed,
                     void* stream) {
  if (!a || !launches || !failed || !a->streams || a->NB < 1 || a->B < 1 ||
      a->k < 0 || a->metrics_every < 1)
    return (int)cudaErrorInvalidValue;
  enum { kGemm, kSoftmax, kBias, kAssoc, kMetrics };
  const int B = a->B, V = a->V, H = a->H;
  // each launch: its error, else one more in its count
  int err = 0;
  auto done = [&](int e, int kernel, int step) {
    err = e;
    if (e) {
      failed[0] = step;
      failed[1] = kernel;
    } else {
      ++launches[kernel];
    }
    return e == 0;
  };
  // up * (A.W + hb) on rows A (B, V): sigmoid means and Bernoulli states,
  // or the pre-activations, then the softmax means and counts
  auto h_pass = [&](const float* A, float* means, float* states,
                    unsigned it, unsigned sid, int i) {
    if (!a->n)
      return done(bm_cd_gemm_act(A, V, 1, a->W, H, 1, a->hb, nullptr, a->up,
                                 kActSigmoid, B, H, V, means, states,
                                 a->seed, it, sid, 0, a->h_tile, a->h_splits,
                                 a->h_ws, a->h_counters, stream),
                  kGemm, i);
    return done(bm_cd_gemm_act(A, V, 1, a->W, H, 1, a->hb, nullptr, a->up,
                               kActPre, B, H, V, a->pre, nullptr, a->seed,
                               it, sid, 0, a->h_tile, a->h_splits, a->h_ws,
                               a->h_counters, stream),
                kGemm, i) &&
           done(bm_cd_softmax_sample(a->pre, 1, B, H, a->n, means, states,
                                     a->seed, it, sid, stream),
                kSoftmax, i);
  };
  for (int i = 0; i < a->NB; ++i) {
    const float* X = a->X + (long long)i * B * V;
    const unsigned it = a->iter0 + (unsigned)i + 1u;
    if (!h_pass(X, a->h0, a->h_samp, it, a->streams[0], i)) return err;
    const float* h_states = a->sample_h ? a->h_samp : a->h0;
    const float* v_states = X;
    const float* v_m = X;
    const float* h_m = a->h0;
    for (int s = 0; s < a->k; ++s) {
      // down (h.W^T + vb): sigmoid, or Gaussian (times sigma) and its draws
      if (!done(bm_cd_gemm_act(h_states, H, 1, a->W, 1, H, a->vb, a->sigma,
                               a->down,
                               a->sigma ? kActGaussian : kActSigmoid, B, V,
                               H, a->v_means, a->v_samp, a->seed, it,
                               a->streams[1 + 2 * s], 0, a->v_tile,
                               a->v_splits, a->v_ws, a->v_counters, stream),
                kGemm, i))
        return err;
      v_m = a->v_means;
      v_states = a->sample_v ? a->v_samp : a->v_means;
      if (!h_pass(v_states, a->h_means, a->h_samp, it,
                  a->streams[2 + 2 * s], i))
        return err;
      h_m = a->h_means;
      h_states = a->sample_h ? a->h_samp : a->h_means;
    }
    if (!done(bm_cd_bias_stats(X, v_states, v_m, a->h0, h_m, B, V, H, a->vb,
                               a->dvb, a->hb, a->dhb, a->q, a->pen,
                               a->msre_col, a->lr, a->mom, a->damp,
                               a->one_minus_damp, a->cost, a->target,
                               stream),
              kBias, i) ||
        !done(bm_cd_assoc_update(X, a->h0, v_states, h_m, a->pen, B, V, H,
                                 a->W, a->dW, a->lr, a->mom, a->l2,
                                 a->assoc_tile, stream),
              kAssoc, i))
      return err;
    if ((long long)it % a->metrics_every) continue;
    int fe_tiles = 0;
    if (a->compute_pll && a->n) {
      if (!done(bm_cd_metrics_draw(H, a->n, a->seed, it, a->met_hh, stream),
                kMetrics, i))
        return err;
    } else if (a->compute_pll) {
      if (!done(bm_cd_metrics_fe(X, a->W, a->hb, B, V, H, a->seed, it,
                                 a->h_tile, a->h_splits, a->h_ws,
                                 a->h_counters, a->met_rows, stream),
                kMetrics, i))
        return err;
      fe_tiles = (H + bm::tc::kTileM - 1) / bm::tc::kTileM;
    }
    if (!done(bm_cd_metrics(X, a->W, a->vb, a->sigma, a->msre_col, B, V, H,
                            a->w_rows, a->l2, a->compute_pll, a->n, a->met_hh,
                            a->met_rows, fe_tiles, a->seed, it,
                            a->met_partials, a->met_counter,
                            a->msre_rows + i, a->pll_rows + i,
                            a->l2_rows + i, stream),
              kMetrics, i))
      return err;
  }
  return 0;
}

}  // extern "C"
