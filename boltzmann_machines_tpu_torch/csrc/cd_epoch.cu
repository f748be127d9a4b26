// CD-k epoch of a Bernoulli x Bernoulli RBM, hand-written for Hopper (sm_90a).
//
// Replaces the TPU's fused epoch kernel `make_cd_epoch_kernel` /
// `_cd_epoch_kernel` (boltzmann_machines_tpu/ops/pallas_ops.py:1266, body
// :262-509, `sub_tiles == 1` branch).  On the TPU one pallas_call runs the
// whole epoch with W resident in VMEM.  Hopper has no such memory, so W and
// dW live in device memory (and the 50 MB L2) and each minibatch runs as a
// short sequence of launches on one stream, in this order:
//
//   K1 cd_gemm_act      1 + 2k per step.  f32 tiled GEMM, A and B addressed
//                       by (row stride, column stride) so X.W, h.W^T and
//                       v.W are one kernel; epilogue sigmoid(mult*(acc+bias))
//                       and, when sampling, the Philox-thresholded states.
//                       Replaces the chain of pallas_ops.py:300-345.
//   K2 cd_bias_stats    column sums over the batch (dvb, dhb, h_sum, msre
//                       partial), the sparsity EMA and penalty, and the
//                       vb/hb/dvb/dhb/q updates.  Replaces :353-356, :425-441.
//   K3 cd_assoc_update  X^T h0 - v^T h (contraction over the batch) with the
//                       momentum update of dW and W in place as epilogue;
//                       each (i, j) has one owner, and it reads the old W for
//                       the L2 term.  Replaces :348-352, :425, :433-439.
//   K4 cd_metrics       only where it % every == 0 (the host knows `it`, so
//                       no readback): L2 of the new W, msre, and the PLL with
//                       one flipped unit per row, via X.W_new with a softplus
//                       row sum (`_free_energy_sum`, pallas_ops.py:185).
//                       Replaces :443-509.
//
// Ordering: every K1 of a step reads the old vb/hb before K2 writes them; K3
// needs K2's penalty vector; K4 reads the new W, vb, hb.  One stream, in
// order, no host synchronisation inside an epoch.
//
// What bounds it on an H100: at 784x1024 the step is a few MFLOP (batch 10)
// to ~2 GFLOP (batch 256), far below the card's f32 rate either way.  A
// profile of the main path (PERF.md) shows the device busy nearly all of
// the step at batch 10, and most of that in cd_gemm_act: with a 64-row tile
// a batch-10 product is one row of 13-16 blocks, each walking the whole
// 784- or 1024-long K loop alone -- latency-bound, with most SMs idle, more
// than launch-bound.  The design does nothing about that yet: all products
// are plain f32 FMA (no TF32, no tensor cores), and split-K for small
// batches, CUDA graphs or one persistent kernel per epoch are later work.
//
// The tiled GEMM, the activations and the block reduction live in gemm.cuh,
// shared with dbm_ops.cu.
//
// C interface (bound with ctypes by ops/cd_epoch.py): every entry launches on
// the given stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm.cuh"
#include "philox.cuh"

namespace {

using bm::BK;
using bm::BM;
using bm::BN;
using bm::block_sum;
using bm::gemm_accumulate;
using bm::GemmTile;
using bm::kGemmThreads;
using bm::sigmoid;
using bm::softplus;
using bm::TM;
using bm::TN;

constexpr int kMetThreads = 256;

__device__ __forceinline__ float log_sigmoid(float x) {
  return x < 0.f ? x - log1pf(expf(x)) : -log1pf(expf(-x));
}

// K1: means = sigmoid(mult * (A.B + bias)); states = 1[u < means] if given.
__global__ void __launch_bounds__(kGemmThreads)
    cd_gemm_act_kernel(const float* __restrict__ A, long long sam,
                       long long sak, const float* __restrict__ Bm,
                       long long sbk, long long sbn,
                       const float* __restrict__ bias, float mult, int M,
                       int N, int K, float* __restrict__ means,
                       float* __restrict__ states, unsigned seed, unsigned it,
                       unsigned stream_id) {
  __shared__ GemmTile sm;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[TM][TN] = {};
  gemm_accumulate(A, sam, sak, Bm, sbk, sbn, M, N, K, m0, n0, sm, acc);
  const int tx = threadIdx.x % (BN / TN), ty = threadIdx.x / (BN / TN);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n >= N) continue;
      const long long idx = (long long)m * N + n;
      const float p = sigmoid(mult * (acc[i][j] + bias[n]));
      means[idx] = p;
      if (states) {
        const float u = bm::philox_uniform(seed, it, stream_id,
                                           (unsigned)idx);
        states[idx] = u < p ? 1.f : 0.f;
      }
    }
  }
}

// K2: one thread per visible column j < V, then per hidden column.
__global__ void cd_bias_stats_kernel(
    const float* __restrict__ X, const float* __restrict__ vs,
    const float* __restrict__ vm, const float* __restrict__ h0,
    const float* __restrict__ hm, int B, int V, int H, float* vb, float* dvb,
    float* hb, float* dhb, float* q, float* __restrict__ pen,
    float* __restrict__ msre_col, float lr, float mom, float damp,
    float one_minus_damp, float cost, float target) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const float n = (float)B;
  if (j < V) {
    float s = 0.f, e = 0.f;
    for (int b = 0; b < B; ++b) {
      const float x = X[(long long)b * V + j];
      s += x - vs[(long long)b * V + j];
      const float d = x - vm[(long long)b * V + j];
      e = fmaf(d, d, e);
    }
    const float acc = lr * (mom * dvb[j] + s / n);
    dvb[j] = acc;
    vb[j] += acc;
    msre_col[j] = e;
  } else if (j < V + H) {
    const int c = j - V;
    float s = 0.f, hsum = 0.f;
    for (int b = 0; b < B; ++b) {
      const float h = hm[(long long)b * H + c];
      s += h0[(long long)b * H + c] - h;
      hsum += h;
    }
    // sparsity acts on the batch SUM of the chain-end hidden means
    const float qn = damp * q[c] + one_minus_damp * hsum;
    const float p = cost * (qn - target);
    q[c] = qn;
    pen[c] = p;
    const float acc = lr * (mom * dhb[c] + s / n - p);
    dhb[c] = acc;
    hb[c] += acc;
  }
}

// K3: rows i of W (visible), columns j (hidden); contraction over the batch.
__global__ void __launch_bounds__(kGemmThreads)
    cd_assoc_update_kernel(const float* __restrict__ X,
                           const float* __restrict__ h0,
                           const float* __restrict__ vs,
                           const float* __restrict__ hm,
                           const float* __restrict__ pen, int B, int V, int H,
                           float* __restrict__ W, float* __restrict__ dW,
                           float lr, float mom, float l2) {
  __shared__ GemmTile sm;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float pos[TM][TN] = {}, neg[TM][TN] = {};
  // A(i, b) = X[b*V + i], B(b, j) = h0[b*H + j]
  gemm_accumulate(X, 1, V, h0, H, 1, V, H, B, m0, n0, sm, pos);
  gemm_accumulate(vs, 1, V, hm, H, 1, V, H, B, m0, n0, sm, neg);
  const int tx = threadIdx.x % (BN / TN), ty = threadIdx.x / (BN / TN);
  const float n = (float)B;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= V) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = n0 + tx * TN + j;
      if (c >= H) continue;
      const long long idx = (long long)m * H + c;
      const float w = W[idx];
      const float g = (pos[i][j] - neg[i][j]) / n - l2 * w;
      // the sparsity penalty is subtracted from every row of dW
      const float acc = lr * (mom * dW[idx] + g - pen[c]);
      dW[idx] = acc;
      W[idx] = w + acc;
    }
  }
}

// K4: grid of B blocks (block b owns batch row b for the PLL); every block
// also sums a grid-strided slice of W^2.  The last block to finish reduces
// the per-block partials in a fixed order (deterministic) and writes the
// three metric rows, then re-arms the counter for the next launch.
__global__ void __launch_bounds__(kMetThreads)
    cd_metrics_kernel(const float* __restrict__ X, const float* __restrict__ W,
                      const float* __restrict__ vb,
                      const float* __restrict__ hb,
                      const float* __restrict__ msre_col, int B, int V, int H,
                      float l2, int compute_pll, unsigned seed, unsigned it,
                      float* partials, unsigned* counter, float* msre_out,
                      float* pll_out, float* l2_out) {
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
    if (tid == 0) {
      const float u = bm::philox_uniform(seed, it, bm::kStreamPll, b);
      flip = (int)(u * (float)V);
    }
    __syncthreads();
    const float* x = X + (long long)b * V;
    float tv = 0.f, tvf = 0.f;
    for (int v = tid; v < V; v += blockDim.x) {
      const float xv = x[v], xf = v == flip ? 1.f - xv : xv;
      tv = fmaf(xv, vb[v], tv);
      tvf = fmaf(xf, vb[v], tvf);
    }
    float th = 0.f, thf = 0.f;
    for (int h = tid; h < H; h += blockDim.x) {
      float a = 0.f, af = 0.f;
      for (int v = 0; v < V; ++v) {
        const float xv = x[v], w = W[(long long)v * H + h];
        a = fmaf(xv, w, a);
        af = fmaf(v == flip ? 1.f - xv : xv, w, af);
      }
      th += softplus(a + hb[h]);
      thf += softplus(af + hb[h]);
    }
    // per-row free energy: -x.vb - sum_h softplus(x.W + hb)
    const float s_tv = block_sum(tv, red), s_tvf = block_sum(tvf, red);
    const float s_th = block_sum(th, red), s_thf = block_sum(thf, red);
    fe_row = -s_tv - s_th;
    fef_row = -s_tvf - s_thf;
  }

  if (tid == 0) {
    partials[3 * blockIdx.x + 0] = block_sq;
    partials[3 * blockIdx.x + 1] = fe_row;
    partials[3 * blockIdx.x + 2] = fef_row;
    __threadfence();
    is_last = atomicAdd(counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!is_last) return;

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

}  // namespace

extern "C" {

int bm_cd_gemm_act(const float* A, long long sam, long long sak,
                   const float* Bm, long long sbk, long long sbn,
                   const float* bias, float mult, int M, int N, int K,
                   float* means, float* states, unsigned seed, unsigned it,
                   unsigned stream_id, void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cd_gemm_act_kernel<<<grid, kGemmThreads, 0, (cudaStream_t)stream>>>(
      A, sam, sak, Bm, sbk, sbn, bias, mult, M, N, K, means, states, seed, it,
      stream_id);
  return (int)cudaGetLastError();
}

int bm_cd_bias_stats(const float* X, const float* vs, const float* vm,
                     const float* h0, const float* hm, int B, int V, int H,
                     float* vb, float* dvb, float* hb, float* dhb, float* q,
                     float* pen, float* msre_col, float lr, float mom,
                     float damp, float one_minus_damp, float cost,
                     float target, void* stream) {
  const int threads = 256;
  const int blocks = (V + H + threads - 1) / threads;
  cd_bias_stats_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      X, vs, vm, h0, hm, B, V, H, vb, dvb, hb, dhb, q, pen, msre_col, lr, mom,
      damp, one_minus_damp, cost, target);
  return (int)cudaGetLastError();
}

int bm_cd_assoc_update(const float* X, const float* h0, const float* vs,
                       const float* hm, const float* pen, int B, int V, int H,
                       float* W, float* dW, float lr, float mom, float l2,
                       void* stream) {
  const dim3 grid((H + BN - 1) / BN, (V + BM - 1) / BM);
  cd_assoc_update_kernel<<<grid, kGemmThreads, 0, (cudaStream_t)stream>>>(
      X, h0, vs, hm, pen, B, V, H, W, dW, lr, mom, l2);
  return (int)cudaGetLastError();
}

// `partials` holds 3 * B floats; `counter` one zeroed unsigned.
int bm_cd_metrics(const float* X, const float* W, const float* vb,
                  const float* hb, const float* msre_col, int B, int V, int H,
                  float l2, int compute_pll, unsigned seed, unsigned it,
                  float* partials, unsigned* counter, float* msre_out,
                  float* pll_out, float* l2_out, void* stream) {
  cd_metrics_kernel<<<B, kMetThreads, 0, (cudaStream_t)stream>>>(
      X, W, vb, hb, msre_col, B, V, H, l2, compute_pll, seed, it, partials,
      counter, msre_out, pll_out, l2_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
