// Shared device code of the port's kernels: the SIMT GEMM accumulator of the
// association kernels, the activations, and a block reduction.  Used by
// cd_epoch.cu (the RBM's CD epoch and stats) and dbm_ops.cu (the DBM epoch).
//
// gemm_accumulate serves the contractions over the batch (X^T h0 - v^T h
// into a V x H output: cd_assoc_update, cd_assoc_stats, dbm_assoc_update),
// which the TPU computes inside the same Pallas bodies as the chain's
// products (pallas_ops.py:1343, :1238, pallas_dbm.py:373).  It is plain f32
// FMA on the SIMT cores: a 64x64 output tile per block of 256 threads, 4x4
// outputs per thread, a 16-deep K slice staged in shared memory, A and B
// addressed by (row stride, column stride).  Their K is the batch (10-256),
// their output W-sized, so they are bound by operations at 67 TFLOP/s, not
// by latency as the chain's products were; moving them to the tensor cores
// is the next item of ROADMAP.md.  The chain's products (A.W, h.W^T) run on
// the tensor-core tile of gemm_tc.cuh.
#pragma once

#include <cuda_runtime.h>

namespace bm {

constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;
constexpr int kGemmThreads = (BM / TM) * (BN / TN);  // 256

struct GemmTile {
  float a[BK][BM + 4];
  float b[BK][BN + 4];
};

// acc[i][j] += sum_k A(m0 + ty*TM + i, k) * B(k, n0 + tx*TN + j), k < K,
// where A(m, k) = A[m*sam + k*sak] and B(k, n) = B[k*sbk + n*sbn].  Out-of-
// range elements load as zero.  Must be called by all threads of the block.
__device__ inline void gemm_accumulate(const float* __restrict__ A,
                                       long long sam, long long sak,
                                       const float* __restrict__ Bm,
                                       long long sbk, long long sbn, int M,
                                       int N, int K, int m0, int n0,
                                       GemmTile& sm, float acc[TM][TN]) {
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BM * BK; e += kGemmThreads) {
      // neighbouring threads on neighbouring addresses
      int m, k;
      if (sak == 1) {
        k = e % BK;
        m = e / BK;
      } else {
        m = e % BM;
        k = e / BM;
      }
      const int gm = m0 + m, gk = k0 + k;
      sm.a[k][m] = (gm < M && gk < K) ? A[gm * sam + gk * sak] : 0.f;
    }
    for (int e = tid; e < BK * BN; e += kGemmThreads) {
      int n, k;
      if (sbn == 1) {
        n = e % BN;
        k = e / BN;
      } else {
        k = e % BK;
        n = e / BK;
      }
      const int gn = n0 + n, gk = k0 + k;
      sm.b[k][n] = (gn < N && gk < K) ? Bm[gk * sbk + gn * sbn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = sm.a[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = sm.b[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

// Sum over the block; the result is valid in thread 0.  `red` holds one
// float per warp.  Must be called by all threads of the block.
__device__ inline float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // `red` may still be read by a previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) t += red[w];
  return t;
}

}  // namespace bm
