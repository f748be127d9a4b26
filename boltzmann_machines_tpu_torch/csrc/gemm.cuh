// Shared device code of the port's kernels: the activations, a block
// reduction and the last-block test of the grid reductions, used by
// cd_epoch.cu (the RBM's CD epoch and stats) and dbm_ops.cu (the DBM
// epoch).  The matrix products live in gemm_tc.cuh (the
// tensor-core tile of the chain's products) and assoc_tc.cuh (the
// contractions over the batch, X^T h0 - v^T h, on the same main loop).
#pragma once

#include <cuda_runtime.h>

namespace bm {

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

// Whether this block is the last of the grid to get here, once thread 0
// has written the block's partials: thread 0 fences them and counts the
// block in on `counter`; the answer reaches every thread through `flag` in
// shared memory.  The last block reads the partials with __ldcg and
// re-arms the counter to 0.  Must be called by all threads of the block.
__device__ inline bool last_block(unsigned* counter, bool* flag) {
  if (threadIdx.x == 0) {
    __threadfence();
    *flag = atomicAdd(counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  return *flag;
}

}  // namespace bm
