// Shared device code of the row kernels that sample a multinomial unit, one
// block a row: block-wide reductions and scans, a thread's chunk of the row,
// the float64-accumulated CDF of a row's expected counts and the draws of
// its counts on the Philox stream.  Used by cd_epoch.cu (cd_softmax_sample,
// the multinomial PLL and probe) and dbm_ops.cu (dbm_softmax, a DBM's
// multinomial layer).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "philox.cuh"

namespace bm {

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

}  // namespace bm
