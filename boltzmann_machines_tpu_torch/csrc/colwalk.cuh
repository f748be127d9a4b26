// Shared device code of the column-walk kernels: per-column reductions over
// the rows of a row-major matrix, split across the warps of a block.  Used by
// cd_bias_stats and cd_stats_sums (cd_epoch.cu: one kernel body, column sums
// over the batch with and without the update) and dbm_max_norm (dbm_ops.cu:
// column norms of W); dbm_msre's grid reduction (dbm_ops.cu) takes its
// 16-byte loads and alignment test.
//
// A block owns a tile of consecutive columns (kColTile = 32 for
// cd_bias_stats and cd_stats_sums, 8 for dbm_max_norm).  Its lanes read
// along rows: with VW = 4 (every row 16-byte aligned), TILE / 4 lanes cover
// one row of the tile, 16 bytes a lane; with VW = 1, TILE lanes do.  So a
// warp covers 32 VW / TILE rows at once and the block's kColThreads threads
// form kGroups row groups; group g reads rows g, g + kGroups, ...  The
// values are combined in a fixed order, never by atomics (cd_bias_stats,
// cd_stats_sums: staged and added in row order; dbm_max_norm: per-group
// sums, a shuffle tree, then the warps in order), so the results do not
// depend on the schedule and a rerun is bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bm {
namespace col {

constexpr int kColTile = 32;      // columns per block
constexpr int kColThreads = 256;  // 8 warps

template <int VW, int TILE = kColTile>
struct Map {
  static constexpr int kLanesPerRow = TILE / VW;
  static constexpr int kRowsPerWarp = 32 / kLanesPerRow;  // 4 or 1
  static constexpr int kGroups = (kColThreads / 32) * kRowsPerWarp;
  // this thread's row group and its first column within the tile
  static __device__ __forceinline__ int group() {
    return (threadIdx.x >> 5) * kRowsPerWarp + (threadIdx.x & 31) /
                                                   kLanesPerRow;
  }
  static __device__ __forceinline__ int col() {
    return ((threadIdx.x & 31) % kLanesPerRow) * VW;
  }
};

// VW consecutive floats at p (16-byte aligned when VW == 4); plain loads,
// since dbm_max_norm writes the matrix it reads
template <int VW>
__device__ __forceinline__ void load(const float* p, float (&v)[VW]) {
  if constexpr (VW == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
    v[0] = *p;
  }
}

template <int VW>
__device__ __forceinline__ void store(float* p, const float (&v)[VW]) {
  if constexpr (VW == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    p[0] = v[0];
  }
}

// Whether every pointer is 16-byte aligned (with widths that are multiples
// of 4, every row then is: the VW = 4 path).
inline bool aligned16(const void* const* ptrs, int n) {
  for (int i = 0; i < n; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) & 15u) return false;
  return true;
}

}  // namespace col
}  // namespace bm
