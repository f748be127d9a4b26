// The association kernel of the CD epoch, the CD stats and the DBM epoch,
// hand-written for Hopper (sm_90a): cd_assoc_update and cd_assoc_stats
// (cd_epoch.cu) and dbm_assoc_update (dbm_ops.cu).  They replace the
// contractions over the batch inside the TPU's CD epoch kernels
// (boltzmann_machines_tpu/ops/pallas_ops.py:347-352 in :1343, and :792), its
// stats kernels (:1147 in :1238; :947-970, :1192 in :1033) and its DBM epoch
// kernel (pallas_dbm.py:238-246 in :373).
//
//   assoc (V x H) = s0 A0^T B0 + s1 A1^T B1
//
// with A (K x V) and B (K x H) row-major activations over a batch of K rows:
// X^T h0 - v^T h (s = 1, -1) for the CD kernels, Ad^T Bd / N - Ap^T Bp / M
// (s = 1/N, -1/M) for the DBM.  Three epilogues: the CD update W += dW =
// lr (mom dW + assoc / B - l2 W - pen), the DBM update W += dW = lr (mom dW
// + assoc - l2 W - pen) (the penalty optional), and the association written
// as it is (stats).  The penalty pen[h] is subtracted from every row.
//
// What bounds it.  K is the batch (10-512), tiny; the output is W-sized
// (12.8 MB at 784x1024, 96 MB at 3072x7800): W and dW are read and written
// once, 4 V H floats (~73 us at 3072x5000 over 3.35 TB/s), and the products'
// 4 K V H operations take ~37 us there in 3xTF32 at 165 TFLOP/s (2.5x that in
// f32 on the SIMT cores).  So the operations go to the tensor cores, and the
// epilogue's bytes to TMA, overlapped with the contraction.
//
// What the design does about it:
// * The main loop is the tensor-core tile of gemm_tc.cuh (tile_accumulate)
//   with both products in one K loop of 2B (k-tiles interleaved: where the
//   products are equal, at k = 0, the sum is exactly 0), each 32-deep stage
//   accumulated apart in 3xTF32 and added times its product's scale, rounded
//   to nearest.  V is wgmma's M (128 rows per block), H its N (32 or 64
//   columns per block: the caller's n_tile, ops/gemm.py assoc_plan); every
//   element has one owner (no split-K), so a rerun is bit for bit the same.
// * Both operands are MN-major (rows of the batch): the V side (A) goes
//   through registers, read from its stage as gemm_tc.cuh reads W; the H side
//   (B) is staged as it lies and written K-major into 128-byte-swizzled hi
//   and lo tiles by the per-stage split (Operand::a_trans).
// * The update kernels load the block's 128 x n_tile tiles of W and dW by
//   TMA (128-byte swizzle, boxes of 128 rows x 32 columns) at the start,
//   while the contraction runs; the epilogue reads them in the accumulator's
//   layout (conflict-free under the swizzle), all of them before it writes
//   anything, and stores the new W and dW (the stats: the association) from
//   registers, 16 bytes a lane after a swap between lane pairs, so every
//   store fills whole 32-byte sectors and the block exits without waiting
//   for its writes.  Each element of W and dW is read once and written
//   once, the old W read before the new one is written.  Ragged edges:
//   TMA's out-of-bounds fill, masked stores.  Where a row stride or a base
//   address is no multiple of 16 bytes, the operands fill the same ring by
//   cp.async (gemm_tc.cuh) and the epilogue reads and writes device memory
//   element by element.
// * Shared memory per block: the ring (4 stages of 16 KB of A and n_tile x
//   128 bytes of B), two hi and two lo tiles of B, and the W and dW tiles:
//   194 KB at n_tile 64, 130 KB at 32; one block per SM (256 threads, the
//   accumulators in registers).

#pragma once

#include "gemm_tc.cuh"

namespace bm {
namespace tc {

enum AssocMode { kAssocStats = 0, kAssocCd = 1, kAssocDbm = 2 };

// The kernel's parameter: the tile (operand 0 and 1: B as A with a_trans,
// A as W with w_trans 0; nm = V, nb = H), the tensor maps that load W and
// dW, the outputs (W and dW, or the association alone), the update's
// scalars; `aligned`: rows of whole 16-byte units (TMA and 16-byte stores).
struct AssocArgs {
  Tile t;
  CUtensorMap tm_w[2];
  float* out[2];
  const float* pen;
  int mode, aligned;
  float div, lr, mom, l2;
};

__host__ __device__ constexpr int assoc_epi_offset(int nt) {
  return (ring_bytes(nt, true) + 1023) & ~1023;
}

// the ring, the W and dW tiles, their barrier, and the alignment slack
__host__ __device__ constexpr int assoc_smem_bytes(int nt) {
  return 1024 + assoc_epi_offset(nt) + 2 * kTileM * nt * 4 + 8;
}

// element (v < 128, h < n_tile) of a W or dW tile: box h / 32 of 128 rows
// of 32 floats, 128-byte swizzle
__device__ __forceinline__ int epi_offset(int v, int h) {
  return (h >> 5) * (kTileM * kTileK) + sw128(v, h & 31);
}

template <int NT>
__global__ void __launch_bounds__(kThreads, 1)
    assoc_kernel(const __grid_constant__ AssocArgs p) {
  extern __shared__ __align__(16) unsigned char assoc_smem[];
  float* E =
      reinterpret_cast<float*>(align_smem(assoc_smem) + assoc_epi_offset(NT));
  uint64_t* ebar = reinterpret_cast<uint64_t*>(E + 2 * kTileM * NT);
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kTileM, b0 = blockIdx.y * NT;
  const bool update = p.mode != kAssocStats;
  const bool prefetch = update && p.aligned;
  if (prefetch && tid == 0) {
    mbar_init(ebar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (prefetch && tid == 0) {
    mbar_expect_tx(ebar, 2 * kTileM * NT * 4);
    for (int o = 0; o < 2; ++o)
      for (int i = 0; i < NT / 32; ++i)
        tma_load_2d(E + o * kTileM * NT + i * kTileM * kTileK, &p.tm_w[o],
                    b0 + 32 * i, m0, ebar);
  }
  float d[NT / 2];
  NoPrologue none;
  tile_accumulate<NT, true>(p.t, assoc_smem, d, none);  // one slice: true
  if (prefetch) mbar_wait(ebar, 0);

  // thread's accumulator (wgmma_tf32.cuh): rows v = 16 warp + g (+ 8),
  // columns h = 8 i + 2 q (+ 1); element j = 4 i + 2 rr + c of d.  The
  // epilogue loads all it reads (W, dW, the penalty) before it writes any
  // of it: interleaved, each load would wait for the stores before it.
  const int warp = tid >> 5, g = (tid & 31) >> 2, q = tid & 3;
  const int V = p.t.nm, H = p.t.nb;
  constexpr int kN = NT / 2;
  float w[kN], dw[kN], pen[NT / 4];
  auto at = [&](int j, int& vl, int& hl) {
    vl = 16 * warp + g + 8 * ((j >> 1) & 1);
    hl = 8 * (j >> 2) + 2 * q + (j & 1);
  };
#pragma unroll
  for (int i = 0; i < NT / 4; ++i) {
    const int h = b0 + 8 * (i >> 1) + 2 * q + (i & 1);
    pen[i] = p.pen != nullptr && h < H ? __ldg(p.pen + h) : 0.f;
  }
  if (update) {
#pragma unroll
    for (int j = 0; j < kN; j += 2) {  // pairs of columns: float2
      int vl, hl;
      at(j, vl, hl);
      if (p.aligned) {
        const float2 x = *reinterpret_cast<const float2*>(
            E + epi_offset(vl, hl));
        const float2 y = *reinterpret_cast<const float2*>(
            E + kTileM * NT + epi_offset(vl, hl));
        w[j] = x.x;
        w[j + 1] = x.y;
        dw[j] = y.x;
        dw[j + 1] = y.y;
      } else {
        const long long idx = (long long)(m0 + vl) * H + b0 + hl;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const bool ok = m0 + vl < V && b0 + hl + c < H;
          w[j + c] = ok ? p.out[0][idx + c] : 0.f;
          dw[j + c] = ok ? p.out[1][idx + c] : 0.f;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      // the penalty is subtracted from every row of dW; the CD association
      // is divided by B here, as the plain version divides it (so the
      // stats' sums and one epoch step's dW agree bit for bit), the DBM's
      // arrives scaled (1/N, -1/M)
      const float pj = pen[2 * (j >> 2) + (j & 1)];
      float acc;
      if (p.mode == kAssocCd) {
        acc = p.lr * (p.mom * dw[j] + (d[j] / p.div - p.l2 * w[j]) - pj);
      } else {
        float gr = d[j] - p.l2 * w[j];
        if (p.pen != nullptr) gr = gr - pj;
        acc = p.lr * (p.mom * dw[j] + gr);
      }
      dw[j] = acc;
      d[j] = w[j] + acc;  // the new W
    }
  }
  // The stores, straight from registers: the block need not wait for them
  // before it exits, so they drain while the SM's next block runs.  Rows of
  // 16 bytes (H % 4 == 0): lanes q and q ^ 1 swap a pair, so that even lanes
  // hold 4 columns of row g and odd lanes 4 of row g + 8, and every store
  // fills whole 32-byte sectors.
  auto store = [&](const float(&x)[kN], float* out) {
    if (p.aligned) {
      const bool odd = q & 1;
      const int row = m0 + 16 * warp + g + (odd ? 8 : 0);
#pragma unroll
      for (int j = 0; j < kN; j += 4) {
        const float r0 =
            __shfl_xor_sync(0xffffffffu, odd ? x[j] : x[j + 2], 1);
        const float r1 =
            __shfl_xor_sync(0xffffffffu, odd ? x[j + 1] : x[j + 3], 1);
        const int col = b0 + 8 * (j >> 2) + 2 * (q & ~1);
        if (row < V && col < H)
          *reinterpret_cast<float4*>(out + (long long)row * H + col) =
              odd ? make_float4(r0, r1, x[j + 2], x[j + 3])
                  : make_float4(x[j], x[j + 1], r0, r1);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        int vl, hl;
        at(j, vl, hl);
        if (m0 + vl < V && b0 + hl < H)
          out[(long long)(m0 + vl) * H + b0 + hl] = x[j];
      }
    }
  };
  store(d, p.out[0]);
  if (update) store(dw, p.out[1]);
}

// A (V, H) row-major float tensor map of boxes of 128 rows x 32 columns.
inline int w_map(CUtensorMap* m, float* p, int V, int H) {
  const cuuint64_t dims[2] = {(cuuint64_t)H, (cuuint64_t)V};
  const cuuint64_t strides[1] = {(cuuint64_t)H * 4};
  const cuuint32_t box[2] = {kTileK, kTileM}, unit[2] = {1, 1};
  return cuTensorMapEncodeTiled(
             m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, p, dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? 0
             : (int)cudaErrorInvalidValue;
}

// static: each library that includes this header grants its own kernel
// (a static local of a function with external linkage would be one object
// shared by every library loaded in the process)
template <int NT>
static int launch_assoc_nt(const AssocArgs& a, cudaStream_t stream) {
  static bool granted[64] = {};
  const int bytes = assoc_smem_bytes(NT);
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  if (dev >= 64 || !granted[dev]) {
    err = (int)cudaFuncSetAttribute(
        assoc_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err) return err;
    if (dev < 64) granted[dev] = true;
  }
  assoc_kernel<NT><<<tile_grid(a.t), kThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// One association launch: products (A0, B0, K0, s0) and (A1, B1, K1, s1),
// each A (K, V) and B (K, H) row-major; `mode` picks the epilogue on out0
// (W, or the association) and out1 (dW); `n_tile` (32 or 64) the columns
// of H per block, ops/gemm.py's assoc_plan.  Returns a cudaError_t.
inline int launch_assoc(const float* A0, const float* B0, int K0, float s0,
                        const float* A1, const float* B1, int K1, float s1,
                        int V, int H, int mode, float* out0, float* out1,
                        const float* pen, float div, float lr, float mom,
                        float l2, int n_tile, cudaStream_t stream) {
  if (V < 1 || H < 1 || K0 < 1 || K1 < 1 || (n_tile != 32 && n_tile != 64))
    return (int)cudaErrorInvalidValue;
  Operand ops[2];
  ops[0] = {B0, A0, H, V, K0, 0, 1, s0};
  ops[1] = {B1, A1, H, V, K1, 0, 1, s1};
  AssocArgs a;
  int err = setup_tile(&a.t, ops, 2, H, V, n_tile, 1, nullptr, nullptr);
  if (err) return err;
  a.out[0] = out0;
  a.out[1] = out1;
  a.pen = pen;
  a.mode = mode;
  a.div = div;
  a.lr = lr;
  a.mom = mom;
  a.l2 = l2;
  // rows of whole 16-byte units: W and dW (the update) loaded by TMA, the
  // outputs stored 16 bytes at a time
  const int n_out = mode == kAssocStats ? 1 : 2;
  a.aligned = H % 4 == 0;
  for (int o = 0; o < n_out; ++o)
    a.aligned = a.aligned && reinterpret_cast<uintptr_t>(a.out[o]) % 16 == 0;
  for (int o = 0; a.aligned && mode != kAssocStats && o < 2; ++o) {
    err = w_map(&a.tm_w[o], a.out[o], V, H);
    if (err) return err;
  }
  return a.t.n_tile == 32 ? launch_assoc_nt<32>(a, stream)
                          : launch_assoc_nt<64>(a, stream);
}

}  // namespace tc
}  // namespace bm
