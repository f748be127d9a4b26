// The tensor-core GEMM tile of the chain's products, hand-written for Hopper
// (sm_90a): the main loop of cd_gemm_act (cd_epoch.cu), dbm_gemm_act
// (dbm_ops.cu) and the association kernels (assoc_tc.cuh).  The first two
// carry the products of the TPU's CD epoch and stats
// kernels (boltzmann_machines_tpu/ops/pallas_ops.py:1343, :792, :1238,
// :1033) and of its DBM epoch, sampler and AIS kernels (pallas_dbm.py:373,
// :481, :516).  On the TPU each product sits inside the Pallas body with W
// resident in VMEM; here W streams from device memory (or the 50 MB L2).
//
// What bounds a product.  out (B x N) = A (B x K) . W, with W (K x N) or
// W^T, at a batch B of 1-256 rows: W (4KN bytes) is by far the largest
// operand, so at these batches a product is bound by W's bytes (3072x5000:
// 61 MB, 18 us at 3.35 TB/s; in 3xTF32 its operations take about as long at
// 165 TFLOP/s, in f32 on the SIMT cores 2.5x longer) or, for the small
// DBM/AIS products (a microsecond of either), by the latency of the launch
// and of the K loop.
//
// What the design does about it:
// * Swap A and B: out^T = W^(T) . A^T, so the model dimension is wgmma's M
//   (64 rows per warpgroup, two warpgroups: 128 rows per block, one block
//   per SM) and the batch is its N (a width of wgmma_tf32.cuh, 8..128): no
//   padding rows, each block streams its own 128 rows of W once, and both
//   warpgroups share one activation tile.
// * 3xTF32 on the tensor cores, for f32 accuracy: each operand is split into
//   hi = tf32(x) and lo = tf32(x - hi) (round to nearest), and lo.hi +
//   hi.lo + hi.hi accumulate in f32 (small terms first), each 32-deep stage
//   into an accumulator of its own that is added to the block's sum (times
//   its product's scale) by an f32 FMA rounded to nearest.  Products of
//   tf32 values are exact in f32, so the error is the dropped lo.lo and
//   lo's rounding (~2^-22 relative) and the sums.  Plain TF32 (~1e-3)
//   would break the kernel-vs-plain comparisons and the draw-by-draw ones.
// * wgmma reads tf32 from shared memory only K-major.  The activation tile
//   (rows of 32 k, K-major in A's own layout) is split once per stage into
//   hi (in place) and lo copies that wgmma reads through 128-byte-swizzle
//   descriptors; W's fragment comes from registers, loaded from the stage
//   (either orientation of W) and split there.
// * A ring of stages(n_tile) stages in shared memory, filled by TMA
//   (cp.async.bulk.tensor, 128-byte swizzle, one mbarrier per stage), so the
//   next tiles of W and A load while wgmma runs; each stage's wgmmas run
//   while the next stage is split.  Where a row stride or a base address is
//   not a multiple of 16 bytes (TMA cannot take it), the same kernel fills
//   the same ring, in the same swizzled layout, with 4-byte cp.async copies.
//   Ragged edges are zero-filled on load (TMA's out-of-bounds fill,
//   cp.async's src-size 0) and masked in the epilogue.
// * Deterministic split-K: grid (model tiles, batch tiles, splits), the
//   plan (ops/gemm.py) choosing narrower batch tiles and K slices so that
//   ~100-132 blocks run.  Slice s takes k-tiles [s T / S, (s + 1) T / S) of
//   the T 32-deep tiles of both products; every slice writes its partial
//   tile to an f32 workspace, and the last block of a tile to finish (a
//   per-tile counter, __threadfence, as cd_metrics does) sums slices 0..S-1
//   in that order, runs the epilogue and re-arms the counter.  No float
//   atomics: same-seed runs are bit-identical at a given plan.
//
// The two-product form (A1.W1 + A2.W2 of a DBM middle layer) is one K loop
// over both ranges.  The association kernels (assoc_tc.cuh: X^T h0 - v^T h
// with the update as epilogue) run the same main loop, tile_accumulate,
// with A given as (k, rows) (Operand::a_trans: staged as it lies, written
// K-major by the split), the two products' k-tiles interleaved and each
// stage added times its product's scale (Operand::scale: 1 and -1, or
// 1/N and -1/M).  The kernel allocates nothing: the caller passes the
// workspace (splits x 128 x n_tile floats per tile) and the zeroed
// counters.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_tf32.cuh"

namespace bm {
namespace tc {

constexpr int kTileM = 128;  // model rows per block: wgmma's 64 per warpgroup
constexpr int kTileK = 32;   // K per stage: 128 bytes of f32
constexpr int kThreads = 256;  // two warpgroups
constexpr int kTileStride = kTileM + 4;  // row stride of the staged output
constexpr int kWBytes = kTileM * kTileK * 4;

// One product's operands: A (rows, k) with row stride lda, or (k, rows)
// when a_trans (the association's hidden side); W (k, nm) with row stride
// ldw (propup, w_trans 0) or (nm, k) (propdown, w_trans 1).  Each 32-deep
// stage of the product is added to the block's sum times `scale`.
struct Operand {
  const float* a;
  const float* w;
  long long lda, ldw;
  int k, w_trans;
  int a_trans = 0;
  float scale = 1.f;
};

// Everything a block of the tile needs; the tensor maps are used only when
// tma != 0.  nb batch rows, nm model columns of the output.
struct Tile {
  CUtensorMap tm_a[2];
  CUtensorMap tm_w[2];
  Operand op[2];
  int n_ops, nb, nm, n_tile, splits, tma;
  float* ws;
  unsigned* counters;
};

// Ring depth: as many stages as fit beside the two lo tiles (the widest
// batch tiles take 4 of 29-32 KB, the narrower 6).  With a transposed A
// (trans_a: the association kernels) 4: their K is a batch of <= 16
// k-tiles, and their W and dW tiles take the room.
__host__ __device__ constexpr int stages(int n_tile, bool trans_a = false) {
  return trans_a || n_tile > 64 ? 4 : 6;
}

// stages of (W tile, A tile), two lo copies of A (and two hi copies when
// A is transposed), the barriers
__host__ __device__ constexpr int ring_bytes(int n_tile, bool trans_a) {
  return stages(n_tile, trans_a) * (kWBytes + n_tile * kTileK * 4) +
         (trans_a ? 4 : 2) * n_tile * kTileK * 4 +
         stages(n_tile, trans_a) * 8;
}

// the ring and 1024 bytes of slack to align it for the 128-byte swizzle
__host__ __device__ constexpr int smem_bytes(int n_tile) {
  return ring_bytes(n_tile, false) + 1024;
}

// ------------------------------------------------------------------ PTX
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar))
      : "memory");
}

// 4-byte asynchronous copy; zero-filled when !valid
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keeps a register live and unmoved across the asynchronous wgmma
__device__ __forceinline__ void fence_reg(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}
__device__ __forceinline__ void fence_reg(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// Shared-memory descriptor of a K-major operand in the 128-byte swizzle:
// rows of 128 bytes, 8-row groups 1024 bytes apart (SBO); LBO unused.
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFFull) >> 4) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// Offset (in floats) of element (row r, column c < 32) of a tile of 128-byte
// rows in TMA's 128-byte swizzle: 16-byte chunk c/4 of row r is stored at
// chunk (c/4) ^ (r % 8).
__device__ __forceinline__ int sw128(int r, int c) {
  return r * kTileK + ((((c >> 2) ^ (r & 7))) << 2) + (c & 3);
}

// W's element (model row m < 128, k < 32) in a stage: propdown (w_trans) one
// {32 k, 128 m} box; propup four {32 m, 32 k} boxes side by side.
__device__ __forceinline__ int w_offset(int w_trans, int m, int k) {
  return w_trans ? sw128(m, k) : (m >> 5) * (kTileK * 32) + sw128(k, m & 31);
}

// ------------------------------------------------------------- main loop
__device__ __forceinline__ unsigned char* align_smem(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// The operand and first k of k-tile kt of the K loop, over nk0 k-tiles of
// product 0 and nk1 of product 1: product 0's first, then product 1's; or,
// interleaved, tile j of product 0 then tile j of product 1 while both have
// one.  The association interleaves: where its two products are equal (k =
// 0) each stage of one cancels the same stage of the other, so the sum is
// exactly 0.
__device__ __forceinline__ void ktile(int kt, int nk0, int nk1,
                                      bool interleave, int& o, int& k0) {
  int j;
  const int p = nk0 < nk1 ? nk0 : nk1;
  if (!interleave) {
    o = kt < nk0 ? 0 : 1;
    j = o ? kt - nk0 : kt;
  } else if (kt < 2 * p) {
    o = kt & 1;
    j = kt >> 1;
  } else {
    o = nk0 > nk1 ? 0 : 1;
    j = kt - p;
  }
  k0 = j * kTileK;
}

// A prologue that does nothing (tile_accumulate's default).
struct NoPrologue {
  __device__ void start() {}
  __device__ void finish() {}
};

// Accumulates the block's slice of the product into d, in wgmma's
// accumulator layout (wgmma_tf32.cuh); with split-K, the sum over all
// slices (returns false in the blocks that are not the last of their tile,
// which then stop).  kTransA: every product's A is (k, rows) (Operand::
// a_trans), staged as it lies and written K-major by the split, and the
// products' k-tiles interleave.  `pro.start()` runs in every thread before
// the ring's first loads are issued and `pro.finish()` once they are, while
// they are in flight (an AIS beta's first dbm_gemm_act launch runs the
// log-weight update of the beta before there).  Must be called by all
// kThreads threads; `smem_raw` is the dynamic shared memory.
template <int NT, bool kTransA, class Prologue>
__device__ __forceinline__ bool tile_accumulate(const Tile& t,
                                                unsigned char* smem_raw,
                                                float (&d)[NT / 2],
                                                Prologue& pro) {
  constexpr int S = stages(NT, kTransA);
  constexpr int kABytes = NT * kTileK * 4;
  constexpr int kStageBytes = kWBytes + kABytes;
  constexpr int kA4 = kABytes / 16;  // float4 per activation tile
  __shared__ int is_last;
  unsigned char* smem = align_smem(smem_raw);
  // kTransA: two hi tiles; then two lo tiles; then the barriers
  float* his = reinterpret_cast<float*>(smem + S * kStageBytes);
  float* los = his + (kTransA ? 2 : 0) * (kABytes / 4);
  uint64_t* bars = reinterpret_cast<uint64_t*>(los + 2 * (kABytes / 4));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int m0 = blockIdx.x * kTileM, b0 = blockIdx.y * NT;

  const int nk0 = t.n_ops > 0 ? (t.op[0].k + kTileK - 1) / kTileK : 0;
  const int nk1 = t.n_ops > 1 ? (t.op[1].k + kTileK - 1) / kTileK : 0;
  const int nkt = nk0 + nk1;
  const int kt0 = (int)((long long)blockIdx.z * nkt / t.splits);
  const int kt1 = (int)((long long)(blockIdx.z + 1) * nkt / t.splits);
  const int n_local = kt1 - kt0;

  pro.start();
  if (t.tma && tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(&bars[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // load local k-tile j into stage j % S
  auto issue = [&](int j) {
    int o, kk;
    ktile(kt0 + j, nk0, nk1, kTransA, o, kk);
    const Operand& op = t.op[o];
    unsigned char* st = smem + (j % S) * kStageBytes;
    float* ws = reinterpret_cast<float*>(st);
    float* as = reinterpret_cast<float*>(st + kWBytes);
    if (t.tma) {
      if (tid == 0) {
        uint64_t* bar = &bars[j % S];
        mbar_expect_tx(bar, kStageBytes);
        if (op.w_trans) {
          tma_load_2d(ws, &t.tm_w[o], kk, m0, bar);
        } else {
          for (int i = 0; i < kTileM / 32; ++i)
            tma_load_2d(ws + i * kTileK * 32, &t.tm_w[o], m0 + 32 * i, kk,
                        bar);
        }
        if (kTransA)
          tma_load_2d(as, &t.tm_a[o], b0, kk, bar);
        else
          tma_load_2d(as, &t.tm_a[o], kk, b0, bar);
      }
      return;
    }
    for (int e = tid; e < kTileM * kTileK; e += kThreads) {
      int m, k;
      if (op.w_trans) {  // neighbouring threads on neighbouring addresses
        m = e >> 5;
        k = e & 31;
      } else {
        k = e / kTileM;
        m = e % kTileM;
      }
      const bool ok = m0 + m < t.nm && kk + k < op.k;
      const float* src =
          ok ? (op.w_trans ? op.w + (long long)(m0 + m) * op.ldw + kk + k
                           : op.w + (long long)(kk + k) * op.ldw + m0 + m)
             : op.w;
      cp_async4(ws + w_offset(op.w_trans, m, k), src, ok);
    }
    for (int e = tid; e < NT * kTileK; e += kThreads) {
      if (kTransA) {  // (32 k, NT rows) as it lies
        const int k = e / NT, b = e % NT;
        const bool ok = b0 + b < t.nb && kk + k < op.k;
        cp_async4(as + e,
                  ok ? op.a + (long long)(kk + k) * op.lda + b0 + b : op.a,
                  ok);
      } else {
        const int b = e >> 5, k = e & 31;
        const bool ok = b0 + b < t.nb && kk + k < op.k;
        cp_async4(as + sw128(b, k),
                  ok ? op.a + (long long)(b0 + b) * op.lda + kk + k : op.a,
                  ok);
      }
    }
  };

  // d: the block's sum; c: one stage's product.  Each stage's 12 wgmmas
  // accumulate into a zeroed c, which is then added to d, times its
  // product's scale, rounded to nearest: the tensor cores' own accumulation
  // truncates, and over K = 5000 (~2000 wgmma steps into one accumulator)
  // that bias alone reached ~1e-5 at 3072x5000; per stage it stays at the
  // scale of c.
  float c[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) d[i] = c[i] = 0.f;

  // prepare(j, f): wait for k-tile j, split its activation tile (hi in
  // place, or into hi buffer j % 2 when transposed; lo into lo buffer
  // j % 2) and load W's fragments of the tile (hi and lo) into registers f.
  auto prepare = [&](int j, uint32_t(&f)[2][4][4]) {
    const int s = j % S;
    if (t.tma) {
      mbar_wait(&bars[s], (unsigned)(j / S) & 1u);
    } else {
      cp_async_wait<S - 2>();
      __syncthreads();
    }
    unsigned char* st = smem + s * kStageBytes;
    const float* wsm = reinterpret_cast<const float*>(st);
    float4* as = reinterpret_cast<float4*>(st + kWBytes);
    float4* lo = reinterpret_cast<float4*>(los + (j & 1) * (kABytes / 4));
    if (kTransA) {
      // element (k, b) of the staged (32 k, NT) tile to row b, column k of
      // the swizzled hi and lo tiles, four k per thread: reads of
      // neighbouring b, 16-byte writes to eight distinct chunks
      const float* at = reinterpret_cast<const float*>(as);
      float4* hi = reinterpret_cast<float4*>(his + (j & 1) * (kABytes / 4));
#pragma unroll
      for (int i = 0; i < (kA4 + kThreads - 1) / kThreads; ++i) {
        const int e = tid + i * kThreads;
        if (kA4 % kThreads == 0 || e < kA4) {
          const int b = e % NT, k4 = e / NT;
          float x[4], h[4], l[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            x[r] = at[(4 * k4 + r) * NT + b];
            h[r] = tf32_rna(x[r]);
            l[r] = tf32_rna(x[r] - h[r]);
          }
          const int off = sw128(b, 4 * k4) >> 2;
          hi[off] = make_float4(h[0], h[1], h[2], h[3]);
          lo[off] = make_float4(l[0], l[1], l[2], l[3]);
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < (kA4 + kThreads - 1) / kThreads; ++i) {
        const int e = tid + i * kThreads;
        if (kA4 % kThreads == 0 || e < kA4) {
          const float4 x = as[e];
          float4 h, l;
          h.x = tf32_rna(x.x);
          h.y = tf32_rna(x.y);
          h.z = tf32_rna(x.z);
          h.w = tf32_rna(x.w);
          l.x = tf32_rna(x.x - h.x);
          l.y = tf32_rna(x.y - h.y);
          l.z = tf32_rna(x.z - h.z);
          l.w = tf32_rna(x.w - h.w);
          as[e] = h;
          lo[e] = l;
        }
      }
    }
    int o, k0;
    ktile(kt0 + j, nk0, nk1, kTransA, o, k0);
    const int w_trans = t.op[o].w_trans;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = 16 * warp + g + (r & 1) * 8;
        const int k = kk * 8 + q + (r >> 1) * 4;
        const float x = wsm[w_offset(w_trans, m, k)], h = tf32_rna(x);
        f[0][kk][r] = __float_as_uint(h);
        f[1][kk][r] = __float_as_uint(tf32_rna(x - h));
      }
    }
    fence_proxy_async();  // the split's generic writes, visible to wgmma
  };

  // step(j): the 12 wgmmas of k-tile j (fragments f) run while k-tile j + 1
  // is prepared (into fn); then they are retired (d += scale c), stage
  // j % S is refilled with k-tile j + S, and the barrier makes the next
  // split visible.  No wgmma is in flight across a step, so the compiler
  // keeps the accumulator registers in place.
  auto step = [&](int j, uint32_t(&f)[2][4][4], uint32_t(&fn)[2][4][4]) {
    unsigned char* st = smem + (j % S) * kStageBytes;
    {
#pragma unroll
      for (int i = 0; i < NT / 2; ++i) fence_reg(c[i]);
      wgmma_fence();
      const uint64_t dh =
          desc_sw128(kTransA ? his + (j & 1) * (kABytes / 4)
                             : reinterpret_cast<float*>(st + kWBytes));
      const uint64_t dl = desc_sw128(los + (j & 1) * (kABytes / 4));
      // +32 bytes per 8-deep step inside the swizzled 128-byte rows.  The
      // eight small products (lo.hi, hi.lo) first, while c is small: each
      // wgmma step truncates c to f32, so the four large ones (hi.hi) add
      // the only truncations at the scale of the sum.
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_tf32<NT>(c, f[1][kk], dh + 2 * kk);
        wgmma_tf32<NT>(c, f[0][kk], dl + 2 * kk);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_tf32<NT>(c, f[0][kk], dh + 2 * kk);
      wgmma_commit();
    }
    if (j + 1 < n_local) prepare(j + 1, fn);
    {
      int o, k0;
      ktile(kt0 + j, nk0, nk1, kTransA, o, k0);
      const float scale = t.op[o].scale;
      wgmma_wait_all();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          fence_reg(f[0][kk][r]);
          fence_reg(f[1][kk][r]);
        }
#pragma unroll
      for (int i = 0; i < NT / 2; ++i) {
        fence_reg(c[i]);
        d[i] = __fmaf_rn(c[i], scale, d[i]);
        c[i] = 0.f;
      }
    }
    __syncthreads();  // stage j % S and lo j % 2 free; split j + 1 visible
    if (j + S < n_local) issue(j + S);
    if (!t.tma) cp_async_commit();
  };

  for (int j = 0; j < S; ++j) {
    if (j < n_local) issue(j);
    if (!t.tma) cp_async_commit();
  }
  pro.finish();
  uint32_t fa[2][4][4], fb[2][4][4];
  if (n_local > 0) {
    prepare(0, fa);
    __syncthreads();
  }
  for (int j = 0; j < n_local; j += 2) {
    step(j, fa, fb);
    if (j + 1 < n_local) step(j + 1, fb, fa);
  }
  if (!t.tma) cp_async_wait<0>();

  // split-K: every slice writes its partial tile from registers, in the
  // accumulator's own layout (float4 i of thread tid at i * kThreads + tid,
  // coalesced); the last block of the tile to finish sums slices 0..S-1 in
  // that order into the same registers, all loads of a slice in flight.
  if (t.splits > 1) {
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    constexpr int kPart4 = kTileM * NT / 4, kRuns = NT / 8;
    float4* part = reinterpret_cast<float4*>(t.ws) +
                   (long long)tile * t.splits * kPart4;
#pragma unroll
    for (int i = 0; i < kRuns; ++i)
      part[(long long)blockIdx.z * kPart4 + i * kThreads + tid] = make_float4(
          d[4 * i], d[4 * i + 1], d[4 * i + 2], d[4 * i + 3]);
    __threadfence();
    __syncthreads();
    if (tid == 0)
      is_last = atomicAdd(&t.counters[tile], 1u) == (unsigned)t.splits - 1u;
    __syncthreads();
    if (!is_last) return false;
    __threadfence();
    float4 v[kRuns];
#pragma unroll
    for (int i = 0; i < kRuns; ++i) v[i] = __ldcg(&part[i * kThreads + tid]);
    for (int s = 1; s < t.splits; ++s) {
      float4 w[kRuns];
#pragma unroll
      for (int i = 0; i < kRuns; ++i)
        w[i] = __ldcg(&part[(long long)s * kPart4 + i * kThreads + tid]);
#pragma unroll
      for (int i = 0; i < kRuns; ++i) {
        v[i].x += w[i].x;
        v[i].y += w[i].y;
        v[i].z += w[i].z;
        v[i].w += w[i].w;
      }
    }
#pragma unroll
    for (int i = 0; i < kRuns; ++i) {
      d[4 * i] = v[i].x;
      d[4 * i + 1] = v[i].y;
      d[4 * i + 2] = v[i].z;
      d[4 * i + 3] = v[i].w;
    }
    if (tid == 0) t.counters[tile] = 0u;  // re-armed for the next launch
  }
  return true;
}

// tile_accumulate (with its prologue `pro`), then the 128 x n_tile result
// staged in shared memory for the epilogue, out_tile[b * kTileStride + m]
// (batch column b, model row m).
template <int NT, class Prologue>
__device__ bool tile_product(const Tile& t, unsigned char* smem_raw,
                             float*& out_tile, Prologue& pro) {
  float d[NT / 2];
  if (!tile_accumulate<NT, false>(t, smem_raw, d, pro)) return false;
  // no copy is in flight any more, so the ring's memory is free
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2,
            q = threadIdx.x & 3;
  float* T = reinterpret_cast<float*>(align_smem(smem_raw));
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NT / 8; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int m = 16 * warp + g + (r >> 1) * 8;
      const int b = 8 * i + 2 * q + (r & 1);
      T[b * kTileStride + m] = d[4 * i + r];
    }
  __syncthreads();
  out_tile = T;
  return true;
}

template <int NT>
__device__ bool tile_product(const Tile& t, unsigned char* smem_raw,
                             float*& out_tile) {
  NoPrologue none;
  return tile_product<NT>(t, smem_raw, out_tile, none);
}

// ------------------------------------------------------------ host side
// Fills `t` from the launch's products and plan.  TMA is used when every
// base address and row stride is a multiple of 16 bytes, else cp.async.
// Returns a cudaError_t (cudaErrorInvalidValue for a plan or layout the
// tile does not take).
inline int setup_tile(Tile* t, const Operand* ops, int n_ops, int nb, int nm,
                      int n_tile, int splits, float* ws, unsigned* counters) {
  if (n_ops < 0 || n_ops > 2 || nb < 1 || nm < 1 || splits < 1 ||
      n_tile < 8 || n_tile > 128 || n_tile % 8 || (splits > 1 && !ws) ||
      (splits > 1 && !counters))
    return (int)cudaErrorInvalidValue;
  *t = Tile();
  t->n_ops = n_ops;
  t->nb = nb;
  t->nm = nm;
  t->n_tile = n_tile;
  t->splits = splits;
  t->ws = ws;
  t->counters = counters;
  bool tma = true;
  for (int i = 0; i < n_ops; ++i) {
    t->op[i] = ops[i];
    const Operand& o = ops[i];
    if (o.k < 1) return (int)cudaErrorInvalidValue;
    tma = tma && (reinterpret_cast<uintptr_t>(o.a) % 16 == 0) &&
          (reinterpret_cast<uintptr_t>(o.w) % 16 == 0) && o.lda % 4 == 0 &&
          o.ldw % 4 == 0;
  }
  t->tma = tma;
  if (!tma) return 0;
  for (int i = 0; i < n_ops; ++i) {
    const Operand& o = ops[i];
    const cuuint32_t unit[2] = {1, 1};
    {  // A: (nb rows, k), swizzled boxes of n_tile rows x 32 k; or (k, nb)
       // (a_trans), plain boxes of 32 k x n_tile, split K-major later
      const cuuint64_t dims[2] = {(cuuint64_t)(o.a_trans ? nb : o.k),
                                  (cuuint64_t)(o.a_trans ? o.k : nb)};
      const cuuint64_t strides[1] = {(cuuint64_t)o.lda * 4};
      const cuuint32_t box[2] = {
          (cuuint32_t)(o.a_trans ? n_tile : kTileK),
          (cuuint32_t)(o.a_trans ? kTileK : n_tile)};
      if (cuTensorMapEncodeTiled(
              &t->tm_a[i], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
              const_cast<float*>(o.a), dims, strides, box, unit,
              CU_TENSOR_MAP_INTERLEAVE_NONE,
              o.a_trans ? CU_TENSOR_MAP_SWIZZLE_NONE
                        : CU_TENSOR_MAP_SWIZZLE_128B,
              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
        return (int)cudaErrorInvalidValue;
    }
    {  // W: (nm, k) boxes of 128 x 32 k, or (k, nm) boxes of 32 k x 32
      const cuuint64_t dims[2] = {(cuuint64_t)(o.w_trans ? o.k : nm),
                                  (cuuint64_t)(o.w_trans ? nm : o.k)};
      const cuuint64_t strides[1] = {(cuuint64_t)o.ldw * 4};
      const cuuint32_t box[2] = {kTileK,
                                 (cuuint32_t)(o.w_trans ? kTileM : 32)};
      if (cuTensorMapEncodeTiled(
              &t->tm_w[i], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
              const_cast<float*>(o.w), dims, strides, box, unit,
              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
        return (int)cudaErrorInvalidValue;
    }
  }
  return 0;
}

inline dim3 tile_grid(const Tile& t) {
  return dim3((t.nm + kTileM - 1) / kTileM,
              (t.nb + t.n_tile - 1) / t.n_tile, t.splits);
}

// Launches kernel<NT> for the tile's n_tile (the widths of wgmma_tf32.cuh),
// granting its dynamic shared memory first.
#define BM_TC_DISPATCH(KERNEL, TILE, ARGS, STREAM, ERR)                     \
  do {                                                                     \
    switch ((TILE).n_tile) {                                               \
      BM_TC_CASE(KERNEL, 8, TILE, ARGS, STREAM, ERR)                       \
      BM_TC_CASE(KERNEL, 16, TILE, ARGS, STREAM, ERR)                      \
      BM_TC_CASE(KERNEL, 32, TILE, ARGS, STREAM, ERR)                      \
      BM_TC_CASE(KERNEL, 56, TILE, ARGS, STREAM, ERR)                      \
      BM_TC_CASE(KERNEL, 64, TILE, ARGS, STREAM, ERR)                      \
      BM_TC_CASE(KERNEL, 104, TILE, ARGS, STREAM, ERR)                     \
      BM_TC_CASE(KERNEL, 128, TILE, ARGS, STREAM, ERR)                     \
      default:                                                             \
        ERR = (int)cudaErrorInvalidValue;                                  \
    }                                                                      \
  } while (0)

#define BM_TC_CASE(KERNEL, NT, TILE, ARGS, STREAM, ERR)                     \
  case NT: {                                                               \
    static bool granted[64] = {};                                          \
    const int bytes = bm::tc::smem_bytes(NT);                              \
    int dev = 0;                                                           \
    ERR = (int)cudaGetDevice(&dev);                                        \
    if (ERR) break;                                                        \
    if (dev >= 64 || !granted[dev]) {                                      \
      ERR = (int)cudaFuncSetAttribute(                                     \
          KERNEL<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes); \
      if (ERR) break;                                                      \
      if (dev < 64) granted[dev] = true;                                   \
    }                                                                      \
    KERNEL<NT><<<bm::tc::tile_grid(TILE), bm::tc::kThreads, bytes,         \
                 STREAM>>>(ARGS);                                          \
    ERR = (int)cudaGetLastError();                                         \
    break;                                                                 \
  }

}  // namespace tc
}  // namespace bm
