// Philox4x32-10 counter-based generator (Salmon et al., SC'11), the device
// side of ops/philox.py: both compute the same rounds, so a kernel and its
// plain PyTorch version draw identical uniforms.
//
// Replaces the TPU kernels' hardware PRNG (`_uniform_bits`,
// boltzmann_machines_tpu/ops/pallas_ops.py:39), which no other device can
// reproduce.  Keyed by (epoch seed, global iteration); the counter holds the
// element index, the stream id and the data-parallel shard id (0 outside a
// mesh; the TPU mixes it into the seed instead, pallas_ops.py:1096-1100) --
// see ops/philox.py for the stream layout.
#pragma once

#include <stdint.h>

namespace bm {

constexpr unsigned kPhiloxM0 = 0xD2511F53u;
constexpr unsigned kPhiloxM1 = 0xCD9E8D57u;
constexpr unsigned kPhiloxW0 = 0x9E3779B9u;
constexpr unsigned kPhiloxW1 = 0xBB67AE85u;
constexpr unsigned kStreamPll = 0xFFFFu;
constexpr unsigned kStreamPllHhat = 0xFFFEu;
constexpr unsigned kStreamPllHhatFlip = 0xFFFDu;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += kPhiloxW0;
      k.y += kPhiloxW1;
    }
    const unsigned hi0 = __umulhi(kPhiloxM0, c.x), lo0 = kPhiloxM0 * c.x;
    const unsigned hi1 = __umulhi(kPhiloxM1, c.z), lo1 = kPhiloxM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

// Uniform in [0, 1) from one output word, by the mantissa trick of the TPU
// kernels: bitcast((bits >> 9) | 0x3f800000) - 1 == (bits >> 9) * 2^-23.
__device__ __forceinline__ float uniform_from_bits(unsigned bits) {
  return __uint_as_float((bits >> 9) | 0x3f800000u) - 1.0f;
}

// Standard normal by Box-Muller on the uniforms of output words 0 and 1 of
// one counter (ops/philox.py `normal`; the TPU's `_normal_from_bits`,
// pallas_ops.py:46-51).  Built without --use_fast_math, so logf, cosf and
// sqrtf stay within an ulp or two of torch's.
__device__ __forceinline__ float box_muller(unsigned w0, unsigned w1) {
  const float u1 = uniform_from_bits(w0);
  const float u2 = uniform_from_bits(w1);
  const float rad = sqrtf(__fmul_rn(-2.f, logf(fmaxf(u1, 1e-7f))));
  return __fmul_rn(rad, cosf(__fmul_rn(6.2831854820251465f, u2)));
}

// The uniform of output word 0 of counter (idx, stream, shard, 0).
__device__ __forceinline__ float philox_uniform(unsigned seed, unsigned it,
                                                unsigned stream,
                                                unsigned idx,
                                                unsigned shard = 0u) {
  return uniform_from_bits(philox4x32_10(make_uint4(idx, stream, shard, 0u),
                                         make_uint2(seed, it)).x);
}

// The normal of counter (idx, stream, shard, 0).
__device__ __forceinline__ float philox_normal(unsigned seed, unsigned it,
                                               unsigned stream,
                                               unsigned idx,
                                               unsigned shard = 0u) {
  const uint4 r = philox4x32_10(make_uint4(idx, stream, shard, 0u),
                                make_uint2(seed, it));
  return box_muller(r.x, r.y);
}

// Output words 0 and 1 of the N counters (idx[j], 0, 0, 0) under key k:
// N independent chains in one basic block, which the compiler interleaves so
// that each hides the others' latency; the zero words are constants, so the
// first round's products of them fold away.
template <int N>
__device__ __forceinline__ void philox_zero_words(const unsigned (&idx)[N],
                                                  uint2 k, unsigned (&w0)[N],
                                                  unsigned (&w1)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const uint4 r = philox4x32_10(make_uint4(idx[j], 0u, 0u, 0u), k);
    w0[j] = r.x;
    w1[j] = r.y;
  }
}

}  // namespace bm
