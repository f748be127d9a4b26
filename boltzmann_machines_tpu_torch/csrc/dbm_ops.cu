// All-Bernoulli DBM kernels, hand-written for Hopper (sm_90a): the PCD /
// mean-field training epoch, the particle sampler and the AIS sweep.
//
// Replaces the TPU's three kernels of boltzmann_machines_tpu/ops/pallas_dbm.py:
//   make_dbm_epoch_kernel / _dbm_epoch_kernel   (pallas_call at :373)
//   make_dbm_sample_kernel / _dbm_sample_kernel (pallas_call at :481)
//   make_ais_kernel / _ais_kernel               (pallas_call at :516)
// Each of those is one pallas_call with every weight, accumulator and chain
// resident in VMEM for the whole run.  Hopper has no such memory: here W, dW,
// the particles and the mean-field buffers live in device memory (and the
// 50 MB L2), and each minibatch (sweep, beta) is an ordered sequence of
// launches on one stream, with no host synchronisation inside a call of the
// wrapper (ops/dbm_ops.py).
//
// Kernels:
//   dbm_gemm_act     out = act(alpha (A1.B1 + A2.B2 + C) + gamma bias), the
//                    one GEMM of every layer update: two products summed in
//                    one accumulator (a middle layer reads "up from below
//                    plus down from above"), an optional addend C (the
//                    hoisted X.W0 of mean-field), the bias scaled by gamma
//                    apart from the product (mean-field init doubles the
//                    product only: sigmoid(2 X.W0 + hb0); AIS scales both by
//                    beta), except in the softplus epilogue, which adds it
//                    inside the scale (AIS log p~: softplus(beta (x.W + b))).
//                    Epilogues: identity, sigmoid with optional Philox
//                    states, sigmoid with the mean-field change
//                    max |new - old| folded into a device scalar, and per-row
//                    softplus sums at two betas written as per-block partials.
//   dbm_mf_check     one thread: counts a mean-field sweep and raises the
//                    `done` flag when the change is <= tol or the budget is
//                    spent.  The mean-field loop stays on the device: the
//                    host enqueues max_mf_updates sweeps unconditionally, and
//                    every sweep launch returns at once when `done` is set.
//   dbm_bias_update  bias statistics (data / N - particles / M), the
//                    per-layer sparsity EMAs of batch sums with their penalty,
//                    and the momentum update of a bias vector.
//   dbm_assoc_update data^T.data / N - particles^T.particles / M - l2 W -
//                    penalty, and the momentum update of dW and W in place.
//   dbm_max_norm     per-column max-norm of W after the update (a reduction
//                    over rows, so its own pass).
//   dbm_msre         the minibatch's msre (fixed-order block reduction) and
//                    its mean-field update count.
//   ais_logw         per-run log-weight update from the softplus partials,
//                    reduced in a fixed order, so log-weights are
//                    deterministic.
//
// Mean-field without a ping-pong buffer: the update of layer l reads layers
// l-1 and l+1 but never l, so each element's owner reads its old value,
// writes the new one and folds |new - old| into the change, race-free, and
// layer 0 still reads the old mu1 (layer 1's launch comes after it).
//
// What bounds it on an H100: at dbm_mnist's shapes (784-512-1024, 100 rows)
// each GEMM is 40-100 MFLOP, far below the card's f32 rate, and with a 64-row
// tile a 100-row product is two rows of 8-16 blocks on 132 SMs, each walking
// a K loop of 512-1536 alone: latency-bound, like cd_gemm_act at small batch
// (PERF.md).  The design does nothing about that yet (plain f32 FMA, no tensor
// cores, no split-K); persistent kernels, CUDA graphs and wgmma are later work.
//
// C interface (bound with ctypes by ops/dbm_ops.py): every entry launches on
// the given stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() (the first error of a multi-launch entry).

#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm.cuh"
#include "philox.cuh"

namespace {

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

enum Act { kIdentity = 0, kSigmoid = 1, kSigmoidDelta = 2, kSoftplusRows = 3 };

// max that keeps a NaN, as jnp.max does (a NaN change ends mean-field)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (b != b || b > a) ? b : a;
}

}  // namespace

// Arguments of one dbm_gemm_act launch; ops/dbm_ops.py mirrors the layout
// (ctypes.Structure, natural alignment).  A(m, k) = a[m*sam + k*sak],
// B(k, n) = b[k*sbk + n*sbn]; a2 == nullptr (or k2 == 0) drops the second
// product, c (row-major M x N) and bias (N) may be null.
struct GemmArgs {
  const float* a1;
  const float* b1;
  const float* a2;
  const float* b2;
  const float* c;
  const float* bias;
  float* out;             // means or states; kSoftplusRows: partials
  unsigned* delta_bits;   // kSigmoidDelta: max |new - old| as float bits
  const int* done;        // launch is a no-op while *done != 0; may be null
  long long sam1, sak1, sbk1, sbn1;
  long long sam2, sak2, sbk2, sbn2;
  int k1, k2, M, N;
  int act, sample;
  float alpha, alpha2, gamma;
  unsigned seed, it, stream_id;
};

namespace {

constexpr int kRedThreads = 256;

// out(m, n) = act(pre), pre = alpha (acc + C) + gamma bias, acc = A1.B1 +
// A2.B2; kSoftplusRows sums softplus(alpha (acc + C + bias)) and the same at
// alpha2 over the row instead.
__global__ void __launch_bounds__(kGemmThreads)
    dbm_gemm_act_kernel(const GemmArgs a) {
  if (a.done != nullptr && *a.done != 0) return;  // mean-field converged
  __shared__ GemmTile sm;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[TM][TN] = {};
  if (a.k1 > 0)
    gemm_accumulate(a.a1, a.sam1, a.sak1, a.b1, a.sbk1, a.sbn1, a.M, a.N,
                    a.k1, m0, n0, sm, acc);
  if (a.a2 != nullptr && a.k2 > 0)
    gemm_accumulate(a.a2, a.sam2, a.sak2, a.b2, a.sbk2, a.sbn2, a.M, a.N,
                    a.k2, m0, n0, sm, acc);
  const int tx = threadIdx.x % (BN / TN), ty = threadIdx.x / (BN / TN);
  float dmax = 0.f;
  float rows1[TM], rows2[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    rows1[i] = rows2[i] = 0.f;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (m >= a.M || n >= a.N) continue;
      const long long idx = (long long)m * a.N + n;
      float t = acc[i][j];
      if (a.c != nullptr) t += a.c[idx];
      const float b = a.bias != nullptr ? a.bias[n] : 0.f;
      if (a.act == kSoftplusRows) {
        // bias inside the scale: softplus(beta (x.W + b)) at two betas
        const float u = t + b;
        rows1[i] += softplus(a.alpha * u);
        rows2[i] += softplus(a.alpha2 * u);
        continue;
      }
      const float pre = a.alpha * t + a.gamma * b;
      if (a.act == kIdentity) {
        a.out[idx] = pre;
        continue;
      }
      float p = sigmoid(pre);
      if (a.act == kSigmoidDelta) dmax = nan_max(dmax, fabsf(p - a.out[idx]));
      if (a.sample) {
        const float r = bm::philox_uniform(a.seed, a.it, a.stream_id,
                                           (unsigned)idx);
        p = r < p ? 1.f : 0.f;
      }
      a.out[idx] = p;
    }
  }
  if (a.act == kSigmoidDelta) {
    // max over the warp, then one atomic per warp; atomicMax on the bits of
    // non-negative floats is exact and independent of the order (a NaN's
    // bits, 0x7fc00000, exceed those of +inf, so a NaN wins too)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      dmax = nan_max(dmax, __shfl_xor_sync(0xffffffffu, dmax, o));
    if ((threadIdx.x & 31) == 0) atomicMax(a.delta_bits, __float_as_uint(dmax));
  } else if (a.act == kSoftplusRows) {
    // the 16 threads of a row group are adjacent lanes of one warp: sum
    // their row partials in a fixed order, then one write per (row, block)
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) {
        rows1[i] += __shfl_xor_sync(0xffffffffu, rows1[i], o);
        rows2[i] += __shfl_xor_sync(0xffffffffu, rows2[i], o);
      }
    }
    if (tx == 0) {
      const int nblk = gridDim.x;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int m = m0 + ty * TM + i;
        if (m >= a.M) continue;
        a.out[(long long)m * nblk + blockIdx.x] = rows1[i];
        a.out[((long long)a.M + m) * nblk + blockIdx.x] = rows2[i];
      }
    }
  }
}

// ctrl = {delta bits, done, n_mf}; zeroed before the first sweep.
__global__ void dbm_mf_check_kernel(unsigned* ctrl, float tol,
                                    int max_updates) {
  int* done = reinterpret_cast<int*>(ctrl + 1);
  int* n_mf = reinterpret_cast<int*>(ctrl + 2);
  if (*done) return;
  const int n = *n_mf + 1;
  *n_mf = n;
  const float delta = __uint_as_float(ctrl[0]);
  // the JAX loop runs while n < max and delta > tol (a NaN change stops it)
  if (!(delta > tol) || n >= max_updates) *done = 1;
  ctrl[0] = 0u;
}

// One thread per column j < n: D is (N, n) data-side means, P (M, n)
// particles.  grad = sum D / N - sum P / M; with sparsity (q != null) the
// EMAs of the batch sums and the penalty cost (q - t) + cost (mu - t), which
// is subtracted from grad and written to pen for the association update.
__global__ void dbm_bias_update_kernel(
    const float* __restrict__ D, const float* __restrict__ P, int N, int M,
    int n, float* b, float* db, float* q, float* mu_m,
    float* __restrict__ pen, float lr, float mom, float damp,
    float one_minus_damp, float cost, float target) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  float sd = 0.f, sp = 0.f;
  for (int r = 0; r < N; ++r) sd += D[(long long)r * n + j];
  for (int r = 0; r < M; ++r) sp += P[(long long)r * n + j];
  float g = sd / (float)N - sp / (float)M;
  if (q != nullptr) {
    const float qn = damp * q[j] + one_minus_damp * sp;
    const float mn = damp * mu_m[j] + one_minus_damp * sd;
    const float p = cost * (qn - target) + cost * (mn - target);
    q[j] = qn;
    mu_m[j] = mn;
    pen[j] = p;
    g = g - p;
  }
  const float acc = lr * (mom * db[j] + g);
  db[j] = acc;
  b[j] += acc;
}

// W (n_in, n_out), rows i, columns j.  pos = Ad^T.Bd over N data rows, neg =
// Ap^T.Bp over M particle rows; each (i, j) has one owner, which reads the
// old W for the L2 term before it writes the new one.
__global__ void __launch_bounds__(kGemmThreads)
    dbm_assoc_update_kernel(const float* __restrict__ Ad,
                            const float* __restrict__ Bd,
                            const float* __restrict__ Ap,
                            const float* __restrict__ Bp,
                            const float* __restrict__ pen, int N, int M,
                            int n_in, int n_out, float* __restrict__ W,
                            float* __restrict__ dW, float lr, float mom,
                            float l2) {
  __shared__ GemmTile sm;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float pos[TM][TN] = {}, neg[TM][TN] = {};
  // A(i, r) = Ad[r*n_in + i], B(r, j) = Bd[r*n_out + j]
  gemm_accumulate(Ad, 1, n_in, Bd, n_out, 1, n_in, n_out, N, m0, n0, sm, pos);
  gemm_accumulate(Ap, 1, n_in, Bp, n_out, 1, n_in, n_out, M, m0, n0, sm, neg);
  const int tx = threadIdx.x % (BN / TN), ty = threadIdx.x / (BN / TN);
  const float fn = (float)N, fm = (float)M;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = m0 + ty * TM + i;
    if (r >= n_in) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = n0 + tx * TN + j;
      if (c >= n_out) continue;
      const long long idx = (long long)r * n_out + c;
      const float w = W[idx];
      float g = pos[i][j] / fn - neg[i][j] / fm - l2 * w;
      if (pen != nullptr) g = g - pen[c];
      const float acc = lr * (mom * dW[idx] + g);
      dW[idx] = acc;
      W[idx] = w + acc;
    }
  }
}

// One thread per column: W[:, j] *= min(|w|, c) / max(|w|, 1e-8).
__global__ void dbm_max_norm_kernel(float* W, int n_in, int n_out,
                                    float max_norm) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n_out) return;
  float s = 0.f;
  for (int i = 0; i < n_in; ++i) {
    const float w = W[(long long)i * n_out + j];
    s = fmaf(w, w, s);
  }
  const float norm = sqrtf(s);
  const float num = fminf(norm, max_norm), den = fmaxf(norm, 1e-8f);
  for (int i = 0; i < n_in; ++i) {
    const long long idx = (long long)i * n_out + j;
    W[idx] = W[idx] * num / den;
  }
}

// One block: msre = mean((X - v_means)^2) over B x V, and the mean-field
// update count of the minibatch.
__global__ void __launch_bounds__(kRedThreads)
    dbm_msre_kernel(const float* __restrict__ X,
                    const float* __restrict__ vm, long long n,
                    const unsigned* ctrl, float* msre_out, float* nmf_out) {
  __shared__ float red[kRedThreads / 32];
  float s = 0.f;
  for (long long e = threadIdx.x; e < n; e += blockDim.x) {
    const float d = X[e] - vm[e];
    s = fmaf(d, d, s);
  }
  const float t = block_sum(s, red);
  if (threadIdx.x == 0) {
    *msre_out = t / (float)n;
    *nmf_out = (float)reinterpret_cast<const int*>(ctrl)[2];
  }
}

// One block per run r:
//   lp(beta) = beta (x_r . hb0) + sum_v softplus(beta (x.W0^T + vb))_r
//              + sum_h2 softplus(beta (x.W1 + hb1))_r
// from the per-block partials of the two dbm_gemm_act launches (sets 0 and 1
// at beta_lo and beta_hi), then log_w -= lp(beta_lo); log_w += lp(beta_hi),
// the JAX kernel's order of operations.
__global__ void __launch_bounds__(kRedThreads)
    ais_logw_kernel(const float* __restrict__ x,
                    const float* __restrict__ hb0, int R, int H1,
                    const float* __restrict__ part_v, int nblk_v,
                    const float* __restrict__ part_h2, int nblk_h2,
                    float beta_lo, float beta_hi, float* log_w) {
  __shared__ float red[kRedThreads / 32];
  const int r = blockIdx.x;
  float s = 0.f;
  for (int j = threadIdx.x; j < H1; j += blockDim.x)
    s = fmaf(x[(long long)r * H1 + j], hb0[j], s);
  const float xh = block_sum(s, red);
  if (threadIdx.x != 0) return;
  float sv_lo = 0.f, sv_hi = 0.f, sh_lo = 0.f, sh_hi = 0.f;
  for (int b = 0; b < nblk_v; ++b) {
    sv_lo += part_v[(long long)r * nblk_v + b];
    sv_hi += part_v[((long long)R + r) * nblk_v + b];
  }
  for (int b = 0; b < nblk_h2; ++b) {
    sh_lo += part_h2[(long long)r * nblk_h2 + b];
    sh_hi += part_h2[((long long)R + r) * nblk_h2 + b];
  }
  const float lp_lo = beta_lo * xh + sv_lo + sh_lo;
  const float lp_hi = beta_hi * xh + sv_hi + sh_hi;
  log_w[r] = log_w[r] - lp_lo;
  log_w[r] = log_w[r] + lp_hi;
}

inline dim3 gemm_grid(const GemmArgs& a) {
  return dim3((a.N + BN - 1) / BN, (a.M + BM - 1) / BM);
}

}  // namespace

extern "C" {

// Number of column blocks of a launch: the partials of kSoftplusRows hold
// 2 * M * gemm_col_blocks(N) floats.
int bm_dbm_gemm_col_blocks(int N) { return (N + BN - 1) / BN; }

int bm_dbm_gemm_act(const GemmArgs* a, void* stream) {
  dbm_gemm_act_kernel<<<gemm_grid(*a), kGemmThreads, 0,
                        (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

// Zero the mean-field control words {delta bits, done, n_mf}.
int bm_dbm_mf_reset(unsigned* ctrl, void* stream) {
  cudaMemsetAsync(ctrl, 0, 3 * sizeof(unsigned), (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// `n_sweeps` mean-field sweeps: per sweep the `n_layers` layer launches of
// `layers` (each with delta_bits = ctrl and done = ctrl + 1), then one
// dbm_mf_check.
int bm_dbm_mf_loop(const GemmArgs* layers, int n_layers, int n_sweeps,
                   unsigned* ctrl, float tol, int max_updates, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  for (int it = 0; it < n_sweeps; ++it) {
    for (int l = 0; l < n_layers; ++l) {
      dbm_gemm_act_kernel<<<gemm_grid(layers[l]), kGemmThreads, 0, s>>>(
          layers[l]);
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
    dbm_mf_check_kernel<<<1, 1, 0, s>>>(ctrl, tol, max_updates);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

int bm_dbm_bias_update(const float* D, const float* P, int N, int M, int n,
                       float* b, float* db, float* q, float* mu_m, float* pen,
                       float lr, float mom, float damp, float one_minus_damp,
                       float cost, float target, void* stream) {
  const int threads = 256;
  dbm_bias_update_kernel<<<(n + threads - 1) / threads, threads, 0,
                           (cudaStream_t)stream>>>(
      D, P, N, M, n, b, db, q, mu_m, pen, lr, mom, damp, one_minus_damp, cost,
      target);
  return (int)cudaGetLastError();
}

int bm_dbm_assoc_update(const float* Ad, const float* Bd, const float* Ap,
                        const float* Bp, const float* pen, int N, int M,
                        int n_in, int n_out, float* W, float* dW, float lr,
                        float mom, float l2, void* stream) {
  const dim3 grid((n_out + BN - 1) / BN, (n_in + BM - 1) / BM);
  dbm_assoc_update_kernel<<<grid, kGemmThreads, 0, (cudaStream_t)stream>>>(
      Ad, Bd, Ap, Bp, pen, N, M, n_in, n_out, W, dW, lr, mom, l2);
  return (int)cudaGetLastError();
}

int bm_dbm_max_norm(float* W, int n_in, int n_out, float max_norm,
                    void* stream) {
  const int threads = 128;
  dbm_max_norm_kernel<<<(n_out + threads - 1) / threads, threads, 0,
                        (cudaStream_t)stream>>>(W, n_in, n_out, max_norm);
  return (int)cudaGetLastError();
}

int bm_dbm_msre(const float* X, const float* vm, long long n,
                const unsigned* ctrl, float* msre_out, float* nmf_out,
                void* stream) {
  dbm_msre_kernel<<<1, kRedThreads, 0, (cudaStream_t)stream>>>(
      X, vm, n, ctrl, msre_out, nmf_out);
  return (int)cudaGetLastError();
}

int bm_ais_logw(const float* x, const float* hb0, int R, int H1,
                const float* part_v, int nblk_v, const float* part_h2,
                int nblk_h2, float beta_lo, float beta_hi, float* log_w,
                void* stream) {
  ais_logw_kernel<<<R, kRedThreads, 0, (cudaStream_t)stream>>>(
      x, hb0, R, H1, part_v, nblk_v, part_h2, nblk_h2, beta_lo, beta_hi,
      log_w);
  return (int)cudaGetLastError();
}

}  // extern "C"
