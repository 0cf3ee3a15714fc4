// The backward of flash attention (B3): dQ, dK and dV.
//
// Replaces no TPU kernel: the reference has no Pallas backward.  Off a TPU
// its training differentiates the plain XLA attention (`ops.attention`
// resolves "auto" to "xla", src/repro/kernels/ops.py:30-31), so this
// computes what `jax.grad` of `repro.kernels.ref.attention_ref` computes:
// with S = sm_scale · q·kᵀ in float32 from the inputs' values, P the
// masked softmax of S, O = P·V and the incoming gradient dO,
//   dV = Pᵀ·dO,  dP = dO·Vᵀ,  dS = P ∘ (dP − D) with D = rowsum(dO ∘ O),
//   dQ = sm_scale · dS·K,  dK = sm_scale · dSᵀ·Q,
// every product and sum in float32, each gradient written once in the
// input dtype.  The masks are B3's: causal (row i sees keys <= i, Sq ==
// Skv), a sliding window (keys >= i − window), none (any Sq, Skv), with
// keys past Skv and rows past Sq out of every tile; GQA sums dK and dV
// over the group's query heads.
//
// Three kernels, launched in order on one stream; none uses atomics, so
// the result is deterministic:
// 1. `fa_bwd_stats`, one CTA a (batch, head, 64 query rows): the
//    log-sum-exp of each row's scaled scores (the forward keeps only O)
//    and D = rowsum(dO ∘ O);
// 2. `fa_bwd_dkdv`, one CTA a (batch, kv head, 64 keys): K and V stay in
//    shared memory while the CTA walks every query tile of the band, for
//    each query head of the group, recomputing P from the row statistics
//    and accumulating dK and dV in registers;
// 3. `fa_bwd_dq`, one CTA a (batch, head, 64 query rows): Q and dO stay,
//    the key tiles of the band stream through, dQ accumulates in
//    registers.
//
// What bounds it on an H100: operations.  The three kernels do eight
// products the size of the forward's two (S three times, dP twice, dV,
// dK, dQ once each), about 4x the forward's FLOP; the bound the port
// states is 2.5x the forward's at the tensor cores' rate.  This first
// design runs every product as scalar float32 FMAs on the CUDA cores:
// tiles are staged in shared memory as float32 (rows padded to an odd
// stride, so a warp's column reads hit distinct banks), each thread
// holds a 4 x 4 tile of S or dP and an 8 x D/32 tile of dK, dV or dQ.
// `wgmma` and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "float_convert.cuh"

namespace {

constexpr int kRows = 64;        // query rows and keys a tile
constexpr int kThreads = 256;
constexpr int kLdP = kRows + 1;  // row stride of the P and dS tiles

struct Args {
  int batch, n_heads, n_kv_heads, sq, skv;
  int64_t qb, qh, qs, kb, kh, ks, vb, vh, vs;  // input strides (elements)
  float scale;
  int causal, window;
};

__device__ __forceinline__ bool visible(const Args& a, int i, int j) {
  return i < a.sq && j < a.skv && (!a.causal || j <= i) &&
         (a.window < 0 || j >= i - a.window);
}

// The key tiles a query tile starting at q0 meets: [lo, hi).
__device__ __forceinline__ void key_tiles(const Args& a, int q0, int* lo,
                                          int* hi) {
  int h = (a.skv + kRows - 1) / kRows;
  if (a.causal) h = min(h, (q0 + kRows - 1) / kRows + 1);
  int l = 0;
  if (a.window >= 0 && q0 - a.window > 0) l = (q0 - a.window) / kRows;
  *lo = l;
  *hi = h;
}

// Rows [row0, row0 + 64) of a (rows, D) matrix at `src` with row stride
// `stride`, as float32 into `dst` (row stride D + 1); rows at or past
// `n_rows` are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t stride, int row0,
                                          int n_rows) {
  constexpr int LD = D + 1;
  for (int idx = threadIdx.x; idx < kRows * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    float val = 0.f;
    if (row0 + r < n_rows) val = to_f32(src[(int64_t)(row0 + r) * stride + c]);
    dst[r * LD + c] = val;
  }
}

// acc[i][j] = sum_d A[ty + 16 i][d] · B[tx + 16 j][d] (A·Bᵀ on two tiles).
template <int D>
__device__ __forceinline__ void mm_abt(float acc[4][4], const float* A,
                                       const float* B, int ty, int tx) {
  constexpr int LD = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = A[(ty + 16 * i) * LD + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = B[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
}

// acc[i][j] += sum_m M[m][w + 8 i] · X[m][lane + 32 j]: rows w + 8 i of
// Mᵀ·X, M a (64, 64) tile of stride kLdP, X a (64, D) tile.
template <int D>
__device__ __forceinline__ void mm_atb_acc(float acc[8][D / 32],
                                           const float* M, const float* X,
                                           int w, int lane) {
  constexpr int LD = D + 1;
#pragma unroll 2
  for (int m = 0; m < kRows; ++m) {
    float p[8], x[D / 32];
#pragma unroll
    for (int i = 0; i < 8; ++i) p[i] = M[m * kLdP + w + 8 * i];
#pragma unroll
    for (int j = 0; j < D / 32; ++j) x[j] = X[m * LD + lane + 32 * j];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < D / 32; ++j) acc[i][j] = fmaf(p[i], x[j], acc[i][j]);
  }
}

// acc[i][j] += sum_c M[w + 8 i][c] · X[c][lane + 32 j]: rows w + 8 i of
// M·X.
template <int D>
__device__ __forceinline__ void mm_ab_acc(float acc[8][D / 32],
                                          const float* M, const float* X,
                                          int w, int lane) {
  constexpr int LD = D + 1;
#pragma unroll 2
  for (int c = 0; c < kRows; ++c) {
    float p[8], x[D / 32];
#pragma unroll
    for (int i = 0; i < 8; ++i) p[i] = M[(w + 8 * i) * kLdP + c];
#pragma unroll
    for (int j = 0; j < D / 32; ++j) x[j] = X[c * LD + lane + 32 * j];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < D / 32; ++j) acc[i][j] = fmaf(p[i], x[j], acc[i][j]);
  }
}

// Row statistics: lse[row] = log-sum-exp of the row's visible scaled
// scores, delta[row] = rowsum(dO ∘ O).  Grid (q tiles, heads, batch).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fa_bwd_stats(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ o, const T* __restrict__ dout,
             float* __restrict__ lse, float* __restrict__ delta, Args a) {
  extern __shared__ float smem[];
  constexpr int LD = D + 1;
  float* Qs = smem;
  float* Ks = Qs + kRows * LD;
  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.n_heads / a.n_kv_heads);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int64_t row_base = ((int64_t)b * a.n_heads + h) * a.sq;

  // D = rowsum(dO ∘ O): a warp a row
  const int w = tid / 32, lane = tid % 32;
  for (int r = w; r < kRows; r += kThreads / 32) {
    const int row = q0 + r;
    if (row >= a.sq) break;
    const T* op = o + (row_base + row) * D;
    const T* gp = dout + (row_base + row) * D;
    float s = 0.f;
    for (int d = lane; d < D; d += 32) s = fmaf(to_f32(op[d]), to_f32(gp[d]), s);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) delta[row_base + row] = s;
  }

  load_tile<T, D>(Qs, q + b * a.qb + h * a.qh, a.qs, q0, a.sq);
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  int lo, hi;
  key_tiles(a, q0, &lo, &hi);
  const T* kp = k + b * a.kb + hk * a.kh;
  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * kRows;
    __syncthreads();
    load_tile<T, D>(Ks, kp, a.ks, k0, a.skv);
    __syncthreads();
    float s[4][4];
    mm_abt<D>(s, Qs, Ks, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!visible(a, q0 + ty + 16 * i, k0 + tx + 16 * j)) continue;
        const float x = s[i][j] * a.scale;
        if (x > m[i]) {
          l[i] = l[i] * expf(m[i] - x) + 1.f;
          m[i] = x;
        } else {
          l[i] += expf(x - m[i]);
        }
      }
  }
  // merge the 16 column threads of each row (lanes of one half-warp)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[i], off);
      const float lo_ = __shfl_xor_sync(0xffffffffu, l[i], off);
      const float mn = fmaxf(m[i], mo);
      float sum = 0.f;
      if (m[i] != -INFINITY) sum += l[i] * expf(m[i] - mn);
      if (mo != -INFINITY) sum += lo_ * expf(mo - mn);
      m[i] = mn;
      l[i] = sum;
    }
    const int row = q0 + ty + 16 * i;
    if (tx == 0 && row < a.sq) lse[row_base + row] = m[i] + logf(l[i]);
  }
}

// P (and dS) of one (query tile, key tile) pair from the row statistics:
// p = exp(S·scale − lse) on visible entries, 0 elsewhere.
__device__ __forceinline__ void probs(float p[4][4], const float s[4][4],
                                      const Args& a, const float* lse_s,
                                      int q0, int k0, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = ty + 16 * i;
      p[i][j] = visible(a, q0 + r, k0 + tx + 16 * j)
                    ? expf(s[i][j] * a.scale - lse_s[r])
                    : 0.f;
    }
}

// dK and dV of 64 keys of one (batch, kv head), summed over the group's
// query heads and every query tile of the band.  Grid (key tiles, kv
// heads, batch).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
fa_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            T* __restrict__ dk, T* __restrict__ dv, Args a) {
  extern __shared__ float smem[];
  constexpr int LD = D + 1, DJ = D / 32;
  float* Ks = smem;
  float* Vs = Ks + kRows * LD;
  float* Qs = Vs + kRows * LD;
  float* Gs = Qs + kRows * LD;  // dO
  float* Ps = Gs + kRows * LD;
  float* Ss = Ps + kRows * kLdP;  // dS
  float* lse_s = Ss + kRows * kLdP;
  float* dl_s = lse_s + kRows;
  const int k0 = blockIdx.x * kRows, hk = blockIdx.y, b = blockIdx.z;
  const int group = a.n_heads / a.n_kv_heads;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int w = tid / 32, lane = tid % 32;

  load_tile<T, D>(Ks, k + b * a.kb + hk * a.kh, a.ks, k0, a.skv);
  load_tile<T, D>(Vs, v + b * a.vb + hk * a.vh, a.vs, k0, a.skv);
  float gk[8][DJ], gv[8][DJ];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) gk[i][j] = gv[i][j] = 0.f;

  const int nq = (a.sq + kRows - 1) / kRows;
  const int qt_lo = a.causal ? k0 / kRows : 0;
  int qt_hi = nq;
  if (a.window >= 0)
    qt_hi = min(nq, (min(k0 + kRows, a.skv) - 1 + a.window) / kRows + 1);
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const int64_t row_base = ((int64_t)b * a.n_heads + h) * a.sq;
    for (int qt = qt_lo; qt < qt_hi; ++qt) {
      const int q0 = qt * kRows;
      __syncthreads();
      load_tile<T, D>(Qs, q + b * a.qb + h * a.qh, a.qs, q0, a.sq);
      load_tile<T, D>(Gs, dout + row_base * D, D, q0, a.sq);
      if (tid < kRows) {
        const bool in = q0 + tid < a.sq;
        lse_s[tid] = in ? lse[row_base + q0 + tid] : 0.f;
        dl_s[tid] = in ? delta[row_base + q0 + tid] : 0.f;
      }
      __syncthreads();
      float s[4][4], p[4][4], dp[4][4];
      mm_abt<D>(s, Qs, Ks, ty, tx);
      probs(p, s, a, lse_s, q0, k0, ty, tx);
      mm_abt<D>(dp, Gs, Vs, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = ty + 16 * i, c = tx + 16 * j;
          Ps[r * kLdP + c] = p[i][j];
          Ss[r * kLdP + c] = p[i][j] * (dp[i][j] - dl_s[r]);
        }
      __syncthreads();
      mm_atb_acc<D>(gv, Ps, Gs, w, lane);
      mm_atb_acc<D>(gk, Ss, Qs, w, lane);
    }
  }
  const int64_t base = ((int64_t)b * a.n_kv_heads + hk) * a.skv;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int key = k0 + w + 8 * i;
    if (key >= a.skv) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int64_t at = (base + key) * D + lane + 32 * j;
      dk[at] = from_f32<T>(gk[i][j] * a.scale);
      dv[at] = from_f32<T>(gv[i][j]);
    }
  }
}

// dQ of 64 query rows of one (batch, head), over the key tiles of the
// band.  Grid (query tiles, heads, batch).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
fa_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, Args a) {
  extern __shared__ float smem[];
  constexpr int LD = D + 1, DJ = D / 32;
  float* Qs = smem;
  float* Gs = Qs + kRows * LD;  // dO
  float* Ks = Gs + kRows * LD;
  float* Vs = Ks + kRows * LD;
  float* Ss = Vs + kRows * LD;  // dS
  float* lse_s = Ss + kRows * kLdP;
  float* dl_s = lse_s + kRows;
  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.n_heads / a.n_kv_heads);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int w = tid / 32, lane = tid % 32;
  const int64_t row_base = ((int64_t)b * a.n_heads + h) * a.sq;

  load_tile<T, D>(Qs, q + b * a.qb + h * a.qh, a.qs, q0, a.sq);
  load_tile<T, D>(Gs, dout + row_base * D, D, q0, a.sq);
  if (tid < kRows) {
    const bool in = q0 + tid < a.sq;
    lse_s[tid] = in ? lse[row_base + q0 + tid] : 0.f;
    dl_s[tid] = in ? delta[row_base + q0 + tid] : 0.f;
  }
  float gq[8][DJ];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) gq[i][j] = 0.f;
  int lo, hi;
  key_tiles(a, q0, &lo, &hi);
  const T* kp = k + b * a.kb + hk * a.kh;
  const T* vp = v + b * a.vb + hk * a.vh;
  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * kRows;
    __syncthreads();
    load_tile<T, D>(Ks, kp, a.ks, k0, a.skv);
    load_tile<T, D>(Vs, vp, a.vs, k0, a.skv);
    __syncthreads();
    float s[4][4], p[4][4], dp[4][4];
    mm_abt<D>(s, Qs, Ks, ty, tx);
    probs(p, s, a, lse_s, q0, k0, ty, tx);
    mm_abt<D>(dp, Gs, Vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i;
        Ss[r * kLdP + tx + 16 * j] = p[i][j] * (dp[i][j] - dl_s[r]);
      }
    __syncthreads();
    mm_ab_acc<D>(gq, Ss, Ks, w, lane);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = q0 + w + 8 * i;
    if (row >= a.sq) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      dq[(row_base + row) * D + lane + 32 * j] =
          from_f32<T>(gq[i][j] * a.scale);
  }
}

template <int D>
constexpr int stats_smem() {
  return 2 * kRows * (D + 1) * (int)sizeof(float);
}
template <int D>
constexpr int dkdv_smem() {
  return (4 * kRows * (D + 1) + 2 * kRows * kLdP + 2 * kRows) *
         (int)sizeof(float);
}
template <int D>
constexpr int dq_smem() {
  return (4 * kRows * (D + 1) + kRows * kLdP + 2 * kRows) *
         (int)sizeof(float);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, void* dq, void* dk, void* dv, float* lse,
           float* delta, const Args& a, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      fa_bwd_stats<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      stats_smem<D>());
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fa_bwd_dkdv<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dkdv_smem<D>());
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fa_bwd_dq<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dq_smem<D>());
  if (e != cudaSuccess) return (int)e;
  const dim3 block(kThreads);
  const int nq = (a.sq + kRows - 1) / kRows, nk = (a.skv + kRows - 1) / kRows;
  const T* tq = (const T*)q;
  const T* tk = (const T*)k;
  const T* tv = (const T*)v;
  const T* tg = (const T*)dout;
  fa_bwd_stats<T, D><<<dim3(nq, a.n_heads, a.batch), block, stats_smem<D>(),
                       s>>>(tq, tk, (const T*)o, tg, lse, delta, a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  fa_bwd_dkdv<T, D><<<dim3(nk, a.n_kv_heads, a.batch), block, dkdv_smem<D>(),
                      s>>>(tq, tk, tv, tg, lse, delta, (T*)dk, (T*)dv, a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  fa_bwd_dq<T, D><<<dim3(nq, a.n_heads, a.batch), block, dq_smem<D>(), s>>>(
      tq, tk, tv, tg, lse, delta, (T*)dq, a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dim(int d, const void* q, const void* k, const void* v,
               const void* o, const void* dout, void* dq, void* dk, void* dv,
               float* lse, float* delta, const Args& a, cudaStream_t s) {
  if (d == 64)
    return launch<T, 64>(q, k, v, o, dout, dq, dk, dv, lse, delta, a, s);
  if (d == 128)
    return launch<T, 128>(q, k, v, o, dout, dq, dk, dv, lse, delta, a, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q (B, H, Sq, D) and k, v (B, Hkv, Skv, D) read through `strides` (q's,
// k's and v's batch, head and sequence strides in elements; unit stride
// on D); o and dout (B, H, Sq, D) contiguous, o the forward's output;
// dq, dk, dv contiguous outputs in the input dtype; lse and delta (B, H,
// Sq) float32 scratch.  dtype 0 float32, 1 bf16; head dim 64 or 128.
// Returns 0 or a cudaError_t.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, void* lse, void* delta,
    int dtype, int batch, int n_heads, int n_kv_heads, int sq, int skv, int d,
    const int64_t* strides, float sm_scale, int causal, int window,
    void* stream) {
  if (batch == 0 || n_heads == 0 || sq == 0 || skv == 0) return 0;
  Args a;
  a.batch = batch;
  a.n_heads = n_heads;
  a.n_kv_heads = n_kv_heads;
  a.sq = sq;
  a.skv = skv;
  a.qb = strides[0];
  a.qh = strides[1];
  a.qs = strides[2];
  a.kb = strides[3];
  a.kh = strides[4];
  a.ks = strides[5];
  a.vb = strides[6];
  a.vh = strides[7];
  a.vs = strides[8];
  a.scale = sm_scale;
  a.causal = causal;
  a.window = window;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_dim<float>(d, q, k, v, o, dout, dq, dk, dv, (float*)lse,
                             (float*)delta, a, s);
  if (dtype == 1)
    return launch_dim<__nv_bfloat16>(d, q, k, v, o, dout, dq, dk, dv,
                                     (float*)lse, (float*)delta, a, s);
  return (int)cudaErrorInvalidValue;
}
