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
// every sum in float32, each gradient written once in the input dtype.
// The masks are B3's: causal (row i sees keys <= i, Sq == Skv), a sliding
// window (keys >= i − window), none (any Sq, Skv); GQA sums dK and dV over
// the group's query heads.  No kernel here uses atomics: every gradient
// element is summed by one CTA in a fixed order, so two calls give the
// same bits.
//
// What bounds it on an H100: operations.  Given P, the backward needs five
// products the size of the forward's two (S, dP, dV, dK, dQ): 2.5x the
// forward's FLOP, 3.44e11 at qwen2.5-3b's training shape (B 2, H 16 over 2
// kv heads, S 4,096, D 128, causal), 0.348 ms at the bf16 tensor cores'
// 989 TFLOP/s; only `wgmma` reaches that rate.
//
// bf16 at head dims 64, 96, 128 and 256 (every backward the port trains)
// runs on the tensor cores, in three kernels:
// * `fa_bwd_prep`: D = rowsum(dO ∘ O) a row, and the forward's row
//   log-sum-exp (written by the Hopper forward's epilogue under grad, so
//   no score product is spent on it) times log2(e), both into buffers
//   padded to 128 rows a head (+inf and 0 past Sq, so padded rows give P
//   = 0).
// * `fa_bwd_dkdv_wgmma`: a CTA owns 64 keys of one (batch, kv head), whose
//   K and V tiles TMA loads once.  A producer warp streams the (Q, dO)
//   tiles of 64 query rows of the band, for every query head of the group,
//   with those rows' LSE and D, and deals them in turn to two consumer
//   warpgroups, each with a two-stage ring of its own.  Each warpgroup
//   computes the products transposed: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (`wgmma`,
//   both operands in shared memory), Pᵀ = exp2(Sᵀ·scale·log2 e − LSE·log2
//   e) and dSᵀ = Pᵀ ∘ (dPᵀ − D) in registers, then dV += Pᵀ·dO and dK +=
//   dSᵀ·Q with Pᵀ and dSᵀ as `wgmma`'s register A operand: the
//   accumulator layout of Sᵀ is the A layout of the next product, so
//   nothing goes through shared memory.  dK and dV stay in registers (64
//   + 64 floats a thread at D 128, 48 + 48 at D 96; `setmaxnreg` gives the
//   consumers the producer's registers); at the end the two warpgroups'
//   sums are added in a fixed order through shared memory and written
//   once.  Dealing one key block's tiles to two warpgroups, rather than
//   giving each its own keys, halves the longest CTA: under a causal mask
//   the first key block meets every query tile, the last one only the
//   diagonal.
// * `fa_bwd_dq_wgmma`: a CTA owns 128 query rows of one (batch, head), two
//   consumer warpgroups of 64; Q and dO stay in shared memory, the
//   producer streams (K, V) tiles of 64 keys over the band through a ring
//   of three stages (four at D 64 and 96).  S = Q·Kᵀ and dP = dO·Vᵀ
//   (`wgmma`, shared memory), P and dS in registers, then dQ += dS·K with
//   K read MN-major through the transpose-B flag, as the forward reads V.
// At head dim 256 the registers and shared memory of that design do not
// fit (dK and dV of 64 keys would take 256 accumulators a thread, a (Q,
// dO) stage 64 KB), so the two passes split their work otherwise (SPLIT
// in DkdvTile and DqTile): a dK/dV CTA's two warpgroups share one two-stage
// ring and both compute every item, each for its 128 columns of dK and dV
// (Sᵀ and dPᵀ contract over all 256, so each warpgroup computes them: 1.5x
// the pass's products); a dQ CTA owns 64 rows and deals its (K, V) tiles
// to the two warpgroups in turn, each summing a whole dQ (128 accumulators
// a thread) over its own, the two sums added in a fixed order at the end.
// Bound at recurrentgemma-9b's training shape (q (2, 16, 4,096, 256) over
// one kv head, causal, window 2,048): 5.157e11 FLOP, 0.521 ms.
// Both loops at head dims 64 and 128 are software-pipelined: the next
// tile's S and dP (dQ pass) or Sᵀ (dK/dV pass, where dPᵀ's accumulators
// would not fit beside the others) are issued right behind this tile's
// last product, so the tensor cores run them back to back, and a tile is
// released once its products are done (at 256 the dQ pass's warpgroups
// take turns on the tensor cores instead).  That is seven products where five would do (S and dP are
// computed in both passes): the price of summing dQ without atomics.
// Tiles are 128-byte-swizzled slabs of 64 columns, the layout TMA writes
// and `wgmma` reads; at head dim 96 (phi3-mini's), 64-byte-swizzled slabs
// of 32 columns, three a row, as the forward's (`Slabs` in tma.cuh): Sᵀ,
// dPᵀ, S and dP contract over 96 in 6 k16 steps, and dV, dK and dQ are
// n96 products over three whole MN-major atoms (bound at phi3-mini's
// training shape, q, k, v (2, 32, 4,096, 96), causal: 5.16e11 FLOP,
// 0.521 ms).  TMA zero-fills rows past Sq and keys past Skv, which
// then add nothing that is stored, so only tiles that the causal or window
// band's edge crosses are masked.  Under a causal mask the CTAs with the
// longest band start first (the first key blocks of the dK/dV pass, the
// last query blocks of the dQ pass), and the block scheduler hands the
// rest to SMs as they free up.  The schedules are mirrored in Python by
// `bwd_tile_schedule` in kernels/flash_attention.py, which the CPU tests
// check.
//
// float32 (which the tensor cores would round to TF32) keeps three scalar
// kernels, at the same head dims: `fa_bwd_stats` (the row log-sum-exp,
// recomputed from q·kᵀ, and D), `fa_bwd_dkdv` (a CTA a (batch, kv head, 64
// keys)) and `fa_bwd_dq` (a CTA a (batch, head, 64 rows)), every product a
// float32 FMA on tiles staged in shared memory; at head dim 256 their
// tiles are 32 rows, so four of them fit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "float_convert.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kThreads = 256;

// Rows (query rows and keys) a tile of the scalar kernels at head dim D:
// 64, or 32 at D 256, where four 64-row float32 tiles would not fit in
// shared memory.
template <int D>
constexpr int kScalarRows = D == 256 ? 32 : 64;

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

// The key tiles of R keys a query tile of R rows starting at q0 meets:
// [lo, hi).
template <int R>
__device__ __forceinline__ void key_tiles(const Args& a, int q0, int* lo,
                                          int* hi) {
  int h = (a.skv + R - 1) / R;
  if (a.causal) h = min(h, (q0 + R - 1) / R + 1);
  int l = 0;
  if (a.window >= 0 && q0 - a.window > 0) l = (q0 - a.window) / R;
  *lo = l;
  *hi = h;
}

// Rows [row0, row0 + R) of a (rows, D) matrix at `src` with row stride
// `stride`, as float32 into `dst` (row stride D + 1); rows at or past
// `n_rows` are zero.
template <typename T, int D, int R>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t stride, int row0,
                                          int n_rows) {
  constexpr int LD = D + 1;
  for (int idx = threadIdx.x; idx < R * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    float val = 0.f;
    if (row0 + r < n_rows) val = to_f32(src[(int64_t)(row0 + r) * stride + c]);
    dst[r * LD + c] = val;
  }
}

// acc[i][j] = sum_d A[ty + 16 i][d] · B[tx + 16 j][d] (A·Bᵀ on two R-row
// tiles).
template <int D, int R>
__device__ __forceinline__ void mm_abt(float acc[R / 16][R / 16],
                                       const float* A, const float* B, int ty,
                                       int tx) {
  constexpr int LD = D + 1, N = R / 16;
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float x[N], y[N];
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = A[(ty + 16 * i) * LD + d];
#pragma unroll
    for (int j = 0; j < N; ++j) y[j] = B[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
}

// acc[i][j] += sum_m M[m][w + 8 i] · X[m][lane + 32 j]: rows w + 8 i of
// Mᵀ·X, M an (R, R) tile of stride R + 1, X an (R, D) tile.
template <int D, int R>
__device__ __forceinline__ void mm_atb_acc(float acc[R / 8][D / 32],
                                           const float* M, const float* X,
                                           int w, int lane) {
  constexpr int LD = D + 1, LP = R + 1;
#pragma unroll 2
  for (int m = 0; m < R; ++m) {
    float p[R / 8], x[D / 32];
#pragma unroll
    for (int i = 0; i < R / 8; ++i) p[i] = M[m * LP + w + 8 * i];
#pragma unroll
    for (int j = 0; j < D / 32; ++j) x[j] = X[m * LD + lane + 32 * j];
#pragma unroll
    for (int i = 0; i < R / 8; ++i)
#pragma unroll
      for (int j = 0; j < D / 32; ++j) acc[i][j] = fmaf(p[i], x[j], acc[i][j]);
  }
}

// acc[i][j] += sum_c M[w + 8 i][c] · X[c][lane + 32 j]: rows w + 8 i of
// M·X.
template <int D, int R>
__device__ __forceinline__ void mm_ab_acc(float acc[R / 8][D / 32],
                                          const float* M, const float* X,
                                          int w, int lane) {
  constexpr int LD = D + 1, LP = R + 1;
#pragma unroll 2
  for (int c = 0; c < R; ++c) {
    float p[R / 8], x[D / 32];
#pragma unroll
    for (int i = 0; i < R / 8; ++i) p[i] = M[(w + 8 * i) * LP + c];
#pragma unroll
    for (int j = 0; j < D / 32; ++j) x[j] = X[c * LD + lane + 32 * j];
#pragma unroll
    for (int i = 0; i < R / 8; ++i)
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
  constexpr int R = kScalarRows<D>, N = R / 16;
  extern __shared__ float smem[];
  constexpr int LD = D + 1;
  float* Qs = smem;
  float* Ks = Qs + R * LD;
  const int q0 = blockIdx.x * R, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.n_heads / a.n_kv_heads);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int64_t row_base = ((int64_t)b * a.n_heads + h) * a.sq;

  // D = rowsum(dO ∘ O): a warp a row
  const int w = tid / 32, lane = tid % 32;
  for (int r = w; r < R; r += kThreads / 32) {
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

  load_tile<T, D, R>(Qs, q + b * a.qb + h * a.qh, a.qs, q0, a.sq);
  float m[N], l[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  int lo, hi;
  key_tiles<R>(a, q0, &lo, &hi);
  const T* kp = k + b * a.kb + hk * a.kh;
  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * R;
    __syncthreads();
    load_tile<T, D, R>(Ks, kp, a.ks, k0, a.skv);
    __syncthreads();
    float s[N][N];
    mm_abt<D, R>(s, Qs, Ks, ty, tx);
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) {
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
  for (int i = 0; i < N; ++i) {
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
template <int R>
__device__ __forceinline__ void probs(float p[R / 16][R / 16],
                                      const float s[R / 16][R / 16],
                                      const Args& a, const float* lse_s,
                                      int q0, int k0, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < R / 16; ++i)
#pragma unroll
    for (int j = 0; j < R / 16; ++j) {
      const int r = ty + 16 * i;
      p[i][j] = visible(a, q0 + r, k0 + tx + 16 * j)
                    ? expf(s[i][j] * a.scale - lse_s[r])
                    : 0.f;
    }
}

// dK and dV of R keys of one (batch, kv head), summed over the group's
// query heads and every query tile of the band.  Grid (key tiles, kv
// heads, batch).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
fa_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            T* __restrict__ dk, T* __restrict__ dv, Args a) {
  constexpr int R = kScalarRows<D>, N = R / 16, LP = R + 1;
  extern __shared__ float smem[];
  constexpr int LD = D + 1, DJ = D / 32;
  float* Ks = smem;
  float* Vs = Ks + R * LD;
  float* Qs = Vs + R * LD;
  float* Gs = Qs + R * LD;  // dO
  float* Ps = Gs + R * LD;
  float* Ss = Ps + R * LP;  // dS
  float* lse_s = Ss + R * LP;
  float* dl_s = lse_s + R;
  const int k0 = blockIdx.x * R, hk = blockIdx.y, b = blockIdx.z;
  const int group = a.n_heads / a.n_kv_heads;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int w = tid / 32, lane = tid % 32;

  load_tile<T, D, R>(Ks, k + b * a.kb + hk * a.kh, a.ks, k0, a.skv);
  load_tile<T, D, R>(Vs, v + b * a.vb + hk * a.vh, a.vs, k0, a.skv);
  float gk[R / 8][DJ], gv[R / 8][DJ];
#pragma unroll
  for (int i = 0; i < R / 8; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) gk[i][j] = gv[i][j] = 0.f;

  const int nq = (a.sq + R - 1) / R;
  const int qt_lo = a.causal ? k0 / R : 0;
  int qt_hi = nq;
  if (a.window >= 0)
    qt_hi = min(nq, (min(k0 + R, a.skv) - 1 + a.window) / R + 1);
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const int64_t row_base = ((int64_t)b * a.n_heads + h) * a.sq;
    for (int qt = qt_lo; qt < qt_hi; ++qt) {
      const int q0 = qt * R;
      __syncthreads();
      load_tile<T, D, R>(Qs, q + b * a.qb + h * a.qh, a.qs, q0, a.sq);
      load_tile<T, D, R>(Gs, dout + row_base * D, D, q0, a.sq);
      if (tid < R) {
        const bool in = q0 + tid < a.sq;
        lse_s[tid] = in ? lse[row_base + q0 + tid] : 0.f;
        dl_s[tid] = in ? delta[row_base + q0 + tid] : 0.f;
      }
      __syncthreads();
      float s[N][N], p[N][N], dp[N][N];
      mm_abt<D, R>(s, Qs, Ks, ty, tx);
      probs<R>(p, s, a, lse_s, q0, k0, ty, tx);
      mm_abt<D, R>(dp, Gs, Vs, ty, tx);
#pragma unroll
      for (int i = 0; i < N; ++i)
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const int r = ty + 16 * i, c = tx + 16 * j;
          Ps[r * LP + c] = p[i][j];
          Ss[r * LP + c] = p[i][j] * (dp[i][j] - dl_s[r]);
        }
      __syncthreads();
      mm_atb_acc<D, R>(gv, Ps, Gs, w, lane);
      mm_atb_acc<D, R>(gk, Ss, Qs, w, lane);
    }
  }
  const int64_t base = ((int64_t)b * a.n_kv_heads + hk) * a.skv;
#pragma unroll
  for (int i = 0; i < R / 8; ++i) {
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

// dQ of R query rows of one (batch, head), over the key tiles of the
// band.  Grid (query tiles, heads, batch).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
fa_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, Args a) {
  constexpr int R = kScalarRows<D>, N = R / 16, LP = R + 1;
  extern __shared__ float smem[];
  constexpr int LD = D + 1, DJ = D / 32;
  float* Qs = smem;
  float* Gs = Qs + R * LD;  // dO
  float* Ks = Gs + R * LD;
  float* Vs = Ks + R * LD;
  float* Ss = Vs + R * LD;  // dS
  float* lse_s = Ss + R * LP;
  float* dl_s = lse_s + R;
  const int q0 = blockIdx.x * R, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.n_heads / a.n_kv_heads);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int w = tid / 32, lane = tid % 32;
  const int64_t row_base = ((int64_t)b * a.n_heads + h) * a.sq;

  load_tile<T, D, R>(Qs, q + b * a.qb + h * a.qh, a.qs, q0, a.sq);
  load_tile<T, D, R>(Gs, dout + row_base * D, D, q0, a.sq);
  if (tid < R) {
    const bool in = q0 + tid < a.sq;
    lse_s[tid] = in ? lse[row_base + q0 + tid] : 0.f;
    dl_s[tid] = in ? delta[row_base + q0 + tid] : 0.f;
  }
  float gq[R / 8][DJ];
#pragma unroll
  for (int i = 0; i < R / 8; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) gq[i][j] = 0.f;
  int lo, hi;
  key_tiles<R>(a, q0, &lo, &hi);
  const T* kp = k + b * a.kb + hk * a.kh;
  const T* vp = v + b * a.vb + hk * a.vh;
  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * R;
    __syncthreads();
    load_tile<T, D, R>(Ks, kp, a.ks, k0, a.skv);
    load_tile<T, D, R>(Vs, vp, a.vs, k0, a.skv);
    __syncthreads();
    float s[N][N], p[N][N], dp[N][N];
    mm_abt<D, R>(s, Qs, Ks, ty, tx);
    probs<R>(p, s, a, lse_s, q0, k0, ty, tx);
    mm_abt<D, R>(dp, Gs, Vs, ty, tx);
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const int r = ty + 16 * i;
        Ss[r * LP + tx + 16 * j] = p[i][j] * (dp[i][j] - dl_s[r]);
      }
    __syncthreads();
    mm_ab_acc<D, R>(gq, Ss, Ks, w, lane);
  }
#pragma unroll
  for (int i = 0; i < R / 8; ++i) {
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
  return 2 * kScalarRows<D> * (D + 1) * (int)sizeof(float);
}
template <int D>
constexpr int dkdv_smem() {
  constexpr int R = kScalarRows<D>;
  return (4 * R * (D + 1) + 2 * R * (R + 1) + 2 * R) * (int)sizeof(float);
}
template <int D>
constexpr int dq_smem() {
  constexpr int R = kScalarRows<D>;
  return (4 * R * (D + 1) + R * (R + 1) + 2 * R) * (int)sizeof(float);
}

// The scalar kernels (float32): row statistics, dK and dV, dQ.
template <int D>
int launch_scalar(const void* q, const void* k, const void* v, const void* o,
                  const void* dout, void* dq, void* dk, void* dv, float* lse,
                  float* delta, const Args& a, cudaStream_t s) {
  using T = float;
  constexpr int R = kScalarRows<D>;
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
  const int nq = (a.sq + R - 1) / R, nk = (a.skv + R - 1) / R;
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

// ------------------------------------------------------- TMA + wgmma ----
// Mirrored by `bwd_tile_schedule` in kernels/flash_attention.py: keep the
// two in step.
constexpr int kWgRows = 64;    // keys (dK/dV) or query rows (dQ) a warpgroup
constexpr int kTileRows = 64;  // query rows (dK/dV) or keys (dQ) a ring tile
constexpr int kWgThreads = 128;
constexpr int kPadRows = 128;  // the LSE and D buffers' rows a head: Sq up
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kProducerRegs = 24;

struct HArgs {
  int n_heads, n_kv_heads, group, sq, skv, sq_pad;
  float scale, scale_log2;
  int causal, window;
  int4 orders;  // of the q, k, v and dO tensor maps
};

// The band of B3's masks over 64 x 64 tiles of (query rows from q0, keys
// from k0).  Rows past Sq and keys past Skv are not its business: their
// tiles are zero-filled.
struct Band {
  int causal, window;
  __device__ bool visible(int i, int j) const {
    return (!causal || j <= i) && (window < 0 || j >= i - window);
  }
  // no pair of the tile is visible: it is skipped
  __device__ bool outside(int q0, int k0) const {
    return (causal && k0 > q0 + kTileRows - 1) ||
           (window >= 0 && k0 + kTileRows - 1 < q0 - window);
  }
  // every pair is visible: it runs without the mask
  __device__ bool inside(int q0, int k0) const {
    return (!causal || k0 + kTileRows - 1 <= q0) &&
           (window < 0 || k0 >= q0 + kTileRows - 1 - window);
  }
};

// A bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Hand a ring slot back to the producer: each consumer warp arrives once.
__device__ __forceinline__ void release(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// A 64 x 64 product's accumulator (wgmma's D layout, 32 floats) as bf16 A
// fragments of the next product, whose depth is that product's 64 columns
// (16 a k-step).
__device__ __forceinline__ void to_a_fragments(const float (&s)[32],
                                               uint32_t (&f)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      f[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
}

// acc = A·Bᵀ over D: A 64 rows from `a`, B 64 rows from `b`, each as
// `Slabs<D>`, slabs `a_slab` and `b_slab` bytes apart, K-major; one wgmma
// group.
template <int D>
__device__ __forceinline__ void product_abt(float (&acc)[32], uint32_t a,
                                            uint32_t a_slab, uint32_t b,
                                            uint32_t b_slab) {
  using S = Slabs<D>;
#pragma unroll
  for (int j = 0; j < S::COUNT; ++j)
#pragma unroll
    for (int kk = 0; kk < S::COLS / 16; ++kk)
      wgmma_ss<64>(acc,
                   smem_desc(a + j * a_slab + kk * 32, 16, S::ATOM, S::LAYOUT),
                   smem_desc(b + j * b_slab + kk * 32, 16, S::ATOM, S::LAYOUT),
                   (j | kk) != 0);
  wgmma_commit();
}

// acc += F·X: F the 64 x 64 A fragments, X 64 rows of N columns at `x`
// (slabs of a D-column tile, `Slabs<D>`, `x_slab` bytes apart) read
// MN-major, 16 rows a k-step; one wgmma group.
template <int D, int N = D>
__device__ __forceinline__ void product_fx(float (&acc)[N / 2],
                                           const uint32_t (&f)[4][4],
                                           uint32_t x, uint32_t x_slab) {
  using S = Slabs<D>;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs_tb<N>(acc, f[kk],
                   smem_desc(x + kk * 16 * S::ROW_BYTES, x_slab, S::ATOM,
                             S::LAYOUT),
                   1);
  wgmma_commit();
}

// Columns [C0, C0 + NC) of a 64 x N accumulator's rows from `row0`
// (wgmma's D layout: this thread holds rows row0 + warp·16 + group and + 8)
// as bf16, times `scale`, into `out` (row stride `ld`, column 0 at the
// accumulator's column 0); rows at or past `n_rows` are not stored.
template <int N, int C0 = 0, int NC = N>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out,
                                           const float (&acc)[N / 2],
                                           int row0, int n_rows, int ld,
                                           float scale, int warp, int group,
                                           int tig) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + warp * 16 + group + 8 * r;
    if (row >= n_rows) continue;
    uint32_t* dst = reinterpret_cast<uint32_t*>(out + (int64_t)row * ld);
#pragma unroll
    for (int j = C0 / 8; j < (C0 + NC) / 8; ++j)
      dst[4 * j + tig] = pack_bf16(acc[4 * j + 2 * r] * scale,
                                   acc[4 * j + 2 * r + 1] * scale);
  }
}

// D = rowsum(dO ∘ O) and LSE · log2(e) of each row, a warp a row of the
// padded (B·H, sq_pad) buffers: 0 and +inf past Sq.
template <int D>
__global__ void __launch_bounds__(256)
fa_bwd_prep(const __nv_bfloat16* __restrict__ o,
            const __nv_bfloat16* __restrict__ dout,
            const float* __restrict__ lse, float* __restrict__ lse2,
            float* __restrict__ delta, int sq, int sq_pad, int n_rows) {
  const int at = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (at >= n_rows) return;
  const int bh = at / sq_pad, r = at % sq_pad;
  float s = 0.f;
  if (r < sq) {
    const int64_t row = (int64_t)bh * sq + r;
    const __nv_bfloat162* op =
        reinterpret_cast<const __nv_bfloat162*>(o + row * D);
    const __nv_bfloat162* gp =
        reinterpret_cast<const __nv_bfloat162*>(dout + row * D);
#pragma unroll
    for (int c = lane; c < D / 2; c += 32) {
      const float2 x = __bfloat1622float2(op[c]);
      const float2 g = __bfloat1622float2(gp[c]);
      s = fmaf(x.x, g.x, fmaf(x.y, g.y, s));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
  }
  if (lane == 0) {
    delta[at] = s;
    lse2[at] = r < sq ? lse[(int64_t)bh * sq + r] * kLog2e : INFINITY;
  }
}

// Shared memory of a dK/dV CTA at head dim D: K and V (64 keys each); for
// each of the two consumer warpgroups a ring of STAGES (Q, dO) tiles of 64
// query rows (at D 256 one ring the two share: SPLIT), each stored as
// `Slabs<D>` (D / 64 slabs of rows x 128 bytes, 128-byte swizzled; at D 96
// three of rows x 64 bytes, 64-byte swizzled); the rings' LSE and D rows;
// the mbarriers (K and V full, then full and empty for each stage).
template <int D>
struct DkdvTile {
  static_assert(D == 64 || D == 96 || D == 128 || D == 256,
                "head dim 64, 96, 128 or 256");
  using S = Slabs<D>;
  static constexpr int SLABS = S::COUNT;
  static constexpr int NWG = 2;  // consumer warpgroups
  // D 256: both warpgroups compute every item, each for its half of dK's
  // and dV's columns (64 + 64 accumulators a thread, as at D 128); two
  // (Q, dO) stages of 64 KB are all that fit beside K and V
  static constexpr bool SPLIT = D == 256;
  static constexpr int DC = SPLIT ? D / 2 : D;  // columns a warpgroup sums
  static constexpr int STAGES = 2;              // a ring's
  static constexpr int SLOTS = SPLIT ? STAGES : NWG * STAGES;
  static constexpr int RELEASERS = SPLIT ? 2 * 4 : 4;  // warps a slot waits
  static constexpr uint32_t KV_SLAB = kWgRows * S::ROW_BYTES;
  static constexpr uint32_t KV_BYTES = SLABS * KV_SLAB;
  static constexpr uint32_t T_SLAB = kTileRows * S::ROW_BYTES;
  static constexpr uint32_t T_BYTES = SLABS * T_SLAB;
  static constexpr uint32_t SLOT_BYTES = 2 * T_BYTES;        // Q, then dO
  static constexpr uint32_t STAT_BYTES = 2 * kTileRows * 4;  // LSE, then D
  static constexpr int THREADS = (NWG + 1) * kWgThreads;
  static constexpr int CONSUMER_REGS = 240;
  static constexpr int SMEM = 2 * KV_BYTES + SLOTS * (SLOT_BYTES + STAT_BYTES) +
                              8 * (1 + 2 * SLOTS) + 1024;
  // the two warpgroups' partial sums pass through the rings at the end
  static_assert(SPLIT || SLOTS * SLOT_BYTES >= 2 * D * kWgThreads * 2,
                "room for the partial sums");
};

// dK and dV of 64 keys of one (batch, kv head), summed over the group's
// query heads and the query tiles of the band: the ring's items (head g,
// query tile qt), in order, are dealt to the two warpgroups in turn, each
// sums its own, and the two sums are added in a fixed order at the end.
// At D 256 (SPLIT) both warpgroups take every item, each summing its half
// of the columns (Sᵀ and dPᵀ, which contract over all 256, are computed by
// both: 1.5x the pass's products), and each stores its half.
// Grid (kv heads, batch, key blocks): the first key blocks, the longest
// bands under a causal mask, start first.
template <int D>
__global__ void __launch_bounds__(DkdvTile<D>::THREADS, 1)
fa_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap q_map,
                  const __grid_constant__ CUtensorMap k_map,
                  const __grid_constant__ CUtensorMap v_map,
                  const __grid_constant__ CUtensorMap do_map,
                  const float* __restrict__ lse2,
                  const float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dk,
                  __nv_bfloat16* __restrict__ dv, HArgs a) {
  using T = DkdvTile<D>;
  constexpr int NWG = T::NWG;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t k_s = (raw + 1023) & ~1023u;
  const uint32_t v_s = k_s + T::KV_BYTES;
  const uint32_t ring = v_s + T::KV_BYTES;  // slot w · STAGES + stage
  const uint32_t stats = ring + T::SLOTS * T::SLOT_BYTES;
  const uint32_t kv_full = stats + T::SLOTS * T::STAT_BYTES;
  const uint32_t full = kv_full + 8, empty = full + 8 * T::SLOTS;

  const int hk = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * kWgRows;
  const int nq = (a.sq + kTileRows - 1) / kTileRows;
  const int qt_lo = a.causal ? k0 / kTileRows : 0;
  int qt_hi = nq;
  if (a.window >= 0)
    qt_hi = min(nq, (k0 + kWgRows - 1 + a.window) / kTileRows + 1);
  const int n_tiles = qt_hi - qt_lo;  // a query head's
  const int n_items = a.group * n_tiles;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
#pragma unroll
    for (int i = 0; i < T::SLOTS; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, T::RELEASERS);  // each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / kWgThreads;
  if (wg == NWG) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x != NWG * kWgThreads) return;
    mbar_expect_tx(kv_full, 2 * T::KV_BYTES);
#pragma unroll
    for (int j = 0; j < T::SLABS; ++j) {
      tma_load(k_s + j * T::KV_SLAB, &k_map, a.orders.y, kv_full,
               j * T::S::COLS, k0, hk, b);
      tma_load(v_s + j * T::KV_SLAB, &v_map, a.orders.z, kv_full,
               j * T::S::COLS, k0, hk, b);
    }
    for (int it = 0; it < n_items; ++it) {
      const int h = hk * a.group + it / n_tiles;
      const int q0 = (qt_lo + it % n_tiles) * kTileRows;
      // the ring's own item count, and its slot
      const int n = T::SPLIT ? it : it / NWG;
      const int slot = (T::SPLIT ? 0 : (it % NWG) * T::STAGES) + n % T::STAGES;
      mbar_wait(empty + 8 * slot, ((n / T::STAGES) & 1) ^ 1);
      mbar_expect_tx(full + 8 * slot, T::SLOT_BYTES + T::STAT_BYTES);
      const uint32_t dst = ring + slot * T::SLOT_BYTES;
#pragma unroll
      for (int j = 0; j < T::SLABS; ++j) {
        tma_load(dst + j * T::T_SLAB, &q_map, a.orders.x, full + 8 * slot,
                 j * T::S::COLS, q0, h, b);
        tma_load(dst + T::T_BYTES + j * T::T_SLAB, &do_map, a.orders.w,
                 full + 8 * slot, j * T::S::COLS, q0, h, b);
      }
      const int64_t row = ((int64_t)b * a.n_heads + h) * a.sq_pad + q0;
      const uint32_t sd = stats + slot * T::STAT_BYTES;
      bulk_load(sd, lse2 + row, kTileRows * 4, full + 8 * slot);
      bulk_load(sd + kTileRows * 4, delta + row, kTileRows * 4,
                full + 8 * slot);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      T::CONSUMER_REGS));

  const int tid = threadIdx.x % kWgThreads;
  const int warp = tid / 32, lane = tid % 32, group = lane / 4, tig = lane % 4;
  const Band band{a.causal, a.window};
  // Sᵀ's rows (keys) of this thread: key0 and key0 + 8; its columns (query
  // rows of the tile) are 8j + 2·tig + e, j < 8, e < 2
  const int key0 = k0 + warp * 16 + group;

  constexpr int DC = T::DC;
  float dk_acc[DC / 2], dv_acc[DC / 2];
#pragma unroll
  for (int i = 0; i < DC / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  float s[32], dp[32];
  uint32_t pf[4][4], df[4][4];
  // this warpgroup's n-th item is the ring's item wg + NWG·n (SPLIT: n),
  // and its columns of dO and Q start `cols` bytes into a tile
  const int n_mine = T::SPLIT ? n_items : (n_items - wg + NWG - 1) / NWG;
  const uint32_t cols = T::SPLIT ? wg * (DC / T::S::COLS) * T::T_SLAB : 0;
  auto slot = [&](int n) {
    return (T::SPLIT ? 0 : wg * T::STAGES) + n % T::STAGES;
  };
  // Sᵀ = K·Qᵀ of item n, once it has landed: one group
  auto issue_s = [&](int n) {
    mbar_wait(full + 8 * slot(n), (n / T::STAGES) & 1);
    wgmma_fence();
    product_abt<D>(s, k_s, T::KV_SLAB, ring + slot(n) * T::SLOT_BYTES,
                   T::T_SLAB);
  };
  mbar_wait(kv_full, 0);
  // Software-pipelined: Sᵀ of item n + 1 is issued right behind the dK
  // product of item n, so the tensor cores run the two back to back; item
  // n is released once its products are done.  (dPᵀ of item n + 1 waits
  // for the next round: its 32 accumulators in flight beside P, dS, dK
  // and dV would not fit in the consumers' registers.)
  if (n_mine > 0) issue_s(0);
  for (int n = 0; n < n_mine; ++n) {
    const int it = T::SPLIT ? n : wg + NWG * n;
    const int q0 = (qt_lo + it % n_tiles) * kTileRows;
    const uint32_t q_st = ring + slot(n) * T::SLOT_BYTES;
    const uint32_t do_st = q_st + T::T_BYTES;
    const float* lse_t = reinterpret_cast<const float*>(
        smem_raw + (stats + slot(n) * T::STAT_BYTES - raw));
    wgmma_wait_all();  // dV and dK of item n - 1, and Sᵀ
    fence_regs(s);
    fence_regs(dk_acc);
    fence_regs(dv_acc);
    if (n > 0) release(empty + 8 * slot(n - 1), lane);
    wgmma_fence();
    product_abt<D>(dp, v_s, T::KV_SLAB, do_st, T::T_SLAB);  // dPᵀ = V·dOᵀ
    if (band.inside(q0, k0)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int c = (i >> 2) * 8 + 2 * tig + (i & 1);
        s[i] = fast_exp2(fmaf(s[i], a.scale_log2, -lse_t[c]));
      }
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int c = (i >> 2) * 8 + 2 * tig + (i & 1);
        s[i] = band.visible(q0 + c, key0 + 8 * ((i >> 1) & 1))
                   ? fast_exp2(fmaf(s[i], a.scale_log2, -lse_t[c]))
                   : 0.f;
      }
    }
    to_a_fragments(s, pf);
    wgmma_fence();
    product_fx<D, DC>(dv_acc, pf, do_st + cols, T::T_SLAB);  // dV += Pᵀ·dO
    wgmma_wait_all_but_one();                     // dPᵀ
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = (i >> 2) * 8 + 2 * tig + (i & 1);
      dp[i] = s[i] * (dp[i] - lse_t[kTileRows + c]);
    }
    to_a_fragments(dp, df);
    wgmma_fence();
    product_fx<D, DC>(dk_acc, df, q_st + cols, T::T_SLAB);  // dK += dSᵀ·Q
    if (n + 1 < n_mine) issue_s(n + 1);
  }
  if (n_mine > 0) {
    wgmma_wait_all();
    fence_regs(dk_acc);
    fence_regs(dv_acc);
    release(empty + 8 * slot(n_mine - 1), lane);
  }

  const int64_t base = ((int64_t)b * a.n_kv_heads + hk) * a.skv * D;
  if constexpr (T::SPLIT) {
    // each warpgroup summed every item for its own columns
    store_rows<DC>(dk + base + wg * DC, dk_acc, k0, a.skv, D, a.scale, warp,
                   group, tig);
    store_rows<DC>(dv + base + wg * DC, dv_acc, k0, a.skv, D, 1.f, warp,
                   group, tig);
  } else {
    // warpgroup 1 hands over its dK, warpgroup 0 its dV, through the rings
    // (every tile is consumed): each thread's registers to the same thread
    // of the other warpgroup, in the same layout; then warpgroup 0 stores dK
    // and warpgroup 1 dV, each element summed as warpgroup 0's + warpgroup
    // 1's
    float* part = reinterpret_cast<float*>(smem_raw + (ring - raw)) + tid;
    asm volatile("bar.sync 1, %0;\n" ::"n"(NWG * kWgThreads) : "memory");
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) part[i * kWgThreads] = dv_acc[i];
    } else {
#pragma unroll
      for (int i = 0; i < D / 2; ++i)
        part[(D / 2 + i) * kWgThreads] = dk_acc[i];
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(NWG * kWgThreads) : "memory");
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i)
        dk_acc[i] += part[(D / 2 + i) * kWgThreads];
      store_rows<D>(dk + base, dk_acc, k0, a.skv, D, a.scale, warp, group,
                    tig);
    } else {
#pragma unroll
      for (int i = 0; i < D / 2; ++i)
        dv_acc[i] = part[i * kWgThreads] + dv_acc[i];
      store_rows<D>(dv + base, dv_acc, k0, a.skv, D, 1.f, warp, group, tig);
    }
  }
}

// Shared memory of a dQ CTA at head dim D: Q and dO (ROWS rows each), then
// a ring of STAGES (K, V) tiles of 64 keys, each as `Slabs<D>`; the
// mbarriers (Q and dO full, then full and empty for each stage).
template <int D>
struct DqTile {
  static_assert(D == 64 || D == 96 || D == 128 || D == 256,
                "head dim 64, 96, 128 or 256");
  using S = Slabs<D>;
  static constexpr int SLABS = S::COUNT;
  // D 256: 64 rows a CTA, whose (K, V) tiles are dealt to the two
  // warpgroups in turn, each summing a whole dQ (128 accumulators a
  // thread) over its own; 128 rows would leave room for one 64 KB stage
  static constexpr bool SPLIT = D == 256;
  static constexpr int ROWS = SPLIT ? kWgRows : 2 * kWgRows;
  static constexpr int STAGES = SPLIT ? 2 : (D == 128 ? 3 : 4);
  static constexpr int RELEASERS = SPLIT ? 4 : 2 * 4;  // warps a stage waits
  static constexpr uint32_t Q_SLAB = ROWS * S::ROW_BYTES;
  static constexpr uint32_t Q_BYTES = SLABS * Q_SLAB;  // Q or dO
  static constexpr uint32_t KV_SLAB = kTileRows * S::ROW_BYTES;
  static constexpr uint32_t KV_BYTES = SLABS * KV_SLAB;  // K or V
  static constexpr uint32_t STAGE_BYTES = 2 * KV_BYTES;  // K, then V
  static constexpr int THREADS = 3 * kWgThreads;
  static constexpr int CONSUMER_REGS = 240;
  static constexpr int SMEM = 2 * Q_BYTES + STAGES * STAGE_BYTES +
                              8 * (1 + 2 * STAGES) + 1024;
};

// dQ of 128 query rows of one (batch, head) over the key tiles of the
// band, 64 a warpgroup; at D 256 (SPLIT) of 64 rows, the key tiles dealt
// to the two warpgroups in turn and their sums added in a fixed order at
// the end.  Grid (heads, batch, query blocks), the last query blocks (the
// longest causal bands) first.
template <int D>
__global__ void __launch_bounds__(DqTile<D>::THREADS, 1)
fa_bwd_dq_wgmma(const __grid_constant__ CUtensorMap q_map,
                const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap v_map,
                const __grid_constant__ CUtensorMap do_map,
                const float* __restrict__ lse2,
                const float* __restrict__ delta,
                __nv_bfloat16* __restrict__ dq, HArgs a) {
  using T = DqTile<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t do_s = q_s + T::Q_BYTES;
  const uint32_t ring = do_s + T::Q_BYTES;
  const uint32_t q_full = ring + T::STAGES * T::STAGE_BYTES;
  const uint32_t full = q_full + 8, empty = full + 8 * T::STAGES;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * T::ROWS;
  const int nk = (a.skv + kTileRows - 1) / kTileRows;
  int kb_lo = 0, kb_hi = nk;
  if (a.causal) kb_hi = min(nk, (q0 + T::ROWS - 1) / kTileRows + 1);
  if (a.window >= 0 && q0 - a.window > 0)
    kb_lo = (q0 - a.window) / kTileRows;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int i = 0; i < T::STAGES; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, T::RELEASERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / kWgThreads;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x != 2 * kWgThreads) return;
    const int hk = h / a.group;
    mbar_expect_tx(q_full, 2 * T::Q_BYTES);
#pragma unroll
    for (int j = 0; j < T::SLABS; ++j)
#pragma unroll
      for (int w = 0; w < T::ROWS / kWgRows; ++w) {
        const uint32_t at = j * T::Q_SLAB + w * kWgRows * T::S::ROW_BYTES;
        tma_load(q_s + at, &q_map, a.orders.x, q_full, j * T::S::COLS,
                 q0 + w * kWgRows, h, b);
        tma_load(do_s + at, &do_map, a.orders.w, q_full, j * T::S::COLS,
                 q0 + w * kWgRows, h, b);
      }
    for (int kb = kb_lo, it = 0; kb < kb_hi; ++kb, ++it) {
      const int st = it % T::STAGES;
      mbar_wait(empty + 8 * st, ((it / T::STAGES) & 1) ^ 1);
      mbar_expect_tx(full + 8 * st, T::STAGE_BYTES);
      const uint32_t dst = ring + st * T::STAGE_BYTES;
#pragma unroll
      for (int j = 0; j < T::SLABS; ++j) {
        tma_load(dst + j * T::KV_SLAB, &k_map, a.orders.y, full + 8 * st,
                 j * T::S::COLS, kb * kTileRows, hk, b);
        tma_load(dst + T::KV_BYTES + j * T::KV_SLAB, &v_map, a.orders.z,
                 full + 8 * st, j * T::S::COLS, kb * kTileRows, hk, b);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      T::CONSUMER_REGS));

  const int tid = threadIdx.x % kWgThreads;
  const int warp = tid / 32, lane = tid % 32, group = lane / 4, tig = lane % 4;
  // this warpgroup's first row (SPLIT: the CTA's)
  const int r_lo = q0 + (T::SPLIT ? 0 : wg * kWgRows);
  const bool live = r_lo < a.sq;
  const uint32_t q_wg =
      q_s + (T::SPLIT ? 0 : wg * kWgRows * T::S::ROW_BYTES);
  const uint32_t do_wg =
      do_s + (T::SPLIT ? 0 : wg * kWgRows * T::S::ROW_BYTES);
  const Band band{a.causal, a.window};
  // this thread's rows: row0 and row0 + 8 (the padded buffers hold them)
  const int row0 = r_lo + warp * 16 + group;
  const int64_t bh = (int64_t)b * a.n_heads + h;
  const float l2[2] = {lse2[bh * a.sq_pad + row0],
                       lse2[bh * a.sq_pad + row0 + 8]};
  const float d2[2] = {delta[bh * a.sq_pad + row0],
                       delta[bh * a.sq_pad + row0 + 8]};

  float dq_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;
  float s[32], dp[32];
  uint32_t df[4][4];
  // ring slot and parity of key tile kb
  auto slot = [&](int kb) { return (kb - kb_lo) % T::STAGES; };
  auto phase = [&](int kb) { return ((kb - kb_lo) / T::STAGES) & 1; };
  // S = Q·Kᵀ and dP = dO·Vᵀ of tile kb, once it has landed: two groups
  auto issue_s = [&](int kb) {
    mbar_wait(full + 8 * slot(kb), phase(kb));
    const uint32_t k_st = ring + slot(kb) * T::STAGE_BYTES;
    wgmma_fence();
    product_abt<D>(s, q_wg, T::Q_SLAB, k_st, T::KV_SLAB);
    product_abt<D>(dp, do_wg, T::Q_SLAB, k_st + T::KV_BYTES, T::KV_SLAB);
  };
  // a tile this warpgroup does not compute: released once it has landed
  auto pass = [&](int kb) {
    mbar_wait(full + 8 * slot(kb), phase(kb));
    release(empty + 8 * slot(kb), lane);
  };
  if constexpr (T::SPLIT) {
    // tile kb_lo + i is warpgroup (i % 2)'s, in ring slot i % 2: each
    // warpgroup waits for its tile, computes it whole, and releases it
    // while the other computes its own
    mbar_wait(q_full, 0);
    for (int kb = kb_lo + wg; kb < kb_hi; kb += 2) {
      const int k0 = kb * kTileRows;
      if (band.outside(r_lo, k0)) {
        pass(kb);
        continue;
      }
      issue_s(kb);
      wgmma_wait_all_but_one();  // S
      fence_regs(s);
      if (band.inside(r_lo, k0)) {
#pragma unroll
        for (int i = 0; i < 32; ++i)
          s[i] = fast_exp2(fmaf(s[i], a.scale_log2, -l2[(i >> 1) & 1]));
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int r = (i >> 1) & 1;
          const int key = k0 + (i >> 2) * 8 + 2 * tig + (i & 1);
          s[i] = band.visible(row0 + 8 * r, key)
                     ? fast_exp2(fmaf(s[i], a.scale_log2, -l2[r]))
                     : 0.f;
        }
      }
      wgmma_wait_all();  // dP
      fence_regs(dp);
#pragma unroll
      for (int i = 0; i < 32; ++i) dp[i] = s[i] * (dp[i] - d2[(i >> 1) & 1]);
      to_a_fragments(dp, df);
      wgmma_fence();
      product_fx<D>(dq_acc, df, ring + slot(kb) * T::STAGE_BYTES,
                    T::KV_SLAB);  // dQ += dS·K
      wgmma_wait_all();
      fence_regs(dq_acc);
      release(empty + 8 * slot(kb), lane);
    }
    // warpgroup 0 hands over its columns D/2.., warpgroup 1 its columns
    // ..D/2, through the ring (every tile is consumed); each half is then
    // summed as warpgroup 0's + warpgroup 1's and stored by the warpgroup
    // that holds it
    float* part = reinterpret_cast<float*>(smem_raw + (ring - smem_addr(
                                                          smem_raw))) + tid;
    constexpr int H = D / 4;  // accumulators a thread holds of each half
    asm volatile("bar.sync 1, %0;\n" ::"n"(2 * kWgThreads) : "memory");
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < H; ++i) part[(H + i) * kWgThreads] = dq_acc[H + i];
    } else {
#pragma unroll
      for (int i = 0; i < H; ++i) part[i * kWgThreads] = dq_acc[i];
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(2 * kWgThreads) : "memory");
    if (wg == 0) {
#pragma unroll
      for (int i = 0; i < H; ++i) dq_acc[i] += part[i * kWgThreads];
      store_rows<D, 0, D / 2>(dq + bh * a.sq * D, dq_acc, r_lo, a.sq, D,
                              a.scale, warp, group, tig);
    } else {
#pragma unroll
      for (int i = 0; i < H; ++i)
        dq_acc[H + i] = part[(H + i) * kWgThreads] + dq_acc[H + i];
      store_rows<D, D / 2, D / 2>(dq + bh * a.sq * D, dq_acc, r_lo, a.sq, D,
                                  a.scale, warp, group, tig);
    }
    return;
  }
  // the tiles [x, y) this warpgroup computes: the band is contiguous, so
  // the others lie at the ends of the CTA's [kb_lo, kb_hi)
  int x = kb_lo, y = live ? kb_hi : kb_lo;
  while (x < y && band.outside(r_lo, x * kTileRows)) ++x;
  while (y > x && band.outside(r_lo, (y - 1) * kTileRows)) --y;
  for (int kb = kb_lo; kb < x; ++kb) pass(kb);
  // Software-pipelined: S and dP of tile kb + 1 are issued right behind
  // dQ's product of tile kb, so the tensor cores run them while this
  // warpgroup waits; tile kb is released once its product is done.
  if (x < y) {
    mbar_wait(q_full, 0);
    issue_s(x);
  }
  for (int kb = x; kb < y; ++kb) {
    const int k0 = kb * kTileRows;
    wgmma_wait_all_but_one();  // dQ's product of tile kb - 1, and S
    fence_regs(s);
    fence_regs(dq_acc);
    if (kb > x) release(empty + 8 * slot(kb - 1), lane);
    if (band.inside(r_lo, k0)) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        s[i] = fast_exp2(fmaf(s[i], a.scale_log2, -l2[(i >> 1) & 1]));
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        const int key = k0 + (i >> 2) * 8 + 2 * tig + (i & 1);
        s[i] = band.visible(row0 + 8 * r, key)
                   ? fast_exp2(fmaf(s[i], a.scale_log2, -l2[r]))
                   : 0.f;
      }
    }
    wgmma_wait_all();  // dP
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) dp[i] = s[i] * (dp[i] - d2[(i >> 1) & 1]);
    to_a_fragments(dp, df);
    wgmma_fence();
    product_fx<D>(dq_acc, df, ring + slot(kb) * T::STAGE_BYTES,
                  T::KV_SLAB);  // dQ += dS·K
    if (kb + 1 < y) issue_s(kb + 1);
  }
  if (x < y) {
    wgmma_wait_all();
    fence_regs(dq_acc);
    release(empty + 8 * slot(y - 1), lane);
  }
  for (int kb = y; kb < kb_hi; ++kb) pass(kb);
  if (!live) return;
  store_rows<D>(dq + bh * a.sq * D, dq_acc, r_lo, a.sq, D, a.scale, warp,
                group, tig);
}

template <typename K>
int set_smem(K kern, int bytes) {
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// The tensor-core kernels (bf16): prep, dK and dV, dQ.  q, k, v are read
// through TMA at their strides `st`; dout and o are contiguous.
template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, const void* o,
                 const void* dout, void* dq, void* dk, void* dv,
                 const float* lse, float* scratch, int batch, int n_heads,
                 int n_kv_heads, int sq, int skv, const int64_t* st,
                 float sm_scale, int causal, int window, cudaStream_t s) {
  HArgs a;
  a.n_heads = n_heads;
  a.n_kv_heads = n_kv_heads;
  a.group = n_heads / n_kv_heads;
  a.sq = sq;
  a.skv = skv;
  a.sq_pad = (sq + kPadRows - 1) / kPadRows * kPadRows;
  a.scale = sm_scale;
  a.scale_log2 = sm_scale * kLog2e;
  a.causal = causal;
  a.window = window;
  CUtensorMap maps[4];
  int orders[4];
  constexpr int RB = Slabs<D>::ROW_BYTES;
  const int64_t do_st[3] = {(int64_t)n_heads * sq * D, (int64_t)sq * D, D};
  int e = encode_map(&maps[0], &orders[0], q, batch, n_heads, sq, D, st,
                     kTileRows, RB);
  if (!e)
    e = encode_map(&maps[1], &orders[1], k, batch, n_kv_heads, skv, D,
                   st + 3, kTileRows, RB);
  if (!e)
    e = encode_map(&maps[2], &orders[2], v, batch, n_kv_heads, skv, D,
                   st + 6, kTileRows, RB);
  if (!e)
    e = encode_map(&maps[3], &orders[3], dout, batch, n_heads, sq, D, do_st,
                   kTileRows, RB);
  if (e) return e;
  a.orders = make_int4(orders[0], orders[1], orders[2], orders[3]);

  float* lse2 = scratch;
  float* delta = scratch + (int64_t)batch * n_heads * a.sq_pad;
  const int n_rows = batch * n_heads * a.sq_pad;
  fa_bwd_prep<D><<<(n_rows + 7) / 8, 256, 0, s>>>(
      (const __nv_bfloat16*)o, (const __nv_bfloat16*)dout, lse, lse2, delta,
      sq, a.sq_pad, n_rows);
  e = (int)cudaGetLastError();
  if (e) return e;

  auto* bk = (__nv_bfloat16*)dk;
  auto* bv = (__nv_bfloat16*)dv;
  using T = DkdvTile<D>;
  e = set_smem(fa_bwd_dkdv_wgmma<D>, T::SMEM);
  if (e) return e;
  fa_bwd_dkdv_wgmma<D><<<dim3(n_kv_heads, batch,
                              (skv + kWgRows - 1) / kWgRows),
                         T::THREADS, T::SMEM, s>>>(
      maps[0], maps[1], maps[2], maps[3], lse2, delta, bk, bv, a);
  e = (int)cudaGetLastError();
  if (e) return e;

  using TQ = DqTile<D>;
  e = set_smem(fa_bwd_dq_wgmma<D>, TQ::SMEM);
  if (e) return e;
  fa_bwd_dq_wgmma<D><<<dim3(n_heads, batch, (sq + TQ::ROWS - 1) / TQ::ROWS),
                       TQ::THREADS, TQ::SMEM, s>>>(
      maps[0], maps[1], maps[2], maps[3], lse2, delta,
      (__nv_bfloat16*)dq, a);
  return (int)cudaGetLastError();
}

template <typename K>
int attributes_of(K kern, int dyn, int* attrs) {
  cudaFuncAttributes fa;
  const cudaError_t e = cudaFuncGetAttributes(&fa, kern);
  if (e != cudaSuccess) return (int)e;
  attrs[0] = fa.numRegs;
  attrs[1] = (int)fa.sharedSizeBytes;
  attrs[2] = dyn;
  attrs[3] = (int)fa.localSizeBytes;
  attrs[4] = fa.maxThreadsPerBlock;
  return 0;
}

template <int D>
int attributes_d(int which, int* attrs) {
  if (which == 0)
    return attributes_of(fa_bwd_dkdv_wgmma<D>, DkdvTile<D>::SMEM, attrs);
  if (which == 1)
    return attributes_of(fa_bwd_dq_wgmma<D>, DqTile<D>::SMEM, attrs);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q (B, H, Sq, D) and k, v (B, Hkv, Skv, D) read through `strides` (q's,
// k's and v's batch, head and sequence strides in elements; unit stride
// on D); o and dout (B, H, Sq, D) contiguous, o the forward's output;
// dq, dk, dv contiguous outputs in the input dtype.  dtype 0 float32
// (the scalar kernels): lse and scratch are (B, H, Sq) float32 scratch.
// dtype 1 bf16 (TMA + wgmma; q, k and v 16-byte aligned, their strides
// multiples of 16 bytes): lse is the forward's row log-sum-exp (B, H, Sq)
// float32, scratch 2 x (B, H, Sq rounded up to 128) float32.  Head dim
// 64, 96, 128 or 256.  Returns 0, a cudaError_t, or (TMA map encoding)
// kNoEncoder / kEncodeFailed + CUresult.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, void* lse, void* scratch,
    int dtype, int batch, int n_heads, int n_kv_heads, int sq, int skv, int d,
    const int64_t* strides, float sm_scale, int causal, int window,
    void* stream) {
  if (batch == 0 || n_heads == 0 || sq == 0 || skv == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) {
#define FA_BWD_WGMMA(DIM)                                                    \
  if (d == DIM)                                                              \
    return launch_wgmma<DIM>(q, k, v, o, dout, dq, dk, dv,                   \
                             (const float*)lse, (float*)scratch, batch,      \
                             n_heads, n_kv_heads, sq, skv, strides, sm_scale, \
                             causal, window, s);
    FA_BWD_WGMMA(64)
    FA_BWD_WGMMA(96)
    FA_BWD_WGMMA(128)
    FA_BWD_WGMMA(256)
#undef FA_BWD_WGMMA
    return (int)cudaErrorInvalidValue;
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
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
  if (d == 64)
    return launch_scalar<64>(q, k, v, o, dout, dq, dk, dv, (float*)lse,
                             (float*)scratch, a, s);
  if (d == 96)
    return launch_scalar<96>(q, k, v, o, dout, dq, dk, dv, (float*)lse,
                             (float*)scratch, a, s);
  if (d == 128)
    return launch_scalar<128>(q, k, v, o, dout, dq, dk, dv, (float*)lse,
                              (float*)scratch, a, s);
  if (d == 256)
    return launch_scalar<256>(q, k, v, o, dout, dq, dk, dv, (float*)lse,
                              (float*)scratch, a, s);
  return (int)cudaErrorInvalidValue;
}

// The tensor-core kernels' build at head dim d (64, 96, 128 or 256): which
// 0 the dK/dV kernel, 1 the dQ kernel.  attrs gets registers a thread,
// static shared bytes, the dynamic shared bytes it is launched with, local
// (spill) bytes a thread, and max threads a block.
extern "C" int flash_attention_bwd_attributes(int d, int which, int* attrs) {
  if (d == 64) return attributes_d<64>(which, attrs);
  if (d == 96) return attributes_d<96>(which, attrs);
  if (d == 128) return attributes_d<128>(which, attrs);
  if (d == 256) return attributes_d<256>(which, attrs);
  return (int)cudaErrorInvalidValue;
}
