// mamba2's SSD (state-space duality) scan, step by step in float32.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py, `ssd_scan`
// (`_ssd_kernel`), which walks a (batch, heads, chunks) grid in order on one
// core, carries the P x N state in VMEM from one chunk to the next and maps
// each chunk onto MXU products (C·Bᵀ, the decay-masked product with X, the
// carried state's contribution and update).  On the card blocks carry
// nothing between them, so one CTA owns a block of state rows of one
// (batch, head) and loops over the whole sequence itself.
//
// Semantics, per head, with H_t in R^{P x N} kept in float32:
//   H_t = a_t · H_{t-1} + x_t ⊗ b_t,   y_t = H_t · c_t,
// a_t clamped below at 1e-37 (the Pallas kernel clamps the log-decay
// there), H_{-1} = h0 (zeros when absent); y is written in x's dtype and
// the final state H_{S-1} in float32.  The rows of H never mix, so a CTA
// takes any block of rows and the (b, h) pair's rows split across CTAs.
//
// Design (the simple one; a chunked form on the tensor cores is later
// work): 128 threads, each holding 2 rows x 16 state columns of H in
// registers (1 x 8, 1 x 16 and 4 x 8 layouts ran slower on an H100).  The
// 16 columns of a thread are interleaved in groups of 4 (column q·4·TPR +
// ns·4 + r for thread slot ns, group q, lane r) so the float4 reads of b
// and c by neighbouring threads hit neighbouring banks.
// Step inputs (x, a, b, c) are staged in shared memory as float32, kL
// steps at a time; the next chunk's global loads are issued into
// registers before the current chunk is computed, so their latency hides
// behind it.  Each step a thread leaves its partial sums of y_t for its 2
// rows in shared memory, and the TPR = N / 16 partials of a row are added
// once per chunk for all kL steps together, off the recurrence's critical
// path.  b and c are read through their strides, so the model's broadcast
// over heads (stride 0) costs no copy.
//
// What bounds it on an H100: operations, on the CUDA cores.  Each state
// element costs 3 float32 instructions per step (x·b, a·H + that, the y
// FMA), so at mamba2-370m's prefill shape (B=4, S=32768, H=32, P=64,
// N=128) the kernel issues about 1.03e11 of them, ~3 ms at the card's
// 3.35e13 float32 instructions a second outside the tensor cores (its 67
// TFLOP/s counts an FMA as two operations); the bytes (1.15 GB,
// 0.34 ms at 3.35 TB/s) and the chunked form on the tensor cores (3.4e11
// FLOP, 0.35 ms at 989 TFLOP/s) bound the work itself well below that.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "float_convert.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRP = 2;   // state rows per thread
constexpr int kNT = 16;  // state columns per thread
constexpr int kL = 8;    // steps staged in shared memory at a time

struct Strides {
  int64_t x_b, x_s, x_h;  // x (B, S, H, P), unit stride on P
  int64_t a_b, a_s, a_h;  // a (B, S, H)
  int64_t b_b, b_s, b_h;  // b (B, S, H, N), unit stride on N
  int64_t c_b, c_s, c_h;  // c (B, S, H, N), unit stride on N
};

// column of state element j (0..kNT-1) of thread slot ns
template <int TPR>
__device__ __forceinline__ int column(int ns, int j) {
  return (j >> 2) * (4 * TPR) + ns * 4 + (j & 3);
}

// TPR = N / kNT threads share a block of kRP rows; R = rows of H per CTA
template <typename T, int TPR>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const T* __restrict__ a,
                const T* __restrict__ bm, const T* __restrict__ cm,
                const float* __restrict__ h0, T* __restrict__ y,
                float* __restrict__ hT, int S, int H, int P, Strides st) {
  constexpr int N = kNT * TPR;
  constexpr int R = kRP * kThreads / TPR;
  constexpr int kBC = kL * N / kThreads;  // b (and c) values per thread
  constexpr int kX = (kL * R + kThreads - 1) / kThreads;  // x per thread
  __shared__ __align__(16) float a_s[kL];
  __shared__ __align__(16) float x_s[kL][R];
  __shared__ __align__(16) float b_s[kL][N];
  __shared__ __align__(16) float c_s[kL][N];
  __shared__ __align__(16) float y_s[kL][kThreads * kRP];  // partials

  const int tid = threadIdx.x;
  const int rq = tid / TPR, ns = tid % TPR;
  const int hh = blockIdx.y, bb = blockIdx.z;
  const int p_base = blockIdx.x * R;
  const int row0 = p_base + kRP * rq;

  const T* xb = x + bb * st.x_b + hh * st.x_h;
  const T* ab = a + bb * st.a_b + hh * st.a_h;
  const T* bb_ = bm + bb * st.b_b + hh * st.b_h;
  const T* cb = cm + bb * st.c_b + hh * st.c_h;
  const int64_t bh = (int64_t)bb * H + hh;

  float h[kRP][kNT];
#pragma unroll
  for (int k = 0; k < kRP; ++k) {
    const int row = row0 + k;
#pragma unroll
    for (int j = 0; j < kNT; ++j)
      h[k][j] = (h0 != nullptr && row < P)
                    ? h0[(bh * P + row) * N + column<TPR>(ns, j)]
                    : 0.f;
  }

  // the next chunk's inputs, in flight while the current one is computed
  T rb[kBC], rc[kBC], rx[kX];
  T ra = from_f32<T>(1.f);
  auto load = [&](int t0) {
#pragma unroll
    for (int i = 0; i < kBC; ++i) {
      const int e = tid + i * kThreads, t = t0 + e / N, n = e % N;
      const bool ok = t < S;
      rb[i] = ok ? bb_[t * st.b_s + n] : from_f32<T>(0.f);
      rc[i] = ok ? cb[t * st.c_s + n] : from_f32<T>(0.f);
    }
#pragma unroll
    for (int i = 0; i < kX; ++i) {
      const int e = tid + i * kThreads, t = t0 + e / R, row = p_base + e % R;
      rx[i] = (e < kL * R && t < S && row < P) ? xb[t * st.x_s + row]
                                               : from_f32<T>(0.f);
    }
    if (tid < kL && t0 + tid < S) ra = ab[(t0 + tid) * st.a_s];
  };
  auto stage = [&]() {
#pragma unroll
    for (int i = 0; i < kBC; ++i) {
      const int e = tid + i * kThreads;
      b_s[e / N][e % N] = to_f32(rb[i]);
      c_s[e / N][e % N] = to_f32(rc[i]);
    }
#pragma unroll
    for (int i = 0; i < kX; ++i) {
      const int e = tid + i * kThreads;
      if (e < kL * R) x_s[e / R][e % R] = to_f32(rx[i]);
    }
    if (tid < kL) a_s[tid] = fmaxf(to_f32(ra), 1e-37f);
  };

  load(0);
  for (int t0 = 0; t0 < S; t0 += kL) {
    __syncthreads();  // the previous chunk is done with the buffers
    stage();
    __syncthreads();
    if (t0 + kL < S) load(t0 + kL);
    const int steps = min(kL, S - t0);
    for (int tt = 0; tt < steps; ++tt) {
      const float at = a_s[tt];
      float xr[kRP];
#pragma unroll
      for (int k = 0; k < kRP; ++k) xr[k] = x_s[tt][kRP * rq + k];
      const float4* bq = reinterpret_cast<const float4*>(&b_s[tt][ns * 4]);
      const float4* cq = reinterpret_cast<const float4*>(&c_s[tt][ns * 4]);
      float yv[kRP];
#pragma unroll
      for (int k = 0; k < kRP; ++k) yv[k] = 0.f;
#pragma unroll
      for (int q = 0; q < kNT / 4; ++q) {
        const float4 bv = bq[q * TPR];
        const float4 cv = cq[q * TPR];
        const float bj[4] = {bv.x, bv.y, bv.z, bv.w};
        const float cj[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int k = 0; k < kRP; ++k) {
            float& hk = h[k][q * 4 + r];
            hk = fmaf(at, hk, xr[k] * bj[r]);
            yv[k] = fmaf(hk, cj[r], yv[k]);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kRP; ++k) y_s[tt][tid * kRP + k] = yv[k];
    }
    __syncthreads();
    // y_t[row] = the sum of the TPR partials of the row's thread slots
    for (int e = tid; e < steps * R; e += kThreads) {
      const int tt = e / R, r = e % R, row = p_base + r;
      const float* part = &y_s[tt][(r / kRP) * TPR * kRP + r % kRP];
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < TPR; ++k) acc += part[kRP * k];
      if (row < P)
        y[((int64_t)(bb * (int64_t)S + t0 + tt) * H + hh) * P + row] =
            from_f32<T>(acc);
    }
  }

#pragma unroll
  for (int k = 0; k < kRP; ++k) {
    const int row = row0 + k;
    if (row >= P) continue;
    float* out = hT + (bh * P + row) * N;
#pragma unroll
    for (int q = 0; q < kNT / 4; ++q)
      *reinterpret_cast<float4*>(&out[q * 4 * TPR + ns * 4]) =
          make_float4(h[k][4 * q], h[k][4 * q + 1], h[k][4 * q + 2],
                      h[k][4 * q + 3]);
  }
}

template <typename T, int TPR>
int launch(const void* x, const void* a, const void* b, const void* c,
           const float* h0, void* y, float* hT, int batch, int S, int H,
           int P, const Strides& st, cudaStream_t stream) {
  constexpr int R = kRP * kThreads / TPR;
  dim3 grid((P + R - 1) / R, H, batch);
  ssd_scan_kernel<T, TPR><<<grid, kThreads, 0, stream>>>(
      (const T*)x, (const T*)a, (const T*)b, (const T*)c, h0, (T*)y, hT, S,
      H, P, st);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_n(int n, const void* x, const void* a, const void* b,
             const void* c, const float* h0, void* y, float* hT, int batch,
             int S, int H, int P, const Strides& st, cudaStream_t stream) {
  switch (n) {
    case 16:
      return launch<T, 16 / kNT>(x, a, b, c, h0, y, hT, batch, S, H, P, st,
                                 stream);
    case 32:
      return launch<T, 32 / kNT>(x, a, b, c, h0, y, hT, batch, S, H, P, st,
                                 stream);
    case 64:
      return launch<T, 64 / kNT>(x, a, b, c, h0, y, hT, batch, S, H, P, st,
                                 stream);
    case 128:
      return launch<T, 128 / kNT>(x, a, b, c, h0, y, hT, batch, S, H, P, st,
                                  stream);
    case 256:
      return launch<T, 256 / kNT>(x, a, b, c, h0, y, hT, batch, S, H, P, st,
                                  stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, a, b, c and y share it).  strides: the
// 12 element strides of Strides, in its order.  h0 may be null (zeros);
// y is contiguous (B, S, H, P) and hT contiguous (B, H, P, N) float32.
// Returns cudaGetLastError() after the launch.
extern "C" int ssd_scan_launch(const void* x, const void* a, const void* b,
                               const void* c, const void* h0, void* y,
                               void* hT, int dtype, int batch, int S, int H,
                               int P, int N, const int64_t* strides,
                               void* stream) {
  if (batch == 0 || S == 0 || H == 0 || P == 0) return 0;
  Strides st{strides[0], strides[1], strides[2],  strides[3],
             strides[4], strides[5], strides[6],  strides[7],
             strides[8], strides[9], strides[10], strides[11]};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_n<float>(N, x, a, b, c, (const float*)h0, y, (float*)hT,
                           batch, S, H, P, st, s);
  if (dtype == 1)
    return launch_n<__nv_bfloat16>(N, x, a, b, c, (const float*)h0, y,
                                   (float*)hT, batch, S, H, P, st, s);
  return (int)cudaErrorInvalidValue;
}
