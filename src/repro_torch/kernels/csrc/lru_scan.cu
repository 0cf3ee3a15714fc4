// The RG-LRU diagonal recurrence (RecurrentGemma / Griffin).
//
// Replaces the TPU kernel src/repro/kernels/lru_scan.py, `lru_scan`
// (`_lru_kernel`), which walks a (batch, channel blocks, chunks) grid in
// order, runs a fori_loop over each chunk vectorised across a 128-lane
// block of channels, and carries the state in VMEM from one chunk to the
// next.  On the card blocks carry nothing between them, so each thread owns
// one (batch, channel) pair and walks the whole sequence itself.
//
// Semantics: h_t = a_t ⊙ h_{t-1} + x_t in float32, h_{-1} = h0 (zeros when
// absent); y_t = h_t written in x's dtype, the final state in float32.
//
// What bounds it on an H100: bytes.  Each element of x and a is read once
// and each element of y written once (at recurrentgemma-9b's prefill shape,
// B=4, S=4096, D=4096 in bf16: 403 MB, 0.12 ms at 3.35 TB/s) for one FMA.
// The recurrence is sequential in S, so the parallelism is B·D threads
// (16,384 there, ~4 warps an SM) and the bytes in flight have to come from
// each thread looking ahead: a thread loads the next kU steps of x and a
// into registers before it computes the current kU, so kU loads of each
// are in flight behind the dependent FMA chain.  Neighbouring threads own
// neighbouring channels, so every load and store of a warp is one
// contiguous run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "float_convert.cuh"

namespace {

constexpr int kThreads = 64;
constexpr int kU = 32;  // steps a thread has in flight

template <typename T>
__global__ void __launch_bounds__(kThreads)
lru_scan_kernel(const T* __restrict__ x, const T* __restrict__ a,
                const float* __restrict__ h0, T* __restrict__ y,
                float* __restrict__ hT, int S, int D, int64_t x_b,
                int64_t x_s, int64_t a_b, int64_t a_s) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const int bb = blockIdx.y;
  if (d >= D) return;
  const T* xp = x + bb * x_b + d;
  const T* ap = a + bb * a_b + d;
  T* yp = y + (int64_t)bb * S * D + d;
  float h = h0 != nullptr ? h0[(int64_t)bb * D + d] : 0.f;

  T xn[kU], an[kU];
  auto load = [&](int t0) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int t = t0 + u;
      xn[u] = t < S ? xp[t * x_s] : from_f32<T>(0.f);
      an[u] = t < S ? ap[t * a_s] : from_f32<T>(0.f);
    }
  };
  load(0);
  for (int t0 = 0; t0 < S; t0 += kU) {
    T xc[kU], ac[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      xc[u] = xn[u];
      ac[u] = an[u];
    }
    if (t0 + kU < S) load(t0 + kU);
    if (t0 + kU <= S) {
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        h = fmaf(to_f32(ac[u]), h, to_f32(xc[u]));
        yp[(int64_t)(t0 + u) * D] = from_f32<T>(h);
      }
    } else {
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (t0 + u < S) {
          h = fmaf(to_f32(ac[u]), h, to_f32(xc[u]));
          yp[(int64_t)(t0 + u) * D] = from_f32<T>(h);
        }
      }
    }
  }
  hT[(int64_t)bb * D + d] = h;
}

template <typename T>
int launch(const void* x, const void* a, const float* h0, void* y, float* hT,
           int batch, int S, int D, const int64_t* st, cudaStream_t stream) {
  dim3 grid((D + kThreads - 1) / kThreads, batch);
  lru_scan_kernel<T><<<grid, kThreads, 0, stream>>>(
      (const T*)x, (const T*)a, h0, (T*)y, hT, S, D, st[0], st[1], st[2],
      st[3]);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, a and y share it).  strides: x's batch
// and sequence strides, then a's (unit stride on D for both).  h0 may be
// null (zeros); y is contiguous (B, S, D) and hT contiguous (B, D) float32.
// Returns cudaGetLastError() after the launch.
extern "C" int lru_scan_launch(const void* x, const void* a, const void* h0,
                               void* y, void* hT, int dtype, int batch, int S,
                               int D, const int64_t* strides, void* stream) {
  if (batch == 0 || D == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(x, a, (const float*)h0, y, (float*)hT, batch, S, D,
                         strides, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, a, (const float*)h0, y, (float*)hT,
                                 batch, S, D, strides, s);
  return (int)cudaErrorInvalidValue;
}
