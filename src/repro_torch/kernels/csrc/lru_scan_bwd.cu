// The backward of the RG-LRU diagonal recurrence (B5-bwd).
//
// Replaces no TPU kernel: the reference has no Pallas backward.  Off a TPU
// its training differentiates the XLA `lru_scan_ref` (`ops.lru_scan`
// resolves "auto" to "xla", src/repro/kernels/ops.py:71-77), so this
// computes what `jax.grad` of `repro.kernels.ref.lru_scan_ref` computes.
// For h_t = a_t·h_{t-1} + x_t in float32 from h0 (zeros when absent), y_t
// = h_t in x's dtype and the final state h_{S-1} in float32, with the
// incoming gradients dy and dhT:
//   g_{S-1} = dy_{S-1} + dhT,  g_t = dy_t + a_{t+1}·g_{t+1},
//   dx_t = g_t,  da_t = g_t·h_{t-1},  dh0 = a_0·g_0,
// every sum in float32, dx and da written once in the input dtype, dh0 in
// float32.
//
// What bounds it on an H100: bytes.  x, a and dy are read once and dx and
// da written once (at recurrentgemma-9b's training shape, B 2, S 4,096, D
// 4,096 in bf16: 335,544,320 B, 0.100 ms at 3.35 TB/s) for a few flops an
// element.  As in B5 (csrc/lru_scan.cu) the recurrence is sequential in S,
// so each thread owns one (batch, channel) pair and the bytes in flight
// come from each thread loading ahead of its dependent chain.
//
// da needs the float32 h_{t-1}, which the forward does not keep (it returns
// y rounded to x's dtype).  The kernel recomputes it: a forward walk keeps
// h at the start of every kC-step chunk in a float32 scratch (B, ⌈S/kC⌉,
// D) the wrapper allocates (4 MB at the training shape); then a reverse
// walk takes the chunks from the last, refills a chunk's h_{t-1} from its
// start state into shared memory (a column a thread) and walks g back
// through it.  That reads x and a twice: 1.4x the bound's bytes, against
// keeping a float32 h from the forward (a (B, S, D) tensor a layer, 134 MB
// at the training shape, alive from the forward to the backward).  Each
// walk loads the next chunk (x and a; the reverse walk also dy) while it
// computes the current one.  At the training shape that is 8,192 threads,
// ~2 warps an SM: latency, not bandwidth, sets the pace (ROADMAP: a split
// of S with a carry fix-up is the next step).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "float_convert.cuh"

namespace {

constexpr int kThreads = 64;
constexpr int kC = 32;  // steps a chunk: the scratch's stride and the load-ahead

template <typename T>
__global__ void __launch_bounds__(kThreads)
lru_scan_bwd_kernel(const T* __restrict__ x, const T* __restrict__ a,
                    const T* __restrict__ dy, const float* __restrict__ h0,
                    const float* __restrict__ dhT, T* __restrict__ dx,
                    T* __restrict__ da, float* __restrict__ dh0,
                    float* __restrict__ starts, int S, int D, int64_t x_b,
                    int64_t x_s, int64_t a_b, int64_t a_s, int64_t g_b,
                    int64_t g_s) {
  __shared__ float h_prev[kC][kThreads];
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const int bb = blockIdx.y;
  if (d >= D) return;
  const T* xp = x + bb * x_b + d;
  const T* ap = a + bb * a_b + d;
  const T* gp = dy + bb * g_b + d;
  const int64_t out0 = (int64_t)bb * S * D + d;
  const int n_chunks = (S + kC - 1) / kC;
  float* hs = starts + (int64_t)bb * n_chunks * D + d;
  float* hcol = &h_prev[0][threadIdx.x];

  // forward walk: h at the start of each chunk (every chunk but the last
  // is whole)
  float h = h0 != nullptr ? h0[(int64_t)bb * D + d] : 0.f;
  T xn[kC], an[kC];
  auto load_xa = [&](int t0) {
#pragma unroll
    for (int u = 0; u < kC; ++u) {
      xn[u] = xp[(t0 + u) * x_s];
      an[u] = ap[(t0 + u) * a_s];
    }
  };
  if (n_chunks > 1) load_xa(0);
  for (int c = 0; c + 1 < n_chunks; ++c) {
    T xc[kC], ac[kC];
#pragma unroll
    for (int u = 0; u < kC; ++u) {
      xc[u] = xn[u];
      ac[u] = an[u];
    }
    if (c + 2 < n_chunks) load_xa((c + 1) * kC);
    hs[(int64_t)c * D] = h;
#pragma unroll
    for (int u = 0; u < kC; ++u) h = fmaf(to_f32(ac[u]), h, to_f32(xc[u]));
  }
  hs[(int64_t)(n_chunks - 1) * D] = h;

  // reverse walk, chunk by chunk from the last (which may be ragged: its
  // steps past S load as zeros and store nothing)
  float carry = dhT != nullptr ? dhT[(int64_t)bb * D + d] : 0.f;
  T gn[kC];
  auto load_all = [&](int t0, bool ragged) {
#pragma unroll
    for (int u = 0; u < kC; ++u) {
      const int t = t0 + u;
      const bool in = !ragged || t < S;
      xn[u] = in ? xp[t * x_s] : from_f32<T>(0.f);
      an[u] = in ? ap[t * a_s] : from_f32<T>(0.f);
      gn[u] = in ? gp[t * g_s] : from_f32<T>(0.f);
    }
  };
  load_all((n_chunks - 1) * kC, true);
  for (int c = n_chunks - 1; c >= 0; --c) {
    const int t0 = c * kC;
    T xc[kC], ac[kC], gc[kC];
#pragma unroll
    for (int u = 0; u < kC; ++u) {
      xc[u] = xn[u];
      ac[u] = an[u];
      gc[u] = gn[u];
    }
    if (c > 0) load_all(t0 - kC, false);
    // refill: h_prev[u] = h_{t0+u-1}
    float hh = hs[(int64_t)c * D];
#pragma unroll
    for (int u = 0; u < kC; ++u) {
      hcol[u * kThreads] = hh;
      hh = fmaf(to_f32(ac[u]), hh, to_f32(xc[u]));
    }
    const int n = min(kC, S - t0);
    if (n == kC) {
#pragma unroll
      for (int u = kC - 1; u >= 0; --u) {
        const float g = to_f32(gc[u]) + carry;
        dx[out0 + (int64_t)(t0 + u) * D] = from_f32<T>(g);
        da[out0 + (int64_t)(t0 + u) * D] = from_f32<T>(g * hcol[u * kThreads]);
        carry = to_f32(ac[u]) * g;
      }
    } else {
#pragma unroll
      for (int u = kC - 1; u >= 0; --u) {
        if (u >= n) continue;
        const float g = to_f32(gc[u]) + carry;
        dx[out0 + (int64_t)(t0 + u) * D] = from_f32<T>(g);
        da[out0 + (int64_t)(t0 + u) * D] = from_f32<T>(g * hcol[u * kThreads]);
        carry = to_f32(ac[u]) * g;
      }
    }
  }
  if (dh0 != nullptr) dh0[(int64_t)bb * D + d] = carry;
}

template <typename T>
int launch(const void* x, const void* a, const void* dy, const float* h0,
           const float* dhT, void* dx, void* da, float* dh0, float* starts,
           int batch, int S, int D, const int64_t* st, cudaStream_t stream) {
  dim3 grid((D + kThreads - 1) / kThreads, batch);
  lru_scan_bwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      (const T*)x, (const T*)a, (const T*)dy, h0, dhT, (T*)dx, (T*)da, dh0,
      starts, S, D, st[0], st[1], st[2], st[3], st[4], st[5]);
  return (int)cudaGetLastError();
}

template <typename T>
int attributes_of(int* attrs) {
  cudaFuncAttributes fa;
  const cudaError_t e = cudaFuncGetAttributes(&fa, lru_scan_bwd_kernel<T>);
  if (e != cudaSuccess) return (int)e;
  attrs[0] = fa.numRegs;
  attrs[1] = (int)fa.sharedSizeBytes;
  attrs[2] = 0;
  attrs[3] = (int)fa.localSizeBytes;
  attrs[4] = fa.maxThreadsPerBlock;
  return 0;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, a, dy, dx and da share it).  strides:
// x's batch and sequence strides, then a's, then dy's (unit stride on D for
// all three).  h0, dhT and dh0 (B, D) float32 may each be null (zeros; dh0
// not written); dx and da are contiguous (B, S, D); starts is float32
// scratch of (B, ⌈S / 32⌉, D).  Returns cudaGetLastError() after the
// launch.
extern "C" int lru_scan_bwd_launch(const void* x, const void* a,
                                   const void* dy, const void* h0,
                                   const void* dhT, void* dx, void* da,
                                   void* dh0, void* starts, int dtype,
                                   int batch, int S, int D,
                                   const int64_t* strides, void* stream) {
  if (batch == 0 || D == 0 || S == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(x, a, dy, (const float*)h0, (const float*)dhT, dx,
                         da, (float*)dh0, (float*)starts, batch, S, D,
                         strides, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, a, dy, (const float*)h0,
                                 (const float*)dhT, dx, da, (float*)dh0,
                                 (float*)starts, batch, S, D, strides, s);
  return (int)cudaErrorInvalidValue;
}

// The kernel's build for dtype (0 float32, 1 bfloat16): registers a thread,
// static shared bytes, 0 (no dynamic shared memory), local (spill) bytes a
// thread, max threads a block.
extern "C" int lru_scan_bwd_attributes(int dtype, int* attrs) {
  if (dtype == 0) return attributes_of<float>(attrs);
  if (dtype == 1) return attributes_of<__nv_bfloat16>(attrs);
  return (int)cudaErrorInvalidValue;
}
