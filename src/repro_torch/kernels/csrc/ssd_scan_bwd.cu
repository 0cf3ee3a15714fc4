// The backward of mamba2's SSD scan (kernel B4), on the CUDA cores.
//
// Replaces no TPU kernel: the reference differentiates its XLA scan
// (src/repro/kernels/ops.py:60-68, jax.grad through ssd_scan_ref).  The
// forward, per head, with H_t in R^{P x N} kept in float32 and a'_t =
// max(a_t, 1e-37) (the clamp of the forward kernels and of the plain
// version's log-decay):
//   H_t = a'_t · H_{t-1} + x_t b_tᵀ,   y_t = H_t c_t,   H_{-1} = h0.
// Its backward, for the incoming dy_t and dH_final (the final state's
// gradient, zero when absent), with G_t the total gradient of H_t:
//   G_{S-1} = dH_final + dy_{S-1} c_{S-1}ᵀ,  G_t = a'_{t+1} G_{t+1} + dy_t c_tᵀ,
//   dx_t = G_t b_t,  db_t = G_tᵀ x_t,  dc_t = H_tᵀ dy_t,
//   da_t = <G_t, H_{t-1}> where a_t >= 1e-37 (else 0: the clamp's own
//   gradient),  dh0 = a'_0 G_0.
// H_{t-1} is never got by inverting the recurrence (a_t may be 0): it is
// recomputed forward from stored states.
//
// Layout.  One CTA owns a (batch, head, block of 32 state columns) and all
// P <= 64 state rows: 8 warps, a warp 8 rows x 32 columns, a thread 4
// rows x 2 columns (lane / 16 picks the row quad, lane % 16 the column
// pair).  Rows past P and columns past N are carried as zeros (their x,
// dy, b and c read as 0), so they add nothing.  Two CTAs share an SM
// (at most 128 registers a thread), so mamba2-370m's training shape (2 x
// 32 heads x 4 column blocks = 256 CTAs) runs in one wave.  b and c are read through
// their strides (the model's broadcast over heads, stride 0, costs no
// copy); db and dc are written per head, and autograd's expand backward
// sums them over the heads.
//
// Two passes over the sequence, kL steps a chunk, each chunk's inputs
// loaded into registers while the chunk before is computed, then staged in
// shared memory as float32 (steps past S read as x = dy = b = c = 0 and
// a = 1, which leave H and G as they are):
// 1. forward: H from h0, the state entering each chunk stored in a float32
//    scratch (the CTA's own slab: nothing crosses CTAs), and dc_t, which
//    needs H_t and dy_t only;
// 2. backward, chunks last to first: the chunk's H_t recomputed from its
//    stored entry state into registers (kL x 8 floats a thread), then the
//    steps in reverse: G, and the partial sums of dx_t (over this CTA's
//    columns), db_t and da_t (over its columns too).
// Sums across lanes go through warp shuffles, across warps through shared
// memory in a fixed order, across column blocks (dx and da) through a
// float32 scratch that a second kernel adds up in column-block order: no
// atomics anywhere, so two calls give the same bits.
//
// A simple kernel first: it is bound by CUDA-core instructions (about 14
// float32 operations an element a step, shuffles besides); the chunked
// (SSD) form on the tensor cores is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "float_convert.cuh"

namespace {

constexpr int kRows = 4;         // state rows a thread
constexpr int kCols = 2;         // state columns a thread
constexpr int kE = kRows * kCols;
constexpr int kWarpRows = 8;     // two row quads a warp
constexpr int kBlockCols = 32;   // sixteen column pairs a warp
constexpr int kMaxP = 64;        // eight warps hold them all
constexpr int kWarps = kMaxP / kWarpRows;
constexpr int kThreads = kWarps * 32;  // whatever P: rows past it are 0
constexpr int kL = 8;            // steps a chunk (between stored states)
constexpr int kXD = kL * kMaxP / kThreads;       // x, dy values a thread stages
constexpr int kBC = kL * kBlockCols / kThreads;  // b, c values a thread stages
static_assert(kXD * kThreads == kL * kMaxP, "x tile");
static_assert(kBC * kThreads == kL * kBlockCols, "b tile");
constexpr float kMinDecay = 1e-37f;

// scratch offsets in floats, rounded up to keep float4 stores aligned
__host__ __device__ constexpr int64_t round4(int64_t n) {
  return (n + 3) / 4 * 4;
}

struct Strides {
  int64_t x_b, x_s, x_h;  // x (B, S, H, P), unit stride on P
  int64_t a_b, a_s, a_h;  // a (B, S, H)
  int64_t b_b, b_s, b_h;  // b (B, S, H, N), unit stride on N
  int64_t c_b, c_s, c_h;  // c (B, S, H, N), unit stride on N
};

struct Smem {
  float x[kL][kMaxP];
  float dy[kL][kMaxP];
  float b[kL][kBlockCols];
  float c[kL][kBlockCols];
  float a[kL];                              // clamped decay, 1 past S
  float col_part[kL][kWarps][kBlockCols];  // dc (pass 1), db (pass 2)
  float dx[kL][kMaxP];                    // this column block's dx_t
  float da[kL][kWarps];
};

// One chunk's inputs in flight: loaded into registers while the chunk
// before is computed, then staged in shared memory as float32.
template <typename T>
struct Staging {
  T x[kXD], dy[kXD], b[kBC], c[kBC], a;

  __device__ __forceinline__ void load(const T* xb, const T* ab,
                                       const T* bb, const T* cb,
                                       const T* dyb, int t0, int S, int P,
                                       int N, int col0, int64_t dy_s,
                                       const Strides& st) {
    const int tid = threadIdx.x;
#pragma unroll
    for (int i = 0; i < kXD; ++i) {
      const int e = tid + i * kThreads, t = t0 + e / kMaxP, p = e % kMaxP;
      const bool ok = t < S && p < P;
      x[i] = ok ? xb[t * st.x_s + p] : from_f32<T>(0.f);
      dy[i] = ok ? dyb[t * dy_s + p] : from_f32<T>(0.f);
    }
#pragma unroll
    for (int i = 0; i < kBC; ++i) {
      const int e = tid + i * kThreads, t = t0 + e / kBlockCols;
      const int n = col0 + e % kBlockCols;
      const bool ok = t < S && n < N;
      b[i] = ok ? bb[t * st.b_s + n] : from_f32<T>(0.f);
      c[i] = ok ? cb[t * st.c_s + n] : from_f32<T>(0.f);
    }
    const int t = t0 + tid;
    a = (tid < kL && t < S) ? ab[t * st.a_s] : from_f32<T>(1.f);
  }

  __device__ __forceinline__ void store(Smem& sm) const {
    const int tid = threadIdx.x;
#pragma unroll
    for (int i = 0; i < kXD; ++i) {
      const int e = tid + i * kThreads;
      sm.x[e / kMaxP][e % kMaxP] = to_f32(x[i]);
      sm.dy[e / kMaxP][e % kMaxP] = to_f32(dy[i]);
    }
#pragma unroll
    for (int i = 0; i < kBC; ++i) {
      const int e = tid + i * kThreads;
      sm.b[e / kBlockCols][e % kBlockCols] = to_f32(b[i]);
      sm.c[e / kBlockCols][e % kBlockCols] = to_f32(c[i]);
    }
    if (tid < kL) sm.a[tid] = fmaxf(to_f32(a), kMinDecay);
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
ssd_scan_bwd_kernel(const T* __restrict__ x, const T* __restrict__ a,
                    const T* __restrict__ bm, const T* __restrict__ cm,
                    const T* __restrict__ dy, const float* __restrict__ h0,
                    const float* __restrict__ dhT, float* __restrict__ dx_part,
                    float* __restrict__ da_part, T* __restrict__ db,
                    T* __restrict__ dc, float* __restrict__ dh0,
                    float* __restrict__ hs, int S, int H, int P, int N,
                    Strides st) {
  __shared__ Smem sm;
  const int tid = threadIdx.x, nt = kThreads;
  const int warp = tid / 32, lane = tid % 32;
  const int cblk = blockIdx.x, ncb = gridDim.x;
  const int hh = blockIdx.y, bb = blockIdx.z;
  const int col0 = cblk * kBlockCols;
  const int row0 = warp * kWarpRows + (lane / 16) * kRows;
  const int cl0 = (lane % 16) * kCols;  // first column within the block
  const int64_t bh = (int64_t)bb * H + hh;
  const int nck = (S + kL - 1) / kL;

  const T* xb = x + bb * st.x_b + hh * st.x_h;
  const T* ab = a + bb * st.a_b + hh * st.a_h;
  const T* bbp = bm + bb * st.b_b + hh * st.b_h;
  const T* cbp = cm + bb * st.c_b + hh * st.c_h;
  // dy, db, dc are contiguous (B, S, H, P or N)
  const int64_t dy_s = (int64_t)H * P;
  const T* dyb = dy + (bb * (int64_t)S * H + hh) * P;
  // this CTA's slab of stored states: [chunk][thread][kE]
  float* slab = hs + ((bh * ncb + cblk) * nck) * (int64_t)nt * kE;

  // element e = i * kCols + j: row row0 + i, column col0 + cl0 + j
  float h[kE];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int row = row0 + i, col = col0 + cl0 + j;
      h[i * kCols + j] = (h0 != nullptr && row < P && col < N)
                             ? h0[(bh * P + row) * N + col]
                             : 0.f;
    }

  // ---- pass 1: forward, storing each chunk's entry state, and dc ----
  Staging<T> next;
  next.load(xb, ab, bbp, cbp, dyb, 0, S, P, N, col0, dy_s, st);
  for (int k = 0; k < nck; ++k) {
    const int t0 = k * kL;
    float4* out = reinterpret_cast<float4*>(slab + ((int64_t)k * nt + tid) *
                                            kE);
    out[0] = make_float4(h[0], h[1], h[2], h[3]);
    out[1] = make_float4(h[4], h[5], h[6], h[7]);
    __syncthreads();  // the previous chunk is done with the buffers
    next.store(sm);
    __syncthreads();
    if (k + 1 < nck)
      next.load(xb, ab, bbp, cbp, dyb, t0 + kL, S, P, N, col0, dy_s, st);
#pragma unroll
    for (int tt = 0; tt < kL; ++tt) {
      const float at = sm.a[tt];
      float s[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[j] = 0.f;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float xr = sm.x[tt][row0 + i], dyr = sm.dy[tt][row0 + i];
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          float& he = h[i * kCols + j];
          he = fmaf(at, he, xr * sm.b[tt][cl0 + j]);
          s[j] = fmaf(he, dyr, s[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        s[j] += __shfl_xor_sync(0xffffffffu, s[j], 16);
        if (lane < 16) sm.col_part[tt][warp][cl0 + j] = s[j];
      }
    }
    __syncthreads();
    const int steps = min(kL, S - t0);
    for (int e = tid; e < steps * kBlockCols; e += nt) {
      const int tt = e / kBlockCols, n = e % kBlockCols;
      if (col0 + n >= N) continue;
      float acc = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) acc += sm.col_part[tt][w][n];
      dc[((bb * (int64_t)S + t0 + tt) * H + hh) * N + col0 + n] =
          from_f32<T>(acc);
    }
  }

  // ---- pass 2: backward, chunks last to first ----
  float g[kE];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int row = row0 + i, col = col0 + cl0 + j;
      g[i * kCols + j] = (dhT != nullptr && row < P && col < N)
                             ? dhT[(bh * P + row) * N + col]
                             : 0.f;
    }
  float a_next = 1.f;  // a'_{t+1}: the step after the last is decay 1
  next.load(xb, ab, bbp, cbp, dyb, (nck - 1) * kL, S, P, N, col0, dy_s, st);
  for (int k = nck - 1; k >= 0; --k) {
    const int t0 = k * kL;
    float hin[kE];
    {
      const float4* in = reinterpret_cast<const float4*>(
          slab + ((int64_t)k * nt + tid) * kE);
      const float4 u = in[0], v = in[1];
      hin[0] = u.x; hin[1] = u.y; hin[2] = u.z; hin[3] = u.w;
      hin[4] = v.x; hin[5] = v.y; hin[6] = v.z; hin[7] = v.w;
    }
    __syncthreads();
    next.store(sm);
    __syncthreads();
    if (k > 0)
      next.load(xb, ab, bbp, cbp, dyb, t0 - kL, S, P, N, col0, dy_s, st);
    // H_t of the chunk's steps, recomputed from the stored entry state
    float hr[kL][kE];
#pragma unroll
    for (int tt = 0; tt < kL; ++tt) {
      const float at = sm.a[tt];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float xr = sm.x[tt][row0 + i];
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int e = i * kCols + j;
          const float prev = tt == 0 ? hin[e] : hr[tt > 0 ? tt - 1 : 0][e];
          hr[tt][e] = fmaf(at, prev, xr * sm.b[tt][cl0 + j]);
        }
      }
    }
#pragma unroll
    for (int tt = kL - 1; tt >= 0; --tt) {
      float dxp[kRows], dbp[kCols], dap = 0.f;
#pragma unroll
      for (int i = 0; i < kRows; ++i) dxp[i] = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) dbp[j] = 0.f;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float dyr = sm.dy[tt][row0 + i], xr = sm.x[tt][row0 + i];
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int e = i * kCols + j;
          g[e] = fmaf(a_next, g[e], dyr * sm.c[tt][cl0 + j]);
          dxp[i] = fmaf(g[e], sm.b[tt][cl0 + j], dxp[i]);
          dbp[j] = fmaf(g[e], xr, dbp[j]);
          const float prev = tt == 0 ? hin[e] : hr[tt > 0 ? tt - 1 : 0][e];
          dap = fmaf(g[e], prev, dap);
        }
      }
      a_next = sm.a[tt];
      // dx: over the 16 column pairs of a row quad
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int m = 1; m < 16; m <<= 1)
          dxp[i] += __shfl_xor_sync(0xffffffffu, dxp[i], m);
      // db: over the two row quads of the warp
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        dbp[j] += __shfl_xor_sync(0xffffffffu, dbp[j], 16);
#pragma unroll
      for (int m = 1; m < 32; m <<= 1)
        dap += __shfl_xor_sync(0xffffffffu, dap, m);
      if (lane % 16 == 0) {
#pragma unroll
        for (int i = 0; i < kRows; ++i) sm.dx[tt][row0 + i] = dxp[i];
      }
      if (lane < 16) {
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          sm.col_part[tt][warp][cl0 + j] = dbp[j];
      }
      if (lane == 0) sm.da[tt][warp] = dap;
    }
    __syncthreads();
    const int steps = min(kL, S - t0);
    for (int e = tid; e < steps * kBlockCols; e += nt) {
      const int tt = e / kBlockCols, n = e % kBlockCols;
      if (col0 + n >= N) continue;
      float acc = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) acc += sm.col_part[tt][w][n];
      db[((bb * (int64_t)S + t0 + tt) * H + hh) * N + col0 + n] =
          from_f32<T>(acc);
    }
    for (int e = tid; e < steps * P; e += nt) {
      const int tt = e / P, p = e % P;
      dx_part[(((cblk * (int64_t)gridDim.z + bb) * S + t0 + tt) * H + hh) *
                  P + p] = sm.dx[tt][p];
    }
    for (int tt = tid; tt < steps; tt += nt) {
      float acc = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) acc += sm.da[tt][w];
      da_part[((cblk * (int64_t)gridDim.z + bb) * S + t0 + tt) * H + hh] =
          acc;
    }
  }

  // dh0 = a'_0 G_0 (a_next now holds a'_0)
  if (dh0 != nullptr) {
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int row = row0 + i, col = col0 + cl0 + j;
        if (row < P && col < N)
          dh0[(bh * P + row) * N + col] = a_next * g[i * kCols + j];
      }
  }
}

// dx and da: the column blocks' partial sums added in block order, and
// da zeroed where the forward clamped the decay.
template <typename T>
__global__ void ssd_scan_bwd_finish(const float* __restrict__ dx_part,
                                    const float* __restrict__ da_part,
                                    const T* __restrict__ a, T* __restrict__ dx,
                                    T* __restrict__ da, int ncb, int64_t n_x,
                                    int64_t n_a, int S, int H, int64_t a_b,
                                    int64_t a_s, int64_t a_h) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i < n_x) {
    float acc = 0.f;
    for (int c = 0; c < ncb; ++c) acc += dx_part[c * n_x + i];
    dx[i] = from_f32<T>(acc);
  }
  if (i < n_a) {
    const int hh = (int)(i % H);
    const int64_t t = (i / H) % S, bb = i / ((int64_t)H * S);
    float acc = 0.f;
    for (int c = 0; c < ncb; ++c) acc += da_part[c * n_a + i];
    const float av = to_f32(a[bb * a_b + t * a_s + hh * a_h]);
    da[i] = from_f32<T>(av >= kMinDecay ? acc : 0.f);
  }
}

template <typename T>
int launch(const void* x, const void* a, const void* b, const void* c,
           const void* dy, const float* h0, const float* dhT, void* dx,
           void* da, void* db, void* dc, float* dh0, float* scratch,
           int batch, int S, int H, int P, int N, const Strides& st,
           cudaStream_t stream) {
  const int ncb = (N + kBlockCols - 1) / kBlockCols;
  const int64_t n_x = (int64_t)batch * S * H * P, n_a = (int64_t)batch * S * H;
  float* dx_part = scratch;
  float* da_part = dx_part + round4(ncb * n_x);
  float* hs = da_part + round4(ncb * n_a);  // float4-aligned
  ssd_scan_bwd_kernel<T><<<dim3(ncb, H, batch), kThreads, 0, stream>>>(
      (const T*)x, (const T*)a, (const T*)b, (const T*)c, (const T*)dy, h0,
      dhT, dx_part, da_part, (T*)db, (T*)dc, dh0, hs, S, H, P, N, st);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int threads = 256;
  const int64_t blocks = (n_x + threads - 1) / threads;
  ssd_scan_bwd_finish<T><<<(unsigned)blocks, threads, 0, stream>>>(
      dx_part, da_part, (const T*)a, (T*)dx, (T*)da, ncb, n_x, n_a, S, H,
      st.a_b, st.a_s, st.a_h);
  return (int)cudaGetLastError();
}

}  // namespace

// Float32 scratch the launch needs, in floats: the column blocks' dx and
// da partial sums and the stored chunk-entry states.
extern "C" int64_t ssd_scan_bwd_scratch(int batch, int S, int H, int P,
                                        int N) {
  const int64_t ncb = (N + kBlockCols - 1) / kBlockCols;
  const int64_t nck = (S + kL - 1) / kL;
  return round4(ncb * (int64_t)batch * S * H * P) +
         round4(ncb * (int64_t)batch * S * H) +
         (int64_t)batch * H * ncb * nck * kThreads * kE;
}

// dtype: 0 float32, 1 bfloat16 (x, a, b, c, dy and the gradients dx, da,
// db, dc share it).  strides: the 12 element strides of x, a, b, c as
// ssd_scan_launch takes them; dy, dx, db, dc are contiguous (B, S, H, P or
// N), da contiguous (B, S, H).  h0, dhT (B, H, P, N) float32 may be null
// (zeros); dh0 (B, H, P, N) float32 may be null (not written).  scratch
// holds ssd_scan_bwd_scratch(...) floats.  P <= 64.  Returns
// cudaGetLastError() after the launches.
extern "C" int ssd_scan_bwd_launch(const void* x, const void* a,
                                   const void* b, const void* c,
                                   const void* dy, const void* h0,
                                   const void* dhT, void* dx, void* da,
                                   void* db, void* dc, void* dh0,
                                   void* scratch, int dtype, int batch, int S,
                                   int H, int P, int N,
                                   const int64_t* strides, void* stream) {
  if (batch == 0 || S == 0 || H == 0 || P == 0 || N == 0) return 0;
  if (P > kMaxP) return (int)cudaErrorInvalidValue;
  Strides st{strides[0], strides[1], strides[2],  strides[3],
             strides[4], strides[5], strides[6],  strides[7],
             strides[8], strides[9], strides[10], strides[11]};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(x, a, b, c, dy, (const float*)h0,
                         (const float*)dhT, dx, da, db, dc, (float*)dh0,
                         (float*)scratch, batch, S, H, P, N, st, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, a, b, c, dy, (const float*)h0,
                                 (const float*)dhT, dx, da, db, dc,
                                 (float*)dh0, (float*)scratch, batch, S, H, P,
                                 N, st, s);
  return (int)cudaErrorInvalidValue;
}

// The main kernel's build (dtype 0 or 1): registers a thread, static
// shared bytes, 0, local (spill) bytes a thread, max threads a block.
extern "C" int ssd_scan_bwd_attributes(int dtype, int* attrs) {
  cudaFuncAttributes fa;
  cudaError_t e = dtype == 0
                      ? cudaFuncGetAttributes(&fa, ssd_scan_bwd_kernel<float>)
                      : cudaFuncGetAttributes(
                            &fa, ssd_scan_bwd_kernel<__nv_bfloat16>);
  if (e != cudaSuccess) return (int)e;
  attrs[0] = fa.numRegs;
  attrs[1] = (int)fa.sharedSizeBytes;
  attrs[2] = 0;
  attrs[3] = (int)fa.localSizeBytes;
  attrs[4] = fa.maxThreadsPerBlock;
  return 0;
}
