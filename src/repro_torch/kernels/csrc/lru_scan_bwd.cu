// The backward of the RG-LRU diagonal recurrence (B5-bwd).
//
// Replaces no TPU kernel: the reference has no Pallas backward.  Off a TPU
// its training differentiates the XLA `lru_scan_ref` (`ops.lru_scan`
// resolves "auto" to "xla", src/repro/kernels/ops.py:71-77), so this
// computes what `jax.grad` of `repro.kernels.ref.lru_scan_ref` computes.
// For h_t = a_t·h_{t-1} + x_t in float32 from h0 (zeros when absent), y_t
// = h_t in x's dtype and the final state h_{S-1} in float32, with the
// incoming gradients dy and dhT, and q the carry from the right (q = dhT
// after the last step):
//   g_t = dy_t + q_t,  q_{t-1} = a_t·g_t,
//   dx_t = g_t,  da_t = g_t·h_{t-1},  dh0 = a_0·g_0 (the carry left of 0),
// every sum in float32, dx and da written once in the input dtype, dh0 in
// float32.
//
// What bounds it on an H100: bytes.  x, a and dy are read once and dx and
// da written once (at recurrentgemma-9b's training shape, B 2, S 4,096, D
// 4,096 in bf16: 335,544,320 B, 0.100 ms at 3.35 TB/s) for a few flops an
// element.  The design is the forward's (lru_chunked.cuh) run backward: a
// CTA a (batch, 128-step chunk, tile of channels), a thread 4 steps of 8
// bf16 or 4 float32 channels in registers (256 threads a CTA: 8 steps a
// thread held 242 registers and ran at 70% of the bound in bf16, 4 steps
// at 75%), every load 16 bytes.  The
// reverse recurrence is linear in q, so a sub-chunk is summed up by (Π a,
// the carry it passes left from a zero carry), folded in order through
// shared memory, and the chunks of a chain are joined from the last one
// down, each chunk's carry passed to the chunk before it through a link,
// in chunk order (chunks taken by ticket from the last).
//
// da needs the float32 h_{t-1}.  The forward kept the state entering each
// chunk (`starts`, B × ⌈S/128⌉ × D float32, 1 MB at the training shape);
// a CTA folds its sub-chunks' forward summaries from its chunk's start, so
// every thread rebuilds its own h_{t-1} from x and a it already holds: x,
// a and dy are read once.  Without starts (a direct call) the wrapper has
// the forward kernel write them first, in the same call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lru_chunked.cuh"

namespace {

constexpr int kBwdM = 4;  // steps a thread
constexpr int kFwdM = 8;  // the forward's, when it rebuilds the starts

template <typename T, int kM>
__global__ void __launch_bounds__(kL / kM * kK)
lru_bwd_chunked(const T* __restrict__ x, const T* __restrict__ a,
                const T* __restrict__ dy, const float* __restrict__ starts,
                const float* __restrict__ dhT, T* __restrict__ dx,
                T* __restrict__ da, float* __restrict__ dh0,
                unsigned long long* chain, int S, int D, int n_chunks,
                int n_tiles,
                int64_t x_b, int64_t x_s, int64_t a_b, int64_t a_s,
                int64_t g_b, int64_t g_s, bool x_vec, bool a_vec, bool g_vec,
                bool o_vec) {
  constexpr int V = Tile<T>::V, C = Tile<T>::C, kJ = kL / kM;
  __shared__ __align__(16) float sA[kJ][C];  // Π a, then forward prefix
  __shared__ __align__(16) float sH[kJ][C];  // end state, then prefix
  __shared__ __align__(16) float sP[kJ][C];  // Π a right of the sub-chunk
  __shared__ __align__(16) float sG[kJ][C];  // carry passed left, then
                                             // the one entering from the
                                             // right
  __shared__ __align__(16) float sIn[C];     // the chunk's start state
  __shared__ __align__(16) float sQ[C];      // the carry entering it
  const int n_chains = gridDim.x / n_chunks;
  const Place p = take_ticket(chain, n_chains, n_tiles);
  const int c = n_chunks - 1 - p.step;
  const int tid = threadIdx.x, j = tid / kK, k = tid % kK;
  const int d0 = p.tile * C + k * V;
  const int nv = min(V, D - d0);
  const int t0 = c * kL + j * kM;

  uint4 xr[kM], ar[kM], gr[kM];
  const T* xp = x + p.batch * x_b + d0;
  const T* ap = a + p.batch * a_b + d0;
  const T* gp = dy + p.batch * g_b + d0;
#pragma unroll
  for (int u = 0; u < kM; ++u) {
    const int t = t0 + u;
    const bool in = t < S && nv > 0;
    xr[u] = in ? load_row(xp + t * x_s, x_vec && nv == V, nv, 0.f)
               : splat<T>(0.f);
    ar[u] = in ? load_row(ap + t * a_s, a_vec && nv == V, nv, 1.f)
               : splat<T>(1.f);
    gr[u] = in ? load_row(gp + t * g_s, g_vec && nv == V, nv, 0.f)
               : splat<T>(0.f);
  }
  // the sub-chunk's summaries: forward (Π a, end state from zero) and
  // reverse (the carry it passes left from a zero carry)
  float A[V], H[V], G[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    A[v] = 1.f;
    H[v] = 0.f;
    G[v] = 0.f;
  }
#pragma unroll
  for (int u = 0; u < kM; ++u)
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float av = lane<T>(ar[u], v);
      H[v] = fmaf(av, H[v], lane<T>(xr[u], v));
      A[v] *= av;
    }
#pragma unroll
  for (int u = kM - 1; u >= 0; --u)
#pragma unroll
    for (int v = 0; v < V; ++v)
      G[v] = lane<T>(ar[u], v) * (lane<T>(gr[u], v) + G[v]);
#pragma unroll
  for (int v = 0; v < V; v += 4) {
    *reinterpret_cast<float4*>(&sA[j][k * V + v]) =
        make_float4(A[v], A[v + 1], A[v + 2], A[v + 3]);
    *reinterpret_cast<float4*>(&sH[j][k * V + v]) =
        make_float4(H[v], H[v + 1], H[v + 2], H[v + 3]);
    *reinterpret_cast<float4*>(&sG[j][k * V + v]) =
        make_float4(G[v], G[v + 1], G[v + 2], G[v + 3]);
  }
  __syncthreads();
  // a thread a channel folds the sub-chunks: right to left for the carry
  // (exclusive suffixes), left to right for the state (exclusive prefixes)
  const int dch = p.tile * C + tid;
  float p_tot = 1.f, q_tot = 0.f;
  if (tid < C) {
#pragma unroll
    for (int i = kJ - 1; i >= 0; --i) {
      const float ai = sA[i][tid], gi = sG[i][tid];
      sP[i][tid] = p_tot;
      sG[i][tid] = q_tot;
      q_tot = fmaf(ai, q_tot, gi);
      p_tot *= ai;
    }
    float a_pre = 1.f, h_pre = 0.f;
#pragma unroll
    for (int i = 0; i < kJ; ++i) {
      const float ai = sA[i][tid], hi = sH[i][tid];
      sA[i][tid] = a_pre;
      sH[i][tid] = h_pre;
      h_pre = fmaf(ai, h_pre, hi);
      a_pre *= ai;
    }
    if (dch < D)
      sIn[tid] = starts[((int64_t)p.batch * n_chunks + c) * D + dch];
  }
  // the carry, from the last chunk down, in chunk order: the link from
  // chunk c + 1, then the one to chunk c - 1
  if (tid < C && dch < D) {
    unsigned long long* link =
        chain + 1 + (int64_t)p.batch * n_chunks * D + dch;
    const float q_in =
        c == n_chunks - 1
            ? (dhT != nullptr ? dhT[(int64_t)p.batch * D + dch] : 0.f)
            : await(link + (int64_t)c * D);
    const float q_out = fmaf(p_tot, q_in, q_tot);
    if (c > 0)
      publish(link + (int64_t)(c - 1) * D, q_out);
    else if (dh0 != nullptr)
      dh0[(int64_t)p.batch * D + dch] = q_out;
    sQ[tid] = q_in;
  }
  __syncthreads();
  if (nv <= 0) return;

  // the sub-chunk: h_{t-1} forward from its true start, then g backward
  float hp[kM][V], h[V], q[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int cv = k * V + v;
    h[v] = fmaf(sA[j][cv], sIn[cv], sH[j][cv]);
    q[v] = fmaf(sP[j][cv], sQ[cv], sG[j][cv]);
  }
#pragma unroll
  for (int u = 0; u < kM; ++u)
#pragma unroll
    for (int v = 0; v < V; ++v) {
      hp[u][v] = h[v];
      h[v] = fmaf(lane<T>(ar[u], v), h[v], lane<T>(xr[u], v));
    }
  const int64_t o = (int64_t)p.batch * S * D + d0;
#pragma unroll
  for (int u = kM - 1; u >= 0; --u) {
    uint4 gx = make_uint4(0, 0, 0, 0), ga = make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float g = lane<T>(gr[u], v) + q[v];
      set_lane<T>(gx, v, g);
      set_lane<T>(ga, v, g * hp[u][v]);
      q[v] = lane<T>(ar[u], v) * g;
    }
    if (t0 + u < S) {
      const bool vec = o_vec && nv == V;
      store_row(dx + o + (int64_t)(t0 + u) * D, gx, vec, nv);
      store_row(da + o + (int64_t)(t0 + u) * D, ga, vec, nv);
    }
  }
}

template <typename T>
int launch(const void* x, const void* a, const void* dy, const float* h0,
           const float* dhT, const float* starts_in, void* dx, void* da,
           float* dh0, float* starts, unsigned long long* chain,
           int64_t n_chain, int batch, int S, int D, const int64_t* st,
           cudaStream_t stream) {
  constexpr int V = Tile<T>::V;
  const int n_chunks = (S + kL - 1) / kL;
  const int n_tiles = (D + Tile<T>::C - 1) / Tile<T>::C;
  const int n_chains = batch * n_tiles;
  const bool rebuild = starts_in == nullptr;
  const int64_t per_pass = 1 + (int64_t)batch * n_chunks * D;
  if (n_chain < (rebuild ? 2 : 1) * per_pass)
    return (int)cudaErrorInvalidValue;
  const bool x_vec = rows_aligned(x, st[0], st[1], V);
  const bool a_vec = rows_aligned(a, st[2], st[3], V);
  if (rebuild) {
    lru_fwd_chunked<T, kFwdM><<<n_chunks * n_chains, kL / kFwdM * kK, 0,
                                stream>>>(
        (const T*)x, (const T*)a, h0, nullptr, nullptr, starts, chain, S, D,
        n_chunks, n_tiles, st[0], st[1], st[2], st[3], x_vec, a_vec, false);
    const int e = (int)cudaGetLastError();
    if (e) return e;
    chain += per_pass;
    starts_in = starts;
  }
  lru_bwd_chunked<T, kBwdM><<<n_chunks * n_chains, kL / kBwdM * kK, 0,
                              stream>>>(
      (const T*)x, (const T*)a, (const T*)dy, starts_in, dhT, (T*)dx, (T*)da,
      dh0, chain, S, D, n_chunks, n_tiles, st[0], st[1], st[2],
      st[3], st[4], st[5], x_vec, a_vec, rows_aligned(dy, st[4], st[5], V),
      rows_aligned(dx, D, D, V) && rows_aligned(da, D, D, V));
  return (int)cudaGetLastError();
}

template <typename T>
int attributes_of(int* attrs) {
  cudaFuncAttributes fa;
  const cudaError_t e =
      cudaFuncGetAttributes(&fa, lru_bwd_chunked<T, kBwdM>);
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
// not written); dx and da are contiguous (B, S, D).  starts_in: the
// forward's chunk starts (B, ⌈S / 128⌉, D) float32, or null, and then the
// forward kernel first writes them into `starts` (same shape) from x, a
// and h0; chain: n_chain uint64, zeroed, at least 1 + B·⌈S / 128⌉·D,
// twice that without starts_in.  Returns cudaGetLastError() after the
// launches.
extern "C" int lru_scan_bwd_launch(const void* x, const void* a,
                                   const void* dy, const void* h0,
                                   const void* dhT, const void* starts_in,
                                   void* dx, void* da, void* dh0,
                                   void* starts, void* chain, int64_t n_chain,
                                   int dtype, int batch, int S, int D,
                                   const int64_t* strides, void* stream) {
  if (batch == 0 || D == 0 || S == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  auto* ch = (unsigned long long*)chain;
  if (dtype == 0)
    return launch<float>(x, a, dy, (const float*)h0, (const float*)dhT,
                         (const float*)starts_in, dx, da, (float*)dh0,
                         (float*)starts, ch, n_chain, batch, S, D, strides,
                         s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(
        x, a, dy, (const float*)h0, (const float*)dhT,
        (const float*)starts_in, dx, da, (float*)dh0, (float*)starts, ch,
        n_chain, batch, S, D, strides, s);
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
