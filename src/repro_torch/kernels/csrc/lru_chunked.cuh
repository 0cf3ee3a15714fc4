// The chunked RG-LRU scan shared by B5 (lru_scan.cu) and its backward
// (lru_scan_bwd.cu): the tile geometry, 16-byte row loads and stores, the
// in-order carry between CTAs, and the forward kernel itself (the backward
// launches it to rebuild the chunk-start states when it is not given them).
//
// The sequence is split into chunks of kL steps, the channels into tiles
// of C = kK·V (V channels a thread, one 16-byte vector: 8 bf16 or 4
// float32).  A CTA owns one (batch, chunk, tile); its kJ·kK threads each
// own a sub-chunk of kM steps of V channels, held in registers.  The
// recurrence h_t = a_t·h_{t-1} + x_t is linear, so a sub-chunk is summed
// up exactly by (A = Π a, H = its end state from a zero start), the
// sub-chunks of a chunk are folded in order through shared memory, and the
// chunks of one (batch, tile) — a chain — are joined in order: the start
// state of chunk c is start[c-1]·A[c-1] + H[c-1], computed by chunk c-1's
// CTA and published to chunk c's CTA through a link.  CTAs take chunks by
// an atomic ticket,
// chain index fastest, so a CTA only ever waits on a CTA that already runs
// (no deadlock whatever the scheduler does), and every carry is combined in
// chunk order, never in the order CTAs arrive: two calls give the same
// bits.  Products of a stay in [0, 1] for RG-LRU and are kept as they are
// (no log space; see src/repro/kernels/lru_scan.py:11-14).
//
// The chain buffer (uint64, zeroed by the caller before each launch): [0]
// the ticket counter, then one link a (batch, chunk, channel), the carry
// entering that chunk.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "float_convert.cuh"

namespace {

constexpr int kL = 128;  // steps a chunk (a CTA)
constexpr int kK = 8;    // threads across a tile: 128 bytes of a row

template <typename T>
struct Tile {
  static constexpr int V = 16 / sizeof(T);  // channels a thread
  static constexpr int C = kK * V;          // channels a tile
};

// lane v of a 16-byte vector of T, as float32
template <typename T>
__device__ __forceinline__ float lane(const uint4& r, int v);
template <>
__device__ __forceinline__ float lane<float>(const uint4& r, int v) {
  return __uint_as_float((&r.x)[v]);
}
template <>
__device__ __forceinline__ float lane<__nv_bfloat16>(const uint4& r, int v) {
  const uint32_t w = (&r.x)[v >> 1];
  return __uint_as_float((v & 1) ? (w & 0xffff0000u) : (w << 16));
}

// lane v of a vector set to f rounded to T (round to nearest even)
template <typename T>
__device__ __forceinline__ void set_lane(uint4& r, int v, float f);
template <>
__device__ __forceinline__ void set_lane<float>(uint4& r, int v, float f) {
  (&r.x)[v] = __float_as_uint(f);
}
template <>
__device__ __forceinline__ void set_lane<__nv_bfloat16>(uint4& r, int v,
                                                        float f) {
  const uint32_t b = __bfloat16_as_ushort(__float2bfloat16(f));
  uint32_t& w = (&r.x)[v >> 1];
  w = (v & 1) ? ((w & 0xffffu) | (b << 16)) : ((w & 0xffff0000u) | b);
}

// every lane of a vector at f (exact in T: 0 or 1)
template <typename T>
__device__ __forceinline__ uint4 splat(float f) {
  uint4 r = make_uint4(0, 0, 0, 0);
#pragma unroll
  for (int v = 0; v < Tile<T>::V; ++v) set_lane<T>(r, v, f);
  return r;
}

// V channels of one row from p: one 16-byte load when `vec` (aligned, all
// V in range), else n (< V possible) scalar loads, the rest at `pad`
template <typename T>
__device__ __forceinline__ uint4 load_row(const T* p, bool vec, int n,
                                          float pad) {
  if (vec) return __ldg(reinterpret_cast<const uint4*>(p));
  uint4 r = splat<T>(pad);
#pragma unroll
  for (int v = 0; v < Tile<T>::V; ++v)
    if (v < n) set_lane<T>(r, v, to_f32(p[v]));
  return r;
}

template <typename T>
__device__ __forceinline__ void store_row(T* p, const uint4& r, bool vec,
                                          int n) {
  if (vec) {
    *reinterpret_cast<uint4*>(p) = r;
    return;
  }
#pragma unroll
  for (int v = 0; v < Tile<T>::V; ++v)
    if (v < n) p[v] = from_f32<T>(lane<T>(r, v));
}

// A link carries one channel's float32 carry from a chunk's CTA to the
// next one's in a chain: the value's bits and a nonzero tag in one 64-bit
// word, written and read whole (single-copy atomic), in a buffer zeroed
// before the launch.  The reader spins on its own word until the tag
// shows, and the word holds the value: no flag, fence or second read
// between the two CTAs.
__device__ __forceinline__ void publish(unsigned long long* p, float v) {
  const unsigned long long w = (1ull << 32) | __float_as_uint(v);
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(w)
               : "memory");
}
__device__ __forceinline__ float await(const unsigned long long* p) {
  unsigned long long w;
  do {
    asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];" : "=l"(w) : "l"(p)
                 : "memory");
  } while ((w >> 32) == 0);
  return __uint_as_float((uint32_t)w);
}

// this CTA's (place in its chain, chain, batch, tile), from the ticket
// counter (the chain buffer's first word)
struct Place {
  int step;  // chunks of the chain taken before this one
  int chain, batch, tile;
};
__device__ __forceinline__ Place take_ticket(unsigned long long* chain,
                                             int n_chains, int n_tiles) {
  __shared__ int ticket;
  if (threadIdx.x == 0) ticket = (int)atomicAdd(chain, 1ull);
  __syncthreads();
  Place p;
  p.step = ticket / n_chains;
  p.chain = ticket % n_chains;
  p.batch = p.chain / n_tiles;
  p.tile = p.chain % n_tiles;
  return p;
}

// Whether a tensor's rows can be read or written as 16-byte vectors.
inline bool rows_aligned(const void* p, int64_t stride_b, int64_t stride_s,
                         int V) {
  return (reinterpret_cast<uintptr_t>(p) % 16 == 0) && stride_b % V == 0 &&
         stride_s % V == 0;
}

// ---------------------------------------------------------------- forward --
// y (B, S, D) contiguous in T (null: not written), hT (B, D) float32 (null:
// not written), starts (B, n_chunks, D) float32 (null: not written): the
// state entering each chunk, starts[0] = h0 (zeros when absent); chain: 1
// + B·n_chunks·D words, zeroed.  kM steps a thread, kL / kM threads down a
// chunk.
template <typename T, int kM>
__global__ void __launch_bounds__(kL / kM * kK)
lru_fwd_chunked(const T* __restrict__ x, const T* __restrict__ a,
                const float* __restrict__ h0, T* __restrict__ y,
                float* __restrict__ hT, float* __restrict__ starts,
                unsigned long long* chain, int S, int D, int n_chunks,
                int n_tiles, int64_t x_b, int64_t x_s,
                int64_t a_b, int64_t a_s, bool x_vec, bool a_vec,
                bool y_vec) {
  constexpr int V = Tile<T>::V, C = Tile<T>::C, kJ = kL / kM;
  __shared__ __align__(16) float sA[kJ][C];  // sub-chunk Π a, then prefix
  __shared__ __align__(16) float sH[kJ][C];  // sub-chunk end state, then
                                             // prefix
  __shared__ __align__(16) float sIn[C];     // the chunk's start state
  const int n_chains = gridDim.x / n_chunks;
  const Place p = take_ticket(chain, n_chains, n_tiles);
  const int c = p.step;
  const int tid = threadIdx.x, j = tid / kK, k = tid % kK;
  const int d0 = p.tile * C + k * V;
  const int nv = min(V, D - d0);
  const int t0 = c * kL + j * kM;

  uint4 xr[kM], ar[kM];
  const T* xp = x + p.batch * x_b + d0;
  const T* ap = a + p.batch * a_b + d0;
#pragma unroll
  for (int u = 0; u < kM; ++u) {
    const int t = t0 + u;
    const bool in = t < S && nv > 0;
    xr[u] = in ? load_row(xp + t * x_s, x_vec && nv == V, nv, 0.f)
               : splat<T>(0.f);
    ar[u] = in ? load_row(ap + t * a_s, a_vec && nv == V, nv, 1.f)
               : splat<T>(1.f);
  }
  // the sub-chunk's summary
  float A[V], H[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    A[v] = 1.f;
    H[v] = 0.f;
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
  for (int v = 0; v < V; v += 4) {
    *reinterpret_cast<float4*>(&sA[j][k * V + v]) =
        make_float4(A[v], A[v + 1], A[v + 2], A[v + 3]);
    *reinterpret_cast<float4*>(&sH[j][k * V + v]) =
        make_float4(H[v], H[v + 1], H[v + 2], H[v + 3]);
  }
  __syncthreads();
  // a thread a channel folds the sub-chunks in order: exclusive prefixes
  // in place, the chunk's totals kept
  float a_tot = 1.f, h_tot = 0.f;
  if (tid < C) {
#pragma unroll
    for (int i = 0; i < kJ; ++i) {
      const float ai = sA[i][tid], hi = sH[i][tid];
      sA[i][tid] = a_tot;
      sH[i][tid] = h_tot;
      h_tot = fmaf(ai, h_tot, hi);
      a_tot *= ai;
    }
  }
  // the carry, in chunk order: the link from chunk c - 1, then the one to
  // chunk c + 1
  const int dch = p.tile * C + tid;
  if (tid < C && dch < D) {
    const int64_t bd = (int64_t)p.batch * n_chunks * D + dch;
    unsigned long long* link = chain + 1 + bd;
    const float h_in =
        c == 0 ? (h0 != nullptr ? h0[(int64_t)p.batch * D + dch] : 0.f)
               : await(link + (int64_t)c * D);
    const float h_end = fmaf(a_tot, h_in, h_tot);
    if (c + 1 < n_chunks)
      publish(link + (int64_t)(c + 1) * D, h_end);
    else if (hT != nullptr)
      hT[(int64_t)p.batch * D + dch] = h_end;
    if (starts != nullptr) starts[bd + (int64_t)c * D] = h_in;
    sIn[tid] = h_in;
  }
  __syncthreads();
  if (y == nullptr || nv <= 0) return;

  // the sub-chunk from its true start
  float h[V];
#pragma unroll
  for (int v = 0; v < V; ++v)
    h[v] = fmaf(sA[j][k * V + v], sIn[k * V + v], sH[j][k * V + v]);
  T* yp = y + (int64_t)p.batch * S * D + d0;
#pragma unroll
  for (int u = 0; u < kM; ++u) {
    uint4 out = make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      h[v] = fmaf(lane<T>(ar[u], v), h[v], lane<T>(xr[u], v));
      set_lane<T>(out, v, h[v]);
    }
    if (t0 + u < S)
      store_row(yp + (int64_t)(t0 + u) * D, out, y_vec && nv == V, nv);
  }
}

}  // namespace
