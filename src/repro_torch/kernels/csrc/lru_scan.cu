// The RG-LRU diagonal recurrence (RecurrentGemma / Griffin).
//
// Replaces the TPU kernel src/repro/kernels/lru_scan.py, `lru_scan`
// (`_lru_kernel`), which walks a (batch, channel blocks, chunks) grid in
// order, runs a fori_loop over each chunk vectorised across a 128-lane
// block of channels, and carries the state in VMEM from one chunk to the
// next.  On the card blocks run in no order and carry nothing between
// them, so the carry goes through device memory, in chunk order: the
// chunked scan of lru_chunked.cuh (a CTA a (batch, 128-step chunk, tile of
// 64 bf16 or 32 float32 channels), each chunk's start state passed to the
// next chunk's CTA through a link).
//
// Semantics: h_t = a_t ⊙ h_{t-1} + x_t in float32, h_{-1} = h0 (zeros when
// absent); y_t = h_t written in x's dtype, the final state in float32.
// Under grad it also writes the float32 state entering each chunk (B,
// ⌈S/128⌉, D), which the backward (lru_scan_bwd.cu) starts from.
//
// What bounds it on an H100: bytes.  Each element of x and a is read once
// and each element of y written once (at recurrentgemma-9b's training
// shape, B 2, S 4,096, D 4,096 in bf16: 201 MB, 0.060 ms at 3.35 TB/s; its
// prefill, B 4: 0.120 ms) for one FMA.  A thread holds 8 steps of 8 bf16
// (or 4 float32) channels, all 16 of its 16-byte loads in flight before
// the first FMA; at the training shape that is 4,096 CTAs of 128 threads.
// The carry's serial cost is one hop a chunk along each chain (32 hops at
// S 4,096): one 64-bit link a channel, written by one CTA and spun on by
// the next.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lru_chunked.cuh"

namespace {

constexpr int kFwdM = 8;  // steps a thread

template <typename T>
int launch(const void* x, const void* a, const float* h0, void* y, float* hT,
           float* starts, unsigned long long* chain, int64_t n_chain,
           int batch, int S, int D, const int64_t* st, cudaStream_t stream) {
  constexpr int V = Tile<T>::V;
  const int n_chunks = (S + kL - 1) / kL;
  const int n_tiles = (D + Tile<T>::C - 1) / Tile<T>::C;
  if (n_chain < 1 + (int64_t)batch * n_chunks * D)
    return (int)cudaErrorInvalidValue;
  lru_fwd_chunked<T, kFwdM><<<n_chunks * batch * n_tiles, kL / kFwdM * kK,
                              0, stream>>>(
      (const T*)x, (const T*)a, h0, (T*)y, hT, starts, chain, S, D, n_chunks,
      n_tiles, st[0], st[1], st[2], st[3], rows_aligned(x, st[0], st[1], V),
      rows_aligned(a, st[2], st[3], V), rows_aligned(y, D, D, V));
  return (int)cudaGetLastError();
}

template <typename T>
int attributes_of(int* attrs) {
  cudaFuncAttributes fa;
  const cudaError_t e =
      cudaFuncGetAttributes(&fa, lru_fwd_chunked<T, kFwdM>);
  if (e != cudaSuccess) return (int)e;
  attrs[0] = fa.numRegs;
  attrs[1] = (int)fa.sharedSizeBytes;
  attrs[2] = 0;
  attrs[3] = (int)fa.localSizeBytes;
  attrs[4] = fa.maxThreadsPerBlock;
  return 0;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, a and y share it).  strides: x's batch
// and sequence strides, then a's (unit stride on D for both).  h0 may be
// null (zeros); y is contiguous (B, S, D); hT contiguous (B, D) float32;
// starts contiguous (B, ⌈S / 128⌉, D) float32, or null (not kept); chain:
// n_chain uint64, at least 1 + B·⌈S / 128⌉·D, zeroed.  Returns
// cudaGetLastError() after the launch.
extern "C" int lru_scan_launch(const void* x, const void* a, const void* h0,
                               void* y, void* hT, void* starts, void* chain,
                               int64_t n_chain, int dtype, int batch, int S,
                               int D, const int64_t* strides, void* stream) {
  if (batch == 0 || D == 0 || S == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  auto* ch = (unsigned long long*)chain;
  if (dtype == 0)
    return launch<float>(x, a, (const float*)h0, y, (float*)hT,
                         (float*)starts, ch, n_chain, batch, S, D, strides,
                         s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, a, (const float*)h0, y, (float*)hT,
                                 (float*)starts, ch, n_chain, batch, S, D,
                                 strides, s);
  return (int)cudaErrorInvalidValue;
}

// Steps a chunk (the chunk starts' stride in the sequence).
extern "C" int lru_scan_chunk() { return kL; }

// The kernel's build for dtype: registers a thread, static shared bytes, 0
// (no dynamic shared memory), local (spill) bytes a thread, max threads a
// block.
extern "C" int lru_scan_attributes(int dtype, int* attrs) {
  if (dtype == 0) return attributes_of<float>(attrs);
  if (dtype == 1) return attributes_of<__nv_bfloat16>(attrs);
  return (int)cudaErrorInvalidValue;
}
