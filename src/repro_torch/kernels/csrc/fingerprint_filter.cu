// NetClone response filter (paper §3.5) for a batch of configurations.
//
// Replaces the TPU kernel src/repro/kernels/fingerprint_filter.py,
// `fingerprint_filter` (`_filter_kernel`), which keeps one switch's tables
// resident in VMEM and walks the response lanes with a fori_loop; the
// reference gets its config axis by vmap.  Here the config axis is native.
//
// Semantics are sequential in lane order: for each lane with CLO > 0,
//   slot = (uint32(rid) * 2654435761 mod 2^32) >> 15 mod n_slots;
//   tables[idx][slot] == rid  -> clear the slot, drop the response;
//   otherwise                 -> write rid there, forward the response.
// Two responses of one request in one tick must see each other's writes,
// so the lanes of one config stay sequential; configs run in parallel.
//
// What bounds it on an H100: not bytes.  A launch moves about
// G*K*(16 + 8) B (lanes in, the touched slot read and written, drop out),
// ~150 KB at G = 200, K = 32, which is ~0.05 us at 3.35 TB/s.  The time is
// the launch itself plus K dependent global-memory round trips (each lane
// may read what the lane before wrote).  The design keeps that chain as
// short as it can without changing the semantics: one warp per config
// stages the config's lanes into shared memory with coalesced loads, and
// one thread walks them against the table, which stays in device memory
// and is updated in place (200 configs x 16 KB sit in the 50 MB L2).
// Copying a whole 16 KB table into shared memory per tick would cost far
// more than the <= 32 slots a tick touches.  Fusing this launch into the
// rest of the tick is the real fix; that is the fused-backend slice's work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "filter_common.cuh"

__global__ void fingerprint_filter_kernel(int32_t* __restrict__ tables,
                                          const int32_t* __restrict__ rid,
                                          const int32_t* __restrict__ idx,
                                          const int32_t* __restrict__ clo,
                                          bool* __restrict__ drop,
                                          int n_tables, int n_slots, int k) {
  __shared__ int32_t s_rid[kLaneChunk];
  __shared__ int32_t s_idx[kLaneChunk];
  __shared__ int32_t s_clo[kLaneChunk];
  __shared__ bool s_drop[kLaneChunk];
  const int64_t g = blockIdx.x;
  int32_t* tab = tables + g * (int64_t)n_tables * n_slots;
  const int64_t lane0 = g * (int64_t)k;
  for (int base = 0; base < k; base += kLaneChunk) {
    const int n = min(kLaneChunk, k - base);
    const int t = threadIdx.x;
    if (t < n) {
      s_rid[t] = rid[lane0 + base + t];
      s_idx[t] = idx[lane0 + base + t];
      s_clo[t] = clo[lane0 + base + t];
    }
    __syncthreads();
    if (t == 0) {
      for (int i = 0; i < n; ++i) {
        s_drop[i] = filter_step(tab, n_tables, n_slots, s_rid[i], s_idx[i],
                                s_clo[i]);
      }
    }
    __syncthreads();
    if (t < n) drop[lane0 + base + t] = s_drop[t];
    __syncthreads();
  }
}

extern "C" int fingerprint_filter_launch(void* tables, const void* rid,
                                         const void* idx, const void* clo,
                                         void* drop, int g, int n_tables,
                                         int n_slots, int k, void* stream) {
  if (g == 0 || k == 0) return 0;
  fingerprint_filter_kernel<<<g, kLaneChunk, 0, (cudaStream_t)stream>>>(
      (int32_t*)tables, (const int32_t*)rid, (const int32_t*)idx,
      (const int32_t*)clo, (bool*)drop, n_tables, n_slots, k);
  return (int)cudaGetLastError();
}
