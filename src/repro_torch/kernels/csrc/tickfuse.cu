// The fused switch response path: StateT write + fingerprint filter, for a
// batch of configurations.
//
// Replaces the TPU kernel src/repro/kernels/tickfuse.py,
// `tickfuse_response_path` (`_tickfuse_kernel`), which keeps StateT and the
// filter tables of one switch resident in VMEM and walks the response lanes
// with a fori_loop; the reference gets its config axis by vmap.  Here the
// config axis is native.
//
// Per lane, in order: StateT[sid] = qlen when 0 <= sid < n_servers
// (inactive lanes arrive as sid = n_servers, clo = 0), then the filter step
// of fingerprint_filter.cu.  Lane order matters twice: one server often
// completes several jobs in a tick (the last lane's qlen stays), and two
// responses of one request must see each other's table writes.
//
// What bounds it on an H100: launch latency and the chain of K dependent
// global-memory round trips, not bytes.  A launch moves about
// G*K*(24 + 12) B (~230 KB at G = 200, K = 32: lanes in, the touched slot
// read and written, the StateT write, drop out), ~0.07 us at 3.35 TB/s.
// The design is the one of fingerprint_filter.cu: one warp per config
// stages the lanes into shared memory with coalesced loads, one thread
// walks them; both tables stay in device memory (L2-resident at this size)
// and are updated in place.  Fusing the whole tick is the fused-backend
// slice's work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "filter_common.cuh"

__global__ void tickfuse_kernel(int32_t* __restrict__ server_state,
                                int32_t* __restrict__ tables,
                                const int32_t* __restrict__ rid,
                                const int32_t* __restrict__ idx,
                                const int32_t* __restrict__ clo,
                                const int32_t* __restrict__ sid,
                                const int32_t* __restrict__ qlen,
                                bool* __restrict__ drop, int n_servers,
                                int n_tables, int n_slots, int k) {
  __shared__ int32_t s_rid[kLaneChunk];
  __shared__ int32_t s_idx[kLaneChunk];
  __shared__ int32_t s_clo[kLaneChunk];
  __shared__ int32_t s_sid[kLaneChunk];
  __shared__ int32_t s_qlen[kLaneChunk];
  __shared__ bool s_drop[kLaneChunk];
  const int64_t g = blockIdx.x;
  int32_t* tab = tables + g * (int64_t)n_tables * n_slots;
  int32_t* sstate = server_state + g * (int64_t)n_servers;
  const int64_t lane0 = g * (int64_t)k;
  for (int base = 0; base < k; base += kLaneChunk) {
    const int n = min(kLaneChunk, k - base);
    const int t = threadIdx.x;
    if (t < n) {
      s_rid[t] = rid[lane0 + base + t];
      s_idx[t] = idx[lane0 + base + t];
      s_clo[t] = clo[lane0 + base + t];
      s_sid[t] = sid[lane0 + base + t];
      s_qlen[t] = qlen[lane0 + base + t];
    }
    __syncthreads();
    if (t == 0) {
      for (int i = 0; i < n; ++i) {
        const int32_t s = s_sid[i];
        if (s >= 0 && s < n_servers) sstate[s] = s_qlen[i];
        s_drop[i] = filter_step(tab, n_tables, n_slots, s_rid[i], s_idx[i],
                                s_clo[i]);
      }
    }
    __syncthreads();
    if (t < n) drop[lane0 + base + t] = s_drop[t];
    __syncthreads();
  }
}

extern "C" int tickfuse_launch(void* server_state, void* tables,
                               const void* rid, const void* idx,
                               const void* clo, const void* sid,
                               const void* qlen, void* drop, int g,
                               int n_servers, int n_tables, int n_slots, int k,
                               void* stream) {
  if (g == 0 || k == 0) return 0;
  tickfuse_kernel<<<g, kLaneChunk, 0, (cudaStream_t)stream>>>(
      (int32_t*)server_state, (int32_t*)tables, (const int32_t*)rid,
      (const int32_t*)idx, (const int32_t*)clo, (const int32_t*)sid,
      (const int32_t*)qlen, (bool*)drop, n_servers, n_tables, n_slots, k);
  return (int)cudaGetLastError();
}
