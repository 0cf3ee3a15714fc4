// NetClone response filter (paper section 3.5) for a batch of configurations.
//
// Replaces the TPU kernel src/repro/kernels/fingerprint_filter.py,
// `fingerprint_filter` (`_filter_kernel`), which keeps one switch's tables
// resident in VMEM and walks the response lanes with a fori_loop; the
// reference gets its config axis by vmap.  Here the config axis is native.
//
// Semantics are sequential in lane order (filter_common.cuh): two responses
// of one request in one tick must see each other's writes.
//
// What bounds it on an H100: not bytes.  A launch moves about
// G*K*(12 + 1) B of lanes and drops plus 8 B for each distinct table entry
// the lanes touch, ~110 KB at G = 200, K = 32: ~0.03 us at 3.35 TB/s.  Its
// floor is the launch itself, a few microseconds.  The first design walked
// each config's lanes in one thread, K dependent L2 round trips a launch
// (8 us).  This one resolves the lanes of a warp in parallel
// (filter_common.cuh): one warp a config, four configs a CTA, each pass
// loads its 32 lanes with coalesced loads, groups them by the entry they
// touch and reads and writes each entry once, so a pass costs the lanes'
// load, one dependent L2 round trip for the entries, and the stores.  The
// tables stay in device memory and are updated in place (200 configs x 16
// KB sit in the 50 MB L2).  Fusing the launch into the rest of the tick is
// the fused backend's work.
//
// filter_noop_launch takes the same arguments and launches an empty kernel
// on the same grid: the floor of a launch through the same path.

#include <cuda_runtime.h>
#include <stdint.h>

#include "filter_common.cuh"

__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
fingerprint_filter_kernel(int32_t* __restrict__ tables,
                          const int32_t* __restrict__ rid,
                          const int32_t* __restrict__ idx,
                          const int32_t* __restrict__ clo,
                          bool* __restrict__ drop, int g_count, int n_tables,
                          int n_slots, int k) {
  __shared__ int32_t s_rid[kWarpsPerBlock][kWarp];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int64_t g = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  if (g >= g_count) return;  // the whole warp
  int32_t* tab = tables + g * n_tables * n_slots;
  for (int base = 0; base < k; base += kWarp) {
    const int i = base + lane;
    const int64_t at = g * k + i;
    const bool live = i < k;
    const bool d = filter_pass(tab, n_tables, n_slots, live ? rid[at] : 0,
                               live ? idx[at] : 0, live ? clo[at] : 0,
                               s_rid[warp]);
    if (live) drop[at] = d;
    __syncwarp();  // the next pass sees this pass's table stores
  }
}

__global__ void filter_noop_kernel() {}

extern "C" int fingerprint_filter_launch(void* tables, const void* rid,
                                         const void* idx, const void* clo,
                                         void* drop, int g, int n_tables,
                                         int n_slots, int k, void* stream) {
  if (!filter_sizes_ok(g, n_tables, n_slots, k)) return kBadSizes;
  if (g == 0 || k == 0) return 0;
  fingerprint_filter_kernel<<<filter_blocks(g), kWarpsPerBlock * kWarp, 0,
                              (cudaStream_t)stream>>>(
      (int32_t*)tables, (const int32_t*)rid, (const int32_t*)idx,
      (const int32_t*)clo, (bool*)drop, g, n_tables, n_slots, k);
  return (int)cudaGetLastError();
}

extern "C" int filter_noop_launch(void* tables, const void* rid,
                                  const void* idx, const void* clo, void* drop,
                                  int g, int n_tables, int n_slots, int k,
                                  void* stream) {
  if (!filter_sizes_ok(g, n_tables, n_slots, k)) return kBadSizes;
  if (g == 0 || k == 0) return 0;
  filter_noop_kernel<<<filter_blocks(g), kWarpsPerBlock * kWarp, 0,
                       (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
