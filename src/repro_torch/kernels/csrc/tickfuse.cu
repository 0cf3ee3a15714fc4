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
// (filter_common.cuh).  Lane order matters twice: one server often
// completes several jobs in a tick (the last lane's qlen stays), and two
// responses of one request must see each other's table writes.  StateT and
// the tables are separate arrays, so the order between a lane's two writes
// does not matter, only the order within each.
//
// What bounds it on an H100: not bytes.  A launch moves about G*K*(20 + 1)
// B of lanes and drops, 8 B for each distinct table entry and 4 B for each
// distinct server the lanes touch, ~165 KB at G = 200, K = 32: ~0.05 us at
// 3.35 TB/s.  Its floor is the launch itself, a few microseconds.  The first
// design walked each config's lanes in one thread, K dependent L2 round
// trips a launch (8.7 us).  This one resolves a warp's lanes in parallel
// (filter_common.cuh): one warp a config, four configs a CTA; a pass loads
// its 32 lanes with coalesced loads, the highest lane of each server writes
// StateT, and each distinct table entry is read and written once by the
// lowest lane that touches it.  Passes run in order for K > 32, with
// __syncwarp() between them.  Both tables stay in device memory
// (L2-resident at this size) and are updated in place.
//
// Two entry points share the kernel.  tickfuse_launch takes the reference's
// lanes: contiguous int32, inactive lanes already neutralised.
// tickfuse_masked_launch takes the staged engine's lanes as they are (active
// bool, idx and sid int64, rid, clo and qlen int32, each with its own
// strides) and neutralises the inactive lanes itself, as the stage did with
// torch.where and casts before: sid = active ? int32(sid) : n_servers, clo
// = active ? clo : 0, idx = int32(idx).

#include <cuda_runtime.h>
#include <stdint.h>

#include "filter_common.cuh"

namespace {

struct Lane {
  int32_t rid, idx, clo, sid, qlen;
};

// The reference's lanes: (G, K) int32, contiguous, pre-neutralised.
struct PlainLanes {
  const int32_t* rid;
  const int32_t* idx;
  const int32_t* clo;
  const int32_t* sid;
  const int32_t* qlen;
  __device__ Lane load(int64_t g, int i, int k, int) const {
    const int64_t at = g * k + i;
    return {rid[at], idx[at], clo[at], sid[at], qlen[at]};
  }
};

// The staged engine's lanes, read through their strides (in elements):
// row and lane stride of active, rid, idx, clo, sid, qlen, in that order.
struct MaskedLanes {
  const bool* active;
  const int32_t* rid;
  const int64_t* idx;
  const int32_t* clo;
  const int64_t* sid;
  const int32_t* qlen;
  int64_t st[12];
  __device__ int64_t at(int t, int64_t g, int i) const {
    return g * st[2 * t] + (int64_t)i * st[2 * t + 1];
  }
  __device__ Lane load(int64_t g, int i, int, int n_servers) const {
    // every load issued before the mask is applied, so none waits on it
    const bool a = active[at(0, g, i)];
    const int32_t c = clo[at(3, g, i)];
    const int64_t s = sid[at(4, g, i)];
    return {rid[at(1, g, i)], (int32_t)idx[at(2, g, i)], a ? c : 0,
            a ? (int32_t)s : n_servers, qlen[at(5, g, i)]};
  }
};

template <class Lanes>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
tickfuse_kernel(int32_t* __restrict__ server_state,
                int32_t* __restrict__ tables, const Lanes lanes,
                bool* __restrict__ drop, int g_count, int n_servers,
                int n_tables, int n_slots, int k) {
  __shared__ int32_t s_rid[kWarpsPerBlock][kWarp];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int64_t g = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  if (g >= g_count) return;  // the whole warp
  int32_t* tab = tables + g * n_tables * n_slots;
  int32_t* sstate = server_state + g * n_servers;
  for (int base = 0; base < k; base += kWarp) {
    const int i = base + lane;
    const bool live = i < k;
    // lanes past K: clo 0 and an out-of-range sid touch nothing
    const Lane l = live ? lanes.load(g, i, k, n_servers)
                        : Lane{0, 0, 0, n_servers, 0};
    state_pass(sstate, n_servers, l.sid, l.qlen);
    const bool d =
        filter_pass(tab, n_tables, n_slots, l.rid, l.idx, l.clo, s_rid[warp]);
    if (live) drop[g * k + i] = d;
    __syncwarp();  // the next pass sees this pass's stores
  }
}

template <class Lanes>
int launch(void* server_state, void* tables, const Lanes& lanes, void* drop,
           int g, int n_servers, int n_tables, int n_slots, int k,
           void* stream) {
  if (!filter_sizes_ok(g, n_tables, n_slots, k) || n_servers < 0)
    return kBadSizes;
  if (g == 0 || k == 0) return 0;
  tickfuse_kernel<Lanes><<<filter_blocks(g), kWarpsPerBlock * kWarp, 0,
                           (cudaStream_t)stream>>>(
      (int32_t*)server_state, (int32_t*)tables, lanes, (bool*)drop, g,
      n_servers, n_tables, n_slots, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tickfuse_launch(void* server_state, void* tables,
                               const void* rid, const void* idx,
                               const void* clo, const void* sid,
                               const void* qlen, void* drop, int g,
                               int n_servers, int n_tables, int n_slots, int k,
                               void* stream) {
  const PlainLanes lanes{(const int32_t*)rid, (const int32_t*)idx,
                         (const int32_t*)clo, (const int32_t*)sid,
                         (const int32_t*)qlen};
  return launch(server_state, tables, lanes, drop, g, n_servers, n_tables,
                n_slots, k, stream);
}

// `strides`: 12 int64, the row and lane strides of active, rid, idx, clo,
// sid and qlen.
extern "C" int tickfuse_masked_launch(void* server_state, void* tables,
                                      const void* active, const void* rid,
                                      const void* idx, const void* clo,
                                      const void* sid, const void* qlen,
                                      const int64_t* strides, void* drop,
                                      int g, int n_servers, int n_tables,
                                      int n_slots, int k, void* stream) {
  MaskedLanes lanes{(const bool*)active, (const int32_t*)rid,
                    (const int64_t*)idx, (const int32_t*)clo,
                    (const int64_t*)sid, (const int32_t*)qlen, {}};
  for (int t = 0; t < 12; ++t) lanes.st[t] = strides[t];
  return launch(server_state, tables, lanes, drop, g, n_servers, n_tables,
                n_slots, k, stream);
}
