// The warp-parallel lane resolution shared by the two switch response-path
// kernels (fingerprint_filter.cu, tickfuse.cu).
//
// The filter, one lane at a time (paper section 3.5): a lane with CLO > 0
// and 0 <= idx < n_tables reads the table entry at filter_pos; if it holds
// the lane's id, the entry is cleared and the response dropped (a hit),
// else the id is written there.  Other lanes touch nothing and are never
// dropped (the engine produces no out-of-range idx).  An id of 0 "hits" an
// empty entry, as the reference's does.  The reference walks a config's
// lanes in that order, one after another.
//
// Here one warp serves one config and takes its lanes 32 at a time, one lane
// a thread.  The lanes of a pass that really depend on each other are those
// that touch one entry: both copies of one request, or two ids whose
// fingerprints collide.  __match_any_sync groups them by that entry, and the
// group's lowest lane walks the group in lane order against one load and
// one store of the entry.  That gives the bits of the sequential walk.
// `emulate_warps` in kernels/fingerprint_filter.py mirrors this code for the
// CPU tests.
#pragma once

#include <stdint.h>

// Lanes a pass takes: one warp per config.
constexpr int kWarp = 32;
constexpr unsigned kFullMask = 0xffffffffu;
// Configs a CTA serves, one warp each.
constexpr int kWarpsPerBlock = 4;

// The flattened (table, slot) entry a lane with this id and table index
// touches: slot = (uint32(rid) * 2654435761 mod 2^32) >> 15 mod n_slots.
__device__ __forceinline__ int64_t filter_pos(int32_t rid, int32_t idx,
                                              int n_slots) {
  const uint32_t x = ((uint32_t)rid * 2654435761u) >> 15;
  return (int64_t)idx * n_slots + (int64_t)(x % (uint32_t)n_slots);
}

// One pass of the filter over a warp's 32 lanes; every lane of the warp
// calls it together (lanes past K with clo = 0) and gets its drop flag.
// `s_rid` is this warp's 32-entry slice of shared memory.
//
// Key: a lane that touches the tables is keyed by its entry's position,
// every other lane by a value no position and no other lane can take
// (positions are below 2^62).  The group's leader loads the entry once,
// walks the members in lane order (hit = entry == rid_j, then entry = hit ?
// 0 : rid_j) and stores the entry once.  Leaders of different entries run
// side by side, so a pass costs one load and one store per distinct entry,
// all in flight together, instead of a chain of 32 dependent round trips.
__device__ __forceinline__ bool filter_pass(int32_t* tab, int n_tables,
                                            int n_slots, int32_t rid,
                                            int32_t idx, int32_t clo,
                                            int32_t* s_rid) {
  const int lane = threadIdx.x & (kWarp - 1);
  const bool touches = clo > 0 && idx >= 0 && idx < n_tables;
  const int64_t pos = touches ? filter_pos(rid, idx, n_slots) : 0;
  const unsigned long long key =
      touches ? (unsigned long long)pos : ~0ull - (unsigned)lane;
  const unsigned group = __match_any_sync(kFullMask, key);
  s_rid[lane] = rid;
  __syncwarp();
  unsigned hits = 0;
  if (touches && lane == __ffs(group) - 1) {
    int32_t entry = tab[pos];
    for (unsigned m = group; m != 0; m &= m - 1) {
      const int j = __ffs(m) - 1;
      const int32_t r = s_rid[j];
      const bool hit = entry == r;
      entry = hit ? 0 : r;
      hits |= (unsigned)hit << j;
    }
    tab[pos] = entry;
  }
  return (__reduce_or_sync(kFullMask, hits) >> lane) & 1u;
}

// One pass of the StateT write over a warp's 32 lanes: StateT[sid] = qlen
// for 0 <= sid < n_servers, the last lane of the pass winning a server.
// Lanes are grouped by sid (an out-of-range sid gets a key of its own, at
// 2^31 and above) and the group's highest lane writes.
__device__ __forceinline__ void state_pass(int32_t* sstate, int n_servers,
                                           int32_t sid, int32_t qlen) {
  const int lane = threadIdx.x & (kWarp - 1);
  const bool writes = sid >= 0 && sid < n_servers;
  const unsigned key = writes ? (unsigned)sid : 0x80000000u + (unsigned)lane;
  const unsigned group = __match_any_sync(kFullMask, key);
  if (writes && lane == 31 - __clz(group)) sstate[sid] = qlen;
}

// The launchers' own check of the sizes they are given (the Python wrappers
// check dtypes, devices, contiguity and the shapes that tie the tensors
// together); a failure returns kBadSizes, which no cudaError_t takes.
constexpr int kBadSizes = -1;

__host__ inline bool filter_sizes_ok(int g, int n_tables, int n_slots, int k) {
  return g >= 0 && k >= 0 && n_tables > 0 && n_slots > 0;
}

__host__ inline int filter_blocks(int g) {
  return (g + kWarpsPerBlock - 1) / kWarpsPerBlock;
}
