// The filter step shared by the two switch response-path kernels.
#pragma once

#include <stdint.h>

// Lanes staged per pass: one warp per config.
constexpr int kLaneChunk = 32;

// One lane of the NetClone response filter (paper §3.5) against one
// config's flattened (n_tables, n_slots) table stack.  Returns the drop
// flag.  CLO == 0 lanes never touch the tables; a lane whose idx lies
// outside [0, n_tables) is left alone (the engine never produces one).
__device__ __forceinline__ bool filter_step(int32_t* tab, int n_tables,
                                            int n_slots, int32_t rid,
                                            int32_t idx, int32_t clo) {
  if (clo <= 0 || idx < 0 || idx >= n_tables) return false;
  const uint32_t x = ((uint32_t)rid * 2654435761u) >> 15;
  const int64_t pos = (int64_t)idx * n_slots + (int64_t)(x % (uint32_t)n_slots);
  const bool hit = tab[pos] == rid;
  tab[pos] = hit ? 0 : rid;
  return hit;
}
