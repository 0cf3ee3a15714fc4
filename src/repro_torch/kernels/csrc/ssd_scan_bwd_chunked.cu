// The backward of mamba2's SSD scan (kernel B4) in the chunked form, on the
// tensor cores of Hopper: bf16 at head dim P = 64 and state width N = 64 or
// 128 (mamba2-370m's training).  Float32, and bf16 at other widths, keep the
// step kernel of csrc/ssd_scan_bwd.cu (`bwd_kernel_for` in
// kernels/ssd_scan.py routes; nothing falls back on a failure).
//
// Replaces no TPU kernel: the reference differentiates its XLA scan
// (src/repro/kernels/ops.py:60-68, jax.grad through ssd_scan_ref).  The
// forward (csrc/ssd_scan.cu), per head, with a'_t = max(a_t, 1e-37):
//   H_t = a'_t · H_{t-1} + x_t b_tᵀ,   y_t = H_t c_t,   H_{-1} = h0.
// In chunks of L steps, cum the prefix sum of log a' within the chunk,
// M_ts = 2^(cum_t − cum_s)·[s <= t] (cum in log2), w_s = 2^(cum_L − cum_s),
// S = C·Bᵀ, H_prev the state entering the chunk and H_end the one leaving:
//   y = (S⊙M)·X + 2^cum ⊙ (C·H_prevᵀ),  H_end = 2^cum_L·H_prev + (X⊙w)ᵀ·B.
// Its backward, for dY and G = the gradient of H_end (dH_final for the last
// chunk), with dS = dY·Xᵀ:
//   dX = (S⊙M)ᵀ·dY + w ⊙ (B·Gᵀ),   dB = (dS⊙M)ᵀ·C + (X⊙w)·G,
//   dC = (dS⊙M)·B + 2^cum ⊙ (dY·H_prev),
//   the gradient of H_prev = 2^cum_L·G + (dY⊙2^cum)ᵀ·C (G of the chunk
//   before; dh0 for chunk 0),
//   dcum_t = Σ_s Q_ts − Σ_s Q_st + 2^cum_t c_t·(dY·H_prev)_t − r_t
//            + [t = L−1]·(Σ_s r_s + 2^cum_L <G, H_prev>),
//   Q = S⊙M⊙dS, r_s = w_s x_s·(B·Gᵀ)_s,  d log a'_t = Σ_{u >= t} dcum_u,
//   da_t = d log a'_t / a'_t where a_t >= 1e-37, else 0 (the clamp's own
//   gradient, as the step kernel).
//
// What bounds it on an H100.  At mamba2-370m's training shape (x (2, 4096,
// 32, 64), N 128, b and c broadcast over heads, bf16) the backward must
// move 1.1e8 bytes (0.033 ms at 3.35 TB/s) and the chunked form does
// 4.3e10 FLOP at 128-step chunks (0.043 ms at 989 TFLOP/s): only `wgmma`
// reaches that rate.  The step form (csrc/ssd_scan_bwd.cu) runs a 4,096-step
// serial chain twice on the CUDA cores, ~3 ms.  Here the serial part is a
// walk over chunk-boundary states, and the rest is chunk-local and
// parallel: two kernels a call, in order on the stream, joined by the bf16
// H_prev and G of every chunk (the wrapper's scratch, 2 x 64 MiB at the
// training shape), and no atomics anywhere, so two calls give the same bits.
//
// 1. `ssd_bwd_walk_kernel`, one CTA a (direction and 64 state columns,
//    head, batch), 256 CTAs at the training shape: walking forward, H_prev
//    of each chunk from h0, H = 2^cum_L·H + (X⊙w)ᵀ·B; walking backward, G
//    of each chunk from dH_final, G = 2^cum_L·G + (dY⊙2^cum)ᵀ·C, and dh0 at
//    the end.  The state is a float32 `wgmma` accumulator (csrc/ssd_scan.cu's
//    state warpgroup: A = (X⊙w)ᵀ or (dY⊙2^cum)ᵀ from `ldmatrix.trans`,
//    scaled and rounded to bf16 in registers), fed by a TMA ring that a
//    producer warp keeps kStages chunks ahead; each state leaves as a bf16
//    copy (the forward rounds its state's operand copy the same way).
// 2. `ssd_bwd_main_kernel`, one CTA (one warpgroup) a (chunk, head,
//    batch), 4,096 CTAs at the training shape, two a SM: TMA brings X, dY,
//    B, C and then the chunk's H_prev and G (80 KiB at N = 128; b and c
//    described as the (B, S, N) tensor they are, the stride-0 head axis
//    dropped), warp 0 scans log2 max(a, 1e-37) into cum, then `wgmma`
//    chains with bf16 operands and float32 accumulators: Sᵀ = B·Cᵀ and
//    dSᵀ = X·dYᵀ; Q, the mask M applied to the exponent (positive above
//    the diagonal, where 2^· overflows and inf·0 is NaN); dX = (S⊙M)ᵀ·dY +
//    w ⊙ (B·Gᵀ) with (S⊙M)ᵀ rounded to bf16 in registers; dB = (dS⊙M)ᵀ·C +
//    (X⊙w)·G; dC = 2^cum ⊙ (dY·H_prev) + (dS⊙M)·B with dS recomputed
//    row-major (dY·Xᵀ).  Every dcum term is formed in float32 from the
//    accumulators (S⊙M⊙dS before any rounding: the sums behind da cancel),
//    summed per row across a group's lanes by shuffles and across warps
//    through shared memory in a fixed order, then d log a' by a reverse
//    warp scan; <G, H_prev> from the bf16 copies in float32.  da needs
//    nothing across chunks: cum restarts at every chunk, and the states
//    carry the rest.
// Outputs (the bf16 states, dx, db, dc) leave through swizzled staging
// tiles and TMA stores: the accumulators' scattered bf16 pairs stored
// straight to device memory ran at a fraction of the bandwidth (on an H100
// at the training shape the walk took 0.167 ms that way, 0.061 with no
// stores at all, 0.093 through TMA).  Steps past S read
// as x = dy = b = c = 0 (TMA's zero fill) and a = 1, and are not written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "tma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kP = 64;        // head dim P
constexpr int kL = 64;        // steps a chunk
constexpr int kThreads = 128; // one warpgroup: the main kernel's CTA
constexpr uint32_t kTile = kL * kRowBytes;  // 64 rows x 64 bf16, 8 KiB
static_assert(kP == kL, "a state tile has as many rows as a chunk tile");
constexpr float kMinDecay = 1e-37f;

template <int M, int K>
__device__ __forceinline__ void fence_frags(uint32_t (&r)[M][K]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < K; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t v, float lo,
                                                 float hi) {
  const __nv_bfloat162 p = *reinterpret_cast<const __nv_bfloat162*>(&v);
  return pack_bf16(__low2float(p) * lo, __high2float(p) * hi);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  const __nv_bfloat162 p = *reinterpret_cast<const __nv_bfloat162*>(&v);
  return make_float2(__low2float(p), __high2float(p));
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

// The byte offset of the bf16 pair (row, 8j + 2·tig) in a 128-byte-swizzled
// tile of rows x 64 columns, j < 8: the layout TMA writes.
__device__ __forceinline__ uint32_t pair_at(int row, int j, int tig) {
  return row * kRowBytes + ((j ^ (row & 7)) << 4) + tig * 4;
}

// cum (the inclusive prefix sum of log2 max(a, 1e-37) over chunk c) into
// cum[0..kL), by one warp, two steps a lane; a step past S decays by 1.
__device__ __forceinline__ void chunk_cum(float* cum,
                                          const __nv_bfloat16* ap,
                                          int64_t a_ss, int c, int S,
                                          int lane) {
  float l[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int t = c * kL + 2 * lane + e;
    const float v = t < S ? __bfloat162float(ap[t * a_ss]) : 1.f;
    l[e] = log2f(fmaxf(v, kMinDecay));
  }
  float incl = l[0] + l[1];
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  cum[2 * lane] = incl - l[1];
  cum[2 * lane + 1] = incl;
}

// The A fragments of T (L x P, K over the columns p) for this warp's 16 rows
// s, rows row0 and row0 + 8 scaled by w0 and w8 and rounded to bf16: plain
// `ldmatrix` of T [s][p] (matrix i: rows 16·warp + 8·(i & 1) + 0..7, columns
// 16kk + 8·(i >> 1) + 0..7).
__device__ __forceinline__ void row_fragments(uint32_t (&f)[4][4],
                                              uint32_t tile, int warp,
                                              int lane, float w0, float w8) {
#pragma unroll
  for (int kk = 0; kk < kP / 16; ++kk) {
    const int i = lane >> 3;
    const int row = warp * 16 + (i & 1) * 8 + (lane & 7);
    const int chunk16 = 2 * kk + (i >> 1);
    const uint32_t addr = tile + row * kRowBytes + ((chunk16 ^ (row & 7)) << 4);
    uint32_t r[4];
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr)
        : "memory");
    f[kk][0] = scale_bf16x2(r[0], w0, w0);
    f[kk][1] = scale_bf16x2(r[1], w8, w8);
    f[kk][2] = scale_bf16x2(r[2], w0, w0);
    f[kk][3] = scale_bf16x2(r[3], w8, w8);
  }
}

// A 64 x 64 accumulator (the D layout: register 4j + e is row row0 + 8·(e >>
// 1), column 8j + 2·tig + (e & 1)) as A fragments, rounded to bf16: column
// tiles 2kk and 2kk + 1 are K = 16kk..16kk + 15.
__device__ __forceinline__ void acc_fragments(uint32_t (&f)[4][4],
                                              const float (&d)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    f[kk][0] = pack_bf16(d[8 * kk + 0], d[8 * kk + 1]);
    f[kk][1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
    f[kk][2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
    f[kk][3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
  }
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The consumer warpgroup's own barrier (named barrier 1, its 128 threads).
__device__ __forceinline__ void wg_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
}

// Outputs leave through a ring of two swizzled 64 x 64 bf16 staging tiles
// and TMA stores (rows past S not written).  `put` hands columns 64·slab
// .. 64·slab + 63 of an accumulator (register 4j + e is row row0 + 8·(e >>
// 1), column 8j + 2·tig + (e & 1)) to the TMA box at (col, row) of `map`;
// thread 0 of the warpgroup issues the stores.
struct Stager {
  uint32_t tiles;  // two kTile tiles
  int n = 0;       // stores issued

  template <int W>
  __device__ __forceinline__ void put(const float (&d)[W], int slab,
                                      const CUtensorMap* map, int order,
                                      int col, int row, int h, int b, int tid,
                                      int row0, int tig) {
    const uint32_t tile = tiles + (n & 1) * kTile;
    // the store that last read this tile (two puts ago) is done reading
    if (tid == 0)
      asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
    wg_sync();
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int k = 32 * slab + 4 * j + 2 * r;
        const uint32_t val = pack_bf16(d[k], d[k + 1]);
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                         tile + pair_at(row0 + 8 * r, j, tig)),
                     "r"(val)
                     : "memory");
      }
    fence_proxy_async();
    wg_sync();
    if (tid == 0) {
      tma_store(map, order, tile, col, row, h, b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
    ++n;
  }

  // the last stores are done reading shared memory (before the CTA exits)
  __device__ __forceinline__ void drain(int tid) const {
    if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
};

// ------------------------------------------------ 1. the state walks --
// One CTA a (direction and 64 state columns, head, batch): direction 0
// walks the chunks forward from h0 and writes H_prev of each chunk,
// direction 1 walks them backward from dH_final and writes G of each chunk
// (and dh0 at the end), both as bf16 operand copies: H = 2^cum_L·H +
// (X⊙w)ᵀ·B, G = 2^cum_L·G + (dY⊙2^cum)ᵀ·C, chunk after chunk, the state's
// P x 64 block a float32 wgmma accumulator (csrc/ssd_scan.cu's state
// warpgroup).  Warpgroup 1's first warp keeps a ring of kStages chunks full
// with TMA (T = X or dY, R = B or C, one 64-column slab) and writes each
// chunk's cum, its decays loaded kStages chunks ahead; warpgroup 0 runs the
// chain, building the next chunk's fragments while the product runs.  256
// CTAs at the training shape, two a SM.
constexpr int kStages = 4;
constexpr int kWalkThreads = 2 * kThreads;

struct WalkSmem {
  static constexpr uint32_t R = kTile;                    // after T
  static constexpr uint32_t STAGE = 2 * kTile;
  static constexpr uint32_t CUM = kStages * STAGE;  // float [kStages][kL]
  static constexpr uint32_t OUT = CUM + kStages * kL * 4;  // two tiles
  static constexpr uint32_t BARS = OUT + 2 * kTile;
  static constexpr uint32_t TMA_BYTES = 2 * kTile;
  static constexpr int SMEM = BARS + 16 * kStages + 1024;
};

// The A fragments of (T⊙w)ᵀ for a chunk: w_s = 2^(cum_L − cum_s) walking
// forward, 2^cum_s walking backward.
__device__ __forceinline__ void walk_fragments(uint32_t (&f)[4][4],
                                               uint32_t tile,
                                               const float* cum, int dir,
                                               int warp, int lane) {
  const float last = cum[kL - 1];
  const int tig = lane % 4;
#pragma unroll
  for (int kk = 0; kk < kL / 16; ++kk) {
    const int s = 16 * kk + ((lane >> 4) << 3) + (lane & 7);
    const int chunk16 = 2 * warp + ((lane >> 3) & 1);
    const uint32_t addr = tile + s * kRowBytes + ((chunk16 ^ (s & 7)) << 4);
    uint32_t r[4];
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr)
        : "memory");
    const int s0 = 16 * kk + 2 * tig;
    float w[4];
    const int at[4] = {s0, s0 + 1, s0 + 8, s0 + 9};
#pragma unroll
    for (int q = 0; q < 4; ++q)
      w[q] = fast_exp2(dir ? cum[at[q]] : last - cum[at[q]]);
    f[kk][0] = scale_bf16x2(r[0], w[0], w[1]);  // row p, steps s0, s0 + 1
    f[kk][1] = scale_bf16x2(r[1], w[0], w[1]);  // row p + 8
    f[kk][2] = scale_bf16x2(r[2], w[2], w[3]);  // row p, steps s0 + 8, + 9
    f[kk][3] = scale_bf16x2(r[3], w[2], w[3]);  // row p + 8
  }
}

template <int N>
__global__ void __launch_bounds__(kWalkThreads, 2)
    ssd_bwd_walk_kernel(const __grid_constant__ CUtensorMap x_map,
                        const __grid_constant__ CUtensorMap dy_map,
                        const __grid_constant__ CUtensorMap b_map,
                        const __grid_constant__ CUtensorMap c_map,
                        const __grid_constant__ CUtensorMap hp_map,
                        const __grid_constant__ CUtensorMap g_map,
                        int4 orders, int2 state_orders,
                        const __nv_bfloat16* __restrict__ a,
                        int64_t a_sb, int64_t a_ss, int64_t a_sh,
                        const float* __restrict__ h0,
                        const float* __restrict__ dhT,
                        float* __restrict__ dh0, int S, int H) {
  using T = WalkSmem;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  float* const cum_all =
      reinterpret_cast<float*>(smem_raw + (base - raw) + T::CUM);
  const uint32_t bars = base + T::BARS;
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (kStages + st); };
  auto t_s = [&](int st) { return base + st * T::STAGE; };
  auto r_s = [&](int st) { return base + st * T::STAGE + T::R; };
  auto cum = [&](int st) { return cum_all + st * kL; };

  const int dir = blockIdx.x & 1, col0 = (blockIdx.x >> 1) * kSlabCols;
  const int h = blockIdx.y, b = blockIdx.z;
  const int nc = (S + kL - 1) / kL;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full(i), 1 + 32);  // the TMA bytes and 32 lanes' cum
      mbar_init(empty(i), 4);      // one arrival from each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup, made warp-uniform for the compiler: a role branch it
  // cannot prove uniform makes ptxas serialize the wgmmas behind it
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / kThreads, 0);
  const int tid = threadIdx.x % kThreads;
  const int warp = tid / 32, lane = tid % 32;
  const int group = lane / 4, tig = lane % 4;
  const int row0 = warp * 16 + group;  // and row0 + 8
  if (wg == 1) {
    if (warp != 0) return;
    const CUtensorMap* tmap = dir ? &dy_map : &x_map;
    const CUtensorMap* rmap = dir ? &c_map : &b_map;
    const int tord = dir ? orders.y : orders.x;
    const int rord = dir ? orders.w : orders.z;
    const __nv_bfloat16* ap = a + b * a_sb + h * a_sh;
    // the decays of the next kStages chunks in flight, two steps a lane
    float av[kStages][2];
    auto load_a = [&](int i, float (&v)[2]) {
      const int c = dir ? nc - 1 - i : i;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int t = c * kL + 2 * lane + e;
        // a step past S (or a chunk past the walk's end) decays by 1
        v[e] = i < nc && t < S ? __bfloat162float(ap[t * a_ss]) : 1.f;
      }
    };
#pragma unroll
    for (int i = 0; i < kStages; ++i) load_a(i, av[i]);
    for (int i = 0; i < nc; ++i) {
      const int c = dir ? nc - 1 - i : i;
      const int st = i % kStages;
      mbar_wait(empty(st), ((i / kStages) & 1) ^ 1);  // fresh: empty
      if (lane == 0) {
        mbar_expect_tx(full(st), T::TMA_BYTES);
        tma_load(t_s(st), tmap, tord, full(st), 0, c * kL, h, b);
        tma_load(r_s(st), rmap, rord, full(st), col0, c * kL, h, b);
      }
      const float l0 = log2f(fmaxf(av[0][0], kMinDecay));
      const float l1 = log2f(fmaxf(av[0][1], kMinDecay));
      float incl = l0 + l1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += v;
      }
      cum(st)[2 * lane] = incl - l1;
      cum(st)[2 * lane + 1] = incl;
      mbar_arrive(full(st));
#pragma unroll
      for (int k = 0; k + 1 < kStages; ++k) {
        av[k][0] = av[k + 1][0];
        av[k][1] = av[k + 1][1];
      }
      load_a(i + kStages, av[kStages - 1]);
    }
    return;
  }

  // ---- warpgroup 0: the chain ----
  const int64_t bh = (int64_t)b * H + h;
  const float* init = dir ? dhT : h0;
  const CUtensorMap* out_map = dir ? &g_map : &hp_map;
  const int out_order = dir ? state_orders.y : state_orders.x;
  Stager out{base + T::OUT};
  float acc[kSlabCols / 2];
#pragma unroll
  for (int j = 0; j < kSlabCols / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int64_t off =
          (bh * kP + row0 + 8 * r) * N + col0 + 8 * j + 2 * tig;
      const float2 v = init != nullptr
                           ? *reinterpret_cast<const float2*>(init + off)
                           : make_float2(0.f, 0.f);
      acc[4 * j + 2 * r] = v.x;
      acc[4 * j + 2 * r + 1] = v.y;
    }
  uint32_t f[4][4], nf[4][4];
  mbar_wait(full(0), 0);
  walk_fragments(f, t_s(0), cum(0), dir, warp, lane);
  for (int i = 0; i < nc; ++i) {
    const int c = dir ? nc - 1 - i : i;
    const int st = i % kStages;
    // the state entering chunk c (forward), the gradient of the one
    // leaving it (backward), as bf16
    out.put(acc, 0, out_map, out_order, col0, c * kP, h, b, tid, row0, tig);
    const float decay = fast_exp2(cum(st)[kL - 1]);
#pragma unroll
    for (int k = 0; k < kSlabCols / 2; ++k) acc[k] *= decay;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kL / 16; ++kk)
      wgmma_rs_tb<kSlabCols>(acc, f[kk],
                     smem_desc(r_s(st) + kk * 16 * kRowBytes, kTile, 1024),
                     1);
    wgmma_commit();
    const bool more = i + 1 < nc;
    const int st1 = (i + 1) % kStages;
    if (more) {  // the next chunk's fragments, while the product runs
      mbar_wait(full(st1), ((i + 1) / kStages) & 1);
      walk_fragments(nf, t_s(st1), cum(st1), dir, warp, lane);
    }
    wgmma_wait_all();
    fence_regs(acc);
    fence_frags(f);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q) f[kk][q] = nf[kk][q];
  }
  out.drain(tid);
  if (dir == 1 && dh0 != nullptr) {
#pragma unroll
    for (int j = 0; j < kSlabCols / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int64_t off =
            (bh * kP + row0 + 8 * r) * N + col0 + 8 * j + 2 * tig;
        *reinterpret_cast<float2*>(dh0 + off) =
            make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
      }
  }
}

// ---------------------------------------------------- 2. the main kernel --
template <int N>
struct MainSmem {
  static_assert(N == 64 || N == 128, "state width 64 or 128");
  static constexpr int SLABS = N / kSlabCols;
  static constexpr uint32_t X = 0, DY = kTile, B = 2 * kTile;
  static constexpr uint32_t C = B + SLABS * kTile;
  static constexpr uint32_t HP = C + SLABS * kTile;   // H_prev [p][n]
  static constexpr uint32_t G = HP + SLABS * kTile;   // G [p][n]
  static constexpr uint32_t CUM = G + SLABS * kTile;  // float [kL]
  static constexpr uint32_t COLQ = CUM + kL * 4;      // float [4][kL]
  static constexpr uint32_t ROWQ = COLQ + 4 * kL * 4; // float [kL]
  static constexpr uint32_t RR = ROWQ + kL * 4;       // float [kL]
  static constexpr uint32_t INTER = RR + kL * 4;      // float [kL]
  static constexpr uint32_t DOT = INTER + kL * 4;     // float [4]
  static constexpr uint32_t OUT = (DOT + 16 + 1023) / 1024 * 1024;  // 2 tiles
  static constexpr uint32_t BAR = OUT + 2 * kTile;    // the chunk, the states
  static constexpr uint32_t TMA_BYTES = (2 + 2 * SLABS) * kTile;
  static constexpr uint32_t STATE_BYTES = 2 * SLABS * kTile;
  static constexpr int SMEM = BAR + 16 + 1024;
};

template <int N>
__global__ void __launch_bounds__(kThreads, 2)
    ssd_bwd_main_kernel(const __grid_constant__ CUtensorMap x_map,
                        const __grid_constant__ CUtensorMap dy_map,
                        const __grid_constant__ CUtensorMap b_map,
                        const __grid_constant__ CUtensorMap c_map,
                        const __grid_constant__ CUtensorMap hp_map,
                        const __grid_constant__ CUtensorMap g_map,
                        const __grid_constant__ CUtensorMap dx_map,
                        const __grid_constant__ CUtensorMap db_map,
                        const __grid_constant__ CUtensorMap dc_map,
                        int4 orders, int4 out_orders,
                        const __nv_bfloat16* __restrict__ a, int64_t a_sb,
                        int64_t a_ss, int64_t a_sh,
                        __nv_bfloat16* __restrict__ da, int S, int H) {
  using T = MainSmem<N>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  float* const fs = reinterpret_cast<float*>(smem_raw + (base - raw));
  float* const cum = fs + T::CUM / 4;
  float* const colq = fs + T::COLQ / 4;
  float* const rowq_s = fs + T::ROWQ / 4;
  float* const rr_s = fs + T::RR / 4;
  float* const inter_s = fs + T::INTER / 4;
  float* const dot_s = fs + T::DOT / 4;
  const uint32_t bar = base + T::BAR;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int group = lane / 4, tig = lane % 4;
  const int row0 = warp * 16 + group;  // and row0 + 8
  const int t0 = c * kL;
  const __nv_bfloat16* ap = a + b * a_sb + h * a_sh;

  // two barriers: the chunk's tiles, which the first products read, and
  // the states, which arrive while those run
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_init(bar + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, T::TMA_BYTES);
    tma_load(base + T::X, &x_map, orders.x, bar, 0, t0, h, b);
    tma_load(base + T::DY, &dy_map, orders.y, bar, 0, t0, h, b);
#pragma unroll
    for (int j = 0; j < T::SLABS; ++j) {
      tma_load(base + T::B + j * kTile, &b_map, orders.z, bar,
               j * kSlabCols, t0, h, b);
      tma_load(base + T::C + j * kTile, &c_map, orders.w, bar,
               j * kSlabCols, t0, h, b);
    }
    mbar_expect_tx(bar + 8, T::STATE_BYTES);
#pragma unroll
    for (int j = 0; j < T::SLABS; ++j) {
      tma_load(base + T::HP + j * kTile, &hp_map, out_orders.w & 0xffff,
               bar + 8, j * kSlabCols, c * kP, h, b);
      tma_load(base + T::G + j * kTile, &g_map, out_orders.w >> 16,
               bar + 8, j * kSlabCols, c * kP, h, b);
    }
  }
  if (warp == 0) chunk_cum(cum, ap, a_ss, c, S, lane);
  __syncthreads();
  mbar_wait(bar, 0);

  const float last = cum[kL - 1];
  const float cr[2] = {cum[row0], cum[row0 + 8]};
  Stager out{base + T::OUT};

  // ---- Sᵀ = B·Cᵀ and dSᵀ = X·dYᵀ (rows s, columns t) ----
  float st[32], dst[32];
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < T::SLABS; ++j)
#pragma unroll
    for (int kk = 0; kk < kSlabCols / 16; ++kk)
      wgmma_ss<64>(st, smem_desc(base + T::B + j * kTile + kk * 32, 16, 1024),
                   smem_desc(base + T::C + j * kTile + kk * 32, 16, 1024),
                   (j | kk) != 0);
#pragma unroll
  for (int kk = 0; kk < kP / 16; ++kk)
    wgmma_ss<64>(dst, smem_desc(base + T::X + kk * 32, 16, 1024),
                 smem_desc(base + T::DY + kk * 32, 16, 1024), kk != 0);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(st);
  fence_regs(dst);

  // Mᵀ_st = 2^(cum_t − cum_s) for t >= s, the mask applied to the exponent;
  // Qᵀ = Sᵀ⊙Mᵀ⊙dSᵀ from the float32 accumulators, its row sums (Σ_t Q_ts,
  // at s) and its column sums (Σ_s Q_ts, at t)
  float rowq[2] = {0.f, 0.f}, colq_t[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) colq_t[k] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;
    const int col = (i >> 2) * 8 + 2 * tig + (i & 1);
    const float e = col >= row0 + 8 * r ? cum[col] - cr[r] : -INFINITY;
    const float m = fast_exp2(e);
    st[i] *= m;
    const float q = st[i] * dst[i];
    dst[i] *= m;
    rowq[r] += q;
    colq_t[(i >> 2) * 2 + (i & 1)] += q;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rowq[r] += __shfl_xor_sync(0xffffffffu, rowq[r], 1);
    rowq[r] += __shfl_xor_sync(0xffffffffu, rowq[r], 2);
    if (tig == 0) rowq_s[row0 + 8 * r] = rowq[r];
  }
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    colq_t[k] += __shfl_xor_sync(0xffffffffu, colq_t[k], 4);
    colq_t[k] += __shfl_xor_sync(0xffffffffu, colq_t[k], 8);
    colq_t[k] += __shfl_xor_sync(0xffffffffu, colq_t[k], 16);
    if (group == 0) colq[warp * kL + (k >> 1) * 8 + 2 * tig + (k & 1)] =
        colq_t[k];
  }
  uint32_t pf[4][4], dpf[4][4];
  acc_fragments(pf, st);   // (S⊙M)ᵀ
  acc_fragments(dpf, dst); // (dS⊙M)ᵀ

  // ---- dX = (S⊙M)ᵀ·dY + w ⊙ (B·Gᵀ) ----
  const float wr[2] = {fast_exp2(last - cr[0]), fast_exp2(last - cr[1])};
  mbar_wait(bar + 8, 0);
  {
    float acc[32], bg[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kL / 16; ++kk)
      wgmma_rs_tb<64>(acc, pf[kk],
                      smem_desc(base + T::DY + kk * 16 * kRowBytes, kTile,
                                1024),
                      kk != 0);
#pragma unroll
    for (int j = 0; j < T::SLABS; ++j)
#pragma unroll
      for (int kk = 0; kk < kSlabCols / 16; ++kk)
        wgmma_ss<64>(bg,
                     smem_desc(base + T::B + j * kTile + kk * 32, 16, 1024),
                     smem_desc(base + T::G + j * kTile + kk * 32, 16, 1024),
                     (j | kk) != 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    fence_regs(bg);
    fence_frags(pf);
    // r_s = w_s x_s·(B·Gᵀ)_s, and dX takes w ⊙ (B·Gᵀ)
    float rr[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float2 xv =
            unpack_bf16(lds32(base + T::X + pair_at(row0 + 8 * r, j, tig)));
        const float g0 = bg[4 * j + 2 * r], g1 = bg[4 * j + 2 * r + 1];
        rr[r] = fmaf(xv.x, g0, fmaf(xv.y, g1, rr[r]));
        acc[4 * j + 2 * r] = fmaf(wr[r], g0, acc[4 * j + 2 * r]);
        acc[4 * j + 2 * r + 1] = fmaf(wr[r], g1, acc[4 * j + 2 * r + 1]);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rr[r] += __shfl_xor_sync(0xffffffffu, rr[r], 1);
      rr[r] += __shfl_xor_sync(0xffffffffu, rr[r], 2);
      if (tig == 0) rr_s[row0 + 8 * r] = wr[r] * rr[r];
    }
    out.put(acc, 0, &dx_map, out_orders.x, 0, t0, h, b, tid, row0, tig);
  }

  // ---- dB = (dS⊙M)ᵀ·C + (X⊙w)·G: C [t][n] and G [p][n] MN-major ----
  {
    uint32_t xf[4][4];
    row_fragments(xf, base + T::X, warp, lane, wr[0], wr[1]);
    float acc[N / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kL / 16; ++kk)
      wgmma_rs_tb<N>(acc, dpf[kk],
                     smem_desc(base + T::C + kk * 16 * kRowBytes, kTile,
                               1024),
                     kk != 0);
#pragma unroll
    for (int kk = 0; kk < kP / 16; ++kk)
      wgmma_rs_tb<N>(acc, xf[kk],
                     smem_desc(base + T::G + kk * 16 * kRowBytes, kTile,
                               1024),
                     1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    fence_frags(dpf);
    fence_frags(xf);
#pragma unroll
    for (int j = 0; j < T::SLABS; ++j)
      out.put(acc, j, &db_map, out_orders.y, j * kSlabCols, t0, h, b, tid,
              row0, tig);
  }

  // ---- dC = 2^cum ⊙ (dY·H_prev) + (dS⊙M)·B, dS = dY·Xᵀ (rows t) ----
  {
    uint32_t yf[4][4];
    row_fragments(yf, base + T::DY, warp, lane, 1.f, 1.f);
    float acc[N / 2], ds[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kP / 16; ++kk)
      wgmma_rs_tb<N>(acc, yf[kk],
                     smem_desc(base + T::HP + kk * 16 * kRowBytes, kTile,
                               1024),
                     kk != 0);
#pragma unroll
    for (int kk = 0; kk < kP / 16; ++kk)
      wgmma_ss<64>(ds, smem_desc(base + T::DY + kk * 32, 16, 1024),
                   smem_desc(base + T::X + kk * 32, 16, 1024), kk != 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    fence_regs(ds);
    fence_frags(yf);
    // the inter-chunk term and its dcum: 2^cum_t c_t·(dY·H_prev)_t
    const float e2[2] = {fast_exp2(cr[0]), fast_exp2(cr[1])};
    float it[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float2 cv = unpack_bf16(lds32(
            base + T::C + (j / 8) * kTile + pair_at(row0 + 8 * r, j % 8, tig)));
        float& u0 = acc[4 * j + 2 * r];
        float& u1 = acc[4 * j + 2 * r + 1];
        u0 *= e2[r];
        u1 *= e2[r];
        it[r] = fmaf(cv.x, u0, fmaf(cv.y, u1, it[r]));
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      it[r] += __shfl_xor_sync(0xffffffffu, it[r], 1);
      it[r] += __shfl_xor_sync(0xffffffffu, it[r], 2);
      if (tig == 0) inter_s[row0 + 8 * r] = it[r];
    }
    // dS⊙M (M_ts for s <= t) as A fragments, then (dS⊙M)·B on top
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      const int col = (i >> 2) * 8 + 2 * tig + (i & 1);
      const float e = col <= row0 + 8 * r ? cr[r] - cum[col] : -INFINITY;
      ds[i] *= fast_exp2(e);
    }
    uint32_t df[4][4];
    acc_fragments(df, ds);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kL / 16; ++kk)
      wgmma_rs_tb<N>(acc, df[kk],
                     smem_desc(base + T::B + kk * 16 * kRowBytes, kTile,
                               1024),
                     1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    fence_frags(df);
#pragma unroll
    for (int j = 0; j < T::SLABS; ++j)
      out.put(acc, j, &dc_map, out_orders.z, j * kSlabCols, t0, h, b, tid,
              row0, tig);
  }

  // ---- <G, H_prev>: the two tiles share one swizzle, so the sum runs over
  // matching bytes ----
  {
    float dot = 0.f;
#pragma unroll
    for (int k = 0; k < T::SLABS * (int)kTile / 16 / kThreads; ++k) {
      const uint32_t off = (k * kThreads + tid) * 16;
      const uint4 hv = lds128(base + T::HP + off);
      const uint4 gv = lds128(base + T::G + off);
      const uint32_t hw[4] = {hv.x, hv.y, hv.z, hv.w};
      const uint32_t gw[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 hh = unpack_bf16(hw[q]), gg = unpack_bf16(gw[q]);
        dot = fmaf(hh.x, gg.x, fmaf(hh.y, gg.y, dot));
      }
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1)
      dot += __shfl_xor_sync(0xffffffffu, dot, m);
    if (lane == 0) dot_s[warp] = dot;
  }
  __syncthreads();

  // ---- dcum, d log a' (a reverse scan), da ----
  if (warp == 0) {
    float d[2], rsum = 0.f;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int t = 2 * lane + e;
      d[e] = colq[t] + colq[kL + t] + colq[2 * kL + t] + colq[3 * kL + t] -
             rowq_s[t] + inter_s[t] - rr_s[t];
      rsum += rr_s[t];
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1)
      rsum += __shfl_xor_sync(0xffffffffu, rsum, m);
    if (lane == 31)
      d[1] += rsum + fast_exp2(last) *
                         (dot_s[0] + dot_s[1] + dot_s[2] + dot_s[3]);
    float incl = d[0] + d[1];  // the suffix sum from step 2·lane
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_down_sync(0xffffffffu, incl, off);
      if (lane + off < 32) incl += v;
    }
    const float dl[2] = {incl, incl - d[0]};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int t = t0 + 2 * lane + e;
      if (t >= S) continue;
      const float av = __bfloat162float(ap[t * a_ss]);
      da[((int64_t)b * S + t) * H + h] =
          __float2bfloat16(av >= kMinDecay ? dl[e] / av : 0.f);
    }
  }
  out.drain(tid);
}

constexpr int kMaxDevices = 64;

// Both kernels' dynamic shared-memory limits, set on the current device
// the first time an instantiation launches there (cudaFuncSetAttribute
// costs host time on every call).
template <int N>
cudaError_t set_smem_limits() {
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t r = cudaGetDevice(&dev);
  if (r != cudaSuccess) return r;
  const bool cached = dev < kMaxDevices;
  if (cached && done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  r = cudaFuncSetAttribute(ssd_bwd_walk_kernel<N>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           WalkSmem::SMEM);
  if (r == cudaSuccess)
    r = cudaFuncSetAttribute(ssd_bwd_main_kernel<N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             MainSmem<N>::SMEM);
  if (r == cudaSuccess && cached)
    done[dev].store(true, std::memory_order_release);
  return r;
}

template <int N>
int launch(const void* x, const void* a, const void* b, const void* c,
           const void* dy, const float* h0, const float* dhT, void* dx,
           void* da, void* db, void* dc, float* dh0, void* scratch,
           int batch, int S, int H, const int64_t* st, cudaStream_t stream) {
  const int nc = (S + kL - 1) / kL;
  const int64_t n_state = (int64_t)batch * H * nc * kP * N;
  __nv_bfloat16* Hb = reinterpret_cast<__nv_bfloat16*>(scratch);
  __nv_bfloat16* Gb = Hb + n_state;

  CUtensorMap maps[9];
  int orders[9];
  // encode_map takes (batch, head, seq) element strides
  const int64_t xs[3] = {st[0], st[2], st[1]};
  const int64_t bs[3] = {st[6], st[8], st[7]};
  const int64_t cs[3] = {st[9], st[11], st[10]};
  const int64_t dys[3] = {(int64_t)S * H * kP, kP, (int64_t)H * kP};
  const int64_t ss[3] = {(int64_t)H * nc * kP * N, (int64_t)nc * kP * N, N};
  int e = encode_map(&maps[0], &orders[0], x, batch, H, S, kP, xs, kL);
  if (!e) e = encode_map(&maps[1], &orders[1], dy, batch, H, S, kP, dys, kL);
  if (!e) e = encode_map(&maps[2], &orders[2], b, batch, H, S, N, bs, kL);
  if (!e) e = encode_map(&maps[3], &orders[3], c, batch, H, S, N, cs, kL);
  if (!e)
    e = encode_map(&maps[4], &orders[4], Hb, batch, H, nc * kP, N, ss, kP);
  if (!e)
    e = encode_map(&maps[5], &orders[5], Gb, batch, H, nc * kP, N, ss, kP);
  // dx, db, dc: contiguous (B, S, H, P or N)
  const int64_t ns[3] = {(int64_t)S * H * N, N, (int64_t)H * N};
  if (!e) e = encode_map(&maps[6], &orders[6], dx, batch, H, S, kP, dys, kL);
  if (!e) e = encode_map(&maps[7], &orders[7], db, batch, H, S, N, ns, kL);
  if (!e) e = encode_map(&maps[8], &orders[8], dc, batch, H, S, N, ns, kL);
  if (e) return e;
  const int4 ord = make_int4(orders[0], orders[1], orders[2], orders[3]);
  const __nv_bfloat16* ab = (const __nv_bfloat16*)a;

  cudaError_t r = set_smem_limits<N>();
  if (r != cudaSuccess) return (int)r;
  ssd_bwd_walk_kernel<N><<<dim3(2 * (N / kSlabCols), H, batch), kWalkThreads,
                            WalkSmem::SMEM, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], ord,
      make_int2(orders[4], orders[5]), ab, st[3], st[4], st[5], h0, dhT, dh0,
      S, H);
  r = cudaGetLastError();
  if (r != cudaSuccess) return (int)r;

  ssd_bwd_main_kernel<N><<<dim3(nc, H, batch), kThreads, MainSmem<N>::SMEM,
                            stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], maps[6], maps[7],
      maps[8], ord,
      make_int4(orders[6], orders[7], orders[8],
                orders[4] | (orders[5] << 16)),
      ab, st[3], st[4], st[5], (__nv_bfloat16*)da, S, H);
  return (int)cudaGetLastError();
}

}  // namespace

// Scratch the launch needs, in floats: the bf16 H_prev and G of every
// chunk.
extern "C" int64_t ssd_scan_bwd_chunked_scratch(int batch, int S, int H,
                                                int N) {
  const int64_t nc = (S + kL - 1) / kL;
  return (int64_t)batch * H * nc * kP * N;
}

// bf16 only, P = 64, N = 64 or 128.  x, a, b, c are read through their
// element strides (the 12 of ssd_scan_launch: x, a, b, c by batch, seq,
// head; b and c may be broadcast over heads, stride 0; every other stride
// of a dim longer than 1, and the base addresses, multiples of 16 bytes);
// dy, dx, db, dc are contiguous (B, S, H, P or N), da contiguous (B, S, H).
// h0, dhT (B, H, P, N) float32 may be null (zeros); dh0 (B, H, P, N)
// float32 may be null (not written).  scratch holds
// ssd_scan_bwd_chunked_scratch(...) floats, 16-byte aligned.  Returns 0, a
// cudaError_t, or (TMA map encoding) kNoEncoder / kEncodeFailed + CUresult.
extern "C" int ssd_scan_bwd_chunked_launch(
    const void* x, const void* a, const void* b, const void* c,
    const void* dy, const void* h0, const void* dhT, void* dx, void* da,
    void* db, void* dc, void* dh0, void* scratch, int batch, int S, int H,
    int P, int N, const int64_t* strides, void* stream) {
  if (batch == 0 || S == 0 || H == 0) return 0;
  if (P != kP) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (N == 64)
    return launch<64>(x, a, b, c, dy, (const float*)h0, (const float*)dhT,
                      dx, da, db, dc, (float*)dh0, scratch, batch, S, H,
                      strides, s);
  if (N == 128)
    return launch<128>(x, a, b, c, dy, (const float*)h0, (const float*)dhT,
                       dx, da, db, dc, (float*)dh0, scratch, batch, S,
                       H, strides, s);
  return (int)cudaErrorInvalidValue;
}

// The build of kernel `which` (0 the state walks, 1 the main kernel) at
// state width n (64 or 128): attrs gets registers a thread, static shared
// bytes, the dynamic shared bytes it is launched with, local (spill) bytes
// a thread, and max threads a block.
extern "C" int ssd_scan_bwd_chunked_attributes(int which, int n,
                                               int* attrs) {
  cudaFuncAttributes fa;
  cudaError_t e;
  int dyn = 0;
  if (n != 64 && n != 128) return (int)cudaErrorInvalidValue;
  if (which == 0) {
    e = n == 64 ? cudaFuncGetAttributes(&fa, ssd_bwd_walk_kernel<64>)
                : cudaFuncGetAttributes(&fa, ssd_bwd_walk_kernel<128>);
    dyn = WalkSmem::SMEM;
  } else if (which == 1) {
    e = n == 64 ? cudaFuncGetAttributes(&fa, ssd_bwd_main_kernel<64>)
                : cudaFuncGetAttributes(&fa, ssd_bwd_main_kernel<128>);
    dyn = n == 64 ? MainSmem<64>::SMEM : MainSmem<128>::SMEM;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
  attrs[0] = fa.numRegs;
  attrs[1] = (int)fa.sharedSizeBytes;
  attrs[2] = dyn;
  attrs[3] = (int)fa.localSizeBytes;
  attrs[4] = fa.maxThreadsPerBlock;
  return 0;
}
