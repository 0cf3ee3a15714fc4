// Blocked online-softmax attention (flash attention) for prefill.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py,
// `flash_attention` (`_fa_kernel`), which walks a (batch, q_heads, q_blocks,
// kv_blocks) grid in order on one core and carries the running max m, sum l
// and accumulator acc in VMEM scratch across the kv axis.  Here one CTA owns
// a block of query rows of one (batch, head) and loops over the kv tiles
// itself, keeping m, l and acc in registers; CTAs run in parallel.
//
// Semantics, as `_fa_kernel`:
//   q·kᵀ is scaled by sm_scale; the scores, the online max and sum and acc
//   are float32; masked entries are -1e30; whole kv tiles outside the
//   causal or window band are skipped; l == 0 -> 1 at the end; the output
//   is in q's dtype.  Causal rows are aligned at the start (row i sees
//   columns <= i), so the wrapper takes causal or windowed attention only
//   with Sq == Skv.  GQA reads kv head h / q_per_kv, with no repeat.
//   Columns past Skv (a ragged last tile) are -inf and contribute nothing.
//
// What bounds it on an H100: operations.  Causal prefill at qwen2.5-3b's
// shape (B=4, H=16, S=4096, D=128) does 4·B·H·D per in-band (query, key)
// pair, 2.75e11 FLOP on 151 MB of q, k, v and out: 0.278 ms at 989 TFLOP/s
// against 0.045 ms at 3.35 TB/s.  recurrentgemma-9b's local attention (H=16,
// one kv head, S=4096, D=256, window 2048) does 4.13e11 FLOP: 0.417 ms.
// phi3-mini's causal prefill (B=4, H=32, S=4096, D=96) does 4.12e11 FLOP:
// 0.417 ms too.
// Only the tensor cores reach that rate, and only through `wgmma`.  Two
// kernels, chosen by the wrapper from the inputs:
//
// * `flash_attention_wgmma_kernel` (bf16 at head dims 64, 96, 128 and 256:
//   every prefill of the port) is built for Hopper.  A CTA of three
//   warpgroups owns 128 query rows of one (batch, head).  Warpgroup 2 is
//   the producer: one of its threads loads Q once and keeps a ring of K
//   and V tiles (128 keys, or 64 at D 256; two stages, three at D 96,
//   four at D 64) full with TMA, on full/empty `mbarrier`s, so loads
//   overlap the products.  Warpgroups 0 and 1 each own 64 rows: S = Q·Kᵀ
//   is a `wgmma` with both operands in shared memory, the online softmax
//   runs in registers, and O += P·V is a
//   `wgmma` with P taken from S's accumulators (rounded to bf16, as
//   attention_ref rounds it) and V read MN-major through the transpose-B
//   flag.  `setmaxnreg` moves the producer's registers to the consumers (O
//   is 64 x 256 float32 at D 256, 128 registers a thread).  Tiles are
//   128-byte-swizzled slabs of 64 columns, the layout TMA writes and
//   `wgmma` reads (`Slabs` in tma.cuh).  Head dim 96 (phi3-mini's) is 192
//   bytes a row, no whole number of 128-byte slabs.  Of the two ways
//   round that, padding each row to 128 columns in shared memory (TMA
//   zero-fills columns 96-127) or 64-byte-swizzled slabs of 32 columns,
//   three a row, this takes the second: every operand is then one of
//   `wgmma`'s canonical layouts (P·V reads V MN-major as one n96 product
//   over three whole 32-column atoms, where the padded rows would need 1.5
//   128-byte atoms or an n64 and an n32 product on a part of one), S runs
//   the 6 k16 steps that hold data, and shared memory holds no padding (a
//   third ring stage fits instead).  The cost is a third TMA box a tile.
//   Under grad the epilogue also writes each row's
//   log-sum-exp, which it holds as m and l, for the backward
//   (flash_attention_bwd.cu); inference passes a null pointer and runs the
//   same work.  The tensor cores are kept busy two ways, together
//   measured faster on the card than the kernel without them (PERF.md):
//   within a warpgroup, S of the next tile and P·V of this one are issued
//   together and the softmax runs while P·V does; between the two
//   warpgroups, named barriers hand over the turn to issue products, so
//   one's softmax runs under the other's products.  K and V tiles are
//   released separately, K as soon as S is done.  The mask runs only on
//   the tiles that the band's edge or the last key crosses, and the
//   softmax is exp2 with sm_scale·log2(e) folded into one FMA.  O leaves
//   through shared memory and a TMA store.  The tile schedule is mirrored
//   in Python by `tile_schedule` in kernels/flash_attention.py, which the
//   CPU tests check.
// * `flash_attention_kernel` (float32, and bf16 at head dims 16 and 32,
//   which no path of the port runs): the tiles are staged in shared memory
//   as float32 and every product is a scalar FMA on a 4 x 2 (scores) and
//   4 x D/16 (output) register tile per thread, so it runs on the CUDA
//   cores; float32 inputs need it (the tensor cores would round them), and
//   q is scaled in float32 before the product, as `_fa_kernel` does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "float_convert.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per CTA
constexpr int kBK = 32;        // kv rows per tile
constexpr int kThreads = 256;  // 16 x 16: ty picks rows, tx picks columns
constexpr float kMasked = -1e30f;

// A score after masking: -inf past the last key (it must contribute
// nothing, even to a row with no key yet), -1e30 outside the causal or
// window band (as `_fa_kernel` masks).
__device__ __forceinline__ float mask_score(float s, int row, int col,
                                            int skv, int causal,
                                            int window) {
  if (col >= skv) return -INFINITY;
  bool keep = true;
  if (causal) keep = col <= row;
  if (window >= 0) keep = keep && col >= row - window;
  return keep ? s : kMasked;
}

// ---------------------------------------------------------- scalar FMA ----
template <int D>
constexpr size_t smem_bytes() {
  // q (padded rows), k (padded rows), v, p (padded rows), all float32
  return sizeof(float) *
         (kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           int n_heads, int q_per_kv, int sq, int skv,
                           int64_t q_sb, int64_t q_sh, int64_t q_ss,
                           int64_t k_sb, int64_t k_sh, int64_t k_ss,
                           int64_t v_sb, int64_t v_sh, int64_t v_ss,
                           float sm_scale, int causal, int window) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int DP = D + 1;   // padded row: column reads hit distinct banks
  constexpr int PP = kBK + 1;
  constexpr int NJ = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + kBQ * DP;
  float* v_s = k_s + kBK * DP;
  float* p_s = v_s + kBK * D;

  // the last query blocks do the most causal work: hand them out first
  const int qb = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q_start = qb * kBQ;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  const T* qp = q + b * q_sb + h * q_sh;
  const T* kp = k + b * k_sb + (h / q_per_kv) * k_sh;
  const T* vp = v + b * v_sb + (h / q_per_kv) * v_sh;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int row = q_start + r;
    q_s[r * DP + d] = row < sq ? to_f32(qp[row * q_ss + d]) * sm_scale : 0.f;
  }

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  // the kv tiles inside the band of this query block
  int kb_lo = 0;
  int kb_hi = (skv + kBK - 1) / kBK;
  if (causal) kb_hi = min(kb_hi, (q_start + kBQ - 1) / kBK + 1);
  if (window >= 0 && q_start - window > 0) kb_lo = (q_start - window) / kBK;

  for (int kb = kb_lo; kb < kb_hi; ++kb) {
    const int k_start = kb * kBK;
    __syncthreads();  // q_s written; the last tile's readers are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int c = i / D, d = i % D;
      const int col = k_start + c;
      const bool ok = col < skv;
      k_s[c * DP + d] = ok ? to_f32(kp[col * k_ss + d]) : 0.f;
      v_s[c * D + d] = ok ? to_f32(vp[col * v_ss + d]) : 0.f;
    }
    __syncthreads();

    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float k0 = k_s[tx * DP + d];
      const float k1 = k_s[(tx + 16) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float qv = q_s[(ty + 16 * i) * DP + d];
        s[i][0] = fmaf(qv, k0, s[i][0]);
        s[i][1] = fmaf(qv, k1, s[i][1]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q_start + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 2; ++j)
        s[i][j] = mask_score(s[i][j], row, k_start + tx + 16 * j, skv,
                             causal, window);
      // a row's 32 columns live in the 16 lanes that share ty
      float mc = fmaxf(s[i][0], s[i][1]);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, off));
      const float mn = fmaxf(m[i], mc);
      const float p0 = expf(s[i][0] - mn);
      const float p1 = expf(s[i][1] - mn);
      const float alpha = expf(m[i] - mn);
      float ps = p0 + p1;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[i] = alpha * l[i] + ps;
      m[i] = mn;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
      p_s[(ty + 16 * i) * PP + tx] = p0;
      p_s[(ty + 16 * i) * PP + tx + 16] = p1;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(ty + 16 * i) * PP + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vv = v_s[c * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q_start + ty + 16 * i;
    if (row >= sq) continue;
    const float li = l[i] == 0.f ? 1.f : l[i];
    T* op = out + ((int64_t)(b * n_heads + h) * sq + row) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) op[tx + 16 * j] = from_f32<T>(acc[i][j] / li);
  }
}

// ------------------------------------------------------- TMA + wgmma ----
// Mirrored by `tile_schedule` in kernels/flash_attention.py: keep the two in
// step.
constexpr int kWgRows = 64;                // query rows per consumer warpgroup
constexpr int kCtaRows = 2 * kWgRows;      // query rows per CTA
constexpr int kWgThreads = 128;
constexpr int kWgmmaThreads = 3 * kWgThreads;  // consumers 0, 1; producer 2
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kMaskedLog2 = kMasked * kLog2e;  // -1e30 in log2 units
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

// Shared memory of one CTA at head dim D: Q (128 rows), then a ring of
// STAGES K tiles and STAGES V tiles of BK keys, each stored as `Slabs<D>`
// (D / 64 slabs of rows x 128 bytes, 128-byte swizzled; at D 96 three of
// rows x 64 bytes, 64-byte swizzled); then the mbarriers.
template <int D>
struct WgmmaTile {
  static_assert(D == 64 || D == 96 || D == 128 || D == 256,
                "head dim 64, 96, 128 or 256");
  using S = Slabs<D>;
  static constexpr int BK = D == 256 ? 64 : 128;  // keys per tile
  static constexpr int SLABS = S::COUNT;
  static constexpr int STAGES = D == 64 ? 4 : (D == 96 ? 3 : 2);
  static constexpr uint32_t Q_BYTES = kCtaRows * D * 2;
  static constexpr uint32_t KV_BYTES = BK * D * 2;   // one K or one V tile
  static constexpr uint32_t Q_SLAB = kCtaRows * S::ROW_BYTES;
  static constexpr uint32_t KV_SLAB = BK * S::ROW_BYTES;
  static constexpr int N_BARS = 1 + 4 * STAGES;
  // + 1024: the slabs start on a 1024-byte boundary (the swizzle's period)
  static constexpr int SMEM = Q_BYTES + 2 * STAGES * KV_BYTES + 8 * N_BARS +
                              1024;
};

// The CTA's mbarriers, 8 bytes each: Q full, then K full, V full, K empty
// and V empty for each stage of the ring.
template <int STAGES>
struct Barriers {
  uint32_t base;
  __device__ uint32_t q_full() const { return base; }
  __device__ uint32_t k_full(int st) const { return base + 8 * (1 + st); }
  __device__ uint32_t v_full(int st) const {
    return base + 8 * (1 + STAGES + st);
  }
  __device__ uint32_t k_empty(int st) const {
    return base + 8 * (1 + 2 * STAGES + st);
  }
  __device__ uint32_t v_empty(int st) const {
    return base + 8 * (1 + 3 * STAGES + st);
  }
};

// One consumer warpgroup's view of the CTA's kv tiles; `it` counts tiles
// from the CTA's first, kb = kb_lo + it.  Accumulator layout (wgmma's D
// matrix): warp w of the warpgroup holds rows 16w + group and 16w + group
// + 8 (lane = 4·group + tig); register 4j + e is column 8j + 2·tig + (e & 1)
// of row 16w + group + 8·(e >> 1).
template <int D>
struct Consumer {
  using T = WgmmaTile<D>;
  static constexpr int BK = T::BK;
  Barriers<T::STAGES> bars;
  uint32_t q_wg, k_s, v_s;
  int kb_lo, skv, causal, window, r_lo, row0, tig, lane;
  float scale_log2;

  __device__ int stage(int it) const { return it % T::STAGES; }
  __device__ uint32_t parity(int it) const { return (it / T::STAGES) & 1; }
  __device__ void wait_k(int it) const {
    mbar_wait(bars.k_full(stage(it)), parity(it));
  }
  __device__ void wait_v(int it) const {
    mbar_wait(bars.v_full(stage(it)), parity(it));
  }
  // hand a K or V tile back to the producer (each consumer warp arrives
  // once)
  __device__ void release_k(int it) const {
    __syncwarp();
    if (lane == 0) mbar_arrive(bars.k_empty(stage(it)));
  }
  __device__ void release_v(int it) const {
    __syncwarp();
    if (lane == 0) mbar_arrive(bars.v_empty(stage(it)));
  }
  // a tile this warpgroup does not compute: released once it has landed
  __device__ void pass(int it) const {
    wait_k(it);
    wait_v(it);
    release_k(it);
    release_v(it);
  }

  // Tile kb lies wholly outside the band of the 64 rows from `rows`.
  __device__ bool outside(int kb, int rows) const {
    const int k0 = kb * BK;
    return (causal && k0 > rows + kWgRows - 1) ||
           (window >= 0 && k0 + BK - 1 < rows - window);
  }
  // The tiles [x, y) of the CTA's [kb_lo, kb_hi) that the 64 rows from
  // `rows` compute: the band is contiguous, so the others sit at the ends.
  __device__ int2 own_tiles(int kb_hi, int rows) const {
    int lo = kb_lo, hi = kb_hi;
    while (lo < hi && outside(lo, rows)) ++lo;
    while (hi > lo && outside(hi - 1, rows)) --hi;
    return make_int2(lo, hi);
  }
  // Tile kb lies wholly inside this warpgroup's band and before Skv: it
  // needs no mask.
  __device__ bool inside(int kb) const {
    const int k0 = kb * BK;
    return k0 + BK <= skv && (!causal || k0 + BK - 1 <= r_lo) &&
           (window < 0 || k0 >= r_lo + kWgRows - 1 - window);
  }

  // S = Q·Kᵀ of tile `it` (64 x BK, K-major operands, 16 columns of D a
  // step), one wgmma group
  __device__ void issue_s(float (&s)[BK / 2], int it) const {
    using S = typename T::S;
    const uint32_t k_st = k_s + stage(it) * T::KV_BYTES;
#pragma unroll
    for (int j = 0; j < T::SLABS; ++j) {
#pragma unroll
      for (int kk = 0; kk < S::COLS / 16; ++kk) {
        const uint64_t a = smem_desc(q_wg + j * T::Q_SLAB + kk * 32, 16,
                                     S::ATOM, S::LAYOUT);
        const uint64_t b = smem_desc(k_st + j * T::KV_SLAB + kk * 32, 16,
                                     S::ATOM, S::LAYOUT);
        wgmma_ss<BK>(s, a, b, (j | kk) != 0);
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  }

  // O += P·V of tile `it`: V [key][d] is MN-major for this product; 16
  // keys a step (16 rows into every slab), the next slab's columns one
  // slab on; one wgmma group
  __device__ void issue_pv(float (&o)[D / 2], const uint32_t (&p)[BK / 16][4],
                           int it) const {
    using S = typename T::S;
    const uint32_t v_st = v_s + stage(it) * T::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs_tb<D>(o, p[kk],
                     smem_desc(v_st + kk * 16 * S::ROW_BYTES, T::KV_SLAB,
                               S::ATOM, S::LAYOUT),
                     1);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  }

  // The online softmax of tile kb in log2 units: updates m and l (l a
  // partial sum over this thread's columns), turns s into P and gives each
  // row's rescale factor for O.  A row's BK columns live in a lane quad.
  __device__ void softmax(float (&s)[BK / 2], int kb, float (&m)[2],
                          float (&l)[2], float (&alpha)[2]) const {
    float mx[2] = {m[0], m[1]};
    const bool plain = inside(kb);
    if (plain) {
      float raw[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        raw[(i >> 1) & 1] = fmaxf(raw[(i >> 1) & 1], s[i]);
      mx[0] = fmaxf(mx[0], raw[0] * scale_log2);
      mx[1] = fmaxf(mx[1], raw[1] * scale_log2);
    } else {
      const int k0 = kb * BK;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int r = (i >> 1) & 1;
        const int row = row0 + 8 * r;
        const int col = k0 + (i >> 2) * 8 + 2 * tig + (i & 1);
        float t = s[i] * scale_log2;
        if (col >= skv)
          t = -INFINITY;
        else if ((causal && col > row) || (window >= 0 && col < row - window))
          t = kMaskedLog2;
        s[i] = t;
        mx[r] = fmaxf(mx[r], t);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = fast_exp2(m[r] - mx[r]);
      m[r] = mx[r];
    }
    float ps[2] = {0.f, 0.f};
    if (plain) {
      // sm_scale·log2(e) and the max folded into one FMA
      const float nm[2] = {-m[0], -m[1]};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        s[i] = fast_exp2(fmaf(s[i], scale_log2, nm[(i >> 1) & 1]));
        ps[(i >> 1) & 1] += s[i];
      }
    } else {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        s[i] = fast_exp2(s[i] - m[(i >> 1) & 1]);
        ps[(i >> 1) & 1] += s[i];
      }
    }
    l[0] = alpha[0] * l[0] + ps[0];
    l[1] = alpha[1] * l[1] + ps[1];
  }
};

// O's rows times their softmax rescale factors
template <int D>
__device__ __forceinline__ void rescale(float (&o)[D / 2],
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
}

// P as A fragments of O += P·V: score n-tiles 2kk and 2kk + 1 are keys
// 16kk..16kk + 15, rounded to bf16
template <int BK>
__device__ __forceinline__ void to_a_fragments(const float (&s)[BK / 2],
                                               uint32_t (&p)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    p[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// Named barriers 3 and 4 pass the turn to issue products between the two
// consumer warpgroups: warpgroup w waits on 3 + w, the other arrives there.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(3 + wg), "n"(2 * kWgThreads)
               : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(3 + (1 - wg)),
               "n"(2 * kWgThreads)
               : "memory");
}

// One consumer warpgroup: 64 query rows against the CTA's kv tiles.
// * The products of consecutive tiles overlap the softmax: S of tile i + 1
//   and P·V of tile i are issued together, and the softmax of tile i + 1
//   runs while P·V is still on the tensor cores.  O's rescale for tile i
//   runs while S of tile i + 1 is.
// * The two warpgroups take turns to issue their products (warpgroup 0
//   first), so that one's softmax runs while the other's products are on
//   the tensor cores.  A warpgroup issues in n + 1 rounds for n tiles; the
//   one with fewer pads with empty rounds, so both take as many.
template <int D>
__device__ __forceinline__ void wgmma_consumer(
    int wg, uint32_t q_s, uint32_t k_s, uint32_t v_s,
    Barriers<WgmmaTile<D>::STAGES> bars, const CUtensorMap* o_map,
    int o_order, float* lse, int h, int b, int q0, int kb_lo, int kb_hi,
    int sq, int skv, float scale_log2, int causal, int window) {
  using T = WgmmaTile<D>;
  constexpr int BK = T::BK;
  const int tid = threadIdx.x % kWgThreads;
  const int warp = tid / 32, lane = tid % 32;
  const int group = lane / 4;
  Consumer<D> c;
  c.bars = bars;
  c.q_wg = q_s + wg * kWgRows * T::S::ROW_BYTES;
  c.k_s = k_s;
  c.v_s = v_s;
  c.kb_lo = kb_lo;
  c.skv = skv;
  c.causal = causal;
  c.window = window;
  c.r_lo = q0 + wg * kWgRows;
  c.row0 = c.r_lo + warp * 16 + group;  // and row0 + 8
  c.tig = lane % 4;
  c.lane = lane;
  c.scale_log2 = scale_log2;

  const int2 mine = c.own_tiles(kb_hi, c.r_lo);
  const int2 other = c.own_tiles(kb_hi, q0 + (1 - wg) * kWgRows);
  const int n_mine = mine.y - mine.x, n_other = other.y - other.x;
  for (int kb = kb_lo; kb < mine.x; ++kb) c.pass(kb - kb_lo);

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  // m in log2 units; l a partial sum over this thread's columns, summed
  // over the lane quad once at the end
  float m[2] = {kMaskedLog2, kMaskedLog2}, l[2] = {0.f, 0.f};
  float s[BK / 2], alpha[2];
  uint32_t p[BK / 16][4];
  if (wg == 1) turn_pass(1);
  if (n_mine > 0) {
    mbar_wait(bars.q_full(), 0);
    int it = mine.x - kb_lo;
    c.wait_k(it);
    turn_wait(wg);
    wgmma_fence();
    c.issue_s(s, it);
    turn_pass(wg);
    wgmma_wait_all();
    fence_regs(s);
    c.release_k(it);
    c.softmax(s, mine.x, m, l, alpha);
    to_a_fragments<BK>(s, p);
    for (int kb = mine.x + 1; kb < mine.y; ++kb, ++it) {
      c.wait_k(it + 1);
      turn_wait(wg);
      wgmma_fence();
      c.issue_s(s, it + 1);
      rescale<D>(o, alpha);
      c.wait_v(it);
      wgmma_fence();
      c.issue_pv(o, p, it);
      turn_pass(wg);
      wgmma_wait_all_but_one();  // S
      fence_regs(s);
      c.release_k(it + 1);
      c.softmax(s, kb, m, l, alpha);
      wgmma_wait_all();  // P·V
      fence_regs(o);
      c.release_v(it);
      to_a_fragments<BK>(s, p);
    }
    c.wait_v(it);
    rescale<D>(o, alpha);
    turn_wait(wg);
    wgmma_fence();
    c.issue_pv(o, p, it);
    turn_pass(wg);
    wgmma_wait_all();
    fence_regs(o);
    c.release_v(it);
  }
  for (int r = n_mine ? n_mine + 1 : 0; r < (n_other ? n_other + 1 : 0);
       ++r) {
    turn_wait(wg);
    turn_pass(wg);
  }
  if (wg == 0) turn_wait(0);  // warpgroup 1's last pass
  for (int kb = mine.y; kb < kb_hi; ++kb) c.pass(kb - kb_lo);

  // normalise, stage O as bf16 in this warpgroup's Q rows (its last read
  // of them is done) in the swizzled slab layout, and store it with TMA
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / (l[r] == 0.f ? 1.f : l[r]);
  }
  // under grad: each row's log-sum-exp of its scaled scores, for the
  // backward (m and l are in log2 units)
  if (lse != nullptr && c.tig == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (c.row0 + 8 * r < sq)
        lse[c.row0 + 8 * r] = (m[r] + log2f(l[r])) * kLn2;
  }
  constexpr int CHUNKS = T::S::COLS / 8;  // 16-byte chunks a slab row
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = warp * 16 + group + 8 * r;
      const uint32_t addr = c.q_wg + (j / CHUNKS) * T::Q_SLAB +
                            T::S::at(row, j % CHUNKS) + c.tig * 4;
      const uint32_t val = pack_bf16(o[4 * j + 2 * r] * inv[r],
                                     o[4 * j + 2 * r + 1] * inv[r]);
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(val)
                   : "memory");
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(kWgThreads)
               : "memory");
  if (tid == 0) {
#pragma unroll
    for (int j = 0; j < T::SLABS; ++j)
      tma_store(o_map, o_order, c.q_wg + j * T::Q_SLAB, j * T::S::COLS,
                c.r_lo, h, b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

template <int D>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
    flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                                 const __grid_constant__ CUtensorMap k_map,
                                 const __grid_constant__ CUtensorMap v_map,
                                 const __grid_constant__ CUtensorMap o_map,
                                 float* __restrict__ lse, int4 orders,
                                 int q_per_kv, int sq, int skv,
                                 float scale_log2, int causal, int window) {
  using T = WgmmaTile<D>;
  constexpr int BK = T::BK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t k_s = q_s + T::Q_BYTES;  // stage i at + i · KV_BYTES
  const uint32_t v_s = k_s + T::STAGES * T::KV_BYTES;
  const Barriers<T::STAGES> bars{v_s + T::STAGES * T::KV_BYTES};

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kCtaRows;  // heaviest first
  // the kv tiles inside this CTA's band
  int kb_lo = 0;
  int kb_hi = (skv + BK - 1) / BK;
  if (causal) kb_hi = min(kb_hi, (q0 + kCtaRows - 1) / BK + 1);
  if (window >= 0 && q0 - window > 0) kb_lo = (q0 - window) / BK;

  if (threadIdx.x == 0) {
    mbar_init(bars.q_full(), 1);
#pragma unroll
    for (int i = 0; i < T::STAGES; ++i) {
      mbar_init(bars.k_full(i), 1);
      mbar_init(bars.v_full(i), 1);
      // one arrival from each consumer warp
      mbar_init(bars.k_empty(i), 8);
      mbar_init(bars.v_empty(i), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / kWgThreads;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x != 2 * kWgThreads) return;
    const int hk = h / q_per_kv;
    mbar_expect_tx(bars.q_full(), T::Q_BYTES);
#pragma unroll
    for (int j = 0; j < T::SLABS; ++j)
#pragma unroll
      for (int w = 0; w < 2; ++w)
        tma_load(q_s + j * T::Q_SLAB + w * kWgRows * T::S::ROW_BYTES, &q_map,
                 orders.x, bars.q_full(), j * T::S::COLS, q0 + w * kWgRows,
                 h, b);
    for (int kb = kb_lo, it = 0; kb < kb_hi; ++kb, ++it) {
      const int st = it % T::STAGES;
      const uint32_t ph = (it / T::STAGES) & 1;  // a fresh ring is empty
      mbar_wait(bars.k_empty(st), ph ^ 1);
      mbar_expect_tx(bars.k_full(st), T::KV_BYTES);
#pragma unroll
      for (int j = 0; j < T::SLABS; ++j)
        tma_load(k_s + st * T::KV_BYTES + j * T::KV_SLAB, &k_map, orders.y,
                 bars.k_full(st), j * T::S::COLS, kb * BK, hk, b);
      mbar_wait(bars.v_empty(st), ph ^ 1);
      mbar_expect_tx(bars.v_full(st), T::KV_BYTES);
#pragma unroll
      for (int j = 0; j < T::SLABS; ++j)
        tma_load(v_s + st * T::KV_BYTES + j * T::KV_SLAB, &v_map, orders.z,
                 bars.v_full(st), j * T::S::COLS, kb * BK, hk, b);
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    float* lse_h =
        lse == nullptr ? nullptr : lse + ((int64_t)b * gridDim.x + h) * sq;
    wgmma_consumer<D>(wg, q_s, k_s, v_s, bars, &o_map, orders.w, lse_h, h, b,
                      q0, kb_lo, kb_hi, sq, skv, scale_log2, causal, window);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int batch,
           int n_heads, int n_kv_heads, int sq, int skv, const int64_t* st,
           float sm_scale, int causal, int window, cudaStream_t stream) {
  auto kern = flash_attention_kernel<T, D>;
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((sq + kBQ - 1) / kBQ, n_heads, batch);
  kern<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, n_heads,
      n_heads / n_kv_heads, sq, skv, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], sm_scale, causal, window);
  return (int)cudaGetLastError();
}

// launches of the TMA + wgmma kernel since the library was loaded: the
// route this dispatch took (flash_attention_wgmma_launches reads it)
long long g_wgmma_launches = 0;

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 float* lse, int batch, int n_heads, int n_kv_heads, int sq,
                 int skv,
                 const int64_t* st, float sm_scale, int causal, int window,
                 cudaStream_t stream) {
  using T = WgmmaTile<D>;
  constexpr int RB = T::S::ROW_BYTES;
  CUtensorMap maps[4];
  int orders[4];
  const int64_t out_st[3] = {(int64_t)n_heads * sq * D, (int64_t)sq * D, D};
  int e = encode_map(&maps[0], &orders[0], q, batch, n_heads, sq, D, st,
                     kWgRows, RB);
  if (!e)
    e = encode_map(&maps[1], &orders[1], k, batch, n_kv_heads, skv, D,
                   st + 3, T::BK, RB);
  if (!e)
    e = encode_map(&maps[2], &orders[2], v, batch, n_kv_heads, skv, D,
                   st + 6, T::BK, RB);
  if (!e)
    e = encode_map(&maps[3], &orders[3], out, batch, n_heads, sq, D, out_st,
                   kWgRows, RB);
  if (e) return e;
  auto kern = flash_attention_wgmma_kernel<D>;
  const cudaError_t a = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (a != cudaSuccess) return (int)a;
  const dim3 grid(n_heads, batch, (sq + kCtaRows - 1) / kCtaRows);
  kern<<<grid, kWgmmaThreads, T::SMEM, stream>>>(
      maps[0], maps[1], maps[2], maps[3], lse,
      make_int4(orders[0], orders[1], orders[2], orders[3]),
      n_heads / n_kv_heads, sq, skv, sm_scale * kLog2e, causal, window);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++g_wgmma_launches;
  return (int)err;
}

template <typename T>
int launch_dim(int d, const void* q, const void* k, const void* v, void* out,
               int batch, int n_heads, int n_kv_heads, int sq, int skv,
               const int64_t* st, float sm_scale, int causal, int window,
               cudaStream_t s) {
#define FA_CASE(DIM)                                                        \
  case DIM:                                                                 \
    return launch<T, DIM>(q, k, v, out, batch, n_heads, n_kv_heads, sq, skv, \
                          st, sm_scale, causal, window, s);
  switch (d) {
    FA_CASE(16)
    FA_CASE(32)
    default:
      break;
  }
  if constexpr (std::is_same<T, float>::value) {  // bf16 here: TMA + wgmma
    switch (d) {
      FA_CASE(64)
      FA_CASE(96)
      FA_CASE(128)
      FA_CASE(256)
      default:
        break;
    }
  }
  return (int)cudaErrorInvalidValue;
#undef FA_CASE
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  strides: q, k, v each (batch, head, seq),
// in elements; the head-dim stride is 1.  window < 0: no window.  bf16 at
// head dim 64, 96, 128 or 256 takes the TMA + wgmma kernel, which needs the
// base addresses of q, k and v and their strides in multiples of 16 bytes,
// and no stride 0 on a dim longer than 1 (the wrapper sees to it).  lse:
// null, or (B, H, Sq) float32 that the TMA + wgmma kernel fills with each
// row's log-sum-exp of its scaled scores (for the backward); the scalar
// kernel takes null only.  Returns 0, a cudaError_t, or (TMA map encoding)
// kNoEncoder / kEncodeFailed + CUresult.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      int dtype,
                                      int batch, int n_heads, int n_kv_heads,
                                      int sq, int skv, int d,
                                      const int64_t* strides, float sm_scale,
                                      int causal, int window, void* stream) {
  if (batch == 0 || n_heads == 0 || sq == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const bool wgmma =
      dtype == 1 && (d == 64 || d == 96 || d == 128 || d == 256);
  if (lse != nullptr && !wgmma) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_dim<float>(d, q, k, v, out, batch, n_heads, n_kv_heads, sq,
                             skv, strides, sm_scale, causal, window, s);
#define FA_WGMMA(DIM)                                                       \
  if (dtype == 1 && d == DIM)                                               \
    return launch_wgmma<DIM>(q, k, v, out, (float*)lse, batch, n_heads,    \
                             n_kv_heads, sq, skv, strides, sm_scale,       \
                             causal, window, s);
  FA_WGMMA(64)
  FA_WGMMA(96)
  FA_WGMMA(128)
  FA_WGMMA(256)
#undef FA_WGMMA
  if (dtype == 1)
    return launch_dim<__nv_bfloat16>(d, q, k, v, out, batch, n_heads,
                                     n_kv_heads, sq, skv, strides, sm_scale,
                                     causal, window, s);
  return (int)cudaErrorInvalidValue;
}

// Launches of the TMA + wgmma kernel since the library was loaded.
extern "C" long long flash_attention_wgmma_launches() {
  return g_wgmma_launches;
}

// The TMA + wgmma kernel's build at head dim d (64, 96, 128 or 256): attrs
// gets registers a thread, static shared bytes, the dynamic shared bytes it
// is launched with, local (spill) bytes a thread, and max threads a block.
extern "C" int flash_attention_wgmma_attributes(int d, int* attrs) {
  cudaFuncAttributes fa;
  cudaError_t e;
  int dyn;
  if (d == 64) {
    e = cudaFuncGetAttributes(&fa, flash_attention_wgmma_kernel<64>);
    dyn = WgmmaTile<64>::SMEM;
  } else if (d == 96) {
    e = cudaFuncGetAttributes(&fa, flash_attention_wgmma_kernel<96>);
    dyn = WgmmaTile<96>::SMEM;
  } else if (d == 128) {
    e = cudaFuncGetAttributes(&fa, flash_attention_wgmma_kernel<128>);
    dyn = WgmmaTile<128>::SMEM;
  } else if (d == 256) {
    e = cudaFuncGetAttributes(&fa, flash_attention_wgmma_kernel<256>);
    dyn = WgmmaTile<256>::SMEM;
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
