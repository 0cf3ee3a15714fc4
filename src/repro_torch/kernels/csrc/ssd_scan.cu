// mamba2's SSD (state-space duality) scan: a chunked kernel on the tensor
// cores for bf16 on Hopper, and a step kernel on the CUDA cores for the
// rest.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py, `ssd_scan`
// (`_ssd_kernel`), which walks a (batch, heads, chunks) grid in order on one
// core, carries the P x N state in VMEM from one chunk to the next and maps
// each chunk onto MXU products (C·Bᵀ, the decay-masked product with X, the
// carried state's contribution and update).  On the card blocks carry
// nothing between them, so one CTA owns a (batch, head), or a block of its
// state rows, and loops over the whole sequence itself.
//
// Semantics, per head, with H_t in R^{P x N} kept in float32:
//   H_t = a_t · H_{t-1} + x_t ⊗ b_t,   y_t = H_t · c_t,
// a_t clamped below at 1e-37 (the Pallas kernel clamps the log-decay
// there), H_{-1} = h0 (zeros when absent); y is written in x's dtype and
// the final state H_{S-1} in float32.  b and c are read through their
// strides, so the model's broadcast over heads (stride 0) costs no copy.
//
// What bounds it on an H100.  At mamba2-370m's prefill shape (B=4,
// S=32768, H=32, P=64, N=128, bf16) the scan moves 1.153 GB (x, y, one
// head's b and c, a, the final state: 0.344 ms at 3.35 TB/s), and the
// chunked form does 2L²(N+P) + 4LNP FLOP a chunk of L steps: 3.44e11 at
// L = 128 (0.347 ms at 989 TFLOP/s), 2.4e11 at this kernel's L = 64.
// Only the tensor cores, through `wgmma`, reach that rate.  Two kernels,
// chosen by the wrapper from dtype and shape alone (`kernel_for` in
// kernels/ssd_scan.py mirrors the choice; nothing falls back on a failure):
//
// * `ssd_scan_chunked_kernel` (bf16 at P = 64, N = 64 or 128: mamba2-370m's
//   prefill) is built for Hopper.  One CTA a (batch, head), 128 CTAs at
//   mamba2-370m's shape, one wave on 132 SMs; a split of the sequence
//   across CTAs, for batches too small to fill the card, is later work.
//   The CTA walks 64-step chunks in order with four warpgroups:
//   - warpgroup 3, one producer warp: a ring of three chunk stages kept
//     full with TMA (x [L][P], b and c [L][N], 128-byte-swizzled slabs of
//     64 columns; b and c described as the (B, S, N) tensor they are, the
//     stride-0 head axis dropped), and per chunk the inclusive prefix sum
//     `cum` of log2 max(a, 1e-37) by a warp scan (a is L values a chunk,
//     too narrow a box for TMA; its loads run three chunks ahead; a step
//     past S counts as decay 1);
//   - warpgroup 0 owns the state H (P x N float32) as a wgmma accumulator
//     and runs the only serial chain: H = 2^cum_L · H + (X⊙w)ᵀ·B with
//     w_s = 2^(cum_L − cum_s), A = (X⊙w)ᵀ taken from X's tile by
//     `ldmatrix.trans`, scaled by w and rounded to bf16 in registers (the
//     next chunk's fragments are built while the product runs).  It writes
//     a bf16 copy of the state entering chunk c into chunk c's own stage,
//     under its b rows, so it waits on nothing but the ring;
//   - warpgroups 1 and 2 compute y for the even and the odd chunks, so one's
//     mask and epilogue run under the other's products: [S | C·H_prevᵀ] =
//     C·[B; H_prev]ᵀ as one chain of m64n128k16 products (the two share
//     A = C; chained wgmmas issue at their latency, not their rate, so one
//     chain of wide products beats two of narrow ones), S⊙M with M_ts =
//     2^(cum_t − cum_s) below the diagonal (the mask applied to the
//     exponent, which is positive and overflows above it), then y =
//     2^cum_t · C·H_prevᵀ + (S⊙M)·X with S⊙M rounded to bf16 in registers;
//     y leaves through a swizzled staging tile and a TMA store (rows past
//     S are not stored).
//   What paces it (tools/bench_ssd_scan.py --scaling, tools/
//   trace_ssd_scan.py): with 32 CTAs each CTA's own chunk loop, whose
//   chained products keep the tensor pipe at about half its rate; from 64
//   CTAs on the time grows with the CTA count, so a resource they share
//   (the 32 heads of a batch read the same b and c tiles through L2)
//   adds to it.  Multicasting b and c to a cluster of heads is the next
//   step.
//   H never leaves float32; only its operand copy, S⊙M and X⊙w are bf16,
//   the same kind of rounding as P in B3 (a CPU emulation of these
//   rounding points is held to the step-by-step oracle in the tests).
//   `setmaxnreg` moves the producer warpgroup's registers to the
//   consumers, as in B3.  The final state leaves once, from the
//   accumulator.
// * `ssd_scan_kernel`, the step form (float32, which the tensor cores
//   would round past the reference's 2e-3, and bf16 at the P and N the
//   chunked kernel is not built for): 128 threads, each holding 2 rows x
//   16 state columns of H in registers, walk the sequence step by step;
//   a CTA takes 32 state rows of one (batch, head).  It is bound by CUDA-
//   core instructions: 3 float32 instructions per state element a step,
//   about 1.03e11 at mamba2-370m's shape, ~3 ms at the card's 3.35e13
//   such instructions a second, whatever its tuning.  The 16 columns of a
//   thread are interleaved in groups of 4 (column q·4·TPR + ns·4 + r for
//   thread slot ns, group q, lane r) so the float4 reads of b and c by
//   neighbouring threads hit neighbouring banks; step inputs are staged in
//   shared memory as float32, kL steps at a time, the next chunk's loads
//   in flight; each step a thread leaves its partial sums of y_t in shared
//   memory, added once per chunk for all kL steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "float_convert.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRP = 2;   // state rows per thread
constexpr int kNT = 16;  // state columns per thread
constexpr int kL = 8;    // steps staged in shared memory at a time

struct Strides {
  int64_t x_b, x_s, x_h;  // x (B, S, H, P), unit stride on P
  int64_t a_b, a_s, a_h;  // a (B, S, H)
  int64_t b_b, b_s, b_h;  // b (B, S, H, N), unit stride on N
  int64_t c_b, c_s, c_h;  // c (B, S, H, N), unit stride on N
};

// column of state element j (0..kNT-1) of thread slot ns
template <int TPR>
__device__ __forceinline__ int column(int ns, int j) {
  return (j >> 2) * (4 * TPR) + ns * 4 + (j & 3);
}

// TPR = N / kNT threads share a block of kRP rows; R = rows of H per CTA
template <typename T, int TPR>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const T* __restrict__ a,
                const T* __restrict__ bm, const T* __restrict__ cm,
                const float* __restrict__ h0, T* __restrict__ y,
                float* __restrict__ hT, int S, int H, int P, Strides st) {
  constexpr int N = kNT * TPR;
  constexpr int R = kRP * kThreads / TPR;
  constexpr int kBC = kL * N / kThreads;  // b (and c) values per thread
  constexpr int kX = (kL * R + kThreads - 1) / kThreads;  // x per thread
  __shared__ __align__(16) float a_s[kL];
  __shared__ __align__(16) float x_s[kL][R];
  __shared__ __align__(16) float b_s[kL][N];
  __shared__ __align__(16) float c_s[kL][N];
  __shared__ __align__(16) float y_s[kL][kThreads * kRP];  // partials

  const int tid = threadIdx.x;
  const int rq = tid / TPR, ns = tid % TPR;
  const int hh = blockIdx.y, bb = blockIdx.z;
  const int p_base = blockIdx.x * R;
  const int row0 = p_base + kRP * rq;

  const T* xb = x + bb * st.x_b + hh * st.x_h;
  const T* ab = a + bb * st.a_b + hh * st.a_h;
  const T* bb_ = bm + bb * st.b_b + hh * st.b_h;
  const T* cb = cm + bb * st.c_b + hh * st.c_h;
  const int64_t bh = (int64_t)bb * H + hh;

  float h[kRP][kNT];
#pragma unroll
  for (int k = 0; k < kRP; ++k) {
    const int row = row0 + k;
#pragma unroll
    for (int j = 0; j < kNT; ++j)
      h[k][j] = (h0 != nullptr && row < P)
                    ? h0[(bh * P + row) * N + column<TPR>(ns, j)]
                    : 0.f;
  }

  // the next chunk's inputs, in flight while the current one is computed
  T rb[kBC], rc[kBC], rx[kX];
  T ra = from_f32<T>(1.f);
  auto load = [&](int t0) {
#pragma unroll
    for (int i = 0; i < kBC; ++i) {
      const int e = tid + i * kThreads, t = t0 + e / N, n = e % N;
      const bool ok = t < S;
      rb[i] = ok ? bb_[t * st.b_s + n] : from_f32<T>(0.f);
      rc[i] = ok ? cb[t * st.c_s + n] : from_f32<T>(0.f);
    }
#pragma unroll
    for (int i = 0; i < kX; ++i) {
      const int e = tid + i * kThreads, t = t0 + e / R, row = p_base + e % R;
      rx[i] = (e < kL * R && t < S && row < P) ? xb[t * st.x_s + row]
                                               : from_f32<T>(0.f);
    }
    if (tid < kL && t0 + tid < S) ra = ab[(t0 + tid) * st.a_s];
  };
  auto stage = [&]() {
#pragma unroll
    for (int i = 0; i < kBC; ++i) {
      const int e = tid + i * kThreads;
      b_s[e / N][e % N] = to_f32(rb[i]);
      c_s[e / N][e % N] = to_f32(rc[i]);
    }
#pragma unroll
    for (int i = 0; i < kX; ++i) {
      const int e = tid + i * kThreads;
      if (e < kL * R) x_s[e / R][e % R] = to_f32(rx[i]);
    }
    if (tid < kL) a_s[tid] = fmaxf(to_f32(ra), 1e-37f);
  };

  load(0);
  for (int t0 = 0; t0 < S; t0 += kL) {
    __syncthreads();  // the previous chunk is done with the buffers
    stage();
    __syncthreads();
    if (t0 + kL < S) load(t0 + kL);
    const int steps = min(kL, S - t0);
    for (int tt = 0; tt < steps; ++tt) {
      const float at = a_s[tt];
      float xr[kRP];
#pragma unroll
      for (int k = 0; k < kRP; ++k) xr[k] = x_s[tt][kRP * rq + k];
      const float4* bq = reinterpret_cast<const float4*>(&b_s[tt][ns * 4]);
      const float4* cq = reinterpret_cast<const float4*>(&c_s[tt][ns * 4]);
      float yv[kRP];
#pragma unroll
      for (int k = 0; k < kRP; ++k) yv[k] = 0.f;
#pragma unroll
      for (int q = 0; q < kNT / 4; ++q) {
        const float4 bv = bq[q * TPR];
        const float4 cv = cq[q * TPR];
        const float bj[4] = {bv.x, bv.y, bv.z, bv.w};
        const float cj[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int k = 0; k < kRP; ++k) {
            float& hk = h[k][q * 4 + r];
            hk = fmaf(at, hk, xr[k] * bj[r]);
            yv[k] = fmaf(hk, cj[r], yv[k]);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kRP; ++k) y_s[tt][tid * kRP + k] = yv[k];
    }
    __syncthreads();
    // y_t[row] = the sum of the TPR partials of the row's thread slots
    for (int e = tid; e < steps * R; e += kThreads) {
      const int tt = e / R, r = e % R, row = p_base + r;
      const float* part = &y_s[tt][(r / kRP) * TPR * kRP + r % kRP];
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < TPR; ++k) acc += part[kRP * k];
      if (row < P)
        y[((int64_t)(bb * (int64_t)S + t0 + tt) * H + hh) * P + row] =
            from_f32<T>(acc);
    }
  }

#pragma unroll
  for (int k = 0; k < kRP; ++k) {
    const int row = row0 + k;
    if (row >= P) continue;
    float* out = hT + (bh * P + row) * N;
#pragma unroll
    for (int q = 0; q < kNT / 4; ++q)
      *reinterpret_cast<float4*>(&out[q * 4 * TPR + ns * 4]) =
          make_float4(h[k][4 * q], h[k][4 * q + 1], h[k][4 * q + 2],
                      h[k][4 * q + 3]);
  }
}

template <typename T, int TPR>
int launch(const void* x, const void* a, const void* b, const void* c,
           const float* h0, void* y, float* hT, int batch, int S, int H,
           int P, const Strides& st, cudaStream_t stream) {
  constexpr int R = kRP * kThreads / TPR;
  dim3 grid((P + R - 1) / R, H, batch);
  ssd_scan_kernel<T, TPR><<<grid, kThreads, 0, stream>>>(
      (const T*)x, (const T*)a, (const T*)b, (const T*)c, h0, (T*)y, hT, S,
      H, P, st);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_n(int n, const void* x, const void* a, const void* b,
             const void* c, const float* h0, void* y, float* hT, int batch,
             int S, int H, int P, const Strides& st, cudaStream_t stream) {
  switch (n) {
    case 16:
      return launch<T, 16 / kNT>(x, a, b, c, h0, y, hT, batch, S, H, P, st,
                                 stream);
    case 32:
      return launch<T, 32 / kNT>(x, a, b, c, h0, y, hT, batch, S, H, P, st,
                                 stream);
    case 64:
      return launch<T, 64 / kNT>(x, a, b, c, h0, y, hT, batch, S, H, P, st,
                                 stream);
    case 128:
      return launch<T, 128 / kNT>(x, a, b, c, h0, y, hT, batch, S, H, P, st,
                                  stream);
    case 256:
      return launch<T, 256 / kNT>(x, a, b, c, h0, y, hT, batch, S, H, P, st,
                                  stream);
  }
  return (int)cudaErrorInvalidValue;
}


// ------------------------------------------------ chunked: TMA + wgmma ----
// The chunk plan is mirrored by `CHUNK` and `chunk_plan` in
// kernels/ssd_scan.py: keep the two in step.
constexpr int kP = 64;                       // head dim P of the chunked kernel
constexpr int kChunk = 64;                   // steps a chunk
constexpr int kWgThreads = 128;
// warpgroup 0 the state, 1 and 2 y (even and odd chunks), 3 the producer
constexpr int kChunkedThreads = 4 * kWgThreads;
constexpr int kStages = 3;                   // chunks in the ring
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 152;  // 128 · (40 + 3 · 152) <= 65,536
constexpr uint32_t kTile = kChunk * kRowBytes;  // one 64-row slab, 8 KB

// Shared memory of one CTA at state width N, from a 1024-byte-aligned base:
// kStages stages, each x [L][P], then per 64-column slab of N the b rows
// [L] with the bf16 state rows [P] entering the chunk right under them (so
// one K-major operand of 128 rows serves S = C·Bᵀ and C·H_prevᵀ together),
// then c [L][N]; two y staging tiles [L][P]; the stages' cum arrays
// (float32); the mbarriers.
template <int N>
struct ChunkSmem {
  static_assert(N == 64 || N == 128, "state width 64 or 128");
  static constexpr int SLABS = N / kSlabCols;
  static constexpr uint32_t BH = kTile;                 // b|H after x
  static constexpr uint32_t BH_SLAB = 2 * kTile;        // b slab, H slab
  static constexpr uint32_t C = BH + SLABS * BH_SLAB;   // c after b|H
  static constexpr uint32_t STAGE = C + SLABS * kTile;
  static constexpr uint32_t TMA_BYTES = (1 + 2 * SLABS) * kTile;  // x, b, c
  static constexpr uint32_t Y = kStages * STAGE;
  static constexpr uint32_t CUM = Y + 2 * kTile;
  static constexpr uint32_t BARS = CUM + kStages * kChunk * 4;
  static constexpr int SMEM = BARS + 8 * 3 * kStages + 1024;
};

// The CTA's mbarriers, 8 bytes each, for each stage of the ring: full (x,
// b, c and cum landed), state (the bf16 state entering the chunk written),
// empty (both consumers done with the stage).
struct ChunkBars {
  uint32_t base;
  __device__ uint32_t full(int st) const { return base + 8 * st; }
  __device__ uint32_t state(int st) const {
    return base + 8 * (kStages + st);
  }
  __device__ uint32_t empty(int st) const {
    return base + 8 * (2 * kStages + st);
  }
};

template <int M, int K>
__device__ __forceinline__ void fence_frags(uint32_t (&r)[M][K]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < K; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// hand a stage back to the producer (each consumer warp arrives once)
__device__ __forceinline__ void release(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// a y warpgroup's own barrier (named barrier 1 + k for y warpgroup k, its
// 128 threads)
__device__ __forceinline__ void y_sync(int k) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + k), "n"(kWgThreads)
               : "memory");
}

__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t v, float lo,
                                                 float hi) {
  const __nv_bfloat162 p = *reinterpret_cast<const __nv_bfloat162*>(&v);
  return pack_bf16(__low2float(p) * lo, __high2float(p) * hi);
}

// A 64-row wgmma accumulator (D layout: warp w holds rows 16w + group and
// 16w + group + 8, lane = 4·group + tig; register 4j + e is column 8j +
// 2·tig + (e & 1) of row 16w + group + 8·(e >> 1)) rounded to bf16 into
// 64-column swizzled slabs `slab` bytes apart from `dst`.
template <int N>
__device__ __forceinline__ void store_tile(uint32_t dst, uint32_t slab,
                                           const float (&d)[N / 2], int warp,
                                           int group, int tig) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = warp * 16 + group + 8 * r;
      const uint32_t addr = dst + (j / 8) * slab + row * kRowBytes +
                            (((j % 8) ^ (row % 8)) * 16) + tig * 4;
      const uint32_t val = pack_bf16(d[4 * j + 2 * r], d[4 * j + 2 * r + 1]);
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(val)
                   : "memory");
    }
}

// The A fragments of (X⊙w)ᵀ (P x L; K runs over the chunk's steps s) for
// this warp's 16 rows p: `ldmatrix.trans` reads X [s][p] from its swizzled
// slab (lanes 8i..8i+7 give the rows of 8 x 8 matrix i: steps 16kk + 8·(i
// >> 1) + 0..7, columns 16·warp + 8·(i & 1) + 0..7), and each step's pair
// is scaled by w_s = 2^(cum_last − cum_s) and rounded to bf16.
__device__ __forceinline__ void state_fragments(uint32_t (&f)[4][4],
                                                uint32_t x_s,
                                                const float* cum, int warp,
                                                int lane) {
  const float last = cum[kChunk - 1];
  const int tig = lane % 4;
#pragma unroll
  for (int kk = 0; kk < kChunk / 16; ++kk) {
    const int s = 16 * kk + ((lane >> 4) << 3) + (lane & 7);
    const int chunk16 = 2 * warp + ((lane >> 3) & 1);
    const uint32_t addr = x_s + s * kRowBytes + ((chunk16 ^ (s & 7)) << 4);
    uint32_t r[4];
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr)
        : "memory");
    const int s0 = 16 * kk + 2 * tig;
    const float w0 = fast_exp2(last - cum[s0]);
    const float w1 = fast_exp2(last - cum[s0 + 1]);
    const float w8 = fast_exp2(last - cum[s0 + 8]);
    const float w9 = fast_exp2(last - cum[s0 + 9]);
    f[kk][0] = scale_bf16x2(r[0], w0, w1);  // row p, steps s0, s0 + 1
    f[kk][1] = scale_bf16x2(r[1], w0, w1);  // row p + 8
    f[kk][2] = scale_bf16x2(r[2], w8, w9);  // row p, steps s0 + 8, s0 + 9
    f[kk][3] = scale_bf16x2(r[3], w8, w9);  // row p + 8
  }
}

template <int N>
__global__ void __launch_bounds__(kChunkedThreads, 1)
    ssd_scan_chunked_kernel(const __grid_constant__ CUtensorMap x_map,
                            const __grid_constant__ CUtensorMap b_map,
                            const __grid_constant__ CUtensorMap c_map,
                            const __grid_constant__ CUtensorMap y_map,
                            int4 orders, const __nv_bfloat16* __restrict__ a,
                            int64_t a_sb, int64_t a_ss, int64_t a_sh,
                            const float* __restrict__ h0,
                            float* __restrict__ hT, int S, int H) {
  using T = ChunkSmem<N>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  float* const cum_all =
      reinterpret_cast<float*>(smem_raw + (base - raw) + T::CUM);
  const ChunkBars bars{base + T::BARS};
  auto x_s = [&](int st) { return base + st * T::STAGE; };
  auto bh_s = [&](int st) { return base + st * T::STAGE + T::BH; };
  auto c_s = [&](int st) { return base + st * T::STAGE + T::C; };
  auto cum = [&](int st) { return cum_all + st * kChunk; };

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int nc = (S + kChunk - 1) / kChunk;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kStages; ++i) {
      // the producer warp's TMA bytes and its 32 lanes' cum arrivals
      mbar_init(bars.full(i), 1 + 32);
      mbar_init(bars.state(i), kWgThreads);
      mbar_init(bars.empty(i), 8);  // one arrival from each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup, made warp-uniform for the compiler: a role branch it
  // cannot prove uniform makes ptxas serialize the wgmmas behind it
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / kWgThreads, 0);
  const int tid = threadIdx.x % kWgThreads;
  const int warp = tid / 32, lane = tid % 32;
  const int group = lane / 4, tig = lane % 4;
  const int row0 = warp * 16 + group;  // and row0 + 8
  if (wg == 3) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid >= 32) return;
    const __nv_bfloat16* ap = a + b * a_sb + h * a_sh;
    // a of the next kStages chunks in flight, two steps a lane
    float av[kStages][2];
    auto load_a = [&](int c, float (&v)[2]) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int t = c * kChunk + 2 * lane + e;
        // a step past S decays by 1 (log 0): the state passes it unchanged
        v[e] = t < S ? __bfloat162float(ap[t * a_ss]) : 1.f;
      }
    };
#pragma unroll
    for (int i = 0; i < kStages; ++i) load_a(i, av[i]);
    for (int c = 0; c < nc; ++c) {
      const int st = c % kStages;
      mbar_wait(bars.empty(st), ((c / kStages) & 1) ^ 1);  // fresh: empty
      if (lane == 0) {
        mbar_expect_tx(bars.full(st), T::TMA_BYTES);
        tma_load(x_s(st), &x_map, orders.x, bars.full(st), 0, c * kChunk, h,
                 b);
#pragma unroll
        for (int j = 0; j < T::SLABS; ++j) {
          tma_load(bh_s(st) + j * T::BH_SLAB, &b_map, orders.y,
                   bars.full(st), j * kSlabCols, c * kChunk, h, b);
          tma_load(c_s(st) + j * kTile, &c_map, orders.z, bars.full(st),
                   j * kSlabCols, c * kChunk, h, b);
        }
      }
      // cum: the inclusive prefix sum of log2 max(a, 1e-37) over the
      // chunk, two steps a lane
      const float l0 = log2f(fmaxf(av[0][0], 1e-37f));
      const float l1 = log2f(fmaxf(av[0][1], 1e-37f));
      float incl = l0 + l1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += v;
      }
      cum(st)[2 * lane] = incl - l1;
      cum(st)[2 * lane + 1] = incl;
      mbar_arrive(bars.full(st));
#pragma unroll
      for (int i = 0; i + 1 < kStages; ++i) {
        av[i][0] = av[i + 1][0];
        av[i][1] = av[i + 1][1];
      }
      load_a(c + kStages, av[kStages - 1]);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));

  if (wg == 0) {
    // ---- the state: H = 2^cum_L · H + (X⊙w)ᵀ·B, chunk after chunk ----
    // Its bf16 copy, the state entering chunk c, goes under chunk c's b
    // rows in the chunk's own stage, which the producer has refilled only
    // once both consumers were done with its last chunk.
    const int64_t bh = (int64_t)b * H + h;
    float acc[N / 2];
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int64_t off = (bh * kP + row0 + 8 * r) * N + 8 * j + 2 * tig;
        const float2 v = h0 != nullptr
                             ? *reinterpret_cast<const float2*>(h0 + off)
                             : make_float2(0.f, 0.f);
        acc[4 * j + 2 * r] = v.x;
        acc[4 * j + 2 * r + 1] = v.y;
      }
    // stage 0 is fresh: the state entering chunk 0
    store_tile<N>(bh_s(0) + kTile, T::BH_SLAB, acc, warp, group, tig);
    fence_proxy_async();
    mbar_arrive(bars.state(0));

    uint32_t f[4][4], nf[4][4];
    mbar_wait(bars.full(0), 0);
    state_fragments(f, x_s(0), cum(0), warp, lane);
    for (int c = 0; c < nc; ++c) {
      const int st = c % kStages;
      const float decay = fast_exp2(cum(st)[kChunk - 1]);
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[i] *= decay;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk)
        wgmma_rs_tb<N>(acc, f[kk],
                       smem_desc(bh_s(st) + kk * 16 * kRowBytes, T::BH_SLAB,
                                 1024),
                       1);
      wgmma_commit();
      const bool more = c + 1 < nc;
      const int st1 = (c + 1) % kStages;
      if (more) {  // the next chunk's fragments, while the product runs
        mbar_wait(bars.full(st1), ((c + 1) / kStages) & 1);
        state_fragments(nf, x_s(st1), cum(st1), warp, lane);
      }
      wgmma_wait_all();
      fence_regs(acc);
      fence_frags(f);
      release(bars.empty(st), lane);
      if (more) {  // H as the state entering chunk c + 1
        store_tile<N>(bh_s(st1) + kTile, T::BH_SLAB, acc, warp, group, tig);
        fence_proxy_async();
        mbar_arrive(bars.state(st1));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i) f[kk][i] = nf[kk][i];
      }
    }
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int64_t off = (bh * kP + row0 + 8 * r) * N + 8 * j + 2 * tig;
        *reinterpret_cast<float2*>(hT + off) =
            make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
      }
    return;
  }

  // ---- warpgroups 1 and 2: y = (S⊙M)·X + 2^cum_t · C·H_prevᵀ ----
  // y warpgroup k takes the chunks c = k mod 2, so one's mask and epilogue
  // run while the other's products are on the tensor cores.
  // [S | C·H_prevᵀ] = C·[B; H_prev]ᵀ is one chain of m64n128k16 products
  // (the two share A = C).
  const int k = wg - 1;
  float sy[kChunk / 2 + kP / 2], yl[kP / 2];
  uint32_t p[kChunk / 16][4];
  const uint32_t ys = base + T::Y + k * kTile;  // this warpgroup's y tile
  for (int c = k; c < nc; c += 2) {
    const int st = c % kStages;
    mbar_wait(bars.full(st), (c / kStages) & 1);
    mbar_wait(bars.state(st), (c / kStages) & 1);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < T::SLABS; ++j)
#pragma unroll
      for (int kk = 0; kk < kSlabCols / 16; ++kk)
        wgmma_ss<kChunk + kP>(
            sy, smem_desc(c_s(st) + j * kTile + kk * 32, 16, 1024),
            smem_desc(bh_s(st) + j * T::BH_SLAB + kk * 32, 16, 1024),
            (j | kk) != 0);
    wgmma_commit();
    const float* cm = cum(st);
    const float ct[2] = {cm[row0], cm[row0 + 8]};
    float cs[kChunk / 4];  // cum at this thread's columns 8j + 2·tig + e
#pragma unroll
    for (int j = 0; j < kChunk / 8; ++j) {
      cs[2 * j] = cm[8 * j + 2 * tig];
      cs[2 * j + 1] = cm[8 * j + 2 * tig + 1];
    }
    wgmma_wait_all();
    fence_regs(sy);
    // S⊙M, M_ts = 2^(cum_t − cum_s) for s <= t: the mask is applied to the
    // exponent (positive above the diagonal, where it would overflow and
    // inf · 0 is NaN); 2^-inf = 0.  S is sy's columns 0..L-1.
#pragma unroll
    for (int i = 0; i < kChunk / 2; ++i) {
      const int r = (i >> 1) & 1;
      const int col = (i >> 2) * 8 + 2 * tig + (i & 1);
      const float e = col <= row0 + 8 * r ? ct[r] - cs[(i >> 2) * 2 + (i & 1)]
                                          : -INFINITY;
      sy[i] *= fast_exp2(e);
    }
    // S⊙M as A fragments, rounded to bf16: column tiles 2kk and 2kk + 1
    // are steps 16kk..16kk + 15
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk) {
      p[kk][0] = pack_bf16(sy[8 * kk + 0], sy[8 * kk + 1]);
      p[kk][1] = pack_bf16(sy[8 * kk + 2], sy[8 * kk + 3]);
      p[kk][2] = pack_bf16(sy[8 * kk + 4], sy[8 * kk + 5]);
      p[kk][3] = pack_bf16(sy[8 * kk + 6], sy[8 * kk + 7]);
    }
    // y starts as 2^cum_t · C·H_prevᵀ (sy's columns L..L+P-1) ...
    const float e0 = fast_exp2(ct[0]), e1 = fast_exp2(ct[1]);
#pragma unroll
    for (int i = 0; i < kP / 2; ++i)
      yl[i] = ((i >> 1) & 1 ? e1 : e0) * sy[kChunk / 2 + i];
    wgmma_fence();
    // ... and takes (S⊙M)·X on top: X [s][p] is MN-major for this product
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk)
      wgmma_rs_tb<kP>(yl, p[kk],
                      smem_desc(x_s(st) + kk * 16 * kRowBytes, kTile, 1024),
                      1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(yl);
    fence_frags(p);
    release(bars.empty(st), lane);
    // y leaves through this warpgroup's staging tile and a TMA store; its
    // last store (chunk c - 2) must be done reading the tile
    if (tid == 0)
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    y_sync(k);
    store_tile<kP>(ys, kTile, yl, warp, group, tig);
    fence_proxy_async();
    y_sync(k);
    if (tid == 0) {
      tma_store(&y_map, orders.w, ys, 0, c * kChunk, h, b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <int N>
int launch_chunked(const void* x, const void* a, const void* b,
                   const void* c, const float* h0, void* y, float* hT,
                   int batch, int S, int H, const Strides& st,
                   cudaStream_t stream) {
  using T = ChunkSmem<N>;
  CUtensorMap maps[4];
  int orders[4];
  // encode_map takes (batch, head, seq) element strides
  const int64_t xs[3] = {st.x_b, st.x_h, st.x_s};
  const int64_t bs[3] = {st.b_b, st.b_h, st.b_s};
  const int64_t cs[3] = {st.c_b, st.c_h, st.c_s};
  const int64_t ys[3] = {(int64_t)S * H * kP, kP, (int64_t)H * kP};
  int e = encode_map(&maps[0], &orders[0], x, batch, H, S, kP, xs, kChunk);
  if (!e) e = encode_map(&maps[1], &orders[1], b, batch, H, S, N, bs, kChunk);
  if (!e) e = encode_map(&maps[2], &orders[2], c, batch, H, S, N, cs, kChunk);
  if (!e) e = encode_map(&maps[3], &orders[3], y, batch, H, S, kP, ys, kChunk);
  if (e) return e;
  auto kern = ssd_scan_chunked_kernel<N>;
  const cudaError_t r = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (r != cudaSuccess) return (int)r;
  kern<<<dim3(H, batch), kChunkedThreads, T::SMEM, stream>>>(
      maps[0], maps[1], maps[2], maps[3],
      make_int4(orders[0], orders[1], orders[2], orders[3]),
      (const __nv_bfloat16*)a, st.a_b, st.a_s, st.a_h, h0, hT, S, H);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, a, b, c and y share it).  strides: the
// 12 element strides of Strides, in its order.  h0 may be null (zeros);
// y is contiguous (B, S, H, P) and hT contiguous (B, H, P, N) float32.
// Returns cudaGetLastError() after the launch.
extern "C" int ssd_scan_launch(const void* x, const void* a, const void* b,
                               const void* c, const void* h0, void* y,
                               void* hT, int dtype, int batch, int S, int H,
                               int P, int N, const int64_t* strides,
                               void* stream) {
  if (batch == 0 || S == 0 || H == 0 || P == 0) return 0;
  Strides st{strides[0], strides[1], strides[2],  strides[3],
             strides[4], strides[5], strides[6],  strides[7],
             strides[8], strides[9], strides[10], strides[11]};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_n<float>(N, x, a, b, c, (const float*)h0, y, (float*)hT,
                           batch, S, H, P, st, s);
  if (dtype == 1)
    return launch_n<__nv_bfloat16>(N, x, a, b, c, (const float*)h0, y,
                                   (float*)hT, batch, S, H, P, st, s);
  return (int)cudaErrorInvalidValue;
}

// bf16 only (dtype 1), P = 64, N = 64 or 128; the arguments as
// ssd_scan_launch's.  b and c may be broadcast over heads (stride 0); every
// other stride of a dim longer than 1, and the base addresses, must be
// multiples of 16 bytes (the wrapper sees to it).  Returns 0, a
// cudaError_t, or (TMA map encoding) kNoEncoder / kEncodeFailed + CUresult.
extern "C" int ssd_scan_chunked_launch(const void* x, const void* a,
                                       const void* b, const void* c,
                                       const void* h0, void* y, void* hT,
                                       int dtype, int batch, int S, int H,
                                       int P, int N, const int64_t* strides,
                                       void* stream) {
  if (batch == 0 || S == 0 || H == 0) return 0;
  if (dtype != 1 || P != kP) return (int)cudaErrorInvalidValue;
  Strides st{strides[0], strides[1], strides[2],  strides[3],
             strides[4], strides[5], strides[6],  strides[7],
             strides[8], strides[9], strides[10], strides[11]};
  cudaStream_t s = (cudaStream_t)stream;
  if (N == 64)
    return launch_chunked<64>(x, a, b, c, (const float*)h0, y, (float*)hT,
                              batch, S, H, st, s);
  if (N == 128)
    return launch_chunked<128>(x, a, b, c, (const float*)h0, y, (float*)hT,
                               batch, S, H, st, s);
  return (int)cudaErrorInvalidValue;
}

// The chunked kernel's build at state width n (64 or 128): attrs gets
// registers a thread, static shared bytes, the dynamic shared bytes it is
// launched with, local (spill) bytes a thread, and max threads a block.
extern "C" int ssd_scan_chunked_attributes(int n, int* attrs) {
  cudaFuncAttributes fa;
  cudaError_t e;
  int dyn;
  if (n == 64) {
    e = cudaFuncGetAttributes(&fa, ssd_scan_chunked_kernel<64>);
    dyn = ChunkSmem<64>::SMEM;
  } else if (n == 128) {
    e = cudaFuncGetAttributes(&fa, ssd_scan_chunked_kernel<128>);
    dyn = ChunkSmem<128>::SMEM;
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
