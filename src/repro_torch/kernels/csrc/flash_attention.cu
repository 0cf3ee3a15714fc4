// Blocked online-softmax attention (flash attention) for prefill.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py,
// `flash_attention` (`_fa_kernel`), which walks a (batch, q_heads, q_blocks,
// kv_blocks) grid in order on one core and carries the running max m, sum l
// and accumulator acc in VMEM scratch across the kv axis.  Here one CTA owns
// a block of 64 query rows of one (batch, head) and loops over the kv tiles
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
// shape (B=4, H=16, S=4096, D=128) does 2·B·H·S²·D = 2.75e11 FLOP on
// 151 MB of q, k, v and out, 0.278 ms at 989 TFLOP/s against 0.045 ms at
// 3.35 TB/s.  Two kernels, chosen by the wrapper from the inputs:
//
// * `flash_attention_mma_kernel` (bf16, head dim 64 or 128, the prefill
//   path): the products run on the tensor cores as `mma.sync` m16n8k16
//   with bf16 operands and float32 accumulators.  Four warps own 16 query
//   rows each; q stays in registers as A fragments; k (row-major) and v
//   (transposed) tiles of 64 keys are staged in padded shared memory so
//   the B-fragment loads hit distinct banks; the score accumulators become
//   P·V's A fragments in registers (P rounded to bf16, as attention_ref
//   rounds it).  sm_scale is applied to the float32 scores, after the
//   product, as attention_ref does.  No cp.async/TMA pipelining and no
//   wgmma yet: the loads and the products of a tile do not overlap.
// * `flash_attention_kernel` (float32, and bf16 at other head dims): the
//   tiles are staged in shared memory as float32 and every product is a
//   scalar FMA on a 4 x 2 (scores) and 4 x D/16 (output) register tile
//   per thread, so it runs on the CUDA cores; float32 inputs need it (the
//   tensor cores would round them), and q is scaled in float32 before the
//   product, as `_fa_kernel` does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "float_convert.cuh"

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

// ---------------------------------------------------------------- mma.sync --
constexpr int kMmaBQ = 64;       // query rows per CTA: 16 per warp
constexpr int kMmaBK = 64;       // keys per tile
constexpr int kMmaThreads = 128;
constexpr int kPad = 8;          // bf16 pad per shared row (16 bytes)

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d += a · b for one m16n8k16 tile: a 16x16 bf16 (row), b 16x8 bf16 (col),
// d 16x8 float32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory, transposed: lane t gets, of
// matrix i, the elements (2·(t%4), t/4) and (2·(t%4)+1, t/4) in register i;
// lanes 8i..8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* row) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

template <int D>
constexpr size_t mma_smem_bytes() {
  // k and v tiles, [key][d] with padded rows, bf16
  return sizeof(__nv_bfloat16) * 2 * kMmaBK * (D + kPad);
}

// Fragment layout of m16n8k16 (lane = 4 * group + tig): A holds rows
// group and group + 8 at columns 2·tig + {0, 1} and + 8; B holds column
// (n) group at rows (k) 2·tig + {0, 1} and + 8; C/D hold rows group and
// group + 8 at columns 2·tig + {0, 1}.  A padded shared row (D + 8 bf16)
// puts the 8 rows a fragment load touches on distinct banks.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    flash_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                               const __nv_bfloat16* __restrict__ k,
                               const __nv_bfloat16* __restrict__ v,
                               __nv_bfloat16* __restrict__ out, int n_heads,
                               int q_per_kv, int sq, int skv, int64_t q_sb,
                               int64_t q_sh, int64_t q_ss, int64_t k_sb,
                               int64_t k_sh, int64_t k_ss, int64_t v_sb,
                               int64_t v_sh, int64_t v_ss, float sm_scale,
                               int causal, int window) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int KS = D + kPad;        // k_s and v_s row stride (elements)
  constexpr int NKD = D / 16;         // k-steps of q·kᵀ
  constexpr int NT = kMmaBK / 8;      // score n-tiles per tile
  constexpr int NO = D / 8;           // output n-tiles
  constexpr int V8 = D / 8;           // 16-byte vectors per k/v row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* v_s = k_s + kMmaBK * KS;

  const int qb = gridDim.x - 1 - blockIdx.x;  // heaviest causal blocks first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q_start = qb * kMmaBQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int group = lane / 4;
  const int tig = lane % 4;

  const __nv_bfloat16* qp = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kp = k + b * k_sb + (h / q_per_kv) * k_sh;
  const __nv_bfloat16* vp = v + b * v_sb + (h / q_per_kv) * v_sh;

  // this warp's 16 query rows as A fragments, straight from device memory
  const int row0 = q_start + warp * 16 + group;   // and row0 + 8
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  uint32_t qf[NKD][4];
#pragma unroll
  for (int kk = 0; kk < NKD; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = row0 + (r & 1) * 8;
      const int col = kk * 16 + 2 * tig + (r >> 1) * 8;
      const bool ok = row < sq;
      const __nv_bfloat16* src = qp + row * q_ss + col;
      qf[kk][r] = pack_bf16(ok ? src[0] : zero, ok ? src[1] : zero);
    }
  }

  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  int kb_lo = 0;
  int kb_hi = (skv + kMmaBK - 1) / kMmaBK;
  if (causal) kb_hi = min(kb_hi, (q_start + kMmaBQ - 1) / kMmaBK + 1);
  if (window >= 0 && q_start - window > 0)
    kb_lo = (q_start - window) / kMmaBK;

  for (int kb = kb_lo; kb < kb_hi; ++kb) {
    const int k_start = kb * kMmaBK;
    __syncthreads();  // the last tile's readers are done
    for (int i = tid; i < kMmaBK * V8; i += kMmaThreads) {
      const int c = i / V8, d = (i % V8) * 8;
      const int col = k_start + c;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = kv;
      if (col < skv) {
        kv = *reinterpret_cast<const uint4*>(kp + col * k_ss + d);
        vv = *reinterpret_cast<const uint4*>(vp + col * v_ss + d);
      }
      *reinterpret_cast<uint4*>(k_s + c * KS + d) = kv;
      *reinterpret_cast<uint4*>(v_s + c * KS + d) = vv;
    }
    __syncthreads();

    // scores: 16 rows x 64 keys per warp
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* kr = k_s + (nt * 8 + group) * KS + 2 * tig;
#pragma unroll
      for (int kk = 0; kk < NKD; ++kk) {
        mma_bf16(s[nt], qf[kk],
                 *reinterpret_cast<const uint32_t*>(kr + kk * 16),
                 *reinterpret_cast<const uint32_t*>(kr + kk * 16 + 8));
      }
    }

    // mask, online softmax; each row's 64 columns live in one lane quad
    float mc[2] = {kMasked, kMasked};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + (e >> 1) * 8;
        const int col = k_start + nt * 8 + 2 * tig + (e & 1);
        s[nt][e] = mask_score(s[nt][e] * sm_scale, row, col, skv, causal,
                              window);
        mc[e >> 1] = fmaxf(mc[e >> 1], s[nt][e]);
      }
    }
    float alpha[2], ps[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mc[r] = fmaxf(mc[r], __shfl_xor_sync(0xffffffffu, mc[r], 1));
      mc[r] = fmaxf(mc[r], __shfl_xor_sync(0xffffffffu, mc[r], 2));
      const float mn = fmaxf(m[r], mc[r]);
      alpha[r] = expf(m[r] - mn);
      m[r] = mn;
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = expf(s[nt][e] - m[e >> 1]);
        ps[e >> 1] += s[nt][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      ps[r] += __shfl_xor_sync(0xffffffffu, ps[r], 1);
      ps[r] += __shfl_xor_sync(0xffffffffu, ps[r], 2);
      l[r] = alpha[r] * l[r] + ps[r];
    }
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // o += P·V: two score n-tiles make one A fragment of 16 keys
#pragma unroll
    for (int kk = 0; kk < kMmaBK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      // B fragments of output n-tiles j, j + 1: v rows kk·16 + 0..15
      // (lanes 0-15, then 16-31 one n-tile on), transposed on load
#pragma unroll
      for (int j = 0; j < NO; j += 2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, v_s + (kk * 16 + (lane & 15)) * KS +
                                  (j + (lane >> 4)) * 8);
        mma_bf16(o[j], pa, vb[0], vb[1]);
        mma_bf16(o[j + 1], pa, vb[2], vb[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (row >= sq) continue;
    const float li = l[r] == 0.f ? 1.f : l[r];
    __nv_bfloat16* op = out + ((int64_t)(b * n_heads + h) * sq + row) * D;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int col = j * 8 + 2 * tig;
      op[col] = __float2bfloat16(o[j][2 * r] / li);
      op[col + 1] = __float2bfloat16(o[j][2 * r + 1] / li);
    }
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

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* out,
               int batch, int n_heads, int n_kv_heads, int sq, int skv,
               const int64_t* st, float sm_scale, int causal, int window,
               cudaStream_t stream) {
  auto kern = flash_attention_mma_kernel<D>;
  constexpr size_t smem = mma_smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((sq + kMmaBQ - 1) / kMmaBQ, n_heads, batch);
  kern<<<grid, kMmaThreads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)out, n_heads,
      n_heads / n_kv_heads, sq, skv, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], sm_scale, causal, window);
  return (int)cudaGetLastError();
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
    FA_CASE(64)
    FA_CASE(96)
    FA_CASE(128)
    FA_CASE(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FA_CASE
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  strides: q, k, v each (batch, head, seq),
// in elements; the head-dim stride is 1.  window < 0: no window.  bf16 at
// head dim 64 or 128 takes the tensor-core kernel, which reads k and v in
// 16-byte vectors: their base addresses and strides must be multiples of
// 16 bytes (the wrapper sees to it).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int dtype,
                                      int batch, int n_heads, int n_kv_heads,
                                      int sq, int skv, int d,
                                      const int64_t* strides, float sm_scale,
                                      int causal, int window, void* stream) {
  if (batch == 0 || n_heads == 0 || sq == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_dim<float>(d, q, k, v, out, batch, n_heads, n_kv_heads, sq,
                             skv, strides, sm_scale, causal, window, s);
  if (dtype == 1 && d == 64)
    return launch_mma<64>(q, k, v, out, batch, n_heads, n_kv_heads, sq, skv,
                          strides, sm_scale, causal, window, s);
  if (dtype == 1 && d == 128)
    return launch_mma<128>(q, k, v, out, batch, n_heads, n_kv_heads, sq, skv,
                           strides, sm_scale, causal, window, s);
  if (dtype == 1)
    return launch_dim<__nv_bfloat16>(d, q, k, v, out, batch, n_heads,
                                     n_kv_heads, sq, skv, strides, sm_scale,
                                     causal, window, s);
  return (int)cudaErrorInvalidValue;
}
