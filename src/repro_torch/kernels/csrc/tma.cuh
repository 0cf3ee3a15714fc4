// TMA, mbarrier and wgmma-descriptor helpers shared by the Hopper kernels
// (flash_attention.cu, ssd_scan.cu).
//
// Tiles live in shared memory as 128-byte-swizzled slabs of 64 bf16
// columns (rows x 128 bytes, the layout TMA writes and wgmma reads); a
// slab starts on a 1024-byte boundary, the swizzle's period.  A width that
// is no whole number of 64 columns (head dim 96) takes 64-byte-swizzled
// slabs of 32 columns instead (`Slabs`).  Tensors are
// described to TMA as 4-D maps by `encode_map`: the unit-stride inner dim,
// then the logical dims sequence, head and batch in the order of their
// strides.  `cuTensorMapEncodeTiled` is reached through the runtime's
// driver entry point, so a library needs no -lcuda.
#pragma once

#include <cuda.h>  // CUtensorMap and cuTensorMapEncodeTiled's types only
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSlabCols = 64;   // bf16 columns of a 128-byte slab
constexpr int kRowBytes = 128;  // one row of a slab

// The slabs a bf16 tile of D columns is stored as.  64, 128 and 256
// columns are whole 64-column slabs, 128 bytes a row, 128-byte swizzled.
// 96 columns (192 bytes a row) are not: they are three 32-column slabs, 64
// bytes a row, 64-byte swizzled.  That is the layout TMA writes under
// CU_TENSOR_MAP_SWIZZLE_64B and `wgmma` reads with descriptor layout type
// 2, and a canonical one for both operand majors: K-major, a 16-deep step
// is half a row; MN-major, 96 columns are three whole 32-column atoms.
template <int D>
struct Slabs {
  static constexpr int ROW_BYTES = D % kSlabCols == 0 ? kRowBytes : 64;
  static constexpr int COLS = ROW_BYTES / 2;  // bf16 columns of a slab
  static constexpr int COUNT = D / COLS;
  // 8 rows: the swizzle's period, and a descriptor's stride byte offset
  static constexpr uint32_t ATOM = 8 * ROW_BYTES;
  static constexpr uint32_t LAYOUT = ROW_BYTES == 128 ? 1 : 2;
  static_assert(D % COLS == 0, "a whole number of slabs");
  // Byte offset of 16-byte chunk c of row r in a slab that starts on an
  // ATOM boundary: the swizzle XORs the chunk with address bits 7 and up
  // (row % 8 at 128 bytes a row, (row / 2) % 4 at 64).
  __device__ static uint32_t at(int r, int c) {
    return r * ROW_BYTES +
           ((c ^ ((r * ROW_BYTES >> 7) & (ROW_BYTES / 16 - 1))) << 4);
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of `bar` with parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// The coordinate of the logical dim (0 seq, 1 head, 2 batch) that sits at
// TMA dim 1 + i of a tensor map: field i (2 bits) of its `order` names the
// dim, and bit 6 + dim marks a broadcast dim, always read at 0 (see
// `encode_map`).
__device__ __forceinline__ int at_dim(int order, int i, int s, int h, int b) {
  const int which = (order >> (2 * i)) & 3;
  if ((order >> (6 + which)) & 1) return 0;
  return which == 0 ? s : (which == 1 ? h : b);
}

// TMA: the box at (column col, sequence row s, head h, batch b) of `map`
// into shared memory at `dst`, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int order, uint32_t bar, int col,
                                         int s, int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col),
      "r"(at_dim(order, 0, s, h, b)), "r"(at_dim(order, 1, s, h, b)),
      "r"(at_dim(order, 2, s, h, b))
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, int order,
                                          uint32_t src, int col, int s, int h,
                                          int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(col), "r"(at_dim(order, 0, s, h, b)),
      "r"(at_dim(order, 1, s, h, b)), "r"(at_dim(order, 2, s, h, b))
      : "memory");
}

// A wgmma shared-memory matrix descriptor for a swizzled operand: start
// address, leading and stride byte offsets (in 16-byte units), and the
// layout type in bits 62-63: 1 (128-byte swizzle) or 2 (64-byte).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo,
                                              uint32_t layout = 1) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all_but_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of wgmma's registers across
// the wait (the asm that issues a wgmma does not say when it completes).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo
  return *reinterpret_cast<const uint32_t*>(&v);
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// Error codes of the C interfaces beyond cudaError_t's: no encoder, or the
// encoder's CUresult + kEncodeFailed.
constexpr int kNoEncoder = 199999;
constexpr int kEncodeFailed = 200000;

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 tensor of logical dims (seq, heads, batch), element strides st =
// (b, h, s) and a unit-stride inner dim of d columns, as a 4-D TMA map: dim
// 0 is the inner dim, dims 1-3 are s, h and b in the order of their
// strides, increasing (for the model's transposed (B, S, H, D) views that
// is h, s, b).  The box is `row_bytes` / 2 columns x `rows` rows of one
// head and batch, swizzled over `row_bytes` (128: 64 columns; 64: 32, see
// `Slabs`); rows past S read as zeros and are not stored.  A dim
// of stride 0 and extent > 1 (a broadcast) is described with extent 1 and
// flagged, so `at_dim` reads it at 0.  *order gets the logical dim (0 s, 1
// h, 2 b) at TMA dims 1-3, two bits each, and bit 6 + dim for each
// broadcast dim.
int encode_map(CUtensorMap* map, int* order, const void* ptr, int batch,
               int heads, int seq, int d, const int64_t* st, int rows,
               int row_bytes = kRowBytes) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return kNoEncoder;
  uint64_t ext[3] = {(uint64_t)seq, (uint64_t)heads, (uint64_t)batch};
  uint64_t bytes[3] = {2 * (uint64_t)st[2], 2 * (uint64_t)st[1],
                       2 * (uint64_t)st[0]};
  int broadcast = 0;
  for (int i = 0; i < 3; ++i)
    if (bytes[i] == 0 && ext[i] > 1) {
      ext[i] = 1;
      broadcast |= 1 << (6 + i);
    }
  // a dim of extent 1 is only ever at coordinate 0: give it a stride past
  // the others, so it sorts last
  uint64_t past = 2 * (uint64_t)d;
  for (int i = 0; i < 3; ++i)
    if (ext[i] > 1 && bytes[i] * ext[i] > past) past = bytes[i] * ext[i];
  past = (past + 15) / 16 * 16;
  for (int i = 0; i < 3; ++i)
    if (ext[i] == 1) bytes[i] = past;
  int idx[3] = {0, 1, 2};
  for (int i = 1; i < 3; ++i)  // insertion sort, stable
    for (int j = i; j > 0 && bytes[idx[j]] < bytes[idx[j - 1]]; --j) {
      const int t = idx[j];
      idx[j] = idx[j - 1];
      idx[j - 1] = t;
    }
  cuuint64_t dims[4] = {(cuuint64_t)d, ext[idx[0]], ext[idx[1]], ext[idx[2]]};
  cuuint64_t strides[3] = {bytes[idx[0]], bytes[idx[1]], bytes[idx[2]]};
  cuuint32_t box[4] = {(cuuint32_t)row_bytes / 2, 1, 1, 1};
  for (int i = 0; i < 3; ++i)
    if (idx[i] == 0) box[1 + i] = rows;
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        row_bytes == kRowBytes ? CU_TENSOR_MAP_SWIZZLE_128B
                                               : CU_TENSOR_MAP_SWIZZLE_64B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return kEncodeFailed + (int)r;
  *order = idx[0] | (idx[1] << 2) | (idx[2] << 4) | broadcast;
  return 0;
}

}  // namespace
