// Hopper building blocks of the warp-specialized int8 kernels
// (wgmma_gemm.cuh, the attention kernel, the MobileBERT layer kernel):
// mbarriers, TMA tile loads and stores and the host-side tensor map, wgmma
// on s8 operands read from 128- or 64-byte swizzled shared memory (A also
// from registers), register hand-over between warpgroups and named
// barriers. sm_90a only (wgmma and setmaxnreg do not exist on plain
// sm_90).

#pragma once

#include <cuda.h>   // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_runtime.h>
#include <stdint.h>

namespace tqwg {

// ---------------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// makes the barriers' initialisation visible to the async proxy (TMA)
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(addr),
      "r"(parity)
      : "memory");
}

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------

// the 2-D box at (inner c0, outer c1) of `map` into shared memory; the
// transferred bytes complete on `bar` (out-of-bounds elements read as 0)
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// the 2-D box at (inner c0, outer c1) of `map` from shared memory, as its
// own bulk group
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// this thread's bulk stores but the newest N have read their sources
template <int N>
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void tma_store_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// orders this thread's generic shared-memory writes before later reads
// of the async proxy (wgmma operands, TMA stores)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, found through the runtime so the
// library needs no -lcuda; null where libcuda does not export it
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) != cudaSuccess
        || q != cudaDriverEntryPointSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess
        || q != cudaDriverEntryPointSuccess)
      p = nullptr;
#endif
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// The tensor map of a row-major (rows, cols) byte matrix read in boxes of
// box_rows x box_cols bytes with the given swizzle. cols % 16 == 0 and a
// 16-byte aligned base are the caller's to check. Returns false if the
// encoding is refused.
inline bool make_u8_map(CUtensorMap* map, const void* base, int rows,
                        int cols, int box_cols, int box_rows,
                        CUtensorMapSwizzle swz) {
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1u, 1u};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The tensor map of a row-major (rows, cols) int8 matrix read in boxes of
// box_rows x 128 bytes, 128-byte swizzled (the layout wgmma's descriptors
// below expect). cols % 16 == 0 and a 16-byte aligned base are the
// caller's to check. Returns false if the encoding is refused.
inline bool make_i8_map(CUtensorMap* map, const void* base, int rows,
                        int cols, int box_rows) {
  return make_u8_map(map, base, rows, cols, 128, box_rows,
                     CU_TENSOR_MAP_SWIZZLE_128B);
}

// ---------------------------------------------------------------------------
// cp.async: global -> shared without registers
// ---------------------------------------------------------------------------

// BYTES (8 or 16) bytes from gmem to smem, both BYTES-aligned; only the
// first `valid` (0 or BYTES) are read, the rest written as zeros
template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem,
                                         int valid) {
  static_assert(BYTES == 8 || BYTES == 16, "cp.async of 8 or 16 bytes");
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(smem)),
                 "l"(gmem), "r"(valid)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                     smem_u32(smem)),
                 "l"(gmem), "r"(valid)
                 : "memory");
}

// every cp.async this thread issued has landed in shared memory
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// The matrix descriptor of a K-major tile of 128-byte rows written by TMA
// with 128-byte swizzling: start address >> 4, leading offset 1 (unused
// for swizzled K-major), stride 1024 bytes between 8-row groups, layout
// type 1 (128B swizzle). The tile must start on a 1024-byte boundary; a
// k32 step inside the 128-byte row adds 32 bytes (2) to the start field.
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((1024ull >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses of an accumulator register
// across an asynchronous wgmma that writes it
__device__ __forceinline__ void fence_reg(int& r) {
  asm volatile("" : "+r"(r)::"memory");
}

#define TQWG_R8(i)                                                        \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]),             \
      "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

// D (64 x 128, s32) (+)= A (64 x 32, s8, K-major) * B (128 x 32, s8,
// K-major)^T, both from shared memory; scale_d = 0 overwrites D.
//
// Accumulator fragment (PTX ISA, wgmma .m64nNk32 D layout): thread
// T = 32 w + l of the warpgroup holds, for j = 0..15,
//   d[4j + 2h + c] = D[16 w + l / 4 + 8 h][8 j + 2 (l % 4) + c],
// h, c in {0, 1}: rows 16w + l/4 and +8, column pairs 2 (l % 4) of every
// 8-column block.
__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[64],
                                                    uint64_t desc_a,
                                                    uint64_t desc_b,
                                                    int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : TQWG_R8(0), TQWG_R8(8), TQWG_R8(16), TQWG_R8(24), TQWG_R8(32),
        TQWG_R8(40), TQWG_R8(48), TQWG_R8(56)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (64 x 64, s32) (+)= A (64 x 32, s8) * B (64 x 32, s8)^T, both K-major
// in shared memory; the fragment of wgmma_m64n128k32_s8 for j = 0..7.
__device__ __forceinline__ void wgmma_m64n64k32_s8(int* d, uint64_t desc_a,
                                                   uint64_t desc_b,
                                                   int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "%32, %33, p;\n"
      "}\n"
      : TQWG_R8(0), TQWG_R8(8), TQWG_R8(16), TQWG_R8(24)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (64 x 32, s32) (+)= A (64 x 32, s8, in registers) * B (32 x 32, s8,
// K-major in shared memory)^T. A's fragment is mma.sync m16n8k32's for
// warp w's rows 16 w ..: a[0] = row g, bytes 4t..4t+3; a[1] = row g + 8,
// the same; a[2] / a[3] = bytes 16 + 4t.. of rows g / g + 8 (g = lane / 4,
// t = lane % 4); D's fragment that of wgmma_m64n128k32_s8 for j = 0..3.
__device__ __forceinline__ void wgmma_m64n32k32_s8_rs(int* d,
                                                      const unsigned* a,
                                                      uint64_t desc_b,
                                                      int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p;\n"
      "}\n"
      : TQWG_R8(0), TQWG_R8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

#undef TQWG_R8

// The matrix descriptor of a K-major tile of 64-byte rows with 64-byte
// swizzling (16-byte chunk c of row r at c ^ ((r >> 1) & 3)): stride 512
// bytes between 8-row groups, layout type 2. The tile starts on a
// 512-byte boundary; a k32 step inside the row adds 32 bytes (2).
__device__ __forceinline__ uint64_t sw64_desc(const void* tile) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((512ull >> 4) << 32) |
         (2ull << 62);
}

// ---------------------------------------------------------------------------
// warpgroups
// ---------------------------------------------------------------------------

template <int REGS>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

template <int REGS>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

// barrier `id` (1..15; 0 is __syncthreads) over `threads` threads
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

}  // namespace tqwg
