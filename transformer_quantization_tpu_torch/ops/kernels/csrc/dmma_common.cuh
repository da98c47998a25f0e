// Hopper's float64 tensor cores (DMMA: mma.sync .f64, the m16n8k4 / k8 /
// k16 shapes that sm_90 added), the u8 x s8 integer mma.sync, and the
// cp.async group steps, for the float x int8 matmul (K9,
// float_int8_gemm.cu) and the attention's second kernel
// (int8_attention.cu). Kept apart from mm_common.cuh and
// wgmma_common.cuh so that the kernels on those headers keep their
// machine code.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tqdm {

// D += A (16 x 4KS, row) * B (4KS x 8, col) in float64, KS = 1, 2, 4
// (m16n8k4, k8, k16). Lane (g, t) = (lane / 4, lane % 4) holds
//   a[2s + r] = A[g + 8r][t + 4s],  b[s] = B[t + 4s][g]   (s < KS)
//   c[2r + j] = D[g + 8r][2t + j]
// Each product of two values that are exact in float64 is exact, and each
// add rounds once to float64: the order of the k sum is the caller's.
template <int KS>
__device__ __forceinline__ void dmma(double (&c)[4], const double* a,
                                     const double* b);

template <>
__device__ __forceinline__ void dmma<1>(double (&c)[4], const double* a,
                                        const double* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(b[0]));
}

template <>
__device__ __forceinline__ void dmma<2>(double (&c)[4], const double* a,
                                        const double* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

template <>
__device__ __forceinline__ void dmma<4>(double (&c)[4], const double* a,
                                        const double* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, "
      "{%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
        "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// A 16 x 16 step as KS-deep DMMAs: 4 / KS of them over the same fragments
// (the layout above with s < 4), so that a kernel picks the shape by KS
// alone
template <int KS>
__device__ __forceinline__ void dmma16(double (&c)[4], const double (&a)[8],
                                       const double (&b)[4]) {
#pragma unroll
  for (int i = 0; i < 4 / KS; ++i) dmma<KS>(c, a + 2 * KS * i, b + KS * i);
}

// D += A (16x32, row, u8) * B (32x8, col, s8), int32 sums
__device__ __forceinline__ void mma_k32_u8(int* c, const unsigned* a,
                                           const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes from gmem to smem (both 16-byte aligned); valid 0 writes zeros
// and reads nothing
__device__ __forceinline__ void cp16(void* smem, const void* gmem,
                                     bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(smem))),
               "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every group of this thread's cp.async but the newest N has landed
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// an int8 (the low byte's value, sign-extended) as float64, exactly
__device__ __forceinline__ double i8_to_f64(uint32_t word, int byte) {
  return static_cast<double>(static_cast<int8_t>(word >> (8 * byte)));
}

}  // namespace tqdm
