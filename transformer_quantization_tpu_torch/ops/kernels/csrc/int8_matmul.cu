// Payload matmul with the dequant fold, activation and per-column output
// site in the epilogue.
//
// Replaces: transformer_quantization_tpu/ops/pallas/engine_kernels.py
//   int8_matmul (_mm_kernel / _mm_body / _int_dot), and the matmul halves
//   of int8_matmul_add_ln, int8_ffn_ln, int8_attn_ln and int8_layer_ln.
//
//   y   = (in_s * wscale[n]) * (acc + in_shift * colsum[n]) + bias[n]
//   y   = act(y)                              (none | gelu_new | relu)
//   out = emit:  clip(rint(y / out_s[n]) - out_sh[n], -128, 127)  int8
//         fold:  out_s[n] * (clip(...) + out_sh[n])               float
//                (on the fold site's out_bits grid: [lo, hi] up to 16 bits)
//         float: y                                                float
//
// What bounds it on the card: the int8 tensor-core rate. At BERT-base
// shapes (M = 16384, K/N = 768..3072) every call does 19-77 GOP over
// 26-65 MB, 300-1200 int8 operations per byte, far above the H100's
// ~590 op/byte ridge (1,979 TOP/s over 3.35 TB/s).
//
// Design: 128x128 output tile per 256-thread block, 8 warps of 64x32,
// mma.sync.m16n8k32 s8*s8->s32 (mm_tile in mm_common.cuh, shared with
// the NoNorm matmul and the MobileBERT layer kernel). Both operands are
// K-contiguous (x is (M, K), the weight (N, K)), so every fragment
// register is one 32-bit shared-memory load; rows are padded to 80 bytes,
// which makes the fragment loads bank-conflict free. K advances 64 bytes
// at a time through a two-stage cp.async ring. This is the simple first
// kernel: wgmma, TMA and a persistent schedule are later work.
//
// Numerics: the int32 accumulator converts with __int2float_rn (as XLA's
// convert does) and the epilogue keeps the reference's association order;
// the file is built with -fmad=false so no multiply-add is contracted.
// rintf rounds half to even like torch.round / jnp.round.

#include "mm_common.cuh"

namespace {

using namespace tqmm;

template <int ACT, int OUT>
__global__ void __launch_bounds__(THREADS)
    int8_mm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ vecs,
                   const float* __restrict__ scal, void* __restrict__ out,
                   int M, int N, int K, float lo, float hi, float gelu_c) {
  __shared__ __align__(16) int8_t sA[2 * BM * LDS];
  __shared__ __align__(16) int8_t sB[2 * BN * LDS];
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  int acc[4][4][4];
  mm_tile<false>(x, K, w, M, N, K, m0, n0, sA, sB, acc);
  const float in_s = scal[0];
  const float in_sh = scal[1];
  mm_epilogue(
      acc, m0, n0, M, N,
      [&](int col) { return col_site(vecs, N, col, in_s, in_sh); },
      [&](int row, int col, int a, const ColSite& k) {
        store_site<ACT, OUT>(fold(a, k), (size_t)row * N + col, k.os, k.inv,
                             k.osh, lo, hi, gelu_c, out);
      });
}

template <int ACT, int OUT>
cudaError_t launch(const int8_t* x, const int8_t* w, const float* vecs,
                   const float* scal, void* out, int M, int N, int K,
                   float lo, float hi, float gelu_c, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int8_mm_kernel<ACT, OUT><<<grid, THREADS, 0, stream>>>(
      x, w, vecs, scal, out, M, N, K, lo, hi, gelu_c);
  return cudaGetLastError();
}

template <int ACT>
cudaError_t launch_act(int out_mode, const int8_t* x, const int8_t* w,
                       const float* vecs, const float* scal, void* out, int M,
                       int N, int K, float lo, float hi, float gelu_c,
                       cudaStream_t st) {
  switch (out_mode) {
    case 0: return launch<ACT, 0>(x, w, vecs, scal, out, M, N, K, lo, hi, gelu_c, st);
    case 1: return launch<ACT, 1>(x, w, vecs, scal, out, M, N, K, lo, hi, gelu_c, st);
    default: return launch<ACT, 2>(x, w, vecs, scal, out, M, N, K, lo, hi, gelu_c, st);
  }
}

}  // namespace

// act: 0 none, 1 gelu_new, 2 relu. out_mode: 0 emit (int8), 1 fold (f32),
// 2 float (f32). [lo, hi]: the output site's level bounds (emit: 8-bit).
// Returns the launch's cudaError_t.
extern "C" int tq_int8_matmul(const void* x, const void* w, const void* vecs,
                              const void* scal, void* out, int M, int N,
                              int K, int act, int out_mode, float lo,
                              float hi, float gelu_c, void* stream) {
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* vp = static_cast<const float*>(vecs);
  const float* sp = static_cast<const float*>(scal);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (act < 0 || act > 2 || out_mode < 0 || out_mode > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  switch (act) {
    case 0: e = launch_act<0>(out_mode, xp, wp, vp, sp, out, M, N, K, lo, hi, gelu_c, st); break;
    case 1: e = launch_act<1>(out_mode, xp, wp, vp, sp, out, M, N, K, lo, hi, gelu_c, st); break;
    default: e = launch_act<2>(out_mode, xp, wp, vp, sp, out, M, N, K, lo, hi, gelu_c, st); break;
  }
  return static_cast<int>(e);
}
