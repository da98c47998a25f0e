// Payload matmul with MobileBERT's whole NoNorm tail in the epilogue.
//
// Replaces: transformer_quantization_tpu/ops/pallas/engine_kernels.py
//   int8_matmul_norm (_mm_norm_kernel / _mm_norm_core / _mm_norm_val), and
//   int8_matmul_add_ln and the dense half of int8_ffn_ln with
//   norm='nonorm'.
//
//   y   = (in_s * wscale[n]) * (acc + in_shift * colsum[n]) + bias[n]
//   y   = out_s[n] * (clip(rint(y / out_s[n]) - out_sh[n], -128, 127)
//                    + out_sh[n])                        (the fold site)
//   y   = y + r_s * (r8 + r_sh)                          (with a residual)
//   y   = res_s * (clip(rint(y * (1/res_s)) - res_sh, -128, 127) + res_sh)
//                                                        (when res_quant)
//   out = clip(rint((y * gamma[n] + beta[n]) / ln_s) - ln_sh, -128, 127)
//
// What bounds it on the card: bytes, at MobileBERT's widths (M = 16384;
// K x N = 512 x 128 for the bottleneck-in and FFN dense matmuls, 128 x
// 128 for attn_out, 128 x 512 for bottleneck-out): 0.5-2.1 GOP over
// 6.3-19 MB, 85-200 int8 operations per byte, under the H100's ~590
// op/byte ridge.
//
// Design: NoNorm is elementwise (no row reduction, unlike LayerNorm), so
// the whole tail runs on the accumulator tile in registers and only the
// norm-site payload leaves the block: no add+LN kernel and no round trip
// of the fold payload. The main loop is K1's (mm_tile), the tail
// nonorm_out, both in mm_common.cuh and shared with int8_mb_layer.cu.
//
// Numerics: the plain version's association order, -fmad=false, rintf,
// true divisions by the out and ln scales and a multiply by 1/res_s, as
// int8_matmul_add_ln_ref (norm='nonorm') computes them.

#include "mm_common.cuh"

namespace {

using namespace tqmm;

template <bool RES>
__global__ void __launch_bounds__(THREADS)
    mm_nonorm_kernel(const int8_t* __restrict__ x,
                     const int8_t* __restrict__ w,
                     const float* __restrict__ vecs,
                     const float* __restrict__ scal,
                     const int8_t* __restrict__ r8,
                     const float* __restrict__ gb,
                     const float* __restrict__ ls, int8_t* __restrict__ out,
                     int M, int N, int K, int res_quant) {
  __shared__ __align__(16) int8_t sA[2 * BM * LDS];
  __shared__ __align__(16) int8_t sB[2 * BN * LDS];
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  int acc[4][4][4];
  mm_tile<false>(x, K, w, M, N, K, m0, n0, sA, sB, acc);
  const float in_s = scal[0];
  const float in_sh = scal[1];
  const NoNorm p = nonorm_params(ls, res_quant);
  mm_epilogue(
      acc, m0, n0, M, N,
      [&](int col) { return col_norm(vecs, gb, N, col, in_s, in_sh); },
      [&](int row, int col, int a, const ColNorm& k) {
        const size_t idx = (size_t)row * N + col;
        out[idx] = nonorm_out(a, k, RES, RES ? r8[idx] : int8_t(0), p);
      });
}

}  // namespace

// x: (M, K) int8; w: (N, K) int8; vecs: (5, N) f32 (rows 3/4: the fold
// site); scal: (1, 2) f32 [in_s, in_sh]; r8: (M, N) int8 residual payload
// or null; gb: (2, N) f32 [gamma_q; beta_q]; ls: (1, 8) f32 [-, -, r_s,
// r_sh, res_s, res_sh, ln_s, ln_sh]; out: (M, N) int8. K % 16 == 0.
// Returns the launch's cudaError_t.
extern "C" int tq_int8_matmul_norm(const void* x, const void* w,
                                   const void* vecs, const void* scal,
                                   const void* r8, const void* gb,
                                   const void* ls, void* out, int M, int N,
                                   int K, int res_quant, void* stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* vp = static_cast<const float*>(vecs);
  const float* sp = static_cast<const float*>(scal);
  const int8_t* rp = static_cast<const int8_t*>(r8);
  const float* gp = static_cast<const float*>(gb);
  const float* lp = static_cast<const float*>(ls);
  int8_t* op = static_cast<int8_t*>(out);
  if (rp != nullptr)
    mm_nonorm_kernel<true><<<grid, THREADS, 0, st>>>(
        xp, wp, vp, sp, rp, gp, lp, op, M, N, K, res_quant);
  else
    mm_nonorm_kernel<false><<<grid, THREADS, 0, st>>>(
        xp, wp, vp, sp, rp, gp, lp, op, M, N, K, res_quant);
  return static_cast<int>(cudaGetLastError());
}
