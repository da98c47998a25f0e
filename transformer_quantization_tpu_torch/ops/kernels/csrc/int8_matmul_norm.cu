// Payload matmul with MobileBERT's whole NoNorm tail in the epilogue (K6),
// for Hopper.
//
// Replaces: transformer_quantization_tpu/ops/pallas/engine_kernels.py
//   int8_matmul_norm (_mm_norm_kernel / _mm_norm_core / _mm_norm_val), and
//   int8_matmul_add_ln and the dense half of int8_ffn_ln with
//   norm='nonorm'.
//
//   acc = x8 (M, K) @ w8 (N, K)^T                 exact int32
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
// op/byte ridge; 1.9-5.7 us a call at 3.35 TB/s. Beside the bytes, the
// epilogue runs some 45 instructions an element (bottleneck-out: ~12 us
// of issue over the card's 528 schedulers).
//
// Design: NoNorm is elementwise (no row reduction, unlike LayerNorm), so
// the whole tail runs on the accumulator tile in registers and only the
// norm-site payload leaves the block. The kernel is an instance of the
// persistent warp-specialized GEMM of wgmma_gemm.cuh (a producer
// warpgroup's TMA ring of five stages; two consumer warpgroups in
// ping-pong on wgmma m64n128k32 s8, one tile's epilogue under the other's
// products; 16-byte staged stores), with the epilogue policy NormEpi:
// - tiles of 64 x 128: at N = 128 (7 of a layer's 8 calls) 128-row tiles
//   number 128 for 132 SMs, so each block's second consumer warpgroup
//   idled and nothing hid the epilogue (1.3-1.6x the time), and the
//   128-row instances spilled;
// - the column constants are ColNorm (the fold and its site, gamma,
//   beta: 32 bytes a column); 164,960 bytes of shared memory a block;
// - an element takes the plain version's steps in its order (the fold,
//   the fold site's level, the residual, the res site, NoNorm, the norm
//   site's level, to_i8: mm_common.cuh's nonorm_out, which the MobileBERT
//   layer kernel takes too), both site levels through rint_div_fma, one
//   8-column block (4 elements a thread) a step: two ran 2-3% slower;
// - the residual is the skeleton's per-element input: each warp's rows
//   of r8 arrive by cp.async in its staging buffer under the main loop
//   and are read where the output pair is then written (16-byte loads in
//   place of one byte per element);
// - residual and res_quant are template parameters: four instances, each
//   168 registers at launch and no spills (nvcc 12.9 -Xptxas -v).
// - A split-half packed int4 weight (w4: (N, K/2) bytes, column j in a
//   byte's low nibble and column K/2 + j in its high one) takes the
//   skeleton's packed kernel (gemm_kernel_w4: the producer warpgroup's
//   idle warps unpack each stage's packed box in shared memory), whose
//   loads are laid out for 128-row tiles: NormEpiW4, four more instances.
//   The sum is x[:, :K/2] @ lo^T + x[:, K/2:] @ hi^T, exact in int32, so
//   the tail sees the int8 matmul's sums on the unpacked weight. At K =
//   128 one packed box holds both halves of the row. K % 32 == 0.
// Limits: K % 16 == 0, N % 8 == 0, 16-byte aligned x, w, r8 and out.
// Times: k1_probe.py and chip_smoke.py (PERF.md): on an NVIDIA H100
// 80GB HBM3 at 700 W, 0.093 ms for a MobileBERT-uncased layer's eight
// calls at B = 128, S = 128, against 0.216 for the mma.sync kernel it
// replaced and 0.066 for torch._int_mm's int32 products alone.
//
// Numerics: the plain version's association order, -fmad=false, rintf,
// the IEEE quotients by the fold and norm scales and a multiply by the
// IEEE 1/res_s, as int8_matmul_add_ln_ref (norm='nonorm') computes them;
// every output is bit-identical to it.

#include "mm_common.cuh"
#include "wgmma_gemm.cuh"

namespace {

using tqmm::ColNorm;

struct NormArgs {
  const float* vecs;   // (5, N) rows; 3/4: the fold site
  const float* scal;   // (1, 2): in_s, in_sh
  const int8_t* r8;    // (M, N) residual payload or null
  const float* gb;     // (2, N): gamma_q; beta_q
  const float* ls;     // (1, 8): -, -, r_s, r_sh, res_s, res_sh, ln_s, ln_sh
};

// K6's epilogue policy (wgmma_gemm.cuh). RES: the residual r8 is added
// after the fold site; RQ: the res site fake-quantizes the sum. Tiles of
// 64 rows and one 8-column block an epilogue step (the header above).
template <bool RES, bool RQ>
struct NormEpi {
  using Col = ColNorm;
  using Out = int8_t;
  using Args = NormArgs;
  static constexpr bool kResidual = RES;
  static constexpr int kTM = 64;
  static constexpr int kEpiNB = 1;
  const float* vecs;
  const float* gb;
  const int8_t* r8;
  int N;
  float in_s, in_sh, r_s, r_sh, res_s, inv_res, res_sh, ln_s, inv_ln, ln_sh;

  __device__ __forceinline__ NormEpi(const Args& a, int n)
      : vecs(a.vecs), gb(a.gb), r8(a.r8), N(n), in_s(a.scal[0]),
        in_sh(a.scal[1]), r_s(a.ls[2]), r_sh(a.ls[3]), res_s(a.ls[4]),
        inv_res(1.0f / a.ls[4]), res_sh(a.ls[5]), ln_s(a.ls[6]),
        inv_ln(1.0f / a.ls[6]), ln_sh(a.ls[7]) {}
  __device__ __forceinline__ static Col pad() {
    return ColNorm{tqmm::ColSite{0.0f, 0.0f, 0.0f, 1.0f, 1.0f, 0.0f}, 0.0f,
                   0.0f};
  }
  __device__ __forceinline__ Col col(int n) const {
    return tqmm::col_norm(vecs, gb, N, n, in_s, in_sh);
  }
  __device__ __forceinline__ Out apply(int acc, const Col& k,
                                       int8_t r = 0) const {
    return tqmm::nonorm_out<RES, RQ>(
        acc, k, r,
        tqmm::NoNorm{r_s, r_sh, res_s, inv_res, res_sh, ln_s, inv_ln, ln_sh});
  }
};

// K6 on a packed int4 weight (kW4): 128-row tiles, one 8-column block an
// epilogue step
template <bool RES, bool RQ>
struct NormEpiW4 : NormEpi<RES, RQ> {
  static constexpr bool kW4 = true;
  static constexpr int kTM = 128;
  using NormEpi<RES, RQ>::NormEpi;
};

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// x: (M, K) int8; w: (N, K) int8; vecs: (5, N) f32 (rows 3/4: the fold
// site); scal: (1, 2) f32 [in_s, in_sh]; r8: (M, N) int8 residual payload
// or null; gb: (2, N) f32 [gamma_q; beta_q]; ls: (1, 8) f32 [-, -, r_s,
// r_sh, res_s, res_sh, ln_s, ln_sh]; out: (M, N) int8. K % 16 == 0,
// N % 8 == 0, x, w, r8 and out 16-byte aligned. Returns the launch's
// cudaError_t (cudaErrorInvalidValue for arguments the kernel does not
// take, or a tensor map that cannot be encoded).
extern "C" int tq_int8_matmul_norm(const void* x, const void* w,
                                   const void* vecs, const void* scal,
                                   const void* r8, const void* gb,
                                   const void* ls, void* out, int M, int N,
                                   int K, int res_quant, void* stream) {
  if (!aligned16(out) || (r8 != nullptr && !aligned16(r8)))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mx, mw;
  int sms = 0;
  cudaError_t e = tqwg::gemm_setup(x, w, M, N, K, &mx, &mw, &sms);
  if (e == cudaSuccess && !tqwg::make_i8_map(&mx, x, M, K, 64))
    e = cudaErrorInvalidValue;   // x in 64-row boxes (kTM)
  if (e != cudaSuccess) return static_cast<int>(e);
  const NormArgs a{static_cast<const float*>(vecs),
                   static_cast<const float*>(scal),
                   static_cast<const int8_t*>(r8),
                   static_cast<const float*>(gb),
                   static_cast<const float*>(ls)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using tqwg::gemm_launch;
  if (r8 != nullptr)
    e = res_quant
            ? gemm_launch<NormEpi<true, true>>(mx, mw, a, out, M, N, K, sms, st)
            : gemm_launch<NormEpi<true, false>>(mx, mw, a, out, M, N, K, sms,
                                                st);
  else
    e = res_quant
            ? gemm_launch<NormEpi<false, true>>(mx, mw, a, out, M, N, K, sms,
                                                st)
            : gemm_launch<NormEpi<false, false>>(mx, mw, a, out, M, N, K, sms,
                                                 st);
  return static_cast<int>(e);
}

// tq_int8_matmul_norm with w the (N, K/2) split-half packed int4 weight
// (uint8, 16-byte aligned); K % 32 == 0.
extern "C" int tq_int8_matmul_norm_w4(const void* x, const void* w,
                                      const void* vecs, const void* scal,
                                      const void* r8, const void* gb,
                                      const void* ls, void* out, int M,
                                      int N, int K, int res_quant,
                                      void* stream) {
  if (!aligned16(out) || (r8 != nullptr && !aligned16(r8)))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mx, mw;
  int sms = 0;
  cudaError_t e = tqwg::gemm_setup_w4(x, w, M, N, K, &mx, &mw, &sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  const NormArgs a{static_cast<const float*>(vecs),
                   static_cast<const float*>(scal),
                   static_cast<const int8_t*>(r8),
                   static_cast<const float*>(gb),
                   static_cast<const float*>(ls)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using tqwg::gemm_launch;
  if (r8 != nullptr)
    e = res_quant ? gemm_launch<NormEpiW4<true, true>>(mx, mw, a, out, M, N,
                                                       K, sms, st)
                  : gemm_launch<NormEpiW4<true, false>>(mx, mw, a, out, M,
                                                        N, K, sms, st);
  else
    e = res_quant ? gemm_launch<NormEpiW4<false, true>>(mx, mw, a, out, M,
                                                        N, K, sms, st)
                  : gemm_launch<NormEpiW4<false, false>>(mx, mw, a, out, M,
                                                         N, K, sms, st);
  return static_cast<int>(e);
}
