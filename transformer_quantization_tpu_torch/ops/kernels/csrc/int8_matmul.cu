// Payload matmul with the dequant fold, activation and per-column output
// site in the epilogue (K1), for Hopper.
//
// Replaces: transformer_quantization_tpu/ops/pallas/engine_kernels.py
//   int8_matmul (_mm_kernel / _mm_body / _int_dot, w4 too), and the matmul
//   halves of int8_matmul_add_ln, int8_ffn_ln, int8_attn_ln and
//   int8_layer_ln.
//
//   acc = x8 (M, K) @ w8 (N, K)^T                 exact int32
//         (w4: x8[:, :K/2] @ lo^T + x8[:, K/2:] @ hi^T, the nibbles of the
//         (N, K/2) split-half packed int4 weight, tq_int8_matmul_w4)
//   y   = (in_s * wscale[n]) * (acc + in_shift * colsum[n]) + bias[n]
//   y   = act(y)        (none | gelu_new | relu | gelu (A-S erf) |
//                        gelu_poly10 | tanh: mm_common.cuh act_fn)
//   out = emit:  clip(rint(y / out_s[n]) - out_sh[n], -128, 127)  int8
//         fold:  out_s[n] * (clip(...) + out_sh[n])               float
//                (on the fold site's out_bits grid: [lo, hi] up to 16 bits)
//         float: y                                                float
//         (fold and float out in bfloat16 too, rounded to nearest even:
//         the engine's engine_dtype bf16; no activation)
//
// What bounds it on the card: the int8 tensor-core rate. At BERT-base
// shapes (M = 16384, K/N = 768..3072) every call does 19-77 GOP over
// 26-65 MB, 300-1200 int8 operations per byte, far above the H100's
// ~590 op/byte ridge (1,979 TOP/s over 3.35 TB/s). Beside the products,
// the epilogue runs some 16 (emit) to 40 (gelu_new) float instructions
// per output element, longer than the products themselves at K = 768;
// so the design runs one tile's epilogue under another tile's products.
//
// Design: an instance of the persistent warp-specialized GEMM of
// wgmma_gemm.cuh (one 384-thread block per SM over 128 x 128 tiles; a
// producer warpgroup's TMA ring of five 32 KB stages; two consumer
// warpgroups in ping-pong on wgmma m64n128k32 s8, one tile's epilogue
// under the other's products; 16-byte staged stores), with the epilogue
// policy SiteEpi: each tile's 128 column constants (ColSite, the (5, N)
// rows' fold and site) are loaded before the main loop and written to
// shared memory after it, and each element takes site_out's steps from
// mm_common.cuh (fold, act_fn, the site level, to_i8), 16 elements at a
// time so that their chains interleave. The level's rint(y / s) is
// rint_div_fma, the IEEE quotient's integer without a branch or an
// out-of-line call (with them the epilogue ran 25% slower). BN = 128: a warpgroup's int32 accumulator is then 128
// registers a thread, which leaves the epilogue room in a consumer's 232;
// BN = 256 would need 256.
// The packed int4 weight (W4A8) is every policy's W4Epi instance
// (gemm_kernel_w4): the weight stays packed in device memory, half its
// int8 bytes, and each stage's nibbles are unpacked in shared memory by
// the producer warpgroup's idle warps (wgmma_gemm.cuh, kW4). At
// BERT-base's serving buckets (M = 256) the weight is most of a call's
// bytes, but a call is then a few dozen tiles, each a serial chain of
// K / 128 stages, and the chain's latency sets its time; at M = 16384
// the products do, and the unpack's shared-memory traffic beside
// wgmma's operand reads costs a third more than the int8 instance
// (PERF.md).
// Limits: K % 16 == 0 (TMA's 16-byte row stride; w4: K % 32 == 0), N % 8
// == 0, 16-byte aligned operands; M, N and K ragged against the tiles.
// Resources (nvcc 12.9 -Xptxas -v, every instance): 168 registers a
// thread at launch, moved by setmaxnreg to 40 (producer) / 232
// (consumers), no spills; 203,872 bytes of dynamic shared memory (the
// w4 instances 203,912: five "unpacked" mbarriers more).
//
// Numerics: integer accumulation is exact in any order (|acc| < 2^31 at
// K = 3072; w4 sums 16 acc, |16 acc| < 2^31 for K < 131072, and shifts
// it back exactly); the int32 accumulator converts with __int2float_rn
// (as XLA's convert does) and the epilogue keeps the reference's
// association order;
// the file is built with -fmad=false so no multiply-add is contracted.
// rintf rounds half to even like torch.round / jnp.round. Every output is
// bit-identical to int8_matmul_ref.

#include <type_traits>

#include "mm_common.cuh"
#include "wgmma_gemm.cuh"

namespace {

using tqmm::ColSite;

// K1's epilogue policy (wgmma_gemm.cuh): the column constants are the
// (5, N) rows' fold and site (ColSite); an element takes mm_common.cuh's
// site_out (fold, act_fn, the site level through rint_div_fma, to_i8),
// the steps the MobileBERT layer kernel's emitted payloads take too. OUT
// 3 and 4 are fold and float (1, 2) with a bfloat16 output.
template <int ACT, int OUT>
struct SiteEpi {
  using Col = ColSite;
  using Out = typename std::conditional<
      OUT == 0, int8_t,
      typename std::conditional<(OUT >= 3), __nv_bfloat16, float>::type>::type;
  struct Args {
    const float* vecs;   // (5, N) rows
    const float* scal;   // (1, 2): in_s, in_sh
    float lo, hi, gelu_c;
  };
  const float* vecs;
  int N;
  float in_s, in_sh, lo, hi, gelu_c;

  __device__ __forceinline__ SiteEpi(const Args& a, int n)
      : vecs(a.vecs), N(n), in_s(a.scal[0]), in_sh(a.scal[1]), lo(a.lo),
        hi(a.hi), gelu_c(a.gelu_c) {}
  __device__ __forceinline__ static Col pad() {
    return ColSite{0.0f, 0.0f, 0.0f, 1.0f, 1.0f, 0.0f};
  }
  __device__ __forceinline__ Col col(int n) const {
    return tqmm::col_site(vecs, N, n, in_s, in_sh);
  }
  __device__ __forceinline__ Out apply(int acc, const Col& kc) const {
    if constexpr (OUT >= 3)
      return __float2bfloat16_rn(
          tqmm::site_out<ACT, OUT - 2>(acc, kc, lo, hi, gelu_c));
    else
      return tqmm::site_out<ACT, OUT>(acc, kc, lo, hi, gelu_c);
  }
};

// the policy E, or its packed-int4 instance
template <class E, bool W4>
using Pick = typename std::conditional<W4, tqwg::W4Epi<E>, E>::type;

template <int ACT, bool W4>
cudaError_t launch_act(int out_mode, const CUtensorMap& mx,
                       const CUtensorMap& mw, const float* vecs,
                       const float* scal, void* out, int M, int N, int K,
                       float lo, float hi, float gelu_c, int sms,
                       cudaStream_t st) {
  using tqwg::gemm_launch;
  if constexpr (ACT == 0) {   // bfloat16 outputs: no activation
    if (out_mode == 3) return gemm_launch<Pick<SiteEpi<0, 3>, W4>>(mx, mw, {vecs, scal, lo, hi, gelu_c}, out, M, N, K, sms, st);
    if (out_mode == 4) return gemm_launch<Pick<SiteEpi<0, 4>, W4>>(mx, mw, {vecs, scal, lo, hi, gelu_c}, out, M, N, K, sms, st);
  }
  switch (out_mode) {
    case 0: return gemm_launch<Pick<SiteEpi<ACT, 0>, W4>>(mx, mw, {vecs, scal, lo, hi, gelu_c}, out, M, N, K, sms, st);
    case 1: return gemm_launch<Pick<SiteEpi<ACT, 1>, W4>>(mx, mw, {vecs, scal, lo, hi, gelu_c}, out, M, N, K, sms, st);
    default: return gemm_launch<Pick<SiteEpi<ACT, 2>, W4>>(mx, mw, {vecs, scal, lo, hi, gelu_c}, out, M, N, K, sms, st);
  }
}

template <bool W4>
int matmul(const void* x, const void* w, const void* vecs, const void* scal,
           void* out, int M, int N, int K, int act, int out_mode, float lo,
           float hi, float gelu_c, void* stream) {
  if (act < 0 || act > 5 || out_mode < 0 || out_mode > 4 ||
      (out_mode > 2 && act != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mx, mw;
  int sms = 0;
  cudaError_t e = W4 ? tqwg::gemm_setup_w4(x, w, M, N, K, &mx, &mw, &sms)
                     : tqwg::gemm_setup(x, w, M, N, K, &mx, &mw, &sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  const float* vp = static_cast<const float*>(vecs);
  const float* sp = static_cast<const float*>(scal);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (act) {
    case 0: e = launch_act<0, W4>(out_mode, mx, mw, vp, sp, out, M, N, K, lo, hi, gelu_c, sms, st); break;
    case 1: e = launch_act<1, W4>(out_mode, mx, mw, vp, sp, out, M, N, K, lo, hi, gelu_c, sms, st); break;
    case 2: e = launch_act<2, W4>(out_mode, mx, mw, vp, sp, out, M, N, K, lo, hi, gelu_c, sms, st); break;
    case 3: e = launch_act<3, W4>(out_mode, mx, mw, vp, sp, out, M, N, K, lo, hi, gelu_c, sms, st); break;
    case 4: e = launch_act<4, W4>(out_mode, mx, mw, vp, sp, out, M, N, K, lo, hi, gelu_c, sms, st); break;
    default: e = launch_act<5, W4>(out_mode, mx, mw, vp, sp, out, M, N, K, lo, hi, gelu_c, sms, st); break;
  }
  return static_cast<int>(e);
}

}  // namespace

// act: 0 none, 1 gelu_new, 2 relu, 3 gelu (A-S erf), 4 gelu_poly10, 5 tanh.
// out_mode: 0 emit (int8), 1 fold (f32), 2 float (f32), 3 fold (bf16), 4
// float (bf16; 3 and 4 with act 0 only). [lo, hi]: the output site's
// level bounds (emit: 8-bit).
// x (M, K) and w (N, K) int8, 16-byte aligned, K % 16 == 0, N % 8 == 0.
// Returns the launch's cudaError_t (cudaErrorInvalidValue for arguments
// the kernel does not take, or a tensor map that cannot be encoded).
extern "C" int tq_int8_matmul(const void* x, const void* w, const void* vecs,
                              const void* scal, void* out, int M, int N,
                              int K, int act, int out_mode, float lo,
                              float hi, float gelu_c, void* stream) {
  return matmul<false>(x, w, vecs, scal, out, M, N, K, act, out_mode, lo, hi,
                       gelu_c, stream);
}

// tq_int8_matmul on the (N, K/2) split-half packed int4 weight w (uint8,
// 16-byte aligned), K % 32 == 0.
extern "C" int tq_int8_matmul_w4(const void* x, const void* w,
                                 const void* vecs, const void* scal,
                                 void* out, int M, int N, int K, int act,
                                 int out_mode, float lo, float hi,
                                 float gelu_c, void* stream) {
  return matmul<true>(x, w, vecs, scal, out, M, N, K, act, out_mode, lo, hi,
                      gelu_c, stream);
}
