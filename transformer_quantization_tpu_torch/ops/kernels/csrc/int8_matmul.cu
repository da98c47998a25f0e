// Payload matmul with the dequant fold, activation and per-column output
// site in the epilogue (K1), for Hopper.
//
// Replaces: transformer_quantization_tpu/ops/pallas/engine_kernels.py
//   int8_matmul (_mm_kernel / _mm_body / _int_dot), and the matmul halves
//   of int8_matmul_add_ln, int8_ffn_ln, int8_attn_ln and int8_layer_ln.
//
//   acc = x8 (M, K) @ w8 (N, K)^T                 exact int32
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
// Limits: K % 16 == 0 (TMA's 16-byte row stride), N % 8 == 0, 16-byte
// aligned operands; M, N and K ragged against the tiles.
// Resources (nvcc 12.9 -Xptxas -v, every instance): 168 registers a
// thread at launch, moved by setmaxnreg to 40 (producer) / 232
// (consumers), no spills; 203,872 bytes of dynamic shared memory.
//
// Numerics: integer accumulation is exact in any order (|acc| < 2^31 at
// K = 3072); the int32 accumulator converts with __int2float_rn (as XLA's
// convert does) and the epilogue keeps the reference's association order;
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
// the steps the MobileBERT layer kernel's emitted payloads take too.
template <int ACT, int OUT>
struct SiteEpi {
  using Col = ColSite;
  using Out = typename std::conditional<OUT == 0, int8_t, float>::type;
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
    return tqmm::site_out<ACT, OUT>(acc, kc, lo, hi, gelu_c);
  }
};

template <int ACT>
cudaError_t launch_act(int out_mode, const CUtensorMap& mx,
                       const CUtensorMap& mw, const float* vecs,
                       const float* scal, void* out, int M, int N, int K,
                       float lo, float hi, float gelu_c, int sms,
                       cudaStream_t st) {
  using tqwg::gemm_launch;
  switch (out_mode) {
    case 0: return gemm_launch<SiteEpi<ACT, 0>>(mx, mw, {vecs, scal, lo, hi, gelu_c}, out, M, N, K, sms, st);
    case 1: return gemm_launch<SiteEpi<ACT, 1>>(mx, mw, {vecs, scal, lo, hi, gelu_c}, out, M, N, K, sms, st);
    default: return gemm_launch<SiteEpi<ACT, 2>>(mx, mw, {vecs, scal, lo, hi, gelu_c}, out, M, N, K, sms, st);
  }
}

}  // namespace

// act: 0 none, 1 gelu_new, 2 relu. out_mode: 0 emit (int8), 1 fold (f32),
// 2 float (f32). [lo, hi]: the output site's level bounds (emit: 8-bit).
// x (M, K) and w (N, K) int8, 16-byte aligned, K % 16 == 0, N % 8 == 0.
// Returns the launch's cudaError_t (cudaErrorInvalidValue for arguments
// the kernel does not take, or a tensor map that cannot be encoded).
extern "C" int tq_int8_matmul(const void* x, const void* w, const void* vecs,
                              const void* scal, void* out, int M, int N,
                              int K, int act, int out_mode, float lo,
                              float hi, float gelu_c, void* stream) {
  if (act < 0 || act > 2 || out_mode < 0 || out_mode > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mx, mw;
  int sms = 0;
  cudaError_t e = tqwg::gemm_setup(x, w, M, N, K, &mx, &mw, &sms);
  if (e != cudaSuccess) return static_cast<int>(e);
  const float* vp = static_cast<const float*>(vecs);
  const float* sp = static_cast<const float*>(scal);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (act) {
    case 0: e = launch_act<0>(out_mode, mx, mw, vp, sp, out, M, N, K, lo, hi, gelu_c, sms, st); break;
    case 1: e = launch_act<1>(out_mode, mx, mw, vp, sp, out, M, N, K, lo, hi, gelu_c, sms, st); break;
    default: e = launch_act<2>(out_mode, mx, mw, vp, sp, out, M, N, K, lo, hi, gelu_c, sms, st); break;
  }
  return static_cast<int>(e);
}
