// Float-in residual add + LayerNorm with flexible sites (K5).
//
// Replaces: transformer_quantization_tpu/ops/pallas/engine_kernels.py
//   the add+LN tails of the flex forms of int8_attn_ln (_attn_mega_kernel)
//   and int8_ffn_ln (_ffn_kernel): _ln_body with _site_vals, the sites of
//   the mixed-precision and PEG recipes; and fused_add_ln (_add_ln_kernel),
//   the add+LN of the non-payload residual route: a float32 residual,
//   scalar 8-bit sites and both outputs.
//
//   x    = y + r_s * (r8 + r_sh)     (residual an int8 payload)
//        | y + r                     (residual a float32 value edge)
//   x    = res_s * (clip(rint(x * (1/res_s)) - res_sh, res_lo, res_hi)
//                   + res_sh)                           (when res_quant)
//   mean = sum(x)/H, var = max(sum(x*x)/H - mean^2, 0)    (one pass)
//   z    = (x - mean) * (1 / sqrt(var + eps)) * gamma + beta
//   lvl  = clip(rint(z / ln_s) - ln_sh, ln_lo, ln_hi)
//   out  = int8 lvl (payload) and / or ln_s * (lvl + ln_sh) (float edge)
//
// The res and ln sites are scalars (scal[4:8]) or, for per-column (PEG)
// sites, the (4, H) rows lnv = [res_s; res_sh; ln_s; ln_sh], on grids of
// up to 16 bits ([lo, hi] per site). The two outputs are separate
// pointers; the flex chains ask for one, fused_add_ln (a float32
// residual, scalar sites) for both, the only form built with both. The
// instances of add_ln.cuh's template with a float32 y; the design and the
// numerics are there.

#include "add_ln.cuh"

namespace {

// both outputs only for fused_add_ln's form (a float32 residual, scalar
// sites): no other caller asks for them
template <typename RT, bool COL>
int by_outputs(const tqln::Args& a, int H, cudaStream_t st) {
  if (a.out8 != nullptr && a.outf != nullptr) {
    if constexpr (sizeof(RT) == 4 && !COL)
      return tqln::launch<float, RT, COL, tqln::OUT_I8 | tqln::OUT_F32>(a, H,
                                                                        st);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a.out8 != nullptr)
    return tqln::launch<float, RT, COL, tqln::OUT_I8>(a, H, st);
  if (a.outf != nullptr)
    return tqln::launch<float, RT, COL, tqln::OUT_F32>(a, H, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename RT>
int by_sites(const tqln::Args& a, int H, cudaStream_t st) {
  return a.lnv != nullptr ? by_outputs<RT, true>(a, H, st)
                          : by_outputs<RT, false>(a, H, st);
}

}  // namespace

// fused_add_ln at engine_dtype bf16: y and r (M, H) bf16 (the float32
// residual stream's bfloat16 form), scalar sites (scal as below), out8:
// (M, H) int8 and outf: (M, H) bf16, both written. H % 128 == 0, H <=
// 1024. Returns the launch's cudaError_t.
extern "C" int tq_fused_add_ln_bf16(const void* y, const void* r,
                                    const void* gb, const void* scal,
                                    void* out8, void* outf, int M, int H,
                                    float eps, int res_quant, float res_lo,
                                    float res_hi, float ln_lo, float ln_hi,
                                    void* stream) {
  if (out8 == nullptr || outf == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const tqln::Args a{y, r, static_cast<const float*>(gb),
                     static_cast<const float*>(scal), nullptr,
                     static_cast<int8_t*>(out8), static_cast<float*>(outf),
                     M, eps, res_quant, res_lo, res_hi, ln_lo, ln_hi};
  return tqln::launch<__nv_bfloat16, __nv_bfloat16, false,
                      tqln::OUT_I8 | tqln::OUT_BF16>(
      a, H, static_cast<cudaStream_t>(stream));
}

// y: (M, H) f32; r: (M, H) int8 payload (r_f32 = 0, with scal[2:4]) or f32
// value (r_f32 = 1); gb: (2, H) [gamma; beta]; scal: 8 f32 [y_s, y_sh, r_s,
// r_sh, res_s, res_sh, ln_s, ln_sh]; lnv: (4, H) per-column site rows or
// null; out8: (M, H) int8 and / or outf: (M, H) f32 (both only with r_f32
// and no lnv), either may be null.
// H % 128 == 0, H <= 1024. Returns the launch's cudaError_t.
extern "C" int tq_flex_add_ln(const void* y, const void* r, int r_f32,
                              const void* gb, const void* scal,
                              const void* lnv, void* out8, void* outf, int M,
                              int H, float eps, int res_quant, float res_lo,
                              float res_hi, float ln_lo, float ln_hi,
                              void* stream) {
  const tqln::Args a{y, r, static_cast<const float*>(gb),
                     static_cast<const float*>(scal),
                     static_cast<const float*>(lnv),
                     static_cast<int8_t*>(out8), static_cast<float*>(outf),
                     M, eps, res_quant, res_lo, res_hi, ln_lo, ln_hi};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return r_f32 ? by_sites<float>(a, H, st) : by_sites<int8_t>(a, H, st);
}
