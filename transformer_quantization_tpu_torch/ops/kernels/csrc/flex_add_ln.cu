// Float-in residual add + LayerNorm with flexible sites.
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
// pointers, either may be null; the flex chains ask for one,
// fused_add_ln for both.
//
// What bounds it on the card: bytes. At H = 768, M = 16384 the attention
// block's add+LN reads 4 + 1 bytes and writes 4 per element (113 MB, 34 us
// at 3.35 TB/s), the FFN block's reads 4 + 4 and writes 1, fused_add_ln
// reads 4 + 4 and writes 1 + 4 (164 MB, 49 us).
//
// Design: add_ln_payload.cu's: one warp per row, eight rows per 256-thread
// block, each lane 4 contiguous columns per 128-column chunk (float4 and
// char4 loads), the row in registers, sums by warp shuffles.
//
// Numerics: association order of the plain version (flex_add_ln_ref),
// -fmad=false, rintf (half to even), IEEE division and square root; both
// row sums accumulate in double and round once to float, so the result
// does not depend on the order of the sum.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = THREADS / 32;

struct Sites {
  float res_s, res_sh, ln_s, ln_sh;
};

__device__ __forceinline__ Sites sites_at(const float* __restrict__ scal,
                                          const float* __restrict__ lnv,
                                          int H, int col) {
  if (lnv == nullptr) return {scal[4], scal[5], scal[6], scal[7]};
  return {lnv[col], lnv[H + col], lnv[2 * H + col], lnv[3 * H + col]};
}

template <int NCH>  // H = NCH * 128
__global__ void __launch_bounds__(THREADS)
    flex_add_ln_kernel(const float* __restrict__ y, const void* __restrict__ r,
                       int r_f32, const float* __restrict__ gb,
                       const float* __restrict__ scal,
                       const float* __restrict__ lnv,
                       int8_t* __restrict__ out8, float* __restrict__ outf,
                       int M, float eps, int res_quant, float res_lo,
                       float res_hi, float ln_lo, float ln_hi) {
  constexpr int H = NCH * 128;
  const int row = blockIdx.x * ROWS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const float r_s = scal[2], r_sh = scal[3];
  const size_t base = (size_t)row * H;

  float x[NCH * 4];
  double sum = 0.0, sumsq = 0.0;
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const int col = c * 128 + lane * 4;
    const float4 yv = *reinterpret_cast<const float4*>(y + base + col);
    const float ys[4] = {yv.x, yv.y, yv.z, yv.w};
    float rs[4];
    if (r_f32) {
      const float4 rv = *reinterpret_cast<const float4*>(
          static_cast<const float*>(r) + base + col);
      rs[0] = rv.x; rs[1] = rv.y; rs[2] = rv.z; rs[3] = rv.w;
    } else {
      const char4 rv = *reinterpret_cast<const char4*>(
          static_cast<const int8_t*>(r) + base + col);
      const int8_t rb[4] = {rv.x, rv.y, rv.z, rv.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        rs[e] = r_s * (static_cast<float>(rb[e]) + r_sh);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v = ys[e] + rs[e];
      if (res_quant) {
        const Sites st = sites_at(scal, lnv, H, col + e);
        const float inv_res = 1.0f / st.res_s;
        const float lvl = fminf(
            fmaxf(rintf(v * inv_res) - st.res_sh, res_lo), res_hi);
        v = st.res_s * (lvl + st.res_sh);
      }
      x[c * 4 + e] = v;
      sum += static_cast<double>(v);
      sumsq += static_cast<double>(v * v);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, o);
    sumsq += __shfl_xor_sync(0xffffffffu, sumsq, o);
  }
  const float mean = static_cast<float>(sum) / static_cast<float>(H);
  const float ms = static_cast<float>(sumsq) / static_cast<float>(H);
  const float var = fmaxf(ms - mean * mean, 0.0f);
  const float rstd = 1.0f / sqrtf(var + eps);
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const int col = c * 128 + lane * 4;
    float lv[4], fv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const Sites st = sites_at(scal, lnv, H, col + e);
      const float z = (x[c * 4 + e] - mean) * rstd * gb[col + e] +
                      gb[H + col + e];
      lv[e] = fminf(fmaxf(rintf(z / st.ln_s) - st.ln_sh, ln_lo), ln_hi);
      fv[e] = st.ln_s * (lv[e] + st.ln_sh);
    }
    if (out8 != nullptr)
      *reinterpret_cast<char4*>(out8 + base + col) = make_char4(
          static_cast<int8_t>(__float2int_rn(lv[0])),
          static_cast<int8_t>(__float2int_rn(lv[1])),
          static_cast<int8_t>(__float2int_rn(lv[2])),
          static_cast<int8_t>(__float2int_rn(lv[3])));
    if (outf != nullptr)
      *reinterpret_cast<float4*>(outf + base + col) =
          make_float4(fv[0], fv[1], fv[2], fv[3]);
  }
}

}  // namespace

// y: (M, H) f32; r: (M, H) int8 payload (r_f32 = 0, with scal[2:4]) or f32
// value (r_f32 = 1); gb: (2, H) [gamma; beta]; scal: 8 f32 [y_s, y_sh, r_s,
// r_sh, res_s, res_sh, ln_s, ln_sh]; lnv: (4, H) per-column site rows or
// null; out8: (M, H) int8 and / or outf: (M, H) f32, either may be null.
// H % 128 == 0, H <= 1024. Returns the launch's cudaError_t.
extern "C" int tq_flex_add_ln(const void* y, const void* r, int r_f32,
                              const void* gb, const void* scal,
                              const void* lnv, void* out8, void* outf, int M,
                              int H, float eps, int res_quant, float res_lo,
                              float res_hi, float ln_lo, float ln_hi,
                              void* stream) {
  const float* yp = static_cast<const float*>(y);
  const float* g = static_cast<const float*>(gb);
  const float* s = static_cast<const float*>(scal);
  const float* lv = static_cast<const float*>(lnv);
  int8_t* o8 = static_cast<int8_t*>(out8);
  float* of = static_cast<float*>(outf);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((M + ROWS - 1) / ROWS);
#define TQ_FLEX_LN(NCH)                                                     \
  flex_add_ln_kernel<NCH><<<grid, THREADS, 0, st>>>(                        \
      yp, r, r_f32, g, s, lv, o8, of, M, eps, res_quant, res_lo, res_hi,    \
      ln_lo, ln_hi);                                                        \
  break
  switch (H) {
    case 128: TQ_FLEX_LN(1);
    case 256: TQ_FLEX_LN(2);
    case 384: TQ_FLEX_LN(3);
    case 512: TQ_FLEX_LN(4);
    case 640: TQ_FLEX_LN(5);
    case 768: TQ_FLEX_LN(6);
    case 896: TQ_FLEX_LN(7);
    case 1024: TQ_FLEX_LN(8);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TQ_FLEX_LN
  return static_cast<int>(cudaGetLastError());
}
