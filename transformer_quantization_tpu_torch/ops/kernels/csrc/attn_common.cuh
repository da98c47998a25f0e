// The payload attention's arithmetic as the MobileBERT layer kernel
// (int8_mb_layer.cu, K8) runs it on wgmma fragments: the attention
// kernel's (int8_attention.cu, K2 / K7, on mma.sync) forms and order,
// written out again here because moving K7's own functions into this
// header changed three of its six instances' machine code. A thread
// holds its scores as the m16n8 fragments of two rows (g, g + 8) and of
// key pairs 8 j + 2 t, which mma.sync's C fragment and wgmma's
// accumulator share. tests/test_torch_mb_layer.py emulates the forms.
//
//   scores = q8 . k8 (int32) + q_sh*ksum + k_sh*qsum + d*q_sh*k_sh
//   level  = clip(rint(scores * qk_over_sc) - sc_sh, -128, 127)
//   s2     = a * level + (mask*log2e + a*sc_sh)    (a = sc_s/sqrt(d)*log2e)
//   e      = exp2(s2 [- rowmax])      probs = clip(rint(e*(1/p_s)/sum) - p_sh)
//   ctx    = p8 . v8 (int32) + p_sh*vsum + v_sh*psum + T*p_sh*v_sh
//   out    = clip(rint(ctx * p_s*v_s/c_s) - c_sh, -128, 127)
//
// The int32 sums convert exactly by the 1.5 * 2^23 bias (|x| <= 2^22).
// When every shift is an integer of magnitude at most 128 (every 8-bit
// site's), a kernel takes the integer path: each sum of the chain is an
// integer below 2^23, so the scores (and so the context) come as the bits
// of (1.5 * 2^23 + q.k + q_sh*ksum) less (1.5 * 2^23 - k_sh*qsum -
// d*q_sh*k_sh), two instructions for the reference's three exact adds;
// and a site's level is taken on the biased value: clip((x + 1.5 * 2^23)
// - (1.5 * 2^23 + sh)) for the scores, and for the probs and the context
// clip((x + 1.5 * 2^23) - sh) between 1.5 * 2^23 - 128 and + 127, whose
// low byte is the payload (exact for |x| < 2^22; beyond it both sides
// saturate alike, the biased sum being monotone). Other shifts take the
// reference's formulas with rintf.
//
// Numerics: the association order of int8_attention_ref, -fmad=false,
// exp2f as torch.exp2 calls it on the card; the softmax denominator
// accumulates in double and rounds once to float, as the plain version
// does (two double sums taken in different orders may differ in their
// last bits, which moves the float only in the rarest of ties); a level
// off the integers (a shift that is not one) converts to int8 by
// truncation, as the plain version's cast does. The site scalars scal (12
// f32): [q_s, q_sh, k_s, k_sh, v_s, v_sh, sc_s, sc_sh, p_s, p_sh, c_s,
// c_sh].

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tqattn {

constexpr float BIAS = 12582912.0f;      // 1.5 * 2^23
constexpr int BIAS_BITS = 0x4B400000;    // its bits
constexpr float SHIFT_MAX = 128.0f;      // see small_int
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned ONES = 0x01010101u;   // four s8 ones

// int32 -> float, exact for |v| < 2^22 (every sum and product here)
__device__ __forceinline__ float i2f(int v) {
  return __int_as_float(v + BIAS_BITS) - BIAS;
}

__device__ __forceinline__ float clip8(float r) {
  return fminf(fmaxf(r, -128.0f), 127.0f);
}

// An 8-bit site's level clip(rint(x) - sh, -128, 127) as a float. INT:
// sh_b = 1.5 * 2^23 + sh (sh an integer; see the note).
template <bool INT>
__device__ __forceinline__ float site_lvl(float x, float sh, float sh_b) {
  return INT ? clip8((x + BIAS) - sh_b) : clip8(rintf(x) - sh);
}

// The same level as an int8 payload, in the low byte of the result.
template <bool INT>
__device__ __forceinline__ uint32_t site_bits(float x, float sh) {
  if (INT)
    return __float_as_uint(
        fminf(fmaxf((x + BIAS) - sh, BIAS - 128.0f), BIAS + 127.0f));
  // a level off the integers (a shift that is not one) truncates toward
  // zero, as the reference's conversion to int8 does
  return static_cast<uint32_t>(__float2int_rz(clip8(rintf(x) - sh)));
}

// the low bytes of a, b, c, d as one word [a, b, c, d]
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

// The site scalars in the forms the chain uses, each computed as
// int8_attention_ref computes it.
struct Site {
  float q_sh, k_sh, v_sh, sc_sh, p_sh, c_sh, sc_b;
  float qk_over_sc, dqk, a, ash, inv_ps, pv_over_c, tpv;
};

template <int D>
__device__ __forceinline__ Site site_of(const float* scal, int T,
                                        float rsqrt_d, float log2e) {
  Site s;
  s.q_sh = scal[1];
  s.k_sh = scal[3];
  s.v_sh = scal[5];
  s.sc_sh = scal[7];
  s.p_sh = scal[9];
  s.c_sh = scal[11];
  s.sc_b = BIAS + s.sc_sh;
  s.qk_over_sc = (scal[0] * scal[2]) * (1.0f / scal[6]);
  s.dqk = (static_cast<float>(D) * s.q_sh) * s.k_sh;
  s.a = (scal[6] * rsqrt_d) * log2e;
  s.ash = s.a * s.sc_sh;
  s.inv_ps = 1.0f / scal[8];
  s.pv_over_c = (scal[8] * scal[4]) * (1.0f / scal[10]);
  s.tpv = (static_cast<float>(T) * s.p_sh) * s.v_sh;
  return s;
}

// Whether a shift lets the kernel take the integer path: an integer of
// magnitude at most 128, as every 8-bit site's (128 - zero point, or 0).
// Then every sum of the chain is an integer below 2^23, exact in float
// whatever its order (|q.k| <= 64 * 2^14, q_sh * ksum <= 128 * 64 * 128,
// |p.v| <= 128 * 2^14, p_sh * vsum <= 128 * 128 * 128, ...).
__device__ __forceinline__ bool small_int(float sh) {
  return fabsf(sh) <= SHIFT_MAX && rintf(sh) == sh;
}

// A shift times a payload sum (q_sh * ksum of a key, p_sh * vsum of a head
// dim); INT: the int32 product plus the bias's bits, in a float's bits
// (see softmax and ctx_bits).
template <bool INT>
__device__ __forceinline__ float shift_term(float sh, int sum) {
  return INT ? __int_as_float(static_cast<int>(sh) * sum + BIAS_BITS)
             : sh * i2f(sum);
}

// The scores site, the exp2 softmax and the probs site on a thread's
// score fragments (acc[ni][r]: key 8 ni + 2 t + (r & 1) of row g (r < 2)
// or g + 8), the rows' q sums in qs[0] / qs[2], and each key pair's
// constants at colp (a float4: the two keys' shift_term(q_sh, ksum), then
// their mask * log2e + a * sc_sh); the probs payload comes out as p.v's A
// fragments: pa[c] for keys 32c .. 32c+31, each 16 of them in the order
// (n-tile pair, lane t, column): position 4t + u holds key 8 (u >> 1) +
// 2t + (u & 1). skip: skip_max (no row max is taken off: e = exp2(s2 -
// 0), which is exp2(s2) bit for bit).
template <int NT, bool INT>
__device__ __forceinline__ void softmax(const int (&acc)[NT][4],
                                        const int (&qs)[4], const float* colp,
                                        const Site& s, int t, bool skip,
                                        unsigned (&pa)[NT / 4][4]) {
  const float qk_lo = s.k_sh * i2f(qs[0]);
  const float qk_hi = s.k_sh * i2f(qs[2]);
  // INT: scores = (acc + q_sh*ksum) + (k_sh*qsum + d*q_sh*k_sh), integers,
  // as the bits of (1.5 * 2^23 + the first) less (1.5 * 2^23 - the second)
  const float rb_lo = BIAS - (qk_lo + s.dqk);
  const float rb_hi = BIAS - (qk_hi + s.dqk);
  float sv[NT][4];
#pragma unroll
  for (int ni = 0; ni < NT; ++ni) {
    const float4 cv = *reinterpret_cast<const float4*>(colp + 4 * (ni * 4 + t));
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float kq = (r & 1) ? cv.y : cv.x;
      const float m2 = (r & 1) ? cv.w : cv.z;
      const float scr =
          INT ? __int_as_float(acc[ni][r] + __float_as_int(kq)) -
                    (r < 2 ? rb_lo : rb_hi)
              : ((i2f(acc[ni][r]) + kq) + (r < 2 ? qk_lo : qk_hi)) + s.dqk;
      sv[ni][r] =
          s.a * site_lvl<INT>(scr * s.qk_over_sc, s.sc_sh, s.sc_b) + m2;
    }
  }
  float m_lo = 0.0f, m_hi = 0.0f;
  if (!skip) {
    m_lo = __int_as_float(0xff800000);  // -inf
    m_hi = m_lo;
    // four running maxima a row half from -inf (all-NaN gives -inf), to
    // shorten the chains
    float mx[2][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) mx[0][j] = mx[1][j] = m_lo;
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) {
      mx[0][ni & 3] = fmaxf(mx[0][ni & 3], fmaxf(sv[ni][0], sv[ni][1]));
      mx[1][ni & 3] = fmaxf(mx[1][ni & 3], fmaxf(sv[ni][2], sv[ni][3]));
    }
    m_lo = fmaxf(fmaxf(mx[0][0], mx[0][1]), fmaxf(mx[0][2], mx[0][3]));
    m_hi = fmaxf(fmaxf(mx[1][0], mx[1][1]), fmaxf(mx[1][2], mx[1][3]));
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      m_lo = fmaxf(m_lo, __shfl_xor_sync(FULL, m_lo, o));
      m_hi = fmaxf(m_hi, __shfl_xor_sync(FULL, m_hi, o));
    }
  }
  // e = exp2(s2 - m) (m = 0 under skip_max); the row sums in double, two
  // partial sums a row half to shorten the add chains
  double d[2][2] = {{0.0, 0.0}, {0.0, 0.0}};
#pragma unroll
  for (int ni = 0; ni < NT; ++ni) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float e = exp2f(sv[ni][r] - (r < 2 ? m_lo : m_hi));
      sv[ni][r] = e;
      d[r >> 1][ni & 1] += static_cast<double>(e);
    }
  }
  double d_lo = d[0][0] + d[0][1], d_hi = d[1][0] + d[1][1];
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    d_lo += __shfl_xor_sync(FULL, d_lo, o);
    d_hi += __shfl_xor_sync(FULL, d_hi, o);
  }
  const float w_lo = s.inv_ps / static_cast<float>(d_lo);
  const float w_hi = s.inv_ps / static_cast<float>(d_hi);
#pragma unroll
  for (int c = 0; c < NT / 4; ++c) {
    uint32_t u[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        u[n][r] = site_bits<INT>(sv[4 * c + n][r] * (r < 2 ? w_lo : w_hi),
                                 s.p_sh);
    pa[c][0] = pack4(u[0][0], u[0][1], u[1][0], u[1][1]);
    pa[c][1] = pack4(u[0][2], u[0][3], u[1][2], u[1][3]);
    pa[c][2] = pack4(u[2][0], u[2][1], u[3][0], u[3][1]);
    pa[c][3] = pack4(u[2][2], u[2][3], u[3][2], u[3][3]);
  }
}

// One context element's payload (low byte) from its p.v sum acc, the head
// dim's pvd = shift_term(p_sh, vsum) and the row's terms: vp = v_sh *
// psum and rb = 1.5 * 2^23 - (vp + T*p_sh*v_sh). INT: ctx = (p.v +
// p_sh*vsum) + (v_sh*psum + T*p_sh*v_sh), as in softmax.
template <bool INT>
__device__ __forceinline__ uint32_t ctx_bits(int acc, float pvd, float rb,
                                             float vp, const Site& s) {
  const float ctx = INT ? __int_as_float(acc + __float_as_int(pvd)) - rb
                        : ((i2f(acc) + pvd) + vp) + s.tpv;
  return site_bits<INT>(ctx * s.pv_over_c, s.c_sh);
}

}  // namespace tqattn
