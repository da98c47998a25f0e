// The attention of one (sequence, head) on int8 tensor cores inside the
// MobileBERT layer kernel (int8_mb_layer.cu): the counterpart of the TPU
// kernels' _attn_row (dots='i8'). The standalone attention kernel
// (int8_attention.cu) computes the same function with a design of its own
// and agrees with this one bit for bit.
//
//   scores = q8 . k8 (int32) + q_sh*ksum + k_sh*qsum + d*q_sh*k_sh
//   level  = clip(rint(scores * qk_over_sc) - sc_sh, -128, 127)
//   s2     = a * level + (mask*log2e + a*sc_sh)    (a = sc_s/sqrt(d)*log2e)
//   e      = exp2(s2 [- rowmax])      probs = clip(rint(e*(1/p_s)/sum) - p_sh)
//   ctx    = p8 . v8 (int32) + p_sh*vsum + v_sh*psum + T*p_sh*v_sh
//   out    = clip(rint(ctx * p_s*v_s/c_s) - c_sh, -128, 127)
//
// Each warp owns 16 query rows end to end: q.k^T (mma.sync m16n8k32) into
// registers, the whole softmax chain on those registers with the row max /
// row sum across the four lanes that share a row, the probs payload into
// shared memory, and p.v on tensor cores. The (T, T) scores never reach
// shared or device memory. skip_max is honoured exactly as given.
//
// Numerics: the association order of int8_attention_ref, -fmad=false,
// rintf (half to even), exp2f as torch.exp2 calls it on the card; the
// softmax denominator accumulates in double and rounds once to float, as
// the plain version does, so its value does not depend on the order of
// the sum. The site scalars scal (12 f32): [q_s, q_sh, k_s, k_sh, v_s,
// v_sh, sc_s, sc_sh, p_s, p_sh, c_s, c_sh].

#pragma once

#include "mm_common.cuh"

namespace tqattn {

using tqmm::THREADS;

__device__ __forceinline__ float clip8(float r) {
  return fminf(fmaxf(r, -128.0f), 127.0f);
}

// the scores-site multiplier a = sc_s / sqrt(d) * log2(e)
__device__ __forceinline__ float scores_a(const float* scal, float rsqrt_d,
                                          float log2e) {
  return (scal[6] * rsqrt_d) * log2e;
}

// mask2[j] = mask[j] * log2(e) + a * sc_sh for the T keys of a sequence
template <int T>
__device__ __forceinline__ void mask_row(float* mask2, const float* mask,
                                         const float* scal, float rsqrt_d,
                                         float log2e) {
  const float a = scores_a(scal, rsqrt_d, log2e);
  for (int j = threadIdx.x; j < T; j += THREADS)
    mask2[j] = mask[j] * log2e + a * scal[7];
}

// One head. In shared memory: q (T x D, row stride ldq), k (T x D, ldk),
// v transposed (D x T, ldv), mask2 (T), and scratch qsum / ksum (T), vsum
// (D) and the probs sp (T x (T + 16)), which may alias q and k (they are
// no longer read when the probs are written). Context row i, dim dd goes
// to out[i * ldo + dd] (shared or device memory). All THREADS threads
// call it; it starts by reading the payloads, so the caller has them in
// place and synchronised. It does not synchronise after its last write.
template <int T, int D>
__device__ __forceinline__ void attn_head(
    const int8_t* sq, int ldq, const int8_t* sk, int ldk, const int8_t* svt,
    int ldv, int8_t* sp, const float* mask2, float* qsum, float* ksum,
    float* vsum, const float* scal, float rsqrt_d, float log2e,
    int skip_max, int8_t* out, size_t ldo) {
  static_assert(T % 32 == 0 && T <= 128, "T must be 32, 64, 96 or 128");
  static_assert(D % 32 == 0, "head_dim must be a multiple of 32");
  constexpr int LDP = T + 16;   // probs smem row stride (bytes)
  constexpr int NT = T / 8;     // phase-1 n-tiles (key columns)
  constexpr int ND = D / 8;     // phase-3 n-tiles (head dims)
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const float q_s = scal[0], q_sh = scal[1], k_s = scal[2], k_sh = scal[3];
  const float v_s = scal[4], v_sh = scal[5], sc_s = scal[6], sc_sh = scal[7];
  const float p_s = scal[8], p_sh = scal[9], c_s = scal[10], c_sh = scal[11];
  const float a = scores_a(scal, rsqrt_d, log2e);

  // ---- payload sums: q and k per row, v per head dim ----
  for (int task = tid; task < 2 * T + D; task += THREADS) {
    int s = 0;
    if (task < 2 * T) {
      const int8_t* row = task < T ? sq + task * ldq : sk + (task - T) * ldk;
      for (int e = 0; e < D; ++e) s += row[e];
      (task < T ? qsum[task] : ksum[task - T]) = static_cast<float>(s);
    } else {
      const int8_t* row = svt + (task - 2 * T) * ldv;
      for (int e = 0; e < T; ++e) s += row[e];
      vsum[task - 2 * T] = static_cast<float>(s);
    }
  }
  __syncthreads();

  // ---- phase 1: raw scores of this warp's 16 query rows ----
  const bool active = warp < T / 16;
  const int i0 = warp * 16;
  int acc[NT][4];
#pragma unroll
  for (int ni = 0; ni < NT; ++ni)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[ni][r] = 0;
  if (active) {
#pragma unroll
    for (int kk = 0; kk < D; kk += 32) {
      unsigned af[4];
      tqmm::load_a_frag(af, sq, ldq, i0, kk, g, t);
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        unsigned bf[2];
        tqmm::load_b_frag(bf, sk, ldk, ni * 8, kk, g, t);
        tqmm::mma_k32(acc[ni], af, bf);
      }
    }
  }
  __syncthreads();  // q/k no longer read: the probs may overwrite them

  // ---- phase 2: scores site, exp2 softmax, probs payload ----
  float psum_lo = 0.0f, psum_hi = 0.0f;
  if (active) {
    const float qk_over_sc = (q_s * k_s) * (1.0f / sc_s);
    const float dqk = (static_cast<float>(D) * q_sh) * k_sh;
    const float qs_lo = qsum[i0 + g];
    const float qs_hi = qsum[i0 + g + 8];
    float sv[NT][4];
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = ni * 8 + t * 2 + (r & 1);
        const float qs = r < 2 ? qs_lo : qs_hi;
        const float scr =
            ((__int2float_rn(acc[ni][r]) + q_sh * ksum[j]) + k_sh * qs) + dqk;
        const float lvl = clip8(rintf(scr * qk_over_sc) - sc_sh);
        sv[ni][r] = a * lvl + mask2[j];
      }
    }
    float m_lo = 0.0f, m_hi = 0.0f;
    if (!skip_max) {
      m_lo = __int_as_float(0xff800000);  // -inf
      m_hi = m_lo;
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        m_lo = fmaxf(m_lo, fmaxf(sv[ni][0], sv[ni][1]));
        m_hi = fmaxf(m_hi, fmaxf(sv[ni][2], sv[ni][3]));
      }
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        m_lo = fmaxf(m_lo, __shfl_xor_sync(0xffffffffu, m_lo, o));
        m_hi = fmaxf(m_hi, __shfl_xor_sync(0xffffffffu, m_hi, o));
      }
    }
    double d_lo = 0.0, d_hi = 0.0;
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float e = skip_max ? exp2f(sv[ni][r])
                                 : exp2f(sv[ni][r] - (r < 2 ? m_lo : m_hi));
        sv[ni][r] = e;
        if (r < 2) d_lo += static_cast<double>(e);
        else d_hi += static_cast<double>(e);
      }
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      d_lo += __shfl_xor_sync(0xffffffffu, d_lo, o);
      d_hi += __shfl_xor_sync(0xffffffffu, d_hi, o);
    }
    const float w_lo = (1.0f / p_s) / static_cast<float>(d_lo);
    const float w_hi = (1.0f / p_s) / static_cast<float>(d_hi);
    int ps_lo = 0, ps_hi = 0;
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + g + (r < 2 ? 0 : 8);
        const int j = ni * 8 + t * 2 + (r & 1);
        const float lvl =
            clip8(rintf(sv[ni][r] * (r < 2 ? w_lo : w_hi)) - p_sh);
        const int q = __float2int_rn(lvl);
        if (r < 2) ps_lo += q; else ps_hi += q;
        sp[i * LDP + j] = static_cast<int8_t>(q);
      }
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      ps_lo += __shfl_xor_sync(0xffffffffu, ps_lo, o);
      ps_hi += __shfl_xor_sync(0xffffffffu, ps_hi, o);
    }
    psum_lo = static_cast<float>(ps_lo);
    psum_hi = static_cast<float>(ps_hi);
  }
  __syncthreads();

  // ---- phase 3: context = probs . v, context payload ----
  if (active) {
    int acc2[ND][4];
#pragma unroll
    for (int ni = 0; ni < ND; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc2[ni][r] = 0;
#pragma unroll
    for (int kk = 0; kk < T; kk += 32) {
      unsigned af[4];
      tqmm::load_a_frag(af, sp, LDP, i0, kk, g, t);
#pragma unroll
      for (int ni = 0; ni < ND; ++ni) {
        unsigned bf[2];
        tqmm::load_b_frag(bf, svt, ldv, ni * 8, kk, g, t);
        tqmm::mma_k32(acc2[ni], af, bf);
      }
    }
    const float pv_over_c = (p_s * v_s) * (1.0f / c_s);
    const float tpv = (static_cast<float>(T) * p_sh) * v_sh;
#pragma unroll
    for (int ni = 0; ni < ND; ++ni) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + g + (r < 2 ? 0 : 8);
        const int dd = ni * 8 + t * 2 + (r & 1);
        const float ctx = ((__int2float_rn(acc2[ni][r]) + p_sh * vsum[dd]) +
                           v_sh * (r < 2 ? psum_lo : psum_hi)) + tpv;
        const float lvl = clip8(rintf(ctx * pv_over_c) - c_sh);
        out[(size_t)i * ldo + dd] = static_cast<int8_t>(__float2int_rn(lvl));
      }
    }
  }
}

}  // namespace tqattn
