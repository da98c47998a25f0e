// Fused int8 attention over the q|k|v payload, one block per (batch row,
// head).
//
// Replaces: transformer_quantization_tpu/ops/pallas/engine_kernels.py
//   int8_attention via _attention_call / _attn_kernel / _attn_row
//   (dots='i8'), and the attention stage of int8_layer_ln.
//
//   scores = q8 . k8 (int32) + q_sh*ksum + k_sh*qsum + d*q_sh*k_sh
//   level  = clip(rint(scores * qk_over_sc) - sc_sh, -128, 127)
//   s2     = a * level + (mask*log2e + a*sc_sh)    (a = sc_s/sqrt(d)*log2e)
//   e      = exp2(s2 [- rowmax])      probs = clip(rint(e*(1/p_s)/sum) - p_sh)
//   ctx    = p8 . v8 (int32) + p_sh*vsum + v_sh*psum + T*p_sh*v_sh
//   out    = clip(rint(ctx * p_s*v_s/c_s) - c_sh, -128, 127)
//
// What bounds it on the card: bytes. At B=128, S=128, 12 heads the call
// does 6.4 GOP against 50 MB of q|k|v in and context out, about 130 int8
// operations per byte, below the H100's ~590 op/byte ridge; the softmax
// chain (an exp2 per score) is the other cost.
//
// Design: each block loads its head's q and k (T x 64 int8) and v
// (transposed, 64 x T) into shared memory once, then each warp owns 16
// query rows end to end: q.k^T on int8 tensor cores (mma.sync m16n8k32)
// into registers, the whole phase-2 chain on those registers with the row
// max / row sum across the four lanes that share a row, the probs payload
// into shared memory (reusing the q/k space), and p.v on tensor cores.
// The (T, T) scores never reach shared or device memory, so the block
// needs 31 KB of shared memory, not the 64 KB of an f32 score tile.
// skip_max is honoured exactly as given. The shifted-bf16 dots of the TPU
// kernel were a TPU workaround and are not ported.
//
// Numerics: same association order as int8_attention_ref, -fmad=false,
// rintf (half to even), exp2f as torch.exp2 calls it on the card; the
// softmax denominator accumulates in double and rounds once to float, as
// the plain version does, so its value does not depend on the order of
// the sum.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ void mma_s8(int* c, const unsigned* a,
                                       const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ unsigned ld32(const int8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

__device__ __forceinline__ float clip8(float r) {
  return fminf(fmaxf(r, -128.0f), 127.0f);
}

template <int T, int D>
__global__ void __launch_bounds__(THREADS)
    attn_kernel(const int8_t* __restrict__ qkv,
                const float* __restrict__ mask,
                const float* __restrict__ scal, int8_t* __restrict__ out,
                int H, float rsqrt_d, float log2e, int skip_max) {
  static_assert(T % 32 == 0 && T <= 128, "T must be 32, 64, 96 or 128");
  static_assert(D % 32 == 0, "head_dim must be a multiple of 32");
  constexpr int LDQ = D + 16;   // q/k smem row stride (bytes)
  constexpr int LDP = T + 16;   // probs / v^T smem row stride (bytes)
  constexpr int QK_BYTES = 2 * T * LDQ;
  constexpr int P_BYTES = T * LDP;
  constexpr int R0 = QK_BYTES > P_BYTES ? QK_BYTES : P_BYTES;
  constexpr int NT = T / 8;     // phase-1 n-tiles (key columns)
  constexpr int ND = D / 8;     // phase-3 n-tiles (head dims)

  __shared__ __align__(16) int8_t region0[R0];   // q|k, then probs
  __shared__ __align__(16) int8_t svt[D * LDP];  // v transposed
  __shared__ float mask2[T];
  __shared__ float qsum[T];
  __shared__ float ksum[T];
  __shared__ float vsum[D];
  int8_t* sq = region0;
  int8_t* sk = region0 + T * LDQ;
  int8_t* sp = region0;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const size_t ld = 3 * (size_t)H;
  const int8_t* base = qkv + (size_t)b * T * ld + (size_t)h * D;

  const float q_s = scal[0], q_sh = scal[1], k_s = scal[2], k_sh = scal[3];
  const float v_s = scal[4], v_sh = scal[5], sc_s = scal[6], sc_sh = scal[7];
  const float p_s = scal[8], p_sh = scal[9], c_s = scal[10], c_sh = scal[11];
  const float a = (sc_s * rsqrt_d) * log2e;

  // ---- phase 0: q, k (row-major) and v^T into shared memory ----
  constexpr int CH = D / 16;  // 16-byte chunks per row
  for (int c = tid; c < 2 * T * CH; c += THREADS) {
    const int which = c / (T * CH);
    const int rem = c - which * T * CH;
    const int row = rem / CH;
    const int cc = rem - row * CH;
    const uint4 v = *reinterpret_cast<const uint4*>(
        base + row * ld + which * H + cc * 16);
    *reinterpret_cast<uint4*>((which ? sk : sq) + row * LDQ + cc * 16) = v;
  }
  for (int c = tid; c < T * CH; c += THREADS) {
    const int row = c / CH;
    const int cc = c - row * CH;
    const uint4 v = *reinterpret_cast<const uint4*>(
        base + row * ld + 2 * H + cc * 16);
    const int8_t* bytes = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
    for (int e = 0; e < 16; ++e) svt[(cc * 16 + e) * LDP + row] = bytes[e];
  }
  if (tid < T) mask2[tid] = mask[(size_t)b * T + tid] * log2e + a * sc_sh;
  __syncthreads();
  for (int task = tid; task < 2 * T + D; task += THREADS) {
    int s = 0;
    if (task < 2 * T) {
      const int8_t* row = (task < T ? sq + task * LDQ : sk + (task - T) * LDQ);
      for (int e = 0; e < D; ++e) s += row[e];
      (task < T ? qsum[task] : ksum[task - T]) = static_cast<float>(s);
    } else {
      const int8_t* row = svt + (task - 2 * T) * LDP;
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
      const int8_t* p = sq + (i0 + g) * LDQ + kk + t * 4;
      af[0] = ld32(p);
      af[1] = ld32(p + 8 * LDQ);
      af[2] = ld32(p + 16);
      af[3] = ld32(p + 8 * LDQ + 16);
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        unsigned bf[2];
        const int8_t* pb = sk + (ni * 8 + g) * LDQ + kk + t * 4;
        bf[0] = ld32(pb);
        bf[1] = ld32(pb + 16);
        mma_s8(acc[ni], af, bf);
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
      const int8_t* p = sp + (i0 + g) * LDP + kk + t * 4;
      af[0] = ld32(p);
      af[1] = ld32(p + 8 * LDP);
      af[2] = ld32(p + 16);
      af[3] = ld32(p + 8 * LDP + 16);
#pragma unroll
      for (int ni = 0; ni < ND; ++ni) {
        unsigned bf[2];
        const int8_t* pb = svt + (ni * 8 + g) * LDP + kk + t * 4;
        bf[0] = ld32(pb);
        bf[1] = ld32(pb + 16);
        mma_s8(acc2[ni], af, bf);
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
        out[((size_t)b * T + i) * H + (size_t)h * D + dd] =
            static_cast<int8_t>(__float2int_rn(lvl));
      }
    }
  }
}

template <int T, int D>
cudaError_t launch(const int8_t* qkv, const float* mask, const float* scal,
                   int8_t* out, int B, int H, int n_heads, float rsqrt_d,
                   float log2e, int skip_max, cudaStream_t stream) {
  dim3 grid(n_heads, B);
  attn_kernel<T, D><<<grid, THREADS, 0, stream>>>(qkv, mask, scal, out, H,
                                                 rsqrt_d, log2e, skip_max);
  return cudaGetLastError();
}

}  // namespace

// qkv: (B*T, 3H) int8, columns [q | k | v], head-minor inside each third.
// mask: (B, T) f32 additive bias. scal: 12 f32 site scalars. out: (B*T, H).
extern "C" int tq_int8_attention(const void* qkv, const void* mask,
                                 const void* scal, void* out, int B, int T,
                                 int H, int n_heads, float rsqrt_d,
                                 float log2e, int skip_max, void* stream) {
  const int8_t* q = static_cast<const int8_t*>(qkv);
  const float* m = static_cast<const float*>(mask);
  const float* s = static_cast<const float*>(scal);
  int8_t* o = static_cast<int8_t*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int D = H / n_heads;
  if (D != 64 || D * n_heads != H)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  switch (T) {
    case 32: e = launch<32, 64>(q, m, s, o, B, H, n_heads, rsqrt_d, log2e,
                                skip_max, st); break;
    case 64: e = launch<64, 64>(q, m, s, o, B, H, n_heads, rsqrt_d, log2e,
                                skip_max, st); break;
    case 128: e = launch<128, 64>(q, m, s, o, B, H, n_heads, rsqrt_d, log2e,
                                  skip_max, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(e);
}
