// Fused int8 attention over q, k and v payloads, one block per (batch row,
// head).
//
// Replaces: transformer_quantization_tpu/ops/pallas/engine_kernels.py
//   int8_attention_qkv and int8_attention, both through _attention_call /
//   _attn_kernel / _attn_row (dots='i8'), and the attention stage of
//   int8_layer_ln and int8_attn_ln.
//
// q, k and v each come from their own array (row strides ldq / ldk / ldv,
// the caller's pointers already at the column block picked by `cols`):
// int8_attention is the instance over one fused q|k|v array (cols 0, 1, 2,
// stride 3H); MobileBERT's engine reads q and k as the halves of one [q|k]
// payload and v from its own (cols 0, 1, 0).
//
// What bounds it on the card: bytes. At B=128, S=128, 12 heads of 64 the
// call does 6.4 GOP against 50 MB of q|k|v in and context out, about 130
// int8 operations per byte, below the H100's ~590 op/byte ridge; the
// softmax chain (an exp2 per score) is the other cost.
//
// Design: each block loads its head's q and k (T x D int8) and v
// (transposed, D x T) into shared memory once, then runs attn_head
// (attn_common.cuh, shared with int8_mb_layer.cu): a warp owns 16 query
// rows end to end, both products on int8 tensor cores, the probs payload
// reusing the q/k space. The block needs 31 KB of shared memory at
// (T, D) = (128, 64). The shifted-bf16 dots of the TPU kernel were a TPU
// workaround and are not ported.

#include "attn_common.cuh"

namespace {

using tqmm::THREADS;

template <int T, int D>
__global__ void __launch_bounds__(THREADS)
    attn_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ k,
                const int8_t* __restrict__ v, int ldq, int ldk, int ldv,
                const float* __restrict__ mask,
                const float* __restrict__ scal, int8_t* __restrict__ out,
                int hidden, float rsqrt_d, float log2e, int skip_max) {
  constexpr int LDQ = D + 16;   // q/k smem row stride (bytes)
  constexpr int LDP = T + 16;   // probs / v^T smem row stride (bytes)
  constexpr int QK_BYTES = 2 * T * LDQ;
  constexpr int P_BYTES = T * LDP;
  constexpr int R0 = QK_BYTES > P_BYTES ? QK_BYTES : P_BYTES;

  __shared__ __align__(16) int8_t region0[R0];   // q|k, then probs
  __shared__ __align__(16) int8_t svt[D * LDP];  // v transposed
  __shared__ float mask2[T];
  __shared__ float qsum[T];
  __shared__ float ksum[T];
  __shared__ float vsum[D];
  int8_t* sq = region0;
  int8_t* sk = region0 + T * LDQ;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int8_t* qb = q + (size_t)b * T * ldq + (size_t)h * D;
  const int8_t* kb = k + (size_t)b * T * ldk + (size_t)h * D;
  const int8_t* vb = v + (size_t)b * T * ldv + (size_t)h * D;

  // q, k (row-major) and v^T into shared memory
  constexpr int CH = D / 16;  // 16-byte chunks per row
  for (int c = tid; c < 2 * T * CH; c += THREADS) {
    const int which = c / (T * CH);
    const int rem = c - which * T * CH;
    const int row = rem / CH;
    const int cc = rem - row * CH;
    const uint4 val = *reinterpret_cast<const uint4*>(
        (which ? kb + (size_t)row * ldk : qb + (size_t)row * ldq) + cc * 16);
    *reinterpret_cast<uint4*>((which ? sk : sq) + row * LDQ + cc * 16) = val;
  }
  for (int c = tid; c < T * CH; c += THREADS) {
    const int row = c / CH;
    const int cc = c - row * CH;
    const uint4 val = *reinterpret_cast<const uint4*>(
        vb + (size_t)row * ldv + cc * 16);
    const int8_t* bytes = reinterpret_cast<const int8_t*>(&val);
#pragma unroll
    for (int e = 0; e < 16; ++e) svt[(cc * 16 + e) * LDP + row] = bytes[e];
  }
  tqattn::mask_row<T>(mask2, mask + (size_t)b * T, scal, rsqrt_d, log2e);
  __syncthreads();
  tqattn::attn_head<T, D>(sq, LDQ, sk, LDQ, svt, LDP, region0, mask2, qsum,
                          ksum, vsum, scal, rsqrt_d, log2e, skip_max,
                          out + (size_t)b * T * hidden + (size_t)h * D,
                          hidden);
}

template <int T, int D>
cudaError_t launch(const int8_t* q, const int8_t* k, const int8_t* v,
                   int ldq, int ldk, int ldv, const float* mask,
                   const float* scal, int8_t* out, int B, int hidden,
                   float rsqrt_d, float log2e, int skip_max,
                   cudaStream_t stream) {
  dim3 grid(hidden / D, B);
  attn_kernel<T, D><<<grid, THREADS, 0, stream>>>(
      q, k, v, ldq, ldk, ldv, mask, scal, out, hidden, rsqrt_d, log2e,
      skip_max);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_t(int T, const int8_t* q, const int8_t* k,
                     const int8_t* v, int ldq, int ldk, int ldv,
                     const float* mask, const float* scal, int8_t* out, int B,
                     int hidden, float rsqrt_d, float log2e, int skip_max,
                     cudaStream_t st) {
  switch (T) {
    case 32: return launch<32, D>(q, k, v, ldq, ldk, ldv, mask, scal, out, B, hidden, rsqrt_d, log2e, skip_max, st);
    case 64: return launch<64, D>(q, k, v, ldq, ldk, ldv, mask, scal, out, B, hidden, rsqrt_d, log2e, skip_max, st);
    case 128: return launch<128, D>(q, k, v, ldq, ldk, ldv, mask, scal, out, B, hidden, rsqrt_d, log2e, skip_max, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q / k / v: the (B*T, *) int8 arrays, each pointer at its hidden-wide
// column block, with row strides ldq / ldk / ldv (multiples of 16 bytes);
// heads are head-minor inside each block. mask: (B, T) f32 additive bias.
// scal: 12 f32 site scalars. out: (B*T, hidden). T in {32, 64, 128},
// head_dim = hidden / n_heads in {32, 64}. Returns the launch's
// cudaError_t.
extern "C" int tq_int8_attention(const void* q, const void* k, const void* v,
                                 int ldq, int ldk, int ldv, const void* mask,
                                 const void* scal, void* out, int B, int T,
                                 int hidden, int n_heads, float rsqrt_d,
                                 float log2e, int skip_max, void* stream) {
  const int8_t* qp = static_cast<const int8_t*>(q);
  const int8_t* kp = static_cast<const int8_t*>(k);
  const int8_t* vp = static_cast<const int8_t*>(v);
  const float* m = static_cast<const float*>(mask);
  const float* s = static_cast<const float*>(scal);
  int8_t* o = static_cast<int8_t*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int D = hidden / n_heads;
  if (D * n_heads != hidden || (ldq | ldk | ldv) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  switch (D) {
    case 32: e = launch_t<32>(T, qp, kp, vp, ldq, ldk, ldv, m, s, o, B, hidden, rsqrt_d, log2e, skip_max, st); break;
    case 64: e = launch_t<64>(T, qp, kp, vp, ldq, ldk, ldv, m, s, o, B, hidden, rsqrt_d, log2e, skip_max, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(e);
}
