// Payload matmul with the dequant fold, activation and per-column output
// site in the epilogue.
//
// Replaces: transformer_quantization_tpu/ops/pallas/engine_kernels.py
//   int8_matmul (_mm_kernel / _mm_body / _int_dot), and the matmul halves
//   of int8_matmul_add_ln, int8_ffn_ln, int8_attn_ln and int8_layer_ln.
//
//   y   = (in_s * wscale[n]) * (acc + in_shift * colsum[n]) + bias[n]
//   y   = act(y)                              (none | gelu_new)
//   out = emit:  clip(rint(y / out_s[n]) - out_sh[n], -128, 127)  int8
//         fold:  out_s[n] * (clip(...) + out_sh[n])               float
//                (on the fold site's out_bits grid: [lo, hi] up to 16 bits)
//         float: y                                                float
//
// What bounds it on the card: the int8 tensor-core rate. At BERT-base
// shapes (M = 16384, K/N = 768..3072) every call does 19-77 GOP over
// 26-65 MB, 300-1200 int8 operations per byte, far above the H100's
// ~590 op/byte ridge (1,979 TOP/s over 3.35 TB/s).
//
// Design: 128x128 output tile per 256-thread block, 8 warps of 64x32,
// mma.sync.m16n8k32 s8*s8->s32. Both operands are K-contiguous (x is
// (M, K), the weight (N, K)), so every fragment register is one 32-bit
// shared-memory load; rows are padded to 80 bytes, which makes the
// fragment loads bank-conflict free. K advances 64 bytes at a time
// through a two-stage cp.async ring. This is the simple first kernel:
// wgmma, TMA and a persistent schedule are later work.
//
// Numerics: the int32 accumulator converts with __int2float_rn (as XLA's
// convert does) and the epilogue keeps the reference's association order;
// the file is built with -fmad=false so no multiply-add is contracted.
// rintf rounds half to even like torch.round / jnp.round.

#include "mm_common.cuh"

namespace {

using namespace tqmm;

constexpr int BN = 128;

template <int ACT, int OUT>
__global__ void __launch_bounds__(THREADS)
    int8_mm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ vecs,
                   const float* __restrict__ scal, void* __restrict__ out,
                   int M, int N, int K, float lo, float hi, float gelu_c) {
  __shared__ __align__(16) int8_t sA[2][BM * LDS];
  __shared__ __align__(16) int8_t sB[2][BN * LDS];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // mma groupID
  const int t = lane & 3;    // mma threadID_in_group
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int wm = (warp >> 2) * 64;
  const int wn = (warp & 3) * 32;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  auto load_tile = [&](int stage, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * THREADS;   // 512 16-byte chunks per operand
      const int row = c >> 2;
      const int col = (c & 3) * 16;
      const int gk = k0 + col;
      const int gm = m0 + row;
      const bool pa = gm < M && gk < K;
      cp_async16(&sA[stage][row * LDS + col],
                 pa ? x + (size_t)gm * K + gk : x, pa);
      const int gn = n0 + row;
      const bool pb = gn < N && gk < K;
      cp_async16(&sB[stage][row * LDS + col],
                 pb ? w + (size_t)gn * K + gk : w, pb);
    }
  };

  const int ktiles = (K + BK - 1) / BK;
  load_tile(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < ktiles; ++kt) {
    if (kt + 1 < ktiles) load_tile((kt + 1) & 1, (kt + 1) * BK);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const int8_t* as = sA[kt & 1];
    const int8_t* bs = sB[kt & 1];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      unsigned af[4][4];
      unsigned bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        load_a_frag(af[mi], as, LDS, wm + mi * 16, kk, g, t);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        load_b_frag(bf[ni], bs, wn + ni * 8, kk, g, t);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_k32<false>(acc[mi][ni], af[mi], bf[ni]);
    }
    __syncthreads();
  }

  const float in_s = scal[0];
  const float in_sh = scal[1];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + wn + ni * 8 + t * 2;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = m0 + wm + mi * 16 + g + (r >= 2 ? 8 : 0);
        const int cc = col + (r & 1);
        if (row < M && cc < N) {
          const float ws = vecs[cc];
          const float cs = vecs[N + cc];
          const float bias = vecs[2 * N + cc];
          const float y =
              (in_s * ws) * (__int2float_rn(acc[mi][ni][r]) + in_sh * cs) +
              bias;
          store_out<ACT, OUT>(y, (size_t)row * N + cc, cc, N, vecs, lo, hi,
                              gelu_c, out);
        }
      }
    }
  }
}

template <int ACT, int OUT>
cudaError_t launch(const int8_t* x, const int8_t* w, const float* vecs,
                   const float* scal, void* out, int M, int N, int K,
                   float lo, float hi, float gelu_c, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int8_mm_kernel<ACT, OUT><<<grid, THREADS, 0, stream>>>(
      x, w, vecs, scal, out, M, N, K, lo, hi, gelu_c);
  return cudaGetLastError();
}

}  // namespace

// act: 0 none, 1 gelu_new. out_mode: 0 emit (int8), 1 fold (f32),
// 2 float (f32). [lo, hi]: the output site's level bounds (emit: 8-bit).
// Returns the launch's cudaError_t.
extern "C" int tq_int8_matmul(const void* x, const void* w, const void* vecs,
                              const void* scal, void* out, int M, int N,
                              int K, int act, int out_mode, float lo,
                              float hi, float gelu_c, void* stream) {
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* vp = static_cast<const float*>(vecs);
  const float* sp = static_cast<const float*>(scal);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (act < 0 || act > 1 || out_mode < 0 || out_mode > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  switch (act * 3 + out_mode) {
    case 0: e = launch<0, 0>(xp, wp, vp, sp, out, M, N, K, lo, hi, gelu_c, st); break;
    case 1: e = launch<0, 1>(xp, wp, vp, sp, out, M, N, K, lo, hi, gelu_c, st); break;
    case 2: e = launch<0, 2>(xp, wp, vp, sp, out, M, N, K, lo, hi, gelu_c, st); break;
    case 3: e = launch<1, 0>(xp, wp, vp, sp, out, M, N, K, lo, hi, gelu_c, st); break;
    case 4: e = launch<1, 1>(xp, wp, vp, sp, out, M, N, K, lo, hi, gelu_c, st); break;
    default: e = launch<1, 2>(xp, wp, vp, sp, out, M, N, K, lo, hi, gelu_c, st); break;
  }
  return static_cast<int>(e);
}
