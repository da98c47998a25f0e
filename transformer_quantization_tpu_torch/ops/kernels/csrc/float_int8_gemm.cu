// The float x int8 matmul (K9), for Hopper: a float32 edge on no grid
// against an int8 weight.
//
// Replaces: transformer_quantization_tpu/ops/pallas/engine_kernels.py
//   _f_dot with _mm_body(in_mode='f') (int8_matmul(in_mode='f') and the
//   attn_out stage of int8_layer_ln / int8_attn_ln / int8_matmul_add_ln)
//   where the edge lies on no grid: the disabled context site ('c':
//   'fp32'), whose raw value p.v * p_s * v_s the float-edge matmul (K4)
//   cannot take apart into levels.
//
//   acc[m, n] = sum_k x[m, k] * w[n, k]            (float64, rounded once)
//   y         = act(wscale[n] * acc + bias[n])
//   out       = the output site of y: its int8 payload (emit), its value
//               on a 2-16-bit grid (fold) or y itself (float)
//
// Numerics: a float32 times an int8 is exact in float64 (24 + 8 bits), so
// each output is the float32 rounding of the exact sum but where the
// float64 sum's own rounding (order-dependent, some 2^-29 of a float32
// step) meets a tie; the plain version (float_int8_matmul_ref) sums in
// float64 too, so the two agree bit for bit but on such ties. JAX sums in
// float32 (its result depends on the order). No TF32: it would change the
// numbers. After the sum the epilogue is int8_matmul.cu's, -fmad=false:
// (wscale * acc) + bias, act, the site level rint(y / out_s) through
// rint_div_fma (the IEEE quotient's integer), clipped to [lo, hi].
//
// What bounds it on the card: operations. BERT-base's attn_out (M =
// 16384, K = N = 768) is 19.3 GFLOP: 0.29 ms at the 67 TFLOP/s float64
// (tensor-core) peak of an H100 SXM, against 55 MB of traffic (16 us).
// This first design runs the float64 FMA units without tensor cores (half
// that peak): tiles of 64 x 64 outputs, a block of 256 threads each
// holding 4 x 4 float64 sums, x and w staged through shared memory as
// float64 (converted once a tile, the weight's bytes exactly), 32 columns
// of K a stage, the next stage's global loads in flight under this one's
// products. A split-bf16 or DMMA (float64 mma.sync) design is a later
// redesign.
// Limits: K % 4 == 0, K <= 8192 (the wrapper's); x 16-byte aligned, w
// 4-byte aligned rows; M, N ragged against the tiles.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mm_common.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int THREADS = 256;
constexpr int LDS = BM + 1;   // a shared row of 64 doubles and a pad

// the epilogue constants of one output column
struct ColF {
  float ws, b, os, inv, osh;
};

template <int ACT, int OUT>
__device__ __forceinline__ void store(void* out, int m, int n, int N,
                                      float acc, const ColF& k, float lo,
                                      float hi, float gelu_c) {
  const float y = tqmm::act_fn<ACT>(k.ws * acc + k.b, gelu_c);
  const size_t i = static_cast<size_t>(m) * N + n;
  if constexpr (OUT == 2) {
    static_cast<float*>(out)[i] = y;
  } else {
    const float lvl =
        fminf(fmaxf(tqmm::rint_div_fma(y, k.os, k.inv) - k.osh, lo), hi);
    if constexpr (OUT == 0)
      static_cast<int8_t*>(out)[i] = tqmm::to_i8(lvl);
    else
      static_cast<float*>(out)[i] = k.os * (lvl + k.osh);
  }
}

template <int ACT, int OUT>
__global__ void __launch_bounds__(THREADS)
    float_int8_kernel(const float* __restrict__ x,
                      const int8_t* __restrict__ w,
                      const float* __restrict__ vecs, void* __restrict__ out,
                      int M, int N, int K, float lo, float hi,
                      float gelu_c) {
  __shared__ double xs[BK][LDS];   // xs[k][m]: the x tile, transposed
  __shared__ double ws[BK][LDS];   // ws[k][n]: the weight tile, transposed
  const int t = threadIdx.x;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int ty = t >> 4, tx = t & 15;   // rows ty + 16 i, columns tx + 16 j
  // a stage's global loads: two float4 of x and two 4-byte words of w a
  // thread (rows r, r + 32; columns c4 .. c4 + 3 of the stage)
  const int r = t >> 3, c4 = (t & 7) * 4;
  float4 xv[2];
  int wv[2];
  auto load = [&](int k0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r + 32 * h, k = k0 + c4;
      const bool kin = k < K;
      xv[h] = m0 + row < M && kin
                  ? *reinterpret_cast<const float4*>(
                        x + static_cast<size_t>(m0 + row) * K + k)
                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      wv[h] = n0 + row < N && kin
                  ? *reinterpret_cast<const int*>(
                        w + static_cast<size_t>(n0 + row) * K + k)
                  : 0;
    }
  };
  double acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0;
  load(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();   // the last stage's products are done with the tiles
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r + 32 * h;
      xs[c4 + 0][row] = static_cast<double>(xv[h].x);
      xs[c4 + 1][row] = static_cast<double>(xv[h].y);
      xs[c4 + 2][row] = static_cast<double>(xv[h].z);
      xs[c4 + 3][row] = static_cast<double>(xv[h].w);
#pragma unroll
      for (int b = 0; b < 4; ++b)
        ws[c4 + b][row] = static_cast<double>(
            static_cast<int8_t>(wv[h] >> (8 * b)));
    }
    __syncthreads();
    if (k0 + BK < K) load(k0 + BK);   // in flight under the products
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      double a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[k][tx + 16 * j];
      // each product is exact: a fused multiply-add rounds as the sum of
      // the separate product would
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __fma_rn(a[i], b[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + tx + 16 * j;
    if (n >= N) continue;
    ColF k;
    k.ws = vecs[n];
    k.b = vecs[2 * N + n];
    k.os = vecs[3 * N + n];
    k.inv = 1.0f / k.os;
    k.osh = vecs[4 * N + n];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + ty + 16 * i;
      if (m < M)
        store<ACT, OUT>(out, m, n, N, __double2float_rn(acc[i][j]), k, lo,
                        hi, gelu_c);
    }
  }
}

template <int ACT>
cudaError_t launch_act(int out_mode, const float* x, const int8_t* w,
                       const float* vecs, void* out, int M, int N, int K,
                       float lo, float hi, float gelu_c, cudaStream_t st) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  switch (out_mode) {
    case 0: float_int8_kernel<ACT, 0><<<grid, THREADS, 0, st>>>(x, w, vecs, out, M, N, K, lo, hi, gelu_c); break;
    case 1: float_int8_kernel<ACT, 1><<<grid, THREADS, 0, st>>>(x, w, vecs, out, M, N, K, lo, hi, gelu_c); break;
    default: float_int8_kernel<ACT, 2><<<grid, THREADS, 0, st>>>(x, w, vecs, out, M, N, K, lo, hi, gelu_c); break;
  }
  return cudaGetLastError();
}

}  // namespace

// x: (M, K) f32, 16-byte aligned; w: (N, K) int8; vecs: (5, N) f32 rows
// [wscale, -, bias, out_s, out_sh]; out: (M, N), int8 (out_mode 0, emit)
// or f32 (1 fold, 2 float). act: 0 none, 1 gelu_new, 2 relu. [lo, hi]:
// the output site's level bounds. K % 4 == 0, 0 < K <= 8192. Launches on
// `stream`; returns the launch's cudaError_t (cudaErrorInvalidValue for
// arguments the kernel does not take).
extern "C" int tq_float_int8_matmul(const void* x, const void* w,
                                    const void* vecs, void* out, int M,
                                    int N, int K, int act, int out_mode,
                                    float lo, float hi, float gelu_c,
                                    void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 4 || K > 8192 || act < 0 ||
      act > 2 || out_mode < 0 || out_mode > 2 ||
      (reinterpret_cast<uintptr_t>(x) & 15) ||
      (reinterpret_cast<uintptr_t>(w) & 3))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xp = static_cast<const float*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* vp = static_cast<const float*>(vecs);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (act) {
    case 0: e = launch_act<0>(out_mode, xp, wp, vp, out, M, N, K, lo, hi, gelu_c, st); break;
    case 1: e = launch_act<1>(out_mode, xp, wp, vp, out, M, N, K, lo, hi, gelu_c, st); break;
    default: e = launch_act<2>(out_mode, xp, wp, vp, out, M, N, K, lo, hi, gelu_c, st); break;
  }
  return static_cast<int>(e);
}
