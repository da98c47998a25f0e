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
//               on a 2-16-bit grid (fold) or y itself (float); fold and
//               float also in bfloat16 (no activation: engine_dtype bf16)
//   act       = none | gelu_new | relu | gelu (A-S erf) | gelu_poly10 |
//               tanh (mm_common.cuh act_fn)
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
// tensor-core peak of an H100 SXM, against 55 MB of traffic (16 us).
//
// Design: the products on the float64 tensor cores, DMMA (mma.sync
// m16n8k4 .f64, dmma_common.cuh; KS picks k4 / k8 / k16, and k4 measured
// 2-3% faster than the other two, k1_probe.py --kernels k9):
// - a block of 256 threads (8 warps as 2 x 4) takes 128 x 128 outputs,
//   each warp 64 x 32 of them: 4 x 4 m16n8 tiles of float64 sums, 64
//   doubles (128 registers) a thread, one block an SM (launch bounds 256,
//   1: up to 255 registers a thread);
// - x stays float32 and w int8 in shared memory (a quarter and an eighth
//   of their float64 bytes), a 4-stage cp.async ring of 32 columns of K a
//   stage (16 KB of x, 4 KB of w), the loads of stage k + 3 in flight
//   under the products of stage k;
// - lane (g, t) of a warp takes columns 8t .. 8t+7 of a stage (the k sum's
//   order is free: each term is exact), in two halves of four: one 16-byte
//   load of x a row and one 8-byte load of w a column serve both halves,
//   and each value converts to float64 as its fragment is built; x rows
//   are stored with their 16-byte chunks swapped in odd rows (c ^ 1), so
//   that the eight rows of a fragment load meet no bank twice;
// - the epilogue takes each lane's two neighbouring columns at once (a
//   float2 or a 2-byte store).
// Limits: K % 16 == 0, K <= 8192, N % 8 == 0 (the wrapper's; the engine's
// plan refuses other widths); x 16-byte aligned, w 16-byte aligned rows;
// M ragged against the tiles.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dmma_common.cuh"
#include "mm_common.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 32, STAGES = 4;
constexpr int THREADS = 256;
constexpr int MT = 4, NT = 4;        // a warp's m16 x n8 tiles (64 x 32)
constexpr int KS = 1;                // DMMA depth / 4: m16n8k4
constexpr int XS = BM * BK * 4;      // a stage's x bytes
constexpr int WS = BN * BK;          // a stage's w bytes
constexpr int SMEM = STAGES * (XS + WS);

// byte offset of 16-byte chunk c (of 8) in row r of a stage's x tile
__device__ __forceinline__ int xoff(int r, int c) {
  return r * (BK * 4) + ((c ^ (r & 1)) << 4);
}

// the epilogue constants of one output column
struct ColF {
  float ws, b, os, inv, osh;
};

__device__ __forceinline__ ColF col_of(const float* vecs, int N, int n) {
  ColF k;
  k.ws = vecs[n];
  k.b = vecs[2 * N + n];
  k.os = vecs[3 * N + n];
  k.inv = 1.0f / k.os;
  k.osh = vecs[4 * N + n];
  return k;
}

// one output: y = act(wscale * acc + bias), then the site (OUT 0: the
// level, stored as int8; 1: its value; 2: y; the epilogue stores OUT 3
// and 4 as 1 and 2 in bfloat16)
template <int ACT, int OUT>
__device__ __forceinline__ float out_of(float acc, const ColF& k, float lo,
                                        float hi, float gelu_c) {
  const float y = tqmm::act_fn<ACT>(k.ws * acc + k.b, gelu_c);
  if constexpr (OUT == 2) {
    return y;
  } else {
    const float lvl =
        fminf(fmaxf(tqmm::rint_div_fma(y, k.os, k.inv) - k.osh, lo), hi);
    return OUT == 0 ? lvl : k.os * (lvl + k.osh);
  }
}

template <int ACT, int OUT>
__device__ __forceinline__ void epilogue(const double (&acc)[MT][NT][4],
                                         const float* vecs, void* out,
                                         int mw, int nw, int M, int N,
                                         float lo, float hi, float gelu_c) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nj = 0; nj < NT; ++nj) {
    const int n = nw + nj * 8 + 2 * t;   // and n + 1 (N % 8 == 0)
    if (n >= N) continue;
    const ColF k0 = col_of(vecs, N, n), k1 = col_of(vecs, N, n + 1);
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int m = mw + mi * 16 + g + 8 * r;
        if (m >= M) continue;
        constexpr int O = OUT >= 3 ? OUT - 2 : OUT;
        const float y0 = out_of<ACT, O>(
            __double2float_rn(acc[mi][nj][2 * r]), k0, lo, hi, gelu_c);
        const float y1 = out_of<ACT, O>(
            __double2float_rn(acc[mi][nj][2 * r + 1]), k1, lo, hi, gelu_c);
        const size_t i = static_cast<size_t>(m) * N + n;
        if constexpr (OUT >= 3) {
          *reinterpret_cast<__nv_bfloat162*>(
              static_cast<__nv_bfloat16*>(out) + i) =
              __floats2bfloat162_rn(y0, y1);
        } else if constexpr (OUT == 0) {
          char2 v;
          v.x = static_cast<signed char>(tqmm::to_i8(y0));
          v.y = static_cast<signed char>(tqmm::to_i8(y1));
          *reinterpret_cast<char2*>(static_cast<int8_t*>(out) + i) = v;
        } else {
          *reinterpret_cast<float2*>(static_cast<float*>(out) + i) =
              make_float2(y0, y1);
        }
      }
    }
  }
}

template <int ACT, int OUT>
__global__ void __launch_bounds__(THREADS, 1)
    float_int8_kernel(const float* __restrict__ x,
                      const int8_t* __restrict__ w,
                      const float* __restrict__ vecs, void* __restrict__ out,
                      int M, int N, int K, float lo, float hi,
                      float gelu_c) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int KT = (K + BK - 1) / BK;

  // stage s <- columns kt * BK .. of x (4 chunks a thread) and w (one)
  auto load = [&](int s, int kt) {
    uint8_t* xs = smem + s * (XS + WS);
    uint8_t* ws = xs + XS;
    const int k0 = kt * BK;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int id = tid + THREADS * i, r = id >> 3, c = id & 7;
      const bool ok = m0 + r < M && k0 + 4 * c < K;
      tqdm::cp16(xs + xoff(r, c),
                 ok ? x + static_cast<size_t>(m0 + r) * K + k0 + 4 * c : x,
                 ok);
    }
    const int r = tid >> 1, c = tid & 1;
    const bool ok = n0 + r < N && k0 + 16 * c < K;
    tqdm::cp16(ws + r * BK + 16 * c,
               ok ? w + static_cast<size_t>(n0 + r) * K + k0 + 16 * c : w,
               ok);
  };

  double acc[MT][NT][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int nj = 0; nj < NT; ++nj)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][nj][i] = 0.0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load(s, s);
    tqdm::cp_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    tqdm::cp_wait<STAGES - 2>();
    __syncthreads();   // stage kt landed; every warp is done with kt - 1's
    if (kt + STAGES - 1 < KT) load((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    tqdm::cp_commit();
    const uint8_t* xs = smem + (kt % STAGES) * (XS + WS);
    const uint8_t* ws = xs + XS;
    uint2 wv[NT];
#pragma unroll
    for (int nj = 0; nj < NT; ++nj)
      wv[nj] = *reinterpret_cast<const uint2*>(ws + (wn + nj * 8 + g) * BK +
                                               8 * t);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // columns 8t + 4h + s, s < 4, as fragment k positions t + 4s
      double b[NT][4];
#pragma unroll
      for (int nj = 0; nj < NT; ++nj) {
        const uint32_t word = h ? wv[nj].y : wv[nj].x;
#pragma unroll
        for (int s = 0; s < 4; ++s) b[nj][s] = tqdm::i8_to_f64(word, s);
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const int r = wm + mi * 16 + g;
        const float4 lo4 =
            *reinterpret_cast<const float4*>(xs + xoff(r, 2 * t + h));
        const float4 hi4 =
            *reinterpret_cast<const float4*>(xs + xoff(r + 8, 2 * t + h));
        const double a[8] = {lo4.x, hi4.x, lo4.y, hi4.y,
                             lo4.z, hi4.z, lo4.w, hi4.w};
#pragma unroll
        for (int nj = 0; nj < NT; ++nj) tqdm::dmma16<KS>(acc[mi][nj], a, b[nj]);
      }
    }
  }
  tqdm::cp_wait<0>();
  epilogue<ACT, OUT>(acc, vecs, out, m0 + wm, n0 + wn, M, N, lo, hi, gelu_c);
}

template <int ACT>
cudaError_t launch_act(int out_mode, const float* x, const int8_t* w,
                       const float* vecs, void* out, int M, int N, int K,
                       float lo, float hi, float gelu_c, cudaStream_t st) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  void (*kernel)(const float*, const int8_t*, const float*, void*, int, int,
                 int, float, float, float);
  switch (out_mode) {
    case 0: kernel = float_int8_kernel<ACT, 0>; break;
    case 1: kernel = float_int8_kernel<ACT, 1>; break;
    case 2: kernel = float_int8_kernel<ACT, 2>; break;
    // bfloat16 outputs: no activation (the caller checks)
    case 3: kernel = float_int8_kernel<0, 3>; break;
    default: kernel = float_int8_kernel<0, 4>; break;
  }
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (attr != cudaSuccess) return attr;
  kernel<<<grid, THREADS, SMEM, st>>>(x, w, vecs, out, M, N, K, lo, hi,
                                      gelu_c);
  return cudaGetLastError();
}

}  // namespace

// x: (M, K) f32, 16-byte aligned; w: (N, K) int8, 16-byte aligned; vecs:
// (5, N) f32 rows [wscale, -, bias, out_s, out_sh]; out: (M, N), int8
// (out_mode 0, emit), f32 (1 fold, 2 float) or bf16 (3 fold, 4 float;
// act 0 only), 8-byte aligned. act: 0 none, 1 gelu_new, 2 relu, 3 gelu,
// 4 gelu_poly10, 5 tanh. [lo, hi]: the output site's level bounds.
// K % 16 == 0, 0 < K <= 8192, N % 8 == 0. Launches on `stream`; returns
// the launch's cudaError_t (cudaErrorInvalidValue for arguments the
// kernel does not take).
extern "C" int tq_float_int8_matmul(const void* x, const void* w,
                                    const void* vecs, void* out, int M,
                                    int N, int K, int act, int out_mode,
                                    float lo, float hi, float gelu_c,
                                    void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 || K > 8192 || N % 8 ||
      act < 0 || act > 5 || out_mode < 0 || out_mode > 4 ||
      (out_mode > 2 && act != 0) ||
      (reinterpret_cast<uintptr_t>(x) & 15) ||
      (reinterpret_cast<uintptr_t>(w) & 15) ||
      (reinterpret_cast<uintptr_t>(out) & 7))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xp = static_cast<const float*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* vp = static_cast<const float*>(vecs);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (act) {
    case 0: e = launch_act<0>(out_mode, xp, wp, vp, out, M, N, K, lo, hi, gelu_c, st); break;
    case 1: e = launch_act<1>(out_mode, xp, wp, vp, out, M, N, K, lo, hi, gelu_c, st); break;
    case 2: e = launch_act<2>(out_mode, xp, wp, vp, out, M, N, K, lo, hi, gelu_c, st); break;
    case 3: e = launch_act<3>(out_mode, xp, wp, vp, out, M, N, K, lo, hi, gelu_c, st); break;
    case 4: e = launch_act<4>(out_mode, xp, wp, vp, out, M, N, K, lo, hi, gelu_c, st); break;
    default: e = launch_act<5>(out_mode, xp, wp, vp, out, M, N, K, lo, hi, gelu_c, st); break;
  }
  return static_cast<int>(e);
}
