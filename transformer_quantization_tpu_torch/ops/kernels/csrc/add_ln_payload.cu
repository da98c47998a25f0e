// Payload-in / payload-out residual add + LayerNorm.
//
// Replaces: transformer_quantization_tpu/ops/pallas/engine_kernels.py
//   fused_add_ln_payload (_add_ln_payload_kernel / _ln_body), and the
//   add+LN epilogues of int8_matmul_add_ln, int8_ffn_ln and int8_layer_ln.
//
//   x    = y_s * (y8 + y_sh) + r_s * (r8 + r_sh)
//   x    = res_s * (clip(rint(x * (1/res_s)) - res_sh, -128, 127) + res_sh)
//                                                       (when res_quant)
//   mean = sum(x)/H, var = max(sum(x*x)/H - mean^2, 0)    (one pass)
//   z    = (x - mean) * (1 / sqrt(var + eps)) * gamma + beta
//   out  = clip(rint(z / ln_s) - ln_sh, -128, 127)        int8
//
// What bounds it on the card: bytes. A row of H = 768 reads 1,536 bytes
// and writes 768 for ~15 flops per element; at M = 16384 rows that is 38 MB,
// 11.3 us at 3.35 TB/s.
//
// Design: one warp per row, eight rows per 256-thread block; each lane
// loads 4 contiguous payload bytes per 128-column chunk (coalesced 128-byte
// warp loads), keeps the row in registers, and reduces sum and sum of
// squares with warp shuffles. Nothing touches shared memory.
//
// Numerics: association order of the plain version, -fmad=false, rintf
// (half to even), IEEE division and square root. Both row sums accumulate
// in double and round once to float, as the plain version does, so the
// result does not depend on the order of the sum: a one-level flip here
// would compound through the twelve layers of the engine.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = THREADS / 32;

template <int NCH>  // H = NCH * 128
__global__ void __launch_bounds__(THREADS)
    add_ln_kernel(const int8_t* __restrict__ y8, const int8_t* __restrict__ r8,
                  const float* __restrict__ gb,
                  const float* __restrict__ scal, int8_t* __restrict__ out,
                  int M, float eps, int res_quant) {
  constexpr int H = NCH * 128;
  const int row = blockIdx.x * ROWS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const float y_s = scal[0], y_sh = scal[1], r_s = scal[2], r_sh = scal[3];
  const float res_s = scal[4], res_sh = scal[5];
  const float ln_s = scal[6], ln_sh = scal[7];
  const float inv_res = 1.0f / res_s;

  float x[NCH * 4];
  double sum = 0.0, sumsq = 0.0;
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const int col = c * 128 + lane * 4;
    const char4 yv = *reinterpret_cast<const char4*>(y8 + (size_t)row * H + col);
    const char4 rv = *reinterpret_cast<const char4*>(r8 + (size_t)row * H + col);
    const int8_t ys[4] = {yv.x, yv.y, yv.z, yv.w};
    const int8_t rs[4] = {rv.x, rv.y, rv.z, rv.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v = y_s * (static_cast<float>(ys[e]) + y_sh) +
                r_s * (static_cast<float>(rs[e]) + r_sh);
      if (res_quant) {
        const float lvl =
            fminf(fmaxf(rintf(v * inv_res) - res_sh, -128.0f), 127.0f);
        v = res_s * (lvl + res_sh);
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
    int8_t q[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float z = (x[c * 4 + e] - mean) * rstd * gb[col + e] +
                      gb[H + col + e];
      const float lvl = fminf(fmaxf(rintf(z / ln_s) - ln_sh, -128.0f), 127.0f);
      q[e] = static_cast<int8_t>(__float2int_rn(lvl));
    }
    *reinterpret_cast<char4*>(out + (size_t)row * H + col) =
        make_char4(q[0], q[1], q[2], q[3]);
  }
}

template <int NCH>
cudaError_t launch(const int8_t* y8, const int8_t* r8, const float* gb,
                   const float* scal, int8_t* out, int M, float eps,
                   int res_quant, cudaStream_t stream) {
  add_ln_kernel<NCH><<<(M + ROWS - 1) / ROWS, THREADS, 0, stream>>>(
      y8, r8, gb, scal, out, M, eps, res_quant);
  return cudaGetLastError();
}

}  // namespace

// y8, r8, out: (M, H) int8; gb: (2, H) f32 [gamma; beta]; scal: 8 f32
// [y_s, y_sh, r_s, r_sh, res_s, res_sh, ln_s, ln_sh]. H % 128 == 0.
extern "C" int tq_add_ln_payload(const void* y8, const void* r8,
                                 const void* gb, const void* scal, void* out,
                                 int M, int H, float eps, int res_quant,
                                 void* stream) {
  const int8_t* y = static_cast<const int8_t*>(y8);
  const int8_t* r = static_cast<const int8_t*>(r8);
  const float* g = static_cast<const float*>(gb);
  const float* s = static_cast<const float*>(scal);
  int8_t* o = static_cast<int8_t*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (H) {
    case 128: e = launch<1>(y, r, g, s, o, M, eps, res_quant, st); break;
    case 256: e = launch<2>(y, r, g, s, o, M, eps, res_quant, st); break;
    case 384: e = launch<3>(y, r, g, s, o, M, eps, res_quant, st); break;
    case 512: e = launch<4>(y, r, g, s, o, M, eps, res_quant, st); break;
    case 640: e = launch<5>(y, r, g, s, o, M, eps, res_quant, st); break;
    case 768: e = launch<6>(y, r, g, s, o, M, eps, res_quant, st); break;
    case 896: e = launch<7>(y, r, g, s, o, M, eps, res_quant, st); break;
    case 1024: e = launch<8>(y, r, g, s, o, M, eps, res_quant, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(e);
}
