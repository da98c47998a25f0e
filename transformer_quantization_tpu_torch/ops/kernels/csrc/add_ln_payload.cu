// Payload-in / payload-out residual add + LayerNorm (K3).
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
// The instance of add_ln.cuh's template with int8 payloads in, scalar
// 8-bit sites and the int8 payload out; the design and the numerics are
// there.

#include "add_ln.cuh"

// y8, r8, out: (M, H) int8; gb: (2, H) f32 [gamma; beta]; scal: 8 f32
// [y_s, y_sh, r_s, r_sh, res_s, res_sh, ln_s, ln_sh]. H % 128 == 0,
// H <= 1024. Returns the launch's cudaError_t.
extern "C" int tq_add_ln_payload(const void* y8, const void* r8,
                                 const void* gb, const void* scal, void* out,
                                 int M, int H, float eps, int res_quant,
                                 void* stream) {
  const tqln::Args a{y8, r8, static_cast<const float*>(gb),
                     static_cast<const float*>(scal), nullptr,
                     static_cast<int8_t*>(out), nullptr, M, eps, res_quant,
                     -128.0f, 127.0f, -128.0f, 127.0f};
  return tqln::launch<int8_t, int8_t, false, tqln::OUT_I8>(
      a, H, static_cast<cudaStream_t>(stream));
}

// The add+LN kernels' fast division (add_ln.cuh div_fast, div_check)
// against __fdiv_rn on the card: for each of the nb divisors b (device
// floats in [2^-30, 2^30]) every float32 dividend below 2^96 in magnitude,
// every divisor in that range at four dividends, and seeded random pairs
// at every pair of exponents of that domain; adds the count of pairs
// whose quotients differ to *bad (one unsigned long long on the card,
// zeroed by the caller). Returns the launch's cudaError_t.
extern "C" int tq_ln_div_check(const void* b, int nb, void* bad,
                               void* stream) {
  tqln::div_check<<<dim3(512, nb + 2), tqln::THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(b), nb,
      static_cast<unsigned long long*>(bad));
  return static_cast<int>(cudaGetLastError());
}
