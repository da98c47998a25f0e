// Float-edge matmul (K4), for Hopper: a float32 value edge on a known grid
// against an int8 weight, contracted exactly on the int8 tensor cores.
//
// Replaces: transformer_quantization_tpu/ops/pallas/engine_kernels.py
//   int8_matmul(in_mode='f') (_mm_body / _f_dot) and the inter matmul of
//   int8_ffn_ln(in_mode='f'): the FFN input of the mixed-precision and PEG
//   recipes, a 16-bit or per-embedding-group 'x' site that cannot ride an
//   int8 payload.
//
// The edge holds x[m, k] = s_g * (q - zp_g) with q an integer level in
// [0, 2^bits - 1] and one (s_g, zp_g) per group g of columns (one group
// for a per-tensor site; a PEG site's groups are contiguous in its
// permutation order, `cols`). Then
//   q            = clip(rint(x * (1 / s_g)) + zp_g, 0, 2^bits - 1)  (exact:
//                  the product errs by ~2^-23 relative, under half a level
//                  for |q - zp| < 2^16)
//   acc_g[m, n]  = sum_{k in g} q[m, k] w[n, k] - zp_g * colsum_g[n]  (int)
//   y            = wscale[n] * (sum_g s_g * float(acc_g)) + bias[n]
// with the group sum taken in group order, then act and the output site,
// as in int8_matmul: its int8 payload (emit: the flex FFN's inter matmul,
// an 8-bit attn_out fold site after a 16-bit context), or for a one-group
// edge its float32 value on a 2-16-bit grid (fold: the q|k|v matmul on a
// float layer input, the dense matmul on a 16-bit inter edge, attn_out on
// a 16-bit context, the inter matmul folding a 16-bit inter site) or y
// itself (float: attn_out on a 16-bit context with a disabled fold
// site); fold and float also in bfloat16 (no activation: the engine's
// engine_dtype bf16). act: none, gelu_new, gelu (A-S erf), gelu_poly10
// or tanh (mm_common.cuh act_fn). The JAX
// reference takes x @ w^T as a float32 dot product, whose result depends
// on its summation order; here every rounding happens after an exact
// integer sum, so the kernel and its plain version (float_edge_matmul_ref)
// agree bit for bit.
//
// What bounds it on the card: the int8 tensor-core rate. BERT-base inter
// (M = 16384, K = 768, N = 3072) is one 77.3 GOP product: 39 us at
// 1,979 TOP/s, against 103 MB of traffic (31 us), whatever the edge's
// width. A 16-bit edge costs two int8 products, so it runs at best at
// half the bound; the level pass alone moves 63 MB (8-bit) or 76 MB
// (16-bit): 19-23 us at 3.35 TB/s.
//
// Design: two launches, each its own entry point.
// 1. The level pass (levels_kernel): a row a warp, 4 blocks of 8 warps
//    an SM; a warp copies its row of x into its own shared-memory row
//    (float4 loads) and writes the row's levels in group order (the
//    `cols` gather reads that row; 1 / s_g and zp_g come from per-column
//    tables) into an int8 scratch, four bytes a lane. At BERT-base's
//    inter on an H100 (700 W) 1.4-1.5x its bytes bound (the copy alone
//    1.28x: x's 50 MB at 2.6 TB/s); chunks of rows a block, staged whole
//    before their levels, ran at 1.6-1.8x, double-buffered by cp.async
//    no faster. The levels are stored as s8 bytes, byte - 128, so that
//    they ride K1's wgmma s32.s8.s8 (no u8 variant is needed); the shift
//    folds into the integer correction below. 8-bit
//    edges: a (M, K) scratch. 16-bit edges: (2 Mp, K), Mp = M rounded up
//    to 64: the 64-row panel p keeps its lo bytes in scratch rows
//    128 p.. 128 p + 63 and its hi bytes in the next 64, so that one
//    128-row TMA box holds both planes of 64 output rows (rows past M are
//    zeros).
// 2. The GEMM: the fourth instance of the persistent warp-specialized
//    GEMM of wgmma_gemm.cuh (TMA ring, two consumer warpgroups in
//    ping-pong on wgmma m64n128k32 s8, staged 16-byte stores), with the
//    epilogue policy EdgeEpi on 64 x 128 tiles:
//    - 8-bit: acc_g = acc'_g + (128 - zp_g) colsum_g, acc' the sum of the
//      shifted levels (int32: |acc'| <= 2^14 K);
//    - 16-bit (kPlanes = 2): the skeleton's two accumulators of a 128-row
//      box, acc[0] and acc[1], are the lo and hi sums of the same 64 rows
//      against one B descriptor: acc_g = acc_lo + 256 acc_hi +
//      (256 * 128 + 128 - zp_g) colsum_g in int64, one __ll2float_rn;
//    - one group: the epilogue forms acc from the int32 sums;
//    - several groups (kGroups): the main loop folds each group's sums,
//      y = y + s_g * f32(acc_g) in group order (separately rounded, as
//      the plain version), the corrections from a group table that each
//      tile writes to shared memory (G x 128 int32 a warpgroup), once the
//      stage that ends the group (PEG: 6 groups of 128 at H = 768, one
//      stage each) has completed; groups of 64 columns fold after every
//      two k32 steps (kFoldSteps = 2). The fold is never under a branch
//      and never
//      under another wgmma in flight: ptxas then serializes every wgmma
//      of the kernel (its warnings C7515 / C7520), which first put PEG at
//      0.39 ms on an H100; folds overlapped with the next group's
//      products that way, or from a copy of the sums, ran no faster than
//      waited ones. An
//      8-bit group of at most 128 columns has |acc_g| < 2^22, so f32(acc_g)
//      is the exact 1.5 * 2^23 conversion (full-rate adds) in place of I2F;
//    - the column constants (wscale, bias, output site; one group's
//      correction) are ColEdge, 24 bytes; a block takes 162,912 (8-bit)
//      or 203,872 (16-bit) bytes of shared memory, 195,680 / 220,256 with
//      the group tables (kGroups 32 / 16);
//    - every instance 168 registers at launch (setmaxnreg: consumers 232,
//      240 for 16-bit groups of 64 columns), no spills (nvcc 12.9).
// Limits: N % 8 == 0; groups of a multiple of 64 columns (at most 32 of
// them at 8 bits, 16 at 16 bits); K <= 4096; 16-byte aligned x, w, out
// and scratch.
//
// Numerics: -fmad=false, rintf (half to even, like torch.round), the
// output site's rint(y / out_s) through rint_div_fma (the IEEE
// quotient's integer); every output is bit-identical to
// float_edge_matmul_ref, and the scratch to float_edge_levels_ref.

#include <type_traits>

#include "mm_common.cuh"
#include "wgmma_gemm.cuh"

namespace {

// the column constants: wscale, bias, the output site (out_s, its
// reciprocal, out_shift) and, for one group, its colsum term (8-bit:
// (128 - zp) colsum; 16-bit: colsum)
struct ColEdge {
  float ws, b, os, inv, osh;
  int cs;
};

struct EdgeArgs {
  const float* vecs;   // (5, N) rows
  const float* gs;     // (G,) group scales s_g
  const float* gzp;    // (G,) zero points
  const int* gcs;      // (G, N) per-group column sums of w
  int G, gsize;
  float gelu_c, lo, hi;   // [lo, hi]: a fold's level bounds
};

// K4's epilogue policy (wgmma_gemm.cuh). PL: bytes of a level (1: up to
// 8 bits, 2: 16); GR: one group (0), or several folded in the main loop
// after each stage (1: groups of a multiple of 128 columns) or every two
// k32 steps (2: of an odd multiple of 64). OUT: 0 emit (int8, the 8-bit
// site), 1 fold (f32 on the [lo, hi] grid), 2 float (f32 y); 3 and 4 are
// 1 and 2 with a bfloat16 output.
template <int PL, int GR, int ACT, int OUT = 0>
struct EdgeEpi {
  using Col = ColEdge;
  using Out = typename std::conditional<
      OUT == 0, int8_t,
      typename std::conditional<(OUT >= 3), __nv_bfloat16, float>::type>::type;
  using Args = EdgeArgs;
  static constexpr int kTM = 64;
  static constexpr int kPlanes = PL;
  static constexpr int kGroups = GR ? (PL == 1 ? 32 : 16) : 0;
  static constexpr int kFoldSteps = GR == 2 ? 2 : 4;
  // two planes folded every two k32 steps spill 20 bytes at 232
  static constexpr int kRegs = PL == 2 && GR == 2 ? 240 : 232;
  static constexpr int kShift = PL == 1 ? 128 : 256 * 128 + 128;
  const float* vecs;
  const float* gs;
  const float* gzp;
  const int* gcs;
  int N, G, gsize, zc;   // zc: kShift - zp_0
  float s0, gelu_c, lo, hi;

  __device__ __forceinline__ EdgeEpi(const Args& a, int n)
      : vecs(a.vecs), gs(a.gs), gzp(a.gzp), gcs(a.gcs), N(n), G(a.G),
        gsize(a.gsize), zc(kShift - static_cast<int>(a.gzp[0])),
        s0(a.gs[0]), gelu_c(a.gelu_c), lo(a.lo), hi(a.hi) {}
  __device__ __forceinline__ static Col pad() {
    return ColEdge{0.0f, 0.0f, 1.0f, 1.0f, 0.0f, 0};
  }
  __device__ __forceinline__ Col col(int n) const {
    ColEdge k;
    k.ws = vecs[n];
    k.b = vecs[2 * N + n];
    k.os = vecs[3 * N + n];
    k.inv = 1.0f / k.os;
    k.osh = vecs[4 * N + n];
    k.cs = GR ? 0 : (PL == 1 ? zc * gcs[n] : gcs[n]);
    return k;
  }
  // y = wscale * x + bias, act, then the 8-bit output site's level
  // (emit), that site's value on the [lo, hi] grid (fold) or y (float)
  __device__ __forceinline__ Out site(float x, const Col& k) const {
    const float y = tqmm::act_fn<ACT>(k.ws * x + k.b, gelu_c);
    if constexpr (OUT == 4) {
      return __float2bfloat16_rn(y);
    } else if constexpr (OUT == 3) {
      const float lvl =
          fminf(fmaxf(tqmm::rint_div_fma(y, k.os, k.inv) - k.osh, lo), hi);
      return __float2bfloat16_rn(k.os * (lvl + k.osh));
    } else if constexpr (OUT == 2) {
      return y;
    } else if constexpr (OUT == 1) {
      const float lvl =
          fminf(fmaxf(tqmm::rint_div_fma(y, k.os, k.inv) - k.osh, lo), hi);
      return k.os * (lvl + k.osh);
    } else {
      return tqmm::to_i8(fminf(
          fmaxf(tqmm::rint_div_fma(y, k.os, k.inv) - k.osh, -128.0f),
          127.0f));
    }
  }
  // one group of one plane: x = s_0 * f32(acc' + (128 - zp_0) colsum)
  __device__ __forceinline__ Out apply(int acc, const Col& k) const {
    return site(s0 * __int2float_rn(acc + k.cs), k);
  }
  // one group of two planes
  __device__ __forceinline__ Out apply(int lo, int hi, const Col& k) const {
    const long long a = static_cast<long long>(lo) + 256LL * hi +
                        static_cast<long long>(zc) * k.cs;
    return site(s0 * __ll2float_rn(a), k);
  }
  // groups: x is the main loop's float sum
  __device__ __forceinline__ Out apply(float x, const Col& k) const {
    return site(x, k);
  }

  // an 8-bit group of at most 128 columns: |acc_g| <= 255 * 128 * 128
  // < 2^22 (zp_g in [0, 255], as edge_grid checks), so its float
  // conversion can go by way of 1.5 * 2^23; a test of the kernel's
  // arguments alone, so that the compiler sees every warp take the same
  // branch (a branch it cannot prove uniform serializes the wgmma)
  __device__ __forceinline__ bool small() const {
    return PL == 1 && gsize <= 128;
  }
  // group g's table entry of column n < N: the correction (8-bit, plus
  // the 1.5 * 2^23 bits for a small group) or the column sum (16-bit)
  __device__ __forceinline__ int gentry(int g, int n) const {
    const int cs = gcs[g * N + n];
    if constexpr (PL == 2) return cs;
    const int v = (kShift - static_cast<int>(gzp[g])) * cs;
    return small() ? v + 0x4B400000 : v;
  }
  // y += s_g * f32(acc_g) where `end` (the unit ends group g), in the
  // accumulator layout of wgmma_common.cuh: a[4 j + 2 h + c] is column
  // 8 j + 2 t4 + c. Elsewhere y += 0 * f32(..), which leaves y as it is
  // but for the sign of a zero sum (-0 + 0 = +0): no output level moves
  // by it, and no select is needed.
  __device__ __forceinline__ void fold(const int (&a)[64], float (&y)[64],
                                       const int* gt, int g, int t4,
                                       bool end) const {
    const float s = end ? gs[g] : 0.0f;
    if (small()) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int2 c = *reinterpret_cast<const int2*>(gt + 8 * j + 2 * t4);
#pragma unroll
        for (int i = 4 * j; i < 4 * j + 4; ++i) {
          const float f =
              __fsub_rn(__int_as_float(a[i] + ((i & 1) ? c.y : c.x)),
                        tqmm::kMagic);
          y[i] = __fadd_rn(y[i], __fmul_rn(s, f));
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int2 c = *reinterpret_cast<const int2*>(gt + 8 * j + 2 * t4);
#pragma unroll
        for (int i = 4 * j; i < 4 * j + 4; ++i)
          y[i] = __fadd_rn(
              y[i], __fmul_rn(s, __int2float_rn(a[i] + ((i & 1) ? c.y : c.x))));
      }
    }
  }
  // two planes: acc_g = lo + 256 hi + (256 * 128 + 128 - zp_g) colsum_g
  // in int64, one conversion
  __device__ __forceinline__ void fold(const int (&lo)[64],
                                       const int (&hi)[64], float (&y)[64],
                                       const int* gt, int g, int t4,
                                       bool end) const {
    const float s = end ? gs[g] : 0.0f;
    const long long z = kShift - static_cast<long long>(gzp[g]);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int2 c = *reinterpret_cast<const int2*>(gt + 8 * j + 2 * t4);
#pragma unroll
      for (int i = 4 * j; i < 4 * j + 4; ++i) {
        const long long v = static_cast<long long>(lo[i]) + 256LL * hi[i] +
                            z * ((i & 1) ? c.y : c.x);
        y[i] = __fadd_rn(y[i], __fmul_rn(s, __ll2float_rn(v)));
      }
    }
  }
};

// the level pass: threads of a block, blocks an SM, the widest K (a
// block's shared memory: 11 rows of K floats)
constexpr int LT = 256;
constexpr int LEVEL_BLOCKS = 4;
constexpr int MAX_K = 4096;

// rows of levels a plane of the scratch holds
int plane_rows(int M, int planes) {
  return planes == 1 ? M : (M + 63) / 64 * 64;
}

// x's levels in group order, byte - 128, into the scratch lv (layout
// above), a row a warp: a block keeps, per group-order column, its source
// column, 1 / s_g and zp_g in shared memory; each warp copies its row of
// x into its own row buffer (float4 loads, four in flight a lane), then
// writes the row's levels, four columns a lane (rows past M: zeros, up
// to `rows`). The warps of an SM run apart, so one's copy hides
// another's arithmetic. Lane l takes its four source columns in the
// order l / 8, l / 8 + 1, ... (mod 4), so that the identity order (one
// group) reads 32 banks at once.
__global__ void __launch_bounds__(LT)
    levels_kernel(const float* __restrict__ x,
                  const long long* __restrict__ cols,
                  const float* __restrict__ ginv,
                  const float* __restrict__ gzp, int8_t* __restrict__ lv,
                  int M, int rows, int K, int gsize, int planes,
                  float maxq) {
  extern __shared__ float xs[];   // cols, 1 / s, zp, then a row a warp
  int* cs = reinterpret_cast<int*>(xs);
  float* cinv = xs + K;
  float* czp = xs + 2 * K;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* row = xs + (3 + warp) * static_cast<size_t>(K);
  const int k4 = K / 4;
  const int rot = (lane >> 3) & 3;
  for (int i = threadIdx.x; i < K; i += LT) {
    cs[i] = static_cast<int>(cols[i]);
    cinv[i] = ginv[i / gsize];
    czp[i] = gzp[i / gsize];
  }
  __syncthreads();
  for (int m = blockIdx.x * (LT / 32) + warp; m < rows;
       m += gridDim.x * (LT / 32)) {
    if (m < M) {
      const float4* x4 =
          reinterpret_cast<const float4*>(x) + static_cast<size_t>(m) * k4;
      for (int c = lane; c < k4; c += 4 * 32) {   // 4 loads in flight
        float4 v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (c + 32 * u < k4) v[u] = __ldcs(x4 + c + 32 * u);
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (c + 32 * u < k4)
            reinterpret_cast<float4*>(row)[c + 32 * u] = v[u];
      }
    }
    __syncwarp();
    for (int q = lane; q < k4; q += 32) {
      const int j = 4 * q;
      unsigned lo4 = 0u, hi4 = 0u;
      if (m < M) {
        const int4 c4 = *reinterpret_cast<const int4*>(cs + j);
        const float4 inv4 = *reinterpret_cast<const float4*>(cinv + j);
        const float4 zp4 = *reinterpret_cast<const float4*>(czp + j);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int e = (u + rot) & 3;
          const int ce = e == 0 ? c4.x : e == 1 ? c4.y : e == 2 ? c4.z : c4.w;
          const float inv =
              e == 0 ? inv4.x : e == 1 ? inv4.y : e == 2 ? inv4.z : inv4.w;
          const float zp =
              e == 0 ? zp4.x : e == 1 ? zp4.y : e == 2 ? zp4.z : zp4.w;
          const float lq =
              fminf(fmaxf(rintf(row[ce] * inv) + zp, 0.0f), maxq);
          const unsigned qi = static_cast<unsigned>(static_cast<int>(lq));
          lo4 |= ((qi & 255u) ^ 128u) << (8 * e);
          hi4 |= ((qi >> 8) ^ 128u) << (8 * e);
        }
      }
      if (planes == 1) {
        *reinterpret_cast<unsigned*>(lv + static_cast<size_t>(m) * K + j) =
            lo4;
      } else {
        const size_t lo_row = static_cast<size_t>(m >> 6) * 128 + (m & 63);
        *reinterpret_cast<unsigned*>(lv + lo_row * K + j) = lo4;
        *reinterpret_cast<unsigned*>(lv + (lo_row + 64) * K + j) = hi4;
      }
    }
    __syncwarp();   // the row is read before the next copy into it
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// the arguments both launches share
bool edge_ok(int M, int K, int gsize, int planes) {
  return M > 0 && K > 0 && K <= MAX_K && gsize > 0 && gsize % 64 == 0 &&
         K % gsize == 0 && (planes == 1 || planes == 2);
}

cudaError_t launch_levels(const void* x, const void* cols, const void* ginv,
                          const void* gzp, void* lv, int M, int K, int gsize,
                          int planes, float maxq, cudaStream_t st) {
  if (!edge_ok(M, K, gsize, planes) || !aligned16(x) || !aligned16(lv))
    return cudaErrorInvalidValue;
  const int rows = plane_rows(M, planes);
  const size_t smem = (3 + LT / 32) * static_cast<size_t>(K) * sizeof(float);
  static cudaError_t attr = cudaFuncSetAttribute(
      levels_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (3 + LT / 32) * MAX_K * static_cast<int>(sizeof(float)));
  static int sms = 0;
  if (attr != cudaSuccess) return attr;
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  const int need = (rows + LT / 32 - 1) / (LT / 32);   // a row a warp
  const int blocks = need < LEVEL_BLOCKS * sms ? need : LEVEL_BLOCKS * sms;
  levels_kernel<<<blocks, LT, smem, st>>>(
      static_cast<const float*>(x), static_cast<const long long*>(cols),
      static_cast<const float*>(ginv), static_cast<const float*>(gzp),
      static_cast<int8_t*>(lv), M, rows, K, gsize, planes, maxq);
  return cudaGetLastError();
}

// act 0 and 1 (gelu_new) at every output; 3-5 (gelu, gelu_poly10, tanh)
// emit or fold (OUT 0, 1); bfloat16 outputs (OUT 3, 4) act 0 only
template <int PL, int GR, int OUT>
cudaError_t launch_policy(int act, const CUtensorMap& mx,
                          const CUtensorMap& mw, const EdgeArgs& a, void* out,
                          int M, int N, int K, int sms, cudaStream_t st) {
  using tqwg::gemm_launch;
  if constexpr (OUT >= 3) {
    return gemm_launch<EdgeEpi<PL, GR, 0, OUT>>(mx, mw, a, out, M, N, K, sms,
                                                st);
  } else {
    if constexpr (OUT <= 1) {
      switch (act) {
        case 3: return gemm_launch<EdgeEpi<PL, GR, 3, OUT>>(mx, mw, a, out, M, N, K, sms, st);
        case 4: return gemm_launch<EdgeEpi<PL, GR, 4, OUT>>(mx, mw, a, out, M, N, K, sms, st);
        case 5: return gemm_launch<EdgeEpi<PL, GR, 5, OUT>>(mx, mw, a, out, M, N, K, sms, st);
        default: break;
      }
    }
  return act ? gemm_launch<EdgeEpi<PL, GR, 1, OUT>>(mx, mw, a, out, M, N, K,
                                                     sms, st)
             : gemm_launch<EdgeEpi<PL, GR, 0, OUT>>(mx, mw, a, out, M, N, K,
                                                     sms, st);
  }
}

// fold and float outputs: one group only (the grouped epilogues emit)
template <int PL>
cudaError_t launch_planes(int act, int out_mode, const CUtensorMap& mx,
                          const CUtensorMap& mw, const EdgeArgs& a, void* out,
                          int M, int N, int K, int sms, cudaStream_t st) {
  if (a.G == 1) {
    switch (out_mode) {
      case 0: return launch_policy<PL, 0, 0>(act, mx, mw, a, out, M, N, K, sms, st);
      case 1: return launch_policy<PL, 0, 1>(act, mx, mw, a, out, M, N, K, sms, st);
      case 3: return launch_policy<PL, 0, 3>(act, mx, mw, a, out, M, N, K, sms, st);
      case 4: return launch_policy<PL, 0, 4>(act, mx, mw, a, out, M, N, K, sms, st);
      default: return launch_policy<PL, 0, 2>(act, mx, mw, a, out, M, N, K, sms, st);
    }
  }
  if (out_mode != 0) return cudaErrorInvalidValue;
  if (a.gsize % tqwg::TK == 0)
    return launch_policy<PL, 1, 0>(act, mx, mw, a, out, M, N, K, sms, st);
  return launch_policy<PL, 2, 0>(act, mx, mw, a, out, M, N, K, sms, st);
}

cudaError_t launch_gemm(const void* lv, const void* w, const void* vecs,
                        const void* gs, const void* gzp, const void* gcs,
                        void* out, int M, int N, int K, int gsize,
                        int planes, int act, int out_mode, float lo,
                        float hi, float gelu_c, cudaStream_t st) {
  const int G = edge_ok(M, K, gsize, planes) ? K / gsize : 0;
  if (G == 0 || G > (planes == 1 ? 32 : 16) || act < 0 || act > 5 ||
      act == 2 ||
      out_mode < 0 || out_mode > 4 || (out_mode != 0 && G != 1) ||
      (out_mode == 2 && act > 1) || (out_mode > 2 && act != 0) ||
      !aligned16(out))
    return cudaErrorInvalidValue;
  const int rows = planes * plane_rows(M, planes);
  CUtensorMap mx, mw;
  int sms = 0;
  cudaError_t e = tqwg::gemm_setup(lv, w, rows, N, K, &mx, &mw, &sms);
  if (e == cudaSuccess && !tqwg::make_i8_map(&mx, lv, rows, K, 64 * planes))
    e = cudaErrorInvalidValue;   // boxes of one 64-row panel's planes
  if (e != cudaSuccess) return e;
  const EdgeArgs a{static_cast<const float*>(vecs),
                   static_cast<const float*>(gs),
                   static_cast<const float*>(gzp),
                   static_cast<const int*>(gcs), G, gsize, gelu_c, lo, hi};
  return planes == 1
             ? launch_planes<1>(act, out_mode, mx, mw, a, out, M, N, K, sms,
                                st)
             : launch_planes<2>(act, out_mode, mx, mw, a, out, M, N, K, sms,
                                st);
}

}  // namespace

// x: (M, K) f32; cols: (K,) int64 column order; ginv / gzp: (G,) f32
// reciprocal group scale, zero point; lv: the levels' int8 scratch, (M, K)
// for planes 1 (levels < 256) and (2 Mp, K) for planes 2, Mp = M rounded
// up to 64. gsize = K / G, a multiple of 64; K <= 4096; maxq: 2^bits - 1;
// x and lv 16-byte aligned. Launches the level pass on `stream`: x's
// levels into lv; returns its cudaError_t (cudaErrorInvalidValue for
// arguments the kernel does not take).
extern "C" int tq_float_edge_levels(const void* x, const void* cols,
                                    const void* ginv, const void* gzp,
                                    void* lv, int M, int K, int gsize,
                                    int planes, float maxq, void* stream) {
  return static_cast<int>(launch_levels(x, cols, ginv, gzp, lv, M, K, gsize,
                                        planes, maxq,
                                        static_cast<cudaStream_t>(stream)));
}

// lv: a level pass's scratch of M rows (arguments as above); w: (N, K)
// int8, columns in `cols` order; vecs: (5, N) f32; gs / gzp: (G,) f32
// group scale, zero point; gcs: (G, N) int32 per-group column sums of w;
// out: (M, N), int8 for out_mode 0 (emit: the 8-bit output site's levels,
// vecs rows 3 / 4) or f32 for 1 (fold: the site's values on the [lo, hi]
// level grid) and 2 (float: y), bf16 for 3 (fold) and 4 (float); fold and
// float need G == 1. G <= 32 (planes 1) or 16 (planes 2); N % 8 == 0;
// act: 0 none, 1 gelu_new, 3 gelu, 4 gelu_poly10, 5 tanh (3-5 emit or
// fold; out_mode 3 and 4 act 0); w and out 16-byte aligned. Launches the
// GEMM on `stream`.
extern "C" int tq_float_edge_gemm(const void* lv, const void* w,
                                  const void* vecs, const void* gs,
                                  const void* gzp, const void* gcs, void* out,
                                  int M, int N, int K, int gsize, int planes,
                                  int act, int out_mode, float lo, float hi,
                                  float gelu_c, void* stream) {
  return static_cast<int>(launch_gemm(lv, w, vecs, gs, gzp, gcs, out, M, N, K,
                                      gsize, planes, act, out_mode, lo, hi,
                                      gelu_c,
                                      static_cast<cudaStream_t>(stream)));
}
