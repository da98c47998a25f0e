// Float-edge matmul: a float32 value edge on a known grid against an int8
// weight, contracted exactly on int8 tensor cores.
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
// with the group sum taken in group order, then act and the 8-bit output
// site emitted as an int8 payload, as in int8_matmul (the flex FFN's inter
// matmul; fold and float outputs are not yet ported here). The JAX reference takes x @ w^T as a float32 dot
// product, whose result depends on its summation order; here every
// rounding happens after an exact integer sum, so the kernel and its plain
// version (float_edge_matmul_ref) agree bit for bit.
//
// What bounds it on the card: the int8 tensor-core rate. BERT-base inter
// (M = 16384, K = 768, N = 3072) is one 77.3 GOP product: 39 us at
// 1,979 TOP/s, against 103 MB of traffic (31 us), whatever the edge's
// width. A 16-bit edge costs this design two u8 products, so it runs at
// best at half the bound.
//
// Design: one block per 128 rows, resident over all of N. The block first
// turns its 128 x K float tile (read through `cols`: a PEG site's columns
// are gathered in group order) into levels in shared memory, once: u8
// planes of K + 16 bytes a row (16-bit levels split into hi and lo bytes;
// each plane's int32 sum fits: 768 * 255 * 127 < 2^31; the padding keeps
// the fragment loads bank-conflict free). Then it walks the N tiles with
// K1's inner loop (int8_matmul.cu): weight tiles through a two-stage
// cp.async ring, mma.sync m16n8k32 u8 x s8 -> s32 per plane. At each
// group's end the int32 partials fold into a float32 accumulator
// (256 * hi + lo and the zero-point term in int64, one conversion) and
// restart. A 16-bit edge keeps two integer accumulators, so its warps take
// 64 x 16 tiles instead of 64 x 32 to stay within the register file; its
// two planes of 768 columns take 197 KB of the 227 KB of shared memory,
// which bounds K (the wrapper checks).

#include "mm_common.cuh"

namespace {

using namespace tqmm;

template <int PLANES>
__host__ __device__ constexpr int tile_n() {
  return PLANES == 1 ? 128 : 64;
}

// dynamic shared memory: the level planes (BM rows of K + 16 bytes) and the
// weight ring
template <int PLANES>
size_t smem_bytes(int K) {
  return (size_t)PLANES * BM * (K + 16) + (size_t)2 * tile_n<PLANES>() * LDS;
}

template <int PLANES, int ACT>
__global__ void __launch_bounds__(THREADS)
    fe_mm_kernel(const float* __restrict__ x,
                 const long long* __restrict__ cols,
                 const int8_t* __restrict__ w, const float* __restrict__ vecs,
                 const float* __restrict__ gs, const float* __restrict__ ginv,
                 const float* __restrict__ gzp, const int* __restrict__ gcs,
                 int8_t* __restrict__ out, int M, int N, int K, int gsize,
                 float maxq, float gelu_c) {
  constexpr int NI = PLANES == 1 ? 4 : 2;  // 8-column mma tiles per warp
  constexpr int BN = tile_n<PLANES>();
  extern __shared__ __align__(16) int8_t smem[];
  const int KP = K + 16;                    // level row stride, bytes
  int8_t* sA = smem;                        // [PLANES][BM][KP]
  int8_t* sB = smem + (size_t)PLANES * BM * KP;  // [2][BN][LDS]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // mma groupID
  const int t = lane & 3;    // mma threadID_in_group
  const int m0 = blockIdx.x * BM;
  const int wm = (warp >> 2) * 64;
  const int wn = (warp & 3) * (8 * NI);

  // the block's levels, once: 4 columns (in group order) a thread a step
  const int quads = K / 4;
  for (int idx = tid; idx < BM * quads; idx += THREADS) {
    const int row = idx / quads;
    const int cq = (idx - row * quads) * 4;
    const int grp = cq / gsize;
    const float inv = ginv[grp];
    const float zp = gzp[grp];
    const int gm = m0 + row;
    unsigned lo4 = 0u, hi4 = 0u;
    if (gm < M) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float v = x[(size_t)gm * K + cols[cq + e]];
        const float q = fminf(fmaxf(rintf(v * inv) + zp, 0.0f), maxq);
        const unsigned qi = static_cast<unsigned>(__float2int_rn(q));
        lo4 |= (qi & 255u) << (8 * e);
        hi4 |= (qi >> 8) << (8 * e);
      }
    }
    *reinterpret_cast<unsigned*>(&sA[row * KP + cq]) = lo4;
    if (PLANES == 2)
      *reinterpret_cast<unsigned*>(&sA[(size_t)BM * KP + row * KP + cq]) =
          hi4;
  }
  __syncthreads();

  auto load_b = [&](int stage, int n0, int k0) {
    for (int c = tid; c < BN * 4; c += THREADS) {  // 16-byte chunks
      const int row = c >> 2;
      const int col = (c & 3) * 16;
      const int gn = n0 + row;
      const int gk = k0 + col;
      const bool pb = gn < N && gk < K;
      cp_async16(&sB[stage * BN * LDS + row * LDS + col],
                 pb ? w + (size_t)gn * K + gk : w, pb);
    }
  };

  const int ktiles = K / BK;
  for (int n0 = 0; n0 < N; n0 += BN) {
    int acc[PLANES][4][NI][4];
    float yacc[4][NI][4];
#pragma unroll
    for (int p = 0; p < PLANES; ++p)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[p][i][j][r] = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) yacc[i][j][r] = 0.0f;

    // the ring is empty here: the previous tile's last wait left only an
    // empty commit group pending
    load_b(0, n0, 0);
    cp_async_commit();
    for (int kt = 0; kt < ktiles; ++kt) {
      if (kt + 1 < ktiles) load_b((kt + 1) & 1, n0, (kt + 1) * BK);
      cp_async_commit();
      cp_async_wait1();
      __syncthreads();
      const int8_t* bs = sB + (kt & 1) * BN * LDS;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 32) {
        unsigned bf[NI][2];
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
          load_b_frag(bf[ni], bs, LDS, wn + ni * 8, kk, g, t);
#pragma unroll
        for (int p = 0; p < PLANES; ++p) {
          unsigned af[4][4];
#pragma unroll
          for (int mi = 0; mi < 4; ++mi)
            load_a_frag(af[mi], sA + (size_t)p * BM * KP, KP, wm + mi * 16,
                        kt * BK + kk, g, t);
#pragma unroll
          for (int mi = 0; mi < 4; ++mi)
#pragma unroll
            for (int ni = 0; ni < NI; ++ni)
              mma_k32<true>(acc[p][mi][ni], af[mi], bf[ni]);
        }
      }
      __syncthreads();
      if (((kt + 1) * BK) % gsize == 0) {
        // the group ends: s_g * float(acc_g) into the float accumulator
        const int grp = (kt * BK) / gsize;
        const float s = gs[grp];
        const long long zpl = static_cast<long long>(gzp[grp]);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int ni = 0; ni < NI; ++ni)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int col = n0 + wn + ni * 8 + t * 2 + (r & 1);
              long long a = acc[0][mi][ni][r];
              if (PLANES == 2) a += 256LL * acc[PLANES - 1][mi][ni][r];
              if (col < N) a -= zpl * gcs[(size_t)grp * N + col];
              const float tv = s * __ll2float_rn(a);
              yacc[mi][ni][r] = grp == 0 ? tv : yacc[mi][ni][r] + tv;
#pragma unroll
              for (int p = 0; p < PLANES; ++p) acc[p][mi][ni][r] = 0;
            }
      }
    }

#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = m0 + wm + mi * 16 + g + (r >= 2 ? 8 : 0);
          const int col = n0 + wn + ni * 8 + t * 2 + (r & 1);
          if (row < M && col < N) {
            const float y = vecs[col] * yacc[mi][ni][r] + vecs[2 * N + col];
            store_out<ACT, 0>(y, (size_t)row * N + col, col, N, vecs,
                              -128.0f, 127.0f, gelu_c, out);
          }
        }
      }
    }
  }
}

struct Args {
  const float* x;
  const long long* cols;
  const int8_t* w;
  const float* vecs;
  const float* gs;
  const float* ginv;
  const float* gzp;
  const int* gcs;
  int8_t* out;
  int M, N, K, gsize;
  float maxq, gelu_c;
};

template <int PLANES, int ACT>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes<PLANES>(a.K);
  static size_t smem_allowed = 0;  // raised once per size, not every launch
  if (smem > smem_allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        fe_mm_kernel<PLANES, ACT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    smem_allowed = smem;
  }
  fe_mm_kernel<PLANES, ACT><<<(a.M + BM - 1) / BM, THREADS, smem, stream>>>(
      a.x, a.cols, a.w, a.vecs, a.gs, a.ginv, a.gzp, a.gcs, a.out, a.M, a.N,
      a.K, a.gsize, a.maxq, a.gelu_c);
  return cudaGetLastError();
}

}  // namespace

// x: (M, K) f32; cols: (K,) int64 column order; w: (N, K) int8, columns in
// that order; vecs: (5, N) f32; gs / ginv / gzp: (G,) f32 group scale, its
// reciprocal, zero point; gcs: (G, N) int32 per-group column sums of w;
// gsize = K / G, a multiple of 64; planes: 1 (levels < 256) or 2; maxq:
// 2^bits - 1. act: 0 none, 1 gelu_new; out: (M, N) int8, the 8-bit
// output site's levels (vecs rows 3 / 4). A block takes
// planes * 128 * (K + 16) + 2 * (planes == 1 ? 128 : 64) * 80 bytes of
// shared memory. Returns the launch's cudaError_t.
extern "C" int tq_float_edge_matmul(
    const void* x, const void* cols, const void* w, const void* vecs,
    const void* gs, const void* ginv, const void* gzp, const void* gcs,
    void* out, int M, int N, int K, int gsize, int planes, float maxq,
    int act, float gelu_c, void* stream) {
  if (act < 0 || act > 1 || gsize <= 0 ||
      gsize % BK || K % gsize || (planes != 1 && planes != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(x),
               static_cast<const long long*>(cols),
               static_cast<const int8_t*>(w),
               static_cast<const float*>(vecs),
               static_cast<const float*>(gs),
               static_cast<const float*>(ginv),
               static_cast<const float*>(gzp),
               static_cast<const int*>(gcs),
               static_cast<int8_t*>(out), M, N, K, gsize, maxq, gelu_c};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (planes == 1)
    e = act ? launch<1, 1>(a, st) : launch<1, 0>(a, st);
  else
    e = act ? launch<2, 1>(a, st) : launch<2, 0>(a, st);
  return static_cast<int>(e);
}

