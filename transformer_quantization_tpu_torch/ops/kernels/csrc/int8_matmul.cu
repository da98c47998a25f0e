// Payload matmul with the dequant fold, activation and per-column output
// site in the epilogue (K1), for Hopper.
//
// Replaces: transformer_quantization_tpu/ops/pallas/engine_kernels.py
//   int8_matmul (_mm_kernel / _mm_body / _int_dot), and the matmul halves
//   of int8_matmul_add_ln, int8_ffn_ln, int8_attn_ln and int8_layer_ln.
//
//   acc = x8 (M, K) @ w8 (N, K)^T                 exact int32
//   y   = (in_s * wscale[n]) * (acc + in_shift * colsum[n]) + bias[n]
//   y   = act(y)                              (none | gelu_new | relu)
//   out = emit:  clip(rint(y / out_s[n]) - out_sh[n], -128, 127)  int8
//         fold:  out_s[n] * (clip(...) + out_sh[n])               float
//                (on the fold site's out_bits grid: [lo, hi] up to 16 bits)
//         float: y                                                float
//
// What bounds it on the card: the int8 tensor-core rate. At BERT-base
// shapes (M = 16384, K/N = 768..3072) every call does 19-77 GOP over
// 26-65 MB, 300-1200 int8 operations per byte, far above the H100's
// ~590 op/byte ridge (1,979 TOP/s over 3.35 TB/s). Beside the products,
// the epilogue runs some 16 (emit) to 40 (gelu_new) float instructions
// per output element, longer than the products themselves at K = 768;
// so the design runs one tile's epilogue under another tile's products.
//
// Design: a persistent, warp-specialized kernel, one 384-thread block per
// SM walking 128 x 128 output tiles (BN = 128: a warpgroup's int32
// accumulator is then 128 registers a thread, which leaves the epilogue
// room in a consumer's 232; BN = 256 would need 256).
// - Producer warpgroup (threads 256-383, 40 registers after setmaxnreg):
//   one thread issues cp.async.bulk.tensor.2d (TMA) loads of the x and w
//   tiles, 128 bytes of K each, 128-byte swizzled, into a ring of five
//   32 KB stages with full / empty mbarrier pairs. TMA's out-of-bounds
//   zero fill covers ragged M, N and K: zero rows and zero K columns add
//   nothing to the products. The tensor maps are made on the host
//   (cuTensorMapEncodeTiled, found through cudaGetDriverEntryPoint, so
//   the library needs no -lcuda) and passed as __grid_constant__, which
//   survives CUDA graph capture.
// - Two consumer warpgroups (232 registers each) in ping-pong: the
//   block's tiles alternate between them, and each owns a whole 128 x 128
//   tile (two wgmma.mma_async m64n128k32 s32.s8.s8 per k32 step, A and B
//   from shared memory through matrix descriptors, four k32 steps a
//   stage; 8-bit wgmma needs both operands K-major, and x (M, K) and
//   w (N, K) already are). The producer fills the ring in tile order; a
//   pair of turn mbarriers lets a warpgroup start its main loop only when
//   the other has issued its own, so one warpgroup's tile streams through
//   the tensor cores while the other runs the previous tile's epilogue.
//   (Without the turns a warpgroup could wait on a full barrier two
//   phases early, which passes at once.)
// - Epilogue: each tile's 128 column constants (ColSite) are loaded
//   before the main loop and written to shared memory after it. Each
//   element then takes store_site's steps from mm_common.cuh (fold,
//   act_fn, the site level, to_i8) in the same order, 16 elements at a
//   time so that their chains interleave; the level's rint(y / s) is
//   rint_div_fma, which gives rint_div's integers without its branch and
//   out-of-line call (with them the epilogue ran 25% slower). Each warp
//   stages its 32 rows in a 4 KB shared-memory buffer (XOR-swizzled by
//   16-byte chunk, so the writes and the reads are free of bank
//   conflicts; float outputs in four passes of 32 columns) and writes
//   them out in 16-byte vectors, 8 lanes per 128-byte row segment
//   (8-byte halves where N % 16 != 0).
// - Tiles are walked row panel by row panel (tile t = m * n_tiles + n):
//   the blocks in flight cover every column tile of a few row panels, so
//   x is read from memory about once, and the weight (at most 2.4 MB at
//   BERT-base) stays in L2.
// Limits: K % 16 == 0 (TMA's 16-byte row stride), N % 8 == 0, 16-byte
// aligned operands; M, N and K ragged against the tiles.
// Resources (nvcc 12.9 -Xptxas -v, every instance): 168 registers a
// thread at launch, moved by setmaxnreg to 40 (producer) / 232
// (consumers), no spills; 203,872 bytes of dynamic shared memory.
//
// Numerics: integer accumulation is exact in any order (|acc| < 2^31 at
// K = 3072); the int32 accumulator converts with __int2float_rn (as XLA's
// convert does) and the epilogue keeps the reference's association order;
// the file is built with -fmad=false so no multiply-add is contracted.
// rintf rounds half to even like torch.round / jnp.round. Every output is
// bit-identical to int8_matmul_ref.

#include "mm_common.cuh"
#include "wgmma_common.cuh"

namespace {

using namespace tqwg;
using tqmm::ColSite;

constexpr int TM = 128;                    // rows of a tile
constexpr int TN = 128;                    // columns of a tile (BN)
constexpr int TK = 128;                    // bytes of K per stage
constexpr int STAGES = 5;
constexpr int A_BYTES = TM * TK;
constexpr int STAGE_BYTES = A_BYTES + TN * TK;
constexpr int WARP_OUT = 32 * 128;         // a warp's staging buffer
constexpr int THREADS = 384;               // 2 consumer + 1 producer WGs
constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 8 * WARP_OUT +
                     2 * TN * static_cast<int>(sizeof(ColSite)) +
                     (2 * STAGES + 2) * 8;

// 8-column blocks whose elements one epilogue step interleaves
constexpr int EPI_NB = 2;

// EPI_NB 8-column blocks j0.. of a warp's 32-row share of the tile:
// store_site's steps on the thread's 8 elements of each (element e of a
// block: column lc + (e & 1), warp row e / 2) at once, so that their
// chains interleave, into the staging buffer (pass p of the float
// outputs). The site level is site_level's with rint_div_fma for
// rint_div: the same integers, without the branch and the call that
// would keep the compiler from interleaving.
template <int ACT, int OUT>
__device__ __forceinline__ void epi_block(const int (&acc)[2][64],
                                          const ColSite* tab, int j0, int p,
                                          int g, int t4, float lo, float hi,
                                          float gelu_c, uint8_t* stage) {
  ColSite k[2 * EPI_NB];
#pragma unroll
  for (int i = 0; i < 2 * EPI_NB; ++i)
    k[i] = tab[8 * (j0 + (i >> 1)) + 2 * t4 + (i & 1)];
  float y[8 * EPI_NB];
  int8_t b[8 * EPI_NB];
#pragma unroll
  for (int i = 0; i < 8 * EPI_NB; ++i) {
    const int j = j0 + (i >> 3), e = i & 7, r = e >> 1;
    const ColSite& kc = k[2 * (i >> 3) + (e & 1)];
    y[i] = tqmm::act_fn<ACT>(
        tqmm::fold(acc[r >> 1][4 * j + 2 * (r & 1) + (e & 1)], kc), gelu_c);
    if (OUT != 2) {
      const float lvl = fminf(
          fmaxf(tqmm::rint_div_fma(y[i], kc.os, kc.inv) - kc.osh, lo), hi);
      if (OUT == 0) b[i] = tqmm::to_i8(lvl);
      else y[i] = kc.os * (lvl + kc.osh);
    }
  }
#pragma unroll
  for (int i = 0; i < 4 * EPI_NB; ++i) {   // element pairs (c = 0, 1)
    const int lc = 8 * (j0 + (i >> 2)) + 2 * t4;
    const int r = i & 3;
    const int lr = 16 * (r >> 1) + 8 * (r & 1) + g;
    if (OUT == 0) {   // bytes, 16-byte chunk lc / 16
      *reinterpret_cast<uint16_t*>(
          stage + lr * 128 + (((lc >> 4) ^ (lr & 7)) << 4) + (lc & 15)) =
          static_cast<uint16_t>(static_cast<uint8_t>(b[2 * i]) |
                                (static_cast<uint8_t>(b[2 * i + 1]) << 8));
    } else {          // floats, 4-float chunk of the pass
      const int pc = lc - 32 * p;
      *reinterpret_cast<float2*>(reinterpret_cast<float*>(stage) +
                                 lr * 32 + (((pc >> 2) ^ (lr & 7)) << 2) +
                                 (pc & 3)) =
          make_float2(y[2 * i], y[2 * i + 1]);
    }
  }
}

template <int ACT, int OUT>
__device__ __forceinline__ void consume(
    const uint8_t* ring, uint64_t* full, uint64_t* empty, uint64_t* turn,
    ColSite* tab, uint8_t* stage, const float* __restrict__ vecs, float in_s,
    float in_sh, void* __restrict__ out, int M, int N, int ktiles, int tiles,
    int n_tiles, int wg, float lo, float hi, float gelu_c) {
  const int tid = threadIdx.x & 127;
  const int w = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  int acc[2][64];
  for (int t = blockIdx.x + wg * gridDim.x, local = wg; t < tiles;
       t += 2 * gridDim.x, local += 2) {
    const int m0 = (t / n_tiles) * TM;
    const int n0 = (t % n_tiles) * TN;

    // this tile's column constants, one column per thread: loaded now,
    // written to the table after the main loop (which hides the loads)
    ColSite kcol{0.0f, 0.0f, 0.0f, 1.0f, 1.0f, 0.0f};
    if (n0 + tid < N) kcol = tqmm::col_site(vecs, N, n0 + tid, in_s, in_sh);

    // main loop, in turn with the other warpgroup: it waits until the
    // other one has taken every stage before this tile's (a full barrier
    // waited on two phases early would pass at once), so the ring order
    // and the turns alternate the two over the tensor cores
    if (local > 1) mbar_wait(&turn[wg], ((local >> 1) - 1 + wg) & 1);
    else if (local == 1) mbar_wait(&turn[1], 0);
    // this tile's stages sit at ring positions local * ktiles..
    const long long first = static_cast<long long>(local) * ktiles;
    int s = static_cast<int>(first % STAGES);
    uint32_t ph = static_cast<uint32_t>((first / STAGES) & 1);
    int prev = 0;
    for (int kt = 0; kt < ktiles; ++kt) {
      mbar_wait(&full[s], ph);
      const uint8_t* a = ring + s * STAGE_BYTES;
      const uint64_t da = sw128_desc(a);
      const uint64_t db = sw128_desc(a + A_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TK / 32; ++kk) {
        const int scale = (kt | kk) != 0;
        wgmma_m64n128k32_s8(acc[0], da + 2 * kk, db + 2 * kk, scale);
        wgmma_m64n128k32_s8(acc[1], da + (64 * TK >> 4) + 2 * kk,
                            db + 2 * kk, scale);
      }
      wgmma_commit();
      if (kt > 0) {
        wgmma_wait<1>();
        mbar_arrive(&empty[prev]);
      }
      prev = s;
      if (++s == STAGES) {
        s = 0;
        ph ^= 1;
      }
    }
    if (tid == 0) mbar_arrive(&turn[wg ^ 1]);
    wgmma_wait<0>();
    mbar_arrive(&empty[prev]);
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      fence_reg(acc[0][i]);
      fence_reg(acc[1][i]);
    }
    named_sync(1 + wg, 128);   // the last epilogue is done with the table
    tab[tid] = kcol;
    named_sync(1 + wg, 128);   // the table is written

    // epilogue: the warp's 32 rows (local row lr = 16 half + 8 h + g is
    // tile row 64 half + 16 w + 8 h + g) through its staging buffer
    constexpr int PASSES = OUT == 0 ? 1 : 4;   // floats: 32 columns a pass
    constexpr int JP = 16 / PASSES;            // 8-column blocks a pass
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
#pragma unroll
      for (int jj = 0; jj < JP; jj += EPI_NB)
        epi_block<ACT, OUT>(acc, tab, p * JP + jj, p, g, t4, lo, hi, gelu_c,
                            stage);
      __syncwarp();
      // 32 rows x 128 bytes: 8 lanes per row, 16 bytes each
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int lr = 4 * i + (lane >> 3);
        const int chunk = lane & 7;
        const uint4 v = *reinterpret_cast<const uint4*>(
            stage + lr * 128 + ((chunk ^ (lr & 7)) << 4));
        const int row = m0 + 64 * (lr >> 4) + 16 * w + (lr & 15);
        if (row >= M) continue;
        if (OUT == 0) {
          const int col = n0 + 16 * chunk;
          int8_t* dst = static_cast<int8_t*>(out) +
                        static_cast<size_t>(row) * N + col;
          if (col + 16 <= N && (N & 15) == 0) {
            *reinterpret_cast<uint4*>(dst) = v;
          } else {
            if (col + 8 <= N)
              *reinterpret_cast<uint2*>(dst) = make_uint2(v.x, v.y);
            if (col + 16 <= N)
              *reinterpret_cast<uint2*>(dst + 8) = make_uint2(v.z, v.w);
          }
        } else {
          const int col = n0 + 32 * p + 4 * chunk;
          if (col < N)
            *reinterpret_cast<uint4*>(static_cast<float*>(out) +
                                      static_cast<size_t>(row) * N + col) =
                v;
        }
      }
      __syncwarp();
    }
  }
}

template <int ACT, int OUT>
__global__ void __launch_bounds__(THREADS, 1)
    int8_mm_kernel(const __grid_constant__ CUtensorMap map_x,
                   const __grid_constant__ CUtensorMap map_w,
                   const float* __restrict__ vecs,
                   const float* __restrict__ scal, void* __restrict__ out,
                   int M, int N, int K, float lo, float hi, float gelu_c) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* staging = ring + STAGES * STAGE_BYTES;
  ColSite* tab = reinterpret_cast<ColSite*>(staging + 8 * WARP_OUT);
  uint64_t* full = reinterpret_cast<uint64_t*>(tab + 2 * TN);
  uint64_t* empty = full + STAGES;
  uint64_t* turn = empty + STAGES;   // turn[c]: warpgroup c's main loop

  const int n_tiles = (N + TN - 1) / TN;
  const int tiles = ((M + TM - 1) / TM) * n_tiles;
  const int ktiles = (K + TK - 1) / TK;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);
    }
    mbar_init(&turn[0], 1);
    mbar_init(&turn[1], 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread keeps the ring full, tile after tile
    regs_dealloc<40>();
    if (threadIdx.x == 256) {
      tma_prefetch_map(&map_x);
      tma_prefetch_map(&map_w);
      int s = 0;
      uint32_t ph = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (t / n_tiles) * TM;
        const int n0 = (t % n_tiles) * TN;
        for (int kt = 0; kt < ktiles; ++kt) {
          mbar_wait(&empty[s], ph ^ 1);
          uint8_t* st = ring + s * STAGE_BYTES;
          mbar_arrive_expect_tx(&full[s], STAGE_BYTES);
          tma_load_2d(st, &map_x, &full[s], kt * TK, m0);
          tma_load_2d(st + A_BYTES, &map_w, &full[s], kt * TK, n0);
          if (++s == STAGES) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
  } else {
    regs_alloc<232>();
    consume<ACT, OUT>(ring, full, empty, turn, tab + wg * TN,
                      staging + (threadIdx.x >> 5) * WARP_OUT, vecs, scal[0],
                      scal[1], out, M, N, ktiles, tiles, n_tiles, wg, lo, hi,
                      gelu_c);
  }
}

template <int ACT, int OUT>
cudaError_t launch(const CUtensorMap& mx, const CUtensorMap& mw,
                   const float* vecs, const float* scal, void* out, int M,
                   int N, int K, float lo, float hi, float gelu_c,
                   int sms, cudaStream_t stream) {
  static cudaError_t attr = cudaFuncSetAttribute(
      int8_mm_kernel<ACT, OUT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM);
  if (attr != cudaSuccess) return attr;
  const int tiles = ((M + TM - 1) / TM) * ((N + TN - 1) / TN);
  const int grid = tiles < sms ? tiles : sms;
  int8_mm_kernel<ACT, OUT><<<grid, THREADS, SMEM, stream>>>(
      mx, mw, vecs, scal, out, M, N, K, lo, hi, gelu_c);
  return cudaGetLastError();
}

template <int ACT>
cudaError_t launch_act(int out_mode, const CUtensorMap& mx,
                       const CUtensorMap& mw, const float* vecs,
                       const float* scal, void* out, int M, int N, int K,
                       float lo, float hi, float gelu_c, int sms,
                       cudaStream_t st) {
  switch (out_mode) {
    case 0: return launch<ACT, 0>(mx, mw, vecs, scal, out, M, N, K, lo, hi, gelu_c, sms, st);
    case 1: return launch<ACT, 1>(mx, mw, vecs, scal, out, M, N, K, lo, hi, gelu_c, sms, st);
    default: return launch<ACT, 2>(mx, mw, vecs, scal, out, M, N, K, lo, hi, gelu_c, sms, st);
  }
}

}  // namespace

// act: 0 none, 1 gelu_new, 2 relu. out_mode: 0 emit (int8), 1 fold (f32),
// 2 float (f32). [lo, hi]: the output site's level bounds (emit: 8-bit).
// x (M, K) and w (N, K) int8, 16-byte aligned, K % 16 == 0, N % 8 == 0.
// Returns the launch's cudaError_t (cudaErrorInvalidValue for arguments
// the kernel does not take, or a tensor map that cannot be encoded).
extern "C" int tq_int8_matmul(const void* x, const void* w, const void* vecs,
                              const void* scal, void* out, int M, int N,
                              int K, int act, int out_mode, float lo,
                              float hi, float gelu_c, void* stream) {
  if (act < 0 || act > 2 || out_mode < 0 || out_mode > 2 || M <= 0 ||
      N <= 0 || K <= 0 || K % 16 || N % 8 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) & 15)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mx, mw;
  if (!make_i8_map(&mx, x, M, K, TM) || !make_i8_map(&mw, w, N, K, TN))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const float* vp = static_cast<const float*>(vecs);
  const float* sp = static_cast<const float*>(scal);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (act) {
    case 0: e = launch_act<0>(out_mode, mx, mw, vp, sp, out, M, N, K, lo, hi, gelu_c, sms, st); break;
    case 1: e = launch_act<1>(out_mode, mx, mw, vp, sp, out, M, N, K, lo, hi, gelu_c, sms, st); break;
    default: e = launch_act<2>(out_mode, mx, mw, vp, sp, out, M, N, K, lo, hi, gelu_c, sms, st); break;
  }
  return static_cast<int>(e);
}
