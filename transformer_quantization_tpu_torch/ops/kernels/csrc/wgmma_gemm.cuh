// The persistent warp-specialized int8 GEMM for Hopper, shared by the
// payload matmul (int8_matmul.cu, K1) and the fused linear
// (fused_int8_linear.cu): the producer warpgroup's TMA ring, the two
// consumer warpgroups' wgmma main loop in ping-pong, and a staged
// epilogue, templated on an epilogue policy that says what an output
// element is.
//
//   out[m][n] = Epi::apply(acc[m][n], col[n])     acc = x (M, K) @ w (N, K)^T
//
// x and w are int8, K-major, read through host-made tensor maps
// (make_i8_map). An epilogue policy Epi gives:
//   Col                   the per-column constants of one output column;
//   Out                   the output element type (int8_t or float);
//   Args                  the kernel argument it is made from (by value);
//   Epi(const Args&, N)   the per-call scalars, once per consumer thread;
//   static Col pad()      the constants of a column past N (never stored);
//   Col col(n) const      the constants of column n < N;
//   Out apply(acc, col)   one element's steps from its int32 sum.
//
// Design: one 384-thread block per SM walking 128 x 128 output tiles row
// panel by row panel (tile t = m * n_tiles + n: the blocks in flight cover
// every column tile of a few row panels, so x is read from memory about
// once and the weight stays in L2).
// - Producer warpgroup (threads 256-383, 40 registers after setmaxnreg):
//   one thread issues cp.async.bulk.tensor.2d (TMA) loads of the x and w
//   tiles, 128 bytes of K each, 128-byte swizzled, into a ring of five
//   32 KB stages with full / empty mbarrier pairs. TMA's out-of-bounds
//   zero fill covers ragged M, N and K: zero rows and zero K columns add
//   nothing to the products. The tensor maps are passed as
//   __grid_constant__, which survives CUDA graph capture.
// - Two consumer warpgroups (232 registers each) in ping-pong: the
//   block's tiles alternate between them, and each owns a whole 128 x 128
//   tile (two wgmma.mma_async m64n128k32 s32.s8.s8 per k32 step, A and B
//   from shared memory through matrix descriptors, four k32 steps a
//   stage; 8-bit wgmma needs both operands K-major). A pair of turn
//   mbarriers lets a warpgroup start its main loop only when the other
//   has issued its own, so one warpgroup's tile streams through the
//   tensor cores while the other runs the previous tile's epilogue.
//   (Without the turns a warpgroup could wait on a full barrier two
//   phases early, which passes at once.)
// - Epilogue: a tile's 128 column constants are loaded before its main
//   loop (which hides the loads) and written to shared memory after it.
//   Elements go through Epi::apply 16 at a time so that their chains
//   interleave. Each warp stages its 32 rows in a 4 KB shared-memory
//   buffer (XOR-swizzled by 16-byte chunk, so the writes and the reads are
//   free of bank conflicts; float outputs in four passes of 32 columns)
//   and writes them out in 16-byte vectors, 8 lanes per 128-byte row
//   segment (8-byte halves where N % 16 != 0).
// Limits: K % 16 == 0 (TMA's 16-byte row stride), N % 8 == 0, 16-byte
// aligned operands (gemm_setup checks them); M, N and K ragged against
// the tiles.

#pragma once

#include "wgmma_common.cuh"

namespace tqwg {

constexpr int TM = 128;                    // rows of a tile
constexpr int TN = 128;                    // columns of a tile (BN)
constexpr int TK = 128;                    // bytes of K per stage
constexpr int STAGES = 5;
constexpr int A_BYTES = TM * TK;
constexpr int STAGE_BYTES = A_BYTES + TN * TK;
constexpr int WARP_OUT = 32 * 128;         // a warp's staging buffer
constexpr int THREADS = 384;               // 2 consumer + 1 producer WGs

// dynamic shared memory of a block: the ring (1 KB aligned), the staging
// buffers, the two warpgroups' column tables and the mbarriers
template <class Col>
constexpr int gemm_smem() {
  return 1024 + STAGES * STAGE_BYTES + 8 * WARP_OUT +
         2 * TN * static_cast<int>(sizeof(Col)) + (2 * STAGES + 2) * 8;
}

// 8-column blocks whose elements one epilogue step interleaves
constexpr int EPI_NB = 2;

// EPI_NB 8-column blocks j0.. of a warp's 32-row share of the tile:
// Epi::apply on the thread's 8 elements of each (element e of a block:
// column lc + (e & 1), warp row e / 2) at once, so that their chains
// interleave, into the staging buffer (pass p of the float outputs).
template <class Epi>
__device__ __forceinline__ void epi_block(const int (&acc)[2][64],
                                          const typename Epi::Col* tab,
                                          int j0, int p, int g, int t4,
                                          const Epi& epi, uint8_t* stage) {
  using Out = typename Epi::Out;
  typename Epi::Col k[2 * EPI_NB];
#pragma unroll
  for (int i = 0; i < 2 * EPI_NB; ++i)
    k[i] = tab[8 * (j0 + (i >> 1)) + 2 * t4 + (i & 1)];
  Out o[8 * EPI_NB];
#pragma unroll
  for (int i = 0; i < 8 * EPI_NB; ++i) {
    const int j = j0 + (i >> 3), e = i & 7, r = e >> 1;
    o[i] = epi.apply(acc[r >> 1][4 * j + 2 * (r & 1) + (e & 1)],
                     k[2 * (i >> 3) + (e & 1)]);
  }
#pragma unroll
  for (int i = 0; i < 4 * EPI_NB; ++i) {   // element pairs (c = 0, 1)
    const int lc = 8 * (j0 + (i >> 2)) + 2 * t4;
    const int r = i & 3;
    const int lr = 16 * (r >> 1) + 8 * (r & 1) + g;
    if constexpr (sizeof(Out) == 1) {   // bytes, 16-byte chunk lc / 16
      *reinterpret_cast<uint16_t*>(
          stage + lr * 128 + (((lc >> 4) ^ (lr & 7)) << 4) + (lc & 15)) =
          static_cast<uint16_t>(static_cast<uint8_t>(o[2 * i]) |
                                (static_cast<uint8_t>(o[2 * i + 1]) << 8));
    } else {                            // floats, 4-float chunk of the pass
      const int pc = lc - 32 * p;
      *reinterpret_cast<float2*>(reinterpret_cast<float*>(stage) +
                                 lr * 32 + (((pc >> 2) ^ (lr & 7)) << 2) +
                                 (pc & 3)) = make_float2(o[2 * i], o[2 * i + 1]);
    }
  }
}

template <class Epi>
__device__ __forceinline__ void consume(
    const uint8_t* ring, uint64_t* full, uint64_t* empty, uint64_t* turn,
    typename Epi::Col* tab, uint8_t* stage, const Epi& epi,
    void* __restrict__ out, int M, int N, int ktiles, int tiles, int n_tiles,
    int wg) {
  constexpr bool BYTES = sizeof(typename Epi::Out) == 1;
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
    typename Epi::Col kcol = Epi::pad();
    if (n0 + tid < N) kcol = epi.col(n0 + tid);

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
    constexpr int PASSES = BYTES ? 1 : 4;   // floats: 32 columns a pass
    constexpr int JP = 16 / PASSES;         // 8-column blocks a pass
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
#pragma unroll
      for (int jj = 0; jj < JP; jj += EPI_NB)
        epi_block<Epi>(acc, tab, p * JP + jj, p, g, t4, epi, stage);
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
        if (BYTES) {
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

template <class Epi>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap map_x,
                const __grid_constant__ CUtensorMap map_w,
                const typename Epi::Args args, void* __restrict__ out, int M,
                int N, int K) {
  using Col = typename Epi::Col;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* staging = ring + STAGES * STAGE_BYTES;
  Col* tab = reinterpret_cast<Col*>(staging + 8 * WARP_OUT);
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
    const Epi epi(args, N);
    consume<Epi>(ring, full, empty, turn, tab + wg * TN,
                 staging + (threadIdx.x >> 5) * WARP_OUT, epi, out, M, N,
                 ktiles, tiles, n_tiles, wg);
  }
}

// The tensor maps of x (M, K) and w (N, K) and the card's SM count, after
// the checks the kernel needs (M, N, K > 0, K % 16 == 0, N % 8 == 0,
// 16-byte aligned x and w); cudaErrorInvalidValue for what it does not
// take or a map that cannot be encoded.
inline cudaError_t gemm_setup(const void* x, const void* w, int M, int N,
                              int K, CUtensorMap* mx, CUtensorMap* mw,
                              int* sms) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 || N % 8 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) & 15)
    return cudaErrorInvalidValue;
  if (!make_i8_map(mx, x, M, K, TM) || !make_i8_map(mw, w, N, K, TN))
    return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return e;
}

// one launch of the GEMM with epilogue Epi: a block per SM, at most one
// per tile; returns the launch's cudaError_t
template <class Epi>
cudaError_t gemm_launch(const CUtensorMap& mx, const CUtensorMap& mw,
                        const typename Epi::Args& args, void* out, int M,
                        int N, int K, int sms, cudaStream_t stream) {
  constexpr int smem = gemm_smem<typename Epi::Col>();
  static cudaError_t attr = cudaFuncSetAttribute(
      gemm_kernel<Epi>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const int tiles = ((M + TM - 1) / TM) * ((N + TN - 1) / TN);
  const int grid = tiles < sms ? tiles : sms;
  gemm_kernel<Epi><<<grid, THREADS, smem, stream>>>(mx, mw, args, out, M, N,
                                                    K);
  return cudaGetLastError();
}

}  // namespace tqwg
