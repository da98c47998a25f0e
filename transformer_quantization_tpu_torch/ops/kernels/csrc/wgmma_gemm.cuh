// The persistent warp-specialized int8 GEMM for Hopper, shared by four
// kernels: the payload matmul (int8_matmul.cu, K1), the fused linear
// (fused_int8_linear.cu), MobileBERT's NoNorm matmul (int8_matmul_norm.cu,
// K6) and the float-edge matmul (float_edge_matmul.cu, K4): the producer
// warpgroup's TMA ring, the two consumer warpgroups' wgmma main loop in
// ping-pong, and a staged epilogue, templated on an epilogue policy that
// says what an output element is. K1 and the fused linear also build
// each policy on a split-half packed int4 weight (W4Epi, kW4 below).
//
//   out[m][n] = Epi::apply(acc[m][n], col[n] [, r8[m][n]])
//   acc = x (M, K) @ w (N, K)^T
//
// x and w are int8, K-major, read through host-made tensor maps
// (make_i8_map). An epilogue policy Epi gives:
//   Col                   the per-column constants of one output column;
//   Out                   the output element type (int8_t, float or
//                         __nv_bfloat16);
//   Args                  the kernel argument it is made from (by value);
//   Epi(const Args&, N)   the per-call scalars, once per consumer thread;
//   static Col pad()      the constants of a column past N (never stored);
//   Col col(n) const      the constants of column n < N;
//   Out apply(acc, col)   one element's steps from its int32 sum;
// and, where it departs from the defaults (a policy that says nothing
// compiles as K1 and the fused linear do):
//   kResidual = true      each element also reads r8[m][n] of an (M, N)
//                         int8 input, the member `const int8_t* r8`
//                         (row-major, 16-byte aligned; int8 outputs
//                         only), through Out apply(acc, col, r);
//   kTM = 64              tiles of 64 rows, not 128 (x's tensor map then
//                         has 64-row boxes): a call with few column tiles
//                         still gives both consumer warpgroups tiles;
//   kEpiNB = 1            one 8-column block an epilogue step, not two;
//   kPlanes = 2           (kTM = 64, no residual) x's rows come in
//                         128-row boxes that hold two planes of the tile's
//                         64 rows (rows 0-63 and 64-127 of the box; x's
//                         map has 128-row boxes over 2 * 64 * tiles rows),
//                         summed into acc[0] and acc[1] against one B
//                         descriptor: Out apply(acc0, acc1, col);
//   kGroups = G > 0       the K columns fall into the member `int G`
//                         groups of `int gsize` columns (a multiple of
//                         32 kFoldSteps) whose int32 sums the main loop
//                         folds one by one into a float sum, Out
//                         apply(float, col) then: each tile first writes
//                         `int gentry(g, n)` for its columns into a
//                         G x 128 table in shared memory (G <= kGroups);
//                         after each unit of kFoldSteps k32 steps'
//                         products has completed, `fold(acc, y, row, g,
//                         t4, end)` (two planes: `fold(acc0, acc1, y, row,
//                         g, t4, end)`) adds group g's sums to y where
//                         `end` (the unit ends the group), and the next
//                         unit restarts the sums;
//   kFoldSteps = 2        (kGroups) a commit, wait and fold every two k32
//                         steps, for groups of 64 columns (default 4: one
//                         a stage);
//   kRegs = 240           registers a consumer thread (the producer then
//                         keeps 24, not 40);
//   kW4 = true            (W4Epi<E>, or K6's NormEpiW4 with its residual:
//                         kTM = 128, one plane, no groups) w is the
//                         (N, K/2) split-half packed int4
//                         weight, byte j of a row holding column j in its
//                         low nibble and column K/2 + j in its high one
//                         (the JAX package's layout), read through a map
//                         made by gemm_setup_w4; K % 32 == 0.
//
// Design: one 384-thread block per SM walking kTM x 128 output tiles row
// panel by row panel (tile t = m * n_tiles + n: the blocks in flight cover
// every column tile of a few row panels, so x is read from memory about
// once and the weight stays in L2).
// - Producer warpgroup (threads 256-383, 40 registers after setmaxnreg):
//   one thread issues cp.async.bulk.tensor.2d (TMA) loads of the x and w
//   tiles, 128 bytes of K each, 128-byte swizzled, into a ring of five
//   stages (32 KB at 128 rows, 24 KB at 64) with full / empty mbarrier
//   pairs. TMA's out-of-bounds zero fill covers ragged M, N and K: zero
//   rows and zero K columns add nothing to the products. The tensor maps
//   are passed as __grid_constant__, which survives CUDA graph capture.
// - Two consumer warpgroups (232 registers each) in ping-pong: the
//   block's tiles alternate between them, and each owns a whole tile (one
//   wgmma.mma_async m64n128k32 s32.s8.s8 per 64 rows and k32 step, A and
//   B from shared memory through matrix descriptors, four k32 steps a
//   stage; 8-bit wgmma needs both operands K-major). A pair of turn
//   mbarriers lets a warpgroup start its main loop only when the other
//   has issued its own, so one warpgroup's tile streams through the
//   tensor cores while the other runs the previous tile's epilogue.
//   (Without the turns a warpgroup could wait on a full barrier two
//   phases early, which passes at once.)
// - Epilogue: a tile's 128 column constants are loaded before its main
//   loop (which hides the loads) and written to shared memory after it.
//   A thread takes its elements of kEpiNB 8-column blocks through
//   Epi::apply at once (8 a block at 128 rows, 4 at 64: 16 for K1, 4 for
//   K6, 8 for K4) so that their chains interleave. Each warp stages its
//   kTM / 4 rows in a 4 KB shared-memory buffer (XOR-swizzled by 16-byte
//   chunk, so the writes and the reads are free of bank conflicts; float
//   outputs in four passes of 32 columns) and writes them out in 16-byte
//   vectors, 8 lanes per 128-byte row segment (8-byte halves where
//   N % 16 != 0).
// - Packed int4 weights (kW4): the weight stays packed in device memory.
//   A stage holds K columns k0..k0+63 and K/2 + k0..K/2 + k0 + 63 (k0 =
//   64 kt): TMA loads x's two 64-byte boxes (64-byte swizzled) as the A
//   tile's two halves and the packed weight's 128 x 64-byte box, both
//   nibbles of those columns, unswizzled over the B tile's second half.
//   The producer warpgroup's other three warps unpack it in place once the
//   stage's loads land (unpack_w4: lo nibbles to the first half, hi
//   nibbles to the second, each as 16 w, 64-byte swizzled) and arrive on
//   the stage's third mbarrier, "unpacked", which the consumers wait on
//   beside "full"; the consumers run the k32 steps on the lo halves and
//   the hi halves (sw64_desc). The kernel is gemm_kernel_w4. The sum is
//   x[:, :K/2] @ lo^T + x[:, K/2:] @ hi^T, the JAX _int_dot(w4). Where
//   K/2 % 64 != 0 the last packed box runs past K/2 and TMA fills it with
//   zeros, so both nibbles of those columns are 0 and add nothing,
//   whatever x's boxes hold there (the lo box reads x's real columns past
//   K/2; the hi box past K reads zeros).
// - The residual (kResidual): before its main loop each warp issues
//   cp.async loads of its rows of r8 into its staging buffer, with the
//   store loop's addressing (16-byte vectors, 8-byte halves where
//   N % 16 != 0, zeros past M and N), so that they land under the main
//   loop and take no registers; after it each thread reads an element
//   pair where it then writes the output pair. No shared memory is added.
// Limits: K % 16 == 0 (TMA's 16-byte row stride; kW4: K % 32 == 0),
// N % 8 == 0, 16-byte aligned operands (gemm_setup checks x and w, the
// caller out and r8); M, N and K ragged against the tiles.

#pragma once

#include <cuda_bf16.h>

#include <type_traits>

#include "wgmma_common.cuh"

namespace tqwg {

constexpr int TM = 128;                    // rows of a tile (Epi::kTM: 64)
constexpr int TN = 128;                    // columns of a tile (BN)
constexpr int TK = 128;                    // bytes of K per stage
constexpr int STAGES = 5;
constexpr int WARP_OUT = 32 * 128;         // a warp's staging buffer
constexpr int THREADS = 384;               // 2 consumer + 1 producer WGs

// 8-column blocks whose elements one epilogue step interleaves
constexpr int EPI_NB = 2;

// A policy's optional members (the contract above) and their defaults:
// kResidual false, kTM = TM, kEpiNB = EPI_NB, kPlanes 1, kGroups 0,
// kFoldSteps TK / 32, kRegs 232.
template <class E, class = void>
struct epi_residual : std::false_type {};
template <class E>
struct epi_residual<E, std::void_t<decltype(E::kResidual)>>
    : std::bool_constant<E::kResidual> {};
template <class E, class = void>
struct epi_tm : std::integral_constant<int, TM> {};
template <class E>
struct epi_tm<E, std::void_t<decltype(E::kTM)>>
    : std::integral_constant<int, E::kTM> {};
template <class E, class = void>
struct epi_nb : std::integral_constant<int, EPI_NB> {};
template <class E>
struct epi_nb<E, std::void_t<decltype(E::kEpiNB)>>
    : std::integral_constant<int, E::kEpiNB> {};
template <class E, class = void>
struct epi_planes : std::integral_constant<int, 1> {};
template <class E>
struct epi_planes<E, std::void_t<decltype(E::kPlanes)>>
    : std::integral_constant<int, E::kPlanes> {};
template <class E, class = void>
struct epi_groups : std::integral_constant<int, 0> {};
template <class E>
struct epi_groups<E, std::void_t<decltype(E::kGroups)>>
    : std::integral_constant<int, E::kGroups> {};
template <class E, class = void>
struct epi_fold_steps : std::integral_constant<int, TK / 32> {};
template <class E>
struct epi_fold_steps<E, std::void_t<decltype(E::kFoldSteps)>>
    : std::integral_constant<int, E::kFoldSteps> {};
template <class E, class = void>
struct epi_regs : std::integral_constant<int, 232> {};
template <class E>
struct epi_regs<E, std::void_t<decltype(E::kRegs)>>
    : std::integral_constant<int, E::kRegs> {};
template <class E, class = void>
struct epi_w4 : std::false_type {};
template <class E>
struct epi_w4<E, std::void_t<decltype(E::kW4)>>
    : std::bool_constant<E::kW4> {};

// policy E on a split-half packed int4 weight (kW4)
template <class E>
struct W4Epi : E {
  static constexpr bool kW4 = true;
  using E::E;
};

// bytes of a ring stage: the x tile (tm rows) and the w tile
__host__ __device__ constexpr int stage_bytes(int tm) {
  return (tm + TN) * TK;
}

// dynamic shared memory of a block: the ring (1 KB aligned), the staging
// buffers, the two warpgroups' column tables, the mbarriers and (kGroups)
// the two warpgroups' group tables
template <class Epi>
constexpr int gemm_smem() {
  return 1024 +
         STAGES * stage_bytes(epi_tm<Epi>::value * epi_planes<Epi>::value) +
         8 * WARP_OUT +
         2 * TN * static_cast<int>(sizeof(typename Epi::Col)) +
         (2 * STAGES + 2) * 8 + 2 * epi_groups<Epi>::value * TN * 4;
}

// NB 8-column blocks j0.. of a warp's 16 H-row share of the tile (H =
// kTM / 64 halves): Epi::apply on the thread's EB = 4 H elements of each
// (element e of a block: column lc + (e & 1), warp row e / 2) at once, so
// that their chains interleave, into the staging buffer (pass p of the
// float outputs). With a residual, each element pair's input bytes are
// first read from where its output pair is then written. With two planes
// (HA = 2 H) an element is apply(acc[0][i], acc[1][i], col); with a group
// fold the accumulator A is the tile's float sum.
template <class Epi, int H, int HA, class A>
__device__ __forceinline__ void epi_block(const A (&acc)[HA][64],
                                          const typename Epi::Col* tab,
                                          int j0, int p, int g, int t4,
                                          const Epi& epi, uint8_t* stage) {
  using Out = typename Epi::Out;
  constexpr int NB = epi_nb<Epi>::value;
  constexpr int EB = 4 * H, LE = H + 1;   // elements of a block, log2
  constexpr int PB = 2 * H, LP = H;       // element pairs of a block, log2
  typename Epi::Col k[2 * NB];
#pragma unroll
  for (int i = 0; i < 2 * NB; ++i)
    k[i] = tab[8 * (j0 + (i >> 1)) + 2 * t4 + (i & 1)];
  Out o[EB * NB];
  if constexpr (epi_residual<Epi>::value) {
    uint16_t rin[PB * NB];   // the residual's element pairs
#pragma unroll
    for (int i = 0; i < PB * NB; ++i) {
      const int lc = 8 * (j0 + (i >> LP)) + 2 * t4;
      const int r = i & (PB - 1);
      const int lr = 16 * (r >> 1) + 8 * (r & 1) + g;
      rin[i] = *reinterpret_cast<const uint16_t*>(
          stage + lr * 128 + (((lc >> 4) ^ (lr & 7)) << 4) + (lc & 15));
    }
#pragma unroll
    for (int i = 0; i < EB * NB; ++i) {
      const int j = j0 + (i >> LE), e = i & (EB - 1), r = e >> 1;
      o[i] = epi.apply(acc[r >> 1][4 * j + 2 * (r & 1) + (e & 1)],
                       k[2 * (i >> LE) + (e & 1)],
                       static_cast<int8_t>(rin[i >> 1] >> (8 * (i & 1))));
    }
  } else if constexpr (HA == H) {
#pragma unroll
    for (int i = 0; i < EB * NB; ++i) {
      const int j = j0 + (i >> LE), e = i & (EB - 1), r = e >> 1;
      o[i] = epi.apply(acc[r >> 1][4 * j + 2 * (r & 1) + (e & 1)],
                       k[2 * (i >> LE) + (e & 1)]);
    }
  } else {
    static_assert(HA == 2 && H == 1, "two planes of 64-row tiles");
#pragma unroll
    for (int i = 0; i < EB * NB; ++i) {
      const int j = j0 + (i >> LE), e = i & (EB - 1);
      const int a = 4 * j + 2 * (e >> 1) + (e & 1);
      o[i] = epi.apply(acc[0][a], acc[1][a], k[2 * (i >> LE) + (e & 1)]);
    }
  }
#pragma unroll
  for (int i = 0; i < PB * NB; ++i) {   // element pairs (c = 0, 1)
    const int lc = 8 * (j0 + (i >> LP)) + 2 * t4;
    const int r = i & (PB - 1);
    const int lr = 16 * (r >> 1) + 8 * (r & 1) + g;
    if constexpr (sizeof(Out) == 1) {   // bytes, 16-byte chunk lc / 16
      *reinterpret_cast<uint16_t*>(
          stage + lr * 128 + (((lc >> 4) ^ (lr & 7)) << 4) + (lc & 15)) =
          static_cast<uint16_t>(static_cast<uint8_t>(o[2 * i]) |
                                (static_cast<uint8_t>(o[2 * i + 1]) << 8));
    } else if constexpr (sizeof(Out) == 2) {   // 16-bit, 8-value chunk
      const int pc = lc - 64 * p;
      *reinterpret_cast<uint32_t*>(
          stage + lr * 128 + (((pc >> 3) ^ (lr & 7)) << 4) + 2 * (pc & 7)) =
          static_cast<uint32_t>(__bfloat16_as_ushort(o[2 * i])) |
          (static_cast<uint32_t>(__bfloat16_as_ushort(o[2 * i + 1])) << 16);
    } else {                            // floats, 4-float chunk of the pass
      const int pc = lc - 32 * p;
      *reinterpret_cast<float2*>(reinterpret_cast<float*>(stage) +
                                 lr * 32 + (((pc >> 2) ^ (lr & 7)) << 2) +
                                 (pc & 3)) = make_float2(o[2 * i], o[2 * i + 1]);
    }
  }
}

// The warp's 16 H rows x 128 bytes of the (M, N) int8 input r8 at tile
// (m0, n0) into its staging buffer, laid out as the store loop reads it:
// cp.async, 8 lanes per row segment, 16 bytes each (8-byte halves where
// N % 16 != 0), zeros past M and N. The caller waits (cp_async_wait_all,
// __syncwarp) before it reads them.
template <int H>
__device__ __forceinline__ void stage_residual(const int8_t* r8,
                                               uint8_t* stage, int m0,
                                               int n0, int M, int N, int w,
                                               int lane) {
#pragma unroll
  for (int i = 0; i < 4 * H; ++i) {
    const int lr = 4 * i + (lane >> 3);
    const int chunk = lane & 7;
    uint8_t* dst = stage + lr * 128 + ((chunk ^ (lr & 7)) << 4);
    const int row = m0 + 64 * (lr >> 4) + 16 * w + (lr & 15);
    const int col = n0 + 16 * chunk;
    const int8_t* src = r8 + static_cast<size_t>(row) * N + col;
    if ((N & 15) == 0) {
      const bool in = row < M && col < N;
      cp_async<16>(dst, in ? src : r8, in ? 16 : 0);
    } else {
      const bool lo = row < M && col + 8 <= N;
      const bool hi = row < M && col + 16 <= N;
      cp_async<8>(dst, lo ? src : r8, lo ? 8 : 0);
      cp_async<8>(dst + 8, hi ? src + 8 : r8, hi ? 8 : 0);
    }
  }
}

// blocks of 8 weight rows an unpacking warp loads before it stores any
constexpr int W4_ILP = 2;

// (kW4) The stage's packed weight box (TN rows x 64 bytes, unswizzled, as
// TMA wrote it over the B tile's second half) unpacked in place into the
// B tile's two TN x 64-byte halves, 64-byte swizzled as sw64_desc reads
// them (16-byte chunk c of row r at c ^ ((r >> 1) & 3)): the lo nibbles
// into the first half, the hi nibbles into the second, each as the high
// half of its byte, an int8 of 16 w (lo: (v << 4) & 0xF0.., hi: v &
// 0xF0..: two operations a word, where sign-extending w took nine), so
// the products sum 16 acc, exact in int32 (|16 acc| < 2^31 for K <
// 131072), and the consumers take acc back by an arithmetic shift right
// of 4 before the epilogue. Warp w of `warps`
// takes the blocks of 8 rows w, w + warps, .., W4_ILP blocks' loads
// before their stores; four lanes a row, one 16-byte chunk each (loads
// and stores free of bank conflicts), so a row's lanes are one warp,
// which reads the row before it writes it.
__device__ __forceinline__ void unpack_w4(uint8_t* b, int w, int warps,
                                          int lane) {
  constexpr int ILP = W4_ILP;
  uint8_t* bh = b + TN * 64;
  const int c = lane & 3;
#pragma unroll 1
  for (int j0 = w; j0 < TN / 8; j0 += ILP * warps) {
    uint4 v[ILP];
#pragma unroll
    for (int i = 0; i < ILP; ++i) {
      const int r = 8 * (j0 + i * warps) + (lane >> 2);
      if (r < TN)
        v[i] = *reinterpret_cast<const uint4*>(bh + r * 64 + c * 16);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < ILP; ++i) {
      const int r = 8 * (j0 + i * warps) + (lane >> 2);
      if (r >= TN) break;
      const int off = r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
      constexpr uint32_t HI = 0xF0F0F0F0u;
      *reinterpret_cast<uint4*>(b + off) =
          make_uint4((v[i].x << 4) & HI, (v[i].y << 4) & HI,
                     (v[i].z << 4) & HI, (v[i].w << 4) & HI);
      *reinterpret_cast<uint4*>(bh + off) =
          make_uint4(v[i].x & HI, v[i].y & HI, v[i].z & HI, v[i].w & HI);
    }
  }
}

template <class Epi>
__device__ __forceinline__ void consume(
    const uint8_t* ring, uint64_t* full, uint64_t* empty, uint64_t* turn,
    typename Epi::Col* tab, int* gtab, uint8_t* stage, const Epi& epi,
    void* __restrict__ out, int M, int N, int ktiles, int tiles, int n_tiles,
    int wg) {
  constexpr bool BYTES = sizeof(typename Epi::Out) == 1;
  constexpr bool RES = epi_residual<Epi>::value;
  static_assert(BYTES || !RES, "a residual needs int8 outputs");
  constexpr int TMe = epi_tm<Epi>::value;
  static_assert(TMe == 64 || TMe == 128, "tiles of 64 or 128 rows");
  constexpr int PL = epi_planes<Epi>::value;
  static_assert(PL == 1 || (PL == 2 && TMe == 64 && !RES),
                "two planes: 64-row tiles, no residual");
  constexpr bool GROUPS = epi_groups<Epi>::value > 0;
  constexpr bool W4 = epi_w4<Epi>::value;
  static_assert(!W4 || (TMe == 128 && PL == 1 && !GROUPS),
                "packed int4: 128-row tiles, one plane");
  constexpr int H = TMe / 64;               // m64 halves of a tile
  constexpr int HA = H * PL;                // accumulators of a stage
  constexpr int A_BYTES = TMe * PL * TK;
  constexpr int STAGE_BYTES = stage_bytes(TMe * PL);
  const int tid = threadIdx.x & 127;
  const int w = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  int acc[HA][64];
  float yacc[1][GROUPS ? 64 : 1];           // the group fold's float sum
  for (int t = blockIdx.x + wg * gridDim.x, local = wg; t < tiles;
       t += 2 * gridDim.x, local += 2) {
    const int m0 = (t / n_tiles) * TMe;
    const int n0 = (t % n_tiles) * TN;

    // this tile's column constants, one column per thread: loaded now,
    // written to the table after the main loop (which hides the loads)
    // (with a group fold, after it: its registers are all taken)
    typename Epi::Col kcol = Epi::pad();
    if constexpr (!GROUPS)
      if (n0 + tid < N) kcol = epi.col(n0 + tid);
    // the residual's rows, in flight under the main loop
    if constexpr (RES) stage_residual<H>(epi.r8, stage, m0, n0, M, N, w, lane);
    // the group table, read by the folds in the main loop (the last tile's
    // folds ended before its epilogue's first barrier)
    if constexpr (GROUPS) {
      for (int gi = 0; gi < epi.G; ++gi)
        gtab[gi * TN + tid] = n0 + tid < N ? epi.gentry(gi, n0 + tid) : 0;
      named_sync(1 + wg, 128);
    }

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
    if constexpr (GROUPS) {
      // per group g: acc_g (int32, exact), then y += s_g * f32(acc_g -
      // zp_g colsum_g) in group order (Epi::fold), once the products of
      // the unit (U k32 steps of a stage) that ends the group have
      // completed; the next unit restarts the sums. ptxas serializes
      // every wgmma of a kernel that reads accumulators in a path it
      // cannot prove uniform or while a wgmma is in flight (a fold of one
      // stage under the next stage's products from a copy of its sums ran
      // 11% slower at PEG's shape on an H100), so a fold follows its wait
      // and takes `end` as a value, never under a branch.
      constexpr int U = epi_fold_steps<Epi>::value;
      static_assert(U > 0 && (TK / 32) % U == 0, "units within a stage");
#pragma unroll
      for (int i = 0; i < 64; ++i) yacc[0][i] = -0.0f;   // -0 + t == t
      const int per = epi.gsize / (32 * U);   // units a group
      int gi = 0, sg = 0;   // the group, and the unit's place in it
      for (int kt = 0; kt < ktiles; ++kt) {
        mbar_wait(&full[s], ph);
        const uint8_t* a = ring + s * STAGE_BYTES;
        const uint64_t da = sw128_desc(a);
        const uint64_t db = sw128_desc(a + A_BYTES);
        if (kt == ktiles - 1 && tid == 0) mbar_arrive(&turn[wg ^ 1]);
        // a loop, not unrolled: with two folds in one body ptxas spilled
        // the two-plane sums (40 bytes at 240 registers, H100 build)
#pragma unroll 1
        for (int u = 0; u < TK / 32; u += U) {
          wgmma_fence();
#pragma unroll
          for (int kk = u; kk < u + U; ++kk) {
            const int scale = (sg | (kk - u)) != 0;
            wgmma_m64n128k32_s8(acc[0], da + 2 * kk, db + 2 * kk, scale);
            if constexpr (PL == 2)
              wgmma_m64n128k32_s8(acc[1], da + (64 * TK >> 4) + 2 * kk,
                                  db + 2 * kk, scale);
          }
          wgmma_commit();
          wgmma_wait<0>();
          if (u + U == TK / 32) {   // the stage's last unit
            mbar_arrive(&empty[s]);
            if (++s == STAGES) {
              s = 0;
              ph ^= 1;
            }
          }
#pragma unroll
          for (int i = 0; i < 64; ++i) {
            fence_reg(acc[0][i]);
            if constexpr (PL == 2) fence_reg(acc[1][i]);
          }
          const bool end = ++sg == per && gi < epi.G;
          const int g = gi < epi.G ? gi : epi.G - 1;   // units past K: zeros
          gi += end;
          sg = end ? 0 : sg;
          if constexpr (PL == 2)
            epi.fold(acc[0], acc[1], yacc[0], gtab + g * TN, g, t4, end);
          else
            epi.fold(acc[0], yacc[0], gtab + g * TN, g, t4, end);
        }
      }
      // the sums are folded: zeros let the compiler free their registers
      // through the epilogue (the next tile's first products overwrite
      // them, but read them as wgmma operands)
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        acc[0][i] = 0;
        if constexpr (PL == 2) acc[1][i] = 0;
      }
      if (n0 + tid < N) kcol = epi.col(n0 + tid);
    } else {
    for (int kt = 0; kt < ktiles; ++kt) {
      mbar_wait(&full[s], ph);
      const uint8_t* a = ring + s * STAGE_BYTES;
      if constexpr (W4) {
        // the weight's nibbles are in the B tile (gemm_kernel_w4's
        // "unpacked" barriers follow the turns); the k32 steps: x's lo
        // half against the lo nibbles (kk = 0, 1), the hi halves (2, 3),
        // 32 bytes into each 64-byte row
        mbar_wait(&turn[2 + s], ph);
        const uint64_t da = sw64_desc(a);
        const uint64_t db = sw64_desc(a + A_BYTES);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < TK / 32; ++kk) {
          const int scale = (kt | kk) != 0;
          const int oa = (kk >> 1) * (TMe * 64 >> 4) + 2 * (kk & 1);
          const int ob = (kk >> 1) * (TN * 64 >> 4) + 2 * (kk & 1);
          wgmma_m64n128k32_s8(acc[0], da + oa, db + ob, scale);
          wgmma_m64n128k32_s8(acc[1], da + oa + (64 * 64 >> 4), db + ob,
                              scale);
        }
      } else {
      const uint64_t da = sw128_desc(a);
      const uint64_t db = sw128_desc(a + A_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TK / 32; ++kk) {
        const int scale = (kt | kk) != 0;
        wgmma_m64n128k32_s8(acc[0], da + 2 * kk, db + 2 * kk, scale);
        if constexpr (HA == 2)
          wgmma_m64n128k32_s8(acc[1], da + (64 * TK >> 4) + 2 * kk,
                              db + 2 * kk, scale);
      }
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
      if constexpr (HA == 2) fence_reg(acc[1][i]);
    }
    if constexpr (W4) {   // the products of 16 w: acc exactly
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        acc[0][i] >>= 4;
        acc[1][i] >>= 4;
      }
    }
    }
    named_sync(1 + wg, 128);   // the last epilogue is done with the table
    tab[tid] = kcol;
    named_sync(1 + wg, 128);   // the table is written

    // epilogue: the warp's 16 H rows (local row lr = 16 half + 8 h + g is
    // tile row 64 half + 16 w + 8 h + g) through its staging buffer
    constexpr bool HALVES = sizeof(typename Epi::Out) == 2;
    // floats: 32 columns a pass; 16-bit values 64
    constexpr int PASSES = BYTES ? 1 : (HALVES ? 2 : 4);
    constexpr int JP = 16 / PASSES;         // 8-column blocks a pass
    if constexpr (RES) {
      cp_async_wait_all();
      __syncwarp();
    }
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
#pragma unroll
      for (int jj = 0; jj < JP; jj += epi_nb<Epi>::value) {
        if constexpr (GROUPS)
          epi_block<Epi, H>(yacc, tab, p * JP + jj, p, g, t4, epi, stage);
        else
          epi_block<Epi, H>(acc, tab, p * JP + jj, p, g, t4, epi, stage);
      }
      __syncwarp();
      // 16 H rows x 128 bytes: 8 lanes per row, 16 bytes each
#pragma unroll
      for (int i = 0; i < 4 * H; ++i) {
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
        } else if (HALVES) {
          const int col = n0 + 64 * p + 8 * chunk;
          if (col < N)
            *reinterpret_cast<uint4*>(static_cast<uint16_t*>(out) +
                                      static_cast<size_t>(row) * N + col) =
                v;
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
  constexpr int TMe = epi_tm<Epi>::value;
  constexpr int BOX = TMe * epi_planes<Epi>::value;   // x rows a stage
  constexpr int STAGE_BYTES = stage_bytes(BOX);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* staging = ring + STAGES * STAGE_BYTES;
  Col* tab = reinterpret_cast<Col*>(staging + 8 * WARP_OUT);
  uint64_t* full = reinterpret_cast<uint64_t*>(tab + 2 * TN);
  uint64_t* empty = full + STAGES;
  uint64_t* turn = empty + STAGES;   // turn[c]: warpgroup c's main loop
  int* gtab = reinterpret_cast<int*>(turn + 2);   // kGroups x TN a WG

  const int n_tiles = (N + TN - 1) / TN;
  const int tiles = ((M + TMe - 1) / TMe) * n_tiles;
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

  // registers a thread: the consumers' kRegs, the producer the rest of
  // the launch's 168 a thread (setmaxnreg.inc takes only what .dec
  // released, or it waits for ever)
  constexpr int CREGS = epi_regs<Epi>::value;
  constexpr int PREGS = 3 * 168 - 2 * CREGS;
  static_assert(CREGS % 8 == 0 && PREGS >= 24, "setmaxnreg's counts");
  if (wg == 2) {
    // producer: one thread keeps the ring full, tile after tile
    regs_dealloc<PREGS>();
    if (threadIdx.x == 256) {
      tma_prefetch_map(&map_x);
      tma_prefetch_map(&map_w);
      int s = 0;
      uint32_t ph = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (t / n_tiles) * BOX;
        const int n0 = (t % n_tiles) * TN;
        for (int kt = 0; kt < ktiles; ++kt) {
          mbar_wait(&empty[s], ph ^ 1);
          uint8_t* st = ring + s * STAGE_BYTES;
          mbar_arrive_expect_tx(&full[s], STAGE_BYTES);
          tma_load_2d(st, &map_x, &full[s], kt * TK, m0);
          tma_load_2d(st + BOX * TK, &map_w, &full[s], kt * TK, n0);
          if (++s == STAGES) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
  } else {
    regs_alloc<CREGS>();
    const Epi epi(args, N);
    consume<Epi>(ring, full, empty, turn, tab + wg * TN,
                 gtab + wg * epi_groups<Epi>::value * TN,
                 staging + (threadIdx.x >> 5) * WARP_OUT, epi, out, M, N,
                 ktiles, tiles, n_tiles, wg);
  }
}

// The kernel of a policy with kW4: gemm_kernel (kTM = 128, one plane)
// with the packed weight's stage loads ("Packed int4 weights" above). It
// is a kernel of its own so that the other instances' machine code stays
// as it was: a branch on kW4 in gemm_kernel's producer loop, though
// discarded at compile time, changed ptxas's code for every instance.
template <class Epi>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_kernel_w4(const __grid_constant__ CUtensorMap map_x,
                   const __grid_constant__ CUtensorMap map_w,
                   const typename Epi::Args args, void* __restrict__ out,
                   int M, int N, int K) {
  static_assert(epi_w4<Epi>::value, "a packed-int4 policy");
  using Col = typename Epi::Col;
  constexpr int STAGE_BYTES = stage_bytes(TM);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* staging = ring + STAGES * STAGE_BYTES;
  Col* tab = reinterpret_cast<Col*>(staging + 8 * WARP_OUT);
  uint64_t* full = reinterpret_cast<uint64_t*>(tab + 2 * TN);
  uint64_t* empty = full + STAGES;
  uint64_t* turn = empty + STAGES;
  uint64_t* unpacked = turn + 2;   // a stage's B tile is unpacked

  const int n_tiles = (N + TN - 1) / TN;
  const int tiles = ((M + TM - 1) / TM) * n_tiles;
  const int ktiles = (K + TK - 1) / TK;   // = K/2 / 64 rounded up
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);
      mbar_init(&unpacked[s], 96);
    }
    mbar_init(&turn[0], 1);
    mbar_init(&turn[1], 1);
    fence_barrier_init();
  }
  __syncthreads();

  constexpr int CREGS = epi_regs<Epi>::value;
  constexpr int PREGS = 3 * 168 - 2 * CREGS;
  if (wg == 2) {
    regs_dealloc<PREGS>();
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
          // x's columns k0.. and K/2 + k0.. into the A tile's halves, the
          // packed columns k0.. (both nibbles) over the B tile's second
          // half (k0 = 64 kt)
          mbar_arrive_expect_tx(&full[s], 2 * TM * 64 + TN * 64);
          tma_load_2d(st, &map_x, &full[s], kt * 64, m0);
          tma_load_2d(st + TM * 64, &map_x, &full[s], (K >> 1) + kt * 64,
                      m0);
          tma_load_2d(st + TM * TK + TN * 64, &map_w, &full[s], kt * 64,
                      n0);
          if (++s == STAGES) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    } else if (threadIdx.x >= 288) {
      // warps 1-3: each stage's weight unpacked once its loads land,
      // in the ring's order, up to STAGES stages ahead of the consumers
      const int w = (threadIdx.x >> 5) - 9;
      int s = 0;
      uint32_t ph = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        for (int kt = 0; kt < ktiles; ++kt) {
          mbar_wait(&full[s], ph);
          unpack_w4(ring + s * STAGE_BYTES + TM * TK, w, 3,
                    threadIdx.x & 31);
          fence_proxy_async();   // the writes, visible to wgmma
          mbar_arrive(&unpacked[s]);
          if (++s == STAGES) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
  } else {
    regs_alloc<CREGS>();
    const Epi epi(args, N);
    consume<Epi>(ring, full, empty, turn, tab + wg * TN, nullptr,
                 staging + (threadIdx.x >> 5) * WARP_OUT, epi, out, M, N,
                 ktiles, tiles, n_tiles, wg);
  }
}

// the card's SM count
inline cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return e;
}

// The tensor maps of x (M, K) and w (N, K) and the card's SM count, after
// the checks the kernel needs (M, N, K > 0, K % 16 == 0, N % 8 == 0,
// 16-byte aligned x and w); cudaErrorInvalidValue for what it does not
// take or a map that cannot be encoded. x's boxes are TM rows: a policy
// with kTM = 64 remakes its map with make_i8_map(mx, x, M, K, 64).
inline cudaError_t gemm_setup(const void* x, const void* w, int M, int N,
                              int K, CUtensorMap* mx, CUtensorMap* mw,
                              int* sms) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 || N % 8 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) & 15)
    return cudaErrorInvalidValue;
  if (!make_i8_map(mx, x, M, K, TM) || !make_i8_map(mw, w, N, K, TN))
    return cudaErrorInvalidValue;
  return sm_count(sms);
}

// gemm_setup for a policy with kW4: x (M, K) read in TM x 64-byte boxes,
// 64-byte swizzled, and the packed weight wp (N, K/2) in TN x 64-byte
// boxes, unswizzled; K % 32 == 0 (the packed rows' 16-byte stride)
inline cudaError_t gemm_setup_w4(const void* x, const void* wp, int M,
                                 int N, int K, CUtensorMap* mx,
                                 CUtensorMap* mw, int* sms) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 32 || N % 8 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(wp)) &
          15)
    return cudaErrorInvalidValue;
  if (!make_u8_map(mx, x, M, K, 64, TM, CU_TENSOR_MAP_SWIZZLE_64B) ||
      !make_u8_map(mw, wp, N, K / 2, 64, TN, CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  return sm_count(sms);
}

// one launch of the GEMM with epilogue Epi: a block per SM, at most one
// per tile; returns the launch's cudaError_t
template <class Epi>
cudaError_t gemm_launch(const CUtensorMap& mx, const CUtensorMap& mw,
                        const typename Epi::Args& args, void* out, int M,
                        int N, int K, int sms, cudaStream_t stream) {
  constexpr int smem = gemm_smem<Epi>();
  constexpr int tm = epi_tm<Epi>::value;
  const int tiles = ((M + tm - 1) / tm) * ((N + TN - 1) / TN);
  const int grid = tiles < sms ? tiles : sms;
  if constexpr (epi_w4<Epi>::value) {
    constexpr int smem4 = smem + STAGES * 8;   // the "unpacked" barriers
    static cudaError_t attr = cudaFuncSetAttribute(
        gemm_kernel_w4<Epi>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem4);
    if (attr != cudaSuccess) return attr;
    gemm_kernel_w4<Epi><<<grid, THREADS, smem4, stream>>>(mx, mw, args, out,
                                                          M, N, K);
  } else {
    static cudaError_t attr = cudaFuncSetAttribute(
        gemm_kernel<Epi>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (attr != cudaSuccess) return attr;
    gemm_kernel<Epi><<<grid, THREADS, smem, stream>>>(mx, mw, args, out, M,
                                                      N, K);
  }
  return cudaGetLastError();
}

}  // namespace tqwg
