// A whole MobileBERT encoder layer in one launch (K8), for Hopper.
//
// Replaces: transformer_quantization_tpu/ops/pallas/engine_kernels.py
//   int8_mb_layer_ln (_mb_layer_kernel).
//
//   li8 = nonorm(bn_in(h8))                  bottleneck in, no residual
//   sh8 = nonorm(bn_attn(h8))                shared key/query bottleneck
//   qk8 = [q | k](sh8), v8 = v(h8)           (bottleneck: both from li8)
//   c8  = attention(q, k, v)                 per head
//   x8  = nonorm(attn_out(c8) + li8)
//   x8  = nonorm(dense_j(act(inter_j(x8))) + x8)   stacked FFNs, then the
//                                                  output FFN
//   out = nonorm(out_bn(x8) + h8)            bottleneck out
//
// Any matmul's weight may instead be a split-half packed int4 one (w4:
// (N, K/2) bytes, byte j holding column j in its low nibble and column
// K/2 + j in its high one, the JAX int8_mb_layer_ln's per-matmul w4).
//
// What bounds it on the card: operations, and then the epilogues'
// instructions. At MobileBERT-uncased widths (H = 512, bottleneck 128,
// intermediate 512, 4 heads of 32, 3 stacked FFNs) a layer at B = 128,
// S = 128 is 27.4 GOP of int8 products plus 1.07 GOP of attention (14.4
// us at 1,979 TOP/s) against 8.4 MB of h8 read and written once (2.5 us
// at 3.35 TB/s); each 128-row tile reads the layer's 835,584 weight bytes
// from L2 (107 MB a layer at S = 128); and the ~63 M outputs of its
// matmuls each take 20-45 instructions of fold, site and NoNorm
// arithmetic (~0.04 ms of the card's issue slots at 20).
//
// Design: one 384-thread block an SM walks tiles of whole sequences and
// keeps each tile's live set in shared memory: h8 (the bottleneck-out
// residual, then the layer's output in its place), li8 / x8, and one
// union that holds sh8 / c8, q, k and v^T during attention and the FFN
// inter payload after it; every payload in the 128-byte swizzled K-major
// layout that wgmma's descriptors read (v^T in 64-byte swizzled halves of
// 64 keys), the layout fixed at compile time (SM_*).
// - A producer warp streams every matmul's weight tiles (128 rows x 128
//   bytes of K, TMA through a tensor map a matrix) in the layer's fixed
//   order through a ring of four 16 KB stages (full / empty mbarriers),
//   so it runs ahead across matmul boundaries, epilogues and attention.
// - Two consumer warpgroups run every matmul as units of 128 output
//   columns on wgmma m64nNk32 s8 (A and B from shared memory), one
//   generic unit (main loop, column table, an epilogue by Kind). Tiles of
//   128 rows (one sequence at S = 128, two at 64, four at 32): each
//   warpgroup owns 64 rows, and every step but attention at S = 128 is
//   row-local, so they meet at no barrier but their own. Where 128-row
//   tiles would leave SMs idle (S <= 64 and B * S / 64 tiles fit the
//   card: B = 128 at S = 64 and 32), tiles of 64 rows whose warpgroups
//   split each unit's columns and the heads (COLS), meeting after each
//   matmul.
// - Each epilogue element takes mm_common.cuh's site_out (K1's steps) or
//   nonorm_out (K6's) on a column's constants staged in a table, and
//   lands as a packed pair in the layout the next matmul's descriptor
//   reads; a residual pair is read where its output pair is written.
// - v^T comes from the tensor cores as W_v . x^T (A = the weight tile,
//   B = 64 rows of x), so its per-column constants become per-row ones;
//   each 4-byte store holds four keys in the order the probs' A fragments
//   hold them, and the same registers give v's sums per 32-key block.
//   q's and k's row sums per head come from the [q | k] epilogue.
// - Attention, per head: the scores on wgmma (q's rows against the
//   sequence's keys), attn_common.cuh's softmax (K7's arithmetic, its
//   integer path and its double sums) on the accumulator registers, the
//   probs packed as p.v's A fragments in registers, p.v on wgmma against
//   v^T, and the context's payload over sh8 (dead by then). At S = 32 a
//   warpgroup's 64 rows hold two sequences: each warp takes its own
//   sequence's 32 keys and the other's A bytes are zero.
// - The output leaves through a TMA store of h8's panels (rows past the
//   end clipped); a ragged last tile reads zeros past the end by TMA.
// - Packed int4 weights (w4) reach the consumers as the int8 tiles they
//   read for an int8 weight, so the consumer code is the same: the
//   producer waits until every stage of the unit's K chunks is free, then
//   loads the packed boxes by TMA onto a "landed" mbarrier, and the
//   producer warpgroup's three idle warps unpack them in shared memory
//   and complete the stages' "full" mbarriers themselves. A packed box of
//   128 bytes a row (K >= 256) holds two K chunks, chunk b in its low
//   nibbles and chunk K/256 + b in its high ones: it lands over the
//   second's stage and unpacks row by row in place, low nibbles to the
//   first's. At K = 128 a 64-byte packed row holds both halves of the one
//   chunk: the box lands over the stage's second half and unpacks in two
//   rounds of 64 rows through registers. Each nibble is sign-extended to
//   an int8 (two SIMD byte operations a word), so the products are the
//   int8 matmul's on the unpacked weight: exact int32 sums, whatever the
//   order of the chunks. The ring keeps its four stages and no shared
//   memory is added (four mbarriers in the barrier block's spare bytes).
// What the probe measured (k1_probe.py --kernels mb; PERF.md): the
// epilogues' arithmetic takes most of the time and the products and the
// attention do not hide under it; a turn protocol that staggered the
// warpgroups' products was no faster than letting them run free.
//
// Limits: (seq, head_dim, heads) in {32, 64, 128} x 32 x 4 (the
// bottleneck 128 wide); H and I multiples of 128 up to MAXW = 512 (a
// unit's K chunks sit in the ring at once, and shared memory is laid out
// for that width); a w4 matmul's K 128 or a multiple of 256 (whole packed
// boxes of two chunks); up to MAX_FFN stacked FFNs; 16-byte aligned h8,
// out and weights.
//
// Numerics: every element takes the plain version's steps in its order
// (-fmad=false; mm_common.cuh's helpers, which K1 and K6 take too, and
// attn_common.cuh's copy of K7's attention arithmetic), so the layer is
// bit-identical to int8_mb_layer_ln_ref and to the chain of K1, K6, K7.

#include <type_traits>

#include "attn_common.cuh"
#include "mm_common.cuh"
#include "wgmma_common.cuh"

namespace {

using tqmm::ColNorm;
using tqmm::ColSite;
using namespace tqwg;

constexpr int MAX_FFN = 8;                 // stacked FFNs a layer may have
constexpr int MAX_MM = 6 + 2 * (MAX_FFN + 1);
constexpr int TR = 128;                    // rows of a tile
constexpr int HD = 32;                     // head_dim
constexpr int NH = 4;                      // heads
constexpr int TH = HD * NH;                // bottleneck width
constexpr int PANEL = TR * 128;            // 128 rows x 128 bytes
constexpr int HALF = PANEL / 2;            // 64 rows: a warpgroup's share
                                           // of a panel, or (COLS) a panel
constexpr int STAGES = 4;                  // weight ring stages
constexpr int STAGE = 128 * 128;           // 128 weight rows x 128 bytes
constexpr int THREADS = 384;               // 2 consumer + 1 producer WGs
constexpr int CREGS = 232, PREGS = 40;     // setmaxnreg (3 x 168 in all)

// One matmul of the layer, in the kernel's order (bn_in, [bn_attn], v,
// qk, attn_out, (inter, dense) per FFN, out_bn): its epilogue inputs,
// N (v: the TH weight rows) and K
struct Mm {
  const float* vecs;   // (5, N)
  const float* scal;   // (1, 2): in_s, in_sh
  const float* gb;     // (2, N) gamma_q / beta_q (NoNorm), or null
  const float* ls;     // (1, 8) NoNorm scalars, or null
  int n, k;
};

struct Params {
  CUtensorMap wmap[MAX_MM];   // each weight (N, K) in 128 x 128-byte boxes
  CUtensorMap hmap, omap;     // h8 and out (M, H) in boxes of a tile's rows
  Mm mm[MAX_MM];
  const float* mask;          // (M / T, T): one float a row
  const float* ascal;         // the 12 attention site scalars
  int M, S, cols, H, I, n_mm, n_ffn, shared_kq, act, skip_max;
  int res_ao, res_ffn_mask, res_obn;
  float rsqrt_d, log2e, gelu_c;
  int w4_mask;                // bit m: matmul m's weight is packed int4
};
// kernel parameters beyond 4 KB need CUDA 12.1 or later
static_assert(sizeof(Params) <= 32764, "a kernel's parameter space");

// Shared-memory offsets (bytes from a 1 KB boundary), laid out for the
// widest H and I the kernel takes (MAXW), so that every buffer is the
// block's base plus a constant (the host-side size check,
// engine_kernels._mb_layer_smem, repeats them):
constexpr int MAXW = STAGES * 128;          // H, I: a unit's K in the ring
// the weight ring at 0, then: h8; li8 / x8; the union (sh8 / c8, q, k,
// v^T | the FFN inter payload); the two warpgroups' column tables; the
// keys' attention constants (a float pair a key and head); v's sums (4
// key blocks x TH ints); q's sums (an int a row and head); 13 mbarriers
// (full, empty, h8's, and the w4 boxes' landed)
constexpr int SM_H8 = STAGES * STAGE;
constexpr int SM_X8 = SM_H8 + MAXW * TR;
constexpr int SM_U = SM_X8 + PANEL;
constexpr int SM_TAB = SM_U + MAXW * TR;
constexpr int SM_COLV = SM_TAB + 2 * TR * static_cast<int>(sizeof(ColNorm));
constexpr int SM_VS = SM_COLV + NH * TR * 2 * 4;
constexpr int SM_QS = SM_VS + 4 * TH * 4;
constexpr int SM_BARS = SM_QS + NH * TR * 4;
constexpr int SMEM = SM_BARS + 128 + 1024;  // and 1 KB of alignment
static_assert(4 * PANEL <= MAXW * TR, "the union holds the attention's four");

// a consumer thread's place, and its ring position
struct Cons {
  uint8_t* ring;   // the block's shared-memory base
  int wg, tid, wq, g, t;
  int s;
  uint32_t ph;
  __device__ __forceinline__ uint64_t* full(int i) const {
    return reinterpret_cast<uint64_t*>(ring + SM_BARS) + i;
  }
  __device__ __forceinline__ uint64_t* empty(int i) const {
    return reinterpret_cast<uint64_t*>(ring + SM_BARS) + STAGES + i;
  }
};

__device__ __forceinline__ void advance(Cons& c) {
  if (++c.s == STAGES) {
    c.s = 0;
    c.ph ^= 1;
  }
}

// acc = a unit's products against the next kch stages of the ring (its
// 128 columns): the warpgroup's 64 rows of the kch panels at a (K-major,
// 128 rows each) against all 128, or (COLS) the tile's 64 rows (panels of
// 64 rows) against the warpgroup's 64 columns (acc[0..31])
template <bool COLS>
__device__ __forceinline__ void unit_main(Cons& c, int (&acc)[64],
                                          const uint8_t* a, int kch) {
  int prev = 0;
  for (int kc = 0; kc < kch; ++kc) {
    mbar_wait(c.full(c.s), c.ph);
    const uint64_t da =
        sw128_desc(COLS ? a + kc * HALF : a + kc * PANEL + c.wg * HALF);
    const uint64_t db =
        sw128_desc(c.ring + c.s * STAGE + (COLS ? c.wg * HALF : 0));
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if constexpr (COLS)
        wgmma_m64n64k32_s8(acc, da + 2 * kk, db + 2 * kk, (kc | kk) != 0);
      else
        wgmma_m64n128k32_s8(acc, da + 2 * kk, db + 2 * kk, (kc | kk) != 0);
    }
    wgmma_commit();
    if (kc > 0) {
      wgmma_wait<1>();
      mbar_arrive(c.empty(prev));
    }
    prev = c.s;
    advance(c);
  }
  wgmma_wait<0>();
  mbar_arrive(c.empty(prev));
#pragma unroll
  for (int i = 0; i < (COLS ? 32 : 64); ++i) fence_reg(acc[i]);
}

// x, which the compiler may no longer take for a known value: what is
// computed from it stays after this point instead of being hoisted out of
// the tile and matmul loops, where its registers would stay live through
// the attention
__device__ __forceinline__ int fresh(int x) {
  asm volatile("" : "+r"(x));
  return x;
}

// byte offset of (row r, byte b) in a 128-byte swizzled panel
__device__ __forceinline__ int sw128(int r, int b) {
  return r * 128 + ((((b >> 4) ^ r) & 7) << 4) + (b & 15);
}

// the epilogue policies: K1's emitted payload and K6's NoNorm tail, on a
// column's constants in the table (ColNorm; an emitted payload reads its
// ColSite part)
template <int ACT>
struct EmitOp {
  static constexpr bool kRes = false;
  float gelu_c;
  __device__ __forceinline__ int8_t apply(int acc, const ColNorm& k,
                                          int8_t) const {
    return tqmm::site_out<ACT, 0>(acc, k.s, -128.0f, 127.0f, gelu_c);
  }
};

template <bool RES, bool RQ>
struct NormOp {
  static constexpr bool kRes = RES;
  tqmm::NoNorm nn;
  __device__ __forceinline__ int8_t apply(int acc, const ColNorm& k,
                                          int8_t r) const {
    return tqmm::nonorm_out<RES, RQ>(acc, k, r, nn);
  }
};

// The epilogue of a unit: each element of acc through op into dst (a
// panel; the residual, where op takes one, read from the same place of
// res): rows 64 wg + 16 wq + g (+ 8) and the unit's 128 columns, or
// (COLS) rows 16 wq + g (+ 8) and the warpgroup's 64 columns. SUMS: rs +=
// each row's sum of the payload over each 32 of those columns, summed
// over the row's four lanes.
template <class Op, bool SUMS, bool COLS>
__device__ __forceinline__ void epilogue(const Cons& c, const int (&acc)[64],
                                         const ColNorm* tab, const Op& op,
                                         uint8_t* dst, const uint8_t* res,
                                         int (&rs)[NH][2]) {
  constexpr bool RES = Op::kRes;
  constexpr int NB = RES ? 1 : 2;   // 8-column blocks a step
  const int wg = fresh(c.wg), t = fresh(c.t);
  const int r0 = (COLS ? 0 : 64 * wg) + 16 * fresh(c.wq) + fresh(c.g);
  const int c0 = COLS ? 64 * wg : 0;   // the warpgroup's first column
#pragma unroll
  for (int j0 = 0; j0 < (COLS ? 8 : 16); j0 += NB) {
    ColNorm k[2 * NB];
#pragma unroll
    for (int i = 0; i < 2 * NB; ++i)
      k[i] = tab[8 * (j0 + (i >> 1)) + 2 * t + (i & 1)];
    uint16_t rin[2 * NB] = {};
    if constexpr (RES)
#pragma unroll
      for (int i = 0; i < 2 * NB; ++i)
        rin[i] = *reinterpret_cast<const uint16_t*>(
            res + sw128(r0 + 8 * (i & 1), c0 + 8 * (j0 + (i >> 1)) + 2 * t));
    int8_t o[4 * NB];
#pragma unroll
    for (int i = 0; i < 4 * NB; ++i) {   // (block, h, column) = i / 4, ..
      const int j = j0 + (i >> 2), h = (i >> 1) & 1, e = i & 1;
      o[i] = op.apply(acc[4 * j + 2 * h + e], k[2 * (i >> 2) + e],
                      static_cast<int8_t>(rin[i >> 1] >> (8 * e)));
    }
#pragma unroll
    for (int i = 0; i < 2 * NB; ++i) {
      const int j = j0 + (i >> 1), h = i & 1;
      *reinterpret_cast<uint16_t*>(dst + sw128(r0 + 8 * h,
                                               c0 + 8 * j + 2 * t)) =
          static_cast<uint16_t>(static_cast<uint8_t>(o[2 * i]) |
                                (static_cast<uint8_t>(o[2 * i + 1]) << 8));
      if constexpr (SUMS) rs[j >> 2][h] += o[2 * i] + o[2 * i + 1];
    }
  }
  if constexpr (SUMS) {
#pragma unroll
    for (int hd = 0; hd < NH; ++hd)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        rs[hd][h] += __shfl_xor_sync(tqattn::FULL, rs[hd][h], 1);
        rs[hd][h] += __shfl_xor_sync(tqattn::FULL, rs[hd][h], 2);
      }
  }
}

// what a unit's elements are: an emitted payload (after act 0 / 1 / 2),
// the NoNorm tail (with the residual, and the res site's fake-quant), or
// the [q | k] payload with its row sums per head
enum Kind : int { EMIT, NORM = 3, NORM_RES, NORM_RES_RQ, QK };

// One 128-column unit of matmul m (its n-tile nt): the products of the
// kch panels at a against the ring's next kch stages (unit_main), then
// its epilogue (kind) into dst
template <bool COLS>
__device__ __forceinline__ void unit(Cons& c, const Mm& m, int nt,
                                     const uint8_t* a, int kch, int kind,
                                     float gelu_c, ColNorm* tab, uint8_t* dst,
                                     const uint8_t* res, int (&rs)[NH][2]) {
  // this unit's column constants, one column a thread: loaded now,
  // written to the table after the main loop (which hides the loads)
  const int col = nt * 128 + (COLS ? 64 * c.wg + (c.tid & 63) : c.tid);
  ColNorm kcol;
  kcol.s = tqmm::col_site(m.vecs, m.n, col, m.scal[0], m.scal[1]);
  const bool norm = kind >= NORM && kind <= NORM_RES_RQ;
  kcol.gamma = norm ? m.gb[col] : 0.0f;
  kcol.beta = norm ? m.gb[m.n + col] : 0.0f;
  int acc[64];
  unit_main<COLS>(c, acc, a, kch);
  named_sync(1 + c.wg, 128);   // the last epilogue is done with the table
  if (!COLS || c.tid < 64) tab[c.tid] = kcol;
  named_sync(1 + c.wg, 128);
  const tqmm::NoNorm nn = norm ? tqmm::nonorm_params(m.ls) : tqmm::NoNorm{};
  switch (kind) {
    case EMIT + 1:
      epilogue<EmitOp<1>, false, COLS>(c, acc, tab, {gelu_c}, dst, res, rs);
      break;
    case EMIT + 2:
      epilogue<EmitOp<2>, false, COLS>(c, acc, tab, {gelu_c}, dst, res, rs);
      break;
    case NORM:
      epilogue<NormOp<false, false>, false, COLS>(c, acc, tab, {nn}, dst, res,
                                                  rs);
      break;
    case NORM_RES:
      epilogue<NormOp<true, false>, false, COLS>(c, acc, tab, {nn}, dst, res,
                                                 rs);
      break;
    case NORM_RES_RQ:
      epilogue<NormOp<true, true>, false, COLS>(c, acc, tab, {nn}, dst, res,
                                                rs);
      break;
    case QK:
      epilogue<EmitOp<0>, true, COLS>(c, acc, tab, {gelu_c}, dst, res, rs);
      break;
    default:
      epilogue<EmitOp<0>, false, COLS>(c, acc, tab, {gelu_c}, dst, res, rs);
  }
}

// v^T = W_v . x^T over 64 rows of x (64 keys), 64 dims a pipeline: the
// v payload into a v^T half (64-byte rows, the probs' key order), and
// each dim's sum over each 32-key block into vs[block][dim]. Rows split:
// the warpgroup's keys 64 wg .. into half wg, dims 0..127 in two
// pipelines over the same resident stages, one 32-register accumulator
// at a time (two in one pipeline made ptxas serialize every wgmma of the
// kernel for want of registers), the stages released after both. COLS:
// the tile's 64 keys into half 0, the warpgroup's dims 64 wg .. .
template <bool COLS>
__device__ __forceinline__ void v_unit(Cons& c, const Mm& m,
                                       const uint8_t* x, int kch,
                                       uint8_t* vt, int* vs) {
  const float in_s = m.scal[0], in_sh = m.scal[1];
  uint8_t* half = COLS ? vt : vt + c.wg * HALF;
  const int b0 = COLS ? 0 : 2 * c.wg;   // the keys' first 32-key block
#pragma unroll 1
  for (int pass = 0; pass < (COLS ? 1 : 2); ++pass) {
    const int dh = COLS ? c.wg : pass;
    ColSite kd[2];   // dims 64 dh + 16 wq + g + 8 h
#pragma unroll
    for (int h = 0; h < 2; ++h)
      kd[h] = tqmm::col_site(m.vecs, TH, 64 * dh + 16 * c.wq + c.g + 8 * h,
                             in_s, in_sh);
    int acc[32];
    int s = c.s;
    uint32_t ph = c.ph;
    for (int kc = 0; kc < kch; ++kc) {
      if (pass == 0) mbar_wait(c.full(s), ph);
      const uint64_t da = sw128_desc(c.ring + s * STAGE + dh * HALF);
      const uint64_t db =
          sw128_desc(COLS ? x + kc * HALF : x + kc * PANEL + c.wg * HALF);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n64k32_s8(acc, da + 2 * kk, db + 2 * kk, (kc | kk) != 0);
      wgmma_commit();
      if (++s == STAGES) {
        s = 0;
        ph ^= 1;
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 32; ++i) fence_reg(acc[i]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int dim = 64 * dh + 16 * c.wq + c.g + 8 * h;
      int bsum[2] = {0, 0};
#pragma unroll
      for (int q = 0; q < 4; ++q) {   // keys 16 q + {2t, 2t+1, 2t+8, 2t+9}
        uint32_t u[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          u[e] = static_cast<uint32_t>(tqmm::site_out<0, 0>(
              acc[4 * (2 * q + (e >> 1)) + 2 * h + (e & 1)], kd[h], -128.0f,
              127.0f, 0.0f));
        const uint32_t w = tqattn::pack4(u[0], u[1], u[2], u[3]);
        *reinterpret_cast<uint32_t*>(
            half + dim * 64 + (((q ^ (dim >> 1)) & 3) << 4) + 4 * c.t) = w;
        bsum[q >> 1] = __dp4a(static_cast<int>(w),
                              static_cast<int>(tqattn::ONES), bsum[q >> 1]);
      }
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        bsum[b] += __shfl_xor_sync(tqattn::FULL, bsum[b], 1);
        bsum[b] += __shfl_xor_sync(tqattn::FULL, bsum[b], 2);
      }
      if (c.t == 0) {
        vs[b0 * TH + dim] = bsum[0];
        vs[(b0 + 1) * TH + dim] = bsum[1];
      }
    }
  }
  for (int kc = 0; kc < kch; ++kc) {
    mbar_arrive(c.empty(c.s));
    advance(c);
  }
}

// whether the attention takes the integer path: every shift an integer of
// at most 128 (attn_common.cuh)
__device__ __forceinline__ bool fast_path(const tqattn::Site& st) {
  return tqattn::small_int(st.q_sh) && tqattn::small_int(st.k_sh) &&
         tqattn::small_int(st.v_sh) && tqattn::small_int(st.sc_sh) &&
         tqattn::small_int(st.p_sh) && tqattn::small_int(st.c_sh);
}

// One tile's attention for the warpgroup's 64 query rows over the four
// heads, or (COLS) for the tile's 64 rows over the warpgroup's two heads
// 2 wg, 2 wg + 1, head by head; the context payload lands in c8. qsm:
// the rows' q sums, a head's rows after another's (q_terms).
template <int S, bool INT, bool COLS>
__device__ __forceinline__ void attention(const Cons& c,
                                          const tqattn::Site& st, bool skip,
                                          const int* qsm, const uint8_t* qp,
                                          const uint8_t* kp,
                                          const uint8_t* vt,
                                          const float* colv, const int* vs,
                                          uint8_t* c8) {
  constexpr int N = S == 128 ? 128 : 64;   // keys in a score row
  constexpr int NT = S == 32 ? 4 : N / 8;  // a row's own n-tiles
  constexpr int KCH = N / 32;              // k32 chunks of p.v
  static_assert(!COLS || S <= 64, "64-row tiles hold sequences of <= 64");
  const int row_wg = COLS ? 0 : 64 * c.wg;    // the warpgroup's first row
  const int key0 = S == 128 ? 0 : row_wg;
  const int sq = S == 32 ? (c.wq >> 1) : 0;   // S = 32: the warp's sequence
  const int r0 = row_wg + 16 * c.wq + c.g;
  // the sequence's 32-key blocks of v's sums
  const int vb = S == 128 ? 0 : (COLS ? 0 : 2 * c.wg) + (S == 32 ? sq : 0);
#pragma unroll 1
  for (int lh = 0; lh < (COLS ? 2 : NH); ++lh) {
    const int hd = (COLS ? 2 * c.wg : 0) + lh;
    const int t = fresh(c.t);
    int acc[64];
    wgmma_fence();
    const uint64_t da = sw128_desc(qp + row_wg * 128) + 2 * hd;
    const uint64_t db = sw128_desc(kp + key0 * 128) + 2 * hd;
    if constexpr (N == 128) wgmma_m64n128k32_s8(acc, da, db, 0);
    else wgmma_m64n64k32_s8(acc, da, db, 0);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < N / 2; ++i) fence_reg(acc[i]);
    int sc[NT][4];
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        sc[ni][r] = S == 32 ? (sq ? acc[4 * (4 + ni) + r] : acc[4 * ni + r])
                            : acc[4 * ni + r];
    const int qs[4] = {qsm[hd * TR + r0], 0, qsm[hd * TR + r0 + 8], 0};
    unsigned pa[NT / 4][4];
    tqattn::softmax<NT, INT>(sc, qs,
                             colv + hd * TR * 2 + (key0 + 32 * sq) * 2, st,
                             t, skip, pa);
    unsigned pk[KCH][4];   // p.v's A: the other sequence's keys zero
#pragma unroll
    for (int cc = 0; cc < KCH; ++cc)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pk[cc][i] = S == 32 ? (cc == sq ? pa[0][i] : 0u) : pa[cc][i];
    int ps_lo = 0, ps_hi = 0;   // the rows' probs sums
#pragma unroll
    for (int cc = 0; cc < KCH; ++cc) {
      ps_lo = __dp4a(static_cast<int>(pk[cc][0]),
                     static_cast<int>(tqattn::ONES), ps_lo);
      ps_lo = __dp4a(static_cast<int>(pk[cc][2]),
                     static_cast<int>(tqattn::ONES), ps_lo);
      ps_hi = __dp4a(static_cast<int>(pk[cc][1]),
                     static_cast<int>(tqattn::ONES), ps_hi);
      ps_hi = __dp4a(static_cast<int>(pk[cc][3]),
                     static_cast<int>(tqattn::ONES), ps_hi);
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      ps_lo += __shfl_xor_sync(tqattn::FULL, ps_lo, o);
      ps_hi += __shfl_xor_sync(tqattn::FULL, ps_hi, o);
    }
    int dc[16];
    wgmma_fence();
#pragma unroll
    for (int cc = 0; cc < KCH; ++cc) {
      const int half = S == 128 ? cc >> 1 : (COLS ? 0 : c.wg);
      wgmma_m64n32k32_s8_rs(
          dc, pk[cc], sw64_desc(vt + half * HALF + hd * HD * 64) + 2 * (cc & 1),
          cc != 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 16; ++i) fence_reg(dc[i]);
    const float vp_lo = st.v_sh * tqattn::i2f(ps_lo);
    const float vp_hi = st.v_sh * tqattn::i2f(ps_hi);
    const float rb_lo = tqattn::BIAS - (vp_lo + st.tpv);
    const float rb_hi = tqattn::BIAS - (vp_hi + st.tpv);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t u[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int dim = HD * hd + 8 * j + 2 * t + e;
        int vsum = vs[vb * TH + dim];
#pragma unroll
        for (int b = 1; b < S / 32; ++b) vsum += vs[(vb + b) * TH + dim];
        const float pvd = tqattn::shift_term<INT>(st.p_sh, vsum);
        u[e] = tqattn::ctx_bits<INT>(dc[4 * j + e], pvd, rb_lo, vp_lo, st);
        u[2 + e] =
            tqattn::ctx_bits<INT>(dc[4 * j + 2 + e], pvd, rb_hi, vp_hi, st);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint16_t*>(
            c8 + sw128(r0 + 8 * h, HD * hd + 8 * j + 2 * t)) =
            static_cast<uint16_t>((u[2 * h] & 0xFF) |
                                  ((u[2 * h + 1] & 0xFF) << 8));
    }
  }
}

template <bool COLS>
__device__ __forceinline__ void attention_any(
    const Cons& c, int seq, const tqattn::Site& st, bool fast, bool skip,
    const int* qsm, const uint8_t* qp, const uint8_t* kp,
    const uint8_t* vt, const float* colv, const int* vs, uint8_t* c8) {
  if (!COLS && seq == 128) {
    if (fast)
      attention<128, true, false>(c, st, skip, qsm, qp, kp, vt, colv, vs,
                                  c8);
    else
      attention<128, false, false>(c, st, skip, qsm, qp, kp, vt, colv, vs,
                                   c8);
  } else if (seq == 64) {
    if (fast)
      attention<64, true, COLS>(c, st, skip, qsm, qp, kp, vt, colv, vs, c8);
    else
      attention<64, false, COLS>(c, st, skip, qsm, qp, kp, vt, colv, vs, c8);
  } else {
    if (fast)
      attention<32, true, COLS>(c, st, skip, qsm, qp, kp, vt, colv, vs, c8);
    else
      attention<32, false, COLS>(c, st, skip, qsm, qp, kp, vt, colv, vs, c8);
  }
}

// each key's attention constants from the [q | k] epilogue's k sums ks
// (per head of the epilogue's columns: all four, or COLS the warpgroup's
// two): per head, the float4 of a key pair (shift_term(q_sh, ksum) of both
// keys, then both keys' mask * log2e + a * sc_sh); lane t writes the
// epilogue's head t
// each row's q sums from the [q | k] epilogue's qs into qsm[head][row]
// (lane t writes the epilogue's head t)
template <bool COLS>
__device__ __forceinline__ void q_terms(const Cons& c, const int (&qs)[NH][2],
                                        int* qsm) {
  if (COLS && c.t >= 2) return;
  const int hd = (COLS ? 2 * c.wg : 0) + c.t;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int sum = qs[0][h];
#pragma unroll
    for (int i = 1; i < NH; ++i) sum = c.t == i ? qs[i][h] : sum;
    qsm[hd * TR + (COLS ? 0 : 64 * c.wg) + 16 * c.wq + c.g + 8 * h] = sum;
  }
}

template <bool COLS>
__device__ __forceinline__ void key_terms(const Cons& c, const Params& p,
                                          const tqattn::Site& st, bool fast,
                                          const int (&ks)[NH][2], int row0,
                                          float* colv) {
  if (COLS && c.t >= 2) return;
  const int hd = (COLS ? 2 * c.wg : 0) + c.t;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = (COLS ? 0 : 64 * c.wg) + 16 * c.wq + c.g + 8 * h;
    int sum = ks[0][h];
#pragma unroll
    for (int i = 1; i < NH; ++i) sum = c.t == i ? ks[i][h] : sum;
    const float kq = fast ? tqattn::shift_term<true>(st.q_sh, sum)
                          : tqattn::shift_term<false>(st.q_sh, sum);
    const float mv = row0 + key < p.M ? p.mask[row0 + key] : 0.0f;
    float* e = colv + hd * TR * 2 + (key >> 1) * 4 + (key & 1);
    e[0] = kq;
    e[2] = mv * p.log2e + st.ash;
  }
}


// The consumer warpgroups' tiles (of TR rows, or COLS 64): matmul by
// matmul in the kernel's order, each 128 output columns a unit; v^T
// between the bottleneck and [q | k], the attention after [q | k]. Rows
// split, each warpgroup's rows are its own until the attention at S = 128
// (so only its own barrier between matmuls); COLS, each matmul's output
// is both warpgroups' (a barrier of both after it), the attention of a
// warpgroup's heads its own.
template <bool COLS>
__device__ __forceinline__ void consume(const Params& p, uint8_t* base,
                                        Cons& c,
                                        uint64_t* hbar, int tiles) {
  constexpr int ROWS = COLS ? TR / 2 : TR;   // rows of a tile
  constexpr int P = ROWS * 128;              // bytes of its panels
  uint8_t* h8 = base + SM_H8;
  uint8_t* x8 = base + SM_X8;
  uint8_t* sh = base + SM_U;          // sh8, then c8
  uint8_t* qp = sh + P;               // q, then k
  uint8_t* vt = qp + 2 * P;           // v^T: its 64-key halves
  uint8_t* inter = base + SM_U;       // or the FFN inter payload
  ColNorm* tab = reinterpret_cast<ColNorm*>(base + SM_TAB) + c.wg * TR;
  float* colv = reinterpret_cast<float*>(base + SM_COLV);
  int* vs = reinterpret_cast<int*>(base + SM_VS);
  int* qsm = reinterpret_cast<int*>(base + SM_QS);
  const int hch = p.H / 128, ich = p.I / 128;
  const int m_v = 1 + p.shared_kq, m_qk = m_v + 1, m_last = p.n_mm - 1;
  int lt = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++lt) {
    const int row0 = tile * ROWS;
    mbar_wait(hbar, lt & 1);
    for (int m = 0; m < p.n_mm; ++m) {
      if (m == m_v) {   // v^T from h8 (shared_kq) or li8 (bottleneck)
        v_unit<COLS>(c, p.mm[m], p.shared_kq ? h8 : x8, p.mm[m].k / 128, vt,
                     vs);
        continue;
      }
      // matmul m's input panels, epilogue and output (its residual in
      // place where it has one)
      const uint8_t* a = x8;
      int kch = 1, kind;
      uint8_t* dst = x8;
      if (m < m_v) {                  // bn_in -> li8, bn_attn -> sh8
        a = h8;
        kch = hch;
        kind = NORM;
        dst = m == 0 ? x8 : sh;
      } else if (m == m_qk) {         // [q | k] from sh8 or li8
        a = p.shared_kq ? sh : x8;
        kind = QK;
        dst = qp;
      } else if (m == m_qk + 1) {     // attn_out + li8 -> x8
        a = sh;
        kind = p.res_ao ? NORM_RES_RQ : NORM_RES;
      } else if (m == m_last) {       // out_bn + h8 -> the output, in h8
        kind = p.res_obn ? NORM_RES_RQ : NORM_RES;
        dst = h8;
      } else if ((m - m_qk) % 2 == 0) {   // an FFN's inter + act
        kind = EMIT + p.act;
        dst = inter;
      } else {                        // its dense + x8 -> x8
        a = inter;
        kch = ich;
        kind = (p.res_ffn_mask >> ((m - m_qk - 3) / 2)) & 1 ? NORM_RES_RQ
                                                            : NORM_RES;
      }
      const bool res = kind == NORM_RES || kind == NORM_RES_RQ;
      for (int nt = 0; nt < p.mm[m].n / 128; ++nt) {
        // rows split at S = 128, every key is both warpgroups': the
        // union's k and v^T stay until both are past the attention
        if (!COLS && p.S == 128 && m == m_qk + 2 && nt == 0)
          named_sync(3, 256);
        int rs[NH][2] = {};
        unit<COLS>(c, p.mm[m], nt, a, kch, kind, p.gelu_c, tab, dst + nt * P,
                   res ? dst + nt * P : nullptr, rs);
        if (kind == QK && nt == 0) {
          q_terms<COLS>(c, rs, qsm);
        } else if (kind == QK) {
          const tqattn::Site st =
              tqattn::site_of<HD>(p.ascal, p.S, p.rsqrt_d, p.log2e);
          key_terms<COLS>(c, p, st, fast_path(st), rs, row0, colv);
        }
      }
      fence_proxy_async();
      if (m == m_qk) {
        // the attention: rows split at S = 128 over all keys; COLS over
        // sh8, which the other warpgroup's [q | k] may still read
        if (COLS || p.S == 128) named_sync(3, 256);
        else named_sync(1 + c.wg, 128);
        const tqattn::Site st =
            tqattn::site_of<HD>(p.ascal, p.S, p.rsqrt_d, p.log2e);
        attention_any<COLS>(c, p.S, st, fast_path(st), p.skip_max, qsm, qp,
                            qp + P, vt, colv, vs, sh);
        fence_proxy_async();
      }
      if (COLS) named_sync(3, 256);
      else named_sync(1 + c.wg, 128);
    }
    // the output out by TMA, then the next tile's h8 in
    named_sync(3, 256);
    if (threadIdx.x == 0) {
      for (int nt = 0; nt < hch; ++nt)
        tma_store_2d(&p.omap, h8 + nt * P, nt * 128, row0);
      const int next = tile + gridDim.x;
      if (next < tiles) {
        tma_store_wait_read<0>();
        mbar_arrive_expect_tx(hbar, hch * P);
        for (int nt = 0; nt < hch; ++nt)
          tma_load_2d(h8 + nt * P, &p.hmap, hbar, nt * 128, next * ROWS);
      }
    }
  }
  if (threadIdx.x == 0) tma_store_wait_all();
}

// the producer: every tile's weight tiles, matmul by matmul, unit by unit
// (a w4 unit's packed boxes onto the landed mbarriers, once all of its
// stages are free)
__device__ __forceinline__ void produce(const Params& p, uint8_t* ring, uint64_t* full,
                        uint64_t* empty, uint64_t* landed, int tiles) {
  for (int m = 0; m < p.n_mm; ++m) tma_prefetch_map(&p.wmap[m]);
  int s = 0;
  uint32_t ph = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x)
    for (int m = 0; m < p.n_mm; ++m) {
      const int nt = p.mm[m].n / 128, kch = p.mm[m].k / 128;
      if ((p.w4_mask >> m) & 1) {
        for (int n = 0; n < nt; ++n) {
          const int s0 = s;
          for (int k = 0; k < kch; ++k) {
            mbar_wait(&empty[s], ph ^ 1);
            if (++s == STAGES) {
              s = 0;
              ph ^= 1;
            }
          }
          if (kch == 1) {   // one 64-byte box over the stage's second half
            mbar_arrive_expect_tx(&landed[s0], STAGE / 2);
            tma_load_2d(ring + s0 * STAGE + STAGE / 2, &p.wmap[m],
                        &landed[s0], 0, n * 128);
          } else {          // box b over the stage of chunk kch / 2 + b
            for (int b = 0; b < kch / 2; ++b) {
              const int hs = (s0 + kch / 2 + b) % STAGES;
              mbar_arrive_expect_tx(&landed[hs], STAGE);
              tma_load_2d(ring + hs * STAGE, &p.wmap[m], &landed[hs],
                          b * 128, n * 128);
            }
          }
        }
        continue;
      }
      for (int n = 0; n < nt; ++n)
        for (int k = 0; k < kch; ++k) {
          mbar_wait(&empty[s], ph ^ 1);
          mbar_arrive_expect_tx(&full[s], STAGE);
          tma_load_2d(ring + s * STAGE, &p.wmap[m], &full[s], k * 128,
                      n * 128);
          if (++s == STAGES) {
            s = 0;
            ph ^= 1;
          }
        }
    }
}

// the int8 levels of 16 packed int4 weights' low (HI false) or high
// nibbles, each sign-extended: (n ^ 8) - 8 in every byte
template <bool HI>
__device__ __forceinline__ uint32_t nibbles4(uint32_t x) {
  const uint32_t n = (HI ? x >> 4 : x) & 0x0F0F0F0Fu;
  return __vsub4(n ^ 0x08080808u, 0x08080808u);
}
template <bool HI>
__device__ __forceinline__ uint4 nibbles(const uint4& v) {
  return make_uint4(nibbles4<HI>(v.x), nibbles4<HI>(v.y), nibbles4<HI>(v.z),
                    nibbles4<HI>(v.w));
}

// (w4, K >= 256) a packed box (128 rows x 128 bytes, unswizzled, as TMA
// wrote it over stage hi) into the 128-byte swizzled int8 tiles of its
// two chunks: the low nibbles into stage lo, the high ones in place.
// Each of the three warps takes 4 rows at a time, a lane a 16-byte chunk,
// and reads its rows whole before it writes them.
__device__ __forceinline__ void unpack_box(uint8_t* hi, uint8_t* lo, int w,
                                           int lane) {
  const int c = lane & 7;
#pragma unroll 1
  for (int r = 4 * w + (lane >> 3); r < 128; r += 12) {
    const uint4 v = *reinterpret_cast<const uint4*>(hi + r * 128 + c * 16);
    __syncwarp();
    const int off = r * 128 + ((c ^ (r & 7)) << 4);
    *reinterpret_cast<uint4*>(lo + off) = nibbles<false>(v);
    *reinterpret_cast<uint4*>(hi + off) = nibbles<true>(v);
  }
}

// (w4, K = 128) the packed box (128 rows x 64 bytes, unswizzled, over the
// stage's second half) into the stage's 128-byte swizzled int8 tile, row
// r's low nibbles to its chunks 0-3, its high ones to chunks 4-7: in two
// rounds of 64 rows, each read into registers (the 96 threads' 256
// 16-byte chunks) before any thread writes, since the second round's
// rows land over the packed rows
__device__ __forceinline__ void unpack_k128(uint8_t* st, int t) {
  const uint8_t* src = st + STAGE / 2;
#pragma unroll 1
  for (int h = 0; h < 2; ++h) {
    uint4 v[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int j = t + 96 * i;   // row 64 h + j / 4, chunk j % 4
      if (j < 256)
        v[i] = *reinterpret_cast<const uint4*>(src + 64 * 64 * h + 16 * j);
    }
    named_sync(4, 96);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int j = t + 96 * i;
      if (j >= 256) break;
      const int r = 64 * h + (j >> 2), c = j & 3;
      *reinterpret_cast<uint4*>(st + r * 128 + ((c ^ (r & 7)) << 4)) =
          nibbles<false>(v[i]);
      *reinterpret_cast<uint4*>(st + r * 128 + (((c + 4) ^ (r & 7)) << 4)) =
          nibbles<true>(v[i]);
    }
  }
}

// the unpacking warps (the producer warpgroup's warps 1-3, 96 threads):
// the w4 units in the producer's order, each unit's packed boxes once
// they land, then its stages' full mbarriers
__device__ __forceinline__ void unpack(const Params& p, uint8_t* ring,
                                       uint64_t* full, uint64_t* landed,
                                       int tiles) {
  const int t = threadIdx.x - 288, w = t >> 5, lane = t & 31;
  int s = 0;
  uint32_t lph = 0;   // each stage's landed phase, a bit a stage
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x)
    for (int m = 0; m < p.n_mm; ++m) {
      const int nt = p.mm[m].n / 128, kch = p.mm[m].k / 128;
      if (!((p.w4_mask >> m) & 1)) {
        s = (s + nt * kch) % STAGES;
        continue;
      }
      for (int n = 0; n < nt; ++n) {
        if (kch == 1) {
          mbar_wait(&landed[s], (lph >> s) & 1);
          lph ^= 1u << s;
          unpack_k128(ring + s * STAGE, t);
        } else {
          for (int b = 0; b < kch / 2; ++b) {
            const int hs = (s + kch / 2 + b) % STAGES;
            mbar_wait(&landed[hs], (lph >> hs) & 1);
            lph ^= 1u << hs;
            unpack_box(ring + hs * STAGE, ring + ((s + b) % STAGES) * STAGE,
                       w, lane);
          }
        }
        fence_proxy_async();   // the writes, visible to wgmma
        named_sync(4, 96);
        if (t == 0)
          for (int k = 0; k < kch; ++k) mbar_arrive(&full[(s + k) % STAGES]);
        s = (s + kch) % STAGES;
      }
    }
}


__global__ void __launch_bounds__(THREADS, 1)
    mb_layer_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // offsets from the shared array itself, so that every access stays a
  // shared-memory one
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + SM_BARS);
  uint64_t* empty = full + STAGES;
  uint64_t* hbar = empty + STAGES;
  uint64_t* landed = hbar + 1;             // w4: a stage's packed box
  const int rows = p.cols ? TR / 2 : TR;   // of a tile
  const int tiles = (p.M + rows - 1) / rows;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
      mbar_init(&landed[s], 1);
    }
    mbar_init(hbar, 1);
    fence_barrier_init();
    tma_prefetch_map(&p.hmap);
    tma_prefetch_map(&p.omap);
    mbar_arrive_expect_tx(hbar, (p.H / 128) * rows * 128);
    for (int nt = 0; nt < p.H / 128; ++nt)
      tma_load_2d(base + SM_H8 + nt * rows * 128, &p.hmap, hbar, nt * 128,
                  blockIdx.x * rows);
  }
  __syncthreads();
  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    regs_dealloc<PREGS>();
    if (threadIdx.x == 256) produce(p, base, full, empty, landed, tiles);
    else if (threadIdx.x >= 288 && p.w4_mask)
      unpack(p, base, full, landed, tiles);
  } else {
    regs_alloc<CREGS>();
    const int tid = threadIdx.x & 127;
    Cons c{base, wg, tid, tid >> 5, (tid & 31) >> 2, tid & 3, 0, 0u};
    if (p.cols) consume<true>(p, base, c, hbar, tiles);
    else consume<false>(p, base, c, hbar, tiles);
  }
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

// the card's SM count, or 0 where it cannot be read
int sm_count() {
  static const int sms = [] {
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return 0;
    return n;
  }();
  return sms;
}

// one launch: a block an SM, at most one a tile
cudaError_t launch(const Params& p, int smem, int sms, cudaStream_t stream) {
  static int smem_allowed = 0;   // raised once, not on every launch
  if (smem > smem_allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        mb_layer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    smem_allowed = smem;
  }
  const int rows = p.cols ? TR / 2 : TR;
  const int tiles = (p.M + rows - 1) / rows;
  mb_layer_kernel<<<tiles < sms ? tiles : sms, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

int mb_layer(const void* h8, const void* mask, const void* ascal,
             const void* const* flat, int n_flat, void* out, int B, int T,
             int H, int TH_, int I, int D, int n_ffn, int shared_kq, int act,
             int skip_max, int res_ao, int res_ffn_mask, int res_obn,
             int w4_plan, float rsqrt_d, float log2e, float gelu_c,
             void* stream) {
  if ((T != 32 && T != 64 && T != 128) || D != HD || TH_ != TH || B <= 0 ||
      H <= 0 || I <= 0 || H % 128 || I % 128 || H > MAXW || I > MAXW ||
      n_ffn < 0 ||
      n_ffn > MAX_FFN || act < 0 || act > 2 || !aligned16(h8) ||
      !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  // matmuls: bn_in, [bn_attn], qk, v, attn_out, 2 per FFN, inter, out,
  // out_bn; NoNorms: bn_in, [bn_attn], attn_out, 1 per FFN, out, out_bn
  const int want = 3 * (7 + shared_kq + 2 * n_ffn) + 2 * (4 + shared_kq +
                                                          n_ffn);
  if (n_flat != want) return static_cast<int>(cudaErrorInvalidValue);
  const int M = B * T;
  Params p{};
  int i = 0, m = 0;
  bool ok = true;
  const auto f32 = [&](int j) { return static_cast<const float*>(flat[j]); };
  // matmul at flat[i] (N x K) as the kernel's m-th, its NoNorm after it;
  // j: its place in the plan's order (w4_plan's bit), where the packed
  // int4 weight (N, K/2) is read in boxes of 128 rows x min(K/2, 128)
  // bytes, unswizzled
  const auto mm = [&](int at, int n, int k, int norm_at, int j) {
    const bool w4 = (w4_plan >> j) & 1;
    ok = ok && aligned16(flat[at]) &&
         (w4 ? (k == 128 || k % 256 == 0) &&
                   make_u8_map(&p.wmap[m], flat[at], n, k / 2,
                               k / 2 < 128 ? k / 2 : 128, 128,
                               CU_TENSOR_MAP_SWIZZLE_NONE)
             : make_i8_map(&p.wmap[m], flat[at], n, k, 128));
    p.mm[m] = Mm{f32(at + 1), f32(at + 2),
                 norm_at < 0 ? nullptr : f32(norm_at),
                 norm_at < 0 ? nullptr : f32(norm_at + 1), n, k};
    p.w4_mask |= static_cast<int>(w4) << m;
    ++m;
  };
  // the plan's order: bn_in, [bn_attn], qk, v, attn_out, (inter, dense)
  // per FFN, out_bn; the kernel's takes v before qk
  const int jq = 1 + shared_kq;
  mm(i, TH, H, i + 3, 0);              // bn_in
  i += 5;
  if (shared_kq) {
    mm(i, TH, H, i + 3, 1);            // bn_attn
    i += 5;
  }
  const int qk_at = i;
  i += 3;
  mm(i, TH, shared_kq ? H : TH, -1, jq + 1);   // v (rows: v^T's)
  i += 3;
  mm(qk_at, 2 * TH, TH, -1, jq);       // [q | k]
  mm(i, TH, TH, i + 3, jq + 2);        // attn_out
  i += 5;
  for (int j = 0; j <= n_ffn; ++j) {
    mm(i, I, TH, -1, jq + 3 + 2 * j);          // inter
    mm(i + 3, TH, I, i + 6, jq + 4 + 2 * j);   // dense
    i += 8;
  }
  mm(i, H, TH, i + 3, jq + 5 + 2 * n_ffn);   // out_bn
  p.n_mm = m;
  // tiles of 64 rows, the warpgroups splitting the columns, where 128-row
  // tiles would leave SMs idle and 64-row ones do not overflow the card
  const int sms = sm_count();
  if (sms == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  p.cols = T <= 64 && (M + 63) / 64 <= sms;
  const int rows = p.cols ? TR / 2 : TR;
  ok = ok && make_i8_map(&p.hmap, h8, M, H, rows) &&
       make_i8_map(&p.omap, out, M, H, rows);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  p.mask = static_cast<const float*>(mask);
  p.ascal = static_cast<const float*>(ascal);
  p.M = M;
  p.S = T;
  p.H = H;
  p.I = I;
  p.n_ffn = n_ffn;
  p.shared_kq = shared_kq;
  p.act = act;
  p.skip_max = skip_max;
  p.res_ao = res_ao;
  p.res_ffn_mask = res_ffn_mask;
  p.res_obn = res_obn;
  p.rsqrt_d = rsqrt_d;
  p.log2e = log2e;
  p.gelu_c = gelu_c;
  const int smem = SMEM;
  static_assert(SMEM <= 232448, "a block's shared memory on the H100");
  return static_cast<int>(
      launch(p, smem, sms, static_cast<cudaStream_t>(stream)));
}

}  // namespace

// The layer plan `flat` in the canonical order of mb_layer_flat
// (engine_kernels.py): (w, vecs, scal) per matmul, (gb, scal) per NoNorm:
// bn_in, bn_in_norm, [bn_attn, bn_attn_norm when shared_kq], qk, v,
// attn_out, attn_out_norm, (inter, dense, norm) per stacked FFN, inter,
// out, out_norm, out_bn, out_bn_norm. h8 / out: (B*T, H) int8; mask: (B,
// T) f32; ascal: 12 f32 attention site scalars. res_ffn_mask bit j: FFN
// j's res site (bit n_ffn: out.res). act: 0 none, 1 gelu_new, 2 relu.
// Built for T in {32, 64, 128} and 4 heads of 32; H, I multiples of 128;
// h8, out and the weights 16-byte aligned. Returns a cudaError_t
// (cudaErrorInvalidValue for a plan or shape it does not take, or a
// tensor map that cannot be encoded).
extern "C" int tq_int8_mb_layer(const void* h8, const void* mask,
                                const void* ascal, const void* const* flat,
                                int n_flat, void* out, int B, int T, int H,
                                int TH_, int I, int D, int n_ffn,
                                int shared_kq, int act, int skip_max,
                                int res_ao, int res_ffn_mask, int res_obn,
                                float rsqrt_d, float log2e, float gelu_c,
                                void* stream) {
  return mb_layer(h8, mask, ascal, flat, n_flat, out, B, T, H, TH_, I, D,
                  n_ffn, shared_kq, act, skip_max, res_ao, res_ffn_mask,
                  res_obn, 0, rsqrt_d, log2e, gelu_c, stream);
}

// tq_int8_mb_layer with packed int4 weights (the wrapper's entry point;
// tq_int8_mb_layer keeps the earlier signature for the probes' builds of
// other checkouts): bit j of w4_plan says that the plan's j-th matmul
// (mb_layer_flat's order: bn_in, [bn_attn], qk, v, attn_out, inter and
// dense per FFN, out_bn) has its (N, K/2) split-half packed int4 weight at
// its place in `flat` (K 128 or a multiple of 256); 0: every weight int8
extern "C" int tq_int8_mb_layer_w4(const void* h8, const void* mask,
                                   const void* ascal,
                                   const void* const* flat, int n_flat,
                                   void* out, int B, int T, int H, int TH_,
                                   int I, int D, int n_ffn, int shared_kq,
                                   int act, int skip_max, int res_ao,
                                   int res_ffn_mask, int res_obn,
                                   int w4_plan, float rsqrt_d, float log2e,
                                   float gelu_c, void* stream) {
  return mb_layer(h8, mask, ascal, flat, n_flat, out, B, T, H, TH_, I, D,
                  n_ffn, shared_kq, act, skip_max, res_ao, res_ffn_mask,
                  res_obn, w4_plan, rsqrt_d, log2e, gelu_c, stream);
}
