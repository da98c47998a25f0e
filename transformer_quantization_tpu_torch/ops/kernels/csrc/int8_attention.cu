// Fused int8 attention over q, k and v payloads (K2 / K7), for Hopper.
//
// Replaces: transformer_quantization_tpu/ops/pallas/engine_kernels.py
//   int8_attention_qkv and int8_attention, both through _attention_call /
//   _attn_kernel / _attn_row (dots='i8'), and the attention stage of
//   int8_layer_ln and int8_attn_ln.
//
//   scores = q8 . k8 (int32) + q_sh*ksum + k_sh*qsum + d*q_sh*k_sh
//   level  = clip(rint(scores * qk_over_sc) - sc_sh, -128, 127)
//   s2     = a * level + (mask*log2e + a*sc_sh)    (a = sc_s/sqrt(d)*log2e)
//   e      = exp2(s2 [- rowmax])      probs = clip(rint(e*(1/p_s)/sum) - p_sh)
//   ctx    = p8 . v8 (int32) + p_sh*vsum + v_sh*psum + T*p_sh*v_sh
//   out    = clip(rint(ctx * p_s*v_s/c_s) - c_sh, -128, 127)
//
// q, k and v each come from their own array (row strides ldq / ldk / ldv,
// the caller's pointers already at the column block picked by `cols`):
// int8_attention is the instance over one fused q|k|v array (cols 0, 1, 2,
// stride 3H); MobileBERT's engine reads q and k as the halves of one [q|k]
// payload and v from its own (cols 0, 1, 0).
//
// What bounds it on the card: by the usual count, bytes: at B=128, S=128,
// 12 heads of 64 the call moves 50 MB (15 us at 3.35 TB/s) for 6.4 GOP of
// int8 products (3.2 us at the int8 peak). In fact the instructions do:
// the softmax chain takes some 23 for each of the 25.2M scores (the
// scores site, exp2, a double sum, the probs site) and the rest of a row
// (both products on mma.sync, the context site) some 8 more a score. On
// an H100 80GB HBM3 at 700 W (k1_probe.py --kernels attn) the call takes
// 0.058 ms, the same loads and stores alone 0.019 and the kernel without
// its softmax 0.028, and each part taken out saves about its share of
// the instructions: the 64 scores a thread holds at T = 128 leave room
// for four warps a scheduler, too few to hide the chain's latencies. So
// the design keeps the loads under the arithmetic and takes every
// instruction it can out of it.
//
// Design (two persistent 256-thread blocks an SM, eight warps each):
// - a block walks groups of 128 query rows (G = 128/T (batch row, head)
//   items a group); one thread keeps the next group's q, k and v tiles
//   (TMA boxes of T rows x D bytes through 2-D tensor maps with each
//   array's own row stride, D-byte swizzled) and mask rows loading into
//   the other of two stages while the block works on this one, on an
//   mbarrier per stage;
// - the eight warps first share out the group: v transposed into v^T in
//   shared memory (4 x 4 byte blocks with __byte_perm, whole words; the
//   keys of each 16 in the order the probs' A fragments hold them), v's
//   column sums on the same words (__dp4a, then across lanes), and each
//   key's column constants (q_sh * ksum by __dp4a
//   on 16-byte loads, and mask * log2e + a*sc_sh);
// - after one barrier each warp owns 16 query rows of one item end to
//   end: q.k^T on mma.sync m16n8k32 into registers (the q rows' sums by a
//   product with a ones operand on the same tensor cores), the softmax
//   chain on the registers, the probs payload packed straight into p.v's
//   A fragments (their sums again by a ones product), p.v, the context
//   site, and the payload into the warp's swizzled staging tile, which a
//   TMA store writes out (16 x D bytes);
// - the int32 sums convert exactly by the 1.5 * 2^23 bias (|x| <= 2^22).
//   When every shift is an integer of magnitude at most 128 (every 8-bit
//   site's), the block takes the integer path: each sum of the chain is an
//   integer below 2^23, so the scores (and so the context) come as the
//   bits of (1.5 * 2^23 + q.k + q_sh*ksum) less (1.5 * 2^23 - k_sh*qsum -
//   d*q_sh*k_sh), two instructions for the reference's three exact adds;
//   and a site's level is taken on the biased value: clip((x + 1.5 * 2^23)
//   - (1.5 * 2^23 + sh)) for the scores, and for the probs and the context
//   clip((x + 1.5 * 2^23) - sh) between 1.5 * 2^23 - 128 and + 127, whose
//   low byte is the payload (exact for |x| < 2^22; beyond it both sides
//   saturate alike, the biased sum being monotone). A block with other
//   shifts takes the reference's formulas with rintf. No conversion
//   instruction is left in the chain but the exp2 and the double sum's.
// At (T, D) = (128, 64) a stage is 25 KB, the block 94 KB.
//
// Numerics: the association order of int8_attention_ref, -fmad=false,
// exp2f as torch.exp2 calls it on the card; the softmax denominator
// accumulates in double and rounds once to float, as the plain version
// does (the two double sums, taken in different orders, may differ in
// their last bits, which moves the float only in the rarest of ties); a
// level off the integers (a shift that is not one) converts to int8 by
// truncation, as the plain version's cast does. Every output is
// bit-identical to int8_attention_ref. The site scalars scal
// (12 f32): [q_s, q_sh, k_s, k_sh, v_s, v_sh, sc_s, sc_sh, p_s, p_sh, c_s,
// c_sh]. The shifted-bf16 dots of the TPU kernel were a TPU workaround
// and are not ported. K8 (int8_mb_layer.cu) keeps its own attention,
// attn_common.cuh's attn_head, with the same arithmetic.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mm_common.cuh"     // tqmm::mma_k32
#include "wgmma_common.cuh"  // mbarriers, TMA loads, the tensor-map encoder

namespace {

using tqwg::smem_u32;

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS = 16 * WARPS;         // query rows (and keys) a group
constexpr float BIAS = 12582912.0f;      // 1.5 * 2^23
constexpr int BIAS_BITS = 0x4B400000;    // its bits
constexpr float SHIFT_MAX = 128.0f;      // see small_int
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned ONES = 0x01010101u;   // four s8 ones

template <int T, int D>
struct Cfg {
  static constexpr int G = ROWS / T;     // (batch row, head) items a group
  static constexpr int TILE = ROWS * D;  // a group's q, k or v bytes
  static constexpr int STAGE = (3 * TILE + ROWS * 4 + 1023) / 1024 * 1024;
  // v^T row stride (bytes): 64 mod 128 at T = 128 and 64, 32 at T = 32,
  // so that p.v's 16-byte (8-byte) fragment loads meet no bank twice
  static constexpr int LDV = T == 128 ? 192 : T;
  static constexpr int VT = G * D * LDV;  // a group's v^T bytes
  static constexpr int OUT = 16 * D;     // a warp's context staging tile
  static constexpr int NT = T / 8;       // key n-tiles of q.k^T
  static constexpr int ND = D / 8;       // head-dim n-tiles of p.v
  static constexpr int KC = T / 32;      // k32 chunks of p.v
  static constexpr int KD = D / 32;      // k32 chunks of q.k^T
  static constexpr int PVS = G * D;      // floats of p_sh * vsum a group
  // two stages | staging (8 warps x 2) | x 2 (a group and the next):
  // v^T, key constants (float4 a key pair), p_sh * vsum | barriers;
  // after up to 1 KB of alignment
  static constexpr int SMEM = 1024 + 2 * STAGE + WARPS * 2 * OUT +
                              2 * (VT + ROWS * 8 + PVS * 4) + 16;
};

// Byte offset of (row r, byte b) in a tile of D-byte rows as TMA writes it
// with D-byte swizzling (CU_TENSOR_MAP_SWIZZLE_64B at D = 64, _32B at
// D = 32): the 16-byte chunk b / 16 is XOR-ed with address bits 7-8 (7),
// so that the eight rows of an mma fragment load fall on distinct banks.
// Tiles start on 1024-byte boundaries.
template <int D>
__device__ __forceinline__ int sw(int r, int b) {
  constexpr int SH = D == 64 ? 1 : 2;
  constexpr int MASK = D / 16 - 1;
  return r * D + ((((b >> 4) ^ ((r >> SH) & MASK)) << 4) | (b & 15));
}

// Lane t's quarter of row r of a swizzled tile, bytes [t*D/4, (t+1)*D/4):
// D/16 words in one load, free of bank conflicts over the eight rows of a
// fragment.
template <int D>
__device__ __forceinline__ void ld_quarter(const int8_t* tile, int r, int t,
                                           uint32_t (&w)[D / 16]) {
  if constexpr (D == 64) {
    const uint4 v = *reinterpret_cast<const uint4*>(tile + sw<64>(r, 16 * t));
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  } else {
    const uint2 v = *reinterpret_cast<const uint2*>(tile + sw<32>(r, 8 * t));
    w[0] = v.x;
    w[1] = v.y;
  }
}

// The byte in a v^T row of the word of keys (k32 chunk c, half h) that
// lane t reads as its B fragment for p.v: a lane's words lie together, two
// chunks to a 16-byte load (T = 32: one chunk, 8 bytes).
template <int T>
__device__ __forceinline__ int vt_pos(int c, int h, int t) {
  return T == 32 ? 8 * t + 4 * h : 64 * (c >> 1) + 16 * t + 8 * (c & 1) + 4 * h;
}

// int32 -> float, exact for |v| < 2^22 (every sum and product here)
__device__ __forceinline__ float i2f(int v) {
  return __int_as_float(v + BIAS_BITS) - BIAS;
}

__device__ __forceinline__ float clip8(float r) {
  return fminf(fmaxf(r, -128.0f), 127.0f);
}

// An 8-bit site's level clip(rint(x) - sh, -128, 127) as a float. INT:
// sh_b = 1.5 * 2^23 + sh (sh an integer; see the note).
template <bool INT>
__device__ __forceinline__ float site_lvl(float x, float sh, float sh_b) {
  return INT ? clip8((x + BIAS) - sh_b) : clip8(rintf(x) - sh);
}

// The same level as an int8 payload, in the low byte of the result.
template <bool INT>
__device__ __forceinline__ uint32_t site_bits(float x, float sh) {
  if (INT)
    return __float_as_uint(
        fminf(fmaxf((x + BIAS) - sh, BIAS - 128.0f), BIAS + 127.0f));
  // a level off the integers (a shift that is not one) truncates toward
  // zero, as the reference's conversion to int8 does
  return static_cast<uint32_t>(__float2int_rz(clip8(rintf(x) - sh)));
}

// the low bytes of a, b, c, d as one word [a, b, c, d]
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

// 4 x 4 bytes: o[j] = [w0.byte j, w1.byte j, w2.byte j, w3.byte j]
__device__ __forceinline__ void transpose4(uint32_t w0, uint32_t w1,
                                           uint32_t w2, uint32_t w3,
                                           uint32_t* o) {
  const uint32_t x0 = __byte_perm(w0, w1, 0x5140);
  const uint32_t x1 = __byte_perm(w0, w1, 0x7362);
  const uint32_t y0 = __byte_perm(w2, w3, 0x5140);
  const uint32_t y1 = __byte_perm(w2, w3, 0x7362);
  o[0] = __byte_perm(x0, y0, 0x5410);
  o[1] = __byte_perm(x0, y0, 0x7632);
  o[2] = __byte_perm(x1, y1, 0x5410);
  o[3] = __byte_perm(x1, y1, 0x7632);
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the 2-D box at (inner c0, outer c1) of `map` from shared memory
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// this thread's bulk stores but the newest N have read their sources
template <int N>
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void tma_store_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// The site scalars in the forms the chain uses, each computed as
// int8_attention_ref computes it.
struct Site {
  float q_sh, k_sh, v_sh, sc_sh, p_sh, c_sh, sc_b;
  float qk_over_sc, dqk, a, ash, inv_ps, pv_over_c, tpv;
};

template <int T, int D>
__device__ __forceinline__ Site site_of(const float* scal, float rsqrt_d,
                                        float log2e) {
  Site s;
  s.q_sh = scal[1];
  s.k_sh = scal[3];
  s.v_sh = scal[5];
  s.sc_sh = scal[7];
  s.p_sh = scal[9];
  s.c_sh = scal[11];
  s.sc_b = BIAS + s.sc_sh;
  s.qk_over_sc = (scal[0] * scal[2]) * (1.0f / scal[6]);
  s.dqk = (static_cast<float>(D) * s.q_sh) * s.k_sh;
  s.a = (scal[6] * rsqrt_d) * log2e;
  s.ash = s.a * s.sc_sh;
  s.inv_ps = 1.0f / scal[8];
  s.pv_over_c = (scal[8] * scal[4]) * (1.0f / scal[10]);
  s.tpv = (static_cast<float>(T) * s.p_sh) * s.v_sh;
  return s;
}

// Whether a shift lets the block take the integer path: an integer of
// magnitude at most 128, as every 8-bit site's (128 - zero point, or 0).
// Then every sum of the chain is an integer below 2^23, exact in float
// whatever its order (|q.k| <= 64 * 2^14, q_sh * ksum <= 128 * 64 * 128,
// |p.v| <= 128 * 2^14, p_sh * vsum <= 128 * 128 * 128, ...).
__device__ __forceinline__ bool small_int(float sh) {
  return fabsf(sh) <= SHIFT_MAX && rintf(sh) == sh;
}

// The block's shared work on a group that has landed in stage `st` (q | k
// | v tiles of 128 rows, then the items' mask rows), nv of its items
// valid:
// - v^T of each item into vt: the word of keys 32c + 16h + {2tq, 2tq+1,
//   2tq+8, 2tq+9} (in that order: p.v's A fragments hold the probs so) at
//   vt_pos(c, h, tq);
// - p_sh * vsum of each item's head dims into pvs;
// - each key's [q_sh*ksum, mask*log2e + a*sc_sh] into colv (a float4 a
//   key pair: the two ksum terms, then the two mask terms).
// INT: the two products are int32 (+ the bias's bits: see context), in
// the floats' bits.
template <int T, int D, bool INT>
__device__ __forceinline__ void prep(const int8_t* st, int8_t* vt,
                                     float* colv, float* pvs, const Site& s,
                                     float log2e, int nv) {
  using C = Cfg<T, D>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int8_t* sk = st + C::TILE;
  const int8_t* sv = st + 2 * C::TILE;
  const float* smask = reinterpret_cast<const float*>(st + 3 * C::TILE);

  // key constants: two threads a key, each summing half its row
  {
    const int c = threadIdx.x >> 1, half = threadIdx.x & 1;
    const int8_t* row = sk + c * D + half * (D / 2);
    int ks = 0;
#pragma unroll
    for (int u = 0; u < D / 32; ++u) {
      const uint4 x = *reinterpret_cast<const uint4*>(row + 16 * u);
      ks = __dp4a(static_cast<int>(x.x), static_cast<int>(ONES), ks);
      ks = __dp4a(static_cast<int>(x.y), static_cast<int>(ONES), ks);
      ks = __dp4a(static_cast<int>(x.z), static_cast<int>(ONES), ks);
      ks = __dp4a(static_cast<int>(x.w), static_cast<int>(ONES), ks);
    }
    ks += __shfl_xor_sync(FULL, ks, 1);
    if (c / T < nv)
      colv[(c >> 1) * 4 + 2 * half + (c & 1)] =
          half ? smask[c] * log2e + s.ash
               : INT ? __int_as_float(static_cast<int>(s.q_sh) * ks + BIAS_BITS)
                     : s.q_sh * i2f(ks);
  }

  // v^T and vsum: lane (chunk cc of 16 keys, tq) of warp w takes the keys
  // cc*16 + {2tq, 2tq+1, 2tq+8, 2tq+9} at head dims 8w .. 8w+7, writes them
  // as one word of each of those eight v^T rows, and sums each word (four
  // keys of one dim) with the item's other lanes
  const int dd0 = 8 * warp;
  if (dd0 < D) {
    const int cc = lane >> 2, tq = lane & 3;
    const int r0 = cc * 16 + 2 * tq;
    const int item = r0 / T;
    uint32_t o[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
    if (item < nv) {
      const uint2 w0 = *reinterpret_cast<const uint2*>(sv + sw<D>(r0, dd0));
      const uint2 w1 =
          *reinterpret_cast<const uint2*>(sv + sw<D>(r0 + 1, dd0));
      const uint2 w2 =
          *reinterpret_cast<const uint2*>(sv + sw<D>(r0 + 8, dd0));
      const uint2 w3 =
          *reinterpret_cast<const uint2*>(sv + sw<D>(r0 + 9, dd0));
      transpose4(w0.x, w1.x, w2.x, w3.x, o);
      transpose4(w0.y, w1.y, w2.y, w3.y, o + 4);
      const int kb = (cc * 16) % T;  // the 16 keys' first, in the item
      int8_t* dst = vt + (item * D + dd0) * C::LDV +
                    vt_pos<T>(kb >> 5, (kb >> 4) & 1, tq);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(dst + j * C::LDV) = o[j];
    }
    int vs[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      vs[j] = __dp4a(static_cast<int>(o[j]), static_cast<int>(ONES), 0);
    if constexpr (T == 128) {  // the whole warp is one item's keys
#pragma unroll
      for (int j = 0; j < 8; ++j) vs[j] = __reduce_add_sync(FULL, vs[j]);
    } else {
#pragma unroll
      for (int m = 1; m < T / 4; m <<= 1)
#pragma unroll
        for (int j = 0; j < 8; ++j) vs[j] += __shfl_xor_sync(FULL, vs[j], m);
    }
    if (item < nv && lane % (T / 4) == 0) {
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[j] = INT ? __int_as_float(static_cast<int>(s.p_sh) * vs[j] +
                                    BIAS_BITS)
                   : s.p_sh * i2f(vs[j]);
      float4* dst = reinterpret_cast<float4*>(pvs + item * D + dd0);
      dst[0] = make_float4(v[0], v[1], v[2], v[3]);
      dst[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
  }
}

// q.k^T of this warp's 16 query rows (group rows q0 .. q0+15) against the
// item's T keys (group rows k0 ..): acc[ni] is the m16n8 tile of keys
// ni*8 .., qs[0] / qs[2] the q rows' sums (rows g / g+8). The products
// take the head dims in an order of their own, the same for q and k:
// word 2kk + h of lane t's quarter of a row serves as k positions 32kk +
// 16h + 4t .. +3.
template <int T, int D>
__device__ __forceinline__ void scores(const int8_t* sq, const int8_t* sk,
                                       int q0, int k0, int g, int t,
                                       int (&acc)[Cfg<T, D>::NT][4],
                                       int (&qs)[4]) {
  using C = Cfg<T, D>;
  const unsigned ones[2] = {ONES, ONES};
  uint32_t lo[D / 16], hi[D / 16];
  ld_quarter<D>(sq, q0 + g, t, lo);
  ld_quarter<D>(sq, q0 + g + 8, t, hi);
  unsigned af[C::KD][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) qs[r] = 0;
#pragma unroll
  for (int kk = 0; kk < C::KD; ++kk) {
    af[kk][0] = lo[2 * kk];
    af[kk][1] = hi[2 * kk];
    af[kk][2] = lo[2 * kk + 1];
    af[kk][3] = hi[2 * kk + 1];
    tqmm::mma_k32(qs, af[kk], ones);
  }
#pragma unroll
  for (int ni = 0; ni < C::NT; ++ni) {
    uint32_t w[D / 16];
    ld_quarter<D>(sk, k0 + ni * 8 + g, t, w);
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[ni][r] = 0;
#pragma unroll
    for (int kk = 0; kk < C::KD; ++kk) {
      const unsigned bf[2] = {w[2 * kk], w[2 * kk + 1]};
      tqmm::mma_k32(acc[ni], af[kk], bf);
    }
  }
}

// The scores site, the exp2 softmax and the probs site on this warp's
// accumulators; the probs payload comes out as p.v's A fragments: pa[c]
// for keys 32c .. 32c+31, each 16 of them in the order (n-tile pair,
// lane t, column): position 4t + u holds key 8 (u >> 1) + 2t + (u & 1).
// SKIP: skip_max (no row max is taken off).
template <int T, int D, bool INT, bool SKIP>
__device__ __forceinline__ void softmax(const int (&acc)[Cfg<T, D>::NT][4],
                                        const int (&qs)[4], const float* colp,
                                        const Site& s, int t,
                                        unsigned (&pa)[Cfg<T, D>::KC][4]) {
  using C = Cfg<T, D>;
  const float qk_lo = s.k_sh * i2f(qs[0]);
  const float qk_hi = s.k_sh * i2f(qs[2]);
  // INT: scores = (acc + q_sh*ksum) + (k_sh*qsum + d*q_sh*k_sh), integers,
  // as the bits of (1.5 * 2^23 + the first) less (1.5 * 2^23 - the second)
  const float rb_lo = BIAS - (qk_lo + s.dqk);
  const float rb_hi = BIAS - (qk_hi + s.dqk);
  float sv[C::NT][4];
#pragma unroll
  for (int ni = 0; ni < C::NT; ++ni) {
    const float4 cv = *reinterpret_cast<const float4*>(colp + 4 * (ni * 4 + t));
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float kq = (r & 1) ? cv.y : cv.x;
      const float m2 = (r & 1) ? cv.w : cv.z;
      const float scr =
          INT ? __int_as_float(acc[ni][r] + __float_as_int(kq)) -
                    (r < 2 ? rb_lo : rb_hi)
              : ((i2f(acc[ni][r]) + kq) + (r < 2 ? qk_lo : qk_hi)) + s.dqk;
      sv[ni][r] =
          s.a * site_lvl<INT>(scr * s.qk_over_sc, s.sc_sh, s.sc_b) + m2;
    }
  }
  float m_lo = 0.0f, m_hi = 0.0f;
  if (!SKIP) {
    m_lo = __int_as_float(0xff800000);  // -inf
    m_hi = m_lo;
    // four running maxima a row half from -inf (all-NaN gives -inf), to
    // shorten the chains
    float mx[2][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) mx[0][j] = mx[1][j] = m_lo;
#pragma unroll
    for (int ni = 0; ni < C::NT; ++ni) {
      mx[0][ni & 3] = fmaxf(mx[0][ni & 3], fmaxf(sv[ni][0], sv[ni][1]));
      mx[1][ni & 3] = fmaxf(mx[1][ni & 3], fmaxf(sv[ni][2], sv[ni][3]));
    }
    m_lo = fmaxf(fmaxf(mx[0][0], mx[0][1]), fmaxf(mx[0][2], mx[0][3]));
    m_hi = fmaxf(fmaxf(mx[1][0], mx[1][1]), fmaxf(mx[1][2], mx[1][3]));
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      m_lo = fmaxf(m_lo, __shfl_xor_sync(FULL, m_lo, o));
      m_hi = fmaxf(m_hi, __shfl_xor_sync(FULL, m_hi, o));
    }
  }
  // e = exp2(s2 - m), or exp2(s2) under skip_max; the row sums in double,
  // two partial sums a row half to shorten the add chains
  double d[2][2] = {{0.0, 0.0}, {0.0, 0.0}};
#pragma unroll
  for (int ni = 0; ni < C::NT; ++ni) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float e =
          exp2f(SKIP ? sv[ni][r] : sv[ni][r] - (r < 2 ? m_lo : m_hi));
      sv[ni][r] = e;
      d[r >> 1][ni & 1] += static_cast<double>(e);
    }
  }
  double d_lo = d[0][0] + d[0][1], d_hi = d[1][0] + d[1][1];
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    d_lo += __shfl_xor_sync(FULL, d_lo, o);
    d_hi += __shfl_xor_sync(FULL, d_hi, o);
  }
  const float w_lo = s.inv_ps / static_cast<float>(d_lo);
  const float w_hi = s.inv_ps / static_cast<float>(d_hi);
#pragma unroll
  for (int c = 0; c < C::KC; ++c) {
    uint32_t u[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        u[n][r] = site_bits<INT>(sv[4 * c + n][r] * (r < 2 ? w_lo : w_hi),
                                 s.p_sh);
    pa[c][0] = pack4(u[0][0], u[0][1], u[1][0], u[1][1]);
    pa[c][1] = pack4(u[0][2], u[0][3], u[1][2], u[1][3]);
    pa[c][2] = pack4(u[2][0], u[2][1], u[3][0], u[3][1]);
    pa[c][3] = pack4(u[2][2], u[2][3], u[3][2], u[3][3]);
  }
}

// p.v of this warp's rows against the item's v^T (vti, D rows of LDV
// bytes) and p_sh * vsum (pvi), the context site, and the payload into
// the warp's staging tile (16 x D, swizzled as the output map's box)
template <int T, int D, bool INT>
__device__ __forceinline__ void context(const unsigned (&pa)[Cfg<T, D>::KC][4],
                                        const int8_t* vti, const float* pvi,
                                        const Site& s, int g, int t,
                                        uint8_t* ost) {
  using C = Cfg<T, D>;
  const unsigned ones[2] = {ONES, ONES};
  int ps[4] = {0, 0, 0, 0};
#pragma unroll
  for (int c = 0; c < C::KC; ++c) tqmm::mma_k32(ps, pa[c], ones);
  const float vp_lo = s.v_sh * i2f(ps[0]);
  const float vp_hi = s.v_sh * i2f(ps[2]);
  // INT: ctx = (p.v + p_sh*vsum) + (v_sh*psum + T*p_sh*v_sh), as in softmax
  const float rb_lo = BIAS - (vp_lo + s.tpv);
  const float rb_hi = BIAS - (vp_hi + s.tpv);
#pragma unroll
  for (int ni = 0; ni < C::ND; ++ni) {
    int a2[4] = {0, 0, 0, 0};
    const int8_t* row = vti + (ni * 8 + g) * C::LDV;
    unsigned vb[C::KC][2];
    if constexpr (T == 32) {
      const uint2 v = *reinterpret_cast<const uint2*>(row + vt_pos<T>(0, 0, t));
      vb[0][0] = v.x;
      vb[0][1] = v.y;
    } else {
#pragma unroll
      for (int c = 0; c < C::KC; c += 2) {
        const uint4 v =
            *reinterpret_cast<const uint4*>(row + vt_pos<T>(c, 0, t));
        vb[c][0] = v.x;
        vb[c][1] = v.y;
        vb[c + 1][0] = v.z;
        vb[c + 1][1] = v.w;
      }
    }
#pragma unroll
    for (int c = 0; c < C::KC; ++c) tqmm::mma_k32(a2, pa[c], vb[c]);
    const float2 pv = *reinterpret_cast<const float2*>(pvi + ni * 8 + 2 * t);
    uint32_t u[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float pvd = (r & 1) ? pv.y : pv.x;
      const float ctx =
          INT ? __int_as_float(a2[r] + __float_as_int(pvd)) -
                    (r < 2 ? rb_lo : rb_hi)
              : ((i2f(a2[r]) + pvd) + (r < 2 ? vp_lo : vp_hi)) + s.tpv;
      u[r] = site_bits<INT>(ctx * s.pv_over_c, s.c_sh);
    }
    // rows g (dims 2t, 2t+1) and g+8 of this lane; a lane pair makes one
    // 4-byte word of row g (even t) and one of row g+8 (odd t)
    const uint32_t w = pack4(u[0], u[1], u[2], u[3]);
    const uint32_t p = __shfl_xor_sync(FULL, w, 1);
    const uint32_t word = (t & 1) ? __byte_perm(p, w, 0x7632)
                                  : __byte_perm(w, p, 0x5410);
    *reinterpret_cast<uint32_t*>(
        ost + sw<D>(g + 8 * (t & 1), ni * 8 + 4 * (t >> 1))) = word;
  }
}

// blocks an SM each instance is built for: 128 registers a thread
constexpr int MIN_BLOCKS = 2;

template <int T, int D>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    attn_kernel(const __grid_constant__ CUtensorMap map_q,
                const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v,
                const __grid_constant__ CUtensorMap map_m,
                const __grid_constant__ CUtensorMap map_o,
                const float* __restrict__ scal, int n_items, int n_heads,
                float rsqrt_d, float log2e, int skip_max) {
  using C = Cfg<T, D>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // offsets from the shared array itself, so that every access stays a
  // shared-memory one
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* staging = ring + 2 * C::STAGE;
  int8_t* vt = reinterpret_cast<int8_t*>(staging + WARPS * 2 * C::OUT);
  float* colv = reinterpret_cast<float*>(vt + 2 * C::VT);
  float* pvs = colv + 2 * ROWS * 2;
  uint64_t* full = reinterpret_cast<uint64_t*>(pvs + 2 * C::PVS);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_groups = (n_items + C::G - 1) / C::G;

  // one thread loads group grp (the block's n-th) into stage n & 1
  auto load = [&](int grp, int n) {
    const int first = grp * C::G;
    const int nv = min(C::G, n_items - first);
    uint8_t* st = ring + (n & 1) * C::STAGE;
    uint64_t* bar = &full[n & 1];
    tqwg::mbar_arrive_expect_tx(bar, nv * (3 * T * D + 4 * T));
    for (int i = 0; i < nv; ++i) {
      const int b = (first + i) / n_heads;
      const int h = first + i - b * n_heads;
      tqwg::tma_load_2d(st + i * T * D, &map_q, bar, h * D, b * T);
      tqwg::tma_load_2d(st + C::TILE + i * T * D, &map_k, bar, h * D, b * T);
      tqwg::tma_load_2d(st + 2 * C::TILE + i * T * D, &map_v, bar, h * D,
                        b * T);
      tqwg::tma_load_2d(st + 3 * C::TILE + i * T * 4, &map_m, bar, 0, b);
    }
  };
  if (threadIdx.x == 0) {
    tqwg::mbar_init(&full[0], 1);
    tqwg::mbar_init(&full[1], 1);
    tqwg::fence_barrier_init();
    tqwg::tma_prefetch_map(&map_q);
    tqwg::tma_prefetch_map(&map_k);
    tqwg::tma_prefetch_map(&map_v);
    tqwg::tma_prefetch_map(&map_m);
    tqwg::tma_prefetch_map(&map_o);
    for (int n = 0; n < 2 && blockIdx.x + n * gridDim.x < n_groups; ++n)
      load(blockIdx.x + n * gridDim.x, n);
  }
  __syncthreads();

  const Site s = site_of<T, D>(scal, rsqrt_d, log2e);
  const bool fast = small_int(s.q_sh) && small_int(s.k_sh) &&
                    small_int(s.v_sh) && small_int(s.sc_sh) &&
                    small_int(s.p_sh) && small_int(s.c_sh);
  const int g = lane >> 2, t = lane & 3;
  const int slot = warp / (T / 16);                  // this warp's item
  const int q0 = slot * T + (warp % (T / 16)) * 16;  // its first query row
  int n = 0;
  for (int grp = blockIdx.x; grp < n_groups; grp += gridDim.x, ++n) {
    const int par = n & 1;
    const int first = grp * C::G;
    const int nv = min(C::G, n_items - first);
    const int8_t* st = reinterpret_cast<const int8_t*>(ring + par * C::STAGE);
    int8_t* vtp = vt + par * C::VT;
    float* colp = colv + par * ROWS * 2;
    float* pvp = pvs + par * C::PVS;
    tqwg::mbar_wait(&full[par], (n >> 1) & 1);
    if (fast)
      prep<T, D, true>(st, vtp, colp, pvp, s, log2e, nv);
    else
      prep<T, D, false>(st, vtp, colp, pvp, s, log2e, nv);
    __syncthreads();
    // every warp is past its previous group: its stage takes the group
    // after this one
    if (threadIdx.x == 0 && n >= 1 && grp + gridDim.x < n_groups)
      load(grp + gridDim.x, n + 1);
    if (slot >= nv) continue;
    int acc[C::NT][4], qs[4];
    scores<T, D>(st, st + C::TILE, q0, slot * T, g, t, acc, qs);
    unsigned pa[C::KC][4];
    const float* ci = colp + slot * T * 2;
    if (fast && skip_max)
      softmax<T, D, true, true>(acc, qs, ci, s, t, pa);
    else if (fast)
      softmax<T, D, true, false>(acc, qs, ci, s, t, pa);
    else if (skip_max)
      softmax<T, D, false, true>(acc, qs, ci, s, t, pa);
    else
      softmax<T, D, false, false>(acc, qs, ci, s, t, pa);
    uint8_t* ost = staging + (warp * 2 + par) * C::OUT;
    if (lane == 0) tma_store_wait_read<1>();  // ost's last store has read it
    __syncwarp();
    const int8_t* vti = vtp + slot * D * C::LDV;
    const float* pvi = pvp + slot * D;
    if (fast)
      context<T, D, true>(pa, vti, pvi, s, g, t, ost);
    else
      context<T, D, false>(pa, vti, pvi, s, g, t, ost);
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) {
      const int b = (first + slot) / n_heads;
      const int h = first + slot - b * n_heads;
      tma_store_2d(&map_o, ost, h * D, b * T + (q0 - slot * T));
    }
  }
  if (lane == 0) tma_store_wait_all();
}

// A 2-D tensor map of a row-major (rows, cols) array with a row stride of
// stride_bytes, read in boxes of box_rows x box_cols: int8 (f32 false) or
// f32 elements
inline bool make_map(CUtensorMap* map, const void* base, bool f32,
                     uint64_t cols, uint64_t rows, uint64_t stride_bytes,
                     uint32_t box_cols, uint32_t box_rows,
                     CUtensorMapSwizzle swz) {
  tqwg::EncodeTiledFn enc = tqwg::encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {stride_bytes};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem[2] = {1u, 1u};
  return enc(map,
             f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                 : CU_TENSOR_MAP_DATA_TYPE_UINT8,
             2, const_cast<void*>(base), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// resident blocks an SM of the (T, D) instance (with its shared memory
// allowance set), or -1
template <int T, int D>
int blocks_per_sm() {
  constexpr int smem = Cfg<T, D>::SMEM;
  const auto kernel = attn_kernel<T, D>;
  int n = 0;
  if (cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, THREADS,
                                                    smem) != cudaSuccess)
    return -1;
  return n;
}

// q, k, v (B*T rows, hidden columns at row strides ld*), the (B, T) mask
// and the (B*T, hidden) output as tensor maps: int8 boxes of T (the
// output: 16) rows x D bytes, D-byte swizzled; f32 mask boxes of a row.
// One block a group of items, at most the card's resident blocks.
template <int T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, int ldq,
                   int ldk, int ldv, const void* mask, const float* scal,
                   void* out, int B, int hidden, int n_heads, float rsqrt_d,
                   float log2e, int skip_max, cudaStream_t stream) {
  constexpr int smem = Cfg<T, D>::SMEM;
  static const int slots = [] {
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return 0;
    const int per_sm = blocks_per_sm<T, D>();
    return per_sm > 0 ? sms * per_sm : 0;
  }();
  if (slots == 0) return cudaErrorInvalidConfiguration;
  const CUtensorMapSwizzle swz =
      D == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
  const uint64_t rows = static_cast<uint64_t>(B) * T;
  CUtensorMap mq, mk, mv, mm, mo;
  if (!make_map(&mq, q, false, hidden, rows, ldq, D, T, swz) ||
      !make_map(&mk, k, false, hidden, rows, ldk, D, T, swz) ||
      !make_map(&mv, v, false, hidden, rows, ldv, D, T, swz) ||
      !make_map(&mm, mask, true, T, B, 4ull * T, T, 1,
                CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !make_map(&mo, out, false, hidden, rows, hidden, D, 16, swz))
    return cudaErrorInvalidValue;
  const int n_items = B * n_heads;
  const int groups = (n_items + Cfg<T, D>::G - 1) / Cfg<T, D>::G;
  const int grid = groups < slots ? groups : slots;
  attn_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      mq, mk, mv, mm, mo, scal, n_items, n_heads, rsqrt_d, log2e, skip_max);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_t(int T, const void* q, const void* k, const void* v,
                     int ldq, int ldk, int ldv, const void* mask,
                     const float* scal, void* out, int B, int hidden,
                     int n_heads, float rsqrt_d, float log2e, int skip_max,
                     cudaStream_t st) {
  switch (T) {
    case 32: return launch<32, D>(q, k, v, ldq, ldk, ldv, mask, scal, out, B, hidden, n_heads, rsqrt_d, log2e, skip_max, st);
    case 64: return launch<64, D>(q, k, v, ldq, ldk, ldv, mask, scal, out, B, hidden, n_heads, rsqrt_d, log2e, skip_max, st);
    case 128: return launch<128, D>(q, k, v, ldq, ldk, ldv, mask, scal, out, B, hidden, n_heads, rsqrt_d, log2e, skip_max, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q / k / v: the (B*T, *) int8 arrays, each pointer at its hidden-wide
// column block, with row strides ldq / ldk / ldv (multiples of 16 bytes,
// pointers 16-byte aligned); heads are head-minor inside each block.
// mask: (B, T) f32 additive bias, 16-byte aligned. scal: 12 f32 site
// scalars. out: (B*T, hidden), 16-byte aligned. T in {32, 64, 128},
// head_dim = hidden / n_heads in {32, 64}. Returns the launch's
// cudaError_t (cudaErrorInvalidValue for arguments the kernel does not
// take, or a tensor map that cannot be encoded).
extern "C" int tq_int8_attention(const void* q, const void* k, const void* v,
                                 int ldq, int ldk, int ldv, const void* mask,
                                 const void* scal, void* out, int B, int T,
                                 int hidden, int n_heads, float rsqrt_d,
                                 float log2e, int skip_max, void* stream) {
  const float* s = static_cast<const float*>(scal);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || n_heads <= 0 || hidden % n_heads)
    return static_cast<int>(cudaErrorInvalidValue);
  const int D = hidden / n_heads;
  if ((ldq | ldk | ldv) % 16 ||
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(mask) |
       reinterpret_cast<uintptr_t>(out)) & 15)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  switch (D) {
    case 32: e = launch_t<32>(T, q, k, v, ldq, ldk, ldv, mask, s, out, B, hidden, n_heads, rsqrt_d, log2e, skip_max, st); break;
    case 64: e = launch_t<64>(T, q, k, v, ldq, ldk, ldv, mask, s, out, B, hidden, n_heads, rsqrt_d, log2e, skip_max, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(e);
}

// Resident blocks an SM of the (T, head_dim) instance, or -1 (shapes it
// does not take, or a failed query).
extern "C" int tq_int8_attention_blocks(int T, int D) {
  switch (D * 1000 + T) {
    case 32032: return blocks_per_sm<32, 32>();
    case 32064: return blocks_per_sm<64, 32>();
    case 32128: return blocks_per_sm<128, 32>();
    case 64032: return blocks_per_sm<32, 64>();
    case 64064: return blocks_per_sm<64, 64>();
    case 64128: return blocks_per_sm<128, 64>();
    default: return -1;
  }
}

// ---------------------------------------------------------------------------
// The attention's other forms (the second kernel, attn_flex_*)
//
// Replaces the same TPU function for every form but the all-8-bit payload
// one above: _attn_row with a scores site of 2-16 bits or disabled (bits
// 0: s2 = q_s k_s rsqrt(d) log2e * scores + mask log2e), a probs site of
// 1-16 bits or disabled (the raw softmax), a context site of 1-16 bits or
// disabled (a float32 value edge out, _emit_ctx), and the value-space form
// of float32 q / k / v values with identity site scalars
// (int8_attention_ref(dots='f32'), the engine's 16-bit / sub-8 /
// per-column q / k / v sites).
//
//   scores = q . k   (payloads: + q_sh*ksum + k_sh*qsum + d*q_sh*k_sh)
//   s2     = the scores site as above, or its disabled form
//   e      = exp2(s2 [- rowmax]), sum in double rounded once
//   probs  = the probs site's payload, shifted levels or e / sum
//   ctx    = probs . v (a 1-8-bit probs site on payloads: the integer sum
//            + p_sh*vsum + v_sh*psum + T*p_sh*v_sh; else probs . (v +
//            v_sh), float64 sums rounded once)
//   out    = the context site: a payload, or float values (_emit_ctx)
//
// What bounds it on the card: at BERT-base (B = 128, T = 128, 12 heads of
// 64) q.k and p.v are 6.4 G multiply-adds each way: as float64 products
// 0.10 ms at the 67 TFLOP/s float64 tensor-core peak, as int8 ones 3 us,
// against 50-150 MB of traffic (15-45 us: int8 or float32 q / k / v, an
// int8 or float32 context). So the integer-dot forms are bound by bytes
// and the float ones by the float64 tensor cores.
//
// Two routes, picked by the form alone (attn_flex_route in
// engine_kernels.py; both compute int8_attention_ref's function):
// - integer (payload q / k / v, a probs site of 1-16 bits):
//   attn_flex_i8_kernel on K2's skeleton and device functions above (two
//   persistent blocks an SM, TMA stages, v^T, the key constants, q.k on
//   mma.sync s8 m16n8k32 with the row sums by a ones operand), then the
//   scores site, the softmax and the probs site in registers, in the plain
//   version's float32 order (-fmad=false, exp2f, the denominator in double
//   rounded once, a payload level off the integers truncated). p.v:
//   - 1-8-bit probs (PV_PAY): K2's payload product s8 x s8 and its
//     corrections, in float32 as the plain version takes them (|p.v| <=
//     T * 128 * 128 = 2^21, exact);
//   - 9-16-bit probs (PV_LVL): the shifted level L (an integer in [lo_b,
//     lo_b + 2^bits - 1], lo_b = p_sh - 2^(bits-1)) as U = L - lo_b in
//     [0, 65535], split into two byte planes U = lo + 256 hi, each on
//     mma.sync u8 x s8 against v8: |sum lo * v8| and |sum hi * v8| <= T *
//     255 * 128 < 2^22 in int32; sum U by a ones operand (<= T * 65535 <
//     2^23); then in int64 ctx = (lo.v8 + 256 hi.v8) + lo_b * vsum + v_sh *
//     (sum U + T * lo_b), the exact value of sum L (v8 + v_sh) (|ctx| <
//     2^42 under the block's condition below), rounded once to float32:
//     the plain version's float64 sum of these integer products is exact
//     too (each product < 2^34, every partial sum < 2^53), so this form is
//     bit-identical, with no tie. The condition, taken once a block as K2's
//     small_int: p_sh and v_sh integers of magnitude at most 2^16 (then L,
//     v8 + v_sh and the level bounds are exact in float32). A block whose
//     shifts miss it (never the engine's: zero_point_of rounds) takes p.v
//     on the float64 tensor cores as the float route does (L and v8 + v_sh
//     as float32 values), the plain function too;
//   - a disabled probs site (PV_F64, {'p': 'fp32'}): q.k stays on the int8
//     tensor cores, p.v on the float64 ones.
// - float64 (float32 q / k / v values): attn_flex_f32_kernel, a block of
//   eight warps a group of 128 query rows, one block an SM (up to 255
//   registers a thread: at two, ptxas spilled and the call took 1.2x as
//   long), persistent over the groups: the next group's q, k and v (as
//   float32, 16-byte chunks swapped in odd rows of q and k, rows of D + 4
//   for v) and mask rows load by cp.async into the other of two stages
//   (98.5 KB each at (128, 64)) under this group's products (staged one
//   group a block, the loads' latency set the time: 0.22 ms, not 0.15);
//   each warp's q.k over 32 keys at a time on DMMA (16 float64 sums a
//   key n8 tile, rounded to float32 scores as the plain version rounds
//   them; the scores and then the probs stay float32 registers, 64 a
//   thread at T = 128), the softmax, then p.v on DMMA over every head dim
//   at once (64 float64 sums a thread), each probs fragment converted to
//   float64 once and each value of v (+ v_sh) as its fragment is built.
// Float64 sums (DMMA) are the exact sums' roundings but where the float64
// sum's own rounding meets a float32 tie; so are the plain version's.
// Every instance is built at each (T, D) of ATTN_SHAPES.
// ---------------------------------------------------------------------------

#include "dmma_common.cuh"   // DMMA, u8 x s8 mma.sync, cp.async groups

namespace {

enum { PV_PAY = 0, PV_LVL = 1, PV_F64 = 2 };
constexpr float LVL_SHIFT_MAX = 65536.0f;   // see PV_LVL's condition
constexpr int KS_F = 4;   // the float dots' DMMA depth / 4: m16n8k16
constexpr int NDG = 2;    // head-dim n8 tiles a float p.v pass (integer
                          // route); the float route takes them all
constexpr int KCH = 4;    // key n8 tiles a float q.k pass
// blocks an SM each instance is built for (its launch bounds): two where
// p.v runs on the int8 tensor cores (128 registers a thread), one where
// it runs on the float64 ones (up to 255: at two, ptxas spilled 0.5-0.8 KB
// a thread and the call took 1.8x as long)
template <int PV>
constexpr int i8_blocks() {
  return PV == PV_F64 ? 1 : 2;
}
constexpr int F32_BLOCKS = 1;

__device__ __forceinline__ float clipf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float half_of(int bits) {
  return bits ? static_cast<float>(1 << (bits - 1)) : 0.0f;
}

// The flex sites' constants, each computed as int8_attention_ref computes
// it; s holds K2's (the payload scores and context)
struct FSite {
  Site s;
  float coef;           // the scores site disabled: q_s k_s rsqrt(d) log2e
  float sc_lo, sc_hi;   // the scores site's level bounds
  float p_lo, p_hi;     // the probs site's clip bounds (see probs_of)
  float c_s, c_lo, c_hi;
  int sc_bits, p_bits, c_bits;
};

// pay: a 1-8-bit probs site on payloads (bounds of the payload level);
// else the bounds of the shifted level (9-16 bits: p_sh - half, (p_sh +
// half) - 1; 1-8 bits on values: p_sh + -half, p_sh + (half - 1))
template <int T, int D>
__device__ __forceinline__ FSite fsite_of(const float* scal, float rsqrt_d,
                                          float log2e, int sc_bits,
                                          int p_bits, int c_bits, bool pay) {
  FSite f;
  f.s = site_of<T, D>(scal, rsqrt_d, log2e);
  if (!sc_bits) f.s.ash = 0.0f;   // the keys' mask term: mask * log2e
  f.coef = ((scal[0] * scal[2]) * rsqrt_d) * log2e;
  const float hs = half_of(sc_bits), hp = half_of(p_bits),
              hc = half_of(c_bits);
  f.sc_lo = -hs;
  f.sc_hi = hs - 1.0f;
  if (pay) {
    f.p_lo = -hp;
    f.p_hi = hp - 1.0f;
  } else if (p_bits > 8) {
    f.p_lo = f.s.p_sh - hp;
    f.p_hi = (f.s.p_sh + hp) - 1.0f;
  } else {
    f.p_lo = f.s.p_sh + -hp;
    f.p_hi = f.s.p_sh + (hp - 1.0f);
  }
  f.c_s = scal[10];
  if (c_bits > 8) {
    f.c_lo = f.s.c_sh - hc;
    f.c_hi = (f.s.c_sh + hc) - 1.0f;
  } else {
    f.c_lo = -hc;
    f.c_hi = hc - 1.0f;
  }
  f.sc_bits = sc_bits;
  f.p_bits = p_bits;
  f.c_bits = c_bits;
  return f;
}

// s2 of one score (scr: the float32 scores) and its key's mask term
__device__ __forceinline__ float s2_of(float scr, float mk, const FSite& f) {
  if (f.sc_bits == 0) return f.coef * scr + mk;
  return f.s.a * clipf(rintf(scr * f.s.qk_over_sc) - f.s.sc_sh, f.sc_lo,
                       f.sc_hi) +
         mk;
}

// The softmax of this warp's rows on the m16n8 layout (sv[ni][r]: row g
// for r < 2, g + 8 else; keys 8 ni + 2t + (r & 1)): e = exp2(s2 [- m])
// in place, and the two rows' denominators, summed in double and rounded
// once (the row max from -inf by fmaxf, four running maxima a row half,
// as K2's)
template <int NT, bool SKIP>
__device__ __forceinline__ void flex_softmax(float (&sv)[NT][4], float& dlo,
                                             float& dhi) {
  float m_lo = 0.0f, m_hi = 0.0f;
  if (!SKIP) {
    m_lo = __int_as_float(0xff800000);  // -inf
    m_hi = m_lo;
    float mx[2][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) mx[0][j] = mx[1][j] = m_lo;
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) {
      mx[0][ni & 3] = fmaxf(mx[0][ni & 3], fmaxf(sv[ni][0], sv[ni][1]));
      mx[1][ni & 3] = fmaxf(mx[1][ni & 3], fmaxf(sv[ni][2], sv[ni][3]));
    }
    m_lo = fmaxf(fmaxf(mx[0][0], mx[0][1]), fmaxf(mx[0][2], mx[0][3]));
    m_hi = fmaxf(fmaxf(mx[1][0], mx[1][1]), fmaxf(mx[1][2], mx[1][3]));
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      m_lo = fmaxf(m_lo, __shfl_xor_sync(FULL, m_lo, o));
      m_hi = fmaxf(m_hi, __shfl_xor_sync(FULL, m_hi, o));
    }
  }
  double d[2][2] = {{0.0, 0.0}, {0.0, 0.0}};
#pragma unroll
  for (int ni = 0; ni < NT; ++ni) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float e =
          exp2f(SKIP ? sv[ni][r] : sv[ni][r] - (r < 2 ? m_lo : m_hi));
      sv[ni][r] = e;
      d[r >> 1][ni & 1] += static_cast<double>(e);
    }
  }
  double d_lo = d[0][0] + d[0][1], d_hi = d[1][0] + d[1][1];
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    d_lo += __shfl_xor_sync(FULL, d_lo, o);
    d_hi += __shfl_xor_sync(FULL, d_hi, o);
  }
  dlo = static_cast<float>(d_lo);
  dhi = static_cast<float>(d_hi);
}

// The probs site's float value of e (not a payload): the shifted level
// (1-16 bits) or, disabled, e / sum
__device__ __forceinline__ float probs_of(float e, float w, float inv_den,
                                          const FSite& f) {
  return f.p_bits == 0 ? e * inv_den : clipf(rintf(e * w), f.p_lo, f.p_hi);
}

// Two neighbouring context outputs (dims d, d + 1 of one row) through the
// context site, at element o of the (M, hidden) output
__device__ __forceinline__ void store_ctx2(void* out, size_t o, float c0,
                                           float c1, const FSite& f) {
  const float x0 = c0 * f.s.pv_over_c, x1 = c1 * f.s.pv_over_c;
  if (f.c_bits == 0) {
    *reinterpret_cast<float2*>(static_cast<float*>(out) + o) =
        make_float2(x0, x1);
  } else if (f.c_bits > 8) {
    *reinterpret_cast<float2*>(static_cast<float*>(out) + o) =
        make_float2(f.c_s * clipf(rintf(x0), f.c_lo, f.c_hi),
                    f.c_s * clipf(rintf(x1), f.c_lo, f.c_hi));
  } else {
    // a level off the integers truncates, as the plain version's cast
    char2 v;
    v.x = static_cast<signed char>(
        __float2int_rz(clipf(rintf(x0) - f.s.c_sh, f.c_lo, f.c_hi)));
    v.y = static_cast<signed char>(
        __float2int_rz(clipf(rintf(x1) - f.s.c_sh, f.c_lo, f.c_hi)));
    *reinterpret_cast<char2*>(static_cast<int8_t*>(out) + o) = v;
  }
}

// p.v on the float64 tensor cores: this warp's 16 rows of float probs
// (sv, the m16n8 layout of softmax) against v, G head-dim n8 tiles a
// pass (each probs fragment converted once a pass); load_b(nd, q16, b)
// gives b[s] = v + v_sh at key 16 q16 + {2t, 2t+1, 2t+8, 2t+9}[s] and
// head dim 8 nd + g, the keys the probs fragment's k positions t + 4s
// hold. emit(nd, ctx) takes the float32 context of tile nd (the m16n8
// layout).
template <int T, int D, int G, typename LoadB, typename Emit>
__device__ __forceinline__ void pv_f64(const float (&sv)[T / 8][4],
                                       LoadB load_b, Emit emit) {
#pragma unroll 1
  for (int nd0 = 0; nd0 < D / 8; nd0 += G) {
    double c[G][4];
#pragma unroll
    for (int j = 0; j < G; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) c[j][i] = 0.0;
#pragma unroll
    for (int q16 = 0; q16 < T / 16; ++q16) {
      double a[8];
#pragma unroll
      for (int s = 0; s < 4; ++s)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          a[2 * s + r] = sv[2 * q16 + (s >> 1)][(s & 1) + 2 * r];
#pragma unroll
      for (int j = 0; j < G; ++j) {
        double b[4];
        load_b(nd0 + j, q16, b);
        tqdm::dmma16<KS_F>(c[j], a, b);
      }
    }
#pragma unroll
    for (int j = 0; j < G; ++j) {
      float ctx[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ctx[i] = __double2float_rn(c[j][i]);
      emit(nd0 + j, ctx);
    }
  }
}

// PV_LVL's condition on a block: exact integer p.v (see the note)
__device__ __forceinline__ bool lvl_exact(float p_sh, float v_sh) {
  return fabsf(p_sh) <= LVL_SHIFT_MAX && rintf(p_sh) == p_sh &&
         fabsf(v_sh) <= LVL_SHIFT_MAX && rintf(v_sh) == v_sh;
}

template <int T, int D>
struct FCfg {
  using C = Cfg<T, D>;
  // K2's layout without the output staging: two stages | x 2: v^T, key
  // constants, p_sh * vsum (PV_LVL: vsum) | barriers
  static constexpr int SMEM =
      1024 + 2 * C::STAGE + 2 * (C::VT + ROWS * 8 + C::PVS * 4) + 16;
};

template <int T, int D, int PV>
__global__ void __launch_bounds__(THREADS, i8_blocks<PV>())
    attn_flex_i8_kernel(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v,
                        const __grid_constant__ CUtensorMap map_m,
                        const float* __restrict__ scal,
                        void* __restrict__ out, int n_items, int n_heads,
                        int hidden, float rsqrt_d, float log2e,
                        int skip_max, int sc_bits, int p_bits, int c_bits) {
  using C = Cfg<T, D>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  int8_t* vt = reinterpret_cast<int8_t*>(ring + 2 * C::STAGE);
  float* colv = reinterpret_cast<float*>(vt + 2 * C::VT);
  float* pvs = colv + 2 * ROWS * 2;
  uint64_t* full = reinterpret_cast<uint64_t*>(pvs + 2 * C::PVS);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_groups = (n_items + C::G - 1) / C::G;

  auto load = [&](int grp, int n) {
    const int first = grp * C::G;
    const int nv = min(C::G, n_items - first);
    uint8_t* st = ring + (n & 1) * C::STAGE;
    uint64_t* bar = &full[n & 1];
    tqwg::mbar_arrive_expect_tx(bar, nv * (3 * T * D + 4 * T));
    for (int i = 0; i < nv; ++i) {
      const int b = (first + i) / n_heads;
      const int h = first + i - b * n_heads;
      tqwg::tma_load_2d(st + i * T * D, &map_q, bar, h * D, b * T);
      tqwg::tma_load_2d(st + C::TILE + i * T * D, &map_k, bar, h * D, b * T);
      tqwg::tma_load_2d(st + 2 * C::TILE + i * T * D, &map_v, bar, h * D,
                        b * T);
      tqwg::tma_load_2d(st + 3 * C::TILE + i * T * 4, &map_m, bar, 0, b);
    }
  };
  if (threadIdx.x == 0) {
    tqwg::mbar_init(&full[0], 1);
    tqwg::mbar_init(&full[1], 1);
    tqwg::fence_barrier_init();
    tqwg::tma_prefetch_map(&map_q);
    tqwg::tma_prefetch_map(&map_k);
    tqwg::tma_prefetch_map(&map_v);
    tqwg::tma_prefetch_map(&map_m);
    for (int n = 0; n < 2 && blockIdx.x + n * gridDim.x < n_groups; ++n)
      load(blockIdx.x + n * gridDim.x, n);
  }
  __syncthreads();

  const FSite f = fsite_of<T, D>(scal, rsqrt_d, log2e, sc_bits, p_bits,
                                 c_bits, PV == PV_PAY);
  // prep's p_sh * vsum: vsum itself where PV_LVL takes it apart
  Site sp = f.s;
  if (PV == PV_LVL) sp.p_sh = 1.0f;
  const bool exact = PV == PV_LVL && lvl_exact(f.s.p_sh, f.s.v_sh);
  const int g = lane >> 2, t = lane & 3;
  const int slot = warp / (T / 16);
  const int q0 = slot * T + (warp % (T / 16)) * 16;
  int n = 0;
  for (int grp = blockIdx.x; grp < n_groups; grp += gridDim.x, ++n) {
    const int par = n & 1;
    const int first = grp * C::G;
    const int nv = min(C::G, n_items - first);
    const int8_t* st = reinterpret_cast<const int8_t*>(ring + par * C::STAGE);
    int8_t* vtp = vt + par * C::VT;
    float* colp = colv + par * ROWS * 2;
    float* pvp = pvs + par * C::PVS;
    tqwg::mbar_wait(&full[par], (n >> 1) & 1);
    prep<T, D, false>(st, vtp, colp, pvp, sp, log2e, nv);
    __syncthreads();
    if (threadIdx.x == 0 && n >= 1 && grp + gridDim.x < n_groups)
      load(grp + gridDim.x, n + 1);
    if (slot >= nv) continue;
    const int item = first + slot;
    const int b = item / n_heads, hd = item - b * n_heads;
    // this warp's output rows g and g + 8, at head hd's columns
    const size_t orow =
        static_cast<size_t>(b * T + (q0 - slot * T) + g) * hidden + hd * D;
    const size_t o8 = static_cast<size_t>(8) * hidden;

    int acc[C::NT][4], qs[4];
    scores<T, D>(st, st + C::TILE, q0, slot * T, g, t, acc, qs);
    const float* ci = colp + slot * T * 2;
    const float qk_lo = f.s.k_sh * i2f(qs[0]);
    const float qk_hi = f.s.k_sh * i2f(qs[2]);
    float sv[C::NT][4];
#pragma unroll
    for (int ni = 0; ni < C::NT; ++ni) {
      const float4 cv =
          *reinterpret_cast<const float4*>(ci + 4 * (ni * 4 + t));
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float kq = (r & 1) ? cv.y : cv.x;
        const float m2 = (r & 1) ? cv.w : cv.z;
        const float scr =
            ((i2f(acc[ni][r]) + kq) + (r < 2 ? qk_lo : qk_hi)) + f.s.dqk;
        sv[ni][r] = s2_of(scr, m2, f);
      }
    }
    float dlo, dhi;
    if (skip_max)
      flex_softmax<C::NT, true>(sv, dlo, dhi);
    else
      flex_softmax<C::NT, false>(sv, dlo, dhi);
    const float w_lo = f.s.inv_ps / dlo, w_hi = f.s.inv_ps / dhi;
    const int8_t* vti = vtp + slot * D * C::LDV;
    const float* pvi = pvp + slot * D;

    if constexpr (PV == PV_PAY) {
      // K2's payload p.v: the probs' int8 payload in the A fragments
      unsigned pa[C::KC][4];
#pragma unroll
      for (int c = 0; c < C::KC; ++c) {
        uint32_t u[4][4];
#pragma unroll
        for (int nn = 0; nn < 4; ++nn)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            u[nn][r] = static_cast<uint32_t>(__float2int_rz(
                clipf(rintf(sv[4 * c + nn][r] * (r < 2 ? w_lo : w_hi)) -
                          f.s.p_sh,
                      f.p_lo, f.p_hi)));
        pa[c][0] = pack4(u[0][0], u[0][1], u[1][0], u[1][1]);
        pa[c][1] = pack4(u[0][2], u[0][3], u[1][2], u[1][3]);
        pa[c][2] = pack4(u[2][0], u[2][1], u[3][0], u[3][1]);
        pa[c][3] = pack4(u[2][2], u[2][3], u[3][2], u[3][3]);
      }
      const unsigned ones[2] = {ONES, ONES};
      int ps[4] = {0, 0, 0, 0};
#pragma unroll
      for (int c = 0; c < C::KC; ++c) tqmm::mma_k32(ps, pa[c], ones);
      const float vp_lo = f.s.v_sh * i2f(ps[0]);
      const float vp_hi = f.s.v_sh * i2f(ps[2]);
#pragma unroll
      for (int ni = 0; ni < C::ND; ++ni) {
        int a2[4] = {0, 0, 0, 0};
        const int8_t* row = vti + (ni * 8 + g) * C::LDV;
#pragma unroll
        for (int c = 0; c < C::KC; ++c) {
          const unsigned vb[2] = {
              *reinterpret_cast<const uint32_t*>(row + vt_pos<T>(c, 0, t)),
              *reinterpret_cast<const uint32_t*>(row + vt_pos<T>(c, 1, t))};
          tqmm::mma_k32(a2, pa[c], vb);
        }
        const float2 pv =
            *reinterpret_cast<const float2*>(pvi + ni * 8 + 2 * t);
        float ctx[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          ctx[r] = ((i2f(a2[r]) + ((r & 1) ? pv.y : pv.x)) +
                    (r < 2 ? vp_lo : vp_hi)) +
                   f.s.tpv;
        store_ctx2(out, orow + ni * 8 + 2 * t, ctx[0], ctx[1], f);
        store_ctx2(out, orow + o8 + ni * 8 + 2 * t, ctx[2], ctx[3], f);
      }
    } else {
      // the float probs (PV_LVL: the shifted levels; PV_F64: e / sum)
      const float id_lo = 1.0f / dlo, id_hi = 1.0f / dhi;
#pragma unroll
      for (int ni = 0; ni < C::NT; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          sv[ni][r] = probs_of(sv[ni][r], r < 2 ? w_lo : w_hi,
                               r < 2 ? id_lo : id_hi, f);
      if (PV == PV_LVL && exact) {
        // U = L - lo_b in two byte planes, on mma.sync u8 x s8
        const int lo_b = static_cast<int>(f.p_lo);
        unsigned plo[C::KC][4], phi[C::KC][4];
#pragma unroll
        for (int c = 0; c < C::KC; ++c) {
          uint32_t u[4][4];
#pragma unroll
          for (int nn = 0; nn < 4; ++nn)
#pragma unroll
            for (int r = 0; r < 4; ++r)
              u[nn][r] = static_cast<uint32_t>(
                  __float2int_rn(sv[4 * c + nn][r] - f.p_lo));
          plo[c][0] = pack4(u[0][0], u[0][1], u[1][0], u[1][1]);
          plo[c][1] = pack4(u[0][2], u[0][3], u[1][2], u[1][3]);
          plo[c][2] = pack4(u[2][0], u[2][1], u[3][0], u[3][1]);
          plo[c][3] = pack4(u[2][2], u[2][3], u[3][2], u[3][3]);
          phi[c][0] = pack4(u[0][0] >> 8, u[0][1] >> 8, u[1][0] >> 8,
                            u[1][1] >> 8);
          phi[c][1] = pack4(u[0][2] >> 8, u[0][3] >> 8, u[1][2] >> 8,
                            u[1][3] >> 8);
          phi[c][2] = pack4(u[2][0] >> 8, u[2][1] >> 8, u[3][0] >> 8,
                            u[3][1] >> 8);
          phi[c][3] = pack4(u[2][2] >> 8, u[2][3] >> 8, u[3][2] >> 8,
                            u[3][3] >> 8);
        }
        const unsigned ones[2] = {ONES, ONES};
        int s_lo[4] = {0, 0, 0, 0}, s_hi[4] = {0, 0, 0, 0};
#pragma unroll
        for (int c = 0; c < C::KC; ++c) {
          tqdm::mma_k32_u8(s_lo, plo[c], ones);
          tqdm::mma_k32_u8(s_hi, phi[c], ones);
        }
        const int v_sh = static_cast<int>(f.s.v_sh);
        // sum L of rows g, g + 8
        const long long sl_lo = s_lo[0] + 256LL * s_hi[0] +
                                static_cast<long long>(T) * lo_b;
        const long long sl_hi = s_lo[2] + 256LL * s_hi[2] +
                                static_cast<long long>(T) * lo_b;
#pragma unroll
        for (int ni = 0; ni < C::ND; ++ni) {
          int a_lo[4] = {0, 0, 0, 0}, a_hi[4] = {0, 0, 0, 0};
          const int8_t* row = vti + (ni * 8 + g) * C::LDV;
#pragma unroll
          for (int c = 0; c < C::KC; ++c) {
            const unsigned vb[2] = {
                *reinterpret_cast<const uint32_t*>(row + vt_pos<T>(c, 0, t)),
                *reinterpret_cast<const uint32_t*>(row + vt_pos<T>(c, 1, t))};
            tqdm::mma_k32_u8(a_lo, plo[c], vb);
            tqdm::mma_k32_u8(a_hi, phi[c], vb);
          }
          // vsum of dims 8 ni + 2t, +1 (prep's, an exact float)
          const float2 vs =
              *reinterpret_cast<const float2*>(pvi + ni * 8 + 2 * t);
          const long long vsum[2] = {__float2ll_rn(vs.x),
                                     __float2ll_rn(vs.y)};
          float ctx[4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            ctx[r] = __ll2float_rn(a_lo[r] + 256LL * a_hi[r] +
                                   lo_b * vsum[r & 1] +
                                   v_sh * (r < 2 ? sl_lo : sl_hi));
          store_ctx2(out, orow + ni * 8 + 2 * t, ctx[0], ctx[1], f);
          store_ctx2(out, orow + o8 + ni * 8 + 2 * t, ctx[2], ctx[3], f);
        }
        continue;
      }
      // p.v on the float64 tensor cores: b = v8 + v_sh as float32, as the
      // plain version adds them, then float64
      const float v_sh = f.s.v_sh;
      pv_f64<T, D, NDG>(
          sv,
          [&](int nd, int q16, double (&bb)[4]) {
            const uint32_t word = *reinterpret_cast<const uint32_t*>(
                vti + (nd * 8 + g) * C::LDV + vt_pos<T>(q16 >> 1, q16 & 1, t));
#pragma unroll
            for (int s = 0; s < 4; ++s)
              bb[s] = static_cast<double>(
                  tqmm::i8_to_float(static_cast<int8_t>(word >> (8 * s))) +
                  v_sh);
          },
          [&](int nd, const float (&ctx)[4]) {
            store_ctx2(out, orow + nd * 8 + 2 * t, ctx[0], ctx[1], f);
            store_ctx2(out, orow + o8 + nd * 8 + 2 * t, ctx[2], ctx[3], f);
          });
    }
  }
}

// The float route's stage: one group (G items) of q, k and v as float32,
// q and k in rows of D floats (16-byte chunks swapped in odd rows: qoff),
// v in rows of D + 4 (its column reads meet no bank twice), and the items'
// mask rows
template <int T, int D>
struct QCfg {
  static constexpr int G = ROWS / T;
  static constexpr int LV = D + 4;             // v rows (floats)
  static constexpr int QB = ROWS * D * 4;      // the q or k tile's bytes
  static constexpr int VB = ROWS * LV * 4;     // the v tile's bytes
  static constexpr int STAGE = 2 * QB + VB + ROWS * 4;
  static constexpr int SMEM = 2 * STAGE;
};

// byte offset of 16-byte chunk c of row r in a q or k tile: chunks c and
// c ^ 4 trade places in odd rows, so that the eight rows of a fragment
// load meet no bank twice
template <int D>
__device__ __forceinline__ int qoff(int r, int c) {
  return r * D * 4 + ((c ^ ((r & 1) << 2)) << 4);
}

template <int T, int D>
__global__ void __launch_bounds__(THREADS, F32_BLOCKS)
    attn_flex_f32_kernel(const float* __restrict__ qkv,
                         const float* __restrict__ mask,
                         const float* __restrict__ scal,
                         void* __restrict__ out, int n_items, int n_heads,
                         int hidden, float rsqrt_d, float log2e,
                         int skip_max, int sc_bits, int p_bits, int c_bits) {
  using Q = QCfg<T, D>;
  constexpr int NT = T / 8;
  constexpr int CH = D / 4;                  // 16-byte chunks a row
  extern __shared__ __align__(16) uint8_t fsm[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_groups = (n_items + Q::G - 1) / Q::G;
  const int ld = 3 * hidden;
  const FSite f = fsite_of<T, D>(scal, rsqrt_d, log2e, sc_bits, p_bits,
                                 c_bits, false);

  // every thread's cp.async share of group grp into stage st: q, k and v
  // rows of the group's items (row i*T + j: key j of item i), then their
  // mask rows; one commit group
  auto load = [&](int grp, int st) {
    uint8_t* qs = fsm + st * Q::STAGE;
    uint8_t* ks = qs + Q::QB;
    float* vs = reinterpret_cast<float*>(ks + Q::QB);
    float* ms = vs + ROWS * Q::LV;
    const int first = grp * Q::G;
    const int nv = min(Q::G, n_items - first);
    for (int e = tid; e < nv * T * CH; e += THREADS) {
      const int r = e / CH, c = e - r * CH;
      const int item = first + r / T, j = r % T;
      const int b = item / n_heads, h = item - b * n_heads;
      const float* src = qkv + static_cast<size_t>(b * T + j) * ld + h * D +
                         4 * c;
      tqdm::cp16(qs + qoff<D>(r, c), src, true);
      tqdm::cp16(ks + qoff<D>(r, c), src + hidden, true);
      tqdm::cp16(vs + r * Q::LV + 4 * c, src + 2 * hidden, true);
    }
    for (int e = tid; e < nv * T / 4; e += THREADS) {
      const int item = first + 4 * e / T;
      tqdm::cp16(ms + 4 * e,
                 mask + static_cast<size_t>(item / n_heads) * T + 4 * e % T,
                 true);
    }
    tqdm::cp_commit();
  };

  const int g = lane >> 2, t = lane & 3;
  const int slot = warp / (T / 16);
  const int q0 = slot * T + (warp % (T / 16)) * 16, k0 = slot * T;
  if (blockIdx.x < n_groups) load(blockIdx.x, 0);
  int n = 0;
  for (int grp = blockIdx.x; grp < n_groups; grp += gridDim.x, ++n) {
    // the next group's loads go out under this one's products; its stage
    // was read by the group before, which every warp is done with
    if (grp + gridDim.x < n_groups)
      load(grp + gridDim.x, (n + 1) & 1);
    else
      tqdm::cp_commit();
    tqdm::cp_wait<1>();
    __syncthreads();
    const uint8_t* qs = fsm + (n & 1) * Q::STAGE;
    const uint8_t* ks = qs + Q::QB;
    const float* vs = reinterpret_cast<const float*>(ks + Q::QB);
    const float* ms = vs + ROWS * Q::LV;
    const int item = grp * Q::G + slot;
    if (item < n_items) {
      const int b = item / n_heads, hd = item - b * n_heads;
      // q.k: KCH key n8 tiles a pass, the head dims 16 at a time (dims 16
      // kb + 4t + s as the fragments' k positions t + 4s)
      float sv[NT][4];
#pragma unroll
      for (int kc = 0; kc < NT; kc += KCH) {
        double acc[KCH][4];
#pragma unroll
        for (int j = 0; j < KCH; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[j][i] = 0.0;
#pragma unroll
        for (int kb = 0; kb < D / 16; ++kb) {
          const float4 lo4 = *reinterpret_cast<const float4*>(
              qs + qoff<D>(q0 + g, 4 * kb + t));
          const float4 hi4 = *reinterpret_cast<const float4*>(
              qs + qoff<D>(q0 + g + 8, 4 * kb + t));
          const double a[8] = {lo4.x, hi4.x, lo4.y, hi4.y,
                               lo4.z, hi4.z, lo4.w, hi4.w};
#pragma unroll
          for (int j = 0; j < KCH; ++j) {
            const float4 kv = *reinterpret_cast<const float4*>(
                ks + qoff<D>(k0 + (kc + j) * 8 + g, 4 * kb + t));
            const double bb[4] = {kv.x, kv.y, kv.z, kv.w};
            tqdm::dmma16<KS_F>(acc[j], a, bb);
          }
        }
#pragma unroll
        for (int j = 0; j < KCH; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float ml =
                ms[k0 + (kc + j) * 8 + 2 * t + (r & 1)] * log2e;
            sv[kc + j][r] = s2_of(__double2float_rn(acc[j][r]),
                                  sc_bits ? ml + f.s.ash : ml, f);
          }
      }
      float dlo, dhi;
      if (skip_max)
        flex_softmax<NT, true>(sv, dlo, dhi);
      else
        flex_softmax<NT, false>(sv, dlo, dhi);
      const float w_lo = f.s.inv_ps / dlo, w_hi = f.s.inv_ps / dhi;
      const float id_lo = 1.0f / dlo, id_hi = 1.0f / dhi;
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          sv[ni][r] = probs_of(sv[ni][r], r < 2 ? w_lo : w_hi,
                               r < 2 ? id_lo : id_hi, f);
      const size_t orow =
          static_cast<size_t>(b * T + (q0 - slot * T) + g) * hidden + hd * D;
      const size_t o8 = static_cast<size_t>(8) * hidden;
      const float* vb = vs + k0 * Q::LV;
      const float v_sh = f.s.v_sh;
      // b = v + v_sh, a float32 add as the plain version's, then float64
      pv_f64<T, D, D / 8>(
          sv,
          [&](int nd, int q16, double (&bb)[4]) {
            const float* col = vb + 16 * q16 * Q::LV + nd * 8 + g;
            bb[0] = col[(2 * t) * Q::LV] + v_sh;
            bb[1] = col[(2 * t + 1) * Q::LV] + v_sh;
            bb[2] = col[(2 * t + 8) * Q::LV] + v_sh;
            bb[3] = col[(2 * t + 9) * Q::LV] + v_sh;
          },
          [&](int nd, const float (&ctx)[4]) {
            store_ctx2(out, orow + nd * 8 + 2 * t, ctx[0], ctx[1], f);
            store_ctx2(out, orow + o8 + nd * 8 + 2 * t, ctx[2], ctx[3], f);
          });
    }
    __syncthreads();   // every warp is done with this stage
  }
  tqdm::cp_wait<0>();
}

// resident blocks an SM of an instance at `smem` bytes (its allowance
// set), or -1
template <typename K>
int flex_blocks(K kernel, int smem) {
  int n = 0;
  if (cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, THREADS,
                                                    smem) != cudaSuccess)
    return -1;
  return n;
}

// The integer route: K2's tensor maps over the fused q|k|v payload
// (column blocks 0, 1, 2 at a row stride of 3 hidden bytes) and the mask;
// one persistent block a group, at most the card's resident blocks.
template <int T, int D, int PV>
cudaError_t launch_flex_i8(const void* qkv, const void* mask,
                           const float* scal, void* out, int B, int hidden,
                           int n_heads, int sc_bits, int p_bits, int c_bits,
                           float rsqrt_d, float log2e, int skip_max,
                           cudaStream_t stream) {
  constexpr int smem = FCfg<T, D>::SMEM;
  static const int slots = [] {
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return 0;
    const int per_sm = flex_blocks(attn_flex_i8_kernel<T, D, PV>, smem);
    return per_sm > 0 ? sms * per_sm : 0;
  }();
  if (slots == 0) return cudaErrorInvalidConfiguration;
  const CUtensorMapSwizzle swz =
      D == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
  const uint64_t rows = static_cast<uint64_t>(B) * T;
  const uint64_t ld = 3ull * hidden;
  const int8_t* base = static_cast<const int8_t*>(qkv);
  CUtensorMap mq, mk, mv, mm;
  if (!make_map(&mq, base, false, hidden, rows, ld, D, T, swz) ||
      !make_map(&mk, base + hidden, false, hidden, rows, ld, D, T, swz) ||
      !make_map(&mv, base + 2 * hidden, false, hidden, rows, ld, D, T,
                swz) ||
      !make_map(&mm, mask, true, T, B, 4ull * T, T, 1,
                CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  const int n_items = B * n_heads;
  const int groups = (n_items + Cfg<T, D>::G - 1) / Cfg<T, D>::G;
  const int grid = groups < slots ? groups : slots;
  attn_flex_i8_kernel<T, D, PV><<<grid, THREADS, smem, stream>>>(
      mq, mk, mv, mm, scal, out, n_items, n_heads, hidden, rsqrt_d, log2e,
      skip_max, sc_bits, p_bits, c_bits);
  return cudaGetLastError();
}

// The float route: persistent blocks, one an SM (at most the groups)
template <int T, int D>
cudaError_t launch_flex_f32(const void* qkv, const void* mask,
                            const float* scal, void* out, int B, int hidden,
                            int n_heads, int sc_bits, int p_bits,
                            int c_bits, float rsqrt_d, float log2e,
                            int skip_max, cudaStream_t stream) {
  using Q = QCfg<T, D>;
  static const int slots = [] {
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return 0;
    const int per_sm = flex_blocks(attn_flex_f32_kernel<T, D>, Q::SMEM);
    return per_sm > 0 ? sms * per_sm : 0;
  }();
  if (slots == 0) return cudaErrorInvalidConfiguration;
  const int n_items = B * n_heads;
  const int groups = (n_items + Q::G - 1) / Q::G;
  attn_flex_f32_kernel<T, D><<<groups < slots ? groups : slots, THREADS,
                               Q::SMEM, stream>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(mask), scal,
      out, n_items, n_heads, hidden, rsqrt_d, log2e, skip_max, sc_bits,
      p_bits, c_bits);
  return cudaGetLastError();
}

template <int T, int D>
cudaError_t launch_flex(int f32, const void* qkv, const void* mask,
                        const float* scal, void* out, int B, int hidden,
                        int n_heads, int sc_bits, int p_bits, int c_bits,
                        float rsqrt_d, float log2e, int skip_max,
                        cudaStream_t st) {
  if (f32)
    return launch_flex_f32<T, D>(qkv, mask, scal, out, B, hidden, n_heads,
                                 sc_bits, p_bits, c_bits, rsqrt_d, log2e,
                                 skip_max, st);
  if (p_bits == 0)
    return launch_flex_i8<T, D, PV_F64>(qkv, mask, scal, out, B, hidden,
                                        n_heads, sc_bits, p_bits, c_bits,
                                        rsqrt_d, log2e, skip_max, st);
  if (p_bits <= 8)
    return launch_flex_i8<T, D, PV_PAY>(qkv, mask, scal, out, B, hidden,
                                        n_heads, sc_bits, p_bits, c_bits,
                                        rsqrt_d, log2e, skip_max, st);
  return launch_flex_i8<T, D, PV_LVL>(qkv, mask, scal, out, B, hidden,
                                      n_heads, sc_bits, p_bits, c_bits,
                                      rsqrt_d, log2e, skip_max, st);
}

}  // namespace

// qkv: the (B*T, 3 hidden) fused q|k|v edge, int8 payloads (f32 0) or
// float32 values (f32 1), heads head-minor inside each third, 16-byte
// aligned; mask: (B, T) f32 additive bias, 16-byte aligned; scal: 12 f32
// site scalars; out: (B*T, hidden), int8 for a context site of 1-8 bits,
// else f32, 16-byte aligned. sc_bits / p_bits / c_bits: 1-16, or 0 for a
// disabled site. T in {32, 64, 128}, head_dim = hidden / n_heads in {32,
// 64}. The route: float32 values take the float64 one; payloads the
// integer one, with p.v on the float64 tensor cores where the probs site
// is disabled. Returns the launch's cudaError_t (cudaErrorInvalidValue for
// arguments the kernel does not take, or a tensor map that cannot be
// encoded).
extern "C" int tq_int8_attention_flex(const void* qkv, int f32,
                                      const void* mask, const void* scal,
                                      void* out, int B, int T, int hidden,
                                      int n_heads, int sc_bits, int p_bits,
                                      int c_bits, float rsqrt_d, float log2e,
                                      int skip_max, void* stream) {
  if (B <= 0 || n_heads <= 0 || hidden % n_heads || sc_bits < 0 ||
      sc_bits > 16 || p_bits < 0 || p_bits > 16 || c_bits < 0 ||
      c_bits > 16 ||
      ((reinterpret_cast<uintptr_t>(qkv) | reinterpret_cast<uintptr_t>(mask) |
        reinterpret_cast<uintptr_t>(out)) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  const int D = hidden / n_heads;
  const float* s = static_cast<const float*>(scal);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D * 1000 + T) {
    case 32032: return static_cast<int>(launch_flex<32, 32>(f32, qkv, mask, s, out, B, hidden, n_heads, sc_bits, p_bits, c_bits, rsqrt_d, log2e, skip_max, st));
    case 32064: return static_cast<int>(launch_flex<64, 32>(f32, qkv, mask, s, out, B, hidden, n_heads, sc_bits, p_bits, c_bits, rsqrt_d, log2e, skip_max, st));
    case 32128: return static_cast<int>(launch_flex<128, 32>(f32, qkv, mask, s, out, B, hidden, n_heads, sc_bits, p_bits, c_bits, rsqrt_d, log2e, skip_max, st));
    case 64032: return static_cast<int>(launch_flex<32, 64>(f32, qkv, mask, s, out, B, hidden, n_heads, sc_bits, p_bits, c_bits, rsqrt_d, log2e, skip_max, st));
    case 64064: return static_cast<int>(launch_flex<64, 64>(f32, qkv, mask, s, out, B, hidden, n_heads, sc_bits, p_bits, c_bits, rsqrt_d, log2e, skip_max, st));
    case 64128: return static_cast<int>(launch_flex<128, 64>(f32, qkv, mask, s, out, B, hidden, n_heads, sc_bits, p_bits, c_bits, rsqrt_d, log2e, skip_max, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Resident blocks an SM of each flex instance at (T, head_dim): route 0
// integer (PV_LVL, the widest), 1 float; -1 for shapes it does not take or
// a failed query
extern "C" int tq_int8_attention_flex_blocks(int T, int D, int route) {
  switch ((D * 1000 + T) * 2 + (route != 0)) {
#define TQ_FB(t, d)                                                          \
  case (d * 1000 + t) * 2:                                                   \
    return flex_blocks(attn_flex_i8_kernel<t, d, PV_LVL>, FCfg<t, d>::SMEM); \
  case (d * 1000 + t) * 2 + 1:                                               \
    return flex_blocks(attn_flex_f32_kernel<t, d>, QCfg<t, d>::SMEM);
    TQ_FB(32, 32) TQ_FB(64, 32) TQ_FB(128, 32)
    TQ_FB(32, 64) TQ_FB(64, 64) TQ_FB(128, 64)
#undef TQ_FB
    default: return -1;
  }
}
