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
// The attention's other forms (attn_flex_kernel)
//
// Replaces the same TPU function for every form but the all-8-bit payload
// one above: _attn_row with a scores site of 2-16 bits or disabled (bits
// 0: s2 = q_s k_s rsqrt(d) log2e * scores + mask log2e), a probs site of
// 9-16 bits (shifted float levels) or disabled (the raw softmax), a
// context site of 9-16 bits or disabled (a float32 value edge out,
// _emit_ctx), sub-8-bit sites, and the value-space form of float32 q / k /
// v values with identity site scalars (int8_attention_ref(dots='f32'),
// the engine's 16-bit / sub-8 / per-column q / k / v sites).
//
//   scores = q . k   (payloads: + q_sh*ksum + k_sh*qsum + d*q_sh*k_sh)
//   s2     = the scores site as above, or its disabled form
//   e      = exp2(s2 [- rowmax]), sum in double rounded once
//   probs  = the probs site's payload, shifted levels or e / sum
//   ctx    = probs . v (a payload probs site on payloads: the integer sum
//            + p_sh*vsum + v_sh*psum + T*p_sh*v_sh; else probs . (v +
//            v_sh))
//   out    = the context site: a payload, or float values (_emit_ctx)
//
// What bounds it on the card: operations, the float dots. At BERT-base
// (B = 128, T = 128, 12 heads of 64) q.k and p.v are 6.4 GFLOP: 0.10 ms at
// the 67 TFLOP/s float64 (tensor-core) peak, against 50-150 MB of traffic
// (15-45 us: int8 or float32 q / k / v, an int8 or float32 context).
//
// Design (a simple first form): a block of 256 threads a (batch row,
// head) and 64 of its query rows (T = 32: all 32); q^T, k^T, the scores
// and probs and then v are staged in shared memory as float64 (166 KB at
// T = 128, D = 64: one block an SM), both products on the float64 FMA
// units with register tiles of 4 x 8 (scores) and 4 x 4 (context) sums a
// thread, the softmax a warp a row. Every element of q, k, v and the
// probs is exact in float64 and so is every product: the integer forms'
// sums (|q.k| < 2^21, |p.v| < 2^31) are exact, and the float forms' are
// the exact sums' roundings but where the float64 sum's own rounding meets
// a float32 tie. Then each step in int8_attention_ref's float32 order
// (-fmad=false, exp2f, the IEEE divisions), bit-identical to it but on
// such ties; a payload level off the integers truncates as its cast does.
// A tensor-core (DMMA or split-bf16 wgmma) redesign is later work.
// ---------------------------------------------------------------------------

namespace {

constexpr int FT = 256;   // threads of a flex block

template <int T, int D>
struct FCfg {
  static constexpr int QR = T < 64 ? T : 64;   // query rows a block
  static constexpr int SPLIT = T / QR;         // blocks a (row, head) item
  static constexpr int LQ = QR + 1;            // q^T row stride (doubles)
  static constexpr int LK = T + 1;             // k^T row stride
  static constexpr int LV = D + 1;             // v row stride
  static constexpr int LP = T + 1;             // probs row stride
  static constexpr int KV = D * LK > T * LV ? D * LK : T * LV;
  static constexpr int RI = QR / 16;           // rows a thread
  static constexpr int CJ = T / 16;            // keys a thread (scores)
  static constexpr int CD = D / 16;            // head dims a thread (p.v)
  // doubles: q^T, k^T then v, the probs; floats: qsum, ksum, the keys'
  // mask terms, psum, vsum
  static constexpr int SMEM =
      8 * (D * LQ + KV + QR * LP) + 4 * (QR + T + T + QR + D);
};

__device__ __forceinline__ float clipf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

template <int T, int D, bool QF>
__global__ void __launch_bounds__(FT, 1)
    attn_flex_kernel(const void* __restrict__ qkv,
                     const float* __restrict__ mask,
                     const float* __restrict__ scal, void* __restrict__ out,
                     int hidden, int n_heads, int sc_bits, int p_bits,
                     int c_bits, float rsqrt_d, float log2e, int skip_max) {
  using C = FCfg<T, D>;
  extern __shared__ double fsm[];
  double* qT = fsm;                    // [D][LQ]
  double* kv = qT + D * C::LQ;         // k^T [D][LK], then v [T][LV]
  double* P = kv + C::KV;              // [QR][LP]
  float* qsum = reinterpret_cast<float*>(P + C::QR * C::LP);
  float* ksum = qsum + C::QR;
  float* mk = ksum + T;                // a key's mask term
  float* psum = mk + T;
  float* vsum = psum + C::QR;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int ty = t >> 4, tx = t & 15;
  const int item = blockIdx.x / C::SPLIT;
  const int i0 = (blockIdx.x % C::SPLIT) * C::QR;   // first query row
  const int b = item / n_heads, h = item - b * n_heads;
  const int ld = 3 * hidden;
  const size_t row0 = static_cast<size_t>(b) * T;
  const int8_t* q8 = static_cast<const int8_t*>(qkv);
  const float* qf = static_cast<const float*>(qkv);
  auto at = [&](size_t row, int col) -> float {
    const size_t i = row * ld + col;
    return QF ? qf[i] : static_cast<float>(q8[i]);
  };
  const float q_s = scal[0], q_sh = scal[1], k_s = scal[2], k_sh = scal[3];
  const float v_s = scal[4], v_sh = scal[5], sc_s = scal[6], sc_sh = scal[7];
  const float p_s = scal[8], p_sh = scal[9], c_s = scal[10], c_sh = scal[11];
  // a payload probs site on payloads: the integer p.v and its corrections
  const bool int_pv = !QF && p_bits >= 1 && p_bits <= 8;

  // q^T and k^T (and the payloads' row sums), the keys' mask terms
  for (int e = t; e < C::QR * D; e += FT) {
    const int r = e / D, d = e - r * D;
    qT[d * C::LQ + r] = at(row0 + i0 + r, h * D + d);
  }
  for (int e = t; e < T * D; e += FT) {
    const int j = e / D, d = e - j * D;
    kv[d * C::LK + j] = at(row0 + j, hidden + h * D + d);
  }
  const float a = (sc_s * rsqrt_d) * log2e;
  for (int j = t; j < T; j += FT) {
    const float ml = mask[row0 + j] * log2e;
    mk[j] = sc_bits ? ml + a * sc_sh : ml;
  }
  __syncthreads();
  if (!QF) {
    for (int r = t; r < C::QR; r += FT) {
      float s = 0.0f;
      for (int d = 0; d < D; ++d) s += static_cast<float>(qT[d * C::LQ + r]);
      qsum[r] = s;
    }
    for (int j = t; j < T; j += FT) {
      float s = 0.0f;
      for (int d = 0; d < D; ++d) s += static_cast<float>(kv[d * C::LK + j]);
      ksum[j] = s;
    }
    __syncthreads();
  }

  // scores -> s2 into P
  {
    double acc[C::RI][C::CJ];
#pragma unroll
    for (int i = 0; i < C::RI; ++i)
#pragma unroll
      for (int j = 0; j < C::CJ; ++j) acc[i][j] = 0.0;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      double x[C::RI], y[C::CJ];
#pragma unroll
      for (int i = 0; i < C::RI; ++i) x[i] = qT[d * C::LQ + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < C::CJ; ++j) y[j] = kv[d * C::LK + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < C::RI; ++i)
#pragma unroll
        for (int j = 0; j < C::CJ; ++j)
          acc[i][j] = __fma_rn(x[i], y[j], acc[i][j]);
    }
    const float qk_over_sc = (q_s * k_s) * (1.0f / sc_s);
    const float coef = ((q_s * k_s) * rsqrt_d) * log2e;   // scores off
    const float dqk = (static_cast<float>(D) * q_sh) * k_sh;
    const float half_sc = sc_bits ? static_cast<float>(1 << (sc_bits - 1))
                                  : 0.0f;
#pragma unroll
    for (int i = 0; i < C::RI; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < C::CJ; ++j) {
        const int k = tx + 16 * j;
        float scr = __double2float_rn(acc[i][j]);
        if (!QF) scr = ((scr + q_sh * ksum[k]) + k_sh * qsum[r]) + dqk;
        float s2;
        if (sc_bits == 0) {
          s2 = coef * scr + mk[k];
        } else {
          const float lvl =
              clipf(rintf(scr * qk_over_sc) - sc_sh, -half_sc, half_sc - 1.0f);
          s2 = a * lvl + mk[k];
        }
        P[r * C::LP + k] = s2;
      }
    }
  }
  __syncthreads();

  // the softmax and the probs site, a warp a row; then v into the k^T
  // buffer (no longer read)
  {
    const float inv_ps = 1.0f / p_s;
    const float half_p = p_bits ? static_cast<float>(1 << (p_bits - 1)) : 0.0f;
    for (int r = warp; r < C::QR; r += FT / 32) {
      double* pr = P + r * C::LP;
      float s2[T / 32];
      float m = __int_as_float(0xff800000);   // -inf
#pragma unroll
      for (int u = 0; u < T / 32; ++u) {
        s2[u] = static_cast<float>(pr[lane + 32 * u]);
        m = fmaxf(m, s2[u]);
      }
#pragma unroll
      for (int o = 16; o >= 1; o >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      double den = 0.0;
#pragma unroll
      for (int u = 0; u < T / 32; ++u) {
        s2[u] = skip_max ? exp2f(s2[u]) : exp2f(s2[u] - m);
        den += static_cast<double>(s2[u]);
      }
#pragma unroll
      for (int o = 16; o >= 1; o >>= 1)
        den += __shfl_xor_sync(0xffffffffu, den, o);
      const float dn = static_cast<float>(den);
      const float w = inv_ps / dn;
      const float inv_den = 1.0f / dn;
      float ps = 0.0f;
#pragma unroll
      for (int u = 0; u < T / 32; ++u) {
        const float e = s2[u];
        float p;
        if (p_bits == 0) {
          p = e * inv_den;
        } else if (p_bits > 8) {
          p = clipf(rintf(e * w), p_sh - half_p, p_sh + half_p - 1.0f);
        } else if (int_pv) {
          // the int8 payload, a level off the integers truncated as the
          // plain version's cast does
          p = truncf(clipf(rintf(e * w) - p_sh, -half_p, half_p - 1.0f));
          ps += p;
        } else {
          p = clipf(rintf(e * w), p_sh + -half_p, p_sh + (half_p - 1.0f));
        }
        pr[lane + 32 * u] = p;
      }
      if (int_pv) {
#pragma unroll
        for (int o = 16; o >= 1; o >>= 1)
          ps += __shfl_xor_sync(0xffffffffu, ps, o);
        if (lane == 0) psum[r] = ps;
      }
    }
  }
  __syncthreads();   // the scores phase is done with k^T
  for (int e = t; e < T * D; e += FT) {
    const int j = e / D, d = e - j * D;
    const float v = at(row0 + j, 2 * hidden + h * D + d);
    kv[j * C::LV + d] = int_pv ? v : v + v_sh;
  }
  __syncthreads();
  if (int_pv) {
    for (int d = t; d < D; d += FT) {
      float s = 0.0f;
      for (int j = 0; j < T; ++j) s += static_cast<float>(kv[j * C::LV + d]);
      vsum[d] = s;
    }
    __syncthreads();
  }

  // the context and its site
  double acc[C::RI][C::CD];
#pragma unroll
  for (int i = 0; i < C::RI; ++i)
#pragma unroll
    for (int j = 0; j < C::CD; ++j) acc[i][j] = 0.0;
#pragma unroll 4
  for (int k = 0; k < T; ++k) {
    double x[C::RI], y[C::CD];
#pragma unroll
    for (int i = 0; i < C::RI; ++i) x[i] = P[(ty + 16 * i) * C::LP + k];
#pragma unroll
    for (int j = 0; j < C::CD; ++j) y[j] = kv[k * C::LV + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < C::RI; ++i)
#pragma unroll
      for (int j = 0; j < C::CD; ++j)
        acc[i][j] = __fma_rn(x[i], y[j], acc[i][j]);
  }
  const float pv_over_c = (p_s * v_s) * (1.0f / c_s);
  const float tpv = (static_cast<float>(T) * p_sh) * v_sh;
  const float half_c = c_bits ? static_cast<float>(1 << (c_bits - 1)) : 0.0f;
#pragma unroll
  for (int i = 0; i < C::RI; ++i) {
    const int r = ty + 16 * i;
    const size_t orow = (row0 + i0 + r) * static_cast<size_t>(hidden);
#pragma unroll
    for (int j = 0; j < C::CD; ++j) {
      const int d = tx + 16 * j;
      float ctx = __double2float_rn(acc[i][j]);
      if (int_pv) ctx = ((ctx + p_sh * vsum[d]) + v_sh * psum[r]) + tpv;
      const float x = ctx * pv_over_c;
      const size_t o = orow + h * D + d;
      if (c_bits == 0) {
        static_cast<float*>(out)[o] = x;
      } else if (c_bits > 8) {
        static_cast<float*>(out)[o] =
            c_s * clipf(rintf(x), c_sh - half_c, c_sh + half_c - 1.0f);
      } else {
        static_cast<int8_t*>(out)[o] = static_cast<int8_t>(__float2int_rz(
            clipf(rintf(x) - c_sh, -half_c, half_c - 1.0f)));
      }
    }
  }
}

template <int T, int D, bool QF>
cudaError_t launch_flex(const void* qkv, const float* mask,
                        const float* scal, void* out, int B, int hidden,
                        int n_heads, int sc_bits, int p_bits, int c_bits,
                        float rsqrt_d, float log2e, int skip_max,
                        cudaStream_t st) {
  using C = FCfg<T, D>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      attn_flex_kernel<T, D, QF>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return attr;
  const int blocks = B * n_heads * C::SPLIT;
  attn_flex_kernel<T, D, QF><<<blocks, FT, C::SMEM, st>>>(
      qkv, mask, scal, out, hidden, n_heads, sc_bits, p_bits, c_bits,
      rsqrt_d, log2e, skip_max);
  return cudaGetLastError();
}

template <bool QF>
cudaError_t launch_flex_td(int T, int D, const void* qkv, const float* mask,
                           const float* scal, void* out, int B, int hidden,
                           int n_heads, int sc_bits, int p_bits, int c_bits,
                           float rsqrt_d, float log2e, int skip_max,
                           cudaStream_t st) {
  switch (D * 1000 + T) {
    case 32032: return launch_flex<32, 32, QF>(qkv, mask, scal, out, B, hidden, n_heads, sc_bits, p_bits, c_bits, rsqrt_d, log2e, skip_max, st);
    case 32064: return launch_flex<64, 32, QF>(qkv, mask, scal, out, B, hidden, n_heads, sc_bits, p_bits, c_bits, rsqrt_d, log2e, skip_max, st);
    case 32128: return launch_flex<128, 32, QF>(qkv, mask, scal, out, B, hidden, n_heads, sc_bits, p_bits, c_bits, rsqrt_d, log2e, skip_max, st);
    case 64032: return launch_flex<32, 64, QF>(qkv, mask, scal, out, B, hidden, n_heads, sc_bits, p_bits, c_bits, rsqrt_d, log2e, skip_max, st);
    case 64064: return launch_flex<64, 64, QF>(qkv, mask, scal, out, B, hidden, n_heads, sc_bits, p_bits, c_bits, rsqrt_d, log2e, skip_max, st);
    case 64128: return launch_flex<128, 64, QF>(qkv, mask, scal, out, B, hidden, n_heads, sc_bits, p_bits, c_bits, rsqrt_d, log2e, skip_max, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// qkv: the (B*T, 3 hidden) fused q|k|v edge, int8 payloads (f32 0) or
// float32 values (f32 1), heads head-minor inside each third; mask: (B, T)
// f32 additive bias; scal: 12 f32 site scalars; out: (B*T, hidden), int8
// for a context site of 1-8 bits, else f32. sc_bits / p_bits / c_bits:
// 1-16, or 0 for a disabled site. T in {32, 64, 128}, head_dim = hidden /
// n_heads in {32, 64}. Returns the launch's cudaError_t
// (cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int tq_int8_attention_flex(const void* qkv, int f32,
                                      const void* mask, const void* scal,
                                      void* out, int B, int T, int hidden,
                                      int n_heads, int sc_bits, int p_bits,
                                      int c_bits, float rsqrt_d, float log2e,
                                      int skip_max, void* stream) {
  if (B <= 0 || n_heads <= 0 || hidden % n_heads || sc_bits < 0 ||
      sc_bits > 16 || p_bits < 0 || p_bits > 16 || c_bits < 0 || c_bits > 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int D = hidden / n_heads;
  const float* m = static_cast<const float*>(mask);
  const float* s = static_cast<const float*>(scal);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      f32 ? launch_flex_td<true>(T, D, qkv, m, s, out, B, hidden, n_heads,
                                 sc_bits, p_bits, c_bits, rsqrt_d, log2e,
                                 skip_max, st)
          : launch_flex_td<false>(T, D, qkv, m, s, out, B, hidden, n_heads,
                                  sc_bits, p_bits, c_bits, rsqrt_d, log2e,
                                  skip_max, st));
}
