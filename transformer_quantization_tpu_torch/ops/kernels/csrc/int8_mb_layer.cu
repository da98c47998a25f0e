// A whole MobileBERT encoder layer in one launch, one block per sequence.
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
// What bounds it on the card: operations. At MobileBERT-uncased widths
// (H = 512, bottleneck 128, intermediate 512, 4 heads of 32, S = 128) a
// layer is 27.4 GOP of int8 products plus 1.07 GOP of attention at B=128
// (14.4 us at 1,979 TOP/s) against 8.4 MB of h8 read and written once
// (5 us at 3.35 TB/s); the 835,584 weight bytes of a layer are read by
// every block, from L2.
//
// Design: a block owns one sequence (T = 128 rows, the matmul tile height)
// and keeps every intermediate payload in shared memory: h8 (T x H, held
// to the end as the bottleneck-out residual), li8 / x8 (T x 128, the FFN
// chain updates it in place: each element's residual is read by the
// thread that overwrites it, before it does), and one union that holds
// sh8 / c8, [q|k], v^T and the probs during attention and the T x I inter
// payload during the FFNs: 198 KB at these widths. Weights stream
// from global memory through a two-stage cp.async ring. Every matmul is
// K1's main loop (mm_tile with A resident in shared memory) with the K1
// emit or the K6 NoNorm epilogue, and the attention is attn_head, the
// same arithmetic as int8_matmul.cu, int8_matmul_norm.cu and
// int8_attention.cu, so the layer is bit-identical to the chain of those
// kernels.
//
// What the measurements showed (scripts/mb_layer_probe.py): the epilogue
// arithmetic over a layer's ~63M outputs, not the tensor-core loops, set
// the first version's time; its per-column constants are now loaded once
// per column, and its site divisions run as a multiply by the reciprocal
// with the true quotient taken, in an out-of-line call, only for the rare
// unsure element (rint_div).

#include "attn_common.cuh"
#include "mm_common.cuh"

namespace {

using namespace tqmm;

constexpr int MAX_FFN = 8;  // stacked FFNs a layer may have

struct Mm {
  const int8_t* w;
  const float* vecs;
  const float* scal;
};

struct Nrm {
  const float* gb;
  const float* scal;
};

struct Params {
  const int8_t* h8;
  const float* mask;
  const float* ascal;
  int8_t* out;
  Mm bn_in, bn_attn, qk, v, attn_out, out_bn;
  // [0, n_ffn): the stacked FFNs; [n_ffn]: the output FFN (inter, out)
  Mm inter[MAX_FFN + 1], dense[MAX_FFN + 1];
  Nrm n_bn_in, n_bn_attn, n_attn_out, n_out_bn, ffn_norm[MAX_FFN + 1];
  int res_ao, res_ffn_mask, res_obn;  // mask bit j: FFN j's res site
  int H, I, n_ffn, shared_kq, act, skip_max;
  float rsqrt_d, log2e, gelu_c;
};

// c (T x N, row stride ldc; transposed, N x T, when TRANS) = the emitted
// payload of act(a (T x K, lda) @ W^T), all in shared memory
template <int ACT, bool TRANS>
__device__ void mb_emit(const int8_t* a, int lda, const Mm& m, int N, int K,
                        int8_t* c, int ldc, int8_t* ring, float gelu_c) {
  const float in_s = m.scal[0];
  const float in_sh = m.scal[1];
  for (int n0 = 0; n0 < N; n0 += BN) {
    int acc[4][4][4];
    mm_tile<true>(a, lda, m.w, BM, N, K, 0, n0, nullptr, ring, acc);
    mm_epilogue(
        acc, 0, n0, BM, N,
        [&](int col) { return col_site(m.vecs, N, col, in_s, in_sh); },
        [&](int row, int col, int v, const ColSite& k) {
          const int8_t q = emit_out<ACT>(fold(v, k), k, gelu_c);
          if (TRANS) c[col * ldc + row] = q;
          else c[row * ldc + col] = q;
        });
  }
  __syncthreads();
}

__device__ void mb_emit_act(int act, const int8_t* a, int lda, const Mm& m,
                            int N, int K, int8_t* c, int ldc, int8_t* ring,
                            float gelu_c) {
  if (act == 2) mb_emit<2, false>(a, lda, m, N, K, c, ldc, ring, gelu_c);
  else if (act == 1) mb_emit<1, false>(a, lda, m, N, K, c, ldc, ring, gelu_c);
  else mb_emit<0, false>(a, lda, m, N, K, c, ldc, ring, gelu_c);
}

// c = the NoNorm payload of a @ W^T (+ the residual payload r, row stride
// ldr, when r is not null); c may be r (in place) and may lie in device
// memory
__device__ void mb_norm(const int8_t* a, int lda, const Mm& m, const Nrm& n,
                        int N, int K, const int8_t* r, int ldr, int res_quant,
                        int8_t* c, int ldc, int8_t* ring) {
  const float in_s = m.scal[0];
  const float in_sh = m.scal[1];
  const NoNorm p = nonorm_params(n.scal, res_quant);
  const bool has_res = r != nullptr;
  for (int n0 = 0; n0 < N; n0 += BN) {
    int acc[4][4][4];
    mm_tile<true>(a, lda, m.w, BM, N, K, 0, n0, nullptr, ring, acc);
    mm_epilogue(
        acc, 0, n0, BM, N,
        [&](int col) { return col_norm(m.vecs, n.gb, N, col, in_s, in_sh); },
        [&](int row, int col, int v, const ColNorm& k) {
          const int8_t rv = has_res ? r[row * ldr + col] : int8_t(0);
          c[(size_t)row * ldc + col] = nonorm_out(v, k, has_res, rv, p);
        });
  }
  __syncthreads();
}

// shared-memory layout (bytes), shared with the host-side size check
struct Layout {
  int lh, la, lqk, lvt, li, u;
  __host__ __device__ Layout(int T, int TH, int H, int I) {
    lh = H + 16;        // h8 row stride
    la = TH + 16;       // li8 / x8 and sh8 / c8 row stride
    lqk = 2 * TH + 16;  // [q | k] row stride
    lvt = T + 16;       // v^T and probs row stride
    li = I + 16;        // FFN inter payload row stride
    const int attn = T * la + T * lqk + TH * lvt + T * lvt;
    u = attn > T * li ? attn : T * li;
  }
  __host__ __device__ size_t bytes(int T, int D) const {
    return (size_t)T * lh + (size_t)T * la + u + 2 * BN * LDS +
           (size_t)(3 * T + D) * sizeof(float);
  }
};

template <int T, int D, int NH>
__global__ void __launch_bounds__(THREADS) mb_layer_kernel(const Params p) {
  static_assert(T == BM, "a block's rows are one sequence: T == 128");
  constexpr int TH = NH * D;
  extern __shared__ __align__(16) int8_t smem[];
  const Layout L(T, TH, p.H, p.I);
  int8_t* sh = smem;                 // h8: T x H
  int8_t* sa = sh + T * L.lh;        // li8, then x8: T x TH
  int8_t* su = sa + T * L.la;        // the union:
  int8_t* sb = su;                   //   sh8, then c8: T x TH
  int8_t* sqk = sb + T * L.la;       //   [q | k]: T x 2TH
  int8_t* svt = sqk + T * L.lqk;     //   v^T: TH x T
  int8_t* sp = svt + TH * L.lvt;     //   probs: T x T
  int8_t* si = su;                   //   or the FFN inter payload: T x I
  int8_t* ring = su + L.u;           // weight tiles: 2 x BN x LDS
  float* mask2 = reinterpret_cast<float*>(ring + 2 * BN * LDS);
  float* qsum = mask2 + T;
  float* ksum = qsum + T;
  float* vsum = ksum + T;

  const int b = blockIdx.x;
  const int H = p.H;
  const int8_t* hg = p.h8 + (size_t)b * T * H;
  const int ch = H / 16;
  for (int c = threadIdx.x; c < T * ch; c += THREADS) {
    const int row = c / ch;
    const int cc = c - row * ch;
    *reinterpret_cast<uint4*>(sh + row * L.lh + cc * 16) =
        *reinterpret_cast<const uint4*>(hg + (size_t)row * H + cc * 16);
  }
  tqattn::mask_row<T>(mask2, p.mask + (size_t)b * T, p.ascal, p.rsqrt_d,
                      p.log2e);
  __syncthreads();

  // bottleneck in, then the attention inputs
  mb_norm(sh, L.lh, p.bn_in, p.n_bn_in, TH, H, nullptr, 0, 0, sa, L.la, ring);
  const int8_t* qk_in = sa;
  const int8_t* v_in = sa;
  int v_k = TH, v_ld = L.la;
  if (p.shared_kq) {
    mb_norm(sh, L.lh, p.bn_attn, p.n_bn_attn, TH, H, nullptr, 0, 0, sb, L.la,
            ring);
    qk_in = sb;
    v_in = sh;
    v_k = H;
    v_ld = L.lh;
  }
  mb_emit<0, false>(qk_in, L.la, p.qk, 2 * TH, TH, sqk, L.lqk, ring, 0.0f);
  mb_emit<0, true>(v_in, v_ld, p.v, TH, v_k, svt, L.lvt, ring, 0.0f);

  // attention, one head after another; the context lands in sb
  for (int h = 0; h < NH; ++h) {
    tqattn::attn_head<T, D>(sqk + h * D, L.lqk, sqk + TH + h * D, L.lqk,
                            svt + h * D * L.lvt, L.lvt, sp, mask2, qsum, ksum,
                            vsum, p.ascal, p.rsqrt_d, p.log2e, p.skip_max,
                            sb + h * D, L.la);
    __syncthreads();
  }

  // attn_out + li8 -> x8 (in place over li8), then the FFNs
  mb_norm(sb, L.la, p.attn_out, p.n_attn_out, TH, TH, sa, L.la, p.res_ao, sa,
          L.la, ring);
  for (int j = 0; j <= p.n_ffn; ++j) {
    mb_emit_act(p.act, sa, L.la, p.inter[j], p.I, TH, si, L.li, ring,
                p.gelu_c);
    mb_norm(si, L.li, p.dense[j], p.ffn_norm[j], TH, p.I, sa, L.la,
            (p.res_ffn_mask >> j) & 1, sa, L.la, ring);
  }
  // bottleneck out + h8 -> the layer's output payload
  mb_norm(sa, L.la, p.out_bn, p.n_out_bn, H, TH, sh, L.lh, p.res_obn,
          p.out + (size_t)b * T * H, H, ring);
}

}  // namespace

// The layer plan `flat` in the canonical order of mb_layer_flat
// (engine_kernels.py): (w, vecs, scal) per matmul, (gb, scal) per NoNorm:
// bn_in, bn_in_norm, [bn_attn, bn_attn_norm when shared_kq], qk, v,
// attn_out, attn_out_norm, (inter, dense, norm) per stacked FFN, inter,
// out, out_norm, out_bn, out_bn_norm. h8 / out: (B*T, H) int8; mask: (B,
// T) f32; ascal: 12 f32 attention site scalars. res_ffn_mask bit j: FFN
// j's res site (bit n_ffn: out.res). act: 0 none, 1 gelu_new, 2 relu.
// Built for T = 128 and 4 heads of 32; H, I multiples of 64. Returns a
// cudaError_t (cudaErrorInvalidValue for a plan or shape it does not take).
extern "C" int tq_int8_mb_layer(const void* h8, const void* mask,
                                const void* ascal, const void* const* flat,
                                int n_flat, void* out, int B, int T, int H,
                                int TH, int I, int D, int n_ffn,
                                int shared_kq, int act, int skip_max,
                                int res_ao, int res_ffn_mask, int res_obn,
                                float rsqrt_d, float log2e, float gelu_c,
                                void* stream) {
  constexpr int kT = 128, kD = 32, kNH = 4;
  if (T != kT || D != kD || TH != kD * kNH || H % BK || I % BK ||
      n_ffn < 0 || n_ffn > MAX_FFN || act < 0 || act > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.h8 = static_cast<const int8_t*>(h8);
  p.mask = static_cast<const float*>(mask);
  p.ascal = static_cast<const float*>(ascal);
  p.out = static_cast<int8_t*>(out);
  int i = 0;
  auto mm = [&]() {
    Mm m{static_cast<const int8_t*>(flat[i]),
         static_cast<const float*>(flat[i + 1]),
         static_cast<const float*>(flat[i + 2])};
    i += 3;
    return m;
  };
  auto nrm = [&]() {
    Nrm n{static_cast<const float*>(flat[i]),
          static_cast<const float*>(flat[i + 1])};
    i += 2;
    return n;
  };
  // matmuls: bn_in, [bn_attn], qk, v, attn_out, 2 per FFN, inter, out,
  // out_bn; NoNorms: bn_in, [bn_attn], attn_out, 1 per FFN, out, out_bn
  const int want = 3 * (7 + shared_kq + 2 * n_ffn) + 2 * (4 + shared_kq +
                                                          n_ffn);
  if (n_flat != want) return static_cast<int>(cudaErrorInvalidValue);
  p.bn_in = mm();
  p.n_bn_in = nrm();
  if (shared_kq) {
    p.bn_attn = mm();
    p.n_bn_attn = nrm();
  }
  p.qk = mm();
  p.v = mm();
  p.attn_out = mm();
  p.n_attn_out = nrm();
  for (int j = 0; j <= n_ffn; ++j) {
    p.inter[j] = mm();
    p.dense[j] = mm();
    p.ffn_norm[j] = nrm();
  }
  p.out_bn = mm();
  p.n_out_bn = nrm();
  p.res_ao = res_ao;
  p.res_ffn_mask = res_ffn_mask;
  p.res_obn = res_obn;
  p.H = H;
  p.I = I;
  p.n_ffn = n_ffn;
  p.shared_kq = shared_kq;
  p.act = act;
  p.skip_max = skip_max;
  p.rsqrt_d = rsqrt_d;
  p.log2e = log2e;
  p.gelu_c = gelu_c;

  const size_t smem = Layout(kT, TH, H, I).bytes(kT, kD);
  static size_t smem_allowed = 0;  // raised once, not on every launch
  if (smem > smem_allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        mb_layer_kernel<kT, kD, kNH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_allowed = smem;
  }
  mb_layer_kernel<kT, kD, kNH><<<B, THREADS, smem,
                                 static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
