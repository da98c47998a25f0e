"""A/B the int8 matmul kernel (K1, ``csrc/int8_matmul.cu``) against edited
copies of itself on one NVIDIA card, at BERT-base's layer shapes,
MobileBERT's NoNorm matmul (K6, ``csrc/int8_matmul_norm.cu``) against
another checkout's at a MobileBERT layer's five shapes, the float-edge
matmul (K4, ``csrc/float_edge_matmul.cu``) at the recipes' inter shape,
the attention (K2 / K7, ``csrc/int8_attention.cu``) at BERT-base's and
MobileBERT's calls, the add+LN template (K3 / K5) and MobileBERT's layer
kernel (K8, ``csrc/int8_mb_layer.cu``).

    python3 k1_probe.py [--out DIR] [--parent DIR] [--build-only]
                        [--kernels k1,norm,edge,attn,ln,mb,w4,sass,k9,flex]

Each variant is the kernel's source and the shared GEMM header
(``csrc/wgmma_gemm.cuh``) with one edit, built with the package's
``nvcc`` flags into ``DIR`` (default ``k1_probe_build/``, listed in
``.gitignore``), all builds started together, loaded with ``ctypes``:

- ``kernel``: the source as it is;
- ``main_loop``: no epilogue (the products, the ring and the turns
  alone; its output is not written);
- ``one_warpgroup``: one consumer warpgroup takes every tile, so each
  tile's epilogue runs after its products and not under the next tile's;
- ``exact_branch``: the site level through ``rint_div`` (a branch and an
  out-of-line call for elements near a half level) in place of
  ``rint_div_fma``;
- ``step8``: 8 elements per epilogue step instead of 16;
- ``parent`` (with ``--parent DIR``, an unpacked checkout of another
  commit): that checkout's ``int8_matmul.cu`` and headers as they are.

On random int8 operands (M = 16384) it checks every variant that
computes the function against ``int8_matmul_ref`` (bit-identical or it
fails), and prints each variant's device ms per call (20 calls in a CUDA
graph, median of 5 replays) and TOP/s beside ``torch._int_mm``. With
``--parent`` it also compares K1's machine code with the parent's
(``cuobjdump -sass``, kernel by kernel).

K6 (``norm`` in ``--kernels``): ``kernel`` (the source as it is),
``tm128`` (tiles of 128 rows, where the kernel takes 64), ``nb2`` (two
8-column blocks an epilogue step, where the kernel takes one),
``main_loop`` (no epilogue: the products and the residual's loads) and
``no_math`` (each element ``acc ^ r``: the epilogue's data movement
without its arithmetic) and, with ``--parent``, ``parent`` (that
checkout's ``int8_matmul_norm.cu``),
on ``chip_smoke.norm_inputs`` at M = 16384 for bn_in and bn_attn (512 ->
128, no residual), attn_out (128 -> 128), the FFN dense (512 -> 128) and
out_bn (128 -> 512), the last three with a residual and the res site;
each that computes the function checked against
``int8_matmul_add_ln_ref`` (bit-identical or it fails) and timed beside ``torch._int_mm``, and their sum per layer (the
FFN dense four times).

K4 (``edge`` in ``--kernels``): ``kernel`` (the source as it is),
``main_loop`` (no epilogue: the products and the in-loop group folds),
``no_fold`` (the group folds' arithmetic taken out: the products, the
waits and the table alone), ``half_stage`` (groups of whole stages
folded after every two k32 steps, as groups of 64 columns are),
``unrolled`` (the main loop's units of a stage unrolled, two folds in
one body for groups of 64), ``regs232`` (232 registers a consumer
thread for 16-bit groups of 64, where the kernel takes 240) and, with
``--parent``, ``parent`` (that checkout's
``float_edge_matmul.cu``, called through its own signature), at M =
16384, K = 768, N = 3072 with gelu_new on ``chip_smoke.edge_inputs``:
the mixed recipe's 16-bit edge in one group, PEG's 8-bit edge in 6
permuted groups, and 16-bit and 8-bit edges in 12 permuted groups of 64
columns; each that computes the function checked against
``float_edge_matmul_ref`` (bit-identical or it fails) and timed, the
kernel's level pass and GEMM also alone, beside ``torch.matmul`` (f32,
TF32 off) and K1's gelu_new inter at the same shape. With ``--parent`` it
also compares K1's, the fused linear's, K6's, K2's and K8's machine code
with the parent's (``cuobjdump -sass``, kernel by kernel).

The add+LN template (``ln`` in ``--kernels``; ``csrc/add_ln.cuh``, built
as K3 ``add_ln_payload.cu`` and as K5 ``flex_add_ln.cu``): ``kernel``
(the sources as they are), ``loads_only`` (each row's loads in and its
outputs out, the words XORed: the floor the data movement sets),
``no_f64_sums`` (the row sums in float), ``rintf`` (the old rounding in
place of the magic-number one), ``i2f`` (the old int8 -> float
conversion in place of the byte permutes), ``one_row_a_block`` (one row
a warp, eight a block, the grid the rows need: the old grid),
``no_div`` (z * ln_s for z / ln_s: the division's cost), ``e4`` (four
columns a lane a chunk at every H), ``blocks1`` / ``blocks4`` (one /
four blocks an SM, where the kernel takes two), ``blocks2`` (at most two
blocks an SM where the registers allow more), ``balanced`` (a persistent
grid cut so that every warp takes the same number of rows, give or take
one round), ``pad_row`` (an eighth, unused shared-memory row for
per-column sites) and, with ``--parent``,
``parent`` (that checkout's ``add_ln_payload.cu`` / ``flex_add_ln.cu``),
at M = 16384, H = 768 on ``chip_smoke.ln_inputs``: K3 (W8A8), K5's two
calls under the mixed recipe's 16-bit sites and under PEG's per-column
ones, and ``fused_add_ln`` (K5 builds the variants that split its time:
``LN_K5_VARIANTS``); each that computes the function checked against its
plain version (bit-identical or it fails) and timed beside its bound,
with the sums per layer; and the count of conversion-pipe opcodes in
K3's machine code at H = 768 (``cuobjdump -sass``). With ``--parent`` it
also compares the other kernels' machine code with the parent's.

The attention kernel (``attn`` in ``--kernels``; K2 / K7,
``csrc/int8_attention.cu``): ``kernel`` (the source as it is),
``loads_only`` (the TMA loads in and the context tiles out, with no
shared-memory preparation and no arithmetic: the floor the data movement
sets), ``no_softmax`` (the softmax chain taken out: the probs are the
scores' low bytes; the loads, the v transpose, both products and the
context site stay), ``general`` (the reference's formulas with rintf,
which the kernel takes for shifts that are not small integers, in place
of its integer path), ``one_block`` (one block an SM, where the kernel
takes two), ``no_exp`` / ``no_f64`` (exp2 taken out / the row sums in
float: the cost of each), ``no_qk`` / ``no_context`` / ``no_prep`` (the
q.k^T products / p.v and the context site / the block's shared
preparation taken out) and, with
``--parent``, ``parent`` (that checkout's ``int8_attention.cu``), at
BERT-base's call (B = 128, T = 128, 12 heads of 64, one fused q|k|v
array) and MobileBERT's (4 heads of 32, q and k the halves of one [q|k]
array, v its own: cols (0, 1, 0)) on ``chip_smoke.attn_inputs``, with
skip_max as both engines take it; each
that computes the function checked against ``int8_attention_qkv_ref``
(bit-identical or it fails) and timed beside its bound. With
``--parent`` it also compares the machine code of K8, K1, the fused
linear, K6 and K4 with the parent's.

MobileBERT's layer kernel (``mb`` in ``--kernels``; K8,
``csrc/int8_mb_layer.cu``): ``kernel`` (the source as it is),
``main_loop`` (every unit's products with no epilogue and no attention:
the weight stream and the tensor cores), ``no_math`` (each element the
low byte of its sum, the residual XORed in: the epilogues' data movement
without their arithmetic), ``attn_only`` (no matmul: the attention on
what shared memory holds), ``lockstep`` (both warpgroups meet at a
barrier before each unit's products), ``ilp`` (twice the elements an
epilogue step: 8 NoNorm, 16 emitted) and, with ``--parent``, ``parent``
(that checkout's ``int8_mb_layer.cu``, at the seqs it takes:
``PARENT_MB_SEQS``), at ``MB_CALLS`` (S = 128, 64 and 32 at B = 128, over
16384 rows, and ragged batches) on ``chip_smoke.mb_inputs``; each that
computes the function checked against ``int8_mb_layer_ln_ref`` and the
chain of K1, K6 and K7 (bit-identical or it fails) and timed beside that
chain, with ptxas's registers and spills of every variant and K8's MMA
opcodes (``cuobjdump -sass``: warpgroup MMAs, no ``mma.sync``); with
``--parent`` also every other kernel's machine code against the
parent's (``MB_SASS``). Variants named ``build_*`` are built for
ptxas's lines and not run; ``--build-only`` stops after the builds.

K1's packed-int4 instance (``w4`` in ``--kernels``; ``gemm_kernel_w4``
in ``csrc/wgmma_gemm.cuh``): ``kernel`` (the source as it is), ``ilp1``
/ ``ilp4`` / ``ilp6`` (the unpacking warps load 1 / 4 / 6 blocks of 8
weight rows before they store any, where the kernel takes ``W4_ILP``),
``no_unpack`` (the nibbles left packed: the loads, the ring and the
products alone), ``no_fence`` (no proxy fence after the unpack),
``unpack_alone`` (no products: the loads and the unpack alone),
``no_loads`` / ``no_stores`` (the unpack without its shared-memory loads
/ stores) and
``two_warps`` (two unpacking warps, where the kernel takes three), at
BERT-base's four matmul shapes at M = 16384 and M = 256 (the (8, 32)
serving bucket's rows) on random packed weights; each that computes the
function checked against ``int8_matmul_ref(w4=True)`` and K1 int8 on the
unpacked weight (bit-identical or it fails) and timed beside K1 int8 and
``torch._int_mm`` on the unpacked weight, with the sums per layer and
ptxas's lines per variant. With ``--parent`` it also compares the other
GEMM instances' machine code (K1 int8, the fused linear, K6, K4) with the
parent's.

The float x int8 matmul (``k9`` in ``--kernels``; K9,
``csrc/float_int8_gemm.cu``): ``kernel`` (the source as it is: DMMA
m16n8k4), ``k16`` / ``k8`` (the same products as m16n8k16 / m16n8k8
DMMAs), ``stages3`` (a 3-stage ring, where the kernel takes 4),
``main_loop`` (no epilogue: the ring, the conversions and the products),
``w_magic`` (w's bytes to float64 by a byte permute and a float64 add
of 2^52 + 128, exact, in place of the conversion), ``no_cvt_x`` /
``no_cvt_w`` / ``no_cvt`` (x's, w's or both conversions replaced by bit
moves: timing only, the function is not computed) and, with
``--parent``, ``parent`` (that checkout's
``float_int8_gemm.cu``, called through its own signature), at phase
16's call (M = 16384, K = N = 768, emit) and at its fold and float
epilogues; each that computes the function checked against
``float_int8_matmul_ref`` (within the float64 ties,
``chip_smoke.compare_ties``) and timed beside its bound, ``torch.matmul``
f32 (TF32 off) and the float64 product of the same sums.

The attention's second kernel (``flex`` in ``--kernels``;
``csrc/int8_attention.cu``, ``attn_flex_*``): ``kernel`` (the source as
it is), ``k4`` (the float dots as m16n8k4 DMMAs, where the kernel takes
m16n8k16), ``ndg1`` / ``ndg4`` (1 / 4 head-dim tiles a float p.v pass
on the integer route, where the kernel takes ``NDG``), ``kch2`` /
``kch8`` (2 / 8 key tiles a float q.k pass, where it takes ``KCH``),
``lvl_blocks1`` (the 9-16-bit probs instances built for one block an
SM, where the kernel takes two), ``f64_blocks2`` (the integer route's
disabled-probs instances built for two, where it takes one) and, with
``--parent``, ``parent`` (that checkout's kernel through the same entry
point), on phase 16's forms (``FLEX_PROBE_FORMS``) at B = 128, T = 128,
12 heads of 64 with ``chip_smoke.flex_attn_case``'s scalars; each
checked against ``int8_attention_ref`` (the integer route bit-identical,
the float64 one within the ties) and timed beside its bound, with
ptxas's registers and spills of every instance.

``sass`` in ``--kernels`` (with ``--parent``): every source of the
package built as it is and as the parent has it, and each kernel's
machine code compared with the parent's (identical, differing, or only
in this tree), seconds of builds and nothing run; then the MMA and
float64 opcodes of K9's and the attention's second kernel's instances
(DMMA, IMMA, DFMA: the routes' tensor cores).
Imports torch and the port only.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import threading
from pathlib import Path

import torch

import chip_smoke as CS
from transformer_quantization_tpu_torch.ops import int_linear as IL
from transformer_quantization_tpu_torch.ops.kernels import build as KB
from transformer_quantization_tpu_torch.ops.kernels import engine_kernels as EK
from transformer_quantization_tpu_torch.ops.kernels.activations import (
    GELU_NEW_C,
)

EDITS = {
    "kernel": [],
    "main_loop": [("for (int p = 0; p < PASSES; ++p) {",
                   "for (int p = 0; p < 0; ++p) {")],
    "one_warpgroup": [
        ("if (local > 1) mbar_wait(&turn[wg], ((local >> 1) - 1 + wg) & 1);\n"
         "    else if (local == 1) mbar_wait(&turn[1], 0);", ""),
        ("for (int t = blockIdx.x + wg * gridDim.x, local = wg; t < tiles;\n"
         "       t += 2 * gridDim.x, local += 2) {",
         "if (wg == 1) return;\n"
         "  for (int t = blockIdx.x, local = 0; t < tiles;\n"
         "       t += gridDim.x, local += 1) {")],
    "exact_branch": [("tqmm::rint_div_fma(y, kc.os, kc.inv)",
                      "tqmm::rint_div(y, kc.os, kc.inv)")],
    "step8": [("constexpr int EPI_NB = 2;", "constexpr int EPI_NB = 1;")],
}
COMPUTES = {"kernel", "one_warpgroup", "exact_branch", "step8", "parent"}
GEMM = "wgmma_gemm.cuh"
LN = "add_ln.cuh"
ATTN = "attn_common.cuh"
# (N, K, activation, output) of a BERT-base layer's four calls, and the
# recipes' dense fold on a 16-bit grid
SHAPES = [(2304, 768, None, "emit", 8), (768, 768, None, "emit", 8),
          (3072, 768, "gelu_new", "emit", 8), (768, 3072, None, "emit", 8),
          (768, 3072, None, "fold", 16)]
ACT = {None: 0, "gelu_new": 1, "relu": 2}
MODE = {"emit": 0, "fold": 1, "float": 2}
# K6's variants: the source as it is; 128-row tiles (the kernel takes 64:
# at N = 128 a 128-row tiling leaves a consumer warpgroup of each block
# idle); two 8-column blocks an epilogue step (the kernel takes one); no
# epilogue (the products and the residual's loads alone); an element step
# without its arithmetic (acc ^ r: the epilogue's data movement alone)
NORM_EDITS = {
    "kernel": [],
    "tm128": [("static constexpr int kTM = 64;",
               "static constexpr int kTM = 128;"),
              ("make_i8_map(&mx, x, M, K, 64)",
               "make_i8_map(&mx, x, M, K, 128)")],
    "nb2": [("static constexpr int kEpiNB = 1;",
             "static constexpr int kEpiNB = 2;")],
    "main_loop": EDITS["main_loop"],
    "no_math": [("    const float y = tqmm::fold(acc, k.s);\n",
                 "    return static_cast<int8_t>(acc ^ r);\n"
                 "    const float y = tqmm::fold(acc, k.s);\n")],
}
NORM_COMPUTES = {"kernel", "tm128", "nb2", "parent"}
# K6's calls on a MobileBERT-uncased layer: (tag, N, K, residual, launches)
NORM_CALLS = [("bn_in", 128, 512, False, 1), ("bn_attn", 128, 512, False, 1),
              ("attn_out", 128, 128, True, 1),
              ("ffn dense", 128, 512, True, 4),
              ("out_bn", 512, 128, True, 1)]
# K4's variants (the module docstring)
EDGE_EDITS = {
    "kernel": [],
    "main_loop": EDITS["main_loop"],
    "no_fold": [("    const float s = end ? gs[g] : 0.0f;\n    if (small()) {",
                 "    return;\n    const float s = end ? gs[g] : 0.0f;\n"
                 "    if (small()) {"),
                ("    const float s = end ? gs[g] : 0.0f;\n    const long long z",
                 "    return;\n    const float s = end ? gs[g] : 0.0f;\n"
                 "    const long long z")],
    "half_stage": [("  if (a.gsize % tqwg::TK == 0)\n", "  if (false)\n")],
    "unrolled": [("#pragma unroll 1\n        for (int u = 0;",
                  "#pragma unroll\n        for (int u = 0;")],
    "regs232": [("kRegs = PL == 2 && GR == 2 ? 240 : 232;", "kRegs = 232;")],
}
EDGE_COMPUTES = {"kernel", "half_stage", "unrolled", "regs232", "parent"}
# the recipes' inter matmul, and groups of 64 at its shape: (tag, bits,
# groups)
EDGE_CALLS = [("mixed", 16, 1), ("peg", 8, 6), ("g64", 16, 12),
              ("g64", 8, 12)]
# the parent's float-edge entry point (one call, no level scratch)
PARENT_EDGE_SYM = "tq_float_edge_matmul"
PARENT_EDGE_ARGS = ((ctypes.c_void_p,) * 9 + (ctypes.c_int,) * 5
                    + (ctypes.c_float, ctypes.c_int, ctypes.c_float,
                       ctypes.c_void_p))
# the attention kernel's variants (the module docstring)
ATTN_CONSUMER_QK = """    int acc[C::NT][4], qs[4];
    scores<T, D>(st, st + C::TILE, q0, slot * T, g, t, acc, qs);
"""
ATTN_SOFTMAX = """    unsigned pa[C::KC][4];
    const float* ci = colp + slot * T * 2;
    if (fast && skip_max)
      softmax<T, D, true, true>(acc, qs, ci, s, t, pa);
    else if (fast)
      softmax<T, D, true, false>(acc, qs, ci, s, t, pa);
    else if (skip_max)
      softmax<T, D, false, true>(acc, qs, ci, s, t, pa);
    else
      softmax<T, D, false, false>(acc, qs, ci, s, t, pa);
"""
ATTN_CONTEXT = """    if (fast)
      context<T, D, true>(pa, vti, pvi, s, g, t, ost);
    else
      context<T, D, false>(pa, vti, pvi, s, g, t, ost);
"""
ATTN_PREP = """    if (fast)
      prep<T, D, true>(st, vtp, colp, pvp, s, log2e, nv);
    else
      prep<T, D, false>(st, vtp, colp, pvp, s, log2e, nv);
"""
ATTN_EDITS = {
    "kernel": [],
    "loads_only": [
        (ATTN_PREP, ""),
        (ATTN_CONSUMER_QK, ""), (ATTN_SOFTMAX, ""), (ATTN_CONTEXT, "")],
    "no_softmax": [(ATTN_SOFTMAX, """    unsigned pa[C::KC][4];
#pragma unroll
    for (int c = 0; c < C::KC; ++c)
#pragma unroll
      for (int j = 0; j < 4; ++j) pa[c][j] = acc[4 * c + j][j] ^ qs[0];
""")],
    "general": [("  const bool fast = small_int", "  const bool fast = false && small_int")],
    "one_block": [("constexpr int MIN_BLOCKS = 2;", "constexpr int MIN_BLOCKS = 1;")],
    "no_exp": [("          exp2f(SKIP ? sv[ni][r] : sv[ni][r] - (r < 2 ? m_lo : m_hi));",
                "          SKIP ? sv[ni][r] : sv[ni][r] - (r < 2 ? m_lo : m_hi);")],
    "no_context": [(ATTN_CONTEXT, """    {
      uint32_t x = 0;
#pragma unroll
      for (int c = 0; c < C::KC; ++c)
#pragma unroll
        for (int j = 0; j < 4; ++j) x ^= pa[c][j];
      reinterpret_cast<uint32_t*>(ost)[lane] = x;
    }
""")],
    "no_qk": [(ATTN_CONSUMER_QK, """    int acc[C::NT][4], qs[4];
#pragma unroll
    for (int ni = 0; ni < C::NT; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[ni][r] = (ni * 4 + r) * 37 - lane * 11;
#pragma unroll
    for (int r = 0; r < 4; ++r) qs[r] = lane * r;
""")],
    "no_prep": [(ATTN_PREP, "")],
    "ex2_ftz": [("""      const float e =
          exp2f(SKIP ? sv[ni][r] : sv[ni][r] - (r < 2 ? m_lo : m_hi));""",
                 """      float e;
      asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e)
          : "f"(SKIP ? sv[ni][r] : sv[ni][r] - (r < 2 ? m_lo : m_hi)));""")],
    "no_pclip": [("""        u[n][r] = site_bits<INT>(sv[4 * c + n][r] * (r < 2 ? w_lo : w_hi),
                                 s.p_sh);""", """        u[n][r] = __float_as_uint(
            (sv[4 * c + n][r] * (r < 2 ? w_lo : w_hi) + BIAS) - s.p_sh);""")],
    "no_sync": [("""      prep<T, D, false>(st, vtp, colp, pvp, s, log2e, nv);
    __syncthreads();""", """      prep<T, D, false>(st, vtp, colp, pvp, s, log2e, nv);
    __syncwarp();""")],
    "no_f64": [("  double d[2][2] = {{0.0, 0.0}, {0.0, 0.0}};",
                "  float d[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};"),
               ("      d[r >> 1][ni & 1] += static_cast<double>(e);",
                "      d[r >> 1][ni & 1] += e;"),
               ("  double d_lo = d[0][0] + d[0][1], d_hi = d[1][0] + d[1][1];",
                "  float d_lo = d[0][0] + d[0][1], d_hi = d[1][0] + d[1][1];")],
}
ATTN_COMPUTES = {"kernel", "general", "one_block", "parent"}
# (tag, B, T, head_dim, heads, chip_smoke.attn_split layout or 'fused');
# skip_max as both engines' plans take it (their scores' bound < 100)
ATTN_CALLS = [("bert", 128, 128, 64, 12, "fused"),
              ("mobilebert", 128, 128, 32, 4, "mobilebert")]
ATTN_SKIP_MAX = 1
# the kernels whose machine code this PR's edits must leave as they were
ATTN_SASS = ("int8_mb_layer.cu", "int8_matmul.cu", "fused_int8_linear.cu",
             "int8_matmul_norm.cu", "float_edge_matmul.cu")
# the other kernels on the shared headers (the GEMM skeleton's other
# instances, and the mma.sync kernels on mm_common.cuh), whose machine
# code an edit of those headers for K4 must leave as it was
SASS_SOURCES = ("int8_matmul.cu", "fused_int8_linear.cu",
                "int8_matmul_norm.cu", "int8_attention.cu",
                "int8_mb_layer.cu")


# the add+LN template's variants (the module docstring), on add_ln.cuh
LN_CALL = """    if constexpr (COL)
      ln_row<YT, RT, COL, OUT, NCH, GENERAL>(a, cst, k, cy, cr, row, lane);
    else if (!ints)
      ln_row<YT, RT, COL, OUT, NCH, GENERAL>(a, cst, k, cy, cr, row, lane);
    else if (a.res_quant)
      ln_row<YT, RT, COL, OUT, NCH, INT_RQ>(a, cst, k, cy, cr, row, lane);
    else
      ln_row<YT, RT, COL, OUT, NCH, INT_NO_RQ>(a, cst, k, cy, cr, row, lane);
"""
LN_COPY = """template <int NCH>
__device__ uint32_t bits(const Raw<int8_t, NCH>& r, int i) {
  return r.w[i >> 2];
}
template <int NCH>
__device__ uint32_t bits(const Raw<float, NCH>& r, int i) {
  return __float_as_uint(r.v[i]);
}
// the loads in and the outputs out, no arithmetic
template <typename YT, typename RT, int OUT, int NCH>
__device__ void copy_row(const Args& a, const Raw<YT, NCH>& ry,
                         const Raw<RT, NCH>& rr, int row, int lane) {
  using C = Cols<NCH>;
  constexpr int E = C::E;
  const size_t base = static_cast<size_t>(row) * C::H;
#pragma unroll
  for (int c = 0; c < C::CH; ++c) {
    const int col = C::col(c, lane);
    if (OUT & OUT_I8) {
      uint32_t w[E / 4];
#pragma unroll
      for (int q = 0; q < E / 4; ++q) {
        const int i = c * E + 4 * q;
        w[q] = bits(ry, i) ^ bits(rr, i);
        if (sizeof(YT) == 4 || sizeof(RT) == 4)
          w[q] ^= bits(ry, i + 1) ^ bits(ry, i + 2) ^ bits(ry, i + 3) ^
                  bits(rr, i + 1) ^ bits(rr, i + 2) ^ bits(rr, i + 3);
      }
      if constexpr (E == 8)
        *reinterpret_cast<uint2*>(a.out8 + base + col) = make_uint2(w[0], w[1]);
      else
        *reinterpret_cast<uint32_t*>(a.out8 + base + col) = w[0];
    }
    if (OUT & OUT_F32)
#pragma unroll
      for (int q = 0; q < E / 4; ++q) {
        float f[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = c * E + 4 * q + j;
          f[j] = __uint_as_float(bits(ry, i) ^ bits(rr, i));
        }
        *reinterpret_cast<float4*>(a.outf + base + col + 4 * q) =
            make_float4(f[0], f[1], f[2], f[3]);
      }
  }
}

// YT / RT: int8_t (a payload"""
LN_EDITS = {
    "kernel": [],
    "loads_only": [(LN_CALL, "    copy_row<YT, RT, OUT, NCH>(a, cy, cr, row, lane);\n"),
                   ("// YT / RT: int8_t (a payload", LN_COPY)],
    "no_f64_sums": [("using Acc = double;", "using Acc = float;")],
    "general": [("  const bool ints = !COL && ", "  const bool ints = false && ")],
    "i2f": [("  return __uint_as_float(__byte_perm(w ^ 0x80808080u, e23, 0x7540 | j));",
             "  return __fadd_rn(static_cast<float>(static_cast<int8_t>(w >> (8 * j))),\n"
             "                   BYTE_BIAS);")],
    "one_row_a_block": [("  return rows < resident ? rows : resident;",
                         "  return rows;")],
    "pass1_only": [("  const size_t base = static_cast<size_t>(row) * H;\n",
                    """  const size_t base = static_cast<size_t>(row) * H;
  if (lane == 0) {
    if (OUT & OUT_I8) a.out8[base] = static_cast<int8_t>(rstd > 1.0f);
    if (OUT & OUT_F32) a.outf[base] = rstd;
  }
  return;
""")],
    "div_full": [("    bool fast = k.fast_div;", "    bool fast = false;")],
    "no_div": [("    bool fast = k.fast_div;", "    bool fast = true;"),
               ("  const float q = __fmaf_rn(r, a, 0.0f);\n"
                "  return __fmaf_rn(r, __fmaf_rn(-b, q, a), q);",
                "  return __fmul_rn(a, r);")],
    "e4": [("constexpr int VEC = 8;", "constexpr int VEC = 4;")],
    "blocks1": [("    if (per_sm < 1) per_sm = 1;", "    per_sm = 1;")],
    "blocks4": [("constexpr int MIN_BLOCKS = 2;", "constexpr int MIN_BLOCKS = 4;")],
    "blocks2": [("    if (per_sm < 1) per_sm = 1;",
                 "    per_sm = per_sm < 1 ? 1 : per_sm > 2 ? 2 : per_sm;")],
    "pad_row": [("  __shared__ __align__(16) float cst[(COL ? K_COL : 2) * H];",
                 "  __shared__ __align__(16) float cst[(COL ? K_COL + 1 : 2) * H];")],
    "balanced": [("  return rows < resident ? rows : resident;",
                  "  if (rows <= resident) return rows;\n"
                  "  const int rounds = (rows + resident - 1) / resident;\n"
                  "  return (rows + rounds - 1) / rounds;")],
    "prefetch_all": [("  constexpr bool PREFETCH = sizeof(YT) + sizeof(RT) == 2;",
                      "  constexpr bool PREFETCH = true;")],
    "no_prefetch": [("  constexpr bool PREFETCH = sizeof(YT) + sizeof(RT) == 2;",
                     "  constexpr bool PREFETCH = false;")],
    "acc4": [("constexpr int NACC = 2;", "constexpr int NACC = 4;")],
    "stats_ieee": [("  if (div_fast_takes(b) && f >= 0x1p-60f && f < DIV_A_MAX)",
                    "  if (false)")],
    "persist_all": [("  return sizeof(YT) + sizeof(RT) == 2 || COL;",
                     "  return true;")],
}
LN_COMPUTES = {"kernel", "general", "i2f", "one_row_a_block", "div_full",
               "e4", "blocks1", "blocks2", "blocks4", "balanced", "pad_row",
               "prefetch_all", "no_prefetch",
               "acc4", "stats_ieee", "persist_all", "parent"}
# K5's variants: the ones that split its time (its 72 instances build
# slowly)
LN_K5_VARIANTS = ("kernel", "loads_only", "no_f64_sums", "general",
                  "pass1_only", "div_full", "prefetch_all", "persist_all",
                  "blocks1", "blocks2", "balanced", "pad_row")
# the add+LN calls of the main path and the recipes at M = 16384, H = 768:
# (tag, source, residual 'i8' | 'f', sites 'scalar8' | 'scalar16' | 'peg',
# outputs, launches a layer)
LN_CALLS = [("K3 (W8A8)", "add_ln_payload", "i8", "scalar8", ("i8",), 2),
            ("K5 ln1 mixed", "flex_add_ln", "i8", "scalar16", ("f",), 1),
            ("K5 ln2 mixed", "flex_add_ln", "f", "scalar16", ("i8",), 1),
            ("K5 ln1 PEG", "flex_add_ln", "i8", "peg", ("f",), 1),
            ("K5 ln2 PEG", "flex_add_ln", "f", "peg", ("i8",), 1),
            ("fused_add_ln", "flex_add_ln", "f", "scalar8", ("i8", "f"), 2)]
# every other source, whose machine code an edit of add_ln.cuh must leave
# as it was
LN_SASS = ("int8_matmul.cu", "fused_int8_linear.cu", "int8_matmul_norm.cu",
           "float_edge_matmul.cu", "int8_attention.cu", "int8_mb_layer.cu")
# the conversion-pipe opcodes counted in K3's machine code
CONVERSIONS = ("I2F", "F2F", "FRND", "F2I", "MUFU")

# K8's variants (the module docstring), on int8_mb_layer.cu
MB_ATTN = """        attention_any<COLS>(c, p.S, st, fast_path(st), p.skip_max, qsm, qp,
                            qp + P, vt, colv, vs, sh);
"""
MB_UNIT = """  const int col = nt * 128 + (COLS ? 64 * c.wg + (c.tid & 63) : c.tid);"""
MB_V = """  uint8_t* half = COLS ? vt : vt + c.wg * HALF;"""
MB_EDITS = {
    "kernel": [],
    "main_loop": [
        ("  named_sync(1 + c.wg, 128);   // the last epilogue is done with "
         "the table", "  if (kch >= 0) return;\n  named_sync(1 + c.wg, 128);"),
        ("    for (int i = 0; i < 32; ++i) fence_reg(acc[i]);",
         "    for (int i = 0; i < 32; ++i) fence_reg(acc[i]);\n"
         "    if (kch >= 0) continue;"),
        (MB_ATTN, "")],
    "no_math": [
        ("return tqmm::site_out<ACT, 0>(acc, k.s, -128.0f, 127.0f, gelu_c);",
         "return static_cast<int8_t>(acc);"),
        ("return tqmm::nonorm_out<RES, RQ>(acc, k, r, nn);",
         "return static_cast<int8_t>(acc ^ r);")],
    "attn_only": [
        ("    for (int m = 0; m < p.n_mm; ++m) {\n      const int nt",
         "    for (int m = 0; m < 0; ++m) {\n      const int nt"),
        (MB_UNIT, "  if (kch >= 0) return;\n" + MB_UNIT),
        (MB_V, MB_V + "\n  if (kch >= 0) return;")],
    "lockstep": [("  int prev = 0;\n  for (int kc = 0; kc < kch; ++kc) {",
                  "  named_sync(3, 256);\n  int prev = 0;\n"
                  "  for (int kc = 0; kc < kch; ++kc) {")],
    "ilp": [("  constexpr int NB = RES ? 1 : 2;   // 8-column blocks a step",
             "  constexpr int NB = RES ? 2 : 4;")],
}
MB_COMPUTES = {"kernel", "lockstep", "ilp", "parent"}
# every other source, whose machine code this PR's edits of the shared
# headers must leave as it was
MB_SASS = ("int8_matmul.cu", "fused_int8_linear.cu", "int8_matmul_norm.cu",
           "float_edge_matmul.cu", "int8_attention.cu", "add_ln_payload.cu",
           "flex_add_ln.cu")
# (seq, batch): the layer kernel's built seqs at the serving batch (B =
# 128: 64-row tiles at S = 64 and 32) and over 16384 rows (128-row
# tiles), and ragged batches (B * S not a multiple of 128)
MB_CALLS = ((128, 128), (64, 128), (32, 128), (64, 256), (32, 512), (64, 7),
            (32, 9))
PARENT_MB_SEQS = (128,)   # the seqs the parent's K8 takes


# K9's variants: (old, new) edits of float_int8_gemm.cu
K9_EPI = ("  epilogue<ACT, OUT>(acc, vecs, out, m0 + wm, n0 + wn, M, N, lo, "
          "hi, gelu_c);")
K9_EDITS = {
    "kernel": [],
    "k16": [("constexpr int KS = 1;", "constexpr int KS = 4;")],
    "k8": [("constexpr int KS = 1;", "constexpr int KS = 2;")],
    "stages3": [("constexpr int BM = 128, BN = 128, BK = 32, STAGES = 4;",
                 "constexpr int BM = 128, BN = 128, BK = 32, STAGES = 3;")],
    "main_loop": [(K9_EPI, """  double sum = 0.0;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int nj = 0; nj < NT; ++nj)
#pragma unroll
      for (int i = 0; i < 4; ++i) sum += acc[mi][nj][i];
  if (sum == 1.25e300) static_cast<float*>(out)[0] = 0.0f;""")],
}
K9_W = "        for (int s = 0; s < 4; ++s) b[nj][s] = tqdm::i8_to_f64(word, s);"
K9_X = """        const double a[8] = {lo4.x, hi4.x, lo4.y, hi4.y,
                             lo4.z, hi4.z, lo4.w, hi4.w};"""
K9_X_BITS = """        const double a[8] = {
            __hiloint2double(__float_as_int(lo4.x), 0),
            __hiloint2double(__float_as_int(hi4.x), 0),
            __hiloint2double(__float_as_int(lo4.y), 0),
            __hiloint2double(__float_as_int(hi4.y), 0),
            __hiloint2double(__float_as_int(lo4.z), 0),
            __hiloint2double(__float_as_int(hi4.z), 0),
            __hiloint2double(__float_as_int(lo4.w), 0),
            __hiloint2double(__float_as_int(hi4.w), 0)};"""
# w's bytes as float64 by 2^52 + (v + 128) less 2^52 + 128: a byte
# permute and a float64 add, exact, in place of the conversion
K9_W_MAGIC = """        for (int s = 0; s < 4; ++s)
          b[nj][s] = __hiloint2double(
                         0x43300000,
                         __byte_perm(word ^ 0x80808080u, 0, 0x4440 + s)) -
                     4503599627370624.0;"""
K9_W_BITS = """        for (int s = 0; s < 4; ++s)
          b[nj][s] = __hiloint2double(static_cast<int>(word >> (8 * s)), 0);"""
K9_EDITS.update({
    "w_magic": [(K9_W, K9_W_MAGIC)],
    "no_cvt_x": [(K9_X, K9_X_BITS)],
    "no_cvt_w": [(K9_W, K9_W_BITS)],
    "no_cvt": [(K9_X, K9_X_BITS), (K9_W, K9_W_BITS)],
})
K9_COMPUTES = {"kernel", "k16", "k8", "stages3", "w_magic", "parent"}
# the attention's second kernel's variants: edits of int8_attention.cu
FLEX_EDITS = {
    "kernel": [],
    "k4": [("constexpr int KS_F = 4;", "constexpr int KS_F = 1;")],
    "ndg1": [("constexpr int NDG = 2;", "constexpr int NDG = 1;")],
    "ndg4": [("constexpr int NDG = 2;", "constexpr int NDG = 4;")],
    "kch2": [("constexpr int KCH = 4;", "constexpr int KCH = 2;")],
    "lvl_blocks1": [("return PV == PV_F64 ? 1 : 2;",
                     "return PV == PV_PAY ? 2 : 1;")],
    "f64_blocks2": [("return PV == PV_F64 ? 1 : 2;", "return 2;")],
    "kch8": [("constexpr int KCH = 4;", "constexpr int KCH = 8;")],
}
# phase 16's forms: (attn_bits, dots)
FLEX_PROBE_FORMS = (((0, 8, 8), "i8"), ((8, 0, 8), "i8"), ((8, 8, 0), "i8"),
                    ((16, 16, 8), "i8"), ((8, 8, 16), "i8"),
                    ((16, 16, 16), "f32"), ((6, 6, 6), "f32"))
# SASS opcodes that say which units the float and integer dots run on
MMA_OPS = ("DMMA", "IMMA", "HMMA", "DFMA")

LOGS = {}   # (source, variant) -> its nvcc log


def build_variants(source: str, variants: dict, out: Path,
                   parent=None) -> dict:
    """Write and build every variant of ``csrc/<source>`` (its edits
    applied to the source or to the shared GEMM header, each copied into
    the variant's own directory, where the source's includes find it
    first), and with ``parent`` (a checkout's root) that checkout's
    source against its own headers, all ``nvcc`` runs started together;
    returns name -> the library (see :func:`entry`)."""
    return build_many([(source, variants, out, parent)])[0]


def build_many(jobs) -> list:
    """:func:`build_variants` for every ``(source, variants, out,
    parent)`` of ``jobs``, every ``nvcc`` run of every job started
    together; returns each job's name -> library."""
    running = []
    for source, variants, out, parent in jobs:
        procs = {}
        for name, edits in variants.items():
            files = {f: (KB.CSRC / f).read_text() for f in (source, GEMM,
                                                             LN, ATTN)}
            for old, new in edits:
                holder = [f for f, text in files.items() if old in text]
                if not holder:
                    raise SystemExit(f"{source}: {name}: the sources no "
                                     f"longer hold {old!r}")
                files[holder[0]] = files[holder[0]].replace(old, new)
            d = out / name
            d.mkdir(parents=True, exist_ok=True)
            for f, text in files.items():
                (d / f).write_text(text)
            procs[name] = (d, KB.CSRC)
        if parent is not None:
            procs["parent"] = (Path(parent) / KB.CSRC.relative_to(
                KB.CSRC.parents[3]), None)
        job = {}
        for name, (d, inc) in procs.items():
            lib = out / f"{name}.so"
            job[name] = (lib, subprocess.Popen(
                [KB._nvcc(), *KB.NVCC_FLAGS,
                 *(["-I", str(inc)] if inc else []), "-o", str(lib),
                 str(d / source)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        running.append((source, job))
    built = []
    for source, job in running:
        libs = {}
        for name, (lib, p) in job.items():
            log, _ = p.communicate()
            if p.returncode:
                raise SystemExit(f"{source}: {name} failed to build:\n{log}")
            spills = sorted({ln.strip() for ln in log.splitlines()
                             if "spill" in ln or "serialized" in ln})
            print(f"  {source} {name}: built; {' | '.join(spills)}")
            LOGS[source, name] = log
            libs[name] = ctypes.CDLL(str(lib))
        built.append(libs)
    return built


def sass(lib: Path) -> dict:
    """The machine code of every kernel in ``lib`` (``cuobjdump -sass``):
    a kernel's name, with its source's anonymous-namespace tag taken out,
    -> its instructions."""
    dump = subprocess.run(
        [str(Path(KB._nvcc()).with_name("cuobjdump")), "-sass", str(lib)],
        capture_output=True, text=True, check=True).stdout
    funcs, name = {}, None
    for ln in dump.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            name = re.sub(r"_GLOBAL__N__\w+?_cu_[0-9a-f]+", "", m.group(1))
            funcs[name] = []
        elif name is not None and re.match(r"\s*/\*[0-9a-f]{4,}\*/", ln):
            funcs[name].append(ln.split("*/", 1)[1].split(";")[0].strip())
    return funcs


def same_sass(out: Path, a: str = "kernel", b: str = "parent") -> None:
    """Print whether variants ``a`` and ``b`` built into ``out`` compile to
    the same machine code, kernel by kernel."""
    fa, fb = sass(out / f"{a}.so"), sass(out / f"{b}.so")
    same = [n for n in fa if fb.get(n) == fa[n]]
    new = [n for n in fa if n not in fb]
    print(f"  SASS {a} vs {b}: {len(same)} of {len(fa)} kernels identical"
          + ("" if len(same) == len(fa) == len(fb) else
             f" (differ: {sorted(set(fa) ^ set(same) ^ set(new))[:4]}; "
             f"{len(fb)} in {b}; {len(new)} only in {a})"), flush=True)


def entry(lib: ctypes.CDLL, name: str, argtypes=None):
    """Entry point ``name`` of ``build.py``'s signatures in ``lib``
    (``argtypes`` in place of the signature's, for another checkout's)."""
    sym, sig = KB._SIGNATURES[name]
    fn = getattr(lib, sym)
    fn.argtypes = list(argtypes or sig)
    fn.restype = ctypes.c_int
    return fn


def inputs(m, n, k, gen, dev):
    x = torch.randint(-128, 128, (m, k), generator=gen, device=dev,
                      dtype=torch.int8)
    w = torch.randint(-128, 128, (n, k), generator=gen, device=dev,
                      dtype=torch.int8)
    vecs = torch.stack([
        torch.rand(n, generator=gen, device=dev) * 1e-3 + 1e-4,
        w.float().sum(1), torch.randn(n, generator=gen, device=dev) * 0.1,
        0.05 * (1 + torch.rand(n, generator=gen, device=dev)),
        torch.full((n,), 3.0, device=dev)]).contiguous()
    return x, w, vecs, torch.tensor([[0.02, 5.0]], device=dev)


def probe_norm(out: Path, parent) -> None:
    """K6 and the parent's K6 at a MobileBERT layer's five calls."""
    fns = {name: entry(lib, "int8_matmul_norm") for name, lib in
           build_variants("int8_matmul_norm.cu", NORM_EDITS, out / "norm",
                          parent).items()}
    dev = torch.device("cuda")
    m = 16384
    per_layer = dict.fromkeys([*fns, "torch._int_mm"], 0.0)
    for i, (tag, n, k, res, launches) in enumerate(NORM_CALLS):
        x, w, vecs, scal, r, gb, ls = (torch.from_numpy(a).to(dev) for a in
                                       CS.norm_inputs(m, k, n, 40 + i))
        r8 = r if res else None
        want = EK.int8_matmul_add_ln_ref(x, w, vecs, scal, r8, gb, ls,
                                         eps=0.0, res_quant=res,
                                         norm="nonorm")
        out8 = torch.empty((m, n), device=dev, dtype=torch.int8)
        line = (f"  K6 [{tag}] {m}x{k}->{n} "
                f"{'residual' if res else 'no residual'}:")
        for name, fn in fns.items():
            def call(fn=fn):
                err = fn(x.data_ptr(), w.data_ptr(), vecs.data_ptr(),
                         scal.data_ptr(), r8.data_ptr() if res else None,
                         gb.data_ptr(), ls.data_ptr(), out8.data_ptr(), m, n,
                         k, int(res), torch.cuda.current_stream().cuda_stream)
                KB.check(err, name)
            call()
            torch.cuda.synchronize()
            if name in NORM_COMPUTES and not torch.equal(out8, want):
                raise SystemExit(f"k1_probe: K6 {name} differs from "
                                 f"int8_matmul_add_ln_ref at {line}")
            t = CS.device_ms(call)
            per_layer[name] += launches * t
            line += f" {name} {t:.4f} ms;"
        w_t = w.t()
        t = CS.device_ms(lambda: torch._int_mm(x, w_t))
        per_layer["torch._int_mm"] += launches * t
        print(f"{line} torch._int_mm {t:.4f} ms", flush=True)
    print("  K6 per layer (8 launches): " + "; ".join(
        f"{name} {t:.4f} ms" for name, t in per_layer.items()), flush=True)


def probe_edge(out: Path, parent) -> None:
    """K4's variants and the parent's K4 at the recipes' inter shape, and
    (with ``parent``) the other GEMM instances' machine code against the
    parent's."""
    jobs = [("float_edge_matmul.cu", EDGE_EDITS, out / "edge", parent)]
    if parent is not None:
        jobs += [(src, {"kernel": []}, out / Path(src).stem, parent)
                 for src in SASS_SOURCES]
    built = build_many(jobs)
    for src in SASS_SOURCES if parent is not None else ():
        print(f"  {src}:", end="")
        same_sass(out / Path(src).stem)
    libs = built[0]
    dev = torch.device("cuda")
    m, k, n = 16384, 768, 3072
    st = lambda: torch.cuda.current_stream().cuda_stream
    for i, (tag, bits, groups) in enumerate(EDGE_CALLS):
        x, w, vecs, s, zp, cols = (torch.from_numpy(a).to(dev) for a in
                                   CS.edge_inputs(m, k, n, bits, groups,
                                                  50 + i))
        grid = EK.edge_grid(w, s, zp, bits, groups, cols)
        planes, size = EK.edge_planes(grid), k // groups
        maxq = float(2 ** bits - 1)
        want = EK.float_edge_matmul_ref(x, vecs, grid, activation="gelu_new")
        lv = torch.empty((EK._edge_levels_rows(m, planes), k), device=dev,
                         dtype=torch.int8)
        out8 = torch.empty((m, n), device=dev, dtype=torch.int8)
        g = [grid[key].data_ptr() for key in ("s", "inv_s", "zp", "gcs")]
        line = f"  K4 [{tag}] {m}x{k}->{n} {bits}-bit, {groups} groups:"
        for name, lib in libs.items():
            if name == "parent":
                fn = getattr(lib, PARENT_EDGE_SYM)
                fn.argtypes, fn.restype = list(PARENT_EDGE_ARGS), ctypes.c_int

                def call(fn=fn, name=name):
                    KB.check(fn(x.data_ptr(), cols.data_ptr(),
                                grid["w"].data_ptr(), vecs.data_ptr(), *g,
                                out8.data_ptr(), m, n, k, size, planes, maxq,
                                1, GELU_NEW_C, st()), name)
            else:
                lev = entry(lib, "float_edge_levels")
                gemm = entry(lib, "float_edge_gemm")

                def call(lev=lev, gemm=gemm, name=name):
                    KB.check(lev(x.data_ptr(), cols.data_ptr(), g[1], g[2],
                                 lv.data_ptr(), m, k, size, planes, maxq,
                                 st()), name)
                    KB.check(gemm(lv.data_ptr(), grid["w"].data_ptr(),
                                  vecs.data_ptr(), g[0], g[2], g[3],
                                  out8.data_ptr(), m, n, k, size, planes, 1,
                                  0, -128.0, 127.0, GELU_NEW_C, st()), name)
            call()
            torch.cuda.synchronize()
            if name in EDGE_COMPUTES and not torch.equal(out8, want):
                raise SystemExit(f"k1_probe: K4 {name} differs from "
                                 f"float_edge_matmul_ref at {line}")
            line += f" {name} {CS.device_ms(call):.4f} ms;"
        lev = entry(libs["kernel"], "float_edge_levels")
        gemm = entry(libs["kernel"], "float_edge_gemm")
        t_lev = CS.device_ms(lambda: KB.check(lev(
            x.data_ptr(), cols.data_ptr(), g[1], g[2], lv.data_ptr(), m, k,
            size, planes, maxq, st()), "levels"))
        t_gemm = CS.device_ms(lambda: KB.check(gemm(
            lv.data_ptr(), grid["w"].data_ptr(), vecs.data_ptr(), g[0], g[2],
            g[3], out8.data_ptr(), m, n, k, size, planes, 1, 0, -128.0, 127.0,
            GELU_NEW_C, st()), "gemm"))
        w_f = grid["w"].float()
        t_f32 = CS.device_ms(lambda: torch.matmul(x, w_f.t()))
        x8 = torch.randint(-128, 128, (m, k), device=dev, dtype=torch.int8)
        scal = torch.tensor([[0.02, 5.0]], device=dev)
        t_k1 = CS.device_ms(lambda: EK.int8_matmul(
            x8, grid["w"], vecs, scal, activation="gelu_new"))
        print(f"{line} the level pass alone {t_lev:.4f} ms, the GEMM alone "
              f"{t_gemm:.4f} ms; torch.matmul f32 {t_f32:.4f} ms; K1 gelu_new"
              f" (int8 x) {t_k1:.4f} ms", flush=True)


def probe_attn(out: Path, parent) -> None:
    """The attention kernel's variants and the parent's at BERT-base's and
    MobileBERT's calls, and (with ``parent``) the other kernels' machine
    code against the parent's."""
    jobs = [("int8_attention.cu", ATTN_EDITS, out / "attn", parent)]
    if parent is not None:
        jobs += [(src, {"kernel": []}, out / Path(src).stem, parent)
                 for src in ATTN_SASS]
    built = build_many(jobs)
    for src in ATTN_SASS if parent is not None else ():
        print(f"  {src}:", end="")
        same_sass(out / Path(src).stem)
    fns = {name: entry(lib, "int8_attention")
           for name, lib in built[0].items()}
    dev = torch.device("cuda")
    for i, (tag, b, seq, d, nh, layout) in enumerate(ATTN_CALLS):
        qkv, mask, scal = (torch.from_numpy(a).to(dev) for a in
                           CS.attn_inputs(b, seq, d, nh, 70 + i,
                                          full_pad=False))
        h = nh * d
        if layout == "fused":
            q = k = v = qkv
            cols = (0, 1, 2)
        else:
            arrays = CS.attn_split(qkv.cpu().numpy(), h, layout)
            q, k, v = (torch.from_numpy(a).to(dev) for a in arrays[:3])
            cols = arrays[3]
        want = EK.int8_attention_qkv_ref(q, k, v, mask, scal, n_heads=nh,
                                         seq=seq, hidden=h, cols=cols,
                                         skip_max=bool(ATTN_SKIP_MAX))
        out8 = torch.empty((b * seq, h), device=dev, dtype=torch.int8)
        ops = 4.0 * b * nh * seq * seq * d
        bnd, by = CS.bound_ms(ops, 4 * b * seq * h + mask.numel() * 4)
        line = (f"  attention [{tag}] B={b} T={seq} {nh}x{d} skip_max="
                f"{ATTN_SKIP_MAX} (bound {bnd:.4f} ms, {by}):")
        for name, fn in fns.items():
            def call(fn=fn, name=name):
                KB.check(fn(q.data_ptr() + cols[0] * h,
                            k.data_ptr() + cols[1] * h,
                            v.data_ptr() + cols[2] * h, q.shape[1],
                            k.shape[1], v.shape[1], mask.data_ptr(),
                            scal.data_ptr(), out8.data_ptr(), b, seq, h, nh,
                            EK._rsqrt_d(d), EK.LOG2E, ATTN_SKIP_MAX,
                            torch.cuda.current_stream().cuda_stream), name)
            call()
            torch.cuda.synchronize()
            if name in ATTN_COMPUTES and not torch.equal(out8, want):
                raise SystemExit(f"k1_probe: attention {name} differs from "
                                 f"int8_attention_qkv_ref at {line}")
            line += f" {name} {CS.device_ms(call):.4f} ms;"
        print(line, flush=True)


def conversions(lib: Path, nch: int) -> dict:
    """Per add+LN kernel instance at H = 128 * ``nch`` in ``lib``: the
    count of each ``CONVERSIONS`` opcode in its machine code."""
    out = {}
    for name, code in sass(lib).items():
        # (an anonymous namespace's tag, taken out by sass(), may take the
        # hex-looking start of the name with it)
        if "ln_kernel" in name and re.search(rf"Li{nch}EE", name):
            ops = [ln.split()[1] if ln.startswith("@") else ln.split()[0]
                   for ln in code if ln]
            out[name] = {c: sum(op.split(".")[0] == c for op in ops)
                         for c in CONVERSIONS}
    return out


def mma_counts(lib: Path) -> dict:
    """Per layer kernel in ``lib``: how many warpgroup MMAs
    (``*GMMA``) and warp MMAs (``IMMA`` / ``HMMA``, mma.sync) its machine
    code holds."""
    out = {}
    for name, code in sass(lib).items():
        if "mb_layer_kernel" in name:
            ops = [ln.split()[1] if ln.startswith("@") else ln.split()[0]
                   for ln in code if ln]
            out[name] = {
                "GMMA": sum("GMMA" in op for op in ops),
                "mma.sync": sum(op.split(".")[0] in ("IMMA", "HMMA")
                                for op in ops)}
    return out


def probe_mb(out: Path, parent, build_only: bool = False) -> None:
    """K8's variants and (with ``parent``) the parent's K8, at every built
    seq over 16384 rows and at ragged batches, on ``chip_smoke.mb_inputs``
    (MobileBERT-uncased widths, the 'spread' scalars, skip_max off),
    beside the chain of K1, K6 and K7 on the same inputs; ptxas's
    registers and spills and the MMA opcodes of every instance; with
    ``parent`` also the other kernels' machine code against the
    parent's."""
    jobs = [("int8_mb_layer.cu", MB_EDITS, out / "mb", parent)]
    if parent is not None:
        jobs += [(src, {"kernel": []}, out / Path(src).stem, parent)
                 for src in MB_SASS]
    # the chain's kernels build beside the variants
    chain_build = threading.Thread(target=KB.build, args=(
        ("int8_matmul", "int8_matmul_norm", "int8_attention"),))
    chain_build.start()
    built = build_many(jobs)
    chain_build.join()
    print("  K8 ptxas: " + " | ".join(
        CS.ptxas_lines(LOGS["int8_mb_layer.cu", "kernel"])), flush=True)
    print(f"  K8 MMA opcodes: {mma_counts(out / 'mb' / 'kernel.so')}")
    if build_only:
        return
    for src in MB_SASS if parent is not None else ():
        print(f"  {src}:", end="")
        same_sass(out / Path(src).stem)
    fns = {name: entry(lib, "int8_mb_layer")
           for name, lib in built[0].items()}
    dev = torch.device("cuda")
    for i, (seq, b) in enumerate(MB_CALLS):
        h8, mask, ascal, flat = (
            torch.from_numpy(a).to(dev) if not isinstance(a, list) else
            [torch.from_numpy(x).to(dev) for x in a]
            for a in CS.mb_inputs(b, seq, 80 + i))
        kw = CS.mb_kwargs(seq)
        want = EK.int8_mb_layer_ln_ref(h8, mask, ascal, flat, **kw)
        chain = EK.mb_layer_chain(h8, mask, ascal, flat, **kw)
        if not torch.equal(chain, want):
            raise SystemExit(f"k1_probe: the chain differs from the plain "
                             f"layer at S={seq}, B={b}")
        res_ao, res_ffn, res_out, res_obn = kw["res"]
        ffn_mask = sum(int(r) << j for j, r in enumerate(res_ffn + (res_out,)))
        ptrs = (ctypes.c_void_p * len(flat))(*(a.data_ptr() for a in flat))
        out8 = torch.empty_like(h8)
        print(f"  K8 S={seq} B={b}:", end="", flush=True)
        for name, fn in fns.items():
            if (name == "parent" and seq not in PARENT_MB_SEQS
                    or name.startswith("build_")):
                continue

            def call(fn=fn, name=name):
                KB.check(fn(h8.data_ptr(), mask.data_ptr(), ascal.data_ptr(),
                            ctypes.addressof(ptrs), len(flat),
                            out8.data_ptr(), b, seq, 512, 128, 512, 32, 3, 1,
                            2, 0, int(res_ao), ffn_mask, int(res_obn),
                            EK._rsqrt_d(32), EK.LOG2E, GELU_NEW_C,
                            torch.cuda.current_stream().cuda_stream), name)
            call()
            torch.cuda.synchronize()
            if name in MB_COMPUTES and not torch.equal(out8, want):
                bad = int((out8 != want).sum())
                raise SystemExit(f"k1_probe: K8 {name} differs from the "
                                 f"plain layer on {bad} elements at S={seq}, "
                                 f"B={b}")
            print(f" {name} {CS.device_ms(call):.4f} ms;", end="", flush=True)
        t_chain = CS.device_ms(lambda: EK.mb_layer_chain(h8, mask, ascal,
                                                         flat, **kw))
        print(f" the chain {t_chain:.4f} ms", flush=True)


def probe_ln(out: Path, parent) -> None:
    """The add+LN template's variants, built as K3 (``add_ln_payload.cu``)
    and K5 (``flex_add_ln.cu``), and (with ``parent``) the parent's K3 and
    K5, at the main path's and the recipes' add+LN calls (M = 16384, H =
    768) on ``chip_smoke.ln_inputs``; with ``parent`` also the other
    kernels' machine code against the parent's."""
    jobs = [("add_ln_payload.cu", LN_EDITS, out / "k3", parent),
            ("flex_add_ln.cu", {v: LN_EDITS[v] for v in LN_K5_VARIANTS},
             out / "k5", parent)]
    if parent is not None:
        jobs += [(src, {"kernel": []}, out / Path(src).stem, parent)
                 for src in LN_SASS]
    built = build_many(jobs)
    for src in LN_SASS if parent is not None else ():
        print(f"  {src}:", end="")
        same_sass(out / Path(src).stem)
    for name in ("kernel", "parent") if parent is not None else ("kernel",):
        for fn_name, counts in conversions(out / "k3" / f"{name}.so",
                                           6).items():
            print(f"  K3 {name} {fn_name}: conversion-pipe opcodes {counts}",
                  flush=True)
        (out / f"k3_{name}.sass").write_text("\n".join(
            f"// {fn}\n" + "\n".join(code)
            for fn, code in sass(out / "k3" / f"{name}.so").items()))
    fns = {"add_ln_payload": {n: entry(lib, "add_ln_payload")
                              for n, lib in built[0].items()},
           "flex_add_ln": {n: entry(lib, "flex_add_ln")
                           for n, lib in built[1].items()}}
    dev = torch.device("cuda")
    m, h, eps = 16384, 768, 1e-12
    y8, r8, y, r, gb, lnv = (torch.from_numpy(a).to(dev)
                             for a in CS.ln_inputs(m, h, seed=5))
    scal = {k: torch.tensor([v], dtype=torch.float32, device=dev)
            for k, v in (("scalar8", CS.LN_SCAL8),
                         ("scalar16", CS.LN_SCAL16))}
    scal["peg"] = scal["scalar8"]
    st = lambda: torch.cuda.current_stream().cuda_stream
    per_layer = {}
    for tag, src, res, sites, outs, launches in LN_CALLS:
        sc = scal[sites]
        lv = lnv if sites == "peg" else None
        bits = 8 if sites == "scalar8" else 16
        o8 = torch.empty((m, h), device=dev, dtype=torch.int8)
        of = torch.empty((m, h), device=dev, dtype=torch.float32)
        rv = r8 if res == "i8" else r
        if src == "add_ln_payload":
            want = [EK.fused_add_ln_payload_ref(y8, r8, gb, sc, eps=eps)]
            nbytes = 3 * m * h
        elif outs == ("i8", "f"):
            want = list(EK.fused_add_ln_ref(y, r, gb, sc, eps=eps))
            nbytes = m * h * (4 + 4 + 1 + 4)
        else:
            want = [EK.flex_add_ln_ref(
                y, rv, gb, sc, lv, eps=eps, res_mode=res, res_bits=bits,
                ln_bits=8 if outs == ("i8",) else bits,
                ln_out="emit" if outs == ("i8",) else "f")]
            nbytes = m * h * (4 + rv.element_size()
                              + (1 if outs == ("i8",) else 4))
        got = [o8 if o == "i8" else of for o in outs]
        res_lo, res_hi = EK._clip_bounds(bits)
        ln_lo, ln_hi = EK._clip_bounds(8 if outs[0] == "i8" else bits)
        bnd, by = CS.bound_ms(0.0, nbytes + 2 * h * 4
                              + (4 * h * 4 if lv is not None else 32))
        line = f"  {tag} {m}x{h} (bound {bnd:.4f} ms, {by}):"
        for name, fn in fns[src].items():
            if src == "add_ln_payload":
                def call(fn=fn, name=name):
                    KB.check(fn(y8.data_ptr(), r8.data_ptr(), gb.data_ptr(),
                                sc.data_ptr(), o8.data_ptr(), m, h, eps, 1,
                                st()), name)
            else:
                def call(fn=fn, name=name):
                    KB.check(fn(
                        y.data_ptr(), rv.data_ptr(), int(res == "f"),
                        gb.data_ptr(), sc.data_ptr(),
                        lv.data_ptr() if lv is not None else None,
                        o8.data_ptr() if "i8" in outs else None,
                        of.data_ptr() if "f" in outs else None, m, h, eps,
                        1, res_lo, res_hi, ln_lo, ln_hi, st()), name)
            call()
            torch.cuda.synchronize()
            if name in LN_COMPUTES and not all(
                    torch.equal(g, w) for g, w in zip(got, want)):
                raise SystemExit(f"k1_probe: {src} {name} differs from its "
                                 f"plain version at {line}")
            t = CS.device_ms(call)
            key = ("K3" if src == "add_ln_payload" else
                   "fused_add_ln" if tag == "fused_add_ln" else
                   "K5 PEG" if sites == "peg" else "K5 mixed")
            per_layer.setdefault(key, {})
            per_layer[key][name] = (per_layer[key].get(name, 0.0)
                                    + launches * t)
            line += f" {name} {t:.4f} ms;"
        print(line, flush=True)
    for key, times in per_layer.items():
        print(f"  {key} per layer: " + "; ".join(
            f"{n} {t:.4f} ms" for n, t in times.items()), flush=True)


# K1's packed-int4 instance's variants (the module docstring)
W4_UNPACK = ("          unpack_w4(ring + s * STAGE_BYTES + TM * TK, w, 3,\n"
             "                    threadIdx.x & 31);")
W4_EDITS = {
    "kernel": [],
    "ilp1": [("constexpr int W4_ILP = 2;", "constexpr int W4_ILP = 1;")],
    "ilp4": [("constexpr int W4_ILP = 2;", "constexpr int W4_ILP = 4;")],
    "ilp6": [("constexpr int W4_ILP = 2;", "constexpr int W4_ILP = 6;")],
    "no_unpack": [(W4_UNPACK, "")],
    "no_fence": [("          fence_proxy_async();   // the writes, visible "
                  "to wgmma", "")],
    "unpack_alone": [("          wgmma_m64n128k32_s8(acc[0], da + oa, db + ob, "
                      "scale);\n          wgmma_m64n128k32_s8(acc[1], da + oa "
                      "+ (64 * 64 >> 4), db + ob,\n                         "
                      "     scale);", "")],
    "no_loads": [("        v[i] = *reinterpret_cast<const uint4*>(bh + r * 64 + "
                  "c * 16);", "        v[i] = make_uint4(r, c, lane, j0);")],
    "no_stores": [("""      *reinterpret_cast<uint4*>(b + off) =
          make_uint4((v[i].x << 4) & HI, (v[i].y << 4) & HI,
                     (v[i].z << 4) & HI, (v[i].w << 4) & HI);
      *reinterpret_cast<uint4*>(bh + off) =
          make_uint4(v[i].x & HI, v[i].y & HI, v[i].z & HI, v[i].w & HI);""",
                   """      if (((((v[i].x << 4) & HI) ^ (v[i].y & HI) ^ v[i].z ^ v[i].w)
           == 0x1234567u))
        b[off] = 1;""")],
    "two_warps": [("} else if (threadIdx.x >= 288) {",
                   "} else if (threadIdx.x >= 320) {"),
                  ("const int w = (threadIdx.x >> 5) - 9;",
                   "const int w = (threadIdx.x >> 5) - 10;"),
                  ("unpack_w4(ring + s * STAGE_BYTES + TM * TK, w, 3,",
                   "unpack_w4(ring + s * STAGE_BYTES + TM * TK, w, 2,"),
                  ("mbar_init(&unpacked[s], 96);",
                   "mbar_init(&unpacked[s], 64);")],
}
W4_COMPUTES = {"kernel", "ilp1", "ilp4", "ilp6", "two_warps"}
# the GEMM instances whose machine code a packed-int4 edit must leave
W4_SASS = ("int8_matmul.cu", "fused_int8_linear.cu", "int8_matmul_norm.cu",
           "float_edge_matmul.cu")


def probe_w4(out: Path, parent) -> None:
    """K1 w4's variants at BERT-base's shapes, M = 16384 and 256, beside K1
    int8 and ``torch._int_mm`` on the unpacked weight."""
    jobs = [("int8_matmul.cu", W4_EDITS, out / "w4", None)]
    if parent is not None:
        jobs += [(src, {"kernel": []}, out / f"w4_{Path(src).stem}", parent)
                 for src in W4_SASS]
    built = build_many(jobs)
    for src in W4_SASS if parent is not None else ():
        print(f"  {src}:", end="")
        same_sass(out / f"w4_{Path(src).stem}")
    libs = built[0]
    fns = {name: entry(lib, "int8_matmul_w4") for name, lib in libs.items()}
    int8 = entry(libs["kernel"], "int8_matmul")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    st = lambda: torch.cuda.current_stream().cuda_stream
    for m in (16384, 256):
        per_layer = dict.fromkeys([*fns, "K1 int8", "torch._int_mm"], 0.0)
        for n, k, act, mode, bits in SHAPES[:4]:
            x = torch.randint(-128, 128, (m, k), generator=gen, device=dev,
                              dtype=torch.int8)
            wp = torch.randint(0, 256, (n, k // 2), generator=gen,
                               device=dev, dtype=torch.uint8)
            w8 = IL.unpack_int4(wp, k)
            _, _, vecs, scal = inputs(1, n, 16, gen, dev)
            vecs[1] = w8.float().sum(1)
            lo, hi = EK._clip_bounds(bits)
            out8 = torch.empty((m, n), device=dev, dtype=torch.int8)
            want = EK.int8_matmul_ref(x, wp, vecs, scal, activation=act,
                                      w4=True)
            line = f"  K1 w4 {m}x{k}->{n} act={act}:"
            for name, fn in [*fns.items(), ("K1 int8", int8)]:
                w = w8 if name == "K1 int8" else wp

                def call(fn=fn, w=w, name=name):
                    KB.check(fn(x.data_ptr(), w.data_ptr(), vecs.data_ptr(),
                                scal.data_ptr(), out8.data_ptr(), m, n, k,
                                ACT[act], MODE[mode], lo, hi, GELU_NEW_C,
                                st()), name)
                call()
                torch.cuda.synchronize()
                if ((name in W4_COMPUTES or name == "K1 int8")
                        and not torch.equal(out8, want)):
                    raise SystemExit(f"k1_probe: {name} differs from "
                                     f"int8_matmul_ref(w4=True) at {line}")
                t = CS.device_ms(call)
                per_layer[name] += t
                line += f" {name} {t:.4f} ms;"
            w_t = w8.t()
            t = CS.device_ms(lambda: torch._int_mm(x, w_t))
            per_layer["torch._int_mm"] += t
            print(f"{line} torch._int_mm {t:.4f} ms", flush=True)
        print(f"  K1 w4 per layer at M = {m}: " + "; ".join(
            f"{name} {t:.4f} ms" for name, t in per_layer.items()),
            flush=True)


def probe_k9(out: Path, parent) -> None:
    """K9's variants and the parent's K9 at phase 16's call."""
    libs = build_variants("float_int8_gemm.cu", K9_EDITS, out / "k9", parent)
    print("  ptxas kernel: " + " | ".join(
        CS.ptxas_lines(LOGS["float_int8_gemm.cu", "kernel"])), flush=True)
    fns = {name: entry(lib, "float_int8_matmul") for name, lib in libs.items()}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(20)
    m, k, n = 16384, 768, 768
    x = torch.randn(m, k, generator=gen, device=dev)
    w8 = torch.randint(-128, 128, (n, k), generator=gen, device=dev,
                       dtype=torch.int8)
    vecs = torch.stack([
        torch.rand(n, generator=gen, device=dev) * 2e-3 + 1e-4,
        torch.zeros(n, device=dev),
        torch.randn(n, generator=gen, device=dev) * 0.1,
        0.02 * (1 + torch.rand(n, generator=gen, device=dev)),
        torch.full((n,), 3.0, device=dev)]).contiguous()
    bnd, by = CS.bound_ms(0.0, m * k * 4 + n * k + m * n)
    bnd = max(bnd, 2.0 * m * n * k / CS.PEAK_F64_OPS * 1e3)
    w_f = (w8.float() * vecs[0][:, None]).t().contiguous()
    x64, w64 = x.double(), w8.double().t().contiguous()
    t_f32 = CS.device_ms(lambda: torch.matmul(x, w_f))
    t_f64 = CS.device_ms(lambda: torch.matmul(x64, w64))
    st = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    for mode in ("emit", "fold", "float"):
        want = EK.float_int8_matmul_ref(x, w8, vecs, out_mode=mode)
        got = torch.empty_like(want)
        line = (f"  K9 {m}x{k}->{n} {mode} (bound {bnd:.4f} ms, operations "
                f"at the float64 tensor-core peak):")
        for name, fn in fns.items():
            def call(fn=fn, name=name):
                KB.check(fn(x.data_ptr(), w8.data_ptr(), vecs.data_ptr(),
                            got.data_ptr(), m, n, k, 0, MODE[mode], -128.0,
                            127.0, GELU_NEW_C, st()), name)
            call()
            torch.cuda.synchronize()
            if name in K9_COMPUTES:
                CS.compare_ties(got, want, CS._out_step(vecs, mode),
                                f"K9 {name} {mode}", quiet=True)
            t = CS.device_ms(call)
            line += (f" {name} {t:.4f} ms ({2.0 * m * n * k / t / 1e9:.1f} "
                     "TFLOP/s);")
        print(f"{line} torch.matmul f32 {t_f32:.4f} ms, float64 {t_f64:.4f} "
              "ms", flush=True)


def probe_flex(out: Path, parent) -> None:
    """The attention's second kernel's variants and the parent's on phase
    16's forms at BERT-base's call."""
    libs = build_variants("int8_attention.cu", FLEX_EDITS, out / "flex",
                          parent)
    for name in FLEX_EDITS:
        print(f"  ptxas {name}: " + " | ".join(
            ln for ln in CS.ptxas_lines(LOGS["int8_attention.cu", name])
            if "flex" in ln), flush=True)
    fns = {name: entry(lib, "int8_attention_flex")
           for name, lib in libs.items()}
    dev = torch.device("cuda")
    b, seq, d, nh = 128, 128, 64, 12
    qkv8, mask, scal = (torch.from_numpy(a).to(dev) for a in
                        CS.attn_inputs(b, seq, d, nh, 90, full_pad=False))
    h = nh * d
    for bits, dots in FLEX_PROBE_FORMS:
        qkv, s = CS.flex_attn_case(qkv8, scal, bits, dots)
        kw = dict(n_heads=nh, seq=seq, skip_max=True, attn_bits=bits,
                  dots=dots)
        want = EK.int8_attention_ref(qkv, mask, s, **kw)
        got = torch.empty_like(want)
        route = EK.attn_flex_route(bits, dots)
        step = (None if 1 <= bits[2] <= 8 else
                float(s[0, 10]) if bits[2] > 8 else "ulp")
        ops = 2.0 * b * nh * seq * seq * d
        f64 = ops * ((dots == "f32") + (route == "f64"))
        t_ops = ((2 * ops - f64) / CS.PEAK_INT8_OPS
                 + f64 / CS.PEAK_F64_OPS) * 1e3
        t_b = (qkv.numel() * qkv.element_size() + mask.numel() * 4
               + want.numel() * want.element_size()) / CS.PEAK_BYTES * 1e3
        line = (f"  flex {bits} {dots} route {route} B={b} T={seq} {nh}x{d} "
                f"(bound {max(t_ops, t_b):.4f} ms, "
                f"{'operations' if t_ops >= t_b else 'bytes'}):")
        for name, fn in fns.items():
            def call(fn=fn, name=name):
                KB.check(fn(qkv.data_ptr(), int(dots == "f32"),
                            mask.data_ptr(), s.data_ptr(), got.data_ptr(), b,
                            seq, h, nh, *bits, EK._rsqrt_d(d), EK.LOG2E, 1,
                            torch.cuda.current_stream().cuda_stream), name)
            call()
            torch.cuda.synchronize()
            tag = f"flex {name} {bits} {dots}"
            if route == "f64" or name == "parent":
                CS.compare_ties(got, want, step, tag, quiet=True)
            elif step is None:
                CS.compare(got, want, tag, quiet=True)
            else:
                CS.compare_values(got, want, 1.0 if step == "ulp" else step,
                                  tag, quiet=True)
            line += f" {name} {CS.device_ms(call):.4f} ms;"
        print(line, flush=True)


def opcode_counts(lib: Path, pattern: str) -> dict:
    """Per kernel of ``lib`` whose name matches ``pattern``: the count of
    each ``MMA_OPS`` opcode in its machine code."""
    out = {}
    for name, code in sass(lib).items():
        if re.search(pattern, name):
            ops = [ln.split()[1] if ln.startswith("@") else ln.split()[0]
                   for ln in code if ln]
            out[name] = {c: sum(op.split(".")[0] == c for op in ops)
                         for c in MMA_OPS}
    return out


def probe_sass(out: Path, parent) -> None:
    """Every source's machine code against the parent checkout's, kernel
    by kernel (``sass`` in ``--kernels``): the kernels a change must leave
    as they were are then those it lists as identical."""
    if parent is None:
        raise SystemExit("k1_probe: sass needs --parent")
    rel = KB.CSRC.relative_to(KB.CSRC.parents[3])
    srcs = [s for s in KB.SOURCES if (Path(parent) / rel / f"{s}.cu").exists()]
    build_many([(f"{s}.cu", {"kernel": []}, out / f"sass_{s}", parent)
                for s in srcs])
    for s in srcs:
        print(f"  {s}.cu:", end="")
        same_sass(out / f"sass_{s}")
    # (sass() takes the namespace tag out with a hex run that may take a
    # name's first letters: match on the rest)
    for src, pattern in (("float_int8_gemm", "int8_kernel"),
                         ("int8_attention", "flex_(i8|f32)_kernel")):
        for name, counts in opcode_counts(
                out / f"sass_{src}" / "kernel.so", pattern).items():
            print(f"  {src}.cu {name}: " + ", ".join(
                f"{c} {n}" for c, n in counts.items()), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="k1_probe_build")
    ap.add_argument("--parent", default=None,
                    help="an unpacked checkout whose K1 and K6 to time "
                         "beside")
    ap.add_argument("--build-only", action="store_true",
                    help="mb: build the variants and print ptxas's lines")
    ap.add_argument("--kernels", default="k1,norm",
                    help="which of k1, norm, edge, attn, ln, mb, w4, sass, "
                         "k9, flex to probe")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k1_probe: needs a card")
    print(CS.nvidia_smi_line(), flush=True)
    kernels = set(args.kernels.split(","))
    if "norm" in kernels:
        probe_norm(Path(args.out), args.parent)
    if "edge" in kernels:
        probe_edge(Path(args.out), args.parent)
    if "attn" in kernels:
        probe_attn(Path(args.out), args.parent)
    if "ln" in kernels:
        probe_ln(Path(args.out), args.parent)
    if "mb" in kernels:
        probe_mb(Path(args.out), args.parent, args.build_only)
    if "w4" in kernels:
        probe_w4(Path(args.out), args.parent)
    if "sass" in kernels:
        probe_sass(Path(args.out), args.parent)
    if "k9" in kernels:
        probe_k9(Path(args.out), args.parent)
    if "flex" in kernels:
        probe_flex(Path(args.out), args.parent)
    if "k1" not in kernels:
        return 0
    fns = {name: entry(lib, "int8_matmul") for name, lib in build_variants(
        "int8_matmul.cu", EDITS, Path(args.out), args.parent).items()}
    if args.parent:
        same_sass(Path(args.out))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    m = 16384
    for n, k, act, mode, bits in SHAPES:
        x, w, vecs, scal = inputs(m, n, k, gen, dev)
        lo, hi = EK._clip_bounds(bits)
        out = torch.empty((m, n), device=dev, dtype=torch.int8
                          if mode == "emit" else torch.float32)
        want = EK.int8_matmul_ref(x, w, vecs, scal, activation=act,
                                  out_mode=mode, out_bits=bits)
        ops = 2.0 * m * n * k
        line = f"  {m}x{k}->{n} act={act} {mode} {bits}-bit:"
        for name, fn in fns.items():
            def call(fn=fn):
                err = fn(x.data_ptr(), w.data_ptr(), vecs.data_ptr(),
                         scal.data_ptr(), out.data_ptr(), m, n, k, ACT[act],
                         MODE[mode], lo, hi, GELU_NEW_C,
                         torch.cuda.current_stream().cuda_stream)
                KB.check(err, name)
            call()
            torch.cuda.synchronize()
            if name in COMPUTES and not torch.equal(out, want):
                raise SystemExit(f"k1_probe: {name} differs from "
                                 f"int8_matmul_ref at {line}")
            t = CS.device_ms(call)
            line += f" {name} {t:.4f} ms ({ops / t / 1e9:.0f} TOP/s);"
        w_t = w.t()
        t = CS.device_ms(lambda: torch._int_mm(x, w_t))
        print(f"{line} torch._int_mm {t:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
