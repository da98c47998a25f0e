"""Kernels of the full-handoff int8 engine: plain versions and wrappers.

Counterpart of ``transformer_quantization_tpu/ops/pallas/engine_kernels.py``.
Activations travel between matmuls as int8 payloads: value
``s * (p + shift)``, ``shift = 128 - zero_point`` for asymmetric sites.

The wrappers here launch kernels written by hand for Hopper (``csrc/``):

- :func:`int8_matmul` -- payload matmul with the dequant fold, bias, an
  optional activation (every key of the JAX ``_ACTS``: ``gelu_new``,
  ``relu``, ``gelu`` (A-S erf), ``gelu_poly10``, ``tanh``), and a
  per-column output site (``emit`` int8 payload, ``fold`` fake-quantized
  float on an ``out_bits`` grid, or raw ``float``; fold and float also in
  bfloat16, ``out_dtype``, with no activation), against an int8 weight
  or (``w4``) a split-half packed int4 one, unpacked inside the kernel;
- :func:`int8_matmul_norm` -- the same matmul with MobileBERT's whole
  elementwise tail in its epilogue: fold site, optional + residual
  payload, res site, NoNorm, norm-site payload (also the ``nonorm`` forms
  of :func:`int8_matmul_add_ln` and :func:`int8_ffn_ln`), against an
  int8 or (``w4``) a packed int4 weight;
- :func:`int8_attention_qkv` -- scores, scores site, exp2 softmax, probs
  payload, probs @ v and the context payload, per (batch row, head), over
  q, k and v picked from up to three arrays by ``cols``;
  :func:`int8_attention` is its instance over one fused q|k|v array, and
  launches its second kernel (:func:`int8_attention_flex`) for every other
  form: scores / probs / context sites of 2-16 bits or disabled (bits 0),
  a float32 context value edge out, and the value-space form of float32
  q / k / v values (``dots='f32'``);
- :func:`int8_mb_layer_ln` -- a whole MobileBERT layer in one launch over
  tiles of whole sequences, every intermediate payload in shared memory,
  its elements through the same device functions as the three kernels
  above, any of its matmuls on a packed int4 weight (``w4``);
- :func:`fused_add_ln_payload` -- payload + payload residual add, res
  site, one-pass LayerNorm, ln payload;
- :func:`fused_add_ln` -- float32 y + float32 residual, res site,
  LayerNorm, and both the ln payload and its float value: the add+LN of
  the engine's non-payload residual route (a disabled fold site), an
  instance of the :func:`flex_add_ln` kernel; at ``out_dtype`` bfloat16
  (``engine_dtype`` bf16) its bfloat16 y / residual / value form;
- :func:`float_edge_matmul` -- the matmul of a float value edge (a 16-bit
  or per-column site of the mixed / PEG recipes, a 16-bit or sub-8 layer
  input, inter or context edge) against an int8 weight, contracted
  exactly on int8 tensor cores from the edge's grid levels, with optional
  ``gelu_new`` (or, emitted or folded, ``gelu`` / ``gelu_poly10`` /
  ``tanh``) and an emitted int8 payload, a fold on a 2-16-bit grid or the
  raw float out (also bfloat16): a level pass (:func:`float_edge_levels`)
  then a GEMM on its levels (:func:`float_edge_gemm`);
- :func:`float_int8_matmul` -- the matmul of a float edge on no grid (the
  disabled context site's raw value) against an int8 weight, products
  summed in float64 and rounded once;
- :func:`flex_add_ln` -- float32 y + payload or float residual, res and
  ln sites per tensor or per column (``lnv``) on 8- or 16-bit grids,
  LayerNorm, and an int8 payload or a float value edge out.

An H100 SM cannot hold whole weight matrices the way the TPU kernels held
them in VMEM, so the TPU's fused forms are thin compositions here with the
JAX signatures; the JAX package states each fused form bit-identical to
the chain: :func:`int8_matmul_add_ln` = matmul(emit on the fold site) ->
add+LN; :func:`int8_layer_ln` = qkv matmul -> attention -> matmul_add_ln
-> inter matmul(act, emit) -> matmul_add_ln, seven launches per all-int8
encoder layer. The flex forms of the mixed and PEG recipes:
:func:`int8_attn_ln` = qkv matmul -> attention -> attn_out matmul (fold)
-> flex add+LN, and :func:`int8_ffn_ln` = inter matmul (float-edge or
payload) -> dense matmul (fold) -> flex add+LN. With ``norm='nonorm'``
(MobileBERT) the tail needs no row reduction and rides the matmul
epilogue: :func:`int8_matmul_add_ln` is one :func:`int8_matmul_norm`
launch and :func:`int8_ffn_ln` two. MobileBERT's layer fits one block's
shared memory at its widths, so :func:`int8_mb_layer_ln` is one kernel;
:func:`mb_layer_chain` is the same layer as a chain of the kernels above,
and its plain form is :func:`int8_mb_layer_ln_ref`.

Each ``*_ref`` repeats the JAX ``*_ref`` operation for operation (same
association order, division where it divides), with one deliberate
difference: the row sums of the softmax and of LayerNorm accumulate in
float64 and round once to float32, and LayerNorm takes ``1 / sqrt`` (both
IEEE-rounded) for ``rsqrt``; the float-edge contraction, which JAX
computes as a float32 dot product, is the exact integer contraction of
the edge's grid levels (:func:`float_edge_matmul_ref`); and every other
float dot product of JAX's (the value-space attention's q.k and p.v, p.v
on 16-bit or raw probabilities, a float edge on no grid) sums its
products in float64 and rounds once to float32 (:func:`_f64_matmul`:
each product of two float32 values, or of a float32 and an int8, is
exact in float64, so only the float64 sum's rounding depends on the
order, some 2^-29 of a float32 step). The result then
does not depend on the summation order or the device, so the kernels,
which do the same, agree with these versions bit for bit; against the
JAX oracles (float32 sums) a payload may sit one level off on rare
elements. A wrapper runs the
plain version for a tensor on the CPU; for a CUDA tensor it launches its
kernel or raises. :data:`LAUNCHES` counts kernel launches per wrapper.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import numpy as np
import torch

from transformer_quantization_tpu_torch.ops.int_linear import (
    exact_int_matmul,
    unpack_int4,
)
from transformer_quantization_tpu_torch.ops.kernels import build as KB
from transformer_quantization_tpu_torch.ops.kernels.activations import (
    ACTS,
    GELU_NEW_C,
)

Tensor = torch.Tensor

# kernel launches per wrapper; a wrapper adds one only where it launches
LAUNCHES: Dict[str, int] = {"int8_matmul": 0, "int8_matmul_w4": 0,
                            "int8_attention": 0,
                            "fused_add_ln_payload": 0,
                            "float_edge_matmul": 0, "flex_add_ln": 0,
                            "int8_matmul_norm": 0, "int8_attention_qkv": 0,
                            "int8_mb_layer_ln": 0, "fused_add_ln": 0,
                            "int8_matmul_norm_w4": 0,
                            "int8_mb_layer_ln_w4": 0,
                            "fused_int8_linear": 0,
                            "fused_int8_linear_w4": 0,
                            "fused_linear_quantize": 0,
                            "float_edge_levels": 0,
                            "float_edge_matmul_fold": 0,
                            "int8_attention_flex": 0,
                            "float_int8_matmul": 0}

LOG2E = float(np.float32(np.log2(np.e)))


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Payload helpers
# ---------------------------------------------------------------------------


def quantize_payload(x: Tensor, s, shift) -> Tensor:
    """float -> int8 payload of a per-tensor 8-bit site."""
    r = torch.round(x.to(torch.float32) * (1.0 / s)) - shift
    return torch.clamp(r, -128.0, 127.0).to(torch.int8)


def dequantize_payload(p: Tensor, s, shift) -> Tensor:
    """int8 payload -> float site value."""
    return s * (p.to(torch.float32) + shift)


def _clip_bounds(bits: int) -> Tuple[float, float]:
    """Payload-grid clip bounds of a ``bits``-bit site."""
    half = float(2 ** (bits - 1))
    return -half, half - 1.0


def fakequant_f32(x: Tensor, s, shift, lo: float = -128.0,
                  hi: float = 127.0) -> Tensor:
    """Fake-quant through the payload grid."""
    r = torch.clamp(torch.round(x * (1.0 / s)) - shift, lo, hi)
    return s * (r + shift)


def _row_sum(x: Tensor) -> Tensor:
    """Sum over the last dim, accumulated in float64, rounded once to
    float32: independent of the summation order."""
    return torch.sum(x.to(torch.float64), dim=-1, keepdim=True).to(
        torch.float32)


def _row_mean(x: Tensor) -> Tensor:
    """:func:`_row_sum` over the row length, a true float32 division on
    every device (the length is a 0-d tensor: PyTorch's CUDA kernels turn
    division by a Python number into multiplication by its reciprocal)."""
    return _row_sum(x) / torch.full((), float(x.shape[-1]), device=x.device)


def _attn3(attn_bits) -> Tuple[int, int, int]:
    ab = tuple(attn_bits)
    return (ab[0], ab[1], ab[2] if len(ab) > 2 else 8)


def _require_w8(w4: bool, what: str) -> None:
    """Int4 weights where the port has no w4 form yet: the float-edge
    matmul (K4), ROADMAP.md section 2a."""
    if w4:
        raise NotImplementedError(f"{what}: int4 weights (w4) are not yet "
                                  "ported (ROADMAP.md section 2a)")


def _out_site(y, vecs, activation, out_mode, out_bits,
              out_dtype=torch.float32):
    """Activation and the per-column output site of a matmul (rows 3/4
    of ``vecs``), on an ``out_bits`` grid; a float or fold output in
    ``out_dtype`` (the JAX ``out_dtype``: float32, or bfloat16 at the
    engine's ``engine_dtype`` bf16, rounded to nearest even)."""
    if out_mode == "emit" and out_bits != 8:
        raise ValueError("an emitted payload is 8-bit (out_bits=8)")
    act = ACTS[activation]
    if act is not None:
        y = act(y)
    if out_mode == "float":
        return y.to(out_dtype)
    lo, hi = _clip_bounds(out_bits)
    r = torch.clamp(torch.round(y / vecs[3]) - vecs[4], lo, hi)
    if out_mode == "emit":
        return r.to(torch.int8)
    return (vecs[3] * (r + vecs[4])).to(out_dtype)


# ---------------------------------------------------------------------------
# Plain versions (mirrors of the JAX *_ref oracles)
# ---------------------------------------------------------------------------


def int8_matmul_ref(x8, w8, vecs, scalars, *, activation=None,
                    out_mode="emit", w4=False, in_mode="i8", out_bits=8,
                    in_grid=None, out_dtype=torch.float32):
    """``act(s_x s_w (x8 @ w8^T + shift colsum) + b)`` then the per-column
    output site. ``vecs`` rows: [wscale, colsum, bias, out_s, out_shift];
    ``scalars``: (1, 2) [in_s, in_shift]. ``w4``: ``w8`` is the (N, K/2)
    split-half packed int4 weight, unpacked first (the JAX
    ``int8_matmul_ref``). ``in_mode='f'``: ``x8`` is a float value edge,
    carrying its own scale (``scalars`` unused): on the grid ``in_grid``
    (:func:`edge_grid`) the product is :func:`float_edge_matmul_ref`'s,
    on no grid (``in_grid`` None: the disabled context site's raw value)
    :func:`float_int8_matmul_ref`'s. A float or fold output is in
    ``out_dtype``."""
    if in_mode == "f":
        _require_w8(w4, "int8_matmul(in_mode='f')")
        if in_grid is None:
            return float_int8_matmul_ref(x8, w8, vecs, activation=activation,
                                         out_mode=out_mode, out_bits=out_bits,
                                         out_dtype=out_dtype)
        _check_grid_weight(in_grid, w8)
        return float_edge_matmul_ref(x8, vecs, in_grid,
                                     activation=activation,
                                     out_mode=out_mode, out_bits=out_bits,
                                     out_dtype=out_dtype)
    if in_mode != "i8":
        raise ValueError(f"unknown in_mode {in_mode!r}")
    if w4:
        w8 = unpack_int4(w8, x8.shape[1])
    acc = exact_int_matmul(x8, w8).to(torch.float32)
    in_s, in_shift = scalars[0, 0], scalars[0, 1]
    y = (in_s * vecs[0]) * (acc + in_shift * vecs[1]) + vecs[2]
    return _out_site(y, vecs, activation, out_mode, out_bits, out_dtype)


def _f64_matmul(a: Tensor, b: Tensor) -> Tensor:
    """``a @ b`` of float32 (or int8-valued) operands with the products
    summed in float64 and rounded once to float32: each product is exact in
    float64 (24 + 24 bits at most), so the result is the float32 rounding
    of the exact sum but where the float64 sum's own rounding (some 2^-29
    of a float32 step) meets a tie."""
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(
        torch.float32)


def float_int8_matmul_ref(x, w8, vecs, *, activation=None, out_mode="emit",
                          out_bits=8, out_dtype=torch.float32):
    """The matmul of a float edge on no grid (JAX ``_f_dot`` with
    ``_mm_body(in_mode='f')``): ``act(wscale * (x @ w8^T) + b)`` then the
    output site, ``x @ w8^T`` summed in float64 (:func:`_f64_matmul`)
    where JAX sums in float32."""
    y = vecs[0] * _f64_matmul(x.to(torch.float32), w8.t()) + vecs[2]
    return _out_site(y, vecs, activation, out_mode, out_bits, out_dtype)


def edge_grid(w8: Tensor, s: Tensor, zp: Tensor, bits: int,
              n_groups: int, cols: Tensor) -> Dict:
    """The grid of a float value edge ``x[:, k] = s_k * (q_k - zp_k)``
    (``q_k`` an integer level in [0, 2^bits - 1]) consumed by the weight
    ``w8`` (N, K): the K columns taken in the order ``cols`` fall into
    ``n_groups`` equal groups, each with one scale and zero point (one
    group for a per-tensor site; a PEG site's groups in its permutation
    order). Carries the weight's columns in that order and their per-group
    int32 column sums, for :func:`float_edge_matmul_ref` and its kernel."""
    k = w8.shape[1]
    if k % n_groups:
        raise ValueError(f"{k} columns do not split into {n_groups} groups")
    size = k // n_groups
    cols = cols.to(torch.int64)
    s_c = torch.broadcast_to(s.reshape(-1), (k,))[cols].reshape(n_groups,
                                                                size)
    z_c = torch.broadcast_to(zp.reshape(-1), (k,))[cols].reshape(n_groups,
                                                                 size)
    if not (torch.equal(s_c, s_c[:, :1].expand_as(s_c))
            and torch.equal(z_c, z_c[:, :1].expand_as(z_c))):
        raise ValueError("edge grid: the site's params vary inside a group")
    if not bool(((z_c >= 0) & (z_c <= 2 ** bits - 1)).all()):
        raise ValueError(f"edge grid: a zero point off the {bits}-bit grid")
    # the identity order (a per-tensor site) takes the weight as it is
    same = torch.equal(cols, torch.arange(k, device=cols.device))
    wp = w8 if same else w8[:, cols].contiguous()
    s_g = s_c[:, 0].to(torch.float32).contiguous()
    return {"cols": cols.contiguous(), "bits": int(bits), "s": s_g,
            "inv_s": (1.0 / s_g).contiguous(),
            "zp": z_c[:, 0].to(torch.float32).contiguous(), "w": wp,
            "gcs": wp.to(torch.int32).reshape(wp.shape[0], n_groups, size)
            .sum(dim=-1).to(torch.int32).t().contiguous()}


def _check_grid_weight(grid, w8) -> None:
    if grid is None:
        raise ValueError("in_mode='f' needs the input edge's grid "
                         "(in_grid / x_grid, see edge_grid)")
    if tuple(grid["w"].shape) != tuple(w8.shape):
        raise ValueError(f"edge grid weight {tuple(grid['w'].shape)} does "
                         f"not match the weight {tuple(w8.shape)}")


def edge_levels(x: Tensor, grid: Dict) -> Tensor:
    """The float edge's integer grid levels, columns in group order:
    ``clip(rint(x / s_g) + zp_g, 0, 2^bits - 1)`` with ``x * (1 / s_g)``
    for the division. Exact for on-grid values of up to 16 bits: the
    product's relative error is at most ~2^-23, under half a level for
    |q - zp| < 2^16."""
    g = grid["s"].numel()
    size = x.shape[1] // g
    xp = x.to(torch.float32).index_select(1, grid["cols"])
    inv = torch.repeat_interleave(grid["inv_s"], size)
    zp = torch.repeat_interleave(grid["zp"], size)
    return torch.clamp(torch.round(xp * inv) + zp, 0.0,
                       float(2 ** grid["bits"] - 1))


def float_edge_matmul_ref(x, vecs, grid, *, activation=None,
                          out_mode="emit", out_bits=8,
                          out_dtype=torch.float32):
    """The float-edge matmul ``act(wscale * (x @ w^T) + b)`` then the
    output site, with the product taken exactly: per group g,
    ``acc_g = q_g @ w_g^T - zp_g * colsum_g`` in integers (float64 holds
    every partial sum: |acc| < 2^53), then ``x @ w^T = sum_g s_g *
    f32(acc_g)``, summed in group order. The JAX oracle's float32 dot
    product differs from it by float32 rounding only."""
    q = edge_levels(x, grid).to(torch.float64)
    wp = grid["w"].to(torch.float64)
    g = grid["s"].numel()
    size = q.shape[1] // g
    y = None
    for i in range(g):
        cols = slice(i * size, (i + 1) * size)
        acc = (torch.matmul(q[:, cols], wp[:, cols].t())
               - grid["zp"][i].to(torch.float64)
               * grid["gcs"][i].to(torch.float64))
        t = grid["s"][i] * acc.to(torch.float32)
        y = t if y is None else y + t
    y = vecs[0] * y + vecs[2]
    return _out_site(y, vecs, activation, out_mode, out_bits, out_dtype)


def edge_planes(grid: Dict) -> int:
    """Bytes of an edge level: 1 up to 8 bits, 2 (lo, hi) up to 16."""
    return 1 if grid["bits"] <= 8 else 2


def _edge_shift(planes: int) -> int:
    """What the stored s8 bytes (byte - 128) take off a level: 128, or
    256 * 128 + 128 for two planes."""
    return 128 if planes == 1 else 256 * 128 + 128


def float_edge_levels_ref(x: Tensor, grid: Dict) -> Tensor:
    """The level pass of :func:`float_edge_matmul`: :func:`edge_levels` in
    group order as int8 bytes ``byte - 128``. Up to 8 bits an (M, K)
    array; 16 bits (2 Mp, K), Mp = M rounded up to 64, where 64-row panel
    p holds its levels' low bytes in rows 128 p.. 128 p + 63 and their
    high bytes in the next 64 (rows past M are 0)."""
    q = edge_levels(x, grid).to(torch.int32)
    if edge_planes(grid) == 1:
        return (q - 128).to(torch.int8)
    m, k = q.shape
    mp = -(-m // 64) * 64
    lo, hi = q.new_zeros((mp, k)), q.new_zeros((mp, k))
    lo[:m], hi[:m] = (q & 255) - 128, (q >> 8) - 128
    return torch.stack([lo.view(-1, 64, k), hi.view(-1, 64, k)],
                       1).reshape(2 * mp, k).to(torch.int8)


def float_edge_gemm_ref(lv: Tensor, m: int, vecs, grid, *, activation=None,
                        out_mode="emit", out_bits=8,
                        out_dtype=torch.float32):
    """The GEMM of :func:`float_edge_matmul` on the level pass's bytes
    ``lv`` (:func:`float_edge_levels_ref`) of ``m`` rows: per group g the
    exact integer sums of the stored bytes, ``acc'`` (``acc_lo`` /
    ``acc_hi`` for two planes), with the shift folded into the
    correction, ``acc_g = acc' + (128 - zp_g) colsum_g`` or ``acc_lo +
    256 acc_hi + (256 * 128 + 128 - zp_g) colsum_g``; then as
    :func:`float_edge_matmul_ref` from ``acc_g``."""
    planes = edge_planes(grid)
    k = lv.shape[1]
    if planes == 1:
        b = [lv[:m].to(torch.float64)]
    else:
        p = lv.view(-1, 2, 64, k)
        b = [p[:, i].reshape(-1, k)[:m].to(torch.float64) for i in (0, 1)]
    wp = grid["w"].to(torch.float64)
    g = grid["s"].numel()
    size = k // g
    y = None
    for i in range(g):
        cols = slice(i * size, (i + 1) * size)
        acc = [torch.matmul(bi[:, cols], wp[:, cols].t()) for bi in b]
        acc = acc[0] if planes == 1 else acc[0] + 256.0 * acc[1]
        acc = acc + ((_edge_shift(planes) - grid["zp"][i].to(torch.float64))
                     * grid["gcs"][i].to(torch.float64))
        t = grid["s"][i] * acc.to(torch.float32)
        y = t if y is None else y + t
    y = vecs[0] * y + vecs[2]
    return _out_site(y, vecs, activation, out_mode, out_bits, out_dtype)


def _emit_ctx(ctx, pv_over_c, c_s, c_sh, c_bits: int):
    """The context site from the float context sum (JAX ``_emit_ctx``):
    1-8 bits an int8 payload; 9-16 bits a float value edge on the site's
    grid, ``c_s * clip(rint(ctx * pv_over_c), c_sh - half, c_sh + half -
    1)``; disabled (bits 0, identity c_s / c_sh) the raw float value
    ``ctx * pv_over_c``."""
    if c_bits == 0:
        return ctx * pv_over_c
    if c_bits > 8:
        half = float(2 ** (c_bits - 1))
        return c_s * torch.clamp(torch.round(ctx * pv_over_c), c_sh - half,
                                 c_sh + half - 1.0)
    lo, hi = _clip_bounds(c_bits)
    return torch.clamp(torch.round(ctx * pv_over_c) - c_sh, lo, hi).to(
        torch.int8)


def _check_attn_bits(attn_bits) -> Tuple[int, int, int]:
    bits = _attn3(attn_bits)
    if any(not 0 <= b <= 16 for b in bits):
        raise ValueError(f"attention sites of {bits} bits: each is 1-16 "
                         "bits or disabled (0)")
    return bits


def int8_attention_ref(qkv8, mask_bias, scalars, *, n_heads, seq,
                       skip_max=False, attn_bits=(8, 8), dots="i8"):
    """Attention over the fused q|k|v edge: scores -> scores site -> 1/sqrt(d)
    + mask -> exp2 softmax -> probs site -> probs @ v -> context site, the
    JAX ``int8_attention_ref``. ``scalars`` (1, 12): [q_s, q_sh, k_s, k_sh,
    v_s, v_sh, sc_s, sc_sh, p_s, p_sh, c_s, c_sh]; ``attn_bits`` the
    (scores, probs, context) sites' bits, 0 for a disabled site.
    ``dots='i8'``: int8 payloads, integer q.k with rank-1 shift
    corrections; ``'f32'``: float32 q / k / v values with identity site
    scalars (the value-space form of 16-bit, sub-8 or per-column q / k / v
    sites), q.k a float dot. probs @ v is the integer product with
    corrections for a 1-8-bit probs site on payloads, else a float dot on
    the probs (shifted grid levels, or the raw softmax at bits 0) and v's
    values (``v8 + v_sh``). Float dots sum in float64
    (:func:`_f64_matmul`). Returns the (M, H) context: an int8 payload for
    a 1-8-bit site, else float32 values (:func:`_emit_ctx`)."""
    sc_bits, p_bits, c_bits = _check_attn_bits(attn_bits)
    if dots not in ("i8", "f32"):
        raise ValueError(f"unknown dots {dots!r}")
    mt, h3 = qkv8.shape
    h = h3 // 3
    d = h // n_heads
    b = mt // seq
    s = scalars[0]
    q8, k8, v8 = (qkv8[:, i * h:(i + 1) * h].reshape(b, seq, n_heads, d)
                  for i in range(3))
    if dots == "f32":
        scr = _f64_matmul(q8.permute(0, 2, 1, 3), k8.permute(0, 2, 3, 1))
    else:
        acc = exact_int_matmul(q8.permute(0, 2, 1, 3),
                               k8.permute(0, 2, 1, 3)).to(torch.float32)
        qsum = torch.sum(q8.to(torch.float32), dim=-1)  # (b, T, n)
        ksum = torch.sum(k8.to(torch.float32), dim=-1)
        scr = (acc + s[1] * ksum.permute(0, 2, 1)[:, :, None, :]
               + s[3] * qsum.permute(0, 2, 1)[:, :, :, None]
               + d * s[1] * s[3])
    rsqrt_d = _rsqrt_d(d)
    if sc_bits == 0:
        # the scores site disabled: the dequantized raw scores
        s2 = ((s[0] * s[2] * rsqrt_d * LOG2E) * scr
              + mask_bias[:, None, None, :] * LOG2E)
    else:
        qk_over_sc = s[0] * s[2] * (1.0 / s[6])
        a = s[6] * rsqrt_d * LOG2E
        mask2 = mask_bias[:, None, None, :] * LOG2E + a * s[7]
        lo_sc, hi_sc = _clip_bounds(sc_bits)
        r = torch.clamp(torch.round(scr * qk_over_sc) - s[7], lo_sc, hi_sc)
        s2 = a * r + mask2
    if skip_max:
        e = torch.exp2(s2)
    else:
        m = torch.amax(s2, dim=-1, keepdim=True)
        e = torch.exp2(s2 - m)
    denom = _row_sum(e)
    pv_over_c = s[8] * s[4] * (1.0 / s[10])
    if p_bits == 0 or p_bits > 8 or dots == "f32":
        if p_bits == 0:
            pf = e * (1.0 / denom)
        elif p_bits > 8:
            half = float(2 ** (p_bits - 1))
            pf = torch.clamp(torch.round(e * ((1.0 / s[8]) / denom)),
                             s[9] - half, s[9] + half - 1.0)
        else:
            lo_p, hi_p = _clip_bounds(p_bits)
            pf = torch.clamp(torch.round(e * ((1.0 / s[8]) / denom)),
                             s[9] + lo_p, s[9] + hi_p)
        vf = v8.to(torch.float32) + s[5]
        ctx = _f64_matmul(pf, vf.permute(0, 2, 1, 3)).permute(0, 2, 1, 3)
        return _emit_ctx(ctx, pv_over_c, s[10], s[11], c_bits).reshape(mt, h)
    lo_p, hi_p = _clip_bounds(p_bits)
    p8 = torch.clamp(torch.round(e * ((1.0 / s[8]) / denom)) - s[9],
                     lo_p, hi_p).to(torch.int8)
    acc2 = exact_int_matmul(p8, v8.permute(0, 2, 3, 1)).to(torch.float32)
    acc2 = acc2.permute(0, 2, 1, 3)                   # (b, T, n, d)
    vsum = torch.sum(v8.to(torch.float32), dim=1)     # (b, n, d)
    psum = torch.sum(p8.to(torch.float32), dim=-1)    # (b, n, T)
    ctx = (acc2 + s[9] * vsum[:, None, :, :]
           + s[5] * psum.permute(0, 2, 1)[:, :, :, None]
           + seq * s[9] * s[5])
    return _emit_ctx(ctx, pv_over_c, s[10], s[11], c_bits).reshape(mt, h)


def int8_attention_qkv_ref(q_arr, k_arr, v_arr, mask_bias, scalars, *,
                           n_heads, seq, hidden, cols=(0, 0, 0),
                           skip_max=False, attn_bits=(8, 8)):
    """:func:`int8_attention_ref` over separate q, k, v payload arrays:
    ``cols[i]`` picks the ``hidden``-wide column block of each (MobileBERT:
    q and k are the halves of one fused [q | k] matmul, v its own)."""
    qkv = torch.cat([a[:, c * hidden:(c + 1) * hidden]
                     for a, c in zip((q_arr, k_arr, v_arr), cols)], dim=1)
    return int8_attention_ref(qkv, mask_bias, scalars, n_heads=n_heads,
                              seq=seq, skip_max=skip_max,
                              attn_bits=attn_bits)


def _ln_body_ref(x, gb, sv, *, eps, res_quant, res_bits=8, ln_bits=8,
                 norm="layernorm"):
    """res-site fake-quant -> one-pass LayerNorm (or MobileBERT's NoNorm
    ``x * gamma_q + beta_q``) -> ln-site levels. ``sv`` = (res_s, res_sh,
    ln_s, ln_sh): scalars, or (1, H) per-column rows of PEG sites;
    ``res_bits`` / ``ln_bits`` are the two sites' grids."""
    res_s, res_sh, ln_s, ln_sh = sv
    if res_quant:
        lo, hi = _clip_bounds(res_bits)
        x = fakequant_f32(x, res_s, res_sh, lo, hi)
    if norm == "nonorm":
        z = x * gb[0] + gb[1]
    elif norm == "layernorm":
        mean = _row_mean(x)
        ms = _row_mean(x * x)
        var = torch.clamp(ms - mean * mean, min=0.0)
        z = (x - mean) * (1.0 / torch.sqrt(var + eps)) * gb[0] + gb[1]
    else:
        raise ValueError(f"unknown norm {norm!r}")
    lo, hi = _clip_bounds(ln_bits)
    return torch.clamp(torch.round(z / ln_s) - ln_sh, lo, hi)


def _ln_ref_body(x, gb, s, *, eps, res_quant, norm="layernorm"):
    return _ln_body_ref(x, gb, (s[4], s[5], s[6], s[7]), eps=eps,
                        res_quant=res_quant, norm=norm)


def fused_add_ln_ref(y, r, gb, scalars, *, eps, res_quant=True,
                     out_dtype=torch.float32):
    """Float add -> res site -> LayerNorm -> ln site: ``(int8 payload,
    ln_s * (level + ln_sh))``, the float value in ``out_dtype``. ``y``,
    ``r``: (M, H) float32 or (engine_dtype bf16) bfloat16, added in
    float32; ``scalars`` (1, 8) as :func:`fused_add_ln_payload_ref`'s, of
    which [0:4] are unused."""
    s = scalars[0]
    x = y.to(torch.float32) + r.to(torch.float32)
    q = _ln_ref_body(x, gb, s, eps=eps, res_quant=res_quant)
    return q.to(torch.int8), (s[6] * (q + s[7])).to(out_dtype)


def fused_add_ln_payload_ref(y8, r8, gb, scalars, *, eps, res_quant=True):
    """Payload add -> res site -> LayerNorm -> ln payload. ``scalars``
    (1, 8): [y_s, y_sh, r_s, r_sh, res_s, res_sh, ln_s, ln_sh]."""
    s = scalars[0]
    x = (s[0] * (y8.to(torch.float32) + s[1])
         + s[2] * (r8.to(torch.float32) + s[3]))
    return _ln_ref_body(x, gb, s, eps=eps, res_quant=res_quant).to(
        torch.int8)


def flex_add_ln_ref(y, r, gb, scalars, lnv=None, *, eps, res_quant=True,
                    res_mode="i8", res_bits=8, ln_bits=8, ln_out="emit",
                    norm="layernorm"):
    """Float y + residual -> res site -> LayerNorm (or NoNorm) -> ln
    site: the add+LN tail of the JAX flex forms (``_ffn_kernel`` /
    ``_attn_mega_kernel``). ``r``: int8 payload with ``scalars[0, 2:4]``
    (``res_mode='i8'``) or the float site value itself (``'f'``). Sites:
    ``scalars[0, 4:8]``, or the (4, H) per-column rows ``lnv`` [res_s;
    res_sh; ln_s; ln_sh]. ``ln_out``: ``'emit'`` int8 payload or ``'f'``
    the float value edge ``ln_s * (level + ln_sh)``."""
    s = scalars[0]
    if res_mode == "i8":
        x = y + s[2] * (r.to(torch.float32) + s[3])
    elif res_mode == "f":
        x = y + r.to(torch.float32)
    else:
        raise ValueError(f"unknown res_mode {res_mode!r}")
    sv = ((lnv[0:1], lnv[1:2], lnv[2:3], lnv[3:4]) if lnv is not None
          else (s[4], s[5], s[6], s[7]))
    q = _ln_body_ref(x, gb, sv, eps=eps, res_quant=res_quant,
                     res_bits=res_bits, ln_bits=ln_bits, norm=norm)
    if ln_out == "emit":
        if ln_bits != 8:
            raise ValueError("an emitted payload is 8-bit (ln_bits=8)")
        return q.to(torch.int8)
    if ln_out != "f":
        raise ValueError(f"unknown ln_out {ln_out!r}")
    return sv[2] * (q + sv[3])


def int8_matmul_add_ln_ref(x8, w8, vecs, scalars, r8, gb, ln_scalars, *,
                           eps, res_quant=True, w4=False, norm="layernorm",
                           in_mode="i8", in_grid=None):
    """Matmul with the fold site -> + residual payload -> res site -> LN
    or NoNorm -> ln payload. ``r8`` None: no residual (the
    :func:`int8_matmul_norm_ref` form). ``in_mode='f'``: ``x8`` is a float
    context edge, on the grid ``in_grid`` or (None) on none."""
    y = int8_matmul_ref(x8, w8, vecs, scalars, activation=None,
                        out_mode="fold", w4=w4, in_mode=in_mode,
                        in_grid=in_grid)
    s = ln_scalars[0]
    if r8 is not None:
        y = y + s[2] * (r8.to(torch.float32) + s[3])
    return _ln_ref_body(y, gb, s, eps=eps, res_quant=res_quant,
                        norm=norm).to(torch.int8)


def int8_matmul_norm_ref(x8, w8, vecs, scalars, gb, ln_scalars, *, eps,
                         res_quant=False, w4=False, norm="nonorm"):
    """:func:`int8_matmul_add_ln_ref` without a residual: MobileBERT's
    bottleneck-in and shared key/query bottleneck branches."""
    return int8_matmul_add_ln_ref(x8, w8, vecs, scalars, None, gb,
                                  ln_scalars, eps=eps, res_quant=res_quant,
                                  w4=w4, norm=norm)


def _edge_mode(mode: str, what: str) -> str:
    if mode not in ("i8", "f"):
        raise ValueError(f"unknown {what} {mode!r}")
    return mode


def _ctx_mode(attn_bits) -> str:
    """The context edge into attn_out: an int8 payload for a 1-8-bit
    context site, else a float value edge (JAX ``ctx_mode``)."""
    return "i8" if 1 <= _attn3(attn_bits)[2] <= 8 else "f"


def int8_ffn_ln_ref(x8, wi, vi, si, wd, vd, sd, r8, gb, ln_scalars,
                    lnv=None, *, activation, eps, res_quant=True, w4i=False,
                    w4d=False, norm="layernorm", in_mode="i8", res_mode="i8",
                    h_bits=8, y_bits=8, ln_out="emit", ln_bits=8,
                    inter_mode="i8", inter_bits=8, x_grid=None,
                    i_grid=None):
    """Inter matmul + act -> inter site -> dense matmul (fold on the
    ``h_bits`` grid) -> + residual -> res site (``y_bits``) -> LN or
    NoNorm -> ln site. The flex keywords are the JAX ones: ``in_mode='f'``
    takes the FFN input as a float value edge on the grid ``x_grid``,
    ``res_mode='f'`` the residual likewise, ``inter_mode='f'`` makes the
    inter site a float value edge on its ``inter_bits`` grid (``i_grid``,
    the dense matmul's), ``lnv`` per-column site rows, ``ln_out='f'`` a
    float value out."""
    inter_mode = _edge_mode(inter_mode, "inter_mode")
    i8 = int8_matmul_ref(x8, wi, vi, si, activation=activation, w4=w4i,
                         out_mode="emit" if inter_mode == "i8" else "fold",
                         out_bits=8 if inter_mode == "i8" else inter_bits,
                         in_mode=in_mode, in_grid=x_grid)
    y = int8_matmul_ref(i8, wd, vd, sd, activation=None, out_mode="fold",
                        w4=w4d, out_bits=h_bits, in_mode=inter_mode,
                        in_grid=i_grid)
    return flex_add_ln_ref(y, r8, gb, ln_scalars, lnv, eps=eps,
                           res_quant=res_quant, res_mode=res_mode,
                           res_bits=y_bits, ln_bits=ln_bits, ln_out=ln_out,
                           norm=norm)


def int8_attn_ln_ref(x8, wq, vq, sq, mask_bias, attn_scal, wo, vo, so, gb,
                     ln_scalars, lnv=None, *, n_heads, seq, eps,
                     res_quant=True, skip_max=False, w4q=False, w4o=False,
                     ln_out="emit", ln_bits=8, attn_bits=(8, 8),
                     in_mode="i8", qkv_mode="i8", qkv_bits=8, g_bits=8,
                     u_bits=8, in_grid=None, ctx_grid=None):
    """q|k|v matmul -> attention -> attn_out (fold on the ``g_bits``
    grid) -> + layer input -> res site (``u_bits``) -> LN -> ln site: the
    payload ``'emit'`` or, for a 16-bit / PEG ``x`` site, the float value
    edge (``ln_out='f'``, ``lnv`` per-column rows). ``in_mode='f'``: the
    layer input is a float value edge on the grid ``in_grid``, and the
    residual is that value. ``qkv_mode='f'``: q / k / v are float values
    on their ``qkv_bits`` grid and the attention runs in value space.
    A context site outside 1-8 bits hands attn_out a float edge, on the
    grid ``ctx_grid`` (9-16 bits) or on none (disabled). Value edges are
    float32 (JAX's ``out_dtype=float32``)."""
    in_mode = _edge_mode(in_mode, "in_mode")
    qf = _edge_mode(qkv_mode, "qkv_mode") == "f"
    qkv = int8_matmul_ref(x8, wq, vq, sq, activation=None,
                          out_mode="fold" if qf else "emit",
                          out_bits=qkv_bits if qf else 8, w4=w4q,
                          in_mode=in_mode, in_grid=in_grid)
    c = int8_attention_ref(qkv, mask_bias, attn_scal, n_heads=n_heads,
                           seq=seq, skip_max=skip_max, attn_bits=attn_bits,
                           dots="f32" if qf else "i8")
    y = int8_matmul_ref(c, wo, vo, so, activation=None, out_mode="fold",
                        w4=w4o, out_bits=g_bits,
                        in_mode=_ctx_mode(attn_bits), in_grid=ctx_grid)
    return flex_add_ln_ref(y, x8, gb, ln_scalars, lnv, eps=eps,
                           res_quant=res_quant, res_mode=in_mode,
                           res_bits=u_bits, ln_bits=ln_bits, ln_out=ln_out)


def int8_layer_ln_ref(x8, wq, vq, sq, mask_bias, attn_scal, wo, vo, so,
                      gb1, ln1_scal, wi, vi, si, wd, vd, sd, gb2, ln2_scal,
                      *, n_heads, seq, eps, activation, res1=True, res2=True,
                      skip_max=False, w4q=False, w4o=False, w4i=False,
                      w4d=False, attn_bits=(8, 8), ctx_grid=None):
    """A whole all-int8 encoder layer: attention block then FFN block; a
    context site outside 1-8 bits feeds attn_out a float edge
    (``ctx_grid``, see :func:`int8_attn_ln_ref`)."""
    hx8 = int8_attn_ln_ref(x8, wq, vq, sq, mask_bias, attn_scal, wo, vo, so,
                           gb1, ln1_scal, n_heads=n_heads, seq=seq, eps=eps,
                           res_quant=res1, skip_max=skip_max, w4q=w4q,
                           w4o=w4o, attn_bits=attn_bits, ctx_grid=ctx_grid)
    return int8_ffn_ln_ref(hx8, wi, vi, si, wd, vd, sd, hx8, gb2, ln2_scal,
                           activation=activation, eps=eps, res_quant=res2,
                           w4i=w4i, w4d=w4d)


# ---------------------------------------------------------------------------
# Wrappers: plain version on the CPU, kernel on the card
# ---------------------------------------------------------------------------


def _check(t: Tensor, name: str, dtype, shape=None) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    # the kernels read int8 (and packed int4) rows in 16-byte vectors
    if dtype in (torch.int8, torch.uint8) and t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary")


def _same_device(*ts: Tensor) -> None:
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devs))}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


# the epilogues' activation codes (csrc/mm_common.cuh act_fn): every key
# of the JAX _ACTS; 'gelu' is the A-S erf form
_MM_ACTS = {None: 0, "gelu_new": 1, "relu": 2, "gelu": 3, "gelu_poly10": 4,
            "tanh": 5}
_MM_OUT = {"emit": 0, "fold": 1, "float": 2}
# a bfloat16 fold / float output's code (engine_dtype bf16)
_MM_OUT_BF16 = {"fold": 3, "float": 4}


def _mm_modes(activation, out_mode: str, out_bits: int, what: str,
              out_dtype=torch.float32):
    """The kernels' (act, out_mode, lo, hi) codes for an epilogue; a
    bfloat16 fold or float output (``out_dtype``) takes no activation."""
    if activation not in _MM_ACTS:
        raise NotImplementedError(f"{what} kernel: activation "
                                  f"{activation!r} is not yet ported")
    if out_mode not in _MM_OUT:
        raise ValueError(f"unknown out_mode {out_mode!r}")
    if out_mode == "emit" and out_bits != 8:
        raise ValueError("an emitted payload is 8-bit (out_bits=8)")
    if not 2 <= out_bits <= 16:
        raise NotImplementedError(f"{what} kernel: {out_bits}-bit output "
                                  "sites are not yet ported")
    lo, hi = _clip_bounds(out_bits)
    mode = _MM_OUT[out_mode]
    if out_mode != "emit" and out_dtype != torch.float32:
        if out_dtype != torch.bfloat16 or activation is not None:
            raise NotImplementedError(
                f"{what} kernel: a {out_dtype} {out_mode} output with "
                f"activation {activation!r} is not yet ported (bfloat16, "
                "no activation)")
        mode = _MM_OUT_BF16[out_mode]
    return _MM_ACTS[activation], mode, lo, hi


def _out_tensor(m: int, n: int, out_mode: str, out_dtype, device) -> Tensor:
    """A matmul's (M, N) output: the int8 payload, or the float / fold
    value in ``out_dtype``."""
    return torch.empty((m, n), device=device,
                       dtype=torch.int8 if out_mode == "emit" else out_dtype)


def _check_matmul(x8, w8, vecs, scalars, what: str, w4: bool = False):
    """(M, N, K) of a payload matmul's operands on the card; ``w4``: ``w8``
    is the (N, K/2) packed int4 weight, whose rows TMA reads at a stride
    of K/2 bytes, so K % 32 == 0."""
    m, k = x8.shape
    n = w8.shape[0]
    _check(x8, "x8", torch.int8)
    if w4:
        _check(w8, "w8 (packed int4)", torch.uint8, (n, k // 2))
    else:
        _check(w8, "w8", torch.int8, (n, k))
    _check(vecs, "vecs", torch.float32, (5, n))
    _check(scalars, "scalars", torch.float32, (1, 2))
    _same_device(x8, w8, vecs, scalars)
    if k % (32 if w4 else 16) or n % 8:
        raise ValueError(f"{what} kernel needs K % {32 if w4 else 16} == 0 "
                         f"and N % 8 == 0 (got K={k}, N={n})")
    if not (m and n and k):
        raise ValueError(f"{what} kernel needs M, N, K > 0 (got M={m}, "
                         f"N={n}, K={k})")
    return m, n, k


def int8_matmul(x8, w8, vecs, scalars, *, activation=None, out_mode="emit",
                w4=False, in_mode="i8", out_bits=8, in_grid=None,
                out_dtype=torch.float32):
    """Payload matmul; see :func:`int8_matmul_ref`. On the card: a
    persistent warp-specialized Hopper kernel (``csrc/int8_matmul.cu``, an
    instance of the GEMM in ``csrc/wgmma_gemm.cuh``): TMA loads of 128 x 128-byte tiles into an mbarrier ring,
    ``wgmma.mma_async`` m64n128k32 s8 x s8 -> s32 in two ping-pong
    consumer warpgroups, and the fold, activation and output site in an
    epilogue that runs under the other warpgroup's products and stores
    through shared memory in 16-byte vectors. Needs K % 16 == 0, N % 8 ==
    0 and 16-byte aligned, contiguous operands (raises otherwise). ``w4``:
    the kernel's packed-int4 instance, which reads the (N, K/2) weight as
    it is stored and unpacks each stage's nibbles in shared memory (no
    int8 copy of the weight is made); K % 32 == 0. A float input edge
    (``in_mode='f'``) launches :func:`float_edge_matmul` on its grid
    ``in_grid``, or :func:`float_int8_matmul` where it has none. A
    bfloat16 ``out_dtype`` (no activation) writes a fold or float output
    in bfloat16 from the epilogue."""
    if not x8.is_cuda:
        return int8_matmul_ref(x8, w8, vecs, scalars, activation=activation,
                               out_mode=out_mode, w4=w4, in_mode=in_mode,
                               out_bits=out_bits, in_grid=in_grid,
                               out_dtype=out_dtype)
    if in_mode == "f":
        _require_w8(w4, "int8_matmul(in_mode='f')")
        if in_grid is None:
            return float_int8_matmul(x8, w8, vecs, activation=activation,
                                     out_mode=out_mode, out_bits=out_bits,
                                     out_dtype=out_dtype)
        _check_grid_weight(in_grid, w8)
        return float_edge_matmul(x8, vecs, in_grid, activation=activation,
                                 out_mode=out_mode, out_bits=out_bits,
                                 out_dtype=out_dtype)
    if in_mode != "i8":
        raise ValueError(f"unknown in_mode {in_mode!r}")
    act, mode, lo, hi = _mm_modes(activation, out_mode, out_bits,
                                  "int8_matmul", out_dtype)
    m, n, k = _check_matmul(x8, w8, vecs, scalars, "int8_matmul", w4=w4)
    out = _out_tensor(m, n, out_mode, out_dtype, x8.device)
    name = "int8_matmul_w4" if w4 else "int8_matmul"
    fn = KB.load(name)
    err = fn(x8.data_ptr(), w8.data_ptr(), vecs.data_ptr(),
             scalars.data_ptr(), out.data_ptr(), m, n, k, act, mode, lo, hi,
             GELU_NEW_C, _stream())
    KB.check(err, name)
    LAUNCHES[name] += 1
    return out


FE_BK = 64  # the float-edge kernel's group unit: a group spans whole units
SMEM_MAX = 232448  # bytes of shared memory a block may take (H100)
FE_MAX_K = 4096  # the float-edge kernels' widest K
FE_MAX_GROUPS = {1: 32, 2: 16}  # groups the GEMM folds, by planes


def _edge_grid_shape(grid, k: int, n: int, what: str) -> Tuple[int, int]:
    """(planes, group size) of an edge grid on the card, after checking
    its tensors; raises for a grid the float-edge kernels do not take."""
    w, g = grid["w"], grid["s"].numel()
    _check(w, "grid w", torch.int8, (n, k))
    _check(grid["cols"], "grid cols", torch.int64, (k,))
    for key in ("s", "inv_s", "zp"):
        _check(grid[key], f"grid {key}", torch.float32, (g,))
    _check(grid["gcs"], "grid gcs", torch.int32, (g, n))
    _same_device(*(grid[key] for key in ("w", "cols", "s", "inv_s", "zp",
                                         "gcs")))
    size, bits = k // g, grid["bits"]
    planes = edge_planes(grid)
    if size % FE_BK or n % 8:
        raise NotImplementedError(
            f"{what} kernel needs groups of a multiple of {FE_BK} columns "
            f"and N % 8 == 0 (got {g} groups of {size}, N={n}); other grids "
            "are not yet ported")
    if (not 1 <= bits <= 16 or k > FE_MAX_K
            or (g > 1 and g > FE_MAX_GROUPS[planes])):
        raise NotImplementedError(
            f"{what} kernel: a {bits}-bit edge of K={k} in {g} groups is not "
            f"yet ported (K <= {FE_MAX_K}, at most {FE_MAX_GROUPS[planes]} "
            "groups)")
    return planes, size


def _edge_levels_rows(m: int, planes: int) -> int:
    return m if planes == 1 else 2 * (-(-m // 64) * 64)


def _edge_modes(activation, out_mode, out_bits, groups: int,
                out_dtype=torch.float32):
    """The float-edge GEMM's (act, out_mode, lo, hi) codes: no activation
    or gelu_new at every output, gelu / gelu_poly10 / tanh emitted or
    folded; an emitted payload at any grouping, a fold or the raw float
    out (float32, or bfloat16 with no activation) of a one-group
    (per-tensor) edge."""
    if activation not in (None, "gelu_new", "gelu", "gelu_poly10", "tanh"):
        raise NotImplementedError(f"float_edge_matmul kernel: activation "
                                  f"{activation!r} is not yet ported")
    if activation not in (None, "gelu_new") and out_mode == "float":
        raise NotImplementedError(f"float_edge_matmul kernel: activation "
                                  f"{activation!r} with a float output is "
                                  "not yet ported")
    act, mode, lo, hi = _mm_modes(activation, out_mode, out_bits,
                                  "float_edge_matmul", out_dtype)
    if out_mode != "emit" and groups > 1:
        raise NotImplementedError(f"float_edge_matmul kernel: out_mode "
                                  f"{out_mode!r} of a {groups}-group edge is "
                                  "not yet ported")
    return act, mode, lo, hi


def float_edge_matmul(x, vecs, grid, *, activation=None, out_mode="emit",
                      out_bits=8, out_dtype=torch.float32):
    """Float-edge matmul; see :func:`float_edge_matmul_ref`. On the card
    two launches (``csrc/float_edge_matmul.cu``): the level pass
    (:func:`float_edge_levels`) writes the edge's levels once, in group
    order, into an int8 scratch; then the Hopper GEMM of
    ``csrc/wgmma_gemm.cuh`` (TMA ring, ``wgmma`` s8 in two ping-pong
    warpgroups; :func:`float_edge_gemm`) contracts them exactly, folding
    each group's int32 sums in group order. The GEMM emits the 8-bit
    payload, or for a one-group edge also the fold on a 2-16-bit grid or
    the raw float (float32 out); other outputs raise."""
    if not x.is_cuda:
        return float_edge_matmul_ref(x, vecs, grid, activation=activation,
                                     out_mode=out_mode, out_bits=out_bits,
                                     out_dtype=out_dtype)
    _edge_modes(activation, out_mode, out_bits, grid["s"].numel(),
                out_dtype)   # raise before launching
    _check(vecs, "vecs", torch.float32, (5, grid["w"].shape[0]))
    return float_edge_gemm(float_edge_levels(x, grid), x.shape[0], vecs,
                           grid, activation=activation, out_mode=out_mode,
                           out_bits=out_bits, out_dtype=out_dtype)


def float_edge_levels(x, grid):
    """:func:`float_edge_levels_ref`; on the card the level pass alone,
    the first of :func:`float_edge_matmul`'s two launches: a block copies
    rows of x to shared memory in coalesced float4 loads and writes their
    levels in group order (the ``cols`` gather from shared memory)."""
    if not x.is_cuda:
        return float_edge_levels_ref(x, grid)
    m, k = x.shape
    _check(x, "x", torch.float32)
    planes, size = _edge_grid_shape(grid, k, grid["w"].shape[0],
                                    "float_edge_levels")
    _same_device(x, grid["w"])
    lv = torch.empty((_edge_levels_rows(m, planes), k), device=x.device,
                     dtype=torch.int8)
    err = KB.load("float_edge_levels")(
        x.data_ptr(), grid["cols"].data_ptr(), grid["inv_s"].data_ptr(),
        grid["zp"].data_ptr(), lv.data_ptr(), m, k, size, planes,
        float(2 ** grid["bits"] - 1), _stream())
    KB.check(err, "float_edge_levels")
    LAUNCHES["float_edge_levels"] += 1
    return lv


def float_edge_gemm(lv, m: int, vecs, grid, *, activation=None,
                    out_mode="emit", out_bits=8, out_dtype=torch.float32):
    """:func:`float_edge_gemm_ref`; on the card the GEMM alone, the second
    of :func:`float_edge_matmul`'s two launches, on the levels ``lv`` of
    ``m`` rows that :func:`float_edge_levels` wrote. Counted under
    ``float_edge_matmul`` (an emitted payload) or
    ``float_edge_matmul_fold`` (a fold or the raw float out)."""
    if not lv.is_cuda:
        return float_edge_gemm_ref(lv, m, vecs, grid, activation=activation,
                                   out_mode=out_mode, out_bits=out_bits,
                                   out_dtype=out_dtype)
    act, mode, lo, hi = _edge_modes(activation, out_mode, out_bits,
                                    grid["s"].numel(), out_dtype)
    k = lv.shape[1]
    n = grid["w"].shape[0]
    planes, size = _edge_grid_shape(grid, k, n, "float_edge_gemm")
    _check(lv, "lv", torch.int8, (_edge_levels_rows(m, planes), k))
    _check(vecs, "vecs", torch.float32, (5, n))
    _same_device(lv, vecs, grid["w"])
    out = _out_tensor(m, n, out_mode, out_dtype, lv.device)
    err = KB.load("float_edge_gemm")(
        lv.data_ptr(), grid["w"].data_ptr(), vecs.data_ptr(),
        grid["s"].data_ptr(), grid["zp"].data_ptr(), grid["gcs"].data_ptr(),
        out.data_ptr(), m, n, k, size, planes, act, mode, lo, hi, GELU_NEW_C,
        _stream())
    KB.check(err, "float_edge_gemm")
    name = ("float_edge_matmul" if out_mode == "emit"
            else "float_edge_matmul_fold")
    LAUNCHES[name] += 1
    return out


FI_MAX_K = 8192  # the float x int8 GEMM's widest K


def float_int8_matmul(x, w8, vecs, *, activation=None, out_mode="emit",
                      out_bits=8, out_dtype=torch.float32):
    """The matmul of a float edge on no grid; see
    :func:`float_int8_matmul_ref`. On the card
    (``csrc/float_int8_gemm.cu``): the products on the float64 tensor
    cores (DMMA), x staged as float32 and the weight as int8 in a cp.async
    ring and converted exactly to float64 as each fragment is built, each
    output's sum rounded once to float32, then the epilogue of
    :func:`int8_matmul` (wscale, bias, activation, the output site
    emitted, folded on a 2-16-bit grid or the raw float). Needs 16-byte
    aligned, contiguous operands, K % 16 == 0, K <= 8192 and N % 8 == 0
    (the engine's plan refuses other widths: ``_require_k1_width``)."""
    if not x.is_cuda:
        return float_int8_matmul_ref(x, w8, vecs, activation=activation,
                                     out_mode=out_mode, out_bits=out_bits,
                                     out_dtype=out_dtype)
    act, mode, lo, hi = _mm_modes(activation, out_mode, out_bits,
                                  "float_int8_matmul", out_dtype)
    m, k = x.shape
    n = w8.shape[0]
    _check(x, "x", torch.float32)
    _check(w8, "w8", torch.int8, (n, k))
    _check(vecs, "vecs", torch.float32, (5, n))
    _same_device(x, w8, vecs)
    if (not (m and n and k) or k % 16 or k > FI_MAX_K or n % 8
            or x.data_ptr() % 16):
        raise NotImplementedError(
            f"float_int8_matmul kernel needs M, N, K > 0, K % 16 == 0, K <= "
            f"{FI_MAX_K}, N % 8 == 0 and a 16-byte aligned x (got M={m}, "
            f"N={n}, K={k})")
    out = _out_tensor(m, n, out_mode, out_dtype, x.device)
    err = KB.load("float_int8_matmul")(
        x.data_ptr(), w8.data_ptr(), vecs.data_ptr(), out.data_ptr(), m, n,
        k, act, mode, lo, hi, GELU_NEW_C, _stream())
    KB.check(err, "float_int8_matmul")
    LAUNCHES["float_int8_matmul"] += 1
    return out


ATTN_SHAPES = tuple((t, d) for t in (32, 64, 128)
                    for d in (32, 64))  # (seq, head_dim) built


def _rsqrt_d(d: int) -> float:
    return float(np.float32(1.0 / np.sqrt(d)))


def _attention_launch(q_arr, k_arr, v_arr, cols, mask_bias, scalars, *,
                      n_heads, seq, hidden, skip_max, attn_bits,
                      what: str) -> Tensor:
    """Launch ``csrc/int8_attention.cu`` over the column blocks ``cols``
    of q, k and v; counts the launch under ``what``."""
    if _attn3(attn_bits) != (8, 8, 8):
        raise NotImplementedError(f"{what} kernel: only 8-bit scores/probs/"
                                  "context sites are ported")
    mt = q_arr.shape[0]
    d = hidden // n_heads
    b = mt // seq
    if (seq, d) not in ATTN_SHAPES or b * seq != mt or d * n_heads != hidden:
        raise NotImplementedError(f"{what} kernel: (seq, head_dim) = ({seq},"
                                  f" {d}) is not built (built: "
                                  f"{ATTN_SHAPES})")
    for name, a, c in (("q", q_arr, cols[0]), ("k", k_arr, cols[1]),
                       ("v", v_arr, cols[2])):
        _check(a, name, torch.int8)
        if a.ndim != 2 or a.shape[0] != mt or (c + 1) * hidden > a.shape[1]:
            raise ValueError(f"{what}: {name} {tuple(a.shape)} has no column "
                             f"block {c} of width {hidden} over {mt} rows")
        if a.shape[1] % 16:
            raise ValueError(f"{what}: {name} rows must be a multiple of 16 "
                             "bytes")
    _check(mask_bias, "mask_bias", torch.float32, (b, seq))
    if mask_bias.data_ptr() % 16:  # the kernel's TMA loads of mask rows
        raise ValueError(f"{what}: mask_bias must start on a 16-byte "
                         "boundary")
    _check(scalars, "scalars", torch.float32, (1, 12))
    _same_device(q_arr, k_arr, v_arr, mask_bias, scalars)
    out = torch.empty((mt, hidden), device=q_arr.device, dtype=torch.int8)
    fn = KB.load("int8_attention")
    err = fn(q_arr.data_ptr() + cols[0] * hidden,
             k_arr.data_ptr() + cols[1] * hidden,
             v_arr.data_ptr() + cols[2] * hidden, q_arr.shape[1],
             k_arr.shape[1], v_arr.shape[1], mask_bias.data_ptr(),
             scalars.data_ptr(), out.data_ptr(), b, seq, hidden, n_heads,
             _rsqrt_d(d), LOG2E, int(skip_max), _stream())
    KB.check(err, what)
    LAUNCHES[what] += 1
    return out


def int8_attention(qkv8, mask_bias, scalars, *, n_heads, seq,
                   skip_max=False, attn_bits=(8, 8), dots="i8"):
    """Fused attention over the q|k|v edge; see :func:`int8_attention_ref`.
    On the card: for int8 payloads and 8-bit scores / probs / context
    sites, the kernel of :func:`int8_attention_qkv` with q, k, v the column
    blocks 0, 1, 2 of ``qkv8`` (``csrc/int8_attention.cu``); for every
    other form its second kernel, :func:`int8_attention_flex`."""
    if not qkv8.is_cuda:
        return int8_attention_ref(qkv8, mask_bias, scalars, n_heads=n_heads,
                                  seq=seq, skip_max=skip_max,
                                  attn_bits=attn_bits, dots=dots)
    if dots != "i8" or _attn3(attn_bits) != (8, 8, 8):
        return int8_attention_flex(qkv8, mask_bias, scalars, n_heads=n_heads,
                                   seq=seq, skip_max=skip_max,
                                   attn_bits=attn_bits, dots=dots)
    return _attention_launch(qkv8, qkv8, qkv8, (0, 1, 2), mask_bias,
                             scalars, n_heads=n_heads, seq=seq,
                             hidden=qkv8.shape[1] // 3, skip_max=skip_max,
                             attn_bits=attn_bits, what="int8_attention")


def attn_flex_route(attn_bits, dots) -> str:
    """The route of the attention's second kernel for a form, a function
    of the form alone: ``'int'`` for int8 payloads (``dots='i8'``) and a
    probs site of 1-16 bits (q.k and p.v on the int8 tensor cores), else
    ``'f64'`` (float32 q / k / v values, or a disabled probs site: the
    float dots on the float64 tensor cores)."""
    _, p_bits, _ = _check_attn_bits(attn_bits)
    if dots not in ("i8", "f32"):
        raise ValueError(f"unknown dots {dots!r}")
    return "int" if dots == "i8" and p_bits >= 1 else "f64"


# the magnitude up to which the integer route takes integer p_sh / v_sh
# exactly (see attn_pv_exact)
LVL_SHIFT_MAX = 2.0 ** 16


def attn_pv_exact(p_sh: float, v_sh: float) -> bool:
    """Whether the integer route's p.v of a 9-16-bit probs site is an exact
    integer, the kernel's condition on each block (``lvl_exact`` in
    ``csrc/int8_attention.cu``): ``p_sh`` and ``v_sh`` (float32) integers
    of magnitude at most ``LVL_SHIFT_MAX``. Then every probs level ``L``
    is an integer in ``[p_sh - 2^(b-1), p_sh + 2^(b-1) - 1]``, ``v8 +
    v_sh`` is an integer exact in float32, and ``sum L (v8 + v_sh)`` is
    the integer that the kernel takes apart into byte planes (each int32
    partial below 2^22 at T <= 128) and recombines in int64, which the
    plain version's float64 sum also reaches exactly (every product <
    2^34, every partial sum < 2^53). Otherwise the block takes p.v on the
    float64 tensor cores."""
    p, v = np.float32(p_sh), np.float32(v_sh)
    return bool(abs(p) <= LVL_SHIFT_MAX and np.rint(p) == p
                and abs(v) <= LVL_SHIFT_MAX and np.rint(v) == v)


def int8_attention_flex(qkv, mask_bias, scalars, *, n_heads, seq,
                        skip_max=False, attn_bits=(8, 8), dots="i8"):
    """The attention's other forms; see :func:`int8_attention_ref`: scores
    and probs sites of 1-16 bits or disabled, a context payload (1-8 bits)
    or float32 context values (9-16 bits, or disabled), on int8 payloads
    (``dots='i8'``) or float32 q / k / v values (``'f32'``). On the card
    (``csrc/int8_attention.cu``) the form picks the route
    (:func:`attn_flex_route`): ``'int'`` runs q.k and p.v on the int8
    tensor cores on K2's skeleton (a 9-16-bit probs level in two byte
    planes, combined exactly in int64 where :func:`attn_pv_exact` holds,
    else p.v on the float64 ones), bit-identical to the plain version;
    ``'f64'`` runs every float dot on the float64 tensor cores (DMMA; q.k
    of payloads stays on the int8 ones), equal to it but where a float64
    sum meets a float32 tie. The softmax chain and the sites take the
    plain version's float32 order on both. Needs a 16-byte aligned
    ``mask_bias`` (the integer route loads its rows by TMA)."""
    if not qkv.is_cuda:
        return int8_attention_ref(qkv, mask_bias, scalars, n_heads=n_heads,
                                  seq=seq, skip_max=skip_max,
                                  attn_bits=attn_bits, dots=dots)
    sc_bits, p_bits, c_bits = _check_attn_bits(attn_bits)
    if dots not in ("i8", "f32"):
        raise ValueError(f"unknown dots {dots!r}")
    mt, h3 = qkv.shape
    hidden = h3 // 3
    d = hidden // n_heads
    b = mt // seq
    if ((seq, d) not in ATTN_SHAPES or b * seq != mt or h3 != 3 * hidden
            or d * n_heads != hidden):
        raise NotImplementedError(f"int8_attention_flex kernel: (seq, "
                                  f"head_dim) = ({seq}, {d}) is not built "
                                  f"(built: {ATTN_SHAPES})")
    _check(qkv, "qkv", torch.float32 if dots == "f32" else torch.int8)
    _check(mask_bias, "mask_bias", torch.float32, (b, seq))
    _check(scalars, "scalars", torch.float32, (1, 12))
    _same_device(qkv, mask_bias, scalars)
    if qkv.data_ptr() % 16 or mask_bias.data_ptr() % 16:
        raise ValueError("int8_attention_flex: qkv and mask_bias must start "
                         "on a 16-byte boundary")
    out = torch.empty((mt, hidden), device=qkv.device,
                      dtype=torch.int8 if 1 <= c_bits <= 8
                      else torch.float32)
    err = KB.load("int8_attention_flex")(
        qkv.data_ptr(), int(dots == "f32"), mask_bias.data_ptr(),
        scalars.data_ptr(), out.data_ptr(), b, seq, hidden, n_heads,
        sc_bits, p_bits, c_bits, _rsqrt_d(d), LOG2E, int(skip_max),
        _stream())
    KB.check(err, "int8_attention_flex")
    LAUNCHES["int8_attention_flex"] += 1
    return out


def int8_attention_qkv(q_arr, k_arr, v_arr, mask_bias, scalars, *, n_heads,
                       seq, hidden, cols=(0, 0, 0), skip_max=False,
                       attn_bits=(8, 8)):
    """Attention over separate q, k, v payload arrays; see
    :func:`int8_attention_qkv_ref`. On the card: persistent blocks walk
    the (batch row, head) items, TMA loads of q, k and v at their own
    column blocks and row strides, both products on int8 tensor cores
    (``csrc/int8_attention.cu``)."""
    if not q_arr.is_cuda:
        return int8_attention_qkv_ref(q_arr, k_arr, v_arr, mask_bias,
                                      scalars, n_heads=n_heads, seq=seq,
                                      hidden=hidden, cols=cols,
                                      skip_max=skip_max, attn_bits=attn_bits)
    return _attention_launch(q_arr, k_arr, v_arr, tuple(cols), mask_bias,
                             scalars, n_heads=n_heads, seq=seq, hidden=hidden,
                             skip_max=skip_max, attn_bits=attn_bits,
                             what="int8_attention_qkv")


def _matmul_nonorm(x8, w8, vecs, scalars, r8, gb, ln_scalars, *,
                   res_quant, w4=False) -> Tensor:
    """Launch ``csrc/int8_matmul_norm.cu`` (K6, an instance of the GEMM in
    ``csrc/wgmma_gemm.cuh``): the matmul with the fold site, the optional
    residual ``r8`` (staged by the kernel through shared memory under its
    main loop), the res site and NoNorm in its epilogue. ``w4``: ``w8`` is
    the (N, K/2) packed int4 weight, unpacked inside the kernel (its
    packed instances, on the skeleton's ``gemm_kernel_w4``: 128-row
    tiles). Needs K % 16 == 0 (K % 32 for ``w4``), N % 8 == 0 and 16-byte
    aligned, contiguous operands; raises on anything else (there is no
    fall-back to the plain version)."""
    m, n, _ = _check_matmul(x8, w8, vecs, scalars, "int8_matmul_norm",
                            w4=w4)
    if r8 is not None:
        _check(r8, "r8", torch.int8, (m, n))
    _check(gb, "gb", torch.float32, (2, n))
    _check(ln_scalars, "ln_scalars", torch.float32, (1, 8))
    _same_device(x8, gb, ln_scalars, *([r8] if r8 is not None else []))
    out = torch.empty((m, n), device=x8.device, dtype=torch.int8)
    name = "int8_matmul_norm_w4" if w4 else "int8_matmul_norm"
    fn = KB.load(name)
    err = fn(x8.data_ptr(), w8.data_ptr(), vecs.data_ptr(),
             scalars.data_ptr(), r8.data_ptr() if r8 is not None else None,
             gb.data_ptr(), ln_scalars.data_ptr(), out.data_ptr(), m, n,
             x8.shape[1], int(res_quant), _stream())
    KB.check(err, name)
    LAUNCHES[name] += 1
    return out


def int8_matmul_norm(x8, w8, vecs, scalars, gb, ln_scalars, *, eps,
                     res_quant=False, w4=False, norm="nonorm"):
    """Matmul -> fold site -> NoNorm -> norm payload, no residual; see
    :func:`int8_matmul_norm_ref`. On the card: one launch of the
    persistent TMA / ``wgmma`` GEMM of ``csrc/wgmma_gemm.cuh`` with the
    whole tail in its epilogue (``csrc/int8_matmul_norm.cu``, K6; its
    packed int4 instances for ``w4``), under :func:`_matmul_nonorm`'s
    limits."""
    if not x8.is_cuda:
        return int8_matmul_norm_ref(x8, w8, vecs, scalars, gb, ln_scalars,
                                    eps=eps, res_quant=res_quant, w4=w4,
                                    norm=norm)
    if norm != "nonorm":
        raise NotImplementedError(f"int8_matmul_norm kernel: norm={norm!r} "
                                  "is not yet ported")
    return _matmul_nonorm(x8, w8, vecs, scalars, None, gb, ln_scalars,
                          res_quant=res_quant, w4=w4)


def _mb_layer_smem(head_dim: int, hidden: int) -> int:
    """Shared memory of one ``int8_mb_layer.cu`` block (its ``SM_*``
    offsets), laid out for the widest H and I it takes (``MB_MAX_WIDTH``)
    whatever the seq: the weight ring (4 stages of 128 x 128 bytes), h8,
    li8 / x8, the union of sh8 / c8, q, k and v^T with the FFN inter
    payload, two warpgroups' column tables (32 bytes a column), the keys'
    attention constants (a float pair a key and head), v's sums (4 key
    blocks), q's sums (an int a row and head), the mbarriers and 1 KB of
    alignment."""
    heads = hidden // head_dim
    return (4 * 128 * 128 + 128 * MB_MAX_WIDTH + 128 * hidden
            + 128 * max(MB_MAX_WIDTH, 4 * hidden) + 2 * 128 * 32
            + heads * 128 * 8 + 4 * hidden * 4 + heads * 128 * 4 + 128
            + 1024)


# (seq, head_dim, heads) the layer kernel is built for
MB_LAYER_SHAPES = ((32, 32, 4), (64, 32, 4), (128, 32, 4))
MB_MAX_FFN = 8
MB_MAX_WIDTH = 512  # H and I: a unit's K chunks fill the kernel's ring


def mb_layer_refusal(*, seq, head_dim, n_heads, h, inter, attn_case,
                     activation, n_ffn, attn_bits, w4):
    """Why the layer kernel (``csrc/int8_mb_layer.cu``) does not take a
    MobileBERT layer of these shapes and plan, or None where it does. The
    engine's plan reads it to choose each seq's route
    (:func:`~..models.mobilebert.MobileBertEngineStatic.layer_route`);
    :func:`int8_mb_layer_ln` raises it on the card. ``w4``: a flag per
    matmul in :func:`mb_layer_flat`'s order; a packed int4 weight's K must
    be 128 or a multiple of 256 (the kernel unpacks whole 128-byte packed
    boxes, two K chunks each, or at K = 128 one 64-byte box)."""
    if _attn3(attn_bits) != (8, 8, 8):
        return "only 8-bit scores/probs/context sites are ported"
    if attn_case not in ("shared_kq", "bottleneck"):
        return (f"attn_case {attn_case!r} is not yet ported (the kernel "
                "takes 'shared_kq' and 'bottleneck')")
    if (seq, head_dim, n_heads) not in MB_LAYER_SHAPES:
        return (f"(seq, head_dim, heads) = ({seq}, {head_dim}, {n_heads}) "
                f"is not built (built: {MB_LAYER_SHAPES})")
    if activation not in _MM_ACTS or n_ffn > MB_MAX_FFN:
        return (f"activation {activation!r} / {n_ffn} stacked FFNs are not "
                "yet ported")
    if h % 128 or inter % 128 or max(h, inter) > MB_MAX_WIDTH:
        return (f"width {h}, intermediate {inter} (needs widths of a "
                f"multiple of 128 up to {MB_MAX_WIDTH})")
    ks = _mb_matmul_ks(attn_case == "shared_kq", n_ffn, h,
                       head_dim * n_heads, inter)
    bad = sorted({k for k, f in zip(ks, w4) if f and k != 128 and k % 256})
    if bad:
        return (f"int4 weights (w4) of K = {bad} (the kernel's packed "
                "boxes need K = 128 or a multiple of 256)")
    smem = _mb_layer_smem(head_dim, n_heads * head_dim)
    if smem > SMEM_MAX:
        return (f"a 128-row tile's live set ({smem} bytes) exceeds shared "
                f"memory ({SMEM_MAX})")
    return None


def int8_mb_layer_ln(h8, mask_bias, attn_scal, flat, *, n_heads, seq,
                     hidden, attn_case, activation, res, w4, n_ffn,
                     skip_max=False, attn_bits=(8, 8)):
    """A whole MobileBERT layer; see :func:`int8_mb_layer_ln_ref` and
    :func:`mb_layer_flat` for ``flat``. On the card: one launch of a
    persistent warp-specialized Hopper kernel (``csrc/int8_mb_layer.cu``):
    a block an SM walks 128-row tiles of whole sequences, a producer warp
    streams the layer's weight tiles by TMA, two consumer warpgroups run
    every matmul and the attention on ``wgmma`` with every intermediate
    payload in shared memory; bit-identical to :func:`mb_layer_chain`.
    Shapes and plans the kernel does not take (:func:`mb_layer_refusal`)
    raise NotImplementedError (there is no quiet fall-back to the chain:
    the engine's plan picks the chain for them before anything runs)."""
    kw = dict(n_heads=n_heads, seq=seq, hidden=hidden, attn_case=attn_case,
              activation=activation, res=res, w4=w4, n_ffn=n_ffn,
              skip_max=skip_max, attn_bits=attn_bits)
    if not h8.is_cuda:
        return int8_mb_layer_ln_ref(h8, mask_bias, attn_scal, flat, **kw)
    # out.dense's (hidden, I) weight, tenth from the end (mb_layer_flat);
    # packed, I / 2 bytes a row
    inter = flat[-10].shape[1] if len(flat) >= 10 else 0
    if len(w4) > 1 and w4[-2]:
        inter *= 2
    why = mb_layer_refusal(seq=seq, head_dim=hidden // n_heads,
                           n_heads=n_heads, h=h8.shape[1], inter=inter,
                           attn_case=attn_case, activation=activation,
                           n_ffn=n_ffn, attn_bits=attn_bits, w4=w4)
    if why is not None:
        raise NotImplementedError(f"int8_mb_layer_ln kernel: {why}")
    d = hidden // n_heads
    mt, h = h8.shape
    shared_kq = attn_case == "shared_kq"
    shapes = _mb_flat_shapes(shared_kq, n_ffn, h, hidden, inter,
                             tuple(w4))
    if len(flat) != len(shapes):
        raise ValueError(f"int8_mb_layer_ln: flat has {len(flat)} arrays, "
                         f"the plan needs {len(shapes)}")
    # one pass over the plan's 50-odd arrays (a layer's host time), then
    # _check's message for the first that the kernel does not take
    for i in [i for i, (a, (shape, dtype)) in enumerate(zip(flat, shapes))
              if not a.is_cuda or a.dtype != dtype or a.shape != shape
              or not a.is_contiguous()
              or (dtype in (torch.int8, torch.uint8)
                  and a.data_ptr() % 16)][:1]:
        _check(flat[i], f"flat[{i}]", shapes[i][1], shapes[i][0])
    if mt % seq:
        raise NotImplementedError(f"int8_mb_layer_ln kernel: rows {mt} "
                                  "(needs whole sequences)")
    _check(h8, "h8", torch.int8)
    _check(mask_bias, "mask_bias", torch.float32, (mt // seq, seq))
    _check(attn_scal, "attn_scal", torch.float32, (1, 12))
    _same_device(h8, mask_bias, attn_scal, *flat)
    res_ao, res_ffn, res_out, res_obn = res
    ffn_mask = sum(int(bool(r)) << j
                   for j, r in enumerate(tuple(res_ffn) + (res_out,)))
    ptrs = (ctypes.c_void_p * len(flat))(*(a.data_ptr() for a in flat))
    out = torch.empty_like(h8)
    # bit j: the plan's j-th matmul (mb_layer_flat's order) is packed int4
    w4_plan = sum(int(bool(f)) << j for j, f in enumerate(w4))
    fn = KB.load("int8_mb_layer_w4")
    err = fn(h8.data_ptr(), mask_bias.data_ptr(), attn_scal.data_ptr(),
             ctypes.addressof(ptrs), len(flat), out.data_ptr(), mt // seq,
             seq, h, hidden, inter, d, n_ffn, int(shared_kq),
             _MM_ACTS[activation], int(skip_max), int(bool(res_ao)),
             ffn_mask, int(bool(res_obn)), w4_plan, _rsqrt_d(d), LOG2E,
             GELU_NEW_C, _stream())
    name = "int8_mb_layer_ln_w4" if w4_plan else "int8_mb_layer_ln"
    KB.check(err, name)
    LAUNCHES[name] += 1
    return out


def _mb_matmul_ks(shared_kq: bool, n_ffn: int, h: int, hidden: int,
                  inter: int) -> Tuple[int, ...]:
    """Each matmul's K in :func:`mb_layer_flat`'s order: bn_in, [bn_attn],
    q|k, v, attn_out, (inter, dense) per FFN, out_bn."""
    return ((h,) + ((h,) if shared_kq else ())
            + (hidden, h if shared_kq else hidden, hidden)
            + (hidden, inter) * (n_ffn + 1) + (hidden,))


@functools.lru_cache(maxsize=None)
def _mb_flat_shapes(shared_kq: bool, n_ffn: int, h: int, hidden: int,
                    inter: int, w4: Tuple[bool, ...] = ()):
    """(shape, dtype) of each array of a layer plan in
    :func:`mb_layer_flat`'s order, at widths (h, hidden, inter); ``w4``
    (a flag per matmul): the (N, K/2) uint8 packed int4 weight."""
    f32 = torch.float32
    w4s = iter(w4)

    def mm(n, k):
        if next(w4s, False):
            return [((n, k // 2), torch.uint8), ((5, n), f32), ((1, 2), f32)]
        return [((n, k), torch.int8), ((5, n), f32), ((1, 2), f32)]

    def nrm(n):
        return [((2, n), f32), ((1, 8), f32)]

    out = mm(hidden, h) + nrm(hidden)
    if shared_kq:
        out += mm(hidden, h) + nrm(hidden)
    out += mm(2 * hidden, hidden) + mm(hidden, h if shared_kq else hidden)
    out += mm(hidden, hidden) + nrm(hidden)
    for _ in range(n_ffn + 1):  # the stacked FFNs, then the output FFN
        out += mm(inter, hidden) + mm(hidden, inter) + nrm(hidden)
    return tuple(out + mm(h, hidden) + nrm(h))


def fused_add_ln_payload(y8, r8, gb, scalars, *, eps, res_quant=True):
    """Payload-in/payload-out add + LayerNorm; see
    :func:`fused_add_ln_payload_ref`. On the card: K3
    (``csrc/add_ln_payload.cu``), the int8-in, int8-out instance of
    ``csrc/add_ln.cuh``'s add+LN template."""
    if not y8.is_cuda:
        return fused_add_ln_payload_ref(y8, r8, gb, scalars, eps=eps,
                                        res_quant=res_quant)
    m, h = y8.shape
    _check(y8, "y8", torch.int8)
    _check(r8, "r8", torch.int8, (m, h))
    _check(gb, "gb", torch.float32, (2, h))
    _check(scalars, "scalars", torch.float32, (1, 8))
    _same_device(y8, r8, gb, scalars)
    _h_fits(h, "fused_add_ln_payload")
    out = torch.empty((m, h), device=y8.device, dtype=torch.int8)
    fn = KB.load("add_ln_payload")
    err = fn(y8.data_ptr(), r8.data_ptr(), gb.data_ptr(), scalars.data_ptr(),
             out.data_ptr(), m, h, float(eps), int(res_quant), _stream())
    KB.check(err, "fused_add_ln_payload")
    LAUNCHES["fused_add_ln_payload"] += 1
    return out


def _h_fits(h: int, what: str) -> None:
    if h % 128 or h > 1024:
        raise NotImplementedError(f"{what} kernel needs H % 128 == 0 and "
                                  f"H <= 1024 (got {h})")


def _aligned(*ts: Tensor) -> None:
    """The add+LN kernels read float32 rows in 16-byte vectors (int8
    arrays are checked by :func:`_check`)."""
    for t in ts:
        if t.data_ptr() % 16:
            raise ValueError("the add+LN kernel's row arrays must start on "
                             "a 16-byte boundary")


def fused_add_ln(y, r, gb, scalars, *, eps, res_quant=True,
                 out_dtype=torch.float32):
    """Float-in add + LayerNorm emitting the payload and the float value;
    see :func:`fused_add_ln_ref`. On the card: ``csrc/flex_add_ln.cu``'s
    instance with a float32 residual, scalar 8-bit sites and both
    outputs; at ``out_dtype`` bfloat16 (the engine's engine_dtype bf16)
    its instance with bfloat16 ``y`` and ``r`` and the float value out in
    bfloat16."""
    if not y.is_cuda:
        return fused_add_ln_ref(y, r, gb, scalars, eps=eps,
                                res_quant=res_quant, out_dtype=out_dtype)
    m, h = y.shape
    if out_dtype == torch.bfloat16:
        return _fused_add_ln_bf16(y, r, gb, scalars, eps=eps,
                                  res_quant=res_quant)
    if out_dtype != torch.float32:
        raise NotImplementedError(f"fused_add_ln kernel: a {out_dtype} "
                                  "output is not yet ported")
    _check(y, "y", torch.float32)
    _check(r, "r", torch.float32, (m, h))
    _check(gb, "gb", torch.float32, (2, h))
    _check(scalars, "scalars", torch.float32, (1, 8))
    _same_device(y, r, gb, scalars)
    _h_fits(h, "fused_add_ln")
    out8 = torch.empty((m, h), device=y.device, dtype=torch.int8)
    outf = torch.empty((m, h), device=y.device, dtype=torch.float32)
    _aligned(y, r)
    fn = KB.load("flex_add_ln")
    err = fn(y.data_ptr(), r.data_ptr(), 1, gb.data_ptr(), scalars.data_ptr(),
             None, out8.data_ptr(), outf.data_ptr(), m, h, float(eps),
             int(res_quant), -128.0, 127.0, -128.0, 127.0, _stream())
    KB.check(err, "fused_add_ln")
    LAUNCHES["fused_add_ln"] += 1
    return out8, outf


def _fused_add_ln_bf16(y, r, gb, scalars, *, eps, res_quant):
    """:func:`fused_add_ln` at bfloat16 on the card: y and r (M, H)
    bfloat16, both outputs (int8, bfloat16) from one launch of
    ``tq_fused_add_ln_bf16`` (``csrc/flex_add_ln.cu``)."""
    m, h = y.shape
    _check(y, "y", torch.bfloat16)
    _check(r, "r", torch.bfloat16, (m, h))
    _check(gb, "gb", torch.float32, (2, h))
    _check(scalars, "scalars", torch.float32, (1, 8))
    _same_device(y, r, gb, scalars)
    _h_fits(h, "fused_add_ln")
    _aligned(y, r)
    out8 = torch.empty((m, h), device=y.device, dtype=torch.int8)
    outf = torch.empty((m, h), device=y.device, dtype=torch.bfloat16)
    err = KB.load("fused_add_ln_bf16")(
        y.data_ptr(), r.data_ptr(), gb.data_ptr(), scalars.data_ptr(),
        out8.data_ptr(), outf.data_ptr(), m, h, float(eps), int(res_quant),
        -128.0, 127.0, -128.0, 127.0, _stream())
    KB.check(err, "fused_add_ln")
    LAUNCHES["fused_add_ln"] += 1
    return out8, outf


def flex_add_ln(y, r, gb, scalars, lnv=None, *, eps, res_quant=True,
                res_mode="i8", res_bits=8, ln_bits=8, ln_out="emit"):
    """Float-in add + LayerNorm with flexible sites; see
    :func:`flex_add_ln_ref`. On the card: K5 (``csrc/flex_add_ln.cu``),
    the float-y instances of ``csrc/add_ln.cuh``'s add+LN template."""
    if not y.is_cuda:
        return flex_add_ln_ref(y, r, gb, scalars, lnv, eps=eps,
                               res_quant=res_quant, res_mode=res_mode,
                               res_bits=res_bits, ln_bits=ln_bits,
                               ln_out=ln_out)
    if res_mode not in ("i8", "f"):
        raise ValueError(f"unknown res_mode {res_mode!r}")
    if ln_out not in ("emit", "f"):
        raise ValueError(f"unknown ln_out {ln_out!r}")
    if ln_out == "emit" and ln_bits != 8:
        raise ValueError("an emitted payload is 8-bit (ln_bits=8)")
    if not (2 <= res_bits <= 16 and 2 <= ln_bits <= 16):
        raise NotImplementedError("flex_add_ln kernel: sites outside 2..16 "
                                  "bits are not yet ported")
    m, h = y.shape
    _check(y, "y", torch.float32)
    _check(r, "r", torch.int8 if res_mode == "i8" else torch.float32,
           (m, h))
    _check(gb, "gb", torch.float32, (2, h))
    _check(scalars, "scalars", torch.float32, (1, 8))
    if lnv is not None:
        _check(lnv, "lnv", torch.float32, (4, h))
    _same_device(y, r, gb, scalars, *([lnv] if lnv is not None else []))
    _h_fits(h, "flex_add_ln")
    out = torch.empty((m, h), device=y.device,
                      dtype=torch.int8 if ln_out == "emit"
                      else torch.float32)
    _aligned(y, r)
    res_lo, res_hi = _clip_bounds(res_bits)
    ln_lo, ln_hi = _clip_bounds(ln_bits)
    fn = KB.load("flex_add_ln")
    err = fn(y.data_ptr(), r.data_ptr(), int(res_mode == "f"), gb.data_ptr(),
             scalars.data_ptr(), lnv.data_ptr() if lnv is not None else None,
             out.data_ptr() if ln_out == "emit" else None,
             out.data_ptr() if ln_out == "f" else None, m, h, float(eps),
             int(res_quant), res_lo, res_hi, ln_lo, ln_hi, _stream())
    KB.check(err, "flex_add_ln")
    LAUNCHES["flex_add_ln"] += 1
    return out


# ---------------------------------------------------------------------------
# The TPU's fused forms as chains of the kernels
# ---------------------------------------------------------------------------


def fold_ln_scalars(vecs: Tensor, ln_scalars: Tensor) -> Tensor:
    """The add+LN scalars with [y_s, y_sh] read from the producing matmul's
    fold site (``vecs`` rows 3/4). Only for the all-int8 chains, whose
    fold site is an 8-bit per-tensor site, so column 0 carries it (the
    flex chains hand the fold value to :func:`flex_add_ln` as float32)."""
    return torch.cat([vecs[3:5, 0], ln_scalars[0, 2:]]).reshape(1, 8)


def int8_matmul_add_ln(x8, w8, vecs, scalars, r8, gb, ln_scalars, *, eps,
                       res_quant=True, w4=False, norm="layernorm",
                       in_mode="i8", in_grid=None):
    """LayerNorm: matmul (emit on the fold site; a float context edge
    through :func:`int8_matmul`'s ``in_mode='f'`` on ``in_grid`` or on no
    grid) -> :func:`fused_add_ln_payload`; bit-identical to
    :func:`int8_matmul_add_ln_ref` when the fold site is 8-bit per-tensor,
    as in every all-int8 layer plan (a per-column fold site takes the flex
    chains). NoNorm: one :func:`int8_matmul_norm` kernel launch with the
    residual."""
    if norm == "nonorm":
        if not x8.is_cuda:
            return int8_matmul_add_ln_ref(x8, w8, vecs, scalars, r8, gb,
                                          ln_scalars, eps=eps,
                                          res_quant=res_quant, w4=w4,
                                          norm=norm, in_mode=in_mode,
                                          in_grid=in_grid)
        if in_mode != "i8":
            raise NotImplementedError("int8_matmul_add_ln kernel: a float "
                                      "context edge (in_mode='f') with "
                                      "NoNorm is not yet ported")
        return _matmul_nonorm(x8, w8, vecs, scalars, r8, gb, ln_scalars,
                              res_quant=res_quant, w4=w4)
    if norm != "layernorm":
        raise ValueError(f"unknown norm {norm!r}")
    y8 = int8_matmul(x8, w8, vecs, scalars, activation=None,
                     out_mode="emit", w4=w4, in_mode=in_mode,
                     in_grid=in_grid)
    return fused_add_ln_payload(y8, r8, gb, fold_ln_scalars(vecs, ln_scalars),
                                eps=eps, res_quant=res_quant)


def int8_ffn_ln(x8, wi, vi, si, wd, vd, sd, r8, gb, ln_scalars, lnv=None, *,
                activation, eps, res_quant=True, w4i=False, w4d=False,
                norm="layernorm", in_mode="i8", res_mode="i8", h_bits=8,
                y_bits=8, ln_out="emit", ln_bits=8, inter_mode="i8",
                inter_bits=8, x_grid=None, i_grid=None):
    """The FFN block; see :func:`int8_ffn_ln_ref`: inter matmul (act; the
    float-edge kernel when ``in_mode='f'``; the inter site emitted, or
    folded on its ``inter_bits`` grid when ``inter_mode='f'``) -> dense
    matmul (the float-edge kernel on ``i_grid`` for a float inter edge;
    fold on the ``h_bits`` grid, float32 out) -> :func:`flex_add_ln`. The
    dense fold value reaches the add+LN as float32, so the fold site may be
    per-tensor or per-column (three launches, and a level pass for each
    float edge). NoNorm (all-int8 sites only): inter matmul -> dense
    :func:`int8_matmul_add_ln`, two launches."""
    inter_mode = _edge_mode(inter_mode, "inter_mode")
    if norm == "nonorm":
        flex = (in_mode, res_mode, h_bits, y_bits, ln_out, ln_bits,
                lnv is None, inter_mode)
        if flex != ("i8", "i8", 8, 8, "emit", 8, True, "i8"):
            raise NotImplementedError("int8_ffn_ln: flex sites with NoNorm "
                                      "are not yet ported")
        i8 = int8_matmul(x8, wi, vi, si, activation=activation,
                         out_mode="emit", w4=w4i)
        return int8_matmul_add_ln(i8, wd, vd, sd, r8, gb, ln_scalars,
                                  eps=eps, res_quant=res_quant, w4=w4d,
                                  norm="nonorm")
    i8 = int8_matmul(x8, wi, vi, si, activation=activation,
                     out_mode="emit" if inter_mode == "i8" else "fold",
                     out_bits=8 if inter_mode == "i8" else inter_bits,
                     w4=w4i, in_mode=in_mode, in_grid=x_grid)
    y = int8_matmul(i8, wd, vd, sd, activation=None, out_mode="fold",
                    w4=w4d, out_bits=h_bits, in_mode=inter_mode,
                    in_grid=i_grid)
    return flex_add_ln(y, r8, gb, ln_scalars, lnv, eps=eps,
                       res_quant=res_quant, res_mode=res_mode,
                       res_bits=y_bits, ln_bits=ln_bits, ln_out=ln_out)


def int8_attn_ln(x8, wq, vq, sq, mask_bias, attn_scal, wo, vo, so, gb,
                 ln_scalars, lnv=None, *, n_heads, seq, eps, res_quant=True,
                 skip_max=False, w4q=False, w4o=False, ln_out="emit",
                 ln_bits=8, attn_bits=(8, 8), in_mode="i8", qkv_mode="i8",
                 qkv_bits=8, g_bits=8, u_bits=8, in_grid=None,
                 ctx_grid=None):
    """The attention block; see :func:`int8_attn_ln_ref`: qkv matmul (a
    float layer input on the float-edge kernel; q / k / v emitted, or
    folded on their ``qkv_bits`` grid for the value-space attention) ->
    attention -> attn_out matmul (the float-edge kernel or the float x
    int8 one for a float context edge; fold on the ``g_bits`` grid,
    float32 out) -> :func:`flex_add_ln` with the layer input (payload or
    value) as the residual (four launches, and a level pass for each
    float edge on a grid)."""
    in_mode = _edge_mode(in_mode, "in_mode")
    qf = _edge_mode(qkv_mode, "qkv_mode") == "f"
    qkv = int8_matmul(x8, wq, vq, sq, activation=None,
                      out_mode="fold" if qf else "emit",
                      out_bits=qkv_bits if qf else 8, w4=w4q,
                      in_mode=in_mode, in_grid=in_grid)
    c = int8_attention(qkv, mask_bias, attn_scal, n_heads=n_heads, seq=seq,
                       skip_max=skip_max, attn_bits=attn_bits,
                       dots="f32" if qf else "i8")
    y = int8_matmul(c, wo, vo, so, activation=None, out_mode="fold",
                    w4=w4o, out_bits=g_bits, in_mode=_ctx_mode(attn_bits),
                    in_grid=ctx_grid)
    return flex_add_ln(y, x8, gb, ln_scalars, lnv, eps=eps,
                       res_quant=res_quant, res_mode=in_mode, res_bits=u_bits,
                       ln_bits=ln_bits, ln_out=ln_out)


def int8_layer_ln(x8, wq, vq, sq, mask_bias, attn_scal, wo, vo, so, gb1,
                  ln1_scal, wi, vi, si, wd, vd, sd, gb2, ln2_scal, *,
                  n_heads, seq, eps, activation, res1=True, res2=True,
                  skip_max=False, w4q=False, w4o=False, w4i=False, w4d=False,
                  attn_bits=(8, 8), ctx_grid=None):
    """A whole all-int8 encoder layer as the chain qkv matmul -> attention
    -> attn_out matmul -> add+LN -> inter matmul -> dense matmul -> add+LN
    (four matmul, one attention and two add+LN launches); both fold sites
    8-bit per-tensor, as the engine plans it. Attention sites other than
    8-bit take the attention's second kernel, and a float context edge the
    float-edge matmul (``ctx_grid``, with its level pass) or the float x
    int8 one into attn_out."""
    qkv8 = int8_matmul(x8, wq, vq, sq, activation=None, out_mode="emit",
                       w4=w4q)
    c8 = int8_attention(qkv8, mask_bias, attn_scal, n_heads=n_heads,
                        seq=seq, skip_max=skip_max, attn_bits=attn_bits)
    hx8 = int8_matmul_add_ln(c8, wo, vo, so, x8, gb1, ln1_scal, eps=eps,
                             res_quant=res1, w4=w4o,
                             in_mode=_ctx_mode(attn_bits), in_grid=ctx_grid)
    i8 = int8_matmul(hx8, wi, vi, si, activation=activation, out_mode="emit",
                     w4=w4i)
    return int8_matmul_add_ln(i8, wd, vd, sd, hx8, gb2, ln2_scal, eps=eps,
                              res_quant=res2, w4=w4d)


# ---------------------------------------------------------------------------
# MobileBERT's inverted-bottleneck layer
# ---------------------------------------------------------------------------


def mb_layer_flat(lp: Dict, attn_case: str) -> Tuple[Tensor, ...]:
    """Flatten one MobileBERT layer plan (``build_mobilebert_engine``) into
    the order :func:`int8_mb_layer_ln` takes: (w, vecs, scal) per matmul
    and (gb, scal) per NoNorm, as the JAX ``mb_layer_flat``."""
    def mm(p):
        return (p["w"], p["vecs"], p["scal"])

    def nrm(p):
        return (p["gb"], p["scal"])

    out = [*mm(lp["bn_in"]), *nrm(lp["bn_in_norm"])]
    if attn_case == "shared_kq":
        out += [*mm(lp["bn_attn"]), *nrm(lp["bn_attn_norm"])]
    out += [*mm(lp["qk"]), *mm(lp["v"])]
    out += [*mm(lp["attn_out"]), *nrm(lp["attn_out_norm"])]
    for f in lp["ffns"]:
        out += [*mm(f["inter"]), *mm(f["dense"]), *nrm(f["norm"])]
    out += [*mm(lp["inter"]), *mm(lp["out"]), *nrm(lp["out_norm"])]
    out += [*mm(lp["out_bn"]), *nrm(lp["out_bn_norm"])]
    return tuple(out)


def mb_layer_chain(h8, mask_bias, attn_scal, flat, *, n_heads, seq, hidden,
                   attn_case, activation, res, w4, n_ffn, skip_max=False,
                   attn_bits=(8, 8), plain=False, attn_plain=None):
    """A whole MobileBERT layer as the JAX engine's per-op route
    (``fuse_layer=False``): bottleneck-in (and shared key/query) NoNorm
    matmuls -> [q | k] and v matmuls -> attention over ``cols=(0, 1, 0)``
    -> attn_out + NoNorm -> each FFN (inter + act, dense + NoNorm) ->
    bottleneck-out + NoNorm. ``flat``, ``res`` and ``w4`` as
    :func:`int8_mb_layer_ln`. The kernel wrappers, or with ``plain`` each
    step's plain version (``attn_plain``, when given, for the attention:
    the engine's mixed backends); on the card per layer (shared_kq, 3
    stacked FFNs): 6 :func:`int8_matmul`, 8 :func:`int8_matmul_norm` and
    one :func:`int8_attention_qkv` launch."""
    attn_plain = plain if attn_plain is None else attn_plain
    mm = int8_matmul_ref if plain else int8_matmul
    mm_norm = int8_matmul_norm_ref if plain else int8_matmul_norm
    mm_add_norm = int8_matmul_add_ln_ref if plain else int8_matmul_add_ln
    ffn = int8_ffn_ln_ref if plain else int8_ffn_ln
    attn = int8_attention_qkv_ref if attn_plain else int8_attention_qkv
    it = iter(flat)
    w4s = iter(w4)
    res_ao, res_ffn, res_out, res_obn = res
    nkw = dict(eps=0.0, norm="nonorm")

    def take(n):
        return [next(it) for _ in range(n)]

    def norm_branch(x8):
        w, v, s, gb, ns = take(5)
        return mm_norm(x8, w, v, s, gb, ns, res_quant=False, w4=next(w4s),
                       **nkw)

    def ffn_block(x8, res_q):
        wi, vi, si, wd, vd, sd, gb, ns = take(8)
        return ffn(x8, wi, vi, si, wd, vd, sd, x8, gb, ns,
                   activation=activation, res_quant=res_q, w4i=next(w4s),
                   w4d=next(w4s), **nkw)

    li8 = norm_branch(h8)
    if attn_case == "bottleneck":
        qk_in, v_in = li8, li8
    elif attn_case == "shared_kq":
        qk_in, v_in = norm_branch(h8), h8
    elif attn_case == "plain":
        qk_in, v_in = h8, h8
    else:
        raise ValueError(f"unknown attn_case {attn_case!r}")
    wq, vq, sq, wv, vv, sv = take(6)
    qk8 = mm(qk_in, wq, vq, sq, activation=None, out_mode="emit",
             w4=next(w4s))
    v8 = mm(v_in, wv, vv, sv, activation=None, out_mode="emit", w4=next(w4s))
    c8 = attn(qk8, qk8, v8, mask_bias, attn_scal, n_heads=n_heads, seq=seq,
              hidden=hidden, cols=(0, 1, 0), skip_max=skip_max,
              attn_bits=attn_bits)
    wo, vo, so, gb, ns = take(5)
    x8 = mm_add_norm(c8, wo, vo, so, li8, gb, ns, res_quant=res_ao,
                     w4=next(w4s), **nkw)
    for j in range(n_ffn):
        x8 = ffn_block(x8, res_ffn[j])
    y8 = ffn_block(x8, res_out)
    wb, vb, sb, gb, ns = take(5)
    return mm_add_norm(y8, wb, vb, sb, h8, gb, ns, res_quant=res_obn,
                       w4=next(w4s), **nkw)


def int8_mb_layer_ln_ref(h8, mask_bias, attn_scal, flat, *, n_heads, seq,
                         hidden, attn_case, activation, res, w4, n_ffn,
                         skip_max=False, attn_bits=(8, 8)):
    """Plain version of :func:`int8_mb_layer_ln`: the layer's chain on the
    plain versions (the JAX megakernel is bit-identical to its chain)."""
    return mb_layer_chain(h8, mask_bias, attn_scal, flat, n_heads=n_heads,
                          seq=seq, hidden=hidden, attn_case=attn_case,
                          activation=activation, res=res, w4=w4, n_ffn=n_ffn,
                          skip_max=skip_max, attn_bits=attn_bits, plain=True)
