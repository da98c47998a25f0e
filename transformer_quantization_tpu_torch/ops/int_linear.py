"""Real-integer (INT8) linear algebra on torch tensors.

Counterpart of ``transformer_quantization_tpu/ops/int_linear.py``: weights
stored as int8, activations re-quantized to int8 payloads on entry, the
matmul accumulated exactly in integers and the dequantization folded in:

    y = s_x * s_w * (x_q @ w_q^T + (128 - z_x) * colsum(w_q))

PyTorch has no general int8 x int8 -> int32 matmul on CUDA, so
:func:`exact_int_matmul` computes the integer product as a floating-point
product of the integer values, in float32 where every partial sum stays
below 2^24 (exact) and in float64 otherwise. 4-bit weights may be stored
as split-half packed int4 (:func:`pack_weight_int4`): two nibbles a byte,
unpacked to int8 before the exact product.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from transformer_quantization_tpu_torch.quant import quantizers as Q

Tensor = torch.Tensor


def exact_int_matmul(a: Tensor, b_t: Tensor) -> Tensor:
    """``a @ b_t^T`` for integer-valued int8 tensors (contraction on the
    last dim of both), as an exact int32 tensor.

    float32 holds every partial sum exactly while K * 128 * 128 <= 2^24
    (K <= 1024) and TF32 is off; wider contractions run in float64, exact
    for any K here. Both products round nothing, so the result equals an
    integer matmul whatever the summation order.
    """
    k = a.shape[-1]
    if k * 128 * 128 <= 2 ** 24:
        if a.is_cuda and torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError("exact_int_matmul needs TF32 off "
                               "(torch.backends.cuda.matmul.allow_tf32)")
        dt = torch.float32
    else:
        dt = torch.float64
    acc = torch.matmul(a.to(dt), b_t.to(dt).transpose(-1, -2))
    return acc.to(torch.int32)


def can_pack_weight(spec: Q.QuantizerSpec) -> bool:
    return spec.symmetric and spec.n_bits <= 8


def pack_weight_int8(spec: Q.QuantizerSpec, qp: Q.QuantParams,
                     w: Tensor, alpha: Optional[Tensor] = None) -> Dict:
    """Quantize a ``(O, I)`` weight to a real int8 payload (4-bit
    levels too): ``w_int``, ``scale`` ``(1,)`` or ``(O,)``, ``colsum``
    ``(O,)`` (sum over the contraction dim, for the activation zero-point
    correction). ``alpha`` applies AdaRound's hard decision,
    ``floor(w / s) + (alpha >= 0)``, instead of round-to-nearest."""
    if not can_pack_weight(spec):
        raise ValueError("int8 packing needs symmetric <=8-bit weights")
    qpe = Q.expand_qparams(qp, w.ndim, 0)
    scale = Q.scale_of(spec, qpe)
    int_min, int_max = Q.int_min_max(spec, qp.signed)
    if alpha is not None:
        w_round = torch.floor(w / scale) + (alpha >= 0).to(torch.float32)
    else:
        w_round = torch.round(w / scale)
    w_int = torch.clamp(w_round, int_min, int_max).to(torch.int8)
    return {
        "w_int": w_int,
        "scale": Q.scale_of(spec, qp).reshape(-1).to(torch.float32),
        "colsum": w_int.to(torch.float32).sum(dim=-1),
        "n_bits": spec.n_bits,
    }


def _weight_ints(packed: Dict) -> Tensor:
    """The ``(O, I)`` int8 levels of a packed weight (int8 or int4)."""
    if "w_packed" in packed:
        return unpack_int4(packed["w_packed"], packed["in_features"])
    return packed["w_int"]


def dequantize_packed_weight(packed: Dict) -> Tensor:
    """Packed int8 / int4 weight -> the dequantized float32 ``(O, I)``
    tensor (the W4A32 weight-only form for int4)."""
    return _weight_ints(packed).to(torch.float32) * packed["scale"][:, None]


def quantize_activation_int8(spec: Q.QuantizerSpec, qp: Q.QuantParams,
                             x: Tensor):
    """Float activation -> ``(x_int8, scale, shift)`` with the true integer
    value ``x_int8 + shift``: asymmetric grids shift by -128."""
    scale = Q.scale_of(spec, qp)
    zp = Q.zero_point_of(spec, qp)
    int_min, int_max = Q.int_min_max(spec, qp.signed)
    if x.dtype in (torch.bfloat16, torch.float16):
        x = x.to(torch.float32)
    x_int = torch.clamp(torch.round(x / scale) + zp, int_min, int_max)
    if not spec.symmetric:
        x_int = x_int - 128.0
        shift = 128.0 - zp
    else:
        shift = torch.zeros_like(zp)
    return x_int.to(torch.int8), scale.to(torch.float32), shift


def dequantize_activation_int8(spec: Q.QuantizerSpec, qp: Q.QuantParams,
                               x_int8: Tensor) -> Tensor:
    """Inverse of :func:`quantize_activation_int8`: payload -> floats."""
    scale = Q.scale_of(spec, qp)
    zp = Q.zero_point_of(spec, qp)
    x = x_int8.to(torch.float32)
    if not spec.symmetric:
        x = x + 128.0
    return scale * (x - zp)


def int8_linear(x_int8: Tensor, x_scale: Tensor, x_shift: Tensor,
                packed: Dict, bias: Optional[Tensor],
                activation=None) -> Tensor:
    """Int8 matmul (exact int32 accumulation) + dequant fold + bias +
    optional activation."""
    acc = exact_int_matmul(x_int8, _weight_ints(packed)).to(torch.float32)
    acc = acc + x_shift * packed["colsum"]
    y = (x_scale * packed["scale"]) * acc
    if bias is not None:
        y = y + bias
    if activation is not None:
        y = activation(y)
    return y


def _q8(spec: Q.QuantizerSpec, qp: Q.QuantParams, x: Tensor):
    x8, s, shift = quantize_activation_int8(spec, qp, x)
    return x8, s.reshape(()), shift.reshape(())


# Integer attention (the JAX ops/int_linear.py forms): with a = s_a (a8 +
# sa) and b = s_b (b8 + sb) per-tensor, sum_d a b = s_a s_b (a8.b8 + sa
# rowsum(b8) + sb rowsum(a8) + d sa sb); a8.b8 is exact_int_matmul's (a
# float32 product of int8 levels, exact with TF32 off while d * 2^14 <=
# 2^24: d <= 1024; float64 past that).


def int8_attention_scores(q: Tensor, k: Tensor, q_spec, q_qp, k_spec, k_qp
                          ) -> Tensor:
    """(B, T, n, d) x (B, T, n, d) -> (B, n, Tq, Tk) raw attention scores
    from q's and k's int8 levels on their act sites' grids (q and k are
    quantized here: their producers' fake-quant may be skipped)."""
    d = q.shape[-1]
    q8, s_q, sh_q = _q8(q_spec, q_qp, q)
    k8, s_k, sh_k = _q8(k_spec, k_qp, k)
    acc = exact_int_matmul(q8.permute(0, 2, 1, 3),
                           k8.permute(0, 2, 1, 3)).to(torch.float32)
    ksum = torch.sum(k8.to(torch.float32), dim=-1)  # (B, Tk, n)
    qsum = torch.sum(q8.to(torch.float32), dim=-1)  # (B, Tq, n)
    acc = (acc + sh_q * ksum.permute(0, 2, 1)[:, :, None, :]
           + sh_k * qsum.permute(0, 2, 1)[:, :, :, None]
           + d * sh_q * sh_k)
    return (s_q * s_k) * acc


def int8_attention_context(probs: Tensor, v: Tensor, p_spec, p_qp,
                           v_spec, v_qp) -> Tensor:
    """(B, n, Tq, Tk) x (B, Tk, n, d) -> (B, Tq, n, d) attention context
    from the probs' and v's int8 levels."""
    tk = probs.shape[-1]
    p8, s_p, sh_p = _q8(p_spec, p_qp, probs)
    v8, s_v, sh_v = _q8(v_spec, v_qp, v)
    # (B, n, Tq, Tk) x (B, n, d, Tk) -> (B, n, Tq, d)
    acc = exact_int_matmul(p8, v8.permute(0, 2, 3, 1)).to(torch.float32)
    acc = acc.permute(0, 2, 1, 3)                    # (B, Tq, n, d)
    vsum = torch.sum(v8.to(torch.float32), dim=1)    # (B, n, d)
    psum = torch.sum(p8.to(torch.float32), dim=-1)   # (B, n, Tq)
    acc = (acc + sh_p * vsum[:, None, :, :]
           + sh_v * psum.permute(0, 2, 1)[:, :, :, None]
           + tk * sh_p * sh_v)
    return (s_p * s_v) * acc


def int8_grouped_linear(x_int8: Tensor, x_scale: Tensor, x_shift: Tensor,
                        packed: Dict, bias: Optional[Tensor], groups: int,
                        activation=None) -> Tensor:
    """Block-diagonal (grouped) :func:`int8_linear`, SqueezeBERT's
    kernel-size-1 grouped convs: the packed weight is ``(O, I/groups)``
    and output group j contracts input group j only, exactly in integers
    (:func:`exact_int_matmul` a group, the counterpart of XLA's int dot
    in the JAX package). ``colsum`` is per output row over that row's own
    inputs, so the zero-point correction is exact per group."""
    w_int = _weight_ints(packed)
    out_f, in_g = w_int.shape
    lead = x_int8.shape[:-1]
    xg = x_int8.reshape(-1, groups, in_g).transpose(0, 1)
    wg = w_int.reshape(groups, out_f // groups, in_g)
    acc = exact_int_matmul(xg, wg).transpose(0, 1).reshape(*lead, out_f)
    acc = acc.to(torch.float32) + x_shift * packed["colsum"]
    y = (x_scale * packed["scale"]) * acc
    if bias is not None:
        y = y + bias
    if activation is not None:
        y = activation(y)
    return y


def pack_weight_int4(spec: Q.QuantizerSpec, qp: Q.QuantParams,
                     w: Tensor) -> Dict:
    """A symmetric 4-bit ``(O, I)`` weight packed two nibbles a byte in
    the split-half layout ``byte[:, j] = (w[:, j] & 0xF) | ((w[:, j + I/2]
    & 0xF) << 4)`` (uint8, ``(O, I/2)``), bit for bit the JAX package's:
    ``scale`` ``(1,)`` or ``(O,)``, ``colsum`` the float32 sum of the
    levels, ``n_bits`` 4, ``in_features`` I."""
    if not (spec.symmetric and spec.n_bits == 4):
        raise ValueError("int4 packing needs symmetric 4-bit weights")
    qpe = Q.expand_qparams(qp, w.ndim, 0)
    scale = Q.scale_of(spec, qpe)
    int_min, int_max = Q.int_min_max(spec, qp.signed)
    w_int = torch.clamp(torch.round(w / scale), int_min, int_max).to(
        torch.int32)
    i = w_int.shape[1]
    if i % 2:
        raise ValueError(f"int4 packing needs an even in_features, got {i}")
    k2 = i // 2
    packed = (w_int[:, :k2] & 0xF) | ((w_int[:, k2:] & 0xF) << 4)
    return {
        "w_packed": packed.to(torch.uint8),
        "scale": Q.scale_of(spec, qp).reshape(-1).to(torch.float32),
        "colsum": w_int.to(torch.float32).sum(dim=-1),
        "n_bits": 4,
        "in_features": i,
    }


def unpack_int4(packed: Tensor, in_features: int) -> Tensor:
    """Split-half uint8 nibbles ``(O, I/2)`` -> int8 levels ``(O, I)`` in
    [-8, 7] (each nibble sign-extended)."""
    p = packed.to(torch.int16)
    lo, hi = p & 0xF, p >> 4
    lo = torch.where(lo >= 8, lo - 16, lo)
    hi = torch.where(hi >= 8, hi - 16, hi)
    w = torch.cat([lo, hi], dim=1).to(torch.int8)
    if w.shape[1] != in_features:
        raise ValueError(f"packed int4 of {w.shape[1]} columns, expected "
                         f"{in_features}")
    return w


def pack_embedding_int8(spec: Q.QuantizerSpec, qp: Q.QuantParams,
                        table: Tensor) -> Dict:
    """Int8 embedding table, dequantized per gathered row."""
    qpe = Q.expand_qparams(qp, table.ndim, 0)
    scale = Q.scale_of(spec, qpe)
    zp = Q.zero_point_of(spec, qpe)
    int_min, int_max = Q.int_min_max(spec, qp.signed)
    t_int = torch.clamp(torch.round(table / scale) + zp, int_min, int_max)
    if spec.symmetric:
        t_int8 = t_int.to(torch.int8)
        zp8 = torch.zeros_like(zp)
    else:
        t_int8 = (t_int - 128.0).to(torch.int8)
        zp8 = zp - 128.0
    if scale.ndim:
        scale = torch.broadcast_to(scale, (table.shape[0], 1))
        zp8 = torch.broadcast_to(zp8, (table.shape[0], 1))
    return {"t_int": t_int8, "scale": scale.to(torch.float32).contiguous(),
            "zp": zp8.to(torch.float32).contiguous()}


def int8_embedding_lookup(ids: Tensor, packed: Dict) -> Tensor:
    rows = packed["t_int"][ids].to(torch.float32)
    scale, zp = packed["scale"], packed["zp"]
    if scale.ndim:
        scale, zp = scale[ids], zp[ids]
    return scale * (rows - zp)
