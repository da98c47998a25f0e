"""Kernels of the full-handoff int8 engine: plain versions and wrappers.

Counterpart of ``transformer_quantization_tpu/ops/pallas/engine_kernels.py``.
Activations travel between matmuls as int8 payloads: value
``s * (p + shift)``, ``shift = 128 - zero_point`` for asymmetric sites.

Three kernels are written by hand for Hopper (``csrc/``):

- :func:`int8_matmul` -- payload matmul with the dequant fold, bias,
  optional ``gelu_new``, and a per-column output site (``emit`` int8
  payload, ``fold`` fake-quantized float, or raw ``float``);
- :func:`int8_attention` -- scores, scores site, exp2 softmax, probs
  payload, probs @ v and the context payload, per (batch row, head);
- :func:`fused_add_ln_payload` -- payload + payload residual add, res
  site, one-pass LayerNorm, ln payload.

An H100 SM cannot hold whole weight matrices the way the TPU kernels held
them in VMEM, so the TPU's fused forms are thin compositions here with the
JAX signatures; the JAX package states each fused form bit-identical to
the chain: :func:`int8_matmul_add_ln` = matmul(emit on the fold site) ->
add+LN; :func:`int8_ffn_ln` = matmul(act, emit) -> matmul_add_ln;
:func:`int8_layer_ln` = qkv matmul -> attention -> matmul_add_ln ->
ffn_ln, seven launches per encoder layer.

Each ``*_ref`` repeats the JAX ``*_ref`` operation for operation (same
association order, division where it divides), with one deliberate
difference: the row sums of the softmax and of LayerNorm accumulate in
float64 and round once to float32, and LayerNorm takes ``1 / sqrt`` (both
IEEE-rounded) for ``rsqrt``. The result then does not depend on the
summation order or the device, so the kernels, which do the same, agree
with these versions bit for bit; against the JAX oracles (float32 sums)
a payload may sit one level off on rare elements. A wrapper runs the
plain version for a tensor on the CPU; for a CUDA tensor it launches its
kernel or raises. :data:`LAUNCHES` counts kernel launches per wrapper.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from transformer_quantization_tpu_torch.ops.int_linear import exact_int_matmul
from transformer_quantization_tpu_torch.ops.kernels import build as KB
from transformer_quantization_tpu_torch.ops.kernels.activations import (
    ACTS,
    GELU_NEW_C,
)

Tensor = torch.Tensor

# kernel launches per wrapper; a wrapper adds one only where it launches
LAUNCHES: Dict[str, int] = {"int8_matmul": 0, "int8_attention": 0,
                            "fused_add_ln_payload": 0}

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


def _require_i8(w4: bool, in_mode: str, what: str) -> None:
    if w4:
        raise NotImplementedError(f"{what}: int4 weights (w4) are not yet "
                                  "ported")
    if in_mode != "i8":
        raise NotImplementedError(f"{what}: float input edges "
                                  "(in_mode='f') are not yet ported")


# ---------------------------------------------------------------------------
# Plain versions (mirrors of the JAX *_ref oracles)
# ---------------------------------------------------------------------------


def int8_matmul_ref(x8, w8, vecs, scalars, *, activation=None,
                    out_mode="emit", w4=False, in_mode="i8"):
    """``act(s_x s_w (x8 @ w8^T + shift colsum) + b)`` then the per-column
    output site. ``vecs`` rows: [wscale, colsum, bias, out_s, out_shift];
    ``scalars``: (1, 2) [in_s, in_shift]."""
    _require_i8(w4, in_mode, "int8_matmul")
    acc = exact_int_matmul(x8, w8).to(torch.float32)
    in_s, in_shift = scalars[0, 0], scalars[0, 1]
    y = (in_s * vecs[0]) * (acc + in_shift * vecs[1]) + vecs[2]
    act = ACTS[activation]
    if act is not None:
        y = act(y)
    if out_mode == "float":
        return y
    r = torch.clamp(torch.round(y / vecs[3]) - vecs[4], -128.0, 127.0)
    if out_mode == "emit":
        return r.to(torch.int8)
    return vecs[3] * (r + vecs[4])


def _emit_ctx(ctx, pv_over_c, c_s, c_sh, c_bits: int):
    if not 1 <= c_bits <= 8:
        raise NotImplementedError("float context edges are not yet ported")
    lo, hi = _clip_bounds(c_bits)
    return torch.clamp(torch.round(ctx * pv_over_c) - c_sh, lo, hi).to(
        torch.int8)


def int8_attention_ref(qkv8, mask_bias, scalars, *, n_heads, seq,
                       skip_max=False, attn_bits=(8, 8)):
    """Attention over the fused q|k|v payload (``dots='i8'`` form):
    scores -> scores site -> 1/sqrt(d) + mask -> exp2 softmax -> probs
    payload -> probs @ v with rank-1 shift corrections -> context payload.
    ``scalars`` (1, 12): [q_s, q_sh, k_s, k_sh, v_s, v_sh, sc_s, sc_sh,
    p_s, p_sh, c_s, c_sh]."""
    sc_bits, p_bits, c_bits = _attn3(attn_bits)
    if not (1 <= sc_bits <= 8 and 1 <= p_bits <= 8):
        raise NotImplementedError("16-bit or disabled scores/probs sites "
                                  "are not yet ported")
    mt, h3 = qkv8.shape
    h = h3 // 3
    d = h // n_heads
    b = mt // seq
    s = scalars[0]
    q8, k8, v8 = (qkv8[:, i * h:(i + 1) * h].reshape(b, seq, n_heads, d)
                  for i in range(3))
    acc = exact_int_matmul(q8.permute(0, 2, 1, 3),
                           k8.permute(0, 2, 1, 3)).to(torch.float32)
    qsum = torch.sum(q8.to(torch.float32), dim=-1)  # (b, T, n)
    ksum = torch.sum(k8.to(torch.float32), dim=-1)
    scr = (acc + s[1] * ksum.permute(0, 2, 1)[:, :, None, :]
           + s[3] * qsum.permute(0, 2, 1)[:, :, :, None]
           + d * s[1] * s[3])
    rsqrt_d = float(np.float32(1.0 / np.sqrt(d)))
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


def _ln_body_ref(x, gb, sv, *, eps, res_quant, res_bits=8, ln_bits=8):
    """res-site fake-quant -> one-pass LayerNorm -> ln-site levels."""
    res_s, res_sh, ln_s, ln_sh = sv
    if res_quant:
        lo, hi = _clip_bounds(res_bits)
        x = fakequant_f32(x, res_s, res_sh, lo, hi)
    mean = _row_mean(x)
    ms = _row_mean(x * x)
    var = torch.clamp(ms - mean * mean, min=0.0)
    z = (x - mean) * (1.0 / torch.sqrt(var + eps)) * gb[0] + gb[1]
    lo, hi = _clip_bounds(ln_bits)
    return torch.clamp(torch.round(z / ln_s) - ln_sh, lo, hi)


def _ln_ref_body(x, gb, s, *, eps, res_quant):
    return _ln_body_ref(x, gb, (s[4], s[5], s[6], s[7]), eps=eps,
                        res_quant=res_quant)


def fused_add_ln_payload_ref(y8, r8, gb, scalars, *, eps, res_quant=True):
    """Payload add -> res site -> LayerNorm -> ln payload. ``scalars``
    (1, 8): [y_s, y_sh, r_s, r_sh, res_s, res_sh, ln_s, ln_sh]."""
    s = scalars[0]
    x = (s[0] * (y8.to(torch.float32) + s[1])
         + s[2] * (r8.to(torch.float32) + s[3]))
    return _ln_ref_body(x, gb, s, eps=eps, res_quant=res_quant).to(
        torch.int8)


def int8_matmul_add_ln_ref(x8, w8, vecs, scalars, r8, gb, ln_scalars, *,
                           eps, res_quant=True, w4=False, in_mode="i8"):
    """Matmul with the fold site -> + residual payload -> res site -> LN ->
    ln payload."""
    y = int8_matmul_ref(x8, w8, vecs, scalars, activation=None,
                        out_mode="fold", w4=w4, in_mode=in_mode)
    s = ln_scalars[0]
    y = y + s[2] * (r8.to(torch.float32) + s[3])
    return _ln_ref_body(y, gb, s, eps=eps, res_quant=res_quant).to(
        torch.int8)


def int8_ffn_ln_ref(x8, wi, vi, si, wd, vd, sd, r8, gb, ln_scalars, *,
                    activation, eps, res_quant=True, w4i=False, w4d=False):
    """Inter matmul + act -> inter payload -> dense matmul (fold) ->
    + residual -> LN -> ln payload."""
    i8 = int8_matmul_ref(x8, wi, vi, si, activation=activation, w4=w4i,
                         out_mode="emit")
    y = int8_matmul_ref(i8, wd, vd, sd, activation=None, out_mode="fold",
                        w4=w4d)
    s = ln_scalars[0]
    y = y + s[2] * (r8.to(torch.float32) + s[3])
    return _ln_ref_body(y, gb, s, eps=eps, res_quant=res_quant).to(
        torch.int8)


def int8_attn_ln_ref(x8, wq, vq, sq, mask_bias, attn_scal, wo, vo, so, gb,
                     ln_scalars, *, n_heads, seq, eps, res_quant=True,
                     skip_max=False, w4q=False, w4o=False,
                     attn_bits=(8, 8)):
    """q|k|v matmul -> attention -> attn_out (fold) -> + layer input ->
    LN -> ln payload (the all-int8 form)."""
    qkv8 = int8_matmul_ref(x8, wq, vq, sq, activation=None,
                           out_mode="emit", w4=w4q)
    c8 = int8_attention_ref(qkv8, mask_bias, attn_scal, n_heads=n_heads,
                            seq=seq, skip_max=skip_max, attn_bits=attn_bits)
    y = int8_matmul_ref(c8, wo, vo, so, activation=None, out_mode="fold",
                        w4=w4o)
    s = ln_scalars[0]
    y = y + s[2] * (x8.to(torch.float32) + s[3])
    return _ln_ref_body(y, gb, s, eps=eps, res_quant=res_quant).to(
        torch.int8)


def int8_layer_ln_ref(x8, wq, vq, sq, mask_bias, attn_scal, wo, vo, so,
                      gb1, ln1_scal, wi, vi, si, wd, vd, sd, gb2, ln2_scal,
                      *, n_heads, seq, eps, activation, res1=True, res2=True,
                      skip_max=False, w4q=False, w4o=False, w4i=False,
                      w4d=False, attn_bits=(8, 8)):
    """A whole all-int8 encoder layer: attention block then FFN block."""
    hx8 = int8_attn_ln_ref(x8, wq, vq, sq, mask_bias, attn_scal, wo, vo, so,
                           gb1, ln1_scal, n_heads=n_heads, seq=seq, eps=eps,
                           res_quant=res1, skip_max=skip_max, w4q=w4q,
                           w4o=w4o, attn_bits=attn_bits)
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
    # the kernels read int8 rows in 16-byte vectors
    if dtype == torch.int8 and t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary")


def _same_device(*ts: Tensor) -> None:
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devs))}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


_MM_ACTS = {None: 0, "gelu_new": 1}
_MM_OUT = {"emit": 0, "fold": 1, "float": 2}


def int8_matmul(x8, w8, vecs, scalars, *, activation=None, out_mode="emit",
                w4=False, in_mode="i8"):
    """Payload matmul; see :func:`int8_matmul_ref`. On the card: int8
    tensor-core product (``mma.sync`` m16n8k32) with the fold, activation
    and output site in the epilogue (``csrc/int8_matmul.cu``)."""
    if not x8.is_cuda:
        return int8_matmul_ref(x8, w8, vecs, scalars, activation=activation,
                               out_mode=out_mode, w4=w4, in_mode=in_mode)
    _require_i8(w4, in_mode, "int8_matmul")
    if activation not in _MM_ACTS:
        raise NotImplementedError(f"int8_matmul kernel: activation "
                                  f"{activation!r} is not yet ported")
    m, k = x8.shape
    n = w8.shape[0]
    _check(x8, "x8", torch.int8)
    _check(w8, "w8", torch.int8, (n, k))
    _check(vecs, "vecs", torch.float32, (5, n))
    _check(scalars, "scalars", torch.float32, (1, 2))
    _same_device(x8, w8, vecs, scalars)
    if k % 16 or n % 8:
        raise ValueError(f"int8_matmul kernel needs K % 16 == 0 and "
                         f"N % 8 == 0 (got K={k}, N={n})")
    out = torch.empty((m, n), device=x8.device,
                      dtype=torch.int8 if out_mode == "emit"
                      else torch.float32)
    fn = KB.load("int8_matmul")
    err = fn(x8.data_ptr(), w8.data_ptr(), vecs.data_ptr(),
             scalars.data_ptr(), out.data_ptr(), m, n, k,
             _MM_ACTS[activation], _MM_OUT[out_mode], GELU_NEW_C, _stream())
    KB.check(err, "int8_matmul")
    LAUNCHES["int8_matmul"] += 1
    return out


ATTN_SHAPES = ((32, 64), (64, 64), (128, 64))  # (seq, head_dim) built


def int8_attention(qkv8, mask_bias, scalars, *, n_heads, seq,
                   skip_max=False, attn_bits=(8, 8)):
    """Fused attention over the q|k|v payload; see
    :func:`int8_attention_ref`. On the card: one block per (batch row,
    head), both products on int8 tensor cores (``csrc/int8_attention.cu``).
    """
    if not qkv8.is_cuda:
        return int8_attention_ref(qkv8, mask_bias, scalars, n_heads=n_heads,
                                  seq=seq, skip_max=skip_max,
                                  attn_bits=attn_bits)
    if _attn3(attn_bits) != (8, 8, 8):
        raise NotImplementedError("int8_attention kernel: only 8-bit "
                                  "scores/probs/context sites are ported")
    mt, h3 = qkv8.shape
    h = h3 // 3
    d = h // n_heads
    b = mt // seq
    if (seq, d) not in ATTN_SHAPES or b * seq != mt or d * n_heads != h:
        raise NotImplementedError(f"int8_attention kernel: (seq, head_dim)"
                                  f" = ({seq}, {d}) is not built "
                                  f"(built: {ATTN_SHAPES})")
    _check(qkv8, "qkv8", torch.int8)
    _check(mask_bias, "mask_bias", torch.float32, (b, seq))
    _check(scalars, "scalars", torch.float32, (1, 12))
    _same_device(qkv8, mask_bias, scalars)
    out = torch.empty((mt, h), device=qkv8.device, dtype=torch.int8)
    fn = KB.load("int8_attention")
    err = fn(qkv8.data_ptr(), mask_bias.data_ptr(), scalars.data_ptr(),
             out.data_ptr(), b, seq, h, n_heads,
             float(np.float32(1.0 / np.sqrt(d))), LOG2E, int(skip_max),
             _stream())
    KB.check(err, "int8_attention")
    LAUNCHES["int8_attention"] += 1
    return out


def fused_add_ln_payload(y8, r8, gb, scalars, *, eps, res_quant=True):
    """Payload-in/payload-out add + LayerNorm; see
    :func:`fused_add_ln_payload_ref`. On the card: one warp per row
    (``csrc/add_ln_payload.cu``)."""
    if not y8.is_cuda:
        return fused_add_ln_payload_ref(y8, r8, gb, scalars, eps=eps,
                                        res_quant=res_quant)
    m, h = y8.shape
    _check(y8, "y8", torch.int8)
    _check(r8, "r8", torch.int8, (m, h))
    _check(gb, "gb", torch.float32, (2, h))
    _check(scalars, "scalars", torch.float32, (1, 8))
    _same_device(y8, r8, gb, scalars)
    if h % 128 or h > 1024:
        raise NotImplementedError(f"fused_add_ln_payload kernel needs "
                                  f"H % 128 == 0 and H <= 1024 (got {h})")
    out = torch.empty((m, h), device=y8.device, dtype=torch.int8)
    fn = KB.load("add_ln_payload")
    err = fn(y8.data_ptr(), r8.data_ptr(), gb.data_ptr(), scalars.data_ptr(),
             out.data_ptr(), m, h, float(eps), int(res_quant), _stream())
    KB.check(err, "fused_add_ln_payload")
    LAUNCHES["fused_add_ln_payload"] += 1
    return out


# ---------------------------------------------------------------------------
# The TPU's fused forms as chains of the three kernels
# ---------------------------------------------------------------------------


def fold_ln_scalars(vecs: Tensor, ln_scalars: Tensor) -> Tensor:
    """The add+LN scalars with [y_s, y_sh] read from the producing matmul's
    fold site (``vecs`` rows 3/4). The fold site is per-tensor in every
    ported plan (per-column fold sites are PEG recipes, not yet ported),
    so column 0 carries it."""
    return torch.cat([vecs[3:5, 0], ln_scalars[0, 2:]]).reshape(1, 8)


def int8_matmul_add_ln(x8, w8, vecs, scalars, r8, gb, ln_scalars, *, eps,
                       res_quant=True, w4=False, in_mode="i8"):
    """Matmul (emit on the fold site) -> :func:`fused_add_ln_payload`;
    bit-identical to :func:`int8_matmul_add_ln_ref`."""
    y8 = int8_matmul(x8, w8, vecs, scalars, activation=None,
                     out_mode="emit", w4=w4, in_mode=in_mode)
    return fused_add_ln_payload(y8, r8, gb, fold_ln_scalars(vecs, ln_scalars),
                                eps=eps, res_quant=res_quant)


def int8_ffn_ln(x8, wi, vi, si, wd, vd, sd, r8, gb, ln_scalars, *,
                activation, eps, res_quant=True, w4i=False, w4d=False):
    """Inter matmul (act, emit) -> :func:`int8_matmul_add_ln`."""
    i8 = int8_matmul(x8, wi, vi, si, activation=activation, out_mode="emit",
                     w4=w4i)
    return int8_matmul_add_ln(i8, wd, vd, sd, r8, gb, ln_scalars, eps=eps,
                              res_quant=res_quant, w4=w4d)


def int8_layer_ln(x8, wq, vq, sq, mask_bias, attn_scal, wo, vo, so, gb1,
                  ln1_scal, wi, vi, si, wd, vd, sd, gb2, ln2_scal, *,
                  n_heads, seq, eps, activation, res1=True, res2=True,
                  skip_max=False, w4q=False, w4o=False, w4i=False, w4d=False,
                  attn_bits=(8, 8)):
    """A whole all-int8 encoder layer as the chain qkv matmul -> attention
    -> attn_out matmul -> add+LN -> inter matmul -> dense matmul -> add+LN
    (four matmul, one attention and two add+LN launches)."""
    qkv8 = int8_matmul(x8, wq, vq, sq, activation=None, out_mode="emit",
                       w4=w4q)
    c8 = int8_attention(qkv8, mask_bias, attn_scal, n_heads=n_heads,
                        seq=seq, skip_max=skip_max, attn_bits=attn_bits)
    hx8 = int8_matmul_add_ln(c8, wo, vo, so, x8, gb1, ln1_scal, eps=eps,
                             res_quant=res1, w4=w4o)
    return int8_ffn_ln(hx8, wi, vi, si, wd, vd, sd, hx8, gb2, ln2_scal,
                       activation=activation, eps=eps, res_quant=res2,
                       w4i=w4i, w4d=w4d)
