"""Fused quantize -> int8 matmul -> dequant epilogue: the generic int
path's linear layer.

Counterpart of ``transformer_quantization_tpu/ops/pallas/int_matmul.py``
(``fused_int8_linear`` / ``_fused_call`` / ``_kernel``). One pass:

    x_int8 = clip(round(x * (1/s_x)) + zp_x)         quantize-on-load
    acc    = x_int8 @ w_int8^T                       exact int32
    y      = (s_x*s_w) * (acc + (128-zp_x)*colsum) + b   dequant + bias
    y      = act(y)
    out    = s_o * (y_int - zp_o), or the output site's int8 payload,
             y_int = clip(round(y * (1/s_o)) + zp_o, imin, imax)

``x`` may already be an int8 payload of its input site (the hand-off of
``ffn.inter.out`` to ``ffn.dense``): quantize-on-load is skipped. The
weight is int8 or split-half packed int4 (W4A8: ``w_int8`` is then the
(N, K/2) uint8 nibbles, ``x_int8[:, :K/2] @ lo^T + x_int8[:, K/2:] @
hi^T``).

:func:`fused_int8_linear_ref` is the plain version, the TPU kernel's
arithmetic in its order (reciprocal products, not quotients, as the TPU
kernel rounds them); its quantize step is :func:`quantize_input_ref`.
:func:`fused_int8_linear` takes the JAX function's arguments and returns
None where the JAX function does whatever the device: an x dtype other
than float32 or int8, a K mismatch, an emitted payload without an 8-bit
output site, a row count that is not a multiple of 8. In place of the
TPU's 128-tile rule it applies the kernel's own, K % 16 and N % 8, on
every device, so the CPU takes the card's route. On CPU tensors it runs
the plain version, on CUDA tensors ``csrc/fused_int8_linear.cu``: a
float32 x is quantized once into an int8 scratch payload
(:func:`quantize_input`'s pass), which the Hopper GEMM then reads; an
int4 weight takes the GEMM's packed-int4 instance, which unpacks each
stage's nibbles in shared memory (K % 32 == 0 there, else None). A
bfloat16 x (the generic path's ``compute_dtype``) is quantized in float32
as the TPU kernel does (its own quantize pass on the card) and its float
or fold output is bfloat16, rounded to nearest even; with a packed int4
weight the card takes a bfloat16 x only to emit the payload.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from transformer_quantization_tpu_torch.ops.int_linear import (
    exact_int_matmul,
    unpack_int4,
)
from transformer_quantization_tpu_torch.ops.kernels import build as KB
from transformer_quantization_tpu_torch.ops.kernels import engine_kernels as EK
from transformer_quantization_tpu_torch.ops.kernels.activations import (
    ACTS,
    GELU_NEW_C,
)
from transformer_quantization_tpu_torch.quant import quantizers as Q

Tensor = torch.Tensor

# the kernel's activation codes ('gelu' is the Abramowitz-Stegun form)
_ACT_CODES = {None: 0, "gelu": 1, "gelu_new": 2, "tanh": 3, "relu": 4,
              "gelu_poly10": 5}
# out_mode codes: no output site (float), fold (float), emit (int8)
_OUT_FLOAT, _OUT_FOLD, _OUT_EMIT = 0, 1, 2


def _out_bounds(out_bits: int, out_sym: bool, signed: Tensor):
    """(imin, imax) of the output site's grid; a symmetric site is signed
    or unsigned by its ``signed`` scalar."""
    top = 2.0 ** out_bits - 1
    if not out_sym:
        return 0.0, top
    half = 2.0 ** (out_bits - 1)
    return (torch.where(signed > 0, -half, 0.0),
            torch.where(signed > 0, half - 1, top))


def quantize_input_ref(x2d: Tensor, scalars: Tensor, asym_in: bool) -> Tensor:
    """The TPU ``_kernel``'s quantize-on-load of the (M, K) float32
    ``x2d``: its input site's int8 payload, ``clip(round(x * (1/s_x)) +
    zp_x, 0, 255) - 128`` (asymmetric) or ``clip(round(x * (1/s_x)),
    -128, 127)`` (symmetric), ``scalars`` (1, 8) as
    :func:`fused_int8_linear_ref`'s. A reciprocal product and fixed
    bounds: not ``ops.int_linear.quantize_activation_int8``, which
    divides and takes a symmetric site's bounds from its sign, and so can
    land a level away."""
    s_x, zp_x = scalars[0, 0], scalars[0, 1]
    xq = torch.round(x2d * (1.0 / s_x)) + (zp_x if asym_in else 0.0)
    if asym_in:
        xq = torch.clamp(xq, 0.0, 255.0) - 128.0
    else:
        xq = torch.clamp(xq, -128.0, 127.0)
    return xq.to(torch.int8)


def fused_int8_linear_ref(x2d: Tensor, w: Tensor, w_scale: Tensor,
                          colsum: Tensor, bias: Optional[Tensor],
                          scalars: Tensor, *, activation, asym_in: bool,
                          out_bits: int, out_sym: bool, out_int8: bool,
                          w4: bool = False) -> Tensor:
    """The TPU ``_kernel``'s arithmetic on (M, K) ``x2d`` (float32,
    bfloat16, or an int8 payload) against the (N, K) int8 ``w`` (``w4``:
    the (N, K/2) split-half packed int4 weight, unpacked first).
    ``scalars`` (1, 8): [s_x, zp_x, s_o, zp_o, signed_o, 0, 0, 0];
    ``out_bits`` 0: no output site. A float or fold output is in the
    dtype of a float x (float32 for a payload x), as the TPU kernel
    stores it."""
    s = scalars[0]
    s_x, zp_x = s[0], s[1]
    x8 = (x2d if x2d.dtype == torch.int8
          else quantize_input_ref(x2d.to(torch.float32), scalars, asym_in))
    out_dtype = torch.float32 if x2d.dtype == torch.int8 else x2d.dtype
    if w4:
        w = unpack_int4(w, x2d.shape[1])
    acc = exact_int_matmul(x8, w).to(torch.float32)
    if asym_in:
        acc = acc + (128.0 - zp_x) * colsum
    y = (s_x * w_scale) * acc
    if bias is not None:
        y = y + bias
    act = ACTS[activation]
    if act is not None:
        y = act(y)
    if not out_bits:
        return y.to(out_dtype)
    s_o, zp_o = s[2], s[3]
    imin, imax = _out_bounds(out_bits, out_sym, s[4])
    y_int = torch.clamp(torch.round(y * (1.0 / s_o)) + zp_o, imin, imax)
    if out_int8:
        return (y_int - (0.0 if out_sym else 128.0)).to(torch.int8)
    return (s_o * (y_int - zp_o)).to(out_dtype)


def _launch(x2d, w, w_scale, colsum, bias, scalars, *, activation, asym_in,
            out_bits, out_sym, out_int8, w4=False) -> Tensor:
    """``csrc/fused_int8_linear.cu`` on CUDA tensors: for a float32 or
    bfloat16 x the quantize pass into a scratch payload, then the GEMM
    (``w4``: its packed-int4 instance on the (N, K/2) weight), in one
    call."""
    m, k = x2d.shape
    n = w.shape[0]
    x_f32 = x2d.dtype != torch.int8
    # the entry point's x kind: 0 a payload, 1 float32, 2 bfloat16
    x_kind = {torch.int8: 0, torch.float32: 1, torch.bfloat16: 2}.get(
        x2d.dtype)
    if x_kind is None:
        raise ValueError(f"x must be float32, bfloat16 or int8, got "
                         f"{x2d.dtype}")
    EK._check(x2d, "x", x2d.dtype)
    if x2d.data_ptr() % 16:
        raise ValueError("x must start on a 16-byte boundary")
    if x_kind == 2 and w4 and not out_int8:
        raise NotImplementedError(
            "fused_int8_linear kernel: a bfloat16 float / fold output on a "
            "packed int4 weight is not yet ported (it emits the payload)")
    if w4:
        EK._check(w, "w (packed int4)", torch.uint8, (n, k // 2))
    else:
        EK._check(w, "w", torch.int8, (n, k))
    for name, v in (("w_scale", w_scale), ("colsum", colsum)) + (
            (("bias", bias),) if bias is not None else ()):
        EK._check(v, name, torch.float32, (n,))
    EK._check(scalars, "scalars", torch.float32, (1, 8))
    EK._same_device(x2d, w, w_scale, colsum, scalars,
                    *([bias] if bias is not None else []))
    if activation not in _ACT_CODES:
        raise NotImplementedError(f"fused_int8_linear kernel: activation "
                                  f"{activation!r} is not yet ported")
    if out_bits and not 2 <= out_bits <= 16:
        raise NotImplementedError(f"fused_int8_linear kernel: a {out_bits}-"
                                  "bit output site is not yet ported")
    kq = 32 if w4 else 16
    if not (m and n and k) or k % kq or n % 8:
        raise ValueError(f"fused_int8_linear kernel needs M, N, K > 0, "
                         f"K % {kq} == 0 and N % 8 == 0 (got M={m}, N={n}, "
                         f"K={k})")
    mode = _OUT_EMIT if out_int8 else (_OUT_FOLD if out_bits else _OUT_FLOAT)
    # the scratch payload of a float32 x, which the GEMM reads by TMA
    xq = torch.empty((m, k), device=x2d.device, dtype=torch.int8) if x_f32 \
        else None
    out = torch.empty((m, n), device=x2d.device,
                      dtype=torch.int8 if out_int8
                      else (torch.float32 if x_kind == 0 else x2d.dtype))
    name = "fused_int8_linear_w4" if w4 else "fused_int8_linear"
    fn = KB.load(name)
    err = fn(x2d.data_ptr(), x_kind,
             xq.data_ptr() if x_f32 else None, w.data_ptr(),
             w_scale.data_ptr(), colsum.data_ptr(),
             bias.data_ptr() if bias is not None else None,
             scalars.data_ptr(), out.data_ptr(), m, n, k,
             _ACT_CODES[activation], int(asym_in), mode, int(out_bits),
             int(out_sym), GELU_NEW_C, EK._stream())
    KB.check(err, name)
    if x_f32:
        EK.LAUNCHES["fused_linear_quantize"] += 1
    EK.LAUNCHES[name] += 1
    return out


def quantize_input(x2d: Tensor, scalars: Tensor, asym_in: bool) -> Tensor:
    """:func:`quantize_input_ref` on CPU tensors; on CUDA tensors the
    fused linear's quantize pass alone (the first of its two launches for
    a float32 x), reading float4 and writing char4."""
    if not x2d.is_cuda:
        return quantize_input_ref(x2d, scalars, asym_in)
    m, k = x2d.shape
    EK._check(x2d, "x", torch.float32)
    EK._check(scalars, "scalars", torch.float32, (1, 8))
    EK._same_device(x2d, scalars)
    if x2d.data_ptr() % 16 or k % 4 or not m:
        raise ValueError("the quantize pass needs M > 0, K % 4 == 0 and x "
                         "on a 16-byte boundary")
    xq = torch.empty((m, k), device=x2d.device, dtype=torch.int8)
    err = KB.load("fused_quantize")(x2d.data_ptr(), scalars.data_ptr(),
                                    xq.data_ptr(), m, k, int(asym_in),
                                    EK._stream())
    KB.check(err, "fused_linear_quantize")
    EK.LAUNCHES["fused_linear_quantize"] += 1
    return xq


def fused_int8_linear(x: Tensor, packed, in_spec: Q.QuantizerSpec,
                      in_qp: Q.QuantParams, bias: Optional[Tensor] = None,
                      activation=None, out_spec=None, out_qp=None,
                      emit_int8: bool = False,
                      plain: bool = False) -> Optional[Tensor]:
    """Fused quantize + int8 matmul + dequant (+ act) (+ output site) over
    the last dim of ``x``; None when the layer does not fit (the caller
    runs the int path). ``in_qp`` per-tensor. The output site folds in
    when ``out_qp`` is per-tensor; ``emit_int8`` writes its int8 payload
    instead of floats (8-bit sites only). A split-half int4 weight
    (``w_packed``) runs the same steps on its unpacked levels; the kernel
    takes it at K % 32 == 0. ``plain``: the plain version on any device
    (the yardstick the kernel is held against)."""
    w4 = "w_packed" in packed
    w = packed["w_packed"] if w4 else packed.get("w_int")
    if w is None:
        return None
    k = x.shape[-1]
    n = w.shape[0]
    if (x.dtype not in (torch.float32, torch.bfloat16, torch.int8)
            or w.shape[1] * (2 if w4 else 1) != k):
        return None
    fold = (out_spec is not None and out_qp is not None
            and out_qp.delta.ndim == 0)
    if emit_int8 and not (fold and out_spec.n_bits == 8):
        return None
    lead = x.shape[:-1]
    m = math.prod(lead)
    if m % 8 or m < 8 or k % (32 if w4 else 16) or n % 8:
        return None

    dev = x.device
    zero = torch.zeros((), device=dev)
    s_x = Q.scale_of(in_spec, in_qp).reshape(())
    zp_x = Q.zero_point_of(in_spec, in_qp).reshape(())
    s_o = zp_o = signed_o = zero
    out_bits, out_sym = 0, False
    if fold:
        out_bits, out_sym = out_spec.n_bits, out_spec.symmetric
        s_o = Q.scale_of(out_spec, out_qp).reshape(())
        zp_o = Q.zero_point_of(out_spec, out_qp).reshape(())
        signed_o = out_qp.signed.reshape(())
    scalars = torch.stack([s_x, zp_x, s_o, zp_o, signed_o, zero, zero, zero]
                          ).reshape(1, 8).to(torch.float32)
    w_scale = torch.broadcast_to(packed["scale"].reshape(-1).to(torch.float32),
                                 (n,)).contiguous()
    args = (x.reshape(m, k).contiguous(), w, w_scale,
            packed["colsum"].to(torch.float32),
            None if bias is None else bias.to(torch.float32), scalars)
    kw = dict(activation=activation, asym_in=not in_spec.symmetric,
              out_bits=out_bits, out_sym=out_sym, out_int8=emit_int8, w4=w4)
    if plain or not x.is_cuda:
        y = fused_int8_linear_ref(*args, **kw)
    else:
        y = _launch(*args, **kw)
    return y.reshape(*lead, n)
