"""QAT forward on int8 products: fake-quant values, STE / LSQ gradients.

Counterpart of ``transformer_quantization_tpu/training/int8_qat.py``. At
fixed (or per-step frozen) ranges the quantized operands of a fake-quant
matmul are int8 grids, so ``fake_quant(x) @ fake_quant(w)^T`` can be taken
as an exact int8 x int8 -> int32 product: the values are exactly the
fake-quant composition's (integer sums are exact where a float32 product
rounds), while the backward keeps that composition's straight-through
gradients, including the learned-range (LSQ) gradients of ``delta`` and
``zero_float``.

The product of the int8 payloads (activations shifted by -128, signed
weight levels) is :func:`int8_product`: ``torch._int_mm`` on the card,
the port's exact plain integer product (``ops/int_linear.py``
``exact_int_matmul``) on the CPU; the backward's float products are
``torch.matmul``. :func:`fakequant_qat_linear` is the float composition
this replaces, the oracle for values and gradients.

Scope: per-tensor asymmetric 8-bit activations x symmetric signed weights
of up to 8 bits, per tensor or per channel (the paper's W4A8 QAT).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from transformer_quantization_tpu_torch.ops import int_linear as IL
from transformer_quantization_tpu_torch.quant import quantizers as Q

Tensor = torch.Tensor

EPS = 1e-8


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def int8_product(a: Tensor, w: Tensor) -> Tensor:
    """Exact int32 ``a @ w^T`` of int8 ``a`` (M, K) and ``w`` (N, K):
    ``torch._int_mm`` on the card (:func:`int_mm_padded`), the port's
    exact plain product on the CPU."""
    if a.is_cuda:
        return int_mm_padded(a, w)
    return IL.exact_int_matmul(a, w)


def int_mm_padded(a: Tensor, w: Tensor) -> Tensor:
    """``torch._int_mm(a, w^T)``, whose CUDA kernel takes M > 16 and K, N
    multiples of 8: operands outside that are zero-padded to a shape it
    takes (zero rows and columns add nothing to any sum) and the result
    cut back; whatever it still refuses raises."""
    m, k = a.shape
    n = w.shape[0]
    mp, kp, np_ = max(_round_up(m, 8), 24), _round_up(k, 8), _round_up(n, 8)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (np_, kp) != (n, k):
        w = F.pad(w, (0, kp - k, 0, np_ - n))
    out = torch._int_mm(a.contiguous(), w.t())
    return out[:m, :n] if (mp, np_) != (m, n) else out


def _act_levels(x, s, zp):
    """Asymmetric 8-bit activation levels (clipped) and the clip mask."""
    u = torch.round(x / s) + zp
    keep = (u >= 0.0) & (u <= 255.0)
    return torch.clamp(u, 0.0, 255.0), keep


def _w_levels(w, s, lo, hi):
    u = torch.round(w / s)
    keep = (u >= lo) & (u <= hi)
    return torch.clamp(u, lo, hi), keep


def _params(x_delta, x_zero, w_delta, w_per_channel):
    s_x = torch.clamp(x_delta, min=EPS)
    zp = torch.clamp(torch.round(x_zero), 0.0, 255.0)
    s_w = torch.clamp(w_delta, min=EPS)
    if w_per_channel:
        s_w = s_w.reshape(-1, 1)  # (N, 1) against (N, K) weights
    return s_x, zp, s_w


def _w_bounds(w_bits: int):
    return -(2.0 ** (w_bits - 1)), 2.0 ** (w_bits - 1) - 1.0


def int8_payloads(x, w, x_delta, x_zero, w_delta, w_bits: int,
                  w_per_channel: bool):
    """The int8 operands of the product: the activation levels shifted by
    -128 (``p_x``, x's shape) and the signed weight levels (``p_w``, (N,
    K)), with the clipped levels ``r_w`` and the site params ``(s_x, zp,
    s_w)``."""
    s_x, zp, s_w = _params(x_delta, x_zero, w_delta, w_per_channel)
    lo, hi = _w_bounds(w_bits)
    r_x, _ = _act_levels(x, s_x, zp)
    r_w, _ = _w_levels(w, s_w, lo, hi)
    return ((r_x - 128.0).to(torch.int8), r_w.to(torch.int8), r_w,
            (s_x, zp, s_w))


class Int8QATLinear(torch.autograd.Function):
    """``fake_quant(x) @ fake_quant(w)^T + bias`` on the exact int8
    product, with the fake-quant composition's STE / LSQ gradients (the
    JAX ``_fwd`` / ``_bwd``)."""

    @staticmethod
    def forward(ctx, x, w, bias, x_delta, x_zero, w_delta, w_bits,
                w_per_channel, quantize_input):
        # int8 payloads: acts shifted by -128 so both operands are int8
        p_x, p_w, r_w, (s_x, zp, s_w) = int8_payloads(
            x, w, x_delta, x_zero, w_delta, w_bits, w_per_channel)
        k = x.shape[-1]
        acc = int8_product(p_x.reshape(-1, k), p_w).to(torch.float32)
        acc = acc.reshape(*x.shape[:-1], w.shape[0])
        colsum = torch.sum(r_w, dim=1)  # exact: integers
        shift = 128.0 - zp
        y = (s_x * s_w.reshape(-1)) * (acc + shift * colsum)
        if bias is not None:
            y = y + bias
        ctx.save_for_backward(x, w, x_delta, x_zero, w_delta)
        ctx.cfg = (bias is not None, w_bits, w_per_channel, quantize_input)
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, x_delta, x_zero, w_delta = ctx.saved_tensors
        has_bias, w_bits, w_per_channel, quantize_input = ctx.cfg
        s_x, zp, s_w = _params(x_delta, x_zero, w_delta, w_per_channel)
        lo, hi = _w_bounds(w_bits)
        r_x, keep_x = _act_levels(x, s_x, zp)
        r_w, keep_w = _w_levels(w, s_w, lo, hi)
        zr = torch.round(x_zero)
        zkeep = (zr >= 0.0) & (zr <= 255.0)
        fq_x = s_x * (r_x - zp)
        fq_w = s_w * r_w
        n, k = w.shape
        g_fqx = torch.matmul(g, fq_w)
        # d loss / d fq_w: g and fq_x contracted over every batch dim
        g_fqw = torch.matmul(g.reshape(-1, n).t(), fq_x.reshape(-1, k))
        if quantize_input:
            kx = keep_x.to(g.dtype)
            g_x = g_fqx * kx
            dmask_x = (x_delta >= EPS).to(g.dtype)
            g_xd = torch.sum(g_fqx * ((r_x - zp) - kx * x / s_x)) * dmask_x
            g_xz = (torch.sum(g_fqx * s_x * (kx - 1.0))
                    * zkeep.to(g.dtype))
        else:
            # x is the producer's fake-quantized value: this op quantizes
            # nothing of x, so the product's gradient passes unmasked and
            # the input site's params are constants here
            g_x = g_fqx
            g_xd = torch.zeros_like(x_delta)
            g_xz = torch.zeros_like(x_zero)
        kw = keep_w.to(g.dtype)
        g_w = g_fqw * kw
        d_w = g_fqw * (r_w - kw * w / s_w)
        wmask = (w_delta >= EPS).to(g.dtype)
        g_wd = (torch.sum(d_w, dim=1) if w_per_channel
                else torch.sum(d_w)) * wmask
        g_b = torch.sum(g.reshape(-1, n), dim=0) if has_bias else None
        return g_x, g_w, g_b, g_xd, g_xz, g_wd, None, None, None


def int8_qat_linear(x: Tensor, w: Tensor, bias: Optional[Tensor],
                    x_delta: Tensor, x_zero: Tensor, w_delta: Tensor,
                    w_bits: int = 8, w_per_channel: bool = False,
                    quantize_input: bool = True) -> Tensor:
    """``fake_quant(x) @ fake_quant(w)^T + bias`` with the product on int8
    payloads (:func:`int8_product`) and STE / LSQ gradients.

    ``x``: (..., K) float; ``w``: (N, K); ``x_delta`` / ``x_zero``: the
    activation site's range params (linear scale domain); ``w_delta``: the
    weight site's scale, a scalar or (N,) with ``w_per_channel``; weights
    on the signed symmetric grid of ``w_bits``. ``quantize_input=False``:
    ``x`` is already the site's fake-quantized value (the producer applied
    ``fake_quant``), its levels are recovered exactly, and the backward
    treats ``x_delta`` / ``x_zero`` as constants with ``d y / d x =
    fq_w``."""
    return Int8QATLinear.apply(x, w, bias, x_delta, x_zero, w_delta,
                               int(w_bits), bool(w_per_channel),
                               bool(quantize_input))


def fakequant_qat_linear(x, w, bias, x_delta, x_zero, w_delta,
                         w_bits: int = 8, w_per_channel: bool = False):
    """The float fake-quant composition :func:`int8_qat_linear` replaces,
    the oracle for its values and gradients (differentiable through
    :class:`~..quant.quantizers.FakeQuant`)."""
    x_spec = Q.QuantizerSpec(n_bits=8, method=Q.QMethod.asymmetric_uniform)
    w_spec = Q.QuantizerSpec(n_bits=w_bits,
                             method=Q.QMethod.symmetric_uniform)
    qp_x = Q.QuantParams(delta=x_delta, zero_float=x_zero,
                         signed=torch.zeros((), device=x.device))
    qp_w = Q.QuantParams(delta=w_delta, zero_float=torch.zeros_like(w_delta),
                         signed=torch.ones((), device=x.device))
    fx = Q.fake_quant(x_spec, qp_x, x)
    fw = Q.fake_quant(w_spec, qp_w, w, axis=0 if w_per_channel else None)
    y = torch.einsum("...k,nk->...n", fx, fw)
    return y + bias if bias is not None else y
