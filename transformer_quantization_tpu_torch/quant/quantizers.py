"""Uniform quantizer math on torch tensors.

Counterpart of ``transformer_quantization_tpu/quant/quantizers.py``:
configuration in a hashable :class:`QuantizerSpec`, state (scale /
zero-point / signedness) in a :class:`QuantParams` dataclass of tensors.
Every function repeats the JAX version's operations in the same order so
the two agree bit for bit on the same float32 inputs.

:func:`fake_quant` carries the straight-through / LSQ backward of the
JAX ``_fq_bwd`` as a :class:`torch.autograd.Function` (:class:`FakeQuant`)
when a gradient is wanted (quantization-aware training); otherwise, as
in calibration, inference and serving, it runs the same forward
operations without building a graph. :func:`set_quant_range` returns
detached params, as the JAX version's ``stop_gradient`` does.

AdaRound's relaxation (:func:`adaround_fake_quant` and its helpers) is
the JAX version's, its gradient with respect to ``alpha`` autograd's.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple

import torch

Tensor = torch.Tensor


class QMethod(enum.Enum):
    """Quantization method registry."""

    symmetric_uniform = "symmetric_uniform"
    asymmetric_uniform = "asymmetric_uniform"


@dataclasses.dataclass(frozen=True)
class QuantizerSpec:
    """Static quantizer configuration: bits, method, scale domain."""

    n_bits: int = 8
    method: QMethod = QMethod.asymmetric_uniform
    scale_domain: str = "linear"
    eps: float = 1e-8

    def __post_init__(self):
        if self.scale_domain not in ("linear", "log"):
            raise ValueError(f"scale_domain must be 'linear' or 'log', got "
                             f"{self.scale_domain!r}")

    @property
    def symmetric(self) -> bool:
        return self.method == QMethod.symmetric_uniform


@dataclasses.dataclass
class QuantParams:
    """Quantizer state: ``delta`` (in the spec's scale domain), the
    un-rounded ``zero_float`` and a scalar 0/1 ``signed`` flag. Shapes are
    reduced: scalar per-tensor, ``(C,)`` per-channel / per-axis."""

    delta: Tensor
    zero_float: Tensor
    signed: Tensor


def int_min_max(spec: QuantizerSpec, signed=1.0) -> Tuple[Tensor, Tensor]:
    """Integer grid limits: asymmetric ``[0, 2^b-1]``; symmetric
    ``[-2^(b-1), 2^(b-1)-1]`` if signed else ``[0, 2^b-1]``. Float32 0-d
    tensors on ``signed``'s device, filled there (a tensor made from a
    Python number on the card would be a blocking host-to-device copy)."""
    b = spec.n_bits
    dev = signed.device if isinstance(signed, Tensor) else None
    if not spec.symmetric:
        return (torch.full((), 0.0, device=dev),
                torch.full((), 2.0 ** b - 1, device=dev))
    signed = torch.as_tensor(signed, dtype=torch.float32)
    int_min = torch.where(signed > 0, -(2.0 ** (b - 1)), 0.0)
    int_max = torch.where(signed > 0, 2.0 ** (b - 1) - 1, 2.0 ** b - 1)
    return int_min.to(torch.float32), int_max.to(torch.float32)


def scale_of(spec: QuantizerSpec, qp: QuantParams) -> Tensor:
    """Effective positive scale."""
    if spec.scale_domain == "linear":
        return torch.clamp(qp.delta, min=spec.eps)
    return torch.exp(qp.delta)


def zero_point_of(spec: QuantizerSpec, qp: QuantParams) -> Tensor:
    """Rounded, grid-clamped zero point (0 for symmetric quantizers)."""
    if spec.symmetric:
        return torch.zeros_like(qp.delta)
    int_min, int_max = int_min_max(spec, qp.delta.new_zeros(()))
    return torch.clamp(torch.round(qp.zero_float), int_min, int_max)


def x_min_max_of(spec: QuantizerSpec,
                 qp: QuantParams) -> Tuple[Tensor, Tensor]:
    """Representable range ``(scale * (int_min - zp), scale * (int_max -
    zp))``."""
    scale = scale_of(spec, qp)
    zp = zero_point_of(spec, qp)
    int_min, int_max = int_min_max(spec, qp.signed)
    return scale * (int_min - zp), scale * (int_max - zp)


def set_quant_range(spec: QuantizerSpec, x_min, x_max) -> QuantParams:
    """Quantization parameters from a (min, max) range, with the
    ``x_min <= 0`` / ``x_max >= eps`` clamps of the JAX version. The
    range math runs in float64 when either bound is a float64 tensor
    (``--double``: a float64 model's weight ranges, as JAX's under
    ``jax_enable_x64``), else in float32; ``signed`` stays float32."""
    dt = (torch.float64 if any(isinstance(v, Tensor)
                               and v.dtype == torch.float64
                               for v in (x_min, x_max)) else torch.float32)
    x_min = torch.as_tensor(x_min, dtype=dt)
    x_max = torch.as_tensor(x_max, dtype=dt, device=x_min.device)
    x_min = torch.clamp(x_min, max=0.0)
    x_max = torch.clamp(x_max, min=spec.eps)
    if spec.symmetric:
        signed = (torch.min(x_min) < 0).to(torch.float32)
        _, int_max = int_min_max(spec, signed)
        x_absmax = torch.maximum(torch.abs(x_min), x_max)
        delta = x_absmax / int_max
        zero_float = torch.zeros_like(delta)
    else:
        signed = torch.zeros((), dtype=torch.float32, device=x_min.device)
        _, int_max = int_min_max(spec, signed)
        delta = (x_max - x_min) / int_max
        zero_float = -x_min / delta
    if spec.scale_domain == "log":
        delta = torch.log(delta)
    return QuantParams(delta=delta.detach(), zero_float=zero_float.detach(),
                       signed=signed.detach())


def broadcast_shape(rank: int, axis: int) -> Tuple[int, ...]:
    """Shape placing the channel dim at ``axis`` of a rank-``rank`` tensor."""
    return tuple(-1 if d == axis else 1 for d in range(rank))


def expand_qparams(qp: QuantParams, rank: int,
                   axis: Optional[int]) -> QuantParams:
    """Reshape reduced ``(C,)`` params to broadcast against a rank-N tensor
    (``axis=None`` means channel dim 0, the per-channel weight case)."""
    if qp.delta.ndim == 0:
        return qp
    shape = broadcast_shape(rank, 0 if axis is None else axis)
    return QuantParams(delta=qp.delta.reshape(shape),
                       zero_float=qp.zero_float.reshape(shape),
                       signed=qp.signed)


def to_int(spec: QuantizerSpec, qp: QuantParams, x: Tensor) -> Tensor:
    """``clamp(round(x / scale) + zp, int_min, int_max)`` (float-typed)."""
    scale = scale_of(spec, qp)
    zp = zero_point_of(spec, qp)
    int_min, int_max = int_min_max(spec, qp.signed)
    return torch.clamp(torch.round(x / scale) + zp, int_min, int_max)


def from_int(spec: QuantizerSpec, qp: QuantParams, x_int: Tensor) -> Tensor:
    """Integer representation -> dequantized float."""
    return scale_of(spec, qp) * (x_int - zero_point_of(spec, qp))


def _fake_quant_forward(spec: QuantizerSpec, qp: QuantParams, x: Tensor,
                        axis: Optional[int]) -> Tensor:
    qpe = expand_qparams(qp, x.ndim, axis)
    orig = x.dtype
    if orig in (torch.bfloat16, torch.float16):
        x = x.to(torch.float32)
    y = from_int(spec, qpe, to_int(spec, qpe, x))
    return y.to(orig) if y.dtype != orig else y


def fake_quant(spec: QuantizerSpec, qp: QuantParams, x: Tensor,
               axis: Optional[int] = None) -> Tensor:
    """Quantize-dequantize. bf16/f16 inputs are upcast to float32 for the
    grid arithmetic and returned in their own dtype. When a gradient is
    wanted for ``x``, ``qp.delta`` or ``qp.zero_float``, the result
    carries the straight-through / LSQ backward (:class:`FakeQuant`)."""
    if torch.is_grad_enabled() and (x.requires_grad or qp.delta.requires_grad
                                    or qp.zero_float.requires_grad):
        return FakeQuant.apply(qp.delta, qp.zero_float, qp.signed, x, spec,
                               axis)
    return _fake_quant_forward(spec, qp, x, axis)


class FakeQuant(torch.autograd.Function):
    """:func:`fake_quant` with the JAX ``_fq_bwd`` backward: ``g_x = g *
    keep`` (the gradient on the closed grid interval, torch-clamp
    semantics), ``g_delta = sum g * ((r - zp) - keep * x / s)`` through the
    scale domain (a ``delta >= eps`` mask for linear, ``* exp(delta)`` for
    log), ``g_zero_float = sum g * s * zkeep * (keep - 1)`` (zero for
    symmetric quantizers), each reduced to its stored shape: a scalar, or
    per channel along ``axis``. ``signed`` gets no gradient."""

    @staticmethod
    def forward(ctx, delta, zero_float, signed, x, spec, axis):
        qp = QuantParams(delta=delta, zero_float=zero_float, signed=signed)
        ctx.save_for_backward(delta, zero_float, signed, x)
        ctx.spec, ctx.axis = spec, axis
        return _fake_quant_forward(spec, qp, x, axis)

    @staticmethod
    def backward(ctx, g):
        delta, zero_float, signed, x = ctx.saved_tensors
        spec, axis = ctx.spec, ctx.axis
        qp = QuantParams(delta=delta, zero_float=zero_float, signed=signed)
        x32 = x.to(torch.float32)
        g32 = g.to(torch.float32)
        qpe = expand_qparams(qp, x.ndim, axis)
        s = scale_of(spec, qpe)
        zp = zero_point_of(spec, qpe)
        int_min, int_max = int_min_max(spec, qpe.signed)
        u = torch.round(x32 / s) + zp
        keep = ((u >= int_min) & (u <= int_max)).to(torch.float32)
        r = torch.clamp(u, int_min, int_max)
        g_x = (g32 * keep).to(x.dtype)
        g_s = g32 * ((r - zp) - keep * (x32 / s))
        g_z_full = None
        if not spec.symmetric:
            # +zp inside the clamp (its own rounding and clamp keep), -zp
            # in the dequantization
            zr = torch.round(qpe.zero_float)
            lo_z, hi_z = int_min_max(spec, zr)
            zkeep = ((zr >= lo_z) & (zr <= hi_z)).to(torch.float32)
            g_z_full = g32 * s * zkeep * (keep - 1.0)
        if delta.ndim == 0:
            def red(t):
                return torch.sum(t)
        else:
            ax = 0 if axis is None else axis
            axes = tuple(d for d in range(x.ndim) if d != ax)

            def red(t):
                return torch.sum(t, dim=axes)
        g_d = red(g_s)
        if spec.scale_domain == "linear":
            g_d = g_d * (delta >= spec.eps).to(torch.float32)
        else:
            g_d = g_d * torch.exp(delta)
        g_z = (torch.zeros_like(zero_float) if g_z_full is None
               else red(g_z_full).reshape(zero_float.shape))
        return (g_d.reshape(delta.shape), g_z, None,
                g_x if ctx.needs_input_grad[3] else None, None, None)


# ---------------------------------------------------------------------------
# AdaRound relaxation
# ---------------------------------------------------------------------------

ZETA = 1.1
GAMMA = -0.1


def logit(p: Tensor, eps: float = 1e-16) -> Tensor:
    """Inverse sigmoid."""
    p = torch.clamp(p, eps, 1 - eps)
    return -torch.log(1.0 / p - 1.0)


def hard_sigmoid(x: Tensor, zeta: float = ZETA,
                 gamma: float = GAMMA) -> Tensor:
    """Rectified sigmoid h(alpha)."""
    p = torch.sigmoid(x)
    return torch.clamp(p * (zeta - gamma) + gamma, 0.0, 1.0)


def hard_logit(p: Tensor, zeta: float = ZETA, gamma: float = GAMMA) -> Tensor:
    """Inverse of :func:`hard_sigmoid`."""
    return -torch.log((zeta - p) / (p - gamma))


class AdaRoundMode(enum.Enum):
    """Rounding relaxations."""

    nearest = "nearest"
    learned_sigmoid = "learned_sigmoid"
    learned_hard_sigmoid = "learned_hard_sigmoid"
    sigmoid_temp_decay = "sigmoid_temp_decay"


def adaround_rest(mode: AdaRoundMode, alpha: Tensor,
                  temperature=None) -> Tensor:
    """h(alpha): the continuous rounding offset."""
    if mode == AdaRoundMode.learned_sigmoid:
        return torch.sigmoid(alpha)
    if mode == AdaRoundMode.learned_hard_sigmoid:
        return hard_sigmoid(alpha)
    if mode == AdaRoundMode.sigmoid_temp_decay:
        return torch.sigmoid(alpha / temperature)
    raise ValueError(f"Unknown rounding mode: {mode}")


def adaround_init_alpha(mode: AdaRoundMode, spec: QuantizerSpec,
                        qp: QuantParams, w: Tensor,
                        axis: Optional[int] = None,
                        temperature=None) -> Tensor:
    """alpha such that h(alpha) is the float rounding rest of ``w / s``."""
    scale = scale_of(spec, expand_qparams(qp, w.ndim, axis))
    x = w / scale
    rest = x - torch.floor(x)
    if mode == AdaRoundMode.learned_sigmoid:
        return logit(rest)
    if mode == AdaRoundMode.learned_hard_sigmoid:
        return hard_logit(rest)
    if mode == AdaRoundMode.sigmoid_temp_decay:
        return temperature * logit(rest)
    raise ValueError(f"Unknown rounding mode: {mode}")


def adaround_fake_quant(mode: AdaRoundMode, spec: QuantizerSpec,
                        qp: QuantParams, w: Tensor, alpha: Tensor,
                        soft: bool, axis: Optional[int] = None,
                        temperature=None) -> Tensor:
    """AdaRound forward: ``floor(w / s)`` plus the learned offset, the
    continuous h(alpha) with ``soft`` or the hard decision ``alpha >= 0``,
    then the zero point, the grid clamp and the dequantization. Autograd
    gives alpha its gradient through h; ``floor`` passes none and the
    clamp passes it on the closed grid interval, as ``jax.grad`` of the
    JAX version does."""
    if mode == AdaRoundMode.nearest:
        return fake_quant(spec, qp, w, axis=axis)
    qpe = expand_qparams(qp, w.ndim, axis)
    scale = scale_of(spec, qpe)
    zp = zero_point_of(spec, qpe)
    int_min, int_max = int_min_max(spec, qpe.signed)
    x_floor = torch.floor(w / scale)
    if soft:
        offset = adaround_rest(mode, alpha, temperature)
    else:
        offset = (alpha >= 0).to(w.dtype)
    x_int = x_floor + offset
    if not spec.symmetric:
        x_int = x_int + zp
    x_int = torch.clamp(x_int, int_min, int_max)
    return scale * (x_int - zp)
