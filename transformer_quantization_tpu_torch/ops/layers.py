"""Quantized layer primitives.

Counterpart of ``transformer_quantization_tpu/ops/layers.py``. Each
primitive takes a :class:`~..quant.manager.QuantCtx` and a site name; the
weight quantizer lives at ``<name>.w``, the output activation quantizer
at ``<name>.out``. Biases are never quantized.

Ported: the float path, the generic int8 branch and its fused linear
(the JAX ``use_pallas``, ``ctx.fused_linear``) and the int8 QAT matmul
(``ctx.int8_qat_sites``, :func:`_int8_qat_matmul`) of
:func:`quant_linear`, :func:`quant_layernorm`, :func:`quant_nonorm`,
:func:`quant_embedding` and :func:`dropout`, and AdaRound's I/O capture:
when ``name`` is in ``ctx.capture_sites`` a primitive records its
(input, output before the output act site) pair in ``ctx.captures``
(:func:`_maybe_capture`); the int8 fused linear and QAT matmul stand
aside while capturing; and SqueezeBERT's grouped (block-diagonal) layer
:func:`quant_grouped_linear`, float and int8.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from transformer_quantization_tpu_torch.ops import int_linear as IL
from transformer_quantization_tpu_torch.ops.kernels.int_matmul import (
    fused_int8_linear,
)
from transformer_quantization_tpu_torch.quant import quantizers as Q
from transformer_quantization_tpu_torch.quant import ranges as R
from transformer_quantization_tpu_torch.quant.manager import (
    estimate_weight_qp,
)
from transformer_quantization_tpu_torch.quant.qconfig import Phase

Tensor = torch.Tensor

_SQRT_HALF = float(np.float32(np.sqrt(0.5)))


def _gelu_erfc(x):
    # jax.nn.gelu(approximate=False): 0.5 * x * erfc(-x * sqrt(1/2))
    return 0.5 * x * torch.special.erfc(-x * _SQRT_HALF)


def _gelu_tanh(x):
    # jax.nn.gelu(approximate=True): x * 0.5 * (1 + tanh(c (x + a x^3)))
    c = float(np.float32(np.sqrt(2 / np.pi)))
    return x * (0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * x ** 3))))


# Fusable activation functions; "gelu" is exact (erf), as in the JAX
# package's generic path
ACTIVATIONS = {
    None: None,
    "relu": torch.relu,
    "relu6": lambda x: torch.clamp(x, 0.0, 6.0),
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "gelu": _gelu_erfc,
    "gelu_new": _gelu_tanh,
}


def _resolve_act(activation) -> Optional[Callable]:
    if activation is None or callable(activation):
        return activation
    return ACTIVATIONS[activation]


def _maybe_capture(ctx, name: str, x: Tensor, y: Tensor) -> None:
    if name in ctx.capture_sites:
        ctx.captures[name] = (x, y)


def _int8_fast_path(ctx, name: str, input_site: Optional[str]):
    """(input site cfg, its params, packed weight) when the matmul can run
    on the int8 path, else None. Sites wider than 8 bits never ride int8
    payloads: re-quantizing them would wrap the levels."""
    int_params = ctx.int_params
    if not int_params or name not in int_params:
        return None
    if input_site is None or input_site not in ctx.cfg:
        return None
    in_cfg = ctx.cfg[input_site]
    if not (in_cfg.enabled and ctx.mode.act_quant and ctx.mode.weight_quant):
        return None
    if in_cfg.per_channel or in_cfg.n_groups:
        return None  # scales vary along the contracted features
    if in_cfg.spec.n_bits > 8:
        return None
    wname = f"{name}.w"
    if wname in ctx.cfg and not ctx.cfg[wname].enabled:
        return None
    st = ctx.qstate.get(input_site)
    if st is None:
        return None
    return in_cfg, st["qp"], int_params[name]


def _weight_from_int_or_fake(ctx, name: str, w: Tensor) -> Tensor:
    """Quantized weight for the float path: the dequantized packed int8
    payload when fixed ranges have one (bit-identical values) and nothing
    is captured, else the fake-quant chain."""
    wname = f"{name}.w"
    if (ctx.int_params and name in ctx.int_params and ctx.mode.weight_quant
            and ctx.mode.weight_phase == Phase.fix
            and not (wname in ctx.cfg and not ctx.cfg[wname].enabled)
            and not ctx.capture_sites):
        return IL.dequantize_packed_weight(ctx.int_params[name])
    return ctx.weight(wname, w)


def _fused_linear(ctx, name: str, x: Tensor, b: Optional[Tensor],
                  activation, in_cfg, in_qp, packed) -> Optional[Tensor]:
    """The fused linear on ``x`` (float32, or the input site's int8
    payload): the output act site folds into its epilogue when it is
    enabled, fixed and per-tensor, and its int8 payload is emitted for a
    site of ``ctx.int8_only_sites``. None when the kernel does not take
    the layer."""
    out_site = f"{name}.out"
    out_spec = out_qp = None
    oc = ctx.cfg[out_site] if out_site in ctx.cfg else None
    if (oc is not None and oc.enabled and ctx.mode.act_quant
            and ctx.mode.act_phase == Phase.fix and out_site in ctx.qstate
            and oc.axis is None):
        oq = ctx.qstate[out_site]["qp"]
        if oq.delta.ndim == 0:
            out_spec, out_qp = oc.spec, oq
    emit = (out_spec is not None and out_spec.n_bits == 8
            and out_site in ctx.int8_only_sites)
    y = fused_int8_linear(x, packed, in_cfg.spec, in_qp, bias=b,
                          activation=activation, out_spec=out_spec,
                          out_qp=out_qp, emit_int8=emit,
                          plain=ctx.fused_linear == "plain")
    if y is None:
        return None
    if emit:
        # the sole consumer takes the payload as its x
        ctx.int8_handoffs[out_site] = y
        return y
    if out_spec is not None:
        return y  # the output site ran in the epilogue
    return ctx.act(out_site, y)


def _int8_qat_matmul(ctx, name: str, x: Tensor, w: Tensor,
                     b: Optional[Tensor], input_site: Optional[str]):
    """The QAT matmul on int8 payloads when every condition holds, else
    None: the layer is in ``ctx.int8_qat_sites`` (weights screened by
    ``training/qat.py`` ``int8_forward_sites``), the input site is an
    enabled per-tensor asymmetric 8-bit linear-domain act site with stored
    params (so ``x`` arrives as its fake-quantized value and its levels
    are recovered exactly), the act phase is not ``record_ranges`` and
    nothing is captured.
    Weights may be fixed, learned or estimated (the range re-derived from
    the live weight, as ``QuantCtx.weight``'s estimate branch, on the
    signed grid)."""
    # imported here, as JAX does: the training package sits above the ops
    from transformer_quantization_tpu_torch.training.int8_qat import (
        int8_qat_linear,
    )

    if (name not in ctx.int8_qat_sites or input_site is None
            or ctx.capture_sites or ctx.compute_dtype is not None):
        return None
    m = ctx.mode
    if not (m.weight_quant and m.act_quant):
        return None
    if m.act_phase == Phase.record_ranges:
        return None
    wname = f"{name}.w"
    if wname not in ctx.cfg or input_site not in ctx.cfg:
        return None
    ic = ctx.cfg[input_site]
    if not (ic.kind == "act" and ic.enabled and ic.axis is None
            and not ic.n_groups and ic.spec.n_bits == 8
            and not ic.spec.symmetric and ic.spec.scale_domain == "linear"):
        return None
    wc = ctx.cfg[wname]
    ist = ctx.qstate.get(input_site)
    if ist is None:
        return None
    qp_x = ist["qp"]
    if qp_x.delta.ndim != 0:
        return None
    if m.weight_phase == Phase.estimate:
        if wc.range_cfg.method in (R.RangeMethod.MSE,
                                   R.RangeMethod.cross_entropy):
            return None  # estimate_weight_qp refuses these
        if ctx.qstate.get(wname, {}).get("alpha") is not None:
            return None
        qp_w = estimate_weight_qp(wc, w)
        # the int8 matmul's grid is the signed one; a weight with no
        # negative entry gets a self-consistent signed grid (absmax /
        # (2^b - 1) -> absmax / (2^(b-1) - 1)), a no-op for every other
        b_ = wc.spec.n_bits
        factor = (2.0 ** b_ - 1.0) / (2.0 ** (b_ - 1) - 1.0)
        qp_w = Q.QuantParams(
            delta=torch.where(qp_w.signed > 0, qp_w.delta,
                              qp_w.delta * factor),
            zero_float=qp_w.zero_float,
            signed=torch.ones_like(qp_w.signed))
        ctx.qstate[wname] = dict(ctx.qstate.get(wname, {"alpha": None}),
                                 qp=qp_w)
    else:
        wst = ctx.qstate.get(wname)
        if wst is None or wst.get("alpha") is not None:
            return None
        qp_w = wst["qp"]
    return int8_qat_linear(x, w, b, qp_x.delta, qp_x.zero_float,
                           qp_w.delta.reshape(-1) if wc.per_channel
                           else qp_w.delta, wc.spec.n_bits, wc.per_channel,
                           False)


def _compute_operands(ctx, x: Tensor, w_q: Tensor):
    """The float matmul's operands: both in ``ctx.compute_dtype`` when the
    forward sets one (the JAX ``compute_dtype``), else the weight in x's
    dtype."""
    cdt = ctx.compute_dtype
    if cdt is not None:
        return x.to(cdt), w_q.to(cdt)
    return x, w_q.to(x.dtype)


def quant_linear(ctx, name: str, x: Tensor, w: Tensor, b: Optional[Tensor],
                 activation=None, input_site: Optional[str] = None) -> Tensor:
    """Quantized affine layer: quantize weight -> x @ W^T + b -> activation
    -> quantize output. ``w`` is stored ``(out, in)``. With packed int
    weights and a per-tensor (or per-token) input site the matmul runs on
    the exact int8 path; with ``ctx.fused_linear`` and a per-tensor input
    site, through :func:`~.kernels.int_matmul.fused_int8_linear`, which
    takes the input site's int8 payload where its producer emitted one.
    A layer of ``ctx.int8_qat_sites`` takes :func:`_int8_qat_matmul`."""
    act = _resolve_act(activation)
    fast = _int8_fast_path(ctx, name, input_site)
    if fast is not None and fast[0].axis == x.ndim - 1:
        fast = None  # per-embd: scales vary along the contraction
    if fast is not None:
        in_cfg, in_qp, packed = fast
        if in_cfg.axis is not None:
            in_qp = Q.expand_qparams(in_qp, x.ndim, in_cfg.axis)
        elif (ctx.fused_linear and not callable(activation)
              and not ctx.capture_sites):
            x = ctx.int8_handoffs.pop(input_site, x)
            y = _fused_linear(ctx, name, x, b, activation, in_cfg, in_qp,
                              packed)
            if y is not None:
                return y
            if x.dtype == torch.int8:
                # the kernel rejected a payload: materialize its floats
                x = IL.dequantize_activation_int8(in_cfg.spec, in_qp, x)
        x_int8, s_x, shift = IL.quantize_activation_int8(in_cfg.spec, in_qp,
                                                         x)
        y = IL.int8_linear(x_int8, s_x, shift, packed, b, act)
        y = y.to(x.dtype)
        _maybe_capture(ctx, name, x, y)
        return ctx.act(f"{name}.out", y)

    if ctx.int8_qat_sites:
        y = _int8_qat_matmul(ctx, name, x, w, b, input_site)
        if y is not None:
            y = y.to(x.dtype)
            if act is not None:
                y = act(y)
            return ctx.act(f"{name}.out", y)

    x, w_q = _compute_operands(ctx, x, _weight_from_int_or_fake(ctx, name,
                                                                w))
    y = float_matmul(x, w_q.transpose(0, 1),
                     wide_matmul_precision(ctx, input_site, f"{name}.w"))
    if b is not None:
        y = (y + b).to(y.dtype)
    if act is not None and ctx.capture_pre_act:
        # AdaRound's include_act_func=False: the pre-activation target
        _maybe_capture(ctx, name, x, y)
        y = act(y)
    else:
        if act is not None:
            y = act(y)
        _maybe_capture(ctx, name, x, y)
    return ctx.act(f"{name}.out", y)


def quant_grouped_linear(ctx, name: str, x: Tensor, w: Tensor,
                         b: Optional[Tensor], groups: int, activation=None,
                         input_site: Optional[str] = None) -> Tensor:
    """Block-diagonal (grouped) affine layer: SqueezeBERT's kernel-size-1
    grouped Conv1d in (B, T, C) layout. ``w`` is stored ``(out,
    in/groups)``; output group j contracts input group j only. One group
    is :func:`quant_linear` (and its int8 and fused-linear paths). With
    packed int weights and a per-tensor (or per-token) input site the
    groups' products run on the exact int8 path
    (:func:`~.int_linear.int8_grouped_linear`); a per-embedding input site
    (scales along the contraction) keeps the float path."""
    if groups == 1:
        return quant_linear(ctx, name, x, w, b, activation=activation,
                            input_site=input_site)
    act = _resolve_act(activation)
    fast = _int8_fast_path(ctx, name, input_site)
    if fast is not None and fast[0].axis == x.ndim - 1:
        fast = None  # per-embd: scales vary along the contraction
    if fast is not None:
        in_cfg, in_qp, packed = fast
        if in_cfg.axis is not None:
            in_qp = Q.expand_qparams(in_qp, x.ndim, in_cfg.axis)
        x_int8, s_x, shift = IL.quantize_activation_int8(in_cfg.spec, in_qp,
                                                         x)
        y = IL.int8_grouped_linear(x_int8, s_x, shift, packed, b, groups,
                                   act).to(x.dtype)
        _maybe_capture(ctx, name, x, y)
        return ctx.act(f"{name}.out", y)
    x, w_q = _compute_operands(ctx, x, _weight_from_int_or_fake(ctx, name,
                                                                w))
    out_f, in_g = w_q.shape
    lead = x.shape[:-1]
    xg = x.reshape(-1, groups, in_g).transpose(0, 1)
    wg = w_q.reshape(groups, out_f // groups, in_g).transpose(1, 2)
    y = float_matmul(xg, wg, wide_matmul_precision(ctx, input_site,
                                                   f"{name}.w"))
    y = y.transpose(0, 1).reshape(*lead, out_f)
    if b is not None:
        y = (y + b).to(y.dtype)
    if act is not None:
        y = act(y)
    _maybe_capture(ctx, name, x, y)
    return ctx.act(f"{name}.out", y)


def wide_matmul_precision(ctx, *sites) -> bool:
    """Whether any named act / weight site puts >8-bit-grid values into a
    float matmul: the JAX package asks for ``lax.Precision.HIGHEST`` there
    (its ``ops/layers.py`` ``wide_matmul_precision``), since a reduced-
    precision product destroys the low bits of a 16-bit grid (about 30% of
    logit scale at ``{'c': 16}`` in its measurements). The port's own copy
    of the predicate; :func:`float_matmul` acts on it."""
    cfg = getattr(ctx, "cfg", None)
    if cfg is None:
        return False
    for name in sites:
        if name is None or name not in cfg:
            continue
        c = cfg[name]
        if c.enabled and c.spec.n_bits > 8:
            return True
    return False


def float_matmul(a: Tensor, b: Tensor, full: bool) -> Tensor:
    """``torch.matmul(a, b)``; with ``full`` in full float32 whatever the
    caller set with ``torch.backends.cuda.matmul.allow_tf32`` or
    ``torch.set_float32_matmul_precision`` (TF32 keeps a 10-bit mantissa).
    The caller's setting is restored afterwards."""
    if not full:
        return torch.matmul(a, b)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        return torch.matmul(a, b)
    finally:
        torch.set_float32_matmul_precision(prev)


def quant_layernorm(ctx, name: str, x: Tensor, scale: Tensor, bias: Tensor,
                    eps: float = 1e-12) -> Tensor:
    """LayerNorm with quantized gamma and quantized output; statistics in
    float32 whatever the activation dtype."""
    scale_q = ctx.weight(f"{name}.w", scale)
    x32 = x.to(torch.float32)
    mean = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mean), dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = (y * scale_q.to(torch.float32) + bias.to(torch.float32)).to(x.dtype)
    _maybe_capture(ctx, name, x, y)
    return ctx.act(f"{name}.out", y)


def quant_nonorm(ctx, name: str, x: Tensor, weight: Tensor,
                 bias: Tensor) -> Tensor:
    """MobileBERT's NoNorm ``x * w + b``: weight and bias quantize through
    the one weight site ``<name>.w`` as ``concat(w, b)`` (one grid, one
    range over both), then the output act site."""
    wb_q = ctx.weight(f"{name}.w", torch.cat([weight, bias]))
    w_q, b_q = torch.split(wb_q, weight.shape[0])
    y = x * w_q + b_q
    _maybe_capture(ctx, name, x, y)
    return ctx.act(f"{name}.out", y)


def quant_embedding(ctx, name: str, ids: Tensor, table: Tensor) -> Tensor:
    """Embedding lookup from a quantized table (rows are grid points, so
    the output is not activation-quantized). Packed int8 tables dequantize
    after the gather. Under ``ctx.compute_dtype`` the rows are cast to
    it."""
    cdt = ctx.compute_dtype
    if ctx.int_params and name in ctx.int_params and ctx.mode.weight_quant:
        rows = IL.int8_embedding_lookup(ids, ctx.int_params[name])
        return rows.to(cdt) if cdt is not None else rows
    rows = ctx.weight(f"{name}.w", table)[ids]
    _maybe_capture(ctx, name, ids, rows)
    return rows.to(cdt) if cdt is not None else rows


def dropout(x: Tensor, rate: float, generator: Optional[torch.Generator],
            deterministic: bool) -> Tensor:
    """Inverted dropout drawing its mask from ``generator``; identity in
    eval mode or at rate 0."""
    if deterministic or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("training dropout needs a torch.Generator")
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))
