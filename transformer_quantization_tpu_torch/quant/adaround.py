"""AdaRound: learned per-weight rounding (PTQ).

Counterpart of ``transformer_quantization_tpu/quant/adaround.py``:

- :func:`optimize_layer_rounding`: Adam on one layer's rounding logits
  ``alpha`` over its cached (input, output) pairs. The JAX version is one
  jitted ``lax.fori_loop``; here it is an eager loop that never waits on
  the host: each step's minibatch indices are drawn on the device from a
  ``torch.Generator`` (``randperm(n)[:batch_size]``, as JAX's
  ``permutation``), the annealing temperature is host arithmetic on the
  step count, and nothing is read back until the loop ends;
- :func:`combined_loss`: reconstruction MSE (summed over dim 1, meaned
  over the rest) plus the annealed rounding regularizer ``weight *
  sum(1 - |2h - 1|^b)`` after the warmup;
- :func:`temp_decay`: the b-annealing schedules (linear, cosine, sigmoid,
  power, exp, log), in float32 on the host;
- :func:`mse_grid_init`: the 80-candidate absmax shrink search on the
  weight MSE (candidates batched) or on a layer-output loss.
"""

from __future__ import annotations

import dataclasses
import enum
import logging
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from transformer_quantization_tpu_torch.quant import quantizers as Q
from transformer_quantization_tpu_torch.training import optim as O

logger = logging.getLogger("AdaRound")

Tensor = torch.Tensor
F32 = np.float32


class AdaRoundInitMode(enum.Enum):
    range_estimator = "range_estimator"
    mse = "mse"
    mse_out = "mse_out"
    mse_out_asym = "mse_out_asym"


class AdaRoundTempDecayType(enum.Enum):
    linear = "linear"
    cosine = "cosine"
    sigmoid = "sigmoid"
    power = "power"
    exp = "exp"
    log = "log"


class AdaRoundActQuantMode(enum.Enum):
    no_act_quant = "no_act_quant"
    post_adaround = "post_adaround"


@dataclasses.dataclass(frozen=True)
class AdaRoundConfig:
    """The JAX package's defaults (the reference's
    ``DEFAULT_ADAROUND_CONFIG``)."""

    layers: Tuple[str, ...] = ("all",)
    num_samples: int = 1024
    init: AdaRoundInitMode = AdaRoundInitMode.range_estimator
    round_mode: Q.AdaRoundMode = Q.AdaRoundMode.learned_hard_sigmoid
    asym: bool = True
    include_act_func: bool = True
    lr: float = 1e-3
    iters: int = 1000
    weight: float = 0.01
    annealing: Tuple[float, float] = (20.0, 2.0)
    decay_type: AdaRoundTempDecayType = AdaRoundTempDecayType.cosine
    decay_shape: float = 1.0
    decay_start: float = 0.0
    warmup: float = 0.2
    act_quant_mode: AdaRoundActQuantMode = AdaRoundActQuantMode.post_adaround
    batch_size: int = 32


def _sigmoid32(x) -> np.float32:
    x = F32(x)
    return F32(1) / (F32(1) + np.exp(-x, dtype=np.float32))


def temp_decay(t, cfg: AdaRoundConfig) -> np.float32:
    """b(t) at step ``t``, in float32 as the JAX version computes it
    (Python constants rounded to float32 where they meet ``t``)."""
    t = F32(t)
    t_max = cfg.iters
    start_b, end_b = cfg.annealing
    decay_start = (cfg.warmup + (1.0 - cfg.warmup) * cfg.decay_start) * t_max
    rel_t = (t - F32(decay_start)) / F32(t_max - decay_start)
    rel_t = F32(min(max(rel_t, F32(0)), F32(1)))
    d = cfg.decay_shape
    kind = cfg.decay_type
    if kind == AdaRoundTempDecayType.linear:
        b = F32(end_b) + F32(start_b - end_b) * max(F32(0), F32(1) - rel_t)
    elif kind == AdaRoundTempDecayType.cosine:
        b = F32(end_b) + F32(0.5 * (start_b - end_b)) * (
            F32(1) + np.cos(rel_t * F32(np.pi), dtype=np.float32))
    elif kind == AdaRoundTempDecayType.sigmoid:
        offset = _sigmoid32(-d / 2)
        rel_p = ((_sigmoid32(F32(d) * (rel_t - F32(0.5))) - offset)
                 / (F32(1) - F32(2) * offset))
        b = F32(start_b) + F32(end_b - start_b) * rel_p
    elif kind == AdaRoundTempDecayType.power:
        b = F32(end_b) + F32(start_b - end_b) * (
            F32(1) - np.power(rel_t, F32(d), dtype=np.float32))
    elif kind == AdaRoundTempDecayType.exp:
        rel_p = ((F32(1) - np.exp(F32(-d) * rel_t, dtype=np.float32))
                 / F32(1.0 - np.exp(-d)))
        b = F32(start_b) + F32(end_b - start_b) * rel_p
    elif kind == AdaRoundTempDecayType.log:
        C = F32(np.exp(end_b / d))
        c = F32(np.exp(start_b / d))
        # (C - c) * rel_t + c as a convex blend: the raw form cancels
        # catastrophically in float32 when start_b is large
        b = F32(d) * np.log(c * (F32(1) - rel_t) + C * rel_t,
                            dtype=np.float32)
    else:
        raise ValueError(kind)
    return F32(start_b) if t < F32(decay_start) else F32(b)


def combined_loss(pred: Tensor, tgt: Tensor, alpha: Tensor, t,
                  cfg: AdaRoundConfig, temperature=None):
    """``(total, reconstruction, rounding)`` at step ``t``: the MSE summed
    over dim 1 and meaned over the rest, plus the rounding regularizer
    from step ``iters * warmup`` on (zero before it, and in
    ``sigmoid_temp_decay`` mode)."""
    rec = torch.mean(torch.sum((pred - tgt) ** 2, dim=1))
    loss_start = cfg.iters * cfg.warmup
    if (cfg.round_mode == Q.AdaRoundMode.sigmoid_temp_decay
            or F32(t) < F32(loss_start)):
        round_loss = torch.zeros((), device=rec.device)
    else:
        b = float(temp_decay(t, cfg))
        h = Q.adaround_rest(cfg.round_mode, alpha, temperature)
        reg = torch.sum(1 - torch.abs((h.reshape(-1) - 0.5) * 2) ** b)
        round_loss = cfg.weight * reg
    return rec + round_loss, rec, round_loss


# ---------------------------------------------------------------------------
# Grid initialization
# ---------------------------------------------------------------------------

# elements a batch of candidates may hold (candidates x weight entries)
_GRID_CHUNK = 1 << 26


def mse_grid_init(spec: Q.QuantizerSpec, w: Tensor,
                  loss_fn: Optional[Callable] = None) -> Q.QuantParams:
    """80-step absmax shrink search: ``s_i = absmax * (1 - 0.01 i)``, the
    ``s`` minimizing ``MSE(w, Q(w))`` (candidates batched, a chunk at a
    time) or ``loss_fn(qp)``. As in the JAX version, a ``loss_fn``
    candidate's ``1 - 0.01 i`` is taken in float64 and the weight-MSE
    candidates' and the chosen one's in float32."""
    absmax = torch.maximum(torch.max(w), torch.abs(torch.min(w)))
    idxs = torch.arange(80, dtype=torch.float32, device=w.device)
    if loss_fn is None:
        scores = []
        per = max(1, _GRID_CHUNK // max(w.numel(), 1))
        for chunk in idxs.split(per):
            s = absmax * (1.0 - 0.01 * chunk)
            qp = Q.set_quant_range(spec, -s, s)
            shape = (-1,) + (1,) * w.ndim
            qpe = Q.QuantParams(delta=qp.delta.reshape(shape),
                                zero_float=qp.zero_float.reshape(shape),
                                signed=qp.signed)
            wq = Q.from_int(spec, qpe, Q.to_int(spec, qpe, w[None]))
            scores.append(torch.mean((w[None] - wq) ** 2,
                                     dim=tuple(range(1, w.ndim + 1))))
        scores = torch.cat(scores)
    else:
        scores = torch.stack([
            loss_fn(Q.set_quant_range(spec, -s, s))
            for s in (absmax * float(F32(1.0 - 0.01 * i))
                      for i in np.arange(80.0))])
    best = absmax * (1.0 - 0.01 * idxs[torch.argmin(scores)])
    return Q.set_quant_range(spec, -best, best)


# ---------------------------------------------------------------------------
# Per-layer optimization
# ---------------------------------------------------------------------------


@torch.no_grad()
def local_losses(layer_apply: Callable, spec: Q.QuantizerSpec,
                 qp: Q.QuantParams, w: Tensor, alpha: Tensor,
                 cached_inp: Tensor, cached_out: Tensor,
                 cfg: AdaRoundConfig, axis: Optional[int] = None
                 ) -> Tuple[Tensor, Tensor]:
    """(soft, hard) MSE of the layer on the first ``batch_size`` cached
    rows (device tensors)."""
    bs = min(cfg.batch_size, cached_inp.shape[0])

    def mse(soft):
        w_q = Q.adaround_fake_quant(cfg.round_mode, spec, qp, w, alpha,
                                    soft=soft, axis=axis,
                                    temperature=cfg.annealing[0])
        return torch.mean((layer_apply(w_q, cached_inp[:bs])
                           - cached_out[:bs]) ** 2)
    return mse(True), mse(False)


def optimize_layer_rounding(layer_apply: Callable, spec: Q.QuantizerSpec,
                            qp: Q.QuantParams, w: Tensor,
                            cached_inp: Tensor, cached_out: Tensor,
                            cfg: AdaRoundConfig, per_channel_axis: int = 0,
                            seed: int = 0) -> Tuple[Tensor, Dict]:
    """Optimize one layer's rounding logits; ``layer_apply(w_q, inp) ->
    out`` is the layer's op with the quantized weight substituted.

    ``cfg.iters`` Adam steps (optax's ``adam(lr)``: one group, constant
    rate, no clip, no decay) on :func:`combined_loss` over minibatches of
    ``min(batch_size, n)`` cached rows, each step's drawn on ``w``'s
    device from a generator seeded with ``seed``; the loop reads nothing
    back to the host. Returns ``(alpha, stats)``, stats the soft and
    hard local losses before and after."""
    mode = cfg.round_mode
    temperature = cfg.annealing[0]
    axis = per_channel_axis if qp.delta.ndim else None
    dev = w.device
    with torch.no_grad():
        alpha0 = Q.adaround_init_alpha(mode, spec, qp, w, axis=axis,
                                       temperature=temperature)
    n = cached_inp.shape[0]
    bs = min(cfg.batch_size, n)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    opt = O.Optimizer(groups={"alpha": O.Group(O.constant_schedule(cfg.lr))},
                      labels=["alpha"])
    alpha = alpha0
    state = opt.init([alpha])
    for t in range(cfg.iters):
        idx = torch.randperm(n, generator=gen, device=dev)[:bs]
        inp = torch.index_select(cached_inp, 0, idx)
        tgt = torch.index_select(cached_out, 0, idx)
        temp = (float(temp_decay(t, cfg))
                if mode == Q.AdaRoundMode.sigmoid_temp_decay else temperature)
        a = alpha.detach().requires_grad_(True)
        with torch.enable_grad():
            w_q = Q.adaround_fake_quant(mode, spec, qp, w, a, soft=True,
                                        axis=axis, temperature=temp)
            total, _, _ = combined_loss(layer_apply(w_q, inp), tgt, a, t,
                                        cfg, temperature=temperature)
            g, = torch.autograd.grad(total, a)
        with torch.no_grad():
            (alpha,), state = opt.update([g], state, [alpha])

    s0, h0 = local_losses(layer_apply, spec, qp, w, alpha0, cached_inp,
                          cached_out, cfg, axis)
    s1, h1 = local_losses(layer_apply, spec, qp, w, alpha, cached_inp,
                          cached_out, cfg, axis)
    stats = {"loss_soft_before": float(s0), "loss_hard_before": float(h0),
             "loss_soft_after": float(s1), "loss_hard_after": float(h1)}
    logger.info("AdaRound local loss before (hard): %.7f -> after (hard): "
                "%.7f", stats["loss_hard_before"], stats["loss_hard_after"])
    return alpha, stats
