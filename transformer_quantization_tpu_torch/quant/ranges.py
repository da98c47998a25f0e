"""Quantization range estimation: the current-minmax estimator.

Counterpart of ``transformer_quantization_tpu/quant/ranges.py``. The
min-max family is a pure ``update(state, x) -> state`` step over a
fixed-shape state dict. This slice ports the current-minmax estimator
(the W8A8 default for weights and activations) with per-tensor,
per-channel and per-axis reductions; all/running minmax, percentile,
PEG groups, MSE and cross-entropy raise ``NotImplementedError`` until
their slice lands.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple

import torch

Tensor = torch.Tensor


class RangeMethod(enum.Enum):
    """Estimator registry."""

    current_minmax = "current_minmax"
    allminmax = "allminmax"
    running_minmax = "running_minmax"
    MSE = "MSE"
    cross_entropy = "cross_entropy"


class OptMethod(enum.Enum):
    """MSE optimization method."""

    grid = "grid"
    golden_section = "golden_section"


@dataclasses.dataclass(frozen=True)
class ReduceSpec:
    """How a tensor reduces to a range: per-tensor (default), per-channel
    along dim 0, or along ``axis``; ``n_groups``/``permute`` are PEG."""

    per_channel: bool = False
    axis: Optional[int] = None
    n_groups: Optional[int] = None
    permute: bool = False


@dataclasses.dataclass(frozen=True)
class RangeEstimatorConfig:
    method: RangeMethod = RangeMethod.current_minmax
    percentile: Optional[float] = None
    momentum: float = 0.9
    num_candidates: int = 100
    opt_method: OptMethod = OptMethod.grid


def _axis_view(x: Tensor, axis: int) -> Tensor:
    """Move ``axis`` to the front and flatten the rest."""
    if axis != 0:
        x = torch.movedim(x, axis, 0)
    return x.reshape(x.shape[0], -1)


def reduce_min_max(x: Tensor, rs: ReduceSpec,
                   percentile: Optional[float] = None
                   ) -> Tuple[Tensor, Tensor]:
    """Reduce a tensor to its (min, max) range under ``rs``."""
    if percentile or rs.n_groups is not None:
        raise NotImplementedError(
            "percentile / grouped (PEG) ranges are not yet ported")
    if rs.axis is not None:
        x2d = _axis_view(x, rs.axis)
        return torch.amin(x2d, dim=-1), torch.amax(x2d, dim=-1)
    if rs.per_channel:
        x2d = x.reshape(x.shape[0], -1)
        return torch.amin(x2d, dim=-1), torch.amax(x2d, dim=-1)
    return torch.amin(x), torch.amax(x)


def init_range_state(shape: Tuple[int, ...], device=None) -> dict:
    """Fixed-shape estimator state: range + initialized flag."""
    return {
        "xmin": torch.zeros(shape, dtype=torch.float32, device=device),
        "xmax": torch.zeros(shape, dtype=torch.float32, device=device),
        "initialized": torch.zeros((), dtype=torch.bool, device=device),
    }


def update_range_state(state: dict, x: Tensor, cfg: RangeEstimatorConfig,
                       rs: ReduceSpec) -> dict:
    """One estimator step. current_minmax replaces the range with this
    batch's; the other min-max estimators are not yet ported."""
    if cfg.method != RangeMethod.current_minmax:
        raise NotImplementedError(
            f"range method {cfg.method.name} is not yet ported")
    m, M = reduce_min_max(x, rs, cfg.percentile)
    return {"xmin": torch.broadcast_to(m, state["xmin"].shape)
            .to(torch.float32).clone(),
            "xmax": torch.broadcast_to(M, state["xmax"].shape)
            .to(torch.float32).clone(),
            "initialized": torch.ones((), dtype=torch.bool,
                                      device=x.device)}


def finalize_ranges(state: dict) -> Tuple[Tensor, Tensor]:
    return state["xmin"], state["xmax"]
