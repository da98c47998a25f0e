"""Quantization range estimation: the current-minmax estimator.

Counterpart of ``transformer_quantization_tpu/quant/ranges.py``. The
min-max family is a pure ``update(state, x) -> state`` step over a
fixed-shape state dict. Ported: the current-minmax estimator (the W8A8
default for weights and activations) with per-tensor, per-channel,
per-axis and per-embedding-group (PEG, optionally permuted) reductions,
and the per-channel dynamic ranges of the PEG permutation pre-pass;
all/running minmax, percentile, MSE and cross-entropy raise
``NotImplementedError`` until their slice lands.
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


def _group_min_max(x2d: Tensor, n_groups: int,
                   perm: Optional[Tensor]) -> Tuple[Tensor, Tensor]:
    """Per-group min/max broadcast back to channels. ``perm`` (the
    argsort of recorded per-channel ranges) orders the channels before
    they are cut into equal groups; results go back through its inverse."""
    c = x2d.shape[0]
    if n_groups <= 0 or c % n_groups:
        raise ValueError(f"{c} channels do not split into {n_groups} groups")
    if perm is not None:
        x2d = x2d[perm.long()]
    g = x2d.reshape(n_groups, -1)
    m = torch.repeat_interleave(torch.amin(g, dim=-1), c // n_groups)
    M = torch.repeat_interleave(torch.amax(g, dim=-1), c // n_groups)
    if perm is not None:
        inv = torch.argsort(perm.long(), stable=True)
        m, M = m[inv], M[inv]
    return m, M


def reduce_min_max(x: Tensor, rs: ReduceSpec,
                   percentile: Optional[float] = None,
                   perm: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Reduce a tensor to its (min, max) range under ``rs``; ``perm`` is
    the channel permutation of a permuted PEG site."""
    if percentile:
        raise NotImplementedError("percentile ranges are not yet ported")
    if rs.axis is not None:
        x2d = _axis_view(x, rs.axis)
        if rs.n_groups is not None:
            return _group_min_max(x2d, rs.n_groups, perm)
        return torch.amin(x2d, dim=-1), torch.amax(x2d, dim=-1)
    if rs.per_channel:
        x2d = x.reshape(x.shape[0], -1)
        return torch.amin(x2d, dim=-1), torch.amax(x2d, dim=-1)
    return torch.amin(x), torch.amax(x)


def channel_dynamic_ranges(x: Tensor, axis: int) -> Tensor:
    """Per-channel ``max - min`` of the PEG permutation pre-pass (the
    reference's momentum update reduces to the last batch's ranges)."""
    x2d = _axis_view(x, axis)
    return torch.amax(x2d, dim=-1) - torch.amin(x2d, dim=-1)


def init_range_state(shape: Tuple[int, ...], device=None) -> dict:
    """Fixed-shape estimator state: range + initialized flag."""
    return {
        "xmin": torch.zeros(shape, dtype=torch.float32, device=device),
        "xmax": torch.zeros(shape, dtype=torch.float32, device=device),
        "initialized": torch.zeros((), dtype=torch.bool, device=device),
    }


def update_range_state(state: dict, x: Tensor, cfg: RangeEstimatorConfig,
                       rs: ReduceSpec, perm: Optional[Tensor] = None) -> dict:
    """One estimator step. current_minmax replaces the range with this
    batch's; the other min-max estimators are not yet ported."""
    if cfg.method != RangeMethod.current_minmax:
        raise NotImplementedError(
            f"range method {cfg.method.name} is not yet ported")
    m, M = reduce_min_max(x, rs, cfg.percentile, perm)
    return {"xmin": torch.broadcast_to(m, state["xmin"].shape)
            .to(torch.float32).clone(),
            "xmax": torch.broadcast_to(M, state["xmax"].shape)
            .to(torch.float32).clone(),
            "initialized": torch.ones((), dtype=torch.bool,
                                      device=x.device)}


def finalize_ranges(state: dict) -> Tuple[Tensor, Tensor]:
    return state["xmin"], state["xmax"]
