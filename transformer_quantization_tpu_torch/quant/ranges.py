"""Quantization range estimation.

Counterpart of ``transformer_quantization_tpu/quant/ranges.py``:

- the min-max family (current-minmax with optional percentile clipping
  and per-tensor, per-channel, per-axis and per-embedding-group (PEG,
  optionally permuted) reductions; all-minmax; running-minmax) as a pure
  ``update(state, x) -> state`` step over a fixed-shape state dict, plus
  the per-channel dynamic ranges of the PEG permutation pre-pass;
- :class:`MSERangeEstimator`, the MSE and cross-entropy range searches
  (1-D and 2-D grids, symmetric and nested asymmetric golden-section),
  with :func:`golden_section_minimize`.

The searches are tensor code that stays on the tensor's device: the
one-sidedness decision and the search range are read once, on the first
batch (the grid thresholds are built in float64 on the host from them, as
the JAX package builds them); every loss, argmin and golden-section step
after that is a device operation, with no host synchronisation. Grid
candidates are evaluated in chunks of a fixed candidate count (the last
one padded), so each candidate's loss has the same reduction shape
whatever the chunking; losses are float32 errors summed in float64.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple

import numpy as np
import torch

from transformer_quantization_tpu_torch.quant import quantizers as Q

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
    range_margin: float = 0.5


# ---------------------------------------------------------------------------
# Reduction to (xmin, xmax): the min-max family
# ---------------------------------------------------------------------------


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


def _full(shape, value, device) -> Tensor:
    """A float32 tensor filled on ``device`` (a Python number rounded to
    float32, as JAX rounds it; no host-to-device copy)."""
    return torch.full(shape, float(value), dtype=torch.float32,
                      device=device)


def _percentile(x2d: Tensor, q: float) -> Tensor:
    """``jnp.percentile(x2d, q, axis=-1)`` with its linear interpolation:
    the position ``q / 100 * (n - 1)`` and the weights are float32, as
    in JAX, and computed on the host from ``n`` alone; the two order
    statistics come from ``kthvalue`` (``torch.quantile`` refuses more
    than 2^24 elements)."""
    n = x2d.shape[-1]
    f32 = np.float32
    pos = f32(f32(q) / f32(100.0)) * (f32(n) - f32(1.0))
    low = min(max(np.floor(pos), f32(0.0)), f32(n) - f32(1.0))
    high = min(max(np.ceil(pos), f32(0.0)), f32(n) - f32(1.0))
    hw = f32(pos - np.floor(pos))
    lw = f32(f32(1.0) - hw)
    lv = torch.kthvalue(x2d, int(low) + 1, dim=-1).values
    hv = (lv if int(high) == int(low)
          else torch.kthvalue(x2d, int(high) + 1, dim=-1).values)
    return lv * _full((), lw, x2d.device) + hv * _full((), hw, x2d.device)


def reduce_min_max(x: Tensor, rs: ReduceSpec,
                   percentile: Optional[float] = None,
                   perm: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Reduce a tensor to its (min, max) range under ``rs``; ``perm`` is
    the channel permutation of a permuted PEG site. With ``percentile``,
    per-channel ranges take percentiles ``(p, 100 - p)`` and the
    per-tensor range ``(p, 100)``, of shape ``(1,)``, the reference's
    quirk; the axis reductions ignore it."""
    if rs.axis is not None:
        x2d = _axis_view(x, rs.axis)
        if rs.n_groups is not None:
            return _group_min_max(x2d, rs.n_groups, perm)
        return torch.amin(x2d, dim=-1), torch.amax(x2d, dim=-1)
    if rs.per_channel:
        x2d = x.reshape(x.shape[0], -1)
        if percentile:
            return (_percentile(x2d, percentile),
                    _percentile(x2d, 100.0 - percentile))
        return torch.amin(x2d, dim=-1), torch.amax(x2d, dim=-1)
    if percentile:
        flat = x.reshape(1, -1)
        return _percentile(flat, percentile), _percentile(flat, 100.0)
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
    """One estimator step of the min-max family:

    - current_minmax replaces the range with this batch's;
    - allminmax keeps the envelope over batches, reducing per-tensor or
      per-channel only (``axis`` and groups ignored, the result
      broadcast to the state's shape), as in the reference;
    - running_minmax takes an EMA with ``momentum`` after the first
      batch sets the state, without the PEG permutation.
    """
    shape = state["xmin"].shape

    def to_state(m, M):
        return (torch.broadcast_to(m, shape).to(torch.float32).clone(),
                torch.broadcast_to(M, shape).to(torch.float32).clone())

    done = torch.ones((), dtype=torch.bool, device=x.device)
    if cfg.method == RangeMethod.current_minmax:
        m, M = to_state(*reduce_min_max(x, rs, cfg.percentile, perm))
        return {"xmin": m, "xmax": M, "initialized": done}
    init = state["initialized"]
    if cfg.method == RangeMethod.allminmax:
        m, M = to_state(*reduce_min_max(
            x, ReduceSpec(per_channel=rs.per_channel)))
        return {"xmin": torch.where(init, torch.minimum(state["xmin"], m), m),
                "xmax": torch.where(init, torch.maximum(state["xmax"], M), M),
                "initialized": done}
    if cfg.method == RangeMethod.running_minmax:
        m, M = to_state(*reduce_min_max(
            x, dataclasses.replace(rs, permute=False)))
        # float32 factors, as JAX rounds the Python floats
        new = _full((), 1 - cfg.momentum, x.device)
        old = _full((), cfg.momentum, x.device)
        return {"xmin": torch.where(init, new * m + old * state["xmin"], m),
                "xmax": torch.where(init, new * M + old * state["xmax"], M),
                "initialized": done}
    raise ValueError(f"update_range_state does not handle {cfg.method}; "
                     "use MSERangeEstimator for MSE/cross-entropy")


def finalize_ranges(state: dict) -> Tuple[Tensor, Tensor]:
    return state["xmin"], state["xmax"]


# ---------------------------------------------------------------------------
# Golden-section bounded scalar minimization, batched
# ---------------------------------------------------------------------------

# JAX (x64 off) rounds the float64 constant to float32 before it
# multiplies the float32 brackets; so does the port
_INVPHI = np.float32((np.sqrt(5.0) - 1.0) / 2.0)


def _golden_points(lo: Tensor, hi: Tensor) -> Tuple[Tensor, Tensor]:
    """The two interior points of a bracket, in separately rounded
    float32 operations."""
    inv = _full((), _INVPHI, lo.device)
    return hi - inv * (hi - lo), lo + inv * (hi - lo)


def golden_section_minimize(fn, lo, hi, num_iters: int = 64) -> Tensor:
    """Minimize ``fn`` on ``[lo, hi]`` by golden-section search.

    ``lo`` / ``hi`` are float32 scalars or tensors of one bracket per
    problem (a ``(C,)`` bracket per channel is the counterpart of JAX's
    ``vmap`` over channels); ``fn`` maps a tensor of that shape to the
    losses there, of any float dtype. The brackets are float32 with the
    float32 constant, as in JAX, and each iteration makes one evaluation,
    at the new point of each problem, chosen by a ``where``: no host
    synchronisation.
    """
    lo = torch.as_tensor(lo, dtype=torch.float32)
    hi = torch.as_tensor(hi, dtype=torch.float32, device=lo.device)
    lo, hi = torch.broadcast_tensors(lo, hi)
    c, d = _golden_points(lo, hi)
    fc, fd = fn(c), fn(d)
    for _ in range(num_iters):
        shrink_right = fc < fd  # keep [lo, d]; the old c becomes the new d
        lo = torch.where(shrink_right, lo, c)
        hi = torch.where(shrink_right, d, hi)
        c_new, d_new = _golden_points(lo, hi)
        f_new = fn(torch.where(shrink_right, c_new, d_new))
        fc, fd = (torch.where(shrink_right, f_new, fd),
                  torch.where(shrink_right, fc, f_new))
        c, d = c_new, d_new
    return torch.where(fc < fd, c, d)


# ---------------------------------------------------------------------------
# MSE / cross-entropy estimators
# ---------------------------------------------------------------------------

# elements of one loss evaluation chunk (candidates x tensor size)
CHUNK_ELEMENTS = 1 << 24


def _fq_with_range(spec: Q.QuantizerSpec, x: Tensor, neg: Tensor,
                   pos: Tensor, reciprocal_step: bool = False) -> Tensor:
    """Fake-quantize each problem ``x[g]`` per-tensor with its own
    candidate range ``(neg[g], pos[g])`` (the reference's temp quantizer,
    which forces ``per_channel=False``). Each element sees the float32
    operations of a per-tensor quantizer with scalar thresholds, as JAX's
    jitted search computes them. ``reciprocal_step``: the asymmetric
    step ``(max - min) / (2^b - 1)`` as a product with the float32
    reciprocal, the form XLA gives that division by a constant where the
    thresholds are not themselves constants (the golden-section
    searches; the grids' constant thresholds are folded with the
    division). A search ends on a zero point's rounding edge, which the
    step's last bit moves, so the port computes the step as JAX does."""
    if spec.symmetric or not reciprocal_step:
        qp = Q.set_quant_range(spec, neg, pos)
    else:
        x_min = torch.clamp(neg.to(torch.float32), max=0.0)
        x_max = torch.clamp(pos.to(torch.float32), min=spec.eps)
        delta = (x_max - x_min) * _levels_reciprocal(spec, x.device)
        zero_float = -x_min / delta
        if spec.scale_domain == "log":
            delta = torch.log(delta)
        qp = Q.QuantParams(delta=delta, zero_float=zero_float,
                           signed=torch.zeros((), device=x.device))
    return Q.fake_quant(spec, qp, x, axis=0)


def _levels_reciprocal(spec: Q.QuantizerSpec, device) -> Tensor:
    """``1 / (2^b - 1)`` in float32."""
    return _full((), np.float32(1.0) / np.float32(2.0 ** spec.n_bits - 1),
                 device)


def _mse_loss(spec, x, neg, pos, per_channel: bool,
              reciprocal_step: bool = False) -> Tensor:
    """``sum ||x_g - Q(x_g)||^2`` per problem ``g`` (float64 sums of
    float32 squared errors), or per leading channel of each problem when
    ``per_channel``: ``(G,)`` or ``(G, C)``."""
    y = _fq_with_range(spec, x, neg, pos, reciprocal_step)
    d2 = (x - y) ** 2
    lead = d2.shape[1] if d2.ndim > 1 else 1
    sq = d2.reshape(d2.shape[0], lead, -1).sum(dim=-1, dtype=torch.float64)
    return sq if per_channel else sq.sum(dim=-1)


def _ce_loss(spec, x, neg, pos, per_channel: bool,
             reciprocal_step: bool = False) -> Tensor:
    """``H(softmax(x), log_softmax(Q(x)))`` along dim 1 of each problem,
    always global (broadcast over the channels when ``per_channel``)."""
    y = _fq_with_range(spec, x, neg, pos, reciprocal_step)
    logq = torch.log_softmax(y, dim=2)
    p = torch.softmax(x, dim=2)
    loss = (-p * logq).reshape(x.shape[0], -1).sum(dim=-1,
                                                   dtype=torch.float64)
    if per_channel:
        return loss[:, None].expand(-1, x.shape[1])
    return loss


class MSERangeEstimator:
    """MSE / cross-entropy range search.

    The one-sidedness decision and the search range come from the first
    batch (two host reads); the losses, argmins and golden-section steps
    stay on the device. Grid losses accumulate across batches without
    momentum in a float64 ``loss_array`` (``inf`` at candidate 0);
    golden-section re-solves on each batch, and the last batch wins.
    """

    def __init__(self, spec: Q.QuantizerSpec, cfg: RangeEstimatorConfig,
                 per_channel: bool = False, cross_entropy: bool = False):
        self.spec = spec
        self.cfg = cfg
        self.per_channel = per_channel
        self.loss_fn = _ce_loss if cross_entropy else _mse_loss
        self.max_int_skew = (2 ** spec.n_bits) // 4
        self.one_sided: Optional[bool] = None
        self.loss_array: Optional[Tensor] = None
        self.max_pos_thr = self.max_neg_thr = self.max_search_range = None
        self.xmin = self.xmax = None

    def _define_search_range(self, x: Tensor) -> None:
        """One-sidedness and the search range, from the first batch's
        extremes (the estimator's one host read)."""
        xmin, xmax = (float(v) for v in torch.aminmax(x))
        self.one_sided = xmin >= 0
        n_ch = x.shape[0] if self.per_channel else 1
        self.channel_groups = n_ch
        m = self.cfg.range_margin
        n = self.cfg.num_candidates + 1
        if self.one_sided or self.spec.symmetric:
            shape = (n_ch, n)
            self.max_pos_thr = max(abs(xmin), xmax) + m
            self.max_neg_thr = -self.max_pos_thr
            self.max_search_range = self.max_pos_thr
        else:
            shape = (n_ch, n, self.max_int_skew, 2)
            self.max_pos_thr = xmax + m
            self.max_neg_thr = xmin - m
            self.max_search_range = max(abs(self.max_pos_thr),
                                        abs(self.max_neg_thr))
        self.loss_array = torch.zeros(shape, dtype=torch.float64,
                                      device=x.device)
        self.loss_array[:, 0] = float("inf")

    @property
    def step_size(self) -> float:
        return self.max_search_range / self.cfg.num_candidates

    def update(self, x: Tensor) -> None:
        x = x.detach().to(torch.float32)
        if self.one_sided is None:
            self._define_search_range(x)
        symmetric = self.one_sided or self.spec.symmetric
        if self.cfg.opt_method == OptMethod.grid:
            self._grid_1d(x) if symmetric else self._grid_2d(x)
        else:
            self._golden_symmetric(x) if symmetric \
                else self._golden_asymmetric(x)

    def finalize(self) -> Tuple[Tensor, Tensor]:
        if self.xmin is None:
            raise RuntimeError("no data passed through the MSE range estimator")
        if self.per_channel:
            return self.xmin, self.xmax
        return self.xmin.reshape(()), self.xmax.reshape(())

    # -- grids -------------------------------------------------------------

    def _grid_losses(self, x: Tensor, neg64: np.ndarray,
                     pos64: np.ndarray) -> Tensor:
        """Loss of every candidate threshold pair (float64 thresholds
        rounded to float32) over the whole of ``x``: ``(N,)`` or ``(N,
        C)``, in chunks of a fixed candidate count, the last padded."""
        n = neg64.size
        k = max(1, min(n, CHUNK_ELEMENTS // max(1, x.numel())))
        pad = -n % k
        neg = torch.from_numpy(np.pad(neg64, (0, pad), mode="edge")
                               .astype(np.float32)).to(x.device)
        pos = torch.from_numpy(np.pad(pos64, (0, pad), mode="edge")
                               .astype(np.float32)).to(x.device)
        out = []
        for i in range(0, n + pad, k):
            xs = x.unsqueeze(0).expand(k, *x.shape)
            out.append(self.loss_fn(self.spec, xs, neg[i:i + k],
                                    pos[i:i + k], self.per_channel))
        return torch.cat(out)[:n]

    def _grid_1d(self, x: Tensor) -> None:
        # thresholds in float64, rounded to float32 only at the quantizer
        # (a float32 grid flips near-tied argmins)
        step = self.step_size
        pos64 = step * np.arange(1, self.cfg.num_candidates + 1,
                                 dtype=np.float64)
        neg64 = np.zeros_like(pos64) if self.one_sided else -pos64
        losses = self._grid_losses(x, neg64, pos64)
        self.loss_array[:, 1:] += losses.T if self.per_channel \
            else losses[None]
        best = self.loss_array.argmin(dim=1).to(torch.float64)
        self.xmax = (step * best).to(torch.float32)
        self.xmin = (torch.zeros_like(self.xmax) if self.one_sided
                     else (-step * best).to(torch.float32))

    def _grid_2d(self, x: Tensor) -> None:
        step = self.step_size
        n_bits = self.spec.n_bits
        cand = np.arange(1, self.cfg.num_candidates + 1, dtype=np.float64)
        shift = np.arange(self.max_int_skew, dtype=np.float64)
        sign = np.asarray([1.0, -1.0])
        finish = step * cand
        start = -finish
        delta = (finish - start) / (2.0 ** n_bits - 1)
        skew = (sign[None, None, :] * shift[None, :, None]
                * delta[:, None, None])
        neg = np.maximum(start[:, None, None] + skew, self.max_neg_thr)
        pos = np.minimum(finish[:, None, None] + skew, self.max_pos_thr)
        losses = self._grid_losses(x, neg.reshape(-1), pos.reshape(-1))
        shape = (self.cfg.num_candidates, self.max_int_skew, 2)
        if self.per_channel:
            self.loss_array[:, 1:] += torch.movedim(
                losses.reshape(shape + (-1,)), -1, 0)
        else:
            self.loss_array[0, 1:] += losses.reshape(shape)
        # per channel: the argmin's (candidate, shift, sign) back to a range
        flat = self.loss_array.reshape(self.channel_groups, -1).argmin(dim=1)
        c = torch.div(flat, self.max_int_skew * 2, rounding_mode="floor")
        s = torch.div(flat, 2, rounding_mode="floor") % self.max_int_skew
        r = flat % 2
        c, s = c.to(torch.float64), s.to(torch.float64)
        st, fi = -step * c, step * c
        d = (fi - st) / (2.0 ** n_bits - 1)
        sk = torch.where(r == 0, 1.0, -1.0).to(torch.float64) * s * d
        self.xmin = torch.clamp(st + sk, min=self.max_neg_thr).to(
            torch.float32)
        self.xmax = torch.clamp(fi + sk, max=self.max_pos_thr).to(
            torch.float32)

    # -- golden section ----------------------------------------------------

    def _problems(self, x: Tensor) -> Tensor:
        """The independent searches: one per channel, or the whole tensor."""
        return x if self.per_channel else x.unsqueeze(0)

    def _golden_symmetric(self, x: Tensor) -> None:
        data = self._problems(x)
        lo = 0.01 * self.max_search_range
        hi = self.max_search_range
        shape = (data.shape[0],)

        def loss(r):
            neg = torch.zeros_like(r) if self.one_sided else -r
            return self.loss_fn(self.spec, data, neg, r, False, True)

        best = golden_section_minimize(loss, _full(shape, lo, x.device),
                                       _full(shape, hi, x.device))
        self.xmax = best
        self.xmin = torch.zeros_like(best) if self.one_sided else -best

    def _golden_asymmetric(self, x: Tensor) -> None:
        """Nested golden section: an outer search over the range, an inner
        one over the shift, 48 iterations each."""
        data = self._problems(x)
        lo = 0.01 * self.max_search_range
        hi = self.max_search_range
        shape = (data.shape[0],)
        f32 = torch.float32
        recip = _levels_reciprocal(self.spec, x.device)
        skew = _full((), self.max_int_skew, x.device)

        def shift_loss(shift, rng):
            return self.loss_fn(self.spec, data, -rng + shift, rng + shift,
                                False, True)

        def inner_best_shift(rng):
            # XLA's form of 2 * rng / (2^b - 1) * max_int_skew
            max_shift = 2 * rng * recip * skew
            return golden_section_minimize(
                lambda s: shift_loss(s, rng), -max_shift, max_shift,
                num_iters=48)

        def range_loss(rng):
            return shift_loss(inner_best_shift(rng), rng)

        rng = golden_section_minimize(range_loss, _full(shape, lo, x.device),
                                      _full(shape, hi, x.device),
                                      num_iters=48)
        shift = inner_best_shift(rng)
        if self.per_channel:
            self.xmax, self.xmin = rng + shift, -rng + shift
        else:
            # per tensor JAX adds the two as Python floats, then rounds
            r64, s64 = rng.to(torch.float64), shift.to(torch.float64)
            self.xmax = (r64 + s64).to(f32)
            self.xmin = (-r64 + s64).to(f32)


def make_estimator(spec: Q.QuantizerSpec, cfg: RangeEstimatorConfig,
                   per_channel: bool = False) -> MSERangeEstimator:
    """Estimator factory for the MSE and cross-entropy methods."""
    if cfg.method in (RangeMethod.MSE, RangeMethod.cross_entropy):
        return MSERangeEstimator(
            spec, cfg, per_channel=per_channel,
            cross_entropy=cfg.method == RangeMethod.cross_entropy)
    raise ValueError(
        f"{cfg.method} is a pure-update estimator; use update_range_state")
