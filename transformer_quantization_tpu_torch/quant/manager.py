"""Quantization state threading.

Counterpart of ``transformer_quantization_tpu/quant/manager.py``. A
:class:`QuantCtx` is created per forward; models call ``ctx.act(name, x)``
/ ``ctx.weight(name, w)`` at every site, and :meth:`QuantCtx.export`
returns the updated per-site state:

- act sites: ``{"qp": QuantParams, "range_state": {xmin, xmax,
  initialized}}``, plus ``perm`` (int64 ``(C,)``) and ``ranges`` (float32
  ``(C,)``) at permuted PEG sites
- weight sites: ``{"qp": QuantParams, "alpha": None}``, or AdaRound's
  rounding logits (the weight's shape) as ``alpha``

Phases ``estimate``, ``fix``, ``learn`` and the PEG ``record_ranges``
pre-pass are ported, with every range estimator: the MSE and
cross-entropy act sites take their estimators from an ``mse_session``
that persists across calibration batches. In ``learn`` (QAT with learned
ranges) a site quantizes with its stored ``qp``, whose ``delta`` and
``zero_float`` are the tensors the optimizer trains; range updates in
``estimate`` read ``x.detach()``, as the JAX version's
``stop_gradient``. A weight site with an AdaRound ``alpha`` quantizes
with its hard rounding decisions. With ``capture_sites`` set, the
layers record their (input, output) pairs in ``captures`` (AdaRound's
layer I/O, ``ops/layers.py`` ``_maybe_capture``), and a standalone act
site named there records ``(x, x)``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch

from transformer_quantization_tpu_torch.quant import quantizers as Q
from transformer_quantization_tpu_torch.quant import ranges as R
from transformer_quantization_tpu_torch.quant.qconfig import (
    Phase,
    QuantMode,
    QuantModelConfig,
    QuantSiteConfig,
)

Tensor = torch.Tensor
SiteState = Dict[str, object]

_MSE_METHODS = (R.RangeMethod.MSE, R.RangeMethod.cross_entropy)


def init_act_site_state(cfg: QuantSiteConfig, x: Tensor) -> SiteState:
    shape = cfg.ranges_shape(tuple(x.shape))
    dev = x.device
    qp = Q.QuantParams(delta=torch.ones(shape, device=dev),
                       zero_float=torch.zeros(shape, device=dev),
                       signed=torch.zeros((), device=dev))
    state: SiteState = {"qp": qp,
                        "range_state": R.init_range_state(shape, dev)}
    if cfg.permute:
        state["perm"] = torch.arange(shape[0], device=dev)
        state["ranges"] = torch.zeros((shape[0],), device=dev)
    return state


def estimate_weight_qp(cfg: QuantSiteConfig, w: Tensor) -> Q.QuantParams:
    """Range of a weight re-derived from the weight itself in the estimate
    phase: min-max only, as in JAX (MSE weight ranges are set up front by
    :func:`init_weight_site_state`)."""
    rc = cfg.range_cfg
    if rc.method in _MSE_METHODS:
        raise ValueError(
            "MSE weight range estimation inside a forward; initialize "
            "weight ranges up front instead")
    xmin, xmax = R.reduce_min_max(
        w.detach(), R.ReduceSpec(per_channel=cfg.per_channel),
        rc.percentile if rc.method == R.RangeMethod.current_minmax else None)
    return Q.set_quant_range(cfg.spec, xmin, xmax)


def init_weight_site_state(cfg: QuantSiteConfig, w: Tensor) -> SiteState:
    """Estimate a weight site's range once from its (static) weight: MSE
    and cross-entropy through their search, current-minmax with its
    percentile; all/running minmax on one unchanging tensor reduce to
    current-minmax without it."""
    rc = cfg.range_cfg
    rs = R.ReduceSpec(per_channel=cfg.per_channel)
    if rc.method in _MSE_METHODS:
        est = R.make_estimator(cfg.spec, rc, cfg.per_channel)
        est.update(w)
        xmin, xmax = est.finalize()
    elif rc.method == R.RangeMethod.current_minmax:
        xmin, xmax = R.reduce_min_max(w, rs, rc.percentile)
    else:
        xmin, xmax = R.reduce_min_max(w, rs)
    shape = (-1,) if cfg.per_channel else ()
    return {"qp": Q.set_quant_range(cfg.spec, xmin.reshape(shape),
                                    xmax.reshape(shape)),
            "alpha": None}


def init_weight_qstate(cfg: QuantModelConfig,
                       weights: Mapping[str, Tensor]) -> Dict[str, SiteState]:
    """Initialize all weight sites from a {site_name: weight} mapping."""
    return {name: init_weight_site_state(site_cfg, weights[name])
            for name, site_cfg in cfg.items()
            if site_cfg.kind == "weight" and name in weights}


class QuantCtx:
    """Per-forward quantization context (create one per ``apply`` call).

    ``requant_only_sites``: act sites whose every consumer re-quantizes
    with the site's own params (an int8 matmul); in the fix phase their
    producer-side fake-quant is a numeric no-op and is skipped.

    The generic int path's fused linear (the JAX ``use_pallas``):
    ``fused_linear`` False, True (the kernel on CUDA tensors) or
    ``'plain'`` (its plain version on any device); ``int8_only_sites``,
    act sites consumed only by the next int8 matmul, whose producer emits
    the int8 payload; ``int8_handoffs``, those payloads by site, each
    taken once by its consumer.

    ``mse_session``: the MSE / cross-entropy act sites' estimators by
    site name, kept across calibration batches by the caller.

    ``int8_qat_sites``: layers whose QAT fake-quant matmul runs on int8
    payloads (``training/int8_qat.py``; ``training/qat.py``
    ``int8_forward_sites``).

    ``capture_sites``: the sites whose (input, output) pairs the forward
    records in ``captures``; ``capture_pre_act`` records a fused
    activation's input instead of its output (AdaRound's
    ``include_act_func=False``). While capturing, the int8 payload paths
    stand aside for the float ones.
    """

    def __init__(self, cfg: QuantModelConfig, qstate: Mapping[str, SiteState],
                 mode: QuantMode, mse_session: Optional[Dict] = None):
        self.cfg = cfg
        self.mode = mode
        self.qstate: Dict[str, SiteState] = dict(qstate)
        self.mse_session = mse_session
        self.int_params = None
        self.requant_only_sites = frozenset()
        self.fused_linear = False
        self.int8_only_sites = frozenset()
        self.int8_handoffs: Dict[str, Tensor] = {}
        self.int8_qat_sites = frozenset()
        self.capture_sites = frozenset()
        self.capture_pre_act = False
        self.captures: Dict[str, tuple] = {}
        # inference options (bert_apply): activation storage in
        # compute_dtype, the attention's float einsums in attention_dtype,
        # and its scores / context on int8 levels
        self.compute_dtype = None
        self.attention_dtype = None
        self.int8_attention = False

    def weight(self, name: str, w: Tensor) -> Tensor:
        if name not in self.cfg:
            return w
        cfg = self.cfg[name]
        assert cfg.kind == "weight", name
        if not (self.mode.weight_quant and cfg.enabled):
            return w
        phase = self.mode.weight_phase
        if phase == Phase.estimate:
            qp = estimate_weight_qp(cfg, w)
            self.qstate[name] = dict(self.qstate.get(name, {"alpha": None}),
                                     qp=qp)
        else:  # fix, learn, and the record pre-pass: the stored params
            qp = self.qstate[name]["qp"]
        alpha = self.qstate.get(name, {}).get("alpha")
        axis = 0 if cfg.per_channel else None
        if alpha is not None:
            return Q.adaround_fake_quant(
                Q.AdaRoundMode.learned_hard_sigmoid, cfg.spec, qp, w, alpha,
                soft=False, axis=axis)
        return Q.fake_quant(cfg.spec, qp, w, axis=axis)

    def act(self, name: str, x: Tensor) -> Tensor:
        if name not in self.cfg:
            return x
        cfg = self.cfg[name]
        assert cfg.kind == "act", name
        if name in self.capture_sites:
            self.captures[name] = (x, x)
        if not (self.mode.act_quant and cfg.enabled):
            return x
        phase = self.mode.act_phase
        if (phase == Phase.fix and cfg.axis is None
                and name in self.requant_only_sites):
            return x
        if phase == Phase.record_ranges:
            # PEG permutation pre-pass: record per-channel dynamic ranges
            # at permuted sites; every site passes x through unquantized
            if cfg.permute:
                st = self.qstate.get(name) or init_act_site_state(cfg, x)
                self.qstate[name] = dict(st, ranges=R.channel_dynamic_ranges(
                    x, cfg.axis or 2))
            return x
        if name not in self.qstate:
            self.qstate[name] = init_act_site_state(cfg, x)
        st = dict(self.qstate[name])
        if phase == Phase.estimate:
            rc = cfg.range_cfg
            if rc.method in _MSE_METHODS:
                if self.mse_session is None:
                    raise RuntimeError(
                        f"site {name!r} uses {rc.method} act ranges; run "
                        "calibration with an mse_session")
                est = self.mse_session.get(name)
                if est is None:
                    est = self.mse_session[name] = R.make_estimator(
                        cfg.spec, rc)
                est.update(x.detach())
                xmin, xmax = est.finalize()
            else:
                st["range_state"] = R.update_range_state(
                    st["range_state"], x.detach(), rc, cfg.reduce_spec,
                    perm=st.get("perm"))
                xmin, xmax = R.finalize_ranges(st["range_state"])
            st["qp"] = Q.set_quant_range(cfg.spec, xmin, xmax)
            self.qstate[name] = st
        return Q.fake_quant(cfg.spec, st["qp"], x, axis=cfg.axis)

    def export(self) -> Dict[str, SiteState]:
        return self.qstate


def reset_act_ranges(cfg: QuantModelConfig,
                     qstate: Mapping[str, SiteState]) -> Dict[str, SiteState]:
    """Zero the act sites' range state and params so they can be
    re-estimated (the reference's ``reset_act_ranges``); the PEG
    permutation state is kept."""
    out = dict(qstate)
    for name, site_cfg in cfg.items():
        if site_cfg.kind != "act" or name not in out:
            continue
        st = dict(out[name])
        rs = st["range_state"]
        st["range_state"] = {
            "xmin": torch.zeros_like(rs["xmin"]),
            "xmax": torch.zeros_like(rs["xmax"]),
            "initialized": torch.zeros_like(rs["initialized"]),
        }
        st["qp"] = QuantParamsReset(st["qp"])
        out[name] = st
    return out


def QuantParamsReset(qp: Q.QuantParams) -> Q.QuantParams:
    """Params back to their initial values: unit scale, zero offset,
    unsigned."""
    return Q.QuantParams(delta=torch.ones_like(qp.delta),
                         zero_float=torch.zeros_like(qp.zero_float),
                         signed=torch.zeros_like(qp.signed))


def finalize_permutations(cfg: QuantModelConfig,
                          qstate: Mapping[str, SiteState]
                          ) -> Dict[str, SiteState]:
    """Recorded per-channel ranges -> sort permutations (a stable argsort,
    as ``jnp.argsort``, so tied ranges keep their channel order)."""
    out = dict(qstate)
    for name, site_cfg in cfg.items():
        if site_cfg.kind == "act" and site_cfg.permute and name in out:
            st = dict(out[name])
            if st.get("ranges") is not None:
                st["perm"] = torch.argsort(st["ranges"], stable=True)
            out[name] = st
    return out


def share_ranges(qstate: Mapping[str, SiteState], source: str,
                 targets) -> Dict[str, SiteState]:
    """Copy recorded permutation ranges from one site to the permuted
    sites among ``targets`` (``--per-groups-permute-shared-h``)."""
    out = dict(qstate)
    src = out[source].get("ranges")
    if src is None:
        raise ValueError(f"source site {source} has no recorded ranges")
    for t in targets:
        if t in out and "ranges" in out[t]:
            out[t] = dict(out[t], ranges=src)
    return out
