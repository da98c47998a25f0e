"""Quantization observability.

Counterpart of ``transformer_quantization_tpu/utils/telemetry.py``:

- :func:`range_summary` — every site's range, scale and bits, straight
  from the calibrated quant state (no forward needed);
- :func:`clipped_fraction` — the fraction of a tensor outside a site's
  range;
- :func:`activation_report` — one capture forward
  (``apply_fn(capture_sites=)``) over chosen sites: histograms,
  per-token max-abs profiles and clip rates;
- :func:`residual_sites` / :func:`write_residual_histograms` — per-layer
  residual histograms, per tensor and per token;
- :class:`TBWriter` — TensorBoard event files through
  ``torch.utils.tensorboard`` where ``tensorboard`` imports, else the JAX
  package's JSONL fallback (``events.jsonl``, one JSON object a scalar or
  histogram), which the tests hold against JAX's by hiding the import.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Mapping, Sequence

import numpy as np
import torch

from transformer_quantization_tpu_torch.quant import quantizers as Q


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def range_summary(qcfg, qstate: Mapping) -> Dict[str, Dict]:
    """Per-site range / scale summary from calibrated state."""
    out: Dict[str, Dict] = {}
    for name, site in qcfg.items():
        st = qstate.get(name)
        if st is None or "qp" not in st:
            continue
        qp = st["qp"]
        xmin, xmax = Q.x_min_max_of(site.spec, qp)
        out[name] = {
            "kind": site.kind,
            "n_bits": site.spec.n_bits,
            "enabled": site.enabled,
            "symmetric": site.spec.symmetric,
            "x_min": _np(xmin).tolist(),
            "x_max": _np(xmax).tolist(),
            "delta": _np(Q.scale_of(site.spec, qp)).tolist(),
            "per_channel_shape": list(qp.delta.shape),
            "has_alpha": st.get("alpha") is not None,
        }
    return out


def clipped_fraction(spec, qp, x) -> float:
    """Fraction of elements outside the quantizer's representable range."""
    xmin, xmax = Q.x_min_max_of(spec, qp)
    x = torch.as_tensor(x)
    clipped = (x < xmin.to(x.device)) | (x > xmax.to(x.device))
    return float(clipped.to(torch.float32).mean())


def _histogram(x: np.ndarray, bins: int = 64) -> Dict:
    hist, edges = np.histogram(x, bins=bins)
    return {"counts": hist.tolist(), "lo": float(edges[0]),
            "hi": float(edges[-1])}


def _captures(apply_fn, params, qcfg, qstate, batch, sites, mode):
    from transformer_quantization_tpu_torch.quant.qconfig import QuantMode

    mode = mode or QuantMode(weight_quant=False, act_quant=False)
    out, _ = apply_fn(params, batch, qcfg=qcfg, qstate=qstate, mode=mode,
                      capture_sites=tuple(sites))
    return out.get("captures", {})


def activation_report(apply_fn, params, qcfg, qstate, batch,
                      sites: Sequence[str], mode=None,
                      bins: int = 64) -> Dict[str, Dict]:
    """Capture the chosen sites in one forward and fingerprint them: per
    site a histogram, the per-token max-abs profile of (B, T, d) tensors,
    the dynamic range and the clip rate against the site's calibrated
    range (at ``<site>.out`` where that site exists)."""
    caps = _captures(apply_fn, params, qcfg, qstate, batch, sites, mode)
    report: Dict[str, Dict] = {}
    for name in sites:
        if name not in caps:
            continue
        y = _np(caps[name][1])
        entry: Dict = {
            "shape": list(y.shape),
            "min": float(y.min()),
            "max": float(y.max()),
            "mean": float(y.mean()),
            "std": float(y.std()),
            "hist": _histogram(y, bins),
        }
        if y.ndim == 3:
            entry["per_token_max_abs"] = np.abs(y).max(axis=(0, 2)).tolist()
        site_key = f"{name}.out" if f"{name}.out" in qcfg else name
        st = qstate.get(site_key)
        if st is not None and "qp" in st and site_key in qcfg:
            entry["clipped_fraction"] = clipped_fraction(
                qcfg[site_key].spec, st["qp"], torch.from_numpy(y))
        report[name] = entry
    return report


def residual_sites(qcfg) -> list:
    """All residual-sum activation sites (``*.res``)."""
    return [n for n, c in qcfg.items()
            if c.kind == "act" and n.endswith(".res")]


def write_residual_histograms(apply_fn, params, qcfg, qstate, batch, writer,
                              *, step: int = 0, mode=None,
                              per_token: bool = True,
                              sites: Sequence[str] = None) -> list:
    """One capture forward, then for each residual site a whole-tensor
    histogram (tag ``<site>/layer`` at ``step``) and, for the first sample,
    one histogram per token position (tag ``<site>/token``, the position
    as the step). Returns the sites written."""
    sites = list(sites) if sites is not None else residual_sites(qcfg)
    caps = _captures(apply_fn, params, qcfg, qstate, batch, sites, mode)
    written = []
    for name in sites:
        if name not in caps:
            continue
        y = _np(caps[name][1])
        writer.histogram(f"{name}/layer", y, step)
        if per_token and y.ndim == 3:
            for t in range(y.shape[1]):
                writer.histogram(f"{name}/token", y[0, t], step=t)
        written.append(name)
    return written


class TBWriter:
    """TensorBoard writer with a JSONL fallback (``events.jsonl``)."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self._jsonl = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(logdir)
        except Exception:  # tensorboard missing or unusable: JSONL
            self._tb = None
            self._jsonl = open(os.path.join(logdir, "events.jsonl"), "a")

    def scalar(self, tag: str, value: float, step: int = 0):
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)
        else:
            self._jsonl.write(json.dumps(
                {"type": "scalar", "tag": tag, "value": float(value),
                 "step": step}) + "\n")

    def histogram(self, tag: str, values, step: int = 0):
        if self._tb is not None:
            self._tb.add_histogram(tag, _np(values), step)
        else:
            self._jsonl.write(json.dumps(
                {"type": "histogram", "tag": tag,
                 "hist": _histogram(_np(values)), "step": step}) + "\n")

    def write_range_summary(self, qcfg, qstate, step: int = 0):
        for name, info in range_summary(qcfg, qstate).items():
            d = np.asarray(info["delta"]).ravel()
            self.scalar(f"ranges/{name}/delta_mean", float(d.mean()), step)
            xmin = np.asarray(info["x_min"]).ravel()
            xmax = np.asarray(info["x_max"]).ravel()
            self.scalar(f"ranges/{name}/x_min", float(xmin.min()), step)
            self.scalar(f"ranges/{name}/x_max", float(xmax.max()), step)

    def close(self):
        if self._tb is not None:
            self._tb.close()
        if self._jsonl is not None:
            self._jsonl.close()
