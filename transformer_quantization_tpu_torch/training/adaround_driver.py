"""Model-level AdaRound application.

Counterpart of ``transformer_quantization_tpu/training/adaround_driver.py``:
layer by layer in the family's spec order, the grid init, the capture of
the layer's (input, float output) over the calibration samples, the
rounding optimization (``quant/adaround.py``) and the alphas stored in
the weight site's state; then, in ``post_adaround`` mode with act quant,
the act ranges reset and re-estimated with the rounded weights.

Sequential fidelity: in the asymmetric mode each layer's input is
captured with every weight quantized, the earlier layers' learned
roundings included, so they shape the later layers' targets (the
reference's quantized-prefix pass). The captures stay on the device.
"""

from __future__ import annotations

import logging
import zlib
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from transformer_quantization_tpu_torch.ops.layers import ACTIVATIONS
from transformer_quantization_tpu_torch.quant import adaround as AR
from transformer_quantization_tpu_torch.quant import quantizers as Q
from transformer_quantization_tpu_torch.quant.manager import reset_act_ranges
from transformer_quantization_tpu_torch.quant.qconfig import (
    Phase,
    QuantModelConfig,
    QuantMode,
)
from transformer_quantization_tpu_torch.training.calibration import (
    calibrate_model,
)
from transformer_quantization_tpu_torch.utils.data import (
    batch_iterator,
    trim_to_real_length,
)

logger = logging.getLogger("AdaRound")

Tensor = torch.Tensor


def make_layer_apply(spec: Dict) -> Callable:
    """``layer_apply(w_q, inp) -> out`` for one weighted layer kind:
    ``linear``, ``layernorm``, ``embedding``, ``grouped_linear`` and
    ``nonorm`` (MobileBERT's, whose optimized weight is the stacked ``[w;
    b]``, so one alpha covers both)."""
    kind = spec["kind"]
    if kind == "linear":
        b = spec.get("b")
        act = ACTIVATIONS[spec.get("act")]

        def apply(w_q, x):
            y = torch.matmul(x, w_q.transpose(0, 1))
            if b is not None:
                y = y + b
            if act is not None:
                y = act(y)
            return y
        return apply
    if kind == "layernorm":
        b, eps = spec["b"], spec["eps"]

        def apply(scale_q, x):
            mean = torch.mean(x, dim=-1, keepdim=True)
            var = torch.mean(torch.square(x - mean), dim=-1, keepdim=True)
            return (x - mean) * torch.rsqrt(var + eps) * scale_q + b
        return apply
    if kind == "embedding":
        def apply(t_q, ids):
            # index_select's backward is an index_add_: only the gathered
            # rows get gradient, and nothing waits on the host
            rows = torch.index_select(t_q, 0, ids.reshape(-1))
            return rows.reshape(*ids.shape, t_q.shape[-1])
        return apply
    if kind == "grouped_linear":
        g = spec["groups"]
        b = spec.get("b")
        act = ACTIVATIONS[spec.get("act")]

        def apply(w_q, x):
            out_f, in_g = w_q.shape
            lead = x.shape[:-1]
            xg = x.reshape(*lead, g, in_g)
            wg = w_q.reshape(g, out_f // g, in_g)
            y = torch.einsum("...gi,goi->...go", xg, wg).reshape(*lead, out_f)
            if b is not None:
                y = y + b
            if act is not None:
                y = act(y)
            return y
        return apply
    if kind == "nonorm":
        def apply(wb_q, x):
            w_q, b_q = torch.chunk(wb_q, 2)
            return x * w_q + b_q
        return apply
    raise ValueError(kind)


def get_train_samples(batches, num_samples: int) -> Dict[str, np.ndarray]:
    """The first ``num_samples`` rows of the calibration batches, stacked."""
    acc: Dict[str, List] = {}
    n = 0
    for b in batches:
        for k, v in b.items():
            acc.setdefault(k, []).append(np.asarray(v))
        n += len(np.asarray(b["input_ids"]))
        if n >= num_samples:
            break
    return {k: np.concatenate(v)[:num_samples] for k, v in acc.items()}


def layer_seed(seed: int, name: str) -> int:
    """A layer's generator seed: ``seed + crc32(name) % 10000``. The JAX
    package adds ``hash(name) % 10000``, which Python salts per process,
    so its stream is not reproducible; ``crc32`` is stable."""
    return seed + zlib.crc32(name.encode()) % 10000


def _capture_layer_io(apply_fn, params, qcfg, qstate, samples, site,
                      batch_size, asym, act_quant, include_act_func,
                      device) -> Tuple[Tensor, Tensor]:
    """``(inp, out)`` of ``site`` over ``samples``, concatenated on the
    device: ``out`` under full precision, ``inp`` with the weights
    quantized when ``asym``."""
    fp_mode = QuantMode(weight_quant=False, act_quant=False)
    q_mode = QuantMode(weight_quant=True, act_quant=act_quant,
                       act_phase=Phase.fix)
    n = len(samples["input_ids"])

    def run(mode, want):
        parts = []
        for s in range(0, n, batch_size):
            batch = {k: v[s:s + batch_size] for k, v in samples.items()}
            out, _ = apply_fn(params, batch, qcfg=qcfg, qstate=qstate,
                              mode=mode, capture_sites=(site,),
                              capture_pre_act=not include_act_func,
                              device=device)
            x, y = out["captures"][site]
            parts.append(x if want == "inp" else y)
        return torch.cat(parts, dim=0)

    out = run(fp_mode, "out")
    inp = run(q_mode if asym else fp_mode, "inp")
    return inp, out


def apply_adaround_to_model(apply_fn, params, qcfg: QuantModelConfig,
                            qstate: Dict, layer_specs: List[Tuple[str, Dict]],
                            batches, cfg: AR.AdaRoundConfig, *,
                            batch_size: int = 32,
                            act_quant: bool = False,
                            range_est_batches=None,
                            num_est_batches: int = 1,
                            cross_entropy_layer: Optional[str] = None,
                            seed: int = 0,
                            stats_out: Optional[List] = None,
                            device="cuda") -> Dict:
    """AdaRound layer by layer; returns qstate with the alphas stored.

    ``layer_specs`` comes from the model family
    (``models/bert.py`` ``bert_adaround_specs``); ``cfg.layers`` filters
    it, ``'all'`` or site names. ``stats_out`` collects ``(name,
    stats)`` per layer. Act quant stays off while the roundings are
    learned; with ``act_quant`` in ``post_adaround`` mode the act ranges
    are then re-estimated on ``range_est_batches`` (else ``batches``).
    """
    samples = get_train_samples(batches, cfg.num_samples)
    samples.pop("labels", None)
    samples.pop("example_mask", None)

    if "all" not in cfg.layers:
        known = {name for name, _ in layer_specs}
        for name in cfg.layers:
            if name not in known:
                logger.warning("skipping unknown layer %s", name)
        layer_specs = [(n, s) for n, s in layer_specs if n in cfg.layers]
    if not layer_specs:
        logger.warning("No layers to apply AdaRound for, exiting...")
        return qstate

    effective_act_quant = False

    qstate = dict(qstate)
    for name, spec in layer_specs:
        wsite = f"{name}.w"
        if wsite not in qcfg or not qcfg[wsite].enabled:
            continue
        site_cfg = qcfg[wsite]
        w = spec["w"]
        layer_apply = make_layer_apply(spec)
        st = dict(qstate[wsite])

        if cfg.init == AR.AdaRoundInitMode.range_estimator:
            pass
        elif cfg.init == AR.AdaRoundInitMode.mse:
            with torch.no_grad():
                st["qp"] = AR.mse_grid_init(site_cfg.spec, w)
            qstate[wsite] = st
        elif cfg.init in (AR.AdaRoundInitMode.mse_out,
                          AR.AdaRoundInitMode.mse_out_asym):
            inp0, out0 = _capture_layer_io(
                apply_fn, params, qcfg, qstate, samples, name, batch_size,
                asym=cfg.init == AR.AdaRoundInitMode.mse_out_asym,
                act_quant=effective_act_quant,
                include_act_func=cfg.include_act_func, device=device)

            def out_loss(qp, _inp=inp0[:batch_size], _out=out0[:batch_size],
                         _spec=site_cfg.spec, _w=w, _ap=layer_apply):
                axis = 0 if _spec and qp.delta.ndim else None
                w_q = Q.fake_quant(_spec, qp, _w, axis=axis)
                return torch.mean((_ap(w_q, _inp) - _out) ** 2)

            with torch.no_grad():
                st["qp"] = AR.mse_grid_init(site_cfg.spec, w,
                                            loss_fn=out_loss)
            qstate[wsite] = st
        else:
            raise ValueError(f"Unknown initialization for AdaRound: "
                             f"{cfg.init}")

        inp, out = _capture_layer_io(
            apply_fn, params, qcfg, qstate, samples, name, batch_size,
            asym=cfg.asym, act_quant=effective_act_quant,
            include_act_func=cfg.include_act_func, device=device)

        logger.info("Started AdaRound for layer %s", name)
        alpha, stats = AR.optimize_layer_rounding(
            layer_apply, site_cfg.spec, st["qp"], w, inp, out, cfg,
            seed=layer_seed(seed, name))
        st["alpha"] = alpha
        qstate[wsite] = st
        logger.info("Done AdaRound for layer %s: %s", name, stats)
        if stats_out is not None:
            stats_out.append((name, stats))

    if (cfg.act_quant_mode == AR.AdaRoundActQuantMode.post_adaround
            and act_quant):
        qstate = reset_act_ranges(qcfg, qstate)
        qstate = calibrate_model(
            apply_fn, params, qcfg,
            range_est_batches if range_est_batches is not None else batches,
            max_num_batches=num_est_batches, act_quant=True,
            weight_quant=True, cross_entropy_layer=cross_entropy_layer,
            device=device, qstate=qstate)
    return qstate


def adaround_multi_eval(apply_fn, params, qcfg: QuantModelConfig,
                        qstate: Dict, *, eval_fn: Callable,
                        est_arrays: Dict[str, np.ndarray],
                        act_quant_mode: AR.AdaRoundActQuantMode,
                        weight_quant: bool = True, act_quant: bool = True,
                        num_est_batches: int = 1, est_pad: bool = True,
                        cross_entropy_layer: Optional[str] = None,
                        batch_sizes: Tuple[int, ...] = (1, 4, 16),
                        log_fn: Callable = logger.info, device="cuda"):
    """AdaRound's evaluation protocol: score once with FP32 activations;
    then, unless ``no_act_quant``, for each calibration batch size reset
    the act ranges, re-estimate them on up to ``num_est_batches`` batches
    of that size from ``est_arrays``, fix and score; the result is the
    best score (the first of equals).

    ``eval_fn(qstate, mode) -> (score, payload)``. Returns ``(score,
    details)``: ``fp_acts_score``, per-batch-size ``scores``,
    ``best_batch_size``, ``best_qstate`` and the winner's ``payload``.
    """
    fp_mode = QuantMode(weight_quant=weight_quant, act_quant=False)
    fp_score, fp_payload = eval_fn(qstate, fp_mode)
    log_fn(f"Score (FP32 acts) -> {100.0 * fp_score:.2f}")
    if act_quant_mode == AR.AdaRoundActQuantMode.no_act_quant or not act_quant:
        return fp_score, {"fp_acts_score": fp_score, "scores": {},
                          "best_batch_size": None, "best_qstate": qstate,
                          "payload": fp_payload}

    q_mode = QuantMode(weight_quant=weight_quant, act_quant=True)
    scores: Dict[int, float] = {}
    best = None
    for bs in batch_sizes:
        qs = reset_act_ranges(qcfg, qstate)
        est_batches = []
        for b in batch_iterator(est_arrays, bs, drop_last=True):
            b.pop("labels", None)
            b.pop("example_mask", None)
            if not est_pad:
                b = trim_to_real_length(b)
            est_batches.append(b)
            if len(est_batches) >= num_est_batches:
                break
        qs = calibrate_model(apply_fn, params, qcfg, est_batches,
                             max_num_batches=num_est_batches,
                             act_quant=True, weight_quant=weight_quant,
                             cross_entropy_layer=cross_entropy_layer,
                             device=device, qstate=qs)
        sc, payload = eval_fn(qs, q_mode)
        scores[bs] = sc
        log_fn(f"Score (bs={bs}) -> {100.0 * sc:.2f}")
        if best is None or sc > scores[best[0]]:
            best = (bs, qs, payload)
    log_fn(f"Score (FP32 acts) -> {100.0 * fp_score:.2f}")
    for k, v in scores.items():
        log_fn(f"Score (bs={k}) -> {100.0 * v:.2f}")
    return scores[best[0]], {"fp_acts_score": fp_score, "scores": scores,
                             "best_batch_size": best[0],
                             "best_qstate": best[1], "payload": best[2]}
