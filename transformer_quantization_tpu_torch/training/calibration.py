"""Calibration: range estimation over data.

Counterpart of ``transformer_quantization_tpu/training/calibration.py``
and of ``__graft_entry__._calibrated_bert``: stream batches through the
model with activation sites in the estimate phase, after initializing
every weight site from its own tensor; for permuted PEG sites, first the
full-precision pre-pass that records per-channel ranges and fixes the
permutations. The cross-entropy estimator and dynamic (unfixed) ranges
wait for their slices.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Mapping, Optional

import numpy as np
import torch

from transformer_quantization_tpu_torch import resolve_device
from transformer_quantization_tpu_torch.models import bert as B
from transformer_quantization_tpu_torch.models import mobilebert as MB
from transformer_quantization_tpu_torch.quant.manager import (
    finalize_permutations,
    init_weight_qstate,
    share_ranges,
)
from transformer_quantization_tpu_torch.quant.qconfig import (
    Phase,
    QuantDefaults,
    QuantModelConfig,
    QuantMode,
)
from transformer_quantization_tpu_torch.quant.quantizers import QMethod
from transformer_quantization_tpu_torch.quant.ranges import RangeMethod

ApplyFn = Callable  # (params, batch, qcfg=, qstate=, mode=, device=) -> (out, qstate)


def w8a8_defaults() -> QuantDefaults:
    """The W8A8 PTQ recipe: symmetric 8-bit weights, asymmetric 8-bit
    activations, current-minmax ranges for both."""
    return QuantDefaults(method=QMethod.symmetric_uniform,
                         act_method=QMethod.asymmetric_uniform, n_bits=8,
                         weight_range_method=RangeMethod.current_minmax,
                         act_range_method=RangeMethod.current_minmax)


def record_permutation_ranges(apply_fn: ApplyFn, params,
                              qcfg: QuantModelConfig, qstate: Dict,
                              batches: Iterable, max_num_batches: int = 10,
                              shared_groups=None, device="cuda") -> Dict:
    """PEG permutation pre-pass: run the full-precision model recording
    per-channel dynamic ranges at permuted sites, optionally share each
    layer's ranges from a source site (``shared_groups``: ``(source,
    targets)`` pairs), and return qstate with the sort permutations."""
    mode = QuantMode(weight_quant=False, act_quant=True,
                     act_phase=Phase.record_ranges)
    with torch.no_grad():
        for i, batch in enumerate(batches):
            if i >= max_num_batches:
                break
            _, qstate = apply_fn(params, batch, qcfg=qcfg, qstate=qstate,
                                 mode=mode, device=device)
    for source, targets in shared_groups or ():
        qstate = share_ranges(qstate, source, targets)
    return finalize_permutations(qcfg, qstate)


def calibrate_model(apply_fn: ApplyFn, params, qcfg: QuantModelConfig,
                    batches: Iterable, *, weight_tensors: Mapping,
                    max_num_batches: int = 1, device="cuda",
                    qstate: Optional[Dict] = None) -> Dict:
    """Weight sites from their tensors, then act ranges estimated over up
    to ``max_num_batches`` batches, starting from ``qstate`` (the PEG
    permutations); returns the calibrated qstate."""
    with torch.no_grad():
        qstate = dict(qstate or {})
        qstate.update(init_weight_qstate(qcfg, weight_tensors))
        mode = QuantMode(act_phase=Phase.estimate)
        for i, batch in enumerate(batches):
            if i >= max_num_batches:
                break
            _, qstate = apply_fn(params, batch, qcfg=qcfg, qstate=qstate,
                                 mode=mode, device=device)
    return qstate


def calibration_batch(vocab_size: int, batch_size: int, seq: int,
                      seed: int) -> Dict[str, np.ndarray]:
    """The one calibration batch of the W8A8 recipe, drawn exactly as the
    JAX package's ``_calibrated_bert`` draws it."""
    rng = np.random.RandomState(seed)
    return {"input_ids": rng.randint(0, vocab_size,
                                     (batch_size, seq)).astype(np.int32),
            "attention_mask": np.ones((batch_size, seq), np.float32),
            "token_type_ids": np.zeros((batch_size, seq), np.int32)}


# the paper's recipes as quant_dicts over the W8A8 defaults (the JAX
# package's CLI ``--recipe`` presets; the MSE weight ranges those presets
# also set are not ported, so weights stay current-minmax)
RECIPES = {
    "w8a8-mixed": ({"y": 16, "h": 16, "x": 16}, False),
    "w8a8-peg": ({"y": "ngp6", "h": "ngp6", "x": "ngp6"}, True),
}


def calibrated_bert(cfg, batch_size: int = 2, seq: int = 128, seed: int = 0,
                    device="cuda", params: Optional[Dict] = None,
                    defaults: Optional[QuantDefaults] = None,
                    quant_dict: Optional[Mapping] = None,
                    shared_h: bool = False):
    """Random-init BERT (or the given ``params``) + one-batch calibration
    -> ``(params, qcfg, qstate)``. ``quant_dict`` is applied to the site
    config first; when it leaves permuted PEG sites, the full-precision
    pre-pass on the calibration batch fixes their permutations before the
    ranges are estimated, with every permuted site of a layer sharing the
    ``ffn.dense.out`` ranges when ``shared_h``."""
    dev = resolve_device(device)
    if params is None:
        params = B.init_bert_params(cfg, seed=seed, device=dev)
    qcfg = B.declare_bert_sites(defaults or w8a8_defaults(), cfg)
    if quant_dict:
        qcfg = B.apply_bert_quant_dict(qcfg, quant_dict,
                                       cfg.num_hidden_layers)
    batch = calibration_batch(cfg.vocab_size, batch_size, seq, seed)

    def apply_fn(p, b, **kw):
        return B.bert_apply(p, b, cfg, **kw)

    qstate: Dict = {}
    if any(c.kind == "act" and c.permute for _, c in qcfg.items()):
        shared = (B.shared_permutation_groups(cfg.num_hidden_layers)
                  if shared_h else None)
        qstate = record_permutation_ranges(apply_fn, params, qcfg, qstate,
                                           [batch], shared_groups=shared,
                                           device=dev)
    qstate = calibrate_model(apply_fn, params, qcfg, [batch],
                             weight_tensors=B.bert_weight_site_tensors(params),
                             device=dev, qstate=qstate)
    return params, qcfg, qstate


def calibrated_mobilebert(cfg, batch_size: int = 2, seq: int = 128,
                          seed: int = 0, device="cuda",
                          params: Optional[Dict] = None,
                          defaults: Optional[QuantDefaults] = None,
                          quant_dict: Optional[Mapping] = None):
    """Random-init MobileBERT (or the given ``params``) + one-batch
    calibration -> ``(params, qcfg, qstate)``; ``quant_dict`` is the
    MobileBERT one (static enables, attention-probs overrides)."""
    dev = resolve_device(device)
    if params is None:
        params = MB.init_mobilebert_params(cfg, seed=seed, device=dev)
    qcfg = MB.declare_mobilebert_sites(defaults or w8a8_defaults(), cfg,
                                       quant_dict=quant_dict)
    batch = calibration_batch(cfg.vocab_size, batch_size, seq, seed)

    def apply_fn(p, b, **kw):
        return MB.mobilebert_apply(p, b, cfg, **kw)

    qstate = calibrate_model(
        apply_fn, params, qcfg, [batch],
        weight_tensors=MB.mobilebert_weight_site_tensors(params), device=dev)
    return params, qcfg, qstate
