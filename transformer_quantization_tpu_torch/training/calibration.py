"""Calibration: range estimation over data.

Counterpart of ``transformer_quantization_tpu/training/calibration.py``
and of ``__graft_entry__._calibrated_bert``: stream batches through the
model with activation sites in the estimate phase, after initializing
every weight site from its own tensor. The cross-entropy estimator, the
PEG permutation pre-pass and dynamic (unfixed) ranges wait for their
slices.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Mapping, Optional

import numpy as np
import torch

from transformer_quantization_tpu_torch import resolve_device
from transformer_quantization_tpu_torch.models import bert as B
from transformer_quantization_tpu_torch.quant.manager import init_weight_qstate
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


def calibrate_model(apply_fn: ApplyFn, params, qcfg: QuantModelConfig,
                    batches: Iterable, *, weight_tensors: Mapping,
                    max_num_batches: int = 1, device="cuda") -> Dict:
    """Weight sites from their tensors, then act ranges estimated over up
    to ``max_num_batches`` batches; returns the calibrated qstate."""
    with torch.no_grad():
        qstate = init_weight_qstate(qcfg, weight_tensors)
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


def calibrated_bert(cfg, batch_size: int = 2, seq: int = 128, seed: int = 0,
                    device="cuda", params: Optional[Dict] = None,
                    defaults: Optional[QuantDefaults] = None):
    """Random-init BERT (or the given ``params``) + one-batch calibration
    -> ``(params, qcfg, qstate)``."""
    dev = resolve_device(device)
    if params is None:
        params = B.init_bert_params(cfg, seed=seed, device=dev)
    qcfg = B.declare_bert_sites(defaults or w8a8_defaults(), cfg)
    batch = calibration_batch(cfg.vocab_size, batch_size, seq, seed)
    qstate = calibrate_model(
        lambda p, b, **kw: B.bert_apply(p, b, cfg, **kw), params, qcfg,
        [batch], weight_tensors=B.bert_weight_site_tensors(params),
        device=dev)
    return params, qcfg, qstate
