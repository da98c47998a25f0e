"""Calibration: range estimation over data.

Counterpart of ``transformer_quantization_tpu/training/calibration.py``
and of ``__graft_entry__._calibrated_bert``: stream batches through the
model with activation sites in the estimate phase (MSE and cross-entropy
act sites keep their estimators in one ``mse_session`` for the run),
after initializing every weight site from its own tensor; for permuted
PEG sites, first the full-precision pre-pass that records per-channel
ranges and fixes the permutations. :func:`prepare_quantized_model` also
gives dynamic (unfixed) act ranges, and :data:`CLI_RECIPES` holds the JAX
CLI's PTQ presets and the calibration of its ``qat-w4a8`` recipe (whose
training options are ``training/trainer.py`` ``QAT_RECIPES``);
:data:`ADAROUND_RECIPES` its ``w4-adaround`` recipe (``training/
adaround_driver.py`` runs it).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, Mapping, Optional

import numpy as np
import torch

from transformer_quantization_tpu_torch import resolve_device
from transformer_quantization_tpu_torch.models import bert as B
from transformer_quantization_tpu_torch.models import mobilebert as MB
from transformer_quantization_tpu_torch.quant import adaround as AR
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
from transformer_quantization_tpu_torch.quant.quantizers import (
    AdaRoundMode,
    QMethod,
)
from transformer_quantization_tpu_torch.quant.ranges import (
    OptMethod,
    RangeMethod,
)

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


def install_cross_entropy_estimator(qcfg: QuantModelConfig,
                                    site: str) -> QuantModelConfig:
    """Switch one act site to cross-entropy range estimation by golden
    section (the reference's ``cross_entropy_layer`` option)."""
    new_rc = dataclasses.replace(qcfg[site].range_cfg,
                                 method=RangeMethod.cross_entropy,
                                 opt_method=OptMethod.golden_section)
    return qcfg.replace_site(site, range_cfg=new_rc)


def calibrate_model(apply_fn: ApplyFn, params, qcfg: QuantModelConfig,
                    batches: Iterable, *,
                    weight_tensors: Optional[Mapping] = None,
                    max_num_batches: int = 1, act_quant: bool = True,
                    weight_quant: bool = True,
                    cross_entropy_layer: Optional[str] = None,
                    device="cuda", qstate: Optional[Dict] = None) -> Dict:
    """Weight sites from their tensors, then act ranges estimated over up
    to ``max_num_batches`` batches (weights fixed), starting from
    ``qstate`` (the PEG permutations); returns the calibrated qstate.
    Raises ``ValueError`` when ``batches`` holds none."""
    if cross_entropy_layer is not None:
        qcfg = install_cross_entropy_estimator(qcfg, cross_entropy_layer)
    qstate = dict(qstate or {})
    with torch.no_grad():
        if weight_quant and weight_tensors:
            qstate.update(init_weight_qstate(qcfg, weight_tensors))
        if act_quant:
            mode = QuantMode(weight_quant=weight_quant, act_quant=True,
                             act_phase=Phase.estimate,
                             weight_phase=Phase.fix)
            mse_session: Dict = {}
            n = 0
            for batch in batches:
                if n >= max_num_batches:
                    break
                _, qstate = apply_fn(params, batch, qcfg=qcfg, qstate=qstate,
                                     mode=mode, mse_session=mse_session,
                                     device=device)
                n += 1
            if n == 0:
                raise ValueError("no calibration batches provided")
    return qstate


def prepare_quantized_model(apply_fn: ApplyFn, params,
                            qcfg: QuantModelConfig, batches, *,
                            weight_tensors=None, num_batches: int = 1,
                            act_quant: bool = True, weight_quant: bool = True,
                            dynamic: bool = False, cross_entropy_layer=None,
                            permute_batches=None, shared_groups=None,
                            device="cuda"):
    """PTQ preparation: the PEG pre-pass where the config has permuted
    sites (on ``permute_batches``, else ``batches``), then calibration;
    returns ``(qstate, eval_mode)``. ``dynamic=True`` fixes no act
    ranges: only the weight sites are set, and the eval mode re-estimates
    act ranges on every batch."""
    qstate: Dict = {}
    if any(c.kind == "act" and c.permute for _, c in qcfg.items()):
        qstate = record_permutation_ranges(
            apply_fn, params, qcfg, qstate,
            permute_batches if permute_batches is not None else batches,
            shared_groups=shared_groups, device=device)
    if dynamic:
        if weight_tensors and weight_quant:
            with torch.no_grad():
                qstate.update(init_weight_qstate(qcfg, weight_tensors))
        return qstate, QuantMode(weight_quant=weight_quant,
                                 act_quant=act_quant,
                                 act_phase=Phase.estimate)
    qstate = calibrate_model(apply_fn, params, qcfg, batches,
                             weight_tensors=weight_tensors,
                             max_num_batches=num_batches,
                             act_quant=act_quant, weight_quant=weight_quant,
                             cross_entropy_layer=cross_entropy_layer,
                             device=device, qstate=qstate)
    return qstate, QuantMode(weight_quant=weight_quant, act_quant=act_quant,
                             act_phase=Phase.fix)


def calibration_batch(vocab_size: int, batch_size: int, seq: int,
                      seed: int) -> Dict[str, np.ndarray]:
    """The one calibration batch of the W8A8 recipe, drawn exactly as the
    JAX package's ``_calibrated_bert`` draws it."""
    rng = np.random.RandomState(seed)
    return {"input_ids": rng.randint(0, vocab_size,
                                     (batch_size, seq)).astype(np.int32),
            "attention_mask": np.ones((batch_size, seq), np.float32),
            "token_type_ids": np.zeros((batch_size, seq), np.int32)}


# the paper's recipes as quant_dicts over the current-minmax W8A8
# defaults, with shared-h for PEG (weights and acts current-minmax)
MINMAX_RECIPES = {
    "w8a8-mixed": ({"y": 16, "h": 16, "x": 16}, False),
    "w8a8-peg": ({"y": "ngp6", "h": "ngp6", "x": "ngp6"}, True),
}


@dataclasses.dataclass(frozen=True)
class Recipe:
    """One calibration preset of the JAX CLI: the site defaults, the
    quant_dict, the PEG shared-h permutation, the classifier's
    ``quant_setup``, the sequences of its one calibration batch
    (``est_batch_size``, trimmed to their real length unless
    ``est_pad``) and whether activations are quantized (the CLI's
    ``--no-act-quant`` clears ``act_quant``)."""

    defaults: QuantDefaults
    quant_dict: Mapping
    shared_h: bool = False
    quant_setup: str = "all"
    est_batch_size: int = 1
    est_pad: bool = False
    act_quant: bool = True


def cli_w8a8_defaults() -> QuantDefaults:
    """The CLI's ``_W8A8`` preset over its option defaults: symmetric
    8-bit weights with MSE golden-section ranges over 100 candidates,
    asymmetric 8-bit activations with current-minmax ranges."""
    return QuantDefaults(method=QMethod.symmetric_uniform,
                         act_method=QMethod.asymmetric_uniform, n_bits=8,
                         n_bits_act=8, per_channel_weights=False,
                         percentile=None,
                         weight_range_method=RangeMethod.MSE,
                         weight_range_opt=OptMethod.golden_section,
                         weight_num_candidates=100,
                         act_range_method=RangeMethod.current_minmax,
                         act_range_opt=OptMethod.golden_section,
                         act_momentum=0.9, act_num_candidates=100)


def cli_w4a8_qat_defaults() -> QuantDefaults:
    """The CLI's ``qat-w4a8`` calibration: symmetric 4-bit weights with MSE
    golden-section ranges, asymmetric 8-bit activations with
    current-minmax ranges (the other options at the CLI's defaults)."""
    return dataclasses.replace(cli_w8a8_defaults(), n_bits=4, n_bits_act=8)


# a copy of the JAX CLI's ``RECIPES`` PTQ presets and ``apply_recipe``'s
# STS-B variant of the mixed one (pooler and classifier sites 16-bit, the
# classifier output's range by MSE golden section), and the calibration of
# its ``qat-w4a8`` recipe: one estimation batch of 16 sequences padded to
# their full length
CLI_RECIPES = {
    "w8a8": Recipe(cli_w8a8_defaults(), {}),
    "w8a8-mixed": Recipe(cli_w8a8_defaults(), {"y": 16, "h": 16, "x": 16}),
    "w8a8-mixed-stsb": Recipe(
        cli_w8a8_defaults(),
        {"y": 16, "h": 16, "x": 16, "P": 16, "C": 16},
        quant_setup="MSE_logits"),
    "w8a8-peg": Recipe(cli_w8a8_defaults(),
                       {"y": "ngp6", "h": "ngp6", "x": "ngp6"},
                       shared_h=True),
    "qat-w4a8": Recipe(cli_w4a8_qat_defaults(), {}, est_batch_size=16,
                       est_pad=True),
}


def cli_w4_adaround_defaults() -> QuantDefaults:
    """The CLI's ``w4-adaround`` ranges: symmetric 4-bit weights with MSE
    ranges by grid search over 100 candidates (the act options at the
    CLI's defaults, unused while acts stay float)."""
    return dataclasses.replace(cli_w8a8_defaults(), n_bits=4,
                               weight_range_opt=OptMethod.grid)


# the JAX CLI's ``w4-adaround`` recipe: W4A32 (no act quant), every layer's
# rounding learned over 1,024 samples for 10,000 iterations from the
# weights' own ranges, act ranges left alone (``no_act_quant``); the
# AdaRound minibatch is the CLI's default ``--batch-size`` (32)
ADAROUND_RECIPES = {
    "w4-adaround": (
        Recipe(cli_w4_adaround_defaults(), {}, act_quant=False),
        AR.AdaRoundConfig(
            layers=("all",), num_samples=1024,
            init=AR.AdaRoundInitMode.range_estimator,
            round_mode=AdaRoundMode.learned_hard_sigmoid,
            iters=10000,
            act_quant_mode=AR.AdaRoundActQuantMode.no_act_quant,
            batch_size=32)),
}


def calibrated_bert(cfg, batch_size: int = 2, seq: int = 128, seed: int = 0,
                    device="cuda", params: Optional[Dict] = None,
                    defaults: Optional[QuantDefaults] = None,
                    quant_dict: Optional[Mapping] = None,
                    shared_h: bool = False, recipe: Optional[str] = None):
    """Random-init BERT (or the given ``params``) + one-batch calibration
    -> ``(params, qcfg, qstate)``. ``recipe`` names a preset of
    :data:`CLI_RECIPES`, which then sets ``defaults``, ``quant_dict``,
    ``shared_h`` and the classifier's ``quant_setup``; without it the
    defaults are the current-minmax :func:`w8a8_defaults`. ``quant_dict``
    is applied to the site config first; when it leaves permuted PEG
    sites, the full-precision pre-pass on the calibration batch fixes
    their permutations before the ranges are estimated, with every
    permuted site of a layer sharing the ``ffn.dense.out`` ranges when
    ``shared_h``."""
    dev = resolve_device(device)
    quant_setup = "all"
    if recipe is not None:
        r = CLI_RECIPES[recipe]
        defaults, quant_dict, shared_h = r.defaults, r.quant_dict, r.shared_h
        quant_setup = r.quant_setup
    if params is None:
        params = B.init_bert_params(cfg, seed=seed, device=dev)
    qcfg = B.declare_bert_sites(defaults or w8a8_defaults(), cfg,
                                quant_setup=quant_setup,
                                quant_dict=quant_dict)
    if quant_dict:
        qcfg = B.apply_bert_quant_dict(qcfg, quant_dict,
                                       cfg.num_hidden_layers)
    batch = calibration_batch(cfg.vocab_size, batch_size, seq, seed)

    def apply_fn(p, b, **kw):
        return B.bert_apply(p, b, cfg, **kw)

    shared = (B.shared_permutation_groups(cfg.num_hidden_layers)
              if shared_h else None)
    qstate, _ = prepare_quantized_model(
        apply_fn, params, qcfg, [batch],
        weight_tensors=B.bert_weight_site_tensors(params),
        shared_groups=shared, device=dev)
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
