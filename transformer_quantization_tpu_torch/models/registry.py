"""Model-family registry.

Counterpart of ``transformer_quantization_tpu/models/registry.py``: each
family exposes one uniform functional surface, so the serving engine (and
later the CLI, trainer and AdaRound driver) are family-agnostic. The port
has BERT and MobileBERT; ``roberta``, ``distilbert``, ``albert`` and
``squeezebert`` resolve by name and raise ``NotImplementedError`` (ROADMAP
§1 item 5), as do the HF ``config.json`` loader (item 5) and MobileBERT's
AdaRound specs (item 5).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, Optional, Tuple

from transformer_quantization_tpu_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class ModelFamily:
    """Uniform functional surface of one quantized model family."""

    name: str
    config_cls: type
    init_params: Callable                  # (cfg, seed, device) -> params
    init_head: Callable                    # (cfg, seed, device) -> head subtree
    head_key: str                          # params key the head lives under
    apply: Callable                        # bert_apply-compatible signature
    declare_sites: Callable                # (defaults, cfg, quant_setup, qd)
    apply_quant_dict: Callable             # (qcfg, quant_dict, n_layers)
    apply_peg: Callable                    # (qcfg, n_layers, **peg)
    weight_site_tensors: Callable          # (params) -> {site: tensor}
    adaround_specs: Callable               # (params, cfg) -> [(name, spec)]
    build_int_params: Callable             # (params, qcfg, qstate, use_int4)
    shared_perm_groups: Optional[Callable]  # (n_layers) -> [(src, targets)]
    load_checkpoint: Callable              # (dir, num_labels) -> (cfg, params)
    # full-handoff int8 inference engine (ops/engine.py); None = family
    # not engine-capable
    build_engine: Optional[Callable] = None   # (params, cfg, qcfg, qstate)
    engine_apply: Optional[Callable] = None   # (params, batch, cfg, ...)
    # per model-name config presets
    config_presets: Dict[str, Dict] = dataclasses.field(default_factory=dict)
    tiny_preset: Dict = dataclasses.field(default_factory=dict)


def _mobilebert_adaround_specs(params, cfg):
    raise NotImplementedError(
        "MobileBERT's AdaRound specs (its NoNorm layers' stacked [w; b] "
        "alphas and their deployment) are not yet ported (ROADMAP §1 item "
        "5)")


def _hf_loader(family: str) -> Callable:
    def load(model_dir, num_labels=None):
        raise NotImplementedError(
            f"loading a HF {family} checkpoint ({model_dir}/config.json) is "
            "not yet ported (ROADMAP §1 item 5: models/hf_loader.py)")
    return load


def _bert_family() -> ModelFamily:
    from transformer_quantization_tpu_torch.models import bert as B

    def init_head(cfg, seed=0, device="cuda"):
        return B.init_bert_params(dataclasses.replace(cfg,
                                                      num_hidden_layers=0),
                                  seed, device)["classifier"]

    return ModelFamily(
        name="bert",
        config_cls=B.BertConfig,
        init_params=B.init_bert_params,
        init_head=init_head,
        head_key="classifier",
        apply=B.bert_apply,
        declare_sites=B.declare_bert_sites,
        apply_quant_dict=B.apply_bert_quant_dict,
        apply_peg=B.apply_peg_wiring,
        weight_site_tensors=B.bert_weight_site_tensors,
        adaround_specs=B.bert_adaround_specs,
        build_int_params=B.build_bert_int_params,
        shared_perm_groups=B.shared_permutation_groups,
        load_checkpoint=_hf_loader("bert"),
        build_engine=B.build_bert_engine,
        engine_apply=B.bert_engine_apply,
        config_presets={
            "bert_base_uncased": {},
            "bert_base_cased": dict(vocab_size=28996),
            "bert_large_uncased": dict(hidden_size=1024,
                                       num_hidden_layers=24,
                                       num_attention_heads=16,
                                       intermediate_size=4096),
        },
        tiny_preset=dict(vocab_size=2048, hidden_size=64,
                         num_hidden_layers=2, num_attention_heads=4,
                         intermediate_size=128,
                         max_position_embeddings=128),
    )


def _mobilebert_family() -> ModelFamily:
    from transformer_quantization_tpu_torch.models import mobilebert as M

    def init_head(cfg, seed=0, device="cuda"):
        return M.init_mobilebert_params(
            dataclasses.replace(cfg, num_hidden_layers=0), seed,
            device)["classifier"]

    return ModelFamily(
        name="mobilebert",
        config_cls=M.MobileBertConfig,
        init_params=M.init_mobilebert_params,
        init_head=init_head,
        head_key="classifier",
        apply=M.mobilebert_apply,
        declare_sites=M.declare_mobilebert_sites,
        apply_quant_dict=M.apply_mobilebert_quant_dict,
        apply_peg=M.apply_peg_wiring,
        weight_site_tensors=M.mobilebert_weight_site_tensors,
        adaround_specs=_mobilebert_adaround_specs,
        build_int_params=M.build_mobilebert_int_params,
        build_engine=M.build_mobilebert_engine,
        engine_apply=M.mobilebert_engine_apply,
        shared_perm_groups=None,
        load_checkpoint=_hf_loader("mobilebert"),
        config_presets={"mobilebert_uncased": {}},
        tiny_preset=dict(vocab_size=2048, hidden_size=64,
                         num_hidden_layers=2, num_attention_heads=4,
                         intermediate_size=64, embedding_size=16,
                         intra_bottleneck_size=32,
                         max_position_embeddings=128),
    )


def _not_ported(name: str) -> Callable[[], ModelFamily]:
    def family() -> ModelFamily:
        raise NotImplementedError(
            f"model family {name!r} is not yet ported (ROADMAP §1 item 5)")
    return family


_FAMILIES = {
    "bert": _bert_family,
    "roberta": _not_ported("roberta"),
    "mobilebert": _mobilebert_family,
    "distilbert": _not_ported("distilbert"),
    "albert": _not_ported("albert"),
    "squeezebert": _not_ported("squeezebert"),
}

# model-name -> family (the reference's quantizable HF models)
MODEL_NAME_TO_FAMILY = {
    "bert_base_uncased": "bert",
    "bert_base_cased": "bert",
    "bert_large_uncased": "bert",
    "roberta_base": "roberta",
    "distilroberta_base": "roberta",
    "mobilebert_uncased": "mobilebert",
    "distilbert_base_uncased": "distilbert",
    "albert_base_v2": "albert",
    "albert_large_v2": "albert",
    "squeezebert_uncased": "squeezebert",
}


def get_family(name: str) -> ModelFamily:
    """Resolve a family by family name or model name."""
    if name in MODEL_NAME_TO_FAMILY:
        name = MODEL_NAME_TO_FAMILY[name]
    return _FAMILIES[name]()


def build_model(model_name: str, seed: int = 0, tiny: bool = False,
                num_labels: int = 2, model_path: Optional[str] = None,
                device="cuda", **overrides
                ) -> Tuple[ModelFamily, object, Dict]:
    """(family, cfg, params) for a model name on ``device``; a framework
    checkpoint directory (``utils/checkpoint.py``) as ``model_path`` gives
    its family, config and weights. Random init draws from the family's
    seeded generator (``init_*_params(cfg, seed, device)``), not JAX's
    ``PRNGKey`` stream."""
    dev = resolve_device(device)
    fam = get_family(model_name)
    if model_path and os.path.exists(os.path.join(model_path,
                                                  "manifest.json")):
        from transformer_quantization_tpu_torch.utils import checkpoint as CK

        ck = CK.load_checkpoint(model_path, device=dev)
        fam = get_family(ck["family"])
        cfg = ck["cfg"]
        if num_labels and cfg.num_labels != num_labels:
            cfg = dataclasses.replace(cfg, num_labels=num_labels)
        return fam, cfg, ck["params"]
    if model_path and os.path.exists(os.path.join(model_path, "config.json")):
        cfg, params = fam.load_checkpoint(model_path, num_labels)
        return fam, cfg, params
    kw = dict(fam.config_presets.get(model_name, {}))
    if tiny:
        kw = dict(fam.tiny_preset)
    kw.update(overrides)
    kw["num_labels"] = num_labels
    cfg = fam.config_cls(**kw)
    return fam, cfg, fam.init_params(cfg, seed, dev)
