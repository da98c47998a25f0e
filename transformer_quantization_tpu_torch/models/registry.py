"""Model-family registry.

Counterpart of ``transformer_quantization_tpu/models/registry.py``: each
family exposes one uniform functional surface, so the serving engine (and
later the CLI, trainer and AdaRound driver) are family-agnostic. All six
of the JAX package's quantizable families are here: BERT, RoBERTa
(``distilroberta_base`` too), MobileBERT, DistilBERT, ALBERT and
SqueezeBERT, each with its full-handoff engine, and each loads a local
Hugging Face checkpoint directory (``models/hf_loader.py``).
MobileBERT's AdaRound specs raise (ROADMAP §1 item 5).
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
    load_checkpoint: Callable              # (dir, num_labels, device)
    #                                        -> (cfg, params)
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
    def load(model_dir, num_labels=None, device="cuda"):
        from transformer_quantization_tpu_torch.models import hf_loader

        return hf_loader.LOADERS[family](model_dir, num_labels, device)
    return load


def _init_head(init_params: Callable) -> Callable:
    """A family's head subtree, from its init at zero layers."""
    def init_head(cfg, seed=0, device="cuda"):
        return init_params(dataclasses.replace(cfg, num_hidden_layers=0),
                           seed, device)["classifier"]
    return init_head


_TINY = dict(vocab_size=2048, hidden_size=64, num_hidden_layers=2,
             num_attention_heads=4, intermediate_size=128,
             max_position_embeddings=128)


def _bert_family() -> ModelFamily:
    from transformer_quantization_tpu_torch.models import bert as B

    return ModelFamily(
        name="bert",
        config_cls=B.BertConfig,
        init_params=B.init_bert_params,
        init_head=_init_head(B.init_bert_params),
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
        tiny_preset=dict(_TINY),
    )


def _roberta_family() -> ModelFamily:
    from transformer_quantization_tpu_torch.models import bert as B
    from transformer_quantization_tpu_torch.models import roberta as R

    return ModelFamily(
        name="roberta",
        config_cls=R.RobertaConfig,
        init_params=R.init_roberta_params,
        init_head=_init_head(R.init_roberta_params),
        head_key="classifier",
        apply=R.roberta_apply,
        declare_sites=R.declare_roberta_sites,
        apply_quant_dict=R.apply_roberta_quant_dict,
        apply_peg=R.apply_peg_wiring,
        weight_site_tensors=R.roberta_weight_site_tensors,
        adaround_specs=R.roberta_adaround_specs,
        build_int_params=R.build_roberta_int_params,
        shared_perm_groups=B.shared_permutation_groups,
        load_checkpoint=_hf_loader("roberta"),
        build_engine=R.build_roberta_engine,
        engine_apply=R.roberta_engine_apply,
        config_presets={
            "roberta_base": {},
            "distilroberta_base": dict(num_hidden_layers=6),
        },
        tiny_preset=dict(_TINY, max_position_embeddings=130),
    )


def _mobilebert_family() -> ModelFamily:
    from transformer_quantization_tpu_torch.models import mobilebert as M

    return ModelFamily(
        name="mobilebert",
        config_cls=M.MobileBertConfig,
        init_params=M.init_mobilebert_params,
        init_head=_init_head(M.init_mobilebert_params),
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


def _distilbert_family() -> ModelFamily:
    from transformer_quantization_tpu_torch.models import bert as B
    from transformer_quantization_tpu_torch.models import distilbert as D

    return ModelFamily(
        name="distilbert",
        config_cls=D.DistilBertConfig,
        init_params=D.init_distilbert_params,
        init_head=_init_head(D.init_distilbert_params),
        head_key="classifier",
        apply=D.distilbert_apply,
        declare_sites=D.declare_distilbert_sites,
        apply_quant_dict=D.apply_distilbert_quant_dict,
        apply_peg=D.apply_peg_wiring,
        weight_site_tensors=D.distilbert_weight_site_tensors,
        adaround_specs=D.distilbert_adaround_specs,
        build_int_params=D.build_distilbert_int_params,
        build_engine=D.build_distilbert_engine,
        engine_apply=D.distilbert_engine_apply,
        shared_perm_groups=B.shared_permutation_groups,
        load_checkpoint=_hf_loader("distilbert"),
        config_presets={"distilbert_base_uncased": {}},
        tiny_preset=dict(_TINY),
    )


def _albert_family() -> ModelFamily:
    from transformer_quantization_tpu_torch.models import albert as A

    return ModelFamily(
        name="albert",
        config_cls=A.AlbertConfig,
        init_params=A.init_albert_params,
        init_head=_init_head(A.init_albert_params),
        head_key="classifier",
        apply=A.albert_apply,
        declare_sites=A.declare_albert_sites,
        apply_quant_dict=A.apply_albert_quant_dict,
        apply_peg=A.apply_peg_wiring,
        weight_site_tensors=A.albert_weight_site_tensors,
        adaround_specs=A.albert_adaround_specs,
        build_int_params=A.build_albert_int_params,
        build_engine=A.build_albert_engine,
        engine_apply=A.albert_engine_apply,
        shared_perm_groups=None,
        load_checkpoint=_hf_loader("albert"),
        config_presets={
            "albert_base_v2": {},
            "albert_large_v2": dict(hidden_size=1024, num_hidden_layers=24,
                                    num_attention_heads=16,
                                    intermediate_size=4096),
        },
        tiny_preset=dict(_TINY, embedding_size=16),
    )


def _squeezebert_family() -> ModelFamily:
    from transformer_quantization_tpu_torch.models import bert as B
    from transformer_quantization_tpu_torch.models import squeezebert as S

    return ModelFamily(
        name="squeezebert",
        config_cls=S.SqueezeBertConfig,
        init_params=S.init_squeezebert_params,
        init_head=_init_head(S.init_squeezebert_params),
        head_key="classifier",
        apply=S.squeezebert_apply,
        declare_sites=S.declare_squeezebert_sites,
        apply_quant_dict=B.apply_bert_quant_dict,
        apply_peg=B.apply_peg_wiring,
        weight_site_tensors=S.squeezebert_weight_site_tensors,
        adaround_specs=S.squeezebert_adaround_specs,
        build_int_params=S.build_squeezebert_int_params,
        build_engine=S.build_squeezebert_engine,
        engine_apply=S.squeezebert_engine_apply,
        shared_perm_groups=B.shared_permutation_groups,
        load_checkpoint=_hf_loader("squeezebert"),
        config_presets={"squeezebert_uncased": {}},
        tiny_preset=dict(_TINY),
    )


_FAMILIES = {
    "bert": _bert_family,
    "roberta": _roberta_family,
    "mobilebert": _mobilebert_family,
    "distilbert": _distilbert_family,
    "albert": _albert_family,
    "squeezebert": _squeezebert_family,
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
    its family, config and weights, and a local Hugging Face directory
    (``config.json`` and ``model.safetensors`` or ``pytorch_model.bin``)
    the named family's, through ``models/hf_loader.py``. Random init draws from the family's
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
        cfg, params = fam.load_checkpoint(model_path, num_labels, dev)
        return fam, cfg, params
    kw = dict(fam.config_presets.get(model_name, {}))
    if tiny:
        kw = dict(fam.tiny_preset)
    kw.update(overrides)
    kw["num_labels"] = num_labels
    cfg = fam.config_cls(**kw)
    return fam, cfg, fam.init_params(cfg, seed, dev)
