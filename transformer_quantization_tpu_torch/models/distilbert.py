"""Quantized DistilBERT for sequence classification.

Counterpart of ``transformer_quantization_tpu/models/distilbert.py``
(HF ``DistilBertForSequenceClassification``): BERT's embeddings without
token types (a zero table behind a disabled site, so BERT's embedding
code runs as it is), 6 post-LN encoder layers of BERT's shape, no pooler,
and the head ``pre_classifier`` (dense + relu) -> classifier.

Ported: the forward :func:`distilbert_apply` (FP32 baseline, estimate /
fix phases, the generic int8 path with ``fused_linear``, capture, and
the training forward with BERT's options), packing, the ``quant_dict``
language, PEG wiring, AdaRound specs and the full-handoff engine
(:func:`build_distilbert_engine`, :func:`distilbert_engine_apply`).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

import torch

from transformer_quantization_tpu_torch import resolve_device
from transformer_quantization_tpu_torch.models import bert as B
from transformer_quantization_tpu_torch.ops import engine as ENG
from transformer_quantization_tpu_torch.ops.layers import dropout, quant_linear
from transformer_quantization_tpu_torch.quant.qconfig import (
    QuantConfigBuilder,
    QuantDefaults,
    QuantModelConfig,
    QuantMode,
)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class DistilBertConfig(B.BertConfig):
    num_hidden_layers: int = 6
    type_vocab_size: int = 1  # zero table, site disabled


def init_distilbert_params(cfg: DistilBertConfig, seed: int = 0,
                           device="cuda") -> Dict:
    """BERT's tree from ``seed`` with a zero token-type table, no pooler,
    and the ``pre`` / ``out`` head drawn from a generator seeded with
    ``seed + 1``."""
    dev = resolve_device(device)
    params = B.init_bert_params(cfg, seed, dev)
    params["embeddings"]["token_type"] = torch.zeros(
        (cfg.type_vocab_size, cfg.hidden_size), device=dev)
    del params["pooler"]
    gen = torch.Generator().manual_seed(seed + 1)
    std, h = cfg.initializer_range, cfg.hidden_size
    params["classifier"] = {
        "pre": B.linear_init(gen, h, h, std, dev),
        "out": B.linear_init(gen, cfg.num_labels, h, std, dev),
    }
    return params


def declare_distilbert_sites(defaults: QuantDefaults, cfg: DistilBertConfig,
                             quant_setup: str = "all",
                             quant_dict: Optional[Mapping] = None
                             ) -> QuantModelConfig:
    quant_dict = quant_dict or {}
    b = QuantConfigBuilder(defaults)
    B.declare_embedding_sites(b, quant_dict)
    B.declare_encoder_sites(b, cfg.num_hidden_layers)
    b.weight("clf.pre.w")
    b.act("clf.pre.out")
    B.declare_classifier_site(b, "clf.out", quant_setup)
    # the token-type table is a zero placeholder: never quantized
    return b.build().replace_site("emb.token_type.w", enabled=False)


def apply_distilbert_quant_dict(qcfg: QuantModelConfig, quant_dict: Mapping,
                                n_layers: int) -> QuantModelConfig:
    """BERT's key language with the head keys on pre_classifier /
    classifier."""
    ordered = B.encoder_quant_dict_entries(n_layers) + [
        ("P", ("clf.pre.out",)),
        ("C", ("clf.out.out",)),
        ("wP", ("clf.pre.w",)),
        ("wC", ("clf.out.w",)),
    ]
    return B._apply_ordered_quant_dict(qcfg, quant_dict, ordered)


def apply_peg_wiring(qcfg: QuantModelConfig, n_layers: int,
                     per_token: bool = False, per_embd: bool = False,
                     per_groups: Optional[int] = None,
                     permute: bool = False) -> QuantModelConfig:
    return B.apply_peg_wiring(qcfg, n_layers, per_token=per_token,
                              per_embd=per_embd, per_groups=per_groups,
                              permute=permute, pooler_site="clf.pre.out")


def distilbert_weight_site_tensors(params: Dict) -> Dict[str, Tensor]:
    out = B.encoder_weight_site_tensors(params)
    del out["emb.token_type.w"]
    out["clf.pre.w"] = params["classifier"]["pre"]["kernel"]
    out["clf.out.w"] = params["classifier"]["out"]["kernel"]
    return out


def distilbert_adaround_specs(params: Dict, cfg: DistilBertConfig
                              ) -> List[Tuple[str, Dict]]:
    c = params["classifier"]
    return [s for s in B.encoder_adaround_specs(params, cfg)
            if s[0] != "emb.token_type"] + [
        ("clf.pre", {"kind": "linear", "w": c["pre"]["kernel"],
                     "b": c["pre"]["bias"], "act": "relu"}),
        ("clf.out", {"kind": "linear", "w": c["out"]["kernel"],
                     "b": c["out"]["bias"], "act": None}),
    ]


def build_distilbert_int_params(params: Dict, qcfg: QuantModelConfig,
                                qstate: Mapping,
                                use_int4: bool = False) -> Dict:
    with torch.no_grad():
        return B.pack_int_params(distilbert_weight_site_tensors(params),
                                 qcfg, qstate, use_int4=use_int4)


def _inputs(batch: Mapping, dev):
    """(input_ids, token types (zeros, whatever the batch holds),
    position_ids, mask_bias)."""
    input_ids, _, position_ids, mask_bias = B.prepare_inputs(batch, dev)
    return input_ids, torch.zeros_like(input_ids), position_ids, mask_bias


def _head(ctx, params, cfg: DistilBertConfig, h, h_site, batch,
          train=False, gen=None):
    """pre_classifier (dense + relu) on the first token -> dropout ->
    classifier."""
    c = params["classifier"]
    x = quant_linear(ctx, "clf.pre", h[:, 0], c["pre"]["kernel"],
                     c["pre"]["bias"], activation="relu", input_site=h_site)
    x = dropout(x, cfg.hidden_dropout_prob, gen, not train)
    logits = quant_linear(ctx, "clf.out", x, c["out"]["kernel"],
                          c["out"]["bias"], input_site="clf.pre.out")
    outputs = {"logits": logits, "sequence_output": h}
    labels = batch.get("labels")
    if labels is not None:
        labels = torch.as_tensor(labels).to(logits.device)
        outputs["loss"] = B.classification_loss(logits, labels,
                                                cfg.num_labels)
    return outputs


def distilbert_apply(params: Dict, batch: Mapping, cfg: DistilBertConfig,
                     qcfg: Optional[QuantModelConfig] = None,
                     qstate: Optional[Dict] = None,
                     mode: Optional[QuantMode] = None, *, train: bool = False,
                     dropout_generator: Optional[torch.Generator] = None,
                     mse_session: Optional[Dict] = None,
                     int_params: Optional[Dict] = None, fused_linear=False,
                     int8_qat_sites=None,
                     capture_sites=None, capture_pre_act: bool = False,
                     compute_dtype=None, attention_dtype=None,
                     int8_attention: bool = False,
                     remat: bool = False, scan_layers: bool = False,
                     device="cuda") -> Tuple[Dict, Dict]:
    """Forward pass; returns ``(outputs, new_qstate)``, as
    :func:`~.bert.bert_apply` (its inference options and its training
    forward too: dropout from ``dropout_generator``, the head's after
    pre_classifier included, ``int8_qat_sites``, ``remat``,
    ``compute_dtype``; ``scan_layers`` runs the loop). ``params`` must
    live on ``device``.
    """
    del scan_layers  # the loop computes JAX's scan (bert_apply's note)
    dev = B._check_device(params, device)
    with contextlib.nullcontext() if train else torch.no_grad():
        ctx = B.family_ctx(qcfg, qstate, mode, cfg, train=train,
                           int_params=int_params, fused_linear=fused_linear,
                           int8_qat_sites=int8_qat_sites,
                           mse_session=mse_session,
                           capture_sites=capture_sites,
                           capture_pre_act=capture_pre_act,
                           compute_dtype=compute_dtype,
                           attention_dtype=attention_dtype,
                           int8_attention=int8_attention)
        input_ids, token_type_ids, position_ids, mask_bias = _inputs(batch,
                                                                     dev)
        mask_bias = B.compute_mask(mask_bias, compute_dtype)
        gen = dropout_generator if train else None
        h = B._embeddings(ctx, params, cfg, input_ids, token_type_ids,
                          position_ids, train, gen)
        h, h_site = B.run_encoder(ctx, params, cfg, h, mask_bias, train, gen,
                                  first_site="emb.ln.out", remat=remat)
        outputs = _head(ctx, params, cfg, h, h_site, batch, train, gen)
        if capture_sites:
            outputs["captures"] = ctx.captures
    return outputs, ctx.export()


def build_distilbert_engine(params: Dict, cfg: DistilBertConfig,
                            qcfg: QuantModelConfig, qstate: Mapping,
                            int_params: Optional[Dict] = None,
                            use_int4: bool = False, device="cuda"):
    """The full-handoff engine plan: the standard ``L{i}.`` encoder, entry
    ``emb.ln.out``; returns ``(static, plan, int_params)``."""
    B._check_device(params, device)
    with torch.no_grad():
        if int_params is None:
            int_params = build_distilbert_int_params(params, qcfg, qstate,
                                                     use_int4=use_int4)
        static, plan = ENG.build_encoder_plan(
            qcfg, qstate, int_params, params["layers"],
            n_heads=cfg.num_attention_heads, ln_eps=cfg.layer_norm_eps,
            hidden_act=cfg.hidden_act, entry_site="emb.ln.out")
    return static, plan, int_params


def distilbert_engine_apply(params: Dict, batch: Mapping,
                            cfg: DistilBertConfig, qcfg: QuantModelConfig,
                            qstate: Mapping, static, plan, int_params: Dict,
                            *, backend: str = "kernels",
                            engine_dtype=torch.float32,
                            gelu_impl: str = "tanh",
                            device="cuda") -> Dict:
    """Inference through the full-handoff int8 engine (embeddings and head
    through the generic site machinery); ``backend='plain'`` runs the
    layers' plain versions. ``engine_dtype`` / ``gelu_impl`` as
    :func:`~.bert.bert_engine_apply`'s."""
    dev = B._check_device(params, device)
    with torch.no_grad():
        ctx = B.make_ctx(qcfg, qstate, QuantMode(), int_params=int_params)
        input_ids, token_type_ids, position_ids, _ = _inputs(batch, dev)
        h = B._embeddings(ctx, params, cfg, input_ids, token_type_ids,
                          position_ids, False, None)
        h = ENG.encoder_engine(h, B.engine_bias(batch, input_ids, dev),
                               static, plan, backend=backend,
                               out_dtype=engine_dtype,
                               gelu_impl=gelu_impl).to(B.exit_dtype(h))
        h_site = f"L{cfg.num_hidden_layers - 1}.ffn.ln.out"
        return _head(ctx, params, cfg, h, h_site, batch)
