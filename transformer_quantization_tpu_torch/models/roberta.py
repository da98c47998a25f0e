"""Quantized RoBERTa for sequence classification.

Counterpart of ``transformer_quantization_tpu/models/roberta.py``: BERT's
embeddings and encoder with their site inventory, and these deltas:

- position ids come from the padding token: non-pad tokens are numbered
  from ``pad_token_id + 1``, pads stay at ``pad_token_id``
  (:func:`create_position_ids_from_input_ids`);
- no pooler: the head is HF's ``RobertaClassificationHead`` on ``<s>``,
  dense -> tanh -> out_proj, with the dense output site quantized before
  the tanh and the tanh output not re-quantized (:func:`_roberta_head`);
- no [0, 5] logits clamp for regression.

``distilroberta_base`` is the same family at 6 layers. Ported: the
forward :func:`roberta_apply` (FP32 baseline, estimate / fix phases, the
generic int8 path with ``fused_linear``, capture, and the training
forward with BERT's options), packing, the ``quant_dict`` language, PEG
wiring, AdaRound specs and the full-handoff engine
(:func:`build_roberta_engine`, :func:`roberta_engine_apply`).
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
class RobertaConfig(B.BertConfig):
    """HF ``RobertaConfig`` subset (roberta-base defaults)."""

    vocab_size: int = 50265
    max_position_embeddings: int = 514
    type_vocab_size: int = 1
    layer_norm_eps: float = 1e-5
    pad_token_id: int = 1


def create_position_ids_from_input_ids(input_ids: Tensor,
                                       padding_idx: int) -> Tensor:
    """Non-pad tokens numbered from ``padding_idx + 1``; pads stay at
    ``padding_idx`` (fairseq's ``make_positions``)."""
    mask = (input_ids != padding_idx).to(torch.int64)
    return torch.cumsum(mask, dim=1) * mask + padding_idx


def init_roberta_params(cfg: RobertaConfig, seed: int = 0,
                        device="cuda") -> Dict:
    """BERT's tree (:func:`~.bert.init_bert_params` from ``seed``) with the
    pooler replaced by the classification head, drawn from a generator
    seeded with ``seed + 1``."""
    dev = resolve_device(device)
    params = B.init_bert_params(cfg, seed, dev)
    del params["pooler"]
    gen = torch.Generator().manual_seed(seed + 1)
    std, h = cfg.initializer_range, cfg.hidden_size
    params["classifier"] = {
        "dense": B.linear_init(gen, h, h, std, dev),
        "out_proj": B.linear_init(gen, cfg.num_labels, h, std, dev),
    }
    return params


def declare_roberta_sites(defaults: QuantDefaults, cfg: RobertaConfig,
                          quant_setup: str = "all",
                          quant_dict: Optional[Mapping] = None
                          ) -> QuantModelConfig:
    """Site inventory: BERT embeddings + encoder, RoBERTa head."""
    quant_dict = quant_dict or {}
    b = QuantConfigBuilder(defaults)
    B.declare_embedding_sites(b, quant_dict)
    B.declare_encoder_sites(b, cfg.num_hidden_layers)
    b.weight("clf.dense.w")
    b.act("clf.dense.out")
    B.declare_classifier_site(b, "clf.out_proj", quant_setup)
    return b.build()


def apply_roberta_quant_dict(qcfg: QuantModelConfig, quant_dict: Mapping,
                             n_layers: int) -> QuantModelConfig:
    """BERT's key language with the head keys on the classification head:
    ``P`` the dense (+tanh) site, ``C`` the logits, ``wP`` / ``wC`` their
    weights."""
    ordered = B.encoder_quant_dict_entries(n_layers) + [
        ("P", ("clf.dense.out",)),
        ("C", ("clf.out_proj.out",)),
        ("wP", ("clf.dense.w",)),
        ("wC", ("clf.out_proj.w",)),
    ]
    return B._apply_ordered_quant_dict(qcfg, quant_dict, ordered)


def apply_peg_wiring(qcfg: QuantModelConfig, n_layers: int,
                     per_token: bool = False, per_embd: bool = False,
                     per_groups: Optional[int] = None,
                     permute: bool = False) -> QuantModelConfig:
    """BERT's PEG wiring with the head's dense site in the pooler's role."""
    return B.apply_peg_wiring(qcfg, n_layers, per_token=per_token,
                              per_embd=per_embd, per_groups=per_groups,
                              permute=permute, pooler_site="clf.dense.out")


def roberta_weight_site_tensors(params: Dict) -> Dict[str, Tensor]:
    out = B.encoder_weight_site_tensors(params)
    out["clf.dense.w"] = params["classifier"]["dense"]["kernel"]
    out["clf.out_proj.w"] = params["classifier"]["out_proj"]["kernel"]
    return out


def roberta_adaround_specs(params: Dict, cfg: RobertaConfig
                           ) -> List[Tuple[str, Dict]]:
    c = params["classifier"]
    return B.encoder_adaround_specs(params, cfg) + [
        ("clf.dense", {"kind": "linear", "w": c["dense"]["kernel"],
                       "b": c["dense"]["bias"], "act": None}),
        ("clf.out_proj", {"kind": "linear", "w": c["out_proj"]["kernel"],
                          "b": c["out_proj"]["bias"], "act": None}),
    ]


def build_roberta_int_params(params: Dict, qcfg: QuantModelConfig,
                             qstate: Mapping, use_int4: bool = False) -> Dict:
    with torch.no_grad():
        return B.pack_int_params(roberta_weight_site_tensors(params), qcfg,
                                 qstate, use_int4=use_int4)


def _inputs(batch: Mapping, cfg: RobertaConfig, dev):
    """(input_ids, token_type_ids, position_ids, mask_bias), the positions
    from the padding token unless the batch gives them."""
    input_ids, token_type_ids, position_ids, mask_bias = B.prepare_inputs(
        batch, dev)
    if batch.get("position_ids") is None:
        position_ids = create_position_ids_from_input_ids(input_ids,
                                                          cfg.pad_token_id)
    return input_ids, token_type_ids, position_ids, mask_bias


def roberta_apply(params: Dict, batch: Mapping, cfg: RobertaConfig,
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
    :func:`~.bert.bert_apply` (``qcfg=None`` the float model,
    ``int_params`` the generic int8 path, ``fused_linear`` its fused
    linear; the inference options ``compute_dtype`` / ``attention_dtype``
    / ``int8_attention``). ``params`` must live on ``device``.

    ``train=True`` is the training forward, as
    :func:`~.bert.bert_apply`'s: dropout from ``dropout_generator`` (the
    head's two around dense -> tanh too), the autograd graph,
    ``int8_qat_sites``, ``remat`` and ``compute_dtype`` (``--amp``);
    ``scan_layers`` runs the loop, which computes JAX's scan.
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
        input_ids, token_type_ids, position_ids, mask_bias = _inputs(
            batch, cfg, dev)
        mask_bias = B.compute_mask(mask_bias, compute_dtype)
        gen = dropout_generator if train else None
        h = B._embeddings(ctx, params, cfg, input_ids, token_type_ids,
                          position_ids, train, gen)
        h, h_site = B.run_encoder(ctx, params, cfg, h, mask_bias, train, gen,
                                  first_site="emb.ln.out", remat=remat)
        outputs = _roberta_head(ctx, params, cfg, h, h_site, batch, train,
                                gen)
        if capture_sites:
            outputs["captures"] = ctx.captures
    return outputs, ctx.export()


def _roberta_head(ctx, params, cfg: RobertaConfig, h, h_site, batch,
                  train=False, gen=None):
    """``RobertaClassificationHead``: ``<s>`` -> dropout -> dense -> tanh
    -> dropout -> out_proj. The dense output site quantizes before the
    tanh, whose output is not re-quantized; no logits clamp."""
    c = params["classifier"]
    x = dropout(h[:, 0], cfg.hidden_dropout_prob, gen, not train)
    x = quant_linear(ctx, "clf.dense", x, c["dense"]["kernel"],
                     c["dense"]["bias"], input_site=h_site)
    x = dropout(torch.tanh(x), cfg.hidden_dropout_prob, gen, not train)
    logits = quant_linear(ctx, "clf.out_proj", x, c["out_proj"]["kernel"],
                          c["out_proj"]["bias"])
    outputs = {"logits": logits, "sequence_output": h}
    labels = batch.get("labels")
    if labels is not None:
        labels = torch.as_tensor(labels).to(logits.device)
        outputs["loss"] = B.classification_loss(logits, labels,
                                                cfg.num_labels)
    return outputs


def build_roberta_engine(params: Dict, cfg: RobertaConfig,
                         qcfg: QuantModelConfig, qstate: Mapping,
                         int_params: Optional[Dict] = None,
                         use_int4: bool = False, device="cuda"):
    """The full-handoff engine plan (BERT's encoder sites, entry
    ``emb.ln.out``); returns ``(static, plan, int_params)``."""
    B._check_device(params, device)
    with torch.no_grad():
        if int_params is None:
            int_params = build_roberta_int_params(params, qcfg, qstate,
                                                  use_int4=use_int4)
        static, plan = ENG.build_encoder_plan(
            qcfg, qstate, int_params, params["layers"],
            n_heads=cfg.num_attention_heads, ln_eps=cfg.layer_norm_eps,
            hidden_act=cfg.hidden_act, entry_site="emb.ln.out")
    return static, plan, int_params


def roberta_engine_apply(params: Dict, batch: Mapping, cfg: RobertaConfig,
                         qcfg: QuantModelConfig, qstate: Mapping, static,
                         plan, int_params: Dict, *, backend: str = "kernels",
                         engine_dtype=torch.float32, gelu_impl: str = "tanh",
                         device="cuda") -> Dict:
    """Inference through the full-handoff int8 engine: embeddings and the
    head through the generic site machinery, the encoder on int8
    payloads; ``backend='plain'`` runs the layers' plain versions.
    ``engine_dtype`` / ``gelu_impl`` as :func:`~.bert.bert_engine_apply`'s."""
    dev = B._check_device(params, device)
    with torch.no_grad():
        ctx = B.make_ctx(qcfg, qstate, QuantMode(), int_params=int_params)
        input_ids, token_type_ids, position_ids, _ = _inputs(batch, cfg, dev)
        h = B._embeddings(ctx, params, cfg, input_ids, token_type_ids,
                          position_ids, False, None)
        h = ENG.encoder_engine(h, B.engine_bias(batch, input_ids, dev), static,
                               plan, backend=backend, out_dtype=engine_dtype,
                               gelu_impl=gelu_impl).to(B.exit_dtype(h))
        h_site = f"L{cfg.num_hidden_layers - 1}.ffn.ln.out"
        return _roberta_head(ctx, params, cfg, h, h_site, batch)
