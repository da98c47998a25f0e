"""Quantized SqueezeBERT for sequence classification.

Counterpart of ``transformer_quantization_tpu/models/squeezebert.py``
(HF ``SqueezeBertForSequenceClassification``): BERT's embeddings and
encoder shape, whose denses are kernel-size-1 grouped Conv1ds, i.e.
block-diagonal linears. Kernel-size-1 convs do not depend on the layout,
so the layers stay in (B, T, C) and run on the grouped linear
(:func:`~..ops.layers.quant_grouped_linear`; kernels stored ``(out,
in/groups)``); group counts follow the HF config (q / k / v and the FFN
grouped, 4 by default; the post-attention conv 1), and the pooler and
classifier are plain denses. The site names are BERT's.

Ported: the forward :func:`squeezebert_apply` (FP32 baseline, estimate /
fix phases, the generic int8 path: the grouped products exact in
integers, one-group layers on the fused linear with ``fused_linear``;
capture; the training forward with BERT's options), packing, AdaRound
specs (grouped layers carry their group count), and the full-handoff
engine: the grouped kernels densified to block-diagonal weights, whose
off-block zeros quantize to exactly 0 (:func:`_densify_for_engine`), on
BERT's engine plan.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Dict, List, Mapping, Optional, Tuple

import torch

from transformer_quantization_tpu_torch import resolve_device
from transformer_quantization_tpu_torch.models import bert as B
from transformer_quantization_tpu_torch.ops.layers import (
    quant_grouped_linear,
)
from transformer_quantization_tpu_torch.quant.qconfig import (
    QuantConfigBuilder,
    QuantDefaults,
    QuantModelConfig,
    QuantMode,
)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class SqueezeBertConfig(B.BertConfig):
    q_groups: int = 4
    k_groups: int = 4
    v_groups: int = 4
    post_attention_groups: int = 1
    intermediate_groups: int = 4
    output_groups: int = 4


def _group_counts(cfg: SqueezeBertConfig) -> Dict[str, int]:
    """Each grouped layer's group count, by its site suffix."""
    return {
        "attn.q": cfg.q_groups, "attn.k": cfg.k_groups,
        "attn.v": cfg.v_groups,
        "attn_out.dense": cfg.post_attention_groups,
        "ffn.inter": cfg.intermediate_groups,
        "ffn.dense": cfg.output_groups,
    }


def init_squeezebert_params(cfg: SqueezeBertConfig, seed: int = 0,
                            device="cuda") -> Dict:
    """BERT's embeddings, pooler and classifier from ``seed``; the grouped
    ``(out, in/groups)`` layer kernels (zero biases, unit LayerNorms) from
    a generator seeded with ``seed + 1``."""
    dev = resolve_device(device)
    base = B.init_bert_params(dataclasses.replace(cfg, num_hidden_layers=0),
                              seed, dev)
    gen = torch.Generator().manual_seed(seed + 1)
    std, h, m = cfg.initializer_range, cfg.hidden_size, cfg.intermediate_size
    g = _group_counts(cfg)

    def grouped(n_out, n_in, groups):
        return B.linear_init(gen, n_out, n_in // groups, std, dev)

    def ln():
        return {"scale": torch.ones((h,), device=dev),
                "bias": torch.zeros((h,), device=dev)}

    layers = [{
        "attn": {x: grouped(h, h, g[f"attn.{x}"]) for x in "qkv"},
        "attn_out": {"dense": grouped(h, h, g["attn_out.dense"]),
                     "ln": ln()},
        "ffn": {"inter": grouped(m, h, g["ffn.inter"]),
                "dense": grouped(h, m, g["ffn.dense"]), "ln": ln()},
    } for _ in range(cfg.num_hidden_layers)]
    return dict(base, layers=layers)


def declare_squeezebert_sites(defaults: QuantDefaults,
                              cfg: SqueezeBertConfig,
                              quant_setup: str = "all",
                              quant_dict: Optional[Mapping] = None
                              ) -> QuantModelConfig:
    quant_dict = quant_dict or {}
    b = QuantConfigBuilder(defaults)
    B.declare_embedding_sites(b, quant_dict)
    B.declare_encoder_sites(b, cfg.num_hidden_layers)
    b.weight("pooler.dense.w")
    b.act("pooler.dense.out")
    B.declare_classifier_site(b, "classifier", quant_setup)
    return b.build()


def squeezebert_weight_site_tensors(params: Dict) -> Dict[str, Tensor]:
    """BERT's site names; the layer tensors are the grouped kernels."""
    return B.bert_weight_site_tensors(params)


def squeezebert_adaround_specs(params: Dict, cfg: SqueezeBertConfig
                               ) -> List[Tuple[str, Dict]]:
    """BERT's specs, the grouped layers as ``grouped_linear`` with their
    group count for the local re-apply."""
    group_of = _group_counts(cfg)
    out = []
    for name, spec in B.encoder_adaround_specs(params, cfg):
        suffix = name.split(".", 1)[-1] if name.startswith("L") else name
        g = group_of.get(suffix)
        if g and g > 1 and spec["kind"] == "linear":
            spec = dict(spec, kind="grouped_linear", groups=g)
        out.append((name, spec))
    return out + [
        ("pooler.dense", {"kind": "linear", "w": params["pooler"]["kernel"],
                          "b": params["pooler"]["bias"], "act": "tanh"}),
        ("classifier", {"kind": "linear", "w": params["classifier"]["kernel"],
                        "b": params["classifier"]["bias"], "act": None}),
    ]


def build_squeezebert_int_params(params: Dict, qcfg: QuantModelConfig,
                                 qstate: Mapping,
                                 use_int4: bool = False) -> Dict:
    """Every weight site packs, the grouped ``(O, I/groups)`` kernels too:
    each output row contracts only its own group's inputs, so the packer's
    per-row ``colsum`` is already the exact correction for
    :func:`~..ops.int_linear.int8_grouped_linear`."""
    return B.build_bert_int_params(params, qcfg, qstate, use_int4=use_int4)


def _grouped_linear(groups: Dict[str, int], ctx, name: str, x, w, b,
                    activation=None, input_site=None):
    """:func:`~..ops.layers.quant_grouped_linear` with the group count of
    site ``name`` (``L{i}.<suffix>``)."""
    return quant_grouped_linear(ctx, name, x, w, b,
                                groups[name.split(".", 1)[1]],
                                activation=activation, input_site=input_site)


def squeezebert_apply(params: Dict, batch: Mapping, cfg: SqueezeBertConfig,
                      qcfg: Optional[QuantModelConfig] = None,
                      qstate: Optional[Dict] = None,
                      mode: Optional[QuantMode] = None, *,
                      train: bool = False,
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
    forward too: dropout from ``dropout_generator`` at the JAX
    ``_sq_layer``'s three places a layer, ``int8_qat_sites``, ``remat``,
    ``compute_dtype``; ``scan_layers`` runs the loop), with the encoder's
    matmuls grouped. The grouped layers train through
    :func:`~..ops.layers.quant_grouped_linear`'s fake-quant STE; as in JAX,
    the int8 QAT matmul takes only the one-group layers (the attention
    output, the pooler and the classifier). ``params`` must live on
    ``device``.
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
        input_ids, token_type_ids, position_ids, mask_bias = B.prepare_inputs(
            batch, dev)
        mask_bias = B.compute_mask(mask_bias, compute_dtype)
        gen = dropout_generator if train else None
        h = B._embeddings(ctx, params, cfg, input_ids, token_type_ids,
                          position_ids, train, gen)
        h, h_site = B.run_encoder(
            ctx, params, cfg, h, mask_bias, train, gen,
            first_site="emb.ln.out",
            linear=functools.partial(_grouped_linear, _group_counts(cfg)),
            remat=remat)
        outputs = B._classification_head(ctx, params, cfg, h, h_site, batch,
                                         train, gen, clamp=False)
        if capture_sites:
            outputs["captures"] = ctx.captures
    return outputs, ctx.export()


def _block_diag_kernel(kernel: Tensor, groups: int,
                       fill: float = 0.0) -> Tensor:
    """A grouped ``(O, I/g)`` kernel as the equivalent block-diagonal dense
    ``(O, I)`` kernel; ``fill`` sets the off-block entries (0 for weights,
    -1 for AdaRound alphas, so that the hard rounding ``floor(0 / s) +
    (alpha >= 0)`` keeps them 0)."""
    out_f, ig = kernel.shape
    og = out_f // groups
    dense = torch.full((out_f, ig * groups), fill, dtype=kernel.dtype,
                       device=kernel.device)
    for j in range(groups):
        dense[j * og:(j + 1) * og, j * ig:(j + 1) * ig] = \
            kernel[j * og:(j + 1) * og]
    return dense


def _densify_for_engine(params: Dict, cfg: SqueezeBertConfig,
                        qstate: Mapping) -> Tuple[Dict, Dict]:
    """The block-diagonal dense view of the grouped encoder, and a qstate
    with AdaRound alphas densified with a round-down fill.

    Exact: weight packing is symmetric (``int_linear.can_pack_weight``),
    so 0 sits on every weight grid and ``round(0 / s) == 0``; the
    off-block zeros pack to int8 zeros, and the dense int8 product equals
    the grouped one. Through the int8 matmul kernel they cost ``groups``
    times the grouped products' operations."""
    group_of = _group_counts(cfg)
    qstate2 = dict(qstate)
    layers = []
    for i, layer in enumerate(params["layers"]):
        nl = {
            "attn": {x: dict(layer["attn"][x]) for x in "qkv"},
            "attn_out": {"dense": dict(layer["attn_out"]["dense"]),
                         "ln": layer["attn_out"]["ln"]},
            "ffn": {"inter": dict(layer["ffn"]["inter"]),
                    "dense": dict(layer["ffn"]["dense"]),
                    "ln": layer["ffn"]["ln"]},
        }
        for suffix, g in group_of.items():
            if g <= 1:
                continue
            top, leaf = suffix.split(".")
            slot = nl[top][leaf]
            slot["kernel"] = _block_diag_kernel(slot["kernel"], g)
            wsite = f"L{i}.{suffix}.w"
            entry = qstate.get(wsite)
            if entry is not None and entry.get("alpha") is not None:
                qstate2[wsite] = dict(entry, alpha=_block_diag_kernel(
                    entry["alpha"], g, fill=-1.0))
        layers.append(nl)
    return dict(params, layers=layers), qstate2


def build_squeezebert_engine(params: Dict, cfg: SqueezeBertConfig,
                             qcfg: QuantModelConfig, qstate: Mapping,
                             int_params: Optional[Dict] = None,
                             use_int4: bool = False, device="cuda"):
    """The full-handoff engine plan: the grouped kernels densified
    (:func:`_densify_for_engine`), packed and planned as BERT's encoder.
    Returns ``(static, plan, int_params)``, ``int_params`` the generic
    path's packing of the grouped params (the embeddings and head, which
    the engine's forward reads, pack the same in both)."""
    B._check_device(params, device)
    with torch.no_grad():
        dense, qstate2 = _densify_for_engine(params, cfg, qstate)
        static, plan, _ = B.build_bert_engine(dense, cfg, qcfg, qstate2,
                                              use_int4=use_int4,
                                              device=device)
        if int_params is None:
            int_params = build_squeezebert_int_params(params, qcfg, qstate,
                                                      use_int4=use_int4)
    return static, plan, int_params


def squeezebert_engine_apply(params: Dict, batch: Mapping,
                             cfg: SqueezeBertConfig, qcfg: QuantModelConfig,
                             qstate: Mapping, static, plan, int_params: Dict,
                             *, backend: str = "kernels",
                             engine_dtype=torch.float32,
                             gelu_impl: str = "tanh",
                             device="cuda") -> Dict:
    """BERT's engine forward: embeddings and head through the generic site
    machinery, the encoder on int8 payloads (the plan holds the densified
    weights); as in the JAX package, its head clamps regression logits
    where :func:`squeezebert_apply`'s does not."""
    return B.bert_engine_apply(params, batch, cfg, qcfg, qstate, static,
                               plan, int_params, backend=backend,
                               engine_dtype=engine_dtype,
                               gelu_impl=gelu_impl, device=device)
