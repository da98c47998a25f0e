"""Quantized BERT for sequence classification.

Counterpart of ``transformer_quantization_tpu/models/bert.py``: a plain
function over a parameter dict plus threaded quantization state, with
the site inventory of the reference's QuantizedBert (two-stage embedding
sums, scores quantized before 1/sqrt(d), probs after softmax, residual
sums before each LayerNorm, fused GELU / Tanh). Parameters keep the JAX
nesting and its ``(out, in)`` kernel layout, so ``convert.py`` carries
JAX weights across unchanged.

Ported: the fake-quant forward :func:`bert_apply` (also the FP baseline
with ``qcfg=None``), the generic int8 path (``int_params``) with its fused
linear (``fused_linear``, the JAX ``use_pallas``), packing, the
``quant_dict`` key language (:func:`apply_bert_quant_dict`) with the PEG
shared-permutation groups, the ``--per-token`` / ``--per-embd`` /
``--per-groups`` wiring (:func:`apply_peg_wiring`), and the full-handoff
engine (:func:`build_bert_engine` / :func:`bert_engine_apply`), and the
training forward (``bert_apply(train=True)``: an autograd graph through
the fake-quant sites' STE / LSQ backward, dropout from a
``torch.Generator``, the int8 QAT matmul at ``int8_qat_sites``), and
AdaRound: the layer specs (:func:`bert_adaround_specs`), layer I/O
capture (``bert_apply(capture_sites=...)``) and the packing of alphas.
The training options ``compute_dtype`` (``--amp``), ``remat`` and
``scan_layers`` (:func:`bert_apply`); the pipeline waits. The
BERT-shaped families (RoBERTa, DistilBERT, ALBERT, SqueezeBERT) build on
its embeddings, encoder, training forward, packing and engine entry
(:func:`family_ctx`,
:func:`engine_bias`, :func:`encoder_weight_site_tensors`).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

import torch

from transformer_quantization_tpu_torch import resolve_device
from transformer_quantization_tpu_torch.ops import engine as ENG
from transformer_quantization_tpu_torch.ops import int_linear as IL
from transformer_quantization_tpu_torch.ops.layers import (
    dropout,
    float_matmul,
    quant_embedding,
    quant_layernorm,
    quant_linear,
    wide_matmul_precision,
)
from transformer_quantization_tpu_torch.quant.manager import QuantCtx
from transformer_quantization_tpu_torch.quant.qconfig import (
    Phase,
    QuantConfigBuilder,
    QuantDefaults,
    QuantModelConfig,
    QuantMode,
    apply_quant_value,
)
from transformer_quantization_tpu_torch.quant.ranges import (
    OptMethod,
    RangeMethod,
)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class BertConfig:
    """Model hyperparameters (HF ``BertConfig`` subset)."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    layer_norm_eps: float = 1e-12
    num_labels: int = 2
    initializer_range: float = 0.02
    hidden_act: str = "gelu"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def init_bert_params(cfg: BertConfig, seed: int = 0,
                     device="cuda") -> Dict:
    """Random initialization, normal(0, initializer_range) kernels and
    tables, zero biases, unit LayerNorm gammas; kernels stored ``(out,
    in)``. Drawn from a ``torch.Generator`` seeded with ``seed`` (on the
    CPU, so a seed gives the same weights on every device)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    std = cfg.initializer_range

    def normal(*shape):
        return (std * torch.randn(shape, generator=gen)).to(dev)

    def linear(n_out, n_in):
        return {"kernel": normal(n_out, n_in),
                "bias": torch.zeros((n_out,), device=dev)}

    def ln(dim):
        return {"scale": torch.ones((dim,), device=dev),
                "bias": torch.zeros((dim,), device=dev)}

    h, m = cfg.hidden_size, cfg.intermediate_size
    params = {
        "embeddings": {
            "word": normal(cfg.vocab_size, h),
            "position": normal(cfg.max_position_embeddings, h),
            "token_type": normal(cfg.type_vocab_size, h),
            "ln": ln(h),
        },
        "layers": [],
        "pooler": linear(h, h),
        "classifier": linear(cfg.num_labels, h),
    }
    for _ in range(cfg.num_hidden_layers):
        params["layers"].append({
            "attn": {"q": linear(h, h), "k": linear(h, h), "v": linear(h, h)},
            "attn_out": {"dense": linear(h, h), "ln": ln(h)},
            "ffn": {"inter": linear(m, h), "dense": linear(h, m), "ln": ln(h)},
        })
    return params


def linear_init(gen: torch.Generator, n_out: int, n_in: int, std: float,
                dev) -> Dict:
    """normal(0, std) ``(out, in)`` kernel drawn from ``gen`` (on the CPU),
    zero bias, on ``dev``."""
    return {"kernel": (std * torch.randn((n_out, n_in), generator=gen)
                       ).to(dev),
            "bias": torch.zeros((n_out,), device=dev)}


def params_to(params, dtype=None, device=None):
    """A copy of a (nested) parameter dict with every tensor moved/cast."""
    if isinstance(params, dict):
        return {k: params_to(v, dtype, device) for k, v in params.items()}
    if isinstance(params, list):
        return [params_to(v, dtype, device) for v in params]
    return params.to(device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# Quant site inventory
# ---------------------------------------------------------------------------


def declare_bert_sites(defaults: QuantDefaults, cfg: BertConfig,
                       quant_setup: str = "all",
                       quant_dict: Optional[Mapping] = None) -> QuantModelConfig:
    """Declare every weight/activation quantizer of QuantizedBert.
    ``quant_setup``: 'all' | 'FP_logits' | 'MSE_logits'."""
    quant_dict = quant_dict or {}
    b = QuantConfigBuilder(defaults)
    declare_embedding_sites(b, quant_dict)
    declare_encoder_sites(b, cfg.num_hidden_layers)
    b.weight("pooler.dense.w")
    b.act("pooler.dense.out")
    declare_classifier_site(b, "classifier", quant_setup)
    return b.build()


def declare_embedding_sites(b: QuantConfigBuilder, quant_dict: Mapping) -> None:
    """BERT embedding sites (``Et`` switches the word table to MSE)."""
    et_over = ({"range_method": RangeMethod.MSE,
                "opt_method": OptMethod.golden_section}
               if "Et" in quant_dict else {})
    b.weight("emb.word.w", **et_over)
    b.weight("emb.position.w")
    b.weight("emb.token_type.w")
    b.act("emb.sum_tt")
    b.act("emb.sum_pos")
    b.weight("emb.ln.w")
    b.act("emb.ln.out")


def declare_encoder_sites(b: QuantConfigBuilder, n_layers: int) -> None:
    """Per-layer encoder sites."""
    for i in range(n_layers):
        p = f"L{i}."
        for lin in ("attn.q", "attn.k", "attn.v"):
            b.weight(p + lin + ".w")
            b.act(p + lin + ".out")
        b.act(p + "attn.scores")
        b.act(p + "attn.probs")
        b.act(p + "attn.context")
        b.weight(p + "attn_out.dense.w")
        b.act(p + "attn_out.dense.out")
        b.act(p + "attn_out.res")
        b.weight(p + "attn_out.ln.w")
        b.act(p + "attn_out.ln.out")
        b.weight(p + "ffn.inter.w")
        b.act(p + "ffn.inter.out")
        b.weight(p + "ffn.dense.w")
        b.act(p + "ffn.dense.out")
        b.act(p + "ffn.res")
        b.weight(p + "ffn.ln.w")
        b.act(p + "ffn.ln.out")


def declare_classifier_site(b: QuantConfigBuilder, name: str,
                            quant_setup: str) -> None:
    """Logits-layer ``quant_setup`` handling."""
    b.weight(f"{name}.w")
    if quant_setup == "MSE_logits":
        b.act(f"{name}.out", range_method=RangeMethod.MSE,
              opt_method=OptMethod.golden_section)
    elif quant_setup == "FP_logits":
        b.act(f"{name}.out", enabled=False)
    elif quant_setup == "all":
        b.act(f"{name}.out")
    else:
        raise ValueError(f"Quantization setup '{quant_setup}' not supported.")


def _layer_act_sites(i: int) -> Tuple[str, ...]:
    """All activation sites inside encoder layer ``i`` (for 'L' keys)."""
    p = f"L{i}."
    return tuple(p + s for s in (
        "attn.q.out", "attn.k.out", "attn.v.out", "attn.scores", "attn.probs",
        "attn.context", "attn_out.dense.out", "attn_out.res",
        "attn_out.ln.out", "ffn.inter.out", "ffn.dense.out", "ffn.res",
        "ffn.ln.out"))


LETTER_SITE = {
    "s": "attn.scores", "p": "attn.probs", "c": "attn.context",
    "g": "attn_out.dense.out", "u": "attn_out.res", "x": "attn_out.ln.out",
    "h": "ffn.dense.out", "y": "ffn.res", "z": "ffn.ln.out",
}


def encoder_quant_dict_entries(n_layers: int
                               ) -> List[Tuple[str, Tuple[str, ...]]]:
    """Embedding + per-layer quant_dict key entries in the reference's
    hijack order: per layer, each letter's per-layer key before its global
    one, then ``L{i}`` before ``L``."""
    ordered: List[Tuple[str, Tuple[str, ...]]] = [
        ("e", ("emb.sum_tt", "emb.sum_pos")),
        ("Et", ("emb.word.w",)),
    ]
    for i in range(n_layers):
        for letter, site in LETTER_SITE.items():
            ordered.append((f"{letter}{i}", (f"L{i}.{site}",)))
            ordered.append((letter, (f"L{i}.{site}",)))
        ordered.append((f"L{i}", _layer_act_sites(i)))
        ordered.append(("L", _layer_act_sites(i)))
    return ordered


def _apply_ordered_quant_dict(qcfg: QuantModelConfig, quant_dict: Mapping,
                              ordered) -> QuantModelConfig:
    unknown = set(quant_dict) - {k for k, _ in ordered}
    if unknown:
        raise KeyError(f"unknown quant_dict keys: {sorted(unknown)}")
    for key, sites in ordered:
        if key in quant_dict:
            for site in sites:
                qcfg = apply_quant_value(qcfg, site, quant_dict[key])
    return qcfg


def apply_bert_quant_dict(qcfg: QuantModelConfig, quant_dict: Mapping,
                          n_layers: int) -> QuantModelConfig:
    """Apply the BERT ``quant_dict`` key language: embeddings, then per
    layer the letters of :data:`LETTER_SITE` and ``L``, then the head keys
    ``P``, ``C``, ``wP``, ``wC``; a global key applied after a per-layer
    one overrides it, as in the reference."""
    ordered = encoder_quant_dict_entries(n_layers) + [
        ("P", ("pooler.dense.out",)),
        ("C", ("classifier.out",)),
        ("wP", ("pooler.dense.w",)),
        ("wC", ("classifier.w",)),
    ]
    return _apply_ordered_quant_dict(qcfg, quant_dict, ordered)


def apply_peg_wiring(qcfg: QuantModelConfig, n_layers: int,
                     per_token: bool = False, per_embd: bool = False,
                     per_groups: Optional[int] = None,
                     permute: bool = False,
                     pooler_site: str = "pooler.dense.out"
                     ) -> QuantModelConfig:
    """Per-token / per-embedding / per-group activation quantization
    wiring (the CLI's ``--per-token`` / ``--per-embd`` / ``--per-groups``):
    ``axis=2`` for per-embedding / per-group on (B, T, d) sites, ``axis=1``
    for per-token; applied to the embedding sums + LayerNorm and, per
    layer, to the q/k/v outputs, context, self-output dense / residual /
    LN and FFN-output dense / residual / LN. The pooler (B, d) gets
    ``axis=1`` only in per-embedding mode."""
    base_axis = 2 if (per_embd or per_groups) else 1
    if not (per_token or per_embd or per_groups):
        return qcfg
    changes = {"axis": base_axis, "n_groups": per_groups, "permute": permute}
    sites = ["emb.sum_tt", "emb.sum_pos", "emb.ln.out"]
    for i in range(n_layers):
        p = f"L{i}."
        sites += [p + s for s in (
            "attn.q.out", "attn.k.out", "attn.v.out", "attn.context",
            "attn_out.dense.out", "attn_out.res", "attn_out.ln.out",
            "ffn.dense.out", "ffn.res", "ffn.ln.out")]
    qcfg = qcfg.replace_sites({s: dict(changes) for s in sites})
    if per_embd and pooler_site in qcfg:
        qcfg = qcfg.replace_site(pooler_site, axis=1,
                                 n_groups=per_groups, permute=permute)
    return qcfg


def shared_permutation_groups(n_layers: int
                              ) -> List[Tuple[str, Tuple[str, ...]]]:
    """(source, targets) per layer for ``--per-groups-permute-shared-h``:
    every permuted site of a layer takes the FFN-output dense site's
    recorded ranges."""
    out = []
    for i in range(n_layers):
        p = f"L{i}."
        targets = tuple(p + s for s in (
            "attn.q.out", "attn.k.out", "attn.v.out", "attn.context",
            "attn_out.dense.out", "attn_out.res", "attn_out.ln.out",
            "ffn.dense.out", "ffn.res", "ffn.ln.out"))
        out.append((p + "ffn.dense.out", targets))
    return out


# ---------------------------------------------------------------------------
# Int packing
# ---------------------------------------------------------------------------

# gather-consumed tables, packed row-wise unlike matmul weights
EMBEDDING_TABLE_SITES = frozenset(
    {"emb.word", "emb.position", "emb.token_type"})


def bert_weight_site_tensors(params: Dict) -> Dict[str, Tensor]:
    """Map weight-site names to their tensors."""
    out = encoder_weight_site_tensors(params)
    out["pooler.dense.w"] = params["pooler"]["kernel"]
    out["classifier.w"] = params["classifier"]["kernel"]
    return out


def encoder_weight_site_tensors(params: Dict) -> Dict[str, Tensor]:
    """The embedding and encoder weight sites, shared by the BERT-shaped
    families."""
    e = params["embeddings"]
    out = {"emb.word.w": e["word"], "emb.position.w": e["position"],
           "emb.token_type.w": e["token_type"],
           "emb.ln.w": e["ln"]["scale"]}
    for i, layer in enumerate(params["layers"]):
        p = f"L{i}."
        out[p + "attn.q.w"] = layer["attn"]["q"]["kernel"]
        out[p + "attn.k.w"] = layer["attn"]["k"]["kernel"]
        out[p + "attn.v.w"] = layer["attn"]["v"]["kernel"]
        out[p + "attn_out.dense.w"] = layer["attn_out"]["dense"]["kernel"]
        out[p + "attn_out.ln.w"] = layer["attn_out"]["ln"]["scale"]
        out[p + "ffn.inter.w"] = layer["ffn"]["inter"]["kernel"]
        out[p + "ffn.dense.w"] = layer["ffn"]["dense"]["kernel"]
        out[p + "ffn.ln.w"] = layer["ffn"]["ln"]["scale"]
    return out


def bert_adaround_specs(params: Dict, cfg: BertConfig
                        ) -> List[Tuple[str, Dict]]:
    """The weighted layers in module order, each with what a re-run of
    the layer alone needs: the embeddings (their LayerNorm too), each
    encoder layer's q / k / v, attention-output dense and LayerNorm,
    intermediate (dense + gelu), output dense and LayerNorm, then the
    pooler and the classifier (102 at 12 layers)."""
    return encoder_adaround_specs(params, cfg) + [
        ("pooler.dense", {"kind": "linear", "w": params["pooler"]["kernel"],
                          "b": params["pooler"]["bias"], "act": "tanh"}),
        ("classifier", {"kind": "linear", "w": params["classifier"]["kernel"],
                        "b": params["classifier"]["bias"], "act": None}),
    ]


def encoder_adaround_specs(params: Dict, cfg) -> List[Tuple[str, Dict]]:
    """The embedding and encoder-layer AdaRound specs. The intermediate
    layer's activation is named ``"gelu"`` (exact), as in the JAX
    package, whatever ``cfg.hidden_act`` is."""
    e = params["embeddings"]
    specs: List[Tuple[str, Dict]] = [
        ("emb.word", {"kind": "embedding", "w": e["word"]}),
        ("emb.position", {"kind": "embedding", "w": e["position"]}),
        ("emb.token_type", {"kind": "embedding", "w": e["token_type"]}),
        ("emb.ln", {"kind": "layernorm", "w": e["ln"]["scale"],
                    "b": e["ln"]["bias"], "eps": cfg.layer_norm_eps}),
    ]
    for i, layer in enumerate(params["layers"]):
        p = f"L{i}."
        a, so, f = layer["attn"], layer["attn_out"], layer["ffn"]

        def lin(d, act=None):
            return {"kind": "linear", "w": d["kernel"], "b": d["bias"],
                    "act": act}

        def ln(d):
            return {"kind": "layernorm", "w": d["scale"], "b": d["bias"],
                    "eps": cfg.layer_norm_eps}

        specs += [
            (p + "attn.q", lin(a["q"])),
            (p + "attn.k", lin(a["k"])),
            (p + "attn.v", lin(a["v"])),
            (p + "attn_out.dense", lin(so["dense"])),
            (p + "attn_out.ln", ln(so["ln"])),
            (p + "ffn.inter", lin(f["inter"], "gelu")),
            (p + "ffn.dense", lin(f["dense"])),
            (p + "ffn.ln", ln(f["ln"])),
        ]
    return specs


def pack_int_params(tensors: Dict[str, Tensor], qcfg: QuantModelConfig,
                    qstate: Mapping, use_int4: bool = False) -> Dict:
    """Int8 payloads for every packable weight site (LayerNorm gammas stay
    on the fake-quant path). A matmul weight with an AdaRound ``alpha``
    packs its hard rounding decisions, always as int8 storage of its
    levels; with ``use_int4`` any other 2-D weight whose site is 4-bit is
    packed as split-half int4. Embedding tables stay int8 and round to
    nearest, alpha or not, as in the JAX package."""
    out: Dict = {}
    for wname, w in tensors.items():
        if wname.endswith("ln.w") or wname not in qcfg:
            continue
        site_cfg = qcfg[wname]
        if not site_cfg.enabled or not IL.can_pack_weight(site_cfg.spec):
            continue
        if wname not in qstate:
            continue
        qp = qstate[wname]["qp"]
        alpha = qstate[wname].get("alpha")
        name = wname[:-len(".w")]
        if name in EMBEDDING_TABLE_SITES:
            out[name] = IL.pack_embedding_int8(site_cfg.spec, qp, w)
        elif w.ndim != 2:
            continue
        elif use_int4 and site_cfg.spec.n_bits == 4 and alpha is None:
            out[name] = IL.pack_weight_int4(site_cfg.spec, qp, w)
        else:
            out[name] = IL.pack_weight_int8(site_cfg.spec, qp, w,
                                            alpha=alpha)
    return out


def build_bert_int_params(params: Dict, qcfg: QuantModelConfig,
                          qstate: Mapping, use_int4: bool = False) -> Dict:
    """Pack BERT's linear kernels and embedding tables into int8 (4-bit
    weight sites into split-half int4 with ``use_int4``)."""
    with torch.no_grad():
        return pack_int_params(bert_weight_site_tensors(params), qcfg,
                               qstate, use_int4=use_int4)


# ---------------------------------------------------------------------------
# Forward pass
# ---------------------------------------------------------------------------


def _params_device(params: Dict) -> torch.device:
    return params["embeddings"]["word"].device


def _check_device(params: Dict, device) -> torch.device:
    dev = resolve_device(device)
    pdev = _params_device(params)
    if pdev.type != dev.type:
        raise ValueError(f"params live on {pdev}, but device={dev}")
    return pdev


def _attention_mask(batch: Mapping, device) -> Tensor:
    return torch.as_tensor(batch["attention_mask"], device=device).to(
        torch.float32)


def prepare_inputs(batch: Mapping, device):
    """(input_ids, token_type_ids, position_ids, mask_bias) on ``device``:
    default token types / positions and the HF additive -10000 mask."""
    input_ids = torch.as_tensor(batch["input_ids"], device=device).long()
    B, T = input_ids.shape
    token_type_ids = batch.get("token_type_ids")
    token_type_ids = (torch.zeros_like(input_ids) if token_type_ids is None
                      else torch.as_tensor(token_type_ids,
                                           device=device).long())
    position_ids = batch.get("position_ids")
    position_ids = (torch.arange(T, device=device).expand(B, T)
                    if position_ids is None
                    else torch.as_tensor(position_ids, device=device).long())
    mask_bias = None
    if batch.get("attention_mask") is not None:
        mask_bias = (1.0 - _attention_mask(batch, device)[:, None, None, :]
                     ) * -10000.0
    return input_ids, token_type_ids, position_ids, mask_bias


def int8_sites_for_mode(int8_qat_sites, train: bool, cfg):
    """The int8 QAT forward's sites, or None when training with hidden
    dropout: dropout between an act site and its consumer matmul
    (embeddings -> L0 q/k/v, pooled -> classifier) rescales survivors by
    1/(1-p), off the producer's 8-bit grid, where the int8 path's exact
    level recovery would re-quantize and clip them (the JAX
    ``int8_sites_for_mode``). The reference QAT recipe trains with dropout
    0."""
    if (int8_qat_sites and train
            and getattr(cfg, "hidden_dropout_prob", 0.0) > 0.0):
        return None
    return int8_qat_sites


def make_ctx(qcfg, qstate, mode, *, mse_session=None,
             int_params=None, capture_sites=None,
             capture_pre_act: bool = False, compute_dtype=None,
             attention_dtype=None, int8_attention: bool = False
             ) -> QuantCtx:
    """The per-forward quantization context (shared across families), with
    the inference options of :func:`bert_apply`: ``compute_dtype``
    (activation storage), ``attention_dtype`` (the attention's float
    einsums) and ``int8_attention`` (its scores and context on int8
    levels)."""
    ctx = QuantCtx(qcfg if qcfg is not None else QuantModelConfig(()),
                   qstate or {}, mode or QuantMode(),
                   mse_session=mse_session)
    ctx.int_params = int_params or None
    if capture_sites:
        ctx.capture_sites = frozenset(capture_sites)
        ctx.capture_pre_act = capture_pre_act
    ctx.compute_dtype = compute_dtype
    ctx.attention_dtype = attention_dtype
    ctx.int8_attention = int8_attention
    return ctx


def family_ctx(qcfg, qstate, mode, cfg, *, train: bool, int_params=None,
               fused_linear=False, int8_qat_sites=None, mse_session=None,
               capture_sites=None, capture_pre_act: bool = False,
               compute_dtype=None, attention_dtype=None,
               int8_attention: bool = False) -> QuantCtx:
    """The forward's context for a family beyond BERT: ``int8_qat_sites``
    as :func:`bert_apply` takes them (:func:`int8_sites_for_mode`), the
    training forward refusing ``int_params`` as it does, and
    ``fused_linear`` (the JAX ``use_pallas``) running the int8 matmuls
    through the fused linear, without BERT's int8 hand-off and
    requant-only sites (the JAX families set neither); the inference
    options as :func:`make_ctx`'s."""
    if train and int_params:
        raise ValueError("int_params is an inference path; train with the "
                         "fake-quant forward")
    ctx = make_ctx(qcfg, qstate, mode, mse_session=mse_session,
                   int_params=int_params, capture_sites=capture_sites,
                   capture_pre_act=capture_pre_act,
                   compute_dtype=compute_dtype,
                   attention_dtype=attention_dtype,
                   int8_attention=int8_attention)
    ctx.int8_qat_sites = frozenset(
        int8_sites_for_mode(int8_qat_sites, train, cfg) or ())
    if int_params and fused_linear:
        ctx.fused_linear = fused_linear
    return ctx


def compute_mask(mask_bias, compute_dtype):
    """The additive mask bias in ``compute_dtype`` when the forward sets
    one (JAX ``bert_apply``'s cast)."""
    if compute_dtype is None or mask_bias is None:
        return mask_bias
    return mask_bias.to(compute_dtype)


def _embeddings(ctx, params, cfg: BertConfig, input_ids, token_type_ids,
                position_ids, train, gen):
    """Two-stage quantized embedding sum."""
    e = params["embeddings"]
    words = quant_embedding(ctx, "emb.word", input_ids, e["word"])
    tok_types = quant_embedding(ctx, "emb.token_type", token_type_ids,
                                e["token_type"])
    h = ctx.act("emb.sum_tt", words + tok_types)
    pos = quant_embedding(ctx, "emb.position", position_ids, e["position"])
    h = ctx.act("emb.sum_pos", h + pos)
    h = quant_layernorm(ctx, "emb.ln", h, e["ln"]["scale"], e["ln"]["bias"],
                        cfg.layer_norm_eps)
    return dropout(h, cfg.hidden_dropout_prob, gen, not train)


def _act_site_params(ctx, site: str):
    """(spec, qp) of a fixed, enabled, per-tensor act site of at most 8
    bits, else (None, None) (the JAX ``_act_site_params``)."""
    c = ctx.cfg[site] if site in ctx.cfg else None
    if (c is not None and c.enabled and ctx.mode.act_quant
            and ctx.mode.act_phase == Phase.fix and site in ctx.qstate
            and c.axis is None and c.spec.n_bits <= 8):
        qp = ctx.qstate[site]["qp"]
        if qp.delta.ndim == 0:
            return c.spec, qp
    return None, None


def _int8_attention_sites(ctx, a: str, b: str):
    """The two sites' (spec, qp) pairs when ``ctx.int8_attention`` runs
    their product on int8 levels (packed int params, both sites as
    :func:`_act_site_params` takes them), else None."""
    if not (ctx.int_params and ctx.int8_attention):
        return None
    (sa, qa), (sb, qb) = _act_site_params(ctx, a), _act_site_params(ctx, b)
    if sa is None or sb is None:
        return None
    return sa, qa, sb, qb


def attention_scores(ctx, q: Tensor, k: Tensor, prefix: str,
                     dtype=None) -> Tensor:
    """(B, T, n, d) q and k -> (B, n, Tq, Tk) raw scores: on int8 levels
    (:func:`~..ops.int_linear.int8_attention_scores`) under
    ``ctx.int8_attention``, else a float matmul in ``ctx.attention_dtype``
    (when set) cast to ``dtype`` (when given)."""
    sites = _int8_attention_sites(ctx, prefix + "attn.q.out",
                                  prefix + "attn.k.out")
    if sites is not None:
        return IL.int8_attention_scores(q, k, *sites)
    if ctx.attention_dtype is not None:
        q, k = q.to(ctx.attention_dtype), k.to(ctx.attention_dtype)
    s = float_matmul(q.permute(0, 2, 1, 3), k.permute(0, 2, 3, 1),
                     wide_matmul_precision(ctx, prefix + "attn.q.out",
                                           prefix + "attn.k.out"))
    return s if dtype is None else s.to(dtype)


def attention_context(ctx, probs: Tensor, v: Tensor, prefix: str,
                      dtype=None) -> Tensor:
    """(B, n, Tq, Tk) probs and (B, T, n, d) v -> (B, Tq, n, d) context, as
    :func:`attention_scores` picks its product."""
    sites = _int8_attention_sites(ctx, prefix + "attn.probs",
                                  prefix + "attn.v.out")
    if sites is not None:
        return IL.int8_attention_context(probs, v, *sites)
    if ctx.attention_dtype is not None:
        probs, v = probs.to(ctx.attention_dtype), v.to(ctx.attention_dtype)
    c = float_matmul(probs, v.permute(0, 2, 1, 3), wide_matmul_precision(
        ctx, prefix + "attn.probs", prefix + "attn.v.out"))
    return (c if dtype is None else c.to(dtype)).permute(0, 2, 1, 3)


def _self_attention(ctx, layer, cfg: BertConfig, h, mask_bias, prefix,
                    train, gen, h_site=None, linear=quant_linear):
    """Quantized self-attention (float or, under ``ctx.int8_attention``,
    integer products between fake-quant sites; the softmax in float32);
    ``linear`` computes q, k and v (:func:`~..ops.layers.quant_linear`'s
    signature)."""
    B, T, H = h.shape
    nh, hd = cfg.num_attention_heads, cfg.head_dim
    a = layer["attn"]
    q = linear(ctx, prefix + "attn.q", h, a["q"]["kernel"], a["q"]["bias"],
               input_site=h_site)
    k = linear(ctx, prefix + "attn.k", h, a["k"]["kernel"], a["k"]["bias"],
               input_site=h_site)
    v = linear(ctx, prefix + "attn.v", h, a["v"]["kernel"], a["v"]["bias"],
               input_site=h_site)
    q = q.reshape(B, T, nh, hd)
    k = k.reshape(B, T, nh, hd)
    v = v.reshape(B, T, nh, hd)
    scores = attention_scores(ctx, q, k, prefix, h.dtype)
    # raw scores are quantized; 1/sqrt(d) comes after
    scores = ctx.act(prefix + "attn.scores", scores)
    scores = scores / torch.sqrt(torch.full((), float(hd), dtype=scores.dtype,
                                            device=scores.device))
    if mask_bias is not None:
        scores = scores + mask_bias.to(scores.dtype)
    probs = torch.softmax(scores.to(torch.float32), dim=-1).to(scores.dtype)
    probs = ctx.act(prefix + "attn.probs", probs)
    probs = dropout(probs, cfg.attention_probs_dropout_prob, gen, not train)
    context = attention_context(ctx, probs, v, prefix, h.dtype).reshape(
        B, T, H)
    return ctx.act(prefix + "attn.context", context)


def _layer(ctx, layer, cfg: BertConfig, h, mask_bias, prefix, train, gen,
           h_site=None, linear=quant_linear):
    """One encoder layer; ``linear`` computes each of its matmuls
    (SqueezeBERT's grouped layers)."""
    context = _self_attention(ctx, layer, cfg, h, mask_bias, prefix, train,
                              gen, h_site=h_site, linear=linear)
    so = layer["attn_out"]
    y = linear(ctx, prefix + "attn_out.dense", context,
               so["dense"]["kernel"], so["dense"]["bias"],
               input_site=prefix + "attn.context")
    y = dropout(y, cfg.hidden_dropout_prob, gen, not train)
    y = ctx.act(prefix + "attn_out.res", y + h)
    attn_out = quant_layernorm(ctx, prefix + "attn_out.ln", y,
                               so["ln"]["scale"], so["ln"]["bias"],
                               cfg.layer_norm_eps)
    f = layer["ffn"]
    inter = linear(ctx, prefix + "ffn.inter", attn_out, f["inter"]["kernel"],
                   f["inter"]["bias"], activation=cfg.hidden_act,
                   input_site=prefix + "attn_out.ln.out")
    y = linear(ctx, prefix + "ffn.dense", inter, f["dense"]["kernel"],
               f["dense"]["bias"], input_site=prefix + "ffn.inter.out")
    y = dropout(y, cfg.hidden_dropout_prob, gen, not train)
    y = ctx.act(prefix + "ffn.res", y + attn_out)
    return quant_layernorm(ctx, prefix + "ffn.ln", y, f["ln"]["scale"],
                           f["ln"]["bias"], cfg.layer_norm_eps)


def maybe_remat_layer(ctx, remat: bool, layer_fn, params_i, h, gen):
    """``layer_fn(sub_ctx, params_i, h, gen)``, under ``remat`` inside
    ``torch.utils.checkpoint.checkpoint(use_reentrant=False)``: the
    layer's activations are recomputed in the backward instead of stored
    (the JAX ``maybe_remat_layer``'s ``jax.checkpoint``).

    The quant state threads through the recomputed region: each run of
    the region starts a shallow context copy from the quant state at the
    layer's entry, the forward's copy hands its updates on to ``ctx``, and
    the backward's recompute discards its own, so no estimate-phase update
    is applied twice. The dropout generator is set to its entry state for
    each run; the recompute leaves it where it found it. Off while
    capturing (as in JAX), where no gradient is recorded, and with an
    ``mse_session`` (its estimators would see the recompute's batch)."""
    if (not remat or ctx.capture_sites or ctx.mse_session is not None
            or not torch.is_grad_enabled()):
        return layer_fn(ctx, params_i, h, gen)
    import copy

    from torch.utils.checkpoint import checkpoint

    entry_qstate = dict(ctx.qstate)
    entry_rng = gen.get_state() if gen is not None else None
    forward_qstate = []

    def region(h_in):
        recompute = bool(forward_qstate)
        sub = copy.copy(ctx)
        sub.qstate = dict(entry_qstate)
        if gen is not None:
            resume = gen.get_state()
            gen.set_state(entry_rng)
        try:
            y = layer_fn(sub, params_i, h_in, gen)
        finally:
            if recompute and gen is not None:
                gen.set_state(resume)
        if not recompute:
            forward_qstate.append(sub.export())
        return y

    y = checkpoint(region, h, use_reentrant=False)
    ctx.qstate = dict(forward_qstate[0])
    return y


def run_encoder(ctx, params, cfg, h, mask_bias, train, gen, *,
                first_site: str, linear=quant_linear, remat: bool = False):
    """The encoder-layer stack as a plain loop, each layer under
    :func:`maybe_remat_layer`; returns (h, last site)."""
    h_site = first_site
    for i in range(cfg.num_hidden_layers):
        h = maybe_remat_layer(
            ctx, remat,
            lambda sub, p_i, hc, g, prefix=f"L{i}.", hs=h_site: _layer(
                sub, p_i, cfg, hc, mask_bias, prefix, train, g, h_site=hs,
                linear=linear),
            params["layers"][i], h, gen)
        h_site = f"L{i}.ffn.ln.out"
    return h, h_site


def bert_apply(params: Dict, batch: Mapping, cfg: BertConfig,
               qcfg: Optional[QuantModelConfig] = None,
               qstate: Optional[Dict] = None,
               mode: Optional[QuantMode] = None, *, train: bool = False,
               dropout_generator: Optional[torch.Generator] = None,
               mse_session: Optional[Dict] = None,
               int_params: Optional[Dict] = None,
               fused_linear=False,
               int8_qat_sites=None,
               capture_sites=None,
               capture_pre_act: bool = False,
               compute_dtype=None,
               attention_dtype=None,
               int8_attention: bool = False,
               remat: bool = False,
               scan_layers: bool = False,
               device="cuda") -> Tuple[Dict, Dict]:
    """Forward pass; returns ``(outputs, new_qstate)``.

    ``qcfg=None`` is the float baseline (its dtype is the params' dtype:
    bf16 params give the bf16 dense model). ``int_params`` runs every
    packable matmul on the exact int8 path. ``fused_linear`` (the JAX
    ``use_pallas``) runs those with a per-tensor input site through the
    fused linear kernel, ``ffn.inter`` handing its output payload to
    ``ffn.dense`` as int8; ``'plain'`` runs the kernel's plain version on
    any device. ``mse_session`` holds the MSE / cross-entropy act sites'
    estimators across calibration batches. ``params`` must live on
    ``device``.

    ``train=True`` is the training forward: dropout draws from
    ``dropout_generator`` (required when a dropout rate is above 0), and
    where gradients are enabled the forward builds the autograd graph
    (inference and calibration run under ``torch.no_grad``).
    ``int8_qat_sites`` (``training/qat.py`` ``int8_forward_sites``) runs
    those layers' fake-quant matmuls on int8 payloads
    (``training/int8_qat.py``); off in training with hidden dropout
    (:func:`int8_sites_for_mode`). The engine-only ``int_params`` paths
    are inference paths and refuse ``train``.

    ``capture_sites`` (AdaRound's layer I/O) records each named layer's
    (input, output) pair in ``outputs["captures"]``, the output before
    the fused activation with ``capture_pre_act``; the fused linear and
    the int8 QAT matmul stand aside while capturing.

    Inference options (the JAX ``bert_apply``'s): ``compute_dtype`` (e.g.
    ``torch.bfloat16``) stores activations in that dtype (embedding rows,
    the float matmuls' operands, the mask bias; LayerNorm statistics and
    the fake-quant grid arithmetic stay float32; the fused linear takes a
    bfloat16 x and returns bfloat16), and skips the int8 QAT matmul;
    ``attention_dtype`` runs the attention's float matmuls in that dtype
    (the softmax stays float32); ``int8_attention`` with ``int_params``
    takes the scores and context products on the int8 levels of 8-bit
    per-tensor q / k / probs / v sites. In training ``compute_dtype`` is
    the JAX ``QATConfig.compute_dtype`` (``--amp``): bf16 activations and
    matmuls over float32 master weights, range math, LayerNorm
    statistics, softmax and loss in float32.

    Training options (the JAX ``bert_apply``'s): ``remat`` recomputes each
    encoder layer in the backward (:func:`maybe_remat_layer`; equal
    values and gradients). ``scan_layers`` is taken and the layers run in
    the loop: JAX's scan traces one layer body for every layer to cut its
    compile time, computes the loop's values (its gates fall back to the
    loop wherever a layer needs its own identity), and eager PyTorch has
    no trace for a scan to shorten; stacking the weights would only copy
    them.
    """
    del scan_layers  # the loop computes JAX's scan; see above
    dev = _check_device(params, device)
    if train and int_params:
        raise ValueError("int_params is an inference path; train with the "
                         "fake-quant forward")
    with contextlib.nullcontext() if train else torch.no_grad():
        ctx = make_ctx(qcfg, qstate, mode, mse_session=mse_session,
                       int_params=int_params, capture_sites=capture_sites,
                       capture_pre_act=capture_pre_act,
                       compute_dtype=compute_dtype,
                       attention_dtype=attention_dtype,
                       int8_attention=int8_attention)
        ctx.int8_qat_sites = frozenset(
            int8_sites_for_mode(int8_qat_sites, train, cfg) or ())
        if int_params and fused_linear:
            ctx.fused_linear = fused_linear
            # consumed only by the next int8 matmul: emitted as payloads
            ctx.int8_only_sites = frozenset(
                f"L{i}.ffn.inter.out" for i in range(cfg.num_hidden_layers))
        if int_params:
            # sites whose every consumer is an int8 matmul over the same
            # site params: producer-side fake-quant is a numeric no-op
            req = set()
            if "classifier" in int_params:
                req.add("pooler.dense.out")
            for i in range(cfg.num_hidden_layers):
                if f"L{i}.attn_out.dense" in int_params:
                    req.add(f"L{i}.attn.context")
            ctx.requant_only_sites = frozenset(req)
        input_ids, token_type_ids, position_ids, mask_bias = prepare_inputs(
            batch, dev)
        mask_bias = compute_mask(mask_bias, compute_dtype)
        gen = dropout_generator if train else None
        h = _embeddings(ctx, params, cfg, input_ids, token_type_ids,
                        position_ids, train, gen)
        h, h_site = run_encoder(ctx, params, cfg, h, mask_bias, train, gen,
                                first_site="emb.ln.out", remat=remat)
        outputs = _classification_head(ctx, params, cfg, h, h_site, batch,
                                       train, gen)
        if capture_sites:
            outputs["captures"] = ctx.captures
    return outputs, ctx.export()


def _classification_head(ctx, params, cfg: BertConfig, h, h_site, batch,
                         train, gen, clamp: bool = True):
    """Pooler + classifier + loss; ``clamp`` the STS-B regression logits
    to [0, 5] (ALBERT's and SqueezeBERT's fake-quant forwards do not)."""
    pooled = quant_linear(ctx, "pooler.dense", h[:, 0],
                          params["pooler"]["kernel"], params["pooler"]["bias"],
                          activation="tanh", input_site=h_site)
    pooled = dropout(pooled, cfg.hidden_dropout_prob, gen, not train)
    logits = quant_linear(ctx, "classifier", pooled,
                          params["classifier"]["kernel"],
                          params["classifier"]["bias"],
                          input_site="pooler.dense.out")
    if cfg.num_labels == 1 and clamp:
        logits = torch.clamp(logits, 0.0, 5.0)  # STS-B regression
    outputs = {"logits": logits, "pooled": pooled, "sequence_output": h}
    labels = batch.get("labels")
    if labels is not None:
        labels = torch.as_tensor(labels).to(logits.device)
        outputs["loss"] = classification_loss(logits, labels, cfg.num_labels)
    return outputs


def classification_loss(logits, labels, num_labels: int):
    """MSE for regression tasks, cross-entropy otherwise."""
    if num_labels == 1:
        return torch.mean((logits.reshape(-1)
                           - labels.reshape(-1).to(torch.float32)) ** 2)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return -torch.gather(logp, 1, labels.long()[:, None]).mean()


# ---------------------------------------------------------------------------
# Full-handoff int8 inference engine
# ---------------------------------------------------------------------------


def build_bert_engine(params: Dict, cfg: BertConfig, qcfg: QuantModelConfig,
                      qstate: Mapping, int_params: Optional[Dict] = None,
                      use_int4: bool = False, device="cuda"):
    """Assemble the engine plan for a calibrated BERT; returns
    ``(static, plan, int_params)``. Raises
    :class:`~..ops.engine.EngineIncompatible` when the config does not fit
    the ported routes (all-int8 layers, flex layers with 16-bit / PEG
    ``g``, ``u``, ``x``, ``h`` and ``y`` sites, and the non-payload
    residual route of a disabled ``g`` / ``h`` fold site)."""
    _check_device(params, device)
    with torch.no_grad():
        if int_params is None:
            int_params = build_bert_int_params(params, qcfg, qstate,
                                               use_int4=use_int4)
        static, plan = ENG.build_encoder_plan(
            qcfg, qstate, int_params, params["layers"],
            n_heads=cfg.num_attention_heads, ln_eps=cfg.layer_norm_eps,
            hidden_act=cfg.hidden_act, entry_site="emb.ln.out")
    return static, plan, int_params


def exit_dtype(h: Tensor) -> torch.dtype:
    """The dtype the engine's output takes for the head, from the value
    that entered the engine: float32, or float64 for a float64 model
    (``--double``), whose JAX head promotes the engine's float32 output to
    its float64 weights."""
    return torch.promote_types(h.dtype, torch.float32)


def engine_bias(batch: Mapping, input_ids: Tensor, dev) -> Tensor:
    """The engine's (B, T) additive attention bias: -10000 on padding."""
    if batch.get("attention_mask") is None:
        return torch.zeros(input_ids.shape, device=dev)
    return (1.0 - _attention_mask(batch, dev)) * -10000.0


def bert_engine_apply(params: Dict, batch: Mapping, cfg: BertConfig,
                      qcfg: QuantModelConfig, qstate: Mapping, static, plan,
                      int_params: Dict, *, backend: str = "kernels",
                      engine_dtype=torch.float32, gelu_impl: str = "tanh",
                      device="cuda") -> Dict:
    """Inference through the full-handoff int8 engine: embeddings and the
    pooler/classifier head run through the generic site machinery, the
    encoder on int8 payloads (``ops/engine.py``). ``backend='plain'`` runs
    the encoder layers' plain versions instead of the kernels (a
    ``'mix:<mm>,<attn>,<ln>'`` spec mixes them). ``engine_dtype`` / ``gelu_impl`` are the JAX options (``ops/engine.py``
    :func:`~..ops.engine.encoder_engine`'s ``out_dtype`` / ``gelu_impl``);
    the encoder's output is cast back to float32 for the head."""
    dev = _check_device(params, device)
    with torch.no_grad():
        ctx = make_ctx(qcfg, qstate, QuantMode(), int_params=int_params)
        input_ids, token_type_ids, position_ids, _ = prepare_inputs(batch,
                                                                    dev)
        h = _embeddings(ctx, params, cfg, input_ids, token_type_ids,
                        position_ids, False, None)
        h = ENG.encoder_engine(h, engine_bias(batch, input_ids, dev), static,
                               plan, backend=backend, out_dtype=engine_dtype,
                               gelu_impl=gelu_impl).to(exit_dtype(h))
        h_site = f"L{cfg.num_hidden_layers - 1}.ffn.ln.out"
        return _classification_head(ctx, params, cfg, h, h_site, batch,
                                    False, None)
