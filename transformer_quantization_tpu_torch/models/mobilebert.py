"""Quantized MobileBERT for sequence classification.

Counterpart of ``transformer_quantization_tpu/models/mobilebert.py``
(google/mobilebert-uncased): trigram embeddings (128-d word vectors with
their right and left neighbours, 384-d, transformed to 512-d, then the
position and token-type sums), NoNorm (``x * w + b``, both through one
weight site) wherever BERT has LayerNorm, and inverted-bottleneck layers:
bottleneck-in projections (with the shared key/query bottleneck), 4 heads
over the 128-d true hidden size, stacked FFNs, the output FFN and the
bottleneck-out back to 512-d. Parameters keep the JAX nesting and its
``(out, in)`` kernel layout, so ``convert.py`` carries JAX weights across.

Ported: the fake-quant forward :func:`mobilebert_apply` (inference,
calibration and training with dropout, the int8 QAT matmuls, ``remat``
and ``scan_layers``; also the FP baseline with ``qcfg=None`` and the
generic int8 path with ``int_params``), the site inventory with the
MobileBERT ``quant_dict`` (static enables and the attention-probs
overrides), int8 packing (int8, and split-half int4 with ``use_int4`` as
in the JAX package), and the full-handoff engine
(:func:`build_mobilebert_engine`, :func:`mobilebert_encoder_engine`,
:func:`mobilebert_engine_apply`) on int8 or packed int4 weights (W4A8).
:func:`apply_peg_wiring` passes the config through, as in the JAX
package. AdaRound specs, the pipeline and capture wait; the engine
raises "not yet ported" for 16-bit or disabled attention sites.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from transformer_quantization_tpu_torch import resolve_device
from transformer_quantization_tpu_torch.models import bert as B
from transformer_quantization_tpu_torch.ops import engine as ENG
from transformer_quantization_tpu_torch.ops.kernels import engine_kernels as EK
from transformer_quantization_tpu_torch.ops.layers import (
    dropout,
    quant_embedding,
    quant_linear,
    quant_nonorm,
)
from transformer_quantization_tpu_torch.quant import quantizers as Q
from transformer_quantization_tpu_torch.quant.qconfig import (
    QuantConfigBuilder,
    QuantDefaults,
    QuantModelConfig,
    QuantMode,
)
from transformer_quantization_tpu_torch.quant.ranges import (
    OptMethod,
    RangeMethod,
)

Tensor = torch.Tensor

# the reference's default MobileBERT quant_dict
DEFAULT_QUANT_DICT = {
    "sum_input_pos_embd": True,
    "sum_token_type_embd": True,
    "attn_scores": True,
    "attn_probs": True,
    "attn_probs_n_bits_act": None,
    "attn_probs_act_range_method": None,
    "attn_probs_act_range_options": None,
    "attn_output": True,
    "res_self_output": True,
    "res_output": True,
    "res_output_bottleneck": True,
    "res_ffn_output": True,
}


@dataclasses.dataclass(frozen=True)
class MobileBertConfig:
    """HF ``MobileBertConfig`` subset (google/mobilebert-uncased defaults)."""

    vocab_size: int = 30522
    hidden_size: int = 512
    num_hidden_layers: int = 24
    num_attention_heads: int = 4
    intermediate_size: int = 512
    embedding_size: int = 128
    intra_bottleneck_size: int = 128
    num_feedforward_networks: int = 4
    use_bottleneck: bool = True
    use_bottleneck_attention: bool = False
    key_query_shared_bottleneck: bool = True
    trigram_input: bool = True
    hidden_act: str = "relu"
    classifier_activation: bool = False
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout_prob: float = 0.0
    attention_probs_dropout_prob: float = 0.1
    num_labels: int = 2
    initializer_range: float = 0.02

    @property
    def true_hidden_size(self) -> int:
        return (self.intra_bottleneck_size if self.use_bottleneck
                else self.hidden_size)

    @property
    def head_dim(self) -> int:
        return self.true_hidden_size // self.num_attention_heads

    @property
    def num_stacked_ffn(self) -> int:
        return self.num_feedforward_networks - 1

    @property
    def has_shared_kq_bottleneck(self) -> bool:
        return (self.use_bottleneck and self.key_query_shared_bottleneck
                and not self.use_bottleneck_attention)


def make_quant_dict(partial: Optional[Mapping] = None) -> Dict:
    """DEFAULT_QUANT_DICT overlaid with user overrides."""
    qd = dict(DEFAULT_QUANT_DICT)
    qd.update(partial or {})
    return qd


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def init_mobilebert_params(cfg: MobileBertConfig, seed: int = 0,
                           device="cuda") -> Dict:
    """Random initialization: normal(0, initializer_range) kernels and
    tables, zero biases, NoNorm weights 1 and biases 0; kernels stored
    ``(out, in)``. Drawn from a ``torch.Generator`` seeded with ``seed``
    (on the CPU, so a seed gives the same weights on every device)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    std = cfg.initializer_range
    h, th, e, i = (cfg.hidden_size, cfg.true_hidden_size, cfg.embedding_size,
                   cfg.intermediate_size)

    def normal(*shape):
        return (std * torch.randn(shape, generator=gen)).to(dev)

    def linear(n_out, n_in):
        return {"kernel": normal(n_out, n_in),
                "bias": torch.zeros((n_out,), device=dev)}

    def nonorm(dim):
        return {"weight": torch.ones((dim,), device=dev),
                "bias": torch.zeros((dim,), device=dev)}

    params: Dict = {
        "embeddings": {
            "word": normal(cfg.vocab_size, e),
            "position": normal(cfg.max_position_embeddings, h),
            "token_type": normal(cfg.type_vocab_size, h),
            "transform": linear(h, 3 * e if cfg.trigram_input else e),
            "norm": nonorm(h),
        },
        "layers": [],
        # HF checkpoints carry pooler weights whether or not it runs
        "pooler": linear(h, h),
        "classifier": linear(cfg.num_labels, h),
    }
    for _ in range(cfg.num_hidden_layers):
        layer: Dict = {
            "attn": {"q": linear(th, th), "k": linear(th, th),
                     "v": linear(th, th if cfg.use_bottleneck_attention
                                 else h)},
            "attn_out": {"dense": linear(th, th), "norm": nonorm(th)},
            "inter": linear(i, th),
            "out": {"dense": linear(th, i), "norm": nonorm(th)},
        }
        if cfg.use_bottleneck:
            layer["bottleneck"] = {"input": {"dense": linear(th, h),
                                             "norm": nonorm(th)}}
            if cfg.has_shared_kq_bottleneck:
                layer["bottleneck"]["attention"] = {"dense": linear(th, h),
                                                    "norm": nonorm(th)}
            layer["out"]["bn_dense"] = linear(h, th)
            layer["out"]["bn_norm"] = nonorm(h)
        layer["ffn"] = [{"inter": linear(i, th), "dense": linear(th, i),
                         "norm": nonorm(th)}
                        for _ in range(cfg.num_stacked_ffn)]
        params["layers"].append(layer)
    return params


# ---------------------------------------------------------------------------
# Quant site inventory
# ---------------------------------------------------------------------------


def _declare_dense(b: QuantConfigBuilder, name: str) -> None:
    """A linear or NoNorm site: its weight and its output."""
    b.weight(f"{name}.w")
    b.act(f"{name}.out")


def declare_mobilebert_sites(defaults: QuantDefaults, cfg: MobileBertConfig,
                             quant_setup: str = "all",
                             quant_dict: Optional[Mapping] = None
                             ) -> QuantModelConfig:
    """Declare every quantizer site, honouring the MobileBERT quant_dict's
    static enables and attention-probs overrides."""
    qd = make_quant_dict(quant_dict)
    b = QuantConfigBuilder(defaults)
    b.weight("emb.word.w")
    b.weight("emb.position.w")
    b.weight("emb.token_type.w")
    _declare_dense(b, "emb.transform")
    b.act("emb.sum_pos", enabled=bool(qd["sum_input_pos_embd"]))
    b.act("emb.sum_tt", enabled=bool(qd["sum_token_type_embd"]))
    _declare_dense(b, "emb.norm")

    probs_over: Dict = {}
    if qd["attn_probs_n_bits_act"] is not None:
        probs_over["n_bits"] = int(qd["attn_probs_n_bits_act"])
    if qd["attn_probs_act_range_method"] is not None:
        probs_over["range_method"] = RangeMethod[
            qd["attn_probs_act_range_method"]]
    if qd["attn_probs_act_range_options"]:
        # the only range option the reference recipes set here
        om = dict(qd["attn_probs_act_range_options"]).get("opt_method")
        if om is not None:
            probs_over["opt_method"] = (om if isinstance(om, OptMethod)
                                        else OptMethod[om])

    for i in range(cfg.num_hidden_layers):
        p = f"L{i}."
        if cfg.use_bottleneck:
            _declare_dense(b, p + "bn.in.dense")
            _declare_dense(b, p + "bn.in.norm")
            if cfg.has_shared_kq_bottleneck:
                _declare_dense(b, p + "bn.attn.dense")
                _declare_dense(b, p + "bn.attn.norm")
        for lin in ("attn.q", "attn.k", "attn.v"):
            _declare_dense(b, p + lin)
        b.act(p + "attn.scores", enabled=bool(qd["attn_scores"]))
        b.act(p + "attn.probs", enabled=bool(qd["attn_probs"]), **probs_over)
        b.act(p + "attn.context", enabled=bool(qd["attn_output"]))
        _declare_dense(b, p + "attn_out.dense")
        b.act(p + "attn_out.res", enabled=bool(qd["res_self_output"]))
        _declare_dense(b, p + "attn_out.norm")
        for j in range(cfg.num_stacked_ffn):
            _declare_dense(b, p + f"ffn{j}.inter")
            _declare_dense(b, p + f"ffn{j}.dense")
            b.act(p + f"ffn{j}.res", enabled=bool(qd["res_ffn_output"]))
            _declare_dense(b, p + f"ffn{j}.norm")
        _declare_dense(b, p + "ffn.inter")
        _declare_dense(b, p + "out.dense")
        b.act(p + "out.res", enabled=bool(qd["res_output"]))
        _declare_dense(b, p + "out.norm")
        if cfg.use_bottleneck:
            _declare_dense(b, p + "out.bn.dense")
            b.act(p + "out.bn.res",
                  enabled=bool(qd["res_output_bottleneck"]))
            _declare_dense(b, p + "out.bn.norm")

    if cfg.classifier_activation:
        _declare_dense(b, "pooler.dense")
    b.weight("classifier.w")
    if quant_setup == "FP_logits":
        b.act("classifier.out", enabled=False)
    elif quant_setup in ("all", None):
        b.act("classifier.out")
    else:
        raise ValueError(f"Quantization setup '{quant_setup}' not supported.")
    return b.build()


def apply_mobilebert_quant_dict(qcfg: QuantModelConfig, quant_dict: Mapping,
                                n_layers: int) -> QuantModelConfig:
    """MobileBERT takes its quant_dict at declaration time
    (:func:`declare_mobilebert_sites`), not through BERT's letter keys."""
    return qcfg


def apply_peg_wiring(qcfg: QuantModelConfig, n_layers: int,
                     **_kw) -> QuantModelConfig:
    """The reference applies the per-embedding / per-group wiring only to
    BERT; MobileBERT passes through unchanged."""
    return qcfg


# ---------------------------------------------------------------------------
# Weight tensors / int packing
# ---------------------------------------------------------------------------


def _nonorm_range_tensor(p: Dict) -> Tensor:
    # one weight site over both: the range covers concat(w, b)
    return torch.cat([p["weight"], p["bias"]])


def mobilebert_weight_site_tensors(params: Dict) -> Dict[str, Tensor]:
    """Map weight-site names to their tensors."""
    e = params["embeddings"]
    out = {
        "emb.word.w": e["word"],
        "emb.position.w": e["position"],
        "emb.token_type.w": e["token_type"],
        "emb.transform.w": e["transform"]["kernel"],
        "emb.norm.w": _nonorm_range_tensor(e["norm"]),
        "classifier.w": params["classifier"]["kernel"],
        "pooler.dense.w": params["pooler"]["kernel"],
    }
    for i, layer in enumerate(params["layers"]):
        p = f"L{i}."
        if "bottleneck" in layer:
            bn = layer["bottleneck"]
            out[p + "bn.in.dense.w"] = bn["input"]["dense"]["kernel"]
            out[p + "bn.in.norm.w"] = _nonorm_range_tensor(bn["input"]["norm"])
            if "attention" in bn:
                out[p + "bn.attn.dense.w"] = bn["attention"]["dense"]["kernel"]
                out[p + "bn.attn.norm.w"] = _nonorm_range_tensor(
                    bn["attention"]["norm"])
        out[p + "attn.q.w"] = layer["attn"]["q"]["kernel"]
        out[p + "attn.k.w"] = layer["attn"]["k"]["kernel"]
        out[p + "attn.v.w"] = layer["attn"]["v"]["kernel"]
        out[p + "attn_out.dense.w"] = layer["attn_out"]["dense"]["kernel"]
        out[p + "attn_out.norm.w"] = _nonorm_range_tensor(
            layer["attn_out"]["norm"])
        for j, f in enumerate(layer["ffn"]):
            out[p + f"ffn{j}.inter.w"] = f["inter"]["kernel"]
            out[p + f"ffn{j}.dense.w"] = f["dense"]["kernel"]
            out[p + f"ffn{j}.norm.w"] = _nonorm_range_tensor(f["norm"])
        out[p + "ffn.inter.w"] = layer["inter"]["kernel"]
        out[p + "out.dense.w"] = layer["out"]["dense"]["kernel"]
        out[p + "out.norm.w"] = _nonorm_range_tensor(layer["out"]["norm"])
        if "bn_dense" in layer["out"]:
            out[p + "out.bn.dense.w"] = layer["out"]["bn_dense"]["kernel"]
            out[p + "out.bn.norm.w"] = _nonorm_range_tensor(
                layer["out"]["bn_norm"])
    return out


def build_mobilebert_int_params(params: Dict, qcfg: QuantModelConfig,
                                qstate: Mapping,
                                use_int4: bool = False) -> Dict:
    """Pack the linear kernels and embedding tables into int8 (4-bit weight
    sites into split-half int4 with ``use_int4``; NoNorm sites stay
    elementwise)."""
    with torch.no_grad():
        tensors = {k: v for k, v in
                   mobilebert_weight_site_tensors(params).items()
                   if not k.endswith("norm.w")}
        return B.pack_int_params(tensors, qcfg, qstate, use_int4=use_int4)


# ---------------------------------------------------------------------------
# Forward pass
# ---------------------------------------------------------------------------


def _embeddings(ctx, params, cfg: MobileBertConfig, input_ids, token_type_ids,
               position_ids, train=False, gen=None):
    e = params["embeddings"]
    x = quant_embedding(ctx, "emb.word", input_ids, e["word"])  # (B, T, E)
    if cfg.trigram_input:
        # cat(x_{t+1}, x_t, x_{t-1}) along features, zero-padded at the ends
        zero = torch.zeros_like(x[:, :1])
        nxt = torch.cat([x[:, 1:], zero], dim=1)
        prv = torch.cat([zero, x[:, :-1]], dim=1)
        x = torch.cat([nxt, x, prv], dim=2)
    if cfg.trigram_input or cfg.embedding_size != cfg.hidden_size:
        x = quant_linear(ctx, "emb.transform", x, e["transform"]["kernel"],
                         e["transform"]["bias"])
    pos = quant_embedding(ctx, "emb.position", position_ids, e["position"])
    tok = quant_embedding(ctx, "emb.token_type", token_type_ids,
                          e["token_type"])
    x = ctx.act("emb.sum_pos", x + pos)
    x = ctx.act("emb.sum_tt", x + tok)
    x = quant_nonorm(ctx, "emb.norm", x, e["norm"]["weight"],
                     e["norm"]["bias"])
    return dropout(x, cfg.hidden_dropout_prob, gen, not train)


def _attention(ctx, layer, cfg: MobileBertConfig, q_in, k_in, v_in,
               layer_input, mask_bias, prefix, train, gen, qk_site=None,
               v_site=None):
    """Self-attention (float matmuls between fake-quant sites) and the
    self-output: dense -> + layer input -> res site -> NoNorm; dropout on
    the probs (and, without the bottleneck, on the dense output)."""
    b, t, _ = q_in.shape
    nh, hd, th = cfg.num_attention_heads, cfg.head_dim, cfg.true_hidden_size
    a = layer["attn"]
    q = quant_linear(ctx, prefix + "attn.q", q_in, a["q"]["kernel"],
                     a["q"]["bias"], input_site=qk_site)
    k = quant_linear(ctx, prefix + "attn.k", k_in, a["k"]["kernel"],
                     a["k"]["bias"], input_site=qk_site)
    v = quant_linear(ctx, prefix + "attn.v", v_in, a["v"]["kernel"],
                     a["v"]["bias"], input_site=v_site)
    q = q.reshape(b, t, nh, hd)
    k = k.reshape(b, t, nh, hd)
    v = v.reshape(b, t, nh, hd)
    scores = B.attention_scores(ctx, q, k, prefix)
    scores = ctx.act(prefix + "attn.scores", scores)
    scores = scores / torch.sqrt(torch.full((), float(hd), dtype=q_in.dtype,
                                            device=scores.device))
    if mask_bias is not None:
        scores = scores + mask_bias
    probs = torch.softmax(scores.to(torch.float32), dim=-1).to(scores.dtype)
    probs = ctx.act(prefix + "attn.probs", probs)
    probs = dropout(probs, cfg.attention_probs_dropout_prob, gen, not train)
    context = B.attention_context(ctx, probs, v, prefix).reshape(b, t, th)
    context = ctx.act(prefix + "attn.context", context)

    so = layer["attn_out"]
    y = quant_linear(ctx, prefix + "attn_out.dense", context,
                     so["dense"]["kernel"], so["dense"]["bias"],
                     input_site=prefix + "attn.context")
    if not cfg.use_bottleneck:
        y = dropout(y, cfg.hidden_dropout_prob, gen, not train)
    y = ctx.act(prefix + "attn_out.res", y + layer_input)
    return quant_nonorm(ctx, prefix + "attn_out.norm", y,
                        so["norm"]["weight"], so["norm"]["bias"])


def _layer(ctx, layer, cfg: MobileBertConfig, h, mask_bias, prefix,
           train=False, gen=None, h_site=None):
    """One inverted-bottleneck layer (dropout where the JAX layer has it:
    the probs, the bottleneck-out, and without the bottleneck the
    self-output and output)."""
    if cfg.use_bottleneck:
        bn = layer["bottleneck"]
        bi = bn["input"]
        layer_input = quant_linear(ctx, prefix + "bn.in.dense", h,
                                   bi["dense"]["kernel"], bi["dense"]["bias"],
                                   input_site=h_site)
        layer_input = quant_nonorm(ctx, prefix + "bn.in.norm", layer_input,
                                   bi["norm"]["weight"], bi["norm"]["bias"])
        if cfg.use_bottleneck_attention:
            q_in = k_in = v_in = layer_input
            qk_site = v_site = prefix + "bn.in.norm.out"
        elif cfg.key_query_shared_bottleneck:
            ba = bn["attention"]
            shared = quant_linear(ctx, prefix + "bn.attn.dense", h,
                                  ba["dense"]["kernel"], ba["dense"]["bias"],
                                  input_site=h_site)
            shared = quant_nonorm(ctx, prefix + "bn.attn.norm", shared,
                                  ba["norm"]["weight"], ba["norm"]["bias"])
            q_in, k_in, v_in = shared, shared, h
            qk_site, v_site = prefix + "bn.attn.norm.out", h_site
        else:
            q_in = k_in = v_in = h
            qk_site = v_site = h_site
    else:
        q_in = k_in = v_in = layer_input = h
        qk_site = v_site = h_site

    x = _attention(ctx, layer, cfg, q_in, k_in, v_in, layer_input, mask_bias,
                   prefix, train, gen, qk_site=qk_site, v_site=v_site)

    x_site = prefix + "attn_out.norm.out"
    for j, f in enumerate(layer["ffn"]):
        inter = quant_linear(ctx, prefix + f"ffn{j}.inter", x,
                             f["inter"]["kernel"], f["inter"]["bias"],
                             activation=cfg.hidden_act, input_site=x_site)
        y = quant_linear(ctx, prefix + f"ffn{j}.dense", inter,
                         f["dense"]["kernel"], f["dense"]["bias"],
                         input_site=prefix + f"ffn{j}.inter.out")
        y = ctx.act(prefix + f"ffn{j}.res", y + x)
        x = quant_nonorm(ctx, prefix + f"ffn{j}.norm", y,
                         f["norm"]["weight"], f["norm"]["bias"])
        x_site = prefix + f"ffn{j}.norm.out"

    o = layer["out"]
    inter = quant_linear(ctx, prefix + "ffn.inter", x,
                         layer["inter"]["kernel"], layer["inter"]["bias"],
                         activation=cfg.hidden_act, input_site=x_site)
    y = quant_linear(ctx, prefix + "out.dense", inter, o["dense"]["kernel"],
                     o["dense"]["bias"], input_site=prefix + "ffn.inter.out")
    if not cfg.use_bottleneck:
        y = dropout(y, cfg.hidden_dropout_prob, gen, not train)
    y = ctx.act(prefix + "out.res", y + x)
    y = quant_nonorm(ctx, prefix + "out.norm", y, o["norm"]["weight"],
                     o["norm"]["bias"])
    if not cfg.use_bottleneck:
        return y
    y = quant_linear(ctx, prefix + "out.bn.dense", y, o["bn_dense"]["kernel"],
                     o["bn_dense"]["bias"],
                     input_site=prefix + "out.norm.out")
    y = dropout(y, cfg.hidden_dropout_prob, gen, not train)
    y = ctx.act(prefix + "out.bn.res", y + h)
    return quant_nonorm(ctx, prefix + "out.bn.norm", y,
                        o["bn_norm"]["weight"], o["bn_norm"]["bias"])


def _classification_head(ctx, params, cfg: MobileBertConfig, h, h_site,
                         batch, train=False, gen=None):
    """First token -> pooler (a pass-through unless
    ``classifier_activation``) -> dropout -> classifier, + loss."""
    pooled = h[:, 0]
    clf_site = h_site
    if cfg.classifier_activation:
        pooled = quant_linear(ctx, "pooler.dense", pooled,
                              params["pooler"]["kernel"],
                              params["pooler"]["bias"], activation="tanh",
                              input_site=h_site)
        clf_site = "pooler.dense.out"
    pooled_do = dropout(pooled, cfg.hidden_dropout_prob, gen, not train)
    logits = quant_linear(ctx, "classifier", pooled_do,
                          params["classifier"]["kernel"],
                          params["classifier"]["bias"], input_site=clf_site)
    outputs = {"logits": logits, "pooled": pooled, "sequence_output": h}
    labels = batch.get("labels")
    if labels is not None:
        labels = torch.as_tensor(labels).to(logits.device)
        outputs["loss"] = B.classification_loss(logits, labels,
                                                cfg.num_labels)
    return outputs


def mobilebert_apply(params: Dict, batch: Mapping, cfg: MobileBertConfig,
                     qcfg: Optional[QuantModelConfig] = None,
                     qstate: Optional[Dict] = None,
                     mode: Optional[QuantMode] = None, *, train: bool = False,
                     dropout_generator: Optional[torch.Generator] = None,
                     mse_session: Optional[Dict] = None,
                     int_params: Optional[Dict] = None,
                     int8_qat_sites=None,
                     compute_dtype=None, attention_dtype=None,
                     int8_attention: bool = False,
                     remat: bool = False, scan_layers: bool = False,
                     device="cuda") -> Tuple[Dict, Dict]:
    """Forward pass; returns ``(outputs, new_qstate)``. ``qcfg=None`` is
    the float model; ``int_params`` runs every packable matmul on the
    exact int8 path (an inference path: it refuses ``train``);
    ``mse_session`` holds the MSE / cross-entropy act sites' estimators
    across calibration batches. ``params`` must live on ``device``.
    ``compute_dtype`` / ``int8_attention`` as the JAX
    ``mobilebert_apply``'s (and ``attention_dtype`` as
    :func:`~.bert.bert_apply`'s).

    ``train=True`` is the training forward, as :func:`~.bert.bert_apply`'s:
    dropout (at the JAX layer's places) draws from ``dropout_generator``
    (required when a dropout rate is above 0), gradients flow through the
    embeddings, NoNorms, bottlenecks and stacked FFNs, and
    ``int8_qat_sites`` runs those layers' fake-quant matmuls on int8
    payloads (off with hidden dropout, :func:`~.bert.int8_sites_for_mode`).
    ``remat`` recomputes each layer in the backward
    (:func:`~.bert.maybe_remat_layer`); ``scan_layers`` is taken and the
    layers run in the loop, as in :func:`~.bert.bert_apply`. Inference and
    calibration run under ``torch.no_grad``.
    """
    del scan_layers  # the loop computes JAX's scan (bert_apply's note)
    dev = B._check_device(params, device)
    if train and int_params:
        raise ValueError("int_params is an inference path; train with the "
                         "fake-quant forward")
    with contextlib.nullcontext() if train else torch.no_grad():
        ctx = B.make_ctx(qcfg, qstate, mode, mse_session=mse_session,
                         int_params=int_params, compute_dtype=compute_dtype,
                         attention_dtype=attention_dtype,
                         int8_attention=int8_attention)
        ctx.int8_qat_sites = frozenset(
            B.int8_sites_for_mode(int8_qat_sites, train, cfg) or ())
        input_ids, token_type_ids, position_ids, mask_bias = B.prepare_inputs(
            batch, dev)
        mask_bias = B.compute_mask(mask_bias, compute_dtype)
        gen = dropout_generator if train else None
        h = _embeddings(ctx, params, cfg, input_ids, token_type_ids,
                        position_ids, train, gen)
        h_site = "emb.norm.out"
        for i in range(cfg.num_hidden_layers):
            h = B.maybe_remat_layer(
                ctx, remat,
                lambda sub, p_i, hc, g, prefix=f"L{i}.", hs=h_site: _layer(
                    sub, p_i, cfg, hc, mask_bias, prefix, train, g,
                    h_site=hs),
                params["layers"][i], h, gen)
            h_site = (f"L{i}.out.bn.norm.out" if cfg.use_bottleneck
                      else f"L{i}.out.norm.out")
        outputs = _classification_head(ctx, params, cfg, h, h_site, batch,
                                       train, gen)
    return outputs, ctx.export()


# ---------------------------------------------------------------------------
# Full-handoff int8 inference engine
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MobileBertEngineStatic:
    """Hashable engine shape/flags for the MobileBERT topology."""

    n_layers: int
    n_heads: int
    hidden: int        # true_hidden_size (bottleneck width)
    n_ffn: int         # stacked FFNs before the output FFN
    attn_case: str     # 'bottleneck' | 'shared_kq' | 'plain'
    hidden_act: str
    # per layer: (res_attn_out, (res_ffn0, ...), res_out, res_out_bn)
    res_quant: Tuple[Tuple, ...]
    # per layer: w4 flag per matmul in plan order
    w4: Tuple[Tuple[bool, ...], ...]
    attn_skip_max: bool = False
    # per layer: (scores_bits, probs_bits, context_bits)
    attn_bits: Tuple[Tuple[int, ...], ...] = ()
    # the sequence lengths at which the layer kernel takes every layer of
    # the plan (EK.mb_layer_refusal), chosen when the plan is made
    k8_seqs: Tuple[int, ...] = ()

    def layer_attn_bits(self, i: int) -> Tuple[int, ...]:
        return self.attn_bits[i] if self.attn_bits else (8, 8, 8)

    def layer_route(self, seq: int) -> str:
        """The kernels' route at ``seq``: ``'k8'``, one
        :func:`~..ops.kernels.engine_kernels.int8_mb_layer_ln` launch a
        layer, where the layer kernel is built for the plan's shapes, else
        ``'chain'``, :func:`~..ops.kernels.engine_kernels.mb_layer_chain`
        (K1, K6 and K7 launches)."""
        return "k8" if seq in self.k8_seqs else "chain"


def _nonorm_plan(qcfg, qstate, norm_params: Mapping, wsite: str,
                 res_site: Optional[str], out_site: str,
                 r_site) -> Tuple[Dict, bool]:
    """gamma_q / beta_q (quantized together through the weight site) and
    the (1, 8) scalar row [1, 0, r_s, r_sh, res_s, res_sh, n_s, n_sh] of
    one NoNorm; ``r_site``: (s, shift) of the residual payload or None.
    Returns ``(plan, res_quant)``."""
    gamma = norm_params["weight"].to(torch.float32)
    beta = norm_params["bias"].to(torch.float32)
    if wsite in qcfg and qcfg[wsite].enabled:
        c = qcfg[wsite]
        ENG._require(wsite in qstate, f"{wsite!r} not calibrated")
        wb = Q.fake_quant(c.spec, qstate[wsite]["qp"],
                          torch.cat([gamma, beta]),
                          axis=0 if c.per_channel else None)
        gamma, beta = torch.split(wb, gamma.shape[0])
    dev = gamma.device
    one, zero = torch.ones((), device=dev), torch.zeros((), device=dev)
    res_quant = res_site is not None and ENG._act_enabled(qcfg, res_site)
    res_s, res_sh = (ENG.act_site_scalars(qcfg, qstate, res_site)
                     if res_quant else (one, zero))
    n_s, n_sh = ENG.act_site_scalars(qcfg, qstate, out_site)
    r_s, r_sh = r_site if r_site is not None else (one, zero)
    return {
        "gb": torch.stack([gamma, beta]).contiguous(),
        "scal": torch.stack([one, zero, r_s, r_sh, res_s, res_sh, n_s,
                             n_sh]).reshape(1, 8),
    }, res_quant


def _attn_case(cfg: MobileBertConfig) -> str:
    if cfg.use_bottleneck_attention:
        return "bottleneck"
    if cfg.key_query_shared_bottleneck:
        return "shared_kq"
    return "plain"


def build_mobilebert_engine(params: Dict, cfg: MobileBertConfig,
                            qcfg: QuantModelConfig, qstate: Mapping,
                            int_params: Optional[Dict] = None,
                            use_int4: bool = False, device="cuda"):
    """Assemble the full-handoff engine plan for a calibrated MobileBERT;
    returns ``(static, plan, int_params)``. Every edge of the layer is an
    int8 payload: the bottleneck matmuls carry their NoNorm, q|k is one
    matmul over the shared bottleneck and v its own, and every
    residual-feeding matmul carries add + res site + NoNorm. Raises
    :class:`~..ops.engine.EngineIncompatible` for configs off this path
    (no bottleneck, sites that are not 8-bit per-tensor payloads) and
    NotImplementedError for 16-bit or disabled attention sites, which the
    JAX engine serves and the port does not yet. ``use_int4`` packs 4-bit
    weight sites split-half (W4A8): each matmul's flag is in
    ``static.w4``, and K6 / K8 (or K1) unpack the weight in the kernel."""
    B._check_device(params, device)
    ENG._require(cfg.use_bottleneck,
                 "mobilebert engine requires use_bottleneck")
    with torch.no_grad():
        if int_params is None:
            int_params = build_mobilebert_int_params(params, qcfg, qstate,
                                                     use_int4=use_int4)
        return _build_plan(params, cfg, qcfg, qstate, int_params)


def _build_plan(params, cfg, qcfg, qstate, int_params):
    attn_case = _attn_case(cfg)

    def site(name):
        return ENG.act_site_scalars(qcfg, qstate, name)

    def mm(names, biases, in_scal, outs):
        plan, w4 = ENG._mm_plan(int_params, names, biases, in_scal, outs)
        w4s.append(w4)
        return plan

    layers, res_flags, w4_flags = [], [], []
    for i, lp in enumerate(params["layers"]):
        p = f"L{i}."
        w4s = []  # the layer's matmuls' int4 flags, in plan order
        h_scal = site("emb.norm.out" if i == 0
                      else f"L{i - 1}.out.bn.norm.out")
        bn = lp["bottleneck"]
        bn_in = mm([p + "bn.in.dense"], [bn["input"]["dense"]["bias"]],
                   h_scal, [site(p + "bn.in.dense.out")])
        bn_in_norm, _ = _nonorm_plan(qcfg, qstate, bn["input"]["norm"],
                                     p + "bn.in.norm.w", None,
                                     p + "bn.in.norm.out", None)
        li_scal = site(p + "bn.in.norm.out")
        bn_attn = bn_attn_norm = None
        if attn_case == "bottleneck":
            qk_scal, v_scal = li_scal, li_scal
        elif attn_case == "shared_kq":
            ba = bn["attention"]
            bn_attn = mm([p + "bn.attn.dense"], [ba["dense"]["bias"]],
                         h_scal, [site(p + "bn.attn.dense.out")])
            bn_attn_norm, _ = _nonorm_plan(qcfg, qstate, ba["norm"],
                                           p + "bn.attn.norm.w", None,
                                           p + "bn.attn.norm.out", None)
            qk_scal, v_scal = site(p + "bn.attn.norm.out"), h_scal
        else:
            qk_scal, v_scal = h_scal, h_scal

        a = lp["attn"]
        qk = mm([p + "attn.q", p + "attn.k"],
                [a["q"]["bias"], a["k"]["bias"]], qk_scal,
                [site(p + "attn.q.out"), site(p + "attn.k.out")])
        v = mm([p + "attn.v"], [a["v"]["bias"]], v_scal,
               [site(p + "attn.v.out")])
        sc_s, sc_sh, sc_bits = ENG.attn_edge_scalars(qcfg, qstate,
                                                     p + "attn.scores")
        p_s, p_sh, p_bits = ENG.attn_edge_scalars(qcfg, qstate,
                                                  p + "attn.probs")
        c_s, c_sh, c_bits = ENG.attn_edge_scalars(qcfg, qstate,
                                                  p + "attn.context")
        if (sc_bits, p_bits, c_bits) != (8, 8, 8):
            raise NotImplementedError(
                f"{p}attn sites are ({sc_bits}, {p_bits}, {c_bits})-bit: "
                "the quant_dict attention overrides (16-bit probs, disabled "
                "scores / probs / context) are not yet ported")
        attn_scal = torch.cat(
            [torch.stack(site(p + s)) for s in
             ("attn.q.out", "attn.k.out", "attn.v.out")]
            + [torch.stack((sc_s, sc_sh)), torch.stack((p_s, p_sh)),
               torch.stack((c_s, c_sh))]).reshape(1, 12)

        so = lp["attn_out"]
        attn_out = mm([p + "attn_out.dense"], [so["dense"]["bias"]],
                      (c_s, c_sh), [site(p + "attn_out.dense.out")])
        attn_out_norm, res_ao = _nonorm_plan(
            qcfg, qstate, so["norm"], p + "attn_out.norm.w",
            p + "attn_out.res", p + "attn_out.norm.out", li_scal)

        x_site = p + "attn_out.norm.out"
        ffns, res_ffn = [], []
        for j, f in enumerate(lp["ffn"]):
            inter = mm([p + f"ffn{j}.inter"], [f["inter"]["bias"]],
                       site(x_site), [site(p + f"ffn{j}.inter.out")])
            dense = mm([p + f"ffn{j}.dense"], [f["dense"]["bias"]],
                       site(p + f"ffn{j}.inter.out"),
                       [site(p + f"ffn{j}.dense.out")])
            norm, rq = _nonorm_plan(qcfg, qstate, f["norm"],
                                    p + f"ffn{j}.norm.w", p + f"ffn{j}.res",
                                    p + f"ffn{j}.norm.out", site(x_site))
            ffns.append({"inter": inter, "dense": dense, "norm": norm})
            res_ffn.append(rq)
            x_site = p + f"ffn{j}.norm.out"

        o = lp["out"]
        inter = mm([p + "ffn.inter"], [lp["inter"]["bias"]], site(x_site),
                   [site(p + "ffn.inter.out")])
        out_d = mm([p + "out.dense"], [o["dense"]["bias"]],
                   site(p + "ffn.inter.out"), [site(p + "out.dense.out")])
        out_norm, res_out = _nonorm_plan(
            qcfg, qstate, o["norm"], p + "out.norm.w", p + "out.res",
            p + "out.norm.out", site(x_site))
        out_bn = mm([p + "out.bn.dense"], [o["bn_dense"]["bias"]],
                    site(p + "out.norm.out"), [site(p + "out.bn.dense.out")])
        out_bn_norm, res_obn = _nonorm_plan(
            qcfg, qstate, o["bn_norm"], p + "out.bn.norm.w",
            p + "out.bn.res", p + "out.bn.norm.out", h_scal)

        layers.append({
            "bn_in": bn_in, "bn_in_norm": bn_in_norm,
            "bn_attn": bn_attn, "bn_attn_norm": bn_attn_norm,
            "qk": qk, "v": v, "attn_scal": attn_scal,
            "attn_out": attn_out, "attn_out_norm": attn_out_norm,
            "ffns": ffns, "inter": inter,
            "out": out_d, "out_norm": out_norm,
            "out_bn": out_bn, "out_bn_norm": out_bn_norm,
        })
        res_flags.append((res_ao, tuple(res_ffn), res_out, res_obn))
        w4_flags.append(tuple(w4s))

    entry_scal = torch.stack(site("emb.norm.out")).reshape(1, 2)
    # the softmax max-subtraction is dead work when the grid-bounded
    # quantized scores keep |s2| <= 256 * sc_s / sqrt(d) * log2(e) far
    # below exp2's overflow threshold (~126)
    worst = max(2.0 ** 8 * float(lp_["attn_scal"][0, 6]) for lp_ in layers)
    bound = worst / float(np.sqrt(cfg.head_dim)) * float(np.log2(np.e))
    attn_bits = ((8, 8, 8),) * cfg.num_hidden_layers
    k8_seqs = tuple(seq for seq, _, _ in EK.MB_LAYER_SHAPES if all(
        EK.mb_layer_refusal(
            seq=seq, head_dim=cfg.head_dim, n_heads=cfg.num_attention_heads,
            h=cfg.hidden_size, inter=cfg.intermediate_size,
            attn_case=attn_case, activation=cfg.hidden_act,
            n_ffn=cfg.num_stacked_ffn, attn_bits=ab, w4=w4) is None
        for lp_, ab, w4 in zip(layers, attn_bits, w4_flags)))
    static = MobileBertEngineStatic(
        n_layers=cfg.num_hidden_layers, n_heads=cfg.num_attention_heads,
        hidden=cfg.true_hidden_size, n_ffn=cfg.num_stacked_ffn,
        attn_case=attn_case, hidden_act=cfg.hidden_act,
        res_quant=tuple(res_flags), w4=tuple(w4_flags),
        attn_skip_max=bound < 100.0, attn_bits=attn_bits,
        k8_seqs=k8_seqs)
    return static, {"layers": layers, "entry_scal": entry_scal}, int_params


def mobilebert_encoder_engine(h: Tensor, mask_bias: Tensor,
                              static: MobileBertEngineStatic, plan: Dict, *,
                              backend: str = "kernels",
                              out_dtype=torch.float32,
                              fuse_layer: Optional[bool] = None) -> Tensor:
    """Run the MobileBERT encoder stack on int8 payloads.

    ``h``: (B, T, H) float, the entry-site value; ``mask_bias``: (B, T)
    float32 additive bias. Returns the last layer's bottleneck-out NoNorm
    value, (B, T, H) in ``out_dtype`` (the JAX ``engine_dtype``, which
    here only casts the exit value). ``backend='kernels'`` runs the kernel
    wrappers (the CUDA kernels on the card, their plain versions on the
    CPU), ``'plain'`` the plain versions on any device, and
    ``'mix:<mm>,<attn>,<ln>'`` (:func:`~..ops.engine.parse_backend`) the
    matmuls on one and the attention on the other (NoNorm rides the
    matmuls: ``<ln>`` takes nothing). ``fuse_layer`` ``True``: each layer
    as ONE
    :func:`~..ops.kernels.engine_kernels.int8_mb_layer_ln` (which raises
    at shapes the layer kernel is not built for); ``False``:
    :func:`~..ops.kernels.engine_kernels.mb_layer_chain`, the per-op
    route, bit-identical to it; ``None`` (default): with the kernels the
    route the plan chose for this seq (``static.layer_route(T)``), the
    chain on the plain versions or under a mix.
    """
    mm_be, attn_be, ln_be = ENG.parse_backend(backend)
    kern = mm_be == "kernels"
    b, t, hdim = h.shape
    if fuse_layer is None:
        fuse_layer = (mm_be == attn_be == ln_be == "kernels"
                      and static.layer_route(t) == "k8")
    es = plan["entry_scal"]
    h8 = EK.quantize_payload(h.reshape(b * t, hdim), es[0, 0], es[0, 1])
    mask_bias = mask_bias.to(torch.float32).contiguous()
    layer_fn = EK.int8_mb_layer_ln if kern else EK.int8_mb_layer_ln_ref
    for i, lp in enumerate(plan["layers"]):
        kw = dict(n_heads=static.n_heads, seq=t, hidden=static.hidden,
                  attn_case=static.attn_case, activation=static.hidden_act,
                  res=static.res_quant[i], w4=static.w4[i],
                  n_ffn=static.n_ffn, skip_max=static.attn_skip_max,
                  attn_bits=static.layer_attn_bits(i))
        flat = EK.mb_layer_flat(lp, static.attn_case)
        if fuse_layer:
            h8 = layer_fn(h8, mask_bias, lp["attn_scal"], flat, **kw)
        else:
            h8 = EK.mb_layer_chain(h8, mask_bias, lp["attn_scal"], flat,
                                   plain=not kern,
                                   attn_plain=attn_be == "plain", **kw)
    ls = plan["layers"][-1]["out_bn_norm"]["scal"]
    return EK.dequantize_payload(h8, ls[0, 6], ls[0, 7]).to(
        out_dtype).reshape(b, t, hdim)


def entry_value(params: Dict, batch: Mapping, cfg: MobileBertConfig,
                qcfg: QuantModelConfig, qstate: Mapping, int_params: Dict,
                device="cuda") -> Tuple[Tensor, Tensor]:
    """The encoder engine's inputs on ``batch``: the entry-site value (B, T,
    H) and the (B, T) additive mask bias."""
    dev = B._check_device(params, device)
    with torch.no_grad():
        ctx = B.make_ctx(qcfg, qstate, QuantMode(), int_params=int_params)
        input_ids, token_type_ids, position_ids, _ = B.prepare_inputs(batch,
                                                                      dev)
        h = _embeddings(ctx, params, cfg, input_ids, token_type_ids,
                        position_ids)
        if batch.get("attention_mask") is None:
            bias = torch.zeros(input_ids.shape, device=dev)
        else:
            bias = (1.0 - B._attention_mask(batch, dev)) * -10000.0
    return h, bias


def mobilebert_engine_apply(params: Dict, batch: Mapping,
                            cfg: MobileBertConfig, qcfg: QuantModelConfig,
                            qstate: Mapping, static, plan, int_params: Dict,
                            *, backend: str = "kernels",
                            engine_dtype=torch.float32,
                            gelu_impl: str = "tanh",
                            fuse_layer: Optional[bool] = None,
                            device="cuda") -> Dict:
    """Inference through the full-handoff int8 engine: the embeddings and
    the head run through the generic site machinery, the encoder on int8
    payloads (:func:`mobilebert_encoder_engine`). ``engine_dtype`` casts
    the encoder's exit (then back to float32, as JAX's); ``gelu_impl`` is
    taken and, as in the JAX package, unused (MobileBERT's act is
    relu)."""
    h, bias = entry_value(params, batch, cfg, qcfg, qstate, int_params,
                          device=device)
    with torch.no_grad():
        ctx = B.make_ctx(qcfg, qstate, QuantMode(), int_params=int_params)
        h = mobilebert_encoder_engine(h, bias, static, plan, backend=backend,
                                      out_dtype=engine_dtype,
                                      fuse_layer=fuse_layer).to(
                                          B.exit_dtype(h))
        last = f"L{cfg.num_hidden_layers - 1}.out.bn.norm.out"
        return _classification_head(ctx, params, cfg, h, last, batch)
