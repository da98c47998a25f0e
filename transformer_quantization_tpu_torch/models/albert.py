"""Quantized ALBERT for sequence classification.

Counterpart of ``transformer_quantization_tpu/models/albert.py`` (HF
``AlbertForSequenceClassification`` with one hidden group of one inner
layer, the released v2 configs):

- factorized embeddings: ``embedding_size``-wide tables, their LayerNorm,
  then ``emb_proj`` (HF ``embedding_hidden_mapping_in``) to the hidden
  size, whose input site is ``emb.ln.out`` and output site
  ``emb_proj.out`` (the engine's entry);
- ONE shared transformer layer applied ``num_hidden_layers`` times: its
  sites carry the prefix ``shared.``, so weight quantizers are shared and
  activation quantizers see every application (the JAX package's
  reading of sharing);
- ``gelu_new``; pooler dense + tanh; BERT's classifier.

Ported: the forward :func:`albert_apply` (FP32 baseline, estimate / fix
phases, the generic int8 path with ``fused_linear``, capture, and the
training forward with BERT's options), packing, the ``quant_dict``
language with its per-layer keys collapsed onto the shared sites
(:func:`apply_albert_quant_dict`), the shared PEG wiring, AdaRound specs,
and the full-handoff engine (:func:`build_albert_engine`: one plan layer
an application, every one on the shared layer's one set of int8 weights).
``scan_layers`` runs the loop: the JAX package's scan over the shared
layer (``_scan_shared_encoder``, under ``remat`` one checkpoint over its
body) carries the hidden state and the ``shared.`` sites' quant state
from each application to the next, as the loop does, and its gate
(``_can_scan_shared``) falls back to the loop wherever the two could
differ (a shared site not yet initialized, or the generic gates of
``bert.generic_scan_gates``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

import torch

from transformer_quantization_tpu_torch import resolve_device
from transformer_quantization_tpu_torch.models import bert as B
from transformer_quantization_tpu_torch.ops import engine as ENG
from transformer_quantization_tpu_torch.ops.layers import quant_linear
from transformer_quantization_tpu_torch.quant.qconfig import (
    QuantConfigBuilder,
    QuantDefaults,
    QuantModelConfig,
    QuantMode,
)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class AlbertConfig(B.BertConfig):
    vocab_size: int = 30000
    embedding_size: int = 128
    hidden_size: int = 768
    num_hidden_layers: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu_new"
    hidden_dropout_prob: float = 0.0
    attention_probs_dropout_prob: float = 0.0


def init_albert_params(cfg: AlbertConfig, seed: int = 0,
                       device="cuda") -> Dict:
    """The shared layer, pooler and classifier of a one-layer BERT from
    ``seed``; the ``embedding_size``-wide tables and ``emb_proj`` from a
    generator seeded with ``seed + 1``."""
    dev = resolve_device(device)
    base = B.init_bert_params(dataclasses.replace(cfg, num_hidden_layers=1),
                              seed, dev)
    gen = torch.Generator().manual_seed(seed + 1)
    std, e = cfg.initializer_range, cfg.embedding_size

    def table(n):
        return (std * torch.randn((n, e), generator=gen)).to(dev)

    return {
        "embeddings": {
            "word": table(cfg.vocab_size),
            "position": table(cfg.max_position_embeddings),
            "token_type": table(cfg.type_vocab_size),
            "ln": {"scale": torch.ones((e,), device=dev),
                   "bias": torch.zeros((e,), device=dev)},
        },
        "emb_proj": B.linear_init(gen, cfg.hidden_size, e, std, dev),
        "shared": base["layers"][0],
        "pooler": base["pooler"],
        "classifier": base["classifier"],
    }


def declare_albert_sites(defaults: QuantDefaults, cfg: AlbertConfig,
                         quant_setup: str = "all",
                         quant_dict: Optional[Mapping] = None
                         ) -> QuantModelConfig:
    """Embedding sites, ``emb_proj``, the one shared layer's sites (BERT's
    layer 0 under the prefix ``shared.``), pooler and classifier."""
    quant_dict = quant_dict or {}
    b = QuantConfigBuilder(defaults)
    B.declare_embedding_sites(b, quant_dict)
    b.weight("emb_proj.w")
    b.act("emb_proj.out")
    layer = QuantConfigBuilder(defaults)
    B.declare_encoder_sites(layer, 1)
    for name, site in layer.build().items():
        b._sites.append((name.replace("L0.", "shared."), site))
    b.weight("pooler.dense.w")
    b.act("pooler.dense.out")
    B.declare_classifier_site(b, "classifier", quant_setup)
    return b.build()


def apply_albert_quant_dict(qcfg: QuantModelConfig, quant_dict: Mapping,
                            n_layers: int) -> QuantModelConfig:
    """BERT's letter language over the shared layer: the per-layer keys
    (``y3``, ``L7``) collapse onto the one shared site set, each applied
    in the JAX package's order."""
    letter_site = {k: f"shared.{v}" for k, v in B.LETTER_SITE.items()}
    shared_acts = tuple(f"shared.{s[3:]}" for s in B._layer_act_sites(0))
    ordered: List[Tuple[str, Tuple[str, ...]]] = [
        ("e", ("emb.sum_tt", "emb.sum_pos")),
        ("Et", ("emb.word.w",)),
    ]
    for letter, site in letter_site.items():
        ordered += [(f"{letter}{i}", (site,)) for i in range(n_layers)]
        ordered.append((letter, (site,)))
    ordered += [(f"L{i}", shared_acts) for i in range(n_layers)]
    ordered += [
        ("L", shared_acts),
        ("P", ("pooler.dense.out",)),
        ("C", ("classifier.out",)),
        ("wP", ("pooler.dense.w",)),
        ("wC", ("classifier.w",)),
    ]
    return B._apply_ordered_quant_dict(qcfg, quant_dict, ordered)


def apply_peg_wiring(qcfg: QuantModelConfig, n_layers: int,
                     per_token: bool = False, per_embd: bool = False,
                     per_groups: Optional[int] = None,
                     permute: bool = False) -> QuantModelConfig:
    """Per-token / per-embedding / per-group wiring of the embedding sums,
    ``emb_proj.out`` and the shared layer's sites (the pooler in
    per-embedding mode)."""
    if not (per_token or per_embd or per_groups):
        return qcfg
    base_axis = 2 if (per_embd or per_groups) else 1
    changes = {"axis": base_axis, "n_groups": per_groups, "permute": permute}
    sites = ["emb.sum_tt", "emb.sum_pos", "emb.ln.out", "emb_proj.out"]
    sites += [f"shared.{s}" for s in (
        "attn.q.out", "attn.k.out", "attn.v.out", "attn.context",
        "attn_out.dense.out", "attn_out.res", "attn_out.ln.out",
        "ffn.dense.out", "ffn.res", "ffn.ln.out")]
    qcfg = qcfg.replace_sites({s: dict(changes) for s in sites})
    if per_embd:
        qcfg = qcfg.replace_site("pooler.dense.out", axis=1,
                                 n_groups=per_groups, permute=permute)
    return qcfg


def albert_weight_site_tensors(params: Dict) -> Dict[str, Tensor]:
    e, s = params["embeddings"], params["shared"]
    return {
        "emb.word.w": e["word"],
        "emb.position.w": e["position"],
        "emb.token_type.w": e["token_type"],
        "emb.ln.w": e["ln"]["scale"],
        "emb_proj.w": params["emb_proj"]["kernel"],
        "pooler.dense.w": params["pooler"]["kernel"],
        "classifier.w": params["classifier"]["kernel"],
        "shared.attn.q.w": s["attn"]["q"]["kernel"],
        "shared.attn.k.w": s["attn"]["k"]["kernel"],
        "shared.attn.v.w": s["attn"]["v"]["kernel"],
        "shared.attn_out.dense.w": s["attn_out"]["dense"]["kernel"],
        "shared.attn_out.ln.w": s["attn_out"]["ln"]["scale"],
        "shared.ffn.inter.w": s["ffn"]["inter"]["kernel"],
        "shared.ffn.dense.w": s["ffn"]["dense"]["kernel"],
        "shared.ffn.ln.w": s["ffn"]["ln"]["scale"],
    }


def albert_adaround_specs(params: Dict, cfg: AlbertConfig
                          ) -> List[Tuple[str, Dict]]:
    e, s = params["embeddings"], params["shared"]
    a, so, f = s["attn"], s["attn_out"], s["ffn"]

    def lin(d, act=None):
        return {"kind": "linear", "w": d["kernel"], "b": d["bias"],
                "act": act}

    def ln(d):
        return {"kind": "layernorm", "w": d["scale"], "b": d["bias"],
                "eps": cfg.layer_norm_eps}

    return [
        ("emb.word", {"kind": "embedding", "w": e["word"]}),
        ("emb.position", {"kind": "embedding", "w": e["position"]}),
        ("emb.token_type", {"kind": "embedding", "w": e["token_type"]}),
        ("emb.ln", ln(e["ln"])),
        ("emb_proj", lin(params["emb_proj"])),
        ("shared.attn.q", lin(a["q"])),
        ("shared.attn.k", lin(a["k"])),
        ("shared.attn.v", lin(a["v"])),
        ("shared.attn_out.dense", lin(so["dense"])),
        ("shared.attn_out.ln", ln(so["ln"])),
        ("shared.ffn.inter", lin(f["inter"], cfg.hidden_act)),
        ("shared.ffn.dense", lin(f["dense"])),
        ("shared.ffn.ln", ln(f["ln"])),
        ("pooler.dense", lin(params["pooler"], "tanh")),
        ("classifier", lin(params["classifier"])),
    ]


def build_albert_int_params(params: Dict, qcfg: QuantModelConfig,
                            qstate: Mapping, use_int4: bool = False) -> Dict:
    with torch.no_grad():
        return B.pack_int_params(albert_weight_site_tensors(params), qcfg,
                                 qstate, use_int4=use_int4)


def _embedded(ctx, params, cfg: AlbertConfig, batch: Mapping, dev,
              train=False, gen=None):
    """The factorized embeddings and ``emb_proj``: ``(h, mask_bias,
    input_ids)``, ``h`` the ``emb_proj.out`` value."""
    input_ids, token_type_ids, position_ids, mask_bias = B.prepare_inputs(
        batch, dev)
    h = B._embeddings(ctx, params, cfg, input_ids, token_type_ids,
                      position_ids, train, gen)
    h = quant_linear(ctx, "emb_proj", h, params["emb_proj"]["kernel"],
                     params["emb_proj"]["bias"], input_site="emb.ln.out")
    return h, mask_bias, input_ids


def albert_apply(params: Dict, batch: Mapping, cfg: AlbertConfig,
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
    :func:`~.bert.bert_apply`: the shared layer runs
    ``num_hidden_layers`` times in a plain loop, each application reading
    (and in the estimate phase updating) the ``shared.`` sites. ``params``
    must live on ``device``. The inference options ``compute_dtype`` /
    ``attention_dtype`` / ``int8_attention`` as :func:`~.bert.bert_apply`'s.

    ``train=True`` is the training forward, as :func:`~.bert.bert_apply`'s
    (dropout from ``dropout_generator``, ``int8_qat_sites``,
    ``compute_dtype``): every application's gradient falls on the one
    shared weight set and, under learned ranges, on the one set of
    ``shared.`` ranges. ``remat`` recomputes each application in the
    backward (:func:`~.bert.maybe_remat_layer`); ``scan_layers`` runs the
    loop (the module docstring).
    """
    del scan_layers  # the loop computes JAX's scan (the module docstring)
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
        gen = dropout_generator if train else None
        h, mask_bias, _ = _embedded(ctx, params, cfg, batch, dev, train, gen)
        mask_bias = B.compute_mask(mask_bias, compute_dtype)
        h_site = "emb_proj.out"
        for _ in range(cfg.num_hidden_layers):
            h = B.maybe_remat_layer(
                ctx, remat,
                lambda sub, p_sh, hc, g, hs=h_site: B._layer(
                    sub, p_sh, cfg, hc, mask_bias, "shared.", train, g,
                    h_site=hs),
                params["shared"], h, gen)
            h_site = "shared.ffn.ln.out"
        outputs = B._classification_head(ctx, params, cfg, h, h_site, batch,
                                         train, gen, clamp=False)
        if capture_sites:
            outputs["captures"] = ctx.captures
    return outputs, ctx.export()


def build_albert_engine(params: Dict, cfg: AlbertConfig,
                        qcfg: QuantModelConfig, qstate: Mapping,
                        int_params: Optional[Dict] = None,
                        use_int4: bool = False, device="cuda"):
    """The full-handoff engine plan: ``num_hidden_layers`` layers on the
    ``shared.`` sites (``prefixes``), entry ``emb_proj.out``. Every layer
    of the plan holds the same int8 weight tensors (one set on the
    device). Returns ``(static, plan, int_params)``."""
    B._check_device(params, device)
    n = cfg.num_hidden_layers
    with torch.no_grad():
        if int_params is None:
            int_params = build_albert_int_params(params, qcfg, qstate,
                                                 use_int4=use_int4)
        static, plan = ENG.build_encoder_plan(
            qcfg, qstate, int_params, [params["shared"]] * n,
            n_heads=cfg.num_attention_heads, ln_eps=cfg.layer_norm_eps,
            hidden_act=cfg.hidden_act, entry_site="emb_proj.out",
            prefixes=["shared."] * n)
    return static, plan, int_params


def albert_engine_apply(params: Dict, batch: Mapping, cfg: AlbertConfig,
                        qcfg: QuantModelConfig, qstate: Mapping, static, plan,
                        int_params: Dict, *, backend: str = "kernels",
                        engine_dtype=torch.float32, gelu_impl: str = "tanh",
                        device="cuda") -> Dict:
    """Inference through the full-handoff int8 engine: embeddings,
    ``emb_proj`` and the head through the generic site machinery, the
    shared layer's applications on int8 payloads; ``backend='plain'``
    runs the layers' plain versions. ``engine_dtype`` / ``gelu_impl`` as
    :func:`~.bert.bert_engine_apply`'s."""
    dev = B._check_device(params, device)
    with torch.no_grad():
        ctx = B.make_ctx(qcfg, qstate, QuantMode(), int_params=int_params)
        h, _, input_ids = _embedded(ctx, params, cfg, batch, dev)
        h = ENG.encoder_engine(h, B.engine_bias(batch, input_ids, dev),
                               static, plan, backend=backend,
                               out_dtype=engine_dtype,
                               gelu_impl=gelu_impl).to(B.exit_dtype(h))
        return B._classification_head(ctx, params, cfg, h,
                                      "shared.ffn.ln.out", batch, False,
                                      None, clamp=False)
