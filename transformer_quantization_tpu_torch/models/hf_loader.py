"""Hugging Face checkpoint directories, read from local disk.

Counterpart of ``transformer_quantization_tpu/models/hf_loader.py``: a
directory holding ``config.json`` and ``model.safetensors`` or
``pytorch_model.bin`` becomes the family's config and parameter tree on
``device``, kernels kept in the ``(out, in)`` layout, for BERT, RoBERTa,
MobileBERT, DistilBERT, ALBERT and SqueezeBERT.

Nothing is fetched: :func:`resolve_model_dir` takes local directories
only. The port needs neither ``safetensors`` nor ``transformers``:
:func:`read_safetensors` reads the format itself (an 8-byte little-endian
header length, a JSON header of names, dtypes, shapes and byte offsets,
then the raw little-endian data), and ``pytorch_model.bin`` loads with
``torch.load(weights_only=True)``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from transformer_quantization_tpu_torch import resolve_device
from transformer_quantization_tpu_torch.models import albert as AL
from transformer_quantization_tpu_torch.models import bert as B
from transformer_quantization_tpu_torch.models import distilbert as DB
from transformer_quantization_tpu_torch.models import mobilebert as MB
from transformer_quantization_tpu_torch.models import roberta as RB
from transformer_quantization_tpu_torch.models import squeezebert as SB

# safetensors dtype names -> little-endian numpy dtypes ("BF16" is read as
# its 16-bit pattern and widened to float32, exactly)
_ST_DTYPES = {"F64": "<f8", "F32": "<f4", "F16": "<f2", "BF16": "<u2",
              "I64": "<i8", "I32": "<i4", "I16": "<i2", "I8": "i1",
              "U8": "u1", "BOOL": "?"}


def resolve_model_dir(name_or_dir: str, *, allow_hub: bool = False,
                      revision: Optional[str] = None,
                      cache_dir: Optional[str] = None) -> str:
    """A local checkpoint directory passes through. Anything else raises:
    the JAX package's ``allow_hub`` resolves a hub repo id through
    ``huggingface_hub``, which the port does not use."""
    if os.path.isdir(name_or_dir):
        return name_or_dir
    if allow_hub:
        raise NotImplementedError(
            f"{name_or_dir!r}: resolving a Hugging Face hub repo id needs "
            "huggingface_hub, which the port does not use; download the "
            "checkpoint directory and pass its path")
    raise FileNotFoundError(f"{name_or_dir!r} is not a local checkpoint "
                            "directory")


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """Every tensor of a ``.safetensors`` file as a numpy array (BF16
    widened to float32)."""
    with open(path, "rb") as f:
        data = f.read()
    n = int.from_bytes(data[:8], "little")
    header = json.loads(data[8:8 + n])
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = info["dtype"]
        if dtype not in _ST_DTYPES:
            raise ValueError(f"{path}: {name} has dtype {dtype}, which the "
                             "reader does not take")
        begin, end = info["data_offsets"]
        dt = np.dtype(_ST_DTYPES[dtype])
        a = np.frombuffer(data, dtype=dt, count=(end - begin) // dt.itemsize,
                          offset=base + begin)
        if dtype == "BF16":
            a = (a.astype(np.uint32) << 16).view(np.float32)
        out[name] = a.reshape(info["shape"]).copy()
    return out


def load_hf_state_dict(model_dir: str) -> Dict[str, np.ndarray]:
    """A local HF checkpoint's tensors as ``{name: np.ndarray}``:
    ``model.safetensors`` first, else ``pytorch_model.bin``."""
    st_path = os.path.join(model_dir, "model.safetensors")
    pt_path = os.path.join(model_dir, "pytorch_model.bin")
    if os.path.exists(st_path):
        return read_safetensors(st_path)
    if os.path.exists(pt_path):
        sd = torch.load(pt_path, map_location="cpu", weights_only=True)
        return {k: (v.float() if v.dtype == torch.bfloat16 else v).numpy()
                for k, v in sd.items()}
    raise FileNotFoundError(f"no checkpoint found under {model_dir}")


def _hf_config(model_dir: str) -> Dict:
    with open(os.path.join(model_dir, "config.json")) as f:
        return json.load(f)


def _labels(hf: Dict, num_labels: Optional[int]) -> int:
    return num_labels or len(hf.get("id2label", {0: 0, 1: 1}))


def _t(a: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(dev)


def _lin(sd, prefix, dev) -> Dict:
    return {"kernel": _t(sd[prefix + ".weight"], dev),
            "bias": _t(sd[prefix + ".bias"], dev)}


def _ln(sd, prefix, dev) -> Dict:
    return {"scale": _t(sd[prefix + ".weight"], dev),
            "bias": _t(sd[prefix + ".bias"], dev)}


def _nonorm(sd, prefix, dev) -> Dict:
    return {"weight": _t(sd[prefix + ".weight"], dev),
            "bias": _t(sd[prefix + ".bias"], dev)}


def _strip_model(sd: Dict) -> Dict:
    return {k[len("model."):] if k.startswith("model.") else k: v
            for k, v in sd.items()}


def _bert_layer(sd, p: str, dev) -> Dict:
    return {
        "attn": {"q": _lin(sd, f"{p}.attention.self.query", dev),
                 "k": _lin(sd, f"{p}.attention.self.key", dev),
                 "v": _lin(sd, f"{p}.attention.self.value", dev)},
        "attn_out": {"dense": _lin(sd, f"{p}.attention.output.dense", dev),
                     "ln": _ln(sd, f"{p}.attention.output.LayerNorm", dev)},
        "ffn": {"inter": _lin(sd, f"{p}.intermediate.dense", dev),
                "dense": _lin(sd, f"{p}.output.dense", dev),
                "ln": _ln(sd, f"{p}.output.LayerNorm", dev)},
    }


def _bert_encoder(sd, cfg, backbone: str, dev) -> Dict:
    """Embeddings and layers of a BERT-shaped HF backbone."""
    e = f"{backbone}.embeddings"
    return {
        "embeddings": {
            "word": _t(sd[f"{e}.word_embeddings.weight"], dev),
            "position": _t(sd[f"{e}.position_embeddings.weight"], dev),
            "token_type": _t(sd[f"{e}.token_type_embeddings.weight"], dev),
            "ln": _ln(sd, f"{e}.LayerNorm", dev),
        },
        "layers": [_bert_layer(sd, f"{backbone}.encoder.layer.{i}", dev)
                   for i in range(cfg.num_hidden_layers)],
    }


# ---------------------------------------------------------------------------
# BERT
# ---------------------------------------------------------------------------


def load_bert_config(model_dir: str, num_labels: Optional[int] = None
                     ) -> B.BertConfig:
    hf = _hf_config(model_dir)
    return B.BertConfig(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        num_hidden_layers=hf["num_hidden_layers"],
        num_attention_heads=hf["num_attention_heads"],
        intermediate_size=hf["intermediate_size"],
        max_position_embeddings=hf["max_position_embeddings"],
        type_vocab_size=hf.get("type_vocab_size", 2),
        hidden_dropout_prob=hf.get("hidden_dropout_prob", 0.1),
        attention_probs_dropout_prob=hf.get("attention_probs_dropout_prob",
                                            0.1),
        layer_norm_eps=hf.get("layer_norm_eps", 1e-12),
        num_labels=_labels(hf, num_labels),
    )


def bert_params_from_state_dict(sd: Dict[str, np.ndarray], cfg,
                                device="cuda") -> Dict:
    """HF ``BertForSequenceClassification`` names onto the port's tree."""
    dev = resolve_device(device)
    sd = _strip_model(sd)
    return dict(_bert_encoder(sd, cfg, "bert", dev),
                pooler=_lin(sd, "bert.pooler.dense", dev),
                classifier=_lin(sd, "classifier", dev))


def load_bert(model_dir: str, num_labels: Optional[int] = None,
              device="cuda") -> Tuple[B.BertConfig, Dict]:
    cfg = load_bert_config(model_dir, num_labels)
    return cfg, bert_params_from_state_dict(load_hf_state_dict(model_dir),
                                            cfg, device)


# ---------------------------------------------------------------------------
# RoBERTa
# ---------------------------------------------------------------------------


def load_roberta_config(model_dir: str, num_labels: Optional[int] = None
                        ) -> RB.RobertaConfig:
    hf = _hf_config(model_dir)
    return RB.RobertaConfig(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        num_hidden_layers=hf["num_hidden_layers"],
        num_attention_heads=hf["num_attention_heads"],
        intermediate_size=hf["intermediate_size"],
        max_position_embeddings=hf["max_position_embeddings"],
        type_vocab_size=hf.get("type_vocab_size", 1),
        hidden_dropout_prob=hf.get("hidden_dropout_prob", 0.1),
        attention_probs_dropout_prob=hf.get("attention_probs_dropout_prob",
                                            0.1),
        layer_norm_eps=hf.get("layer_norm_eps", 1e-5),
        pad_token_id=hf.get("pad_token_id", 1),
        num_labels=_labels(hf, num_labels),
    )


def roberta_params_from_state_dict(sd: Dict[str, np.ndarray], cfg,
                                   device="cuda") -> Dict:
    """HF ``RobertaForSequenceClassification`` names: no pooler, the
    two-layer head ``classifier.dense`` / ``classifier.out_proj``."""
    dev = resolve_device(device)
    sd = _strip_model(sd)
    return dict(_bert_encoder(sd, cfg, "roberta", dev), classifier={
        "dense": _lin(sd, "classifier.dense", dev),
        "out_proj": _lin(sd, "classifier.out_proj", dev)})


def load_roberta(model_dir: str, num_labels: Optional[int] = None,
                 device="cuda") -> Tuple[RB.RobertaConfig, Dict]:
    cfg = load_roberta_config(model_dir, num_labels)
    return cfg, roberta_params_from_state_dict(
        load_hf_state_dict(model_dir), cfg, device)


# ---------------------------------------------------------------------------
# MobileBERT
# ---------------------------------------------------------------------------


def load_mobilebert_config(model_dir: str, num_labels: Optional[int] = None
                           ) -> MB.MobileBertConfig:
    hf = _hf_config(model_dir)
    return MB.MobileBertConfig(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        num_hidden_layers=hf["num_hidden_layers"],
        num_attention_heads=hf["num_attention_heads"],
        intermediate_size=hf["intermediate_size"],
        embedding_size=hf.get("embedding_size", 128),
        intra_bottleneck_size=hf.get("intra_bottleneck_size", 128),
        num_feedforward_networks=hf.get("num_feedforward_networks", 4),
        use_bottleneck=hf.get("use_bottleneck", True),
        use_bottleneck_attention=hf.get("use_bottleneck_attention", False),
        key_query_shared_bottleneck=hf.get("key_query_shared_bottleneck",
                                           True),
        trigram_input=hf.get("trigram_input", True),
        hidden_act=hf.get("hidden_act", "relu"),
        classifier_activation=hf.get("classifier_activation", False),
        max_position_embeddings=hf["max_position_embeddings"],
        type_vocab_size=hf.get("type_vocab_size", 2),
        hidden_dropout_prob=hf.get("hidden_dropout_prob", 0.0),
        attention_probs_dropout_prob=hf.get("attention_probs_dropout_prob",
                                            0.1),
        num_labels=_labels(hf, num_labels),
    )


def mobilebert_params_from_state_dict(sd: Dict[str, np.ndarray], cfg,
                                      device="cuda") -> Dict:
    """HF ``MobileBertForSequenceClassification`` names onto the port's
    tree; the pooler's dense is None where the checkpoint has none
    (``classifier_activation`` off)."""
    dev = resolve_device(device)
    sd = _strip_model(sd)
    e = "mobilebert.embeddings"
    params: Dict = {
        "embeddings": {
            "word": _t(sd[f"{e}.word_embeddings.weight"], dev),
            "position": _t(sd[f"{e}.position_embeddings.weight"], dev),
            "token_type": _t(sd[f"{e}.token_type_embeddings.weight"], dev),
            "transform": _lin(sd, f"{e}.embedding_transformation", dev),
            "norm": _nonorm(sd, f"{e}.LayerNorm", dev),
        },
        "layers": [],
        "pooler": (_lin(sd, "mobilebert.pooler.dense", dev)
                   if "mobilebert.pooler.dense.weight" in sd
                   else {"kernel": None, "bias": None}),
        "classifier": _lin(sd, "classifier", dev),
    }
    for i in range(cfg.num_hidden_layers):
        p = f"mobilebert.encoder.layer.{i}"
        layer: Dict = {
            "attn": {"q": _lin(sd, f"{p}.attention.self.query", dev),
                     "k": _lin(sd, f"{p}.attention.self.key", dev),
                     "v": _lin(sd, f"{p}.attention.self.value", dev)},
            "attn_out": {
                "dense": _lin(sd, f"{p}.attention.output.dense", dev),
                "norm": _nonorm(sd, f"{p}.attention.output.LayerNorm", dev)},
            "inter": _lin(sd, f"{p}.intermediate.dense", dev),
            "out": {"dense": _lin(sd, f"{p}.output.dense", dev),
                    "norm": _nonorm(sd, f"{p}.output.LayerNorm", dev)},
        }
        if cfg.use_bottleneck:
            bn = f"{p}.bottleneck"
            layer["bottleneck"] = {"input": {
                "dense": _lin(sd, f"{bn}.input.dense", dev),
                "norm": _nonorm(sd, f"{bn}.input.LayerNorm", dev)}}
            if cfg.has_shared_kq_bottleneck:
                layer["bottleneck"]["attention"] = {
                    "dense": _lin(sd, f"{bn}.attention.dense", dev),
                    "norm": _nonorm(sd, f"{bn}.attention.LayerNorm", dev)}
            layer["out"]["bn_dense"] = _lin(
                sd, f"{p}.output.bottleneck.dense", dev)
            layer["out"]["bn_norm"] = _nonorm(
                sd, f"{p}.output.bottleneck.LayerNorm", dev)
        layer["ffn"] = [{
            "inter": _lin(sd, f"{p}.ffn.{j}.intermediate.dense", dev),
            "dense": _lin(sd, f"{p}.ffn.{j}.output.dense", dev),
            "norm": _nonorm(sd, f"{p}.ffn.{j}.output.LayerNorm", dev),
        } for j in range(cfg.num_stacked_ffn)]
        params["layers"].append(layer)
    return params


def load_mobilebert(model_dir: str, num_labels: Optional[int] = None,
                    device="cuda") -> Tuple[MB.MobileBertConfig, Dict]:
    cfg = load_mobilebert_config(model_dir, num_labels)
    return cfg, mobilebert_params_from_state_dict(
        load_hf_state_dict(model_dir), cfg, device)


# ---------------------------------------------------------------------------
# ALBERT
# ---------------------------------------------------------------------------


def load_albert_config(model_dir: str, num_labels: Optional[int] = None
                       ) -> AL.AlbertConfig:
    """One hidden group of one inner layer (the released v2 configs);
    anything else raises."""
    hf = _hf_config(model_dir)
    if hf.get("num_hidden_groups", 1) != 1 or hf.get("inner_group_num",
                                                     1) != 1:
        raise NotImplementedError(
            f"{model_dir}: ALBERT with {hf.get('num_hidden_groups')} hidden "
            f"groups of {hf.get('inner_group_num')} layers; the family takes "
            "one group of one layer")
    return AL.AlbertConfig(
        vocab_size=hf["vocab_size"],
        embedding_size=hf.get("embedding_size", 128),
        hidden_size=hf["hidden_size"],
        num_hidden_layers=hf["num_hidden_layers"],
        num_attention_heads=hf["num_attention_heads"],
        intermediate_size=hf["intermediate_size"],
        max_position_embeddings=hf["max_position_embeddings"],
        type_vocab_size=hf.get("type_vocab_size", 2),
        hidden_dropout_prob=hf.get("hidden_dropout_prob", 0.0),
        attention_probs_dropout_prob=hf.get("attention_probs_dropout_prob",
                                            0.0),
        layer_norm_eps=hf.get("layer_norm_eps", 1e-12),
        hidden_act=hf.get("hidden_act", "gelu_new"),
        num_labels=_labels(hf, num_labels),
    )


def albert_params_from_state_dict(sd: Dict[str, np.ndarray], cfg,
                                  device="cuda") -> Dict:
    """HF ``AlbertForSequenceClassification`` names: the factorized
    embeddings, ``embedding_hidden_mapping_in`` as ``emb_proj``, the one
    shared layer, pooler and classifier."""
    dev = resolve_device(device)
    sd = _strip_model(sd)
    e = "albert.embeddings"
    lyr = "albert.encoder.albert_layer_groups.0.albert_layers.0"
    return {
        "embeddings": {
            "word": _t(sd[f"{e}.word_embeddings.weight"], dev),
            "position": _t(sd[f"{e}.position_embeddings.weight"], dev),
            "token_type": _t(sd[f"{e}.token_type_embeddings.weight"], dev),
            "ln": _ln(sd, f"{e}.LayerNorm", dev),
        },
        "emb_proj": _lin(sd, "albert.encoder.embedding_hidden_mapping_in",
                         dev),
        "shared": {
            "attn": {"q": _lin(sd, f"{lyr}.attention.query", dev),
                     "k": _lin(sd, f"{lyr}.attention.key", dev),
                     "v": _lin(sd, f"{lyr}.attention.value", dev)},
            "attn_out": {"dense": _lin(sd, f"{lyr}.attention.dense", dev),
                         "ln": _ln(sd, f"{lyr}.attention.LayerNorm", dev)},
            "ffn": {"inter": _lin(sd, f"{lyr}.ffn", dev),
                    "dense": _lin(sd, f"{lyr}.ffn_output", dev),
                    "ln": _ln(sd, f"{lyr}.full_layer_layer_norm", dev)},
        },
        "pooler": _lin(sd, "albert.pooler", dev),
        "classifier": _lin(sd, "classifier", dev),
    }


def load_albert(model_dir: str, num_labels: Optional[int] = None,
                device="cuda") -> Tuple[AL.AlbertConfig, Dict]:
    cfg = load_albert_config(model_dir, num_labels)
    return cfg, albert_params_from_state_dict(
        load_hf_state_dict(model_dir), cfg, device)


# ---------------------------------------------------------------------------
# SqueezeBERT
# ---------------------------------------------------------------------------


def load_squeezebert_config(model_dir: str, num_labels: Optional[int] = None
                            ) -> SB.SqueezeBertConfig:
    hf = _hf_config(model_dir)
    return SB.SqueezeBertConfig(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        num_hidden_layers=hf["num_hidden_layers"],
        num_attention_heads=hf["num_attention_heads"],
        intermediate_size=hf["intermediate_size"],
        max_position_embeddings=hf["max_position_embeddings"],
        type_vocab_size=hf.get("type_vocab_size", 2),
        hidden_dropout_prob=hf.get("hidden_dropout_prob", 0.1),
        attention_probs_dropout_prob=hf.get("attention_probs_dropout_prob",
                                            0.1),
        layer_norm_eps=hf.get("layer_norm_eps", 1e-12),
        hidden_act=hf.get("hidden_act", "gelu"),
        q_groups=hf.get("q_groups", 4),
        k_groups=hf.get("k_groups", 4),
        v_groups=hf.get("v_groups", 4),
        post_attention_groups=hf.get("post_attention_groups", 1),
        intermediate_groups=hf.get("intermediate_groups", 4),
        output_groups=hf.get("output_groups", 4),
        num_labels=_labels(hf, num_labels),
    )


def squeezebert_params_from_state_dict(sd: Dict[str, np.ndarray], cfg,
                                       device="cuda") -> Dict:
    """HF ``SqueezeBertForSequenceClassification`` names (root
    ``transformer`` or ``squeezebert``); the kernel-size-1 conv weights
    ``(O, I/g, 1)`` squeeze to the grouped ``(O, I/g)`` kernels."""
    dev = resolve_device(device)
    sd = _strip_model(sd)
    root = ("transformer" if "transformer.embeddings.word_embeddings.weight"
            in sd else "squeezebert")
    e = f"{root}.embeddings"

    def conv(prefix):
        return {"kernel": _t(sd[prefix + ".weight"], dev).squeeze(-1),
                "bias": _t(sd[prefix + ".bias"], dev)}

    layers = []
    for i in range(cfg.num_hidden_layers):
        p = f"{root}.encoder.layers.{i}"
        layers.append({
            "attn": {"q": conv(f"{p}.attention.query"),
                     "k": conv(f"{p}.attention.key"),
                     "v": conv(f"{p}.attention.value")},
            "attn_out": {"dense": conv(f"{p}.post_attention.conv1d"),
                         "ln": _ln(sd, f"{p}.post_attention.layernorm", dev)},
            "ffn": {"inter": conv(f"{p}.intermediate.conv1d"),
                    "dense": conv(f"{p}.output.conv1d"),
                    "ln": _ln(sd, f"{p}.output.layernorm", dev)},
        })
    return {
        "embeddings": {
            "word": _t(sd[f"{e}.word_embeddings.weight"], dev),
            "position": _t(sd[f"{e}.position_embeddings.weight"], dev),
            "token_type": _t(sd[f"{e}.token_type_embeddings.weight"], dev),
            "ln": _ln(sd, f"{e}.LayerNorm", dev),
        },
        "layers": layers,
        "pooler": _lin(sd, f"{root}.pooler.dense", dev),
        "classifier": _lin(sd, "classifier", dev),
    }


def load_squeezebert(model_dir: str, num_labels: Optional[int] = None,
                     device="cuda") -> Tuple[SB.SqueezeBertConfig, Dict]:
    cfg = load_squeezebert_config(model_dir, num_labels)
    return cfg, squeezebert_params_from_state_dict(
        load_hf_state_dict(model_dir), cfg, device)


# ---------------------------------------------------------------------------
# DistilBERT
# ---------------------------------------------------------------------------


def load_distilbert_config(model_dir: str, num_labels: Optional[int] = None
                           ) -> DB.DistilBertConfig:
    hf = _hf_config(model_dir)
    return DB.DistilBertConfig(
        vocab_size=hf["vocab_size"],
        hidden_size=hf.get("dim", 768),
        num_hidden_layers=hf.get("n_layers", 6),
        num_attention_heads=hf.get("n_heads", 12),
        intermediate_size=hf.get("hidden_dim", 3072),
        max_position_embeddings=hf.get("max_position_embeddings", 512),
        hidden_dropout_prob=hf.get("dropout", 0.1),
        attention_probs_dropout_prob=hf.get("attention_dropout", 0.1),
        num_labels=_labels(hf, num_labels),
    )


def distilbert_params_from_state_dict(sd: Dict[str, np.ndarray], cfg,
                                      device="cuda") -> Dict:
    """HF ``DistilBertForSequenceClassification`` names
    (``distilbert.transformer.layer.{i}``: q_lin / k_lin / v_lin /
    out_lin, sa_layer_norm, ffn.lin1 / lin2, output_layer_norm); a zero
    token-type table; the head pre_classifier + classifier."""
    dev = resolve_device(device)
    sd = _strip_model(sd)
    e = "distilbert.embeddings"
    layers = []
    for i in range(cfg.num_hidden_layers):
        p = f"distilbert.transformer.layer.{i}"
        layers.append({
            "attn": {"q": _lin(sd, f"{p}.attention.q_lin", dev),
                     "k": _lin(sd, f"{p}.attention.k_lin", dev),
                     "v": _lin(sd, f"{p}.attention.v_lin", dev)},
            "attn_out": {"dense": _lin(sd, f"{p}.attention.out_lin", dev),
                         "ln": _ln(sd, f"{p}.sa_layer_norm", dev)},
            "ffn": {"inter": _lin(sd, f"{p}.ffn.lin1", dev),
                    "dense": _lin(sd, f"{p}.ffn.lin2", dev),
                    "ln": _ln(sd, f"{p}.output_layer_norm", dev)},
        })
    return {
        "embeddings": {
            "word": _t(sd[f"{e}.word_embeddings.weight"], dev),
            "position": _t(sd[f"{e}.position_embeddings.weight"], dev),
            "token_type": torch.zeros((1, cfg.hidden_size), device=dev),
            "ln": _ln(sd, f"{e}.LayerNorm", dev),
        },
        "layers": layers,
        "classifier": {"pre": _lin(sd, "pre_classifier", dev),
                       "out": _lin(sd, "classifier", dev)},
    }


def load_distilbert(model_dir: str, num_labels: Optional[int] = None,
                    device="cuda") -> Tuple[DB.DistilBertConfig, Dict]:
    cfg = load_distilbert_config(model_dir, num_labels)
    return cfg, distilbert_params_from_state_dict(
        load_hf_state_dict(model_dir), cfg, device)


# the loader of each family, by the registry's family name
LOADERS = {"bert": load_bert, "roberta": load_roberta,
           "mobilebert": load_mobilebert, "distilbert": load_distilbert,
           "albert": load_albert, "squeezebert": load_squeezebert}
