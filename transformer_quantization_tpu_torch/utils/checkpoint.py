"""Checkpoint directories in the JAX package's format.

Counterpart of ``transformer_quantization_tpu/utils/checkpoint.py``. One
directory holds

- ``params.npz``: the model weights;
- ``qstate.npz``: the per-site quant state (scales, zero points,
  signedness, range state, PEG permutations, AdaRound alphas);
- ``int_params.npz``: optionally, the packed int8 / int4 payloads;
- ``manifest.json``: the model family, its config and the ``has_*``
  flags.

Arrays are stored flat under ``/``-joined tree paths: ``#i`` for a list
element, ``@QuantParams.field`` for a dataclass field, and the paths that
hold ``None`` in the object array ``__none_paths__``. Reading and writing
use numpy alone; :func:`load_checkpoint` builds the port's config and
hands the trees to ``convert.py``, so what the JAX package calibrated can
be served here, and :func:`save_checkpoint` writes what its
``load_checkpoint`` reads.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from transformer_quantization_tpu_torch import convert as C
from transformer_quantization_tpu_torch import resolve_device
from transformer_quantization_tpu_torch.models import albert as AL
from transformer_quantization_tpu_torch.models import bert as B
from transformer_quantization_tpu_torch.models import distilbert as DB
from transformer_quantization_tpu_torch.models import mobilebert as MB
from transformer_quantization_tpu_torch.models import roberta as RB
from transformer_quantization_tpu_torch.models import squeezebert as SB
from transformer_quantization_tpu_torch.quant.quantizers import QuantParams

_NONE_PATHS = "__none_paths__"

# the families the port has: manifest name -> config class
FAMILIES = {"bert": B.BertConfig, "roberta": RB.RobertaConfig,
            "mobilebert": MB.MobileBertConfig,
            "distilbert": DB.DistilBertConfig, "albert": AL.AlbertConfig,
            "squeezebert": SB.SqueezeBertConfig}


def _array(v) -> np.ndarray:
    """A leaf as numpy; int64 tensors (the port's index type) are written
    as int32, the JAX package's."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        if v.dtype == torch.int64:
            v = v.to(torch.int32)
        return v.numpy()
    return np.asarray(v)


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}#{i}/"))
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            out.update(_flatten(getattr(tree, f.name),
                                f"{prefix}@{type(tree).__name__}.{f.name}/"))
    else:
        out[prefix.rstrip("/")] = None if tree is None else _array(tree)
    return out


def _rebuild(node: Any) -> Any:
    if not isinstance(node, dict):
        return node
    keys = list(node)
    if keys and all(k.startswith("#") for k in keys):
        return [_rebuild(node[f"#{i}"]) for i in range(len(keys))]
    if keys and all(k.startswith("@") for k in keys):
        cls_name = keys[0][1:].split(".")[0]
        fields = {k.split(".", 1)[1]: _rebuild(v) for k, v in node.items()}
        return QuantParams(**fields) if cls_name == "QuantParams" else fields
    return {k: _rebuild(v) for k, v in node.items()}


def save_tree(path: str, tree: Any) -> None:
    """Write a tree of tensors / arrays to one ``.npz``."""
    flat = _flatten(tree)
    nones = [k for k, v in flat.items() if v is None]
    np.savez(path, **{_NONE_PATHS: np.asarray(nones, dtype=object)},
             **{k: v for k, v in flat.items() if v is not None})


def load_tree(path: str) -> Any:
    """Read a ``.npz`` into its nested dicts / lists of numpy arrays, with
    ``QuantParams`` nodes holding numpy fields."""
    root: Dict = {}

    def put(key, value):
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    with np.load(path, allow_pickle=True) as z:
        for k in z.files:
            if k != _NONE_PATHS:
                put(k, z[k])
        for k in z[_NONE_PATHS].tolist():
            put(k, None)
    return _rebuild(root)


def save_checkpoint(ckpt_dir: str, *, params: Any, family: str, cfg: Any,
                    qstate: Optional[Dict] = None,
                    int_params: Optional[Dict] = None,
                    extra: Optional[Dict] = None) -> None:
    """Write a checkpoint directory that the JAX package's
    ``load_checkpoint`` reads."""
    if family not in FAMILIES:
        raise NotImplementedError(f"model family {family!r} is not ported")
    os.makedirs(ckpt_dir, exist_ok=True)
    save_tree(os.path.join(ckpt_dir, "params.npz"), params)
    if qstate is not None:
        save_tree(os.path.join(ckpt_dir, "qstate.npz"), qstate)
    if int_params is not None:
        save_tree(os.path.join(ckpt_dir, "int_params.npz"), int_params)
    manifest = {
        "family": family,
        "config": dataclasses.asdict(cfg),
        "config_cls": type(cfg).__name__,
        "has_qstate": qstate is not None,
        "has_int_params": int_params is not None,
        "extra": extra or {},
        "format_version": 1,
    }
    with open(os.path.join(ckpt_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2, default=str)


def load_checkpoint(ckpt_dir: str, device="cuda") -> Dict[str, Any]:
    """Read a checkpoint directory onto ``device`` -> ``{family, cfg,
    params, qstate?, int_params?, extra}``. Raises for a family the port
    lacks. Packed int4 weights (W4A8) load as they are stored, AdaRound
    alphas as float32 tensors."""
    dev = resolve_device(device)
    with open(os.path.join(ckpt_dir, "manifest.json")) as f:
        manifest = json.load(f)
    family = manifest["family"]
    if family not in FAMILIES:
        raise NotImplementedError(f"model family {family!r} is not ported")
    out: Dict[str, Any] = {
        "family": family,
        "cfg": FAMILIES[family](**manifest["config"]),
        "params": C.params_from_jax(
            load_tree(os.path.join(ckpt_dir, "params.npz")), device=dev),
        "extra": manifest.get("extra", {}),
    }
    if manifest.get("has_qstate"):
        out["qstate"] = C.qstate_from_jax(
            load_tree(os.path.join(ckpt_dir, "qstate.npz")), device=dev)
    if manifest.get("has_int_params"):
        out["int_params"] = C.int_params_from_jax(
            load_tree(os.path.join(ckpt_dir, "int_params.npz")), device=dev)
    return out


def is_checkpoint(path: Optional[str]) -> bool:
    return bool(path) and os.path.exists(os.path.join(path, "manifest.json"))
