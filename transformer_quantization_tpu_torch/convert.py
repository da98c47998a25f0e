"""Carry the JAX package's weights and quantization state across.

Takes ``params``, ``qstate`` and ``int_params`` of
``transformer_quantization_tpu`` as nested dicts/lists of numpy arrays
(the caller does the ``np.asarray`` on the JAX side, e.g. with
``jax.tree.map(np.asarray, tree)``, which keeps each ``QuantParams``
with numpy ``delta`` / ``zero_float`` / ``signed``) and builds the port's
counterparts on ``device``. Both packages keep kernels in the ``(out,
in)`` layout and the same nesting for every family (ALBERT's ``shared``
layer and ``emb_proj``, SqueezeBERT's ``(out, in/groups)`` kernels), so
this is a re-nesting into tensors.
QAT state comes across too: the ``learnable`` / ``rest`` split of
``training/qat.py`` (``rest`` holding a learned site's ``qp_signed``) and
a JAX train state's params and ranges, and AdaRound's rounding logits
(``alpha``, float32). Imports no JAX.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from transformer_quantization_tpu_torch import resolve_device
from transformer_quantization_tpu_torch.quant.quantizers import QuantParams


def _tensor(x, dev):
    # np.array copies into a contiguous array of the same rank (0-d stays
    # 0-d, which np.ascontiguousarray would make 1-d)
    return torch.from_numpy(np.array(x)).to(dev)


def params_from_jax(params, device="cuda"):
    """Nested dict/list of arrays -> the same nesting of tensors."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, Mapping):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        return _tensor(x, dev)

    return conv(params)


def qparams_from_jax(qp, device="cuda") -> QuantParams:
    dev = resolve_device(device)
    return QuantParams(
        delta=_tensor(qp.delta, dev).to(torch.float32),
        zero_float=_tensor(qp.zero_float, dev).to(torch.float32),
        signed=_tensor(qp.signed, dev).to(torch.float32))


def _site_from_jax(st: Mapping, dev) -> Dict:
    new = {}
    if st.get("qp") is not None:
        new["qp"] = qparams_from_jax(st["qp"], dev)
    if st.get("qp_signed") is not None:
        new["qp_signed"] = _tensor(st["qp_signed"], dev).to(torch.float32)
    if "alpha" in st:
        new["alpha"] = (None if st["alpha"] is None
                        else _tensor(st["alpha"], dev).to(torch.float32))
    if st.get("range_state") is not None:
        new["range_state"] = {k: _tensor(v, dev)
                              for k, v in st["range_state"].items()}
    if st.get("perm") is not None:
        new["perm"] = _tensor(st["perm"], dev).to(torch.int64)
    if st.get("ranges") is not None:
        new["ranges"] = _tensor(st["ranges"], dev).to(torch.float32)
    return new


def qstate_from_jax(qstate: Mapping, device="cuda") -> Dict:
    """Per-site state: ``qp`` becomes a :class:`QuantParams`, the
    ``range_state`` dict its tensors, a PEG site's ``perm`` an int64 and
    its ``ranges`` a float32 tensor, an AdaRound ``alpha`` a float32
    tensor.
    The ``rest`` of a QAT split (``qp_signed`` for a learned site's
    ``qp``) converts the same way."""
    dev = resolve_device(device)
    return {name: _site_from_jax(st, dev) for name, st in qstate.items()}


def learnable_from_jax(learnable: Mapping, device="cuda") -> Dict:
    """``{site: {'delta', 'zero_float'}}`` (JAX ``split_learnable_ranges``)
    -> float32 tensors."""
    dev = resolve_device(device)
    return {name: {k: _tensor(v, dev).to(torch.float32)
                   for k, v in st.items()}
            for name, st in learnable.items()}


def train_state_from_jax(model_tree: Mapping, device="cuda"):
    """A JAX train state's weights and ranges, its ``<path>.model.npz``
    tree (read with ``utils/checkpoint.py`` ``load_tree``) -> ``(params,
    learnable, rest)`` on ``device``. The optimizer state stays behind:
    its leaves are optax's."""
    return (params_from_jax(model_tree["params"], device),
            learnable_from_jax(model_tree.get("learnable") or {}, device),
            qstate_from_jax(model_tree.get("rest") or {}, device))


def int_params_from_jax(int_params: Mapping, device="cuda") -> Dict:
    """Packed int8 / split-half int4 weights and tables -> tensors (int8
    stays int8, packed int4 uint8, scales and column sums float32,
    ``n_bits`` and ``in_features`` ints)."""
    dev = resolve_device(device)
    out = {}
    for name, p in int_params.items():
        out[name] = {k: (int(v) if k in ("n_bits", "in_features")
                         else _tensor(v, dev))
                     for k, v in p.items()}
    return out
