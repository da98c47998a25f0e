"""Quantization-aware training.

Counterpart of ``transformer_quantization_tpu/training/qat.py``:

- ``learn_ranges`` (LSQ): every initialized, enabled site's ``delta`` and
  ``zero_float`` are split out of the quant state (:func:`split_learnable_
  ranges`) and trained beside the weights; packed into one flat float32
  tensor (:func:`ravel_ranges`, JAX's ``ravel_pytree`` order: sites sorted
  by name, ``delta`` before ``zero_float``), so clipping and Adam see them
  as one leaf. The ``signed`` flag stays in ``rest`` as ``qp_signed``.
  Symmetric quantizers get no ``zero_float`` gradient.
- estimate-ranges training: ranges re-estimated from data each step
  (``Phase.estimate``), per kind frozen by ``fix_weight_ranges`` /
  ``fix_act_ranges``.

Gradients reach float32 master weights through the straight-through
estimator and the ranges through the scale / zero-point arithmetic
(``quant/quantizers.py`` ``FakeQuant``, ``training/int8_qat.py``).
:func:`make_qat_train_step` is a plain step function (no jit, no
donation).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, List, Optional, Tuple

import torch

from transformer_quantization_tpu_torch.quant.qconfig import (
    Phase,
    QuantModelConfig,
    QuantMode,
)
from transformer_quantization_tpu_torch.quant.quantizers import QuantParams
from transformer_quantization_tpu_torch.training import optim as O

Tensor = torch.Tensor


def split_learnable_ranges(qcfg: QuantModelConfig, qstate: Dict
                           ) -> Tuple[Dict, Dict]:
    """``(learnable, rest)``: ``learnable[site] = {'delta', 'zero_float'}``
    for every initialized, enabled site; ``rest`` the remaining state, the
    learnable sites' ``signed`` flag as ``qp_signed``."""
    learnable, rest = {}, {}
    for name, st in qstate.items():
        if name in qcfg and qcfg[name].enabled and "qp" in st:
            qp = st["qp"]
            learnable[name] = {"delta": qp.delta, "zero_float": qp.zero_float}
            rest[name] = dict({k: v for k, v in st.items() if k != "qp"},
                              qp_signed=qp.signed)
        else:
            rest[name] = st
    return learnable, rest


def merge_learnable_ranges(learnable: Dict, rest: Dict) -> Dict:
    """Inverse of :func:`split_learnable_ranges`: a quant state."""
    out = {}
    for name, st in rest.items():
        if name in learnable:
            st = {k: v for k, v in st.items() if k != "qp_signed"}
            out[name] = dict(st, qp=QuantParams(
                delta=learnable[name]["delta"],
                zero_float=learnable[name]["zero_float"],
                signed=rest[name]["qp_signed"]))
        else:
            out[name] = st
    return out


def ravel_ranges(learnable: Dict) -> Tuple[Tensor, Callable]:
    """``(flat, unravel)``: the learnable ranges as one float32 vector in
    ``ravel_pytree``'s order, and the function that cuts a vector of that
    layout back into the ``learnable`` nesting (views, so gradients reach
    the vector)."""
    order = [(site, k, learnable[site][k].shape)
             for site in sorted(learnable) for k in ("delta", "zero_float")]
    if not order:
        return torch.zeros((0,)), lambda flat: {}
    flat = torch.cat([learnable[s][k].reshape(-1).to(torch.float32)
                      for s, k, _ in order])
    sizes = [torch.Size(shape).numel() for _, _, shape in order]

    def unravel(vec: Tensor) -> Dict:
        out: Dict = {}
        for (s, k, shape), piece in zip(order, torch.split(vec, sizes)):
            out.setdefault(s, {})[k] = piece.reshape(shape)
        return out
    return flat, unravel


@dataclasses.dataclass(frozen=True)
class QATConfig:
    """QAT options (the JAX ``QATConfig``). ``int8_sites``: the layers
    whose fake-quant matmul runs on int8 payloads
    (:func:`int8_forward_sites`); None / empty keeps the float fake-quant
    matmuls. ``compute_dtype`` (e.g. ``"bfloat16"``, the CLI's ``--amp``)
    runs the step's activations and matmuls in that dtype over float32
    master weights; range math, statistics, loss and optimizer stay
    float32. ``remat`` recomputes each encoder layer in the backward;
    ``scan_layers`` is passed to the forward, which runs its loop
    (``models/bert.py`` ``bert_apply``). ``pp_mesh`` is not yet ported
    (ROADMAP §1 item 9) and raises in :func:`make_qat_train_step`."""

    learn_ranges: bool = False
    fix_weight_ranges: bool = False
    fix_act_ranges: bool = False
    learning_rate: float = 5e-5
    range_learning_rate: Optional[float] = None  # None -> same as lr
    weight_decay: float = 0.0
    compute_dtype: Optional[str] = None
    remat: bool = False
    scan_layers: bool = False
    pp_mesh: object = None
    int8_sites: Optional[frozenset] = None


def check_ported(qat: QATConfig) -> None:
    """Raise for the QATConfig options the port lacks."""
    if qat.pp_mesh is not None:
        raise NotImplementedError(
            "QATConfig.pp_mesh is not yet ported (ROADMAP §1 item 9)")


def forward_options(qat: QATConfig) -> Dict:
    """The forward's keyword options for ``qat`` (the JAX
    ``make_qat_train_step``'s ``extra``)."""
    extra: Dict = {}
    if qat.compute_dtype is not None:
        extra["compute_dtype"] = getattr(torch, qat.compute_dtype)
    if qat.remat:
        extra["remat"] = True
    if qat.scan_layers:
        extra["scan_layers"] = True
    if qat.int8_sites:
        extra["int8_qat_sites"] = qat.int8_sites
    return extra


def int8_forward_sites(qcfg: QuantModelConfig, qstate: Dict) -> frozenset:
    """Layers whose QAT fake-quant matmul can run on int8 payloads:
    enabled symmetric linear-domain weight sites of up to 8 bits on a
    signed grid (the flag the calibration inferred from the data), with
    no AdaRound ``alpha`` and per-channel params exactly where the site
    is per-channel; plus ``L.<suffix>`` for a suffix eligible in every
    layer (the JAX scan-layers naming). The input-site conditions are
    checked in ``ops/layers.py`` ``_int8_qat_matmul``."""
    out = set()
    for name, c in qcfg.items():
        if c.kind != "weight" or not name.endswith(".w") or not c.enabled:
            continue
        if (not c.spec.symmetric or c.spec.scale_domain != "linear"
                or c.spec.n_bits > 8):
            continue
        st = qstate.get(name)
        if st is None or st.get("alpha") is not None:
            continue
        qp = st["qp"]
        if float(qp.signed) != 1.0:
            continue
        if c.per_channel != (qp.delta.ndim == 1):
            continue
        out.add(name[:-len(".w")])
    layer_ids = {int(m.group(1)) for n, _ in qcfg.items()
                 if (m := re.match(r"^L(\d+)\.", n))}
    suffixes = {n[n.index(".") + 1:] for n in out if re.match(r"^L\d+\.", n)}
    for suf in suffixes:
        if all(f"L{i}.{suf}" in out for i in layer_ids):
            out.add(f"L.{suf}")
    return frozenset(out)


def qat_mode(qat: QATConfig, weight_quant: bool = True,
             act_quant: bool = True) -> QuantMode:
    """The train step's QuantMode: ``learn`` for both kinds with
    ``learn_ranges``, else ``estimate`` unless fixed."""
    if qat.learn_ranges:
        return QuantMode(weight_quant=weight_quant, act_quant=act_quant,
                         weight_phase=Phase.learn, act_phase=Phase.learn)
    return QuantMode(
        weight_quant=weight_quant, act_quant=act_quant,
        weight_phase=Phase.fix if qat.fix_weight_ranges else Phase.estimate,
        act_phase=Phase.fix if qat.fix_act_ranges else Phase.estimate)


def tree_leaves(tree) -> List[Tuple[Tuple[str, ...], Tensor]]:
    """``(path, leaf)`` pairs in ``jax.tree.leaves``' order: dict keys
    sorted, lists in order, None an empty subtree (a MobileBERT
    checkpoint's absent pooler)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [((str(k),) + p, v) for k in sorted(tree)
                for p, v in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [((str(i),) + p, v) for i, t in enumerate(tree)
                for p, v in tree_leaves(t)]
    return [((), tree)]


def tree_unflatten(template, leaves: List[Tensor]):
    """``template``'s nesting with its leaves replaced, in
    :func:`tree_leaves`' order."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return [build(v) for v in t]
        return next(it)
    return build(template)


def trainable_paths(params) -> List[Tuple[str, ...]]:
    """The optimizer's leaf paths: ``("params", ...)`` for each weight,
    then ``("ranges",)`` (the order of JAX's ``{"params", "ranges"}``)."""
    return [("params",) + p for p, _ in tree_leaves(params)] + [("ranges",)]


def make_optimizer(qat: QATConfig, params) -> O.Optimizer:
    """AdamW on the weights at ``qat.learning_rate``; the ranges at the
    same rate (the reference's behaviour), or with
    ``range_learning_rate`` through their own Adam."""
    paths = trainable_paths(params)
    groups = {"params": O.Group(O.constant_schedule(qat.learning_rate),
                                qat.weight_decay)}
    if qat.range_learning_rate is None:
        return O.Optimizer(groups, ["params"] * len(paths))
    groups["ranges"] = O.Group(O.constant_schedule(qat.range_learning_rate))
    return O.Optimizer(groups, [p[0] for p in paths])


def qat_value_and_grad(apply_fn: Callable, qcfg: QuantModelConfig,
                       qat: QATConfig, params, learnable, rest, batch,
                       generator):
    """One QAT forward and backward: ``(loss, grads, new_qstate,
    unravel)``, ``grads`` over the weights' leaves (:func:`tree_leaves`'
    order) and then the packed ranges (:func:`ravel_ranges`), zeros where
    a leaf takes no part."""
    check_ported(qat)
    extra = forward_options(qat)
    flat, unravel = ravel_ranges(learnable)
    p_leaves = [t.detach().requires_grad_(True)
                for _, t in tree_leaves(params)]
    live = tree_unflatten(params, p_leaves)
    flat = flat.to(p_leaves[0].device).detach().requires_grad_(True)
    qstate = merge_learnable_ranges(unravel(flat), rest)
    out, new_qstate = apply_fn(live, batch, qcfg=qcfg, qstate=qstate,
                               mode=qat_mode(qat), train=True,
                               dropout_generator=generator, **extra)
    loss = out["loss"]
    inputs = p_leaves + [flat]
    grads = torch.autograd.grad(loss, inputs, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for g, t in zip(grads, inputs)]
    return loss.detach(), grads, _detached(new_qstate), unravel


def make_qat_train_step(apply_fn: Callable, qcfg: QuantModelConfig,
                        qat: QATConfig, tx: O.Optimizer):
    """The QAT train step ``step(params, learnable, rest, opt_state, batch,
    generator) -> (params, learnable, rest, opt_state, generator, loss)``.

    ``apply_fn(params, batch, qcfg=, qstate=, mode=, train=True,
    dropout_generator=, [int8_qat_sites=, compute_dtype=, remat=,
    scan_layers=]) -> (outputs with 'loss', qstate)``. ``learnable`` is
    empty unless ``learn_ranges``; the optimizer sees the weights' leaves
    then the packed ranges. The loss is returned as a 0-d tensor."""
    check_ported(qat)

    def step(params, learnable, rest, opt_state, batch, generator):
        loss, grads, new_qstate, unravel = qat_value_and_grad(
            apply_fn, qcfg, qat, params, learnable, rest, batch, generator)
        flat, _ = ravel_ranges(learnable)
        leaves = [t for _, t in tree_leaves(params)]
        with torch.no_grad():
            new, opt_state = tx.update(
                grads, opt_state, leaves + [flat.to(leaves[0].device)])
        new_params = tree_unflatten(params, new[:-1])
        new_learnable, new_rest = {}, new_qstate
        if learnable:
            new_learnable = unravel(new[-1])
            new_rest = {}
            for k, v in new_qstate.items():
                if k in learnable:
                    v = dict({kk: vv for kk, vv in v.items() if kk != "qp"},
                             qp_signed=v["qp"].signed)
                new_rest[k] = v
        return (new_params, new_learnable, new_rest, opt_state, generator,
                loss)

    return step


def _detached(qstate: Dict) -> Dict:
    """A quant state with every tensor detached from the step's graph."""
    def det(v):
        if isinstance(v, Tensor):
            return v.detach()
        if isinstance(v, QuantParams):
            return QuantParams(delta=v.delta.detach(),
                               zero_float=v.zero_float.detach(),
                               signed=v.signed.detach())
        if isinstance(v, dict):
            return {k: det(x) for k, x in v.items()}
        return v
    return {k: det(v) for k, v in qstate.items()}


def init_qat_state(qcfg: QuantModelConfig, qat: QATConfig, params, qstate,
                   tx: O.Optimizer):
    """``(params, learnable, rest, opt_state)`` after calibration; the
    optimizer state over the weights' leaves and the packed ranges."""
    if qat.learn_ranges:
        learnable, rest = split_learnable_ranges(qcfg, qstate)
    else:
        learnable, rest = {}, dict(qstate)
    flat, _ = ravel_ranges(learnable)
    leaves = [t for _, t in tree_leaves(params)]
    opt_state = tx.init(leaves + [flat.to(leaves[0].device)])
    return params, learnable, rest, opt_state
