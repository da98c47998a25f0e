"""Full-handoff int8 encoder inference engine.

Counterpart of ``transformer_quantization_tpu/ops/engine.py``. Every
activation edge between matmuls is an int8 payload:

    entry value -> quantize_payload -> per layer int8_layer_ln
                -> dequantize_payload (the last ffn.ln site)

:func:`build_encoder_plan` validates a model's quantization config and
assembles the same plan dict as the JAX package (per layer ``qkv``,
``attn_scal``, ``attn_out``, ``ln1``, ``inter``, ``dense``, ``ln2``). This
slice runs the all-int8 route only; configurations the JAX engine serves
through other routes (int4 weights, flex/PEG/16-bit edges, disabled fold
sites, 16-bit attention sites) raise :class:`EngineIncompatible` with
"not yet ported".
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from transformer_quantization_tpu_torch.ops.kernels import engine_kernels as EK
from transformer_quantization_tpu_torch.quant import quantizers as Q

Tensor = torch.Tensor


class EngineIncompatible(Exception):
    """The quantization config doesn't fit the engine path."""


@dataclasses.dataclass(frozen=True)
class EngineStatic:
    """Hashable engine shape/flags; tensors live in the plan dict."""

    n_layers: int
    n_heads: int
    ln_eps: float
    hidden_act: str
    # per layer: (qkv_w4, attn_out_w4, inter_w4, dense_w4)
    w4: Tuple[Tuple[bool, bool, bool, bool], ...]
    # per layer: (attn_out.dense.out folded?, ffn.dense.out folded?)
    fold: Tuple[Tuple[bool, bool], ...]
    # per layer: (attn_out.res enabled?, ffn.res enabled?)
    res_quant: Tuple[Tuple[bool, bool], ...]
    # softmax may skip the max-subtraction (proven at plan time from the
    # concrete scores-site scales)
    attn_skip_max: bool = False
    attn_bits: Tuple[Tuple[int, ...], ...] = ()

    def layer_attn_bits(self, i: int) -> Tuple[int, ...]:
        return self.attn_bits[i] if self.attn_bits else (8, 8, 8)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise EngineIncompatible(msg)


def _f32(v) -> Tensor:
    return v.to(torch.float32) if isinstance(v, Tensor) else torch.tensor(
        v, dtype=torch.float32)


def act_site_scalars(qcfg, qstate: Mapping, name: str) -> Tuple[Tensor, Tensor]:
    """(scale, payload-shift) of a per-tensor asymmetric 8-bit act site."""
    _require(name in qcfg, f"no act site {name!r}")
    c = qcfg[name]
    _require(c.kind == "act", f"{name!r} is not an act site")
    _require(c.enabled, f"act site {name!r} disabled")
    _require(c.axis is None and not c.n_groups,
             f"act site {name!r} is per-axis/grouped")
    _require(c.spec.n_bits == 8, f"act site {name!r} is {c.spec.n_bits}-bit")
    _require(not c.spec.symmetric, f"act site {name!r} is symmetric")
    _require(name in qstate, f"act site {name!r} not calibrated")
    qp = qstate[name]["qp"]
    _require(qp.delta.ndim == 0, f"act site {name!r} has non-scalar params")
    s = Q.scale_of(c.spec, qp).reshape(()).to(torch.float32)
    shift = (128.0 - Q.zero_point_of(c.spec, qp).reshape(())).to(
        torch.float32)
    return s, shift


def attn_edge_scalars(qcfg, qstate: Mapping,
                      name: str) -> Tuple[Tensor, Tensor, int]:
    """(scale, shift, bits) of an attention-interior act site (scores /
    probs / context): 8 or 16 bits, or disabled (``bits=0``, identity
    params). shift = 2^(bits-1) - zero_point."""
    _require(name in qcfg, f"no act site {name!r}")
    c = qcfg[name]
    if not c.enabled:
        return torch.ones(()), torch.zeros(()), 0
    _require(c.axis is None and not c.n_groups,
             f"act site {name!r} is per-axis/grouped")
    _require(2 <= c.spec.n_bits <= 16,
             f"act site {name!r} is {c.spec.n_bits}-bit (engine attention "
             "supports 2..16)")
    _require(not c.spec.symmetric, f"act site {name!r} is symmetric")
    _require(name in qstate, f"act site {name!r} not calibrated")
    qp = qstate[name]["qp"]
    _require(qp.delta.ndim == 0, f"act site {name!r} has non-scalar params")
    s = Q.scale_of(c.spec, qp).reshape(()).to(torch.float32)
    shift = (2.0 ** (c.spec.n_bits - 1)
             - Q.zero_point_of(c.spec, qp).reshape(())).to(torch.float32)
    return s, shift, c.spec.n_bits


def act_edge_params(qcfg, qstate: Mapping, name: str):
    """Classify an act site as an engine edge: ``('i8', 8, s, shift)`` for
    per-tensor 8-bit asymmetric sites (int8 payload protocol), else
    ``('f', bits, s, shift)`` (16-bit / per-embedding value edges)."""
    _require(name in qcfg, f"no act site {name!r}")
    c = qcfg[name]
    _require(c.kind == "act", f"{name!r} is not an act site")
    _require(c.enabled, f"act site {name!r} disabled")
    _require(not c.spec.symmetric, f"act site {name!r} is symmetric")
    _require(name in qstate, f"act site {name!r} not calibrated")
    bits = c.spec.n_bits
    qp = qstate[name]["qp"]
    s = Q.scale_of(c.spec, qp).to(torch.float32)
    zp = Q.zero_point_of(c.spec, qp).to(torch.float32)
    shift = 2.0 ** (bits - 1) - zp
    if (c.axis is None and not c.n_groups and bits == 8
            and qp.delta.ndim == 0):
        return ("i8", 8, s.reshape(()), shift.reshape(()))
    _require(bits <= 16, f"act site {name!r} is {bits}-bit (engine max 16)")
    if qp.delta.ndim > 0:
        _require(c.axis == 2, f"act site {name!r}: engine flex edges must "
                 "be per-embedding (axis=2)")
    return ("f", bits, s.reshape(-1) if qp.delta.ndim else s.reshape(()),
            shift.reshape(-1) if qp.delta.ndim else shift.reshape(()))


def _act_enabled(qcfg, name: str) -> bool:
    return name in qcfg and qcfg[name].enabled


def _bcast(v: Tensor, n: int) -> Tensor:
    v = v.reshape(-1).to(torch.float32)
    return torch.broadcast_to(v, (n,)) if v.shape[0] != n else v


def _packed_weight(int_params: Mapping, name: str):
    _require(name in int_params, f"weight of {name!r} not int-packed")
    p = int_params[name]
    _require("w_packed" not in p,
             f"int4 weight of {name!r}: the W4A8 engine is not yet ported")
    return p["w_int"], p


def _mm_plan(int_params: Mapping, names: List[str], biases: List[Tensor],
             in_scal: Tuple[Tensor, Tensor],
             out_sites: List[Tuple[Tensor, Tensor]]) -> Dict:
    """One matmul's plan: (N, K) int8 weight (row-concat over ``names`` for
    the fused q|k|v matmul), (5, N) epilogue rows [wscale, colsum, bias,
    out_s, out_shift] and the (1, 2) input-site scalars."""
    ws, packs = zip(*(_packed_weight(int_params, n) for n in names))
    w = ws[0] if len(ws) == 1 else torch.cat(ws, dim=0)
    ns = [p["colsum"].shape[0] for p in packs]
    n = sum(ns)
    wscale = torch.cat([_bcast(p["scale"], nn) for p, nn in zip(packs, ns)])
    colsum = torch.cat([p["colsum"].to(torch.float32) for p in packs])
    bias = torch.cat([b.to(torch.float32) for b in biases])
    out_s = torch.cat([_bcast(s, nn) for (s, _), nn in zip(out_sites, ns)])
    out_shift = torch.cat([_bcast(sh, nn) for (_, sh), nn in zip(out_sites, ns)])
    vecs = torch.stack([wscale, colsum, bias, out_s, out_shift]).contiguous()
    scal = torch.stack([_f32(v).reshape(()) for v in in_scal]).reshape(1, 2)
    return {"w": w.contiguous(), "vecs": vecs, "scal": scal}


def _ln_plan(qcfg, qstate, params_ln: Mapping, res_site: str, ln_site: str,
             ln_wsite: str, y_site: Tuple[Tensor, Tensor],
             r_site: Tuple[Tensor, Tensor]) -> Tuple[Dict, bool]:
    """gamma/beta (+quantized gamma) and the (1, 8) site scalars [y_s,
    y_sh, r_s, r_sh, res_s, res_sh, ln_s, ln_sh] of one add+LN."""
    gamma = params_ln["scale"].to(torch.float32)
    beta = params_ln["bias"].to(torch.float32)
    if ln_wsite in qcfg and qcfg[ln_wsite].enabled:
        c = qcfg[ln_wsite]
        _require(ln_wsite in qstate, f"{ln_wsite!r} not calibrated")
        gamma = Q.fake_quant(c.spec, qstate[ln_wsite]["qp"], gamma,
                             axis=0 if c.per_channel else None)
    res_quant = _act_enabled(qcfg, res_site)
    if res_quant:
        res_s, res_sh = act_site_scalars(qcfg, qstate, res_site)
    else:
        res_s, res_sh = (torch.ones((), device=gamma.device),
                         torch.zeros((), device=gamma.device))
    l_s, l_sh = act_site_scalars(qcfg, qstate, ln_site)
    vals = (*y_site, *r_site, res_s, res_sh, l_s, l_sh)
    plan = {"gb": torch.stack([gamma, beta]).contiguous(),
            "scal": torch.stack([_f32(v).reshape(()) for v in vals])
            .reshape(1, 8)}
    return plan, res_quant


def _flex_reason(qcfg, qstate, p: str) -> Optional[str]:
    """Why layer prefix ``p`` would need a flex route, else None."""
    for site in ("attn.q.out", "attn.k.out", "attn.v.out",
                 "attn_out.ln.out", "ffn.inter.out", "ffn.ln.out"):
        if act_edge_params(qcfg, qstate, p + site)[0] != "i8":
            return f"{p}{site} is a 16-bit / per-embedding edge"
    for site in ("attn_out.dense.out", "ffn.dense.out"):
        if not _act_enabled(qcfg, p + site):
            return (f"{p}{site} is disabled (the non-payload residual route "
                    "and fused_add_ln)")
        if act_edge_params(qcfg, qstate, p + site)[0] != "i8":
            return f"{p}{site} is a 16-bit / per-embedding fold site"
    for site in ("attn_out.res", "ffn.res"):
        if (_act_enabled(qcfg, p + site)
                and act_edge_params(qcfg, qstate, p + site)[0] != "i8"):
            return f"{p}{site} is a 16-bit / per-embedding residual site"
    return None


def build_encoder_plan(qcfg, qstate: Mapping, int_params: Mapping,
                       layer_params: List[Mapping], *, n_heads: int,
                       ln_eps: float, hidden_act: str, entry_site: str
                       ) -> Tuple[EngineStatic, Dict]:
    """Validate and assemble the engine plan for a BERT-family encoder with
    the shared ``L{i}.*`` site naming. Raises :class:`EngineIncompatible`
    when an edge can't ride the all-int8 payload route."""
    layers, w4_flags, fold_flags, res_flags, attn_bits_flags = [], [], [], [], []
    for i, lp in enumerate(layer_params):
        p = f"L{i}."
        in_site = entry_site if i == 0 else f"L{i - 1}.ffn.ln.out"
        in_edge = act_edge_params(qcfg, qstate, in_site)
        _require(in_edge[0] == "i8", f"{in_site} is a float value edge: "
                 "flex layers are not yet ported")
        why = _flex_reason(qcfg, qstate, p)
        _require(why is None, f"{why}: flex layers are not yet ported")
        in_scal = (in_edge[2], in_edge[3])
        qkv_out = [act_site_scalars(qcfg, qstate, p + f"attn.{x}.out")
                   for x in "qkv"]
        qkv = _mm_plan(int_params, [p + f"attn.{x}" for x in "qkv"],
                       [lp["attn"][x]["bias"] for x in "qkv"], in_scal,
                       qkv_out)

        sc_s, sc_sh, sc_bits = attn_edge_scalars(qcfg, qstate,
                                                 p + "attn.scores")
        p_s, p_sh, p_bits = attn_edge_scalars(qcfg, qstate, p + "attn.probs")
        c_s, c_sh, c_bits = attn_edge_scalars(qcfg, qstate,
                                              p + "attn.context")
        _require((sc_bits, p_bits, c_bits) == (8, 8, 8),
                 f"{p}attn sites are ({sc_bits}, {p_bits}, {c_bits})-bit: "
                 "16-bit / disabled attention sites are not yet ported")
        attn_scal = torch.stack(
            [v.reshape(()) for pair in qkv_out for v in pair]
            + [sc_s, sc_sh, p_s, p_sh, c_s, c_sh]).reshape(1, 12)

        g_site = act_site_scalars(qcfg, qstate, p + "attn_out.dense.out")
        attn_out = _mm_plan(int_params, [p + "attn_out.dense"],
                            [lp["attn_out"]["dense"]["bias"]], (c_s, c_sh),
                            [g_site])
        ln1, res1 = _ln_plan(qcfg, qstate, lp["attn_out"]["ln"],
                             p + "attn_out.res", p + "attn_out.ln.out",
                             p + "attn_out.ln.w", g_site, in_scal)
        x_site = act_site_scalars(qcfg, qstate, p + "attn_out.ln.out")
        i_site = act_site_scalars(qcfg, qstate, p + "ffn.inter.out")
        inter = _mm_plan(int_params, [p + "ffn.inter"],
                         [lp["ffn"]["inter"]["bias"]], x_site, [i_site])
        h_site = act_site_scalars(qcfg, qstate, p + "ffn.dense.out")
        dense = _mm_plan(int_params, [p + "ffn.dense"],
                         [lp["ffn"]["dense"]["bias"]], i_site, [h_site])
        ln2, res2 = _ln_plan(qcfg, qstate, lp["ffn"]["ln"], p + "ffn.res",
                             p + "ffn.ln.out", p + "ffn.ln.w", h_site,
                             x_site)
        layers.append({"qkv": qkv, "attn_scal": attn_scal,
                       "attn_out": attn_out, "ln1": ln1, "inter": inter,
                       "dense": dense, "ln2": ln2})
        w4_flags.append((False, False, False, False))
        fold_flags.append((True, True))
        res_flags.append((res1, res2))
        attn_bits_flags.append((sc_bits, p_bits, c_bits))

    entry_edge = act_edge_params(qcfg, qstate, entry_site)
    entry_scal = torch.stack((entry_edge[2], entry_edge[3])).reshape(1, 2)
    # the softmax max-subtraction is dead work when the grid-bounded
    # quantized scores keep |s2| <= 256 * sc_s / sqrt(d) * log2(e) far
    # below exp2's overflow threshold (~126)
    hidden = int(layer_params[0]["attn"]["q"]["bias"].shape[0])
    head_dim = hidden // n_heads
    worst = max((2.0 ** attn_bits_flags[li][0]) * float(lp_["attn_scal"][0, 6])
                for li, lp_ in enumerate(layers))
    bound = worst / float(np.sqrt(head_dim)) * float(np.log2(np.e))
    static = EngineStatic(
        n_layers=len(layer_params), n_heads=n_heads, ln_eps=ln_eps,
        hidden_act=hidden_act, w4=tuple(w4_flags), fold=tuple(fold_flags),
        res_quant=tuple(res_flags), attn_skip_max=bound < 100.0,
        attn_bits=tuple(attn_bits_flags))
    return static, {"layers": layers, "entry_scal": entry_scal}


def encoder_engine(h: Tensor, mask_bias: Tensor, static: EngineStatic,
                   plan: Dict, *, backend: str = "kernels") -> Tensor:
    """Run the encoder stack on payloads.

    ``h``: (B, T, H) float, the (fake-quantized) entry-site value.
    ``mask_bias``: (B, T) float32 additive attention bias. Returns the last
    layer's ln-site value, (B, T, H) float32. ``backend='kernels'`` runs
    each layer through the kernel wrappers (the CUDA kernels on the card,
    their plain versions on the CPU); ``'plain'`` runs the plain layer
    version on any device, the yardstick the kernels are held against.
    ``hidden_act='gelu'`` runs as the tanh form ``gelu_new``, the JAX
    engine's default ``gelu_impl='tanh'``.
    """
    if backend not in ("kernels", "plain"):
        raise ValueError(f"unknown engine backend {backend!r}")
    b, t, hdim = h.shape
    hidden_act = ("gelu_new" if static.hidden_act == "gelu"
                  else static.hidden_act)
    layer_fn = EK.int8_layer_ln if backend == "kernels" else EK.int8_layer_ln_ref
    es = plan["entry_scal"]
    h8 = EK.quantize_payload(h.reshape(b * t, hdim), es[0, 0], es[0, 1])
    mask_bias = mask_bias.to(torch.float32).contiguous()
    for i, lp in enumerate(plan["layers"]):
        res1, res2 = static.res_quant[i]
        h8 = layer_fn(
            h8, lp["qkv"]["w"], lp["qkv"]["vecs"], lp["qkv"]["scal"],
            mask_bias, lp["attn_scal"], lp["attn_out"]["w"],
            lp["attn_out"]["vecs"], lp["attn_out"]["scal"],
            lp["ln1"]["gb"], lp["ln1"]["scal"],
            lp["inter"]["w"], lp["inter"]["vecs"], lp["inter"]["scal"],
            lp["dense"]["w"], lp["dense"]["vecs"], lp["dense"]["scal"],
            lp["ln2"]["gb"], lp["ln2"]["scal"],
            n_heads=static.n_heads, seq=t, eps=static.ln_eps,
            activation=hidden_act, res1=res1, res2=res2,
            skip_max=static.attn_skip_max,
            attn_bits=static.layer_attn_bits(i))
    ln2 = plan["layers"][-1]["ln2"]
    hf = EK.dequantize_payload(h8, ln2["scal"][0, 6], ln2["scal"][0, 7])
    return hf.reshape(b, t, hdim)
