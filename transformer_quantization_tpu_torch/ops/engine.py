"""Full-handoff int8 encoder inference engine.

Counterpart of ``transformer_quantization_tpu/ops/engine.py``. Every
activation edge between matmuls is an int8 payload:

    entry value -> quantize_payload -> per layer int8_layer_ln
                -> dequantize_payload (the last ffn.ln site)

A flex layer -- 16-bit, sub-8 or per-column (PEG) sites off the attention
interior: the paper's mixed-precision and PEG recipes, its leave-one-out
and bit-width study (quant_dict ``L`` / ``L{i}`` / ``z`` keys, global 16-
or sub-8-bit activations) -- runs the JAX engine's "mega" route instead:
one :func:`~.kernels.engine_kernels.int8_attn_ln` and one flex
:func:`~.kernels.engine_kernels.int8_ffn_ln`, each edge (the layer input,
q / k / v, the FFN input ``x``, ``ffn.inter.out``, the next layer's input
``z``) an int8 payload or a float32 value edge as ``EngineStatic.io`` and
``EngineStatic.flex`` say. A float edge into a matmul carries its grid
(``grid`` in the consuming matmul's plan) for the float-edge matmul.

The attention sites (quant_dict ``s``, ``p``, ``c``) may be 2-16 bits or
disabled on any route; a context site outside 1-8 bits hands attn_out a
float value edge (on its grid at 9-16 bits, on none when disabled).

A disabled fold site (``attn_out.dense.out`` or ``ffn.dense.out``, the
leave-one-out ``{'g': 'fp32'}`` / ``{'h': 'fp32'}``) in any layer moves
the whole stack to the non-payload residual route: the residual stream
is float32, each layer the chain q|k|v matmul -> attention -> attn_out
matmul (``fold`` or ``float``) -> :func:`~.kernels.engine_kernels.
fused_add_ln` -> inter matmul -> dense matmul -> ``fused_add_ln``, and
the stack returns the last float value.

:func:`build_encoder_plan` validates a model's quantization config and
assembles the same plan dict as the JAX package (per layer ``qkv``,
``attn_scal``, ``attn_out``, ``ln1``, ``inter``, ``dense``, ``ln2``; a
float edge adds the consuming matmul's ``grid``). Split-half packed int4
weights (W4A8, ``use_int4``) ride every route's payload matmuls
(``EngineStatic.w4``); an int4 weight under a float edge raises
:class:`EngineIncompatible` with "not yet ported".

:func:`encoder_engine` takes the JAX engine's inference options: the
backend spec of :func:`parse_backend` (a mix of kernels and plain
versions per op kind), ``gelu_impl`` (:func:`engine_act`) and
``out_dtype`` (the ``engine_dtype``: bfloat16 storage of the entry and
exit values and of the non-payload route's residual stream).
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
    # per layer: (x_mode 'i8'|'f', x_bits, h_bits, y_bits, lnv1?, lnv2?):
    # x = attn_out.ln.out (the FFN input), h = the ffn.dense.out fold
    # site, y = ffn.res; lnv1 / lnv2 mark per-column (PEG) site rows of
    # the two add+LNs
    flex: Tuple[Tuple[str, int, int, int, bool, bool], ...] = ()
    attn_bits: Tuple[Tuple[int, ...], ...] = ()
    # per layer: (in_mode, qkv_mode, qkv_bits, z_mode, z_bits, g_bits,
    # u_bits, inter_mode, i_bits): the layer-input edge, the q/k/v sites,
    # ffn.ln.out (the next layer's input), the attention block's fold
    # ('g') and res ('u') grids, and the ffn.inter.out edge
    io: Tuple[Tuple[str, str, int, str, int, int, int, str, int], ...] = ()
    # per layer: whether it runs as one all-int8 int8_layer_ln, every edge
    # an 8-bit per-tensor payload. A per-column 8-bit fold site ('g' / 'h'
    # 'ngN') leaves flex and io at their defaults, but the all-int8 chain's
    # add+LN reads a scalar fold site, so such a layer takes the flex route;
    # a disabled fold site anywhere puts every layer on the non-payload
    # residual route
    int8_layer: Tuple[bool, ...] = ()

    IO_DEFAULT = ("i8", "i8", 8, "i8", 8, 8, 8, "i8", 8)
    FLEX_DEFAULT = ("i8", 8, 8, 8, False, False)

    @property
    def any_flex(self) -> bool:
        return (any(f != self.FLEX_DEFAULT for f in self.flex)
                or any(o != self.IO_DEFAULT for o in self.io))

    def layer_attn_bits(self, i: int) -> Tuple[int, ...]:
        return self.attn_bits[i] if self.attn_bits else (8, 8, 8)

    def layer_flex(self, i: int):
        return self.flex[i] if self.flex else self.FLEX_DEFAULT

    def layer_io(self, i: int):
        return self.io[i] if self.io else self.IO_DEFAULT


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


def attn_edge_scalars(qcfg, qstate: Mapping, name: str,
                      device=None) -> Tuple[Tensor, Tensor, int]:
    """(scale, shift, bits) of an attention-interior act site (scores /
    probs / context): 2-16 bits, or disabled (``bits=0``, identity params
    on ``device``). shift = 2^(bits-1) - zero_point."""
    _require(name in qcfg, f"no act site {name!r}")
    c = qcfg[name]
    if not c.enabled:
        return (torch.ones((), device=device),
                torch.zeros((), device=device), 0)
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
    """``(weight, packed dict, w4)``: the (N, K) int8 weight, or with
    ``w4`` the (N, K/2) split-half packed int4 one."""
    _require(name in int_params, f"weight of {name!r} not int-packed")
    p = int_params[name]
    w4 = "w_packed" in p
    return (p["w_packed"] if w4 else p["w_int"]), p, w4


def _mm_plan(int_params: Mapping, names: List[str], biases: List[Tensor],
             in_scal: Tuple[Tensor, Tensor],
             out_sites: Optional[List[Tuple[Tensor, Tensor]]],
             weights: Optional[Dict] = None) -> Tuple[Dict, bool]:
    """One matmul's plan and whether its weight is packed int4: (N, K)
    int8 or (N, K/2) packed int4 weight (row-concat over ``names`` for the
    fused q|k|v matmul, all of one width), (5, N) epilogue rows [wscale,
    colsum, bias, out_s, out_shift] and the (1, 2) input-site scalars.
    ``out_sites`` None (a disabled fold site): out_s 1, out_shift 0.
    ``weights`` maps the ``names`` of each weight already assembled to its
    tensor, so that layers that share their sites share one weight."""
    ws, packs, w4s = zip(*(_packed_weight(int_params, n) for n in names))
    _require(len(set(w4s)) == 1, "mixed int4/int8 sub-weights in one matmul")
    key = tuple(names)
    w = None if weights is None else weights.get(key)
    if w is None:
        w = (ws[0] if len(ws) == 1 else torch.cat(ws, dim=0)).contiguous()
        if weights is not None:
            weights[key] = w
    ns = [p["colsum"].shape[0] for p in packs]
    n = sum(ns)
    wscale = torch.cat([_bcast(p["scale"], nn) for p, nn in zip(packs, ns)])
    colsum = torch.cat([p["colsum"].to(torch.float32) for p in packs])
    bias = torch.cat([b.to(torch.float32) for b in biases])
    if out_sites is None:
        out_s = torch.ones((n,), device=bias.device)
        out_shift = torch.zeros((n,), device=bias.device)
    else:
        out_s = torch.cat([_bcast(s, nn)
                           for (s, _), nn in zip(out_sites, ns)])
        out_shift = torch.cat([_bcast(sh, nn)
                               for (_, sh), nn in zip(out_sites, ns)])
    vecs = torch.stack([wscale, colsum, bias, out_s, out_shift]).contiguous()
    scal = torch.stack([_f32(v).reshape(()) for v in in_scal]).reshape(1, 2)
    return {"w": w, "vecs": vecs, "scal": scal}, w4s[0]


def _require_k1_width(int_params: Mapping, name: str, mm: Dict,
                      w4: bool) -> None:
    """Refuse, when the plan is made, a matmul whose width the int8 matmul
    kernel (K1) does not take: K % 16 == 0 (K % 32 for a packed int4
    weight, whose rows TMA reads at K/2 bytes) and N % 8 == 0, the limits
    its wrapper checks on the card (``EK._check_matmul``)."""
    n = mm["w"].shape[0]
    k = int_params[name]["in_features"] if w4 else mm["w"].shape[1]
    align = 32 if w4 else 16
    _require(k % align == 0 and n % 8 == 0,
             f"{name}: K = {k}, N = {n} is outside the int8 matmul kernel's "
             f"limits (K % {align} == 0, N % 8 == 0): not yet ported")


def _ln_plan(qcfg, qstate, params_ln: Mapping, res_site: str, ln_site: str,
             ln_wsite: str, y_site: Optional[Tuple[Tensor, Tensor]],
             r_site: Tuple[Tensor, Tensor]) -> Tuple[Dict, bool, int, Tuple]:
    """gamma/beta (+quantized gamma) and the site params of one add+LN;
    returns ``(plan, res_quant, res_bits, ln_edge)``.

    ``plan["scal"]`` (1, 8): [y_s, y_sh, r_s, r_sh, res_s, res_sh, ln_s,
    ln_sh]. ``y_site`` is the producing matmul's fold site when it is an
    8-bit per-tensor payload site, else None (identity: the flex chains
    hand the fold value over as float32). The res and ln sites may be
    flex edges (16-bit / per-column); when either is per-column the plan
    carries them as the (4, H) rows ``lnv`` [res_s; res_sh; ln_s; ln_sh]
    and zeros in ``scal[4:8]``.
    """
    gamma = params_ln["scale"].to(torch.float32)
    beta = params_ln["bias"].to(torch.float32)
    n = gamma.shape[0]
    if ln_wsite in qcfg and qcfg[ln_wsite].enabled:
        c = qcfg[ln_wsite]
        _require(ln_wsite in qstate, f"{ln_wsite!r} not calibrated")
        gamma = Q.fake_quant(c.spec, qstate[ln_wsite]["qp"], gamma,
                             axis=0 if c.per_channel else None)
    dev = gamma.device
    one, zero = torch.ones((), device=dev), torch.zeros((), device=dev)
    res_quant = _act_enabled(qcfg, res_site)
    res_bits = 8
    if res_quant:
        _, res_bits, res_s, res_sh = act_edge_params(qcfg, qstate, res_site)
    else:
        res_s, res_sh = one, zero
    ln_edge = act_edge_params(qcfg, qstate, ln_site)
    _, _, l_s, l_sh = ln_edge
    y_s, y_sh = y_site if y_site is not None else (one, zero)
    pervec = res_s.ndim > 0 or l_s.ndim > 0
    head = [_f32(v).reshape(()) for v in (y_s, y_sh, *r_site)]
    tail = ([zero] * 4 if pervec else
            [_f32(v).reshape(()) for v in (res_s, res_sh, l_s, l_sh)])
    plan = {"gb": torch.stack([gamma, beta]).contiguous(),
            "scal": torch.stack(head + tail).reshape(1, 8)}
    if pervec:
        plan["lnv"] = torch.stack([_bcast(res_s, n), _bcast(res_sh, n),
                                   _bcast(l_s, n), _bcast(l_sh, n)]
                                  ).contiguous()
    return plan, res_quant, res_bits, ln_edge


def _x_edge_grid(qcfg, qstate, site: str, edge, w8: Tensor) -> Dict:
    """The grid of a float value edge (``site``: a 16-bit / sub-8 /
    per-column act site) for the float-edge matmul that consumes it: its
    groups follow the site's quantizer (one for a per-tensor site; a PEG
    site's groups in its permutation order; a group per column for a
    per-embedding site)."""
    c = qcfg[site]
    _, bits, s, shift = edge
    k = w8.shape[1]
    zp = 2.0 ** (bits - 1) - shift
    cols = torch.arange(k, device=w8.device)
    if c.n_groups:
        n_groups = c.n_groups
        if c.permute:
            cols = qstate[site]["perm"].to(device=w8.device)
    else:
        n_groups = k if s.ndim else 1
    return EK.edge_grid(w8, s, zp, bits, n_groups, cols)


def _grid(grids: Dict, key, make) -> Dict:
    """The edge grid of ``key`` (its matmul's weight names and the edge's
    site), made once: layers that share their sites share it."""
    if key not in grids:
        grids[key] = make()
    return grids[key]


def build_encoder_plan(qcfg, qstate: Mapping, int_params: Mapping,
                       layer_params: List[Mapping], *, n_heads: int,
                       ln_eps: float, hidden_act: str, entry_site: str,
                       prefixes: Optional[List[str]] = None
                       ) -> Tuple[EngineStatic, Dict]:
    """Validate and assemble the engine plan for a BERT-family encoder with
    the shared ``L{i}.*`` site naming, as the JAX package's plan. ``prefixes``
    sets each layer's site prefix instead (ALBERT's ``["shared."] * n``:
    every layer reads the one shared layer's sites, and layer i > 0 takes
    its input from ``prefixes[i - 1] + "ffn.ln.out"``); layers of one
    prefix share one weight tensor a matmul in the plan, and one grid a
    float edge. Raises :class:`EngineIncompatible` when an edge fits no
    route (JAX's refusals: a disabled or wider than 16-bit act site on a
    matmul edge, q / k / v sites of different widths; and the port's:
    int4 weights under a float edge, widths outside the int8 matmul
    kernel's limits)."""
    layers, fold_flags, res_flags, attn_bits_flags = [], [], [], []
    flex_flags, io_flags, int8_flags, w4_flags = [], [], [], []
    if prefixes is None:
        prefixes = [f"L{i}." for i in range(len(layer_params))]
    weights: Dict = {}
    grids: Dict = {}
    for i, lp in enumerate(layer_params):
        p = prefixes[i]
        in_site = entry_site if i == 0 else prefixes[i - 1] + "ffn.ln.out"
        in_edge = act_edge_params(qcfg, qstate, in_site)
        in_mode = in_edge[0]
        dev = in_edge[2].device
        ident = (torch.ones((), device=dev), torch.zeros((), device=dev))
        # a float input edge carries its own (fake-quantized) values: the
        # consuming matmul folds no input-site params
        in_scal = (in_edge[2], in_edge[3]) if in_mode == "i8" else ident
        qkv_edges = [act_edge_params(qcfg, qstate, p + f"attn.{x}.out")
                     for x in "qkv"]
        qkv_out = [(e[2], e[3]) for e in qkv_edges]
        if all(e[0] == "i8" for e in qkv_edges):
            qkv_mode, qkv_bits, qkv_sv = "i8", 8, qkv_out
        else:
            # q / k / v leave the payload protocol (16-bit, sub-8 or per-
            # column sites: quant_dict 'L' keys): the matmul folds them on
            # their grids and the attention runs value-space float dots
            # with identity site scalars (the values carry their scales)
            bset = {e[1] for e in qkv_edges}
            _require(len(bset) == 1,
                     "q/k/v sites must share one grid width for the "
                     "engine's value-space attention "
                     f"(got {sorted(e[1] for e in qkv_edges)})")
            qkv_mode, qkv_bits, qkv_sv = "f", bset.pop(), [ident] * 3
        qkv, qkv_w4 = _mm_plan(int_params, [p + f"attn.{x}" for x in "qkv"],
                               [lp["attn"][x]["bias"] for x in "qkv"],
                               in_scal, qkv_out, weights)
        if in_mode == "f":
            _require(not qkv_w4, f"{p}attn.q: an int4 weight under a float "
                     "layer input (the float-edge matmul's w4): not yet "
                     "ported")
            qkv["grid"] = _grid(grids, (p + "attn.qkv", in_site),
                                lambda: _x_edge_grid(qcfg, qstate, in_site,
                                                     in_edge, qkv["w"]))

        sc_s, sc_sh, sc_bits = attn_edge_scalars(qcfg, qstate,
                                                 p + "attn.scores", dev)
        p_s, p_sh, p_bits = attn_edge_scalars(qcfg, qstate, p + "attn.probs",
                                              dev)
        c_s, c_sh, c_bits = attn_edge_scalars(qcfg, qstate,
                                              p + "attn.context", dev)
        attn_scal = torch.stack(
            [_f32(v).reshape(()) for pair in qkv_sv for v in pair]
            + [sc_s, sc_sh, p_s, p_sh, c_s, c_sh]).reshape(1, 12)
        # a context site outside 1-8 bits ('c': 16 / 'fp32') is a float
        # value edge into attn_out: no input-site params fold in
        ctx_scal = (c_s, c_sh) if 1 <= c_bits <= 8 else ident

        # the attn_out fold site is quant_dict 'g': flexible, or disabled
        # (the non-payload residual route)
        ao_fold = _act_enabled(qcfg, p + "attn_out.dense.out")
        g_bits, g_out = 8, None
        if ao_fold:
            _, g_bits, g_s, g_sh = act_edge_params(qcfg, qstate,
                                                   p + "attn_out.dense.out")
            g_out = (g_s, g_sh)
        attn_out, ao_w4 = _mm_plan(int_params, [p + "attn_out.dense"],
                                   [lp["attn_out"]["dense"]["bias"]],
                                   ctx_scal, [g_out] if ao_fold else None,
                                   weights)
        if not 1 <= c_bits <= 8:
            _require(not ao_w4, f"{p}attn_out.dense: an int4 weight under a "
                     "float context edge: not yet ported")
        if c_bits > 8:
            # the 16-bit context's grid; a disabled one has none (its raw
            # value runs the float x int8 matmul)
            attn_out["grid"] = _grid(
                grids, (p + "attn_out.dense", p + "attn.context"),
                lambda: EK.edge_grid(
                    attn_out["w"], c_s, 2.0 ** (c_bits - 1) - c_sh, c_bits,
                    1, torch.arange(attn_out["w"].shape[1], device=dev)))
        # ln1's LN site is the FFN input, quant_dict 'x': flexible
        ln1, res1, u_bits, x_edge = _ln_plan(
            qcfg, qstate, lp["attn_out"]["ln"], p + "attn_out.res",
            p + "attn_out.ln.out", p + "attn_out.ln.w",
            g_out if ao_fold and g_bits == 8 and g_s.ndim == 0 else None,
            in_scal)
        x_mode, x_bits, x_s, x_sh = x_edge
        # a float x edge carries its own values: no input params fold in
        x_scal = (x_s, x_sh) if x_mode == "i8" else ident
        # the ffn.inter.out edge into the dense matmul: a payload, or a
        # float value edge ('L': 16, global 16-bit or sub-8 activations)
        i_edge = act_edge_params(qcfg, qstate, p + "ffn.inter.out")
        inter_mode, i_bits = i_edge[0], i_edge[1]
        inter, inter_w4 = _mm_plan(int_params, [p + "ffn.inter"],
                                   [lp["ffn"]["inter"]["bias"]], x_scal,
                                   [(i_edge[2], i_edge[3])], weights)
        if x_mode == "f":
            _require(not inter_w4,
                     f"{p}ffn.inter: an int4 weight under a float x edge "
                     "(the float-edge matmul's w4): not yet ported")
            inter["grid"] = _grid(
                grids, (p + "ffn.inter", p + "attn_out.ln.out"),
                lambda: _x_edge_grid(qcfg, qstate, p + "attn_out.ln.out",
                                     x_edge, inter["w"]))
        i_scal = (i_edge[2], i_edge[3]) if inter_mode == "i8" else ident
        # the dense fold site is quant_dict 'h': flexible, or disabled
        d_fold = _act_enabled(qcfg, p + "ffn.dense.out")
        h_bits, h_out = 8, None
        if d_fold:
            _, h_bits, h_s, h_sh = act_edge_params(qcfg, qstate,
                                                   p + "ffn.dense.out")
            h_out = (h_s, h_sh)
        dense, dense_w4 = _mm_plan(int_params, [p + "ffn.dense"],
                                   [lp["ffn"]["dense"]["bias"]], i_scal,
                                   [h_out] if d_fold else None, weights)
        if inter_mode == "f":
            _require(not dense_w4,
                     f"{p}ffn.dense: an int4 weight under a float inter "
                     "edge (the float-edge matmul's w4): not yet ported")
            dense["grid"] = _grid(
                grids, (p + "ffn.dense", p + "ffn.inter.out"),
                lambda: _x_edge_grid(qcfg, qstate, p + "ffn.inter.out",
                                     i_edge, dense["w"]))
        # every matmul on an int8 payload runs on K1 (a float edge on the
        # float-edge or the float x int8 matmul)
        for name, mm, w4, mode in (
                (p + "attn.q", qkv, qkv_w4, in_mode),
                (p + "attn_out.dense", attn_out, ao_w4,
                 "i8" if 1 <= c_bits <= 8 else "f"),
                (p + "ffn.inter", inter, inter_w4, x_mode),
                (p + "ffn.dense", dense, dense_w4, inter_mode)):
            if mode == "i8":
                _require_k1_width(int_params, name, mm, w4)
        # ln2's res site is quant_dict 'y', its LN site quant_dict 'z' (the
        # next layer's input): both flexible
        ln2, res2, y_bits, z_edge = _ln_plan(
            qcfg, qstate, lp["ffn"]["ln"], p + "ffn.res", p + "ffn.ln.out",
            p + "ffn.ln.w",
            h_out if d_fold and h_bits == 8 and h_s.ndim == 0 else None,
            x_scal)
        flex = (x_mode, x_bits, h_bits, y_bits, "lnv" in ln1, "lnv" in ln2)
        io = (in_mode, qkv_mode, qkv_bits, z_edge[0], z_edge[1], g_bits,
              u_bits, inter_mode, i_bits)
        default = (flex == EngineStatic.FLEX_DEFAULT
                   and io == EngineStatic.IO_DEFAULT)
        _require(default or (ao_fold and d_fold),
                 f"{p[:-1]}: flex recipes need both fold sites enabled")

        layers.append({"qkv": qkv, "attn_scal": attn_scal,
                       "attn_out": attn_out, "ln1": ln1, "inter": inter,
                       "dense": dense, "ln2": ln2})
        fold_flags.append((ao_fold, d_fold))
        res_flags.append((res1, res2))
        attn_bits_flags.append((sc_bits, p_bits, c_bits))
        w4_flags.append((qkv_w4, ao_w4, inter_w4, dense_w4))
        flex_flags.append(flex)
        io_flags.append(io)
        int8_flags.append(default and ao_fold and d_fold and g_s.ndim == 0
                          and h_s.ndim == 0)

    entry_edge = act_edge_params(qcfg, qstate, entry_site)
    _require(entry_edge[2].ndim == 0,
             f"entry site {entry_site!r} must be per-tensor")
    entry_scal = torch.stack((entry_edge[2], entry_edge[3])).reshape(1, 2)
    # the softmax max-subtraction is dead work when the grid-bounded
    # quantized scores keep |s2| <= 2^bits * sc_s / sqrt(d) * log2(e) far
    # below exp2's overflow threshold (~126); a disabled scores site (bits
    # 0) has no grid bound
    skip_max = False
    if all(b[0] for b in attn_bits_flags):
        hidden = int(layer_params[0]["attn"]["q"]["bias"].shape[0])
        head_dim = hidden // n_heads
        worst = max((2.0 ** attn_bits_flags[li][0])
                    * float(lp_["attn_scal"][0, 6])
                    for li, lp_ in enumerate(layers))
        skip_max = (worst / float(np.sqrt(head_dim))
                    * float(np.log2(np.e))) < 100.0
    n = len(layer_params)
    payload_res = all(ao and d for ao, d in fold_flags)
    static = EngineStatic(
        n_layers=n, n_heads=n_heads, ln_eps=ln_eps, hidden_act=hidden_act,
        w4=tuple(w4_flags), fold=tuple(fold_flags),
        res_quant=tuple(res_flags), attn_skip_max=skip_max,
        flex=tuple(flex_flags), attn_bits=tuple(attn_bits_flags),
        io=tuple(io_flags),
        int8_layer=tuple(f and payload_res for f in int8_flags))
    return static, {"layers": layers, "entry_scal": entry_scal}


BACKENDS = ("kernels", "plain")


def parse_backend(backend: str) -> Tuple[str, str, str]:
    """Backend spec -> the (matmul, attention, add+LN) op backends, as the
    JAX ``parse_backend``: ``'kernels'`` or ``'plain'`` for all three op
    kinds, or ``'mix:<mm>,<attn>,<ln>'`` mixing them (e.g.
    ``'mix:kernels,plain,kernels'``: the plain attention between the
    kernels' matmuls and add+LNs)."""
    if backend.startswith("mix:"):
        parts = tuple(backend[4:].split(","))
    else:
        parts = (backend,) * 3
    if len(parts) != 3 or any(p not in BACKENDS for p in parts):
        raise ValueError(f"unknown engine backend {backend!r} (one of "
                         f"{BACKENDS} or 'mix:<mm>,<attn>,<ln>')")
    return parts


# the engine's hidden_act 'gelu' by gelu_impl (the JAX encoder_engine's
# substitution): the tanh form, the degree-10 polynomial, the A-S erf
GELU_IMPLS = {"tanh": "gelu_new", "poly": "gelu_poly10", "exact": "gelu"}


def engine_act(hidden_act: str, gelu_impl: str) -> str:
    """The epilogue activation the engine runs for ``hidden_act``:
    ``'gelu'`` as :data:`GELU_IMPLS` maps ``gelu_impl``, others as they
    are."""
    if gelu_impl not in GELU_IMPLS:
        raise ValueError(f"unknown gelu_impl {gelu_impl!r} (one of "
                         f"{sorted(GELU_IMPLS)})")
    return GELU_IMPLS[gelu_impl] if hidden_act == "gelu" else hidden_act


def encoder_engine(h: Tensor, mask_bias: Tensor, static: EngineStatic,
                   plan: Dict, *, backend: str = "kernels",
                   out_dtype=torch.float32,
                   gelu_impl: str = "tanh") -> Tensor:
    """Run the encoder stack on payloads and value edges.

    ``h``: (B, T, H) float, the (fake-quantized) entry-site value.
    ``mask_bias``: (B, T) float32 additive attention bias. Returns the last
    layer's ln-site value, (B, T, H) in ``out_dtype``. ``backend``
    (:func:`parse_backend`): ``'kernels'`` runs each op through the kernel
    wrappers (the CUDA kernels on the card, their plain versions on the
    CPU), ``'plain'`` the plain versions on any device, the yardstick the
    kernels are held against, and ``'mix:<mm>,<attn>,<ln>'`` picks one of
    the two per op kind. An all-int8 layer is one ``int8_layer_ln`` (its
    attention sites any of 2-16 bits or disabled) under a uniform backend
    and, under a mix, the same chain of matmul, attention and add+LN ops
    (the JAX engine's unfused route: the fused forms are bit-identical to
    it); a flex layer one ``int8_attn_ln`` and one flex ``int8_ffn_ln``
    with the layer's edge modes (``static.io``), under a uniform backend
    only (JAX's refusal); a float entry edge starts the stream as the
    entry value itself, and a float last ``z`` edge is returned as it is.
    With a disabled fold site anywhere the stack takes the non-payload
    residual route (:func:`_non_payload_stack`). ``hidden_act='gelu'``
    runs as ``gelu_impl`` says (:func:`engine_act`).

    ``out_dtype`` is the JAX ``engine_dtype``: the entry value is cast to
    it before its payload is taken (a float entry edge keeps the float32
    value), the non-payload route's residual stream and float matmul
    outputs ride it (bfloat16: the kernels' bfloat16 forms), flex value
    edges stay float32, and the exit value is cast to it.
    """
    mm_be, attn_be, ln_be = parse_backend(backend)
    b, t, hdim = h.shape
    hidden_act = engine_act(static.hidden_act, gelu_impl)
    uniform = mm_be == attn_be == ln_be
    kern = mm_be == "kernels"
    layer_fn = EK.int8_layer_ln if kern else EK.int8_layer_ln_ref
    attn_fn = EK.int8_attn_ln if kern else EK.int8_attn_ln_ref
    ffn_fn = EK.int8_ffn_ln if kern else EK.int8_ffn_ln_ref
    es = plan["entry_scal"]
    hf = h.reshape(b * t, hdim).to(out_dtype)
    # a float entry edge (a 16-bit or sub-8 entry site): the stream starts
    # as the fake-quantized value itself, taken before the out_dtype cast
    # (a bfloat16 hop would leave its grid)
    h8 = (h.reshape(b * t, hdim).to(torch.float32)
          if static.layer_io(0)[0] == "f"
          else EK.quantize_payload(hf, es[0, 0], es[0, 1]))
    mask_bias = mask_bias.to(torch.float32).contiguous()
    # the residual stream rides payloads only when every fold site is
    # enabled (JAX payload_res, all or nothing over the stack)
    payload_res = all(ao and d for ao, d in static.fold)
    if static.any_flex and not (payload_res and uniform):
        raise ValueError("mixed/PEG recipe layers need a uniform engine "
                         f"backend ('kernels' or 'plain'), got {backend!r}")
    if not payload_res:
        hf = _non_payload_stack(h8, hf, mask_bias, static, plan, t,
                                hidden_act, (mm_be, attn_be, ln_be),
                                out_dtype)
        return hf.reshape(b, t, hdim)
    for i, lp in enumerate(plan["layers"]):
        res1, res2 = static.res_quant[i]
        w4q, w4o, w4i, w4d = static.w4[i]
        if not static.int8_layer[i]:
            # the flex route: each edge an int8 payload or a float32 value
            # edge, as the layer's io and flex descriptors say
            x_mode, x_bits, h_bits, y_bits, _, _ = static.layer_flex(i)
            (in_mode, qkv_mode, qkv_bits, z_mode, z_bits, g_bits, u_bits,
             inter_mode, i_bits) = static.layer_io(i)
            hx = attn_fn(
                h8, lp["qkv"]["w"], lp["qkv"]["vecs"], lp["qkv"]["scal"],
                mask_bias, lp["attn_scal"], lp["attn_out"]["w"],
                lp["attn_out"]["vecs"], lp["attn_out"]["scal"],
                lp["ln1"]["gb"], lp["ln1"]["scal"], lp["ln1"].get("lnv"),
                n_heads=static.n_heads, seq=t, eps=static.ln_eps,
                res_quant=res1, skip_max=static.attn_skip_max,
                ln_out="emit" if x_mode == "i8" else "f", ln_bits=x_bits,
                attn_bits=static.layer_attn_bits(i), in_mode=in_mode,
                qkv_mode=qkv_mode, qkv_bits=qkv_bits, g_bits=g_bits,
                u_bits=u_bits, w4q=w4q, w4o=w4o,
                in_grid=lp["qkv"].get("grid"),
                ctx_grid=lp["attn_out"].get("grid"))
            h8 = ffn_fn(
                hx, lp["inter"]["w"], lp["inter"]["vecs"],
                lp["inter"]["scal"], lp["dense"]["w"], lp["dense"]["vecs"],
                lp["dense"]["scal"], hx, lp["ln2"]["gb"], lp["ln2"]["scal"],
                lp["ln2"].get("lnv"), activation=hidden_act,
                eps=static.ln_eps, res_quant=res2, in_mode=x_mode,
                res_mode=x_mode, h_bits=h_bits, y_bits=y_bits,
                ln_out="emit" if z_mode == "i8" else "f", ln_bits=z_bits,
                inter_mode=inter_mode, inter_bits=i_bits,
                x_grid=lp["inter"].get("grid"),
                i_grid=lp["dense"].get("grid"), w4i=w4i, w4d=w4d)
            continue
        if not uniform:
            h8 = _mixed_layer(h8, lp, mask_bias, static, i, t, hidden_act,
                              (mm_be, attn_be, ln_be))
            continue
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
            attn_bits=static.layer_attn_bits(i), w4q=w4q, w4o=w4o, w4i=w4i,
            w4d=w4d, ctx_grid=lp["attn_out"].get("grid"))
    if static.layer_io(static.n_layers - 1)[3] == "f":
        # the last layer's z is a float value edge: the stream already
        # holds the fake-quantized ln-site values
        return h8.to(out_dtype).reshape(b, t, hdim)
    ln2 = plan["layers"][-1]["ln2"]
    if "lnv" in ln2:
        # a per-column plan carries the (per-tensor) ffn.ln.out params
        # broadcast in lnv rows 2/3
        s_l, sh_l = ln2["lnv"][2, 0], ln2["lnv"][3, 0]
    else:
        s_l, sh_l = ln2["scal"][0, 6], ln2["scal"][0, 7]
    hf = EK.dequantize_payload(h8, s_l, sh_l).to(out_dtype)
    return hf.reshape(b, t, hdim)


def _op_fns(backends: Tuple[str, str, str]):
    """(matmul, attention, float add+LN, payload add+LN) of the engine's
    op backends: each op kind's wrapper (``'kernels'``) or plain version
    (``'plain'``)."""
    mm_be, attn_be, ln_be = backends
    kl = ln_be == "kernels"
    return (EK.int8_matmul if mm_be == "kernels" else EK.int8_matmul_ref,
            EK.int8_attention if attn_be == "kernels"
            else EK.int8_attention_ref,
            EK.fused_add_ln if kl else EK.fused_add_ln_ref,
            EK.fused_add_ln_payload if kl else EK.fused_add_ln_payload_ref)


def _mixed_layer(h8: Tensor, lp: Dict, mask_bias: Tensor,
                 static: EngineStatic, i: int, t: int, hidden_act: str,
                 backends: Tuple[str, str, str]) -> Tensor:
    """An all-int8 layer under a mixed backend: the JAX engine's unfused
    route, q|k|v matmul (emit) -> attention -> attn_out matmul (emit on
    its fold site; a float context edge on the float-edge or float x int8
    matmul) -> payload add+LN -> inter matmul (act, emit) -> dense matmul
    (emit) -> payload add+LN, each op on its kind's backend."""
    mm, attn, _, add_ln = _op_fns(backends)
    res1, res2 = static.res_quant[i]
    w4q, w4o, w4i, w4d = static.w4[i]
    attn_bits = static.layer_attn_bits(i)

    def mp(p):
        return p["w"], p["vecs"], p["scal"]

    qkv8 = mm(h8, *mp(lp["qkv"]), activation=None, out_mode="emit", w4=w4q)
    c8 = attn(qkv8, mask_bias, lp["attn_scal"], n_heads=static.n_heads,
              seq=t, skip_max=static.attn_skip_max, attn_bits=attn_bits)
    y8 = mm(c8, *mp(lp["attn_out"]), activation=None, out_mode="emit",
            w4=w4o, in_mode=EK._ctx_mode(attn_bits),
            in_grid=lp["attn_out"].get("grid"))
    h8 = add_ln(y8, h8, lp["ln1"]["gb"], lp["ln1"]["scal"],
                eps=static.ln_eps, res_quant=res1)
    i8 = mm(h8, *mp(lp["inter"]), activation=hidden_act, out_mode="emit",
            w4=w4i)
    y8 = mm(i8, *mp(lp["dense"]), activation=None, out_mode="emit", w4=w4d)
    return add_ln(y8, h8, lp["ln2"]["gb"], lp["ln2"]["scal"],
                  eps=static.ln_eps, res_quant=res2)


def _non_payload_stack(h8: Tensor, hf: Tensor, mask_bias: Tensor,
                       static: EngineStatic, plan: Dict, t: int,
                       hidden_act: str, backends: Tuple[str, str, str],
                       out_dtype=torch.float32) -> Tensor:
    """The JAX engine's non-payload residual route: the residual stream
    ``hf`` is float in ``out_dtype`` (the entry value, then each add+LN's
    float output), and each layer runs q|k|v matmul (emit) -> attention ->
    attn_out matmul (``'fold'`` on its site, or ``'float'`` when the site
    is disabled, in ``out_dtype``; a float context edge, ``'c': 16`` /
    ``'fp32'``, on the float-edge or the float x int8 matmul) ->
    :func:`~.kernels.engine_kernels.fused_add_ln` -> inter matmul (act,
    emit) -> dense matmul (fold or float) -> fused_add_ln, each op on its
    kind's backend. Returns the last layer's float output, (M, H)."""
    mm, attn, add_ln, _ = _op_fns(backends)

    def mp(p):
        return p["w"], p["vecs"], p["scal"]

    for i, lp in enumerate(plan["layers"]):
        ao_fold, d_fold = static.fold[i]
        res1, res2 = static.res_quant[i]
        w4q, w4o, w4i, w4d = static.w4[i]
        attn_bits = static.layer_attn_bits(i)
        qkv8 = mm(h8, *mp(lp["qkv"]), activation=None, out_mode="emit",
                  w4=w4q)
        c8 = attn(qkv8, mask_bias, lp["attn_scal"], n_heads=static.n_heads,
                  seq=t, skip_max=static.attn_skip_max, attn_bits=attn_bits)
        y = mm(c8, *mp(lp["attn_out"]), activation=None,
               out_mode="fold" if ao_fold else "float", w4=w4o,
               in_mode=EK._ctx_mode(attn_bits),
               in_grid=lp["attn_out"].get("grid"), out_dtype=out_dtype)
        h8, hf = add_ln(y, hf, lp["ln1"]["gb"], lp["ln1"]["scal"],
                        eps=static.ln_eps, res_quant=res1,
                        out_dtype=out_dtype)
        i8 = mm(h8, *mp(lp["inter"]), activation=hidden_act, out_mode="emit",
                w4=w4i)
        y = mm(i8, *mp(lp["dense"]), activation=None,
               out_mode="fold" if d_fold else "float", w4=w4d,
               out_dtype=out_dtype)
        h8, hf = add_ln(y, hf, lp["ln2"]["gb"], lp["ln2"]["scal"],
                        eps=static.ln_eps, res_quant=res2,
                        out_dtype=out_dtype)
    return hf
