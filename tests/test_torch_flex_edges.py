"""Port parity for the engine's float edges: 16-bit and disabled attention
sites (quant_dict ``s`` / ``p`` / ``c``), float layer edges (``L`` /
``L{i}`` / ``z``), 16-bit ``ffn.inter.out`` edges and global W8A16 / W8A6,
the paper's leave-one-out and bit-width study, from the plan through the
engine's routes.

The port calibrates a random BERT with each configuration's quant_dict
or act bits on one batch; its params and ranges are carried into JAX, so
both packages run the same numbers, each its own packing, plan and
engine, the port on the CPU, its wrappers on their plain versions. Sizes: the tiny config of
tests/test_engine.py (2 layers, H=64, 4 heads, seq 16); a 12-layer H=256
model for the depth checks; ALBERT's tiny config for its shared layer.

Tolerances:
- engine statics (``io``, ``attn_bits``, ``flex``, ``fold``,
  ``attn_skip_max``) and plans (but the port's edge grids): exact;
- logits: rtol 1e-3 / atol 2e-3 of the JAX engine's XLA backend (and, as
  JAX's own tests hold it, of JAX's generic int path and its Pallas
  kernels in interpret mode), the engine-vs-generic bound of
  tests/test_engine.py; at 12 layers no further from the JAX engine than
  JAX's generic int path is (tests/test_torch_bert_engine.py);
- the attention's plain version against JAX's oracle: payloads equal or
  one level off on at most 0.1% of elements; float context values within
  one level of a 16-bit context site (the raw context of a disabled one:
  one level of a 16-bit probs site times the largest |v|), and off by
  more than a thousandth of that (1e-5 of the largest raw value) on at
  most 1% of elements. JAX sums the float dots and the softmax row in
  float32, the port in float64, and the two frameworks' exp2 differ by
  ulps: a 16-bit probs level or a narrow scores level lands on the other
  side of a tie now and then, and moves a row's context by a level.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as G
from transformer_quantization_tpu.models import albert as JA
from transformer_quantization_tpu.models import bert as JB
from transformer_quantization_tpu.ops import engine as JENG
from transformer_quantization_tpu.ops.pallas import engine_kernels as JEK
from transformer_quantization_tpu.quant import quantizers as JQ
from transformer_quantization_tpu.quant.qconfig import QuantMode as JMode
from transformer_quantization_tpu_torch import convert as C
from transformer_quantization_tpu_torch.models import albert as TA
from transformer_quantization_tpu_torch.models import bert as TB
from transformer_quantization_tpu_torch.ops import engine as TENG
from transformer_quantization_tpu_torch.ops.kernels import engine_kernels as EK
from transformer_quantization_tpu_torch.training import calibration as TC

torch.set_num_threads(2)

RTOL, ATOL = 1e-3, 2e-3
LEVEL_TOL, FRAC_TOL = 1, 1e-3
FLOAT_FRAC_TOL = 1e-2
TINY = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=128,
            max_position_embeddings=64, num_labels=2)
SEQ = 16
# (id, quant_dict, act bits): chip_smoke.py phase 16's configurations, then
# the other keys of the study
CONFIGS = [
    ("s-fp32", {"s": "fp32"}, 8), ("p-fp32", {"p": "fp32"}, 8),
    ("c-fp32", {"c": "fp32"}, 8), ("sp16", {"s": 16, "p": 16}, 8),
    ("c16", {"c": 16}, 8), ("z16", {"z": 16}, 8), ("L16", {"L": 16}, 8),
    ("w8a16", {}, 16), ("w8a6", {}, 6),
    ("L0-16", {"L0": 16}, 8), ("L12", {"L": 12}, 8), ("p0-16", {"p0": 16}, 8),
    ("h-c-fp32", {"h": "fp32", "c": "fp32"}, 8),
]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(vocab, n, seq, seed=1):
    rng = np.random.RandomState(seed)
    return {
        "input_ids": rng.randint(0, vocab, (n, seq)).astype(np.int32),
        "attention_mask": (np.arange(seq)[None, :]
                           < rng.randint(seq // 2, seq + 1, (n, 1))
                           ).astype(np.float32),
        "token_type_ids": np.zeros((n, seq), np.int32),
    }


def _port_defaults(act_bits):
    return dataclasses.replace(TC.w8a8_defaults(), n_bits_act=act_bits)


def _port_qcfg(cfg, qd, act_bits):
    return TB.apply_bert_quant_dict(
        TB.declare_bert_sites(_port_defaults(act_bits), cfg), qd,
        cfg.num_hidden_layers)


def _jax_tree(tree):
    """A nesting of tensors -> the same nesting of JAX arrays."""
    return jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree)


def _jax_qstate(qstate):
    """The port's calibrated per-site ``qp`` -> JAX ``QuantParams``."""
    return {name: {"qp": JQ.QuantParams(
        delta=jnp.asarray(st["qp"].delta.numpy()),
        zero_float=jnp.asarray(st["qp"].zero_float.numpy()),
        signed=jnp.asarray(st["qp"].signed.numpy()))}
        for name, st in qstate.items() if "qp" in st}


_PARAMS = {}


def _params(kw):
    """The port's random BERT of ``kw`` (seed 0), once per size."""
    key = tuple(sorted(kw.items()))
    if key not in _PARAMS:
        _PARAMS[key] = TB.init_bert_params(TB.BertConfig(**kw), seed=0,
                                           device="cpu")
    return _PARAMS[key]


def _setup(kw, qd, act_bits, seq, n=4):
    """Both packages' models of one configuration: the port's random BERT
    calibrated on one batch with ``qd`` over W8A{act_bits}, its params and
    ranges carried into JAX (the same numbers on both sides; the
    calibrations' own parity is tests/test_torch_recipes.py's), each
    package's int8 packing and engine plan, and a request batch."""
    jcfg, tcfg = JB.BertConfig(**kw), TB.BertConfig(**kw)
    tp = _params(kw)
    _, tq, ts = TC.calibrated_bert(tcfg, batch_size=2, seq=seq, seed=0,
                                   device="cpu", params=tp,
                                   defaults=_port_defaults(act_bits),
                                   quant_dict=qd)
    jq = JB.apply_bert_quant_dict(
        JB.declare_bert_sites(dataclasses.replace(
            G._w8a8_defaults(), n_bits_act=act_bits), jcfg), qd,
        jcfg.num_hidden_layers)
    jp, js = _jax_tree(tp), _jax_qstate(ts)
    jint = JB.build_bert_int_params(jp, jq, js)
    jst, jplan, _ = JB.build_bert_engine(jp, jcfg, jq, js, int_params=jint)
    tst, tplan, tint = TB.build_bert_engine(tp, tcfg, tq, ts, device="cpu")
    batch = _batch(kw["vocab_size"], n, seq)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, jq=jq, js=js, jint=jint,
                jst=jst, jplan=jplan, tp=tp, tq=tq, ts=ts, tst=tst,
                tplan=tplan, tint=tint, batch=batch, jb=jb)


def _jax_engine(s, backend="xla"):
    """The JAX engine's logits on the setup's batch (once a backend)."""
    key = f"jax-{backend}"
    if key not in s:
        cfg, q, st = s["jcfg"], s["jq"], s["jst"]
        if backend == "pallas":
            out = JB.bert_engine_apply(
                s["jp"], s["jb"], cfg, q, s["js"], st, s["jplan"], s["jint"],
                backend="pallas", interpret=True)["logits"]
        else:
            out = jax.jit(lambda p, b, qs, plan, ip: JB.bert_engine_apply(
                p, b, cfg, q, qs, st, plan, ip, backend=backend)["logits"])(
                s["jp"], s["jb"], s["js"], s["jplan"], s["jint"])
        s[key] = np.asarray(out)
    return s[key]


def _jax_generic(s):
    """JAX's generic int path's logits on the setup's batch."""
    cfg, q = s["jcfg"], s["jq"]
    return np.asarray(jax.jit(lambda p, b, qs, ip: JB.bert_apply(
        p, b, cfg, q, qs, JMode(), int_params=ip)[0]["logits"])(
        s["jp"], s["jb"], s["js"], s["jint"]))


def _port_engine(s, backend="kernels"):
    return TB.bert_engine_apply(s["tp"], s["batch"], s["tcfg"], s["tq"],
                                s["ts"], s["tst"], s["tplan"], s["tint"],
                                backend=backend, device="cpu")[
        "logits"].numpy()


def _close(got, want):
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


_SETUPS = {}


def _tiny_setup(name, qd, bits):
    """The tiny :func:`_setup` of one configuration, made once."""
    if name not in _SETUPS:
        _SETUPS[name] = _setup(TINY, qd, bits, SEQ)
    return _SETUPS[name]


@pytest.fixture(params=CONFIGS, ids=[c[0] for c in CONFIGS])
def config(request):
    return _tiny_setup(*request.param)


def test_config_plans_and_matches_jax_engine(config):
    """Each configuration builds the port's engine, with JAX's statics and
    plan, and its logits match the JAX engine's; the wrappers (their plain
    versions on CPU tensors) equal the plain backend bit for bit."""
    s = config
    tst, jst = s["tst"], s["jst"]
    for f in ("fold", "res_quant", "attn_skip_max", "attn_bits", "w4",
              "flex", "io", "any_flex"):
        assert getattr(tst, f) == getattr(jst, f), f
    flat_j = jax.tree_util.tree_leaves_with_path(_np(s["jplan"]))
    flat_t = dict(jax.tree_util.tree_leaves_with_path(
        {"layers": [{k: ({kk: vv for kk, vv in v.items() if kk != "grid"}
                         if isinstance(v, dict) else v)
                     for k, v in lp.items()} for lp in s["tplan"]["layers"]],
         "entry_scal": s["tplan"]["entry_scal"]}))
    assert len(flat_j) == len(flat_t)
    for path, v in flat_j:
        np.testing.assert_array_equal(flat_t[path].numpy(), v,
                                      err_msg=str(path))
    EK.reset_launches()
    got = _port_engine(s)
    assert set(EK.LAUNCHES.values()) == {0}   # CPU tensors: plain versions
    _close(got, _jax_engine(s))
    np.testing.assert_array_equal(_port_engine(s, "plain"), got)


# ---------------------------------------------------------------------------
# The JAX engine tests of these routes, ported
# ---------------------------------------------------------------------------

_JAX_TINY = {}


def _jax_tiny():
    """tests/test_engine.py's ``tiny_setup``: JAX's calibrated tiny BERT
    (``__graft_entry__._calibrated_bert``) and its request batch."""
    if not _JAX_TINY:
        cfg = JB.BertConfig(**TINY)
        params, qcfg, qstate = G._calibrated_bert(cfg, batch_size=2, seq=SEQ)
        rng = np.random.RandomState(1)
        batch = {
            "input_ids": rng.randint(0, 128, (4, SEQ)).astype(np.int32),
            "attention_mask": (np.arange(SEQ)[None, :]
                               < rng.randint(8, 17, (4, 1))
                               ).astype(np.float32),
            "token_type_ids": np.zeros((4, SEQ), np.int32)}
        _JAX_TINY.update(cfg=cfg, params=params, qcfg=qcfg, qstate=qstate,
                         batch=batch)
    return _JAX_TINY


def _jax_test_setup(qd=None, act_bits=None, recalibrate=True):
    """A configuration as tests/test_engine.py's tests make it: ``qd`` over
    the tiny setup's sites (or global ``act_bits``), re-estimated on the
    request batch where the test does (``recalibrate``), else the W8A8
    ranges; both packages' engines on the same params and ranges."""
    t = _jax_tiny()
    jcfg, jp, jb = t["cfg"], t["params"], {
        k: jnp.asarray(v) for k, v in t["batch"].items()}
    if act_bits is not None:
        jq = JB.declare_bert_sites(dataclasses.replace(
            G._w8a8_defaults(), n_bits_act=act_bits), jcfg)
    else:
        jq = JB.apply_bert_quant_dict(t["qcfg"], qd, jcfg.num_hidden_layers)
    tcfg = TB.BertConfig(**TINY)
    tq = (_port_qcfg(tcfg, {}, act_bits) if act_bits is not None
          else _port_qcfg(tcfg, qd, 8))
    tp = C.params_from_jax(_np(jp), device="cpu")
    if recalibrate:
        # the ranges re-estimated on the request batch, as the JAX test
        # does (in the port: the calibrations agree, tests/
        # test_torch_bert_engine.py), and carried into JAX
        ts, _ = TC.prepare_quantized_model(
            lambda p, b, **k: TB.bert_apply(p, b, tcfg, **k), tp, tq,
            [t["batch"]], weight_tensors=TB.bert_weight_site_tensors(tp),
            device="cpu")
        js = _jax_qstate(ts)
    else:
        js = t["qstate"]
        ts = C.qstate_from_jax(_np(js), device="cpu")
    jint = JB.build_bert_int_params(jp, jq, js)
    jst, jplan, _ = JB.build_bert_engine(jp, jcfg, jq, js, int_params=jint)
    tst, tplan, tint = TB.build_bert_engine(tp, tcfg, tq, ts, device="cpu")
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, jq=jq, js=js, jint=jint,
                jst=jst, jplan=jplan, tp=tp, tq=tq, ts=ts, tst=tst,
                tplan=tplan, tint=tint, batch=t["batch"], jb=jb)


def _against_jax_routes(s):
    """The port's engine against JAX's generic int path and JAX's engine
    on both backends, as the JAX tests hold JAX's engine."""
    got = _port_engine(s)
    _close(got, _jax_generic(s))
    _close(got, _jax_engine(s))
    _close(got, _jax_engine(s, "pallas"))


@pytest.mark.parametrize("qd,want_io0", [
    ({"L": 16}, ("i8", "f", 16, "f", 16, 16, 16, "f", 16)),
    ({"L0": 16}, ("i8", "f", 16, "f", 16, 16, 16, "f", 16)),
    ({"L": 12}, ("i8", "f", 12, "f", 12, 12, 12, "f", 12)),
], ids=["L16", "L0_16", "L12"])
def test_engine_16bit_layer_key_matches_generic(qd, want_io0):
    """tests/test_engine.py's test of the same name: quant_dict 'L' /
    'L{i}' keys take every act site of a layer off the payload protocol
    (value-space attention, float inter and z edges); the port's engine
    matches JAX's generic int path and its engine on both backends."""
    s = _jax_test_setup(qd)
    assert s["tst"].layer_io(0) == s["jst"].layer_io(0) == want_io0
    _against_jax_routes(s)


def test_engine_w8a16_global():
    """tests/test_engine.py's test of the same name: global 16-bit
    activations take every act edge off the payload protocol, a float
    entry edge first; the engine still matches JAX's generic int path and
    its engine on both backends."""
    s = _jax_test_setup(act_bits=16)
    assert s["tst"].layer_io(0)[:2] == ("f", "f")
    _against_jax_routes(s)


def test_engine_mixed_qkv_widths_rejected():
    """A 16-bit q.out beside 8-bit k / v has no value-space partner: both
    packages refuse it with the same reason; so do a disabled q.out and a
    site wider than 16 bits."""
    t = _jax_tiny()
    s = _jax_test_setup({}, recalibrate=False)
    for pkg_q, build, exc in (
            (s["jq"], lambda q: JB.build_bert_engine(
                s["jp"], t["cfg"], q, s["js"], int_params=s["jint"]),
             JENG.EngineIncompatible),
            (s["tq"], lambda q: TB.build_bert_engine(
                s["tp"], s["tcfg"], q, s["ts"], int_params=s["tint"],
                device="cpu"), TENG.EngineIncompatible)):
        wide = pkg_q.replace_site("L0.attn.q.out", spec=dataclasses.replace(
            pkg_q["L0.attn.q.out"].spec, n_bits=16))
        with pytest.raises(exc, match="share one grid width"):
            build(wide)
        with pytest.raises(exc, match="disabled"):
            build(pkg_q.replace_site("L0.attn.q.out", enabled=False))
        for site in ("L0.attn.context", "L0.ffn.inter.out"):
            with pytest.raises(exc, match="32-bit"):
                build(pkg_q.replace_site(site, spec=dataclasses.replace(
                    pkg_q[site].spec, n_bits=32)))


@pytest.mark.parametrize("qd,want_bits", [({"c": 16}, (8, 8, 16)),
                                          ({"c": "fp32"}, (8, 8, 0))],
                         ids=["ctx16", "ctx_off"])
def test_engine_flex_context_matches_generic(qd, want_bits):
    """tests/test_engine.py's test of the same name: 'c': 16 / 'c': 'fp32'
    (on the W8A8 ranges, as there) hand attn_out a float context edge (on
    the 16-bit grid, or raw); the engine matches JAX's generic int path
    and its engine on both backends."""
    s = _jax_test_setup(qd, recalibrate=False)
    assert s["tst"].layer_attn_bits(0) == want_bits
    assert ("grid" in s["tplan"]["layers"][0]["attn_out"]) == (
        want_bits[2] == 16)
    _against_jax_routes(s)


def test_per_layer_attn_bits_override():
    """tests/test_engine.py's test of the same name: 'p0': 16 gives layer 0
    alone a 16-bit probs site; the engine runs end to end and matches
    JAX's."""
    s = _jax_test_setup({"p0": 16}, recalibrate=False)
    assert s["tst"].layer_attn_bits(0) == (8, 16, 8)
    assert s["tst"].layer_attn_bits(1) == (8, 8, 8)
    got = _port_engine(s)
    assert np.isfinite(got).all()
    _close(got, _jax_engine(s))


def test_skip_max_is_not_proven_for_disabled_scores():
    """A disabled scores site has no grid bound: the plan keeps the
    softmax's max subtraction (JAX's guard), though its identity scale
    would "prove" it dead; on scores past exp2's range the engine stays
    finite and equal to JAX's."""
    s = _tiny_setup("s-fp32", {"s": "fp32"}, 8)
    assert s["jst"].attn_skip_max is False
    assert s["tst"].attn_skip_max is False
    # the same model with every scores site 8-bit proves it dead
    assert _tiny_setup("w8a8", {}, 8)["tst"].attn_skip_max is True
    rng = np.random.RandomState(9)
    nh, t, d = 4, 16, 16
    qkv8 = rng.randint(-128, 128, (2 * t, 3 * nh * d)).astype(np.int8)
    bias = np.zeros((2, t), np.float32)
    sc = np.array([[0.5, 3.0, 0.5, -2.0, 0.015, 1.0, 1.0, 0.0,
                    1 / 255.0, 128.0, 0.01, 2.0]], np.float32)
    want = JEK.int8_attention_ref(jnp.asarray(qkv8), jnp.asarray(bias),
                                  jnp.asarray(sc), n_heads=nh, seq=t,
                                  attn_bits=(0, 8, 8))
    got = EK.int8_attention(torch.from_numpy(qkv8), torch.from_numpy(bias),
                            torch.from_numpy(sc), n_heads=nh, seq=t,
                            skip_max=s["tst"].attn_skip_max,
                            attn_bits=(0, 8, 8))
    _payload_close(want, got)
    # without the max subtraction these scores overflow exp2
    blown = EK.int8_attention_ref(torch.from_numpy(qkv8),
                                  torch.from_numpy(bias),
                                  torch.from_numpy(sc), n_heads=nh, seq=t,
                                  skip_max=True, attn_bits=(0, 8, 8))
    assert not torch.equal(blown, got)


# ---------------------------------------------------------------------------
# The attention's forms against JAX's oracle
# ---------------------------------------------------------------------------


def _payload_close(want, got):
    want = np.asarray(want).astype(np.int32)
    got = got.numpy().astype(np.int32)
    assert want.shape == got.shape
    diff = np.abs(want - got)
    assert diff.max() <= LEVEL_TOL, diff.max()
    assert (diff > 0).mean() <= FRAC_TOL, (diff > 0).mean()


def _context_close(want, got, c_bits, c_s, p_step_v=0.0):
    want = np.asarray(want)
    got = got.numpy()
    assert want.dtype == got.dtype and want.shape == got.shape
    if 1 <= c_bits <= 8:
        _payload_close(want, torch.from_numpy(got))
        return
    diff = np.abs(want.astype(np.float64) - got)
    if c_bits:
        step, near = c_s, 1e-3 * c_s
    else:
        # one level of a 16-bit probs site times the largest |v| value
        step, near = p_step_v, 1e-5 * np.abs(want).max()
    assert diff.max() <= LEVEL_TOL * step + near, diff.max()
    assert (diff > near).mean() <= FLOAT_FRAC_TOL, (diff > near).mean()


ATTN_BITS = [(4, 4), (2, 2), (16, 4), (8, 16), (16, 16), (0, 8), (8, 0),
             (0, 0)]
CTX = {8: (0.01, 2.0), 16: (4e-5, 32768.0 - 40.0), 0: (1.0, 0.0)}


def _attn_scalars(bits, c_bits, value_space=False):
    sc_s, sc_sh = (1.0, 0.0) if bits[0] == 0 else (0.11, 2.0)
    p_s = 1.0 if bits[1] == 0 else 1 / (2.0 ** bits[1] - 1)
    p_sh = 0.0 if bits[1] == 0 else 2.0 ** (bits[1] - 1)
    c_s, c_sh = CTX[c_bits]
    qkv = ([1.0, 0.0] * 3 if value_space
           else [0.02, 3.0, 0.02, -2.0, 0.015, 1.0])
    if value_space and c_bits == 8:
        c_s = 0.5
    return np.asarray([qkv + [sc_s, sc_sh, p_s, p_sh, c_s, c_sh]],
                      np.float32)


@pytest.mark.parametrize("c_bits", [8, 16, 0], ids=["c8", "c16", "c0"])
@pytest.mark.parametrize("bits", ATTN_BITS,
                         ids=[f"s{a}p{b}" for a, b in ATTN_BITS])
def test_attention_bits_matrix(bits, c_bits):
    """tests/test_engine.py's test_attention_bits_matrix_bit_equal on the
    port's plain version (and the wrapper, which runs it on CPU tensors),
    across the context site's three forms: the int8 payload, the 16-bit
    float edge and the disabled (raw) float edge."""
    nh, d, b, t = 4, 16, 2, 32
    rng = np.random.RandomState(5)
    qkv8 = rng.randint(-128, 128, (b * t, 3 * nh * d)).astype(np.int8)
    bias = np.concatenate([np.zeros((b, t - 8), np.float32),
                           np.full((b, 8), -10000.0, np.float32)], axis=1)
    sc = _attn_scalars(bits, c_bits)
    ab = (*bits, c_bits)
    want = JEK.int8_attention_ref(jnp.asarray(qkv8), jnp.asarray(bias),
                                  jnp.asarray(sc), n_heads=nh, seq=t,
                                  attn_bits=ab)
    got = EK.int8_attention(torch.from_numpy(qkv8), torch.from_numpy(bias),
                            torch.from_numpy(sc), n_heads=nh, seq=t,
                            attn_bits=ab)
    v = qkv8[:, 2 * nh * d:].astype(np.float32) + sc[0, 5]
    _context_close(want, got, c_bits, sc[0, 10],
                   sc[0, 8] * sc[0, 4] * np.abs(v).max())


@pytest.mark.parametrize("c_bits", [8, 16, 0], ids=["c8", "c16", "c0"])
@pytest.mark.parametrize("bits", [(16, 16), (6, 6), (0, 0)],
                         ids=["s16p16", "s6p6", "s0p0"])
def test_value_space_attention(bits, c_bits):
    """The value-space form (``dots='f32'``): float32 q / k / v values on
    a 16-bit grid with identity site scalars, as the engine's 16-bit /
    sub-8 q / k / v sites hand it; against JAX's oracle."""
    nh, d, b, t = 4, 16, 2, 32
    rng = np.random.RandomState(6)
    lv = rng.randint(-2000, 2000, (b * t, 3 * nh * d)).astype(np.float32)
    qkv = (lv * np.float32(3e-4)).astype(np.float32)
    bias = np.concatenate([np.zeros((b, t - 5), np.float32),
                           np.full((b, 5), -10000.0, np.float32)], axis=1)
    sc = _attn_scalars(bits, c_bits, value_space=True)
    ab = (*bits, c_bits)
    want = JEK.int8_attention_ref(jnp.asarray(qkv), jnp.asarray(bias),
                                  jnp.asarray(sc), n_heads=nh, seq=t,
                                  attn_bits=ab, dots="f32")
    got = EK.int8_attention(torch.from_numpy(qkv), torch.from_numpy(bias),
                            torch.from_numpy(sc), n_heads=nh, seq=t,
                            attn_bits=ab, dots="f32")
    _context_close(want, got, c_bits, sc[0, 10],
                   sc[0, 8] * np.abs(qkv[:, 2 * nh * d:]).max())


# ---------------------------------------------------------------------------
# Depth and ALBERT
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("qd", [{"c": "fp32"}, {"L": 16}],
                         ids=["c-fp32", "L16"])
def test_full_depth_stays_within_jax_route_gap(qd):
    """tests/test_torch_bert_engine.py's depth gate on these routes: at 12
    layers (H=256) the port's engine is no further from the JAX engine
    than JAX's generic int path is, on 16 sequences."""
    kw = dict(vocab_size=512, hidden_size=256, num_hidden_layers=12,
              num_attention_heads=4, intermediate_size=1024,
              max_position_embeddings=64, num_labels=2)
    s = _setup(kw, qd, 8, 32, n=16)
    got = _port_engine(s)
    j_eng = _jax_engine(s)
    port_gap = float(np.abs(got - j_eng).max())
    jax_gap = float(np.abs(_jax_generic(s) - j_eng).max())
    print(f"{qd}: 12 layers, H=256: max |port engine - JAX engine| = "
          f"{port_gap:.4e}, max |JAX generic int - JAX engine| = "
          f"{jax_gap:.4e}")
    assert np.isfinite(got).all() and got.shape == j_eng.shape
    assert port_gap <= jax_gap


def test_albert_context16_through_prefixes():
    """ALBERT's one shared layer under 'c': 16: every plan layer reads the
    shared sites (``prefixes``), the context grid is made once and shared,
    and the engine matches JAX's."""
    kw = dict(vocab_size=128, embedding_size=32, hidden_size=64,
              num_hidden_layers=3, num_attention_heads=4,
              intermediate_size=128, max_position_embeddings=64,
              num_labels=2)
    jcfg, tcfg = JA.AlbertConfig(**kw), TA.AlbertConfig(**kw)
    tp = TA.init_albert_params(tcfg, seed=0, device="cpu")
    tq = TA.apply_albert_quant_dict(
        TA.declare_albert_sites(TC.w8a8_defaults(), tcfg), {"c": 16},
        tcfg.num_hidden_layers)

    def apply_fn(p, b, **k):
        return TA.albert_apply(p, b, tcfg, **k)

    ts, _ = TC.prepare_quantized_model(
        apply_fn, tp, tq, [TC.calibration_batch(128, 2, SEQ, 0)],
        weight_tensors=TA.albert_weight_site_tensors(tp), device="cpu")
    jq = JA.apply_albert_quant_dict(
        JA.declare_albert_sites(G._w8a8_defaults(), jcfg), {"c": 16},
        jcfg.num_hidden_layers)
    jp, js = _jax_tree(tp), _jax_qstate(ts)
    jst, jplan, jint = JA.build_albert_engine(jp, jcfg, jq, js)
    assert jst.layer_attn_bits(2) == (8, 8, 16)
    tst, tplan, tint = TA.build_albert_engine(tp, tcfg, tq, ts, device="cpu")
    assert tst.attn_bits == jst.attn_bits
    grids = {id(lp["attn_out"]["grid"]) for lp in tplan["layers"]}
    assert len(grids) == 1
    batch = _batch(128, 4, SEQ)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = jax.jit(lambda p, b, qs, plan, ip: JA.albert_engine_apply(
        p, b, jcfg, jq, qs, jst, plan, ip, backend="xla")["logits"])(
        jp, jb, js, jplan, jint)
    got = TA.albert_engine_apply(tp, batch, tcfg, tq, ts, tst, tplan, tint,
                                 device="cpu")["logits"]
    _close(got.numpy(), want)
