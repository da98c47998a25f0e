"""Port parity: the MobileBERT int8 engine path against the JAX package.

The JAX package initialises and calibrates a random MobileBERT (W8A8
current-minmax, one calibration batch, ``prepare_quantized_model``);
``convert.py`` carries its params, qstate and int_params across and the
port's counterparts run on the CPU, on the same seeded numpy batches.
Sizes: the tiny config of tests/test_mobilebert.py (head_dim 8), and a
wider one at MobileBERT's head_dim 32 (bottleneck 128, 4 heads, H=256,
seq 32), two layers each; 24 layers at the tiny width for the depth
check.

Tolerances:
- int8 packing, the engine plan and integer-only stages (matmul, fold,
  requant, relu, NoNorm): exact;
- payloads after exp2 (attention) or a reordered rounding (the Pallas
  megakernel multiplies by 1 / out_s where the oracles divide): at most
  one level off on at most 1% of elements;
- logits (fake-quant forward, generic int path, engine vs the JAX
  engine's XLA backend): rtol 1e-3 / atol 2e-3; at 24 layers, no further
  from the JAX engine than the JAX generic int path is;
- calibrated deltas / zero points: within 1e-6 relative wherever the
  site's input is computed by the same float ops (the tiny config, the
  embeddings and layer 0), 1e-2 deeper at the wide size, where a
  one-level flip in an upstream site moves later ranges.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as G
import chip_smoke as CS
from transformer_quantization_tpu.models import mobilebert as JM
from transformer_quantization_tpu.ops.engine import EngineIncompatible as JInc
from transformer_quantization_tpu.ops.pallas import engine_kernels as JEK
from transformer_quantization_tpu.quant.qconfig import QuantMode as JMode
from transformer_quantization_tpu.training.calibration import (
    prepare_quantized_model,
)
from transformer_quantization_tpu_torch import convert as C
from transformer_quantization_tpu_torch.models import mobilebert as TM
from transformer_quantization_tpu_torch.ops import engine as TENG
from transformer_quantization_tpu_torch.ops.kernels import engine_kernels as EK
from transformer_quantization_tpu_torch.quant.qconfig import QuantMode
from transformer_quantization_tpu_torch.training import calibration as TC

torch.set_num_threads(2)

TINY = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=32, embedding_size=8,
            intra_bottleneck_size=16, max_position_embeddings=64,
            num_labels=2)
CONFIGS = {
    "tiny": (TINY, 16),
    "wide": (dict(vocab_size=256, hidden_size=256, num_hidden_layers=2,
                  num_attention_heads=4, intermediate_size=256,
                  embedding_size=32, intra_bottleneck_size=128,
                  max_position_embeddings=64, num_labels=2), 32),
}
ATTN_CASES = {
    "shared_kq": {},
    "bottleneck": {"use_bottleneck_attention": True},
    # plain attention over the full hidden stream needs TH == H
    "plain": {"key_query_shared_bottleneck": False,
              "intra_bottleneck_size": 32},
}
RTOL, ATOL = 1e-3, 2e-3
LEVEL_TOL, FRAC_TOL = 1, 1e-2


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _request_batch(vocab, n, seq, seed=1):
    rng = np.random.RandomState(seed)
    return {"input_ids": rng.randint(0, vocab, (n, seq)).astype(np.int32),
            "attention_mask": (np.arange(seq)[None, :]
                               < rng.randint(seq // 2, seq + 1, (n, 1))
                               ).astype(np.float32),
            "token_type_ids": np.zeros((n, seq), np.int32)}


def _jax_calibrated(jcfg, seq, defaults=None, quant_dict=None):
    """JAX init (PRNGKey 0) + one-batch calibration
    (``prepare_quantized_model``, eager: jitted, XLA's fusions move the
    deeper wide-config ranges by up to 1.3e-2) on the batch the port's
    ``calibrated_mobilebert`` draws."""
    params = JM.init_mobilebert_params(jax.random.PRNGKey(0), jcfg)
    qcfg = JM.declare_mobilebert_sites(defaults or G._w8a8_defaults(), jcfg,
                                       quant_dict=quant_dict)
    batch = _jbatch(TC.calibration_batch(jcfg.vocab_size, 2, seq, 0))
    qstate, _ = prepare_quantized_model(
        functools.partial(JM.mobilebert_apply, cfg=jcfg), params, qcfg,
        [batch], weight_tensors=JM.mobilebert_weight_site_tensors(params))
    return params, qcfg, qstate


def _build(kw, seq):
    jcfg, tcfg = JM.MobileBertConfig(**kw), TM.MobileBertConfig(**kw)
    jp, jq, js = _jax_calibrated(jcfg, seq)
    jint = JM.build_mobilebert_int_params(jp, jq, js)
    jstatic, jplan, _ = JM.build_mobilebert_engine(jp, jcfg, jq, js,
                                                   int_params=jint)
    tp = C.params_from_jax(_np(jp), device="cpu")
    ts = C.qstate_from_jax(_np(js), device="cpu")
    tint = C.int_params_from_jax(_np(jint), device="cpu")
    _, tq, ts_own = TC.calibrated_mobilebert(tcfg, batch_size=2, seq=seq,
                                             device="cpu", params=tp)
    batch = _request_batch(kw["vocab_size"], 4, seq)
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, jq=jq, js=js, jint=jint,
                jstatic=jstatic, jplan=jplan, tp=tp, tq=tq, ts=ts,
                ts_own=ts_own, tint=tint, batch=batch, jbatch=_jbatch(batch),
                seq=seq)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def setup(request):
    s = _build(*CONFIGS[request.param])
    s["name"] = request.param
    return s


def _payload_close(want, got, exact):
    """int8 payloads: equal, or (not ``exact``) at most one level off on at
    most 1% of elements."""
    want = np.asarray(want).astype(np.int32)
    got = got.numpy().astype(np.int32)
    assert want.shape == got.shape
    if exact:
        np.testing.assert_array_equal(got, want)
    diff = np.abs(want - got)
    assert diff.max() <= LEVEL_TOL, diff.max()
    assert (diff > 0).mean() <= FRAC_TOL, (diff > 0).mean()


def _logits_close(want, got):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


# ---------------------------------------------------------------------------
# Calibration, packing, conversion, forward
# ---------------------------------------------------------------------------


def test_calibration_matches_jax(setup):
    js = _np(setup["js"])
    assert set(js) == set(setup["ts_own"])
    for name, st in js.items():
        qp = setup["ts_own"][name]["qp"]
        strict = (setup["name"] == "tiny"
                  or name.startswith(("emb.", "L0.")))
        tol = 1e-6 if strict else 1e-2
        d_j, d_t = np.asarray(st["qp"].delta), qp.delta.numpy()
        assert np.all(np.abs(d_j - d_t) <= tol * np.abs(d_j)), name
        z_j, z_t = np.asarray(st["qp"].zero_float), qp.zero_float.numpy()
        assert np.all(np.abs(z_j - z_t)
                      <= tol * np.maximum(1.0, np.abs(z_j))), name


def test_convert_carries_mobilebert_trees(setup):
    """params (nested dicts and the per-layer FFN lists), qstate and
    int_params convert leaf for leaf."""
    flat_j = jax.tree_util.tree_leaves_with_path(_np(setup["jp"]))
    flat_t = dict(jax.tree_util.tree_leaves_with_path(setup["tp"]))
    assert len(flat_j) == len(flat_t)
    for path, v in flat_j:
        np.testing.assert_array_equal(flat_t[path].numpy(), v,
                                      err_msg=str(path))
    js = _np(setup["js"])
    assert set(js) == set(setup["ts"])
    for name, st in js.items():
        np.testing.assert_array_equal(setup["ts"][name]["qp"].delta.numpy(),
                                      np.asarray(st["qp"].delta))
    assert set(setup["tint"]) == set(_np(setup["jint"]))


def test_int_params_pack_exactly(setup):
    tint = TM.build_mobilebert_int_params(setup["tp"], setup["tq"],
                                          setup["ts"])
    jint = _np(setup["jint"])
    assert set(tint) == set(jint)
    assert not any(k.endswith("norm") for k in tint)
    for name, p in jint.items():
        for k, v in p.items():
            if k == "n_bits":
                assert tint[name][k] == v
            else:
                np.testing.assert_array_equal(tint[name][k].numpy(), v)


@pytest.mark.parametrize("route", ["fp", "fake_quant", "generic_int"])
def test_forward_matches_jax(setup, route):
    cfg, q = setup["jcfg"], setup["jq"]
    tq, ts = setup["tq"], setup["ts"]
    if route == "fp":
        want = JM.mobilebert_apply(setup["jp"], setup["jbatch"], cfg)[0]
        got = TM.mobilebert_apply(setup["tp"], setup["batch"], setup["tcfg"],
                                  device="cpu")[0]
    else:
        jint = setup["jint"] if route == "generic_int" else None
        tint = setup["tint"] if route == "generic_int" else None
        want = JM.mobilebert_apply(setup["jp"], setup["jbatch"], cfg, q,
                                   setup["js"], JMode(),
                                   int_params=jint)[0]
        got = TM.mobilebert_apply(setup["tp"], setup["batch"], setup["tcfg"],
                                  tq, ts, QuantMode(), int_params=tint,
                                  device="cpu")[0]
    _logits_close(want["logits"], got["logits"])


# ---------------------------------------------------------------------------
# The engine plan and the plain versions at layer 0
# ---------------------------------------------------------------------------


def test_engine_plan_matches_jax(setup):
    tst, tplan, _ = TM.build_mobilebert_engine(setup["tp"], setup["tcfg"],
                                               setup["tq"], setup["ts"],
                                               device="cpu")
    jst = setup["jstatic"]
    for f in ("n_layers", "n_heads", "hidden", "n_ffn", "attn_case",
              "hidden_act", "res_quant", "w4", "attn_skip_max", "attn_bits"):
        assert getattr(tst, f) == getattr(jst, f), f
    flat_j = jax.tree_util.tree_leaves_with_path(_np(setup["jplan"]))
    flat_t = dict(jax.tree_util.tree_leaves_with_path(tplan))
    assert len(flat_j) == len(flat_t)
    for path, v in flat_j:
        np.testing.assert_array_equal(flat_t[path].numpy(), v,
                                      err_msg=str(path))


@pytest.fixture(scope="module")
def layer0(setup):
    """Layer 0's plan (JAX and converted) and its payloads on the request
    batch, computed with the JAX oracles."""
    cfg, q, js = setup["jcfg"], setup["jq"], setup["js"]
    ctx = JM.B.make_ctx(q, js, JMode(), int_params=setup["jint"])
    ids, tt, pos, _ = JM.B.prepare_inputs(setup["jbatch"])
    h = JM._embeddings(ctx, setup["jp"], cfg, ids, tt, pos, False, None)
    plan = setup["jplan"]
    es = plan["entry_scal"]
    n, seq = h.shape[0], setup["seq"]
    h8 = JEK.quantize_payload(h.reshape(n * seq, -1), es[0, 0], es[0, 1])
    bias = (1.0 - setup["jbatch"]["attention_mask"]) * -10000.0
    lp = plan["layers"][0]
    st = setup["jstatic"]

    def norm(x8, mp, npl, r8, res_quant):
        return JEK.int8_matmul_add_ln_ref(
            x8, mp["w"], mp["vecs"], mp["scal"], r8, npl["gb"], npl["scal"],
            eps=0.0, res_quant=res_quant, norm="nonorm")

    li8 = norm(h8, lp["bn_in"], lp["bn_in_norm"], None, False)
    sh8 = norm(h8, lp["bn_attn"], lp["bn_attn_norm"], None, False)
    qk8 = JEK.int8_matmul_ref(sh8, lp["qk"]["w"], lp["qk"]["vecs"],
                              lp["qk"]["scal"])
    v8 = JEK.int8_matmul_ref(h8, lp["v"]["w"], lp["v"]["vecs"],
                             lp["v"]["scal"])
    akw = dict(n_heads=st.n_heads, seq=seq, hidden=st.hidden, cols=(0, 1, 0),
               skip_max=st.attn_skip_max)
    c8 = JEK.int8_attention_qkv_ref(qk8, qk8, v8, bias, lp["attn_scal"],
                                    **akw)
    x8 = norm(c8, lp["attn_out"], lp["attn_out_norm"], li8,
              st.res_quant[0][0])
    j = dict(h8=h8, bias=bias, li8=li8, sh8=sh8, qk8=qk8, v8=v8, c8=c8,
             x8=x8)
    tplan = jax.tree.map(_t, plan)
    return dict(j=j, t={k: _t(v) for k, v in j.items()}, lp=lp,
                tlp=tplan["layers"][0], akw=akw, static=st)


@pytest.mark.parametrize("branch,xin", [("bn_in", "h8"), ("bn_attn", "h8")])
def test_int8_matmul_norm_ref(layer0, branch, xin):
    lp, tlp = layer0["lp"], layer0["tlp"]
    args = lambda p, x: (x, p[branch]["w"], p[branch]["vecs"],  # noqa: E731
                         p[branch]["scal"], p[branch + "_norm"]["gb"],
                         p[branch + "_norm"]["scal"])
    want = JEK.int8_matmul_norm_ref(*args(lp, layer0["j"][xin]), eps=0.0)
    got = EK.int8_matmul_norm_ref(*args(tlp, layer0["t"][xin]), eps=0.0)
    _payload_close(want, got, exact=True)


@pytest.mark.parametrize("res_quant", [True, False])
def test_int8_matmul_add_ln_ref_nonorm(layer0, res_quant):
    lp, tlp = layer0["lp"], layer0["tlp"]

    def args(p, v):
        return (v["c8"], p["attn_out"]["w"], p["attn_out"]["vecs"],
                p["attn_out"]["scal"], v["li8"], p["attn_out_norm"]["gb"],
                p["attn_out_norm"]["scal"])

    kw = dict(eps=0.0, res_quant=res_quant, norm="nonorm")
    want = JEK.int8_matmul_add_ln_ref(*args(lp, layer0["j"]), **kw)
    got = EK.int8_matmul_add_ln_ref(*args(tlp, layer0["t"]), **kw)
    _payload_close(want, got, exact=True)


@pytest.mark.parametrize("form", ["residual res_quant", "residual",
                                  "no residual"])
@pytest.mark.parametrize("m,k,n,seed", [(1000, 80, 136, 20),
                                        (1000, 80, 264, 21),
                                        (257, 128, 520, 22)])
def test_nonorm_refs_at_ragged_shapes(m, k, n, seed, form):
    """K6's plain versions against JAX's at the ragged shapes the card
    holds the kernel to them at (chip_smoke.NORM_SHAPES and its seeds, the
    last at 257 rows), on chip_smoke.norm_inputs: bit-identical payloads
    that spread over most of the int8 grid."""
    arrays = CS.norm_inputs(m, k, n, seed)
    jx, tx = [jnp.asarray(a) for a in arrays], [_t(a) for a in arrays]
    if form == "no residual":
        want = JEK.int8_matmul_norm_ref(*jx[:4], *jx[5:], eps=0.0)
        got = EK.int8_matmul_norm_ref(*tx[:4], *tx[5:], eps=0.0)
    else:
        kw = dict(eps=0.0, res_quant=form == "residual res_quant",
                  norm="nonorm")
        want = JEK.int8_matmul_add_ln_ref(*jx, **kw)
        got = EK.int8_matmul_add_ln_ref(*tx, **kw)
    _payload_close(want, got, exact=True)
    assert len(np.unique(got.numpy())) > 128


def _ffn_args(p, x8):
    f = p["ffns"][0]
    return (x8, f["inter"]["w"], f["inter"]["vecs"], f["inter"]["scal"],
            f["dense"]["w"], f["dense"]["vecs"], f["dense"]["scal"], x8,
            f["norm"]["gb"], f["norm"]["scal"])


def test_int8_ffn_ln_ref_nonorm_relu(layer0):
    kw = dict(activation="relu", eps=0.0, norm="nonorm")
    want = JEK.int8_ffn_ln_ref(*_ffn_args(layer0["lp"], layer0["j"]["x8"]),
                               **kw)
    got = EK.int8_ffn_ln_ref(*_ffn_args(layer0["tlp"], layer0["t"]["x8"]),
                             **kw)
    _payload_close(want, got, exact=True)
    f, tf = layer0["lp"]["ffns"][0]["inter"], layer0["tlp"]["ffns"][0]["inter"]
    _payload_close(
        JEK.int8_matmul_ref(layer0["j"]["x8"], f["w"], f["vecs"], f["scal"],
                            activation="relu"),
        EK.int8_matmul_ref(layer0["t"]["x8"], tf["w"], tf["vecs"],
                           tf["scal"], activation="relu"), exact=True)


@pytest.mark.parametrize("skip_max", [True, False])
def test_int8_attention_qkv_ref(layer0, skip_max):
    akw = dict(layer0["akw"], skip_max=skip_max)
    j, t = layer0["j"], layer0["t"]
    want = JEK.int8_attention_qkv_ref(j["qk8"], j["qk8"], j["v8"], j["bias"],
                                      layer0["lp"]["attn_scal"], **akw)
    got = EK.int8_attention_qkv_ref(t["qk8"], t["qk8"], t["v8"], t["bias"],
                                    layer0["tlp"]["attn_scal"], **akw)
    _payload_close(want, got, exact=False)


def _layer_kw(st, seq):
    return dict(n_heads=st.n_heads, seq=seq, hidden=st.hidden,
                attn_case=st.attn_case, activation=st.hidden_act,
                res=st.res_quant[0], w4=st.w4[0], n_ffn=st.n_ffn,
                skip_max=st.attn_skip_max)


def test_layer_wrappers_equal_plain_layer_on_cpu(setup, layer0):
    """The whole-layer wrapper and the chain's wiring, on CPU tensors (so
    on their plain versions): bit-identical to the plain whole layer, and
    no kernel launch counted."""
    EK.reset_launches()
    tlp, t = layer0["tlp"], layer0["t"]
    flat = EK.mb_layer_flat(tlp, "shared_kq")
    kw = _layer_kw(layer0["static"], setup["seq"])
    want = EK.int8_mb_layer_ln_ref(t["h8"], t["bias"], tlp["attn_scal"],
                                   flat, **kw)
    for got in (EK.int8_mb_layer_ln(t["h8"], t["bias"], tlp["attn_scal"],
                                    flat, **kw),
                EK.mb_layer_chain(t["h8"], t["bias"], tlp["attn_scal"],
                                  flat, **kw)):
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    fkw = dict(activation="relu", eps=0.0, norm="nonorm")
    np.testing.assert_array_equal(
        EK.int8_ffn_ln(*_ffn_args(tlp, t["x8"]), **fkw).numpy(),
        EK.int8_ffn_ln_ref(*_ffn_args(tlp, t["x8"]), **fkw).numpy())
    assert set(EK.LAUNCHES.values()) == {0}


def _interpreted_layer(h8, bias, ascal, flat, **kw):
    """The JAX megakernel in interpret mode, jitted: one program for the
    kernel body's ops, where eagerly each grid step dispatches them one by
    one."""
    return jax.jit(lambda *a: JEK.int8_mb_layer_ln(
        *a[:3], a[3:], interpret=True, **kw))(h8, bias, ascal, *flat)


@pytest.mark.parametrize("setup", ["tiny"], indirect=True)
def test_int8_mb_layer_ln_against_pallas_interpret(setup, layer0):
    """The port's plain whole layer against the JAX MobileBERT megakernel
    in interpret mode, as tests/test_mobilebert.py runs it (tiny config
    only, to keep the suite's time)."""
    st, seq = layer0["static"], setup["seq"]
    j, t = layer0["j"], layer0["t"]
    kw = _layer_kw(st, seq)
    want = _interpreted_layer(
        j["h8"], j["bias"], layer0["lp"]["attn_scal"],
        JEK.mb_layer_flat(layer0["lp"], st.attn_case),
        attn_bits=st.layer_attn_bits(0), **kw)
    got = EK.int8_mb_layer_ln_ref(
        t["h8"], t["bias"], layer0["tlp"]["attn_scal"],
        EK.mb_layer_flat(layer0["tlp"], st.attn_case), **kw)
    _payload_close(want, got, exact=False)


@pytest.mark.parametrize("seq", [32, 64])
@pytest.mark.parametrize("setup", ["wide"], indirect=True)
def test_int8_mb_layer_ln_against_pallas_interpret_stacked(setup, layer0,
                                                           seq):
    """The layer kernel's shorter seqs: the port's plain whole layer
    against the JAX megakernel in interpret mode at S = 32 and 64 on the
    wide config's layer 0 (head_dim 32, the card kernel's), on a seeded
    payload and padding of 8 sequences, which JAX stacks 8 to a block
    (``batch_block``: 256 and 512 rows)."""
    st = layer0["static"]
    rng = np.random.RandomState(seq)
    h8 = rng.randint(-60, 60, (8 * seq, setup["tcfg"].hidden_size)).astype(
        np.int8)
    lens = rng.randint(1, seq + 1, 8)
    bias = np.where(np.arange(seq)[None, :] < lens[:, None], 0.0,
                    -10000.0).astype(np.float32)
    kw = _layer_kw(st, seq)
    want = _interpreted_layer(
        jnp.asarray(h8), jnp.asarray(bias), layer0["lp"]["attn_scal"],
        JEK.mb_layer_flat(layer0["lp"], st.attn_case),
        attn_bits=st.layer_attn_bits(0), **kw)
    got = EK.int8_mb_layer_ln_ref(
        torch.from_numpy(h8), torch.from_numpy(bias),
        layer0["tlp"]["attn_scal"],
        EK.mb_layer_flat(layer0["tlp"], st.attn_case), **kw)
    _payload_close(want, got, exact=False)


# ---------------------------------------------------------------------------
# The engine end to end
# ---------------------------------------------------------------------------


def _jax_engine_logits(jcfg, jq, js, jp, jplan, jint, jst, jbatch,
                       jit=True):
    """The JAX engine's logits on its XLA backend: jitted (eagerly it
    compiles op by op), or eager for a deep stack (whose unrolled program
    takes longer to trace and compile than the shared op compiles)."""
    def fn(p, b, s, plan, ip):
        return JM.mobilebert_engine_apply(p, b, jcfg, jq, s, jst, plan, ip,
                                          backend="xla")["logits"]
    return np.asarray((jax.jit(fn) if jit else fn)(jp, jbatch, js, jplan,
                                                   jint))


@pytest.mark.parametrize("attn_case", sorted(ATTN_CASES))
def test_engine_matches_jax_engine(attn_case):
    """Every attention topology, tiny config: the port's engine on its
    plain versions (whole-layer and chain routes) and through the kernel
    wrappers (on CPU tensors) against the JAX engine's XLA backend."""
    kw = dict(TINY, **ATTN_CASES[attn_case])
    s = _build(kw, 16)
    assert s["jstatic"].attn_case == attn_case
    want = _jax_engine_logits(s["jcfg"], s["jq"], s["js"], s["jp"],
                              s["jplan"], s["jint"], s["jstatic"],
                              s["jbatch"])
    tst, tplan, tint = TM.build_mobilebert_engine(s["tp"], s["tcfg"],
                                                  s["tq"], s["ts"],
                                                  device="cpu")
    got = {}
    for backend in ("plain", "kernels"):
        for fuse in (True, False):
            got[backend, fuse] = TM.mobilebert_engine_apply(
                s["tp"], s["batch"], s["tcfg"], s["tq"], s["ts"], tst, tplan,
                tint, backend=backend, fuse_layer=fuse,
                device="cpu")["logits"]
            _logits_close(want, got[backend, fuse])
    for logits in got.values():
        np.testing.assert_array_equal(logits.numpy(),
                                      got["plain", True].numpy())


ROUTES = {"tiny": {32: "chain", 64: "chain", 128: "chain"},
          "wide": {32: "k8", 64: "k8", 128: "k8"}}


def test_the_plan_chooses_the_route_by_seq(setup, monkeypatch):
    """The default kernels route is the plan's, chosen when it is made:
    the layer kernel where it is built ((seq, head_dim, heads) in
    ``EK.MB_LAYER_SHAPES``: the wide config at S = 32, 64 and 128), the
    chain elsewhere (every seq of the tiny config's head_dim 8; a seq or a
    head_dim that is not built). At S = 64 the default route runs the
    plan's route and matches the JAX engine."""
    s = setup
    tst, tplan, tint = TM.build_mobilebert_engine(s["tp"], s["tcfg"],
                                                  s["tq"], s["ts"],
                                                  device="cpu")
    routes = {t: tst.layer_route(t) for t in (32, 64, 128)}
    assert routes == ROUTES[s["name"]]
    assert tst.k8_seqs == tuple(t for t, r in routes.items() if r == "k8")
    for seq, head_dim in ((256, 32), (64, 64)):
        why = EK.mb_layer_refusal(
            seq=seq, head_dim=head_dim, n_heads=4, h=512, inter=512,
            attn_case=tst.attn_case, activation="relu", n_ffn=3,
            attn_bits=(8, 8, 8), w4=(False,))
        assert why is not None and "not built" in why
    calls = {"int8_mb_layer_ln": 0, "mb_layer_chain": 0}
    for name in calls:
        real = getattr(EK, name)

        # the plain whole layer is itself a chain on the plain versions:
        # only the engine's own calls (on the kernel wrappers) count
        def rec(*a, _real=real, _name=name, **k):
            calls[_name] += not k.get("plain", False)
            return _real(*a, **k)
        monkeypatch.setattr(EK, name, rec)
    batch = _request_batch(s["tcfg"].vocab_size, 4, 64, seed=2)
    want = _jax_engine_logits(s["jcfg"], s["jq"], s["js"], s["jp"],
                              s["jplan"], s["jint"], s["jstatic"],
                              _jbatch(batch))
    got = TM.mobilebert_engine_apply(s["tp"], batch, s["tcfg"], s["tq"],
                                     s["ts"], tst, tplan, tint,
                                     device="cpu")["logits"]
    n_layers = s["tcfg"].num_hidden_layers
    k8 = routes[64] == "k8"
    assert calls == {"int8_mb_layer_ln": n_layers * k8,
                     "mb_layer_chain": n_layers * (not k8)}
    _logits_close(want, got)


def test_engine_at_full_depth_stays_within_jax_route_gap():
    """MobileBERT-uncased depth (24 layers) at the tiny width: a rare
    one-level payload flip spreads through its sequence's later layers,
    so the gate is the JAX package's own gap: on 4 sequences the port's
    engine is no further from the JAX engine than the JAX generic int
    path is. ``pytest -s`` prints both gaps."""
    kw = dict(TINY, num_hidden_layers=24)
    seq = 16
    jcfg = JM.MobileBertConfig(**kw)
    jp, jq, js = _jax_calibrated(jcfg, seq)
    jint = JM.build_mobilebert_int_params(jp, jq, js)
    jst, jplan, _ = JM.build_mobilebert_engine(jp, jcfg, jq, js,
                                               int_params=jint)
    batch = _request_batch(kw["vocab_size"], 4, seq)
    jb = _jbatch(batch)
    j_eng = _jax_engine_logits(jcfg, jq, js, jp, jplan, jint, jst, jb,
                               jit=False)
    j_gen = np.asarray(JM.mobilebert_apply(jp, jb, jcfg, jq, js, JMode(),
                                           int_params=jint)[0]["logits"])
    tcfg = TM.MobileBertConfig(**kw)
    tp = C.params_from_jax(_np(jp), device="cpu")
    ts = C.qstate_from_jax(_np(js), device="cpu")
    _, tq, _ = TC.calibrated_mobilebert(tcfg, seq=seq, device="cpu",
                                        params=tp)
    tst, tplan, tint = TM.build_mobilebert_engine(tp, tcfg, tq, ts,
                                                  device="cpu")
    got = TM.mobilebert_engine_apply(tp, batch, tcfg, tq, ts, tst, tplan,
                                     tint, device="cpu")["logits"].numpy()
    port_gap = float(np.abs(got - j_eng).max())
    jax_gap = float(np.abs(j_gen - j_eng).max())
    print(f"24 layers, tiny width, seq {seq}, 4 sequences: max |port engine"
          f" - JAX engine| = {port_gap:.4e}, max |JAX generic int - JAX "
          f"engine| = {jax_gap:.4e}, logit scale "
          f"{float(np.abs(j_eng).max()):.4e}")
    assert np.isfinite(got).all() and got.shape == j_eng.shape
    assert port_gap <= jax_gap


def test_port_calibration_drives_its_own_engine():
    """From the port's own init: calibrate, pack, plan, serve; the engine
    stays close to the fake-quant simulation."""
    cfg = TM.MobileBertConfig(**TINY)
    params, qcfg, qstate = TC.calibrated_mobilebert(cfg, seq=16, seed=3,
                                                    device="cpu")
    static, plan, ip = TM.build_mobilebert_engine(params, cfg, qcfg, qstate,
                                                  device="cpu")
    batch = _request_batch(cfg.vocab_size, 4, 16, seed=4)
    eng = TM.mobilebert_engine_apply(params, batch, cfg, qcfg, qstate,
                                     static, plan, ip, device="cpu")["logits"]
    sim, _ = TM.mobilebert_apply(params, batch, cfg, qcfg, qstate,
                                 device="cpu")
    assert eng.shape == (4, cfg.num_labels) and torch.isfinite(eng).all()
    np.testing.assert_allclose(eng.numpy(), sim["logits"].numpy(),
                               rtol=5e-2, atol=5e-2)


# ---------------------------------------------------------------------------
# What the engine does not take
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("qd", [
    {"attn_probs_n_bits_act": 16}, {"attn_scores": False},
    {"attn_probs": False}, {"attn_output": False},
], ids=["probs16", "scores_off", "probs_off", "ctx_off"])
def test_attention_overrides_not_yet_ported(qd):
    """The JAX engine serves the quant_dict attention overrides; the port
    raises until they are ported."""
    cfg = TM.MobileBertConfig(**TINY)
    params, qcfg, qstate = TC.calibrated_mobilebert(cfg, seq=16,
                                                    device="cpu",
                                                    quant_dict=qd)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        TM.build_mobilebert_engine(params, cfg, qcfg, qstate, device="cpu")


def test_engine_incompatible_configs():
    """The JAX engine's EngineIncompatible reasons; int4 weights plan (the
    W4A8 engine: tests/test_torch_mobilebert_w4.py)."""
    cfg = TM.MobileBertConfig(**TINY)
    params, qcfg, qstate = TC.calibrated_mobilebert(cfg, seq=16,
                                                    device="cpu")
    # 4-bit weights pack as split-half int4 (NoNorm sites stay
    # elementwise, the tables int8), every matmul's w4 flag set
    d4 = dataclasses.replace(TC.w8a8_defaults(), n_bits=4, n_bits_act=8)
    _, q4, s4 = TC.calibrated_mobilebert(cfg, seq=16, device="cpu",
                                         params=params, defaults=d4)
    packed = TM.build_mobilebert_int_params(params, q4, s4, use_int4=True)
    assert packed["L0.bn.in.dense"]["w_packed"].dtype == torch.uint8
    assert "w_int" in TM.build_mobilebert_int_params(params, q4, s4)[
        "L0.bn.in.dense"]
    assert not any(k.endswith("norm") for k in packed)
    st4 = TM.build_mobilebert_engine(params, cfg, q4, s4, use_int4=True,
                                     device="cpu")[0]
    assert all(all(f) for f in st4.w4)
    # global 16-bit activations: the same reason as JAX
    d16 = dataclasses.replace(TC.w8a8_defaults(), n_bits_act=16)
    _, q16, s16 = TC.calibrated_mobilebert(cfg, seq=16, device="cpu",
                                           params=params, defaults=d16)
    with pytest.raises(TENG.EngineIncompatible, match="16-bit"):
        TM.build_mobilebert_engine(params, cfg, q16, s16, device="cpu")
    jcfg = JM.MobileBertConfig(**TINY)
    jp, jq, js = _jax_calibrated(jcfg, 16,
                                 defaults=dataclasses.replace(
                                     G._w8a8_defaults(), n_bits_act=16))
    with pytest.raises(JInc, match="16-bit"):
        JM.build_mobilebert_engine(jp, jcfg, jq, js)
    # no bottleneck
    nb = TM.MobileBertConfig(**dict(TINY, use_bottleneck=False))
    p_nb, q_nb, s_nb = TC.calibrated_mobilebert(nb, seq=16, device="cpu")
    with pytest.raises(TENG.EngineIncompatible, match="use_bottleneck"):
        TM.build_mobilebert_engine(p_nb, nb, q_nb, s_nb, device="cpu")
    # training: dropout needs its generator (the training forward:
    # tests/test_torch_mobilebert_train.py)
    with pytest.raises(ValueError, match="Generator"):
        TM.mobilebert_apply(params, _request_batch(128, 2, 16), cfg, qcfg,
                            qstate, train=True, device="cpu")


def test_layer_kernel_holds_mobilebert_uncased_in_shared_memory():
    """The layer kernel's shared memory, laid out for its widest H and I
    (the weight ring, h8, li8 / x8, the attention / FFN union, the column
    tables, the keys' constants, v's and q's sums), fits a block's shared
    memory at every built seq, and its wrapper refuses wider layers."""
    at = EK._mb_layer_smem(head_dim=32, hidden=128)
    assert at == 230528 and at <= EK.SMEM_MAX
    assert EK.MB_MAX_WIDTH == 512
    for h, inter in ((512, 512), (256, 256), (1024, 512), (512, 1024)):
        why = EK.mb_layer_refusal(seq=128, head_dim=32, n_heads=4, h=h,
                                  inter=inter, attn_case="shared_kq",
                                  activation="relu", n_ffn=3,
                                  attn_bits=(8, 8, 8), w4=(False,))
        assert (why is None) == (max(h, inter) <= 512), why


def test_entry_points_need_a_card_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card refusal is not testable")
    cfg = TM.MobileBertConfig(**TINY)
    with pytest.raises(RuntimeError, match="cuda"):
        TM.init_mobilebert_params(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        TC.calibrated_mobilebert(cfg, seq=8)
    params, qcfg, qstate = TC.calibrated_mobilebert(cfg, seq=8, device="cpu")
    batch = _request_batch(cfg.vocab_size, 2, 8)
    with pytest.raises(RuntimeError, match="cuda"):
        TM.mobilebert_apply(params, batch, cfg, qcfg, qstate)
    with pytest.raises(RuntimeError, match="cuda"):
        TM.build_mobilebert_engine(params, cfg, qcfg, qstate)
    static, plan, ip = TM.build_mobilebert_engine(params, cfg, qcfg, qstate,
                                                  device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        TM.mobilebert_engine_apply(params, batch, cfg, qcfg, qstate, static,
                                   plan, ip)
