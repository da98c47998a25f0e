"""Port parity for the paper's accuracy-preserving recipes: mixed precision
(16-bit ``x``/``h``/``y`` sites) and per-embedding-group (PEG, permuted)
activation quantization, from the quant_dict language through calibration
to the engine's flex route.

The JAX package calibrates a random BERT as ``scripts/recipe_bench.py``
does (``_w8a8_defaults`` plus the recipe's quant_dict, the PEG pre-pass
for permuted sites, one calibration batch, all jitted); ``convert.py``
carries params and qstate across and the port runs on the CPU. Sizes,
for both recipes: the tiny config of tests/test_engine.py (PEG with
``ngp4``), and a wider one whose H splits into 6 groups (H=192, 4 heads, 3
layers, I=768, seq 32; PEG with ``ngp6`` and the shared-h permutation).
The simulation and the generic int path are held against JAX once per
recipe (the tiny size), the engine and the plain versions at every size.
Each setup costs a few JAX compiles, most of the file's time.

Tolerances:
- site configs, grouped / permuted ranges, permutations: exact;
- calibrated deltas / zero points: 1e-6 relative where the site's input
  is computed by the same float ops (the tiny size, and emb. / L0. sites
  of the wide one), 1e-2 deeper, as in tests/test_torch_bert_engine.py;
- engine plans: exact (the port's plan adds the ``x`` edge grid);
- plain versions at layer 0: integer stages exact; emitted payloads equal
  or one level off on at most 0.1% of elements; float value edges within
  one grid level on at most 0.1% of elements (float32 sums in JAX, float64
  or exact integer sums in the port);
- logits: the engine against the JAX engine's XLA backend within the flex
  bound of tests/test_engine.py (rtol 2e-3 / atol 3e-3); the simulation
  and the generic int path against JAX within rtol 1e-3 / atol 2e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as G
from transformer_quantization_tpu.models import bert as JB
from transformer_quantization_tpu.ops.pallas import engine_kernels as JEK
from transformer_quantization_tpu.quant import manager as JM
from transformer_quantization_tpu.quant import quantizers as JQ
from transformer_quantization_tpu.quant import ranges as JR
from transformer_quantization_tpu.quant.qconfig import Phase as JPhase
from transformer_quantization_tpu.quant.qconfig import QuantMode as JMode
from transformer_quantization_tpu.training import calibration as JCAL
from transformer_quantization_tpu_torch import convert as C
from transformer_quantization_tpu_torch.models import bert as TB
from transformer_quantization_tpu_torch.ops import engine as TENG
from transformer_quantization_tpu_torch.ops.kernels import engine_kernels as EK
from transformer_quantization_tpu_torch.quant import manager as TM
from transformer_quantization_tpu_torch.quant import ranges as TR
from transformer_quantization_tpu_torch.quant.qconfig import QuantMode
from transformer_quantization_tpu_torch.training import calibration as TC

torch.set_num_threads(2)

MIXED = {"x": 16, "h": 16, "y": 16}
SIZES = {
    "tiny": (dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
                  num_attention_heads=4, intermediate_size=128,
                  max_position_embeddings=64, num_labels=2), 16, "ngp4"),
    "wide": (dict(vocab_size=256, hidden_size=192, num_hidden_layers=3,
                  num_attention_heads=4, intermediate_size=768,
                  max_position_embeddings=64, num_labels=2), 32, "ngp6"),
}
SETUPS = ["tiny-mixed", "tiny-peg", "wide-mixed", "wide-peg"]
ENGINE_RTOL, ENGINE_ATOL = 2e-3, 3e-3
RTOL, ATOL = 1e-3, 2e-3
LEVEL_TOL, FRAC_TOL = 1, 1e-3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _recipe(name):
    size, recipe = name.split("-")
    kw, seq, peg = SIZES[size]
    if recipe == "mixed":
        return kw, seq, MIXED, False
    return kw, seq, {"x": peg, "h": peg, "y": peg}, size == "wide"


_PARAMS = {}


def _jax_params(cfg):
    """JAX's random BERT from PRNGKey(0), as __graft_entry__ makes it (once
    per size)."""
    if cfg not in _PARAMS:
        _PARAMS[cfg] = jax.jit(lambda k: JB.init_bert_params(k, cfg))(
            jax.random.PRNGKey(0))
    return _PARAMS[cfg]


def _jax_calibrated(cfg, params, qd, shared_h, seq):
    """scripts/recipe_bench.py's setup with the CLI's shared-h permutation
    groups, in one jit: weight ranges, the PEG pre-pass for permuted
    sites, one-batch calibration, int8 packing."""
    qcfg = JB.apply_bert_quant_dict(
        JB.declare_bert_sites(G._w8a8_defaults(), cfg), qd,
        cfg.num_hidden_layers)
    rng = np.random.RandomState(0)
    cal = {"input_ids": jnp.asarray(rng.randint(0, cfg.vocab_size, (2, seq)),
                                    jnp.int32),
           "attention_mask": jnp.ones((2, seq), jnp.float32),
           "token_type_ids": jnp.zeros((2, seq), jnp.int32)}
    shared = (JB.shared_permutation_groups(cfg.num_hidden_layers)
              if shared_h else None)

    def apply_fn(p, b, qcfg, qstate, mode):
        return JB.bert_apply(p, b, cfg, qcfg, qstate, mode)

    @jax.jit
    def calibrate(p, b):
        qs = JM.init_weight_qstate(qcfg, JB.bert_weight_site_tensors(p))
        if any(c.permute for _, c in qcfg.items()):
            qs = JCAL.record_permutation_ranges(apply_fn, p, qcfg, qs, [b],
                                                shared_groups=shared)
        qs = apply_fn(p, b, qcfg, qs, JMode(act_phase=JPhase.estimate))[1]
        return qs, JB.build_bert_int_params(p, qcfg, qs)

    qstate, int_params = calibrate(params, cal)
    return qcfg, qstate, int_params


@pytest.fixture(scope="module", params=SETUPS)
def setup(request):
    kw, seq, qd, shared_h = _recipe(request.param)
    jcfg, tcfg = JB.BertConfig(**kw), TB.BertConfig(**kw)
    jp = _jax_params(jcfg)
    jq, js, jint = _jax_calibrated(jcfg, jp, qd, shared_h, seq)
    jstatic, jplan, _ = JB.build_bert_engine(jp, jcfg, jq, js, int_params=jint)
    tp = C.params_from_jax(_np(jp), device="cpu")
    _, tq, ts_own = TC.calibrated_bert(tcfg, batch_size=2, seq=seq, seed=0,
                                       device="cpu", params=tp,
                                       quant_dict=qd, shared_h=shared_h)
    ts = C.qstate_from_jax(_np(js), device="cpu")
    tstatic, tplan, tint = TB.build_bert_engine(tp, tcfg, tq, ts,
                                                device="cpu")
    rng = np.random.RandomState(1)
    batch = {
        "input_ids": rng.randint(0, kw["vocab_size"], (4, seq)).astype(
            np.int32),
        "attention_mask": (np.arange(seq)[None, :]
                           < rng.randint(seq // 2, seq + 1, (4, 1))
                           ).astype(np.float32),
        "token_type_ids": np.zeros((4, seq), np.int32),
    }
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    # the simulation and the generic int path once per recipe (the tiny
    # size), the engine at every size
    routes = (["sim", "gen"] if request.param.startswith("tiny") else []
              ) + ["eng"]

    @jax.jit
    def logits(p, b, s, plan, ip):
        """JAX logits of ``routes`` (the engine on its XLA backend)."""
        out = {"sim": lambda: JB.bert_apply(p, b, jcfg, jq, s, JMode()),
               "gen": lambda: JB.bert_apply(p, b, jcfg, jq, s, JMode(),
                                            int_params=ip),
               "eng": lambda: (JB.bert_engine_apply(
                   p, b, jcfg, jq, s, jstatic, plan, ip, backend="xla"),)}
        return {r: out[r]()[0]["logits"] for r in routes}

    want = jax.tree.map(np.asarray, logits(jp, jbatch, js, jplan, jint))
    return dict(name=request.param, seq=seq, jcfg=jcfg, tcfg=tcfg, jp=jp,
                jq=jq, js=js, jint=jint, jstatic=jstatic, jplan=jplan, tp=tp,
                tq=tq, ts=ts, ts_own=ts_own, tstatic=tstatic, tplan=tplan,
                tint=tint, batch=batch, jbatch=jbatch, want=want)


# ---------------------------------------------------------------------------
# quant_dict language and PEG ranges
# ---------------------------------------------------------------------------

_FIELDS = ("enabled", "axis", "n_groups", "permute")


@pytest.mark.parametrize("qd", [
    MIXED, {"x": "ngp6", "h": "ngp6", "y": "ngp6"},
    {"x": "ng4", "h": 16, "y": "per_embd"}, {"s3": 16}, {"L": 16},
    {"h": "fp32"}, {"x0": "ngp4", "x": 16, "L1": 4},
], ids=["mixed", "peg", "combo", "s3", "L", "h-fp32", "order"])
def test_quant_dict_sites_match_jax(qd):
    kw = dict(SIZES["tiny"][0], num_hidden_layers=4)
    jq = JB.apply_bert_quant_dict(
        JB.declare_bert_sites(G._w8a8_defaults(), JB.BertConfig(**kw)), qd, 4)
    tq = TB.apply_bert_quant_dict(
        TB.declare_bert_sites(TC.w8a8_defaults(), TB.BertConfig(**kw)), qd, 4)
    assert jq.names() == tq.names()
    for name, jc in jq.items():
        tc = tq[name]
        assert jc.spec.n_bits == tc.spec.n_bits, name
        for f in _FIELDS:
            assert getattr(jc, f) == getattr(tc, f), (name, f)


def test_quant_dict_rejects_unknown_keys():
    cfg = TB.BertConfig(**SIZES["tiny"][0])
    tq = TB.declare_bert_sites(TC.w8a8_defaults(), cfg)
    with pytest.raises(KeyError, match="unknown quant_dict keys"):
        TB.apply_bert_quant_dict(tq, {"q": 16}, cfg.num_hidden_layers)
    with pytest.raises(NotImplementedError, match="Unknown value"):
        TB.apply_bert_quant_dict(tq, {"x": "int4"}, cfg.num_hidden_layers)


def test_grouped_ranges_match_jax():
    rng = np.random.RandomState(3)
    x = (rng.randn(2, 5, 24) * rng.rand(24) * 4).astype(np.float32)
    perm = rng.permutation(24).astype(np.int32)
    for groups, p in ((4, None), (6, perm), (3, perm)):
        rs = (JR.ReduceSpec(axis=2, n_groups=groups, permute=p is not None),
              TR.ReduceSpec(axis=2, n_groups=groups, permute=p is not None))
        want = JR.reduce_min_max(jnp.asarray(x), rs[0],
                                 perm=None if p is None else jnp.asarray(p))
        got = TR.reduce_min_max(_t(x), rs[1], perm=None if p is None
                                else _t(p))
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(
        TR.channel_dynamic_ranges(_t(x), 2).numpy(),
        np.asarray(JR.channel_dynamic_ranges(jnp.asarray(x), 2)))


def test_permutations_and_shared_ranges_match_jax():
    """Stable argsort on tied ranges, and the shared-h copy."""
    cfg_kw = SIZES["tiny"][0]
    qd = {"x": "ngp4", "h": "ngp4", "y": "ngp4"}
    jq = JB.apply_bert_quant_dict(JB.declare_bert_sites(
        G._w8a8_defaults(), JB.BertConfig(**cfg_kw)), qd, 2)
    tq = TB.apply_bert_quant_dict(TB.declare_bert_sites(
        TC.w8a8_defaults(), TB.BertConfig(**cfg_kw)), qd, 2)
    rng = np.random.RandomState(5)
    ranges = {}
    for name, c in jq.items():
        if c.permute:
            r = rng.randint(0, 4, 64).astype(np.float32)  # many ties
            ranges[name] = r
    js = {n: {"ranges": jnp.asarray(r), "perm": jnp.arange(64)}
          for n, r in ranges.items()}
    ts = {n: {"ranges": _t(r), "perm": torch.arange(64)}
          for n, r in ranges.items()}
    for src, tgts in JB.shared_permutation_groups(2)[:1]:
        js = JM.share_ranges(js, src, tgts)
    for src, tgts in TB.shared_permutation_groups(2)[:1]:
        ts = TM.share_ranges(ts, src, tgts)
    js, ts = JM.finalize_permutations(jq, js), TM.finalize_permutations(tq, ts)
    assert set(js) == set(ts)
    for n in js:
        np.testing.assert_array_equal(ts[n]["perm"].numpy(),
                                      np.asarray(js[n]["perm"]), err_msg=n)
        np.testing.assert_array_equal(ts[n]["ranges"].numpy(),
                                      np.asarray(js[n]["ranges"]), err_msg=n)
    assert TB.shared_permutation_groups(3) == JB.shared_permutation_groups(3)


# ---------------------------------------------------------------------------
# Calibration and the engine plan
# ---------------------------------------------------------------------------


def test_recipe_calibration_matches_jax(setup):
    js = _np(setup["js"])
    assert set(js) == set(setup["ts_own"])
    for name, st in js.items():
        tst = setup["ts_own"][name]
        assert set(k for k in st if st[k] is not None) <= set(tst), name
        if "perm" in st:
            np.testing.assert_array_equal(tst["perm"].numpy(), st["perm"],
                                          err_msg=name)
        strict = (setup["name"].startswith("tiny")
                  or name.startswith(("emb.", "L0.")))
        tol = 1e-6 if strict else 1e-2
        d_j, d_t = np.asarray(st["qp"].delta), tst["qp"].delta.numpy()
        assert np.all(np.abs(d_j - d_t) <= tol * np.abs(d_j)), name
        z_j, z_t = np.asarray(st["qp"].zero_float), tst["qp"].zero_float.numpy()
        assert np.all(np.abs(z_j - z_t)
                      <= tol * np.maximum(1.0, np.abs(z_j))), name


def test_flex_plan_matches_jax(setup):
    tst, jst = setup["tstatic"], setup["jstatic"]
    for f in ("n_layers", "n_heads", "ln_eps", "hidden_act", "fold",
              "res_quant", "attn_skip_max", "attn_bits", "w4", "flex", "io",
              "any_flex"):
        assert getattr(tst, f) == getattr(jst, f), f
    assert tst.any_flex
    flat_j = jax.tree_util.tree_leaves_with_path(_np(setup["jplan"]))
    flat_t = {k: v for k, v in jax.tree_util.tree_leaves_with_path(
        setup["tplan"]) if "grid" not in jax.tree_util.keystr(k)}
    assert len(flat_j) == len(flat_t)
    for path, v in flat_j:
        np.testing.assert_array_equal(flat_t[path].numpy(), v,
                                      err_msg=str(path))


# ---------------------------------------------------------------------------
# Plain versions at layer 0 against the JAX oracles
# ---------------------------------------------------------------------------


def _payload_close(want, got, exact=False):
    want = np.asarray(want).astype(np.int32)
    got = got.numpy().astype(np.int32)
    assert want.shape == got.shape
    diff = np.abs(want - got)
    if exact:
        np.testing.assert_array_equal(got, want)
    assert diff.max() <= LEVEL_TOL, diff.max()
    assert (diff > 0).mean() <= FRAC_TOL, (diff > 0).mean()


def _value_edge_close(want, got, step):
    """Float value edges: within one grid level (``step``, per column or
    per tensor; plus the values' own float32 rounding) on at most 0.1% of
    elements, equal elsewhere."""
    want, got = np.asarray(want), got.numpy()
    diff = np.abs(want - got)
    bound = np.asarray(step) + np.abs(want) * 2.0 ** -22
    assert np.all(diff <= bound), diff.max()
    assert (diff > 0).mean() <= FRAC_TOL, (diff > 0).mean()


def _aargs(p, x, b):
    return (x, p["qkv"]["w"], p["qkv"]["vecs"], p["qkv"]["scal"], b,
            p["attn_scal"], p["attn_out"]["w"], p["attn_out"]["vecs"],
            p["attn_out"]["scal"], p["ln1"]["gb"], p["ln1"]["scal"],
            p["ln1"].get("lnv"))


def _fargs(p, x):
    return (x, p["inter"]["w"], p["inter"]["vecs"], p["inter"]["scal"],
            p["dense"]["w"], p["dense"]["vecs"], p["dense"]["scal"], x,
            p["ln2"]["gb"], p["ln2"]["scal"], p["ln2"].get("lnv"))


def _layer0_kw(setup):
    jst = setup["jstatic"]
    x_mode, x_bits, h_bits, y_bits, _, _ = jst.flex[0]
    assert x_mode == "f"
    akw = dict(n_heads=setup["jcfg"].num_attention_heads, seq=setup["seq"],
               eps=jst.ln_eps, res_quant=jst.res_quant[0][0],
               skip_max=jst.attn_skip_max, ln_out="f", ln_bits=x_bits,
               g_bits=jst.io[0][5], u_bits=jst.io[0][6])
    fkw = dict(activation="gelu_new", eps=jst.ln_eps,
               res_quant=jst.res_quant[0][1], in_mode="f", res_mode="f",
               h_bits=h_bits, y_bits=y_bits)
    return akw, fkw


def _jax_layer0(setup, akw, fkw):
    """Layer 0 on the request batch through the JAX oracles (one jit):
    the entry payload, mask bias, x value edge, inter payload, its
    pre-activation product, the dense fold and the FFN block's payload."""
    cfg, q = setup["jcfg"], setup["jq"]
    h_bits = fkw["h_bits"]

    @jax.jit
    def run(p, s, ip, plan, batch):
        ctx = JB.make_ctx(q, s, JMode(), int_params=ip)
        ids, tt, pos, _ = JB.prepare_inputs(batch)
        h = JB._embeddings(ctx, p, cfg, ids, tt, pos, False, None)
        es, lp = plan["entry_scal"], plan["layers"][0]
        x8 = JEK.quantize_payload(h.reshape(-1, cfg.hidden_size), es[0, 0],
                                  es[0, 1])
        bias = (1.0 - batch["attention_mask"]) * -10000.0
        jx = JEK.int8_attn_ln_ref(*_aargs(lp, x8, bias),
                                  out_dtype=jnp.float32, **akw)
        inter = (lp["inter"]["w"], lp["inter"]["vecs"], lp["inter"]["scal"])
        ji = JEK.int8_matmul_ref(jx, *inter, activation="gelu_new",
                                 in_mode="f")
        jf = JEK.int8_matmul_ref(jx, *inter, out_mode="float", in_mode="f")
        jd = JEK.int8_matmul_ref(ji, lp["dense"]["w"], lp["dense"]["vecs"],
                                 lp["dense"]["scal"], out_mode="fold",
                                 out_bits=h_bits)
        jz = JEK.int8_ffn_ln_ref(*_fargs(lp, jx), **fkw)
        return x8, bias, jx, ji, jf, jd, jz

    return map(np.asarray, run(setup["jp"], setup["js"], setup["jint"],
                               setup["jplan"], setup["jbatch"]))


def test_flex_plain_versions_match_jax_at_layer0(setup):
    tlp = setup["tplan"]["layers"][0]
    akw, fkw = _layer0_kw(setup)
    x8, bias, jx, ji, jf, jd, jz = _jax_layer0(setup, akw, fkw)

    # attention block -> the float x value edge
    tx = EK.int8_attn_ln_ref(*_aargs(tlp, _t(x8), _t(bias)), **akw)
    x_step = (tlp["ln1"]["lnv"][2] if "lnv" in tlp["ln1"]
              else tlp["ln1"]["scal"][0, 6]).numpy()
    _value_edge_close(jx, tx, x_step)
    # the chain wrappers run the plain versions on CPU tensors
    EK.reset_launches()
    np.testing.assert_array_equal(
        EK.int8_attn_ln(*_aargs(tlp, _t(x8), _t(bias)), **akw).numpy(),
        tx.numpy())

    # the grid levels reproduce the edge exactly (integer stage)
    grid = tlp["inter"]["grid"]
    xin = _t(jx)
    lv = EK.edge_levels(xin, grid)
    size = xin.shape[1] // grid["s"].numel()
    back = (torch.repeat_interleave(grid["s"], size)
            * (lv - torch.repeat_interleave(grid["zp"], size)))
    np.testing.assert_array_equal(back.numpy(),
                                  xin[:, grid["cols"]].numpy())

    # float-edge inter matmul (gelu_new, emit) against JAX's f32 dot, and
    # its pre-activation product within float32 rounding
    inter = (tlp["inter"]["w"], tlp["inter"]["vecs"], tlp["inter"]["scal"])
    ti = EK.int8_matmul_ref(xin, *inter, activation="gelu_new", in_mode="f",
                            in_grid=grid)
    _payload_close(ji, ti)
    tf = EK.float_edge_matmul_ref(xin, tlp["inter"]["vecs"], grid,
                                  out_mode="float")
    np.testing.assert_allclose(tf.numpy(), jf, rtol=1e-5,
                               atol=1e-5 * float(np.abs(jf).max()))

    # dense matmul, fold on the h grid: integer inputs, exact
    td = EK.int8_matmul_ref(_t(ji), tlp["dense"]["w"], tlp["dense"]["vecs"],
                            tlp["dense"]["scal"], out_mode="fold",
                            out_bits=fkw["h_bits"])
    np.testing.assert_array_equal(td.numpy(), jd)

    # the flex FFN block -> the next layer's payload; its add+LN alone on
    # JAX's own dense fold value
    tz = EK.int8_ffn_ln_ref(*_fargs(tlp, xin), x_grid=grid, **fkw)
    _payload_close(jz, tz)
    np.testing.assert_array_equal(
        EK.int8_ffn_ln(*_fargs(tlp, xin), x_grid=grid, **fkw).numpy(),
        tz.numpy())
    assert set(EK.LAUNCHES.values()) == {0}  # CPU tensors: plain versions
    tl = EK.flex_add_ln_ref(_t(jd), xin, tlp["ln2"]["gb"], tlp["ln2"]["scal"],
                            tlp["ln2"].get("lnv"), eps=fkw["eps"],
                            res_quant=fkw["res_quant"], res_mode="f",
                            res_bits=fkw["y_bits"])
    _payload_close(jz, tl)


# ---------------------------------------------------------------------------
# End to end
# ---------------------------------------------------------------------------


def test_recipe_engine_matches_jax_engine(setup):
    want = setup["want"]["eng"]
    args = (setup["tp"], setup["batch"], setup["tcfg"], setup["tq"],
            setup["ts"], setup["tstatic"], setup["tplan"], setup["tint"])
    got = TB.bert_engine_apply(*args, device="cpu")["logits"].numpy()
    np.testing.assert_allclose(got, want, rtol=ENGINE_RTOL, atol=ENGINE_ATOL)
    plain = TB.bert_engine_apply(*args, backend="plain",
                                 device="cpu")["logits"].numpy()
    np.testing.assert_array_equal(plain, got)


@pytest.mark.parametrize("setup", ["tiny-mixed", "tiny-peg"], indirect=True)
def test_recipe_simulation_and_generic_int_match_jax(setup):
    got, _ = TB.bert_apply(setup["tp"], setup["batch"], setup["tcfg"],
                           setup["tq"], setup["ts"], QuantMode(), device="cpu")
    np.testing.assert_allclose(got["logits"].numpy(), setup["want"]["sim"],
                               rtol=RTOL, atol=ATOL)
    got, _ = TB.bert_apply(setup["tp"], setup["batch"], setup["tcfg"],
                           setup["tq"], setup["ts"], QuantMode(),
                           int_params=setup["tint"], device="cpu")
    np.testing.assert_allclose(got["logits"].numpy(), setup["want"]["gen"],
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("qd", [{"h": "ngp6"}, {"g": "ng6"}],
                         ids=["h-peg", "g-groups"])
def test_per_column_fold_site_takes_the_flex_route(qd):
    """An 8-bit per-column fold site alone leaves JAX's flex / io
    descriptors at their defaults, but the all-int8 chain's add+LN reads a
    per-tensor fold site: the port's layers must take the flex chains, and
    its engine must still match the JAX engine. At the wide size, where
    the all-int8 chain's error on these sites exceeds the flex bound."""
    kw, seq, _ = SIZES["wide"]
    jcfg, tcfg = JB.BertConfig(**kw), TB.BertConfig(**kw)
    jp = _jax_params(jcfg)
    jq, js, jint = _jax_calibrated(jcfg, jp, qd, False, seq)
    jstatic, jplan, _ = JB.build_bert_engine(jp, jcfg, jq, js, int_params=jint)
    tp = C.params_from_jax(_np(jp), device="cpu")
    tq = TB.apply_bert_quant_dict(
        TB.declare_bert_sites(TC.w8a8_defaults(), tcfg), qd,
        tcfg.num_hidden_layers)
    ts = C.qstate_from_jax(_np(js), device="cpu")
    st, plan, ip = TB.build_bert_engine(tp, tcfg, tq, ts, device="cpu")
    assert not st.any_flex and not any(st.int8_layer)
    batch = TC.calibration_batch(tcfg.vocab_size, 4, seq, seed=4)
    want = jax.jit(lambda p, b, s, plan, ip: JB.bert_engine_apply(
        p, b, jcfg, jq, s, jstatic, plan, ip, backend="xla")["logits"])(
        jp, {k: jnp.asarray(v) for k, v in batch.items()}, js, jplan, jint)
    got = TB.bert_engine_apply(tp, batch, tcfg, tq, ts, st, plan, ip,
                               device="cpu")["logits"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=ENGINE_RTOL, atol=ENGINE_ATOL)


def test_engine_rejects_still_unported_recipes():
    """The keys whose engine routes the port lacked until the float edges
    were ported -- a float layer input ('L' / 'z'), 16-bit q/k/v, a 16-bit
    inter.out, a 16-bit context site -- now plan as the JAX package plans
    them, and their logits are the JAX engine's on the same params and
    ranges; the refusals JAX makes too still raise: q/k/v sites of
    different widths, a disabled q.out, a site wider than 16 bits."""
    kw, seq, _ = SIZES["tiny"]
    cfg, jcfg = TB.BertConfig(**kw), JB.BertConfig(**kw)
    params = TB.init_bert_params(cfg, device="cpu")
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params)
    batch = TC.calibration_batch(cfg.vocab_size, 4, seq, seed=4)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for qd in ({"L": 16}, {"z": 16}, {"L0": 16}, {"c": 16}):
        _, qcfg, qstate = TC.calibrated_bert(cfg, seq=seq, device="cpu",
                                             params=params, quant_dict=qd)
        static, plan, ip = TB.build_bert_engine(params, cfg, qcfg, qstate,
                                                device="cpu")
        jq = JB.apply_bert_quant_dict(
            JB.declare_bert_sites(G._w8a8_defaults(), jcfg), qd,
            jcfg.num_hidden_layers)
        js = {n: {"qp": JQ.QuantParams(
            *(jnp.asarray(getattr(v["qp"], f).numpy())
              for f in ("delta", "zero_float", "signed")))}
            for n, v in qstate.items() if "qp" in v}
        jint = JB.build_bert_int_params(jp, jq, js)
        jst, jplan, _ = JB.build_bert_engine(jp, jcfg, jq, js,
                                             int_params=jint)
        assert (static.io, static.attn_bits) == (jst.io, jst.attn_bits), qd
        want = jax.jit(lambda p, b, s, plan, ip: JB.bert_engine_apply(
            p, b, jcfg, jq, s, jst, plan, ip, backend="xla")["logits"])(
            jp, jb, js, jplan, jint)
        got = TB.bert_engine_apply(params, batch, cfg, qcfg, qstate, static,
                                   plan, ip, device="cpu")["logits"]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL, err_msg=str(qd))
    q16 = qcfg.replace_site("L0.attn.q.out", spec=dataclasses.replace(
        qcfg["L0.attn.q.out"].spec, n_bits=16))
    with pytest.raises(TENG.EngineIncompatible, match="share one grid width"):
        TB.build_bert_engine(params, cfg, q16, qstate, device="cpu")
    with pytest.raises(TENG.EngineIncompatible, match="disabled"):
        TB.build_bert_engine(params, cfg,
                             qcfg.replace_site("L0.attn.q.out",
                                               enabled=False), qstate,
                             device="cpu")
    c32 = qcfg.replace_site("L0.attn.context", spec=dataclasses.replace(
        qcfg["L0.attn.context"].spec, n_bits=32))
    with pytest.raises(TENG.EngineIncompatible, match="32-bit"):
        TB.build_bert_engine(params, cfg, c32, qstate, device="cpu")
