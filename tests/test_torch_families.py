"""Port parity for RoBERTa, DistilBERT, ALBERT and SqueezeBERT on the CPU.

For each family at its registry's tiny preset (2 layers), the JAX package
initialises a model (``build_model(tiny=True)``) and calibrates it (W8A8
current-minmax, one batch, ``prepare_quantized_model``, eager);
``convert.py`` carries its params and qstate across and the port runs the
same routes on the same seeded numpy batches (rows padded; RoBERTa's pads
carry its pad id). The JAX engine runs on its XLA backend.

Tolerances:
- FP32 logits: rtol 1e-5 / atol 1e-5;
- the port's own calibration against JAX's: deltas and zero points to
  float32 rounding (1e-6 relative), signedness equal;
- packed int weights (SqueezeBERT's densified engine weights too) and
  the engine plan: equal bit for bit;
- fake-quant, generic int path and engine logits against the same JAX
  route: rtol 1e-3 / atol 2e-3 (the engine-vs-generic bound of
  tests/test_engine.py).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_quantization_tpu.models import albert as JA
from transformer_quantization_tpu.models import bert as JB
from transformer_quantization_tpu.models import registry as JR
from transformer_quantization_tpu.models import squeezebert as JS
from transformer_quantization_tpu.ops.layers import (
    quant_grouped_linear as j_grouped,
)
from transformer_quantization_tpu.quant.qconfig import QuantMode as JMode
from transformer_quantization_tpu.quant.qconfig import (
    QuantModelConfig as JQMC,
)
from transformer_quantization_tpu.training.calibration import (
    prepare_quantized_model as jax_prepare,
)
from transformer_quantization_tpu_torch import convert as C
from transformer_quantization_tpu_torch.models import albert as TA
from transformer_quantization_tpu_torch.models import bert as TB
from transformer_quantization_tpu_torch.models import registry as TR
from transformer_quantization_tpu_torch.models import squeezebert as TS
from transformer_quantization_tpu_torch.ops import int_linear as TIL
from transformer_quantization_tpu_torch.ops.kernels import engine_kernels as EK
from transformer_quantization_tpu_torch.ops.layers import (
    quant_grouped_linear as t_grouped,
)
from transformer_quantization_tpu_torch.quant import quantizers as TQ
from transformer_quantization_tpu_torch.quant.manager import (
    init_weight_qstate,
)
from transformer_quantization_tpu_torch.quant.qconfig import (
    Phase,
    QuantConfigBuilder,
    QuantMode,
)
from transformer_quantization_tpu_torch.quant.qconfig import (
    QuantModelConfig as TQMC,
)
from transformer_quantization_tpu_torch.training import calibration as TC
from transformer_quantization_tpu_torch.training import qat as TQAT

torch.set_num_threads(2)

MODELS = ["roberta_base", "distilbert_base_uncased", "albert_base_v2",
          "squeezebert_uncased"]
SEQ, N = 16, 4
RTOL, ATOL = 1e-3, 2e-3
FP_TOL = 1e-5
# the JAX routes compile at XLA's backend optimization level 0 (the
# source's arithmetic, as tests/test_torch_qat.py holds QAT; a quarter of
# the compile time)
O0 = {"xla_backend_optimization_level": 0}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _request_batch(vocab, pad_id, seed=1):
    """Seeded ids with rows padded from a random length on; padded ids set
    to the family's pad id (RoBERTa numbers positions from it)."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(3, vocab, (N, SEQ)).astype(np.int32)
    mask = (np.arange(SEQ)[None, :]
            < rng.randint(SEQ // 2, SEQ + 1, (N, 1))).astype(np.float32)
    ids = np.where(mask > 0, ids, pad_id).astype(np.int32)
    return {"input_ids": ids, "attention_mask": mask,
            "token_type_ids": np.zeros((N, SEQ), np.int32)}


@functools.lru_cache(maxsize=None)
def _build(name):
    jfam, jcfg, jp = JR.build_model(name, tiny=True, seed=0)
    tfam = TR.get_family(name)
    tcfg = tfam.config_cls(**dataclasses.asdict(jcfg))
    tp = C.params_from_jax(_np(jp), device="cpu")
    cal = TC.calibration_batch(jcfg.vocab_size, 2, SEQ, 0)
    jq = jfam.declare_sites(_jax_defaults(), jcfg)
    js = _jax_calibrate(jfam, jcfg, jq, jp, cal)
    tq = tfam.declare_sites(TC.w8a8_defaults(), tcfg)

    def apply_fn(p, b, **kw):
        return tfam.apply(p, b, tcfg, **kw)

    ts_own, _ = TC.prepare_quantized_model(
        apply_fn, tp, tq, [cal], weight_tensors=tfam.weight_site_tensors(tp),
        device="cpu")
    ts = C.qstate_from_jax(_np(js), device="cpu")
    jint = jfam.build_int_params(jp, jq, js, False)
    jst, jplan, jint_e = jfam.build_engine(jp, jcfg, jq, js)
    batch = _request_batch(jcfg.vocab_size, getattr(jcfg, "pad_token_id", 0))

    @functools.partial(jax.jit, compiler_options=O0)
    def routes(p, b, st, ip, plan, ip_e):
        """The JAX routes' logits in one program: FP32, fake-quant, the
        generic int path and the engine on its XLA backend."""
        return {
            "fp": jfam.apply(p, b, jcfg)[0]["logits"],
            "fq": jfam.apply(p, b, jcfg, jq, st, JMode())[0]["logits"],
            "int": jfam.apply(p, b, jcfg, jq, st, JMode(),
                              int_params=ip)[0]["logits"],
            "engine": jfam.engine_apply(p, b, jcfg, jq, st, jst, plan, ip_e,
                                        backend="xla")["logits"]}

    want = _np(routes(jp, _jbatch(batch), js, jint, jplan, jint_e))
    return dict(name=name, jfam=jfam, tfam=tfam, jcfg=jcfg, tcfg=tcfg, jp=jp,
                tp=tp, jq=jq, tq=tq, js=js, ts=ts, ts_own=ts_own, jint=jint,
                jst=jst, jplan=jplan, batch=batch, want=want)


def _jax_calibrate(jfam, jcfg, jq, jp, batch):
    """JAX's one-batch calibration (``prepare_quantized_model``), eager:
    jitted, XLA's fusions move DistilBERT's ``L0.attn.context`` range past
    float32 rounding."""
    return jax_prepare(functools.partial(jfam.apply, cfg=jcfg), jp, jq,
                       [_jbatch(batch)],
                       weight_tensors=jfam.weight_site_tensors(jp))[0]


def _jax_defaults():
    from transformer_quantization_tpu.quant.qconfig import QuantDefaults
    from transformer_quantization_tpu.quant.quantizers import QMethod
    from transformer_quantization_tpu.quant.ranges import RangeMethod

    return QuantDefaults(method=QMethod.symmetric_uniform,
                         act_method=QMethod.asymmetric_uniform, n_bits=8,
                         weight_range_method=RangeMethod.current_minmax,
                         act_range_method=RangeMethod.current_minmax)


@pytest.fixture(scope="module", params=MODELS)
def setup(request):
    return _build(request.param)


def _port_apply(s, **kw):
    return s["tfam"].apply(s["tp"], s["batch"], s["tcfg"], device="cpu",
                           **kw)[0]["logits"]


def _close(want, got):
    assert got.shape == want.shape and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# Per family: FP32, calibration, packing, the three routes, the plan
# ---------------------------------------------------------------------------


def test_fp32_logits_match_jax(setup):
    want = setup["want"]["fp"]
    got = _port_apply(setup)
    np.testing.assert_allclose(got.numpy(), want, rtol=FP_TOL, atol=FP_TOL)


def test_convert_carries_the_trees(setup):
    """params (ALBERT's ``shared`` subtree and ``emb_proj``, SqueezeBERT's
    ``(out, in/groups)`` kernels), qstate and int_params (SqueezeBERT's
    densified engine weights too) convert leaf for leaf."""
    s = setup
    flat_j = jax.tree_util.tree_leaves_with_path(_np(s["jp"]))
    flat_t = dict(jax.tree_util.tree_leaves_with_path(s["tp"]))
    assert len(flat_j) == len(flat_t)
    for path, v in flat_j:
        np.testing.assert_array_equal(flat_t[path].numpy(), v,
                                      err_msg=str(path))
    js = _np(s["js"])
    assert set(js) == set(s["ts"])
    for name, st in js.items():
        np.testing.assert_array_equal(s["ts"][name]["qp"].delta.numpy(),
                                      np.asarray(st["qp"].delta))
    jints = [s["jint"]]
    if s["name"] == "squeezebert_uncased":
        jd, jqs = JS._densify_for_engine(s["jp"], s["jcfg"], s["js"])
        jints.append(JB.build_bert_int_params(jd, s["jq"], jqs))
    for jint in jints:
        jint = _np(jint)
        _packed_equal(C.int_params_from_jax(jint, device="cpu"), jint)


def test_calibration_matches_jax(setup):
    js = _np(setup["js"])
    assert set(js) == set(setup["ts_own"])
    for name, st in js.items():
        qp = setup["ts_own"][name]["qp"]
        d_j, d_t = np.asarray(st["qp"].delta), qp.delta.numpy()
        assert np.all(np.abs(d_j - d_t) <= 1e-6 * np.abs(d_j)), name
        z_j, z_t = np.asarray(st["qp"].zero_float), qp.zero_float.numpy()
        assert np.all(np.abs(z_j - z_t)
                      <= 1e-6 * np.maximum(1.0, np.abs(z_j))), name
        np.testing.assert_array_equal(np.asarray(st["qp"].signed),
                                      qp.signed.numpy())


def _packed_equal(tint, jint):
    assert set(tint) == set(jint)
    for name, p in jint.items():
        assert set(tint[name]) == set(p), name
        for k, v in p.items():
            if k == "n_bits":
                assert tint[name][k] == v
            else:
                np.testing.assert_array_equal(tint[name][k].numpy(),
                                              np.asarray(v), err_msg=name)


def test_int_params_pack_exactly(setup):
    s = setup
    tint = s["tfam"].build_int_params(s["tp"], s["tq"], s["ts"])
    _packed_equal(tint, _np(s["jint"]))
    if s["name"] == "squeezebert_uncased":
        # the engine's densified block-diagonal weights
        jd, jqs = JS._densify_for_engine(s["jp"], s["jcfg"], s["js"])
        td, tqs = TS._densify_for_engine(s["tp"], s["tcfg"], s["ts"])
        _packed_equal(TB.build_bert_int_params(td, s["tq"], tqs),
                      _np(JB.build_bert_int_params(jd, s["jq"], jqs)))
        assert s["tcfg"].q_groups > 1
        w = tint["L0.attn.q"]["w_int"]
        assert w.shape[1] == s["tcfg"].hidden_size // s["tcfg"].q_groups


def test_fake_quant_logits_match_jax(setup):
    want = setup["want"]["fq"]
    _close(want, _port_apply(setup, qcfg=setup["tq"], qstate=setup["ts"],
                             mode=QuantMode()))


def test_int_path_logits_match_jax(setup):
    s = setup
    want = s["want"]["int"]
    tint = C.int_params_from_jax(_np(s["jint"]), device="cpu")
    got = _port_apply(s, qcfg=s["tq"], qstate=s["ts"], mode=QuantMode(),
                      int_params=tint)
    _close(want, got)
    # the fused linear's plain version on the same route
    fused = _port_apply(s, qcfg=s["tq"], qstate=s["ts"], mode=QuantMode(),
                        int_params=tint, fused_linear="plain")
    _close(want, fused)


def test_engine_matches_jax_engine(setup):
    s = setup
    want = s["want"]["engine"]
    tst, tplan, tint = s["tfam"].build_engine(s["tp"], s["tcfg"], s["tq"],
                                              s["ts"], device="cpu")
    EK.reset_launches()
    got = s["tfam"].engine_apply(s["tp"], s["batch"], s["tcfg"], s["tq"],
                                 s["ts"], tst, tplan, tint,
                                 device="cpu")["logits"]
    assert set(EK.LAUNCHES.values()) == {0}  # CPU tensors: plain versions
    _close(want, got)
    plain = s["tfam"].engine_apply(s["tp"], s["batch"], s["tcfg"], s["tq"],
                                   s["ts"], tst, tplan, tint,
                                   backend="plain", device="cpu")["logits"]
    np.testing.assert_array_equal(plain.numpy(), got.numpy())


def test_engine_plan_matches_jax(setup):
    s = setup
    tst, tplan, _ = s["tfam"].build_engine(s["tp"], s["tcfg"], s["tq"],
                                           s["ts"], device="cpu")
    jst = s["jst"]
    for f in ("n_layers", "n_heads", "ln_eps", "hidden_act", "fold",
              "res_quant", "attn_skip_max", "attn_bits", "w4", "flex", "io",
              "any_flex"):
        assert getattr(tst, f) == getattr(jst, f), f
    assert all(tst.int8_layer)
    flat_j = jax.tree_util.tree_leaves_with_path(_np(s["jplan"]))
    flat_t = dict(jax.tree_util.tree_leaves_with_path(tplan))
    assert len(flat_j) == len(flat_t)
    for path, v in flat_j:
        np.testing.assert_array_equal(flat_t[path].numpy(), v,
                                      err_msg=str(path))


def test_training_forward_and_card_refusals(setup):
    """The training forward (the preset's dropouts from a generator, the
    fake-quant sites' STE) returns a loss whose gradient reaches every
    layer; it refuses the engine-only ``int_params`` as BERT's does; the
    entry points without ``device`` refuse the CPU."""
    s = setup
    leaves = [t.detach().clone().requires_grad_(True)
              for _, t in TQAT.tree_leaves(s["tp"])]
    live = TQAT.tree_unflatten(s["tp"], leaves)
    batch = dict(s["batch"], labels=np.arange(N) % 2)
    out, _ = s["tfam"].apply(live, batch, s["tcfg"], s["tq"], s["ts"],
                             QuantMode(), train=True,
                             dropout_generator=torch.Generator().manual_seed(
                                 0), device="cpu")
    assert out["loss"].requires_grad and torch.isfinite(out["loss"])
    grads = torch.autograd.grad(out["loss"], leaves, allow_unused=True)
    grads = {path: g for (path, _), g in zip(TQAT.tree_leaves(s["tp"]),
                                               grads)}
    assert all(g is not None and torch.isfinite(g).all()
               for g in grads.values())
    first = ("shared",) if "shared" in s["tp"] else ("layers", "0")
    for part in (("embeddings", "word"), first + ("ffn", "inter"),
                 first + ("attn", "v")):
        assert any(g.abs().max() > 0 for path, g in grads.items()
                   if path[:len(part)] == part), part
    with pytest.raises(ValueError, match="inference path"):
        s["tfam"].apply(s["tp"], batch, s["tcfg"], s["tq"], s["ts"],
                        QuantMode(), train=True,
                        int_params=s["tfam"].build_int_params(
                            s["tp"], s["tq"], s["ts"], False), device="cpu")
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="cuda"):
        s["tfam"].init_params(s["tcfg"], 0)
    with pytest.raises(RuntimeError, match="cuda"):
        s["tfam"].apply(s["tp"], s["batch"], s["tcfg"])
    with pytest.raises(RuntimeError, match="cuda"):
        s["tfam"].build_engine(s["tp"], s["tcfg"], s["tq"], s["ts"])
    st, plan, ip = s["tfam"].build_engine(s["tp"], s["tcfg"], s["tq"],
                                          s["ts"], device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        s["tfam"].engine_apply(s["tp"], s["batch"], s["tcfg"], s["tq"],
                               s["ts"], st, plan, ip)


# ---------------------------------------------------------------------------
# ALBERT: the shared layer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def albert():
    return _build("albert_base_v2")


def test_albert_plan_holds_one_weight_set(albert):
    s = albert
    _, plan, tint = s["tfam"].build_engine(s["tp"], s["tcfg"], s["tq"],
                                           s["ts"], device="cpu")
    layers = plan["layers"]
    assert len(layers) == s["tcfg"].num_hidden_layers == 2
    for mm in ("qkv", "attn_out", "inter", "dense"):
        assert len({lp[mm]["w"].data_ptr() for lp in layers}) == 1, mm
    # the single matmuls are the packed weights themselves
    assert layers[0]["inter"]["w"] is tint["shared.ffn.inter"]["w_int"]
    # layer 0 reads emb_proj.out, layer 1 the shared ffn.ln.out
    assert not torch.equal(layers[0]["qkv"]["scal"], layers[1]["qkv"]["scal"])


@pytest.mark.parametrize("qd", [{"y1": 16, "C": "fp32"}, {"x0": 16, "x": 8},
                                {"L1": 16}, {"h": "ngp4", "Et": 8},
                                {"s0": 16, "P": "fp32", "wC": 4}])
def test_albert_quant_dict_collapses_like_jax(qd):
    tiny = TR.get_family("albert").tiny_preset
    jq = JA.declare_albert_sites(_jax_defaults(), JA.AlbertConfig(**tiny),
                                 quant_dict=qd)
    tq = TA.declare_albert_sites(TC.w8a8_defaults(), TA.AlbertConfig(**tiny),
                                 quant_dict=qd)
    jq, tq = (JA.apply_albert_quant_dict(jq, qd, 2),
              TA.apply_albert_quant_dict(tq, qd, 2))
    assert [n for n, _ in tq.items()] == [n for n, _ in jq.items()]
    for (n, t), (_, j) in zip(tq.items(), jq.items()):
        assert (t.enabled, t.spec.n_bits, t.axis, t.n_groups, t.permute) == (
            j.enabled, j.spec.n_bits, j.axis, j.n_groups, j.permute), n
    assert "L0.attn.q.w" not in tq and "shared.attn.q.w" in tq
    assert len([1 for _, c in tq.items() if c.kind == "weight"]) == 15


# ---------------------------------------------------------------------------
# The grouped linear
# ---------------------------------------------------------------------------


def _grouped_case(seed, g, out_f, in_f, m=6):
    rng = np.random.RandomState(seed)
    w = rng.normal(0, 0.2, (out_f, in_f // g)).astype(np.float32)
    b = rng.normal(0, 0.1, (out_f,)).astype(np.float32)
    x = rng.normal(0, 1, (2, m, in_f)).astype(np.float32)
    return w, b, x


@pytest.mark.parametrize("g,out_f,in_f", [(4, 16, 8), (4, 64, 32),
                                          (2, 24, 48), (1, 16, 8)])
def test_grouped_linear_float_matches_jax_and_blockdiag(g, out_f, in_f):
    w, b, x = _grouped_case(4, g, out_f, in_f)
    jctx = JB.make_ctx(JQMC(()), {}, JMode())
    want = np.asarray(j_grouped(jctx, "t", jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(b), g))
    tctx = TB.make_ctx(TQMC(()), {}, QuantMode())
    got = t_grouped(tctx, "t", torch.from_numpy(x), torch.from_numpy(w),
                    torch.from_numpy(b), g)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    wd = TS._block_diag_kernel(torch.from_numpy(w), g).numpy()
    np.testing.assert_array_equal(
        wd, np.asarray(JS._block_diag_kernel(jnp.asarray(w), g)))
    np.testing.assert_allclose(got.numpy(), x @ wd.T + b, rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("g,out_f,in_f,act", [(4, 64, 32, None),
                                              (4, 64, 32, "gelu"),
                                              (2, 64, 32, "relu")])
def test_int8_grouped_linear_matches_jax_and_blockdiag(g, out_f, in_f, act):
    """The int8 grouped product (asymmetric input payload, per-channel
    symmetric weight) equals JAX's, and the packed block-diagonal weight's
    dense int8 product (off-block levels exactly 0)."""
    from transformer_quantization_tpu.ops import int_linear as JIL
    from transformer_quantization_tpu.quant import quantizers as JQ

    w, b, x = _grouped_case(5, g, out_f, in_f)
    wspec = JQ.QuantizerSpec(method=JQ.QMethod.symmetric_uniform, n_bits=8)
    xspec = JQ.QuantizerSpec(method=JQ.QMethod.asymmetric_uniform, n_bits=8)
    jwqp = JQ.set_quant_range(wspec, jnp.min(w, axis=1), jnp.max(w, axis=1))
    jxqp = JQ.set_quant_range(xspec, jnp.asarray(x.min()),
                              jnp.asarray(x.max()))
    jpk = JIL.pack_weight_int8(wspec, jwqp, jnp.asarray(w))
    jx8, jsx, jsh = JIL.quantize_activation_int8(xspec, jxqp, jnp.asarray(x))
    jact = {None: None, "gelu": jax.nn.gelu, "relu": jax.nn.relu}[act]
    if act == "gelu":
        jact = functools.partial(jax.nn.gelu, approximate=False)
    want = np.asarray(JIL.int8_grouped_linear(jx8, jsx, jsh, jpk,
                                              jnp.asarray(b), g, jact))
    tpk = {k: (v if k == "n_bits" else torch.from_numpy(np.array(v)))
           for k, v in jpk.items()}
    tx8 = torch.from_numpy(np.array(jx8))
    sx = torch.from_numpy(np.array(jsx))
    sh = torch.from_numpy(np.array(jsh))
    from transformer_quantization_tpu_torch.ops.layers import ACTIVATIONS
    got = TIL.int8_grouped_linear(tx8, sx, sh, tpk, torch.from_numpy(b), g,
                                  ACTIVATIONS[act])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # block-diagonal dense form: every off-block level packs to 0
    tqp = TQ.QuantParams(*(torch.from_numpy(np.array(getattr(jwqp, f)))
                           for f in ("delta", "zero_float", "signed")))
    tspec = TQ.QuantizerSpec(method=TQ.QMethod.symmetric_uniform, n_bits=8)
    dense = TIL.pack_weight_int8(tspec, tqp,
                                 TS._block_diag_kernel(torch.from_numpy(w),
                                                       g))
    og, ig = out_f // g, in_f // g
    for j in range(g):
        blk = dense["w_int"][j * og:(j + 1) * og].clone()
        np.testing.assert_array_equal(
            blk[:, j * ig:(j + 1) * ig].numpy(),
            tpk["w_int"][j * og:(j + 1) * og].numpy())
        blk[:, j * ig:(j + 1) * ig] = 0
        assert not blk.any()
    dense_y = TIL.int8_linear(tx8, sx, sh, dense, torch.from_numpy(b),
                              ACTIVATIONS[act])
    np.testing.assert_allclose(got.numpy(), dense_y.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_grouped_fast_path_refuses_per_embedding_input():
    """A per-embedding input site (scales along the contraction) keeps the
    grouped layer off the int8 product, on the float path (JAX
    ``ops/layers.py:380``); a per-token one takes it. Both agree with the
    float path on the fake-quant weight."""
    g, out_f, in_f = 4, 64, 32
    w, b, x = (torch.from_numpy(a) for a in _grouped_case(7, g, out_f, in_f))
    builder = QuantConfigBuilder(TC.w8a8_defaults())
    builder.act("x")
    builder.weight("t.w")
    builder.act("t.out")
    for axis, int8 in ((2, False), (1, True)):
        q = builder.build().replace_site("x", axis=axis)
        ctx = TB.make_ctx(q, {}, QuantMode(act_phase=Phase.estimate))
        ctx.act("x", x)
        st = dict(ctx.export(), **init_weight_qstate(q, {"t.w": w}))
        packed = TIL.pack_weight_int8(q["t.w"].spec, st["t.w"]["qp"], w)
        calls = []
        real = TIL.int8_grouped_linear
        TIL.int8_grouped_linear = (lambda *a, **k: calls.append(1)
                                   or real(*a, **k))
        try:
            ctx = TB.make_ctx(q, st, QuantMode(), int_params={"t": packed})
            xq = ctx.act("x", x)
            got = t_grouped(ctx, "t", xq, w, b, g, input_site="x")
        finally:
            TIL.int8_grouped_linear = real
        assert bool(calls) == int8, axis
        want = t_grouped(TB.make_ctx(q, st, QuantMode()), "t", xq, w, b, g,
                         input_site="x")
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)
