"""Port parity for model-level AdaRound (``training/adaround_driver.py``,
the capture hooks, alpha packing, ``convert.py`` and checkpoints) against
the JAX package.

The model is a tiny BERT (2 layers, H=32, 2 heads, I=64, seq 16), its
params from JAX's init carried across with ``convert.py``; weights get
current-minmax 4-bit symmetric ranges, then both packages run AdaRound
over all 22 layer specs (16 samples, 50 iterations at minibatch 16, so
the index draw only reorders rows) and post_adaround 8-bit asymmetric act
ranges. The data are numpy batches from a seed. JAX's forwards run
jitted without XLA's backend optimizations (``O0``): the AdaRound
driver's captures come from one program for all layers (``_jax_apply``:
the full-precision targets, which do not depend on the quant state, one
forward a batch; the quantized-prefix inputs with init alphas standing
in for the alphas not learned yet, whose hard decisions are the
round-to-nearest ones, checked), and its per-layer optimizer and local
losses from one program a layer shape (``_optimizer_jit``). The file
takes ~50 s in one process, most of it JAX's compiles.

Tolerances:
- the hard rounding decisions after AdaRound: at most 0.1% of weights
  differ (Adam divides a near-zero gradient entry by its own size, so
  where the two packages' sums round apart its steps part; in the
  embedding tables, whose capture input is the same token ids in both
  modes, the reconstruction loss starts at rounding level);
- captures: the embedding ids equal, float inputs and outputs within
  rtol 1e-5 with an absolute floor of 1e-6 of the largest;
  ``make_layer_apply`` within rtol 1e-6 (floor 1e-6);
- ``adaround_multi_eval``: the same chosen batch size, scores within rtol
  1e-2 (the act ranges come from each package's own alphas);
- packing with alphas: bit for bit; the engine's logits rtol 1e-3 / atol
  2e-3 (tests/test_engine.py's bound);
- checkpoints: alphas, int params and logits bit for bit.
"""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_quantization_tpu.models import bert as JB
from transformer_quantization_tpu.quant import adaround as JAR
from transformer_quantization_tpu.quant.qconfig import QuantDefaults
from transformer_quantization_tpu.quant.qconfig import QuantMode as JMode
from transformer_quantization_tpu.quant.quantizers import QMethod
from transformer_quantization_tpu.quant.ranges import RangeMethod
from transformer_quantization_tpu.training import adaround_driver as JAD
from transformer_quantization_tpu.training.calibration import (
    prepare_quantized_model,
)
from transformer_quantization_tpu.utils import checkpoint as JCK
from transformer_quantization_tpu_torch import convert as C
from transformer_quantization_tpu_torch.models import bert as TB
from transformer_quantization_tpu_torch.quant import adaround as TAR
from transformer_quantization_tpu_torch.quant import quantizers as TQ
from transformer_quantization_tpu_torch.quant.qconfig import QuantMode
from transformer_quantization_tpu_torch.serving import server as TS
from transformer_quantization_tpu_torch.training import adaround_driver as TAD
from transformer_quantization_tpu_torch.training import calibration as TC
from transformer_quantization_tpu_torch.utils import checkpoint as TCK

torch.set_num_threads(2)

KW = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
          num_attention_heads=2, intermediate_size=64,
          max_position_embeddings=64, num_labels=2)
SEQ, N = 16, 16
RTOL, ATOL = 1e-3, 2e-3
MAX_FLIP_FRAC = 1e-3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(want, got, rtol=1e-5, floor=1e-6):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=floor * float(np.abs(want).max()))


def _batch(rng, b):
    lens = rng.randint(10, SEQ + 1, (b, 1))
    return {"input_ids": rng.randint(0, KW["vocab_size"], (b, SEQ)).astype(
                np.int32),
            "attention_mask": (np.arange(SEQ)[None, :] < lens).astype(
                np.float32),
            "token_type_ids": (np.arange(SEQ)[None, :] >= lens // 2).astype(
                np.int32)}


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _shim(**over):
    """The ``jax`` module with some attributes replaced."""
    ns = types.SimpleNamespace(**{k: getattr(jax, k) for k in dir(jax)
                                  if not k.startswith("__")})
    for k, v in over.items():
        setattr(ns, k, v)
    return ns


def _o0_jit(f=None, **kw):
    return jax.jit(f, compiler_options={"xla_backend_optimization_level": 0},
                   **kw)


_PROGRAMS = {}


def _optimizer_jit(f=None, **kw):
    """JAX's per-layer optimizer loop and its before / after losses at
    O0, each program shared between layers that trace to the same jaxpr:
    the arrays a layer closes over (weight, bias, cached rows) go in as
    arguments instead of constants baked into a program of their own."""
    def call(*args):
        closed, shape = jax.make_jaxpr(f, return_shape=True)(*args)
        key = str(closed.jaxpr)
        if key not in _PROGRAMS:
            _PROGRAMS[key] = _o0_jit(functools.partial(jax.core.eval_jaxpr,
                                                       closed.jaxpr))
        flat = _PROGRAMS[key](closed.consts, *jax.tree.leaves(args))
        return jax.tree.unflatten(jax.tree.structure(shape), flat)
    return call


def _jax_apply(jcfg, fill=None):
    """JAX's forward for its AdaRound driver and evaluation, jitted: the
    full-precision captures, which do not depend on the quant state, from
    one forward a batch; the quantized-prefix captures from one program
    for every layer, with ``fill``'s alphas standing in for a weight
    site's missing one (init alphas, whose hard decisions are the
    round-to-nearest ones JAX applies without an alpha), so that the
    state's structure, and the program, stay the same as the driver adds
    alphas."""
    fwd = _o0_jit(functools.partial(JB.bert_apply, cfg=jcfg),
                  static_argnames=("qcfg", "mode", "capture_sites",
                                   "capture_pre_act"))
    fp_captures = {}

    def apply(params, batch, qcfg=None, qstate=None, mode=None,
              mse_session=None, capture_sites=None, capture_pre_act=False):
        if not capture_sites:
            return fwd(params, batch, qcfg=qcfg, qstate=qstate, mode=mode)
        names = tuple(n for n, _ in JB.bert_adaround_specs(params, jcfg))
        if mode.weight_quant or mode.act_quant:
            if fill is not None:
                qstate = {k: dict(v, alpha=fill[k])
                          if k in fill and v.get("alpha") is None else v
                          for k, v in qstate.items()}
            return fwd(params, batch, qcfg=qcfg, qstate=qstate, mode=mode,
                       capture_sites=names, capture_pre_act=capture_pre_act)
        key = (np.asarray(batch["input_ids"]).tobytes(), capture_pre_act)
        if key not in fp_captures:
            fp_captures[key] = fwd(params, batch, qcfg=qcfg, qstate=qstate,
                                   mode=mode, capture_sites=names,
                                   capture_pre_act=capture_pre_act)
        return fp_captures[key]
    return apply


def _jax_defaults():
    return QuantDefaults(method=QMethod.symmetric_uniform,
                         act_method=QMethod.asymmetric_uniform, n_bits=4,
                         n_bits_act=8,
                         weight_range_method=RangeMethod.current_minmax,
                         act_range_method=RangeMethod.current_minmax)


@pytest.fixture(scope="module")
def ar():
    jcfg, tcfg = JB.BertConfig(**KW), TB.BertConfig(**KW)
    jp = jax.jit(lambda k: JB.init_bert_params(k, jcfg))(jax.random.PRNGKey(0))
    tp = C.params_from_jax(_np(jp), device="cpu")
    jq = JB.declare_bert_sites(_jax_defaults(), jcfg)
    tq = TB.declare_bert_sites(dataclasses.replace(
        TC.w8a8_defaults(), n_bits=4, n_bits_act=8), tcfg)
    rng = np.random.RandomState(3)
    batches = [_batch(rng, 8) for _ in range(2)]
    eval_batch = _batch(rng, 8)
    est = {k: np.concatenate([b[k] for b in batches]) for k in batches[0]}
    tapply = functools.partial(TB.bert_apply, cfg=tcfg)
    js0, _ = prepare_quantized_model(
        _jax_apply(jcfg), jp, jq, [_jbatch(batches[0])],
        weight_tensors=JB.bert_weight_site_tensors(jp), act_quant=False)
    ts0 = C.qstate_from_jax(_np(js0), device="cpu")
    # the init alphas (the port's, bit for bit JAX's) and their hard
    # decisions: round-to-nearest, entry for entry
    tw = TB.bert_weight_site_tensors(tp)
    fill = {}
    for n, _ in TB.bert_adaround_specs(tp, tcfg):
        c, qp, w = tq[n + ".w"], ts0[n + ".w"]["qp"], tw[n + ".w"]
        a = TQ.adaround_init_alpha(TQ.AdaRoundMode.learned_hard_sigmoid,
                                   c.spec, qp, w)
        assert torch.equal(TQ.adaround_fake_quant(
            TQ.AdaRoundMode.learned_hard_sigmoid, c.spec, qp, w, a,
            soft=False), TQ.fake_quant(c.spec, qp, w)), n
        fill[n + ".w"] = jnp.asarray(a.numpy())
    japply = _jax_apply(jcfg, fill)
    kw = dict(num_samples=N, iters=50, batch_size=N)
    jstats, tstats = [], []
    saved = JAD.jax, JAR.jax
    JAD.jax, JAR.jax = (_shim(jit=lambda f=None, **k: f),
                        _shim(jit=_optimizer_jit))
    try:
        js = JAD.apply_adaround_to_model(
            japply, jp, jq, js0, JB.bert_adaround_specs(jp, jcfg),
            [_jbatch(b) for b in batches], JAR.AdaRoundConfig(**kw),
            batch_size=N, act_quant=True,
            range_est_batches=[_jbatch(est)], stats_out=jstats)
    finally:
        JAD.jax, JAR.jax = saved
    ts = TAD.apply_adaround_to_model(
        tapply, tp, tq, ts0, TB.bert_adaround_specs(tp, tcfg), batches,
        TAR.AdaRoundConfig(**kw), batch_size=N, act_quant=True,
        range_est_batches=[est], stats_out=tstats, device="cpu")
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, jq=jq, tq=tq, js0=js0,
                ts0=ts0, js=js, ts=ts, jstats=jstats, tstats=tstats,
                batches=batches, est=est, eval_batch=eval_batch,
                japply=japply,
                tapply=tapply, ts_j=C.qstate_from_jax(_np(js), device="cpu"))


# ---------------------------------------------------------------------------
# the AdaRound driver end to end, and the evaluation protocol
# ---------------------------------------------------------------------------


def test_adaround_decisions_match_jax(ar):
    names = [n for n, _ in TB.bert_adaround_specs(ar["tp"], ar["tcfg"])]
    assert len(names) == 4 + 8 * KW["num_hidden_layers"] + 2
    assert [n for n, _ in ar["tstats"]] == [n for n, _ in ar["jstats"]] \
        == names
    total = flips = 0
    for n in names:
        ja = np.asarray(ar["js"][n + ".w"]["alpha"])
        ta = ar["ts"][n + ".w"]["alpha"]
        assert ta.dtype == torch.float32 and ta.shape == ja.shape, n
        total += ja.size
        flips += int(((ta.numpy() >= 0) != (ja >= 0)).sum())
    assert flips <= MAX_FLIP_FRAC * total
    # the local losses fell where JAX's did, and the post_adaround act
    # ranges were re-estimated on every act site JAX has
    for (n, jst), (_, tst) in zip(ar["jstats"], ar["tstats"]):
        np.testing.assert_allclose(tst["loss_hard_before"],
                                   jst["loss_hard_before"], rtol=1e-4,
                                   atol=1e-9, err_msg=n)
    acts = {k for k, v in ar["js"].items() if "range_state" in v}
    assert acts and acts == {k for k, v in ar["ts"].items()
                             if "range_state" in v}


def _logit_score(apply_fn, params, batch, qcfg, fp_logits):
    def eval_fn(qs, mode):
        logits = np.asarray(apply_fn(params, batch, qcfg=qcfg, qstate=qs,
                                     mode=mode)[0]["logits"])
        return -float(np.mean((logits - fp_logits) ** 2)), None
    return eval_fn


def test_multi_eval_chooses_jax_batch_size(ar):
    # scored on the samples by JAX's jitted forward
    est = eb = ar["est"]
    jeval = ar["japply"]
    jfp = np.asarray(jeval(ar["jp"], _jbatch(eb))[0]["logits"])
    tapply = functools.partial(ar["tapply"], device="cpu")
    tfp = tapply(ar["tp"], eb)[0]["logits"].numpy()
    kw = dict(est_arrays=est, num_est_batches=1, est_pad=True,
              log_fn=lambda s: None)
    jscore, jd = JAD.adaround_multi_eval(
        ar["japply"], ar["jp"], ar["jq"], ar["js"],
        eval_fn=_logit_score(jeval, ar["jp"], _jbatch(eb), ar["jq"], jfp),
        act_quant_mode=JAR.AdaRoundActQuantMode.post_adaround, **kw)
    tscore, td = TAD.adaround_multi_eval(
        tapply, ar["tp"], ar["tq"], ar["ts"],
        eval_fn=_logit_score(tapply, ar["tp"], eb, ar["tq"], tfp),
        act_quant_mode=TAR.AdaRoundActQuantMode.post_adaround, device="cpu",
        **kw)
    assert td["best_batch_size"] == jd["best_batch_size"]
    assert sorted(td["scores"]) == sorted(jd["scores"]) == [1, 4, 16]
    for bs, v in jd["scores"].items():
        np.testing.assert_allclose(td["scores"][bs], v, rtol=1e-2)
    np.testing.assert_allclose(tscore, jscore, rtol=1e-2)
    np.testing.assert_allclose(td["fp_acts_score"], jd["fp_acts_score"],
                               rtol=1e-2)
    # no_act_quant scores FP32 activations only
    _, nd = TAD.adaround_multi_eval(
        tapply, ar["tp"], ar["tq"], ar["ts"],
        eval_fn=_logit_score(tapply, ar["tp"], eb, ar["tq"], tfp),
        act_quant_mode=TAR.AdaRoundActQuantMode.no_act_quant, device="cpu",
        **kw)
    assert nd["best_batch_size"] is None and nd["scores"] == {}


# ---------------------------------------------------------------------------
# capture at every spec kind, asym on and off
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pre_act", (False, True), ids=("post", "pre"))
@pytest.mark.parametrize("asym", (False, True), ids=("fp", "asym"))
def test_captures_match_jax(ar, asym, pre_act):
    """Every spec's (input, output) pair and two standalone act sites,
    captured in one forward with JAX's AdaRound state (alphas in play
    under the asymmetric mode's quantized weights)."""
    names = [n for n, _ in TB.bert_adaround_specs(ar["tp"], ar["tcfg"])]
    sites = names + ["emb.sum_pos", "L1.attn_out.res"]
    b = ar["est"]
    mode = dict(weight_quant=asym, act_quant=False)
    jout, _ = _o0_jit(functools.partial(JB.bert_apply, cfg=ar["jcfg"]),
                      static_argnames=("qcfg", "mode", "capture_sites",
                                       "capture_pre_act"))(
        ar["jp"], _jbatch(b), qcfg=ar["jq"], qstate=ar["js"],
        mode=JMode(**mode), capture_sites=tuple(sites),
        capture_pre_act=pre_act)
    tout, _ = TB.bert_apply(ar["tp"], b, ar["tcfg"], ar["tq"], ar["ts_j"],
                            QuantMode(**mode), capture_sites=sites,
                            capture_pre_act=pre_act, device="cpu")
    assert set(tout["captures"]) == set(jout["captures"]) == set(sites)
    for n in sites:
        (jx, jy), (tx, ty) = jout["captures"][n], tout["captures"][n]
        if n.startswith("emb.") and n != "emb.ln" and "sum" not in n:
            np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
        else:
            _close(jx, tx)
        _close(jy, ty)
    # the pre-activation target is the gelu's input: the other flag's
    # capture is its output
    other, _ = TB.bert_apply(ar["tp"], b, ar["tcfg"], ar["tq"], ar["ts_j"],
                             QuantMode(**mode), capture_sites=sites,
                             capture_pre_act=not pre_act, device="cpu")
    pre, post = (tout, other) if pre_act else (other, tout)
    gelu = TAD.ACTIVATIONS["gelu"]
    for n in ("L0.ffn.inter", "L1.ffn.inter", "pooler.dense"):
        act = torch.tanh if n == "pooler.dense" else gelu
        assert torch.equal(act(pre["captures"][n][1]),
                           post["captures"][n][1]), n


def test_capture_layer_io_matches_jax(ar):
    """The AdaRound driver's capture over the samples (two batches
    concatenated; the asymmetric input under quantized weights with
    alphas)."""
    samples = TAD.get_train_samples(ar["batches"], N)
    jsamples = JAD.get_train_samples([_jbatch(b) for b in ar["batches"]], N)
    saved = JAD.jax
    JAD.jax = _shim(jit=lambda f=None, **k: f)
    try:
        for site in ("L1.ffn.inter", "L0.attn_out.ln"):
            want = JAD._capture_layer_io(
                ar["japply"], ar["jp"], ar["jq"], ar["js"], jsamples, site,
                8, asym=True, act_quant=False, include_act_func=True)
            got = TAD._capture_layer_io(
                ar["tapply"], ar["tp"], ar["tq"], ar["ts_j"], samples, site,
                8, asym=True, act_quant=False, include_act_func=True,
                device="cpu")
            for w, g in zip(want, got):
                assert g.shape == w.shape == (N, SEQ, g.shape[-1])
                _close(w, g)
    finally:
        JAD.jax = saved


LAYER_SPECS = {
    "linear-gelu": ("linear", dict(act="gelu")),
    "linear-tanh": ("linear", dict(act="tanh")),
    "linear": ("linear", dict(act=None)),
    "layernorm": ("layernorm", dict(eps=1e-12)),
    "embedding": ("embedding", {}),
    "grouped_linear": ("grouped_linear", dict(groups=4, act="gelu_new")),
    "nonorm": ("nonorm", {}),
}


@pytest.mark.parametrize("case", sorted(LAYER_SPECS))
def test_make_layer_apply_matches_jax(case):
    kind, extra = LAYER_SPECS[case]
    rng = np.random.RandomState(4)
    x = rng.randn(3, 5, 32).astype(np.float32)
    if kind == "layernorm":
        w = (1 + 0.1 * rng.randn(32)).astype(np.float32)
    elif kind == "nonorm":
        w = rng.randn(64).astype(np.float32)
    elif kind == "grouped_linear":
        w = rng.randn(32, 8).astype(np.float32)
    else:
        w = (0.2 * rng.randn(24, 32)).astype(np.float32)
    if kind == "embedding":
        x = rng.randint(0, 24, (3, 5)).astype(np.int64)
    b = (0.1 * rng.randn(w.shape[0] if kind != "layernorm" else 32)
         ).astype(np.float32)
    jspec = dict(kind=kind, b=jnp.asarray(b), **extra)
    tspec = dict(kind=kind, b=_t(b), **extra)
    want = JAD.make_layer_apply(jspec)(jnp.asarray(w), jnp.asarray(x))
    got = TAD.make_layer_apply(tspec)(_t(w), _t(x))
    _close(want, got, rtol=1e-6)


# ---------------------------------------------------------------------------
# packing with alphas and the engine; convert and checkpoints
# ---------------------------------------------------------------------------


def _jax_int_params(ar):
    return JB.build_bert_int_params(ar["jp"], ar["jq"], ar["js"],
                                    use_int4=True)


def test_alpha_params_pack_exactly_and_drive_the_engine(ar):
    jint = _jax_int_params(ar)
    tint = TB.build_bert_int_params(ar["tp"], ar["tq"], ar["ts_j"],
                                    use_int4=True)
    assert set(tint) == set(jint)
    for name, p in _np(jint).items():
        assert set(tint[name]) == set(p), name
        # a 4-bit site with an alpha packs int8 storage of its levels
        assert "w_packed" not in tint[name], name
        for k, v in p.items():
            if k == "n_bits":
                assert tint[name][k] == v == 4
            else:
                np.testing.assert_array_equal(tint[name][k].numpy(), v,
                                              err_msg=f"{name}/{k}")
    # the alphas changed the packing somewhere (against nearest)
    near = TB.build_bert_int_params(ar["tp"], ar["tq"], ar["ts0"])
    assert any(not torch.equal(near[n]["w_int"], tint[n]["w_int"])
               for n in tint if "w_int" in tint[n])
    jcfg, jq = ar["jcfg"], ar["jq"]
    jst, jplan, _ = JB.build_bert_engine(ar["jp"], jcfg, jq, ar["js"],
                                         int_params=jint)
    eb = ar["eval_batch"]
    want = jax.jit(lambda p, b, s, plan, ip: JB.bert_engine_apply(
        p, b, jcfg, jq, s, jst, plan, ip, backend="xla")["logits"])(
        ar["jp"], _jbatch(eb), ar["js"], jplan, jint)
    tst, tplan, tint2 = TB.build_bert_engine(ar["tp"], ar["tcfg"], ar["tq"],
                                             ar["ts_j"], device="cpu")
    assert tst.int8_layer == (True, True) and not any(any(f)
                                                      for f in tst.w4)
    got = TB.bert_engine_apply(ar["tp"], eb, ar["tcfg"], ar["tq"],
                               ar["ts_j"], tst, tplan, tint2,
                               device="cpu")["logits"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_alpha_checkpoint_round_trip_and_server(ar, tmp_path):
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jint = _jax_int_params(ar)
    JCK.save_checkpoint(jdir, params=ar["jp"], family="bert",
                        cfg=ar["jcfg"], qstate=ar["js"], int_params=jint)
    ck = TCK.load_checkpoint(jdir, device="cpu")
    n_alpha = 0
    for name, st in _np(ar["js"]).items():
        a = st.get("alpha")
        if a is None:
            assert ck["qstate"][name].get("alpha") is None
            continue
        n_alpha += 1
        got = ck["qstate"][name]["alpha"]
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), a)
        assert torch.equal(got, ar["ts_j"][name]["alpha"])
    assert n_alpha == 4 + 8 * KW["num_hidden_layers"] + 2
    TCK.save_checkpoint(tdir, params=ck["params"], family="bert",
                        cfg=ck["cfg"], qstate=ck["qstate"],
                        int_params=ck["int_params"])
    back = JCK.load_checkpoint(tdir)
    again = TCK.load_checkpoint(tdir, device="cpu")
    for name, st in _np(ar["js"]).items():
        if st.get("alpha") is not None:
            np.testing.assert_array_equal(
                np.asarray(back["qstate"][name]["alpha"]), st["alpha"])
            assert torch.equal(again["qstate"][name]["alpha"],
                               ck["qstate"][name]["alpha"])
    # the server builds the engine from the JAX-written directory (its W8A8
    # site declarations over the checkpoint's state) and answers as the
    # engine built from the loaded state does
    eng = TS.build_engine_from_checkpoint(jdir, device="cpu")
    qcfg = TB.declare_bert_sites(TC.w8a8_defaults(), ck["cfg"])
    st, plan, ip = TB.build_bert_engine(ck["params"], ck["cfg"], qcfg,
                                        ck["qstate"], device="cpu")
    eb = ar["eval_batch"]
    want = TB.bert_engine_apply(ck["params"], eb, ck["cfg"], qcfg,
                                ck["qstate"], st, plan, ip,
                                device="cpu")["logits"]
    got = eng.forward(eb)
    assert got.shape == (8, 2) and torch.isfinite(got).all()
    assert torch.equal(got, want)
