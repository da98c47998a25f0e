"""Port parity for PTQ calibration as the JAX CLI defines it: the recipes
``w8a8``, ``w8a8-mixed`` (and its STS-B variant) and ``w8a8-peg`` with
MSE golden-section weight ranges, through ``prepare_quantized_model``
into the simulation and the engine, plus dynamic ranges,
``reset_act_ranges`` and the checkpoint directory.

The JAX side takes each recipe from the JAX CLI itself (``build_parser``
+ ``apply_recipe`` + ``make_quant_defaults``) and calibrates a random BERT
eagerly, as the CLI does, on one sequence; the port calibrates the same
params (``convert.py``) with ``calibrated_bert(recipe=...)``. The size is
tests/test_torch_recipes.py's wide one cut to 2 layers (H=192, 4 heads,
I=768, seq 32), whose H splits into the PEG recipe's 6 groups. JAX jits one
golden-section search per weight site, most of this file's time, so its
weight ranges are computed once and shared by the four recipes (every
recipe sets the same weight sites); the JAX logits run eagerly, which
shares its op compiles across the recipes.

Tolerances:
- weight sites: the MSE tolerance of tests/test_torch_ranges.py (scales
  within rtol 1e-5 of JAX's, else the port's range no worse than JAX's by
  the float64 loss, printed);
- act sites, calibrated by the port from JAX's weight ranges: 1e-5
  relative at the embedding sites, 1e-2 after the first matmul, as
  deep sites in tests/test_torch_recipes.py (JAX's eager float32 dots
  sum in another order than torch's, and a last-bit difference that
  flips a level of an upstream fake-quant moves the ranges after it:
  3.7e-6 at the mixed recipe's ``L0.ffn.inter``, ~4e-4 at PEG's
  ``L0.ffn.res``); the STS-B variant's MSE ``classifier.out`` by the MSE
  tolerance on the logits that reach it;
- logits of the port's own calibration (engine and simulation) against
  JAX's, with its act ranges calibrated on the port's weight ranges and
  with its whole calibration: rtol 1e-3 / atol 2e-3 (W8A8), 2e-3 / 3e-3
  (mixed, STS-B, PEG);
- dynamic ranges: logits within the same bounds; ``reset_act_ranges``
  and the checkpoint round trip: equal arrays.
"""

import contextlib
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ranges import fused_golden_points
from transformer_quantization_tpu import cli as JCLI
from transformer_quantization_tpu.models import bert as JB
from transformer_quantization_tpu.quant import manager as JM
from transformer_quantization_tpu.quant import quantizers as JQ
from transformer_quantization_tpu.training import calibration as JCAL
from transformer_quantization_tpu.utils import checkpoint as JCK
from transformer_quantization_tpu_torch import convert as C
from transformer_quantization_tpu_torch.models import bert as TB
from transformer_quantization_tpu_torch.quant import manager as TM
from transformer_quantization_tpu_torch.quant import quantizers as TQ
from transformer_quantization_tpu_torch.quant import ranges as TR
from transformer_quantization_tpu_torch.quant.qconfig import QuantMode
from transformer_quantization_tpu_torch.training import calibration as TC
from transformer_quantization_tpu_torch.utils import checkpoint as TCK

torch.set_num_threads(2)

KW = dict(vocab_size=256, hidden_size=192, num_hidden_layers=2,
          num_attention_heads=4, intermediate_size=768,
          max_position_embeddings=64, num_labels=2)
SEQ = 32
RECIPES = ["w8a8", "w8a8-mixed", "w8a8-mixed-stsb", "w8a8-peg"]
BOUNDS = {"w8a8": (1e-3, 2e-3)}
FLEX_BOUNDS = (2e-3, 3e-3)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cli_args(name):
    """The JAX CLI's options after ``--recipe``; the STS-B variant is the
    mixed recipe on the STS-B task."""
    recipe, stsb, _ = name.partition("-stsb")
    argv = ["validate-quantized", "--recipe", recipe]
    if stsb:
        argv += ["--task", "stsb"]
    args = JCLI.build_parser().parse_args(argv)
    JCLI.apply_recipe(args)
    return args


def _port_value(v):
    """A JAX QuantDefaults field as the port spells it (enums by name)."""
    return v.name if hasattr(v, "name") else v


@pytest.mark.parametrize("name", RECIPES)
def test_recipe_table_copies_the_cli(name):
    args = _cli_args(name)
    r = TC.CLI_RECIPES[name]
    jd = JCLI.make_quant_defaults(args)
    for f in ("method", "act_method", "n_bits", "n_bits_act",
              "per_channel_weights", "percentile", "weight_range_method",
              "weight_range_opt", "weight_num_candidates",
              "act_range_method", "act_range_opt", "act_momentum",
              "act_num_candidates", "scale_domain"):
        assert _port_value(getattr(r.defaults, f)) == _port_value(
            getattr(jd, f)), f
    assert dict(r.quant_dict) == JCLI.parse_quant_dict(args.quant_dict)
    assert r.quant_setup == args.quant_setup
    assert r.shared_h == bool(args.per_groups_permute_shared_h)
    assert r.est_batch_size == args.est_ranges_batch_size
    assert args.num_est_batches == 1  # calibrated_bert's one batch
    assert args.est_ranges_pad is False  # trimmed; the batches are full


_CACHE = {}


@contextlib.contextmanager
def _shared_jax_weight_ranges():
    """JAX's ``init_weight_qstate`` computed once for the module's params
    (the recipes share every weight site's config)."""
    real = JCAL.init_weight_qstate

    def shared(qcfg, tensors):
        if "weights" not in _CACHE:
            _CACHE["weights"] = real(qcfg, tensors)
        return dict(_CACHE["weights"])

    JCAL.init_weight_qstate = shared
    try:
        yield
    finally:
        JCAL.init_weight_qstate = real


def _params():
    if "params" not in _CACHE:
        jcfg = JB.BertConfig(**KW)
        jp = jax.jit(lambda k: JB.init_bert_params(k, jcfg))(
            jax.random.PRNGKey(0))
        _CACHE["params"] = jp, C.params_from_jax(_np(jp), device="cpu")
    return _CACHE["params"]


def _request():
    rng = np.random.RandomState(1)
    return {
        "input_ids": rng.randint(0, KW["vocab_size"], (4, SEQ)).astype(
            np.int32),
        "attention_mask": (np.arange(SEQ)[None, :]
                           < rng.randint(SEQ // 2, SEQ + 1, (4, 1))
                           ).astype(np.float32),
        "token_type_ids": np.zeros((4, SEQ), np.int32),
    }


@pytest.fixture(scope="module", params=RECIPES)
def setup(request):
    return _calibrate(request.param)


def _calibrate(name):
    """Both packages' calibrations of one recipe, and JAX's logits."""
    args = _cli_args(name)
    r = TC.CLI_RECIPES[name]
    jcfg, tcfg = JB.BertConfig(**KW), TB.BertConfig(**KW)
    jp, tp = _params()
    qd = JCLI.parse_quant_dict(args.quant_dict)
    jq = JB.declare_bert_sites(JCLI.make_quant_defaults(args), jcfg,
                               quant_setup=args.quant_setup, quant_dict=qd)
    jq = JB.apply_bert_quant_dict(jq, qd, jcfg.num_hidden_layers)
    cal = TC.calibration_batch(KW["vocab_size"], args.est_ranges_batch_size,
                               SEQ, 0)
    jcal = [{k: jnp.asarray(v) for k, v in cal.items()}]
    shared = (JB.shared_permutation_groups(jcfg.num_hidden_layers)
              if args.per_groups_permute_shared_h else None)
    apply_fn = functools.partial(JB.bert_apply, cfg=jcfg)
    prepare = functools.partial(
        JCAL.prepare_quantized_model, apply_fn, jp, jq, jcal,
        weight_tensors=JB.bert_weight_site_tensors(jp),
        num_batches=args.num_est_batches, shared_groups=shared,
        permute_batches=jcal)
    with _shared_jax_weight_ranges():
        js, jmode = prepare()
        js_dyn, jmode_dyn = prepare(dynamic=True)
    jint = JB.build_bert_int_params(jp, jq, js)
    batch = _request()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    # the port: its own calibration, and act ranges from JAX's weight
    # ranges and PEG permutations
    _, tq, ts = TC.calibrated_bert(tcfg, batch_size=r.est_batch_size,
                                   seq=SEQ, seed=0, device="cpu", params=tp,
                                   recipe=name)
    base = TM.reset_act_ranges(tq, C.qstate_from_jax(_np(js), device="cpu"))
    ts_from_jax_w = TC.calibrate_model(
        lambda p, b, **k: TB.bert_apply(p, b, tcfg, **k), tp, tq, [cal],
        device="cpu", qstate=base)
    # JAX's act ranges from the port's weight ranges: the reference for the
    # port's own calibration end to end
    jbase = JM.reset_act_ranges(jq, js)
    jbase.update({n: {"qp": _jax_qp(st["qp"]), "alpha": None}
                  for n, st in ts.items() if "alpha" in st})
    js_pw = JCAL.calibrate_model(apply_fn, jp, jq, jcal, qstate=jbase)
    jint_pw = JB.build_bert_int_params(jp, jq, js_pw)
    jstatic, jplan, _ = JB.build_bert_engine(jp, jcfg, jq, js_pw,
                                             int_params=jint_pw)
    own_static, own_plan, _ = JB.build_bert_engine(jp, jcfg, jq, js,
                                                   int_params=jint)
    # JAX's forwards jitted (the eager engine compiles op by op, ten times
    # the jitted program's time), one program each for both qstates
    engine = jax.jit(lambda static, s, plan, ip: JB.bert_engine_apply(
        jp, jbatch, jcfg, jq, s, static, plan, ip, backend="xla")["logits"],
        static_argnums=0)
    sim = jax.jit(lambda mode, s: JB.bert_apply(
        jp, jbatch, jcfg, jq, s, mode)[0]["logits"], static_argnums=0)
    want = {
        "eng": engine(jstatic, js_pw, jplan, jint_pw),
        "sim": sim(jmode, js_pw),
        "eng_own": engine(own_static, js, own_plan, jint),
        "sim_own": sim(jmode, js),
    }
    try:
        want["dyn"] = sim(jmode_dyn, js_dyn)
    except RuntimeError as e:  # an MSE act site has no session at eval
        want["dyn"] = e
    return dict(name=name, args=args, jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp,
                jq=jq, js=js, jint=jint, js_dyn=js_dyn, jmode=jmode,
                jmode_dyn=jmode_dyn, tq=tq, ts=ts,
                ts_from_jax_w=ts_from_jax_w, batch=batch, cal=cal,
                want={k: v if isinstance(v, Exception) else np.asarray(v)
                      for k, v in want.items()})


def _jax_qp(qp):
    return JQ.QuantParams(delta=jnp.asarray(qp.delta.numpy()),
                          zero_float=jnp.asarray(qp.zero_float.numpy()),
                          signed=jnp.asarray(qp.signed.numpy()))


def _bounds(name):
    return BOUNDS.get(name, FLEX_BOUNDS)


def _qp_loss64(spec, x, qp) -> float:
    """The MSE objective of params ``qp`` on ``x``, in float64."""
    x = torch.as_tensor(x)
    y = TQ.fake_quant(spec, qp, x).double()
    return float(((x.double() - y) ** 2).sum())


def _est_qp(site, x, fused=False):
    """The port's params for ``x`` from a fresh estimator of the site."""
    with fused_golden_points() if fused else contextlib.nullcontext():
        est = TR.make_estimator(site.spec, site.range_cfg)
        est.update(torch.as_tensor(x))
        return TQ.set_quant_range(site.spec, *est.finalize())


def assert_qp_close(name, site, x, jqp, tqp) -> None:
    """An MSE site's params against JAX's by the MSE tolerance: scale and
    zero point within rtol 1e-5; else the port's loss on ``x`` no worse
    than JAX's (a near-tie, printed); else the port's search on XLA's
    fused brackets is (printed)."""
    def close(q):
        return all(abs(float(getattr(q, f)) - float(getattr(jqp, f)))
                   <= 1e-5 * abs(float(getattr(jqp, f)))
                   for f in ("delta", "zero_float"))

    if close(tqp):
        return
    lj, lt = _qp_loss64(site.spec, x, jqp), _qp_loss64(site.spec, x, tqp)
    print(f"MSE site {name}: JAX delta {float(jqp.delta)!r} loss {lj!r}, "
          f"port delta {float(tqp.delta)!r} loss {lt!r}")
    if lt <= lj * (1 + 1e-6):
        return
    fqp = _est_qp(site, x, fused=True)
    lf = _qp_loss64(site.spec, x, fqp)
    print(f"MSE site {name} with XLA's fused brackets: delta "
          f"{float(fqp.delta)!r} loss {lf!r}")
    assert close(fqp) or lf <= lj * (1 + 1e-6), name


def test_weight_ranges_match_jax(setup):
    """Every weight site: MSE golden-section ranges by the MSE tolerance."""
    js, ts, tq = _np(setup["js"]), setup["ts"], setup["tq"]
    tensors = TB.bert_weight_site_tensors(setup["tp"])
    n_sites = 0
    for name, site in tq.items():
        if site.kind != "weight":
            continue
        n_sites += 1
        assert (site.range_cfg.method, site.range_cfg.opt_method) == (
            TR.RangeMethod.MSE, TR.OptMethod.golden_section)
        jqp = C.qparams_from_jax(js[name]["qp"], device="cpu")
        np.testing.assert_array_equal(ts[name]["qp"].signed.numpy(),
                                      jqp.signed.numpy())
        assert_qp_close(name, site, tensors[name], jqp, ts[name]["qp"])
    assert n_sites == 4 + 8 * KW["num_hidden_layers"] + 2


def test_act_ranges_match_jax(setup):
    """Act sites, calibrated by the port from JAX's weight ranges (and
    PEG permutations): current-minmax ranges as in
    tests/test_torch_recipes.py; the STS-B variant's MSE logits site by
    the MSE tolerance on the logits that reach it."""
    js, ts = _np(setup["js"]), setup["ts_from_jax_w"]
    assert set(js) == set(ts) == set(setup["ts"])
    for name, st in js.items():
        site = setup["tq"][name]
        if site.kind != "act":
            continue
        tst = ts[name]
        if "perm" in st:
            np.testing.assert_array_equal(tst["perm"].numpy(), st["perm"],
                                          err_msg=name)
        if site.range_cfg.method == TR.RangeMethod.MSE:
            continue  # below
        tol = 1e-5 if name.startswith("emb.") else 1e-2
        d_j, d_t = np.asarray(st["qp"].delta), tst["qp"].delta.numpy()
        assert np.all(np.abs(d_j - d_t) <= tol * np.abs(d_j)), name
        z_j, z_t = (np.asarray(st["qp"].zero_float),
                    tst["qp"].zero_float.numpy())
        assert np.all(np.abs(z_j - z_t)
                      <= tol * np.maximum(1.0, np.abs(z_j))), name
    mse = [n for n, c in setup["tq"].items()
           if c.kind == "act" and c.range_cfg.method == TR.RangeMethod.MSE]
    assert mse == (["classifier.out"] if setup["name"].endswith("-stsb")
                   else [])
    for name in mse:
        _assert_logits_site(setup, name, js[name]["qp"], ts[name]["qp"])


def _assert_logits_site(setup, name, jqp, tqp):
    """The MSE act site on the classifier's output, on the logits of the
    calibration batch that reach it in the port (fixed ranges, the site
    itself off), by the MSE tolerance against JAX's params."""
    site = setup["tq"][name]
    tq = setup["tq"].replace_site(name, enabled=False)
    out, _ = TB.bert_apply(setup["tp"], setup["cal"], setup["tcfg"], tq,
                           setup["ts_from_jax_w"], QuantMode(), device="cpu")
    logits = out["logits"]
    for f in ("delta", "zero_float"):  # the port's calibration took these
        np.testing.assert_array_equal(
            getattr(_est_qp(site, logits), f).numpy(),
            getattr(tqp, f).numpy())
    assert_qp_close(f"{setup['name']}:{name}", site, logits,
                    C.qparams_from_jax(jqp, device="cpu"), tqp)


def _port_logits(setup):
    """The port's own calibration through its engine and its simulation."""
    tp, tcfg, tq, ts = setup["tp"], setup["tcfg"], setup["tq"], setup["ts"]
    static, plan, tint = TB.build_bert_engine(tp, tcfg, tq, ts, device="cpu")
    eng = TB.bert_engine_apply(tp, setup["batch"], tcfg, tq, ts, static,
                               plan, tint, device="cpu")["logits"].numpy()
    sim, _ = TB.bert_apply(tp, setup["batch"], tcfg, tq, ts, QuantMode(),
                           device="cpu")
    return eng, sim["logits"].numpy()


@pytest.mark.parametrize("weights", ["port", "jax"])
def test_engine_and_simulation_match_jax(setup, weights):
    """The port's own calibration through its engine and its simulation
    against JAX's engine (XLA backend) and simulation, JAX's act ranges
    calibrated on the port's weight ranges (``port``: the port's pipeline
    given the same weight ranges) or JAX's whole calibration (``jax``:
    the weight scales then differ by ulps, float64 against float32 loss
    sums, and one calibration sequence carries that to the act ranges
    after the first matmul; JAX's logits move by as much between the
    two calibrations)."""
    rtol, atol = _bounds(setup["name"])
    suffix = "" if weights == "port" else "_own"
    eng, sim = _port_logits(setup)
    np.testing.assert_allclose(eng, setup["want"]["eng" + suffix],
                               rtol=rtol, atol=atol)
    np.testing.assert_allclose(sim, setup["want"]["sim" + suffix],
                               rtol=rtol, atol=atol)


def test_dynamic_ranges_match_jax(setup):
    """``dynamic=True``: only weight sites (and PEG permutations) are set,
    and the eval mode re-estimates act ranges on every batch; an MSE act
    site (the STS-B variant's logits) has no session then, and both
    packages raise."""
    r = TC.CLI_RECIPES[setup["name"]]
    tp, tcfg, tq = setup["tp"], setup["tcfg"], setup["tq"]

    def apply_fn(p, b, **k):
        return TB.bert_apply(p, b, tcfg, **k)

    shared = (TB.shared_permutation_groups(tcfg.num_hidden_layers)
              if r.shared_h else None)
    qs, mode = TC.prepare_quantized_model(
        apply_fn, tp, tq, [setup["cal"]],
        weight_tensors=TB.bert_weight_site_tensors(tp), dynamic=True,
        shared_groups=shared, device="cpu")
    jmode = setup["jmode_dyn"]
    assert (mode.act_phase.name, mode.weight_phase.name) == (
        jmode.act_phase.name, jmode.weight_phase.name)
    assert set(qs) == set(setup["js_dyn"])
    want = setup["want"]["dyn"]
    if isinstance(want, Exception):
        assert setup["name"].endswith("-stsb"), want
        with pytest.raises(RuntimeError, match="mse_session"):
            TB.bert_apply(tp, setup["batch"], tcfg, tq, qs, mode,
                          device="cpu")
        return
    rtol, atol = _bounds(setup["name"])
    out, _ = TB.bert_apply(tp, setup["batch"], tcfg, tq, qs, mode,
                           device="cpu")
    np.testing.assert_allclose(out["logits"].numpy(), want, rtol=rtol,
                               atol=atol)


def test_reset_act_ranges_matches_jax(setup):
    js = setup["js"]
    want = _np(JM.reset_act_ranges(setup["jq"], js))
    got = TM.reset_act_ranges(setup["tq"], C.qstate_from_jax(
        _np(js), device="cpu"))
    assert set(got) == set(want)
    for name, st in want.items():
        for f in ("delta", "zero_float", "signed"):
            np.testing.assert_array_equal(
                getattr(got[name]["qp"], f).numpy(),
                np.asarray(getattr(st["qp"], f)), err_msg=name)
        for k, v in (st.get("range_state") or {}).items():
            np.testing.assert_array_equal(got[name]["range_state"][k].numpy(),
                                          np.asarray(v), err_msg=name)
        if "perm" in st:
            np.testing.assert_array_equal(got[name]["perm"].numpy(),
                                          st["perm"])


def _equal_trees(a, b, path=""):
    """Nested dicts / lists / QuantParams of arrays or tensors, equal."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _equal_trees(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal_trees(x, y, f"{path}#{i}")
    elif hasattr(a, "delta"):
        for f in ("delta", "zero_float", "signed"):
            _equal_trees(getattr(a, f), getattr(b, f), f"{path}@{f}")
    elif a is None:
        assert b is None, path
    else:
        x = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        y = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert x.shape == y.shape, path
        np.testing.assert_array_equal(x, y, err_msg=path)


def test_checkpoint_round_trip(setup, tmp_path):
    """JAX ``save_checkpoint`` -> port ``load_checkpoint`` equals
    ``convert.py`` of the in-memory trees; port ``save_checkpoint`` ->
    JAX ``load_checkpoint`` gives JAX's arrays back."""
    jp, js, jint = setup["jp"], setup["js"], setup["jint"]
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    JCK.save_checkpoint(jdir, params=jp, family="bert", cfg=setup["jcfg"],
                        qstate=js, int_params=jint, extra={"task": "rte"})
    ck = TCK.load_checkpoint(jdir, device="cpu")
    assert ck["family"] == "bert" and ck["cfg"] == setup["tcfg"]
    assert ck["extra"] == {"task": "rte"}
    _equal_trees(ck["params"], C.params_from_jax(_np(jp), device="cpu"))
    _equal_trees(ck["qstate"], C.qstate_from_jax(_np(js), device="cpu"))
    _equal_trees(ck["int_params"], C.int_params_from_jax(_np(jint),
                                                         device="cpu"))
    TCK.save_checkpoint(tdir, params=ck["params"], family="bert",
                        cfg=ck["cfg"], qstate=ck["qstate"],
                        int_params=ck["int_params"], extra=ck["extra"])
    with open(f"{tdir}/manifest.json") as f:
        manifest = json.load(f)
    assert manifest["config_cls"] == "BertConfig"
    back = JCK.load_checkpoint(tdir)
    assert back["cfg"] == setup["jcfg"]
    _equal_trees(back["params"], _np(jp))
    _equal_trees(back["qstate"], _np(js))
    _equal_trees(back["int_params"], _np(jint))
