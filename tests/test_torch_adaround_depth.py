"""An AdaRound-deployed BERT at BERT-base depth (12 layers; H=256 as the
wide config of tests/test_torch_bert_engine.py, seq 32, 16 sequences)
through the JAX package and the port: 4-bit symmetric weights with
alphas packed as int8 storage of their levels, post_adaround 8-bit
asymmetric act ranges estimated by JAX with the alphas applied.

Two states share one set of JAX programs: ``nearest`` (every alpha at its
init, whose hard decisions are round-to-nearest, ties aside, checked) and
``alphas``
(the linear sites' init alphas moved by seeded noise, as learned
rounding moves them; the tables and LayerNorm gammas keep their init
alphas, since the JAX engine deploys those at nearest).

What is held, each case:
- the port's engine is no further from the JAX engine than the JAX
  engine is from the JAX generic int path (the parity contract's depth
  rule; rtol 1e-3 / atol 2e-3 is not met by any two int8 routes at 12
  layers);
- the rule ``chip_smoke.py`` phase 14 gates on the card, here on JAX's
  own routes and on the port's: the engine's gaps to the fake-quant
  forward and to the generic int path are at most ``ROUTE_RATIO`` times
  the generic int path's gap to the fake-quant forward, and the
  ``alphas`` state's gaps at most ``ROUTE_RATIO`` times the ``nearest``
  state's.
``pytest -s`` prints every gap in levels of the classifier.out grid.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_quantization_tpu.models import bert as JB
from transformer_quantization_tpu.quant import quantizers as JQ
from transformer_quantization_tpu.quant.manager import init_weight_qstate
from transformer_quantization_tpu.quant.qconfig import Phase, QuantDefaults
from transformer_quantization_tpu.quant.qconfig import QuantMode as JMode
from transformer_quantization_tpu.quant.quantizers import QMethod
from transformer_quantization_tpu.quant.ranges import RangeMethod
from transformer_quantization_tpu_torch import convert as C
from transformer_quantization_tpu_torch.models import bert as TB
from transformer_quantization_tpu_torch.quant import quantizers as TQ
from transformer_quantization_tpu_torch.quant.qconfig import QuantMode
from transformer_quantization_tpu_torch.training import calibration as TC

torch.set_num_threads(2)

KW = dict(vocab_size=512, hidden_size=256, num_hidden_layers=12,
          num_attention_heads=4, intermediate_size=1024,
          max_position_embeddings=64, num_labels=2)
SEQ, N = 32, 16
# the largest ratio between two route gaps of one model, and between the
# alphas state's gap and the nearest state's; chip_smoke.py's
# ROUTE_RATIO holds the card's routes to the same number
ROUTE_RATIO = 2.0
NOISE = 1.0


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(rng, n):
    return {"input_ids": rng.randint(0, KW["vocab_size"], (n, SEQ)).astype(
                np.int32),
            "attention_mask": (np.arange(SEQ)[None, :]
                               < rng.randint(SEQ // 2, SEQ + 1, (n, 1))
                               ).astype(np.float32),
            "token_type_ids": np.zeros((n, SEQ), np.int32)}


@pytest.fixture(scope="module")
def routes():
    jcfg, tcfg = JB.BertConfig(**KW), TB.BertConfig(**KW)
    # the port's random init (seeded), carried to JAX as is
    tp = TB.init_bert_params(tcfg, seed=0, device="cpu")
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tp)
    jq = JB.declare_bert_sites(QuantDefaults(
        method=QMethod.symmetric_uniform,
        act_method=QMethod.asymmetric_uniform, n_bits=4, n_bits_act=8,
        weight_range_method=RangeMethod.current_minmax,
        act_range_method=RangeMethod.current_minmax), jcfg)
    tq = TB.declare_bert_sites(dataclasses.replace(
        TC.w8a8_defaults(), n_bits=4, n_bits_act=8), tcfg)
    js0 = jax.jit(lambda p: init_weight_qstate(
        jq, JB.bert_weight_site_tensors(p)))(jp)
    specs = JB.bert_adaround_specs(jp, jcfg)
    cal = {k: jnp.asarray(v)
           for k, v in _batch(np.random.RandomState(2), N).items()}
    ev = _batch(np.random.RandomState(1), N)
    jev = {k: jnp.asarray(v) for k, v in ev.items()}

    # the fake-quant programs run the layers as one lax.scan (the same ops
    # in the same order as the unrolled loop; one layer body to trace)
    calibrate = jax.jit(lambda s: JB.bert_apply(
        jp, cal, jcfg, jq, s, JMode(act_phase=Phase.estimate),
        scan_layers=True)[1])
    generic = jax.jit(lambda s, ip: JB.bert_apply(
        jp, jev, jcfg, jq, s, JMode(), int_params=ip)[0]["logits"])
    fake = jax.jit(lambda s: JB.bert_apply(jp, jev, jcfg, jq, s, JMode(),
                                           scan_layers=True)[0]["logits"])
    engines = {}
    ts0 = C.qstate_from_jax(_np(js0), device="cpu")
    tt = TB.bert_weight_site_tensors(tp)
    # the port's init alphas (bit for bit JAX's, tests/test_torch_adaround.py);
    # their hard decisions are round-to-nearest but at an exact half, which
    # they round up where nearest rounds to even
    init_alpha, ties = {}, 0
    for name, _ in specs:
        c, qp, w = tq[name + ".w"], ts0[name + ".w"]["qp"], tt[name + ".w"]
        a = TQ.adaround_init_alpha(TQ.AdaRoundMode.learned_hard_sigmoid,
                                   c.spec, qp, w)
        off = TQ.adaround_fake_quant(TQ.AdaRoundMode.learned_hard_sigmoid,
                                     c.spec, qp, w, a, soft=False) \
            != TQ.fake_quant(c.spec, qp, w)
        x = w / TQ.scale_of(c.spec, qp)
        assert bool((x[off] - torch.floor(x[off]) == 0.5).all()), name
        ties += int(off.sum())
        init_alpha[name + ".w"] = a.numpy()
    rng = np.random.RandomState(5)
    out = {}
    for case, noise in (("nearest", 0.0), ("alphas", NOISE)):
        js = dict(js0)
        for name, spec in specs:
            s = name + ".w"
            a = init_alpha[s]
            if spec["kind"] == "linear":
                a = a + noise * rng.randn(*a.shape).astype(np.float32)
            js[s] = dict(js[s], alpha=jnp.asarray(a))
        js = calibrate(js)
        jint = JB.build_bert_int_params(jp, jq, js, use_int4=True)
        jst, jplan, _ = JB.build_bert_engine(jp, jcfg, jq, js,
                                             int_params=jint)
        if jst not in engines:
            engines[jst] = jax.jit(lambda s, plan, ip, _st=jst:
                                   JB.bert_engine_apply(
                                       jp, jev, jcfg, jq, s, _st, plan, ip,
                                       backend="xla")["logits"])
        ts = C.qstate_from_jax(_np(js), device="cpu")
        tst, tplan, tint = TB.build_bert_engine(tp, tcfg, tq, ts,
                                                device="cpu")
        with torch.no_grad():
            t_gen = TB.bert_apply(tp, ev, tcfg, tq, ts, QuantMode(),
                                  int_params=tint, device="cpu")[0]["logits"]
            t_fq = TB.bert_apply(tp, ev, tcfg, tq, ts, QuantMode(),
                                 device="cpu")[0]["logits"]
        near = {k: dict(v, alpha=None) if "alpha" in v else v
                for k, v in ts.items()}
        out[case] = dict(
            j_eng=np.asarray(engines[jst](js, jplan, jint)),
            j_gen=np.asarray(generic(js, jint)),
            j_fq=np.asarray(fake(js)),
            t_eng=TB.bert_engine_apply(tp, ev, tcfg, tq, ts, tst, tplan, tint,
                                       device="cpu")["logits"].numpy(),
            t_gen=t_gen.numpy(), t_fq=t_fq.numpy(),
            step=float(JQ.scale_of(jq["classifier.out"].spec,
                                   js["classifier.out"]["qp"])),
            ties=ties, flips=sum(int((tint[n]["w_int"] != p["w_int"]).sum())
                      for n, p in TB.build_bert_int_params(
                          tp, tq, near).items() if "w_int" in p))
    return out


def _gaps(r, side):
    e, g, f = (r[f"{side}_{k}"] for k in ("eng", "gen", "fq"))
    return {"engine-fq": float(np.abs(e - f).max()),
            "generic-fq": float(np.abs(g - f).max()),
            "engine-generic": float(np.abs(e - g).max())}


def _show(tag, r, side, step):
    e, g, f = (r[f"{side}_{k}"] for k in ("eng", "gen", "fq"))
    return f"{tag}: " + ", ".join(
        f"{k} {np.abs(a - b).max() / step:.1f} levels "
        f"({(np.abs(a - b) / step > 0.5).mean():.2f} off)"
        for k, a, b in (("engine-fq", e, f), ("generic-fq", g, f),
                        ("engine-generic", e, g)))


@pytest.mark.parametrize("case", ("nearest", "alphas"))
def test_engine_at_full_depth_stays_within_jax_route_gap(routes, case):
    r = routes[case]
    step = r["step"]
    port_gap = float(np.abs(r["t_eng"] - r["j_eng"]).max())
    jax_gap = float(np.abs(r["j_gen"] - r["j_eng"]).max())
    jg, tg = _gaps(r, "j"), _gaps(r, "t")
    print(f"\n12 layers, H=256, {case}: max |port engine - JAX engine| "
          f"{port_gap / step:.1f} levels, JAX engine-generic "
          f"{jax_gap / step:.1f}; {_show('JAX', r, 'j', step)}; "
          f"{_show('port', r, 't', step)}; hard decisions off nearest "
          f"{r['flips']}; logit scale {float(np.abs(r['j_fq']).max()):.4e},"
          f" step {step:.4e}")
    assert np.isfinite(r["t_eng"]).all() and r["t_eng"].shape == (N, 2)
    assert port_gap <= jax_gap
    if case == "nearest":
        assert r["flips"] == r["ties"]
    else:
        assert r["flips"] > 100 * r["ties"]
    for gaps in (jg, tg):
        assert gaps["engine-fq"] <= ROUTE_RATIO * gaps["generic-fq"]
        assert gaps["engine-generic"] <= ROUTE_RATIO * gaps["generic-fq"]
    if case == "alphas":
        for side, gaps in (("j", jg), ("t", tg)):
            base = _gaps(routes["nearest"], side)
            for k, v in gaps.items():
                assert v <= ROUTE_RATIO * base[k], (side, k)
