"""Port parity: the quant core and int8 packing against the JAX package.

The same numpy inputs (from a seed) go through the JAX function and its
counterpart in ``transformer_quantization_tpu_torch`` on the CPU. The
grid arithmetic is the same float32 operations in the same order, so the
results must be equal bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_quantization_tpu.ops import int_linear as JIL
from transformer_quantization_tpu.quant import qconfig as JQC
from transformer_quantization_tpu.quant import quantizers as JQ
from transformer_quantization_tpu.quant import ranges as JR
from transformer_quantization_tpu.quant.manager import QuantCtx as JCtx
from transformer_quantization_tpu_torch.ops import int_linear as TIL
from transformer_quantization_tpu_torch.quant import qconfig as TQC
from transformer_quantization_tpu_torch.quant import quantizers as TQ
from transformer_quantization_tpu_torch.quant import manager as TM
from transformer_quantization_tpu_torch.quant import ranges as TR
from transformer_quantization_tpu_torch.quant.manager import QuantCtx as TCtx

torch.set_num_threads(2)

SPECS = {
    "asym8": (JQ.QuantizerSpec(8, JQ.QMethod.asymmetric_uniform),
              TQ.QuantizerSpec(8, TQ.QMethod.asymmetric_uniform)),
    "sym8": (JQ.QuantizerSpec(8, JQ.QMethod.symmetric_uniform),
             TQ.QuantizerSpec(8, TQ.QMethod.symmetric_uniform)),
    "asym4": (JQ.QuantizerSpec(4, JQ.QMethod.asymmetric_uniform),
              TQ.QuantizerSpec(4, TQ.QMethod.asymmetric_uniform)),
    "sym4_log": (JQ.QuantizerSpec(4, JQ.QMethod.symmetric_uniform, "log"),
                 TQ.QuantizerSpec(4, TQ.QMethod.symmetric_uniform, "log")),
    "asym16": (JQ.QuantizerSpec(16, JQ.QMethod.asymmetric_uniform),
               TQ.QuantizerSpec(16, TQ.QMethod.asymmetric_uniform)),
}


def _x(seed, shape=(6, 5, 8), scale=1.5, shift=0.0):
    return (np.random.RandomState(seed).randn(*shape) * scale
            + shift).astype(np.float32)


def _eq(jax_val, torch_val):
    np.testing.assert_array_equal(np.asarray(jax_val),
                                  torch_val.detach().cpu().numpy())


def _close_log_domain(js, jqp, jval, tval):
    """Log-domain scales go through exp, which differs by ulps between
    XLA and torch: values agree to float32 precision or, where a rounding
    sits on a tie, by at most one grid level."""
    tol = float(np.asarray(JQ.scale_of(js, jqp)).max())
    np.testing.assert_allclose(tval.numpy(), np.asarray(jval), rtol=1e-6,
                               atol=tol * 1.000001)


def _tqp(jqp):
    return TQ.QuantParams(delta=torch.from_numpy(np.array(jqp.delta)),
                          zero_float=torch.from_numpy(np.array(jqp.zero_float)),
                          signed=torch.from_numpy(np.array(jqp.signed)))


@pytest.mark.parametrize("spec", sorted(SPECS))
@pytest.mark.parametrize("shift", [0.0, 2.0, -2.0])
def test_set_quant_range_and_fake_quant(spec, shift):
    js, ts = SPECS[spec]
    x = _x(0, shift=shift)
    jqp = JQ.set_quant_range(js, x.min(), x.max())
    tqp = TQ.set_quant_range(ts, torch.tensor(x.min()), torch.tensor(x.max()))
    check = (_eq if js.scale_domain == "linear" else
             lambda a, b: _close_log_domain(js, jqp, a, b))
    for f in ("delta", "zero_float", "signed"):
        check(getattr(jqp, f), getattr(tqp, f))
    check(JQ.scale_of(js, jqp), TQ.scale_of(ts, tqp))
    _eq(JQ.zero_point_of(js, jqp), TQ.zero_point_of(ts, tqp))
    xt = torch.from_numpy(x)
    tqp = _tqp(jqp)  # from here on, the same stored params on both sides
    if js.scale_domain == "linear":
        _eq(JQ.to_int(js, jqp, x), TQ.to_int(ts, tqp, xt))
    check(JQ.fake_quant(js, jqp, x), TQ.fake_quant(ts, tqp, xt))
    lo_j, hi_j = JQ.int_min_max(js, jqp.signed)
    lo_t, hi_t = TQ.int_min_max(ts, tqp.signed)
    _eq(lo_j, lo_t)
    _eq(hi_j, hi_t)


@pytest.mark.parametrize("spec", ["asym8", "sym8"])
def test_per_channel_fake_quant(spec):
    js, ts = SPECS[spec]
    w = _x(1, (7, 12), scale=0.05)
    rs_j, rs_t = JR.ReduceSpec(per_channel=True), TR.ReduceSpec(per_channel=True)
    jm, jM = JR.reduce_min_max(w, rs_j)
    tm, tM = TR.reduce_min_max(torch.from_numpy(w), rs_t)
    _eq(jm, tm)
    _eq(jM, tM)
    jqp, tqp = JQ.set_quant_range(js, jm, jM), TQ.set_quant_range(ts, tm, tM)
    _eq(JQ.fake_quant(js, jqp, w, axis=0),
        TQ.fake_quant(ts, tqp, torch.from_numpy(w), axis=0))


def test_bf16_input_fake_quant_round_trips_dtype():
    js, ts = SPECS["asym8"]
    x = _x(2)
    jqp = JQ.set_quant_range(js, x.min(), x.max())
    tqp = _tqp(jqp)
    jy = JQ.fake_quant(js, jqp, jnp.asarray(x, jnp.bfloat16))
    ty = TQ.fake_quant(ts, tqp, torch.from_numpy(x).to(torch.bfloat16))
    assert ty.dtype == torch.bfloat16
    np.testing.assert_array_equal(np.asarray(jy.astype(jnp.float32)),
                                  ty.to(torch.float32).numpy())


@pytest.mark.parametrize("rs", [{}, {"per_channel": True}, {"axis": 1},
                                {"axis": 2}], ids=["tensor", "channel",
                                                   "axis1", "axis2"])
def test_current_minmax_update(rs):
    x = _x(3)
    jcfg = JR.RangeEstimatorConfig(method=JR.RangeMethod.current_minmax)
    tcfg = TR.RangeEstimatorConfig(method=TR.RangeMethod.current_minmax)
    shape = (() if not rs else (x.shape[0],) if rs.get("per_channel")
             else (x.shape[rs["axis"]],))
    jst = JR.init_range_state(shape)
    tst = TR.init_range_state(shape)
    for seed in (3, 4):  # current minmax: the last batch wins
        x = _x(seed)
        jst = JR.update_range_state(jst, x, jcfg, JR.ReduceSpec(**rs))
        tst = TR.update_range_state(tst, torch.from_numpy(x), tcfg,
                                    TR.ReduceSpec(**rs))
    for a, b in zip(JR.finalize_ranges(jst), TR.finalize_ranges(tst)):
        _eq(a, b)


def test_unported_estimators_raise():
    """What raised here before now computes: the ``learn`` phase of
    weight and act sites; the estimators (all-minmax, running-minmax,
    percentile), which match JAX on the same input; and a weight site
    with an AdaRound ``alpha``, which quantizes with its hard decisions as
    JAX's does (bit for bit)."""
    x = _x(5)
    jst, tst = JR.init_range_state(()), TR.init_range_state(())
    for m in ("running_minmax", "allminmax"):
        jc = JR.RangeEstimatorConfig(method=JR.RangeMethod[m])
        tc = TR.RangeEstimatorConfig(method=TR.RangeMethod[m])
        for a, b in zip(JR.update_range_state(jst, x, jc, JR.ReduceSpec())
                        .values(),
                        TR.update_range_state(tst, torch.from_numpy(x), tc,
                                              TR.ReduceSpec()).values()):
            _eq(a, b)
    for a, b in zip(JR.reduce_min_max(x, JR.ReduceSpec(), percentile=1.0),
                    TR.reduce_min_max(torch.from_numpy(x), TR.ReduceSpec(),
                                      percentile=1.0)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)
    b = TQC.QuantConfigBuilder(_w8a8(TQC))
    b.weight("lin.w")
    b.act("lin.out")
    cfg = b.build()
    w, xt = torch.from_numpy(_x(6, (5, 8))), torch.from_numpy(x)
    # the learn phase (QAT) computes: it quantizes with the stored params,
    # so on a calibrated state it equals the fix phase
    learn = TQC.Phase.learn
    cal = TCtx(cfg, {"lin.w": TM.init_weight_site_state(cfg["lin.w"], w)},
               TQC.QuantMode(act_phase=TQC.Phase.estimate))
    cal.act("lin.out", xt)
    st = cal.export()
    for phase_kw in ({"act_phase": learn}, {"weight_phase": learn}):
        got = TCtx(cfg, st, TQC.QuantMode(**phase_kw))
        want = TCtx(cfg, st, TQC.QuantMode())
        assert torch.equal(got.act("lin.out", xt), want.act("lin.out", xt))
        assert torch.equal(got.weight("lin.w", w), want.weight("lin.w", w))
    qs = {"lin.w": dict(TM.init_weight_site_state(cfg["lin.w"], w),
                        alpha=torch.from_numpy(_x(7, (5, 8))))}
    got = TCtx(cfg, qs, TQC.QuantMode()).weight("lin.w", w)
    jb = JQC.QuantConfigBuilder(_w8a8(JQC))
    jb.weight("lin.w")
    jqs = {"lin.w": {"qp": JQ.QuantParams(
        delta=qs["lin.w"]["qp"].delta.numpy(),
        zero_float=qs["lin.w"]["qp"].zero_float.numpy(),
        signed=qs["lin.w"]["qp"].signed.numpy()),
        "alpha": jnp.asarray(qs["lin.w"]["alpha"].numpy())}}
    want = JCtx(jb.build(), jqs, JQC.QuantMode()).weight(
        "lin.w", jnp.asarray(w.numpy()))
    _eq(want, got)
    assert not torch.equal(got, TCtx(cfg, st, TQC.QuantMode()).weight(
        "lin.w", w))


def _w8a8(q, **over):
    """The W8A8 defaults in qconfig module ``q`` (JAX's or the port's)."""
    return q.QuantDefaults(method=q.QMethod.symmetric_uniform,
                           act_method=q.QMethod.asymmetric_uniform,
                           weight_range_method=q.RangeMethod.current_minmax,
                           act_range_method=q.RangeMethod.current_minmax,
                           **over)


@pytest.mark.parametrize("per_channel", [False, True])
def test_quant_ctx_estimate_then_fix(per_channel):
    """Weight and act sites through QuantCtx: estimate then fix."""
    def build(q):
        b = q.QuantConfigBuilder(_w8a8(q, per_channel_weights=per_channel))
        b.weight("lin.w")
        b.act("lin.out")
        return b.build()

    jcfg, tcfg = build(JQC), build(TQC)
    w, x = _x(6, (5, 8), 0.1), _x(7, (3, 5), 1.0, 0.5)
    jctx = JCtx(jcfg, {}, JQC.QuantMode(weight_phase=JQC.Phase.estimate,
                                        act_phase=JQC.Phase.estimate))
    tctx = TCtx(tcfg, {}, TQC.QuantMode(weight_phase=TQC.Phase.estimate,
                                        act_phase=TQC.Phase.estimate))
    _eq(jctx.weight("lin.w", w), tctx.weight("lin.w", torch.from_numpy(w)))
    _eq(jctx.act("lin.out", x), tctx.act("lin.out", torch.from_numpy(x)))
    js, ts = jctx.export(), tctx.export()
    for site in ("lin.w", "lin.out"):
        _eq(js[site]["qp"].delta, ts[site]["qp"].delta)
        _eq(js[site]["qp"].zero_float, ts[site]["qp"].zero_float)
    fixed = TCtx(tcfg, ts, TQC.QuantMode())
    x2 = _x(8, (3, 5), 2.0)
    _eq(JCtx(jcfg, js, JQC.QuantMode()).act("lin.out", x2),
        fixed.act("lin.out", torch.from_numpy(x2)))


@pytest.mark.parametrize("per_channel", [False, True])
def test_pack_weight_and_int8_linear(per_channel):
    js, ts = SPECS["sym8"]
    w = _x(9, (6, 16), 0.05)
    rs = dict(per_channel=per_channel)
    jm, jM = JR.reduce_min_max(w, JR.ReduceSpec(**rs))
    jqp = JQ.set_quant_range(js, jm, jM)
    tqp = _tqp(jqp)
    jp = JIL.pack_weight_int8(js, jqp, w)
    tp = TIL.pack_weight_int8(ts, tqp, torch.from_numpy(w))
    for k in ("w_int", "scale", "colsum"):
        _eq(jp[k], tp[k])
    _eq(JIL.dequantize_packed_weight(jp), TIL.dequantize_packed_weight(tp))
    a_js, a_ts = SPECS["asym8"]
    x = _x(10, (4, 3, 16), 1.0, 0.3)
    aqp = JQ.set_quant_range(a_js, x.min(), x.max())
    jx8, jsx, jsh = JIL.quantize_activation_int8(a_js, aqp, x)
    tx8, tsx, tsh = TIL.quantize_activation_int8(a_ts, _tqp(aqp),
                                                 torch.from_numpy(x))
    _eq(jx8, tx8)
    _eq(jsh, tsh)
    b = _x(11, (6,), 0.1)
    _eq(JIL.int8_linear(jx8, jsx, jsh, jp, b),
        TIL.int8_linear(tx8, tsx, tsh, tp, torch.from_numpy(b)))


def test_exact_int_matmul_wide_contraction_is_exact():
    """K=3072 (float64 route) and K=768 (float32 route) against int64."""
    rng = np.random.RandomState(12)
    for k in (768, 3072):
        a = rng.randint(-128, 128, (9, k)).astype(np.int8)
        b = rng.randint(-128, 128, (5, k)).astype(np.int8)
        want = a.astype(np.int64) @ b.astype(np.int64).T
        got = TIL.exact_int_matmul(torch.from_numpy(a), torch.from_numpy(b))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_embedding_pack_and_lookup():
    js, ts = SPECS["sym8"]
    table = _x(13, (20, 8), 0.02)
    jqp = JQ.set_quant_range(js, table.min(), table.max())
    jp = JIL.pack_embedding_int8(js, jqp, table)
    tp = TIL.pack_embedding_int8(ts, _tqp(jqp), torch.from_numpy(table))
    for k in ("t_int", "scale", "zp"):
        _eq(jp[k], tp[k])
    ids = np.random.RandomState(14).randint(0, 20, (3, 7))
    _eq(JIL.int8_embedding_lookup(jnp.asarray(ids), jp),
        TIL.int8_embedding_lookup(torch.from_numpy(ids), tp))
