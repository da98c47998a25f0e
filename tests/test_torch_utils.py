"""The port's utilities against the JAX package's: ``--double``'s float64
ranges, ``utils/telemetry.py`` (range summary and residual histograms
through ``TBWriter``'s JSONL fallback), ``utils/profiling.py`` and
``utils/misc.py``.

The model is a tiny BERT (2 layers, H = 64, seq 32) from the port's seeded
init, carried to JAX as is; batches are drawn with numpy from a seed.

Tolerances:
- ``--double``: float64 weights through one W8A8 current-minmax estimate
  pass in both packages (JAX with ``jax_enable_x64``, restored after):
  weight-site params float64 in both and equal to 1e-12 relative; act-site
  params float32 in both (their range state is float32 in JAX) and within
  rtol 1e-5; ``set_quant_range`` keeps float32 inputs float32.
- telemetry: the JSONL lines equal JAX's in order, type, tag and step;
  scalars within rtol 1e-5; histogram edges within rtol 1e-5 and bin
  counts equal (the captures agree to float32 rounding).
- ``PhaseTimer.report`` equal to JAX's for the same totals; ``trace``
  writes a Chrome trace; the misc helpers equal JAX's.
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_training_options import _jax_qstate
from transformer_quantization_tpu.models import bert as JB
from transformer_quantization_tpu.quant import quantizers as JQ
from transformer_quantization_tpu.quant.manager import init_weight_qstate
from transformer_quantization_tpu.quant.qconfig import Phase
from transformer_quantization_tpu.quant.qconfig import QuantMode as JMode
from transformer_quantization_tpu.utils import misc as JM
from transformer_quantization_tpu.utils import profiling as JP
from transformer_quantization_tpu.utils import telemetry as JTel
from transformer_quantization_tpu_torch.models import bert as TB
from transformer_quantization_tpu_torch.quant import quantizers as TQ
from transformer_quantization_tpu_torch.quant.qconfig import Phase as TPhase
from transformer_quantization_tpu_torch.quant.qconfig import QuantMode
from transformer_quantization_tpu_torch.training import calibration as TC
from transformer_quantization_tpu_torch.utils import misc as TM
from transformer_quantization_tpu_torch.utils import profiling as TP
from transformer_quantization_tpu_torch.utils import telemetry as TTel

torch.set_num_threads(2)

KW = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
          num_attention_heads=4, intermediate_size=128,
          max_position_embeddings=64, num_labels=2, hidden_dropout_prob=0.0,
          attention_probs_dropout_prob=0.0)
SEQ, B = 32, 4


def _np(tree):
    return jax.tree.map(np.array, tree)


def _batch(seed, n=B):
    rng = np.random.RandomState(seed)
    return {"input_ids": rng.randint(4, KW["vocab_size"], (n, SEQ)).astype(
                np.int32),
            "attention_mask": (np.arange(SEQ)[None, :]
                               < rng.randint(SEQ // 2, SEQ + 1, (n, 1))
                               ).astype(np.float32),
            "token_type_ids": np.zeros((n, SEQ), np.int32)}


def _jax_defaults():
    from transformer_quantization_tpu.quant.qconfig import QuantDefaults
    from transformer_quantization_tpu.quant.ranges import RangeMethod

    return QuantDefaults(method=JQ.QMethod.symmetric_uniform,
                         act_method=JQ.QMethod.asymmetric_uniform, n_bits=8,
                         n_bits_act=8,
                         weight_range_method=RangeMethod.current_minmax,
                         act_range_method=RangeMethod.current_minmax)


def _estimate(dtype):
    """One estimate pass from the weight sites in both packages, with the
    weights in ``dtype``: ``(jax qcfg, jax qstate, port qcfg, port qstate,
    port params)``."""
    jcfg, tcfg = JB.BertConfig(**KW), TB.BertConfig(**KW)
    tp = TB.params_to(TB.init_bert_params(tcfg, seed=0, device="cpu"),
                      dtype=dtype)
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tp)
    jq = JB.declare_bert_sites(_jax_defaults(), jcfg)
    tq = TB.declare_bert_sites(TC.w8a8_defaults(), tcfg)
    b = _batch(1)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    js = jax.jit(lambda p: JB.bert_apply(
        p, jb, jcfg, jq, init_weight_qstate(jq, JB.bert_weight_site_tensors(
            p)), JMode(act_phase=Phase.estimate))[1])(jp)
    from transformer_quantization_tpu_torch.quant.manager import (
        init_weight_qstate as t_init,
    )

    ts0 = t_init(tq, TB.bert_weight_site_tensors(tp))
    _, ts = TB.bert_apply(tp, b, tcfg, tq, ts0,
                          QuantMode(act_phase=TPhase.estimate), device="cpu")
    return jq, _np(js), tq, ts, tp


def test_double_ranges_are_float64_and_match_jax_x64():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        jq, js, tq, ts, _ = _estimate(torch.float64)
    finally:
        jax.config.update("jax_enable_x64", prev)
    n_weight = 0
    for site, c in tq.items():
        got, want = ts[site]["qp"], js[site]["qp"]
        if c.kind == "weight":
            n_weight += 1
            assert got.delta.dtype == torch.float64, site
            assert want.delta.dtype == np.float64, site
            np.testing.assert_allclose(got.delta.numpy(), want.delta,
                                       rtol=1e-12, err_msg=site)
        else:
            assert got.delta.dtype == torch.float32, site
            assert want.delta.dtype == np.float32, site
            np.testing.assert_allclose(got.delta.numpy(), want.delta,
                                       rtol=1e-5, err_msg=site)
            np.testing.assert_allclose(got.zero_float.numpy(),
                                       want.zero_float, rtol=1e-5,
                                       atol=1e-4, err_msg=site)
    assert n_weight > 10
    spec = TQ.QuantizerSpec(n_bits=8, method=TQ.QMethod.symmetric_uniform)
    qp32 = TQ.set_quant_range(spec, torch.tensor(-1.0), torch.tensor(2.0))
    qp64 = TQ.set_quant_range(spec, torch.tensor(-1.0, dtype=torch.float64),
                              torch.tensor(2.0, dtype=torch.float64))
    assert qp32.delta.dtype == torch.float32
    assert qp64.delta.dtype == torch.float64
    assert qp64.signed.dtype == torch.float32
    assert float(qp64.delta) == 2.0 / 127


@pytest.fixture(scope="module")
def calibrated():
    """The port's random BERT calibrated by the port (W8A8 current-minmax,
    one batch), and the same params and ranges in JAX's trees."""
    tcfg = TB.BertConfig(**KW)
    tp = TB.init_bert_params(tcfg, seed=0, device="cpu")
    _, tq, ts = TC.calibrated_bert(tcfg, batch_size=2, seq=SEQ, seed=1,
                                   device="cpu", params=tp)
    return dict(jq=JB.declare_bert_sites(_jax_defaults(),
                                         JB.BertConfig(**KW)),
                js=_jax_qstate(ts), tq=tq, ts=ts, tp=tp,
                jp=jax.tree.map(lambda t: jnp.asarray(t.numpy()), tp))


def _jsonl_both(tmp_path, write):
    """Run ``write(jax_writer, port_writer)`` with both packages'
    ``TBWriter`` on their JSONL fallback; returns both files' records."""
    saved = sys.modules.get("torch.utils.tensorboard", None)
    sys.modules["torch.utils.tensorboard"] = None  # the import raises
    try:
        jw = JTel.TBWriter(str(tmp_path / "jax"))
        tw = TTel.TBWriter(str(tmp_path / "torch"))
    finally:
        if saved is None:
            del sys.modules["torch.utils.tensorboard"]
        else:
            sys.modules["torch.utils.tensorboard"] = saved
    assert jw._tb is None and tw._tb is None
    write(jw, tw)
    jw.close()
    tw.close()
    out = []
    for side in ("jax", "torch"):
        with open(tmp_path / side / "events.jsonl") as f:
            out.append([json.loads(line) for line in f])
    return out


def _same_records(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g["type"], g["tag"], g["step"]) == (w["type"], w["tag"],
                                                   w["step"])
        if g["type"] == "scalar":
            np.testing.assert_allclose(g["value"], w["value"], rtol=1e-5,
                                       atol=1e-12, err_msg=g["tag"])
        else:
            np.testing.assert_allclose([g["hist"]["lo"], g["hist"]["hi"]],
                                       [w["hist"]["lo"], w["hist"]["hi"]],
                                       rtol=1e-5, err_msg=g["tag"])
            assert g["hist"]["counts"] == w["hist"]["counts"], g["tag"]


def test_range_summary_matches_jax(calibrated, tmp_path):
    c = calibrated
    got = TTel.range_summary(c["tq"], c["ts"])
    want = JTel.range_summary(c["jq"], c["js"])
    assert set(got) == set(want)
    for site in want:
        for k in ("kind", "n_bits", "enabled", "symmetric",
                  "per_channel_shape", "has_alpha"):
            assert got[site][k] == want[site][k], (site, k)
        for k in ("x_min", "x_max", "delta"):
            np.testing.assert_allclose(got[site][k], want[site][k],
                                       rtol=1e-6, err_msg=f"{site}.{k}")
    jrec, trec = _jsonl_both(tmp_path, lambda jw, tw: (
        jw.write_range_summary(c["jq"], c["js"]),
        tw.write_range_summary(c["tq"], c["ts"])))
    _same_records(trec, jrec)


def test_residual_histograms_match_jax(calibrated, tmp_path):
    """One capture forward at fixed ranges; per-site and per-token
    histograms of every ``*.res`` site; the clip fraction beside them."""
    c = calibrated
    b = _batch(2, n=2)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    cfg_j, cfg_t = JB.BertConfig(**KW), TB.BertConfig(**KW)

    def japply(p, batch, qcfg=None, qstate=None, mode=None,
               capture_sites=None):
        return jax.jit(lambda p, b, s: JB.bert_apply(
            p, b, cfg_j, qcfg, s, mode, capture_sites=capture_sites))(
                p, batch, qstate)

    def tapply(p, batch, **kw):
        return TB.bert_apply(p, batch, cfg_t, device="cpu", **kw)

    written = []
    jrec, trec = _jsonl_both(tmp_path, lambda jw, tw: written.extend([
        JTel.write_residual_histograms(japply, c["jp"], c["jq"], c["js"], jb,
                                       jw, step=3, mode=JMode()),
        TTel.write_residual_histograms(tapply, c["tp"], c["tq"], c["ts"], b,
                                       tw, step=3, mode=QuantMode())]))
    assert written[0] == written[1] == TTel.residual_sites(c["tq"])
    assert len(written[1]) == 2 * KW["num_hidden_layers"]
    _same_records(trec, jrec)
    sites = ["L0.attn_out.res", "L1.ffn.ln"]
    got = TTel.activation_report(tapply, c["tp"], c["tq"], c["ts"], b,
                                 sites, mode=QuantMode())
    want = JTel.activation_report(japply, c["jp"], c["jq"], c["js"], jb,
                                  sites, mode=JMode())
    assert set(got) == set(want) == set(sites)
    for s in sites:
        assert got[s]["shape"] == want[s]["shape"]
        assert got[s]["hist"]["counts"] == want[s]["hist"]["counts"]
        np.testing.assert_allclose(got[s]["clipped_fraction"],
                                   want[s]["clipped_fraction"], rtol=1e-6)
        np.testing.assert_allclose(got[s]["per_token_max_abs"],
                                   want[s]["per_token_max_abs"], rtol=1e-5)


def test_phase_timer_report_matches_jax():
    totals = {"calibration": 12.345, "eval": 1.5, "train": 100.0}
    counts = {"calibration": 1, "eval": 3, "train": 1}
    reports = []
    for mod in (JP, TP):
        t = mod.PhaseTimer()
        t._totals, t._counts = dict(totals), dict(counts)
        reports.append(t.report())
    assert reports[0] == reports[1]
    assert reports[1].splitlines()[0] == f"{'train':24s} {100.0:8.2f}s  x1"
    t = TP.PhaseTimer()
    with t.phase("a"):
        torch.ones(4).sum()
    with t.phase("a"):
        pass
    assert list(t.totals()) == ["a"] and t._counts["a"] == 2


def test_trace_writes_a_chrome_trace(tmp_path):
    with TP.trace(str(tmp_path / "prof")):
        with TP.annotate("region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "prof" / TP.TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "region" for e in events)
    with TP.trace(None):  # no directory: a no-op
        pass


def test_misc_matches_jax():
    rng = np.random.RandomState(0)
    tree = {"embeddings": {"word": rng.normal(size=(7, 3)).astype(
                np.float32)},
            "layers": [{"w": rng.randint(-8, 8, (5, 2)).astype(np.int8)}],
            "b": np.zeros((4,), np.float32)}
    ttree = jax.tree.map(torch.from_numpy, tree)
    assert TM.count_params(ttree) == JM.count_params(tree) == 21 + 10 + 4
    assert (TM.count_embedding_params(ttree)
            == JM.count_embedding_params(tree) == 21)
    assert TM.tree_size_bytes(ttree) == JM.tree_size_bytes(tree) == {
        "float32": 100, "int8": 10}
    d = TM.DotDict(a=1)
    d.b = 2
    assert (d.a, d["b"]) == (1, 2)
    with pytest.raises(AttributeError):
        d.missing
    s = TM.Stopwatch()
    with s:
        pass
    assert s.get_total_duration() >= 0 and s.format().startswith("Elapsed")
    TM.seed_all(5)
    a = (np.random.rand(), torch.rand(1).item())
    TM.seed_all(5)
    assert a == (np.random.rand(), torch.rand(1).item())
