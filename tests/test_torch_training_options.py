"""The training options of ``QATConfig`` and the forwards (the JAX CLI's
``--remat``, ``--scan-layers`` and ``--amp``) against the port itself and
against JAX, on a tiny W8A8 BERT (2 layers, H = 64, seq 32) and the tiny ALBERT
preset (2 applications of the shared layer, H = 64, E = 16). Weights are
the port's seeded init, carried to JAX as they are; batches are drawn with
numpy from a seed; the ranges are the port's calibration, carried to JAX.

- ``remat``: one QAT forward and backward with and without it, for
  learned ranges with dropout, learned ranges on the int8 QAT forward, and
  estimate-phase ranges with dropout: the loss, every gradient, the new
  quant state and the dropout generator's state equal bit for bit.
- ``scan_layers``: an estimate pass (ranges updated layer by layer) and a
  fixed-range forward with ``scan_layers=True`` against JAX's scan, run
  jitted (the test checks JAX took it; the port's ``scan_layers`` runs its
  loop) at W8A8 current-minmax: ranges and params within rtol 1e-5 / atol
  1e-7 (float32 rounding), logits within rtol 1e-5 / atol 1e-6; ALBERT's
  shared layer carries its quant state from application to application.
- ``compute_dtype='bfloat16'``: one learned-range QAT step's loss and
  gradients against JAX's (O0-jitted, as ``tests/test_torch_qat.py``):
  loss within rtol 2e-3, the error norm of all gradients together within
  5% of JAX's norm and each leaf's within 25% (measured 6e-5, 2.4% and at
  most 10.6%: the port rounds each bf16 op, XLA keeps more in float32);
  the port's float32 step differs from its bf16 step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from transformer_quantization_tpu.models import albert as JA
from transformer_quantization_tpu.models import bert as JB
from transformer_quantization_tpu.quant.qconfig import Phase
from transformer_quantization_tpu.quant.qconfig import QuantMode as JMode
from transformer_quantization_tpu.training import qat as JQAT
from transformer_quantization_tpu_torch import convert as C
from transformer_quantization_tpu_torch.models import albert as TA
from transformer_quantization_tpu_torch.models import bert as TB
from transformer_quantization_tpu_torch.models import registry as TR
from transformer_quantization_tpu_torch.quant.qconfig import Phase as TPhase
from transformer_quantization_tpu_torch.quant.qconfig import QuantMode
from transformer_quantization_tpu_torch.training import calibration as TC
from transformer_quantization_tpu_torch.training import qat as TQAT

torch.set_num_threads(2)

KW = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
          num_attention_heads=4, intermediate_size=128,
          max_position_embeddings=64, num_labels=2, hidden_dropout_prob=0.0,
          attention_probs_dropout_prob=0.0)
SEQ, B = 32, 4
O0 = {"xla_backend_optimization_level": 0}
RANGE_RTOL, RANGE_ATOL = 1e-5, 1e-7
LOGIT_RTOL, LOGIT_ATOL = 1e-5, 1e-6
# the loss; all gradients' error norm and each leaf's, relative to JAX's
BF16_LOSS_RTOL, BF16_TOTAL, BF16_LEAF = 2e-3, 5e-2, 0.25
LEAF_FLOOR = 1e-4


def _np(tree):
    """Numpy copies (a port tensor made from a view of a JAX buffer would
    follow that buffer when JAX frees and reuses it)."""
    return jax.tree.map(np.array, tree)


def _batch(seed, vocab, n=B, labels=True):
    rng = np.random.RandomState(seed)
    b = {"input_ids": rng.randint(4, vocab, (n, SEQ)).astype(np.int32),
         "attention_mask": (np.arange(SEQ)[None, :]
                            < rng.randint(SEQ // 2, SEQ + 1, (n, 1))
                            ).astype(np.float32),
         "token_type_ids": np.zeros((n, SEQ), np.int32)}
    if labels:
        b["labels"] = rng.randint(0, 2, (n,)).astype(np.int32)
    return b


def _jax_defaults():
    from transformer_quantization_tpu.quant.qconfig import QuantDefaults
    from transformer_quantization_tpu.quant.quantizers import QMethod
    from transformer_quantization_tpu.quant.ranges import RangeMethod

    return QuantDefaults(method=QMethod.symmetric_uniform,
                         act_method=QMethod.asymmetric_uniform, n_bits=8,
                         n_bits_act=8,
                         weight_range_method=RangeMethod.current_minmax,
                         act_range_method=RangeMethod.current_minmax)


def _port_defaults():
    return TC.w8a8_defaults()


def _calls(module, name):
    """Wrap ``module.name`` to count its calls; returns (count, restore)."""
    real, n = getattr(module, name), [0]

    def wrapped(*a, **k):
        n[0] += 1
        return real(*a, **k)
    setattr(module, name, wrapped)
    return n, lambda: setattr(module, name, real)


def _close_states(ts, js, what):
    """Every site's range state and params within float32 rounding."""
    js = C.qstate_from_jax(_np(js), device="cpu")
    assert set(ts) == set(js), what
    for site in js:
        pairs = [(ts[site]["qp"].delta, js[site]["qp"].delta, "delta"),
                 (ts[site]["qp"].zero_float, js[site]["qp"].zero_float,
                  "zero_float")]
        if "range_state" in js[site]:
            pairs += [(ts[site]["range_state"][k], js[site]["range_state"][k],
                       k) for k in ("xmin", "xmax")]
        for a, b, k in pairs:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RANGE_RTOL,
                                       atol=RANGE_ATOL,
                                       err_msg=f"{what}: {site}.{k}")


def _jax_qstate(qstate):
    """The port's quant state as JAX's (params, range state, alphas)."""
    from transformer_quantization_tpu.quant import quantizers as JQ

    def arr(t):
        return jnp.asarray(t.numpy())

    out = {}
    for name, st in qstate.items():
        js = {"qp": JQ.QuantParams(delta=arr(st["qp"].delta),
                                   zero_float=arr(st["qp"].zero_float),
                                   signed=arr(st["qp"].signed))}
        if "range_state" in st:
            js["range_state"] = {k: arr(v)
                                 for k, v in st["range_state"].items()}
        if "alpha" in st:
            js["alpha"] = None
        out[name] = js
    return out


@pytest.fixture(scope="module")
def bert():
    """The port's random BERT, calibrated by the port on one batch, and
    the same params and ranges in JAX's trees."""
    jcfg, tcfg = JB.BertConfig(**KW), TB.BertConfig(**KW)
    tp = TB.init_bert_params(tcfg, seed=0, device="cpu")
    _, tq, ts = TC.calibrated_bert(tcfg, batch_size=2, seq=SEQ, seed=1,
                                   device="cpu", params=tp,
                                   defaults=_port_defaults())
    return dict(jcfg=jcfg, tcfg=tcfg, tp=tp, tq=tq, ts=ts,
                jp=jax.tree.map(lambda t: jnp.asarray(t.numpy()), tp),
                jq=JB.declare_bert_sites(_jax_defaults(), jcfg),
                js=_jax_qstate(ts))


def _remat_case(bert, case):
    tcfg = bert["tcfg"]
    dropout = 0.0 if case == "learn-int8" else 0.1
    cfg = dataclasses.replace(tcfg, hidden_dropout_prob=dropout,
                              attention_probs_dropout_prob=dropout)
    qat = TQAT.QATConfig(learn_ranges=not case.startswith("estimate"))
    if case == "learn-int8":
        qat = dataclasses.replace(
            qat, int8_sites=TQAT.int8_forward_sites(bert["tq"], bert["ts"]))
    if qat.learn_ranges:
        learnable, rest = TQAT.split_learnable_ranges(bert["tq"], bert["ts"])
    else:
        learnable, rest = {}, dict(bert["ts"])
    batch = _batch(2, KW["vocab_size"])
    out = []
    for remat in (False, True):
        gen = torch.Generator().manual_seed(7)

        def apply_fn(p, b, **kw):
            return TB.bert_apply(p, b, cfg, device="cpu", **kw)

        loss, grads, new_qs, _ = TQAT.qat_value_and_grad(
            apply_fn, bert["tq"], dataclasses.replace(qat, remat=remat),
            bert["tp"], learnable, rest, batch, gen)
        out.append((loss, grads, new_qs, gen.get_state()))
    return out


@pytest.mark.parametrize("case", ["learn-dropout", "learn-int8",
                                  "estimate-dropout"])
def test_remat_is_bit_identical(bert, case):
    (l0, g0, q0, r0), (l1, g1, q1, r1) = _remat_case(bert, case)
    assert torch.equal(l0, l1)
    assert len(g0) == len(g1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)
    assert torch.equal(r0, r1)
    assert set(q0) == set(q1)
    for site in q0:
        st0, st1 = q0[site], q1[site]
        if "qp" in st0:
            assert torch.equal(st0["qp"].delta, st1["qp"].delta), site
            assert torch.equal(st0["qp"].zero_float,
                               st1["qp"].zero_float), site
        if "range_state" in st0:
            for k in ("xmin", "xmax"):
                assert torch.equal(st0["range_state"][k],
                                   st1["range_state"][k]), site


def _estimate_then_logits(apply, qstate, est):
    """``apply(qstate, mode)``'s estimate pass, then its fixed-range
    logits on the updated state: ``(state, logits)``."""
    state = apply(qstate, est)[1]
    return state, apply(state, JMode())[0]["logits"]


def test_bert_scan_matches_jax(bert):
    """An estimate pass and a fixed-range forward with ``scan_layers``."""
    jcfg, tcfg = bert["jcfg"], bert["tcfg"]
    b = _batch(3, KW["vocab_size"], labels=False)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    n, restore = _calls(JB, "_scan_encoder")
    try:
        js, jl = jax.jit(lambda s: _estimate_then_logits(
            lambda qs, mode: JB.bert_apply(bert["jp"], jb, jcfg, bert["jq"],
                                           qs, mode, scan_layers=True),
            s, JMode(act_phase=Phase.estimate)))(bert["js"])
    finally:
        restore()
    assert n[0] == 2  # JAX took its scan in both forwards
    _, ts = TB.bert_apply(bert["tp"], b, tcfg, bert["tq"], bert["ts"],
                          QuantMode(act_phase=TPhase.estimate),
                          scan_layers=True, device="cpu")
    _close_states(ts, js, "estimate")
    out, _ = TB.bert_apply(bert["tp"], b, tcfg, bert["tq"], ts, QuantMode(),
                           scan_layers=True, device="cpu")
    np.testing.assert_allclose(out["logits"].numpy(), np.asarray(jl),
                               rtol=LOGIT_RTOL, atol=LOGIT_ATOL)


def test_albert_shared_scan_matches_jax():
    """ALBERT's scan over the shared layer, its quant state carried from
    application to application (every shared site initialized first, so
    JAX's gate takes the scan)."""
    tiny = TR.get_family("albert").tiny_preset
    jcfg = JA.AlbertConfig(**tiny, num_labels=2)
    tcfg = TA.AlbertConfig(**tiny, num_labels=2)
    tp = TA.init_albert_params(tcfg, seed=0, device="cpu")
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tp)
    jq = JA.declare_albert_sites(_jax_defaults(), jcfg)
    tq = TA.declare_albert_sites(_port_defaults(), tcfg)
    est = JMode(act_phase=Phase.estimate)
    b1, b2 = (_batch(s, tiny["vocab_size"], labels=False) for s in (4, 5))
    # every site initialized by one port calibration pass on b1
    ts1, _ = TC.prepare_quantized_model(
        lambda p, b, **k: TA.albert_apply(p, b, tcfg, **k),
        tp, tq, [b1], weight_tensors=TA.albert_weight_site_tensors(tp),
        device="cpu")
    jb2 = {k: jnp.asarray(v) for k, v in b2.items()}
    n, restore = _calls(JA, "_scan_shared_encoder")
    try:
        js2, jl = jax.jit(lambda s: _estimate_then_logits(
            lambda qs, mode: JA.albert_apply(jp, jb2, jcfg, jq, qs, mode,
                                             scan_layers=True), s, est))(
                                                 _jax_qstate(ts1))
    finally:
        restore()
    assert n[0] == 2
    _, ts2 = TA.albert_apply(tp, b2, tcfg, tq, ts1,
                             QuantMode(act_phase=TPhase.estimate),
                             scan_layers=True, device="cpu")
    _close_states(ts2, js2, "albert estimate")
    out, _ = TA.albert_apply(tp, b2, tcfg, tq, ts2, QuantMode(),
                             scan_layers=True, device="cpu")
    np.testing.assert_allclose(out["logits"].numpy(), np.asarray(jl),
                               rtol=LOGIT_RTOL, atol=LOGIT_ATOL)


def _jax_step_grads(bert, batch, compute_dtype):
    learnable, rest = JQAT.split_learnable_ranges(bert["jq"], bert["js"])
    flat, unravel = ravel_pytree(learnable)
    qat = JQAT.QATConfig(learn_ranges=True)
    extra = ({"compute_dtype": jnp.dtype(compute_dtype)} if compute_dtype
             else {})
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(tr):
        qs = JQAT.merge_learnable_ranges(unravel(tr["ranges"]), rest)
        out, _ = JB.bert_apply(tr["params"], jb, bert["jcfg"],
                               qcfg=bert["jq"], qstate=qs,
                               mode=JQAT.qat_mode(qat), train=True,
                               dropout_rng=jax.random.PRNGKey(0), **extra)
        return out["loss"]

    loss, g = jax.jit(jax.value_and_grad(loss_fn), compiler_options=O0)(
        {"params": bert["jp"], "ranges": flat})
    leaves = jax.tree.leaves(g["params"]) + [g["ranges"]]
    return float(loss), [np.asarray(x, np.float32) for x in leaves]


def _port_step_grads(bert, batch, compute_dtype):
    qat = TQAT.QATConfig(learn_ranges=True, compute_dtype=compute_dtype)
    learnable, rest = TQAT.split_learnable_ranges(bert["tq"], bert["ts"])

    def apply_fn(p, b, **kw):
        return TB.bert_apply(p, b, bert["tcfg"], device="cpu", **kw)

    loss, grads, _, _ = TQAT.qat_value_and_grad(
        apply_fn, bert["tq"], qat, bert["tp"], learnable, rest, batch,
        torch.Generator().manual_seed(0))
    return float(loss), [g.numpy() for g in grads]


def test_bf16_qat_step_matches_jax(bert):
    """One learned-range QAT step at ``compute_dtype='bfloat16'`` (the
    CLI's ``--amp``) against JAX's (dropout 0 in the config). Leaves whose
    gradient is mathematically zero (the key biases: the softmax ignores a
    shift shared by every key) are left out by the floor. The port's
    float32 step differs from its bf16 step: the bf16 path is taken."""
    batch = _batch(6, KW["vocab_size"])
    jl, jg = _jax_step_grads(bert, batch, "bfloat16")
    tl, tg = _port_step_grads(bert, batch, "bfloat16")
    fl, fg = _port_step_grads(bert, batch, None)
    assert len(jg) == len(tg) == len(fg)
    np.testing.assert_allclose(tl, jl, rtol=BF16_LOSS_RTOL)
    flat_j = np.concatenate([g.ravel() for g in jg])

    def total_err(grads):
        flat = np.concatenate([g.ravel() for g in grads])
        return np.linalg.norm(flat - flat_j) / np.linalg.norm(flat_j)

    assert total_err(tg) <= BF16_TOTAL
    assert tl != fl and total_err(tg) != total_err(fg)
    floor = LEAF_FLOOR * max(np.linalg.norm(g) for g in jg)
    for i, (t, j) in enumerate(zip(tg, jg)):
        if np.linalg.norm(j) > floor:
            err = np.linalg.norm(t - j) / np.linalg.norm(j)
            assert err <= BF16_LEAF, (i, err)
