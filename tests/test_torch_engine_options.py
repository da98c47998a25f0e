"""The inference options of the port's engine and generic path against the
JAX package on the CPU (tiny BERT: 2 layers, H = 64, seq 16, calibrated
by JAX and carried across by ``convert.py``).

- ``gelu_impl`` ``'tanh'`` / ``'poly'`` / ``'exact'``: the engine's logits
  against JAX ``bert_engine_apply(gelu_impl=..., backend='xla')`` within
  rtol 1e-3 / atol 2e-3 (the engine tolerance of tests/test_engine.py);
  the epilogue activations' plain versions (K1's ``int8_matmul_ref``, the
  fused linear's ``gelu_poly10``) against JAX's reference matmuls, bit for
  bit on the emitted payloads;
- ``engine_dtype`` bfloat16 on the W8A8 (payload), non-payload (``{'h':
  'fp32'}``) and flex (``{'x': 16, 'h': 16, 'y': 16}``) plans against
  JAX's bfloat16 engine: logits within rtol 1e-3 / atol 2e-3 (measured:
  equal; the plain versions repeat JAX's bfloat16 casts); the flex value
  edges stay float32;
- ``parse_backend``, the flex refusal under a mixed backend (JAX's
  message), and a mixed-backend forward against JAX's;
- the generic path at ``compute_dtype`` / ``attention_dtype`` bfloat16,
  with and without ``int8_attention``, through the fused linear against
  JAX ``bert_apply(use_pallas=True)`` (its kernel in interpret mode):
  logits within rtol 1e-3 / atol 2e-3 and the sequence output within
  one level of its grid on at most 1% of the elements (measured: equal
  on this config).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as G
from transformer_quantization_tpu.models import bert as JB
from transformer_quantization_tpu.ops import int_linear as JIL
from transformer_quantization_tpu.ops.pallas import engine_kernels as JEK
from transformer_quantization_tpu.ops.pallas.int_matmul import (
    fused_int8_linear as j_fused,
)
from transformer_quantization_tpu.quant import quantizers as JQ
from transformer_quantization_tpu.quant.qconfig import QuantMode as JMode
from transformer_quantization_tpu_torch import convert as C
from transformer_quantization_tpu_torch.models import bert as TB
from transformer_quantization_tpu_torch.ops import engine as TENG
from transformer_quantization_tpu_torch.ops.kernels import engine_kernels as EK
from transformer_quantization_tpu_torch.ops.kernels import int_matmul as TIM
from transformer_quantization_tpu_torch.quant import quantizers as TQ
from transformer_quantization_tpu_torch.training import calibration as TC

torch.set_num_threads(2)

KW = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
          num_attention_heads=4, intermediate_size=128,
          max_position_embeddings=64, num_labels=2)
SEQ = 16
RTOL, ATOL = 1e-3, 2e-3
# the generic path's bfloat16 storage: bfloat16 matmuls and activations
# may round differently in XLA and PyTorch on the CPU (measured: equal
# logits and sequence output on this config); JAX's own bfloat16 checks
# hold 3e-2 (tests/test_engine.py)
BF16_RTOL, BF16_ATOL = 1e-3, 2e-3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def bert():
    jcfg, tcfg = JB.BertConfig(**KW), TB.BertConfig(**KW)
    jp, jq, js = G._calibrated_bert(jcfg, batch_size=2, seq=SEQ)
    jint = jax.jit(lambda p, s: JB.build_bert_int_params(p, jq, s))(jp, js)
    rng = np.random.RandomState(1)
    batch = {
        "input_ids": rng.randint(0, KW["vocab_size"], (8, SEQ)).astype(
            np.int32),
        "attention_mask": (np.arange(SEQ)[None, :]
                           < rng.randint(SEQ // 2, SEQ + 1, (8, 1))
                           ).astype(np.float32),
        "token_type_ids": np.zeros((8, SEQ), np.int32),
    }
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, jq=jq, js=js, jint=jint,
                tp=C.params_from_jax(_np(jp), device="cpu"),
                ts=C.qstate_from_jax(_np(js), device="cpu"),
                tint=C.int_params_from_jax(_np(jint), device="cpu"),
                batch=batch,
                jbatch={k: jnp.asarray(v) for k, v in batch.items()},
                engines={})


def _qcfgs(bert, qd):
    """Both packages' W8A8 site configs with ``qd`` applied."""
    n = KW["num_hidden_layers"]
    return (JB.apply_bert_quant_dict(bert["jq"], qd, n),
            TB.apply_bert_quant_dict(
                TB.declare_bert_sites(TC.w8a8_defaults(), bert["tcfg"]), qd,
                n))


def _engines(bert, name, qd):
    """Both packages' engine plans under ``qd``, made once a module."""
    if name not in bert["engines"]:
        jq, tq = _qcfgs(bert, qd)
        jst, jplan, _ = JB.build_bert_engine(bert["jp"], bert["jcfg"], jq,
                                             bert["js"],
                                             int_params=bert["jint"])
        tst, tplan, tint = TB.build_bert_engine(bert["tp"], bert["tcfg"], tq,
                                                bert["ts"], device="cpu")
        bert["engines"][name] = (jq, tq, jst, jplan, tst, tplan, tint)
    return bert["engines"][name]


def _jax_engine(bert, name, qd, **kw):
    """JAX's engine (XLA backend, jitted) under ``qd``: (logits, sequence
    output) as numpy."""
    jq, _, jst, jplan, _, _, _ = _engines(bert, name, qd)
    fn = jax.jit(lambda p, b: {k: v for k, v in JB.bert_engine_apply(
        p, b, bert["jcfg"], jq, bert["js"], jst, jplan, bert["jint"],
        **kw).items() if k in ("logits", "sequence_output")})
    out = fn(bert["jp"], bert["jbatch"])
    return (np.asarray(out["logits"]),
            np.asarray(out["sequence_output"], np.float32))


def _port_engine(bert, name, qd, seq_out=False, **kw):
    _, tq, _, _, tst, tplan, tint = _engines(bert, name, qd)
    out = TB.bert_engine_apply(bert["tp"], bert["batch"], bert["tcfg"], tq,
                               bert["ts"], tst, tplan, tint, device="cpu",
                               **kw)
    return (out["logits"], out["sequence_output"]) if seq_out else \
        out["logits"]


def _engine_close(bert, name, qd, want, got):
    """Logits within rtol 1e-3 / atol 2e-3; the sequence output (the last
    ffn.ln.out values) within one level of its grid on at most 1% of the
    elements."""
    (wl, ws), (gl, gs) = want, got
    np.testing.assert_allclose(gl.numpy(), wl, rtol=RTOL, atol=ATOL)
    _, tq, _, _, _, _, _ = _engines(bert, name, qd)
    site = f"L{KW['num_hidden_layers'] - 1}.ffn.ln.out"
    step = float(TQ.scale_of(tq[site].spec, bert["ts"][site]["qp"]))
    gs = gs.float().numpy()
    diff = np.abs(gs - ws)
    assert gs.shape == ws.shape and np.isfinite(gs).all()
    assert diff.max() <= step * 1.001 + 1e-6, (diff.max(), step)
    assert (diff > 1e-6).mean() <= 0.01, (diff > 1e-6).mean()


@pytest.mark.parametrize("impl", ["tanh", "poly", "exact"])
def test_engine_gelu_impl_matches_jax(bert, impl):
    """The engine's GELU by ``gelu_impl`` (tanh form, the degree-10
    polynomial, the A-S erf) against JAX's; each through the kernel
    wrappers and the plain versions alike."""
    want = _jax_engine(bert, "w8a8", {}, backend="xla", gelu_impl=impl)
    got = _port_engine(bert, "w8a8", {}, seq_out=True, gelu_impl=impl)
    _engine_close(bert, "w8a8", {}, want, got)
    plain = _port_engine(bert, "w8a8", {}, gelu_impl=impl, backend="plain")
    np.testing.assert_array_equal(plain.numpy(), got[0].numpy())
    with pytest.raises(ValueError, match="gelu_impl"):
        _port_engine(bert, "w8a8", {}, gelu_impl="erf")


def _matmul_inputs(m=96, k=64, n=48, seed=5):
    rng = np.random.RandomState(seed)
    x8 = rng.randint(-128, 128, (m, k)).astype(np.int8)
    w8 = rng.randint(-127, 128, (n, k)).astype(np.int8)
    vecs = np.stack([
        rng.uniform(1e-3, 3e-3, n), w8.astype(np.float32).sum(1),
        rng.normal(0, 0.5, n), rng.uniform(0.01, 0.03, n),
        rng.randint(-20, 20, n).astype(np.float32)]).astype(np.float32)
    scal = np.array([[0.05, 3.0]], np.float32)
    return x8, w8, vecs, scal


@pytest.mark.parametrize("act", ["gelu", "gelu_poly10", "tanh", "gelu_new"])
def test_activation_epilogues_match_jax(act):
    """K1's plain version with each epilogue activation against JAX's
    ``int8_matmul_ref`` (eager: one XLA op at a time, no fused multiply-
    add), bit for bit on the emitted payloads; its fold output in
    bfloat16 against JAX's ``out_dtype`` bfloat16 (no activation)."""
    x8, w8, vecs, scal = _matmul_inputs()
    want = JEK.int8_matmul_ref(x8, w8, vecs, scal, activation=act,
                               out_mode="emit")
    t = [torch.from_numpy(a) for a in (x8, w8, vecs, scal)]
    got = EK.int8_matmul_ref(*t, activation=act, out_mode="emit")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for mode in ("fold", "float"):
        want = JEK.int8_matmul_ref(x8, w8, vecs, scal, out_mode=mode,
                                   out_dtype=jnp.bfloat16)
        got = EK.int8_matmul_ref(*t, out_mode=mode, out_dtype=torch.bfloat16)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))


def _linear_case(seed=3, m=32, k=64, n=48):
    """A per-tensor asymmetric 8-bit input site, a per-channel symmetric
    int8 weight and an asymmetric 8-bit output site, in both packages."""
    rng = np.random.RandomState(seed)
    x = rng.normal(0, 1.0, (m, k)).astype(np.float32)
    w = rng.normal(0, 0.1, (n, k)).astype(np.float32)
    bias = rng.normal(0, 0.1, (n,)).astype(np.float32)

    def spec(method):
        return (JQ.QuantizerSpec(n_bits=8, method=getattr(JQ.QMethod, method)),
                TQ.QuantizerSpec(n_bits=8, method=getattr(TQ.QMethod, method)))

    def tqp(qp):
        return TQ.QuantParams(*(torch.from_numpy(np.array(v)) for v in
                                (qp.delta, qp.zero_float, qp.signed)))

    wspec, _ = spec("symmetric_uniform")
    wqp = JQ.set_quant_range(wspec, jnp.min(w, axis=1), jnp.max(w, axis=1))
    jpacked = JIL.pack_weight_int8(wspec, wqp, jnp.asarray(w))
    jspec, tspec = spec("asymmetric_uniform")
    jin = JQ.set_quant_range(jspec, jnp.min(x), jnp.max(x))
    jout = JQ.set_quant_range(jspec, jnp.float32(-1.0), jnp.float32(2.5))
    return dict(x=x, bias=bias, jpacked=jpacked,
                tpacked={k_: torch.from_numpy(np.array(v))
                         for k_, v in jpacked.items() if k_ != "n_bits"},
                jspec=jspec, tspec=tspec, jin=jin, jout=jout, tin=tqp(jin),
                tout=tqp(jout))


BF16_PLANS = {"w8a8": {}, "h-fp32": {"h": "fp32"},
              "mixed": {"x": 16, "h": 16, "y": 16}}


@pytest.mark.parametrize("name", sorted(BF16_PLANS))
def test_engine_dtype_bf16_matches_jax(bert, name):
    """``engine_dtype`` bfloat16 against JAX's bfloat16 engine: the
    payload route (entry and exit casts), the non-payload route (bfloat16
    residual stream, matmul folds and fused add+LN outputs) and the flex
    route (value edges float32). The bfloat16 exit is cast back to float32
    before the head in both packages."""
    qd = BF16_PLANS[name]
    want = _jax_engine(bert, name, qd, backend="xla",
                       engine_dtype=jnp.bfloat16)
    got = _port_engine(bert, name, qd, seq_out=True,
                       engine_dtype=torch.bfloat16)
    assert got[0].dtype == got[1].dtype == torch.float32
    _engine_close(bert, name, qd, want, got)
    plain = _port_engine(bert, name, qd, engine_dtype=torch.bfloat16,
                         backend="plain")
    np.testing.assert_array_equal(plain.numpy(), got[0].numpy())
    if name == "mixed":
        # the flex route's value edges: float32 whatever the engine_dtype
        _, _, _, _, tst, _, _ = _engines(bert, name, qd)
        assert tst.any_flex and not any(tst.int8_layer)


def test_parse_backend_and_mixed_forward_match_jax(bert):
    """``parse_backend`` as JAX's (the port's names), a mixed backend on
    the W8A8 plan against JAX's (its matmuls in interpret mode), and the
    flex refusal under a mix with JAX's message."""
    assert TENG.parse_backend("kernels") == ("kernels",) * 3
    assert TENG.parse_backend("mix:kernels,plain,kernels") == (
        "kernels", "plain", "kernels")
    for bad in ("xla", "mix:kernels,plain", "mix:a,b,c"):
        with pytest.raises(ValueError, match="engine backend"):
            TENG.parse_backend(bad)
    want = _jax_engine(bert, "w8a8", {}, backend="mix:pallas,xla,xla",
                       interpret=True)
    got = _port_engine(bert, "w8a8", {}, seq_out=True,
                       backend="mix:kernels,plain,plain")
    _engine_close(bert, "w8a8", {}, want, got)
    np.testing.assert_array_equal(
        got[0].numpy(), _port_engine(bert, "w8a8", {}).numpy())
    got_np = _port_engine(bert, "h-fp32", BF16_PLANS["h-fp32"],
                          backend="mix:plain,kernels,plain")
    np.testing.assert_array_equal(
        got_np.numpy(),
        _port_engine(bert, "h-fp32", BF16_PLANS["h-fp32"]).numpy())
    qd = BF16_PLANS["mixed"]
    jq, tq, jst, jplan, tst, tplan, tint = _engines(bert, "mixed", qd)
    with pytest.raises(ValueError, match="uniform engine backend"):
        JB.bert_engine_apply(bert["jp"], bert["jbatch"], bert["jcfg"], jq,
                             bert["js"], jst, jplan, bert["jint"],
                             backend="mix:xla,pallas,xla", interpret=True)
    with pytest.raises(ValueError, match="uniform engine backend"):
        _port_engine(bert, "mixed", qd, backend="mix:kernels,plain,kernels")


@pytest.mark.parametrize("int8_attention", [False, True],
                         ids=["bf16", "bf16-int8-attention"])
def test_generic_bf16_matches_jax(bert, int8_attention):
    """The generic W8A8 path with ``compute_dtype`` and ``attention_dtype``
    bfloat16 (the JAX server's fallback), with and without the integer
    attention, through the fused linear (its bfloat16 x form) against
    JAX's with its kernel; the port's plain and kernel routes agree bit
    for bit."""
    kw = dict(compute_dtype=jnp.bfloat16, attention_dtype=jnp.bfloat16,
              int8_attention=int8_attention)
    want, _ = JB.bert_apply(bert["jp"], bert["jbatch"], bert["jcfg"],
                            bert["jq"], bert["js"], JMode(),
                            int_params=bert["jint"], use_pallas=True, **kw)
    tkw = dict(compute_dtype=torch.bfloat16, attention_dtype=torch.bfloat16,
               int8_attention=int8_attention)
    args = (bert["tp"], bert["batch"], bert["tcfg"],
            TB.declare_bert_sites(TC.w8a8_defaults(), bert["tcfg"]),
            bert["ts"])
    got, _ = TB.bert_apply(*args, int_params=bert["tint"], fused_linear=True,
                           device="cpu", **tkw)
    np.testing.assert_allclose(got["logits"].float().numpy(),
                               np.asarray(want["logits"], np.float32),
                               rtol=BF16_RTOL, atol=BF16_ATOL)
    # the last layer's ln-site values (the sequence output): within one
    # level of that site's grid on at most 1% of the elements
    ws = np.asarray(want["sequence_output"], np.float32)
    gs = got["sequence_output"].float().numpy()
    site = f"L{KW['num_hidden_layers'] - 1}.ffn.ln.out"
    step = float(TQ.scale_of(args[3][site].spec, bert["ts"][site]["qp"]))
    diff = np.abs(gs - ws)
    assert gs.shape == ws.shape and np.isfinite(gs).all()
    assert diff.max() <= step * 1.001 + 1e-6, (diff.max(), step)
    assert (diff > 1e-6).mean() <= 0.01, (diff > 1e-6).mean()
    plain, _ = TB.bert_apply(*args, int_params=bert["tint"],
                             fused_linear="plain", device="cpu", **tkw)
    np.testing.assert_array_equal(plain["logits"].float().numpy(),
                                  got["logits"].float().numpy())
