"""Port parity for the last two TPU kernels and the paths that run them:
the generic int path's fused linear (JAX ``use_pallas``) and the engine's
non-payload residual route (a disabled fold site, with ``fused_add_ln``),
the leave-one-out FP32 configurations of the paper's section 3.

Kernels: the plain versions against the JAX functions in interpret mode,
on inputs made with numpy from a seed (m=16, k=32, n=24 as
tests/test_pallas.py); the fused linear's quantize step, which the card
runs as a pass of its own before the payload route, bit for bit against
the JAX kernel's quantize-on-load and as a decomposition of the float32
route. Paths: the tiny BERT of tests/test_engine.py (2
layers, H=64). The JAX package calibrates W8A8 once; each leave-one-out
configuration applies its quant_dict to both packages' site configs over
that one qstate (the comparison needs the same ranges on both sides, not
ranges re-estimated per configuration).

Tolerances:
- fused linear: levels, payloads and folded values equal where no
  transcendental comes before the rounding (no activation, relu,
  gelu_poly10); after gelu, gelu_new or tanh, levels at most one apart on
  at most 1% of elements. Unrounded float outputs within rtol 1e-6 /
  atol 1e-6 (the interpreted JAX kernel lets XLA contract the fold's
  multiply-add, which the port never does), rtol 1e-5 after a
  transcendental (XLA's and PyTorch's exp / tanh differ by ulps);
- fused_add_ln: payloads at most one level apart on at most 0.1% of rows'
  elements (float32 row sums in JAX, float64 in the port, and ``z / ln_s``
  against JAX's ``z * (1 / ln_s)``), the float output ``ln_s * (q +
  ln_sh)`` of the port's own payload exactly;
- logits against JAX: rtol 1e-3 / atol 2e-3 (tests/test_engine.py's
  bound); ``sequence_output`` (O(1), where that atol says more) within one
  grid level of ``ffn.ln.out`` on at most 1% of elements, or within 1e-5
  where that site is disabled; the port's fused path against its own int
  path within tests/test_pallas.py's rtol 1e-4 / atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as G
from transformer_quantization_tpu.models import bert as JB
from transformer_quantization_tpu.ops import engine as JENG
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
from transformer_quantization_tpu_torch.ops import int_linear as TIL
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


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _tqp(qp):
    return TQ.QuantParams(delta=_t(qp.delta), zero_float=_t(qp.zero_float),
                          signed=_t(qp.signed))


def _spec(method, bits=8):
    return (JQ.QuantizerSpec(n_bits=bits, method=getattr(JQ.QMethod, method)),
            TQ.QuantizerSpec(n_bits=bits, method=getattr(TQ.QMethod, method)))


# ---------------------------------------------------------------------------
# The fused linear's plain version against the JAX kernel (interpret mode)
# ---------------------------------------------------------------------------

ACTIVATIONS = [None, "gelu", "gelu_new", "gelu_poly10", "tanh", "relu"]
OUT_SITES = ["none", "asym-fold", "sym-signed-6bit", "emit"]
INPUTS = ["f32-asym", "f32-sym", "payload-asym", "payload-sym"]
CASES = [(act, out, INPUTS[(i + j) % 4], (i + j) % 2 == 0, (i // 2 + j) % 2)
         for i, act in enumerate(ACTIVATIONS) for j, out in enumerate(OUT_SITES)]


def _case_inputs(inp, bias, per_channel, out, n=24):
    """x (float32 or its payload), the packed weight, the input and output
    sites of one case, in both packages."""
    rng = np.random.RandomState(9)
    m, k = 16, 32
    x = (rng.randn(m, k) * 1.5).astype(np.float32)
    w = rng.normal(0, 0.1, (n, k)).astype(np.float32)
    b = rng.normal(0, 0.1, (n,)).astype(np.float32) if bias else None
    wspec, _ = _spec("symmetric_uniform")
    red = dict(axis=1) if per_channel else {}
    wqp = JQ.set_quant_range(wspec, jnp.min(w, **red), jnp.max(w, **red))
    jpacked = JIL.pack_weight_int8(wspec, wqp, jnp.asarray(w))
    in_j, in_t = _spec("asymmetric_uniform" if inp.endswith("asym")
                       else "symmetric_uniform")
    iqp = JQ.set_quant_range(in_j, jnp.min(x), jnp.max(x))
    jx = jnp.asarray(x)
    if inp.startswith("payload"):
        jx = JIL.quantize_activation_int8(in_j, iqp, jx)[0]
    # the output site's range from the int linear's own output
    x8, s, sh = JIL.quantize_activation_int8(in_j, iqp, jnp.asarray(x))
    y = np.asarray(JIL.int8_linear(x8, s, sh, jpacked,
                                   None if b is None else jnp.asarray(b)))
    out_j = out_t = oqp = None
    if out != "none":
        method, bits = (("symmetric_uniform", 6) if out.startswith("sym")
                        else ("asymmetric_uniform", 8))
        out_j, out_t = _spec(method, bits)
        oqp = JQ.set_quant_range(out_j, jnp.asarray(y.min()),
                                 jnp.asarray(y.max()))
    tpacked = {key: _t(v) for key, v in jpacked.items() if key != "n_bits"}
    return dict(jx=jx, tx=_t(jx), jpacked=jpacked, tpacked=tpacked,
                jb=None if b is None else jnp.asarray(b),
                tb=None if b is None else _t(b), in_j=in_j, in_t=in_t,
                jiqp=iqp, tiqp=_tqp(iqp), out_j=out_j, out_t=out_t,
                joqp=oqp, toqp=None if oqp is None else _tqp(oqp))


@pytest.mark.parametrize("act,out,inp,bias,per_channel", CASES,
                         ids=[f"{a}-{o}-{i}-{'b' if bb else 'nob'}-"
                              f"{'pc' if pc else 'pt'}"
                              for a, o, i, bb, pc in CASES])
def test_fused_linear_plain_matches_jax(act, out, inp, bias, per_channel):
    c = _case_inputs(inp, bias, per_channel, out)
    emit = out == "emit"
    want = np.asarray(j_fused(c["jx"], c["jpacked"], c["in_j"], c["jiqp"],
                              bias=c["jb"], activation=act,
                              out_spec=c["out_j"], out_qp=c["joqp"],
                              emit_int8=emit, interpret=True))
    EK.reset_launches()
    got = TIM.fused_int8_linear(c["tx"], c["tpacked"], c["in_t"], c["tiqp"],
                                bias=c["tb"], activation=act,
                                out_spec=c["out_t"], out_qp=c["toqp"],
                                emit_int8=emit).numpy()
    assert EK.LAUNCHES["fused_int8_linear"] == 0  # CPU: the plain version
    assert got.dtype == want.dtype and got.shape == want.shape
    exact = act in (None, "relu", "gelu_poly10")
    if out == "none":
        np.testing.assert_allclose(got, want, rtol=1e-6 if exact else 1e-5,
                                   atol=1e-6)
        return
    if exact:
        np.testing.assert_array_equal(got, want)
        return
    # one level: a payload step, or the output site's grid step
    step = 1.0 if emit else float(TQ.scale_of(c["out_t"], c["toqp"]))
    diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
    assert diff.max() <= step * (1 + 1e-6), diff.max()
    assert (diff > 0).mean() <= 0.01, (diff > 0).mean()


def test_fused_linear_emits_the_consumers_payload():
    """The emitted payload is quantize_activation_int8(fake_quant(y)), as
    tests/test_pallas.py pins for JAX, and a consumer of the payload gives
    what it gives on the fake-quantized floats."""
    c = _case_inputs("f32-asym", True, True, "emit", n=32)
    y = TIM.fused_int8_linear(c["tx"], c["tpacked"], c["in_t"], c["tiqp"],
                              bias=c["tb"], out_spec=c["out_t"],
                              out_qp=c["toqp"])
    pay = TIM.fused_int8_linear(c["tx"], c["tpacked"], c["in_t"], c["tiqp"],
                                bias=c["tb"], out_spec=c["out_t"],
                                out_qp=c["toqp"], emit_int8=True)
    ref8 = TIL.quantize_activation_int8(c["out_t"], c["toqp"], y)[0]
    np.testing.assert_array_equal(pay.numpy(), ref8.numpy())
    np.testing.assert_array_equal(
        TIL.dequantize_activation_int8(c["out_t"], c["toqp"], pay).numpy(),
        y.numpy())
    rng = np.random.RandomState(10)
    w2 = _t(rng.normal(0, 0.1, (8, 32)).astype(np.float32))
    wspec = TQ.QuantizerSpec(n_bits=8, method=TQ.QMethod.symmetric_uniform)
    w2qp = TQ.set_quant_range(wspec, w2.min(1).values, w2.max(1).values)
    packed2 = TIL.pack_weight_int8(wspec, w2qp, w2)
    np.testing.assert_array_equal(
        TIM.fused_int8_linear(pay, packed2, c["out_t"], c["toqp"]).numpy(),
        TIM.fused_int8_linear(y, packed2, c["out_t"], c["toqp"]).numpy())


def test_fused_linear_acceptance_rules():
    """None where the JAX function returns None whatever the device (m not
    a multiple of 8, m < 8, a dtype other than float32 / int8, a K
    mismatch, emit without an 8-bit output site), and where the kernel's
    tile rule refuses (K % 16, N % 8; packed int4 K % 32); a bfloat16 x
    is taken, as the JAX function takes it."""
    c = _case_inputs("f32-asym", True, False, "asym-fold")
    args = (c["tpacked"], c["in_t"], c["tiqp"])
    jargs = (c["jpacked"], c["in_j"], c["jiqp"])
    x, jx = c["tx"], c["jx"]
    assert TIM.fused_int8_linear(x, *args) is not None
    for tx_, jx_ in ((x[:12], jx[:12]), (x[:4], jx[:4]),
                     (x.double(), None), (x[:, :16], jx[:, :16])):
        assert TIM.fused_int8_linear(tx_, *args) is None
        if jx_ is not None:
            assert j_fused(jx_, *jargs, interpret=True) is None
    assert TIM.fused_int8_linear(x, *args, emit_int8=True) is None
    assert j_fused(jx, *jargs, emit_int8=True, interpret=True) is None
    o4, t4 = _spec("asymmetric_uniform", 4)
    assert TIM.fused_int8_linear(x, *args, out_spec=t4, out_qp=c["toqp"],
                                 emit_int8=True) is None
    assert j_fused(jx, *jargs, out_spec=o4, out_qp=c["joqp"],
                   emit_int8=True, interpret=True) is None
    # the kernel's tile rule: K % 16 and N % 8
    k40 = {**c["tpacked"], "w_int": torch.zeros((24, 40), dtype=torch.int8)}
    assert TIM.fused_int8_linear(torch.zeros(16, 40), k40, *args[1:]) is None
    n20 = {key: v[:20] for key, v in c["tpacked"].items()}
    assert TIM.fused_int8_linear(x, n20, *args[1:]) is None
    # split-half int4 weights compute (tests/test_torch_int4.py holds them
    # against JAX) on the int8 path's steps, and take the kernel's K % 32
    rng = np.random.RandomState(2)
    wp = torch.from_numpy(rng.randint(0, 256, (24, 16)).astype(np.uint8))
    lv = TIL.unpack_int4(wp, 32)
    w4 = {"w_packed": wp, "scale": c["tpacked"]["scale"],
          "colsum": lv.float().sum(1), "n_bits": 4, "in_features": 32}
    w8 = {"w_int": lv, "scale": w4["scale"], "colsum": w4["colsum"]}
    np.testing.assert_array_equal(
        TIM.fused_int8_linear(x, w4, *args[1:]).numpy(),
        TIM.fused_int8_linear(x, w8, *args[1:]).numpy())
    k48 = dict(w4, w_packed=torch.zeros((24, 24), dtype=torch.uint8),
               in_features=48)
    assert TIM.fused_int8_linear(torch.zeros(16, 48), k48, *args[1:]) is None
    # a bfloat16 x: quantized in float32, its fold output bfloat16, equal
    # to the JAX kernel's (interpret mode) on the same bfloat16 x
    got = TIM.fused_int8_linear(x.bfloat16(), *args, bias=c["tb"],
                                out_spec=c["out_t"], out_qp=c["toqp"])
    want = j_fused(jx.astype(jnp.bfloat16), *jargs, bias=c["jb"],
                   out_spec=c["out_j"], out_qp=c["joqp"], interpret=True)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


# ---------------------------------------------------------------------------
# The quantize step the card runs as a pass of its own
# ---------------------------------------------------------------------------

KERNEL_ACTS = [None, "gelu", "gelu_new", "tanh", "relu"]
DECOMP = [(inp, act, out) for inp in ("f32-asym", "f32-sym")
          for act in KERNEL_ACTS for out in ("none", "asym-fold", "emit")]


@pytest.mark.parametrize("inp,act,out", DECOMP,
                         ids=[f"{i}-{a}-{o}" for i, a, o in DECOMP])
def test_quantize_pass_then_payload_equals_float_x(inp, act, out,
                                                   monkeypatch):
    """The card's decomposition of a float32 x: the quantize step into a
    payload, then the payload route, gives the plain version's bits on the
    float32 x, for both input sites, the kernel's five activations and its
    three outputs (no site, fold, emit)."""
    c = _case_inputs(inp, True, True, out)
    calls = []
    real = TIM.fused_int8_linear_ref
    monkeypatch.setattr(TIM, "fused_int8_linear_ref",
                        lambda *a, **k: calls.append((a, k)) or real(*a, **k))
    TIM.fused_int8_linear(c["tx"], c["tpacked"], c["in_t"], c["tiqp"],
                          bias=c["tb"], activation=act, out_spec=c["out_t"],
                          out_qp=c["toqp"], emit_int8=out == "emit")
    (args, kw), = calls
    want = real(*args, **kw)
    x8 = TIM.quantize_input_ref(args[0], args[5], kw["asym_in"])
    assert x8.dtype == torch.int8
    got = real(x8, *args[1:], **kw)
    assert got.dtype == want.dtype
    assert torch.equal(got, want)


def _half_levels(s: np.float32, m: int, k: int, seed: int) -> np.ndarray:
    """(m, k) float32 values around the grid's half levels (n + 0.5) * s,
    exactly there and one ulp either side, among random values, and some
    past the grid's ends."""
    rng = np.random.RandomState(seed)
    n = np.arange(-140, 140, dtype=np.float32)
    half = ((n + np.float32(0.5)) * s).astype(np.float32)
    vals = np.concatenate([half, np.nextafter(half, np.float32(np.inf)),
                           np.nextafter(half, np.float32(-np.inf))])
    rest = (rng.randn(m * k - vals.size) * 60 * s).astype(np.float32)
    x = np.concatenate([vals, rest])
    rng.shuffle(x)
    return x.reshape(m, k)


def _jax_quantize_on_load(x: np.ndarray, scal: np.ndarray, asym: bool):
    """The JAX ``_kernel``'s quantize-on-load levels, in interpret mode:
    the kernel on an identity weight of scale 1 and zero colsum gives
    y = s_x * level; the level is recovered exactly (|level| <= 128)."""
    from transformer_quantization_tpu.ops.pallas.int_matmul import _fused_call
    m, k = x.shape
    y = np.asarray(_fused_call(
        jnp.asarray(x), jnp.eye(k, dtype=jnp.int8), jnp.ones((k,)),
        jnp.zeros((k,)), None, jnp.asarray(scal), activation=None,
        asym_in=asym, out_bits=0, out_sym=False, block_m=m, interpret=True))
    lvl = np.round(y / scal[0, 0])
    np.testing.assert_array_equal((scal[0, 0] * lvl).astype(np.float32), y)
    return lvl.astype(np.int8)


QUANT = [(asym, s) for asym in (True, False) for s in (0.0371, 0.05173)]


@pytest.mark.parametrize("asym,s", QUANT,
                         ids=[f"{'asym' if a else 'sym'}-{s}"
                              for a, s in QUANT])
def test_quantize_step_matches_jax_kernel(asym, s):
    """The factored quantize step against the JAX kernel's quantize-on-load
    (interpret mode), on values at, and one ulp either side of, every half
    level, where x / s and x * (1/s) can round apart, and past the grid's
    ends."""
    s = np.float32(s)
    x = _half_levels(s, 16, 64, seed=12)
    scal = np.zeros((1, 8), np.float32)
    scal[0, :2] = (s, 117.0 if asym else 0.0)
    want = _jax_quantize_on_load(x, scal, asym)
    got = TIM.quantize_input_ref(_t(x), _t(scal), asym).numpy()
    np.testing.assert_array_equal(got, want)
    # the inputs reach both ends of the grid
    assert got.min() == -128 and got.max() == 127


@pytest.mark.parametrize("case", ["reciprocal", "unsigned-symmetric"])
def test_quantize_activation_int8_is_not_the_kernels_step(case):
    """``ops.int_linear.quantize_activation_int8`` divides and takes a
    symmetric site's bounds from its sign; the TPU kernel multiplies by
    1/s_x and clips a symmetric input to [-128, 127]. On these inputs the
    two differ, and the JAX kernel sides with the factored step, which is
    why the pass does not call the former."""
    s = np.float32(0.0371)
    if case == "reciprocal":
        inv = np.float32(1.0) / s
        x = _half_levels(s, 16, 64, seed=13)
        apart = np.round(x / s) != np.round(x * inv)
        assert apart.any()   # x / s and x * (1/s) round apart here
        spec = TQ.QuantizerSpec(n_bits=8,
                                method=TQ.QMethod.asymmetric_uniform)
        qp = TQ.QuantParams(delta=_t(s), zero_float=_t(np.float32(117.0)),
                            signed=_t(np.float32(1.0)))
        asym = True
    else:   # an unsigned symmetric site: levels 0..255 against -128..127
        apart = None
        x = np.abs(_half_levels(s, 16, 64, seed=14))
        spec = TQ.QuantizerSpec(n_bits=8, method=TQ.QMethod.symmetric_uniform)
        qp = TQ.QuantParams(delta=_t(s), zero_float=_t(np.float32(0.0)),
                            signed=_t(np.float32(0.0)))
        asym = False
    scal = np.zeros((1, 8), np.float32)
    scal[0, 0] = float(TQ.scale_of(spec, qp))
    scal[0, 1] = float(TQ.zero_point_of(spec, qp))
    ours = TIM.quantize_input_ref(_t(x), _t(scal), asym).numpy()
    theirs = TIL.quantize_activation_int8(spec, qp, _t(x))[0].numpy()
    differ = ours != theirs
    assert differ.any()
    if apart is not None:   # only where the two roundings part
        assert not (differ & ~apart).any()
    np.testing.assert_array_equal(ours, _jax_quantize_on_load(x, scal, asym))


# ---------------------------------------------------------------------------
# fused_add_ln's plain version against the JAX kernel (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("res_quant", [True, False])
def test_fused_add_ln_plain_matches_jax(res_quant):
    rng = np.random.RandomState(4)
    m, h = 64, 128
    y = (rng.randn(m, h) * 0.8).astype(np.float32)
    r = (rng.randn(m, h) * 1.2 + 0.3).astype(np.float32)
    gb = np.stack([1.0 + 0.1 * rng.randn(h), 0.1 * rng.randn(h)]).astype(
        np.float32)
    scal = np.array([[1.0, 0.0, 1.0, 0.0, 0.031, 5.0, 0.027, -3.0]],
                    np.float32)
    j8, jf = map(np.asarray, JEK.fused_add_ln(
        jnp.asarray(y), jnp.asarray(r), jnp.asarray(gb), jnp.asarray(scal),
        eps=1e-12, res_quant=res_quant, interpret=True))
    EK.reset_launches()
    t8, tf = EK.fused_add_ln(_t(y), _t(r), _t(gb), _t(scal), eps=1e-12,
                             res_quant=res_quant)
    assert EK.LAUNCHES["fused_add_ln"] == 0  # CPU: the plain version
    assert t8.dtype == torch.int8 and tf.dtype == torch.float32
    diff = np.abs(t8.numpy().astype(np.int32) - j8.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, diff.max()
    np.testing.assert_array_equal(
        tf.numpy(), (scal[0, 6] * (t8.numpy().astype(np.float32)
                                   + scal[0, 7])))
    # JAX's float output is its own payload's value
    np.testing.assert_array_equal(
        jf, scal[0, 6] * (j8.astype(np.float32) + scal[0, 7]))


# ---------------------------------------------------------------------------
# The paths: generic W8A8 / leave-one-out, and the engine's non-payload route
# ---------------------------------------------------------------------------


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
                jbatch={k: jnp.asarray(v) for k, v in batch.items()})


def _qcfgs(bert, qd):
    """Both packages' W8A8 site configs with ``qd`` applied."""
    n = KW["num_hidden_layers"]
    return (JB.apply_bert_quant_dict(bert["jq"], qd, n),
            TB.apply_bert_quant_dict(
                TB.declare_bert_sites(TC.w8a8_defaults(), bert["tcfg"]), qd,
                n))


def _outputs_close(want, got, tq, ts, site="L1.ffn.ln.out"):
    """Logits within rtol 1e-3 / atol 2e-3; sequence_output within one
    level of its (the last ffn.ln.out) grid on at most 1% of elements,
    equal elsewhere, or within 1e-5 where that site is disabled."""
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), rtol=RTOL,
                               atol=ATOL)
    ws = np.asarray(want["sequence_output"])
    gs = got["sequence_output"].numpy()
    assert gs.shape == ws.shape and np.isfinite(gs).all()
    diff = np.abs(gs - ws)
    if not tq[site].enabled:
        assert diff.max() <= 1e-5, diff.max()
        return
    step = float(TQ.scale_of(tq[site].spec, ts[site]["qp"]))
    assert diff.max() <= step * 1.001 + 1e-6, (diff.max(), step)
    assert (diff > 1e-6).mean() <= 0.01, (diff > 1e-6).mean()


# fused linears per forward: 6 a layer and the pooler (M = 8 sequences);
# a disabled x takes inter off, a disabled z the next layer's q / k / v
# and the pooler
GENERIC = {"w8a8": ({}, 13), "x-fp32": ({"x": "fp32"}, 11),
           "z-fp32": ({"z": "fp32"}, 9)}


@pytest.mark.parametrize("name", sorted(GENERIC))
def test_generic_fused_path_matches_jax(bert, name, monkeypatch):
    """bert_apply(fused_linear=True) against JAX bert_apply(use_pallas=True)
    in interpret mode, and against the port's own int path. The kernel's
    tile rule sends the classifier (N=2) to the int path, where JAX runs
    it through the kernel too: its input is the pooler's folded output,
    already on its grid, so the quotient and the reciprocal product round
    to the same levels there."""
    qd, n_fused = GENERIC[name]
    jq, tq = _qcfgs(bert, qd)
    want, _ = JB.bert_apply(bert["jp"], bert["jbatch"], bert["jcfg"], jq,
                            bert["js"], JMode(), int_params=bert["jint"],
                            use_pallas=True)
    calls = []
    real = TIM.fused_int8_linear_ref
    monkeypatch.setattr(TIM, "fused_int8_linear_ref",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    args = (bert["tp"], bert["batch"], bert["tcfg"], tq, bert["ts"])
    got, _ = TB.bert_apply(*args, int_params=bert["tint"], fused_linear=True,
                           device="cpu")
    assert len(calls) == n_fused  # every fused layer but the classifier
    _outputs_close(want, got, tq, bert["ts"])
    # the same path with the plain version asked for, and the int path
    plain, _ = TB.bert_apply(*args, int_params=bert["tint"],
                             fused_linear="plain", device="cpu")
    np.testing.assert_array_equal(plain["logits"].numpy(),
                                  got["logits"].numpy())
    intp, _ = TB.bert_apply(*args, int_params=bert["tint"], device="cpu")
    np.testing.assert_allclose(got["logits"].numpy(),
                               intp["logits"].numpy(), rtol=1e-4, atol=1e-5)


ENGINE = {"g-fp32": ({"g": "fp32"}, ((False, True), (False, True))),
          "h-fp32": ({"h": "fp32"}, ((True, False), (True, False))),
          "h1-fp32": ({"h1": "fp32"}, ((True, True), (True, False)))}


@pytest.mark.parametrize("name", sorted(ENGINE))
def test_non_payload_route_matches_jax_engine(bert, name):
    """A disabled fold site builds, takes the non-payload residual route
    over the whole stack (one per-layer key is enough) and matches the JAX
    engine (XLA backend); plan flags equal JAX's."""
    qd, fold = ENGINE[name]
    jq, tq = _qcfgs(bert, qd)
    jst, jplan, _ = JB.build_bert_engine(bert["jp"], bert["jcfg"], jq,
                                         bert["js"], int_params=bert["jint"])
    want = jax.jit(lambda p, b, s, plan, ip: JB.bert_engine_apply(
        p, b, bert["jcfg"], jq, s, jst, plan, ip, backend="xla"))(
        bert["jp"], bert["jbatch"], bert["js"], jplan, bert["jint"])
    tst, tplan, tint = TB.build_bert_engine(bert["tp"], bert["tcfg"], tq,
                                            bert["ts"], device="cpu")
    assert tst.fold == jst.fold == fold
    assert tst.res_quant == jst.res_quant
    assert tst.flex == jst.flex and tst.io == jst.io
    assert not any(tst.int8_layer)
    flat_j = jax.tree_util.tree_leaves_with_path(_np(jplan))
    flat_t = dict(jax.tree_util.tree_leaves_with_path(tplan))
    assert len(flat_j) == len(flat_t)
    for path, v in flat_j:
        np.testing.assert_array_equal(flat_t[path].numpy(), v,
                                      err_msg=str(path))
    args = (bert["tp"], bert["batch"], bert["tcfg"], tq, bert["ts"], tst,
            tplan, tint)
    EK.reset_launches()
    got = TB.bert_engine_apply(*args, device="cpu")
    assert set(EK.LAUNCHES.values()) == {0}  # CPU tensors: plain versions
    _outputs_close(want, got, tq, bert["ts"])
    plain = TB.bert_engine_apply(*args, backend="plain", device="cpu")
    np.testing.assert_array_equal(plain["logits"].numpy(),
                                  got["logits"].numpy())


@pytest.mark.parametrize("qd", [{"x": "fp32"}, {"z": "fp32"}],
                         ids=["x-fp32", "z-fp32"])
def test_engine_refuses_leave_one_out_edges_as_jax(bert, qd):
    """A disabled x or z site is an edge the engine needs: both packages
    refuse it (EngineIncompatible), and the generic path serves it."""
    jq, tq = _qcfgs(bert, qd)
    with pytest.raises(JENG.EngineIncompatible):
        JB.build_bert_engine(bert["jp"], bert["jcfg"], jq, bert["js"],
                             int_params=bert["jint"])
    with pytest.raises(TENG.EngineIncompatible):
        TB.build_bert_engine(bert["tp"], bert["tcfg"], tq, bert["ts"],
                             device="cpu")
