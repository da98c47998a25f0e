"""Port parity: the engine kernels' plain versions against the JAX oracles.

Each plain version in ``transformer_quantization_tpu_torch.ops.kernels``
is held against its JAX ``*_ref`` on the same inputs: the layer-0 plan and
payloads of a tiny calibrated BERT (the config of tests/test_engine.py),
carried across as numpy arrays. Tolerances:

- int32 accumulators and matmul payloads without an activation: exact;
- payloads after a transcendental or a reduction (tanh / exp2 / rsqrt,
  softmax and LayerNorm sums): at most one level off on at most 0.1% of
  elements (the JAX and torch CPU kernels differ by ulps there).

The composed wrappers run their plain versions on CPU tensors and must
equal the plain whole-layer version bit for bit; the whole layer is also
held against the Pallas kernel in interpret mode, as the JAX package's
own tests run it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as G
from transformer_quantization_tpu.models import bert as JB
from transformer_quantization_tpu.ops.pallas import engine_kernels as JEK
from transformer_quantization_tpu.ops.pallas.int_matmul import _ACTS as J_ACTS
from transformer_quantization_tpu.quant.qconfig import QuantMode as JMode
from transformer_quantization_tpu_torch.ops.int_linear import (
    exact_int_matmul,
    unpack_int4,
)
from transformer_quantization_tpu_torch.ops.kernels import engine_kernels as EK
from transformer_quantization_tpu_torch.ops.kernels.activations import ACTS

torch.set_num_threads(2)

LEVEL_TOL, FRAC_TOL = 1, 1e-3


def _t(a):
    return torch.from_numpy(np.array(a))


def _payload_close(want, got, exact):
    """int8 payloads: equal, or (not ``exact``) one level off on at most
    0.1% of elements."""
    want = np.asarray(want).astype(np.int32)
    got = got.numpy().astype(np.int32)
    assert want.shape == got.shape
    diff = np.abs(want - got)
    if exact:
        np.testing.assert_array_equal(got, want)
    assert diff.max() <= LEVEL_TOL, diff.max()
    assert (diff > 0).mean() <= FRAC_TOL, (diff > 0).mean()


@pytest.fixture(scope="module")
def layer0():
    """Layer-0 engine plan and payloads of the tiny calibrated BERT."""
    cfg = JB.BertConfig(vocab_size=128, hidden_size=64, num_hidden_layers=2,
                        num_attention_heads=4, intermediate_size=128,
                        max_position_embeddings=64, num_labels=2)
    params, qcfg, qstate = G._calibrated_bert(cfg, batch_size=2, seq=16)
    static, plan, int_params = JB.build_bert_engine(params, cfg, qcfg, qstate)
    rng = np.random.RandomState(1)
    mask = (np.arange(16)[None, :] < rng.randint(8, 17, (4, 1))).astype(
        np.float32)
    batch = {"input_ids": jnp.asarray(rng.randint(0, 128, (4, 16)),
                                      jnp.int32),
             "attention_mask": jnp.asarray(mask)}
    ctx = JB.make_ctx(qcfg, qstate, JMode(), int_params=int_params)
    ids, tt, pos, _ = JB.prepare_inputs(batch)
    h = JB._embeddings(ctx, params, cfg, ids, tt, pos, False, None)
    es = plan["entry_scal"]
    x8 = JEK.quantize_payload(h.reshape(64, 64), es[0, 0], es[0, 1])
    lp = plan["layers"][0]
    bias = jnp.asarray((1.0 - mask) * -10000.0)
    akw = dict(n_heads=4, seq=16, skip_max=static.attn_skip_max)
    qkv8 = JEK.int8_matmul_ref(x8, lp["qkv"]["w"], lp["qkv"]["vecs"],
                               lp["qkv"]["scal"])
    c8 = JEK.int8_attention_ref(qkv8, bias, lp["attn_scal"], **akw)
    y8 = JEK.int8_matmul_ref(c8, lp["attn_out"]["w"], lp["attn_out"]["vecs"],
                             lp["attn_out"]["scal"])
    hx8 = JEK.int8_matmul_add_ln_ref(
        c8, lp["attn_out"]["w"], lp["attn_out"]["vecs"],
        lp["attn_out"]["scal"], x8, lp["ln1"]["gb"], lp["ln1"]["scal"],
        eps=static.ln_eps)
    i8 = JEK.int8_matmul_ref(hx8, lp["inter"]["w"], lp["inter"]["vecs"],
                             lp["inter"]["scal"], activation="gelu_new")
    j = dict(x8=x8, bias=bias, qkv8=qkv8, c8=c8, y8=y8, hx8=hx8, i8=i8)
    t = {k: _t(v) for k, v in j.items()}
    tplan = jax.tree.map(_t, plan)
    return dict(static=static, jplan=plan, tplan=tplan, j=j, t=t, akw=akw,
                lp=lp, tlp=tplan["layers"][0])


def test_payload_helpers_exact():
    rng = np.random.RandomState(0)
    x = (rng.randn(50, 24) * 0.7).astype(np.float32)
    s, sh = np.float32(0.0123), np.float32(7.0)
    _payload_close(JEK.quantize_payload(x, s, sh),
                   EK.quantize_payload(_t(x), _t(s), _t(sh)), exact=True)
    p = rng.randint(-128, 128, (50, 24)).astype(np.int8)
    np.testing.assert_array_equal(
        np.asarray(JEK.dequantize_payload(p, s, sh)),
        EK.dequantize_payload(_t(p), _t(s), _t(sh)).numpy())
    np.testing.assert_array_equal(
        np.asarray(JEK.fakequant_f32(x, s, sh)),
        EK.fakequant_f32(_t(x), _t(s), _t(sh)).numpy())


@pytest.mark.parametrize("name", ["gelu", "gelu_new", "gelu_poly10", "tanh",
                                  "relu"])
def test_activation_copies(name):
    x = (np.random.RandomState(1).randn(4096) * 3).astype(np.float32)
    want = np.asarray(J_ACTS[name](jnp.asarray(x)))
    got = ACTS[name](_t(x)).numpy()
    if name in ("gelu_poly10", "relu"):
        np.testing.assert_array_equal(got, want)  # no transcendental
        return
    # XLA's and PyTorch's tanh / exp differ by ulps: a relative 1e-6. As
    # x -> -inf, 1 + tanh(u) and 1 + erf(z) cancel, so the gelus' error
    # there is absolute: a few float32 steps below 1 times |x| / 2. XLA's
    # tanh saturates to -1 at u = -7.9, where PyTorch's is still 4.5 steps
    # (2.7e-7) above it: |x| * 2^-23 at x = -4.87 on these inputs, so the
    # bound there is |x| * 2^-22
    cancel = (np.abs(x) * 2.0 ** -22 * (x < 0) if name != "tanh"
              else np.zeros_like(x))
    diff = np.abs(got.astype(np.float64) - want)
    bad = diff > 1e-6 * np.abs(want) + cancel
    if bad.any():
        # which side drifted: both against float64 of the same formula
        ref = ACTS[name](torch.from_numpy(x.astype(np.float64))).numpy()
        pytest.fail(f"{bad.sum()} of {x.size} elements off (x in "
                    f"[{x[bad].min():.3g}, {x[bad].max():.3g}], max diff "
                    f"{diff.max():.3g}); against float64: JAX "
                    f"{np.abs(want - ref).max():.3g}, torch "
                    f"{np.abs(got - ref).max():.3g}")


@pytest.mark.parametrize("name,xin,act", [
    ("qkv", "x8", None), ("attn_out", "c8", None),
    ("inter", "hx8", "gelu_new"), ("dense", "i8", None)])
@pytest.mark.parametrize("out_mode", ["emit", "fold", "float"])
def test_int8_matmul_ref(layer0, name, xin, act, out_mode):
    lp, tlp = layer0["lp"][name], layer0["tlp"][name]
    want = JEK.int8_matmul_ref(layer0["j"][xin], lp["w"], lp["vecs"],
                               lp["scal"], activation=act, out_mode=out_mode)
    got = EK.int8_matmul_ref(layer0["t"][xin], tlp["w"], tlp["vecs"],
                             tlp["scal"], activation=act, out_mode=out_mode)
    if out_mode == "emit":
        _payload_close(want, got, exact=act is None)
    elif act is None:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=float(lp["vecs"][3, 0]) * 1.000001)


def test_int32_accumulator_exact(layer0):
    x8, w = layer0["j"]["x8"], layer0["lp"]["qkv"]["w"]
    want = jax.lax.dot_general(x8, w, (((1,), (1,)), ((), ())),
                               preferred_element_type=jnp.int32)
    got = exact_int_matmul(layer0["t"]["x8"], layer0["tlp"]["qkv"]["w"])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("skip_max", [True, False])
def test_int8_attention_ref(layer0, skip_max):
    akw = dict(layer0["akw"], skip_max=skip_max)
    want = JEK.int8_attention_ref(layer0["j"]["qkv8"], layer0["j"]["bias"],
                                  layer0["lp"]["attn_scal"], **akw)
    got = EK.int8_attention_ref(layer0["t"]["qkv8"], layer0["t"]["bias"],
                                layer0["tlp"]["attn_scal"], **akw)
    _payload_close(want, got, exact=False)


@pytest.mark.parametrize("res_quant", [True, False])
def test_fused_add_ln_payload_ref(layer0, res_quant):
    lp, tlp = layer0["lp"], layer0["tlp"]
    eps = layer0["static"].ln_eps
    want = JEK.fused_add_ln_payload_ref(layer0["j"]["y8"], layer0["j"]["x8"],
                                        lp["ln1"]["gb"], lp["ln1"]["scal"],
                                        eps=eps, res_quant=res_quant)
    got = EK.fused_add_ln_payload_ref(layer0["t"]["y8"], layer0["t"]["x8"],
                                      tlp["ln1"]["gb"], tlp["ln1"]["scal"],
                                      eps=eps, res_quant=res_quant)
    _payload_close(want, got, exact=False)


def test_int8_matmul_add_ln_ref(layer0):
    lp, tlp, eps = layer0["lp"], layer0["tlp"], layer0["static"].ln_eps
    a = lp["attn_out"]
    want = JEK.int8_matmul_add_ln_ref(layer0["j"]["c8"], a["w"], a["vecs"],
                                      a["scal"], layer0["j"]["x8"],
                                      lp["ln1"]["gb"], lp["ln1"]["scal"],
                                      eps=eps)
    ta = tlp["attn_out"]
    got = EK.int8_matmul_add_ln_ref(layer0["t"]["c8"], ta["w"], ta["vecs"],
                                    ta["scal"], layer0["t"]["x8"],
                                    tlp["ln1"]["gb"], tlp["ln1"]["scal"],
                                    eps=eps)
    _payload_close(want, got, exact=False)


def _ffn_args(plan, hx8):
    return (hx8, plan["inter"]["w"], plan["inter"]["vecs"],
            plan["inter"]["scal"], plan["dense"]["w"], plan["dense"]["vecs"],
            plan["dense"]["scal"], hx8, plan["ln2"]["gb"], plan["ln2"]["scal"])


def test_int8_ffn_ln_ref(layer0):
    eps = layer0["static"].ln_eps
    want = JEK.int8_ffn_ln_ref(*_ffn_args(layer0["lp"], layer0["j"]["hx8"]),
                               activation="gelu_new", eps=eps)
    got = EK.int8_ffn_ln_ref(*_ffn_args(layer0["tlp"], layer0["t"]["hx8"]),
                             activation="gelu_new", eps=eps)
    _payload_close(want, got, exact=False)


def _layer_args(plan, x8, bias):
    return (x8, plan["qkv"]["w"], plan["qkv"]["vecs"], plan["qkv"]["scal"],
            bias, plan["attn_scal"], plan["attn_out"]["w"],
            plan["attn_out"]["vecs"], plan["attn_out"]["scal"],
            plan["ln1"]["gb"], plan["ln1"]["scal"], plan["inter"]["w"],
            plan["inter"]["vecs"], plan["inter"]["scal"], plan["dense"]["w"],
            plan["dense"]["vecs"], plan["dense"]["scal"], plan["ln2"]["gb"],
            plan["ln2"]["scal"])


def _layer_kw(layer0):
    st = layer0["static"]
    return dict(n_heads=4, seq=16, eps=st.ln_eps, activation="gelu_new",
                res1=st.res_quant[0][0], res2=st.res_quant[0][1],
                skip_max=st.attn_skip_max)


def test_int8_layer_ln_ref(layer0):
    want = JEK.int8_layer_ln_ref(
        *_layer_args(layer0["lp"], layer0["j"]["x8"], layer0["j"]["bias"]),
        **_layer_kw(layer0))
    got = EK.int8_layer_ln_ref(
        *_layer_args(layer0["tlp"], layer0["t"]["x8"], layer0["t"]["bias"]),
        **_layer_kw(layer0))
    _payload_close(want, got, exact=False)


def test_composed_wrappers_equal_plain_layer_on_cpu(layer0):
    """The kernel chain's wiring, run on its plain versions: bit-identical
    to the plain whole layer, and no kernel launch counted."""
    EK.reset_launches()
    args = _layer_args(layer0["tlp"], layer0["t"]["x8"], layer0["t"]["bias"])
    want = EK.int8_layer_ln_ref(*args, **_layer_kw(layer0))
    got = EK.int8_layer_ln(*args, **_layer_kw(layer0))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    tlp, eps = layer0["tlp"], layer0["static"].ln_eps
    np.testing.assert_array_equal(
        EK.int8_ffn_ln(*_ffn_args(tlp, layer0["t"]["hx8"]),
                       activation="gelu_new", eps=eps).numpy(),
        EK.int8_ffn_ln_ref(*_ffn_args(tlp, layer0["t"]["hx8"]),
                           activation="gelu_new", eps=eps).numpy())
    assert set(EK.LAUNCHES.values()) == {0}


def test_fold_site_scalars_match_ln_plan(layer0):
    """The chain's add+LN reads [y_s, y_sh] from the producing matmul's
    vecs rows 3/4; in the W8A8 plan they equal ln_scal[0, 0:2]."""
    for lp in layer0["tplan"]["layers"]:
        for mm, ln in (("attn_out", "ln1"), ("dense", "ln2")):
            vecs = lp[mm]["vecs"]
            assert torch.equal(vecs[3], vecs[3, :1].expand_as(vecs[3]))
            assert torch.equal(vecs[4], vecs[4, :1].expand_as(vecs[4]))
            assert torch.equal(EK.fold_ln_scalars(vecs, lp[ln]["scal"]),
                               lp[ln]["scal"])


def test_int8_layer_ln_against_pallas_interpret(layer0):
    """The port's composed layer against the JAX whole-layer Pallas kernel
    in interpret mode (the kernel's own fold multiplies by 1/out_s where
    the oracles divide, so it may sit one level off on rare elements)."""
    want = JEK.int8_layer_ln(
        *_layer_args(layer0["lp"], layer0["j"]["x8"], layer0["j"]["bias"]),
        interpret=True, **_layer_kw(layer0))
    got = EK.int8_layer_ln(
        *_layer_args(layer0["tlp"], layer0["t"]["x8"], layer0["t"]["bias"]),
        **_layer_kw(layer0))
    _payload_close(want, got, exact=False)


def test_unported_modes_raise(layer0):
    tlp = layer0["tlp"]["qkv"]
    x8 = layer0["t"]["x8"]
    # w4 computes on the packed int4 weight (tests/test_torch_int4.py);
    # K4's w4 form is not ported
    wp = tlp["w"][:, ::2].contiguous().view(torch.uint8)  # any nibbles
    np.testing.assert_array_equal(
        EK.int8_matmul_ref(x8, wp, tlp["vecs"], tlp["scal"],
                           w4=True).numpy(),
        EK.int8_matmul_ref(x8, unpack_int4(wp, x8.shape[1]), tlp["vecs"],
                           tlp["scal"]).numpy())
    with pytest.raises(NotImplementedError, match="not yet ported"):
        EK.int8_matmul_ref(x8.float(), tlp["w"], tlp["vecs"], tlp["scal"],
                           w4=True, in_mode="f", in_grid={})
    args = _layer_args(layer0["tplan"]["layers"][0], x8, layer0["t"]["bias"])
    kw = dict(n_heads=4, seq=16, eps=layer0["static"].ln_eps)
    # value-space q / k / v, float layer inputs and 16-bit or disabled
    # attention sites are ported (tests/test_torch_flex_edges.py holds
    # them against JAX); modes outside the JAX package's still raise
    out = EK.int8_attn_ln_ref(*args[:11], qkv_mode="f", qkv_bits=16, **kw)
    assert out.dtype == torch.int8 and out.shape == x8.shape
    for mode in ("qkv_mode", "in_mode"):
        with pytest.raises(ValueError, match=f"unknown {mode}"):
            EK.int8_attn_ln_ref(*args[:11], **{mode: "f16"}, **kw)
        with pytest.raises(ValueError, match=f"unknown {mode}"):
            EK.int8_attn_ln(*args[:11], **{mode: "f16"}, **kw)
    c8 = EK.int8_attention_ref(layer0["t"]["qkv8"], layer0["t"]["bias"],
                               layer0["tlp"]["attn_scal"], n_heads=4, seq=16,
                               attn_bits=(16, 8, 8))
    assert c8.dtype == torch.int8
    with pytest.raises(ValueError, match="1-16 bits or disabled"):
        EK.int8_attention_ref(layer0["t"]["qkv8"], layer0["t"]["bias"],
                              layer0["tlp"]["attn_scal"], n_heads=4, seq=16,
                              attn_bits=(8, 17, 8))


def _rn32(x):
    """The float32 nearest to the rational ``x`` (ties to even), exactly."""
    from fractions import Fraction
    if x == 0:
        return 0.0
    sign, x = (-1.0 if x < 0 else 1.0), abs(x)
    e = x.numerator.bit_length() - x.denominator.bit_length()
    e += (Fraction(2) ** (e + 1) <= x) - (Fraction(2) ** e > x)
    m = x * Fraction(2) ** (23 - e)
    n, rem = divmod(m.numerator, m.denominator)
    if 2 * rem > m.denominator or (2 * rem == m.denominator and n % 2):
        n += 1
    return sign * float(Fraction(n) * Fraction(2) ** (e - 23))


def test_rint_div_fma_matches_the_ieee_quotient():
    """K1's epilogue rounds ``y / s`` as ``rint_div_fma`` (mm_common.cuh):
    ``q0 = y * inv`` (``inv`` the IEEE ``1 / s``) and two corrections
    ``q + (y - s q) * inv``, each an fma, for the IEEE quotient without a
    division. Its arithmetic, emulated exactly with rationals, against the
    IEEE quotient on values within a few ulps of half-integer quotients
    (where ``rint(y * inv)`` alone is wrong) and on plain values: equal,
    so ``rint`` of both is equal."""
    from fractions import Fraction as F
    rng = np.random.RandomState(5)
    f32 = lambda v: float(np.float32(v))
    fma = lambda a, b, c: _rn32(F(a) * F(b) + F(c))
    naive_wrong = 0
    for i in range(4000):
        s = f32(10 ** rng.uniform(-4, 0.5))
        inv = _rn32(1 / F(s))
        if i % 2:
            y = np.float32((rng.randint(-300, 300) + 0.5) * s)
            for _ in range(rng.randint(0, 4)):
                y = np.nextafter(y, np.float32(np.inf if rng.rand() < .5
                                               else -np.inf))
            y = float(y)
        else:
            y = f32(rng.uniform(-50, 50) * s)
        want = _rn32(F(y) / F(s))
        q0 = _rn32(F(y) * F(inv))
        q = fma(fma(-s, q0, y), inv, q0)
        q = fma(fma(-s, q, y), inv, q)
        assert q == want, (y, s)
        naive_wrong += round(q0) != round(want)
    assert naive_wrong > 0   # the cases exercise the correction
