"""Port parity for W4A8: split-half packed int4 weights through the int
matmul's plain version, the fused linear, the int path's linear, BERT's
engine and generic path, ``convert.py`` and the checkpoint directory.

Inputs are made with numpy from a seed and handed to both packages; the
models are the tiny BERT of tests/test_engine.py (2 layers, H=64),
calibrated by the JAX package with current-minmax 4-bit symmetric weights
and 8-bit activations (``test_w4a8_engine_megakernels_interpret_matches_
xla``'s recipe). The kernel's main loop is emulated on the CPU: the
stage decomposition and the nibble arithmetic of ``csrc/wgmma_gemm.cuh``
(kW4), including the ragged last packed box.

Tolerances:
- packing, unpacking, the W4A32 dequantized weight, the engine plan: bit
  for bit;
- the int matmul (``int8_matmul_ref(w4=True)``) against the JAX kernel in
  interpret mode, on power-of-two scales and integer shifts (every float
  step exact, so no rounding order shows): equal payloads and values
  without an activation or with relu; after gelu_new (XLA's and
  PyTorch's tanh differ by ulps) payloads at most one level apart on at
  most 1% of elements, folded values one grid step, floats rtol 1e-5;
- the fused linear against the JAX kernel in interpret mode: as
  tests/test_torch_fused_linear.py (levels equal without a
  transcendental; one level on at most 1% after one; float outputs rtol
  1e-6 / 1e-5);
- logits: rtol 1e-3 / atol 2e-3 (tests/test_engine.py's bound).
"""

import dataclasses

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
from transformer_quantization_tpu.utils import checkpoint as JCK
from transformer_quantization_tpu_torch import convert as C
from transformer_quantization_tpu_torch.models import bert as TB
from transformer_quantization_tpu_torch.ops import engine as TENG
from transformer_quantization_tpu_torch.ops import int_linear as TIL
from transformer_quantization_tpu_torch.ops.kernels import engine_kernels as EK
from transformer_quantization_tpu_torch.ops.kernels import int_matmul as TIM
from transformer_quantization_tpu_torch.quant import quantizers as TQ
from transformer_quantization_tpu_torch.quant.qconfig import QuantMode
from transformer_quantization_tpu_torch.training import calibration as TC
from transformer_quantization_tpu_torch.utils import checkpoint as TCK

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


def _w4_spec():
    return (JQ.QuantizerSpec(n_bits=4, method=JQ.QMethod.symmetric_uniform),
            TQ.QuantizerSpec(n_bits=4, method=TQ.QMethod.symmetric_uniform))


def _packed_pair(w, per_channel, lo=None, hi=None):
    """Both packages' int4 packing of the float (O, I) ``w``, its range
    from ``w`` or the given ``lo`` / ``hi``."""
    jspec, tspec = _w4_spec()
    red = dict(axis=1) if per_channel else {}
    lo = jnp.min(w, **red) if lo is None else jnp.asarray(lo)
    hi = jnp.max(w, **red) if hi is None else jnp.asarray(hi)
    qp = JQ.set_quant_range(jspec, lo, hi)
    return (JIL.pack_weight_int4(jspec, qp, jnp.asarray(w)),
            TIL.pack_weight_int4(tspec, _tqp(qp), _t(w)))


# (O, I, per-channel, range shrunk so that levels clip at -8 / 7)
PACK_CASES = {"per-tensor": (24, 64, False, 1.0),
              "per-channel": (24, 64, True, 1.0),
              "clipped": (16, 32, False, 0.4),
              "odd-half": (8, 18, True, 1.0)}


@pytest.mark.parametrize("case", sorted(PACK_CASES))
def test_pack_and_unpack_match_jax(case):
    o, i, pc, shrink = PACK_CASES[case]
    rng = np.random.RandomState(3)
    w = rng.normal(0, 0.1, (o, i)).astype(np.float32)
    lo = hi = None
    if shrink != 1.0:
        lo, hi = shrink * w.min(), shrink * w.max()
    jp, tp = _packed_pair(w, pc, lo, hi)
    assert set(tp) == set(jp)
    assert tp["n_bits"] == 4 and tp["in_features"] == i == jp["in_features"]
    assert tp["w_packed"].dtype == torch.uint8
    for k in ("w_packed", "scale", "colsum"):
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]), k)
    lv = TIL.unpack_int4(tp["w_packed"], i)
    np.testing.assert_array_equal(
        lv.numpy(), np.asarray(JIL.unpack_int4(jp["w_packed"], i)))
    if shrink != 1.0:
        assert lv.min() == -8 and lv.max() == 7
    # the W4A32 weight-only form
    np.testing.assert_array_equal(
        TIL.dequantize_packed_weight(tp).numpy(),
        np.asarray(JIL.dequantize_packed_weight(jp)))


def test_int8_linear_on_int4_matches_jax():
    rng = np.random.RandomState(4)
    w = rng.normal(0, 0.1, (24, 64)).astype(np.float32)
    x = (rng.randn(2, 8, 64) * 1.5).astype(np.float32)
    b = rng.normal(0, 0.1, (24,)).astype(np.float32)
    jp, tp = _packed_pair(w, True)
    aspec = JQ.QuantizerSpec(n_bits=8, method=JQ.QMethod.asymmetric_uniform)
    tspec = TQ.QuantizerSpec(n_bits=8, method=TQ.QMethod.asymmetric_uniform)
    iqp = JQ.set_quant_range(aspec, jnp.min(x), jnp.max(x))
    jx8, js, jsh = JIL.quantize_activation_int8(aspec, iqp, jnp.asarray(x))
    tx8, ts, tsh = TIL.quantize_activation_int8(tspec, _tqp(iqp), _t(x))
    np.testing.assert_array_equal(tx8.numpy(), np.asarray(jx8))
    want = JIL.int8_linear(jx8, js, jsh, jp, jnp.asarray(b))
    got = TIL.int8_linear(tx8, ts, tsh, tp, _t(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def _matmul_inputs(m=16, k=64, n=40, seed=5):
    """An int8 payload, a packed int4 weight (both packages' layout, made
    by the JAX packer) and epilogue rows whose every float step is exact:
    power-of-two scales, integer shifts and column sums, biases on a 2^-6
    grid."""
    rng = np.random.RandomState(seed)
    x8 = rng.randint(-128, 128, (m, k)).astype(np.int8)
    w = rng.normal(0, 0.1, (n, k)).astype(np.float32)
    jp, _ = _packed_pair(w, False)
    lv = np.asarray(JIL.unpack_int4(jp["w_packed"], k)).astype(np.float32)
    vecs = np.stack([np.full(n, 2.0 ** -9, np.float32), lv.sum(1),
                     rng.randint(-64, 64, n).astype(np.float32) / 64,
                     np.full(n, 2.0 ** -2, np.float32),
                     rng.randint(-4, 5, n).astype(np.float32)])
    scal = np.array([[2.0 ** -3, 5.0]], np.float32)
    return x8, np.asarray(jp["w_packed"]), vecs, scal


MM_CASES = [(act, mode) for act in (None, "relu", "gelu_new")
            for mode in ("emit", "fold", "float")]


@pytest.mark.parametrize("act,mode", MM_CASES,
                         ids=[f"{a}-{m}" for a, m in MM_CASES])
def test_int8_matmul_w4_matches_jax_kernel(act, mode):
    x8, wp, vecs, scal = _matmul_inputs()
    j_args = tuple(jnp.asarray(a) for a in (x8, wp, vecs, scal))
    kw = dict(activation=act, out_mode=mode)
    want = np.asarray(JEK.int8_matmul(*j_args, w4=True, interpret=True,
                                      **kw))
    EK.reset_launches()
    got = EK.int8_matmul(*(_t(a) for a in (x8, wp, vecs, scal)), w4=True,
                         **kw).numpy()
    assert set(EK.LAUNCHES.values()) == {0}  # CPU: the plain version
    # the port's product on the unpacked weight: the same bits
    lv = TIL.unpack_int4(_t(wp), x8.shape[1])
    np.testing.assert_array_equal(
        got, EK.int8_matmul_ref(_t(x8), lv, _t(vecs), _t(scal), **kw).numpy())
    # the JAX kernel and the JAX oracle
    oracle = np.asarray(JEK.int8_matmul_ref(*j_args, w4=True, **kw))
    for ref in (want, oracle):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        if act != "gelu_new":
            np.testing.assert_array_equal(got, ref)
        elif mode == "float":
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
        else:
            step = 1.0 if mode == "emit" else float(vecs[3, 0])
            diff = np.abs(got.astype(np.float64) - ref.astype(np.float64))
            assert diff.max() <= step * (1 + 1e-6), diff.max()
            assert (diff > 0).mean() <= 0.01, (diff > 0).mean()


def test_w4_raises_where_the_port_has_no_w4_form():
    """K4 (a float value edge into the matmul) keeps its int8-only contract
    (ROADMAP section 2a); MobileBERT's K8 takes packed int4 weights but a
    packed K of 384 (tests/test_torch_mobilebert_w4.py), which it
    refuses."""
    x8, wp, vecs, scal = (_t(a) for a in _matmul_inputs())
    with pytest.raises(NotImplementedError, match="not yet ported"):
        EK.int8_matmul_ref(x8.float(), wp, vecs, scal, w4=True, in_mode="f",
                           in_grid={})
    kw = dict(seq=128, head_dim=32, n_heads=4, inter=512,
              attn_case="bottleneck", activation="relu", n_ffn=3,
              attn_bits=(8, 8, 8), w4=(True,) * 13)
    assert EK.mb_layer_refusal(h=512, **kw) is None
    assert "w4" in EK.mb_layer_refusal(h=384, **kw)


HI = np.uint32(0xF0F0F0F0)


@pytest.mark.parametrize("k", [768, 800, 864, 96])
def test_w4_main_loop_emulation(k):
    """The kW4 main loop on the CPU: stage kt loads x's columns 64 kt..
    and K/2 + 64 kt.. (zeros past K) and the packed columns 64 kt.. (zeros
    past K/2), unpacks the packed words as ``unpack_w4`` does (each nibble
    in the high half of its byte, an int8 of 16 w: lo ``(v << 4) & 0xF0..``,
    hi ``v & 0xF0..``) and sums both halves' products; over ceil(K / 128)
    stages that is 16 x @ unpack_int4(w)^T, and its arithmetic shift right
    by 4 the product exactly, ragged last box included (K/2 % 64 != 0 at
    800 and 864)."""
    rng = np.random.RandomState(k)
    m, n = 8, 16
    x = rng.randint(-128, 128, (m, k)).astype(np.int64)
    wp = rng.randint(0, 256, (n, k // 2)).astype(np.uint8)
    k2 = k // 2
    xz = np.zeros((m, k + 128), np.int64)
    xz[:, :k] = x
    pz = np.zeros((n, k2 + 64), np.uint8)
    pz[:, :k2] = wp
    acc = np.zeros((m, n), np.int64)
    for kt in range(-(-k // 128)):
        c0 = 64 * kt
        xa, xb = xz[:, c0:c0 + 64], xz[:, k2 + c0:k2 + c0 + 64]
        words = pz[:, c0:c0 + 64].copy().view(np.uint32)  # little-endian
        lo = ((words << np.uint32(4)) & HI).view(np.int8).reshape(
            n, 64).astype(np.int64)
        hi = (words & HI).view(np.int8).reshape(n, 64).astype(np.int64)
        acc += xa @ lo.T + xb @ hi.T
    assert np.abs(acc).max() < 2 ** 31
    want = x @ TIL.unpack_int4(torch.from_numpy(wp), k).numpy().astype(
        np.int64).T
    np.testing.assert_array_equal(acc, 16 * want)
    np.testing.assert_array_equal(acc >> 4, want)


# (act, output site, input): the fused linear on a packed int4 weight
FL_CASES = [(None, "none", "f32"), ("gelu", "fold", "f32"),
            ("relu", "emit", "f32"), ("gelu_new", "none", "payload"),
            (None, "fold", "payload"), ("tanh", "emit", "payload")]


@pytest.mark.parametrize("act,out,inp", FL_CASES,
                         ids=[f"{a}-{o}-{i}" for a, o, i in FL_CASES])
def test_fused_linear_int4_matches_jax(act, out, inp):
    rng = np.random.RandomState(9)
    m, k, n = 16, 64, 24
    x = (rng.randn(m, k) * 1.5).astype(np.float32)
    w = rng.normal(0, 0.1, (n, k)).astype(np.float32)
    b = rng.normal(0, 0.1, (n,)).astype(np.float32)
    jp, tp = _packed_pair(w, True)
    aspec = JQ.QuantizerSpec(n_bits=8, method=JQ.QMethod.asymmetric_uniform)
    tspec = TQ.QuantizerSpec(n_bits=8, method=TQ.QMethod.asymmetric_uniform)
    iqp = JQ.set_quant_range(aspec, jnp.min(x), jnp.max(x))
    jx = jnp.asarray(x)
    if inp == "payload":
        jx = JIL.quantize_activation_int8(aspec, iqp, jx)[0]
    x8, s, sh = JIL.quantize_activation_int8(aspec, iqp, jnp.asarray(x))
    y = np.asarray(JIL.int8_linear(x8, s, sh, jp, jnp.asarray(b)))
    okw_j, okw_t = {}, {}
    if out != "none":
        oqp = JQ.set_quant_range(aspec, jnp.asarray(y.min()),
                                 jnp.asarray(y.max()))
        okw_j = dict(out_spec=aspec, out_qp=oqp, emit_int8=out == "emit")
        okw_t = dict(out_spec=tspec, out_qp=_tqp(oqp),
                     emit_int8=out == "emit")
    want = np.asarray(j_fused(jx, jp, aspec, iqp, bias=jnp.asarray(b),
                              activation=act, interpret=True, **okw_j))
    EK.reset_launches()
    got = TIM.fused_int8_linear(_t(jx), tp, tspec, _tqp(iqp), bias=_t(b),
                                activation=act, **okw_t).numpy()
    assert set(EK.LAUNCHES.values()) == {0}  # CPU: the plain version
    assert got.dtype == want.dtype and got.shape == want.shape
    # the same call on the unpacked weight: the int4 form changes nothing
    # but the weight's storage
    t8 = dict(tp, w_int=TIL.unpack_int4(tp["w_packed"], k))
    del t8["w_packed"]
    np.testing.assert_array_equal(
        got, TIM.fused_int8_linear(_t(jx), t8, tspec, _tqp(iqp), bias=_t(b),
                                   activation=act, **okw_t).numpy())
    exact = act in (None, "relu")
    if out == "none":
        np.testing.assert_allclose(got, want, rtol=1e-6 if exact else 1e-5,
                                   atol=1e-6)
    elif exact:
        np.testing.assert_array_equal(got, want)
    else:
        step = 1.0 if out == "emit" else float(TQ.scale_of(
            tspec, okw_t["out_qp"]))
        diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
        assert diff.max() <= step * (1 + 1e-6), diff.max()
        assert (diff > 0).mean() <= 0.01, (diff > 0).mean()


def test_fused_linear_int4_acceptance():
    """The kernel reads packed rows of K/2 bytes at a 16-byte stride: K %
    32 == 0, else None (the caller's int path); a K that does not match
    the packed width, None."""
    rng = np.random.RandomState(2)
    tspec = TQ.QuantizerSpec(n_bits=8, method=TQ.QMethod.asymmetric_uniform)
    for k, ok in ((48, False), (64, True)):
        _, tp = _packed_pair(rng.normal(0, 0.1, (8, k)).astype(np.float32),
                             False)
        x = torch.from_numpy(rng.randn(8, k).astype(np.float32))
        qp = TQ.set_quant_range(tspec, x.min(), x.max())
        y = TIM.fused_int8_linear(x, tp, tspec, qp)
        assert (y is not None) == ok, k
        assert TIM.fused_int8_linear(x[:, :k - 16], tp, tspec, qp) is None


# ---------------------------------------------------------------------------
# W4A8 BERT: packing, the engine, the generic path, convert, checkpoints
# ---------------------------------------------------------------------------


def _d4_jax():
    return dataclasses.replace(G._w8a8_defaults(), n_bits=4, n_bits_act=8)


@pytest.fixture(scope="module")
def w4a8():
    jcfg, tcfg = JB.BertConfig(**KW), TB.BertConfig(**KW)
    jp, jq, js = G._calibrated_bert(jcfg, batch_size=2, seq=SEQ,
                                    defaults=_d4_jax())
    jint = jax.jit(lambda p, s: JB.build_bert_int_params(
        p, jq, s, use_int4=True))(jp, js)
    jst, jplan, _ = JB.build_bert_engine(jp, jcfg, jq, js, int_params=jint,
                                         use_int4=True)
    tq = TB.declare_bert_sites(dataclasses.replace(
        TC.w8a8_defaults(), n_bits=4, n_bits_act=8), tcfg)
    rng = np.random.RandomState(5)
    batch = {
        "input_ids": rng.randint(0, KW["vocab_size"], (4, SEQ)).astype(
            np.int32),
        "attention_mask": (np.arange(SEQ)[None, :]
                           < rng.randint(8, SEQ + 1, (4, 1))
                           ).astype(np.float32),
        "token_type_ids": np.zeros((4, SEQ), np.int32),
    }
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, jq=jq, js=js, jint=jint,
                jst=jst, jplan=jplan, tq=tq,
                tp=C.params_from_jax(_np(jp), device="cpu"),
                ts=C.qstate_from_jax(_np(js), device="cpu"), batch=batch,
                jbatch={k: jnp.asarray(v) for k, v in batch.items()})


def test_int4_params_pack_exactly(w4a8):
    tint = TB.build_bert_int_params(w4a8["tp"], w4a8["tq"], w4a8["ts"],
                                    use_int4=True)
    jint = _np(w4a8["jint"])
    assert set(tint) == set(jint)
    n4 = 0
    for name, p in jint.items():
        assert set(tint[name]) == set(p), name
        n4 += "w_packed" in p
        for k, v in p.items():
            if k in ("n_bits", "in_features"):
                assert tint[name][k] == v
            else:
                np.testing.assert_array_equal(tint[name][k].numpy(), v)
    # every linear (6 a layer, pooler, classifier) packs int4; the three
    # embedding tables stay int8
    assert n4 == 6 * KW["num_hidden_layers"] + 2
    assert "w_int" in tint["emb.word"] or "t_int" in tint["emb.word"]
    # convert.py carries JAX's int4 dict across as the port packs it
    conv = C.int_params_from_jax(jint, device="cpu")
    for name, p in tint.items():
        for k, v in p.items():
            if isinstance(v, torch.Tensor):
                assert conv[name][k].dtype == v.dtype, (name, k)
                assert torch.equal(conv[name][k], v), (name, k)
            else:
                assert conv[name][k] == v and isinstance(conv[name][k], int)


def test_w4a8_engine_matches_jax_engine(w4a8):
    cfg, q, st = w4a8["jcfg"], w4a8["jq"], w4a8["jst"]
    want = jax.jit(lambda p, b, s, plan, ip: JB.bert_engine_apply(
        p, b, cfg, q, s, st, plan, ip, backend="xla")["logits"])(
        w4a8["jp"], w4a8["jbatch"], w4a8["js"], w4a8["jplan"], w4a8["jint"])
    tst, tplan, tint = TB.build_bert_engine(w4a8["tp"], w4a8["tcfg"],
                                            w4a8["tq"], w4a8["ts"],
                                            use_int4=True, device="cpu")
    assert any(any(f) for f in tst.w4)  # int4 in play
    assert tst.w4 == st.w4 and tst.int8_layer == (True, True)
    flat_j = jax.tree_util.tree_leaves_with_path(_np(w4a8["jplan"]))
    flat_t = dict(jax.tree_util.tree_leaves_with_path(tplan))
    assert len(flat_j) == len(flat_t)
    for path, v in flat_j:
        assert flat_t[path].numpy().dtype == v.dtype, path
        np.testing.assert_array_equal(flat_t[path].numpy(), v,
                                      err_msg=str(path))
    EK.reset_launches()
    got = TB.bert_engine_apply(w4a8["tp"], w4a8["batch"], w4a8["tcfg"],
                               w4a8["tq"], w4a8["ts"], tst, tplan, tint,
                               device="cpu")["logits"]
    assert set(EK.LAUNCHES.values()) == {0}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    plain = TB.bert_engine_apply(w4a8["tp"], w4a8["batch"], w4a8["tcfg"],
                                 w4a8["tq"], w4a8["ts"], tst, tplan, tint,
                                 backend="plain", device="cpu")["logits"]
    np.testing.assert_array_equal(plain.numpy(), got.numpy())
    # JAX's int4 dict through convert.py drives the same engine
    conv = C.int_params_from_jax(_np(w4a8["jint"]), device="cpu")
    cst, cplan, _ = TB.build_bert_engine(w4a8["tp"], w4a8["tcfg"],
                                         w4a8["tq"], w4a8["ts"],
                                         int_params=conv, device="cpu")
    conv_logits = TB.bert_engine_apply(
        w4a8["tp"], w4a8["batch"], w4a8["tcfg"], w4a8["tq"], w4a8["ts"],
        cst, cplan, conv, device="cpu")["logits"]
    np.testing.assert_array_equal(conv_logits.numpy(), got.numpy())


def test_w4a8_non_payload_route_matches_jax_engine(w4a8):
    """A disabled ``ffn.dense.out`` (``{'h': 'fp32'}``) puts the stack on
    the non-payload route, which takes the w4 flags too."""
    jq = JB.apply_bert_quant_dict(w4a8["jq"], {"h": "fp32"},
                                  KW["num_hidden_layers"])
    tq = TB.apply_bert_quant_dict(w4a8["tq"], {"h": "fp32"},
                                  KW["num_hidden_layers"])
    jst, jplan, _ = JB.build_bert_engine(w4a8["jp"], w4a8["jcfg"], jq,
                                         w4a8["js"], int_params=w4a8["jint"])
    want = jax.jit(lambda p, b, s, plan, ip: JB.bert_engine_apply(
        p, b, w4a8["jcfg"], jq, s, jst, plan, ip, backend="xla")["logits"])(
        w4a8["jp"], w4a8["jbatch"], w4a8["js"], jplan, w4a8["jint"])
    tst, tplan, tint = TB.build_bert_engine(w4a8["tp"], w4a8["tcfg"], tq,
                                            w4a8["ts"], use_int4=True,
                                            device="cpu")
    assert tst.fold[0] == (True, False) and all(all(f) for f in tst.w4)
    got = TB.bert_engine_apply(w4a8["tp"], w4a8["batch"], w4a8["tcfg"], tq,
                               w4a8["ts"], tst, tplan, tint,
                               device="cpu")["logits"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_w4a8_generic_paths_match_jax(w4a8):
    """The generic int path (int8_linear on unpacked levels) and its fused
    linear (``fused_linear=True``, JAX ``use_pallas=True`` in interpret
    mode) at W4A8."""
    tint = TB.build_bert_int_params(w4a8["tp"], w4a8["tq"], w4a8["ts"],
                                    use_int4=True)
    jargs = (w4a8["jp"], w4a8["jbatch"], w4a8["jcfg"], w4a8["jq"],
             w4a8["js"], JMode())
    targs = (w4a8["tp"], w4a8["batch"], w4a8["tcfg"], w4a8["tq"], w4a8["ts"],
             QuantMode())
    want = jax.jit(lambda p, b, s, ip: JB.bert_apply(
        p, b, w4a8["jcfg"], w4a8["jq"], s, JMode(), int_params=ip)[0][
        "logits"])(w4a8["jp"], w4a8["jbatch"], w4a8["js"], w4a8["jint"])
    got, _ = TB.bert_apply(*targs, int_params=tint, device="cpu")
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    jf, _ = JB.bert_apply(*jargs, int_params=w4a8["jint"], use_pallas=True)
    EK.reset_launches()
    tf, _ = TB.bert_apply(*targs, int_params=tint, fused_linear=True,
                          device="cpu")
    assert set(EK.LAUNCHES.values()) == {0}
    np.testing.assert_allclose(tf["logits"].numpy(),
                               np.asarray(jf["logits"]), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(tf["logits"].numpy(), got["logits"].numpy(),
                               rtol=1e-4, atol=1e-5)


def test_engine_refuses_int4_under_a_float_edge(w4a8):
    """A 16-bit FFN input (``{'x': 16}``) makes the inter matmul a
    float-edge one (K4), which has no w4 form yet: refused at plan time,
    before anything is launched."""
    _, tq, ts = TC.calibrated_bert(
        w4a8["tcfg"], batch_size=2, seq=SEQ, device="cpu",
        params=w4a8["tp"], quant_dict={"x": 16},
        defaults=dataclasses.replace(TC.w8a8_defaults(), n_bits=4,
                                     n_bits_act=8))
    with pytest.raises(TENG.EngineIncompatible, match="not yet ported"):
        TB.build_bert_engine(w4a8["tp"], w4a8["tcfg"], tq, ts, use_int4=True,
                             device="cpu")
    # the same recipe on int8 weights plans (the flex route)
    static, _, _ = TB.build_bert_engine(w4a8["tp"], w4a8["tcfg"], tq, ts,
                                        device="cpu")
    assert static.any_flex and not any(any(f) for f in static.w4)


def test_engine_refuses_widths_outside_the_matmul_kernel():
    """An intermediate width of 784 is a multiple of 16 but not of 32:
    under packed int4 weights the FFN dense matmul (K = 784) is outside
    K1's limits, so the plan is refused when it is made; on int8 weights
    the same model plans."""
    cfg = TB.BertConfig(**dict(KW, intermediate_size=784))
    params, tq, ts = TC.calibrated_bert(
        cfg, batch_size=2, seq=SEQ, device="cpu",
        defaults=dataclasses.replace(TC.w8a8_defaults(), n_bits=4,
                                     n_bits_act=8))
    with pytest.raises(TENG.EngineIncompatible,
                       match=r"L0\.ffn\.dense: K = 784, N = 64 .*K % 32"):
        TB.build_bert_engine(params, cfg, tq, ts, use_int4=True,
                             device="cpu")
    static, _, _ = TB.build_bert_engine(params, cfg, tq, ts, device="cpu")
    assert not any(any(f) for f in static.w4)


def test_int4_checkpoint_round_trip(w4a8, tmp_path):
    """JAX ``save_checkpoint`` with int4 int_params -> port
    ``load_checkpoint`` (uint8 nibbles, int ``in_features``) -> port
    ``save_checkpoint`` -> JAX ``load_checkpoint`` gives JAX's arrays
    back."""
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    JCK.save_checkpoint(jdir, params=w4a8["jp"], family="bert",
                        cfg=w4a8["jcfg"], qstate=w4a8["js"],
                        int_params=w4a8["jint"])
    ck = TCK.load_checkpoint(jdir, device="cpu")
    conv = C.int_params_from_jax(_np(w4a8["jint"]), device="cpu")
    assert set(ck["int_params"]) == set(conv)
    for name, p in conv.items():
        for k, v in p.items():
            got = ck["int_params"][name][k]
            if isinstance(v, torch.Tensor):
                assert got.dtype == v.dtype and torch.equal(got, v)
            else:
                assert got == v and isinstance(got, int)
    TCK.save_checkpoint(tdir, params=ck["params"], family="bert",
                        cfg=ck["cfg"], qstate=ck["qstate"],
                        int_params=ck["int_params"])
    back = JCK.load_checkpoint(tdir)
    jint = _np(w4a8["jint"])
    for name, p in jint.items():
        for k, v in p.items():
            np.testing.assert_array_equal(np.asarray(back["int_params"][name][
                k]), np.asarray(v), err_msg=f"{name}/{k}")
