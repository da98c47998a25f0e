"""The port's int8 QAT linear (``training/int8_qat.py``) against the JAX
package's ``int8_qat_linear`` (values and gradients, with and without
``quantize_input``) and against the port's own float fake-quant
composition ``fakequant_qat_linear``; the padded ``torch._int_mm``
product; and ``int8_forward_sites`` against JAX's on a calibrated tiny
BERT.

The cases mirror tests/test_int8_qat.py: 8- and 4-bit weights, per
tensor and per channel, ranges that clip on both sides; inputs made with
numpy from a seed.

Tolerances: values bit for bit against JAX's int8 forward (the int32
products are exact and the epilogue repeats its operations), within
rtol 1e-5 / atol 1e-5 of the float composition (a float32 product
rounds); gradients within rtol 1e-5 of JAX's (float32 products and sums in
another order), with an absolute floor of 1e-6 of the tensor's largest
entry, and within tests/test_int8_qat.py's rtol 1e-4 / atol 1e-5 of the
float composition's.
"""

import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as G
from transformer_quantization_tpu.models import bert as JB
from transformer_quantization_tpu.training import int8_qat as JI
from transformer_quantization_tpu.training import qat as JQAT
from transformer_quantization_tpu_torch import convert as C
from transformer_quantization_tpu_torch.ops import int_linear as IL
from transformer_quantization_tpu_torch.training import int8_qat as TI
from transformer_quantization_tpu_torch.training import qat as TQAT

torch.set_num_threads(2)

NAMES = ["x", "w", "bias", "x_delta", "x_zero", "w_delta"]
CASES = list(itertools.product((8, 4), (False, True), (True, False)))


def _setup(w_bits=8, w_per_channel=False, seed=0, n=12, k=16, b=5):
    rng = np.random.RandomState(seed)
    x = rng.normal(scale=1.2, size=(b, 3, k)).astype(np.float32)
    w = rng.normal(scale=0.5, size=(n, k)).astype(np.float32)
    bias = rng.normal(size=(n,)).astype(np.float32)
    x_delta = np.float32(2.0 * 0.8 / 255.0)
    x_zero = np.float32(131.0)
    if w_per_channel:
        w_delta = (np.abs(rng.normal(0.4, 0.1, (n,)))
                   / (2 ** (w_bits - 1) - 1)).astype(np.float32)
    else:
        w_delta = np.float32(0.4 / (2 ** (w_bits - 1) - 1))
    g = rng.normal(size=(b, 3, n)).astype(np.float32)
    return [x, w, bias, np.asarray(x_delta), np.asarray(x_zero),
            np.asarray(w_delta)], g


def _on_grid(arrays):
    """x replaced by its fake-quantized value (the ``quantize_input=False``
    contract: the producer quantized it)."""
    x, _, _, xd, xz, _ = arrays
    s, zp = np.float32(xd), np.float32(np.clip(np.round(xz), 0, 255))
    r = np.clip(np.round(x / s) + zp, 0, 255)
    return [(s * (r - zp)).astype(np.float32)] + arrays[1:]


def _jax(arrays, g, w_bits, pc, qi):
    def loss(*a):
        return jnp.sum(JI.int8_qat_linear(*a, w_bits, pc, qi) * g)
    a = [jnp.asarray(v) for v in arrays]
    y = JI.int8_qat_linear(*a, w_bits, pc, qi)
    grads = jax.grad(loss, argnums=tuple(range(6)))(*a)
    return np.asarray(y), [np.asarray(v) for v in grads]


def _port(fn, arrays, g, *args):
    t = [torch.tensor(v, requires_grad=True) for v in arrays]
    y = fn(*t, *args)
    y.backward(torch.tensor(g))
    return y.detach().numpy(), [v.grad.numpy() for v in t]


def _close(got, want, rtol, atol_frac, what):
    floor = atol_frac * float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=floor,
                               err_msg=what)


@pytest.mark.parametrize("w_bits,pc,qi", CASES)
def test_int8_qat_linear_matches_jax(w_bits, pc, qi):
    arrays, g = _setup(w_bits, pc)
    if not qi:
        arrays = _on_grid(arrays)
    jy, jg = _jax(arrays, g, w_bits, pc, qi)
    ty, tg = _port(TI.int8_qat_linear, arrays, g, w_bits, pc, qi)
    np.testing.assert_array_equal(ty, jy)
    for name, a, b in zip(NAMES, tg, jg):
        assert a.shape == b.shape, name
        _close(a, b, 1e-5, 1e-6, name)
    if not qi:
        assert not tg[3].any() and not tg[4].any()


@pytest.mark.parametrize("w_bits,pc", [c[:2] for c in CASES if c[2]])
def test_int8_qat_linear_matches_the_float_composition(w_bits, pc):
    arrays, g = _setup(w_bits, pc)
    ty, tg = _port(TI.int8_qat_linear, arrays, g, w_bits, pc, True)
    fy, fg = _port(TI.fakequant_qat_linear, arrays, g, w_bits, pc)
    np.testing.assert_allclose(ty, fy, rtol=1e-5, atol=1e-5)
    for name, a, b in zip(NAMES, tg, fg):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5, err_msg=name)
    # both x clip branches and the zero point's gradient are live
    assert 0 < (tg[0] == 0).mean() < 1 and tg[4] != 0


@pytest.mark.parametrize("m,k,n", [(8, 60, 2), (17, 64, 136), (5, 3, 9),
                                   (24, 16, 8)])
def test_padded_int_mm_is_the_exact_product(m, k, n):
    """The padding that fits ``torch._int_mm``'s CUDA limits (M > 16, K
    and N multiples of 8) adds nothing: equal to the exact product (run
    here through the CPU's ``torch._int_mm``)."""
    rng = np.random.RandomState(m + k + n)
    a = torch.from_numpy(rng.randint(-128, 128, (m, k)).astype(np.int8))
    w = torch.from_numpy(rng.randint(-8, 8, (n, k)).astype(np.int8))
    got = TI.int_mm_padded(a, w)
    assert got.dtype == torch.int32 and tuple(got.shape) == (m, n)
    assert torch.equal(got, IL.exact_int_matmul(a, w))
    assert torch.equal(TI.int8_product(a, w), got)


@pytest.fixture(scope="module")
def calibrated():
    cfg = JB.BertConfig(vocab_size=128, hidden_size=64, num_hidden_layers=2,
                        num_attention_heads=4, intermediate_size=128,
                        max_position_embeddings=64, num_labels=2,
                        hidden_dropout_prob=0.0,
                        attention_probs_dropout_prob=0.0)
    params, qcfg, qstate = G._calibrated_bert(cfg, batch_size=2, seq=16)
    return cfg, params, qcfg, qstate


def test_int8_forward_sites_match_jax(calibrated):
    _, _, qcfg, qstate = calibrated
    from transformer_quantization_tpu_torch.models import bert as TB
    from transformer_quantization_tpu_torch.training import (
        calibration as TC,
    )

    want = JQAT.int8_forward_sites(qcfg, qstate)
    tq = TB.declare_bert_sites(TC.w8a8_defaults(), TB.BertConfig(
        **{f: getattr(calibrated[0], f)
           for f in ("vocab_size", "hidden_size", "num_hidden_layers",
                     "num_attention_heads", "intermediate_size",
                     "max_position_embeddings", "num_labels")}))
    ts = C.qstate_from_jax(jax.tree.map(np.asarray, qstate), device="cpu")
    got = TQAT.int8_forward_sites(tq, ts)
    assert got == want
    assert {"L0.attn.q", "L1.ffn.dense", "classifier", "L.ffn.inter"} <= got
    # an unsigned weight grid is not eligible
    ts["L0.attn.q.w"] = dict(ts["L0.attn.q.w"], qp=dataclass_replace(
        ts["L0.attn.q.w"]["qp"], signed=torch.zeros(())))
    got2 = TQAT.int8_forward_sites(tq, ts)
    assert "L0.attn.q" not in got2 and "L.attn.q" not in got2


def dataclass_replace(obj, **kw):
    import dataclasses

    return dataclasses.replace(obj, **kw)


def test_bert_forward_on_the_int8_sites_matches_jax(calibrated):
    """The whole tiny BERT's learn-phase forward with the int8 QAT matmul
    at every eligible site: logits equal to JAX's within the parity
    contract's rtol 1e-3 / atol 2e-3 (float attention and LayerNorms sum in
    another order), and to the port's float fake-quant forward."""
    from transformer_quantization_tpu_torch.models import bert as TB
    from transformer_quantization_tpu_torch.quant.qconfig import (
        Phase,
        QuantMode,
    )
    from transformer_quantization_tpu_torch.training import (
        calibration as TC,
    )

    jcfg, params, qcfg, qstate = calibrated
    sites = JQAT.int8_forward_sites(qcfg, qstate)
    rng = np.random.RandomState(4)
    batch = {"input_ids": rng.randint(0, 128, (4, 16)).astype(np.int32),
             "attention_mask": np.ones((4, 16), np.float32),
             "token_type_ids": np.zeros((4, 16), np.int32),
             "labels": rng.randint(0, 2, (4,)).astype(np.int32)}
    jmode = JQAT.qat_mode(JQAT.QATConfig(learn_ranges=True))
    jout, _ = JB.bert_apply(params, {k: jnp.asarray(v)
                                     for k, v in batch.items()}, jcfg,
                            qcfg=qcfg, qstate=qstate, mode=jmode, train=True,
                            dropout_rng=jax.random.PRNGKey(0),
                            int8_qat_sites=sites)
    tcfg = TB.BertConfig(**{f: getattr(jcfg, f) for f in (
        "vocab_size", "hidden_size", "num_hidden_layers",
        "num_attention_heads", "intermediate_size",
        "max_position_embeddings", "num_labels", "hidden_dropout_prob",
        "attention_probs_dropout_prob")})
    tq = TB.declare_bert_sites(TC.w8a8_defaults(), tcfg)
    tp = C.params_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    ts = C.qstate_from_jax(jax.tree.map(np.asarray, qstate), device="cpu")
    mode = QuantMode(weight_phase=Phase.learn, act_phase=Phase.learn)
    apply = functools.partial(TB.bert_apply, tp, batch, tcfg, tq, ts, mode,
                              train=True, device="cpu")
    calls = []
    real = TI.Int8QATLinear.apply

    def spy(*a):
        calls.append(a[1].shape)
        return real(*a)

    TI.Int8QATLinear.apply = spy
    try:
        out, _ = apply(int8_qat_sites=TQAT.int8_forward_sites(tq, ts))
    finally:
        TI.Int8QATLinear.apply = real
    flt, _ = apply()
    # q, k, v, attn_out, inter, dense a layer, the pooler, the classifier
    assert len(calls) == 6 * 2 + 2
    np.testing.assert_allclose(out["logits"].detach().numpy(),
                               np.asarray(jout["logits"]), rtol=1e-3,
                               atol=2e-3)
    np.testing.assert_allclose(out["logits"].detach().numpy(),
                               flt["logits"].detach().numpy(), rtol=1e-3,
                               atol=2e-3)
    assert abs(float(out["loss"]) - float(jout["loss"])) < 1e-4
