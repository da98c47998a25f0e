"""The float matmuls that take a >8-bit site run in full float32.

The JAX package asks for ``lax.Precision.HIGHEST`` on any float matmul
whose act or weight site has a grid wider than 8 bits
(``ops/layers.py`` ``wide_matmul_precision``): a reduced-precision product
(bf16 passes on a TPU, TF32 on an NVIDIA card) keeps about 10 mantissa
bits and rounds away a 16-bit site's low levels. The port keeps its own
copy of the predicate and runs those products with
``torch.set_float32_matmul_precision('highest')`` for the call, whatever
the caller set, and restores the caller's setting. Exact checks: the
predicate agrees with JAX's on every pair of sites of W8A8,
``w8a8-mixed`` and ``{'c': 16}``; a forward with TF32 allowed by the
caller runs the wide sites' products at 'highest' and the others at the
caller's setting, and leaves the caller's flag as it was.
"""

import types

import numpy as np
import pytest
import torch

import __graft_entry__ as G
from transformer_quantization_tpu.models import bert as JB
from transformer_quantization_tpu.ops import layers as JL
from transformer_quantization_tpu_torch.models import bert as TB
from transformer_quantization_tpu_torch.ops import layers as TL
from transformer_quantization_tpu_torch.quant.qconfig import QuantMode
from transformer_quantization_tpu_torch.training import calibration as TC

torch.set_num_threads(2)

TINY = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=128,
            max_position_embeddings=64, num_labels=2)
CONFIGS = {"w8a8": {}, "w8a8-mixed": {"x": 16, "h": 16, "y": 16},
           "c16": {"c": 16}}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_wide_matmul_predicate_matches_jax(name):
    qd = CONFIGS[name]
    jq = JB.apply_bert_quant_dict(
        JB.declare_bert_sites(G._w8a8_defaults(), JB.BertConfig(**TINY)), qd,
        TINY["num_hidden_layers"])
    tq = TB.apply_bert_quant_dict(
        TB.declare_bert_sites(TC.w8a8_defaults(), TB.BertConfig(**TINY)), qd,
        TINY["num_hidden_layers"])
    jctx, tctx = types.SimpleNamespace(cfg=jq), types.SimpleNamespace(cfg=tq)
    sites = [None, "not.a.site"] + list(jq.names())
    wide = 0
    for a in sites:
        for b in sites:
            want = JL.wide_matmul_precision(jctx, a, b) is not None
            assert TL.wide_matmul_precision(tctx, a, b) == want, (a, b)
            wide += want
    assert (wide > 0) == bool(qd)
    assert not TL.wide_matmul_precision(types.SimpleNamespace(), sites[2])


def test_float_matmul_restores_the_callers_setting():
    a = torch.randn(4, 8)
    prev = torch.get_float32_matmul_precision()
    seen = []
    real = torch.matmul
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.matmul = lambda *x: (seen.append(
            torch.get_float32_matmul_precision()), real(*x))[1]
        TL.float_matmul(a, a.t(), True)
        TL.float_matmul(a, a.t(), False)
        with pytest.raises(RuntimeError):
            TL.float_matmul(a, a, True)   # (4, 8) @ (4, 8): raises inside
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.matmul = real
        torch.set_float32_matmul_precision(prev)
    assert seen == ["highest", "high", "highest"]


@pytest.mark.parametrize("name", ["w8a8", "w8a8-mixed"])
def test_forward_keeps_wide_products_full_and_the_callers_flag(name):
    qd = CONFIGS[name]
    cfg = TB.BertConfig(**TINY)
    params, qcfg, qstate = TC.calibrated_bert(cfg, batch_size=2, seq=16,
                                              seed=0, device="cpu",
                                              quant_dict=qd)
    rng = np.random.RandomState(1)
    batch = {"input_ids": rng.randint(0, TINY["vocab_size"], (2, 16)).astype(
                 np.int32),
             "attention_mask": np.ones((2, 16), np.float32),
             "token_type_ids": np.zeros((2, 16), np.int32)}
    prev = torch.get_float32_matmul_precision()
    seen = []
    real = torch.matmul
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.matmul = lambda *x: (seen.append(
            torch.get_float32_matmul_precision()), real(*x))[1]
        with torch.no_grad():
            TB.bert_apply(params, batch, cfg, qcfg, qstate, QuantMode(),
                          device="cpu")
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.matmul = real
        torch.set_float32_matmul_precision(prev)
    assert "high" in seen   # the 8-bit sites keep the caller's setting
    assert ("highest" in seen) == bool(qd)
