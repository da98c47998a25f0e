"""The payload attention (K2 / K7) of the port, on the CPU, at the card's
shapes: the plain versions the card holds the kernel to, against JAX's
``int8_attention`` / ``int8_attention_qkv`` in interpret mode and against
JAX's ``int8_attention_ref``.

Inputs come from ``chip_smoke.attn_inputs`` (numpy, seeded), the helper
the card's checks use: q|k|v payloads in [-60, 60), padded masks, the
site scalars ``chip_smoke.ATTN_SCALARS``. Cases:
- ``int8_attention`` at every (seq, head_dim) of ``ATTN_SHAPES``, B = 2,
  2-4 heads, skip_max both ways (the last row fully padded under
  skip_max=False; under skip_max=True a fully padded row divides 0 by 0,
  and JAX's kernel and its reference give it different payloads);
- ``int8_attention_qkv`` over ``chip_smoke.attn_split``'s layouts
  (MobileBERT's cols (0, 1, 0) and three arrays at (1, 2, 0), each of its
  own row stride) at head_dim 32 and 64;
- the saturating scalars (scores and context levels clipped at -128 /
  127), and the fully padded row alone.

Tolerance (as ``tests/test_torch_kernels_ref.py``): payloads equal or one
level off on at most 0.1% of elements, since XLA's and PyTorch's exp2
differ by ulps; the port's wrappers on CPU tensors are its plain versions
and count no launch.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as CS
from transformer_quantization_tpu.ops.pallas import engine_kernels as JEK
from transformer_quantization_tpu_torch.ops.kernels import engine_kernels as EK

LEVEL_TOL, FRAC_TOL = 1, 1e-3
HEADS = {32: 4, 64: 2}


def _close(want, got):
    want = np.asarray(want).astype(np.int32)
    got = np.asarray(got).astype(np.int32)
    assert want.shape == got.shape
    diff = np.abs(want - got)
    assert diff.max() <= LEVEL_TOL, diff.max()
    assert (diff > 0).mean() <= FRAC_TOL, (diff > 0).mean()


def _jax_and_port(qkv, mask, scal, *, n_heads, seq, skip_max):
    """JAX's kernel (interpret mode) and reference, and the port's wrapper
    (its plain version on the CPU), on the fused q|k|v payload."""
    j = [jnp.asarray(a) for a in (qkv, mask, scal)]
    kw = dict(n_heads=n_heads, seq=seq, skip_max=skip_max)
    jk = JEK.int8_attention(*j, interpret=True, dots="i8", **kw)
    # the reference jitted: one program, where eagerly each of its ops
    # compiles on first use (equal outputs)
    jr = jax.jit(lambda *a: JEK.int8_attention_ref(*a, **kw))(*j)
    got = EK.int8_attention(*(torch.from_numpy(a) for a in (qkv, mask,
                                                             scal)), **kw)
    return np.asarray(jk), np.asarray(jr), got.numpy()


@pytest.mark.parametrize("skip_max", [False, True])
@pytest.mark.parametrize("seq,d", EK.ATTN_SHAPES)
def test_int8_attention_against_jax(seq, d, skip_max):
    qkv, mask, scal = CS.attn_inputs(2, seq, d, HEADS[d], 300 + seq + d,
                                     full_pad=not skip_max)
    jk, jr, got = _jax_and_port(qkv, mask, scal, n_heads=HEADS[d], seq=seq,
                                skip_max=skip_max)
    _close(jk, got)
    _close(jr, got)
    # the context site takes tens of levels, not a constant
    assert len(np.unique(got)) > 20


@pytest.mark.parametrize("layout", ["mobilebert", "three"])
@pytest.mark.parametrize("d", [32, 64])
def test_int8_attention_qkv_strides(d, layout):
    seq, nh = 128, HEADS[d]
    qkv, mask, scal = CS.attn_inputs(2, seq, d, nh, 400 + d)
    h = nh * d
    q, k, v, cols = CS.attn_split(qkv, h, layout)
    assert len({q.shape[1], k.shape[1], v.shape[1]}) == (
        2 if layout == "mobilebert" else 3)
    j = [jnp.asarray(a) for a in (q, k, v, mask, scal)]
    kw = dict(n_heads=nh, seq=seq, hidden=h, cols=cols, skip_max=False)
    jk = JEK.int8_attention_qkv(*j, interpret=True, dots="i8", **kw)
    EK.reset_launches()
    got = EK.int8_attention_qkv(*(torch.from_numpy(a) for a in
                                  (q, k, v, mask, scal)), **kw)
    assert EK.LAUNCHES["int8_attention_qkv"] == 0
    _close(jk, got.numpy())
    # the same payload as the fused entry point on the fused array
    _, _, fused = _jax_and_port(qkv, mask, scal, n_heads=nh, seq=seq,
                                skip_max=False)
    np.testing.assert_array_equal(got.numpy(), fused)


@pytest.mark.parametrize("d", [32, 64])
def test_int8_attention_saturating(d):
    seq, nh = 128, HEADS[d]
    qkv, mask, scal = CS.attn_inputs(2, seq, d, nh, 500 + d, "saturate")
    jk, jr, got = _jax_and_port(qkv, mask, scal, n_heads=nh, seq=seq,
                                skip_max=False)
    _close(jk, got)
    _close(jr, got)
    # the scores site clips: levels at both ends before the softmax
    t = {k: torch.from_numpy(a) for k, a in (("qkv", qkv), ("scal", scal))}
    s = t["scal"][0]
    h = nh * d
    q8 = t["qkv"][:, :h].reshape(2, seq, nh, d).permute(0, 2, 1, 3)
    k8 = t["qkv"][:, h:2 * h].reshape(2, seq, nh, d).permute(0, 2, 1, 3)
    acc = torch.einsum("bhid,bhjd->bhij", q8.double(), k8.double())
    lvl = torch.round(acc * float(s[0] * s[2] / s[6])) - float(s[7])
    assert (lvl > 127).any() and (lvl < -128).any()
    # and so does the context site
    assert (got == 127).any() and (got == -128).any()


def test_int8_attention_fully_padded_row():
    seq, d, nh = 64, 64, 2
    qkv, mask, scal = CS.attn_inputs(3, seq, d, nh, 600, full_pad=True)
    assert (mask[-1] == -10000.0).all() and (mask[:-1] == 0.0).any()
    jk, jr, got = _jax_and_port(qkv, mask, scal, n_heads=nh, seq=seq,
                                skip_max=False)
    _close(jk, got)
    _close(jr, got)
    # the padded row's queries attend all keys at the same bias: a
    # context of its own, not the saturated ends
    last = got[2 * seq:]
    assert len(np.unique(last)) > 20
