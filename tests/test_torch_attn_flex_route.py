"""The attention's second kernel: its route by form, and its integer
route's p.v of a 9-16-bit probs site, modelled in plain torch.

On the card (``csrc/int8_attention.cu``) a 9-16-bit probs level ``L``
meets ``v8`` on the int8 tensor cores: ``U = L - lo_b`` (``lo_b = p_sh -
2^(bits-1)``) in two byte planes ``U = lo + 256 hi``, each plane's
product with ``v8`` an int32 partial, ``sum U`` by a ones operand, and
``sum L (v8 + v_sh)`` put together in int64, then rounded once to float32.
:func:`lvl_pv_model` does the same in torch; the tests hold it bit for bit
against ``int8_attention_ref`` (whose float64 sum of these integer
products is exact), assert the partials' bounds, and check that it refuses
the shifts ``attn_pv_exact`` rules out, where the kernel takes p.v on the
float64 tensor cores instead. ``tests/test_torch_flex_edges.py`` and
``tests/test_torch_kernels_ref.py`` hold the plain versions against JAX.
"""

import itertools

import numpy as np
import pytest
import torch

from transformer_quantization_tpu_torch.ops.kernels import engine_kernels as EK

BITS = (0, 2, 4, 6, 8, 9, 16)
INT32_PARTIAL = 2 ** 22   # |sum plane * v8| < T * 255 * 128 <= 2^22


def lvl_pv_model(levels, v8, p_sh: float, v_sh: float, p_bits: int):
    """``sum_k levels[..., k] * (v8[..., k, :] + v_sh)`` as the integer
    route computes it: ``levels`` (..., T) the integer levels of a
    ``p_bits``-bit probs site (9-16), ``v8`` (..., T, d) int8; returns the
    float32 context and the int32 partials ``(lo . v8, hi . v8, sum lo,
    sum hi)``. Raises ValueError where the kernel's block condition
    fails."""
    if not EK.attn_pv_exact(p_sh, v_sh):
        raise ValueError(f"p_sh={p_sh}, v_sh={v_sh}: no exact integer p.v")
    t = levels.shape[-1]
    lo_b = int(p_sh) - 2 ** (p_bits - 1)
    u = levels.to(torch.int64) - lo_b
    assert int(u.min()) >= 0 and int(u.max()) < 2 ** p_bits
    lo, hi = u & 255, u >> 8
    v = v8.to(torch.int64)
    a_lo, a_hi = lo @ v, hi @ v
    s_lo, s_hi = lo.sum(-1, keepdim=True), hi.sum(-1, keepdim=True)
    ctx = (a_lo + 256 * a_hi + lo_b * v.sum(-2, keepdim=True)
           + int(v_sh) * (s_lo + 256 * s_hi + t * lo_b))
    return ctx.to(torch.float32), (a_lo, a_hi, s_lo, s_hi)


def ref_levels(qkv8, mask, scal, *, n_heads, seq, attn_bits, skip_max):
    """The probs site's shifted levels (b, heads, T, T) and v8 (b, heads,
    T, d), as ``int8_attention_ref`` computes them for ``dots='i8'``."""
    sc_bits, p_bits, _ = EK._check_attn_bits(attn_bits)
    mt, h3 = qkv8.shape
    h = h3 // 3
    d = h // n_heads
    b = mt // seq
    s = scal[0]
    q8, k8, v8 = (qkv8[:, i * h:(i + 1) * h].reshape(b, seq, n_heads, d)
                  for i in range(3))
    acc = EK.exact_int_matmul(q8.permute(0, 2, 1, 3),
                              k8.permute(0, 2, 1, 3)).to(torch.float32)
    qsum = torch.sum(q8.to(torch.float32), dim=-1)
    ksum = torch.sum(k8.to(torch.float32), dim=-1)
    scr = (acc + s[1] * ksum.permute(0, 2, 1)[:, :, None, :]
           + s[3] * qsum.permute(0, 2, 1)[:, :, :, None] + d * s[1] * s[3])
    rsqrt_d = EK._rsqrt_d(d)
    if sc_bits == 0:
        s2 = ((s[0] * s[2] * rsqrt_d * EK.LOG2E) * scr
              + mask[:, None, None, :] * EK.LOG2E)
    else:
        a = s[6] * rsqrt_d * EK.LOG2E
        lo_sc, hi_sc = EK._clip_bounds(sc_bits)
        r = torch.clamp(torch.round(scr * (s[0] * s[2] * (1.0 / s[6])))
                        - s[7], lo_sc, hi_sc)
        s2 = a * r + (mask[:, None, None, :] * EK.LOG2E + a * s[7])
    e = torch.exp2(s2 if skip_max else
                   s2 - torch.amax(s2, dim=-1, keepdim=True))
    half = float(2 ** (p_bits - 1))
    pf = torch.clamp(torch.round(e * ((1.0 / s[8]) / EK._row_sum(e))),
                     s[9] - half, s[9] + half - 1.0)
    return pf, v8.permute(0, 2, 1, 3)


def attn_case(seed, b=2, seq=128, d=64, n_heads=2, zero_qk=False,
              v_fill=None):
    rng = np.random.RandomState(seed)
    h = n_heads * d
    qkv = rng.randint(-128, 128, (b * seq, 3 * h)).astype(np.int8)
    if zero_qk:
        qkv[:, :2 * h] = 0
    if v_fill is not None:
        qkv[:, 2 * h:] = v_fill
    lens = rng.randint(1, seq + 1, b)
    mask = np.where(np.arange(seq)[None, :] < lens[:, None], 0.0,
                    -10000.0).astype(np.float32)
    return torch.from_numpy(qkv), torch.from_numpy(mask)


def scalars(p_s, p_sh, v_sh, v_s=0.04):
    return torch.tensor([[0.05, 3.0, 0.05, -2.0, v_s, v_sh, 0.25, 2.0, p_s,
                          p_sh, 1.0, 0.0]], dtype=torch.float32)


@pytest.mark.parametrize("dots", ("i8", "f32"))
@pytest.mark.parametrize("p_bits", BITS)
def test_route_is_a_function_of_the_form(dots, p_bits):
    for sc_bits, c_bits in itertools.product(BITS, BITS):
        route = EK.attn_flex_route((sc_bits, p_bits, c_bits), dots)
        assert route == ("int" if dots == "i8" and p_bits >= 1 else "f64")
    with pytest.raises(ValueError):
        EK.attn_flex_route((8, p_bits, 17), dots)
    with pytest.raises(ValueError):
        EK.attn_flex_route((8, p_bits, 8), "bf16")


@pytest.mark.parametrize("p_bits,p_sh,v_sh,sc_bits,skip", [
    (16, 32768.0, 5.0, 8, False), (16, 0.0, -3.0, 16, True),
    (12, 2048.0, 128.0, 0, False), (9, -7.0, 0.0, 8, True),
    (16, 65536.0, -65536.0, 8, False)])
def test_integer_pv_model_matches_plain(p_bits, p_sh, v_sh, sc_bits, skip):
    """Seeded payloads: the model's float32 context, through the context
    site disabled, is bit for bit ``int8_attention_ref``'s."""
    qkv, mask = attn_case(3 + p_bits)
    scal = scalars(1.0 / (2 ** p_bits - 1), p_sh, v_sh)
    kw = dict(n_heads=2, seq=128, attn_bits=(sc_bits, p_bits, 0),
              skip_max=skip)
    want = EK.int8_attention_ref(qkv, mask, scal, **kw)
    pf, v8 = ref_levels(qkv, mask, scal, **kw)
    assert torch.equal(pf, torch.round(pf))
    ctx, parts = lvl_pv_model(pf, v8, p_sh, v_sh, p_bits)
    for a in parts[:2]:
        assert int(a.abs().max()) < INT32_PARTIAL
    pv_over_c = scal[0, 8] * scal[0, 4] * (1.0 / scal[0, 10])
    got = (ctx * pv_over_c).permute(0, 2, 1, 3).reshape(want.shape)
    assert torch.equal(got, want)


@pytest.mark.parametrize("p_sh", (32768.0, -32768.0, 0.0))
def test_integer_pv_model_at_the_extremes(p_sh):
    """Every probs level at its largest (equal scores, a tiny p_s) against
    |v8 + v_sh| = 256 at T = 128, d = 64: the partials stay inside their
    bounds and the context, near -2^31, is the plain version's to the
    bit."""
    qkv, mask = attn_case(7, zero_qk=True, v_fill=-128)
    mask = torch.zeros_like(mask)
    scal = scalars(1e-9, p_sh, -128.0, v_s=1.0)
    kw = dict(n_heads=2, seq=128, attn_bits=(8, 16, 0), skip_max=False)
    pf, v8 = ref_levels(qkv, mask, scal, **kw)
    assert torch.equal(pf, torch.full_like(pf, p_sh + 32767.0))
    ctx, (a_lo, a_hi, s_lo, s_hi) = lvl_pv_model(pf, v8, p_sh, -128.0, 16)
    assert int(a_lo.abs().max()) == int(a_hi.abs().max()) == 255 * 128 * 128
    assert int(a_lo.abs().max()) < INT32_PARTIAL
    assert int((s_lo + 256 * s_hi).max()) == 65535 * 128 < 2 ** 23
    exact = (p_sh + 32767.0) * -256.0 * 128
    assert float(ctx.flatten()[0]) == float(np.float32(exact))
    want = EK.int8_attention_ref(qkv, mask, scal, **kw)
    pv_over_c = scal[0, 8] * scal[0, 4] * (1.0 / scal[0, 10])
    assert torch.equal((ctx * pv_over_c).permute(0, 2, 1, 3).reshape(
        want.shape), want)


@pytest.mark.parametrize("p_sh,v_sh", [
    (127.5, 5.0), (128.0, 0.25), (65537.0, 0.0), (0.0, -65537.0),
    (float(2 ** 20), 1.0), (float("nan"), 0.0)])
def test_integer_pv_model_refuses_inexact_shifts(p_sh, v_sh):
    """Shifts that are not integers, or too large for the exact path: the
    block condition (``attn_pv_exact``) is false and the model refuses, as
    the kernel's block takes p.v on the float64 tensor cores."""
    assert not EK.attn_pv_exact(p_sh, v_sh)
    levels = torch.zeros(1, 128)
    v8 = torch.zeros(1, 128, 64, dtype=torch.int8)
    with pytest.raises(ValueError):
        lvl_pv_model(levels, v8, p_sh, v_sh, 16)


def test_block_condition_table():
    """``attn_pv_exact`` on the engine's shifts (integers of at most 2^15
    from ``zero_point_of``) and at the bound."""
    for p_sh in (0.0, 128.0, 32768.0, -32768.0, 65536.0, -65536.0):
        for v_sh in (0.0, 5.0, -128.0, 65536.0):
            assert EK.attn_pv_exact(p_sh, v_sh)
    assert not EK.attn_pv_exact(65536.0 + 1.0, 0.0)
    assert not EK.attn_pv_exact(0.5, 0.0)
