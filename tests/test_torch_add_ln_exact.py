"""The add+LN template's exact forms (``csrc/add_ln.cuh``), on the CPU.

On its integer path (scalar sites, every shift an integer of at most
2^16) the card's K3 / K5 / ``fused_add_ln`` kernels replace three
conversion instructions with float arithmetic that is exact by
construction: int8 -> float by a byte permute into 2^23 and one
subtraction that also adds the shift; a site ``clip(rint(t) - sh, lo,
hi)`` as ``t + 1.5 * 2^23`` clipped to the bounds translated by ``1.5 *
2^23 + sh``; the int8 store from the low byte of that sum less the
shift. These tests emulate each form in
float32 torch arithmetic (and ``__byte_perm`` in Python integers) and
hold it bitwise against what the plain versions use (``.to(float32)``
plus the shift, ``torch.round`` then ``torch.clamp``, the int8 cast),
then the whole kernel's chain of operations, written from the template
(the integer path, or the general one for per-column sites and shifts
off the integers),
against ``fused_add_ln_payload_ref``, ``flex_add_ln_ref`` and
``fused_add_ln_ref`` on ``chip_smoke.ln_inputs``. The kernels' division
is the IEEE quotient where they take their fast form; the card checks
that (``chip_smoke.check_ln_division``), and the emulation divides.

Tolerances: none; every comparison is bitwise, except that a NaN level
(only inf - inf makes one) clips to the low bound in the kernel, where
``torch.clamp`` keeps it: that case is held against ``torch.fmax`` /
``torch.fmin``, the kernel's ``fmaxf`` / ``fminf``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import chip_smoke as CS
from transformer_quantization_tpu_torch.ops.kernels import engine_kernels as EK

F32 = torch.float32
MAGIC = torch.tensor(12582912.0, dtype=F32)      # 1.5 * 2^23
BYTE_BIAS = torch.tensor(8388736.0, dtype=F32)   # 2^23 + 128


def byte_perm(x: int, y: int, s: int) -> int:
    """PTX ``prmt.b32`` (``__byte_perm``): byte n of the result is byte
    ``s``'s nibble n of the eight bytes {y, x} (x the low four)."""
    src = (y << 32) | x
    return sum(((src >> (8 * ((s >> (4 * n)) & 7))) & 0xFF) << (8 * n)
               for n in range(4))


def f32_of_bits(bits) -> torch.Tensor:
    return torch.tensor(np.array(bits, np.uint32).view(np.int32)).view(F32)


def bits_of_f32(x: torch.Tensor) -> np.ndarray:
    return x.view(torch.int32).numpy().view(np.uint32)


def site_u(t, sh, lo, hi):
    """The integer path's site: u = t + M clipped to [M + sh + lo, M + sh +
    hi] (fmaxf / fminf); u - M is the level plus the shift."""
    lo_u, hi_u = ((MAGIC + torch.as_tensor(sh, dtype=F32)) + b for b in
                  (torch.tensor(lo, dtype=F32), torch.tensor(hi, dtype=F32)))
    return torch.fmin(torch.fmax(t + MAGIC, lo_u), hi_u)


@pytest.mark.parametrize("shift", [0.0, 3.0, -5.0, 128.0, -65536.0])
def test_byte_to_float_by_permute_is_exact_for_every_byte(shift):
    i = np.arange(256, dtype=np.uint32)
    words = i | ((255 - i) << 8) | (i << 16) | ((255 - i) << 24)
    bias = BYTE_BIAS - torch.tensor(shift, dtype=F32)
    for j in range(4):
        got = f32_of_bits([byte_perm(int(w) ^ 0x80808080, 0x4B000000,
                                     0x7540 | j) for w in words]) - bias
        want = torch.tensor(((words >> (8 * j)) & 0xFF).astype(np.uint8)
                            .view(np.int8)).to(F32) + shift
        assert torch.equal(got, want), j
        assert len(torch.unique(want)) == 256


def _hard_floats() -> torch.Tensor:
    rng = np.random.RandomState(0)
    v = [rng.randn(4000) * 10.0 ** rng.randint(-4, 10, 4000),
         np.arange(-300, 300) + 0.5, np.arange(-300, 300) - 0.5,
         np.array([2 ** 21 + 0.5, 2 ** 22 - 0.5, 2 ** 22 - 1.5, 0.0, -0.0,
                   0.49999997, -0.49999997, 1.5, 2.5, -1.5, -2.5,
                   1e-45, -1e-45, 3e38, -3e38, np.inf, -np.inf])]
    for edge in (2.0 ** 22, 2.0 ** 23, 2.0 ** 24):
        for sgn in (1.0, -1.0):
            x = np.float32(sgn * edge)
            v.append(np.array([np.nextafter(x, np.float32(0)), x,
                               np.nextafter(x, np.float32(sgn * np.inf))]))
    return torch.tensor(np.concatenate(v).astype(np.float32))


@pytest.mark.parametrize("bits,shift", [(8, -128), (8, -5), (8, 0), (8, 3),
                                        (8, 128), (16, -32768), (16, -7),
                                        (16, 0), (16, 32768), (4, 8),
                                        (8, 65536), (16, -65536)])
def test_the_u_domain_site_equals_round_then_clamp(bits, shift):
    t = _hard_floats()
    lo, hi = EK._clip_bounds(bits)
    want = torch.clamp(torch.round(t) - shift, lo, hi)
    u = site_u(t, shift, lo, hi)
    assert torch.equal((u - MAGIC) - shift, want)
    assert torch.equal(u - MAGIC, want + shift)   # the res site's lvl + sh


def test_a_nan_level_clips_low():
    t = torch.tensor([float("nan"), float("inf") - float("inf")], dtype=F32)
    assert torch.equal(site_u(t, 3.0, -128.0, 127.0) - MAGIC - 3.0,
                       torch.full_like(t, -128.0))


@settings(max_examples=300, deadline=None)
@given(st.lists(st.floats(width=32, allow_nan=False), min_size=1,
                max_size=32),
       st.sampled_from([2, 4, 8, 12, 16]), st.integers(-2 ** 16, 2 ** 16))
def test_the_u_domain_site_matches_on_any_float(vals, bits, shift):
    t = torch.tensor(vals, dtype=F32)
    lo, hi = EK._clip_bounds(bits)
    assert torch.equal(site_u(t, float(shift), lo, hi) - MAGIC - shift,
                       torch.clamp(torch.round(t) - shift, lo, hi))


def pack_levels(u: torch.Tensor, shift: float) -> np.ndarray:
    """The kernel's int8 store of four levels from their clipped u: the
    low bytes of u - sh, packed by byte permutes."""
    b = [int(v) for v in bits_of_f32(u - torch.as_tensor(shift, dtype=F32))]
    return np.array([byte_perm(byte_perm(b[0], b[1], 0x0040),
                               byte_perm(b[2], b[3], 0x0040), 0x5410)],
                    np.uint32)


@pytest.mark.parametrize("shift", [0.0, 5.0, -128.0, 65536.0])
def test_the_int8_store_is_the_low_byte_of_u_less_the_shift(shift):
    t = torch.arange(-200, 200, dtype=F32) + 0.25
    u = site_u(t, shift, -128.0, 127.0)
    want = (torch.clamp(torch.round(t) - shift, -128, 127)).to(torch.int8)
    low = bits_of_f32(u - torch.tensor(shift, dtype=F32)) & 0xFF
    assert np.array_equal(low.astype(np.uint8).view(np.int8), want.numpy())
    for q in range(0, 400, 4):
        assert np.array_equal(pack_levels(u[q:q + 4], shift).view(np.int8),
                              want[q:q + 4].numpy())


def test_a_level_off_the_integers_truncates_as_the_cast():
    levels = torch.tensor([-127.75, -2.25, -0.5, 0.25, 3.5, 126.75],
                          dtype=F32)
    assert torch.equal(torch.trunc(levels).to(torch.int8),
                       levels.to(torch.int8))
    assert not torch.equal(torch.round(levels), torch.trunc(levels))


def _int_shift(sh) -> bool:
    sh = torch.as_tensor(sh)
    return bool(torch.all((sh == torch.round(sh)) & (sh.abs() <= 2 ** 16)))


def emulate_add_ln(y, r, gb, scal, lnv, *, eps, res_quant, res_bits, ln_bits,
                   y_payload, r_payload, outs):
    """The template's chain of operations (``add_ln.cuh`` ``ln_row``) in
    float32 torch, written from the kernel: on the integer path (scalar
    sites, every shift read an integer of at most 2^16) the byte permute
    with the shift in its bias, the sites clipped in u, the payload from
    the low byte of u - sh; else (per-column sites, or a shift off the
    integers) the plain formulas; the float64 row sums rounded once."""
    s = scal[0]
    if lnv is None:
        res_s, res_sh, ln_s, ln_sh = s[4], s[5], s[6], s[7]
    else:
        res_s, res_sh, ln_s, ln_sh = lnv
    read = [res_sh, ln_sh] + [s[1]] * y_payload + [s[3]] * r_payload
    ints = lnv is None and all(_int_shift(sh) for sh in read)

    def value(p, sc, sh, payload):
        if not payload:
            return p
        u = (p.to(torch.int32) & 0xFF) ^ 0x80
        biased = (u | 0x4B000000).view(F32)
        if ints:
            return sc * (biased - (BYTE_BIAS - sh))
        return sc * ((biased - BYTE_BIAS) + sh)

    x = value(y, s[0], s[1], y_payload) + value(r, s[2], s[3], r_payload)
    if res_quant:
        lo, hi = EK._clip_bounds(res_bits)
        t = x * (1.0 / res_s)
        if ints:
            x = res_s * (site_u(t, res_sh, lo, hi) - MAGIC)
        else:
            lvl = torch.clamp(torch.round(t) - res_sh, lo, hi)
            x = res_s * (lvl + res_sh)
    h = torch.tensor(float(x.shape[-1]), dtype=F32)
    mean = x.to(torch.float64).sum(-1, keepdim=True).to(F32) / h
    ms = (x * x).to(torch.float64).sum(-1, keepdim=True).to(F32) / h
    var = torch.fmax(ms - mean * mean, torch.tensor(0.0, dtype=F32))
    z = (x - mean) * (1.0 / torch.sqrt(var + eps)) * gb[0] + gb[1]
    lo, hi = EK._clip_bounds(ln_bits)
    t = z / ln_s
    out = []
    if ints:
        u = site_u(t, ln_sh, lo, hi)
        if "i8" in outs:
            low = bits_of_f32(u - ln_sh).astype(np.int64) & 0xFF
            out.append(torch.tensor(low).to(torch.uint8).view(torch.int8))
        if "f" in outs:
            out.append(ln_s * (u - MAGIC))
        return out
    lvl = torch.clamp(torch.round(t) - ln_sh, lo, hi)
    if "i8" in outs:
        out.append(torch.trunc(lvl).to(torch.int8))
    if "f" in outs:
        out.append(ln_s * (lvl + ln_sh))
    return out


SPECIAL = [("spread", CS.LN_SCAL8, CS.LN_SCAL16, 0.0, False, 1.0)] + [
    (name, scal, scal, outlier, name == "fractional", gamma)
    for name, (scal, outlier, _, gamma) in CS.LN_SPECIAL.items()]


@pytest.mark.parametrize("case", SPECIAL, ids=[c[0] for c in SPECIAL])
@pytest.mark.parametrize("h", [128, 384, 768])
def test_the_kernels_chain_equals_the_plain_versions(case, h):
    name, s8, s16, outlier, frac, gamma = case
    y8, r8, y, r, gb, lnv = (torch.from_numpy(a) for a in CS.ln_inputs(
        37, h, seed=h, outlier=outlier, frac_shift=frac, gamma=gamma))
    s8, s16 = (torch.tensor([v], dtype=F32) for v in (s8, s16))
    rqs = CS.LN_SPECIAL[name][2] if name in CS.LN_SPECIAL else (True, False)
    for rq in rqs:
        kw = dict(eps=1e-12, res_quant=rq)
        (got,) = emulate_add_ln(y8, r8, gb, s8, None, res_bits=8, ln_bits=8,
                                y_payload=True, r_payload=True, outs=("i8",),
                                **kw)
        assert torch.equal(got, EK.fused_add_ln_payload_ref(y8, r8, gb, s8,
                                                            **kw)), rq
        got = emulate_add_ln(y, r, gb, s8, None, res_bits=8, ln_bits=8,
                             y_payload=False, r_payload=False,
                             outs=("i8", "f"), **kw)
        want = EK.fused_add_ln_ref(y, r, gb, s8, **kw)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), rq
        for rv, res_mode in ((r8, "i8"), (r, "f")):
            for sc, lv, bits in ((s8, None, 8), (s16, None, 16),
                                 (s8, lnv, 16)):
                for ln_out in ("emit", "f"):
                    ln_bits = 8 if ln_out == "emit" else bits
                    (got,) = emulate_add_ln(
                        y, rv, gb, sc,
                        None if lv is None else tuple(lv[i:i + 1]
                                                      for i in range(4)),
                        res_bits=bits, ln_bits=ln_bits, y_payload=False,
                        r_payload=res_mode == "i8",
                        outs=("i8",) if ln_out == "emit" else ("f",), **kw)
                    want = EK.flex_add_ln_ref(
                        y, rv, gb, sc, lv, res_mode=res_mode, res_bits=bits,
                        ln_bits=ln_bits, ln_out=ln_out, **kw)
                    assert torch.equal(got, want), (rq, res_mode, bits,
                                                    ln_out)
