"""The MobileBERT layer kernel's exact forms, on the CPU.

On the card the layer kernel (K8, ``csrc/int8_mb_layer.cu``) runs the
attention's arithmetic from ``csrc/attn_common.cuh`` (K7's) on wgmma
fragments of 128-row tiles of whole sequences, and replaces the plain
formulas with forms that are exact by construction:

- the integer path (every shift an integer of at most 128): a shift
  times a payload sum as the bits of the int32 product plus those of
  1.5 * 2^23 (``shift_term``), the scores and the context as the
  difference of two biased floats, and a site's level taken on the
  biased value, its int8 payload the low byte (``site_lvl`` /
  ``site_bits``);
- the payload sums taken from the emitted bytes (q's and k's per head
  from the [q | k] epilogue, v's per 32-key block from v^T's, the probs'
  from their packed A fragments), and at S = 32 two sequences in a
  warpgroup's 64 rows: each warp takes its own sequence's 32 keys of the
  warpgroup's 64, and the other sequence's probs bytes are zero.

These tests emulate each form in float32 / int32 numpy arithmetic over
its domain and hold it against the plain formula, then a tile's
attention as the kernel walks it (two warpgroups of 64 rows, four warps
of 16, head by head) against ``int8_attention_qkv_ref`` at S = 32, 64
and 128.

Tolerances: none; every comparison is exact (float32 values compared
with ``==``, so -0 and +0 agree; payloads bitwise).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke as CS
from transformer_quantization_tpu_torch.ops.kernels import engine_kernels as EK

F32 = np.float32
BIAS = F32(12582912.0)        # 1.5 * 2^23
BIAS_BITS = 0x4B400000
LOG2E = F32(EK.LOG2E)
SHIFTS = np.arange(-128, 129).astype(F32)   # every integer-path shift


def i2f(v):
    """int32 -> float32 by the bias, exact for |v| < 2^22."""
    return (np.asarray(v, np.int32) + np.int32(BIAS_BITS)).view(F32) - BIAS


def shift_term(sh, s, ints: bool):
    """attn_common.cuh's shift_term: sh * s, or (ints) the int32 product
    plus the bias's bits, read as a float."""
    if ints:
        return (np.asarray(sh).astype(np.int32) * np.asarray(s, np.int32)
                + np.int32(BIAS_BITS)).view(F32)
    return F32(sh) * i2f(s) if np.ndim(sh) == 0 else sh * i2f(s)


def add_bits(acc, biased):
    """__int_as_float(acc + __float_as_int(biased))"""
    return (np.asarray(acc, np.int32) + biased.view(np.int32)).view(F32)


def clip8(r):
    return np.minimum(np.maximum(r, F32(-128.0)), F32(127.0))


def site_lvl(x, sh, ints: bool):
    """The scores site's level as a float: clip(rint(x) - sh), or (ints)
    clip((x + 1.5 * 2^23) - (1.5 * 2^23 + sh))."""
    if ints:
        return clip8((x + BIAS) - (BIAS + sh))
    return clip8(np.rint(x) - sh)


def site_bits(x, sh, ints: bool):
    """A site's int8 payload: the low byte of clamp((x + 1.5 * 2^23) -
    sh) between 1.5 * 2^23 - 128 and + 127, or the truncated level."""
    if ints:
        u = np.minimum(np.maximum((x + BIAS) - sh, BIAS - F32(128.0)),
                       BIAS + F32(127.0))
        return (u.view(np.uint32) & 0xFF).astype(np.uint8).view(np.int8)
    return np.trunc(clip8(np.rint(x) - sh)).astype(np.int8)


def plain_site(x, sh):
    """The plain versions' payload: clip(round(x) - sh) cast to int8."""
    return torch.clamp(torch.round(torch.from_numpy(x)) - float(sh), -128,
                       127).to(torch.int8).numpy()


def test_the_scores_integer_form_equals_the_plain_sum():
    """scores = ((acc + q_sh ksum) + k_sh qsum) + d q_sh k_sh: as the
    integer path's bits of (1.5 * 2^23 + acc + q_sh ksum) less (1.5 * 2^23
    - k_sh qsum - d q_sh k_sh), for every pair of integer shifts, at the
    corners of the domain (|q.k| <= 32 * 128^2, head sums of 32 bytes)
    and on seeded sums inside it."""
    rng = np.random.RandomState(0)
    q_sh, k_sh = (a.reshape(-1, 1) for a in np.meshgrid(SHIFTS, SHIFTS))
    corners = [-(32 * 128 * 128), 32 * 128 * 128 - 1, 0]
    sums = [-4096, 4064, 0]
    acc = np.concatenate([np.array(corners * 9), rng.randint(
        -32 * 128 * 128, 32 * 128 * 128, 48)]).astype(np.int32)
    ksum = np.concatenate([np.repeat(sums, 9), rng.randint(-4096, 4065, 48)])
    qsum = np.concatenate([np.tile(np.repeat(sums, 3), 3),
                           rng.randint(-4096, 4065, 48)])
    dqk = (F32(32.0) * q_sh) * k_sh
    qk = k_sh * i2f(qsum)[None, :]
    kq = shift_term(q_sh, ksum[None, :], True)
    got = add_bits(acc[None, :], kq) - (BIAS - (qk + dqk))
    want = (((acc.astype(F32)[None, :] + q_sh * ksum.astype(F32)[None, :])
             + k_sh * qsum.astype(F32)[None, :]) + dqk)
    general = ((i2f(acc)[None, :] + shift_term(q_sh, ksum[None, :], False))
               + qk) + dqk
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(general, want)


def test_the_context_integer_form_equals_the_plain_sum():
    """ctx = ((p.v + p_sh vsum) + v_sh psum) + T p_sh v_sh: as the
    integer path's difference of two biased floats, for every pair of
    integer shifts and each seq, at the domain's corners (|p.v| <= 2^21,
    v's and the probs' sums over up to 128 keys) and on seeded sums."""
    rng = np.random.RandomState(1)
    p_sh, v_sh = (a.reshape(-1, 1) for a in np.meshgrid(SHIFTS, SHIFTS))
    top = 128 * 128 * 128
    acc = np.concatenate([np.array([-top, top - 1, 0] * 9),
                          rng.randint(-top, top, 48)]).astype(np.int32)
    sums = [-16384, 16256, 0]
    vsum = np.concatenate([np.repeat(sums, 9), rng.randint(-16384, 16257, 48)])
    psum = np.concatenate([np.tile(np.repeat(sums, 3), 3),
                           rng.randint(-16384, 16257, 48)])
    for seq in (32, 64, 128):
        tpv = (F32(seq) * p_sh) * v_sh
        vp = v_sh * i2f(psum)[None, :]
        pvd = shift_term(p_sh, vsum[None, :], True)
        got = add_bits(acc[None, :], pvd) - (BIAS - (vp + tpv))
        want = (((acc.astype(F32)[None, :] + p_sh * vsum.astype(F32)[None, :])
                 + v_sh * psum.astype(F32)[None, :]) + tpv)
        np.testing.assert_array_equal(got, want)


def _site_inputs():
    """float32 values for a site: seeded values over every binade up to
    2^26, every half-integer in [-300, 300] and its neighbours one and two
    ulps away, the edges of the bias's exact range and huge values."""
    rng = np.random.RandomState(2)
    spread = (rng.uniform(-1, 1, 20000) * 2.0 ** rng.uniform(-10, 26, 20000))
    half = np.arange(-300, 300) + F32(0.5)
    near = [half]
    for direction in (np.inf, -np.inf):
        x = half.astype(F32)
        for _ in range(2):
            x = np.nextafter(x, F32(direction))
            near.append(x)
    edges = np.array([2.0 ** 22, -2.0 ** 22, 2.0 ** 22 + 1, -2.0 ** 22 - 1,
                      2.0 ** 22 - 0.5, -2.0 ** 22 + 0.5, 3e38, -3e38, 0.0,
                      -0.0])
    return np.concatenate([spread, *near, edges]).astype(F32)


def test_the_sites_on_the_biased_value_equal_round_then_clip():
    """A site on the integer path: the scores' level clip((x + 1.5 *
    2^23) - (1.5 * 2^23 + sh)), and a payload's low byte of the biased
    clamp, against clip(round(x) - sh) and the plain int8 cast, for every
    integer shift and values of every size (beyond 2^22 both saturate
    alike)."""
    x = _site_inputs()
    for sh in SHIFTS:
        want = plain_site(x, sh)
        np.testing.assert_array_equal(site_lvl(x, sh, True), want)
        np.testing.assert_array_equal(site_bits(x, sh, True), want)
        np.testing.assert_array_equal(site_bits(x, sh, False), want)


def _softmax_row(acc, qsum, kq, m2, s, ints, skip):
    """attn_common.cuh's softmax on one row's own keys: the probs'
    payload. acc: the row's int32 scores; kq / m2: the keys' constants."""
    qk = s["k_sh"] * i2f(qsum)
    if ints:
        scr = add_bits(acc, kq) - (BIAS - (qk + s["dqk"]))
    else:
        scr = ((i2f(acc) + kq) + qk) + s["dqk"]
    sv = s["a"] * site_lvl(scr * s["qk_over_sc"], s["sc_sh"], ints) + m2
    if not skip:
        sv = sv - sv.max()
    e = torch.exp2(torch.from_numpy(sv)).numpy()
    w = s["inv_ps"] / F32(e.astype(np.float64).sum())
    return site_bits(e * w, s["p_sh"], ints)


def _site(scal, seq):
    """attn_common.cuh's site_of: the scalars in the chain's forms."""
    q_s, q_sh, k_s, k_sh, v_s, v_sh, sc_s, sc_sh, p_s, p_sh, c_s, c_sh = (
        F32(v) for v in scal[0])
    a = (sc_s * F32(EK._rsqrt_d(32))) * LOG2E
    return dict(q_sh=q_sh, k_sh=k_sh, v_sh=v_sh, sc_sh=sc_sh, p_sh=p_sh,
                c_sh=c_sh, qk_over_sc=(q_s * k_s) * (F32(1.0) / sc_s),
                dqk=(F32(32.0) * q_sh) * k_sh, a=a, ash=a * sc_sh,
                inv_ps=F32(1.0) / p_s, pv_over_c=(p_s * v_s) * (F32(1.0) / c_s),
                tpv=(F32(seq) * p_sh) * v_sh)


def k8_tile_attention(q8, k8, v8, mask, scal, seq, skip, cols=False):
    """The context payload of 128-row tiles of whole sequences (``cols``:
    64-row tiles, seq <= 64) as the layer kernel computes it: per
    warpgroup and head, the scores against the warpgroup's keys (rows
    split: its 64 rows and all 128 keys at S = 128, its own 64 below;
    ``cols``: the tile's 64 rows and keys, the warpgroup's two heads),
    each warp's own sequence's keys (at S = 32 half of them), the probs
    bytes of the other sequence zero in p.v's operand, the sums from the
    bytes (q's and k's per head, v's per 32-key block, the probs' over the
    operand row), and the context's site."""
    s = _site(scal, seq)
    ints = all(abs(s[k]) <= 128 and np.rint(s[k]) == s[k]
               for k in ("q_sh", "k_sh", "v_sh", "sc_sh", "p_sh", "c_sh"))
    i32 = lambda a: a.astype(np.int32)  # noqa: E731
    heads = [slice(32 * h, 32 * h + 32) for h in range(4)]
    tr = 64 if cols else 128
    m2_all = mask.reshape(-1) * LOG2E + s["ash"]
    out = np.zeros((q8.shape[0], 128), np.int8)
    for t0 in range(0, q8.shape[0], tr):
        q, k, v = (a[t0:t0 + tr] for a in (q8, k8, v8))
        m2 = m2_all[t0:t0 + tr]
        qsum = np.stack([i32(q[:, hd]).sum(1) for hd in heads], 1)
        ksum = np.stack([i32(k[:, hd]).sum(1) for hd in heads], 1)
        vs32 = np.stack([i32(v[32 * b:32 * b + 32]).sum(0)
                         for b in range(tr // 32)])
        for wg in range(2):
            row_wg = 0 if cols else 64 * wg
            key0 = 0 if seq == 128 else row_wg
            n = 128 if seq == 128 else 64
            keys = slice(key0, key0 + n)
            for h in ([2 * wg, 2 * wg + 1] if cols else range(4)):
                hd = heads[h]
                kq = shift_term(s["q_sh"], ksum[keys, h], ints)
                acc = i32(q[row_wg:row_wg + 64, hd]) @ i32(k[keys, hd]).T
                pk = np.zeros((64, n), np.int8)
                for r in range(64):
                    sq = (r // 16) >> 1 if seq == 32 else 0
                    own = slice(32 * sq, 32 * sq + 32) if seq == 32 else (
                        slice(0, n))
                    pk[r, own] = _softmax_row(acc[r, own], qsum[row_wg + r, h],
                                              kq[own], m2[keys][own], s, ints,
                                              skip)
                psum = i32(pk).sum(1)
                ctx_acc = i32(pk) @ i32(v[keys, hd])
                for r in range(64):
                    sq = (r // 16) >> 1 if seq == 32 else 0
                    vb = 0 if seq == 128 else (
                        (0 if cols else 2 * wg) + (sq if seq == 32 else 0))
                    vsum = sum(vs32[b, hd] for b in range(vb, vb + seq // 32))
                    pvd = shift_term(s["p_sh"], vsum, ints)
                    vp = s["v_sh"] * i2f(psum[r])
                    if ints:
                        ctx = (add_bits(ctx_acc[r], pvd)
                               - (BIAS - (vp + s["tpv"])))
                    else:
                        ctx = ((i2f(ctx_acc[r]) + pvd) + vp) + s["tpv"]
                    out[t0 + row_wg + r, hd] = site_bits(
                        ctx * s["pv_over_c"], s["c_sh"], ints)
    return out


@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("scalars", ["spread", "saturate", "fractional"])
@pytest.mark.parametrize("seq,cols", [(32, False), (64, False),
                                      (128, False), (32, True), (64, True)])
def test_the_tile_attention_as_the_kernel_walks_it(seq, cols, scalars,
                                                   skip):
    """A tile's attention the kernel's way, its warpgroups splitting the
    rows or (``cols``, 64-row tiles at S <= 64) the heads (integer path for
    the 'spread' and 'saturate' scalars, the general one for
    'fractional'), equals the plain attention over [q | k] and v at cols
    (0, 1, 0), on seeded payloads of 128 / seq sequences with padding."""
    b = 128 // seq
    qkv, mask, scal = CS.attn_inputs(b, seq, 32, 4, 60 + seq, scalars,
                                     full_pad=not skip)
    q8, k8, v8 = (qkv[:, 128 * i:128 * i + 128] for i in range(3))
    got = k8_tile_attention(q8, k8, v8, mask, scal, seq, skip, cols)
    qk = torch.from_numpy(np.ascontiguousarray(qkv[:, :256]))
    want = EK.int8_attention_qkv_ref(
        qk, qk, torch.from_numpy(np.ascontiguousarray(v8)),
        torch.from_numpy(mask), torch.from_numpy(scal), n_heads=4, seq=seq,
        hidden=128, cols=(0, 1, 0), skip_max=skip)
    np.testing.assert_array_equal(got, want.numpy())
