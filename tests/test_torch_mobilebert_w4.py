"""Port parity for MobileBERT at W4A8: the packed int4 (``w4``) forms of
K6 (``int8_matmul_norm``, the NoNorm ``int8_matmul_add_ln``) and K8
(``int8_mb_layer_ln``), and the W4A8 engine, against the JAX package.

- K6's plain versions on split-half packed int4 weights, at K = 128 (one
  64-byte packed row holds both halves) and K = 512, with no residual
  and with one, res_quant both ways: bit-identical to JAX's ``*_ref`` and
  to the int8 form on the unpacked weight (seeded numpy inputs);
- the whole layer's plain version (``int8_mb_layer_ln_ref``) at
  MobileBERT-uncased's widths with every weight packed and with mixed
  flags: bit-identical to the JAX package's per-op route on its
  ``*_ref`` functions (the attention, whose softmax sums in float64 in
  the port, fed to both from the port's; it has its own parity tests),
  and the chain of the wrappers (their plain versions on the CPU)
  bit-identical to it; the plan's refusals and packed shapes;
- the K8 kernel's stage layout emulated in numpy: the producer's packed
  boxes and the unpacking warps' byte operations give each K chunk's
  int8 tile that an int8 weight would (K = 128, 256, 512);
- the W4A8 engine at the registry's tiny widths (2 layers, H = 64,
  bottleneck 32, 4 heads), the port's calibration carried into JAX
  (4-bit current-minmax weights, 8-bit acts), both packages packing and
  planning on their own: packed weights and ``w4`` flags equal, and
  logits within rtol 1e-3 / atol 2e-3 of JAX's engine (jitted, its XLA
  backend) at S = 32 on the layer kernel's plain route and at S = 16 on
  the chain.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as G
import chip_smoke as CS
from test_torch_mobilebert_train import to_jax
from transformer_quantization_tpu.models import mobilebert as JM
from transformer_quantization_tpu.ops.pallas import engine_kernels as JEK
from transformer_quantization_tpu_torch.models import mobilebert as TM
from transformer_quantization_tpu_torch.models.registry import get_family
from transformer_quantization_tpu_torch.ops.int_linear import unpack_int4
from transformer_quantization_tpu_torch.ops.kernels import engine_kernels as EK
from transformer_quantization_tpu_torch.training import calibration as TC

torch.set_num_threads(2)

RTOL, ATOL = 1e-3, 2e-3


def _t(a):
    return torch.from_numpy(np.array(a))


def _pack(w):
    """int4 levels (N, K) in [-8, 7] -> the split-half uint8 (N, K/2)."""
    k2 = w.shape[1] // 2
    return ((w[:, :k2] & 0xF) | ((w[:, k2:] & 0xF) << 4)).astype(np.uint8)


def _w4_plan(flat, w4, seed):
    """``chip_smoke.mb_inputs``' layer plan with the flagged matmuls' weights
    replaced by seeded int4 levels, packed, and their colsums redone."""
    rng = np.random.RandomState(seed)
    out = list(flat)
    mm = [i for i, a in enumerate(flat) if a.dtype == np.int8]
    for i, f in zip(mm, w4):
        if f:
            w = rng.randint(-8, 8, flat[i].shape).astype(np.int8)
            out[i] = _pack(w)
            out[i + 1] = out[i + 1].copy()
            out[i + 1][1] = w.astype(np.float32).sum(1)
    return out


@pytest.mark.parametrize("k", [128, 512])
@pytest.mark.parametrize("residual", ["none", "rq0", "rq1"])
def test_k6_w4_refs_match_jax(k, residual):
    rng = np.random.RandomState(k + len(residual))
    m, n = 96, 128
    x8 = rng.randint(-128, 128, (m, k)).astype(np.int8)
    w = rng.randint(-8, 8, (n, k)).astype(np.int8)
    vecs = np.stack([0.05 / np.sqrt(k) * (0.5 + rng.rand(n)),
                     w.astype(np.float32).sum(1), 0.1 * rng.randn(n),
                     0.04 + 0.02 * rng.rand(n), np.full(n, 3.0)]).astype(
                         np.float32)
    scal = np.array([[0.03, 5.0]], np.float32)
    gb = np.stack([np.linspace(0.5, 1.5, n),
                   np.linspace(-0.1, 0.1, n)]).astype(np.float32)
    ls = np.array([[1.0, 0.0, 0.04, 2.0, 0.06, -3.0, 0.05, 1.0]], np.float32)
    r8 = rng.randint(-128, 128, (m, n)).astype(np.int8)
    kw = dict(eps=0.0, norm="nonorm", res_quant=residual == "rq1")
    args = (x8, _pack(w), vecs, scal)
    if residual == "none":
        want = JEK.int8_matmul_norm_ref(*args, gb, ls, w4=True, **kw)
        got = EK.int8_matmul_norm_ref(*map(_t, args + (gb, ls)), w4=True,
                                      **kw)
        int8 = EK.int8_matmul_norm_ref(*map(_t, (x8, w, vecs, scal, gb, ls)),
                                       **kw)
    else:
        want = JEK.int8_matmul_add_ln_ref(*args, r8, gb, ls, w4=True, **kw)
        got = EK.int8_matmul_add_ln_ref(*map(_t, args + (r8, gb, ls)),
                                        w4=True, **kw)
        int8 = EK.int8_matmul_add_ln_ref(
            *map(_t, (x8, w, vecs, scal, r8, gb, ls)), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), int8.numpy())
    assert len(np.unique(got.numpy())) > 64


def _jax_layer(h8, mask, ascal, flat, kw, attention):
    """The JAX package's per-op route of one MobileBERT layer
    (``mobilebert_encoder_engine(fuse_layer=False)`` on its ``*_ref``
    backend) with ``attention`` for the attention step."""
    it, w4 = iter(flat), iter(kw["w4"])
    res_ao, res_ffn, res_out, res_obn = kw["res"]
    nk = dict(eps=0.0, norm="nonorm")

    def take(n):
        return [next(it) for _ in range(n)]

    def branch(x8):
        w, v, s, gb, ns = take(5)
        return JEK.int8_matmul_norm_ref(x8, w, v, s, gb, ns, res_quant=False,
                                        w4=next(w4), **nk)

    def ffn(x8, rq):
        wi, vi, si, wd, vd, sd, gb, ns = take(8)
        return JEK.int8_ffn_ln_ref(x8, wi, vi, si, wd, vd, sd, x8, gb, ns,
                                   activation="relu", res_quant=rq,
                                   w4i=next(w4), w4d=next(w4), **nk)

    li8 = branch(h8)
    sh8 = branch(h8)
    wq, vq, sq, wv, vv, sv = take(6)
    qk8 = JEK.int8_matmul_ref(sh8, wq, vq, sq, w4=next(w4))
    v8 = JEK.int8_matmul_ref(h8, wv, vv, sv, w4=next(w4))
    c8 = jnp.asarray(attention(np.asarray(qk8), np.asarray(v8)))
    wo, vo, so, gb, ns = take(5)
    x8 = JEK.int8_matmul_add_ln_ref(c8, wo, vo, so, li8, gb, ns,
                                    res_quant=res_ao, w4=next(w4), **nk)
    for j in range(kw["n_ffn"]):
        x8 = ffn(x8, res_ffn[j])
    y8 = ffn(x8, res_out)
    wb, vb, sb, gb, ns = take(5)
    return JEK.int8_matmul_add_ln_ref(y8, wb, vb, sb, h8, gb, ns,
                                      res_quant=res_obn, w4=next(w4), **nk)


@pytest.mark.parametrize("flags", ["all", "mixed"])
def test_k8_w4_ref_matches_jax_route(flags):
    seq, b = 32, 3
    h8, mask, ascal, flat = CS.mb_inputs(b, seq, 61)
    kw = CS.mb_kwargs(seq)
    n = len(kw["w4"])
    kw["w4"] = tuple(flags == "all" or j % 3 != 1 for j in range(n))
    flat = _w4_plan(flat, kw["w4"], 62)
    t = [_t(a) for a in flat]
    args = (_t(h8), _t(mask), _t(ascal))
    akw = dict(n_heads=4, seq=seq, hidden=128, cols=(0, 1, 0),
               skip_max=kw["skip_max"])

    def attention(qk8, v8):
        return EK.int8_attention_qkv_ref(_t(qk8), _t(qk8), _t(v8), args[1],
                                         args[2], **akw).numpy()

    want = _jax_layer(jnp.asarray(h8), jnp.asarray(mask), jnp.asarray(ascal),
                      [jnp.asarray(a) for a in flat], kw, attention)
    got = EK.int8_mb_layer_ln_ref(*args, t, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(np.unique(got.numpy())) > 64
    # the wrappers' chain and the whole-layer wrapper (their plain versions
    # on the CPU), and the K8 form on the unpacked weights
    np.testing.assert_array_equal(
        EK.mb_layer_chain(*args, t, **kw).numpy(), got.numpy())
    np.testing.assert_array_equal(
        EK.int8_mb_layer_ln(*args, t, **kw).numpy(), got.numpy())
    mm = [i for i, a in enumerate(t) if a.dtype in (torch.int8, torch.uint8)]
    ks = EK._mb_matmul_ks(True, kw["n_ffn"], 512, 128, 512)
    unpacked = list(t)
    for i, k, f in zip(mm, ks, kw["w4"]):
        if f:
            unpacked[i] = unpack_int4(t[i], k)
    np.testing.assert_array_equal(
        EK.int8_mb_layer_ln_ref(*args, unpacked, **dict(
            kw, w4=(False,) * n)).numpy(), got.numpy())


def test_k8_w4_refusals_and_shapes():
    """K8 takes any per-matmul w4 tuple at MobileBERT-uncased's widths; a
    packed K of 384 (no whole two-chunk box) is refused when the plan is
    made, so the plan routes that layer to the chain."""
    kw = dict(seq=128, head_dim=32, n_heads=4, attn_case="shared_kq",
              activation="relu", n_ffn=3, attn_bits=(8, 8, 8))
    n = 7 + 1 + 2 * 3
    for w4 in ((True,) * n, tuple(j % 2 == 0 for j in range(n))):
        assert EK.mb_layer_refusal(h=512, inter=512, w4=w4, **kw) is None
    why = EK.mb_layer_refusal(h=384, inter=512, w4=(True,) * n, **kw)
    assert why is not None and "w4" in why and "384" in why
    assert EK.mb_layer_refusal(h=384, inter=512, w4=(False,) * n,
                               **kw) is None
    # K = 384 only where that matmul is packed: bn_in / bn_attn / v (K = h)
    w4 = tuple(j not in (0, 1, 3) for j in range(n))
    assert EK.mb_layer_refusal(h=384, inter=512, w4=w4, **kw) is None
    shapes = EK._mb_flat_shapes(True, 3, 512, 128, 512, (True,) * n)
    weights = [s for s in shapes if s[1] == torch.uint8]
    assert len(weights) == n and weights[0][0] == (128, 256)
    assert weights[2][0] == (256, 64) and weights[-1][0] == (512, 64)


def _sw128(tile):
    """A 128 x 128-byte tile as the 128-byte TMA swizzle lays it out:
    16-byte chunk c of row r at chunk c ^ (r & 7)."""
    out = np.empty_like(tile)
    for r in range(128):
        for c in range(8):
            d = c ^ (r & 7)
            out[r, 16 * d:16 * d + 16] = tile[r, 16 * c:16 * c + 16]
    return out


def _nibbles(v, hi):
    """``nibbles<HI>``: (n ^ 8) - 8 in every byte, bytewise (``__vsub4``)."""
    n = ((v >> 4) if hi else v) & 0x0F
    return ((n ^ 8).astype(np.int16) - 8).astype(np.int8).view(np.uint8)


@pytest.mark.parametrize("k", [128, 256, 512])
def test_k8_w4_stage_layout_emulated(k):
    """The producer's boxes and the unpacking warps' stores
    (``csrc/int8_mb_layer.cu``: ``produce``, ``unpack_box``,
    ``unpack_k128``), emulated byte for byte over the four-stage ring:
    every K chunk's stage holds the swizzled int8 tile of an int8
    weight's chunk."""
    rng = np.random.RandomState(k)
    w = rng.randint(-8, 8, (128, k)).astype(np.int8)
    packed = _pack(w)
    kch, stage = k // 128, 128 * 128
    ring = np.zeros((4, stage), np.uint8)
    s0 = 3   # the unit's first stage: it wraps around the ring
    if kch == 1:
        ring[s0, stage // 2:] = packed.reshape(-1)   # over the second half
        st = ring[s0].copy()
        for h in range(2):   # two rounds of 64 rows
            src = st[stage // 2 + 64 * 64 * h:][:64 * 64].reshape(256, 16)
            vals = src.copy()   # every thread reads before any writes
            for j in range(256):
                r, c = 64 * h + j // 4, j % 4
                st[r * 128 + ((c ^ (r & 7)) << 4):][:16] = _nibbles(
                    vals[j], False)
                st[r * 128 + (((c + 4) ^ (r & 7)) << 4):][:16] = _nibbles(
                    vals[j], True)
        ring[s0] = st
    else:
        for b in range(kch // 2):
            hs, lo = (s0 + kch // 2 + b) % 4, (s0 + b) % 4
            ring[hs] = packed[:, 128 * b:128 * b + 128].reshape(-1)
            for r in range(128):   # a row read whole, then written
                row = ring[hs, r * 128:r * 128 + 128].copy()
                for c in range(8):
                    off = r * 128 + ((c ^ (r & 7)) << 4)
                    ring[lo, off:off + 16] = _nibbles(row[16 * c:][:16],
                                                      False)
                    ring[hs, off:off + 16] = _nibbles(row[16 * c:][:16], True)
    for kc in range(kch):
        want = _sw128(w[:, 128 * kc:128 * kc + 128].view(np.uint8))
        np.testing.assert_array_equal(ring[(s0 + kc) % 4].reshape(128, 128),
                                      want, err_msg=f"K={k} chunk {kc}")


KW = dict(get_family("mobilebert").tiny_preset, num_labels=2)


@pytest.fixture(scope="module")
def engines():
    """The port's tiny MobileBERT, calibrated for W4A8, carried into JAX;
    each package's W4A8 packing and engine plan."""
    tcfg, jcfg = TM.MobileBertConfig(**KW), JM.MobileBertConfig(**KW)
    d4 = dataclasses.replace(TC.w8a8_defaults(), n_bits=4, n_bits_act=8)
    tp, tq, ts = TC.calibrated_mobilebert(tcfg, batch_size=2, seq=32,
                                          device="cpu", defaults=d4)
    jp, js = to_jax(tp, ts)
    jq = JM.declare_mobilebert_sites(
        dataclasses.replace(G._w8a8_defaults(), n_bits=4, n_bits_act=8), jcfg)
    # jitted: one program, where eagerly each op compiles on first use
    # (the packed bytes equal the eager ones)
    jint = jax.jit(lambda p, qs: JM.build_mobilebert_int_params(
        p, jq, qs, use_int4=True))(jp, js)
    jst, jplan, _ = JM.build_mobilebert_engine(jp, jcfg, jq, js,
                                               int_params=jint)
    tst, tplan, tint = TM.build_mobilebert_engine(tp, tcfg, tq, ts,
                                                  use_int4=True,
                                                  device="cpu")
    return dict(tcfg=tcfg, jcfg=jcfg, tp=tp, tq=tq, ts=ts, jp=jp, jq=jq,
                js=js, jint=jint, jst=jst, jplan=jplan, tst=tst, tplan=tplan,
                tint=tint)


def test_w4a8_plan_matches_jax(engines):
    e = engines
    assert e["tst"].w4 == tuple(tuple(f) for f in e["jst"].w4)
    assert all(all(f) for f in e["tst"].w4)
    for name, p in e["jint"].items():
        if "w_packed" in p:
            np.testing.assert_array_equal(e["tint"][name]["w_packed"].numpy(),
                                          np.asarray(p["w_packed"]),
                                          err_msg=name)


@pytest.mark.parametrize("seq,fuse", [(32, True), (16, False)],
                         ids=["s32-layer", "s16-chain"])
def test_w4a8_engine_matches_jax(engines, seq, fuse):
    e = engines
    rng = np.random.RandomState(seq)
    batch = {"input_ids": rng.randint(0, KW["vocab_size"], (4, seq)).astype(
                 np.int32),
             "attention_mask": (np.arange(seq)[None, :]
                                < rng.randint(seq // 2, seq + 1, (4, 1))
                                ).astype(np.float32),
             "token_type_ids": np.zeros((4, seq), np.int32)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = jax.jit(lambda p, b: JM.mobilebert_engine_apply(
        p, b, e["jcfg"], e["jq"], e["js"], e["jst"], e["jplan"], e["jint"],
        backend="xla")["logits"])(e["jp"], jb)
    EK.reset_launches()
    got = TM.mobilebert_engine_apply(e["tp"], batch, e["tcfg"], e["tq"],
                                     e["ts"], e["tst"], e["tplan"], e["tint"],
                                     fuse_layer=fuse, device="cpu")["logits"]
    assert set(EK.LAUNCHES.values()) == {0}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
