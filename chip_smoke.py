"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero; nothing is caught):

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: compile the engine's CUDA kernels from ``csrc/`` (timed);
3. kernels: each kernel against its plain PyTorch version on the card, on
   the inputs the main path gives it (layer 0 of BERT-base at B=128,
   S=128): max level difference, mismatches, kernel / plain / bound ms,
   and for the matmul ``torch._int_mm`` ms (the int32 product only); then
   the composed chains against their plain versions; then the kernels'
   other built shapes (ragged matmul tiles, seq 64 / 32, H=256). Every
   comparison must be bit-identical;
4. main path at full BERT-base width: random init from ``--seed``,
   one-batch W8A8 calibration, int8 packing, the engine plan, and three
   request batches (B=128, S=128, seeded padding) through
   ``bert_engine_apply``; launch counts per forward, logits against the
   same engine on the plain versions (rtol 1e-3 / atol 2e-3), and engine
   / fake-quant simulation / bf16 dense seq/s as the median and range of
   five host-clock windows of at least one second each.

The last lines are the kernels JSON (times per encoder layer: the sum
over that layer's launches of each kernel), the nvidia-smi line, and
``{"ok": true, "device": {...}}``. Imports torch and the port only.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from transformer_quantization_tpu_torch.models import bert as B
from transformer_quantization_tpu_torch.ops import engine as ENG
from transformer_quantization_tpu_torch.ops.kernels import build as KB
from transformer_quantization_tpu_torch.ops.kernels import engine_kernels as EK
from transformer_quantization_tpu_torch.quant.qconfig import QuantMode
from transformer_quantization_tpu_torch.training import calibration as CAL

# H100 SXM dense peaks (NVIDIA data sheet) used for the bounds
PEAK_INT8_OPS = 1979e12
PEAK_F32_OPS = 67e12   # outside the tensor cores
PEAK_BYTES = 3.35e12
BATCH, SEQ = 128, 128
LOGIT_RTOL, LOGIT_ATOL = 1e-3, 2e-3


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def timed_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call, CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(ops: float, nbytes: float, peak: float = PEAK_INT8_OPS):
    """(least ms, 'operations' | 'bytes') on the H100 SXM peaks."""
    t_ops, t_bytes = ops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def compare(got: torch.Tensor, want: torch.Tensor, name: str) -> dict:
    """Level differences of two int8 payloads; fails unless bit-identical
    (kernels and plain versions sum in float64 and round once, so no
    summation order or device moves a level)."""
    torch.cuda.synchronize()
    diff = (got.to(torch.int32) - want.to(torch.int32)).abs()
    max_diff = int(diff.max())
    n_bad = int((diff > 0).sum())
    print(f"  {name}: max_level_diff={max_diff} mismatches={n_bad} "
          f"(of {diff.numel()})")
    if max_diff:
        fail(f"{name}: expected bit-identical, max level diff {max_diff} "
             f"on {n_bad} elements")
    return {"max_abs_err": max_diff, "mismatches": n_bad}


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def request_batches(cfg, n: int, seed: int):
    """``n`` (B, S) request batches with seeded padding lengths."""
    rng = np.random.RandomState(seed + 1)
    out = []
    for _ in range(n):
        lens = rng.randint(SEQ // 4, SEQ + 1, (BATCH, 1))
        out.append({
            "input_ids": rng.randint(0, cfg.vocab_size,
                                     (BATCH, SEQ)).astype(np.int32),
            "attention_mask": (np.arange(SEQ)[None, :] < lens
                               ).astype(np.float32),
            "token_type_ids": np.zeros((BATCH, SEQ), np.int32)})
    return out


def entry_value(params, cfg, qcfg, qstate, int_params, batch, dev):
    """The encoder's inputs on ``batch`` as ``bert_engine_apply`` makes
    them: the entry-site value (B, S, H) and the (B, S) mask bias."""
    ctx = B.make_ctx(qcfg, qstate, QuantMode(), int_params=int_params)
    ids, tt, pos, _ = B.prepare_inputs(batch, dev)
    with torch.no_grad():
        h = B._embeddings(ctx, params, cfg, ids, tt, pos, False, None)
    mask = (1.0 - torch.as_tensor(batch["attention_mask"], device=dev)
            ) * -10000.0
    return h, mask.contiguous()


def layer0_inputs(params, cfg, qcfg, qstate, int_params, plan, batch, dev):
    """The payloads layer 0 of the engine consumes and produces on
    ``batch``, computed with the plain versions."""
    h, mask = entry_value(params, cfg, qcfg, qstate, int_params, batch, dev)
    es = plan["entry_scal"]
    x8 = EK.quantize_payload(h.reshape(BATCH * SEQ, -1), es[0, 0], es[0, 1])
    lp = plan["layers"][0]
    qkv8 = EK.int8_matmul_ref(x8, lp["qkv"]["w"], lp["qkv"]["vecs"],
                              lp["qkv"]["scal"])
    return x8, mask, lp, qkv8


def check_kernels(params, cfg, qcfg, qstate, int_params, static, plan,
                  batch, dev) -> dict:
    """Phase 3: each kernel against its plain version on the card."""
    x8, mask, lp, qkv8 = layer0_inputs(params, cfg, qcfg, qstate,
                                       int_params, plan, batch, dev)
    m, h = x8.shape
    nh = cfg.num_attention_heads
    akw = dict(n_heads=nh, seq=SEQ, skip_max=static.attn_skip_max)
    c8 = EK.int8_attention_ref(qkv8, mask, lp["attn_scal"], **akw)
    ln1 = EK.fold_ln_scalars(lp["attn_out"]["vecs"], lp["ln1"]["scal"])
    if not torch.equal(ln1, lp["ln1"]["scal"]):
        fail("ln1 scalars [0:2] differ from the attn_out fold site")
    y8 = EK.int8_matmul_ref(c8, lp["attn_out"]["w"], lp["attn_out"]["vecs"],
                            lp["attn_out"]["scal"])
    hx8 = EK.fused_add_ln_payload_ref(y8, x8, lp["ln1"]["gb"], ln1,
                                      eps=static.ln_eps)
    i8 = EK.int8_matmul_ref(hx8, lp["inter"]["w"], lp["inter"]["vecs"],
                            lp["inter"]["scal"], activation="gelu_new")
    report = {}

    # K1: the four matmuls of a layer
    mm = [("qkv", x8, lp["qkv"], None), ("attn_out", c8, lp["attn_out"], None),
          ("inter", hx8, lp["inter"], "gelu_new"),
          ("dense", i8, lp["dense"], None)]
    k1 = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
          "max_abs_err": 0, "ops": 0.0, "bytes": 0.0}
    for tag, xin, mp, act in mm:
        w, vecs, scal = mp["w"], mp["vecs"], mp["scal"]
        n, k = w.shape
        got = EK.int8_matmul(xin, w, vecs, scal, activation=act)
        want = EK.int8_matmul_ref(xin, w, vecs, scal, activation=act)
        res = compare(got, want, f"int8_matmul[{tag}] {m}x{k}->{n}")
        t_k = timed_ms(lambda: EK.int8_matmul(xin, w, vecs, scal,
                                              activation=act))
        t_p = timed_ms(lambda: EK.int8_matmul_ref(xin, w, vecs, scal,
                                                  activation=act), iters=5)
        w_t = w.t()
        t_l = timed_ms(lambda: torch._int_mm(xin, w_t))
        ops, nbytes = 2.0 * m * n * k, m * k + n * k + 5 * n * 4 + m * n
        bnd, by = bound_ms(ops, nbytes)
        print(f"  int8_matmul[{tag}]: kernel {t_k:.4f} ms, plain {t_p:.4f} "
              f"ms, torch._int_mm (int32 product only) {t_l:.4f} ms, bound "
              f"{bnd:.4f} ms ({by}), {ops / t_k / 1e9:.1f} TOP/s")
        for key, val in (("ms", t_k), ("plain_ms", t_p), ("bound_ms", bnd),
                         ("library_ms", t_l), ("ops", ops),
                         ("bytes", nbytes)):
            k1[key] += val
        k1["max_abs_err"] = max(k1["max_abs_err"], res["max_abs_err"])
    k1["bound_by"] = bound_ms(k1.pop("ops"), k1.pop("bytes"))[1]
    report["int8_matmul"] = k1

    # K2: attention
    got = EK.int8_attention(qkv8, mask, lp["attn_scal"], **akw)
    res = compare(got, c8, f"int8_attention B={BATCH} T={SEQ} heads={nh}")
    t_k = timed_ms(lambda: EK.int8_attention(qkv8, mask, lp["attn_scal"],
                                             **akw))
    t_p = timed_ms(lambda: EK.int8_attention_ref(qkv8, mask,
                                                 lp["attn_scal"], **akw),
                   iters=5)
    d = h // nh
    ops, nbytes = 4.0 * BATCH * nh * SEQ * SEQ * d, 4 * m * h + mask.numel() * 4
    bnd, by = bound_ms(ops, nbytes)
    print(f"  int8_attention: kernel {t_k:.4f} ms, plain {t_p:.4f} ms, bound "
          f"{bnd:.4f} ms ({by})")
    report["int8_attention"] = {"ms": t_k, "plain_ms": t_p, "bound_ms": bnd,
                                "bound_by": by, "library_ms": None, **res}

    # K3: add + LayerNorm (twice per layer, same shape)
    gb = lp["ln1"]["gb"]
    got = EK.fused_add_ln_payload(y8, x8, gb, ln1, eps=static.ln_eps)
    res = compare(got, hx8, f"fused_add_ln_payload {m}x{h}")
    t_k = timed_ms(lambda: EK.fused_add_ln_payload(y8, x8, gb, ln1,
                                                   eps=static.ln_eps))
    t_p = timed_ms(lambda: EK.fused_add_ln_payload_ref(y8, x8, gb, ln1,
                                                       eps=static.ln_eps),
                   iters=5)
    ops, nbytes = 12.0 * m * h, 3.0 * m * h + 2 * h * 4 + 32
    bnd, by = bound_ms(ops, nbytes, PEAK_F32_OPS)
    print(f"  fused_add_ln_payload: kernel {t_k:.4f} ms, plain {t_p:.4f} ms,"
          f" bound {bnd:.4f} ms ({by})")
    report["fused_add_ln_payload"] = {
        "ms": 2 * t_k, "plain_ms": 2 * t_p, "bound_ms": 2 * bnd,
        "bound_by": by, "library_ms": None, **res}

    # the TPU's fused forms as chains of the kernels, each against its
    # plain version and its own bound (bytes: each input read once, the
    # int8 output written once)
    ao, ffn = lp["attn_out"], (lp["inter"], lp["dense"])
    w_bytes = lambda *mps: sum(mp["w"].numel() + 20 * mp["w"].shape[0]
                               for mp in mps)
    eps = static.ln_eps
    n1 = ffn[0]["w"].shape[0]
    margs = (c8, ao["w"], ao["vecs"], ao["scal"], x8, lp["ln1"]["gb"],
             lp["ln1"]["scal"])
    fargs = (hx8, ffn[0]["w"], ffn[0]["vecs"], ffn[0]["scal"], ffn[1]["w"],
             ffn[1]["vecs"], ffn[1]["scal"], hx8, lp["ln2"]["gb"],
             lp["ln2"]["scal"])
    fkw = dict(activation="gelu_new", eps=eps)
    largs = (x8, lp["qkv"]["w"], lp["qkv"]["vecs"], lp["qkv"]["scal"], mask,
             lp["attn_scal"], ao["w"], ao["vecs"], ao["scal"],
             lp["ln1"]["gb"], lp["ln1"]["scal"], ffn[0]["w"], ffn[0]["vecs"],
             ffn[0]["scal"], ffn[1]["w"], ffn[1]["vecs"], ffn[1]["scal"],
             lp["ln2"]["gb"], lp["ln2"]["scal"])
    lkw = dict(n_heads=nh, seq=SEQ, eps=eps, activation="gelu_new",
               res1=static.res_quant[0][0], res2=static.res_quant[0][1],
               skip_max=static.attn_skip_max)
    chains = {  # name: (chain, plain, ops, bytes)
        "int8_matmul_add_ln": (
            lambda: EK.int8_matmul_add_ln(*margs, eps=eps),
            lambda: EK.int8_matmul_add_ln_ref(*margs, eps=eps),
            2.0 * m * h * h, 3 * m * h + w_bytes(ao)),
        "int8_ffn_ln": (
            lambda: EK.int8_ffn_ln(*fargs, **fkw),
            lambda: EK.int8_ffn_ln_ref(*fargs, **fkw),
            4.0 * m * h * n1, 3 * m * h + w_bytes(*ffn)),
        "int8_layer_ln": (
            lambda: EK.int8_layer_ln(*largs, **lkw),
            lambda: EK.int8_layer_ln_ref(*largs, **lkw),
            2.0 * m * h * (3 * h + h + 2 * n1) + 4.0 * BATCH * nh * SEQ * SEQ
            * d, 2 * m * h + w_bytes(lp["qkv"], ao, *ffn) + mask.numel() * 4),
    }
    for name, (chain, ref, ops, nbytes) in chains.items():
        compare(chain(), ref(), f"{name} (chain vs plain)")
        t_k = timed_ms(chain)
        t_p = timed_ms(ref, iters=5)
        bnd, by = bound_ms(ops, nbytes)
        print(f"  {name}: chain {t_k:.4f} ms, plain {t_p:.4f} ms, bound "
              f"{bnd:.4f} ms ({by})")
    return report


def check_other_shapes(plan, dev) -> None:
    """The kernels' other built shapes and ragged edges (not on the main
    path): random payloads against the plain versions."""
    gen = torch.Generator(device=dev).manual_seed(7)
    lp = plan["layers"][0]

    def ints(*shape, lo=-40, hi=40):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    # a ragged matmul: M, N off the 128-tiles, K off the 64-byte step
    m, n, k = 1000, 136, 80
    w = ints(n, k)
    vecs = torch.stack([torch.full((n,), 2e-4, device=dev),
                        w.float().sum(1), torch.zeros(n, device=dev),
                        torch.full((n,), 0.05, device=dev),
                        torch.full((n,), 3.0, device=dev)])
    scal = torch.tensor([[0.03, 5.0]], device=dev)
    x = ints(m, k)
    for act in (None, "gelu_new"):
        for mode in ("emit", "fold", "float"):
            got = EK.int8_matmul(x, w, vecs, scal, activation=act,
                                 out_mode=mode)
            want = EK.int8_matmul_ref(x, w, vecs, scal, activation=act,
                                      out_mode=mode)
            tag = f"int8_matmul {m}x{k}->{n} act={act} {mode}"
            if mode == "emit":
                compare(got, want, tag)
            elif not torch.equal(got, want):
                fail(f"{tag}: max err {(got - want).abs().max().item()}")
    # attention at the other built sequence lengths
    for seq in (64, 32):
        b = 6
        qkv = ints(b * seq, 3 * 768, lo=-60, hi=60)
        mask = torch.zeros(b, seq, device=dev)
        mask[:, seq // 2:] = -10000.0
        for skip in (True, False):
            compare(EK.int8_attention(qkv, mask, lp["attn_scal"], n_heads=12,
                                      seq=seq, skip_max=skip),
                    EK.int8_attention_ref(qkv, mask, lp["attn_scal"],
                                          n_heads=12, seq=seq,
                                          skip_max=skip),
                    f"int8_attention seq={seq} skip_max={skip}")
    # add + LayerNorm at another width, ragged rows
    h = 256
    gb = torch.stack([torch.ones(h, device=dev), torch.zeros(h, device=dev)])
    y8, r8 = ints(999, h), ints(999, h)
    for res_quant in (True, False):
        compare(EK.fused_add_ln_payload(y8, r8, gb, lp["ln1"]["scal"],
                                        eps=1e-12, res_quant=res_quant),
                EK.fused_add_ln_payload_ref(y8, r8, gb, lp["ln1"]["scal"],
                                            eps=1e-12, res_quant=res_quant),
                f"fused_add_ln_payload 999x{h} res_quant={res_quant}")


def window_ms(fn, window_s: float = 1.0, windows: int = 5):
    """Median, least and most milliseconds per call over ``windows``
    host-clock windows of at least ``window_s`` seconds each: calls are
    enqueued back to back and each window ends in a synchronise."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    iters = max(1, int(np.ceil(window_s / (time.perf_counter() - t0))))
    per_call = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        per_call.append((time.perf_counter() - t0) * 1e3 / iters)
    return float(np.median(per_call)), min(per_call), max(per_call)


def seq_per_s(ms) -> str:
    """seq/s at the median window, with the range over the windows."""
    med, lo, hi = (BATCH * 1e3 / t for t in ms)
    return f"{med:.1f} ({hi:.1f}-{lo:.1f})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    print(f"[1] device: {kind}; nvidia-smi: {smi}", flush=True)

    t_build = KB.build()
    print(f"[2] build: {t_build:.1f} s for {', '.join(KB.SOURCES)}",
          flush=True)
    for name, log in KB.BUILD_LOG.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"  {name}: " + " | ".join(regs))

    cfg = B.BertConfig()
    t0 = time.perf_counter()
    params, qcfg, qstate = CAL.calibrated_bert(cfg, batch_size=8, seq=SEQ,
                                               seed=args.seed, device=dev)
    static, plan, int_params = B.build_bert_engine(params, cfg, qcfg, qstate,
                                                   device=dev)
    torch.cuda.synchronize()
    print(f"  set-up (init, calibration, packing, plan): "
          f"{time.perf_counter() - t0:.1f} s; skip_max={static.attn_skip_max}",
          flush=True)
    batches = request_batches(cfg, 3, args.seed)

    print("[3] kernels against their plain versions, layer-0 inputs "
          f"(B={BATCH}, S={SEQ})", flush=True)
    report = check_kernels(params, cfg, qcfg, qstate, int_params, static,
                           plan, batches[0], dev)
    check_other_shapes(plan, dev)

    print("[4] main path: BERT-base W8A8 through bert_engine_apply",
          flush=True)
    EK.reset_launches()
    logits = [B.bert_engine_apply(params, b, cfg, qcfg, qstate, static, plan,
                                  int_params, device=dev)["logits"]
              for b in batches]
    torch.cuda.synchronize()
    launches = dict(EK.LAUNCHES)
    per_fwd = {k: v / len(batches) for k, v in launches.items()}
    print(f"  launches over {len(batches)} forwards: {launches}; per "
          f"forward: {per_fwd}")
    want = {"int8_matmul": 4 * cfg.num_hidden_layers,
            "int8_attention": cfg.num_hidden_layers,
            "fused_add_ln_payload": 2 * cfg.num_hidden_layers}
    if per_fwd != want:
        fail(f"launches per forward {per_fwd}, expected {want}")
    for i, (b, lg) in enumerate(zip(batches, logits)):
        ref = B.bert_engine_apply(params, b, cfg, qcfg, qstate, static, plan,
                                  int_params, backend="plain",
                                  device=dev)["logits"]
        if tuple(lg.shape) != (BATCH, cfg.num_labels):
            fail(f"logits shape {tuple(lg.shape)}")
        if not torch.isfinite(lg).all():
            fail("non-finite logits")
        err = (lg - ref).abs().max().item()
        ok = torch.allclose(lg, ref, rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
        print(f"  batch {i}: logits max |kernels - plain| = {err:.3e} "
              f"(rtol {LOGIT_RTOL}, atol {LOGIT_ATOL}); logit scale "
              f"{ref.abs().max().item():.3e}")
        if not ok:
            fail(f"batch {i}: engine logits disagree with the plain engine")

    b0 = batches[0]
    # the encoder alone (12 x int8_layer_ln + payload entry/exit) on this
    # batch's entry value and mask, against the whole forward on the same
    # batch: the difference is embeddings and the head
    h0, m0 = entry_value(params, cfg, qcfg, qstate, int_params, b0, dev)
    t_enc = window_ms(lambda: ENG.encoder_engine(h0, m0, static, plan))
    t_fwd = window_ms(lambda: B.bert_engine_apply(
        params, b0, cfg, qcfg, qstate, static, plan, int_params, device=dev))
    print("  ms per call, median (least-most) of 5 windows of >= 1 s: "
          f"engine forward {t_fwd[0]:.3f} ({t_fwd[1]:.3f}-{t_fwd[2]:.3f}), "
          f"encoder {t_enc[0]:.3f} ({t_enc[1]:.3f}-{t_enc[2]:.3f}) "
          f"(kernels), embeddings + head {t_fwd[0] - t_enc[0]:.3f} "
          "(difference of the medians; plain torch)")
    eng_plain = window_ms(lambda: B.bert_engine_apply(
        params, b0, cfg, qcfg, qstate, static, plan, int_params,
        backend="plain", device=dev))
    sim = window_ms(lambda: B.bert_apply(params, b0, cfg, qcfg, qstate,
                                         QuantMode(), device=dev))
    params16 = B.params_to(params, dtype=torch.bfloat16)
    dense16 = window_ms(lambda: B.bert_apply(params16, b0, cfg, None,
                                             device=dev))
    print(f"  seq/s at B={BATCH}, S={SEQ}, median (range) of 5 windows "
          f"({kind}, {smi}): engine {seq_per_s(t_fwd)}, engine on plain "
          f"versions {seq_per_s(eng_plain)}, fake-quant simulation (f32, "
          f"TF32 off) {seq_per_s(sim)}, bf16 dense {seq_per_s(dense16)}")

    sources = {"int8_matmul": ("int8_matmul.cu", "cuda",
                               "transformer_quantization_tpu/ops/pallas/"
                               "engine_kernels.py:254"),
               "int8_attention": ("int8_attention.cu", "cuda",
                                  "transformer_quantization_tpu/ops/pallas/"
                                  "engine_kernels.py:804"),
               "fused_add_ln_payload": ("add_ln_payload.cu", "cuda",
                                        "transformer_quantization_tpu/ops/"
                                        "pallas/engine_kernels.py:1073")}
    kernels = []
    for name, (src, route, replaces) in sources.items():
        r = report[name]
        kernels.append({
            "name": name, "route": route,
            "source": "transformer_quantization_tpu_torch/ops/kernels/csrc/"
                      + src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
