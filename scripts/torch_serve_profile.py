"""Where a served batch's time goes, on one NVIDIA card.

    python3 scripts/torch_serve_profile.py [--seed S]

Builds the servers of ``chip_smoke.py`` phase 11 (BERT-base and
MobileBERT-uncased, W8A8 calibrated from ``--seed``, written as a
checkpoint and served by ``build_engine_from_checkpoint`` with the JAX
bench's settings, every bucket captured) and, for each model:

1. at the buckets (8, 32), (64, 32), (8, 128) and (64, 128), on a seeded
   padded batch: the graph replay's host-clock ms per call (five windows
   of >= 0.25 s), then 20 replays under ``torch.profiler`` (CUDA
   activity): kernels a replay, their device ms a replay summed, the
   device's busy ms a replay (the union of kernel intervals) and the
   device ms a replay by kernel group (the port's kernels by name, the
   rest of PyTorch's by kind);
2. the closed loop of phase 11 (512 requests of 8-127 tokens at
   concurrency 64) twice on one started engine, the second under the
   profiler: seq/s, p50 / p99 ms, and the device's busy share of the
   profiled loop's wall time.

Prints the card's name and power limit first. Imports torch, the port
and ``chip_smoke.py`` only.
"""

from __future__ import annotations

import argparse
import gc
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as CS  # noqa: E402
from transformer_quantization_tpu_torch.models import bert as B  # noqa: E402
from transformer_quantization_tpu_torch.models import mobilebert as MB  # noqa: E402
from transformer_quantization_tpu_torch.ops.kernels import build as KB  # noqa: E402
from transformer_quantization_tpu_torch.training import calibration as CAL  # noqa: E402

BUCKETS = ((8, 32), (64, 32), (8, 128), (64, 128))
# kernel name fragment -> group (first match wins)
GROUPS = (("gemm_kernel", "K1 int8_matmul"), ("attn_kernel", "K2 attention"),
          ("add_ln_kernel", "K3 add+LN"), ("mb_layer_kernel", "K8 layer"),
          ("Memcpy", "copies"), ("Memset", "copies"), ("gemm", "cuBLAS"),
          ("reduce", "torch reductions"), ("index", "torch gathers"),
          ("elementwise", "torch elementwise"))


def group(name: str) -> str:
    for frag, label in GROUPS:
        if frag in name:
            return label
    return "other"


def kernels(prof) -> list:
    """(name, start us, end us) of every device event of a profile."""
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.device_type == DeviceType.CUDA]


def busy_us(spans) -> float:
    """Length of the union of the (start, end) intervals."""
    total, end = 0.0, -np.inf
    for _, a, b in sorted(spans, key=lambda k: k[1]):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def profile_replays(graphs, x, n: int = 20) -> dict:
    graphs(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            graphs(x)
        torch.cuda.synchronize()
    ks = kernels(prof)
    by = {}
    for name, a, b in ks:
        by[group(name)] = by.get(group(name), 0.0) + (b - a) / n / 1e3
    return {"kernels": len(ks) / n,
            "device_ms": sum(b - a for _, a, b in ks) / n / 1e3,
            "busy_ms": busy_us(ks) / n / 1e3,
            "by_group": dict(sorted(by.items(), key=lambda kv: -kv[1]))}


def closed_loop_profile(eng, vocab: int, seed: int) -> None:
    reqs = CS.serve_requests(vocab, seed)
    with eng:
        gc.collect()
        snaps = [eng.run_closed_loop(reqs, CS.SERVE_CONCURRENCY)]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            snaps.append(eng.run_closed_loop(reqs, CS.SERVE_CONCURRENCY))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    for i, s in enumerate(snaps):
        print(f"    closed loop run {i + 1}: seq/s {s['seq_per_sec']:.1f}, "
              f"p50 {s['latency_ms_p50']:.3f} ms, p99 "
              f"{s['latency_ms_p99']:.3f} ms, {s['batches']} batches, "
              f"wall {s['wall_s'] * 1e3:.1f} ms"
              + (" (profiled)" if i else ""))
    ks = kernels(prof)
    print(f"    profiled loop: device busy {busy_us(ks) / 1e3:.3f} ms of "
          f"{wall * 1e3:.1f} ms wall ({busy_us(ks) / 1e4 / wall:.1f}%); "
          f"{len(ks)} device events")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        CS.fail("torch.cuda.is_available() is False: this script needs a "
                "card")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"{torch.cuda.get_device_name(0)}; {CS.nvidia_smi_line()}",
          flush=True)
    KB.build(("int8_matmul", "int8_attention", "add_ln_payload",
              "int8_mb_layer"))
    cfg, mcfg = B.BertConfig(), MB.MobileBertConfig()
    models = {
        "bert": (cfg, *CAL.calibrated_bert(cfg, batch_size=8, seq=CS.SEQ,
                                           seed=args.seed,
                                           device=dev)[::2]),
        "mobilebert": (mcfg, *CAL.calibrated_mobilebert(
            mcfg, batch_size=8, seq=CS.SEQ, seed=args.seed,
            device=dev)[::2]),
    }
    for tag, (mc, params, qstate) in models.items():
        eng = CS.serve_checkpoint(tag, mc, params, qstate, dev)
        eng.warmup()
        graphs = eng.forward
        print(f"[{tag}]", flush=True)
        for b, s in BUCKETS:
            x = CS.packed_batch(mc.vocab_size, b, s, args.seed + 7, dev)
            t = CS.window_ms(lambda: graphs(x), window_s=0.25)
            r = profile_replays(graphs, x)
            print(f"    B={b} S={s}: replay {t[0]:.3f} ms ({t[1]:.3f}-"
                  f"{t[2]:.3f}); profiled: {r['kernels']:.0f} kernels, "
                  f"device {r['device_ms']:.3f} ms, busy "
                  f"{r['busy_ms']:.3f} ms; by group (ms): "
                  + ", ".join(f"{k} {v:.3f}"
                              for k, v in r["by_group"].items()),
                  flush=True)
        closed_loop_profile(eng, mc.vocab_size, args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
