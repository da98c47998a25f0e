"""Where the MobileBERT layer kernel's time goes, on one NVIDIA card; and
the attention / matmul kernels against another checkout's, in turns.

    python3 scripts/mb_layer_probe.py [--parent DIR] [--rounds N]

Builds variants of ``csrc/int8_mb_layer.cu`` from edited copies of it
and of the shared headers -- unchanged; without the attention heads;
with a trivial epilogue (the accumulator's low byte stored, no fold,
site or NoNorm); with both; with the rare exact quotient of the site
levels inline instead of in a function call -- and times each on random
payloads and a random plan at
MobileBERT-uncased widths (B=128, S=128, H=512, bottleneck 128, 4 heads
of 32, 3 stacked FFNs), CUDA events over 50 launches, the variants in
turns for ``--rounds`` rounds. The edited variants compute nothing
useful: they are timing probes. With ``--parent DIR`` (an unpacked
checkout of another commit) it also times that checkout's attention over
BERT-base's fused q|k|v (B=128, 12 heads of 64) and BERT-base's
attn_out matmul against this tree's, in turns. Prints the card's name
and power limit beside the times. Imports torch and the port only.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from transformer_quantization_tpu_torch.ops.kernels import (  # noqa: E402
    build as KB,
    engine_kernels as EK,
)

OUT = KB.BUILD_DIR / "probe"

LAYER = "int8_mb_layer.cu"
COMMON = "mm_common.cuh"
# (variant, [(file, regex, replacement), ...]) edits of the sources
VARIANTS = {
    "layer kernel": [],
    "no attention": [(LAYER, re.escape("for (int h = 0; h < NH; ++h) {"),
                      "for (int h = 0; h < 0; ++h) {")],
    "trivial epilogue": [
        (LAYER, re.escape("emit_out<ACT>(fold(v, k), k, gelu_c)"),
         "static_cast<int8_t>(v)"),
        (LAYER, re.escape("nonorm_out(v, k, has_res, rv, p)"),
         "static_cast<int8_t>(v + rv)")],
    "quotient inline": [
        (COMMON, re.escape("    return rint_quotient(y, s);"),
         "    return rintf(y / s);")],
}
VARIANTS["neither"] = VARIANTS["no attention"] + VARIANTS["trivial epilogue"]


def nvcc_job(src: Path, name: str, include: Path):
    """The nvcc command that builds ``src`` into ``OUT/name.so``."""
    out = OUT / f"{name}.so"
    cmd = [KB._nvcc(), *KB.NVCC_FLAGS, "-I", str(include), "-o", str(out),
           str(src)]
    return cmd, out


def build_all(jobs):
    """jobs: {name: (cmd, out)}; runs every nvcc at once."""
    procs = {n: subprocess.Popen(c, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for n, (c, _) in jobs.items()}
    libs = {}
    for n, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"build of {n} failed:\n{log}")
        libs[n] = ctypes.CDLL(str(jobs[n][1]))
    return libs


def variant_sources():
    """{variant: path of its int8_mb_layer.cu}: each variant's edited copy
    of the kernel and of every shared header, in a directory of its own
    (quoted includes resolve beside the including file)."""
    out = {}
    for name, edits in VARIANTS.items():
        vdir = OUT / name.replace(" ", "_")
        vdir.mkdir(parents=True, exist_ok=True)
        files = {p.name: p.read_text()
                 for p in [KB.CSRC / LAYER, *KB.CSRC.glob("*.cuh")]}
        for fname, old, new in edits:
            files[fname], n = re.subn(old, new, files[fname])
            if n != 1:
                raise SystemExit(f"variant {name!r}: edit {old!r} of "
                                 f"{fname} matched {n} times")
        for fname, text in files.items():
            (vdir / fname).write_text(text)
        out[name] = vdir / LAYER
    return out


def random_plan(dev, gen, h=512, th=128, inter=512, n_ffn=3):
    """A layer plan at the given widths in mb_layer_flat's order."""
    def ints(*shape):
        return torch.randint(-60, 60, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    def mm(n, k):
        w = ints(n, k)
        vecs = torch.stack([torch.full((n,), 1e-3, device=dev),
                            w.float().sum(1), torch.zeros(n, device=dev),
                            torch.full((n,), 0.05, device=dev),
                            torch.full((n,), 2.0, device=dev)]).contiguous()
        return [w, vecs, torch.tensor([[0.02, 3.0]], device=dev)]

    def nrm(n):
        return [torch.stack([torch.ones(n, device=dev),
                             torch.zeros(n, device=dev)]).contiguous(),
                torch.tensor([[1.0, 0.0, 0.03, 1.0, 0.04, 2.0, 0.05, -1.0]],
                             device=dev)]

    flat = mm(th, h) + nrm(th) + mm(th, h) + nrm(th)
    flat += mm(2 * th, th) + mm(th, h) + mm(th, th) + nrm(th)
    for _ in range(n_ffn + 1):
        flat += mm(inter, th) + mm(th, inter) + nrm(th)
    return flat + mm(h, th) + nrm(h)


def time_rounds(fns, rounds: int, iters: int = 50):
    """{name: [ms per launch per round]}: the fns in turns, the order
    reversed every other round (A B C, C B A, ...)."""
    out = {n: [] for n in fns}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for fn in fns.values():
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    names = list(fns)
    for i in range(rounds):
        for n in (names if i % 2 == 0 else names[::-1]):
            fn = fns[n]
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            torch.cuda.synchronize()
            out[n].append(start.elapsed_time(end) / iters)
    return out


def report(title, times):
    print(title)
    for n, ts in times.items():
        print(f"  {n}: median {np.median(ts):.4f} ms (rounds: "
              + ", ".join(f"{t:.4f}" for t in ts) + ")")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("mb_layer_probe: needs a card")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)}; {smi}", flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {n: nvcc_job(p, f"mb_{n.replace(' ', '_')}", p.parent)
            for n, p in variant_sources().items()}
    if args.parent is not None:
        pcsrc = (args.parent / "transformer_quantization_tpu_torch" / "ops"
                 / "kernels" / "csrc")
        for lib in ("int8_attention", "int8_matmul"):
            jobs[f"parent {lib}"] = nvcc_job(pcsrc / f"{lib}.cu",
                                               f"parent_{lib}", pcsrc)
            jobs[f"this {lib}"] = nvcc_job(KB.CSRC / f"{lib}.cu",
                                             f"this_{lib}", KB.CSRC)
    libs = build_all(jobs)

    gen = torch.Generator(device=dev).manual_seed(0)
    b, t, h = 128, 128, 512
    flat = random_plan(dev, gen)
    h8 = torch.randint(-60, 60, (b * t, h), generator=gen, device=dev,
                       dtype=torch.int8)
    mask = torch.zeros(b, t, device=dev)
    mask[:, 96:] = -10000.0
    ascal = torch.tensor([[0.05, 1.0, 0.05, -2.0, 0.05, 0.0, 0.5, 3.0,
                           1.0 / 255, -128.0, 0.04, 1.0]], device=dev)
    out = torch.empty_like(h8)
    ptrs = (ctypes.c_void_p * len(flat))(*(a.data_ptr() for a in flat))
    _, argtypes = KB._SIGNATURES["int8_mb_layer"]
    stream = torch.cuda.current_stream().cuda_stream

    def layer_fn(lib):
        fn = lib.tq_int8_mb_layer
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int

        def run():
            err = fn(h8.data_ptr(), mask.data_ptr(), ascal.data_ptr(),
                     ctypes.addressof(ptrs), len(flat), out.data_ptr(), b, t,
                     h, 128, 512, 32, 3, 1, 2, 1, 1, 0b1111, 1,
                     float(np.float32(1 / np.sqrt(32))), EK.LOG2E,
                     EK.GELU_NEW_C, stream)
            if err:
                raise SystemExit(f"launch failed: {err}")
        return run

    report(f"int8_mb_layer_ln variants, ms per launch (B={b}, S={t}; {smi})",
           time_rounds({n: layer_fn(libs[n]) for n in VARIANTS},
                       args.rounds))

    if args.parent is not None:
        hh = 768
        qkv = torch.randint(-60, 60, (b * t, 3 * hh), generator=gen,
                            device=dev, dtype=torch.int8)
        bmask = torch.zeros(b, t, device=dev)
        bmask[:, 100:] = -10000.0
        c8 = torch.empty((b * t, hh), device=dev, dtype=torch.int8)
        rs = float(np.float32(1 / np.sqrt(64)))

        def attn_parent():
            f = libs["parent int8_attention"].tq_int8_attention
            f.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
                ctypes.c_float, ctypes.c_float, ctypes.c_int,
                ctypes.c_void_p]
            return lambda: f(qkv.data_ptr(), bmask.data_ptr(),
                             ascal.data_ptr(), c8.data_ptr(), b, t, hh, 12,
                             rs, EK.LOG2E, 1, stream)

        def attn_this():
            f = libs["this int8_attention"].tq_int8_attention
            f.argtypes = list(KB._SIGNATURES["int8_attention"][1])
            p = qkv.data_ptr()
            return lambda: f(p, p + hh, p + 2 * hh, 3 * hh, 3 * hh, 3 * hh,
                             bmask.data_ptr(), ascal.data_ptr(),
                             c8.data_ptr(), b, t, hh, 12, rs, EK.LOG2E, 1,
                             stream)

        w = torch.randint(-60, 60, (hh, hh), generator=gen, device=dev,
                          dtype=torch.int8)
        vecs = torch.stack([torch.full((hh,), 1e-3, device=dev),
                            w.float().sum(1), torch.zeros(hh, device=dev),
                            torch.full((hh,), 0.05, device=dev),
                            torch.full((hh,), 2.0, device=dev)]).contiguous()
        sc = torch.tensor([[0.02, 3.0]], device=dev)
        x8 = qkv[:, :hh].contiguous()
        y8 = torch.empty((b * t, hh), device=dev, dtype=torch.int8)

        def mm(lib):
            f = libs[lib].tq_int8_matmul
            f.argtypes = list(KB._SIGNATURES["int8_matmul"][1])
            return lambda: f(x8.data_ptr(), w.data_ptr(), vecs.data_ptr(),
                             sc.data_ptr(), y8.data_ptr(), b * t, hh, hh, 0,
                             0, -128.0, 127.0, EK.GELU_NEW_C, stream)

        report(f"BERT-base attention (12 heads of 64) and attn_out matmul "
               f"(16384x768->768), this tree against {args.parent} ({smi})",
               time_rounds({"attention, parent": attn_parent(),
                            "attention, this tree": attn_this(),
                            "attn_out matmul, parent": mm(
                                "parent int8_matmul"),
                            "attn_out matmul, this tree": mm(
                                "this int8_matmul")}, args.rounds,
                           iters=200))
    return 0


if __name__ == "__main__":
    sys.exit(main())
