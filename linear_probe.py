"""A/B the fused linear (``csrc/fused_int8_linear.cu``) against an edited
copy of itself and against another checkout's, on one NVIDIA card, at
BERT-base's layer shapes.

    python3 linear_probe.py [--out DIR] [--parent DIR]

Variants, built as ``k1_probe.py`` builds its own (all ``nvcc`` runs
started together, into ``DIR``, default ``k1_probe_build/linear``):

- ``kernel``: the source as it is;
- ``rcp2``: the A-S erf's branch-free reciprocal with two Newton steps
  in place of one;
- ``division``: that reciprocal as the IEEE division ``1.0f / d`` (a
  range check and a slow-path call per element);
- ``parent`` (with ``--parent DIR``, an unpacked checkout of another
  commit with the same entry point, the quantize pass's scratch
  argument included): that checkout's ``fused_int8_linear.cu`` and
  headers.

Each variant's reciprocal is first held against the IEEE division on
every float32 in [1, 2^126] (``tq_fused_rcp_check``; the count of
differing results is printed, and only the variants that compute the
function must have none). On random inputs (M = 16384; an asymmetric
8-bit input site from x's range, per-column weight scales, a bias) it
checks every variant against ``fused_int8_linear_ref`` (bit-identical or
it fails) and prints each one's device ms per call (20 calls in a CUDA
graph, median of 5 replays)
for q (float32 x, 768 -> 768, fold), inter (float32 x, 768 -> 3072, the
A-S gelu, emit), dense (payload, 3072 -> 768, fold) and the
``{'x': 'fp32'}`` dense (float32 x, 3072 -> 768, fold), and the quantize
pass alone on each float32 x. With ``--parent`` it also compares the
machine code with the parent's (``cuobjdump -sass``, kernel by
kernel). Imports torch and the port only.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch

import chip_smoke as CS
from k1_probe import build_variants, entry, same_sass
from transformer_quantization_tpu_torch.ops.kernels import int_matmul as IM
from transformer_quantization_tpu_torch.ops.kernels.activations import (
    GELU_NEW_C,
)
from transformer_quantization_tpu_torch.quant import quantizers as Q

EDITS = {
    "kernel": [],
    "rcp2": [("  return __fmaf_rn(r, __fmaf_rn(-d, r, 1.0f), r);",
              "  r = __fmaf_rn(r, __fmaf_rn(-d, r, 1.0f), r);\n"
              "  return __fmaf_rn(r, __fmaf_rn(-d, r, 1.0f), r);")],
    "division": [("const float t = rcp_ge1(1.0f + p * ax);",
                  "const float t = 1.0f / (1.0f + p * ax);")],
}
# (tag, x dtype, K, N, activation, output)
SHAPES = [("q", torch.float32, 768, 768, None, "fold"),
          ("inter", torch.float32, 768, 3072, "gelu", "emit"),
          ("dense", torch.int8, 3072, 768, None, "fold"),
          ("dense x-fp32", torch.float32, 3072, 768, None, "fold")]


def inputs(m, k, n, x_dtype, gen, dev):
    """x, the packed weight pieces, the bias and the (1, 8) scalars with
    an asymmetric 8-bit input site and an 8-bit output site."""
    spec = Q.QuantizerSpec(n_bits=8, method=Q.QMethod.asymmetric_uniform)
    x = 1.5 * torch.randn(m, k, generator=gen, device=dev)
    in_qp = Q.set_quant_range(spec, x.min(), x.max())
    w = torch.randint(-127, 128, (n, k), generator=gen, device=dev,
                      dtype=torch.int8)
    w_scale = 1e-3 * (1 + torch.rand(n, generator=gen, device=dev))
    colsum = w.float().sum(1)
    bias = 0.1 * torch.randn(n, generator=gen, device=dev)
    scal = torch.zeros(1, 8, device=dev)
    scal[0, 0] = Q.scale_of(spec, in_qp)
    scal[0, 1] = Q.zero_point_of(spec, in_qp)
    if x_dtype == torch.int8:
        x = IM.quantize_input_ref(x, scal, True)
    y = IM.fused_int8_linear_ref(x, w, w_scale, colsum, bias, scal,
                                 activation=None, asym_in=True, out_bits=0,
                                 out_sym=False, out_int8=False)
    out_qp = Q.set_quant_range(spec, y.min(), y.max())
    scal[0, 2] = Q.scale_of(spec, out_qp)
    scal[0, 3] = Q.zero_point_of(spec, out_qp)
    return x, w, w_scale, colsum, bias, scal


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="k1_probe_build/linear")
    ap.add_argument("--parent", default=None,
                    help="an unpacked checkout whose fused linear to time "
                         "beside")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("linear_probe: needs a card")
    print(CS.nvidia_smi_line(), flush=True)
    libs = build_variants("fused_int8_linear.cu", EDITS, Path(args.out),
                          args.parent)
    if args.parent:
        same_sass(Path(args.out))
    dev = torch.device("cuda")
    fns = {}
    for name, lib in libs.items():
        fns[name] = entry(lib, "fused_int8_linear")
        bad = torch.zeros(1, dtype=torch.int64, device=dev)
        err = entry(lib, "fused_rcp_check")(
            bad.data_ptr(), torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        print(f"  {name}: the reciprocal differs from 1.0f / d on "
              f"{int(bad.item())} float32 d in [1, 2^126] (error {err})",
              flush=True)
        if err or bad.item():
            raise SystemExit(f"linear_probe: {name}: reciprocal check "
                             "failed")
    gen = torch.Generator(device=dev).manual_seed(5)
    m = 16384
    for tag, x_dtype, k, n, act, mode in SHAPES:
        x, w, w_scale, colsum, bias, scal = inputs(m, k, n, x_dtype, gen,
                                                   dev)
        emit = mode == "emit"
        want = IM.fused_int8_linear_ref(
            x, w, w_scale, colsum, bias, scal, activation=act, asym_in=True,
            out_bits=8, out_sym=False, out_int8=emit)
        x_f32 = int(x_dtype == torch.float32)
        xq = torch.empty((m, k), device=dev, dtype=torch.int8)
        out = torch.empty((m, n), device=dev,
                          dtype=torch.int8 if emit else torch.float32)
        codes = (m, n, k, IM._ACT_CODES[act], 1,
                 IM._OUT_EMIT if emit else IM._OUT_FOLD, 8, 0, GELU_NEW_C)
        line = f"  [{tag}] {m}x{k}->{n} act={act} {mode}:"
        for name, fn in fns.items():
            def call(fn=fn, name=name):
                ptrs = (x.data_ptr(), x_f32, xq.data_ptr(), w.data_ptr(),
                        w_scale.data_ptr(), colsum.data_ptr(),
                        bias.data_ptr(), scal.data_ptr(), out.data_ptr())
                err = fn(*ptrs, *codes,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise SystemExit(f"linear_probe: {name}: CUDA error "
                                     f"{err}")
            call()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise SystemExit(f"linear_probe: {name} differs from "
                                 f"fused_int8_linear_ref at {line}")
            line += f" {name} {CS.device_ms(call):.4f} ms;"
        if x_f32:
            t = CS.device_ms(lambda: IM.quantize_input(x, scal, True))
            line += f" the quantize pass alone {t:.4f} ms;"
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
