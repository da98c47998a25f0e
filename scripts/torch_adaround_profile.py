"""Profile the port's AdaRound optimizer loop on the card, one layer of
each shape.

    python3 scripts/torch_adaround_profile.py [--seed N] [--iters N]

BERT-base from ``--seed``'s random weights; for layer 0's q (768x768),
intermediate (768x3072, gelu), output dense (3072x768), its attention
LayerNorm and the word table, the layer's spec from
``bert_adaround_specs`` with 4-bit symmetric MSE-grid ranges (the
``w4-adaround`` preset's), cached inputs of 64 samples x 128 tokens drawn
from a seeded normal (token ids for the table) and the float layer's
outputs as targets. ``optimize_layer_rounding`` with the preset's
options and minibatch 32: after a 20-iteration warm-up, ``--iters``
iterations on the host clock (one synchronize at the end) and as many
under ``torch.profiler`` (CUDA activity): the kernels an iteration, the
device's busy ms an iteration (the union of its kernels' spans) and its
share of the unprofiled iteration, and the host's aten calls an
iteration. Needs a card; builds no kernel.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import chip_smoke as CS  # noqa: E402
from torch_qat_profile import busy_us  # noqa: E402
from transformer_quantization_tpu_torch.models import bert as B  # noqa: E402
from transformer_quantization_tpu_torch.quant import adaround as AR  # noqa: E402
from transformer_quantization_tpu_torch.training import adaround_driver as AD  # noqa: E402
from transformer_quantization_tpu_torch.training import calibration as CAL  # noqa: E402

LAYERS = (("768x768", "L0.attn.q"), ("768x3072 gelu", "L0.ffn.inter"),
          ("3072x768", "L0.ffn.dense"), ("LayerNorm", "L0.attn_out.ln"),
          ("word table", "emb.word"))
SAMPLES = 64


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_adaround_profile: needs a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(f"{torch.cuda.get_device_name(0)}; {CS.nvidia_smi_line()}",
          flush=True)
    cfg = B.BertConfig()
    params = B.init_bert_params(cfg, seed=args.seed, device=dev)
    rec, arc0 = CAL.ADAROUND_RECIPES["w4-adaround"]
    qcfg = B.declare_bert_sites(rec.defaults, cfg,
                                quant_setup=rec.quant_setup)
    specs = dict(B.bert_adaround_specs(params, cfg))
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    n = args.iters
    for label, name in LAYERS:
        spec, site = specs[name], qcfg[name + ".w"].spec
        w = spec["w"]
        qp = AR.mse_grid_init(site, w)
        layer_apply = AD.make_layer_apply(spec)
        if spec["kind"] == "embedding":
            inp = torch.randint(0, w.shape[0], (SAMPLES, CS.SEQ),
                                generator=gen, device=dev)
        else:
            width = w.shape[-1] if spec["kind"] == "linear" else w.shape[0]
            inp = torch.randn((SAMPLES, CS.SEQ, width), generator=gen,
                              device=dev)
        with torch.no_grad():
            out = layer_apply(w, inp)

        def loop(iters, _a=layer_apply, _s=site, _q=qp, _w=w, _i=inp,
                 _o=out):
            return AR.optimize_layer_rounding(
                _a, _s, _q, _w, _i, _o,
                dataclasses.replace(arc0, iters=iters))
        loop(20)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loop(n)
        torch.cuda.synchronize()
        t_loop = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        loop(0)
        torch.cuda.synchronize()
        t_rest = (time.perf_counter() - t0) * 1e3
        wall = (t_loop - t_rest) / n
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            loop(n)
            torch.cuda.synchronize()
        kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        busy = busy_us([(e.time_range.start, e.time_range.end)
                        for e in kern]) / n / 1e3
        aten = sum(1 for e in prof.events()
                   if e.device_type == DeviceType.CPU
                   and e.name.startswith("aten::"))
        print(f"  [{label}] {name}: {wall:.3f} ms an iteration (host clock, "
              f"{n} iterations, the 4 local losses and set-up taken off); "
              f"profiled: {len(kern) / n:.0f} kernels an iteration, device "
              f"busy {busy:.3f} ms an iteration ({100 * busy / wall:.1f}% "
              f"of the unprofiled iteration), aten calls "
              f"{aten / n:.0f} an iteration", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
