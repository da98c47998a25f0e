"""Profile the port's QAT train step on the card.

    python3 scripts/torch_qat_profile.py [--seed N] [--steps N]

BERT-base (12 layers, dropout 0) from ``--seed``'s random weights,
calibrated with the JAX CLI's ``qat-w4a8`` recipe on synthetic RTE
examples (``chip_smoke.py`` phase 13's set-up), then the train step
(``training/qat.py`` ``make_qat_train_step`` with ``training/trainer.py``
``make_optimizer``) at B = 8, S = 128 on the int8 forward and on the
float fake-quant forward: after three warm-up steps, ``--steps`` steps
timed on the host clock (each ends in a read of its loss) and the same
number under ``torch.profiler`` (CUDA activity): the kernels a step, the
device's busy ms a step (the union of its kernels' spans) and its share
of the step, the kernels' ms by group, and the host's aten calls a step.
Needs a card; builds no kernel (the int8 products are ``torch._int_mm``).
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
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
from transformer_quantization_tpu_torch.training import calibration as CAL  # noqa: E402
from transformer_quantization_tpu_torch.training import qat as QAT  # noqa: E402
from transformer_quantization_tpu_torch.training import trainer as TT  # noqa: E402
from transformer_quantization_tpu_torch.utils import data as DATA  # noqa: E402
from transformer_quantization_tpu_torch.utils import glue as GL  # noqa: E402

# kernel name fragment -> group (first match wins)
GROUPS = (("int8", "int8 products (_int_mm)"), ("gemm", "float GEMMs"),
          ("Kernel2", "float GEMMs"), ("sm90", "float GEMMs"),
          ("reduce", "reductions"), ("foreach", "optimizer (foreach)"),
          ("Memcpy", "copies"), ("Memset", "copies"),
          ("elementwise", "elementwise"), ("index", "gathers / scatters"),
          ("scatter", "gathers / scatters"), ("softmax", "softmax"),
          ("layer_norm", "layer norm"), ("cat", "cat"))


def group(name: str) -> str:
    for frag, label in GROUPS:
        if frag in name:
            return label
    return "other"


def busy_us(spans) -> float:
    """Length of the union of the (start, end) intervals."""
    total, end = 0.0, -np.inf
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def run_steps(step, state, batches):
    for b in batches:
        state = step(*state, b)
        float(state[-1])
    return state


def measure(name, step, state, batches, n) -> None:
    state = run_steps(step, state, batches[:3])
    t0 = time.perf_counter()
    state = run_steps(step, state, batches[3:3 + n])
    wall = (time.perf_counter() - t0) * 1e3 / n
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_steps(step, state, batches[3 + n:3 + 2 * n])
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = [(e.time_range.start, e.time_range.end) for e in dev]
    busy = busy_us(spans) / n / 1e3
    by = {}
    for e in dev:
        g = group(e.name)
        by[g] = by.get(g, 0.0) + (e.time_range.end - e.time_range.start)
    aten = sum(1 for e in prof.events()
               if e.device_type == DeviceType.CPU
               and e.name.startswith("aten::"))
    print(f"  [{name}] {wall:.2f} ms a step (host clock, {n} steps); "
          f"profiled: {len(dev) / n:.0f} kernels a step, device busy "
          f"{busy:.2f} ms a step ({100 * busy / wall:.1f}% of the "
          f"unprofiled step), aten calls {aten / n:.0f} a step", flush=True)
    for g, us in sorted(by.items(), key=lambda kv: -kv[1]):
        print(f"    {g}: {us / n / 1e3:.3f} ms a step")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_qat_profile: needs a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(f"{torch.cuda.get_device_name(0)}; {CS.nvidia_smi_line()}",
          flush=True)
    cfg = dataclasses.replace(B.BertConfig(), hidden_dropout_prob=0.0,
                              attention_probs_dropout_prob=0.0)
    params = B.init_bert_params(cfg, seed=args.seed, device=dev)
    task = GL.TASKS["rte"]
    arrays = DATA.encode_examples(
        DATA.SyntheticTokenizer(cfg.vocab_size), task,
        GL.synthetic_examples(task, "train", CS.QAT_EXAMPLES,
                              seed=args.seed), CS.SEQ)
    rec = CAL.CLI_RECIPES["qat-w4a8"]
    qcfg = B.declare_bert_sites(rec.defaults, cfg,
                                quant_setup=rec.quant_setup)
    apply_fn = functools.partial(B.bert_apply, cfg=cfg, device=dev)
    tcfg, qat0 = TT.QAT_RECIPES["qat-w4a8"]
    qstate, qat = TT.prepare_qat(apply_fn, params, qcfg, arrays,
                                 B.bert_weight_site_tensors(params), qat0,
                                 rec, device=dev)
    batches = []
    for b in DATA.batch_iterator(arrays, tcfg.batch_size, drop_last=True):
        b.pop("example_mask")
        batches.append(b)
    n = args.steps
    if 3 + 2 * n > len(batches):
        raise SystemExit(f"--steps {n}: at most {(len(batches) - 3) // 2}")
    for name, q in (("int8 forward", qat),
                    ("float fake-quant forward",
                     dataclasses.replace(qat, int8_sites=None))):
        tx = TT.make_optimizer(tcfg, 288, params)
        step = QAT.make_qat_train_step(apply_fn, qcfg, q, tx)
        p, learnable, rest, opt = QAT.init_qat_state(qcfg, q, params,
                                                     qstate, tx)
        gen = torch.Generator(device=dev).manual_seed(tcfg.seed)

        def one(p, learnable, rest, opt, gen, loss, batch, _step=step):
            return _step(p, learnable, rest, opt, batch, gen)

        measure(name, one, (p, learnable, rest, opt, gen,
                            torch.zeros(())), batches, n)
    return 0


if __name__ == "__main__":
    sys.exit(main())
