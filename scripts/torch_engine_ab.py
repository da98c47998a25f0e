"""Same-call A/B of the BERT-base W8A8 engine's seq/s between this
checkout and another one, on one NVIDIA card.

    python3 scripts/torch_engine_ab.py --parent DIR [--rounds N] [--seed S]

``DIR`` is an unpacked checkout of another commit (``git archive``, under
a git-ignored directory such as ``scratch_checkout/``). Each round runs
parent, this, this, parent, every run in a process of its own that
imports that checkout's port and ``chip_smoke.py``, builds the engine's
three kernel libraries into that checkout's build directory, makes
BERT-base from ``--seed`` with its one-batch W8A8 calibration and engine
plan, and times ``bert_engine_apply`` on one request batch (B=128,
S=128) and the encoder alone on its entry value, each as the median of
five host-clock windows of at least one second (``chip_smoke.window_ms``).
Prints one JSON line per run and, first, the card's name and power
limit. Imports torch and the ports only.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def worker(root: str, seed: int) -> None:
    sys.path.insert(0, root)
    import torch

    import chip_smoke as CS
    from transformer_quantization_tpu_torch.models import bert as B
    from transformer_quantization_tpu_torch.ops import engine as ENG
    from transformer_quantization_tpu_torch.ops.kernels import build as KB
    from transformer_quantization_tpu_torch.training import calibration as CAL

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    KB.build(("int8_matmul", "int8_attention", "add_ln_payload"))
    cfg = B.BertConfig()
    params, qcfg, qstate = CAL.calibrated_bert(cfg, batch_size=8, seq=CS.SEQ,
                                               seed=seed, device=dev)
    static, plan, ip = B.build_bert_engine(params, cfg, qcfg, qstate,
                                           device=dev)
    b0 = CS.request_batches(cfg, 1, seed)[0]
    h0, m0 = CS.entry_value(params, cfg, qcfg, qstate, ip, b0, dev)
    t_fwd = CS.window_ms(lambda: B.bert_engine_apply(
        params, b0, cfg, qcfg, qstate, static, plan, ip, device=dev))
    t_enc = CS.window_ms(lambda: ENG.encoder_engine(h0, m0, static, plan))
    print(json.dumps({"checkout": root,
                      "seq_per_s": CS.BATCH * 1e3 / t_fwd[0],
                      "forward_ms": t_fwd, "encoder_ms": t_enc}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="an unpacked checkout of the commit to compare with")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker is not None:
        worker(args.worker, args.seed)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    parent = str(Path(args.parent).resolve())
    for _ in range(args.rounds):
        for root in (parent, str(ROOT), str(ROOT), parent):
            subprocess.run([sys.executable, __file__, "--parent", parent,
                            "--seed", str(args.seed), "--worker", root],
                           check=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
