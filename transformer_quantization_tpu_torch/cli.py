"""The command line.

Counterpart of ``transformer_quantization_tpu/cli.py``, with its four
commands, flag surface, defaults, recipes and outputs:

    python -m transformer_quantization_tpu_torch.cli train-baseline    [opts]
    python -m transformer_quantization_tpu_torch.cli train-quantized   [opts]
    python -m transformer_quantization_tpu_torch.cli validate-baseline [opts]
    python -m transformer_quantization_tpu_torch.cli validate-quantized [opts]

It writes ``config.out``, ``eval_results_<task>.txt`` (``mnli-mm`` for
MNLI's mismatched split), ``final_score.txt``, the checkpoints
(``checkpoint_<task>``, and ``checkpoint_<task>_step<N>`` pruned to
``--save-total-limit``) into ``--output-dir``, and prints one JSON line
``{"final_score": ..., "tasks": {...}}`` last.

Where the port differs from the JAX CLI:

- ``--device {cuda,cpu}`` (default ``cuda``) takes the place of JAX's
  ``TQ_PLATFORM``. Without a card ``cuda`` raises; the run never carries
  on on the CPU.
- ``--engine {off,auto,kernels,plain}`` replaces JAX's
  ``off/auto/pallas/xla``: ``kernels`` runs the engine's hand-written
  CUDA kernels (and the generic int path's fused linear), ``plain`` their
  plain PyTorch versions (the generic int path without the fused linear),
  and ``auto`` picks ``kernels`` on ``cuda`` and ``plain`` on ``cpu``, as
  JAX's picks Pallas on a TPU and XLA elsewhere. When the engine plan
  raises ``EngineIncompatible``, or the mode is dynamic or not full-quant,
  evaluation takes the generic int path and logs why: JAX's own rule.
- ``--pp-stages`` above 1 raises (the pipeline, ROADMAP §1 item 9) and
  ``--export-dir`` raises (serving export, item 6), each before any
  work.
- ``--from-hub`` raises: the port fetches nothing
  (``models/hf_loader.py`` ``resolve_model_dir``).
- ``--scan-layers`` runs the encoder's loop (``models/bert.py``
  ``bert_apply``), which computes JAX's scan.
- ``--int8-qat-forward auto`` follows JAX's rule (on under
  ``--learn-ranges``), on the card too.

The recipes (:data:`RECIPES`) are read from the port's preset tables
(``training/calibration.py`` ``CLI_RECIPES`` / ``ADAROUND_RECIPES``,
``training/trainer.py`` ``QAT_RECIPES``), not copied.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import functools
import inspect
import json
import logging
import os
import re
import shutil
from typing import Dict, Optional

import numpy as np
import torch

logger = logging.getLogger("tq_torch")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="transformer_quantization_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)

    def add_common(sp):
        g = sp.add_argument_group("base")
        g.add_argument("--seed", type=int, default=1000)
        g.add_argument("--output-dir", default=None)
        g.add_argument("--profile-dir", default=None,
                       help="write a torch.profiler Chrome trace of the run "
                            "here (trace.json)")
        g.add_argument("--tb-logging-dir", default=None,
                       help="TensorBoard events: per-site ranges + scores "
                            "(events.jsonl without tensorboard)")
        g.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                       help="where the model runs; 'cuda' raises without a "
                            "card")
        g = sp.add_argument_group("data")
        g.add_argument("--task", action="append", default=None,
                       help="GLUE task (repeatable) or 'all'")
        g.add_argument("--max-seq-length", type=int, default=128)
        g.add_argument("--pad-to-max-length", dest="pad_to_max_length",
                       action="store_true", default=True)
        g.add_argument("--no-pad-to-max-length", dest="pad_to_max_length",
                       action="store_false")
        g.add_argument("--num-train-samples", type=int, default=None)
        g.add_argument("--num-val-samples", type=int, default=None)
        g.add_argument("--synthetic-data", action="store_true",
                       help="use deterministic offline synthetic data")
        g.add_argument("--data-dir", default=None)
        g = sp.add_argument_group("model")
        g.add_argument("--model-name", default="bert_base_uncased",
                       choices=["bert_base_uncased", "bert_large_uncased",
                                "bert_base_cased", "roberta_base",
                                "distilroberta_base", "mobilebert_uncased",
                                "distilbert_base_uncased", "albert_base_v2",
                                "albert_large_v2", "squeezebert_uncased"])
        g.add_argument("--model-path", default=None,
                       help="local HF checkpoint directory or framework "
                            "checkpoint directory")
        g.add_argument("--from-hub", action="store_true",
                       help="resolve a non-directory --model-path as a hub "
                            "repo id (raises: the port fetches nothing)")
        g.add_argument("--quant-model-path", default=None,
                       help="framework checkpoint dir (params + calibrated "
                            "quant state) to evaluate or train from")
        g.add_argument("--tiny-model", action="store_true",
                       help="debug: 2-layer hidden-64 model")
        g.add_argument("--attn-dropout", type=float, default=None)
        g.add_argument("--hidden-dropout", type=float, default=None)
        g = sp.add_argument_group("training")
        g.add_argument("--learning-rate", type=float, default=5e-5)
        g.add_argument("--batch-size", type=int, default=32)
        g.add_argument("--num-epochs", type=int, default=3)
        g.add_argument("--weight-decay", type=float, default=0.0)
        g.add_argument("--ffn-weight-decay", type=float, default=0.0,
                       help="extra decoupled weight decay on FFN kernels")
        g.add_argument("--max-grad-norm", type=float, default=1.0)
        g.add_argument("--warmup-ratio", type=float, default=0.0)
        g.add_argument("--warmup-steps", type=int, default=None,
                       help="absolute LR warmup steps (overrides "
                            "--warmup-ratio)")
        g.add_argument("--lr-scheduler-type", default="linear",
                       choices=["linear", "cosine", "constant"])
        g.add_argument("--gradient-accumulation-steps", type=int, default=1)
        g.add_argument("--max-steps", type=int, default=None,
                       help="stop after N optimizer steps; the LR schedule "
                            "still spans num_epochs, so an interrupted run "
                            "resumes exactly")
        g.add_argument("--eval-batch-size", type=int, default=32)
        g.add_argument("--remat", action="store_true",
                       help="recompute each encoder layer in the backward "
                            "(torch.utils.checkpoint): less activation "
                            "memory for about a third more forward work")
        g.add_argument("--scan-layers", action="store_true",
                       help="taken for the JAX CLI's flag: the encoder runs "
                            "its loop, which computes the JAX scan")
        g.add_argument("--amp", action="store_true",
                       help="mixed-precision training: bf16 matmuls/"
                            "activations, f32 master weights, range math, "
                            "statistics, loss, and optimizer")
        g = sp.add_argument_group("progress")
        g.add_argument("--eval-every", "--eval-steps", dest="eval_every",
                       type=int, default=None,
                       help="mid-train eval on the validation set every N "
                            "optimizer steps")
        g.add_argument("--eval-strategy", default=None,
                       choices=["no", "steps", "epoch"],
                       help="evaluation frequency: 'steps' uses "
                            "--eval-every, 'epoch' evaluates at each epoch "
                            "end")
        g.add_argument("--eval-during-training", action="store_true",
                       help="evaluate at each logging step")
        g.add_argument("--load-best-model-at-end", action="store_true",
                       help="track the best mid-train eval and restore it "
                            "after training")
        g.add_argument("--metric-for-best-model", default=None)
        g.add_argument("--smaller-is-better", action="store_true",
                       help="best-model metric is minimized")
        g.add_argument("--save-total-limit", type=int, default=None,
                       help="keep only the N most recent step checkpoints")
        g.add_argument("--run-name", default=None,
                       help="label recorded in config.out")
        g.add_argument("--resume", action="store_true",
                       help="resume an interrupted training run from the "
                            "train state saved at --save-every cadence "
                            "under --output-dir")
        g.add_argument("--save-every", "--save-steps", dest="save_every",
                       type=int, default=None,
                       help="mid-train checkpoint every N optimizer steps "
                            "into --output-dir")
        g.add_argument("--log-every", "--logging-steps", dest="log_every",
                       type=int, default=50,
                       help="loss log interval in steps (the first step is "
                            "always logged)")
        g.add_argument("--tqdm", action="store_true", default=True,
                       help="progress bar over training batches (log lines "
                            "when tqdm or a tty is unavailable)")
        g.add_argument("--no-tqdm", dest="tqdm", action="store_false")
        g.add_argument("--tb-train-histograms", action="store_true",
                       help="per-layer residual histograms (per-tensor + "
                            "per-token) before and after training")
        g.add_argument("--pp-stages", type=int, default=1,
                       help="pipeline stages (above 1 raises: not yet "
                            "ported)")
        g.add_argument("--pp-microbatches", type=int, default=2,
                       help="microbatches per batch in the pipeline")
        g.add_argument("--export-dir", default=None,
                       help="serving export (raises: not yet ported)")
        g.add_argument("--export-seq-buckets", nargs="+", type=int,
                       default=None,
                       help="sequence buckets to export")
        g.add_argument("--export-batch-buckets", nargs="+", type=int,
                       default=None,
                       help="engine batch buckets to export")
        g.add_argument("--tb", action="store_true",
                       help="enable the TensorBoard writer at "
                            "<output-dir>/tb when --tb-logging-dir is not "
                            "given")
        # accepted so the JAX CLI's command lines run unchanged; they change
        # nothing (the JAX CLI's own no-ops)
        for flag in ("--overwrite-output", "--save-model",
                     "--logging-first-step", "--greater-is-better",
                     "--save-attn", "--line-by-line", "--overwrite-cache",
                     "--use-fast-tokenizer", "--tb-graph"):
            g.add_argument(flag, action="store_true", help=argparse.SUPPRESS)
        for flag in ("--gamma", "--margin"):
            g.add_argument(flag, type=float, default=None,
                           help=argparse.SUPPRESS)
        g.add_argument("--amp-opt-level", default=None,
                       help=argparse.SUPPRESS)
        g.add_argument("--cache-dir", default=None,
                       help="hub cache directory for --from-hub")
        g.add_argument("--num-workers", type=int, default=0,
                       help=argparse.SUPPRESS)

    def add_quant(sp):
        g = sp.add_argument_group("quantization")
        g.add_argument("--recipe", default=None,
                       choices=["w8a8", "w8a8-mixed", "w8a8-peg",
                                "w4-adaround", "qat-w4a8"],
                       help="apply one of the documented experiment "
                            "settings to every option you left at its "
                            "default; explicit flags take precedence")
        g.add_argument("--qmethod", default="symmetric_uniform",
                       choices=["symmetric_uniform", "asymmetric_uniform"])
        g.add_argument("--qmethod-act", default="asymmetric_uniform",
                       choices=["symmetric_uniform", "asymmetric_uniform"])
        g.add_argument("--n-bits", type=int, default=8)
        g.add_argument("--n-bits-act", type=int, default=8)
        g.add_argument("--per-channel", action="store_true")
        g.add_argument("--percentile", type=float, default=None)
        g.add_argument("--quant-setup", default="all",
                       choices=["all", "FP_logits", "MSE_logits"])
        g.add_argument("--weight-quant-method", default="MSE",
                       choices=["current_minmax", "allminmax",
                                "running_minmax", "MSE", "cross_entropy"])
        g.add_argument("--weight-opt-method", default="golden_section",
                       choices=["grid", "golden_section"])
        g.add_argument("--num-candidates", type=int, default=100)
        g.add_argument("--act-quant-method", default="current_minmax",
                       choices=["current_minmax", "allminmax",
                                "running_minmax", "MSE", "cross_entropy"])
        g.add_argument("--act-opt-method", default="golden_section",
                       choices=["grid", "golden_section"])
        g.add_argument("--act-momentum", type=float, default=0.9)
        g.add_argument("--act-num-candidates", type=int, default=100,
                       help="grid size for MSE act-range search")
        g.add_argument("--no-weight-quant", action="store_true")
        g.add_argument("--no-act-quant", action="store_true")
        g.add_argument("--num-est-batches", type=int, default=1)
        g.add_argument("--est-ranges-batch-size", type=int, default=1)
        g.add_argument("--est-ranges-pad", dest="est_ranges_pad",
                       action="store_true", default=None)
        g.add_argument("--est-ranges-no-pad", dest="est_ranges_pad",
                       action="store_false",
                       help="trim calibration batches to their longest real "
                            "sequence; default inherits --pad-to-max-length")
        g.add_argument("--cross-entropy-layer", default=None)
        g.add_argument("--quant-dict", default=None,
                       help="python-literal dict, e.g. \"{'y': 16, 'Et': 2}\"")
        g.add_argument("--dynamic", action="store_true")
        g.add_argument("--engine", default="off",
                       choices=["off", "auto", "kernels", "plain"],
                       help="evaluate through the full-handoff int8 engine "
                            "when the quant config fits: 'kernels' on the "
                            "card's kernels, 'plain' on their plain "
                            "versions, 'auto' the kernels on cuda and the "
                            "plain versions on cpu")
        g.add_argument("--double", action="store_true",
                       help="run the model and its quantizer math in "
                            "float64")
        g.add_argument("--per-token", action="store_true")
        g.add_argument("--per-embd", action="store_true")
        g.add_argument("--per-groups", type=int, default=None)
        g.add_argument("--per-groups-permute", action="store_true")
        g.add_argument("--per-groups-permute-shared-h", action="store_true")
        g = sp.add_argument_group("qat")
        g.add_argument("--learn-ranges", action="store_true")
        g.add_argument("--int8-qat-forward", nargs="?", const="on",
                       default="auto", choices=["auto", "on", "off"],
                       help="run eligible fake-quant matmuls on int8 "
                            "payloads during QAT (training/int8_qat.py; "
                            "needs full-precision activations, so not with "
                            "--amp); 'auto' turns it on under "
                            "--learn-ranges")
        g.add_argument("--range-learning-rate", type=float, default=None,
                       help="separate lr for learned ranges")
        g.add_argument("--fix-weight-ranges", action="store_true")
        g.add_argument("--fix-act-ranges", action="store_true")
        g = sp.add_argument_group("adaround")
        g.add_argument("--adaround", action="append", default=None,
                       help="layer name or 'all' (repeatable)")
        g.add_argument("--adaround-num-samples", type=int, default=1024)
        g.add_argument("--adaround-init", default="range_estimator",
                       choices=["range_estimator", "mse", "mse_out",
                                "mse_out_asym"])
        g.add_argument("--adaround-mode", default="learned_hard_sigmoid",
                       choices=["learned_sigmoid", "learned_hard_sigmoid",
                                "sigmoid_temp_decay"])
        g.add_argument("--adaround-asym", action="store_true", default=True)
        g.add_argument("--no-adaround-asym", dest="adaround_asym",
                       action="store_false")
        g.add_argument("--adaround-include-act-func", action="store_true",
                       default=True)
        g.add_argument("--no-adaround-include-act-func",
                       dest="adaround_include_act_func", action="store_false")
        g.add_argument("--adaround-lr", type=float, default=1e-3)
        g.add_argument("--adaround-iters", type=int, default=1000)
        g.add_argument("--adaround-weight", type=float, default=0.01)
        g.add_argument("--adaround-annealing", default="20,2")
        g.add_argument("--adaround-decay-type", default="cosine",
                       choices=["linear", "cosine", "sigmoid", "power",
                                "exp", "log"])
        g.add_argument("--adaround-decay-shape", type=float, default=1.0)
        g.add_argument("--adaround-decay-start", type=float, default=0.0)
        g.add_argument("--adaround-warmup", type=float, default=0.2)
        g.add_argument("--adaround-act-quant-mode", "--adaround-act-quant",
                       dest="adaround_act_quant_mode",
                       default="post_adaround",
                       choices=["no_act_quant", "post_adaround"])

    for cmd in ("train-baseline", "validate-baseline"):
        add_common(sub.add_parser(cmd))
    for cmd in ("train-quantized", "validate-quantized"):
        sp = sub.add_parser(cmd)
        add_common(sp)
        add_quant(sp)
    return p


def make_quant_defaults(args):
    from transformer_quantization_tpu_torch.quant.qconfig import QuantDefaults
    from transformer_quantization_tpu_torch.quant.quantizers import QMethod
    from transformer_quantization_tpu_torch.quant.ranges import (
        OptMethod,
        RangeMethod,
    )

    return QuantDefaults(
        method=QMethod[args.qmethod],
        act_method=QMethod[args.qmethod_act],
        n_bits=args.n_bits,
        n_bits_act=args.n_bits_act,
        per_channel_weights=args.per_channel,
        percentile=args.percentile,
        weight_range_method=RangeMethod[args.weight_quant_method],
        weight_range_opt=OptMethod[args.weight_opt_method],
        weight_num_candidates=args.num_candidates,
        act_range_method=RangeMethod[args.act_quant_method],
        act_range_opt=OptMethod[args.act_opt_method],
        act_momentum=args.act_momentum,
        act_num_candidates=args.act_num_candidates,
    )


def parse_quant_dict(s: Optional[str]) -> Dict:
    if not s:
        return {}
    d = ast.literal_eval(s)
    if not isinstance(d, dict):
        raise ValueError(f"--quant-dict must be a dict literal, got {s!r}")
    return d


def _load_model(args, num_labels: int = 2):
    from transformer_quantization_tpu_torch.models.hf_loader import (
        resolve_model_dir,
    )
    from transformer_quantization_tpu_torch.models.registry import build_model

    if args.model_path and not os.path.isdir(args.model_path):
        args.model_path = resolve_model_dir(
            args.model_path, allow_hub=bool(getattr(args, "from_hub", False)),
            cache_dir=getattr(args, "cache_dir", None))
    fam, cfg, params = build_model(
        args.model_name, seed=args.seed,
        tiny=getattr(args, "tiny_model", False), num_labels=num_labels,
        model_path=args.model_path, device=args.device)
    if args.model_path and os.path.exists(
            os.path.join(args.model_path, "config.json")):
        logger.info("Loaded checkpoint from %s", args.model_path)
    else:
        logger.info("No local checkpoint; initialized %s from config",
                    args.model_name)
    if args.hidden_dropout is not None:
        cfg = dataclasses.replace(cfg, hidden_dropout_prob=args.hidden_dropout)
    if args.attn_dropout is not None:
        cfg = dataclasses.replace(
            cfg, attention_probs_dropout_prob=args.attn_dropout)
    return fam, cfg, params


def _to_double(tree):
    """Every float32 tensor of a parameter tree as float64."""
    if isinstance(tree, dict):
        return {k: _to_double(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_double(v) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.dtype == torch.float32:
        return tree.to(torch.float64)
    return tree


def run_task(args, task, do_train: bool, quantized: bool) -> float:
    from transformer_quantization_tpu_torch.ops.engine import (
        EngineIncompatible,
    )
    from transformer_quantization_tpu_torch.quant import adaround as AR
    from transformer_quantization_tpu_torch.quant.qconfig import (
        Phase,
        QuantMode,
    )
    from transformer_quantization_tpu_torch.quant.quantizers import (
        AdaRoundMode,
    )
    from transformer_quantization_tpu_torch.training import (
        adaround_driver as AD,
    )
    from transformer_quantization_tpu_torch.training import qat as QAT
    from transformer_quantization_tpu_torch.training import trainer as T
    from transformer_quantization_tpu_torch.training.calibration import (
        prepare_quantized_model,
    )
    from transformer_quantization_tpu_torch.utils import checkpoint as CK
    from transformer_quantization_tpu_torch.utils import data as D
    from transformer_quantization_tpu_torch.utils import glue as G
    from transformer_quantization_tpu_torch.utils.profiling import PhaseTimer

    dev = torch.device(args.device)
    timer = PhaseTimer()
    fam, cfg, params = _load_model(args, num_labels=task.num_labels)
    cfg = dataclasses.replace(cfg, num_labels=task.num_labels)
    if not args.model_path:
        params[fam.head_key] = fam.init_head(cfg, args.seed + 1, dev)
    if getattr(args, "double", False):
        # the whole model (and hence all quantizer math) in float64
        params = _to_double(params)

    splits = G.load_task_data(task, data_dir=args.data_dir,
                              synthetic=args.synthetic_data, seed=args.seed)
    tok = D.load_tokenizer(args.model_path, cfg.vocab_size)
    train_arr = D.encode_examples(tok, task, splits["train"],
                                  args.max_seq_length)
    val_arr = D.encode_examples(tok, task, splits["validation"],
                                args.max_seq_length)
    if args.num_train_samples:
        train_arr = {k: v[:args.num_train_samples]
                     for k, v in train_arr.items()}
    if cfg.type_vocab_size == 1:
        # a one-row token-type table (RoBERTa): its tokenizer gives type 0
        # only, where a pair encoder's type 1 would index past the table
        for arr in (train_arr, val_arr):
            arr["token_type_ids"] = np.zeros_like(arr["token_type_ids"])

    apply_fn = functools.partial(fam.apply, cfg=cfg, device=dev)
    if getattr(args, "scan_layers", False):
        apply_fn = functools.partial(apply_fn, scan_layers=True)
    weight_quant = act_quant = False
    qcfg = qstate = None
    eval_mode = T.FP32_MODE

    if quantized:
        weight_quant = not args.no_weight_quant
        act_quant = not args.no_act_quant
        quant_dict = parse_quant_dict(args.quant_dict)
        qcfg = fam.declare_sites(make_quant_defaults(args), cfg,
                                 quant_setup=args.quant_setup,
                                 quant_dict=quant_dict)
        qcfg = fam.apply_peg(
            qcfg, cfg.num_hidden_layers, per_token=args.per_token,
            per_embd=args.per_embd, per_groups=args.per_groups,
            permute=args.per_groups_permute
            or args.per_groups_permute_shared_h)
        qcfg = fam.apply_quant_dict(qcfg, quant_dict, cfg.num_hidden_layers)

        est_batches = list(D.batch_iterator(
            train_arr, args.est_ranges_batch_size, drop_last=True))
        est_pad = (args.est_ranges_pad if args.est_ranges_pad is not None
                   else args.pad_to_max_length)
        for i, b in enumerate(est_batches):
            b.pop("example_mask", None)
            b.pop("labels", None)
            if not est_pad:
                est_batches[i] = D.trim_to_real_length(b)

        if CK.is_checkpoint(args.quant_model_path):
            ck = CK.load_checkpoint(args.quant_model_path, device=dev)
            params = ck["params"]
            qstate = ck.get("qstate", {})
            eval_mode = QuantMode(weight_quant=weight_quant,
                                  act_quant=act_quant,
                                  weight_phase=Phase.fix,
                                  act_phase=(Phase.estimate if args.dynamic
                                             else Phase.fix))
            logger.info("Loaded quantized checkpoint from %s",
                        args.quant_model_path)
        else:
            shared = (fam.shared_perm_groups(cfg.num_hidden_layers)
                      if args.per_groups_permute_shared_h
                      and fam.shared_perm_groups else None)
            with timer.phase("calibration"):
                qstate, eval_mode = prepare_quantized_model(
                    apply_fn, params, qcfg,
                    est_batches[:max(args.num_est_batches, 1)],
                    weight_tensors=fam.weight_site_tensors(params),
                    num_batches=args.num_est_batches, act_quant=act_quant,
                    weight_quant=weight_quant, dynamic=args.dynamic,
                    cross_entropy_layer=args.cross_entropy_layer,
                    permute_batches=est_batches[:10], shared_groups=shared,
                    device=dev)

        # AdaRound (validate path only)
        ar_cfg = None
        if not do_train and weight_quant and args.adaround:
            ann = tuple(float(x) for x in args.adaround_annealing.split(","))
            ar_cfg = AR.AdaRoundConfig(
                layers=tuple(args.adaround),
                num_samples=args.adaround_num_samples,
                init=AR.AdaRoundInitMode[args.adaround_init],
                round_mode=AdaRoundMode[args.adaround_mode],
                asym=args.adaround_asym,
                include_act_func=args.adaround_include_act_func,
                lr=args.adaround_lr, iters=args.adaround_iters,
                weight=args.adaround_weight, annealing=ann,
                decay_type=AR.AdaRoundTempDecayType[args.adaround_decay_type],
                decay_shape=args.adaround_decay_shape,
                decay_start=args.adaround_decay_start,
                warmup=args.adaround_warmup,
                act_quant_mode=AR.AdaRoundActQuantMode[
                    args.adaround_act_quant_mode],
                batch_size=args.batch_size)
            data_batches = list(D.batch_iterator(train_arr, args.batch_size,
                                                 drop_last=True))
            with timer.phase("adaround"):
                qstate = AD.apply_adaround_to_model(
                    apply_fn, params, qcfg, qstate,
                    fam.adaround_specs(params, cfg), data_batches, ar_cfg,
                    batch_size=args.batch_size,
                    act_quant=act_quant and ar_cfg.act_quant_mode
                    == AR.AdaRoundActQuantMode.post_adaround,
                    range_est_batches=est_batches,
                    num_est_batches=args.num_est_batches,
                    cross_entropy_layer=args.cross_entropy_layer,
                    seed=args.seed, device=dev)

    tb_writer = None
    tb_dir = args.tb_logging_dir
    if tb_dir is None and getattr(args, "tb", False):
        tb_dir = os.path.join(args.output_dir or ".", "tb")
    if tb_dir:
        from transformer_quantization_tpu_torch.utils.telemetry import (
            TBWriter,
        )

        tb_writer = TBWriter(os.path.join(tb_dir, task.name))

    if do_train:
        eval_every = args.eval_every
        if args.eval_during_training and eval_every is None:
            eval_every = args.log_every
        if args.eval_strategy == "no":
            eval_every = None
        tcfg = T.TrainConfig(learning_rate=args.learning_rate,
                             num_epochs=args.num_epochs,
                             batch_size=args.batch_size,
                             weight_decay=args.weight_decay,
                             max_grad_norm=args.max_grad_norm,
                             warmup_ratio=args.warmup_ratio, seed=args.seed,
                             grad_accum_steps=(
                                 args.gradient_accumulation_steps),
                             log_every=args.log_every,
                             eval_every=eval_every,
                             eval_at_epoch_end=args.eval_strategy == "epoch",
                             progress_bar=args.tqdm,
                             save_every=args.save_every,
                             eval_batch_size=args.eval_batch_size,
                             max_steps=args.max_steps,
                             warmup_steps=args.warmup_steps,
                             lr_scheduler_type=args.lr_scheduler_type,
                             ffn_weight_decay=args.ffn_weight_decay,
                             load_best_model_at_end=(
                                 args.load_best_model_at_end),
                             metric_for_best_model=args.metric_for_best_model,
                             greater_is_better=not args.smaller_is_better)
        amp_dtype = "bfloat16" if args.amp else None
        qat_cfg = QAT.QATConfig(compute_dtype=amp_dtype, remat=args.remat,
                                scan_layers=args.scan_layers)
        if quantized:
            qat_cfg = QAT.QATConfig(
                learn_ranges=args.learn_ranges,
                fix_weight_ranges=args.fix_weight_ranges,
                fix_act_ranges=args.fix_act_ranges,
                learning_rate=args.learning_rate,
                range_learning_rate=args.range_learning_rate,
                compute_dtype=amp_dtype, remat=args.remat,
                scan_layers=args.scan_layers)
            i8fwd = getattr(args, "int8_qat_forward", "auto") or "auto"
            want_i8 = (i8fwd == "on" if i8fwd != "auto"
                       else bool(args.learn_ranges))
            if want_i8:
                if amp_dtype is not None:
                    (logger.warning if i8fwd == "on" else logger.info)(
                        "--int8-qat-forward needs full-precision "
                        "activations (bf16 rounds them off-grid); "
                        "IGNORED with --amp")
                else:
                    sites = QAT.int8_forward_sites(qcfg, qstate)
                    n_real = sum(1 for s in sites if not s.startswith("L."))
                    if not n_real:
                        logger.warning("--int8-qat-forward: no eligible "
                                       "matmul sites in this config; "
                                       "using the float forward")
                    else:
                        qat_cfg = dataclasses.replace(qat_cfg,
                                                      int8_sites=sites)
                        logger.info("int8 QAT forward active for %d "
                                    "matmul sites", n_real)
                        if (cfg.hidden_dropout_prob or 0) > 0:
                            logger.warning(
                                "training hidden dropout %.2f > 0 "
                                "disables the int8 forward at train time "
                                "(off-grid inputs); pass "
                                "--hidden-dropout 0.0 to keep it",
                                cfg.hidden_dropout_prob)

        save_fn = None
        if args.output_dir and args.save_every:
            # seeded with the checkpoints already on disk, so a resumed run
            # keeps pruning the earlier process's checkpoints too
            pat = re.compile(re.escape(f"checkpoint_{task.name}_step")
                             + r"(\d+)$")
            saved_steps = sorted(
                int(m.group(1)) for d in os.listdir(args.output_dir)
                if (m := pat.match(d))
            ) if os.path.isdir(args.output_dir) else []

            def save_fn(p, qs, step):
                CK.save_checkpoint(
                    os.path.join(args.output_dir,
                                 f"checkpoint_{task.name}_step{step}"),
                    params=p, family=fam.name, cfg=cfg,
                    qstate=qs if quantized else None,
                    extra={"command": args.command, "step": step})
                saved_steps.append(step)
                while (args.save_total_limit
                       and len(saved_steps) > args.save_total_limit):
                    old = saved_steps.pop(0)
                    shutil.rmtree(
                        os.path.join(args.output_dir,
                                     f"checkpoint_{task.name}_step{old}"),
                        ignore_errors=True)

        def residual_hists(step):
            if not (args.tb_train_histograms and tb_writer is not None):
                return
            from transformer_quantization_tpu_torch.utils.telemetry import (
                write_residual_histograms,
            )

            hb = next(iter(D.batch_iterator(val_arr, args.eval_batch_size)))
            hb.pop("labels", None)
            hb.pop("example_mask", None)
            write_residual_histograms(
                apply_fn, params, qcfg, qstate, hb, tb_writer, step=step,
                mode=eval_mode if quantized else T.FP32_MODE)

        if quantized:
            residual_hists(0)
        train_state_path = None
        if args.output_dir and args.save_every:
            train_state_path = os.path.join(args.output_dir,
                                            f"train_state_{task.name}")
        with timer.phase("train"):
            params, qstate = T.train(apply_fn, params, task, train_arr, tcfg,
                                     qcfg=qcfg, qstate=qstate,
                                     qat_cfg=qat_cfg, log_fn=logger.info,
                                     eval_arrays=val_arr,
                                     tb_writer=tb_writer, save_fn=save_fn,
                                     train_state_path=train_state_path,
                                     resume=args.resume)
        if quantized:
            # ranges fixed after training for the final eval
            eval_mode = QuantMode(weight_quant=weight_quant,
                                  act_quant=act_quant,
                                  weight_phase=Phase.fix, act_phase=Phase.fix)
            residual_hists(1)

    if args.output_dir:
        CK.save_checkpoint(
            os.path.join(args.output_dir, f"checkpoint_{task.name}"),
            params=params, family=fam.name, cfg=cfg,
            qstate=qstate if quantized else None,
            extra={"command": args.command, "seed": args.seed})

    eval_splits = [("validation", val_arr)]
    if task.name == "mnli" and "validation_mismatched" in splits:
        mm = D.encode_examples(tok, task, splits["validation_mismatched"],
                               args.max_seq_length)
        eval_splits.append(("validation_mismatched", mm))

    full_q = QuantMode()

    def make_engine_apply(qs, mode):
        """Engine forward for this qstate and mode, the generic int path's
        forward, or None (simulation). Rebuilt per qstate: the plan bakes
        site scales, and the AdaRound multi-eval re-estimates act ranges
        per setting. The engine bakes the full-quant fixed-range mode;
        every other mode (dynamic, weight-only, a family without an
        engine, a config the plan refuses) takes the generic int path,
        whose sites follow ``mode``."""
        if not quantized or args.engine == "off":
            return None
        backend = args.engine
        if backend == "auto":
            backend = "kernels" if args.device == "cuda" else "plain"

        def generic_int_apply(why):
            logger.info("generic int path active for eval (%s, backend=%s)",
                        why, backend)
            ip = (fam.build_int_params(params, qcfg, qs, args.n_bits <= 4)
                  if mode.weight_quant else None)
            kw = {}
            if (backend == "kernels" and "fused_linear"
                    in inspect.signature(fam.apply).parameters):
                kw["fused_linear"] = True

            def int_apply(p, batch, qcfg=None, qstate=None, mode=None,
                          **more):
                return fam.apply(p, batch, cfg, qcfg, qstate, mode,
                                 int_params=ip, device=dev, **kw, **more)

            return int_apply

        if args.dynamic:
            return generic_int_apply("dynamic ranges")
        if mode != full_q:
            return generic_int_apply("non-default quant mode")
        if fam.build_engine is None:
            return generic_int_apply("no engine for family")
        try:
            e_static, e_plan, e_int = fam.build_engine(
                params, cfg, qcfg, qs, use_int4=args.n_bits <= 4, device=dev)
        except EngineIncompatible as e:
            return generic_int_apply(f"engine unavailable: {e}")
        logger.info("int8 engine active for eval (backend=%s)", backend)

        def engine_apply(p, batch, qcfg=None, qstate=None, mode=None, **kw):
            out = fam.engine_apply(p, batch, cfg, qcfg, qstate, e_static,
                                   e_plan, e_int, backend=backend,
                                   device=dev)
            return out, qstate

        return engine_apply

    def eval_mean(qs, mode):
        split_scores, res = [], {}
        fwd = make_engine_apply(qs, mode) or apply_fn
        for split_name, arr in eval_splits:
            with timer.phase("eval"):
                m = T.evaluate(fwd, params, qs, task, arr, qcfg=qcfg,
                               mode=mode, batch_size=args.eval_batch_size,
                               num_val_samples=args.num_val_samples)
            res[split_name] = m
            split_scores.append(m.get(task.final_metric,
                                      m.get("combined_score")))
            logger.info("Eval results %s/%s: %s", task.name, split_name, m)
            if args.num_val_samples is not None:
                break
        return float(np.mean(split_scores)), res

    if quantized and ar_cfg is not None and not args.dynamic:
        # AdaRound's multi-eval: the FP-acts score, then act ranges
        # re-estimated at batch sizes {1, 4, 16}; the best is reported
        est_pad = (args.est_ranges_pad if args.est_ranges_pad is not None
                   else args.pad_to_max_length)
        final, details = AD.adaround_multi_eval(
            apply_fn, params, qcfg, qstate, eval_fn=eval_mean,
            est_arrays=train_arr, act_quant_mode=ar_cfg.act_quant_mode,
            weight_quant=weight_quant, act_quant=act_quant,
            num_est_batches=args.num_est_batches, est_pad=est_pad,
            cross_entropy_layer=args.cross_entropy_layer,
            log_fn=logger.info, device=dev)
        results = details["payload"]
        qstate = details["best_qstate"]
    else:
        final, results = eval_mean(qstate, eval_mode)
    logger.info("Phase timings:\n%s", timer.report())

    if tb_writer is not None:
        if quantized and qstate:
            tb_writer.write_range_summary(qcfg, qstate)
        tb_writer.scalar(f"eval/{task.final_metric}", final)
        tb_writer.close()

    if args.output_dir:
        os.makedirs(args.output_dir, exist_ok=True)
        for split_name, m in results.items():
            suffix = ("mnli-mm" if split_name == "validation_mismatched"
                      else task.name)
            with open(os.path.join(args.output_dir,
                                   f"eval_results_{suffix}.txt"), "w") as f:
                for k, v in m.items():
                    f.write(f"{k} = {v}\n")
    return final


def _log_results(task_scores: Dict[str, float]):
    """Macro-average incl./excl. WNLI."""
    for t, s in task_scores.items():
        logger.info("GLUE task %s: %.2f", t, 100.0 * s)
    vals = list(task_scores.values())
    logger.info("GLUE macro-avg (incl. WNLI): %.2f",
                100.0 * float(np.mean(vals)))
    no_wnli = [s for t, s in task_scores.items() if t != "wnli"]
    if no_wnli and "wnli" in task_scores:
        logger.info("GLUE macro-avg (excl. WNLI): %.2f",
                    100.0 * float(np.mean(no_wnli)))


def _recipe_options(recipe) -> Dict:
    """A ``training/calibration.py`` ``Recipe`` as CLI options: the site
    defaults, the quant_dict (as its literal), shared-h PEG, the
    classifier's setup, the calibration batch (a padded one through
    ``--pad-to-max-length``, which ``--est-ranges-pad`` inherits) and
    ``--no-act-quant``."""
    d = recipe.defaults
    out = dict(n_bits=d.n_bits, n_bits_act=d.n_bits_act,
               qmethod=d.method.name, qmethod_act=d.act_method.name,
               weight_quant_method=d.weight_range_method.name,
               weight_opt_method=d.weight_range_opt.name,
               num_candidates=d.weight_num_candidates,
               act_quant_method=d.act_range_method.name,
               est_ranges_batch_size=recipe.est_batch_size,
               num_est_batches=1, quant_setup=recipe.quant_setup)
    if recipe.est_pad:
        out["pad_to_max_length"] = True
    else:
        out["est_ranges_pad"] = False
    if recipe.quant_dict:
        out["quant_dict"] = repr(dict(recipe.quant_dict))
    if recipe.shared_h:
        out["per_groups_permute_shared_h"] = True
    if not recipe.act_quant:
        out["no_act_quant"] = True
    return out


def _build_recipes() -> Dict[str, Dict]:
    """The JAX CLI's ``RECIPES``, read from the port's preset tables."""
    from transformer_quantization_tpu_torch.training import calibration as CAL
    from transformer_quantization_tpu_torch.training import trainer as T

    recipes = {name: _recipe_options(CAL.CLI_RECIPES[name])
               for name in ("w8a8", "w8a8-mixed", "w8a8-peg",
                            "w8a8-mixed-stsb")}
    rec, ar = CAL.ADAROUND_RECIPES["w4-adaround"]
    recipes["w4-adaround"] = dict(
        _recipe_options(rec), adaround=list(ar.layers),
        adaround_num_samples=ar.num_samples, adaround_init=ar.init.name,
        adaround_mode=ar.round_mode.name, adaround_iters=ar.iters,
        adaround_act_quant_mode=ar.act_quant_mode.name,
        batch_size=ar.batch_size)
    tcfg, qat = T.QAT_RECIPES["qat-w4a8"]
    # the QAT recipe trains with both dropouts at 0 (QAT_RECIPES' note)
    recipes["qat-w4a8"] = dict(
        _recipe_options(CAL.CLI_RECIPES["qat-w4a8"]),
        learn_ranges=qat.learn_ranges, batch_size=tcfg.batch_size,
        learning_rate=tcfg.learning_rate, num_epochs=tcfg.num_epochs,
        warmup_steps=tcfg.warmup_steps, weight_decay=tcfg.weight_decay,
        attn_dropout=0.0, hidden_dropout=0.0)
    return recipes


RECIPES = _build_recipes()


def apply_recipe(args) -> None:
    """Overlay a named recipe onto options the user left at defaults."""
    name = args.recipe
    if name == "w8a8-mixed" and any(
            t.lower().replace("-", "") == "stsb"
            for t in (getattr(args, "task", None) or [])):
        # STS-B's variant: pooler and classifier sites 16-bit, the
        # regression output's range by MSE
        name = "w8a8-mixed-stsb"
    recipe = RECIPES[name]
    defaults = vars(build_parser().parse_args([args.command]))
    for k, v in recipe.items():
        if k not in vars(args):
            continue  # e.g. adaround options on a train command
        if vars(args)[k] == defaults.get(k):
            setattr(args, k, v)
    logger.info("applied recipe %r (explicit flags take precedence)",
                args.recipe)


def main(argv=None):
    from transformer_quantization_tpu_torch import resolve_device
    from transformer_quantization_tpu_torch.utils import glue as G
    from transformer_quantization_tpu_torch.utils.misc import seed_all
    from transformer_quantization_tpu_torch.utils.profiling import trace

    logging.basicConfig(
        level=os.environ.get("LOGLEVEL", "INFO"),
        format="%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    args = build_parser().parse_args(argv)
    resolve_device(args.device)  # raises without a card for 'cuda'
    if getattr(args, "recipe", None):
        apply_recipe(args)
    if args.pp_stages > 1:
        raise NotImplementedError(
            "--pp-stages > 1: the pipeline is not yet ported (ROADMAP §1 "
            "item 9)")
    if args.export_dir:
        raise NotImplementedError(
            "--export-dir: serving export is not yet ported (ROADMAP §1 "
            "item 6)")
    seed_all(args.seed)
    do_train = args.command.startswith("train")
    quantized = args.command.endswith("quantized")
    if getattr(args, "per_token", False) and not args.dynamic:
        # static per-position ranges are meaningless: per-token implies
        # dynamic quantization
        logger.info("--per-token forces --dynamic")
        args.dynamic = True
    tasks = G.resolve_tasks(args.task or ["rte"])

    if args.output_dir:
        os.makedirs(args.output_dir, exist_ok=True)
        with open(os.path.join(args.output_dir, "config.out"), "w") as f:
            f.write(json.dumps(vars(args), indent=2, default=str) + "\n")

    task_scores = {}
    with trace(getattr(args, "profile_dir", None)):
        for task in tasks:
            logger.info("%s task %s",
                        "Training" if do_train else "Validating", task.name)
            task_scores[task.name] = run_task(args, task, do_train, quantized)
            logger.info("Final score %s -> %.2f", task.name,
                        100.0 * task_scores[task.name])

    _log_results(task_scores)
    final = float(np.mean(list(task_scores.values())))
    if args.output_dir:
        with open(os.path.join(args.output_dir, "final_score.txt"), "w") as f:
            f.write(f"{final}\n")
    print(json.dumps({"final_score": final,
                      "tasks": {k: round(v, 4)
                                for k, v in task_scores.items()}}))
    return final


if __name__ == "__main__":
    main()
