"""Train and eval loops.

Counterpart of ``transformer_quantization_tpu/training/trainer.py``: the
float baseline (``qcfg=None``), PTQ evaluation and QAT over fixed-shape
numpy batches (``utils/data.py`` ``batch_iterator``), with the JAX
trainer's optimizer (``training/optim.py``: clipping over weights and
ranges together, AdamW, the warmup + decay schedule, ``ffn_weight_decay``
on FFN kernels only, gradient accumulation), its cadences in optimizer
steps, ``max_steps``, resume (the numpy shuffle replayed), best-model
tracking and restore, and mid-train state files.

As in JAX, ``train`` builds its optimizer with :func:`make_optimizer`,
so ``QATConfig.range_learning_rate`` does not reach it. Dropout draws
from a ``torch.Generator`` on the params' device seeded with
``TrainConfig.seed``; its state is part of the train state. ``apply_fn``
binds its model config and device: ``apply_fn(params, batch, qcfg=,
qstate=, mode=, [train=, dropout_generator=, int8_qat_sites=]) ->
(outputs, qstate)``.

:data:`QAT_RECIPES` pairs the JAX CLI's ``qat-w4a8`` recipe's training
options with its calibration preset (``training/calibration.py``
``CLI_RECIPES``), and :func:`prepare_qat` calibrates a model for it as the
CLI does.
"""

from __future__ import annotations

import copy
import dataclasses
import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from transformer_quantization_tpu_torch import convert as C
from transformer_quantization_tpu_torch.quant.qconfig import (
    QuantModelConfig,
    QuantMode,
)
from transformer_quantization_tpu_torch.quant.quantizers import QuantParams
from transformer_quantization_tpu_torch.training import optim as O
from transformer_quantization_tpu_torch.training import qat as QAT
from transformer_quantization_tpu_torch.utils.data import batch_iterator
from transformer_quantization_tpu_torch.utils.glue import (
    GlueTask,
    compute_metrics,
)

FP32_MODE = QuantMode(weight_quant=False, act_quant=False)


@dataclasses.dataclass
class TrainConfig:
    """Training options (the JAX ``TrainConfig``; cadences and
    ``max_steps`` in optimizer steps)."""

    learning_rate: float = 5e-5
    num_epochs: int = 3
    batch_size: int = 32
    weight_decay: float = 0.0
    max_grad_norm: float = 1.0
    warmup_ratio: float = 0.0
    seed: int = 1000
    log_every: int = 50
    grad_accum_steps: int = 1
    eval_every: Optional[int] = None
    eval_at_epoch_end: bool = False
    save_every: Optional[int] = None
    eval_batch_size: int = 32
    # a tqdm bar over each epoch's batches when tqdm is installed and
    # stderr is a terminal; log lines otherwise
    progress_bar: bool = False
    max_steps: Optional[int] = None
    warmup_steps: Optional[int] = None
    lr_scheduler_type: str = "linear"   # linear | cosine | constant
    ffn_weight_decay: float = 0.0
    load_best_model_at_end: bool = False
    metric_for_best_model: Optional[str] = None
    greater_is_better: bool = True


# the JAX CLI's qat-w4a8 recipe (its ``RECIPES``): batch 8, lr 5e-5, six
# epochs, 186 warmup steps, no weight decay, learned ranges; the model
# trains with both dropouts at 0 and the int8 forward on (the CLI's
# ``auto`` under learn_ranges); calibration: ``CLI_RECIPES["qat-w4a8"]``
QAT_RECIPES = {
    "qat-w4a8": (TrainConfig(learning_rate=5e-5, num_epochs=6,
                             batch_size=8, warmup_steps=186,
                             weight_decay=0.0),
                 QAT.QATConfig(learn_ranges=True, learning_rate=5e-5,
                               weight_decay=0.0)),
}


def _model_batch(batch: Dict) -> Dict:
    return {k: v for k, v in batch.items()
            if k not in ("labels", "example_mask")}


def evaluate(apply_fn: Callable, params, qstate, task: GlueTask,
             arrays: Dict[str, np.ndarray], *, qcfg=None,
             mode: QuantMode = FP32_MODE, batch_size: int = 32,
             num_val_samples: Optional[int] = None) -> Dict[str, float]:
    """Whole-split evaluation -> the task's metrics (the final batch
    padded and its padding masked out)."""
    if num_val_samples is not None:
        arrays = {k: v[:num_val_samples] for k, v in arrays.items()}
    logits, labels = [], []
    for batch in batch_iterator(arrays, batch_size, pad_final=True):
        em = batch.pop("example_mask")
        out, qstate = apply_fn(params, _model_batch(batch), qcfg=qcfg,
                               qstate=qstate, mode=mode)
        keep = em > 0
        logits.append(out["logits"].detach().cpu().numpy()[keep])
        labels.append(np.asarray(batch["labels"])[keep])
    return compute_metrics(task, np.concatenate(logits),
                           np.concatenate(labels))


def lr_schedule(tcfg: TrainConfig, steps_total: int) -> O.Schedule:
    """Warmup (``warmup_steps``, else ``warmup_ratio`` of the total), then
    linear, cosine or constant over the rest, joined as
    ``optax.join_schedules`` joins them."""
    warmup = (tcfg.warmup_steps if tcfg.warmup_steps is not None
              else int(tcfg.warmup_ratio * steps_total))
    rest = max(steps_total - warmup, 1)
    if tcfg.lr_scheduler_type == "cosine":
        decay = O.cosine_decay_schedule(tcfg.learning_rate, rest)
    elif tcfg.lr_scheduler_type == "constant":
        decay = O.constant_schedule(tcfg.learning_rate)
    elif tcfg.lr_scheduler_type == "linear":
        decay = O.linear_schedule(tcfg.learning_rate, 0.0, rest)
    else:
        raise ValueError(f"unknown lr_scheduler_type "
                         f"{tcfg.lr_scheduler_type!r}")
    if warmup > 0:
        warm = O.linear_schedule(0.0, tcfg.learning_rate, warmup)
        return O.join_schedules([warm, decay], [warmup])
    return decay


def is_ffn_kernel(path) -> bool:
    """An FFN matmul weight: the last key ``kernel`` under an ``ffn`` key
    (biases and the FFN LayerNorm are not)."""
    return bool(path) and path[-1] == "kernel" and any("ffn" in k
                                                        for k in path)


def make_optimizer(tcfg: TrainConfig, steps_total: int,
                   params) -> O.Optimizer:
    """Clip by global norm, then AdamW on the schedule of
    :func:`lr_schedule` (``ffn_weight_decay`` added on FFN kernels), with
    gradient accumulation over ``grad_accum_steps``; the leaves are
    ``params``' and then the packed ranges."""
    lr = lr_schedule(tcfg, steps_total)
    paths = QAT.trainable_paths(params)
    groups = {"other": O.Group(lr, tcfg.weight_decay)}
    labels = ["other"] * len(paths)
    if tcfg.ffn_weight_decay:
        groups["ffn"] = O.Group(lr, tcfg.weight_decay
                                + tcfg.ffn_weight_decay)
        labels = ["ffn" if is_ffn_kernel(p) else "other" for p in paths]
    return O.Optimizer(groups, labels, max_grad_norm=tcfg.max_grad_norm,
                       accum=max(tcfg.grad_accum_steps, 1))


def _params_device(params) -> torch.device:
    return QAT.tree_leaves(params)[0][1].device


def save_train_state(path: str, params, learnable, rest, opt_state,
                     generator: torch.Generator, step_i: int,
                     best: Optional[Dict] = None) -> None:
    """The whole mid-train state: weights, ranges and the rest of the
    quant state (``<path>.model.npz``, ``utils/checkpoint.py``'s tree
    format), the optimizer state, the dropout generator, the position and
    the best model so far (``<path>.opt.npz``)."""
    from transformer_quantization_tpu_torch.utils import checkpoint as CK

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tree = {"params": params, "learnable": learnable, "rest": rest}
    extra = {}
    if best is not None and best.get("state") is not None:
        bp, bl, br = best["state"]
        tree["best"] = {"params": bp, "learnable": bl, "rest": br}
        extra["__best_score__"] = np.asarray(best["score"])
    CK.save_tree(path + ".model.npz", tree)
    np.savez(path + ".opt.npz", __step__=np.asarray(step_i),
             __rng__=generator.get_state().numpy(), **extra,
             **{"opt/" + k: v for k, v in O.state_arrays(opt_state).items()})


def load_train_state(path: str, opt_template: Dict,
                     generator: torch.Generator, device) -> Tuple:
    """Inverse of :func:`save_train_state` onto ``device``;
    ``opt_template`` is a fresh ``Optimizer.init`` state, and
    ``generator`` takes the saved state. Returns ``(params, learnable,
    rest, opt_state, generator, step, best)``."""
    from transformer_quantization_tpu_torch.utils import checkpoint as CK

    model = CK.load_tree(path + ".model.npz")
    best = {"score": None, "state": None}
    with np.load(path + ".opt.npz") as z:
        step_i = int(z["__step__"])
        generator.set_state(torch.from_numpy(np.array(z["__rng__"])))
        if "__best_score__" in z.files and "best" in model:
            best = {"score": float(z["__best_score__"]),
                    "state": C.train_state_from_jax(model["best"], device)}
        opt = {k[len("opt/"):]: z[k] for k in z.files if k.startswith("opt/")}
    opt_state = O.state_from_arrays(opt, opt_template, device)
    return (*C.train_state_from_jax(model, device), opt_state, generator,
            step_i, best)


def has_train_state(path: str) -> bool:
    return os.path.exists(path + ".opt.npz")


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, QuantParams):
        return QuantParams(delta=_clone(tree.delta),
                           zero_float=_clone(tree.zero_float),
                           signed=_clone(tree.signed))
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v) for v in tree)
    return copy.copy(tree)


def train(apply_fn: Callable, params, task: GlueTask,
          train_arrays: Dict[str, np.ndarray], tcfg: TrainConfig, *,
          qcfg: Optional[QuantModelConfig] = None,
          qstate: Optional[Dict] = None,
          qat_cfg: Optional[QAT.QATConfig] = None,
          eval_arrays: Optional[Dict[str, np.ndarray]] = None,
          log_fn: Callable = print, tb_writer=None,
          save_fn: Optional[Callable] = None,
          train_state_path: Optional[str] = None, resume: bool = False,
          step_callback: Optional[Callable] = None) -> Tuple:
    """The train loop: the float baseline (``qcfg=None``) or QAT
    (``qcfg``, ``qstate``, ``qat_cfg``). Returns ``(params, qstate)``, the
    learned ranges merged back.

    ``eval_every`` / ``eval_at_epoch_end`` evaluate ``eval_arrays`` with
    the current (frozen) ranges; ``save_every`` calls ``save_fn(params,
    qstate, step)`` and writes the train state to ``train_state_path``;
    ``resume`` continues from that state, replaying the shuffle;
    ``load_best_model_at_end`` restores the best evaluated step;
    ``tb_writer`` (``utils/telemetry.py`` ``TBWriter``) receives
    ``train/loss`` at the log cadence and ``eval/<metric>`` at the eval
    cadence. ``step_callback(step, loss)``, when given, sees every
    micro-batch's loss (a 0-d tensor)."""
    n = len(train_arrays["input_ids"])
    steps_per_epoch = max(n // tcfg.batch_size, 1)
    total = steps_per_epoch * tcfg.num_epochs
    qat_cfg = qat_cfg or QAT.QATConfig()
    qstate = qstate or {}
    qcfg_ = qcfg or QuantModelConfig(())
    # the schedule advances once per optimizer update
    tx = make_optimizer(tcfg, max(total // tcfg.grad_accum_steps, 1),
                        params)
    step_fn = QAT.make_qat_train_step(apply_fn, qcfg_, qat_cfg, tx)
    params, learnable, rest, opt_state = QAT.init_qat_state(
        qcfg_, qat_cfg, params, qstate, tx)
    dev = _params_device(params)

    start_step = 0
    gen = torch.Generator(device=dev).manual_seed(tcfg.seed)
    best = {"score": None, "state": None}
    if resume and train_state_path and has_train_state(train_state_path):
        params, learnable, rest, opt_state, gen, start_step, best = \
            load_train_state(train_state_path, opt_state, gen, dev)
        log_fn(f"resumed train state from {train_state_path} "
               f"at step {start_step}")

    quantized = qcfg is not None and len(qcfg.sites) > 0
    mid_eval_mode = QuantMode() if quantized else FP32_MODE

    def current_qstate():
        return QAT.merge_learnable_ranges(learnable, rest)

    if tcfg.load_best_model_at_end and not (
            (tcfg.eval_every or tcfg.eval_at_epoch_end)
            and eval_arrays is not None):
        log_fn("WARNING: load_best_model_at_end needs an eval cadence "
               "(eval_every / eval_at_epoch_end) and an eval split to ever "
               "record a best model; it will be a no-op")

    def track_best(m, step_i):
        if not tcfg.load_best_model_at_end:
            return
        key = tcfg.metric_for_best_model or task.final_metric
        score = m.get(key, m.get("combined_score"))
        if score is None:
            return
        better = (best["score"] is None
                  or (score > best["score"]) == tcfg.greater_is_better
                  and score != best["score"])
        if better:
            best["score"] = score
            best["state"] = _clone((params, learnable, rest))
            log_fn(f"[step {step_i}] new best {key}={score:.4f}")

    def run_mid_eval(step_i):
        if eval_arrays is None:
            return
        with torch.no_grad():
            m = evaluate(apply_fn, params, current_qstate(), task,
                         eval_arrays, qcfg=qcfg, mode=mid_eval_mode,
                         batch_size=tcfg.eval_batch_size)
        log_fn(f"[step {step_i}] eval: {m}")
        track_best(m, step_i)
        if tb_writer is not None:
            for k, v in m.items():
                tb_writer.scalar(f"eval/{k}", float(v), step_i)

    def maybe_tqdm(it, epoch):
        if not tcfg.progress_bar:
            return it
        try:
            import sys

            from tqdm import tqdm
        except ImportError:
            return it
        if not sys.stderr.isatty():
            return it
        return tqdm(it, total=steps_per_epoch, leave=False,
                    desc=f"epoch {epoch}")

    accum = max(tcfg.grad_accum_steps, 1)
    max_micro = tcfg.max_steps * accum if tcfg.max_steps else None
    data_rng = np.random.RandomState(tcfg.seed)
    step_i = 0
    for epoch in range(tcfg.num_epochs):
        for batch in maybe_tqdm(batch_iterator(
                train_arrays, tcfg.batch_size, shuffle=True, rng=data_rng,
                drop_last=True), epoch):
            if step_i < start_step:
                # a resumed run replays the shuffle without stepping
                step_i += 1
                continue
            # checked before the step: a run resumed at max_steps takes
            # no extra step
            if max_micro is not None and step_i >= max_micro:
                return _finish(params, learnable, rest, best, log_fn)
            batch.pop("example_mask")
            params, learnable, rest, opt_state, gen, loss = step_fn(
                params, learnable, rest, opt_state, batch, gen)
            step_i += 1
            if step_callback is not None:
                step_callback(step_i, loss)
            if step_i % tcfg.log_every == 0 or step_i == 1:
                log_fn(f"epoch {epoch} step {step_i}/{total} "
                       f"loss {float(loss):.4f}")
                if tb_writer is not None:
                    tb_writer.scalar("train/loss", float(loss), step_i)
            if (tcfg.eval_every and eval_arrays is not None
                    and step_i % (tcfg.eval_every * accum) == 0):
                run_mid_eval(step_i)
            if tcfg.save_every and step_i % (tcfg.save_every * accum) == 0:
                if save_fn is not None:
                    save_fn(params, current_qstate(), step_i)
                if train_state_path:
                    save_train_state(train_state_path, params, learnable,
                                     rest, opt_state, gen, step_i, best)
            if max_micro is not None and step_i >= max_micro:
                return _finish(params, learnable, rest, best, log_fn)
        if tcfg.eval_at_epoch_end and step_i > start_step:
            run_mid_eval(step_i)
    return _finish(params, learnable, rest, best, log_fn)


def _finish(params, learnable, rest, best, log_fn):
    if best["state"] is not None:
        log_fn(f"restoring best checkpoint (score {best['score']:.4f})")
        params, learnable, rest = best["state"]
    return params, QAT.merge_learnable_ranges(learnable, rest)


def prepare_qat(apply_fn: Callable, params, qcfg: QuantModelConfig,
                train_arrays: Dict[str, np.ndarray], weight_tensors,
                qat_cfg: QAT.QATConfig, recipe, *, device="cuda"):
    """Calibrate for QAT as the JAX CLI does, by ``recipe`` (a
    ``training/calibration.py`` ``Recipe``): one estimation batch of
    ``recipe.est_batch_size`` from the train split in order (labels
    dropped, trimmed to its real length unless ``recipe.est_pad``), weight
    sites from their tensors; then the int8 forward's sites
    (:func:`~.qat.int8_forward_sites`) into ``qat_cfg``. Returns
    ``(qstate, qat_cfg)``; clear ``int8_sites`` for the float forward."""
    from transformer_quantization_tpu_torch.training import (
        calibration as CAL,
    )
    from transformer_quantization_tpu_torch.utils.data import (
        trim_to_real_length,
    )

    est = []
    for b in batch_iterator(train_arrays, recipe.est_batch_size,
                            drop_last=True):
        b = _model_batch(b)
        est.append(b if recipe.est_pad else trim_to_real_length(b))
    qstate, _ = CAL.prepare_quantized_model(
        apply_fn, params, qcfg, est[:1], weight_tensors=weight_tensors,
        num_batches=1, permute_batches=est[:10], device=device)
    return qstate, dataclasses.replace(
        qat_cfg, int8_sites=QAT.int8_forward_sites(qcfg, qstate))
