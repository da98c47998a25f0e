"""GLUE task registry, metrics and examples, offline.

Counterpart of ``transformer_quantization_tpu/utils/glue.py``: per-task
sentence keys, label counts, split sizes and the final metric
(:data:`TASKS`); the metrics in numpy (accuracy, F1, Matthews
correlation, Pearson, Spearman, and ``combined_score``, the mean of a
task's metrics); deterministic synthetic examples in which each label
draws from its own slice of a shared vocabulary, so a model can learn
them; and examples read from local files, ``<data_dir>/<task>/<split>.
{jsonl,json,tsv}``, or from a local Hugging Face ``datasets`` cache
(:func:`load_task_data`; offline, nothing is downloaded).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class GlueTask:
    name: str
    sentence_keys: Tuple[str, ...]
    num_labels: int  # 1 => regression (STS-B)
    final_metric: str
    metrics: Tuple[str, ...]
    train_size: int
    dev_size: int


# reference: utils/glue_tasks.py:59-95
TASKS: Dict[str, GlueTask] = {
    "cola": GlueTask("cola", ("sentence",), 2, "matthews_correlation",
                     ("matthews_correlation",), 8551, 1043),
    "sst2": GlueTask("sst2", ("sentence",), 2, "accuracy", ("accuracy",),
                     67349, 872),
    "mrpc": GlueTask("mrpc", ("sentence1", "sentence2"), 2, "combined_score",
                     ("accuracy", "f1"), 3668, 408),
    "stsb": GlueTask("stsb", ("sentence1", "sentence2"), 1, "combined_score",
                     ("pearson", "spearmanr"), 5749, 1500),
    "qqp": GlueTask("qqp", ("question1", "question2"), 2, "combined_score",
                    ("accuracy", "f1"), 363846, 40430),
    "mnli": GlueTask("mnli", ("premise", "hypothesis"), 3, "accuracy",
                     ("accuracy",), 392702, 9815),
    "qnli": GlueTask("qnli", ("question", "sentence"), 2, "accuracy",
                     ("accuracy",), 104743, 5463),
    "rte": GlueTask("rte", ("sentence1", "sentence2"), 2, "accuracy",
                    ("accuracy",), 2490, 277),
    "wnli": GlueTask("wnli", ("sentence1", "sentence2"), 2, "accuracy",
                     ("accuracy",), 635, 71),
}

ALL_TASKS = tuple(TASKS)  # 'all' expansion (glue_tasks.py:21-56)


def resolve_tasks(names) -> List[GlueTask]:
    if isinstance(names, str):
        names = [names]
    out = []
    for n in names:
        n = n.lower().replace("-", "")
        if n == "all":
            return [TASKS[t] for t in ALL_TASKS]
        if n not in TASKS:
            raise KeyError(f"unknown GLUE task {n!r}; know {sorted(TASKS)}")
        out.append(TASKS[n])
    return out


# ---------------------------------------------------------------------------
# Metrics (numpy re-implementations of the HF metric fns the reference loads)
# ---------------------------------------------------------------------------


def _accuracy(preds, labels):
    return float(np.mean(preds == labels))


def _f1(preds, labels):
    tp = float(np.sum((preds == 1) & (labels == 1)))
    fp = float(np.sum((preds == 1) & (labels == 0)))
    fn = float(np.sum((preds == 0) & (labels == 1)))
    if tp == 0:
        return 0.0
    prec, rec = tp / (tp + fp), tp / (tp + fn)
    return 2 * prec * rec / (prec + rec)


def _matthews(preds, labels):
    tp = float(np.sum((preds == 1) & (labels == 1)))
    tn = float(np.sum((preds == 0) & (labels == 0)))
    fp = float(np.sum((preds == 1) & (labels == 0)))
    fn = float(np.sum((preds == 0) & (labels == 1)))
    denom = np.sqrt((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
    return float((tp * tn - fp * fn) / denom) if denom > 0 else 0.0


def _pearson(x, y):
    x = x.astype(np.float64) - x.mean()
    y = y.astype(np.float64) - y.mean()
    d = np.sqrt((x ** 2).sum() * (y ** 2).sum())
    return float((x * y).sum() / d) if d > 0 else 0.0


def _rank(a):
    order = np.argsort(a, kind="mergesort")
    ranks = np.empty_like(order, dtype=np.float64)
    sa = a[order]
    n = len(a)
    i = 0
    while i < n:
        j = i
        while j + 1 < n and sa[j + 1] == sa[i]:
            j += 1
        ranks[order[i:j + 1]] = 0.5 * (i + j) + 1
        i = j + 1
    return ranks


def _spearman(x, y):
    return _pearson(_rank(x), _rank(y))


def compute_metrics(task: GlueTask, logits: np.ndarray,
                    labels: np.ndarray) -> Dict[str, float]:
    """Per-task metrics + combined_score (glue_tasks.py:120-133: argmax for
    classification, squeeze for regression, mean of multi-metrics)."""
    logits = np.asarray(logits)
    labels = np.asarray(labels)
    if task.num_labels == 1:
        preds = logits.reshape(-1)
    else:
        preds = np.argmax(logits, axis=-1)
    out: Dict[str, float] = {}
    for m in task.metrics:
        if m == "accuracy":
            out[m] = _accuracy(preds, labels)
        elif m == "f1":
            out[m] = _f1(preds, labels)
        elif m == "matthews_correlation":
            out[m] = _matthews(preds, labels)
        elif m == "pearson":
            out[m] = _pearson(preds, labels.astype(np.float64))
        elif m == "spearmanr":
            out[m] = _spearman(preds, labels.astype(np.float64))
        else:
            raise ValueError(m)
    if len(out) > 1:
        out["combined_score"] = float(np.mean(list(out.values())))
    return out


# ---------------------------------------------------------------------------
# Data ingestion
# ---------------------------------------------------------------------------

_SYNTH_WORDS_PER_CLASS = 64


def synthetic_examples(task: GlueTask, split: str, n: int,
                       seed: int = 0) -> List[Dict]:
    """Deterministic synthetic classification/regression data.

    Each class draws tokens from a distinct slice of a shared vocabulary
    with some overlap, so models can genuinely fit it — used for offline
    smoke/e2e runs.
    """
    # stable across processes (Python's str hash is per-process randomized,
    # which would make "deterministic" synthetic data non-deterministic)
    import zlib

    rng = np.random.RandomState(seed + zlib.crc32(split.encode()) % 1000)
    vocab = [f"tok{i}" for i in range(512)]
    examples = []
    n_classes = max(task.num_labels, 2)
    for i in range(n):
        if task.num_labels == 1:
            label = float(rng.uniform(0, 5))
            bias = int(label / 5.0 * 400)
        else:
            label = int(rng.randint(0, n_classes))
            bias = label * _SYNTH_WORDS_PER_CLASS
        ex = {}
        for key in task.sentence_keys:
            ln = rng.randint(4, 24)
            ids = ((bias + rng.randint(0, _SYNTH_WORDS_PER_CLASS, ln))
                   % len(vocab))
            noise = rng.randint(0, len(vocab), max(1, ln // 4))
            words = [vocab[t] for t in ids] + [vocab[t] for t in noise]
            ex[key] = " ".join(words)
        ex["label"] = label
        examples.append(ex)
    return examples


def _read_examples_file(path: str, task: GlueTask) -> List[Dict]:
    """One file -> [example dicts]. JSONL (keys = sentence keys + label)
    or TSV with a header row naming the same columns."""
    import csv
    import json

    examples: List[Dict] = []
    want = list(task.sentence_keys) + ["label"]
    if path.endswith(".jsonl") or path.endswith(".json"):
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    examples.append(json.loads(line))
    else:  # tsv
        with open(path, newline="") as f:
            for row in csv.DictReader(f, delimiter="\t",
                                      quoting=csv.QUOTE_NONE):
                examples.append({k: row[k] for k in want if k in row})
    out = []
    for ex in examples:
        label = ex.get("label")
        if label is not None:
            label = (float(label) if task.num_labels == 1
                     else int(label))
        out.append({**{k: ex.get(k, "") for k in task.sentence_keys},
                    "label": label})
    return out


def _load_from_files(task: GlueTask,
                     data_dir: str) -> Optional[Dict[str, List[Dict]]]:
    """``<data_dir>/<task>/<split>.{jsonl,tsv}`` -> split dict, or None
    when the directory has no files for this task."""
    base = os.path.join(data_dir, task.name)
    if not os.path.isdir(base):
        base = data_dir  # flat layout: files directly under data_dir

    def find(names):
        for n in names:
            for ext in (".jsonl", ".json", ".tsv"):
                p = os.path.join(base, n + ext)
                if os.path.exists(p):
                    return p
        return None

    train = find(["train"])
    val = find(["validation_matched", "dev_matched"]
               if task.name == "mnli" else ["validation", "dev"])
    if train is None or val is None:
        return None
    out = {"train": _read_examples_file(train, task),
           "validation": _read_examples_file(val, task)}
    if task.name == "mnli":
        mm = find(["validation_mismatched", "dev_mismatched"])
        if mm is not None:
            out["validation_mismatched"] = _read_examples_file(mm, task)
    return out


def load_task_data(task: GlueTask, data_dir: Optional[str] = None,
                   synthetic: bool = False, synthetic_sizes=(256, 128),
                   seed: int = 0) -> Dict[str, List[Dict]]:
    """``{split: [examples]}`` with splits ``train`` / ``validation`` (and
    ``validation_mismatched`` for MNLI).

    Priority, as in JAX: synthetic when asked -> the files under
    ``data_dir`` -> a local Hugging Face ``datasets`` cache
    (``datasets.load_dataset("glue", name)`` with ``HF_DATASETS_OFFLINE``
    defaulted to 1, so nothing is fetched) -> synthetic examples when that
    fails for any reason (``datasets`` missing, no cache)."""
    if data_dir is not None and not synthetic:
        loaded = _load_from_files(task, data_dir)
        if loaded is not None:
            return loaded
    if not synthetic:
        try:
            import datasets  # works offline only from a local cache

            os.environ.setdefault("HF_DATASETS_OFFLINE", "1")
            ds = datasets.load_dataset("glue", task.name)
            out = {"train": list(ds["train"])}
            if task.name == "mnli":
                out["validation"] = list(ds["validation_matched"])
                out["validation_mismatched"] = list(
                    ds["validation_mismatched"])
            else:
                out["validation"] = list(ds["validation"])
            return out
        except Exception:  # no datasets / no cache: synthetic, as JAX
            pass
    n_train, n_val = synthetic_sizes
    out = {"train": synthetic_examples(task, "train", n_train, seed),
           "validation": synthetic_examples(task, "validation", n_val, seed)}
    if task.name == "mnli":
        out["validation_mismatched"] = synthetic_examples(
            task, "validation_mismatched", n_val, seed)
    return out
