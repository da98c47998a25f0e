"""Misc utilities.

Counterpart of ``transformer_quantization_tpu/utils/misc.py``:
:func:`seed_all` (Python's, numpy's and torch's generators, the card's
too when one is present), parameter counts over the port's nested
parameter dicts, :class:`DotDict`, :class:`Stopwatch` (which waits for
the card's queued work before it reads the clock) and
:func:`tree_size_bytes`.
"""

from __future__ import annotations

import random
import time
from typing import Dict

import numpy as np
import torch


def seed_all(seed: int) -> None:
    """Seed ``random``, numpy and torch (every card's generator too, when
    CUDA is available). The port's own draws (init, dropout, the shuffle)
    take their generators from explicit seeds; this seeds the rest."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    if torch.cuda.is_available():
        torch.cuda.manual_seed_all(seed)


def tree_tensors(tree):
    """The tensors and arrays of a nested dict / list tree, in order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_tensors(v)]
    return [tree] if hasattr(tree, "shape") else []


def count_params(params) -> int:
    return sum(int(np.prod(x.shape)) for x in tree_tensors(params))


def count_embedding_params(params) -> int:
    return count_params(params.get("embeddings", {}))


class DotDict(dict):
    """Attribute-style dict.

    >>> d = DotDict(a=1)
    >>> d.a
    1
    """

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v

    def __delattr__(self, k):
        del self[k]


def sync_device() -> None:
    """Wait for the card's queued work, so a host clock reading covers it."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Stopwatch:
    """Wall-clock timer with start/stop accumulation; each reading first
    waits for the card's queued work (``torch.cuda.synchronize``) when the
    process has used a card.

    >>> s = Stopwatch()
    >>> with s:
    ...     pass
    >>> s.get_total_duration() >= 0
    True
    """

    def __init__(self):
        self._start = None
        self._total = 0.0

    def start(self):
        if self._start is None:
            sync_device()
            self._start = time.perf_counter()
        return self

    def stop(self):
        if self._start is not None:
            sync_device()
            self._total += time.perf_counter() - self._start
            self._start = None
        return self

    def reset(self):
        self._start, self._total = None, 0.0
        return self

    def get_total_duration(self) -> float:
        extra = 0.0
        if self._start is not None:
            sync_device()
            extra = time.perf_counter() - self._start
        return self._total + extra

    def format(self) -> str:
        return f"Elapsed time: {self.get_total_duration():.2f} sec"

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


def tree_size_bytes(tree) -> Dict[str, int]:
    """Total bytes per dtype (numpy's dtype names, as JAX reports them:
    ``float32``, ``int8``, ...) — storage accounting for packed weights."""
    out: Dict[str, int] = {}
    for x in tree_tensors(tree):
        if isinstance(x, torch.Tensor):
            name = str(x.dtype).replace("torch.", "")
            n = x.numel() * x.element_size()
        else:
            name, n = str(x.dtype), int(x.nbytes)
        out[name] = out.get(name, 0) + int(n)
    return out
