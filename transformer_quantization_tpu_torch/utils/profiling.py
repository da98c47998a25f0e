"""Tracing and phase timing.

Counterpart of ``transformer_quantization_tpu/utils/profiling.py``:

- :func:`trace` — ``torch.profiler`` over the CPU and (when present) the
  card, written as a Chrome trace (``trace.json``, viewable in Perfetto or
  ``chrome://tracing``) into the given directory;
- :func:`annotate` — a named region in that trace
  (``torch.profiler.record_function``);
- :class:`PhaseTimer` — wall-clock per named phase (calibration, adaround,
  train, eval), each phase an annotated region, with the JAX package's
  report format. A phase's end waits for the card's queued work, so its
  time covers the kernels it launched.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch

from transformer_quantization_tpu_torch.utils.misc import sync_device

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """``torch.profiler`` trace of the enclosed code into
    ``<logdir>/trace.json`` when ``logdir`` is given; no-op otherwise."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def annotate(name: str):
    """Named region visible in profiler timelines."""
    return torch.profiler.record_function(name)


class PhaseTimer:
    """Accumulate wall-clock per named phase."""

    def __init__(self):
        self._totals: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            with annotate(name):
                yield
        finally:
            sync_device()
            dt = time.perf_counter() - t0
            self._totals[name] = self._totals.get(name, 0.0) + dt
            self._counts[name] = self._counts.get(name, 0) + 1

    def totals(self) -> Dict[str, float]:
        return dict(self._totals)

    def report(self) -> str:
        lines = [f"{k:24s} {v:8.2f}s  x{self._counts[k]}"
                 for k, v in sorted(self._totals.items(),
                                    key=lambda kv: -kv[1])]
        return "\n".join(lines)
