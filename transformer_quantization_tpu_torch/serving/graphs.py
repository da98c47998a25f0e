"""One CUDA graph per (batch, seq) bucket.

The port's counterpart of ``jax.jit``'s per-shape program cache, which the
JAX serving engine relies on (each bucket compiles once, then replays):
:class:`BucketGraphs` wraps an eager ``forward(batch) -> logits`` and, on
the first call at a batch shape,

1. runs ``forward`` eagerly on a side stream (the first launch builds and
   loads the kernels and fills any lazy state; capture is never a first
   launch);
2. allocates static input tensors of the batch's shapes;
3. captures one ``torch.cuda.CUDAGraph`` of ``forward`` on them, every
   bucket's graph in one shared memory pool.

Later calls copy the batch into the static inputs, replay the graph, and
return a copy of the static logits made on the same stream (the next
replay of any bucket may overwrite them). The forward must do device
work only: no host read of a device tensor and no tensor made from host
data. Capture runs in ``thread_local`` error mode, so a bucket captured
lazily on the serving scheduler's thread tolerates the resolver thread's
copies. A capture or replay error propagates; nothing falls back to the
eager forward. On the CPU the caller passes the eager forward itself.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Tuple, Union

import torch

from transformer_quantization_tpu_torch import resolve_device

Tensor = torch.Tensor
Batch = Union[Tensor, Dict[str, Tensor]]


def _key(batch: Batch) -> Tuple:
    if isinstance(batch, Tensor):
        return (tuple(batch.shape), batch.dtype)
    return tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(
        batch.items()))


def _static_copy(batch: Batch, device) -> Batch:
    if isinstance(batch, Tensor):
        return batch.to(device, copy=True)
    return {k: v.to(device, copy=True) for k, v in batch.items()}


def _copy_into(static: Batch, batch: Batch) -> None:
    if isinstance(static, Tensor):
        static.copy_(batch, non_blocking=True)
        return
    if static.keys() != batch.keys():
        raise KeyError(f"batch keys {sorted(batch)} != {sorted(static)}")
    for k, v in static.items():
        v.copy_(batch[k], non_blocking=True)


class BucketGraphs:
    """``forward`` replayed as one CUDA graph per batch shape on
    ``device`` (a CUDA device; raises for any other)."""

    def __init__(self, forward: Callable[[Batch], Tensor], device="cuda"):
        dev = resolve_device(device)
        if dev.type != "cuda":
            raise ValueError(
                f"BucketGraphs captures CUDA graphs and needs a CUDA device, "
                f"got {dev}; on the CPU serve the eager forward itself")
        self.forward = forward
        self.device = torch.device("cuda", dev.index if dev.index is not None
                                   else torch.cuda.current_device())
        self.graphs: Dict[Tuple, Tuple] = {}
        self._pool = None
        self._lock = threading.Lock()

    def capture(self, batch: Batch) -> Tuple:
        """(graph, static inputs, static logits) of ``batch``'s shape,
        captured now if it was not before."""
        key = _key(batch)
        with self._lock:
            if key in self.graphs:
                return self.graphs[key]
            static_in = _static_copy(batch, self.device)
            cur = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                self.forward(static_in)
            cur.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self._pool,
                                  capture_error_mode="thread_local"):
                static_out = self.forward(static_in)
            if self._pool is None:
                self._pool = graph.pool()
            self.graphs[key] = (graph, static_in, static_out)
            return self.graphs[key]

    def __call__(self, batch: Batch) -> Tensor:
        graph, static_in, static_out = self.capture(batch)
        _copy_into(static_in, batch)
        graph.replay()
        return static_out.clone()
