"""Dynamic-batching inference engine.

Counterpart of ``transformer_quantization_tpu/serving/engine.py``:

- requests (token ids or raw text) enter a queue and are assembled into
  batches by a scheduler thread: sequences bucket to a length of
  ``seq_buckets``, batches fill up to ``max_batch`` or flush after
  ``max_wait_ms``, and the batch pads to a size of ``batch_buckets``, so
  the forward sees a fixed set of (batch, seq) shapes; on the card each
  shape is one captured CUDA graph (``serving/graphs.py``), the
  counterpart of the JAX engine's per-shape compiled programs
- the batch is assembled on the host and moved to the engine's device;
  with ``fused_transfer`` the ids, mask and type ids travel as one (3, B,
  S) int32 array, staged in pinned memory, in one ``non_blocking`` copy
- the forward runs on the scheduler thread's stream; a resolver thread
  waits for each batch's event, copies its logits to the host and
  answers the requests, so up to ``pipeline_depth`` batches are in flight
- per-request latency and aggregate throughput are metered.

BERT-class models are single-forward encoders, so "continuous batching"
means dynamic batching with strict shape bucketing. Serving over a mesh
(``ServeConfig.mesh``) is not yet ported (ROADMAP §1 item 9).
"""

from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from transformer_quantization_tpu_torch import resolve_device

Tensor = torch.Tensor
Batch = Union[Tensor, Dict[str, Tensor]]


@dataclasses.dataclass
class ServeConfig:
    max_batch: int = 32
    max_wait_ms: float = 2.0
    seq_buckets: Sequence[int] = (32, 64, 128)
    batch_buckets: Sequence[int] = (1, 2, 4, 8, 16, 32)
    precompile: bool = False  # warm (capture) every bucket at start-up
    # DP serving over a device mesh: not yet ported, must stay None
    mesh: object = None
    # pack ids/mask/type_ids into ONE (3, B, S) int32 host array so each
    # batch costs a single host->device transfer instead of three. The
    # forward must then accept the packed array (see unpack_batch).
    fused_transfer: bool = False
    # in-flight batches between the scheduler and the resolver
    pipeline_depth: int = 2
    # admission control: maximum queued (not yet scheduled) requests;
    # 0 = unbounded. When full, submit_* raises QueueFullError and the
    # HTTP front end answers 503.
    max_queue: int = 0


class QueueFullError(Exception):
    """Admission queue is full (ServeConfig.max_queue); shed the request."""


@dataclasses.dataclass
class _Request:
    ids: np.ndarray
    type_ids: Optional[np.ndarray]
    future: Future
    t_enqueue: float


class Metrics:
    def __init__(self):
        self.lock = threading.Lock()
        self.requests = 0
        self.tokens = 0
        self.batches = 0
        self.latencies: List[float] = []
        self.t0 = time.perf_counter()

    def record(self, n_req: int, n_tok: int, lats: List[float]):
        with self.lock:
            self.requests += n_req
            self.tokens += n_tok
            self.batches += 1
            self.latencies.extend(lats)

    def snapshot(self) -> Dict:
        with self.lock:
            dt = time.perf_counter() - self.t0
            lat = np.asarray(self.latencies) if self.latencies else np.zeros(1)
            return {
                "requests": self.requests,
                "tokens": self.tokens,
                "batches": self.batches,
                "wall_s": dt,
                "seq_per_sec": self.requests / dt if dt else 0.0,
                "tokens_per_sec": self.tokens / dt if dt else 0.0,
                "latency_ms_p50": float(np.percentile(lat, 50)) * 1e3,
                "latency_ms_p99": float(np.percentile(lat, 99)) * 1e3,
                "avg_batch": self.requests / max(self.batches, 1),
            }


def _bucket(value: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if value <= b:
            return b
    return buckets[-1]


def unpack_batch(packed: Tensor) -> Dict[str, Tensor]:
    """Split a fused-transfer (3, B, S) int32 tensor back into the model's
    batch dict (ServeConfig.fused_transfer); on the card call it inside
    the captured forward, where the split is part of the graph."""
    return {"input_ids": packed[0],
            "attention_mask": packed[1].to(torch.float32),
            "token_type_ids": packed[2]}


class _PinnedRing:
    """Pinned host buffers for the fused transfer, a ring per (B, S), each
    guarded by the event recorded after its copy: a buffer is rewritten
    only once the copy that read it has completed."""

    def __init__(self, slots: int):
        self.slots = slots
        self._rings: Dict[tuple, list] = {}
        self._next: Dict[tuple, int] = {}

    def reserve(self, shape) -> list:
        """The ring of ``shape``, its slots allocated now (a pinned
        allocation is slow and may synchronise: warm-up takes it)."""
        if shape not in self._rings:
            self._rings[shape] = [
                [torch.empty(shape, dtype=torch.int32, pin_memory=True),
                 None] for _ in range(self.slots)]
            self._next[shape] = 0
        return self._rings[shape]

    def take(self, shape) -> list:
        ring = self.reserve(shape)
        i = self._next[shape]
        self._next[shape] = (i + 1) % self.slots
        slot = ring[i]
        if slot[1] is not None:
            slot[1].synchronize()
        return slot


class ServingEngine:
    """Dynamic-batching executor over a quantized forward.

    ``forward(batch) -> logits`` takes a dict of ``input_ids`` /
    ``attention_mask`` / ``token_type_ids`` tensors on ``device`` (or the
    packed (3, B, S) tensor with ``fused_transfer``) at any bucketed shape;
    on the card it is a :class:`~.graphs.BucketGraphs` (one CUDA graph per
    shape) or any callable, as in the JAX engine.
    """

    def __init__(self, forward: Callable[[Batch], Tensor],
                 cfg: Optional[ServeConfig] = None, tokenizer=None,
                 device="cuda"):
        self.forward = forward
        self.cfg = cfg or ServeConfig()
        if self.cfg.mesh is not None:
            raise NotImplementedError(
                "serving over a device mesh (ServeConfig.mesh) is not yet "
                "ported (ROADMAP §1 item 9)")
        self.device = resolve_device(device)
        self.tokenizer = tokenizer
        self.metrics = Metrics()
        self._q: "queue.Queue[_Request]" = queue.Queue(
            maxsize=self.cfg.max_queue)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._cuda = self.device.type == "cuda"
        self._pinned = (_PinnedRing(max(self.cfg.pipeline_depth, 1) + 2)
                        if self._cuda and self.cfg.fused_transfer else None)

    # -- lifecycle ----------------------------------------------------------

    def start(self):
        if self.cfg.precompile:
            self.warmup()
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def buckets(self) -> List[tuple]:
        """Every served (batch, seq) bucket, largest first."""
        shapes = [(b, s) for s in self.cfg.seq_buckets
                  for b in self.cfg.batch_buckets if b <= self.cfg.max_batch]
        return sorted(shapes, key=lambda bs: bs[0] * bs[1], reverse=True)

    def warmup(self):
        """Run (on the card: capture) every (batch, seq) bucket up front,
        largest first, so captured graphs share one memory pool; with the
        fused transfer on the card, allocate each bucket's pinned staging
        buffers too."""
        for b, s in self.buckets():
            if self._pinned is not None:
                self._pinned.reserve((3, b, s))
            if self.cfg.fused_transfer:
                batch = torch.zeros((3, b, s), dtype=torch.int32,
                                    device=self.device)
            else:
                batch = {
                    "input_ids": torch.zeros((b, s), dtype=torch.int32,
                                             device=self.device),
                    "attention_mask": torch.zeros((b, s),
                                                  device=self.device),
                    "token_type_ids": torch.zeros((b, s), dtype=torch.int32,
                                                  device=self.device),
                }
            self.forward(batch)
        if self._cuda:
            torch.cuda.synchronize(self.device)

    # -- request ingress ----------------------------------------------------

    def submit_ids(self, ids: Sequence[int],
                   type_ids: Optional[Sequence[int]] = None) -> Future:
        fut: Future = Future()
        # overlong inputs truncate to the largest seq bucket at ingress,
        # where _assemble would clip them anyway; this keeps the queue
        # accounting and the token metric honest
        s_max = max(self.cfg.seq_buckets)
        ids = np.asarray(ids, np.int32)[:s_max]
        if type_ids is not None:
            type_ids = np.asarray(type_ids, np.int32)[:s_max]
        try:
            self._q.put_nowait(_Request(ids, type_ids, fut,
                                        time.perf_counter()))
        except queue.Full:
            raise QueueFullError(
                f"serving queue full ({self.cfg.max_queue} pending)")
        return fut

    def submit_text(self, a: str, b: Optional[str] = None,
                    max_len: Optional[int] = None) -> Future:
        if self.tokenizer is None:
            raise RuntimeError("engine built without tokenizer")
        if max_len is None:
            max_len = max(self.cfg.seq_buckets)
        ids, types, mask = self.tokenizer.encode_pair(a, b, max_len)
        n = int(np.sum(mask))
        return self.submit_ids(ids[:n], types[:n])

    def classify(self, a: str, b: Optional[str] = None,
                 timeout: float = 60.0) -> np.ndarray:
        return self.submit_text(a, b).result(timeout)

    # -- scheduler ----------------------------------------------------------

    def _drain(self) -> List[_Request]:
        """Collect up to max_batch requests, waiting at most max_wait_ms
        after the first arrival."""
        out: List[_Request] = []
        try:
            out.append(self._q.get(timeout=0.05))
        except queue.Empty:
            return out
        deadline = time.perf_counter() + self.cfg.max_wait_ms / 1e3
        while len(out) < self.cfg.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                out.append(self._q.get(timeout=remaining))
            except queue.Empty:
                break
        return out

    def _assemble(self, reqs: List[_Request]) -> Batch:
        """The requests as one bucketed batch on the engine's device."""
        max_len = max(len(r.ids) for r in reqs)
        S = _bucket(max_len, self.cfg.seq_buckets)
        Bq = _bucket(len(reqs), self.cfg.batch_buckets)
        if self.cfg.fused_transfer:
            slot = self._pinned.take((3, Bq, S)) if self._pinned else None
            packed = (slot[0].numpy() if slot is not None
                      else np.empty((3, Bq, S), np.int32))
            packed.fill(0)
            ids, mask, types = packed
        else:
            ids = np.zeros((Bq, S), np.int32)
            mask = np.zeros((Bq, S), np.float32)
            types = np.zeros((Bq, S), np.int32)
        for i, r in enumerate(reqs):
            n = min(len(r.ids), S)
            ids[i, :n] = r.ids[:n]
            mask[i, :n] = 1
            if r.type_ids is not None:
                types[i, :n] = r.type_ids[:n]
        if not self.cfg.fused_transfer:
            return {"input_ids": torch.from_numpy(ids).to(self.device),
                    "attention_mask": torch.from_numpy(mask).to(self.device),
                    "token_type_ids": torch.from_numpy(types).to(
                        self.device)}
        if slot is None:  # the CPU: the host array is the batch
            return torch.from_numpy(packed)
        out = slot[0].to(self.device, non_blocking=True)
        slot[1] = torch.cuda.Event()
        slot[1].record()
        return out

    def _loop(self):
        """Scheduler: assemble + dispatch on this thread's stream. The
        device->host copy completes on the resolver thread, so the next
        batch is already enqueued while the previous one runs."""
        inflight: "queue.Queue" = queue.Queue(
            maxsize=max(self.cfg.pipeline_depth, 1))
        resolver = threading.Thread(target=self._resolve_loop,
                                    args=(inflight,), daemon=True)
        resolver.start()
        on_stream = (torch.cuda.stream(torch.cuda.Stream(self.device))
                     if self._cuda else contextlib.nullcontext())
        try:
            with on_stream:
                while not self._stop.is_set():
                    reqs = self._drain()
                    if not reqs:
                        continue
                    try:
                        batch = self._assemble(reqs)
                        logits = self.forward(batch)
                        done = None
                        if self._cuda:
                            done = torch.cuda.Event()
                            done.record()
                        inflight.put((reqs, logits, done))
                    except Exception as e:  # surface errors to callers
                        for r in reqs:
                            if not r.future.done():
                                r.future.set_exception(e)
        finally:
            inflight.put(None)
            resolver.join(timeout=30)

    def _resolve_loop(self, inflight: "queue.Queue"):
        while True:
            item = inflight.get()
            if item is None:
                return
            reqs, logits, done = item
            try:
                if done is not None:
                    done.synchronize()
                arr = logits.detach().cpu().numpy()
                t_done = time.perf_counter()
                for i, r in enumerate(reqs):
                    r.future.set_result(arr[i])
                self.metrics.record(
                    len(reqs), int(sum(len(r.ids) for r in reqs)),
                    [t_done - r.t_enqueue for r in reqs])
            except Exception as e:
                for r in reqs:
                    if not r.future.done():
                        r.future.set_exception(e)

    # -- offline benchmark --------------------------------------------------

    def run_closed_loop(self, requests: List[np.ndarray],
                        concurrency: int = 64) -> Dict:
        """Feed a fixed request list with bounded in-flight concurrency;
        returns the metrics snapshot."""
        self.metrics = Metrics()  # exclude warm-up and captures
        sem = threading.Semaphore(concurrency)
        futures = []
        for ids in requests:
            sem.acquire()
            f = self.submit_ids(ids)
            f.add_done_callback(lambda _f: sem.release())
            futures.append(f)
        for f in futures:
            f.result(timeout=600)
        return self.metrics.snapshot()
