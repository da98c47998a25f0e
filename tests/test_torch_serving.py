"""The port's serving engine (``transformer_quantization_tpu_torch/
serving/engine.py``) on the CPU: bucketing, dynamic batching, metering,
the text interface, the fused transfer, admission control and the closed
loop, over a small W8A8 BERT on the full-handoff engine (the kernels'
plain versions run on the CPU). Mirrors ``tests/test_serving.py``; the
metrics snapshot has the JAX engine's keys. ``BucketGraphs`` needs a
CUDA device and ``ServeConfig.mesh`` is not ported: both raise.
"""

import threading

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from transformer_quantization_tpu.serving.engine import Metrics as JMetrics
from transformer_quantization_tpu_torch.models import bert as B
from transformer_quantization_tpu_torch.models import mobilebert as MB
from transformer_quantization_tpu_torch.models.registry import get_family
from transformer_quantization_tpu_torch.serving import (
    BucketGraphs,
    QueueFullError,
    ServeConfig,
    ServingEngine,
    unpack_batch,
)
from transformer_quantization_tpu_torch.serving.engine import _bucket
from transformer_quantization_tpu_torch.training import calibration as CAL
from transformer_quantization_tpu_torch.utils.data import SyntheticTokenizer

CFG = B.BertConfig(vocab_size=256, hidden_size=32, num_hidden_layers=2,
                   num_attention_heads=4, intermediate_size=64,
                   max_position_embeddings=64, num_labels=2)
SEQ_BUCKETS, BATCH_BUCKETS = (16, 32, 64), (1, 2, 4, 8)


@pytest.fixture(scope="module")
def model():
    """One W8A8 calibration and engine plan for the module, and its eager
    forward (the batch dict or the packed (3, B, S) array)."""
    params, qcfg, qstate = CAL.calibrated_bert(CFG, batch_size=4, seq=16,
                                               device="cpu")
    static, plan, int_params = B.build_bert_engine(params, CFG, qcfg, qstate,
                                                   device="cpu")

    def forward(batch):
        if not isinstance(batch, dict):
            batch = unpack_batch(batch)
        return B.bert_engine_apply(params, batch, CFG, qcfg, qstate, static,
                                   plan, int_params, device="cpu")["logits"]

    return forward


def _engine(forward, **kw):
    cfg = dict(max_batch=8, max_wait_ms=5.0, seq_buckets=SEQ_BUCKETS,
               batch_buckets=BATCH_BUCKETS)
    cfg.update(kw)
    return ServingEngine(forward, ServeConfig(**cfg),
                         tokenizer=SyntheticTokenizer(CFG.vocab_size),
                         device="cpu")


def _bucket_batch(rows, seq):
    """The (len(rows), seq) batch dict the engine assembles for ``rows``."""
    n = len(rows)
    ids = np.zeros((n, seq), np.int32)
    mask = np.zeros((n, seq), np.float32)
    for i, r in enumerate(rows):
        ids[i, :len(r)] = r
        mask[i, :len(r)] = 1.0
    return {"input_ids": torch.from_numpy(ids),
            "attention_mask": torch.from_numpy(mask),
            "token_type_ids": torch.zeros((n, seq), dtype=torch.int32)}


def test_bucket_rounding():
    assert _bucket(5, (16, 32)) == 16
    assert _bucket(16, (16, 32)) == 16
    assert _bucket(17, (16, 32)) == 32
    assert _bucket(100, (16, 32)) == 32  # clamps to the largest


def test_buckets_largest_first(model):
    eng = _engine(model, max_batch=4)
    shapes = eng.buckets()
    assert sorted(shapes) == sorted((b, s) for s in SEQ_BUCKETS
                                    for b in BATCH_BUCKETS if b <= 4)
    sizes = [b * s for b, s in shapes]
    assert sizes == sorted(sizes, reverse=True)


def test_single_request_matches_direct_forward(model):
    """One request's logits are the direct engine forward's at its bucket
    (B=1, S=16), bit for bit."""
    ids = np.random.RandomState(1).randint(4, 256, 10).astype(np.int32)
    with _engine(model) as eng:
        logits = eng.submit_ids(ids).result(timeout=120)
    want = model(_bucket_batch([ids], 16))[0].numpy()
    assert logits.shape == (CFG.num_labels,)
    np.testing.assert_array_equal(logits, want)


def test_batching_and_metrics(model):
    rng = np.random.RandomState(2)
    reqs = [rng.randint(4, 256, rng.randint(5, 30)).astype(np.int32)
            for _ in range(40)]
    with _engine(model) as eng:
        snap = eng.run_closed_loop(reqs, concurrency=16)
    assert set(snap) == set(JMetrics().snapshot())
    assert snap["requests"] == 40
    assert snap["tokens"] == sum(len(r) for r in reqs)
    assert snap["seq_per_sec"] > 0 and snap["tokens_per_sec"] > 0
    assert snap["batches"] < 40  # concurrency coalesced requests
    assert snap["avg_batch"] == 40 / snap["batches"]
    assert snap["latency_ms_p99"] >= snap["latency_ms_p50"] > 0


def test_text_interface(model):
    tok = SyntheticTokenizer(CFG.vocab_size)
    ids, types, mask = tok.encode_pair("the quick brown fox",
                                       "jumps over the dog", 64)
    n = int(sum(mask))
    with _engine(model) as eng:
        logits = eng.classify("the quick brown fox", "jumps over the dog")
        by_ids = eng.submit_ids(ids[:n], types[:n]).result(60)
    assert logits.shape == (CFG.num_labels,)
    assert np.all(np.isfinite(logits))
    np.testing.assert_array_equal(logits, by_ids)


def test_submit_text_needs_a_tokenizer(model):
    eng = ServingEngine(model, ServeConfig(), device="cpu")
    with pytest.raises(RuntimeError, match="tokenizer"):
        eng.submit_text("hello")


def test_fused_transfer_matches_dict_path(model):
    """The packed (3, B, S) transfer answers every request as the dict
    path does, bit for bit (one request at a time, so both see the same
    buckets)."""
    rng = np.random.RandomState(0)
    reqs = [rng.randint(3, 60, (rng.randint(4, 40),)).astype(np.int32)
            for _ in range(12)]
    with _engine(model, fused_transfer=True, pipeline_depth=3) as e2:
        fused = [e2.submit_ids(r).result(60) for r in reqs]
    with _engine(model) as e1:
        plain = [e1.submit_ids(r).result(60) for r in reqs]
    for a, b in zip(fused, plain):
        np.testing.assert_array_equal(a, b)


def test_overlong_input_truncates_at_ingress(model):
    ids = np.arange(4, 4 + 100, dtype=np.int32) % 256
    with _engine(model) as eng:
        logits = eng.submit_ids(ids).result(60)
        snap = eng.metrics.snapshot()
    assert snap["tokens"] == 64
    np.testing.assert_array_equal(
        logits, model(_bucket_batch([ids[:64]], 64))[0].numpy())


def test_queue_overflow_sheds_load():
    """With max_queue set and the scheduler not draining, submissions past
    the bound raise QueueFullError (the HTTP layer answers 503)."""
    eng = ServingEngine(lambda b: b["input_ids"],
                        ServeConfig(max_queue=2, seq_buckets=(16,)),
                        device="cpu")
    eng.submit_ids([1, 2, 3])
    eng.submit_ids([4, 5])
    with pytest.raises(QueueFullError):
        eng.submit_ids([6])


def test_forward_errors_reach_the_callers():
    def broken(batch):
        raise RuntimeError("capture failed")

    with ServingEngine(broken, ServeConfig(), device="cpu") as eng:
        fut = eng.submit_ids([5, 6, 7])
        with pytest.raises(RuntimeError, match="capture failed"):
            fut.result(30)


def test_closed_loop_64_requests(model):
    """64 requests at concurrency 16 over every seq bucket: each answered
    once, with the logits of the direct forward on that request alone
    within the engine tolerance (a batch's other rows do not move a row),
    and the stopped engine's threads gone."""
    rng = np.random.RandomState(3)
    reqs = [rng.randint(4, 256, rng.randint(8, 64)).astype(np.int32)
            for _ in range(64)]
    eng = _engine(model, fused_transfer=True, precompile=True)
    seen = []
    forward = eng.forward

    def recording(batch):
        seen.append(tuple(batch.shape))
        return forward(batch)

    eng.forward = recording
    with eng:
        warm = list(seen)
        futs = []
        sem = threading.Semaphore(16)
        for ids in reqs:
            sem.acquire()
            f = eng.submit_ids(ids)
            f.add_done_callback(lambda _f: sem.release())
            futs.append(f)
        got = [f.result(120) for f in futs]
        snap = eng.metrics.snapshot()
        thread = eng._thread
    assert not thread.is_alive()
    assert [tuple(s[1:]) for s in warm] == eng.buckets()
    served = seen[len(warm):]
    assert all(s[0] == 3 and (s[1], s[2]) in eng.buckets() for s in served)
    assert snap["requests"] == 64
    assert snap["tokens"] == sum(len(r) for r in reqs)
    for ids, lg in zip(reqs, got):
        want = model(_bucket_batch([ids], _bucket(len(ids), SEQ_BUCKETS)))
        np.testing.assert_allclose(lg, want[0].numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_run_closed_loop_64_requests(model):
    rng = np.random.RandomState(4)
    reqs = [rng.randint(4, 256, rng.randint(8, 64)).astype(np.int32)
            for _ in range(64)]
    with _engine(model, fused_transfer=True, pipeline_depth=5) as eng:
        snap = eng.run_closed_loop(reqs, concurrency=64)
    assert snap["requests"] == 64
    assert snap["tokens"] == sum(len(r) for r in reqs)
    assert 1 <= snap["avg_batch"] <= 8


def test_bucket_graphs_raise_on_the_cpu(model):
    with pytest.raises(ValueError, match="CUDA"):
        BucketGraphs(model, "cpu")


def test_bucket_graphs_raise_without_a_card(model):
    if torch.cuda.is_available():
        pytest.skip("a card is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="cuda"):
        BucketGraphs(model, "cuda")


def test_mesh_raises(model):
    with pytest.raises(NotImplementedError, match="item 9"):
        ServingEngine(model, ServeConfig(mesh=object()), device="cpu")


def test_engine_on_cuda_without_a_card_raises(model):
    if torch.cuda.is_available():
        pytest.skip("a card is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="cuda"):
        ServingEngine(model, ServeConfig())


class _HostReads(TorchDispatchMode):
    """Records the operators that read a tensor's value on the host
    (``.item()``, ``bool()``, ``float()``, data-dependent shapes)."""

    HOST = ("aten._local_scalar_dense", "aten.item", "aten.nonzero",
            "aten.masked_select", "aten.unique")

    def __init__(self):
        super().__init__()
        self.reads = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if str(func).startswith(self.HOST):
            self.reads.append(str(func))
        return func(*args, **(kwargs or {}))


def test_engine_forwards_read_nothing_on_the_host(model):
    """What ``BucketGraphs`` captures must be device work only: one
    served forward of each engine (BERT, MobileBERT's tiny preset) on a
    packed batch reads no tensor value on the host."""
    mcfg = MB.MobileBertConfig(**get_family("mobilebert").tiny_preset)
    mp, mq, ms = CAL.calibrated_mobilebert(mcfg, batch_size=2, seq=16,
                                           device="cpu")
    mstatic, mplan, mint = MB.build_mobilebert_engine(mp, mcfg, mq, ms,
                                                      device="cpu")
    packed = torch.zeros((3, 2, 32), dtype=torch.int32)
    packed[0, :, :20] = 7
    packed[1, :, :20] = 1
    for forward in (model, lambda b: MB.mobilebert_engine_apply(
            mp, unpack_batch(b), mcfg, mq, ms, mstatic, mplan, mint,
            device="cpu")["logits"]):
        with _HostReads() as probe:
            out = forward(packed)
        assert out.shape == (2, 2)
        assert probe.reads == []
