"""The port's HTTP server (``transformer_quantization_tpu_torch/serving/
server.py``) on the CPU, from checkpoints the JAX package wrote.

- BERT (2 layers, hidden 32) and MobileBERT (the registry's tiny preset)
  calibrated by JAX's ``prepare_quantized_model`` (W8A8 current-minmax)
  and written by JAX's ``save_checkpoint``; the same request ids served
  by JAX's ``build_engine_from_checkpoint`` and the port's give logits
  within rtol 1e-3 / atol 2e-3 (the engine tolerance of
  ``tests/test_engine.py``);
- HTTP through the port's ``serve``: /classify, /metrics and /healthz,
  400 on bad JSON or non-string text, 404, overlong input truncated,
  concurrent clients, 503 on a full queue (mirrors
  ``tests/test_server.py``);
- a tiny RoBERTa and ALBERT the port calibrated and wrote, served through
  the family's engine and answering exactly what its ``engine_apply``
  gives on the same batch;
- ``--bf16`` and a checkpoint without quant state against the JAX server;
  serving from an export raises, naming its ROADMAP item.
"""

import json
import socket
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformer_quantization_tpu.models import bert as JB
from transformer_quantization_tpu.models import mobilebert as JMB
from transformer_quantization_tpu.quant.qconfig import QuantDefaults
from transformer_quantization_tpu.quant.quantizers import QMethod
from transformer_quantization_tpu.quant.ranges import RangeMethod
from transformer_quantization_tpu.serving import ServeConfig as JServeConfig
from transformer_quantization_tpu.serving import server as JS
from transformer_quantization_tpu.training.calibration import (
    prepare_quantized_model,
)
from transformer_quantization_tpu.utils import checkpoint as JCK
from transformer_quantization_tpu_torch.models.registry import get_family
from transformer_quantization_tpu_torch.serving import ServeConfig
from transformer_quantization_tpu_torch.serving import server as TS
from transformer_quantization_tpu_torch.utils import checkpoint as TCK

CFG = JB.BertConfig(vocab_size=256, hidden_size=32, num_hidden_layers=2,
                    num_attention_heads=4, intermediate_size=64,
                    max_position_embeddings=64, num_labels=2)
MB_CFG = JMB.MobileBertConfig(num_labels=2,
                              **get_family("mobilebert").tiny_preset)
RTOL, ATOL = 1e-3, 2e-3
SERVE = dict(max_batch=4, max_wait_ms=2.0, seq_buckets=(16, 32),
             batch_buckets=(1, 2, 4))


def _defaults():
    return QuantDefaults(method=QMethod.symmetric_uniform,
                         act_method=QMethod.asymmetric_uniform, n_bits=8,
                         weight_range_method=RangeMethod.current_minmax,
                         act_range_method=RangeMethod.current_minmax)


def _jax_checkpoint(path, family, cfg) -> str:
    """JAX init, one-batch W8A8 calibration (each forward one jitted
    program: both servers read the ranges it writes), JAX
    ``save_checkpoint``."""
    init, declare, apply, tensors = {
        "bert": (JB.init_bert_params, JB.declare_bert_sites, JB.bert_apply,
                 JB.bert_weight_site_tensors),
        "mobilebert": (JMB.init_mobilebert_params,
                       JMB.declare_mobilebert_sites, JMB.mobilebert_apply,
                       JMB.mobilebert_weight_site_tensors)}[family]
    params = init(jax.random.PRNGKey(0), cfg)
    qcfg = declare(_defaults(), cfg)
    rng = np.random.RandomState(0)
    batch = {"input_ids": jnp.asarray(rng.randint(0, cfg.vocab_size,
                                                  (2, 16)), jnp.int32),
             "attention_mask": jnp.ones((2, 16), jnp.float32)}
    program = jax.jit(lambda p, b, qs, mode: apply(
        p, b, cfg, qcfg=qcfg, qstate=qs, mode=mode), static_argnames="mode")

    def jitted(p, b, qcfg=None, qstate=None, mode=None, mse_session=None):
        assert not mse_session   # current-minmax ranges: none
        return program(p, b, qstate, mode)

    qstate, _ = prepare_quantized_model(jitted, params, qcfg, [batch],
                                        weight_tensors=tensors(params))
    ckpt = str(path / family)
    JCK.save_checkpoint(ckpt, params=params, family=family, cfg=cfg,
                        qstate=qstate)
    return ckpt


@pytest.fixture(scope="module")
def bert_ckpt(tmp_path_factory):
    return _jax_checkpoint(tmp_path_factory.mktemp("ck"), "bert", CFG)


@pytest.fixture(scope="module")
def mobilebert_ckpt(tmp_path_factory):
    return _jax_checkpoint(tmp_path_factory.mktemp("ck"), "mobilebert",
                           MB_CFG)


def _requests(vocab, n, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(4, vocab, rng.randint(5, 31)).astype(np.int32)
            for _ in range(n)]


@pytest.mark.parametrize("family", ["bert", "mobilebert"])
def test_port_server_matches_jax_server(family, request):
    """The same checkpoint and request ids through both packages' servers
    (one request at a time: each at B = 1, S = 16 or 32, two JAX
    compiles); the logits agree within the engine tolerance."""
    ckpt = request.getfixturevalue(f"{family}_ckpt")
    vocab = CFG.vocab_size if family == "bert" else MB_CFG.vocab_size
    reqs = _requests(vocab, 6, seed=7)
    jeng = JS.build_engine_from_checkpoint(ckpt,
                                           serve_cfg=JServeConfig(**SERVE))
    teng = TS.build_engine_from_checkpoint(ckpt, device="cpu",
                                           serve_cfg=ServeConfig(**SERVE))
    with jeng:
        want = [np.asarray(jeng.submit_ids(r).result(300)) for r in reqs]
    with teng:
        got = [teng.submit_ids(r).result(60) for r in reqs]
    for w, g in zip(want, got):
        assert g.shape == w.shape == (2,)
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def test_checkpoint_serves_through_the_registry(bert_ckpt):
    """The port's server runs the registry's family on the port's own
    ``load_checkpoint`` of the JAX-written directory."""
    ck = TCK.load_checkpoint(bert_ckpt, device="cpu")
    assert ck["family"] == "bert" and "qstate" in ck
    eng = TS.build_engine_from_checkpoint(bert_ckpt, device="cpu")
    assert eng.device == torch.device("cpu")
    assert eng.tokenizer.vocab_size == CFG.vocab_size
    assert callable(eng.forward) and not hasattr(eng.forward, "graphs")


@pytest.mark.parametrize("family", ["roberta", "albert"])
def test_family_checkpoint_serves_its_engine(family, tmp_path):
    """A tiny RoBERTa / ALBERT calibrated by the port (W8A8 current-minmax)
    and written by its ``save_checkpoint`` is served by
    ``build_engine_from_checkpoint`` on the CPU (the plain versions): the
    forward, and each request alone through the queue (batch bucket 1),
    answer exactly what the family's ``engine_apply`` gives on the same
    batch."""
    from transformer_quantization_tpu_torch.models import registry as TR
    from transformer_quantization_tpu_torch.training import calibration as TC

    fam, cfg, params = TR.build_model(family, tiny=True, seed=2,
                                      device="cpu")
    qcfg = fam.declare_sites(TC.w8a8_defaults(), cfg)
    qstate, _ = TC.prepare_quantized_model(
        lambda p, b, **kw: fam.apply(p, b, cfg, **kw), params, qcfg,
        [TC.calibration_batch(cfg.vocab_size, 2, 32, 0)],
        weight_tensors=fam.weight_site_tensors(params), device="cpu")
    TCK.save_checkpoint(str(tmp_path), params=params, family=family, cfg=cfg,
                        qstate=qstate)
    ck = TCK.load_checkpoint(str(tmp_path), device="cpu")
    assert ck["family"] == family and ck["cfg"] == cfg
    static, plan, ip = fam.build_engine(ck["params"], cfg, qcfg, ck["qstate"],
                                        device="cpu")

    def engine(batch):
        return fam.engine_apply(ck["params"], batch, cfg, qcfg, ck["qstate"],
                                static, plan, ip, device="cpu")["logits"]

    eng = TS.build_engine_from_checkpoint(
        str(tmp_path), device="cpu",
        serve_cfg=ServeConfig(**dict(SERVE, max_batch=1,
                                     batch_buckets=(1,))))
    reqs = _requests(cfg.vocab_size, 4, seed=3)
    batch = {"input_ids": np.zeros((4, 32), np.int32),
             "attention_mask": np.zeros((4, 32), np.float32),
             "token_type_ids": np.zeros((4, 32), np.int32)}
    for i, r in enumerate(reqs):
        batch["input_ids"][i, :len(r)] = r
        batch["attention_mask"][i, :len(r)] = 1
    torch.testing.assert_close(eng.forward(batch), engine(batch), rtol=0,
                               atol=0)
    with eng:
        got = [eng.submit_ids(r).result(60) for r in reqs]
    for r, g in zip(reqs, got):
        s = 16 if len(r) <= 16 else 32
        one = {"input_ids": np.zeros((1, s), np.int32),
               "attention_mask": np.zeros((1, s), np.float32),
               "token_type_ids": np.zeros((1, s), np.int32)}
        one["input_ids"][0, :len(r)] = r
        one["attention_mask"][0, :len(r)] = 1
        np.testing.assert_array_equal(np.asarray(g), engine(one)[0].numpy())


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def http(bert_ckpt):
    """The port's ``serve`` in a thread on a free localhost port (20 ms
    batching window, so concurrent clients coalesce)."""
    eng = TS.build_engine_from_checkpoint(
        bert_ckpt, device="cpu",
        serve_cfg=ServeConfig(**dict(SERVE, max_wait_ms=20.0)))
    port = _free_port()
    ready = threading.Event()
    threading.Thread(target=TS.serve, args=(eng, port, ready, "127.0.0.1"),
                     daemon=True).start()
    assert ready.wait(timeout=60)
    return eng, port


def _post(port, payload: bytes, path="/classify", timeout=120):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=payload,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_classify_metrics_healthz(http):
    eng, port = http
    code, out = _post(port, json.dumps({"text": "hello world",
                                        "pair": "general"}).encode())
    assert code == 200 and len(out["logits"]) == 2
    np.testing.assert_array_equal(
        np.float32(out["logits"]), eng.classify("hello world", "general"))
    code, m = _get(port, "/metrics")
    assert code == 200 and m["requests"] >= 2
    assert _get(port, "/healthz") == (200, {"status": "ok"})
    assert _get(port, "/nope")[0] == 404


def test_http_error_handling(http):
    """Malformed JSON, a missing or non-string text -> 400; an unknown
    POST path -> 404; never a 500 for client mistakes."""
    _, port = http
    code, out = _post(port, b"{not json")
    assert code == 400 and "bad request" in out["error"]
    assert _post(port, json.dumps({"pair": "no text"}).encode())[0] == 400
    assert _post(port, json.dumps({"text": 42}).encode())[0] == 400
    assert _post(port, json.dumps({"text": "a", "pair": 1}).encode())[0] \
        == 400
    code, out = _post(port, json.dumps({"text": "ok"}).encode())
    assert code == 200 and len(out["logits"]) == 2
    assert _post(port, b"{}", path="/nope")[0] == 404


def test_http_overlong_input_truncates(http):
    """Inputs past the largest seq bucket truncate at ingress and still
    classify."""
    eng, port = http
    before = eng.metrics.snapshot()
    code, out = _post(port, json.dumps({"text": "word " * 500}).encode())
    assert code == 200 and all(np.isfinite(out["logits"]))
    after = eng.metrics.snapshot()
    assert after["tokens"] - before["tokens"] == 32


def test_http_concurrent_clients(http):
    """8 threads x 6 requests, all served, all finite, coalesced into
    batches of more than one on average."""
    eng, port = http
    before = eng.metrics.snapshot()
    results, errs = [], []

    def client(i):
        try:
            for j in range(6):
                results.append(_post(port, json.dumps(
                    {"text": f"client {i} request {j}"}).encode()))
        except Exception as e:  # reported below
            errs.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errs and not any(t.is_alive() for t in threads)
    assert len(results) == 48
    assert all(c == 200 and np.isfinite(o["logits"]).all()
               for c, o in results)
    after = eng.metrics.snapshot()
    assert after["requests"] - before["requests"] == 48
    assert after["batches"] - before["batches"] < 48


def test_http_full_queue_answers_503(bert_ckpt):
    """With the queue full (the engine not draining it), /classify answers
    503 at once."""
    eng = TS.build_engine_from_checkpoint(
        bert_ckpt, device="cpu",
        serve_cfg=ServeConfig(**dict(SERVE, max_queue=1)))
    eng.submit_ids([5, 6, 7])
    httpd = TS.make_server(eng, 0, "127.0.0.1")
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        code, out = _post(httpd.server_address[1],
                          json.dumps({"text": "shed me"}).encode())
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=30)
    assert code == 503 and "queue full" in out["error"]


def _served(eng, reqs):
    with eng:
        return [np.asarray(eng.submit_ids(r).result(300)) for r in reqs]


def test_unported_serving_paths_raise(bert_ckpt, tmp_path):
    """``--bf16`` (the engine at ``engine_dtype`` bfloat16) and a
    checkpoint without quant state (the generic fallback: the float model,
    its attention in bfloat16) serve in both packages, the port's answers
    within the tolerance of the JAX server's on the same checkpoint and
    requests (the engine's rtol 1e-3 / atol 2e-3; the fallback, float
    logits of scale ~7e-3 that both packages' bfloat16 attention give
    within 3e-9 here, rtol 1e-3 / atol 1e-5); serving from an export
    still raises."""
    # requests of 10 ids: one (1, 16) bucket, one JAX compile a server
    reqs = [np.arange(4, 14, dtype=np.int32) + 7 * i for i in range(3)]
    want = _served(JS.build_engine_from_checkpoint(
        bert_ckpt, bf16=True, serve_cfg=JServeConfig(**SERVE)), reqs)
    teng = TS.build_engine_from_checkpoint(bert_ckpt, device="cpu",
                                           bf16=True,
                                           serve_cfg=ServeConfig(**SERVE))
    assert teng.forward.route == "engine"
    for w, g in zip(want, _served(teng, reqs)):
        assert g.shape == w.shape == (2,)
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    with pytest.raises(NotImplementedError, match="export"):
        TS.build_engine_from_export(str(tmp_path))
    with pytest.raises(NotImplementedError, match="export"):
        TS.main(["--export-dir", str(tmp_path), "--device", "cpu"])
    # a checkpoint without quant state: JAX serves its generic path
    ck = JCK.load_checkpoint(bert_ckpt)
    bare = str(tmp_path / "bare")
    JCK.save_checkpoint(bare, params=ck["params"], family="bert",
                        cfg=ck["cfg"])
    want = _served(JS.build_engine_from_checkpoint(
        bare, serve_cfg=JServeConfig(**SERVE)), reqs)
    teng = TS.build_engine_from_checkpoint(bare, device="cpu",
                                           serve_cfg=ServeConfig(**SERVE))
    assert teng.forward.route == "generic"
    for w, g in zip(want, _served(teng, reqs)):
        assert g.shape == w.shape == (2,)
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-5)


def test_server_on_cuda_without_a_card_raises(bert_ckpt):
    if torch.cuda.is_available():
        pytest.skip("a card is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="cuda"):
        TS.build_engine_from_checkpoint(bert_ckpt)
