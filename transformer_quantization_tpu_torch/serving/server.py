"""HTTP serving front end over the dynamic-batching engine.

Counterpart of ``transformer_quantization_tpu/serving/server.py``. Minimal
stdlib server (no extra dependencies):

    POST /classify   {"text": "...", "pair": "...?"}  -> {"logits": [...]}
    GET  /metrics                                      -> engine metrics
    GET  /healthz                                      -> ok

Start from a checkpoint directory (the JAX package's format,
``utils/checkpoint.py``):

    python -m transformer_quantization_tpu_torch.serving.server \\
        --checkpoint DIR [--port 8080] [--vocab vocab.txt] [--device cuda|cpu]

Requests are tokenized (native C++ WordPiece when a vocab.txt is given,
else the synthetic word-hash tokenizer), enqueued, dynamically batched
onto (batch, seq) buckets, each one CUDA graph on the card, and answered
with the classification logits. The full-handoff int8 engine serves
(``--bf16``: its bfloat16 ``engine_dtype``); a checkpoint without quant
state or one the engine refuses serves the generic forward (bfloat16
attention, and bfloat16 activations with ``--bf16``), as the JAX server
does. ``--export-dir`` is not yet ported and raises.
"""

from __future__ import annotations

import argparse
import json
import threading
from concurrent.futures import TimeoutError as FutTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from transformer_quantization_tpu_torch import resolve_device
from transformer_quantization_tpu_torch.serving.engine import (
    QueueFullError,
    ServeConfig,
    ServingEngine,
    unpack_batch,
)


def build_engine_from_checkpoint(ckpt_dir: str, *, device="cuda",
                                 bf16: bool = False, tokenizer=None,
                                 serve_cfg: Optional[ServeConfig] = None
                                 ) -> ServingEngine:
    """Quantized int8 engine from a framework checkpoint directory, as the
    JAX server builds it: the family's full-handoff engine under the W8A8
    current-minmax sites the checkpoint was calibrated with (``bf16``:
    ``engine_dtype`` bfloat16); a checkpoint without quant state, or one
    the engine's plan refuses (:class:`~..ops.engine.EngineIncompatible`),
    serves the family's generic forward (``fam.apply`` on the packed int
    weights through the fused linear, ``compute_dtype`` bfloat16 with
    ``bf16``, the attention's float products in bfloat16). On the card
    each bucket is one CUDA graph (:class:`~.graphs.BucketGraphs`), on
    the CPU the eager forward serves. The forward takes the batch dict or
    the fused-transfer (3, B, S) array; :attr:`ServingEngine.forward`'s
    ``route`` says which route serves (``'engine'`` or ``'generic'``)."""
    import torch

    from transformer_quantization_tpu_torch.models.registry import get_family
    from transformer_quantization_tpu_torch.ops.engine import (
        EngineIncompatible,
    )
    from transformer_quantization_tpu_torch.training.calibration import (
        w8a8_defaults,
    )
    from transformer_quantization_tpu_torch.utils import checkpoint as CK
    from transformer_quantization_tpu_torch.utils.data import (
        SyntheticTokenizer,
    )

    dev = resolve_device(device)
    ck = CK.load_checkpoint(ckpt_dir, device=dev)
    fam = get_family(ck["family"])
    cfg, params = ck["cfg"], ck["params"]
    qstate = ck.get("qstate")
    cdt = torch.bfloat16 if bf16 else None
    qcfg = int_params = engine = None
    if qstate is not None:
        # the W8A8 recipe the checkpoint was calibrated with
        qcfg = fam.declare_sites(w8a8_defaults(), cfg)
        int_params = fam.build_int_params(params, qcfg, qstate, False)
        if fam.build_engine is not None:
            try:
                engine = fam.build_engine(params, cfg, qcfg, qstate,
                                          device=dev)
            except EngineIncompatible:
                engine = None

    if engine is not None:
        static, plan, e_int = engine

        def forward(batch):
            if not isinstance(batch, dict):
                batch = unpack_batch(batch)
            return fam.engine_apply(params, batch, cfg, qcfg, qstate, static,
                                    plan, e_int,
                                    engine_dtype=cdt or torch.float32,
                                    device=dev)["logits"]
    else:
        def forward(batch):
            if not isinstance(batch, dict):
                batch = unpack_batch(batch)
            out, _ = fam.apply(params, batch, cfg, qcfg, qstate,
                               int_params=int_params, fused_linear=True,
                               compute_dtype=cdt,
                               attention_dtype=torch.bfloat16, device=dev)
            return out["logits"]

    route = "engine" if engine is not None else "generic"
    if dev.type == "cuda":
        from transformer_quantization_tpu_torch.serving.graphs import (
            BucketGraphs,
        )

        forward = BucketGraphs(forward, dev)
    forward.route = route
    if tokenizer is None:
        tokenizer = SyntheticTokenizer(cfg.vocab_size)
    return ServingEngine(forward, serve_cfg or ServeConfig(),
                         tokenizer=tokenizer, device=dev)


def build_engine_from_export(export_dir: str, *, tokenizer=None,
                             serve_cfg: Optional[ServeConfig] = None
                             ) -> ServingEngine:
    """Serving from an exported artifact: not yet ported."""
    raise NotImplementedError(
        "serving from an export (serving/export.py) is not yet ported "
        "(ROADMAP §1 item 6: the torch.export artifact)")


def make_handler(engine: ServingEngine):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"status": "ok"})
            elif self.path == "/metrics":
                self._send(200, engine.metrics.snapshot())
            else:
                self._send(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/classify":
                self._send(404, {"error": "unknown path"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                text = req["text"]
                pair = req.get("pair")
                if not isinstance(text, str) or (
                        pair is not None and not isinstance(pair, str)):
                    raise TypeError("'text'/'pair' must be strings")
            except (json.JSONDecodeError, KeyError, TypeError,
                    UnicodeDecodeError, ValueError) as e:
                self._send(400, {"error": f"bad request: {e}"})
                return
            try:
                fut = engine.submit_text(text, pair)
            except QueueFullError as e:
                self._send(503, {"error": str(e)})
                return
            try:
                logits = fut.result(timeout=60)
                self._send(200, {"logits": [float(v) for v in logits]})
            except FutTimeout:
                self._send(504, {"error": "inference timed out"})
            except Exception as e:  # the forward's error, to the client
                self._send(500, {"error": str(e)})

        def log_message(self, *a):  # quiet
            pass

    return Handler


def make_server(engine: ServingEngine, port: int = 8080,
                host: str = "0.0.0.0") -> ThreadingHTTPServer:
    """The HTTP server of :func:`serve`, bound and not yet serving (port 0
    picks a free one: ``server_address[1]``); the caller starts
    ``engine`` and, when done, calls ``shutdown()`` and stops it."""
    return ThreadingHTTPServer((host, port), make_handler(engine))


def serve(engine: ServingEngine, port: int = 8080,
          ready_event: Optional[threading.Event] = None,
          host: str = "0.0.0.0"):
    """Start ``engine`` and answer HTTP on ``host:port`` for ever; stops
    the engine on the way out. ``ready_event`` is set once the socket
    listens."""
    engine.start()
    try:
        with make_server(engine, port, host) as httpd:
            if ready_event is not None:
                ready_event.set()
            httpd.serve_forever()
    finally:
        engine.stop()


def main(argv=None):
    ap = argparse.ArgumentParser()
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--checkpoint")
    src.add_argument("--export-dir",
                     help="serve an exported artifact (not yet ported)")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--vocab", default=None,
                    help="vocab.txt for the native WordPiece tokenizer")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    tok = None
    if args.vocab:
        from transformer_quantization_tpu_torch.utils.native import (
            WordPieceTokenizer,
        )

        tok = WordPieceTokenizer(args.vocab)
    if args.export_dir:
        eng = build_engine_from_export(args.export_dir, tokenizer=tok)
    else:
        eng = build_engine_from_checkpoint(args.checkpoint, bf16=args.bf16,
                                           tokenizer=tok, device=args.device)
    print(f"serving on :{args.port}", flush=True)
    serve(eng, args.port)


if __name__ == "__main__":
    main()
