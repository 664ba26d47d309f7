"""Batch-serving daemon for transcription on one GPU.

Counterpart of ``olmoasr_tpu/serve.py``. ``BatchingService`` is the JAX
package's (a single worker thread collects concurrently submitted jobs into
dynamic batches, groups them by options and decodes each group as one batch
of 30 s windows); only its worker loop is the port's own, as it runs the
port's ``transcribe_many``. The option list, the query-string parser and the
queue sentinel are the JAX module's, which imports nothing of jax.

Two surfaces:

* Library: ``BatchingService(model).submit(audio, **options)`` -> Future.
* HTTP: ``python -m olmoasr_tpu_torch.serve --model ckpt.pt --port 8000`` --
  POST /v1/transcribe (audio file bytes, options as query parameters), GET
  /healthz. Standard library only (``http.server``); audio is decoded by the
  port's ``load_audio``. ``kv_quant`` is on unless ``--no-kv-quant``.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from typing import Any, Dict, List, Optional

from olmoasr_tpu import serve as _jax_serve
from olmoasr_tpu.serve import _SENTINEL, ALLOWED_OPTIONS, _parse_option  # noqa: F401

__all__ = ["ALLOWED_OPTIONS", "BatchingService", "make_handler", "serve", "main"]


class BatchingService(_jax_serve.BatchingService):
    """Dynamic batching around the port's ``transcribe_many``: the JAX
    package's service (``submit``, ``start``, ``stop``, the queue and its
    draining) with this worker loop."""

    def _run(self) -> None:
        from olmoasr_tpu_torch.transcribe import transcribe_many

        while True:
            jobs = self._collect()
            if not jobs:
                self._drain_queue(RuntimeError("BatchingService stopped"))
                return
            # different options cannot share a decode batch (filters, ladder)
            groups: Dict[str, List[int]] = {}
            for i, (_, opts, _) in enumerate(jobs):
                groups.setdefault(json.dumps(opts, sort_keys=True, default=repr), []).append(i)
            for idxs in groups.values():
                futs = [jobs[i][2] for i in idxs]
                try:
                    results = transcribe_many(
                        self.model, [jobs[i][0] for i in idxs],
                        batch_size=min(self.max_batch, len(idxs)), verbose=None,
                        **jobs[idxs[0]][1],
                    )
                    for f, r in zip(futs, results):
                        f.set_result(r)
                except Exception as e:  # noqa: BLE001 -- fail the whole group
                    for f in futs:
                        if not f.done():
                            f.set_exception(e)
                self.stats["batches"] += 1
                self.stats["batched_jobs"] += len(idxs)


def make_handler(service: BatchingService):
    from http.server import BaseHTTPRequestHandler
    from urllib.parse import parse_qsl, urlparse

    from olmoasr_tpu_torch.audio import load_audio

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (http.server API)
            if urlparse(self.path).path in ("/healthz", "/health"):
                self._send(200, {"ok": True, "stats": service.stats})
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):  # noqa: N802
            url = urlparse(self.path)
            if url.path != "/v1/transcribe":
                self._send(404, {"error": "not found"})
                return
            try:
                options = {k: _parse_option(k, v) for k, v in parse_qsl(url.query)}
                bad = set(options) - ALLOWED_OPTIONS
                if bad:
                    self._send(400, {"error": f"unknown options: {sorted(bad)}"})
                    return
                length = int(self.headers.get("Content-Length", 0))
                if length <= 0:
                    self._send(400, {"error": "empty body (audio bytes)"})
                    return
                data = self.rfile.read(length)
                suffix = os.path.splitext(self.headers.get("X-Filename", "audio.wav"))[1] or ".wav"
                with tempfile.NamedTemporaryFile(suffix=suffix) as tf:
                    tf.write(data)
                    tf.flush()
                    audio = load_audio(tf.name)
                self._send(200, service.submit(audio, **options).result())
            except Exception as e:  # noqa: BLE001 -- surface to the client
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, fmt, *args):  # quiet; stats via /healthz
            pass

    return Handler


def serve(service: BatchingService, host: str = "0.0.0.0", port: int = 8000):
    """The HTTP server, not yet serving (call ``serve_forever``), with the
    service started. Many requests wait on futures concurrently while the
    single worker batches them."""
    from http.server import ThreadingHTTPServer

    server = ThreadingHTTPServer((host, port), make_handler(service))
    service.start()
    return server


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser(description="OLMoASR GPU batch-serving daemon")
    p.add_argument("--model", required=True, help="local .pt or .npz checkpoint")
    p.add_argument("--device", default="cuda", help="torch device the model runs on")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000, help="0 picks a free port")
    p.add_argument("--max-batch", type=int, default=32)
    p.add_argument("--max-wait-ms", type=float, default=100.0)
    p.add_argument("--beam-size", type=int, default=None)
    p.add_argument("--no-kv-quant", action="store_true")
    args = p.parse_args(argv)

    from olmoasr_tpu_torch.api import load_model

    model = load_model(args.model, device=args.device)
    defaults: Dict[str, Any] = {"kv_quant": not args.no_kv_quant}
    if args.beam_size:
        defaults["beam_size"] = args.beam_size
    service = BatchingService(model, max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
                              default_options=defaults)
    server = serve(service, args.host, args.port)
    host, port = server.server_address[:2]
    print(f"serving {args.model} on {host}:{port} "
          f"(max_batch={args.max_batch}, max_wait={args.max_wait_ms}ms, {defaults})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        service.stop()


if __name__ == "__main__":
    main()
