"""Batch-serving daemon for transcription on one GPU.

Counterpart of ``olmoasr_tpu/serve.py``, copied (the port imports nothing of
the JAX package; ``tests/test_torch_copies.py`` pins the option list and the
query-string parser to the originals). A single worker thread collects
concurrently submitted jobs into dynamic batches, groups them by options and
decodes each group as one batch of 30 s windows through the port's
``transcribe_many``.

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
import queue
import tempfile
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

__all__ = ["ALLOWED_OPTIONS", "BatchingService", "make_handler", "serve", "main"]

_SENTINEL = object()

# options forwarded to transcribe_many; everything else is rejected so typos
# fail loudly instead of silently decoding with defaults
ALLOWED_OPTIONS = {
    "temperature", "compression_ratio_threshold", "logprob_threshold",
    "no_speech_threshold", "condition_on_previous_text", "initial_prompt",
    "word_timestamps", "clip_timestamps", "hallucination_silence_threshold",
    "language", "task", "beam_size", "best_of", "patience", "length_penalty",
    "without_timestamps", "fp16", "kv_quant",
}


class BatchingService:
    """Dynamic batching around ``transcribe_many``.

    ``submit`` enqueues a job and returns a ``concurrent.futures.Future``.
    A single worker thread drains the queue: it waits up to ``max_wait_ms``
    for up to ``max_batch`` jobs, groups them by decode-options signature,
    and decodes each group as one batch. One worker = one GPU owner; kernel
    launches stay single-threaded by construction.
    """

    def __init__(
        self,
        model,
        *,
        max_batch: int = 32,
        max_wait_ms: float = 100.0,
        default_options: Optional[Dict[str, Any]] = None,
    ):
        self.model = model
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self.default_options = dict(default_options or {})
        self._queue: "queue.Queue" = queue.Queue()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._started = False
        self._closed = False
        self._lock = threading.Lock()
        self.stats = {"requests": 0, "batches": 0, "batched_jobs": 0}

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "BatchingService":
        with self._lock:
            if not self._started:
                self._worker.start()
                self._started = True
        return self

    def stop(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        if self._started:
            self._queue.put(_SENTINEL)
            self._worker.join(timeout=30)
        # jobs enqueued behind the sentinel (or while the worker was dying)
        # would otherwise hang their callers in .result() forever
        self._drain_queue(RuntimeError("BatchingService stopped"))

    def _drain_queue(self, exc: Exception) -> None:
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                return
            if item is _SENTINEL:
                continue
            fut = item[2]
            if not fut.done():
                fut.set_exception(exc)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- API ----------------------------------------------------------------

    def submit(
        self, audio: Union[str, np.ndarray], **options
    ) -> "Future":
        """Enqueue one transcription; returns a Future of the result dict."""
        bad = set(options) - ALLOWED_OPTIONS
        if bad:
            raise ValueError(f"unknown decode options: {sorted(bad)}")
        if self._closed:
            raise RuntimeError("BatchingService stopped; submit() rejected")
        fut: "Future" = Future()
        merged = {**self.default_options, **options}
        self._queue.put((audio, merged, fut))
        self.stats["requests"] += 1
        if not self._started:
            self.start()
        return fut

    def transcribe(self, audio, **options) -> dict:
        """Blocking convenience wrapper."""
        return self.submit(audio, **options).result()

    # -- worker -------------------------------------------------------------

    def _collect(self) -> List[Tuple]:
        """Block for one job, then gather more until max_batch/max_wait."""
        first = self._queue.get()
        if first is _SENTINEL:
            return []
        jobs = [first]
        deadline = time.monotonic() + self.max_wait_ms / 1e3
        while len(jobs) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                item = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if item is _SENTINEL:
                self._queue.put(_SENTINEL)  # re-post for the outer loop
                break
            jobs.append(item)
        return jobs

    def _run(self) -> None:
        from olmoasr_tpu_torch.transcribe import transcribe_many

        while True:
            jobs = self._collect()
            if not jobs:
                self._drain_queue(RuntimeError("BatchingService stopped"))
                return
            # group by options signature: different options cannot share a
            # decode batch (different filter configs / fallback ladders)
            groups: Dict[str, List[int]] = {}
            for i, (_, opts, _) in enumerate(jobs):
                key = json.dumps(opts, sort_keys=True, default=repr)
                groups.setdefault(key, []).append(i)
            for idxs in groups.values():
                audios = [jobs[i][0] for i in idxs]
                opts = jobs[idxs[0]][1]
                futs = [jobs[i][2] for i in idxs]
                try:
                    results = transcribe_many(
                        self.model, audios,
                        batch_size=min(self.max_batch, len(audios)),
                        verbose=None, **opts,
                    )
                    for f, r in zip(futs, results):
                        f.set_result(r)
                except Exception as e:  # noqa: BLE001 — fail the whole group
                    for f in futs:
                        if not f.done():
                            f.set_exception(e)
                self.stats["batches"] += 1
                self.stats["batched_jobs"] += len(idxs)



def _parse_option(key: str, raw: str):
    """Query-param string -> typed option value."""
    low = raw.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("none", "null"):
        return None
    try:
        return int(raw)
    except ValueError:
        pass
    try:
        return float(raw)
    except ValueError:
        pass
    if key == "temperature" and "," in raw:
        return tuple(float(t) for t in raw.split(","))
    return raw


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
    p.add_argument("--model", default="small.en", help="released name or ckpt path")
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
