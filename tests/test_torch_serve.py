"""The port's serving layer (olmoasr_tpu_torch.serve) on the CPU with a
micro model: the batching service against direct ``transcribe_many``,
grouping by options, unknown options refused, ``stop`` failing queued jobs,
and the HTTP front end end to end on 127.0.0.1. Mirrors tests/test_serve.py.
"""

from __future__ import annotations

import json
import threading
import urllib.error
import urllib.request
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from olmoasr_tpu.models.dims import ModelDimensions
from olmoasr_tpu_torch import transcribe_many
from olmoasr_tpu_torch.api import _new_model
from olmoasr_tpu_torch.models.whisper import init_params
from olmoasr_tpu_torch.serve import _SENTINEL, BatchingService, serve

DIMS = ModelDimensions(
    n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=4, n_audio_layer=2,
    n_vocab=51864, n_text_ctx=448, n_text_state=64, n_text_head=4, n_text_layer=2,
)
OPTS = dict(
    temperature=0.0, compression_ratio_threshold=None, logprob_threshold=None,
    no_speech_threshold=None, without_timestamps=True, fp16=False,
)


@pytest.fixture(scope="module")
def model():
    return init_params(_new_model(DIMS, False, "cpu", torch.float32),
                       torch.Generator().manual_seed(0)).eval()


def _tone(seconds=2.0, hz=440.0):
    t = np.arange(int(16000 * seconds)) / 16000.0
    return (0.2 * np.sin(2 * np.pi * hz * t)).astype(np.float32)


def test_batching_service_matches_direct(model):
    wavs = [_tone(2.0, 300.0 + 100 * i) for i in range(4)]
    direct = transcribe_many(model, wavs, batch_size=4, verbose=None, **OPTS)
    with BatchingService(model, max_batch=4, max_wait_ms=200) as svc:
        futs = [svc.submit(w, **OPTS) for w in wavs]
        results = [f.result(timeout=300) for f in futs]
    for got, want in zip(results, direct):
        assert got == want
    # the four jobs ran as one dynamic batch (same options signature)
    assert svc.stats["batches"] >= 1 and svc.stats["batched_jobs"] == 4


def test_batching_service_groups_by_options(model):
    wavs = [_tone(1.0), _tone(1.0)]
    with BatchingService(model, max_batch=8, max_wait_ms=200) as svc:
        f1 = svc.submit(wavs[0], **OPTS)
        f2 = svc.submit(wavs[1], **{**OPTS, "beam_size": 2})
        r1, r2 = f1.result(timeout=300), f2.result(timeout=300)
    assert isinstance(r1["text"], str) and isinstance(r2["text"], str)
    assert r2 == transcribe_many(model, wavs[1:], batch_size=1, verbose=None,
                                 **{**OPTS, "beam_size": 2})[0]
    assert svc.stats["batches"] >= 2  # different options cannot share a batch


def test_submit_rejects_unknown_options(model):
    svc = BatchingService(model)
    with pytest.raises(ValueError, match="unknown decode options"):
        svc.submit(_tone(0.5), not_an_option=1)


def test_stop_rejects_submit_and_fails_queued(model):
    # after stop(): submit() raises instead of enqueueing into a dead worker,
    # and a job left in the queue gets its Future failed (never hangs)
    svc = BatchingService(model, max_batch=2, max_wait_ms=10)
    svc.stop()  # never started: stop must still close the service
    with pytest.raises(RuntimeError, match="stopped"):
        svc.submit(_tone(0.5), **OPTS)

    svc2 = BatchingService(model, max_batch=2, max_wait_ms=10)
    fut = Future()
    svc2._queue.put(_SENTINEL)  # a job racing stop(), queued behind the sentinel
    svc2._queue.put((_tone(0.5), dict(OPTS), fut))
    svc2.start()
    svc2.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        fut.result(timeout=30)


def test_http_server_end_to_end(model, tmp_path):
    import scipy.io.wavfile as wavfile

    wav = _tone(1.5)
    path = tmp_path / "tone.wav"
    wavfile.write(path, 16000, (wav * 32767).astype(np.int16))

    svc = BatchingService(model, max_batch=4, max_wait_ms=50, default_options=dict(OPTS))
    server = serve(svc, host="127.0.0.1", port=0)  # a free port
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
            assert json.loads(r.read())["ok"] is True

        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/transcribe?without_timestamps=true&beam_size=2",
            data=path.read_bytes(), method="POST", headers={"X-Filename": "tone.wav"},
        )
        with urllib.request.urlopen(req, timeout=600) as r:
            out = json.loads(r.read())
        assert set(out) == {"text", "segments", "language"}
        from olmoasr_tpu_torch.audio import load_audio

        want = transcribe_many(model, [load_audio(str(path))], batch_size=1, verbose=None,
                               **{**OPTS, "beam_size": 2})[0]
        assert out == json.loads(json.dumps(want))

        req = urllib.request.Request(  # unknown option -> 400
            f"http://127.0.0.1:{port}/v1/transcribe?bogus=1", data=b"x", method="POST",
        )
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=30)
        assert ei.value.code == 400
    finally:
        server.shutdown()
        server.server_close()
        svc.stop()


def test_main_parses_the_jax_servers_flags(tmp_path, monkeypatch):
    """``main`` loads the checkpoint on the given device, turns kv_quant on
    unless --no-kv-quant, and adds beam_size when given."""
    from olmoasr_tpu_torch import serve as serve_mod

    seen = {}

    class FakeServer:
        server_address = ("127.0.0.1", 12345)

        def serve_forever(self):
            raise KeyboardInterrupt

        def server_close(self):
            seen["closed"] = True

    def fake_serve(service, host, port):
        seen.update(service=service, host=host, port=port)
        return FakeServer()

    monkeypatch.setattr(serve_mod, "serve", fake_serve)
    monkeypatch.setattr("olmoasr_tpu_torch.api.load_model",
                        lambda path, device: seen.setdefault("load", (path, device)))
    serve_mod.main(["--model", "m.pt", "--device", "cpu", "--host", "127.0.0.1", "--port", "0",
                    "--beam-size", "5", "--max-batch", "4"])
    assert seen["load"] == ("m.pt", "cpu") and seen["closed"]
    assert seen["service"].default_options == {"kv_quant": True, "beam_size": 5}
    assert seen["service"].max_batch == 4 and (seen["host"], seen["port"]) == ("127.0.0.1", 0)
    serve_mod.main(["--model", "m.pt", "--no-kv-quant"])
    assert seen["service"].default_options == {"kv_quant": False}
