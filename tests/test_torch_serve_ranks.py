"""The server across ranks (``serve.BatchingService`` over a control group,
``serve.follow``, ``serve.main`` under torchrun) on CPU ``gloo`` ranks at
micro dims, against one process's service and the JAX package's.

The ranks are processes of ``tests/torch_dist_worker.py`` (torch and the
port only, no JAX): a ``file://`` rendezvous for the service, torchrun for
``serve.main``. The weights are ``PRNGKey(0)``'s, every decode is fp32 at
``SAMPLE_LEN`` tokens a window, and the tolerances are
``tests/test_torch_decoding_mesh.py``'s: tokens and text equal,
``no_speech_prob`` within 1e-5, ``avg_logprob`` within 1e-4. Rank 0 takes 6
requests at once in two option groups (greedy, 4 files; beam 2, 2 files:
each splits over the 2 ranks), then one with ``beam_size=abc``, which fails
on both ranks, then 2 more; rank 1 follows and returns on ``stop``.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import urllib.request

import jax
import numpy as np
import pytest
import scipy.io.wavfile as wavfile
import torch

from olmoasr_tpu.api import OLMoASR as JaxOLMoASR
from olmoasr_tpu.models import whisper as jm
from olmoasr_tpu.models.dims import ModelDimensions as JaxDims
from olmoasr_tpu.serve import BatchingService as JaxBatchingService
from olmoasr_tpu_torch import decoding
from olmoasr_tpu_torch.api import _new_model
from olmoasr_tpu_torch.models import convert
from olmoasr_tpu_torch.models.dims import ModelDimensions
from olmoasr_tpu_torch.serve import BatchingService, serve

MICRO = dict(n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=4, n_audio_layer=2,
             n_vocab=51864, n_text_ctx=448, n_text_state=64, n_text_head=4, n_text_layer=2)
SAMPLE_LEN = 12
NO_SPEECH_TOL, LOGPROB_TOL = 1e-5, 1e-4  # tests/test_torch_decoding_mesh.py's
EOT = 50256
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dist_worker.py")
GREEDY = dict(temperature=0.0, compression_ratio_threshold=None, logprob_threshold=None,
              no_speech_threshold=None, fp16=False)
BEAM = dict(GREEDY, beam_size=2)
BAD = dict(GREEDY, beam_size="abc")
SERVICE = dict(max_batch=8, max_wait_ms=1000, default_options={"sample_len": SAMPLE_LEN})


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, (REPO, env.get("PYTHONPATH"))))
    return env


@pytest.fixture(scope="module")
def params():
    return jm.init_params(jax.random.PRNGKey(0), JaxDims(**MICRO), include_padding_token=False)


@pytest.fixture(scope="module")
def state_dict(params):
    return convert.state_dict_from_jax_params(jax.tree.map(np.asarray, params),
                                              ModelDimensions(**MICRO))


@pytest.fixture(scope="module")
def model(state_dict):
    m = _new_model(ModelDimensions(**MICRO), False, "cpu", torch.float32)
    m.load_state_dict(state_dict)
    return m.eval()


@pytest.fixture(scope="module")
def rounds():
    """(audio, options) of each round: 6 files of 2-7 s seeded noise in two
    option groups, the bad option alone, then 2 more files."""
    rng = np.random.default_rng(11)
    wavs = [(rng.standard_normal(int(16000 * rng.uniform(2, 7))) * 0.1).astype(np.float32)
            for _ in range(9)]
    first = [(w, GREEDY) for w in wavs[:4]] + [(w, BEAM) for w in wavs[4:6]]
    return [first, [(wavs[6], BAD)], [(w, GREEDY) for w in wavs[7:]]]


@pytest.fixture(scope="module")
def two_ranks(state_dict, rounds, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve2")
    path = str(tmp / "serve.pt")
    torch.save({"kind": "serve", "dims": MICRO, "state_dict": state_dict, "rounds": rounds,
                "service": SERVICE}, path)
    procs = [subprocess.Popen([sys.executable, WORKER, path, str(r), "2", str(tmp / "rdzv")],
                              env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for r in range(2)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return [torch.load(f"{path}.out{r}", weights_only=False) for r in range(2)]


def _one_process(service, requests):
    with service:
        futures = [service.submit(audio, **options) for audio, options in requests]
        return [f.result(timeout=300) for f in futures]


def _assert_same(got: dict, want: dict):
    """Equal results but for the scores, which are within the tolerances."""
    assert got["text"] == want["text"] and got["language"] == want["language"]
    assert len(got["segments"]) == len(want["segments"])
    for g, w in zip(got["segments"], want["segments"]):
        assert abs(g["no_speech_prob"] - w["no_speech_prob"]) <= NO_SPEECH_TOL
        assert abs(g["avg_logprob"] - w["avg_logprob"]) <= LOGPROB_TOL
        scores = ("no_speech_prob", "avg_logprob")
        assert {k: v for k, v in g.items() if k not in scores} == \
            {k: v for k, v in w.items() if k not in scores}


def test_two_rank_service_matches_one_process_and_jax(two_ranks, model, params, rounds):
    """The 6 requests of the first round (two option groups, each split over
    the 2 ranks) answer as one process's service and the JAX package's
    ``BatchingService`` answer them."""
    got = two_ranks[0]["rounds"][0]
    assert [status for status, _ in got] == ["ok"] * 6
    want = _one_process(BatchingService(model, **SERVICE), rounds[0])
    jax_want = _one_process(JaxBatchingService(JaxOLMoASR(JaxDims(**MICRO), params), **SERVICE),
                            rounds[0])
    assert any(w["segments"] for w in want)
    for (_, g), w, j in zip(got, want, jax_want):
        _assert_same(g, w)
        _assert_same(g, j)


def test_follower_survives_a_bad_option_and_returns_on_stop(two_ranks, model, rounds):
    """``beam_size=abc`` fails its group's future on rank 0 and its batch on
    rank 1 with the same error; the next batch still answers, as one
    process's service does; rank 1's loop returns on ``stop``, having
    followed every batch; rank 0's stats count each batch once. Each rank
    gathered what the three split decodes gather."""
    rank0, rank1 = two_ranks
    (status, error), = rank0["rounds"][1]
    assert status == "error" and error.startswith("TypeError: "), error
    assert rank1["follow"] == {"batches": 4, "errors": [error]}
    # every group but the bad one's single window split over the ranks: one
    # decode each, 4 gathers (tokens, log-probs, no-speech, features)
    assert rank0["gathers"] == rank1["gathers"] == 3 * 4
    assert rank0["stats"] == {"requests": 9, "batches": 4, "batched_jobs": 9}
    want = _one_process(BatchingService(model, **SERVICE), rounds[2])
    assert [status for status, _ in rank0["rounds"][2]] == ["ok", "ok"]
    for (_, g), w in zip(rank0["rounds"][2], want):
        _assert_same(g, w)


def _post_all(port: int, wavs) -> list:
    answers = [None] * len(wavs)

    def post(k):
        with open(wavs[k], "rb") as f:
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/v1/transcribe?fp16=false&temperature=0",
                data=f.read(), method="POST", headers={"X-Filename": "req.wav"})
        with urllib.request.urlopen(req, timeout=300) as r:
            answers[k] = json.loads(r.read())

    threads = [threading.Thread(target=post, args=(k,)) for k in range(len(wavs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return answers


def _healthz(port: int) -> dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
        return json.loads(r.read())["stats"]


def test_serve_main_under_torchrun_answers_as_one_process(state_dict, tmp_path, monkeypatch):
    """``serve.main`` on 2 gloo ranks through torchrun (``--device cpu
    --port 0``; the token embedding's rows past the byte tokens zeroed, so
    that the text is not empty): rank 0 alone prints its listening line, 4
    concurrent requests (fp32, t=0) decode as one batch split over the
    ranks and answer as one process's server does, and on an interrupt to
    torchrun both ranks' ``main`` return."""
    from olmoasr_tpu_torch import load_model
    from olmoasr_tpu_torch import transcribe as tr

    sd = {k: v.clone() for k, v in state_dict.items()}
    sd["decoder.token_embedding.weight"][256:EOT] = 0.0
    ckpt = str(tmp_path / "micro.npz")
    convert.save_npz_checkpoint(ckpt, sd, ModelDimensions(**MICRO))
    rng = np.random.default_rng(12)
    wavs = []
    for k in range(4):
        wavs.append(str(tmp_path / f"req{k}.wav"))
        wavfile.write(wavs[-1], 16000, (rng.standard_normal(16000 * (3 + k)) * 3000)
                      .astype(np.int16))
    job = {"argv": ["--model", ckpt, "--device", "cpu", "--host", "127.0.0.1", "--port", "0",
                    "--max-wait-ms", "1000"],
           "sample_len": SAMPLE_LEN, "out": str(tmp_path / "returned")}
    proc = subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone",
                             "--nproc_per_node=2", WORKER, "serve", json.dumps(job)],
                            env=_env(), cwd=tmp_path, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("serving "):
                break
        assert lines and lines[-1].startswith("serving "), "".join(lines)
        port = int(line.split(" on ")[1].split()[0].rsplit(":", 1)[1])
        got = _post_all(port, wavs)
        stats = _healthz(port)
    finally:
        proc.send_signal(signal.SIGINT)
        lines += proc.communicate(timeout=120)[0].splitlines(keepends=True)
    log = "".join(lines)
    assert [line.startswith("serving ") for line in lines].count(True) == 1, log
    assert ", 2 ranks)" in log
    for r in range(2):
        assert os.path.exists(f"{job['out']}{r}"), log
    assert stats == {"requests": 4, "batches": 1, "batched_jobs": 4}

    monkeypatch.setattr(tr, "DecodingOptions", lambda **kw: decoding.DecodingOptions(
        **{**kw, "fp16": False, "sample_len": SAMPLE_LEN}))
    service = BatchingService(load_model(ckpt, device="cpu"), max_wait_ms=1000,
                              default_options={"kv_quant": True})
    server = serve(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        want = _post_all(server.server_address[1], wavs)
    finally:
        server.shutdown()
        server.server_close()
        service.stop()
    assert any(w["text"] for w in want)
    for g, w in zip(got, want):
        _assert_same(g, w)
