"""The port's long-form transcription (olmoasr_tpu_torch.transcribe) against
the JAX package's, on the CPU: the copied pieces and the command line.

The copied pieces are pinned to the originals by driving both with the same
inputs: ``_needs_fallback`` over a grid of results and thresholds,
``_decode_batch_with_fallback`` with one scripted fake model (the same
temperatures, pending rows and options at every rung), and ``_FileState``
with the same audio and scripted decode results (the same windows, seeks and
segments). The whole slice through both packages (``transcribe`` and
``transcribe_many`` with the same fp32 weights, beam search, word
timestamps) is in ``tests/test_torch_transcribe_long.py``.

The command line (``python -m olmoasr_tpu_torch.transcribe``) takes the JAX
CLI's arguments and defaults plus ``--device``, and writes what the port's
``transcribe_many`` returns through the shared writers.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

from olmoasr_tpu import decoding as jdec
from olmoasr_tpu import transcribe as jtr
from olmoasr_tpu.models import whisper as jm
from olmoasr_tpu.models.dims import ModelDimensions
from olmoasr_tpu.tokenizer import get_tokenizer
from olmoasr_tpu_torch import decoding, transcribe_many
from olmoasr_tpu_torch import transcribe as tr

TOK = get_tokenizer(False, language="en", task="transcribe")
TS = TOK.timestamp_begin
DIMS = ModelDimensions(
    n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=4, n_audio_layer=2,
    n_vocab=51864, n_text_ctx=448, n_text_state=64, n_text_head=4, n_text_layer=2,
)


# ---------------------------------------------------------------------------
# copies pinned against the originals
# ---------------------------------------------------------------------------


def _results(cls, **fields):
    return cls(**{"tokens": [], "text": "", **fields})


@pytest.mark.parametrize("thresholds", [(2.4, -1.0, 0.6), (None, -1.0, 0.6), (2.4, None, 0.6),
                                        (2.4, -1.0, None), (None, None, None)])
def test_needs_fallback_matches(thresholds):
    for cr in (0.5, 2.4, 3.0):
        for lp in (-2.0, -1.0, -0.5):
            for ns in (0.1, 0.6, 0.9):
                f = dict(compression_ratio=cr, avg_logprob=lp, no_speech_prob=ns)
                assert tr._needs_fallback(_results(decoding.DecodingResult, **f), *thresholds) \
                    == jtr._needs_fallback(_results(jdec.DecodingResult, **f), *thresholds)


class _ScriptedModel:
    """Window i (its mel is filled with i) at temperature t passes the gates
    when (i + 10 t) % 3 == 0, window 6 never; records each decode call."""

    def __init__(self, result_cls, to_numpy):
        self.result_cls, self.to_numpy, self.calls = result_cls, to_numpy, []

    def decode(self, batch, options):
        ids = [int(v) for v in self.to_numpy(batch)[:, 0, 0]]
        fields = dataclasses.asdict(options)
        self.calls.append((options.temperature, ids, fields))
        t = options.temperature
        passes = lambda i: (i + round(10 * t)) % 3 == 0 and i != 6
        return [_results(self.result_cls, avg_logprob=-0.5 if passes(i) else -2.0,
                         compression_ratio=1.0, no_speech_prob=0.1, temperature=t, tokens=[i])
                for i in ids]


@pytest.mark.parametrize("temperatures", [[0.0], [0.0, 0.2, 0.4, 0.6, 0.8, 1.0], [0.4, 1.0]])
def test_decode_batch_with_fallback_matches(temperatures):
    n = 7
    windows = [np.full((80, 3000), i, np.float32) for i in range(n)]
    opts = dict(language="en", beam_size=5, best_of=5, patience=None, fp16=False)
    gates = dict(compression_ratio_threshold=2.4, logprob_threshold=-1.0, no_speech_threshold=0.6)
    jmodel = _ScriptedModel(jdec.DecodingResult, np.asarray)
    want = jtr._decode_batch_with_fallback(jmodel, windows, temperatures, dict(opts), **gates)
    tmodel = _ScriptedModel(decoding.DecodingResult, lambda t: t.numpy())
    got = tr._decode_batch_with_fallback(tmodel, [torch.from_numpy(w) for w in windows],
                                         temperatures, dict(opts), **gates)
    assert tmodel.calls == jmodel.calls
    assert [c[0] for c in tmodel.calls] == temperatures  # window 6 climbs the whole ladder
    assert [(r.tokens, r.temperature) for r in got] == [(r.tokens, r.temperature) for r in want]


def _scripted_results():
    """Token sequences that take every branch of the segmentation."""
    return [
        [TS + 0, 11, 12, TS + 50, TS + 60, 13, TS + 100, 14],  # pairs, unfinished tail
        [TS + 0, 21, TS + 40, TS + 40, 22, TS + 90],  # pairs, single timestamp ending
        [31, 32, TS + 700],  # no pair, a final timestamp
        [41, 42, 43],  # no timestamps at all
        [],  # nothing decoded
        [TS + 3, TS + 3],  # an instantaneous segment, cleared
    ]


@pytest.mark.parametrize("clip,prompt,no_speech", [("0", None, 0.6), ("5,20,40", "hello", None),
                                                   ("0", None, 0.05)])
def test_file_state_matches(clip, prompt, no_speech):
    wav = (np.random.default_rng(0).standard_normal(16000 * 75) * 0.1).astype(np.float32)
    stub = types.SimpleNamespace(dims=DIMS, device=torch.device("cpu"))
    common = dict(verbose=False, logprob_threshold=-1.0, no_speech_threshold=no_speech,
                  condition_on_previous_text=True, initial_prompt=prompt,
                  clip_timestamps=clip, language="en", word_timestamps=False,
                  prepend_punctuations="", append_punctuations="",
                  hallucination_silence_threshold=None)
    jstate = jtr._FileState(stub, wav, TOK, compression_ratio_threshold=2.4, **common)
    tstate = tr._FileState(stub, wav, TOK, **common)
    scripted = _scripted_results()
    for k in range(20):
        want, got = jstate.current_window(), tstate.current_window()
        if want is None:
            assert got is None and tstate.done and jstate.done
            break
        assert got.shape == (80, 3000) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
        fields = dict(tokens=scripted[k % len(scripted)], avg_logprob=-0.5 - 0.1 * k,
                      no_speech_prob=0.1 * (k % 3), temperature=0.2 * (k % 2),
                      compression_ratio=1.5, text="")
        jstate.consume(jdec.DecodingResult(**fields))
        tstate.consume(decoding.DecodingResult(**fields))
        assert tstate.seek == jstate.seek
    else:
        pytest.fail("the file never ended")
    assert k >= 3
    assert tstate.finalize() == jstate.finalize()
    assert tstate.prompt_reset_since == jstate.prompt_reset_since


def _jax_word_anomaly_score():
    """The JAX package's ``word_anomaly_score``, a closure-free function
    nested in ``_FileState.consume``, rebuilt from its code object."""
    code = next(c for c in jtr._FileState.consume.__code__.co_consts
                if getattr(c, "co_name", None) == "word_anomaly_score")
    return types.FunctionType(code, {})


def test_word_anomaly_score_matches():
    want = _jax_word_anomaly_score()
    for prob in (None, 0.0, 0.1499, 0.15, 0.9):
        for start, end in ((0.0, 0.0), (1.0, 1.05), (1.0, 1.133), (1.0, 1.2), (0.5, 2.5),
                           (0.5, 2.6), (0.0, 7.25)):
            word = {"word": " x", "start": start, "end": end}
            if prob is not None:
                word["probability"] = prob
            assert tr.word_anomaly_score(word) == want(word), word


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _help(module: str) -> str:
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, "-m", module, "--help"], capture_output=True,
                          text=True, cwd=REPO, env=env, timeout=300, check=True)
    return " ".join(proc.stdout.split())


def test_cli_arguments_and_defaults_are_the_jax_clis():
    """The two --help texts agree word for word once the port's --device
    (its usage entry and its line) is taken out."""
    port, orig = _help("olmoasr_tpu_torch.transcribe"), _help("olmoasr_tpu.transcribe")
    device = "--device DEVICE torch device the model runs on (default: cuda)"
    assert device in port and "[--device DEVICE]" in port
    assert port.replace(" " + device, "").replace(" [--device DEVICE]", "") == orig


@pytest.fixture
def one_thread():
    """One intra-op thread for the test: its bf16 CPU decode gains little
    from more (alone, 35 s at 8 threads and 48 s at 1), and at 8 it stalls
    where the suite's workers share the host's cores (671 s)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_cli_writes_what_transcribe_many_returns(tmp_path, monkeypatch, one_thread):
    """The CLI on two short wavs and a micro .npz written by the JAX package:
    the five writer outputs for each, and JSON equal to the port's own
    transcribe_many with the same arguments (bf16, beam_size=5 and best_of=5,
    a two-rung ladder)."""
    import scipy.io.wavfile as wavfile

    from olmoasr_tpu.models.convert import save_npz_checkpoint
    from olmoasr_tpu_torch import load_model

    ckpt = str(tmp_path / "micro.npz")
    save_npz_checkpoint(ckpt, jm.init_params(jax.random.PRNGKey(1), DIMS), DIMS)
    rng = np.random.default_rng(8)
    wavs = []
    for name, seconds in (("a", 3), ("b", 5)):
        path = str(tmp_path / f"{name}.wav")
        wavfile.write(path, 16000, (rng.standard_normal(16000 * seconds) * 3000).astype(np.int16))
        wavs.append(path)
    out = tmp_path / "out"
    monkeypatch.setattr(sys, "argv", [
        "transcribe", *wavs, "--model", ckpt, "-o", str(out), "--device", "cpu",
        "--batch_size", "2", "--temperature_increment_on_fallback", "1.0", "--verbose", "False",
    ])
    tr.cli()
    assert sorted(os.listdir(out)) == sorted(f"{n}.{ext}" for n in ("a", "b")
                                             for ext in ("txt", "vtt", "srt", "tsv", "json"))
    want = transcribe_many(load_model(ckpt, device="cpu"), wavs, batch_size=2,
                           temperature=(0.0, 1.0), verbose=False, beam_size=5, best_of=5)
    for name, w in zip(("a", "b"), want):
        with open(out / f"{name}.json", encoding="utf-8") as f:
            got = json.load(f)
        assert got == json.loads(json.dumps(w))
        assert set(got) == {"text", "segments", "language"} and got["segments"]
        for seg in got["segments"]:
            assert {"id", "seek", "start", "end", "text", "tokens", "temperature",
                    "avg_logprob", "compression_ratio", "no_speech_prob"} <= set(seg)
