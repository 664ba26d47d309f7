"""The port's long-form transcription (olmoasr_tpu_torch.transcribe) against
the JAX package's, on the CPU.

The copied pieces are pinned to the originals by driving both with the same
inputs: ``_needs_fallback`` over a grid of results and thresholds,
``_decode_batch_with_fallback`` with one scripted fake model (the same
temperatures, pending rows and options at every rung), and ``_FileState``
with the same audio and scripted decode results (the same windows, seeks and
segments). Then the whole slice: ``transcribe`` and ``transcribe_many`` on
75 s of seeded audio through both packages with the same fp32 weights at
temperature 0 must give the same segments. As in test_torch_decoding.py the
test first shows that every greedy step's top-2 margin exceeds the logit
tolerance, so that identity is what the tolerance predicts. Scores
(avg_logprob, no_speech_prob, compression_ratio) are held to 1e-4. The same
holds with beam search (``beam_size=3, best_of=3``), the CLI's decode.

With ``word_timestamps`` (and the hallucination-silence heuristic) both
packages transcribe the same two files with their encoders at fp32 (the JAX
package's alignment encodes at its bf16 default otherwise): the same
segments, seeks and words, word times equal and probabilities within 1e-5.
Their model's token embedding keeps only the byte tokens' text rows (the
offline tokenizer decodes nothing else), so that its segments have words.

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
from olmoasr_tpu.api import OLMoASR as JaxOLMoASR
from olmoasr_tpu.models import whisper as jm
from olmoasr_tpu.models.dims import ModelDimensions
from olmoasr_tpu.tokenizer import get_tokenizer
from olmoasr_tpu_torch import decoding, transcribe_many
from olmoasr_tpu_torch import transcribe as tr
from olmoasr_tpu_torch.api import _new_model
from olmoasr_tpu_torch.models import whisper as tm
from olmoasr_tpu_torch.models.convert import state_dict_from_jax_params

TOK = get_tokenizer(False, language="en", task="transcribe")
TS = TOK.timestamp_begin
DIMS = ModelDimensions(
    n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=4, n_audio_layer=2,
    n_vocab=51864, n_text_ctx=448, n_text_state=64, n_text_head=4, n_text_layer=2,
)
# The two packages' logits differ by the port's encoder attention, which rounds
# p to bf16 as the TPU kernel does, and its torch STFT: the test measures that
# difference on every teacher-forced step and requires it below half of this,
# and every greedy choice to lead its runner-up by more than this (measured
# at AUDIO_SEED: logits 1.1e-4 apart at most, the smallest margin 3.2e-3).
LOGIT_TOL = 2e-3
SCORE_TOL = 1e-4
SAMPLE_LEN = 12
AUDIO_SEED = 6


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
# the slice: long-form transcription through both packages
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    params = jm.init_params(jax.random.PRNGKey(0), DIMS, include_padding_token=False)
    model = _new_model(DIMS, False, "cpu", torch.float32)
    model.load_state_dict(state_dict_from_jax_params(jax.tree.map(np.asarray, params), DIMS))
    return JaxOLMoASR(DIMS, params), model


@pytest.fixture(scope="module")
def audios():
    rng = np.random.default_rng(AUDIO_SEED)
    return [(rng.standard_normal(16000 * s) * 0.1).astype(np.float32) for s in (75, 41)]


def _assert_margins(params, model, calls):
    """Teacher-force every decoded window's tokens through both packages: at
    each greedy step the logits agree within LOGIT_TOL / 2 and the chosen
    token led the runner-up by more than LOGIT_TOL, so the choice cannot
    differ."""
    import jax.numpy as jnp

    jstep = jax.jit(jm.decode_step, static_argnums=1)
    for mel, options, results in calls:
        prompt = decoding._resolve_prompt(TOK, options)
        cfg = decoding.build_filter_config(TOK, options, len(prompt), DIMS.n_vocab)
        B = mel.shape[0]
        n = len(prompt) + SAMPLE_LEN
        cache = tm.init_cache(model, tm.encode_audio(model, mel), max_len=n)
        feats = jm.encode_audio(params, DIMS, jnp.asarray(mel.numpy()), compute_dtype=jnp.float32)
        jcache = jm.init_cache(params, DIMS, feats, max_len=n)
        step = torch.tensor([prompt] * B)
        ring = torch.full((B, SAMPLE_LEN), TOK.eot)
        for i in range(SAMPLE_LEN):
            logits = tm.decode_step(model, step, cache)[:, -1]
            want, jcache = jstep(params, DIMS, jnp.asarray(step.numpy(), jnp.int32), jcache)
            diff = (logits - torch.from_numpy(np.asarray(want)[:, -1])).abs().max()
            assert float(diff) < LOGIT_TOL / 2, (i, float(diff))
            filt = decoding.apply_filters(logits, ring, i, cfg)
            top2 = filt.topk(2, dim=-1).values
            for b, r in enumerate(results):
                if i <= len(r.tokens):
                    tok = r.tokens[i] if i < len(r.tokens) else TOK.eot
                    assert int(filt[b].argmax()) == tok
                    assert float(top2[b, 0] - top2[b, 1]) > LOGIT_TOL, (b, i)
                    ring[b, i] = tok
            step = ring[:, i:i + 1]


def _assert_same_transcripts(got, want):
    assert got["language"] == want["language"] and got["text"] == want["text"]
    assert len(got["segments"]) == len(want["segments"]) > 0
    for g, w in zip(got["segments"], want["segments"]):
        for key in ("id", "seek", "start", "end", "tokens", "text", "temperature"):
            assert g[key] == w[key], key
        for key in ("avg_logprob", "no_speech_prob", "compression_ratio"):
            assert abs(g[key] - w[key]) <= SCORE_TOL, key
    seeks = [s["seek"] for s in got["segments"]]
    assert seeks == sorted(seeks)


@pytest.mark.parametrize("many", [False, True])
def test_long_form_matches_jax(pair, audios, monkeypatch, many):
    jmodel, model = pair
    calls = []
    decode = model.decode

    def recording_decode(mel, options):
        out = decode(mel, options)
        calls.append((mel, options, out))
        return out

    monkeypatch.setattr(model, "decode", recording_decode)
    opts = dict(temperature=0.0, fp16=False, sample_len=SAMPLE_LEN)
    if many:
        got = transcribe_many(model, audios, batch_size=2, **opts)
        want = jtr.transcribe_many(jmodel, audios, batch_size=2, **opts)
    else:
        got = [model.transcribe(audios[0], **opts)]
        want = [jmodel.transcribe(audios[0], **opts)]
    assert len(calls) >= 3  # at least three windows of the 75 s file
    _assert_margins(jmodel.params, model, calls)
    for g, w in zip(got, want):
        _assert_same_transcripts(g, w)


def test_long_form_beam_search_matches_jax(pair, audios):
    """The CLI's decode, beam_size=3 at t=0 (best_of=3 would sample above
    it): both files through both packages. The gates are off, so every
    window is decided by the beam, which both packages compute alike."""
    jmodel, model = pair
    opts = dict(temperature=(0.0, 0.2), fp16=False, sample_len=SAMPLE_LEN, beam_size=3,
                best_of=3, compression_ratio_threshold=None, logprob_threshold=None)
    steps = tm.decode_step.single_steps
    got = transcribe_many(model, audios, batch_size=2, **opts)
    assert tm.decode_step.single_steps > steps
    want = jtr.transcribe_many(jmodel, audios, batch_size=2, **opts)
    for g, w in zip(got, want):
        _assert_same_transcripts(g, w)


@pytest.fixture
def jax_fp32_encoder(monkeypatch):
    """The JAX package's encoder at fp32 unless a caller says otherwise
    (its ``embed_audio``, which the alignment calls, passes nothing)."""
    orig = jm.encode_audio
    monkeypatch.setattr(jm, "encode_audio", lambda params, dims, mel, **kw: orig(
        params, dims, mel, **{"compute_dtype": jax.numpy.float32, **kw}))


@pytest.fixture(scope="module")
def byte_pair():
    """``pair``'s weights with the token embedding's text rows past the 256
    byte tokens zeroed: the offline tokenizer decodes only those bytes, so
    this random model's segments have text, and so words."""
    params = jm.init_params(jax.random.PRNGKey(0), DIMS, include_padding_token=False)
    params = jax.tree.map(np.asarray, params)
    params["decoder"]["token_embedding"] = params["decoder"]["token_embedding"].copy()
    params["decoder"]["token_embedding"][256:TOK.eot] = 0.0
    model = _new_model(DIMS, False, "cpu", torch.float32)
    model.load_state_dict(state_dict_from_jax_params(params, DIMS))
    return JaxOLMoASR(DIMS, jax.tree.map(jax.numpy.asarray, params)), model


@pytest.mark.parametrize("threshold", [None, 2.0])
def test_long_form_word_timestamps_match_jax(byte_pair, audios, jax_fp32_encoder, threshold):
    jmodel, model = byte_pair
    opts = dict(temperature=0.0, fp16=False, sample_len=SAMPLE_LEN, word_timestamps=True,
                hallucination_silence_threshold=threshold)
    files = [audios[1], audios[0][:16000 * 20]]
    got = transcribe_many(model, files, batch_size=2, **opts)
    want = jtr.transcribe_many(jmodel, files, batch_size=2, **opts)
    n_words = 0
    for g, w in zip(got, want):
        _assert_same_transcripts(g, w)
        for gs, ws in zip(g["segments"], w["segments"]):
            assert [(x["word"], x["start"], x["end"]) for x in gs["words"]] == \
                [(x["word"], x["start"], x["end"]) for x in ws["words"]]
            for x, y in zip(gs["words"], ws["words"]):
                assert abs(x["probability"] - y["probability"]) <= 1e-5
                assert gs["seek"] / 100 <= x["start"] <= x["end"] <= gs["seek"] / 100 + 30
            n_words += len(gs["words"])
    assert n_words >= (3 if threshold is None else 1)


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
