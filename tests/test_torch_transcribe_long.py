"""The port's long-form transcription against the JAX package's on the
CPU, end to end: ``transcribe`` and ``transcribe_many`` on 75 s and 41 s of
seeded audio through both packages with the same fp32 weights at
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

These are the slowest of the port's transcription tests, in a file of their
own so that ``--dist loadfile`` gives them a worker of their own; the copied
pieces and the command line are in ``tests/test_torch_transcribe.py``.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from olmoasr_tpu import transcribe as jtr
from olmoasr_tpu.api import OLMoASR as JaxOLMoASR
from olmoasr_tpu.models import whisper as jm
from olmoasr_tpu.models.dims import ModelDimensions
from olmoasr_tpu.tokenizer import get_tokenizer
from olmoasr_tpu_torch import decoding, transcribe_many
from olmoasr_tpu_torch.api import _new_model
from olmoasr_tpu_torch.models import whisper as tm
from olmoasr_tpu_torch.models.convert import state_dict_from_jax_params

TOK = get_tokenizer(False, language="en", task="transcribe")
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
