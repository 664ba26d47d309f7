"""The port's word-level timestamps (olmoasr_tpu_torch.timing and
``models.whisper.cross_attention_weights``) against the JAX package's, on
the CPU at micro dims (2 + 2 layers, width 64, 1500 audio positions, fp32).

The host-side copies must agree bit for bit: ``median_filter`` and ``dtw``
on seeded matrices, ``merge_punctuations`` on word lists that take each of
its branches. ``cross_attention_weights`` on the same tokens and audio
features agrees to 1e-5. Then ``find_alignment`` and
``add_word_timestamps`` from the same mel: equal words, tokens and times,
probabilities within 1e-5.

The JAX package's ``embed_audio`` encodes at its default compute dtype,
bf16; the tests give its ``encode_audio`` fp32 as that default, so that both
packages run the path at fp32 (the port runs in its weights' dtype). The
port's encoder and ``decode_train`` round the attention's P to bf16 as the
TPU kernels do and the JAX model on the CPU does not: the features end
about 1.4e-3 apart, and the DTW's input, normalised over the near-flat
weights of a random model (their spread over tokens is about 1e-5), about
1.5e-3. No bound covers that: the cheapest predecessor leads the next by
as little as 5e-6 a summed cell somewhere on the path. The words and times
agree all the same at every case here; from the same audio features the
DTW's input agrees to about 3e-6.
"""

from __future__ import annotations

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from olmoasr_tpu import timing as jt
from olmoasr_tpu.api import OLMoASR as JaxOLMoASR
from olmoasr_tpu.models import whisper as jm
from olmoasr_tpu.models.dims import ModelDimensions
from olmoasr_tpu.tokenizer import get_tokenizer
from olmoasr_tpu_torch import timing as tt
from olmoasr_tpu_torch.api import _new_model
from olmoasr_tpu_torch.models import whisper as tm
from olmoasr_tpu_torch.models.convert import state_dict_from_jax_params

DIMS = ModelDimensions(
    n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=4, n_audio_layer=2,
    n_vocab=51864, n_text_ctx=448, n_text_state=64, n_text_head=4, n_text_layer=2,
)
TOK = get_tokenizer(False)
WEIGHT_TOL = PROB_TOL = 1e-5
TEXTS = (" hello world, this is a test of the word timing path.",
         " \"Quoted\" (words) and more-words! Again? Yes.")


@pytest.fixture(scope="module")
def jax_fp32_encoder():
    """The JAX package's encoder at fp32 unless a caller says otherwise."""
    orig = jm.encode_audio

    def encode_audio(params, dims, mel, **kw):
        return orig(params, dims, mel, **{"compute_dtype": jnp.float32, **kw})

    mp = pytest.MonkeyPatch()
    mp.setattr(jm, "encode_audio", encode_audio)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def pair():
    params = jm.init_params(jax.random.PRNGKey(0), DIMS, include_padding_token=False)
    model = _new_model(DIMS, False, "cpu", torch.float32)
    model.load_state_dict(state_dict_from_jax_params(jax.tree.map(np.asarray, params), DIMS))
    return JaxOLMoASR(DIMS, params), model.eval()


def _mel(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((80, 3000)).astype(np.float32)


# ---------------------------------------------------------------------------
# copies pinned against the originals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,width", [((4, 7, 40), 7), ((3, 30, 200), 7), ((2, 5, 6), 7),
                                         ((9, 17), 3), ((1, 1), 1)])
def test_median_filter_is_bit_equal(shape, width):
    x = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)
    got, want = tt.median_filter(x, width), jt.median_filter(x, width)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("shape,ties", [((5, 20), False), ((30, 200), False), ((12, 12), True),
                                        ((1, 9), False), ((7, 1), True)])
def test_dtw_is_bit_equal(shape, ties):
    rng = np.random.default_rng(shape[0] * 1000 + shape[1])
    x = rng.integers(0, 3, shape).astype(np.float32) if ties else rng.standard_normal(shape)
    got, want = tt.dtw(x), jt.dtw(x)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert got[0][-1] == shape[0] - 1 and got[1][-1] == shape[1] - 1


def _words(mod, spec):
    return [mod.WordTiming(w, [i], 0.1 * i, 0.1 * i + 0.05, 0.5) for i, w in enumerate(spec)]


@pytest.mark.parametrize("spec", [
    [" \"", "Hello", ",", " world"],
    [" (", " a", ")", ".", " -", " b", "!", "”"],
    [" x"],
    [],
    ["\"", " ¿", "Qué", "?", " y", "、"],
])
def test_merge_punctuations_matches(spec):
    pre, app = "\"'“¿([{-", "\"'.。,，!！?？:：”)]}、"
    got, want = _words(tt, spec), _words(jt, spec)
    tt.merge_punctuations(got, pre, app)
    jt.merge_punctuations(want, pre, app)
    assert [(w.word, w.tokens, w.start, w.end) for w in got] == \
        [(w.word, w.tokens, w.start, w.end) for w in want]


def test_softmax_is_bit_equal():
    x = np.random.default_rng(1).standard_normal((6, 50)).astype(np.float32) * 10
    assert np.array_equal(tt._softmax(x), jt._softmax(x))


# ---------------------------------------------------------------------------
# the model's side: the weights, the alignment, the words
# ---------------------------------------------------------------------------


def _tokens(text: str) -> list:
    return list(TOK.sot_sequence) + [TOK.no_timestamps] + TOK.encode(text) + [TOK.eot]


@pytest.mark.parametrize("batch", [1, 2])
def test_cross_attention_weights_match_jax(pair, batch):
    jmodel, model = pair
    rng = np.random.default_rng(batch)
    feats = (rng.standard_normal((batch, 1500, DIMS.n_audio_state)) * 0.5).astype(np.float32)
    tokens = np.array([_tokens(TEXTS[0])] * batch)
    tokens[-1, 5] = 100  # rows differ
    want = np.asarray(jm.cross_attention_weights(jmodel.params, DIMS, jnp.asarray(tokens),
                                                 jnp.asarray(feats)))
    got = tm.cross_attention_weights(model, torch.from_numpy(tokens), torch.from_numpy(feats))
    assert got.dtype == torch.float32
    assert got.shape == want.shape == (DIMS.n_text_layer, batch, DIMS.n_text_head,
                                       tokens.shape[1], 1500)
    np.testing.assert_allclose(got.numpy(), want, atol=WEIGHT_TOL, rtol=0)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-5)


def _assert_same_alignment(got, want):
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert (g.word, g.tokens, g.start, g.end) == (w.word, w.tokens, w.start, w.end)
        assert abs(g.probability - w.probability) <= PROB_TOL


@pytest.mark.parametrize("text,num_frames,seed", [(TEXTS[0], 2000, 0), (TEXTS[1], 3000, 1),
                                                   (TEXTS[1], 600, 2)])
def test_find_alignment_matches_jax(jax_fp32_encoder, pair, text, num_frames, seed):
    jmodel, model = pair
    mel = _mel(seed)
    ids = TOK.encode(text)
    want = jt.find_alignment(jmodel, TOK, ids, jnp.asarray(mel), num_frames)
    got = tt.find_alignment(model, TOK, ids, torch.from_numpy(mel), num_frames)
    _assert_same_alignment(got, want)
    assert tt.find_alignment(model, TOK, [], torch.from_numpy(mel), num_frames) == []


def test_find_alignment_from_the_same_features_matches_jax(pair, monkeypatch):
    """The JAX side given the port's audio features, so that only the
    decoder's side of the two packages differs: the DTW's input then agrees
    to about 3e-6 (against about 1.5e-3 from each package's own encoder,
    above)."""
    jmodel, model = pair
    mel = _mel(4)
    feats = tm.encode_audio(model, torch.from_numpy(mel)[None])
    monkeypatch.setattr(jmodel, "embed_audio", lambda m: jnp.asarray(feats.numpy()),
                        raising=False)
    for text, num_frames in zip(TEXTS, (3000, 1200)):
        ids = TOK.encode(text)
        want = jt.find_alignment(jmodel, TOK, ids, jnp.asarray(mel), num_frames)
        got = tt.find_alignment(model, TOK, ids, torch.from_numpy(mel), num_frames)
        _assert_same_alignment(got, want)


def _segments(text_a: str, text_b: str, seek: int):
    a, b = TOK.encode(text_a), TOK.encode(text_b)
    ts = TOK.timestamp_begin
    return [
        {"seek": seek, "start": seek / 100, "end": seek / 100 + 4.0,
         "tokens": [ts] + a + [ts + 200], "text": text_a},
        {"seek": seek, "start": seek / 100 + 4.0, "end": seek / 100 + 9.0,
         "tokens": [ts + 200] + b + [ts + 450], "text": text_b},
    ]


@pytest.mark.parametrize("seek,last_speech", [(0, 0.0), (1200, 11.5)])
def test_add_word_timestamps_matches_jax(jax_fp32_encoder, pair, seek, last_speech):
    jmodel, model = pair
    mel = _mel(3 + seek)
    want = _segments(*TEXTS, seek)
    got = copy.deepcopy(want)
    jt.add_word_timestamps(segments=want, model=jmodel, tokenizer=TOK, mel=jnp.asarray(mel),
                           num_frames=2500, last_speech_timestamp=last_speech)
    tt.add_word_timestamps(segments=got, model=model, tokenizer=TOK, mel=torch.from_numpy(mel),
                           num_frames=2500, last_speech_timestamp=last_speech)
    for g, w in zip(got, want):
        assert (g["start"], g["end"]) == (w["start"], w["end"])
        assert [(x["word"], x["start"], x["end"]) for x in g["words"]] == \
            [(x["word"], x["start"], x["end"]) for x in w["words"]]
        for x, y in zip(g["words"], w["words"]):
            assert abs(x["probability"] - y["probability"]) <= PROB_TOL
    assert sum(len(s["words"]) for s in got) > 5
    for s in got:
        for x in s["words"]:
            assert x["start"] <= x["end"]
