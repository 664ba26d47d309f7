"""The port's decoding and audio front end (olmoasr_tpu_torch.decoding,
olmoasr_tpu_torch.audio) against the JAX package, on the CPU.

The filters and the copied definitions must agree exactly. The whole greedy
slice runs in fp32 on a micro model with the same weights on both sides and
must give identical tokens; the test first shows that every step's top-2
margin exceeds the logit tolerance, so that identity is what the tolerance
predicts and not luck. That tolerance comes from the encoder: the port's
attention rounds p to bf16 as the TPU kernel does, the JAX model on the CPU
runs exact fp32 attention.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from olmoasr_tpu import audio as jaudio
from olmoasr_tpu import decoding as jdec
from olmoasr_tpu.models import whisper as jm
from olmoasr_tpu.models.dims import ModelDimensions
from olmoasr_tpu.tokenizer import get_tokenizer
from olmoasr_tpu_torch import audio, decoding
from olmoasr_tpu_torch.api import _new_model
from olmoasr_tpu_torch.models import whisper as tm
from olmoasr_tpu_torch.models.convert import state_dict_from_jax_params

V = 51864
TOK = get_tokenizer(False)


# ---------------------------------------------------------------------------
# copies pinned against the originals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["DecodingOptions", "DecodingResult", "FilterConfig"])
def test_copied_dataclasses_match(name):
    port, orig = getattr(decoding, name), getattr(jdec, name)
    pf, of = dataclasses.fields(port), dataclasses.fields(orig)
    assert [f.name for f in pf] == [f.name for f in of]
    for a, b in zip(pf, of):
        if a.default is not dataclasses.MISSING and not (
            isinstance(a.default, float) and np.isnan(a.default)
        ):
            assert a.default == b.default, a.name
        assert (a.default_factory is dataclasses.MISSING) == (
            b.default_factory is dataclasses.MISSING
        )


OPTION_SETS = [
    {},
    {"without_timestamps": True},
    {"suppress_blank": False, "suppress_tokens": "1,2,3", "max_initial_timestamp": None},
    {"suppress_tokens": [-1, 7], "prompt": "hello there", "prefix": "so", "sample_len": 20},
]


@pytest.mark.parametrize("opts", OPTION_SETS)
def test_filter_config_and_prompt_match(opts):
    port = decoding.build_filter_config(TOK, decoding.DecodingOptions(**opts), 3, V)
    orig = jdec.build_filter_config(TOK, jdec.DecodingOptions(**opts), 3, V)
    assert dataclasses.asdict(port) == dataclasses.asdict(orig)
    np.testing.assert_array_equal(port.suppress_mask, orig.suppress_mask)
    assert decoding._resolve_prompt(TOK, decoding.DecodingOptions(**opts)) == \
        jdec._resolve_prompt(TOK, jdec.DecodingOptions(**opts))


def test_ranker_and_compression_ratio_match():
    toks = [[[1, 2, 3], [4]], [[5], [6, 7]]]
    lps = [[-3.0, -1.5], [-0.5, -2.5]]
    for lp in (None, 1.0):
        assert decoding.MaximumLikelihoodRanker(lp).rank(toks, lps) == \
            jdec.MaximumLikelihoodRanker(lp).rank(toks, lps)
    for text in ("", "a a a a a a a a", "the quick brown fox"):
        assert decoding.compression_ratio(text) == jdec.compression_ratio(text)


def test_audio_copies_match():
    for name in ("SAMPLE_RATE", "N_FFT", "HOP_LENGTH", "CHUNK_LENGTH", "N_SAMPLES",
                 "N_FRAMES", "N_SAMPLES_PER_TOKEN", "FRAMES_PER_SECOND", "TOKENS_PER_SECOND"):
        assert getattr(audio, name) == getattr(jaudio, name), name
    for n_mels in (80, 128):
        np.testing.assert_array_equal(audio.mel_filters_np(n_mels), jaudio.mel_filters_np(n_mels))
    x = np.arange(30, dtype=np.float32).reshape(3, 10)
    for length in (4, 10, 17):
        want = jaudio.pad_or_trim(x, length)
        np.testing.assert_array_equal(audio.pad_or_trim(x, length), want)
        np.testing.assert_array_equal(audio.pad_or_trim(torch.from_numpy(x), length).numpy(), want)
        np.testing.assert_array_equal(
            audio.pad_or_trim(x, length, axis=0), jaudio.pad_or_trim(x, length, axis=0)
        )


def test_load_audio_matches(tmp_path):
    import scipy.io.wavfile as wavfile

    pcm = (np.random.default_rng(0).standard_normal(8000) * 3000).astype(np.int16)
    wav, npy = str(tmp_path / "a.wav"), str(tmp_path / "a.npy")
    wavfile.write(wav, 8000, pcm)  # resampled to 16 kHz on load
    np.save(npy, pcm)
    for path in (wav, npy):
        np.testing.assert_array_equal(audio.load_audio(path), jaudio.load_audio(path))


# ---------------------------------------------------------------------------
# log-mel
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def waveforms():
    return (np.random.default_rng(3).standard_normal((2, 16000 * 3)) * 0.1).astype(np.float32)


def test_log_mel_matches_numpy_and_jax(waveforms):
    got = audio.log_mel_spectrogram(torch.from_numpy(waveforms)).numpy()
    np.testing.assert_allclose(got, jaudio.log_mel_spectrogram_np(waveforms), atol=1e-4, rtol=0)
    np.testing.assert_allclose(
        got, np.asarray(jaudio.log_mel_spectrogram(jnp.asarray(waveforms))), atol=1e-4, rtol=0
    )
    single = audio.log_mel_spectrogram(waveforms[0], padding=800).numpy()
    np.testing.assert_allclose(
        single, jaudio.log_mel_spectrogram_np(waveforms[0], padding=800), atol=1e-4, rtol=0
    )


def test_log_mel_takes_int16_pcm(waveforms):
    pcm = (waveforms * 32767).astype(np.int16)
    got = audio.log_mel_spectrogram(pcm).numpy()
    want = np.asarray(jaudio.log_mel_spectrogram(pcm))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# apply_filters, rule for rule
# ---------------------------------------------------------------------------


def _rings(step: int):
    """Token rings whose first ``step`` entries exercise every rule."""
    ts = TOK.timestamp_begin
    rows = [
        [11, 12, 13, 14, 15],  # text only
        [ts + 4, 21, ts + 9, 22, 23],  # ts, text, ts: must close or keep text
        [21, ts + 3, ts + 3, 22, 23],  # text, ts, ts: no third timestamp
        [ts + 50, ts + 50, 31, 32, 33],  # monotonic floor from an early ts
        [ts, 41, 42, 43, TOK.eot],  # eot later in the ring
        [ts + 2, 51, 52, ts + 30, ts + 30],  # ts late in the ring
    ]
    ring = np.full((len(rows), 8), TOK.eot, np.int32)
    for i, r in enumerate(rows):
        ring[i, :step] = r[:step]
    return ring


def _logits(seed: int):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((6, V)) * 2).astype(np.float32)
    logits[1, TOK.timestamp_begin:] += 6.0  # timestamp mass wins rule 4
    logits[4, TOK.eot] += 25.0  # EOT beats the timestamps in rule 4
    return logits


@pytest.mark.parametrize("opts", OPTION_SETS[:3])
@pytest.mark.parametrize("step", [0, 1, 2, 3, 5])
def test_apply_filters_matches(opts, step):
    cfg_t = decoding.build_filter_config(TOK, decoding.DecodingOptions(**opts), 1, V)
    cfg_j = jdec.build_filter_config(TOK, jdec.DecodingOptions(**opts), 1, V)
    logits, ring = _logits(step), _rings(step)
    want = np.asarray(jdec.apply_filters(jnp.asarray(logits), jnp.asarray(ring),
                                         jnp.int32(step), cfg_j))
    got = decoding.apply_filters(torch.from_numpy(logits), torch.from_numpy(ring), step, cfg_t)
    np.testing.assert_array_equal(np.isneginf(got.numpy()), np.isneginf(want))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_apply_filters_lets_eot_win_rule_4():
    cfg = decoding.build_filter_config(TOK, decoding.DecodingOptions(), 1, V)
    out = decoding.apply_filters(torch.from_numpy(_logits(0)), torch.from_numpy(_rings(3)), 3, cfg)
    assert int(out[4].argmax()) == TOK.eot
    assert int(out[1].argmax()) >= TOK.timestamp_begin


# ---------------------------------------------------------------------------
# the whole greedy slice
# ---------------------------------------------------------------------------

DIMS = ModelDimensions(
    n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=4, n_audio_layer=2,
    n_vocab=V, n_text_ctx=448, n_text_state=64, n_text_head=4, n_text_layer=2,
)
# encoder bf16-p rounding carried to the logits: 1.2e-4 measured at the first
# step (audio features 1.7e-3 apart), held with a wide margin
LOGIT_TOL = 1e-2
SAMPLE_LEN = 40


@pytest.fixture(scope="module")
def slice_pair():
    params = jm.init_params(jax.random.PRNGKey(0), DIMS, include_padding_token=False)
    model = _new_model(DIMS, False, "cpu", torch.float32)
    model.load_state_dict(state_dict_from_jax_params(jax.tree.map(np.asarray, params), DIMS))
    mel = (np.random.default_rng(1).standard_normal((2, 80, 3000)) * 0.5).astype(np.float32)
    return params, model, mel


def test_greedy_slice_matches_jax_decode(slice_pair):
    params, model, mel = slice_pair
    opts = dict(fp16=False, sample_len=SAMPLE_LEN)
    got = decoding.decode(model, mel, decoding.DecodingOptions(**opts))
    want = jdec.decode(params, DIMS, mel, jdec.DecodingOptions(**opts))

    # teacher-force the port's tokens: every greedy choice had room to spare
    prompt = decoding._resolve_prompt(TOK, decoding.DecodingOptions(**opts))
    cfg = decoding.build_filter_config(TOK, decoding.DecodingOptions(**opts), len(prompt), V)
    feats = tm.encode_audio(model, torch.from_numpy(mel))
    cache = tm.init_cache(model, feats, max_len=len(prompt) + SAMPLE_LEN)
    logits = tm.decode_step(model, torch.tensor([prompt] * 2), cache)[:, -1]
    ring = torch.full((2, SAMPLE_LEN), TOK.eot)
    for i in range(SAMPLE_LEN):
        filt = decoding.apply_filters(logits, ring, i, cfg)
        top2 = filt.topk(2, dim=-1).values
        for b, r in enumerate(got):
            if i <= len(r.tokens):  # rows still running
                tok = r.tokens[i] if i < len(r.tokens) else TOK.eot
                assert int(filt[b].argmax()) == tok
                assert float(top2[b, 0] - top2[b, 1]) > LOGIT_TOL, (b, i)
                ring[b, i] = tok
        logits = tm.decode_step(model, ring[:, i:i + 1], cache)[:, 0]

    for g, w in zip(got, want):
        assert g.tokens == w.tokens
        assert g.text == w.text
        assert abs(g.no_speech_prob - w.no_speech_prob) < 1e-4
        assert abs(g.avg_logprob - w.avg_logprob) < 1e-3
        assert tuple(g.audio_features.shape) == (DIMS.n_audio_ctx, DIMS.n_audio_state)


def test_decode_single_window_and_model_entry_point(slice_pair):
    params, model, mel = slice_pair
    from olmoasr_tpu_torch.api import OLMoASR

    wrapped = _new_model(DIMS, False, "cpu", torch.float32)
    assert isinstance(wrapped, OLMoASR)
    wrapped.load_state_dict(model.state_dict())
    opts = decoding.DecodingOptions(fp16=False, sample_len=6)
    one = wrapped.decode(mel[0], opts)
    assert isinstance(one, decoding.DecodingResult)
    assert one.tokens == decoding.decode(model, mel[:1], opts)[0].tokens
    feats = wrapped.embed_audio(torch.from_numpy(mel[:1]))
    logits = wrapped.logits(torch.tensor([[TOK.sot, 11, 12]]), feats)
    assert logits.shape == (1, 3, V) and logits.dtype == torch.float32


@pytest.mark.parametrize("opts", [{"beam_size": 5, "word_timestamps": True},
                                  {"beam_size": 2, "best_of": 5,
                                   "hallucination_silence_threshold": 2.0},
                                  {"beam_size": 5, "patience": 2.0, "word_timestamps": True}])
def test_unported_options_raise(slice_pair, opts):
    """Beam search is ported; what beam-search users may still ask for and
    the port does not take (word timestamps, the hallucination-silence
    heuristic) raises before anything decodes."""
    from olmoasr_tpu_torch import transcribe_many

    _, model, _ = slice_pair
    steps = tm.decode_step.single_steps
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        transcribe_many(model, [np.zeros(16000, np.float32)], fp16=False, **opts)
    assert tm.decode_step.single_steps == steps


def test_decode_refuses_a_dtype_mismatch(slice_pair):
    """A mismatch between the weights' dtype and ``fp16`` is no longer
    refused: fp16=False on a bf16 model computes in fp32 from an fp32 copy,
    as the JAX package's ``_linear`` casts weights to the activation dtype."""
    _, model, mel = slice_pair
    bf16 = _new_model(DIMS, False, "cpu", torch.bfloat16)
    bf16.load_state_dict(model.state_dict())
    opts = decoding.DecodingOptions(fp16=False, sample_len=6)
    got = decoding.decode(bf16, mel, opts)
    fp32 = _new_model(DIMS, False, "cpu", torch.float32)
    fp32.load_state_dict(bf16.state_dict())  # the bf16 values, widened
    want = decoding.decode(fp32, mel, opts)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert [r.avg_logprob for r in got] == [r.avg_logprob for r in want]
    assert got[0].audio_features.dtype == torch.float32 and bf16.dtype == torch.bfloat16


def test_default_options_decode_fp32_weights_in_bf16(slice_pair):
    """DecodingOptions() has fp16=True: an fp32 model decodes in bf16, the
    same as the explicitly bf16-cast model, through decode and OLMoASR.decode."""
    _, model, mel = slice_pair
    opts = decoding.DecodingOptions(sample_len=6)
    got = decoding.decode(model, mel, opts)
    cast = _new_model(DIMS, False, "cpu", torch.float32)
    cast.load_state_dict(model.state_dict())
    want = decoding.decode(cast.to(torch.bfloat16), mel, opts)
    for g, w in zip(got, want):
        assert g.tokens == w.tokens and g.avg_logprob == w.avg_logprob
        assert g.no_speech_prob == w.no_speech_prob
        assert g.audio_features.dtype == torch.bfloat16
        assert torch.equal(g.audio_features, w.audio_features)
    assert model.dtype == torch.float32
    assert cast.decode(mel[0], opts).tokens == want[0].tokens


# ---------------------------------------------------------------------------
# temperature sampling and best_of
# ---------------------------------------------------------------------------


def test_sampler_draws_from_softmax_over_temperature():
    """Counts of 40000 draws from one filtered logit row against
    softmax(filt / T): chi-square at p > 1e-3 (df 5), suppressed tokens never
    drawn. Torch's random bits are not JAX's, so the distributions are
    compared, not the draws."""
    from scipy.stats import chi2

    row = torch.tensor([1.0, -np.inf, 0.5, 2.0, -1.0, -np.inf, 0.0, 1.5])
    n, T = 40000, 0.7
    gen = torch.Generator().manual_seed(0)
    toks = decoding._next_tokens(row.expand(n, -1), T, gen)
    counts = np.bincount(toks.numpy(), minlength=row.numel())
    probs = torch.softmax(row / T, dim=-1).numpy()
    assert counts[~np.isfinite(row.numpy())].sum() == 0
    live = probs > 0
    stat = float((((counts - n * probs) ** 2)[live] / (n * probs[live])).sum())
    assert chi2.sf(stat, live.sum() - 1) > 1e-3, (counts, probs)
    assert decoding._next_tokens(row[None], 0.0, None).tolist() == [3]


def test_best_of_samples_share_the_window_and_are_ranked(slice_pair, monkeypatch):
    """best_of=3 at T=0.6: one encode, 3 token rows per window over the
    window's cross cache (equal no-speech probs within a group), results
    chosen by MaximumLikelihoodRanker; a decode without a generator is
    seeded 0, so it repeats."""
    _, model, mel = slice_pair
    seen = []
    orig = decoding._decode_sample

    def spy(*args, **kwargs):
        out = orig(*args, **kwargs)
        seen.append((args, out))
        return out

    monkeypatch.setattr(decoding, "_decode_sample", spy)
    opts = decoding.DecodingOptions(fp16=False, temperature=0.6, best_of=3, sample_len=8)
    got = decoding.decode(model, mel, opts)
    (args, (tokens, lps, probs_at_sot, feats)), = seen
    assert args[8] == 3 and tokens.shape == (6, 8) and feats.shape[0] == 2
    p_ns = probs_at_sot[:, TOK.no_speech].view(2, 3)
    torch.testing.assert_close(p_ns, p_ns[:, :1].expand(2, 3), atol=1e-6, rtol=0)
    for b, r in enumerate(got):
        cands = []
        for g in range(3):
            seq = tokens[3 * b + g].tolist()
            seq = seq[: seq.index(TOK.eot)] if TOK.eot in seq else seq
            cands.append((float(lps[3 * b + g]) / len(seq), seq, float(lps[3 * b + g])))
        score, seq, lp = max(cands, key=lambda c: c[0])
        assert r.tokens == seq and r.temperature == 0.6
        assert r.avg_logprob == pytest.approx(lp / (len(seq) + 1))
        assert r.no_speech_prob == pytest.approx(float(p_ns[b, 0]))
    again = decoding.decode(model, mel, opts)
    assert [r.tokens for r in again] == [r.tokens for r in got]


# ---------------------------------------------------------------------------
# beam search
# ---------------------------------------------------------------------------

BEAM_SAMPLE_LEN = 16


def _assert_same_results(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.tokens == w.tokens and g.text == w.text
        assert abs(g.avg_logprob - w.avg_logprob) < 1e-4
        assert abs(g.no_speech_prob - w.no_speech_prob) < 1e-4
        assert g.temperature == w.temperature == 0.0


@pytest.mark.parametrize("opts", [
    {"beam_size": 2},
    {"beam_size": 3, "kv_quant": True},
    {"beam_size": 3, "patience": 2.0},
    {"beam_size": 2, "patience": 2.0, "kv_quant": True, "best_of": 5},
])
def test_beam_search_matches_jax_decode(slice_pair, opts):
    """fp32 beam search through both packages on the same weights: the same
    hypotheses, scores within 1e-4. ``best_of`` is ignored at temperature 0."""
    params, model, mel = slice_pair
    o = dict(fp16=False, sample_len=BEAM_SAMPLE_LEN, **opts)
    steps = tm.decode_step.single_steps
    got = decoding.decode(model, mel, decoding.DecodingOptions(**o))
    # one step per sampled token but the last, and the one-token prefill
    assert tm.decode_step.single_steps - steps == BEAM_SAMPLE_LEN
    want = jdec.decode(params, DIMS, mel, jdec.DecodingOptions(**o))
    _assert_same_results(got, want)


def test_beam_search_exits_early_as_jax_does():
    """A model whose EOT logit is lifted (its embedding row along the final
    LayerNorm's bias) fills every window's finished pool within a few steps;
    at the first check, after 32 steps of 40, the worst finished score beats
    the best live one in every window and both packages stop there."""
    params = jax.tree.map(np.copy, jax.tree.map(
        np.asarray, jm.init_params(jax.random.PRNGKey(0), DIMS, include_padding_token=False)))
    u = np.random.default_rng(7).standard_normal(DIMS.n_text_state).astype(np.float32)
    params["decoder"]["ln_b"] = u
    params["decoder"]["token_embedding"][TOK.eot] = 0.15 * u
    model = _new_model(DIMS, False, "cpu", torch.float32)
    model.load_state_dict(state_dict_from_jax_params(params, DIMS))
    mel = (np.random.default_rng(1).standard_normal((2, 80, 3000)) * 0.5).astype(np.float32)
    o = dict(fp16=False, sample_len=40, beam_size=3)
    steps = tm.decode_step.single_steps
    got = decoding.decode(model, mel, decoding.DecodingOptions(**o))
    assert tm.decode_step.single_steps - steps == 1 + decoding.EXIT_CHECK_EVERY - 1
    assert all(0 < len(r.tokens) < 40 for r in got)
    _assert_same_results(got, jdec.decode(params, DIMS, mel, jdec.DecodingOptions(**o)))


def test_beam_step_keeps_the_pool_and_the_ancestry():
    """One hand-made step: 1 window, K=2 beams, a vocabulary of 4 with EOT=3.
    The pool takes the EOT candidate, the live beams the best two others,
    the history and the map follow their source beams, and positions from
    the write index on stay each row's own."""
    cfg = decoding.FilterConfig(sample_begin=1, eot=3, timestamp_begin=4, no_timestamps=4,
                                blank_suppress=(), suppress=(), apply_timestamp_rules=False,
                                max_initial_timestamp_index=None, n_vocab=4)
    logp = torch.log(torch.tensor([[0.1, 0.2, 0.3, 0.4], [0.05, 0.8, 0.1, 0.05]]))
    st = decoding._BeamState(
        tokens=torch.tensor([[0, 2, 3, 3], [1, 1, 3, 3]]),
        beam_lp=torch.tensor([[-1.0, -0.5]]),
        fin_tokens=torch.full((1, 2, 4), 3),
        fin_lp=torch.full((1, 2), decoding._BEAM_NEG),
        logits=logp,
        anc=torch.tensor([[0, 1, 0, 0, 0], [1, 0, 1, 1, 1]], dtype=torch.int32),
    )
    tok = decoding._beam_step(st, 2, cfg, index=3)
    # the top 4: beam 1 tok 1 (-0.723), beam 0 tok 3 = EOT (-1.916), beam 0
    # tok 2 (-2.204), beam 0 tok 1 (-2.609): the live beams are 1 then 0
    assert tok.tolist() == [1, 2]
    assert st.tokens.tolist() == [[1, 1, 1, 3], [0, 2, 2, 3]]
    assert st.anc.tolist() == [[1, 0, 1, 0, 0], [0, 1, 0, 1, 1]]
    torch.testing.assert_close(st.beam_lp, torch.tensor([[-0.5 + np.log(0.8),
                                                          -1.0 + np.log(0.3)]],
                                                        dtype=torch.float32))
    assert st.fin_tokens[0, 0].tolist() == [0, 2, 3, 3]
    assert float(st.fin_lp[0, 0]) == pytest.approx(-1.0 + np.log(0.4))
    assert float(st.fin_lp[0, 1]) <= -1e29  # an empty slot
