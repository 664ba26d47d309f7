"""The port's ``olmoasr`` compat surface (``olmoasr_tpu_torch.olmoasr``), its
copies of ``data/segment.py`` and ``data/align.py``, and the demo's
transcription functions, against the top-level ``olmoasr`` shim and the JAX
package.

The subpackage has the shim's modules and each module's ``__all__``. The
copies are driven with the inputs of ``tests/test_segment.py`` and
``tests/test_align.py`` beside their originals and must give the same
segments, rows and counters. ``load_model(...).transcribe`` of both surfaces
on one micro ``.npz`` at fp32 and temperature 0 gives the same text and
segments (tokens, times and text equal, scores within 1e-4, as
``tests/test_torch_transcribe.py`` holds them, whose weights and audio these
are). The demo's ``transcribe_file`` (beam 5) and ``transcribe_mic`` (three
int16 chunks at 8 kHz, one of them stereo) equal the same computation through
the JAX model's ``transcribe``.
"""

from __future__ import annotations

import dataclasses
import gzip
import importlib
import json

import jax
import numpy as np
import pytest
import scipy.io.wavfile as wavfile

import olmoasr as shim
import olmoasr_tpu.audio as jaudio
import olmoasr_tpu.data.align as jalign
import olmoasr_tpu.data.segment as jseg
from olmoasr_tpu.models import whisper as jm
from olmoasr_tpu.models.convert import save_npz_checkpoint
from olmoasr_tpu.models.dims import ModelDimensions
from olmoasr_tpu.utils import convert_to_timestamp

import olmoasr_tpu_torch.data.align as talign
import olmoasr_tpu_torch.data.segment as tseg
from olmoasr_tpu_torch import olmoasr as port
from olmoasr_tpu_torch.demo import demo

MODULES = ("", ".model", ".inf_model", ".transcribe", ".preprocess", ".utils")
DIMS = ModelDimensions(
    n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=4, n_audio_layer=2,
    n_vocab=51864, n_text_ctx=448, n_text_state=64, n_text_head=4, n_text_layer=2,
)
SAMPLE_LEN = 12
SCORE_TOL = 1e-4  # tests/test_torch_transcribe.py's
AUDIO_SEED = 6  # tests/test_torch_transcribe.py's
FP32 = dict(temperature=0.0, fp16=False, sample_len=SAMPLE_LEN)


@pytest.mark.parametrize("module", MODULES)
def test_surface_is_the_shims(module):
    """Each module of the port's subpackage exports the shim module's names,
    each bound to the port's own object."""
    ours = importlib.import_module("olmoasr_tpu_torch.olmoasr" + module)
    theirs = importlib.import_module("olmoasr" + module)
    assert ours.__all__ == theirs.__all__
    for name in ours.__all__:
        obj = getattr(ours, name)
        assert getattr(obj, "__module__", "olmoasr_tpu_torch").startswith("olmoasr_tpu_torch"), \
            (module, name)


def test_package_attributes():
    for name in ("inf_model", "model", "preprocess", "utils"):
        assert getattr(port, name).__name__ == f"olmoasr_tpu_torch.olmoasr.{name}"
    assert port.available_models() == shim.available_models()
    assert port.MODEL2LINK == shim.MODEL2LINK
    assert {k: v.to_dict() for k, v in port.VARIANT_TO_DIMS.items()} == \
        {k: v.to_dict() for k, v in shim.VARIANT_TO_DIMS.items()}
    assert port.utils.over_ctx_len is tseg.token_budget


# ---------------------------------------------------------------------------
# the copies of data/segment.py and data/align.py
# ---------------------------------------------------------------------------


def _transcript(cues):
    return {(convert_to_timestamp(s), convert_to_timestamp(e)): text for s, e, text in cues}


def _plain(x):
    """Segments, counters and machine segments as comparable values."""
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return (str(x.dtype), x.tolist())
    if dataclasses.is_dataclass(x):
        return {f.name: _plain(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {str(k): _plain(v) for k, v in x.items()}
    return x


# tests/test_segment.py's transcripts
CHUNK_CASES = {
    "two_segments": [(0, 14_000, "one"), (14_000, 28_000, "two"), (28_000, 42_000, "three"),
                     (42_000, 56_000, "four")],
    "over_30s": [(0, 31_000, "too long"), (31_000, 35_000, "ok")],
    "long_gap": [(0, 5_000, "speech"), (70_000, 75_000, "more")],
    "count_threshold": [(i * 31_000, i * 31_000 + 29_000, f"cue {i}") for i in range(200)],
    "audio": [(0, 10_000, "a"), (10_000, 20_000, "b"), (20_000, 40_000, "c")],
    "row_schema": [(0, 5_000, "text")],
}


@pytest.mark.parametrize("case", list(CHUNK_CASES))
def test_chunk_data_matches(case):
    kwargs = {"video_id": "v"}
    if case == "audio":
        kwargs["audio"] = (np.random.default_rng(0).standard_normal(16000 * 40) * 1000).astype(
            np.int16)
    t = _transcript(CHUNK_CASES[case])
    got, want = tseg.chunk_data(t, **kwargs), jseg.chunk_data(t, **kwargs)
    assert _plain(got) == _plain(want)
    assert [s.to_dict() for s in got[0]] == [s.to_dict() for s in want[0]]


def test_token_budget_matches():
    """tests/test_segment.py's three budgets, and the last-segment form."""
    tok_port = tseg.get_tokenizer(False)
    tok_jax = jseg.get_tokenizer(False)
    cases = ([(0, 1000, "hi there")], [(0, 1000, "word " * 600)],
             [(i * 100, i * 100 + 90, "hello there my friend " * 4) for i in range(22)])
    for cues in cases:
        for last in (False, True):
            assert tseg.token_budget(cues, tok_port, last) == jseg.token_budget(cues, tok_jax,
                                                                                 last)


def test_preprocess_jsonl_matches(tmp_path):
    """One shard of three videos (VTT and SRT) through both: the same
    segment rows (each under its own output directory) and stats."""
    rows = [{"id": "v0", "content": "WEBVTT\n\n00:00:00.000 --> 00:00:14.000\none\n\n"
             "00:00:14.000 --> 00:00:28.000\ntwo\n\n00:00:28.000 --> 00:00:42.000\nthree\n",
             "ext": "vtt"},
            {"id": "v1", "content": "1\n00:00:00,000 --> 00:00:05,000\nspeech\n\n2\n"
             "00:01:10,000 --> 00:01:15,000\nmore\n", "ext": "srt"},
            {"video_id": "v2", "transcript": "WEBVTT\n\n00:00:00.000 --> 00:00:31.000\nlong\n",
             "ext": "vtt"}]
    shard = tmp_path / "shard0.jsonl.gz"
    with gzip.open(shard, "wt") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows)
    stats = {}
    for name, mod in (("port", tseg), ("jax", jseg)):
        stats[name] = mod.preprocess_jsonl(str(shard), str(tmp_path / name))
    assert stats["port"] == stats["jax"] and stats["port"]["segment_count"] > 0
    for fname in ("shard0_segments.jsonl.gz", "shard0_stats.json"):
        opener = gzip.open if fname.endswith(".gz") else open
        with opener(tmp_path / "port" / fname, "rt") as a, \
                opener(tmp_path / "jax" / fname, "rt") as b:
            # the rows name files under each run's own output directory
            assert a.read().replace(str(tmp_path / "port"), "OUT") == \
                b.read().replace(str(tmp_path / "jax"), "OUT"), fname


# tests/test_align.py's transcripts and boundaries
ALIGN_CASES = {
    "simple": ([(100, 5000, "machine hello world"), (5100, 9000, "more words")], [(0, 5000)]),
    "two_boundaries": ([(0, 4000, "a"), (4000, 8000, "b"), (8000, 12000, "c")],
                       [(0, 8000), (8000, 12000)]),
}


@pytest.mark.parametrize("case", list(ALIGN_CASES))
def test_align_machine_transcript_matches(case):
    cues, bounds = ALIGN_CASES[case]
    t = _transcript(cues)
    assert _plain(talign.align_machine_transcript(t, bounds, "v")) == \
        _plain(jalign.align_machine_transcript(t, bounds, "v"))


@pytest.mark.parametrize("with_machine", [True, False])
def test_merge_man_mach_segs_matches(with_machine):
    man = _transcript([(0, 4000, "hello world"), (4000, 8000, "good day")])
    mach = _transcript([(50, 3900, "hello world"), (4100, 7900, "good night")]) \
        if with_machine else None
    got = talign.merge_man_mach_segs(man, mach, video_id="v")
    want = jalign.merge_man_mach_segs(man, mach, video_id="v")
    assert _plain(got) == _plain(want)
    assert [s.merged for s in got[0]] == [s.merged for s in want[0]]


# ---------------------------------------------------------------------------
# load_model(...).transcribe and the demo, against the JAX model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("compat") / "micro.npz")
    save_npz_checkpoint(path, jm.init_params(jax.random.PRNGKey(0), DIMS), DIMS)
    return path


@pytest.fixture(scope="module")
def models(ckpt):
    return port.load_model(ckpt, device="cpu"), shim.load_model(ckpt)


def _assert_same_transcripts(got, want):
    assert got["language"] == want["language"] and got["text"] == want["text"]
    assert len(got["segments"]) == len(want["segments"]) > 0
    for g, w in zip(got["segments"], want["segments"]):
        for key in ("id", "seek", "start", "end", "tokens", "text", "temperature"):
            assert g[key] == w[key], key
        for key in ("avg_logprob", "no_speech_prob", "compression_ratio"):
            assert abs(g[key] - w[key]) <= SCORE_TOL, key


def test_load_model_transcribe_matches_the_shims(models):
    """41 s of tests/test_torch_transcribe.py's audio, two windows."""
    ours, theirs = models
    rng = np.random.default_rng(AUDIO_SEED)
    rng.standard_normal(16000 * 75)  # that test's first file
    wav = (rng.standard_normal(16000 * 41) * 0.1).astype(np.float32)
    _assert_same_transcripts(ours.transcribe(wav, **FP32), theirs.transcribe(wav, **FP32))


def test_demo_transcribe_file_matches(models, tmp_path):
    """The File tab with beam search (beam 5 at t=0) on a 35 s wav."""
    ours, theirs = models
    path = str(tmp_path / "a.wav")
    rng = np.random.default_rng(9)
    wavfile.write(path, 16000, (rng.standard_normal(16000 * 35) * 3000).astype(np.int16))
    got = demo.transcribe_file(ours, path, True, **FP32)
    result = theirs.transcribe(path, beam_size=5, best_of=5, **FP32)
    lines = [f"[{s['start']:7.2f} -> {s['end']:7.2f}] {s['text']}" for s in result["segments"]]
    assert got == result["text"].strip() + "\n\n" + "\n".join(lines)
    assert result["segments"]


def test_demo_transcribe_mic_matches(models):
    """The Live tab: three int16 chunks at 8 kHz (the second stereo) grow
    the rolling buffer; after each, the buffer and its text equal the JAX
    model's transcribe of the same buffer, built with the JAX package's
    resampler."""
    ours, theirs = models
    rng = np.random.default_rng(10)
    chunks = [(rng.standard_normal(8000 * 4) * 3000).astype(np.int16),
              (rng.standard_normal((8000 * 3, 2)) * 3000).astype(np.int16),
              (rng.standard_normal(8000 * 5) * 3000).astype(np.int16)]
    state, want_stream = None, None
    for chunk in chunks:
        state, text = demo.transcribe_mic(ours, state, (8000, chunk), **FP32)
        x = chunk.astype(np.float32) / 32768.0
        x = jaudio.resample_poly(x.mean(axis=1) if x.ndim == 2 else x, 16000, 8000)
        want_stream = x if want_stream is None else np.concatenate([want_stream, x])
        np.testing.assert_array_equal(state, want_stream)
        assert text == theirs.transcribe(want_stream, **FP32)["text"]
    assert len(state) == 16000 * 12
