"""The port's copies of the JAX package's framework-free modules, pinned to
their originals: the port imports nothing of ``olmoasr_tpu`` (even its
modules free of jax), so it carries its own ``models/dims.py``,
``version.py``, the released models' links (``MODEL2LINK``),
``tokenizer.py``, ``utils.py``, ``writers.py``, ``data/transcripts.py``,
the serving option parser, the host-side log-mel and the training loader's
token building. Each test feeds both the same
inputs and wants the same outputs, exactly."""

from __future__ import annotations

import numpy as np
import pytest

import olmoasr_tpu as jpkg
import olmoasr_tpu.audio as jaudio
import olmoasr_tpu.serve as jserve
import olmoasr_tpu.tokenizer as jtok
import olmoasr_tpu.utils as jutils
import olmoasr_tpu.writers as jwriters
from olmoasr_tpu.data.transcripts import TranscriptReader as JReader
from olmoasr_tpu.models.dims import VARIANT_TO_DIMS as J_DIMS
from olmoasr_tpu.training import dataset as jds
from olmoasr_tpu.version import __version__ as j_version

import olmoasr_tpu_torch as port
import olmoasr_tpu_torch.audio as taudio
import olmoasr_tpu_torch.serve as tserve
import olmoasr_tpu_torch.tokenizer as ttok
import olmoasr_tpu_torch.utils as tutils
import olmoasr_tpu_torch.writers as twriters
from olmoasr_tpu_torch.data.transcripts import TranscriptReader as TReader
from olmoasr_tpu_torch.training import dataset as tds

TEXTS = ["", " hello world", "Hello, World! 123", " naïve café — ünïcödé ♪♪", "  spaces   inside ",
         "<|endoftext|> is text here", " 'quoted' (brackets) [x] {y}", "\tline\nbreak"]


def test_released_model_names():
    assert port.MODEL2LINK == jpkg.MODEL2LINK
    assert port.available_models() == jpkg.available_models()


def test_model_dims_and_version():
    assert port.__version__ == j_version
    assert port.VARIANT_TO_DIMS.keys() == J_DIMS.keys()
    for name, dims in J_DIMS.items():
        assert port.VARIANT_TO_DIMS[name].to_dict() == dims.to_dict(), name
    assert port.ModelDimensions(**J_DIMS["small.en"].to_dict()) == port.VARIANT_TO_DIMS["small.en"]


@pytest.mark.parametrize("multilingual", [False, True])
def test_tokenizer(multilingual):
    j, t = jtok.get_tokenizer(multilingual), ttok.get_tokenizer(multilingual)
    for text in TEXTS:
        ids = j.encode(text)
        assert t.encode(text) == ids, text
        assert t.decode(ids) == j.decode(ids)
    for name in ("eot", "sot", "transcribe", "translate", "sot_lm", "sot_prev", "no_speech",
                 "no_timestamps", "timestamp_begin", "sot_sequence",
                 "sot_sequence_including_notimestamps", "non_speech_tokens",
                 "all_language_tokens", "all_language_codes"):
        assert getattr(t, name) == getattr(j, name), name
    stamps = [j.sot, j.timestamp_begin, *j.encode(" hi there"), j.timestamp_begin + 50, j.eot]
    assert t.decode_with_timestamps(stamps) == j.decode_with_timestamps(stamps)
    assert t.split_to_word_tokens(stamps[2:-2]) == j.split_to_word_tokens(stamps[2:-2])
    assert ttok.LANGUAGES == jtok.LANGUAGES and ttok.TO_LANGUAGE_CODE == jtok.TO_LANGUAGE_CODE


RESULT = {
    "text": " Hello there. A second line, a bit longer than the first one.",
    "language": "en",
    "segments": [
        {"id": 0, "seek": 0, "start": 0.0, "end": 2.5, "text": " Hello there.",
         "tokens": [1, 2], "temperature": 0.0, "avg_logprob": -0.3,
         "compression_ratio": 1.1, "no_speech_prob": 0.01},
        {"id": 1, "seek": 0, "start": 2.5, "end": 3661.257,
         "text": " A second line, a bit longer than the first one.", "tokens": [3],
         "temperature": 0.2, "avg_logprob": -0.5, "compression_ratio": 1.3,
         "no_speech_prob": 0.02},
    ],
}


@pytest.mark.parametrize("fmt", ["txt", "vtt", "srt", "tsv", "json"])
def test_writers(tmp_path, fmt):
    out = {}
    for name, mod in (("jax", jwriters), ("port", twriters)):
        d = tmp_path / name
        d.mkdir()
        mod.get_writer(fmt, str(d))(RESULT, "dir/audio.wav",
                                    max_line_width=20 if fmt in ("vtt", "srt") else None)
        out[name] = (d / f"audio.{fmt}").read_text(encoding="utf-8")
    assert out["port"] == out["jax"] and out["jax"]


def test_utils():
    for t in (0.0, 1.234, 59.999, 3661.257):
        for hours in (False, True):
            assert tutils.format_timestamp(t, hours) == jutils.format_timestamp(t, hours)
    for s in ("00:01:02.345", "01:00:00.000"):
        assert tutils.convert_to_milliseconds(s) == jutils.convert_to_milliseconds(s)
    assert tutils.convert_to_timestamp(3723456) == jutils.convert_to_timestamp(3723456)
    assert tutils.compression_ratio(RESULT["text"]) == jutils.compression_ratio(RESULT["text"])


def test_serving_options():
    assert tserve.ALLOWED_OPTIONS == jserve.ALLOWED_OPTIONS
    for key, raw in (("beam_size", "5"), ("fp16", "True"), ("fp16", "false"), ("language", "en"),
                     ("temperature", "0.2"), ("temperature", "0,0.2,0.4"), ("best_of", "None"),
                     ("initial_prompt", "hello, world"), ("patience", "1e-3"),
                     ("length_penalty", "null")):
        assert tserve._parse_option(key, raw) == jserve._parse_option(key, raw), (key, raw)
        assert type(tserve._parse_option(key, raw)) is type(jserve._parse_option(key, raw))


def test_host_log_mel():
    wave = np.random.default_rng(0).standard_normal(16000 * 7).astype(np.float32) * 0.1
    for n_mels, padding in ((80, 0), (128, 160)):
        np.testing.assert_array_equal(taudio.log_mel_spectrogram_np(wave, n_mels, padding),
                                      jaudio.log_mel_spectrogram_np(wave, n_mels, padding))
    batch = np.stack([wave[:48000], wave[48000:96000]])
    np.testing.assert_array_equal(taudio.log_mel_spectrogram_np(batch),
                                  jaudio.log_mel_spectrogram_np(batch))


VTT = """WEBVTT

00:00:00.000 --> 00:00:02.000
hello world

00:00:02.000 --> 00:00:04.500
<c>training</c> smoke
test
"""
SRT = """1
00:00:00,500 --> 00:00:01,250
first cue

2
00:00:01,250 --> 00:00:03,000
second &amp; cue
"""


@pytest.mark.parametrize("ext,text", [("vtt", VTT), ("srt", SRT), ("vtt", "WEBVTT\n\n")])
def test_transcript_reader(ext, text):
    want = JReader(transcript_string=text, ext=ext).read()
    assert TReader(transcript_string=text, ext=ext).read() == want


def test_token_building():
    """The loader's token sequences (both modes, >30 s, empty) from the same rng."""
    j, t = jtok.get_tokenizer(False), ttok.get_tokenizer(False)
    transcript = JReader(transcript_string=VTT, ext="vtt").read()[0]
    for norm_end in (4500, 31000, "00:00:29.000"):
        for seed in range(4):
            for tr in (transcript, {}):
                want = jds.build_tokens(tr, j, norm_end, rng=np.random.default_rng(seed))
                got = tds.build_tokens(tr, t, norm_end, rng=np.random.default_rng(seed))
                assert got == want, (norm_end, seed, bool(tr))
