"""The port's copies of the framework-free data pipeline and the eval-set
fetcher, pinned to their originals: ``data/jsonl.py``, ``sampling.py``,
``filtering.py``, ``tagging.py``, ``audio_lang.py``, ``qa_video.py``,
``yodas.py`` and ``eval/get_eval_set.py``. Mirrors
``tests/test_data_pipeline.py`` and the CHiME-6 case of
``tests/test_eval_harness.py``: each test feeds the JAX package's function
and the port's the same seeded inputs (the same rows, or the same files in
two ``tmp_path`` trees) and wants equal outputs: rows, tags, written files,
reports, percentiles, resegmented YODAS rows and the CHiME-6 segments.

Nothing is downloaded: ``get_eval_set`` is reached through its offline
branches (an archive already in place is only extracted; the licensed sets
raise), ``materialize_hf_set`` reads a stub ``datasets`` module, and the
audio language id takes an injected classifier (no speechbrain, no network).
"""

from __future__ import annotations

import gzip
import io
import json
import os
import sys
import tarfile
import types
import zipfile

import numpy as np
import pytest
import scipy.io.wavfile as wavfile

from olmoasr_tpu.data import audio_lang as j_lang
from olmoasr_tpu.data import filtering as j_filter
from olmoasr_tpu.data import jsonl as j_jsonl
from olmoasr_tpu.data import qa_video as j_qa
from olmoasr_tpu.data import sampling as j_sampling
from olmoasr_tpu.data import tagging as j_tag
from olmoasr_tpu.data import yodas as j_yodas
from olmoasr_tpu.eval import get_eval_set as j_get

from olmoasr_tpu_torch.data import audio_lang as t_lang
from olmoasr_tpu_torch.data import filtering as t_filter
from olmoasr_tpu_torch.data import jsonl as t_jsonl
from olmoasr_tpu_torch.data import qa_video as t_qa
from olmoasr_tpu_torch.data import sampling as t_sampling
from olmoasr_tpu_torch.data import tagging as t_tag
from olmoasr_tpu_torch.data import yodas as t_yodas
from olmoasr_tpu_torch.eval import get_eval_set as t_get

VTT = """WEBVTT

00:00:00.000 --> 00:00:02.000
Hello there, my friend.

00:00:02.000 --> 00:00:04.000
This is mixed case text.
"""

VTT_UPPER = """WEBVTT

00:00:00.000 --> 00:00:02.000
ALL SHOUTING HERE

00:00:02.000 --> 00:00:04.000
STILL SHOUTING
"""

VTT_REPEAT = """WEBVTT

00:00:00.000 --> 00:00:02.000
the same line here

00:00:02.000 --> 00:00:04.000
the same line here again
"""

SRT = "1\n00:00:00,000 --> 00:00:03,000\nsome text\n\n2\n00:00:03,000 --> 00:00:05,500\nmore. text\n"
CONTENTS = [VTT, VTT_UPPER, VTT_REPEAT, VTT.replace("This is", "this is"),
            VTT.replace(",", ""), "WEBVTT\n\n00:00:00.000 --> 00:00:01.000\nJohn : hi &nbsp; x\n",
            ""]
TEXTS = ["the quick brown fox is in the barn and it was not alone", "这是一段中文文本内容测试",
         "это русский текст для теста", "", "12345 !!!", "Bonjour tout le monde, ça va",
         "한국어 텍스트", "日本語のテキスト", "مرحبا بالعالم", "नमस्ते दुनिया", "I I I you"]
PAIRS = [(j_jsonl, t_jsonl), (j_sampling, t_sampling), (j_filter, t_filter), (j_tag, t_tag),
         (j_lang, t_lang), (j_qa, t_qa), (j_yodas, t_yodas), (j_get, t_get)]


def row(content, **kw):
    return {"id": "v", "seg_content": content, "norm_end": 4000, "ext": "vtt", **kw}


def _rows(seed: int = 0, n: int = 24):
    """Seeded rows over CONTENTS with manual and machine texts and tags."""
    rng = np.random.default_rng(seed)
    words = ["hello", "there", "my", "friend", "mixed", "case", "text", "Hello", "world."]
    rows = []
    for i in range(n):
        man = " ".join(rng.choice(words, rng.integers(0, 6)))
        mach = " ".join(rng.choice(words, rng.integers(0, 6)))
        rows.append(row(CONTENTS[i % len(CONTENTS)], id=f"v{i}", man_text=man, mach_text=mach,
                        edit_dist=float(rng.uniform(0, 1)), casing=str(rng.choice(
                            ["mixed", "upper", "lower"])), has_comma_period=bool(i % 2),
                        num_words=int(rng.integers(0, 40))))
    return rows


def _write_jsonl(path, rows) -> str:
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wt", encoding="utf-8") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    return str(path)


def _read_tree(root) -> dict:
    """relative path -> bytes (gzip files decompressed) of every file under
    ``root``."""
    out = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            with (gzip.open if name.endswith(".gz") else open)(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def test_the_copies_keep_their_originals_names():
    """Every public name of an original is in its copy, with the same
    constants."""
    for j, t in PAIRS:
        names = {n for n in vars(j) if not n.startswith("__") and not isinstance(
            getattr(j, n), types.ModuleType)}
        assert names <= set(vars(t)), (t.__name__, names - set(vars(t)))
    assert t_filter.ESSENTIAL_KEYS == j_filter.ESSENTIAL_KEYS
    assert t_tag._EN_STOPWORDS == j_tag._EN_STOPWORDS
    assert set(t_tag.TAGGING_FUNCTIONS) == set(j_tag.TAGGING_FUNCTIONS)
    assert (t_get.URLS, t_get.HF_SETS, t_get.CHIME6_URLS) == \
        (j_get.URLS, j_get.HF_SETS, j_get.CHIME6_URLS)


# ---------------------------------------------------------------------------
# tagging
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("content", CONTENTS + [SRT])
def test_apply_tags_matches(content):
    ext = "srt" if content is SRT else "vtt"
    r = row(content, ext=ext, man_text="hello world", mach_text="hello word")
    tags = list(j_tag.TAGGING_FUNCTIONS)
    assert t_tag.apply_tags(dict(r), tags) == j_tag.apply_tags(dict(r), tags)
    assert [c.text for c in t_tag.cues_from_row(r)] == [c.text for c in j_tag.cues_from_row(r)]
    assert t_tag.row_length(r) == j_tag.row_length(r)


def test_tag_edit_dist_and_language_match():
    for r in _rows(1):
        assert t_tag.tag_edit_dist(r) == j_tag.tag_edit_dist(r), r
    for man, mach in (("", ""), ("", "x y"), ("   ", "hello"), ("hello world", "")):
        r = row("", man_text=man, mach_text=mach)
        assert t_tag.tag_edit_dist(r) == j_tag.tag_edit_dist(r), (man, mach)
    for text in TEXTS:
        assert t_tag.detect_text_language(text) == j_tag.detect_text_language(text), text
        assert t_tag.tag_text_lang({"content": text}) == j_tag.tag_text_lang({"content": text})
    with pytest.raises(KeyError, match="unknown tag"):
        t_tag.apply_tags(row(VTT), ["no_such_tag"])


def test_tagging_main_and_config_match(tmp_path):
    cfg = tmp_path / "tags.yaml"
    cfg.write_text("tags:\n  - tag: casing\n  - edit_dist\n  - tag: num_words\n"
                   "  - tag: repeating_lines\n")
    assert t_tag.load_tag_config(str(cfg)) == j_tag.load_tag_config(str(cfg))
    shards = [_write_jsonl(tmp_path / f"s{i}.jsonl.gz", _rows(i, 9)) for i in range(2)]
    reports = {}
    for name, mod in (("jax", j_tag), ("port", t_tag)):
        reports[name] = mod.main(shards, str(tmp_path / name), tag_config=str(cfg))
    assert reports["port"] == reports["jax"] and reports["jax"]["rows"] == 18
    assert _read_tree(tmp_path / "port") == _read_tree(tmp_path / "jax")
    with pytest.raises(ValueError, match="no tags"):
        t_tag.main(shards, str(tmp_path / "none"), tags=[])


# ---------------------------------------------------------------------------
# filtering
# ---------------------------------------------------------------------------

RULES = [
    dict(tag="casing", values=("mixed", "lower")),
    dict(tag="casing", not_values=("upper",)),
    dict(tag="edit_dist", bounds=(None, 0.5)),
    dict(tag="edit_dist", bounds=(0.2, None)),
    dict(tag="num_words", comparison="ge", ref_value=10),
    dict(tag="num_words", comparison="lt", ref_value=30),
    dict(tag="has_comma_period", ref_value=True),
    dict(tag="not_a_tag", ref_value=1),
]


@pytest.mark.parametrize("rules", [RULES[:3], RULES[2:7], RULES[1:2] + RULES[4:6], RULES])
def test_filter_row_matches(rules):
    jr = [j_filter.FilterRule(**r) for r in rules]
    tr = [t_filter.FilterRule(**r) for r in rules]
    # the rows of _rows, and rows on the bounds' and comparisons' edges
    edges = [dict(r, edit_dist=e, num_words=n) for r in _rows(3, 2)
             for e, n in ((0.2, 10), (0.5, 30), (0.2, 29), (0.5, 9))]
    for r in _rows(2) + edges:
        assert t_filter.filter_row(r, tr) == j_filter.filter_row(r, jr), r


def test_clean_seg_content_matches():
    for content in CONTENTS + [SRT, "WEBVTT\n\n1\n00:00:00.000 --> 00:00:02.000\n"
                                    "Mr Smith : a &amp; b ... c \\h d\n"]:
        assert t_filter.clean_seg_content(content) == j_filter.clean_seg_content(content)


@pytest.mark.parametrize("subsample", [None, 0.5])
def test_filtering_main_and_shard_match(tmp_path, subsample):
    cfg = tmp_path / "filter.yaml"
    cfg.write_text("filters:\n"
                   "  - tag: casing\n    values: [mixed, lower]\n"
                   "  - tag: edit_dist\n    bounds: [0, 0.8]\n"
                   "  - tag: num_words\n    comparison: gt\n    ref_value: 3\n")
    assert t_filter.load_filter_config(str(cfg)) == [
        t_filter.FilterRule(**vars(r)) for r in j_filter.load_filter_config(str(cfg))]
    shards = [_write_jsonl(tmp_path / f"s{i}.jsonl.gz", _rows(10 + i)) for i in range(2)]
    out = {}
    for name, mod in (("jax", j_filter), ("port", t_filter)):
        out[name] = (mod.main(shards, str(tmp_path / name), str(cfg), subsample=subsample),
                     mod.process_single_jsonl_file(shards[0], str(tmp_path / f"{name}_one"),
                                                   mod.load_filter_config(str(cfg)),
                                                   subsample=subsample, keep_keys=["id"]))
    assert out["port"] == out["jax"] and 0 < out["jax"][0]["kept"] < 48
    for name in ("", "_one"):
        assert _read_tree(tmp_path / f"port{name}") == _read_tree(tmp_path / f"jax{name}")


# ---------------------------------------------------------------------------
# sampling and jsonl
# ---------------------------------------------------------------------------


def test_reservoir_sampling_and_percentiles_match(tmp_path):
    rng = np.random.default_rng(4)
    shards = []
    for i in range(3):
        rows = [{"edit_dist": float(v)} for v in rng.uniform(0, 1, 700)]
        rows += [{"edit_dist": "x"}, {"other": 1}, {"edit_dist": None}]
        shards.append(_write_jsonl(tmp_path / (f"s{i}.jsonl" + (".gz" if i else "")), rows))
    for k, seed in ((50, 0), (500, 3), (2000, 1)):
        assert t_sampling.reservoir_sample_file(shards[1], "edit_dist", k, seed) == \
            j_sampling.reservoir_sample_file(shards[1], "edit_dist", k, seed)
    for values in ([], [1.0], list(rng.standard_normal(101))):
        assert t_sampling.calculate_percentiles(values) == \
            j_sampling.calculate_percentiles(values)
    tables = [mod.main(shards, "edit_dist", k_per_shard=300,
                       out_path=str(tmp_path / f"{mod.__name__}.json"))
              for mod in (j_sampling, t_sampling)]
    assert tables[0] == tables[1] and tables[0]["n"] == 900
    assert (tmp_path / f"{t_sampling.__name__}.json").read_text() == \
        (tmp_path / f"{j_sampling.__name__}.json").read_text()


def test_text_to_jsonl_matches(tmp_path):
    d = tmp_path / "transcripts"
    (d / "sub").mkdir(parents=True)
    (d / "vid1.vtt").write_text(VTT)
    (d / "sub" / "vid2.srt").write_text(SRT)
    (d / "empty.vtt").write_text("WEBVTT\n")
    (d / "broken.srt").write_bytes(b"\xff\xfe garbage")
    for p in sorted(d.rglob("*.*")):
        assert t_jsonl.video_row(str(p)) == j_jsonl.video_row(str(p)), p
    counts = [mod.text_to_jsonl(str(d), str(tmp_path / f"{name}.jsonl.gz"))
              for name, mod in (("jax", j_jsonl), ("port", t_jsonl))]
    assert counts[0] == counts[1] >= 2
    trees = _read_tree(tmp_path)
    assert trees["port.jsonl.gz"] == trees["jax.jsonl.gz"]


# ---------------------------------------------------------------------------
# audio language id
# ---------------------------------------------------------------------------


def _classify(wav: np.ndarray) -> str:
    """A classifier of the samples themselves, so that both packages must
    read the same audio: a language by its RMS, and the RMS's digits."""
    rms = float(np.sqrt(np.mean(wav.astype(np.float64) ** 2)))
    return f"{'en' if rms > 0.05 else 'fr'}:{rms:.17g}"


def test_audio_language_id_and_assignment_match(tmp_path):
    rng = np.random.default_rng(5)
    segments = []
    for i in range(7):
        vid = f"vid{i % 3}"
        pcm = (rng.standard_normal(4000) * (3000 if i % 2 else 600)).astype(np.int16)
        if i % 3 == 2:
            path = str(tmp_path / f"seg{i}.wav")
            wavfile.write(path, 16000, pcm)
        else:
            path = str(tmp_path / f"seg{i}.npy")
            np.save(path, pcm)
        segments.append((vid, path))
    for max_per_video in (1, 2, 5):
        assert t_lang.identify_segment_languages(segments, _classify,
                                                 max_per_video=max_per_video) == \
            j_lang.identify_segment_languages(segments, _classify, max_per_video=max_per_video)
    lang_map = j_lang.identify_segment_languages(segments, _classify)
    assert {v.split(":")[0] for v in lang_map.values()} == {"en", "fr"}
    for name, mod in (("jax", j_lang), ("port", t_lang)):
        mod.write_lang_map(lang_map, str(tmp_path / f"{name}_map.json.gz"))
    assert t_lang.load_lang_map(str(tmp_path / "jax_map.json.gz")) == lang_map
    assert j_lang.load_lang_map(str(tmp_path / "port_map.json.gz")) == lang_map
    rows = [dict(r, id=f"vid{i % 4}") for i, r in enumerate(_rows(6, 8))]
    rows[3] = {"video_id": "vid1", "x": 1}
    shards = [_write_jsonl(tmp_path / "a.jsonl.gz", rows), _write_jsonl(tmp_path / "b.jsonl",
                                                                        rows[:3])]
    counts = [mod.main(shards, str(tmp_path / f"{name}_map.json.gz"), str(tmp_path / name))
              for name, mod in (("jax", j_lang), ("port", t_lang))]
    assert counts[0] == counts[1] == 11
    assert _read_tree(tmp_path / "port") == _read_tree(tmp_path / "jax")


# ---------------------------------------------------------------------------
# QA bundles
# ---------------------------------------------------------------------------


def test_gen_video_samples_matches(tmp_path):
    rng = np.random.default_rng(7)
    rows = []
    for i in range(6):
        r = row(CONTENTS[i % 3], id=f"v{i}", seg_id=f"v{i}_0")
        if i % 2:
            r["audio_file"] = str(tmp_path / f"a{i}.npy")
            np.save(r["audio_file"], (rng.standard_normal(1600) * 1000).astype(np.int16))
        rows.append(r)
    shards = [_write_jsonl(tmp_path / "s0.jsonl.gz", rows[:4]), _write_jsonl(tmp_path / "s1.jsonl",
                                                                             rows[4:])]
    outs = {name: mod.gen_video_samples(shards, str(tmp_path / name), n_samples=4, seed=3)
            for name, mod in (("jax", j_qa), ("port", t_qa))}
    assert [os.path.basename(p) for p in outs["port"]] == \
        [os.path.basename(p) for p in outs["jax"]] == [f"sample_{i:04d}" for i in range(4)]
    trees = {name: _read_tree(tmp_path / name) for name in outs}
    assert trees["port"] == trees["jax"] and any(k.endswith(".wav") for k in trees["jax"])
    r = dict(rows[1])
    assert t_qa.generate_video(r, str(tmp_path / "port"), 9) is None  # no moviepy here
    assert j_qa.generate_video(r, str(tmp_path / "jax"), 9) is None


# ---------------------------------------------------------------------------
# YODAS resegmentation
# ---------------------------------------------------------------------------


def _yodas_row(seed: int, n: int = 14, with_audio: bool = True, hf_audio: bool = False) -> dict:
    rng = np.random.default_rng(seed)
    words = ["yodas", "speech", "rows", "again", "longer", "segment", "text"]
    ts, t = [], 0.0
    texts = []
    for i in range(n):
        dur = float(rng.uniform(0.5, 9.0)) if i != 5 else 31.0  # one utterance over 30 s
        ts.append((round(t, 2), round(t + dur, 2)))
        t += dur + float(rng.uniform(0, 1.5))
        texts.append(" ".join(rng.choice(words, rng.integers(1, 12))))
    row = {"utt_id": f"utt{seed}", "text": texts, "ts": ts, "dur": t}
    if with_audio:
        audio = (rng.standard_normal(int(t * 16000) + 16000) * 0.1).astype(np.float32)
        row["audio"] = {"array": audio, "sampling_rate": 16000} if hf_audio else audio
    return row


@pytest.mark.parametrize("with_audio,hf_audio", [(True, False), (True, True), (False, False)])
def test_reseg_row_matches(with_audio, hf_audio):
    r = _yodas_row(8, with_audio=with_audio, hf_audio=hf_audio)
    got, want = t_yodas.reseg_row(r), j_yodas.reseg_row(r)
    assert len(got) == len(want) >= 3
    for g, w in zip(got, want):
        assert g.to_dict() == w.to_dict()
        assert (g.audio is None) == (w.audio is None) == (not with_audio)
        if with_audio:
            np.testing.assert_array_equal(g.audio, w.audio)
    assert all(seg.end_s - seg.start_s <= 30.0 for seg in got)


def test_process_arrow_file_matches(tmp_path):
    import pyarrow as pa

    # the HF layout's audio struct (a bare list column would be sliced as a
    # list, in both packages alike)
    rows = [_yodas_row(s, n=6, hf_audio=True) for s in (20, 21)]
    for r in rows:
        r["audio"]["array"] = r["audio"]["array"].tolist()
    table = pa.Table.from_pylist(rows)
    path = str(tmp_path / "shard.arrow")
    with pa.OSFile(path, "wb") as sink, pa.ipc.new_stream(sink, table.schema) as writer:
        writer.write_table(table)
    counts = [mod.main([path], str(tmp_path / name))
              for name, mod in (("jax", j_yodas), ("port", t_yodas))]
    assert counts[0] == counts[1] > 0
    trees = {name: _read_tree(tmp_path / name) for name in ("jax", "port")}
    assert trees["port"] == trees["jax"] and any(k.endswith(".npy") for k in trees["jax"])


# ---------------------------------------------------------------------------
# eval sets, offline
# ---------------------------------------------------------------------------


def _chime6_tree(root, layout: str):
    """A CHiME-6 session with two worn mics in ``layout`` ("transcripts" or
    the archive's "transcriptions/eval"), per-device timestamp dicts on one
    utterance."""
    rate = 16000
    (root / "audio").mkdir(parents=True)
    tdir = root / ("transcripts" if layout == "transcripts" else "transcriptions/eval")
    tdir.mkdir(parents=True)
    wav = (np.arange(rate * 12) % 32000 - 16000).astype(np.int16)
    wavfile.write(str(root / "audio" / "S01_P01.wav"), rate, wav)
    wavfile.write(str(root / "audio" / "S01_P02.wav"), rate, np.stack([wav[::-1], wav], 1))
    utts = [
        {"words": "hello [noise] world", "start_time": "0:00:01.0", "end_time": "0:00:03.5",
         "speaker": "P01"},
        {"words": "[noise]", "start_time": "0:00:04", "end_time": "0:00:05"},
        {"words": "second   utterance", "start_time": "0:00:06", "end_time": "0:00:08",
         "speaker": "P02"},
        {"words": "by device", "start_time": {"P02": "0:00:02", "U01": "0:00:03"},
         "end_time": {"P02": "0:00:04.25", "U01": "0:00:05"}, "speaker": "P02"},
        {"words": "backwards", "start_time": "5.0", "end_time": "4.0"},
        {"words": "no speaker mic", "start_time": "9", "end_time": "11", "speaker": "P09"},
    ]
    (tdir / "S01.json").write_text(json.dumps(utts))
    (tdir / "S02.json").write_text(json.dumps(utts[:1]))  # a session without audio


@pytest.mark.parametrize("layout", ["transcripts", "transcriptions"])
def test_segment_chime6_matches(tmp_path, layout):
    for name in ("jax", "port"):
        _chime6_tree(tmp_path / name, layout)
    manifests = [mod.segment_chime6(str(tmp_path / name))
                 for name, mod in (("jax", j_get), ("port", t_get))]
    assert [os.path.basename(m) for m in manifests] == ["chime6_segments.jsonl"] * 2
    trees = {name: _read_tree(tmp_path / name) for name in ("jax", "port")}
    assert trees["port"] == trees["jax"]
    rows = [json.loads(line) for line in open(manifests[1])]
    assert [r["text"] for r in rows] == ["hello world", "second utterance", "by device",
                                         "no speaker mic"]


def _tar_gz(path, members: dict) -> None:
    with tarfile.open(path, "w:gz") as tar:
        for name, data in members.items():
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))


def test_get_eval_set_offline_branches_match(tmp_path):
    """A corpus archive already in place is extracted, not downloaded; the
    CHiME-6 archives in place are extracted, laid out and segmented; the
    licensed sets and an unknown name raise alike."""
    wav = io.BytesIO()
    wavfile.write(wav, 16000, (np.arange(16000 * 10) % 2000).astype(np.int16))
    utts = [{"words": "hello world", "start_time": "0:00:01", "end_time": "0:00:02",
             "speaker": "P01"}]
    for name in ("jax", "port"):
        ls = tmp_path / name / "librispeech_clean"
        ls.mkdir(parents=True)
        _tar_gz(ls / "test-clean.tar.gz", {"LibriSpeech/test-clean/1/2/1-2.trans.txt": b"1-2-0 A"})
        with zipfile.ZipFile(tmp_path / name / "k.zip", "w") as z:
            z.writestr(zipfile.ZipInfo("kincaid/a.txt", date_time=(2020, 1, 1, 0, 0, 0)), "x")
        chime = tmp_path / name / "chime6"
        chime.mkdir()
        _tar_gz(chime / "CHiME6_eval.tar.gz", {
            "CHiME6_eval/CHiME6/audio/eval/S01_P01.wav": wav.getvalue(),
            "CHiME6_eval/CHiME6/audio/eval/S01_U01.CH1.wav": wav.getvalue()})
        _tar_gz(chime / "CHiME6_transcriptions.tar.gz", {
            "transcriptions/transcriptions/eval/S01.json": json.dumps(utts).encode()})
    for name, mod in (("jax", j_get), ("port", t_get)):
        root = str(tmp_path / name)
        assert mod.get_eval_set("librispeech_clean", root) == os.path.join(
            root, "librispeech_clean")
        assert mod.download_and_extract("file:///nowhere/k.zip", root) == root
        assert mod.get_eval_set("chime6", root) == os.path.join(root, "chime6")
        for licensed in ("wsj", "callhome", "switchboard", "coraal"):
            with pytest.raises(NotImplementedError, match="manual"):
                mod.get_eval_set(licensed, root)
        with pytest.raises(ValueError, match="unknown eval set"):
            mod.get_eval_set("nope", root)
    trees = {name: _read_tree(tmp_path / name) for name in ("jax", "port")}
    assert trees["port"] == trees["jax"]
    assert "chime6/chime6_segments.jsonl" in trees["port"]
    assert not any("_U01" in k for k in trees["port"])


def test_materialize_hf_set_matches(tmp_path, monkeypatch):
    rows = [{"audio": {"array": np.sin(np.arange(8000 + 800 * i) / (3 + i)) * 0.5,
                       "sampling_rate": 16000}, "transcription": f"utterance {i}"}
            for i in range(5)]
    calls = []

    def load_dataset(path, config, split=None, trust_remote_code=None):
        calls.append((path, config, split))
        return rows

    monkeypatch.setitem(sys.modules, "datasets", types.SimpleNamespace(load_dataset=load_dataset))
    for name, mod in (("jax", j_get), ("port", t_get)):
        manifest = mod.materialize_hf_set("fleurs", str(tmp_path / name), max_samples=3)
        assert manifest == str(tmp_path / name / "fleurs.jsonl")
        assert mod.get_eval_set("rev16", str(tmp_path / f"{name}_all")) == \
            str(tmp_path / f"{name}_all" / "rev16")
    assert calls == [("google/fleurs", "en_us", "test"),
                     ("distil-whisper/rev16", "whisper_subset", "test")] * 2
    for suffix in ("", "_all"):
        trees = {name: _read_tree(tmp_path / f"{name}{suffix}") for name in ("jax", "port")}
        assert trees["port"] == trees["jax"]
    assert len([k for k in _read_tree(tmp_path / "port") if k.endswith(".wav")]) == 3
