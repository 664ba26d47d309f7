"""The port's evaluation (``olmoasr_tpu_torch.eval``, ``normalizers``) against
the JAX package's, on the CPU.

The copied modules are pinned to their originals on the same inputs: the
WER (``compute_measures`` on seeded and edge-case pairs), the normalizers
(every string of ``tests/test_normalizers.py`` and seeded text), the
spelling asset (byte-equal files and mappings), every local loader on the
synthetic trees of ``tests/test_eval_harness.py`` (LibriSpeech, manifest,
CHiME-6, Hub5 remixed from a sphere file, WSJ, the CORAAL cleaner), the HF
loader with ``datasets`` stubbed, ``bootstrap_ci``, ``analysis`` and
``figures.wer_table``.

Then the harness: one micro model's weights (the token embedding's text rows
past the 256 byte tokens zeroed, so that hypotheses have text) in both
packages at fp32, each model's ``decode`` wrapped to ``fp16=False`` and a
short ``sample_len``, and for ``long_form_eval`` each package's
``transcribe_many`` wrapped with the gates off (every window decides at t=0
by beam search, as ``test_long_form_beam_search_matches_jax`` runs it).
``short_form_eval`` with a ragged last batch (the JAX package pads it, the
port does not) and ``long_form_eval`` give the same per-sample hypotheses,
references and WERs, and ``write_results`` the same files apart from the
real-time factor. The port computes the log-mel with ``torch.stft``, the JAX
package with NumPy; the greedy choices these weights make lead their
runner-up by far more than that difference moves a logit, as
``tests/test_torch_transcribe.py`` measures for the same model family.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import json
import os
import shutil
import sys
import types

import jax
import numpy as np
import pytest
import scipy.io.wavfile as wavfile
import torch

import olmoasr_tpu.eval.analysis as janalysis
import olmoasr_tpu.eval.datasets as jds
import olmoasr_tpu.eval.figures as jfigures
import olmoasr_tpu.eval.harness as jharness
import olmoasr_tpu.eval.wer as jwer
import olmoasr_tpu.normalizers as jnorm
import olmoasr_tpu.normalizers.build_spelling as jbuild
import olmoasr_tpu.transcribe as jtranscribe
from olmoasr_tpu.api import OLMoASR as JaxOLMoASR
from olmoasr_tpu.models import whisper as jm
from olmoasr_tpu.models.convert import params_to_torch_state_dict
from olmoasr_tpu.models.dims import ModelDimensions

import olmoasr_tpu_torch.eval.analysis as tanalysis
import olmoasr_tpu_torch.eval.datasets as tds
import olmoasr_tpu_torch.eval.figures as tfigures
import olmoasr_tpu_torch.eval.harness as tharness
import olmoasr_tpu_torch.eval.wer as twer
import olmoasr_tpu_torch.normalizers as tnorm
import olmoasr_tpu_torch.normalizers.build_spelling as tbuild
import olmoasr_tpu_torch.transcribe as ttranscribe
from olmoasr_tpu_torch.api import _new_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = ("hello", "world", "colour", "twenty", "one", "the", "speech", "model", "mr", "doctor",
         "it's", "don't", "$5", "1st", "percent", "point", "five", "uh", "um", "neighbour",
         "organise", "[noise]", "(laughs)", "naïve", "café", "o'clock", "we'll", "thousand")


def _random_text(rng, n_words: int) -> str:
    words = rng.choice(WORDS, n_words)
    return " ".join(w.upper() if rng.random() < 0.2 else w for w in words)


# ---------------------------------------------------------------------------
# the WER and the normalizers
# ---------------------------------------------------------------------------

EDGE_PAIRS = [("", ""), ("hello world", ""), ("", "hello world"), ("a b c", "a b c"),
              ("a b c d", "a x c"), ("the cat sat", "cat sat on the mat"), ("x", "y z x")]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compute_measures_matches(seed):
    rng = np.random.default_rng(seed)
    pairs = EDGE_PAIRS + [(_random_text(rng, int(rng.integers(0, 12))),
                           _random_text(rng, int(rng.integers(0, 12)))) for _ in range(20)]
    for ref, hyp in pairs:
        got, want = twer.compute_measures(ref, hyp), jwer.compute_measures(ref, hyp)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), (ref, hyp)
        assert got.mer == want.mer and twer.wer(ref, hyp) == jwer.wer(ref, hyp)
        assert twer._edit_ops(ref.split(), hyp.split()) == jwer._edit_ops(ref.split(), hyp.split())
    refs, hyps = [p[0] for p in pairs], [p[1] for p in pairs]
    assert dataclasses.asdict(twer.compute_measures(refs, hyps)) == \
        dataclasses.asdict(jwer.compute_measures(refs, hyps))
    assert twer.calculate_wer(pairs) == jwer.calculate_wer(pairs)
    assert twer.calculate_wer([]) == jwer.calculate_wer([]) == 0.0


def _normalizer_cases():
    """Every string literal of tests/test_normalizers.py, then seeded text."""
    with open(os.path.join(REPO, "tests", "test_normalizers.py"), encoding="utf-8") as f:
        tree = ast.parse(f.read())
    cases = sorted({n.value for n in ast.walk(tree)
                    if isinstance(n, ast.Constant) and isinstance(n.value, str)})
    rng = np.random.default_rng(0)
    return cases + [_random_text(rng, int(rng.integers(1, 15))) for _ in range(40)]


def test_normalizers_match():
    cases = _normalizer_cases()
    assert len(cases) > 200
    pairs = [(tnorm.EnglishTextNormalizer(), jnorm.EnglishTextNormalizer()),
             (tnorm.EnglishNumberNormalizer(), jnorm.EnglishNumberNormalizer()),
             (tnorm.EnglishSpellingNormalizer(), jnorm.EnglishSpellingNormalizer()),
             (tnorm.BasicTextNormalizer(), jnorm.BasicTextNormalizer()),
             (tnorm.BasicTextNormalizer(remove_diacritics=True),
              jnorm.BasicTextNormalizer(remove_diacritics=True))]
    for text in cases:
        for port, ref in pairs:
            assert port(text) == ref(text), (type(port).__name__, text)
        assert tnorm.remove_symbols(text) == jnorm.remove_symbols(text)
        assert tnorm.remove_symbols_and_diacritics(text) == \
            jnorm.remove_symbols_and_diacritics(text)


def test_spelling_asset_is_the_jax_packages(tmp_path, monkeypatch):
    """The two english.json files byte-equal, the port reads its own, the
    override still wins, and build_spelling writes the port's asset."""
    port_asset = os.path.join(REPO, "olmoasr_tpu_torch", "assets", "english.json")
    with open(port_asset, "rb") as f, \
            open(os.path.join(REPO, "olmoasr_tpu", "assets", "english.json"), "rb") as g:
        assert f.read() == g.read()
    with open(port_asset, encoding="utf-8") as f:
        assert tnorm.EnglishSpellingNormalizer().mapping == json.load(f)
    assert tbuild.build_mapping() == jbuild.build_mapping()
    override = tmp_path / "spell.json"
    override.write_text(json.dumps({"colour": "KOLOR"}))
    monkeypatch.setenv("OLMOASR_SPELLING_JSON", str(override))
    assert tnorm.EnglishSpellingNormalizer()("colour me") == \
        jnorm.EnglishSpellingNormalizer()("colour me") == "KOLOR me"
    written = {}

    class Sink(io.StringIO):  # build_spelling's output, kept off the disk
        def __init__(self, path, *args, **kw):
            super().__init__()
            self.path = path

        def close(self):
            written[self.path] = self.getvalue()
            super().close()

    monkeypatch.setattr(tbuild, "open", Sink, raising=False)
    tbuild.main()
    (path, text), = written.items()
    assert os.path.samefile(path, port_asset) and json.loads(text) == jbuild.build_mapping()


# ---------------------------------------------------------------------------
# the loaders
# ---------------------------------------------------------------------------


def _librispeech_tree(root, n=5, seed=0, seconds=(1.0, 3.0)):
    chap = root / "LibriSpeech" / "test-clean" / "19" / "198"
    chap.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        utt = f"19-198-{i:04d}"
        wav = (rng.standard_normal(int(16000 * rng.uniform(*seconds))) * 1000).astype(np.int16)
        wavfile.write(str(chap / f"{utt}.wav"), 16000, wav)
        lines.append(f"{utt} {_random_text(rng, int(rng.integers(2, 8))).upper()}")
    (chap / "19-198.trans.txt").write_text("\n".join(lines))
    return str(root)


def _sphere(path, a, b):
    inter = np.empty(2 * len(a), "<i2")
    inter[0::2], inter[1::2] = a, b
    header = (b"NIST_1A\n   1024\nchannel_count -i 2\nsample_rate -i 8000\n"
              b"sample_coding -s3 pcm\nend_head\n")
    with open(path, "wb") as f:
        f.write(header.ljust(1024, b" "))
        f.write(inter.tobytes())


def _trees(root):
    """One directory per loader, as tests/test_eval_harness.py builds them."""
    ls = _librispeech_tree(root / "ls")
    man = root / "man"
    man.mkdir()
    wavfile.write(str(man / "a.wav"), 16000, np.zeros(8000, np.int16))
    (man / "set.jsonl").write_text(
        json.dumps({"audio": "a.wav", "text": "some text", "id": "0"}) + "\n"
        + json.dumps({"audio": "a.wav", "text": "cut", "start": 0.1, "end": 0.3}) + "\n")
    ch = root / "chime"
    (ch / "transcriptions" / "eval").mkdir(parents=True)
    (ch / "audio" / "eval").mkdir(parents=True)
    wavfile.write(str(ch / "audio" / "eval" / "S01_P01.wav"), 16000, np.zeros(16000 * 20, np.int16))
    (ch / "transcriptions" / "eval" / "S01.json").write_text(json.dumps([
        {"start_time": "0:00:01.00", "end_time": "0:00:03.50", "words": "hello there [noise]",
         "speaker": "P01"},
        {"start_time": "0:00:04.00", "end_time": "0:00:05.00", "words": "[laughs]",
         "speaker": "P02"}]))
    hub = root / "hub5"
    (hub / "hub5e_00" / "english").mkdir(parents=True)
    rng = np.random.default_rng(1)
    _sphere(hub / "hub5e_00" / "english" / "en_4093.sph",
            (rng.standard_normal(8000) * 1000).astype("<i2"),
            (rng.standard_normal(8000) * 1000).astype("<i2"))
    (hub / "hub5e00.english.000405.stm").write_text(
        ";; header\n"
        "en_4093 A en_4093_A 0.20 0.90 <o,en,f> HELLO THERE\n"
        "en_4093 B en_4093_B 0.30 0.70 <o,en,m> BACK AGAIN\n"
        "sw_2001 B sw_2001_B 1.00 2.00 <o,sw,m> SWITCHBOARD LINE\n")
    wsj = root / "wsj"
    wsj.mkdir()
    (wsj / "wav.scp").write_text("u1 /data/u1.wav\nu2 /data/u2.wav\n")
    (wsj / "text").write_text("u1 THE TEXT\nu3 MISSING AUDIO\nu2 MORE\n")
    return {"librispeech_clean": ls, "set": str(man), "chime6": str(ch), "callhome": str(hub),
            "switchboard": str(hub), "wsj": str(wsj)}


def _items(mod, eval_set, root):
    out = []
    for it in mod.DatasetFactory.create_loader(eval_set, root).load():
        d = dataclasses.asdict(it)
        d["audio"] = os.path.relpath(d["audio"], root)
        out.append(d)
    return out


def test_loaders_give_the_same_items(tmp_path, monkeypatch):
    """Each package on its own copy of the trees (Hub5 writes its remixed
    channels into the tree); the remix's native path forced."""
    monkeypatch.setattr(shutil, "which", lambda name, *a, **k: None)
    trees = {}
    for name in ("jax", "port"):
        (tmp_path / name).mkdir()
        trees[name] = _trees(tmp_path / name)
    n = 0
    for eval_set in trees["jax"]:
        want = _items(jds, eval_set, trees["jax"][eval_set])
        got = _items(tds, eval_set, trees["port"][eval_set])
        assert got == want, eval_set
        n += len(want)
    assert n >= 11
    for ch in ("A", "B"):
        wavs = [wavfile.read(os.path.join(trees[k]["callhome"], "wav", f"en_4093_{ch}.wav"))[1]
                for k in ("jax", "port")]
        assert np.array_equal(*wavs)
    for text in ("so [laugh] I went (pause 0.5) there", "um you know uh", "<ts> a /b/ c"):
        assert tds.clean_coraal_text(text) == jds.clean_coraal_text(text)
    assert tds.HF_DATASET_CONFIGS == jds.HF_DATASET_CONFIGS
    assert tds.LONG_FORM_SETS == jds.LONG_FORM_SETS
    for name in ("librispeech_other", "artie", "tedlium", "tedlium_long", "coraal", "coraal_long",
                 "ami_ihm", "ami_sdm", "kincaid46", "fleurs", "rev16"):
        assert type(tds.DatasetFactory.create_loader(name, str(tmp_path))).__name__ == \
            type(jds.DatasetFactory.create_loader(name, str(tmp_path))).__name__


def test_hf_loader_matches(monkeypatch, tmp_path):
    """HFDatasetLoader with ``datasets`` stubbed, as
    test_hf_dataset_loader_monkeypatched runs it; and the same error where
    the package is missing."""

    class FakeDS:
        column_names = ["audio", "transcription"]

        def __init__(self, rows):
            self.rows = rows

        def cast_column(self, name, typ):
            return self

        def remove_columns(self, cols):
            return self

        def __len__(self):
            return len(self.rows)

        def __getitem__(self, i):
            return self.rows[i]

    rng = np.random.default_rng(0)
    rows = [{"audio": {"array": rng.standard_normal(n), "sampling_rate": 16000},
             "transcription": t} for n, t in ((16000, "hello world"), (8000, ""), (4000, "again"))]
    monkeypatch.setitem(sys.modules, "datasets", types.SimpleNamespace(
        load_dataset=lambda **kw: FakeDS(rows), Audio=lambda **kw: None))
    got = tds.HFDatasetLoader(str(tmp_path), "fleurs").load()
    want = jds.HFDatasetLoader(str(tmp_path), "fleurs").load()
    assert [(i.text, i.id) for i in got] == [(i.text, i.id) for i in want] and len(got) == 2
    for g, w in zip(got, want):
        assert np.array_equal(tharness._item_waveform(g), jharness._item_waveform(w))
    monkeypatch.setitem(sys.modules, "datasets", None)
    errors = []
    for mod in (jds, tds):
        with pytest.raises(RuntimeError) as e:
            mod.HFDatasetLoader(str(tmp_path), "fleurs").load()
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_bootstrap_analysis_and_figures_match(tmp_path):
    rng = np.random.default_rng(0)
    wers = rng.uniform(0, 1, 37).tolist()
    for seed in (0, 3):
        assert tharness.bootstrap_ci(wers, 200, seed) == jharness.bootstrap_ci(wers, 200, seed)
    assert tharness.bootstrap_ci([]) == jharness.bootstrap_ci([])
    runs = {}
    for r in ("a", "b"):
        d = tmp_path / r
        d.mkdir()
        for name in ("librispeech_clean", "tedlium"):
            res = {"eval_set": name, "wer": float(rng.uniform()), "n_samples": 10}
            (d / f"{name}_{r}.json").write_text(json.dumps(res))
            rows = "".join(f"{i},{rng.uniform():.4f},\"ref\",\"hyp\"\n" for i in range(9))
            (d / f"{name}_{r}_per_sample.csv").write_text("id,wer,ref,hyp\n" + rows)
        runs[r] = str(d)
    for r, d in runs.items():
        assert tanalysis.error_bars_for_run(d, 100) == janalysis.error_bars_for_run(d, 100)
        csv = os.path.join(d, f"tedlium_{r}_per_sample.csv")
        assert tanalysis.read_per_sample_csv(csv) == janalysis.read_per_sample_csv(csv)
    assert tanalysis.comparison_table(runs) == janalysis.comparison_table(runs)
    rows = tfigures.load_results([str(tmp_path / "*" / "*.json")])
    assert rows == jfigures.load_results([str(tmp_path / "*" / "*.json")]) and len(rows) == 4
    for variant in (None, "small.en"):
        assert tfigures.wer_table(rows, variant) == jfigures.wer_table(rows, variant)
    assert tfigures.PUBLISHED == jfigures.PUBLISHED


# ---------------------------------------------------------------------------
# the harness against the JAX harness
# ---------------------------------------------------------------------------

DIMS = ModelDimensions(
    n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=4, n_audio_layer=2,
    n_vocab=51864, n_text_ctx=448, n_text_state=64, n_text_head=4, n_text_layer=2,
)
SAMPLE_LEN = 10
EOT = 50256


@pytest.fixture(scope="module")
def pair():
    """The JAX model and the port's from the same fp32 weights, the token
    embedding's text rows past the byte tokens zeroed."""
    params = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0), DIMS,
                                                     include_padding_token=False))
    params["decoder"]["token_embedding"] = params["decoder"]["token_embedding"].copy()
    params["decoder"]["token_embedding"][256:EOT] = 0.0
    model = _new_model(DIMS, False, "cpu", torch.float32)
    model.load_state_dict(params_to_torch_state_dict(params, DIMS))
    return JaxOLMoASR(DIMS, jax.tree.map(jax.numpy.asarray, params)), model.eval()


@pytest.fixture
def fp32_decode(pair, monkeypatch):
    """Each model's decode at fp32 and SAMPLE_LEN; each package's
    transcribe_many with the gates off."""
    for model in pair:
        decode = model.decode
        monkeypatch.setattr(model, "decode", lambda mel, options, decode=decode: decode(
            mel, dataclasses.replace(options, fp16=False, sample_len=SAMPLE_LEN)))
    for mod in (jtranscribe, ttranscribe):
        many = mod.transcribe_many
        monkeypatch.setattr(mod, "transcribe_many", lambda model, wavs, many=many, **kw: many(
            model, wavs, **{**kw, "fp16": False, "sample_len": SAMPLE_LEN,
                            "compression_ratio_threshold": None, "logprob_threshold": None}))
    return pair


def _same_results(got, want):
    for f in ("eval_set", "wer", "substitutions", "insertions", "deletions", "n_samples",
              "audio_seconds", "per_sample"):
        assert getattr(got, f) == getattr(want, f), f


@pytest.fixture(scope="module")
def eval_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval")
    _librispeech_tree(root, n=5, seed=3, seconds=(2.0, 12.0))
    rng = np.random.default_rng(4)
    lines = []
    for i, seconds in enumerate((35, 12)):
        wav = (rng.standard_normal(16000 * seconds) * 1500).astype(np.int16)
        wavfile.write(str(root / f"long{i}.wav"), 16000, wav)
        lines.append(json.dumps({"audio": f"long{i}.wav", "id": f"long{i}",
                                 "text": _random_text(rng, 30)}))
    (root / "longset.jsonl").write_text("\n".join(lines) + "\n")
    return str(root)


def test_short_form_eval_matches_jax(fp32_decode, eval_tree, tmp_path):
    """5 utterances in batches of 2 (the last batch ragged); write_results'
    files equal apart from the real-time factor."""
    jmodel, model = fp32_decode
    got = tharness.short_form_eval(model, "librispeech_clean", eval_tree, batch_size=2)
    want = jharness.short_form_eval(jmodel, "librispeech_clean", eval_tree, batch_size=2)
    _same_results(got, want)
    assert got.n_samples == 5 and any(r["hyp"] for r in got.per_sample)
    assert got.wall_seconds > 0
    for mod, result in (("jax", want), ("port", got)):
        mod_harness = jharness if mod == "jax" else tharness
        mod_harness.write_results(result, str(tmp_path / mod), "micro")
    for suffix in (".txt", ".json", "_per_sample.csv"):
        files = [(tmp_path / mod / f"librispeech_clean_micro{suffix}").read_text()
                 for mod in ("jax", "port")]
        if suffix == ".json":
            files = [{k: v for k, v in json.loads(f).items() if k != "rtfx"} for f in files]
        elif suffix == ".txt":
            files = [[line for line in f.splitlines() if not line.startswith("rtfx=")]
                     for f in files]
        assert files[0] == files[1], suffix


def test_long_form_eval_matches_jax(fp32_decode, eval_tree):
    """Beam 5 at t=0 over a 35 s and a 12 s file."""
    jmodel, model = fp32_decode
    got = tharness.long_form_eval(model, "longset", eval_tree, batch_size=2)
    want = jharness.long_form_eval(jmodel, "longset", eval_tree, batch_size=2)
    _same_results(got, want)
    assert got.n_samples == 2 and got.audio_seconds == 47.0
    assert all(r["hyp"] for r in got.per_sample)


def test_harness_cli_on_the_cpu(pair, eval_tree, tmp_path, capsys, monkeypatch):
    """``main --device cpu`` over an ``.npz`` of the same weights: its last
    line is the result of ``short_form_eval`` in this process (bf16, the
    CLI's decode), and it writes the three results files."""
    from olmoasr_tpu_torch.models import convert

    _, model = pair
    ckpt = str(tmp_path / "micro.npz")
    convert.save_npz_checkpoint(ckpt, model.state_dict(), model.dims)
    options = tharness.DecodingOptions
    monkeypatch.setattr(tharness, "DecodingOptions",
                        lambda **kw: options(**kw, sample_len=SAMPLE_LEN))
    tharness.main(["--eval_set", "librispeech_clean", "--eval_dir", eval_tree, "--ckpt", ckpt,
                   "--out_dir", str(tmp_path / "out"), "--batch_size", "4", "--max_samples",
                   "3", "--device", "cpu"])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = tharness.short_form_eval(model, "librispeech_clean", eval_tree, batch_size=4,
                                    max_samples=3)
    assert {k: v for k, v in last.items() if k != "rtfx"} == \
        {k: v for k, v in want.to_dict().items() if k != "rtfx"}
    assert sorted(os.listdir(tmp_path / "out")) == [
        "librispeech_clean_micro.npz.json", "librispeech_clean_micro.npz.txt",
        "librispeech_clean_micro.npz_per_sample.csv"]
