"""The port's remaining entry points against the JAX package's, on the CPU:
``load_model`` of a released name through a download (a ``file://`` link in
``MODEL2LINK``; nothing touches the network), ``models/gen_inf_ckpt`` from a
``.pt`` and from an ``.npz``, the HF export's state dict key for key (and,
with ``transformers``, its config and model directory), ``eval/parity``'s
``main`` end to end on a micro checkpoint over a LibriSpeech-format tree,
the demo's checkpoint flow and its gradio app over a stand-in ``gradio``,
and the native BPE built from the port's own sources, whose ids equal the
port's Python tokenizer's and the JAX package's native BPE's.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import scipy.io.wavfile as wavfile
import torch

import olmoasr_tpu
import olmoasr_tpu_torch
from olmoasr_tpu import api as japi
from olmoasr_tpu.eval import harness as jharness
from olmoasr_tpu.eval import parity as jparity
from olmoasr_tpu.integrations import hf as jhf
from olmoasr_tpu.models import convert as jconvert
from olmoasr_tpu.models import gen_inf_ckpt as jgen
from olmoasr_tpu.models import whisper as jm
from olmoasr_tpu.models.dims import ModelDimensions
from olmoasr_tpu_torch import api, tokenizer
from olmoasr_tpu_torch.demo import demo
from olmoasr_tpu_torch.eval import harness as tharness
from olmoasr_tpu_torch.eval import parity
from olmoasr_tpu_torch.integrations import hf
from olmoasr_tpu_torch.models import convert
from olmoasr_tpu_torch.models.gen_inf_ckpt import gen_inf_ckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIMS = ModelDimensions(
    n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=4, n_audio_layer=2,
    n_vocab=51864, n_text_ctx=448, n_text_state=64, n_text_head=4, n_text_layer=2,
)
EOT = 50256
SAMPLE_LEN = 10


@pytest.fixture(scope="module")
def train_params():
    """Micro training weights (with the padding row), the token embedding's
    text rows past the byte tokens zeroed so that decoded text is not empty."""
    params = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0), DIMS,
                                                     include_padding_token=True))
    params["decoder"]["token_embedding"] = params["decoder"]["token_embedding"].copy()
    params["decoder"]["token_embedding"][256:EOT] = 0.0
    return params


@pytest.fixture(scope="module")
def ckpts(train_params, tmp_path_factory):
    """The training weights as a reference ``.pt`` and as an ``.npz``."""
    root = tmp_path_factory.mktemp("ckpts")
    pt, npz = str(root / "train.pt"), str(root / "train.npz")
    torch.save({"dims": DIMS.to_dict(),
                "model_state_dict": jconvert.params_to_torch_state_dict(train_params, DIMS)}, pt)
    jconvert.save_npz_checkpoint(npz, train_params, DIMS)
    return pt, npz


# ---------------------------------------------------------------------------
# the download
# ---------------------------------------------------------------------------


def test_load_model_downloads_a_released_name_once(ckpts, tmp_path, monkeypatch):
    """A released name not yet under ``download_root`` is fetched from its
    link, as the JAX package's ``_download`` fetches it; the second load
    reuses the file."""
    pt, _ = ckpts
    url = "file://" + pt
    monkeypatch.setitem(olmoasr_tpu_torch.MODEL2LINK, "small.en", url)
    root = str(tmp_path / "cache")
    calls = []
    urlopen = api.urllib.request.urlopen
    monkeypatch.setattr(api.urllib.request, "urlopen", lambda u: calls.append(u) or urlopen(u))
    first = api.load_model("small.en", device="cpu", download_root=root)
    assert calls == [url] and os.listdir(root) == ["train.pt"]
    second = api.load_model("small.en", device="cpu", download_root=root)
    assert calls == [url]
    by_path = api.load_model(pt, device="cpu")
    for k, v in by_path.state_dict().items():
        assert torch.equal(first.state_dict()[k], v) and torch.equal(second.state_dict()[k], v), k
    # the JAX package's download of the same link: the same bytes, the same name
    jroot = str(tmp_path / "jcache")
    got = japi._download(url, jroot)
    assert os.path.basename(got) == "train.pt"
    with open(got, "rb") as a, open(os.path.join(root, "train.pt"), "rb") as b:
        assert a.read() == b.read()
    assert api._download(url, root) == os.path.join(root, "train.pt")


def test_cut_download_leaves_no_file(ckpts, tmp_path, monkeypatch):
    """A download cut part-way leaves nothing at the target (the bytes went
    to a file of the process's own, which is removed), so the next call
    downloads the whole file and ``load_model`` never reads a part of it."""
    pt, _ = ckpts
    url = "file://" + pt
    root = str(tmp_path / "cache")
    urlopen = api.urllib.request.urlopen

    def cut(u):
        source = urlopen(u)
        reads = iter(range(3))
        read = source.read
        source.read = lambda n: read(n) if next(reads, None) is not None else 1 / 0
        return source

    monkeypatch.setattr(api.urllib.request, "urlopen", cut)
    with pytest.raises(ZeroDivisionError):
        api._download(url, root)
    assert os.listdir(root) == []
    monkeypatch.setattr(api.urllib.request, "urlopen", urlopen)
    got = api._download(url, root)
    assert os.listdir(root) == ["train.pt"]
    with open(got, "rb") as a, open(pt, "rb") as b:
        assert a.read() == b.read()


def test_two_ranks_download_a_released_name_once(ckpts, tmp_path):
    """Under a ``gloo`` group of 2 ranks that both load a released name (as
    the CLI, the eval harness and the server do), rank 0 alone downloads it,
    slowly, while rank 1 waits; both load the checkpoint's weights, and the
    cache holds the one whole file. A link that fails on rank 0 raises on
    both ranks and leaves no file."""
    pt, _ = ckpts
    root = str(tmp_path / "cache")
    job = {"kind": "load", "name": "small.en", "root": root, "read_delay": 0.0005,
           "links": ["file://" + pt, "file://" + str(tmp_path / "missing.pt")]}
    path = str(tmp_path / "load.pt")
    torch.save(job, path)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, (REPO, env.get("PYTHONPATH"))))
    worker = os.path.join(REPO, "tests", "torch_dist_worker.py")
    procs = [subprocess.Popen([sys.executable, worker, path, str(r), "2", str(tmp_path / "rdzv")],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for r in range(2)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    ranks = [torch.load(f"{path}.out{r}", weights_only=False) for r in range(2)]
    want = api.load_model(pt, device="cpu").state_dict()
    (good0, bad0), (good1, bad1) = ranks
    assert good0["opened"] == [job["links"][0]] and good1["opened"] == []
    for got in (good0, good1):
        assert got["state_dict"].keys() == want.keys()
        for k, v in want.items():
            assert torch.equal(got["state_dict"][k], v), k
    assert os.listdir(root) == ["train.pt"]
    assert bad0["error"].startswith("URLError") and bad0["opened"] == [job["links"][1]]
    assert bad1["error"].startswith("RuntimeError: rank 0 could not download")
    assert bad1["opened"] == [] and os.listdir(root) == ["train.pt"]


# ---------------------------------------------------------------------------
# gen_inf_ckpt
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("source", ["pt", "npz"])
def test_gen_inf_ckpt_matches_jax(ckpts, tmp_path, source):
    """The inference ``.npz`` from a training checkpoint: the JAX
    ``gen_inf_ckpt``'s arrays, key for key, the padding row gone."""
    src = ckpts[0] if source == "pt" else ckpts[1]
    got, want = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    assert gen_inf_ckpt(src, got) == got
    jgen.gen_inf_ckpt(src, want)
    with np.load(got) as g, np.load(want) as w:
        assert sorted(g.files) == sorted(w.files)
        for k in w.files:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k
        assert g["decoder/token_embedding"].shape[0] == DIMS.n_vocab
    if source == "pt":  # the command line
        cli = str(tmp_path / "cli.npz")
        subprocess.run([sys.executable, "-m", "olmoasr_tpu_torch.models.gen_inf_ckpt", src, cli],
                       check=True, cwd=REPO, timeout=120)
        with np.load(cli) as c, np.load(got) as g:
            assert all(np.array_equal(c[k], g[k]) for k in g.files)


# ---------------------------------------------------------------------------
# the HF export
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("padding_row", [True, False])
def test_hf_state_dict_matches_jax(train_params, padding_row):
    params = train_params
    if not padding_row:
        params = jconvert.strip_padding_row(params)
    sd = convert.state_dict_from_jax_params(params, DIMS)
    got = hf.params_to_hf_state_dict(sd, DIMS)
    want = jhf.params_to_hf_state_dict(params, DIMS)
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype == torch.float32 and torch.equal(got[k], v), k
    assert got["proj_out.weight"].shape[0] == DIMS.n_vocab


# transformers runs in a process of its own: module stubs that other test
# files leave in sys.modules (tests/ref_loader.py) break its import-time
# probes of optional packages
HF_CHECK = """
import json, os, sys
import torch
from transformers import WhisperForConditionalGeneration
from olmoasr_tpu.integrations import hf as jhf
from olmoasr_tpu_torch.demo import demo
from olmoasr_tpu_torch.integrations import hf
from olmoasr_tpu_torch.models import convert

ckpt, out = sys.argv[1:]
sd, dims = convert.load_torch_checkpoint(ckpt)
assert hf.make_hf_config(dims).to_dict() == jhf.make_hf_config(dims).to_dict()
assert hf.convert_checkpoint_to_hf(ckpt, out + "/hf") == out + "/hf"
got = WhisperForConditionalGeneration.from_pretrained(out + "/hf").state_dict()
want = hf.params_to_hf_state_dict(convert.strip_padding_row(sd), dims)
for k in ("model.decoder.layers.1.encoder_attn.k_proj.weight", "model.encoder.conv2.weight",
          "model.decoder.embed_tokens.weight", "proj_out.weight"):
    assert torch.equal(got[k], want[k]), k
# the demo's export: written once, then reused
assert demo.export_hf(ckpt, out + "/demo") == out + "/demo"
assert os.path.isfile(out + "/demo/config.json")
assert demo.export_hf("unused.pt", out + "/demo") == out + "/demo"
print("ok")
"""


def test_hf_config_and_export(ckpts, tmp_path):
    """With ``transformers``: ``make_hf_config`` equal to the JAX
    package's; ``convert_checkpoint_to_hf`` writes a directory that
    ``WhisperForConditionalGeneration.from_pretrained`` loads to the
    exported weights; the demo's ``export_hf`` writes it once and reuses
    it."""
    import importlib.util

    if importlib.util.find_spec("transformers") is None:
        pytest.skip("transformers is not installed")
    env = {**os.environ, "PYTHONPATH": REPO, "HF_HUB_OFFLINE": "1",
           "TRANSFORMERS_OFFLINE": "1", "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", HF_CHECK, ckpts[0], str(tmp_path)], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stderr[-3000:]


# ---------------------------------------------------------------------------
# the parity harness
# ---------------------------------------------------------------------------


def _librispeech_tree(root, n=4, seed=3):
    chap = root / "LibriSpeech" / "test-clean" / "19" / "198"
    chap.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        utt = f"19-198-{i:04d}"
        wav = (rng.standard_normal(int(16000 * rng.uniform(2.0, 8.0))) * 1000).astype(np.int16)
        wavfile.write(str(chap / f"{utt}.wav"), 16000, wav)
        lines.append(f"{utt} " + " ".join(rng.choice(["SPEECH", "MODEL", "THE", "AUDIO"], 4)))
    (chap / "19-198.trans.txt").write_text("\n".join(lines))
    return str(root)


def test_parity_main_matches_jax(ckpts, tmp_path, monkeypatch, capsys):
    """``parity.main`` with the fallback tokenizer on an inference ``.npz``:
    both packages print the same short-form line and write the same results
    files (apart from the real-time factor); each package's decode at fp32
    and a short sample length. With ``--long_audio`` the port prints
    ``long_form_eval_single``'s WER."""
    ckpt = gen_inf_ckpt(ckpts[1], str(tmp_path / "micro.npz"))
    tree = _librispeech_tree(tmp_path / "tree")
    for mod in (tharness, jharness):
        options = mod.DecodingOptions
        monkeypatch.setattr(mod, "DecodingOptions", lambda options=options, **kw: options(
            **{**kw, "fp16": False, "sample_len": SAMPLE_LEN}))
    argv = ["--ckpt", ckpt, "--eval_dir", tree, "--allow_fallback_tokenizer", "--batch_size", "2",
            "--max_samples", "3"]
    assert parity.main([*argv, "--out_dir", str(tmp_path / "port"), "--device", "cpu"]) == 0
    port_out = capsys.readouterr().out.splitlines()
    assert jparity.main([*argv, "--out_dir", str(tmp_path / "jax")]) == 0
    jax_out = capsys.readouterr().out.splitlines()

    def short_line(lines):
        line = next(x for x in lines if x.startswith("parity: short-form"))
        return line.split(", RTFx")[0]

    assert short_line(port_out) == short_line(jax_out)
    assert "byte-fallback tokenizer" in port_out[0]
    for suffix in (".txt", ".json", "_per_sample.csv"):
        files = [(tmp_path / mod / f"librispeech_clean_?{suffix}").read_text()
                 for mod in ("port", "jax")]
        if suffix == ".json":
            files = [{k: v for k, v in json.loads(f).items() if k != "rtfx"} for f in files]
        elif suffix == ".txt":
            files = [[x for x in f.splitlines() if not x.startswith("rtfx=")] for f in files]
        assert files[0] == files[1], suffix
    with pytest.raises(SystemExit, match="byte-fallback"):  # no rank file, no flag
        parity.main(["--ckpt", ckpt, "--device", "cpu"])

    long_audio = str(tmp_path / "long.wav")
    rng = np.random.default_rng(7)
    wavfile.write(long_audio, 16000, (rng.standard_normal(16000 * 33) * 1000).astype(np.int16))
    (tmp_path / "long.txt").write_text("the speech model")
    transcribe = api.OLMoASR.transcribe
    monkeypatch.setattr(api.OLMoASR, "transcribe", lambda self, audio, **kw: transcribe(
        self, audio, **{**kw, "fp16": False, "sample_len": SAMPLE_LEN}))
    parity.main([*argv, "--out_dir", str(tmp_path / "port2"), "--device", "cpu", "--long_audio",
                 long_audio, "--long_ref", str(tmp_path / "long.txt")])
    line = capsys.readouterr().out.splitlines()[-1]
    model = api.load_model(ckpt, device="cpu")
    wer = tharness.long_form_eval_single(model, long_audio, str(tmp_path / "long.txt"))
    assert line == (f"parity: long-form long.wav: WER {wer * 100:.2f}% "
                    f"(beam_size=5, best_of=5, timestamps)")


# ---------------------------------------------------------------------------
# the demo
# ---------------------------------------------------------------------------


def test_ensure_checkpoint(tmp_path, monkeypatch):
    """A checkpoint already in place is returned; a missing one comes from
    the hub's ``hf_hub_download`` (a stand-in module here); None when the
    download fails."""
    local = tmp_path / "checkpoints"
    calls = []

    def fake_download(repo_id, filename, local_dir):
        calls.append((repo_id, filename, local_dir))
        path = os.path.join(local_dir, filename)
        open(path, "wb").close()
        return path

    monkeypatch.setitem(sys.modules, "huggingface_hub",
                        types.SimpleNamespace(hf_hub_download=fake_download))
    path = demo.ensure_checkpoint(str(local))
    assert path == str(local / demo.CHECKPOINT_FILENAME) and os.path.isfile(path)
    assert calls == [(demo.OLMOASR_REPO, demo.CHECKPOINT_FILENAME, str(local))]
    assert demo.ensure_checkpoint(str(local)) == path and len(calls) == 1

    def offline(**kw):
        raise OSError("no network")

    monkeypatch.setitem(sys.modules, "huggingface_hub",
                        types.SimpleNamespace(hf_hub_download=offline))
    assert demo.ensure_checkpoint(str(tmp_path / "elsewhere")) is None


def test_export_hf_and_pipeline(tmp_path, monkeypatch):
    """``export_hf`` gives None when the export fails (its success is in
    ``test_hf_config_and_export``). ``_hf_pipeline`` asks transformers for
    the speech recognition pipeline of the model (a stand-in module here),
    None when it fails."""
    assert demo.export_hf(str(tmp_path / "missing.pt"), str(tmp_path / "bad")) is None
    seen = []
    monkeypatch.setitem(sys.modules, "transformers", types.SimpleNamespace(
        pipeline=lambda task, model, framework: seen.append((task, model, framework)) or "pipe"))
    assert demo._hf_pipeline("hf_dir") == "pipe"
    assert seen == [("automatic-speech-recognition", "hf_dir", "pt")]
    monkeypatch.setitem(sys.modules, "transformers", types.SimpleNamespace())
    assert demo._hf_pipeline("hf_dir") is None


class _Widget:
    """A stand-in gradio component: records its handlers."""

    def __init__(self, kind, *args, **kwargs):
        self.kind, self.args, self.kwargs, self.handlers = kind, args, kwargs, []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def click(self, fn, inputs, outputs):
        self.handlers.append(fn)

    stream = click

    def launch(self, **kwargs):
        self.launched = kwargs


def test_build_demo_over_a_stand_in_gradio(ckpts, tmp_path, monkeypatch):
    """``build_demo`` and ``main`` with a stand-in ``gradio`` module: the
    three tabs are built, the File tab's handler gives ``transcribe_file``'s
    text, the Compare tab's the model's text beside the (unavailable) HF
    baseline, the Live tab's ``transcribe_mic``'s; ``main`` launches on its
    port."""
    widgets = []

    def make(kind):
        return lambda *a, **k: widgets.append(_Widget(kind, *a, **k)) or widgets[-1]

    gr = types.SimpleNamespace(**{k: make(k) for k in (
        "Blocks", "Markdown", "Tab", "Audio", "Checkbox", "Textbox", "Button", "Row", "State")})
    monkeypatch.setitem(sys.modules, "gradio", gr)
    monkeypatch.setattr(demo, "_hf_pipeline", lambda name: None)
    ckpt = gen_inf_ckpt(ckpts[1], str(tmp_path / "micro.npz"))
    fast = dict(fp16=False, sample_len=4, temperature=0.0)
    transcribe = api.OLMoASR.transcribe
    monkeypatch.setattr(api.OLMoASR, "transcribe",
                        lambda self, audio, **kw: transcribe(self, audio, **{**kw, **fast}))
    app = demo.build_demo(ckpt, device="cpu")
    assert [w.args[0] for w in widgets if w.kind == "Tab"] == ["File", "Compare", "Live"]
    (file_fn,), (compare_fn,) = [w.handlers for w in widgets if w.kind == "Button"]
    (mic_fn,) = next(w.handlers for w in widgets if w.kind == "Audio" and w.kwargs.get(
        "streaming"))
    wav = str(tmp_path / "a.wav")
    rng = np.random.default_rng(1)
    pcm = (rng.standard_normal(16000 * 4) * 1000).astype(np.int16)
    wavfile.write(wav, 16000, pcm)
    model = api.load_model(ckpt, device="cpu")
    assert file_fn(wav, False) == demo.transcribe_file(model, wav, False)
    assert compare_fn(wav) == (model.transcribe(wav)["text"].strip(),
                               "(HF baseline unavailable offline)")
    state, text = mic_fn(None, (16000, pcm))
    want_state, want_text = demo.transcribe_mic(model, None, (16000, pcm))
    assert np.array_equal(state, want_state) and text == want_text
    assert app is widgets[0]
    widgets.clear()
    demo.main(["--model", ckpt, "--device", "cpu", "--port", "7861"])
    assert widgets[0].launched == {"server_port": 7861}


# ---------------------------------------------------------------------------
# the native BPE
# ---------------------------------------------------------------------------

TEXTS = [" hello world", "hello", "  double  spaces ", "it's a test", "numbers 12345 mixed",
         "punct!?.,;", " hello hello hello", "", " ", "a", "I'll we've don't"]
UNICODE_TEXTS = [" café hello", "日本 hello 日本語", "emoji \U0001f44d test", "mixed１２３digits",
                 "non breaking space", "tabs\t\tand  spaces", "číslo ٣٤٥", "Ωμέγα", "a  b",
                 "ideographic　space", "«quotes»—dash…", "", " ", "\t", "ß sharp", "ｆｕｌｌ",
                 "I'll we've don't ’smart’"]


def _rank_file(path, extra):
    import base64

    entries = [(bytes([b]), b) for b in range(256)] + [(t, 256 + i) for i, t in enumerate(extra)]
    with open(path, "wb") as f:
        for tok, rank in entries:
            f.write(base64.b64encode(tok) + b" " + str(rank).encode() + b"\n")
    return str(path)


@pytest.fixture(scope="module")
def native():
    from olmoasr_tpu_torch import tokenizer_native

    if not tokenizer_native.native_available():
        pytest.skip("no C++ compiler on this host")
    return tokenizer_native


def test_native_bpe_is_built_from_the_ports_sources(native):
    """The library lies in the build directory (nothing is committed), and
    its unicode tables, generated from the port tokenizer's pattern, hold the
    JAX package's ranges."""
    from olmoasr_tpu_torch.cpp import build

    paths = build.build()
    assert paths["libbpe"].startswith(str(build.BUILD_DIR))
    with open(build.BUILD_DIR / "unicode_tables.inc") as a, \
            open(os.path.join(os.path.dirname(olmoasr_tpu.__file__), "cpp",
                              "unicode_tables.inc")) as b:
        assert a.read().splitlines()[2:] == b.read().splitlines()[2:]


@pytest.mark.parametrize("which", ["ascii", "unicode"])
def test_native_bpe_matches_python_and_jax(native, tmp_path, which):
    """On the texts of tests/test_native_bpe.py (and 200 fuzzed ones for the
    unicode ranks): the port's native ids equal its Python engine's and the
    JAX package's native BPE's."""
    import random

    from olmoasr_tpu import tokenizer_native as jnative

    if which == "ascii":
        extra = [b" h", b"el", b"lo", b" he", b" hel", b" hell", b" hello", b"ll"]
        texts = list(TEXTS)
    else:
        extra = [b" h", b"el", b"lo", "é".encode(), b" caf", " café".encode(), "日".encode(),
                 "本".encode(), "日本".encode(), "\U0001f44d".encode()[:2],
                 "\U0001f44d".encode()]
        rng = random.Random(42)
        pools = ["abcdefghij ", "\t\n  　", "0123456789٠١٢", "àéîöüß", "日本語中文",
                 "!?.,;:—…«»", "\U0001f600\U0001f44d\U0001f680", "'s't're've'm'll'd'"]
        texts = UNICODE_TEXTS + ["".join(rng.choice(rng.choice(pools))
                                         for _ in range(rng.randrange(0, 40)))
                                 for _ in range(200)]
    ranks_path = _rank_file(tmp_path / "ranks.tiktoken", extra)
    ranks = tokenizer.load_tiktoken_ranks(ranks_path)
    py = tokenizer.BytePairEncoder(ranks, {})
    mine, theirs = native.NativeBPE(ranks_path), jnative.NativeBPE(ranks_path)
    assert mine.n_vocab == theirs.n_vocab == len(ranks)
    for text in texts:
        assert mine.encode(text) == py.encode(text) == theirs.encode(text), repr(text)
    assert native.NativeBPE(None).encode("hello world") == list(b"hello world")
