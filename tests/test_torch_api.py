"""The port's public API surface against the JAX package's, on the CPU:
``load_model`` by released name (the file a download leaves under
``download_root``, or a download from a ``file://`` link; nothing touches
the network), the command line's
``--model NAME --model_dir DIR``, ``OLMoASR.forward`` (``model(mel,
tokens, padding_mask)``), ``half()`` (bf16, as the JAX package casts),
``astype``, ``num_params`` and ``device``.

Tolerance of the forward: both sides compute in bf16 at their defaults, and
the port's attention rounds p to bf16 before P.V where the JAX model on the
CPU runs XLA's attention, so the logits are held to 2e-2 of their largest
magnitude (a few bf16 steps).
"""

from __future__ import annotations

import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import olmoasr_tpu_torch
from olmoasr_tpu.api import OLMoASR as JaxOLMoASR
from olmoasr_tpu.models import whisper as jm
from olmoasr_tpu.models.convert import params_to_torch_state_dict
from olmoasr_tpu.models.dims import ModelDimensions
from olmoasr_tpu_torch import transcribe as tr
from olmoasr_tpu_torch.api import OLMoASR, load_model
from olmoasr_tpu_torch.models import whisper as tm
from olmoasr_tpu_torch.models.convert import state_dict_from_jax_params

DIMS = ModelDimensions(n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=1,
                       n_audio_layer=2, n_vocab=51864, n_text_ctx=16, n_text_state=64,
                       n_text_head=1, n_text_layer=2)


@pytest.fixture(scope="module")
def params_np():
    return jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(3), DIMS,
                                                   include_padding_token=False))


@pytest.fixture
def released(params_np, tmp_path):
    """A micro checkpoint saved under small.en's released file name in a
    temporary download root."""
    root = tmp_path / "models"
    root.mkdir()
    path = root / "OLMoASR-small.en.pt"
    torch.save({"dims": DIMS.to_dict(),
                "model_state_dict": params_to_torch_state_dict(params_np, DIMS)}, str(path))
    return str(root), str(path)


def test_released_name_loads_the_cached_file(released, monkeypatch):
    root, path = released
    by_name = load_model("small.en", device="cpu", download_root=root)
    by_path = load_model(path, device="cpu")
    assert isinstance(by_name, OLMoASR) and by_name.dims.to_dict() == DIMS.to_dict()
    for k, v in by_path.state_dict().items():
        assert torch.equal(by_name.state_dict()[k], v), k
    # without download_root: $XDG_CACHE_HOME/olmoasr, as the JAX package's _download
    monkeypatch.setenv("XDG_CACHE_HOME", os.path.dirname(root))
    os.rename(root, os.path.join(os.path.dirname(root), "olmoasr"))
    assert olmoasr_tpu_torch.load_model("small.en", device="cpu").dims == by_name.dims
    # a released name whose file is missing is downloaded from its link (a
    # file:// URL here) into the cache, as the JAX package's _download does
    source = os.path.join(os.path.dirname(root), "source")
    os.makedirs(source)
    shutil.copy(os.path.join(os.path.dirname(root), "olmoasr", "OLMoASR-small.en.pt"),
                os.path.join(source, "OLMoASR-tiny.en.pt"))
    monkeypatch.setitem(olmoasr_tpu_torch.MODEL2LINK, "tiny.en",
                        "file://" + os.path.join(source, "OLMoASR-tiny.en.pt"))
    assert load_model("tiny.en", device="cpu").dims == by_name.dims
    assert os.path.isfile(os.path.join(os.path.dirname(root), "olmoasr", "OLMoASR-tiny.en.pt"))
    # a name that is neither released nor a file: the JAX package's RuntimeError
    with pytest.raises(RuntimeError, match="available models"):
        load_model("no-such-model", device="cpu")
    # the JAX package's (and the reference's) signature, by keyword; in_memory is ignored
    kw = load_model(name="small.en", device="cpu", download_root=os.path.dirname(root) + "/olmoasr",
                    inference=True, in_memory=True)
    for k, v in by_path.state_dict().items():
        assert torch.equal(kw.state_dict()[k], v), k


def test_cli_model_dir_resolves_a_released_name(released, tmp_path, monkeypatch):
    """``transcribe a.wav --model small.en --model_dir D --device cpu`` loads
    ``D/OLMoASR-small.en.pt``, and the server defaults ``--model`` to
    small.en as the JAX server does."""
    import scipy.io.wavfile as wavfile

    from olmoasr_tpu_torch import api, serve

    root, path = released
    wav = str(tmp_path / "a.wav")
    rng = np.random.default_rng(0)
    wavfile.write(wav, 16000, (rng.standard_normal(16000) * 3000).astype(np.int16))
    loaded = []
    real = api.load_model
    monkeypatch.setattr(api, "load_model", lambda *a, **kw: loaded.append((a, kw)) or real(*a, **kw))
    monkeypatch.setattr(sys, "argv", [
        "transcribe", wav, "--model", "small.en", "--model_dir", root, "-o",
        str(tmp_path / "out"), "--device", "cpu", "--temperature_increment_on_fallback", "None",
        "--beam_size", "None", "--best_of", "None", "--verbose", "False",
    ])
    tr.cli()
    assert loaded == [(("small.en",), {"device": "cpu", "download_root": root})]
    assert sorted(os.listdir(tmp_path / "out")) == [f"a.{e}" for e in ("json", "srt", "tsv",
                                                                       "txt", "vtt")]
    seen = {}

    def fake_load(name, device):
        seen["model"] = name
        raise SystemExit(0)

    monkeypatch.setattr(api, "load_model", fake_load)
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu"])
    assert seen["model"] == "small.en"


def _pair(params_np):
    model = tm.empty_model(DIMS, cls=OLMoASR)
    model.load_state_dict(state_dict_from_jax_params(params_np, DIMS))
    return JaxOLMoASR(DIMS, jax.tree.map(jnp.asarray, params_np)), model.eval()


def test_forward_is_forward_train(params_np):
    """``model(mel, tokens, padding_mask)`` runs ``forward_train`` in both
    packages (bf16 compute, fp32 logits)."""
    jmodel, model = _pair(params_np)
    rng = np.random.default_rng(1)
    mel = rng.standard_normal((2, 80, 2 * DIMS.n_audio_ctx)).astype(np.float32)
    tokens = rng.integers(0, 50000, (2, DIMS.n_text_ctx)).astype(np.int32)
    mask = np.where(np.arange(DIMS.n_text_ctx)[None] < np.array([[16], [9]]), 0.0,
                    -np.inf).astype(np.float32)
    want = np.asarray(jmodel(jnp.asarray(mel), jnp.asarray(tokens), jnp.asarray(mask)))
    args = (torch.from_numpy(mel), torch.from_numpy(tokens), torch.from_numpy(mask))
    with torch.no_grad():
        got = model(*args)
        assert torch.equal(got, tm.forward_train(model, *args))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert float(np.abs(got.numpy() - want).max()) <= 2e-2 * float(np.abs(want).max())


def test_half_is_bf16(params_np):
    jmodel, model = _pair(params_np)
    assert model.half() is model and model.dtype == torch.bfloat16
    jhalf = jax.tree_util.tree_flatten_with_path(jmodel.half().params)[0]
    assert {str(leaf.dtype) for _, leaf in jhalf} == {"bfloat16"}
    sd = model.state_dict()
    got = state_dict_from_jax_params(jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)),
                                                  jmodel.params), DIMS)
    for k, v in got.items():
        assert sd[k].dtype == torch.bfloat16 and torch.equal(sd[k], v.to(torch.bfloat16)), k


def test_num_params_astype_and_device_match_jax(params_np):
    """``num_params`` counts the JAX param tree's leaves (the encoder's
    sinusoids are a buffer here and a constant there), ``astype`` casts in
    place and returns the model, ``device`` is the parameters' device."""
    jmodel, model = _pair(params_np)
    assert model.num_params() == jmodel.num_params()
    assert model.num_params() < sum(t.numel() for t in model.state_dict().values())
    assert model.device == torch.device("cpu") and jmodel.device.platform == "cpu"
    assert model.astype(torch.bfloat16) is model and model.dtype == torch.bfloat16
    jcast = jmodel.astype(jnp.bfloat16)
    assert jcast is jmodel
    assert {str(leaf.dtype) for leaf in jax.tree.leaves(jcast.params)} == {"bfloat16"}
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    assert model.astype(torch.float32).dtype == torch.float32
    assert model.num_params() == jmodel.num_params()
