"""Checkpoint conversion of the port (olmoasr_tpu_torch.models.convert) against
the JAX package's params and file formats."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from olmoasr_tpu.models import convert as jconvert
from olmoasr_tpu.models import whisper as jm
from olmoasr_tpu.models.dims import ModelDimensions
from olmoasr_tpu_torch import load_model
from olmoasr_tpu_torch.api import OLMoASR, _new_model
from olmoasr_tpu_torch.models import convert
from olmoasr_tpu_torch.models.dims import ModelDimensions as PortDims

DIMS = ModelDimensions(
    n_mels=80, n_audio_ctx=24, n_audio_state=64, n_audio_head=4, n_audio_layer=2,
    n_vocab=51864, n_text_ctx=20, n_text_state=64, n_text_head=4, n_text_layer=2,
)


@pytest.fixture(scope="module")
def params_np():
    params = jm.init_params(jax.random.PRNGKey(0), DIMS, include_padding_token=True)
    return jax.tree.map(np.asarray, params)


def _assert_trees_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees_equal(a[k], b[k])
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


def test_round_trip_through_the_state_dict(params_np):
    sd = convert.state_dict_from_jax_params(params_np, DIMS)
    model = _new_model(DIMS, True, "cpu", torch.float32)
    model.load_state_dict(sd)  # strict: every name matches the module tree
    assert sd["encoder.blocks.1.attn.query.weight"].shape == (64, 64)
    np.testing.assert_array_equal(
        sd["decoder.blocks.0.mlp.0.weight"].numpy(), params_np["decoder"]["blocks"]["mlp_w1"][0].T
    )
    np.testing.assert_array_equal(  # conv (k, in, out) -> (out, in, k)
        sd["encoder.conv1.weight"].numpy(), params_np["encoder"]["conv1_w"].transpose(2, 1, 0)
    )
    _assert_trees_equal(convert.jax_params_from_state_dict(model.state_dict(), DIMS), params_np)


def test_state_dict_names_match_the_jax_exporter(params_np):
    sd = convert.state_dict_from_jax_params(params_np, DIMS)
    ref = jconvert.params_to_torch_state_dict(params_np, DIMS)
    assert sd.keys() == ref.keys()
    for k in sd:
        np.testing.assert_array_equal(sd[k].numpy(), ref[k].numpy(), err_msg=k)


def test_npz_loader_matches_the_jax_loader(params_np, tmp_path):
    path = str(tmp_path / "micro.npz")
    jconvert.save_npz_checkpoint(path, params_np, DIMS)
    sd, dims = convert.load_npz_checkpoint(path)
    jparams, jdims = jconvert.load_npz_checkpoint(path)
    assert isinstance(dims, PortDims) and dims.to_dict() == jdims.to_dict() == DIMS.to_dict()
    want = convert.state_dict_from_jax_params(jax.tree.map(np.asarray, jparams), DIMS)
    assert sd.keys() == want.keys()
    for k in sd:
        assert torch.equal(sd[k], want[k]), k


def test_strip_padding_row(params_np):
    sd = convert.state_dict_from_jax_params(params_np, DIMS)
    emb = "decoder.token_embedding.weight"
    assert sd[emb].shape[0] == jm.PADDING_TOKEN + 1
    stripped = convert.strip_padding_row(sd)
    assert stripped[emb].shape[0] == jm.PADDING_TOKEN
    assert sd[emb].shape[0] == jm.PADDING_TOKEN + 1  # the input is left as it was
    assert convert.strip_padding_row(stripped)[emb].shape[0] == jm.PADDING_TOKEN


@pytest.mark.parametrize("fmt", ["npz", "pt"])
def test_load_model_from_a_local_file(params_np, tmp_path, fmt):
    path = str(tmp_path / f"micro.{fmt}")
    if fmt == "npz":
        jconvert.save_npz_checkpoint(path, params_np, DIMS)
    else:
        sd = jconvert.params_to_torch_state_dict(params_np, DIMS)
        torch.save({"dims": DIMS.to_dict(), "model_state_dict": sd}, path)
    model = load_model(path, device="cpu")
    assert isinstance(model, OLMoASR) and model.dims.to_dict() == DIMS.to_dict()
    got = model.state_dict()
    assert got["decoder.token_embedding.weight"].shape[0] == jm.PADDING_TOKEN
    np.testing.assert_array_equal(
        got["decoder.blocks.1.cross_attn.out.weight"].numpy(),
        params_np["decoder"]["blocks"]["cross_o_w"][1].T,
    )
    assert load_model(path, device="cpu", inference=False).state_dict()[
        "decoder.token_embedding.weight"].shape[0] == jm.PADDING_TOKEN + 1


def test_load_model_refuses_a_missing_file(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_model(str(tmp_path / "nope.pt"))


def test_save_npz_checkpoint_reads_back_in_both_packages(params_np, tmp_path):
    """The port writes the JAX package's ``.npz`` format: flattened leaves
    plus ``__dims__``, bit-equal through both loaders."""
    path = str(tmp_path / "port.npz")
    sd = convert.state_dict_from_jax_params(params_np, DIMS)
    convert.save_npz_checkpoint(path, sd, PortDims(**DIMS.to_dict()))
    jparams, jdims = jconvert.load_npz_checkpoint(path)
    assert jdims == DIMS
    _assert_trees_equal(jax.tree.map(np.asarray, jparams), params_np)
    back, dims = convert.load_npz_checkpoint(path)
    assert dims == PortDims(**DIMS.to_dict())
    for k in sd:
        assert torch.equal(back[k], sd[k]), k


@pytest.mark.parametrize("entry", ["build_model", "load_model"])
def test_entry_points_default_to_the_card(params_np, tmp_path, entry):
    """``build_model`` and ``load_model`` run on ``cuda`` unless the caller
    asks for the CPU: on a host without a card they raise, with no fallback."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    import olmoasr_tpu_torch

    if entry == "build_model":
        call = lambda: olmoasr_tpu_torch.build_model("tiny.en")
    else:
        path = str(tmp_path / "micro.npz")
        jconvert.save_npz_checkpoint(path, params_np, DIMS)
        call = lambda: olmoasr_tpu_torch.load_model(path)
    with pytest.raises((RuntimeError, AssertionError)):
        call()
