"""Checkpoint conversion into the port's torch state dict.

Counterpart of ``olmoasr_tpu/models/convert.py``. The port's modules use the
reference's state-dict names, so a released ``.pt`` checkpoint
(``{"dims": {...}, "model_state_dict": {...}}``) loads as it is. The JAX
package's params (stacked per layer, linear weights ``(in, out)``, conv
kernels ``(k, in, out)``) come in through :func:`state_dict_from_jax_params`,
and its native ``.npz`` format (flat ``a/b/c`` keys plus ``__dims__``) is read
and written with numpy alone.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Tuple

import numpy as np
import torch

from olmoasr_tpu_torch.models.dims import ModelDimensions
from olmoasr_tpu_torch.models.whisper import PADDING_TOKEN, sinusoids

StateDict = Dict[str, torch.Tensor]

# JAX block-stack leaf -> (torch name inside a block, transposed?)
_SELF_MAP = {
    "attn_ln_g": ("attn_ln.weight", False), "attn_ln_b": ("attn_ln.bias", False),
    "attn_q_w": ("attn.query.weight", True), "attn_q_b": ("attn.query.bias", False),
    "attn_k_w": ("attn.key.weight", True),
    "attn_v_w": ("attn.value.weight", True), "attn_v_b": ("attn.value.bias", False),
    "attn_o_w": ("attn.out.weight", True), "attn_o_b": ("attn.out.bias", False),
    "mlp_ln_g": ("mlp_ln.weight", False), "mlp_ln_b": ("mlp_ln.bias", False),
    "mlp_w1": ("mlp.0.weight", True), "mlp_b1": ("mlp.0.bias", False),
    "mlp_w2": ("mlp.2.weight", True), "mlp_b2": ("mlp.2.bias", False),
}
_CROSS_MAP = {
    "cross_ln_g": ("cross_attn_ln.weight", False),
    "cross_ln_b": ("cross_attn_ln.bias", False),
    "cross_q_w": ("cross_attn.query.weight", True),
    "cross_q_b": ("cross_attn.query.bias", False),
    "cross_k_w": ("cross_attn.key.weight", True),
    "cross_v_w": ("cross_attn.value.weight", True),
    "cross_v_b": ("cross_attn.value.bias", False),
    "cross_o_w": ("cross_attn.out.weight", True),
    "cross_o_b": ("cross_attn.out.bias", False),
}
# JAX top-level leaf -> torch name (conv kernels permute (k, in, out) <-> (out, in, k))
_ENC_MAP = {
    "conv1_b": "encoder.conv1.bias", "conv2_b": "encoder.conv2.bias",
    "ln_post_g": "encoder.ln_post.weight", "ln_post_b": "encoder.ln_post.bias",
}
_DEC_MAP = {
    "token_embedding": "decoder.token_embedding.weight",
    "positional_embedding": "decoder.positional_embedding",
    "ln_g": "decoder.ln.weight", "ln_b": "decoder.ln.bias",
}


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a))  # a writable, contiguous copy


def state_dict_from_jax_params(params: Dict[str, Any], dims: ModelDimensions) -> StateDict:
    """The JAX package's param pytree (leaves as numpy arrays) -> state dict."""
    enc, dec = params["encoder"], params["decoder"]
    sd: StateDict = {
        "encoder.conv1.weight": _t(np.asarray(enc["conv1_w"]).transpose(2, 1, 0)),
        "encoder.conv2.weight": _t(np.asarray(enc["conv2_w"]).transpose(2, 1, 0)),
        "encoder.positional_embedding": _t(sinusoids(dims.n_audio_ctx, dims.n_audio_state)),
    }
    sd.update({name: _t(np.asarray(enc[leaf])) for leaf, name in _ENC_MAP.items()})
    sd.update({name: _t(np.asarray(dec[leaf])) for leaf, name in _DEC_MAP.items()})

    def unstack(prefix: str, blocks: Dict[str, Any], mapping) -> None:
        for leaf, (name, transpose) in mapping.items():
            stacked = np.asarray(blocks[leaf])
            for i in range(stacked.shape[0]):
                sd[f"{prefix}.{i}.{name}"] = _t(stacked[i].T if transpose else stacked[i])

    unstack("encoder.blocks", enc["blocks"], _SELF_MAP)
    unstack("decoder.blocks", dec["blocks"], {**_SELF_MAP, **_CROSS_MAP})
    return sd


def jax_params_from_state_dict(sd: StateDict, dims: ModelDimensions) -> Dict[str, Any]:
    """Inverse of :func:`state_dict_from_jax_params` (numpy leaves)."""

    def npy(name: str) -> np.ndarray:
        return sd[name].detach().cpu().float().numpy()

    def stack(prefix: str, n_layer: int, mapping) -> Dict[str, np.ndarray]:
        out = {}
        for leaf, (name, transpose) in mapping.items():
            per_layer = [npy(f"{prefix}.{i}.{name}") for i in range(n_layer)]
            out[leaf] = np.stack([a.T if transpose else a for a in per_layer])
        return out

    encoder = {leaf: npy(name) for leaf, name in _ENC_MAP.items()}
    encoder["conv1_w"] = npy("encoder.conv1.weight").transpose(2, 1, 0)
    encoder["conv2_w"] = npy("encoder.conv2.weight").transpose(2, 1, 0)
    encoder["blocks"] = stack("encoder.blocks", dims.n_audio_layer, _SELF_MAP)
    decoder = {leaf: npy(name) for leaf, name in _DEC_MAP.items()}
    decoder["blocks"] = stack(
        "decoder.blocks", dims.n_text_layer, {**_SELF_MAP, **_CROSS_MAP}
    )
    return {"encoder": encoder, "decoder": decoder}


def strip_padding_row(sd: StateDict) -> StateDict:
    """Training -> inference weights: drop the padding-token embedding row."""
    name = "decoder.token_embedding.weight"
    if sd[name].shape[0] == PADDING_TOKEN + 1:
        sd = dict(sd)
        sd[name] = sd[name][:PADDING_TOKEN]
    return sd


def load_npz_checkpoint(path: str) -> Tuple[StateDict, ModelDimensions]:
    """Read the JAX package's ``save_npz_checkpoint`` format."""
    with np.load(path, allow_pickle=False) as data:
        dims = ModelDimensions(**json.loads(str(data["__dims__"])))
        tree: Dict[str, Any] = {}
        for key in data.files:
            if key == "__dims__":
                continue
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = data[key]
    return state_dict_from_jax_params(tree, dims), dims


def save_npz_checkpoint(path: str, sd: StateDict, dims: ModelDimensions) -> None:
    """Write the JAX package's ``save_npz_checkpoint`` format from a state
    dict: its param tree's leaves as fp32 under flat ``a/b/c`` keys, plus the
    ``__dims__`` JSON."""

    def flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
        flat = {}
        for k, v in tree.items():
            flat.update(flatten(v, f"{prefix}{k}/") if isinstance(v, dict)
                        else {f"{prefix}{k}": v})
        return flat

    np.savez(path, **flatten(jax_params_from_state_dict(sd, dims)),
             __dims__=json.dumps(dims.to_dict()))


def load_torch_checkpoint(path: str) -> Tuple[StateDict, ModelDimensions]:
    """Read a reference ``.pt`` checkpoint (dims + model_state_dict)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    dims = ModelDimensions(**ckpt["dims"])
    sd = ckpt.get("model_state_dict") or ckpt.get("state_dict") or ckpt
    return {k.removeprefix("module."): v for k, v in sd.items()}, dims
