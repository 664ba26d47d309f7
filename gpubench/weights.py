"""Random weights of a Whisper-shaped model, made on the device from a seed.

Both the port and the plain reference are handed the same state dict (the
reference upcasts it to fp32), under the module names the port and the
released checkpoints use. The draws are two large calls on one
``torch.Generator`` of the device: a normal draw for every matrix and
embedding, scaled per leaf by sqrt(2 / fan_in), and a uniform draw for every
bias, scaled to +-1 / sqrt(fan_in); LayerNorms are ones and zeros, the
padding row (id 51864, training only) is zero and the encoder's position
table is the usual sinusoid table. The same seed on the same device gives
the same bits, so the training check draws the initial weights again.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

PADDING_TOKEN = 51864
SEED_MOD = 2 ** 63


def norm_seed(seed: int) -> int:
    """Any whole number as a seed of ``torch.Generator`` and numpy."""
    return int(seed) % SEED_MOD


def leaf_specs(dims: Dict[str, int], padding_row: bool) -> List[Tuple[str, tuple, str, int]]:
    """(name, shape, kind, fan_in) of every leaf, in the port's order;
    kind is normal, uniform, ones, zeros or sinusoid."""
    specs = []
    da, dt, m = dims["n_audio_state"], dims["n_text_state"], dims["n_mels"]

    def linear(prefix, n_out, n_in, bias=True):
        specs.append((f"{prefix}.weight", (n_out, n_in), "normal", n_in))
        if bias:
            specs.append((f"{prefix}.bias", (n_out,), "uniform", n_in))

    def ln(prefix, d):
        specs.append((f"{prefix}.weight", (d,), "ones", 0))
        specs.append((f"{prefix}.bias", (d,), "zeros", 0))

    def block(prefix, d, cross):
        for attn in ("attn", "cross_attn") if cross else ("attn",):
            linear(f"{prefix}.{attn}.query", d, d)
            linear(f"{prefix}.{attn}.key", d, d, bias=False)
            linear(f"{prefix}.{attn}.value", d, d)
            linear(f"{prefix}.{attn}.out", d, d)
            ln(f"{prefix}.{attn}_ln", d)
        linear(f"{prefix}.mlp.0", 4 * d, d)
        linear(f"{prefix}.mlp.2", d, 4 * d)
        ln(f"{prefix}.mlp_ln", d)

    specs.append(("encoder.conv1.weight", (da, m, 3), "normal", 3 * m))
    specs.append(("encoder.conv1.bias", (da,), "uniform", 3 * m))
    specs.append(("encoder.conv2.weight", (da, da, 3), "normal", 3 * da))
    specs.append(("encoder.conv2.bias", (da,), "uniform", 3 * da))
    specs.append(("encoder.positional_embedding", (dims["n_audio_ctx"], da), "sinusoid", 0))
    for i in range(dims["n_audio_layer"]):
        block(f"encoder.blocks.{i}", da, False)
    ln("encoder.ln_post", da)
    n_rows = dims["n_vocab"] + int(padding_row)
    specs.append(("decoder.token_embedding.weight", (n_rows, dt), "normal", dt))
    specs.append(("decoder.positional_embedding", (dims["n_text_ctx"], dt), "normal", dt))
    for i in range(dims["n_text_layer"]):
        block(f"decoder.blocks.{i}", dt, True)
    ln("decoder.ln", dt)
    return specs


def sinusoids(length: int, channels: int) -> np.ndarray:
    """Whisper's sinusoid position table (float32)."""
    inc = math.log(10000) / (channels // 2 - 1)
    inv = np.exp(-inc * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


@torch.no_grad()
def make_state_dict(dims: Dict[str, int], seed: int, device, dtype: torch.dtype,
                    padding_row: bool = False) -> Dict[str, torch.Tensor]:
    """The weights of ``seed`` on ``device`` in ``dtype``: each leaf a view of
    one of two flat buffers (normal and uniform draws) or a small tensor of
    its own."""
    specs = leaf_specs(dims, padding_row)
    gen = torch.Generator(device=device)
    gen.manual_seed(norm_seed(seed))
    sizes = {k: sum(math.prod(s) for _, s, kind, _ in specs if kind == k)
             for k in ("normal", "uniform")}
    flats = {
        "normal": torch.randn(sizes["normal"], generator=gen, device=device),
        "uniform": torch.rand(sizes["uniform"], generator=gen, device=device),
    }
    offsets = {"normal": 0, "uniform": 0}
    scaled = []
    for name, shape, kind, fan_in in specs:
        if kind in flats:
            n = math.prod(shape)
            view = flats[kind][offsets[kind]:offsets[kind] + n]
            offsets[kind] += n
            if kind == "normal":
                view.mul_(math.sqrt(2.0 / fan_in))
            else:
                bound = 1.0 / math.sqrt(fan_in)
                view.mul_(2 * bound).sub_(bound)
            scaled.append((name, shape, kind, offsets[kind] - n))
    flats = {k: v.to(dtype) for k, v in flats.items()}
    sd: Dict[str, torch.Tensor] = {}
    for name, shape, kind, start in scaled:
        n = math.prod(shape)
        sd[name] = flats[kind][start:start + n].view(shape)
    for name, shape, kind, _ in specs:
        if kind == "ones":
            sd[name] = torch.ones(shape, device=device, dtype=dtype)
        elif kind == "zeros":
            sd[name] = torch.zeros(shape, device=device, dtype=dtype)
        elif kind == "sinusoid":
            sd[name] = torch.from_numpy(sinusoids(*shape)).to(device=device, dtype=dtype)
    if padding_row:
        sd["decoder.token_embedding.weight"][PADDING_TOKEN].zero_()
    return {name: sd[name] for name, *_ in specs}
