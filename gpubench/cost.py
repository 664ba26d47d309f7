"""The yardstick's arithmetic: operations and bytes from shapes, and the
peaks they are held to.

Matrix products count two operations a multiply-add. ``train_flops_per_sample``
is the port's (``training/train.py``, itself a copy of the TPU benchmark's), copied here so
that the program cannot change what it is measured against. The kernel
counts give each input byte read once and each output byte written once, and
the operations that the inputs need (causal attention counts the lower
triangle), so a share of the least time cannot pass 100% unless the kernel
time leaves part of the work out.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

PEAKS_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "peaks.json")


def peaks(kind: str) -> Optional[Dict[str, float]]:
    """The published peaks of the card named ``kind``
    (``torch.cuda.get_device_name()``), or None for a card not in the table."""
    with open(PEAKS_FILE) as f:
        table = json.load(f)
    return table.get(kind)


def least_time_s(ops: float, nbytes: float, peak: Dict[str, float]) -> float:
    """The least time the card could take: the larger of the operations
    over the bf16 rate and the bytes over the memory bandwidth."""
    return max(ops / peak["bf16_flops_per_s"], nbytes / peak["hbm_bytes_per_s"])


def _enc_layer_fwd(d: int, ta: int) -> float:
    return 24 * ta * d * d + 4 * ta * ta * d


def _conv_fwd(dims) -> float:
    d, ta = dims["n_audio_state"], dims["n_audio_ctx"]
    return 2 * 3 * dims["n_mels"] * d * (2 * ta) + 2 * 3 * d * d * ta


def train_flops_per_sample(dims) -> float:
    """Forward and backward FLOPs of one training sample (30 s of audio, the
    n_text_ctx text positions): matrix products only, the backward twice the
    forward, the remat recompute not counted."""
    d, la = dims["n_audio_state"], dims["n_audio_layer"]
    dt, lt = dims["n_text_state"], dims["n_text_layer"]
    ta, tt = dims["n_audio_ctx"], dims["n_text_ctx"]
    dec_layer = (
        8 * tt * dt * dt + 4 * tt * tt * dt
        + 4 * tt * dt * dt + 4 * ta * dt * dt + 4 * tt * ta * dt
        + 16 * tt * dt * dt
    )
    logits = 2 * tt * dt * (dims["n_vocab"] + 1)
    fwd = _conv_fwd(dims) + la * _enc_layer_fwd(d, ta) + lt * dec_layer + logits
    return 3.0 * fwd


def encoder_flops_per_window(dims) -> float:
    """Forward FLOPs of the encoder over one 30 s window."""
    return _conv_fwd(dims) + dims["n_audio_layer"] * _enc_layer_fwd(
        dims["n_audio_state"], dims["n_audio_ctx"])


def cross_kv_flops_per_window(dims) -> float:
    """The cross K and V projections of every decoder layer, once a window."""
    d = dims["n_text_state"]
    return dims["n_text_layer"] * 4 * dims["n_audio_ctx"] * d * d


def decoder_flops_per_token(dims, position: int) -> float:
    """One token row of the decoder at ``position`` through the cache: the
    self, cross and MLP products, attention over position + 1 keys and the
    audio, and the logits."""
    d, ta = dims["n_text_state"], dims["n_audio_ctx"]
    per_layer = 28 * d * d + 4 * (position + 1) * d + 4 * ta * d
    return dims["n_text_layer"] * per_layer + 2 * d * dims["n_vocab"]


def cross_attend_call(dims, windows: int, kv_bytes: int) -> Dict[str, float]:
    """The attention core of ``cross_block_decode`` (row 1) over ``windows``
    rows, one window each, for one layer: q (fp32) in, K and V read once
    (with their fp32 per-position scales when int8), the output written in
    bf16; q.K and p.V over the audio positions."""
    d, ta = dims["n_text_state"], dims["n_audio_ctx"]
    nbytes = 2 * windows * ta * d * kv_bytes + windows * d * 4 + windows * d * 2
    if kv_bytes == 1:
        nbytes += 2 * windows * ta * 4
    return {"ops": 4.0 * windows * ta * d, "bytes": float(nbytes)}


def layer_block_call(dims, rows: int, offset: int) -> Dict[str, float]:
    """``layer_block_decode`` ("sc", row 7) over ``rows`` token rows at ring
    position ``offset``, one layer, bf16 activations over an int8 cross
    cache: x in and out, the self sub-block's fused QKV and out products and
    the cross q and out products (bf16 weights, read once), the rings'
    ``offset`` valid positions read, the new key and value written, the
    int8 cross K and V with their scales read once, two LayerNorms."""
    d, ta = dims["n_text_state"], dims["n_audio_ctx"]
    weights = (6 * d * d + 6 * d + 4 * d) * 2
    nbytes = (weights + 2 * rows * d * 2 + 2 * rows * offset * d * 2 + 2 * rows * d * 2
              + 2 * rows * ta * d + 2 * rows * ta * 4)
    ops = 2 * rows * 6 * d * d + 4 * rows * (offset + 1) * d + 4 * rows * ta * d
    return {"ops": float(ops), "bytes": float(nbytes)}


def train_attention_per_sample(dims) -> Dict[str, float]:
    """The training attention of one sample (rows 3 and 9): the encoder's
    self-attention over the audio, the decoder's causal self-attention over
    n_text_ctx positions (the lower triangle) and its cross-attention,
    forward and backward (the backward's four products: twice the forward),
    bf16 operands; the remat forward is not counted."""
    da, la, ta = dims["n_audio_state"], dims["n_audio_layer"], dims["n_audio_ctx"]
    dt, lt, tt = dims["n_text_state"], dims["n_text_layer"], dims["n_text_ctx"]
    fwd_ops = la * 4 * ta * ta * da + lt * (2 * tt * (tt + 1) * dt + 4 * tt * ta * dt)
    # forward: q, k, v in, o out; backward: q, k, v, o, do in, dq, dk, dv out
    fwd_bytes = la * 4 * ta * da * 2 + lt * (4 * tt * dt * 2 + (2 * tt + 2 * ta) * dt * 2)
    bwd_bytes = la * 8 * ta * da * 2 + lt * (8 * tt * dt * 2 + (4 * tt + 4 * ta) * dt * 2)
    return {"ops": 3.0 * fwd_ops, "bytes": float(fwd_bytes + bwd_bytes)}
