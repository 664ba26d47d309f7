"""Whisper-architecture encoder-decoder in PyTorch.

Counterpart of ``olmoasr_tpu/models/whisper.py``. The modules carry the
reference's torch state-dict names (``encoder.blocks.{i}.attn.query.weight``,
``decoder.token_embedding.weight``, ...), so released ``.pt`` checkpoints load
as they are; the forward passes are plain functions over those modules. The
training forward (``Whisper.forward``) calls each block as a module
(``ResidualAttentionBlock.forward``), so that data-parallel wrappers (DDP,
FSDP2) see the calls; inference runs on the unwrapped model.

Numerics follow the JAX model: fp32 LayerNorm islands cast back, q and k each
scaled by dh^-0.25 with an fp32 softmax in the plain attention, exact (erf)
GELU, products in the weights' dtype, logits through the tied token embedding
returned in fp32. The kernels of the inference path: the encoder's
self-attention (``ops.train_attention``) and, at S=1 decode steps, the whole
decoder layer (``ops.attention``): ``ln_matmul`` (fused QKV),
``self_attend_decode`` (bf16, fp32 or int8 rings), ``matmul_residual``,
``cross_block_decode`` and ``mlp_block``, or the routes of the JAX step's
kernel matrix (``decode_step``'s ``route``) through ``layer_block_decode``
and ``cross_attend_decode``. The training forward (``forward_train``: ``encode_train`` and
``decode_train``) sends the encoder's self-attention and the decoder's self-
and cross-attention through ``ops.train_attention``'s forward and backward
kernels, or with ``attention="flash"`` through ``ops.flash``'s (the JAX
package's flash route, which it picks by environment switches); fp32
parameters are cast to the compute dtype op by op, so their gradients come
back in fp32.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from olmoasr_tpu_torch.models.dims import ModelDimensions
from olmoasr_tpu_torch.ops.attention import (
    cross_attend_decode,
    cross_block_decode,
    cross_block_decode_plain,
    layer_block_decode,
    ln_matmul,
    matmul_residual,
    mlp_block,
    mlp_block_plain,
    self_attend_decode,
)
from olmoasr_tpu_torch.ops.flash import flash_mha, flash_self_attention
from olmoasr_tpu_torch.ops.train_attention import (
    cross_attention,
    dec_self_attention,
    enc_self_attention,
)

PADDING_TOKEN = 51864


def sinusoids(length: int, channels: int, max_timescale: float = 10000) -> np.ndarray:
    """Sinusoidal position embedding of the audio encoder (a constant)."""
    assert channels % 2 == 0
    log_timescale_increment = np.log(max_timescale) / (channels // 2 - 1)
    inv_timescales = np.exp(-log_timescale_increment * np.arange(channels // 2))
    scaled_time = np.arange(length)[:, None] * inv_timescales[None, :]
    return np.concatenate([np.sin(scaled_time), np.cos(scaled_time)], axis=1).astype(
        np.float32
    )


# ---------------------------------------------------------------------------
# modules (containers with the reference's parameter names)
# ---------------------------------------------------------------------------


class MultiHeadAttention(nn.Module):
    def __init__(self, n_state: int, n_head: int, **factory):
        super().__init__()
        self.n_head = n_head
        self.query = nn.Linear(n_state, n_state, **factory)
        self.key = nn.Linear(n_state, n_state, bias=False, **factory)
        self.value = nn.Linear(n_state, n_state, **factory)
        self.out = nn.Linear(n_state, n_state, **factory)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, n_state: int, n_head: int, cross_attention: bool, **factory):
        super().__init__()
        self.attn = MultiHeadAttention(n_state, n_head, **factory)
        self.attn_ln = nn.LayerNorm(n_state, **factory)
        if cross_attention:
            self.cross_attn = MultiHeadAttention(n_state, n_head, **factory)
            self.cross_attn_ln = nn.LayerNorm(n_state, **factory)
        self.mlp = nn.Sequential(
            nn.Linear(n_state, 4 * n_state, **factory),
            nn.GELU(),
            nn.Linear(4 * n_state, n_state, **factory),
        )
        self.mlp_ln = nn.LayerNorm(n_state, **factory)

    def forward(self, x: torch.Tensor, n_head: int, attention: str,
                audio: Optional[torch.Tensor] = None, key_bias: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The training forward of this block: ``_encoder_block``, or with
        ``audio`` ``_decoder_block``. The training forwards call it as a
        module, so that a wrapper's hooks fire around it (FSDP2's unshard
        before it and its gradient reduce-scatter after its backward)."""
        if audio is None:
            return _encoder_block(x, self, n_head, attention)
        return _decoder_block(x, self, audio, n_head, key_bias, attention, mask)


class AudioEncoder(nn.Module):
    def __init__(self, dims: ModelDimensions, **factory):
        super().__init__()
        d = dims.n_audio_state
        self.conv1 = nn.Conv1d(dims.n_mels, d, kernel_size=3, padding=1, **factory)
        self.conv2 = nn.Conv1d(d, d, kernel_size=3, stride=2, padding=1, **factory)
        self.register_buffer(
            "positional_embedding", torch.empty(dims.n_audio_ctx, d, **factory)
        )
        self.blocks = nn.ModuleList(
            ResidualAttentionBlock(d, dims.n_audio_head, False, **factory)
            for _ in range(dims.n_audio_layer)
        )
        self.ln_post = nn.LayerNorm(d, **factory)


class TextDecoder(nn.Module):
    def __init__(self, dims: ModelDimensions, n_vocab: int, **factory):
        super().__init__()
        d = dims.n_text_state
        self.token_embedding = nn.Embedding(n_vocab, d, **factory)
        self.positional_embedding = nn.Parameter(torch.empty(dims.n_text_ctx, d, **factory))
        self.blocks = nn.ModuleList(
            ResidualAttentionBlock(d, dims.n_text_head, True, **factory)
            for _ in range(dims.n_text_layer)
        )
        self.ln = nn.LayerNorm(d, **factory)


class Whisper(nn.Module):
    """Encoder-decoder with the reference's module tree.

    ``include_padding_token`` adds the training vocabulary's extra embedding
    row (id 51864); inference checkpoints do not have it.

    Inference keeps derived weights beside the parameters, each made on first
    use: a copy of the model per compute dtype (``in_dtype``) and the decode
    step's fused QKV projection (``fused_qkv``). ``load_state_dict`` and
    ``.to()`` (any ``_apply``) drop them; an in-place edit of a parameter
    does not, so call ``drop_derived()`` after one.
    """

    def __init__(self, dims: ModelDimensions, include_padding_token: bool = False,
                 device=None, dtype=None):
        super().__init__()
        self.dims = dims
        self._derived: dict = {}
        factory = dict(device=device, dtype=dtype)
        self.encoder = AudioEncoder(dims, **factory)
        self.decoder = TextDecoder(dims, dims.n_vocab + int(include_padding_token), **factory)
        if self.encoder.positional_embedding.device.type != "meta":
            self.reset_positional_embedding()

    def drop_derived(self) -> None:
        self._derived = {}

    def _apply(self, fn, *args, **kwargs):
        self.drop_derived()
        return super()._apply(fn, *args, **kwargs)

    def load_state_dict(self, *args, **kwargs):
        self.drop_derived()
        return super().load_state_dict(*args, **kwargs)

    @torch.no_grad()
    def in_dtype(self, dtype: torch.dtype) -> "Whisper":
        """This model with its weights in ``dtype``: itself when they are,
        else a copy made on first use and reused by later calls (the
        kernels take weights in the activation dtype)."""
        if self.dtype == dtype:
            return self
        if dtype not in self._derived:
            derived, self._derived = self._derived, {}
            try:
                twin = copy.deepcopy(self).to(dtype)
            finally:
                self._derived = derived
            self._derived[dtype] = twin
        return self._derived[dtype]

    @torch.no_grad()
    def fused_qkv(self):
        """The decoder's self-attention projections fused per layer, stacked:
        weights (L, 3D, D) = [Wq; Wk; Wv] and biases (L, 3D) = [bq, 0, bv]
        (the key projection has no bias). Built once, as the JAX package's
        scan-invariant concat is hoisted out of its decode loop."""
        if "qkv" not in self._derived:
            attn = [blk.attn for blk in self.decoder.blocks]
            self._derived["qkv"] = (
                torch.stack([torch.cat([a.query.weight, a.key.weight, a.value.weight])
                             for a in attn]),
                torch.stack([torch.cat([a.query.bias, torch.zeros_like(a.query.bias),
                                        a.value.bias]) for a in attn]),
            )
        return self._derived["qkv"]

    def reset_positional_embedding(self) -> None:
        pos = self.encoder.positional_embedding
        pos.copy_(torch.from_numpy(sinusoids(*pos.shape)))

    def forward(self, mel: torch.Tensor, tokens: torch.Tensor,
                padding_mask: Optional[torch.Tensor] = None, *, compute_dtype=torch.bfloat16,
                remat: bool = False, return_hidden: bool = False,
                attention: str = "kernel") -> torch.Tensor:
        """The training forward, :func:`forward_train` (fp32 logits), so that
        ``model(mel, tokens, padding_mask)`` works as in the JAX package, and
        a data-parallel wrapper of the model (DDP, FSDP2) runs its hooks
        around the whole step's forward."""
        return forward_train(self, mel, tokens, padding_mask, compute_dtype=compute_dtype,
                             remat=remat, return_hidden=return_hidden, attention=attention)

    @property
    def device(self) -> torch.device:
        return self.decoder.token_embedding.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.decoder.token_embedding.weight.dtype


def empty_model(dims: ModelDimensions, include_padding_token: bool = False,
                device="cpu", dtype=torch.float32, cls=Whisper) -> Whisper:
    """A model with uninitialised parameters (built without a default init
    pass) and its sinusoid buffer set."""
    model = cls(dims, include_padding_token, device="meta", dtype=dtype)
    model = model.to_empty(device=device)
    with torch.no_grad():
        model.reset_positional_embedding()
    return model


@torch.no_grad()
def init_params(model: Whisper, generator: torch.Generator,
                include_padding_token: bool = False) -> Whisper:
    """Random init in the JAX package's scheme (``init_params``): kaiming-normal
    weights (std sqrt(2 / fan_in)), uniform(+-1/sqrt(fan_in)) biases, LayerNorm
    ones/zeros, a zeroed padding row. Numbers come from ``generator`` on the
    CPU, so a seed gives the same weights on every device."""

    def normal(p, fan_in):
        t = torch.randn(p.shape, generator=generator, dtype=torch.float32)
        p.copy_(t * np.sqrt(2.0 / fan_in))

    def uniform(p, fan_in):
        bound = 1.0 / np.sqrt(fan_in)
        t = torch.rand(p.shape, generator=generator, dtype=torch.float32)
        p.copy_(t * (2 * bound) - bound)

    for module in model.modules():
        if isinstance(module, nn.LayerNorm):
            module.weight.fill_(1.0)
            module.bias.fill_(0.0)
        elif isinstance(module, (nn.Linear, nn.Conv1d)):
            fan_in = module.weight[0].numel()  # in_features (x kernel width)
            normal(module.weight, fan_in)
            if module.bias is not None:
                uniform(module.bias, fan_in)
    dec = model.decoder
    d_text = dec.token_embedding.weight.shape[1]
    normal(dec.token_embedding.weight, d_text)
    if include_padding_token:
        dec.token_embedding.weight[PADDING_TOKEN].zero_()
    normal(dec.positional_embedding, d_text)
    return model


# ---------------------------------------------------------------------------
# core ops
# ---------------------------------------------------------------------------


def layer_norm(x: torch.Tensor, ln: nn.LayerNorm, eps: float = 1e-5) -> torch.Tensor:
    """fp32 LayerNorm island, cast back to x's dtype (torch's layer_norm
    computes bf16 inputs in fp32 and rounds once at the output). Weights of
    another dtype (fp32 parameters under bf16 training compute) join the
    island in fp32, as the JAX package's ``layer_norm`` takes them."""
    if ln.weight.dtype == x.dtype:
        return F.layer_norm(x, x.shape[-1:], ln.weight, ln.bias, eps)
    y = F.layer_norm(x.float(), x.shape[-1:], ln.weight.float(), ln.bias.float(), eps)
    return y.to(x.dtype)


def _linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    return F.linear(x, layer.weight.to(x.dtype),
                    None if layer.bias is None else layer.bias.to(x.dtype))


def _split_heads(x: torch.Tensor, n_head: int) -> torch.Tensor:
    B, T, D = x.shape
    return x.view(B, T, n_head, D // n_head).transpose(1, 2)  # (B, H, T, dh)


def sdpa(q, k, v, n_head: int, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention with q and k each scaled by dh^-0.25 and an fp32 softmax;
    ``mask`` is additive, broadcastable to (B, H, Tq, Tk)."""
    B, Tq, D = q.shape
    scale = (D // n_head) ** -0.25
    qh = _split_heads(q, n_head) * scale
    kh = _split_heads(k, n_head) * scale
    logits = (qh @ kh.transpose(-1, -2)).float()
    if mask is not None:
        logits = logits + mask.float()
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    return (w @ _split_heads(v, n_head)).transpose(1, 2).reshape(B, Tq, D)


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------


def _mlp(x: torch.Tensor, blk: ResidualAttentionBlock) -> torch.Tensor:
    h = layer_norm(x, blk.mlp_ln)
    return x + _linear(F.gelu(_linear(h, blk.mlp[0])), blk.mlp[2])


ATTENTION_ROUTES = ("kernel", "flash")


def _check_attention(attention: str) -> None:
    """The training attention route: ``"kernel"`` (``ops.train_attention``,
    the JAX package's ``OLMOASR_ENC_ATTN`` / ``OLMOASR_DEC_ATTN`` =
    ``kernel``) or ``"flash"`` (``ops.flash``, its flash route with
    ``OLMOASR_TRAIN_FLASH_DEC=1``)."""
    if attention not in ATTENTION_ROUTES:
        raise ValueError(f"attention must be one of {ATTENTION_ROUTES}, got {attention!r}")


def _encoder_block(x: torch.Tensor, blk: ResidualAttentionBlock, n_head: int,
                   attention: str) -> torch.Tensor:
    h = layer_norm(x, blk.attn_ln)
    q = _linear(h, blk.attn.query)
    k = _linear(h, blk.attn.key)
    v = _linear(h, blk.attn.value)
    attend = flash_self_attention if attention == "flash" else enc_self_attention
    x = x + _linear(attend(q, k, v, n_head), blk.attn.out)
    return _mlp(x, blk)


def _blocks(x: torch.Tensor, blocks, remat: bool, *args, **kwargs) -> torch.Tensor:
    """x through each block's module call ``blk(x, *args, **kwargs)``;
    ``remat`` recomputes each block's forward in the backward (non-reentrant
    checkpointing over the call), as the JAX package's ``jax.checkpoint`` per
    block."""
    for blk in blocks:
        x = (checkpoint(blk, x, *args, use_reentrant=False, **kwargs) if remat
             else blk(x, *args, **kwargs))
    return x


def encode_train(model: Whisper, mel: torch.Tensor, *, compute_dtype=torch.bfloat16,
                 remat: bool = False, attention: str = "kernel") -> torch.Tensor:
    """The encoder with gradients (JAX ``encode_audio`` as training calls it):
    (B, n_mels, 2 * n_audio_ctx) mel -> (B, n_audio_ctx, D) in
    ``compute_dtype``: conv stem with exact GELU -> + sinusoids -> blocks ->
    ln_post; the blocks' attention is ``enc_self_attention``, or
    ``flash_self_attention`` with ``attention="flash"``."""
    _check_attention(attention)
    enc = model.encoder
    x = mel.to(device=model.device, dtype=compute_dtype)
    x = F.gelu(F.conv1d(x, enc.conv1.weight.to(x.dtype), enc.conv1.bias.to(x.dtype), padding=1))
    x = F.gelu(F.conv1d(x, enc.conv2.weight.to(x.dtype), enc.conv2.bias.to(x.dtype), stride=2,
                        padding=1))
    x = x.transpose(1, 2).contiguous() + enc.positional_embedding.to(x.dtype)
    x = _blocks(x, enc.blocks, remat, model.dims.n_audio_head, attention)
    return layer_norm(x, enc.ln_post)


@torch.no_grad()
def encode_audio(model: Whisper, mel: torch.Tensor, attention: str = "kernel") -> torch.Tensor:
    """``encode_train`` for inference: no gradients, in the weights' dtype."""
    return encode_train(model, mel, compute_dtype=model.dtype, attention=attention)


# ---------------------------------------------------------------------------
# decoder: full-sequence (training) forward
# ---------------------------------------------------------------------------


def _decoder_block(x: torch.Tensor, blk: ResidualAttentionBlock, audio: torch.Tensor,
                   n_head: int, key_bias: Optional[torch.Tensor], attention: str,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    h = layer_norm(x, blk.attn_ln)
    q = _linear(h, blk.attn.query)
    k = _linear(h, blk.attn.key)
    v = _linear(h, blk.attn.value)
    if attention == "flash":
        # the key bias as segment ids, text 0 and pads 1 (JAX decode_train's
        # flash route): a pad query attends the pads at or before it
        ids = None if key_bias is None else (key_bias != 0).int()
        attn = flash_mha(q, k, v, n_head, causal=True, q_ids=ids, kv_ids=ids)
        attend = flash_mha
    elif mask is not None:
        # a legacy full mask (causal included): plain attention for both, the
        # cross attention unmasked (JAX decode_train's XLA route)
        attn, attend = sdpa(q, k, v, n_head, mask), sdpa
    else:
        attn, attend = dec_self_attention(q, k, v, n_head, key_bias), cross_attention
    x = x + _linear(attn, blk.attn.out)
    # cross K/V: this layer's projections of the audio features
    ck = _linear(audio, blk.cross_attn.key)
    cv = _linear(audio, blk.cross_attn.value)
    q = _linear(layer_norm(x, blk.cross_attn_ln), blk.cross_attn.query)
    x = x + _linear(attend(q, ck, cv, n_head), blk.cross_attn.out)
    return _mlp(x, blk)


def decode_train(model: Whisper, tokens: torch.Tensor, audio_features: torch.Tensor,
                 padding_mask: Optional[torch.Tensor] = None, *, remat: bool = False,
                 return_hidden: bool = False, attention: str = "kernel") -> torch.Tensor:
    """The decoder's teacher-forced forward (JAX ``decode_train``): tokens
    (B, T), PADDING_TOKEN allowed, over audio features (B, Ta, D) in the
    compute dtype -> fp32 logits (B, T, vocab rows) through the tied
    embedding, the padding row included; ``return_hidden`` stops before the
    logits. ``padding_mask`` is the loader's additive (B, T) per-key bias
    (-inf on pad columns, clamped to -1e9 in the kernels); self-attention is
    causal, cross-attention unmasked. ``attention`` picks the kernels
    (``"kernel"`` or ``"flash"``, see ``encode_train``).

    A legacy additive (B, T, T) or (B, 1, T, T) ``padding_mask`` goes as the
    JAX package takes it: on the kernel route, self-attention is plain
    attention (``sdpa``) under ``padding_mask + causal`` and cross-attention
    plain and unmasked, outside the kernels; on the flash route the
    segment ids come from the mask's first query row."""
    _check_attention(attention)
    dec = model.decoder
    T = tokens.shape[1]
    dtype = audio_features.dtype
    x = dec.token_embedding.weight[tokens.long()].to(dtype) + dec.positional_embedding[:T].to(dtype)
    key_bias = mask = None
    if padding_mask is not None and padding_mask.dim() == 2:
        key_bias = padding_mask.float()
    elif padding_mask is not None:
        full = padding_mask[:, None] if padding_mask.dim() == 3 else padding_mask
        if attention == "flash":
            key_bias = full[:, 0, 0, :].float()
        else:
            causal = torch.full((T, T), float("-inf"), device=x.device).triu(1)
            mask = full.to(device=x.device, dtype=torch.float32) + causal
    x = _blocks(x, dec.blocks, remat, model.dims.n_text_head, attention, audio_features,
                key_bias, mask)
    x = layer_norm(x, dec.ln)
    if return_hidden:
        return x
    return F.linear(x, dec.token_embedding.weight.to(x.dtype)).float()


def forward_train(model: Whisper, mel: torch.Tensor, tokens: torch.Tensor,
                  padding_mask: Optional[torch.Tensor] = None, *, compute_dtype=torch.bfloat16,
                  remat: bool = False, return_hidden: bool = False,
                  attention: str = "kernel") -> torch.Tensor:
    """mel -> encoder -> decoder -> fp32 logits (JAX ``forward_train``), with
    the attention of ``attention`` (``"kernel"`` or ``"flash"``)."""
    audio = encode_train(model, mel, compute_dtype=compute_dtype, remat=remat,
                         attention=attention)
    return decode_train(model, tokens.to(audio.device), audio, padding_mask, remat=remat,
                        return_hidden=return_hidden, attention=attention)


@torch.no_grad()
def cross_attention_weights(model: Whisper, tokens: torch.Tensor,
                            audio_features: torch.Tensor) -> torch.Tensor:
    """The decoder's full-sequence forward over ``tokens`` (B, T) and
    ``audio_features`` (B, Ta, D), in the features' dtype, returning every
    layer's cross-attention softmax weights, (L, B, H, T, Ta) fp32: the
    alignment that word timestamps read (JAX ``cross_attention_weights``).
    Plain PyTorch: the weights are materialised, which no fused attention
    kernel does; the causal self-attention is ``sdpa``."""
    dec = model.decoder
    B, T = tokens.shape
    dtype = audio_features.dtype
    n_head = model.dims.n_text_head
    scale = (model.dims.n_text_state // n_head) ** -0.25
    x = dec.token_embedding.weight[tokens.long()].to(dtype) + dec.positional_embedding[:T].to(dtype)
    causal = torch.full((T, T), float("-inf"), device=x.device).triu(1)
    out = torch.empty((len(dec.blocks), B, n_head, T, audio_features.shape[1]),
                      dtype=torch.float32, device=x.device)
    for i, blk in enumerate(dec.blocks):
        h = layer_norm(x, blk.attn_ln)
        attn = sdpa(_linear(h, blk.attn.query), _linear(h, blk.attn.key),
                    _linear(h, blk.attn.value), n_head, causal)
        x = x + _linear(attn, blk.attn.out)
        q = _linear(layer_norm(x, blk.cross_attn_ln), blk.cross_attn.query)
        ck = _linear(audio_features, blk.cross_attn.key)
        cv = _linear(audio_features, blk.cross_attn.value)
        qh, kh = _split_heads(q, n_head) * scale, _split_heads(ck, n_head) * scale
        out[i] = torch.softmax((qh @ kh.transpose(-1, -2)).float(), dim=-1)
        attn = (out[i].to(cv.dtype) @ _split_heads(cv, n_head)).transpose(1, 2).reshape(q.shape)
        x = _mlp(x + _linear(attn, blk.cross_attn.out), blk)
    return out


# ---------------------------------------------------------------------------
# decoder: KV-cached incremental inference
# ---------------------------------------------------------------------------


@dataclass
class KVCache:
    """Decoder state. ``self_kv``: (2, L, R, C, D), the key rings then the
    value rings (``self_k``, ``self_v``) of R token rows, positions below
    ``index`` valid, written in place by ``decode_step``; one storage lets a
    step write a layer's new key and value with one copy. The rings are in
    the activation dtype, or int8 with ``self_scale`` (2, L, R, 1, C) fp32
    per-position scales (``self_k_scale``, ``self_v_scale``; None otherwise).
    ``cross_k``/``cross_v``: (L, B, T, D) projections of the B audio windows'
    features, in the activation dtype or int8; ``cross_*_scale``: (L, B, 1,
    T) fp32 per-position scales, ones when the cross cache is not quantized.
    R is a multiple of B: token row r reads window r // (R // B)."""

    self_kv: torch.Tensor
    cross_k: torch.Tensor
    cross_v: torch.Tensor
    cross_k_scale: torch.Tensor
    cross_v_scale: torch.Tensor
    index: int = 0
    self_scale: Optional[torch.Tensor] = None

    @property
    def self_k_scale(self) -> Optional[torch.Tensor]:
        return None if self.self_scale is None else self.self_scale[0]

    @property
    def self_v_scale(self) -> Optional[torch.Tensor]:
        return None if self.self_scale is None else self.self_scale[1]

    @property
    def self_k(self) -> torch.Tensor:
        return self.self_kv[0]

    @property
    def self_v(self) -> torch.Tensor:
        return self.self_kv[1]

    @property
    def kv_group(self) -> int:
        """Token rows per audio window."""
        return self.self_kv.shape[2] // self.cross_k.shape[1]


def _quantize_rows(x: torch.Tensor):
    """Per-row (last axis) symmetric int8 quantization: (int8, fp32 scales)."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(dim=-1), 1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


@torch.no_grad()
def init_cache(
    model: Whisper,
    audio_features: torch.Tensor,  # (B, T, D)
    max_len: Optional[int] = None,
    *,
    quantize_cross: bool = False,
    quantize_self: bool = False,
    self_batch: Optional[int] = None,
) -> KVCache:
    """Allocate the self rings and project every layer's cross K/V once per
    audio window (optionally int8 with per-position scales).

    ``quantize_self``: int8 self rings with zeroed (L, R, 1, C) fp32
    per-position scales, each key and value row quantized as ``decode_step``
    writes it (the JAX package's ``init_cache(quantize_self=True)``).
    ``self_batch`` sizes the self rings apart from the cross cache: best_of
    sampling decodes ``self_batch = B * G`` token rows over the same B
    windows, which share one cross cache instead of G copies."""
    dec = model.decoder
    L = model.dims.n_text_layer
    B, T, D = audio_features.shape
    rows = self_batch or B
    if rows % B:
        raise ValueError(f"self_batch {rows} is not a multiple of the {B} audio windows")
    n_ctx = max_len or model.dims.n_text_ctx
    kw = dict(device=audio_features.device)
    dtype = audio_features.dtype
    kv_dtype = torch.int8 if quantize_cross else dtype
    cross_k = torch.empty((L, B, T, D), dtype=kv_dtype, **kw)
    cross_v = torch.empty((L, B, T, D), dtype=kv_dtype, **kw)
    k_scale = torch.ones((L, B, 1, T), dtype=torch.float32, **kw)
    v_scale = torch.ones((L, B, 1, T), dtype=torch.float32, **kw)
    for i, blk in enumerate(dec.blocks):
        k = _linear(audio_features, blk.cross_attn.key)
        v = _linear(audio_features, blk.cross_attn.value)
        if quantize_cross:
            k, k_scale[i, :, 0] = _quantize_rows(k)
            v, v_scale[i, :, 0] = _quantize_rows(v)
        cross_k[i] = k
        cross_v[i] = v
    return KVCache(
        self_kv=torch.zeros((2, L, rows, n_ctx, D), dtype=torch.int8 if quantize_self else dtype,
                            **kw),
        cross_k=cross_k,
        cross_v=cross_v,
        cross_k_scale=k_scale,
        cross_v_scale=v_scale,
        self_scale=torch.zeros((2, L, rows, 1, n_ctx), dtype=torch.float32, **kw)
        if quantize_self else None,
    )


def _attend_cached(q, k, v, offset: int, n_head: int) -> torch.Tensor:
    """Self-attention of S > 1 queries at positions offset.. over the ring's
    first offset+S positions (this call's keys included), causal among the
    new ones."""
    S, C = q.shape[1], k.shape[1]
    query_pos = offset + torch.arange(S, device=q.device)[:, None]
    future = torch.arange(C, device=q.device)[None, :] > query_pos
    mask = torch.zeros((S, C), dtype=torch.float32, device=q.device)
    return sdpa(q, k, v, n_head, mask.masked_fill(future, float("-inf")))


def _write_ring(cache: KVCache, layer: int, offset: int, kv: torch.Tensor) -> None:
    """This call's keys and values, kv (2, R, S, D), into layer ``layer``'s
    rings at positions offset..; int8 rings take each row quantized with its
    scale, as the JAX step writes them after its layer loop."""
    end = offset + kv.shape[2]
    if cache.self_scale is None:
        cache.self_kv[:, layer, :, offset:end] = kv
        return
    q, scale = _quantize_rows(kv)
    cache.self_kv[:, layer, :, offset:end] = q
    cache.self_scale[:, layer, :, 0, offset:end] = scale


def _ring_prefix(cache: KVCache, layer: int, offset: int, dtype: torch.dtype) -> torch.Tensor:
    """Layer ``layer``'s rings below ``offset``, (2, R, offset, D) in
    ``dtype``: int8 rings dequantized with their scales in fp32 first."""
    kv = cache.self_kv[:, layer, :, :offset]
    if cache.self_scale is None:
        return kv
    return (kv.float() * cache.self_scale[:, layer, :, 0, :offset, None]).to(dtype)


# decode_step's routes: the JAX step's kernel routes as its flag matrix names
# them (tests/test_decode_flag_matrix.py)
ROUTES = ("auto", "split", "layer", "attend")


def _check_route(route: str, cache: KVCache, beam_anc, G: int) -> None:
    """Refuse a single-token step's route whose kernels do not take this
    cache."""
    if route == "layer" and (cache.cross_k.dtype != torch.int8 or G != 1 or beam_anc is not None
                             or cache.self_scale is not None):
        raise ValueError(
            "route 'layer' needs an int8 cross cache, one token row per window (kv_group 1), "
            f"no ancestry map and unquantized self rings; got a {cache.cross_k.dtype} cross "
            f"cache, kv_group {G}, ancestry {beam_anc is not None}, int8 rings "
            f"{cache.self_scale is not None}")
    if route == "attend" and G != 1:
        raise ValueError(f"route 'attend' needs one token row per window (kv_group 1), got {G}")


@torch.no_grad()
def decode_step(model: Whisper, tokens: torch.Tensor, cache: KVCache,
                beam_anc: Optional[torch.Tensor] = None, *, route: str = "auto") -> torch.Tensor:
    """Run the decoder on ``tokens`` (R, S) at positions ``cache.index``..;
    returns fp32 logits (R, S, n_vocab) and advances the cache in place.

    S=1 steps run every sub-block through the hand-written kernels
    (``ops.attention``): ``ln_matmul`` (fused QKV), ``self_attend_decode``
    over the read-only rings, ``matmul_residual``, then the new key and value
    go into the rings, then ``cross_block_decode`` and ``mlp_block``. Over an
    int8 cross cache with one token row per window, no ancestry map and
    unquantized rings, the self and cross sub-blocks run as one
    ``layer_block_decode`` launch, as the JAX step takes its layer block
    there (whisper.py, use_layer_block). A prefill (S>1) is plain tensor
    code, as in the JAX package; over int8 rings it attends the dequantized
    ring and its own keys unquantized, and quantizes them afterwards.
    ``decode_step.single_steps`` counts the S=1 calls.

    ``route`` picks the JAX step's kernel routes for S=1 steps, as its flag
    matrix names them; the prefill ignores it. A route whose conditions do
    not hold raises ValueError.

    - ``"auto"``: the dispatch above (``OLMOASR_LAYER_BLOCK=sc``);
    - ``"split"``: the split chain, never the layer block
      (``OLMOASR_LAYER_BLOCK=0``);
    - ``"layer"``: the whole layer, MLP included, as one
      ``layer_block_decode(include_mlp=True)`` a layer
      (``OLMOASR_LAYER_BLOCK=1``; the conditions of the fused launch);
    - ``"attend"``: the split self sub-block, then ``ln_matmul`` for the
      cross q, ``cross_attend_decode`` and ``matmul_residual``
      (``OLMOASR_PALLAS_CROSS_BLOCK=0, OLMOASR_PALLAS_CROSS=1``; one token row
      per window).

    ``beam_anc`` (R, C) int32, beam search: the rings are not reordered when
    beams are re-ranked; ``beam_anc[r, t]`` names the ring row within r's
    group of ``cache.kv_group`` rows that holds r's key and value at position
    t. It needs S=1 and a shared cross cache (kv_group > 1). This step's key
    and value still go to row r's own position ``cache.index``: the caller
    keeps the map the identity from there on.
    """
    dec = model.decoder
    dims = model.dims
    n_head = dims.n_text_head
    R, S = tokens.shape
    D = dims.n_text_state
    offset = cache.index
    end = offset + S
    if end > cache.self_k.shape[2]:
        raise ValueError(f"positions {offset}..{end - 1} exceed the cache's {cache.self_k.shape[2]}")
    G = cache.kv_group
    if beam_anc is not None and not (S == 1 and G > 1):
        raise ValueError(f"ancestry mode needs S=1 and a shared cross cache, got S={S}, "
                         f"kv_group={G}")
    single = S == 1
    quantized = cache.self_scale is not None
    if beam_anc is not None and quantized:
        raise ValueError("ancestry mode needs unquantized self rings")
    if route not in ROUTES:
        raise ValueError(f"route {route!r} is not one of {ROUTES}")
    if single:
        _check_route(route, cache, beam_anc, G)
    # the activation dtype: the rings' unless they are int8, then the weights'
    dtype = dec.token_embedding.weight.dtype if quantized else cache.self_k.dtype
    x = F.embedding(tokens, dec.token_embedding.weight).to(dtype)
    x = x + dec.positional_embedding[offset:end].to(dtype)
    if single:
        w_qkv, b_qkv = model.fused_qkv()
        decode_step.single_steps += 1
        fusable = beam_anc is None and G == 1 and cache.cross_k.dtype == torch.int8 \
            and not quantized
        route = {"auto": "sc" if fusable else "split"}.get(route, route)
    else:
        route = "prefill"
    scales = dict(k_scale=cache.self_k_scale, v_scale=cache.self_v_scale)
    cross = cross_block_decode if single else cross_block_decode_plain
    mlp = mlp_block if single else mlp_block_plain
    for i, blk in enumerate(dec.blocks):
        ca, cln = blk.cross_attn, blk.cross_attn_ln
        mlp_w = (blk.mlp_ln.weight, blk.mlp_ln.bias, blk.mlp[0].weight, blk.mlp[0].bias,
                 blk.mlp[2].weight, blk.mlp[2].bias)
        ck, cv = cache.cross_k[i], cache.cross_v[i]
        ks, vs = cache.cross_k_scale[i], cache.cross_v_scale[i]
        if route in ("sc", "layer"):
            whole = route == "layer"
            x, kv_new = layer_block_decode(
                x, blk.attn_ln.weight, blk.attn_ln.bias, w_qkv[i], b_qkv[i],
                blk.attn.out.weight, blk.attn.out.bias, cln.weight, cln.bias, ca.query.weight,
                ca.query.bias, ca.out.weight, ca.out.bias, cache.self_k, cache.self_v,
                ck, cv, ks, vs, offset, i, n_head=n_head, include_mlp=whole,
                mlp=mlp_w if whole else None,
            )
            cache.self_kv[:, i, :, offset].copy_(kv_new[:, :, 0])
            if not whole:
                x = mlp_block(x, *mlp_w)
            continue
        if single:
            qkv = ln_matmul(x, blk.attn_ln.weight, blk.attn_ln.bias, w_qkv[i], b_qkv[i])
            attn = self_attend_decode(
                qkv[..., :D], cache.self_k, cache.self_v, qkv[..., D:2 * D], qkv[..., 2 * D:],
                offset, i, n_head=n_head, beam_anc=beam_anc, beam_k=G, **scales,
            )
            x = matmul_residual(attn, x, blk.attn.out.weight, blk.attn.out.bias)
            # after the attention, this step's key and value into the rings
            _write_ring(cache, i, offset, qkv[:, :, D:].unflatten(-1, (2, D)).permute(2, 0, 1, 3))
        else:
            h = layer_norm(x, blk.attn_ln)
            q = _linear(h, blk.attn.query)
            kv = torch.stack([_linear(h, blk.attn.key), _linear(h, blk.attn.value)])
            # the prefill attends the ring's valid prefix (dequantized) and its
            # own keys as computed, under a causal mask, then writes them
            old = _ring_prefix(cache, i, offset, dtype)
            attn = _attend_cached(q, torch.cat([old[0], kv[0]], dim=1),
                                  torch.cat([old[1], kv[1]], dim=1), offset, n_head)
            x = x + _linear(attn, blk.attn.out)
            _write_ring(cache, i, offset, kv)
        if route == "attend":
            qc = ln_matmul(x, cln.weight, cln.bias, ca.query.weight, ca.query.bias)
            int8 = ck.dtype == torch.int8
            cattn = cross_attend_decode(qc, ck, cv, ks if int8 else None, vs if int8 else None,
                                        n_head=n_head)
            x = matmul_residual(cattn, x, ca.out.weight, ca.out.bias)
        else:
            x = cross(x, cln.weight, cln.bias, ca.query.weight, ca.query.bias, ca.out.weight,
                      ca.out.bias, ck, cv, ks, vs, n_head, kv_group=G)
        x = mlp(x, *mlp_w)
    cache.index = end
    x = layer_norm(x, dec.ln)
    return F.linear(x, dec.token_embedding.weight.to(x.dtype)).float()


decode_step.single_steps = 0
