"""Whisper-architecture encoder-decoder in PyTorch.

Counterpart of ``olmoasr_tpu/models/whisper.py``. The modules carry the
reference's torch state-dict names (``encoder.blocks.{i}.attn.query.weight``,
``decoder.token_embedding.weight``, ...), so released ``.pt`` checkpoints load
as they are; the forward passes are plain functions over those modules.

Numerics follow the JAX model: fp32 LayerNorm islands cast back, q and k each
scaled by dh^-0.25 with an fp32 softmax in the plain attention, exact (erf)
GELU, products in the weights' dtype, logits through the tied token embedding
returned in fp32. Six kernels serve the inference path: the encoder's
self-attention (``ops.train_attention``) and, at S=1 decode steps, the whole
decoder layer (``ops.attention``): ``ln_matmul`` (fused QKV),
``self_attend_decode``, ``matmul_residual``, ``cross_block_decode`` and
``mlp_block``. The training forward (``forward_train``: ``encode_train`` and
``decode_train``) sends the encoder's self-attention and the decoder's self-
and cross-attention through ``ops.train_attention``'s forward and backward
kernels; fp32 parameters are cast to the compute dtype op by op, so their
gradients come back in fp32.
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
    cross_block_decode,
    cross_block_decode_plain,
    layer_block_decode,
    ln_matmul,
    matmul_residual,
    mlp_block,
    mlp_block_plain,
    self_attend_decode,
)
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


def _encoder_block(x: torch.Tensor, blk: ResidualAttentionBlock, n_head: int) -> torch.Tensor:
    h = layer_norm(x, blk.attn_ln)
    q = _linear(h, blk.attn.query)
    k = _linear(h, blk.attn.key)
    v = _linear(h, blk.attn.value)
    x = x + _linear(enc_self_attention(q, k, v, n_head), blk.attn.out)
    return _mlp(x, blk)


def _blocks(fn, x: torch.Tensor, blocks, remat: bool, *args) -> torch.Tensor:
    """x through ``fn(x, blk, *args)`` for each block; ``remat`` recomputes
    each block's forward in the backward (non-reentrant checkpointing), as
    the JAX package's ``jax.checkpoint`` per block."""
    for blk in blocks:
        x = checkpoint(fn, x, blk, *args, use_reentrant=False) if remat else fn(x, blk, *args)
    return x


def encode_train(model: Whisper, mel: torch.Tensor, *, compute_dtype=torch.bfloat16,
                 remat: bool = False) -> torch.Tensor:
    """The encoder with gradients (JAX ``encode_audio`` as training calls it):
    (B, n_mels, 2 * n_audio_ctx) mel -> (B, n_audio_ctx, D) in
    ``compute_dtype``: conv stem with exact GELU -> + sinusoids -> blocks ->
    ln_post; the blocks' attention is ``enc_self_attention``."""
    enc = model.encoder
    x = mel.to(device=model.device, dtype=compute_dtype)
    x = F.gelu(F.conv1d(x, enc.conv1.weight.to(x.dtype), enc.conv1.bias.to(x.dtype), padding=1))
    x = F.gelu(F.conv1d(x, enc.conv2.weight.to(x.dtype), enc.conv2.bias.to(x.dtype), stride=2,
                        padding=1))
    x = x.transpose(1, 2).contiguous() + enc.positional_embedding.to(x.dtype)
    x = _blocks(_encoder_block, x, enc.blocks, remat, model.dims.n_audio_head)
    return layer_norm(x, enc.ln_post)


@torch.no_grad()
def encode_audio(model: Whisper, mel: torch.Tensor) -> torch.Tensor:
    """``encode_train`` for inference: no gradients, in the weights' dtype."""
    return encode_train(model, mel, compute_dtype=model.dtype)


# ---------------------------------------------------------------------------
# decoder: full-sequence (training) forward
# ---------------------------------------------------------------------------


def _decoder_block(x: torch.Tensor, blk: ResidualAttentionBlock, audio: torch.Tensor,
                   n_head: int, key_bias: Optional[torch.Tensor]) -> torch.Tensor:
    h = layer_norm(x, blk.attn_ln)
    q = _linear(h, blk.attn.query)
    k = _linear(h, blk.attn.key)
    v = _linear(h, blk.attn.value)
    x = x + _linear(dec_self_attention(q, k, v, n_head, key_bias), blk.attn.out)
    # cross K/V: this layer's projections of the audio features
    ck = _linear(audio, blk.cross_attn.key)
    cv = _linear(audio, blk.cross_attn.value)
    q = _linear(layer_norm(x, blk.cross_attn_ln), blk.cross_attn.query)
    x = x + _linear(cross_attention(q, ck, cv, n_head), blk.cross_attn.out)
    return _mlp(x, blk)


def decode_train(model: Whisper, tokens: torch.Tensor, audio_features: torch.Tensor,
                 padding_mask: Optional[torch.Tensor] = None, *, remat: bool = False,
                 return_hidden: bool = False) -> torch.Tensor:
    """The decoder's teacher-forced forward (JAX ``decode_train``): tokens
    (B, T), PADDING_TOKEN allowed, over audio features (B, Ta, D) in the
    compute dtype -> fp32 logits (B, T, vocab rows) through the tied
    embedding, the padding row included; ``return_hidden`` stops before the
    logits. ``padding_mask`` is the loader's additive (B, T) per-key bias
    (-inf on pad columns, clamped to -1e9 in the kernels); self-attention is
    causal, cross-attention unmasked."""
    if padding_mask is not None and padding_mask.dim() != 2:
        raise NotImplementedError(
            "decode_train takes the loader's (B, T) key bias; the legacy (B, T, T) mask "
            "is not ported")
    dec = model.decoder
    T = tokens.shape[1]
    dtype = audio_features.dtype
    x = dec.token_embedding.weight[tokens.long()].to(dtype) + dec.positional_embedding[:T].to(dtype)
    key_bias = None if padding_mask is None else padding_mask.float()
    x = _blocks(_decoder_block, x, dec.blocks, remat, audio_features, model.dims.n_text_head,
                key_bias)
    x = layer_norm(x, dec.ln)
    if return_hidden:
        return x
    return F.linear(x, dec.token_embedding.weight.to(x.dtype)).float()


def forward_train(model: Whisper, mel: torch.Tensor, tokens: torch.Tensor,
                  padding_mask: Optional[torch.Tensor] = None, *, compute_dtype=torch.bfloat16,
                  remat: bool = False, return_hidden: bool = False) -> torch.Tensor:
    """mel -> encoder -> decoder -> fp32 logits (JAX ``forward_train``)."""
    audio = encode_train(model, mel, compute_dtype=compute_dtype, remat=remat)
    return decode_train(model, tokens.to(audio.device), audio, padding_mask, remat=remat,
                        return_hidden=return_hidden)


# ---------------------------------------------------------------------------
# decoder: KV-cached incremental inference
# ---------------------------------------------------------------------------


@dataclass
class KVCache:
    """Decoder state. ``self_kv``: (2, L, R, C, D), the key rings then the
    value rings (``self_k``, ``self_v``) of R token rows, positions below
    ``index`` valid, written in place by ``decode_step``; one storage lets a
    step write a layer's new key and value with one copy. ``cross_k``/
    ``cross_v``: (L, B, T, D) projections of the B audio windows' features,
    in the activation dtype or int8; ``cross_*_scale``: (L, B, 1, T) fp32
    per-position scales, ones when the cross cache is not quantized. R is a
    multiple of B: token row r reads window r // (R // B)."""

    self_kv: torch.Tensor
    cross_k: torch.Tensor
    cross_v: torch.Tensor
    cross_k_scale: torch.Tensor
    cross_v_scale: torch.Tensor
    index: int = 0

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
    self_batch: Optional[int] = None,
) -> KVCache:
    """Allocate the self rings and project every layer's cross K/V once per
    audio window (optionally int8 with per-position scales).

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
        self_kv=torch.zeros((2, L, rows, n_ctx, D), dtype=dtype, **kw),
        cross_k=cross_k,
        cross_v=cross_v,
        cross_k_scale=k_scale,
        cross_v_scale=v_scale,
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


@torch.no_grad()
def decode_step(model: Whisper, tokens: torch.Tensor, cache: KVCache,
                beam_anc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Run the decoder on ``tokens`` (R, S) at positions ``cache.index``..;
    returns fp32 logits (R, S, n_vocab) and advances the cache in place.

    S=1 steps run every sub-block through the hand-written kernels
    (``ops.attention``): ``ln_matmul`` (fused QKV), ``self_attend_decode``
    over the read-only rings, ``matmul_residual``, then the new key and value
    go into the rings, then ``cross_block_decode`` and ``mlp_block``. Over an
    int8 cross cache with one token row per window and no ancestry map, the
    self and cross sub-blocks run as one ``layer_block_decode`` launch, as
    the JAX step takes its layer block there (whisper.py, use_layer_block).
    A prefill (S>1) is plain tensor code, as in the JAX package.
    ``decode_step.single_steps`` counts the S=1 calls.

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
    dtype = cache.self_k.dtype
    x = F.embedding(tokens, dec.token_embedding.weight).to(dtype)
    x = x + dec.positional_embedding[offset:end].to(dtype)
    single = S == 1
    if single:
        w_qkv, b_qkv = model.fused_qkv()
        decode_step.single_steps += 1
    fused = single and beam_anc is None and G == 1 and cache.cross_k.dtype == torch.int8
    cross = cross_block_decode if single else cross_block_decode_plain
    mlp = mlp_block if single else mlp_block_plain
    for i, blk in enumerate(dec.blocks):
        ca, cln = blk.cross_attn, blk.cross_attn_ln
        if fused:
            x, kv_new = layer_block_decode(
                x, blk.attn_ln.weight, blk.attn_ln.bias, w_qkv[i], b_qkv[i],
                blk.attn.out.weight, blk.attn.out.bias, cln.weight, cln.bias, ca.query.weight,
                ca.query.bias, ca.out.weight, ca.out.bias, cache.self_k, cache.self_v,
                cache.cross_k[i], cache.cross_v[i], cache.cross_k_scale[i],
                cache.cross_v_scale[i], offset, i, n_head=n_head,
            )
            cache.self_kv[:, i, :, offset].copy_(kv_new[:, :, 0])
        elif single:
            qkv = ln_matmul(x, blk.attn_ln.weight, blk.attn_ln.bias, w_qkv[i], b_qkv[i])
            attn = self_attend_decode(
                qkv[..., :D], cache.self_k, cache.self_v, qkv[..., D:2 * D], qkv[..., 2 * D:],
                offset, i, n_head=n_head, beam_anc=beam_anc, beam_k=G,
            )
            x = matmul_residual(attn, x, blk.attn.out.weight, blk.attn.out.bias)
            # after the attention, this step's key and value into the rings
            cache.self_kv[:, i, :, offset].copy_(qkv[:, 0, D:].unflatten(-1, (2, D)).transpose(0, 1))
        else:
            h = layer_norm(x, blk.attn_ln)
            q = _linear(h, blk.attn.query)
            # the prefill writes its keys first and attends the ring's valid
            # prefix (its own positions included) under a causal mask
            cache.self_k[i, :, offset:end] = _linear(h, blk.attn.key)
            cache.self_v[i, :, offset:end] = _linear(h, blk.attn.value)
            attn = _attend_cached(
                q, cache.self_k[i, :, :end], cache.self_v[i, :, :end], offset, n_head
            )
            x = x + _linear(attn, blk.attn.out)
        if not fused:
            x = cross(
                x, cln.weight, cln.bias, ca.query.weight, ca.query.bias, ca.out.weight,
                ca.out.bias, cache.cross_k[i], cache.cross_v[i], cache.cross_k_scale[i],
                cache.cross_v_scale[i], n_head, kv_group=G,
            )
        x = mlp(
            x, blk.mlp_ln.weight, blk.mlp_ln.bias, blk.mlp[0].weight, blk.mlp[0].bias,
            blk.mlp[2].weight, blk.mlp[2].bias,
        )
    cache.index = end
    x = layer_norm(x, dec.ln)
    return F.linear(x, dec.token_embedding.weight.to(x.dtype)).float()


decode_step.single_steps = 0
