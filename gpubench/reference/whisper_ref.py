"""Plain fp32 Whisper: log-mel, encoder, teacher-forced decoder, loss, AdamW.

The architecture of OpenAI's Whisper as OLMoASR releases it (pre-LayerNorm
blocks, exact GELU, key projection without bias, logits through the tied
token embedding), written from the published description in plain torch
operations over a dict of fp32 tensors under the released state-dict names.
No cache, no batching tricks, no kernel; the caller turns TF32 off
(:func:`strict_fp32`). Departures, each an option the comparison uses:

- ``kv_bits``: the decoder's cross K and V rounded per audio position to
  symmetric ``kv_bits``-bit integers (scale = max |x| / (2^(bits-1) - 1)),
  as a server that stores its cross cache in int8 does;
- ``quant="fp8"``: every matrix product of a linear layer (and the logits)
  takes both operands rounded to float8 e4m3 with one scale a tensor, the
  forward only (a straight-through backward): the control of a bf16 program;
- ``remat``: each block recomputed in the backward (memory only).

It imports nothing of ``olmoasr_tpu_torch`` or of JAX.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

SAMPLE_RATE, N_FFT, HOP = 16000, 400, 160
N_SAMPLES = 30 * SAMPLE_RATE
PADDING_TOKEN = 51864


def strict_fp32() -> None:
    """fp32 products in fp32: no TF32 in cuBLAS or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


# ---------------------------------------------------------------------------
# log-mel
# ---------------------------------------------------------------------------


def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    lin = f / (200.0 / 3)
    log = 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (np.log(6.4) / 27.0)
    return np.where(f >= 1000.0, log, lin)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    lin = m * (200.0 / 3)
    log = 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0))
    return np.where(m >= 15.0, log, lin)


def mel_filters(n_mels: int = 80) -> np.ndarray:
    """The Slaney-normalised triangular filterbank (n_mels, 201), float32."""
    fft = np.linspace(0, SAMPLE_RATE / 2, N_FFT // 2 + 1)
    pts = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(SAMPLE_RATE / 2), n_mels + 2))
    w = np.zeros((n_mels, fft.size))
    for i in range(n_mels):
        lo, mid, hi = pts[i], pts[i + 1], pts[i + 2]
        up = (fft - lo) / (mid - lo)
        down = (hi - fft) / (hi - mid)
        w[i] = np.maximum(0.0, np.minimum(up, down)) * (2.0 / (hi - lo))
    return w.astype(np.float32)


def log_mel(pcm: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """(B, 480000) float samples -> (B, n_mels, 3000): a periodic Hann
    window of 400 over centred, reflect-padded frames every 160 samples,
    the power spectrum (the last frame dropped), the filterbank, log10 over
    1e-10, floored 8 below each row's max, then (x + 4) / 4."""
    window = torch.hann_window(N_FFT, periodic=True, device=pcm.device, dtype=torch.float32)
    spec = torch.stft(pcm.float(), N_FFT, HOP, window=window, center=True, pad_mode="reflect",
                      return_complex=True)[..., :-1]
    power = spec.real ** 2 + spec.imag ** 2
    filt = torch.from_numpy(mel_filters(n_mels)).to(pcm.device)
    logs = torch.log10(torch.clamp(filt @ power, min=1e-10))
    logs = torch.maximum(logs, logs.amax(dim=(-2, -1), keepdim=True) - 8.0)
    return (logs + 4.0) / 4.0


# ---------------------------------------------------------------------------
# lower precisions
# ---------------------------------------------------------------------------


def round_rows(x: torch.Tensor, bits: int) -> torch.Tensor:
    """x with each row (last axis) rounded to symmetric ``bits``-bit
    integers and scaled back."""
    top = 2 ** (bits - 1) - 1
    scale = torch.clamp_min(x.abs().amax(dim=-1, keepdim=True), 1e-8) / top
    return torch.clamp(torch.round(x / scale), -top, top) * scale


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one scale (max |x| -> 448), forward
    only: the backward passes the gradient through unchanged."""
    scale = torch.clamp_min(x.detach().abs().amax(), 1e-12) / 448.0
    q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x).detach()


class Precision:
    """Where the reference computes below fp32 (the controls)."""

    def __init__(self, kv_bits: Optional[int] = None, quant: Optional[str] = None):
        if quant not in (None, "fp8"):
            raise ValueError(f"quant must be None or 'fp8', got {quant!r}")
        self.kv_bits, self.quant = kv_bits, quant

    def mm(self, x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None):
        if self.quant == "fp8":
            x, w = round_fp8(x), round_fp8(w)
        return F.linear(x, w, b)

    def kv(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.kv_bits is None else round_rows(x, self.kv_bits)


FP32 = Precision()


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------


def sinusoids(length: int, channels: int) -> torch.Tensor:
    inc = math.log(10000) / (channels // 2 - 1)
    inv = torch.exp(-inc * torch.arange(channels // 2, dtype=torch.float64))
    t = torch.arange(length, dtype=torch.float64)[:, None] * inv[None, :]
    return torch.cat([torch.sin(t), torch.cos(t)], dim=1).float()


def _ln(p, name, x):
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"], p[f"{name}.bias"], 1e-5)


def _lin(p, name, x, prec: Precision, bias=True):
    return prec.mm(x, p[f"{name}.weight"], p[f"{name}.bias"] if bias else None)


def _attend(q, k, v, n_head, mask=None):
    B, Tq, D = q.shape
    dh = D // n_head
    qh = q.view(B, Tq, n_head, dh).transpose(1, 2)
    kh = k.view(B, k.shape[1], n_head, dh).transpose(1, 2)
    vh = v.view(B, v.shape[1], n_head, dh).transpose(1, 2)
    logits = (qh @ kh.transpose(-1, -2)) / math.sqrt(dh)
    if mask is not None:
        logits = logits + mask
    return (torch.softmax(logits, dim=-1) @ vh).transpose(1, 2).reshape(B, Tq, D)


def _mlp(p, name, x, prec):
    h = _ln(p, f"{name}.mlp_ln", x)
    return x + _lin(p, f"{name}.mlp.2", F.gelu(_lin(p, f"{name}.mlp.0", h, prec)), prec)


def _enc_block(p, name, x, n_head, prec):
    h = _ln(p, f"{name}.attn_ln", x)
    a = _attend(_lin(p, f"{name}.attn.query", h, prec), _lin(p, f"{name}.attn.key", h, prec, False),
                _lin(p, f"{name}.attn.value", h, prec), n_head)
    return _mlp(p, name, x + _lin(p, f"{name}.attn.out", a, prec), prec)


def _dec_block(p, name, x, audio, n_head, mask, prec):
    h = _ln(p, f"{name}.attn_ln", x)
    a = _attend(_lin(p, f"{name}.attn.query", h, prec), _lin(p, f"{name}.attn.key", h, prec, False),
                _lin(p, f"{name}.attn.value", h, prec), n_head, mask)
    x = x + _lin(p, f"{name}.attn.out", a, prec)
    ck = prec.kv(_lin(p, f"{name}.cross_attn.key", audio, prec, False))
    cv = prec.kv(_lin(p, f"{name}.cross_attn.value", audio, prec))
    q = _lin(p, f"{name}.cross_attn.query", _ln(p, f"{name}.cross_attn_ln", x), prec)
    x = x + _lin(p, f"{name}.cross_attn.out", _attend(q, ck, cv, n_head), prec)
    return _mlp(p, name, x, prec)


def _run(fn, remat, *args):
    return checkpoint(fn, *args, use_reentrant=False) if remat else fn(*args)


def encode(p: Dict[str, torch.Tensor], dims, mel: torch.Tensor, prec: Precision = FP32,
           remat: bool = False) -> torch.Tensor:
    """(B, n_mels, 3000) log-mel -> (B, n_audio_ctx, D) audio features."""
    x = F.gelu(F.conv1d(mel, p["encoder.conv1.weight"], p["encoder.conv1.bias"], padding=1))
    x = F.gelu(F.conv1d(x, p["encoder.conv2.weight"], p["encoder.conv2.bias"], stride=2,
                        padding=1))
    x = x.transpose(1, 2) + sinusoids(dims["n_audio_ctx"], dims["n_audio_state"]).to(x.device)
    for i in range(dims["n_audio_layer"]):
        x = _run(lambda x, i=i: _enc_block(p, f"encoder.blocks.{i}", x, dims["n_audio_head"],
                                           prec), remat, x)
    return _ln(p, "encoder.ln_post", x)


def decode(p: Dict[str, torch.Tensor], dims, tokens: torch.Tensor, audio: torch.Tensor,
           key_bias: Optional[torch.Tensor] = None, prec: Precision = FP32,
           remat: bool = False) -> torch.Tensor:
    """Teacher-forced logits (B, T, vocabulary rows) of ``tokens`` (B, T)
    over ``audio`` (B, Ta, D): causal self-attention, with ``key_bias`` (B,
    T), an additive bias on each key position (-inf on padding), and the
    cross-attention unmasked."""
    T = tokens.shape[1]
    emb = p["decoder.token_embedding.weight"]
    x = emb[tokens] + p["decoder.positional_embedding"][:T]
    mask = torch.full((T, T), float("-inf"), device=x.device).triu(1)[None, None]
    if key_bias is not None:
        mask = mask + key_bias[:, None, None, :]
    for i in range(dims["n_text_layer"]):
        x = _run(lambda x, i=i: _dec_block(p, f"decoder.blocks.{i}", x, audio,
                                           dims["n_text_head"], mask, prec), remat, x)
    x = _ln(p, "decoder.ln", x)
    return prec.mm(x, emb)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def token_loss_sum(p, dims, pcm, text_input, text_target, prec: Precision = FP32,
                   remat: bool = True):
    """The summed cross entropy of the valid targets (not PADDING_TOKEN) of
    a block of samples: log-mel of the 30 s PCM, encoder, decoder with the
    padding keys masked, logsumexp minus the target's logit."""
    with torch.no_grad():
        mel = log_mel(pcm)
    valid = text_target != PADDING_TOKEN
    key_bias = torch.where(text_input == PADDING_TOKEN, float("-inf"), 0.0)
    # the padding bias follows the input positions: a sample's n inputs are
    # its tokens, the rest are pads
    audio = encode(p, dims, mel, prec, remat)
    logits = decode(p, dims, text_input, audio, key_bias, prec, remat)
    nll = torch.logsumexp(logits, dim=-1) - logits.gather(
        -1, torch.where(valid, text_target, 0)[..., None])[..., 0]
    return torch.where(valid, nll, 0.0).sum()


class AdamW:
    """AdamW as the recipe states it, over fp32 leaves: the gradient clipped
    to a global norm of ``max_norm`` when it reaches it, then
    ``p -= lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``; update n (from 1)
    takes the learning rate of step n - 1 of a linear warmup over
    ``warmup_frac`` of ``train_steps`` to ``peak_lr``."""

    def __init__(self, opt: Dict[str, float]):
        self.o = opt
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}
        self.t = 0

    def lr(self, step: int) -> float:
        o = self.o
        warmup = max(int(o["train_steps"] * o["warmup_frac"]), 1)
        f32 = np.float32
        if step < warmup:
            return float(f32(o["peak_lr"]) * (f32(step) / f32(warmup)))
        span = f32(max(o["train_steps"] - warmup, 1))
        return float(f32(o["peak_lr"]) * max((f32(o["train_steps"]) - f32(step)) / span, f32(0)))

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]) -> float:
        o = self.o
        norm = torch.sqrt(sum(g.double().square().sum() for g in grads.values())).item()
        clip = o["max_grad_norm"] / norm if norm >= o["max_grad_norm"] else 1.0
        lr = self.lr(self.t)
        self.t += 1
        b1, b2 = o["beta1"], o["beta2"]
        bc1, bc2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for name, p in params.items():
            g = grads[name] * clip
            if name not in self.m:
                self.m[name] = torch.zeros_like(p)
                self.v[name] = torch.zeros_like(p)
            m, v = self.m[name], self.v[name]
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            update = (m / bc1) / ((v / bc2).sqrt() + o["eps"]) + o["weight_decay"] * p
            p.sub_(lr * update)
        return norm
