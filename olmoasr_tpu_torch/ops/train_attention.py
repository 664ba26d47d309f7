"""Whole-row softmax attention forward on ``(B, T, D)`` tensors.

Counterpart of ``olmoasr_tpu/ops/train_attention.py`` (the forward only:
``_attn_fwd`` and its public entries ``enc_self_attention``,
``dec_self_attention``, ``cross_attention``). The backward comes with
training.

Semantics kept from the TPU kernel: q is pre-scaled by dh^-0.5 in q's dtype;
the additive fp32 key bias is the padding mask (keys >= ``valid_len`` get
-1e9) plus ``key_bias``, clamped at -1e9 so that -inf never becomes NaN; the
causal mask sets -1e9; the softmax runs over the whole key row in fp32 and
``p = exp(s - max)`` is rounded to bf16 before P.V, then divided by the fp32
row sum. The port runs at the true sequence length: the TPU's 128-multiple
padding was a tiling device, and the kernel masks its ragged last tile.

Dispatch: a CUDA tensor launches ``csrc/train_attention.cu`` or raises; a CPU
tensor runs the plain twin.
"""

from __future__ import annotations

from typing import Optional

import torch

from olmoasr_tpu_torch.ops import _build

NEG = -1e9
HEAD_DIM = 64  # the kernel's head width (every OLMoASR/Whisper size)


def _split(x: torch.Tensor, n_head: int) -> torch.Tensor:
    B, T, D = x.shape
    return x.view(B, T, n_head, D // n_head).transpose(1, 2)  # (B, H, T, dh)


def _scale(dh: int, dtype: torch.dtype) -> float:
    """dh^-0.5 as a value of q's dtype (0.125 for dh=64: exact in bf16)."""
    return float(torch.tensor(dh ** -0.5, dtype=dtype))


def key_bias_row(
    Tk: int,
    key_bias: Optional[torch.Tensor],
    valid_len: Optional[int],
    device,
) -> Optional[torch.Tensor]:
    """The additive fp32 (1 or B, Tk) bias, or None when nothing is masked."""
    if key_bias is None and (valid_len is None or valid_len >= Tk):
        return None
    valid = Tk if valid_len is None else valid_len
    pos = torch.arange(Tk, device=device)
    bias = torch.where(pos < valid, 0.0, NEG).to(torch.float32)[None]
    if key_bias is not None:
        bias = torch.clamp_min(key_bias.to(device=device, dtype=torch.float32) + bias, NEG)
    return bias.contiguous()


def train_attention_fwd_plain(
    q, k, v, n_head: int, causal: bool = False,
    key_bias: Optional[torch.Tensor] = None, valid_len: Optional[int] = None,
) -> torch.Tensor:
    B, Tq, D = q.shape
    Tk = k.shape[1]
    dh = D // n_head
    qh = (_split(q, n_head) * _scale(dh, q.dtype)).float()
    kh = _split(k, n_head).float()
    vh = _split(v, n_head).float()
    bias = key_bias_row(Tk, key_bias, valid_len, q.device)
    if causal:
        rows = torch.arange(Tq, device=q.device)[:, None]
        cols = torch.arange(Tk, device=q.device)[None, :]
        future = cols > rows
    out = torch.empty((B, n_head, Tq, dh), dtype=torch.float32, device=q.device)
    step = max(1, (1 << 27) // (n_head * Tq * Tk))  # bounds the (b, H, Tq, Tk) scores
    for b0 in range(0, B, step):
        b1 = min(B, b0 + step)
        s = qh[b0:b1] @ kh[b0:b1].transpose(-1, -2)
        if bias is not None:
            s = s + (bias if bias.shape[0] == 1 else bias[b0:b1])[:, None, None, :]
        if causal:
            s = s.masked_fill(future, NEG)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        l = p.sum(dim=-1, keepdim=True)
        out[b0:b1] = (p.to(torch.bfloat16).float() @ vh[b0:b1]) / l
    return out.transpose(1, 2).reshape(B, Tq, D).to(q.dtype)


def train_attention_fwd(
    q: torch.Tensor,  # (B, Tq, D)
    k: torch.Tensor,  # (B, Tk, D)
    v: torch.Tensor,
    n_head: int,
    causal: bool = False,
    key_bias: Optional[torch.Tensor] = None,  # (B, Tk) additive
    valid_len: Optional[int] = None,  # keys at or past it are masked
) -> torch.Tensor:
    """Attention forward for whole rows of keys (see module docstring).

    Replaces ``olmoasr_tpu/ops/train_attention.py::_attn_fwd``. Bound on the
    card: tensor-core FLOPs (the encoder at small.en, B=64: 442 GFLOP of
    products per layer). The kernel keeps each 64-query tile's scores, row
    max, row sum and P in shared memory and registers, passes over K twice
    (row max, then P.V) and runs every product on the tensor cores in bf16.
    """
    if not q.is_cuda:
        return train_attention_fwd_plain(q, k, v, n_head, causal, key_bias, valid_len)
    what = "train_attention_fwd"
    B, Tq, D = q.shape
    Tk = k.shape[1]

    def need(cond, msg):
        if not cond:
            raise ValueError(f"{what}: {msg}")

    need(q.dtype in (torch.float32, torch.bfloat16), f"q is {q.dtype}")
    need(D == n_head * HEAD_DIM, f"the kernel takes head width {HEAD_DIM}, got D={D}, H={n_head}")
    need(k.dim() == 3 and k.shape[0] == B and k.shape[2] == D, f"k {tuple(k.shape)} vs q {tuple(q.shape)}")
    need(v.shape == k.shape, f"v {tuple(v.shape)} vs k {tuple(k.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        need(t.dtype == q.dtype and t.device == q.device, f"{name} is {t.dtype} on {t.device}")
        need(t.is_contiguous() and t.data_ptr() % 16 == 0, f"{name} must be contiguous, 16-byte aligned")
    if key_bias is not None:
        need(tuple(key_bias.shape) == (B, Tk), f"key_bias must be (B, Tk), got {tuple(key_bias.shape)}")
    bias = key_bias_row(Tk, key_bias, valid_len, q.device)
    bias_stride = 0 if bias is None or bias.shape[0] == 1 else Tk
    out = torch.empty_like(q)
    lib = _build.lib()
    _build.check(lib.olm_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if bias is None else bias.data_ptr(), bias_stride, out.data_ptr(),
        B, n_head, Tq, Tk, D, int(causal), _scale(HEAD_DIM, q.dtype),
        _build.dtype_code(q.dtype), _build.stream_ptr(q.device),
    ), what)
    train_attention_fwd.launches += 1
    return out


train_attention_fwd.launches = 0


def enc_self_attention(q, k, v, n_head: int, valid_len: Optional[int] = None):
    """Non-causal self-attention (the encoder's 1500 positions)."""
    return train_attention_fwd(q, k, v, n_head, False, None, valid_len)


def dec_self_attention(q, k, v, n_head: int, key_bias=None):
    """Causal decoder self-attention with the per-key padding bias."""
    return train_attention_fwd(q, k, v, n_head, True, key_bias)


def cross_attention(q, k, v, n_head: int, valid_len: Optional[int] = None):
    """Decoder cross-attention: text queries over audio keys, no mask."""
    return train_attention_fwd(q, k, v, n_head, False, None, valid_len)
