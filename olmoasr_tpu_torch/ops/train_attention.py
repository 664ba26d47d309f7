"""Whole-row softmax attention on ``(B, T, D)`` tensors, forward and backward.

Counterpart of ``olmoasr_tpu/ops/train_attention.py``: ``_attn_fwd``,
``_attn_bwd``, the custom VJP ``_train_attention`` (here the autograd
function ``TrainAttention``) and its public entries ``enc_self_attention``,
``dec_self_attention``, ``cross_attention``. With gradients enabled they run
the autograd function, which saves only q, k, v, the key bias and
``valid_len`` and recomputes everything else in the backward kernel; under
``torch.no_grad`` they call the forward alone.

Semantics kept from the TPU kernel: q is pre-scaled by dh^-0.5 in q's dtype;
the additive fp32 key bias is the padding mask (keys >= ``valid_len`` get
-1e9) plus ``key_bias``, clamped at -1e9 so that -inf never becomes NaN; the
causal mask sets -1e9; the softmax runs over the whole key row in fp32 and
``p = exp(s - max)`` is rounded to bf16 before P.V, then divided by the fp32
row sum. The backward keeps the TPU kernel's roundings too: ``do`` is cast
to q's type, ``pn = p / l`` stays fp32 for ``delta = sum(dp * pn)``, ``ds``
and ``pn`` are rounded to bf16 (even for fp32 inputs) before their products,
and dq is rounded to q's type before the scale. The port runs at the true
sequence length: the TPU's 128-multiple padding was a tiling device, and the
kernels mask their ragged last tile.

Dispatch: a CUDA tensor launches ``csrc/train_attention.cu`` or raises; a CPU
tensor runs the plain twins.
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
    products per layer). The bf16 kernel (``csrc/attention_mma.cuh``) keeps
    each 128-query tile's scores, row max, row sum, P and O in registers
    (mma.sync, 16 rows a warp), streams K and V through a cp.async ring and
    passes over K twice (row max, then P.V); fp32 runs on the CUDA cores.
    """
    if not q.is_cuda:
        return train_attention_fwd_plain(q, k, v, n_head, causal, key_bias, valid_len)
    what = "train_attention_fwd"
    bias, bias_stride = _kernel_inputs(what, q, k, v, None, n_head, key_bias, valid_len)
    B, Tq, D = q.shape
    out = torch.empty_like(q)
    _build.check(_build.lib().olm_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if bias is None else bias.data_ptr(), bias_stride, out.data_ptr(),
        B, n_head, Tq, k.shape[1], D, int(causal), _scale(HEAD_DIM, q.dtype),
        _build.dtype_code(q.dtype), _build.stream_ptr(q.device),
    ), what)
    train_attention_fwd.launches += 1
    return out


train_attention_fwd.launches = 0


def _kernel_inputs(what, q, k, v, do, n_head, key_bias, valid_len):
    """Check the tensors a kernel takes; returns the fp32 key bias (or None)
    and its batch stride."""
    B, Tq, D = q.shape
    Tk = k.shape[1]

    def need(cond, msg):
        if not cond:
            raise ValueError(f"{what}: {msg}")

    need(q.dtype in (torch.float32, torch.bfloat16), f"q is {q.dtype}")
    need(D == n_head * HEAD_DIM, f"the kernel takes head width {HEAD_DIM}, got D={D}, H={n_head}")
    need(k.dim() == 3 and k.shape[0] == B and k.shape[2] == D, f"k {tuple(k.shape)} vs q {tuple(q.shape)}")
    need(v.shape == k.shape, f"v {tuple(v.shape)} vs k {tuple(k.shape)}")
    need(do is None or do.shape == q.shape, f"do {None if do is None else tuple(do.shape)} vs q")
    for name, t in (("q", q), ("k", k), ("v", v), ("do", do)):
        if t is None:
            continue
        need(t.dtype == q.dtype and t.device == q.device, f"{name} is {t.dtype} on {t.device}")
        need(t.is_contiguous() and t.data_ptr() % 16 == 0, f"{name} must be contiguous, 16-byte aligned")
    if key_bias is not None:
        need(tuple(key_bias.shape) == (B, Tk), f"key_bias must be (B, Tk), got {tuple(key_bias.shape)}")
    bias = key_bias_row(Tk, key_bias, valid_len, q.device)
    return bias, 0 if bias is None or bias.shape[0] == 1 else Tk


def train_attention_bwd_plain(
    q, k, v, do, n_head: int, causal: bool = False,
    key_bias: Optional[torch.Tensor] = None, valid_len: Optional[int] = None,
):
    """(dq, dk, dv) of the forward, step by step as ``_bwd_row_kernel`` with
    the default switches (see the module docstring)."""
    B, Tq, D = q.shape
    Tk = k.shape[1]
    dh = D // n_head
    scale = _scale(dh, q.dtype)
    qh = (_split(q, n_head) * scale).float()
    kh = _split(k, n_head).float()
    vh = _split(v, n_head).float()
    doh = _split(do.to(q.dtype), n_head).float()
    bias = key_bias_row(Tk, key_bias, valid_len, q.device)
    if causal:
        future = torch.arange(Tk, device=q.device)[None, :] > torch.arange(Tq, device=q.device)[:, None]
    dq = torch.empty((B, n_head, Tq, dh), dtype=torch.float32, device=q.device)
    dk = torch.empty((B, n_head, Tk, dh), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    step = max(1, (1 << 27) // (n_head * Tq * Tk))  # bounds the (b, H, Tq, Tk) blocks
    for b0 in range(0, B, step):
        b1 = min(B, b0 + step)
        s = qh[b0:b1] @ kh[b0:b1].transpose(-1, -2)
        if bias is not None:
            s = s + (bias if bias.shape[0] == 1 else bias[b0:b1])[:, None, None, :]
        if causal:
            s = s.masked_fill(future, NEG)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        pn = p / p.sum(dim=-1, keepdim=True)
        dp = doh[b0:b1] @ vh[b0:b1].transpose(-1, -2)
        delta = (dp * pn).sum(dim=-1, keepdim=True)
        ds = (pn * (dp - delta)).to(torch.bfloat16).float()
        dq[b0:b1] = ds @ kh[b0:b1]
        dk[b0:b1] = ds.transpose(-1, -2) @ qh[b0:b1]
        dv[b0:b1] = pn.to(torch.bfloat16).float().transpose(-1, -2) @ doh[b0:b1]
    merge = lambda x, dtype: x.transpose(1, 2).reshape(B, x.shape[2], D).to(dtype)
    return merge(dq, q.dtype) * scale, merge(dk, k.dtype), merge(dv, v.dtype)


def train_attention_bwd(
    q: torch.Tensor,  # (B, Tq, D)
    k: torch.Tensor,  # (B, Tk, D)
    v: torch.Tensor,
    do: torch.Tensor,  # (B, Tq, D), the output's gradient
    n_head: int,
    causal: bool = False,
    key_bias: Optional[torch.Tensor] = None,
    valid_len: Optional[int] = None,
):
    """(dq, dk, dv) of :func:`train_attention_fwd` (see the module docstring).

    Replaces ``olmoasr_tpu/ops/train_attention.py::_attn_bwd``. Bound on the
    card: tensor-core FLOPs, five products of 2 T^2 dh per (b, h) at the
    least (the encoder at small.en, B=16: 276 GFLOP a layer). Two launches
    (``csrc/train_attention.cu``; bf16 on the register-resident core of
    ``csrc/attention_mma.cuh``): per 64-query tile the row statistics and
    dq, then per 64-key tile dK and dV over the query tiles; no atomics, so
    the result does not depend on scheduling and two launches agree to the
    bit. ``do`` must be contiguous in q's dtype on the card; the CPU twin
    casts it.
    """
    if not q.is_cuda:
        return train_attention_bwd_plain(q, k, v, do, n_head, causal, key_bias, valid_len)
    what = "train_attention_bwd"
    bias, bias_stride = _kernel_inputs(what, q, k, v, do, n_head, key_bias, valid_len)
    B, Tq, D = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    stats = torch.empty((3, B, n_head, Tq), dtype=torch.float32, device=q.device)
    _build.check(_build.lib().olm_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        None if bias is None else bias.data_ptr(), bias_stride,
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
        B, n_head, Tq, k.shape[1], D, int(causal), _scale(HEAD_DIM, q.dtype),
        _build.dtype_code(q.dtype), _build.stream_ptr(q.device),
    ), what)
    train_attention_bwd.launches += 1
    return dq, dk, dv


train_attention_bwd.launches = 0


class TrainAttention(torch.autograd.Function):
    """Attention with the hand-written backward: the counterpart of the JAX
    package's custom VJP ``_train_attention``. It saves q, k, v and the key
    bias (the residuals of ``_attn_fwd_res``) and returns no gradient for the
    key bias, as ``_attn_bwd_res`` returns zeros there."""

    @staticmethod
    def forward(ctx, q, k, v, key_bias, n_head, causal, valid_len):
        ctx.save_for_backward(q, k, v, key_bias)
        ctx.args = (n_head, causal, valid_len)
        return train_attention_fwd(q, k, v, n_head, causal, key_bias, valid_len)

    @staticmethod
    def backward(ctx, g):
        q, k, v, key_bias = ctx.saved_tensors
        n_head, causal, valid_len = ctx.args
        do = g.to(q.dtype).contiguous()
        dq, dk, dv = train_attention_bwd(q, k, v, do, n_head, causal, key_bias, valid_len)
        return dq, dk, dv, None, None, None, None


def train_attention(q, k, v, n_head: int, causal: bool = False,
                    key_bias: Optional[torch.Tensor] = None, valid_len: Optional[int] = None):
    """The forward, through :class:`TrainAttention` when a gradient is wanted."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return TrainAttention.apply(q, k, v, key_bias, n_head, causal, valid_len)
    return train_attention_fwd(q, k, v, n_head, causal, key_bias, valid_len)


def enc_self_attention(q, k, v, n_head: int, valid_len: Optional[int] = None):
    """Non-causal self-attention (the encoder's 1500 positions)."""
    return train_attention(q, k, v, n_head, False, None, valid_len)


def dec_self_attention(q, k, v, n_head: int, key_bias=None):
    """Causal decoder self-attention with the per-key padding bias."""
    return train_attention(q, k, v, n_head, True, key_bias)


def cross_attention(q, k, v, n_head: int, valid_len: Optional[int] = None):
    """Decoder cross-attention: text queries over audio keys, no mask."""
    return train_attention(q, k, v, n_head, False, None, valid_len)
