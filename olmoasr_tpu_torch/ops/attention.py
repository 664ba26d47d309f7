"""Decode-step kernels: every sub-block of an S=1 decoder layer.

Counterpart of ``olmoasr_tpu/ops/attention.py`` for the self sub-block
(``ln_matmul``, ``self_attend_decode`` over bf16, fp32 or int8 rings,
``matmul_residual``), the cross sub-block (``cross_block_decode``:
non-transposed keys, ``kv_group`` query rows per cache row), the cross
attention alone (``cross_attend_decode``), the self and cross sub-blocks or
the whole layer in one launch (``layer_block_decode``, over an int8 cross
cache) and ``mlp_block``. Each function takes ONE layer's
tensors in torch's weight layout (``(out, in)``); activations keep the JAX
layout: ``x`` is ``(B, 1, D)``, the cross cache ``(B, T, D)`` with
per-position scales ``(B, 1, T)`` (ones when unquantized), the self rings the
stacked ``(L, B, C, D)`` tensors indexed by layer (int8 rings with
``(L, B, 1, C)`` fp32 per-position scales).

Dispatch: a CUDA tensor launches the hand-written kernel (in bf16
``csrc/skinny_proj.cu`` for every projection and LayerNorm of ``ln_matmul``,
``matmul_residual``, ``cross_block_decode`` and ``mlp_block``, in fp32
``csrc/linear.cu`` for them; ``csrc/cross_attention.cu``,
``csrc/self_attention.cu``, ``csrc/decode_layer.cu`` for
``layer_block_decode`` in bf16, ``csrc/layer_block.cu`` for it in fp32) or
raises; a CPU tensor runs the plain PyTorch twin below. There is no
fallback from one to the other. Each
wrapper counts its launches in ``<function>.launches``;
``self_attend_decode.beam_launches`` counts those with an ancestry map,
``self_attend_decode.q8_launches`` those over int8 rings and
``layer_block_decode.mlp_launches`` those of the whole layer.

Precision contract, shared by kernel and twin: LayerNorm in fp32 (eps 1e-5),
operands of every product rounded to the weight type, products accumulated
in fp32, bias/GELU/residual epilogues in fp32, one rounding at the store.
With fp32 weights this is the JAX fp32 path exactly. The two kernels this
contract did not cover before keep the TPU kernel's rounding to its dot
dtype (bf16 under bf16 activations) too: ``self_attend_decode`` over int8
rings rounds its softmax weights, ``cross_attend_decode`` q, its weights and
their products with the values.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from olmoasr_tpu_torch.ops import _build

LN_EPS = 1e-5


def _ln_f32(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    D = x.shape[-1]
    return F.layer_norm(x.float(), (D,), g.float(), b.float(), LN_EPS)


def _linear_f32(a: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ w.T + b`` with the operands as given, accumulated in fp32."""
    return F.linear(a.float(), w.float(), b.float())


def _require(cond: bool, what: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{what}: {msg}")


def _check_operands(what: str, dtype: torch.dtype, device, **tensors) -> None:
    for name, t in tensors.items():
        _require(t.device == device, what, f"{name} is on {t.device}, not {device}")
        _require(t.dtype == dtype, what, f"{name} is {t.dtype}, not {dtype}")
        _require(t.is_contiguous(), what, f"{name} must be contiguous")
        # the bf16 kernels read rows in 16-byte chunks
        _require(t.data_ptr() % 16 == 0, what, f"{name} must be 16-byte aligned")


def _layer_norm(lib, stream, x, g, b):
    """Launch the fp32 row LayerNorm of csrc/linear.cu: (rows, D)."""
    D = x.shape[-1]
    rows = x.numel() // D
    h = torch.empty((rows, D), dtype=x.dtype, device=x.device)
    _build.check(lib.olm_layer_norm(
        x.data_ptr(), g.data_ptr(), b.data_ptr(), h.data_ptr(), rows, D, LN_EPS,
        _build.dtype_code(x.dtype), stream,
    ), "layer norm")
    return h


def _linear(lib, stream, a, w, bias, out, resid=None, gelu=False):
    """Launch the fp32 ``out = epilogue(a @ w.T)`` with K split over enough
    blocks to put about two on every SM (csrc/linear.cu)."""
    M, K = a.shape
    N = w.shape[0]
    blocks = -(-N // 32) * -(-M // 32)
    splits = max(1, min(K // 64, -(-2 * _sm_count(a.device) // blocks)))
    ws = torch.empty((splits, M, N), dtype=torch.float32, device=a.device) if splits > 1 else None
    _build.check(lib.olm_linear(
        a.data_ptr(), w.data_ptr(), bias.data_ptr(),
        None if resid is None else resid.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), M, N, K, splits,
        _build.dtype_code(w.dtype), int(gelu), stream,
    ), "linear")


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _proj_plain(a, w, bias, resid=None, gelu=False, out_f32=False) -> torch.Tensor:
    """What ``_proj`` computes: epilogue(a @ w.T), rounded to a's dtype, or
    the fp32 sums unrounded where ``out_f32``."""
    v = _linear_f32(a, w, bias)
    if gelu:
        v = F.gelu(v)
    if resid is not None:
        v = resid.float() + v
    return v if out_f32 else v.to(a.dtype)


def _proj(lib, stream, a, w, bias, out=None, resid=None, gelu=False, out_f32=False):
    """Launch the bf16 skinny projection (csrc/skinny_proj.cu) on (M, K) rows:
    ``out = epilogue(a @ w.T)`` in one launch: + bias, GELU if ``gelu``,
    then resid + that, rounded to bf16 (fp32 unrounded where ``out_f32``);
    programmatically dependent on the launch before it (its weight streams
    while that one drains). The callers have checked the operands."""
    M, K = a.shape
    N = w.shape[0]
    if out is None:
        out = torch.empty((M, N), dtype=torch.float32 if out_f32 else a.dtype, device=a.device)
    _build.check(lib.olm_proj(
        a.data_ptr(), w.data_ptr(), bias.data_ptr(),
        None if resid is None else resid.data_ptr(), out.data_ptr(), M, N, K, int(gelu),
        int(out_f32), stream,
    ), "skinny projection")
    return out


def _proj_layer_norm(lib, stream, x, g, b) -> torch.Tensor:
    """Launch the bf16 row LayerNorm of csrc/skinny_proj.cu: (rows, D)."""
    D = x.shape[-1]
    h = torch.empty((x.numel() // D, D), dtype=x.dtype, device=x.device)
    _build.check(lib.olm_proj_layer_norm(
        x.data_ptr(), g.data_ptr(), b.data_ptr(), h.data_ptr(), h.shape[0], D, stream,
    ), "layer norm")
    return h


# ---------------------------------------------------------------------------
# mlp_block
# ---------------------------------------------------------------------------


def mlp_block_plain(x, ln_g, ln_b, w1, b1, w2, b2) -> torch.Tensor:
    """x + W2 gelu(W1 LN(x) + b1) + b2, any (..., D) shape."""
    h = _ln_f32(x, ln_g, ln_b).to(w1.dtype)
    h = F.gelu(_linear_f32(h, w1, b1)).to(w2.dtype)
    return (x.float() + _linear_f32(h, w2, b2)).to(x.dtype)


def mlp_block(
    x: torch.Tensor,  # (B, 1, D)
    ln_g: torch.Tensor,  # (D,)
    ln_b: torch.Tensor,
    w1: torch.Tensor,  # (F, D)
    b1: torch.Tensor,  # (F,)
    w2: torch.Tensor,  # (D, F)
    b2: torch.Tensor,  # (D,)
) -> torch.Tensor:
    """Decode-step MLP: fp32 LN -> W1 + b1 -> exact GELU -> W2 + b2 -> residual.

    Replaces ``olmoasr_tpu/ops/attention.py::mlp_block`` (``_mlp_kernel``;
    its ``_erf_poly`` was a Mosaic work-around, the kernel uses ``erff``).
    Bound on the card: the weight read, 2*D*F elements per layer (small.en
    bf16: 9.4 MB) against 4*B*D*F FLOPs -- at B=64 far below the tensor
    cores' rate, so latency bounds it. In bf16 it is three launches of
    ``csrc/skinny_proj.cu``: the LayerNorm, W1 with a bias + GELU epilogue
    into bf16 u, then W2 with a bias + residual epilogue; each block of a
    product streams its slice of the weight once for up to 160 rows, K split
    over a thread-block cluster whose partials meet in shared memory, and
    starts streaming while the launch before it drains. In fp32 (the checks) it is
    ``csrc/linear.cu``: a LayerNorm launch, then the split-K linear twice.
    """
    if not x.is_cuda:
        return mlp_block_plain(x, ln_g, ln_b, w1, b1, w2, b2)
    what = "mlp_block"
    D = x.shape[-1]
    Fd = w1.shape[0]
    _require(x.dtype in (torch.float32, torch.bfloat16), what, f"x is {x.dtype}")
    _require(tuple(w1.shape) == (Fd, D) and tuple(w2.shape) == (D, Fd), what,
             f"weights {tuple(w1.shape)}, {tuple(w2.shape)} do not fit D={D}")
    _require(tuple(b1.shape) == (Fd,) and tuple(b2.shape) == (D,), what, "bias shapes")
    _require(tuple(ln_g.shape) == (D,) and tuple(ln_b.shape) == (D,), what, "LN shapes")
    _require(D % 8 == 0 and Fd % 8 == 0, what, "D and F must be multiples of 8")
    _check_operands(what, x.dtype, x.device, x=x, ln_g=ln_g, ln_b=ln_b, w1=w1, b1=b1,
                    w2=w2, b2=b2)
    lib, stream = _build.lib(), _build.stream_ptr(x.device)
    out = torch.empty_like(x)
    if x.dtype == torch.bfloat16:
        _require(D <= 1280, what, f"the bf16 LayerNorm takes D up to 1280, not {D}")
        u = _proj(lib, stream, _proj_layer_norm(lib, stream, x, ln_g, ln_b), w1, b1, gelu=True)
        _proj(lib, stream, u, w2, b2, out.view(-1, D), resid=x.view(-1, D))
    else:
        h = _layer_norm(lib, stream, x, ln_g, ln_b)
        u = torch.empty((h.shape[0], Fd), dtype=x.dtype, device=x.device)
        _linear(lib, stream, h, w1, b1, u, gelu=True)
        _linear(lib, stream, u, w2, b2, out.view(-1, D), resid=x.view(-1, D))
    mlp_block.launches += 1
    return out


mlp_block.launches = 0


# ---------------------------------------------------------------------------
# ln_matmul and matmul_residual (the self sub-block's projections)
# ---------------------------------------------------------------------------


def _check_linear(what, x, w, b, N, D) -> None:
    _require(x.dtype in (torch.float32, torch.bfloat16), what, f"x is {x.dtype}")
    _require(x.dim() == 3 and x.shape[1] == 1 and x.shape[2] == D, what,
             f"x must be (B, 1, {D}), got {tuple(x.shape)}")
    _require(tuple(w.shape) == (N, D) and tuple(b.shape) == (N,), what,
             f"weight {tuple(w.shape)} and bias {tuple(b.shape)} do not fit ({N}, {D})")
    _require(D % 8 == 0 and N % 8 == 0, what, "widths must be multiples of 8")


def ln_matmul_plain(x, ln_g, ln_b, w, b) -> torch.Tensor:
    """LN(x) @ w.T + b, any (..., D) shape."""
    return _linear_f32(_ln_f32(x, ln_g, ln_b).to(w.dtype), w, b).to(x.dtype)


def ln_matmul(
    x: torch.Tensor,  # (B, 1, D)
    ln_g: torch.Tensor,  # (D,)
    ln_b: torch.Tensor,
    w: torch.Tensor,  # (N, D), the fused [Wq; Wk; Wv] with N = 3D
    b: torch.Tensor,  # (N,), [bq, 0, bv]: the key projection has no bias
) -> torch.Tensor:
    """Decode-step fp32 LayerNorm + fused QKV projection, (B, 1, N) out.

    Replaces ``olmoasr_tpu/ops/attention.py::ln_matmul``
    (``_ln_matmul_kernel``). Bound on the card: the weight read, 3*D*D
    elements per layer (small.en bf16: 3.5 MB) against 6*B*D*D FLOPs, so
    latency. In bf16 it is two launches of ``csrc/skinny_proj.cu``: the row
    LayerNorm into bf16 h, then the QKV product (N = 3D) with a bias
    epilogue, programmatically dependent on the LayerNorm. In fp32 (the
    checks) ``csrc/linear.cu``: a LayerNorm launch, then the split-K linear.
    """
    if not x.is_cuda:
        return ln_matmul_plain(x, ln_g, ln_b, w, b)
    what = "ln_matmul"
    D, N = x.shape[-1], w.shape[0]
    _check_linear(what, x, w, b, N, D)
    _require(tuple(ln_g.shape) == (D,) and tuple(ln_b.shape) == (D,), what, "LN shapes")
    _check_operands(what, x.dtype, x.device, x=x, ln_g=ln_g, ln_b=ln_b, w=w, b=b)
    lib, stream = _build.lib(), _build.stream_ptr(x.device)
    out = torch.empty((x.shape[0], 1, N), dtype=x.dtype, device=x.device)
    if x.dtype == torch.bfloat16:
        _require(D <= 1280, what, f"the bf16 LayerNorm takes D up to 1280, not {D}")
        _proj(lib, stream, _proj_layer_norm(lib, stream, x, ln_g, ln_b), w, b, out.view(-1, N))
    else:
        _linear(lib, stream, _layer_norm(lib, stream, x, ln_g, ln_b), w, b, out.view(-1, N))
    ln_matmul.launches += 1
    return out


ln_matmul.launches = 0


def matmul_residual_plain(attn, x, w, b) -> torch.Tensor:
    """x + attn @ w.T + b, any (..., D) shape."""
    return (x.float() + _linear_f32(attn.to(w.dtype), w, b)).to(x.dtype)


def matmul_residual(
    attn: torch.Tensor,  # (B, 1, D) attention output
    x: torch.Tensor,  # (B, 1, D) residual stream
    w: torch.Tensor,  # (D, D)
    b: torch.Tensor,  # (D,)
) -> torch.Tensor:
    """Decode-step output projection + bias + residual add.

    Replaces ``olmoasr_tpu/ops/attention.py::matmul_residual``
    (``_matmul_residual_kernel``). Bound on the card: the weight read, D*D
    elements per layer (small.en bf16: 1.2 MB), so latency. In bf16 the
    kernel is one launch of ``csrc/skinny_proj.cu`` with the bias-and-residual
    epilogue; in fp32 (the checks) ``csrc/linear.cu``'s split-K linear.
    """
    if not x.is_cuda:
        return matmul_residual_plain(attn, x, w, b)
    what = "matmul_residual"
    D = x.shape[-1]
    _check_linear(what, x, w, b, D, D)
    _require(attn.shape == x.shape, what, f"attn {tuple(attn.shape)} is not x's shape")
    _check_operands(what, x.dtype, x.device, attn=attn, x=x, w=w, b=b)
    lib, stream = _build.lib(), _build.stream_ptr(x.device)
    out = torch.empty_like(x)
    launch = _proj if x.dtype == torch.bfloat16 else _linear
    launch(lib, stream, attn.view(-1, D), w, b, out.view(-1, D), resid=x.view(-1, D))
    matmul_residual.launches += 1
    return out


matmul_residual.launches = 0


# ---------------------------------------------------------------------------
# cross_block_decode
# ---------------------------------------------------------------------------


def _q_scale(dh: int) -> float:
    """dh^-0.5, formed as the JAX kernels form it (q and k each dh^-0.25)."""
    scale = dh ** -0.25
    return scale * scale


def _check_head(what: str, D: int, n_head: int) -> int:
    _require(D % n_head == 0, what, f"D={D} is not a multiple of n_head={n_head}")
    dh = D // n_head
    _require(dh <= 128 and 128 % dh == 0, what, f"head width {dh} must divide 128")
    _require(D % 8 == 0, what, "D must be a multiple of 8")
    return dh


def _dot_dtype(dtype: torch.dtype) -> torch.dtype:
    """The TPU kernels' dot dtype (``_dot_dtype``): bf16 under bf16
    activations, fp32 otherwise."""
    return torch.bfloat16 if dtype == torch.bfloat16 else torch.float32


def _check_scales(what: str, device, shape, **scales) -> None:
    for name, t in scales.items():
        _require(t.dtype == torch.float32 and t.device == device and t.is_contiguous()
                 and t.numel() == math.prod(shape), what,
                 f"{name} must be contiguous fp32 {tuple(shape)} on {device}, got "
                 f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _partials(B: int, n_head: int, nchunks: int, dh: int, device):
    """Scratch of the split-position attention: per (row, head, chunk) max,
    sum and weighted values, fp32."""
    f32 = dict(dtype=torch.float32, device=device)
    n = B * n_head * nchunks
    return torch.empty((n,), **f32), torch.empty((n,), **f32), torch.empty((n * dh,), **f32)


def quantizes_q(k_dtype: torch.dtype, x_dtype: torch.dtype) -> bool:
    """Whether the cross q.K product is the int8 one: int8 keys under bf16
    activations, as the TPU kernel's ``_qk_logits`` decides."""
    return k_dtype == torch.int8 and x_dtype == torch.bfloat16


def qk_logits(q: torch.Tensor, k: torch.Tensor, quantize_q: bool) -> torch.Tensor:
    """Per-head logits before the per-key scale: q (B, S, H, dh) fp32,
    already scaled by dh^-0.5; k (B, T, H, dh) in the cache's dtype;
    (B, H, S, T) fp32 out.

    ``quantize_q`` (int8 keys): q is rounded per head and row to int8 with
    the scale max(amax(|q_h|), 1e-20) / 127 (half to even, clipped to
    +-127), the dot product with the int8 keys is taken in integers, and the
    result is multiplied by that scale: ``_qk_logits`` of
    ``olmoasr_tpu/ops/attention.py``. The integer sums are below 2^24, so the
    fp32 einsum holds them exactly in any order."""
    if not quantize_q:
        return torch.einsum("bshd,bthd->bhst", q, k.float())
    scale = q.abs().amax(dim=-1, keepdim=True).clamp_min(1e-20) / 127.0  # (B, S, H, 1)
    q8 = torch.clamp(torch.round(q / scale), -127, 127)
    acc = torch.einsum("bshd,bthd->bhst", q8, k.float())
    return acc * scale.permute(0, 2, 1, 3)


def _cross_attend_plain(q, ck, cv, ck_scale, cv_scale, n_head: int, quantize_q: bool):
    """Cross attention of q (B, S, D) fp32, already scaled by dh^-0.5, over
    the cache rows (B, T, D) with their (B, 1, T) scales; (B, S, D) fp32."""
    B, S, D = q.shape
    T = ck.shape[1]
    dh = D // n_head
    logits = qk_logits(q.view(B, S, n_head, dh), ck.view(B, T, n_head, dh), quantize_q)
    logits = logits * ck_scale.float().reshape(B, 1, 1, T)
    w = torch.softmax(logits, dim=-1) * cv_scale.float().reshape(B, 1, 1, T)
    return torch.einsum("bhst,bthd->bshd", w, cv.float().view(B, T, n_head, dh)).reshape(B, S, D)


def cross_block_decode_plain(
    x, ln_g, ln_b, wq, bq, wo, bo, ck, cv, ck_scale, cv_scale, n_head: int,
    kv_group: int = 1, *, quantize_q: Optional[bool] = None,
) -> torch.Tensor:
    """Cross sub-block for any number S of query rows (the prefill uses S>1).
    With ``kv_group`` G, the G query rows of one cache row fold into its
    query sequence: cross attention is position-independent per query.
    The q.K product is the int8 one (:func:`qk_logits`) when ``quantize_q``,
    which by default is decided as the TPU kernel decides it: int8 keys under
    bf16 activations (:func:`quantizes_q`)."""
    if quantize_q is None:
        quantize_q = quantizes_q(ck.dtype, x.dtype)
    if kv_group > 1:
        Bq, S, D = x.shape
        out = cross_block_decode_plain(
            x.reshape(Bq // kv_group, kv_group * S, D), ln_g, ln_b, wq, bq, wo, bo,
            ck, cv, ck_scale, cv_scale, n_head, quantize_q=quantize_q,
        )
        return out.reshape(Bq, S, D)
    dh = x.shape[-1] // n_head
    h = _ln_f32(x, ln_g, ln_b).to(wq.dtype)
    q = _linear_f32(h, wq, bq) * _q_scale(dh)  # (B, S, D) fp32
    attn = _cross_attend_plain(q, ck, cv, ck_scale, cv_scale, n_head, quantize_q).to(wo.dtype)
    return (x.float() + _linear_f32(attn, wo, bo)).to(x.dtype)


def cross_block_decode(
    x: torch.Tensor,  # (B, 1, D) residual stream after the self sub-block
    ln_g: torch.Tensor,  # (D,) cross LN
    ln_b: torch.Tensor,
    wq: torch.Tensor,  # (D, D)
    bq: torch.Tensor,  # (D,)
    wo: torch.Tensor,  # (D, D)
    bo: torch.Tensor,  # (D,)
    ck: torch.Tensor,  # (B, T, D) bf16, fp32 or int8
    cv: torch.Tensor,  # (B, T, D)
    ck_scale: torch.Tensor,  # (B, 1, T) fp32, ones when unquantized
    cv_scale: torch.Tensor,
    n_head: int,
    kv_group: int = 1,
) -> torch.Tensor:
    """Decode-step cross sub-block: fp32 LN -> q projection -> single-query
    attention over the T cached keys -> output projection -> residual.

    Replaces ``olmoasr_tpu/ops/attention.py::cross_block_decode`` with
    ``_cross_block_kernel`` (non-transposed K). ``kv_group``: query row b
    reads cache row b // kv_group (best_of samples of one window share its
    cache). Bound on the card: the cross cache read, 2*B*T*D elements per
    layer and step for B cache rows (small.en, B=64, bf16: 295 MB per layer).
    Launches: the LayerNorm and the q projection with its bias, stored fp32
    unrounded; the attention (``olm_cross_attention`` in
    ``csrc/cross_attention.cu``, one launch of the single-pass core of
    ``csrc/decode_attention.cuh``: a cache row's ``kv_group`` query rows in
    one block, each stage of K and V staged once for all of them, a (row,
    head) pair's keys split over the blocks of one cluster, no partials in
    device memory; every product fp32); the output projection with bias +
    residual. In bf16 the LayerNorm and the two projections run on
    ``csrc/skinny_proj.cu`` (four launches in all; q's product and Wo each
    programmatically dependent on the launch before it), in fp32 (the
    checks) on ``csrc/linear.cu``. The cache is int8 or in x's dtype. int8
    keys under bf16 activations take the TPU kernel's int8 q.K product from
    the unrounded fp32 q (q rounded per head, ``__dp4a``;
    :func:`qk_logits`); fp32 activations keep the exact product.
    """
    if not x.is_cuda:
        return cross_block_decode_plain(
            x, ln_g, ln_b, wq, bq, wo, bo, ck, cv, ck_scale, cv_scale, n_head, kv_group
        )
    what = "cross_block_decode"
    B, S, D = x.shape
    _require(S == 1, what, f"the kernel takes one query row per batch row, got S={S}")
    _require(x.dtype in (torch.float32, torch.bfloat16), what, f"x is {x.dtype}")
    dh = _check_head(what, D, n_head)
    _require(kv_group >= 1 and ck.dim() == 3 and ck.shape[0] * kv_group == B
             and ck.shape[2] == D, what,
             f"cross keys {tuple(ck.shape)} x kv_group {kv_group} do not match x {tuple(x.shape)}")
    T = ck.shape[1]
    _require(cv.shape == ck.shape and cv.dtype == ck.dtype, what, "ck and cv differ")
    _require(ck.dtype in (torch.int8, x.dtype), what,
             f"the cache must be int8 or x's {x.dtype}, got {ck.dtype}")
    _require(ck.is_contiguous() and cv.is_contiguous(), what, "ck, cv must be contiguous")
    _require(ck.data_ptr() % 16 == 0 and cv.data_ptr() % 16 == 0, what,
             "ck, cv must be 16-byte aligned")
    for name, s in (("ck_scale", ck_scale), ("cv_scale", cv_scale)):
        _require(s.dtype == torch.float32 and s.numel() == ck.shape[0] * T and s.is_contiguous(),
                 what, f"{name} must be contiguous fp32 with (cache rows)*T elements")
        _require(s.device == x.device, what, f"{name} is on {s.device}")
    _require(ck.device == x.device, what, f"cache is on {ck.device}")
    _check_operands(what, x.dtype, x.device, x=x, ln_g=ln_g, ln_b=ln_b, wq=wq, bq=bq,
                    wo=wo, bo=bo)
    _require(tuple(wq.shape) == (D, D) and tuple(wo.shape) == (D, D), what, "weight shapes")
    lib, stream = _build.lib(), _build.stream_ptr(x.device)
    bf16 = x.dtype == torch.bfloat16
    q = torch.empty((B, D), dtype=torch.float32, device=x.device)
    if bf16:
        _require(D <= 1280, what, f"the bf16 LayerNorm takes D up to 1280, not {D}")
        _proj(lib, stream, _proj_layer_norm(lib, stream, x, ln_g, ln_b), wq, bq, q, out_f32=True)
    else:
        _linear(lib, stream, _layer_norm(lib, stream, x, ln_g, ln_b), wq, bq, q)
    attn = torch.empty((B, D), dtype=x.dtype, device=x.device)
    _build.check(lib.olm_cross_attention(
        q.data_ptr(), ck.data_ptr(), cv.data_ptr(), ck_scale.data_ptr(),
        cv_scale.data_ptr(), attn.data_ptr(), B, T, D, n_head, kv_group,
        _build.dtype_code(ck.dtype), _build.dtype_code(x.dtype), _q_scale(dh), stream,
    ), "cross_block_decode (attention)")
    out = torch.empty_like(x)
    (_proj if bf16 else _linear)(lib, stream, attn, wo, bo, out.view(B, D), resid=x.view(B, D))
    cross_block_decode.launches += 1
    return out


cross_block_decode.launches = 0


# ---------------------------------------------------------------------------
# cross_attend_decode
# ---------------------------------------------------------------------------


def cross_attend_decode_plain(q, k, v, k_scale=None, v_scale=None, *,
                              n_head: int) -> torch.Tensor:
    """The TPU kernel's arithmetic (``_cross_decode_kernel``) for any number
    S of query rows: q scaled by dh^-0.5 in fp32, the logits of the dot dtype
    (:func:`qk_logits`: the int8 product under bf16 over int8 keys,
    otherwise q and the keys rounded to the dot dtype) times the k scale,
    the softmax, then the v scale, then the weights rounded to the dot
    dtype, each weight-value product rounded to it, the products summed in
    fp32, one rounding at the store."""
    B, S, D = q.shape
    T = k.shape[1]
    dh = D // n_head
    dd = _dot_dtype(q.dtype)
    quantize_q = quantizes_q(k.dtype, q.dtype)
    qs = q.float() * _q_scale(dh)
    if not quantize_q:
        qs = qs.to(dd).float()
    logits = qk_logits(qs.view(B, S, n_head, dh), k.to(dd).view(B, T, n_head, dh), quantize_q)
    ones = lambda: torch.ones(B, T, device=q.device)
    ks = (ones() if k_scale is None else k_scale.float()).reshape(B, 1, 1, T)
    vs = (ones() if v_scale is None else v_scale.float()).reshape(B, 1, 1, T)
    w = (torch.softmax(logits * ks, dim=-1) * vs).to(dd)  # (B, H, S, T)
    prod = w[..., None] * v.to(dd).view(B, 1, T, n_head, dh).permute(0, 3, 1, 2, 4)
    return prod.float().sum(dim=-2).permute(0, 2, 1, 3).reshape(B, S, D).to(q.dtype)


def cross_attend_decode(
    q: torch.Tensor,  # (B, 1, D) projected, not yet scaled, in the activation dtype
    k: torch.Tensor,  # (B, T, D) int8, or q's dtype
    v: torch.Tensor,
    k_scale: Optional[torch.Tensor] = None,  # (B, T) or (B, 1, T) fp32; None: ones
    v_scale: Optional[torch.Tensor] = None,
    *,
    n_head: int,
) -> torch.Tensor:
    """Single-query cross attention alone, (B, 1, D) in q's dtype.

    Replaces ``olmoasr_tpu/ops/attention.py::cross_attend_decode``
    (``_cross_decode_kernel``), which the JAX step runs with the cross block
    off (``OLMOASR_PALLAS_CROSS=1``) between an ``ln_matmul`` for the cross q
    and a ``matmul_residual``; one kv row per query row, as there. Bound on
    the card: the cache read, 2*B*T*D elements (small.en, B=64, bf16: 295 MB
    a layer). The kernel (``olm_cross_attend`` in ``csrc/cross_attention.cu``)
    is one launch of the single-pass core of ``csrc/decode_attention.cuh``:
    a (row, head) pair's keys split over the blocks of one cluster, merged
    in distributed shared memory, no partials in device memory; with the
    TPU kernel's bf16 rounding of q, of the weights and of their products
    with the values under bf16 activations (the plain twin says where).
    """
    what = "cross_attend_decode"
    if not q.is_cuda:
        return cross_attend_decode_plain(q, k, v, k_scale, v_scale, n_head=n_head)
    B, S, D = q.shape
    _require(S == 1, what, f"the kernel takes one query row per batch row, got S={S}")
    _require(q.dtype in (torch.float32, torch.bfloat16), what, f"q is {q.dtype}")
    dh = _check_head(what, D, n_head)
    _require(k.dim() == 3 and k.shape[0] == B and k.shape[2] == D and v.shape == k.shape, what,
             f"cache {tuple(k.shape)}, {tuple(v.shape)} does not match q {tuple(q.shape)}")
    T = k.shape[1]
    _require(k.dtype in (torch.int8, q.dtype) and v.dtype == k.dtype, what,
             f"the cache must be int8 or q's {q.dtype}, got {k.dtype}, {v.dtype}")
    _check_operands(what, k.dtype, q.device, k=k, v=v)
    _check_operands(what, q.dtype, q.device, q=q)
    scales = {n: t for n, t in (("k_scale", k_scale), ("v_scale", v_scale)) if t is not None}
    _check_scales(what, q.device, (B, T), **scales)
    out = torch.empty_like(q)
    _build.check(_build.lib().olm_cross_attend(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if k_scale is None else k_scale.data_ptr(),
        None if v_scale is None else v_scale.data_ptr(), out.data_ptr(), B, T, D, n_head,
        _build.dtype_code(k.dtype), _build.dtype_code(q.dtype), _q_scale(dh),
        _build.stream_ptr(q.device),
    ), what)
    cross_attend_decode.launches += 1
    return out


cross_attend_decode.launches = 0


# ---------------------------------------------------------------------------
# self_attend_decode
# ---------------------------------------------------------------------------


def _ancestry_rows(beam_anc: torch.Tensor, beam_k: int) -> torch.Tensor:
    """(B, P) ring rows from a (B, P) ancestry map: row b, position t reads
    ring row (b // beam_k) * beam_k + beam_anc[b, t]; an entry outside
    [0, beam_k) reads the group's first row, as the TPU kernel's masked pick
    (``_anc_kv_select``) does."""
    anc = beam_anc.long()
    anc = torch.where((anc >= 0) & (anc < beam_k), anc, 0)
    group0 = torch.arange(anc.shape[0], device=anc.device) // beam_k * beam_k
    return group0[:, None] + anc


def self_attend_decode_plain(
    q, k_ring, v_ring, k_new, v_new, offset: int, layer_idx: int, *, n_head: int,
    beam_anc=None, beam_k: int = 1, k_scale=None, v_scale=None, quantize_q=None,
) -> torch.Tensor:
    """Single-query attention over ring positions < offset of one layer plus
    this step's own key and value, fp32 throughout, one rounding at the end.
    With ``beam_anc`` the ring positions are gathered by ancestry first.

    int8 rings with their (L, B, 1, C) scales (``_self_decode_body`` with its
    scale refs): the ring logits are :func:`qk_logits` (the int8 q.K product
    when ``quantize_q``, by default under bf16 activations) times the k
    scale; this step's key enters with the unrounded fp32 q; the v scale
    folds into the ring weights, which are then rounded to the dot dtype."""
    B, _, D = q.shape
    dh = D // n_head
    heads = lambda t: t.float().reshape(B, -1, n_head, dh)
    qh = heads(q)[:, 0] * _q_scale(dh)  # (B, H, dh)
    k, v = k_ring[layer_idx, :, :offset], v_ring[layer_idx, :, :offset]
    if beam_anc is not None:
        rows = _ancestry_rows(beam_anc[:, :offset], beam_k)
        pos = torch.arange(offset, device=q.device)
        k, v = k[rows, pos], v[rows, pos]
    if k_scale is None:
        old = torch.einsum("bhd,bthd->bht", qh, heads(k))
    else:
        if quantize_q is None:
            quantize_q = quantizes_q(k.dtype, q.dtype)
        old = qk_logits(qh[:, None], k.reshape(B, offset, n_head, dh), quantize_q)[:, :, 0]
        old = old * k_scale[layer_idx, :, 0, :offset].float()[:, None]
    logits = torch.cat([old, (qh * heads(k_new)[:, 0]).sum(-1, keepdim=True)], dim=-1)
    w = torch.softmax(logits, dim=-1)
    w_old = w[..., :offset]
    if v_scale is not None:
        w_old = w_old * v_scale[layer_idx, :, 0, :offset].float()[:, None]
        w_old = w_old.to(_dot_dtype(q.dtype)).float()
    out = torch.einsum("bht,bthd->bhd", w_old, heads(v)) + w[..., offset:] * heads(v_new)[:, 0]
    return out.reshape(B, 1, D).to(q.dtype)


def self_attend_decode(
    q: torch.Tensor,  # (B, 1, D); rows may be views of the fused QKV output
    k_ring: torch.Tensor,  # (L, B, C, D), positions < offset valid; read only
    v_ring: torch.Tensor,
    k_new: torch.Tensor,  # (B, 1, D) this step's key, rows strided as q's
    v_new: torch.Tensor,
    offset: int,
    layer_idx: int,
    *,
    n_head: int,
    beam_anc: Optional[torch.Tensor] = None,  # (B, C) int32 within-group ring rows
    beam_k: int = 1,
    k_scale: Optional[torch.Tensor] = None,  # (L, B, 1, C) fp32 with int8 rings
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Decode-step self attention of layer ``layer_idx`` over the read-only
    rings, the new key always visible; (B, 1, D) in q's dtype.

    Replaces ``olmoasr_tpu/ops/attention.py::self_attend_decode``
    (``_self_decode_kernel``, body ``_self_decode_body``; bf16 or fp32 rings),
    with ``k_scale``/``v_scale`` over int8 rings (``_self_decode_kernel_q8``:
    the cross pass's int8 q.K product under bf16, the scales read at the
    rings' (L, B, 1, C) layout, the weights rounded to bf16; see the twin)
    and, with ``beam_anc``, its beam-search mode (``_self_decode_kernel_beam``
    with ``_anc_kv_select``): rows come in groups of ``beam_k`` beams, the
    rings are never reordered, and row b reads position t from ring row
    ``(b // beam_k) * beam_k + beam_anc[b, t]``; its new key and value are
    its own. Ancestry needs unquantized rings, as the JAX wrapper asserts.

    Bound on the card: the ring read, 2*B*offset*D elements per layer and
    step (small.en, B=64, offset 224, bf16: 44 MB; int8: 22 MB and the
    scales). The kernel (``csrc/self_attention.cu``, the layer chosen by
    pointer, the ring's row stride C): without ancestry, over bf16, fp32 and
    int8 rings, one launch of the single-pass core of
    ``csrc/decode_attention.cuh`` (a (row, head) pair's positions split over
    the blocks of one cluster, merged in distributed shared memory, the new
    key and value folded in by rank 0); with ancestry the split-position
    pass and a combine launch that folds in the new key and value: each
    block loads its chunk's map once and reads every key from its ancestor
    row; a group's blocks are grid neighbours, so the ancestors' repeats
    come from L2. The caller writes k_new and v_new into the rings
    afterwards.
    """
    what = "self_attend_decode"
    quantized = k_ring.dtype == torch.int8
    if beam_anc is not None:
        _require(not quantized, what, "beam ancestry needs unquantized rings")
    _require(quantized == (k_scale is not None) == (v_scale is not None), what,
             "int8 rings take k_scale and v_scale, other rings neither")
    if not q.is_cuda:
        return self_attend_decode_plain(
            q, k_ring, v_ring, k_new, v_new, offset, layer_idx, n_head=n_head,
            beam_anc=beam_anc, beam_k=beam_k, k_scale=k_scale, v_scale=v_scale,
        )
    B, S, D = q.shape
    _require(S == 1, what, f"the kernel takes one query row per batch row, got S={S}")
    _require(q.dtype in (torch.float32, torch.bfloat16), what, f"q is {q.dtype}")
    dh = _check_head(what, D, n_head)
    _require(k_ring.dim() == 4 and k_ring.shape[1] == B and k_ring.shape[3] == D, what,
             f"rings {tuple(k_ring.shape)} do not match q {tuple(q.shape)}")
    L, _, C, _ = k_ring.shape
    _require(v_ring.shape == k_ring.shape, what, "k_ring and v_ring differ")
    _require(0 <= offset <= C and 0 <= layer_idx < L, what,
             f"offset {offset} or layer {layer_idx} outside the rings {tuple(k_ring.shape)}")
    _check_operands(what, k_ring.dtype if quantized else q.dtype, q.device, k_ring=k_ring,
                    v_ring=v_ring)
    if quantized:
        _check_scales(what, q.device, (L, B, 1, C), k_scale=k_scale, v_scale=v_scale)
    stride = q.stride(0)
    for name, t in (("q", q), ("k_new", k_new), ("v_new", v_new)):
        _require(t.shape == q.shape and t.dtype == q.dtype and t.device == q.device, what,
                 f"{name} is {t.dtype} {tuple(t.shape)} on {t.device}")
        _require(t.stride(2) == 1 and (B == 1 or t.stride(0) == stride), what,
                 f"{name}: rows must be contiguous and strided as q's")
        _require(t.data_ptr() % 16 == 0 and stride * t.element_size() % 16 == 0, what,
                 f"{name} rows must be 16-byte aligned")
    if beam_anc is None:
        beam_k = 1
    else:
        _require(beam_k >= 1 and B % beam_k == 0, what, f"{B} rows are not groups of {beam_k}")
        _require(beam_anc.dtype == torch.int32 and tuple(beam_anc.shape) == (B, C)
                 and beam_anc.is_contiguous() and beam_anc.device == q.device, what,
                 f"beam_anc must be contiguous int32 ({B}, {C}) on {q.device}, got "
                 f"{beam_anc.dtype} {tuple(beam_anc.shape)} on {beam_anc.device}")
    lib = _build.lib()
    # the split pass's scratch (ancestry), held until the launch is queued,
    # so that the allocator does not hand its memory to `out`
    parts = _partials(B, n_head, lib.olm_decode_attention_chunks(offset), dh, q.device) \
        if beam_anc is not None else (None,) * 3
    out = torch.empty((B, 1, D), dtype=q.dtype, device=q.device)
    scales = (k_scale.data_ptr(), v_scale.data_ptr()) if quantized else (None, None)
    _build.check(lib.olm_self_attention(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), stride, k_ring.data_ptr(),
        v_ring.data_ptr(), *scales, None if beam_anc is None else beam_anc.data_ptr(),
        *(None if t is None else t.data_ptr() for t in parts), out.data_ptr(), L, layer_idx,
        B, C, offset, D, n_head, beam_k, _build.dtype_code(k_ring.dtype),
        _build.dtype_code(q.dtype), _q_scale(dh), _build.stream_ptr(q.device),
    ), what)
    self_attend_decode.launches += 1
    self_attend_decode.beam_launches += beam_anc is not None
    self_attend_decode.q8_launches += quantized
    return out


self_attend_decode.launches = 0
self_attend_decode.beam_launches = 0  # the launches with an ancestry map
self_attend_decode.q8_launches = 0  # the launches over int8 rings


# ---------------------------------------------------------------------------
# layer_block_decode
# ---------------------------------------------------------------------------


def layer_block_decode_plain(
    x, attn_ln_g, attn_ln_b, w_qkv, b_qkv, attn_o_w, attn_o_b,
    cross_ln_g, cross_ln_b, cross_q_w, cross_q_b, cross_o_w, cross_o_b,
    k_ring, v_ring, ck, cv, ck_scale, cv_scale, offset: int, layer_idx: int, *, n_head: int,
    include_mlp: bool = False, mlp=None,
):
    """The self and cross sub-blocks of one layer (and with ``include_mlp``
    the MLP, ``mlp`` its (ln_g, ln_b, w1, b1, w2, b2)), the residual and the
    projections in fp32 between them; (out, kv_new) as the kernel returns
    them."""
    D = x.shape[-1]
    wdt = w_qkv.dtype
    qkv = _linear_f32(_ln_f32(x, attn_ln_g, attn_ln_b).to(wdt), w_qkv, b_qkv)  # (B, 1, 3D)
    q, k_new, v_new = qkv.split(D, dim=-1)
    a = self_attend_decode_plain(q, k_ring, v_ring, k_new, v_new, offset, layer_idx,
                                 n_head=n_head)  # fp32, as its q
    x1 = x.float() + _linear_f32(a.to(wdt), attn_o_w, attn_o_b)
    qc = _linear_f32(_ln_f32(x1, cross_ln_g, cross_ln_b).to(wdt), cross_q_w, cross_q_b)
    c = _cross_attend_plain(qc * _q_scale(D // n_head), ck, cv, ck_scale, cv_scale, n_head,
                            quantizes_q(ck.dtype, x.dtype))
    x2 = x1 + _linear_f32(c.to(wdt), cross_o_w, cross_o_b)
    if include_mlp:
        ln_g, ln_b, w1, b1, w2, b2 = mlp
        u = F.gelu(_linear_f32(_ln_f32(x2, ln_g, ln_b).to(wdt), w1, b1)).to(wdt)
        x2 = x2 + _linear_f32(u, w2, b2)
    return x2.to(x.dtype), torch.stack([k_new, v_new]).to(x.dtype)


def layer_block_decode(
    x: torch.Tensor,  # (B, 1, D) residual stream
    attn_ln_g: torch.Tensor,  # (D,) self sub-block
    attn_ln_b: torch.Tensor,
    w_qkv: torch.Tensor,  # (3D, D), the fused [Wq; Wk; Wv]
    b_qkv: torch.Tensor,  # (3D,), [bq, 0, bv]
    attn_o_w: torch.Tensor,  # (D, D)
    attn_o_b: torch.Tensor,
    cross_ln_g: torch.Tensor,  # (D,) cross sub-block
    cross_ln_b: torch.Tensor,
    cross_q_w: torch.Tensor,  # (D, D)
    cross_q_b: torch.Tensor,
    cross_o_w: torch.Tensor,  # (D, D)
    cross_o_b: torch.Tensor,
    k_ring: torch.Tensor,  # (L, B, C, D), positions < offset valid; read only
    v_ring: torch.Tensor,
    ck: torch.Tensor,  # (B, T, D) int8 cross cache of this layer
    cv: torch.Tensor,
    ck_scale: torch.Tensor,  # (B, 1, T) fp32
    cv_scale: torch.Tensor,
    offset: int,
    layer_idx: int,
    *,
    n_head: int,
    include_mlp: bool = False,
    mlp=None,  # with include_mlp: the MLP's (ln_g, ln_b, w1 (F, D), b1, w2 (D, F), b2)
):
    """The self and cross sub-blocks of decoder layer ``layer_idx`` for one
    decode step, in one launch: ``(out, kv_new)`` with out (B, 1, D) and this
    step's key and value as ``kv_new`` (2, B, 1, D), for the caller to write
    into the rings at ``offset``. With ``include_mlp`` the launch runs the
    MLP too, and out is the layer's output.

    Replaces ``olmoasr_tpu/ops/attention.py::layer_block_decode``
    (``_layer_block_impl``) in its default "sc" mode (self + cross, the MLP
    after it as ``mlp_block``) and with ``include_mlp=True`` (the whole
    layer). The JAX package takes it for S=1 steps over an int8 cross cache
    with one token row per window, no beam ancestry and unquantized rings,
    and so does ``decode_step``: "sc" by default (greedy decoding and samples
    without best_of under ``kv_quant``, the server's default), the whole
    layer with ``route="layer"``. Its TPU-only forms are not ported: the
    transposed key layout (the port keeps (B, T, D)) and ``rows``/``wv_mode``.

    It computes what the chain ``ln_matmul`` -> ``self_attend_decode`` ->
    ``matmul_residual`` -> ``cross_block_decode`` computes, but, as the TPU
    kernel, keeps the residual and the projections in fp32 inside the layer
    and rounds once at the store. bf16 (``olm_decode_layer``,
    ``csrc/decode_layer.cu``): one cooperative launch (clusters of 4 blocks)
    of six phases and five grid-wide barriers (eight and seven with the MLP):
    each projection takes its LayerNorm as a prologue and splits K over a
    cluster, whose blocks add their partial tiles through distributed shared
    memory; each attention phase gives a block one (row, head) and streams
    all its keys through a cp.async ring that starts filling before the
    barrier that publishes q. fp32 (``csrc/layer_block.cu``): the split kernels' block
    bodies as thirteen phases (eighteen with the MLP), for the exact checks.
    Head widths 32, 64 and 128 in bf16; D up to 1280.
    """
    what = "layer_block_decode"
    _require(include_mlp == (mlp is not None), what,
             "include_mlp takes the MLP's six tensors in mlp, and mlp needs include_mlp")
    _require(k_ring.dtype != torch.int8, what, "the self rings must be unquantized")
    if not x.is_cuda:
        return layer_block_decode_plain(
            x, attn_ln_g, attn_ln_b, w_qkv, b_qkv, attn_o_w, attn_o_b, cross_ln_g, cross_ln_b,
            cross_q_w, cross_q_b, cross_o_w, cross_o_b, k_ring, v_ring, ck, cv, ck_scale,
            cv_scale, offset, layer_idx, n_head=n_head, include_mlp=include_mlp, mlp=mlp,
        )
    B, S, D = x.shape
    _require(S == 1, what, f"the kernel takes one query row per batch row, got S={S}")
    _require(x.dtype in (torch.float32, torch.bfloat16), what, f"x is {x.dtype}")
    _check_head(what, D, n_head)
    _check_operands(what, x.dtype, x.device, x=x, attn_ln_g=attn_ln_g, attn_ln_b=attn_ln_b,
                    w_qkv=w_qkv, b_qkv=b_qkv, attn_o_w=attn_o_w, attn_o_b=attn_o_b,
                    cross_ln_g=cross_ln_g, cross_ln_b=cross_ln_b, cross_q_w=cross_q_w,
                    cross_q_b=cross_q_b, cross_o_w=cross_o_w, cross_o_b=cross_o_b,
                    k_ring=k_ring, v_ring=v_ring)
    shapes = {"w_qkv": (w_qkv, (3 * D, D)), "b_qkv": (b_qkv, (3 * D,)),
              "attn_o_w": (attn_o_w, (D, D)), "cross_q_w": (cross_q_w, (D, D)),
              "cross_o_w": (cross_o_w, (D, D))}
    shapes.update({name: (t, (D,)) for name, t in (
        ("attn_ln_g", attn_ln_g), ("attn_ln_b", attn_ln_b), ("attn_o_b", attn_o_b),
        ("cross_ln_g", cross_ln_g), ("cross_ln_b", cross_ln_b), ("cross_q_b", cross_q_b),
        ("cross_o_b", cross_o_b))})
    Fd = 0
    if include_mlp:
        Fd = mlp[2].shape[0]
        _require(Fd % 8 == 0, what, f"the MLP's width {Fd} is not a multiple of 8")
        names = ("mlp_ln_g", "mlp_ln_b", "w1", "b1", "w2", "b2")
        _check_operands(what, x.dtype, x.device, **dict(zip(names, mlp)))
        shapes.update(zip(names, zip(mlp, ((D,), (D,), (Fd, D), (Fd,), (D, Fd), (D,)))))
    for name, (t, shape) in shapes.items():
        _require(tuple(t.shape) == shape, what, f"{name} is {tuple(t.shape)}, not {shape}")
    _require(k_ring.dim() == 4 and k_ring.shape[1] == B and k_ring.shape[3] == D
             and v_ring.shape == k_ring.shape, what,
             f"rings {tuple(k_ring.shape)}, {tuple(v_ring.shape)} do not match x {tuple(x.shape)}")
    L, _, C, _ = k_ring.shape
    _require(0 <= offset <= C and 0 <= layer_idx < L, what,
             f"offset {offset} or layer {layer_idx} outside the rings {tuple(k_ring.shape)}")
    _require(ck.dtype == torch.int8 and cv.dtype == torch.int8, what,
             f"the cross cache must be int8, got {ck.dtype}")
    _require(ck.dim() == 3 and ck.shape[0] == B and ck.shape[2] == D and cv.shape == ck.shape,
             what, f"cross cache {tuple(ck.shape)} does not match x {tuple(x.shape)}")
    T = ck.shape[1]
    for name, t in (("ck", ck), ("cv", cv)):
        _require(t.is_contiguous() and t.data_ptr() % 16 == 0 and t.device == x.device, what,
                 f"{name} must be contiguous and 16-byte aligned on {x.device}")
    for name, t in (("ck_scale", ck_scale), ("cv_scale", cv_scale)):
        _require(t.dtype == torch.float32 and t.numel() == B * T and t.is_contiguous()
                 and t.device == x.device, what,
                 f"{name} must be contiguous fp32 with B*T elements on {x.device}")
    lib, stream = _build.lib(), _build.stream_ptr(x.device)
    bf16 = x.dtype == torch.bfloat16
    if bf16:
        _require(D // n_head in (32, 64, 128) and D <= 1280, what,
                 f"the bf16 kernel takes head widths 32, 64, 128 and D up to 1280, "
                 f"got {D // n_head} and {D}")
        floats = lib.olm_decode_layer_scratch(B, D, Fd)
    else:
        floats = lib.olm_layer_block_scratch(B, D, n_head, T, offset, Fd, _build.F32)
    _require(floats > 0, what, f"no launch plan for B={B} D={D} heads={n_head} T={T}")
    scratch = torch.empty((floats,), dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    kv_new = torch.empty((2, B, 1, D), dtype=x.dtype, device=x.device)
    ptrs = (
        x.data_ptr(), attn_ln_g.data_ptr(), attn_ln_b.data_ptr(), w_qkv.data_ptr(),
        b_qkv.data_ptr(), attn_o_w.data_ptr(), attn_o_b.data_ptr(), cross_ln_g.data_ptr(),
        cross_ln_b.data_ptr(), cross_q_w.data_ptr(), cross_q_b.data_ptr(), cross_o_w.data_ptr(),
        cross_o_b.data_ptr(), *((t.data_ptr() for t in mlp) if include_mlp else (None,) * 6),
        k_ring.data_ptr(), v_ring.data_ptr(), ck.data_ptr(), cv.data_ptr(),
        ck_scale.data_ptr(), cv_scale.data_ptr(), out.data_ptr(), kv_new.data_ptr(),
        scratch.data_ptr(), L, layer_idx, B, C, offset, D, n_head, T, Fd,
    )
    if bf16:  # no trace buffer: perf/probe_decode_layer.py passes one
        err = lib.olm_decode_layer(*ptrs, _q_scale(D // n_head), None, stream)
    else:
        err = lib.olm_layer_block(*ptrs, _build.F32, _q_scale(D // n_head), stream)
    _build.check(err, what)
    layer_block_decode.launches += 1
    layer_block_decode.mlp_launches += include_mlp
    return out, kv_new


layer_block_decode.launches = 0
layer_block_decode.mlp_launches = 0  # the launches of the whole layer (include_mlp)
