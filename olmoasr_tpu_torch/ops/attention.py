"""Decode-step kernels: every sub-block of an S=1 decoder layer.

Counterpart of ``olmoasr_tpu/ops/attention.py`` for the self sub-block
(``ln_matmul``, ``self_attend_decode``, ``matmul_residual``), the cross
sub-block (``cross_block_decode``: non-transposed keys, ``kv_group`` query
rows per cache row) and ``mlp_block``. Each function takes ONE layer's
tensors in torch's weight layout (``(out, in)``); activations keep the JAX
layout: ``x`` is ``(B, 1, D)``, the cross cache ``(B, T, D)`` with
per-position scales ``(B, 1, T)`` (ones when unquantized), the self rings the
stacked ``(L, B, C, D)`` tensors indexed by layer.

Dispatch: a CUDA tensor launches the hand-written kernel (``csrc/linear.cu``,
``csrc/cross_attention.cu``, ``csrc/self_attention.cu``) or raises; a CPU
tensor runs the plain PyTorch twin below. There is no fallback from one to
the other. Each wrapper counts its launches in ``<function>.launches``.

Precision contract, shared by kernel and twin: LayerNorm in fp32 (eps 1e-5),
operands of every product rounded to the weight type, products accumulated
in fp32, bias/GELU/residual epilogues in fp32, one rounding at the store.
With fp32 weights this is the JAX fp32 path exactly.
"""

from __future__ import annotations

import functools

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
        # the bf16 linear kernel reads rows in 16-byte chunks
        _require(t.data_ptr() % 16 == 0, what, f"{name} must be 16-byte aligned")


def _layer_norm(lib, stream, x, g, b):
    """Launch the row LayerNorm: (rows, D) in x's dtype."""
    D = x.shape[-1]
    rows = x.numel() // D
    h = torch.empty((rows, D), dtype=x.dtype, device=x.device)
    _build.check(lib.olm_layer_norm(
        x.data_ptr(), g.data_ptr(), b.data_ptr(), h.data_ptr(), rows, D, LN_EPS,
        _build.dtype_code(x.dtype), stream,
    ), "layer norm")
    return h


def _linear(lib, stream, a, w, bias, out, resid=None, gelu=False):
    """Launch ``out = epilogue(a @ w.T)`` with K split over enough blocks to
    put about two on every SM (csrc/linear.cu)."""
    M, K = a.shape
    N = w.shape[0]
    blocks = -(-N // 32) * -(-M // 32)
    splits = max(1, min(K // 64, -(-2 * _sm_count(a.device) // blocks)))
    ws = torch.empty((splits, M, N), dtype=torch.float32, device=a.device) if splits > 1 else None
    _build.check(lib.olm_linear(
        a.data_ptr(), w.data_ptr(), bias.data_ptr(),
        None if resid is None else resid.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), M, N, K, splits,
        _build.dtype_code(w.dtype), int(out.dtype == torch.float32), int(gelu), stream,
    ), "linear")


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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
    cores' rate. The kernel (``csrc/linear.cu``) is a LayerNorm launch, then
    the skinny linear twice (GELU epilogue, then bias + residual epilogue):
    each streams its weight once per 32-column tile with every batch row in
    the tile, K split across blocks so that every SM has work.
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
    h = _layer_norm(lib, stream, x, ln_g, ln_b)
    u = torch.empty((h.shape[0], Fd), dtype=x.dtype, device=x.device)
    _linear(lib, stream, h, w1, b1, u, gelu=True)
    out = torch.empty_like(x)
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
    elements per layer (small.en bf16: 3.5 MB) against 6*B*D*D FLOPs. The
    kernel (``csrc/linear.cu``) is the row LayerNorm launch, then the split-K
    skinny linear with N = 3D and a bias epilogue.
    """
    if not x.is_cuda:
        return ln_matmul_plain(x, ln_g, ln_b, w, b)
    what = "ln_matmul"
    D, N = x.shape[-1], w.shape[0]
    _check_linear(what, x, w, b, N, D)
    _require(tuple(ln_g.shape) == (D,) and tuple(ln_b.shape) == (D,), what, "LN shapes")
    _check_operands(what, x.dtype, x.device, x=x, ln_g=ln_g, ln_b=ln_b, w=w, b=b)
    lib, stream = _build.lib(), _build.stream_ptr(x.device)
    h = _layer_norm(lib, stream, x, ln_g, ln_b)
    out = torch.empty((x.shape[0], 1, N), dtype=x.dtype, device=x.device)
    _linear(lib, stream, h, w, b, out.view(-1, N))
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
    elements per layer (small.en bf16: 1.2 MB). The kernel is
    ``csrc/linear.cu``'s skinny linear with the bias-and-residual epilogue.
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
    _linear(lib, stream, attn.view(-1, D), w, b, out.view(-1, D), resid=x.view(-1, D))
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


def _partials(B: int, n_head: int, nchunks: int, dh: int, device):
    """Scratch of the split-position attention: per (row, head, chunk) max,
    sum and weighted values, fp32."""
    f32 = dict(dtype=torch.float32, device=device)
    n = B * n_head * nchunks
    return torch.empty((n,), **f32), torch.empty((n,), **f32), torch.empty((n * dh,), **f32)


def cross_block_decode_plain(
    x, ln_g, ln_b, wq, bq, wo, bo, ck, cv, ck_scale, cv_scale, n_head: int,
    kv_group: int = 1,
) -> torch.Tensor:
    """Cross sub-block for any number S of query rows (the prefill uses S>1).
    With ``kv_group`` G, the G query rows of one cache row fold into its
    query sequence: cross attention is position-independent per query."""
    if kv_group > 1:
        Bq, S, D = x.shape
        out = cross_block_decode_plain(
            x.reshape(Bq // kv_group, kv_group * S, D), ln_g, ln_b, wq, bq, wo, bo,
            ck, cv, ck_scale, cv_scale, n_head,
        )
        return out.reshape(Bq, S, D)
    B, S, D = x.shape
    T = ck.shape[1]
    dh = D // n_head
    h = _ln_f32(x, ln_g, ln_b).to(wq.dtype)
    q = _linear_f32(h, wq, bq) * _q_scale(dh)  # (B, S, D) fp32
    k = ck.float().view(B, T, n_head, dh)
    v = cv.float().view(B, T, n_head, dh)
    logits = torch.einsum("bshd,bthd->bhst", q.view(B, S, n_head, dh), k)
    logits = logits * ck_scale.float().reshape(B, 1, 1, T)
    w = torch.softmax(logits, dim=-1) * cv_scale.float().reshape(B, 1, 1, T)
    attn = torch.einsum("bhst,bthd->bshd", w, v).reshape(B, S, D).to(wo.dtype)
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
    Launches: the LayerNorm and the q projection (``csrc/linear.cu``, fp32
    q); the split-T attention and its combine (``csrc/cross_attention.cu``:
    one block per 128-key chunk, head and query row, 16-byte loads, so the
    cache read spreads over every SM; a group's rows are grid neighbours and
    share the read through L2); the output projection with bias + residual
    (``csrc/linear.cu``). q is not quantized (see the kernel source).
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
    h = _layer_norm(lib, stream, x, ln_g, ln_b)
    q = torch.empty((B, D), dtype=torch.float32, device=x.device)
    _linear(lib, stream, h, wq, bq, q)
    m_part, l_part, acc_part = _partials(
        B, n_head, lib.olm_decode_attention_chunks(T), dh, x.device)
    attn = torch.empty((B, D), dtype=x.dtype, device=x.device)
    _build.check(lib.olm_cross_attention(
        q.data_ptr(), ck.data_ptr(), cv.data_ptr(), ck_scale.data_ptr(),
        cv_scale.data_ptr(), m_part.data_ptr(), l_part.data_ptr(), acc_part.data_ptr(),
        attn.data_ptr(), B, T, D, n_head, kv_group, _build.dtype_code(ck.dtype),
        _build.dtype_code(x.dtype), _q_scale(dh), stream,
    ), "cross_block_decode (attention)")
    out = torch.empty_like(x)
    _linear(lib, stream, attn, wo, bo, out.view(B, D), resid=x.view(B, D))
    cross_block_decode.launches += 1
    return out


cross_block_decode.launches = 0


# ---------------------------------------------------------------------------
# self_attend_decode
# ---------------------------------------------------------------------------


def self_attend_decode_plain(
    q, k_ring, v_ring, k_new, v_new, offset: int, layer_idx: int, *, n_head: int
) -> torch.Tensor:
    """Single-query attention over ring positions < offset of one layer plus
    this step's own key and value, fp32 throughout, one rounding at the end."""
    B, _, D = q.shape
    dh = D // n_head
    heads = lambda t: t.float().reshape(B, -1, n_head, dh)
    qh = heads(q)[:, 0] * _q_scale(dh)  # (B, H, dh)
    k, v = heads(k_ring[layer_idx, :, :offset]), heads(v_ring[layer_idx, :, :offset])
    logits = torch.cat([
        torch.einsum("bhd,bthd->bht", qh, k),
        (qh * heads(k_new)[:, 0]).sum(-1, keepdim=True),
    ], dim=-1)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bht,bthd->bhd", w[..., :offset], v) + w[..., offset:] * heads(v_new)[:, 0]
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
) -> torch.Tensor:
    """Decode-step self attention of layer ``layer_idx`` over the read-only
    rings, the new key always visible; (B, 1, D) in q's dtype.

    Replaces ``olmoasr_tpu/ops/attention.py::self_attend_decode``
    (``_self_decode_kernel``, body ``_self_decode_body``; bf16 or fp32 rings,
    no ancestry). Bound on the card: the ring read, 2*B*offset*D elements per
    layer and step (small.en, B=64, offset 224, bf16: 44 MB). The kernel
    (``csrc/self_attention.cu``) is the cross kernel's split-position pass
    over the ring (row stride C, the layer chosen by pointer), and a combine
    launch that folds in the new key and value. The caller writes k_new and
    v_new into the rings afterwards.
    """
    if not q.is_cuda:
        return self_attend_decode_plain(
            q, k_ring, v_ring, k_new, v_new, offset, layer_idx, n_head=n_head
        )
    what = "self_attend_decode"
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
    _check_operands(what, q.dtype, q.device, k_ring=k_ring, v_ring=v_ring)
    stride = q.stride(0)
    for name, t in (("q", q), ("k_new", k_new), ("v_new", v_new)):
        _require(t.shape == q.shape and t.dtype == q.dtype and t.device == q.device, what,
                 f"{name} is {t.dtype} {tuple(t.shape)} on {t.device}")
        _require(t.stride(2) == 1 and (B == 1 or t.stride(0) == stride), what,
                 f"{name}: rows must be contiguous and strided as q's")
        _require(t.data_ptr() % 16 == 0 and stride * t.element_size() % 16 == 0, what,
                 f"{name} rows must be 16-byte aligned")
    lib, stream = _build.lib(), _build.stream_ptr(q.device)
    m_part, l_part, acc_part = _partials(
        B, n_head, lib.olm_decode_attention_chunks(offset), dh, q.device)
    out = torch.empty((B, 1, D), dtype=q.dtype, device=q.device)
    _build.check(lib.olm_self_attention(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), stride, k_ring.data_ptr(),
        v_ring.data_ptr(), m_part.data_ptr(), l_part.data_ptr(), acc_part.data_ptr(),
        out.data_ptr(), L, layer_idx, B, C, offset, D, n_head, _build.dtype_code(q.dtype),
        _q_scale(dh), stream,
    ), what)
    self_attend_decode.launches += 1
    return out


self_attend_decode.launches = 0
