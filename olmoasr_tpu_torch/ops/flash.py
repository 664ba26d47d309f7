"""Online-softmax multi-head attention with segment ids, forward and backward.

Counterpart of ``olmoasr_tpu/ops/flash.py``: ``flash_mha`` and
``flash_self_attention``, whose kernel is JAX's stock Pallas TPU flash
attention (``jax.experimental.pallas.ops.tpu.flash_attention``) with its
custom VJP. The autograd function ``FlashMHA`` saves that kernel's residuals
(q, k, v, the ids, o and the per-row max ``m`` and sum ``l``) and its
backward recomputes p from them. Under ``torch.no_grad`` the forward runs
alone.

The arithmetic is the stock kernel's, not that of ``ops.train_attention``
(whose rows softmax over the whole key row). Per (batch, head), query row i
and key tiles of 64, in order:

  s    = fp32(q_i . k_j) * dh^-0.5        (q is not pre-scaled)
  s   += -0.7 * FLT_MAX  where q_ids[i] != kv_ids[j], or causal and j > i
  m'   = max(m, max_j s);  p = exp(s - m');  l' = sum_j p + exp(m - m') * l
  acc  = acc * (exp(m - m') * l / l') + (round(p) . V) / l'

with ``round`` to v's dtype (a no-op in fp32), the output acc in q's dtype.
The backward takes ``di = sum(o * do)`` from the rounded output, then
``p = exp(s - m) * (1 / l)``, ``dv = round(p)^T . do``, ``ds = (do . v^T -
di) * p * dh^-0.5``, ``dk = round(ds)^T . q`` and ``dq = round(ds) . k``.
Segment ids mask both sides: a query attends only the keys whose id equals
its own. Key tiles that lie wholly above the diagonal are skipped, as the
stock kernel's ``below_or_on_diag`` skips them. The port runs at the true
sequence lengths: the 128-multiple padding and its reserved pad id were
tiling devices of the TPU, and no row that ``flash_mha`` returns depends on
them. A row that every key masks (neither caller makes one) gets the stock
kernel's artefact, an average of v over the masked keys of its tiles; that
value is not pinned.

Dispatch: a CUDA tensor launches ``csrc/flash_attention.cu`` or raises (bf16
on the mma.sync core of ``csrc/attention_mma.cuh`` under its flash policy,
fp32 on CUDA-core tiles); a CPU tensor runs the plain versions, which step
through the same 64-key tiles and roundings.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from olmoasr_tpu_torch.ops import _build

MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)  # the stock DEFAULT_MASK_VALUE
TILE = 64  # keys per tile of the online softmax (the kernels' key tile)
HEAD_DIM = 64  # the kernels' head width (every OLMoASR/Whisper size)


def _heads(x: torch.Tensor, n_head: int) -> torch.Tensor:
    B, T, D = x.shape
    return x.reshape(B, T, n_head, D // n_head).transpose(1, 2).float()  # (B, H, T, dh)


def _merge(x: torch.Tensor, dtype) -> torch.Tensor:
    B, H, T, dh = x.shape
    return x.transpose(1, 2).reshape(B, T, H * dh).to(dtype)


def _scores(qh, kh, scale, rows, cols, causal, q_ids, kv_ids):
    """Scaled fp32 scores of query rows ``rows`` over keys ``cols`` with the
    additive mask, (B, H, len(rows), len(cols))."""
    s = (qh[:, :, rows] @ kh[:, :, cols].transpose(-1, -2)) * scale
    keep = None
    if q_ids is not None:
        keep = (q_ids[:, rows, None] == kv_ids[:, None, cols])[:, None]
    if causal:
        arange = lambda sl: torch.arange(sl.start, sl.stop, device=s.device)
        below = arange(cols)[None] <= arange(rows)[:, None]
        keep = below if keep is None else keep & below
    if keep is not None:
        s = s + torch.where(keep, 0.0, MASK_VALUE)
    return s


def flash_mha_fwd_plain(q, k, v, n_head: int, causal: bool = False,
                        q_ids: Optional[torch.Tensor] = None,
                        kv_ids: Optional[torch.Tensor] = None):
    """(o, m, l) of the forward (see the module docstring): o (B, Tq, D) in
    q's dtype, the fp32 row max m and row sum l (B, H, Tq)."""
    B, Tq, D = q.shape
    Tk, dh = k.shape[1], D // n_head
    scale = dh ** -0.5
    qh, kh, vh = _heads(q, n_head), _heads(k, n_head), _heads(v, n_head)
    m = torch.full((B, n_head, Tq), float("-inf"), device=q.device)
    l = torch.zeros((B, n_head, Tq), device=q.device)
    acc = torch.zeros((B, n_head, Tq, dh), device=q.device)
    for k0 in range(0, Tk, TILE):
        # with the causal mask, key tile k0 / TILE is seen by the query tiles
        # at or below the diagonal: rows from k0 on
        r0 = k0 if causal else 0
        if r0 >= Tq:
            break
        rows, cols = slice(r0, Tq), slice(k0, min(k0 + TILE, Tk))
        s = _scores(qh, kh, scale, rows, cols, causal, q_ids, kv_ids)
        m_prev, l_prev = m[:, :, rows], l[:, :, rows]
        m_next = torch.maximum(m_prev, s.amax(dim=-1))
        p = torch.exp(s - m_next[..., None])
        l_corr = torch.exp(m_prev - m_next) * l_prev
        l_next = p.sum(dim=-1) + l_corr
        inv = torch.where(l_next == 0.0, 1.0, 1.0 / l_next)
        pv = p.to(v.dtype).float() @ vh[:, :, cols]
        acc[:, :, rows] = acc[:, :, rows] * (l_corr * inv)[..., None] + pv * inv[..., None]
        m[:, :, rows], l[:, :, rows] = m_next, l_next
    return _merge(acc, q.dtype), m, l


def flash_mha_bwd_plain(q, k, v, o, m, l, do, n_head: int, causal: bool = False,
                        q_ids: Optional[torch.Tensor] = None,
                        kv_ids: Optional[torch.Tensor] = None):
    """(dq, dk, dv) from the forward's residuals (see the module docstring),
    in q's, k's and v's dtypes; ``do`` is rounded to q's dtype first."""
    B, Tq, D = q.shape
    Tk, dh = k.shape[1], D // n_head
    scale = dh ** -0.5
    do = do.to(q.dtype)
    qh, kh, vh, doh = (_heads(t, n_head) for t in (q, k, v, do))
    di = (_heads(o, n_head) * doh).sum(dim=-1, keepdim=True)
    dq, dk, dv = torch.empty_like(qh), torch.empty_like(kh), torch.empty_like(vh)
    rnd = lambda x: x.to(q.dtype).float()
    step = max(1, (1 << 27) // (n_head * Tq * Tk))  # bounds the (b, H, Tq, Tk) blocks
    for b0 in range(0, B, step):
        bs = slice(b0, min(B, b0 + step))
        s = _scores(qh[bs], kh[bs], scale, slice(0, Tq), slice(0, Tk), causal,
                    None if q_ids is None else q_ids[bs], None if kv_ids is None else kv_ids[bs])
        p = torch.exp(s - m[bs, ..., None]) * (1.0 / l[bs, ..., None])
        dv[bs] = rnd(p).transpose(-1, -2) @ doh[bs]
        ds = rnd((doh[bs] @ vh[bs].transpose(-1, -2) - di[bs]) * p * scale)
        dk[bs] = ds.transpose(-1, -2) @ qh[bs]
        dq[bs] = ds @ kh[bs]
    return _merge(dq, q.dtype), _merge(dk, k.dtype), _merge(dv, v.dtype)


def _check(what, q, k, v, n_head, q_ids, kv_ids, *extra):
    """Raise on what the kernels do not take."""
    B, Tq, D = q.shape
    Tk = k.shape[1]

    def need(cond, msg):
        if not cond:
            raise ValueError(f"{what}: {msg}")

    need(q.dtype in (torch.float32, torch.bfloat16), f"q is {q.dtype}")
    need(D == n_head * HEAD_DIM, f"the kernels take head width {HEAD_DIM}, got D={D}, H={n_head}")
    need(k.dim() == 3 and k.shape[0] == B and k.shape[2] == D, f"k {tuple(k.shape)} vs q {tuple(q.shape)}")
    need(v.shape == k.shape, f"v {tuple(v.shape)} vs k {tuple(k.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v), *extra):
        need(t.dtype == q.dtype and t.device == q.device, f"{name} is {t.dtype} on {t.device}")
        need(t.is_contiguous() and t.data_ptr() % 16 == 0, f"{name} must be contiguous, 16-byte aligned")
    for name, t, T in (("q_ids", q_ids, Tq), ("kv_ids", kv_ids, Tk)):
        if t is not None:
            need(tuple(t.shape) == (B, T) and t.dtype == torch.int32 and t.is_contiguous()
                 and t.device == q.device, f"{name} must be contiguous int32 ({B}, {T}) on "
                 f"{q.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def flash_mha_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_head: int,
                  causal: bool = False, q_ids: Optional[torch.Tensor] = None,
                  kv_ids: Optional[torch.Tensor] = None):
    """(o, m, l) of the forward; ids are int32 (B, Tq) and (B, Tk), both or
    neither.

    Replaces the forward ``pallas_call`` of the stock kernel that
    ``olmoasr_tpu/ops/flash.py::flash_mha`` calls. Bound on the card:
    tensor-core FLOPs (the encoder at small.en, B=64: 442 GFLOP of products
    a layer). bf16: one block per 128 query rows of one (b, h), 8 warps of
    16 rows, walks the key tiles with the scores, running max and sum, p and
    O in registers (mma.sync), K, V and the kv ids streamed through a
    cp.async ring (``csrc/attention_mma.cuh`` under its flash policy). fp32:
    CUDA-core tiles of 64 rows (``csrc/flash_attention.cu``).
    """
    if not q.is_cuda:
        return flash_mha_fwd_plain(q, k, v, n_head, causal, q_ids, kv_ids)
    what = "flash_mha_fwd"
    _check(what, q, k, v, n_head, q_ids, kv_ids)
    B, Tq, D = q.shape
    out = torch.empty_like(q)
    m = torch.empty((B, n_head, Tq), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    _build.check(_build.lib().olm_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(q_ids), _ptr(kv_ids), out.data_ptr(),
        m.data_ptr(), l.data_ptr(), B, n_head, Tq, k.shape[1], D, int(causal),
        HEAD_DIM ** -0.5, _build.dtype_code(q.dtype), _build.stream_ptr(q.device),
    ), what)
    flash_mha_fwd.launches += 1
    return out, m, l


flash_mha_fwd.launches = 0


def flash_mha_bwd(q, k, v, o, m, l, do, n_head: int, causal: bool = False,
                  q_ids: Optional[torch.Tensor] = None, kv_ids: Optional[torch.Tensor] = None):
    """(dq, dk, dv) of :func:`flash_mha_fwd` from its residuals.

    Replaces the stock kernel's two backward ``pallas_call``s (dk and dv,
    then dq). Bound on the card: tensor-core FLOPs, five products of
    2 Tq Tk dh per (b, h) (the encoder at small.en, B=16: 276 GFLOP a
    layer). ``di = sum(o * do)`` is a pass of its own before the two
    kernels (one launch, bound by the bytes of o and do), as the stock
    kernel takes it from XLA outside its own. The two launches are the
    training backward's (``csrc/attention_mma.cuh``) under the flash policy
    in bf16:
    per 64-query tile dq over the key tiles (S, dP, dQ: seven products in
    all, since dq computes S and dP again), then per 64-key tile dk and dv
    over the query tiles; no atomics, so the result does not depend on
    scheduling. ``do`` must be contiguous in q's dtype on the card; the
    plain version casts it.
    """
    if not q.is_cuda:
        return flash_mha_bwd_plain(q, k, v, o, m, l, do, n_head, causal, q_ids, kv_ids)
    what = "flash_mha_bwd"
    _check(what, q, k, v, n_head, q_ids, kv_ids, ("o", o), ("do", do))
    B, Tq, D = q.shape
    di = torch.empty((B, n_head, Tq), dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    _build.check(_build.lib().olm_flash_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), _ptr(q_ids),
        _ptr(kv_ids), m.data_ptr(), l.data_ptr(), di.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), B, n_head, Tq, k.shape[1], D, int(causal), HEAD_DIM ** -0.5,
        _build.dtype_code(q.dtype), _build.stream_ptr(q.device),
    ), what)
    flash_mha_bwd.launches += 1
    return dq, dk, dv


flash_mha_bwd.launches = 0


class FlashMHA(torch.autograd.Function):
    """Attention with the stock kernel's custom VJP: it saves the forward's
    residuals (q, k, v, the ids, o, m, l) and returns no gradient for the
    ids."""

    @staticmethod
    def forward(ctx, q, k, v, q_ids, kv_ids, n_head, causal):
        o, m, l = flash_mha_fwd(q, k, v, n_head, causal, q_ids, kv_ids)
        ctx.save_for_backward(q, k, v, q_ids, kv_ids, o, m, l)
        ctx.args = (n_head, causal)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, q_ids, kv_ids, o, m, l = ctx.saved_tensors
        n_head, causal = ctx.args
        do = g.to(q.dtype).contiguous()
        dq, dk, dv = flash_mha_bwd(q, k, v, o, m, l, do, n_head, causal, q_ids, kv_ids)
        return dq, dk, dv, None, None, None, None


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_head: int, *,
              causal: bool = False, q_ids: Optional[torch.Tensor] = None,
              kv_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multi-head attention on (B, T, D) tensors, differentiable (see the
    module docstring). Ids are (B, Tq) and (B, Tk) segment ids; a missing
    one is zeros, and with neither nothing is masked but the causal
    triangle. Runs through :class:`FlashMHA` when a gradient is wanted."""
    if q_ids is not None or kv_ids is not None:
        zeros = lambda x: torch.zeros(x.shape[:2], dtype=torch.int32, device=x.device)
        q_ids = zeros(q) if q_ids is None else q_ids.to(torch.int32).contiguous()
        kv_ids = zeros(k) if kv_ids is None else kv_ids.to(torch.int32).contiguous()
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashMHA.apply(q, k, v, q_ids, kv_ids, n_head, causal)
    return flash_mha_fwd(q, k, v, n_head, causal, q_ids, kv_ids)[0]


def flash_self_attention(q, k, v, n_head: int, *, causal: bool = False) -> torch.Tensor:
    """Self-attention through :func:`flash_mha` (the encoder's flash route)."""
    return flash_mha(q, k, v, n_head, causal=causal)
