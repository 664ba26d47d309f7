"""Shared pieces of the H100 probes of the training attention (PERF.md §6
rows 3 and 9): the shape, the kernel wrappers with their launch counts, the
plain versions, the timing and the report.

The probes are the port of the TPU timing probes ``perf/probe_pack.py``,
``perf/probe_pipe.py`` and ``perf/probe_bwd.py``. They keep those probes'
shape (medium.en: B=16, T=1500, D=1024, 16 heads of 64), their variant names
and their useful-FLOP counts (2 products in the forward, 5 in the backward,
1 for the score product alone). Each variant is a template instantiation of
the core in ``csrc/attention_mma.cuh`` (``csrc/attention_probes.cu``). Every
wrapper launches its kernel on a CUDA tensor and runs its plain version on a
CPU tensor, as the production wrappers do. A probe is timed from replays of
a CUDA graph of one call; the output of the graph's last replay is held
against the plain version, so checking costs no launch.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from olmoasr_tpu_torch.ops import _build
from olmoasr_tpu_torch.ops import train_attention as ta

B, T, D, H = 16, 1500, 1024, 16  # medium.en at the training micro batch
DH = 64
RUNS = 11  # timed replays (odd: the median is one run)
SBS = (64, 128)  # query-tile heights the forward probes take

# variant -> code of csrc/attention_probes.cu (olm_probe_fwd)
FWD_CODES = {
    "seq64": 0, "seq128": 1, "pad64": 2, "pad128": 3, "pack64": 4, "pack128": 5,
    "depth1_64": 6, "depth1_128": 7,
}
# probe_pipe's ablate at SB=128: the JAX probe's drop sets, in its order
# (the production forward already takes exp2, so "exp2" is the production
# kernel), then "expf", the accurate exp in its place
ABLATE = (
    (frozenset(), 1), (frozenset({"bias"}), 8), (frozenset({"max"}), 9),
    (frozenset({"exp"}), 10), (frozenset({"sum"}), 11), (frozenset({"div"}), 12),
    (frozenset({"bias", "max", "exp", "sum", "div"}), 13), (frozenset({"bf16exp"}), 14),
    (frozenset({"exp2"}), 1), (frozenset({"expf"}), 15),
)
SCORE_CODES = {(64, 64): 0, (64, 128): 1, (128, 64): 2, (128, 128): 3}  # (d, SB) -> code
BWD_CODES = {"bq64": 0, "bq128": 1, "row64": 2}


def useful_flops(products: int, n: int = B * H, t: int = T, dh: int = DH) -> int:
    """The products' FLOPs at head width 64, as the JAX probes count them:
    2 * products * N * T^2 * dh."""
    return 2 * products * n * t * t * dh


def sb_of(variant: str, prefix: str) -> int:
    sb = int(variant[len(prefix):])
    if sb not in SBS:
        raise ValueError(f"{variant}: the H100 probes take query tiles {SBS}, not {sb}")
    return sb


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _heads(x: torch.Tensor, n_head: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.view(b, t, n_head, d // n_head).transpose(1, 2)


def attn_plain(q, k, v, n_head: int, scale: float, bias: Optional[torch.Tensor] = None,
               drop: Iterable[str] = ()) -> torch.Tensor:
    """The forward the probe kernels compute, on (B, T, n_head * w) tensors,
    with ``drop`` naming the stages an ablation removes (``bias``, ``max``,
    ``exp``, ``sum``, ``div``; ``bf16exp``, ``exp2`` and ``expf`` name the
    exp, the last two both torch's exp here).
    With nothing dropped it is ``train_attention_fwd_plain``'s function: q
    pre-scaled in q's type, scores in fp32, p = exp(s - max) rounded to bf16
    before P.V, then divided by the fp32 row sum."""
    drop = frozenset(drop)
    bsz, tq, width = q.shape
    qh = (_heads(q, n_head) * scale).to(q.dtype).float()
    kh, vh = _heads(k, n_head).float(), _heads(v, n_head).float()
    out = torch.empty(qh.shape[:-1] + (vh.shape[-1],), dtype=torch.float32, device=q.device)
    step = max(1, (1 << 27) // (n_head * tq * k.shape[1]))
    for b0 in range(0, bsz, step):
        b1 = min(bsz, b0 + step)
        s = qh[b0:b1] @ kh[b0:b1].transpose(-1, -2)
        if bias is not None and "bias" not in drop:
            s = s + (bias if bias.shape[0] == 1 else bias[b0:b1])[:, None, None, :]
        if "max" not in drop:
            s = s - s.amax(dim=-1, keepdim=True)
        if "exp" in drop:
            p = s
        elif "bf16exp" in drop:
            p = torch.exp(s.to(torch.bfloat16)).float()
        else:
            p = torch.exp(s)
        o = p.to(torch.bfloat16).float() @ vh[b0:b1]
        if "sum" not in drop and "div" not in drop:
            o = o / p.sum(dim=-1, keepdim=True)
        out[b0:b1] = o
    return out.transpose(1, 2).reshape(bsz, tq, width).to(q.dtype)


def scores_plain(q, k, n_head: int, scale: float) -> torch.Tensor:
    """The score probe's function: (B, Tq, n_head * 64) fp32, for each query
    row and head the sum over the 64-key tiles of the tile's first 64 score
    columns (keys past the end score 0; only the first 64 columns of a
    wider, zero-padded head count)."""
    qh = (_heads(q, n_head) * scale).to(q.dtype).float()
    kh = _heads(k, n_head).float()
    s = qh @ kh.transpose(-1, -2)  # (B, n_head, Tq, Tk)
    tk = s.shape[-1]
    s = torch.nn.functional.pad(s, (0, -tk % 64))
    folded = s.view(*s.shape[:-1], -1, 64).sum(dim=-2)
    return folded.transpose(1, 2).reshape(q.shape[0], q.shape[1], n_head * 64)


def pad_heads(x: torch.Tensor, n_head: int, width: int) -> torch.Tensor:
    """(B, T, n_head * 64) -> (B, T, n_head * width), each head zero-padded."""
    b, t, _ = x.shape
    return torch.nn.functional.pad(x.view(b, t, n_head, DH), (0, width - DH)).reshape(
        b, t, n_head * width).contiguous()


def unpad_heads(x: torch.Tensor, n_head: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.view(b, t, n_head, d // n_head)[..., :DH].reshape(b, t, n_head * DH)


# ---------------------------------------------------------------------------
# kernel wrappers: a count each, of the JAX probe function they stand for
# ---------------------------------------------------------------------------


def _fwd(q, k, v, n_head: int, code: int, bias: Optional[torch.Tensor], drop=()):
    scale = ta._scale(DH, q.dtype)
    if not q.is_cuda:
        return attn_plain(q, k, v, n_head, scale, bias, drop)
    if q.dtype != torch.bfloat16:
        raise ValueError(f"the forward probes take bfloat16, not {q.dtype}")
    out = torch.empty_like(q)
    _build.check(_build.lib().olm_probe_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None if bias is None else bias.data_ptr(),
        0 if bias is None or bias.shape[0] == 1 else bias.shape[1], out.data_ptr(),
        q.shape[0], n_head, q.shape[1], k.shape[1], q.shape[2], 0, scale, code,
        _build.stream_ptr(q.device)), "olm_probe_fwd")
    return out


def probe_seq(q, k, v, n_head: int, sb: int, width: int = DH):
    """probe_pack's seq<SB> (width 64) and pad<SB> (q, k, v zero-padded to
    head width 128 outside the kernel): the forward at query tile sb."""
    if width == DH:
        out = _fwd(q, k, v, n_head, FWD_CODES[f"seq{sb}"], None)
    else:
        out = unpad_heads(_fwd(*(pad_heads(x, n_head, width) for x in (q, k, v)), n_head,
                               FWD_CODES[f"pad{sb}"], None), n_head)
    probe_seq.launches += q.is_cuda
    return out


def probe_pack(q, k, v, n_head: int, sb: int):
    """probe_pack's pack<SB>: two neighbouring heads in one block, their
    [qA | qB] rows 128 wide, both heads' K and V in one ring."""
    if n_head % 2:
        raise ValueError("pack takes an even number of heads")
    out = _fwd(q, k, v, n_head, FWD_CODES[f"pack{sb}"], None)
    probe_pack.launches += q.is_cuda
    return out


def probe_scores(q, k, n_head: int, sb: int, width: int = DH):
    """probe_pack's rawd<d>x<SB>: the score product alone (see
    :func:`scores_plain`), at head width 64 or zero-padded to 128."""
    scale = ta._scale(DH, q.dtype)
    if not q.is_cuda:
        return scores_plain(q, k, n_head, scale)
    qp, kp = (x if width == DH else pad_heads(x, n_head, width) for x in (q, k))
    out = torch.empty((q.shape[0], q.shape[1], n_head * DH), dtype=torch.float32,
                      device=q.device)
    _build.check(_build.lib().olm_probe_scores(
        qp.data_ptr(), kp.data_ptr(), out.data_ptr(), q.shape[0], n_head, q.shape[1],
        k.shape[1], qp.shape[2], scale, SCORE_CODES[width, sb], _build.stream_ptr(q.device)),
        "olm_probe_scores")
    probe_scores.launches += 1
    return out


def probe_pipe(q, k, v, n_head: int, sb: int, depth: int, bias=None):
    """probe_pipe's seq<SB> (a ring of depth 1: load, then compute) and
    pipe<SB> (the production depth, 2)."""
    code = FWD_CODES[f"depth1_{sb}"] if depth == 1 else FWD_CODES[f"seq{sb}"]
    out = _fwd(q, k, v, n_head, code, bias)
    probe_pipe.launches += q.is_cuda
    return out


def probe_ablate(q, k, v, n_head: int, drop: frozenset, bias=None):
    """probe_pipe's ablate: the forward at query tile 128 with the stages in
    ``drop`` removed (one of :data:`ABLATE`'s sets)."""
    code = dict(ABLATE)[frozenset(drop)]
    out = _fwd(q, k, v, n_head, code, bias, drop)
    probe_ablate.launches += q.is_cuda
    return out


def _bwd(q, k, v, do, n_head: int, code: int):
    if not q.is_cuda:
        return ta.train_attention_bwd_plain(q, k, v, do, n_head)
    if q.dtype != torch.bfloat16:
        raise ValueError(f"the backward probes take bfloat16, not {q.dtype}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    stats = torch.empty((3, q.shape[0], n_head, q.shape[1]), dtype=torch.float32,
                        device=q.device)
    _build.check(_build.lib().olm_probe_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), None, 0, dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), stats.data_ptr(), q.shape[0], n_head, q.shape[1],
        k.shape[1], q.shape[2], 0, ta._scale(DH, q.dtype), code, _build.stream_ptr(q.device)),
        "olm_probe_bwd")
    return dq, dk, dv


def probe_bwd_tile(q, k, v, do, n_head: int, bq: int):
    """probe_bwd's bq<N>: the production backward with an N-row query tile
    in its dq launch."""
    if f"bq{bq}" not in BWD_CODES:
        raise ValueError(f"bq{bq}: the H100 backward takes query tiles 64 and 128")
    out = _bwd(q, k, v, do, n_head, BWD_CODES[f"bq{bq}"])
    probe_bwd_tile.launches += q.is_cuda
    return out


def probe_row(q, k, v, do, n_head: int, sb: int):
    """probe_bwd's row<SB>: the whole-row backward, one cluster of 8 blocks
    per (b, h), five products (no bias, no causal mask; Tk <= 1536)."""
    if sb != 64:
        raise ValueError(f"row{sb}: the cluster backward takes 64-row query tiles")
    out = _bwd(q, k, v, do, n_head, BWD_CODES["row64"])
    probe_row.launches += q.is_cuda
    return out


WRAPPERS = (probe_seq, probe_pack, probe_scores, probe_pipe, probe_ablate, probe_bwd_tile,
            probe_row)
for _w in WRAPPERS:
    _w.launches = 0


# ---------------------------------------------------------------------------
# inputs, timing, report
# ---------------------------------------------------------------------------


def inputs(n: int, shape=(B, T, D), seed: int = 0, device="cuda") -> list:
    """n bf16 tensors of standard normals, made from the seed with numpy as
    the JAX probes make theirs."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(
        device, torch.bfloat16) for _ in range(n)]


def timed(fn: Callable, runs: int = RUNS):
    """(median ms of one call over ``runs`` replays of a CUDA graph of it,
    the output of the last replay)."""
    fn()  # warm-up: builds, one-time attributes
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    torch.cuda.synchronize()
    del graph
    return statistics.median(times), out


def bf16_tol(ref: torch.Tensor) -> float:
    """Two bf16 steps at the reference's largest magnitude (chip_smoke's
    tolerance for rows 3 and 9)."""
    return 2.0 ** -6 * float(ref.float().abs().max())


def measure(name: str, fn: Callable, flops: int, want=None, tol_of=bf16_tol,
            runs: int = RUNS) -> dict:
    """Time one variant and hold its output (or outputs) against ``want``."""
    ms, got = timed(fn, runs)
    row = {"variant": name, "ms": ms, "tflops": flops / ms / 1e9, "max_abs_err": None,
           "tol": None, "ok": True}
    if want is not None:
        pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
        row["max_abs_err"] = max(float((g.float() - w.float()).abs().max()) for g, w in pairs)
        row["tol"] = min(tol_of(w) for _, w in pairs)
        row["ok"] = all(bool(torch.isfinite(g).all()) for g, _ in pairs) and (
            row["max_abs_err"] <= row["tol"])
    err = "" if want is None else f"  maxerr {row['max_abs_err']:.3e} (tol {row['tol']:.3e})"
    print(f"{name:24s} {ms:8.4f} ms {row['tflops']:7.1f} TF/s-useful{err}", flush=True)
    return row


def need_card() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("the probes time the card: no CUDA device")
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def report(probe: str, card: str, rows: list) -> None:
    print(json.dumps({"probe": probe, "card": card, "shape": [B, T, D, H], "results": rows}))
    if not all(r["ok"] for r in rows):
        bad = [r["variant"] for r in rows if not r["ok"]]
        print(f"{probe}: variants disagree with their plain versions: {bad}", file=sys.stderr)
        raise SystemExit(1)

