"""The single-pass decode attention core (``csrc/decode_attention.cuh``,
``onepass``) at its cluster sizes, on the card: rows 8 (``cross_attend_decode``)
and 4 (``self_attend_decode`` over bf16 rings) at small.en's widths (D=768,
12 heads), at the greedy step's 64 rows and at 1 and 5 (one file, and a
small server batch: where a launch splits a (row, head) pair's keys over a
cluster); row 1's attention (``cross_block_decode``'s, q fp32, bf16 out)
with 5 query rows a cache row at 1, 16 and 32 windows (one file's beams,
the long-form slice's 16 files, beam search's 32 windows); row 4a
(``self_attend_decode`` over int8 rings) at 1, 5 and 64 rows.

Cases: first, the timer's floor (one elementwise launch on one element).
At 1 and 5 rows: row 8 in bf16 over a bf16 and an int8 cross cache of
T=1500, and row 4 over a bf16 ring (C=448) at offset 224. At 64 rows: the
same row 8 cases, and the bf16 one's bytes laid out so that each (row,
head)'s keys are contiguous (768 rows of one 64-wide head: what the
128-byte head slices at a 1536-byte key stride cost); row 4 at offsets 0
(the new key alone: the launch's fixed cost), 1, 41, 224 and 447, and at
80 rows (the long-form slice's 16 files x 5) at 224. Row 1's attention
over a bf16 and an int8 cache of T=1500 at kv_group 5. Row 4a at offset
224 of a C=225 ring. For each, the wrapper (the slices, blocks of a
cluster, its launch picks: ``0``) and, but for row 4a, the probe entries
``olm_cross_attend_probe`` / ``olm_cross_attention_probe`` /
``olm_self_attend_probe`` at the counts of SLICES, each held against the
plain version (two bf16 steps at the output's largest magnitude), each
timed from replays of a CUDA graph of one call with each replay queued
behind a spin on the card (``ms_spin``, as ``chip_smoke.py`` takes it),
beside the bound (bytes over 3.35 TB/s).

Run: ``python -m olmoasr_tpu_torch.perf.probe_decode_attention`` (the card's
name and power limit, then one JSON line per case).
"""

from __future__ import annotations

import json
import statistics
import subprocess

import torch

from olmoasr_tpu_torch.ops import _build
from olmoasr_tpu_torch.ops import attention as A

D, H = 768, 12
RUNS = 11
SPIN_CYCLES = 200_000  # as chip_smoke.py: longer than the host takes to queue a replay
SLICES = (0, 1, 2, 3, 4, 6, 8, 12, 16)
HBM_BYTES_PER_S = 3.35e12


def spin_ms(fn) -> float:
    """Median over RUNS replays of a graph of one call, each queued behind a
    spin on the card."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    times = []
    for _ in range(RUNS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _cross(q, k, v, ks, vs, heads: int, slices: int) -> torch.Tensor:
    """Row 8 through the wrapper (slices 0) or at `slices` blocks a cluster."""
    if slices == 0:
        return A.cross_attend_decode(q, k, v, ks, vs, n_head=heads)
    B, _, Dq = q.shape
    out = torch.empty_like(q)
    _build.check(_build.lib().olm_cross_attend_probe(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(ks), _ptr(vs), out.data_ptr(), B,
        k.shape[1], Dq, heads, _build.dtype_code(k.dtype), _build.dtype_code(q.dtype),
        A._q_scale(Dq // heads), slices, _build.stream_ptr(q.device)), "olm_cross_attend_probe")
    return out


def _cross_group(q, k, v, ks, vs, group: int, slices: int) -> torch.Tensor:
    """Row 1's attention (q (B, D) fp32, projected, unscaled; ``group``
    query rows a cache row) at the launch's slices (0) or at `slices`."""
    B, Dq = q.shape
    out = torch.empty((B, Dq), dtype=torch.bfloat16, device=q.device)
    lib = _build.lib()
    entry = lib.olm_cross_attention if slices == 0 else lib.olm_cross_attention_probe
    _build.check(entry(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ks.data_ptr(), vs.data_ptr(), out.data_ptr(),
        B, k.shape[1], Dq, H, group, _build.dtype_code(k.dtype), _build.dtype_code(out.dtype),
        A._q_scale(Dq // H), *(() if slices == 0 else (slices,)), _build.stream_ptr(q.device)),
        "olm_cross_attention")
    return out


def _cross_group_plain(q, k, v, ks, vs, group: int) -> torch.Tensor:
    Bc, T = k.shape[:2]
    qs = q.view(Bc, group, D) * A._q_scale(D // H)
    return A._cross_attend_plain(qs, k, v, ks, vs, H, A.quantizes_q(k.dtype, torch.bfloat16)) \
        .view(Bc * group, D).to(torch.bfloat16)


def _self(q, k_ring, v_ring, k_new, v_new, offset: int, layer: int, slices: int) -> torch.Tensor:
    """Row 4 through the wrapper (slices 0) or at `slices` blocks a cluster."""
    if slices == 0:
        return A.self_attend_decode(q, k_ring, v_ring, k_new, v_new, offset, layer, n_head=H)
    L, B, C, _ = k_ring.shape
    out = torch.empty((B, 1, D), dtype=q.dtype, device=q.device)
    _build.check(_build.lib().olm_self_attend_probe(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), q.stride(0), k_ring.data_ptr(),
        v_ring.data_ptr(), out.data_ptr(), L, layer, B, C, offset, D, H,
        _build.dtype_code(q.dtype), A._q_scale(D // H), slices, _build.stream_ptr(q.device)),
        "olm_self_attend_probe")
    return out


def _cases(gen):
    """name -> (launch(slices), plain(), bytes moved, the slices probed)."""
    from olmoasr_tpu_torch.models.whisper import _quantize_rows

    out = {}

    def cross(B, contiguous_heads=False):
        q = torch.randn(B, 1, D, generator=gen).to("cuda", torch.bfloat16)
        kv = [torch.randn(B, 1500, D, generator=gen).cuda() for _ in range(2)]
        bf = [t.to(torch.bfloat16) for t in kv]
        (k8, ks), (v8, vs) = (_quantize_rows(t) for t in kv)
        # (row, head) pairs as rows of one head: (B * H, T, 64), each contiguous
        per_head = lambda t: t.view(B, -1, H, D // H).transpose(1, 2).reshape(B * H, -1, D // H)
        cases = [(f"cross bf16 over bf16, {B} rows, T=1500", (q, *bf, None, None), H),
                 (f"cross bf16 over int8, {B} rows, T=1500",
                  (q, k8, v8, ks, vs[:, None].contiguous()), H)]
        if contiguous_heads:
            cases.append((f"cross bf16 over bf16, {B} rows, T=1500, each head's keys contiguous",
                          (per_head(q), *map(per_head, bf), None, None), 1))
        for name, args, heads in cases:
            out[name] = (lambda s, a=args, h=heads: _cross(*a, h, s),
                         lambda a=args, h=heads: A.cross_attend_decode_plain(*a, n_head=h),
                         _nbytes(*args) + _nbytes(q), SLICES)  # the output: q's bytes

    def self_(B, offsets, C=448):
        qkv = torch.randn(B, 1, 3 * D, generator=gen).to("cuda", torch.bfloat16)
        views = (qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:])
        rings = [torch.randn(1, B, C, D, generator=gen).to("cuda", torch.bfloat16)
                 for _ in range(2)]
        for offset in offsets:
            args = (views[0], *rings, *views[1:], offset, 0)
            out[f"self bf16 ring, {B} rows, offset {offset}"] = (
                lambda s, a=args: _self(*a, s),
                lambda a=args: A.self_attend_decode_plain(*a, n_head=H),
                2 * B * offset * D * 2 + 4 * B * D * 2, SLICES)

    def cross_group(windows, group=5):
        q = torch.randn(windows * group, D, generator=gen).cuda()
        kv = [torch.randn(windows, 1500, D, generator=gen).cuda() for _ in range(2)]
        ones = torch.ones(windows, 1, 1500, device="cuda")
        (k8, ks), (v8, vs) = (_quantize_rows(t) for t in kv)
        out_bytes = windows * group * D * 2
        for kind, args in (("bf16", (q, *[t.to(torch.bfloat16) for t in kv], ones, ones)),
                           ("int8", (q, k8, v8, ks[:, None].contiguous(),
                                     vs[:, None].contiguous()))):
            moved = _nbytes(*args[:3]) + out_bytes + (_nbytes(*args[3:]) if kind == "int8" else 0)
            out[f"cross block attention over {kind}, {windows * group} rows over {windows}, "
                f"T=1500"] = (lambda s, a=args: _cross_group(*a, group, s),
                              lambda a=args: _cross_group_plain(*a, group), moved, SLICES)

    def self_q8(B, offset=224, C=225):
        qkv = torch.randn(B, 1, 3 * D, generator=gen).to("cuda", torch.bfloat16)
        (k8, ks), (v8, vs) = (_quantize_rows(torch.randn(1, B, C, D, generator=gen).cuda())
                              for _ in range(2))
        args = (qkv[..., :D], k8, v8, qkv[..., D:2 * D], qkv[..., 2 * D:], offset, 0)
        kw = dict(n_head=H, k_scale=ks[:, :, None].contiguous(),
                  v_scale=vs[:, :, None].contiguous())
        out[f"self bf16 over int8 rings, {B} rows, offset {offset}"] = (
            lambda s, a=args: A.self_attend_decode(*a, **kw),
            lambda a=args: A.self_attend_decode_plain(*a, **kw),
            2 * B * offset * (D + 4) + 4 * B * D * 2, (0,))

    for B in (1, 5):
        cross(B)
        self_(B, (224,))
    cross(64, contiguous_heads=True)
    self_(64, (0, 1, 41, 224, 447))
    # the long-form slice's 16 files x 5 rows: more (row, head) pairs than
    # the card holds blocks at once
    self_(80, (224,), C=225)
    for windows in (1, 16, 32):
        cross_group(windows)
    for B in (1, 5, 64):
        self_q8(B)
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("probe_decode_attention: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    one = torch.zeros(1, device="cuda")
    print(json.dumps({"case": "the timer's floor: one elementwise launch on one element",
                      "ms_spin": spin_ms(lambda: one.add_(1.0))}))
    bad = []
    for name, (launch, plain, moved, slices) in _cases(torch.Generator().manual_seed(0)).items():
        want = plain()
        tol = 2.0 ** -6 * float(want.float().abs().max())
        row = {"case": name, "bound_ms": 1e3 * moved / HBM_BYTES_PER_S, "slices": {}}
        for s in slices:
            err = float((launch(s).float() - want.float()).abs().max())
            row["slices"][s] = {"ms_spin": spin_ms(lambda: launch(s)), "max_abs_err": err}
            if not err <= tol:
                bad.append(f"{name}, slices {s}: {err} > {tol}")
        print(json.dumps(row))
    if bad:
        raise SystemExit(f"probe_decode_attention: the kernel disagrees with the plain version: {bad}")


if __name__ == "__main__":
    main()
