"""Where the time of the decode step's skinny projections goes, on the card
(PERF.md §6 rows 1, 2, 5 and 6): ``csrc/skinny_proj.cu`` at small.en's
widths (D=768, F=3072) and the decode step's rows (64 greedy, 80 for 16
files x 5 on the long-form slice, 160 for 32 windows x 5 beams).

For each row count, from replays of CUDA graphs; each time is given twice:
``ms``, a graph of one call as ``chip_smoke.timed_ms`` takes it, and
``ms_b2b``, per call in a graph of 20 calls back to back.

- ``proj``: each launch at the kernel's own cluster size and row groups,
  alone and waiting for the launch before in full (``pdl`` off): the
  LayerNorm, W1, W2, Wo, the fused QKV of ``ln_matmul`` and the cross q
  projection Wq of ``cross_block_decode`` (stored fp32); then
  ``mlp_block``'s three launches with and without the programmatic
  dependence, ``matmul_residual`` and ``ln_matmul``;
- ``sweep``: every product (``pdl`` off) at clusters of 1-8 blocks and the
  rows in one or two groups of blocks;
- ``ln_matmul pdl``: ``ln_matmul``'s two launches with QKV at the kernel's
  choice and at the two choices its rule weighs (6 slices in one row
  group, 3 in two), each with and without the programmatic dependence on
  the LayerNorm;
- ``programmatic_edges``: the edges of a graph capture of ``mlp_block``,
  ``matmul_residual`` and ``ln_matmul`` that keep the programmatic
  dependence (4: W1 on the LayerNorm, W2 on W1, Wo on W2, QKV on its
  LayerNorm);
- ``trace``: one traced launch of each product at the kernel's choice: over
  the blocks, the longest and the mean time from the first block's start to
  the block's start, then each step to the next mark (STEPS: W's first
  stages issued, A's first stages issued, the first stage in, the stream
  done, the partials in, the stores issued); and the span from the first
  start to the last end.

Each launch is held against the plain version (two bf16 steps at the
output's largest magnitude; for the fp32 store 1e-4 of it, at least 1e-4).
The times of the split-K bf16 launches these replaced are in PERF.md §6;
``chip_smoke.py --ab`` compares against a tree that has them. Run: ``python -m olmoasr_tpu_torch.perf.probe_proj`` (one JSON line
per row count).
"""

from __future__ import annotations

import json
import statistics
import subprocess

import torch

from olmoasr_tpu_torch.ops import _build
from olmoasr_tpu_torch.ops import attention as A

D, F = 768, 3072
ROWS = (64, 80, 160)
RUNS = 11
CLUSTERS = (1, 2, 3, 4, 6, 8)
ROW_GROUPS = (1, 2)
LNMM_CHOICES = ((0, 0), (6, 1), (3, 2))  # QKV's (cluster size, row groups); 0: the kernel's
CALLS = 20  # calls in one graph for the back-to-back time
# the marks of csrc/skinny_proj.cu, each named by the step that ends at it
STEPS = ("start", "w issued", "a issued", "first in", "stream", "partials", "epilogue")


def launch(a, w, bias, resid=None, gelu=False, out_f32=False, cs=0, rg=0, pdl=True,
           trace=None):
    """One launch of csrc/skinny_proj.cu through its probe entry
    (``olm_proj_probe``): ``cs`` and ``rg`` name the cluster size and the
    groups of blocks the rows are spread over (0: the kernel's choice, as
    ``ops.attention._proj`` launches it); ``pdl=False`` makes the launch
    wait for the one before in full; ``trace``, an int64 tensor, takes the
    blocks' timer marks."""
    M, K = a.shape
    out = torch.empty((M, w.shape[0]), dtype=torch.float32 if out_f32 else a.dtype,
                      device=a.device)
    _build.check(_build.lib().olm_proj_probe(
        a.data_ptr(), w.data_ptr(), bias.data_ptr(),
        None if resid is None else resid.data_ptr(), out.data_ptr(), M, w.shape[0], K,
        int(gelu), int(out_f32), cs, rg, int(pdl), None if trace is None else trace.data_ptr(),
        _build.stream_ptr(a.device),
    ), "skinny projection")
    return out


def _layer_norm(x, g, b):
    return A._proj_layer_norm(_build.lib(), _build.stream_ptr(x.device), x, g, b)


def _graph_ms(fn, calls: int = 1) -> float:
    """Median over RUNS replays of a graph of ``calls`` calls, per call: one
    call as chip_smoke.timed_ms times it, or back to back (the launch's own
    cost and the gaps between launches)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    times = []
    for _ in range(RUNS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def _both_ms(fn) -> dict:
    return {"ms": _graph_ms(fn), "ms_b2b": _graph_ms(fn, CALLS)}


def _inputs(gen, M):
    r = lambda *s, scale=1.0: (torch.randn(*s, generator=gen) * scale).to("cuda", torch.bfloat16)
    x = r(M, D)
    ln = (1 + r(D, scale=0.1), r(D, scale=0.1))
    w1, b1, w2, b2 = r(F, D, scale=D ** -0.5), r(F, scale=0.02), r(D, F, scale=F ** -0.5), \
        r(D, scale=0.02)
    wo, bo, attn = r(D, D, scale=D ** -0.5), r(D, scale=0.02), r(M, D)
    wqkv, bqkv, wq, bq = r(3 * D, D, scale=D ** -0.5), r(3 * D, scale=0.02), \
        r(D, D, scale=D ** -0.5), r(D, scale=0.02)
    h = A._ln_f32(x, *ln).to(torch.bfloat16)
    u = A._proj_plain(h, w1, b1, gelu=True)
    return {"x": x, "ln": ln, "w1": w1, "b1": b1, "w2": w2, "b2": b2, "wo": wo, "bo": bo,
            "wqkv": wqkv, "bqkv": bqkv, "wq": wq, "bq": bq, "attn": attn, "h": h, "u": u}


def _products(t):
    """name -> (keyword arguments of launch / _proj_plain) of each product."""
    return {
        "w1": dict(a=t["h"], w=t["w1"], bias=t["b1"], gelu=True),
        "w2": dict(a=t["u"], w=t["w2"], bias=t["b2"], resid=t["x"]),
        "wo": dict(a=t["attn"], w=t["wo"], bias=t["bo"], resid=t["x"]),
        "qkv": dict(a=t["h"], w=t["wqkv"], bias=t["bqkv"]),
        "wq f32": dict(a=t["h"], w=t["wq"], bias=t["bq"], out_f32=True),
    }


def _checked_ms(kw, cs=0, rg=0):
    """(ms, max_abs_err) of one product at (cs, rg), each launch waiting for
    the one before in full, or the launch's error."""
    call = lambda: launch(**kw, cs=cs, rg=rg, pdl=False)
    try:
        got = call()
        torch.cuda.synchronize()
    except RuntimeError as exc:
        return {"error": str(exc).splitlines()[0]}
    want = A._proj_plain(**kw)
    err = float((got.float() - want.float()).abs().max())
    big = float(want.float().abs().max())
    tol = 1e-4 * max(1.0, big) if want.dtype == torch.float32 else 2.0 ** -6 * big
    return {**_both_ms(call), "max_abs_err": err, "ok": err <= tol}


def _trace(kw) -> dict:
    """Per step of one launch: the longest and the mean time over its blocks
    (us), from the global-timer marks each block writes."""
    marks = _build.lib().olm_proj_marks()
    trace = torch.zeros((8192, marks), dtype=torch.int64, device="cuda")
    for _ in range(2):
        launch(**kw, pdl=False, trace=trace)
    torch.cuda.synchronize()
    t = trace.cpu().double() / 1e3
    t = t[t[:, 0] > 0]
    t0 = float(t[:, 0].min())
    out = {"blocks": int(t.shape[0])}
    start = t[:, 0] - t0
    out["start"] = (round(float(start.max()), 3), round(float(start.mean()), 3))
    for i in range(1, marks):
        d = t[:, i] - t[:, i - 1]
        out[STEPS[i]] = (round(float(d.max()), 3), round(float(d.mean()), 3))
    out["span"] = round(float(t[:, -1].max()) - t0, 3)
    return out


def programmatic_edges(fn) -> int:
    """The programmatic-dependency edges a CUDA graph capture of ``fn``
    keeps (csrc/skinny_proj.cu: olm_graph_programmatic_edges)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    return _build.lib().olm_graph_programmatic_edges(graph.raw_cuda_graph())


def probe(M: int) -> dict:
    t = _inputs(torch.Generator().manual_seed(M), M)
    products = _products(t)
    out = {"rows": M}
    out["proj"] = {name: _checked_ms(kw) for name, kw in products.items()}
    out["proj"]["layer norm"] = _both_ms(lambda: _layer_norm(t["x"], *t["ln"]))
    out["proj"]["mlp_block"] = _both_ms(
        lambda: A.mlp_block(t["x"][:, None], *t["ln"], t["w1"], t["b1"], t["w2"], t["b2"]))

    def serial():
        u = launch(_layer_norm(t["x"], *t["ln"]), t["w1"], t["b1"], gelu=True, pdl=False)
        launch(u, t["w2"], t["b2"], resid=t["x"], pdl=False)
    out["proj"]["mlp_block pdl off"] = _both_ms(serial)
    out["proj"]["matmul_residual"] = _both_ms(
        lambda: A.matmul_residual(t["attn"][:, None], t["x"][:, None], t["wo"], t["bo"]))
    lnmm = lambda: A.ln_matmul(t["x"][:, None], *t["ln"], t["wqkv"], t["bqkv"])
    out["proj"]["ln_matmul"] = _both_ms(lnmm)
    # mlp_block, matmul_residual, ln_matmul: LN -> W1 -> W2 -> Wo, then LN ->
    # QKV, four such edges
    out["programmatic_edges"] = programmatic_edges(lambda: (
        A.mlp_block(t["x"][:, None], *t["ln"], t["w1"], t["b1"], t["w2"], t["b2"]),
        A.matmul_residual(t["attn"][:, None], t["x"][:, None], t["wo"], t["bo"]), lnmm()))
    out["ln_matmul pdl"] = {
        f"cs{c} rg{g} pdl {'on' if pdl else 'off'}": _both_ms(
            lambda c=c, g=g, pdl=pdl: launch(_layer_norm(t["x"], *t["ln"]), t["wqkv"], t["bqkv"],
                                             cs=c, rg=g, pdl=pdl))
        for c, g in LNMM_CHOICES for pdl in (True, False)}
    out["sweep"] = {name: {f"cs{cs} rg{rg}": _checked_ms(kw, cs, rg)
                           for cs in CLUSTERS for rg in ROW_GROUPS}
                    for name, kw in products.items()}
    out["trace"] = {name: _trace(kw) for name, kw in products.items()}
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("probe_proj: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    bad = []
    for M in ROWS:
        row = probe(M)
        print(json.dumps(row))
        bad += [f"{M} rows {name}" for name, r in row["proj"].items() if r.get("ok") is False]
        bad += [f"{M} rows {name} {cfg}" for name, cfgs in row["sweep"].items()
                for cfg, r in cfgs.items() if r.get("ok") is False]
    if bad:
        raise SystemExit(f"probe_proj: the kernel disagrees with the plain version: {bad}")


if __name__ == "__main__":
    main()
