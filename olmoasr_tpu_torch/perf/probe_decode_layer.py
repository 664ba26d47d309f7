"""Where the time of the bf16 decode layer goes, on the card (PERF.md §6
row 7): each phase of ``csrc/decode_layer.cu`` timed from the
global timer marks its blocks write when given a trace buffer.

At small.en's served shape (B=64 rows, D=768, 12 heads, a ring of C=225
at offset 224, an int8 cross cache of 1500 keys, F=3072), seeded random
inputs, for each launch ("sc" and the whole layer): the
launch's time from replays of a CUDA graph of one call (``ms``), then one
traced launch: for every phase the longest and the mean time a block spent
in its work (over the blocks with an item in it, ``first``: until its A
was built, or its first keys were in; ``items``: from there to its last
item's end), and for every grid-wide
barrier the longest wait of a block (the last block's arrival, less its
own). The marks cost one timer read
and one store a block a phase; the graph replays take no trace.

Run: ``python -m olmoasr_tpu_torch.perf.probe_decode_layer`` (one JSON
line per launch).
"""

from __future__ import annotations

import json
import statistics
import subprocess

import torch

from olmoasr_tpu_torch.ops import _build
from olmoasr_tpu_torch.ops import attention as A

B, D, H, C, OFFSET, T, F = 64, 768, 12, 225, 224, 1500, 3072
MARKS = 32  # csrc/decode_layer.cu: kMarks; 16 + 2p, 17 + 2p: inside phase p
RUNS = 11
# (name, start mark, end mark, phase index) of each phase's work, and each
# barrier's (end mark of the phase before, mark after the barrier)
PHASES = {
    "sc": [("qkv", 0, 1, 0), ("self", 2, 3, 1), ("wo", 4, 5, 2), ("wq", 6, 7, 3),
           ("cross", 8, 9, 4), ("wo2", 10, 11, 5)],
    "layer": [("qkv", 0, 1, 0), ("self", 2, 3, 1), ("wo", 4, 5, 2), ("wq", 6, 7, 3),
              ("cross", 8, 9, 4), ("wo2", 10, 11, 5), ("w1", 12, 13, 6), ("w2", 14, 15, 7)],
}


def _inputs(gen):
    from olmoasr_tpu_torch.models.whisper import _quantize_rows

    r = lambda *s, scale=1.0: (torch.randn(*s, generator=gen) * scale).to("cuda", torch.bfloat16)
    sub = lambda n: [1 + r(D, scale=0.1), r(D, scale=0.1), r(n * D, D, scale=D ** -0.5),
                     r(n * D, scale=0.02), r(D, D, scale=D ** -0.5), r(D, scale=0.02)]
    mlp = [1 + r(D, scale=0.1), r(D, scale=0.1), r(F, D, scale=D ** -0.5), r(F, scale=0.02),
           r(D, F, scale=F ** -0.5), r(D, scale=0.02)]
    (ck, ks), (cv, vs) = (_quantize_rows(torch.randn(B, T, D, generator=gen).cuda())
                          for _ in range(2))
    return (r(B, 1, D), *sub(3), *sub(1), r(1, B, C, D), r(1, B, C, D), ck, cv,
            ks[:, None].contiguous(), vs[:, None].contiguous()), mlp


def _launcher(mode, args, mlp):
    """A call of the mode's kernel that writes its marks into ``trace`` when
    given one: the wrappers' launches, with the trace pointer set."""
    lib = _build.lib()
    stream = lambda: _build.stream_ptr(torch.device("cuda"))  # the capture's, in a graph
    x = args[0]
    out = torch.empty_like(x)
    Fd = F if mode == "layer" else 0
    scratch = torch.empty((lib.olm_decode_layer_scratch(B, D, Fd),), device=x.device)
    kv_new = torch.empty((2, B, 1, D), dtype=x.dtype, device=x.device)
    ptrs = [t.data_ptr() for t in args[:13]]
    ptrs += [t.data_ptr() for t in mlp] if mode == "layer" else [None] * 6
    ptrs += [t.data_ptr() for t in args[13:]]

    def call(trace=None):
        _build.check(lib.olm_decode_layer(
            *ptrs, out.data_ptr(), kv_new.data_ptr(), scratch.data_ptr(), 1, 0, B, C, OFFSET, D,
            H, T, Fd, A._q_scale(D // H), None if trace is None else trace.data_ptr(), stream(),
        ), "layer_block_decode")
    return call


def _graph_ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    times = []
    for _ in range(RUNS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def probe(mode, args, mlp) -> dict:
    call = _launcher(mode, args, mlp)
    ms = _graph_ms(call)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    trace = torch.zeros((sms, MARKS), dtype=torch.int64, device="cuda")
    call(trace)  # warm
    call(trace)
    torch.cuda.synchronize()
    t = trace.cpu().double() / 1e3  # us
    t = t[t[:, 0] > 0]  # the rows of the launch's blocks: the grid may have fewer than SMs
    phases = PHASES[mode]
    out = {"mode": mode, "ms": ms, "phases": {}, "barriers": {}}
    for name, s, e, p in phases:
        busy = t[:, 16 + 2 * p] > 0  # blocks with an item in the phase
        work, first = t[:, e] - t[:, s], (t[:, 16 + 2 * p] - t[:, s])[busy]
        items = (t[:, 17 + 2 * p] - t[:, 16 + 2 * p])[busy]
        out["phases"][name] = {"max_us": float(work.max()), "mean_us": float(work.mean()),
                               "busy_blocks": int(busy.sum()),
                               "first_max_us": float(first.max()),
                               "first_mean_us": float(first.mean()),
                               "items_max_us": float(items.max()),
                               "items_mean_us": float(items.mean())}
    for (name, _, e, _), (_, s_next, _, _) in zip(phases, phases[1:]):
        out["barriers"][f"after {name}"] = float((t[:, s_next] - t[:, e]).max())
    out["traced_us"] = float(t[:, phases[-1][2]].max() - t[:, 0].min())
    return out


def cluster_check() -> dict:
    """Whether the card takes a cooperative launch in clusters of 2, 4 and 8
    blocks (``olm_cluster_cooperative_check``): the launch's error and, where
    it ran, its blocks and whether each read its neighbour's shared memory."""
    lib, out = _build.lib(), {}
    for cluster in (2, 4, 8):
        # a block an SM at most 8 times over (256 threads): room for every block
        got = torch.full((8 * 1024,), -1, dtype=torch.int32, device="cuda")
        grid = torch.zeros((1,), dtype=torch.int32)
        err = lib.olm_cluster_cooperative_check(cluster, got.data_ptr(), grid.data_ptr(),
                                                 _build.stream_ptr(got.device))
        row = {"error": int(err), "message": lib.olm_error_string(err).decode(),
               "grid": int(grid[0])}
        if err == 0:
            torch.cuda.synchronize()
            n = int(grid[0])
            want = torch.arange(n, device="cuda", dtype=torch.int32)
            want = want - want % cluster + (want % cluster + 1) % cluster
            row["neighbours_read"] = bool(torch.equal(got[:n], want))
        out[str(cluster)] = row
    return out


STEPS = ("own 24 KB cp.async", "shared 24 KB cp.async", "24 KB ld+st", "10 cluster barriers",
         "10 grid barriers", "far 24 KB cp.async", "cluster smem reads",
         "4096 dependent FMAs", "LayerNorm-like pass, 64 x 192", "the same pass again")


def step_probe(smem: int = 160 * 1024) -> dict:
    """What the phases' steps cost a block at the layer's launch shape
    (``olm_decode_layer_step_probe``): for each step, the longest and the
    mean time over the blocks, in us."""
    lib = _build.lib()
    src = torch.randn(4 << 20, device="cuda")  # 16 MB
    grid = torch.zeros((1,), dtype=torch.int32)
    t = torch.zeros((1024 * 11,), dtype=torch.int64, device="cuda")
    sink = torch.zeros((1024,), device="cuda")
    for _ in range(2):
        _build.check(lib.olm_decode_layer_step_probe(
            src.data_ptr(), t.data_ptr(), sink.data_ptr(), smem, grid.data_ptr(),
            _build.stream_ptr(src.device)), "step probe")
    torch.cuda.synchronize()
    n = int(grid[0])
    marks = t[: n * 11].view(n, 11).cpu().double() / 1e3
    out = {"blocks": n, "smem": smem}
    for i, name in enumerate(STEPS):
        d = marks[:, i + 1] - marks[:, i]
        out[name] = (round(float(d.max()), 3), round(float(d.mean()), 3))
    return out


def main() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    print(json.dumps({"cooperative_clusters": cluster_check()}))
    print(json.dumps({"steps": step_probe()}))
    args, mlp = _inputs(torch.Generator().manual_seed(0))
    for mode in ("sc", "layer"):
        print(json.dumps(probe(mode, args, mlp)))


if __name__ == "__main__":
    main()
