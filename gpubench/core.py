"""The harness: a cell's files found by name, set-up, the measured window,
the traced window, the per-layer metrics, the check and the result line.

A cell of ``BENCHMARK.json`` joins a configuration (``configs/<name>.json``,
its file named in ``configs``) to a traffic mix (``traffic/<name>.json``);
its limits are in ``limits/<workload>.json``. The traffic file's ``kind``
names the generator that drives the program (``drivers/<kind>.py``), whose
``end_to_end`` gives the window's end-to-end values by name; each per-layer
metric is read by ``metrics/<name>.py``. A metric ``<base>.<cells>`` is
``<base>`` in the cells it lists, with a bound of its own, and its value or
reader is ``<base>``'s (:func:`prefixes`). A later cell, configuration or
metric is new files and new entries, and no edit.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# top-level module names that no run may load: JAX and the JAX package,
# and the ``olmoasr`` shim that imports it
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "olmoasr_tpu", "olmoasr")


def forbidden_modules(names=None) -> List[str]:
    """The forbidden top-level names among ``names`` (default: the modules
    loaded in this process), compared whole: ``olmoasr_tpu_torch`` is not
    ``olmoasr_tpu``."""
    names = sys.modules.keys() if names is None else names
    return sorted({n.split(".", 1)[0] for n in names} & set(FORBIDDEN))


def _read_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    workload: Dict[str, Any]
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]

    @property
    def name(self) -> str:
        return self.workload["name"]

    @property
    def dims(self) -> Dict[str, int]:
        return self.config["dims"]


def _in_cell(metric: Dict[str, Any], name: str) -> bool:
    return "workloads" not in metric or name in metric["workloads"]


def load_cell(workload: str, root: str = ROOT, bench: Optional[Dict[str, Any]] = None) -> Cell:
    """The files of ``workload`` under ``root``, found by the names in
    ``BENCHMARK.json`` (or ``bench``)."""
    bench = bench if bench is not None else _read_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; cells: {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _read_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = _read_json(os.path.join(root, "gpubench", "traffic", f"{w['traffic']}.json"))
    limits = _read_json(os.path.join(root, "gpubench", "limits", f"{workload}.json"))
    e2e = [m for m in bench["end_to_end"] if _in_cell(m, workload)]
    per_layer = [m for m in bench["per_layer"] if _in_cell(m, workload)]
    return Cell(w, config, traffic, limits, e2e, per_layer)


def prefixes(name: str) -> List[str]:
    """``name`` and its dotted prefixes, the longest first: a metric
    ``<base>.<cells>`` is ``<base>`` read in the cells it lists, with a bound
    of its own (``mfu.train.large``: ``mfu.train``, then ``mfu``)."""
    parts = name.split(".")
    return [".".join(parts[:i]) for i in range(len(parts), 0, -1)]


def load_metric(name: str, root: str = ROOT) -> Callable[["Context"], Optional[float]]:
    """The ``read`` function of ``metrics/<p>.py`` for the longest prefix
    ``p`` of ``name`` that has one: metrics of one quantity in different
    cells share their reader (``device_idle_pct.train``:
    ``device_idle_pct.py``)."""
    folder = os.path.join(root, "gpubench", "metrics")
    found = [p for p in prefixes(name) if os.path.exists(os.path.join(folder, f"{p}.py"))]
    if not found:
        raise FileNotFoundError(f"no reader for the metric {name!r} in {folder}")
    path = os.path.join(folder, f"{found[0]}.py")
    spec = importlib.util.spec_from_file_location(f"gpubench_metric_{name.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


class Spans:
    """The harness's host spans: seconds summed by phase over the measured
    window, and a profiler mark (``gpubench.<phase>``) around each call."""

    def __init__(self):
        self.seconds: Dict[str, float] = {}
        self.counting = False

    @contextmanager
    def __call__(self, phase: str):
        import torch

        t0 = time.perf_counter()
        with torch.profiler.record_function(f"gpubench.{phase}"):
            yield
        if self.counting:
            self.seconds[phase] = self.seconds.get(phase, 0.0) + time.perf_counter() - t0


@dataclass
class Context:
    """What a driver and a metric reader see."""

    cell: Cell
    seed: int
    device: str
    spans: Spans
    control: List[str] = field(default_factory=list)
    window: Dict[str, Any] = field(default_factory=dict)  # seconds, counts
    traced: Dict[str, Any] = field(default_factory=dict)  # counts of the traced units
    trace: Any = None  # trace.TraceSummary of the traced window
    peak: Optional[Dict[str, float]] = None  # cost.peaks of the card
    window_peak_bytes: int = 0

    @property
    def dims(self) -> Dict[str, int]:
        return self.cell.dims

    @property
    def traffic(self) -> Dict[str, Any]:
        return self.cell.traffic


def _sync(device: str) -> None:
    import torch

    if device.startswith("cuda"):
        torch.cuda.synchronize()


def _memory_peak(device: str) -> int:
    import torch

    if not device.startswith("cuda"):
        return 0
    return max(torch.cuda.max_memory_allocated(i) for i in range(torch.cuda.device_count()))


def _reset_peak(device: str) -> None:
    import torch

    if device.startswith("cuda"):
        for i in range(torch.cuda.device_count()):
            torch.cuda.reset_peak_memory_stats(i)


def _traced_window(driver, ctx: Context) -> None:
    """Run ``traffic["trace_units"]`` more units under ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from gpubench import trace

    acts = [ProfilerActivity.CPU]
    if ctx.device.startswith("cuda"):
        acts.append(ProfilerActivity.CUDA)
    _sync(ctx.device)
    counts: Dict[str, Any] = {}
    with profile(activities=acts) as prof:
        for _ in range(ctx.traffic["trace_units"]):
            with record_function("gpubench.unit"):
                driver.unit(counts)
                driver.finish()
    ctx.traced = counts
    ctx.trace = trace.summarize(prof.profiler.kineto_results.events())
    del prof
    gc.collect()


def _check_numbers(cell: Cell, numbers: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    limits = cell.limits["numbers"]
    missing = set(limits) - set(numbers)
    if missing:
        raise KeyError(f"the check gave no {sorted(missing)}")
    return {k: {"value": numbers[k], "limit": limits[k]["limit"]} for k in limits}


def run(cell: Cell, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
        t_start: Optional[float] = None, control: Optional[List[str]] = None,
        log=print) -> Dict[str, Any]:
    """One run of ``cell``: the result line's object, ``check`` last.

    ``device`` is ``"cuda"`` for every measured run; the CPU serves the
    tests of the harness, which drive the program's plain twins."""
    import torch

    from gpubench import cost

    t_start = time.perf_counter() if t_start is None else t_start
    ctx = Context(cell, seed, device, Spans(), list(control or []))
    kind = cell.traffic["kind"]
    driver = importlib.import_module(f"gpubench.drivers.{kind}").Driver(ctx)
    driver.setup()
    _sync(device)
    setup_s = time.perf_counter() - t_start
    setup_peak = _memory_peak(device)
    _reset_peak(device)

    counts: Dict[str, Any] = {}
    # a control of the training traffic replaces the program: no window
    windowless = bool(ctx.control) and not getattr(driver, "control_needs_window", True)
    # the set-up's objects out of the collector's reach: no collection in the
    # window walks them
    gc.collect()
    gc.freeze()
    ctx.spans.counting = True
    t0 = time.perf_counter()
    ends, cpu = [], []
    while not windowless:
        c0 = time.thread_time()
        driver.unit(counts)
        ends.append(time.perf_counter() - t0)
        cpu.append(time.thread_time() - c0)
        if ends[-1] >= seconds:
            break
    driver.finish()
    window_s = time.perf_counter() - t0
    gc.unfreeze()
    ctx.spans.counting = False
    ctx.window = {"seconds": window_s, "counts": counts}
    ctx.window_peak_bytes = _memory_peak(device)
    memory_peak = max(setup_peak, ctx.window_peak_bytes)
    phases = ", ".join(f"{k} {v:.3f}" for k, v in getattr(driver, "setup_phases", {}).items())
    units = ", ".join(f"{b - a:.3f}/{c:.3f}" for a, b, c in zip([0.0] + ends, ends, cpu))
    log(f"gpubench: {cell.name} set-up {setup_s:.3f} s ({phases}), window {window_s:.3f} s, "
        f"{counts.get('units', 0)} units (wall/host CPU: {units} s)", file=sys.stderr)

    metrics: Dict[str, Dict[str, Any]] = {}
    result: Dict[str, Any] = {}
    if device.startswith("cuda"):
        ctx.peak = cost.peaks(torch.cuda.get_device_name(0))
    if trace and not windowless:
        _traced_window(driver, ctx)
        for m in cell.per_layer:
            value = load_metric(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if ctx.trace is not None:
            from gpubench import trace as trace_mod

            result["breakdown"] = trace_mod.breakdown(ctx.trace)
    elif not windowless:
        values = {"setup_s": setup_s, **driver.end_to_end(window_s, counts)}
        for m in cell.end_to_end:
            base = [p for p in prefixes(m["name"]) if p in values][0]
            metrics[m["name"]] = {"value": values[base], "unit": m["unit"]}

    numbers = driver.check()
    checked = _check_numbers(cell, numbers) if not ctx.control else {
        k: {"value": v, "limit": cell.limits["numbers"].get(k, {}).get("limit")}
        for k, v in numbers.items()}
    correct = counts.get("failed", 0) == 0 and all(
        c["limit"] is not None and math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checked.values())
    dev = {"platform": "gpu" if device.startswith("cuda") else "cpu",
           "kind": torch.cuda.get_device_name(0) if device.startswith("cuda") else "cpu",
           "count": cell.workload["chips"], "memory_peak_bytes": memory_peak}
    if trace and ctx.trace is not None:
        dev["busy_s"] = ctx.trace.busy_s
        dev["window_s"] = ctx.trace.window_s
    out = {"correct": bool(correct), "attempted": counts.get("attempted", 0),
           "failed": counts.get("failed", 0), "metrics": metrics, "device": dev}
    out.update(result)
    out["check"] = checked
    return out
