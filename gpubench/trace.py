"""Reading a ``torch.profiler`` trace: the device's busy time, its kernels
by name, and its idle gaps labelled by the harness's own host spans.

The harness marks its calls into the program with
``torch.profiler.record_function("gpubench.<phase>")``; those marks and the
device's activities (kernels, copies, fills) come back on one clock. The
traced window runs from the first ``gpubench.unit`` mark to the end of the
last one."""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

PREFIX = "gpubench."


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    n_kernels: int
    kernels: Dict[str, List[float]] = field(default_factory=dict)  # name -> [count, seconds]
    idle_by_phase: Dict[str, float] = field(default_factory=dict)

    def kernel_seconds(self, pattern: str) -> Tuple[int, float]:
        """Launches and device seconds of the kernels whose full name
        matches ``pattern`` (a regular expression, searched)."""
        rx = re.compile(pattern)
        n = t = 0.0
        for name, (count, secs) in self.kernels.items():
            if rx.search(name):
                n += count
                t += secs
        return int(n), t


def _kind(event) -> str:
    kind = getattr(event, "activity_type", None)
    return str(kind() if callable(kind) else kind or "").lower()


def _is_device(event) -> bool:
    if "CUDA" not in str(event.device_type()):
        return False
    if event.is_user_annotation() or event.name().startswith(PREFIX):
        return False
    return "annotation" not in _kind(event)


def _is_kernel(event) -> bool:
    kind = _kind(event)
    return "kernel" in kind if kind else not re.search(r"memcpy|memset", event.name(), re.I)


def summarize(events) -> Optional[TraceSummary]:
    """The summary of kineto ``events`` (``prof.profiler.kineto_results
    .events()``), or None when the trace holds no harness mark."""
    spans = []
    for e in events:
        if "CPU" in str(e.device_type()) and e.name().startswith(PREFIX):
            spans.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()[len(PREFIX):]))
    units = [s for s in spans if s[2] == "unit"]
    if not units:
        return None
    w0, w1 = min(s[0] for s in units), max(s[1] for s in units)
    intervals, kernels, n_kernels = [], {}, 0
    for e in events:
        if not _is_device(e):
            continue
        a = max(e.start_ns(), w0)
        b = min(e.start_ns() + e.duration_ns(), w1)
        if b <= a:
            continue
        intervals.append((a, b))
        if _is_kernel(e):
            n_kernels += 1
            slot = kernels.setdefault(e.name(), [0, 0.0])
            slot[0] += 1
            slot[1] += (b - a) * 1e-9
    intervals.sort()
    busy, gaps, cur_a, cur_b = 0, [], w0, w0
    for a, b in intervals:
        if a > cur_b:
            busy += cur_b - cur_a
            gaps.append((cur_b, a))
            cur_a = a
        cur_b = max(cur_b, b)
    busy += cur_b - cur_a
    if cur_b < w1:
        gaps.append((cur_b, w1))
    inner = sorted((s for s in spans if s[2] != "unit"), key=lambda s: s[1] - s[0])
    idle: Dict[str, float] = {}
    for a, b in gaps:
        mid = (a + b) // 2
        label = next((s[2] for s in inner if s[0] <= mid <= s[1]), "between phases")
        idle[label] = idle.get(label, 0.0) + (b - a) * 1e-9
    return TraceSummary((w1 - w0) * 1e-9, busy * 1e-9, n_kernels, kernels, idle)


def short_name(name: str, limit: int = 160) -> str:
    """A kernel's name without ``void``, its argument list and namespaces."""
    s = re.sub(r"^void\s+", "", name)
    depth, cut = 0, len(s)
    for i in range(len(s) - 1, -1, -1):  # the last top-level argument list
        if s[i] == ")":
            depth += 1
        elif s[i] == "(":
            depth -= 1
            if depth == 0:
                cut = i
                break
    s = s[:cut] if cut > 0 else s
    s = re.sub(r"\(anonymous namespace\)::", "", s)
    head, sep, tail = s.partition("<")
    head = head.rsplit("::", 1)[-1]
    return (head + sep + tail)[:limit]


def breakdown(summary: TraceSummary) -> Dict[str, list]:
    """The device operations that took the most time (by kernel name) and
    the idle time by what the harness was doing on the host, 10 of each."""
    ops: Dict[str, float] = {}
    for name, (_, secs) in summary.kernels.items():
        key = short_name(name)
        ops[key] = ops.get(key, 0.0) + secs
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(summary.idle_by_phase.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in top], "idle_gaps": [[k, v] for k, v in gaps]}
