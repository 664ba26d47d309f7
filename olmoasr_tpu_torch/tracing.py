"""Spans of the port's host work, recorded only while ``torch.profiler``
records.

``span(name)`` marks one stretch of host work at a layer boundary: the
encoder's call, one decode step's launches, a micro-batch's forward and
backward, the loader's assembly of a batch. With no profiler recording it
hands back one shared no-op context, so a span costs one test of a flag.
While a profiler records (``torch.autograd.profiler._is_profiler_enabled``,
a global that every thread reads alike), a span

- enters ``torch.profiler.record_function("olmoasr.<name>")`` on a thread
  that the profiler traces (``torch.autograd._profiler_enabled()``, which
  is per thread): the event lands in the kineto trace on the clock of the
  device's kernels and copies. A span on another thread, such as
  ``BatchLoader``'s producer, reaches the totals and not the trace;
- adds to an in-memory total per name: the count, the host seconds
  (``time.perf_counter``) and the self seconds, its duration less its
  direct children's on the same thread.

``totals()`` reads the totals and ``reset()`` empties them. No switch but the
profiler turns spans on: a ``torch.profiler.profile`` around
``OLMoASR.decode``, or ``train_loop.main``'s ``profile_dir``.
"""

from __future__ import annotations

import threading
import time
from contextlib import nullcontext
from typing import Dict, List

import torch
import torch.autograd.profiler as _profiler

PREFIX = "olmoasr."

_OFF = nullcontext()
_lock = threading.Lock()
_totals: Dict[str, List[float]] = {}  # name -> [count, seconds, self seconds]
_local = threading.local()  # .stack: the open spans of this thread


class _Span:
    __slots__ = ("name", "mark", "t0", "children")

    def __init__(self, name: str):
        self.name = name
        self.mark = (torch.profiler.record_function(PREFIX + name)
                     if torch.autograd._profiler_enabled() else None)

    def __enter__(self):
        stack = _local.__dict__.setdefault("stack", [])
        stack.append(self)
        self.children = 0.0
        if self.mark is not None:
            self.mark.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        seconds = time.perf_counter() - self.t0
        if self.mark is not None:
            self.mark.__exit__(*exc)
        stack = _local.stack
        stack.pop()
        if stack:
            stack[-1].children += seconds
        with _lock:
            slot = _totals.setdefault(self.name, [0, 0.0, 0.0])
            slot[0] += 1
            slot[1] += seconds
            slot[2] += seconds - self.children
        return False


def span(name: str):
    """A context that records ``name`` while a profiler records, else the
    shared no-op context."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def totals() -> Dict[str, Dict[str, float]]:
    """``{name: {"count", "seconds", "self_seconds"}}`` of the spans ended
    since the last ``reset()``."""
    with _lock:
        return {k: {"count": int(c), "seconds": s, "self_seconds": own}
                for k, (c, s, own) in _totals.items()}


def reset() -> None:
    with _lock:
        _totals.clear()
