"""The readers of the program's spans (``olmoasr_tpu_torch.tracing``) on the
CPU: their arithmetic on a synthetic context, None where the program has no
such span or no tracing module (a checkout before it), and a traced run of
each kind of cell, cut to a size a CPU test run holds, that prints them."""

import sys

import pytest

from gpubench import core, trace
from gpubench_micro import micro_cell

SEED = 2 ** 31 + 91

TOTALS = {
    "decode.encode": {"count": 1, "seconds": 0.030, "self_seconds": 0.030},
    "decode.cross_cache": {"count": 1, "seconds": 0.010, "self_seconds": 0.010},
    "decode.prefill": {"count": 1, "seconds": 0.004, "self_seconds": 0.004},
    "decode.step": {"count": 127, "seconds": 0.635, "self_seconds": 0.635},
    "decode.select": {"count": 128, "seconds": 1.016, "self_seconds": 1.016},
    "decode.results": {"count": 1, "seconds": 0.006, "self_seconds": 0.006},
    "train.micro": {"count": 2, "seconds": 0.400, "self_seconds": 0.400},
    "train.update": {"count": 1, "seconds": 0.050, "self_seconds": 0.050},
    "loader.batch": {"count": 1, "seconds": 0.025, "self_seconds": 0.025},
}


def _ctx(workload):
    ctx = core.Context(core.load_cell(workload), SEED, "cpu", core.Spans())
    ctx.traced = {"batches": [{"rows": 128, "steps": 127}], "samples": 32}
    ctx.trace = trace.TraceSummary(window_s=0.5, busy_s=0.3, n_kernels=0)
    return ctx


@pytest.fixture
def totals(monkeypatch):
    from olmoasr_tpu_torch import tracing

    monkeypatch.setattr(tracing, "totals", lambda: TOTALS)


@pytest.mark.parametrize("name, workload, want", [
    ("host_step_ms.transcribe", "short-small-b128", 1000.0 * 0.635 / 127),
    ("host_select_ms.transcribe.large", "short-large-int8-b128", 1000.0 * 1.016 / 127),
    ("host_edges_ms.transcribe", "short-small-b128", 1000.0 * 0.050),
    ("host_micro_ms.train", "train-small-mb16x2", 200.0),
    ("host_update_ms.train.large", "train-large-mb32x2", 50.0),
    ("loader_busy_pct.train", "train-small-mb16x2", 5.0),
])
def test_readers_of_spans(totals, name, workload, want):
    assert core.load_metric(name)(_ctx(workload)) == pytest.approx(want, rel=1e-12)


READERS = ["host_step_ms", "host_select_ms", "host_edges_ms", "host_micro_ms",
           "host_update_ms", "loader_busy_pct"]


def test_loader_idle_through_the_window_reads_zero(monkeypatch):
    """A traced step in which the producer, ahead by ``prefetch + 1``
    batches, assembled none: 0%."""
    from olmoasr_tpu_torch import tracing

    monkeypatch.setattr(tracing, "totals", lambda: {
        k: v for k, v in TOTALS.items() if k != "loader.batch"})
    assert core.load_metric("loader_busy_pct.train.large")(_ctx("train-large-mb32x2")) == 0.0


@pytest.mark.parametrize("name", READERS)
def test_readers_without_spans_give_none(monkeypatch, name):
    """No span counted (the traced window ran no such work), and a program
    without the tracing module: each reader gives None and raises
    nothing."""
    from olmoasr_tpu_torch import tracing

    read = core.load_metric(name)
    monkeypatch.setattr(tracing, "totals", lambda: {})
    assert read(_ctx("short-small-b128")) is None
    monkeypatch.setattr(tracing, "totals", lambda: {
        k: dict(v, count=0) for k, v in TOTALS.items()})
    assert read(_ctx("train-small-mb16x2")) is None
    monkeypatch.setitem(sys.modules, "olmoasr_tpu_torch.tracing", None)
    assert read(_ctx("train-small-mb16x2")) is None


@pytest.mark.parametrize("workload, names", [
    ("short-small-b128", ["host_step_ms.transcribe", "host_select_ms.transcribe",
                          "host_edges_ms.transcribe"]),
    ("train-small-mb16x2", ["host_micro_ms.train", "host_update_ms.train",
                            "loader_busy_pct.train"]),
])
def test_traced_run_reports_the_spans(workload, names):
    """A traced run (the CPU's profiler: no device activity) reads the
    program's spans of its traced unit alone."""
    from olmoasr_tpu_torch import tracing

    tracing.reset()
    try:
        out = core.run(micro_cell(workload), SEED, 0.3, True, device="cpu",
                       log=lambda *a, **k: None)
    finally:
        tracing.reset()
    assert out["correct"] is True
    got = {name: out["metrics"][name]["value"] for name in names}
    # the loader may assemble nothing in one traced step: 0% then
    assert all(v > 0 for k, v in got.items() if not k.startswith("loader")), got
    assert 0 <= got.get("loader_busy_pct.train", 0) <= 100
