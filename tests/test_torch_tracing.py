"""The port's spans (``olmoasr_tpu_torch.tracing``), on the CPU at micro
dims: off without a profiler, and under one the counts the decode loop, the
train step and the loader give, the self time of nested spans, and the
events that reach the kineto trace."""

from __future__ import annotations

import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from olmoasr_tpu_torch import decoding, tracing
from olmoasr_tpu_torch.api import _new_model
from olmoasr_tpu_torch.models import whisper as tm
from olmoasr_tpu_torch.models.dims import ModelDimensions
from olmoasr_tpu_torch.training import train as ttrain
from olmoasr_tpu_torch.training.dataset import BatchLoader

DECODE_DIMS = ModelDimensions(
    n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=4, n_audio_layer=1,
    n_vocab=51864, n_text_ctx=448, n_text_state=64, n_text_head=4, n_text_layer=1)
TRAIN_DIMS = ModelDimensions(
    n_mels=80, n_audio_ctx=40, n_audio_state=64, n_audio_head=2, n_audio_layer=1,
    n_vocab=51864, n_text_ctx=24, n_text_state=64, n_text_head=2, n_text_layer=1)


@pytest.fixture(autouse=True)
def empty_totals():
    tracing.reset()
    yield
    tracing.reset()


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


def _event_names(prof):
    return [e.name() for e in prof.profiler.kineto_results.events()]


def test_private_profiler_flags_exist():
    """The span's switch is ``torch.autograd.profiler._is_profiler_enabled``,
    a global every thread reads alike; whether a thread's events reach the
    trace is ``torch.autograd._profiler_enabled()``, per thread."""
    seen = []
    assert torch.autograd.profiler._is_profiler_enabled is False
    assert torch.autograd._profiler_enabled() is False
    with _profiled():
        assert torch.autograd.profiler._is_profiler_enabled is True
        assert torch.autograd._profiler_enabled() is True
        t = threading.Thread(target=lambda: seen.append(
            (torch.autograd.profiler._is_profiler_enabled, torch.autograd._profiler_enabled())))
        t.start()
        t.join(timeout=30)
    assert not t.is_alive() and seen == [(True, False)]
    assert torch.autograd.profiler._is_profiler_enabled is False


def test_off_records_nothing_and_shares_one_context():
    a, b = tracing.span("decode.step"), tracing.span("train.micro")
    assert a is b is tracing._OFF
    with a:
        with b:
            pass
    assert tracing.totals() == {}


def test_self_seconds_are_seconds_less_direct_children():
    with _profiled() as prof:
        with tracing.span("outer"):
            time.sleep(0.01)
            for _ in range(2):
                with tracing.span("middle"):
                    time.sleep(0.005)
                    with tracing.span("inner"):
                        time.sleep(0.005)
    t = tracing.totals()
    assert {k: v["count"] for k, v in t.items()} == {"outer": 1, "middle": 2, "inner": 2}
    assert t["inner"]["self_seconds"] == t["inner"]["seconds"]
    assert t["middle"]["self_seconds"] == pytest.approx(
        t["middle"]["seconds"] - t["inner"]["seconds"], rel=1e-9)
    # only direct children count: the inner spans are inside the middle ones
    assert t["outer"]["self_seconds"] == pytest.approx(
        t["outer"]["seconds"] - t["middle"]["seconds"], rel=1e-9)
    assert t["outer"]["self_seconds"] >= 0.01 and t["middle"]["self_seconds"] >= 0.01
    names = _event_names(prof)
    assert names.count("olmoasr.middle") == 2 and "olmoasr.outer" in names
    tracing.reset()
    assert tracing.totals() == {}


def test_greedy_decode_spans():
    model = _new_model(DECODE_DIMS, False, "cpu", torch.float32)
    tm.init_params(model, torch.Generator().manual_seed(0))
    mel = torch.from_numpy(
        (np.random.default_rng(1).standard_normal((2, 80, 3000)) * 0.5).astype(np.float32))
    sample_len = 6
    # the benchmark's prompt, <|startoftranscript|><|notimestamps|>: a prefill
    # of two tokens, which ``single_steps`` leaves out
    options = decoding.DecodingOptions(fp16=False, sample_len=sample_len,
                                       without_timestamps=True)
    steps0 = tm.decode_step.single_steps
    with _profiled() as prof:
        results = decoding.decode(model, mel, options)
    steps = tm.decode_step.single_steps - steps0
    t = tracing.totals()
    assert len(results) == 2 and steps == sample_len - 1
    assert t["decode.step"]["count"] == steps
    assert t["decode.select"]["count"] == sample_len  # once per sampled token
    for name in ("decode.encode", "decode.cross_cache", "decode.prefill", "decode.results"):
        assert t[name]["count"] == 1, name
    names = _event_names(prof)
    assert names.count("olmoasr.decode.step") == steps
    assert names.count("olmoasr.decode.select") == sample_len
    assert "olmoasr.decode.encode" in names and "olmoasr.decode.results" in names
    # tracing off: the same decode records nothing
    tracing.reset()
    decoding.decode(model, mel, options)
    assert tracing.totals() == {}


def test_train_step_spans():
    accum, micro = 2, 2
    config = ttrain.TrainConfig(train_steps=10, eff_batch_size=accum * micro,
                                micro_batch_size=micro, compute_dtype=torch.float32)
    state = ttrain.init_train_state(0, TRAIN_DIMS, config, device="cpu")
    step = ttrain.make_train_step(TRAIN_DIMS, config)
    rng = np.random.default_rng(0)
    T = TRAIN_DIMS.n_text_ctx
    batch = {
        "mel": torch.from_numpy(rng.standard_normal(
            (accum, micro, 80, 2 * TRAIN_DIMS.n_audio_ctx)).astype(np.float32)),
        "text_input": torch.from_numpy(rng.integers(0, 50000, (accum, micro, T)).astype(np.int32)),
        "text_target": torch.from_numpy(rng.integers(0, 50000, (accum, micro, T)).astype(np.int32)),
        "padding_mask": torch.zeros(accum, micro, T),
    }
    with _profiled() as prof:
        state, metrics = step(state, batch)
    assert np.isfinite(float(metrics["loss"]))
    t = tracing.totals()
    assert t["train.micro"]["count"] == accum and t["train.update"]["count"] == 1
    names = _event_names(prof)
    assert names.count("olmoasr.train.micro") == accum and "olmoasr.train.update" in names
    tracing.reset()
    step(state, batch)
    assert tracing.totals() == {}


class _Rows:
    """A dataset of ``n`` one-row samples that notes the thread fetching each."""

    def __init__(self, n):
        self.n, self.epoch, self.threads = n, 0, []

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        self.threads.append(threading.get_ident())
        return {"mel": np.full((2,), i, np.float32), "text_input": np.zeros(3, np.int32),
                "text_target": np.zeros(3, np.int32), "padding_mask": np.zeros(3, np.float32)}


def _wait_for(cond, seconds=30.0):
    end = time.monotonic() + seconds
    while not cond():
        assert time.monotonic() < end, "timed out"
        time.sleep(0.005)


def test_loader_spans_from_the_producer_thread():
    """With ``prefetch=2`` the producer assembles the batch taken, two
    queued and one waiting to be queued: four ``loader.batch`` spans on its
    thread while the main thread profiles, none in the kineto trace (another
    thread's), and none once the profiler has exited."""
    rows = _Rows(12)
    loader = BatchLoader(rows, micro_batch_size=1, shuffle=False, prefetch=2)
    it = iter(loader)
    with _profiled() as prof:
        first = next(it)
        _wait_for(lambda: tracing.totals().get("loader.batch", {}).get("count") == 4)
    assert first["mel"][0, 0, 0] == 0
    assert set(rows.threads) and threading.get_ident() not in rows.threads
    assert "olmoasr.loader.batch" not in _event_names(prof)
    tracing.reset()
    rest = list(it)
    assert len(rest) == 11 and len(rows.threads) == 12
    assert tracing.totals() == {}


def test_totals_hold_every_span_of_many_threads():
    """More threads than cores, switching often: no count is lost."""
    n_threads, n_spans = 16, 200
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n_spans):
                with tracing.span("outer"):
                    with tracing.span("inner"):
                        pass

        with _profiled():
            threads = [threading.Thread(target=work) for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    t = tracing.totals()
    assert t["outer"]["count"] == t["inner"]["count"] == n_threads * n_spans
    assert t["outer"]["self_seconds"] == pytest.approx(
        t["outer"]["seconds"] - t["inner"]["seconds"], rel=1e-6, abs=1e-9)
