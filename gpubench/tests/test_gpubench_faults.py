"""A run with its timed path broken underneath comes out not correct: the
harness's look for a card skipped, the rest of a run driven at a size a
CPU test run holds (gpubench_micro), the cell's own limits, one case for
each fault the cell can have (one chip: no exchange between chips). The
cross-attention's faults show only at published widths: they run on the
card (marked ``gpu``)."""

import json
import os

import numpy as np
import pytest
import torch

from gpubench import core
from gpubench_micro import micro_cell

SEED = 2 ** 31 + 77


def _run(cell):
    return core.run(cell, SEED, 0.3, False, device="cpu", log=lambda *a, **k: None)


def test_sound_micro_runs_are_correct():
    for workload in ("short-small-b128", "short-large-int8-b128", "train-small-mb16x2"):
        assert _run(micro_cell(workload))["correct"] is True, workload


def _token_altered(monkeypatch):
    from olmoasr_tpu_torch import decoding

    def tenth_best(filt, temperature, generator):
        return filt.topk(10, dim=-1).indices[:, 9]

    monkeypatch.setattr(decoding, "_next_tokens", tenth_best)


def _state_unchanged(monkeypatch):
    from olmoasr_tpu_torch.models import whisper as wm

    original = wm.decode_step

    def step(model, tokens, cache, *args, **kwargs):
        index = cache.index
        out = original(model, tokens, cache, *args, **kwargs)
        if tokens.shape[1] == 1:
            cache.index = index  # the cache does not advance
            step.single_steps += 1
        return out

    step.single_steps = 0
    monkeypatch.setattr(wm, "decode_step", step)


def _half_batch(monkeypatch):
    from olmoasr_tpu_torch import decoding

    original = decoding._decode_sample

    def half(model, mel, *args, **kwargs):
        h = mel.shape[0] // 2
        tokens, lp, probs, feats = original(model, mel[:h], *args, **kwargs)
        twice = lambda t: torch.cat([t, t[:mel.shape[0] - h]])  # noqa: E731
        return twice(tokens), twice(lp), twice(probs), twice(feats)

    monkeypatch.setattr(decoding, "_decode_sample", half)


def _patch_cache(monkeypatch, change):
    from olmoasr_tpu_torch.models import whisper as wm

    original = wm.init_cache

    def init_cache(*args, **kwargs):
        cache = original(*args, **kwargs)
        change(cache)
        return cache

    monkeypatch.setattr(wm, "init_cache", init_cache)


def _cross_neighbour(monkeypatch):
    """Each row's cross-attention reads the next window's cross K/V."""

    def roll(cache):
        for name in ("cross_k", "cross_v", "cross_k_scale", "cross_v_scale"):
            setattr(cache, name, getattr(cache, name).roll(1, dims=1))

    _patch_cache(monkeypatch, roll)


def _scales_ignored(monkeypatch):
    """The int8 cross K/V read without their per-position scales."""

    def ones(cache):
        cache.cross_k_scale.fill_(1.0)
        cache.cross_v_scale.fill_(1.0)

    _patch_cache(monkeypatch, ones)


TRANSCRIBE_FAULTS = [
    (w, f, i) for w in ("short-small-b128", "short-large-int8-b128")
    for f, i in [(_token_altered, "token_altered"), (_state_unchanged, "state_unchanged"),
                 (_half_batch, "half_batch")]
] + [("short-large-int8-b128", _scales_ignored, "scales_ignored")]


@pytest.mark.parametrize("workload,fault", [c[:2] for c in TRANSCRIBE_FAULTS],
                         ids=[f"{i}-{w}" for w, _, i in TRANSCRIBE_FAULTS])
def test_transcribe_fault(workload, fault, monkeypatch):
    fault(monkeypatch)
    assert _run(micro_cell(workload))["correct"] is False


CROSS_FAULTS = [("short-small-b128", "small.en", _cross_neighbour, "cross_neighbour"),
                ("short-large-int8-b128", "large.en-v2", _cross_neighbour, "cross_neighbour"),
                ("short-large-int8-b128", "large.en-v2", _scales_ignored, "scales_ignored")]


@pytest.mark.gpu
@pytest.mark.parametrize("workload,config,fault", [c[:3] for c in CROSS_FAULTS],
                         ids=[f"{i}-{w}" for w, _, _, i in CROSS_FAULTS])
def test_cross_attention_fault_on_card(cuda, workload, config, fault, monkeypatch):
    """The cross-attention's faults at published widths, 32 windows a batch:
    at the micro size the seeded cross-attention is too flat for a row that
    reads its neighbour's window to show, at the real widths it is not."""
    dims = json.load(open(os.path.join(core.HERE, "configs", f"{config}.json")))["dims"]
    cell = micro_cell(workload, dims=dims, batch=32, pool_batches=1, check_windows=12)
    cell.traffic["decode"] = dict(cell.traffic["decode"], sample_len=128)
    fault(monkeypatch)
    for seed in (SEED, 2 ** 32 + 19, 5):
        out = core.run(cell, seed, 0.1, False, device=cuda, log=lambda *a, **k: None)
        assert out["correct"] is False, (seed, out["check"])


def _train_state_unchanged(monkeypatch):
    from olmoasr_tpu_torch.training import train as tm

    original = tm.make_optimizer

    def frozen(config, params):
        opt = original(config, params)
        opt.step = lambda closure=None: None
        return opt

    monkeypatch.setattr(tm, "make_optimizer", frozen)


def _train_half_batch(monkeypatch):
    from olmoasr_tpu_torch.training import train as tm

    original = tm.loss_fn

    def half(model, mel, text_input, text_target, padding_mask, **kwargs):
        h = mel.shape[0] // 2
        return original(model, mel[:h], text_input[:h], text_target[:h],
                        None if padding_mask is None else padding_mask[:h], **kwargs)

    monkeypatch.setattr(tm, "loss_fn", half)


def _train_token_altered(monkeypatch):
    from olmoasr_tpu_torch.training import dataset as ds

    original = ds.AudioTextDataset.__getitem__

    def shifted(self, index):
        item = original(self, index)
        item["text_target"] = np.roll(item["text_target"], -1)
        return item

    monkeypatch.setattr(ds.AudioTextDataset, "__getitem__", shifted)


@pytest.mark.parametrize("workload", ["train-small-mb16x2", "train-large-mb32x2"])
@pytest.mark.parametrize("fault", [_train_state_unchanged, _train_half_batch,
                                   _train_token_altered],
                         ids=["state_unchanged", "half_batch", "token_altered"])
def test_train_fault(workload, fault, monkeypatch):
    fault(monkeypatch)
    assert _run(micro_cell(workload))["correct"] is False
