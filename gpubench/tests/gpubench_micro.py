"""Cells of the benchmark cut to a size that a CPU test run can hold: the
real cell's files, its widths replaced by a one-layer model of width 64."""

import copy

from gpubench import core

MICRO = {"n_mels": 80, "n_audio_ctx": 1500, "n_audio_state": 64, "n_audio_head": 2,
         "n_audio_layer": 1, "n_vocab": 51864, "n_text_ctx": 448, "n_text_state": 64,
         "n_text_head": 2, "n_text_layer": 1}

TRANSCRIBE = dict(batch=4, pool_batches=1, check_windows=3, warmup_units=1)
TRAIN = dict(samples=8, micro=2, accum=2, ref_chunk=1, check_steps=2)


def micro_cell(workload: str, dims=None, **traffic):
    cell = core.load_cell(workload)
    cell.config = dict(cell.config, dims=dims or MICRO)
    t = copy.deepcopy(cell.traffic)
    if t["kind"] == "transcribe":
        t.update(TRANSCRIBE)
        t["decode"] = dict(t["decode"], sample_len=8)
    else:
        t.update(TRAIN)
    t.update(traffic)
    cell.traffic = t
    return cell
