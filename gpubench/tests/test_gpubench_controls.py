"""The controls on the card, at published widths and a batch a test run
holds: each cell's control (the reference with its products in fp8 in the
program's place) comes out not correct under the cell's
limits, where the program itself comes out correct. At the cells' own
sizes the controls are read with ``gpubench/run.py --control`` (PERF.md)."""

import json
import os

import pytest

from gpubench import core
from gpubench_micro import micro_cell

SEEDS = (2 ** 31 + 101, 2 ** 32 + 7, 3)


def _dims(name):
    return json.load(open(os.path.join(core.HERE, "configs", f"{name}.json")))["dims"]


CASES = [
    ("short-small-b128", "small.en", dict(batch=16, check_windows=6), "fp8"),
    ("short-large-int8-b128", "large.en-v2", dict(batch=16, check_windows=6), "fp8"),
    ("train-small-mb16x2", "small.en", dict(samples=8, micro=2, accum=2, ref_chunk=2), "fp8"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("workload,config,traffic,control", CASES,
                         ids=[c[0] for c in CASES])
def test_control_fails_where_the_program_passes(cuda, workload, config, traffic, control):
    cell = micro_cell(workload, dims=_dims(config), **traffic)
    if cell.traffic["kind"] == "transcribe":
        cell.traffic["decode"]["sample_len"] = 64
    for seed in SEEDS:
        assert core.run(cell, seed, 0.5, False, device=cuda)["correct"] is True
        out = core.run(cell, seed, 0.5, False, device=cuda, control=[control])
        checked = {k: v["value"] for k, v in out["check"].items()}
        limits = {k: v["limit"] for k, v in cell.limits["numbers"].items()}
        assert any(checked[k] > limits[k] for k in limits), (checked, limits)
