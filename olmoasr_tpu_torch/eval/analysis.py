"""Result analysis: bootstrap error bars and WER comparison tables.

Rebuild of ``notebooks/gen_error_bars.py`` (and the paper-table
notebooks) as an importable module + CLI: read the per-sample CSVs the eval
harness writes and produce mean WER with 95% bootstrap confidence intervals,
plus cross-model comparison tables.

A copy of ``olmoasr_tpu/eval/analysis.py`` over the port's harness;
``tests/test_torch_eval.py`` pins it to the original.
"""

from __future__ import annotations

import csv
import glob
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from olmoasr_tpu_torch.eval.harness import bootstrap_ci


def read_per_sample_csv(path: str) -> List[float]:
    wers: List[float] = []
    with open(path, encoding="utf-8") as f:
        for row in csv.DictReader(f):
            try:
                wers.append(float(row["wer"]))
            except (KeyError, ValueError):
                continue
    return wers


def error_bars_for_run(
    results_dir: str, n_boot: int = 1000, seed: int = 0
) -> Dict[str, Dict[str, float]]:
    """One row per eval set: mean per-sample WER + bootstrap 95% CI."""
    out: Dict[str, Dict[str, float]] = {}
    for path in sorted(glob.glob(os.path.join(results_dir, "*_per_sample.csv"))):
        name = os.path.basename(path).replace("_per_sample.csv", "")
        wers = read_per_sample_csv(path)
        if not wers:
            continue
        lo, hi = bootstrap_ci(wers, n_boot=n_boot, seed=seed)
        out[name] = {
            "mean_wer": float(np.mean(wers)),
            "ci_low": lo,
            "ci_high": hi,
            "n": len(wers),
        }
    return out


def comparison_table(
    run_dirs: Dict[str, str], out_path: Optional[str] = None
) -> str:
    """Markdown table of corpus WER per eval set across runs (README-style,
    reference README.md:156-187)."""
    rows: Dict[str, Dict[str, float]] = {}
    for run_name, d in run_dirs.items():
        for path in sorted(glob.glob(os.path.join(d, "*.json"))):
            with open(path) as f:
                r = json.load(f)
            if "eval_set" not in r:
                continue
            rows.setdefault(r["eval_set"], {})[run_name] = r["wer"] * 100
    runs = list(run_dirs)
    lines = ["| eval set | " + " | ".join(runs) + " |",
             "|---|" + "---|" * len(runs)]
    for eval_set in sorted(rows):
        cells = [f"{rows[eval_set].get(r, float('nan')):.1f}" for r in runs]
        lines.append(f"| {eval_set} | " + " | ".join(cells) + " |")
    if rows:
        avgs = [
            f"{np.nanmean([rows[s].get(r, np.nan) for s in rows]):.1f}" for r in runs
        ]
        lines.append("| **Average** | " + " | ".join(avgs) + " |")
    table = "\n".join(lines)
    if out_path:
        with open(out_path, "w") as f:
            f.write(table + "\n")
    return table


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--results_dir", required=True)
    p.add_argument("--n_boot", type=int, default=1000)
    a = p.parse_args()
    print(json.dumps(error_bars_for_run(a.results_dir, a.n_boot), indent=2))
