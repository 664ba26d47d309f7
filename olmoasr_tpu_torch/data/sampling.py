"""Reservoir sampling of numeric tags -> percentile tables.

Rebuild of the reference's ``scripts/data/filtering/reservoir_sample.py``:
sample a numeric tag's distribution across JSONL shards without loading
everything, then report percentiles to pick filter thresholds.

A copy of ``olmoasr_tpu/data/sampling.py``: the port imports nothing of the
JAX package, and ``tests/test_torch_data_pipeline.py`` pins the copy to the
original.
"""

from __future__ import annotations

import gzip
import json
from typing import Dict, List, Optional, Sequence

import numpy as np


def reservoir_sample_file(
    path: str, tag: str, k: int, seed: int = 0
) -> List[float]:
    """Classic reservoir sampling of one shard's tag values
    (reservoir_sample.py:135-247)."""
    rng = np.random.default_rng(seed)
    reservoir: List[float] = []
    n = 0
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt", encoding="utf-8") as f:
        for line in f:
            if not line.strip():
                continue
            row = json.loads(line)
            if tag not in row:
                continue
            try:
                v = float(row[tag])
            except (TypeError, ValueError):
                continue
            n += 1
            if len(reservoir) < k:
                reservoir.append(v)
            else:
                j = rng.integers(0, n)
                if j < k:
                    reservoir[j] = v
    return reservoir


def calculate_percentiles(
    values: Sequence[float],
    percentiles: Sequence[float] = (1, 5, 10, 25, 50, 75, 90, 95, 99),
) -> Dict[str, float]:
    """reservoir_sample.py:249-357 percentile table."""
    if not values:
        return {}
    arr = np.asarray(values, dtype=np.float64)
    out = {f"p{p}": float(np.percentile(arr, p)) for p in percentiles}
    out.update(
        {"min": float(arr.min()), "max": float(arr.max()),
         "mean": float(arr.mean()), "n": len(arr)}
    )
    return out


def main(
    jsonl_paths: Sequence[str],
    tag: str,
    *,
    k_per_shard: int = 10_000,
    num_workers: int = 0,
    out_path: Optional[str] = None,
) -> Dict[str, float]:
    """Parallel entry point (reservoir_sample.py:359-550)."""
    if num_workers > 0:
        import multiprocessing as mp
        from functools import partial

        with mp.Pool(num_workers) as pool:
            chunks = pool.map(
                partial(reservoir_sample_file, tag=tag, k=k_per_shard), jsonl_paths
            )
    else:
        chunks = [reservoir_sample_file(p, tag, k_per_shard) for p in jsonl_paths]
    values = [v for c in chunks for v in c]
    table = calculate_percentiles(values)
    if out_path:
        with open(out_path, "w") as f:
            json.dump(table, f, indent=2)
    return table
