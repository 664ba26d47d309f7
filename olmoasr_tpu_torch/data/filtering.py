"""Filtering and sampling of tagged data.

Rebuild of the reference's ``scripts/data/filtering/process_tagged_data.py``:
a YAML filter pipeline interpreted by entry type — boolean equality (223),
categorical in/not_in (237), numeric bounds (266) — plus seg_content regex
cleaning (speaker labels, HTML entities, 304-347), short-circuit per-tag
hitlists (478-536), a seeded subsample (rng 42, 457-475), essential-key
projection (406-419), and report generation (569-668).

YAML schema (configs/data_configs/filtering/*.yaml): ordered list of
``{tag, ref_value | values | bounds | comparison}`` entries.

A copy of ``olmoasr_tpu/data/filtering.py``: the port imports nothing of the
JAX package, and ``tests/test_torch_data_pipeline.py`` pins the copy to the
original.
"""

from __future__ import annotations

import gzip
import json
import os
import re
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

# keys kept in the output rows (process_tagged_data.py:406-419)
ESSENTIAL_KEYS = [
    "id", "seg_id", "subtitle_file", "audio_file", "seg_content",
    "text_timestamp", "audio_timestamp", "norm_end", "ts_mode", "no_ts_mode",
    "only_no_ts_mode", "num_tokens_no_ts_mode", "num_tokens_ts_mode",
]

_SPEAKER_PATTERN = r"[ ]*(?:[A-Z][a-zA-Z]*[ ])+:[ ]*"
_HTML_ENTITIES = r"[ ]*(?:&nbsp;|&amp;|&lt;|&gt;|=|\.{3}|\\h)+[ ]*"
_CLEAN_RE = re.compile(f"{_SPEAKER_PATTERN}|{_HTML_ENTITIES}")


def clean_seg_content(content: str) -> Tuple[str, int]:
    """Strip speaker labels / HTML entities from cue texts; returns the cleaned
    content and 1 if anything changed (process_tagged_data.py:304-347)."""
    modified = 0
    out_lines = []
    for line in content.splitlines():
        if "-->" in line or line.strip() in ("WEBVTT", "") or line.strip().isdigit():
            out_lines.append(line)
            continue
        cleaned = _CLEAN_RE.sub(" ", line)
        if cleaned != line:
            modified = 1
        out_lines.append(cleaned)
    return "\n".join(out_lines), modified


@dataclass(frozen=True)
class FilterRule:
    tag: str
    ref_value: Any = None  # boolean / categorical equality
    values: Optional[Tuple[Any, ...]] = None  # categorical in-list
    not_values: Optional[Tuple[Any, ...]] = None  # categorical not-in
    bounds: Optional[Tuple[Optional[float], Optional[float]]] = None  # numeric
    comparison: Optional[str] = None  # 'lt' | 'le' | 'gt' | 'ge' | 'eq'

    def passes(self, value: Any) -> bool:
        if self.values is not None:
            return value in self.values
        if self.not_values is not None:
            return value not in self.not_values
        if self.bounds is not None:
            lo, hi = self.bounds
            v = float(value)
            if lo is not None and v < lo:
                return False
            if hi is not None and v > hi:
                return False
            return True
        if self.comparison is not None:
            v, r = float(value), float(self.ref_value)
            return {
                "lt": v < r, "le": v <= r, "gt": v > r, "ge": v >= r, "eq": v == r,
            }[self.comparison]
        return value == self.ref_value


def load_filter_config(path: str) -> List[FilterRule]:
    """YAML pipeline (ordered) -> FilterRules
    (configs/data_configs/filtering/*.yaml interpreted by
    process_tagged_data.py:478-536)."""
    import yaml

    with open(path) as f:
        cfg = yaml.safe_load(f)
    entries = cfg.get("filters") if isinstance(cfg, dict) else cfg
    rules = []
    for e in entries:
        rules.append(
            FilterRule(
                tag=e["tag"],
                ref_value=e.get("ref_value"),
                values=tuple(e["values"]) if "values" in e else None,
                not_values=tuple(e["not_values"]) if "not_values" in e else None,
                bounds=tuple(e["bounds"]) if "bounds" in e else None,
                comparison=e.get("comparison"),
            )
        )
    return rules


def filter_row(
    row: Dict[str, Any], rules: Sequence[FilterRule]
) -> Tuple[bool, Optional[str]]:
    """Short-circuit per-tag filtering; returns (keep, first_failing_tag)."""
    for rule in rules:
        if rule.tag not in row:
            return False, f"missing:{rule.tag}"
        if not rule.passes(row[rule.tag]):
            return False, rule.tag
    return True, None


def process_single_jsonl_file(
    path: str,
    out_dir: str,
    rules: Sequence[FilterRule],
    *,
    clean_content: bool = True,
    subsample: Optional[float] = None,
    seed: int = 42,
    keep_keys: Optional[Sequence[str]] = None,
) -> Dict[str, Any]:
    """Filter one shard (process_tagged_data.py:350-475)."""
    rng = np.random.default_rng(seed)
    opener = gzip.open if path.endswith(".gz") else open
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, os.path.basename(path))
    out_opener = gzip.open if out_path.endswith(".gz") else open

    stats: Dict[str, Any] = {"rows": 0, "kept": 0, "cleaned": 0, "subsampled_out": 0}
    hitlist: Dict[str, int] = {}
    keep_keys = list(keep_keys or ESSENTIAL_KEYS)

    with opener(path, "rt", encoding="utf-8") as fin, out_opener(
        out_path, "wt", encoding="utf-8"
    ) as fout:
        for line in fin:
            if not line.strip():
                continue
            stats["rows"] += 1
            row = json.loads(line)
            keep, failed = filter_row(row, rules)
            if not keep:
                hitlist[failed] = hitlist.get(failed, 0) + 1
                continue
            if subsample is not None and rng.random() > subsample:
                stats["subsampled_out"] += 1
                continue
            if clean_content and "seg_content" in row:
                row["seg_content"], changed = clean_seg_content(row["seg_content"])
                stats["cleaned"] += changed
            out = {k: row[k] for k in keep_keys if k in row}
            fout.write(json.dumps(out) + "\n")
            stats["kept"] += 1
    stats["filter_hitlist"] = hitlist
    return stats


def main(
    jsonl_paths: Sequence[str],
    out_dir: str,
    filter_config: str,
    *,
    subsample: Optional[float] = None,
    num_workers: int = 0,
) -> Dict[str, Any]:
    """Multi-shard entry point and report (process_tagged_data.py:671-940)."""
    rules = load_filter_config(filter_config)
    if num_workers > 0:
        import multiprocessing as mp
        from functools import partial

        with mp.Pool(num_workers) as pool:
            all_stats = pool.map(
                partial(
                    process_single_jsonl_file, out_dir=out_dir, rules=rules,
                    subsample=subsample,
                ),
                jsonl_paths,
            )
    else:
        all_stats = [
            process_single_jsonl_file(p, out_dir, rules, subsample=subsample)
            for p in jsonl_paths
        ]

    report: Dict[str, Any] = {"rows": 0, "kept": 0, "filter_hitlist": {}}
    for s in all_stats:
        report["rows"] += s["rows"]
        report["kept"] += s["kept"]
        for k, v in s["filter_hitlist"].items():
            report["filter_hitlist"][k] = report["filter_hitlist"].get(k, 0) + v
    report["keep_rate"] = report["kept"] / max(report["rows"], 1)
    with open(os.path.join(out_dir, "filtering_report.json"), "w") as f:
        json.dump(report, f, indent=2)
    return report


if __name__ == "__main__":
    import argparse
    import glob as _glob
    import json as _json

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--tagged", required=True, help="glob of tagged JSONL shards")
    p.add_argument("--filter_config", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--subsample", type=float, default=None)
    p.add_argument("--num_workers", type=int, default=0)
    a = p.parse_args()
    stats = main(
        sorted(_glob.glob(a.tagged)), a.out_dir, a.filter_config,
        subsample=a.subsample, num_workers=a.num_workers,
    )
    print(_json.dumps(stats, default=str)[:2000])
