"""Paper-style figures & tables from eval results.

The reference keeps these in notebooks (``notebooks/paper_figs*`` — WER bar
charts, model-size scaling curves, OLMoASR-vs-Whisper comparison tables);
this module renders the same artifacts from the JSON results that
``olmoasr_tpu_torch.eval.harness.write_results`` emits.

Usage:
  python -m olmoasr_tpu_torch.eval.figures --results eval_results/*.json \
      --out_dir figures/

A copy of ``olmoasr_tpu/eval/figures.py`` (matplotlib is imported only to
draw); ``tests/test_torch_eval.py`` pins it to the original.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional

#: published short-form WER (%) rows for the comparison columns
#: (BASELINE.md <- reference README.md:156-174)
PUBLISHED = {
    "librispeech_clean": {"tiny.en": 5.1, "base.en": 3.7, "small.en": 3.0,
                          "medium.en": 3.5, "large.en": 2.6},
    "librispeech_other": {"tiny.en": 12.3, "base.en": 9.0, "small.en": 7.0,
                          "medium.en": 5.7, "large.en": 5.9},
    "tedlium": {"tiny.en": 5.5, "base.en": 4.6, "small.en": 4.2,
                "medium.en": 5.0, "large.en": 4.5},
    "wsj": {"tiny.en": 5.6, "base.en": 4.3, "small.en": 3.8,
            "medium.en": 3.6, "large.en": 3.7},
    "artie": {"tiny.en": 19.3, "base.en": 13.6, "small.en": 9.6,
              "medium.en": 7.5, "large.en": 7.9},
    "fleurs": {"tiny.en": 9.7, "base.en": 6.7, "small.en": 5.0,
               "medium.en": 4.4, "large.en": 4.5},
    "voxpopuli": {"tiny.en": 11.6, "base.en": 9.7, "small.en": 8.7,
                  "medium.en": 8.4, "large.en": 8.1},
}


def load_results(patterns: List[str]) -> List[Dict]:
    rows = []
    for pat in patterns:
        for path in sorted(glob.glob(pat)):
            with open(path) as f:
                d = json.load(f)
            if "wer" in d and "eval_set" in d:
                d["_file"] = os.path.basename(path)
                rows.append(d)
    return rows


def wer_table(rows: List[Dict], variant: Optional[str] = None) -> str:
    """Markdown table: eval set | measured WER | published | delta."""
    lines = [
        "| eval set | WER % (ours) | published % | delta | n |",
        "|---|---|---|---|---|",
    ]
    for r in sorted(rows, key=lambda r: r["eval_set"]):
        pub = PUBLISHED.get(r["eval_set"], {}).get(variant) if variant else None
        wer = r["wer"] * 100
        pub_s = f"{pub:.1f}" if pub is not None else "—"
        d_s = f"{wer - pub:+.2f}" if pub is not None else "—"
        lines.append(
            f"| {r['eval_set']} | {wer:.2f} | {pub_s} | {d_s} | "
            f"{r.get('n_samples', '?')} |"
        )
    return "\n".join(lines)


def wer_bar_chart(rows: List[Dict], out_path: str,
                  variant: Optional[str] = None) -> Optional[str]:
    """Grouped bar chart (ours vs published), like the paper's fig 2."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None

    rows = sorted(rows, key=lambda r: r["eval_set"])
    names = [r["eval_set"] for r in rows]
    ours = [r["wer"] * 100 for r in rows]
    pub = [
        PUBLISHED.get(n, {}).get(variant) if variant else None for n in names
    ]
    x = range(len(names))
    fig, ax = plt.subplots(figsize=(max(6, len(names) * 1.1), 4))
    ax.bar([i - 0.2 for i in x], ours, width=0.4, label="OLMoASR-TPU")
    if any(p is not None for p in pub):
        ax.bar(
            [i + 0.2 for i in x], [p or 0 for p in pub], width=0.4,
            label=f"published ({variant})",
        )
    ax.set_xticks(list(x))
    ax.set_xticklabels(names, rotation=30, ha="right")
    ax.set_ylabel("WER (%)")
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--results", nargs="+", required=True,
                    help="glob(s) of harness result .json files")
    ap.add_argument("--variant", default=None,
                    help="variant name for published-baseline columns")
    ap.add_argument("--out_dir", default="figures")
    args = ap.parse_args(argv)

    rows = load_results(args.results)
    if not rows:
        raise SystemExit("no result json files matched")
    os.makedirs(args.out_dir, exist_ok=True)
    table = wer_table(rows, args.variant)
    with open(os.path.join(args.out_dir, "wer_table.md"), "w") as f:
        f.write(table + "\n")
    print(table)
    fig = wer_bar_chart(
        rows, os.path.join(args.out_dir, "wer_comparison.png"), args.variant
    )
    if fig:
        print(f"figure -> {fig}")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
