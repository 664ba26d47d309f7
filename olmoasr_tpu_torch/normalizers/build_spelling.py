"""Materialize the reconstructed British->American spelling mapping as
``olmoasr_tpu_torch/assets/english.json`` (the filename whisper ships; reference
use: scripts/eval/eval.py:50 via whisper.normalizers.EnglishTextNormalizer).

The mapping is the union of the audited rule families and the irregular
table in ``english.py`` (2.3k entries). Dropping in the real upstream asset
(via $OLMOASR_SPELLING_JSON or by overwriting the generated file) gives
exact parity; ``tests/test_normalizers.py`` keeps the generated file in
sync with the code tables.

Run: python -m olmoasr_tpu_torch.normalizers.build_spelling

A copy of ``olmoasr_tpu/normalizers/build_spelling.py`` that writes the
port's asset.
"""

from __future__ import annotations

import json
import os

from olmoasr_tpu_torch.normalizers.english import (
    _BUILTIN_SPELLINGS,
    _generated_spellings,
)


def build_mapping() -> dict:
    mapping = dict(_BUILTIN_SPELLINGS)
    mapping.update(_generated_spellings())
    return dict(sorted(mapping.items()))


def main() -> None:
    out = os.path.join(os.path.dirname(__file__), "..", "assets", "english.json")
    mapping = build_mapping()
    with open(out, "w", encoding="utf-8") as f:
        json.dump(mapping, f, indent=1, ensure_ascii=False)
    print(f"wrote {len(mapping)} entries to {os.path.abspath(out)}")


if __name__ == "__main__":
    main()
