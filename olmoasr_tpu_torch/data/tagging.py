"""Document-level data tagging.

Rebuild of the reference's ``scripts/data/filtering/data_tagger.py``: a
YAML-driven pipeline that walks gzip JSONL shards and attaches quality tags to
each document (video) or segment:

  * ``has_comma_period`` — transcript contains both ',' and '.' (551)
  * ``casing`` — upper/lower/mixed with the 0.6 adjustment rules (440-528)
  * ``repeating_lines`` — consecutive-cue containment repetition (582-637)
  * ``edit_dist`` — manual-vs-machine WER with normalizer fallbacks (289-391)
  * ``text_lang`` — text language id (394-437; pycld2 in the reference, a
    self-contained stopword/character-profile classifier here, pycld2 used
    when importable)
  * ``has_proper_cap_after_punct_line`` — capitalization after sentence
    punctuation (640-680)
  * ``num_words`` (682-700)

Tags append to each JSONL row; per-shard stats aggregate into a report
(948-1047).

A copy of ``olmoasr_tpu/data/tagging.py`` on the port's own
``data.transcripts``, ``eval.wer`` and ``normalizers``: the port imports
nothing of the JAX package, and ``tests/test_torch_data_pipeline.py`` pins the
copy to the original.
"""

from __future__ import annotations

import gzip
import json
import os
import re
import string
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from olmoasr_tpu_torch.data.transcripts import TranscriptReader
from olmoasr_tpu_torch.eval.wer import wer as _wer

UPPER = set(string.ascii_uppercase)
LOWER = set(string.ascii_lowercase)


# --- content access ---------------------------------------------------------


@dataclass
class Cue:
    text: str


def cues_from_row(row: Dict[str, Any]) -> List[Cue]:
    """Parse the row's transcript content into cue texts."""
    content = row.get("seg_content") or row.get("content") or ""
    ext = row.get("ext", "vtt")
    transcript, _, _ = TranscriptReader(transcript_string=content, ext=ext).read()
    return [Cue(t) for t in transcript.values()]


def row_length(row: Dict[str, Any]) -> float:
    return float(row.get("length") or row.get("norm_end") or 0.0)


# --- tag functions ----------------------------------------------------------


def tag_has_comma_period(cues: Sequence[Cue]) -> bool:
    has_period = has_comma = False
    for c in cues:
        has_period = has_period or "." in c.text
        has_comma = has_comma or "," in c.text
        if has_period and has_comma:
            return True
    return False


def _cue_casing(text: str) -> str:
    if not text.strip():
        return "mixed"
    chars = set(text)
    has_upper = bool(UPPER & chars)
    has_lower = bool(LOWER & chars)
    if has_upper and has_lower:
        return "mixed"
    return "upper" if has_upper else "lower"


def tag_casing(cues: Sequence[Cue]) -> str:
    counts = {"upper": 0, "lower": 0, "mixed": 0}
    for c in cues:
        counts[_cue_casing(c.text)] += 1
    max_count = max(counts.values()) if counts else 0
    if max_count == 0:
        return "mixed"
    max_keys = [k for k, v in counts.items() if v == max_count]
    if len(max_keys) == 1:
        dominant = max_keys[0]
        # the reference's 0.6 adjustment rules (data_tagger.py:505-528)
        if dominant == "lower" and counts["mixed"] / max_count > 0.6:
            return "mixed"
        if dominant == "mixed" and counts["upper"] / max_count > 0.6:
            return "upper"
        return dominant
    return "mixed" if "mixed" in max_keys else max_keys[0]


def tag_repeating_lines(cues: Sequence[Cue]) -> bool:
    prev: Optional[str] = None
    for c in cues:
        if prev is not None and prev in c.text:
            if len(c.text.strip().split()) > 1 and len(prev.strip().split()) > 1:
                return True
        prev = c.text
    return False


def tag_proper_capitalization(cues: Sequence[Cue]) -> bool:
    punct_end = re.compile(r"[.!?](?:\s*)$")
    for i in range(1, len(cues)):
        if punct_end.search(cues[i - 1].text):
            cur = cues[i].text.strip()
            if cur and cur[0].isalpha() and not cur[0].isupper():
                return False
    return True


def tag_num_words(cues: Sequence[Cue]) -> int:
    return sum(len(c.text.strip().split()) for c in cues)


def tag_edit_dist(row: Dict[str, Any], normalizer=None) -> float:
    """Manual-vs-machine WER with the reference's normalize-fallback ladder
    (data_tagger.py:289-391)."""
    if normalizer is None:
        from olmoasr_tpu_torch.normalizers import EnglishTextNormalizer

        normalizer = EnglishTextNormalizer()
    manual = (row.get("man_text") or row.get("seg_content") or "").strip()
    machine = (row.get("mach_text") or "").strip()

    def safe_norm(t):
        try:
            return normalizer(t).strip()
        except Exception:
            return t

    nm, nc = safe_norm(manual), safe_norm(machine)
    if nm != "":
        return _wer(nm, nc)
    if manual == "":
        if nc != "":
            return _wer(nc, manual)
        if machine != "":
            return _wer(machine, manual)
        return 0.0
    return _wer(manual, nc)


# --- language id ------------------------------------------------------------

_EN_STOPWORDS = {
    "the", "and", "to", "of", "a", "in", "is", "it", "you", "that", "was",
    "for", "on", "are", "with", "as", "i", "his", "they", "be", "at", "have",
    "this", "from", "or", "had", "by", "not", "but", "what", "we", "can",
    "out", "were", "all", "there", "when", "your", "how", "so", "no", "if",
    "about", "just", "like", "know", "going", "get", "do", "he", "she",
}


def detect_text_language(text: str) -> str:
    """Text language id. Uses pycld2 when present (the reference's choice,
    data_tagger.py:36,422); otherwise a self-contained classifier:
    non-Latin-script detection + English stopword density."""
    try:
        import pycld2 as cld2  # type: ignore

        *_, details = cld2.detect(text)
        return details[0][1]
    except Exception:
        pass

    if not text.strip():
        return "un"
    # script profile
    n_alpha = sum(c.isalpha() for c in text)
    if n_alpha == 0:
        return "un"
    n_latin = sum(("a" <= c.lower() <= "z") for c in text)
    if n_latin / n_alpha < 0.5:
        # dominant non-Latin script: classify by unicode block of the mode char
        for c in text:
            o = ord(c)
            if 0x4E00 <= o <= 0x9FFF:
                return "zh"
            if 0x3040 <= o <= 0x30FF:
                return "ja"
            if 0xAC00 <= o <= 0xD7AF:
                return "ko"
            if 0x0400 <= o <= 0x04FF:
                return "ru"
            if 0x0600 <= o <= 0x06FF:
                return "ar"
            if 0x0900 <= o <= 0x097F:
                return "hi"
        return "un"
    words = re.findall(r"[a-z']+", text.lower())
    if not words:
        return "un"
    hits = sum(w in _EN_STOPWORDS for w in words)
    return "en" if hits / len(words) >= 0.12 else "un"


def tag_text_lang(row: Dict[str, Any]) -> str:
    text = row.get("man_text") or row.get("seg_content") or row.get("content") or ""
    return detect_text_language(text)


# --- pipeline ---------------------------------------------------------------

TAGGING_FUNCTIONS: Dict[str, Callable] = {
    "has_comma_period": lambda row, cues: tag_has_comma_period(cues),
    "casing": lambda row, cues: tag_casing(cues),
    "repeating_lines": lambda row, cues: tag_repeating_lines(cues),
    "edit_dist": lambda row, cues: tag_edit_dist(row),
    "text_lang": lambda row, cues: tag_text_lang(row),
    "has_proper_cap_after_punct_line": lambda row, cues: tag_proper_capitalization(cues),
    "num_words": lambda row, cues: tag_num_words(cues),
}


def apply_tags(row: Dict[str, Any], tags: Sequence[str]) -> Dict[str, Any]:
    """Attach the requested tags to one JSONL row (sidecar-append mode)."""
    cues = cues_from_row(row)
    for tag in tags:
        if tag not in TAGGING_FUNCTIONS:
            raise KeyError(f"unknown tag: {tag}")
        row[tag] = TAGGING_FUNCTIONS[tag](row, cues)
    return row


def load_tag_config(path: str) -> List[str]:
    """YAML pipeline file -> ordered tag list
    (configs/data_configs/tagging/*.yaml)."""
    import yaml  # available transitively; fall back to a trivial parser

    with open(path) as f:
        cfg = yaml.safe_load(f)
    if isinstance(cfg, dict):
        entries = cfg.get("tags") or cfg.get("pipeline") or []
    else:
        entries = cfg
    return [e["tag"] if isinstance(e, dict) else str(e) for e in entries]


def process_jsonl_file(
    path: str,
    out_dir: str,
    tags: Sequence[str],
) -> Dict[str, Any]:
    """Tag every row of one gzip JSONL shard (data_tagger.py:714-893)."""
    opener = gzip.open if path.endswith(".gz") else open
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, os.path.basename(path))
    stats: Dict[str, Any] = {"rows": 0}
    out_opener = gzip.open if out_path.endswith(".gz") else open
    with opener(path, "rt", encoding="utf-8") as fin, out_opener(
        out_path, "wt", encoding="utf-8"
    ) as fout:
        for line in fin:
            if not line.strip():
                continue
            row = json.loads(line)
            row = apply_tags(row, tags)
            fout.write(json.dumps(row) + "\n")
            stats["rows"] += 1
            for tag in tags:
                key = f"{tag}={row[tag]}"
                stats[key] = stats.get(key, 0) + 1
    return stats


def main(
    jsonl_paths: Sequence[str],
    out_dir: str,
    tag_config: Optional[str] = None,
    tags: Optional[Sequence[str]] = None,
    num_workers: int = 0,
) -> Dict[str, Any]:
    """Shard loop with optional mp.Pool (data_tagger.py:1050-1122)."""
    tags = tags or (load_tag_config(tag_config) if tag_config else [])
    if not tags:
        raise ValueError("no tags specified")
    if num_workers > 0:
        import multiprocessing as mp
        from functools import partial

        with mp.Pool(num_workers) as pool:
            all_stats = pool.map(
                partial(process_jsonl_file, out_dir=out_dir, tags=tags), jsonl_paths
            )
    else:
        all_stats = [process_jsonl_file(p, out_dir, tags) for p in jsonl_paths]

    report: Dict[str, Any] = {}
    for s in all_stats:
        for k, v in s.items():
            report[k] = report.get(k, 0) + v
    with open(os.path.join(out_dir, "tagging_report.json"), "w") as f:
        json.dump(report, f, indent=2)
    return report


if __name__ == "__main__":
    import argparse
    import glob as _glob
    import json as _json

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--shards", required=True, help="glob of JSONL shards")
    p.add_argument("--config", default=None, help="tagging YAML")
    p.add_argument("--tags", nargs="*", default=None)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--num_workers", type=int, default=0)
    a = p.parse_args()
    stats = main(
        sorted(_glob.glob(a.shards)), a.out_dir,
        tag_config=a.config, tags=a.tags, num_workers=a.num_workers,
    )
    print(_json.dumps(stats, default=str)[:2000])
