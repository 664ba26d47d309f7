"""Transcript-directory -> JSONL conversion.

Rebuild of the reference's ``scripts/data/processing/text_to_jsonl.py``: walk a
directory of transcripts, emit one gzip JSONL row per video with
{id, subtitle_file, content, length, ext}.

A copy of ``olmoasr_tpu/data/jsonl.py`` on the port's own ``data.transcripts``
and ``utils``: the port imports nothing of the JAX package, and
``tests/test_torch_data_pipeline.py`` pins the copy to the original.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
from typing import Dict, List, Optional, Sequence

from olmoasr_tpu_torch.data.transcripts import TranscriptReader
from olmoasr_tpu_torch.utils import convert_to_milliseconds


def video_row(transcript_path: str) -> Optional[Dict]:
    ext = os.path.splitext(transcript_path)[1][1:].lower()
    try:
        with open(transcript_path, encoding="utf-8", errors="replace") as f:
            content = f.read()
        transcript, start, end = TranscriptReader(
            transcript_string=content, ext=ext
        ).read()
    except Exception:
        return None
    if not transcript:
        return None
    length_ms = convert_to_milliseconds(end) - convert_to_milliseconds(start)
    video_id = os.path.splitext(os.path.basename(transcript_path))[0]
    return {
        "id": video_id,
        "subtitle_file": transcript_path,
        "content": content,
        "length": length_ms,
        "ext": ext,
        "num_cues": len(transcript),
    }


def text_to_jsonl(
    transcript_dir: str,
    out_path: str,
    *,
    exts: Sequence[str] = ("vtt", "srt"),
    num_workers: int = 0,
) -> int:
    """Walk ``transcript_dir`` -> gzip JSONL (text_to_jsonl.py:287-341)."""
    paths: List[str] = []
    for ext in exts:
        paths.extend(
            glob.glob(os.path.join(transcript_dir, "**", f"*.{ext}"), recursive=True)
        )
    paths.sort()

    if num_workers > 0:
        import multiprocessing as mp

        with mp.Pool(num_workers) as pool:
            rows = pool.map(video_row, paths)
    else:
        rows = [video_row(p) for p in paths]

    n = 0
    opener = gzip.open if out_path.endswith(".gz") else open
    with opener(out_path, "wt", encoding="utf-8") as f:
        for row in rows:
            if row is not None:
                f.write(json.dumps(row) + "\n")
                n += 1
    return n


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--in_dir", required=True, help="transcript tree")
    p.add_argument("--out_path", required=True, help="output .jsonl[.gz]")
    p.add_argument("--exts", nargs="*", default=["vtt", "srt"])
    p.add_argument("--num_workers", type=int, default=0)
    a = p.parse_args()
    n = text_to_jsonl(a.in_dir, a.out_path, exts=tuple(a.exts),
                      num_workers=a.num_workers)
    print(f"wrote {n} rows -> {a.out_path}")
