"""Transcript parsing (VTT/SRT) and segment writing.

A copy of ``olmoasr_tpu/data/transcripts.py``: the port imports nothing of the JAX package, and
``tests/test_torch_copies.py`` pins the copy to the original.

Rebuild of ``olmoasr/utils.py:173-373`` (``TranscriptReader``,
``write_segment``) without the webvtt dependency: both formats are simple
cue-block texts; we parse them directly.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Tuple

from olmoasr_tpu_torch.utils import convert_to_milliseconds, convert_to_timestamp

# "00:00:01.000 --> 00:00:04.000" (VTT uses '.', SRT uses ',')
_CUE_RE = re.compile(
    r"(\d{1,2}:)?\d{1,2}:\d{1,2}[.,]\d{1,3}\s*-->\s*(\d{1,2}:)?\d{1,2}:\d{1,2}[.,]\d{1,3}"
)


def _norm_ts(ts: str) -> str:
    ts = ts.strip().replace(",", ".")
    # ensure HH:MM:SS.mmm
    parts = ts.split(":")
    if len(parts) == 2:
        ts = "00:" + ts
    return ts


class TranscriptReader:
    """Parse a VTT or SRT transcript into {(start, end): text} with string
    timestamps 'HH:MM:SS.mmm' (olmoasr/utils.py:173-308 semantics)."""

    def __init__(
        self,
        file_path: Optional[str] = None,
        transcript_string: Optional[str] = None,
        ext: Optional[str] = None,
    ):
        assert file_path or transcript_string is not None
        self.file_path = file_path
        self.transcript_string = transcript_string
        self.ext = (ext or (os.path.splitext(file_path)[1][1:] if file_path else "vtt")).lower()

    def read(self) -> Tuple[Dict[Tuple[str, str], str], Optional[str], Optional[str]]:
        """Returns (transcript dict, first start ts, last end ts)."""
        if self.transcript_string is not None:
            content = self.transcript_string
        else:
            with open(self.file_path, encoding="utf-8", errors="replace") as f:
                content = f.read()

        transcript: Dict[Tuple[str, str], str] = {}
        lines = content.splitlines()
        i = 0
        while i < len(lines):
            line = lines[i].strip()
            m = _CUE_RE.search(line)
            if m:
                start_s, end_s = [
                    _norm_ts(part) for part in re.split(r"-->", m.group(0))
                ]
                text_lines: List[str] = []
                i += 1
                while i < len(lines) and lines[i].strip() != "":
                    t = lines[i].strip()
                    if not _CUE_RE.search(t):
                        text_lines.append(t)
                    else:
                        break
                    i += 1
                text = " ".join(text_lines).strip()
                if text:
                    key = (start_s, end_s)
                    if key in transcript:
                        transcript[key] = transcript[key] + " " + text
                    else:
                        transcript[key] = text
            else:
                i += 1

        if not transcript:
            return {}, None, None
        keys = list(transcript.keys())
        return transcript, keys[0][0], keys[-1][1]


def write_vtt_segment(
    transcript: Dict[Tuple[str, str], str],
    out_path: str,
    rebase_to_ms: Optional[int] = None,
) -> None:
    """Write a VTT file, optionally rebasing timestamps so the first cue starts
    at ``rebase_to_ms`` == 0 (olmoasr/utils.py:311-373 ``write_segment``)."""
    lines = ["WEBVTT", ""]
    base = rebase_to_ms
    for (start, end), text in transcript.items():
        s_ms = convert_to_milliseconds(start)
        e_ms = convert_to_milliseconds(end)
        if base is not None:
            s_ms -= base
            e_ms -= base
        lines.append(f"{convert_to_timestamp(s_ms)} --> {convert_to_timestamp(e_ms)}")
        lines.append(text)
        lines.append("")
    with open(out_path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines))
