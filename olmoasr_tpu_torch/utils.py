"""Small shared utilities (timestamp formatting, safe printing, etc.).

A copy of ``olmoasr_tpu/utils.py``: the port imports nothing of the JAX package, and
``tests/test_torch_copies.py`` pins the copy to the original.

Covers the helpers the reference imports from ``[pip:whisper] utils``
(``olmoasr/transcribe.py:24-33``) plus the timestamp math of
``olmoasr/utils.py:31-97``.

Attribution: ``format_timestamp`` and ``compression_ratio`` are one-liner
ports from openai-whisper (``whisper/utils.py``), Copyright (c) 2022 OpenAI,
MIT License — see the repository-root ``NOTICES`` file (timestamp strings
must render byte-identically for writer parity; the compression-ratio
definition gates the reference's fallback logic).
"""

from __future__ import annotations

import re
import sys
import zlib
from typing import Optional


def exact_div(x: int, y: int) -> int:
    assert x % y == 0
    return x // y


def format_timestamp(
    seconds: float, always_include_hours: bool = False, decimal_marker: str = "."
) -> str:
    assert seconds >= 0, "non-negative timestamp expected"
    milliseconds = round(seconds * 1000.0)

    hours = milliseconds // 3_600_000
    milliseconds -= hours * 3_600_000
    minutes = milliseconds // 60_000
    milliseconds -= minutes * 60_000
    secs = milliseconds // 1_000
    milliseconds -= secs * 1_000

    hours_marker = f"{hours:02d}:" if always_include_hours or hours > 0 else ""
    return (
        f"{hours_marker}{minutes:02d}:{secs:02d}{decimal_marker}{milliseconds:03d}"
    )


def make_safe(string: str) -> str:
    """Replace characters the system encoding can't represent."""
    encoding = sys.getdefaultencoding()
    return string.encode(encoding, errors="replace").decode(encoding)


def compression_ratio(text: str) -> float:
    text_bytes = text.encode("utf-8")
    if len(text_bytes) == 0:
        return 0.0
    return len(text_bytes) / len(zlib.compress(text_bytes))


def str2bool(string: str) -> bool:
    str2val = {"True": True, "False": False, "true": True, "false": False}
    if string in str2val:
        return str2val[string]
    raise ValueError(f"Expected one of {set(str2val.keys())}, got {string}")


def optional_int(string: str) -> Optional[int]:
    return None if string == "None" else int(string)


def optional_float(string: str) -> Optional[float]:
    return None if string == "None" else float(string)


# --- timestamp math used by the data pipeline (olmoasr/utils.py:31-97) -----

_TS_RE = re.compile(r"^(?:(\d+):)?(\d{1,2}):(\d{1,2})[.,](\d{1,3})$")


def convert_to_milliseconds(timestamp: str) -> int:
    """'HH:MM:SS.mmm' or 'MM:SS.mmm' -> integer milliseconds."""
    m = _TS_RE.match(timestamp.strip())
    if not m:
        raise ValueError(f"unparseable timestamp: {timestamp!r}")
    hours = int(m.group(1) or 0)
    minutes, seconds = int(m.group(2)), int(m.group(3))
    millis = int(m.group(4).ljust(3, "0"))
    return ((hours * 60 + minutes) * 60 + seconds) * 1000 + millis


def convert_to_timestamp(ms: int) -> str:
    """Integer milliseconds -> 'HH:MM:SS.mmm'."""
    hours = ms // 3_600_000
    ms -= hours * 3_600_000
    minutes = ms // 60_000
    ms -= minutes * 60_000
    seconds = ms // 1_000
    ms -= seconds * 1_000
    return f"{hours:02d}:{minutes:02d}:{seconds:02d}.{ms:03d}"
