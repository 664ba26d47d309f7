"""Basic text normalizer ([pip:whisper] normalizers.basic semantics).

Used for all WER computation in the reference
(``scripts/eval/eval.py:50,1817`` imports the English variant,
which builds on these helpers).

A copy of ``olmoasr_tpu/normalizers/basic.py``, pinned to the original by
``tests/test_torch_eval.py``.
"""

from __future__ import annotations

import re
import unicodedata

# additional diacritics whisper explicitly maps
ADDITIONAL_DIACRITICS = {
    "œ": "oe", "Œ": "OE", "ø": "o", "Ø": "O", "æ": "ae", "Æ": "AE",
    "ß": "ss", "ẞ": "SS", "đ": "d", "Đ": "D", "ð": "d", "Ð": "D",
    "þ": "th", "Þ": "th", "ł": "l", "Ł": "L",
}


def remove_symbols_and_diacritics(s: str, keep: str = "") -> str:
    """Replace markers/symbols/punctuation with a space, drop diacritics."""

    def replace_character(char: str) -> str:
        if char in keep:
            return char
        if char in ADDITIONAL_DIACRITICS:
            return ADDITIONAL_DIACRITICS[char]
        category = unicodedata.category(char)
        if category == "Mn":
            return ""
        if category[0] in "MSP":
            return " "
        return char

    return "".join(
        replace_character(c) for c in unicodedata.normalize("NFKD", s)
    )


def remove_symbols(s: str) -> str:
    """Replace markers/symbols/punctuation with a space, keep diacritics."""
    return "".join(
        " " if unicodedata.category(c)[0] in "MSP" else c
        for c in unicodedata.normalize("NFKC", s)
    )


class BasicTextNormalizer:
    def __init__(self, remove_diacritics: bool = False, split_letters: bool = False):
        self.clean = (
            remove_symbols_and_diacritics if remove_diacritics else remove_symbols
        )
        self.split_letters = split_letters

    def __call__(self, s: str) -> str:
        s = s.lower()
        s = re.sub(r"[<\[][^>\]]*[>\]]", "", s)  # remove words between brackets
        s = re.sub(r"\(([^)]+?)\)", "", s)  # remove words between parenthesis
        s = self.clean(s).lower()

        if self.split_letters:
            s = " ".join(re.findall(r"\X", s, re.UNICODE))

        s = re.sub(r"\s+", " ", s)
        return s.strip()
