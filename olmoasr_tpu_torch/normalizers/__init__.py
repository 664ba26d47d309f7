"""Text normalizers for WER: copies of ``olmoasr_tpu/normalizers``."""

from olmoasr_tpu_torch.normalizers.basic import (
    BasicTextNormalizer,
    remove_symbols,
    remove_symbols_and_diacritics,
)
from olmoasr_tpu_torch.normalizers.english import (
    EnglishNumberNormalizer,
    EnglishSpellingNormalizer,
    EnglishTextNormalizer,
)

__all__ = [
    "BasicTextNormalizer",
    "EnglishNumberNormalizer",
    "EnglishSpellingNormalizer",
    "EnglishTextNormalizer",
    "remove_symbols",
    "remove_symbols_and_diacritics",
]
