"""``olmoasr.utils`` on the port: transcript parsing and writing, WER and
timestamp helpers; ``over_ctx_len`` is the segment copy's
``token_budget``."""

from olmoasr_tpu_torch.data.segment import token_budget as over_ctx_len
from olmoasr_tpu_torch.data.transcripts import TranscriptReader, write_vtt_segment
from olmoasr_tpu_torch.eval.wer import calculate_wer
from olmoasr_tpu_torch.utils import (
    convert_to_milliseconds,
    convert_to_timestamp,
    format_timestamp,
)

__all__ = [
    "TranscriptReader",
    "calculate_wer",
    "convert_to_milliseconds",
    "convert_to_timestamp",
    "format_timestamp",
    "over_ctx_len",
    "write_vtt_segment",
]
