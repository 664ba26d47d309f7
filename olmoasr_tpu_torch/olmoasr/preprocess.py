"""``olmoasr.preprocess`` on the port: the segmentation and alignment of
the port's copies ``olmoasr_tpu_torch.data.segment`` and ``.data.align``."""

from olmoasr_tpu_torch.data.align import align_machine_transcript, merge_man_mach_segs
from olmoasr_tpu_torch.data.segment import (
    SEGMENT_COUNT_THRESHOLD,
    Segment,
    SegmentCounter,
    chunk_data,
    preprocess_jsonl,
    preprocess_jsonls,
)

__all__ = [
    "SEGMENT_COUNT_THRESHOLD",
    "Segment",
    "SegmentCounter",
    "align_machine_transcript",
    "chunk_data",
    "merge_man_mach_segs",
    "preprocess_jsonl",
    "preprocess_jsonls",
]
