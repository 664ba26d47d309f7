"""Machine-transcript alignment and manual/machine merge.

Rebuild of the reference's ``olmoasr/preprocess.py:1083-1496``
(``chunk_mach_transcript`` + ``merge_man_mach_segs``): given the manual
transcript's segment boundaries, cut the machine transcript at the machine
cues whose start/end timestamps are nearest to each manual boundary
(the reference's greedy nearest-timestamp sweep), pair the segments 1:1, and
compute the normalized per-segment WER (``seg_edit_dist``) used by the
``edit_dist`` filtering tag.

A copy of ``olmoasr_tpu/data/align.py`` on the port's own ``tokenizer``, ``utils``,
``data.transcripts``, ``eval.wer`` and ``normalizers``: the port imports nothing of the JAX
package, and ``tests/test_torch_compat.py`` pins the copy to the original.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from olmoasr_tpu_torch.data.segment import Segment, SegmentCounter, chunk_data, token_budget
from olmoasr_tpu_torch.data.transcripts import TranscriptReader
from olmoasr_tpu_torch.eval.wer import wer as _wer
from olmoasr_tpu_torch.tokenizer import get_tokenizer
from olmoasr_tpu_torch.utils import convert_to_milliseconds, convert_to_timestamp


@dataclass
class MachineSegment:
    """Aligned machine segment (preprocess.py MachineSegment record)."""

    seg_content: str
    timestamp: str  # "start_end" with ',' decimal marks
    video_id: str
    start_ms: int
    end_ms: int
    text: str

    def to_dict(self) -> Dict:
        return {
            "mach_seg_content": self.seg_content,
            "mach_timestamp": self.timestamp,
            "id": self.video_id,
        }


def _nearest_index(cue_times: Sequence[int], target_ms: int, lo: int = 0) -> int:
    """Index of the cue time nearest to target (greedy forward sweep, matching
    the reference's monotone max_diff walk)."""
    best_i, best_d = lo, None
    for i in range(lo, len(cue_times)):
        d = abs(cue_times[i] - target_ms)
        if best_d is None or d < best_d:
            best_d, best_i = d, i
        elif cue_times[i] > target_ms and d > best_d:
            break  # moving away and past the target: stop
    return best_i


def align_machine_transcript(
    mach_transcript: Dict[Tuple[str, str], str],
    man_boundaries: Sequence[Tuple[int, int]],  # (start_ms, end_ms) per manual seg
    video_id: str = "",
) -> Tuple[List[Optional[MachineSegment]], SegmentCounter]:
    """Cut the machine transcript at cue boundaries nearest each manual
    segment boundary; one (possibly None) machine segment per manual segment."""
    counter = SegmentCounter()
    cues = [
        (convert_to_milliseconds(s), convert_to_milliseconds(e), text)
        for (s, e), text in mach_transcript.items()
    ]
    cues.sort(key=lambda c: (c[0], c[1]))
    starts = [c[0] for c in cues]
    ends = [c[1] for c in cues]
    tokenizer = get_tokenizer(False)

    out: List[Optional[MachineSegment]] = []
    search_lo = 0
    for man_start, man_end in man_boundaries:
        if not cues:
            out.append(None)
            continue
        a = _nearest_index(starts, man_start, lo=search_lo)
        b = _nearest_index(ends, man_end, lo=a)
        seg_cues = cues[a : b + 1]
        if not seg_cues or seg_cues[-1][1] <= seg_cues[0][0]:
            counter.too_short_segment_count += 1
            out.append(None)
            continue
        budget = token_budget(seg_cues, tokenizer)
        if not (budget["ts_mode"] or budget["no_ts_mode"]):
            counter.over_ctx_len_segment_count += 1
            out.append(None)
            continue
        base = seg_cues[0][0]
        content_lines = ["WEBVTT", ""]
        for s, e, text in seg_cues:
            content_lines.append(
                f"{convert_to_timestamp(s - base)} --> {convert_to_timestamp(e - base)}"
            )
            content_lines.append(text)
            content_lines.append("")
        ts = (
            f"{convert_to_timestamp(seg_cues[0][0]).replace('.', ',')}_"
            f"{convert_to_timestamp(seg_cues[-1][1]).replace('.', ',')}"
        )
        out.append(
            MachineSegment(
                seg_content="\n".join(content_lines),
                timestamp=ts,
                video_id=video_id,
                start_ms=seg_cues[0][0],
                end_ms=seg_cues[-1][1],
                text=" ".join(c[2] for c in seg_cues),
            )
        )
        counter.segment_count += 1
        search_lo = b
    return out, counter


def merge_man_mach_segs(
    man_transcript: Dict[Tuple[str, str], str],
    mach_transcript: Optional[Dict[Tuple[str, str], str]],
    *,
    video_id: str = "",
    normalizer=None,
) -> Tuple[List[Segment], SegmentCounter, Optional[SegmentCounter]]:
    """Chunk the manual transcript, align the machine transcript to its
    boundaries, attach mach_* fields + per-segment WER (``seg_edit_dist``)
    to each manual Segment (preprocess.py:1341-1496)."""
    if normalizer is None:
        from olmoasr_tpu_torch.normalizers import EnglishTextNormalizer

        normalizer = EnglishTextNormalizer()

    man_segments, man_counter = chunk_data(
        man_transcript, video_id=video_id, transcript_only=True
    )

    def seg_bounds(seg: Segment) -> Tuple[int, int]:
        audio_start = convert_to_milliseconds(
            seg.audio_timestamp.split("_")[0].replace(",", ".")
        )
        # norm_end is dual-typed (ms int for no-speech windows, timestamp
        # string otherwise — the reference's exact convention)
        norm_ms = (
            convert_to_milliseconds(seg.norm_end)
            if isinstance(seg.norm_end, str) else seg.norm_end
        )
        return audio_start, audio_start + norm_ms

    mach_counter: Optional[SegmentCounter] = None
    mach_segments: List[Optional[MachineSegment]] = [None] * len(man_segments)
    if mach_transcript:
        boundaries = [seg_bounds(s) for s in man_segments]
        mach_segments, mach_counter = align_machine_transcript(
            mach_transcript, boundaries, video_id
        )

    def safe_norm(t: str) -> str:
        try:
            return normalizer(t).strip()
        except Exception:
            return t

    merged: List[Segment] = []
    for seg, mach in zip(man_segments, mach_segments):
        man_text = " ".join((seg.transcript or {}).values())
        norm_man = safe_norm(man_text)
        d = seg.to_dict()
        extra = {
            "seg_text": norm_man,
            "man_text": norm_man,
        }
        if mach is None:
            extra.update(
                mach_seg_content="", mach_seg_text="", mach_text="",
                mach_timestamp="", seg_edit_dist=0.0,
            )
        else:
            norm_mach = safe_norm(mach.text)
            if norm_man:
                dist = _wer(norm_man, norm_mach)
            elif norm_mach:
                dist = _wer(norm_mach, norm_man)
            else:
                dist = 0.0
            extra.update(
                mach_seg_content=mach.seg_content,
                mach_seg_text=norm_mach,
                mach_text=norm_mach,
                mach_timestamp=mach.timestamp,
                seg_edit_dist=dist,
            )
        # attach the merged fields onto the Segment's dict payload
        seg.merged = {**d, **extra}  # type: ignore[attr-defined]
        merged.append(seg)
    return merged, man_counter, mach_counter
