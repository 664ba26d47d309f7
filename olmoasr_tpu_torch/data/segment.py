"""Segmentation engine: full videos -> ≤30s audio/transcript training segments.

Rebuild of the reference's ``olmoasr/preprocess.py`` (chunk_data, 30-845;
the shard loop 1499-1753). The reference implements this as a ~1200-line
two-pointer state machine over timestamp STRINGS; we reimplement the same
machine in integer milliseconds. The emission rules (full contract in the
``chunk_data`` docstring) are reference-exact and differentially pinned
against the imported reference code itself
(tests/test_reference_differential_data.py): segment spans, rebased VTT
content, dual-typed norm_end, no-speech windows, the over-30s/over-ctx drop
rules and their counters, and the final-segment anchor-exclusion quirk.

A copy of ``olmoasr_tpu/data/segment.py`` on the port's own ``tokenizer``, ``utils``,
``data.transcripts``, ``eval.wer`` and ``normalizers``: the port imports nothing of the JAX
package, and ``tests/test_torch_compat.py`` pins the copy to the original.
"""

from __future__ import annotations

import dataclasses
import gzip
import json
import os
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

from olmoasr_tpu_torch.tokenizer import Tokenizer, get_tokenizer
from olmoasr_tpu_torch.utils import convert_to_milliseconds, convert_to_timestamp

SEGMENT_COUNT_THRESHOLD = 120
CTX_LIMIT = 448
WINDOW_MS = 30_000
MIN_DURATION_MS = 15  # too_short checks (olmoasr/utils.py:505-523)


@dataclass
class SegmentCounter:
    """Processing statistics (preprocess.py SegmentCounter / stats files)."""

    segment_count: int = 0
    over_30_line_segment_count: int = 0
    bad_text_segment_count: int = 0
    over_ctx_len_segment_count: int = 0
    faulty_audio_segment_count: int = 0
    failed_transcript_count: int = 0
    # extra diagnostics kept by the alignment pipeline (data/align.py)
    empty_segment_count: int = 0
    too_short_segment_count: int = 0

    def to_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)


@dataclass
class Segment:
    """One emitted segment; ``to_dict`` matches the reference JSONL row keys
    (olmoasr/utils.py:526-713 Segment.to_dict)."""

    subtitle_file: str
    seg_content: str
    text_timestamp: str
    audio_timestamp: str
    norm_end: Union[int, str]  # ms for no-speech windows, 'HH:MM:SS.mmm' else
    # (the reference's exact dual typing, utils.py write_segment /
    # preprocess.py no-speech branches; the loader accepts both)
    video_id: str
    seg_id: str
    audio_file: str
    ts_mode: bool
    no_ts_mode: bool
    only_no_ts_mode: bool
    num_tokens_no_ts_mode: int
    num_tokens_ts_mode: int
    # in-memory payloads (None when writing to disk)
    transcript: Optional[Dict[Tuple[str, str], str]] = None
    audio_arr: Optional[np.ndarray] = None

    def to_dict(self) -> Dict:
        return {
            "subtitle_file": self.subtitle_file,
            "seg_content": self.seg_content,
            "text_timestamp": self.text_timestamp,
            "audio_timestamp": self.audio_timestamp,
            "norm_end": self.norm_end,
            "id": self.video_id,
            "seg_id": self.seg_id,
            "audio_file": self.audio_file,
            "ts_mode": self.ts_mode,
            "no_ts_mode": self.no_ts_mode,
            "only_no_ts_mode": self.only_no_ts_mode,
            "num_tokens_no_ts_mode": self.num_tokens_no_ts_mode,
            "num_tokens_ts_mode": self.num_tokens_ts_mode,
        }


def token_budget(
    cues: Sequence[Tuple[int, int, str]],
    tokenizer: Tokenizer,
    last_seg: bool = False,
) -> Dict[str, Union[bool, int]]:
    """olmoasr/utils.py:391-450 ``over_ctx_len`` semantics."""
    n_text = sum(len(tokenizer.encode(" " + text.strip())) for _, _, text in cues)
    n_ts_tokens = len(cues) * 2 + (0 if last_seg else 1)
    num_ts_mode = n_ts_tokens + n_text + 2  # sot + eot
    num_no_ts_mode = n_text + 3  # sot + notimestamps + eot
    return {
        "ts_mode": num_ts_mode <= CTX_LIMIT,
        "no_ts_mode": num_no_ts_mode <= CTX_LIMIT,
        "num_tokens_ts_mode": num_ts_mode,
        "num_tokens_no_ts_mode": num_no_ts_mode,
    }


def _render_vtt(cues: Sequence[Tuple[int, int, str]], base_ms: int) -> str:
    """Rebased VTT content (olmoasr/utils.py:311-373 write_segment)."""
    lines = ["WEBVTT", ""]
    for s, e, text in cues:
        lines.append(
            f"{convert_to_timestamp(s - base_ms)} --> {convert_to_timestamp(e - base_ms)}"
        )
        lines.append(text)
        lines.append("")
    return "\n".join(lines)


def _fmt_audio_ts(start_ms: int) -> str:
    s = convert_to_timestamp(start_ms).replace(".", ",")
    e = convert_to_timestamp(start_ms + WINDOW_MS).replace(".", ",")
    return f"{s}_{e}"


def _wrap_ts(ms: int) -> str:
    """Timestamp string with the reference's 24h datetime wrap: rebasing a cue
    below its window start goes through datetime arithmetic upstream
    (utils.adjust_timestamp), so negative values wrap past midnight."""
    return convert_to_timestamp(ms % 86_400_000)


def _comma(ms: int) -> str:
    return convert_to_timestamp(ms).replace(".", ",")


def _render_segment(
    cues: Sequence[Tuple[int, int, str]], base_ms: int, ext: str
) -> Tuple[str, str, bool]:
    """(content, norm_end_str, only_no_ts_mode) — utils.write_segment
    (olmoasr/utils.py:311-373): cue times rebased by the window start; a cue
    starting/ending before the window flags only_no_ts (its rebased times wrap
    past midnight and are unusable as timestamp tokens)."""
    only_no_ts = False
    content = "WEBVTT\n\n" if ext == "vtt" else ""
    end_str = ""
    for i, (s, e, text) in enumerate(cues):
        if s < base_ms or e < base_ms:
            only_no_ts = True
        start_str = _wrap_ts(s - base_ms)
        end_str = _wrap_ts(e - base_ms)
        if ext == "srt":
            content += f"{i + 1}\n"
            content += (
                f"{start_str.replace('.', ',')} --> {end_str.replace('.', ',')}"
                f"\n{text}\n\n"
            )
        else:
            content += f"{start_str} --> {end_str}\n{text}\n\n"
    return content, end_str.replace(",", "."), only_no_ts


def chunk_data(
    transcript: Dict[Tuple[str, str], str],
    *,
    transcript_ext: str = "vtt",
    audio: Optional[Union[str, np.ndarray]] = None,
    video_id: str = "",
    tokenizer: Optional[Tokenizer] = None,
    segment_output_dir: Optional[str] = None,
    in_memory: bool = True,
    transcript_only: bool = False,
    audio_only: bool = False,
    sample_rate: int = 16000,
) -> Tuple[List[Segment], SegmentCounter]:
    """Segment one video's transcript (+ audio) into <=30s training segments.

    Reference-exact rebuild of the two-pointer machine in
    olmoasr/preprocess.py:30-845 ``chunk_data`` (reformulated in integer
    milliseconds, differentially pinned by
    tests/test_reference_differential_data.py). The behavioral contract:

      * cue order is the transcript's own order (dict insertion), never
        re-sorted; a cue END earlier than the running window start is a
        malformed transcript (failed_transcript_count, no segments) — the
        reference's calculate_difference raises there;
      * a speech segment spans [local_start, last-fitting-cue end]: cues are
        accumulated while cue_end - local_start <= 30s; local_start is the
        previous segment's last cue END (its silence tail is included), the
        transcript start, or a no-speech restart point;
      * the cue that overflows 30s is NOT consumed: the window closes, the
        last included cue becomes the new anchor, and the overflowing cue is
        retried against the next window;
      * text timestamps in seg_content are rebased by local_start
        (write_segment); norm_end is the rebased last cue end as a TIMESTAMP
        STRING (the loader converts back to ms);
      * a single cue longer than 30s is dropped and counted
        (over_30_line_segment_count; doubled when it is the whole
        transcript);
      * >=30s of silence before the next cue emits floor(gap/30s) empty
        full-window segments (norm_end=30000, int), the remainder becoming
        the next window's start; <30s of silence before a cue that will not
        fit emits one empty partial segment named [local_start, cue_start];
      * token budget (utils.over_ctx_len): ts-mode = text + 2*cues +
        (0 if last segment else 1) + 2, no-ts-mode = text + 3, limit 448;
        if neither fits the WHOLE segment is dropped
        (over_ctx_len_segment_count) — no cue spilling;
      * the FINAL segment (transcript exhausted under 30s) keeps the
        anchor-cue exclusion rule (timestamps[a+1:b]), so when the last
        window holds a single leftover cue after a speech emit, that cue is
        dropped with an empty selection (counted over_ctx_len — faithful
        reference quirk); its audio_timestamp equals the text span, not a
        30s window;
      * at most SEGMENT_COUNT_THRESHOLD=120 segments, checked at the top of
        the loop only (a long silence may overshoot, as upstream);
      * audio for speech/no-speech segments is the fixed 30s window
        [local_start, local_start+30s) as int16; the final segment's audio
        ends at its true end; sub-15ms audio is dropped silently and a
        missing decode counts faulty_audio_segment_count.
    """
    tokenizer = tokenizer or get_tokenizer(False)
    counter = SegmentCounter()
    ext = transcript_ext

    items = []
    for (s, e), text in transcript.items():
        s_ms = convert_to_milliseconds(s) if isinstance(s, str) else int(s)
        e_ms = convert_to_milliseconds(e) if isinstance(e, str) else int(e)
        items.append((s_ms, e_ms, text))
    if not items:
        counter.failed_transcript_count += 1
        return [], counter
    ts = [(s, e) for s, e, _ in items]
    texts = {(s, e): t for s, e, t in items}
    ts_set = set(ts)
    n = len(ts)

    waveform: Optional[np.ndarray] = None
    if audio is not None and not transcript_only:
        if isinstance(audio, np.ndarray):
            waveform = audio
        elif audio.endswith(".npy"):
            waveform = np.load(audio)
        else:
            from olmoasr_tpu_torch.audio import load_audio

            waveform = (load_audio(audio) * 32768.0).astype(np.int16)
        if waveform.dtype != np.int16:
            waveform = (np.asarray(waveform, np.float32) * 32768.0).astype(np.int16)

    segments: List[Segment] = []

    def audio_arr(start_ms: int, end_ms: int) -> Optional[np.ndarray]:
        if waveform is None:
            return None
        a_ = int(start_ms * sample_rate / 1000)
        b_ = int(end_ms * sample_rate / 1000)
        return waveform[a_:b_]

    def write_files(subtitle_file: str, content: str, arr) -> Tuple[str, str]:
        audio_file = os.path.join(
            os.path.dirname(subtitle_file),
            os.path.basename(subtitle_file).rsplit(".", 1)[0] + ".npy",
        )
        if segment_output_dir and not in_memory:
            vdir = os.path.join(segment_output_dir, video_id) if video_id else segment_output_dir
            os.makedirs(vdir, exist_ok=True)
            subtitle_file = os.path.join(vdir, os.path.basename(subtitle_file))
            audio_file = os.path.join(vdir, os.path.basename(audio_file))
            if not audio_only:
                with open(subtitle_file, "w", encoding="utf-8") as f:
                    f.write(content)
            if arr is not None and not transcript_only:
                np.save(audio_file, arr)
        return subtitle_file, audio_file

    def emit(
        *, text_ts: str, audio_ts: str, content: str, norm_end, only_no_ts: bool,
        budget: Optional[Dict], arr: Optional[np.ndarray], seg_cues,
        window_start: int, audio_file_from_text: bool = False,
    ) -> None:
        """Append one Segment (the reference's three per-mode output forms
        collapse to the one dataclass; audio validity gates as upstream)."""
        if not transcript_only and waveform is not None:
            # with audio present the reference gates on trim_audio's result;
            # calling without audio at all behaves like transcript-only
            if arr is None:
                counter.faulty_audio_segment_count += 1
                return
            if len(arr) / sample_rate < 0.015:  # too_short_audio
                return
        subtitle_file = f"{text_ts}.{ext}"
        aname = text_ts if audio_file_from_text else audio_ts
        subtitle_file, _ = write_files(subtitle_file, content, arr)
        audio_file = os.path.join(
            os.path.dirname(subtitle_file) or "", f"{aname}.npy"
        ) if os.path.dirname(subtitle_file) else f"{aname}.npy"
        b_ = budget or {
            "ts_mode": True, "no_ts_mode": True,
            "num_tokens_ts_mode": 0, "num_tokens_no_ts_mode": 0,
        }
        segments.append(
            Segment(
                subtitle_file=subtitle_file,
                seg_content=content,
                text_timestamp=text_ts,
                audio_timestamp=audio_ts,
                norm_end=norm_end,
                video_id=video_id,
                seg_id=f"{video_id}_{counter.segment_count}",
                audio_file=audio_file,
                ts_mode=bool(b_["ts_mode"]),
                no_ts_mode=bool(b_["no_ts_mode"]),
                only_no_ts_mode=only_no_ts,
                num_tokens_no_ts_mode=int(b_["num_tokens_no_ts_mode"]),
                num_tokens_ts_mode=int(b_["num_tokens_ts_mode"]),
                transcript={
                    (_wrap_ts(s - window_start), _wrap_ts(e - window_start)): t
                    for s, e, t in seg_cues
                } if in_memory else None,
                audio_arr=arr if in_memory else None,
            )
        )
        counter.segment_count += 1

    def selection(a: int, b: int, use_a: bool) -> List[Tuple[int, int, str]]:
        lo = a if use_a else a + 1
        return [(s, e, texts[(s, e)]) for s, e in ts[lo:b]]

    def timestamps_valid(sel) -> bool:
        # utils.timestamps_valid: bounds vs the transcript's global span and
        # the selection's own first/last
        if not sel:
            return False
        g_start, g_end = ts[0][0], ts[-1][1]
        s0, e_last = sel[0][0], sel[-1][1]
        if s0 < g_start or e_last > g_end:
            return False
        for s, e, _ in sel:
            if s > e or s < g_start or e > g_end or s < s0 or e > e_last:
                return False
        return True

    def speech_budget(sel, last_seg: bool):
        """(over_ctx, budget_or_error) — utils.over_ctx_len."""
        try:
            budget = token_budget(
                [(s, e, t) for s, e, t in sel], tokenizer, last_seg=last_seg
            )
        except Exception:
            return True, "error"
        if not budget["ts_mode"] and not budget["no_ts_mode"]:
            return True, None
        return False, budget

    a = 0
    b = 0
    from_no_speech = False
    start_in_no_speech: Optional[int] = None
    local_start = 0
    init_diff = 0
    diff = 0

    # Livelock guard (deliberate divergence): a zero-length cue followed by a
    # cue ending >30s later repeats the speech-emit state forever in the
    # REFERENCE (only over_ctx_len grows, preprocess.py:633-640). Iterations
    # on terminating inputs are O(n + segments); far beyond that, treat the
    # transcript as failed instead of hanging.
    max_iters = 10_000 + 100 * n
    iters = 0

    while a < n + 1 and counter.segment_count < SEGMENT_COUNT_THRESHOLD:
        iters += 1
        if iters > max_iters:
            counter.failed_transcript_count += 1
            return [], counter
        # --- local_start (preprocess.py:100-116) ----------------------------
        if a == 0 and not from_no_speech:
            local_start = ts[0][1] if (b == 1 and init_diff == 0) else ts[0][0]
        elif from_no_speech or a == b:
            local_start = (
                start_in_no_speech if start_in_no_speech is not None else ts[a][0]
            )
        else:
            local_start = ts[a][1]

        if ts[b][1] < local_start:  # calculate_difference raises upstream
            counter.failed_transcript_count += 1
            return [], counter
        init_diff = ts[b][1] - local_start

        if init_diff <= WINDOW_MS:
            diff = init_diff
            b += 1
        else:
            if b == a:
                # single cue > 30s: drop it (over_30 branch)
                counter.over_30_line_segment_count += 1
                a += 1
                b += 1
                start_in_no_speech = None
                if a == b == n:
                    if counter.segment_count == 0:
                        counter.over_30_line_segment_count += 1
                    break
                continue

            if b - a == 1 and local_start != ts[a][0]:
                if ts[b][0] < local_start:  # calculate_difference raises
                    counter.failed_transcript_count += 1
                    return [], counter
                gap = ts[b][0] - local_start
                pair_is_cue = (local_start, ts[b][0]) in ts_set
                if gap >= WINDOW_MS and not pair_is_cue:
                    # >=30s silence: emit full empty windows, carry remainder
                    n_full = gap // WINDOW_MS
                    for i in range(n_full + 1):
                        start = local_start + i * WINDOW_MS
                        if i == n_full:
                            from_no_speech = True
                            if start == ts[b][0]:
                                a = b
                                start_in_no_speech = None
                            else:
                                start_in_no_speech = start
                            continue
                        end = start + WINDOW_MS
                        span = f"{_comma(start)}_{_comma(end)}"
                        emit(
                            text_ts=span, audio_ts=span,
                            content="WEBVTT\n\n" if ext == "vtt" else "",
                            norm_end=WINDOW_MS, only_no_ts=False, budget=None,
                            arr=audio_arr(start, end), seg_cues=[],
                            window_start=start,
                        )
                    continue
                if gap < WINDOW_MS and not pair_is_cue:
                    if ts[b][0] == local_start:
                        a = b
                        from_no_speech = True
                        start_in_no_speech = None
                        continue
                    # <30s silence before a cue that will not fit: one empty
                    # partial segment named [local_start, cue_start]
                    end = ts[b][0]
                    if end - local_start >= MIN_DURATION_MS:
                        emit(
                            text_ts=f"{_comma(local_start)}_{_comma(end)}",
                            audio_ts=(
                                f"{_comma(local_start)}_"
                                f"{_comma(local_start + WINDOW_MS)}"
                            ),
                            content="WEBVTT\n\n" if ext == "vtt" else "",
                            norm_end=_wrap_ts(end - local_start),
                            only_no_ts=False, budget=None,
                            arr=audio_arr(local_start, local_start + WINDOW_MS),
                            seg_cues=[], window_start=local_start,
                        )
                    a = b
                    from_no_speech = True
                    start_in_no_speech = None
                    continue
                if pair_is_cue:
                    a = b
                    continue

            # --- speech segment [local_start, ts[b-1][1]] -------------------
            use_a = a == 0 or (
                start_in_no_speech is None and a > 0 and from_no_speech
            )
            sel = selection(a, b, use_a)
            over_ctx, res = speech_budget(sel, last_seg=False)
            if not over_ctx and timestamps_valid(sel):
                content, norm_end, only_no_ts = _render_segment(
                    sel, local_start, ext
                )
                emit(
                    text_ts=f"{_comma(local_start)}_{_comma(sel[-1][1])}",
                    audio_ts=(
                        f"{_comma(local_start)}_{_comma(local_start + WINDOW_MS)}"
                    ),
                    content=content, norm_end=norm_end, only_no_ts=only_no_ts,
                    budget=res, arr=audio_arr(local_start, local_start + WINDOW_MS),
                    seg_cues=sel, window_start=local_start,
                )
            elif res == "error":
                counter.bad_text_segment_count += 1
            else:
                counter.over_ctx_len_segment_count += 1
            init_diff = 0
            diff = 0
            a = b - 1
            from_no_speech = False
            start_in_no_speech = None

        # --- transcript exhausted under 30s: final segment ------------------
        if b == n and diff <= WINDOW_MS:
            use_a = a == 0 or (
                start_in_no_speech is None and a > 0 and from_no_speech
            )
            sel = selection(a, b, use_a)
            over_ctx, res = speech_budget(sel, last_seg=True)
            if not over_ctx and timestamps_valid(sel):
                content, norm_end, only_no_ts = _render_segment(
                    sel, local_start, ext
                )
                if ts[b - 1][1] - local_start >= MIN_DURATION_MS:
                    span = f"{_comma(local_start)}_{_comma(ts[b - 1][1])}"
                    emit(
                        text_ts=span, audio_ts=span, content=content,
                        norm_end=norm_end, only_no_ts=only_no_ts, budget=res,
                        arr=audio_arr(local_start, ts[b - 1][1]), seg_cues=sel,
                        window_start=local_start, audio_file_from_text=True,
                    )
            elif res == "error":
                counter.bad_text_segment_count += 1
            else:
                counter.over_ctx_len_segment_count += 1
            break

    return segments, counter


# ---------------------------------------------------------------------------
# the shard loop (preprocess.py:1499-1753 preprocess_jsonl(s))
# ---------------------------------------------------------------------------


def preprocess_jsonl(
    jsonl_path: str,
    output_dir: str,
    *,
    audio_root: Optional[str] = None,
    transcript_only: bool = True,
    subsample: Optional[float] = None,
    seed: int = 42,
) -> Dict[str, int]:
    """Segment every video row of one JSONL(.gz) shard; writes a
    ``<shard>_segments.jsonl.gz`` plus a stats json."""
    from olmoasr_tpu_torch.data.transcripts import TranscriptReader

    opener = gzip.open if jsonl_path.endswith(".gz") else open
    rows = []
    with opener(jsonl_path, "rt", encoding="utf-8") as f:
        for line in f:
            if line.strip():
                rows.append(json.loads(line))

    if subsample:
        rng = np.random.default_rng(seed)
        keep = rng.random(len(rows)) < subsample
        rows = [r for r, k in zip(rows, keep) if k]

    os.makedirs(output_dir, exist_ok=True)
    base = os.path.basename(jsonl_path).split(".")[0]
    out_path = os.path.join(output_dir, f"{base}_segments.jsonl.gz")
    totals = SegmentCounter()

    with gzip.open(out_path, "wt", encoding="utf-8") as out:
        for row in rows:
            video_id = row.get("id") or row.get("video_id") or ""
            content = row.get("content") or row.get("transcript") or ""
            ext = row.get("ext", "vtt")
            transcript, _, _ = TranscriptReader(
                transcript_string=content, ext=ext
            ).read()
            audio = row.get("audio_file")
            if audio and audio_root:
                audio = os.path.join(audio_root, audio)
            segments, counter = chunk_data(
                transcript,
                transcript_ext=ext,
                audio=audio if not transcript_only else None,
                video_id=video_id,
                transcript_only=transcript_only,
                segment_output_dir=output_dir,
                in_memory=False,
            )
            for seg in segments:
                out.write(json.dumps(seg.to_dict()) + "\n")
            for f_ in dataclasses.fields(SegmentCounter):
                setattr(
                    totals, f_.name,
                    getattr(totals, f_.name) + getattr(counter, f_.name),
                )

    stats = totals.to_dict()
    with open(os.path.join(output_dir, f"{base}_stats.json"), "w") as f:
        json.dump(stats, f)
    return stats


def preprocess_jsonls(
    jsonl_paths: Sequence[str],
    output_dir: str,
    *,
    num_workers: int = 0,
    **kwargs,
) -> Dict[str, int]:
    """Many shards, with an optional process pool (preprocess.py:1669-1753)."""
    if num_workers > 0:
        import multiprocessing as mp
        from functools import partial

        with mp.Pool(num_workers) as pool:
            all_stats = pool.map(
                partial(preprocess_jsonl, output_dir=output_dir, **kwargs),
                jsonl_paths,
            )
    else:
        all_stats = [preprocess_jsonl(p, output_dir, **kwargs) for p in jsonl_paths]

    total: Dict[str, int] = {}
    for s in all_stats:
        for k, v in s.items():
            total[k] = total.get(k, 0) + v
    return total


if __name__ == "__main__":
    import argparse
    import glob as _glob
    import json as _json

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--shards", required=True, help="glob of raw JSONL shards")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--mode", default="transcript_only",
                   choices=["transcript_only", "audio_only"])
    p.add_argument("--num_workers", type=int, default=0)
    a = p.parse_args()
    stats = preprocess_jsonls(
        sorted(_glob.glob(a.shards)), a.out_dir,
        transcript_only=(a.mode == "transcript_only"),
        num_workers=a.num_workers,
    )
    print(_json.dumps(stats))
