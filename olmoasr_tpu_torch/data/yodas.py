"""YODAS re-segmentation.

Rebuild of the reference's ``scripts/data/processing/reseg_yodas.py``: re-chunk
YODAS-format utterances (audio + per-utterance text + timestamps) into ≤30s /
≤448-token training segments. Works on plain Python/NumPy records; an Arrow
reader is provided when ``datasets``/``pyarrow`` is available.

YODAS row format (the reference's HF layout, train_yodas.py): ``audio`` array
or path, ``text`` list of utterance strings, ``ts`` list of (start, end)
seconds, ``utt_id``, ``dur``.

A copy of ``olmoasr_tpu/data/yodas.py`` on the port's own ``data.segment`` and
``tokenizer``: the port imports nothing of the JAX package, and
``tests/test_torch_data_pipeline.py`` pins the copy to the original.
"""

from __future__ import annotations

import gzip
import json
import os
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from olmoasr_tpu_torch.data.segment import CTX_LIMIT, WINDOW_MS, token_budget
from olmoasr_tpu_torch.tokenizer import Tokenizer, get_tokenizer


@dataclass
class YodasSegment:
    utt_id: str
    seg_id: str
    start_s: float
    end_s: float
    texts: List[str]
    ts: List[Tuple[float, float]]  # rebased, seconds
    audio: Optional[np.ndarray] = None  # 16 kHz float32 slice

    def to_dict(self) -> Dict:
        return {
            "utt_id": self.utt_id,
            "seg_id": self.seg_id,
            "start": self.start_s,
            "end": self.end_s,
            "text": self.texts,
            "ts": [list(t) for t in self.ts],
            "dur": self.end_s - self.start_s,
        }


def reseg_row(
    row: Dict,
    tokenizer: Optional[Tokenizer] = None,
    sample_rate: int = 16000,
) -> List[YodasSegment]:
    """Re-chunk one YODAS row into ≤30s, ≤448-token segments
    (reseg_yodas.py:247-434)."""
    tokenizer = tokenizer or get_tokenizer(False)
    texts: List[str] = list(row["text"])
    ts: List[Tuple[float, float]] = [tuple(t) for t in row["ts"]]
    audio = row.get("audio")
    if isinstance(audio, dict):  # HF audio feature
        audio = np.asarray(audio["array"], np.float32)
    utt_id = row.get("utt_id", "")

    segments: List[YodasSegment] = []
    i = 0
    n = len(ts)
    while i < n:
        seg_start = ts[i][0]
        j = i
        # greedy: fit utterances in 30s AND the token budget
        while j < n and (ts[j][1] - seg_start) * 1000 <= WINDOW_MS:
            cues = [
                (int(ts[k][0] * 1000), int(ts[k][1] * 1000), texts[k])
                for k in range(i, j + 1)
            ]
            if not token_budget(cues, tokenizer)["no_ts_mode"]:
                break
            j += 1
        if j == i:
            # single utterance too long/too token-heavy: skip it
            i += 1
            continue
        seg_end = ts[j - 1][1]
        seg = YodasSegment(
            utt_id=utt_id,
            seg_id=f"{utt_id}_{len(segments)}",
            start_s=seg_start,
            end_s=seg_end,
            texts=texts[i:j],
            ts=[(s - seg_start, e - seg_start) for s, e in ts[i:j]],
            audio=(
                audio[int(seg_start * sample_rate) : int(seg_end * sample_rate)]
                if audio is not None
                else None
            ),
        )
        segments.append(seg)
        i = j
    return segments


def process_arrow_file(path: str, out_dir: str, audio_out: bool = True) -> int:
    """Read a YODAS Arrow file and write resegmented rows
    (reseg_yodas.py:434-495)."""
    import pyarrow as pa  # via datasets

    os.makedirs(out_dir, exist_ok=True)
    base = os.path.splitext(os.path.basename(path))[0]
    out_jsonl = os.path.join(out_dir, f"{base}_reseg.jsonl.gz")
    n = 0
    with pa.memory_map(path) as source:
        reader = pa.ipc.open_stream(source)
        with gzip.open(out_jsonl, "wt", encoding="utf-8") as out:
            for batch in reader:
                for row in batch.to_pylist():
                    for seg in reseg_row(row):
                        if audio_out and seg.audio is not None:
                            npy = os.path.join(out_dir, f"{seg.seg_id}.npy")
                            np.save(npy, (seg.audio * 32768).astype(np.int16))
                        out.write(json.dumps(seg.to_dict()) + "\n")
                        n += 1
    return n


def main(arrow_paths: Sequence[str], out_dir: str, num_workers: int = 0) -> int:
    if num_workers > 0:
        import multiprocessing as mp
        from functools import partial

        with mp.Pool(num_workers) as pool:
            return sum(
                pool.map(partial(process_arrow_file, out_dir=out_dir), arrow_paths)
            )
    return sum(process_arrow_file(p, out_dir) for p in arrow_paths)
