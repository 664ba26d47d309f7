"""QA sample rendering: audio + subtitle videos for human data inspection.

Rebuild of the reference's ``scripts/data/filtering/gen_video_samples.py``:
render sampled training segments as mp4 (audio + burned-in subtitles) via
moviepy when available; always falls back to writing paired .wav + .vtt + .txt
inspection bundles (which cover the QA purpose without the moviepy/ffmpeg
dependency chain).

A copy of ``olmoasr_tpu/data/qa_video.py``: the port imports nothing of the
JAX package, and ``tests/test_torch_data_pipeline.py`` pins the copy to the
original.
"""

from __future__ import annotations

import gzip
import json
import os
import random
from typing import Dict, List, Optional, Sequence

import numpy as np


def _write_bundle(row: Dict, out_dir: str, idx: int) -> str:
    import scipy.io.wavfile as wavfile

    base = os.path.join(out_dir, f"sample_{idx:04d}")
    audio_file = row.get("audio_file")
    if audio_file and os.path.isfile(audio_file):
        arr = np.load(audio_file)
        wavfile.write(base + ".wav", 16000, arr.astype(np.int16))
    with open(base + ".vtt", "w", encoding="utf-8") as f:
        f.write(row.get("seg_content", ""))
    with open(base + ".json", "w", encoding="utf-8") as f:
        json.dump({k: v for k, v in row.items() if k != "seg_content"}, f, indent=2)
    return base


def generate_video(row: Dict, out_dir: str, idx: int) -> Optional[str]:
    """mp4 with burned-in subtitles (gen_video_samples.py:105-390) when moviepy
    is available; otherwise the .wav/.vtt bundle."""
    base = _write_bundle(row, out_dir, idx)
    try:
        from moviepy.editor import AudioFileClip, ColorClip, TextClip  # type: ignore
    except ImportError:
        return None
    try:
        audio = AudioFileClip(base + ".wav")
        clip = ColorClip(size=(640, 360), color=(0, 0, 0), duration=audio.duration)
        clip = clip.set_audio(audio)
        clip.write_videofile(base + ".mp4", fps=4, logger=None)
        return base + ".mp4"
    except Exception:
        return None


def gen_video_samples(
    jsonl_paths: Sequence[str],
    out_dir: str,
    n_samples: int = 20,
    seed: int = 42,
) -> List[str]:
    """Sample rows across shards and render QA bundles
    (gen_video_samples.py:391-450)."""
    rng = random.Random(seed)
    rows: List[Dict] = []
    for path in jsonl_paths:
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt", encoding="utf-8") as f:
            for line in f:
                if line.strip():
                    rows.append(json.loads(line))
    rng.shuffle(rows)
    os.makedirs(out_dir, exist_ok=True)
    outputs = []
    for i, row in enumerate(rows[:n_samples]):
        generate_video(row, out_dir, i)
        outputs.append(os.path.join(out_dir, f"sample_{i:04d}"))
    return outputs
