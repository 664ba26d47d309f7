"""Audio language identification for data filtering.

Rebuild of the reference's ``scripts/data/filtering/tag_audio_lang.py`` (batch
lang-ID over segment audio with majority vote per video ->
``ids_to_lang.json.gz``) and ``assign_audio_lang_data.py`` (merge the id->lang
map into JSONL shards as ``audio_lang``).

The reference uses SpeechBrain's VoxLingua107 ECAPA classifier (CUDA). Here the
classifier is pluggable: a SpeechBrain torch-CPU backend when the package is
available (tagging is offline), else a caller-provided ``classify_fn``. The
surrounding machinery (batching, majority vote, map write/apply) is
self-contained.

A copy of ``olmoasr_tpu/data/audio_lang.py`` on the port's own ``audio``: the
port imports nothing of the JAX package, and
``tests/test_torch_data_pipeline.py`` pins the copy to the original.
"""

from __future__ import annotations

import gzip
import json
import os
from collections import Counter, defaultdict
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np


def speechbrain_classifier(device: str = "cpu") -> Callable[[np.ndarray], str]:
    """VoxLingua107 ECAPA backend (tag_audio_lang.py:343-347); requires
    speechbrain + network for the model download."""
    from speechbrain.pretrained import EncoderClassifier  # type: ignore

    model = EncoderClassifier.from_hparams(
        source="speechbrain/lang-id-voxlingua107-ecapa", run_opts={"device": device}
    )

    def classify(wav: np.ndarray) -> str:
        import torch

        out = model.classify_batch(torch.from_numpy(wav)[None])
        return out[3][0].split(":")[0].strip()

    return classify


def identify_segment_languages(
    segments: Iterable[Tuple[str, str]],  # (video_id, audio_path)
    classify_fn: Callable[[np.ndarray], str],
    *,
    max_per_video: int = 5,
) -> Dict[str, str]:
    """Majority vote across up to N segments per video
    (tag_audio_lang.py:188-256)."""
    votes: Dict[str, Counter] = defaultdict(Counter)
    seen: Dict[str, int] = defaultdict(int)
    for video_id, audio_path in segments:
        if seen[video_id] >= max_per_video:
            continue
        seen[video_id] += 1
        arr = np.load(audio_path) if audio_path.endswith(".npy") else None
        if arr is None:
            from olmoasr_tpu_torch.audio import load_audio

            arr = load_audio(audio_path)
        else:
            arr = arr.astype(np.float32) / 32768.0
        votes[video_id][classify_fn(arr)] += 1
    return {vid: c.most_common(1)[0][0] for vid, c in votes.items()}


def write_lang_map(lang_map: Dict[str, str], out_path: str):
    """ids_to_lang.json.gz (tag_audio_lang.py:393-398)."""
    with gzip.open(out_path, "wt", encoding="utf-8") as f:
        json.dump(lang_map, f)


def load_lang_map(path: str) -> Dict[str, str]:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt", encoding="utf-8") as f:
        return json.load(f)


def assign_audio_language_to_file(
    jsonl_path: str, lang_map: Dict[str, str], out_dir: str
) -> int:
    """Merge id->lang into one shard as ``audio_lang``
    (assign_audio_lang_data.py:180-276)."""
    opener = gzip.open if jsonl_path.endswith(".gz") else open
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, os.path.basename(jsonl_path))
    out_opener = gzip.open if out_path.endswith(".gz") else open
    n = 0
    with opener(jsonl_path, "rt", encoding="utf-8") as fin, out_opener(
        out_path, "wt", encoding="utf-8"
    ) as fout:
        for line in fin:
            if not line.strip():
                continue
            row = json.loads(line)
            vid = row.get("id") or row.get("video_id")
            row["audio_lang"] = lang_map.get(vid, "unknown")
            fout.write(json.dumps(row) + "\n")
            n += 1
    return n


def main(
    jsonl_paths: Sequence[str],
    lang_map_path: str,
    out_dir: str,
    num_workers: int = 0,
) -> int:
    lang_map = load_lang_map(lang_map_path)
    if num_workers > 0:
        import multiprocessing as mp
        from functools import partial

        with mp.Pool(num_workers) as pool:
            counts = pool.map(
                partial(
                    assign_audio_language_to_file, lang_map=lang_map, out_dir=out_dir
                ),
                jsonl_paths,
            )
        return sum(counts)
    return sum(
        assign_audio_language_to_file(p, lang_map, out_dir) for p in jsonl_paths
    )
