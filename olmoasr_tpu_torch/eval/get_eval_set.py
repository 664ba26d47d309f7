"""Eval-set downloaders.

Rebuild of the reference's ``scripts/eval/get_eval_set.py``: wget/tar for the
classic corpora (eval.py's loaders then parse the extracted trees) and
HF ``datasets`` for the rest, normalized into the JSONL manifest format that
``olmoasr_tpu_torch.eval.datasets.ManifestLoader`` reads.

Network-dependent by nature; every function degrades to a clear error when
offline. LDC-licensed sets (WSJ, HUB5, CORAAL mirrors) must be fetched
manually, like in the reference (get_eval_set.py:615-616 NotImplemented).

A copy of ``olmoasr_tpu/eval/get_eval_set.py``: the port imports nothing of
the JAX package, and ``tests/test_torch_data_pipeline.py`` pins the copy to
the original.
"""

from __future__ import annotations

import json
import os
import tarfile
import urllib.request
from typing import Dict, List, Optional

URLS = {
    "librispeech_clean": "https://www.openslr.org/resources/12/test-clean.tar.gz",
    "librispeech_other": "https://www.openslr.org/resources/12/test-other.tar.gz",
    "artie": "https://ml-corpora-artie.s3-us-west-2.amazonaws.com/artie-bias-corpus.tar.gz",
    "tedlium": "https://projets-lium.univ-lemans.fr/wp-content/uploads/corpus/TED-LIUM/TEDLIUM_release-3.tgz",
    "kincaid46": "https://www.rev.com/blog/wp-content/uploads/2020/03/kincaid46.zip",
}

HF_SETS = {
    # eval-set name -> (dataset path, config, split, text column)
    "fleurs": ("google/fleurs", "en_us", "test", "transcription"),
    "voxpopuli": ("facebook/voxpopuli", "en", "test", "normalized_text"),
    "common_voice": ("mozilla-foundation/common_voice_5_1", "en", "test", "sentence"),
    "tedlium_hf": ("LIUM/tedlium", "release3", "test", "text"),
    "ami_ihm": ("edinburghcstr/ami", "ihm", "test", "text"),
    "ami_sdm": ("edinburghcstr/ami", "sdm", "test", "text"),
    "meanwhile": ("distil-whisper/meanwhile", None, "test", "text"),
    "rev16": ("distil-whisper/rev16", "whisper_subset", "test", "transcription"),
    "earnings21": ("distil-whisper/earnings21", "full", "test", "transcription"),
    "earnings22": ("distil-whisper/earnings22", "full", "test", "transcription"),
}


def download_and_extract(url: str, dest_dir: str) -> str:
    os.makedirs(dest_dir, exist_ok=True)
    fname = os.path.join(dest_dir, os.path.basename(url))
    if not os.path.exists(fname):
        print(f"downloading {url}")
        urllib.request.urlretrieve(url, fname)
    if fname.endswith((".tar.gz", ".tgz")):
        with tarfile.open(fname) as tar:
            tar.extractall(dest_dir)
    elif fname.endswith(".zip"):
        import zipfile

        with zipfile.ZipFile(fname) as z:
            z.extractall(dest_dir)
    return dest_dir


def materialize_hf_set(eval_set: str, dest_dir: str, max_samples: Optional[int] = None):
    """Export an HF dataset to wav files + a JSONL manifest (our normalized
    layout; avoids keeping HF/arrow in the eval path)."""
    import numpy as np
    import scipy.io.wavfile as wavfile
    from datasets import load_dataset

    path, config, split, text_col = HF_SETS[eval_set]
    ds = load_dataset(path, config, split=split, trust_remote_code=True)
    os.makedirs(os.path.join(dest_dir, "audio"), exist_ok=True)
    manifest = os.path.join(dest_dir, f"{eval_set}.jsonl")
    with open(manifest, "w", encoding="utf-8") as f:
        for i, row in enumerate(ds):
            if max_samples and i >= max_samples:
                break
            audio = row["audio"]
            rel = os.path.join("audio", f"{eval_set}_{i:06d}.wav")
            arr = np.asarray(audio["array"], dtype=np.float32)
            wavfile.write(
                os.path.join(dest_dir, rel),
                audio["sampling_rate"],
                (arr * 32767).astype(np.int16),
            )
            f.write(json.dumps({"audio": rel, "text": row[text_col], "id": str(i)}) + "\n")
    return manifest


CHIME6_URLS = [
    "https://www.openslr.org/resources/150/CHiME6_eval.tar.gz",
    "https://www.openslr.org/resources/150/CHiME6_transcriptions.tar.gz",
]


def _ts_seconds(ts: str) -> float:
    parts = [float(p) for p in str(ts).split(":")]
    while len(parts) < 3:
        parts.insert(0, 0.0)
    return parts[0] * 3600 + parts[1] * 60 + parts[2]


def segment_chime6(chime_dir: str, out_dir: Optional[str] = None) -> str:
    """Cut per-utterance wavs from the CHiME-6 session recordings using the
    transcript timestamps (reference get_eval_set.py:456-614 does this with
    pydub; this is a native numpy/scipy reimplementation) and write a JSONL
    manifest. Expects the openslr 150 layout: ``audio/*.wav`` (P* binaural
    preferred) + ``transcripts/S*.json``."""
    import glob as _glob
    import re as _re

    import numpy as np
    import scipy.io.wavfile as wavfile

    out_dir = out_dir or chime_dir
    seg_dir = os.path.join(out_dir, "segments")
    os.makedirs(seg_dir, exist_ok=True)
    manifest = os.path.join(out_dir, "chime6_segments.jsonl")
    trans = sorted(
        _glob.glob(os.path.join(chime_dir, "transcripts", "*.json"))
        or _glob.glob(os.path.join(chime_dir, "transcriptions", "eval", "*.json"))
    )
    n = 0
    wav_cache: dict = {}

    def session_wav(session: str, speaker):
        """The utterance speaker's own worn mic when present (the reference
        cuts each utterance from that speaker's binaural recording), else the
        session's first P-mic."""
        cand = os.path.join(chime_dir, "audio", f"{session}_{speaker}.wav")
        if not (speaker and os.path.isfile(cand)):
            wavs = sorted(
                _glob.glob(os.path.join(chime_dir, "audio", f"{session}_P*.wav"))
            )
            if not wavs:
                return None, None, None
            cand = wavs[0]
        if cand not in wav_cache:
            rate, data = wavfile.read(cand)
            if data.ndim > 1:
                data = data[:, 0]
            wav_cache[cand] = (rate, data)
        mic = os.path.splitext(os.path.basename(cand))[0].split("_")[-1]
        return (*wav_cache[cand], mic)

    with open(manifest, "w", encoding="utf-8") as mf:
        for tj in trans:
            session = os.path.splitext(os.path.basename(tj))[0]
            with open(tj, encoding="utf-8") as f:
                utts = json.load(f)
            for utt in utts:
                text = _re.sub(
                    r"\s+", " ",
                    _re.sub(r"\[[^\]]*\]", "", utt.get("words", "")),
                ).strip()
                if not text:
                    continue
                rate, data, mic = session_wav(session, utt.get("speaker"))
                if data is None:
                    continue
                start, end = utt.get("start_time"), utt.get("end_time")
                if isinstance(start, dict):
                    # per-device timestamp dicts: use the chosen mic's clock
                    key = mic if mic in start else next(iter(start))
                    start, end = start[key], end[key]
                s = int(_ts_seconds(start) * rate)
                e = int(_ts_seconds(end) * rate)
                if e <= s or (e - s) > 30 * rate:
                    continue
                rel = os.path.join("segments", f"{session}_{n:06d}.wav")
                wavfile.write(os.path.join(out_dir, rel), rate, data[s:e])
                mf.write(
                    json.dumps({"audio": rel, "text": text, "id": f"{session}_{n}"})
                    + "\n"
                )
                n += 1
    print(f"chime6: wrote {n} segments -> {manifest}")
    return manifest


def get_chime6(eval_dir: str) -> str:
    """Download + extract + segment CHiME-6 eval (openslr 150; the only
    HUB-licensed-free path the reference supports, get_eval_set.py:456-614)."""
    import glob as _glob
    import shutil

    dest = os.path.join(eval_dir, "chime6")
    for url in CHIME6_URLS:
        download_and_extract(url, dest)
    # normalize the extracted layout -> audio/ + transcripts/
    if os.path.isdir(os.path.join(dest, "CHiME6_eval")):
        os.rename(
            os.path.join(dest, "CHiME6_eval", "CHiME6", "audio", "eval"),
            os.path.join(dest, "audio"),
        )
        shutil.rmtree(os.path.join(dest, "CHiME6_eval"))
        for p in _glob.glob(os.path.join(dest, "audio", "*_U*.wav")):
            os.remove(p)  # array mics unused (reference keeps binaural P*)
    tdir = os.path.join(dest, "transcriptions", "transcriptions")
    if os.path.isdir(tdir):
        os.rename(os.path.join(tdir, "eval"), os.path.join(dest, "transcripts"))
        shutil.rmtree(os.path.join(dest, "transcriptions"))
    segment_chime6(dest)
    return dest


def get_eval_set(eval_set: str, eval_dir: str, max_samples: Optional[int] = None) -> str:
    """Fetch + normalize one eval set under ``eval_dir`` (get_eval_set.py:92)."""
    dest = os.path.join(eval_dir, eval_set)
    if eval_set in URLS:
        return download_and_extract(URLS[eval_set], dest)
    if eval_set == "chime6":
        return get_chime6(eval_dir)
    if eval_set in HF_SETS:
        materialize_hf_set(eval_set, dest, max_samples)
        return dest
    if eval_set in ("wsj", "callhome", "switchboard", "coraal"):
        raise NotImplementedError(
            f"{eval_set} requires a manual (LDC/licensed) download; place the "
            f"corpus under {dest} in its standard layout"
        )
    raise ValueError(f"unknown eval set: {eval_set}")


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--eval_set", required=True)
    p.add_argument("--eval_dir", required=True)
    p.add_argument("--max_samples", type=int, default=None)
    a = p.parse_args()
    get_eval_set(a.eval_set, a.eval_dir, a.max_samples)
