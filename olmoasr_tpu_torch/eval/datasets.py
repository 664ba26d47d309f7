"""Evaluation dataset loaders.

Rebuild of the loader layer in ``scripts/eval/eval.py:283-985``:
a ``BaseDatasetLoader`` per corpus + ``DatasetFactory``. Each loader parses a
locally downloaded corpus tree into (audio_path_or_array, reference_text)
pairs; downloading lives in the JAX package's
``olmoasr_tpu.eval.get_eval_set``, which the port does not carry.

Short-form sets yield ≤30s utterances (batched ``decode``); long-form sets
yield whole recordings (``transcribe``). CORAAL text cleaning mirrors
``eval.py:227-280``.

A copy of ``olmoasr_tpu/eval/datasets.py``, every loader included (the port
imports nothing of the JAX package); ``tests/test_torch_eval.py`` holds each
loader's items to the original's on the same trees.
"""

from __future__ import annotations

import csv
import glob
import json
import os
import re
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np


@dataclass
class EvalItem:
    audio: Union[str, np.ndarray]  # path or waveform
    text: str
    id: Optional[str] = None
    # optional segment window inside the audio file (seconds)
    start: Optional[float] = None
    end: Optional[float] = None


class BaseDatasetLoader:
    """Subclasses parse one corpus layout. ``load()`` -> List[EvalItem]."""

    name: str = ""
    long_form: bool = False

    def __init__(self, eval_dir: str):
        self.eval_dir = eval_dir

    def load(self) -> List[EvalItem]:
        raise NotImplementedError


class LibriSpeechLoader(BaseDatasetLoader):
    """LibriSpeech layout: <root>/<split>/<spk>/<chap>/<spk>-<chap>-<utt>.flac
    with a ``<spk>-<chap>.trans.txt`` per chapter (eval.py:320-373)."""

    name = "librispeech"

    def __init__(self, eval_dir: str, split: str = "test-clean"):
        super().__init__(eval_dir)
        self.split = split

    def load(self) -> List[EvalItem]:
        root = os.path.join(self.eval_dir, "LibriSpeech", self.split)
        if not os.path.isdir(root):
            root = os.path.join(self.eval_dir, self.split)
        items: List[EvalItem] = []
        for trans in sorted(
            glob.glob(os.path.join(root, "*", "*", "*.trans.txt"))
        ):
            chapter_dir = os.path.dirname(trans)
            with open(trans, encoding="utf-8") as f:
                for line in f:
                    utt_id, _, text = line.strip().partition(" ")
                    for ext in (".flac", ".wav"):
                        audio = os.path.join(chapter_dir, utt_id + ext)
                        if os.path.isfile(audio):
                            items.append(EvalItem(audio=audio, text=text, id=utt_id))
                            break
        return items


class ArtieLoader(BaseDatasetLoader):
    """Artie bias corpus TSV (eval.py:374-416)."""

    name = "artie"

    def load(self) -> List[EvalItem]:
        items = []
        for tsv in glob.glob(os.path.join(self.eval_dir, "**", "*.tsv"), recursive=True):
            with open(tsv, encoding="utf-8") as f:
                reader = csv.DictReader(f, delimiter="\t")
                for row in reader:
                    path = row.get("path") or row.get("audio")
                    text = row.get("sentence") or row.get("text") or ""
                    if path:
                        items.append(
                            EvalItem(
                                audio=os.path.join(os.path.dirname(tsv), path),
                                text=text,
                            )
                        )
        return items


class TedliumLoader(BaseDatasetLoader):
    """TED-LIUM release 3 STM segments (short-form) or full talks (long-form)."""

    name = "tedlium"

    def __init__(self, eval_dir: str, long_form: bool = False):
        super().__init__(eval_dir)
        self.long_form = long_form

    def load(self) -> List[EvalItem]:
        stm_dir = None
        for cand in ("legacy/test/stm", "test/stm", "stm"):
            p = os.path.join(self.eval_dir, cand)
            if os.path.isdir(p):
                stm_dir = p
                break
        if stm_dir is None:
            hits = glob.glob(
                os.path.join(self.eval_dir, "**", "*.stm"), recursive=True
            )
            stm_files = sorted(hits)
        else:
            stm_files = sorted(glob.glob(os.path.join(stm_dir, "*.stm")))

        items: List[EvalItem] = []
        for stm in stm_files:
            sph_dir = os.path.join(os.path.dirname(os.path.dirname(stm)), "sph")
            talk_texts: List[str] = []
            talk_audio = None
            with open(stm, encoding="utf-8") as f:
                for line in f:
                    parts = line.strip().split(None, 6)
                    if len(parts) < 7:
                        continue
                    wav_id, _, _, start, end, _, text = parts
                    if "ignore_time_segment_in_scoring" in text:
                        continue
                    audio = None
                    for ext in (".sph", ".wav"):
                        cand = os.path.join(sph_dir, wav_id + ext)
                        if os.path.isfile(cand):
                            audio = cand
                            break
                    if audio is None:
                        continue
                    talk_audio = audio
                    text = text.replace(" <unk>", "").strip()
                    if self.long_form:
                        talk_texts.append(text)
                    else:
                        items.append(
                            EvalItem(
                                audio=audio, text=text,
                                start=float(start), end=float(end),
                            )
                        )
            if self.long_form and talk_audio is not None and talk_texts:
                items.append(EvalItem(audio=talk_audio, text=" ".join(talk_texts)))
        return items


_CORAAL_BRACKETS = re.compile(r"(\[|\<)[^\]\>]*(\]|\>)")
_CORAAL_PAREN = re.compile(r"\([^)]*\)")


def clean_coraal_text(text: str) -> str:
    """CORAAL transcript cleaning (eval.py:227-280): drop markup/pauses,
    normalize interjections."""
    text = _CORAAL_BRACKETS.sub("", text)
    text = _CORAAL_PAREN.sub("", text)
    text = text.replace("/", " ")
    text = re.sub(r"\buh+m*\b|\bum+\b|\bmm+\b|\bhm+\b", "", text, flags=re.I)
    text = re.sub(r"\s+", " ", text)
    return text.strip()


class CoraalLoader(BaseDatasetLoader):
    """CORAAL: per-component wav + tab-separated transcript files
    (eval.py:533-581 short-form, 851-892 long-form)."""

    name = "coraal"

    def __init__(self, eval_dir: str, long_form: bool = False):
        super().__init__(eval_dir)
        self.long_form = long_form

    def load(self) -> List[EvalItem]:
        items: List[EvalItem] = []
        for txt in sorted(
            glob.glob(os.path.join(self.eval_dir, "**", "*.txt"), recursive=True)
        ):
            wav = txt.replace(".txt", ".wav")
            if not os.path.isfile(wav):
                continue
            segs: List[Tuple[float, float, str]] = []
            with open(txt, encoding="utf-8", errors="replace") as f:
                reader = csv.DictReader(f, delimiter="\t")
                if not reader.fieldnames or "Content" not in reader.fieldnames:
                    continue
                for row in reader:
                    content = clean_coraal_text(row.get("Content", ""))
                    spkr = row.get("Spkr", "")
                    if not content or "misc" in spkr.lower():
                        continue
                    try:
                        st, en = float(row["StTime"]), float(row["EnTime"])
                    except (KeyError, ValueError):
                        continue
                    segs.append((st, en, content))
            if not segs:
                continue
            if self.long_form:
                items.append(EvalItem(audio=wav, text=" ".join(s[2] for s in segs)))
            else:
                for st, en, content in segs:
                    if en - st <= 30.0:
                        items.append(
                            EvalItem(audio=wav, text=content, start=st, end=en)
                        )
        return items


class AMILoader(BaseDatasetLoader):
    """AMI ihm/sdm via segment files (eval.py:493-532)."""

    name = "ami"

    def __init__(self, eval_dir: str, mic: str = "ihm"):
        super().__init__(eval_dir)
        self.mic = mic

    def load(self) -> List[EvalItem]:
        items = []
        manifest = os.path.join(self.eval_dir, f"ami_{self.mic}.jsonl")
        if os.path.isfile(manifest):
            with open(manifest, encoding="utf-8") as f:
                for line in f:
                    row = json.loads(line)
                    items.append(
                        EvalItem(
                            audio=row["audio"], text=row["text"],
                            start=row.get("start"), end=row.get("end"),
                        )
                    )
        return items


class ManifestLoader(BaseDatasetLoader):
    """Generic JSONL manifest: {audio, text, [start, end]} per line — the
    normalized on-disk format our downloader writes for HF-sourced sets
    (tedlium/voxpopuli/common_voice/fleurs/meanwhile/rev16/earnings21/22...)."""

    name = "manifest"

    def __init__(self, eval_dir: str, manifest_name: str, long_form: bool = False):
        super().__init__(eval_dir)
        self.manifest_name = manifest_name
        self.long_form = long_form

    def load(self) -> List[EvalItem]:
        path = os.path.join(self.eval_dir, self.manifest_name)
        items = []
        with open(path, encoding="utf-8") as f:
            for line in f:
                if not line.strip():
                    continue
                row = json.loads(line)
                audio = row["audio"]
                if not os.path.isabs(audio):
                    audio = os.path.join(self.eval_dir, audio)
                items.append(
                    EvalItem(
                        audio=audio, text=row["text"], id=row.get("id"),
                        start=row.get("start"), end=row.get("end"),
                    )
                )
        return items


class WSJLoader(BaseDatasetLoader):
    """WSJ via kaldi-style wav.scp + text (eval.py:633-685)."""

    name = "wsj"

    def load(self) -> List[EvalItem]:
        wav_scp = os.path.join(self.eval_dir, "wav.scp")
        text_f = os.path.join(self.eval_dir, "text")
        if not (os.path.isfile(wav_scp) and os.path.isfile(text_f)):
            return []
        wavs: Dict[str, str] = {}
        with open(wav_scp, encoding="utf-8") as f:
            for line in f:
                utt, _, rest = line.strip().partition(" ")
                wavs[utt] = rest
        items = []
        with open(text_f, encoding="utf-8") as f:
            for line in f:
                utt, _, text = line.strip().partition(" ")
                if utt in wavs:
                    items.append(EvalItem(audio=wavs[utt], text=text, id=utt))
        return items


def remix_channel(sph_path: str, wav_path: str, channel: str) -> bool:
    """Extract one channel of a 2-channel SPHERE/WAV file to a mono wav
    (the reference shells out to ``sox <sph> <wav> remix 1|2``,
    eval.py:784-788). Prefers sox when installed; falls back to a native
    NIST-SPHERE PCM parser (header 'NIST_1A' + key/value block + interleaved
    16-bit PCM) so LDC trees work without sox."""
    import shutil as _shutil
    import subprocess

    ch_idx = 0 if channel.upper() == "A" else 1
    if _shutil.which("sox"):
        r = subprocess.run(
            ["sox", sph_path, wav_path, "remix", str(ch_idx + 1)],
            capture_output=True,
        )
        if r.returncode == 0:
            return True
    try:
        with open(sph_path, "rb") as f:
            head = f.read(1024)
            if not head.startswith(b"NIST_1A"):
                return False
            header_size = int(head.splitlines()[1].strip())
            text = head[:header_size].decode("ascii", errors="replace")
            fields = {}
            for line in text.splitlines():
                parts = line.split()
                if len(parts) >= 3 and parts[1].startswith("-"):
                    fields[parts[0]] = parts[2]
            n_ch = int(fields.get("channel_count", 2))
            rate = int(fields.get("sample_rate", 8000))
            fmt = fields.get("sample_coding", "pcm")
            if "pcm" not in fmt:
                return False  # ulaw/shorten need sox
            # sample_byte_format: '10' = big-endian (the common NIST layout),
            # '01' = little-endian
            byte_fmt = fields.get("sample_byte_format", "01")
            dtype = ">i2" if byte_fmt == "10" else "<i2"
            f.seek(header_size)
            data = np.frombuffer(f.read(), dtype=dtype)
        mono = data.reshape(-1, n_ch)[:, ch_idx].astype("<i2")
        from scipy.io import wavfile

        wavfile.write(wav_path, rate, np.ascontiguousarray(mono))
        return True
    except Exception:
        return False


class Hub5Loader(BaseDatasetLoader):
    """CallHome / Switchboard from HUB5 2000 STM (eval.py:686-805), with the
    reference's per-channel remix: segment channel A/B is cut from the stereo
    .sph, materialized once as ``<base>_<ch>.wav``."""

    name = "hub5"

    def __init__(self, eval_dir: str, subset: str = "callhome"):
        super().__init__(eval_dir)
        self.subset = subset  # callhome: en_*, switchboard: sw_*

    def load(self) -> List[EvalItem]:
        stm = os.path.join(self.eval_dir, "hub5e00.english.000405.stm")
        if not os.path.isfile(stm):
            cands = glob.glob(os.path.join(self.eval_dir, "**", "*.stm"), recursive=True)
            if not cands:
                return []
            stm = cands[0]
        prefix = "en_" if self.subset == "callhome" else "sw_"
        items = []
        with open(stm, encoding="utf-8", errors="replace") as f:
            for line in f:
                if line.startswith(";;"):
                    continue
                parts = line.strip().split(None, 6)
                if len(parts) < 7:
                    continue
                wav_id, channel, _, start, end, _, text = parts
                if not wav_id.lower().startswith(prefix):
                    continue
                if "ignore_time_segment_in_scoring" in text:
                    continue
                # strip the leading STM tag exactly like the reference
                # (eval.py:790: re.split('<[^>]+>', line)[-1]) — NB this also
                # drops words BEFORE any inline tag, faithfully reproducing
                # the reference's behavior on nonstandard lines
                text = re.split(r"<[^>]+>", text)[-1].strip()
                audio = os.path.join(
                    self.eval_dir, "wav", f"{wav_id.lower()}_{channel}.wav"
                )
                if not os.path.isfile(audio):
                    # remix from the LDC sphere layout (hub5e_00/english/*.sph)
                    sph = glob.glob(os.path.join(
                        self.eval_dir, "**", f"{wav_id.lower()}.sph"
                    ), recursive=True)
                    if sph:
                        os.makedirs(os.path.dirname(audio), exist_ok=True)
                        if not remix_channel(sph[0], audio, channel):
                            continue
                    else:
                        # fall through: loader may still find a flat wav
                        flat = os.path.join(
                            self.eval_dir, f"{wav_id.lower()}_{channel}.wav"
                        )
                        if os.path.isfile(flat):
                            audio = flat
                items.append(
                    EvalItem(
                        audio=audio, text=text,
                        start=float(start), end=float(end),
                    )
                )
        return items


class CHiME6Loader(BaseDatasetLoader):
    """CHiME-6 dinner-party corpus (eval.py:582-632; the reference segments it
    at download time with pydub — here we read the official layout directly):
    ``transcriptions/<split>/S*.json`` utterance lists + per-session array
    wavs under ``audio/<split>/``."""

    name = "chime6"

    def __init__(self, eval_dir: str, split: str = "eval"):
        super().__init__(eval_dir)
        self.split = split

    @staticmethod
    def _t(ts: str) -> float:
        parts = [float(p) for p in ts.split(":")]
        while len(parts) < 3:
            parts.insert(0, 0.0)
        return parts[0] * 3600 + parts[1] * 60 + parts[2]

    def load(self) -> List[EvalItem]:
        items: List[EvalItem] = []
        trans_dir = os.path.join(self.eval_dir, "transcriptions", self.split)
        audio_dir = os.path.join(self.eval_dir, "audio", self.split)
        for tj in sorted(glob.glob(os.path.join(trans_dir, "*.json"))):
            session = os.path.splitext(os.path.basename(tj))[0]
            # prefer the reference's binaural/worn mics, else the first array
            wavs = sorted(glob.glob(os.path.join(audio_dir, f"{session}_P*.wav"))) or \
                sorted(glob.glob(os.path.join(audio_dir, f"{session}_U*.wav")))
            if not wavs:
                continue
            wav = wavs[0]
            with open(tj, encoding="utf-8") as f:
                utts = json.load(f)
            for utt in utts:
                text = utt.get("words", "")
                text = re.sub(r"\[[^\]]*\]", "", text).strip()  # [noise] etc
                if not text:
                    continue
                start = utt.get("start_time")
                end = utt.get("end_time")
                if isinstance(start, dict):  # per-mic dict in some releases
                    start = next(iter(start.values()))
                    end = next(iter(end.values()))
                s, e = self._t(str(start)), self._t(str(end))
                if e - s <= 0 or e - s > 30:
                    continue
                items.append(EvalItem(audio=wav, text=text, start=s, end=e))
        return items


class Kincaid46Loader(BaseDatasetLoader):
    """Kincaid46 long-form set (eval.py:806-850)."""

    name = "kincaid46"
    long_form = True

    def load(self) -> List[EvalItem]:
        csv_path = os.path.join(self.eval_dir, "kincaid46.csv")
        if not os.path.isfile(csv_path):
            return ManifestLoader(self.eval_dir, "kincaid46.jsonl", True).load()
        items = []
        with open(csv_path, encoding="utf-8") as f:
            for row in csv.DictReader(f):
                items.append(
                    EvalItem(
                        audio=os.path.join(self.eval_dir, "audio", row["audio"]),
                        text=row["text"],
                    )
                )
        return items


# --- factory ----------------------------------------------------------------

SHORT_FORM_SETS = [
    "librispeech_clean", "librispeech_other", "artie", "fleurs", "voxpopuli",
    "ami_ihm", "ami_sdm", "coraal", "chime6", "wsj", "callhome", "switchboard",
    "tedlium", "common_voice",
]
LONG_FORM_SETS = [
    "tedlium_long", "meanwhile", "kincaid46", "rev16", "earnings21",
    "earnings22", "coraal_long",
]


#: eval-set -> (HF path, config name, text column, long_form)
#: mirrors reference scripts/eval/eval.py:1098-1161 _init_hf_dataset
HF_DATASET_CONFIGS = {
    "fleurs": ("google/fleurs", "en_us", "transcription", False),
    "voxpopuli": ("facebook/voxpopuli", "en", "normalized_text", False),
    "common_voice": (
        "mozilla-foundation/common_voice_5_1", "en", "sentence", False,
    ),
    "tedlium_hf_long": (
        "distil-whisper/tedlium-long-form", None, "text", True,
    ),
    "meanwhile": ("distil-whisper/meanwhile", None, "text", True),
    "rev16": ("distil-whisper/rev16", "whisper_subset", "transcription", True),
    "earnings21": ("distil-whisper/earnings21", "full", "transcription", True),
    "earnings22": ("distil-whisper/earnings22", "full", "transcription", True),
}


class HFDatasetLoader(BaseDatasetLoader):
    """Native HuggingFace ``datasets`` loader (eval.py:1098-1161): loads the
    test split from the hub (or the ``eval_dir`` cache when already
    downloaded), decodes audio at 16 kHz, yields in-memory waveforms."""

    name = "hf"

    def __init__(self, eval_dir: str, eval_set: str, hf_token: Optional[str] = None):
        super().__init__(eval_dir)
        self.eval_set = eval_set
        self.hf_token = hf_token or os.environ.get("HF_TOKEN")

    def load(self) -> List[EvalItem]:
        try:
            from datasets import Audio, load_dataset
        except ImportError as e:  # pragma: no cover
            raise RuntimeError(
                f"eval set {self.eval_set} needs the `datasets` package"
            ) from e

        path, name, text_col, long_form = HF_DATASET_CONFIGS[self.eval_set]
        self.long_form = long_form
        kwargs = dict(path=path, split="test", cache_dir=self.eval_dir)
        if name:
            kwargs["name"] = name
        if self.hf_token:
            kwargs["token"] = self.hf_token
        ds = load_dataset(**kwargs)
        ds = ds.cast_column("audio", Audio(sampling_rate=16000))

        class _LazyAudio:
            """Decode the waveform on access — materializing a whole split of
            hours-long files (earnings21/22, rev16) would OOM the host."""

            def __init__(self, dataset, index):
                self._ds, self._i = dataset, index

            def load(self) -> np.ndarray:
                return np.asarray(
                    self._ds[self._i]["audio"]["array"], dtype=np.float32
                )

        items: List[EvalItem] = []
        texts = ds.remove_columns(
            [c for c in ds.column_names if c != text_col]
        )
        for i in range(len(ds)):
            text = texts[i].get(text_col) or ""
            if not text.strip():
                continue
            items.append(
                EvalItem(
                    audio=_LazyAudio(ds, i), text=text,
                    id=f"{self.eval_set}_{i}",
                )
            )
        return items


class DatasetFactory:
    """eval.py:893-985 analog: eval-set name -> loader."""

    @staticmethod
    def create_loader(eval_set: str, eval_dir: str) -> BaseDatasetLoader:
        if eval_set == "librispeech_clean":
            return LibriSpeechLoader(eval_dir, "test-clean")
        if eval_set == "librispeech_other":
            return LibriSpeechLoader(eval_dir, "test-other")
        if eval_set == "artie":
            return ArtieLoader(eval_dir)
        if eval_set == "tedlium":
            return TedliumLoader(eval_dir, long_form=False)
        if eval_set == "tedlium_long":
            return TedliumLoader(eval_dir, long_form=True)
        if eval_set == "coraal":
            return CoraalLoader(eval_dir, long_form=False)
        if eval_set == "coraal_long":
            return CoraalLoader(eval_dir, long_form=True)
        if eval_set in ("ami_ihm", "ami_sdm"):
            return AMILoader(eval_dir, mic=eval_set.split("_")[1])
        if eval_set == "wsj":
            return WSJLoader(eval_dir)
        if eval_set in ("callhome", "switchboard"):
            return Hub5Loader(eval_dir, subset=eval_set)
        if eval_set == "chime6":
            return CHiME6Loader(eval_dir)
        if eval_set == "kincaid46":
            return Kincaid46Loader(eval_dir)
        if eval_set in HF_DATASET_CONFIGS:
            # prefer a pre-normalized manifest when present (offline), else
            # load natively from the HF hub/cache (eval.py:1098-1161)
            manifest = os.path.join(eval_dir, f"{eval_set}.jsonl")
            if os.path.isfile(manifest):
                return ManifestLoader(
                    eval_dir, f"{eval_set}.jsonl",
                    HF_DATASET_CONFIGS[eval_set][3],
                )
            return HFDatasetLoader(eval_dir, eval_set)
        # anything else: the JSONL manifest convention
        long_form = eval_set in LONG_FORM_SETS
        return ManifestLoader(eval_dir, f"{eval_set}.jsonl", long_form)
