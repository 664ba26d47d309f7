"""Training dataset: audio/transcript segments -> (mel, text_input, text_target,
padding_mask) with the reference's exact token-building semantics.

Rebuild of ``AudioTextDataset``
(``scripts/training/train_timestamps.py:64-548``):

  * audio: int16 ``.npy`` (or wav) -> float32/32768 -> pad_or_trim(30s) ->
    log-mel (host NumPy); with ``device_mel`` the 30 s PCM itself (int16
    when the source is int16), and the train step computes the log-mel
  * text: VTT/SRT transcript -> tokens with a 50% coin flip between
    timestamp mode (<sot><t0>text<t1><t2>text<t3>…<next><next><eot>) and
    no-timestamp mode (<sot><notimestamps>text…<eot>); empty-transcript and
    >30s paths as in the reference
  * teacher forcing: input = tokens[:-1], target = tokens[1:], both padded to
    n_text_ctx with PADDING_TOKEN (51864); additive −inf padding mask

Host-side throughput: a prefetch thread feeds batches shaped
(accum, micro_B, ...).

A copy of ``olmoasr_tpu/training/dataset.py`` on the port's own copies of the
tokenizer, the transcript reader and the audio helpers (the port imports
nothing of the JAX package); ``tests/test_torch_training.py`` holds its
batches bit-equal to the original's, with and without ``device_mel``. Not
ported yet: ``YodasDataset``.
"""

from __future__ import annotations

import gzip
import json
import os
from dataclasses import dataclass
from itertools import chain
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

from olmoasr_tpu_torch.audio import load_audio, log_mel_spectrogram_np, pad_or_trim
from olmoasr_tpu_torch.data.transcripts import TranscriptReader
from olmoasr_tpu_torch.models.whisper import PADDING_TOKEN
from olmoasr_tpu_torch.tokenizer import Tokenizer, get_tokenizer
from olmoasr_tpu_torch.utils import convert_to_milliseconds


def convert_to_token_idx(timestamp: Union[str, int], timestamp_begin: int) -> Optional[int]:
    """Timestamp -> token id; None if > 30 s (train_timestamps.py:378-392)."""
    ts_ms = (
        convert_to_milliseconds(timestamp) if isinstance(timestamp, str) else timestamp
    )
    if ts_ms > 30000:
        return None
    return timestamp_begin + (ts_ms // 20)


def build_tokens(
    transcript: Dict[Tuple[str, str], str],
    tokenizer: Tokenizer,
    norm_end: Union[int, str],
    *,
    ts_mode: bool = True,
    only_no_ts_mode: bool = False,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[List[int], bool, int]:
    """The reference's token construction (train_timestamps.py:238-548).

    Returns (tokens, timestamp_mode, norm_end_ms).
    """
    rng = rng or np.random.default_rng()
    if isinstance(norm_end, str):
        norm_end = convert_to_milliseconds(norm_end)
    timestamp_mode = False

    if not transcript:
        tokens = _empty_transcript_tokens(tokenizer, norm_end, only_no_ts_mode, rng)
        if not only_no_ts_mode and norm_end < 30000:
            # mirrored coin flip bookkeeping (the flip happens inside)
            pass
        return tokens, timestamp_mode, norm_end

    # >30s segments: truncate and force no-timestamps
    if norm_end > 30000:
        if len(transcript) > 1:
            transcript = dict(transcript)
            del transcript[list(transcript.keys())[-1]]
            norm_end = convert_to_milliseconds(list(transcript.keys())[-1][1])
        only_no_ts_mode = True

    text_tokens = [
        tokenizer.encode(" " + text.strip()) for _, text in transcript.items()
    ]

    def no_ts():
        return (
            list(tokenizer.sot_sequence_including_notimestamps)
            + list(chain(*text_tokens))
            + [tokenizer.eot]
        )

    if only_no_ts_mode:
        return no_ts(), False, norm_end

    if rng.random() >= 0.5:  # 50% timestamp mode
        if ts_mode:
            ts_tokens = _timestamp_sequence(transcript, text_tokens, tokenizer, norm_end)
            if ts_tokens is not None:
                return ts_tokens, True, norm_end
        return no_ts(), False, norm_end
    return no_ts(), False, norm_end


def _empty_transcript_tokens(
    tokenizer: Tokenizer, norm_end: int, only_no_ts_mode: bool,
    rng: np.random.Generator,
) -> List[int]:
    """train_timestamps.py:345-392 (_process_empty_transcript)."""
    if norm_end > 30000:
        next_start = [tokenizer.timestamp_begin + (30000 // 20)]
    else:
        next_start = [tokenizer.timestamp_begin + (norm_end // 20)]

    if norm_end >= 30000:
        return (
            list(tokenizer.sot_sequence_including_notimestamps)
            + [tokenizer.no_speech]
            + [tokenizer.eot]
        )
    if only_no_ts_mode:
        return list(tokenizer.sot_sequence_including_notimestamps) + [tokenizer.eot]
    if rng.random() >= 0.5:
        return (
            [tokenizer.sot_sequence[0]]
            + [tokenizer.timestamp_begin]
            + next_start
            + next_start
            + [tokenizer.eot]
        )
    return list(tokenizer.sot_sequence_including_notimestamps) + [tokenizer.eot]


def _timestamp_sequence(
    transcript: Dict[Tuple[str, str], str],
    text_tokens: List[List[int]],
    tokenizer: Tokenizer,
    norm_end: int,
) -> Optional[List[int]]:
    """train_timestamps.py:467-548 (_build_timestamp_sequence)."""
    timestamp_begin = tokenizer.timestamp_begin
    sot_token = tokenizer.sot_sequence[0]

    token_ranges = []
    for start, end in transcript.keys():
        start_idx = convert_to_token_idx(start, timestamp_begin)
        end_idx = convert_to_token_idx(end, timestamp_begin)
        if start_idx is None or end_idx is None:
            return None  # fall back to no-timestamp mode
        token_ranges.append((start_idx, end_idx))

    new_tokens: List[int] = []
    for i, (start_ts, end_ts) in enumerate(token_ranges):
        if i == 0:
            new_tokens.extend([sot_token, start_ts] + text_tokens[i] + [end_ts])
        else:
            new_tokens.extend([start_ts] + text_tokens[i] + [end_ts])

    if norm_end > 30000:
        next_start = timestamp_begin + (30000 // 20)
    else:
        next_start = timestamp_begin + (norm_end // 20)
    new_tokens.extend([next_start, tokenizer.eot])
    return new_tokens


@dataclass
class Sample:
    """One training example (paths or in-memory payloads)."""

    audio: Union[str, np.ndarray]  # .npy/.wav path or waveform
    transcript: Union[str, Dict[Tuple[str, str], str]]  # path/string or parsed
    transcript_ext: str = "vtt"
    norm_end: Union[int, str, None] = None  # segment end (ms or 'HH:MM:SS.mmm')


class AudioTextDataset:
    """Map-style dataset with the reference __getitem__ contract."""

    def __init__(
        self,
        samples: Sequence[Union[Sample, Dict]],
        n_text_ctx: int = 448,
        *,
        tokenizer: Optional[Tokenizer] = None,
        seed: int = 42,
        only_no_ts_mode: bool = False,
        device_mel: bool = False,
    ):
        self.samples = [s if isinstance(s, Sample) else Sample(**s) for s in samples]
        self.n_text_ctx = n_text_ctx
        self.tokenizer = tokenizer or get_tokenizer(False)
        self.seed = seed
        self.epoch = 0  # advanced by BatchLoader.set_epoch
        self.only_no_ts_mode = only_no_ts_mode
        # device_mel: emit the raw 30 s PCM (int16 when the source is int16:
        # half the copy's bytes of f32) under the "mel" key; the train step
        # computes the log-mel on its device (train.loss_fn), so the loader
        # runs no STFT
        self.device_mel = device_mel

    def __len__(self) -> int:
        return len(self.samples)

    def _load_audio(self, audio) -> np.ndarray:
        if isinstance(audio, np.ndarray):
            arr = audio.astype(np.float32)
            if audio.dtype == np.int16:
                arr /= 32768.0
            return arr
        if audio.endswith(".npy"):
            return np.load(audio).astype(np.float32) / 32768.0
        return load_audio(audio)

    def _load_audio_raw(self, audio) -> np.ndarray:
        """Like _load_audio but keeps int16 PCM as int16 (the device_mel
        transport: the /32768 rescale happens in the train step's log-mel)."""
        if isinstance(audio, np.ndarray):
            return audio if audio.dtype == np.int16 else audio.astype(np.float32)
        if audio.endswith(".npy"):
            arr = np.load(audio)
            return arr if arr.dtype == np.int16 else arr.astype(np.float32)
        return load_audio(audio)

    def _load_transcript(self, s: Sample) -> Dict[Tuple[str, str], str]:
        if isinstance(s.transcript, dict):
            return s.transcript
        if os.path.isfile(str(s.transcript)):
            reader = TranscriptReader(file_path=s.transcript)
        else:
            reader = TranscriptReader(
                transcript_string=s.transcript, ext=s.transcript_ext
            )
        transcript, _, _ = reader.read()
        return transcript

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        s = self.samples[index]
        # (seed, epoch, index): the timestamp-mode coin must be a fresh flip
        # per VISIT (the reference draws random.random() inside __getitem__
        # each epoch, train_timestamps.py:427-463) — seeding on (seed, index)
        # alone froze each sample into one mode for the whole run, so
        # multi-epoch training never saw the other branch. Epoch-dependent
        # seeding keeps determinism for resume while restoring the 50/50
        # per-visit distribution.
        rng = np.random.default_rng((self.seed, self.epoch, index))

        audio_arr = (
            self._load_audio_raw(s.audio) if self.device_mel
            else self._load_audio(s.audio)
        )
        norm_end = s.norm_end
        if norm_end is None:
            norm_end = int(len(audio_arr) / 16)  # ms at 16 kHz
        if isinstance(norm_end, str):
            norm_end = convert_to_milliseconds(norm_end)
        if norm_end:
            audio_arr = pad_or_trim(audio_arr, length=norm_end * 16)
        audio_arr = pad_or_trim(audio_arr)
        if self.device_mel:
            mel = audio_arr  # (480000,) int16/f32 PCM; the log-mel is the step's
        else:
            mel = log_mel_spectrogram_np(audio_arr).astype(np.float32)

        transcript = self._load_transcript(s)
        tokens, timestamp_mode, _ = build_tokens(
            transcript, self.tokenizer, norm_end,
            only_no_ts_mode=self.only_no_ts_mode, rng=rng,
        )

        text_input = np.asarray(tokens[:-1], np.int32)
        text_target = np.asarray(tokens[1:], np.int32)
        n = len(text_input)
        if n > self.n_text_ctx:
            raise ValueError(
                f"sample {index}: token length {n} exceeds context {self.n_text_ctx}"
            )

        # compact per-key pad bias (T,): the reference builds the equivalent
        # (T, T) additive matrix with -inf pad COLUMNS (model.py:684-686,
        # train_timestamps.py:314-329) — column masks are rank-1, so shipping
        # the vector is semantically identical and 448x smaller (host build,
        # H2D, and per-layer HBM reads all shrink; it fuses into the softmax)
        padding_mask = np.zeros((self.n_text_ctx,), np.float32)
        padding_mask[n:] = -np.inf
        pad = self.n_text_ctx - n
        text_input = np.pad(text_input, (0, pad), constant_values=PADDING_TOKEN)
        text_target = np.pad(text_target, (0, pad), constant_values=PADDING_TOKEN)

        return {
            "mel": mel,
            "text_input": text_input,
            "text_target": text_target,
            "padding_mask": padding_mask,
            "timestamp_mode": np.asarray(timestamp_mode),
        }


def load_jsonl_samples(paths: Sequence[str]) -> List[Sample]:
    """Read OLMoASR-Mix style JSONL(.gz) shards into Samples
    (train_timestamps.py:2258-2266 reads {audio_file, transcript_file, ...})."""
    samples: List[Sample] = []
    for path in paths:
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt", encoding="utf-8") as f:
            for line in f:
                if not line.strip():
                    continue
                row = json.loads(line)
                samples.append(
                    Sample(
                        audio=row.get("audio_file") or row.get("audio"),
                        transcript=row.get("transcript_file")
                        or row.get("transcript")
                        or row.get("content", ""),
                        transcript_ext=row.get("ext", "vtt"),
                        norm_end=row.get("norm_end"),
                    )
                )
    return samples


class BatchLoader:
    """Prefetching loader producing (accum, micro_B, ...) numpy batches.

    DistributedSampler analog: with ``shard_id/num_shards`` each host reads a
    disjoint strided subset (seeded shuffle, seed=42 like
    train_timestamps.py:633-638). With ``prefetch > 0`` a producer thread
    assembles up to that many batches ahead into a bounded queue, so host-side
    sample loading/mel/tokenization overlaps the (async-dispatched) device
    step — the torch-DataLoader-worker analog without process overhead (the
    per-sample work is numpy/C-BPE, which releases the GIL).
    """

    def __init__(
        self,
        dataset: AudioTextDataset,
        micro_batch_size: int,
        accum_steps: int = 1,
        *,
        shuffle: bool = True,
        seed: int = 42,
        shard_id: int = 0,
        num_shards: int = 1,
        num_workers: int = 0,
        drop_last: bool = True,
        prefetch: int = 2,
    ):
        self.dataset = dataset
        self.micro_batch_size = micro_batch_size
        self.accum_steps = accum_steps
        self.shuffle = shuffle
        self.seed = seed
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        self.dataset.epoch = epoch  # per-visit rng (ts-mode coin) advances too

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self.epoch))
            rng.shuffle(idx)
        return idx[self.shard_id :: self.num_shards]

    def _batches(self) -> Iterator[Dict[str, np.ndarray]]:
        per_step = self.micro_batch_size * self.accum_steps
        idx = self._indices()
        n_steps = len(idx) // per_step

        def fetch(i):
            return self.dataset[int(i)]

        if self.num_workers > 0:
            from concurrent.futures import ThreadPoolExecutor

            pool = ThreadPoolExecutor(self.num_workers)
            mapper = pool.map
        else:
            mapper = map

        for s in range(n_steps):
            rows = list(mapper(fetch, idx[s * per_step : (s + 1) * per_step]))
            batch = {
                k: np.stack([r[k] for r in rows]).reshape(
                    self.accum_steps, self.micro_batch_size, *rows[0][k].shape
                )
                for k in ("mel", "text_input", "text_target", "padding_mask")
            }
            yield batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self.prefetch <= 0:
            yield from self._batches()
            return

        import queue
        import threading

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        _END, _ERR = object(), object()

        def _put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for b in self._batches():
                    if not _put(b):
                        return  # consumer gone (early break / new epoch)
                _put(_END)
            except BaseException as e:  # surfaced on the consumer side
                _put((_ERR, e))

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    return
                if isinstance(item, tuple) and len(item) == 2 and item[0] is _ERR:
                    raise item[1]
                yield item
        finally:
            stop.set()

    def __len__(self) -> int:
        per_step = self.micro_batch_size * self.accum_steps
        return len(self._indices()) // per_step
