"""Long-form transcription: sliding 30 s windows with temperature fallback and
timestamp-token segmentation, batched across files.

Counterpart of ``olmoasr_tpu/transcribe.py``. That module imports jax at its
top, so ``_FileState`` (the per-file seek state machine, its word-timestamp
branch and the hallucination-silence heuristic included), ``_get_end``,
``_needs_fallback`` and ``_decode_batch_with_fallback`` are copied here; the
tests pin each to the original. The reference's inert prompt conditioning
is kept: ``condition_on_previous_text`` only moves ``prompt_reset_since``.

``transcribe_many`` decodes one window of every active file a round, as
one batch, and only the windows that fail the fallback gates decode again,
at the next temperature. When more than one input is a 1-D waveform (a
path is read first) of at most ``MAX_FILE_S``, those files stream, as in
the JAX package: ``_StreamedMelGroup`` sends each group's samples to the
device in 30 s chunks (pinned memory, a copy stream of its own; int16
where the samples are exact PCM on the CPU, float32 on the card), writes each chunk's unnormalized log-mel
(``audio.log_mel_chunk_unnorm``) into the group's buffer on the compute
stream once a round needs it or its copy is done, and each round gathers
and normalizes its windows in one call a group (``_gather_windows_norm``).
A window equals the one the per-file path slices from the whole file's
log-mel unless it was normalized before the file's max was known and one
of its frames lies below that max - 8; such a file runs again through the
per-file path (``transcribe_many.stale_max_reruns`` counts them). Other
inputs take the per-file path: the file's log-mel with 30 s of padding on
the model's device, sliced a window a round. With ``word_timestamps`` each
consumed window goes to ``timing``'s alignment on the same device. A
multilingual model without ``language=`` detects each file's language
from its first 30 s (``decoding.detect_language``).

``cli()`` is the command line, ``python -m olmoasr_tpu_torch.transcribe``:
the JAX package's arguments and defaults (beam search with ``beam_size=5``
at temperature 0, ``best_of=5`` samples above it), plus ``--device``.
"""

from __future__ import annotations

import threading
import warnings
from typing import List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from olmoasr_tpu_torch.tokenizer import LANGUAGES, get_tokenizer
from olmoasr_tpu_torch.utils import exact_div, format_timestamp, make_safe
from olmoasr_tpu_torch.audio import (
    FRAMES_PER_SECOND,
    HOP_LENGTH,
    N_FFT,
    N_FRAMES,
    N_SAMPLES,
    SAMPLE_RATE,
    load_audio,
    log_mel_chunk_unnorm,
    log_mel_spectrogram,
    pad_or_trim,
)
from olmoasr_tpu_torch.decoding import DecodingOptions, DecodingResult

DEFAULT_TEMPERATURES = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0)


class _FileState:
    """Per-file long-form state machine: the reference's sliding-window seek
    loop split into ``current_window()`` (the next 30 s mel window, or None
    when done) and ``consume(result)`` (advance seek, cut timestamp segments,
    apply the no-speech skip, add word timestamps), so that a caller can
    decode one window of every active file as one batch. With
    ``word_timestamps`` the caller sets ``_mel_segment`` to the window it
    decoded before ``consume``. Given ``mel_frames`` (the frame count of the
    file's padded log-mel) it computes no mel: the caller gathers its windows
    after ``advance_window()``."""

    def __init__(
        self,
        model,
        audio: Union[str, np.ndarray, torch.Tensor],
        tokenizer,
        *,
        verbose: Optional[bool],
        logprob_threshold: Optional[float],
        no_speech_threshold: Optional[float],
        condition_on_previous_text: bool,
        initial_prompt: Optional[str],
        clip_timestamps: Union[str, List[float]],
        language: str,
        word_timestamps: bool,
        prepend_punctuations: str,
        append_punctuations: str,
        hallucination_silence_threshold: Optional[float],
        mel_frames: Optional[int] = None,
    ):
        self.model = model
        self.tokenizer = tokenizer
        self.verbose = verbose
        self.logprob_threshold = logprob_threshold
        self.no_speech_threshold = no_speech_threshold
        self.condition_on_previous_text = condition_on_previous_text
        self.word_timestamps = word_timestamps
        self.prepend_punctuations = prepend_punctuations
        self.append_punctuations = append_punctuations
        self.hallucination_silence_threshold = hallucination_silence_threshold
        self.language = language
        self.punctuation = "\"'“¿([{-\"'.。,，!！?？:：”)]}、"

        if mel_frames is not None:
            # streamed (transcribe_many): the mel lives in a group's buffer and
            # the windows come from the round's gather; this state only seeks
            self.mel = None
            self.content_frames = mel_frames - N_FRAMES
        else:
            # 30 s of silence padded to the input audio, for slicing; the mel
            # stays on the model's device
            self.mel = log_mel_spectrogram(audio, model.dims.n_mels, padding=N_SAMPLES,
                                           device=model.device)
            self.content_frames = self.mel.shape[-1] - N_FRAMES
        self.content_duration = float(self.content_frames * HOP_LENGTH / SAMPLE_RATE)

        if isinstance(clip_timestamps, str):
            clip_timestamps = [
                float(ts) for ts in (clip_timestamps.split(",") if clip_timestamps else [])
            ]
        seek_points = [round(ts * FRAMES_PER_SECOND) for ts in clip_timestamps]
        if len(seek_points) == 0:
            seek_points.append(0)
        if len(seek_points) % 2 == 1:
            seek_points.append(self.content_frames)
        self.seek_clips: List[Tuple[int, int]] = list(zip(seek_points[::2], seek_points[1::2]))

        self.clip_idx = 0
        self.seek = self.seek_clips[0][0]
        self.input_stride = exact_div(N_FRAMES, model.dims.n_audio_ctx)
        self.time_precision = self.input_stride * HOP_LENGTH / SAMPLE_RATE
        self.all_tokens: List[int] = []
        self.all_segments: List[dict] = []
        self.prompt_reset_since = 0
        self.last_speech_timestamp = 0.0

        if initial_prompt is not None:
            self.initial_prompt_tokens = tokenizer.encode(" " + initial_prompt.strip())
            self.all_tokens.extend(self.initial_prompt_tokens)
        else:
            self.initial_prompt_tokens = []

        # window-scoped scratch: the size of the window last emitted, and
        # with word timestamps its normalised mel row, on the model's device
        self._segment_size = 0
        self._mel_segment: Optional[torch.Tensor] = None

    # -- window emission -----------------------------------------------------

    def advance_window(self) -> Optional[Tuple[int, int]]:
        """Advance clip bookkeeping; return (seek, segment_size) for the next
        30 s window, or None when the file is exhausted."""
        while self.clip_idx < len(self.seek_clips):
            seek_clip_start, seek_clip_end = self.seek_clips[self.clip_idx]
            if self.seek < seek_clip_start:
                self.seek = seek_clip_start
            if self.seek >= seek_clip_end:
                self.clip_idx += 1
                if self.clip_idx < len(self.seek_clips):
                    self.seek = self.seek_clips[self.clip_idx][0]
                continue
            segment_size = min(N_FRAMES, self.content_frames - self.seek,
                               seek_clip_end - self.seek)
            self._segment_size = segment_size
            return self.seek, segment_size
        return None

    def current_window(self) -> Optional[torch.Tensor]:
        """The next (n_mels, N_FRAMES) fp32 mel window on the mel's device,
        zero-padded past the segment (advancing clip bookkeeping), or None."""
        spec = self.advance_window()
        if spec is None:
            return None
        seek, segment_size = spec
        mel_segment = self.mel[:, seek: seek + segment_size]
        if segment_size < N_FRAMES:
            mel_segment = F.pad(mel_segment, (0, N_FRAMES - segment_size))
        return mel_segment.float()

    @property
    def done(self) -> bool:
        return self.clip_idx >= len(self.seek_clips)

    # -- result consumption ---------------------------------------------------

    def consume(self, result: DecodingResult) -> None:
        """Apply a decode result for the window last emitted by
        ``current_window()``."""
        tokenizer = self.tokenizer
        segment_size = self._segment_size
        seek = self.seek
        time_offset = float(seek * HOP_LENGTH / SAMPLE_RATE)
        window_end_time = float((seek + N_FRAMES) * HOP_LENGTH / SAMPLE_RATE)
        segment_duration = segment_size * HOP_LENGTH / SAMPLE_RATE
        tokens = np.array(result.tokens)

        def new_segment(*, start, end, tokens_, result):
            tokens_ = [int(t) for t in tokens_]
            text_tokens = [t for t in tokens_ if t < tokenizer.eot]
            return {
                "seek": seek,
                "start": start,
                "end": end,
                "text": tokenizer.decode(text_tokens),
                "tokens": tokens_,
                "temperature": result.temperature,
                "avg_logprob": result.avg_logprob,
                "compression_ratio": result.compression_ratio,
                "no_speech_prob": result.no_speech_prob,
            }

        if self.no_speech_threshold is not None:
            # no voice activity check
            should_skip = result.no_speech_prob > self.no_speech_threshold
            if self.logprob_threshold is not None and result.avg_logprob > self.logprob_threshold:
                should_skip = False
            if should_skip:
                self.seek += segment_size  # fast-forward to the next boundary
                return

        previous_seek = seek
        current_segments: List[dict] = []

        def is_segment_anomaly(segment: Optional[dict]) -> bool:
            if segment is None or not segment["words"]:
                return False
            words = [w for w in segment["words"] if w["word"] not in self.punctuation]
            words = words[:8]
            score = sum(word_anomaly_score(w) for w in words)
            return score >= 3 or score + 0.01 >= len(words)

        def next_words_segment(segments: List[dict]) -> Optional[dict]:
            return next((s for s in segments if s["words"]), None)
        timestamp_tokens = tokens >= tokenizer.timestamp_begin
        single_timestamp_ending = (
            len(timestamp_tokens) >= 2 and timestamp_tokens[-2:].tolist() == [False, True]
        )

        consecutive = np.where(timestamp_tokens[:-1] & timestamp_tokens[1:])[0] + 1
        if len(consecutive) > 0:
            # output contains two consecutive timestamp tokens
            slices = consecutive.tolist()
            if single_timestamp_ending:
                slices.append(len(tokens))
            last_slice = 0
            for current_slice in slices:
                sliced_tokens = tokens[last_slice:current_slice]
                start_timestamp_pos = int(sliced_tokens[0]) - tokenizer.timestamp_begin
                end_timestamp_pos = int(sliced_tokens[-1]) - tokenizer.timestamp_begin
                current_segments.append(
                    new_segment(
                        start=time_offset + start_timestamp_pos * self.time_precision,
                        end=time_offset + end_timestamp_pos * self.time_precision,
                        tokens_=sliced_tokens,
                        result=result,
                    )
                )
                last_slice = current_slice
            if single_timestamp_ending:
                # no speech after the last timestamp
                self.seek += segment_size
            else:
                # ignore the unfinished segment; seek to the last timestamp
                last_timestamp_pos = int(tokens[last_slice - 1]) - tokenizer.timestamp_begin
                self.seek += last_timestamp_pos * self.input_stride
        else:
            duration = segment_duration
            timestamps = tokens[np.nonzero(timestamp_tokens)[0]]
            if len(timestamps) > 0 and int(timestamps[-1]) != tokenizer.timestamp_begin:
                last_timestamp_pos = int(timestamps[-1]) - tokenizer.timestamp_begin
                duration = last_timestamp_pos * self.time_precision
            current_segments.append(
                new_segment(start=time_offset, end=time_offset + duration, tokens_=tokens,
                            result=result)
            )
            self.seek += segment_size

        if self.word_timestamps:
            from olmoasr_tpu_torch.timing import add_word_timestamps

            add_word_timestamps(
                segments=current_segments,
                model=self.model,
                tokenizer=tokenizer,
                mel=self._mel_segment,
                num_frames=segment_size,
                prepend_punctuations=self.prepend_punctuations,
                append_punctuations=self.append_punctuations,
                last_speech_timestamp=self.last_speech_timestamp,
            )
            if not single_timestamp_ending:
                last_word_end = _get_end(current_segments)
                if last_word_end is not None and last_word_end > time_offset:
                    self.seek = round(last_word_end * FRAMES_PER_SECOND)

            if self.hallucination_silence_threshold is not None:
                threshold = self.hallucination_silence_threshold
                if not single_timestamp_ending:
                    last_word_end = _get_end(current_segments)
                    if last_word_end is not None and last_word_end > time_offset:
                        remaining_duration = window_end_time - last_word_end
                        if remaining_duration > threshold:
                            self.seek = round(last_word_end * FRAMES_PER_SECOND)
                        else:
                            self.seek = previous_seek + segment_size

                first_segment = next_words_segment(current_segments)
                if first_segment is not None and is_segment_anomaly(first_segment):
                    gap = first_segment["start"] - time_offset
                    if gap > threshold:
                        self.seek = previous_seek + round(gap * FRAMES_PER_SECOND)
                        return

                hal_last_end = self.last_speech_timestamp
                for si in range(len(current_segments)):
                    segment = current_segments[si]
                    if not segment["words"]:
                        continue
                    if is_segment_anomaly(segment):
                        next_segment = next_words_segment(current_segments[si + 1:])
                        if next_segment is not None:
                            hal_next_start = next_segment["words"][0]["start"]
                        else:
                            hal_next_start = time_offset + segment_duration
                        silence_before = (
                            segment["start"] - hal_last_end > threshold
                            or segment["start"] < threshold
                            or segment["start"] - time_offset < 2.0
                        )
                        silence_after = (
                            hal_next_start - segment["end"] > threshold
                            or is_segment_anomaly(next_segment)
                            or window_end_time - segment["end"] < 2.0
                        )
                        if silence_before and silence_after:
                            self.seek = round(
                                max(time_offset + 1, segment["start"]) * FRAMES_PER_SECOND
                            )
                            if self.content_duration - segment["end"] < threshold:
                                self.seek = self.content_frames
                            current_segments[si:] = []
                            break
                    hal_last_end = segment["end"]

            last_word_end = _get_end(current_segments)
            if last_word_end is not None:
                self.last_speech_timestamp = last_word_end

        if self.verbose:
            for segment in current_segments:
                start, end, text = segment["start"], segment["end"], segment["text"]
                line = f"[{format_timestamp(start)} --> {format_timestamp(end)}] {text}"
                print(make_safe(line))

        # an instantaneous or empty segment is cleared
        for segment in current_segments:
            if segment["start"] == segment["end"] or segment["text"].strip() == "":
                segment["text"] = ""
                segment["tokens"] = []
                segment["words"] = []

        self.all_segments.extend(
            {"id": i, **segment}
            for i, segment in enumerate(current_segments, start=len(self.all_segments))
        )
        self.all_tokens.extend(token for segment in current_segments for token in segment["tokens"])

        if not self.condition_on_previous_text or result.temperature > 0.5:
            self.prompt_reset_since = len(self.all_tokens)

    def finalize(self) -> dict:
        return dict(
            text=self.tokenizer.decode(self.all_tokens[len(self.initial_prompt_tokens):]),
            segments=self.all_segments,
            language=self.language,
        )


def word_anomaly_score(word: dict) -> float:
    """The hallucination heuristic's score of one word: low probability, or
    a duration far from a spoken word's."""
    probability = word.get("probability", 0.0)
    duration = word["end"] - word["start"]
    score = 0.0
    if probability < 0.15:
        score += 1.0
    if duration < 0.133:
        score += (0.133 - duration) * 15
    if duration > 2.0:
        score += duration - 2.0
    return score


def _get_end(segments: List[dict]) -> Optional[float]:
    return next(
        (w["end"] for s in reversed(segments) for w in reversed(s.get("words", []))),
        segments[-1]["end"] if segments else None,
    )


def _resolve_language(model, audio, decode_options: dict, verbose: Optional[bool]) -> str:
    """``decode_options["language"]``, set first when missing: "en" for an
    English-only model; for a multilingual one, the language that
    ``detect_language`` finds in the audio's first 30 s (its log-mel on the
    model's device)."""
    if decode_options.get("language", None) is None:
        if not model.is_multilingual:
            decode_options["language"] = "en"
        else:
            mel = log_mel_spectrogram(audio, model.dims.n_mels, padding=N_SAMPLES,
                                      device=model.device)
            _, probs = model.detect_language(pad_or_trim(mel, N_FRAMES))
            decode_options["language"] = max(probs, key=probs.get)
            if verbose is not None:
                print(f"Detected language: {LANGUAGES[decode_options['language']].title()}")
    return decode_options["language"]


def _needs_fallback(
    result: DecodingResult,
    compression_ratio_threshold: Optional[float],
    logprob_threshold: Optional[float],
    no_speech_threshold: Optional[float],
) -> bool:
    """Fallback gates of the reference's transcribe loop."""
    needs = False
    if (
        compression_ratio_threshold is not None
        and result.compression_ratio > compression_ratio_threshold
    ):
        needs = True  # too repetitive
    if logprob_threshold is not None and result.avg_logprob < logprob_threshold:
        needs = True  # average log probability too low
    if (
        no_speech_threshold is not None
        and result.no_speech_prob > no_speech_threshold
        and logprob_threshold is not None
        and result.avg_logprob < logprob_threshold
    ):
        needs = False  # silence
    return needs


# ---------------------------------------------------------------------------
# The streamed long-form transport: each group of files goes to the device as
# 30 s chunks of PCM, each chunk's log-mel is written into the group's buffer
# as it arrives, and windows are normalized when a round gathers them, so the
# upload runs behind the decode rounds instead of before the first. The
# file's max enters the normalization only through the clamp
# ``max(x, filemax - 8)``: a window gathered while the running max is still
# short of the file's is equal to the whole-file window unless one of its
# valid frames lies below ``filemax - 8``. The gather returns what that check
# needs, ``transcribe_many`` makes it once every chunk is in, and re-runs an
# affected file through the per-file path.

_CHUNK_HALO = N_FFT - HOP_LENGTH  # 240: frame t reads [t*hop, t*hop + n_fft)


def _mel_write(buf: torch.Tensor, rowmax: torch.Tensor, chunk: torch.Tensor,
               fstart: int) -> None:
    """The log-mel of one self-contained chunk written into the group's
    unnormalized buffer at frame ``fstart``, and the running max raised, both
    in place on the current stream."""
    mel, mx = log_mel_chunk_unnorm(chunk, buf.shape[1])
    buf[:, :, fstart:fstart + mel.shape[-1]] = mel
    torch.maximum(rowmax, mx, out=rowmax)


def _tail_chunk(halo: torch.Tensor) -> torch.Tensor:
    """The last chunk, built on the device: the last 200 samples of every
    row, then the 30 s of zero padding and the (zero) reflect tail; two
    windows of frames for the upload of the short halo."""
    if halo.dtype == torch.int16:
        halo = halo.float() / 32768.0
    return F.pad(halo, (0, 2 * N_SAMPLES + _CHUNK_HALO - halo.shape[1]))


class _StreamedMelGroup:
    """One group of long-form files streaming through the log-mel.

    The host builds each row's 30 s chunks (the reflect head on chunk 0, the
    halo between chunks, the zero tail) and copies each from pinned memory
    on a copy stream of its own with one CUDA event a chunk; chunk 0 at once, the rest
    on a background thread. ``ensure`` and ``poll`` enqueue the chunks'
    mel-writes on the compute stream: ``ensure`` those a round reads (the
    compute stream waits for their copies), ``poll`` only those whose copy
    has completed, so that the compute stream never waits for a copy a round
    does not need. On the CPU the copy is a plain one and no stream is used.

    Float32 rows go as int16 where every sample of a chunk is exactly a PCM
    value, as the JAX package sends them, when ``int16_transport`` is True,
    and as float32 when it is False. None (the default) means int16 on the
    CPU and float32 on the card, which skips the host's int16 pass: the copy
    over the card's link is not what limits the first round (PERF.md).
    Either gives the same windows bit for bit, since ``int16 / 32768``
    restores an exact PCM sample.
    """

    int16_transport: Optional[bool] = None

    @staticmethod
    def _cvt_i16(dst: np.ndarray, src: np.ndarray) -> bool:
        """Exact f32->int16 PCM conversion, blockwise: writes
        ``rint(src*32768)`` into ``dst`` and returns False iff any value is
        out of int16 range or not exactly representable (then the chunk
        falls back to f32 transport)."""
        B = 1 << 20
        for o in range(0, src.size, B):
            s = src[o : o + B] * np.float32(32768.0)
            r = np.rint(s)
            if not (
                r.min() >= -32768.0
                and r.max() <= 32767.0
                and np.array_equal(r, s)
            ):
                return False
            dst[o : o + B] = r
        return True

    def _build_chunk(self, pcm_rows, s: int) -> np.ndarray:
        """Assemble the host-side sample buffer for chunk ``s`` (slice s of
        every row, with the reflect head on slice 0) or, for ``s ==
        n_real``, the tail halo that _tail_chunk expands on the device.
        With the int16 transport on, f32 rows build directly into an int16
        buffer (exactness checked blockwise by _cvt_i16); only
        non-PCM-representable audio rebuilds in f32."""
        n_rows = len(pcm_rows)
        dtype = pcm_rows[0].dtype
        try_i16 = dtype == np.float32 and self._int16
        if try_i16:
            dtype = np.int16
        max_len = self.n_real * N_SAMPLES
        if s == self.n_real:
            halo = np.zeros((n_rows, N_FFT // 2), dtype)
            for j, x in enumerate(pcm_rows):
                if len(x) > max_len - N_FFT // 2:
                    tail = x[max_len - N_FFT // 2 :]
                    if try_i16:
                        if not self._cvt_i16(halo[j, : len(tail)], tail):
                            return self._build_f32(pcm_rows, s)
                    else:
                        halo[j, : len(tail)] = tail
            return halo
        chunk = np.zeros((n_rows, N_SAMPLES + _CHUNK_HALO), dtype)
        lo = s * N_SAMPLES - (N_FFT // 2)
        hi = (s + 1) * N_SAMPLES + (_CHUNK_HALO - N_FFT // 2)
        for j, x in enumerate(pcm_rows):
            if s == 0:
                # reflect head of the zero-padded row (np.pad 'reflect'):
                # head position p = padded_row[200 - p]
                pr = x if len(x) > N_FFT // 2 else np.concatenate(
                    [x, np.zeros(N_FFT // 2 + 1 - len(x), x.dtype)]
                )
                head = pr[1 : N_FFT // 2 + 1][::-1]
                body = x[:hi]
                if try_i16:
                    if not (
                        self._cvt_i16(chunk[j, : N_FFT // 2], head)
                        and self._cvt_i16(
                            chunk[j, N_FFT // 2 : N_FFT // 2 + len(body)],
                            body,
                        )
                    ):
                        return self._build_f32(pcm_rows, s)
                else:
                    chunk[j, : N_FFT // 2] = head
                    chunk[j, N_FFT // 2 : N_FFT // 2 + len(body)] = body
            else:
                body = x[lo : min(hi, len(x))]
                if try_i16:
                    if not self._cvt_i16(chunk[j, : len(body)], body):
                        return self._build_f32(pcm_rows, s)
                else:
                    chunk[j, : len(body)] = body
        return chunk

    def _build_f32(self, pcm_rows, s: int) -> np.ndarray:
        """Fallback: the f32 assembly, for rows whose samples are not
        exactly int16-representable."""
        n_rows = len(pcm_rows)
        max_len = self.n_real * N_SAMPLES
        if s == self.n_real:
            halo = np.zeros((n_rows, N_FFT // 2), np.float32)
            for j, x in enumerate(pcm_rows):
                if len(x) > max_len - N_FFT // 2:
                    tail = x[max_len - N_FFT // 2 :]
                    halo[j, : len(tail)] = tail
            return halo
        chunk = np.zeros((n_rows, N_SAMPLES + _CHUNK_HALO), np.float32)
        lo = s * N_SAMPLES - (N_FFT // 2)
        hi = (s + 1) * N_SAMPLES + (_CHUNK_HALO - N_FFT // 2)
        for j, x in enumerate(pcm_rows):
            if s == 0:
                pr = x if len(x) > N_FFT // 2 else np.concatenate(
                    [x, np.zeros(N_FFT // 2 + 1 - len(x), x.dtype)]
                )
                chunk[j, : N_FFT // 2] = pr[1 : N_FFT // 2 + 1][::-1]
                body = x[:hi]
                chunk[j, N_FFT // 2 : N_FFT // 2 + len(body)] = body
            else:
                body = x[lo : min(hi, len(x))]
                chunk[j, : len(body)] = body
        return chunk

    def __init__(self, pcm_rows, max_len: int, n_mels: int, device):
        self.device = torch.device(device)
        self.n_real = max_len // N_SAMPLES
        self.total_frames = (self.n_real + 2) * N_FRAMES
        n_rows = len(pcm_rows)
        cuda = self.device.type == "cuda"
        self._int16 = not cuda if self.int16_transport is None else self.int16_transport
        self._copy_stream = torch.cuda.Stream(self.device) if cuda else None
        self.chunks: List[Optional[torch.Tensor]] = [None] * (self.n_real + 1)
        self._events: List[Optional[torch.cuda.Event]] = [None] * (self.n_real + 1)
        self._hosts: List[Optional[torch.Tensor]] = [None] * (self.n_real + 1)
        self._dispatched = [threading.Event() for _ in self.chunks]
        self._builder_err: Optional[BaseException] = None
        self._stop = False
        self.buf = torch.zeros((n_rows, n_mels, self.total_frames), dtype=torch.float32,
                               device=self.device)
        self.rowmax = torch.full((n_rows,), -1e30, dtype=torch.float32, device=self.device)
        self.done = 0  # mel-writes enqueued for chunks [0, done)
        # chunk 0 at once: the first round waits for it anyway; the host
        # work of the others runs on a thread while this one decodes
        self._put(0, self._build_chunk(pcm_rows, 0))

        def _build_rest():
            try:
                for s in range(1, self.n_real + 1):
                    if self._stop:
                        break
                    self._put(s, self._build_chunk(pcm_rows, s))
            except BaseException as e:  # raised by _wait_dispatched / poll
                self._builder_err = e
                for ev in self._dispatched:
                    ev.set()

        self._builder = None
        if self.n_real >= 1:
            self._builder = threading.Thread(target=_build_rest, daemon=True)
            self._builder.start()

    def _put(self, s: int, chunk: np.ndarray) -> None:
        """Send chunk ``s`` to the device: from pinned memory on the copy
        stream, its event recorded after it; the pinned tensor is held until
        that event has completed. On the CPU, a plain copy."""
        host = torch.from_numpy(chunk)
        if self._copy_stream is None:
            self.chunks[s] = host.to(self.device)
        else:
            host = host.pin_memory()
            with torch.cuda.stream(self._copy_stream):
                self.chunks[s] = host.to(self.device, non_blocking=True)
                event = torch.cuda.Event()
                event.record(self._copy_stream)
            self._events[s] = event
            self._hosts[s] = host
        self._dispatched[s].set()

    @property
    def complete(self) -> bool:
        return self.done > self.n_real

    def _wait_dispatched(self, s: int) -> None:
        self._dispatched[s].wait()
        if self._builder_err is not None:
            raise self._builder_err

    def _copied(self, s: int) -> bool:
        """Whether chunk ``s``'s copy has completed (never blocks)."""
        return self._events[s] is None or self._events[s].query()

    def _release_hosts(self) -> None:
        """Drop the pinned buffers whose copies have completed."""
        for s, host in enumerate(self._hosts):
            if host is not None and self._events[s] is not None and self._events[s].query():
                self._hosts[s] = None

    def _enqueue(self, s: int) -> None:
        chunk = self.chunks[s]
        if self._events[s] is not None:
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(self._events[s])
            # the chunk was allocated on the copy stream: the allocator must
            # not hand its memory out again before these reads are done
            chunk.record_stream(compute)
        if s == self.n_real:
            chunk = _tail_chunk(chunk)
        _mel_write(self.buf, self.rowmax, chunk, s * N_FRAMES)
        self.chunks[s] = None  # the device PCM goes once consumed

    def ensure(self, last_frame: int) -> None:
        """Enqueue the mel-writes of the chunks covering frames [0,
        last_frame]; the compute stream waits for copies not yet done."""
        need = min(last_frame // N_FRAMES, self.n_real)
        while self.done <= need:
            self._wait_dispatched(self.done)
            self._enqueue(self.done)
            self.done += 1
        self._release_hosts()

    def poll(self) -> None:
        """Enqueue the mel-writes of the chunks whose copies have completed,
        in order, without blocking: the running max moves toward the file's
        max, so later gathers are exact."""
        while self.done <= self.n_real:
            if not self._dispatched[self.done].is_set():
                break
            if self._builder_err is not None:
                raise self._builder_err
            if not self._copied(self.done):
                break
            self._enqueue(self.done)
            self.done += 1
        self._release_hosts()

    def finish(self) -> None:
        """Enqueue every remaining mel-write."""
        while self.done <= self.n_real:
            self._wait_dispatched(self.done)
            self._enqueue(self.done)
            self.done += 1
        self._release_hosts()

    def close(self) -> None:
        """Stop the builder, wait for the copies in flight and drop the
        pinned buffers."""
        self._stop = True
        if self._builder is not None:
            self._builder.join()
        for s, event in enumerate(self._events):
            if event is not None and self._hosts[s] is not None:
                event.synchronize()
            self._hosts[s] = None


def _gather_windows_norm(stack: torch.Tensor, rowmax: torch.Tensor, rows: torch.Tensor,
                         seeks: torch.Tensor, seg_sizes: torch.Tensor):
    """The windows of a round from a group's unnormalized buffer, in one
    gather: window j is ``(max(stack[rows[j], :, seeks[j]:+3000],
    rowmax[rows[j]] - 8) + 4) / 4`` with the frames at or past
    ``seg_sizes[j]`` zeroed. Returns the windows, each window's min over its
    valid frames and the max it was normalized with: the inputs of
    ``transcribe_many``'s check once the file's max is known."""
    w = stack.unfold(-1, N_FRAMES, 1)[rows, :, seeks]  # (n, n_mels, N_FRAMES)
    m = rowmax[rows]
    wn = (torch.maximum(w, (m - 8.0)[:, None, None]) + 4.0) / 4.0
    mask = (torch.arange(N_FRAMES, device=stack.device) < seg_sizes[:, None])[:, None, :]
    win = torch.where(mask, wn, 0.0)
    wmin = torch.where(mask, w, torch.inf).amin(dim=(-2, -1))
    return win, wmin, m


def _decode_batch_with_fallback(
    model,
    windows: List[torch.Tensor],
    temperatures: List[float],
    decode_options: dict,
    *,
    compression_ratio_threshold: Optional[float],
    logprob_threshold: Optional[float],
    no_speech_threshold: Optional[float],
) -> List[DecodingResult]:
    """Batched temperature-fallback ladder: decode ALL windows at the first
    temperature in one batched call, then re-queue only the failures at each
    higher temperature. Rounds are not padded to a fixed row count (the JAX
    package pads for its compiled shapes; eager PyTorch compiles nothing)."""
    results: List[Optional[DecodingResult]] = [None] * len(windows)
    pending = list(range(len(windows)))
    for ti, t in enumerate(temperatures):
        if not pending:
            break
        kwargs = {**decode_options}
        if t > 0:
            kwargs.pop("beam_size", None)
            kwargs.pop("patience", None)
        else:
            kwargs.pop("best_of", None)
        options = DecodingOptions(**kwargs, temperature=t)

        out = model.decode(torch.stack([windows[i] for i in pending]), options)

        still = []
        last = ti == len(temperatures) - 1
        for i, r in zip(pending, out):
            results[i] = r
            if not last and _needs_fallback(
                r, compression_ratio_threshold, logprob_threshold, no_speech_threshold,
            ):
                still.append(i)
        pending = still
    return results  # type: ignore[return-value]


def transcribe(model, audio: Union[str, np.ndarray, torch.Tensor], **kwargs) -> dict:
    """Transcribe audio of any length: ``transcribe_many`` of one file, with
    the same keyword arguments. Returns ``{text, segments, language}``."""
    return transcribe_many(model, [audio], batch_size=1, **kwargs)[0]


def transcribe_many(
    model,
    audios: List[Union[str, np.ndarray, torch.Tensor]],
    *,
    batch_size: int = 8,
    verbose: Optional[bool] = None,
    temperature: Union[float, Tuple[float, ...]] = DEFAULT_TEMPERATURES,
    compression_ratio_threshold: Optional[float] = 2.4,
    logprob_threshold: Optional[float] = -1.0,
    no_speech_threshold: Optional[float] = 0.6,
    condition_on_previous_text: bool = True,
    initial_prompt: Optional[str] = None,
    carry_initial_prompt: bool = False,
    word_timestamps: bool = False,
    prepend_punctuations: str = "\"'“¿([{-",
    append_punctuations: str = "\"'.。,，!！?？:：”)]}、",
    clip_timestamps: Union[str, List[float]] = "0",
    hallucination_silence_threshold: Optional[float] = None,
    **decode_options,
) -> List[dict]:
    """Batched long-form transcription of many files on one device.

    Every active file contributes its current 30 s window, the windows of up
    to ``batch_size`` files decode as one batch (windows of different files
    are independent), and only the windows that fail the fallback gates
    decode again at the next temperature. Per-file output is that of
    ``transcribe``: the seek state machines are independent, and the
    streamed windows (see the module's docstring) equal the per-file ones,
    or the file runs again through ``transcribe``. Paths are read with
    ``load_audio`` and tensors copied to the host first. The signature
    is the JAX package's; ``carry_initial_prompt`` is accepted and, as
    there, unused. ``word_timestamps`` adds each segment's ``words``
    (``timing.add_word_timestamps`` on the window that was decoded) and
    moves seek to the last word's end; ``hallucination_silence_threshold``
    then skips silence around anomalous words. A multilingual model without
    ``language`` detects each file's language first.
    """
    if word_timestamps and decode_options.get("task") == "translate":
        warnings.warn("Word-level timestamps on translations may not be reliable.")
    temperatures = [temperature] if isinstance(temperature, (int, float)) else list(temperature)

    wavs = [load_audio(a) if isinstance(a, str) else _host_samples(a) for a in audios]
    groups, stack_row, mel_frames, gather_w = _stream_groups(model, wavs, batch_size)
    guards: List[tuple] = []  # (group, files, window mins, maxes used) of stale gathers
    try:
        states: List[_FileState] = []
        for fi, wav in enumerate(wavs):
            opts = dict(decode_options)
            language = _resolve_language(model, wav, opts, verbose)
            tokenizer = get_tokenizer(
                model.is_multilingual, num_languages=model.num_languages, language=language,
                task=opts.get("task", "transcribe"),
            )
            states.append(_FileState(
                model, wav, tokenizer,
                verbose=verbose,
                logprob_threshold=logprob_threshold,
                no_speech_threshold=no_speech_threshold,
                condition_on_previous_text=condition_on_previous_text,
                initial_prompt=initial_prompt,
                clip_timestamps=clip_timestamps,
                language=language,
                word_timestamps=word_timestamps,
                prepend_punctuations=prepend_punctuations,
                append_punctuations=append_punctuations,
                hallucination_silence_threshold=hallucination_silence_threshold,
                mel_frames=mel_frames.get(fi),
            ))

        # each round batches the current window of up to batch_size active
        # files; streamed files only seek here and their windows come from
        # one gather a group; languages may differ per file, so windows group
        # by language
        active = list(range(len(states)))
        while active:
            specs, windows, ids = [], [], []
            for i in active[:batch_size]:
                if i in stack_row:
                    spec = states[i].advance_window()
                    if spec is None:
                        continue
                    specs.append((*stack_row[i], *spec, i))  # (group, row, seek, size, file)
                    windows.append(None)  # filled from the gather below
                else:
                    window = states[i].current_window()
                    if window is None:
                        continue
                    windows.append(window)
                ids.append(i)
            if specs:
                gathered = iter(_gather_round(specs, groups, gather_w, guards))
                windows = [next(gathered) if w is None else w for w in windows]
            by_lang: dict = {}
            for w, i in zip(windows, ids):
                ws, iids = by_lang.setdefault(states[i].language, ([], []))
                ws.append(w)
                iids.append(i)
            for lang, (ws, iids) in by_lang.items():
                results = _decode_batch_with_fallback(
                    model, ws, temperatures, {**decode_options, "language": lang},
                    compression_ratio_threshold=compression_ratio_threshold,
                    logprob_threshold=logprob_threshold,
                    no_speech_threshold=no_speech_threshold,
                )
                for i, w, r in zip(iids, ws, results):
                    if word_timestamps:  # the alignment re-encodes the window decoded
                        states[i]._mel_segment = w
                    states[i].consume(r)
                    states[i]._mel_segment = None
            active = [i for i in active if not states[i].done]
            for grp in groups:
                # the chunks that arrived during this round's decode, without
                # stalling the compute stream
                grp.poll()
        finals = [s.finalize() for s in states]

        # a window normalized with a still-running max equals the whole-file
        # window unless one of its valid frames lies below the file's max - 8
        # while the max it used was not the file's: such files run again
        # through the per-file path
        bad = _stale_files(groups, guards, stack_row) if guards else set()
    finally:
        for grp in groups:
            grp.close()
    _COUNTER.stale_max_reruns += len(bad)
    for i in sorted(bad):
        finals[i] = transcribe(
            model, wavs[i], verbose=verbose, temperature=temperature,
            compression_ratio_threshold=compression_ratio_threshold,
            logprob_threshold=logprob_threshold,
            no_speech_threshold=no_speech_threshold,
            condition_on_previous_text=condition_on_previous_text,
            initial_prompt=initial_prompt,
            carry_initial_prompt=carry_initial_prompt,
            word_timestamps=word_timestamps,
            prepend_punctuations=prepend_punctuations,
            append_punctuations=append_punctuations,
            clip_timestamps=clip_timestamps,
            hallucination_silence_threshold=hallucination_silence_threshold,
            **decode_options,
        )
    return finals


# files the stale-max check has sent back through the per-file path, over
# every call (a plain count, for tests and measurements); kept on the
# function even where a caller rebinds the module's name
transcribe_many.stale_max_reruns = 0
_COUNTER = transcribe_many

MAX_FILE_S = 10 * 60  # longer files take the per-file path
GROUP_BUDGET = 128 * 10**6  # samples a streamed group holds at most


def _host_samples(audio):
    """A waveform as host samples (a tensor copied from its device)."""
    return audio.cpu().numpy() if torch.is_tensor(audio) else np.asarray(audio)


def _stream_groups(model, wavs, batch_size: int):
    """The streamed groups of a ``transcribe_many`` call: when more than one
    waveform is 1-D and at most ``MAX_FILE_S`` long, those files in groups of
    ``per_group`` rows (at most ``batch_size``, ``GROUP_BUDGET`` samples at
    the longest file's length rounded up to 30 s, and the file count), every
    group padded with empty rows to that shape. Returns the groups, each
    streamed file's (group, row), its padded log-mel's frame count, and the
    width of a group's gather."""
    batchable = [i for i, w in enumerate(wavs)
                 if w.ndim == 1 and len(w) <= MAX_FILE_S * SAMPLE_RATE]
    groups: List[_StreamedMelGroup] = []
    stack_row, mel_frames = {}, {}
    if len(batchable) <= 1:
        return groups, stack_row, mel_frames, 0
    max_len = max(len(wavs[i]) for i in batchable)
    max_len = -(-max_len // N_SAMPLES) * N_SAMPLES  # rounded up to 30 s
    per_group = max(int(GROUP_BUDGET // max_len), 1)
    per_group = min(max(1, min(per_group, batch_size)), len(batchable))
    for gi, g in enumerate(range(0, len(batchable), per_group)):
        rows = []
        for j, i in enumerate(batchable[g:g + per_group]):
            rows.append(wavs[i])
            stack_row[i] = (gi, j)
            mel_frames[i] = len(wavs[i]) // HOP_LENGTH + N_FRAMES
        rows += [np.zeros(0, np.float32)] * (per_group - len(rows))
        groups.append(_StreamedMelGroup(rows, max_len, model.dims.n_mels, model.device))
    return groups, stack_row, mel_frames, min(per_group, batch_size)


def _gather_round(specs, groups, gather_w: int, guards: list) -> torch.Tensor:
    """The round's streamed windows, in the order of ``specs`` (group, row,
    seek, size, file): one gather of ``gather_w`` windows a touched group,
    after the group's chunks up to the last frame read are enqueued. A
    gather from a group still streaming adds its check to ``guards``."""
    parts = []
    for gi in sorted({s[0] for s in specs}):
        gs = [s[1:4] for s in specs if s[0] == gi]
        grp = groups[gi]
        grp.ensure(max(s[1] for s in gs) + N_FRAMES - 1)
        padded = gs + [gs[-1]] * (gather_w - len(gs))
        rows, seeks, sizes = (torch.tensor(c, device=grp.device) for c in zip(*padded))
        wins, wmin, umax = _gather_windows_norm(grp.buf, grp.rowmax, rows, seeks, sizes)
        if not grp.complete:
            guards.append((gi, [s[4] for s in specs if s[0] == gi],
                           wmin[:len(gs)], umax[:len(gs)]))
        parts.append(wins[:len(gs)])
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _stale_files(groups, guards: list, stack_row: dict) -> set:
    """The files of ``guards`` whose window was normalized with a max that
    was not the file's and holds a valid frame below the file's max - 8;
    every group's remaining chunks are enqueued first."""
    for grp in groups:
        grp.finish()
    fmax = {gi: groups[gi].rowmax.cpu().numpy() for gi, *_ in guards}
    bad = set()
    for gi, gids, wmin, umax in guards:
        wm, um = wmin.cpu().numpy(), umax.cpu().numpy()
        for k, i in enumerate(gids):
            fm = fmax[gi][stack_row[i][1]]
            if um[k] != fm and wm[k] < fm - 8.0:
                bad.add(i)
    return bad


def cli(argv: Optional[List[str]] = None) -> None:
    """Command line: the JAX package's ``transcribe.cli`` with the same
    arguments and defaults, plus ``--device`` (PyTorch wants an explicit
    device; there is no fall back to the CPU). ``--model`` is a local
    ``.pt`` or ``.npz`` for the port's ``load_model``.

    Under torchrun (``python -m torch.distributed.run --nproc_per_node=R -m
    olmoasr_tpu_torch.transcribe ...``) every rank joins the group and each
    batch of windows is split across the ranks (``decoding.join_infer_mesh``;
    ``--batch_size`` files a round, so a batch of one window decodes whole
    on every rank). A bare ``--device cuda`` is each rank's
    ``cuda:{LOCAL_RANK}``. Every rank computes; rank 0 alone prints and
    writes the outputs."""
    import argparse
    import os

    from olmoasr_tpu_torch.decoding import join_infer_mesh, leave_infer_mesh
    from olmoasr_tpu_torch.parallel import mesh as mesh_mod
    from olmoasr_tpu_torch.writers import get_writer
    from olmoasr_tpu_torch.api import load_model

    def optional_int(s):
        return None if s == "None" else int(s)

    def optional_float(s):
        return None if s == "None" else float(s)

    def str2bool(s):
        return s.lower() in ("true", "1", "yes")

    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter
    )
    parser.add_argument("audio", nargs="+", type=str, help="audio file(s) to transcribe")
    parser.add_argument("--model", default="small.en", help="name or path of the model")
    parser.add_argument("--model_dir", type=str, default=None)
    parser.add_argument("--output_dir", "-o", type=str, default=".")
    parser.add_argument(
        "--output_format", "-f", type=str, default="all",
        choices=["txt", "vtt", "srt", "tsv", "json", "all"],
    )
    parser.add_argument("--verbose", type=str2bool, default=True)
    parser.add_argument("--task", type=str, default="transcribe",
                        choices=["transcribe", "translate"])
    parser.add_argument("--language", type=str, default=None,
                        choices=sorted(LANGUAGES.keys()))
    parser.add_argument("--temperature", type=float, default=0)
    parser.add_argument("--best_of", type=optional_int, default=5)
    parser.add_argument("--beam_size", type=optional_int, default=5)
    parser.add_argument("--patience", type=optional_float, default=None)
    parser.add_argument("--length_penalty", type=optional_float, default=None)
    parser.add_argument("--suppress_tokens", type=str, default="-1")
    parser.add_argument("--initial_prompt", type=str, default=None)
    parser.add_argument("--condition_on_previous_text", type=str2bool, default=True)
    parser.add_argument("--temperature_increment_on_fallback", type=optional_float,
                        default=0.2)
    parser.add_argument("--compression_ratio_threshold", type=optional_float,
                        default=2.4)
    parser.add_argument("--logprob_threshold", type=optional_float, default=-1.0)
    parser.add_argument("--no_speech_threshold", type=optional_float, default=0.6)
    parser.add_argument("--word_timestamps", type=str2bool, default=False)
    parser.add_argument("--prepend_punctuations", type=str, default="\"'“¿([{-")
    parser.add_argument("--append_punctuations", type=str,
                        default="\"'.。,，!！?？:：”)]}、")
    parser.add_argument("--highlight_words", type=str2bool, default=False)
    parser.add_argument("--max_line_width", type=optional_int, default=None)
    parser.add_argument("--max_line_count", type=optional_int, default=None)
    parser.add_argument("--max_words_per_line", type=optional_int, default=None)
    parser.add_argument("--clip_timestamps", type=str, default="0")
    parser.add_argument("--hallucination_silence_threshold", type=optional_float,
                        default=None)
    parser.add_argument(
        "--batch_size", type=int, default=1,
        help="files transcribed concurrently (batched windows on one chip); "
        "1 = sequential reference behavior",
    )
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device the model runs on")

    args = parser.parse_args(argv).__dict__
    model_name = args.pop("model")
    model_dir = args.pop("model_dir")
    output_dir = args.pop("output_dir")
    output_format = args.pop("output_format")
    device = args.pop("device")

    temperature = args.pop("temperature")
    if (increment := args.pop("temperature_increment_on_fallback")) is not None:
        temperature = tuple(np.arange(temperature, 1.0 + 1e-6, increment))
    else:
        temperature = [temperature]

    created = join_infer_mesh(device)
    try:
        writes = mesh_mod.rank() == 0
        if writes:
            os.makedirs(output_dir, exist_ok=True)
        else:
            args["verbose"] = None
        if mesh_mod.world_size() > 1:  # each rank on its own card
            device = mesh_mod.rank_device(device)
        model = load_model(model_name, device=device, download_root=model_dir)
        writer = get_writer(output_format, output_dir)
        word_options = ["highlight_words", "max_line_count", "max_line_width",
                        "max_words_per_line"]
        writer_args = {k: args.pop(k) for k in word_options}
        batch_size = args.pop("batch_size")
        audio_paths = args.pop("audio")
        if batch_size > 1 and len(audio_paths) > 1:
            results = transcribe_many(model, audio_paths, batch_size=batch_size,
                                      temperature=temperature, **args)
        else:
            results = (transcribe(model, audio_path, temperature=temperature, **args)
                       for audio_path in audio_paths)
        for audio_path, result in zip(audio_paths, results):
            if writes:
                writer(result, audio_path, **writer_args)
    finally:
        leave_infer_mesh(created)


if __name__ == "__main__":
    cli()
