"""Long-form transcription: sliding 30 s windows with temperature fallback and
timestamp-token segmentation, batched across files.

Counterpart of ``olmoasr_tpu/transcribe.py``. That module imports jax at its
top, so ``_FileState`` (the per-file seek state machine, its word-timestamp
branch and the hallucination-silence heuristic included), ``_get_end``,
``_needs_fallback`` and ``_decode_batch_with_fallback`` are copied here; the
tests pin each to the original. The reference's inert prompt conditioning
is kept: ``condition_on_previous_text`` only moves ``prompt_reset_since``.

``transcribe_many`` computes each file's log-mel on the model's device with
30 s of padding, and every round slices and pads one window per active file
there; the windows of a round decode as one batch, and only the windows that
fail the fallback gates decode again, at the next temperature. With
``word_timestamps`` each consumed window's mel goes to ``timing``'s
alignment on the same device. A multilingual model without ``language=``
detects each file's language from its first 30 s (``decoding.detect_language``).
Not ported here: the streamed-upload transport (``_StreamedMelGroup``,
``_gather_windows_norm``, ``log_mel_chunk_unnorm``; bit-equal to this path
by design), in ROADMAP's Queue 1.

``cli()`` is the command line, ``python -m olmoasr_tpu_torch.transcribe``:
the JAX package's arguments and defaults (beam search with ``beam_size=5``
at temperature 0, ``best_of=5`` samples above it), plus ``--device``.
"""

from __future__ import annotations

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
    N_FRAMES,
    N_SAMPLES,
    SAMPLE_RATE,
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
    decoded before ``consume``."""

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
    ``transcribe``: the seek state machines are independent. The signature
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

    states: List[_FileState] = []
    for audio in audios:
        opts = dict(decode_options)
        language = _resolve_language(model, audio, opts, verbose)
        tokenizer = get_tokenizer(
            model.is_multilingual, num_languages=model.num_languages, language=language,
            task=opts.get("task", "transcribe"),
        )
        states.append(_FileState(
            model, audio, tokenizer,
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
        ))

    # each round batches the current window of up to batch_size active
    # files; languages may differ per file, so windows group by language
    active = list(range(len(states)))
    while active:
        by_lang: dict = {}
        for i in active[:batch_size]:
            window = states[i].current_window()
            if window is not None:
                ws, ids = by_lang.setdefault(states[i].language, ([], []))
                ws.append(window)
                ids.append(i)
        for lang, (ws, ids) in by_lang.items():
            results = _decode_batch_with_fallback(
                model, ws, temperatures, {**decode_options, "language": lang},
                compression_ratio_threshold=compression_ratio_threshold,
                logprob_threshold=logprob_threshold,
                no_speech_threshold=no_speech_threshold,
            )
            for i, w, r in zip(ids, ws, results):
                if word_timestamps:  # the alignment re-encodes the window decoded
                    states[i]._mel_segment = w
                states[i].consume(r)
                states[i]._mel_segment = None
        active = [i for i in active if not states[i].done]
    return [s.finalize() for s in states]


def cli(argv: Optional[List[str]] = None) -> None:
    """Command line: the JAX package's ``transcribe.cli`` with the same
    arguments and defaults, plus ``--device`` (PyTorch wants an explicit
    device; there is no fall back to the CPU). ``--model`` is a local
    ``.pt`` or ``.npz`` for the port's ``load_model``."""
    import argparse
    import os

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
    os.makedirs(output_dir, exist_ok=True)

    temperature = args.pop("temperature")
    if (increment := args.pop("temperature_increment_on_fallback")) is not None:
        temperature = tuple(np.arange(temperature, 1.0 + 1e-6, increment))
    else:
        temperature = [temperature]

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
        for audio_path, result in zip(audio_paths, results):
            writer(result, audio_path, **writer_args)
    else:
        for audio_path in audio_paths:
            writer(transcribe(model, audio_path, temperature=temperature, **args),
                   audio_path, **writer_args)


if __name__ == "__main__":
    cli()
