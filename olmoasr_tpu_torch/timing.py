"""Word-level timestamps: cross-attention alignment by dynamic time warping.

Counterpart of ``olmoasr_tpu/timing.py``. That module imports jax at its top,
so the host-side pieces are copied here unchanged (``median_filter``,
``dtw``, ``WordTiming``, ``_softmax``, ``merge_punctuations``;
``tests/test_torch_timing.py`` pins each to the original), and
``find_alignment`` and ``add_word_timestamps`` are ported onto the port's
model functions: the window is re-encoded (``encode_audio``), the text
tokens are teacher-forced through ``decode_train`` for their probabilities,
and ``cross_attention_weights`` gives the alignment, all on the model's
device in the weights' dtype. The DTW runs on the host in NumPy, as in the
JAX package: its recurrence is sequential and small (at most 448 x 1500).

OLMoASR checkpoints ship no alignment heads, so like whisper's default all
heads of the upper half of the decoder's layers are used.

Attribution: ``merge_punctuations`` is a near-verbatim port and
``find_alignment``'s token and word bookkeeping is closely adapted from
openai-whisper (``whisper/timing.py``), Copyright (c) 2022 OpenAI, MIT
License; see the repository-root ``NOTICES`` file.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from olmoasr_tpu_torch.audio import HOP_LENGTH, SAMPLE_RATE, TOKENS_PER_SECOND
from olmoasr_tpu_torch.models import whisper as model_mod
from olmoasr_tpu_torch.tokenizer import Tokenizer


def median_filter(x: np.ndarray, filter_width: int) -> np.ndarray:
    """Median filter over the last axis with reflect padding."""
    if filter_width <= 1 or x.shape[-1] <= filter_width:
        return x
    assert filter_width % 2 == 1
    pad = filter_width // 2
    padded = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, pad)], mode="reflect")
    windows = np.lib.stride_tricks.sliding_window_view(padded, filter_width, axis=-1)
    return np.median(windows, axis=-1)


def dtw(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Monotonic DTW over a cost matrix x (N, M); returns the alignment path
    (text_indices, time_indices)."""
    N, M = x.shape
    cost = np.full((N + 1, M + 1), np.inf, dtype=np.float64)
    trace = np.full((N + 1, M + 1), -1, dtype=np.int8)
    cost[0, 0] = 0.0
    for i in range(1, N + 1):
        prev_row = cost[i - 1]
        cur_row = cost[i]
        xi = x[i - 1]
        for j in range(1, M + 1):
            c0 = prev_row[j - 1]
            c1 = prev_row[j]
            c2 = cur_row[j - 1]
            if c0 <= c1 and c0 <= c2:
                c, t = c0, 0
            elif c1 <= c2:
                c, t = c1, 1
            else:
                c, t = c2, 2
            cur_row[j] = xi[j - 1] + c
            trace[i, j] = t

    # backtrace
    i, j = N, M
    trace[0, :] = 2
    trace[:, 0] = 1
    text_indices, time_indices = [], []
    while i > 0 or j > 0:
        text_indices.append(i - 1)
        time_indices.append(j - 1)
        t = trace[i, j]
        if t == 0:
            i -= 1
            j -= 1
        elif t == 1:
            i -= 1
        elif t == 2:
            j -= 1
        else:
            raise ValueError("Unexpected trace[i, j]")
    return np.array(text_indices)[::-1], np.array(time_indices)[::-1]


@dataclass
class WordTiming:
    word: str
    tokens: List[int]
    start: float
    end: float
    probability: float


def find_alignment(
    model,
    tokenizer: Tokenizer,
    text_tokens: List[int],
    mel: torch.Tensor,  # (n_mels, 3000)
    num_frames: int,
    *,
    medfilt_width: int = 7,
    qk_scale: float = 1.0,
) -> List[WordTiming]:
    """Each word of ``text_tokens`` with its start, end and mean token
    probability, from the window's ``mel`` of which ``num_frames`` frames
    are audio. Runs the model in its weights' dtype on its device; the
    probabilities and weights come to the host in fp32."""
    if len(text_tokens) == 0:
        return []

    tokens = torch.tensor(
        [list(tokenizer.sot_sequence) + [tokenizer.no_timestamps] + text_tokens + [tokenizer.eot]],
        device=model.device,
    )
    sample_begin = len(tokenizer.sot_sequence) + 1

    audio_features = model_mod.encode_audio(model, torch.as_tensor(mel).to(model.device)[None])
    with torch.no_grad():
        logits = model_mod.decode_train(model, tokens, audio_features)
    # columns [: eot] (EOT excluded from the softmax), matching
    # [pip:whisper] timing.find_alignment; the rows that predict the text
    # tokens, sliced on the device before the copy
    sampled_logits = logits[0, sample_begin - 1:-1, :tokenizer.eot].cpu().numpy()
    token_probs = _softmax(sampled_logits, axis=-1)
    text_token_probs = token_probs[np.arange(len(text_tokens)), np.array(text_tokens)]

    weights_all = model_mod.cross_attention_weights(model, tokens, audio_features)
    L = weights_all.shape[0]
    # whisper default: all heads of the upper half of decoder layers
    w = weights_all[L // 2:, 0, :, :, :num_frames // 2].cpu().numpy()  # (L/2, H, T, frames/2)
    w = w.reshape(-1, w.shape[-2], w.shape[-1])  # (heads, T, frames/2)

    # normalize and smooth like whisper.timing
    std = w.std(axis=-2, keepdims=True)
    mean = w.mean(axis=-2, keepdims=True)
    w = (w - mean) / (std + 1e-8)
    w = median_filter(w, medfilt_width)
    matrix = w.mean(axis=0)  # (T, frames/2)
    matrix = matrix[sample_begin - 1:-1]

    text_indices, time_indices = dtw(-matrix)

    words, word_tokens = tokenizer.split_to_word_tokens(list(text_tokens) + [tokenizer.eot])
    if len(word_tokens) <= 1:
        return []
    word_boundaries = np.pad(np.cumsum([len(t) for t in word_tokens[:-1]]), (1, 0))

    jumps = np.pad(np.diff(text_indices), (1, 0), constant_values=1).astype(bool)
    jump_times = time_indices[jumps] / TOKENS_PER_SECOND
    start_times = jump_times[word_boundaries[:-1]]
    end_times = jump_times[word_boundaries[1:]]
    word_probabilities = [
        float(np.mean(text_token_probs[i:j]))
        for i, j in zip(word_boundaries[:-1], word_boundaries[1:])
    ]

    return [
        WordTiming(word, tokens_, start, end, probability)
        for word, tokens_, start, end, probability in zip(
            words, word_tokens, start_times, end_times, word_probabilities
        )
    ]


def _softmax(x, axis=-1):
    x = x - x.max(axis=axis, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=axis, keepdims=True)


def merge_punctuations(alignment: List[WordTiming], prepended: str, appended: str):
    # merge prepended punctuations
    i = len(alignment) - 2
    j = len(alignment) - 1
    while i >= 0:
        previous = alignment[i]
        following = alignment[j]
        if previous.word.startswith(" ") and previous.word.strip() in prepended:
            following.word = previous.word + following.word
            following.tokens = previous.tokens + following.tokens
            previous.word = ""
            previous.tokens = []
        else:
            j = i
        i -= 1

    # merge appended punctuations
    i = 0
    j = 1
    while j < len(alignment):
        previous = alignment[i]
        following = alignment[j]
        if not previous.word.endswith(" ") and following.word in appended:
            previous.word = previous.word + following.word
            previous.tokens = previous.tokens + following.tokens
            following.word = ""
            following.tokens = []
        else:
            i = j
        j += 1


def add_word_timestamps(
    *,
    segments: List[dict],
    model,
    tokenizer: Tokenizer,
    mel: torch.Tensor,
    num_frames: int,
    prepend_punctuations: str = "\"'“¿([{-",
    append_punctuations: str = "\"'.。,，!！?？:：”)]}、",
    last_speech_timestamp: float,
    **kwargs,
):
    """Attach ``words`` lists to segments ([pip:whisper] timing.add_word_timestamps)."""
    if len(segments) == 0:
        return

    text_tokens_per_segment = [
        [token for token in segment["tokens"] if token < tokenizer.eot]
        for segment in segments
    ]
    text_tokens = list(itertools.chain.from_iterable(text_tokens_per_segment))
    alignment = find_alignment(model, tokenizer, text_tokens, mel, num_frames, **kwargs)
    word_durations = np.array([t.end - t.start for t in alignment])
    word_durations = word_durations[word_durations.nonzero()]
    median_duration = np.median(word_durations) if len(word_durations) > 0 else 0.0
    median_duration = min(0.7, float(median_duration))
    max_duration = median_duration * 2

    # truncate long words at sentence boundaries (hallucination heuristic)
    if len(word_durations) > 0:
        sentence_end_marks = ".。!！?？"
        for i in range(1, len(alignment)):
            if alignment[i].end - alignment[i].start > max_duration:
                if alignment[i].word in sentence_end_marks:
                    alignment[i].end = alignment[i].start + max_duration
                elif alignment[i - 1].word in sentence_end_marks:
                    alignment[i].start = alignment[i].end - max_duration

    merge_punctuations(alignment, prepend_punctuations, append_punctuations)

    time_offset = segments[0]["seek"] * HOP_LENGTH / SAMPLE_RATE
    word_index = 0

    for segment, text_tokens_ in zip(segments, text_tokens_per_segment):
        saved_tokens = 0
        words = []
        while word_index < len(alignment) and saved_tokens < len(text_tokens_):
            timing = alignment[word_index]
            if timing.word:
                words.append(
                    dict(
                        word=timing.word,
                        start=round(time_offset + timing.start, 2),
                        end=round(time_offset + timing.end, 2),
                        probability=timing.probability,
                    )
                )
            saved_tokens += len(timing.tokens)
            word_index += 1

        # hallucinated start fixups (whisper.timing semantics)
        if len(words) > 0:
            if (
                words[0]["end"] - last_speech_timestamp > median_duration * 4
                and (
                    words[0]["end"] - words[0]["start"] > max_duration
                    or (
                        len(words) > 1
                        and words[1]["end"] - words[0]["start"] > max_duration * 2
                    )
                )
            ):
                if (
                    len(words) > 1
                    and words[1]["end"] - words[1]["start"] > max_duration
                ):
                    boundary = max(words[1]["end"] / 2, words[1]["end"] - max_duration)
                    words[0]["end"] = words[1]["start"] = boundary
                words[0]["start"] = max(0, words[0]["end"] - max_duration)

            if segment["start"] < words[0]["end"] and segment["start"] - 0.5 > words[0]["start"]:
                words[0]["start"] = max(
                    0, min(words[0]["end"] - median_duration, segment["start"])
                )
            else:
                segment["start"] = words[0]["start"]

            if segment["end"] > words[-1]["start"] and segment["end"] + 0.5 < words[-1]["end"]:
                words[-1]["end"] = max(
                    words[-1]["start"] + median_duration, segment["end"]
                )
            else:
                segment["end"] = words[-1]["end"]

            last_speech_timestamp = segment["end"]

        segment["words"] = words
