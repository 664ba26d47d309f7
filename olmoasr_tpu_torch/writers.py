"""Output writers: txt / vtt / srt / tsv / json.

A copy of ``olmoasr_tpu/writers.py``: the port imports nothing of the JAX package, and
``tests/test_torch_copies.py`` pins the copy to the original.

Rebuild of ``[pip:whisper] utils.get_writer`` used by the reference CLI
(``olmoasr/transcribe.py:24-33,543``).

Attribution: the writer class hierarchy (``ResultWriter`` /
``SubtitlesWriter`` and subclasses), the ``iterate_result`` /
``iterate_subtitles`` option plumbing (max_line_width / max_line_count /
max_words_per_line / highlight_words), and the exact vtt/srt/tsv format
strings in this file are ported from openai-whisper (``whisper/utils.py``),
Copyright (c) 2022 OpenAI, MIT License — see the repository-root ``NOTICES``
file. Byte-identical output formats are required for parity with the
reference CLI, so the formats (and the logic that selects line breaks) are
the behavioral spec, not an implementation choice.
"""

from __future__ import annotations

import json
import os
import re
import sys
from typing import Callable, List, Optional, TextIO

from olmoasr_tpu_torch.utils import format_timestamp


class ResultWriter:
    extension: str

    def __init__(self, output_dir: str):
        self.output_dir = output_dir

    def __call__(self, result: dict, audio_path: str, **kwargs):
        audio_basename = os.path.basename(audio_path)
        audio_basename = os.path.splitext(audio_basename)[0]
        output_path = os.path.join(
            self.output_dir, audio_basename + "." + self.extension
        )
        with open(output_path, "w", encoding="utf-8") as f:
            self.write_result(result, file=f, **kwargs)

    def write_result(self, result: dict, file: TextIO, **kwargs):
        raise NotImplementedError


class WriteTXT(ResultWriter):
    extension = "txt"

    def write_result(self, result: dict, file: TextIO, **kwargs):
        for segment in result["segments"]:
            print(segment["text"].strip(), file=file, flush=True)


class SubtitlesWriter(ResultWriter):
    always_include_hours: bool
    decimal_marker: str

    def iterate_result(self, result: dict, options: Optional[dict] = None, **kwargs):
        options = options or {}
        max_line_width = kwargs.pop("max_line_width", None) or options.get(
            "max_line_width"
        )
        max_line_count = kwargs.pop("max_line_count", None) or options.get(
            "max_line_count"
        )
        max_words_per_line = kwargs.pop("max_words_per_line", None) or options.get(
            "max_words_per_line"
        )
        highlight_words = kwargs.pop("highlight_words", None) or options.get(
            "highlight_words", False
        )
        max_line_width = max_line_width or 1000
        max_words_per_line = max_words_per_line or 1000

        def iterate_subtitles():
            line_len = 0
            line_count = 1
            subtitle: List[dict] = []
            last: float = 0.0
            for segment in result["segments"]:
                chunk_index = 0
                words: List[dict] = segment.get("words") or []
                if not words:
                    continue
                last = max(last, words[0]["start"])
                while chunk_index < len(words):
                    remaining_words = len(words) - chunk_index
                    if max_words_per_line > len(words) - chunk_index:
                        words_count = remaining_words
                    else:
                        words_count = max_words_per_line
                    for i, original_timing in enumerate(
                        words[chunk_index : chunk_index + words_count]
                    ):
                        timing = original_timing.copy()
                        long_pause = not highlight_words and timing["start"] - last > 3.0
                        has_room = line_len + len(timing["word"]) <= max_line_width
                        seg_break = i == 0 and len(subtitle) > 0 and long_pause
                        if (
                            line_len > 0
                            and has_room
                            and not long_pause
                            and not seg_break
                        ):
                            line_len += len(timing["word"])
                        else:
                            timing["word"] = timing["word"].strip()
                            if (
                                len(subtitle) > 0
                                and max_line_count is not None
                                and (long_pause or line_count >= max_line_count)
                                or seg_break
                            ):
                                yield subtitle
                                subtitle = []
                                line_count = 1
                            elif line_len > 0:
                                line_count += 1
                                timing["word"] = "\n" + timing["word"]
                            line_len = len(timing["word"].strip())
                        subtitle.append(timing)
                        last = timing["start"]
                    chunk_index += words_count
            if len(subtitle) > 0:
                yield subtitle

        if any(s.get("words") for s in result["segments"]):
            for subtitle in iterate_subtitles():
                subtitle_start = self.format_timestamp(subtitle[0]["start"])
                subtitle_end = self.format_timestamp(subtitle[-1]["end"])
                subtitle_text = "".join([word["word"] for word in subtitle])
                if highlight_words:
                    last = subtitle_start
                    all_words = [timing["word"] for timing in subtitle]
                    for i, this_word in enumerate(subtitle):
                        start = self.format_timestamp(this_word["start"])
                        end = self.format_timestamp(this_word["end"])
                        if last != start:
                            yield last, start, subtitle_text
                        yield start, end, "".join(
                            [
                                re.sub(r"^(\s*)(.*)$", r"\1<u>\2</u>", word)
                                if j == i
                                else word
                                for j, word in enumerate(all_words)
                            ]
                        )
                        last = end
                else:
                    yield subtitle_start, subtitle_end, subtitle_text
        else:
            for segment in result["segments"]:
                segment_start = self.format_timestamp(segment["start"])
                segment_end = self.format_timestamp(segment["end"])
                segment_text = segment["text"].strip().replace("-->", "->")
                yield segment_start, segment_end, segment_text

    def format_timestamp(self, seconds: float) -> str:
        return format_timestamp(
            seconds=seconds,
            always_include_hours=self.always_include_hours,
            decimal_marker=self.decimal_marker,
        )


class WriteVTT(SubtitlesWriter):
    extension = "vtt"
    always_include_hours = False
    decimal_marker = "."

    def write_result(self, result: dict, file: TextIO, **kwargs):
        print("WEBVTT\n", file=file)
        for start, end, text in self.iterate_result(result, **kwargs):
            print(f"{start} --> {end}\n{text}\n", file=file, flush=True)


class WriteSRT(SubtitlesWriter):
    extension = "srt"
    always_include_hours = True
    decimal_marker = ","

    def write_result(self, result: dict, file: TextIO, **kwargs):
        for i, (start, end, text) in enumerate(
            self.iterate_result(result, **kwargs), start=1
        ):
            print(f"{i}\n{start} --> {end}\n{text}\n", file=file, flush=True)


class WriteTSV(ResultWriter):
    """TSV of start/end (integer milliseconds) and text."""

    extension = "tsv"

    def write_result(self, result: dict, file: TextIO, **kwargs):
        print("start", "end", "text", sep="\t", file=file)
        for segment in result["segments"]:
            print(round(1000 * segment["start"]), file=file, end="\t")
            print(round(1000 * segment["end"]), file=file, end="\t")
            print(segment["text"].strip().replace("\t", " "), file=file, flush=True)


class WriteJSON(ResultWriter):
    extension = "json"

    def write_result(self, result: dict, file: TextIO, **kwargs):
        json.dump(result, file)


def get_writer(output_format: str, output_dir: str) -> Callable[..., None]:
    writers = {
        "txt": WriteTXT,
        "vtt": WriteVTT,
        "srt": WriteSRT,
        "tsv": WriteTSV,
        "json": WriteJSON,
    }
    if output_format == "all":
        all_writers = [writer(output_dir) for writer in writers.values()]

        def write_all(result: dict, file: str, **kwargs):
            for writer in all_writers:
                writer(result, file, **kwargs)

        return write_all
    return writers[output_format](output_dir)
