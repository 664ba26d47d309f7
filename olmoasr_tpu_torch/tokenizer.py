"""Whisper-compatible tokenizer: byte-level BPE + special-token layout.

A copy of ``olmoasr_tpu/tokenizer.py``: the port imports nothing of the JAX package, and
``tests/test_torch_copies.py`` pins the copy to the original.

The reference delegates tokenization to ``[pip:whisper] tokenizer.get_tokenizer``
(tiktoken, Rust) — used at ``olmoasr/transcribe.py:23,170-175`` and
``scripts/training/train_timestamps.py:37,561``. This module is a
native rebuild:

  * ``BytePairEncoder``: a byte-level BPE engine that loads tiktoken-format rank
    files (base64 "token rank" lines). Given whisper's ``gpt2.tiktoken`` ranks it
    produces identical ids.
  * ``ByteFallbackEncoder``: an offline, dependency-free encoding with the same
    base-vocab *size* (50257) so every special-token id (sot, eot, timestamps, …)
    lands at exactly the reference layout. Used when no rank file is available
    (e.g. air-gapped test environments). Not GPT-2 compatible at the text level.
  * ``Tokenizer``: the task wrapper mirroring whisper's ``Tokenizer`` dataclass —
    sot sequences, timestamp tokens, suppress lists, word splitting.

Attribution: the ``non_speech_tokens`` symbol corpus (the exact list of
suppressed symbols plus the keep-first-token-of ♪♪♪/([{ logic) and the
``split_tokens_on_unicode`` / ``split_tokens_on_spaces`` word-splitting
algorithms are ported from openai-whisper (``whisper/tokenizer.py``),
Copyright (c) 2022 OpenAI, MIT License — see the repository-root ``NOTICES``
file. These define which tokens greedy decoding may emit and where word
timestamps break, i.e. they are part of the parity spec.

Special-token layout for English-only (.en) models, base vocab 50257:
  eot            = 50256  (<|endoftext|>, part of the base GPT-2 vocab)
  sot            = 50257  (<|startoftranscript|>)
  languages      = 50258 … 50356  (99 tokens)
  translate      = 50357, transcribe = 50358
  sot_lm         = 50359, sot_prev   = 50360
  no_speech      = 50361, no_timestamps = 50362
  timestamps     = 50363 … 51863  (<|0.00|> … <|30.00|>, 20 ms steps)
  => n_vocab 51864 (matches ``olmoasr/config/model_dims.py``);
  training adds one padding row, id 51864
  (``olmoasr/model.py:660-667``).
"""

from __future__ import annotations

import base64
import functools
import os
import string
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

# 99 languages, in whisper's canonical dict order (pre-large-v3; .en models and the
# OLMoASR vocab of 51864 imply exactly 99 language tokens).
LANGUAGES = {
    "en": "english", "zh": "chinese", "de": "german", "es": "spanish", "ru": "russian",
    "ko": "korean", "fr": "french", "ja": "japanese", "pt": "portuguese", "tr": "turkish",
    "pl": "polish", "ca": "catalan", "nl": "dutch", "ar": "arabic", "sv": "swedish",
    "it": "italian", "id": "indonesian", "hi": "hindi", "fi": "finnish", "vi": "vietnamese",
    "he": "hebrew", "uk": "ukrainian", "el": "greek", "ms": "malay", "cs": "czech",
    "ro": "romanian", "da": "danish", "hu": "hungarian", "ta": "tamil", "no": "norwegian",
    "th": "thai", "ur": "urdu", "hr": "croatian", "bg": "bulgarian", "lt": "lithuanian",
    "la": "latin", "mi": "maori", "ml": "malayalam", "cy": "welsh", "sk": "slovak",
    "te": "telugu", "fa": "persian", "lv": "latvian", "bn": "bengali", "sr": "serbian",
    "az": "azerbaijani", "sl": "slovenian", "kn": "kannada", "et": "estonian",
    "mk": "macedonian", "br": "breton", "eu": "basque", "is": "icelandic", "hy": "armenian",
    "ne": "nepali", "mn": "mongolian", "bs": "bosnian", "kk": "kazakh", "sq": "albanian",
    "sw": "swahili", "gl": "galician", "mr": "marathi", "pa": "punjabi", "si": "sinhala",
    "km": "khmer", "sn": "shona", "yo": "yoruba", "so": "somali", "af": "afrikaans",
    "oc": "occitan", "ka": "georgian", "be": "belarusian", "tg": "tajik", "sd": "sindhi",
    "gu": "gujarati", "am": "amharic", "yi": "yiddish", "lo": "lao", "uz": "uzbek",
    "fo": "faroese", "ht": "haitian creole", "ps": "pashto", "tk": "turkmen",
    "nn": "nynorsk", "mt": "maltese", "sa": "sanskrit", "lb": "luxembourgish",
    "my": "myanmar", "bo": "tibetan", "tl": "tagalog", "mg": "malagasy", "as": "assamese",
    "tt": "tatar", "haw": "hawaiian", "ln": "lingala", "ha": "hausa", "ba": "bashkir",
    "jw": "javanese", "su": "sundanese",
}

TO_LANGUAGE_CODE = {
    **{language: code for code, language in LANGUAGES.items()},
    "burmese": "my", "valencian": "ca", "flemish": "nl", "haitian": "ht",
    "letzeburgesch": "lb", "pushto": "ps", "panjabi": "pa", "moldavian": "ro",
    "moldovan": "ro", "sinhalese": "si", "castilian": "es",
}

GPT2_BASE_VOCAB = 50257  # includes <|endoftext|> at 50256
N_TIMESTAMPS = 1501  # <|0.00|> … <|30.00|> at 20 ms resolution
PADDING_TOKEN = 51864  # training-only extra row (model.py:660-667)

# GPT-2 pre-tokenization pattern (requires the `regex` module for \p classes).
_GPT2_PAT = (
    r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""
)


def _special_token_strings() -> List[str]:
    return (
        ["<|endoftext|>", "<|startoftranscript|>"]
        + [f"<|{lang}|>" for lang in LANGUAGES]
        + ["<|translate|>", "<|transcribe|>", "<|startoflm|>", "<|startofprev|>",
           "<|nospeech|>", "<|notimestamps|>"]
        + [f"<|{i * 0.02:.2f}|>" for i in range(N_TIMESTAMPS)]
    )


class BytePairEncoder:
    """Byte-level BPE engine over tiktoken-format mergeable ranks.

    ``ranks`` maps token bytes -> rank/id. Merging follows the classic BPE rule:
    repeatedly merge the adjacent pair whose concatenation has the lowest rank.
    """

    def __init__(self, ranks: Dict[bytes, int], special_tokens: Dict[str, int],
                 pattern: str = _GPT2_PAT):
        import regex

        self.ranks = ranks
        self.special_tokens = dict(special_tokens)
        self._pat = regex.compile(pattern)
        self._decoder: Dict[int, bytes] = {rank: tok for tok, rank in ranks.items()}
        self._special_decoder = {v: k for k, v in self.special_tokens.items()}
        self.n_base_vocab = len(ranks)
        self.n_vocab = (
            max(self.special_tokens.values()) + 1 if special_tokens else len(ranks)
        )
        self.eot_token = self.special_tokens.get("<|endoftext|>")

    # -- encoding ---------------------------------------------------------
    def _bpe_merge(self, piece: bytes) -> List[int]:
        if piece in self.ranks:
            return [self.ranks[piece]]
        parts = [piece[i : i + 1] for i in range(len(piece))]
        while len(parts) > 1:
            best_rank = None
            best_i = -1
            for i in range(len(parts) - 1):
                r = self.ranks.get(parts[i] + parts[i + 1])
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_rank is None:
                break
            parts[best_i : best_i + 2] = [parts[best_i] + parts[best_i + 1]]
        out = []
        for p in parts:
            if p in self.ranks:
                out.append(self.ranks[p])
            else:  # unmergeable bytes under an incomplete vocab: skip
                continue
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for match in self._pat.findall(text):
            ids.extend(self._bpe_merge(match.encode("utf-8")))
        return ids

    def encode_with_special(self, text: str) -> List[int]:
        """Encode, honoring special-token strings embedded in the text."""
        import regex

        if not self.special_tokens:
            return self.encode(text)
        special_pat = "|".join(regex.escape(k) for k in self.special_tokens)
        ids: List[int] = []
        pos = 0
        for m in regex.finditer(special_pat, text):
            ids.extend(self.encode(text[pos : m.start()]))
            ids.append(self.special_tokens[m.group()])
            pos = m.end()
        ids.extend(self.encode(text[pos:]))
        return ids

    # -- decoding ---------------------------------------------------------
    def decode_bytes(self, ids: Sequence[int]) -> bytes:
        out = b""
        for i in ids:
            i = int(i)
            if i in self._decoder:
                out += self._decoder[i]
            elif i in self._special_decoder:
                out += self._special_decoder[i].encode("utf-8")
        return out

    def decode(self, ids: Sequence[int]) -> str:
        return self.decode_bytes(ids).decode("utf-8", errors="replace")

    def decode_skip_special(self, ids: Sequence[int]) -> str:
        base = [int(i) for i in ids if int(i) in self._decoder]
        return self.decode_bytes(base).decode("utf-8", errors="replace")


class ByteFallbackEncoder(BytePairEncoder):
    """Offline stand-in: raw UTF-8 bytes as ids 0..255, same special-token layout.

    Base "vocab" is padded to GPT2_BASE_VOCAB ids so specials land at reference
    positions; ids 256..50255 are never produced. Round-trips all text exactly.
    """

    def __init__(self, special_tokens: Dict[str, int]):
        ranks = {bytes([b]): b for b in range(256)}
        import regex

        self.ranks = ranks
        self.special_tokens = dict(special_tokens)
        self._pat = regex.compile(_GPT2_PAT)
        self._decoder = {b: bytes([b]) for b in range(256)}
        self._special_decoder = {v: k for k, v in self.special_tokens.items()}
        self.n_base_vocab = GPT2_BASE_VOCAB
        self.n_vocab = max(self.special_tokens.values()) + 1
        self.eot_token = self.special_tokens.get("<|endoftext|>")

    def encode(self, text: str) -> List[int]:
        return list(text.encode("utf-8"))


def load_tiktoken_ranks(path: str) -> Dict[bytes, int]:
    """Parse a tiktoken rank file: lines of '<base64 token> <rank>'."""
    ranks: Dict[bytes, int] = {}
    with open(path, "rb") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            token_b64, rank = line.split()
            ranks[base64.b64decode(token_b64)] = int(rank)
    return ranks


def _find_rank_file(name: str = "gpt2") -> Optional[str]:
    candidates = [
        os.environ.get("OLMOASR_TIKTOKEN", ""),
        os.path.join(os.path.dirname(__file__), "assets", f"{name}.tiktoken"),
        os.path.expanduser(f"~/.cache/olmoasr/{name}.tiktoken"),
    ]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    return None


@functools.lru_cache(maxsize=4)
def get_encoding(name: str = "gpt2") -> BytePairEncoder:
    """Build the encoding: real BPE ranks when a rank file is present, else
    fallback.

    Special-token LAYOUT is set by ``name`` ([pip:whisper] tokenizer
    encodings): the English "gpt2" ranks INCLUDE <|endoftext|> as rank 50256
    (specials append from 50257 -> n_vocab 51864), while "multilingual" ranks
    do not (eot appended at 50257, sot 50258, timestamps from 50364 ->
    n_vocab 51865).
    """
    path = _find_rank_file(name)
    eot_in_base = name == "gpt2"
    specials_list = _special_token_strings()
    if path is not None:
        ranks = load_tiktoken_ranks(path)
        n = len(ranks)
        specials: Dict[str, int] = {}
        for s in specials_list:
            if s == "<|endoftext|>" and eot_in_base and n == GPT2_BASE_VOCAB:
                specials[s] = GPT2_BASE_VOCAB - 1  # already in the base vocab
            else:
                specials[s] = n
                n += 1
        # <|endoftext|> inside ranks shadows the special id; fix decode side
        return BytePairEncoder(ranks, specials)
    # offline fallback (byte-level ids, exact special layout)
    specials = {}
    n = GPT2_BASE_VOCAB
    if eot_in_base:
        specials["<|endoftext|>"] = GPT2_BASE_VOCAB - 1
        rest = specials_list[1:]
    else:
        rest = specials_list
    for s in rest:
        specials[s] = n
        n += 1
    return ByteFallbackEncoder(specials)


@dataclass
class Tokenizer:
    """Task wrapper with whisper-compatible accessors.

    Mirrors ``[pip:whisper] tokenizer.Tokenizer`` (used throughout the reference:
    sot sequences at ``train_timestamps.py:427-506``, timestamp handling at
    ``olmoasr/transcribe.py:348-408``).
    """

    encoding: BytePairEncoder
    num_languages: int = 99
    language: Optional[str] = None
    task: Optional[str] = None
    multilingual: bool = False
    sot_sequence: Tuple[int, ...] = field(default_factory=tuple)

    def __post_init__(self):
        sot = self.to_id("<|startoftranscript|>")
        seq = [sot]
        if self.language is not None and self.is_multilingual:
            seq.append(self.to_id(f"<|{self.language}|>"))
        if self.task is not None and self.is_multilingual:
            seq.append(self.to_id(f"<|{self.task}|>"))
        self.sot_sequence = tuple(seq)

    # -- raw mapping -------------------------------------------------------
    def to_id(self, special: str) -> int:
        return self.encoding.special_tokens[special]

    @property
    def is_multilingual(self) -> bool:
        # .en models use the gpt2 encoding; OLMoASR is English-only, so a
        # language/task token never enters the sot sequence (matching whisper's
        # gpt2 tokenizer whose sot_sequence is just (sot,)).
        return self.multilingual

    # -- special ids -------------------------------------------------------
    @functools.cached_property
    def eot(self) -> int:
        return self.to_id("<|endoftext|>")

    @functools.cached_property
    def sot(self) -> int:
        return self.to_id("<|startoftranscript|>")

    @functools.cached_property
    def transcribe(self) -> int:
        return self.to_id("<|transcribe|>")

    @functools.cached_property
    def translate(self) -> int:
        return self.to_id("<|translate|>")

    @functools.cached_property
    def sot_lm(self) -> int:
        return self.to_id("<|startoflm|>")

    @functools.cached_property
    def sot_prev(self) -> int:
        return self.to_id("<|startofprev|>")

    @functools.cached_property
    def no_speech(self) -> int:
        return self.to_id("<|nospeech|>")

    @functools.cached_property
    def no_timestamps(self) -> int:
        return self.to_id("<|notimestamps|>")

    @functools.cached_property
    def timestamp_begin(self) -> int:
        return self.to_id("<|0.00|>")

    @property
    def sot_sequence_including_notimestamps(self) -> Tuple[int, ...]:
        return tuple(list(self.sot_sequence) + [self.no_timestamps])

    @functools.cached_property
    def language_token(self) -> int:
        if self.language is None:
            raise ValueError("This tokenizer does not have language token configured")
        return self.to_id(f"<|{self.language}|>")

    @functools.cached_property
    def all_language_tokens(self) -> Tuple[int, ...]:
        return tuple(
            self.to_id(f"<|{code}|>") for code in list(LANGUAGES)[: self.num_languages]
        )

    @functools.cached_property
    def all_language_codes(self) -> Tuple[str, ...]:
        return tuple(list(LANGUAGES)[: self.num_languages])

    # -- encode/decode -----------------------------------------------------
    def encode(self, text: str) -> List[int]:
        return self.encoding.encode(text)

    def decode(self, token_ids: Sequence[int]) -> str:
        token_ids = [int(t) for t in token_ids if int(t) < self.timestamp_begin]
        return self.encoding.decode(token_ids)

    def decode_with_timestamps(self, token_ids: Sequence[int]) -> str:
        """Timestamp tokens rendered as <|x.xx|>, like whisper's."""
        out = []
        chunk: List[int] = []
        for t in [int(t) for t in token_ids]:
            if t >= self.timestamp_begin:
                if chunk:
                    out.append(self.encoding.decode(chunk))
                    chunk = []
                out.append(f"<|{(t - self.timestamp_begin) * 0.02:.2f}|>")
            else:
                chunk.append(t)
        if chunk:
            out.append(self.encoding.decode(chunk))
        return "".join(out)

    # -- suppression lists ---------------------------------------------------
    @functools.cached_property
    def non_speech_tokens(self) -> Tuple[int, ...]:
        """Tokens for speaker tags / non-speech annotations, per whisper's list."""
        symbols = list('"#()*+/:;<=>@[\\]^_`{|}~「」『』')
        symbols += (
            "<< >> <<< >>> -- --- -( -[ (' (\" (( )) ((( ))) [[ ]] {{ }} ♪♪ ♪♪♪".split()
        )
        miscellaneous = set("♩♪♫♬♭♮♯")

        result = set()
        for seed in (" -", " '"):
            ids = self.encoding.encode(seed)
            if ids:
                result.add(ids[0])
        for symbol in symbols + list(miscellaneous):
            for tokens in [
                self.encoding.encode(symbol),
                self.encoding.encode(" " + symbol),
            ]:
                if len(tokens) == 1:
                    result.add(tokens[0])
                elif symbol in miscellaneous and len(tokens) > 0:
                    result.add(tokens[0])
        return tuple(sorted(result))

    # -- word splitting (for word-level timestamps) --------------------------
    def split_to_word_tokens(self, tokens: List[int]):
        if self.language in {"zh", "ja", "th", "lo", "my", "yue"}:
            return self.split_tokens_on_unicode(tokens)
        return self.split_tokens_on_spaces(tokens)

    def split_tokens_on_unicode(self, tokens: List[int]):
        decoded_full = self.decode_with_timestamps(tokens)
        replacement_char = "�"
        words, word_tokens = [], []
        current_tokens: List[int] = []
        unicode_offset = 0
        for token in tokens:
            current_tokens.append(token)
            decoded = self.decode_with_timestamps(current_tokens)
            if (
                replacement_char not in decoded
                or decoded_full[unicode_offset + decoded.index(replacement_char)]
                == replacement_char
            ):
                words.append(decoded)
                word_tokens.append(current_tokens)
                current_tokens = []
                unicode_offset += len(decoded)
        return words, word_tokens

    def split_tokens_on_spaces(self, tokens: List[int]):
        subwords, subword_tokens_list = self.split_tokens_on_unicode(tokens)
        words, word_tokens = [], []
        for subword, subword_tokens in zip(subwords, subword_tokens_list):
            special = subword_tokens[0] >= self.eot
            with_space = subword.startswith(" ")
            punctuation = subword.strip() in string.punctuation
            if special or with_space or punctuation or len(words) == 0:
                words.append(subword)
                word_tokens.append(subword_tokens)
            else:
                words[-1] = words[-1] + subword
                word_tokens[-1].extend(subword_tokens)
        return words, word_tokens


@functools.lru_cache(maxsize=8)
def get_tokenizer(
    multilingual: bool = False,
    *,
    num_languages: int = 99,
    language: Optional[str] = None,
    task: Optional[str] = None,
) -> Tokenizer:
    """Whisper-compatible tokenizer factory. OLMoASR models are English-only, so
    ``multilingual=False`` / gpt2 encoding is the production path
    (``olmoasr/transcribe.py:170-175``)."""
    if language is not None:
        language = language.lower()
        if language not in LANGUAGES:
            if language in TO_LANGUAGE_CODE:
                language = TO_LANGUAGE_CODE[language]
            else:
                raise ValueError(f"Unsupported language: {language}")
    if multilingual:
        language = language or "en"
        task = task or "transcribe"
    else:
        language = None
        task = None
    encoding = get_encoding("multilingual" if multilingual else "gpt2")
    return Tokenizer(
        encoding=encoding,
        num_languages=num_languages,
        language=language,
        task=task,
        multilingual=multilingual,
    )
