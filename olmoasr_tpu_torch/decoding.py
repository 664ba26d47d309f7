"""Greedy and temperature-sampled decoding with whisper-compatible logit
filters and scoring.

Counterpart of ``olmoasr_tpu/decoding.py``. That module imports jax at its
top, so ``DecodingOptions``, ``DecodingResult``, ``compression_ratio``,
``FilterConfig`` and ``build_filter_config`` are copied here with the same
fields and defaults (tests pin them against the originals).

The step loop runs on the host in eager PyTorch: per step ``apply_filters``,
argmax (or a draw from softmax(logits / T) at temperature T > 0) and one
``decode_step``. Finished rows keep emitting EOT; every ``EXIT_CHECK_EVERY``
steps the host reads the finished flags and stops once every row has
finished, as the JAX loop does between its compiled chunks. ``best_of``
samples ride as extra token rows over one encode and one shared cross cache.
Beam search raises NotImplementedError.
"""

from __future__ import annotations

import functools
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from olmoasr_tpu.tokenizer import Tokenizer, get_tokenizer
from olmoasr_tpu_torch import audio as audio_mod
from olmoasr_tpu_torch.models import whisper as model_mod

EXIT_CHECK_EVERY = 32  # steps between host reads of the finished flags


@dataclass(frozen=True)
class DecodingOptions:
    """Mirror of whisper's DecodingOptions."""

    task: str = "transcribe"
    language: Optional[str] = None

    temperature: float = 0.0
    sample_len: Optional[int] = None  # maximum tokens to sample
    best_of: Optional[int] = None  # number of independent samples (t > 0)
    beam_size: Optional[int] = None  # beams (t == 0)
    patience: Optional[float] = None  # beam patience

    length_penalty: Optional[float] = None

    prompt: Optional[Union[str, List[int]]] = None
    prefix: Optional[Union[str, List[int]]] = None

    suppress_tokens: Optional[Union[str, Sequence[int]]] = "-1"
    suppress_blank: bool = True

    without_timestamps: bool = False
    max_initial_timestamp: Optional[float] = 1.0

    fp16: bool = True  # interpreted as bf16

    # int8-quantize the cross-attention K/V cache (per-position scales)
    kv_quant: bool = False


@dataclass(frozen=True)
class DecodingResult:
    audio_features: Optional[torch.Tensor] = None
    language: str = "en"
    language_probs: Optional[Dict[str, float]] = None
    tokens: List[int] = field(default_factory=list)
    text: str = ""
    avg_logprob: float = np.nan
    no_speech_prob: float = np.nan
    temperature: float = np.nan
    compression_ratio: float = np.nan


def compression_ratio(text: str) -> float:
    text_bytes = text.encode("utf-8")
    if len(text_bytes) == 0:
        return 0.0
    return len(text_bytes) / len(zlib.compress(text_bytes))


# ---------------------------------------------------------------------------
# logit filters
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FilterConfig:
    """Static data for the logit filters, precomputed host-side."""

    sample_begin: int
    eot: int
    timestamp_begin: int
    no_timestamps: int
    blank_suppress: Tuple[int, ...]  # (" " ids + eot) for SuppressBlank
    suppress: Tuple[int, ...]  # SuppressTokens list
    apply_timestamp_rules: bool
    max_initial_timestamp_index: Optional[int]
    n_vocab: int

    @functools.cached_property
    def suppress_mask(self) -> np.ndarray:
        m = np.zeros((self.n_vocab,), np.float32)
        m[list(self.suppress)] = -np.inf
        return m

    @functools.cached_property
    def blank_mask(self) -> np.ndarray:
        m = np.zeros((self.n_vocab,), np.float32)
        m[list(self.blank_suppress)] = -np.inf
        return m


def build_filter_config(
    tokenizer: Tokenizer,
    options: DecodingOptions,
    sample_begin: int,
    n_vocab: int,
    n_frames_content: Optional[int] = None,
) -> FilterConfig:
    """Replicates DecodingTask._get_suppress_tokens + filter setup."""
    suppress = options.suppress_tokens
    if isinstance(suppress, str):
        suppress = [int(t) for t in suppress.split(",")] if suppress else []
    else:
        suppress = list(suppress) if suppress is not None else []
    if -1 in suppress:
        suppress = [t for t in suppress if t >= 0]
        suppress.extend(tokenizer.non_speech_tokens)
    suppress.extend(
        [tokenizer.transcribe, tokenizer.translate, tokenizer.sot,
         tokenizer.sot_prev, tokenizer.sot_lm]
    )
    if tokenizer.no_speech is not None:
        suppress.append(tokenizer.no_speech)
    suppress = tuple(sorted(set(suppress)))

    precision = 0.02
    max_initial_timestamp_index = None
    if options.max_initial_timestamp is not None:
        max_initial_timestamp_index = round(options.max_initial_timestamp / precision)

    blank = tuple(tokenizer.encode(" ") + [tokenizer.eot])

    return FilterConfig(
        sample_begin=sample_begin,
        eot=tokenizer.eot,
        timestamp_begin=tokenizer.timestamp_begin,
        no_timestamps=tokenizer.no_timestamps,
        blank_suppress=blank if options.suppress_blank else (),
        suppress=suppress,
        apply_timestamp_rules=not options.without_timestamps,
        max_initial_timestamp_index=max_initial_timestamp_index,
        n_vocab=n_vocab,
    )


@functools.lru_cache(maxsize=8)
def _filter_masks(cfg: FilterConfig, device: str) -> Tuple[torch.Tensor, torch.Tensor]:
    return (torch.from_numpy(cfg.suppress_mask).to(device),
            torch.from_numpy(cfg.blank_mask).to(device))


def apply_filters(
    logits: torch.Tensor,  # (B, V) fp32
    tokens: torch.Tensor,  # (B, max_len) sampled-token ring (eot-padded)
    step: int,  # number of tokens sampled so far
    cfg: FilterConfig,
) -> torch.Tensor:
    """SuppressBlank, SuppressTokens and the timestamp rules
    ([pip:whisper] decoding.py semantics), vectorized over the batch."""
    V = logits.shape[-1]
    dev = logits.device
    neg_inf = torch.tensor(float("-inf"), device=dev)
    suppress_mask, blank_mask = _filter_masks(cfg, str(dev))
    logits = logits + suppress_mask
    if cfg.blank_suppress and step == 0:
        logits = logits + blank_mask

    ids = torch.arange(V, device=dev)
    if not cfg.apply_timestamp_rules:
        ts_mask = (ids >= cfg.timestamp_begin) | (ids == cfg.no_timestamps)
        return torch.where(ts_mask[None, :], neg_inf, logits)

    ts_begin = cfg.timestamp_begin
    is_ts = ids >= ts_begin
    is_text = ids < cfg.eot
    non_ts = ~is_ts
    B, L = tokens.shape
    tokens = tokens.long()

    no_tok = torch.full((B,), -1, dtype=torch.long, device=dev)
    last_tok = tokens[:, step - 1] if step > 0 else no_tok
    penult_tok = tokens[:, step - 2] if step > 1 else no_tok
    last_was_ts = (last_tok >= ts_begin) & (step >= 1)
    penult_was_ts = (penult_tok >= ts_begin) | (step < 2)

    # rule 1: after ts+ts no timestamp; after text+ts no text (close the pair)
    mask_ts = last_was_ts & penult_was_ts
    mask_text = last_was_ts & ~penult_was_ts
    rule1 = (mask_ts[:, None] & is_ts[None, :]) | (mask_text[:, None] & is_text[None, :])
    logits = torch.where(rule1, neg_inf, logits)
    logits[:, cfg.no_timestamps] = float("-inf")

    # rule 2: timestamps are monotonic (the last one may repeat right after it)
    valid = torch.arange(L, device=dev)[None, :] < step
    tok_is_ts = (tokens >= ts_begin) & valid
    last_ts_val = torch.where(tok_is_ts, tokens, 0).amax(dim=1)
    have_ts = tok_is_ts.any(dim=1)
    floor_ts = torch.where(last_was_ts, last_ts_val, last_ts_val + 1)
    ts_too_small = is_ts[None, :] & (ids[None, :] < floor_ts[:, None])
    logits = torch.where(have_ts[:, None] & ts_too_small, neg_inf, logits)

    # rule 3: the first sample is a timestamp, no later than the initial limit
    if step == 0:
        logits = torch.where(non_ts[None, :], neg_inf, logits)
        if cfg.max_initial_timestamp_index is not None:
            last_allowed = ts_begin + cfg.max_initial_timestamp_index
            logits = torch.where((ids > last_allowed)[None, :], neg_inf, logits)

    # rule 4: sample a timestamp when their total probability beats every
    # single non-timestamp token (EOT included, so EOT can end the segment)
    logprobs = torch.log_softmax(logits, dim=-1)
    ts_logprob = torch.logsumexp(torch.where(is_ts[None, :], logprobs, neg_inf), dim=-1)
    max_text_logprob = torch.where(non_ts[None, :], logprobs, neg_inf).amax(dim=-1)
    force_ts = ts_logprob > max_text_logprob
    return torch.where(force_ts[:, None] & non_ts[None, :], neg_inf, logits)


# ---------------------------------------------------------------------------
# greedy loop
# ---------------------------------------------------------------------------


def _next_tokens(filt: torch.Tensor, temperature: float,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    """Argmax at temperature 0; else one draw per row from
    softmax(filt / T), as the JAX step's categorical over filt / max(T, 1e-6)."""
    if temperature == 0:
        return filt.argmax(dim=-1)
    probs = torch.softmax(filt / max(temperature, 1e-6), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.no_grad()
def _decode_sample(
    model: model_mod.Whisper,
    mel: torch.Tensor,  # (B, n_mels, N_FRAMES)
    prompt: List[int],
    cfg: FilterConfig,
    sample_len: int,
    sot_index: int,
    kv_quant: bool,
    temperature: float = 0.0,
    n_groups: int = 1,
    generator: Optional[torch.Generator] = None,
):
    """Encoder + prompt prefill + sampling steps for ``n_groups`` token rows
    per window (row b * n_groups + g), all reading the window's one cross
    cache; returns the sampled token ring (B * n_groups, sample_len), the
    summed log-probs, the probabilities at the sot position and the (B, ...)
    audio features."""
    audio_features = model_mod.encode_audio(model, mel)
    rows = audio_features.shape[0] * n_groups
    dev = audio_features.device
    cache = model_mod.init_cache(
        model, audio_features, max_len=len(prompt) + sample_len, quantize_cross=kv_quant,
        self_batch=rows,
    )
    prompt_t = torch.tensor([prompt] * rows, dtype=torch.long, device=dev)
    logits_all = model_mod.decode_step(model, prompt_t, cache)
    # no-speech probability at the sot position ([pip:whisper] _main_loop)
    probs_at_sot = torch.softmax(logits_all[:, sot_index], dim=-1)
    logits = logits_all[:, -1]

    tokens = torch.full((rows, sample_len), cfg.eot, dtype=torch.long, device=dev)
    finished = torch.zeros((rows,), dtype=torch.bool, device=dev)
    sum_logprobs = torch.zeros((rows,), dtype=torch.float32, device=dev)
    for i in range(sample_len):
        filt = apply_filters(logits, tokens, i, cfg)
        tok = torch.where(finished, cfg.eot, _next_tokens(filt, temperature, generator))
        tok_logprob = torch.log_softmax(filt, dim=-1).gather(1, tok[:, None])[:, 0]
        sum_logprobs += torch.where(finished, 0.0, tok_logprob)
        tokens[:, i] = tok
        finished |= tok == cfg.eot
        if i == sample_len - 1:
            break
        if (i + 1) % EXIT_CHECK_EVERY == 0 and bool(finished.all()):
            break
        logits = model_mod.decode_step(model, tok[:, None], cache)[:, 0]
    return tokens, sum_logprobs, probs_at_sot, audio_features


class MaximumLikelihoodRanker:
    """Pick the highest log-prob sequence, normalized by length or the Google
    NMT length penalty ([pip:whisper] decoding.MaximumLikelihoodRanker)."""

    def __init__(self, length_penalty: Optional[float]):
        self.length_penalty = length_penalty

    def rank(self, tokens: List[List[List[int]]], sum_logprobs: List[List[float]]):
        def scores(logprobs, lengths):
            result = []
            for logprob, length in zip(logprobs, lengths):
                if self.length_penalty is None:
                    penalty = length
                else:
                    penalty = ((5 + length) / 6) ** self.length_penalty
                result.append(logprob / penalty)
            return result

        lengths = [[len(t) for t in s] for s in tokens]
        return [int(np.argmax(scores(p, l))) for p, l in zip(sum_logprobs, lengths)]


def _resolve_prompt(tokenizer: Tokenizer, options: DecodingOptions) -> List[int]:
    """Initial token sequence (DecodingTask._get_initial_tokens)."""
    tokens = list(tokenizer.sot_sequence)
    if options.without_timestamps:
        tokens = list(tokenizer.sot_sequence_including_notimestamps)
    if options.prefix is not None:
        prefix = options.prefix
        prefix_tokens = (
            tokenizer.encode(" " + prefix.strip()) if isinstance(prefix, str) else prefix
        )
        if options.sample_len is not None:
            max_prefix_len = 448 // 2 - options.sample_len
            prefix_tokens = prefix_tokens[-max_prefix_len:]
        tokens = tokens + list(prefix_tokens)
    if options.prompt is not None:
        prompt = options.prompt
        prompt_tokens = (
            tokenizer.encode(" " + prompt.strip()) if isinstance(prompt, str) else prompt
        )
        tokens = [tokenizer.sot_prev] + list(prompt_tokens[-(448 // 2 - 1):]) + tokens
    return tokens


def _check_supported(options: DecodingOptions) -> None:
    # the JAX package takes its beam path only at temperature 0
    if options.beam_size is not None and options.temperature == 0:
        raise NotImplementedError(
            "beam search is not ported yet (ROADMAP Queue 1 item 7)"
        )


def decode(
    model: model_mod.Whisper,
    mel: Union[np.ndarray, torch.Tensor],
    options: DecodingOptions = DecodingOptions(),
    *,
    generator: Optional[torch.Generator] = None,
) -> Union[DecodingResult, List[DecodingResult]]:
    """Whisper-compatible ``decode``: batched 30 s windows in, results out.

    Runs on ``model``'s device and computes in bf16 when ``options.fp16``,
    else in fp32, from a copy of the weights in that dtype when the model's
    differ (``Whisper.in_dtype``), as the JAX package computes from its fp32
    params. Sampling at temperature > 0 draws from ``generator``, a
    ``torch.Generator`` on the model's device, seeded 0 when none is given
    (the JAX package's ``PRNGKey(0)``)."""
    _check_supported(options)
    model = model.in_dtype(torch.bfloat16 if options.fp16 else torch.float32)
    if generator is None:
        generator = torch.Generator(device=model.device).manual_seed(0)
    mel = torch.as_tensor(mel)
    single = mel.ndim == 2
    if single:
        mel = mel[None]
    if mel.shape[-1] != audio_mod.N_FRAMES:
        mel = audio_mod.pad_or_trim(mel, audio_mod.N_FRAMES, axis=-1)
    mel = mel.to(model.device)

    dims = model.dims
    language = options.language or "en"
    multilingual = dims.n_vocab >= 51865
    num_languages = dims.n_vocab - 51765 - 1 if multilingual else 99
    tokenizer = get_tokenizer(
        multilingual=multilingual, num_languages=num_languages,
        language=language, task=options.task,
    )

    n_ctx = dims.n_text_ctx
    prompt = _resolve_prompt(tokenizer, options)
    # positional-embedding guard: prompt + samples must fit n_text_ctx
    sample_len = min(options.sample_len or n_ctx // 2, n_ctx - len(prompt))
    if sample_len <= 0:
        raise ValueError(
            f"prompt length {len(prompt)} leaves no room to sample (n_text_ctx={n_ctx})"
        )
    sot_index = prompt.index(tokenizer.sot)
    cfg = build_filter_config(tokenizer, options, len(prompt), dims.n_vocab)

    # best_of samples ride as extra token rows over one encode per window
    n_groups = options.best_of if (options.best_of and options.temperature > 0) else 1
    tokens, sum_logprobs, probs_at_sot, audio_features = _decode_sample(
        model, mel, prompt, cfg, sample_len, sot_index, options.kv_quant,
        options.temperature, n_groups, generator,
    )
    # the groups of a window share its audio, so their no-speech probs agree
    no_speech_probs = probs_at_sot[::n_groups, tokenizer.no_speech].cpu().numpy()
    seqs, lps = tokens.cpu().tolist(), sum_logprobs.cpu().tolist()
    token_lists, lp_lists = [], []
    for b in range(mel.shape[0]):
        group_tokens = []
        for seq in seqs[b * n_groups:(b + 1) * n_groups]:
            if tokenizer.eot in seq:
                seq = seq[: seq.index(tokenizer.eot)]
            group_tokens.append(seq)
        token_lists.append(group_tokens)
        lp_lists.append(lps[b * n_groups:(b + 1) * n_groups])
    return _finalize_results(
        token_lists, lp_lists, no_speech_probs, tokenizer, options,
        audio_features, language, single,
    )


def _finalize_results(
    token_lists, lp_lists, no_speech_probs, tokenizer, options,
    audio_features, language, single,
) -> Union[DecodingResult, List[DecodingResult]]:
    ranker = MaximumLikelihoodRanker(options.length_penalty)
    selected = ranker.rank(token_lists, lp_lists)
    results = []
    for b, idx in enumerate(selected):
        toks = token_lists[b][idx]
        text = tokenizer.decode(toks).strip()
        n = len(toks)
        avg_logprob = lp_lists[b][idx] / (n + 1) if n >= 0 else np.nan
        results.append(
            DecodingResult(
                audio_features=audio_features[b] if audio_features is not None else None,
                language=language,
                tokens=toks,
                text=text,
                avg_logprob=avg_logprob,
                no_speech_prob=float(no_speech_probs[b]),
                temperature=options.temperature,
                compression_ratio=compression_ratio(text),
            )
        )
    return results[0] if single else results
