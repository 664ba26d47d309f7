"""Greedy, temperature-sampled and beam-search decoding with
whisper-compatible logit filters and scoring.

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

``beam_size`` at temperature 0 takes the beam loop (``_decode_beam``): K
beams per window as token rows over the window's shared cross cache, the
top 2K candidates per window each step, EOT candidates into a finished pool
of ``round(K * patience)``, and an ancestry map that ``decode_step`` reads
instead of reordering the self rings; the host stops every
``EXIT_CHECK_EVERY`` steps once every window's worst finished score beats
its best live one.
"""

from __future__ import annotations

import functools
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from olmoasr_tpu_torch.tokenizer import Tokenizer, get_tokenizer
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


# ---------------------------------------------------------------------------
# beam search
# ---------------------------------------------------------------------------

_BEAM_NEG = -1e30  # score of an empty slot (finished pool) or a masked beam


@dataclass
class _BeamState:
    """The beam loop's device state for B windows of K beams: the token
    history (B*K, sample_len), the live scores (B, K), the finished pool
    (B, N, sample_len) with its scores (B, N), the last logits (B*K, V) and
    the ancestry map (B*K, C) int32."""

    tokens: torch.Tensor
    beam_lp: torch.Tensor
    fin_tokens: torch.Tensor
    fin_lp: torch.Tensor
    logits: torch.Tensor
    anc: torch.Tensor


def _beam_step(st: _BeamState, i: int, cfg: FilterConfig, index: int) -> torch.Tensor:
    """One beam-search step, in place on ``st`` (whisper BeamSearchDecoder
    semantics, the JAX package's ``_beam_step``): per window the K best
    unfinished hypotheses continue and EOT candidates enter the finished
    pool. ``index`` is the position this step's tokens are written at.
    Returns the (B*K,) tokens to feed the next ``decode_step``."""
    B, K = st.beam_lp.shape
    V = st.logits.shape[-1]
    L = st.tokens.shape[1]
    C = st.anc.shape[1]
    dev = st.logits.device
    filt = apply_filters(st.logits, st.tokens, i, cfg)
    cand = st.beam_lp[:, :, None] + torch.log_softmax(filt, dim=-1).view(B, K, V)
    if i == 0:  # every beam holds the prompt: keep beam 0's candidates only
        cand[:, 1:] = _BEAM_NEG
    # the top 2K, so that EOT candidates cannot starve the live beams
    top_lp, top_idx = cand.view(B, K * V).topk(2 * K, dim=-1)
    src_beam = top_idx // V
    tok = top_idx % V
    is_eot = tok == cfg.eot

    # finished pool: the best of the pool and this step's EOT candidates
    src_tokens = st.tokens.view(B, K, L).gather(1, src_beam[:, :, None].expand(B, 2 * K, L))
    src_tokens[:, :, i] = cfg.eot
    merged_lp = torch.cat([st.fin_lp, torch.where(is_eot, top_lp, _BEAM_NEG)], dim=1)
    merged_tokens = torch.cat([st.fin_tokens, src_tokens], dim=1)
    st.fin_lp, best = merged_lp.topk(st.fin_lp.shape[1], dim=-1)
    st.fin_tokens = merged_tokens.gather(1, best[:, :, None].expand(-1, -1, L))

    # live beams: the best K non-EOT candidates; the token history follows
    # its source beam, the rings stay and the ancestry map is permuted
    st.beam_lp, best = torch.where(is_eot, _BEAM_NEG, top_lp).topk(K, dim=-1)
    live_beam = src_beam.gather(1, best)
    live_tok = tok.gather(1, best).reshape(-1)
    rows = (torch.arange(B, device=dev)[:, None] * K + live_beam).reshape(-1)
    st.tokens = st.tokens[rows]
    st.tokens[:, i] = live_tok
    anc = st.anc.view(B, K, C).gather(1, live_beam[:, :, None].expand(B, K, C))
    # positions from this step on are each row's own (its next key is
    # written to its own ring row)
    anc[:, :, index:] = torch.arange(K, device=dev, dtype=anc.dtype)[None, :, None]
    st.anc = anc.view(B * K, C)
    return live_tok


@torch.no_grad()
def _beam_prefill(model, mel, prompt, cfg, sample_len, sot_index, kv_quant, beam_size,
                  patience):
    """Encoder and prompt prefill of the beam loop: K = ``beam_size`` token
    rows per window, row b * K + k, over the window's one cross cache; an
    empty finished pool of N = max(round(K * patience), 1) slots; the
    identity ancestry map (every row wrote its own prompt keys). Returns the
    cache, the state, the probabilities at the sot position (B, V) and the
    audio features."""
    K = beam_size
    n_fin = max(int(round(K * (patience or 1.0))), 1)
    audio_features = model_mod.encode_audio(model, mel)
    B = audio_features.shape[0]
    dev = audio_features.device
    cache = model_mod.init_cache(
        model, audio_features, max_len=len(prompt) + sample_len, quantize_cross=kv_quant,
        self_batch=B * K,
    )
    logits_all = model_mod.decode_step(
        model, torch.tensor([prompt] * (B * K), dtype=torch.long, device=dev), cache
    )
    probs_at_sot = torch.softmax(logits_all[::K, sot_index], dim=-1)
    C = cache.self_k.shape[2]
    st = _BeamState(
        tokens=torch.full((B * K, sample_len), cfg.eot, dtype=torch.long, device=dev),
        beam_lp=torch.zeros((B, K), dtype=torch.float32, device=dev),
        fin_tokens=torch.full((B, n_fin, sample_len), cfg.eot, dtype=torch.long, device=dev),
        fin_lp=torch.full((B, n_fin), _BEAM_NEG, dtype=torch.float32, device=dev),
        logits=logits_all[:, -1],
        anc=(torch.arange(B * K, device=dev, dtype=torch.int32) % K)[:, None]
        .expand(B * K, C).contiguous(),
    )
    return cache, st, probs_at_sot, audio_features


@torch.no_grad()
def _decode_beam(
    model: model_mod.Whisper,
    mel: torch.Tensor,  # (B, n_mels, N_FRAMES)
    prompt: List[int],
    cfg: FilterConfig,
    sample_len: int,
    sot_index: int,
    kv_quant: bool,
    beam_size: int,
    patience: Optional[float],
):
    """The beam loop (the JAX package's ``_decode_beam_jit``): the prefill,
    then per step ``_beam_step`` and one ``decode_step`` that reads the
    ancestry map. Returns every window's finished and live hypotheses
    (B, N + K, sample_len) with their scores (B, N + K), the probabilities
    at the sot position (B, V) and the audio features."""
    cache, st, probs_at_sot, audio_features = _beam_prefill(
        model, mel, prompt, cfg, sample_len, sot_index, kv_quant, beam_size, patience,
    )
    B, K = st.beam_lp.shape
    for i in range(sample_len):
        tok = _beam_step(st, i, cfg, cache.index)
        if i == sample_len - 1:
            break
        # stop once no live continuation can still enter any window's pool
        if (i + 1) % EXIT_CHECK_EVERY == 0 and bool(
            (st.fin_lp.amin(dim=1) >= st.beam_lp.amax(dim=1)).all()
        ):
            break
        st.logits = model_mod.decode_step(model, tok[:, None], cache, beam_anc=st.anc)[:, 0]
    # live beams count as hypotheses too (whisper finalizes them with EOT)
    all_tokens = torch.cat([st.fin_tokens, st.tokens.view(B, K, sample_len)], dim=1)
    all_lp = torch.cat([st.fin_lp, st.beam_lp], dim=1)
    return all_tokens, all_lp, probs_at_sot, audio_features


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
    (the JAX package's ``PRNGKey(0)``). ``beam_size`` at temperature 0
    takes the beam loop, whatever ``best_of`` says."""
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

    if options.beam_size is not None and options.temperature == 0:
        all_tokens, all_lp, probs_at_sot, audio_features = _decode_beam(
            model, mel, prompt, cfg, sample_len, sot_index, options.kv_quant,
            options.beam_size, options.patience,
        )
        token_lists, lp_lists = _beam_hypotheses(all_tokens, all_lp, tokenizer.eot)
        return _finalize_results(
            token_lists, lp_lists, probs_at_sot[:, tokenizer.no_speech].cpu().numpy(),
            tokenizer, options, audio_features, language, single,
        )

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


def _beam_hypotheses(all_tokens: torch.Tensor, all_lp: torch.Tensor, eot: int):
    """Per window, the hypotheses of the pool and the live beams that hold a
    score (empty slots, at -1e30, are dropped), each cut at its first EOT;
    a window with none keeps one empty hypothesis."""
    seqs, lps = all_tokens.cpu().tolist(), all_lp.cpu().tolist()
    token_lists, lp_lists = [], []
    for window_seqs, window_lps in zip(seqs, lps):
        group_tokens, group_lps = [], []
        for seq, lp in zip(window_seqs, window_lps):
            if lp <= -1e29:
                continue
            group_tokens.append(seq[: seq.index(eot)] if eot in seq else seq)
            group_lps.append(lp)
        if not group_tokens:
            group_tokens, group_lps = [[]], [window_lps[0]]
        token_lists.append(group_tokens)
        lp_lists.append(group_lps)
    return token_lists, lp_lists


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


# ---------------------------------------------------------------------------
# language detection
# ---------------------------------------------------------------------------


@torch.no_grad()
def detect_language(
    model: model_mod.Whisper,
    mel: Union[np.ndarray, torch.Tensor],
    tokenizer: Optional[Tokenizer] = None,
) -> Tuple[torch.Tensor, Union[Dict[str, float], List[Dict[str, float]]]]:
    """Single-forward language id ([pip:whisper] decoding.detect_language),
    as the JAX package computes it: encode, one ``decode_step`` of SOT over
    a 4-position cache, fp32 logits masked to the language tokens, softmax.
    Runs in the weights' dtype on the model's device. Returns the language
    token ids (a CPU tensor) and each window's {code: probability}; a single
    (n_mels, frames) mel gives one id and one dict.

    As in the JAX package, ``tokenizer`` defaults to the English one, also
    for a multilingual model (whose language ids it reads one id early)."""
    if tokenizer is None:
        tokenizer = get_tokenizer(multilingual=False)
    mel = torch.as_tensor(mel)
    single = mel.ndim == 2
    if single:
        mel = mel[None]
    if mel.shape[-1] != audio_mod.N_FRAMES:
        mel = audio_mod.pad_or_trim(mel, audio_mod.N_FRAMES, axis=-1)

    audio_features = model_mod.encode_audio(model, mel.to(model.device))
    B = mel.shape[0]
    sot = torch.full((B, 1), tokenizer.sot, dtype=torch.long, device=model.device)
    cache = model_mod.init_cache(model, audio_features, max_len=4)
    logits = model_mod.decode_step(model, sot, cache)[:, 0].float()  # (B, V)

    mask = torch.full((logits.shape[-1],), float("-inf"), device=logits.device)
    mask[list(tokenizer.all_language_tokens)] = 0.0
    logits = logits + mask
    language_tokens = logits.argmax(dim=-1).cpu()
    probs = torch.softmax(logits, dim=-1).cpu().numpy()
    language_probs = [
        {c: float(probs[i, t])
         for c, t in zip(tokenizer.all_language_codes, tokenizer.all_language_tokens)}
        for i in range(B)
    ]
    if single:
        return language_tokens[0], language_probs[0]
    return language_tokens, language_probs
