"""Smoke run of the PyTorch/CUDA port (``olmoasr_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases, one
printed line each (or a few):

1. identity and build: the card's name and power limit, torch and CUDA
   versions, the kernels compiled from ``olmoasr_tpu_torch/csrc``;
2. every kernel against its plain PyTorch twin at the slices' shapes, with
   the tolerance and the device times of both (CUDA events around replays of
   a CUDA graph of one call, median of 11 runs);
3. the short-form slice: small.en at full width with seeded random weights,
   64 windows of 30 s noise, GPU log-mel, greedy ``decode`` with bf16 and
   with int8 cross K/V; wall time, audio-seconds per second, kernel launch
   counts;
4. the long-form slice: small.en in bf16, 16 files of 40-75 s of seeded
   noise through ``transcribe_many(batch_size=16)`` with the default
   temperature ladder and thresholds and best_of=5 (random weights fail the
   gates, so every window climbs the whole ladder); wall time,
   audio-seconds per second, windows per temperature, single-token steps,
   every kernel's launches, the results' schema;
5. a teacher-forced fp32 check, 2 windows with 2 token rows each (the shared
   cross cache): the same weights and tokens through the port on the GPU
   (kernels) and on the CPU (plain twins).

Each slice sets every launch count to 0 before it runs and reads them after;
the ``launches`` of the kernels line are the long-form slice's.

The next-to-last line is ``{"kernels": [...]}``, the last
``{"ok": true, "device": {...}}``. Any failed phase exits non-zero before
either is printed; so does a machine without a CUDA device.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


try:
    import numpy as np
    import torch
except ImportError as exc:  # pragma: no cover - depends on the machine
    fail(f"needs numpy and torch: {exc}")

RUNS = 11  # timed runs per measurement (odd: the median is one run)


def timed_ms(fn) -> float:
    """Median device time of one call of ``fn`` in ms over RUNS runs: the call
    is captured once in a CUDA graph and the replays are timed with CUDA
    events, so the host's launch cost (which bounds an eager call at these
    sizes) stays out of the kernel's time."""
    fn()  # warm-up: builds, caches, one-time attributes
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    times = []
    for _ in range(RUNS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    del graph
    return statistics.median(times)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def bf16_tol(ref: torch.Tensor) -> float:
    # two bf16 ulps at the output's largest magnitude: kernel and twin round
    # their bf16 operands and results at the same places, but fp32 sums taken
    # in another order can land one rounding step apart
    return 2.0 ** -6 * float(ref.float().abs().max())


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------


def phase_identity() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    from olmoasr_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path, log = _build.build(verbose=True)
    _build.lib()
    print(f"build: {path.name} in {time.perf_counter() - t0:.1f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line.lower() and "0 bytes spill" not in line:
            print(f"  ptxas: {line.strip()}")
    return smi


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------


def _weights(gen, *shape, fan_in, dtype):
    return (torch.randn(*shape, generator=gen) * (2.0 / fan_in) ** 0.5).to("cuda", dtype)


def check_mlp(gen) -> list:
    from olmoasr_tpu_torch.ops.attention import mlp_block, mlp_block_plain

    B, D, Fd = 64, 768, 3072
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        args = (
            torch.randn(B, 1, D, generator=gen).to("cuda", dtype),
            (1 + 0.1 * torch.randn(D, generator=gen)).to("cuda", dtype),
            (0.1 * torch.randn(D, generator=gen)).to("cuda", dtype),
            _weights(gen, Fd, D, fan_in=D, dtype=dtype),
            (0.02 * torch.randn(Fd, generator=gen)).to("cuda", dtype),
            _weights(gen, D, Fd, fan_in=Fd, dtype=dtype),
            (0.02 * torch.randn(D, generator=gen)).to("cuda", dtype),
        )
        got, want = mlp_block(*args), mlp_block_plain(*args)
        cases.append(_case("mlp_block", dtype, got, want,
                           lambda: mlp_block(*args), lambda: mlp_block_plain(*args)))
    return cases


def check_cross(gen) -> list:
    from olmoasr_tpu_torch.models.whisper import _quantize_rows
    from olmoasr_tpu_torch.ops.attention import cross_block_decode, cross_block_decode_plain

    B, T, D, H = 64, 1500, 768, 12
    cases = []
    for act, kv in ((torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.int8),
                    (torch.float32, torch.float32)):
        x = torch.randn(B, 1, D, generator=gen).to("cuda", act)
        w = [(1 + 0.1 * torch.randn(D, generator=gen)).to("cuda", act),
             (0.1 * torch.randn(D, generator=gen)).to("cuda", act),
             _weights(gen, D, D, fan_in=D, dtype=act),
             (0.02 * torch.randn(D, generator=gen)).to("cuda", act),
             _weights(gen, D, D, fan_in=D, dtype=act),
             (0.02 * torch.randn(D, generator=gen)).to("cuda", act)]
        ck = torch.randn(B, T, D, generator=gen).to("cuda")
        cv = torch.randn(B, T, D, generator=gen).to("cuda")
        if kv == torch.int8:
            ck, ks = _quantize_rows(ck)
            cv, vs = _quantize_rows(cv)
            ks, vs = ks[:, None, :], vs[:, None, :]
        else:
            ck, cv = ck.to(kv), cv.to(kv)
            ks = vs = torch.ones(B, 1, T, device="cuda")
        args = (x, *w, ck, cv, ks.contiguous(), vs.contiguous(), H)
        got, want = cross_block_decode(*args), cross_block_decode_plain(*args)
        cases.append(_case("cross_block_decode", (act, kv), got, want,
                           lambda: cross_block_decode(*args),
                           lambda: cross_block_decode_plain(*args)))
    # best_of: 5 token rows over each of 16 cache rows
    G, Bc = 5, 16
    x = torch.randn(Bc * G, 1, D, generator=gen).to("cuda", torch.bfloat16)
    ck, cv = (torch.randn(Bc, T, D, generator=gen).to("cuda", torch.bfloat16) for _ in range(2))
    ones = torch.ones(Bc, 1, T, device="cuda")
    args = (x, *[t.to(torch.bfloat16) for t in w], ck, cv, ones, ones, H)
    kw = dict(kv_group=G)
    got, want = cross_block_decode(*args, **kw), cross_block_decode_plain(*args, **kw)
    cases.append(_case("cross_block_decode", (torch.bfloat16, f"kv_group={G}, {Bc * G} rows"),
                       got, want, lambda: cross_block_decode(*args, **kw),
                       lambda: cross_block_decode_plain(*args, **kw)))
    return cases


def check_attention(gen) -> list:
    from olmoasr_tpu_torch.ops.train_attention import (
        train_attention_fwd, train_attention_fwd_plain,
    )

    cases = []
    B, T, D, H = 64, 1500, 768, 12
    for dtype, valid_len in ((torch.bfloat16, None), (torch.bfloat16, 1437),
                             (torch.float32, 1437)):
        q, k, v = (torch.randn(B, T, D, generator=gen).to("cuda", dtype) for _ in range(3))
        kw = dict(valid_len=valid_len)
        got = train_attention_fwd(q, k, v, H, **kw)
        want = train_attention_fwd_plain(q, k, v, H, **kw)
        cases.append(_case("train_attention_fwd", (dtype, f"enc valid_len={valid_len}"),
                           got, want, lambda: train_attention_fwd(q, k, v, H, **kw),
                           lambda: train_attention_fwd_plain(q, k, v, H, **kw)))
        del q, k, v, got, want
    B, T = 16, 448
    q, k, v = (torch.randn(B, T, D, generator=gen).to("cuda", torch.bfloat16) for _ in range(3))
    lengths = torch.randint(T // 2, T + 1, (B,), generator=gen)
    key_bias = torch.where(torch.arange(T)[None] < lengths[:, None], 0.0, float("-inf")).cuda()
    kw = dict(causal=True, key_bias=key_bias)
    got = train_attention_fwd(q, k, v, H, **kw)
    want = train_attention_fwd_plain(q, k, v, H, **kw)
    cases.append(_case("train_attention_fwd", (torch.bfloat16, "causal+key_bias T=448"), got,
                       want, lambda: train_attention_fwd(q, k, v, H, **kw),
                       lambda: train_attention_fwd_plain(q, k, v, H, **kw)))
    return cases


def check_self_sub_block(gen) -> dict:
    """ln_matmul, self_attend_decode on a full-size ring (q, k_new and v_new
    as row views of the fused projection, as decode_step passes them) and
    matmul_residual, at the decode step's widths."""
    from olmoasr_tpu_torch.ops.attention import (
        ln_matmul, ln_matmul_plain, matmul_residual, matmul_residual_plain,
        self_attend_decode, self_attend_decode_plain,
    )

    B, D, H, L, C, layer = 64, 768, 12, 12, 225, 7
    cases = {"ln_matmul": [], "matmul_residual": [], "self_attend_decode": []}
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn(B, 1, D, generator=gen).to("cuda", dtype)
        ln = ((1 + 0.1 * torch.randn(D, generator=gen)).to("cuda", dtype),
              (0.1 * torch.randn(D, generator=gen)).to("cuda", dtype))
        w, b = _weights(gen, 3 * D, D, fan_in=D, dtype=dtype), \
            (0.02 * torch.randn(3 * D, generator=gen)).to("cuda", dtype)
        args = (x, *ln, w, b)
        qkv = ln_matmul(*args)
        cases["ln_matmul"].append(_case(
            "ln_matmul", (dtype, f"B={B} D={D} N={3 * D}"), qkv, ln_matmul_plain(*args),
            lambda: ln_matmul(*args), lambda: ln_matmul_plain(*args)))
        q, kn, vn = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
        rings = [torch.randn(L, B, C, D, generator=gen).to("cuda", dtype) for _ in range(2)]
        for offset in (224, 100, 1):
            sa = (q, *rings, kn, vn, offset, layer)
            attn = self_attend_decode(*sa, n_head=H)
            cases["self_attend_decode"].append(_case(
                "self_attend_decode", (dtype, f"ring L={L} B={B} C={C} layer {layer} offset {offset}"),
                attn, self_attend_decode_plain(*sa, n_head=H),
                lambda: self_attend_decode(*sa, n_head=H),
                lambda: self_attend_decode_plain(*sa, n_head=H)))
        del rings
        wo, bo = _weights(gen, D, D, fan_in=D, dtype=dtype), \
            (0.02 * torch.randn(D, generator=gen)).to("cuda", dtype)
        mr = (attn, x, wo, bo)
        cases["matmul_residual"].append(_case(
            "matmul_residual", (dtype, f"B={B} D={D}"), matmul_residual(*mr),
            matmul_residual_plain(*mr), lambda: matmul_residual(*mr),
            lambda: matmul_residual_plain(*mr)))
    return cases


# p is rounded to bf16 before P.V in kernel and twin alike; where their fp32
# scores differ in the last bit that rounding can flip by one bf16 step,
# which moves an output by up to p/l * 2^-8 * |v| (about 1e-4 at these shapes)
FP32_TOL = {"mlp_block": 1e-4, "cross_block_decode": 1e-4, "train_attention_fwd": 1e-3,
            "ln_matmul": 1e-4, "matmul_residual": 1e-4, "self_attend_decode": 1e-4}


def _case(name, what, got, want, kernel_fn, plain_fn) -> dict:
    torch.cuda.synchronize()
    err = max_err(got, want)
    fp32 = got.dtype == torch.float32
    tol = FP32_TOL[name] * max(1.0, float(want.float().abs().max())) if fp32 else bf16_tol(want)
    finite = bool(torch.isfinite(got).all())
    ms, plain_ms = timed_ms(kernel_fn), timed_ms(plain_fn)
    print(f"  {name} {what}: max_abs_err {err:.3e} (tol {tol:.3e}) "
          f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
    if not finite or not err <= tol:
        fail(f"{name} {what}: kernel disagrees with its plain twin "
             f"(max_abs_err {err}, tol {tol}, finite {finite})")
    return {"what": str(what), "max_abs_err": err, "tol": tol, "ms": ms, "plain_ms": plain_ms}


def phase_kernels() -> dict:
    print("kernels vs plain twins:")
    gen = torch.Generator().manual_seed(0)
    return {
        "cross_block_decode": check_cross(gen),
        "mlp_block": check_mlp(gen),
        "train_attention_fwd": check_attention(gen),
        **check_self_sub_block(gen),
    }


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------


DECODE_KERNELS = ("ln_matmul", "self_attend_decode", "matmul_residual", "cross_block_decode",
                  "mlp_block")


def _counters():
    """Every kernel wrapper of the path, whose ``launches`` count its kernel's
    launches, and decode_step, whose ``single_steps`` count S=1 steps."""
    from olmoasr_tpu_torch.models import whisper
    from olmoasr_tpu_torch.ops import attention, train_attention

    kernels = {name: getattr(attention, name) for name in DECODE_KERNELS}
    kernels["train_attention_fwd"] = train_attention.train_attention_fwd
    return kernels, whisper.decode_step


def _reset_counts():
    kernels, step = _counters()
    for fn in kernels.values():
        fn.launches = 0
    step.single_steps = 0


def _read_counts():
    kernels, step = _counters()
    return {name: fn.launches for name, fn in kernels.items()}, step.single_steps


def _check_decode_counts(label: str, counts: dict, steps: int, L: int) -> None:
    for name in DECODE_KERNELS:
        if counts[name] != L * steps:
            fail(f"{label}: {name} launched {counts[name]} times, expected {L} x {steps}")


def _single_token_steps(results, prompt_len: int, sample_len: int, every: int) -> int:
    """decode_step calls with one token per row: the greedy loop makes one per
    sampled token but the last, stopping at the first finished-flag check
    after every row ended; a one-token prompt's prefill is one more."""
    lengths = [len(r.tokens) for r in results]
    if any(n >= sample_len for n in lengths):  # a row that never sampled EOT
        steps = sample_len - 1
    else:
        last = max(lengths)  # the step at which the last row sampled EOT
        steps = min(-(-(last + 1) // every) * every - 1, sample_len - 1)
    return steps + int(prompt_len == 1)


def phase_slice() -> dict:
    from olmoasr_tpu_torch import build_model
    from olmoasr_tpu_torch.audio import N_SAMPLES, log_mel_spectrogram
    from olmoasr_tpu_torch.decoding import (
        EXIT_CHECK_EVERY, DecodingOptions, _resolve_prompt, get_tokenizer,
    )

    B = 64
    model = build_model("small.en", seed=0, device="cuda", dtype=torch.bfloat16)
    dims = model.dims
    audio = np.random.default_rng(0).standard_normal((B, N_SAMPLES)).astype(np.float32) * 0.1
    audio = torch.from_numpy(audio).cuda()
    log_mel_spectrogram(audio)  # warm-up: FFT plan and filterbank upload
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mel = log_mel_spectrogram(audio)
    torch.cuda.synchronize()
    print(f"slice: small.en B={B} log-mel {mel.shape} in {1e3 * (time.perf_counter() - t0):.2f} ms")
    if not bool(torch.isfinite(mel).all()):
        fail("log-mel is not finite")
    model.decode(mel, DecodingOptions(language="en", sample_len=4))  # warm-up, not counted

    out = {}
    for kv_quant in (False, True):
        options = DecodingOptions(language="en", kv_quant=kv_quant)
        prompt_len = len(_resolve_prompt(get_tokenizer(multilingual=False), options))
        sample_len = min(dims.n_text_ctx // 2, dims.n_text_ctx - prompt_len)
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = model.decode(mel, options)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, single_steps = _read_counts()
        steps = _single_token_steps(results, prompt_len, sample_len, EXIT_CHECK_EVERY)
        label = "int8" if kv_quant else "bf16"
        print(f"  {label} cross K/V: {steps} decode steps, wall {wall:.3f} s, "
              f"{B * 30 / wall:.1f} audio-s/s, launches {counts}")
        if len(results) != B:
            fail(f"{label}: {len(results)} results for {B} windows")
        for r in results:
            ok = (np.isfinite(r.avg_logprob) and 0.0 <= r.no_speech_prob <= 1.0
                  and all(0 <= t < dims.n_vocab for t in r.tokens)
                  and tuple(r.audio_features.shape) == (dims.n_audio_ctx, dims.n_audio_state)
                  and bool(torch.isfinite(r.audio_features).all()))
            if not ok:
                fail(f"{label}: malformed result {r.tokens[:8]} {r.avg_logprob} {r.no_speech_prob}")
        if single_steps != steps:
            fail(f"{label}: decode_step counted {single_steps} single-token steps, expected {steps}")
        _check_decode_counts(label, counts, steps, dims.n_text_layer)
        if counts["train_attention_fwd"] != dims.n_audio_layer:
            fail(f"{label}: encoder attention launched {counts['train_attention_fwd']} times")
        out[label] = {"steps": steps, "wall_s": wall, "audio_s_per_s": B * 30 / wall,
                      "launches": counts}
    return out


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------


def phase_long_form() -> dict:
    from olmoasr_tpu_torch import build_model, transcribe_many
    from olmoasr_tpu_torch.audio import SAMPLE_RATE
    from olmoasr_tpu_torch.transcribe import DEFAULT_TEMPERATURES

    n_files, best_of = 16, 5
    model = build_model("small.en", seed=0, device="cuda", dtype=torch.bfloat16)
    dims = model.dims
    rng = np.random.default_rng(2)
    seconds = rng.integers(40, 76, n_files)
    audios = [torch.from_numpy((rng.standard_normal(s * SAMPLE_RATE) * 0.1).astype(np.float32))
              for s in seconds]
    audio_s = float(seconds.sum())
    transcribe_many(model, audios[:1], batch_size=1, sample_len=4, temperature=(0.0, 1.0),
                    best_of=best_of)  # warm-up: sampling, groups, FFT plans; not counted

    windows_at = {}  # temperature -> windows decoded
    decode = model.decode
    calls = []

    def counting_decode(mel, options):
        windows_at[options.temperature] = windows_at.get(options.temperature, 0) + mel.shape[0]
        calls.append(options.temperature)
        return decode(mel, options)

    model.decode = counting_decode
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = transcribe_many(model, audios, batch_size=n_files, best_of=best_of)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, steps = _read_counts()
    del model.decode
    print(f"long-form: small.en bf16, {n_files} files, {audio_s:.0f} s of audio, "
          f"batch_size={n_files}, best_of={best_of}: wall {wall:.3f} s, "
          f"{audio_s / wall:.1f} audio-s/s, {steps} single-token steps")
    print(f"  windows per temperature {windows_at}; launches {counts}")
    ladder = sorted(windows_at)
    if ladder != list(DEFAULT_TEMPERATURES) or len(set(windows_at.values())) != 1:
        fail(f"long-form: the ladder did not run whole for every window: {windows_at}")
    _check_decode_counts("long-form", counts, steps, dims.n_text_layer)
    if counts["train_attention_fwd"] != dims.n_audio_layer * len(calls):  # one encode a call
        fail(f"long-form: encoder attention launched {counts['train_attention_fwd']} times "
             f"in {len(calls)} decode calls")
    if len(results) != n_files:
        fail(f"long-form: {len(results)} results for {n_files} files")
    for k, r in enumerate(results):
        segs = r.get("segments") if isinstance(r, dict) else None
        if set(r) != {"text", "segments", "language"} or not isinstance(r["text"], str) \
                or r["language"] != "en" or not segs:
            fail(f"long-form: file {k}: malformed result {str(r)[:200]}")
        seeks = [s["seek"] for s in segs]
        fields = ("start", "end", "avg_logprob", "no_speech_prob", "compression_ratio",
                  "temperature")
        if seeks != sorted(seeks) or not all(np.isfinite(s[f]) for s in segs for f in fields):
            fail(f"long-form: file {k}: seeks {seeks} or non-finite segment fields")
    return {"files": n_files, "audio_s": audio_s, "wall_s": wall,
            "audio_s_per_s": audio_s / wall, "single_steps": steps,
            "windows_per_temperature": windows_at, "decode_calls": len(calls),
            "launches": counts}


# ---------------------------------------------------------------------------
# phase 5
# ---------------------------------------------------------------------------

LOGIT_TOL = 2e-3  # fp32 on both sides; sums in another order, exp in another library


def phase_teacher_forced() -> float:
    from olmoasr_tpu_torch import build_model
    from olmoasr_tpu_torch.audio import N_SAMPLES, log_mel_spectrogram
    from olmoasr_tpu_torch.decoding import get_tokenizer
    from olmoasr_tpu_torch.models import whisper as model_mod

    B, G, steps = 2, 2, 8  # 2 windows, 2 token rows each over the shared cross cache
    rng = np.random.default_rng(1)
    audio = torch.from_numpy(rng.standard_normal((B, N_SAMPLES)).astype(np.float32) * 0.1)
    mel = log_mel_spectrogram(audio)
    sot = get_tokenizer(multilingual=False).sot
    tokens = torch.from_numpy(rng.integers(0, 50000, (B * G, steps))).long()
    logits = {}
    for device in ("cuda", "cpu"):
        model = build_model("small.en", seed=0, device=device, dtype=torch.float32)
        with torch.no_grad():
            feats = model_mod.encode_audio(model, mel.to(device))
            cache = model_mod.init_cache(model, feats, max_len=1 + steps, self_batch=B * G)
            first = torch.full((B * G, 1), sot, device=device)
            step_logits = [model_mod.decode_step(model, first, cache)]
            for i in range(steps - 1):
                step_logits.append(model_mod.decode_step(model, tokens[:, i:i + 1].to(device), cache))
        logits[device] = (feats.cpu(), torch.cat(step_logits, dim=1).cpu())
        del model, cache
    feat_err = max_err(logits["cuda"][0], logits["cpu"][0])
    err = max_err(logits["cuda"][1], logits["cpu"][1])
    scale = float(logits["cpu"][1].abs().max())
    print(f"teacher-forced fp32 B={B} windows x {G} rows, {steps} steps: audio features "
          f"max_abs_err {feat_err:.3e}, logits max_abs_err {err:.3e} (tol {LOGIT_TOL}, "
          f"max |logit| {scale:.2f})")
    if not err <= LOGIT_TOL:
        fail(f"teacher-forced logits disagree: {err} > {LOGIT_TOL}")
    return err


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device")
    try:
        import olmoasr_tpu_torch  # noqa: F401
    except ImportError as exc:
        fail(f"run from the root of a checkout of the repository: {exc}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_identity()
    cases = phase_kernels()
    short = phase_slice()
    long_form = phase_long_form()
    phase_teacher_forced()
    if "jax" in sys.modules:
        fail("jax was imported")

    sources = {
        "cross_block_decode": ("olmoasr_tpu_torch/csrc/cross_attention.cu",
                               "olmoasr_tpu/ops/attention.py:986"),
        "mlp_block": ("olmoasr_tpu_torch/csrc/linear.cu", "olmoasr_tpu/ops/attention.py:669"),
        "train_attention_fwd": ("olmoasr_tpu_torch/csrc/train_attention.cu",
                                "olmoasr_tpu/ops/train_attention.py:222"),
        "ln_matmul": ("olmoasr_tpu_torch/csrc/linear.cu", "olmoasr_tpu/ops/attention.py:354"),
        "matmul_residual": ("olmoasr_tpu_torch/csrc/linear.cu",
                            "olmoasr_tpu/ops/attention.py:412"),
        "self_attend_decode": ("olmoasr_tpu_torch/csrc/self_attention.cu",
                               "olmoasr_tpu/ops/attention.py:495"),
    }
    kernels = []
    for name, (source, replaces) in sources.items():
        main_case = cases[name][0]  # the main path's shape and dtype
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": long_form["launches"][name],
            "launches_short_form": {k: short[k]["launches"][name] for k in ("bf16", "int8")},
            "max_abs_err": max(c["max_abs_err"] for c in cases[name]),
            "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
            "cases": cases[name],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
