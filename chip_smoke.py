"""Smoke run of the PyTorch/CUDA port (``olmoasr_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases, one
printed line each (or a few):

1. identity and build: the card's name and power limit, torch and CUDA
   versions, the kernels compiled from ``olmoasr_tpu_torch/csrc``;
2. every kernel against its plain PyTorch twin at the slice's shapes, with
   the tolerance and the device times of both (CUDA events around replays of
   a CUDA graph of one call, median of 11 runs);
3. the slice: small.en at full width with seeded random weights, 64 windows
   of 30 s noise, GPU log-mel, greedy ``decode`` with bf16 and with int8
   cross K/V; wall time, audio-seconds per second, kernel launch counts;
4. a teacher-forced fp32 check at B=2: the same weights and tokens through
   the port on the GPU (kernels) and on the CPU (plain twins).

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


# p is rounded to bf16 before P.V in kernel and twin alike; where their fp32
# scores differ in the last bit that rounding can flip by one bf16 step,
# which moves an output by up to p/l * 2^-8 * |v| (about 1e-4 at these shapes)
FP32_TOL = {"mlp_block": 1e-4, "cross_block_decode": 1e-4, "train_attention_fwd": 1e-3}


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
    }


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------


def _counters():
    from olmoasr_tpu_torch.ops import attention, train_attention

    return {
        "cross_block_decode": attention.cross_block_decode,
        "mlp_block": attention.mlp_block,
        "train_attention_fwd": train_attention.train_attention_fwd,
    }


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

    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    out = {}
    for kv_quant in (False, True):
        options = DecodingOptions(language="en", kv_quant=kv_quant)
        prompt_len = len(_resolve_prompt(get_tokenizer(multilingual=False), options))
        sample_len = min(dims.n_text_ctx // 2, dims.n_text_ctx - prompt_len)
        before = {name: fn.launches for name, fn in counters.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = model.decode(mel, options)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {name: fn.launches - before[name] for name, fn in counters.items()}
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
        L = dims.n_text_layer
        if counts["cross_block_decode"] != L * steps or counts["mlp_block"] != L * steps:
            fail(f"{label}: decode kernels launched {counts}, expected {L} x {steps}")
        if counts["train_attention_fwd"] != dims.n_audio_layer:
            fail(f"{label}: encoder attention launched {counts['train_attention_fwd']} times")
        out[label] = {"steps": steps, "wall_s": wall, "audio_s_per_s": B * 30 / wall}
    out["launches"] = {name: fn.launches for name, fn in counters.items()}
    return out


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------

LOGIT_TOL = 2e-3  # fp32 on both sides; sums in another order, exp in another library


def phase_teacher_forced() -> float:
    from olmoasr_tpu_torch import build_model
    from olmoasr_tpu_torch.audio import N_SAMPLES, log_mel_spectrogram
    from olmoasr_tpu_torch.decoding import get_tokenizer
    from olmoasr_tpu_torch.models import whisper as model_mod

    B, steps = 2, 8
    rng = np.random.default_rng(1)
    audio = torch.from_numpy(rng.standard_normal((B, N_SAMPLES)).astype(np.float32) * 0.1)
    mel = log_mel_spectrogram(audio)
    sot = get_tokenizer(multilingual=False).sot
    tokens = torch.from_numpy(rng.integers(0, 50000, (B, steps))).long()
    logits = {}
    for device in ("cuda", "cpu"):
        model = build_model("small.en", seed=0, device=device, dtype=torch.float32)
        with torch.no_grad():
            feats = model_mod.encode_audio(model, mel.to(device))
            cache = model_mod.init_cache(model, feats, max_len=1 + steps)
            step_logits = [model_mod.decode_step(model, torch.full((B, 1), sot, device=device), cache)]
            for i in range(steps - 1):
                step_logits.append(model_mod.decode_step(model, tokens[:, i:i + 1].to(device), cache))
        logits[device] = (feats.cpu(), torch.cat(step_logits, dim=1).cpu())
        del model, cache
    feat_err = max_err(logits["cuda"][0], logits["cpu"][0])
    err = max_err(logits["cuda"][1], logits["cpu"][1])
    scale = float(logits["cpu"][1].abs().max())
    print(f"teacher-forced fp32 B={B}, {steps} steps: audio features max_abs_err {feat_err:.3e}, "
          f"logits max_abs_err {err:.3e} (tol {LOGIT_TOL}, max |logit| {scale:.2f})")
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
    sliced = phase_slice()
    phase_teacher_forced()
    if "jax" in sys.modules:
        fail("jax was imported")

    sources = {
        "cross_block_decode": ("olmoasr_tpu_torch/csrc/cross_attention.cu",
                               "olmoasr_tpu/ops/attention.py:986"),
        "mlp_block": ("olmoasr_tpu_torch/csrc/linear.cu", "olmoasr_tpu/ops/attention.py:669"),
        "train_attention_fwd": ("olmoasr_tpu_torch/csrc/train_attention.cu",
                                "olmoasr_tpu/ops/train_attention.py:222"),
    }
    kernels = []
    for name, (source, replaces) in sources.items():
        main_case = cases[name][0]  # the main path's shape and dtype
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sliced["launches"][name],
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
