"""Smoke run of the PyTorch/CUDA port (``olmoasr_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases, one
printed line each (or a few):

1. identity and build: the card's name and power limit, torch and CUDA
   versions, the kernels compiled from ``olmoasr_tpu_torch/csrc``;
2. every kernel against its plain PyTorch twin at the slices' shapes, with
   the tolerance and the device times of both (CUDA events around replays of
   a CUDA graph of one call, median of 11 runs): the attention forward and
   backward at the three training shapes (the backward launched twice and
   held bit-equal), the flash route's forward and
   backward (``flash_mha_fwd`` / ``flash_mha_bwd``) at the same shapes, the
   beam-ancestry
   ``self_attend_decode``, the fused ``layer_block_decode`` in both its
   modes (beside the time of the kernels it replaces), the int8 q.K
   ``cross_block_decode`` (at 64 rows, and at 5 rows a window over 16 and
   over 32 windows; its bf16 call held to four device kernels, the kernel
   nodes of a CUDA graph capture of the call), ``self_attend_decode`` over
   int8 rings (one device kernel a call) and
   ``cross_attend_decode`` (the attention kernels beside
   ``scaled_dot_product_attention``, for ``cross_attend_decode`` under both
   timers) included, ``self_attend_decode`` up to offset 447 of a
   448-position ring and, as a yardstick the port never calls, beside
   ``scaled_dot_product_attention`` over the ring's first offset + 1
   positions, the int8 q.K cases also on inputs where the int8 and the exact
   q.K products land far apart, so that a kernel computing the wrong one
   fails; ``mlp_block`` and ``matmul_residual`` in bf16 at the decode
   paths' rows (64 greedy, 160 beam, 80 long-form, 5), each beside
   cuBLAS's products alone (``F.linear``) as a yardstick the port never
   calls, and whether ``mlp_block``'s graph keeps its launches'
   programmatic dependence; then the probes of the training attention
   (``olmoasr_tpu_torch.perf.probe_pack``, ``probe_pipe``, ``probe_bwd``:
   every variant once at medium.en's training shape, few replays, each that
   computes attention held against the twin);
3. the short-form slice: small.en at full width with seeded random weights,
   64 windows of 30 s noise, GPU log-mel, greedy ``decode`` with bf16 and
   with int8 cross K/V (the fused self + cross launch); the encoder of the
   64 windows on the flash route against the kernel route; then beam search, 32
   windows x ``beam_size=5``, in bf16 and int8; for each the host time of
   one step against its summed kernel time (``torch.profiler``), wall time,
   audio-seconds per second, kernel launch counts;
4. the long-form slice at the CLI's defaults: small.en in bf16, 16 files of
   40-75 s of seeded noise through ``transcribe_many(batch_size=16)`` with
   ``beam_size=5`` at temperature 0, the default ladder and thresholds and
   best_of=5 above it (random weights fail the gates, so every window climbs
   the whole ladder); wall time, audio-seconds per second, windows per
   temperature, single-token steps, every kernel's launches, the results'
   schema; the files stream (``_StreamedMelGroup``: f32 chunks, the noise
   is not int16-exact), and every window a round gathers is bit-equal to
   the window of its file's whole-file log-mel; the blocking prefix (the
   first round's windows ready) streamed against the per-file log-mels;
   the stale-max guard: three int16-exact files at fp32, t=0, one quiet
   then loud, which must run again through the per-file path and equal
   ``transcribe`` of it alone; then 4 of its files again with ``word_timestamps=True`` (beam 5
   at t=0) and 2 of those also with ``hallucination_silence_threshold=2.0`` (the vocabulary's
   text rows cut to the byte tokens, which alone the offline tokenizer
   decodes, so that segments have words): words per file, the alignment's
   wall against the decode's, its attention launches, every word inside its
   window; then the server's default traffic in this process: the port's
   ``BatchingService`` with int8 cross K/V and no beam, 8 requests at once
   (greedy at t=0, one sample per window above, every step fused); then the
   decode step's other kernel routes, each as the JAX step's flag matrix
   runs it (a prefill, then 224 single-token steps with argmax, small.en
   bf16): over int8 self rings and an int8 cross cache (64 windows, and 32
   windows x 5 rows as best_of decodes them) beside bf16 rings, then over an
   int8 cross cache along ``route`` = split, layer, attend and auto; each
   with its wall, its launches and a profiled step;
5. a teacher-forced fp32 check: the same weights and tokens through the
   port on the GPU (kernels) and on the CPU (plain twins), 2 windows with 2
   token rows each (the shared cross cache), then 2 windows over an int8
   cross cache (the fused launch); then over int8 self rings (2 rows a
   window, the CPU given the card's rings before each step), and along the
   routes layer and attend; ``timing.find_alignment`` at fp32 on the card and
   on the CPU for one window (equal words and times); language detection on
   a seeded multilingual small.en (``detect_language`` at 1 and 8 windows,
   the same language ids as the CPU's at fp32, then ``transcribe_many`` with
   ``language=None``);
6. the training slice: small.en at full width and depth through
   ``train_loop.main`` on 256 synthetic samples (micro batch 16, effective
   32, remat), 6 steps and a resumed seventh; the attention forward and
   backward launches of every step, the parameters after steps 1 (lr 0) and
   2, audio-seconds and tokens a second over steps 2-5 with the loader's
   waits, each step's wall and the loader's work inside it, one step with
   the loader held back, peak memory, the kernels' device time
   (``torch.profiler``, the resumed step) and the step's FLOPs against 989
   TFLOP/s; then the same with ``device_mel=True`` (the loader ships int16
   PCM, the step computes the log-mel on the card; 3 steps and a resumed
   fourth, beside the host-mel run, one micro-batch's log-mel against the
   host's and step 1's loss against the host-mel run's); then the same
   through ``train_loop.main(attention="flash")``
   (3 steps and a resumed fourth, the flash kernels' 144 forward and 72
   backward launches a step); then an fp32 ``loss_fn`` and backward of a
   narrow model on the card against the CPU twins, on both routes;
7. the entry points: the seeded small.en written as a reference ``.pt``;
   ``load_model`` of a released name whose link is a ``file://`` URL of it
   (downloaded once, then reused), ``gen_inf_ckpt`` of it, the native BPE
   built here and held to the Python tokenizer (the HF export is not run:
   the machine has no ``transformers``); the command line (``python -m olmoasr_tpu_torch.transcribe``) on two
   files with ``--word_timestamps True --highlight_words True
   --max_line_width 40``, and the HTTP server (``python -m
   olmoasr_tpu_torch.serve``, int8 cross K/V and ``beam_size=5``) answering
   4 concurrent requests, one with ``word_timestamps``, each in its own
   process; then decoding split across ranks (``decoding.set_infer_mesh``):
   the short-form slice's greedy bf16 and int8, its beam search and fp32
   greedy and beam on two ranks of the one card over gloo through torchrun,
   against one process (each rank's windows equal to one process's decode
   of them; at fp32 the whole batch's tokens), each rank's wall and the
   gather's; the transcribe CLI at fp32 under torchrun, world 1 over NCCL
   and world 2 over gloo, against one process (rank 0's outputs); the HTTP
   server under torchrun the same way (rank 0 batches and broadcasts, every
   rank decodes its share), 8 concurrent requests at fp32 to each, rank 0's
   answers against one process's, then the default traffic at world 2, each
   rank's ``main`` returning on an interrupt;
8. evaluation: 96 utterances of 3-20 s seeded noise in a LibriSpeech-format
   tree through ``eval.harness.short_form_eval`` at B=64 on small.en (its
   vocabulary cut to the byte tokens), bf16 and int8 cross K/V, each
   hypothesis held to a direct ``decode`` of the same batch and the WER to
   the written per-sample CSV, the wall split into decode, the card's
   log-mel and the host's parts; ``long_form_eval`` (beam 5, best_of 5) of
   35 s + 50 s; the harness's command line in its own process on 16 of
   them, equal to the same run here, and beside it the parity harness
   (``eval.parity --allow_fallback_tokenizer``) on the same 16; fp32
   ``training.validate`` on the card
   against the CPU, small.en's bf16 ``validate``; ``train_loop.main``'s
   sync eval with the profiler's trace of a step (the row 3 and row 9
   kernels named in it), async eval (the harness spawned on the card), and
   the cast-moment Adam (bf16 moments), its step on the card against the
   CPU twin's from the same gradients.

Each slice sets every launch count to 0 before it runs and reads them after;
the ``launches`` of the kernels line are those of the path that runs the
kernel: the long-form slice's, the server traffic's for the fused launch,
the training step's for the attention backward, the flash training step's
for the flash forward and backward, the int8-ring loop's for
the int8 self pass and the routes' for the whole-layer launch and the
standalone cross attention (``launches_eval``: the evaluation's short-form
bf16, int8 and long-form runs; ``launches_decode_ranks``: rank 0's greedy
bf16 decode across two ranks; ``launches_serve_ranks``: rank 0's of the
server across two ranks, its fp32 requests and its default traffic). Every
kernel in that line
carries its bound (the least time the card could take for its main case:
bytes over 3.35 TB/s or operations over the dtype's peak, whichever is
larger) and ``library_ms``, the time of one PyTorch call computing the same
function where there is one (``scaled_dot_product_attention`` for the
attention forward and backward, both routes, and for
``cross_attend_decode``), else null.

``python3 chip_smoke.py --ab TREE`` instead compares the kernels of another
checkout (for example the parent commit, unpacked with ``git archive`` into a
directory that ``.gitignore`` lists) with this one's on chosen cases (the
decode kernels, and the training attention's forward and backward at the
training shapes), in the order TREE, this, this, TREE, each in its own
process on the same inputs, then two profiled greedy steps (over an int8
cross cache, and along ``route="split"`` over a bf16 one) in four
processes a tree, alternating; see :func:`kernel_ab`.

The next-to-last line is ``{"kernels": [...]}``, the last
``{"ok": true, "device": {...}}``. Any failed phase exits non-zero before
either is printed; so does a machine without a CUDA device.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import json
import os
import re
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
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
SPIN_CYCLES = 200_000  # about 0.1 ms of the card's clock: longer than the host takes to queue a replay


def exact_fp32() -> None:
    """fp32 products in fp32, TF32 off in cuBLAS and cuDNN (whose
    convolutions use it by default), in this process: every phase runs so,
    and each rank or CLI process that a phase compares with this one."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def timed_ms(fn, spin: bool = False) -> float:
    """Median device time of one call of ``fn`` in ms over RUNS runs: the call
    is captured once in a CUDA graph and the replays are timed with CUDA
    events, so the host's launch cost (which bounds an eager call at these
    sizes) stays out of the kernel's time. The time still holds the host's
    submission of the replay (4-12 us at decode sizes). ``spin``: each
    replay is queued behind a spin on the card (``torch.cuda._sleep``), which
    leaves that out too; ``--ab`` reports both."""
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
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    del graph
    return statistics.median(times)


def host_us(fn, calls: int = 100, batches: int = 7) -> float:
    """Median host time of one eager call of ``fn`` in us over ``batches``
    batches of ``calls`` calls; the card is waited on between batches only
    (the calls queue far less work than the card takes at once)."""
    fn()
    torch.cuda.synchronize()
    means = []
    for _ in range(batches):
        start = time.perf_counter()
        for _ in range(calls):
            fn()
        means.append((time.perf_counter() - start) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(means)


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


# the decode paths' rows for the skinny projections (rows 2 and 6): greedy
# (64 windows), best_of on the long-form slice (16 files x 5), beam search
# (32 windows x 5), and a count that is no multiple of 16
PROJ_ROWS = (64, 160, 80, 5)


def _cublas_ms(*products) -> float:
    """The yardstick beside rows 2 and 6: cuBLAS's products alone
    (``F.linear(a, w, b)`` for each (a, w, b), one after the other), which
    the port never calls: they leave out the LayerNorm, the GELU and the
    residual."""
    import torch.nn.functional as F

    return timed_ms(lambda: [F.linear(a, w, b) for a, w, b in products])


def check_mlp(gen) -> list:
    from olmoasr_tpu_torch.ops.attention import _ln_f32, mlp_block, mlp_block_plain

    D, Fd = 768, 3072
    cases = []
    for dtype, rows in ((torch.bfloat16, PROJ_ROWS), (torch.float32, (64,))):
        ln = ((1 + 0.1 * torch.randn(D, generator=gen)).to("cuda", dtype),
              (0.1 * torch.randn(D, generator=gen)).to("cuda", dtype))
        w = (_weights(gen, Fd, D, fan_in=D, dtype=dtype),
             (0.02 * torch.randn(Fd, generator=gen)).to("cuda", dtype),
             _weights(gen, D, Fd, fan_in=Fd, dtype=dtype),
             (0.02 * torch.randn(D, generator=gen)).to("cuda", dtype))
        for B in rows:
            args = (torch.randn(B, 1, D, generator=gen).to("cuda", dtype), *ln, *w)
            got, want = mlp_block(*args), mlp_block_plain(*args)
            h = _ln_f32(args[0], *ln).to(dtype)[:, 0]
            u = want.new_empty(B, Fd)
            cases.append(_case("mlp_block", (dtype, f"B={B}"), got, want,
                               lambda: mlp_block(*args), lambda: mlp_block_plain(*args),
                               (nbytes(*args, got), 4 * B * D * Fd, dtype),
                               yardstick=lambda: _cublas_ms((h, w[0], w[1]), (u, w[2], w[3]))))
            if dtype == torch.bfloat16 and B == rows[0]:
                # the times above count the launches' programmatic dependence
                # only if graph capture keeps it
                from olmoasr_tpu_torch.perf.probe_proj import programmatic_edges

                edges = cases[0]["programmatic_edges"] = programmatic_edges(lambda: mlp_block(*args))
                print(f"  mlp_block: its graph keeps {edges} programmatic-dependency edges "
                      f"(2: W1 on the LayerNorm, W2 on W1)")
                if edges != 2:
                    fail(f"mlp_block: graph capture kept {edges} programmatic edges, not 2")
    return cases


def _cross_bound(args, got, kv_group=1):
    """(bytes, operations, dtype) of cross_block_decode: LN, the q and out
    projections of every token row, and q.K and P.V over its window's keys."""
    x, g, b, wq, bq, wo, bo, ck, cv, ks, vs, _ = args
    R, D, T = x.shape[0], x.shape[-1], ck.shape[1]
    scales = (ks, vs) if ck.dtype == torch.int8 else ()
    return (nbytes(x, g, b, wq, bq, wo, bo, ck, cv, *scales, got), 4 * R * D * D + 4 * R * T * D,
            x.dtype)


def check_cross(gen) -> list:
    from olmoasr_tpu_torch.models.whisper import _quantize_rows
    from olmoasr_tpu_torch.ops.attention import (
        _ln_f32, cross_block_decode, cross_block_decode_plain,
    )

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
        # beside the bf16 ones, cuBLAS's two projections alone (q's, then
        # the output's over rows of the same shape)
        h = _ln_f32(x, *w[:2]).to(act)[:, 0]
        cases.append(_case("cross_block_decode", (act, kv), got, want,
                           lambda: cross_block_decode(*args),
                           lambda: cross_block_decode_plain(*args), _cross_bound(args, got),
                           yardstick=(lambda: _cublas_ms((h, w[2], w[3]), (h, w[4], w[5])))
                           if act == torch.bfloat16 else None))
        if kv == torch.bfloat16:  # LayerNorm, Wq, the attention, Wo: no split pass
            cases[-1]["device_kernels"] = _check_device_kernels(
                "cross_block_decode bf16", lambda: cross_block_decode(*args), 4)
    # best_of samples and beams: 5 token rows over each of 16 cache rows (the
    # long-form slice's files) and of 32 (beam search's windows), in bf16 and
    # over the int8 cache of a served request (int8 q.K)
    G = 5
    for Bc in (16, 32):
        x = torch.randn(Bc * G, 1, D, generator=gen).to("cuda", torch.bfloat16)
        ck, cv = (torch.randn(Bc, T, D, generator=gen).to("cuda") for _ in range(2))
        ones = torch.ones(Bc, 1, T, device="cuda")
        (ck8, ks), (cv8, vs) = _quantize_rows(ck), _quantize_rows(cv)
        for kv, cache in ((torch.bfloat16, (ck.to(torch.bfloat16), cv.to(torch.bfloat16), ones,
                                            ones)),
                          (torch.int8, (ck8, cv8, ks[:, None].contiguous(),
                                        vs[:, None].contiguous()))):
            args = (x, *[t.to(torch.bfloat16) for t in w], *cache, H)
            kw = dict(kv_group=G)
            got, want = cross_block_decode(*args, **kw), cross_block_decode_plain(*args, **kw)
            what = (torch.bfloat16, kv, f"kv_group={G}, {Bc * G} rows over {Bc}")
            cases.append(_case("cross_block_decode", what, got, want,
                               lambda: cross_block_decode(*args, **kw),
                               lambda: cross_block_decode_plain(*args, **kw),
                               _cross_bound(args, got, G)))
        del ck, cv, ck8, cv8
    return cases


def outlier_q_case(gen, B, T, D, H, G=1):
    """Cross sub-block inputs on which the int8 q.K product and the exact one
    land far apart: wq = 0, so q = bq, one lane of 100 per head and +-0.35 on
    the others, which round to 0 against the head's int8 scale; lane 0 of
    every head holds 3.0 in every key (its row's largest magnitude, so it
    quantizes exactly): the int8 logits are equal and the weights uniform.
    The exact product also sees the small lanes, which key T // 3 lines up
    (2.9 * their signs), so it takes most of the weight; its value is 3.0 in
    every lane. G query rows per cache row."""
    from olmoasr_tpu_torch.models.whisper import _quantize_rows

    dh = D // H
    sign = torch.where(torch.randn(D, generator=gen) >= 0, 1.0, -1.0)
    bq = 0.35 * sign
    bq[::dh] = 100.0
    k = torch.rand(B, T, D, generator=gen) * 2 - 1
    k[:, T // 3] = 2.9 * sign
    k[:, :, ::dh] = 3.0
    v = torch.rand(B, T, D, generator=gen) * 2 - 1
    v[:, T // 3] = 3.0
    (ck, ks), (cv, vs) = _quantize_rows(k.cuda()), _quantize_rows(v.cuda())
    params = [torch.ones(D), torch.zeros(D), torch.zeros(D, D), bq,
              torch.randn(D, D, generator=gen) * D ** -0.5, torch.zeros(D)]
    bf = lambda t: t.to("cuda", torch.bfloat16)
    return (bf(torch.randn(B * G, 1, D, generator=gen)), *map(bf, params), ck, cv,
            ks[:, None].contiguous(), vs[:, None].contiguous(), H)


def check_int8_qk(gen) -> list:
    """The int8 q.K product on the card: on ``outlier_q_case`` the kernel
    must sit within tolerance of the int8 twin and far outside it against the
    exact-q twin (a kernel that skipped the q rounding, the integer dot or
    the head's scale lands near the exact one)."""
    from olmoasr_tpu_torch.ops.attention import cross_block_decode, cross_block_decode_plain

    cases = []
    for B, G in ((64, 1), (16, 5)):
        args, kw = outlier_q_case(gen, B, 1500, 768, 12, G), dict(kv_group=G)
        got = cross_block_decode(*args, **kw)
        exact = cross_block_decode_plain(*args, **kw, quantize_q=False)
        case = _case("cross_block_decode", (torch.bfloat16, torch.int8,
                                            f"outlier q, kv_group={G}, {B * G} rows"),
                     got, cross_block_decode_plain(*args, **kw),
                     lambda: cross_block_decode(*args, **kw),
                     lambda: cross_block_decode_plain(*args, **kw), _cross_bound(args, got, G))
        case["exact_q_err"] = max_err(got, exact)
        print(f"    against the exact-q twin: max_abs_err {case['exact_q_err']:.3e} "
              f"(must exceed {EXACT_Q_MARGIN} x tol)")
        if not case["exact_q_err"] > EXACT_Q_MARGIN * case["tol"]:
            fail(f"int8 q.K, kv_group={G}: the kernel is {case['exact_q_err']} from the exact-q "
                 f"twin, within {EXACT_Q_MARGIN} x tol {case['tol']}: it did not take the int8 product")
        cases.append(case)
    return cases


EXACT_Q_MARGIN = 8


def layer_block_args(gen, dtype, B=64, L=12, C=225, T=1500, D=768, H=12):
    """layer_block_decode's inputs but offset and layer: x, the self and
    cross sub-blocks' parameters, the rings and an int8 cross cache."""
    from olmoasr_tpu_torch.models.whisper import _quantize_rows

    r = lambda *s, scale=1.0: (torch.randn(*s, generator=gen) * scale).to("cuda", dtype)
    sub = lambda n: [1 + r(D, scale=0.1), r(D, scale=0.1), _weights(gen, n * D, D, fan_in=D,
                                                                   dtype=dtype),
                     r(n * D, scale=0.02), _weights(gen, D, D, fan_in=D, dtype=dtype),
                     r(D, scale=0.02)]
    rings = [r(L, B, C, D), r(L, B, C, D)]
    (ck, ks), (cv, vs) = (_quantize_rows(torch.randn(B, T, D, generator=gen).cuda())
                          for _ in range(2))
    return (r(B, 1, D), *sub(3), *sub(1), *rings, ck, cv, ks[:, None].contiguous(),
            vs[:, None].contiguous())


def _chain(args, offset, layer, H):
    """The split kernels that layer_block_decode replaces, on its inputs:
    ln_matmul, self_attend_decode, matmul_residual, cross_block_decode."""
    from olmoasr_tpu_torch.ops import attention as A

    x, g1, b1, wqkv, bqkv, wo1, bo1, g2, b2, wq, bq, wo2, bo2, kr, vr, ck, cv, ks, vs = args
    D = x.shape[-1]
    qkv = A.ln_matmul(x, g1, b1, wqkv, bqkv)
    a = A.self_attend_decode(qkv[..., :D], kr, vr, qkv[..., D:2 * D], qkv[..., 2 * D:], offset,
                             layer, n_head=H)
    x = A.matmul_residual(a, x, wo1, bo1)
    return A.cross_block_decode(x, g2, b2, wq, bq, wo2, bo2, ck, cv, ks, vs, H)


def _layer_bound(args, got, offset):
    """(bytes, operations, dtype) of layer_block_decode: the self and cross
    sub-blocks' weights, one layer's rings up to ``offset``, the int8 cross
    cache and its scales; the projections and both attentions."""
    x, *w, kr, vr, ck, cv, ks, vs = args
    B, D, T = x.shape[0], x.shape[-1], ck.shape[1]
    rings = 2 * B * offset * D * kr.element_size()
    ops = 2 * B * D * D * 6 + 4 * B * (offset + 1) * D + 4 * B * T * D
    return nbytes(x, *w, ck, cv, ks, vs, got) + rings, ops, x.dtype


def check_layer_block(gen) -> list:
    """The fused self + cross sub-blocks at the greedy int8 step's shapes
    (B=64, rings L=12 C=225, layer 7, T=1500), out and the new key and value
    held to the twin; beside them, the time of the split kernels' chain that
    the fused launch replaces."""
    from olmoasr_tpu_torch.ops.attention import layer_block_decode, layer_block_decode_plain

    H, layer, cases = 12, 7, []
    for dtype, offsets in ((torch.bfloat16, (224, 100, 1)), (torch.float32, (100,))):
        args = layer_block_args(gen, dtype)
        for offset in offsets:
            full = (*args, offset, layer)
            got = torch.cat([t.flatten() for t in layer_block_decode(*full, n_head=H)])
            want = torch.cat([t.flatten() for t in layer_block_decode_plain(*full, n_head=H)])
            case = _case("layer_block_decode", (dtype, f"int8 cross, B=64 T=1500, rings L=12 "
                                                       f"C=225 layer {layer} offset {offset}"),
                         got, want, lambda: layer_block_decode(*full, n_head=H),
                         lambda: layer_block_decode_plain(*full, n_head=H),
                         _layer_bound(args, got, offset))
            case["chain_ms"] = timed_ms(lambda: _chain(args, offset, layer, H))
            print(f"    the split kernels' chain at the same shapes: {case['chain_ms']:.4f} ms")
            cases.append(case)
        del args
    return cases


def _mlp_args(gen, dtype, D=768, Fd=3072):
    """The MLP's (ln_g, ln_b, w1, b1, w2, b2) of one layer."""
    return [(1 + 0.1 * torch.randn(D, generator=gen)).to("cuda", dtype),
            (0.1 * torch.randn(D, generator=gen)).to("cuda", dtype),
            _weights(gen, Fd, D, fan_in=D, dtype=dtype),
            (0.02 * torch.randn(Fd, generator=gen)).to("cuda", dtype),
            _weights(gen, D, Fd, fan_in=Fd, dtype=dtype),
            (0.02 * torch.randn(D, generator=gen)).to("cuda", dtype)]


def check_layer_block_mlp(gen) -> list:
    """The whole layer in one launch (``include_mlp=True``) at the same
    shapes as :func:`check_layer_block`: out and the new key and value held
    to the twin; beside them, the time of the "sc" launch and ``mlp_block``
    that it replaces."""
    from olmoasr_tpu_torch.ops.attention import (
        layer_block_decode, layer_block_decode_plain, mlp_block,
    )

    H, layer, cases = 12, 7, []
    for dtype, offsets in ((torch.bfloat16, (224, 1)), (torch.float32, (100,))):
        args = layer_block_args(gen, dtype)
        mlp = _mlp_args(gen, dtype)
        kw = dict(n_head=H, include_mlp=True, mlp=mlp)
        for offset in offsets:
            full = (*args, offset, layer)
            got = torch.cat([t.flatten() for t in layer_block_decode(*full, **kw)])
            want = torch.cat([t.flatten() for t in layer_block_decode_plain(*full, **kw)])
            mlp_bytes = nbytes(*mlp)
            moved, ops, dt = _layer_bound(args, got, offset)
            case = _case("layer_block_decode_mlp",
                         (dtype, f"whole layer, int8 cross, B=64 T=1500, rings L=12 C=225 "
                                 f"layer {layer} offset {offset}"),
                         got, want, lambda: layer_block_decode(*full, **kw),
                         lambda: layer_block_decode_plain(*full, **kw),
                         (moved + mlp_bytes, ops + 4 * 64 * 768 * 3072, dt))
            case["sc_mlp_ms"] = timed_ms(lambda: mlp_block(
                layer_block_decode(*full, n_head=H)[0], *mlp))
            print(f"    the \"sc\" launch and mlp_block at the same shapes: "
                  f"{case['sc_mlp_ms']:.4f} ms")
            cases.append(case)
        del args
    return cases


def outlier_self_case(gen, B, C, D, H, L=12):
    """self_attend_decode inputs over int8 rings on which the int8 q.K
    product and the exact one land far apart, built as
    :func:`outlier_q_case`: q one lane of 100 per head and +-0.35 on the
    others; lane 0 of every head 3.0 in every ring key, so the int8 logits
    are equal; position C // 3 lines up with the small lanes (2.9 * their
    signs) and holds 3.0 in every value lane. This step's key is zero.
    Returns (q, k_ring, v_ring, k_new, v_new) and the rings' scales."""
    from olmoasr_tpu_torch.models.whisper import _quantize_rows

    dh = D // H
    sign = torch.where(torch.randn(D, generator=gen) >= 0, 1.0, -1.0)
    q = (0.35 * sign).expand(B, 1, D).clone()
    q[..., ::dh] = 100.0
    k = torch.rand(L, B, C, D, generator=gen) * 2 - 1
    k[:, :, C // 3] = 2.9 * sign
    k[..., ::dh] = 3.0
    v = torch.rand(L, B, C, D, generator=gen) * 2 - 1
    v[:, :, C // 3] = 3.0
    (kq, ks), (vq, vs) = _quantize_rows(k.cuda()), _quantize_rows(v.cuda())
    bf = lambda t: t.to("cuda", torch.bfloat16)
    return ((bf(q), kq, vq, bf(torch.zeros(B, 1, D)), bf(torch.rand(B, 1, D, generator=gen))),
            dict(k_scale=ks[:, :, None].contiguous(), v_scale=vs[:, :, None].contiguous()))


def check_self_q8(gen) -> list:
    """``self_attend_decode`` over int8 rings at the int8-ring step's shapes
    (B=64, rings L=12 C=225, layer 7), q, k_new and v_new as row views of a
    fused projection: bf16 (the int8 q.K product) at offsets 224 and 100,
    fp32 (the exact one) at 100; then the outlier case, where the kernel
    must sit within tolerance of the int8 twin and far outside it against
    the exact-q twin."""
    from olmoasr_tpu_torch.models.whisper import _quantize_rows
    from olmoasr_tpu_torch.ops.attention import self_attend_decode, self_attend_decode_plain

    B, D, H, L, C, layer = 64, 768, 12, 12, 225, 7
    cases = []
    for dtype, offsets in ((torch.bfloat16, (224, 100)), (torch.float32, (100,))):
        qkv = torch.randn(B, 1, 3 * D, generator=gen).to("cuda", dtype)
        q, kn, vn = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
        (kq, ks), (vq, vs) = (_quantize_rows(torch.randn(L, B, C, D, generator=gen).cuda())
                              for _ in range(2))
        kw = dict(n_head=H, k_scale=ks[:, :, None].contiguous(),
                  v_scale=vs[:, :, None].contiguous())
        for offset in offsets:
            sa = (q, kq, vq, kn, vn, offset, layer)
            got = self_attend_decode(*sa, **kw)
            cases.append(_case(
                "self_attend_decode_q8",
                (dtype, f"int8 rings L={L} B={B} C={C} layer {layer} offset {offset}"),
                got, self_attend_decode_plain(*sa, **kw), lambda: self_attend_decode(*sa, **kw),
                lambda: self_attend_decode_plain(*sa, **kw), _self_bound(sa, got)))
            if len(cases) == 1:  # one launch of the single-pass core, no combine
                cases[0]["device_kernels"] = _check_device_kernels(
                    "self_attend_decode over int8 rings", lambda: self_attend_decode(*sa, **kw), 1)
        del kq, vq
    (q, kq, vq, kn, vn), scales = outlier_self_case(gen, B, C, D, H)
    sa, kw = (q, kq, vq, kn, vn, C - 1, layer), dict(n_head=H, **scales)
    got = self_attend_decode(*sa, **kw)
    exact = self_attend_decode_plain(*sa, **kw, quantize_q=False)
    what = (torch.bfloat16, f"outlier q, int8 rings, offset {C - 1}")
    case = _case("self_attend_decode_q8", what, got, self_attend_decode_plain(*sa, **kw),
                 lambda: self_attend_decode(*sa, **kw),
                 lambda: self_attend_decode_plain(*sa, **kw), _self_bound(sa, got))
    case["exact_q_err"] = max_err(got, exact)
    print(f"    against the exact-q twin: max_abs_err {case['exact_q_err']:.3e} "
          f"(must exceed {EXACT_Q_MARGIN} x tol)")
    if not case["exact_q_err"] > EXACT_Q_MARGIN * case["tol"]:
        fail(f"int8 rings: the kernel is {case['exact_q_err']} from the exact-q twin, within "
             f"{EXACT_Q_MARGIN} x tol {case['tol']}: it did not take the int8 product")
    cases.append(case)
    return cases


def check_cross_attend(gen) -> list:
    """``cross_attend_decode`` at the step's shapes (B=64, T=1500): bf16 over
    bf16 and over int8 K/V, fp32; beside the first, torch's
    scaled_dot_product_attention on the same q, K and V (it keeps P fp32)."""
    import torch.nn.functional as F

    from olmoasr_tpu_torch.models.whisper import _quantize_rows
    from olmoasr_tpu_torch.ops.attention import (
        _q_scale, cross_attend_decode, cross_attend_decode_plain,
    )

    B, T, D, H = 64, 1500, 768, 12
    cases = []
    for act, kv in ((torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.int8),
                    (torch.float32, torch.float32)):
        q = torch.randn(B, 1, D, generator=gen).to("cuda", act)
        k, v = (torch.randn(B, T, D, generator=gen).to("cuda") for _ in range(2))
        scales = (None, None)
        if kv == torch.int8:
            (k, ks), (v, vs) = _quantize_rows(k), _quantize_rows(v)
            scales = (ks[:, None].contiguous(), vs[:, None].contiguous())
        else:
            k, v = k.to(kv), v.to(kv)
        args, kw = (q, k, v, *scales), dict(n_head=H)
        got = cross_attend_decode(*args, **kw)
        case = _case("cross_attend_decode", (act, kv, f"B={B} T={T}"), got,
                     cross_attend_decode_plain(*args, **kw),
                     lambda: cross_attend_decode(*args, **kw),
                     lambda: cross_attend_decode_plain(*args, **kw),
                     (nbytes(q, k, v, *scales, got), 4 * B * T * D, act))
        if not cases:  # the main path's case: beside it, one library call, both timers
            dh = D // H
            heads = lambda t: t.view(B, -1, H, dh).transpose(1, 2)
            sdpa = lambda: F.scaled_dot_product_attention(heads(q), heads(k), heads(v),
                                                          scale=_q_scale(dh))
            with torch.no_grad():
                case["library_ms"] = timed_ms(sdpa)
                case["library_ms_spin"] = timed_ms(sdpa, spin=True)
            print(f"    scaled_dot_product_attention at the same shape: "
                  f"{case['library_ms']:.4f} ms ({case['library_ms_spin']:.4f} behind a spin); "
                  f"the kernel behind a spin: {case['ms_spin'] / case['library_ms_spin']:.3f} "
                  f"of it")
        cases.append(case)
        del k, v
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
                           lambda: train_attention_fwd_plain(q, k, v, H, **kw),
                           _attention_bound(q, k, v, got, valid_len=valid_len)))
        if not cases[1:]:  # the main path's case: beside it, one library call
            cases[0]["library_ms"] = _sdpa_ms(q, k, v, None, H, False, None)
            print(f"    scaled_dot_product_attention at the same shape: "
                  f"{cases[0]['library_ms']:.4f} ms")
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
                       lambda: train_attention_fwd_plain(q, k, v, H, **kw),
                       _attention_bound(q, k, v, got, causal=True, bias=key_bias)))
    cases[-1]["library_ms"] = _sdpa_ms(q, k, v, None, H, True, key_bias)
    print(f"    scaled_dot_product_attention at the same shape: {cases[-1]['library_ms']:.4f} ms")
    # training's cross attention: the decoder's 448 queries over 1500 audio keys
    k, v = (torch.randn(B, 1500, D, generator=gen).to("cuda", torch.bfloat16) for _ in range(2))
    got = train_attention_fwd(q, k, v, H)
    cases.append(_case("train_attention_fwd", (torch.bfloat16, "cross 448x1500 B=16"), got,
                       train_attention_fwd_plain(q, k, v, H),
                       lambda: train_attention_fwd(q, k, v, H),
                       lambda: train_attention_fwd_plain(q, k, v, H),
                       _attention_bound(q, k, v, got)))
    cases[-1]["library_ms"] = _sdpa_ms(q, k, v, None, H, False, None)
    print(f"    scaled_dot_product_attention at the same shape: {cases[-1]['library_ms']:.4f} ms")
    return cases


def _attention_bound(q, k, v, *outs, causal=False, bias=None, valid_len=None, ids=None,
                     products=2):
    """(bytes, operations, dtype) of ``products`` matrix products of
    2 Tq Tk dh per (b, h) (2 in the forward, 5 in the backward) over the keys
    the call needs: those below ``valid_len``, with the causal mask the lower
    triangle only, and with segment ids (the same for queries and keys) the
    pairs of equal ids."""
    B, Tq, D = q.shape
    Tk = k.shape[1] if valid_len is None else valid_len
    pairs = B * (Tq * (Tq + 1) // 2 if causal else Tq * Tk)
    if ids is not None:
        keep = ids[:, :, None] == ids[:, None, :]
        pairs = int((keep.tril() if causal else keep).sum())
    return nbytes(q, k, v, bias, ids, *outs), products * 2 * pairs * D, q.dtype


def _sdpa_ms(q, k, v, do, H, causal, key_bias, ids=None) -> float:
    """Time of torch's scaled_dot_product_attention at the same shapes (the
    port never calls it; it does not round P to bf16): the forward, or with
    ``do`` its backward, as the forward-and-backward less the forward. The
    causal mask, the key bias and the segment ids (the same for queries and
    keys) ride in one boolean mask."""
    import torch.nn.functional as F

    B, Tq, D = q.shape
    Tk, dh = k.shape[1], D // H
    heads = lambda t: t.detach().view(B, -1, H, dh).transpose(1, 2).requires_grad_(do is not None)
    qh, kh, vh = heads(q), heads(k), heads(v)
    mask = None
    if causal or key_bias is not None or ids is not None:
        mask = torch.ones(B, 1, Tq, Tk, dtype=torch.bool, device=q.device)
        if causal:
            mask &= torch.ones(Tq, Tk, dtype=torch.bool, device=q.device).tril()
        if key_bias is not None:
            mask &= (key_bias > float("-inf"))[:, None, None, :]
        if ids is not None:
            mask &= (ids[:, :, None] == ids[:, None, :])[:, None]
    fwd = lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
    if do is None:
        with torch.no_grad():
            return events_ms(fwd)
    gh = do.view(B, Tq, H, dh).transpose(1, 2)
    both = events_ms(lambda: torch.autograd.grad(fwd(), (qh, kh, vh), gh))
    with torch.no_grad():
        return both - events_ms(fwd)


def check_attention_bwd(gen) -> list:
    """The backward kernel at small.en's width and the training shapes: the
    encoder (1500 x 1500, at the training micro batch of 16 and at B=4), the
    decoder's causal self-attention with the loader's suffix-pad bias (B=16,
    448, text lengths 20-448), the cross attention (B=16, 448 x 1500), all
    bf16, and the decoder self case in fp32; beside each, torch's
    scaled_dot_product_attention backward. In fp32 the kernel still rounds
    ds and pn to bf16, so a few elements may flip by one bf16 step. Every
    case launches the backward twice and fails unless both are bit-equal."""
    from olmoasr_tpu_torch.ops.train_attention import (
        train_attention_bwd, train_attention_bwd_plain,
    )

    D, H, cases = 768, 12, []
    lengths = torch.linspace(20, 448, 16).round()
    pad_bias = torch.where(torch.arange(448)[None] < lengths[:, None], 0.0,
                           float("-inf")).cuda()
    for label, dtype, B, Tq, Tk, causal, bias in (
            ("encoder 1500x1500, B=16", torch.bfloat16, 16, 1500, 1500, False, None),
            ("encoder 1500x1500, B=4", torch.bfloat16, 4, 1500, 1500, False, None),
            ("decoder self 448 causal + pad bias, B=16", torch.bfloat16, 16, 448, 448, True,
             pad_bias),
            ("cross 448x1500, B=16", torch.bfloat16, 16, 448, 1500, False, None),
            ("decoder self 448 causal + pad bias, B=16", torch.float32, 16, 448, 448, True,
             pad_bias)):
        q, do = (torch.randn(B, Tq, D, generator=gen).to("cuda", dtype) for _ in range(2))
        k, v = (torch.randn(B, Tk, D, generator=gen).to("cuda", dtype) for _ in range(2))
        args = (q, k, v, do, H, causal, bias)
        got, want = train_attention_bwd(*args), train_attention_bwd_plain(*args)
        again = train_attention_bwd(*args)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"train_attention_bwd {dtype} {label}: two launches differ (the kernel must be "
                 "deterministic)")
        case = _case("train_attention_bwd", (dtype, label), got, want,
                     lambda: train_attention_bwd(*args), lambda: train_attention_bwd_plain(*args),
                     _attention_bound(q, k, v, do, *got, causal=causal, bias=bias, products=5),
                     flips=dtype == torch.float32)
        case["library_ms"] = _sdpa_ms(*args)
        print(f"    scaled_dot_product_attention backward at the same shape: "
              f"{case['library_ms']:.4f} ms")
        cases.append(case)
        del q, k, v, do, got, want
    return cases


def check_flash(gen) -> dict:
    """The flash route's kernels at small.en's width and the route's shapes:
    the encoder (1500 x 1500; the forward at the inference batch of 64, the
    backward at the training micro batch of 16), the decoder's causal
    self-attention with the loader's suffix pads as segment ids (B=16, 448,
    text lengths 20-448), the cross attention (B=16, 448 x 1500), all bf16,
    and the decoder self case in fp32; beside each, torch's
    scaled_dot_product_attention (forward, or backward) with the same mask.
    The backward takes its residuals (o, m, l) from the forward kernel."""
    from olmoasr_tpu_torch.ops.flash import (
        flash_mha_bwd, flash_mha_bwd_plain, flash_mha_fwd, flash_mha_fwd_plain,
    )

    D, H, out = 768, 12, {"flash_mha_fwd": [], "flash_mha_bwd": []}
    lengths = torch.linspace(20, 448, 16).round()
    pad_ids = (torch.arange(448)[None] >= lengths[:, None]).int().cuda()
    shapes = (("encoder 1500x1500", torch.bfloat16, 1500, 1500, False, None),
              ("decoder self 448 causal + pad ids", torch.bfloat16, 448, 448, True, pad_ids),
              ("cross 448x1500", torch.bfloat16, 448, 1500, False, None),
              ("decoder self 448 causal + pad ids", torch.float32, 448, 448, True, pad_ids))
    for name in out:
        for label, dtype, Tq, Tk, causal, ids in shapes:
            B = 64 if name == "flash_mha_fwd" and Tq == Tk == 1500 else 16
            q, do = (torch.randn(B, Tq, D, generator=gen).to("cuda", dtype) for _ in range(2))
            k, v = (torch.randn(B, Tk, D, generator=gen).to("cuda", dtype) for _ in range(2))
            if name == "flash_mha_fwd":
                inputs, do, fn, plain, products = (), None, flash_mha_fwd, flash_mha_fwd_plain, 2
            else:  # the residuals o, m, l and the output's gradient
                inputs = (*flash_mha_fwd(q, k, v, H, causal, ids, ids), do)
                fn, plain, products = flash_mha_bwd, flash_mha_bwd_plain, 5
            args = (q, k, v, *inputs, H, causal, ids, ids)
            got = fn(*args)
            case = _case(name, (dtype, f"{label}, B={B}"), got, plain(*args),
                         lambda: fn(*args), lambda: plain(*args),
                         _attention_bound(q, k, v, *inputs, *got, causal=causal, ids=ids,
                                          products=products))
            case["library_ms"] = _sdpa_ms(q, k, v, do, H, causal, None, ids)
            print(f"    scaled_dot_product_attention{' backward' if do is not None else ''} "
                  f"at the same shape: {case['library_ms']:.4f} ms")
            out[name].append(case)
            del q, k, v, do, inputs, args, got
    return out


def check_self_sub_block(gen) -> dict:
    """ln_matmul, self_attend_decode on a full-size ring (q, k_new and v_new
    as row views of the fused projection, as decode_step passes them) and
    matmul_residual, at the decode step's widths."""
    from olmoasr_tpu_torch.ops.attention import (
        _ln_f32, ln_matmul, ln_matmul_plain, matmul_residual, matmul_residual_plain,
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
        # the greedy rows above, then seeded rows at the other decode paths'
        # counts (bf16); cuBLAS's product alone beside each
        for rows in (PROJ_ROWS if dtype == torch.bfloat16 else (B,)):
            xr = x if rows == B else torch.randn(rows, 1, D, generator=gen).to("cuda", dtype)
            lm = (xr, *ln, w, b)
            got = qkv if rows == B else ln_matmul(*lm)
            h = _ln_f32(xr, *ln).to(dtype)[:, 0]
            cases["ln_matmul"].append(_case(
                "ln_matmul", (dtype, f"B={rows} D={D} N={3 * D}"), got, ln_matmul_plain(*lm),
                lambda: ln_matmul(*lm), lambda: ln_matmul_plain(*lm),
                (nbytes(*lm, got), 2 * rows * D * 3 * D, dtype),
                yardstick=lambda: _cublas_ms((h, w, b))))
        q, kn, vn = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
        rings = [torch.randn(L, B, C, D, generator=gen).to("cuda", dtype) for _ in range(2)]
        for offset in (224, 100, 1):
            sa = (q, *rings, kn, vn, offset, layer)
            attn = self_attend_decode(*sa, n_head=H)
            case = _case(
                "self_attend_decode", (dtype, f"ring L={L} B={B} C={C} layer {layer} offset {offset}"),
                attn, self_attend_decode_plain(*sa, n_head=H),
                lambda: self_attend_decode(*sa, n_head=H),
                lambda: self_attend_decode_plain(*sa, n_head=H), _self_bound(sa, attn))
            if dtype == torch.bfloat16 and offset == 224:
                case.update(_self_sdpa_ms(sa, H))
            cases["self_attend_decode"].append(case)
        del rings
        # the decoder's whole ring: the last step's offset
        long = [torch.randn(8, B, 448, D, generator=gen).to("cuda", dtype) for _ in range(2)]
        sa = (q, *long, kn, vn, 447, layer)
        attn = self_attend_decode(*sa, n_head=H)
        cases["self_attend_decode"].append(_case(
            "self_attend_decode", (dtype, f"ring L=8 B={B} C=448 layer {layer} offset 447"),
            attn, self_attend_decode_plain(*sa, n_head=H),
            lambda: self_attend_decode(*sa, n_head=H),
            lambda: self_attend_decode_plain(*sa, n_head=H), _self_bound(sa, attn)))
        del long
        wo, bo = _weights(gen, D, D, fan_in=D, dtype=dtype), \
            (0.02 * torch.randn(D, generator=gen)).to("cuda", dtype)
        # the attention output of the ring above at the greedy rows, then
        # seeded rows at the other decode paths' counts (bf16)
        for rows in (PROJ_ROWS if dtype == torch.bfloat16 else (B,)):
            a = attn if rows == B else torch.randn(rows, 1, D, generator=gen).to("cuda", dtype)
            xr = x if rows == B else torch.randn(rows, 1, D, generator=gen).to("cuda", dtype)
            mr = (a, xr, wo, bo)
            out = matmul_residual(*mr)
            cases["matmul_residual"].append(_case(
                "matmul_residual", (dtype, f"B={rows} D={D}"), out,
                matmul_residual_plain(*mr), lambda: matmul_residual(*mr),
                lambda: matmul_residual_plain(*mr), (nbytes(*mr, out), 2 * rows * D * D, dtype),
                yardstick=lambda: _cublas_ms((a[:, 0], wo, bo))))
    return cases


def _self_sdpa_ms(sa, H) -> dict:
    """A yardstick for self_attend_decode that the port never calls:
    scaled_dot_product_attention over the ring's first offset + 1 positions
    with this step's key and value written in at the offset (the writing
    not timed), both timers."""
    import torch.nn.functional as F

    from olmoasr_tpu_torch.ops.attention import _q_scale

    q, kr, vr, kn, vn, offset, layer = sa
    B, D = q.shape[0], q.shape[-1]
    dh = D // H
    k, v = kr[layer, :, :offset + 1].clone(), vr[layer, :, :offset + 1].clone()
    k[:, offset], v[:, offset] = kn[:, 0], vn[:, 0]
    heads = lambda t: t.view(B, -1, H, dh).transpose(1, 2)
    sdpa = lambda: F.scaled_dot_product_attention(heads(q), heads(k), heads(v),
                                                  scale=_q_scale(dh))
    with torch.no_grad():
        out = {"sdpa_ms": timed_ms(sdpa), "sdpa_ms_spin": timed_ms(sdpa, spin=True)}
    print(f"    [yardstick: scaled_dot_product_attention over the {offset + 1} positions, the new "
          f"key written in: {out['sdpa_ms']:.4f} ms ({out['sdpa_ms_spin']:.4f} behind a spin)]")
    return out


def _self_bound(sa, out, anc=None):
    """(bytes, operations, dtype) of self_attend_decode: q, the new key and
    value, one layer's rings up to the offset (and the ancestry map's
    columns, or int8 rings' scales, up to it), the output; q.K and P.V over
    offset + 1 positions."""
    q, kr, _, kn, vn, offset, _ = sa
    B, D = q.shape[0], q.shape[-1]
    rings = 2 * B * offset * D * kr.element_size() + (0 if anc is None else B * offset * 4)
    if kr.dtype == torch.int8:
        rings += 2 * B * offset * 4  # the k and v scales
    return nbytes(q, kn, vn, out) + rings, 4 * B * (offset + 1) * D, q.dtype


def check_self_ancestry(gen) -> list:
    """Beam-search self attention: 32 windows x 5 beams over full-size rings,
    a random ancestry map, q, k_new and v_new as row views of a fused
    projection."""
    from olmoasr_tpu_torch.ops.attention import self_attend_decode, self_attend_decode_plain

    K, D, H, L, C, layer = 5, 768, 12, 12, 225, 7
    B = 32 * K
    anc = torch.randint(0, K, (B, C), generator=gen, dtype=torch.int32).cuda()
    cases = []
    for dtype, offsets in ((torch.bfloat16, (224, 100)), (torch.float32, (100,))):
        qkv = torch.randn(B, 1, 3 * D, generator=gen).to("cuda", dtype)
        q, kn, vn = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
        rings = [torch.randn(L, B, C, D, generator=gen).to("cuda", dtype) for _ in range(2)]
        for offset in offsets:
            sa = (q, *rings, kn, vn, offset, layer)
            kw = dict(n_head=H, beam_anc=anc, beam_k=K)
            got = self_attend_decode(*sa, **kw)
            cases.append(_case(
                "self_attend_decode_beam",
                (dtype, f"ring L={L} B={B} ({B // K} windows x {K} beams) C={C} layer {layer} "
                        f"offset {offset}"),
                got, self_attend_decode_plain(*sa, **kw),
                lambda: self_attend_decode(*sa, **kw),
                lambda: self_attend_decode_plain(*sa, **kw), _self_bound(sa, got, anc)))
        del rings
    return cases


# p is rounded to bf16 before P.V in kernel and twin alike; where their fp32
# scores differ in the last bit that rounding can flip by one bf16 step,
# which moves an output by up to p/l * 2^-8 * |v| (about 1e-4 at these shapes)
FP32_TOL = {"mlp_block": 1e-4, "cross_block_decode": 1e-4, "train_attention_fwd": 1e-3,
            "ln_matmul": 1e-4, "matmul_residual": 1e-4, "self_attend_decode": 1e-4,
            "self_attend_decode_beam": 1e-4, "layer_block_decode": 1e-4,
            "train_attention_bwd": 2.0 ** -6, "self_attend_decode_q8": 1e-4,
            "cross_attend_decode": 1e-4, "layer_block_decode_mlp": 1e-4,
            # the flash route rounds nothing in fp32: kernel and plain version
            # differ only in the order of their fp32 sums
            "flash_mha_fwd": 1e-5, "flash_mha_bwd": 1e-5}
# the backward rounds ds and pn to bf16 even for fp32 inputs: where kernel and
# twin differ in the last fp32 bit a few elements flip by one bf16 step (two
# steps at the largest magnitude above); every other element agrees to 1e-5
FLIP_TOL, FLIP_SHARE = 1e-5, 0.01

# the card's published peaks (NVIDIA H100 SXM data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12, torch.int8: 1979e12}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(moved_bytes: float, ops: float, dtype) -> tuple:
    """(ms, "bytes" or "operations"): the least time the card could take to
    move ``moved_bytes`` (each input read once, each output written once) and
    do ``ops`` operations at the peak rate of ``dtype``."""
    by_bytes = moved_bytes / HBM_BYTES_PER_S
    by_ops = ops / PEAK_OPS_PER_S[dtype]
    return 1e3 * max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def _agrees(got, want, tol, flips: bool) -> bool:
    err = (got.float() - want.float()).abs()
    if not flips:
        return bool(err.max() <= tol)
    scale = float(want.float().abs().max())
    return bool(err.max() <= tol) and float((err > FLIP_TOL * scale).float().mean()) <= FLIP_SHARE


def _case(name, what, got, want, kernel_fn, plain_fn, bound_of=None, flips=False,
          yardstick=None) -> dict:
    """The kernel's output(s) against the twin's, and both timed (the kernel
    also with each replay behind a spin, ``ms_spin``). ``got`` and
    ``want`` may be tuples (each part held to its own tolerance);
    ``bound_of`` is (bytes, operations, dtype) of the call; ``flips`` allows
    FLIP_SHARE of the elements past FLIP_TOL (see there); ``yardstick``
    returns the ms of library calls printed beside the kernel's as
    ``cublas_ms`` (a yardstick the port never calls, not ``library_ms``)."""
    torch.cuda.synchronize()
    parts = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
    fp32 = parts[0][0].dtype == torch.float32
    errs, tols, ok = [], [], True
    for g, w in parts:
        tol = FP32_TOL[name] * max(1.0, float(w.float().abs().max())) if fp32 else bf16_tol(w)
        errs.append(max_err(g, w))
        tols.append(tol)
        ok = ok and bool(torch.isfinite(g).all()) and _agrees(g, w, tol, flips)
    err, tol = max(errs), min(tols)
    ms, ms_spin, plain_ms = timed_ms(kernel_fn), timed_ms(kernel_fn, spin=True), timed_ms(plain_fn)
    out = {"what": str(what), "max_abs_err": err, "tol": tol, "ms": ms, "ms_spin": ms_spin,
           "plain_ms": plain_ms}
    if bound_of is not None:
        out["bound_ms"], out["bound_by"] = bound(*bound_of)
    if yardstick is not None:
        out["cublas_ms"] = yardstick()
    print(f"  {name} {what}: max_abs_err {err:.3e} (tol {tol:.3e}) "
          f"kernel {ms:.4f} ms ({ms_spin:.4f} behind a spin) plain {plain_ms:.4f} ms"
          + (f" bound {out['bound_ms']:.4f} ms ({out['bound_by']})" if bound_of else "")
          + (f" [yardstick: cuBLAS's products alone {out['cublas_ms']:.4f} ms]"
             if yardstick is not None else ""))
    if not ok:
        fail(f"{name} {what}: kernel disagrees with its plain twin "
             f"(max_abs_err {errs}, tol {tols})")
    return out


def events_ms(fn) -> float:
    """Median device time of one eager call of ``fn`` in ms over RUNS runs,
    between CUDA events: for a library call whose autograd graph is not
    captured (its kernels take milliseconds, so the launch cost is small)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(RUNS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_kernels(fn) -> int:
    """The device kernels one call of ``fn`` launches: the kernel nodes of a
    CUDA graph capture of the call (csrc/skinny_proj.cu:
    olm_graph_kernel_nodes), after a warm-up call."""
    from olmoasr_tpu_torch.ops import _build

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    n = _build.lib().olm_graph_kernel_nodes(graph.raw_cuda_graph())
    del graph
    return n


def _check_device_kernels(what: str, fn, n: int) -> int:
    """Fails unless one call of ``fn`` is ``n`` device kernels (the split
    pass would add its combine launch)."""
    got = device_kernels(fn)
    print(f"    one call: {got} device kernels")
    if got != n:
        fail(f"{what}: one call launched {got} device kernels, not {n}")
    return got


def phase_kernels() -> dict:
    print("kernels vs plain twins:")
    gen = torch.Generator().manual_seed(0)
    return {
        "cross_block_decode": check_cross(gen) + check_int8_qk(gen),
        "layer_block_decode": check_layer_block(gen),
        "layer_block_decode_mlp": check_layer_block_mlp(gen),
        "self_attend_decode_q8": check_self_q8(gen),
        "cross_attend_decode": check_cross_attend(gen),
        "mlp_block": check_mlp(gen),
        "train_attention_fwd": check_attention(gen),
        "train_attention_bwd": check_attention_bwd(gen),
        **check_flash(gen),
        **check_self_sub_block(gen),
        "self_attend_decode_beam": check_self_ancestry(gen),
    }


# the probes of rows 3 and 9 (olmoasr_tpu_torch/perf): each wrapper, the TPU
# probe function it ports, its variants (the first is its main case; the
# probes' "base" variants run the production kernels), and what its kernel
# computes ("fwd": the forward, "scores": the score product alone, "bwd": the
# backward)
PROBES = {
    "probe_seq": ("perf/probe_pack.py:64", "probe_pack", ("seq128", "seq64", "pad64", "pad128"),
                  "fwd"),
    "probe_pack": ("perf/probe_pack.py:98", "probe_pack", ("pack128", "pack64"), "fwd"),
    "probe_scores": ("perf/probe_pack.py:147", "probe_pack",
                     ("rawd64x128", "rawd64x64", "rawd128x64", "rawd128x128"), "scores"),
    "probe_pipe": ("perf/probe_pipe.py:49", "probe_pipe", ("pipe128", "pipe64", "seq64", "seq128"),
                   "fwd"),
    "probe_ablate": ("perf/probe_pipe.py:127", "probe_pipe", ("ablate",), "fwd"),
    "probe_bwd_tile": ("perf/probe_bwd.py:125", "probe_bwd", ("bq64", "bq128"), "bwd"),
    "probe_row": ("perf/probe_bwd.py:38", "probe_bwd", ("row64",), "bwd"),
}
PROBE_RUNS = 3  # replays a probe variant is timed over here (the probes' own default is 11)


def phase_probes() -> dict:
    """Every variant of the three probes once, through their entry points
    (``main`` of ``olmoasr_tpu_torch.perf.probe_pack``, ``probe_pipe``,
    ``probe_bwd``: medium.en's training shape, each variant timed over
    PROBE_RUNS graph replays and, where it computes attention, held against
    the plain twin by the probe itself); the probe wrappers' launches are set
    to 0 before and read after. Then, per wrapper, its main variant's time
    with each replay behind a spin, the plain version's time, the bound and
    one library call at the probes' shape."""
    from olmoasr_tpu_torch.ops.train_attention import (
        train_attention_bwd_plain, train_attention_fwd_plain,
    )
    from olmoasr_tpu_torch.perf import _probes as P
    from olmoasr_tpu_torch.perf import probe_bwd, probe_pack, probe_pipe

    print("probes of rows 3 and 9 (medium.en, B=16, T=1500, D=1024, H=16):")
    modules = {"probe_pack": probe_pack, "probe_pipe": probe_pipe, "probe_bwd": probe_bwd}
    for wrapper in P.WRAPPERS:
        wrapper.launches = 0
    rows = {}
    for name, mod in modules.items():
        try:
            rows[name] = {r["variant"]: r for r in mod.main(mod.VARIANTS, runs=PROBE_RUNS)}
        except SystemExit as exc:
            fail(f"{name}: {exc}")
    counts = {w.__name__: w.launches for w in P.WRAPPERS}
    print(f"  probe launches {counts}")
    if set(counts) != set(PROBES) or not all(counts.values()):
        fail(f"probes: a probe kernel was not launched: {counts}")
    q, k, v, do = P.inputs(4)
    plain = {"fwd": lambda: train_attention_fwd_plain(q, k, v, P.H),
             "scores": lambda: P.scores_plain(q, k, P.H, P.DH ** -0.5),
             "bwd": lambda: train_attention_bwd_plain(q, k, v, do, P.H)}
    plain_ms = {kind: timed_ms(fn) for kind, fn in plain.items()}
    fwd_out = plain["fwd"]()
    bounds = {"fwd": bound(*_attention_bound(q, k, v, fwd_out)),
              "scores": bound(nbytes(q, k) + q.numel() * 4, 2 * q.shape[0] * P.T * P.T * P.D,
                              torch.bfloat16),
              # the outputs dq, dk, dv have the shapes of q, k, v
              "bwd": bound(*_attention_bound(q, k, v, do, q, k, v, products=5))}
    library = {"fwd": _sdpa_ms(q, k, v, None, P.H, False, None), "scores": None,
               "bwd": _sdpa_ms(q, k, v, do, P.H, False, None)}
    # a variant's call, for its time with each replay behind a spin
    bias = torch.zeros((1, P.T), dtype=torch.float32, device="cuda")
    calls = {"probe_pack": lambda var: lambda: probe_pack.call(var, q, k, v, P.H),
             "probe_pipe": lambda var: lambda fn=probe_pipe.cases(var)[0][1]: fn(q, k, v, bias,
                                                                                 P.H),
             "probe_bwd": lambda var: lambda: probe_bwd.call(var, q, k, v, do, P.H)}
    out = {}
    for wrapper, (replaces, probe, variants, kind) in PROBES.items():
        mine = [r for v in variants for r in (
            [x for n, x in rows[probe].items() if n.startswith("sb128")] if v == "ablate"
            else [rows[probe][v]])]
        errs = [r["max_abs_err"] for r in mine if r["max_abs_err"] is not None]
        out[wrapper] = {"replaces": replaces, "launches": counts[wrapper], "cases": mine,
                        "ms": mine[0]["ms"],
                        "ms_spin": timed_ms(calls[probe](variants[0]), spin=True),
                        "max_abs_err": max(errs) if errs else None,
                        "plain_ms": plain_ms[kind], "bound_ms": bounds[kind][0],
                        "bound_by": bounds[kind][1], "library_ms": library[kind]}
        print(f"  {wrapper}: {mine[0]['variant']} {mine[0]['ms']:.4f} ms "
              f"({out[wrapper]['ms_spin']:.4f} behind a spin), plain "
              f"{plain_ms[kind]:.4f} ms, bound {bounds[kind][0]:.4f} ms ({bounds[kind][1]}), "
              f"library {library[kind] if library[kind] is None else round(library[kind], 4)} ms")
    return out


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------


DECODE_KERNELS = ("ln_matmul", "self_attend_decode", "matmul_residual", "cross_block_decode",
                  "layer_block_decode", "mlp_block", "cross_attend_decode")
# the single-token step's launches per layer along each route of decode_step:
# the split kernels; over an int8 cross cache with one token row per window
# the fused self + cross launch ("sc", auto's choice there) or the whole
# layer; the standalone cross attention between two more projections
ROUTE_STEP = {
    "split": {"ln_matmul": 1, "self_attend_decode": 1, "matmul_residual": 1,
              "cross_block_decode": 1, "mlp_block": 1},
    "sc": {"layer_block_decode": 1, "mlp_block": 1},
    "layer": {"layer_block_decode": 1},
    "attend": {"ln_matmul": 2, "self_attend_decode": 1, "matmul_residual": 2,
               "cross_attend_decode": 1, "mlp_block": 1},
}


def _counters():
    """Every kernel wrapper of the path, whose ``launches`` count its kernel's
    launches, and decode_step, whose ``single_steps`` count S=1 steps. An
    older checkout under ``--ab`` may lack some wrappers."""
    from olmoasr_tpu_torch.models import whisper
    from olmoasr_tpu_torch.ops import attention, train_attention

    kernels = {name: getattr(attention, name) for name in DECODE_KERNELS
               if hasattr(attention, name)}
    kernels["train_attention_fwd"] = train_attention.train_attention_fwd
    kernels["train_attention_bwd"] = train_attention.train_attention_bwd
    try:
        from olmoasr_tpu_torch.ops import flash
    except ImportError:  # an older checkout under --ab
        return kernels, whisper.decode_step
    kernels["flash_mha_fwd"] = flash.flash_mha_fwd
    kernels["flash_mha_bwd"] = flash.flash_mha_bwd
    return kernels, whisper.decode_step


# kernels counted inside another wrapper's launches: (name, wrapper, counter)
SUB_COUNTS = (("self_attend_decode_beam", "self_attend_decode", "beam_launches"),
              ("self_attend_decode_q8", "self_attend_decode", "q8_launches"),
              ("cross_block_decode_group", "cross_block_decode", "group_launches"),
              ("layer_block_decode_mlp", "layer_block_decode", "mlp_launches"))


def _reset_counts():
    kernels, step = _counters()
    for fn in kernels.values():
        fn.launches = 0
    for _, wrapper, counter in SUB_COUNTS:
        setattr(kernels[wrapper], counter, 0)
    step.single_steps = 0


def _read_counts():
    """Launches by kernel (``self_attend_decode_beam`` and ``_q8``: those of
    the ancestry variant and over int8 rings, subsets of
    ``self_attend_decode``'s; ``layer_block_decode_mlp``: the whole-layer
    launches, a subset of ``layer_block_decode``'s;
    ``cross_block_decode_group``: row 1's ``group_kernel`` launches, those
    with ``kv_group`` > 1, a subset of ``cross_block_decode``'s) and
    single-token steps."""
    kernels, step = _counters()
    counts = {name: fn.launches for name, fn in kernels.items()}
    for name, wrapper, counter in SUB_COUNTS:
        counts[name] = getattr(kernels[wrapper], counter)
    return counts, step.single_steps


def _check_decode_counts(label: str, counts: dict, steps: int, L: int, route: str = "split",
                         int8_rings: bool = False) -> None:
    """Every kernel of the step's route (a key of ROUTE_STEP) launched as
    often per layer and single-token step as the route runs it, and the
    others not at all; the int8-ring and whole-layer launches all or none of
    theirs."""
    per_step = ROUTE_STEP[route]
    want = {name: per_step.get(name, 0) * L * steps for name in DECODE_KERNELS}
    want["self_attend_decode_q8"] = want["self_attend_decode"] if int8_rings else 0
    want["layer_block_decode_mlp"] = want["layer_block_decode"] if route == "layer" else 0
    for name, n in want.items():
        if counts[name] != n:
            fail(f"{label}: {name} launched {counts[name]} times, expected {n} "
                 f"({L} layers x {steps} steps, route {route})" if n else
                 f"{label}: {name} launched {counts[name]} times, expected none")


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
        _check_results(label, results, B, dims)
        if single_steps != steps:
            fail(f"{label}: decode_step counted {single_steps} single-token steps, expected {steps}")
        # int8 cross K/V, one row per window: the fused self + cross launch
        _check_decode_counts(label, counts, steps, dims.n_text_layer,
                             route="sc" if kv_quant else "split")
        if counts["train_attention_fwd"] != dims.n_audio_layer:
            fail(f"{label}: encoder attention launched {counts['train_attention_fwd']} times")
        out[label] = {"steps": steps, "wall_s": wall, "audio_s_per_s": B * 30 / wall,
                      "launches": counts,
                      "step_profile": _profile_greedy_step(model, mel, options)}
    out["encoder flash"] = _encoder_flash(model, mel)
    out.update(phase_beam(model, mel[:BEAM_WINDOWS]))
    return out


# the encoder's features on the two routes, bf16: 12 layers in which the
# routes round p at different maxima (the row's, the running one) and sum in
# other orders; on the CPU's plain versions at B=2 the features differ by
# 2.3e-2 of the largest and 0.7% of the mean magnitude
ENC_ROUTE_MAX, ENC_ROUTE_MEAN = 2.0 ** -3, 2.0 ** -5


def _encoder_flash(model, mel) -> dict:
    """``encode_audio(attention="flash")`` of the windows against the kernel
    route's features: its wall and launches (one flash forward a layer, no
    other attention kernel) and the two routes' difference."""
    from olmoasr_tpu_torch.models.whisper import encode_audio

    want = encode_audio(model, mel)
    encode_audio(model, mel, attention="flash")  # warm-up
    walls = {}
    for route in ("flash", "kernel"):
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = encode_audio(model, mel, attention=route)
        torch.cuda.synchronize()
        walls[route] = time.perf_counter() - t0
        if route == "flash":
            counts, feats = _read_counts()[0], got
    err = (feats.float() - want.float()).abs()
    mx, mean = float(err.max()), float(err.mean())
    ref_mx, ref_mean = float(want.float().abs().max()), float(want.float().abs().mean())
    L = model.dims.n_audio_layer
    print(f"  encoder on the flash route, {mel.shape[0]} windows: wall {walls['flash']:.4f} s "
          f"(kernel route {walls['kernel']:.4f} s); against the kernel route's features max "
          f"{mx:.3e} of {ref_mx:.3f} (tol {ENC_ROUTE_MAX * ref_mx:.3e}), mean {mean:.3e} of "
          f"{ref_mean:.3f} (tol {ENC_ROUTE_MEAN * ref_mean:.3e}); launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    if not (bool(torch.isfinite(feats).all()) and feats.shape == want.shape
            and mx <= ENC_ROUTE_MAX * ref_mx and mean <= ENC_ROUTE_MEAN * ref_mean):
        fail(f"encoder flash route: features {tuple(feats.shape)} differ from the kernel "
             f"route's by {mx} (max), {mean} (mean)")
    if counts["flash_mha_fwd"] != L or any(v for k, v in counts.items() if k != "flash_mha_fwd"):
        fail(f"encoder flash route: launches {counts}, expected {L} flash_mha_fwd alone")
    return {"wall_s": walls["flash"], "kernel_route_wall_s": walls["kernel"], "max_abs_err": mx,
            "mean_abs_err": mean, "launches": counts}


BEAM_WINDOWS, BEAM_SIZE = 32, 5


def _check_results(label: str, results, n: int, dims) -> None:
    if len(results) != n:
        fail(f"{label}: {len(results)} results for {n} windows")
    for r in results:
        ok = (np.isfinite(r.avg_logprob) and 0.0 <= r.no_speech_prob <= 1.0
              and all(0 <= t < dims.n_vocab for t in r.tokens)
              and tuple(r.audio_features.shape) == (dims.n_audio_ctx, dims.n_audio_state)
              and bool(torch.isfinite(r.audio_features).all()))
        if not ok:
            fail(f"{label}: malformed result {r.tokens[:8]} {r.avg_logprob} {r.no_speech_prob}")


def phase_beam(model, mel) -> dict:
    """Beam search, BEAM_WINDOWS windows x BEAM_SIZE beams, bf16 and int8
    cross K/V: the wall and the launch counts of one ``decode``, then one
    beam step on the host clock against its kernels under the profiler."""
    from olmoasr_tpu_torch.decoding import DecodingOptions

    dims, B, K = model.dims, mel.shape[0], BEAM_SIZE
    model.decode(mel, DecodingOptions(language="en", beam_size=K, sample_len=4))  # warm-up
    out = {}
    for kv_quant in (False, True):
        label = f"beam{K} " + ("int8" if kv_quant else "bf16")
        options = DecodingOptions(language="en", beam_size=K, kv_quant=kv_quant)
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = model.decode(mel, options)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, steps = _read_counts()
        print(f"  {label}, {B} windows x {K} beams: {steps} decode steps, wall {wall:.3f} s, "
              f"{B * 30 / wall:.1f} audio-s/s, launches {counts}")
        _check_results(label, results, B, dims)
        _check_decode_counts(label, counts, steps, dims.n_text_layer)
        # the one-token prefill reads no map; every later step does
        if counts["self_attend_decode_beam"] != dims.n_text_layer * (steps - 1) or steps < 2:
            fail(f"{label}: {counts['self_attend_decode_beam']} ancestry launches in {steps} steps")
        out[label] = {"steps": steps, "wall_s": wall, "audio_s_per_s": B * 30 / wall,
                      "launches": counts, "step_profile": _profile_beam_step(model, mel, options)}
    return out


def _kernel_base_name(name: str) -> str:
    """``void ns::(anonymous namespace)::kernel<T>(args)`` -> ``kernel``."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return re.sub(r"<.*", "", re.sub(r"\(.*", "", name)).split("::")[-1] or name


def _profile_beam_step(model, mel, options) -> dict:
    """One step of the beam loop: ``_beam_step`` and a ``decode_step`` that
    reads the ancestry map."""
    from olmoasr_tpu_torch import decoding as dec
    from olmoasr_tpu_torch.models import whisper as model_mod

    tok = dec.get_tokenizer(multilingual=False)
    prompt = dec._resolve_prompt(tok, options)
    cfg = dec.build_filter_config(tok, options, len(prompt), model.dims.n_vocab)
    sample_len = min(model.dims.n_text_ctx // 2, model.dims.n_text_ctx - len(prompt))
    cache, st, _, _ = dec._beam_prefill(model, mel, prompt, cfg, sample_len,
                                        prompt.index(tok.sot), options.kv_quant,
                                        options.beam_size, None)

    def step(i):
        t = dec._beam_step(st, i, cfg, cache.index)
        st.logits = model_mod.decode_step(model, t[:, None], cache, beam_anc=st.anc)[:, 0]

    return _profile_step("beam", step, len(prompt))


def _profile_greedy_step(model, mel, options) -> dict:
    """One greedy step: ``decode_step`` over one token row per window, then
    the argmax (the filters left out)."""
    from olmoasr_tpu_torch import decoding as dec
    from olmoasr_tpu_torch.models import whisper as model_mod

    prompt = dec._resolve_prompt(dec.get_tokenizer(multilingual=False), options)
    feats = model_mod.encode_audio(model, mel)
    cache = model_mod.init_cache(model, feats, max_len=len(prompt) + 224,
                                 quantize_cross=options.kv_quant)
    tokens = torch.tensor([prompt] * mel.shape[0], device=mel.device)
    state = {"logits": model_mod.decode_step(model, tokens, cache)[:, -1]}

    def step(i):
        t = state["logits"].argmax(-1)
        state["logits"] = model_mod.decode_step(model, t[:, None], cache)[:, 0]

    return _profile_step("greedy", step, len(prompt))


def _profile_step(what: str, step, prompt_len: int, warm: int = 40, timed: int = 20,
                  profiled: int = 5) -> dict:
    """``step(i)`` at offset prompt_len + ``warm``: its host-clock time,
    averaged over ``timed`` steps ending in a synchronize, against the device
    time of the kernels it runs, summed over ``profiled`` steps under
    torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for i in range(warm):
        step(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(warm, warm + timed):
        step(i)
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0) / timed
    _reset_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(warm + timed, warm + timed + profiled):
            step(i)
        torch.cuda.synchronize()
    wrappers = {k: v / profiled for k, v in _read_counts()[0].items() if v}
    by_kernel: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = _kernel_base_name(e.name)
            ms, n = by_kernel.get(name, (0.0, 0))
            by_kernel[name] = (ms + e.time_range.elapsed_us() / 1e3 / profiled, n + 1)
    kernel_ms = sum(ms for ms, _ in by_kernel.values())
    launches = sum(n for _, n in by_kernel.values()) / profiled
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:10]
    print(f"    one {what} step at offset {warm + prompt_len}: host {host_ms:.3f} ms, kernels "
          f"{kernel_ms:.3f} ms ({launches:.1f} device launches), device idle "
          f"{100 * (1 - kernel_ms / host_ms):.1f}%" if kernel_ms else
          f"    one {what} step: host {host_ms:.3f} ms, kernel time not measured "
          f"(the profiler recorded no device events)")
    for name, (ms, n) in top:
        print(f"      {name}: {ms:.4f} ms, {n / profiled:.1f} launches per step")
    print(f"      wrapper launches per step: {wrappers}")
    return {"host_ms": host_ms, "kernel_ms": kernel_ms or None,
            "device_launches": launches, "by_kernel_ms": {k: v[0] for k, v in top},
            "wrapper_launches": wrappers}


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------


LONG_FORM_FILES = 16


def _long_form_audios():
    """The long-form slice's files: 40-75 s each of seeded noise."""
    rng = np.random.default_rng(2)
    seconds = rng.integers(40, 76, LONG_FORM_FILES)
    return seconds, [torch.from_numpy((rng.standard_normal(s * 16000) * 0.1).astype(np.float32))
                     for s in seconds]


def phase_long_form() -> dict:
    from olmoasr_tpu_torch import build_model, transcribe_many
    from olmoasr_tpu_torch import transcribe as tr
    from olmoasr_tpu_torch.transcribe import DEFAULT_TEMPERATURES

    n_files, best_of, beam_size = LONG_FORM_FILES, 5, 5  # the CLI's defaults
    model = build_model("small.en", seed=0, device="cuda", dtype=torch.bfloat16)
    dims = model.dims
    seconds, audios = _long_form_audios()
    audio_s = float(seconds.sum())
    transcribe_many(model, audios[:1], batch_size=1, sample_len=4, temperature=(0.0, 1.0),
                    best_of=best_of, beam_size=beam_size)  # warm-up; not counted

    windows_at = {}  # temperature -> windows decoded
    decode = model.decode
    calls = []

    def counting_decode(mel, options):
        windows_at[options.temperature] = windows_at.get(options.temperature, 0) + mel.shape[0]
        calls.append(options.temperature)
        return decode(mel, options)

    model.decode = counting_decode
    reruns = tr.transcribe_many.stale_max_reruns
    with _recorded_stream() as rec:
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = transcribe_many(model, audios, batch_size=n_files, best_of=best_of,
                                  beam_size=beam_size)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, steps = _read_counts()
    del model.decode
    print(f"long-form: small.en bf16, {n_files} files, {audio_s:.0f} s of audio, "
          f"batch_size={n_files}, beam_size={beam_size}, best_of={best_of}: wall {wall:.3f} s, "
          f"{audio_s / wall:.1f} audio-s/s, {steps} single-token steps")
    print(f"  windows per temperature {windows_at}; launches {counts}")
    reruns = tr.transcribe_many.stale_max_reruns - reruns
    # every window decodes at t=0 first; a file run again decodes its own
    gathered = _check_streamed("long-form", rec, audios, dims.n_mels, "float32",
                               None if reruns else windows_at[0.0])
    ladder = sorted(windows_at)
    if ladder != list(DEFAULT_TEMPERATURES) or len(set(windows_at.values())) != 1:
        fail(f"long-form: the ladder did not run whole for every window: {windows_at}")
    _check_decode_counts("long-form", counts, steps, dims.n_text_layer)
    if not 0 < counts["self_attend_decode_beam"] < counts["self_attend_decode"]:
        fail(f"long-form: {counts['self_attend_decode_beam']} ancestry launches of "
             f"{counts['self_attend_decode']}: the t=0 windows did not take the beam loop")
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
    prefix = _blocking_prefix(model, audios)
    guard = _long_form_guard(model)
    return {"files": n_files, "audio_s": audio_s, "wall_s": wall,
            "audio_s_per_s": audio_s / wall, "single_steps": steps,
            "windows_per_temperature": windows_at, "decode_calls": len(calls),
            "launches": counts, "windows_gathered": gathered, "stale_max_reruns": reruns,
            "blocking_prefix": prefix,
            "guard": guard}


@contextlib.contextmanager
def _recorded_stream():
    """Records, while open, every window a ``transcribe_many`` round gathers
    from a streamed group, with its (seek, size, file), the transport dtype
    of every chunk of samples sent to the card (not the tail's halo), and
    after each round's ``poll`` the chunks whose log-mel is enqueued."""
    from olmoasr_tpu_torch import transcribe as tr

    rec = {"windows": [], "transports": [], "polled": []}
    gather, put, poll = tr._gather_round, tr._StreamedMelGroup._put, tr._StreamedMelGroup.poll

    def recording_gather(specs, groups, gather_w, guards):
        out = gather(specs, groups, gather_w, guards)
        rec["windows"].extend(zip([s[2:5] for s in specs], out))
        return out

    def recording_put(self, s, chunk):
        if s < self.n_real:  # the tail's halo goes as int16 whenever it is exact (zeros)
            rec["transports"].append(str(chunk.dtype))
        return put(self, s, chunk)

    def recording_poll(self):
        poll(self)
        rec["polled"].append(self.done)

    tr._gather_round, tr._StreamedMelGroup._put = recording_gather, recording_put
    tr._StreamedMelGroup.poll = recording_poll
    try:
        yield rec
    finally:
        tr._gather_round, tr._StreamedMelGroup._put = gather, put
        tr._StreamedMelGroup.poll = poll


def _check_streamed(label: str, rec: dict, audios, n_mels: int, transport: str,
                    n_windows=None, rerun=()) -> int:
    """Every recorded window bit-equal on the card to the window of its
    file's whole-file log-mel (``transcribe``'s per-file path), but those of
    the files in ``rerun``, which the stale-max guard ran again; every
    file's first window and, given ``n_windows``, that many windows gathered
    from the streamed groups; every chunk sent as ``transport``."""
    from olmoasr_tpu_torch.audio import N_FRAMES, N_SAMPLES, log_mel_spectrogram

    whole, unequal = {}, []
    for (seek, size, i), got in rec["windows"]:
        if i in rerun:
            continue
        if i not in whole:
            whole[i] = log_mel_spectrogram(audios[i], n_mels, padding=N_SAMPLES, device="cuda")
        want = torch.nn.functional.pad(whole[i][:, seek:seek + size], (0, N_FRAMES - size))
        if not torch.equal(got, want):
            unequal.append((i, seek, size, max_err(got, want)))
    first = sum(1 for (seek, _, _), _ in rec["windows"] if seek == 0)
    print(f"  {label}: {len(rec['windows'])} windows gathered from streamed groups, "
          f"{len(unequal)} unequal to the whole-file windows (files run again, not held: "
          f"{sorted(rerun)}); chunks sent as "
          f"{sorted(set(rec['transports']))} ({len(rec['transports'])} chunks); chunks in "
          f"after each round's poll {rec['polled']}")
    if unequal or first != len(audios) or n_windows not in (None, len(rec["windows"])) \
            or set(rec["transports"]) != {transport}:
        fail(f"{label}: streamed windows unequal to the whole-file ones {unequal[:5]}, "
             f"{len(rec['windows'])} gathered ({n_windows} expected), {first} first windows "
             f"of {len(audios)} files, transports {rec['transports']}")
    return len(rec["windows"])


PREFIX_RUNS = 3  # timed runs of each blocking prefix, alternating


def _blocking_prefix(model, audios) -> dict:
    """The time to the first round's windows of ``audios`` (one round of
    all of them), each behind a synchronize, after a warm-up of each,
    alternating: the per-file log-mels of the whole files that the per-file
    path computes before its first round, then each file's first window;
    and streamed, with the card's float32 chunks and with the int16
    transport, on the files as they are (noise that is not exact PCM: the
    int16 attempt fails and chunk 0 is built again in f32) and rounded to
    exact PCM. A streamed run's span ends once the gathered windows are on
    the card: the groups built (chunk 0 built on the host, pinned, its copy
    enqueued, the builder thread started), then ``_gather_round`` (chunk
    0's log-mel, one gather) and a synchronize. ``close``, which stops the
    builder and waits for it, runs after the span and is timed on its own.
    Chunk 0's host build and its pinning are also timed alone. All give the
    same windows bit for bit."""
    from olmoasr_tpu_torch import transcribe as tr
    from olmoasr_tpu_torch.audio import N_FRAMES, N_SAMPLES, log_mel_spectrogram

    n_mels = model.dims.n_mels
    pcm = [torch.from_numpy(np.round(a.numpy() * 32768).clip(-32768, 32767) / 32768)
           .float() for a in audios]
    parts = {}

    def streamed(files, int16):
        tr._StreamedMelGroup.int16_transport = int16
        try:
            t0 = time.perf_counter()
            wavs = [tr._host_samples(a) for a in files]
            groups, stack_row, mel_frames, gather_w = tr._stream_groups(model, wavs, len(wavs))
            t1 = time.perf_counter()
            specs = [(*stack_row[i], 0, min(N_FRAMES, mel_frames[i] - N_FRAMES), i)
                     for i in range(len(wavs))]
            out = tr._gather_round(specs, groups, gather_w, [])
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            for grp in groups:
                grp.close()
            t3 = time.perf_counter()
        finally:
            tr._StreamedMelGroup.int16_transport = None
        parts.setdefault(int16, []).append((t1 - t0, t2 - t1, t3 - t2))
        return out

    def per_file(files):
        windows = []
        for a in files:
            mel = log_mel_spectrogram(a, n_mels, padding=N_SAMPLES, device="cuda")
            size = min(N_FRAMES, mel.shape[-1] - N_FRAMES)
            windows.append(torch.nn.functional.pad(mel[:, :size], (0, N_FRAMES - size)))
        out = torch.stack(windows)
        torch.cuda.synchronize()
        return out

    runs = {}
    for label, files in (("noise", audios), ("exact PCM", pcm)):
        fns = {"per_file": lambda f=files: per_file(f),
               "streamed f32": lambda f=files: streamed(f, False),
               "streamed int16": lambda f=files: streamed(f, True)}
        want = fns["per_file"]()
        for name in ("streamed f32", "streamed int16"):
            if not torch.equal(fns[name](), want):
                fail(f"blocking prefix ({label}): the {name} first windows differ from the "
                     f"per-file ones")
        parts.clear()
        times = {k: [] for k in fns}
        for _ in range(PREFIX_RUNS):
            for name, fn in fns.items():
                t0 = time.perf_counter()
                fn()
                times[name].append(time.perf_counter() - t0)
        # a streamed run's span: the groups built, then the gather; close after it
        for int16, ps in parts.items():
            name = "streamed int16" if int16 else "streamed f32"
            times[name] = [b + g for b, g, _ in ps]
            times[name + " build"] = [b for b, _, _ in ps]
            times[name + " close"] = [c for _, _, c in ps]
        rows = [tr._host_samples(a) for a in files]
        grp = tr._StreamedMelGroup.__new__(tr._StreamedMelGroup)
        grp.n_real = -(-max(len(r) for r in rows) // N_SAMPLES)
        for name, int16 in (("chunk 0 host f32", False), ("chunk 0 host int16", True)):
            grp._int16 = int16
            times[name] = []
            for _ in range(PREFIX_RUNS):
                t0 = time.perf_counter()
                chunk = grp._build_chunk(rows, 0)
                times[name].append(time.perf_counter() - t0)
        times["chunk 0 pin"] = []
        for _ in range(PREFIX_RUNS):
            t0 = time.perf_counter()
            torch.from_numpy(chunk).pin_memory()
            times["chunk 0 pin"].append(time.perf_counter() - t0)
        med = {k: statistics.median(v) for k, v in times.items()}
        print(f"  blocking prefix, {label} (the first round's {len(files)} windows ready on "
              f"the card, medians of {PREFIX_RUNS}): per-file log-mels "
              f"{med['per_file'] * 1e3:.2f} ms; streamed f32 {med['streamed f32'] * 1e3:.2f} "
              f"ms (groups built {med['streamed f32 build'] * 1e3:.2f}), streamed int16 "
              f"{med['streamed int16'] * 1e3:.2f} ms (built "
              f"{med['streamed int16 build'] * 1e3:.2f}); close after the span: f32 "
              f"{med['streamed f32 close'] * 1e3:.2f}, int16 "
              f"{med['streamed int16 close'] * 1e3:.2f} ms; chunk 0 alone on the host: f32 "
              f"{med['chunk 0 host f32'] * 1e3:.2f}, int16 attempt "
              f"{med['chunk 0 host int16'] * 1e3:.2f} ms ({chunk.dtype}, {chunk.nbytes} B), "
              f"pinned in {med['chunk 0 pin'] * 1e3:.2f} ms")
        print("    runs (ms): " + "; ".join(f"{k} " + ", ".join(f"{t * 1e3:.2f}" for t in v)
                                            for k, v in times.items()))
        runs[label] = {"median_s": med, "runs_s": times}
    return runs


GUARD_SAMPLE_LEN = 16  # the guard run's depth: tokens a window


def _pcm_noise(rng, seconds: int, scale: float) -> np.ndarray:
    """Seeded noise whose samples are exact int16 PCM values."""
    w = np.round(rng.standard_normal(seconds * 16000) * scale * 32768).clip(-32768, 32767)
    return (w / 32768).astype(np.float32)


def _long_form_guard(model) -> dict:
    """The stale-max guard on the card: three int16-exact files streamed
    together at fp32, t=0, greedy, GUARD_SAMPLE_LEN tokens a window, as
    int16 (the transport the CPU takes by default); the first quiet
    (digital silence) over its first 30 s and loud after, so that its first
    window, gathered before the rest of it is in, holds frames below its
    file's max - 8. It must run again through the per-file path, and its
    result equal ``transcribe`` of it alone. Then the rerun rate of
    recordings that start with digital silence (``_leading_zeros``)."""
    from olmoasr_tpu_torch import transcribe as tr

    rng = np.random.default_rng(9)
    quiet = _pcm_noise(rng, 30, 0.0005)
    quiet[16000 * 2:16000 * 20] = 0.0
    guard = np.concatenate([quiet, _pcm_noise(rng, 35, 0.3)])
    wavs = [guard, _pcm_noise(rng, 50, 0.05), _pcm_noise(rng, 40, 0.05)]
    opts = dict(temperature=0.0, sample_len=GUARD_SAMPLE_LEN, fp16=False)
    with _timed_reruns() as reruns, _recorded_stream() as rec:
        tr._StreamedMelGroup.int16_transport = True
        try:
            before = tr.transcribe_many.stale_max_reruns
            t0 = time.perf_counter()
            results = tr.transcribe_many(model, wavs, batch_size=len(wavs), **opts)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            tr._StreamedMelGroup.int16_transport = None
    n_reruns = tr.transcribe_many.stale_max_reruns - before
    alone = tr.transcribe(model, guard, **opts)
    rerun_guard = any(a is guard for a, _ in reruns)
    print(f"  stale-max guard: 3 int16-exact files (65 s quiet then loud, 50 s, 40 s) at fp32, "
          f"t=0, greedy, {GUARD_SAMPLE_LEN} tokens a window, int16 chunks: wall {wall:.3f} s; "
          f"stale_max_reruns {n_reruns} (the quiet-then-loud file among them: {rerun_guard}); "
          f"its result equal to transcribe of it alone: {results[0] == alone}")
    if n_reruns < 1 or not rerun_guard or results[0] != alone:
        fail(f"stale-max guard: {n_reruns} reruns, the guard file rerun {rerun_guard}, "
             f"result {str(results[0])[:300]} against {str(alone)[:300]}")
    windows = _check_streamed("stale-max guard", rec, wavs, model.dims.n_mels, "int16",
                              rerun={i for i, w in enumerate(wavs)
                                     if any(a is w for a, _ in reruns)})
    return {"wall_s": wall, "stale_max_reruns": n_reruns, "windows_gathered": windows,
            "leading_zeros": _leading_zeros(model, opts)}


@contextlib.contextmanager
def _timed_reruns():
    """A list that gets (audio, seconds) for each ``transcribe`` call that
    ``transcribe_many`` makes while the block runs: the stale-max guard's
    reruns."""
    from olmoasr_tpu_torch import transcribe as tr

    calls = []
    transcribe = tr.transcribe

    def timed(m, audio, **kw):
        t0 = time.perf_counter()
        out = transcribe(m, audio, **kw)
        torch.cuda.synchronize()
        calls.append((audio, time.perf_counter() - t0))
        return out

    tr.transcribe = timed
    try:
        yield calls
    finally:
        tr.transcribe = transcribe


LEADING_ZEROS_MS = 300  # digital silence before the first sample of each file


def _leading_zeros(model, opts: dict) -> dict:
    """How often the stale-max guard re-runs recordings that start with
    digital silence, and what it costs: the long-form slice's 16 noise files
    with LEADING_ZEROS_MS of zeros before each, streamed at the guard run's
    settings. Round 0's windows are normalized with chunk 0's max; a file
    whose max lies past its first 30 s then holds the zeros' -10 frames
    below its max - 8 and runs again."""
    from olmoasr_tpu_torch import transcribe as tr

    _, audios = _long_form_audios()
    lead = np.zeros(LEADING_ZEROS_MS * 16, np.float32)
    wavs = [np.concatenate([lead, a.numpy()]) for a in audios]
    before = tr.transcribe_many.stale_max_reruns
    with _timed_reruns() as reruns:
        t0 = time.perf_counter()
        results = tr.transcribe_many(model, wavs, batch_size=len(wavs), **opts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n_reruns = tr.transcribe_many.stale_max_reruns - before
    rerun_s = sum(t for _, t in reruns)
    late_max = 0
    for w in wavs:  # files whose loudest 30 s is not their first
        whole = tr.log_mel_spectrogram(w, model.dims.n_mels, device="cuda")
        late_max += int(whole[:, 3000:].max() > whole[:, :3000].max())
    print(f"  leading zeros: the long-form slice's {len(wavs)} files after "
          f"{LEADING_ZEROS_MS} ms of digital silence, streamed at the guard run's settings: "
          f"stale_max_reruns {n_reruns} of {len(wavs)} files ({late_max} have their max past "
          f"their first 30 s); wall {wall:.3f} s, of which the reruns {rerun_s:.3f} s "
          f"({rerun_s / wall:.1%})")
    if n_reruns != len(reruns):
        fail(f"leading zeros: {n_reruns} counted, {len(reruns)} transcribe calls")
    return {"files": len(wavs), "stale_max_reruns": n_reruns, "max_past_first_30s": late_max,
            "wall_s": wall, "rerun_s": rerun_s}


def phase_server_traffic() -> dict:
    """The server's default path in this process, where its launches can be
    counted: the port's BatchingService with ``serve.main``'s defaults (int8
    cross K/V, no beam, no best_of) and 8 requests of 12-26 s submitted at
    once. Windows decode greedily at t=0 and sample one row each above it, so
    every single-token step takes the fused self + cross launch."""
    from olmoasr_tpu_torch import build_model
    from olmoasr_tpu_torch.audio import SAMPLE_RATE
    from olmoasr_tpu_torch.serve import BatchingService
    from olmoasr_tpu_torch.transcribe import DEFAULT_TEMPERATURES

    model = build_model("small.en", seed=0, device="cuda", dtype=torch.bfloat16)
    dims = model.dims
    rng = np.random.default_rng(4)
    seconds = [12 + 2 * k for k in range(8)]
    audios = [torch.from_numpy((rng.standard_normal(s * SAMPLE_RATE) * 0.1).astype(np.float32))
              for s in seconds]
    defaults = {"kv_quant": True}  # serve.main without --no-kv-quant or --beam-size
    with BatchingService(model, max_batch=32, max_wait_ms=1000, default_options=defaults) as svc:
        svc.submit(audios[0], temperature=(0.0, 1.0)).result()  # warm-up; not counted
        windows_at = {}
        decode = model.decode

        def counting_decode(mel, options):
            windows_at[options.temperature] = windows_at.get(options.temperature, 0) + mel.shape[0]
            return decode(mel, options)

        model.decode = counting_decode
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        futures = [svc.submit(a) for a in audios]
        results = [f.result() for f in futures]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, steps = _read_counts()
        del model.decode
        stats = dict(svc.stats)
    audio_s = float(sum(seconds))
    print(f"server traffic in process: small.en bf16, int8 cross K/V, {len(audios)} requests, "
          f"{audio_s:.0f} s of audio: wall {wall:.3f} s, {audio_s / wall:.1f} audio-s/s, "
          f"{steps} single-token steps")
    print(f"  windows per temperature {windows_at}; stats {stats}; launches {counts}")
    if sorted(windows_at) != list(DEFAULT_TEMPERATURES):
        fail(f"server traffic: the ladder did not run whole: {windows_at}")
    _check_decode_counts("server traffic", counts, steps, dims.n_text_layer, route="sc")
    if stats["batches"] != 2:  # the warm-up, then the 8 requests as one batch
        fail(f"server traffic: {stats['batches'] - 1} batches for {len(audios)} requests")
    for k, r in enumerate(results):
        _check_transcript(f"server traffic request {k}", r)
    return {"requests": len(audios), "audio_s": audio_s, "wall_s": wall,
            "audio_s_per_s": audio_s / wall, "single_steps": steps,
            "windows_per_temperature": windows_at, "launches": counts}


ROUTE_WINDOWS, ROUTE_STEPS = 64, 224


def _route_loop(model, feats, prompt, route: str, rows: int, steps: int = ROUTE_STEPS,
                **cache_kw):
    """The JAX flag matrix's loop (tests/test_decode_flag_matrix.py, ``_run``)
    at full size: ``init_cache`` over the windows' features, a prefill of the
    prompt, then ``steps`` single-token steps along ``route``, each fed the
    argmax of the last; returns (wall s, last logits). A one-token prompt
    (small.en's, with timestamps) makes the prefill a single-token step too,
    along the same route."""
    from olmoasr_tpu_torch.models import whisper as model_mod

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache = model_mod.init_cache(model, feats, max_len=len(prompt) + steps,
                                 self_batch=rows, **cache_kw)
    tokens = torch.tensor([prompt] * rows, device=feats.device)
    logits = model_mod.decode_step(model, tokens, cache, route=route)[:, -1]
    for _ in range(steps):
        logits = model_mod.decode_step(model, logits.argmax(-1)[:, None], cache,
                                       route=route)[:, 0]
    torch.cuda.synchronize()
    return time.perf_counter() - t0, logits


def _profile_route_step(model, feats, prompt, route: str, rows: int, **cache_kw) -> dict:
    """One step of :func:`_route_loop` on the host clock against its kernels."""
    from olmoasr_tpu_torch.models import whisper as model_mod

    cache = model_mod.init_cache(model, feats, max_len=len(prompt) + 70, self_batch=rows,
                                 **cache_kw)
    tokens = torch.tensor([prompt] * rows, device=feats.device)
    state = {"logits": model_mod.decode_step(model, tokens, cache, route=route)[:, -1]}

    def step(i):
        t = state["logits"].argmax(-1)
        state["logits"] = model_mod.decode_step(model, t[:, None], cache, route=route)[:, 0]

    return _profile_step(f"{route}-route", step, len(prompt))


def _run_route(label: str, model, feats, prompt, route: str, rows: int, check_route: str,
               **cache_kw) -> dict:
    """:func:`_route_loop` with the launch counts read around it and checked
    against ``check_route``, then a profiled step."""
    L = model.dims.n_text_layer
    windows = feats.shape[0]
    _reset_counts()
    wall, logits = _route_loop(model, feats, prompt, route, rows, **cache_kw)
    counts, steps = _read_counts()
    print(f"  {label}: {steps} decode steps, wall {wall:.3f} s, "
          f"{windows * 30 / wall:.1f} audio-s/s, launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    if steps != ROUTE_STEPS + (len(prompt) == 1) or not bool(torch.isfinite(logits).all()):
        fail(f"{label}: {steps} single-token steps, finite logits "
             f"{bool(torch.isfinite(logits).all())}")
    _check_decode_counts(label, counts, steps, L, route=check_route,
                         int8_rings=cache_kw.get("quantize_self", False))
    return {"steps": steps, "wall_s": wall, "audio_s_per_s": windows * 30 / wall,
            "launches": counts,
            "step_profile": _profile_route_step(model, feats, prompt, route, rows, **cache_kw)}


def phase_routes() -> dict:
    """The decode step's kernel routes at small.en's full width and depth,
    bf16, seeded random weights, over 64 windows' encoder output:

    - int8 self rings (``init_cache(quantize_self=True)``) over an int8 cross
      cache, the JAX flag matrix's int8 case, beside the same loop with bf16
      rings (which takes the "sc" launch), then int8 rings with 5 rows over
      each of 32 windows (``self_batch``, as best_of decodes them);
    - over an int8 cross cache with bf16 rings, ``route`` = split, layer,
      attend and auto.

    Each loop: wall, audio-seconds per second, steps, every wrapper's
    launches (checked against the route), and a profiled step."""
    from olmoasr_tpu_torch import build_model
    from olmoasr_tpu_torch.audio import N_SAMPLES, log_mel_spectrogram
    from olmoasr_tpu_torch.decoding import DecodingOptions, _resolve_prompt, get_tokenizer
    from olmoasr_tpu_torch.models import whisper as model_mod

    model = build_model("small.en", seed=0, device="cuda", dtype=torch.bfloat16)
    audio = np.random.default_rng(7).standard_normal((ROUTE_WINDOWS, N_SAMPLES)) * 0.1
    with torch.no_grad():
        feats = model_mod.encode_audio(model, log_mel_spectrogram(
            torch.from_numpy(audio.astype(np.float32)).cuda()))
    prompt = _resolve_prompt(get_tokenizer(multilingual=False), DecodingOptions(language="en"))
    _route_loop(model, feats[:8], prompt, "auto", 8, steps=4, quantize_cross=True,
                quantize_self=True)  # warm-up; not counted
    B, K = ROUTE_WINDOWS, BEAM_SIZE
    out = {}
    print(f"int8 self rings: small.en bf16, int8 cross K/V, prefill + {ROUTE_STEPS} steps")
    out["int8 rings"] = _run_route("int8 rings, 64 windows", model, feats, prompt, "auto", B,
                                   "split", quantize_cross=True, quantize_self=True)
    out["bf16 rings"] = _run_route("bf16 rings, 64 windows", model, feats, prompt, "auto", B,
                                   "sc", quantize_cross=True)
    out["int8 rings best_of"] = _run_route(
        f"int8 rings, {B // 2} windows x {K} rows", model, feats[:B // 2], prompt, "auto",
        B // 2 * K, "split", quantize_cross=True, quantize_self=True)
    print(f"routes: small.en bf16, int8 cross K/V, bf16 rings, 64 windows, prefill + "
          f"{ROUTE_STEPS} steps")
    for route, check in (("split", "split"), ("layer", "layer"), ("attend", "attend"),
                         ("auto", "sc")):
        out[f"route {route}"] = _run_route(f"route {route}", model, feats, prompt, route, B,
                                           check, quantize_cross=True)
    return out


# ---------------------------------------------------------------------------
# phase 5
# ---------------------------------------------------------------------------

LOGIT_TOL = 2e-3  # fp32 on both sides; sums in another order, exp in another library


# (token rows per window, int8 cross K/V, int8 self rings, route, what the
# card's step runs)
TEACHER_FORCED = ((2, False, False, "auto", "split"), (1, True, False, "auto", "sc"),
                  (2, True, True, "split", "split"), (1, True, False, "layer", "layer"),
                  (1, True, False, "attend", "attend"))


def phase_teacher_forced() -> float:
    """The same weights and tokens through the port on the GPU (kernels) and
    on the CPU (plain twins), fp32: 2 windows x 2 token rows over the shared
    cross cache (the split kernels), then 2 windows x 1 row over an int8
    cross cache (the fused self + cross launch), which both sides take from
    the GPU's quantization so that they read the same int8 values; then 2
    windows x 2 rows over int8 self rings (the route split; before each CPU
    step the CPU's rings are set to the card's, since a key that lands on a
    rounding edge may quantize one int8 step apart on the two), and 2 windows
    x 1 row along the routes layer and attend, each against the CPU twin
    route."""
    from olmoasr_tpu_torch import build_model
    from olmoasr_tpu_torch.audio import N_SAMPLES, log_mel_spectrogram
    from olmoasr_tpu_torch.decoding import get_tokenizer
    from olmoasr_tpu_torch.models import whisper as model_mod

    B, steps = 2, 8
    rng = np.random.default_rng(1)
    audio = torch.from_numpy(rng.standard_normal((B, N_SAMPLES)).astype(np.float32) * 0.1)
    mel = log_mel_spectrogram(audio)
    sot = get_tokenizer(multilingual=False).sot
    models = {d: build_model("small.en", seed=0, device=d, dtype=torch.float32)
              for d in ("cuda", "cpu")}
    with torch.no_grad():
        feats = {d: model_mod.encode_audio(m, mel.to(d)) for d, m in models.items()}
    feat_err = max_err(feats["cuda"].cpu(), feats["cpu"])
    worst = 0.0
    for G, quantize, rings8, route, runs in TEACHER_FORCED:
        tokens = torch.from_numpy(rng.integers(0, 50000, (B * G, steps))).long()
        caches = {d: model_mod.init_cache(m, feats[d], max_len=1 + steps, self_batch=B * G,
                                          quantize_cross=quantize, quantize_self=rings8)
                  for d, m in models.items()}
        if quantize:
            for n in ("cross_k", "cross_v", "cross_k_scale", "cross_v_scale"):
                setattr(caches["cpu"], n, getattr(caches["cuda"], n).cpu())
        _reset_counts()
        logits = {d: [] for d in models}
        for i in range(steps):
            tok = torch.full((B * G, 1), sot) if i == 0 else tokens[:, i - 1:i]
            for d, m in models.items():
                if rings8 and d == "cpu":
                    caches["cpu"].self_kv.copy_(caches["cuda"].self_kv.cpu())
                    caches["cpu"].self_scale.copy_(caches["cuda"].self_scale.cpu())
                logits[d].append(model_mod.decode_step(m, tok.to(d), caches[d], route=route).cpu())
        _check_decode_counts(f"teacher-forced G={G} route {route}", _read_counts()[0], steps,
                             models["cuda"].dims.n_text_layer, route=runs, int8_rings=rings8)
        del caches
        err = max_err(torch.cat(logits["cuda"], dim=1), torch.cat(logits["cpu"], dim=1))
        scale = float(torch.cat(logits["cpu"], dim=1).abs().max())
        print(f"teacher-forced fp32 B={B} windows x {G} rows, "
              f"{'int8' if quantize else 'fp32'} cross K/V, {'int8' if rings8 else 'fp32'} "
              f"self rings, route {route} ({runs}), {steps} steps: audio features max_abs_err "
              f"{feat_err:.3e}, logits max_abs_err {err:.3e} (tol {LOGIT_TOL}, max |logit| "
              f"{scale:.2f})")
        if not err <= LOGIT_TOL:
            fail(f"teacher-forced logits disagree (G={G}, int8 {quantize}, int8 rings {rings8}, "
                 f"route {route}): {err} > {LOGIT_TOL}")
        worst = max(worst, err)
    return worst


def byte_vocabulary(model):
    """``model`` with its token embedding's text rows past the 256 byte
    tokens zeroed, in place. The offline tokenizer decodes only those bytes:
    a random model's other ids decode to nothing, so its segments would have
    no text and no words to time."""
    with torch.no_grad():
        model.decoder.token_embedding.weight[256:50256].zero_()
    model.drop_derived()
    return model


WORD_FILES, WORD_SILENCE_FILES = 4, 2  # files rerun with word timestamps; of them, with the
WORD_SILENCE_THRESHOLD = 2.0  # hallucination-silence heuristic at this threshold
FIRST_WORD_SHIFT_S = 1.4  # the start fixups may move a first word back by 2 x its 0.7 s cap
WORD_SAMPLE_LEN = 64  # the reruns' depth: tokens a window, cut from the CLI's 224


def _check_words(label: str, results, may_be_empty: bool = False) -> int:
    """Every segment has ``words``, each with start <= end inside the 30 s
    window the segment came from (its first word may start up to
    FIRST_WORD_SHIFT_S before it); returns the number of words. With
    ``may_be_empty`` a file may have no segment (the hallucination-silence
    heuristic may drop every one)."""
    n = 0
    for k, r in enumerate(results):
        if not (may_be_empty and isinstance(r, dict) and r.get("segments") == []):
            _check_transcript(f"{label} file {k}", r)
        for seg in r["segments"]:
            words = seg.get("words")
            if not isinstance(words, list):
                fail(f"{label} file {k}: a segment without words: {str(seg)[:300]}")
            lo, hi = seg["seek"] / 100 - FIRST_WORD_SHIFT_S, seg["seek"] / 100 + 30
            for w in words:
                if not (lo <= w["start"] <= w["end"] <= hi and np.isfinite(w["probability"])
                        and w["word"]):
                    fail(f"{label} file {k}: word {w} outside its window [{lo}, {hi}]")
            n += len(words)
    return n


def phase_word_timestamps() -> dict:
    """Word timestamps on the long-form slice: its first 4 files again
    through ``transcribe_many`` with ``word_timestamps=True``, then 2 of
    them also with ``hallucination_silence_threshold=2.0``, on small.en bf16
    with the text rows of its vocabulary cut to the byte tokens
    (:func:`byte_vocabulary`); beam 5 at t=0 alone, the CLI's decode with
    ``--temperature_increment_on_fallback None``, WORD_SAMPLE_LEN tokens a
    window (random weights never end a row early): the random weights fail
    the gates, and a sample at t > 0 lands on the zeroed rows' mass, whose
    ids the tokenizer decodes to nothing.
    The alignment re-encodes each consumed window (the encoder's attention
    kernel) and teacher-forces its tokens (the decoder's self and cross
    attention kernels) before ``cross_attention_weights`` and the host's
    DTW: the encoder attention's launches are counted against that."""
    from olmoasr_tpu_torch import build_model, timing, transcribe_many
    from olmoasr_tpu_torch.models import whisper as model_mod

    _, audios = _long_form_audios()
    model = byte_vocabulary(build_model("small.en", seed=0, device="cuda", dtype=torch.bfloat16))
    dims = model.dims
    walls = {}
    calls = {"decode": 0, "align": 0}
    orig = {"add": timing.add_word_timestamps, "weights": model_mod.cross_attention_weights}
    decode = model.decode

    def timed_call(key, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            walls[key] = walls.get(key, 0.0) + time.perf_counter() - t0
            return out
        return run

    def weights(*args, **kwargs):
        calls["align"] += 1
        return orig["weights"](*args, **kwargs)

    def counting_decode(mel, options):
        calls["decode"] += 1
        return decode(mel, options)

    timing.add_word_timestamps = timed_call("align", orig["add"])
    model_mod.cross_attention_weights = weights
    model.decode = timed_call("decode", counting_decode)
    runs = {}
    try:
        for label, n, extra in (("words", WORD_FILES, {}),
                                ("words + silence", WORD_SILENCE_FILES,
                                 {"hallucination_silence_threshold": WORD_SILENCE_THRESHOLD})):
            walls.clear()
            calls.update(decode=0, align=0)
            _reset_counts()
            t0 = time.perf_counter()
            results = transcribe_many(model, audios[:n], batch_size=n, beam_size=5,
                                      temperature=0.0, sample_len=WORD_SAMPLE_LEN,
                                      word_timestamps=True, **extra)
            wall = time.perf_counter() - t0
            counts, _ = _read_counts()
            n_words = _check_words(label, results, may_be_empty=bool(extra))
            per_file = [sum(len(seg["words"]) for seg in r["segments"]) for r in results]
            want = dims.n_audio_layer * (calls["decode"] + calls["align"]) \
                + 2 * dims.n_text_layer * calls["align"]
            print(f"word timestamps ({label}{', threshold 2.0' if extra else ''}): small.en bf16, "
                  f"{n} long-form files, beam 5 at t=0, {WORD_SAMPLE_LEN} tokens a window: wall "
                  f"{wall:.3f} s, of it the "
                  f"decode {walls.get('decode', 0.0):.3f} s in {calls['decode']} calls and "
                  f"add_word_timestamps {walls.get('align', 0.0):.3f} s over {calls['align']} "
                  f"windows; words per file {per_file}; encoder + alignment attention launches "
                  f"{counts['train_attention_fwd']} (expected {want})")
            if counts["train_attention_fwd"] != want or not calls["align"]:
                fail(f"word timestamps ({label}): {counts['train_attention_fwd']} attention "
                     f"launches, expected {want} for {calls['decode']} decodes and "
                     f"{calls['align']} alignments")
            if not n_words and not extra:
                fail(f"word timestamps ({label}): no words in {n} files")
            runs[label] = {"wall_s": wall, "decode_s": walls.get("decode", 0.0),
                           "align_s": walls.get("align", 0.0), "alignments": calls["align"],
                           "words_per_file": per_file, "launches": counts}
    finally:
        timing.add_word_timestamps = orig["add"]
        model_mod.cross_attention_weights = orig["weights"]
        del model.decode
    return runs


ALIGN_PROB_TOL = 1e-5  # a word's mean token probability, card against CPU at fp32


def phase_alignment_fp32() -> dict:
    """``timing.find_alignment`` at fp32 on the card (the kernels) and on
    the CPU (their plain twins) for the same window and text: small.en's
    seeded weights, 30 s of noise of which 24 s are audio, 25 words of
    byte tokens. Words and times must be equal, probabilities within
    ALIGN_PROB_TOL."""
    from olmoasr_tpu_torch import build_model, timing
    from olmoasr_tpu_torch.audio import N_SAMPLES, log_mel_spectrogram
    from olmoasr_tpu_torch.models.dims import VARIANT_TO_DIMS
    from olmoasr_tpu_torch.tokenizer import get_tokenizer

    tok = get_tokenizer(False)
    rng = np.random.default_rng(12)
    mel = log_mel_spectrogram(torch.from_numpy(
        (rng.standard_normal(N_SAMPLES) * 0.1).astype(np.float32)))
    text = tok.encode(" " + " ".join(rng.choice(WORDS, 25)) + ".")
    got, walls = {}, {}
    for device in ("cuda", "cpu"):
        model = build_model("small.en", seed=0, device=device, dtype=torch.float32)
        _reset_counts()
        t0 = time.perf_counter()
        got[device] = timing.find_alignment(model, tok, text, mel, 2400)
        walls[device] = time.perf_counter() - t0
        if device == "cuda":
            launches = _read_counts()[0]["train_attention_fwd"]
        del model
    card, cpu = got["cuda"], got["cpu"]
    prob_err = max((abs(a.probability - b.probability) for a, b in zip(card, cpu)), default=0.0)
    same = [(w.word, w.tokens, w.start, w.end) for w in card] == \
        [(w.word, w.tokens, w.start, w.end) for w in cpu]
    print(f"find_alignment fp32, small.en, {len(text)} tokens over 24 s: {len(card)} words, "
          f"the card's {'equal to' if same else 'DIFFERENT from'} the CPU's in words and times, "
          f"probabilities max_abs_err {prob_err:.3e} (tol {ALIGN_PROB_TOL}); wall "
          f"{walls['cuda']:.3f} s on the card ({launches} attention launches), "
          f"{walls['cpu']:.3f} s on the CPU")
    dims = VARIANT_TO_DIMS["small.en"]
    if launches != dims.n_audio_layer + 2 * dims.n_text_layer:
        fail(f"find_alignment: {launches} attention launches on the card")
    if not same or len(card) < 20:
        diff = [(a.word, a.start, b.start, a.end, b.end) for a, b in zip(card, cpu)
                if (a.word, a.start, a.end) != (b.word, b.start, b.end)]
        fail(f"find_alignment: the card's words differ from the CPU's: {diff[:10]}")
    if not prob_err <= ALIGN_PROB_TOL:
        fail(f"find_alignment: probabilities {prob_err} apart (tol {ALIGN_PROB_TOL})")
    return {"words": len(card), "prob_err": prob_err, "wall_s": walls, "launches": launches}


LANG_PROB_TOL = 1e-4  # a language's probability, card against CPU at fp32


def phase_language() -> dict:
    """Language detection on a seeded multilingual model: small.en's dims
    with the multilingual vocabulary (51865), fp32 on the card and on the
    CPU. ``detect_language`` on 1 and on 8 windows of noise, one
    single-token step each (the split route's kernels, in fp32), language
    ids equal to the CPU's; then ``transcribe_many``
    with ``language=None`` on one 40 s file in bf16, which must transcribe
    in the language detected in its first 30 s."""
    import dataclasses

    from olmoasr_tpu_torch import transcribe_many
    from olmoasr_tpu_torch.api import _new_model
    from olmoasr_tpu_torch.audio import N_FRAMES, N_SAMPLES, log_mel_spectrogram
    from olmoasr_tpu_torch.models.dims import VARIANT_TO_DIMS
    from olmoasr_tpu_torch.models.whisper import init_params

    dims = dataclasses.replace(VARIANT_TO_DIMS["small.en"], n_vocab=51865)
    models = {}
    for device in ("cuda", "cpu"):
        model = _new_model(dims, False, device, torch.float32)
        init_params(model, torch.Generator().manual_seed(0))
        models[device] = model.eval()
    if not models["cuda"].is_multilingual:
        fail("language detection: the model is not multilingual")
    rng = np.random.default_rng(13)
    mel = log_mel_spectrogram(torch.from_numpy(
        (rng.standard_normal((8, N_SAMPLES)) * 0.1).astype(np.float32)))
    out = {}
    for B in (1, 8):
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids, probs = models["cuda"].detect_language(mel[:B].cuda())
        wall = time.perf_counter() - t0
        counts, steps = _read_counts()
        _check_decode_counts(f"detect_language B={B}", counts, 1, dims.n_text_layer)
        want_ids, want_probs = models["cpu"].detect_language(mel[:B])
        err = max(abs(p[c] - q[c]) for p, q in zip(probs, want_probs) for c in q)
        top = [sorted(p.values())[-2:] for p in want_probs]
        print(f"detect_language fp32, multilingual small.en, B={B}: wall {wall:.3f} s, "
              f"{steps} single-token step; languages {ids.tolist()} on the card, "
              f"{want_ids.tolist()} on the CPU; probabilities max_abs_err {err:.3e} (tol "
              f"{LANG_PROB_TOL}); the CPU's top two apart by at least "
              f"{min(b - a for a, b in top):.3e}")
        if not torch.equal(ids, want_ids) or not err <= LANG_PROB_TOL:
            fail(f"detect_language B={B}: ids {ids.tolist()} against {want_ids.tolist()}, "
                 f"probabilities {err} apart")
        out[f"B={B}"] = {"wall_s": wall, "prob_err": err, "launches": counts}
    del models["cpu"]
    model = models["cuda"].half()
    audio = torch.from_numpy((rng.standard_normal(40 * 16000) * 0.1).astype(np.float32))
    first = log_mel_spectrogram(audio, padding=N_SAMPLES, device="cuda")[:, :N_FRAMES]
    _, probs = model.detect_language(first)
    expect = max(probs, key=probs.get)
    t0 = time.perf_counter()
    (result,) = transcribe_many(model, [audio], temperature=0.0, sample_len=32)
    wall = time.perf_counter() - t0
    _check_transcript("transcribe_many language=None", result)
    print(f"  transcribe_many(language=None) on 40 s, multilingual small.en bf16: language "
          f"{result['language']!r} (detected alone: {expect!r}), {len(result['segments'])} "
          f"segments, wall {wall:.3f} s")
    if result["language"] != expect:
        fail(f"transcribe_many detected {result['language']!r}, detect_language {expect!r}")
    out["transcribe_s"] = wall
    return out


# ---------------------------------------------------------------------------
# phase 6: the training slice
# ---------------------------------------------------------------------------

WORDS = ("the", "of", "and", "to", "in", "speech", "model", "audio", "train", "token", "window",
         "small", "noise", "seed", "card", "step")


def _vtt(rng, seconds: float) -> str:
    """1-12 cues of seeded words spread over the clip."""
    n = int(rng.integers(1, 13))
    edges = np.sort(rng.uniform(0, seconds, 2 * n))
    cues = []
    for a, b in edges.reshape(n, 2):
        ts = lambda s: f"{int(s // 3600):02d}:{int(s // 60 % 60):02d}:{s % 60:06.3f}"
        cues.append(f"{ts(a)} --> {ts(b)}\n{' '.join(rng.choice(WORDS, int(rng.integers(1, 9))))}\n")
    return "WEBVTT\n\n" + "\n".join(cues)


def write_shards(root: str, n: int = 64, seed: int = 5) -> str:
    """n samples of seeded int16 noise of 5-30 s with VTT transcripts, as
    the JAX package's loader reads them (audio .npy + a gzip JSONL shard)."""
    import gzip

    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        seconds = float(rng.uniform(5, 30))
        path = os.path.join(root, f"a{i}.npy")
        np.save(path, (rng.standard_normal(int(16000 * seconds)) * 2000).astype(np.int16))
        rows.append({"audio_file": path, "transcript": _vtt(rng, seconds), "ext": "vtt"})
    shard = os.path.join(root, "shard0.jsonl.gz")
    with gzip.open(shard, "wt") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows)
    return shard


# 8 steps of data: the loader builds batches through every step the smoke runs,
# as it does in a real run (its epoch never ends inside the window)
TRAIN_SAMPLES, TRAIN_MICRO, TRAIN_BATCH, TRAIN_STEPS = 256, 16, 32, 6
TRAIN_STEPS_FLASH = 3  # the flash route's run: the steps cut, not the width or depth
# (the flash route's bf16 kernels are the mma kernels under the flash policy,
# told apart from the kernel route's by the phase that profiles them; its
# backward's di pass is flash_di_kernel; the flash_*_kernel ones are its fp32)
ATTN_KERNELS = ("attn_fwd_mma_kernel", "attn_bwd_dq_mma_kernel", "attn_bwd_dkv_mma_kernel",
                "attn_fwd_f32_kernel", "attn_bwd_dq_kernel", "attn_bwd_dkv_kernel",
                "flash_di_kernel", "flash_fwd_kernel", "flash_bwd_dq_kernel",
                "flash_bwd_dkv_kernel")
# the attention wrappers of each training route: (forward, backward)
TRAIN_ROUTES = {"kernel": ("train_attention_fwd", "train_attention_bwd"),
                "flash": ("flash_mha_fwd", "flash_mha_bwd")}


class LoaderWatch:
    """Wraps ``AudioTextDataset.__getitem__``, the loader's work for one
    sample (audio, log-mel, tokens, on its worker threads), to record when it
    ran; ``pause`` holds new samples back and waits for those in flight, so
    that one step can run with the loader quiet."""

    def __init__(self, dataset_cls):
        self.cls, self.orig = dataset_cls, dataset_cls.__getitem__
        self.spans: list = []
        self.lock = threading.Lock()
        self.paused, self.inflight = False, 0

    def __enter__(self):
        def getitem(dataset, index):
            while True:
                with self.lock:
                    if not self.paused:
                        self.inflight += 1
                        break
                time.sleep(0.002)
            t0 = time.perf_counter()
            try:
                return self.orig(dataset, index)
            finally:
                with self.lock:
                    self.inflight -= 1
                    self.spans.append((t0, time.perf_counter()))

        self.cls.__getitem__ = getitem
        return self

    def __exit__(self, *exc):
        self.resume()
        self.cls.__getitem__ = self.orig

    def pause(self):
        with self.lock:
            self.paused = True
        while True:
            with self.lock:
                if not self.inflight:
                    return
            time.sleep(0.002)

    def resume(self):
        with self.lock:
            self.paused = False

    def busy_s(self, t0: float, t1: float) -> float:
        """Seconds of [t0, t1] in which the loader was building a sample."""
        with self.lock:
            spans = sorted((max(a, t0), min(b, t1)) for a, b in self.spans if b > t0 and a < t1)
        total, end = 0.0, t0
        for a, b in spans:
            if b > end:
                total += b - max(a, end)
                end = b
        return total


def phase_training(attention: str = "kernel", n_steps: int = TRAIN_STEPS,
                   device_mel: bool = False, keep_params_after: int = 0) -> dict:
    """small.en at full width and depth (768 wide, 12 + 12 layers, 1500 / 448
    positions) through ``train_loop.main(attention=..., device_mel=...)`` on the card: 256
    samples, micro batch 16, effective batch 32 (2 micro-batches a step),
    remat, ``n_steps`` steps, then a resumed run of 1 step. Each step is
    wrapped to read the attention kernels' launches (those of the route, and
    none of the other's), the parameters and its start and end; the loader's
    per-sample work is watched (:class:`LoaderWatch`). Step 1 is the
    warm-up; steps 2 to n_steps - 1 are the window, timed end to end with the
    loader's waits; step n_steps runs with the loader held back, so its wall
    against the window's says what the loader's threads cost the step; the
    resumed step runs under the profiler, for the kernels' device time.
    With ``device_mel`` the loader ships int16 PCM and the step computes the
    log-mel; step 1's first micro-batch of PCM is kept (``pcm``). With
    ``keep_params_after`` (a step's number) the parameters after that step
    are kept on the host (``params``)."""
    import statistics as stats

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from olmoasr_tpu_torch.models.dims import VARIANT_TO_DIMS
    from olmoasr_tpu_torch.models.whisper import PADDING_TOKEN
    from olmoasr_tpu_torch.training import dataset as dataset_mod
    from olmoasr_tpu_torch.training import train as train_mod
    from olmoasr_tpu_torch.training import train_loop

    dims = VARIANT_TO_DIMS["small.en"]
    make_step = train_mod.make_train_step
    fwd_name, bwd_name = TRAIN_ROUTES[attention]
    others = [n for route in TRAIN_ROUTES.values() for n in route if n not in (fwd_name, bwd_name)]
    steps: list = []
    profiled: dict = {}
    initial: list = []

    def watched(dims_, config, mesh=None):
        step_fn = make_step(dims_, config, mesh)

        def step(state, batch):
            kernels, _ = _counters()
            n = state.step + 1
            if n == 1:
                initial.extend(p.detach().clone() for p in state.model.parameters())
                if device_mel:
                    profiled["pcm"] = batch["mel"][0].clone()
            quiet = n == n_steps
            if quiet:
                watch.pause()
            try:
                _reset_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if n == n_steps + 1:
                    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                        state, metrics = step_fn(state, batch)
                        torch.cuda.synchronize()
                    # kernels only: the optimizer's record_function range shows on
                    # the device's timeline too, over kernels that are counted already
                    profiled["events"] = [
                        (e.name, e.time_range.elapsed_us()) for e in prof.events()
                        if e.device_type == DeviceType.CUDA and "#" not in e.name
                        and not getattr(e, "is_user_annotation", False)]
                else:
                    state, metrics = step_fn(state, batch)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
            finally:
                if quiet:
                    watch.resume()
            row = {"step": state.step, "t0": t0, "t1": t1, "wall_s": t1 - t0,
                   "loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
                   "lr": float(metrics["lr"]),
                   "fwd": kernels[fwd_name].launches, "bwd": kernels[bwd_name].launches,
                   "other": {k: kernels[k].launches for k in others},
                   "tokens": int((batch["text_target"] != PADDING_TOKEN).sum()), "quiet": quiet}
            same = lambda: all(torch.equal(a, p) for a, p in
                               zip(initial, state.model.parameters()))
            if n == keep_params_after:
                profiled["params"] = {k: p.detach().cpu()
                                      for k, p in state.model.named_parameters()}
            if n == 1:
                row["unchanged"] = same()
            elif n == 2:
                row["changed"] = not same()
                initial.clear()
            steps.append(row)
            return state, metrics

        return step

    here = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp, LoaderWatch(dataset_mod.AudioTextDataset) as watch:
        shards = write_shards(tmp, n=TRAIN_SAMPLES)
        kwargs = dict(variant="small.en", train_shards=shards, exp_name=f"smoke_{attention}",
                      micro_batch_size=TRAIN_MICRO, eff_batch_size=TRAIN_BATCH, remat=True,
                      ckpt_dir=os.path.join(tmp, "ckpt"), ckpt_every=0, log_every=1,
                      device="cuda", attention=attention, device_mel=device_mel)
        train_mod.make_train_step = watched
        os.chdir(tmp)  # the metrics logger writes logs/ under the working directory
        try:
            torch.cuda.reset_peak_memory_stats()
            start = time.perf_counter()
            first = train_loop.main(**kwargs, max_steps_this_run=n_steps)
            peak = torch.cuda.max_memory_allocated()
            resumed = train_loop.main(**kwargs, max_steps_this_run=1)
        finally:
            train_mod.make_train_step = make_step
            os.chdir(here)
        # the gap before a step: the loader's wait and the batch's copy to the
        # card (before step 1: the set-up, the model's init and the first batch)
        for prev_end, row in zip([start] + [r["t1"] for r in steps], steps[:n_steps]):
            row["gap_s"] = row["t0"] - prev_end
        for row in steps:
            row["loader_busy_s"] = watch.busy_s(row["t0"], row["t1"])
        sample_s = [b - a for a, b in watch.spans]
    for row in steps:
        print(f"  step {row['step']}: loss {row['loss']:.4f} grad_norm {row['grad_norm']:.4f} "
              f"lr {row['lr']:.3e} wall {row['wall_s']:.3f} s"
              + (f" after a gap of {row['gap_s']:.3f} s" if "gap_s" in row else "")
              + f", the loader busy {row['loader_busy_s']:.3f} s of it"
              + (" (held back)" if row["quiet"] else "")
              + f"; {attention} attention launches {row['fwd']} forward {row['bwd']} "
                f"backward, {row['tokens']} target tokens")
    label = f"training ({attention} attention{', device_mel' if device_mel else ''})"
    if [r["step"] for r in steps] != list(range(1, n_steps + 2)):
        fail(f"{label}: steps {[r['step'] for r in steps]}, expected 1-{n_steps + 1}")
    if first["global_step"] != n_steps or resumed["global_step"] != n_steps + 1:
        fail(f"{label}: global steps {first['global_step']} then {resumed['global_step']}; "
             f"the resumed run must continue at step {n_steps + 1}")
    micro = TRAIN_BATCH // TRAIN_MICRO
    for row in steps:
        if not (np.isfinite(row["loss"]) and np.isfinite(row["grad_norm"])):
            fail(f"{label}: step {row['step']} loss {row['loss']} grad_norm {row['grad_norm']}")
        # per micro-batch: 36 attention forwards, 36 more in the remat
        # recompute, 36 backwards (12 encoder, 12 self, 12 cross)
        want = (micro * 72, micro * 36)
        if (row["fwd"], row["bwd"]) != want or any(row["other"].values()):
            fail(f"{label}: step {row['step']} attention launches {(row['fwd'], row['bwd'])}, "
                 f"expected {want}, and the other route's {row['other']}, expected none")
    if not steps[0]["unchanged"] or steps[0]["lr"] != 0.0:
        fail(f"{label}: step 1 (lr 0) changed the parameters")
    if not steps[1]["changed"]:
        fail(f"{label}: step 2 left the parameters as they were")

    window = steps[1:n_steps - 1]
    window_s = window[-1]["t1"] - steps[0]["t1"]
    per_step = window_s / len(window)
    wall = stats.median(r["wall_s"] for r in window)
    quiet_wall = steps[n_steps - 1]["wall_s"]
    flops = train_mod.train_flops_per_sample(dims) * TRAIN_BATCH
    by_kernel: dict = {}
    for name, us in profiled.get("events", []):
        base = _kernel_base_name(name)
        by_kernel[base] = by_kernel.get(base, 0.0) + us / 1e3
    kernel_ms = sum(by_kernel.values())
    attn_ms = {k: v for k, v in by_kernel.items() if k in ATTN_KERNELS}
    # the profiler slows the host of its step many times over, not the
    # device: the idle shares set the profiled step's kernel time against the
    # window's time a step, and against the wall of the step run quiet
    idle = 1 - kernel_ms / 1e3 / per_step if kernel_ms else None
    idle_quiet = 1 - kernel_ms / 1e3 / quiet_wall if kernel_ms else None
    out = {"warmup_step_s": steps[0]["wall_s"], "setup_s": steps[0]["gap_s"],
           "window_s": window_s, "window_steps": len(window), "window_step_s": per_step,
           "audio_s_per_s": TRAIN_BATCH * 30 / per_step,
           "tokens_per_s": sum(r["tokens"] for r in window) / window_s,
           "step_wall_s": wall, "quiet_step_wall_s": quiet_wall,
           "loader_sample_s": stats.median(sample_s), "loader_samples": len(sample_s),
           "peak_memory_gb": peak / 1e9,
           "flops_share": flops / per_step / PEAK_OPS_PER_S[torch.bfloat16],
           "attention_ms_per_step": attn_ms, "kernel_ms_per_step": kernel_ms or None,
           "device_idle": idle, "device_idle_quiet": idle_quiet,
           "profiled_step_wall_s": steps[-1]["wall_s"], "steps": steps,
           "launches": {fwd_name: steps[1]["fwd"], bwd_name: steps[1]["bwd"]},
           "pcm": profiled.get("pcm"), "params": profiled.get("params")}
    print(f"{label}: small.en bf16, micro batch {TRAIN_MICRO} x {micro}, remat: set-up "
          f"{out['setup_s']:.3f} s, warm-up step {out['warmup_step_s']:.3f} s; steps 2-"
          f"{n_steps - 1} with the loader's waits {window_s:.3f} s = {per_step:.3f} s a step, "
          f"{out['audio_s_per_s']:.1f} audio-s/s, {out['tokens_per_s']:.0f} target tokens/s, "
          f"{flops / 1e12:.1f} TFLOP a step = {100 * out['flops_share']:.1f}% of 989 TFLOP/s; "
          f"in-step wall {wall:.3f} s (median), {quiet_wall:.3f} s with the loader held back; "
          f"the loader {out['loader_sample_s'] * 1e3:.1f} ms a sample (median of "
          f"{len(sample_s)}); peak memory {out['peak_memory_gb']:.2f} GB")
    if kernel_ms:
        print(f"  profiled step {n_steps + 1} (wall {steps[-1]['wall_s']:.3f} s under the "
              f"profiler): kernels {kernel_ms:.1f} ms, so the device is idle {100 * idle:.1f}% "
              f"of the window's step and {100 * idle_quiet:.1f}% of the quiet step; attention "
              f"kernels " + ", ".join(f"{k} {v:.1f} ms" for k, v in attn_ms.items()))
        for name, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]:
            print(f"    {name}: {ms:.2f} ms")
    else:
        print("  the profiler recorded no device events: attention kernel time not measured")
    return out


TRAIN_STEPS_MEL = 3  # the device_mel run: the steps cut, not the width or depth
MEL_TOL = 1e-4  # the card's log-mel against the host's NumPy one; log10 units / 4
MEL_LOSS_TOL = 5e-3  # step 1's loss from PCM against the host mel's, relative; bf16 compute


def phase_training_device_mel(host: dict) -> dict:
    """The training slice of ``phase_training`` with ``device_mel``: the
    loader ships each sample's 30 s of int16 PCM, the step computes the
    log-mel on the card (``train.loss_fn``); 3 steps and a resumed fourth,
    printed beside the host-mel run ``host`` of this process. One
    micro-batch's log-mel from the card against the host's
    ``log_mel_spectrogram_np`` on the same PCM, and step 1's loss against
    the host-mel run's on the same batch (the same seeds)."""
    from olmoasr_tpu_torch.audio import log_mel_spectrogram, log_mel_spectrogram_np

    out = phase_training(n_steps=TRAIN_STEPS_MEL, device_mel=True, keep_params_after=2)
    pcm = out.pop("pcm")
    if pcm is None or pcm.dtype != torch.int16 or tuple(pcm.shape) != (TRAIN_MICRO, 480000):
        fail(f"device_mel: the batch's PCM is {None if pcm is None else (pcm.dtype, pcm.shape)}")
    with torch.no_grad():
        got = log_mel_spectrogram(pcm, 80).cpu().numpy()
    want = log_mel_spectrogram_np(pcm.cpu().numpy().astype(np.float32) / 32768.0)
    mel_err = float(np.abs(got - want).max())
    loss, host_loss = out["steps"][0]["loss"], host["steps"][0]["loss"]
    loss_err = abs(loss - host_loss) / abs(host_loss)
    def idle(run):
        return "not measured" if run["device_idle"] is None else f"{100 * run['device_idle']:.1f}%"

    print(f"training device_mel beside host mel (the same process; small.en, micro batch "
          f"{TRAIN_MICRO} x {TRAIN_BATCH // TRAIN_MICRO}): window step "
          f"{out['window_step_s']:.3f} s against {host['window_step_s']:.3f} s; in-step wall "
          f"{out['step_wall_s']:.3f} s against {host['step_wall_s']:.3f} s, the loader busy "
          f"{out['steps'][1]['loader_busy_s']:.3f} s against "
          f"{host['steps'][1]['loader_busy_s']:.3f} s of step 2; held back "
          f"{out['quiet_step_wall_s']:.3f} s against {host['quiet_step_wall_s']:.3f} s; the loader "
          f"{out['loader_sample_s'] * 1e3:.1f} ms a sample against "
          f"{host['loader_sample_s'] * 1e3:.1f} ms; device idle {idle(out)} against "
          f"{idle(host)} of the window's step; peak memory {out['peak_memory_gb']:.2f} GB against "
          f"{host['peak_memory_gb']:.2f} GB")
    print(f"  one micro-batch's log-mel ({TRAIN_MICRO} x 480000 int16) on the card against "
          f"log_mel_spectrogram_np: max_abs_err {mel_err:.3e} (tol {MEL_TOL}); step 1 loss "
          f"{loss:.6f} from PCM, {host_loss:.6f} from the host mel: relative {loss_err:.2e} "
          f"(tol {MEL_LOSS_TOL})")
    if not mel_err <= MEL_TOL:
        fail(f"device_mel: the card's log-mel is {mel_err} from the host's (tol {MEL_TOL})")
    if not loss_err <= MEL_LOSS_TOL:
        fail(f"device_mel: step 1's loss {loss} from PCM, {host_loss} from the host mel")
    out["mel_max_abs_err"], out["loss_rel_err"] = mel_err, loss_err
    return out


GRAD_DIMS = dict(n_mels=80, n_audio_ctx=1500, n_audio_state=256, n_audio_head=4,
                 n_audio_layer=2, n_vocab=51864, n_text_ctx=448, n_text_state=256,
                 n_text_head=4, n_text_layer=2)
LOSS_TOL, GRAD_TOL = 1e-4, 1e-3  # relative to the loss, to the largest gradient
FLASH_GRAD_TOL = 1e-4  # the flash route rounds nothing in fp32


def phase_training_flash() -> dict:
    """:func:`phase_training` on the flash route, TRAIN_STEPS_FLASH steps."""
    return phase_training("flash", TRAIN_STEPS_FLASH)


DIST_STEPS = 3  # each torchrun run: steps 1-3 (step 3 with the loader held back) + 1 profiled
# world 2 on the one card: NCCL refuses two ranks on one device ("Duplicate GPU
# detected"); gloo carries FSDP2's all-gathers and reduce-scatters of CUDA
# tensors, but DTensor's functional collectives (``full_tensor``, which the
# checkpoint's full-state gather uses) crash on it (SIGSEGV in wait_tensor,
# torch 2.11.0+cu128; ``python -m olmoasr_tpu_torch.perf.probe_ranks``):
# these runs gather step 2's parameters with c10d all-gathers and skip the
# checkpoint's save
DIST_WORLD2 = ("full", "grad_op")
# world 1 (DDP, NCCL) against the one-device run: each parameter after step 2
# within DDP1_ULPS units in the last place of the largest element of its tensor
DDP1_ULPS = 2
# world 2 against world 1: step 2's update (the parameters' move from their
# seeded start), its difference in L2 against its L2 (bf16 compute over
# other per-rank micro-batch shapes)
UPDATE_TOL = 0.1


def _train_rank(job_path: str) -> None:
    """One rank of a torchrun run of ``phase_training_distributed``: for
    each run of the job, ``train_loop.main`` for DIST_STEPS + 1 steps, each
    step wrapped to read its wall (synchronised), loss, grad norm, lr and
    the attention launches in this process; step 2's parameters gathered
    and written by rank 0, step DIST_STEPS with the loader held back, the
    last step under the profiler on rank 0. A job with ``backend`` "gloo"
    joins a gloo group here, which ``main`` then uses (two ranks on one
    card, see DIST_WORLD2); else each ``main`` joins torchrun's group with
    NCCL. Each rank writes its runs' rows to ``out_dir/rank<r>.json``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from olmoasr_tpu_torch.models.whisper import PADDING_TOKEN
    from olmoasr_tpu_torch.training import checkpoint as ckpt_mod
    from olmoasr_tpu_torch.training import dataset as dataset_mod
    from olmoasr_tpu_torch.training import train as train_mod
    from olmoasr_tpu_torch.training import train_loop

    with open(job_path) as f:
        job = json.load(f)
    rank = int(os.environ["RANK"])
    gloo = job["backend"] == "gloo"
    if gloo:
        torch.cuda.set_device(0)
        torch.distributed.init_process_group("gloo")
    make_step, save = train_mod.make_train_step, ckpt_mod.CheckpointManager.save
    runs = []
    try:
        for i, kwargs in enumerate(job["runs"]):
            fwd_name, bwd_name = TRAIN_ROUTES[kwargs["attention"]]
            rows: list = []
            events: list = []

            def watched(dims_, config, mesh=None):
                step_fn = make_step(dims_, config, mesh)

                def step(state, batch):
                    kernels, _ = _counters()
                    n = state.step + 1
                    quiet = n == DIST_STEPS
                    if quiet:
                        watch.pause()
                    try:
                        _reset_counts()
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        if n == DIST_STEPS + 1 and rank == 0:
                            with profile(activities=[ProfilerActivity.CPU,
                                                     ProfilerActivity.CUDA]) as prof:
                                state, metrics = step_fn(state, batch)
                                torch.cuda.synchronize()
                            events.extend(
                                (e.name, e.time_range.elapsed_us()) for e in prof.events()
                                if e.device_type == DeviceType.CUDA and "#" not in e.name
                                and not getattr(e, "is_user_annotation", False))
                        else:
                            state, metrics = step_fn(state, batch)
                        torch.cuda.synchronize()
                        t1 = time.perf_counter()
                    finally:
                        if quiet:
                            watch.resume()
                    rows.append({"step": state.step, "t0": t0, "t1": t1, "wall_s": t1 - t0,
                                 "loss": float(metrics["loss"]),
                                 "grad_norm": float(metrics["grad_norm"]),
                                 "lr": float(metrics["lr"]), "fwd": kernels[fwd_name].launches,
                                 "bwd": kernels[bwd_name].launches, "quiet": quiet,
                                 "tokens": int((batch["text_target"] != PADDING_TOKEN).sum())})
                    if n == 2:  # every rank gathers, rank 0 writes
                        params = (_gather_c10d(state.model) if gloo
                                  else ckpt_mod.model_state_dict(state))
                        if rank == 0:
                            torch.save(params, os.path.join(job["out_dir"], f"params{i}.pt"))
                    return state, metrics

                return step

            train_mod.make_train_step = watched
            if gloo:  # see DIST_WORLD2
                ckpt_mod.CheckpointManager.save = lambda *a, **kw: None
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with LoaderWatch(dataset_mod.AudioTextDataset) as watch:
                train_loop.main(**kwargs, max_steps_this_run=DIST_STEPS + 1)
            runs.append({"rows": rows, "events": events, "wall_s": time.perf_counter() - t0,
                         "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
    finally:
        train_mod.make_train_step, ckpt_mod.CheckpointManager.save = make_step, save
        if torch.distributed.is_initialized():  # the gloo group made here
            torch.distributed.destroy_process_group()
    with open(os.path.join(job["out_dir"], f"rank{rank}.json"), "w") as f:
        json.dump({"rank": rank, "runs": runs}, f)


def _gather_c10d(model) -> dict:
    """The FSDP2-sharded model's full parameters on the host, through c10d
    all-gathers of each parameter's dim-0 shard (``torch.chunk``'s split,
    padded to equal shards), not DTensor's functional collectives (see
    DIST_WORLD2)."""
    from olmoasr_tpu_torch.training import train as train_mod

    world = torch.distributed.get_world_size()
    out = {}
    with torch.no_grad():
        for name, p in train_mod.unwrap(model).named_parameters():
            local = p.to_local()
            rows = -(-p.shape[0] // world)
            shard = local.new_zeros((rows, *p.shape[1:]))
            shard[:local.shape[0]] = local
            full = local.new_empty((rows * world, *p.shape[1:]))
            torch.distributed.all_gather_into_tensor(full, shard)
            out[name] = full[:p.shape[0]].cpu()
    return out


def _torchrun(label: str, world: int, job: dict, tmp: str) -> list:
    """``job`` (``main``'s arguments of each run and the backend) on
    ``world`` ranks of this card through one torchrun of
    :func:`_train_rank`; for each run, every rank's result, rank 0's first,
    and the path of step 2's parameters. Fails on a failed rank."""
    out_dir = os.path.join(tmp, label)
    os.makedirs(out_dir)
    wall = _launch("--train-rank", {**job, "out_dir": out_dir},
                   os.path.join(out_dir, "job.json"), world, tmp)
    print(f"[{label}: torchrun of {len(job['runs'])} run(s) {wall:.1f} s]")
    ranks = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f)["runs"])
    return [([rank_runs[i] for rank_runs in ranks], os.path.join(out_dir, f"params{i}.pt"))
            for i in range(len(job["runs"]))]


def _ulp(t: torch.Tensor) -> float:
    """One unit in the last place of the largest magnitude in fp32 ``t``."""
    return float(torch.finfo(torch.float32).eps) * float(t.abs().max())


def _report_run(label: str, ranks: list, one_device: dict) -> dict:
    """Print a torchrun run beside the one-device ``device_mel`` run; check
    its steps and launches; return its numbers."""
    rows = ranks[0]["rows"]
    n = DIST_STEPS + 1
    if [r["step"] for r in rows] != list(range(1, n + 1)):
        fail(f"{label}: steps {[r['step'] for r in rows]}, expected 1-{n}")
    micro = TRAIN_BATCH // TRAIN_MICRO
    for r in rows:
        if not (np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])):
            fail(f"{label}: step {r['step']} loss {r['loss']} grad_norm {r['grad_norm']}")
        if (r["fwd"], r["bwd"]) != (micro * 72, micro * 36):
            fail(f"{label}: step {r['step']} attention launches {(r['fwd'], r['bwd'])} in "
                 f"rank 0, expected {(micro * 72, micro * 36)}")
    by_kernel: dict = {}
    for name, us in ranks[0]["events"]:
        base = _kernel_base_name(name)
        by_kernel[base] = by_kernel.get(base, 0.0) + us / 1e3
    kernel_ms = sum(by_kernel.values()) or None
    attn_ms = {k: v for k, v in by_kernel.items() if k in ATTN_KERNELS}
    window = rows[1]["t1"] - rows[0]["t1"]  # step 2 with the loader's waits
    out = {"window_step_s": window, "step_wall_s": rows[1]["wall_s"],
           "quiet_step_wall_s": rows[DIST_STEPS - 1]["wall_s"],
           "kernel_ms_per_step": kernel_ms, "attention_ms_per_step": attn_ms,
           "peak_memory_gb": [r["peak_memory_gb"] for r in ranks],
           "launches": {"train_attention_fwd": rows[1]["fwd"],
                        "train_attention_bwd": rows[1]["bwd"]},
           "losses": [r["loss"] for r in rows], "grad_norms": [r["grad_norm"] for r in rows],
           "run_wall_s": ranks[0]["wall_s"]}
    idle = "not measured" if kernel_ms is None else \
        f"{100 * (1 - kernel_ms / 1e3 / rows[DIST_STEPS - 1]['wall_s']):.1f}%"
    print(f"{label}: window step {window:.3f} s (one device {one_device['window_step_s']:.3f}), "
          f"in-step wall {out['step_wall_s']:.3f} s, held back "
          f"{out['quiet_step_wall_s']:.3f} s (one device "
          f"{one_device['quiet_step_wall_s']:.3f}); kernels "
          + ("not measured" if kernel_ms is None else f"{kernel_ms:.1f} ms")
          + f" a step (rank 0, profiled step {n}; one device "
          f"{one_device['kernel_ms_per_step'] or 0:.1f}), so the device idle {idle} of the "
          f"held-back step; peak memory " + ", ".join(f"{g:.2f}" for g in out["peak_memory_gb"])
          + f" GB a rank (one device {one_device['peak_memory_gb']:.2f}); rows 3 / 9 "
          f"launches {rows[1]['fwd']} / {rows[1]['bwd']} a step in rank 0; the run "
          f"{ranks[0]['wall_s']:.1f} s")
    for r in rows:
        print(f"  step {r['step']}: loss {r['loss']:.6f} grad_norm {r['grad_norm']:.4f} lr "
              f"{r['lr']:.3e} wall {r['wall_s']:.3f} s" + (" (held back)" if r["quiet"] else ""))
    if attn_ms:
        print("  attention kernels " + ", ".join(f"{k} {v:.1f} ms" for k, v in attn_ms.items()))
    return out


def phase_training_distributed(one_device: dict) -> dict:
    """Multi-rank training through torchrun on the card, small.en at full
    width and depth, ``device_mel``, remat, the same seeded data and global
    batch (micro batch 16 x 2) as ``one_device`` (the ``device_mel`` run of
    ``phase_training_device_mel``, this process):

    (a) world 1 (``--nproc_per_node=1``, NCCL, ``fsdp_size=1``: DDP) for
    DIST_STEPS + 1 steps and a save; its parameters after step 2 against the
    one-device run's (expected bit-equal: one rank's all-reduce is the
    identity and rows 3 and 9 are deterministic), held to DDP1_ULPS; then
    one step resumed on one device (``train_loop.main`` in this process)
    from the checkpoint the rank wrote;
    (b) world 2 on the one card, FSDP2 ``full`` and ``grad_op`` over gloo
    (see DIST_WORLD2), micro batch 8 a rank: the same global batch; losses
    of steps 1-DIST_STEPS against (a)'s within MEL_LOSS_TOL, step 2's update
    within UPDATE_TOL of (a)'s.

    Prints each run's window and held-back step walls, the kernels' device
    time of a step (rank 0's profiled step), peak memory per rank and the
    attention launches a step in rank 0, beside the one-device run."""
    from olmoasr_tpu_torch.models import whisper as model_mod
    from olmoasr_tpu_torch.models.dims import VARIANT_TO_DIMS
    from olmoasr_tpu_torch.training import train_loop

    base = dict(variant="small.en", eff_batch_size=TRAIN_BATCH, remat=True, ckpt_every=0,
                log_every=1, attention="kernel", device_mel=True)
    want = one_device["params"]
    out: dict = {}
    here = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        shards = write_shards(tmp, n=TRAIN_SAMPLES)
        base.update(train_shards=shards, ckpt_dir=os.path.join(tmp, "ckpt"))
        w1 = {**base, "exp_name": "dist_w1", "micro_batch_size": TRAIN_MICRO, "device": "cuda"}
        ((ranks, params),) = _torchrun("world 1", 1, {"runs": [w1], "backend": "nccl"}, tmp)
        out["world1"] = _report_run("training, world 1 (torchrun, DDP, NCCL)", ranks, one_device)
        got = torch.load(params, weights_only=True)
        diffs = {k: float((got[k] - w).abs().max()) for k, w in want.items()}
        over = {k: d for k, d in diffs.items() if d > DDP1_ULPS * _ulp(want[k])}
        worst = max(diffs, key=diffs.get)
        print(f"  parameters after step 2 against the one-device run's: max abs diff "
              f"{diffs[worst]:.3e} ({worst}); {sum(d == 0 for d in diffs.values())} of "
              f"{len(diffs)} tensors bit-equal")
        if over:
            fail(f"world 1 (DDP): parameters after step 2 beyond {DDP1_ULPS} ulps of the "
                 f"one-device run's: {dict(list(over.items())[:5])}")
        out["world1"]["params_max_abs_diff"] = diffs[worst]
        os.chdir(tmp)  # the metrics logger writes logs/ under the working directory
        try:
            t0 = time.perf_counter()
            resumed = train_loop.main(**w1, max_steps_this_run=1)
            resumed_s = time.perf_counter() - t0
        finally:
            os.chdir(here)
        if resumed["global_step"] != DIST_STEPS + 2 or not np.isfinite(resumed["train/loss"]):
            fail(f"world 1: the one-device resume gave {resumed}")
        print(f"  resumed on one device from the rank's step {DIST_STEPS + 1} checkpoint: step "
              f"{resumed['global_step']} loss {resumed['train/loss']:.6f} in {resumed_s:.1f} s")

        dims = VARIANT_TO_DIMS["small.en"]
        start = model_mod.empty_model(dims, include_padding_token=True)
        model_mod.init_params(start, torch.Generator().manual_seed(42), include_padding_token=True)
        start = dict(start.named_parameters())
        moved = {k: got[k] - start[k].detach() for k in want}
        norm = float(torch.stack([m.norm() for m in moved.values()]).norm())
        w1_losses = out["world1"]["losses"]
        runs = [{**base, "exp_name": f"dist_w2_{strategy}", "micro_batch_size": TRAIN_MICRO // 2,
                 "device": "cuda:0", "fsdp_size": 2, "fsdp_strategy": strategy}
                for strategy in DIST_WORLD2]
        world2 = _torchrun("world 2", 2, {"runs": runs, "backend": "gloo"}, tmp)
        for strategy, (ranks, params) in zip(DIST_WORLD2, world2):
            label = f"training, world 2 on one card (FSDP2 {strategy}, gloo)"
            run = out[f"world2_{strategy}"] = _report_run(label, ranks, one_device)
            got2 = torch.load(params, weights_only=True)
            diff = float(torch.stack([((got2[k] - start[k].detach()) - m).norm()
                                      for k, m in moved.items()]).norm()) / norm
            loss_err = max(abs(a - b) / abs(b) for a, b in
                           zip(run["losses"][:DIST_STEPS], w1_losses[:DIST_STEPS]))
            run["update_rel_diff"], run["loss_rel_err"] = diff, loss_err
            print(f"  against world 1: losses of steps 1-{DIST_STEPS} within {loss_err:.2e} "
                  f"(tol {MEL_LOSS_TOL}); step 2's update {diff:.4f} of its L2 away "
                  f"(tol {UPDATE_TOL})")
            if not loss_err <= MEL_LOSS_TOL or not diff <= UPDATE_TOL:
                fail(f"{label}: losses {run['losses']} against {w1_losses}, update {diff}")
    return out


def phase_train_fp32() -> dict:
    """One ``loss_fn`` and its backward at fp32 compute for a narrow model
    (2 + 2 layers, width 256 in 4 heads of 64, 1500 / 448 positions), 2
    samples, on the card (kernels) and on the CPU (twins) from the same
    weights and batch: the loss, and the largest error over all gradients
    against their largest magnitude. The attention backward rounds ds and pn
    to bf16 even in fp32, so a last-bit difference flips a few of them by one
    bf16 step. The loss is held to LOSS_TOL, the gradients to GRAD_TOL: that
    floor, measured on the CPU twins themselves as the gradients' change
    under a 1e-7 relative change of the mel, is about 3e-4 at these dims,
    and the check fails if it is not below half of GRAD_TOL. Then the same
    on the flash route (``attention="flash"``), which rounds nothing in fp32:
    its gradients are held to FLASH_GRAD_TOL."""
    from olmoasr_tpu_torch.models import whisper as model_mod
    from olmoasr_tpu_torch.models.dims import ModelDimensions
    from olmoasr_tpu_torch.models.whisper import PADDING_TOKEN
    from olmoasr_tpu_torch.training import train as train_mod

    dims = ModelDimensions(**GRAD_DIMS)
    rng = np.random.default_rng(6)
    B, T = 2, dims.n_text_ctx
    mel = torch.from_numpy(rng.standard_normal((B, 80, 3000)).astype(np.float32))
    tokens = torch.from_numpy(rng.integers(0, 50000, (B, T + 1)))
    lens = torch.tensor([T, 150])
    pad = torch.arange(T)[None] >= lens[:, None]
    inp = torch.where(pad, PADDING_TOKEN, tokens[:, :-1])
    tgt = torch.where(pad, PADDING_TOKEN, tokens[:, 1:])
    mask = torch.where(pad, float("-inf"), 0.0)
    init = model_mod.init_params(model_mod.empty_model(dims, True), torch.Generator().manual_seed(0),
                                 include_padding_token=True).state_dict()

    def grads(device, mel_scale=1.0, attention="kernel"):
        model = model_mod.empty_model(dims, True, device=device)
        model.load_state_dict(init)
        loss, _ = train_mod.loss_fn(model, (mel * mel_scale).to(device), inp.to(device),
                                    tgt.to(device), mask.to(device),
                                    compute_dtype=torch.float32, remat=True,
                                    attention=attention)
        loss.backward()
        return loss.item(), {n: p.grad.cpu() for n, p in model.named_parameters()}

    _reset_counts()
    loss_gpu, g_gpu = grads("cuda")
    counts, _ = _read_counts()
    loss_cpu, g_cpu = grads("cpu")
    _, g_floor = grads("cpu", 1 + 1e-7)
    scale = max(float(g.abs().max()) for g in g_cpu.values())
    err = max(float((g_gpu[n] - g).abs().max()) for n, g in g_cpu.items()) / scale
    floor = max(float((g_floor[n] - g).abs().max()) for n, g in g_cpu.items()) / scale
    loss_err = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    print(f"training fp32 check: 2+2 layers, width 256, B={B}: loss {loss_gpu:.6f} (card) vs "
          f"{loss_cpu:.6f} (CPU), relative {loss_err:.2e}; largest gradient error "
          f"{err:.2e} of the largest gradient (tol {GRAD_TOL:.0e}; the twins' own floor "
          f"{floor:.2e}); "
          f"attention launches {counts['train_attention_fwd']} forward "
          f"{counts['train_attention_bwd']} backward")
    if not loss_err <= LOSS_TOL or not err <= GRAD_TOL:
        fail(f"training fp32 check: loss {loss_err} (tol {LOSS_TOL}) or gradients {err} "
             f"(tol {GRAD_TOL})")
    if not floor <= GRAD_TOL / 2:
        fail(f"training fp32 check: the twins' own floor {floor} is not below half of {GRAD_TOL}")
    if counts["train_attention_bwd"] != 3 * 2 or counts["train_attention_fwd"] != 2 * 3 * 2:
        fail(f"training fp32 check: attention launches {counts}")

    _reset_counts()
    loss_gpu, g_gpu = grads("cuda", attention="flash")
    counts, _ = _read_counts()
    loss_cpu, g_cpu = grads("cpu", attention="flash")
    scale = max(float(g.abs().max()) for g in g_cpu.values())
    flash_err = max(float((g_gpu[n] - g).abs().max()) for n, g in g_cpu.items()) / scale
    flash_loss_err = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    print(f"  flash route: loss {loss_gpu:.6f} (card) vs {loss_cpu:.6f} (CPU), relative "
          f"{flash_loss_err:.2e}; largest gradient error {flash_err:.2e} of the largest gradient "
          f"(tol {FLASH_GRAD_TOL:.0e}); flash launches {counts['flash_mha_fwd']} forward "
          f"{counts['flash_mha_bwd']} backward")
    if not flash_loss_err <= LOSS_TOL or not flash_err <= FLASH_GRAD_TOL:
        fail(f"training fp32 check, flash route: loss {flash_loss_err} (tol {LOSS_TOL}) or "
             f"gradients {flash_err} (tol {FLASH_GRAD_TOL})")
    if (counts["flash_mha_bwd"], counts["flash_mha_fwd"]) != (3 * 2, 2 * 3 * 2) \
            or counts["train_attention_fwd"] or counts["train_attention_bwd"]:
        fail(f"training fp32 check, flash route: attention launches {counts}")
    return {"loss_rel_err": loss_err, "grad_rel_err": err, "floor": floor,
            "flash_loss_rel_err": flash_loss_err, "flash_grad_rel_err": flash_err}


# ---------------------------------------------------------------------------
# phase 7
# ---------------------------------------------------------------------------

SEGMENT_KEYS = {"id", "seek", "start", "end", "text", "tokens", "temperature", "avg_logprob",
                "compression_ratio", "no_speech_prob"}


def _check_transcript(label: str, result: dict) -> None:
    segs = result.get("segments") if isinstance(result, dict) else None
    if set(result) != {"text", "segments", "language"} or not isinstance(result["text"], str) \
            or not segs or not all(SEGMENT_KEYS <= set(seg) for seg in segs):
        fail(f"{label}: malformed result {str(result)[:300]}")


def _write_wav(path: str, seconds: int, rng) -> None:
    import scipy.io.wavfile as wavfile

    pcm = (rng.standard_normal(seconds * 16000) * 3000).astype(np.int16)
    wavfile.write(path, 16000, pcm)


def _run(cmd, timeout: float, **kw) -> subprocess.CompletedProcess:
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, **kw)
    if proc.returncode != 0:
        fail(f"{' '.join(cmd)} exited {proc.returncode}:\n{proc.stdout[-2000:]}\n"
             f"{proc.stderr[-4000:]}")
    return proc


def phase_entry_points() -> dict:
    """The seeded small.en as a reference .pt, its vocabulary's text rows cut
    to the byte tokens (:func:`byte_vocabulary`) so that its segments have
    words; the CLI on two files in one process, with word timestamps
    highlighted and ``--max_line_width 40``; the HTTP server in
    another, with 4 concurrent requests, one of them with word timestamps."""
    import dataclasses
    import urllib.request

    from olmoasr_tpu_torch import build_model

    out = {}
    rng = np.random.default_rng(3)
    with tempfile.TemporaryDirectory() as tmp:
        model = byte_vocabulary(build_model("small.en", seed=0, device="cuda",
                                            dtype=torch.bfloat16))
        ckpt = os.path.join(tmp, "small.en.pt")
        torch.save({"dims": dataclasses.asdict(model.dims),
                    "model_state_dict": {k: v.cpu() for k, v in model.state_dict().items()}},
                   ckpt)
        del model
        torch.cuda.empty_cache()
        out.update(_entry_extras(tmp, ckpt))
        wavs = []
        for name, seconds in (("a", 35), ("b", 50)):
            wavs.append(os.path.join(tmp, f"{name}.wav"))
            _write_wav(wavs[-1], seconds, rng)

        out_dir = os.path.join(tmp, "out")
        cmd = [sys.executable, "-m", "olmoasr_tpu_torch.transcribe", *wavs, "--model", ckpt,
               "-o", out_dir, "--temperature_increment_on_fallback", "None", "--batch_size", "2",
               "--verbose", "False", "--word_timestamps", "True", "--highlight_words", "True",
               "--max_line_width", "40"]
        t0 = time.perf_counter()
        _run(cmd, 600)
        cli_s = time.perf_counter() - t0
        want = sorted(f"{n}.{e}" for n in ("a", "b") for e in ("txt", "vtt", "srt", "tsv", "json"))
        if sorted(os.listdir(out_dir)) != want:
            fail(f"CLI wrote {sorted(os.listdir(out_dir))}, expected {want}")
        highlighted = {}
        for name in ("a", "b"):
            with open(os.path.join(out_dir, f"{name}.json"), encoding="utf-8") as f:
                n_words = _check_words(f"CLI {name}.json", [json.load(f)])
            for ext in ("vtt", "srt"):
                with open(os.path.join(out_dir, f"{name}.{ext}"), encoding="utf-8") as f:
                    text = f.read()
                highlighted[f"{name}.{ext}"] = text.count("<u>")
                if not n_words or text.count("<u>") < n_words:
                    fail(f"CLI {name}.{ext}: {n_words} words, {text.count('<u>')} highlighted:"
                         f"\n{text[:600]}")
        print(f"entry points: CLI (beam_size=5, t=0, batch_size=2, word timestamps "
              f"highlighted, --max_line_width 40) on 35 s + 50 s in its own "
              f"process: {cli_s:.1f} s, five outputs for each file; highlighted words "
              f"{highlighted}")
        out["cli_s"] = cli_s

        reqs = []
        for k in range(4):
            reqs.append(os.path.join(tmp, f"req{k}.wav"))
            _write_wav(reqs[-1], 12 + 4 * k, rng)
        with open(os.path.join(tmp, "server.err"), "w+") as err:
            server = subprocess.Popen(
                [sys.executable, "-m", "olmoasr_tpu_torch.serve", "--model", ckpt, "--host",
                 "127.0.0.1", "--port", "0", "--beam-size", "5", "--max-wait-ms", "1000"],
                stdout=subprocess.PIPE, stderr=err, text=True,
            )
            try:
                out.update(_drive_server(server, reqs, err, urllib.request))
            finally:
                server.terminate()
                try:
                    server.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    server.kill()
                    server.wait()
    return out


BPE_TEXTS = (" hello world", "hello", "  double  spaces ", "it's a test", "numbers 12345 mixed",
             "punct!?.,;", " hello hello hello", "", " ", "I'll we've don't", " café hello",
             "日本 hello 日本語", "emoji \U0001f44d test", "mixed１２３digits", "číslo ٣٤٥",
             "ideographic　space", "«quotes»—dash…", "ß sharp", "ｆｕｌｌ")


def _entry_extras(tmp: str, ckpt: str) -> dict:
    """The entry points that load, convert and tokenize: ``load_model`` of
    a released name whose link is a ``file://`` URL of ``ckpt`` (downloaded
    once, reused the second time, the same weights as ``ckpt``);
    ``gen_inf_ckpt`` of ``ckpt`` to an ``.npz`` (loads to the same weights);
    the native BPE built here from the checkout's sources with the host's
    C++ compiler, its ids equal to the Python tokenizer's on fixed and 200
    fuzzed texts over a rank file with multi-byte merges. The HF export
    (``integrations/hf.py``) is not run: this machine has no
    ``transformers``."""
    import base64
    import filecmp
    import random

    import olmoasr_tpu_torch
    from olmoasr_tpu_torch import load_model, tokenizer, tokenizer_native
    from olmoasr_tpu_torch.models.gen_inf_ckpt import gen_inf_ckpt

    by_path = load_model(ckpt, device="cuda").state_dict()

    def same_weights(label, model):
        sd = model.state_dict()
        bad = [k for k, v in by_path.items() if not torch.equal(sd[k].to(v.dtype), v)]
        if bad or sd.keys() != by_path.keys():
            fail(f"{label}: weights differ from {ckpt}'s: {bad[:5]}")

    root = os.path.join(tmp, "cache")
    link = olmoasr_tpu_torch.MODEL2LINK["small.en"]
    olmoasr_tpu_torch.MODEL2LINK["small.en"] = "file://" + ckpt
    try:
        t0 = time.perf_counter()
        same_weights("load_model by name", load_model("small.en", device="cuda",
                                                      download_root=root))
        download_s = time.perf_counter() - t0
        cached = os.path.join(root, os.path.basename(ckpt))
        stamp = os.stat(cached).st_mtime_ns
        same_weights("load_model by name, again", load_model("small.en", device="cuda",
                                                             download_root=root))
    finally:
        olmoasr_tpu_torch.MODEL2LINK["small.en"] = link
    if os.listdir(root) != [os.path.basename(ckpt)] or not filecmp.cmp(cached, ckpt, False) \
            or os.stat(cached).st_mtime_ns != stamp:
        fail(f"load_model by name: the download root holds {os.listdir(root)}")

    t0 = time.perf_counter()
    npz = gen_inf_ckpt(ckpt, os.path.join(tmp, "inference.npz"))
    gen_s = time.perf_counter() - t0
    same_weights("gen_inf_ckpt", load_model(  # the .npz holds fp32: the checkpoint's dtype
        npz, device="cuda", dtype=by_path["decoder.token_embedding.weight"].dtype))
    torch.cuda.empty_cache()

    ranks_path = os.path.join(tmp, "ranks.tiktoken")
    extra = [b" h", b"el", b"lo", b" he", b" hel", b" hell", b" hello", b"ll", "é".encode(),
             b" caf", " café".encode(), "日".encode(), "本".encode(), "日本".encode(),
             "\U0001f44d".encode()[:2], "\U0001f44d".encode()]
    with open(ranks_path, "wb") as f:
        for rank, tok in enumerate([bytes([b]) for b in range(256)] + extra):
            f.write(base64.b64encode(tok) + b" " + str(rank).encode() + b"\n")
    rng = random.Random(42)
    pools = ["abcdefghij ", "\t\n  　", "0123456789٠١٢", "àéîöüß", "日本語中文", "!?.,;:—…«»",
             "\U0001f600\U0001f44d\U0001f680", "'s't're've'm'll'd'"]
    texts = list(BPE_TEXTS) + ["".join(rng.choice(rng.choice(pools))
                                       for _ in range(rng.randrange(0, 40))) for _ in range(200)]
    t0 = time.perf_counter()
    native = tokenizer_native.NativeBPE(ranks_path)  # built here at first use
    build_s = time.perf_counter() - t0
    python = tokenizer.BytePairEncoder(tokenizer.load_tiktoken_ranks(ranks_path), {})
    differ = [t for t in texts if native.encode(t) != python.encode(t)]
    fallback = tokenizer_native.NativeBPE(None).encode("hello world") == list(b"hello world")
    print(f"entry points: load_model of a released name through a file:// link "
          f"{download_s:.1f} s (downloaded once, reused, the checkpoint's weights); "
          f"gen_inf_ckpt to .npz {gen_s:.1f} s (the same weights); the native BPE built in "
          f"{build_s:.1f} s, {len(texts) - len(differ)} of {len(texts)} texts give the Python "
          f"tokenizer's ids, byte fallback {fallback}")
    if differ or not fallback:
        fail(f"native BPE: ids differ from the Python tokenizer's on {differ[:5]}, byte "
             f"fallback {fallback}")
    return {"download_s": download_s, "gen_inf_ckpt_s": gen_s, "native_bpe_build_s": build_s,
            "native_bpe_texts": len(texts), "bpe_throughput": _bpe_throughput(tmp)}


BPE_CUES = 4000  # cue texts of the throughput corpus


def _bpe_throughput(tmp: str) -> dict:
    """The native BPE against the Python engine on the data pipeline's
    tokenizer work: ``training.dataset``'s ``encode(" " + text)`` of each
    cue of a transcript, over BPE_CUES cues of 1-8 of the training shards'
    WORDS (``_vtt``'s), with a rank file in which every word, bare and after
    a space, merges to one token through its prefixes (as GPT-2's merges
    make a common word one token): the medians of 3 passes each, on the
    host. The ids must agree."""
    import base64

    from olmoasr_tpu_torch import tokenizer, tokenizer_native

    merged = sorted({w[:k] for word in WORDS for w in (word, " " + word)
                     for k in range(2, len(w) + 1)}, key=lambda t: (len(t), t))
    path = os.path.join(tmp, "words.tiktoken")
    with open(path, "wb") as f:
        for rank, tok in enumerate([bytes([b]) for b in range(256)]
                                   + [t.encode() for t in merged]):
            f.write(base64.b64encode(tok) + b" " + str(rank).encode() + b"\n")
    rng = np.random.default_rng(6)
    cues = [" " + " ".join(rng.choice(WORDS, int(rng.integers(1, 9)))) for _ in range(BPE_CUES)]
    engines = {"python": tokenizer.BytePairEncoder(tokenizer.load_tiktoken_ranks(path), {}),
               "native": tokenizer_native.NativeBPE(path)}
    ids, times = {}, {}
    for name, enc in engines.items():
        times[name] = []
        for _ in range(3):
            t0 = time.perf_counter()
            ids[name] = [enc.encode(c) for c in cues]
            times[name].append(time.perf_counter() - t0)
    if ids["python"] != ids["native"]:
        fail("native BPE: the throughput corpus's ids differ from the Python engine's")
    us = {k: statistics.median(v) / BPE_CUES * 1e6 for k, v in times.items()}
    n_ids = sum(map(len, ids["python"]))
    print(f"  BPE throughput ({BPE_CUES} cues, {n_ids} ids, {len(merged)} merges, host): "
          f"python {us['python']:.2f} us a cue, native {us['native']:.2f} us a cue "
          f"({us['python'] / us['native']:.2f}x); runs (s) "
          + "; ".join(f"{k} " + ", ".join(f"{t:.4f}" for t in v) for k, v in times.items()))
    return {"cues": BPE_CUES, "ids": n_ids, "us_per_cue": us, "runs_s": times}


def _listen(proc, err, timeout: float = 300) -> tuple:
    """The port from the line the server ``proc`` prints once it listens,
    and the list of its output's lines, which a thread goes on filling to
    the output's end."""
    lines: list = []
    listening = threading.Event()

    def drain():
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("serving "):
                listening.set()
        listening.set()

    threading.Thread(target=drain, daemon=True).start()
    listening.wait(timeout)
    found = [re.search(r" on [^ ]*:(\d+) ", line) for line in lines
             if line.startswith("serving ")]
    if not found or found[0] is None:
        err.seek(0)
        fail(f"server did not start within {timeout} s: {lines} {err.read()[-4000:]}")
    return int(found[0].group(1)), lines


def _post_all(port: int, wavs, queries, urllib_request) -> tuple:
    """Every file of ``wavs`` POSTed at once, file k with ``queries[k]``: the
    answers ((status, result or error) each) and the wall."""
    answers = [None] * len(wavs)

    def post(k):
        with open(wavs[k], "rb") as f:
            req = urllib_request.Request(f"http://127.0.0.1:{port}/v1/transcribe?{queries[k]}",
                                         data=f.read(), method="POST",
                                         headers={"X-Filename": "req.wav"})
        try:
            with urllib_request.urlopen(req, timeout=600) as r:
                answers[k] = (r.status, json.loads(r.read()))
        except Exception as exc:  # noqa: BLE001 -- reported as a failed request
            answers[k] = (None, repr(exc))

    threads = [threading.Thread(target=post, args=(k,)) for k in range(len(wavs))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return answers, time.perf_counter() - t0


def _answered(label: str, answers) -> list:
    """The results, each answered 200 with the transcript's schema."""
    for k, (status, body) in enumerate(answers):
        if status != 200:
            fail(f"{label}, request {k}: {status} {str(body)[:500]}")
        _check_transcript(f"{label}, request {k}", body)
    return [body for _, body in answers]


def _drive_server(server, reqs, err, urllib_request) -> dict:
    port, _ = _listen(server, err)
    queries = ["temperature=0&word_timestamps=true"] + ["temperature=0"] * (len(reqs) - 1)
    answers, wall = _post_all(port, reqs, queries, urllib_request)
    bodies = _answered("server", answers)
    # request 0 asked for word timestamps: each of its segments has words (a
    # random model's 12 s may give none); the others' segments have none
    n_words = _check_words("server request 0 (word timestamps)", bodies[:1])
    if any("words" in seg for body in bodies[1:] for seg in body["segments"]
           if seg["tokens"]):
        fail("server: words in a request that did not ask for word timestamps")
    with urllib_request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
        stats = json.loads(r.read())["stats"]
    print(f"  server (int8 cross K/V, beam_size=5): {len(reqs)} of {len(reqs)} concurrent "
          f"requests answered 200 in {wall:.1f} s, {n_words} words in the one with word "
          f"timestamps; /healthz {stats}")
    if stats["requests"] != len(reqs) or not stats["batches"] < stats["requests"]:
        fail(f"server: {stats['batches']} batches for {stats['requests']} requests")
    return {"server_wall_s": wall, "server_stats": stats}


# ---------------------------------------------------------------------------
# phase 7, continued: decoding split across ranks
# ---------------------------------------------------------------------------

# (label, windows, DecodingOptions fields) of each decode across ranks: the
# short-form slice's greedy bf16 and int8 and its beam search, and fp32 greedy
# and beam search, whose tokens must equal one process's
# the decodes' depth: tokens a window, cut from 224 to keep the script in its time
RANKS_SAMPLE_LEN = 112
RANK_CASES = (("greedy bf16", 64, {}), ("greedy int8", 64, {"kv_quant": True}),
              ("beam5 bf16", BEAM_WINDOWS, {"beam_size": BEAM_SIZE}),
              ("greedy fp32", 8, {"fp16": False}),
              ("beam5 fp32", 8, {"beam_size": BEAM_SIZE, "fp16": False}))
RANKS_CLI_SAMPLE_LEN = 64  # the CLI runs' depth: tokens a window, cut from the CLI's 224
# the CLI at world 2 against one process, fp32: a segment's avg_logprob and
# no_speech_prob (its rows decode in batches of another size, so the kernels
# may sum in another order)
RANKS_SCORE_TOL = 1e-4
SCORE_KEYS = ("avg_logprob", "no_speech_prob")


def _rank_inputs():
    """The short-form slice's model and windows: the seeded small.en in bf16
    and the log-mel of 64 windows of its seeded noise, on the card."""
    from olmoasr_tpu_torch import build_model
    from olmoasr_tpu_torch.audio import N_SAMPLES, log_mel_spectrogram

    model = build_model("small.en", seed=0, device="cuda", dtype=torch.bfloat16)
    audio = np.random.default_rng(0).standard_normal((64, N_SAMPLES)).astype(np.float32) * 0.1
    return model, log_mel_spectrogram(torch.from_numpy(audio).cuda())


def _decode_cases(model, mel, halves: bool = False) -> dict:
    """Each of RANK_CASES through ``model.decode`` after a short warm-up:
    tokens, wall, launches and single-token steps; with a mesh registered
    also the wall until the gather began and the gather's wall and bytes
    (``decoding._gather_shards`` timed, synchronised on both sides). With
    ``halves``, also the tokens of each half of the windows decoded alone
    (what two ranks decode), in bf16."""
    from olmoasr_tpu_torch import decoding

    gather = decoding._gather_shards
    timing: dict = {}

    def timed_gather(mesh, tensors):
        torch.cuda.synchronize()
        timing["t0"] = time.perf_counter()
        out = gather(mesh, tensors)
        torch.cuda.synchronize()
        timing["s"] = time.perf_counter() - timing["t0"]
        timing["bytes"] = sum(t.numel() * t.element_size() for t in out)
        return out

    decoding._gather_shards = timed_gather
    out = {}
    try:
        for label, n, fields in RANK_CASES:
            options = decoding.DecodingOptions(language="en", sample_len=RANKS_SAMPLE_LEN,
                                               **fields)
            model.decode(mel[:n], dataclasses.replace(options, sample_len=4))  # warm-up
            timing.clear()
            _reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results = model.decode(mel[:n], options)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts, steps = _read_counts()
            _check_results(f"decode across ranks, {label}", results, n, model.dims)
            out[label] = {"tokens": [r.tokens for r in results], "wall_s": wall,
                          "launches": counts, "steps": steps,
                          "before_gather_s": timing["t0"] - t0 if timing else None,
                          "gather_s": timing.get("s"), "gather_bytes": timing.get("bytes")}
            if halves and options.fp16:  # at fp32 the whole batch's tokens are held instead
                halves_of = (mel[:n // 2], mel[n // 2:n])
                out[label]["halves_tokens"] = [r.tokens for h in halves_of
                                               for r in model.decode(h, options)]
    finally:
        decoding._gather_shards = gather
    return out


def _decode_rank(job_path: str) -> None:
    """One rank of ``phase_decode_ranks`` (a), under torchrun: joins a gloo
    group on the one card, registers a mesh over both ranks and decodes
    RANK_CASES; writes its rows to ``out_dir/rank<r>.json``."""
    from olmoasr_tpu_torch import decoding
    from olmoasr_tpu_torch.parallel import mesh as mesh_mod

    with open(job_path) as f:
        job = json.load(f)
    rank = int(os.environ["RANK"])
    exact_fp32()
    torch.cuda.set_device(0)
    torch.distributed.init_process_group("gloo")
    try:
        model, mel = _rank_inputs()
        decoding.set_infer_mesh(mesh_mod.make_mesh(device_type="cuda"))
        out = _decode_cases(model, mel)
    finally:
        decoding.set_infer_mesh(None)
        torch.distributed.destroy_process_group()
    with open(os.path.join(job["out_dir"], f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def _cli_fp32(argv) -> None:
    """``transcribe.cli(argv)`` with every decode at fp32 and
    RANKS_CLI_SAMPLE_LEN tokens a window, the CLI having no flag for
    either."""
    from olmoasr_tpu_torch import decoding, transcribe

    options = transcribe.DecodingOptions
    transcribe.DecodingOptions = lambda **kw: options(
        **{**kw, "fp16": False, "sample_len": RANKS_CLI_SAMPLE_LEN})
    try:
        transcribe.cli(argv)
    finally:
        transcribe.DecodingOptions = options


def _cli_rank(job_path: str) -> None:
    """A rank of ``phase_decode_ranks`` (b), under torchrun:
    :func:`_cli_fp32` of ``job["argv"]``, each ``{rank}`` in it this
    rank's; with ``backend`` "gloo" it first joins a gloo group, which the
    CLI then uses (two ranks on the one card)."""
    with open(job_path) as f:
        job = json.load(f)
    gloo = job["backend"] == "gloo"
    exact_fp32()
    if gloo:
        torch.cuda.set_device(0)
        torch.distributed.init_process_group("gloo")
    try:
        _cli_fp32([a.replace("{rank}", os.environ["RANK"]) for a in job["argv"]])
    finally:
        if gloo:
            torch.distributed.destroy_process_group()


def _rank_cmd(flag: str, job: dict, job_path: str, world: int) -> tuple:
    """(command, environment) of ``chip_smoke.py FLAG JOB`` on ``world`` ranks
    through torchrun, or as one process (``world`` 0), each process given its
    share of the host's cores (torchrun's default is one)."""
    with open(job_path, "w") as f:
        json.dump(job, f)
    here = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, os.path.abspath(__file__), flag, job_path]
    if world:
        cmd[1:1] = ["-m", "torch.distributed.run", "--standalone", f"--nproc_per_node={world}"]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, (here, env.get("PYTHONPATH"))))
    env["OMP_NUM_THREADS"] = str(max(1, (os.cpu_count() or 1) // max(world, 1)))
    return cmd, env


def _launch(flag: str, job: dict, job_path: str, world: int, cwd: str,
            timeout: float = 600) -> float:
    """:func:`_rank_cmd` run to its end; its wall. Fails on a failed rank."""
    cmd, env = _rank_cmd(flag, job, job_path, world)
    t0 = time.perf_counter()
    _run(cmd, timeout=timeout, cwd=cwd, env=env)
    return time.perf_counter() - t0


def _same_cli_outputs(label: str, got_dir: str, want_dir: str, exact: bool) -> float:
    """The five outputs of each file in ``got_dir`` against ``want_dir``:
    the text formats byte-equal, the json equal but for the segments'
    scores, within RANKS_SCORE_TOL unless ``exact``. Returns the largest
    score difference."""
    names = sorted(os.listdir(want_dir))
    if sorted(os.listdir(got_dir)) != names or len(names) != 10:
        fail(f"{label}: wrote {sorted(os.listdir(got_dir))}, one process {names}")
    worst = 0.0
    for name in names:
        with open(os.path.join(got_dir, name), encoding="utf-8") as f:
            got = f.read()
        with open(os.path.join(want_dir, name), encoding="utf-8") as f:
            want = f.read()
        if got == want:
            continue
        if not name.endswith(".json") or exact:
            fail(f"{label}: {name} differs from the one-process CLI's:\n{got[:600]}\n--\n"
                 f"{want[:600]}")
        g, w = json.loads(got), json.loads(want)
        for a, b in zip(g["segments"], w["segments"]):
            worst = max([worst] + [abs(a[k] - b[k]) for k in SCORE_KEYS])
            for k in SCORE_KEYS:
                a[k] = b[k]
        if g != w or worst > RANKS_SCORE_TOL:
            fail(f"{label}: {name} differs from the one-process CLI's (scores up to {worst})")
    return worst


SERVE_RANK_REQUESTS = 8  # each server's concurrent requests, 10-20 s of seeded noise each
# (label, world, backend, --device) of each server of part (c): one process,
# torchrun at world 1 (the server joins NCCL) and at world 2 (gloo on the one
# card: NCCL refuses two ranks on one device)
SERVE_RANKS = (("one", 0, "nccl", "cuda"), ("world1", 1, "nccl", "cuda"),
               ("world2", 2, "gloo", "cuda:0"))
SERVE_STOP_S = 30  # what a stopped server and each of its ranks may take to end


def _serve_rank(job_path: str) -> None:
    """A rank of ``phase_decode_ranks`` (c), or its one process:
    ``serve.main(job["argv"])`` with the launch counts set to 0 first; with
    ``backend`` "gloo" it first joins a gloo group on the one card, which
    ``main`` then uses. Once ``main`` returns (on an interrupt: rank 0 stops
    and the others return on its stop message) writes the launches and
    single-token steps to ``out_dir/<label>_rank<r>.json``."""
    from olmoasr_tpu_torch import serve

    with open(job_path) as f:
        job = json.load(f)
    gloo = job["backend"] == "gloo"
    exact_fp32()
    if gloo:
        torch.cuda.set_device(0)
        torch.distributed.init_process_group("gloo")
    try:
        _reset_counts()
        serve.main(job["argv"])
        counts, steps = _read_counts()
    finally:
        if gloo:
            torch.distributed.destroy_process_group()
    name = f"{job['label']}_rank{os.environ.get('RANK', '0')}.json"
    with open(os.path.join(job["out_dir"], name), "w") as f:
        json.dump({"launches": counts, "steps": steps}, f)


def _same_answers(label: str, got: list, want: list) -> float:
    """Each result equal to ``want``'s, its segments' scores within
    RANKS_SCORE_TOL; returns the largest score difference."""
    worst = 0.0
    for k, (g, w) in enumerate(zip(got, want)):
        g, w = json.loads(json.dumps(g)), json.loads(json.dumps(w))
        for a, b in zip(g["segments"], w["segments"]):
            worst = max([worst] + [abs(a[key] - b[key]) for key in SCORE_KEYS])
            for key in SCORE_KEYS:
                a[key] = b[key]
        if g != w or worst > RANKS_SCORE_TOL:
            fail(f"{label}, request {k}: differs from the one-process server's (scores up to "
                 f"{worst}):\n{str(got[k])[:600]}\n--\n{str(want[k])[:600]}")
    return worst


def _serve_ranks(tmp: str, ckpt: str, L: int) -> dict:
    """Part (c) of :func:`phase_decode_ranks`: ``python -m
    olmoasr_tpu_torch.serve``'s ``main`` (``chip_smoke.py --serve-rank``) on
    ``ckpt`` as one process, under torchrun at world 1 (NCCL) and at world 2
    (gloo), the three at once; each answers SERVE_RANK_REQUESTS concurrent
    requests at fp32 and t=0, rank 0's answers equal to the one process's
    (text exact, scores within RANKS_SCORE_TOL), fewer batches than requests
    on ``/healthz``, one listening line a server (rank 1 prints none); then
    the world-2 server the same files as the default traffic (int8 cross
    K/V, the ladder), each answered 200 with a transcript. Then an interrupt
    to each: every rank's ``main`` must return within SERVE_STOP_S; every
    rank's single-token steps all on the "sc" route. Rank 0's launches at
    world 2 are ``launches_serve_ranks``."""
    import urllib.request

    rng = np.random.default_rng(6)
    wavs = []
    for k in range(SERVE_RANK_REQUESTS):
        wavs.append(os.path.join(tmp, f"serve{k}.wav"))
        _write_wav(wavs[-1], 10 + (10 * k) // (SERVE_RANK_REQUESTS - 1), rng)
    servers, out = {}, {}
    t0 = time.perf_counter()
    try:
        for label, world, backend, device in SERVE_RANKS:
            job = {"argv": ["--model", ckpt, "--device", device, "--host", "127.0.0.1",
                            "--port", "0", "--max-wait-ms", "1000"],
                   "backend": backend, "label": label, "out_dir": tmp}
            cmd, env = _rank_cmd("--serve-rank", job, os.path.join(tmp, f"serve_{label}.json"),
                                 world)
            err = open(os.path.join(tmp, f"serve_{label}.err"), "w+")
            servers[label] = (subprocess.Popen(cmd, cwd=tmp, env=env, stdout=subprocess.PIPE,
                                               stderr=err, text=True), err)
        ports, lines = {}, {}
        for label, (proc, err) in servers.items():
            ports[label], lines[label] = _listen(proc, err)
        started = time.perf_counter() - t0
        with concurrent.futures.ThreadPoolExecutor(len(servers)) as pool:
            runs = {label: pool.submit(_post_all, ports[label], wavs,
                                       ["fp16=false&temperature=0"] * len(wavs), urllib.request)
                    for label in servers}
            fp32 = {label: run.result() for label, run in runs.items()}
        answers = {label: _answered(f"server {label}, fp32", a) for label, (a, _) in fp32.items()}
        worst = {label: _same_answers(f"server {label}, fp32", answers[label], answers["one"])
                 for label in ("world1", "world2")}
        stats = {}
        for label in servers:
            with urllib.request.urlopen(f"http://127.0.0.1:{ports[label]}/healthz",
                                        timeout=30) as r:
                stats[label] = json.loads(r.read())["stats"]
            if not stats[label]["batches"] < stats[label]["requests"] == SERVE_RANK_REQUESTS:
                fail(f"server {label}: {stats[label]} for {SERVE_RANK_REQUESTS} requests")
        default, default_wall = _post_all(ports["world2"], wavs, [""] * len(wavs),
                                          urllib.request)
        _answered("server world2, default traffic", default)
    finally:
        stopping = time.perf_counter()
        for proc, _ in servers.values():
            proc.send_signal(signal.SIGINT)
        left = []
        for label, (proc, err) in servers.items():
            try:
                proc.wait(timeout=max(0.0, stopping + SERVE_STOP_S - time.perf_counter()))
            except subprocess.TimeoutExpired:
                left.append(label)
                proc.kill()
                proc.wait()
            err.close()
        stop_s = time.perf_counter() - stopping
    if left:
        fail(f"servers {left} still running {SERVE_STOP_S} s after the interrupt")
    for label, world, _, _ in SERVE_RANKS:
        listening = [line for line in lines[label] if line.startswith("serving ")]
        if len(listening) != 1 or (world == 2) != (", 2 ranks)" in listening[0]):
            fail(f"server {label}: listening lines {listening}")
    ranks = {}
    for label, world, _, _ in SERVE_RANKS:
        for r in range(max(world, 1)):
            path = os.path.join(tmp, f"{label}_rank{r}.json")
            if not os.path.exists(path):
                fail(f"server {label}: rank {r}'s main did not return on the interrupt")
            with open(path) as f:
                ranks[f"{label} rank {r}"] = json.load(f)
    for name, got in ranks.items():
        _check_decode_counts(f"server {name}", got["launches"], got["steps"], L, route="sc")
    print(f"decode across ranks (c): the server on the byte-vocabulary checkpoint, one process, "
          f"world 1 (NCCL) and world 2 (gloo) at once, listening after {started:.1f} s; "
          f"{SERVE_RANK_REQUESTS} requests of 10-20 s at fp32, t=0, to each at once: walls "
          + ", ".join(f"{label} {w:.2f} s" for label, (_, w) in fp32.items())
          + "; rank 0's answers equal to the one process's (scores within "
          + ", ".join(f"{worst[label]:.2e} at {label}" for label in worst)
          + f"); /healthz {stats}; then the default traffic to world 2 "
          f"{default_wall:.2f} s; stopped in {stop_s:.1f} s, rank 1 printed no listening line")
    print("  single-token steps and launches: " + "; ".join(
        f"{name} {got['steps']} steps, layer_block_decode {got['launches']['layer_block_decode']}"
        f", mlp_block {got['launches']['mlp_block']}, train_attention_fwd "
        f"{got['launches']['train_attention_fwd']}" for name, got in ranks.items()))
    out.update(started_s=started, fp32_walls_s={k: w for k, (_, w) in fp32.items()},
               default_wall_s=default_wall, score_max_diff=worst, stats=stats, stop_s=stop_s,
               ranks=ranks, launches=ranks["world2 rank 0"]["launches"])
    return out


def phase_decode_ranks() -> dict:
    """Decoding split across ranks (``decoding.set_infer_mesh``), on the one
    card (NCCL refuses two ranks on one device, so two ranks go over gloo):

    (a) the short-form slice's seeded small.en and windows, RANK_CASES
    (RANKS_SAMPLE_LEN tokens a window) in this process, then on two ranks through torchrun (``--decode-rank``,
    gloo, a mesh over both): both ranks must build the same results, in
    bf16 equal to this process's decode of each half of the windows (what
    each rank decodes), at fp32 to its decode of the whole batch; rows that
    differ from the whole batch's in bf16 are counted (a kernel may split
    its work otherwise at another row count, and bf16 rounds that). Each
    rank's wall until the gather and the gather's wall and bytes; rank 0's
    launches (greedy bf16: ``launches_decode_ranks``) along each case's
    route.
    (b) the transcribe CLI (beam 5 at t=0, ``--batch_size 2``, fp32,
    RANKS_CLI_SAMPLE_LEN tokens a window) on
    the entry points' two files, the checkpoint's vocabulary cut to the
    byte tokens: one process (this one), world 1 through torchrun (the CLI
    joins NCCL) and world 2 (gloo), the three at once: rank 0's five
    outputs of each file equal the one process's (world 1 exactly), and
    rank 1 writes nothing.
    (c) the server across ranks on the same checkpoint (:func:`_serve_ranks`):
    one process, world 1 (NCCL) and world 2 (gloo), rank 0's answers equal to
    the one process's at fp32, then the default traffic at world 2; rank 0's
    launches there (``launches_serve_ranks``)."""
    exact_fp32()  # as in main, and in each rank
    out: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        model, mel = _rank_inputs()
        L = model.dims.n_text_layer
        one = _decode_cases(model, mel, halves=True)
        os.makedirs(os.path.join(tmp, "a"))
        wall = _launch("--decode-rank", {"out_dir": os.path.join(tmp, "a")},
                       os.path.join(tmp, "a", "job.json"), 2, tmp)
        ranks = []
        for r in range(2):
            with open(os.path.join(tmp, "a", f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        print(f"decode across ranks (a): world 2 on the one card over gloo, torchrun "
              f"{wall:.1f} s")
        for label, n, fields in RANK_CASES:
            got = [r[label] for r in ranks]
            if got[0]["tokens"] != got[1]["tokens"]:
                fail(f"decode across ranks, {label}: the two ranks built different results")
            differ = sum(a != b for a, b in zip(got[0]["tokens"], one[label]["tokens"]))
            if fields.get("fp16") is False and differ:
                fail(f"decode across ranks, {label}: {differ} of {n} rows differ from one "
                     f"process's at fp32")
            if got[0]["tokens"] != one[label].get("halves_tokens", got[0]["tokens"]):
                fail(f"decode across ranks, {label}: the ranks' results differ from one "
                     f"process's decode of each half of the windows")
            route = "sc" if fields.get("kv_quant") else "split"
            _check_decode_counts(f"decode across ranks, {label}, rank 0", got[0]["launches"],
                                 got[0]["steps"], L, route=route)
            print(f"  {label}, {n} windows: one process {one[label]['wall_s']:.3f} s "
                  f"({one[label]['steps']} steps); ranks "
                  + ", ".join(f"{r['before_gather_s']:.3f} s to the gather ({r['steps']} steps)"
                              for r in got)
                  + f"; gather {got[0]['gather_s']:.3f} / {got[1]['gather_s']:.3f} s of "
                  f"{got[0]['gather_bytes'] / 1e6:.1f} MB; wall {got[0]['wall_s']:.3f} / "
                  f"{got[1]['wall_s']:.3f} s; "
                  + ("" if "halves_tokens" not in one[label] else
                     "equal to one process's decode of each half; ")
                  + f"rows differing from its decode of the whole batch: {differ} of {n}")
            out[label] = {"one_process_wall_s": one[label]["wall_s"],
                          "rank_walls_s": [r["wall_s"] for r in got],
                          "before_gather_s": [r["before_gather_s"] for r in got],
                          "gather_s": [r["gather_s"] for r in got],
                          "gather_bytes": got[0]["gather_bytes"], "rows_differing": differ,
                          "launches": got[0]["launches"]}
        out["launches"] = out["greedy bf16"]["launches"]

        ckpt = os.path.join(tmp, "small.en.pt")
        byte_vocabulary(model)
        torch.save({"dims": dataclasses.asdict(model.dims),
                    "model_state_dict": {k: v.cpu() for k, v in model.state_dict().items()}},
                   ckpt)
        del model, mel
        torch.cuda.empty_cache()
        rng = np.random.default_rng(3)  # phase_entry_points' two files
        wavs = []
        for name, seconds in (("a", 35), ("b", 50)):
            wavs.append(os.path.join(tmp, f"{name}.wav"))
            _write_wav(wavs[-1], seconds, rng)
        def argv(label, device="cuda"):
            return [*wavs, "--model", ckpt, "-o", os.path.join(tmp, f"{label}_rank{{rank}}"),
                    "--temperature_increment_on_fallback", "None", "--batch_size", "2",
                    "--verbose", "False", "--device", device]

        # the two torchruns and the one-process run (in this process) at once
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            runs = {label: pool.submit(_launch, "--cli-rank",
                                       {"argv": argv(label, device), "backend": backend},
                                       os.path.join(tmp, f"cli_{label}.json"), world, tmp)
                    for label, world, backend, device in (("world1", 1, "nccl", "cuda"),
                                                          ("world2", 2, "gloo", "cuda:0"))}
            t0 = time.perf_counter()
            _cli_fp32([a.replace("{rank}", "0") for a in argv("one")])
            walls = {"one": time.perf_counter() - t0}
            walls.update({label: run.result() for label, run in runs.items()})
        want = os.path.join(tmp, "one_rank0")
        _same_cli_outputs("CLI, world 1 (NCCL)", os.path.join(tmp, "world1_rank0"), want, True)
        worst = _same_cli_outputs("CLI, world 2 (gloo)", os.path.join(tmp, "world2_rank0"),
                                  want, False)
        if os.path.exists(os.path.join(tmp, "world2_rank1")):
            fail("CLI, world 2: rank 1 wrote outputs")
        print(f"decode across ranks (b): the CLI (beam 5, t=0, fp32, --batch_size 2, "
              f"{RANKS_CLI_SAMPLE_LEN} tokens a window) on 35 s + 50 s, the three runs at once "
              f"on the card: one process (in this one) {walls['one']:.1f} s, world 1 (NCCL) "
              f"{walls['world1']:.1f} s, world 2 (gloo) {walls['world2']:.1f} s (process "
              f"start included); rank 0's outputs equal the one "
              f"process's (world 2: scores within {worst:.2e}), rank 1 wrote nothing")
        out["cli_walls_s"], out["cli_score_max_diff"] = walls, worst
        t0 = time.perf_counter()
        out["serve"] = _serve_ranks(tmp, ckpt, L)
        print(f"decode across ranks (c): {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 8: evaluation and the trainer's last options
# ---------------------------------------------------------------------------

EVAL_UTTERANCES, EVAL_BATCH, EVAL_CLI_SAMPLES = 96, 64, 16
EVAL_ASYNC_UTTERANCES = 16  # the async eval's tree: the harness process evaluates it whole
EVAL_LONG_SECONDS = (35, 50)  # the long-form manifest set's two files
CAST_TOL = 1e-3  # the cast-moment step, card against CPU from the same grads, x its lr
VAL_LOSS_TOL = 1e-4  # fp32 validate's loss, card against CPU, relative


def _eval_tree(root: str, n: int = EVAL_UTTERANCES) -> float:
    """A LibriSpeech-format tree of n utterances in 4 chapters (seeded
    noise of 3-20 s, int16 wav, seeded word transcripts in ``.trans.txt``)
    and a manifest set ``longset`` of two files of EVAL_LONG_SECONDS;
    returns the utterances' seconds."""
    import scipy.io.wavfile as wavfile

    rng = np.random.default_rng(8)
    seconds = 0.0
    per_chapter = n // 4
    for c in range(4):
        chap = os.path.join(root, "LibriSpeech", "test-clean", "61", str(70 + c))
        os.makedirs(chap)
        lines = []
        for i in range(per_chapter):
            utt = f"61-{70 + c}-{i:04d}"
            n = int(16000 * rng.uniform(3, 20))
            wavfile.write(os.path.join(chap, f"{utt}.wav"), 16000,
                          (rng.standard_normal(n) * 3000).astype(np.int16))
            seconds += n / 16000
            words = rng.choice(WORDS, int(rng.integers(3, 25)))
            lines.append(f"{utt} {' '.join(words).upper()}")
        with open(os.path.join(chap, f"61-{70 + c}.trans.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    with open(os.path.join(root, "longset.jsonl"), "w") as f:
        for k, s in enumerate(EVAL_LONG_SECONDS):
            _write_wav(os.path.join(root, f"long{k}.wav"), s, rng)
            text = " ".join(rng.choice(WORDS, 3 * s))
            f.write(json.dumps({"audio": f"long{k}.wav", "text": text, "id": f"long{k}"}) + "\n")
    return seconds


def _timed_short_form(model, tree: str, kv_quant: bool) -> tuple:
    """``short_form_eval`` at EVAL_BATCH with its parts timed: the decode
    calls and the card's log-mel (each behind a synchronize), the normalizer
    and the WER on the host; the rest of the wall is reading and padding
    the audio and the copy to the card."""
    from olmoasr_tpu_torch.eval import harness
    from olmoasr_tpu_torch.normalizers import EnglishTextNormalizer

    parts = {"decode": 0.0, "log_mel": 0.0, "normalizer": 0.0, "wer": 0.0}

    def timed(part, fn, sync):
        def call(*a, **kw):
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            if sync:
                torch.cuda.synchronize()
            parts[part] += time.perf_counter() - t0
            return out
        return call

    model.decode = timed("decode", model.decode, True)
    mel_fn, measures = harness.log_mel_spectrogram, harness.compute_measures
    harness.log_mel_spectrogram = timed("log_mel", mel_fn, True)
    harness.compute_measures = timed("wer", measures, False)
    _reset_counts()
    try:
        result = harness.short_form_eval(
            model, "librispeech_clean", tree, batch_size=EVAL_BATCH, kv_quant=kv_quant,
            normalizer=timed("normalizer", EnglishTextNormalizer(), False))
    finally:
        del model.decode
        harness.log_mel_spectrogram, harness.compute_measures = mel_fn, measures
    counts, steps = _read_counts()
    parts["audio_and_copy"] = result.wall_seconds - sum(parts.values())
    return result, counts, steps, parts


def _check_eval_result(label, result, tree, audio_s, model, kv_quant, out_dir) -> int:
    """n_samples and audio seconds; every hypothesis that of ``model.decode``
    run directly on the same batch; the corpus WER recomputed from
    ``write_results``' per-sample CSV and its text file. Returns how many
    hypotheses of the ragged last batch change when it is padded to
    EVAL_BATCH with its last clip, as the JAX harness pads it (the kernels
    split the work by the row count, so bf16 rounding may flip a near tie:
    counted, not failed)."""
    import csv

    from olmoasr_tpu_torch.audio import log_mel_spectrogram, pad_or_trim
    from olmoasr_tpu_torch.decoding import DecodingOptions
    from olmoasr_tpu_torch.eval import harness
    from olmoasr_tpu_torch.eval.datasets import DatasetFactory
    from olmoasr_tpu_torch.eval.wer import compute_measures
    from olmoasr_tpu_torch.normalizers import EnglishTextNormalizer

    if result.n_samples != EVAL_UTTERANCES or abs(result.audio_seconds - audio_s) > 1e-6:
        fail(f"{label}: {result.n_samples} samples, {result.audio_seconds} s; expected "
             f"{EVAL_UTTERANCES}, {audio_s} s")
    items = DatasetFactory.create_loader("librispeech_clean", tree).load()
    norm = EnglishTextNormalizer()
    options = DecodingOptions(language="en", without_timestamps=True, fp16=True,
                              kv_quant=kv_quant)
    hyps = []
    for i in range(0, len(items), EVAL_BATCH):
        wavs = [pad_or_trim(harness._item_waveform(it)) for it in items[i:i + EVAL_BATCH]]
        mel = log_mel_spectrogram(torch.from_numpy(np.stack(wavs)).cuda())
        hyps += [norm(r.text) for r in model.decode(mel, options)]
    n_real = len(wavs)
    mel = log_mel_spectrogram(torch.from_numpy(np.stack(
        wavs + [wavs[-1]] * (EVAL_BATCH - n_real))).cuda())
    padded = [norm(r.text) for r in model.decode(mel, options)[:n_real]]
    flips = sum(a != b for a, b in zip(padded, hyps[-n_real:]))
    print(f"  {label}: the ragged last batch of {n_real} padded to {EVAL_BATCH}: {flips} of its "
          f"hypotheses differ from the ragged decode's")
    got = [r["hyp"] for r in result.per_sample]
    if got != hyps:
        bad = [k for k, (a, b) in enumerate(zip(got, hyps)) if a != b]
        fail(f"{label}: {len(bad)} hypotheses differ from a direct decode, first {bad[:5]}: "
             f"{got[bad[0]]!r} / {hyps[bad[0]]!r}")
    if not any(hyps):
        fail(f"{label}: every hypothesis is empty")
    harness.write_results(result, out_dir, label.replace(" ", "_"))
    base = os.path.join(out_dir, f"librispeech_clean_{label.replace(' ', '_')}")
    with open(base + "_per_sample.csv", encoding="utf-8") as f:
        rows = list(csv.DictReader(f))
    wer = compute_measures([r["ref"] for r in rows], [r["hyp"] for r in rows]).wer
    with open(base + ".txt") as f:
        text_wer = [line for line in f if line.startswith("wer=")][0].strip()
    if wer != result.wer or text_wer != f"wer={result.wer * 100:.2f}" or len(rows) != len(items):
        fail(f"{label}: the per-sample CSV gives WER {wer}, the text {text_wer}, the result "
             f"{result.wer}")
    return flips


def _validate_fp32() -> dict:
    """fp32 ``validate`` of the narrow model (GRAD_DIMS, its vocabulary cut
    to the byte tokens) on the card and on the CPU on one batch of 2: the
    loss to VAL_LOSS_TOL, the WER equal, the card's argmax ids equal to the
    CPU's wherever the CPU's top two lead by more than LOGIT_TOL."""
    from olmoasr_tpu_torch.models import whisper as model_mod
    from olmoasr_tpu_torch.models.dims import ModelDimensions
    from olmoasr_tpu_torch.models.whisper import PADDING_TOKEN
    from olmoasr_tpu_torch.training import train as train_mod
    from olmoasr_tpu_torch.training.validate import validate

    dims = ModelDimensions(**GRAD_DIMS)
    model = model_mod.init_params(model_mod.empty_model(dims, True),
                                  torch.Generator().manual_seed(0), include_padding_token=True)
    with torch.no_grad():
        model.decoder.token_embedding.weight[256:50256].zero_()
    rng = np.random.default_rng(9)
    T = dims.n_text_ctx
    tokens = rng.integers(0, 256, (2, T + 1))
    pad = np.arange(T)[None] >= np.array([T, 150])[:, None]
    batch = {"mel": rng.standard_normal((2, 80, 3000)).astype(np.float32),
             "text_input": np.where(pad, PADDING_TOKEN, tokens[:, :-1]),
             "text_target": np.where(pad, PADDING_TOKEN, tokens[:, 1:]),
             "padding_mask": np.where(pad, -np.inf, 0.0).astype(np.float32)}
    args = [torch.from_numpy(batch[k]) for k in ("mel", "text_input", "text_target",
                                                  "padding_mask")]
    cpu = validate(model, [batch], compute_dtype=torch.float32)
    with torch.no_grad():
        logits = model_mod.forward_train(model, args[0], args[1], args[3],
                                         compute_dtype=torch.float32)
    top2 = logits.topk(2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > LOGIT_TOL
    model.cuda()
    _reset_counts()
    gpu = validate(model, [batch], compute_dtype=torch.float32)
    counts, _ = _read_counts()
    with torch.no_grad():
        _, aux = train_mod.loss_fn(model, *(a.cuda() for a in args), compute_dtype=torch.float32,
                                   remat=False, return_pred=True)
    differ = int((aux["pred"].cpu() != logits.argmax(-1))[sure].sum())
    loss_err = abs(gpu["val/loss"] - cpu["val/loss"]) / abs(cpu["val/loss"])
    print(f"  validate fp32 (2+2 layers, width 256, B=2): loss {gpu['val/loss']:.6f} (card) vs "
          f"{cpu['val/loss']:.6f} (CPU), relative {loss_err:.2e} (tol {VAL_LOSS_TOL:.0e}); "
          f"WER {gpu['val/wer']:.4f} vs {cpu['val/wer']:.4f}; argmax ids differing at "
          f"{differ} of {int(sure.sum())} positions whose CPU margin exceeds {LOGIT_TOL:.0e} "
          f"(of {sure.numel()}); attention launches {counts['train_attention_fwd']} forward "
          f"{counts['train_attention_bwd']} backward")
    if not loss_err <= VAL_LOSS_TOL or gpu["val/wer"] != cpu["val/wer"] or differ:
        fail(f"validate fp32: loss {loss_err}, WER {gpu['val/wer']} vs {cpu['val/wer']}, "
             f"{differ} argmax ids differ")
    if counts["train_attention_fwd"] != 2 * 3 or counts["train_attention_bwd"]:
        fail(f"validate fp32: attention launches {counts}: one forward, no backward")
    return {"loss_rel_err": loss_err, "wer": gpu["val/wer"], "sure": int(sure.sum())}


def _validate_small(shards: str) -> dict:
    """small.en bf16 ``validate`` (fp32 weights, bf16 compute, as training
    runs) over 2 micro-batches of 16 from the shards' loader."""
    from olmoasr_tpu_torch.models import whisper as model_mod
    from olmoasr_tpu_torch.models.dims import VARIANT_TO_DIMS
    from olmoasr_tpu_torch.training.dataset import (
        AudioTextDataset, BatchLoader, load_jsonl_samples,
    )
    from olmoasr_tpu_torch.training.validate import validate

    dims = VARIANT_TO_DIMS["small.en"]
    model = model_mod.init_params(
        model_mod.empty_model(dims, True, device="cuda", dtype=torch.float32),
        torch.Generator().manual_seed(0), include_padding_token=True)
    loader = BatchLoader(AudioTextDataset(load_jsonl_samples([shards]), dims.n_text_ctx, seed=0),
                         micro_batch_size=16, accum_steps=1, seed=0, num_workers=8)
    batches = []
    for batch in loader:
        batches.append({k: v[0] for k, v in batch.items()})
        if len(batches) == 2:
            break
    validate(model, batches[:1])  # warm-up, not timed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = validate(model, batches)
    wall = time.perf_counter() - t0
    print(f"  validate small.en bf16, 2 micro-batches of 16: wall {wall:.3f} s, loss "
          f"{out['val/loss']:.4f}, WER {out['val/wer']:.4f}")
    if not np.isfinite(out["val/loss"]) or out["val/n_batches"] != 2:
        fail(f"validate small.en: {out}")
    del model
    torch.cuda.empty_cache()
    return {"wall_s": wall, **out}


def _trainer_options(shards: str, tree: str, tmp: str) -> dict:
    """``train_loop.main`` on small.en with the options this slice adds:
    sync eval every 3 steps (eval_max_samples=32; every 3, so that the
    profiler's step 2 holds no eval; the trained embedding cut to the byte
    tokens just before it, as :func:`byte_vocabulary` cuts it, so that its
    hypotheses have text) held to ``short_form_eval`` of the ``best.npz`` it
    wrote, per sample, and the profiler over step 2, then
    async eval every step over a tree of EVAL_ASYNC_UTTERANCES (the harness
    spawned on the card, waited for); then the cast-moment Adam (bf16 mu and nu) on the narrow model: two
    steps through ``main``, its checkpoint restored on the card and on the
    CPU, one more step on the card, and the CPU twin's optimizer step from
    the card's clipped gradients, held to CAST_TOL x the step's lr."""
    from olmoasr_tpu_torch import load_model
    from olmoasr_tpu_torch.eval import harness
    from olmoasr_tpu_torch.models.dims import ModelDimensions
    from olmoasr_tpu_torch.training import checkpoint as ckpt_mod
    from olmoasr_tpu_torch.training import train as train_mod
    from olmoasr_tpu_torch.training import train_loop
    from olmoasr_tpu_torch.training.dataset import (
        AudioTextDataset, BatchLoader, load_jsonl_samples,
    )

    out = {}
    ckpt = os.path.join(tmp, "ckpt")
    prof_dir = os.path.join(tmp, "prof")
    kw = dict(train_shards=shards, ckpt_dir=ckpt, ckpt_every=0, log_every=1, device="cuda",
              eval_set="librispeech_clean")
    small_tree = os.path.join(tmp, "eval_async")
    _eval_tree(small_tree, EVAL_ASYNC_UTTERANCES)
    here = os.getcwd()
    os.chdir(tmp)  # logs/ and eval_results/ go under the working directory
    spawned, evals = [], []
    spawn, sync_eval, short_form = (train_loop.run_async_eval, train_loop.run_sync_eval,
                                    harness.short_form_eval)
    train_loop.run_async_eval = lambda *a: spawned.append(spawn(*a)) or spawned[-1]

    def byte_sync_eval(state, *a, **k):
        byte_vocabulary(state.model)
        return sync_eval(state, *a, **k)

    train_loop.run_sync_eval = byte_sync_eval
    harness.short_form_eval = lambda *a, **k: evals.append(short_form(*a, **k)) or evals[-1]
    try:
        t0 = time.perf_counter()
        sync = train_loop.main(variant="small.en", micro_batch_size=8, eff_batch_size=8,
                               exp_name="eval_sync", eval_every=3, eval_mode="sync",
                               eval_max_samples=32, max_steps_this_run=3, profile_dir=prof_dir,
                               profile_steps=(1, 2), eval_dir=tree, **kw)
        out["sync_run_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        train_loop.main(variant="small.en", micro_batch_size=8, eff_batch_size=8,
                        exp_name="eval_async", eval_every=1, eval_mode="async",
                        max_steps_this_run=1, eval_dir=small_tree, **kw)
        if len(spawned) != 1:
            fail(f"async eval: {len(spawned)} harness processes spawned, expected 1")
        rc = spawned[0].wait(timeout=600)
        out["async_run_s"] = time.perf_counter() - t0
        results = sorted(os.listdir(os.path.join(tmp, "eval_results", "eval_async")))
    finally:
        train_loop.run_async_eval, train_loop.run_sync_eval = spawn, sync_eval
        harness.short_form_eval = short_form
        for proc in spawned:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        os.chdir(here)
    best = os.path.join(ckpt, "eval_sync", "best.npz")
    if not np.isfinite(sync.get("eval/wer", np.nan)) or not os.path.isfile(best) \
            or len(evals) != 1:
        fail(f"sync eval: eval/wer {sync.get('eval/wer')}, best.npz written: "
             f"{os.path.isfile(best)}, {len(evals)} short_form_eval calls")
    want = short_form(load_model(best, device="cuda"), "librispeech_clean", tree, max_samples=32)
    same = sum(a == b for a, b in zip(evals[0].per_sample, want.per_sample))
    print(f"  sync eval against short_form_eval of best.npz: WER {evals[0].wer:.4f} / "
          f"{want.wer:.4f}, {same} of {want.n_samples} samples equal, "
          f"{sum(bool(r['hyp']) for r in want.per_sample)} hypotheses with text")
    if sync["eval/wer"] != want.wer or evals[0].per_sample != want.per_sample \
            or want.n_samples != 32 or not any(r["hyp"] for r in want.per_sample):
        fail(f"sync eval: eval/wer {sync['eval/wer']} against best.npz's {want.wer}, {same} of "
             f"{want.n_samples} samples equal")
    traces = os.listdir(prof_dir)
    with open(os.path.join(prof_dir, traces[0]), encoding="utf-8") as f:
        trace = f.read()
    named = {k: trace.count(k) for k in ("attn_fwd_mma_kernel", "attn_bwd_dq_mma_kernel",
                                         "attn_bwd_dkv_mma_kernel")}
    print(f"  trainer, small.en micro batch 8: sync eval at step 3 over 32 utterances, eval/wer "
          f"{sync['eval/wer']:.4f}, best.npz written, run {out['sync_run_s']:.1f} s; profiler "
          f"trace of step 2 {traces[0]} ({len(trace) / 1e6:.1f} MB), kernel names {named}")
    if len(traces) != 1 or not all(named.values()):
        fail(f"profiler: traces {traces}, row 3 / row 9 kernels named {named}")
    want = [f"librispeech_clean_eval_1.npz{s}" for s in (".json", ".txt", "_per_sample.csv")]
    args = spawned[0].args
    print(f"  async eval: eval_1.npz, the harness spawned with --device "
          f"{args[args.index('--device') + 1]}, exit {rc}, results {results}, run "
          f"{out['async_run_s']:.1f} s")
    if rc != 0 or results != want or args[args.index("--device") + 1] != "cuda":
        fail(f"async eval: exit {rc}, results {results}, arguments {args}")

    dims = ModelDimensions(**GRAD_DIMS)
    bf16 = torch.bfloat16
    cfg = train_mod.TrainConfig(train_steps=10, eff_batch_size=2, micro_batch_size=2,
                                mu_dtype=bf16, nu_dtype=bf16)
    train_loop.main(variant=dims, micro_batch_size=2, eff_batch_size=2, train_steps=10,
                    exp_name="cast", max_steps_this_run=2, mu_dtype="bfloat16",
                    nu_dtype="bfloat16", **{k: v for k, v in kw.items() if k != "eval_set"})
    mgr = ckpt_mod.CheckpointManager(os.path.join(ckpt, "cast"))
    gpu, _ = mgr.restore(train_mod.init_train_state(42, dims, cfg, device="cuda"))
    cpu, _ = mgr.restore(train_mod.init_train_state(42, dims, cfg, device="cpu"))
    stored = {t.dtype for st in gpu.optimizer.state.values()
              for t in (st["exp_avg"], st["exp_avg_sq"])}
    loader = BatchLoader(AudioTextDataset(load_jsonl_samples([shards]), dims.n_text_ctx, seed=1),
                         micro_batch_size=2, accum_steps=1, seed=1, prefetch=0)
    batch = next(iter(loader))
    gpu, metrics = train_mod.make_train_step(dims, cfg)(
        gpu, {k: torch.from_numpy(v).cuda() for k, v in batch.items()})
    lr = float(metrics["lr"])
    for p, q in zip(cpu.model.parameters(), gpu.model.parameters()):
        p.grad = q.grad.cpu()
    cpu.optimizer.param_groups[0]["lr"] = train_mod.lr_schedule(cfg)(2)
    cpu.optimizer.step()
    err = max(float((p.detach() - q.detach().cpu()).abs().max())
              for p, q in zip(cpu.model.parameters(), gpu.model.parameters()))
    print(f"  cast-moment Adam (mu, nu bf16), 2+2 layers width 256: moments stored as "
          f"{sorted(map(str, stored))}; step 3 (lr {lr:.3e}) on the card against the CPU twin's "
          f"optimizer step from the card's gradients: parameters {err:.3e} apart, "
          f"{err / lr:.2e} x the lr (tol {CAST_TOL:.0e} x)")
    if stored != {bf16} or not lr > 0 or not err <= CAST_TOL * lr:
        fail(f"cast-moment step: moments {stored}, lr {lr}, parameters {err} apart")
    out.update({"eval_wer": sync["eval/wer"], "trace_names": named, "cast_err": err,
                "cast_lr": lr})
    return out


def phase_eval() -> dict:
    """The evaluation slice on small.en at full width and depth, seeded
    random weights with the vocabulary cut to the byte tokens
    (:func:`byte_vocabulary`) so that hypotheses have text, bf16:
    ``short_form_eval`` over EVAL_UTTERANCES utterances at batch EVAL_BATCH
    with a bf16 and an int8 cross cache (the split chain, then "sc" +
    ``mlp_block``), each checked against a direct ``decode`` and its written
    results; ``long_form_eval`` (beam 5, best_of 5) of two files; the
    harness's command line in its own process on an ``.npz`` of the same
    weights, against the same run in this process; fp32 ``validate`` on
    the card against the CPU, then small.en's; the trainer's in-loop eval
    (sync, async), profiler and cast-moment Adam."""
    from olmoasr_tpu_torch import build_model, load_model
    from olmoasr_tpu_torch.eval import harness
    from olmoasr_tpu_torch.training import checkpoint as ckpt_mod
    from olmoasr_tpu_torch.training import train as train_mod

    out = {"launches": {}}
    with tempfile.TemporaryDirectory() as tmp:
        tree = os.path.join(tmp, "eval")
        audio_s = _eval_tree(tree)
        model = byte_vocabulary(build_model("small.en", seed=0, device="cuda",
                                            dtype=torch.bfloat16))
        L = model.dims.n_text_layer
        harness.short_form_eval(model, "librispeech_clean", tree, batch_size=4,
                                max_samples=4)  # warm-up: FFT plans, the first launches
        for kv_quant, label, route in ((False, "short_form_bf16", "split"),
                                       (True, "short_form_int8", "sc")):
            result, counts, steps, parts = _timed_short_form(model, tree, kv_quant)
            wall = result.wall_seconds
            host = parts["normalizer"] + parts["wer"] + parts["audio_and_copy"]
            print(f"eval: {label}, small.en, {result.n_samples} utterances, "
                  f"{result.audio_seconds:.1f} s of audio, batch {EVAL_BATCH}: WER "
                  f"{result.wer:.4f}, wall {wall:.3f} s, RTFx {result.rtfx:.1f}; decode "
                  f"{parts['decode']:.3f} s, card log-mel {parts['log_mel']:.3f} s, host "
                  f"{host:.3f} s ({100 * host / wall:.1f}%: audio and copy "
                  f"{parts['audio_and_copy']:.3f}, normalizer {parts['normalizer']:.3f}, WER "
                  f"{parts['wer']:.3f}); {steps} single-token steps; launches "
                  + ", ".join(f"{k} {counts[k]}" for k in (
                      "ln_matmul", "self_attend_decode", "matmul_residual",
                      "cross_block_decode", "mlp_block", "layer_block_decode")))
            _check_decode_counts(label, counts, steps, L, route=route)
            if counts["train_attention_fwd"] != model.dims.n_audio_layer * 2:
                fail(f"{label}: encoder attention launched {counts['train_attention_fwd']} times "
                     f"for 2 batches")
            flips = _check_eval_result(label, result, tree, audio_s, model, kv_quant,
                                       os.path.join(tmp, "results"))
            out[label] = {"wer": result.wer, "wall_s": wall, "rtfx": result.rtfx,
                          "parts_s": parts, "host_share": host / wall, "steps": steps,
                          "padded_last_batch_flips": flips}
            out["launches"][label] = counts

        _reset_counts()
        result = harness.long_form_eval(model, "longset", tree)
        counts, steps = _read_counts()
        print(f"eval: long_form_eval (beam 5, best_of 5), {result.n_samples} files, "
              f"{result.audio_seconds:.0f} s: WER {result.wer:.4f}, wall "
              f"{result.wall_seconds:.3f} s, {result.rtfx:.2f} audio-s/s; launches "
              f"cross_block_decode {counts['cross_block_decode']} (group_kernel "
              f"{counts['cross_block_decode_group']}), self_attend_decode "
              f"{counts['self_attend_decode']} (ancestry {counts['self_attend_decode_beam']})")
        if result.n_samples != 2 or result.audio_seconds != sum(EVAL_LONG_SECONDS) \
                or not counts["cross_block_decode_group"] or not counts["self_attend_decode_beam"]:
            fail(f"long_form_eval: {result.n_samples} files, {result.audio_seconds} s, "
                 f"launches {counts}")
        out["long_form"] = {"wer": result.wer, "wall_s": result.wall_seconds,
                            "audio_s_per_s": result.rtfx}
        out["launches"]["long_form"] = counts

        npz = os.path.join(tmp, "eval.npz")
        ckpt_mod.save_eval_checkpoint(npz, train_mod.TrainState(model, None), model.dims)
        del model
        torch.cuda.empty_cache()
        cli_out, parity_out = os.path.join(tmp, "cli"), os.path.join(tmp, "parity")
        # the parity harness in a process of its own, beside the harness CLI's
        parity = subprocess.Popen(
            [sys.executable, "-m", "olmoasr_tpu_torch.eval.parity", "--ckpt", npz,
             "--eval_dir", tree, "--allow_fallback_tokenizer", "--max_samples",
             str(EVAL_CLI_SAMPLES), "--batch_size", str(EVAL_CLI_SAMPLES), "--out_dir",
             parity_out, "--device", "cuda"], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        try:
            t0 = time.perf_counter()
            proc = _run([sys.executable, "-m", "olmoasr_tpu_torch.eval.harness", "--eval_set",
                         "librispeech_clean", "--eval_dir", tree, "--ckpt", npz, "--out_dir",
                         cli_out, "--max_samples", str(EVAL_CLI_SAMPLES), "--batch_size",
                         str(EVAL_CLI_SAMPLES), "--device", "cuda"], 600)
            cli_s = time.perf_counter() - t0
            parity_stdout, parity_stderr = parity.communicate(timeout=600)
            parity_s = time.perf_counter() - t0
        finally:
            if parity.poll() is None:
                parity.kill()
                parity.wait()
        if parity.returncode != 0:
            fail(f"parity harness exited {parity.returncode}:\n{parity_stdout[-2000:]}\n"
                 f"{parity_stderr[-4000:]}")
        last = json.loads(proc.stdout.strip().splitlines()[-1])
        mine = harness.short_form_eval(load_model(npz, device="cuda"), "librispeech_clean", tree,
                                       batch_size=EVAL_CLI_SAMPLES, max_samples=EVAL_CLI_SAMPLES)
        harness.write_results(mine, os.path.join(tmp, "mine"), "eval.npz")
        csvs = []
        for path in (os.path.join(cli_out, "librispeech_clean_eval.npz_per_sample.csv"),
                     os.path.join(tmp, "mine", "librispeech_clean_eval.npz_per_sample.csv"),
                     os.path.join(parity_out, "librispeech_clean_?_per_sample.csv")):
            with open(path) as f:
                csvs.append(f.read())
        parity_line = next((line for line in parity_stdout.splitlines()
                            if line.startswith("parity: short-form")), "")
        print(f"eval: the harness CLI in its own process on {EVAL_CLI_SAMPLES} utterances: "
              f"{cli_s:.1f} s, WER {last['wer']:.4f}; per-sample rows equal to this "
              f"process's: {csvs[0] == csvs[1]}")
        print(f"eval: the parity harness (python -m olmoasr_tpu_torch.eval.parity "
              f"--allow_fallback_tokenizer) in its own process, beside the harness CLI: "
              f"{parity_s:.1f} s; {parity_line!r}; per-sample rows equal to this process's: "
              f"{csvs[2] == csvs[1]}")
        if csvs[0] != csvs[1] or last["wer"] != mine.wer or last["n_samples"] != mine.n_samples:
            fail(f"harness CLI: {last} against {mine.to_dict()}, per-sample rows equal: "
                 f"{csvs[0] == csvs[1]}")
        if csvs[2] != csvs[1] or f"WER {mine.wer * 100:.2f}% " not in parity_line:
            fail(f"parity harness: {parity_line!r} against WER {mine.wer}, per-sample rows "
                 f"equal: {csvs[2] == csvs[1]}")
        out["cli_s"], out["parity_s"] = cli_s, parity_s

        out["validate_fp32"] = _validate_fp32()
        shards = write_shards(tmp, n=64)
        out["validate_small"] = _validate_small(shards)
        out["trainer"] = _trainer_options(shards, tree, tmp)
    return out


# ---------------------------------------------------------------------------
# --ab: the kernels of two trees on the same inputs
# ---------------------------------------------------------------------------


def _ab_inputs(gen) -> dict:
    """name -> (kind, args, keyword args) of the compared cases: the int8
    cross pass (served requests, and their beams), the outlier-q case of
    both, the self pass at 160 rows without a map, with the identity map and
    with a random one, the self + cross sub-blocks of a greedy int8 step,
    at offsets 224, 100 and 1, the whole layer at 224, ``mlp_block`` of its
    64 rows and at 160, ``matmul_residual`` at 64 and 160 rows, ``ln_matmul``
    at 64, ``cross_attend_decode`` over 64 windows' bf16 cross cache, the
    training attention's forward and backward (rows 3 and 9) at the three
    training shapes, then ``ln_matmul`` at 160 rows, the cross sub-block
    over a bf16 cross cache at 64 rows over 64 and 160 over 32, and the
    flash route's forward and backward (row 10) at ``check_flash``'s bf16
    shapes, the self pass at the greedy 64 rows without a map at offsets 1
    and 224, ``cross_attend_decode`` over an int8 cache at 64 rows, rows 8
    (over bf16 and int8) and 4 (offset 224) at 1 and 5 rows, then row 4a
    (int8 rings, offset 224) at 1, 5 and 64 rows and the cross sub-block
    over an int8 cache at 32 windows x 5. Rings are one layer deep: a call
    reads one layer."""
    from olmoasr_tpu_torch.models.whisper import _quantize_rows

    D, H, T, K, C = 768, 12, 1500, 5, 225
    out = {}
    for B, G in ((64, 1), (16, K)):
        x = torch.randn(B * G, 1, D, generator=gen).to("cuda", torch.bfloat16)
        w = [(1 + 0.1 * torch.randn(D, generator=gen)), 0.1 * torch.randn(D, generator=gen),
             torch.randn(D, D, generator=gen) * (2 / D) ** 0.5,
             0.02 * torch.randn(D, generator=gen),
             torch.randn(D, D, generator=gen) * (2 / D) ** 0.5,
             0.02 * torch.randn(D, generator=gen)]
        (ck, ks), (cv, vs) = (_quantize_rows(torch.randn(B, T, D, generator=gen).cuda())
                              for _ in range(2))
        out[f"cross int8, {B * G} rows over {B}"] = (
            "cross", (x, *[t.to("cuda", torch.bfloat16) for t in w], ck, cv,
                      ks[:, None].contiguous(), vs[:, None].contiguous(), H), {"kv_group": G})
        out[f"cross int8 outlier q, {B * G} rows over {B}"] = (
            "cross", outlier_q_case(gen, B, T, D, H, G), {"kv_group": G})
    rows = 32 * K
    qkv = torch.randn(rows, 1, 3 * D, generator=gen).to("cuda", torch.bfloat16)
    rings = [torch.randn(1, rows, C, D, generator=gen).to("cuda", torch.bfloat16)
             for _ in range(2)]
    self_args = (qkv, *rings, C - 1, 0)  # q, k_new, v_new: views of qkv, see _self_views
    ident = (torch.arange(rows, dtype=torch.int32) % K)[:, None].expand(rows, C).contiguous()
    maps = {"no map": None, "identity map": ident,
            "random map": torch.randint(0, K, (rows, C), generator=gen, dtype=torch.int32)}
    for label, anc in maps.items():
        kw = {"n_head": H} if anc is None else {"n_head": H, "beam_anc": anc.cuda(), "beam_k": K}
        out[f"self bf16, {rows} rows, offset {C - 1}, {label}"] = ("self", self_args, kw)
    layer = layer_block_args(gen, torch.bfloat16, L=1)
    for offset in (224, 100, 1):
        out[f"self + cross int8, 64 rows, offset {offset}"] = (
            "layer", (*layer, offset, 0), {"n_head": H})
    mlp = _mlp_args(gen, torch.bfloat16)
    out["whole layer int8, 64 rows, offset 224"] = (
        "layer", (*layer, 224, 0), {"n_head": H, "include_mlp": True, "mlp": mlp})
    out["mlp bf16, 64 rows"] = ("mlp", (layer[0], *mlp), {})
    # rows 2 and 6 at the beam's 160 rows too; row 6 beside its greedy 64
    rows_bf = lambda n: torch.randn(n, 1, D, generator=gen).to("cuda", torch.bfloat16)
    out["mlp bf16, 160 rows"] = ("mlp", (rows_bf(160), *mlp), {})
    wo = _weights(gen, D, D, fan_in=D, dtype=torch.bfloat16)
    bo = (0.02 * torch.randn(D, generator=gen)).to("cuda", torch.bfloat16)
    for n in (64, 160):
        out[f"matmul_residual bf16, {n} rows"] = ("mr", (rows_bf(n), rows_bf(n), wo, bo), {})
    # row 5 at the greedy 64 rows, and row 8
    wqkv = _weights(gen, 3 * D, D, fan_in=D, dtype=torch.bfloat16)
    bqkv = (0.02 * torch.randn(3 * D, generator=gen)).to("cuda", torch.bfloat16)
    out["ln_matmul bf16, 64 rows"] = ("lnmm", (rows_bf(64), *mlp[:2], wqkv, bqkv), {})
    kv = [torch.randn(64, T, D, generator=gen).to("cuda", torch.bfloat16) for _ in range(2)]
    out[f"cross_attend_decode bf16, 64 rows, T={T}"] = ("xattn", (rows_bf(64), *kv),
                                                         {"n_head": H})
    # rows 3 and 9 at small.en's training shapes: the encoder (the forward at
    # the inference batch of 64, the backward at the micro batch of 16), the
    # decoder's causal self-attention with suffix pads, the cross attention
    lengths = torch.linspace(20, 448, 16).round()
    pad_bias = torch.where(torch.arange(448)[None] < lengths[:, None], 0.0, float("-inf"))
    bf = lambda *shape: torch.randn(*shape, generator=gen).to(torch.bfloat16)
    for kind, B in (("train fwd", 64), ("train bwd", 16)):
        extra = 1 if kind == "train bwd" else 0  # the output's gradient
        for label, Tq, Tk, kw in (("encoder 1500x1500", 1500, 1500, {}),
                                  ("decoder self 448 causal + pad bias", 448, 448,
                                   {"causal": True, "key_bias": pad_bias}),
                                  ("cross 448x1500", 448, 1500, {})):
            B = B if Tq == 1500 else 16
            q, k, v = bf(B, Tq, D), bf(B, Tk, D), bf(B, Tk, D)
            args = (q, k, v, *[bf(B, Tq, D) for _ in range(extra)], H)
            out[f"{kind} {label}, B={B}"] = (kind, args, kw)
    # rows 5 and 1 on the split chain (the bf16 greedy and beam steps): QKV
    # at the beam's 160 rows, the cross sub-block over a bf16 cross cache at
    # 64 windows and at 32 windows x 5 (last, so that the cases above keep
    # the inputs of earlier trees' runs)
    out["ln_matmul bf16, 160 rows"] = ("lnmm", (rows_bf(160), *mlp[:2], wqkv, bqkv), {})
    for B, G in ((64, 1), (32, K)):
        w = [(1 + 0.1 * torch.randn(D, generator=gen)).to("cuda", torch.bfloat16),
             (0.1 * torch.randn(D, generator=gen)).to("cuda", torch.bfloat16),
             _weights(gen, D, D, fan_in=D, dtype=torch.bfloat16),
             (0.02 * torch.randn(D, generator=gen)).to("cuda", torch.bfloat16),
             _weights(gen, D, D, fan_in=D, dtype=torch.bfloat16),
             (0.02 * torch.randn(D, generator=gen)).to("cuda", torch.bfloat16)]
        cache = [torch.randn(B, T, D, generator=gen).to("cuda", torch.bfloat16) for _ in range(2)]
        ones = torch.ones(B, 1, T, device="cuda")
        out[f"cross bf16, {B * G} rows over {B}"] = (
            "cross", (rows_bf(B * G), *w, *cache, ones, ones, H), {"kv_group": G})
    # row 10 at check_flash's bf16 shapes (the backward from the plain
    # forward's residuals, so that both trees read the same ones)
    from olmoasr_tpu_torch.ops.flash import flash_mha_fwd_plain

    pad_ids = (torch.arange(448)[None] >= lengths[:, None]).int()
    for kind in ("flash fwd", "flash bwd"):
        for label, Tq, Tk, causal, ids in (("encoder 1500x1500", 1500, 1500, False, None),
                                           ("decoder self 448 causal + pad ids", 448, 448, True,
                                            pad_ids),
                                           ("cross 448x1500", 448, 1500, False, None)):
            B = 64 if kind == "flash fwd" and Tq == 1500 else 16
            q, k, v = bf(B, Tq, D), bf(B, Tk, D), bf(B, Tk, D)
            if kind == "flash fwd":
                args = (q, k, v, H, causal, ids, ids)
            else:
                gpu = lambda t: None if t is None else t.cuda()
                o, m, l = (t.cpu() for t in flash_mha_fwd_plain(
                    *map(gpu, (q, k, v)), H, causal, gpu(ids), gpu(ids)))
                args = (q, k, v, o, m, l, bf(B, Tq, D), H, causal, ids, ids)
            out[f"{kind} {label}, B={B}"] = (kind, args, {})
    # rows 4 and 8 on the single-pass core: the self pass at the greedy 64
    # rows without a map, and the standalone cross attention over an int8
    # cache (last, so that the cases above keep the inputs of earlier trees'
    # runs)
    qkv64 = torch.randn(64, 1, 3 * D, generator=gen).to("cuda", torch.bfloat16)
    rings64 = [torch.randn(1, 64, C, D, generator=gen).to("cuda", torch.bfloat16)
               for _ in range(2)]
    for offset in (1, 224):
        out[f"self bf16, 64 rows, offset {offset}, no map"] = (
            "self", (qkv64, *rings64, offset, 0), {"n_head": H})
    (k8, ks8), (v8, vs8) = (_quantize_rows(torch.randn(64, T, D, generator=gen).cuda())
                            for _ in range(2))
    out[f"cross_attend_decode bf16 over int8, 64 rows, T={T}"] = (
        "xattn", (rows_bf(64), k8, v8, ks8, vs8[:, None].contiguous()), {"n_head": H})
    # rows 8 and 4 at one file's greedy step and a small server batch's,
    # where the single-pass core splits a (row, head) pair's keys over a
    # cluster (last, as above)
    for n in (1, 5):
        kv = [torch.randn(n, T, D, generator=gen) for _ in range(2)]
        out[f"cross_attend_decode bf16, B={n}, T={T}"] = (
            "xattn", (rows_bf(n), *[t.to("cuda", torch.bfloat16) for t in kv]), {"n_head": H})
        (k8, ks8), (v8, vs8) = (_quantize_rows(t.cuda()) for t in kv)
        out[f"cross_attend_decode bf16 over int8, B={n}, T={T}"] = (
            "xattn", (rows_bf(n), k8, v8, ks8, vs8[:, None].contiguous()), {"n_head": H})
        qkv_n = torch.randn(n, 1, 3 * D, generator=gen).to("cuda", torch.bfloat16)
        rings_n = [torch.randn(1, n, C, D, generator=gen).to("cuda", torch.bfloat16)
                   for _ in range(2)]
        out[f"self bf16, B={n}, offset 224, no map"] = (
            "self", (qkv_n, *rings_n, 224, 0), {"n_head": H})
    # row 4a (int8 rings) at one file's greedy step, a small server batch's
    # and the greedy 64 rows, and row 1 over an int8 cross cache at 32
    # windows x 5 (last, as above)
    for n in (1, 5, 64):
        qkv_n = torch.randn(n, 1, 3 * D, generator=gen).to("cuda", torch.bfloat16)
        (k8, ks8), (v8, vs8) = (_quantize_rows(torch.randn(1, n, C, D, generator=gen).cuda())
                                for _ in range(2))
        out[f"self bf16 over int8 rings, B={n}, offset 224"] = (
            "self", (qkv_n, k8, v8, 224, 0),
            {"n_head": H, "k_scale": ks8[:, :, None].contiguous(),
             "v_scale": vs8[:, :, None].contiguous()})
    B, G = 32, K
    x = rows_bf(B * G)
    w = [(1 + 0.1 * torch.randn(D, generator=gen)).to("cuda", torch.bfloat16),
         (0.1 * torch.randn(D, generator=gen)).to("cuda", torch.bfloat16),
         _weights(gen, D, D, fan_in=D, dtype=torch.bfloat16),
         (0.02 * torch.randn(D, generator=gen)).to("cuda", torch.bfloat16),
         _weights(gen, D, D, fan_in=D, dtype=torch.bfloat16),
         (0.02 * torch.randn(D, generator=gen)).to("cuda", torch.bfloat16)]
    (ck, ks), (cv, vs) = (_quantize_rows(torch.randn(B, T, D, generator=gen).cuda())
                          for _ in range(2))
    out[f"cross int8, {B * G} rows over {B}"] = (
        "cross", (x, *w, ck, cv, ks[:, None].contiguous(), vs[:, None].contiguous(), H),
        {"kv_group": G})
    return out


def _self_views(args):
    """self_attend_decode's arguments from (qkv, k_ring, v_ring, offset,
    layer): q, k_new and v_new as row views of the fused projection, as
    decode_step passes them."""
    qkv, k_ring, v_ring, offset, layer = args
    D = k_ring.shape[-1]
    return qkv[..., :D], k_ring, v_ring, qkv[..., D:2 * D], qkv[..., 2 * D:], offset, layer


def _ab_call(A, kind, args, kw, TA=None, F=None):
    """The tree's kernel for a case (module A is its ops.attention, TA its
    ops.train_attention, F its ops.flash), or None where the tree does not
    have it; "layer" falls back to the split chain and returns the residual
    only."""
    import inspect

    if kind == "flash fwd":
        return lambda: F.flash_mha_fwd(*args, **kw)
    if kind == "flash bwd":
        return lambda: F.flash_mha_bwd(*args, **kw)
    if kind == "train fwd":
        return lambda: TA.train_attention_fwd(*args, **kw)
    if kind == "train bwd":
        return lambda: TA.train_attention_bwd(*args, **kw)
    if kind == "cross":
        return lambda: A.cross_block_decode(*args, **kw)
    if kind == "mlp":
        return lambda: A.mlp_block(*args)
    if kind == "mr":
        return lambda: A.matmul_residual(*args)
    if kind == "lnmm":
        return lambda: A.ln_matmul(*args)
    if kind == "xattn":
        return lambda: A.cross_attend_decode(*args, **kw)
    if kind == "self":
        if "beam_anc" in kw and "beam_anc" not in inspect.signature(A.self_attend_decode).parameters:
            return None
        return lambda: A.self_attend_decode(*_self_views(args), **kw)
    if hasattr(A, "layer_block_decode"):
        return lambda: A.layer_block_decode(*args, **kw)[0]
    return lambda: _chain(args[:-2], args[-2], args[-1], kw["n_head"])


def _import_tree(root: str) -> None:
    """Put the checkout at ROOT first on the path, and make sure its package
    is the one imported."""
    sys.path.insert(0, os.path.abspath(root))
    from olmoasr_tpu_torch.ops import attention as A
    from olmoasr_tpu_torch.ops import flash as F
    from olmoasr_tpu_torch.ops import train_attention as TA

    for mod in (A, TA, F):
        if not os.path.abspath(mod.__file__).startswith(os.path.abspath(root)):
            fail(f"imported {mod.__file__}, not the tree at {root}")


def kernel_cases(root: str, inputs: str, out: str) -> None:
    """``--kernel-cases ROOT INPUTS OUT``: the kernels of the checkout at
    ROOT on the saved inputs; outputs and device times (``timed_ms``, and
    with each replay queued behind a spin) saved to OUT."""
    _import_tree(root)
    from olmoasr_tpu_torch.ops import attention as A
    from olmoasr_tpu_torch.ops import flash as F
    from olmoasr_tpu_torch.ops import train_attention as TA

    results = {}
    for name, (kind, args, kw) in torch.load(inputs).items():
        to = lambda a: a.cuda() if torch.is_tensor(a) else [to(t) for t in a] \
            if isinstance(a, list) else a
        args, kw = [to(a) for a in args], {k: to(v) for k, v in kw.items()}
        fn = _ab_call(A, kind, args, kw, TA, F)
        if fn is None:
            results[name] = None
            continue
        got = fn()
        got = tuple(x.cpu() for x in got) if isinstance(got, tuple) else got.cpu()
        results[name] = {"out": got, "ms": timed_ms(fn), "ms_spin": timed_ms(fn, spin=True)}
        if kind in ("self", "xattn"):  # the wrappers' own host cost
            results[name]["host_us"] = host_us(fn)
        del args, kw, fn
        torch.cuda.empty_cache()
    torch.save(results, out)


GREEDY_STEPS = ("greedy int8 step, 64 rows", "greedy bf16 step, route split, 64 rows")
# the processes of the greedy steps under --ab: the host clock moves between
# processes, so each tree gets four, alternating
STEP_ORDER = ("tree", "this", "this", "tree") * 2


def greedy_steps(root: str, out: str) -> None:
    """``--greedy-steps ROOT OUT``: :func:`_greedy_steps` through the
    checkout at ROOT, saved to OUT."""
    _import_tree(root)
    torch.save(_greedy_steps(), out)


def _greedy_steps() -> dict:
    """Two greedy steps of small.en over 64 windows, host clock against
    kernel time: over an int8 cross cache (the served path, end to end of
    the step) and along ``route="split"`` over a bf16 cross cache, whose
    layers run rows 5, 4, 6, 1 and 2 once each."""
    from olmoasr_tpu_torch import build_model
    from olmoasr_tpu_torch import decoding as dec
    from olmoasr_tpu_torch.audio import N_SAMPLES, log_mel_spectrogram
    from olmoasr_tpu_torch.decoding import DecodingOptions
    from olmoasr_tpu_torch.models.whisper import encode_audio

    model = build_model("small.en", seed=0, device="cuda", dtype=torch.bfloat16)
    audio = np.random.default_rng(0).standard_normal((64, N_SAMPLES)).astype(np.float32) * 0.1
    mel = log_mel_spectrogram(torch.from_numpy(audio).cuda())
    options = DecodingOptions(language="en")
    prompt = dec._resolve_prompt(dec.get_tokenizer(multilingual=False), options)
    return {GREEDY_STEPS[0]: _profile_greedy_step(model, mel, DecodingOptions(language="en",
                                                                             kv_quant=True)),
            GREEDY_STEPS[1]: _profile_route_step(model, encode_audio(model, mel), prompt, "split",
                                                 64)}


def _verdict(rows, key: str) -> tuple:
    """("faster", "slower" or "within", this checkout's median over the
    tree's) for this checkout's runs against the tree's on ``key``."""
    this = [r[key] for r in rows if r["tree"] == "this"]
    tree = [r[key] for r in rows if r["tree"] == "tree"]
    word = "faster" if max(this) < min(tree) else "slower" if min(this) > max(tree) else "within"
    return word, statistics.median(this) / statistics.median(tree)


def kernel_ab(tree: str) -> None:
    """``--ab TREE``: the cases of :func:`_ab_inputs` through the kernels of
    the checkout at TREE and of this one, in the order TREE, this, this, TREE,
    each run in its own process on the same saved inputs; each output held to
    this checkout's twins (the int8 cross cases also to the exact-q twin; the
    attention backward's dq, dk and dv each to two bf16 steps of its own).
    Each case's time is taken twice, by ``timed_ms`` and with each replay
    queued behind a spin, and judged under each: "faster" where both runs
    of this checkout are below both of TREE, "slower" where both are above,
    else "within"; the decode attention wrappers' cases (rows 4 and 8) also
    by their host time a call (:func:`host_us`). Then the two greedy steps of :func:`_greedy_steps`, in
    processes of their own in the order STEP_ORDER: each tree's host ms,
    kernel ms and device launches, their medians and spread.
    Fails if this checkout's kernels leave the tolerance."""
    from olmoasr_tpu_torch.ops import attention as A
    from olmoasr_tpu_torch.ops import flash as F
    from olmoasr_tpu_torch.ops import train_attention as TA

    here = os.path.dirname(os.path.abspath(__file__))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    cases = _ab_inputs(torch.Generator().manual_seed(0))
    refs = {}
    for name, (kind, args, kw) in cases.items():
        if kind == "cross":
            exact = args[7].dtype == torch.int8  # the int8 cache: also the exact-q twin
            refs[name] = (A.cross_block_decode_plain(*args, **kw),
                          A.cross_block_decode_plain(*args, **kw, quantize_q=False)
                          if exact else None)
        elif kind == "self":
            refs[name] = (A.self_attend_decode_plain(*_self_views(args), **kw), None)
        elif kind in ("train fwd", "train bwd", "flash fwd", "flash bwd"):
            gpu = lambda a: a.cuda() if torch.is_tensor(a) else a
            plain = {"train fwd": TA.train_attention_fwd_plain,
                     "train bwd": TA.train_attention_bwd_plain,
                     "flash fwd": F.flash_mha_fwd_plain,
                     "flash bwd": F.flash_mha_bwd_plain}[kind]
            want = plain(*map(gpu, args), **{n: gpu(x) for n, x in kw.items()})
            refs[name] = (tuple(x.cpu() for x in want) if isinstance(want, tuple)
                          else want.cpu(), None)
        elif kind == "mlp":
            refs[name] = (A.mlp_block_plain(*args), None)
        elif kind == "mr":
            refs[name] = (A.matmul_residual_plain(*args), None)
        elif kind == "lnmm":
            refs[name] = (A.ln_matmul_plain(*args), None)
        elif kind == "xattn":
            refs[name] = (A.cross_attend_decode_plain(*args, **kw), None)
        else:
            refs[name] = (A.layer_block_decode_plain(*args, **kw)[0], None)
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        inputs = os.path.join(tmp, "inputs.pt")
        cpu = lambda a: a.cpu() if torch.is_tensor(a) else [cpu(t) for t in a] \
            if isinstance(a, list) else a
        torch.save({k: (kind, [cpu(a) for a in args], {n: cpu(v) for n, v in kw.items()})
                    for k, (kind, args, kw) in cases.items()}, inputs)
        for label, root in (("tree", tree), ("this", here), ("this", here), ("tree", tree)):
            out = os.path.join(tmp, f"run{len(runs)}.pt")
            _run([sys.executable, os.path.abspath(__file__), "--kernel-cases", root, inputs, out],
                 900)
            runs.append((label, torch.load(out)))
    report, bad = {}, []
    for name, (want, exact) in refs.items():
        parts = tuple(w.cpu() for w in (want if isinstance(want, tuple) else (want,)))
        tol = min(bf16_tol(w) for w in parts)
        report[name] = []
        for label, results in runs:
            r = results[name]
            if r is None:
                print(f"  {name} [{label}]: not in this tree")
                report[name].append(None)
                continue
            got = r["out"] if isinstance(r["out"], tuple) else (r["out"],)
            errs = [max_err(g, w) for g, w in zip(got, parts)]  # each to its own tolerance
            ok = all(e <= bf16_tol(w) for e, w in zip(errs, parts))
            err = max(errs)
            row = {"tree": label, "ms": r["ms"], "ms_spin": r["ms_spin"], "max_abs_err": err,
                   "tol": tol}
            line = (f"  {name} [{label}]: {r['ms']:.4f} ms ({r['ms_spin']:.4f} behind a spin), "
                    f"max_abs_err {err:.3e} (tol {tol:.3e})")
            if "host_us" in r:
                row["host_us"] = r["host_us"]
                line += f", host {r['host_us']:.1f} us a call"
            if exact is not None:
                row["exact_q_err"] = max_err(r["out"], exact.cpu())
                line += f", against the exact-q twin {row['exact_q_err']:.3e}"
            print(line)
            report[name].append(row)
            if label == "this" and not ok:
                bad.append(f"{name}: {errs} against two bf16 steps of each output")
        if all(report[name]):
            verdicts = {key: _verdict(report[name], key) for key in ("ms", "ms_spin", "host_us")
                        if all(key in r for r in report[name])}
            labels = {"ms": "", "ms_spin": "behind a spin: ", "host_us": "host: "}
            print("  " + name + ": this checkout " + "; ".join(
                f"{labels[key]}{word} (median {ratio:.3f} of the tree's)"
                for key, (word, ratio) in verdicts.items()))
            report[name].append({"verdict": verdicts})
    steps = {step: {"tree": [], "this": []} for step in GREEDY_STEPS}
    with tempfile.TemporaryDirectory() as tmp:
        for i, label in enumerate(STEP_ORDER):
            out = os.path.join(tmp, f"steps{i}.pt")
            _run([sys.executable, os.path.abspath(__file__), "--greedy-steps",
                  tree if label == "tree" else here, out], 600)
            for step, r in torch.load(out).items():
                steps[step][label].append(r)
    for step in GREEDY_STEPS:
        report[step] = {}
        for label in ("tree", "this"):
            runs_of = steps[step][label]
            stats = {key: sorted(r[key] or float("nan") for r in runs_of)
                     for key in ("host_ms", "kernel_ms", "device_launches")}
            report[step][label] = {key: {"runs": v, "median": statistics.median(v)}
                                   for key, v in stats.items()}
            print(f"  {step} [{label}, {len(runs_of)} processes]: " + ", ".join(
                f"{key} median {statistics.median(v):.3f} ({v[0]:.3f}-{v[-1]:.3f})"
                for key, v in stats.items()))
    print(json.dumps({"ab": report}))
    if bad:
        fail("this checkout's kernels left the tolerance: " + "; ".join(bad))


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device")
    try:
        import olmoasr_tpu_torch  # noqa: F401
    except ImportError as exc:
        fail(f"run from the root of a checkout of the repository: {exc}")
    exact_fp32()

    def timed(phase, *args):
        t0 = time.perf_counter()
        out = phase(*args)
        print(f"[{phase.__name__}: {time.perf_counter() - t0:.1f} s]")
        return out

    timed(phase_identity)
    cases = timed(phase_kernels)
    probes = timed(phase_probes)
    short = timed(phase_slice)
    long_form = timed(phase_long_form)
    words = timed(phase_word_timestamps)
    server = timed(phase_server_traffic)
    routes = timed(phase_routes)
    timed(phase_teacher_forced)
    timed(phase_alignment_fp32)
    language = timed(phase_language)
    training = timed(phase_training)
    training_mel = timed(phase_training_device_mel, training)
    training_flash = timed(phase_training_flash)
    training_dist = timed(phase_training_distributed, training_mel)
    training_mel.pop("params")
    timed(phase_train_fp32)
    timed(phase_entry_points)
    decode_ranks = timed(phase_decode_ranks)
    evaluation = timed(phase_eval)
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "optax", "orbax",
                                                                   "olmoasr_tpu", "olmoasr"))
    if leaked:
        fail(f"imported {leaked}: the port must not load jax, the JAX package or its shim")

    # each kernel's sources (its CUDA files, the first its own) and the TPU
    # kernel it replaces
    C = "olmoasr_tpu_torch/csrc/"
    sources = {
        "cross_block_decode": ((C + "cross_attention.cu", C + "decode_attention.cuh",
                                C + "skinny_proj.cu"), "olmoasr_tpu/ops/attention.py:986"),
        "layer_block_decode": ((C + "decode_layer.cu",), "olmoasr_tpu/ops/attention.py:1228"),
        "mlp_block": ((C + "skinny_proj.cu",), "olmoasr_tpu/ops/attention.py:669"),
        "train_attention_fwd": ((C + "train_attention.cu",),
                                "olmoasr_tpu/ops/train_attention.py:222"),
        "ln_matmul": ((C + "skinny_proj.cu",), "olmoasr_tpu/ops/attention.py:354"),
        "matmul_residual": ((C + "skinny_proj.cu",), "olmoasr_tpu/ops/attention.py:412"),
        "self_attend_decode": ((C + "self_attention.cu", C + "decode_attention.cuh"),
                               "olmoasr_tpu/ops/attention.py:495"),
        "self_attend_decode_beam": ((C + "self_attention.cu",),
                                    "olmoasr_tpu/ops/attention.py:254"),
        "train_attention_bwd": ((C + "train_attention.cu",),
                                "olmoasr_tpu/ops/train_attention.py:412"),
        "self_attend_decode_q8": ((C + "self_attention.cu", C + "decode_attention.cuh"),
                                  "olmoasr_tpu/ops/attention.py:322"),
        "cross_attend_decode": ((C + "cross_attention.cu", C + "decode_attention.cuh"),
                                "olmoasr_tpu/ops/attention.py:725"),
        "layer_block_decode_mlp": ((C + "decode_layer.cu",), "olmoasr_tpu/ops/attention.py:1228"),
        "flash_mha_fwd": ((C + "flash_attention.cu", C + "attention_mma.cuh"),
                          "olmoasr_tpu/ops/flash.py:72"),
        "flash_mha_bwd": ((C + "flash_attention.cu", C + "attention_mma.cuh"),
                          "olmoasr_tpu/ops/flash.py:72"),
    }
    # the path that runs each kernel: the long-form slice at the CLI's
    # defaults, for the fused launch the server's default traffic, for the
    # backward the training slice, for the flash kernels the flash training
    # run, for the int8 self pass the int8-ring loop, for the whole layer and
    # the standalone cross attention their routes
    paths = {"layer_block_decode": server, "train_attention_bwd": training,
             "flash_mha_fwd": training_flash, "flash_mha_bwd": training_flash,
             "self_attend_decode_q8": routes["int8 rings"],
             "layer_block_decode_mlp": routes["route layer"],
             "cross_attend_decode": routes["route attend"]}
    kernels = []
    for name, (files, replaces) in sources.items():
        main_case = cases[name][0]  # the main path's shape and dtype
        path = paths.get(name, long_form)
        kernels.append({
            "name": name, "route": "cuda", "source": files[0], "sources": list(files),
            "replaces": replaces,
            "launches": path["launches"][name],
            "launches_long_form": long_form["launches"][name],
            "launches_server_traffic": server["launches"][name],
            "launches_short_form": {k: v["launches"][name] for k, v in short.items()},
            "launches_training_step": training["launches"].get(name, 0),
            "launches_training_device_mel_step": training_mel["launches"].get(name, 0),
            "launches_word_timestamps": {k: v["launches"][name] for k, v in words.items()},
            "launches_detect_language": {k: language[k]["launches"][name]
                                         for k in ("B=1", "B=8")},
            "launches_training_flash_step": training_flash["launches"].get(name, 0),
            "launches_training_distributed_step":
                training_dist["world1"]["launches"].get(name, 0),
            "launches_routes": {k: v["launches"][name] for k, v in routes.items()},
            "launches_decode_ranks": decode_ranks["launches"][name],
            "launches_serve_ranks": decode_ranks["serve"]["launches"][name],
            "launches_eval": {k: v[name] for k, v in evaluation["launches"].items()},
            "max_abs_err": max(c["max_abs_err"] for c in cases[name]),
            "ms": main_case["ms"], "ms_spin": main_case["ms_spin"],
            "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
            "library_ms": main_case.get("library_ms"),
            "cases": cases[name],
        })
    for name, probe in probes.items():  # their path is the probes' own run
        kernels.append({"name": name, "route": "cuda",
                        "source": C + "attention_probes.cu", "sources": [C + "attention_probes.cu"],
                        **{key: probe[key] for key in (
                            "replaces", "launches", "max_abs_err", "ms", "ms_spin", "plain_ms",
                            "bound_ms", "bound_by", "library_ms", "cases")}})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    if len(sys.argv) > 1:
        if not torch.cuda.is_available():
            fail("no CUDA device")
        if sys.argv[1] == "--ab" and len(sys.argv) == 3:
            kernel_ab(sys.argv[2])
        elif sys.argv[1] == "--kernel-cases" and len(sys.argv) == 5:
            kernel_cases(*sys.argv[2:])
        elif sys.argv[1] == "--greedy-steps" and len(sys.argv) == 4:
            greedy_steps(*sys.argv[2:])
        elif sys.argv[1] == "--train-rank" and len(sys.argv) == 3:
            _train_rank(sys.argv[2])  # one rank of phase_training_distributed, under torchrun
        elif sys.argv[1] == "--decode-rank" and len(sys.argv) == 3:
            _decode_rank(sys.argv[2])  # one rank of phase_decode_ranks (a), under torchrun
        elif sys.argv[1] == "--cli-rank" and len(sys.argv) == 3:
            _cli_rank(sys.argv[2])  # the CLI of phase_decode_ranks (b)
        elif sys.argv[1] == "--serve-rank" and len(sys.argv) == 3:
            _serve_rank(sys.argv[2])  # a server of phase_decode_ranks (c)
        else:
            fail(f"usage: {sys.argv[0]} [--ab TREE]")
    else:
        main()
