"""Smoke run of the PyTorch/CUDA port (``olmoasr_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases, one
printed line each (or a few):

1. identity and build: the card's name and power limit, torch and CUDA
   versions, the kernels compiled from ``olmoasr_tpu_torch/csrc``;
2. every kernel against its plain PyTorch twin at the slices' shapes, with
   the tolerance and the device times of both (CUDA events around replays of
   a CUDA graph of one call, median of 11 runs): the attention forward and
   backward at the three training shapes, the beam-ancestry
   ``self_attend_decode``, the fused ``layer_block_decode`` (beside the time
   of the split kernels it replaces) and the int8 q.K ``cross_block_decode``
   included, the last also on a case where the int8 and the exact q.K
   products land far apart, so that a kernel computing the wrong one fails;
3. the short-form slice: small.en at full width with seeded random weights,
   64 windows of 30 s noise, GPU log-mel, greedy ``decode`` with bf16 and
   with int8 cross K/V (the fused self + cross launch); then beam search, 32
   windows x ``beam_size=5``, in bf16 and int8; for each the host time of
   one step against its summed kernel time (``torch.profiler``), wall time,
   audio-seconds per second, kernel launch counts;
4. the long-form slice at the CLI's defaults: small.en in bf16, 16 files of
   40-75 s of seeded noise through ``transcribe_many(batch_size=16)`` with
   ``beam_size=5`` at temperature 0, the default ladder and thresholds and
   best_of=5 above it (random weights fail the gates, so every window climbs
   the whole ladder); wall time, audio-seconds per second, windows per
   temperature, single-token steps, every kernel's launches, the results'
   schema; then the server's default traffic in this process: the port's
   ``BatchingService`` with int8 cross K/V and no beam, 8 requests at once
   (greedy at t=0, one sample per window above, every step fused);
5. a teacher-forced fp32 check: the same weights and tokens through the
   port on the GPU (kernels) and on the CPU (plain twins), 2 windows with 2
   token rows each (the shared cross cache), then 2 windows over an int8
   cross cache (the fused launch);
6. the training slice: small.en at full width and depth through
   ``train_loop.main`` on 256 synthetic samples (micro batch 16, effective
   32, remat), 6 steps and a resumed seventh; the attention forward and
   backward launches of every step, the parameters after steps 1 (lr 0) and
   2, audio-seconds and tokens a second over steps 2-5 with the loader's
   waits, each step's wall and the loader's work inside it, one step with
   the loader held back, peak memory, the kernels' device time
   (``torch.profiler``, the resumed step) and the step's FLOPs against 989
   TFLOP/s; then an fp32 ``loss_fn`` and backward of a narrow model on the
   card against the CPU twins;
7. the entry points: the seeded small.en written as a reference ``.pt``;
   the command line (``python -m olmoasr_tpu_torch.transcribe``) on two
   files, and the HTTP server (``python -m olmoasr_tpu_torch.serve``, int8
   cross K/V and ``beam_size=5``) answering 4 concurrent requests, each in
   its own process.

Each slice sets every launch count to 0 before it runs and reads them after;
the ``launches`` of the kernels line are those of the path that runs the
kernel: the long-form slice's, the server traffic's for the fused launch and
the training step's for the attention backward. Every kernel in that line
carries its bound (the least time the card could take for its main case:
bytes over 3.35 TB/s or operations over the dtype's peak, whichever is
larger) and ``library_ms``, the time of one PyTorch call computing the same
function where there is one (``scaled_dot_product_attention`` for the
attention forward and backward), else null.

``python3 chip_smoke.py --ab TREE`` instead compares the kernels of another
checkout (for example the parent commit, unpacked with ``git archive`` into a
directory that ``.gitignore`` lists) with this one's on chosen cases, in the
order TREE, this, this, TREE, each in its own process on the same inputs;
see :func:`kernel_ab`.

The next-to-last line is ``{"kernels": [...]}``, the last
``{"ok": true, "device": {...}}``. Any failed phase exits non-zero before
either is printed; so does a machine without a CUDA device.
"""

from __future__ import annotations

import json
import os
import re
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
                           lambda: mlp_block(*args), lambda: mlp_block_plain(*args),
                           (nbytes(*args, got), 4 * B * D * Fd, dtype)))
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
                           lambda: cross_block_decode_plain(*args), _cross_bound(args, got)))
    # best_of samples and beams: 5 token rows over each of 16 cache rows, in
    # bf16 and over the int8 cache of a served request (int8 q.K)
    G, Bc = 5, 16
    x = torch.randn(Bc * G, 1, D, generator=gen).to("cuda", torch.bfloat16)
    ck, cv = (torch.randn(Bc, T, D, generator=gen).to("cuda") for _ in range(2))
    ones = torch.ones(Bc, 1, T, device="cuda")
    (ck8, ks), (cv8, vs) = _quantize_rows(ck), _quantize_rows(cv)
    for kv, cache in ((torch.bfloat16, (ck.to(torch.bfloat16), cv.to(torch.bfloat16), ones, ones)),
                      (torch.int8, (ck8, cv8, ks[:, None].contiguous(), vs[:, None].contiguous()))):
        args = (x, *[t.to(torch.bfloat16) for t in w], *cache, H)
        kw = dict(kv_group=G)
        got, want = cross_block_decode(*args, **kw), cross_block_decode_plain(*args, **kw)
        what = (torch.bfloat16, kv, f"kv_group={G}, {Bc * G} rows")
        cases.append(_case("cross_block_decode", what, got, want,
                           lambda: cross_block_decode(*args, **kw),
                           lambda: cross_block_decode_plain(*args, **kw),
                           _cross_bound(args, got, G)))
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
    # training's cross attention: the decoder's 448 queries over 1500 audio keys
    k, v = (torch.randn(B, 1500, D, generator=gen).to("cuda", torch.bfloat16) for _ in range(2))
    got = train_attention_fwd(q, k, v, H)
    cases.append(_case("train_attention_fwd", (torch.bfloat16, "cross 448x1500 B=16"), got,
                       train_attention_fwd_plain(q, k, v, H),
                       lambda: train_attention_fwd(q, k, v, H),
                       lambda: train_attention_fwd_plain(q, k, v, H),
                       _attention_bound(q, k, v, got)))
    return cases


def _attention_bound(q, k, v, *outs, causal=False, bias=None, valid_len=None, products=2):
    """(bytes, operations, dtype) of ``products`` matrix products of
    2 Tq Tk dh per (b, h) (2 in the forward, 5 in the backward) over the keys
    the call needs: those below ``valid_len``, and with the causal mask the
    lower triangle only."""
    B, Tq, D = q.shape
    Tk = k.shape[1] if valid_len is None else valid_len
    pairs = Tq * (Tq + 1) // 2 if causal else Tq * Tk
    return nbytes(q, k, v, bias, *outs), products * 2 * B * pairs * D, q.dtype


def _sdpa_ms(q, k, v, do, H, causal, key_bias) -> float:
    """Time of torch's scaled_dot_product_attention at the same shapes (the
    port never calls it; it does not round P to bf16): the forward, or with
    ``do`` its backward, as the forward-and-backward less the forward. The
    causal mask and the key bias ride in one boolean mask."""
    import torch.nn.functional as F

    B, Tq, D = q.shape
    Tk, dh = k.shape[1], D // H
    heads = lambda t: t.detach().view(B, -1, H, dh).transpose(1, 2).requires_grad_(do is not None)
    qh, kh, vh = heads(q), heads(k), heads(v)
    mask = None
    if causal or key_bias is not None:
        mask = torch.ones(B, 1, Tq, Tk, dtype=torch.bool, device=q.device)
        if causal:
            mask &= torch.ones(Tq, Tk, dtype=torch.bool, device=q.device).tril()
        if key_bias is not None:
            mask &= (key_bias > float("-inf"))[:, None, None, :]
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
    ds and pn to bf16, so a few elements may flip by one bf16 step."""
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
            lambda: ln_matmul(*args), lambda: ln_matmul_plain(*args),
            (nbytes(*args, qkv), 2 * B * D * 3 * D, dtype)))
        q, kn, vn = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
        rings = [torch.randn(L, B, C, D, generator=gen).to("cuda", dtype) for _ in range(2)]
        for offset in (224, 100, 1):
            sa = (q, *rings, kn, vn, offset, layer)
            attn = self_attend_decode(*sa, n_head=H)
            cases["self_attend_decode"].append(_case(
                "self_attend_decode", (dtype, f"ring L={L} B={B} C={C} layer {layer} offset {offset}"),
                attn, self_attend_decode_plain(*sa, n_head=H),
                lambda: self_attend_decode(*sa, n_head=H),
                lambda: self_attend_decode_plain(*sa, n_head=H), _self_bound(sa, attn)))
        del rings
        wo, bo = _weights(gen, D, D, fan_in=D, dtype=dtype), \
            (0.02 * torch.randn(D, generator=gen)).to("cuda", dtype)
        mr = (attn, x, wo, bo)
        out = matmul_residual(*mr)
        cases["matmul_residual"].append(_case(
            "matmul_residual", (dtype, f"B={B} D={D}"), out,
            matmul_residual_plain(*mr), lambda: matmul_residual(*mr),
            lambda: matmul_residual_plain(*mr), (nbytes(*mr, out), 2 * B * D * D, dtype)))
    return cases


def _self_bound(sa, out, anc=None):
    """(bytes, operations, dtype) of self_attend_decode: q, the new key and
    value, one layer's rings up to the offset (and the ancestry map's
    columns up to it), the output; q.K and P.V over offset + 1 positions."""
    q, kr, _, kn, vn, offset, _ = sa
    B, D = q.shape[0], q.shape[-1]
    rings = 2 * B * offset * D * kr.element_size() + (0 if anc is None else B * offset * 4)
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
            "train_attention_bwd": 2.0 ** -6}
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


def _case(name, what, got, want, kernel_fn, plain_fn, bound_of=None, flips=False) -> dict:
    """The kernel's output(s) against the twin's, and both timed. ``got`` and
    ``want`` may be tuples (each part held to its own tolerance);
    ``bound_of`` is (bytes, operations, dtype) of the call; ``flips`` allows
    FLIP_SHARE of the elements past FLIP_TOL (see there)."""
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
    ms, plain_ms = timed_ms(kernel_fn), timed_ms(plain_fn)
    out = {"what": str(what), "max_abs_err": err, "tol": tol, "ms": ms, "plain_ms": plain_ms}
    if bound_of is not None:
        out["bound_ms"], out["bound_by"] = bound(*bound_of)
    print(f"  {name} {what}: max_abs_err {err:.3e} (tol {tol:.3e}) "
          f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms"
          + (f" bound {out['bound_ms']:.4f} ms ({out['bound_by']})" if bound_of else ""))
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


def phase_kernels() -> dict:
    print("kernels vs plain twins:")
    gen = torch.Generator().manual_seed(0)
    return {
        "cross_block_decode": check_cross(gen) + check_int8_qk(gen),
        "layer_block_decode": check_layer_block(gen),
        "mlp_block": check_mlp(gen),
        "train_attention_fwd": check_attention(gen),
        "train_attention_bwd": check_attention_bwd(gen),
        **check_self_sub_block(gen),
        "self_attend_decode_beam": check_self_ancestry(gen),
    }


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------


DECODE_KERNELS = ("ln_matmul", "self_attend_decode", "matmul_residual", "cross_block_decode",
                  "layer_block_decode", "mlp_block")
# the single-token step's launches per layer: the split kernels, or over an
# int8 cross cache with one token row per window the fused self + cross launch
SPLIT_STEP = ("ln_matmul", "self_attend_decode", "matmul_residual", "cross_block_decode",
              "mlp_block")
FUSED_STEP = ("layer_block_decode", "mlp_block")


def _counters():
    """Every kernel wrapper of the path, whose ``launches`` count its kernel's
    launches, and decode_step, whose ``single_steps`` count S=1 steps."""
    from olmoasr_tpu_torch.models import whisper
    from olmoasr_tpu_torch.ops import attention, train_attention

    kernels = {name: getattr(attention, name) for name in DECODE_KERNELS}
    kernels["train_attention_fwd"] = train_attention.train_attention_fwd
    kernels["train_attention_bwd"] = train_attention.train_attention_bwd
    return kernels, whisper.decode_step


def _reset_counts():
    kernels, step = _counters()
    for fn in kernels.values():
        fn.launches = 0
    kernels["self_attend_decode"].beam_launches = 0
    step.single_steps = 0


def _read_counts():
    """Launches by kernel (``self_attend_decode_beam``: those of the ancestry
    variant, a subset of ``self_attend_decode``'s) and single-token steps."""
    kernels, step = _counters()
    counts = {name: fn.launches for name, fn in kernels.items()}
    counts["self_attend_decode_beam"] = kernels["self_attend_decode"].beam_launches
    return counts, step.single_steps


def _check_decode_counts(label: str, counts: dict, steps: int, L: int,
                         fused: bool = False) -> None:
    """Every kernel of the step launched once per layer and single-token
    step, and the others not at all."""
    step = FUSED_STEP if fused else SPLIT_STEP
    for name in DECODE_KERNELS:
        want = L * steps if name in step else 0
        if counts[name] != want:
            fail(f"{label}: {name} launched {counts[name]} times, expected {want} "
                 f"({L} layers x {steps} steps)" if want else
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
        _check_decode_counts(label, counts, steps, dims.n_text_layer, fused=kv_quant)
        if counts["train_attention_fwd"] != dims.n_audio_layer:
            fail(f"{label}: encoder attention launched {counts['train_attention_fwd']} times")
        out[label] = {"steps": steps, "wall_s": wall, "audio_s_per_s": B * 30 / wall,
                      "launches": counts,
                      "step_profile": _profile_greedy_step(model, mel, options)}
    out.update(phase_beam(model, mel[:BEAM_WINDOWS]))
    return out


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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(warm + timed, warm + timed + profiled):
            step(i)
        torch.cuda.synchronize()
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
    return {"host_ms": host_ms, "kernel_ms": kernel_ms or None,
            "device_launches": launches, "by_kernel_ms": {k: v[0] for k, v in top}}


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------


def phase_long_form() -> dict:
    from olmoasr_tpu_torch import build_model, transcribe_many
    from olmoasr_tpu_torch.audio import SAMPLE_RATE
    from olmoasr_tpu_torch.transcribe import DEFAULT_TEMPERATURES

    n_files, best_of, beam_size = 16, 5, 5  # the CLI's defaults
    model = build_model("small.en", seed=0, device="cuda", dtype=torch.bfloat16)
    dims = model.dims
    rng = np.random.default_rng(2)
    seconds = rng.integers(40, 76, n_files)
    audios = [torch.from_numpy((rng.standard_normal(s * SAMPLE_RATE) * 0.1).astype(np.float32))
              for s in seconds]
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
    return {"files": n_files, "audio_s": audio_s, "wall_s": wall,
            "audio_s_per_s": audio_s / wall, "single_steps": steps,
            "windows_per_temperature": windows_at, "decode_calls": len(calls),
            "launches": counts}


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
    _check_decode_counts("server traffic", counts, steps, dims.n_text_layer, fused=True)
    if stats["batches"] != 2:  # the warm-up, then the 8 requests as one batch
        fail(f"server traffic: {stats['batches'] - 1} batches for {len(audios)} requests")
    for k, r in enumerate(results):
        _check_transcript(f"server traffic request {k}", r)
    return {"requests": len(audios), "audio_s": audio_s, "wall_s": wall,
            "audio_s_per_s": audio_s / wall, "single_steps": steps,
            "windows_per_temperature": windows_at, "launches": counts}


# ---------------------------------------------------------------------------
# phase 5
# ---------------------------------------------------------------------------

LOGIT_TOL = 2e-3  # fp32 on both sides; sums in another order, exp in another library


def phase_teacher_forced() -> float:
    """The same weights and tokens through the port on the GPU (kernels) and
    on the CPU (plain twins), fp32: 2 windows x 2 token rows over the shared
    cross cache (the split kernels), then 2 windows x 1 row over an int8
    cross cache (the fused self + cross launch), which both sides take from
    the GPU's quantization so that they read the same int8 values."""
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
    worst = 0.0
    for G, quantize in ((2, False), (1, True)):
        tokens = torch.from_numpy(rng.integers(0, 50000, (B * G, steps))).long()
        logits, cross = {}, None
        for device, model in models.items():
            with torch.no_grad():
                feats = model_mod.encode_audio(model, mel.to(device))
                cache = model_mod.init_cache(model, feats, max_len=1 + steps, self_batch=B * G,
                                             quantize_cross=quantize)
                if quantize and cross is None:
                    cross = [getattr(cache, n).cpu() for n in
                             ("cross_k", "cross_v", "cross_k_scale", "cross_v_scale")]
                elif quantize:
                    cache.cross_k, cache.cross_v, cache.cross_k_scale, cache.cross_v_scale = cross
                _reset_counts()
                first = torch.full((B * G, 1), sot, device=device)
                step_logits = [model_mod.decode_step(model, first, cache)]
                for i in range(steps - 1):
                    step_logits.append(
                        model_mod.decode_step(model, tokens[:, i:i + 1].to(device), cache))
                if device == "cuda":
                    _check_decode_counts(f"teacher-forced G={G}", _read_counts()[0], steps,
                                         model.dims.n_text_layer, fused=quantize)
            logits[device] = (feats.cpu(), torch.cat(step_logits, dim=1).cpu())
            del cache
        feat_err = max_err(logits["cuda"][0], logits["cpu"][0])
        err = max_err(logits["cuda"][1], logits["cpu"][1])
        scale = float(logits["cpu"][1].abs().max())
        print(f"teacher-forced fp32 B={B} windows x {G} rows, "
              f"{'int8' if quantize else 'fp32'} cross K/V, {steps} steps: audio features "
              f"max_abs_err {feat_err:.3e}, logits max_abs_err {err:.3e} (tol {LOGIT_TOL}, "
              f"max |logit| {scale:.2f})")
        if not err <= LOGIT_TOL:
            fail(f"teacher-forced logits disagree (G={G}, int8 {quantize}): {err} > {LOGIT_TOL}")
        worst = max(worst, err)
    return worst


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
ATTN_KERNELS = ("attn_fwd_bf16_kernel", "attn_fwd_f32_kernel", "attn_bwd_dq_kernel",
                "attn_bwd_dkv_kernel")


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


def phase_training() -> dict:
    """small.en at full width and depth (768 wide, 12 + 12 layers, 1500 / 448
    positions) through ``train_loop.main`` on the card: 256 samples, micro
    batch 16, effective batch 32 (2 micro-batches a step), remat, 6 steps,
    then a resumed run of 1 step. Each step is wrapped to read the attention
    kernels' launches, the parameters and its start and end; the loader's
    per-sample work is watched (:class:`LoaderWatch`). Step 1 is the
    warm-up; steps 2-5 are the window, timed end to end with the loader's
    waits; step 6 runs with the loader held back, so its wall against the
    window's says what the loader's threads cost the step; the resumed step
    runs under the profiler, for the kernels' device time."""
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
    steps: list = []
    profiled: dict = {}
    initial: list = []

    def watched(dims_, config):
        step_fn = make_step(dims_, config)

        def step(state, batch):
            kernels, _ = _counters()
            n = state.step + 1
            if n == 1:
                initial.extend(p.detach().clone() for p in state.model.parameters())
            quiet = n == TRAIN_STEPS
            if quiet:
                watch.pause()
            try:
                _reset_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if n == TRAIN_STEPS + 1:
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
                   "fwd": kernels["train_attention_fwd"].launches,
                   "bwd": kernels["train_attention_bwd"].launches,
                   "tokens": int((batch["text_target"] != PADDING_TOKEN).sum()), "quiet": quiet}
            same = lambda: all(torch.equal(a, p) for a, p in
                               zip(initial, state.model.parameters()))
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
        kwargs = dict(variant="small.en", train_shards=shards, exp_name="smoke",
                      micro_batch_size=TRAIN_MICRO, eff_batch_size=TRAIN_BATCH, remat=True,
                      ckpt_dir=os.path.join(tmp, "ckpt"), ckpt_every=0, log_every=1,
                      device="cuda")
        train_mod.make_train_step = watched
        os.chdir(tmp)  # the metrics logger writes logs/ under the working directory
        try:
            torch.cuda.reset_peak_memory_stats()
            start = time.perf_counter()
            first = train_loop.main(**kwargs, max_steps_this_run=TRAIN_STEPS)
            peak = torch.cuda.max_memory_allocated()
            resumed = train_loop.main(**kwargs, max_steps_this_run=1)
        finally:
            train_mod.make_train_step = make_step
            os.chdir(here)
        # the gap before a step: the loader's wait and the batch's copy to the
        # card (before step 1: the set-up, the model's init and the first batch)
        for prev_end, row in zip([start] + [r["t1"] for r in steps], steps[:TRAIN_STEPS]):
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
              + f"; attention launches {row['fwd']} forward {row['bwd']} backward, "
                f"{row['tokens']} target tokens")
    if [r["step"] for r in steps] != list(range(1, TRAIN_STEPS + 2)):
        fail(f"training: steps {[r['step'] for r in steps]}, expected 1-{TRAIN_STEPS + 1}")
    if first["global_step"] != TRAIN_STEPS or resumed["global_step"] != TRAIN_STEPS + 1:
        fail(f"training: global steps {first['global_step']} then {resumed['global_step']}; "
             f"the resumed run must continue at step {TRAIN_STEPS + 1}")
    micro = TRAIN_BATCH // TRAIN_MICRO
    for row in steps:
        if not (np.isfinite(row["loss"]) and np.isfinite(row["grad_norm"])):
            fail(f"training: step {row['step']} loss {row['loss']} grad_norm {row['grad_norm']}")
        # per micro-batch: 36 attention forwards, 36 more in the remat
        # recompute, 36 backwards (12 encoder, 12 self, 12 cross)
        want = (micro * 72, micro * 36)
        if (row["fwd"], row["bwd"]) != want:
            fail(f"training: step {row['step']} attention launches {(row['fwd'], row['bwd'])}, "
                 f"expected {want}")
    if not steps[0]["unchanged"] or steps[0]["lr"] != 0.0:
        fail("training: step 1 (lr 0) changed the parameters")
    if not steps[1]["changed"]:
        fail("training: step 2 left the parameters as they were")

    window = steps[1:TRAIN_STEPS - 1]
    window_s = window[-1]["t1"] - steps[0]["t1"]
    per_step = window_s / len(window)
    wall = stats.median(r["wall_s"] for r in window)
    quiet_wall = steps[TRAIN_STEPS - 1]["wall_s"]
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
           "launches": {"train_attention_fwd": steps[1]["fwd"],
                        "train_attention_bwd": steps[1]["bwd"]}}
    print(f"training: small.en bf16, micro batch {TRAIN_MICRO} x {micro}, remat: set-up "
          f"{out['setup_s']:.3f} s, warm-up step {out['warmup_step_s']:.3f} s; steps 2-"
          f"{TRAIN_STEPS - 1} with the loader's waits {window_s:.3f} s = {per_step:.3f} s a step, "
          f"{out['audio_s_per_s']:.1f} audio-s/s, {out['tokens_per_s']:.0f} target tokens/s, "
          f"{flops / 1e12:.1f} TFLOP a step = {100 * out['flops_share']:.1f}% of 989 TFLOP/s; "
          f"in-step wall {wall:.3f} s (median), {quiet_wall:.3f} s with the loader held back; "
          f"the loader {out['loader_sample_s'] * 1e3:.1f} ms a sample (median of "
          f"{len(sample_s)}); peak memory {out['peak_memory_gb']:.2f} GB")
    if kernel_ms:
        print(f"  profiled step {TRAIN_STEPS + 1} (wall {steps[-1]['wall_s']:.3f} s under the "
              f"profiler): kernels {kernel_ms:.1f} ms, so the device is idle {100 * idle:.1f}% "
              f"of the window's step and {100 * idle_quiet:.1f}% of the quiet step; attention "
              f"kernels " + ", ".join(f"{k} {v:.1f} ms" for k, v in attn_ms.items()))
        for name, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]:
            print(f"    {name}: {ms:.2f} ms")
    else:
        print("  the profiler recorded no device events: attention kernel time not measured")
    return out


GRAD_DIMS = dict(n_mels=80, n_audio_ctx=1500, n_audio_state=256, n_audio_head=4,
                 n_audio_layer=2, n_vocab=51864, n_text_ctx=448, n_text_state=256,
                 n_text_head=4, n_text_layer=2)
LOSS_TOL, GRAD_TOL = 1e-4, 1e-3  # relative to the loss, to the largest gradient


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
    and the check fails if it is not below half of GRAD_TOL."""
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

    def grads(device, mel_scale=1.0):
        model = model_mod.empty_model(dims, True, device=device)
        model.load_state_dict(init)
        loss, _ = train_mod.loss_fn(model, (mel * mel_scale).to(device), inp.to(device),
                                    tgt.to(device), mask.to(device),
                                    compute_dtype=torch.float32, remat=True)
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
    return {"loss_rel_err": loss_err, "grad_rel_err": err, "floor": floor}


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
    """The seeded small.en as a reference .pt; the CLI on two files in one
    process; the HTTP server in another, with 4 concurrent requests."""
    import dataclasses
    import urllib.request

    from olmoasr_tpu_torch import build_model

    out = {}
    rng = np.random.default_rng(3)
    with tempfile.TemporaryDirectory() as tmp:
        model = build_model("small.en", seed=0, device="cuda", dtype=torch.bfloat16)
        ckpt = os.path.join(tmp, "small.en.pt")
        torch.save({"dims": dataclasses.asdict(model.dims),
                    "model_state_dict": {k: v.cpu() for k, v in model.state_dict().items()}},
                   ckpt)
        del model
        torch.cuda.empty_cache()
        wavs = []
        for name, seconds in (("a", 35), ("b", 50)):
            wavs.append(os.path.join(tmp, f"{name}.wav"))
            _write_wav(wavs[-1], seconds, rng)

        out_dir = os.path.join(tmp, "out")
        cmd = [sys.executable, "-m", "olmoasr_tpu_torch.transcribe", *wavs, "--model", ckpt,
               "-o", out_dir, "--temperature_increment_on_fallback", "None", "--batch_size", "2",
               "--verbose", "False"]
        t0 = time.perf_counter()
        _run(cmd, 600)
        cli_s = time.perf_counter() - t0
        want = sorted(f"{n}.{e}" for n in ("a", "b") for e in ("txt", "vtt", "srt", "tsv", "json"))
        if sorted(os.listdir(out_dir)) != want:
            fail(f"CLI wrote {sorted(os.listdir(out_dir))}, expected {want}")
        for name in ("a", "b"):
            with open(os.path.join(out_dir, f"{name}.json"), encoding="utf-8") as f:
                _check_transcript(f"CLI {name}.json", json.load(f))
        print(f"entry points: CLI (beam_size=5, t=0, batch_size=2) on 35 s + 50 s in its own "
              f"process: {cli_s:.1f} s, five outputs for each file")
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


def _server_port(server, err, timeout: float = 300) -> int:
    """The port from the line the server prints once it listens."""
    lines: list = []
    reader = threading.Thread(target=lambda: lines.append(server.stdout.readline()), daemon=True)
    reader.start()
    reader.join(timeout)
    found = re.search(r" on [^ ]*:(\d+) ", lines[0]) if lines else None
    if found is None:
        err.seek(0)
        fail(f"server did not start within {timeout} s: {lines} {err.read()[-4000:]}")
    return int(found.group(1))


def _drive_server(server, reqs, err, urllib_request) -> dict:
    base = f"http://127.0.0.1:{_server_port(server, err)}"
    answers = [None] * len(reqs)

    def post(k):
        with open(reqs[k], "rb") as f:
            req = urllib_request.Request(f"{base}/v1/transcribe?temperature=0", data=f.read(),
                                         method="POST", headers={"X-Filename": "req.wav"})
        try:
            with urllib_request.urlopen(req, timeout=600) as r:
                answers[k] = (r.status, json.loads(r.read()))
        except Exception as exc:  # noqa: BLE001 -- reported below as a failed request
            answers[k] = (None, repr(exc))

    threads = [threading.Thread(target=post, args=(k,)) for k in range(len(reqs))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    for k, (status, body) in enumerate(answers):
        if status != 200:
            fail(f"server request {k}: {status} {str(body)[:500]}")
        _check_transcript(f"server request {k}", body)
    with urllib_request.urlopen(f"{base}/healthz", timeout=30) as r:
        stats = json.loads(r.read())["stats"]
    print(f"  server (int8 cross K/V, beam_size=5): {len(reqs)} of {len(reqs)} concurrent "
          f"requests answered 200 in {wall:.1f} s; /healthz {stats}")
    if stats["requests"] != len(reqs) or not stats["batches"] < stats["requests"]:
        fail(f"server: {stats['batches']} batches for {stats['requests']} requests")
    return {"server_wall_s": wall, "server_stats": stats}


# ---------------------------------------------------------------------------
# --ab: the kernels of two trees on the same inputs
# ---------------------------------------------------------------------------


def _ab_inputs(gen) -> dict:
    """name -> (kind, args, keyword args) of the compared cases: the int8
    cross pass (served requests, and their beams), the outlier-q case of
    both, the self pass at 160 rows without a map, with the identity map and
    with a random one, and the self + cross sub-blocks of a greedy int8 step.
    Rings are one layer deep: a call reads one layer."""
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
    out["self + cross int8, 64 rows, offset 224"] = (
        "layer", (*layer_block_args(gen, torch.bfloat16, L=1), 224, 0), {"n_head": H})
    return out


def _self_views(args):
    """self_attend_decode's arguments from (qkv, k_ring, v_ring, offset,
    layer): q, k_new and v_new as row views of the fused projection, as
    decode_step passes them."""
    qkv, k_ring, v_ring, offset, layer = args
    D = k_ring.shape[-1]
    return qkv[..., :D], k_ring, v_ring, qkv[..., D:2 * D], qkv[..., 2 * D:], offset, layer


def _ab_call(A, kind, args, kw):
    """The tree's kernel for a case (module A is its ops.attention), or None
    where the tree does not have it; "layer" falls back to the split chain
    and returns the residual only."""
    import inspect

    if kind == "cross":
        return lambda: A.cross_block_decode(*args, **kw)
    if kind == "self":
        if "beam_anc" in kw and "beam_anc" not in inspect.signature(A.self_attend_decode).parameters:
            return None
        return lambda: A.self_attend_decode(*_self_views(args), **kw)
    if hasattr(A, "layer_block_decode"):
        return lambda: A.layer_block_decode(*args, **kw)[0]
    return lambda: _chain(args[:-2], args[-2], args[-1], kw["n_head"])


def kernel_cases(root: str, inputs: str, out: str) -> None:
    """``--kernel-cases ROOT INPUTS OUT``: the kernels of the checkout at
    ROOT on the saved inputs; outputs and device times saved to OUT."""
    sys.path.insert(0, os.path.abspath(root))
    from olmoasr_tpu_torch.ops import attention as A

    if not os.path.abspath(A.__file__).startswith(os.path.abspath(root)):
        fail(f"imported {A.__file__}, not the tree at {root}")
    results = {}
    for name, (kind, args, kw) in torch.load(inputs).items():
        to = lambda a: a.cuda() if torch.is_tensor(a) else a
        args, kw = [to(a) for a in args], {k: to(v) for k, v in kw.items()}
        fn = _ab_call(A, kind, args, kw)
        results[name] = None if fn is None else {"out": fn().cpu(), "ms": timed_ms(fn)}
    results[GREEDY_INT8_STEP] = _greedy_int8_step()
    torch.save(results, out)


GREEDY_INT8_STEP = "greedy int8 step, 64 rows"


def _greedy_int8_step() -> dict:
    """One greedy step of small.en over 64 windows' int8 cross cache, host
    clock against kernel time (the served path, end to end of the step)."""
    from olmoasr_tpu_torch import build_model
    from olmoasr_tpu_torch.audio import N_SAMPLES, log_mel_spectrogram
    from olmoasr_tpu_torch.decoding import DecodingOptions

    model = build_model("small.en", seed=0, device="cuda", dtype=torch.bfloat16)
    audio = np.random.default_rng(0).standard_normal((64, N_SAMPLES)).astype(np.float32) * 0.1
    mel = log_mel_spectrogram(torch.from_numpy(audio).cuda())
    return _profile_greedy_step(model, mel, DecodingOptions(language="en", kv_quant=True))


def kernel_ab(tree: str) -> None:
    """``--ab TREE``: the cases of :func:`_ab_inputs` through the kernels of
    the checkout at TREE and of this one, in the order TREE, this, this, TREE,
    each run in its own process on the same saved inputs; each output held to
    this checkout's twins (the int8 cross cases also to the exact-q twin).
    Each process also profiles one greedy step over an int8 cross cache.
    Fails if this checkout's kernels leave the tolerance."""
    from olmoasr_tpu_torch.ops import attention as A

    here = os.path.dirname(os.path.abspath(__file__))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    cases = _ab_inputs(torch.Generator().manual_seed(0))
    refs = {}
    for name, (kind, args, kw) in cases.items():
        if kind == "cross":
            refs[name] = (A.cross_block_decode_plain(*args, **kw),
                          A.cross_block_decode_plain(*args, **kw, quantize_q=False))
        elif kind == "self":
            refs[name] = (A.self_attend_decode_plain(*_self_views(args), **kw), None)
        else:
            refs[name] = (A.layer_block_decode_plain(*args, **kw)[0], None)
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        inputs = os.path.join(tmp, "inputs.pt")
        cpu = lambda a: a.cpu() if torch.is_tensor(a) else a
        torch.save({k: (kind, [cpu(a) for a in args], {n: cpu(v) for n, v in kw.items()})
                    for k, (kind, args, kw) in cases.items()}, inputs)
        for label, root in (("tree", tree), ("this", here), ("this", here), ("tree", tree)):
            out = os.path.join(tmp, f"run{len(runs)}.pt")
            _run([sys.executable, os.path.abspath(__file__), "--kernel-cases", root, inputs, out],
                 900)
            runs.append((label, torch.load(out)))
    report, bad = {}, []
    for name, (want, exact) in refs.items():
        tol = bf16_tol(want)
        report[name] = []
        for label, results in runs:
            r = results[name]
            if r is None:
                print(f"  {name} [{label}]: not in this tree")
                report[name].append(None)
                continue
            err = max_err(r["out"], want.cpu())
            row = {"tree": label, "ms": r["ms"], "max_abs_err": err, "tol": tol}
            line = f"  {name} [{label}]: {r['ms']:.4f} ms, max_abs_err {err:.3e} (tol {tol:.3e})"
            if exact is not None:
                row["exact_q_err"] = max_err(r["out"], exact.cpu())
                line += f", against the exact-q twin {row['exact_q_err']:.3e}"
            print(line)
            report[name].append(row)
            if label == "this" and not err <= tol:
                bad.append(f"{name}: {err} > {tol}")
    report[GREEDY_INT8_STEP] = []
    for label, results in runs:
        r = results[GREEDY_INT8_STEP]
        print(f"  {GREEDY_INT8_STEP} [{label}]: host {r['host_ms']:.3f} ms, kernels "
              f"{r['kernel_ms'] or float('nan'):.3f} ms, {r['device_launches']:.1f} device launches")
        report[GREEDY_INT8_STEP].append({"tree": label, **r})
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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_identity()
    cases = phase_kernels()
    short = phase_slice()
    long_form = phase_long_form()
    server = phase_server_traffic()
    phase_teacher_forced()
    training = phase_training()
    phase_train_fp32()
    phase_entry_points()
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "optax", "orbax",
                                                                   "olmoasr_tpu"))
    if leaked:
        fail(f"imported {leaked}: the port must not load jax or the JAX package")

    sources = {
        "cross_block_decode": ("olmoasr_tpu_torch/csrc/cross_attention.cu",
                               "olmoasr_tpu/ops/attention.py:986"),
        "layer_block_decode": ("olmoasr_tpu_torch/csrc/layer_block.cu",
                               "olmoasr_tpu/ops/attention.py:1228"),
        "mlp_block": ("olmoasr_tpu_torch/csrc/linear.cu", "olmoasr_tpu/ops/attention.py:669"),
        "train_attention_fwd": ("olmoasr_tpu_torch/csrc/train_attention.cu",
                                "olmoasr_tpu/ops/train_attention.py:222"),
        "ln_matmul": ("olmoasr_tpu_torch/csrc/linear.cu", "olmoasr_tpu/ops/attention.py:354"),
        "matmul_residual": ("olmoasr_tpu_torch/csrc/linear.cu",
                            "olmoasr_tpu/ops/attention.py:412"),
        "self_attend_decode": ("olmoasr_tpu_torch/csrc/self_attention.cu",
                               "olmoasr_tpu/ops/attention.py:495"),
        "self_attend_decode_beam": ("olmoasr_tpu_torch/csrc/self_attention.cu",
                                    "olmoasr_tpu/ops/attention.py:254"),
        "train_attention_bwd": ("olmoasr_tpu_torch/csrc/train_attention.cu",
                                "olmoasr_tpu/ops/train_attention.py:412"),
    }
    kernels = []
    for name, (source, replaces) in sources.items():
        main_case = cases[name][0]  # the main path's shape and dtype
        # launches on the path that runs the kernel: the long-form slice at the
        # CLI's defaults, for the fused launch the server's default traffic,
        # for the backward the training slice
        path = {"layer_block_decode": server, "train_attention_bwd": training}.get(name, long_form)
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": path["launches"][name],
            "launches_long_form": long_form["launches"][name],
            "launches_server_traffic": server["launches"][name],
            "launches_short_form": {k: v["launches"][name] for k, v in short.items()},
            "launches_training_step": training["launches"].get(name, 0),
            "max_abs_err": max(c["max_abs_err"] for c in cases[name]),
            "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
            "library_ms": main_case.get("library_ms"),
            "cases": cases[name],
        })
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
        else:
            fail(f"usage: {sys.argv[0]} [--ab TREE]")
    else:
        main()
