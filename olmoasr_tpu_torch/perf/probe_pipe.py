"""Load/compute overlap and stage-ablation probe of the attention forward on
the H100: the port of ``perf/probe_pipe.py`` (``make_whole``,
``make_ablate``).

On the TPU the question was whether software-pipelining query sub-blocks
overlaps the softmax (VPU) with the next score product (MXU). On Hopper the
key and value tiles stream through a ring of cp.async stages, and the
question is what the ring's depth buys, and what each softmax stage costs.
Variants, at medium.en's training shape (B=16, T=1500, D=1024, 16 heads of
64) with a zero key bias (the bias stage runs, as the TPU probe's pad mask):

  base       the production forward (``train_attention_fwd``)
  seq<SB>    query tile SB, a ring of depth 1: load a tile, then compute it
  pipe<SB>   query tile SB, the production ring of depth 2
  ablate     query tile 128 with the JAX probe's drop sets removed: none,
             bias, max (no max pass), exp, sum, div, all five; then the exp
             itself: bf16exp (in bf16), exp2 (ex2.approx of x log2 e, the
             production kernel's) and expf (the accurate exp)

Each prints ms from graph replays, TF/s on the 2 useful d=64 products and,
for every variant that computes attention, the largest error against
``train_attention_fwd_plain``. Run on the card:
``python -m olmoasr_tpu_torch.perf.probe_pipe base seq128 pipe128 ablate``.
"""

from __future__ import annotations

import sys

import torch

from olmoasr_tpu_torch.ops import train_attention as ta
from olmoasr_tpu_torch.perf import _probes as P

VARIANTS = ("base",) + tuple(f"{kind}{sb}" for kind in ("seq", "pipe") for sb in P.SBS) + (
    "ablate",)


def ablate_name(drop) -> str:
    return "sb128 -" + (",".join(sorted(drop)) or "none")


def cases(variant: str) -> list:
    """(name, call(q, k, v, bias, n_head), computes attention) of a variant."""
    if variant == "base":
        return [("base", lambda q, k, v, bias, n: ta.train_attention_fwd(
            q, k, v, n, key_bias=bias.expand(q.shape[0], -1)), True)]
    if variant == "ablate":
        return [(ablate_name(drop), lambda q, k, v, bias, n, drop=drop: P.probe_ablate(
            q, k, v, n, drop, bias), not drop) for drop, _ in P.ABLATE]
    for kind, depth in (("seq", 1), ("pipe", 3)):
        if variant.startswith(kind) and variant[len(kind):].isdigit():
            sb = P.sb_of(variant, kind)
            return [(variant, lambda q, k, v, bias, n: P.probe_pipe(q, k, v, n, sb, depth, bias),
                     True)]
    raise ValueError(f"unknown probe_pipe variant {variant!r}; known: {VARIANTS}")


def main(variants, runs: int = P.RUNS) -> list:
    card = P.need_card()
    print(card)
    todo = [case for variant in variants for case in cases(variant)]
    q, k, v = P.inputs(3)
    bias = torch.zeros((1, P.T), dtype=torch.float32, device="cuda")
    ref = ta.train_attention_fwd_plain(q, k, v, P.H)
    rows = [P.measure(name, lambda fn=fn: fn(q, k, v, bias, P.H), P.useful_flops(2),
                      ref if attends else None, runs=runs)
            for name, fn, attends in todo]
    P.report("probe_pipe", card, rows)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:] or VARIANTS)
