"""Backward probe of the training attention on the H100: the port of
``perf/probe_bwd.py`` (``make_row``).

Variants, at medium.en's training shape (B=16, T=1500, D=1024, 16 heads of
64):

  base      the production backward (``train_attention_bwd``: per 64-query
            tile the statistics and dq, then per 64-key tile dK and dV; nine
            products)
  bq<N>     the same with an N-row query tile (64 or 128) in the dq launch
  row<SB>   the Hopper form of the TPU probe's whole-row backward: one
            thread-block cluster of 8 blocks per (b, h), each holding 1/8 of
            K and V and its keys' dK and dV in registers; for each SB-row
            query tile (SB = 64) the row max, sum and delta and the dq
            partials are reduced across the cluster's distributed shared
            memory in a fixed order; five products

Each prints ms from graph replays, TF/s on the 5 useful d=64 products (the
JAX probe's count) and the largest error of dq, dk and dv against
``train_attention_bwd_plain``. Run on the card:
``python -m olmoasr_tpu_torch.perf.probe_bwd base bq64 bq128 row64``.
"""

from __future__ import annotations

import sys

from olmoasr_tpu_torch.ops import train_attention as ta
from olmoasr_tpu_torch.perf import _probes as P

VARIANTS = ("base", "bq64", "bq128", "row64")


def call(variant: str, q, k, v, do, n_head: int):
    if variant == "base":
        return ta.train_attention_bwd(q, k, v, do, n_head)
    if variant.startswith("bq") and variant[2:].isdigit():
        return P.probe_bwd_tile(q, k, v, do, n_head, int(variant[2:]))
    if variant.startswith("row") and variant[3:].isdigit():
        return P.probe_row(q, k, v, do, n_head, int(variant[3:]))
    raise ValueError(f"unknown probe_bwd variant {variant!r}; known: {VARIANTS}")


def check(variant: str) -> None:
    """Raise for a name the probe does not take, before anything runs."""
    if variant == "base":
        return
    if variant.startswith("bq") and f"bq{variant[2:]}" in P.BWD_CODES:
        return
    if variant == "row64":
        return
    raise ValueError(f"unknown probe_bwd variant {variant!r}; known: {VARIANTS}")


def main(variants, runs: int = P.RUNS) -> list:
    card = P.need_card()
    print(card)
    for variant in variants:
        check(variant)
    q, k, v, do = P.inputs(4)
    ref = ta.train_attention_bwd_plain(q, k, v, do, P.H)
    rows = [P.measure(variant, lambda variant=variant: call(variant, q, k, v, do, P.H),
                      P.useful_flops(5), ref, runs=runs) for variant in variants]
    P.report("probe_bwd", card, rows)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:] or VARIANTS)
