"""Query-tile, head-width and head-packing probe of the attention forward on
the H100: the port of ``perf/probe_pack.py`` (``make_seq``, ``make_pack``,
``make_raw``).

On the TPU the question was the MXU's depth: d_head=64 fills half of its 128
deep contraction. On Hopper a product is mma.sync at a depth of 16, so the
questions become what a 64- or 128-row query tile, a 128-wide head (twice
the products, twice the bytes) and two heads sharing one block and one ring
of K/V tiles do to the forward, and how near the score product alone runs to
the tensor cores' rate. Variants, at medium.en's training shape (B=16,
T=1500, D=1024, 16 heads of 64):

  seq<SB>           the production forward at query tile SB (64 or 128)
  pad<SB>           q, k, v zero-padded to head width 128 outside the kernel,
                    the core instantiated at width 128
  pack<SB>          two heads in one block: [qA | qB] in one 128-wide row,
                    both heads' K and V in one ring
  rawd<d>x<SB>      the score product alone (``raw<SB>`` is rawd64x<SB>)

Each prints ms from graph replays, TF/s on the useful d=64 products (the
JAX probe's count: 2 for the forward, 1 for the score product) and the
largest error against the plain version. Run on the card:
``python -m olmoasr_tpu_torch.perf.probe_pack seq128 pad128 pack128 rawd64x128``.
"""

from __future__ import annotations

import re
import sys

from olmoasr_tpu_torch.ops import train_attention as ta
from olmoasr_tpu_torch.perf import _probes as P

VARIANTS = tuple(f"{kind}{sb}" for kind in ("seq", "pad", "pack") for sb in P.SBS) + tuple(
    f"rawd{d}x{sb}" for d in (64, 128) for sb in P.SBS)


def parse(variant: str):
    """(kind, SB, head width) of a variant name."""
    m = re.fullmatch(r"rawd(\d+)x(\d+)|raw(\d+)", variant)
    if m:
        d, sb = (int(m[1]), int(m[2])) if m[1] else (P.DH, int(m[3]))
        if d not in (64, 128) or sb not in P.SBS:
            raise ValueError(f"{variant}: rawd takes d in (64, 128) and SB in {P.SBS}")
        return "raw", sb, d
    for kind in ("seq", "pad", "pack"):
        if variant.startswith(kind) and variant[len(kind):].isdigit():
            return kind, P.sb_of(variant, kind), 128 if kind == "pad" else P.DH
    raise ValueError(f"unknown probe_pack variant {variant!r}; known: {VARIANTS}")


def call(variant: str, q, k, v, n_head: int):
    kind, sb, width = parse(variant)
    if kind == "raw":
        return P.probe_scores(q, k, n_head, sb, width)
    if kind == "pack":
        return P.probe_pack(q, k, v, n_head, sb)
    return P.probe_seq(q, k, v, n_head, sb, width)


def plain(variant: str, q, k, v, n_head: int):
    if parse(variant)[0] == "raw":
        return P.scores_plain(q, k, n_head, ta._scale(P.DH, q.dtype))
    return ta.train_attention_fwd_plain(q, k, v, n_head)


def scores_tol(ref) -> float:
    """fp32 on both sides, sums in another order."""
    return 1e-4 * float(ref.abs().max())


def main(variants, runs: int = P.RUNS) -> list:
    card = P.need_card()
    print(card)
    for variant in variants:
        parse(variant)
    q, k, v = P.inputs(3)
    refs, rows = {}, []
    for variant in variants:
        raw = parse(variant)[0] == "raw"
        if raw not in refs:
            refs[raw] = plain(variant, q, k, v, P.H)
        rows.append(P.measure(variant, lambda: call(variant, q, k, v, P.H),
                              P.useful_flops(1 if raw else 2), refs[raw],
                              scores_tol if raw else P.bf16_tol, runs))
    P.report("probe_pack", card, rows)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:] or VARIANTS)
