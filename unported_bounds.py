"""Bounds of the TPU code that has no CUDA counterpart yet, at the shapes its
paths would give it on small.en (bf16, 12 heads of 64), for the kernel table
in ``PERF.md``: row 11, the TPU timing probes (``perf/probe_*.py``). They
time the attention forward and backward, so their bounds are those of rows 3
and 9 at the encoder shape (the forward at B=64, the backward at B=16, five
products).

The ported rows' bounds come from ``chip_smoke.py``, which computes each from
its run's inputs. Run from the root of a checkout: ``python3
unported_bounds.py``. The bound is the least time an H100 could take
(``chip_smoke.bound``: the bytes over 3.35 TB/s or the operations over 989
TFLOP/s, the larger).
"""

from __future__ import annotations

import json

import torch

from chip_smoke import bound

D, H, BF16 = 768, 12, 2


def _attention(B: int, T: int, causal: bool, products: int, tensors: int) -> tuple:
    """(ms, by) of ``products`` products of 2 T T dh per (b, h) over the pairs
    the call needs, moving ``tensors`` (B, T, D) bf16 tensors once."""
    pairs = T * (T + 1) // 2 if causal else T * T
    return bound(tensors * B * T * D * BF16, products * 2 * B * pairs * D, torch.bfloat16)


def rows() -> list:
    out = [
        ("11", "probes of row 3: the forward, encoder B=64 1500x1500",
         _attention(64, 1500, False, 2, 4)),
        ("11", "probes of row 9: the backward, encoder B=16 1500x1500",
         _attention(16, 1500, False, 5, 8)),
    ]
    return [{"row": r, "what": what, "bound_ms": b[0], "bound_by": b[1], "library_ms": None}
            for r, what, b in out]


if __name__ == "__main__":
    table = rows()
    for row in table:
        print(f"row {row['row']}, {row['what']}: bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}), one PyTorch call: none")
    print(json.dumps({"unported": table}))
