"""Bounds of the TPU kernels that have no CUDA counterpart yet, at the shapes
their paths would give them on small.en (bf16, 12 heads of 64), for the
kernel table in ``PERF.md``:

- row 10, ``flash_mha`` (``olmoasr_tpu/ops/flash.py:72``): the encoder's
  self-attention, B=64 x 1500 x 1500 (``OLMOASR_ENC_ATTN`` other than
  ``kernel``), and the training decoder's causal self-attention with segment
  ids, B=16 x 448 (``OLMOASR_TRAIN_FLASH_DEC=1``); forwards, two products;
- row 11, the TPU timing probes (``perf/probe_*.py``): they time the
  attention forward and backward, so their bounds are those of rows 3 and 9
  at the encoder shape (the forward at B=64, the backward at B=16, five
  products).

The ported rows' bounds come from ``chip_smoke.py``, which computes each from
its run's inputs. Run from the root of a checkout: ``python3
unported_bounds.py``. The bound is the least time an H100 could take
(``chip_smoke.bound``: the bytes over 3.35 TB/s or the operations over 989
TFLOP/s, the larger). With a CUDA device it also times the one PyTorch call
that computes the same function (``scaled_dot_product_attention``, the
forward, between CUDA events); without one that column reads "not measured".
"""

from __future__ import annotations

import json

import torch

from chip_smoke import bound, events_ms

D, H, BF16 = 768, 12, 2


def _attention(B: int, T: int, causal: bool, products: int, tensors: int) -> tuple:
    """(ms, by) of ``products`` products of 2 T T dh per (b, h) over the pairs
    the call needs, moving ``tensors`` (B, T, D) bf16 tensors once."""
    pairs = T * (T + 1) // 2 if causal else T * T
    return bound(tensors * B * T * D * BF16, products * 2 * B * pairs * D, torch.bfloat16)


def _sdpa_ms(B: int, T: int, causal: bool):
    if not torch.cuda.is_available():
        return None
    import torch.nn.functional as F

    gen = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(B, H, T, D // H, generator=gen).to("cuda", torch.bfloat16)
               for _ in range(3))
    with torch.no_grad():
        return events_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal))


def rows() -> list:
    out = [
        ("10", "flash_mha, encoder self-attention, B=64 1500x1500",
         _attention(64, 1500, False, 2, 4), _sdpa_ms(64, 1500, False)),
        ("10", "flash_mha, decoder self-attention with segment ids, B=16 448 causal",
         _attention(16, 448, True, 2, 4), _sdpa_ms(16, 448, True)),
        ("11", "probes of row 3: the forward, encoder B=64 1500x1500",
         _attention(64, 1500, False, 2, 4), None),
        ("11", "probes of row 9: the backward, encoder B=16 1500x1500",
         _attention(16, 1500, False, 5, 8), None),
    ]
    return [{"row": r, "what": what, "bound_ms": b[0], "bound_by": b[1], "library_ms": lib}
            for r, what, b, lib in out]


if __name__ == "__main__":
    table = rows()
    for row in table:
        lib = row["library_ms"]
        lib = "none" if row["row"] == "11" else \
            "not measured" if lib is None else f"{lib:.4f} ms"
        print(f"row {row['row']}, {row['what']}: bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}), one PyTorch call: {lib}")
    print(json.dumps({"unported": table}))
