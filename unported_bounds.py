"""Bounds of the TPU kernels that have no CUDA counterpart yet, at the shapes
their paths would give them on small.en (bf16 activations, 64 rows, 1500
audio positions, self rings of 225 at offset 224), for the kernel table in
``PERF.md``.

Run from the root of a checkout: ``python3 unported_bounds.py``. The bound
is the least time an H100 could take (``chip_smoke.bound``: the bytes over
3.35 TB/s or the operations over 989 TFLOP/s, the larger). With a CUDA
device it also times the one PyTorch call that computes the same function
where there is one (``chip_smoke.timed_ms``, graph replays); without one
that column reads "not measured". Rows 10 and 11 are the attention forward
and backward under other names: their bounds are those of rows 3 and 9,
which ``chip_smoke.py`` prints.
"""

from __future__ import annotations

import json

import torch

from chip_smoke import bound, timed_ms

D, H, B, T, OFFSET, FFN = 768, 12, 64, 1500, 224, 3072
BF16, INT8, F32 = 2, 1, 4


def rows() -> list:
    out = []
    # 4a: self_attend_decode over int8 rings with fp32 per-position scales:
    # q, k_new, v_new and the output in bf16, the two rings up to the offset
    out.append(("4a", "self_attend_decode, int8 rings, B=64, offset 224",
                bound(3 * B * D * BF16 + 2 * B * OFFSET * (D * INT8 + F32) + B * D * BF16,
                      4 * B * (OFFSET + 1) * D, torch.bfloat16), None))
    # 7, include_mlp: the "sc" layer block (fused QKV, out projections, the
    # cross q projection, LayerNorms) plus the MLP's LayerNorm and weights,
    # over int8 cross K/V with fp32 scales and bf16 rings
    weights = (6 * D * D + 10 * D + 2 * D + D * FFN + FFN + FFN * D + D) * BF16
    moved = weights + 2 * B * T * (D * INT8 + F32) + 2 * B * OFFSET * D * BF16 + 4 * B * D * BF16
    out.append(("7", "layer_block_decode include_mlp, int8 cross, B=64, offset 224",
                bound(moved, 12 * B * D * D + 4 * B * (OFFSET + 1) * D + 4 * B * T * D
                      + 4 * B * D * FFN, torch.bfloat16), None))
    # 8: cross_attend_decode, one query a row over bf16 cross K/V
    library = None
    if torch.cuda.is_available():
        import torch.nn.functional as F

        gen = torch.Generator().manual_seed(1)
        q = torch.randn(B, H, 1, D // H, generator=gen).to("cuda", torch.bfloat16)
        k, v = (torch.randn(B, H, T, D // H, generator=gen).to("cuda", torch.bfloat16)
                for _ in range(2))
        with torch.no_grad():
            library = timed_ms(lambda: F.scaled_dot_product_attention(q, k, v))
    out.append(("8", "cross_attend_decode, bf16 K/V, B=64",
                bound(2 * B * D * BF16 + 2 * B * T * D * BF16, 4 * B * T * D, torch.bfloat16),
                library))
    return [{"row": r, "what": what, "bound_ms": b[0], "bound_by": b[1], "library_ms": lib}
            for r, what, b, lib in out]


if __name__ == "__main__":
    table = rows()
    for row in table:
        lib = row["library_ms"]
        lib = "not measured" if lib is None and row["row"] == "8" else \
            "none" if lib is None else f"{lib:.4f} ms"
        print(f"row {row['row']}, {row['what']}: bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}), one PyTorch call: {lib}")
    print(json.dumps({"unported": table}))
