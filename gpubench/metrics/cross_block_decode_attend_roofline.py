"""Row 1's attention core (``cross_block_decode`` ->
``csrc/cross_attention.cu``, the single-pass ``attend_kernel`` with an fp32
query): the least time of its work in the traced window (every decode
step, every layer: K and V of each window read once, q in, the output
out; ``cost.cross_attend_call``) over the device time of those kernels."""

from gpubench import cost

# the cross-attention instantiation: the query's type (second argument) is float
KERNELS = r"attend_kernel<[^,<>]+, float,"


def read(ctx):
    if ctx.trace is None or ctx.peak is None:
        return None
    n, secs = ctx.trace.kernel_seconds(KERNELS)
    steps = ctx.traced.get("batches", [])
    if n == 0 or secs <= 0 or not steps:
        return None
    kv_bytes = 1 if ctx.traffic["decode"].get("kv_quant") else 2
    least = 0.0
    for b in steps:
        call = cost.cross_attend_call(ctx.dims, b["rows"], kv_bytes)
        least += b["steps"] * ctx.dims["n_text_layer"] * cost.least_time_s(
            call["ops"], call["bytes"], ctx.peak)
    return 100.0 * least / secs
