"""Rows 3 and 9 (``ops/train_attention.py`` -> ``csrc/train_attention.cu``
on ``attention_mma.cuh``'s forward and backward kernels): the least time
of the attention the traced steps' samples need (``cost
.train_attention_per_sample``: forward and backward, no remat) over the
device time of those kernels, the remat forward included."""

from gpubench import cost

KERNELS = (r"attn_fwd_mma_kernel|attn_bwd_dq_mma_kernel|attn_bwd_dkv_mma_kernel"
           r"|attn_fwd_f32_kernel|attn_bwd_dq_kernel|attn_bwd_dkv_kernel")


def read(ctx):
    if ctx.trace is None or ctx.peak is None:
        return None
    n, secs = ctx.trace.kernel_seconds(KERNELS)
    samples = ctx.traced.get("samples", 0)
    if n == 0 or secs <= 0 or not samples:
        return None
    work = cost.train_attention_per_sample(ctx.dims)
    return 100.0 * samples * cost.least_time_s(work["ops"], work["bytes"], ctx.peak) / secs
