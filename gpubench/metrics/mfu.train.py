"""The measured window's training FLOPs (``cost.train_flops_per_sample``
times the samples its steps took) over its seconds, as a share of the
card's dense bf16 peak."""

from gpubench import cost


def read(ctx):
    samples = ctx.window.get("counts", {}).get("samples", 0)
    if ctx.peak is None or not samples:
        return None
    flops = samples * cost.train_flops_per_sample(ctx.dims)
    return 100.0 * flops / (ctx.window["seconds"] * ctx.peak["bf16_flops_per_s"])
