"""The host's self time in one single-token decode step's call
(``decode_step``: launching every layer's kernels), ms: the program's span
``decode.step`` (``olmoasr_tpu_torch.tracing``) over its count, in the
traced window. None where the program has no such span."""


def read(ctx):
    try:
        from olmoasr_tpu_torch import tracing
    except ImportError:
        return None
    t = tracing.totals().get("decode.step")
    if not t or not t["count"]:
        return None
    return 1000.0 * t["self_seconds"] / t["count"]
