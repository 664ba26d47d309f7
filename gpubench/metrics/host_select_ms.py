"""The host's self time between two decode steps (the filters, the next
token, the log-prob sum, the token write, the finished flags, the exit
reads), ms a step: the program's span ``decode.select``
(``olmoasr_tpu_torch.tracing``) over the traced batches' single-token
steps. None where the program has no such span."""


def read(ctx):
    try:
        from olmoasr_tpu_torch import tracing
    except ImportError:
        return None
    t = tracing.totals().get("decode.select")
    steps = sum(b["steps"] for b in ctx.traced.get("batches", []))
    if not t or not t["count"] or not steps:
        return None
    return 1000.0 * t["self_seconds"] / steps
