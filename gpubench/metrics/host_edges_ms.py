"""The host's self time around a batch's decode loop, ms a batch: the
program's spans ``decode.encode``, ``decode.cross_cache``,
``decode.prefill`` and ``decode.results`` (``olmoasr_tpu_torch.tracing``)
over the traced batches. None where the program has no such span."""

SPANS = ("decode.encode", "decode.cross_cache", "decode.prefill", "decode.results")


def read(ctx):
    try:
        from olmoasr_tpu_torch import tracing
    except ImportError:
        return None
    totals = tracing.totals()
    found = [totals[s] for s in SPANS if totals.get(s, {}).get("count")]
    batches = len(ctx.traced.get("batches", []))
    if not found or not batches:
        return None
    return 1000.0 * sum(t["self_seconds"] for t in found) / batches
