"""The share of the traced window in which the loader assembled batches:
the seconds of the program's span ``loader.batch``
(``olmoasr_tpu_torch.tracing``; on the loader's producer thread, beside
the steps) over the traced window's wall on the device's clock. The
producer runs up to ``prefetch + 1`` batches ahead and stops at an epoch's
end, so a traced step may fall where it assembles nothing: 0 when the
window recorded the train step's spans (``train.micro``) and no
``loader.batch``. None where the program has no such spans."""


def read(ctx):
    try:
        from olmoasr_tpu_torch import tracing
    except ImportError:
        return None
    totals = tracing.totals()
    if not totals.get("train.micro", {}).get("count") or ctx.trace is None \
            or ctx.trace.window_s <= 0:
        return None
    return 100.0 * totals.get("loader.batch", {}).get("seconds", 0.0) / ctx.trace.window_s
