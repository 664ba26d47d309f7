"""The host's self time in one micro-batch of the train step (the device
log-mel, the forward and the backward), ms: the program's span
``train.micro`` (``olmoasr_tpu_torch.tracing``) over its count, in the
traced window. None where the program has no such span."""


def read(ctx):
    try:
        from olmoasr_tpu_torch import tracing
    except ImportError:
        return None
    t = tracing.totals().get("train.micro")
    if not t or not t["count"]:
        return None
    return 1000.0 * t["self_seconds"] / t["count"]
