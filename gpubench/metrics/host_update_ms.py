"""The host's self time in the train step's update (the gradients'
division, ``clip_by_global_norm``, the learning rate, ``opt.step``), ms a
step: the program's span ``train.update`` (``olmoasr_tpu_torch.tracing``)
over its count, in the traced window. None where the program has no such
span."""


def read(ctx):
    try:
        from olmoasr_tpu_torch import tracing
    except ImportError:
        return None
    t = tracing.totals().get("train.update")
    if not t or not t["count"]:
        return None
    return 1000.0 * t["self_seconds"] / t["count"]
