"""The share of the measured window in which the step loop waited for the
loader's next batch (the harness's host clock around ``next``)."""


def read(ctx):
    secs = ctx.window.get("seconds", 0.0)
    if secs <= 0 or "loader_wait" not in ctx.spans.seconds:
        return None
    return 100.0 * ctx.spans.seconds["loader_wait"] / secs
