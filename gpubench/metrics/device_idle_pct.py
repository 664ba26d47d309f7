"""The share of the traced window in which no operation ran on the device;
the reader of every ``device_idle_pct.<cells>`` metric."""


def read(ctx):
    t = ctx.trace
    if t is None or t.busy_s <= 0 or t.window_s <= 0:
        return None
    return 100.0 * (t.window_s - t.busy_s) / t.window_s
