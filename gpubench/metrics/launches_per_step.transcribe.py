"""Device kernel launches of the traced window over the port's count of
single-token decode steps (``decode_step.single_steps``) in it: the host
loop's launches a step, the encoder's and the log-mel's spread over them."""


def read(ctx):
    steps = sum(b["steps"] for b in ctx.traced.get("batches", []))
    if ctx.trace is None or ctx.trace.n_kernels == 0 or steps == 0:
        return None
    return ctx.trace.n_kernels / steps
