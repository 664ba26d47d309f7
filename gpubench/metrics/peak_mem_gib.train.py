"""The allocator's peak over the measured window
(``torch.cuda.max_memory_allocated`` after a reset at its start), GiB."""


def read(ctx):
    if ctx.window_peak_bytes <= 0:
        return None
    return ctx.window_peak_bytes / 2 ** 30
