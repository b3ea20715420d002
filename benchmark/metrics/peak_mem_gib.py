"""Peak device memory in the window: ``torch.cuda.max_memory_allocated``
after a reset at the window's start."""

UNIT = "GiB"
LAYER = None
MOVES = None
SOURCE = "host_clock"


def read(ctx):
    if ctx.peak_bytes is None:
        return None
    return ctx.peak_bytes / 2**30
