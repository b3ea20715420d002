"""Seconds from the process's start to the window's start: imports, the
kernels' build (a cache hit after a checkout's first run), the inputs,
the runners and their preparation."""

UNIT = "s"
LAYER = None
MOVES = None
SOURCE = "host_clock"


def read(ctx):
    return ctx.setup_s
