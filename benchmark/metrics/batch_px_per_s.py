"""Pixels through ``fit_batch`` rung 1 then rung 2 per second: every
pixel of every unit in the window, over the window's whole wall."""

UNIT = "px/s"
LAYER = None
MOVES = None
SOURCE = "host_clock"


def read(ctx):
    if ctx.entry != "batch":
        return None
    return ctx.pixels / ctx.window.wall
