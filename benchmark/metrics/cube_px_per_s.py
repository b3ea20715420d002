"""Valid pixels through the whole cube ladder per second: the pixels of
every batch ``CubeFitter._fit_batches`` yielded in the window, over the
window's whole wall."""

UNIT = "px/s"
LAYER = None
MOVES = None
SOURCE = "host_clock"


def read(ctx):
    if ctx.entry != "cube":
        return None
    return ctx.pixels / ctx.window.wall
