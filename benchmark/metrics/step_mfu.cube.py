"""The whole step's share of the card's peak: the bound time of the
useful likelihood work of the units the profiler left alone over their
wall on the host's clock.  It bounds K1's roofline share from below
whatever kernels the units run."""

from core import readings

UNIT = "%"
LAYER = "step (a unit of work, whole)"
MOVES = "cube_px_per_s"
SOURCE = "program_counter"


def read(ctx):
    if ctx.entry != "cube":
        return None
    return readings.step_mfu(ctx)
