"""Likelihood calls per pixel through both rungs: the sum over rungs of
the mean ``fit.ns.ncall`` of every row, averaged over the window's
units."""

from core import readings

UNIT = "evals/px"
LAYER = "sampler (sampling/sampler.py)"
MOVES = "batch_px_per_s"
SOURCE = "program_counter"


def read(ctx):
    if ctx.entry != "batch" or ctx.pixels == 0:
        return None
    return sum(readings.useful_calls(ctx).values()) / ctx.pixels
