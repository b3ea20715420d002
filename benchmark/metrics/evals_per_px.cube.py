"""Likelihood calls per pixel of the runs the cube batches kept: the
sum of the records' ``n_calls`` (every rung) over the batches' pixels."""

from core import readings

UNIT = "evals/px"
LAYER = "sampler (sampling/sampler.py)"
MOVES = "cube_px_per_s"
SOURCE = "program_counter"


def read(ctx):
    if ctx.entry != "cube" or ctx.pixels == 0:
        return None
    return sum(readings.useful_calls(ctx).values()) / ctx.pixels
