"""Share of the traced blocks run with under a tenth of the rows still
active: sum of ``straggler_blocks`` over sum of ``blocks`` of
``graphs.last_stats`` after each ``fit_batch`` call."""

UNIT = "%"
LAYER = "traced host loop (sampling/graphs.py)"
MOVES = "batch_px_per_s"
SOURCE = "program_counter"


def read(ctx):
    if ctx.entry != "batch":
        return None
    rungs = [r for u in ctx.units for r in u["rungs"]]
    blocks = sum(r["blocks"] for r in rungs)
    if blocks == 0:
        return None
    return 100.0 * sum(r["straggler_blocks"] for r in rungs) / blocks
