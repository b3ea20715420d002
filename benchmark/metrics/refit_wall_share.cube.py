"""Share of the cube ladder's wall spent in its second pass (mode-loss
retries and boundary refits): sum(total_wall - wall) / sum(total_wall)
over the rungs of every batch the profiler left alone
(``BatchRecords.rungs``, the program's own host clock after a sync)."""

UNIT = "%"
LAYER = "cube ladder (cube/fitter.py)"
MOVES = "cube_px_per_s"
SOURCE = "program_span"


def read(ctx):
    if ctx.entry != "cube":
        return None
    rungs = [r for k in ctx.untraced if ctx.units[k]["batch"] is not None
             for r in ctx.units[k]["batch"].rungs]
    total = sum(r["total_wall"] for r in rungs)
    if total <= 0:
        return None
    return 100.0 * sum(r["total_wall"] - r["wall"] for r in rungs) / total
