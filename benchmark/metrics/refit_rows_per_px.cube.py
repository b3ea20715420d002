"""Rows the cube ladder sent to a second pass (mode-loss retries and
boundary refits) per pixel: the ``cube.refit_rows`` counter over the
valid pixels of the batches the profiler left alone.  It tells how much
refit work there was, apart from how long it took
(``refit_wall_share.cube``).  None where the program counts no refit
rows."""

UNIT = "rows/px"
LAYER = "cube ladder (cube/fitter.py)"
MOVES = "cube_px_per_s"
SOURCE = "program_counter"


def read(ctx):
    if ctx.entry != "cube":
        return None
    rows = pixels = 0
    seen = False
    for k in ctx.untraced:
        tr = getattr(ctx.units[k]["batch"], "trace", None)
        if tr is None or "cube.refit_rows" not in tr.counters:
            continue
        seen = True
        rows += tr.counters["cube.refit_rows"]
        pixels += ctx.units[k]["pixels"]
    if not seen or pixels <= 0:
        return None
    return rows / pixels
