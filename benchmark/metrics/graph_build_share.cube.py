"""Share of the cube batches' wall spent building the sampler's CUDA
graphs: the summed lengths of the program's ``graphs.first_run`` spans
(the eager first run of each graph key that is then captured) and
``graphs.capture`` spans (its capture) over the summed lengths of its
``cube.batch`` spans, over the batches of the units the profiler left
alone, in %.  Both graph spans are host walls: the eager run's span
closes when its launches are issued, not when the card has run them,
so the device work it queued is counted where the host next waits for
it.  None where the program records no ``graphs.first_run`` span (it
captures nothing on the CPU, and a program without the span) or no
batch."""

UNIT = "%"
LAYER = "sampler (sampling/graphs.py)"
MOVES = "cube_px_per_s"
SOURCE = "program_span"
BUILD = ("graphs.first_run", "graphs.capture")


def read(ctx):
    if ctx.entry != "cube":
        return None
    build = batch = 0
    first_runs = False
    for k in ctx.untraced:
        tr = getattr(ctx.units[k]["batch"], "trace", None)
        if tr is None:
            continue
        for name, t0, t1, _depth, _attrs in tr.spans:
            if name in BUILD:
                build += t1 - t0
                first_runs |= name == BUILD[0]
            elif name == "cube.batch":
                batch += t1 - t0
    if not first_runs or batch <= 0:
        return None
    return 100.0 * build / batch
