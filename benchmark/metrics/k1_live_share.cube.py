"""Share of the rows K1's one-launch entry was called on that it
computed: the ``k1.lanes_live`` counter over ``k1.lanes`` (the rows of
each call, counted per graph replay; the live ones summed on the device
for a call the sampler masked, all of an unmasked call's), summed over
the batches of the units the profiler left alone, in %.  The rest are
rows no caller reads (accepted or done slice chains, candidates thinned
away or out of the cube), which cost no channel loop.  None where the
program counts no rows."""

UNIT = "%"
LAYER = "kernels (ops/fused.py, csrc/hf_chi2.cu)"
MOVES = "cube_px_per_s"
SOURCE = "program_counter"


def read(ctx):
    if ctx.entry != "cube":
        return None
    live = lanes = 0
    for k in ctx.untraced:
        tr = getattr(ctx.units[k]["batch"], "trace", None)
        if tr is None:
            continue
        live += tr.counters.get("k1.lanes_live", 0)
        lanes += tr.counters.get("k1.lanes", 0)
    if lanes <= 0:
        return None
    return 100.0 * live / lanes
