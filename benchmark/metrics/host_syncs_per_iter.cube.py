"""Host reads of device tensors per sampler iteration: the sampler's
reads (``BatchRecords.trace.syncs``, the sites whose name starts with
``ns.``: the done mask, the loop conditions, the fill check, the
acceptance EMA, the probe's estimate) over the iterations its calls ran
(the ``ns.iterations`` counter), summed over the batches of the units
the profiler left alone.  Each read drains the launch queue.  None where
the program keeps no batch trace."""

UNIT = "syncs/iter"
LAYER = "sampler (sampling/sampler.py)"
MOVES = "cube_px_per_s"
SOURCE = "program_counter"


def read(ctx):
    if ctx.entry != "cube":
        return None
    syncs = iters = 0
    for k in ctx.untraced:
        tr = getattr(ctx.units[k]["batch"], "trace", None)
        if tr is None:
            continue
        syncs += sum(c for site, (c, _w) in tr.syncs.items()
                     if site.startswith("ns."))
        iters += tr.counters.get("ns.iterations", 0)
    if iters <= 0:
        return None
    return syncs / iters
