"""Device operations per sampler iteration in the traced unit: the
operations of its device trace (kernels, copies and fills) over the
iterations its batch's sampler calls ran (the ``ns.iterations`` counter
of ``BatchRecords.trace``).  The ladder's own operations (records,
merges) count too; they are few.  None where the program keeps no batch
trace or the trace holds no operation."""

from core import readings

UNIT = "ops/iter"
LAYER = "sampler (sampling/sampler.py)"
MOVES = "cube_px_per_s"
SOURCE = "device_trace"


def read(ctx):
    if ctx.entry != "cube" or ctx.trace is None or not ctx.trace.kernels:
        return None
    iters = 0
    for k in readings.traced_units(ctx):
        tr = getattr(ctx.units[k]["batch"], "trace", None)
        if tr is not None:
            iters += tr.counters.get("ns.iterations", 0)
    if iters <= 0:
        return None
    return len(ctx.trace.kernels) / iters
