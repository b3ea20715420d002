"""Share of the traced unit's wall in which the device was idle inside
the program's ``fit.sampler`` spans: the length of those spans' union
less the part the traced unit's device operations cover, over the
unit's wall, in %.  The spans are stamped on the profiler's own clock
(``BatchRecords.trace``, ns) and the device intervals read from the
trace (us): no alignment.  ``device_idle.cube`` less this share is the
idle of the ladder's own host code and the fits' other parts.  None
where the program keeps no batch trace or the trace holds no
operation."""

from core import readings

UNIT = "%"
LAYER = "sampler (sampling/sampler.py)"
MOVES = "cube_px_per_s"
SOURCE = "program_span"
SPAN = "fit.sampler"


def union(intervals):
    """Disjoint sorted ``[lo, hi]`` covering ``intervals``."""
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def covered(a, b):
    """Length of the overlap of two disjoint sorted interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def read(ctx):
    if ctx.entry != "cube" or ctx.trace is None or not ctx.trace.kernels:
        return None
    spans = []
    for k in readings.traced_units(ctx):
        tr = getattr(ctx.units[k]["batch"], "trace", None)
        if tr is not None:
            spans += [(t0 / 1e3, t1 / 1e3) for name, t0, t1, _d, _a
                      in tr.spans if name == SPAN]
    if not spans:
        return None
    inside = union(spans)
    busy = covered(inside, union((s, s + d)
                                 for _n, s, d in ctx.trace.kernels))
    idle_us = sum(hi - lo for lo, hi in inside) - busy
    return 100.0 * idle_us / 1e6 / ctx.trace.wall
