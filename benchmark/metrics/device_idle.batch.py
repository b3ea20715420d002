"""Share of the traced unit in which no operation ran on the device: one
less the union of its device operations' intervals over its wall.  The
profiler slows the host, so this overstates the idle share of an
untraced unit."""

from core import readings

UNIT = "%"
LAYER = "device"
MOVES = "batch_px_per_s"
SOURCE = "device_trace"


def read(ctx):
    if ctx.entry != "batch":
        return None
    return readings.device_idle(ctx)
