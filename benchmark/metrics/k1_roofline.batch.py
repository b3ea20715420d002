"""K1 (``hf_chi2_fused``) against its roofline: the bound time of the
useful likelihood work of the traced unit (``core/roofline.py``: the
calls of the runs whose answers are kept) over K1's device time in that
unit.  Padding rows, done rows in a block and thrown-away refits cost
time and count no work."""

from core import readings

UNIT = "%"
LAYER = "kernels (ops/fused.py, csrc/hf_chi2.cu)"
MOVES = "batch_px_per_s"
SOURCE = "device_trace"


def read(ctx):
    if ctx.entry != "batch":
        return None
    return readings.k1_roofline(ctx)
