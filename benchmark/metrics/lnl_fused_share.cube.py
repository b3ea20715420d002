"""Share of K1's likelihood launches that were the one-launch entry
(every transition, the per-component step and the noise scaling in one
launch): the ``k1.lnl_fused`` counter over it and ``k1.lnl_split`` (the
per-transition entry, one launch a transition), counted per graph
replay and summed over the batches of the units the profiler left
alone, in %.  None where the program counts neither."""

UNIT = "%"
LAYER = "kernels (ops/fused.py, csrc/hf_chi2.cu)"
MOVES = "cube_px_per_s"
SOURCE = "program_counter"


def read(ctx):
    if ctx.entry != "cube":
        return None
    fused = split = 0
    for k in ctx.untraced:
        tr = getattr(ctx.units[k]["batch"], "trace", None)
        if tr is None:
            continue
        fused += tr.counters.get("k1.lnl_fused", 0)
        split += tr.counters.get("k1.lnl_split", 0)
    if fused + split <= 0:
        return None
    return 100.0 * fused / (fused + split)
