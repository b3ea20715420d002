"""Share of the segmented sampler's units of work (candidate
iterations, slice fills, kill+slice iterations) that ran as CUDA graph
replays: the ``ns.graph_steps`` counter over it and ``ns.eager_steps``
(each graph key's first run, and every unit of a run kept out of
graphs), summed over the batches of the units the profiler left alone,
in %.  None where the program counts neither."""

UNIT = "%"
LAYER = "sampler (sampling/sampler.py)"
MOVES = "cube_px_per_s"
SOURCE = "program_counter"


def read(ctx):
    if ctx.entry != "cube":
        return None
    graph = eager = 0
    for k in ctx.untraced:
        tr = getattr(ctx.units[k]["batch"], "trace", None)
        if tr is None:
            continue
        graph += tr.counters.get("ns.graph_steps", 0)
        eager += tr.counters.get("ns.eager_steps", 0)
    if graph + eager <= 0:
        return None
    return 100.0 * graph / (graph + eager)
