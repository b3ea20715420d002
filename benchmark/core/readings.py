"""What the per-layer readers share: the window's useful likelihood
calls, K1's device time and the bound of that work.

A traced run profiles one unit (``ctx.trace``); the device's readings
come from it, and the host-timed ones from the units the profiler left
alone (``ctx.untraced``), since it slows a host-bound unit.
"""

from core import roofline

K1_NAME = "hf_chi2"


def traced_units(ctx):
    return [k for k in range(len(ctx.units)) if k not in ctx.untraced]


def useful_calls(ctx, ks=None):
    """``{ncomp: likelihood calls}`` of the runs whose answers are kept,
    in units ``ks`` (default all): the records a cube batch handed back,
    or every row of every ``fit_batch`` call of the batch entry."""
    ks = range(len(ctx.units)) if ks is None else ks
    calls = {}
    if ctx.entry == "cube":
        for k in ks:
            b = ctx.units[k]["batch"]
            if b is None:
                continue
            for _pix, ncomp, (attrs, _d) in b.records:
                calls[ncomp] = calls.get(ncomp, 0) + int(attrs["n_calls"])
    else:
        for run in ctx.tap.runs:
            if run["unit"] in ks:
                calls[run["ncomp"]] = calls.get(run["ncomp"], 0) + int(
                    run["ncall"].astype("int64").sum())
    return calls


def useful_bound_s(ctx, ks=None):
    """Least time the card could take for the useful K1 work of units
    ``ks``, or None where the card's clock was not read."""
    if ctx.card is None or ctx.card.get("clock_hz") is None:
        return None
    work = roofline.k1_work(useful_calls(ctx, ks), ctx.lines_x_channels,
                            ctx.n_model)
    return roofline.bound_s(work, ctx.card)


def k1_device_s(ctx):
    if ctx.trace is None:
        return None
    t = sum(d for name, _s, d in ctx.trace.kernels if K1_NAME in name)
    return t / 1e6 if t > 0 else None


def k1_roofline(ctx):
    """The traced unit's useful K1 work at its bound over K1's device
    time, in %."""
    bound, k1 = useful_bound_s(ctx, traced_units(ctx)), k1_device_s(ctx)
    if bound is None or k1 is None:
        return None
    return 100.0 * bound / k1


def step_mfu(ctx):
    """The untraced units' useful K1 work at its bound over their wall,
    in %."""
    if not ctx.untraced:
        return None
    bound = useful_bound_s(ctx, ctx.untraced)
    if bound is None:
        return None
    return 100.0 * bound / sum(ctx.window.walls[k] for k in ctx.untraced)


def device_idle(ctx):
    """One less the union of the traced unit's device intervals over its
    wall, in %."""
    if ctx.trace is None or not ctx.trace.kernels:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.wall)
