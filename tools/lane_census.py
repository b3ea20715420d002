#!/usr/bin/env python3
"""Rows K1's one-launch likelihood is called on, and the rows the
sampler reads, by regime; no card needed.

One NH3 (1,1)+(2,2) ``fit_batch`` at ncomp 2 and one at ncomp 1 (R
synthetic pixels, ``synth.make_synth_cube_arrays`` at noise 0.15, IRDC
priors; nlive 100, tol 1.0, init_factor 4, ``segment_iters`` 250) on
the CPU, through the one-launch entry's plain version
(``ops.fused.hf_lnl_plain``, which honours the sampler's live masks as
the kernel does).  For each fit and regime, the recorder's ``k1.lanes``
(rows launched), ``k1.lanes_live`` (rows computed) and the calls the
sampler consumes (its ``ncall``): ``slice``, every shrinkage round of a
slice step (the candidate block's fills and the kill+slice
iterations); ``cand``, the candidate iterations' proposals; ``init``,
the initial live set.  One JSON line a fit.

Run from the root of the repository::

    python3 tools/lane_census.py [R]
"""

import json
import sys
import time

import numpy as np
import torch

sys.path.insert(0, ".")

from nestfit_tpu_torch import synth  # noqa: E402
from nestfit_tpu_torch.models import AmmoniaRunner, ammonia  # noqa: E402
from nestfit_tpu_torch.priors import get_irdc_priors  # noqa: E402
from nestfit_tpu_torch.sampling import NSConfig, fit_batch  # noqa: E402
from nestfit_tpu_torch.sampling import sampler  # noqa: E402
from nestfit_tpu_torch.utils import profiling  # noqa: E402

CFG = NSConfig(nlive=100, tol=1.0, init_factor=4)


class OneLaunchRunner(AmmoniaRunner):
    """The NH3 runner on the one-launch entry on the CPU too."""

    def log_likelihood(self, theta, plain=False, live=None):
        return self._log_likelihood(theta, fused=True, live=live)


def nh3_runner(R, ncomp):
    (xa11, d11), (xa22, d22), _ = synth.make_synth_cube_arrays(
        n_pix=R, noise=0.15, rng=np.random.default_rng(0))
    specs = [ammonia.make_ammonia_spectrum(x, d, np.full(R, 0.15),
                                           trans_id=t, device="cpu")
             for t, (x, d) in enumerate(((xa11, d11), (xa22, d22)), 1)]
    return OneLaunchRunner(specs, get_irdc_priors(device="cpu"),
                           ncomp=ncomp, device="cpu")


def census(R, ncomp):
    """``{regime: {lanes, lanes_live, ncall}}`` of one fit."""
    tally = {k: dict.fromkeys(("lanes", "lanes_live", "ncall"), 0)
             for k in ("slice", "cand", "init")}
    shrink, cand_iter = sampler._shrink_slice, sampler._cand_iter

    def add(regime, counters, ncall):
        t = tally[regime]
        t["lanes"] += counters.get("k1.lanes", 0)
        t["lanes_live"] += counters.get("k1.lanes_live", 0)
        t["ncall"] += ncall

    def shrink_counted(*args, **kw):
        with profiling.collect() as tr:
            out = shrink(*args, **kw)
        add("slice", tr.counters, int(out[4].sum()))
        return out

    def cand_counted(s, *args, **kw):
        # the ellipsoid proposals (method "auto" runs no slice step here)
        with profiling.collect() as tr:
            out = cand_iter(s, *args, **kw)
        add("cand", tr.counters, int((out[0].ncall - s.ncall).sum()))
        return out

    sampler._shrink_slice, sampler._cand_iter = shrink_counted, cand_counted
    try:
        runner = nh3_runner(R, ncomp)
        gen = torch.Generator().manual_seed(3)
        t0 = time.perf_counter()
        with profiling.collect() as tr:
            fit = fit_batch(gen, runner, R, CFG, segment_iters=250,
                            device="cpu")
        wall = time.perf_counter() - t0
    finally:
        sampler._shrink_slice, sampler._cand_iter = shrink, cand_iter
    total = {k: tr.counters.get(f"k1.{k}", 0) for k in ("lanes",
                                                        "lanes_live")}
    init = tally["init"]
    init["lanes"] = total["lanes"] - tally["slice"]["lanes"] \
        - tally["cand"]["lanes"]
    init["lanes_live"] = total["lanes_live"] \
        - tally["slice"]["lanes_live"] - tally["cand"]["lanes_live"]
    init["ncall"] = R * (CFG.nlive + CFG.n_init_dead())
    for t in tally.values():
        t["live_share"] = t["lanes_live"] / max(t["lanes"], 1)
        t["read_share"] = t["ncall"] / max(t["lanes"], 1)
    return {"ncomp": ncomp, "R": R, "nlive": CFG.nlive,
            "init_factor": CFG.init_factor, "segment_iters": 250,
            "k1.lanes": total["lanes"], "k1.lanes_live": total["lanes_live"],
            "live_share": total["lanes_live"] / max(total["lanes"], 1),
            "ncall": int(fit.ns.ncall.sum()),
            "iterations": tr.counters.get("ns.iterations", 0),
            "by_regime": tally, "wall_s": round(wall, 1),
            "device": "cpu"}


def main():
    R = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    torch.set_num_threads(min(4, torch.get_num_threads()))
    for ncomp in (2, 1):
        print(json.dumps(census(R, ncomp)), flush=True)


if __name__ == "__main__":
    main()
