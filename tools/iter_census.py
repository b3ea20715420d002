#!/usr/bin/env python3
"""Device operations a segmented sampler iteration runs, by regime.

One rung-2 ``fit_batch`` (``segment_iters`` 250, nlive 100, tol 1.0,
init_factor 4) on ``R`` synthetic pixels of each of NH3 (1,1)+(2,2)
(``synth.make_synth_cube_arrays``, noise 0.15) and N2H+ (1-0) (two
components, noise 0.1); a second call on the kept graphs runs under
``torch.profiler``.  The device events (kernels, copies, sets) that
start inside each ``ns.segment`` span are counted against the span's
iterations, for the candidate and the kill+slice regimes apart, and
split into K1's (kernels named ``hf_chi2*``), the one-launch prior
transform's (``prior_transform*``), the per-prior path's K2/K3
(``table_lerp*``, ``tapered_invert*``) and the rest.  The recorder's
``k1.``, ``prior.`` and sampler counters come beside them.  One JSON
line.

Run from the root of the repository, on a card::

    python3 tools/iter_census.py [R]
"""

import json
import sys

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, ".")

from nestfit_tpu_torch import oracle, synth  # noqa: E402
from nestfit_tpu_torch.models import (  # noqa: E402
    AmmoniaRunner,
    DiazenyliumRunner,
    ammonia,
    diazenylium,
)
from nestfit_tpu_torch.models.tables import DIAZENYLIUM_TRANSITIONS  # noqa
from nestfit_tpu_torch.priors import (  # noqa: E402
    get_diazenylium_priors,
    get_irdc_priors,
)
from nestfit_tpu_torch.sampling import NSConfig, fit_batch  # noqa: E402
from nestfit_tpu_torch.utils import freq_axis_from_velocity  # noqa: E402
from nestfit_tpu_torch.utils import profiling  # noqa: E402

CFG = NSConfig(nlive=100, tol=1.0, init_factor=4)


def nh3_runner(R):
    (xa11, d11), (xa22, d22), _ = synth.make_synth_cube_arrays(
        n_pix=R, noise=0.15, rng=np.random.default_rng(0))
    specs = [ammonia.make_ammonia_spectrum(x, d, np.full(R, 0.15),
                                           trans_id=t, device="cuda")
             for t, (x, d) in enumerate(((xa11, d11), (xa22, d22)), 1)]
    return AmmoniaRunner(specs, get_irdc_priors(device="cuda"), ncomp=2,
                         device="cuda")


def n2hp_runner(R):
    rng = np.random.default_rng(1)
    xa = freq_axis_from_velocity(np.arange(-20, 20, 0.1),
                                 DIAZENYLIUM_TRANSITIONS[0].nu)
    p = np.stack([rng.uniform(-1.5, -0.5, R), rng.uniform(4, 10, R),
                  rng.uniform(-0.5, 0.5, R), rng.uniform(0.2, 0.5, R)], 1)
    d = np.stack([oracle.nnhp_predict(xa, q, trans_id=1) for q in p])
    spec = diazenylium.make_diazenylium_spectrum(
        xa, d + rng.normal(scale=0.1, size=d.shape), np.full(R, 0.1),
        trans_id=1, device="cuda")
    return DiazenyliumRunner(spec, get_diazenylium_priors(device="cuda"),
                             ncomp=2, device="cuda")


KINDS = {"k1": ("hf_chi2",), "prior": ("prior_transform",),
         "k2_k3": ("table_lerp", "tapered_invert")}


def census(runner, R):
    """``{regime: {ops_per_iter, <kind>_per_iter for kind in KINDS and
    rest_per_iter, iters}}`` of the profiled call, and the recorder's K1,
    prior and sampler counters."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    fit_batch(gen, runner, R, CFG, segment_iters=250, device="cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof, profiling.collect() as tr:
        fit_batch(gen, runner, R, CFG, segment_iters=250, device="cuda")
        torch.cuda.synchronize()
    evs = sorted((e.start_ns(), e.name())
                 for e in prof.profiler.kineto_results.events()
                 if e.device_type() == torch.autograd.DeviceType.CUDA)
    starts = np.array([t for t, _ in evs], dtype=np.int64)
    kind = {k: np.array([any(p in n for p in pats) for _, n in evs])
            for k, pats in KINDS.items()}
    by = {}
    for name, t0, t1, _depth, attrs in tr.spans:
        if name != "ns.segment":
            continue
        lo, hi = np.searchsorted(starts, [t0, t1])
        n = by.setdefault(attrs["mode"], dict.fromkeys(
            ["ops", "iters", *KINDS], 0))
        n["ops"] += int(hi - lo)
        n["iters"] += attrs["i1"] - attrs["i0"]
        for k, hit in kind.items():
            n[k] += int(hit[lo:hi].sum())
    out = {}
    for mode, n in by.items():
        it = max(n["iters"], 1)
        out[mode] = {"ops_per_iter": n["ops"] / it,
                     **{f"{k}_per_iter": n[k] / it for k in KINDS},
                     "rest_per_iter": (n["ops"] - sum(n[k] for k in KINDS))
                     / it, "iters": n["iters"]}
    out["counters"] = {k: v for k, v in tr.counters.items()
                       if k.startswith(("k1.", "prior.", "ns.iterations",
                                        "ns.graph"))}
    return out


def main():
    if not torch.cuda.is_available():
        sys.exit("iter_census: needs a CUDA card")
    R = int(sys.argv[1]) if len(sys.argv) > 1 else 512
    print(json.dumps({"device": torch.cuda.get_device_name(0), "R": R,
                      "nh3": census(nh3_runner(R), R),
                      "n2hp": census(n2hp_runner(R), R)}))


if __name__ == "__main__":
    main()
