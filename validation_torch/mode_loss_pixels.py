#!/usr/bin/env python3
"""Reproduce and instrument the mode-loss pixels on the port.

The counterpart of ``validation/mode_loss_pixels.py`` on
``nestfit_tpu_torch``: pixels 17 and 23 of the bench cube (1024 px,
noise 0.15, cube seed 5), whose rung-2 evidence the JAX package's TPU
record put 25 / 7 nats low of the native nlive=400 truth -- one narrow,
weak component beside a broad strong one.  Each pixel is fitted on rung
2, one ``fit_batch`` per seed (generator seed ``1000 + seed``) and init
factor, and one JSON line per (pixel, init factor) gives the lnZ2
distribution, the spread of the max lnL, the MAP parameters per seed and
``n_mode_lost``: the runs more than 8 nats below the native lnZ2.

The native lnZ2 is the median over the engine's seeds in
``validation/native_truth_seed5.json`` (the JAX script hard-codes it;
its ``lnz1`` values there are stale, ROADMAP R4, and never read).
``--mode`` picks the sampler mode (``segmented``: ``segment_iters=250``,
the JAX script's; ``traced``: 0); ``--device`` the device.

Usage: python validation_torch/mode_loss_pixels.py [--pixels 17,23]
         [--seeds 8] [--init-factors 1,4] [--nlive 100] [--kill-k 0]
         [--sbe 1] [--mode segmented|traced] [--device cuda]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench_torch  # noqa: E402
from validation_torch.agreement import NATIVE, SEGMENT_ITERS  # noqa: E402

MODE_LOST_NATS = 8.0
PAR_NAMES = ["voff", "trot", "tex", "ntot", "sigm", "orth"]


def native_lnz2(pixels, path=NATIVE):
    """The engine's median lnZ2 per pixel (None where the artifact has no
    record of the pixel)."""
    with open(path) as fh:
        recs = json.load(fh)["records"]
    out = {}
    for p in pixels:
        seeds = list(recs.get(str(p), {}).get("seeds", {}).values())
        out[p] = float(np.median([s["lnz2"] for s in seeds])) \
            if seeds else None
    return out


def probe(pixels=(17, 23), seeds=8, init_factors=(1, 4), nlive=100,
          kill_k=0, sbe=1, mode="segmented", device="cuda",
          native=NATIVE):
    """Yield one dict per (init factor, pixel): the JAX script's line
    plus ``mode``."""
    import torch
    from nestfit_tpu_torch.priors import get_irdc_priors
    from nestfit_tpu_torch.sampling import NSConfig, fit_batch
    from nestfit_tpu_torch.synth import make_synth_cube_arrays

    noise, cube_seed = 0.15, 5
    (xa11, d11), (xa22, d22), truth = make_synth_cube_arrays(
        n_pix=1024, noise=noise, rng=np.random.default_rng(cube_seed))
    ix = np.asarray(pixels)
    sub = ((xa11, d11[ix]), (xa22, d22[ix]))
    runner2 = bench_torch.make_runner(
        sub, 2, get_irdc_priors(vsys=0.0, device=device), device,
        noise=noise)
    nat = native_lnz2(pixels, native)

    def host(x):
        return x.detach().cpu().numpy()

    for f in init_factors:
        cfg = NSConfig(nlive=nlive, tol=1.0, init_factor=f, kill_k=kill_k,
                       slice_bound_every=sbe)
        rows = {p: [] for p in pixels}
        bench_torch.sync(device)
        t0 = time.perf_counter()
        for s in range(seeds):
            gen = torch.Generator(device=device).manual_seed(1000 + s)
            r = fit_batch(gen, runner2, len(ix), cfg,
                          segment_iters=SEGMENT_ITERS[mode], device=device)
            lnz, mll = host(r.lnz), host(r.ns.max_loglike)
            mapp, nc = host(r.products.map_params), host(r.ns.ncall)
            for j, p in enumerate(pixels):
                rows[p].append({
                    "seed": s, "lnz2": float(lnz[j]),
                    "max_lnl": float(mll[j]),
                    "ncall": int(nc[j]),
                    "map": np.round(mapp[j], 3).tolist(),
                })
        bench_torch.sync(device)
        wall = time.perf_counter() - t0
        for p in pixels:
            v = np.array([r["lnz2"] for r in rows[p]])
            ml = np.array([r["max_lnl"] for r in rows[p]])
            n_lost = int(np.sum(v < (nat[p] or v.max()) - MODE_LOST_NATS))
            yield {
                "pixel": p, "init_factor": f, "nlive": nlive,
                "kill_k": kill_k, "sbe": sbe, "mode": mode,
                "native_lnz2": nat[p],
                "lnz2_median": float(np.median(v)),
                "lnz2_min": float(v.min()), "lnz2_max": float(v.max()),
                "lnz2_scatter": float(v.std(ddof=1)) if v.size > 1 else 0.0,
                "max_lnl_spread": float(ml.max() - ml.min()),
                "n_seeds": seeds, "n_mode_lost": n_lost,
                "truth": np.round(truth[p], 3).tolist(),
                "par_names": PAR_NAMES,
                "wall_s": round(wall, 1),
                "seeds": rows[p],
            }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pixels", default="17,23")
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--init-factors", default="1,4")
    ap.add_argument("--nlive", type=int, default=100)
    ap.add_argument("--kill-k", type=int, default=0)
    ap.add_argument("--sbe", type=int, default=1)
    ap.add_argument("--mode", choices=sorted(SEGMENT_ITERS),
                    default="segmented")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for line in probe(
            [int(p) for p in args.pixels.split(",")], args.seeds,
            [int(f) for f in args.init_factors.split(",")], args.nlive,
            args.kill_k, args.sbe, args.mode, args.device):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
