#!/usr/bin/env python3
"""Count the nested-model evidence-floor violations on the port, before
any retry.

The counterpart of ``validation/mode_loss_probe.py`` on
``nestfit_tpu_torch``: rung 1 and rung 2 of ``fit_batch`` on the bench
cube (``n_px`` pixels of cube seed 5, noise 0.15, the IRDC priors at
``vsys=0``), no second pass and no retry, per named sampler variant and
seed, counting ``viol1 = sum(lnZ1 < null - 8)`` and ``viol2 = sum(lnZ2 <
lnZ1 - 8)``: the runs the fitter's mode-loss retries would re-fit.  One
runner per rung serves every variant and seed.

The JAX script's variants, margin, defaults, per-seed line and final JSON
dict (``viol1``, ``viol2``, ``evals_px``, ``wall_s`` per variant) are kept;
the dict adds ``mode`` and ``card``.  Each JAX key ``random.key(100 +
seed)`` becomes one generator per rung ``n``, seeded ``10 * (100 + seed)
+ n``, so agreement with the JAX record is statistical.  ``wall_s`` is
both rungs' wall and includes first-call costs: the kernel build on the
first pair and, traced, each variant's graph warm-ups and captures (a
variant is a new ``NSConfig``, hence a new program).

Added: ``--mode segmented|traced`` (``segment_iters`` 250, the JAX
script's, or 0, ``fit_batch``'s default), ``--device``, and ``--out``: one
JSON line per (variant, seed) is appended there (with the pixels whose
floor broke and whether every lnZ was finite), and a second call with the
same ``--out`` skips the pairs it already holds at the same mode and
width, so the variants can span several calls.

Usage: python validation_torch/mode_loss_probe.py [n_seeds] [n_px]
         [variants] [--mode segmented|traced] [--out PATH]
         [--device cuda]
``variants`` is a comma list of the names in ``VARIANTS`` (default
"lhs,iid").
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
from validation_torch.agreement import SEGMENT_ITERS, card_or_none  # noqa

MARGIN = 8.0
CUBE_SEED = 5

VARIANTS = {
    "lhs": {},
    "iid": {"init_stratified": False},
    "kill12": {"kill_k": 12},
    "kill6": {"kill_k": 6},
    "diff": {"dir_mode": "diff"},
    "diff3": {"dir_mode": "diff", "fallback_repeats": 3},
    "rep6": {"fallback_repeats": 6},
    "rep8": {"fallback_repeats": 8},
    "fudge": {"ell_fudge": 1.25},
    "efr01": {"efr": 0.1},
    "nlive150": {"nlive": 150},
}


def config(tag, overrides=None):
    """The variant's ``NSConfig``: nlive 100, tol 1.0 and its knobs
    (``overrides`` last: a toy run's)."""
    from nestfit_tpu_torch.sampling import NSConfig

    kw = dict(nlive=100, tol=1.0)
    kw.update(VARIANTS[tag])
    kw.update(overrides or {})
    return NSConfig(**kw)


def make_runners(n_px, device, seed=CUBE_SEED):
    """One ``AmmoniaRunner`` per rung over the ``n_px`` pixels of the
    synthetic NH3 cube of seed ``seed`` (the bench cube's by default)."""
    from nestfit_tpu_torch.priors import get_irdc_priors

    cube = bench_torch.make_cube(n_px, seed)
    utrans = get_irdc_priors(vsys=0.0, device=device)
    return {n: bench_torch.make_runner(cube, n, utrans, device)
            for n in (1, 2)}


def probe_pair(runners, n_px, tag, seed, mode, device, card=None,
               overrides=None):
    """Both rungs of one (variant, seed): its ``--out`` record."""
    import torch
    from nestfit_tpu_torch.sampling import fit_batch

    cfg = config(tag, overrides)
    fits = {}
    bench_torch.sync(device)
    t0 = time.perf_counter()
    for n in (1, 2):
        gen = torch.Generator(device=device).manual_seed(
            10 * (100 + seed) + n)
        fits[n] = fit_batch(gen, runners[n], n_px, cfg,
                            segment_iters=SEGMENT_ITERS[mode], device=device)
    bench_torch.sync(device)
    wall = time.perf_counter() - t0
    lnz1, lnz2 = (fits[n].lnz.cpu().numpy() for n in (1, 2))
    null = fits[1].null_lnz.cpu().numpy()
    bad1 = np.flatnonzero(lnz1 < null - MARGIN)
    bad2 = np.flatnonzero(lnz2 < lnz1 - MARGIN)
    nc = sum(fits[n].ns.ncall.cpu().numpy().astype(np.int64).mean()
             for n in (1, 2))
    return {"variant": tag, "seed": seed, "n_px": n_px, "mode": mode,
            "card": card, "viol1": int(bad1.size), "viol2": int(bad2.size),
            "evals_px": float(nc), "wall_s": wall,
            "viol1_px": bad1.tolist(), "viol2_px": bad2.tolist(),
            "lnz_finite": bool(np.isfinite(lnz1).all()
                               and np.isfinite(lnz2).all())}


def read_out(out, key, **match):
    """The JSON-line records already at ``out`` whose fields equal
    ``match``, by ``key(record)``."""
    done = {}
    if out and os.path.exists(out):
        with open(out) as fh:
            for line in fh:
                if line.strip():
                    rec = json.loads(line)
                    if all(rec.get(k) == v for k, v in match.items()):
                        done[key(rec)] = rec
    return done


def probe(n_seeds=2, n_px=1024, variants="lhs,iid", mode="segmented",
          device="cuda", out=None, overrides=None):
    """Run every (variant, seed) that ``out`` does not hold yet, appending
    each record there; returns the JAX script's dict plus ``mode`` and
    ``card``, over every requested pair."""
    tags = str(variants).split(",")
    unknown = [t for t in tags if t not in VARIANTS]
    if unknown:
        raise ValueError(f"unknown variants {unknown}")
    done = read_out(out, lambda rec: (rec["variant"], rec["seed"]),
                    n_px=n_px, mode=mode)
    card = card_or_none(device)
    runners = None
    result = {"mode": mode, "card": card}
    for tag in tags:
        for seed in range(n_seeds):
            rec = done.get((tag, seed))
            if rec is None:
                if runners is None:
                    runners = make_runners(n_px, device)
                rec = probe_pair(runners, n_px, tag, seed, mode, device,
                                 card, overrides)
                if out:
                    with open(out, "a") as fh:
                        fh.write(json.dumps(rec) + "\n")
            print(f"{tag} seed {seed}: viol1={rec['viol1']} "
                  f"viol2={rec['viol2']} evals/px={rec['evals_px']:.0f} "
                  f"wall={rec['wall_s']:.0f}s", flush=True)
            agg = result.setdefault(tag, {"viol1": [], "viol2": [],
                                          "evals_px": [], "wall_s": []})
            for k in agg:
                agg[k].append(rec[k])
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_seeds", type=int, nargs="?", default=2)
    ap.add_argument("n_px", type=int, nargs="?", default=1024)
    ap.add_argument("variants", nargs="?", default="lhs,iid")
    ap.add_argument("--mode", choices=sorted(SEGMENT_ITERS),
                    default="segmented")
    ap.add_argument("--out")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps(probe(args.n_seeds, args.n_px, args.variants,
                           args.mode, args.device, args.out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
