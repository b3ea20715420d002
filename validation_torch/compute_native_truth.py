#!/usr/bin/env python3
"""The sequential C++ engine's nlive-400 truth for the bench cube, from the
port.

The counterpart of ``validation/compute_native_truth.py`` on
``nestfit_tpu_torch``: the in-repo native nested sampler
(``cpp/nestfit_native.cpp``, the MultiNest-architecture CPU baseline,
through ``nestfit_tpu_torch.native``) fits both rungs of the synthetic NH3
bench cube's pixels (1024 px, noise 0.15, cube seed 5, checked against the
artifact's checksum ``3ca4ac945c289ff3`` before any run) at nlive 400,
tol 1.0, with the port's IRDC PPF tables and the joint resolved-placement
spec.  Phase A runs ``--seeds`` engine seeds on the first ``--pixels``
pixels, phase B ``--extra-seeds`` more on the first
``--extra-seed-pixels``; ``--backfill-bestfit`` re-runs records that lack
the best-fit vectors.  Per pixel and seed the record holds ``lnz{n}``,
``lnz{n}_err``, ``ncall{n}`` and ``bestfit{n}`` (rounded to 5 places), the
JAX artifact's schema; the artifact adds ``card`` and ``walls`` (seconds
per ``"pixel/seed"``, both rungs).  The file is written after every run
and resumed from, as the JAX script resumes from its ``OUT``.

It runs on the host: no card, no JAX platform switch.  It never writes
into ``validation/``: ``--out`` defaults to
``validation_torch/native_truth_seed5_port.json``.

``--compare`` fits nothing: :func:`compare` holds ``--out`` against the
JAX artifact (``validation/native_truth_seed5.json``) per pixel, seed and
rung: ``dz`` and ``dz / sigma``, sigma = sqrt(err_port^2 + err_art^2 +
s^2) with ``s`` the artifact's pooled seed scatter of its multi-seed
pixels per rung, floored at 0.3.  The artifact was made with JAX at
float32, where its PPF tables differ from the port's by up to 8.3e-5, so
the engine's trajectories need not match it bit for bit.

Usage: python validation_torch/compute_native_truth.py [--pixels 48]
         [--seeds 1] [--extra-seed-pixels 8] [--extra-seeds 2]
         [--backfill-bestfit] [--out PATH] [--device cuda]
       python validation_torch/compute_native_truth.py --compare
         [--out PATH] [--artifact PATH]
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
from validation_torch.outlier_postmortem import NATIVE, SIGMA_FLOOR, \
    seed_scatter_model  # noqa: E402

OUT = os.path.join(ROOT, "validation_torch", "native_truth_seed5_port.json")
NLIVE = 400
TOL = 1.0
LNZ_THRESH = 11.0
NOISE, BENCH_SEED, N_PIX = 0.15, 5, 1024
CHECKSUM = "3ca4ac945c289ff3"


class Truth:
    """The bench cube, the engine's tables and the artifact being written
    to ``out``."""

    def __init__(self, out=OUT, device="cuda"):
        import torch
        from nestfit_tpu_torch import native
        from nestfit_tpu_torch.priors import get_irdc_priors

        if not native.available():
            raise RuntimeError("native library unavailable")
        self.cube = bench_torch.make_cube(N_PIX, BENCH_SEED, NOISE)
        got = bench_torch.cube_checksum(self.cube)
        if got != CHECKSUM:
            raise ValueError(f"cube checksum {got} is not the artifact's "
                             f"{CHECKSUM}")
        utrans = get_irdc_priors(vsys=0.0, device=device)
        self.ppf = {n: native.bindings.ppf_tables_from_utrans(utrans, n)
                    for n in (1, 2)}
        # the joint placement: the per-dim tables alone drop the minimum
        # separation, so the engine would integrate a wider ncomp-2 prior
        self.plc = native.bindings.placement_spec_from_utrans(utrans)
        if self.plc is None:
            raise RuntimeError("the IRDC priors hold no placement prior")
        self.native = native
        self.out = out
        self.art = {
            "bench_seed": BENCH_SEED,
            "noise": NOISE,
            "n_pix": N_PIX,
            "nlive": NLIVE,
            "tol": TOL,
            "placement": True,
            "cube_checksum": got,
            "records": {},
            "card": bench_torch.card_line()
            if torch.cuda.is_available() else None,
            "walls": {},
        }
        if os.path.exists(out):
            with open(out) as fh:
                prev = json.load(fh)
            if prev.get("cube_checksum") == got \
                    and prev.get("nlive") == NLIVE and prev.get("placement"):
                for k in ("records", "card", "walls"):
                    prev.setdefault(k, self.art[k])
                self.art = prev

    def save(self):
        tmp = self.out + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(self.art, fh, indent=1)
        os.replace(tmp, self.out)

    def run_pixel(self, i, seed, backfill=False):
        """Both rungs of pixel ``i`` at engine seed ``seed``, unless the
        artifact holds them (with its best-fit vectors, on a backfill)."""
        rec = self.art["records"].setdefault(str(i), {"seeds": {}})
        prev_rec = rec["seeds"].get(str(seed))
        if prev_rec is not None and (not backfill or "bestfit2" in prev_rec):
            return
        (xa11, d11), (xa22, d22) = self.cube
        sd = [(xa11, d11[i], NOISE, 1), (xa22, d22[i], NOISE, 2)]
        t0 = time.time()
        out = {}
        for n in (1, 2):
            r = self.native.ns_spectral_ammonia(
                sd, self.ppf[n], ncomp=n, nlive=NLIVE, tol=TOL, seed=seed,
                placement=self.plc)
            out[f"lnz{n}"] = float(r["lnz"])
            out[f"lnz{n}_err"] = float(r["lnz_err"])
            out[f"ncall{n}"] = int(r["ncall"])
            out[f"bestfit{n}"] = np.round(
                np.asarray(r["bestfit"], dtype=float), 5).tolist()
        wall = time.time() - t0
        if prev_rec is not None:
            # a backfill re-runs the same engine and seed: same trajectory
            dz = abs(prev_rec["lnz2"] - out["lnz2"])
            if dz > 1e-6:
                print(f"pixel {i} seed {seed}: backfill lnz2 moved by "
                      f"{dz:.2e} (nondeterministic engine?)", flush=True)
        rec["seeds"][str(seed)] = out
        self.art["walls"][f"{i}/{seed}"] = wall
        print(f"pixel {i} seed {seed}: lnz1={out['lnz1']:.2f} "
              f"lnz2={out['lnz2']:.2f} ({wall:.0f}s)", flush=True)
        self.save()


def run(pixels=48, seeds=1, extra_seed_pixels=8, extra_seeds=2,
        backfill=False, out=OUT, device="cuda"):
    """The JAX script's two phases (and backfill) into ``out``; returns
    the artifact."""
    t = Truth(out, device)
    if backfill:
        for i_str, rec in sorted(t.art["records"].items(),
                                 key=lambda kv: int(kv[0])):
            for seed in sorted(rec["seeds"]):
                t.run_pixel(int(i_str), int(seed), backfill=True)
    # phase A: one seed on the leading sample (selection + agreement)
    for i in range(pixels):
        for seed in range(seeds):
            t.run_pixel(i, seed)
    # phase B: extra seeds on a subsample (seed-scatter error model)
    for i in range(extra_seed_pixels):
        for seed in range(seeds, seeds + extra_seeds):
            t.run_pixel(i, seed)
    t.art["note"] = ("nbest uses the TPU-side null_lnZ at comparison "
                     "time; artifact stores raw lnz only")
    t.save()
    print(f"done: {len(t.art['records'])} pixels in {out}")
    return t.art


def compare(port, artifact):
    """Each (pixel, seed, rung) of ``port`` that ``artifact`` also holds:
    rows of ``dz`` (port minus artifact) and ``dz_sigma``, and a summary
    (their count, median |dz|/sigma, largest |dz|, the scatter ``s`` per
    rung)."""
    if port["cube_checksum"] != artifact["cube_checksum"]:
        raise ValueError("the two artifacts are of different cubes")
    s_model = seed_scatter_model(artifact["records"])
    s = {n: max(s_model[n], SIGMA_FLOOR) for n in (1, 2)}
    rows = []
    for i, rec in sorted(port["records"].items(), key=lambda kv: int(kv[0])):
        ref = artifact["records"].get(i, {}).get("seeds", {})
        for seed, p in sorted(rec["seeds"].items()):
            a = ref.get(seed)
            if a is None:
                continue
            for n in (1, 2):
                dz = p[f"lnz{n}"] - a[f"lnz{n}"]
                sig = float(np.sqrt(p[f"lnz{n}_err"] ** 2
                                    + a[f"lnz{n}_err"] ** 2 + s[n] ** 2))
                rows.append({"pixel": int(i), "seed": int(seed), "rung": n,
                             "lnz_port": p[f"lnz{n}"],
                             "lnz_artifact": a[f"lnz{n}"],
                             "dz": dz, "dz_sigma": dz / sig,
                             "ncall_port": p[f"ncall{n}"],
                             "ncall_artifact": a[f"ncall{n}"]})
    summary = {
        "n": len(rows), "scatter": {str(n): s[n] for n in (1, 2)},
        "abs_dz_sigma_median": float(np.median(
            [abs(r["dz_sigma"]) for r in rows])) if rows else None,
        "abs_dz_max": max((abs(r["dz"]) for r in rows), default=None)}
    return rows, summary


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pixels", type=int, default=48)
    ap.add_argument("--seeds", type=int, default=1)
    ap.add_argument("--extra-seed-pixels", type=int, default=8)
    ap.add_argument("--extra-seeds", type=int, default=2)
    ap.add_argument("--backfill-bestfit", action="store_true",
                    help="re-run existing records to add bestfit "
                         "vectors (deterministic per seed)")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--compare", action="store_true",
                    help="hold --out against --artifact; fit nothing")
    ap.add_argument("--artifact", default=NATIVE)
    args = ap.parse_args(argv)
    if args.compare:
        with open(args.out) as fh:
            port = json.load(fh)
        with open(args.artifact) as fh:
            art = json.load(fh)
        rows, summary = compare(port, art)
        for r in rows:
            print(json.dumps(r))
        print(json.dumps(summary), flush=True)
        return 0
    run(args.pixels, args.seeds, args.extra_seed_pixels, args.extra_seeds,
        args.backfill_bestfit, args.out, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
