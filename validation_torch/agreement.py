#!/usr/bin/env python3
"""The port's evidence records on the native-truth artifact's pixels.

The counterpart of ``validation/tpu_agreement.py`` on ``nestfit_tpu_torch``:
fits exactly the pixels of ``validation/native_truth_seed5.json`` (the
sequential C++ engine's nlive=400 truth) with ``fit_batch`` at the
cube-fit default nlive=100 (``--seeds`` seeds) and the truth-matched
nlive=400 (``--nlive400-seeds`` seeds), both rungs, and writes the
per-pixel evidences and parameter vectors to ``--out`` in the JAX
record's schema: ``runs["nlive<N>/seed<s>"][pixel]`` holds ``lnz<n>``,
``lnz<n>_err``, ``bestfit<n>``, ``map<n>``, ``median<n>`` (the ``p50``
marginal), ``std<n>`` and ``null_lnz``.  The record adds ``mode``,
``segment_iters``, ``card`` (``nvidia-smi``'s name and power limit) and
``run_stats`` (per config and rung: wall, mean evals/px, converged runs
and runs that stopped short of their death budget; padding rows left
out).  It feeds ``outlier_postmortem.py`` and ``selection_sharpness.py``.

The same cube (``make_synth_cube_arrays`` at the artifact's size, noise
and seed, checked against its checksum before any fit), the artifact's
pixels padded to ``--batch`` with the first (padding rows inactive),
``NSConfig(nlive, tol=1.0, init_factor=4)`` and one generator per
(nlive, seed, ncomp), seeded ``1000 * nlive + 10 * seed + ncomp`` (the
JAX key's integer; agreement with the JAX record is statistical).
``--mode segmented`` runs ``segment_iters=250`` (the JAX script's
protocol), ``--mode traced`` ``segment_iters=0`` (``fit_batch``'s
default).  One runner per rung serves every config.

The record is written after every config.  **One deliberate difference
from the JAX script**: when ``--out`` already holds a record of the same
cube, mode and pixels, its finished configs are kept and skipped, so one
mode can be split over several calls.

``--compare`` fits nothing: it holds ``--out``'s nlive=100 seed medians
against a reference record (``--reference``, by default the JAX
package's ``validation/tpu_agreement_seed5.json``) and prints one JSON
line (:func:`compare`).

Usage: python validation_torch/agreement.py --mode segmented|traced
         --out PATH [--seeds 3] [--nlive400-seeds 1] [--batch 64]
         [--device cuda]
       python validation_torch/agreement.py --compare --out PATH
         [--reference PATH]
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
from bench_torch import log  # noqa: E402
from validation_torch.outlier_postmortem import NATIVE, SIGMA_FLOOR  # noqa

TPU_RECORD = os.path.join(ROOT, "validation", "tpu_agreement_seed5.json")
SEGMENT_ITERS = {"segmented": 250, "traced": 0}


def configs(seeds, nlive400_seeds):
    """The JAX script's configs, in its order: ``[(nlive, seed), ...]``."""
    return ([(100, s) for s in range(seeds)]
            + [(400, s) for s in range(nlive400_seeds)])


def tag_of(nlive, seed):
    return f"nlive{nlive}/seed{seed}"


def card_or_none(device):
    """``nvidia-smi``'s name and power limit on the card, None on the
    CPU."""
    import torch

    return bench_torch.card_line() \
        if torch.device(device).type == "cuda" else None


def make_runners(art, pixels, batch, device):
    """The artifact's cube, checked against its checksum, and one
    ``AmmoniaRunner`` per rung over ``pixels`` padded to ``batch`` rows
    with the first: ``(runners, truth)``.  Raises
    ``ValueError`` when the cube is not the artifact's."""
    from nestfit_tpu_torch.priors import get_irdc_priors
    from nestfit_tpu_torch.synth import make_synth_cube_arrays

    noise = art["noise"]
    (xa11, d11), (xa22, d22), truth = make_synth_cube_arrays(
        n_pix=art["n_pix"], noise=noise,
        rng=np.random.default_rng(art["bench_seed"]))
    cube = ((xa11, d11), (xa22, d22))
    got = bench_torch.cube_checksum(cube)
    if got != art["cube_checksum"]:
        raise ValueError(f"cube checksum {got} is not the artifact's "
                         f"{art['cube_checksum']}")
    if len(pixels) > batch:
        raise ValueError(f"{len(pixels)} pixels do not fit a batch of "
                         f"{batch}")
    pad = np.asarray(list(pixels) + [pixels[0]] * (batch - len(pixels)))
    sub = tuple((xa, d[pad]) for xa, d in cube)
    utrans = get_irdc_priors(vsys=0.0, device=device)
    runners = {n: bench_torch.make_runner(sub, n, utrans, device,
                                          noise=noise)
               for n in (1, 2)}
    return runners, truth


def new_record(art, pixels, truth, mode, device):
    return {
        "bench_seed": art["bench_seed"],
        "noise": art["noise"],
        "cube_checksum": art["cube_checksum"],
        "pixels": list(pixels),
        "truth_params": {str(i): np.round(truth[i], 4).tolist()
                         for i in pixels},
        "runs": {},
        "mode": mode,
        "segment_iters": SEGMENT_ITERS[mode],
        "card": card_or_none(device),
        "run_stats": {},
    }


def resumable(out, art, pixels, mode):
    """The record already at ``out`` when it is of the same cube, mode
    and pixels, else None."""
    if not out or not os.path.exists(out):
        return None
    with open(out) as fh:
        old = json.load(fh)
    if (old.get("cube_checksum"), old.get("mode"), old.get("pixels")) != \
            (art["cube_checksum"], mode, list(pixels)):
        return None
    return old


def save(rec, out):
    """Write ``rec`` to ``out`` (its runs in nlive, then seed order)."""
    def order(tag):
        nlive, seed = tag.split("/")
        return int(nlive[len("nlive"):]), int(seed[len("seed"):])

    for key in ("runs", "run_stats"):
        rec[key] = dict(sorted(rec[key].items(),
                               key=lambda kv: order(kv[0])))
    tmp = out + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(rec, fh, indent=1)
    os.replace(tmp, out)


def fit_config(runners, batch, pixels, nlive, seed, mode, device,
               cfg_overrides=None):
    """Both rungs of one config on ``batch`` rows, the first
    ``len(pixels)`` active: ``(records by pixel, stats)``."""
    import torch
    from nestfit_tpu_torch.sampling import NSConfig, fit_batch
    from nestfit_tpu_torch.sampling.results import MARGINAL_COLS

    cfg = NSConfig(nlive=nlive, tol=1.0, init_factor=4,
                   **(cfg_overrides or {}))
    n_active = len(pixels)
    active = np.arange(batch) < n_active
    i_med = MARGINAL_COLS.index("p50")
    rec, stats = {}, {}
    for n in (1, 2):
        gen = torch.Generator(device=device).manual_seed(
            1000 * nlive + 10 * seed + n)
        bench_torch.sync(device)
        t0 = time.perf_counter()
        r = fit_batch(gen, runners[n], batch, cfg,
                      segment_iters=SEGMENT_ITERS[mode], active=active,
                      device=device)
        bench_torch.sync(device)
        wall = time.perf_counter() - t0

        def host(x):
            return x.detach().cpu().numpy()[:n_active]

        lnz, err, null = host(r.lnz), host(r.ns.lnz_err), host(r.null_lnz)
        nc = host(r.ns.ncall).astype(np.int64)
        conv = host(r.ns.converged).astype(bool)
        n_dead = host(r.ns.n_dead)
        bf, mp = host(r.products.bestfit_params), host(r.products.map_params)
        med = host(r.products.marginals)[:, i_med]
        sd = host(r.products.std_params)
        stats[str(n)] = {
            "wall_s": wall, "evals_per_px": float(nc.mean()),
            "converged": int(conv.sum()),
            "short_of_budget": int(np.sum(~conv & (n_dead < r.ns.max_iter))),
            "max_iter": int(r.ns.max_iter),
        }
        log(f"{tag_of(nlive, seed)} ncomp={n}: {wall:.1f}s "
            f"evals/px={nc.mean():.0f} converged {int(conv.sum())}/"
            f"{n_active}")
        for j, i in enumerate(pixels):
            d = rec.setdefault(str(i), {})
            d[f"lnz{n}"] = float(lnz[j])
            d[f"lnz{n}_err"] = float(err[j])
            d[f"bestfit{n}"] = np.round(bf[j], 5).tolist()
            d[f"map{n}"] = np.round(mp[j], 5).tolist()
            d[f"median{n}"] = np.round(med[j], 5).tolist()
            d[f"std{n}"] = np.round(sd[j], 5).tolist()
            if n == 1:
                d["null_lnz"] = float(null[j])
    return rec, stats


def run_agreement(out=None, mode="segmented", plan=((100, 0),), batch=64,
                  device="cuda", pixels=None, native=NATIVE,
                  cfg_overrides=None):
    """Fit every ``(nlive, seed)`` of ``plan`` not already in ``out``'s
    record; write the record after each config when ``out`` is given.
    ``pixels`` defaults to the artifact's; ``cfg_overrides`` adds
    ``NSConfig`` fields (a capped ``max_iter`` for a small CPU run).
    Returns ``(record, tags fitted by this call)``."""
    with open(native) as fh:
        art = json.load(fh)
    all_pix = sorted(int(k) for k in art["records"])
    pixels = all_pix if pixels is None else list(pixels)
    runners, truth = make_runners(art, pixels, batch, device)
    rec = resumable(out, art, pixels, mode)
    if rec is None:
        rec = new_record(art, pixels, truth, mode, device)
    else:
        log(f"resuming {out}: {sorted(rec['runs'])} kept")
    done = []
    for nlive, seed in plan:
        tag = tag_of(nlive, seed)
        if tag in rec["runs"]:
            continue
        rec["runs"][tag], stats = fit_config(
            runners, batch, pixels, nlive, seed, mode, device,
            cfg_overrides)
        stats["card"] = card_or_none(device)
        rec["run_stats"][tag] = stats
        done.append(tag)
        if out:
            save(rec, out)
    return rec, done


def compare(port, ref, nlive=100):
    """Per pixel and rung, ``port``'s nlive-``nlive`` seed median against
    ``ref``'s, in units of the combined sigma: the two median quoted errors
    and both seed scatters in quadrature, floored at 0.3.  Returns a dict:
    the record count, the median and largest ``|dz|/sigma``, the counts
    beyond 4 and beyond 10, and those beyond 10."""
    def side(rec, i, n):
        runs = [r[i] for k, r in rec["runs"].items()
                if k.startswith(f"nlive{nlive}/") and i in r]
        v = [r[f"lnz{n}"] for r in runs]
        return (float(np.median(v)),
                float(np.median([r[f"lnz{n}_err"] for r in runs])),
                float(np.std(v, ddof=1)) if len(v) >= 2 else 0.0, len(v))

    dz, far = [], []
    for i in sorted(set(map(str, port["pixels"]))
                    & set(map(str, ref["pixels"])), key=int):
        for n in (1, 2):
            mp, ep, sp, kp = side(port, i, n)
            mr, er, sr, kr = side(ref, i, n)
            if not (kp and kr):
                continue
            sig = max(float(np.sqrt(ep ** 2 + er ** 2 + sp ** 2 + sr ** 2)),
                      SIGMA_FLOOR)
            z = (mp - mr) / sig
            dz.append(z)
            if abs(z) > 10:
                far.append({"pixel": int(i), "rung": n, "dz_sigma": z,
                            "port": mp, "ref": mr, "sigma": sig})
    a = np.abs(np.asarray(dz))
    return {
        "nlive": nlive, "n_records": int(a.size),
        "dz_sigma_median": float(np.median(a)) if a.size else None,
        "dz_sigma_max": float(a.max()) if a.size else None,
        "n_beyond_4": int(np.sum(a > 4)), "n_beyond_10": int(np.sum(a > 10)),
        "beyond_10": far,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=sorted(SEGMENT_ITERS),
                    default="segmented")
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--nlive400-seeds", type=int, default=1)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--out", required=True, help="agreement record (JSON)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--native", default=NATIVE)
    ap.add_argument("--compare", action="store_true",
                    help="compare --out with --reference; fit nothing")
    ap.add_argument("--reference", default=TPU_RECORD)
    args = ap.parse_args(argv)
    if args.compare:
        with open(args.out) as fh:
            port = json.load(fh)
        with open(args.reference) as fh:
            ref = json.load(fh)
        print(json.dumps(compare(port, ref)), flush=True)
        return 0
    try:
        rec, done = run_agreement(
            args.out, args.mode, configs(args.seeds, args.nlive400_seeds),
            args.batch, args.device, native=args.native)
    except ValueError as exc:
        log(f"agreement: {exc}")
        return 1
    print(f"done: {len(rec['pixels'])} pixels x {len(rec['runs'])} configs "
          f"in {args.out} ({len(done)} fitted now)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
