#!/usr/bin/env python3
"""The regime-economics probes on the port.

The counterpart of ``validation/regime_probes.py`` on
``nestfit_tpu_torch``: two measurements behind the sampler's one-way,
batch-global candidate -> slice regime switch, at the JAX script's sizes
and keys, each comparing the default path with a forced candidate regime
(``cand_min_acc=1e-9``, so the switch never fires).

``revival``  128 px of rung 2 from the bench cube (seed 5, noise 0.15),
    key 5, with the host loop's progress lines on (``sampler._NS_DEBUG``,
    set for the run; ``NESTFIT_NS_DEBUG`` is read only at import): the
    candidate-union acceptance EMA, the in-cube share and the done count
    at every regime check, ``(i, acc_ema, in_cube, done)``.  Prints the
    JAX script's ``RESULT`` line per run; the record holds each run's
    wall, mean calls, mean lnZ, trajectory and progress-line counts.  The
    lines' syncs and host reads slow the loop, so both walls are taken
    with them on, as in the JAX script.
``hetero``   the first 256 valid pixels of the ``tests/data`` cutouts
    (RMS 0.35 K scaled by the primary beam; padded with the first valid
    pixel, inactive, when fewer), ncomp 2, nlive 100, key 11: per-run
    calls under the default switch against the forced candidate regime.
    Prints the JAX script's four summary lines: the share of runs that
    would prefer the candidate regime (more than 10% fewer calls), the
    largest win of a per-run regime split and its share of the default's
    calls, and the lnZ agreement.  Padding rows are left out.

Segmented only (``segment_iters=64``, the JAX script's): the regime
switch, ``cand_min_acc`` and the progress lines exist only in the
segmented host loop; the traced mode runs fixed blocks of candidate
iterations and a masked slice fill, with no switch to force.  Each JAX
key ``random.key(k)`` becomes a generator seeded ``10 * k + 2`` (rung 2).
``--out`` writes the probe's record as JSON; ``card`` is
``nvidia-smi``'s name and power limit.

Usage: python validation_torch/regime_probes.py {revival,hetero}
         [--out PATH] [--device cuda]
"""

import argparse
import contextlib
import io
import json
import os
import re
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench_torch  # noqa: E402
from validation_torch.agreement import card_or_none  # noqa: E402

SEGMENT_ITERS = 64
FORCED_ACC = 1e-9
FIXTURES = os.path.join(ROOT, "tests", "data")
FIXTURE_RMS = 0.35
REVIVAL_ROWS, REVIVAL_KEY = 128, 5
HETERO_ROWS, HETERO_KEY = 256, 11
PREFER_SHARE = 0.1     # a run prefers the candidate regime at 10% fewer calls
# the segmented host loop's four kinds of progress line (sampler._run_nested)
LINES = {
    "cand_seg": re.compile(r"ns-debug: cand seg i=(\d+)->(\d+) R=(\d+) "
                           r"wall=(\d+\.\d\d)s ncall_mean=(\d+)$"),
    "regime": re.compile(r"ns-debug: i=(\d+) mode=cand acc_ema=(\S+) "
                         r"in_cube=(\d\.\d\d) done=(\d+)$"),
    "probe": re.compile(r"ns-debug: probe i=(\d+) R=(\d+) est=(\S+) "
                        r"thresh=(\S+) cand_ready=(True|False)$"),
    "slice_seg": re.compile(r"ns-debug: slice seg i=(\d+)->(\d+) R=(\d+) "
                            r"wall=(\d+\.\d\d)s done=(\d+) "
                            r"ncall_mean=(\d+)$"),
}


def configs(overrides=None):
    """Both regimes' ``NSConfig`` (nlive 100, tol 1.0; ``overrides`` last:
    a toy run's)."""
    from nestfit_tpu_torch.sampling import NSConfig

    kw = {"nlive": 100, "tol": 1.0, **(overrides or {})}
    return {"default": NSConfig(**kw),
            "forced_cand": NSConfig(**kw, cand_min_acc=FORCED_ACC)}


def debug_lines(run):
    """``run()`` with the host loop's progress lines on: ``(its result, the
    lines)``."""
    from nestfit_tpu_torch.sampling import sampler

    buf = io.StringIO()
    old = sampler._NS_DEBUG
    sampler._NS_DEBUG = True
    try:
        with contextlib.redirect_stdout(buf):
            out = run()
    finally:
        sampler._NS_DEBUG = old
    return out, [ln for ln in buf.getvalue().splitlines()
                 if ln.startswith("ns-debug: ")]


def parse_lines(lines):
    """The fields of each progress line by kind; raises ``ValueError`` on a
    line of no kind."""
    out = {k: [] for k in LINES}
    for ln in lines:
        hits = [(k, m) for k, rx in LINES.items() if (m := rx.match(ln))]
        if len(hits) != 1:
            raise ValueError(f"not a progress line: {ln!r}")
        out[hits[0][0]].append(hits[0][1].groups())
    return out


def trajectory(lines):
    """``[(i, acc_ema, in_cube, done), ...]`` of the regime-check lines."""
    return [(int(i), float(acc), float(cube), int(done))
            for i, acc, cube, done in parse_lines(lines)["regime"]]


def line_counts(lines):
    return {k: len(v) for k, v in parse_lines(lines).items()}


def revival(device="cuda", rows=REVIVAL_ROWS, overrides=None):
    """The ``revival`` record: each regime's run of rung 2 on the bench
    cube's first ``rows`` pixels."""
    import torch
    from nestfit_tpu_torch.priors import get_irdc_priors
    from nestfit_tpu_torch.sampling import fit_batch

    cube = bench_torch.make_cube(1024, 5)
    runner = bench_torch.make_runner(
        cube, 2, get_irdc_priors(vsys=0.0, device=device), device,
        rows=rows)
    cfgs = configs(overrides)
    rec = {"probe": "revival", "rows": rows, "nlive": cfgs["default"].nlive,
           "segment_iters": SEGMENT_ITERS, "key": REVIVAL_KEY,
           "card": card_or_none(device), "runs": {}}
    for name in ("forced_cand", "default"):
        gen = torch.Generator(device=device).manual_seed(
            10 * REVIVAL_KEY + 2)
        bench_torch.sync(device)
        t0 = time.perf_counter()
        r, lines = debug_lines(lambda: fit_batch(
            gen, runner, rows, cfgs[name], segment_iters=SEGMENT_ITERS,
            device=device))
        bench_torch.sync(device)
        wall = time.perf_counter() - t0
        print("\n".join(lines), flush=True)
        nc = r.ns.ncall.cpu().numpy().astype(np.int64)
        lnz = r.lnz.cpu().numpy()
        rec["runs"][name] = {
            "wall_s": wall, "ncall_mean": float(nc.mean()),
            "lnz_mean": float(lnz.mean()),
            "converged": int(r.ns.converged.sum()),
            "lines": line_counts(lines),
            "trajectory": trajectory(lines)}
        print(f"RESULT mode={name} wall={wall:.1f}s "
              f"ncall_mean={nc.mean():.0f} lnz_mean={lnz.mean():.2f}",
              flush=True)
    return rec


def fixture_batch(rows):
    """The fixture cutouts' first ``rows`` valid pixels: ``(stack, ix,
    active, valid, max_snr, datas, noises)``."""
    from nestfit_tpu_torch.cube import CubeStack, DataCube, NoiseMap, \
        read_fits

    pb, _ = read_fits(os.path.join(FIXTURES, "pb_cutout.fits"))
    nmap = NoiseMap.from_pbimg(FIXTURE_RMS, pb)
    stack = CubeStack([
        DataCube.from_fits(os.path.join(FIXTURES, f"nh3_{tag}_cutout.fits"),
                           noise_map=nmap, trans_id=tid)
        for tid, tag in ((1, "11"), (2, "22"))])
    datas, noises, nan_mask, max_snr = stack.get_flat_batch()
    valid = np.nonzero(~nan_mask)[0]
    ix = valid[:rows] if valid.size >= rows else np.concatenate(
        [valid, np.full(rows - valid.size, valid[0])])
    active = np.arange(rows) < min(valid.size, rows)
    return stack, ix, active, valid, max_snr, datas, noises


def hetero(device="cuda", rows=HETERO_ROWS, overrides=None):
    """The ``hetero`` record: per-run calls of both regimes on the
    fixture cutouts."""
    import torch
    from nestfit_tpu_torch.models import AmmoniaRunner, ammonia
    from nestfit_tpu_torch.priors import get_irdc_priors
    from nestfit_tpu_torch.sampling import fit_batch

    stack, ix, active, valid, max_snr, datas, noises = fixture_batch(rows)
    snr = (float(np.nanmin(max_snr[valid])), float(np.nanmax(max_snr[valid])))
    print(f"valid={valid.size} R={rows} snr {snr[0]:.1f}..{snr[1]:.1f}",
          flush=True)
    spectra = [ammonia.make_ammonia_spectrum(
        np.asarray(stack.cubes[tid - 1].xarr),
        np.asarray(d[ix], dtype=np.float32),
        np.maximum(nn[ix], 1e-30).astype(np.float32), trans_id=tid,
        device=device)
        for d, nn, tid in ((datas[0], noises[0], 1),
                           (datas[1], noises[1], 2))]
    runner = AmmoniaRunner(tuple(spectra),
                           get_irdc_priors(vsys=0.0, device=device),
                           ncomp=2, device=device)
    cfgs = configs(overrides)
    rec = {"probe": "hetero", "valid": int(valid.size), "rows": rows,
           "active": int(active.sum()), "nlive": cfgs["default"].nlive,
           "segment_iters": SEGMENT_ITERS, "key": HETERO_KEY,
           "snr_range": list(snr), "card": card_or_none(device),
           "runs": {}}
    res = {}
    for name in ("default", "forced_cand"):
        gen = torch.Generator(device=device).manual_seed(
            10 * HETERO_KEY + 2)
        bench_torch.sync(device)
        t0 = time.perf_counter()
        r = fit_batch(gen, runner, rows, cfgs[name],
                      segment_iters=SEGMENT_ITERS, active=active,
                      device=device)
        bench_torch.sync(device)
        wall = time.perf_counter() - t0
        nc = r.ns.ncall.cpu().numpy().astype(np.int64)[active]
        res[name] = (nc, r.lnz.cpu().numpy()[active])
        rec["runs"][name] = {"wall_s": wall, "ncall_mean": float(nc.mean()),
                             "ncall": nc.tolist()}
        print(f"{name}: wall={wall:.1f}s ncall_mean={nc.mean():.0f}",
              flush=True)
    nc_a, lnz_a = res["default"]
    nc_c, lnz_c = res["forced_cand"]
    sav = nc_a - nc_c
    win = int(np.maximum(sav, 0).sum())
    dz = lnz_a - lnz_c
    rec.update({
        "frac_prefer_cand": float((sav > PREFER_SHARE * nc_a).mean()),
        "max_split_win_evals": win,
        "max_split_win_pct": float(win / nc_a.sum() * 100),
        "lnz_diff_median": float(np.median(dz)),
        "lnz_diff_max_abs": float(np.abs(dz).max())})
    print(f"frac preferring cand (>10% fewer evals): "
          f"{rec['frac_prefer_cand']:.3f}")
    print(f"max split win: {win} evals "
          f"({rec['max_split_win_pct']:.1f}% of default)")
    print(f"lnz agreement: median {np.median(dz):+.2f} "
          f"max|.| {np.abs(dz).max():.2f}", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("probe", choices=("revival", "hetero"))
    ap.add_argument("--out")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rec = {"revival": revival, "hetero": hetero}[args.probe](args.device)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(rec, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
