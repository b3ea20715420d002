#!/usr/bin/env python3
"""Headline benchmark of the PyTorch/CUDA port: NH3 ladder fits per
second on one NVIDIA card.

``bench.py``'s protocol on ``nestfit_tpu_torch``: a synthetic NH3
(1,1)+(2,2) cube (``BENCH_PIXELS`` px, noise 0.15 K, drawn from cube seed
``BENCH_SEED``), the IRDC priors, ``NSConfig(nlive=BENCH_NLIVE, tol=1.0,
init_factor=BENCH_INIT_FACTOR)``, rung ncomp 1 then rung ncomp 2 on every
pixel, each rung followed by a second pass: the floor violators (lnZ more
than 8 nats below the previous rung, or below the null model on rung 1)
and the boundary-band rows (|gain - 11| <= ``BENCH_BOUNDARY_BAND`` nats)
refit at 2x nlive in one batch 128 rows wide (32 when few rows qualify),
at most two rounds.  One fit is one pixel through both rungs.

Protocol: ``sampling.aot.compile_plan`` of both rungs and of the second
pass's runners, a warm-up ladder from generator seed 0, then one timed
ladder per seed of ``BENCH_TIMED_SEEDS`` on a fresh generator each.
``value`` is the median ladder-fits/s over the completed timed ladders;
``timed_clean`` is true when every requested seed completed.  A ladder
skips a rung whose estimated cost no longer fits the budget.

Sampler mode: ``BENCH_SEGMENT_ITERS`` > 0 (default 250) runs the
segmented host loop, 0 the traced mode (CUDA graphs).

Gates, with ``bench.py``'s thresholds; a failed gate reports ``value: 0``:

(i)   selection, on every timed ladder: nbest >= 1 on >= 90% of the
      pixels, nbest = 2 on >= 30%, >= 98% of the runs converged, and a
      run that did not converge spent its whole death budget;
(ii)  native truth, on every timed ladder: lnZ against the committed
      nlive-400 native-engine artifact (``validation/native_truth_seed5
      .json``): |dz|/sigma median < 4, nbest agreement >= 0.7, at most
      15% of the records beyond 10 sigma, MAP parameters within a median
      of 1 posterior std.  It must hold at the default cube (1024 px,
      cube seed 5); at another cube it is recorded as skipped;
(iii) engine agreement, on the first timed ladder: the sequential C++
      engine (``nestfit_tpu_torch.native``) fits ``BENCH_CPU_PIXELS``
      pixels (boxed at ``BENCH_CPU_BUDGET_S`` s): |dz|/sigma median < 6,
      at most max(1, n/3) records beyond 10 sigma, the largest < 50.
      Its single-core rate is the baseline of ``vs_baseline``.

Output: one JSON line, the last on stdout; logs go to stderr.  Without a
card, or when a kernel or the engine fails to build, the line holds
``error`` and ``value: 0`` and the exit code is 1.  ``BENCH_BUDGET_S``
(default 1100 s, so that one run fits a 1,300-s job) bounds the run: a
deadline ``BENCH_DEADLINE_LEAD_S`` before it prints the best partial
line.  ``--fast``: 128 px and a 900-s budget unless the environment says
otherwise.
"""

import dataclasses
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

NOISE = 0.15
THRESH = 11.0            # the ladder's Bayes-factor rule, nats
MODE_LOSS_MARGIN = 8.0   # the nested-model evidence floor's slack, nats
R_BAND, R_SMALL = 128, 32
# gate (i)
SEL_GE1, SEL_EQ2, SEL_CONV = 0.90, 0.30, 0.98
# gate (ii); bench.py gates only on an artifact of >= 16 records
NT_DZ_MEDIAN, NT_AGREE, NT_FRAC_GT10, NT_MAP_DZ, NT_MIN = 4.0, 0.7, 0.15, \
    1.0, 16
# gate (iii)
ENG_DZ_MEDIAN, ENG_DZ_MAX, ENG_OUTLIER = 6.0, 50.0, 10.0
BASELINE_RESERVE_S = 180.0   # budget held back for the engine baseline
TIMED_FLOOR_S = 105.0        # least budget a timed ladder starts with
FIRST_RUNG_EST_S = 75.0      # a rung's estimate before any rung is timed
DEFAULT_CUBE = (1024, 5)     # the artifact's cube: pixels, cube seed
ARTIFACT = Path(__file__).resolve().parent / "validation" / \
    "native_truth_seed5.json"

RESULT = {
    "metric": "spectra_fit_per_sec_per_chip",
    "value": 0.0,
    "unit": "ladder-fits/s/chip",
    "vs_baseline": 0.0,
    "timed_clean": False,
    "partial": True,
}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


@dataclasses.dataclass(frozen=True)
class Settings:
    """The workload and budget, from ``BENCH_*`` environment variables."""

    n_pix: int = 1024
    nlive: int = 100
    seed: int = 5                 # the cube's seed
    init_factor: int = 4
    segment_iters: int = 250
    band_nats: float = 6.0
    cpu_pixels: int = 3
    cpu_budget_s: float = 150.0
    deadline_lead_s: float = 45.0
    budget_s: float = 1100.0
    timed_seeds: tuple = (5, 6, 7)

    @classmethod
    def from_env(cls, argv=(), environ=None):
        env = os.environ if environ is None else environ
        fast = "--fast" in argv

        def get(name, default):
            return env.get(f"BENCH_{name}", default)

        return cls(
            n_pix=int(get("PIXELS", "128" if fast else "1024")),
            nlive=int(get("NLIVE", "100")),
            seed=int(get("SEED", "5")),
            init_factor=int(get("INIT_FACTOR", "4")),
            segment_iters=int(get("SEGMENT_ITERS", "250")),
            band_nats=float(get("BOUNDARY_BAND", "6")),
            cpu_pixels=int(get("CPU_PIXELS", "3")),
            cpu_budget_s=float(get("CPU_BUDGET_S", "150")),
            deadline_lead_s=float(get("DEADLINE_LEAD_S", "45")),
            budget_s=float(get("BUDGET_S", "900" if fast else "1100")),
            timed_seeds=tuple(int(s) for s in
                              get("TIMED_SEEDS", "5,6,7").split(",")),
        )

    @property
    def mode(self) -> str:
        return "segmented" if self.segment_iters > 0 else "traced"


class Clock:
    """The run's budget, from its start."""

    def __init__(self, budget_s: float):
        self.budget_s = budget_s
        self.t0 = time.perf_counter()

    def remaining(self) -> float:
        return self.budget_s - (time.perf_counter() - self.t0)


def sync(device):
    """Wait for the device before a clock read."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _numpy(x):
    """A NumPy array of a tensor (on any device) or an array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# ---------------------------------------------------------------------------
# workload


def make_cube(n_pix, seed, noise=NOISE):
    """The synthetic NH3 cube ``((xa11, d11), (xa22, d22))``."""
    from nestfit_tpu_torch.synth import make_synth_cube_arrays

    cube11, cube22, _ = make_synth_cube_arrays(
        n_pix=n_pix, noise=noise, rng=np.random.default_rng(seed))
    return cube11, cube22


def cube_checksum(cube) -> str:
    """The artifact's checksum of a cube: SHA-256 of both data arrays as
    float32, first 16 hex digits."""
    h = hashlib.sha256()
    for _xa, d in cube:
        h.update(np.ascontiguousarray(d, dtype=np.float32).tobytes())
    return h.hexdigest()[:16]


def make_runner(cube, ncomp, utrans, device, rows=None, noise=NOISE):
    """An ``AmmoniaRunner`` over the cube's pixels (``rows``: the first
    that many, the shape of a refit batch)."""
    from nestfit_tpu_torch.models import AmmoniaRunner, ammonia

    spectra = []
    for tid, (xa, d) in enumerate(cube, start=1):
        d = d if rows is None else d[:rows]
        spectra.append(ammonia.make_ammonia_spectrum(
            xa, d, np.full(d.shape[0], noise), trans_id=tid, device=device))
    return AmmoniaRunner(spectra, utrans, ncomp=ncomp, device=device)


@dataclasses.dataclass
class Setup:
    """What every ladder of one run shares: the cube, the config, one
    runner per rung over every pixel and one per (rung, refit width)."""

    cube: tuple
    cfg: object                  # NSConfig of the rungs
    runners: dict                # ncomp -> runner
    band_runners: dict           # (ncomp, width) -> runner
    r_band: int
    r_small: int
    band_nats: float
    segment_iters: int
    device: str
    noise: float = NOISE

    @property
    def n_pix(self) -> int:
        return self.cube[0][1].shape[0]

    def band_cfg(self, ncomp):
        """The second pass's config: 2x nlive at the rung's death budget,
        so that its rows merge into the rung's record."""
        ndim = self.runners[ncomp].ndim
        return dataclasses.replace(
            self.cfg, nlive=2 * self.cfg.nlive,
            max_iter=self.cfg.resolved(ndim).max_iter)


def make_setup(cube, cfg, segment_iters, band_nats, device,
               r_band=R_BAND, r_small=R_SMALL, noise=NOISE):
    """The runners of both rungs and of the second pass's widths."""
    from nestfit_tpu_torch.priors import get_irdc_priors

    n_pix = cube[0][1].shape[0]
    r_band, r_small = min(r_band, n_pix), min(r_small, n_pix)
    utrans = get_irdc_priors(vsys=0.0, device=device)
    runners = {n: make_runner(cube, n, utrans, device, noise=noise)
               for n in (1, 2)}
    band = {(n, w): make_runner(cube, n, utrans, device, rows=w, noise=noise)
            for n in (1, 2) for w in {r_band, r_small}}
    return Setup(cube, cfg, runners, band, r_band, r_small, band_nats,
                 segment_iters, device, noise)


def precompile(setup, verbose=log):
    """``aot.compile_plan`` of both rungs, then the 128-row and the
    32-row refit runners; the report without its per-task records.

    In the traced mode the second pass fits ``with_data`` copies of the
    refit runners, each likelihood a program of its own, so a refit
    runner's own traced program would never run: its plan is built in
    the segmented mode, which holds only the build and warm-up tasks."""
    from nestfit_tpu_torch.sampling import aot

    seg = setup.segment_iters
    plan = []
    for n in (1, 2):
        plan += aot.build_plan(setup.runners[n], setup.n_pix, setup.cfg,
                               segment_iters=seg, device=setup.device)
    band_seg = seg if seg > 0 else Settings.segment_iters
    for w, label in ((setup.r_band, "band"), (setup.r_small, "band_s")):
        for n in (1, 2):
            plan += aot.build_plan(setup.band_runners[n, w], w,
                                   setup.band_cfg(n), label=f"{label}{n}",
                                   segment_iters=band_seg,
                                   device=setup.device)
    report = aot.compile_plan(plan, verbose=verbose)
    report.pop("programs", None)
    return report


# ---------------------------------------------------------------------------
# the second pass: row selection and merge bookkeeping (NumPy only)


def refit_rows(lnz, floor, attempt, band_nats, r_band,
               margin=MODE_LOSS_MARGIN):
    """The rows of second-pass round ``attempt``: ``(rows, bad,
    n_floor)``.  Round 0 takes the floor violators (``lnz < floor -
    margin``) first, then the boundary band (``|gain - 11| <=
    band_nats`` above the floor) nearest the 11-nat rule first, at most
    ``r_band`` rows; round 1 the floor violators still left."""
    bad = np.flatnonzero(lnz < floor - margin)
    if attempt == 0:
        gain = lnz - floor
        if band_nats > 0:
            band = np.flatnonzero((np.abs(gain - THRESH) <= band_nats)
                                  & (lnz >= floor - margin))
            band = band[np.argsort(np.abs(gain[band] - THRESH))]
        else:
            band = np.empty(0, dtype=np.int64)
        return np.concatenate([bad, band])[:r_band], bad, bad.size
    rows = bad[:r_band]
    return rows, bad, rows.size


def refit_width(n_rows, r_band, r_small):
    """The refit batch's width: ``r_small`` when the rows fit in it."""
    return r_small if n_rows <= r_small else r_band


def merge_choice(rows, bad, lnz, lnz_r, nc_old, nc_new):
    """Which refit records replace which rows: ``(dst, src, extra)``.

    One winner per destination (the better refit); a floor row keeps the
    better of its old and new record, a band row takes the new record
    (decided before the outcome).  ``extra`` counts the likelihood calls
    of every record that is thrown away: the replaced rows' old calls
    (``nc_old``, per pixel) and the discarded refits' (``nc_new``, per
    refit row)."""
    bad_set = set(np.asarray(bad).tolist())
    best = {}
    for j, dest in enumerate(np.asarray(rows).tolist()):
        if dest not in best or lnz_r[j] > lnz_r[best[dest]]:
            best[dest] = j
    dst, src = [], []
    for dest, j in best.items():
        if dest in bad_set and not lnz_r[j] > lnz[dest]:
            continue
        dst.append(dest)
        src.append(j)
    dst = np.asarray(dst, dtype=np.int64)
    src = np.asarray(src, dtype=np.int64)
    taken = set(src.tolist())
    extra = int(np.asarray(nc_old, dtype=np.int64)[dst].sum()) + int(sum(
        int(nc_new[j]) for j in range(len(rows)) if j not in taken))
    return dst, src, extra


# ---------------------------------------------------------------------------
# the ladder


def _fit(setup, gen, runner, n_runs, cfg, stats, active=None):
    """``fit_batch`` in the run's mode; ``stats`` collects the traced
    mode's ``graphs.last_stats``."""
    from nestfit_tpu_torch.sampling import fit_batch, graphs

    graphs.last_stats = graphs.TracedStats()
    fit = fit_batch(gen, runner, n_runs, cfg,
                    segment_iters=setup.segment_iters, active=active,
                    device=setup.device)
    stats.append(graphs.last_stats)
    return fit


def second_pass(setup, gen, n, fit, lnz, floor, stats):
    """The combined mode-loss and boundary refinement after rung ``n``:
    up to two rounds of one refit batch at 2x nlive.  Each batch fits a
    ``with_data`` copy of the refit runner on its rows (padding rows
    repeat the first and are born done).  Returns ``(fit, lnz, extra,
    rounds, still)``: the merged record, its lnZ, the likelihood calls of
    the records thrown away, one dict per round, and the floor violators
    left."""
    import torch
    from nestfit_tpu_torch.sampling import align_fit_meta, merge_fit_rows

    extra, rounds = 0, []
    n_bad0 = 0
    for attempt in range(2):
        rows, bad, n_floor = refit_rows(lnz, floor, attempt,
                                        setup.band_nats, setup.r_band)
        if attempt == 0:
            n_bad0 = bad.size
        if rows.size == 0:
            break
        sync(setup.device)
        t0 = time.perf_counter()
        w = refit_width(rows.size, setup.r_band, setup.r_small)
        pad = np.concatenate([rows, np.full(w - rows.size, rows[0])])
        data = tuple(
            (torch.as_tensor(d[pad], dtype=torch.float32,
                             device=setup.device),
             torch.full((w,), setup.noise, dtype=torch.float32,
                        device=setup.device))
            for _xa, d in setup.cube)
        runner = setup.band_runners[n, w].with_data(data)
        fit_r = _fit(setup, gen, runner, w, setup.band_cfg(n), stats,
                     active=np.arange(w) < rows.size)
        lnz_r = _numpy(fit_r.lnz)[: rows.size]
        dst, src, ext = merge_choice(
            rows, bad, lnz, lnz_r, _numpy(fit.ns.ncall),
            _numpy(fit_r.ns.ncall)[: rows.size])
        extra += ext
        if dst.size:
            fit = merge_fit_rows(fit, align_fit_meta(fit_r, fit), dst, src,
                                 setup.n_pix, w)
            lnz = lnz.copy()
            lnz[dst] = lnz_r[src]
        sync(setup.device)
        rounds.append({
            "ncomp": n, "round": attempt + 1, "rows": int(rows.size),
            "floor_rows": int(min(n_floor, rows.size)), "width": int(w),
            "replaced": int(dst.size),
            "wall_s": time.perf_counter() - t0})
        log(f"bench: second pass {attempt + 1} ncomp={n}: "
            f"{min(n_floor, rows.size)} floor + "
            f"{rows.size - min(n_floor, rows.size)} boundary rows re-fit at "
            f"nlive={2 * setup.cfg.nlive} (R={w}); {dst.size} records "
            "replaced")
    still = int(np.sum(lnz < floor - MODE_LOSS_MARGIN))
    if n_bad0:
        log(f"bench: mode-loss ncomp={n}: {n_bad0} first-pass floor "
            f"violations, {still} remain after refinement")
    return fit, lnz, extra, rounds, still


def run_ladder(setup, gen, tag="", clock=None, reserve=None):
    """Both rungs, each with its second pass, from generator ``gen``.
    With ``reserve`` set, a rung whose estimated cost (8x the longest
    rung of this ladder so far) no longer fits ``clock``'s budget less
    ``reserve`` is skipped, and the ladder returns what completed.

    Returns a dict: ``fits`` and ``walls`` by ncomp, ``extra`` (calls of
    thrown-away records), ``second_pass`` (its rounds),
    ``mode_loss_remaining`` by ncomp and ``traced`` (the summed
    ``graphs.TracedStats``)."""
    from nestfit_tpu_torch.sampling import graphs

    fits, walls, extra, rounds, mlr, stats = {}, {}, 0, [], {}, []
    prev = None
    for n in (1, 2):
        if reserve is not None:
            est = 8.0 * max(walls.values()) if walls else FIRST_RUNG_EST_S
            if clock.remaining() - reserve < est:
                log(f"bench: {tag} aborted before ncomp={n} (budget "
                    f"{clock.remaining():.0f}s left, est {est:.0f}s + "
                    f"reserve {reserve:.0f}s)")
                break
        sync(setup.device)
        t0 = time.perf_counter()
        fit = _fit(setup, gen, setup.runners[n], setup.n_pix, setup.cfg,
                   stats)
        lnz = _numpy(fit.lnz)
        floor = _numpy(fit.null_lnz) if n == 1 else prev
        fit, lnz, ext, r_rounds, mlr[n] = second_pass(
            setup, gen, n, fit, lnz, floor, stats)
        sync(setup.device)
        walls[n] = time.perf_counter() - t0
        extra += ext
        rounds += r_rounds
        prev = lnz
        fits[n] = fit
        nc = _numpy(fit.ns.ncall).astype(np.int64)
        log(f"bench: {tag} ncomp={n} rung {walls[n]:.1f}s "
            f"evals/px={nc.mean() + ext / setup.n_pix:.0f} "
            f"deaths/px={_numpy(fit.ns.n_dead).mean():.0f}")
    return {"fits": fits, "walls": walls, "extra": extra,
            "second_pass": rounds, "mode_loss_remaining": mlr,
            "traced": sum(stats, graphs.TracedStats())}


# ---------------------------------------------------------------------------
# scoring and gates


def nbest_of(lnz1, lnz2, null):
    """The ladder's decision: 0, 1 or 2 components."""
    return np.where(lnz1 - null < THRESH, 0,
                    np.where(lnz2 - lnz1 < THRESH, 1, 2))


def selection_gate(lnz1, lnz2, null, converged, short_of_budget,
                   mode_loss_remaining):
    """Gate (i): ``(nbest, gates, ok)``.  ``converged`` marks the pixels
    whose runs converged on both rungs, ``short_of_budget`` the pixels
    with a run that neither converged nor spent its death budget (a
    stalled run, which fails the gate)."""
    nbest = nbest_of(lnz1, lnz2, null)
    conv = np.asarray(converged)
    frac_ge1 = float((nbest >= 1).mean())
    frac_eq2 = float((nbest == 2).mean())
    n_short = int(np.sum(short_of_budget))
    gates = {
        "converged_frac": float(conv.mean()),
        "nbest_ge1_frac": frac_ge1,
        "nbest_eq2_frac": frac_eq2,
        "mode_loss_remaining": {str(k): int(v) for k, v in
                                sorted(mode_loss_remaining.items())},
    }
    n0 = np.flatnonzero(nbest == 0)
    if n0.size:
        m0 = np.sort(lnz1[n0] - null[n0])
        gates["nbest0_margins"] = np.round(m0, 2).tolist()[:32]
    gates["unconverged_short_of_budget"] = n_short
    ok = (frac_ge1 >= SEL_GE1 and frac_eq2 >= SEL_EQ2
          and conv.mean() >= SEL_CONV and n_short == 0)
    return nbest, gates, bool(ok)


def score_ladder(setup, lad, elapsed):
    """Fold a completed ladder into NumPy: its rate, evals per pixel,
    gate (i) and what gates (ii) and (iii) read.  The fits are left
    behind."""
    r1, r2 = lad["fits"][1], lad["fits"][2]
    lnz1, lnz2 = _numpy(r1.lnz), _numpy(r2.lnz)
    null = _numpy(r1.null_lnz)
    conv, short = True, False
    for r in (r1, r2):
        c = _numpy(r.ns.converged).astype(bool)
        conv = conv & c
        short = short | (~c & (_numpy(r.ns.n_dead) < r.ns.max_iter))
    nbest, gates, ok = selection_gate(lnz1, lnz2, null, conv, short,
                                      lad["mode_loss_remaining"])
    n_pix = setup.n_pix
    evals = float(_numpy(r1.ns.ncall).astype(np.int64).mean()
                  + _numpy(r2.ns.ncall).astype(np.int64).mean()
                  + lad["extra"] / n_pix)
    fits_per_sec = n_pix / elapsed
    log(f"bench: {n_pix} ladder fits in {elapsed:.2f}s -> "
        f"{fits_per_sec:.1f} fits/s/chip; converged="
        f"{gates['converged_frac'] * 100:.1f}% likelihood evals/pixel="
        f"{evals:.0f} nbest histogram="
        f"{np.bincount(nbest, minlength=3).tolist()}; selection gate "
        f"{'PASS' if ok else 'FAIL'}")
    from types import SimpleNamespace

    # what gate (ii) reads of the fits
    fits = tuple(SimpleNamespace(products=SimpleNamespace(
        bestfit_params=_numpy(r.products.bestfit_params),
        std_params=_numpy(r.products.std_params))) for r in (r1, r2))
    return {
        "fits_per_sec": fits_per_sec, "evals_per_pixel": evals,
        "gates": gates, "ok_selection": ok,
        "arrays": {"lnz1": lnz1, "lnz2": lnz2, "null": null,
                   "nbest": nbest, "err1": _numpy(r1.ns.lnz_err),
                   "err2": _numpy(r2.ns.lnz_err), "fits": fits},
    }


def native_truth_comparison(d11, d22, lnz1, lnz2, null, nbest, fits=None,
                            path=ARTIFACT):
    """Gate (ii)'s numbers: ``bench.py``'s comparison against the
    committed nlive-400 native-engine artifact (read with ``json`` and
    NumPy only), the same dict.  ``fits`` is ``(rung 1, rung 2)``, each
    with ``products.bestfit_params`` and ``products.std_params`` (tensors
    or arrays), for the MAP-parameter agreement.

    Where ``bench.py`` returns ``{}`` (no artifact, another cube, an
    artifact without the placement prior, no records) this returns
    ``{"native400": "skipped: <why>"}``."""
    try:
        with open(path) as fh:
            art = json.load(fh)
    except (OSError, ValueError) as exc:
        return {"native400": f"skipped: no artifact ({exc})"}
    if art.get("cube_checksum") != cube_checksum(((None, d11), (None, d22))):
        return {"native400": "skipped: cube differs"}
    if not art.get("placement"):
        return {"native400": "skipped: artifact predates the placement "
                             "prior"}
    recs = art.get("records", {})
    if not recs:
        return {"native400": "skipped: no records"}

    # the engine's seed-to-seed scatter, pooled over its multi-seed pixels
    scat = {1: [], 2: []}
    for rec in recs.values():
        seeds = list(rec["seeds"].values())
        if len(seeds) >= 2:
            for n in (1, 2):
                scat[n].append(np.std([s[f"lnz{n}"] for s in seeds],
                                      ddof=1))
    s_model = {n: float(np.median(scat[n])) if scat[n] else 0.0
               for n in (1, 2)}

    def native(seeds):
        nat = {n: float(np.median([s[f"lnz{n}"] for s in seeds]))
               for n in (1, 2)}
        return nat, (0 if nat[1] - null[i] < THRESH else
                     (1 if nat[2] - nat[1] < THRESH else 2))

    dz, sel_pairs, dz21 = [], [], []
    for key, rec in recs.items():
        i = int(key)
        if i >= lnz1.shape[0]:
            continue
        seeds = list(rec["seeds"].values())
        nat, nat_nbest = native(seeds)
        nat_err = {n: float(np.median([s[f"lnz{n}_err"] for s in seeds]))
                   for n in (1, 2)}
        for n, port in ((1, lnz1), (2, lnz2)):
            sig = max(float(np.sqrt(nat_err[n] ** 2 + s_model[n] ** 2)),
                      0.3)
            dz.append((float(port[i]) - nat[n]) / sig)
        sel_pairs.append((int(nbest[i]), nat_nbest))
        dz21.append(float(lnz2[i] - lnz1[i]) - (nat[2] - nat[1]))

    # MAP parameters against the engine's, in posterior stds, where both
    # select at least that rung's model
    map_dz = []
    if fits is not None:
        for key, rec in recs.items():
            i = int(key)
            if i >= lnz1.shape[0]:
                continue
            seeds = list(rec["seeds"].values())
            _nat, nat_nbest = native(seeds)
            for n, fit in ((1, fits[0]), (2, fits[1])):
                bf_nat = next((s.get(f"bestfit{n}") for s in seeds
                               if s.get(f"bestfit{n}")), None)
                if bf_nat is None or int(nbest[i]) < n or nat_nbest < n:
                    continue
                bf = _numpy(fit.products.bestfit_params)[i]
                sd = _numpy(fit.products.std_params)[i]
                bf_nat = np.asarray(bf_nat, dtype=float)
                ok = sd > 1e-6    # skip constant (orth) rows
                map_dz.extend(
                    (np.abs(bf - bf_nat) / np.maximum(sd, 1e-6))[ok]
                    .tolist())

    dz = np.asarray(dz)
    agree = np.mean([a == b for a, b in sel_pairs])
    out = {
        "native400_n_records": int(dz.size),
        "native400_dz_sigma_median": float(np.median(np.abs(dz))),
        "native400_dz_sigma_max": float(np.max(np.abs(dz))),
        "native400_seed_scatter_lnz1": round(s_model[1], 3),
        "native400_seed_scatter_lnz2": round(s_model[2], 3),
        "native400_nbest_agree_frac": float(agree),
        "native400_dz_frac_gt10": float(np.mean(np.abs(dz) > 10.0)),
        "native400_n_sel": len(sel_pairs),
        "native400_dz21_median": float(np.median(dz21)),
    }
    if map_dz:
        out["map_dz_n"] = len(map_dz)
        out["map_dz_median"] = float(np.median(map_dz))
        out["map_dz_p90"] = float(np.quantile(map_dz, 0.9))
    log(f"bench: native nlive=400 truth: n={dz.size} records, |dz|/sigma "
        f"median {out['native400_dz_sigma_median']:.2f} max "
        f"{out['native400_dz_sigma_max']:.2f}; nbest agreement {agree:.2f} "
        f"on {len(sel_pairs)} px; MAP |dtheta|/sigma median "
        f"{out.get('map_dz_median', float('nan')):.3f}")
    return out


def gate_native(sc, cube, required):
    """Gate (ii) on a scored ladder (:func:`score_ladder`): folds the
    comparison into its gates and sets its ``ok_native``."""
    a = sc["arrays"]
    nt = native_truth_comparison(cube[0][1], cube[1][1], a["lnz1"],
                                 a["lnz2"], a["null"], a["nbest"],
                                 fits=a["fits"])
    sc["gates"].update(nt)
    sc["ok_native"] = native_gate(nt, required)
    log(f"bench: native-truth gate {'PASS' if sc['ok_native'] else 'FAIL'}"
        + (f" ({nt['native400']})" if "native400" in nt else ""))
    return sc["ok_native"]


def native_gate(nt, required):
    """Gate (ii) on :func:`native_truth_comparison`'s dict.  A skipped
    comparison fails where it is ``required`` (the default cube)."""
    if "native400" in nt:
        return not required
    if nt["native400_n_records"] < NT_MIN:
        return True
    ok = (nt["native400_dz_sigma_median"] < NT_DZ_MEDIAN
          and nt["native400_nbest_agree_frac"] >= NT_AGREE
          and nt["native400_dz_frac_gt10"] <= NT_FRAC_GT10)
    if nt.get("map_dz_n", 0) >= NT_MIN:
        ok = ok and nt["map_dz_median"] < NT_MAP_DZ
    return bool(ok)


def engine_baseline(cube, utrans, nlive, rung1, rung2, n_sample, box_s,
                    clock, noise=NOISE):
    """The sequential C++ engine's ladder on the first ``n_sample``
    pixels, one core, each run boxed to what is left of ``box_s`` and of
    the budget.  ``rung1``/``rung2`` are the port's ``(lnz, lnz_err)``.
    Returns ``(ladder-fits/s, agreement records)``; raises when the
    engine does not build or no pixel finishes."""
    from nestfit_tpu_torch import native

    if clock.remaining() < 45:
        raise RuntimeError(f"budget too tight for the engine baseline "
                           f"({clock.remaining():.0f}s left)")
    box_s = min(box_s, max(clock.remaining() - 30, 30))
    (xa11, d11), (xa22, d22) = cube
    ppf = {n: native.ppf_tables_from_utrans(utrans, n) for n in (1, 2)}
    plc = native.placement_spec_from_utrans(utrans)
    agree, done = [], 0
    t0 = time.perf_counter()

    def wall_left():
        return min(box_s - (time.perf_counter() - t0),
                   clock.remaining() - 25)

    for i in range(n_sample):
        spec = [(xa11, d11[i], noise, 1), (xa22, d22[i], noise, 2)]
        res = {}
        for n in (1, 2):
            left = wall_left()
            if left <= 5:
                break
            res[n] = native.ns_spectral_ammonia(
                spec, ppf[n], ncomp=n, nlive=nlive, tol=1.0, seed=i,
                placement=plc, max_wall_s=left)
            if res[n]["truncated"]:
                break
        if len(res) < 2 or res[2]["truncated"] or res[1]["truncated"]:
            log(f"bench: engine baseline pixel {i} truncated by the wall "
                "box; dropped")
            break
        done += 1
        for n, (lnz, err) in ((1, rung1), (2, rung2)):
            sig = max(float(np.hypot(res[n]["lnz_err"], err[i])), 0.3)
            agree.append({"pixel": i,
                          "dz_sigma": (float(lnz[i]) - res[n]["lnz"]) / sig})
        if time.perf_counter() - t0 > box_s:
            break
    dt = time.perf_counter() - t0
    if done == 0:
        raise RuntimeError("no engine baseline pixel finished in its box")
    return done / dt, agree


def engine_gate(agree):
    """Gate (iii): ``(gates, ok)``: |dz|/sigma median < 6, at most
    max(1, n/3) records beyond 10 sigma, every record < 50 sigma."""
    dz = np.abs(np.array([a["dz_sigma"] for a in agree]))
    n_out = int(np.sum(dz > ENG_OUTLIER))
    gates = {"lnz_dz_sigma_median": float(np.median(dz)),
             "lnz_dz_sigma_max": float(np.max(dz)),
             "lnz_dz_frac_gt10": n_out / len(dz),
             "lnz_dz_n": len(dz)}
    ok = bool(np.median(dz) < ENG_DZ_MEDIAN
              and n_out <= max(1, len(dz) // 3)
              and np.max(dz) < ENG_DZ_MAX)
    log(f"bench: lnZ-agreement gate {'PASS' if ok else 'FAIL'} (|dz|/sigma "
        f"median {gates['lnz_dz_sigma_median']:.2f}, frac>10 "
        f"{gates['lnz_dz_frac_gt10']:.2f}, max "
        f"{gates['lnz_dz_sigma_max']:.2f}, n={len(dz)})")
    return gates, ok


# ---------------------------------------------------------------------------
# main


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def kernel_counters():
    from nestfit_tpu_torch.ops import fused, tables

    return {"hf_chi2_fused": fused.hf_chi2_fused,
            "table_lerp": tables.table_lerp,
            "tapered_invert": tables.tapered_invert}


def main(argv=(), environ=None):
    """Run the bench on the card; fills and returns ``RESULT``."""
    s = Settings.from_env(argv, environ)
    clock = Clock(s.budget_s)
    RESULT.update({"mode": s.mode, "segment_iters": s.segment_iters})
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: the bench "
                           "measures the card and has no CPU fallback")
    from nestfit_tpu_torch.ops import _build
    from nestfit_tpu_torch.sampling import NSConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    RESULT["card"] = card_line()
    log(f"bench: {torch.cuda.get_device_name(0)} ({RESULT['card']}), "
        f"torch {torch.__version__} CUDA {torch.version.cuda}; budget "
        f"{s.budget_s:.0f}s; {s.mode} mode; {s.n_pix} px")
    _build.build_all()       # a kernel that fails to build raises here
    device = "cuda"
    cube = make_cube(s.n_pix, s.seed)
    cfg = NSConfig(nlive=s.nlive, tol=1.0, init_factor=s.init_factor)
    setup = make_setup(cube, cfg, s.segment_iters, s.band_nats, device)

    t0 = time.perf_counter()
    pre = precompile(setup)
    log(f"bench: precompile {pre['wall_s']:.1f}s ({pre['n_programs']} "
        f"tasks, {pre['n_deduped']} deduplicated)")
    RESULT["precompile"] = pre
    warm = run_ladder(setup, torch.Generator(device=device).manual_seed(0),
                      tag="warmup")
    t_warm = time.perf_counter() - t0
    RESULT["warmup_s"] = round(t_warm, 1)
    warm_score = score_ladder(setup, warm, t_warm)
    del warm
    RESULT.update({
        "value": round(warm_score["fits_per_sec"], 3)
        if warm_score["ok_selection"] else 0.0,
        "evals_per_pixel": int(warm_score["evals_per_pixel"]),
        "gates": warm_score["gates"]})
    log(f"bench: warmup incl. precompile {t_warm:.1f}s (budget left "
        f"{clock.remaining():.0f}s)")

    required = (s.n_pix, s.seed) == DEFAULT_CUBE    # gate (ii) must hold
    counters = kernel_counters()
    seeds, scores = [], []
    peak = 0.0
    for seed in s.timed_seeds:
        if clock.remaining() - BASELINE_RESERVE_S <= TIMED_FLOOR_S:
            log(f"bench: no budget for the timed ladder of seed {seed}")
            break
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        sync(device)
        t0 = time.perf_counter()
        lad = run_ladder(setup, torch.Generator(device=device)
                         .manual_seed(seed), tag=f"timed seed {seed}",
                         clock=clock, reserve=BASELINE_RESERVE_S)
        sync(device)
        elapsed = time.perf_counter() - t0
        if len(lad["fits"]) < 2:
            log(f"bench: timed ladder of seed {seed} aborted on budget")
            break
        launches = {k: int(fn.launches) for k, fn in counters.items()}
        missing = [k for k, n in launches.items() if n <= 0]
        if missing:
            raise RuntimeError(f"the timed ladder launched no {missing}")
        mem = torch.cuda.max_memory_allocated() / 2**30
        peak = max(peak, mem)
        sc = score_ladder(setup, lad, elapsed)
        ok_nt = gate_native(sc, cube, required)
        rec = {
            "seed": seed, "wall_s": elapsed,
            "rung_s": {str(n): w for n, w in lad["walls"].items()},
            "second_pass": lad["second_pass"],
            "second_pass_s": sum(r["wall_s"] for r in lad["second_pass"]),
            "evals_per_pixel": sc["evals_per_pixel"],
            "fits_per_sec": sc["fits_per_sec"],
            "peak_mem_gib": mem, "launches": launches,
            "gates": sc["gates"],
            "pass": {"selection": sc["ok_selection"], "native400": ok_nt},
        }
        if s.mode == "traced":
            rec["traced"] = dataclasses.asdict(lad["traced"])
        del lad
        seeds.append(rec)
        scores.append(sc)
        rate = statistics.median(r["fits_per_sec"] for r in seeds)
        ok = all(r["pass"]["selection"] and r["pass"]["native400"]
                 for r in seeds)
        RESULT.update({
            "value": round(rate, 3) if ok else 0.0,
            "timed_clean": False, "seeds": seeds,
            "evals_per_pixel": int(statistics.median(
                r["evals_per_pixel"] for r in seeds)),
            "gates": dict(seeds[0]["gates"]), "peak_mem_gib": peak,
            "launches": [dict(r["launches"], seed=r["seed"])
                         for r in seeds],
            "traced": [dict(r["traced"], seed=r["seed"]) for r in seeds]
            if s.mode == "traced" else None})
        log(f"bench: timed seed {seed}: {elapsed:.1f}s "
            f"({rec['fits_per_sec']:.2f} fits/s), rung walls "
            f"{rec['rung_s']}, second pass {rec['second_pass_s']:.1f}s")

    timed_clean = len(seeds) == len(s.timed_seeds)
    if scores:
        rate = statistics.median(sc["fits_per_sec"] for sc in scores)
    else:
        # no timed ladder fitted the budget: the warm-up's rate (with its
        # preparation), gated like a timed ladder
        log("bench: reporting the warm-up ladder (includes preparation)")
        gate_native(warm_score, cube, required)
        rate, scores = s.n_pix / t_warm, [warm_score]
    ok_sel = all(sc["ok_selection"] for sc in scores)
    ok_native = all(sc["ok_native"] for sc in scores)
    gates = dict(scores[0]["gates"])

    a = scores[0]["arrays"]
    cpu_rate, agree = engine_baseline(
        cube, setup.runners[1].utrans, s.nlive, (a["lnz1"], a["err1"]),
        (a["lnz2"], a["err2"]), s.cpu_pixels, s.cpu_budget_s, clock)
    log(f"bench: engine baseline {cpu_rate:.4f} ladder-fits/s/core")
    eng, ok_eng = engine_gate(agree)
    gates.update(eng)
    gates["pass"] = {"selection": ok_sel, "native400": ok_native,
                     "engine": ok_eng}
    value = round(rate, 3)
    if not (ok_sel and ok_native and ok_eng):
        log("bench: ACCURACY GATE FAILED -- reporting 0")
        value = 0.0
    RESULT.update({
        "value": value,
        "vs_baseline": round(value / cpu_rate, 2),
        "baseline_fits_per_sec_per_core": cpu_rate,
        "timed_clean": timed_clean,
        "gates": gates,
    })
    RESULT.setdefault("seeds", [])
    RESULT.setdefault("peak_mem_gib", None)
    RESULT.setdefault("launches", [])
    RESULT.setdefault("traced", None)
    RESULT.pop("partial", None)
    return RESULT


def _deadline_emit(signum=None, frame=None):  # pragma: no cover
    RESULT["deadline_hit"] = True
    log("bench: DEADLINE -- emitting the best-known partial result")
    print(json.dumps(RESULT), flush=True)
    os._exit(0)


def run(argv):
    """The command line: the deadline, ``main``, the JSON line; returns
    the exit code (1 when ``main`` raised)."""
    import faulthandler
    import signal

    s = Settings.from_env(argv)
    faulthandler.enable()
    faulthandler.dump_traceback_later(
        max(s.budget_s - s.deadline_lead_s - 10, 20), exit=False)
    signal.signal(signal.SIGALRM, _deadline_emit)
    signal.alarm(int(max(s.budget_s - s.deadline_lead_s, 30)))
    rc = 0
    try:
        result = main(argv)
    except Exception as exc:  # the JSON line goes out in every case
        import traceback

        log(f"bench: FAILED: {exc!r}")
        traceback.print_exc(file=sys.stderr)
        result = dict(RESULT, value=0.0, error=repr(exc))
        rc = 1
    signal.alarm(0)
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps(result), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
