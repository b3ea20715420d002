"""What decides ``correct``: the window's own outputs against the plain
reference.

For every ``fit_batch`` call the timed path made (``program.Tap``), on
the rows drawn from the seed:

- ``lnl_gap`` [nats]: each posterior sample the program drew carries
  its parameters and ln-likelihood; the widest gap between that
  ln-likelihood and the reference's forward model and chi-square of the
  same parameters against the pixel's own data (K1).
- ``transform_gap`` [prior grid cells]: each posterior sample is matched
  to the sampled point with its very ln-likelihood; the widest gap
  between its parameters and the reference's prior transform of that
  point's unit-cube coordinates (K2, K3), in cells of the parameter's
  prior grid.
- ``lnz_gap`` [nats]: the widest gap between the reported lnZ and the
  reference's batched-kill quadrature of the reported ln-likelihoods of
  the run's dead and live points; on every row, the widest gap between
  the reported null evidence and the reference's.
- ``lnz_err_gap`` [share]: the widest relative gap of lnZ's error.
- ``marg_gap`` [posterior sd]: the widest gap of a reported marginal
  quantile from the reference's (reference parameters, weights from the
  reported ln-likelihoods), over the parameter's posterior standard
  deviation or its prior grid's cell, whichever is wider.  The 0 and 1
  quantiles are left out: they sit on the last point whose weight
  underflows, which a float32 weight reaches some hundred nats before a
  float64 one.
- ``bestfit_gap`` [nats]: the wider of the reported best lnL against the
  best of the reported points and the reference lnL of the reported
  best-fit parameters against the reported best lnL.
- ``ladder_mismatch`` [count] (cube entry): places where the runs that
  covered a pixel, or the records and ``nbest`` handed back for it, part
  from the ladder's rules replayed on the reported evidences, pixel by
  pixel (``reference/ladder.py``), and rows of a call that are no pixel
  of the cube; every record must hold the kept run's numbers exactly.
- ``failed_px`` [count]: pixels of the window that no record came back
  for.

The control is the reference put in the program's place at a lower
precision (``control_dtype``): from the same unit-cube points it
reports every ln-likelihood, lnZ, the marginals and the best fit, and
takes the posterior samples at the points the program took; it is
judged by the same numbers.
"""

import numpy as np
import torch

from core import gen
from reference import evidence, hyperfine, ladder, priors

NEG_HALF = -5e29      # the program masks points at -1e30
CHUNK = 2048
ROW_KEYS = ("lnl_gap", "transform_gap", "lnz_gap", "lnz_err_gap",
            "marg_gap", "bestfit_gap")
INNER_Q = [k for k, q in enumerate(evidence.QUANTILES) if 0 < q < 1]


class Reference:
    """Prior transform and likelihood of a configuration against a
    cube's pixels, at one dtype."""

    def __init__(self, config, inputs, dtype=torch.float64, device="cpu"):
        self.dtype, self.device = dtype, device
        self.model = gen.model_module(config)
        self.transform = priors.Transform(config["prior_set"], dtype, device)
        self.axes = [hyperfine.make_axis(config["model"], tid, xarr, dtype,
                                         device)
                     for tid, xarr, _ in inputs.spectra]
        self.data = [torch.as_tensor(d, dtype=dtype, device=device)
                     for _, _, d in inputs.spectra]
        self.inv2v = 1.0 / (2.0 * inputs.rms ** 2)
        self.cell = self.transform.cells()

    def tensor(self, x):
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.asarray(x))
        return x.to(device=self.device, dtype=self.dtype)

    def loglike(self, theta, pix):
        theta = self.tensor(theta)
        out = []
        for k in range(0, theta.shape[0], CHUNK):
            th = theta[k:k + CHUNK]
            tot = torch.zeros(th.shape[0], dtype=self.dtype,
                              device=self.device)
            for ax, d in zip(self.axes, self.data):
                r = d[pix] - self.model.predict(ax, th)
                tot = tot - torch.sum(r * r, dim=-1) * self.inv2v
            out.append(tot)
        return torch.cat(out) if out else self.tensor(np.zeros(0))

    def theta(self, u):
        u = self.tensor(u)
        return torch.cat([self.transform(u[k:k + CHUNK])
                          for k in range(0, u.shape[0], CHUNK)]) \
            if u.shape[0] else u

    def null(self, pix):
        pix = torch.as_tensor(np.asarray(pix), device=self.device)
        return -sum(torch.sum(d[pix] ** 2, dim=-1)
                    for d in self.data) * self.inv2v

    def summaries(self, theta, lnl, run, nd, n_masked):
        """lnZ, its error and the marginals of points ``theta`` with
        ln-likelihoods ``lnl`` (the first ``nd`` dead, in death order),
        by the reference's quadrature at this dtype."""
        lnx, lnw = evidence.weight_tables(run["nlive"], run["kill_k"],
                                          run["max_iter"],
                                          run["n_init_dead"])
        lnl = self.tensor(lnl)
        lnz, err, lnp = evidence.evidence(lnl[:nd], lnl[nd:], lnx, lnw)
        theta = self.tensor(theta)
        pad = torch.full((n_masked, theta.shape[1]), float("inf"),
                         dtype=self.dtype, device=self.device)
        marg = evidence.weighted_quantiles(
            torch.cat([theta, pad]), torch.cat([lnp, torch.full(
                (n_masked,), -1e30, dtype=self.dtype, device=self.device)]))
        std = evidence.posterior_std(theta, lnp)
        return float(lnz), float(err), _np(marg), _np(std)


def _np(x):
    return x.double().cpu().numpy()


def points(run, s):
    """Sampled row ``s`` of ``run``: ``(pixel, u, reported lnl, n_dead,
    n_masked)``, dead points then the live points still alive."""
    smp = run["sample"]
    nd = int(smp["n_dead"][s])
    alive = smp["live_lnl"][s] > NEG_HALF
    u = np.concatenate([smp["dead_u"][s, :nd], smp["live_u"][s][alive]])
    lnl = np.concatenate([smp["dead_lnl"][s, :nd], smp["live_lnl"][s][alive]])
    n_masked = run["max_iter"] - nd + int((~alive).sum())
    return int(run["pixels"][smp["rows"][s]]), u, lnl, nd, n_masked


def program_report(run, s, lnl):
    """What the program reported for sampled row ``s``.  Each posterior
    sample is matched to the points whose float32 ln-likelihood it
    carries: ``post_cands[j]`` lists them (float32 values collide now
    and then among thousands of points; none means no match)."""
    row = run["sample"]["rows"][s]
    post = run["sample"]["post"][s]
    d = post.shape[1] - 2
    post_lnl = (np.float32(-0.5) * post[:, d]).astype(np.float32)
    lnl32 = np.asarray(lnl, dtype=np.float32)
    order = np.argsort(lnl32, kind="stable")
    lo = np.searchsorted(lnl32[order], post_lnl, side="left")
    hi = np.searchsorted(lnl32[order], post_lnl, side="right")
    return dict(lnl=np.asarray(lnl, dtype=np.float64),
                lnz=float(run["lnz"][row]), err=float(run["lnz_err"][row]),
                marg=run["marg"][row], maxl=float(run["maxl"][row]),
                best=run["best"][row], post_theta=post[:, :d],
                post_lnl=post_lnl.astype(np.float64),
                post_cands=[order[a:b] for a, b in zip(lo, hi)])


def control_report(ctrl, run, s, prog_cands):
    """The control in the program's place for sampled row ``s``: every
    number worked out at the control's dtype from the same points, the
    posterior samples taken at the points the program took."""
    pix, u, _lnl, nd, n_masked = points(run, s)
    theta = ctrl.theta(u)
    lnl = ctrl.loglike(theta, pix)
    lnz, err, marg, _std = ctrl.summaries(theta, lnl, run, nd, n_masked)
    k = int(torch.argmax(lnl))
    idx = np.array([c[0] if len(c) else 0 for c in prog_cands], dtype=int)
    th, ll = _np(theta), _np(lnl)
    return dict(lnl=ll, lnz=lnz, err=err, marg=marg, maxl=float(ll[k]),
                best=th[k], post_theta=th[idx], post_lnl=ll[idx],
                post_cands=[idx[j:j + 1] for j in range(len(idx))])


def judge_row(ref, run, s, rep):
    """The row's six gaps of report ``rep`` against the reference."""
    pix, u, _lnl, nd, n_masked = points(run, s)
    theta = ref.theta(u)
    lnz, err, marg, std = ref.summaries(theta, rep["lnl"], run, nd,
                                        n_masked)
    ncomp = theta.shape[1] // len(ref.cell)
    cells = np.repeat(ref.cell, ncomp)
    scale = np.maximum(std, cells)
    m = np.asarray(rep["marg"], dtype=np.float64)[INNER_Q]
    r = marg[INNER_Q]
    with np.errstate(invalid="ignore"):
        mg = np.where(m == r, 0.0, np.abs(m - r) / scale[None, :])
    lnl_post = _np(ref.loglike(rep["post_theta"], pix))
    th = _np(theta)
    varies = cells > 1e-9
    tg = 0.0
    for post, cands in zip(rep["post_theta"], rep["post_cands"]):
        # the nearest of the points that carry this ln-likelihood
        gap = min((float(np.max(np.abs(post - th[c])[varies]
                                / cells[varies])) for c in cands),
                  default=np.inf)
        tg = max(tg, gap)
    lnl_best = float(ref.loglike(np.asarray(rep["best"])[None], pix)[0])
    return dict(
        lnl_gap=float(np.max(np.abs(rep["post_lnl"] - lnl_post)))
        if len(lnl_post) else 0.0,
        transform_gap=tg,
        lnz_gap=abs(rep["lnz"] - lnz),
        lnz_err_gap=abs(rep["err"] - err) / max(err, 1e-30),
        marg_gap=float(np.nanmax(np.where(np.isnan(mg), np.inf, mg))),
        bestfit_gap=max(abs(rep["maxl"] - float(np.max(rep["lnl"]))),
                        abs(lnl_best - rep["maxl"])))


def judge(config, inputs, tap, units, entry, device="cpu",
          control_dtype=None):
    """``(numbers, control numbers or None, notes)``; numbers as the
    module docstring defines them."""
    ref = Reference(config, inputs, torch.float64, device)
    ctrl = Reference(config, inputs, control_dtype, device) \
        if control_dtype is not None else None
    prog = dict.fromkeys(ROW_KEYS, 0.0)
    cont = dict.fromkeys(ROW_KEYS, 0.0) if ctrl is not None else None
    where = {}
    zero_err = n_rows = 0
    for run in tap.runs:
        n_rows += len(run["sample"]["rows"])
        placed = run["pixels"] >= 0
        null_ref = _np(ref.null(run["pixels"][placed]))
        if null_ref.size:
            prog["lnz_gap"] = max(prog["lnz_gap"], float(
                np.max(np.abs(run["null"][placed] - null_ref))))
            if ctrl is not None:
                cont["lnz_gap"] = max(cont["lnz_gap"], float(np.max(np.abs(
                    _np(ctrl.null(run["pixels"][placed])) - null_ref))))
        for s in range(len(run["sample"]["rows"])):
            _pix, _u, lnl, _nd, _nm = points(run, s)
            if _pix < 0:
                continue
            rep = program_report(run, s, lnl)
            if rep["err"] == 0.0:
                zero_err += 1
            for k, v in judge_row(ref, run, s, rep).items():
                if v > prog[k]:
                    prog[k] = v
                    where[k] = (f"pixel {_pix} ncomp={run['ncomp']} "
                                f"nlive={run['nlive']}")
            if ctrl is not None:
                crep = control_report(ctrl, run, s, rep["post_cands"])
                for k, v in judge_row(ref, run, s, crep).items():
                    cont[k] = max(cont[k], v)
    notes = [f"{k} {prog[k]:.6g} at {w}" for k, w in where.items()]
    notes.append(f"lnZ error reported as 0 on {zero_err} of {n_rows} "
                 "sampled rows")
    prog["failed_px"] = sum(u["failed"] for u in units)
    unplaced = sum(int((r["pixels"] < 0).sum()) for r in tap.runs)
    if unplaced:
        notes.append(f"{unplaced} rows of the calls are no pixel of the cube")
    if entry == "cube":
        rule = dict(margin=config["mode_loss_margin"],
                    retries=config["mode_loss_retries"],
                    band=config["boundary_band"],
                    thresh=config["lnZ_thresh"],
                    mult=config["boundary_nlive_mult"],
                    ncomp_max=config["ncomp_max"])
        batches = [u["batch"] for u in units if u["batch"] is not None]
        records = {(int(p), int(n)): rec for b in batches
                   for p, n, rec in b.records}
        cat = (lambda xs: np.concatenate(xs)) if batches else \
            (lambda xs: np.zeros(0, dtype=np.int64))
        bad = ladder.replay(
            tap.runs, records, cat([b.nbest for b in batches]),
            cat([b.pixel_ix for b in batches]),
            cat([np.full(b.pixel_ix.size, b.nlive) for b in batches]), rule)
        prog["ladder_mismatch"] = len(bad) + unplaced
        notes += bad[:10]
    return prog, cont, notes


def verdict(numbers, limits):
    """``(correct, [(name, value, limit)])``: each number at or under its
    limit; a number that is not finite fails."""
    rows = [(k, numbers[k], limits[k]) for k in numbers]
    ok = all(np.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows
