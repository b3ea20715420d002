"""The ladder replay on hand-made runs: the rules followed give nothing,
however the runs are grouped into calls; each departure is reported."""

import copy

import numpy as np
import pytest

from reference import ladder

RULE = dict(margin=8.0, retries=2, band=6.0, thresh=11.0, mult=2,
            ncomp_max=2)


def run(ncomp, nlive, pixels, lnz, null=None):
    n = len(pixels)
    lnz = np.asarray(lnz, dtype=np.float32)
    return dict(ncomp=ncomp, nlive=nlive, pixels=np.asarray(pixels),
                lnz=lnz, null=np.asarray(null if null is not None
                                         else [-100.0] * n, np.float32),
                lnz_err=np.full(n, 0.1, np.float32), maxl=lnz + 5,
                ncall=np.arange(n) + 1000 * ncomp,
                marg=np.zeros((n, 15, 6)), best=np.zeros((n, 6)))


def record(r, j):
    attrs = dict(global_lnZ=float(r["lnz"][j]),
                 global_lnZ_err=float(r["lnz_err"][j]),
                 max_loglike=float(r["maxl"][j]), n_calls=int(r["ncall"][j]),
                 null_lnZ=float(r["null"][j]))
    return attrs, dict(marginals=r["marg"][j], bestfit_params=r["best"][j])


def batch():
    """Pixels 10-13: 10 fails rung 1; 11 passes rung 1, loses its mode at
    rung 2 and the first retry wins; 12 passes both; 13 sits in the band
    of rung 1 and its boundary refit passes."""
    r1 = run(1, 100, [10, 11, 12, 13], [-99.0, -50.0, -60.0, -88.0])
    b1 = run(1, 200, [13], [-85.0])
    r2 = run(2, 100, [11, 12, 13], [-70.0, -40.0, -83.0])
    m2 = run(2, 100, [11], [-30.0])
    runs = [r1, b1, r2, m2]
    recs = {(10, 1): record(r1, 0), (11, 1): record(r1, 1),
            (12, 1): record(r1, 2), (13, 1): record(b1, 0),
            (11, 2): record(m2, 0), (12, 2): record(r2, 1),
            (13, 2): record(r2, 2)}
    return runs, recs, np.array([0, 2, 2, 1])


PIXELS = np.array([10, 11, 12, 13])
BASE = np.full(4, 100)


def split(r, parts):
    """Run ``r`` as calls on the row groups ``parts``."""
    return [dict({k: (v[list(g)] if isinstance(v, np.ndarray) else v)
                  for k, v in r.items()}) for g in parts]


def regroup(runs, how):
    r1, b1, r2, m2 = runs
    if how == "as_made":
        return runs
    if how == "rung1_in_two_calls":
        return split(r1, [(0, 1), (2, 3)]) + [b1, r2, m2]
    # rung 2's first pass made pixel by pixel, the boundary refit of
    # rung 1 after it (a pixel's own runs keep their order)
    return [r1] + split(r2, [(0,), (1,), (2,)]) + [b1, m2]


@pytest.mark.parametrize("how", ["as_made", "rung1_in_two_calls",
                                 "rung2_per_pixel"])
def test_rules_followed(how):
    runs, recs, nbest = batch()
    assert ladder.replay(regroup(runs, how), recs, nbest, PIXELS, BASE,
                         RULE) == []


@pytest.mark.parametrize("fault", ["nbest", "record_lnz", "kept_loser",
                                   "missing_refit", "extra_record",
                                   "marginals"])
def test_departures_are_reported(fault):
    runs, recs, nbest = batch()
    runs = copy.deepcopy(runs)
    if fault == "nbest":
        nbest = nbest.copy()
        nbest[0] = 1
    elif fault == "record_lnz":
        a, d = recs[(12, 2)]
        recs[(12, 2)] = (dict(a, global_lnZ=a["global_lnZ"] + 0.5), d)
    elif fault == "kept_loser":
        recs[(11, 2)] = record(runs[2], 0)
    elif fault == "missing_refit":
        del runs[1]
    elif fault == "extra_record":
        recs[(10, 2)] = record(runs[2], 0)
    else:
        a, d = recs[(12, 1)]
        recs[(12, 1)] = (a, dict(d, marginals=d["marginals"] + 1e-3))
    assert ladder.replay(runs, recs, nbest, PIXELS, BASE, RULE)
