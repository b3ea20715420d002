"""Host-side records of a fit's pixel groups (the first half of
``write_fit_group`` of ``nestfit_tpu/cube/store.py``).

A record is what the store writes into ``/pix/<lon>/<lat>/<N>``:
``(attrs, datasets)``, two dicts of NumPy arrays and Python scalars, with
the names, types and order of the JAX writer (the attribute/dataset set
of the reference's ``mn_dump``).  Building records needs no ``h5py``, so
the fitter runs where it is missing; ``store.write_fit_record`` writes
them.
"""

import numpy as np
import torch

from nestfit_tpu_torch.sampling.results import MARGINAL_COLS, QUANTILES
from nestfit_tpu_torch.utils.profiling import to_host

_ICS = ("BIC", "AIC", "AICc", "null_BIC", "null_AIC", "null_AICc")


def fit_group_records(fit, rows):
    """Records of run rows ``rows`` of the batched ``FitResult`` ``fit``.

    Each leaf goes to the host once for all ``rows`` (one ``.cpu()`` a
    leaf, not one a pixel).
    """
    rows = np.asarray(rows, dtype=np.int64)
    idx = torch.as_tensor(rows, device=fit.lnz.device)

    def host(x):
        return to_host(x[idx], "cube.records")

    ns, prod = fit.ns, fit.products
    null, lnz, lnz_err, max_ll = (host(x) for x in (
        fit.null_lnz, ns.lnz, ns.lnz_err, ns.max_loglike))
    n_samples, ncall, conv = (host(x) for x in (
        ns.n_samples, ns.ncall, ns.converged))
    ics = {k: host(fit.ics[k]) for k in _ICS}
    post = host(prod.posteriors)
    marg, best, mapp = (host(x) for x in (
        prod.marginals, prod.bestfit_params, prod.map_params))
    records = []
    for i in range(rows.size):
        attrs = {
            "ncomp": fit.ncomp,
            "null_lnZ": float(null[i]),
            "n_chan_tot": fit.n_chan_tot,
            "n_samples": int(n_samples[i]),
            "n_live": ns.nlive,
            "n_params": fit.n_params,
            "global_lnZ": float(lnz[i]),
            "global_lnZ_err": float(lnz_err[i]),
            "max_loglike": float(max_ll[i]),
            "marg_cols": MARGINAL_COLS,
            "marg_quantiles": QUANTILES,
            "n_calls": int(ncall[i]),
            "converged": bool(conv[i]),
        }
        attrs.update((k, float(ics[k][i])) for k in _ICS)
        datasets = {
            "posteriors": np.asarray(post[i], dtype=np.float32),
            "marginals": marg[i],
            "bestfit_params": best[i],
            "map_params": mapp[i],
        }
        records.append((attrs, datasets))
    return records


def fit_group_record(fit, run_ix):
    """The record of run row ``run_ix`` of ``fit``."""
    return fit_group_records(fit, [run_ix])[0]
