"""Standard prior constructors (port of ``get_irdc_priors`` from
``nestfit_tpu/priors/constructors.py``)."""

import numpy as np
import torch
from scipy import stats

from nestfit_tpu_torch.priors.distributions import make_distribution
from nestfit_tpu_torch.priors.priors import (
    ConstantPrior,
    Prior,
    PriorTransformer,
    ResolvedPlacementPrior,
)


def get_irdc_priors(size=500, vsys=0.0, dtype=torch.float32, device="cuda"):
    """Priors for the IRDCs of Svoboda et al. (in prep): beta-distribution
    PDFs on ``size``-point grids, a resolved-placement prior on the
    centroids and the ortho fraction fixed to zero."""
    u = np.linspace(0, 1, size)
    grids = {
        "voff": (8.00 * u - 4.00 + vsys, stats.beta(5.0, 5.0).pdf(u)),
        "trot": (23.00 * u + 7.00, stats.beta(3.0, 6.7).pdf(u)),
        "tex": (9.26 * u + 2.80, stats.beta(1.0, 2.5).pdf(u)),
        "ntot": (4.00 * u + 12.50, stats.beta(10.0, 8.5).pdf(u)),
        "sigm": (2.00 * u + 0.067, stats.beta(1.5, 5.0).pdf(u)),
    }
    d = {k: make_distribution(x, f, dtype=dtype, device=device)
         for k, (x, f) in grids.items()}
    return PriorTransformer([
        ResolvedPlacementPrior(Prior(d["voff"], 0), Prior(d["sigm"], 4),
                               scale=1.2),
        Prior(d["trot"], 1),
        Prior(d["tex"], 2),
        Prior(d["ntot"], 3),
        ConstantPrior(0, 5),
    ])
