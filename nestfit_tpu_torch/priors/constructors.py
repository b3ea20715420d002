"""Standard prior constructors (port of
``nestfit_tpu/priors/constructors.py``): the same grids, PDFs and prior
classes.  Each builds its tables on ``device``."""

import numpy as np
import torch
from scipy import stats

from nestfit_tpu_torch.priors.distributions import make_distribution
from nestfit_tpu_torch.priors.priors import (
    ConstantPrior,
    DuplicatePrior,
    Prior,
    PriorTransformer,
    ResolvedCenSepPrior,
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


def get_synth_priors(size=500, dtype=torch.float32, device="cuda"):
    """Priors for synthetic ammonia tests per Keown et al. (2019) S6.1:
    uniform PDFs, a scaled log-normal on sigma, a resolved
    centre-separation prior on the centroids, and tex duplicated from
    tkin (LTE)."""
    u = np.linspace(0, 1, size)
    flat = np.ones_like(u) / size
    grids = {
        "voff": (7.800 * u - 3.90, flat),
        "vsep": (2.570 * u + 0.13, flat),
        "tkin": (17.200 * u + 7.90, flat),
        "ntot": (1.600 * u + 12.95, flat),
        "sigm": (2.025 * u + 0.075, stats.lognorm(1.0, scale=0.136).pdf(u)),
    }
    d = {k: make_distribution(x, f, dtype=dtype, device=device)
         for k, (x, f) in grids.items()}
    fwhm = 2 * np.sqrt(2 * np.log(2))
    return PriorTransformer([
        ResolvedCenSepPrior(Prior(d["voff"], 0), Prior(d["vsep"], 0),
                            Prior(d["sigm"], 4), scale=1 / fwhm),
        DuplicatePrior(d["tkin"], 1, 2),
        Prior(d["ntot"], 3),
        ConstantPrior(0, 5),
    ])


def get_gaussian_priors(size=500, vsys=0.0, voff_span=8.0, sigm_hi=2.0,
                        peak_hi=10.0, dtype=torch.float32, device="cuda"):
    """Uniform priors for the 3-parameter Gaussian model, with a
    resolved-placement prior on the centroids."""
    u = np.linspace(0, 1, size)
    flat = np.ones_like(u) / size
    d_voff, d_sigm, d_peak = (
        make_distribution(x, flat, dtype=dtype, device=device)
        for x in (voff_span * u - voff_span / 2 + vsys,
                  (sigm_hi - 0.05) * u + 0.05,
                  peak_hi * u + 0.01))
    return PriorTransformer([
        ResolvedPlacementPrior(Prior(d_voff, 0), Prior(d_sigm, 1),
                               scale=1.0),
        Prior(d_peak, 2),
    ])


def get_diazenylium_priors(size=500, vsys=0.0, voff_span=8.0,
                           dtype=torch.float32, device="cuda"):
    """Priors for the 4-parameter N2H+ model (voff, tex, ltau, sigm):
    uniform velocity placement with resolved-separation ordering, Tex in
    (2.8, 12) K, log10 tau in (-2, 2), sigma in (0.05, 2) km/s."""
    u = np.linspace(0, 1, size)
    flat = np.ones_like(u) / size
    d_voff, d_tex, d_ltau, d_sigm = (
        make_distribution(x, flat, dtype=dtype, device=device)
        for x in (voff_span * u - voff_span / 2 + vsys, 9.2 * u + 2.8,
                  4.0 * u - 2.0, 1.95 * u + 0.05))
    return PriorTransformer([
        ResolvedPlacementPrior(Prior(d_voff, 0), Prior(d_sigm, 3),
                               scale=1.2),
        Prior(d_tex, 1),
        Prior(d_ltau, 2),
    ])
