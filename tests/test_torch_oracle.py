"""The port's scalar prior oracle (``OracleDistribution``,
``resolved_placement_interp`` in ``nestfit_tpu_torch/oracle.py``) equals
the JAX package's bit for bit, and holds the port's plain transform: the
placement prior in float64 tables at the JAX package's own tolerance
(``tests/test_priors.py::test_resolved_placement_vs_oracle``), and the
float32 IRDC transform (K2/K3's plain versions) to a quarter grid
cell."""

import numpy as np
import pytest
import torch
from scipy import stats

from nestfit_tpu import oracle as joracle

from nestfit_tpu_torch import oracle
from nestfit_tpu_torch.constants import FWHM
from nestfit_tpu_torch.priors import get_irdc_priors
from nestfit_tpu_torch.priors.distributions import make_distribution
from nestfit_tpu_torch.priors.priors import (
    ConstantPrior,
    Prior,
    PriorTransformer,
    ResolvedPlacementPrior,
)

# IRDC centroid grid (constructors.get_irdc_priors); measured: at most 0.1
# grid cells over 256 draws, seed 3
IRDC_VOFF = (8.00 * np.linspace(0, 1, 500) - 4.00,
             stats.beta(5.0, 5.0).pdf(np.linspace(0, 1, 500)))
F32_CELLS = 0.25


def _gauss_grid():
    x = np.linspace(-4, 4, 200)
    y = np.exp(-0.5 * x ** 2)
    return x, y / y.sum()


@pytest.mark.parametrize("grid", ["gauss", "irdc"])
def test_oracle_distribution_bit_for_bit(grid):
    x, y = _gauss_grid() if grid == "gauss" else IRDC_VOFF
    a, b = oracle.OracleDistribution(x, y), joracle.OracleDistribution(x, y)
    for f in ("xax", "pdf", "cdf", "ppf"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    for f in ("dx", "du", "size", "xmin", "xmax"):
        assert getattr(a, f) == getattr(b, f)
    rng = np.random.default_rng(1)
    for u in rng.uniform(size=20):
        assert a.ppf_interp(u) == b.ppf_interp(u)
        assert a.cdf_interp(u) == b.cdf_interp(u)
    for lo, hi, s in ((-1.0, 2.0, 0.0), (0.5, -0.3, 1.0), (1.0, 1.01, 2.0),
                      (-3.9, 3.9, 3.0)):
        a.cdf_over_interval(lo, hi, s)
        b.cdf_over_interval(lo, hi, s)
        np.testing.assert_array_equal(a.cdf, b.cdf)
        assert a.cdf_interp(0.3) == b.cdf_interp(0.3)


@pytest.mark.parametrize("ncomp", [1, 2, 3])
def test_resolved_placement_interp_bit_for_bit(ncomp):
    x, y = IRDC_VOFF
    rng = np.random.default_rng(ncomp)
    for _ in range(10):
        u = rng.uniform(size=ncomp)
        sig = rng.uniform(0.1, 1.0, size=ncomp)
        np.testing.assert_array_equal(
            oracle.resolved_placement_interp(
                oracle.OracleDistribution(x, y), u, sig, FWHM * 1.2),
            joracle.resolved_placement_interp(
                joracle.OracleDistribution(x, y), u, sig, FWHM * 1.2))


@pytest.mark.parametrize("ncomp", [1, 2, 3])
def test_plain_placement_float64_against_oracle(ncomp):
    x, y = _gauss_grid()
    dist = make_distribution(x, y, dtype=torch.float64, device="cpu")
    prior = ResolvedPlacementPrior(Prior(dist, 0), ConstantPrior(0.3, 1),
                                   scale=1.5)
    rng = np.random.default_rng(5)
    for _ in range(5):
        u = rng.uniform(size=2 * ncomp)
        out = PriorTransformer([prior]).transform(
            torch.as_tensor(u), ncomp, plain=True).numpy()
        want = oracle.resolved_placement_interp(
            oracle.OracleDistribution(x, y), u[:ncomp], np.full(ncomp, 0.3),
            FWHM * 1.5)
        np.testing.assert_allclose(out[:ncomp], want, rtol=1e-6, atol=1e-8)


def test_plain_irdc_transform_against_oracle():
    ut = get_irdc_priors(vsys=0.0, device="cpu")
    prior = ut.priors[0]
    od = oracle.OracleDistribution(*IRDC_VOFF)
    u = np.random.default_rng(3).uniform(size=(256, 12)).astype(np.float32)
    th = ut.transform(torch.as_tensor(u), 2, plain=True).numpy()
    th = th.reshape(256, 6, 2).astype(np.float64)
    err = [np.abs(th[i, 0] - oracle.resolved_placement_interp(
        od, u[i].reshape(6, 2)[0].astype(np.float64), th[i, 4],
        prior.sep_scale)).max() for i in range(256)]
    assert max(err) <= F32_CELLS * prior.vcen_prior.dist.dx
