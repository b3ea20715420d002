"""Port parity: prior tables, kernels K2 (``table_lerp``) and K3
(``tapered_invert``), and the IRDC prior transform, against the JAX
package on the same inputs.

JAX runs its Pallas table kernels in interpret mode and, for the
references, its gather path (``USE_PALLAS_TABLES=False``), as its own
tests do.  The port runs its plain versions on the CPU
(``test_torch_kernels_gpu.py`` holds the CUDA kernels against them).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nestfit_tpu.ops import tables as jax_tables
from nestfit_tpu.priors import distributions as jax_dists
from nestfit_tpu.priors import get_irdc_priors as jax_priors

from nestfit_tpu_torch import convert
from nestfit_tpu_torch.ops import tables
from nestfit_tpu_torch.priors import (
    get_irdc_priors,
    make_distribution,
    ppf_interp,
    tapered_interval_invert,
)

TABLES = ("xax", "pdf", "cdf", "ppf", "t0", "t1c", "t2c")


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(jax_tables, "INTERPRET", True)
    monkeypatch.setattr(jax_dists, "USE_PALLAS_TABLES", False)
    torch.set_num_threads(2)


def _grid():
    x = np.linspace(-4, 4, 500)
    return x, np.exp(-0.5 * (x / 1.7) ** 2) + 0.05


def _dists():
    x, y = _grid()
    return (jax_dists.make_distribution(x, y, dtype=jnp.float32),
            make_distribution(x, y, device="cpu"))


def test_make_distribution_matches_jax():
    jd, td = _dists()
    for f in TABLES:
        np.testing.assert_array_equal(getattr(td, f).numpy(),
                                      np.asarray(getattr(jd, f)))
    for f in ("size", "dx", "du", "xmin", "xmax", "center"):
        assert getattr(td, f) == getattr(jd, f)
    # the same tables carried across through convert.py
    cd = convert.distribution_from_dict(
        {f: np.asarray(getattr(jd, f)) for f in TABLES}
        | {f: getattr(jd, f) for f in ("size", "dx", "du", "xmin", "xmax")})
    for f in TABLES:
        assert torch.equal(getattr(cd, f), getattr(td, f))


def test_table_lerp_plain_matches_jax():
    jd, td = _dists()
    u = np.random.default_rng(3).uniform(size=517).astype(np.float32)
    scaled = u * (td.size - 1)
    got = tables.table_lerp(td.ppf, torch.as_tensor(scaled)).numpy()
    want_kernel = np.asarray(jax_tables.table_lerp(jd.ppf,
                                                   jnp.asarray(scaled)))
    want_gather = np.asarray(jax_dists.ppf_interp(jd, jnp.asarray(u)))
    np.testing.assert_allclose(got, want_kernel, rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(got, want_gather, rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(ppf_interp(td, torch.as_tensor(u)).numpy(),
                               want_gather, rtol=2e-6, atol=2e-6)
    ends = tables.table_lerp(td.ppf, torch.tensor([0.0, td.size - 1.0]))
    assert torch.equal(ends, td.ppf[[0, -1]])


@pytest.mark.parametrize("sfact", [0, 1, 2])
def test_tapered_invert_plain_matches_jax(sfact):
    jd, td = _dists()
    rng = np.random.default_rng(7)
    B = 300
    lo = rng.uniform(-4, 3, size=B).astype(np.float32)
    hi = (lo + rng.uniform(0.005, 6, size=B)).astype(np.float32)
    u = rng.uniform(size=B).astype(np.float32)
    ju, jlo, jhi = map(jnp.asarray, (u, lo, hi))
    want_kernel = np.asarray(jax_tables.tapered_invert(
        jd.t0, jd.t1c, jd.t2c, jd.xax, ju, jlo, jhi, sfact, jd.size,
        jd.xmin, jd.dx, jd.center))
    want_xla = np.asarray(jax_dists.tapered_interval_invert(
        jd, ju, jlo, jhi, sfact))
    got = tapered_interval_invert(
        td, *(torch.as_tensor(a) for a in (u, lo, hi)), sfact).numpy()
    np.testing.assert_allclose(got, want_kernel, atol=0.51 * td.dx, rtol=0)
    np.testing.assert_allclose(got, want_xla, atol=0.51 * td.dx, rtol=0)


@pytest.mark.parametrize("ncomp", [1, 2, 4])
def test_irdc_transform_matches_jax(ncomp):
    """The IRDC transform; ncomp 4 reaches the dense placement path."""
    u = np.random.default_rng(11).uniform(size=(3, 16, 6 * ncomp)).astype(
        np.float32)
    want = np.asarray(jax_priors(vsys=0.0).transform(jnp.asarray(u), ncomp))
    pt = get_irdc_priors(device="cpu")
    got = pt.transform(torch.as_tensor(u), ncomp).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    assert pt.flat_dims(ncomp) == jax_priors().flat_dims(ncomp)


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="cuda"):
        get_irdc_priors()

