"""The port's binding of the native C++ engine
(``nestfit_tpu_torch/native``) against the JAX package's binding
(``nestfit_tpu.native``): the PPF tables and placement spec built from
the port's prior transformer equal the JAX ones bit for bit, and every
engine entry point gives the same numbers for the same inputs and seed.
The port builds its own copy of the library at first use (into
``nestfit_tpu_torch/_build``).  Also the tolerance between the port's
plain float32 transform and the engine's, which ``chip_smoke.py`` holds
the kernels to on the card."""

import numpy as np
import pytest
import torch

from nestfit_tpu import native as jnative
from nestfit_tpu.priors import get_irdc_priors as jax_priors
from nestfit_tpu.utils import freq_axis_from_velocity

from nestfit_tpu_torch.models.tables import AMMONIA_TRANSITIONS
from nestfit_tpu_torch.native import bindings
from nestfit_tpu_torch.priors import get_irdc_priors

pytestmark = pytest.mark.skipif(bindings.compiler() is None,
                                reason="no C++ compiler")

# the port's plain float32 IRDC transform against the engine's, ncomp 2,
# 4096 uniform vectors (seeds 0-3 measured: independent dims <= 8.4e-3,
# centroids <= 0.91 grid cells, median <= 5e-6 cells)
INDEP_ATOL = 2e-2
VOFF_MAX_CELLS, VOFF_MEDIAN_CELLS = 2.0, 1e-2


@pytest.fixture(scope="module")
def priors():
    assert bindings.available() and jnative.available()
    return get_irdc_priors(vsys=0.0, device="cpu"), jax_priors(vsys=0.0)


@pytest.mark.parametrize("ncomp", [1, 2, 3])
def test_ppf_tables_bit_for_bit(priors, ncomp):
    ut, ju = priors
    got = bindings.ppf_tables_from_utrans(ut, ncomp)
    want = jnative.bindings.ppf_tables_from_utrans(ju, ncomp)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_placement_spec_bit_for_bit(priors):
    ut, ju = priors
    got = bindings.placement_spec_from_utrans(ut)
    want = jnative.bindings.placement_spec_from_utrans(ju)
    assert got[:3] == want[:3]
    for g, w in zip(got[3:], want[3:]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("ncomp", [1, 2])
def test_transform_native_matches_jax_binding(priors, ncomp):
    ut, ju = priors
    u = np.random.default_rng(7).uniform(0.02, 0.98, size=(256, 6 * ncomp))
    np.testing.assert_array_equal(
        bindings.transform_native(ut, ncomp, u),
        jnative.transform_native(ju, ncomp, u))


def test_amm_predict_native_matches_jax_binding():
    params = np.array([-1.0, 1.5, 10.0, 15.0, 4.0, 6.0,
                       14.5, 15.0, 0.3, 0.6, 0.0, 0.0])
    for tid in (1, 2):
        xarr = freq_axis_from_velocity(np.arange(-30, 30, 0.158),
                                       AMMONIA_TRANSITIONS[tid - 1].nu)
        np.testing.assert_array_equal(
            bindings.amm_predict_native(xarr, params, tid),
            jnative.amm_predict_native(xarr, params, tid))


def test_ns_gaussian_matches_jax_binding():
    for seed in (0, 3):
        assert bindings.ns_gaussian(4, 0.1, nlive=100, tol=0.5, seed=seed) \
            == jnative.ns_gaussian(4, 0.1, nlive=100, tol=0.5, seed=seed)


def test_ns_spectral_ammonia_matches_jax_binding(priors):
    ut, ju = priors
    rng = np.random.default_rng(3)
    params = np.array([0.5, 11.0, 5.5, 14.6, 0.4, 0.0])
    spectra = []
    for tid in (1, 2):
        xarr = freq_axis_from_velocity(np.linspace(-15, 15, 128),
                                       AMMONIA_TRANSITIONS[tid - 1].nu)
        data = bindings.amm_predict_native(xarr, params, tid) + \
            rng.normal(scale=0.1, size=xarr.shape)
        spectra.append((xarr, data, 0.1, tid))
    kw = dict(ncomp=1, nlive=50, tol=1.0, seed=2)
    got = bindings.ns_spectral_ammonia(
        spectra, bindings.ppf_tables_from_utrans(ut, 1),
        placement=bindings.placement_spec_from_utrans(ut), **kw)
    want = jnative.bindings.ns_spectral_ammonia(
        spectra, jnative.bindings.ppf_tables_from_utrans(ju, 1),
        placement=jnative.bindings.placement_spec_from_utrans(ju), **kw)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert np.isfinite(got["lnz"]) and not got["truncated"]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_plain_transform_against_the_engine(priors, seed):
    """The tolerance ``chip_smoke.py`` holds K2/K3 to against the engine:
    table sub-sampling on the independent dims, the two inversions of
    the tapered interval CDF on the centroids."""
    ut, _ = priors
    u = np.random.default_rng(seed).uniform(size=(4096, 12))
    u = u.astype(np.float32)
    th = ut.transform(torch.as_tensor(u), 2, plain=True).double().numpy()
    tc = bindings.transform_native(ut, 2, u.astype(np.float64))
    a, c = th.reshape(-1, 6, 2), tc.reshape(-1, 6, 2)
    assert np.abs(a[:, 1:] - c[:, 1:]).max() <= INDEP_ATOL
    cells = np.abs(a[:, 0] - c[:, 0]) / ut.priors[0].dist.dx
    assert cells.max() <= VOFF_MAX_CELLS
    assert np.median(cells) <= VOFF_MEDIAN_CELLS


def test_build_goes_to_the_port_build_dir():
    path = bindings.build()
    assert path.parent == bindings.BUILD_DIR and path.exists()
    assert path.name.startswith("nestfit_native-")
