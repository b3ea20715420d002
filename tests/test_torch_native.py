"""The port's binding of the native C++ engine
(``nestfit_tpu_torch/native``) against the JAX package's binding
(``nestfit_tpu.native``): the PPF tables built from the port's prior
transformers equal the JAX ones bit for bit for every constructor and
prior class at every ncomp the JAX binding takes (and raise where it
raises), the placement spec too, and every engine entry point gives the
same numbers for the same inputs and seed.  The port builds its own
copy of the library at first use (into ``nestfit_tpu_torch/_build``).
Also the tolerance between the port's plain float32 transform (and the
JAX package's own) and the engine's, which ``chip_smoke.py`` holds the
kernels to on the card."""

import fcntl
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nestfit_tpu import native as jnative
from nestfit_tpu import priors as jax_pr
from nestfit_tpu.priors import get_irdc_priors as jax_priors
from nestfit_tpu.utils import freq_axis_from_velocity

from nestfit_tpu_torch import priors as pr
from nestfit_tpu_torch.models.tables import AMMONIA_TRANSITIONS
from nestfit_tpu_torch.native import bindings
from nestfit_tpu_torch.priors import get_irdc_priors

from _prior_pairs import PRIOR_KINDS, prior_pair

pytestmark = pytest.mark.skipif(bindings.compiler() is None,
                                reason="no C++ compiler")

# The IRDC transform against the engine's, 4096 uniform float32 vectors
# per seed, the port's plain version and the JAX package's own alike
# (seeds 0-7, 50 and 51 measured at ncomp 2-4):
# - independent dims <= 1.02e-2;
# - centroids on the grid: max 1.75 cells at ncomp 2, 3.99 at ncomp 3
#   and 3.992 at ncomp 4 (the last component, placed after the others),
#   median <= 8.8e-6 cells;
# - centroids off the grid (ROADMAP R3: component 0 when the minimum
#   separations fill the velocity range): none at ncomp 2, <= 2 of 4096
#   at ncomp 3, 21-41 at ncomp 4, off in both and <= 1.3e-7 apart
#   relative.
INDEP_ATOL = 2e-2
VOFF_MAX_CELLS = {2: 2.0, 3: 4.5, 4: 4.5}
VOFF_MEDIAN_CELLS = 1e-2
OFF_GRID_RTOL, OFF_GRID_SHARE = 1e-6, 0.02

CONSTRUCTORS = ["get_irdc_priors", "get_gaussian_priors",
                "get_diazenylium_priors", "get_synth_priors"]
# where the JAX transform raises: a centre/separation prior past ncomp 2
JAX_RAISES = {("get_synth_priors", 3), ("get_synth_priors", 4)}


@pytest.fixture(scope="module", autouse=True)
def jax_engine():
    """The JAX package's engine, loaded in this process.

    Its binding builds ``cpp/libnestfit_native.so`` on first load with
    ``make -B`` through one fixed temporary file, and remembers a failed
    load for the life of the process.  On a checkout without the
    library, every xdist worker loads it at once at collection
    (``tests/test_native.py``'s module-level ``skipif``): the builds
    overwrite each other's temporary file, and a worker may load, or
    leave on disk, a half-written library.  So a worker that has no
    engine rebuilds the library, one worker at a time, and loads it
    again."""
    if not jnative.available() and shutil.which("make") is not None:
        jb = jnative.bindings
        with open(jb._CPP_DIR / ".native_build.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            subprocess.run(["make", "-B", "-C", str(jb._CPP_DIR)],
                           capture_output=True, timeout=300)
        jb._LIB, jb._TRIED = None, False
        jnative.available()


@pytest.fixture(scope="module")
def priors():
    assert bindings.available() and jnative.available()
    return get_irdc_priors(vsys=0.0, device="cpu"), jax_priors(vsys=0.0)


def _pair(name):
    """``(port transformer, JAX transformer)`` of a constructor or of one
    of the prior classes of ``_prior_pairs``."""
    if name in CONSTRUCTORS:
        return getattr(pr, name)(device="cpu"), getattr(jax_pr, name)()
    jt, tt = prior_pair(name)
    return tt, jt


# the IRDC cases keep the ids they had before the other cases came
TABLE_CASES = (
    [pytest.param("get_irdc_priors", n, id=str(n)) for n in (1, 2, 3)]
    + [("get_irdc_priors", 4)]
    + [(c, n) for c in CONSTRUCTORS[1:] for n in (1, 2, 3, 4)]
    + [(k, n) for k in PRIOR_KINDS for n in (1, 2)])


@pytest.mark.parametrize("name,ncomp", TABLE_CASES)
def test_ppf_tables_bit_for_bit(name, ncomp):
    ut, ju = _pair(name)
    if (name, ncomp) in JAX_RAISES:
        with pytest.raises(NotImplementedError):
            jnative.bindings.ppf_tables_from_utrans(ju, ncomp)
        with pytest.raises(NotImplementedError):
            bindings.ppf_tables_from_utrans(ut, ncomp)
        return
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


@pytest.mark.parametrize("name,ncomp", [
    pytest.param("get_irdc_priors", 1, id="1"),
    pytest.param("get_irdc_priors", 2, id="2"),
    ("get_irdc_priors", 3), ("get_irdc_priors", 4),
    ("get_synth_priors", 1), ("get_synth_priors", 2)])
def test_transform_native_matches_jax_binding(name, ncomp):
    ut, ju = _pair(name)
    u = np.random.default_rng(7).uniform(0.02, 0.98,
                                         size=(256, ut.n_param * ncomp))
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


def _check_engine_gap(th, tc, ncomp, dist):
    """``th`` (a float32 transform) against the engine's ``tc``, both
    ``[n, 6 * ncomp]`` IRDC parameter vectors, under the bars above."""
    a, c = th.reshape(-1, 6, ncomp), tc.reshape(-1, 6, ncomp)
    assert np.abs(a[:, 1:] - c[:, 1:]).max() <= INDEP_ATOL
    va, vc = a[:, 0], c[:, 0]
    off = (vc < dist.xmin - dist.dx) | (vc > dist.xmax + dist.dx)
    assert np.array_equal(off, (va < dist.xmin - dist.dx)
                          | (va > dist.xmax + dist.dx))
    assert off.any(1).mean() <= OFF_GRID_SHARE
    np.testing.assert_allclose(va[off], vc[off], rtol=OFF_GRID_RTOL, atol=0)
    cells = np.abs(va[~off] - vc[~off]) / dist.dx
    assert cells.max() <= VOFF_MAX_CELLS[ncomp]
    assert np.median(cells) <= VOFF_MEDIAN_CELLS


# the ncomp 2 cases keep the ids they had before ncomp 3 and 4 came
ENGINE_CASES = ([pytest.param(2, s, id=str(s)) for s in range(4)]
                + [(n, s) for n in (3, 4) for s in range(4)])


@pytest.mark.parametrize("ncomp,seed", ENGINE_CASES)
def test_plain_transform_against_the_engine(priors, ncomp, seed):
    """The tolerance ``chip_smoke.py`` holds K2/K3 (and, at ncomp 4, the
    dense placement step) to against the engine: table sub-sampling on
    the independent dims, the two inversions of the tapered interval CDF
    on the centroids."""
    ut, _ = priors
    u = np.random.default_rng(seed).uniform(size=(4096, 6 * ncomp))
    u = u.astype(np.float32)
    th = ut.transform(torch.as_tensor(u), ncomp, plain=True).double()
    tc = bindings.transform_native(ut, ncomp, u.astype(np.float64))
    _check_engine_gap(th.numpy(), tc, ncomp, ut.priors[0].dist)


@pytest.mark.parametrize("ncomp,seed", [(n, s) for n in (3, 4)
                                        for s in range(4)])
def test_reference_transform_against_the_engine(priors, ncomp, seed):
    """The JAX package's own IRDC transform is as far from the engine as
    the port's, under the same bars: the gap is the reference's."""
    ut, ju = priors
    u = np.random.default_rng(seed).uniform(size=(4096, 6 * ncomp))
    u = u.astype(np.float32)
    tj = np.asarray(ju.transform(jnp.asarray(u), ncomp), dtype=np.float64)
    tc = bindings.transform_native(ut, ncomp, u.astype(np.float64))
    _check_engine_gap(tj, tc, ncomp, ut.priors[0].dist)


def test_build_goes_to_the_port_build_dir():
    path = bindings.build()
    assert path.parent == bindings.BUILD_DIR and path.exists()
    assert path.name.startswith("nestfit_native-")
