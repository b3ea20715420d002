"""Port parity: the Gaussian mixture model, kernel K4's plain version
(``gauss_chi2_plain``), ``GaussianRunner`` and ``fit_batch`` on it,
against the JAX package on the same inputs.

JAX runs on the CPU with the Pallas kernel in interpret mode, as its own
tests run it.  The port runs its plain PyTorch versions on the CPU
(``test_torch_kernels_gpu.py`` holds the CUDA kernel against them).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import random

from nestfit_tpu import oracle as jax_oracle
from nestfit_tpu.models import GaussianRunner as JaxRunner
from nestfit_tpu.models import MODELS as JAX_MODELS
from nestfit_tpu.models import gaussian as jga
from nestfit_tpu.ops import fused as jax_fused
from nestfit_tpu.priors import get_gaussian_priors as jax_priors
from nestfit_tpu.sampling import NSConfig as JaxConfig
from nestfit_tpu.sampling.fit import fit_batch as jax_fit_batch
from nestfit_tpu.utils import freq_axis_from_velocity

from nestfit_tpu_torch import oracle
from nestfit_tpu_torch.models import MODELS, RUNNERS, GaussianRunner
from nestfit_tpu_torch.models import gaussian as tga
from nestfit_tpu_torch.ops import fused
from nestfit_tpu_torch.priors import get_gaussian_priors
from nestfit_tpu_torch.sampling import NSConfig, fit_batch

REST = 23.6944955e9
METADATA = ("N", "IX_VCEN", "IX_SIGM", "NAME", "PAR_NAMES", "PAR_NAMES_SHORT",
            "TEX_LABELS", "TEX_LABELS_WITH_UNITS")


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(jax_fused, "INTERPRET", True)
    torch.set_num_threads(2)


def _xarr(vmax=12.0, vchan=0.158):
    return freq_axis_from_velocity(np.arange(-vmax, vmax, vchan), REST)


def _spectra(data, noise=0.1, **kw):
    xarr = _xarr()
    return (jga.make_gaussian_spectrum(xarr, data, noise, rest_freq=REST,
                                       **kw),
            tga.make_gaussian_spectrum(xarr, data, noise, rest_freq=REST,
                                       device="cpu"))


def _params(n, ncomp, seed):
    """``[n, 3*ncomp]`` parameter-major draws: voff, sigm, peak."""
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(-3, 3, (n, ncomp)),
                           rng.uniform(0.15, 1.0, (n, ncomp)),
                           rng.uniform(0.5, 3.0, (n, ncomp))], axis=1)


@pytest.mark.parametrize("name", ["ammonia", "diazenylium", "gaussian"])
def test_model_registry_and_metadata_match_jax(name):
    tm, jm = MODELS[name], JAX_MODELS[name]
    for attr in METADATA:
        assert getattr(tm, attr) == getattr(jm, attr), attr
    for ncomp in (None, 1, 3):
        assert tm.get_par_names(ncomp) == jm.get_par_names(ncomp)
    assert RUNNERS[name].model is tm
    assert len(tm.TRANSITIONS) == len(jm.TRANSITIONS)


def test_oracle_gauss_predict_matches_jax_oracle():
    xarr = _xarr()
    for p in _params(3, 2, seed=1):
        np.testing.assert_array_equal(oracle.gauss_predict(xarr, p, REST),
                                      jax_oracle.gauss_predict(xarr, p, REST))


@pytest.mark.parametrize("dtype,rtol,atol", [
    ("float64", 1e-8, 1e-6),
    ("float32", 1e-5, 1e-5),
])
def test_gauss_predict_matches_jax(dtype, rtol, atol):
    n_chan = _xarr().shape[0]
    js = jga.make_gaussian_spectrum(_xarr(), np.zeros(n_chan), 0.1,
                                    rest_freq=REST, dtype=getattr(jnp, dtype))
    ts = tga.make_gaussian_spectrum(_xarr(), np.zeros(n_chan), 0.1,
                                    rest_freq=REST,
                                    dtype=getattr(torch, dtype), device="cpu")
    p = _params(8, 2, seed=2).astype(dtype)
    want = np.asarray(jga.gauss_predict(js, jnp.asarray(p)))
    got = tga.gauss_predict(ts, torch.as_tensor(p)).numpy()
    # float32: the relative-axis form rounds dnu and voff*f in float32 in
    # both packages, in a different operation order
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    if dtype == "float64":
        truth = oracle.gauss_predict(_xarr(), p[0], REST)
        np.testing.assert_allclose(got[0], truth, rtol=1e-8, atol=1e-6)


@pytest.mark.parametrize("ncomp", [1, 2, 3])
def test_gauss_chi2_plain_matches_jax_kernel(ncomp):
    R, T = 3, 2
    data = np.random.default_rng(3).normal(scale=0.1,
                                           size=(R, _xarr().shape[0]))
    js, ts = _spectra(data)
    p = _params(T * R, ncomp, seed=4 + ncomp).astype(np.float32)
    want = np.asarray(jga.fused_chi2(js, jnp.asarray(p)))
    got = tga.fused_chi2(ts, torch.as_tensor(p)).numpy()
    # chi2 sums ~150 float32 squared residuals of O(1) K^2
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-3)
    voff, sigm, peak = (torch.as_tensor(p[:, i * ncomp:(i + 1) * ncomp])
                        for i in range(3))
    direct = fused.gauss_chi2_plain(REST / 299792.458, ts.dnu, ts.data,
                                    voff, sigm, peak)
    np.testing.assert_allclose(direct.numpy(), want, rtol=2e-4, atol=1e-3)


def test_gauss_chi2_wrapper_rejects_bad_input():
    data = np.zeros((4, _xarr().shape[0]))
    _, ts = _spectra(data)
    p = torch.as_tensor(_params(6, 1, seed=1), dtype=torch.float32)
    with pytest.raises(ValueError, match="multiple"):
        tga.fused_chi2(ts, p)              # 6 rows against 4 data rows


@pytest.mark.parametrize("ncomp", [1, 2])
def test_loglike_unit_matches_jax(ncomp):
    R = 8
    data = np.random.default_rng(6).normal(scale=0.3,
                                           size=(R, _xarr().shape[0]))
    js, ts = _spectra(data, noise=0.3)
    jr = JaxRunner(js, jax_priors(vsys=0.0), ncomp=ncomp)
    tr = GaussianRunner(ts, get_gaussian_priors(device="cpu"), ncomp=ncomp,
                        device="cpu")
    u = np.random.default_rng(7).uniform(size=(3, R, 3 * ncomp)).astype(
        np.float32)
    np.testing.assert_allclose(
        tr.transform(torch.as_tensor(u)).numpy(),
        np.asarray(jr.transform(jnp.asarray(u))), rtol=2e-5, atol=2e-5)
    # the float32 chi2 of ~150 channels, scaled by 1/(2 noise^2)
    want = np.asarray(jr.loglike_unit(jnp.asarray(u)))
    np.testing.assert_allclose(tr.loglike_unit(torch.as_tensor(u)).numpy(),
                               want, rtol=2e-4, atol=5e-2)
    # the flat-row path the card takes, here through K4's plain version
    theta = tr.transform(torch.as_tensor(u))
    np.testing.assert_allclose(tr._log_likelihood_fused(theta).numpy(),
                               want, rtol=2e-4, atol=5e-2)
    np.testing.assert_allclose(tr.null_lnZ.numpy(), np.asarray(jr.null_lnZ),
                               rtol=1e-6)


# ---- fit_batch end to end ------------------------------------------------
# Two one-component and two two-component truth pixels; the batch holds
# two copies of each and the better run of each pair is compared (the
# remedy for mode loss recorded in tests/test_torch_fit.py).
N_PIX, NOISE = 4, 0.3
TRUTH = [np.array([0.3, 0.5, 2.0]), np.array([-1.0, 0.7, 1.5]),
         np.array([-2.0, 2.0, 0.4, 0.5, 2.0, 1.5]),
         np.array([-1.5, 1.0, 0.6, 0.4, 1.2, 2.2])]


@pytest.fixture(scope="module")
def gauss_cube():
    xarr = _xarr()
    rng = np.random.default_rng(8)
    data = np.stack([oracle.gauss_predict(xarr, p, REST) for p in TRUTH])
    data = data + rng.normal(scale=NOISE, size=data.shape)
    return xarr, np.tile(data, (2, 1))


def _better_of_two(lnz, err):
    lnz, err = np.asarray(lnz).reshape(2, N_PIX), \
        np.asarray(err).reshape(2, N_PIX)
    pick = lnz.argmax(axis=0)
    cols = np.arange(N_PIX)
    return lnz[pick, cols], err[pick, cols]


def test_fit_batch_matches_jax_and_ladder_decision(gauss_cube):
    xarr, data = gauss_cube
    R = data.shape[0]
    kw = dict(nlive=50, tol=1.0, init_factor=4)
    js = dataclasses.replace(
        jga.make_gaussian_spectrum(xarr, data, NOISE, rest_freq=REST),
        noise=jnp.full((R,), NOISE, dtype=jnp.float32))
    ts = tga.make_gaussian_spectrum(xarr, data, np.full(R, NOISE),
                                    rest_freq=REST, device="cpu")
    lnz = {}
    for ncomp in (1, 2):
        jfit = jax_fit_batch(random.key(ncomp),
                             JaxRunner(js, jax_priors(vsys=0.0), ncomp=ncomp),
                             R, JaxConfig(**kw), segment_iters=250)
        gen = torch.Generator()
        gen.manual_seed(ncomp)
        runner = GaussianRunner(ts, get_gaussian_priors(device="cpu"),
                                ncomp=ncomp, device="cpu")
        tfit = fit_batch(gen, runner, R, NSConfig(**kw), segment_iters=250,
                         device="cpu")
        assert tfit.ns.converged.all() and np.asarray(jfit.ns.converged).all()
        lnz_p, err_p = _better_of_two(tfit.lnz.numpy(), tfit.lnz_err.numpy())
        lnz_j, err_j = _better_of_two(jfit.lnz, jfit.lnz_err)
        bar = 4 * np.sqrt(err_p**2 + err_j**2) + 0.5
        assert np.all(np.abs(lnz_p - lnz_j) <= bar), (ncomp, lnz_p, lnz_j)
        np.testing.assert_allclose(tfit.null_lnz.numpy(),
                                   np.asarray(jfit.null_lnz), rtol=1e-6)
        assert torch.isfinite(tfit.products.bestfit_params).all()
        lnz[ncomp] = (lnz_p, lnz_j)
    # the Bayes-factor ladder: a second component is kept at dlnZ > 11
    keep_p = lnz[2][0] - lnz[1][0] > 11.0
    keep_j = lnz[2][1] - lnz[1][1] > 11.0
    np.testing.assert_array_equal(keep_p, keep_j)
    np.testing.assert_array_equal(keep_p, [False, False, True, True])
