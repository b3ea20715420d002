"""Port parity: the N2H+ (diazenylium) model, kernel K1's plain version on
its 15-, 40- and 45-line transitions, ``DiazenyliumRunner``, and an
ncomp-1 recovery through ``fit_batch``, against the JAX package on the
same inputs.

JAX runs on the CPU with the Pallas kernel in interpret mode, as its own
tests run it.  The port runs its plain PyTorch versions on the CPU
(``test_torch_kernels_gpu.py`` holds the CUDA kernel against them).
"""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nestfit_tpu import oracle as jax_oracle
from nestfit_tpu.models import DiazenyliumRunner as JaxRunner
from nestfit_tpu.models import diazenylium as jdz
from nestfit_tpu.ops import fused as jax_fused
from nestfit_tpu.priors import get_diazenylium_priors as jax_priors
from nestfit_tpu.utils import freq_axis_from_velocity

from nestfit_tpu_torch import oracle
from nestfit_tpu_torch.models import DiazenyliumRunner, diazenylium as tdz
from nestfit_tpu_torch.models.tables import (
    AMMONIA_TRANSITIONS,
    DIAZENYLIUM_TRANSITIONS,
)
from nestfit_tpu_torch.ops import _build, fused
from nestfit_tpu_torch.priors import get_diazenylium_priors
from nestfit_tpu_torch.sampling import NSConfig, fit_batch

# voff, tex, ltau, sigm for two components, parameter-major
PARAMS_2C = np.array([-0.5, 1.0, 5.0, 6.0, 0.2, 0.8, 0.25, 0.5])


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(jax_fused, "INTERPRET", True)
    torch.set_num_threads(2)


def _xarr(trans_id, vmax=20.0, vchan=0.1):
    return freq_axis_from_velocity(np.arange(-vmax, vmax, vchan),
                                   DIAZENYLIUM_TRANSITIONS[trans_id - 1].nu)


def _spectra(trans_id, data, noise=0.1, **kw):
    xarr = _xarr(trans_id)
    return (jdz.make_diazenylium_spectrum(xarr, data, noise,
                                          trans_id=trans_id, **kw),
            tdz.make_diazenylium_spectrum(xarr, data, noise,
                                          trans_id=trans_id, device="cpu"))


def _params(n, ncomp, seed):
    """``[n, 4*ncomp]`` parameter-major draws: voff, tex, ltau, sigm."""
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(-2, 2, (n, ncomp)),
                           rng.uniform(3, 11, (n, ncomp)),
                           rng.uniform(-1, 1, (n, ncomp)),
                           rng.uniform(0.1, 1.0, (n, ncomp))], axis=1)


def test_k1_line_cap_covers_every_transition():
    """``MAX_LINES`` mirrors ``kMaxLines`` in the CUDA source, and every
    NH3 and N2H+ transition fits under it (N2H+ (3-2) has 45 lines).
    The cap is the per-row line tables' dynamic shared memory: two rows
    of C = 8 components at 16 B a line may not pass the 48 KB a launch
    takes without opting in."""
    src = (_build.CSRC_DIR / fused.SOURCE).read_text()
    assert int(re.search(r"kMaxLines = (\d+);", src).group(1)) \
        == fused.MAX_LINES
    nhf = [t.nhf for t in AMMONIA_TRANSITIONS + DIAZENYLIUM_TRANSITIONS]
    assert max(nhf) == 45 and max(nhf) <= fused.MAX_LINES
    rows = int(re.search(r"kRowsPerBlock = (\d+);", src).group(1))
    assert rows * fused.MAX_COMP * fused.MAX_LINES * 16 <= 48 * 1024


@pytest.mark.parametrize("trans_id", [1, 2, 3])
def test_nnhp_predict_matches_jax(trans_id):
    n_chan = _xarr(trans_id).shape[0]
    js, ts = (f(_xarr(trans_id), np.zeros(n_chan), 0.1, trans_id=trans_id,
                **kw)
              for f, kw in ((jdz.make_diazenylium_spectrum,
                             dict(dtype=jnp.float64)),
                            (tdz.make_diazenylium_spectrum,
                             dict(dtype=torch.float64, device="cpu"))))
    p = np.concatenate([PARAMS_2C[None], _params(3, 2, seed=trans_id)])
    want = np.asarray(jdz.nnhp_predict(js, jnp.asarray(p)))
    got = tdz.nnhp_predict(ts, torch.as_tensor(p)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-6)
    truth = oracle.nnhp_predict(_xarr(trans_id), PARAMS_2C,
                                trans_id=trans_id)
    np.testing.assert_array_equal(
        truth, jax_oracle.nnhp_predict(_xarr(trans_id), PARAMS_2C,
                                       trans_id=trans_id))
    np.testing.assert_allclose(got[0], truth, rtol=1e-8, atol=1e-5)
    assert truth.max() > 0.1


@pytest.mark.parametrize("trans_id", [1, 3])
@pytest.mark.parametrize("ncomp", [1, 2])
def test_fused_chi2_plain_matches_jax_kernel(trans_id, ncomp):
    R, T = 2, 2
    data = np.random.default_rng(trans_id).normal(
        scale=0.1, size=(R, _xarr(trans_id).shape[0]))
    js, ts = _spectra(trans_id, data)
    p = _params(T * R, ncomp, seed=10 + ncomp).astype(np.float32)
    want = np.asarray(jdz.fused_chi2(js, jnp.asarray(p)))
    got = tdz.fused_chi2(ts, torch.as_tensor(p)).numpy()
    # chi2 sums ~400 float32 squared residuals
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-3)


@pytest.mark.parametrize("ncomp", [1, 2])
def test_loglike_unit_matches_jax(ncomp):
    R = 8
    sp = [_spectra(t, np.random.default_rng(20 + t).normal(
        scale=0.1, size=(R, _xarr(t).shape[0]))) for t in (1, 2)]
    jr = JaxRunner(tuple(s[0] for s in sp), jax_priors(vsys=0.0),
                   ncomp=ncomp)
    tr = DiazenyliumRunner(tuple(s[1] for s in sp),
                           get_diazenylium_priors(device="cpu"),
                           ncomp=ncomp, device="cpu")
    u = np.random.default_rng(9).uniform(size=(2, R, 4 * ncomp)).astype(
        np.float32)
    np.testing.assert_allclose(
        tr.transform(torch.as_tensor(u)).numpy(),
        np.asarray(jr.transform(jnp.asarray(u))), rtol=2e-5, atol=2e-5)
    # the float32 chi2 of ~400 channels, scaled by 1/(2 noise^2)
    want = np.asarray(jr.loglike_unit(jnp.asarray(u)))
    np.testing.assert_allclose(tr.loglike_unit(torch.as_tensor(u)).numpy(),
                               want, rtol=2e-4, atol=5e-2)
    theta = tr.transform(torch.as_tensor(u))
    np.testing.assert_allclose(tr._log_likelihood(theta, fused=True).numpy(),
                               want, rtol=2e-4, atol=5e-2)


def test_diazenylium_fit_recovery():
    """``tests/test_fit.py::test_diazenylium_fit_recovery`` on the port:
    the same inputs and bars."""
    rng = np.random.default_rng(12)
    noise = 0.1
    params = np.array([0.4, 6.0, 0.8, 0.35])  # voff, tex, ltau, sigm
    xarr = freq_axis_from_velocity(np.arange(-12, 12, 0.1),
                                   DIAZENYLIUM_TRANSITIONS[0].nu)
    truth = oracle.nnhp_predict(xarr, params, trans_id=1)
    data = truth + rng.normal(scale=noise, size=xarr.shape)
    spec = tdz.make_diazenylium_spectrum(xarr, data, noise, trans_id=1,
                                         device="cpu")
    runner = DiazenyliumRunner((spec,), get_diazenylium_priors(device="cpu"),
                               ncomp=1, device="cpu")
    gen = torch.Generator()
    gen.manual_seed(3)
    fit = fit_batch(gen, runner, 1, NSConfig(nlive=100, tol=0.5),
                    n_post=256, device="cpu")
    assert bool(fit.ns.converged[0])
    assert float(fit.lnz[0]) > float(fit.null_lnz[0]) + 11
    best = fit.products.bestfit_params[0].numpy()
    assert abs(best[0] - params[0]) < 0.2       # voff
    assert abs(best[3] - params[3]) < 0.2       # sigm
