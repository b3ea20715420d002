"""Port parity: spectra, the NH3 model, kernel K1 (``hf_chi2_fused``) and
the runner's forward step, against the JAX package on the same inputs.

JAX runs on the CPU with the Pallas kernel in interpret mode, as its own
tests run it.  The port runs its plain PyTorch versions on the CPU
(``test_torch_kernels_gpu.py`` holds the CUDA kernel against them).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nestfit_tpu.models import AmmoniaRunner as JaxRunner
from nestfit_tpu.models import ammonia as jam
from nestfit_tpu.models.tables import AMMONIA_TRANSITIONS
from nestfit_tpu.ops import fused as jax_fused
from nestfit_tpu.priors import get_irdc_priors as jax_priors
from nestfit_tpu.utils import freq_axis_from_velocity

from nestfit_tpu_torch import convert
from nestfit_tpu_torch.models import AmmoniaRunner, ammonia as tam
from nestfit_tpu_torch.priors import get_irdc_priors

BASE = np.array([0.0, 12.0, 5.0, 14.5, 0.4, 0.1])


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(jax_fused, "INTERPRET", True)
    torch.set_num_threads(2)


def _xarr(trans_id, n_chan=380):
    nu = AMMONIA_TRANSITIONS[trans_id - 1].nu
    return freq_axis_from_velocity(np.linspace(-30, 30, n_chan), nu)


def _spectra(R, trans_id, seed=0):
    xarr = _xarr(trans_id)
    data = np.random.default_rng(seed).normal(scale=0.2, size=(R, 380))
    return (jam.make_ammonia_spectrum(xarr, data, 0.2, trans_id=trans_id),
            tam.make_ammonia_spectrum(xarr, data, 0.2, trans_id=trans_id,
                                      device="cpu"))


def _params(shape, ncomp, seed):
    rng = np.random.default_rng(seed)
    p = np.tile(np.repeat(BASE, ncomp), shape + (1,))
    return (p + rng.normal(scale=0.02, size=p.shape)).astype(np.float32)


@pytest.mark.parametrize("trans_id", [1, 2])
@pytest.mark.parametrize("ncomp", [1, 2])
def test_amm_predict_matches_jax(ncomp, trans_id):
    js, ts = _spectra(4, trans_id)
    for f in ("dnu", "data", "noise", "t0", "tbg"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)))
    assert (ts.rest_freq, ts.trans_id, ts.nu_chan, ts.size) == (
        js.rest_freq, js.trans_id, js.nu_chan, js.size)
    # the JAX spectrum carried across through convert.py
    cs = convert.spectrum_from_dict(
        {f.name: (np.asarray(getattr(js, f.name))
                  if f.name in ("dnu", "data", "noise", "t0", "tbg")
                  else getattr(js, f.name))
         for f in dataclasses.fields(js)}, device="cpu")
    for f in ("dnu", "data", "noise", "t0", "tbg"):
        assert torch.equal(getattr(cs, f), getattr(ts, f))
    p = _params((16,), ncomp, seed=10 + ncomp)
    want = np.asarray(jam.amm_predict(js, jnp.asarray(p)))
    got = tam.amm_predict(ts, torch.as_tensor(p)).numpy()
    # 1e-5 K absolute floor: the JAX side evaluates the level
    # populations in float64 under the tests' x64 mode
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("trans_id", [1, 2])
@pytest.mark.parametrize("ncomp", [1, 2])
def test_hf_chi2_plain_matches_jax_kernel(ncomp, trans_id):
    R, T = 4, 3
    js, ts = _spectra(R, trans_id, seed=trans_id)
    p = _params((T * R,), ncomp, seed=20 + ncomp)
    want = np.asarray(jam.fused_chi2(js, jnp.asarray(p)))
    got = tam.fused_chi2(ts, torch.as_tensor(p)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-3)


def test_runner_kernel_path_matches_plain_path():
    """The flat-row path (row b reads data row b % R, 1/(2 sigma^2)
    tiled) on the CPU, where the wrapper takes K1's plain version."""
    R = 4
    _, ts11 = _spectra(R, 1, seed=1)
    _, ts22 = _spectra(R, 2, seed=2)
    ts11 = dataclasses.replace(ts11, noise=torch.full((R,), 0.2))
    r = AmmoniaRunner((ts11, ts22), get_irdc_priors(device="cpu"), ncomp=2,
                      device="cpu")
    u = torch.as_tensor(np.random.default_rng(4).uniform(
        0.2, 0.8, size=(3, R, 12)).astype(np.float32))
    theta = r.transform(u)
    np.testing.assert_allclose(r._log_likelihood_fused(theta).numpy(),
                               r.log_likelihood(theta).numpy(),
                               rtol=2e-4, atol=5e-2)


@pytest.mark.parametrize("ncomp", [1, 2])
def test_loglike_unit_matches_jax(ncomp):
    R = 16
    js = [_spectra(R, t, seed=30 + t)[0] for t in (1, 2)]
    ts = [_spectra(R, t, seed=30 + t)[1] for t in (1, 2)]
    jr = JaxRunner(tuple(js), jax_priors(vsys=0.0), ncomp=ncomp)
    tr = AmmoniaRunner(tuple(ts), get_irdc_priors(device="cpu"),
                       ncomp=ncomp, device="cpu")
    u = np.random.default_rng(5).uniform(size=(2, R, 6 * ncomp)).astype(
        np.float32)
    np.testing.assert_allclose(
        tr.transform(torch.as_tensor(u)).numpy(),
        np.asarray(jr.transform(jnp.asarray(u))), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        tr.loglike_unit(torch.as_tensor(u)).numpy(),
        np.asarray(jr.loglike_unit(jnp.asarray(u))), rtol=2e-4, atol=5e-2)
    np.testing.assert_allclose(tr.null_lnZ.numpy(), np.asarray(jr.null_lnZ),
                               rtol=1e-6)


def test_hf_chi2_wrapper_rejects_bad_input():
    _, ts = _spectra(4, 1)
    p = torch.as_tensor(_params((6,), 1, seed=1))     # 6 rows, 4 data rows
    with pytest.raises(ValueError, match="multiple"):
        tam.fused_chi2(ts, p)

