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

from nestfit_tpu import priors as jax_priors_mod
from nestfit_tpu.models import RUNNERS as JAX_RUNNERS
from nestfit_tpu.models import AmmoniaRunner as JaxRunner
from nestfit_tpu.models import ammonia as jam
from nestfit_tpu.models.tables import (
    AMMONIA_TRANSITIONS,
    DIAZENYLIUM_TRANSITIONS,
)
from nestfit_tpu.ops import fused as jax_fused
from nestfit_tpu.priors import get_irdc_priors as jax_priors
from nestfit_tpu.utils import freq_axis_from_velocity

from nestfit_tpu_torch import convert
from nestfit_tpu_torch import priors as priors_mod
from nestfit_tpu_torch.models import RUNNERS, AmmoniaRunner, ammonia as tam
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
    np.testing.assert_allclose(r._log_likelihood(theta, fused=True).numpy(),
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


#: per model: its prior constructor, its parameters per component and
#: the spectra's (velocity axis, rest frequency, trans_id, noise)
FROM_DATA = {
    "ammonia": ("get_irdc_priors", 6, [
        (np.linspace(-30, 30, 380), AMMONIA_TRANSITIONS[t - 1].nu, t, 0.2)
        for t in (1, 2)]),
    "gaussian": ("get_gaussian_priors", 3, [
        (np.arange(-12, 12, 0.158), 23.6944955e9, -1, 0.1)]),
    "diazenylium": ("get_diazenylium_priors", 4, [
        (np.arange(-20, 20, 0.1), DIAZENYLIUM_TRANSITIONS[t - 1].nu, t, 0.1)
        for t in (1, 3)]),
}


@pytest.mark.parametrize("ncomp", [1, 2])
@pytest.mark.parametrize("model", sorted(FROM_DATA))
def test_from_data_loglikelihood_matches_jax(model, ncomp):
    """``Runner.from_data`` of both packages on the same seeded
    ``(xarr, data, noise, trans_id)`` tuples, and ``loglikelihood``
    (NumPy in, NumPy out) on the same unit-cube points, at
    test_loglike_unit_matches_jax's tolerance; the port's is its
    ``loglike_unit``.  Without ``device="cpu"`` the port's runner is on
    the card, so it raises here."""
    R = 8
    prior, n_model, axes = FROM_DATA[model]
    rng = np.random.default_rng(40 + ncomp)
    spec_data = [(freq_axis_from_velocity(v, nu),
                  rng.normal(scale=noise, size=(R, v.size)), noise, tid)
                 for v, nu, tid, noise in axes]
    jr = JAX_RUNNERS[model].from_data(
        spec_data, getattr(jax_priors_mod, prior)(vsys=0.0), ncomp=ncomp)
    cls = RUNNERS[model]
    tr = cls.from_data(spec_data,
                       getattr(priors_mod, prior)(vsys=0.0, device="cpu"),
                       ncomp=ncomp, device="cpu")
    assert type(tr) is cls and tr.ncomp == ncomp
    assert tr.device == torch.device("cpu")
    for js, ts in zip(jr.spectra, tr.spectra, strict=True):
        for f in ("dnu", "data", "noise"):
            assert getattr(ts, f).device == tr.device
            np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                          np.asarray(getattr(js, f)))
        assert (ts.rest_freq, ts.trans_id) == (js.rest_freq, js.trans_id)
    u = rng.uniform(size=(2, R, n_model * ncomp)).astype(np.float32)
    got = tr.loglikelihood(u)
    assert isinstance(got, np.ndarray) and got.shape == (2, R)
    np.testing.assert_array_equal(
        got, tr.loglike_unit(torch.as_tensor(u)).numpy())
    np.testing.assert_allclose(got, jr.loglikelihood(u), rtol=2e-4,
                               atol=5e-2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            cls.from_data(spec_data, tr.utrans, ncomp=ncomp)


def test_hf_chi2_wrapper_rejects_bad_input():
    _, ts = _spectra(4, 1)
    p = torch.as_tensor(_params((6,), 1, seed=1))     # 6 rows, 4 data rows
    with pytest.raises(ValueError, match="multiple"):
        tam.fused_chi2(ts, p)



def test_iemtex_matches_jax():
    """``hyperfine.iemtex``, ``1/(exp(x) - 1)``, on both sides of the
    excitation range, in float32 and float64."""
    from nestfit_tpu.models import hyperfine as jhf
    from nestfit_tpu_torch.models import hyperfine as thf

    x = np.random.default_rng(3).uniform(1e-3, 40.0, 257)
    for dt, jdt in ((torch.float32, jnp.float32), (torch.float64,
                                                    jnp.float64)):
        got = thf.iemtex(torch.as_tensor(x, dtype=dt)).numpy()
        want = np.asarray(jhf.iemtex(jnp.asarray(x, dtype=jdt)))
        np.testing.assert_allclose(got, want, rtol=1e-6)
