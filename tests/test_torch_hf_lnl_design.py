"""K1's one-launch likelihood (``ops/fused.py::hf_lnl_fused``, the
models' ``fused_lnl``) on the CPU: its plain version against the runner's
per-transition path and against the JAX package's
``Runner.log_likelihood`` on the same parameters, for NH3 (1,1)+(2,2) and
N2H+ (1-0)+(3-2) at ncomp 1 and 2, ``B = T * R`` rows over per-row noise
with padding rows (the fitter's: copies of the first row); and the
runner's choice of path, with the counters that record it.
``test_torch_kernels_gpu.py`` holds the CUDA kernel against this plain
version.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nestfit_tpu.models import RUNNERS as JAX_RUNNERS
from nestfit_tpu.models import ammonia as jam
from nestfit_tpu.models import diazenylium as jdz
from nestfit_tpu.utils import freq_axis_from_velocity

from nestfit_tpu_torch.models import RUNNERS, ammonia, diazenylium
from nestfit_tpu_torch.models.tables import (
    AMMONIA_TRANSITIONS,
    DIAZENYLIUM_TRANSITIONS,
)
from nestfit_tpu_torch.ops import fused
from nestfit_tpu_torch.priors import (
    get_diazenylium_priors,
    get_gaussian_priors,
    get_irdc_priors,
)
from nestfit_tpu_torch.utils import profiling

#: per model: both packages' spectrum makers, the transitions, the
#: velocity axis, the noise scale and the port's prior
MODELS = {
    "ammonia": (jam.make_ammonia_spectrum, ammonia.make_ammonia_spectrum,
                AMMONIA_TRANSITIONS, (1, 2), np.linspace(-30, 30, 380), 0.2,
                get_irdc_priors),
    "diazenylium": (jdz.make_diazenylium_spectrum,
                    diazenylium.make_diazenylium_spectrum,
                    DIAZENYLIUM_TRANSITIONS, (1, 3),
                    np.arange(-20, 20, 0.1), 0.1, get_diazenylium_priors),
}
R_VALID, R, T = 5, 8, 3


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _case(model, ncomp, seed=0):
    """Both packages' spectra of ``model`` (``R`` rows: ``R_VALID``
    pixels of their own noise, then padding rows that copy the first),
    the port's runner and ``[T, R, ndim]`` parameters from its prior."""
    jmake, tmake, trans, tids, vel, noise, prior = MODELS[model]
    rng = np.random.default_rng(seed)
    pad = np.r_[np.arange(R_VALID), np.zeros(R - R_VALID, int)]
    js, ts = [], []
    for tid in tids:
        xarr = freq_axis_from_velocity(vel, trans[tid - 1].nu)
        data = rng.normal(scale=noise, size=(R_VALID, vel.size))[pad]
        sig = rng.uniform(0.7 * noise, 1.3 * noise, R_VALID)[pad]
        js.append(jmake(xarr, data, sig, trans_id=tid))
        ts.append(tmake(xarr, data, sig, trans_id=tid, device="cpu"))
    runner = RUNNERS[model](tuple(ts), prior(vsys=0.0, device="cpu"),
                            ncomp=ncomp, device="cpu")
    u = torch.as_tensor(rng.uniform(size=(T, R, runner.ndim)),
                        dtype=torch.float32)
    return js, runner, runner.transform(u)


def _split(monkeypatch, runner, theta):
    """The runner's per-transition path (``fused_chi2`` per spectrum,
    scaled and summed by the runner), with the counters it recorded."""
    with monkeypatch.context() as m:
        m.setattr(type(runner), "one_launch", False)
        with profiling.collect() as tr:
            lnl = runner._log_likelihood(theta, fused=True)
    return lnl, tr.counters


@pytest.mark.parametrize("ncomp", [1, 2])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_plain_one_launch_matches_the_split_path(monkeypatch, model, ncomp):
    """The plain version through the runner (one ``k1.lnl_fused`` call)
    against the per-transition path (one ``k1.lnl_split`` call a
    transition): the same float32 operations, so equal."""
    _, runner, theta = _case(model, ncomp)
    assert runner.one_launch
    with profiling.collect() as tr:
        got = runner._log_likelihood(theta, fused=True)
    assert tr.counters == {"k1.lnl_fused": 1}
    want, counts = _split(monkeypatch, runner, theta)
    assert counts == {"k1.lnl_split": 2}
    assert got.shape == (T, R) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # the entry on flat rows, and its padding rows repeat row 0's lnL
    # for row 0's parameters
    flat = theta.reshape(-1, theta.shape[-1])
    direct = runner.model.fused_lnl(runner.spectra, flat)
    assert torch.equal(direct, got.reshape(-1))
    th0 = theta.clone()
    th0[:, R_VALID:] = th0[:, :1]
    lnl0 = runner._log_likelihood(th0, fused=True)
    assert torch.equal(lnl0[:, R_VALID:],
                       lnl0[:, :1].expand(T, R - R_VALID))


@pytest.mark.parametrize("ncomp", [1, 2])
@pytest.mark.parametrize("model", sorted(MODELS))
def test_plain_one_launch_matches_jax_log_likelihood(model, ncomp):
    """Against the JAX package's ``Runner.log_likelihood`` on the same
    parameters, at K1's bar."""
    js, runner, theta = _case(model, ncomp, seed=1 + ncomp)
    jr = JAX_RUNNERS[model](tuple(js), None, ncomp=ncomp)
    want = np.asarray(jr.log_likelihood(jnp.asarray(theta.numpy())))
    got = runner._log_likelihood(theta, fused=True).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-3)


@pytest.mark.parametrize("why", ["two_slices", "cold", "lte"])
def test_runner_takes_the_split_path_where_one_launch_cannot(why):
    """A spectrum split into two channel slices (a mesh row of two
    devices) or a ``cold``/``lte`` flag keeps the per-transition path:
    ``k1.lnl_split`` a slice, no ``k1.lnl_fused``."""
    _, runner, theta = _case("ammonia", 2, seed=4)
    slices = 1
    if why == "two_slices":
        split = runner.placed(["cpu", "cpu"])
        slices = 2
        want = runner._log_likelihood(theta, fused=True)
        rtol = 2e-5          # the chi-square summed in two parts
    else:
        split = RUNNERS["ammonia"](runner.spectra, runner.utrans, ncomp=2,
                                   device="cpu", **{why: True})
        want = split.log_likelihood(theta)      # the model_predict path
        rtol = 2e-4
    assert not split.one_launch
    with profiling.collect() as tr:
        got = split._log_likelihood(theta, fused=True)
    assert tr.counters == {"k1.lnl_split": 2 * slices}
    torch.testing.assert_close(got, want, rtol=rtol, atol=1e-3)


def test_models_without_a_one_launch_entry_keep_their_kernel():
    """The Gaussian mixture has no ``fused_lnl``: its runner keeps K4."""
    from nestfit_tpu_torch.models import gaussian

    xarr = freq_axis_from_velocity(np.arange(-12, 12, 0.158), 23.6944955e9)
    spec = gaussian.make_gaussian_spectrum(xarr, np.zeros((2, xarr.size)),
                                           0.1, device="cpu")
    runner = RUNNERS["gaussian"](spec, get_gaussian_priors(device="cpu"),
                                 ncomp=1, device="cpu")
    assert not runner.one_launch


def test_one_launch_rejects_what_the_kernel_does_not_take():
    _, runner, theta = _case("diazenylium", 1)
    flat = theta.reshape(-1, theta.shape[-1])
    with pytest.raises(ValueError, match="multiple"):
        runner.model.fused_lnl(runner.spectra, flat[:-1])
    with pytest.raises(ValueError, match="multiple of 4"):
        runner.model.fused_lnl(runner.spectra, flat[:, :-1])
    short = dataclasses.replace(runner.spectra[1],
                                data=runner.spectra[1].data[:4])
    with pytest.raises(ValueError, match="data rows"):
        fused.hf_lnl_fused(diazenylium.lnl_model(),
                           (runner.spectra[0], short), flat)
