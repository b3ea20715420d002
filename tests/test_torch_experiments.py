"""The port's SNR sweep (``nestfit_tpu_torch/experiments/varnoise.py``)
against the JAX package's on the same spectra, at toy size on the CPU:
the same keys and shapes, the same noise, the same null evidences, and
the same component counts wherever the JAX sweep's decision is clear of
the run-to-run evidence scatter (ROADMAP's "not faults": 3-4 nats on
bimodal two-component pixels)."""

import numpy as np
import pytest
import torch

from nestfit_tpu.experiments.varnoise import run_varnoise_sweep as jax_sweep
from nestfit_tpu.priors import get_irdc_priors as jax_priors

from nestfit_tpu_torch.experiments import run_varnoise_sweep
from nestfit_tpu_torch.priors import get_irdc_priors

SWEEP = dict(snr_levels=np.array([1.0, 20.0]), n_per_level=2, ncomp_max=2,
             nlive=20, tol=1.0, seed=7, vchan=0.6)
SCATTER = 4.0    # nats


@pytest.fixture(scope="module")
def sweeps():
    torch.set_num_threads(2)
    port = run_varnoise_sweep(get_irdc_priors(vsys=0.0, device="cpu"),
                              device="cpu", **SWEEP)
    # the JAX sweep in its segmented mode (the traced one compiles longer)
    jax = jax_sweep(jax_priors(vsys=0.0), segment_iters=100, **SWEEP)
    return port, jax


def test_keys_shapes_and_spectra(sweeps):
    port, jax = sweeps
    assert set(port) == set(jax)
    for k in jax:
        assert port[k].shape == np.shape(jax[k]), k
    np.testing.assert_array_equal(port["snr"], jax["snr"])
    np.testing.assert_array_equal(port["noise"], jax["noise"])
    np.testing.assert_allclose(port["lnz"][..., 0], jax["lnz"][..., 0],
                               rtol=1e-5)
    assert np.isfinite(port["lnz"]).all() and np.isfinite(port["bic"]).all()


def test_nbest_lnz_where_clear(sweeps):
    port, jax = sweeps
    lnz, err = jax["lnz"], jax["lnz_err"]
    err = np.nan_to_num(err)
    step = np.diff(lnz, axis=-1)
    comb = np.sqrt(err[..., 1:] ** 2 + err[..., :-1] ** 2
                   + np.nan_to_num(port["lnz_err"][..., 1:]) ** 2)
    clear = np.all(np.abs(step - 11.0) > SCATTER + 3 * comb, axis=-1)
    assert clear.sum() >= clear.size // 2, (step, comb)
    np.testing.assert_array_equal(port["nbest_lnz"][clear],
                                  jax["nbest_lnz"][clear])
    # low SNR keeps fewer components than high SNR in both
    assert port["nbest_lnz"][0].max() <= port["nbest_lnz"][-1].min()


@pytest.mark.parametrize("crit", ["bic", "aicc"])
def test_nbest_information_criteria_where_clear(sweeps, crit):
    port, jax = sweeps
    vals = np.sort(jax[crit], axis=-1)
    clear = vals[..., 1] - vals[..., 0] > 2 * SCATTER
    assert clear.any()
    np.testing.assert_array_equal(port[f"nbest_{crit}"][clear],
                                  jax[f"nbest_{crit}"][clear])
