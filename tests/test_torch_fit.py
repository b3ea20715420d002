"""Port parity end to end: ``fit_batch`` of both packages on the same
synthetic NH3 (1,1)+(2,2) pixels, and the port's device rules.

The two samplers draw from different random streams, so evidences are
compared per pixel within their combined errors (plus 0.5 nat for the
sampler's own systematic); fixed seeds make both runs deterministic.

At nlive 50 and noise 0.4 a 2-component evidence is often bimodal: a
run that loses the weaker mode lands several nats low, in either
package.  Measured on the CPU: one JAX run against another with a
different key fails that per-pixel bar at ncomp 2 on 4 of 5 cubes.  So
each package fits every pixel twice (the batch holds two copies of the
4 pixels) and the better run of each pair is compared -- the nested
sampler's own remedy for mode loss, a repeated run.
"""

import dataclasses
import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import random

from nestfit_tpu import synth as jsynth
from nestfit_tpu.models import AmmoniaRunner as JaxRunner
from nestfit_tpu.models import ammonia as jam
from nestfit_tpu.priors import get_irdc_priors as jax_priors
from nestfit_tpu.sampling import NSConfig as JaxConfig
from nestfit_tpu.sampling.fit import fit_batch as jax_fit_batch
from nestfit_tpu.sampling.fit import fit_single as jax_fit_single
from nestfit_tpu.sampling.sampler import run_nested as jax_run_nested

from nestfit_tpu_torch import synth
from nestfit_tpu_torch.models import AmmoniaRunner, ammonia
from nestfit_tpu_torch.priors import get_irdc_priors
from nestfit_tpu_torch.sampling import NSConfig, fit_batch, fit_single
from nestfit_tpu_torch.sampling.sampler import run_nested

N_PIX, NOISE = 4, 0.4
R = 2 * N_PIX          # two copies of every pixel


@pytest.fixture(scope="module")
def cube():
    (xa11, d11), (xa22, d22), p = jsynth.make_synth_cube_arrays(
        n_pix=N_PIX, noise=NOISE, rng=np.random.default_rng(1))
    return (xa11, np.tile(d11, (2, 1))), (xa22, np.tile(d22, (2, 1))), p


def _better_of_two(lnz, err):
    lnz, err = np.asarray(lnz).reshape(2, N_PIX), \
        np.asarray(err).reshape(2, N_PIX)
    pick = lnz.argmax(axis=0)
    cols = np.arange(N_PIX)
    return lnz[pick, cols], err[pick, cols]


def _jax_runner(cube, ncomp):
    (xa11, d11), (xa22, d22), _ = cube
    spectra = []
    for xa, d, tid in ((xa11, d11, 1), (xa22, d22, 2)):
        spec = jam.make_ammonia_spectrum(xa, d, NOISE, trans_id=tid)
        spectra.append(dataclasses.replace(
            spec, noise=jnp.full((R,), NOISE, dtype=jnp.float32)))
    return JaxRunner(spectra, jax_priors(vsys=0.0), ncomp=ncomp)


def _port_runner(cube, ncomp, device="cpu"):
    (xa11, d11), (xa22, d22), _ = cube
    spectra = [ammonia.make_ammonia_spectrum(xa, d, np.full(R, NOISE),
                                             trans_id=tid, device=device)
               for xa, d, tid in ((xa11, d11, 1), (xa22, d22, 2))]
    return AmmoniaRunner(spectra, get_irdc_priors(device=device),
                         ncomp=ncomp, device=device)


def test_synth_cube_matches_jax():
    got = synth.make_synth_cube_arrays(n_pix=16, noise=NOISE,
                                       rng=np.random.default_rng(3))
    want = jsynth.make_synth_cube_arrays(n_pix=16, noise=NOISE,
                                         rng=np.random.default_rng(3))
    for x, y in zip((*got[0], *got[1], got[2]),
                    (*want[0], *want[1], want[2])):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("ncomp", [1, 2])
def test_fit_batch_matches_jax(cube, ncomp):
    torch.set_num_threads(2)
    kw = dict(nlive=50, tol=1.0, init_factor=4)
    jfit = jax_fit_batch(random.key(ncomp), _jax_runner(cube, ncomp), R,
                         JaxConfig(**kw), segment_iters=250)
    gen = torch.Generator()
    gen.manual_seed(ncomp)
    tfit = fit_batch(gen, _port_runner(cube, ncomp), R, NSConfig(**kw),
                     segment_iters=250, device="cpu")
    assert tfit.ns.converged.all() and np.asarray(jfit.ns.converged).all()
    lnz_p, err_p = _better_of_two(tfit.lnz.numpy(), tfit.lnz_err.numpy())
    lnz_j, err_j = _better_of_two(jfit.lnz, jfit.lnz_err)
    bar = 4 * np.sqrt(err_p**2 + err_j**2) + 0.5
    assert np.all(np.abs(lnz_p - lnz_j) <= bar), (lnz_p, lnz_j, bar)
    np.testing.assert_allclose(tfit.null_lnz.numpy(),
                               np.asarray(jfit.null_lnz), rtol=1e-6)
    for f in ("posteriors", "marginals", "bestfit_params", "map_params"):
        assert getattr(tfit.products, f).shape == \
            getattr(jfit.products, f).shape, f
    assert torch.isfinite(tfit.products.bestfit_params).all()
    for k in ("BIC", "AIC", "AICc", "null_BIC", "null_AIC", "null_AICc"):
        assert tfit.ics[k].shape == (R,)


def test_default_device_needs_a_card(cube):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    (xa11, d11), _, _ = cube
    with pytest.raises(RuntimeError, match="cuda"):
        ammonia.make_ammonia_spectrum(xa11, d11, NOISE, trans_id=1)
    runner = _port_runner(cube, 1)
    with pytest.raises(RuntimeError, match="cuda"):
        AmmoniaRunner(runner.spectra, runner.utrans, ncomp=1)
    with pytest.raises(RuntimeError, match="cuda"):
        fit_batch(torch.Generator(), runner, R, NSConfig(nlive=20))



def test_sampler_defaults_match_jax():
    """``fit_batch``, ``run_nested`` and ``fit_single`` default to the
    JAX package's sampler mode, the traced one, and ``fit_single`` to its
    single-fit config."""
    for port, ref in ((fit_batch, jax_fit_batch),
                      (run_nested, jax_run_nested)):
        got = inspect.signature(port).parameters["segment_iters"].default
        want = inspect.signature(ref).parameters["segment_iters"].default
        assert got == want == 0, port.__name__
    got = inspect.signature(fit_single).parameters["config"].default
    want = inspect.signature(jax_fit_single).parameters["config"].default
    assert (got.nlive, got.tol) == (want.nlive, want.tol) == (400, 0.5)


def _leaves(obj, where=""):
    """``{path: tensor}`` of a ``FitResult``'s tensors."""
    if isinstance(obj, torch.Tensor):
        return {where: obj}
    if isinstance(obj, dict):
        items = obj.items()
    elif dataclasses.is_dataclass(obj):
        items = ((f.name, getattr(obj, f.name))
                 for f in dataclasses.fields(obj))
    else:
        return {}
    return {k: v for name, o in items
            for k, v in _leaves(o, f"{where}.{name}").items()}


def test_fit_single_is_the_traced_fit_batch(cube):
    """``fit_single`` is ``fit_batch`` of one run in the traced mode, bit
    for bit, from generators seeded alike."""
    torch.set_num_threads(2)
    (xa11, d11), (xa22, d22), _ = cube
    spectra = [ammonia.make_ammonia_spectrum(xa, d[:1], np.full(1, NOISE),
                                             trans_id=tid, device="cpu")
               for xa, d, tid in ((xa11, d11, 1), (xa22, d22, 2))]
    runner = AmmoniaRunner(spectra, get_irdc_priors(device="cpu"), ncomp=1,
                           device="cpu")
    cfg = NSConfig(nlive=50, tol=1.0, init_factor=4)
    one = fit_single(torch.Generator().manual_seed(4), runner, cfg,
                     device="cpu")
    batch = fit_batch(torch.Generator().manual_seed(4), runner, 1, cfg,
                      segment_iters=0, device="cpu")
    assert bool(one.ns.converged[0]) and one.lnz.shape == (1,)
    got, want = _leaves(one), _leaves(batch)
    assert set(got) == set(want) and ".ns.lnz" in got
    for k in want:
        assert torch.equal(got[k], want[k]), k
