"""Port parity of ``posterior_modes``: the JAX package's and the port's
mode separation on the same dead points (a JAX ``NSResult`` carried
across with ``convert.result_from_dict``), in float64; and the JAX
package's two mode tests on the port's own sampler."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import random

from nestfit_tpu.sampling import results as jres
from nestfit_tpu.sampling import sampler as js

import nestfit_tpu_torch
from nestfit_tpu_torch import convert
from nestfit_tpu_torch.sampling import results as tres
from nestfit_tpu_torch.sampling import sampler as ts

MU1, MU2 = 0.25, 0.75


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _bimodal_jax(sigma):
    def loglike(u):
        d1 = jnp.sum((u - MU1) ** 2, axis=-1)
        d2 = jnp.sum((u - MU2) ** 2, axis=-1)
        return jnp.logaddexp(-0.5 * d1 / sigma**2, -0.5 * d2 / sigma**2)
    return loglike


def _bimodal_torch(sigma):
    def loglike(u):
        d1 = torch.sum((u - MU1) ** 2, dim=-1)
        d2 = torch.sum((u - MU2) ** 2, dim=-1)
        return torch.logaddexp(-0.5 * d1 / sigma**2, -0.5 * d2 / sigma**2)
    return loglike


def _synthetic_result():
    """A JAX ``NSResult`` of numpy-made dead points: three Gaussian
    clusters of unequal mass in 3-D, weighted by the compression table."""
    rng = np.random.default_rng(7)
    R, L, D, n_dead = 3, 40, 3, 500
    max_iter = 600
    cents = np.array([[0.2, 0.2, 0.5], [0.8, 0.3, 0.5], [0.5, 0.8, 0.2]])
    pick = rng.choice(3, size=(R, max_iter + L), p=[0.5, 0.3, 0.2])
    u = np.clip(cents[pick] + rng.normal(0, 0.03, (R, max_iter + L, D)),
                0, 1)
    d2 = np.min(((u[..., None, :] - cents) ** 2).sum(-1), axis=-1)
    lnl = -0.5 * d2 / 0.03**2
    lnx, lnw = js._weight_tables(L, 10, max_iter)
    valid = np.broadcast_to(np.arange(max_iter) < n_dead, (R, max_iter))
    dead_lnl = np.where(valid, lnl[:, :max_iter], -1e30)
    dead_lnw = np.where(valid, lnw[None], -1e30)
    live_lnw = np.full((R, L), lnx[n_dead] - np.log(L))
    lnz = np.logaddexp.reduce(np.concatenate(
        [dead_lnw + dead_lnl, live_lnw + lnl[:, max_iter:]], 1), axis=1)
    f = lambda x: jnp.asarray(x, dtype=jnp.float64)  # noqa: E731
    return js.NSResult(
        lnz=f(lnz), lnz_err=f(np.full(R, 0.1)), h=f(np.ones(R)),
        lnl_shift=f(np.zeros(R)), n_dead=jnp.full((R,), n_dead, jnp.int32),
        ncall=jnp.full((R,), 1000, jnp.int32),
        converged=jnp.ones((R,), bool), dead_u=f(u[:, :max_iter]),
        dead_lnl=f(dead_lnl), dead_lnw=f(dead_lnw),
        live_u=f(u[:, max_iter:]), live_lnl=f(lnl[:, max_iter:]),
        live_lnw=f(live_lnw), max_loglike=f(lnl.max(1)), nlive=L, ndim=D,
        max_iter=max_iter)


@pytest.fixture(scope="module")
def jax_results():
    """The same dead points for both packages: a JAX run of the bimodal
    Gaussian, and the synthetic three-cluster set."""
    run = js.run_nested(random.key(4), _bimodal_jax(0.04), 2, 3,
                        js.NSConfig(nlive=100, tol=0.1, method="ellipsoid"),
                        dtype=jnp.float64)
    return {"bimodal run": run, "three clusters": _synthetic_result()}


def _to_port(jr):
    return convert.result_from_dict(
        {f.name: np.asarray(getattr(jr, f.name))
         for f in dataclasses.fields(jr)
         if f.name not in ("nlive", "ndim", "max_iter")}
        | {"nlive": jr.nlive, "ndim": jr.ndim, "max_iter": jr.max_iter},
        device="cpu")


@pytest.mark.parametrize("case", ["bimodal run", "three clusters"])
@pytest.mark.parametrize("ztol", [None, "between"])
def test_posterior_modes_match_jax(jax_results, case, ztol):
    """The same modes, members and local evidences, to float64 rounding
    (rtol 1e-8: the two frameworks sum in other orders)."""
    jr = jax_results[case]
    transform_j = lambda u: 4.0 * u - 1.0  # noqa: E731
    transform_t = lambda u: 4.0 * u - 1.0  # noqa: E731
    full = jres.posterior_modes(jr, transform_j, max_modes=4)
    z = None
    if ztol == "between":
        # a floor between the smallest and the largest local evidence
        mlnz = np.asarray(full.mode_lnz)
        fin = mlnz[np.isfinite(mlnz)]
        z = float(0.5 * (fin.min() + fin.max()))
    want = jres.posterior_modes(jr, transform_j, max_modes=4, ztol=z)
    got = tres.posterior_modes(_to_port(jr), transform_t, max_modes=4,
                               ztol=z)
    n_full = np.asarray(full.n_modes)
    assert n_full.min() >= 2
    if z is not None:     # the floor masks some modes and keeps others
        assert 0 < np.asarray(want.n_modes).sum() < n_full.sum()
    np.testing.assert_array_equal(got.n_modes.numpy(),
                                  np.asarray(want.n_modes))
    np.testing.assert_array_equal(got.membership.numpy(),
                                  np.asarray(want.membership))
    for f in ("mode_lnz", "mode_mean", "mode_sigma", "mode_map",
              "mode_frac"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   rtol=1e-8, atol=1e-12, err_msg=f)


def test_posterior_modes_in_row_slices(jax_results, monkeypatch):
    """A batch too wide for one pass goes through the mode separation in
    row slices: the same report, bit for bit."""
    pr = _to_port(jax_results["three clusters"])
    whole = tres.posterior_modes(pr, lambda u: u, max_modes=4)
    row_bytes = (pr.dead_u.shape[1] + pr.live_u.shape[1]) \
        * pr.dead_u.shape[2] * pr.dead_u.element_size()
    monkeypatch.setattr(tres, "_PRODUCTS_BYTES", row_bytes)
    sliced = tres.posterior_modes(pr, lambda u: u, max_modes=4)
    for f in dataclasses.fields(whole):
        assert torch.equal(getattr(sliced, f.name), getattr(whole, f.name)), \
            f.name


def test_posterior_modes_separation():
    """The JAX package's test on the port's traced sampler: a bimodal
    posterior decomposes into two modes whose local evidences sum to the
    global lnZ and split the mass evenly; a unimodal posterior reports a
    single mode."""
    posterior_modes = nestfit_tpu_torch.posterior_modes
    sigma, ndim = 0.04, 4
    g = torch.Generator().manual_seed(2)
    res = ts.run_nested(g, _bimodal_torch(sigma), ndim, 4,
                        ts.NSConfig(nlive=400, tol=0.1, method="ellipsoid"),
                        dtype=torch.float64, segment_iters=0)
    modes = posterior_modes(res, lambda u: u, max_modes=6)
    n_modes = modes.n_modes.numpy()
    assert np.all(n_modes == 2), n_modes
    frac = np.sort(modes.mode_frac.numpy(), axis=-1)[:, -2:]
    assert np.all(np.abs(frac - 0.5) < 0.15), frac
    # local evidences recombine to the global evidence
    mlnz = modes.mode_lnz.numpy()
    tot = np.logaddexp.reduce(np.where(np.isfinite(mlnz), mlnz, -1e30),
                              axis=-1)
    assert np.allclose(tot, res.lnz.numpy(), atol=1e-6)
    # mode means land on the two true centers (order-free)
    mm = modes.mode_mean.numpy()
    for r in range(mm.shape[0]):
        cents = np.sort(mm[r][np.isfinite(mlnz[r])][:, 0])
        assert np.allclose(cents, [MU1, MU2], atol=0.03), cents

    def gauss(u):
        return -0.5 * torch.sum((u - 0.5) ** 2, dim=-1) / 0.05**2

    res1 = ts.run_nested(torch.Generator().manual_seed(3), gauss, ndim, 4,
                         ts.NSConfig(nlive=200, tol=0.1),
                         dtype=torch.float64, segment_iters=0)
    modes1 = posterior_modes(res1, lambda u: u, max_modes=6)
    assert np.all(modes1.n_modes.numpy() == 1), modes1.n_modes


def test_posterior_modes_ztol():
    """MultiNest ``Ztol``: mode slots whose local evidence falls below
    ``ztol`` are masked from the report."""
    sigma, ndim, R = 0.04, 2, 2
    res = ts.run_nested(torch.Generator().manual_seed(4),
                        _bimodal_torch(sigma), ndim, R,
                        ts.NSConfig(nlive=200, tol=0.1, method="ellipsoid"),
                        dtype=torch.float64, segment_iters=0)
    full = tres.posterior_modes(res, lambda u: u, max_modes=4)
    n_full = full.n_modes.numpy()
    assert np.all(n_full == 2), n_full
    hi = float(full.mode_lnz.max())

    # floor above every local evidence: nothing reported
    none = tres.posterior_modes(res, lambda u: u, max_modes=4, ztol=hi + 1.0)
    assert np.all(none.n_modes.numpy() == 0)
    assert np.all(~np.isfinite(none.mode_lnz.numpy()))
    assert np.all(none.mode_frac.numpy() == 0.0)
    assert np.all(none.membership.numpy() == -1)

    # floor below every local evidence: identical report
    low = tres.posterior_modes(res, lambda u: u, max_modes=4, ztol=-1e8)
    assert np.all(low.n_modes.numpy() == n_full)
    assert np.allclose(low.mode_lnz.numpy(), full.mode_lnz.numpy())
