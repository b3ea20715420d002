"""The port's traced mode (``run_nested(segment_iters=0)``): the JAX
package's analytic bars, agreement with the port's segmented sampler and
with the JAX package's traced ``fit_batch``, the static-state block loop
of ``graphs.run_traced`` against the plain block loop, and born-done
rows.

On the CPU ``graphs.run_traced`` runs its blocks without capture; the
CUDA graph path is held against the eager blocks on the card
(``tests/test_torch_graphs_gpu.py`` and ``chip_smoke.py`` phase
*traced*).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import random

from nestfit_tpu.sampling.fit import fit_batch as jax_fit_batch
from nestfit_tpu.sampling import NSConfig as JaxConfig

from nestfit_tpu_torch.sampling import NSConfig, fit_batch, graphs
from nestfit_tpu_torch.sampling import sampler as ts

from test_torch_fit import R, _better_of_two, _jax_runner, _port_runner
from test_torch_fit import cube  # noqa: F401  (fixture)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _gauss(sigma, mu=0.5):
    def loglike(u):
        return -0.5 * torch.sum((u - mu) ** 2, dim=-1) / sigma**2
    return loglike


@pytest.mark.parametrize("method", ["slice", "ellipsoid"])
@pytest.mark.parametrize("ndim,sigma", [(2, 0.05), (6, 0.05)])
def test_gaussian_evidence_traced(ndim, sigma, method):
    """The cases and bars of the JAX package's test_gaussian_evidence
    (its traced mode), in float64."""
    R = 8
    res = ts.run_nested(torch.Generator().manual_seed(0), _gauss(sigma),
                        ndim, R, NSConfig(nlive=200, tol=0.1, method=method),
                        dtype=torch.float64, segment_iters=0)
    lnz_true = 0.5 * ndim * np.log(2 * np.pi * sigma**2)
    lnz = res.lnz.numpy()
    err = res.lnz_err.numpy()
    assert res.converged.all()
    assert np.all(np.abs(lnz - lnz_true) < 4 * np.maximum(err, 0.05)), (
        lnz, lnz_true, err)
    assert abs(lnz.mean() - lnz_true) < 2 * err.mean() / np.sqrt(R) + 0.08
    h_true = -lnz_true - 0.5 * ndim
    assert np.all(np.abs(res.h.numpy() - h_true) < 0.15 * abs(h_true) + 1.0)


def test_traced_agrees_with_segmented():
    """The JAX package holds its segmented ``method="ellipsoid"`` run
    equal to its traced one (test_segmented_matches_traced).  Here the
    traced block's slice fill draws random numbers even when nothing is
    pending, so the two random streams part after the first block and
    the contract holds statistically: per run within combined errors,
    and the batch means within their standard error."""
    ndim, sigma, R = 4, 0.06, 8
    cfg = NSConfig(nlive=100, tol=0.3, method="ellipsoid")
    traced = ts.run_nested(torch.Generator().manual_seed(9), _gauss(sigma),
                           ndim, R, cfg, dtype=torch.float64,
                           segment_iters=0)
    seg = ts.run_nested(torch.Generator().manual_seed(9), _gauss(sigma),
                        ndim, R, cfg, dtype=torch.float64, segment_iters=137)
    assert traced.converged.all() and seg.converged.all()
    d = traced.lnz.numpy() - seg.lnz.numpy()
    comb = np.sqrt(traced.lnz_err.numpy() ** 2 + seg.lnz_err.numpy() ** 2)
    assert np.all(np.abs(d) < 4 * comb), (d, comb)
    assert abs(d.mean()) < 2 * comb.mean() / np.sqrt(R) + 0.05, d
    lnz_true = 0.5 * ndim * np.log(2 * np.pi * sigma**2)
    assert abs(traced.lnz.numpy().mean() - lnz_true) < 0.15


def _init(cfg, ndim, R, seed, loglike, dtype=torch.float64, active=None):
    gen = torch.Generator().manual_seed(seed)
    ll2 = ts._normalize_loglike(loglike, None)
    if cfg.log_zero > -1e60:
        ll2 = ts._floored(ll2, cfg.log_zero)
    st = ts._apply_active(ts.ns_init(gen, ll2, None, ndim, R, cfg, dtype),
                          active)
    return st, ll2


@pytest.mark.parametrize("kw", [
    {},
    {"method": "slice"},
    {"method": "slice", "bound_every": 3, "max_iter": 61, "tol": 1e-3,
     "flat_dims": (1,)},
    {"pwrap_dims": (0,), "efr": 0.5},
    {"ceff": True, "init_factor": 2},
    {"log_zero": -20.0},
], ids=["default", "slice", "phases+tail", "pwrap+efr", "ceff", "log_zero"])
def test_static_state_loop_equals_plain_loop(kw):
    """``graphs.run_traced`` (blocks read and write one static state, the
    dead buffers in place; on the CPU without capture) against the plain
    block loop ``ns_traced``: bit for bit, with bound-refresh phases that
    differ between blocks and a short last block."""
    ndim, R = 3, 5
    cfg = NSConfig(**({"nlive": 40, "tol": 0.5} | kw))
    ll = _gauss(0.08, mu=torch.tensor([0.03, 0.5, 0.6], dtype=torch.float64))
    st_a, ll2 = _init(cfg, ndim, R, 3, ll)
    st_b, _ = _init(cfg, ndim, R, 3, ll)
    plain = ts.ns_finalize(ts.ns_traced(st_a, ll2, None, cfg), cfg)
    static = ts.ns_finalize(graphs.run_traced(st_b, ll2, None, cfg), cfg)
    for f in dataclasses.fields(plain):
        a, b = getattr(plain, f.name), getattr(static, f.name)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), f.name
        else:
            assert a == b, f.name
    stats = graphs.last_stats
    assert stats.blocks > 1 and stats.replays == 0
    assert stats.done_reads == stats.blocks + 1
    if "max_iter" in kw:    # the budget ends the run inside a short block
        assert stats.blocks == -(-kw["max_iter"] // cfg.block_iters)
        assert plain.n_dead.max() == kw["max_iter"]


def test_inactive_rows_are_born_done():
    """Rows marked inactive pay the initial evaluations only and stay as
    ``ns_init`` left them; the others converge."""
    ndim, R = 2, 6
    active = np.array([True, False, True, True, False, True])
    cfg = NSConfig(nlive=50, tol=0.3)
    res = ts.run_nested(torch.Generator().manual_seed(1), _gauss(0.05),
                        ndim, R, cfg, dtype=torch.float64, segment_iters=0,
                        active=active)
    assert res.converged.numpy()[active].all()
    assert not res.converged.numpy()[~active].any()
    assert (res.n_dead.numpy()[~active] == 0).all()
    assert (res.ncall.numpy()[~active] == cfg.nlive).all()
    assert (res.n_dead.numpy()[active] > 100).all()
    lnz_true = 0.5 * ndim * np.log(2 * np.pi * 0.05**2)
    assert np.all(np.abs(res.lnz.numpy()[active] - lnz_true) < 0.8)


def _copies(x):
    return np.asarray(x).reshape(2, -1)


@pytest.mark.parametrize("call", ["segment_iters=0", "defaults"])
def test_fit_batch_traced_matches_jax(cube, call):  # noqa: F811
    """``fit_batch`` of both packages in the traced mode, asked for with
    ``segment_iters=0`` or called at their defaults (the traced mode in
    both), on the same NH3 pixels (two copies of each in the batch),
    rungs 1 and 2.

    Rung 1 is unimodal: the better of each package's two runs agree
    within combined errors, as in test_fit_batch_matches_jax.  At rung 2
    and nlive 50 one pixel's evidence is bimodal (about -470 and -505),
    and the traced mode of either package often loses its upper mode
    (measured on the CPU: in 5 of 6 port runs and 7 of 10 JAX runs over
    different seeds; the segmented mode in 2 of 6), so there each
    pixel's outcome must be one the reference gives: some run of the
    port within combined errors of some run of the JAX package.  The
    ladder decision (lnZ gains against 11) agrees wherever both
    packages' runs clear the threshold by 3 nats and agree among
    themselves."""
    kw = dict(nlive=50, tol=1.0, init_factor=4)
    mode = {"segment_iters": 0} if call == "segment_iters=0" else {}
    runs = {"port": {}, "jax": {}}
    for ncomp in (1, 2):
        jfit = jax_fit_batch(random.key(ncomp), _jax_runner(cube, ncomp), R,
                             JaxConfig(**kw), **mode)
        graphs.last_stats = graphs.TracedStats()
        tfit = fit_batch(torch.Generator().manual_seed(ncomp),
                         _port_runner(cube, ncomp), R, NSConfig(**kw),
                         device="cpu", **mode)
        assert graphs.last_stats.blocks > 0     # the traced block loop ran
        assert tfit.ns.converged.all() and np.asarray(jfit.ns.converged).all()
        np.testing.assert_allclose(tfit.null_lnz.numpy(),
                                   np.asarray(jfit.null_lnz), rtol=1e-6)
        assert torch.isfinite(tfit.products.posteriors).all()
        zp, ep = _copies(tfit.lnz.numpy()), _copies(tfit.lnz_err.numpy())
        zj, ej = _copies(jfit.lnz), _copies(jfit.lnz_err)
        runs["port"][ncomp], runs["jax"][ncomp] = zp, zj
        if ncomp == 1:
            best_p, err_p = _better_of_two(zp, ep)
            best_j, err_j = _better_of_two(zj, ej)
            bar = 4 * np.sqrt(err_p**2 + err_j**2) + 0.5
            assert np.all(np.abs(best_p - best_j) <= bar), (best_p, best_j,
                                                            bar)
        else:
            d = np.abs(zp[:, None] - zj[None, :])            # [2, 2, pix]
            bar = 4 * np.sqrt(ep[:, None] ** 2 + ej[None, :] ** 2) + 0.5
            assert np.all((d <= bar).any(axis=(0, 1))), (zp, zj)
    null = _copies(jfit.null_lnz)[0]

    def decisions(z):
        """nbest and the smallest margin of its gains to 11, for every
        pairing of a rung-1 run with a rung-2 run: [4, pix]."""
        z1 = np.repeat(z[1], 2, axis=0)
        z2 = np.tile(z[2], (2, 1))
        g1, g2 = z1 - null, z2 - z1
        nb = np.where(g1 >= 11.0, 1 + (g2 >= 11.0), 0)
        margin = np.minimum(np.abs(g1 - 11.0),
                            np.where(g1 >= 11.0, np.abs(g2 - 11.0), np.inf))
        return nb, margin

    # decisive: every pairing of runs of both packages clears the
    # threshold by 3 nats and agrees within its package
    nb = {}
    decisive = np.ones(null.shape, dtype=bool)
    for pkg, z in runs.items():
        nb[pkg], margin = decisions(z)
        decisive &= (margin > 3.0).all(axis=0) \
            & (nb[pkg] == nb[pkg][0]).all(axis=0)
    assert decisive.any()
    np.testing.assert_array_equal(nb["port"][0][decisive],
                                  nb["jax"][0][decisive])


def test_fit_batch_traced_takes_no_data(cube):  # noqa: F811
    with pytest.raises(ValueError, match="segment_iters"):
        fit_batch(torch.Generator(), _port_runner(cube, 1), R,
                  NSConfig(nlive=20), segment_iters=0, device="cpu",
                  data=_port_runner(cube, 1).data_tree())
