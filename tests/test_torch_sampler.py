"""Port parity: the nested sampler's deterministic pieces against the JAX
package (state carried across through ``convert.py``), the port's
segmented sampler on analytic Gaussian evidences, and the JAX package's
tests of the ``efr``, ``pwrap_dims``, ``ceff`` and ``log_zero`` knobs.

The two packages draw from different random streams, so whole runs are
compared statistically; everything that involves no randomness is
compared to float rounding.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import random

from nestfit_tpu.sampling import results as jres
from nestfit_tpu.sampling import sampler as js

from nestfit_tpu_torch import convert
from nestfit_tpu_torch.sampling import results as tres
from nestfit_tpu_torch.sampling import sampler as ts


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.mark.parametrize("ndim", [6, 12])
def test_weight_tables_and_resolved_match_jax(ndim):
    for kw in ({}, {"init_factor": 4}, {"kill_k": 7, "max_iter": 500}):
        jc = js.NSConfig(nlive=100, **kw).resolved(ndim)
        tc = ts.NSConfig(nlive=100, **kw).resolved(ndim)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert tc.n_cand() == jc.n_cand()
        assert tc.n_init_dead() == jc.n_init_dead()
        for a, b in zip(
                ts._weight_tables(100, tc.kill_k, tc.max_iter,
                                  tc.n_init_dead()),
                js._weight_tables(100, jc.kill_k, jc.max_iter,
                                  jc.n_init_dead())):
            np.testing.assert_array_equal(a, b)


def _gauss_torch(sigma, mu=0.5):
    def loglike(u):
        return -0.5 * torch.sum((u - mu) ** 2, dim=-1) / sigma**2
    return loglike


@pytest.mark.parametrize("segment_iters", [0, 250])
def test_efr_enlargement_converges(segment_iters):
    """The JAX package's test (its traced mode), and the segmented mode:
    enlarged bounding volumes (efr = 0.3) leave the evidence within the
    sampler's error class."""
    D, sig = 4, 0.4

    def ll(u):
        x = (u - 0.5) * 8.0
        return -0.5 * torch.sum((x / sig) ** 2, dim=-1)

    lnz_true = D * (np.log(np.sqrt(2 * np.pi) * sig) - np.log(8.0))
    res = ts.run_nested(torch.Generator().manual_seed(3), ll, D, 8,
                        ts.NSConfig(nlive=200, tol=0.5, efr=0.3),
                        segment_iters=segment_iters)
    lnz = res.lnz.numpy()
    assert res.converged.all()
    assert abs(lnz.mean() - lnz_true) < 0.35, (lnz.mean(), lnz_true)
    assert np.max(np.abs(lnz - lnz_true)) < 0.9, (lnz, lnz_true)


@pytest.mark.parametrize("method", ["ellipsoid", "slice"])
def test_pwrap_periodic_evidence(method):
    """The JAX package's test (traced mode): a Gaussian straddling the
    0/1 seam on two periodic dims; with ``pwrap_dims`` the evidence
    matches the analytic value and the posterior circular mean lands on
    the seam mode."""
    D, sigma = 4, 0.05
    mu = torch.tensor([0.02, 0.98, 0.5, 0.5], dtype=torch.float64)

    def loglike(u):
        d = u - mu
        # periodic dims use the nearest-image distance
        d = torch.cat([d[..., :2] - torch.round(d[..., :2]), d[..., 2:]],
                      dim=-1)
        return -0.5 * torch.sum(d**2, dim=-1) / sigma**2

    cfg = ts.NSConfig(nlive=200, tol=0.1, method=method, pwrap_dims=(0, 1))
    res = ts.run_nested(torch.Generator().manual_seed(7), loglike, D, 8, cfg,
                        dtype=torch.float64, segment_iters=0)
    lnz_true = 0.5 * D * np.log(2 * np.pi * sigma**2)
    lnz = res.lnz.numpy()
    err = res.lnz_err.numpy()
    assert res.converged.all()
    assert np.all(np.abs(lnz - lnz_true) < 5 * np.maximum(err, 0.05)), (
        lnz, lnz_true, err)
    u_post = res.dead_u.numpy()
    lnw = res.dead_lnw.numpy() + res.dead_lnl.numpy()
    w = np.exp(lnw - lnw.max(axis=-1, keepdims=True))
    w = w / w.sum(axis=-1, keepdims=True)
    ang = 2 * np.pi * u_post[..., 0]
    circ = np.arctan2((w * np.sin(ang)).sum(-1),
                      (w * np.cos(ang)).sum(-1)) / (2 * np.pi) % 1.0
    dist = np.abs(circ - 0.02)
    dist = np.minimum(dist, 1.0 - dist)
    assert np.all(dist < 0.02), circ


@pytest.mark.parametrize("segment_iters", [100, 0])
def test_ceff_constant_efficiency_mode(segment_iters):
    """The JAX package's test (segmented mode), and the traced mode:
    with ``ceff`` the proposal volume adapts so candidate acceptance
    tracks the efr target: few evaluations per death, and an evidence in
    the parameter-estimation accuracy class."""
    ndim, sigma, R = 8, 0.06, 16
    cfg = ts.NSConfig(nlive=100, tol=0.5, ceff=True, efr=0.3)
    res = ts.run_nested(torch.Generator().manual_seed(31),
                        _gauss_torch(sigma), ndim, R, cfg,
                        dtype=torch.float64, segment_iters=segment_iters)
    lnz_true = 0.5 * ndim * np.log(2 * np.pi * sigma**2)
    lnz = res.lnz.numpy()
    assert res.converged.all()
    assert abs(lnz.mean() - lnz_true) < 1.5, (lnz.mean(), lnz_true)
    epd = res.ncall.numpy().astype(np.int64) / np.maximum(
        res.n_dead.numpy(), 1)
    assert epd.mean() < 15.0, epd


def test_log_zero_floor():
    """The JAX package's test (traced mode): a floor below every
    achievable lnL changes nothing; a floor at lnL = -5 truncates the
    Gaussian's tail, biased high by the likelihood-plateau deaths exactly
    as the JAX test's model predicts."""
    ndim, sigma, R = 2, 0.05, 8
    nlive = 200
    ll = _gauss_torch(sigma)

    def run(**kw):
        return ts.run_nested(torch.Generator().manual_seed(9), ll, ndim, R,
                             ts.NSConfig(nlive=nlive, tol=0.1, **kw),
                             dtype=torch.float64, segment_iters=0)

    base, inert, cut = run(), run(log_zero=-1e9), run(log_zero=-5.0)
    assert np.allclose(base.lnz.numpy(), inert.lnz.numpy(), atol=1e-12)
    lnz_trunc = np.log(2 * np.pi * sigma**2 * -np.expm1(-5.0))
    f_above = 10.0 * np.pi * sigma**2       # area with lnL > -5
    k = nlive // 4                          # resolved kill_k
    n_plateau = nlive * (1.0 - f_above)     # expected plateau deaths
    lnx_ns = -n_plateau * np.log(nlive / (nlive - k)) / k
    lnz_expected = lnz_trunc + (lnx_ns - np.log(f_above))
    lnz = cut.lnz.numpy()
    assert cut.converged.all()
    assert lnz.mean() > lnz_trunc
    assert abs(lnz.mean() - lnz_expected) < 0.2, (lnz.mean(), lnz_expected)


def _gauss_jax(u):
    return -0.5 * jnp.sum((u - 0.5) ** 2, axis=-1) / 0.1**2


def _jax_state(R=4, D=3, iters=6):
    """A JAX float32 sampler state part-way through a run: dead points,
    zombies and pending slots all present."""
    cfg = js.NSConfig(nlive=24, tol=0.5, init_factor=2, method="ellipsoid")
    loglike = lambda u, d: _gauss_jax(u).astype(jnp.float32)  # noqa: E731
    st = js.ns_init(random.key(3), loglike, None, D, R, cfg,
                    dtype=jnp.float32)
    st = js._segment_core(st, loglike, None, cfg, iters)
    return st, cfg


def _state_dict(st):
    out = {f.name: np.asarray(getattr(st, f.name))
           for f in dataclasses.fields(st) if f.name not in ("key", "bounds")}
    out["bounds"] = tuple(np.asarray(b) for b in st.bounds)
    return out


def _port_cfg(cfg):
    return ts.NSConfig(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(ts.NSConfig)})


def test_finalize_and_posterior_products_match_jax():
    jst, cfg = _jax_state()
    assert int(np.asarray(jst.pending).sum()) > 0
    pst = convert.state_from_dict(_state_dict(jst), torch.Generator())
    jr = js.ns_finalize(jst, cfg)
    pr = ts.ns_finalize(pst, _port_cfg(cfg))
    for f in ("lnz", "lnz_err", "h", "n_dead", "ncall", "converged",
              "dead_lnl", "dead_lnw", "live_lnl", "live_lnw",
              "max_loglike"):
        np.testing.assert_allclose(getattr(pr, f).numpy(),
                                   np.asarray(getattr(jr, f)),
                                   rtol=1e-6, atol=1e-6, err_msg=f)
    assert (pr.nlive, pr.ndim, pr.max_iter) == (jr.nlive, jr.ndim,
                                                jr.max_iter)

    # posterior products of the same result, carried across
    cr = convert.result_from_dict(
        {f.name: np.asarray(getattr(jr, f.name))
         for f in dataclasses.fields(jr)
         if f.name not in ("nlive", "ndim", "max_iter")}
        | {"nlive": jr.nlive, "ndim": jr.ndim, "max_iter": jr.max_iter},
        device="cpu")
    jp = jres.posterior_products(jr, lambda u: 4.0 * u - 1.0, random.key(0),
                                 n_post=64)
    tp = tres.posterior_products(cr, lambda u: 4.0 * u - 1.0,
                                 torch.Generator(), n_post=64)
    for f in ("bestfit_params", "map_params", "mean_params", "std_params"):
        np.testing.assert_allclose(getattr(tp, f).numpy(),
                                   np.asarray(getattr(jp, f)),
                                   rtol=1e-6, atol=1e-6, err_msg=f)
    # a quantile interpolates between sorted samples by their cumulative
    # weight; where two neighbours' cumulative weights differ by a few
    # float32 ulps (the tails), the ~1e-7 rounding difference between
    # the two frameworks' logsumexp/cumsum moves the answer within that
    # gap.  All but such entries agree to 1e-6.
    got, want = tp.marginals.numpy(), np.asarray(jp.marginals)
    assert np.isclose(got, want, rtol=1e-6, atol=1e-6).mean() > 0.97
    np.testing.assert_allclose(got, want, atol=5e-3)
    assert tp.posteriors.shape == tuple(jp.posteriors.shape)
    ic_j = jres.information_criteria(jr.max_loglike, jr.lnz, 760, 12)
    ic_t = tres.information_criteria(pr.max_loglike, pr.lnz, 760, 12)
    for k, v in ic_j.items():
        np.testing.assert_allclose(ic_t[k].numpy(), np.asarray(v),
                                   rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("rows_per_slice", [1, 3])
def test_posterior_products_in_row_slices(monkeypatch, rows_per_slice):
    """A batch too wide for one pass goes through the posterior products
    in row slices: the same products, bit for bit, as one pass."""
    jst, cfg = _jax_state()
    pr = ts.ns_finalize(
        convert.state_from_dict(_state_dict(jst), torch.Generator()),
        _port_cfg(cfg))

    def products():
        return tres.posterior_products(pr, lambda u: 4.0 * u - 1.0,
                                       torch.Generator().manual_seed(3),
                                       n_post=64)

    whole = products()
    row_bytes = (pr.dead_u.shape[1] + pr.live_u.shape[1]) \
        * pr.dead_u.shape[2] * pr.dead_u.element_size()
    monkeypatch.setattr(tres, "_PRODUCTS_BYTES", rows_per_slice * row_bytes)
    sliced = products()
    for f in dataclasses.fields(whole):
        assert torch.equal(getattr(sliced, f.name), getattr(whole, f.name)), \
            f.name


def test_kill_record_and_termination_match_jax():
    jst, cfg = _jax_state(iters=3)
    # every run ready for a kill
    jst = dataclasses.replace(jst, pending=jnp.zeros_like(jst.pending))
    pst = convert.state_from_dict(_state_dict(jst), torch.Generator())
    jc = cfg.resolved(3)
    lnx_np, lnw_np = js._weight_tables(jc.nlive, jc.kill_k, jc.max_iter,
                                       jc.n_init_dead())
    R = pst.u.shape[0]
    want = js._kill_record(jst, jc, jnp.asarray(lnw_np, jnp.float32),
                           jnp.arange(R))
    lnz, n_deaths, pending, zombie, thresh = ts._kill_record(
        pst, _port_cfg(jc), torch.as_tensor(lnw_np, dtype=torch.float32),
        torch.arange(R))
    got = (pst.dead_u, pst.dead_lnl, lnz, n_deaths, pending, zombie, thresh)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)
    jd, jcv = js._check_termination(jc, jnp.asarray(lnx_np, jnp.float32),
                                    jst.done, want[5], jst.lnl, want[2],
                                    want[3], jnp.float32, stall=jst.stall)
    td, tcv = ts._check_termination(
        _port_cfg(jc), torch.as_tensor(lnx_np, dtype=torch.float32),
        pst.done, zombie, pst.lnl, lnz, n_deaths, stall=pst.stall)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tcv.numpy(), np.asarray(jcv))


@pytest.mark.parametrize("method", ["auto", "slice"])
def test_bounds_match_jax(method):
    """Bounding geometry (k-means, refinement, coverage guard) of one
    float64 live set with zombies and a flat dimension."""
    rng = np.random.default_rng(2)
    R, L, D = 3, 40, 4
    u = np.concatenate([rng.normal(0.3, 0.05, (R, L // 2, D)),
                        rng.normal(0.7, 0.04, (R, L // 2, D))], axis=1)
    u[..., 3] = rng.uniform(size=(R, L))
    zombie = rng.uniform(size=(R, L)) < 0.2
    jc = js.NSConfig(nlive=L, method=method, flat_dims=(3,))
    tc = ts.NSConfig(nlive=L, method=method, flat_dims=(3,))
    jact, act_np = js._act_arrays(jc, D, jnp.float64)
    tu = torch.as_tensor(u)
    tact, _ = ts._act_arrays(tc, D, tu)
    want = js._compute_bounds(jnp.asarray(u), jnp.asarray(zombie), jact,
                              act_np, jc)
    got = ts._compute_bounds(tu, torch.as_tensor(zombie), tact, act_np, tc)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-8)


@pytest.mark.parametrize("ndim,sigma", [(2, 0.05), (6, 0.05)])
def test_gaussian_evidence_segmented(ndim, sigma):
    """The bars of the JAX package's test_gaussian_evidence, with the
    port's segmented sampler in float64."""
    R = 8

    def loglike(u):
        return -0.5 * torch.sum((u - 0.5) ** 2, dim=-1) / sigma**2

    g = torch.Generator()
    g.manual_seed(0)
    res = ts.run_nested(g, loglike, ndim, R, ts.NSConfig(nlive=200, tol=0.1),
                        dtype=torch.float64, segment_iters=250)
    lnz_true = 0.5 * ndim * np.log(2 * np.pi * sigma**2)
    lnz = res.lnz.numpy()
    err = res.lnz_err.numpy()
    assert res.converged.all()
    assert np.all(np.abs(lnz - lnz_true) < 4 * np.maximum(err, 0.05)), (
        lnz, lnz_true, err)
    assert abs(lnz.mean() - lnz_true) < 2 * err.mean() / np.sqrt(R) + 0.08
    h_true = -lnz_true - 0.5 * ndim
    assert np.all(np.abs(res.h.numpy() - h_true) < 0.15 * abs(h_true) + 1.0)


def test_compaction_and_slice_regime_evidence(monkeypatch):
    """Straggler runs (narrower Gaussians, per-run data) are compacted
    into a smaller batch (R=80 -> 16), the kill+slice regime runs (forced
    by a high switch threshold), padding rows are born done, and every
    run still recovers its analytic evidence."""
    ndim, R = 4, 80
    sigma = np.where(np.arange(R) % 10 == 0, 0.01, 0.05)
    active = np.arange(R) < 75

    def loglike(u, data):
        return -0.5 * torch.sum((u - 0.5) ** 2, dim=-1) / data[0] ** 2

    calls = {"compact": 0, "slice": 0}

    def counted(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(ts, "_gather_state",
                        counted("compact", ts._gather_state))
    monkeypatch.setattr(ts, "ns_segment_slice",
                        counted("slice", ts.ns_segment_slice))
    g = torch.Generator()
    g.manual_seed(1)
    cfg = ts.NSConfig(nlive=60, tol=0.2, min_compact=16, cand_min_acc=0.5)
    res = ts.run_nested(g, loglike, ndim, R, cfg, dtype=torch.float64,
                        data=(torch.as_tensor(sigma),), segment_iters=4,
                        active=active)
    lnz_true = 0.5 * ndim * np.log(2 * np.pi * sigma**2)
    dev = (res.lnz.numpy() - lnz_true)[active]
    err = res.lnz_err.numpy()[active]
    assert res.converged.numpy()[active].all()
    assert np.all(np.abs(dev) < 4 * np.maximum(err, 0.1) + 0.5), dev
    assert abs(dev.mean()) < 0.5
    assert calls["compact"] >= 1 and calls["slice"] >= 1, calls
