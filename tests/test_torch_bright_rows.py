"""Bright pixels in float32: lnZ's error and the posterior resampling.

- ``ns_finalize``'s information ``H`` (and so lnZ's error) on runs whose
  best points lie 1e4-1e5 nats above the sampler's shift (the initial
  live maximum), as on bright NH3 pixels: held to float64 sums of the
  same formula.  The former float32 formula, ``sum(p * lnl_s) - lnz_s``
  (kept below as ``_cancelling_h``), misses the same bar by orders of
  magnitude; the JAX package still computes it so.
- the IRDC centroid placement (K3's plain version) in the prior's right
  tail: within one grid cell of the same transform in float64, where
  differencing the cumulative moment tables alone (the JAX package's
  way) misses it by up to four.
- ``posterior_products``' systematic resampling when the float32 sum of
  the weights ends below the last resampling position: no draw lands on
  a slot of zero weight, each moved position is counted
  (``resample_clamped``, and ``fit.resample_clamped`` when the records
  are copied to the host), and ordinary rows draw what they drew before.
"""

import numpy as np
import pytest
import torch

from nestfit_tpu_torch.cube.records import fit_group_records
from nestfit_tpu_torch.priors import get_irdc_priors
from nestfit_tpu_torch.sampling import results as tres
from nestfit_tpu_torch.sampling import sampler as ts
from nestfit_tpu_torch.sampling.fit import FitResult
from nestfit_tpu_torch.utils import profiling as prof

NEG = ts._NEG
L, D = 100, 12
# the best point above the shift, by row
PEAKS = (1.0e4, 3.0e4, 6.0e4, 1.0e5)


def _bright_state(n_dead=6000):
    """A finished-looking state of one run per ``PEAKS`` entry: the dead
    points' shifted lnL rises with the shrinking prior volume as a
    12-dimensional Gaussian's, from 1e3 nats below the shift to the
    peak; the live points lie above the last dead point."""
    cfg = ts.NSConfig(nlive=L, max_iter=8000).resolved(D)
    lnx, _ = ts._weight_tables(L, cfg.kill_k, cfg.max_iter,
                               cfg.n_init_dead())
    R = len(PEAKS)
    peak = np.asarray(PEAKS)[:, None]
    scale = peak + 1e3
    dead = peak - scale * np.exp(lnx[1:n_dead + 1] * 2.0 / D)[None, :]
    live_x = lnx[n_dead] + np.log(np.arange(1, L + 1) / L)
    live = peak - scale * np.exp(live_x * 2.0 / D)[None, :]
    dead_lnl = np.full((R, cfg.max_iter), NEG)
    dead_lnl[:, :n_dead] = dead
    f32 = dict(dtype=torch.float32)
    st = ts._State(
        gen=torch.Generator(), u=torch.rand(R, L, D),
        lnl=torch.as_tensor(live, **f32),
        lnl_shift=torch.full((R,), -400.0, **f32),
        lnz=torch.zeros(R, **f32), done=torch.ones(R, dtype=torch.bool),
        converged=torch.ones(R, dtype=torch.bool),
        n_deaths=torch.full((R,), n_dead, dtype=torch.int32),
        pending=torch.zeros(R, dtype=torch.int32), thresh=torch.zeros(R),
        zombie=torch.zeros(R, L, dtype=torch.bool),
        stall=torch.zeros(R, dtype=torch.int32),
        ncall=torch.full((R,), 50_000, dtype=torch.int32),
        dead_u=torch.rand(R, cfg.max_iter, D),
        dead_lnl=torch.as_tensor(dead_lnl, **f32), i=n_dead, bounds=(),
        acc_ema=torch.tensor(0.5), ceff_mult=torch.ones(R))
    return st, cfg, lnx


def _float64_h(st, cfg, lnx):
    """``(H, lnZ's error)`` of the state's float32 ln-likelihoods by the
    same formula, every sum in float64."""
    _, lnw = ts._weight_tables(L, cfg.kill_k, cfg.max_iter,
                               cfg.n_init_dead())
    nd = int(st.n_deaths[0])
    lnl = torch.cat([st.dead_lnl[:, :nd], st.lnl], dim=1).double()
    n_live = L - int(st.pending[0])
    lnw_all = torch.as_tensor(np.concatenate(
        [lnw[:nd], np.full(L, lnx[nd] - np.log(n_live))])).double()
    lnz = torch.logsumexp(lnw_all + lnl, dim=1, keepdim=True)
    p = torch.exp(lnw_all + lnl - lnz)
    h = torch.sum(p * (lnl - lnz), dim=1)
    err = torch.sqrt(h * (-lnx[nd] / nd))
    return h.numpy(), err.numpy()


def _cancelling_h(st, cfg):
    """``ns_finalize``'s former float32 information,
    ``sum(p * lnl_s) - lnz_s``."""
    lnx_tab, lnw_tab = ts._tables(cfg, L, st.u)
    nd = st.n_deaths.long()
    R = st.u.shape[0]
    valid = torch.arange(cfg.max_iter)[None, :] < nd[:, None]
    dead_lnw = torch.where(valid, lnw_tab.expand(R, cfg.max_iter), NEG)
    dead_lnl = torch.where(valid, st.dead_lnl, NEG)
    live_lnw = (lnx_tab[nd] - np.log(float(L)))[:, None].expand(R, L)
    lnwl = torch.cat([dead_lnw + dead_lnl, live_lnw + st.lnl], dim=1)
    lnz = torch.logsumexp(lnwl, dim=1)
    lnl = torch.cat([dead_lnl, st.lnl], dim=1)
    p = torch.exp(lnwl - lnz[:, None])
    return torch.sum(torch.where(lnl > NEG / 2, p * lnl, 0.0),
                     dim=1) - lnz


def test_bright_information_and_error_match_float64():
    st, cfg, lnx = _bright_state()
    h64, err64 = _float64_h(st, cfg, lnx)
    assert np.all(h64 > 10)
    res = ts.ns_finalize(st, cfg)
    assert res.h.dtype == torch.float32
    np.testing.assert_allclose(res.h.numpy(), h64, rtol=1e-3)
    np.testing.assert_allclose(res.lnz_err.numpy(), err64, rtol=1e-3)
    # the former formula fails the same bar on every row
    old = _cancelling_h(st, cfg).numpy()
    assert np.all(np.abs(old - h64) > 1e-3 * np.abs(h64)), (old, h64)


def test_ordinary_information_is_unchanged():
    """On a run whose lnL spans tens of nats the information is the
    former formula's to float32 rounding."""
    st, cfg, lnx = _bright_state()
    st.dead_lnl = st.dead_lnl * 1e-3
    st.lnl = st.lnl * 1e-3
    h64, _ = _float64_h(st, cfg, lnx)
    res = ts.ns_finalize(st, cfg)
    np.testing.assert_allclose(res.h.numpy(), h64, rtol=1e-5)
    np.testing.assert_allclose(_cancelling_h(st, cfg).numpy(), h64,
                               rtol=1e-4)


def _centroid_cells(dist, got, exact):
    """The centroids' largest gap, in grid cells, at ncomp 2."""
    gap = torch.abs(got.double() - exact).reshape(-1, 6, 2)[:, 0]
    return float(gap.max()) / dist.dx


def test_right_tail_placement_within_a_cell_of_float64():
    u = torch.rand(100_000, 12, generator=torch.Generator().manual_seed(1))
    pt = get_irdc_priors(device="cpu")
    dist = pt.priors[0].vcen_prior.dist
    exact = get_irdc_priors(dtype=torch.float64, device="cpu").transform(
        u.double(), 2)
    assert _centroid_cells(dist, pt.transform(u, 2), exact) <= 1.01
    # every interval on the cumulative side: the former placement (the
    # plain version reads the table; this transformer is the test's own)
    dist.r0.fill_(-np.inf)
    assert _centroid_cells(dist, pt.transform(u, 2), exact) > 3.0


N_DEAD, MAX_ITER, N_ZOMBIE, N_POST = 2915, 3200, 30, 4096


def _result(R=3):
    """Runs over 2,915 dead and 70 live points; the dead slots past
    2,915 and the last 30 live slots are masked.  Row 0 is ordinary
    (lnL rises along the run); rows 1, 2 hold thousands of equal
    weights, whose float32 sum falls short of 1, after a first point of
    zero weight."""
    g = torch.Generator().manual_seed(5)
    dead_lnl = torch.full((R, MAX_ITER), NEG)
    lnl_row0 = -50.0 + 40.0 * torch.linspace(0, 1, N_DEAD) ** 0.25
    dead_lnl[0, :N_DEAD] = lnl_row0
    dead_lnl[1:, :N_DEAD] = -7.0
    dead_lnl[1:, 0] = -1e4            # a point whose weight underflows
    live_lnl = torch.full((R, L), -7.0)
    live_lnl[0] = -10.0 + 0.01 * torch.arange(L)
    live_lnl[:, L - N_ZOMBIE:] = NEG
    dead_lnw = torch.full((R, MAX_ITER), -np.log(N_DEAD + L - N_ZOMBIE))
    live_lnw = torch.full((R, L), -np.log(N_DEAD + L - N_ZOMBIE))
    live_lnw[:, L - N_ZOMBIE:] = NEG
    f32 = torch.float32
    return ts.NSResult(
        lnz=torch.zeros(R), lnz_err=torch.full((R,), 0.1), h=torch.ones(R),
        lnl_shift=torch.zeros(R), n_dead=torch.full((R,), N_DEAD, dtype=
                                                     torch.int32),
        ncall=torch.full((R,), 9000, dtype=torch.int32),
        converged=torch.ones(R, dtype=torch.bool),
        dead_u=torch.rand(R, MAX_ITER, 2, generator=g),
        dead_lnl=dead_lnl.to(f32), dead_lnw=dead_lnw.to(f32),
        live_u=torch.rand(R, L, 2, generator=g), live_lnl=live_lnl.to(f32),
        live_lnw=live_lnw.to(f32), max_loglike=torch.full((R,), -7.0),
        nlive=L, ndim=2, max_iter=MAX_ITER)


def _unguarded_take(result, jitter):
    """The draws of the resampling without the guard: ``searchsorted``
    of the positions in the float32 cumulative weights."""
    _, _, lnp = tres._weights(result, slice(None))
    w = torch.exp(lnp)
    cw = torch.cumsum(w, dim=1)
    pos = (torch.arange(N_POST, dtype=w.dtype)[None, :] + jitter) / N_POST
    take = torch.clamp(torch.searchsorted(cw.contiguous(), pos), 0,
                       cw.shape[1] - 1)
    return take, w


def test_no_draw_lands_on_a_slot_of_zero_weight():
    result = _result()
    # the last jitter torch.rand can give, and a zero one
    jitter = torch.tensor([[0.25], [1.0 - 2.0 ** -24], [0.0]])
    take, w = _unguarded_take(result, jitter)
    cw_end = torch.cumsum(w, dim=1)[:, -1]
    last_pos = (N_POST - 1 + jitter[:, 0]) / N_POST
    assert cw_end[1] < last_pos[1]          # the case the guard is for
    zero = torch.gather(w, 1, take) == 0
    assert not zero[0].any() and zero[1].any() and zero[2, 0]
    prod = tres._products_rows(result, slice(None), lambda u: u, jitter,
                               N_POST, tres.QUANTILES)
    lnl = -0.5 * prod.posteriors[..., 2]
    assert torch.all(lnl > NEG / 2)
    assert torch.all(prod.posteriors[..., 3] > 0)
    assert prod.resample_clamped.tolist() == zero.sum(dim=1).tolist()
    # the ordinary row draws what it drew before, point for point
    u_all = torch.cat([result.dead_u, result.live_u], dim=1)
    assert torch.equal(prod.posteriors[0, :, :2], u_all[0, take[0]])
    # every other draw too: only the moved ones differ
    kept = ~zero
    assert torch.equal(prod.posteriors[..., :2][kept],
                       torch.stack([u_all[r, take[r]] for r in range(3)])
                       [kept])


def test_the_records_copy_counts_the_moved_positions():
    result = _result()
    gen = torch.Generator().manual_seed(0)
    prod = tres.posterior_products(result, lambda u: u, gen, n_post=N_POST)
    # whatever the jitters drawn, the records report the products' count
    fit = FitResult(
        ns=result, products=prod, null_lnz=torch.full((3,), -500.0),
        ics={k: torch.zeros(3) for k in ("BIC", "AIC", "AICc", "null_BIC",
                                         "null_AIC", "null_AICc")},
        ncomp=1, n_params=2, n_chan_tot=100)
    with prof.collect() as tr:
        recs = fit_group_records(fit, [0, 1, 2])
    assert tr.counters["fit.resample_clamped"] == \
        int(prod.resample_clamped.sum())
    assert [r[0]["n_samples"] for r in recs] == [N_DEAD + L] * 3
    assert [r[0]["n_calls"] for r in recs] == [9000] * 3
    with prof.collect() as tr:
        fit_group_records(fit, [0])
    assert tr.counters["fit.resample_clamped"] == \
        int(prod.resample_clamped[0])


@pytest.mark.parametrize("row", [1, 2])
def test_the_guard_counts_every_moved_position(row):
    """Rows of equal weights, at the largest and at a zero jitter: the
    count is the number of unguarded draws on a slot of zero weight."""
    result = _result()
    jitter = torch.full((3, 1), 1.0 - 2.0 ** -24 if row == 1 else 0.0)
    take, w = _unguarded_take(result, jitter)
    moved = int((torch.gather(w, 1, take)[row] == 0).sum())
    assert moved > 0
    prod = tres._products_rows(result, slice(None), lambda u: u, jitter,
                               N_POST, tres.QUANTILES)
    assert int(prod.resample_clamped[row]) == moved
