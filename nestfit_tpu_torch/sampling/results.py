"""Posterior products from nested-sampling results
(port of ``nestfit_tpu/sampling/results.py``: ``resolve_n_post``,
``posterior_products``, ``posterior_modes`` and
``information_criteria``).

Batched over the run axis R, in row slices that bound the peak memory.
"""

import dataclasses
import math

import numpy as np
import torch

from nestfit_tpu_torch.sampling.sampler import NSResult, _NEG

# 15 fixed quantiles incl. the +-1/2/3 sigma credible bounds
QUANTILES = np.array([
    0.00, 0.01, 0.10, 0.25, 0.50, 0.75, 0.90, 0.99, 1.00,
    1.58655254e-1, 0.84134475,
    2.27501319e-2, 0.97724987,
    1.34989803e-3, 0.99865010,
])
MARGINAL_COLS = [
    "min", "p01", "p10", "p25", "p50", "p75", "p90", "p99", "max",
    "1s_lo", "1s_hi", "2s_lo", "2s_hi", "3s_lo", "3s_hi",
]


def resolve_n_post(n_post: int, nlive: int) -> int:
    """Stored-posterior sample count: ``n_post`` if positive, else
    ``16 * nlive`` rounded up to a power of two, clamped to [512, 4096]."""
    if n_post and n_post > 0:
        return int(n_post)
    return int(min(4096, max(512, 2 ** int(np.ceil(np.log2(16 * nlive))))))


@dataclasses.dataclass(frozen=True)
class PosteriorProducts:
    """Per-run posterior summaries in physical parameter space;
    ``posteriors`` columns are the ndim parameters, ``-2 lnL`` and the
    sample's normalised posterior mass."""

    posteriors: torch.Tensor       # [R, n_post, D+2]
    marginals: torch.Tensor        # [R, n_quantiles, D]
    bestfit_params: torch.Tensor   # [R, D]
    map_params: torch.Tensor       # [R, D]
    mean_params: torch.Tensor      # [R, D]
    std_params: torch.Tensor       # [R, D]
    # [R] resampling positions moved off a slot of zero weight (None for
    # products carried across from the JAX package, which has no such
    # guard)
    resample_clamped: torch.Tensor = None


def _chunked_transform(transform, u_all, chunk=256):
    """The prior transform over ``u_all[R, N, D]`` in sample chunks, so
    a transform with grid-sized intermediates stays bounded."""
    return torch.cat([transform(u_all[:, k:k + chunk])
                      for k in range(0, u_all.shape[1], chunk)], dim=1)


def _interp(x, xp, fp):
    """Batched ``jnp.interp`` along the last axis: ``x[..., Q]`` at the
    sorted ``xp[..., N]`` with values ``fp[..., N]``, constant beyond the
    ends (the same arithmetic as JAX's implementation)."""
    n = xp.shape[-1]
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, n - 1)
    x_lo = torch.gather(xp, -1, i - 1)
    f_lo = torch.gather(fp, -1, i - 1)
    f_hi = torch.gather(fp, -1, i)
    dx = torch.gather(xp, -1, i) - x_lo
    delta = x - x_lo
    eps = float(np.spacing(torch.finfo(xp.dtype).eps))
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, f_lo,
                    f_lo + (delta / torch.where(dx0, 1.0, dx)) * (f_hi - f_lo))
    f = torch.where(x < xp[..., :1], fp[..., :1], f)
    return torch.where(x > xp[..., -1:], fp[..., -1:], f)


def _weighted_quantiles(theta, lnp, qs):
    """Weighted quantiles along the sample axis: ``theta[R, D, N]``,
    ``lnp[R, N]`` (masked at -1e30), ``qs[Q]`` -> ``[R, D, Q]``."""
    order = torch.argsort(theta, dim=-1, stable=True)
    ts = torch.gather(theta, -1, order)
    lnp_b = lnp[:, None, :].expand_as(theta)
    ws = torch.exp(torch.gather(lnp_b, -1, order)
                   - torch.amax(lnp, dim=-1)[:, None, None])
    cw = torch.cumsum(ws, dim=-1)
    cw = cw / cw[..., -1:]
    x = qs.expand(theta.shape[:-1] + qs.shape).contiguous()
    return _interp(x, cw.contiguous(), ts)


# bytes of points (``(max_iter + nlive) x D`` per run) the posterior
# products take in one pass; their temporaries peak at ~12x this
# (``tools/cube_memory.py``), so wider batches go in row slices
_PRODUCTS_BYTES = 2**30


def posterior_products(result: NSResult, transform, gen: torch.Generator,
                       n_post: int = 512,
                       quantiles=QUANTILES) -> PosteriorProducts:
    """Posterior summaries for every run: weighted marginal quantiles,
    equal-weight samples by systematic resampling (jitter from ``gen``),
    the best-fit (max-lnL) and MAP (max posterior mass) samples, and the
    posterior mean and standard deviation.  Runs go in row slices of at
    most ``_PRODUCTS_BYTES`` of points, so the peak memory stays bounded
    at any batch width and live-point count."""
    R = result.lnz.shape[0]
    jitter = torch.rand((R, 1), generator=gen, device=result.lnz.device,
                        dtype=result.dead_lnl.dtype)
    step = _row_step(result)
    parts = [_products_rows(result, slice(lo, lo + step), transform,
                            jitter[lo:lo + step], n_post, quantiles)
             for lo in range(0, max(R, 1), step)]
    if len(parts) == 1:
        return parts[0]
    return PosteriorProducts(*(
        torch.cat([getattr(p, f.name) for p in parts])
        for f in dataclasses.fields(PosteriorProducts)))


def _products_rows(result, rows, transform, jitter, n_post, quantiles):
    """``posterior_products`` of the runs ``rows`` (a slice)."""
    u_all, lnl_all, lnp = _weights(result, rows)
    theta_all = _chunked_transform(transform, u_all)         # [R, N, D]
    D = theta_all.shape[-1]

    qs = torch.as_tensor(quantiles, dtype=theta_all.dtype,
                         device=theta_all.device)
    masked_theta = torch.where((lnp > _NEG / 2)[..., None], theta_all,
                               math.inf)
    marginals = _weighted_quantiles(
        masked_theta.transpose(1, 2).contiguous(), lnp, qs).transpose(1, 2)

    w = torch.exp(lnp)
    cw = torch.cumsum(w, dim=1)
    pos = (torch.arange(n_post, dtype=w.dtype, device=w.device)[None, :]
           + jitter) / n_post
    take = torch.clamp(torch.searchsorted(cw.contiguous(), pos), 0,
                       cw.shape[1] - 1)
    # the float32 sum of the weights can end below the last position (and
    # a zero jitter puts the first at 0): keep every draw between the
    # first and the last slot of nonzero weight
    slots = torch.arange(w.shape[1], device=w.device)
    heavy = w > 0
    first = torch.amin(torch.where(heavy, slots, w.shape[1] - 1), dim=1,
                       keepdim=True)
    last = torch.amax(torch.where(heavy, slots, 0), dim=1, keepdim=True)
    moved = (take < first) | (take > last)
    take = torch.minimum(torch.maximum(take, first), last)
    theta_post = torch.gather(theta_all, 1, take[..., None].expand(-1, -1, D))
    posteriors = torch.cat([
        theta_post,
        -2.0 * torch.gather(lnl_all, 1, take)[..., None],
        torch.gather(w, 1, take)[..., None],
    ], dim=-1)

    def pick(ix):
        return torch.gather(theta_all, 1,
                            ix[:, None, None].expand(-1, 1, D))[:, 0]

    mean = torch.sum(w[..., None] * theta_all, dim=1)
    var = torch.sum(w[..., None] * (theta_all - mean[:, None, :]) ** 2, dim=1)
    return PosteriorProducts(
        posteriors=posteriors,
        marginals=marginals,
        bestfit_params=pick(torch.argmax(lnl_all, dim=1)),
        map_params=pick(torch.argmax(lnp, dim=1)),
        mean_params=mean,
        std_params=torch.sqrt(var),
        resample_clamped=torch.sum(moved, dim=1, dtype=torch.int32),
    )


@dataclasses.dataclass(frozen=True)
class ModeProducts:
    """Per-mode posterior decomposition, the analogue of MultiNest's
    ``mmodal`` mode separation (see the JAX package): modes found by
    farthest-point seeding and weighted k-means into ``max_modes``
    clusters on the standardized unit-cube samples, then single-linkage
    merging.  Empty slots carry ``mode_lnz = -inf`` and zero statistics;
    ``mode_lnz`` are local evidences, ``logsumexp`` of which is ``lnz``."""

    n_modes: torch.Tensor     # [R] number of distinct modes found
    mode_lnz: torch.Tensor    # [R, K] local ln evidence per mode slot
    mode_mean: torch.Tensor   # [R, K, D] posterior mean (physical theta)
    mode_sigma: torch.Tensor  # [R, K, D] posterior std (physical theta)
    mode_map: torch.Tensor    # [R, K, D] max-posterior-mass member
    mode_frac: torch.Tensor   # [R, K] posterior mass fraction per mode
    membership: torch.Tensor  # [R, N] mode slot id per sample (-1 masked)


def _sq_dist(x, c):
    """``sum((x[:, :, None] - c[:, None]) ** 2, -1)`` ``[R, N, K]``, one
    slot at a time (no ``[R, N, K, D]`` temporary)."""
    return torch.stack([torch.sum((x - c[:, k, None]) ** 2, dim=-1)
                        for k in range(c.shape[1])], dim=-1)


def _modes_rows(u, theta, lnp, lnz, K, n_iter, merge_fact):
    """``_modes_single`` of the JAX package, batched over the rows of
    ``u``/``theta`` ``[R, N, D]``, ``lnp`` ``[R, N]``, ``lnz`` ``[R]``."""
    R, N, D = u.shape
    dtype, dev = u.dtype, u.device
    rr = torch.arange(R, device=dev)
    kk = torch.arange(K, device=dev)
    w = torch.exp(lnp)                                    # [R, N]
    live = lnp > _NEG / 2
    # standardize: distances in units of the global posterior std
    mean = torch.sum(w[..., None] * u, dim=1)
    std = torch.sqrt(torch.sum(w[..., None] * (u - mean[:, None]) ** 2,
                               dim=1))
    x = (u - mean[:, None]) / torch.clamp(std, min=1e-6)[:, None]
    x = torch.where(live[..., None], x, 1e6)              # park masked rows
    # farthest-point seeding from the MAP sample (deterministic); only
    # meaningfully weighted samples can seed a mode
    seeds = x[rr, torch.argmax(lnp, dim=1)][:, None].repeat(1, K, 1)
    heavy = w > (1e-4 / N) * torch.sum(live, dim=1, keepdim=True)
    for k in range(1, K):
        d2 = torch.amin(_sq_dist(x, seeds), dim=-1)
        score = torch.where(heavy, d2, -1.0)
        seeds[:, k] = x[rr, torch.argmax(score, dim=1)]

    def assign_to(cent):
        d2 = _sq_dist(x, cent)                             # [R, N, K]
        assign = torch.argmin(d2, dim=-1)
        onehot = (assign[..., None] == kk) & live[..., None]
        wk = torch.sum(w[..., None] * onehot, dim=1)        # [R, K]
        return d2, assign, onehot, wk

    cent = seeds
    for _ in range(n_iter):
        _, _, onehot, wk = assign_to(cent)
        new = torch.einsum("rn,rnk,rnd->rkd", w, onehot.to(dtype), x)
        new = new / torch.clamp(wk, min=1e-30)[..., None]
        cent = torch.where((wk > 0)[..., None], new, cent)
    d2, assign, onehot, wk = assign_to(cent)
    # cluster radius: rms standardized distance of members to centroid
    d2_own = torch.gather(d2, 2, assign[..., None])[..., 0]
    r2 = torch.sum(w[..., None] * onehot * d2_own[..., None], dim=1) \
        / torch.clamp(wk, min=1e-30)
    rad = torch.sqrt(r2)                                  # [R, K]
    # single-linkage merge: clusters closer than merge_fact * (r_i + r_j)
    # are one mode; transitive closure by repeated boolean squaring
    cdist = torch.sqrt(_sq_dist(cent, cent))              # [R, K, K]
    nonempty = wk > 1e-12
    link = (cdist <= merge_fact * (rad[:, :, None] + rad[:, None, :])) \
        & nonempty[:, :, None] & nonempty[:, None, :]
    link = link | torch.eye(K, dtype=torch.bool, device=dev)
    for _ in range(int(np.ceil(np.log2(max(K, 2)))) + 1):
        lf = link.to(torch.float32)
        link = (torch.matmul(lf, lf) > 0) | link
    # component label = smallest linked cluster index
    comp = torch.amin(torch.where(link, kk, K), dim=-1)   # [R, K]
    comp = torch.where(nonempty, comp, K)
    mode_of_sample = torch.where(live, torch.gather(comp, 1, assign), K)
    slot_hot = mode_of_sample[..., None] == kk            # [R, N, K]
    frac = torch.sum(w[..., None] * slot_hot, dim=1)      # [R, K]
    used = frac > 1e-12
    lnp_k = torch.where(slot_hot, lnp[..., None], _NEG)
    mode_lnz = torch.logsumexp(lnp_k, dim=1) + lnz[:, None]
    mode_lnz = torch.where(used, mode_lnz, -math.inf)
    wh = w[..., None] * slot_hot / torch.clamp(frac, min=1e-30)[:, None]
    m_mean = torch.einsum("rnk,rnd->rkd", wh, theta)
    m_var = torch.stack([
        torch.einsum("rn,rnd->rd", wh[..., k],
                     (theta - m_mean[:, k, None]) ** 2)
        for k in range(K)], dim=1)
    map_ix = torch.argmax(lnp_k, dim=1)                   # [R, K]
    m_map = torch.gather(theta, 1, map_ix[..., None].expand(-1, -1, D))
    zero = torch.zeros_like(m_mean)
    return ModeProducts(
        n_modes=torch.sum(used, dim=1, dtype=torch.int32),
        mode_lnz=mode_lnz,
        mode_mean=torch.where(used[..., None], m_mean, zero),
        mode_sigma=torch.where(used[..., None], torch.sqrt(m_var), zero),
        mode_map=torch.where(used[..., None], m_map, zero),
        mode_frac=torch.where(used, frac, 0.0),
        membership=torch.where(live, mode_of_sample, -1).to(torch.int32),
    )


def _weights(result: NSResult, rows):
    """Points and normalized ln posterior mass of the runs ``rows``:
    ``(u_all [r, N, D], lnl_all [r, N], lnp [r, N])``."""
    u_all = torch.cat([result.dead_u[rows], result.live_u[rows]], dim=1)
    lnl_all = torch.cat([result.dead_lnl[rows], result.live_lnl[rows]],
                        dim=1)
    lnw_all = torch.cat([result.dead_lnw[rows], result.live_lnw[rows]],
                        dim=1)
    lnp = torch.where(lnl_all > _NEG / 2, lnw_all + lnl_all, _NEG)
    return u_all, lnl_all, lnp - torch.logsumexp(lnp, dim=1, keepdim=True)


def _row_step(result: NSResult) -> int:
    """Runs per slice: at most ``_PRODUCTS_BYTES`` of points."""
    n_pts = result.dead_u.shape[1] + result.live_u.shape[1]
    row_bytes = n_pts * result.dead_u.shape[2] * result.dead_u.element_size()
    return max(1, _PRODUCTS_BYTES // row_bytes)


def posterior_modes(result: NSResult, transform, max_modes: int = 6,
                    n_iter: int = 12, merge_fact: float = 2.0,
                    ztol: float = None, mesh=None) -> ModeProducts:
    """Decompose each run's posterior into isolated modes and report
    per-mode local evidences and statistics (see the JAX package).
    ``ztol`` maps MultiNest's ``Ztol``: mode slots whose local evidence
    falls below it are masked from the report (lnz -> -inf, frac -> 0,
    members -> -1, n_modes decremented); None reports every mode.  Runs
    go in the row slices of :func:`posterior_products`.  ``mesh`` splits
    the runs over its dp rows, each row's share on its first device in a
    thread of its own (``transform`` must accept points there, as a
    runner's does), joined in run order on the result's device."""
    if mesh is not None:
        from nestfit_tpu_torch.parallel import mesh as _mesh

        R = result.lnz.shape[0]

        def row(k, rows, devices, _gen):
            part = _mesh.shard_rows(result, rows, R, devices[0])
            return posterior_modes(part, transform, max_modes, n_iter,
                                   merge_fact, ztol)

        return _mesh.gather_rows(_mesh.run_shards(mesh, None, R, row),
                                 result.lnz.device)
    R = result.lnz.shape[0]
    step = _row_step(result)
    parts = []
    for lo in range(0, max(R, 1), step):
        rows = slice(lo, lo + step)
        u_all, _, lnp = _weights(result, rows)
        theta_all = _chunked_transform(transform, u_all)
        parts.append(_modes_rows(u_all, theta_all, lnp, result.lnz[rows],
                                 max_modes, n_iter, merge_fact))
    mp = parts[0] if len(parts) == 1 else ModeProducts(*(
        torch.cat([getattr(p, f.name) for p in parts])
        for f in dataclasses.fields(ModeProducts)))
    if ztol is None:
        return mp
    keep = mp.mode_lnz >= ztol                             # [R, K]
    keep_m = torch.gather(keep, 1, torch.clamp(mp.membership, min=0).long())
    return dataclasses.replace(
        mp,
        n_modes=torch.sum(keep, dim=1, dtype=mp.n_modes.dtype),
        mode_lnz=torch.where(keep, mp.mode_lnz, -math.inf),
        mode_frac=torch.where(keep, mp.mode_frac, 0.0),
        membership=torch.where((mp.membership >= 0) & keep_m,
                               mp.membership, -1),
    )


def information_criteria(max_loglike, null_lnz, n_chan_tot, n_params):
    """BIC/AIC/AICc and their null-model variants."""
    n = float(n_chan_tot)
    k = float(n_params)
    maxl, nulll = max_loglike, null_lnz
    corr = (2 * k**2 + 2 * k) / (n - k - 1)
    return {
        "BIC": math.log(n) * k - 2 * maxl,
        "AIC": 2 * k - 2 * maxl,
        "AICc": 2 * k - 2 * maxl + corr,
        "null_BIC": math.log(n) * k - 2 * nulll,
        "null_AIC": 2 * k - 2 * nulll,
        "null_AICc": 2 * k - 2 * nulll + corr,
    }
