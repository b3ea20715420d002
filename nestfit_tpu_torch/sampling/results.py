"""Posterior products from nested-sampling results
(port of ``resolve_n_post``, ``posterior_products`` and
``information_criteria`` from ``nestfit_tpu/sampling/results.py``).

Batched over the run axis R.  ``posterior_modes`` is not ported yet
(ROADMAP.md Queue 1 item 11).
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
    n_pts = result.dead_u.shape[1] + result.live_u.shape[1]
    row_bytes = n_pts * result.dead_u.shape[2] * result.dead_u.element_size()
    step = max(1, _PRODUCTS_BYTES // row_bytes)
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
    u_all = torch.cat([result.dead_u[rows], result.live_u[rows]], dim=1)
    lnl_all = torch.cat([result.dead_lnl[rows], result.live_lnl[rows]],
                        dim=1)
    lnw_all = torch.cat([result.dead_lnw[rows], result.live_lnw[rows]],
                        dim=1)
    lnp = torch.where(lnl_all > _NEG / 2, lnw_all + lnl_all, _NEG)
    lnp = lnp - torch.logsumexp(lnp, dim=1, keepdim=True)

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
