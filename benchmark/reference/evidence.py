"""Nested-sampling evidence and posterior summaries for the reference.

The quadrature of a batched-kill nested sampler: the run starts with
``nlive + n_init_dead`` points and kills ``n_init_dead`` of them one at a
time, then kills ``kill_k`` of ``nlive`` at a time, so the t-th death of
a batch sees ``nlive - t mod kill_k`` live points and shrinks the prior
volume by ``1 / that`` in log.  The remaining volume after the last
death is split among the live points still alive.  lnZ is the log of
the weighted likelihood sum, H its information and lnZ's error
``sqrt(H <d>)`` (Skilling).  Copied from
``nestfit_tpu_torch/sampling/sampler.py`` (``_weight_tables``,
``ns_finalize``) and ``results.py`` (``QUANTILES``,
``_weighted_quantiles``, ``_interp``).
"""

import numpy as np
import torch

QUANTILES = (0.00, 0.01, 0.10, 0.25, 0.50, 0.75, 0.90, 0.99, 1.00,
             1.58655254e-1, 0.84134475, 2.27501319e-2, 0.97724987,
             1.34989803e-3, 0.99865010)


def weight_tables(nlive, kill_k, max_iter, n_init_dead):
    """``(lnx[max_iter + 1], lnw[max_iter])`` in float64."""
    n_init_dead = min(n_init_dead, max_iter)
    d_init = 1.0 / (nlive + n_init_dead - np.arange(n_init_dead))
    d_main = 1.0 / (nlive - (np.arange(max_iter - n_init_dead) % kill_k))
    d = np.concatenate([d_init, d_main])
    lnx = np.concatenate([[0.0], -np.cumsum(d)])
    return lnx, lnx[:-1] + np.log1p(-np.exp(-d))


def evidence(lnl_dead, lnl_live, lnx, lnw):
    """``(lnz, lnz_err, lnp)`` of one run: ``lnl_dead[n_dead]`` in death
    order, ``lnl_live[n]`` of the live points still alive; ``lnp`` is the
    normalised ln posterior mass of ``cat(dead, live)``."""
    dt = lnl_dead.dtype
    n_dead = lnl_dead.shape[0]
    lnw_d = torch.as_tensor(lnw[:n_dead], dtype=dt, device=lnl_dead.device)
    lnw_l = torch.full_like(lnl_live, float(lnx[n_dead]
                                            - np.log(max(1, len(lnl_live)))))
    lnwl = torch.cat([lnw_d + lnl_dead, lnw_l + lnl_live])
    lnz = torch.logsumexp(lnwl, dim=0)
    lnp = lnwl - lnz
    h = torch.sum(torch.exp(lnp) * torch.cat([lnl_dead, lnl_live])) - lnz
    mean_d = -lnx[n_dead] / max(1, n_dead)
    err = torch.sqrt(torch.clamp(h, min=0.0) * mean_d)
    return lnz, err, lnp


def weighted_quantiles(theta, lnp, qs=QUANTILES):
    """Quantiles ``[Q, D]`` of ``theta[N, D]`` under ``lnp[N]``: the
    sorted values linearly interpolated at the normalised cumulative
    weight, constant beyond the ends."""
    order = torch.argsort(theta, dim=0, stable=True)
    ts = torch.gather(theta, 0, order)
    w = torch.exp(lnp - lnp.max())[order]
    cw = torch.cumsum(w, dim=0)
    cw = cw / cw[-1:]
    q = torch.as_tensor(qs, dtype=theta.dtype, device=theta.device)
    out = []
    for k in range(theta.shape[1]):
        xp, fp = cw[:, k].contiguous(), ts[:, k]
        n = xp.shape[0]
        i = torch.clamp(torch.searchsorted(xp, q, right=True), 1, n - 1)
        x_lo, f_lo, f_hi = xp[i - 1], fp[i - 1], fp[i]
        dx = xp[i] - x_lo
        flat = dx <= 0
        f = torch.where(flat, f_lo, f_lo + (q - x_lo)
                        / torch.where(flat, 1.0, dx) * (f_hi - f_lo))
        f = torch.where(q < xp[0], fp[0], f)
        out.append(torch.where(q > xp[-1], fp[-1], f))
    return torch.stack(out, dim=1)


def posterior_std(theta, lnp):
    """Posterior standard deviation ``[D]``."""
    w = torch.exp(lnp - torch.logsumexp(lnp, 0))[:, None]
    mean = torch.sum(w * theta, dim=0)
    return torch.sqrt(torch.sum(w * (theta - mean) ** 2, dim=0))
