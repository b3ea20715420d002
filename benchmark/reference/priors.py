"""Tabulated prior transforms for the reference, vectorised over points.

Copied from ``nestfit_tpu_torch/oracle.py`` (``OracleDistribution``,
``resolved_placement_interp``: scalar mirrors of the original NestFit
``core.pyx:23-161, 369-434``) and the grids of
``nestfit_tpu_torch/priors/constructors.py``.  A distribution is built
in float64 on the host (trapezoid CDF, spline-inverted PPF on a uniform
quantile grid) and cast to the working dtype; the centroid placement
inverts the dense, power-law-tapered interval CDF.

A prior set is a JSON file ``priors/<name>.json``: the grid size, each
parameter row's grid ``x = span * u + lo`` and PDF (``beta`` with its
two shapes, or ``flat``), the placement's centroid and width rows and
scale, and constant rows.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch
from scipy import integrate, interpolate, stats

from reference.hyperfine import C

PRIOR_DIR = Path(__file__).with_name("priors")


@dataclasses.dataclass(frozen=True)
class Dist:
    xax: torch.Tensor
    pdf: torch.Tensor
    ppf: torch.Tensor
    size: int
    dx: float
    xmin: float
    xmax: float


def make_dist(xax, pdf, dtype, device) -> Dist:
    xax = np.asarray(xax, dtype=np.float64)
    pdf = np.asarray(pdf, dtype=np.float64)
    size = xax.shape[0]
    cdf = integrate.cumulative_trapezoid(pdf, xax, initial=0)
    cdf = cdf / cdf.max()
    eps_cdf = cdf + np.arange(size) * 1e-16
    eps_cdf /= eps_cdf.max()
    inv = interpolate.UnivariateSpline(eps_cdf, xax, k=3, s=0)
    ppf = inv(np.linspace(0, 1, size))

    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    return Dist(t(xax), t(pdf), t(ppf), size, float(xax[1] - xax[0]),
                float(xax.min()), float(xax.max()))


def ppf_interp(d: Dist, u):
    """Linear PPF interpolation on the uniform quantile grid."""
    s = u * (d.size - 1)
    i = torch.clamp(torch.floor(s), 0, d.size - 2).long()
    lo, hi = d.ppf[i], d.ppf[i + 1]
    return lo + (hi - lo) * (s - i.to(s.dtype))


def cdf_over_interval(d: Dist, x_lo, x_hi, sfact: float):
    """The renormalised, ``(1 - t)^sfact``-tapered CDF ``[..., N]`` over
    ``[x_lo, x_hi]`` (the oracle's ``cdf_over_interval``)."""
    lo = torch.minimum(x_lo, x_hi)
    hi = torch.maximum(x_lo, x_hi)
    n = d.size
    i_lo = torch.clamp(((lo - d.xmin) / d.dx).long(), 0, n - 1)[..., None]
    i_hi = ((hi - d.xmin) / d.dx).long()[..., None]
    i_hi = torch.clamp(torch.where(i_hi == i_lo, i_lo + 1, i_hi), 1, n)
    idx = torch.arange(n, device=lo.device)
    t = (idx - i_lo).to(lo.dtype) / (i_hi - i_lo).to(lo.dtype)
    taper = torch.clamp(1.0 - t, min=0.0) ** sfact
    trap = 0.5 * (d.pdf + torch.roll(d.pdf, 1))
    terms = torch.where((idx > i_lo) & (idx < i_hi), trap * taper, 0.0)
    csum = torch.cumsum(terms, dim=-1)
    cdf = csum / torch.clamp(csum[..., -1:], min=1e-30)
    cdf = torch.where(idx < i_lo, 0.0, cdf)
    cdf = torch.where(idx >= i_hi, 1.0, cdf)
    return torch.where(((i_hi - i_lo) == 1) & (idx >= i_lo), 1.0, cdf)


def cdf_interp(d: Dist, cdf, u):
    """Invert the CDF rows ``cdf[..., N]`` at ``u[...]``."""
    u = torch.clamp(u, min=1e-30)
    i_hi = torch.searchsorted(cdf.contiguous(), u[..., None].contiguous())
    i_hi = torch.clamp(i_hi, 1, d.size - 1)
    y_lo = torch.gather(cdf, -1, i_hi - 1)[..., 0]
    y_hi = torch.gather(cdf, -1, i_hi)[..., 0]
    return d.xax[i_hi[..., 0] - 1] + (u - y_lo) * (
        d.dx / torch.clamp(y_hi - y_lo, min=1e-30))


def place(d: Dist, u, sig, sep_scale: float):
    """Resolved centroid placement ``[..., C]`` (the oracle's
    ``resolved_placement_interp``): components left to right, each the
    tapered interval CDF inverted at its ``u``, at least ``sep_scale *
    sqrt(sig_i sig_{i-1})`` apart, the separations shrunk to fit."""
    ncomp = u.shape[-1]
    if ncomp == 1:
        return ppf_interp(d, u)
    seps = [torch.zeros_like(sig[..., 0])] + [
        sep_scale * torch.sqrt(sig[..., i] * sig[..., i - 1])
        for i in range(1, ncomp)]
    min_seps = torch.stack(seps, dim=-1)
    sep_tot = min_seps.sum(-1)
    v_range = d.xmax - d.xmin
    factor = torch.where(sep_tot > v_range, v_range / sep_tot, 1.0)
    min_seps = min_seps * factor[..., None]
    v_lo = torch.full_like(sep_tot, d.xmin)
    v_hi = d.xmax - sep_tot * factor
    out = []
    for i in range(ncomp):
        v_lo = v_lo + min_seps[..., i]
        v_hi = v_hi + min_seps[..., i]
        cdf = cdf_over_interval(d, v_lo, v_hi, float(ncomp - 1 - i))
        v_lo = cdf_interp(d, cdf, u[..., i])
        out.append(v_lo)
    return torch.stack(out, dim=-1)


class Transform:
    """Unit cube -> physical parameters of one prior set."""

    def __init__(self, name: str, dtype=torch.float64, device="cpu"):
        spec = json.loads((PRIOR_DIR / f"{name}.json").read_text())
        self.spec = spec
        self.n_param = spec["n_param"]
        u = np.linspace(0, 1, spec["size"])
        self.rows = {}
        for row, (span, lo, pdf) in spec["rows"].items():
            if pdf[0] == "beta":
                f = stats.beta(pdf[1], pdf[2]).pdf(u)
            elif pdf[0] == "flat":
                f = np.ones_like(u) / spec["size"]
            else:
                raise ValueError(f"unknown prior pdf {pdf[0]!r}")
            self.rows[int(row)] = make_dist(span * u + lo, f, dtype, device)
        pl = spec["placement"]
        self.v_row, self.s_row = pl["v_row"], pl["s_row"]
        self.sep_scale = C["FWHM"] * pl["scale"]
        self.const = {int(k): float(v) for k, v in spec["const"].items()}

    def cells(self):
        """Grid cell ``[n_param]`` of each parameter row's prior (1e-12
        for a constant row)."""
        return np.array([self.rows[r].dx if r in self.rows else 1e-12
                         for r in range(self.n_param)])

    def __call__(self, u):
        """``u[..., n_param * C]`` (parameter-major) -> ``theta``."""
        ncomp = u.shape[-1] // self.n_param
        p = u.reshape(u.shape[:-1] + (self.n_param, ncomp))
        out = [None] * self.n_param
        for row, d in self.rows.items():
            if row != self.v_row:
                out[row] = ppf_interp(d, p[..., row, :])
        out[self.v_row] = place(self.rows[self.v_row], p[..., self.v_row, :],
                                out[self.s_row], self.sep_scale)
        for row, v in self.const.items():
            out[row] = torch.full_like(p[..., row, :], v)
        return torch.stack(out, dim=-2).reshape(u.shape)
