"""Tabulated 1-D prior distributions
(port of ``nestfit_tpu/priors/distributions.py``).

Construction runs on the host in float64 with NumPy and SciPy
(cumulative-trapezoid CDF, spline-inverted PPF on a uniform quantile
grid, cumulative index-moment tables), then the tables become float32
tensors on the chosen device.  Evaluation goes through the kernels of
``ops/tables.py``: :func:`ppf_interp` through ``table_lerp`` (K2) and
:func:`tapered_interval_invert` through ``tapered_invert`` (K3); with
``plain=True`` they take the plain PyTorch versions on any device (the
reference the kernels are held against).
"""

import dataclasses

import numpy as np
import torch
from scipy import integrate, interpolate

from nestfit_tpu_torch.device import resolve_device, same_device
from nestfit_tpu_torch.ops import tables as table_ops


@dataclasses.dataclass(frozen=True)
class Distribution:
    """Tabulated distribution: x-axis, PDF, CDF and PPF tables, plus the
    cumulative index-moment tables ``t0``/``t1c``/``t2c`` of the
    trapezoid weights (centred at the grid midpoint) that the tapered
    interval inversion reads.

    Derived on the tables' device when the distribution is made (and
    again by :meth:`to`): ``r0``/``r1c``/``r2c``, the same cumulative
    tables less their totals (summed in float64 from ``pdf``, then
    rounded), small in the right tail where ``t0`` is close to its total
    and the differences of ``t0`` cancel; ``cells``, the ``[N, 2, 4]``
    table ``{t0, t1c, t2c, xax}, {r0, r1c, r2c, xax}`` per grid cell that
    K3 reads one 16-byte row at a time; and ``dx_t``, ``dx`` as a 0-dim
    tensor, the divisor of the plain tapered inversion."""

    xax: torch.Tensor
    pdf: torch.Tensor
    cdf: torch.Tensor
    ppf: torch.Tensor
    t0: torch.Tensor
    t1c: torch.Tensor
    t2c: torch.Tensor
    size: int
    dx: float
    du: float
    xmin: float
    xmax: float
    r0: torch.Tensor = dataclasses.field(init=False, repr=False)
    r1c: torch.Tensor = dataclasses.field(init=False, repr=False)
    r2c: torch.Tensor = dataclasses.field(init=False, repr=False)
    cells: torch.Tensor = dataclasses.field(init=False, repr=False)
    dx_t: torch.Tensor = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        for name, table in zip(("r0", "r1c", "r2c"), _tail_tables(
                self.pdf.detach().cpu().double().numpy())):
            object.__setattr__(self, name, torch.as_tensor(
                table, dtype=self.t0.dtype, device=self.t0.device))
        cells = torch.stack([
            torch.stack([self.t0, self.t1c, self.t2c, self.xax], dim=-1),
            torch.stack([self.r0, self.r1c, self.r2c, self.xax], dim=-1)],
            dim=1)
        object.__setattr__(self, "cells", cells.contiguous())
        object.__setattr__(self, "dx_t", torch.tensor(
            self.dx, dtype=self.t0.dtype, device=self.t0.device))

    @property
    def center(self) -> float:
        return (self.size - 1) / 2.0

    def to(self, device) -> "Distribution":
        """On ``device``; itself when it is there already, so tables that a
        captured CUDA graph reads by address stay where they are when a
        runner sharing this prior is built."""
        if same_device(self.xax.device, device):
            return self
        return dataclasses.replace(self, **{
            f: getattr(self, f).to(device)
            for f in ("xax", "pdf", "cdf", "ppf", "t0", "t1c", "t2c")})


def _moment_weights(pdf):
    """The trapezoid weights of ``pdf`` (the first zero) and their first
    and second moments about the grid's middle index, in float64."""
    trap = 0.5 * (pdf + np.roll(pdf, 1))
    trap[0] = 0.0
    ic = np.arange(pdf.shape[0]) - (pdf.shape[0] - 1) / 2.0
    return trap, trap * ic, trap * ic * ic


def _tail_tables(pdf):
    """``r0``/``r1c``/``r2c``: the cumulative moment tables less their
    totals, that is minus the sums to the right of each cell."""
    return [-np.append(np.cumsum(w[:0:-1])[::-1], 0.0)
            for w in _moment_weights(pdf)]


def make_distribution(xax, pdf, dtype=torch.float32,
                      device="cuda") -> Distribution:
    """Build a :class:`Distribution` from PDF samples on a uniform grid
    (float64 host construction, as the reference and the JAX package)."""
    dev = resolve_device(device)
    xax = np.asarray(xax, dtype=np.float64)
    pdf = np.asarray(pdf, dtype=np.float64)
    if xax.ndim != 1 or xax.shape != pdf.shape or not xax[1] > xax[0]:
        raise ValueError("xax must be ascending and match pdf")
    size = xax.shape[0]
    cdf = integrate.cumulative_trapezoid(pdf, xax, initial=0)
    cdf = cdf / cdf.max()
    # strictly-ascending hack for the spline inversion
    eps_cdf = cdf + np.arange(size) * 1e-16
    eps_cdf = eps_cdf / eps_cdf.max()
    inv_cdf = interpolate.UnivariateSpline(eps_cdf, xax, k=3, s=0)
    u = np.linspace(0, 1, size)
    ppf = inv_cdf(u)
    t0, t1c, t2c = (np.cumsum(w) for w in _moment_weights(pdf))
    tables = dict(xax=xax, pdf=pdf, cdf=cdf, ppf=ppf, t0=t0, t1c=t1c,
                  t2c=t2c)
    return Distribution(
        **{k: torch.as_tensor(v, dtype=dtype, device=dev)
           for k, v in tables.items()},
        size=size,
        dx=float(xax[1] - xax[0]),
        du=float(u[1] - u[0]),
        xmin=float(xax.min()),
        xmax=float(xax.max()),
    )


def ppf_interp(dist: Distribution, u, plain: bool = False):
    """Linear PPF interpolation on the uniform quantile grid; ``u`` may
    have any shape."""
    scaled = (u * (dist.size - 1)).contiguous()
    if plain:
        return table_ops.table_lerp_plain(dist.ppf, scaled)
    return table_ops.table_lerp(dist.ppf, scaled)


def cdf_interp(dist_or_cdf, u, xax=None, dx=None, cdf=None):
    """Inverse-interpolate cumulative probability ``u`` onto the
    parameter axis, from a :class:`Distribution` or a batched CDF array
    ``[..., N]`` (with ``xax``/``dx``).  ``cdf`` is accepted and ignored,
    as in the JAX package."""
    if isinstance(dist_or_cdf, Distribution):
        cdf, xax, dx = dist_or_cdf.cdf, dist_or_cdf.xax, dist_or_cdf.dx
    else:
        cdf = dist_or_cdf
        if xax is None or dx is None:
            raise ValueError("a CDF array needs xax and dx")
    size = cdf.shape[-1]
    u = torch.clamp(u, min=1e-30)
    cdf_b = torch.broadcast_to(cdf, u.shape + (size,))
    i_hi = torch.sum(cdf_b < u[..., None], dim=-1)
    i_hi = torch.clamp(i_hi, 1, size - 1)
    i_lo = i_hi - 1
    y_lo = torch.gather(cdf_b, -1, i_lo[..., None])[..., 0]
    y_hi = torch.gather(cdf_b, -1, i_hi[..., None])[..., 0]
    denom = torch.clamp(y_hi - y_lo, min=1e-30)
    return xax[i_lo] + (u - y_lo) * (dx / denom)


_SFACT = {}


def cdf_over_interval(dist: Distribution, x_lo, x_hi, sfact):
    """Re-normalised, power-law-tapered CDF ``[..., N]`` over
    ``[x_lo, x_hi]`` (the dense form; the placement prior uses it only
    for taper exponents above 2)."""
    lo = torch.minimum(x_lo, x_hi)
    hi = torch.maximum(x_lo, x_hi)
    size = dist.size
    dtype = dist.pdf.dtype
    i_lo = torch.clamp(((lo - dist.xmin) / dist.dx).to(torch.int64),
                       0, size - 1)
    i_hi = ((hi - dist.xmin) / dist.dx).to(torch.int64)
    i_hi = torch.where(i_hi == i_lo, i_lo + 1, i_hi)
    i_hi = torch.clamp(i_hi, 1, size)
    idx = torch.arange(size, device=lo.device)
    i_lo_b = i_lo[..., None]
    i_hi_b = i_hi[..., None]
    span = torch.clamp(i_hi_b - i_lo_b, min=1).to(dtype)
    t = (idx - i_lo_b).to(dtype) / span
    key = (float(sfact), dtype, lo.device)
    if key not in _SFACT:     # built once: no host copy per call
        _SFACT[key] = torch.as_tensor(sfact, dtype=dtype, device=lo.device)
    sf = _SFACT[key]
    taper = torch.clamp(1.0 - t, 0.0, 1.0) ** sf[..., None]
    pdf = dist.pdf
    trap = 0.5 * (pdf + torch.roll(pdf, 1))
    interior = (idx > i_lo_b) & (idx < i_hi_b)
    terms = torch.where(interior, trap * taper, 0.0)
    csum = torch.cumsum(terms, dim=-1)
    total = torch.clamp(csum[..., -1:], min=1e-30)
    cdf = csum / total
    cdf = torch.where(idx < i_lo_b, 0.0, cdf)
    cdf = torch.where(idx >= i_hi_b, 1.0, cdf)
    degenerate = (i_hi_b - i_lo_b) == 1
    return torch.where(degenerate & (idx >= i_lo_b), 1.0, cdf)


def tapered_interval_invert(dist: Distribution, u, x_lo, x_hi, sfact: int,
                            plain: bool = False):
    """Invert the tapered interval CDF at ``u`` in O(1) memory per
    element (``sfact`` in 0, 1, 2); the same quantity as
    ``cdf_interp(cdf_over_interval(dist, x_lo, x_hi, sfact), u)``.  An
    interval that starts past the distribution's median differences the
    tail tables ``r0``/``r1c``/``r2c``, any other the cumulative ones:
    the JAX package differences the cumulative ones alone, which cancel
    in float32 for narrow intervals in the right tail (up to ~4 grid
    cells from the float64 answer on the IRDC centroid prior; here
    within one cell)."""
    shape = torch.broadcast_shapes(u.shape, x_lo.shape, x_hi.shape)
    args = [torch.broadcast_to(x, shape).contiguous() for x in (u, x_lo, x_hi)]
    fn = table_ops.tapered_invert_plain if plain \
        else table_ops.tapered_invert
    return fn(dist, *args, int(sfact))
