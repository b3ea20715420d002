"""Prior transforms: unit cube -> physical parameters
(port of the main-path priors of ``nestfit_tpu/priors/priors.py``).

Every prior transforms its rows of the parameter cube
``theta[..., n_params, ncomp]`` (parameter-major layout); a
:class:`PriorTransformer` applies them in sequence.  All transforms
broadcast over leading batch dims.  ``apply`` writes into ``theta``,
which :meth:`PriorTransformer.transform` allocates afresh for each call,
so the caller's unit-cube tensor is never modified.
"""

import torch

from nestfit_tpu_torch.constants import FWHM
from nestfit_tpu_torch.priors.distributions import (
    Distribution,
    cdf_interp,
    cdf_over_interval,
    ppf_interp,
    tapered_interval_invert,
)


class Prior:
    """Independent tabulated prior on one parameter row."""

    n_param = 1
    #: parameter rows whose unit-cube input this prior ignores (the
    #: sampler excludes them from its bounding geometry)
    unused_param_rows = ()

    def __init__(self, dist: Distribution, p_ix: int):
        if p_ix < 0:
            raise ValueError("p_ix must be non-negative")
        self.dist = dist
        self.p_ix = int(p_ix)

    def to(self, device):
        self.dist = self.dist.to(device)
        return self

    def apply(self, theta, ncomp: int, plain: bool = False):
        ix = self.p_ix
        theta[..., ix, :] = ppf_interp(self.dist, theta[..., ix, :], plain)
        return theta


class ConstantPrior(Prior):
    """Fixed value."""

    def __init__(self, value, p_ix):
        self.value = float(value)
        self.p_ix = int(p_ix)
        self.dist = None
        self.unused_param_rows = (self.p_ix,)

    def to(self, device):
        return self

    def apply(self, theta, ncomp, plain=False):
        theta[..., self.p_ix, :] = self.value
        return theta


class ResolvedPlacementPrior(Prior):
    """Sequential N-component centroid placement with minimum resolved
    separations ``scale * FWHM * sqrt(sigma_i sigma_{i-1})``.

    Components are placed left to right; each draw inverts the centroid
    CDF renormalised over the remaining interval with a power-law taper
    of exponent ``ncomp - 1 - i``, and the separations shrink to fit
    when their sum exceeds the full interval.
    """

    n_param = 2

    def __init__(self, vcen_prior, sigm_prior, scale=1.5):
        self.vcen_prior = vcen_prior
        self.sigm_prior = sigm_prior
        self.scale = float(scale)
        self.sep_scale = FWHM * float(scale)
        self.p_ix = vcen_prior.p_ix
        self.dist = vcen_prior.dist

    def to(self, device):
        self.vcen_prior.to(device)
        self.sigm_prior.to(device)
        self.dist = self.vcen_prior.dist
        return self

    def apply(self, theta, ncomp, plain=False):
        dist = self.vcen_prior.dist
        theta = self.sigm_prior.apply(theta, ncomp, plain)
        ix_v = self.vcen_prior.p_ix
        ix_s = self.sigm_prior.p_ix
        u = theta[..., ix_v, :].clone()
        if ncomp == 1:
            theta[..., ix_v, 0] = ppf_interp(dist, u[..., 0], plain)
            return theta
        sig = theta[..., ix_s, :]
        seps = [torch.zeros_like(sig[..., 0])]
        for i in range(1, ncomp):
            seps.append(self.sep_scale
                        * torch.sqrt(sig[..., i] * sig[..., i - 1]))
        min_seps = torch.stack(seps, dim=-1)              # [..., ncomp]
        sep_tot = torch.sum(min_seps, dim=-1)
        v_range = dist.xmax - dist.xmin
        # shrink to fit
        factor = torch.where(sep_tot > v_range, v_range / sep_tot, 1.0)
        min_seps = min_seps * factor[..., None]
        sep_tot = sep_tot * factor
        v_lo = torch.full_like(sep_tot, dist.xmin)
        v_hi = dist.xmax - sep_tot
        for i in range(ncomp):
            sep = min_seps[..., i]
            v_lo = v_lo + sep
            v_hi = v_hi + sep
            sfact = ncomp - 1 - i
            if sfact <= 2:
                v = tapered_interval_invert(dist, u[..., i], v_lo, v_hi,
                                            sfact, plain)
            else:
                # dense form, reached only at ncomp >= 4
                cdf = cdf_over_interval(dist, v_lo, v_hi, float(sfact))
                v = cdf_interp(cdf, u[..., i], xax=dist.xax, dx=dist.dx)
            theta[..., ix_v, i] = v
            v_lo = v
        return theta


class PriorTransformer:
    """Applies a sequence of priors to the unit cube."""

    def __init__(self, priors):
        priors = list(priors)
        if not priors:
            raise ValueError("no priors")
        self.priors = priors
        self.n_prior = len(priors)
        self.n_param = sum(p.n_param for p in priors)

    def to(self, device) -> "PriorTransformer":
        """Move every table to ``device`` (in place); returns self."""
        for p in self.priors:
            p.to(device)
        return self

    def transform(self, utheta, ncomp: int, plain: bool = False):
        """``u[..., n_param*ncomp]`` -> ``theta[..., n_param*ncomp]``.

        ``plain=True`` uses the plain PyTorch versions of the table
        kernels on any device; by default CUDA tensors go through the
        kernels and CPU tensors through the plain versions."""
        ndim = utheta.shape[-1]
        if self.n_param * ncomp != ndim:
            raise ValueError(f"Invalid shape for ncomp={ncomp}: {ndim}")
        lead = utheta.shape[:-1]
        theta = utheta.reshape(lead + (self.n_param, ncomp)).clone()
        for prior in self.priors:
            theta = prior.apply(theta, ncomp, plain)
        return theta.reshape(lead + (ndim,))

    def flat_dims(self, ncomp: int):
        """Unit-cube indices the transform ignores."""
        dims = []
        for prior in self.priors:
            for row in getattr(prior, "unused_param_rows", ()):
                dims.extend(row * ncomp + i for i in range(ncomp))
        return tuple(sorted(dims))
