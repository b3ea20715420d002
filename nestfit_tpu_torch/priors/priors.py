"""Prior transforms: unit cube -> physical parameters
(port of ``nestfit_tpu/priors/priors.py``).

Every prior transforms its rows of the parameter cube
``theta[..., n_params, ncomp]`` (parameter-major layout); a
:class:`PriorTransformer` applies them in sequence.  All transforms
broadcast over leading batch dims.  ``apply`` writes into ``theta``,
which :meth:`PriorTransformer.transform` allocates afresh for each call,
so the caller's unit-cube tensor is never modified; a prior that reads
its unit-cube row after writing part of it reads a copy.  Every table
lookup goes through K2 (``ppf_interp``) or K3
(``tapered_interval_invert``); ``plain=True`` takes their plain PyTorch
versions on any device.

:meth:`PriorTransformer.transform` runs a transformer whose priors are
all :class:`Prior`, :class:`DuplicatePrior`, :class:`ConstantPrior` or
:class:`ResolvedPlacementPrior` (the last at ncomp <= 3) in one launch of
``ops.tables.prior_transform_fused`` (its plain version on the CPU), the
same float32 operations in one kernel; any other transformer takes the
per-prior path, :func:`transform_per_prior`.
"""

import torch

from nestfit_tpu_torch.constants import FWHM
from nestfit_tpu_torch.ops import _build
from nestfit_tpu_torch.ops import tables as table_ops
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


class DuplicatePrior(Prior):
    """Draw once, write to two parameter rows (e.g. tex = tkin in LTE
    synthetic fits)."""

    n_param = 2

    def __init__(self, dist, p_ix, p_ix_dup):
        super().__init__(dist, p_ix)
        if p_ix_dup < 0:
            raise ValueError("p_ix_dup must be non-negative")
        self.p_ix_dup = int(p_ix_dup)
        self.unused_param_rows = (self.p_ix_dup,)

    def apply(self, theta, ncomp, plain=False):
        v = ppf_interp(self.dist, theta[..., self.p_ix, :], plain)
        theta[..., self.p_ix, :] = v
        theta[..., self.p_ix_dup, :] = v
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


class OrderedPrior(Prior):
    """Strict left-to-right ordering by nested rescaling of the unit
    interval."""

    def apply(self, theta, ncomp, plain=False):
        u = theta[..., self.p_ix, :].clone()
        umin = torch.zeros_like(u[..., 0])
        for i in range(ncomp):
            umin = umin + (1.0 - umin) * u[..., i]
            theta[..., self.p_ix, i] = ppf_interp(self.dist, umin, plain)
        return theta


class SpacedPrior(Prior):
    """The first draw from an independent prior; each later draw is a
    positive offset from the running value."""

    def __init__(self, prior_indep: Prior, prior_depen: Prior):
        self.prior_indep = prior_indep
        self.prior_depen = prior_depen
        self.p_ix = prior_indep.p_ix
        self.dist = prior_indep.dist

    def to(self, device):
        self.prior_indep.to(device)
        self.prior_depen.to(device)
        self.dist = self.prior_indep.dist
        return self

    def apply(self, theta, ncomp, plain=False):
        ix = self.p_ix
        u = theta[..., ix, :].clone()
        v = ppf_interp(self.prior_indep.dist, u[..., 0], plain)
        theta[..., ix, 0] = v
        for i in range(1, ncomp):
            v = v + ppf_interp(self.prior_depen.dist, u[..., i], plain)
            theta[..., ix, i] = v
        return theta


class CenSepPrior(Prior):
    """Centre +- separation/2 for two components."""

    def __init__(self, vcen_prior: Prior, vsep_prior: Prior):
        self.vcen_prior = vcen_prior
        self.vsep_prior = vsep_prior
        self.p_ix = vcen_prior.p_ix
        self.dist = vcen_prior.dist

    def to(self, device):
        self.vcen_prior.to(device)
        self.vsep_prior.to(device)
        self.dist = self.vcen_prior.dist
        return self

    def min_sep(self, theta):
        """Floor of the separation (none here)."""
        return None

    def apply(self, theta, ncomp, plain=False):
        if ncomp > 2:
            raise NotImplementedError(
                f"{type(self).__name__} supports ncomp <= 2")
        ix = self.p_ix
        u = theta[..., ix, :].clone()
        vcen = ppf_interp(self.vcen_prior.dist, u[..., 0], plain)
        if ncomp == 1:
            theta[..., ix, 0] = vcen
            return theta
        vsep = ppf_interp(self.vsep_prior.dist, u[..., 1], plain)
        floor = self.min_sep(theta)
        if floor is not None:
            vsep = torch.maximum(vsep, floor)
        theta[..., ix, 0] = vcen - 0.5 * vsep
        theta[..., ix, 1] = vcen + 0.5 * vsep
        return theta


class ResolvedCenSepPrior(CenSepPrior):
    """Centre/separation with the separation floored at ``scale`` times
    the FWHM of the components' geometric-mean width, so the two stay
    spectrally resolved."""

    n_param = 2

    def __init__(self, vcen_prior, vsep_prior, sigm_prior, scale=1.5):
        super().__init__(vcen_prior, vsep_prior)
        self.sigm_prior = sigm_prior
        self.scale = float(scale)
        self.sep_scale = FWHM * float(scale)

    def to(self, device):
        self.sigm_prior.to(device)
        return super().to(device)

    def min_sep(self, theta):
        sig = theta[..., self.sigm_prior.p_ix, :]
        return self.sep_scale * torch.sqrt(sig[..., 0] * sig[..., 1])

    def apply(self, theta, ncomp, plain=False):
        if ncomp > 2:
            raise NotImplementedError(
                f"{type(self).__name__} supports ncomp <= 2")
        theta = self.sigm_prior.apply(theta, ncomp, plain)
        return super().apply(theta, ncomp, plain)


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
        self._programs = {}

    def __getstate__(self):
        # a copy packs its own programs: they hold table addresses
        return {**self.__dict__, "_programs": {}}

    def to(self, device) -> "PriorTransformer":
        """Move every table to ``device`` (in place); returns self."""
        for p in self.priors:
            p.to(device)
        self._programs = {}
        return self

    def program(self, ncomp: int, device):
        """The transformer packed for ``ops.tables.prior_transform_fused``
        at ``ncomp`` on ``device`` (once a pair), or ``None`` where it
        takes the per-prior path: a prior of another class, or what
        ``pack_program`` refuses (a placement past ncomp 3, its dense
        form, among them)."""
        key = (str(device), int(ncomp))
        if key not in self._programs:
            ops = _pack_ops(self.priors)
            self._programs[key] = None if ops is None else \
                table_ops.pack_program(ops, self.n_param, ncomp, device)
        return self._programs[key]

    def transform(self, utheta, ncomp: int, plain: bool = False):
        """``u[..., n_param*ncomp]`` -> ``theta[..., n_param*ncomp]``.

        ``plain=True`` runs the per-prior path with the plain PyTorch
        versions of the table kernels on any device (the reference).
        Otherwise a transformer that :meth:`program` packs takes one
        launch on CUDA tensors (its plain version on CPU tensors), and any
        other the per-prior path with the kernels on CUDA tensors."""
        ndim = utheta.shape[-1]
        if self.n_param * ncomp != ndim:
            raise ValueError(f"Invalid shape for ncomp={ncomp}: {ndim}")
        lead = utheta.shape[:-1]
        if not plain and utheta.dtype == torch.float32:
            prog = self.program(ncomp, utheta.device)
            if prog is not None:
                u = utheta.reshape(-1, ndim).contiguous()
                return table_ops.prior_transform_fused(prog, u).reshape(
                    lead + (ndim,))
        return transform_per_prior(self.priors, utheta, ncomp, plain)

    def flat_dims(self, ncomp: int):
        """Unit-cube indices the transform ignores."""
        dims = []
        for prior in self.priors:
            for row in getattr(prior, "unused_param_rows", ()):
                dims.extend(row * ncomp + i for i in range(ncomp))
        return tuple(sorted(dims))


def transform_per_prior(priors, utheta, ncomp: int, plain: bool = False):
    """Apply ``priors`` in order to ``utheta`` ``[..., n_param*ncomp]``,
    one prior's operations and table kernels after another (the plain
    versions with ``plain=True``).  Counts ``prior.split`` unless
    ``plain``, per launch and per graph replay like a kernel."""
    lead = utheta.shape[:-1]
    n_param = sum(p.n_param for p in priors)
    theta = utheta.reshape(lead + (n_param, ncomp)).clone()
    for prior in priors:
        theta = prior.apply(theta, ncomp, plain)
    if not plain:
        if utheta.is_cuda:
            _build.count_launch(transform_per_prior)
        else:
            _build.count_call(transform_per_prior)
    return theta.reshape(lead + (utheta.shape[-1],))


transform_per_prior.launches = 0
transform_per_prior.counter = "prior.split"


def _simple_op(prior):
    """The packed op of a one-row prior, or ``None`` for another class."""
    cls = type(prior)
    if cls is Prior:
        return table_ops.PriorOp(table_ops.PPF, prior.p_ix, dist=prior.dist)
    if cls is DuplicatePrior:
        return table_ops.PriorOp(table_ops.DUPLICATE, prior.p_ix,
                                 prior.p_ix_dup, dist=prior.dist)
    if cls is ConstantPrior:
        return table_ops.PriorOp(table_ops.CONSTANT, prior.p_ix,
                                 value=prior.value)
    return None


def _pack_ops(priors):
    """The packed ops of ``priors`` in order (a placement as its width
    prior's op, then its own), or ``None`` where a prior has no op."""
    ops = []
    for prior in priors:
        if type(prior) is ResolvedPlacementPrior:
            width = _simple_op(prior.sigm_prior)
            if width is None:
                return None
            ops += [width, table_ops.PriorOp(
                table_ops.PLACEMENT, prior.vcen_prior.p_ix,
                prior.sigm_prior.p_ix, dist=prior.vcen_prior.dist,
                value=prior.sep_scale)]
            continue
        op = _simple_op(prior)
        if op is None:
            return None
        ops.append(op)
    return ops
