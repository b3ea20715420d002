"""Gaussian mixture line model (port of ``nestfit_tpu/models/gaussian.py``).

Three parameters per component, parameter-major packed
``params[p * ncomp + i]``: voff [km/s], sigm [km/s], peak [K].  The
profile is evaluated densely over the channel axis.  ``gauss_predict``
is the plain PyTorch model; ``fused_chi2`` computes the same prediction
and its squared residual against the data in one launch of the Hopper
kernel ``ops.fused.gauss_chi2_fused``.
"""

import torch

from nestfit_tpu_torch.constants import CKMS
from nestfit_tpu_torch.models.ammonia import unpack_params
from nestfit_tpu_torch.models.hyperfine import _ARG_MAX
from nestfit_tpu_torch.models.spectrum import Spectrum, make_spectrum

N_PARAMS = 3


def mixture(dnu, voff, sigm, peak, rest_freq_over_c):
    """Summed Gaussian profiles ``[..., S]`` of components ``[..., C]``
    on the ``[S]`` channel offsets ``dnu`` from the rest frequency::

        pred(s) = sum_c peak_c exp(-(dnu_s + voff_c f)^2 / (2 (sigm_c f)^2))

    with ``f = rest_freq / c``.  Far wings underflow to zero directly:
    below float32's normal range the CPU exp takes a subnormal path
    ~100x slower."""
    rel_cen = -voff * rest_freq_over_c                   # [..., C]
    nu_width = sigm * rest_freq_over_c
    idenom = 0.5 / (nu_width * nu_width)
    d = dnu - rel_cen[..., None]                         # [..., C, S]
    arg = (d * d) * idenom[..., None]
    prof = torch.where(arg < _ARG_MAX,
                       torch.exp(-torch.clamp(arg, max=_ARG_MAX)), 0.0)
    return torch.sum(peak[..., None] * prof, dim=-2)


def _components(spec: Spectrum, params):
    p = unpack_params(params.to(spec.dnu.dtype), N_PARAMS)
    return tuple(p[..., i, :] for i in range(N_PARAMS))


def gauss_predict(spec: Spectrum, params):
    """Predicted spectrum ``[..., S]`` for parameter-major ``params``
    ``[..., 3*ncomp]``; ``spec.rest_freq`` is the velocity reference."""
    voff, sigm, peak = _components(spec, params)
    return mixture(spec.dnu, voff, sigm, peak, spec.rest_freq / CKMS)


def fused_chi2(spec: Spectrum, params_flat):
    """Summed squared residual ``[B]`` for flat-batched ``params_flat``
    ``[B, 3*ncomp]``; row ``b`` is held against data row ``b % R``.

    One launch of the Hopper kernel on CUDA tensors, its plain version
    on CPU tensors (``ops/fused.py``)."""
    from nestfit_tpu_torch.ops import fused

    voff, sigm, peak = _components(spec, params_flat.float())
    return fused.gauss_chi2_fused(
        spec.rest_freq / CKMS, spec.dnu, spec.data,
        *(x.contiguous() for x in (voff, sigm, peak)))


def make_gaussian_spectrum(xarr, data, noise, trans_id=-1, device="cuda",
                           **kw) -> Spectrum:
    """Plain Spectrum; ``rest_freq`` defaults to the axis midpoint."""
    return make_spectrum(xarr, data, noise, trans_id=trans_id,
                         device=device, **kw)


N = N_PARAMS
IX_VCEN = 0
IX_SIGM = 1
NAME = "gaussian"
model_predict = gauss_predict
make_model_spectrum = make_gaussian_spectrum
TRANSITIONS = ()

PAR_NAMES = ["voff", "sigm", "peak"]
PAR_NAMES_SHORT = ["v", "s", "pk"]
TEX_LABELS = [
    r"$v_\mathrm{lsr}$",
    r"$\sigma_\mathrm{v}$",
    r"$T_\mathrm{pk}$",
]
TEX_LABELS_WITH_UNITS = [
    r"$v_\mathrm{lsr} \ [\mathrm{km\, s^{-1}}]$",
    r"$\sigma_\mathrm{v} \ [\mathrm{km\, s^{-1}}]$",
    r"$T_\mathrm{pk} \ [\mathrm{K}]$",
]


def get_par_names(ncomp=None):
    if ncomp is not None:
        return [f"{label}{n}" for label in PAR_NAMES_SHORT
                for n in range(1, ncomp + 1)]
    return PAR_NAMES_SHORT
