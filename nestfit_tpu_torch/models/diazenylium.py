"""Diazenylium (N2H+) hyperfine model
(port of ``nestfit_tpu/models/diazenylium.py``).

Four parameters per component, parameter-major packed
``params[p * ncomp + i]``: voff [km/s], tex [K], ltau (log10 main-line
optical depth), sigm [km/s].  The optical depth is a direct parameter,
so there is no partition function.  ``nnhp_predict`` is the plain
PyTorch model; ``fused_chi2`` computes the same prediction and its
squared residual against the data in one launch of the Hopper kernel
``ops.fused.hf_chi2_fused`` (the NH3 model's kernel, up to its
``MAX_LINES`` hyperfine lines: N2H+ (3-2) has 45), and ``fused_lnl`` the
whole ln-likelihood over every transition in one launch of
``ops.fused.hf_lnl_fused``.
"""

import numpy as np
import torch

from nestfit_tpu_torch.models import hyperfine
from nestfit_tpu_torch.models.ammonia import unpack_params
from nestfit_tpu_torch.models.spectrum import Spectrum, make_spectrum
from nestfit_tpu_torch.models.tables import DIAZENYLIUM_TRANSITIONS

N_PARAMS = 4


def _component_params(spec: Spectrum, params):
    """The transition and per-component ``(voff, tex, tau_main, sigm)``,
    each ``[..., ncomp]``."""
    trans = DIAZENYLIUM_TRANSITIONS[spec.trans_id - 1]
    p = unpack_params(params.to(spec.dnu.dtype), N_PARAMS)
    voff, tex, ltau, sigm = (p[..., i, :] for i in range(N_PARAMS))
    return trans, voff, tex, 10.0 ** ltau, sigm


def nnhp_predict(spec: Spectrum, params):
    """Predicted spectrum ``[..., S]`` for parameter-major ``params``
    ``[..., 4*ncomp]``: the sum of the components' brightness."""
    trans, voff, tex, tau0, sigm = _component_params(spec, params)
    tb = hyperfine.hf_predict(trans, spec.dnu, spec.t0, spec.tbg,
                              voff, tex, tau0, sigm)     # [..., ncomp, S]
    return torch.sum(tb, dim=-2)


def fused_chi2(spec: Spectrum, params_flat):
    """Summed squared residual ``[B]`` for flat-batched ``params_flat``
    ``[B, 4*ncomp]``; row ``b`` is held against data row ``b % R``.

    One launch of the Hopper kernel on CUDA tensors, its plain version
    on CPU tensors (``ops/fused.py``)."""
    from nestfit_tpu_torch.ops import fused

    trans, voff, tex, tau0, sigm = _component_params(spec,
                                                     params_flat.float())
    return fused.hf_chi2_fused(
        trans, spec.dnu, spec.t0, spec.tbg, spec.data,
        *(x.contiguous() for x in (voff, tex, tau0, sigm)))


def lnl_model():
    """The model as ``ops.fused.hf_lnl_fused`` takes it (its kernel step
    reads no constants)."""
    from nestfit_tpu_torch.ops import fused

    return fused.LnlModel(fused.PREP_DIAZENYLIUM, N_PARAMS,
                          DIAZENYLIUM_TRANSITIONS, _component_params,
                          lambda trans: np.zeros(0, np.float32))


def fused_lnl(spectra, params_flat):
    """Ln-likelihood ``[B]`` of flat-batched ``params_flat``
    ``[B, 4*ncomp]`` over ``spectra`` (row ``b`` against data row
    ``b % R``): one launch of ``ops.fused.hf_lnl_fused`` on CUDA tensors,
    which computes ``10**ltau`` itself; its plain version on CPU
    tensors."""
    from nestfit_tpu_torch.ops import fused

    return fused.hf_lnl_fused(lnl_model(), tuple(spectra),
                              params_flat.float().contiguous())


def make_diazenylium_spectrum(xarr, data, noise, trans_id=1, device="cuda",
                              **kw) -> Spectrum:
    """Spectrum of N2H+ transition ``trans_id`` (1 -> (1-0), 2 -> (2-1),
    3 -> (3-2)) with its rest frequency from the transition table."""
    if not 1 <= trans_id <= len(DIAZENYLIUM_TRANSITIONS):
        raise ValueError(f"no diazenylium transition {trans_id}")
    trans = DIAZENYLIUM_TRANSITIONS[trans_id - 1]
    return make_spectrum(xarr, data, noise, rest_freq=trans.nu,
                         trans_id=trans_id, device=device, **kw)


N = N_PARAMS
IX_VCEN = 0
IX_SIGM = 3
NAME = "diazenylium"
model_predict = nnhp_predict
make_model_spectrum = make_diazenylium_spectrum
TRANSITIONS = DIAZENYLIUM_TRANSITIONS

PAR_NAMES = ["voff", "tex", "ltau", "sigm"]
PAR_NAMES_SHORT = ["v", "Tx", "lt", "s"]
TEX_LABELS = [
    r"$v_\mathrm{lsr}$",
    r"$T_\mathrm{ex}$",
    r"$\log(\tau_0)$",
    r"$\sigma_\mathrm{v}$",
]
TEX_LABELS_WITH_UNITS = [
    r"$v_\mathrm{lsr} \ [\mathrm{km\, s^{-1}}]$",
    r"$T_\mathrm{ex} \ [\mathrm{K}]$",
    r"$\log(\tau_0)$",
    r"$\sigma_\mathrm{v} \ [\mathrm{km\, s^{-1}}]$",
]


def get_par_names(ncomp=None):
    if ncomp is not None:
        return [f"{label}{n}" for label in PAR_NAMES_SHORT
                for n in range(1, ncomp + 1)]
    return PAR_NAMES_SHORT
