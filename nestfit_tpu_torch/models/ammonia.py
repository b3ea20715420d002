"""Ammonia (NH3) inversion-transition model
(port of ``nestfit_tpu/models/ammonia.py``).

Six parameters per velocity component, parameter-major packed
``params[p * ncomp + i]``: voff [km/s], trot [K], tex [K], ntot
[log10 cm^-2], sigm [km/s], orth [0-1].  ``amm_predict`` is the plain
PyTorch model; ``fused_chi2`` computes the same prediction and its
squared residual against the data in one launch of the Hopper kernel
``ops.fused.hf_chi2_fused``, and ``fused_lnl`` the whole ln-likelihood
over every transition in one launch of ``ops.fused.hf_lnl_fused``.
"""

import math

import numpy as np
import torch

from nestfit_tpu_torch.constants import CKMS, CCMS, H, KB
from nestfit_tpu_torch.models import hyperfine
from nestfit_tpu_torch.models.spectrum import Spectrum, make_spectrum
from nestfit_tpu_torch.models.tables import AMMONIA_TRANSITIONS, Transition

# Ammonia rotation constants, Coudert & Roueff (2006) A&A 449 855
BROT = 298192.92e6
CROT = 186695.86e6
# Legacy constants, Poynter & Kakar (1975)
BROT_OLD = 298117.06e6
CROT_OLD = 186726.36e6

# Partition function summed over J = 0..50
NPART = 51
_J_ALL = np.arange(NPART)
JORTH = _J_ALL[_J_ALL % 3 == 0]    # 17 ortho levels
JPARA = _J_ALL[_J_ALL % 3 != 0]    # 34 para levels

N_PARAMS = 6


def _level_energy_k(j, brot=BROT, crot=CROT):
    """Rotational level energy over KB in Kelvin."""
    j = np.asarray(j, dtype=np.float64)
    return H * (brot * j * (j + 1) + (crot - brot) * j * j) / KB


_E_ORTH = _level_energy_k(JORTH)
_E_PARA = _level_energy_k(JPARA)
_G_ORTH = 2.0 * JORTH + 1.0
_G_PARA = 2.0 * JPARA + 1.0


def swift_convert(tkin):
    """Kinetic -> rotation temperature, Swift et al. (2005) eq. A6."""
    return tkin / (1.0 + (tkin / 41.18)
                   * torch.log(1.0 + 0.6 * torch.exp(-15.7 / tkin)))


def partition_level(j, trot):
    """``(2j+1) exp(-E_j/(KB trot))`` for one level ``j``."""
    e_j = float(_level_energy_k(j))
    return (2.0 * j + 1.0) * torch.exp(-e_j / trot)


#: the level tables on each device and dtype (a likelihood call copies
#: nothing from the host, so it can be captured in a CUDA graph)
_LEVELS = {}


def partition_func(para: bool, trot):
    """Partition function over the para or ortho J levels (ortho levels
    carry the spin degeneracy factor 2)."""
    key = (para, trot.dtype, trot.device)
    if key not in _LEVELS:
        e, g = (_E_PARA, _G_PARA) if para else (_E_ORTH, _G_ORTH)
        _LEVELS[key] = tuple(torch.as_tensor(x, dtype=trot.dtype,
                                             device=trot.device)
                             for x in (e, g))
    e, g = _LEVELS[key]
    q = torch.sum(g * torch.exp(-e / trot[..., None]), dim=-1)
    return q if para else 2.0 * q


def tau_main(trans: Transition, trot, tex, ntot, sigm, orth):
    """Main-line optical depth of one component."""
    zlev = partition_level(trans.n, trot)
    qtot = partition_func(trans.para, trot)
    species_frac = (1.0 - orth) if trans.para else orth
    pop_rotstate = 10.0 ** ntot * species_frac * zlev / qtot
    t0r = H * trans.nu / KB
    eterm = torch.exp(-t0r / tex)
    expterm = (1.0 - eterm) / (1.0 + eterm)
    fracterm = CCMS**2 * trans.ea / (8.0 * np.pi * trans.nu**2)
    widthterm = CKMS / (sigm * trans.nu * math.sqrt(2.0 * np.pi))
    return pop_rotstate * fracterm * expterm * widthterm


def unpack_params(params, n_params: int):
    """``[..., n_params*ncomp]`` -> ``[..., n_params, ncomp]``."""
    ndim = params.shape[-1]
    if ndim % n_params:
        raise ValueError(f"{ndim} parameters is no multiple of {n_params}")
    return params.reshape(params.shape[:-1] + (n_params, ndim // n_params))


def _component_params(spec: Spectrum, params, cold: bool, lte: bool):
    """Per-component ``(voff, tex, tau0, sigm)``, each ``[..., ncomp]``."""
    trans = AMMONIA_TRANSITIONS[spec.trans_id - 1]
    p = unpack_params(params.to(spec.dnu.dtype), N_PARAMS)
    voff, trot, tex, ntot, sigm, orth = (p[..., i, :] for i in range(N_PARAMS))
    if cold:
        trot = swift_convert(trot)
    if lte:
        tex = trot
    return trans, voff, tex, tau_main(trans, trot, tex, ntot, sigm, orth), sigm


def amm_predict(spec: Spectrum, params, cold: bool = False,
                lte: bool = False):
    """Predicted spectrum ``[..., S]`` for parameter-major ``params``
    ``[..., 6*ncomp]``: the sum of the components' brightness (optically
    thin slabs with respect to each other)."""
    trans, voff, tex, tau0, sigm = _component_params(spec, params, cold, lte)
    tb = hyperfine.hf_predict(trans, spec.dnu, spec.t0, spec.tbg,
                              voff, tex, tau0, sigm)     # [..., ncomp, S]
    return torch.sum(tb, dim=-2)


def fused_chi2(spec: Spectrum, params_flat, cold: bool = False,
               lte: bool = False):
    """Summed squared residual ``[B]`` for flat-batched ``params_flat``
    ``[B, 6*ncomp]``; row ``b`` is held against data row ``b % R``.

    One launch of the Hopper kernel on CUDA tensors, its plain version
    on CPU tensors (``ops/fused.py``)."""
    from nestfit_tpu_torch.ops import fused

    trans, voff, tex, tau0, sigm = _component_params(
        spec, params_flat.float(), cold, lte)
    return fused.hf_chi2_fused(
        trans, spec.dnu, spec.t0, spec.tbg, spec.data,
        *(x.contiguous() for x in (voff, tex, tau0, sigm)))


def lnl_constants(trans: Transition) -> np.ndarray:
    """What the one-launch likelihood's NH3 step (``AmmoniaPrep`` in
    ``csrc/hf_chi2.cu``) reads of ``trans``, as float32: ``[H nu / KB,
    E_n / KB, 2n + 1, 1 (para) or 2 (ortho), 1 (para) or 0, c^2 A / (8 pi
    nu^2), nu, sqrt(2 pi), c]`` (:func:`tau_main`'s constants, rounded as
    PyTorch rounds them there), then ``(E_l / KB, g_l)`` of every level
    of the species (:func:`partition_func`'s tables)."""
    e, g = (_E_PARA, _G_PARA) if trans.para else (_E_ORTH, _G_ORTH)
    head = [H * trans.nu / KB, float(_level_energy_k(trans.n)),
            2.0 * trans.n + 1.0, 1.0 if trans.para else 2.0,
            1.0 if trans.para else 0.0,
            CCMS**2 * trans.ea / (8.0 * np.pi * trans.nu**2), trans.nu,
            math.sqrt(2.0 * np.pi), CKMS]
    return np.concatenate([head, np.stack([e, g], axis=1).ravel()]).astype(
        np.float32)


def lnl_model():
    """The model as ``ops.fused.hf_lnl_fused`` takes it (at the default
    ``cold``/``lte``)."""
    from nestfit_tpu_torch.ops import fused

    return fused.LnlModel(
        fused.PREP_AMMONIA, N_PARAMS, AMMONIA_TRANSITIONS,
        lambda spec, p: _component_params(spec, p, False, False),
        lnl_constants)


def fused_lnl(spectra, params_flat):
    """Ln-likelihood ``[B]`` of flat-batched ``params_flat``
    ``[B, 6*ncomp]`` over ``spectra`` (row ``b`` against data row
    ``b % R``) at the default ``cold``/``lte``: one launch of
    ``ops.fused.hf_lnl_fused`` on CUDA tensors, which computes
    :func:`tau_main` per transition itself; its plain version on CPU
    tensors."""
    from nestfit_tpu_torch.ops import fused

    return fused.hf_lnl_fused(lnl_model(), tuple(spectra),
                              params_flat.float().contiguous())


def make_ammonia_spectrum(xarr, data, noise, trans_id=1, device="cuda",
                          **kw) -> Spectrum:
    """Spectrum of NH3 transition ``trans_id`` (1 -> (1,1), 2 -> (2,2),
    ...) with its rest frequency from the transition table."""
    if not 1 <= trans_id <= len(AMMONIA_TRANSITIONS):
        raise ValueError(f"no ammonia transition {trans_id}")
    trans = AMMONIA_TRANSITIONS[trans_id - 1]
    return make_spectrum(xarr, data, noise, rest_freq=trans.nu,
                         trans_id=trans_id, device=device, **kw)


N = N_PARAMS
IX_VCEN = 0
IX_SIGM = 4
NAME = "ammonia"
model_predict = amm_predict
make_model_spectrum = make_ammonia_spectrum
TRANSITIONS = AMMONIA_TRANSITIONS

PAR_NAMES = ["voff", "trot", "tex", "ntot", "sigm", "orth"]
PAR_NAMES_SHORT = ["v", "Tk", "Tx", "N", "s", "o"]
TEX_LABELS = [
    r"$v_\mathrm{lsr}$",
    r"$T_\mathrm{rot}$",
    r"$T_\mathrm{ex}$",
    r"$\log(N_\mathrm{p})$",
    r"$\sigma_\mathrm{v}$",
    r"$f_\mathrm{o}$",
]
TEX_LABELS_WITH_UNITS = [
    r"$v_\mathrm{lsr} \ [\mathrm{km\, s^{-1}}]$",
    r"$T_\mathrm{rot} \ [\mathrm{K}]$",
    r"$T_\mathrm{ex} \ [\mathrm{K}]$",
    r"$\log(N) \ [\log(\mathrm{cm^{-2}})]$",
    r"$\sigma_\mathrm{v} \ [\mathrm{km\, s^{-1}}]$",
    r"$f_\mathrm{o}$",
]


def get_par_names(ncomp=None):
    if ncomp is not None:
        return [f"{label}{n}" for label in PAR_NAMES_SHORT
                for n in range(1, ncomp + 1)]
    return PAR_NAMES_SHORT
