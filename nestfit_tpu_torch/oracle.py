"""Independent float64 NumPy evaluation of the NH3, N2H+ and Gaussian
models (the physics part of ``nestfit_tpu/oracle.py``, copied): absolute
frequencies, scalar loops, no relative-axis trick.  The synthetic cube
generator and ``chip_smoke.py`` use it to make truth spectra.
"""

import numpy as np

from nestfit_tpu_torch.constants import CKMS, CCMS, H, KB, TCMB
from nestfit_tpu_torch.models.ammonia import BROT, CROT
from nestfit_tpu_torch.models.tables import (
    AMMONIA_TRANSITIONS,
    DIAZENYLIUM_TRANSITIONS,
)


def hf_tb(xarr, trans, voff, tex, tau_main, sigm, tcmb=TCMB):
    """Brightness-temperature profile of one hyperfine component.

    Same physics as reference hyperfine.pyx:52-118 (exact branch),
    evaluated densely in float64 with absolute frequencies.
    """
    xarr = np.asarray(xarr, dtype=np.float64)
    tau = np.zeros_like(xarr)
    for v_j, w_j in zip(trans.voff, trans.tau_wts):
        hf_freq = (1.0 - v_j / CKMS) * trans.nu
        hf_width = sigm / CKMS * hf_freq
        hf_nucen = hf_freq - voff / CKMS * hf_freq
        d = xarr - hf_nucen
        tau += tau_main * w_j * np.exp(-0.5 * d * d / (hf_width * hf_width))
    t0 = H * xarr / KB
    tbg = 1.0 / np.expm1(t0 / tcmb)
    return t0 * (1.0 / np.expm1(t0 / tex) - tbg) * (1.0 - np.exp(-tau))


def amm_partition_level(j, trot, brot=BROT, crot=CROT):
    return (2 * j + 1) * np.exp(
        -H * (brot * j * (j + 1) + (crot - brot) * j * j) / (KB * trot)
    )


def amm_partition_func(para, trot, brot=BROT, crot=CROT):
    qtot = 0.0
    for j in range(51):
        if para and j % 3 != 0:
            qtot += amm_partition_level(j, trot, brot, crot)
        elif not para and j % 3 == 0:
            qtot += 2 * amm_partition_level(j, trot, brot, crot)
    return qtot


def swift_convert(tkin):
    return tkin / (
        1.0 + (tkin / 41.18) * np.log(1.0 + 0.6 * np.exp(-15.7 / tkin))
    )


def amm_tau_main(trans, trot, tex, ntot, sigm, orth):
    """Main-line optical depth (reference ammonia.pyx:349-360)."""
    zlev = amm_partition_level(trans.n, trot)
    qtot = amm_partition_func(trans.para, trot)
    species_frac = (1.0 - orth) if trans.para else orth
    pop_rotstate = 10.0 ** ntot * species_frac * zlev / qtot
    expterm = (1.0 - np.exp(-H * trans.nu / (KB * tex))) / (
        1.0 + np.exp(-H * trans.nu / (KB * tex))
    )
    fracterm = CCMS**2 * trans.ea / (8 * np.pi * trans.nu**2)
    widthterm = CKMS / (sigm * trans.nu * np.sqrt(2 * np.pi))
    return pop_rotstate * fracterm * expterm * widthterm


def amm_predict(xarr, params, trans_id=1, cold=False, lte=False):
    """Multi-component ammonia spectrum (reference ammonia.pyx:326-361).

    ``params`` is parameter-major packed: [voff*n, trot*n, tex*n,
    ntot*n, sigm*n, orth*n].
    """
    params = np.asarray(params, dtype=np.float64)
    ncomp = params.shape[0] // 6
    trans = AMMONIA_TRANSITIONS[trans_id - 1]
    pred = np.zeros_like(np.asarray(xarr, dtype=np.float64))
    for i in range(ncomp):
        voff = params[i]
        trot = params[ncomp + i]
        tex = params[2 * ncomp + i]
        ntot = params[3 * ncomp + i]
        sigm = params[4 * ncomp + i]
        orth = params[5 * ncomp + i]
        if cold:
            trot = swift_convert(trot)
        if lte:
            tex = trot
        tau0 = amm_tau_main(trans, trot, tex, ntot, sigm, orth)
        pred += hf_tb(xarr, trans, voff, tex, tau0, sigm)
    return pred


def nnhp_predict(xarr, params, trans_id=1):
    """Multi-component N2H+ spectrum (reference diazenylium.pyx:140-155)."""
    params = np.asarray(params, dtype=np.float64)
    ncomp = params.shape[0] // 4
    trans = DIAZENYLIUM_TRANSITIONS[trans_id - 1]
    pred = np.zeros_like(np.asarray(xarr, dtype=np.float64))
    for i in range(ncomp):
        voff = params[i]
        tex = params[ncomp + i]
        ltau = params[2 * ncomp + i]
        sigm = params[3 * ncomp + i]
        pred += hf_tb(xarr, trans, voff, tex, 10.0 ** ltau, sigm)
    return pred


def gauss_predict(xarr, params, rest_freq):
    """Multi-component Gaussian spectrum (reference gaussian.pyx:17-50)."""
    params = np.asarray(params, dtype=np.float64)
    ncomp = params.shape[0] // 3
    xarr = np.asarray(xarr, dtype=np.float64)
    pred = np.zeros_like(xarr)
    for i in range(ncomp):
        voff = params[i]
        sigm = params[ncomp + i]
        peak = params[2 * ncomp + i]
        nu_width = sigm / CKMS * rest_freq
        nu_cen = rest_freq * (1 - voff / CKMS)
        d = xarr - nu_cen
        pred += peak * np.exp(-0.5 * d * d / (nu_width * nu_width))
    return pred
