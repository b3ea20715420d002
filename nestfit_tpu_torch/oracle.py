"""Independent float64 NumPy evaluation of the NH3, N2H+ and Gaussian
models (the physics part of ``nestfit_tpu/oracle.py``, copied): absolute
frequencies, scalar loops, no relative-axis trick.  The synthetic cube
generator and ``chip_smoke.py`` use it to make truth spectra.

``OracleDistribution`` and ``resolved_placement_interp`` (copied as
well) are not independent of the priors: they are a scalar float64
transliteration of the reference's prior interpolation and placement,
a line-level mirror to hold the vectorized transforms against.
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


# ---------------------------------------------------------------------------
# Prior-transform oracle: scalar float64 implementation of the reference
# Distribution/prior algorithms (reference core/core.pyx:23-161, 369-434)
# used to cross-check the vectorized JAX implementation.
# ---------------------------------------------------------------------------

class OracleDistribution:
    """Scalar mirror of the reference ``Distribution`` extension type,
    including the in-place ``cdf_over_interval`` mutation semantics."""

    def __init__(self, xax, pdf):
        from scipy import integrate, interpolate
        xax = np.asarray(xax, dtype=np.float64)
        pdf = np.asarray(pdf, dtype=np.float64)
        self.dx = xax[1] - xax[0]
        self.xax = xax
        self.pdf = pdf
        self.size = xax.shape[0]
        self.xmin = xax.min()
        self.xmax = xax.max()
        cdf = integrate.cumulative_trapezoid(pdf, xax, initial=0)
        cdf = cdf / cdf.max()
        self.cdf = cdf.copy()
        eps_cdf = cdf + np.arange(self.size) * 1e-16
        eps_cdf /= eps_cdf.max()
        inv_cdf = interpolate.UnivariateSpline(eps_cdf, xax, k=3, s=0)
        u = np.linspace(0, 1, self.size)
        self.du = u[1] - u[0]
        self.ppf = inv_cdf(u)

    def ppf_interp(self, u):
        i_lo = int((self.size - 1) * u)
        i_hi = i_lo + 1
        x_lo = i_lo * self.du
        y_lo = self.ppf[i_lo]
        y_hi = self.ppf[i_hi]
        slope = (y_hi - y_lo) / self.du
        return slope * (u - x_lo) + y_lo

    def cdf_interp(self, u):
        if u <= self.cdf[0]:
            u = 1e-64
        i_lo, i_hi = 0, self.size
        i = i_hi // 2
        while i != i_lo:
            if u > self.cdf[i]:
                i_lo = i
            else:
                i_hi = i
            i = (i_hi + i_lo) // 2
        i_lo = i if i < self.size else self.size - 1
        i_hi = i_lo + 1
        x_lo = self.xax[i_lo]
        y_lo = self.cdf[i_lo]
        y_hi = self.cdf[i_hi]
        slope = (y_hi - y_lo) / self.dx
        return 1 / slope * (u - y_lo) + x_lo

    def cdf_over_interval(self, x_lo, x_hi, sfact):
        if x_lo > x_hi:
            x_lo, x_hi = x_hi, x_lo
        i_lo = int((x_lo - self.xmin) / self.dx)
        i_lo = min(max(i_lo, 0), self.size - 1)
        i_hi = int((x_hi - self.xmin) / self.dx)
        if i_hi == i_lo:
            i_hi = i_lo + 1
        i_hi = min(max(i_hi, 1), self.size)
        csum = 0.0
        self.cdf[:i_lo] = 0.0
        self.cdf[i_hi:] = 1.0
        if i_hi - i_lo == 1:
            self.cdf[i_lo] = 1.0
        else:
            self.cdf[i_lo] = 0.0
            inv_delta_i = 1.0 / (i_hi - i_lo)
            for i in range(i_lo + 1, i_hi):
                scale = (1.0 - (i - i_lo) * inv_delta_i) ** sfact
                csum += 0.5 * (self.pdf[i] + self.pdf[i - 1]) * scale
                self.cdf[i] = csum
            self.cdf[i_lo:i_hi] /= csum


def resolved_placement_interp(vcen_dist, utheta_v, sigm, sep_scale):
    """Scalar mirror of ``ResolvedPlacementPrior.interp``
    (reference core.pyx:392-434) for pre-transformed sigma values.

    Returns the placed centroid values for one draw.
    """
    n = len(utheta_v)
    if n == 1:
        return np.array([vcen_dist.ppf_interp(utheta_v[0])])
    v_lo = vcen_dist.xmin
    v_hi = vcen_dist.xmax
    min_seps = np.zeros(n)
    sep_tot = 0.0
    for i in range(1, n):
        sep = sep_scale * np.sqrt(sigm[i] * sigm[i - 1])
        sep_tot += sep
        min_seps[i] = sep
    if sep_tot > v_hi - v_lo:
        overf = (v_hi - v_lo) / sep_tot
        min_seps *= overf
        sep_tot = min_seps.sum()
    v_hi -= sep_tot
    out = np.zeros(n)
    for i in range(n):
        sep = min_seps[i]
        v_lo += sep
        v_hi += sep
        vcen_dist.cdf_over_interval(v_lo, v_hi, float(n - 1 - i))
        v_lo = vcen_dist.cdf_interp(utheta_v[i])
        out[i] = v_lo
    return out
