"""NH3 inversion-transition model for the reference.

Copied from ``nestfit_tpu_torch/oracle.py`` (``amm_partition_level``,
``amm_partition_func``, ``amm_tau_main``, ``amm_predict``; the original
NestFit ``ammonia.pyx:326-361``), vectorised over points.  Six
parameters per component, parameter-major: voff [km/s], trot [K],
tex [K], ntot [log10 cm^-2], sigm [km/s], orth.
"""

import math

import torch

from reference.hyperfine import C, CKMS, brightness, tau_profile, unpack

N_PARAMS = 6
_BROT, _CROT = C["BROT"], C["CROT"]


def _level_k(j):
    """E_j / k [K] of rotational level ``j``."""
    return C["H"] * (_BROT * j * (j + 1) + (_CROT - _BROT) * j * j) / C["KB"]


def tau_main(trans, trot, tex, ntot, sigm, orth):
    n = trans["n"]
    zlev = (2 * n + 1) * torch.exp(-_level_k(n) / trot)
    qtot = torch.zeros_like(trot)
    for j in range(51):
        if trans["para"] and j % 3 != 0:
            qtot = qtot + (2 * j + 1) * torch.exp(-_level_k(j) / trot)
        elif not trans["para"] and j % 3 == 0:
            qtot = qtot + 2 * (2 * j + 1) * torch.exp(-_level_k(j) / trot)
    frac = (1.0 - orth) if trans["para"] else orth
    pop = 10.0 ** ntot * frac * zlev / qtot
    nu = trans["nu"]
    e = torch.exp(-(C["H"] * nu / C["KB"]) / tex)
    expterm = (1.0 - e) / (1.0 + e)
    fracterm = C["CCMS"] ** 2 * trans["ea"] / (8 * math.pi * nu ** 2)
    widthterm = CKMS / (sigm * nu * math.sqrt(2 * math.pi))
    return pop * fracterm * expterm * widthterm


def predict(axis, theta):
    """Model spectrum ``[..., S]`` of ``theta[..., 6 C]``."""
    voff, trot, tex, ntot, sigm, orth = unpack(theta, N_PARAMS)
    tau0 = tau_main(axis.trans, trot, tex, ntot, sigm, orth)
    tau = tau_profile(axis, voff, tau0, sigm)
    return torch.sum(brightness(axis, tex, tau), dim=-2)
