"""Hyperfine radiative transfer for the reference, vectorised over points.

Copied from ``nestfit_tpu_torch/oracle.py::hf_tb`` (the physics of the
original NestFit ``hyperfine.pyx:52-118``, exact branch): a sum of
Gaussian opacities over a transition's hyperfine lines, then the
brightness temperature of the slab.  Frequencies are taken relative to
the rest frequency, so that a low-precision control keeps the channel
resolution; every constant is worked out in float64 on the host.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

LINES = json.loads((Path(__file__).with_name("lines.json")).read_text())
C = LINES["constants"]
CKMS = C["CKMS"]


@dataclasses.dataclass(frozen=True)
class Axis:
    """One transition's channel axis: ``dnu = xarr - rest`` [Hz], the
    channel terms ``t0 = h nu / k`` and ``tbg = 1 / expm1(t0 / Tcmb)``,
    and the transition's lines."""

    model: str
    trans_id: int
    rest: float
    dnu: torch.Tensor
    t0: torch.Tensor
    tbg: torch.Tensor
    trans: dict

    @property
    def size(self) -> int:
        return int(self.dnu.shape[0])

    @property
    def n_lines(self) -> int:
        return len(self.trans["voff"])


def freq_axis(velocity, rest):
    """Ascending frequency axis [Hz] of an ascending velocity axis
    [km/s] (radio convention; copied from
    ``nestfit_tpu_torch/utils/axes.py::freq_axis_from_velocity``)."""
    return (rest * (1.0 - np.asarray(velocity, dtype=np.float64)
                    / CKMS))[::-1].copy()


def transition(model: str, trans_id: int) -> dict:
    return LINES[model][str(trans_id)]


def make_axis(model, trans_id, xarr, dtype=torch.float64, device="cpu"):
    trans = transition(model, trans_id)
    xarr = np.asarray(xarr, dtype=np.float64)
    t0 = C["H"] * xarr / C["KB"]
    tbg = 1.0 / np.expm1(t0 / C["TCMB"])

    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    return Axis(model, int(trans_id), float(trans["nu"]),
                t(xarr - trans["nu"]), t(t0), t(tbg), trans)


def tau_profile(axis: Axis, voff, tau_main, sigm):
    """Summed opacity ``[..., C, S]`` of components ``voff``,
    ``tau_main``, ``sigm`` (each ``[..., C]``)."""
    rest = axis.rest
    tau = torch.zeros(voff.shape + (axis.size,), dtype=axis.dnu.dtype,
                      device=axis.dnu.device)
    for v_j, w_j in zip(axis.trans["voff"], axis.trans["tau_wts"]):
        f_j = 1.0 - v_j / CKMS                 # hf_freq / rest
        # hf_nucen - rest = rest (f_j (1 - voff / c) - 1)
        cen = (rest * (f_j - 1.0)) - (rest * f_j / CKMS) * voff
        width = (rest * f_j / CKMS) * sigm
        d = axis.dnu - cen[..., None]
        tau = tau + (w_j * tau_main)[..., None] * torch.exp(
            -0.5 * d * d / (width * width)[..., None])
    return tau


def brightness(axis: Axis, tex, tau):
    """``t0 (1 / expm1(t0 / tex) - tbg) (1 - exp(-tau))`` ``[..., C, S]``."""
    return axis.t0 * (1.0 / torch.expm1(axis.t0 / tex[..., None])
                      - axis.tbg) * (1.0 - torch.exp(-tau))


def unpack(theta, n_params: int):
    """Parameter-major ``[..., n_params * C]`` -> ``n_params`` tensors
    ``[..., C]``."""
    ncomp = theta.shape[-1] // n_params
    p = theta.reshape(theta.shape[:-1] + (n_params, ncomp))
    return [p[..., i, :] for i in range(n_params)]

