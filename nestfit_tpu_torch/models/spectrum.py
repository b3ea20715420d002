"""Spectrum data containers (port of ``nestfit_tpu/models/spectrum.py``).

As in the JAX package the container holds only data, and frequencies
are stored relative to ``rest_freq`` (``dnu = xarr - rest_freq``, the
subtraction done in float64 on the host) so that float32 keeps ~1 Hz
resolution.  ``data``/``noise`` may carry a leading pixel axis; the
channel axis is last.
"""

import dataclasses
import math

import numpy as np
import torch

from nestfit_tpu_torch.constants import H, KB, TCMB
from nestfit_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Spectrum:
    """One transition's observed spectrum plus precomputed channel terms.

    ``dnu``/``t0``/``tbg`` are ``[S]`` channel-axis tensors, ``data`` is
    ``[..., S]`` and ``noise`` is ``[...]`` (0-d when shared by every
    pixel); all on one device.  See the JAX package for the physics.
    """

    dnu: torch.Tensor
    data: torch.Tensor
    noise: torch.Tensor
    t0: torch.Tensor
    tbg: torch.Tensor
    rest_freq: float
    trans_id: int
    nu_chan: float
    size: int

    def to(self, device) -> "Spectrum":
        return dataclasses.replace(
            self, dnu=self.dnu.to(device), data=self.data.to(device),
            noise=self.noise.to(device), t0=self.t0.to(device),
            tbg=self.tbg.to(device),
        )

    @property
    def xarr(self) -> np.ndarray:
        """Absolute frequency axis in Hz (float64, host-side)."""
        return self.dnu.double().cpu().numpy() + self.rest_freq

    @property
    def null_lnZ(self) -> torch.Tensor:
        """Log-likelihood of the all-zero model."""
        dev = self.data
        return -torch.sum(dev * dev, dim=-1) / (2.0 * self.noise**2)

    def loglikelihood(self, pred: torch.Tensor) -> torch.Tensor:
        """``-sum((data - pred)^2) / (2 noise^2)`` over the channel axis
        (normalisation prefactor excluded, as in the reference)."""
        dev = self.data - pred
        return -torch.sum(dev * dev, dim=-1) / (2.0 * self.noise**2)

    @property
    def prefactor(self) -> torch.Tensor:
        """Gaussian normalisation term."""
        return -self.size / 2.0 * torch.log(2.0 * math.pi * self.noise**2)


def make_spectrum(xarr, data, noise, rest_freq=None, trans_id=-1,
                  tcmb: float = TCMB, dtype=torch.float32,
                  device="cuda") -> Spectrum:
    """Build a :class:`Spectrum` from host arrays.

    ``xarr`` is the ascending, uniform absolute frequency axis in Hz,
    ``data`` the brightness temperatures in K, ``noise`` the RMS noise
    in K (scalar or per pixel).  The channel terms ``t0 = H nu / KB``
    and ``tbg = 1/expm1(t0/TCMB)`` are computed in float64 on the host.
    """
    dev = resolve_device(device)
    xarr = np.asarray(xarr, dtype=np.float64)
    if xarr.ndim != 1:
        raise ValueError("xarr must be one-dimensional")
    nu_chan = float(xarr[1] - xarr[0])
    if not nu_chan > 0:
        raise ValueError("frequency axis must be ascending")
    if rest_freq is None:
        rest_freq = float(xarr[xarr.shape[0] // 2])
    if data.shape[-1] != xarr.shape[0]:
        raise ValueError(f"data has {data.shape[-1]} channels, xarr "
                         f"{xarr.shape[0]}")
    if isinstance(noise, (int, float, np.ndarray)) \
            and not np.all(np.asarray(noise) > 0):
        raise ValueError("noise must be positive")
    t0 = H * xarr / KB
    tbg = 1.0 / np.expm1(t0 / tcmb)

    def tensor(x):
        if isinstance(x, torch.Tensor):
            return x.to(device=dev, dtype=dtype)
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

    return Spectrum(
        dnu=tensor(xarr - rest_freq),
        data=tensor(data),
        noise=tensor(noise),
        t0=tensor(t0),
        tbg=tensor(tbg),
        rest_freq=float(rest_freq),
        trans_id=int(trans_id),
        nu_chan=nu_chan,
        size=int(xarr.shape[0]),
    )
