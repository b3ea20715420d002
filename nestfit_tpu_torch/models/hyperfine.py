"""Hyperfine radiative transfer (port of ``nestfit_tpu/models/hyperfine.py``).

Plain PyTorch: the summed Gaussian opacity of a transition's hyperfine
lines, then brightness temperature.  This is the semantics the fused
kernel (``ops/fused.py``) is held against.  Line centres are taken
relative to the rest frequency so that float32 keeps Hz resolution.
"""

import torch

from nestfit_tpu_torch.constants import CKMS
from nestfit_tpu_torch.models.tables import Transition

_ARG_MAX = 87.0   # exp(-87) ~ 1.6e-38, the edge of float32's normal range


def tau_profile(trans: Transition, dnu, voff, tau_main, sigm,
                window_sigma=None):
    """Summed hyperfine opacity profile ``[..., S]`` of one component.

    ``voff``/``tau_main``/``sigm`` are ``[...]`` tensors; ``dnu`` is the
    ``[S]`` channel offset axis from ``trans.nu``.  Per line ``j``::

        rel_nucen = -nu*voff_j/c - voff*hf_freq_j/c
        hf_width  = sigm*hf_freq_j/c
        tau      += tau_main*w_j*exp(-(dnu - rel_nucen)^2/(2 hf_width^2))

    ``window_sigma`` zeroes each profile beyond that many widths, the
    parity mode of the JAX package (reference index-windowed loop).
    """
    dtype, dev = dnu.dtype, dnu.device
    hf_freq = (1.0 - trans.voff / CKMS) * trans.nu          # (nhf,) f64
    rel_base = torch.as_tensor(trans.nu * trans.voff / CKMS, dtype=dtype,
                               device=dev)
    hf_freq_j = torch.as_tensor(hf_freq, dtype=dtype, device=dev)
    wts = torch.as_tensor(trans.tau_wts, dtype=dtype, device=dev)
    voff = torch.as_tensor(voff, dtype=dtype, device=dev)
    sigm = torch.as_tensor(sigm, dtype=dtype, device=dev)
    tau_main = torch.as_tensor(tau_main, dtype=dtype, device=dev)

    batch = torch.broadcast_shapes(voff.shape, sigm.shape, tau_main.shape)
    tau = torch.zeros(batch + dnu.shape, dtype=dtype, device=dev)
    for j in range(trans.nhf):
        f_j = hf_freq_j[j] / CKMS
        rel_nucen = -rel_base[j] - voff * f_j
        hf_width = sigm * f_j
        idenom = 0.5 / (hf_width * hf_width)
        d = dnu - rel_nucen[..., None]
        arg = (d * d) * idenom[..., None]
        # far wings underflow to zero directly: below float32's normal
        # range the CPU exp takes a subnormal path ~100x slower
        prof = torch.where(arg < _ARG_MAX,
                           torch.exp(-torch.clamp(arg, max=_ARG_MAX)), 0.0)
        if window_sigma is not None:
            prof = torch.where(arg <= 0.5 * window_sigma**2, prof, 0.0)
        tau = tau + (tau_main * wts[j])[..., None] * prof
    return tau


def brightness(tau, tex, t0, tbg):
    """``T0 * (1/expm1(T0/Tex) - tbg) * (1 - exp(-tau))``."""
    iemtex = 1.0 / torch.expm1(t0 / tex[..., None])
    return t0 * (iemtex - tbg) * (-torch.expm1(-tau))


def hf_predict(trans: Transition, spec_dnu, spec_t0, spec_tbg,
               voff, tex, tau_main, sigm, window_sigma=None):
    """Brightness ``[..., S]`` of one velocity component (linear
    ``tau_main``)."""
    tau = tau_profile(trans, spec_dnu, voff, tau_main, sigm,
                      window_sigma=window_sigma)
    tex = torch.as_tensor(tex, dtype=spec_dnu.dtype, device=spec_dnu.device)
    return brightness(tau, tex, spec_t0, spec_tbg)


def iemtex(x):
    """``1/(exp(x) - 1)``, the exact form of the excitation term
    (``brightness`` computes it inline)."""
    return 1.0 / torch.expm1(x)
