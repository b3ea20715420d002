"""N2H+ hyperfine model for the reference.

Copied from ``nestfit_tpu_torch/oracle.py::nnhp_predict`` (the original
NestFit ``diazenylium.pyx:140-155``), vectorised over points.  Four
parameters per component, parameter-major: voff [km/s], tex [K], ltau
(log10 main-line opacity), sigm [km/s].
"""

import torch

from reference.hyperfine import brightness, tau_profile, unpack

N_PARAMS = 4


def predict(axis, theta):
    """Model spectrum ``[..., S]`` of ``theta[..., 4 C]``."""
    voff, tex, ltau, sigm = unpack(theta, N_PARAMS)
    tau = tau_profile(axis, voff, 10.0 ** ltau, sigm)
    return torch.sum(brightness(axis, tex, tau), dim=-2)
