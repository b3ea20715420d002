"""Synthetic NH3 cubes (port of ``ParamSampler`` and
``make_synth_cube_arrays`` from ``nestfit_tpu/synth.py``; NumPy only).

Truth spectra come from the float64 oracle (``oracle.py``), an
independent code path from the model under test.  With the same ``rng``
state the arrays equal the JAX package's bit for bit.
"""

import numpy as np

from nestfit_tpu_torch import oracle
from nestfit_tpu_torch.models.tables import AMMONIA_TRANSITIONS
from nestfit_tpu_torch.utils import freq_axis_from_velocity


class ParamSampler:
    """Random 2-component truth parameter draws."""

    def __init__(self, vsep=(0.16, 3), trot=(3, 30), tex=(2.8, 12),
                 ntot=(13, 16), sigm=(0.15, 2), orth=(0, 0), rng=None):
        self.vsep = vsep
        self.trot = trot
        self.tex = tex
        self.ntot = ntot
        self.sigm = sigm
        self.orth = orth
        self.rng = rng if rng is not None else np.random.default_rng()

    def draw(self):
        rng = self.rng
        vsep = rng.uniform(*self.vsep)
        return np.concatenate([
            np.array([0, vsep]),
            rng.uniform(*self.trot, size=2),
            rng.uniform(*self.tex, size=2),
            rng.uniform(*self.ntot, size=2),
            rng.uniform(*self.sigm, size=2),
            rng.uniform(*self.orth, size=2) if self.orth != (0, 0)
            else np.zeros(2),
        ])


def make_synth_cube_arrays(n_pix=1024, noise=0.1, rng=None,
                           sampler_kwargs=None):
    """Synthetic 2-transition cube as dense arrays, one row of truth
    parameters per pixel.

    Returns ``(xarr11, data11), (xarr22, data22), params[n_pix, 12]``.
    """
    rng = rng if rng is not None else np.random.default_rng(5)
    sampler = ParamSampler(rng=rng, **(sampler_kwargs or {}))
    vaxis = np.arange(-30, 30, 0.158)
    xa11 = freq_axis_from_velocity(vaxis, AMMONIA_TRANSITIONS[0].nu)
    xa22 = freq_axis_from_velocity(vaxis, AMMONIA_TRANSITIONS[1].nu)
    d11 = np.empty((n_pix, xa11.shape[0]))
    d22 = np.empty((n_pix, xa22.shape[0]))
    pcube = np.empty((n_pix, 12))
    for i in range(n_pix):
        params = sampler.draw()
        pcube[i] = params
        d11[i] = oracle.amm_predict(xa11, params, trans_id=1)
        d22[i] = oracle.amm_predict(xa22, params, trans_id=2)
    d11 += rng.normal(scale=noise, size=d11.shape)
    d22 += rng.normal(scale=noise, size=d22.shape)
    return (xa11, d11), (xa22, d22), pcube
