"""Spectral axis conversions (radio velocity convention).

The reference delegates axis handling to pyspeckit/spectral_cube
(reference: synth_spectra.py:243-249, main.py:129-166); these two
conversions are all the framework needs.
"""

import numpy as np

from nestfit_tpu_torch.constants import CKMS


def freq_axis_from_velocity(varr_kms, rest_freq_hz):
    """Frequency axis [Hz], ascending, from a velocity axis [km/s].

    Radio convention: ``nu = nu_rest * (1 - v / c)``.  An ascending
    velocity axis maps to a descending frequency axis, so the result is
    reversed to ascending order (the reference forces ascending
    frequency everywhere, main.py:146-149).
    """
    varr = np.asarray(varr_kms, dtype=np.float64)
    nu = rest_freq_hz * (1.0 - varr / CKMS)
    if nu[1] < nu[0]:
        nu = nu[::-1]
    return np.ascontiguousarray(nu)


def velocity_axis_from_freq(xarr_hz, rest_freq_hz):
    """Velocity axis [km/s] (radio convention) from a frequency axis.

    For an ascending frequency axis the velocity axis is descending,
    matching the reference's pairing (main.py:155-166).
    """
    nu = np.asarray(xarr_hz, dtype=np.float64)
    return CKMS * (1.0 - nu / rest_freq_hz)
