"""Synthetic NH3 spectra and cubes (port of ``nestfit_tpu/synth.py``;
NumPy only, but for ``SyntheticSpectrum.to_ammspec``).

Truth spectra come from the float64 oracle (``oracle.py``), an
independent code path from the model under test.  With the same ``rng``
state every array, header and FITS file equals the JAX package's bit for
bit.
"""

from pathlib import Path

import numpy as np

from nestfit_tpu_torch import oracle
from nestfit_tpu_torch.cube.fits_io import write_fits
from nestfit_tpu_torch.models.tables import AMMONIA_TRANSITIONS
from nestfit_tpu_torch.utils import freq_axis_from_velocity, \
    velocity_axis_from_freq

VCHAN = 0.158            # km/s, the synthetic cubes' channel width


class SyntheticSpectrum:
    """A noisy synthetic ammonia spectrum with known truth parameters.

    Parameters are parameter-major packed [voff*n, trot*n, tex*n,
    ntot*n, sigm*n, orth*n]; ``vsys`` shifts the centroids.
    """

    model_name = "ammonia"

    def __init__(self, xarr, params, noise=0.03, vsys=0, trans_id=1,
                 set_seed=False, cold=False, lte=False, rng=None):
        if rng is None:
            rng = np.random.default_rng(5 if set_seed else None)
        self.rng = rng
        xarr = np.asarray(xarr, dtype=np.float64)
        if xarr[1] < xarr[0]:
            xarr = xarr[::-1].copy()
        self.xarr = xarr
        self.params = np.asarray(params, dtype=np.float64)
        self.noise = noise
        self.vsys = vsys
        self.trans_id = trans_id
        self.cold = cold
        self.lte = lte
        self.size = xarr.shape[0]
        self.ncomp = self.params.shape[0] // 6
        self.components = self.calc_profiles()
        self.sum_spec = self.components.sum(axis=0)
        self.noise_spec = self.calc_noise()
        self.sampled_spec = self.sum_spec + self.noise_spec

    @property
    def varr(self):
        """Velocity axis (km/s) for plotting."""
        rest = AMMONIA_TRANSITIONS[self.trans_id - 1].nu
        return velocity_axis_from_freq(self.xarr, rest)

    def calc_profiles(self):
        n = self.ncomp
        comps = []
        for i in range(n):
            p1 = np.array([
                self.params[i] + self.vsys,
                self.params[n + i],
                self.params[2 * n + i],
                self.params[3 * n + i],
                self.params[4 * n + i],
                self.params[5 * n + i],
            ])
            comps.append(oracle.amm_predict(
                self.xarr, p1, trans_id=self.trans_id, cold=self.cold,
                lte=self.lte))
        return np.array(comps)

    def calc_noise(self):
        return self.rng.normal(scale=self.noise, size=self.size)

    def resample_spectrum(self, noise=None):
        if noise is not None:
            self.noise = noise
        self.noise_spec = self.calc_noise()
        self.sampled_spec = self.sum_spec + self.noise_spec

    def to_ammspec(self, dtype=None, device="cuda"):
        """The port's ``Spectrum`` of this spectrum on ``device``."""
        from nestfit_tpu_torch.models import ammonia

        kw = {} if dtype is None else {"dtype": dtype}
        return ammonia.make_ammonia_spectrum(
            self.xarr, self.sampled_spec, self.noise, trans_id=self.trans_id,
            device=device, **kw)

    @property
    def mod_spec(self):
        return oracle.amm_predict(self.xarr, self.params,
                                  trans_id=self.trans_id, cold=self.cold,
                                  lte=self.lte)


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


def _nh3_axes():
    vaxis = np.arange(-30, 30, VCHAN)
    return tuple(freq_axis_from_velocity(vaxis, t.nu)
                 for t in AMMONIA_TRANSITIONS[:2])


def get_test_spectra(kind=0):
    """Canonical seeded 2-component (1,1)+(2,2) synthetic pair."""
    if kind == 0:
        params = np.array([
            -1.0, 1.5,   # voff
            10.0, 15.0,  # trot
            4.0, 6.0,    # tex
            14.5, 15.0,  # ntot
            0.3, 0.6,    # sigm
            0.0, 0.0,    # orth
        ])
    elif kind == 1:
        params = np.array([
            -1.0, 1.0,
            12.0, 12.0,
            6.0, 6.0,
            14.5, 14.6,
            0.3, 0.3,
            0.0, 0.0,
        ])
    else:
        raise ValueError(f'Invalid kind "{kind}"')
    return [
        SyntheticSpectrum(xarr, params, noise=0.2, trans_id=i + 1,
                          set_seed=True)
        for i, xarr in enumerate(_nh3_axes())
    ]


def make_synth_cube_arrays(n_pix=1024, noise=0.1, rng=None, kind=0,
                           sampler_kwargs=None):
    """Synthetic 2-transition cube as dense arrays, one row of truth
    parameters per pixel.  ``kind`` is accepted for the JAX package's
    signature and unused there too.

    Returns ``(xarr11, data11), (xarr22, data22), params[n_pix, 12]``.
    """
    rng = rng if rng is not None else np.random.default_rng(5)
    sampler = ParamSampler(rng=rng, **(sampler_kwargs or {}))
    xa11, xa22 = _nh3_axes()
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


def make_fake_header(n_lon, n_lat, xarr, rms=None, rest_freq=None):
    """Minimal 3-axis FITS header for a synthetic cube."""
    xarr = np.asarray(xarr)
    header = {
        "SIMPLE": True,
        "BITPIX": -32,
        "NAXIS": 3,
        "NAXIS1": int(n_lon),
        "NAXIS2": int(n_lat),
        "NAXIS3": int(xarr.size),
        "CTYPE1": "RA---TAN", "CRPIX1": 1.0, "CRVAL1": 0.0,
        "CDELT1": -2.8e-4, "CUNIT1": "deg",
        "CTYPE2": "DEC--TAN", "CRPIX2": 1.0, "CRVAL2": 0.0,
        "CDELT2": 2.8e-4, "CUNIT2": "deg",
        "CTYPE3": "FREQ", "CRPIX3": 1.0, "CRVAL3": float(xarr[0]),
        "CDELT3": float(xarr[1] - xarr[0]), "CUNIT3": "Hz",
        "BUNIT": "K",
        "RADESYS": "ICRS",
        "EQUINOX": 2000.0,
    }
    if rest_freq is not None:
        header["RESTFRQ"] = float(rest_freq)
    if rms is not None:
        header["RMS"] = float(rms)
    return header


def make_indep_synth_cube(outdir="run/synth", im_shape=(8, 4096),
                          noise_levels=None, rng=None,
                          sampler_kwargs=None):
    """Write synthetic NH3 (1,1)/(2,2) FITS cube pairs at a ladder of
    noise levels (default ``linspace(0, 0.5, 11)``), plus the
    truth-parameter and peak-intensity cubes.

    Every pixel carries an independent 2-component truth draw from
    :class:`ParamSampler`.  Returns a dict with the written paths:
    ``{"params": ..., "peak": ..., "cubes": {rms: (path11, path22)}}``.
    """
    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    if noise_levels is None:
        noise_levels = np.linspace(0.0, 0.5, 11)
    rng = rng if rng is not None else np.random.default_rng(5)
    n_lat, n_lon = im_shape
    n_pix = n_lat * n_lon
    (xa11, d11), (xa22, d22), pcube = make_synth_cube_arrays(
        n_pix=n_pix, noise=0.0, rng=rng, sampler_kwargs=sampler_kwargs,
    )
    pkcube = np.stack([d11.max(axis=1), d22.max(axis=1)], axis=1)

    # FITS layout: spectral axis first, (S, b, l)
    cube11 = d11.reshape(n_lat, n_lon, -1).transpose(2, 0, 1)
    cube22 = d22.reshape(n_lat, n_lon, -1).transpose(2, 0, 1)
    paths = {"cubes": {}}
    pdata = pcube.reshape(n_lat, n_lon, -1).transpose(2, 0, 1)
    paths["params"] = str(outdir / "syn_params.fits")
    write_fits(paths["params"], pdata.astype(np.float32),
               make_fake_header(n_lon, n_lat, np.arange(pdata.shape[0])))
    pkdata = pkcube.reshape(n_lat, n_lon, -1).transpose(2, 0, 1)
    paths["peak"] = str(outdir / "syn_peak.fits")
    write_fits(paths["peak"], pkdata.astype(np.float32),
               make_fake_header(n_lon, n_lat, np.arange(2)))
    for std in np.asarray(noise_levels):
        pair = []
        for tag, cube, xarr, trans in (
            ("11", cube11, xa11, AMMONIA_TRANSITIONS[0]),
            ("22", cube22, xa22, AMMONIA_TRANSITIONS[1]),
        ):
            noisy = cube + rng.normal(scale=std, size=cube.shape) \
                if std > 0 else cube
            header = make_fake_header(
                n_lon, n_lat, xarr, rms=float(std), rest_freq=trans.nu
            )
            path = str(outdir / f"syn_{tag}_rms{std:.3f}.fits")
            write_fits(path, noisy.astype(np.float32), header)
            pair.append(path)
        paths["cubes"][float(std)] = tuple(pair)
    return paths
