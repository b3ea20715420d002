"""Cube data containers: noise maps, data cubes, cube stacks (port of
``nestfit_tpu/cube/cube.py``; NumPy only).

Data are transposed to ``(l, b, S)`` so the channel axis is minor, the
frequency axis is forced ascending, and the noise is per pixel; the
batched accessors return the whole field as dense arrays for the
vectorized fitter.
"""

import logging

import numpy as np

from nestfit_tpu_torch.constants import CKMS
from nestfit_tpu_torch.cube.fits_io import read_fits

log = logging.getLogger("nestfit_tpu_torch.cube")

_KBOL = 1.380649e-23      # J/K (SI, exact)
_JY = 1.0e-26             # W m^-2 Hz^-1 per jansky


def beam_solid_angle(header):
    """Gaussian beam solid angle [sr] from header BMAJ/BMIN (degrees),
    ``pi * theta_maj * theta_min / (4 ln 2)``; None when absent."""
    bmaj = header.get("BMAJ")
    if bmaj is None:
        return None
    bmin = header.get("BMIN", bmaj)
    return (np.pi * np.deg2rad(float(bmaj)) * np.deg2rad(float(bmin))
            / (4.0 * np.log(2.0)))


def pixel_solid_angle(header):
    """Sky-pixel solid angle [sr] from CDELT1/CDELT2 (degrees)."""
    cd1 = header.get("CDELT1")
    cd2 = header.get("CDELT2", cd1)
    if cd1 is None:
        return None
    return abs(np.deg2rad(float(cd1)) * np.deg2rad(float(cd2)))


def brightness_scale(bunit, header, xarr):
    """Per-channel factor converting ``bunit`` intensities to Kelvin.

    The role of ``spectral_cube.to('K')`` in the reference
    (main.py:134-141): Rayleigh-Jeans brightness temperature
    ``T = S * 1e-26 * c^2 / (2 k_B nu^2 Omega)`` with the beam solid
    angle from the header for Jy/beam data (per-channel frequency, so
    the factor is an [S] array), or the pixel solid angle for
    Jy/pixel.  Returns scalar 1.0 for Kelvin data; raises on units it
    cannot convert (silently mis-scaled spectra would corrupt every
    evidence downstream).
    """
    u = str(bunit or "").strip().lower()
    # strip common annotations: "K (Ta*)", "Kelvin"
    base = u.split("(")[0].strip()
    if base in ("", "k", "kelvin", "k (ta*)", "ta*", "tmb"):
        if base == "":
            log.info("no BUNIT: assuming cube intensity units of K")
        return 1.0
    scale = 1.0
    if base.startswith("m") and "jy" in base:
        scale, base = 1e-3, base[1:]
    if base in ("jy/beam", "jy / beam", "jy beam-1", "jy beam^-1"):
        omega = beam_solid_angle(header)
        if omega is None:
            raise ValueError(
                "BUNIT=Jy/beam requires BMAJ/BMIN beam keywords for "
                "the K conversion"
            )
    elif base in ("jy/pixel", "jy/pix"):
        omega = pixel_solid_angle(header)
        if omega is None:
            raise ValueError(
                "BUNIT=Jy/pixel requires CDELT1/CDELT2 for the K "
                "conversion"
            )
    elif base in ("jy/sr",):
        omega = 1.0
    else:
        raise ValueError(
            f"cannot convert BUNIT={bunit!r} to K (supported: K, "
            "Jy/beam, mJy/beam, Jy/pixel, Jy/sr)"
        )
    c_ms = CKMS * 1e3
    nu = np.asarray(xarr, dtype=np.float64)
    return scale * _JY * c_ms**2 / (2.0 * _KBOL * nu**2 * omega)


def spectral_axis_hz(header, n_s=None):
    """Frequency axis [Hz, FITS channel order] from a FITS header.

    Covers the spectral conventions the reference gets from
    spectral_cube's ``with_spectral_unit('Hz')`` (main.py:142-146):

    * ``FREQ`` with CUNIT3 Hz/kHz/MHz/GHz;
    * ``VRAD`` -- radio velocity, ``nu = nu0 (1 - v/c)``;
    * ``VOPT``/``FELO`` -- optical velocity, ``nu = nu0 / (1 + v/c)``;
    * ``VELO`` -- AIPS convention: radio when ``VELREF >= 257``,
      optical for ``VELREF`` 1..3, relativistic apparent radial
      velocity ``nu = nu0 sqrt((1-b)/(1+b))`` otherwise (Greisen 2006,
      FITS WCS Paper III sec. 2.2).

    Velocity axes require a rest frequency (RESTFRQ/RESTFREQ).
    """
    if n_s is None:
        n_s = header["NAXIS3"]
    ctype3 = str(header.get("CTYPE3", "FREQ")).upper()
    crval = header["CRVAL3"]
    cdelt = header["CDELT3"]
    crpix = header.get("CRPIX3", 1)
    axis = crval + (np.arange(n_s) + 1 - crpix) * cdelt
    kind = ctype3.split("-")[0]
    rest = header.get("RESTFRQ", header.get("RESTFREQ"))
    if kind == "FREQ":
        unit = str(header.get("CUNIT3", "Hz")).strip().lower()
        mult = {"hz": 1.0, "khz": 1e3, "mhz": 1e6, "ghz": 1e9}.get(unit)
        if mult is None:
            raise ValueError(f"unsupported frequency CUNIT3={unit!r}")
        return axis * mult, rest
    # velocity axis in km/s
    unit = str(header.get("CUNIT3", "m/s")).strip().lower()
    if unit in ("m/s", "m s-1", "ms-1", ""):
        vel = axis / 1000.0
    elif unit in ("km/s", "km s-1", "kms-1"):
        vel = axis
    else:
        raise ValueError(f"unsupported velocity CUNIT3={unit!r}")
    if not rest:
        raise ValueError("velocity spectral axis requires RESTFRQ")
    if kind == "VRAD":
        conv = "radio"
    elif kind in ("VOPT", "FELO"):
        conv = "optical"
    elif kind == "VELO":
        velref = header.get("VELREF")
        if velref is not None and int(velref) >= 257:
            conv = "radio"
        elif velref is not None and 1 <= int(velref) <= 3:
            conv = "optical"
        else:
            conv = "relativistic"
    else:
        raise ValueError(f"unsupported spectral CTYPE3={ctype3!r}")
    beta = vel / CKMS
    if conv == "radio":
        xarr = rest * (1.0 - beta)
    elif conv == "optical":
        xarr = rest / (1.0 + beta)
    else:
        xarr = rest * np.sqrt((1.0 - beta) / (1.0 + beta))
    return xarr, rest


class NoiseMap:
    """Per-pixel RMS noise map (role of reference main.py:39-65).

    Stored internally as ``(l, b)`` to match the cube's transposed
    spatial layout; the constructor accepts the FITS-native ``(b, l)``
    orientation.
    """

    def __init__(self, data):
        self.data = np.ascontiguousarray(np.swapaxes(np.asarray(data), 0, 1))
        self.shape = self.data.shape

    @classmethod
    def from_pbimg(cls, rms, pb_img):
        """Scale a scalar RMS by the inverse primary-beam response;
        unobserved (non-finite) pixels get infinite noise."""
        pb_img = np.asarray(pb_img)
        # FITS images often carry degenerate leading (stokes, spectral)
        # axes; keep only the trailing two sky axes
        if pb_img.ndim > 2:
            lead = pb_img.shape[:-2]
            if any(n != 1 for n in lead):
                raise ValueError(
                    f"primary-beam image has non-degenerate leading "
                    f"axes: {pb_img.shape}"
                )
            pb_img = pb_img.reshape(pb_img.shape[-2:])
        elif pb_img.ndim < 2:
            raise ValueError(f"Cannot parse shape : {pb_img.shape}")
        with np.errstate(divide="ignore", invalid="ignore"):
            img = np.where(np.isfinite(pb_img), rms / pb_img, np.inf)
        img[~np.isfinite(img)] = np.inf
        return cls(img)

    def get_noise(self, i_lon, i_lat):
        return self.data[i_lon, i_lat]


class NoiseMapUniform:
    """Spatially uniform RMS (role of reference main.py:68-74)."""

    def __init__(self, rms):
        self.rms = float(rms)
        self.shape = None

    def get_noise(self, i_lon, i_lat):
        return self.rms


class DataCube:
    """One transition's spectral cube (reference: main.py:77-172).

    Construct from dense arrays (``data`` in K with shape (l, b, S) or
    (S, b, l), ``xarr`` ascending Hz) or via :meth:`from_fits`.
    """

    def __init__(self, data, xarr, noise_map, trans_id=None, header=None,
                 rest_freq=None):
        if isinstance(noise_map, (float, int)):
            self.noise_map = NoiseMapUniform(noise_map)
        else:
            self.noise_map = noise_map
        self.trans_id = trans_id
        data = np.asarray(data)
        xarr = np.asarray(xarr, dtype=np.float64)
        if data.shape[0] == xarr.shape[0] and data.shape[-1] != xarr.shape[0]:
            # (S, b, l) -> (l, b, S), the reference's transpose
            # (main.py:150-153)
            data = data.transpose()
        assert data.shape[-1] == xarr.shape[0]
        if xarr[1] < xarr[0]:
            xarr = xarr[::-1].copy()
            data = data[..., ::-1].copy()
        self.data = data
        self.xarr = xarr
        self._header = dict(header) if header else {}
        self.rest_freq = (
            rest_freq if rest_freq is not None
            else self._header.get("RESTFRQ", float(xarr[xarr.shape[0] // 2]))
        )
        nu_chan = xarr[1] - xarr[0]
        self.dv = abs(nu_chan) / self.rest_freq * CKMS
        # velocity axis paired to ascending frequency is descending
        # (main.py:155-166)
        self.varr = CKMS * (1.0 - xarr / self.rest_freq)
        self.shape = self.data.shape
        self.spatial_shape = (self.shape[0], self.shape[1])
        self.nchan = self.shape[2]
        if self.noise_map.shape is not None:
            assert self.spatial_shape == self.noise_map.shape

    @classmethod
    def from_fits(cls, path, noise_map=None, trans_id=None,
                  mask_channels=None):
        """Read a FITS cube, converting units to K / Hz.

        Covers the reference's spectral_cube-based ingestion semantics
        (main.py:134-153) without spectral_cube: FREQ (any standard
        CUNIT3) and VRAD/VOPT/FELO/VELO velocity conventions on the
        spectral axis (:func:`spectral_axis_hz`), and BUNIT conversion
        of K / Jy/beam / mJy/beam / Jy/pixel / Jy/sr intensities to
        brightness temperature (:func:`brightness_scale`, using the
        header beam).  ``mask_channels`` (indices in FITS channel
        order, e.g. noisy band edges) are dropped from both the data
        and the axis.
        """
        data, header = read_fits(path)
        if data.ndim == 4:
            data = data[0]
        assert data.ndim == 3, data.shape
        n_s = header.get("NAXIS3", data.shape[0])
        xarr, rest = spectral_axis_hz(header, n_s)
        scale = brightness_scale(header.get("BUNIT"), header, xarr)
        if np.ndim(scale):
            # per-channel factor (Jy -> K depends on nu); data is in
            # FITS (S, b, l) order here
            data = data * np.asarray(scale).reshape(-1, 1, 1)
        elif scale != 1.0:
            data = data * scale
        if mask_channels is not None:
            keep = np.ones(n_s, dtype=bool)
            keep[np.asarray(mask_channels, dtype=np.int64)] = False
            xarr = xarr[keep]
            data = data[keep]
        if xarr[1] < xarr[0]:
            xarr = xarr[::-1].copy()
            data = data[::-1].copy()
        if noise_map is None:
            noise_map = header.get("RMS", 1.0)
        return cls(data, xarr, noise_map, trans_id=trans_id, header=header,
                   rest_freq=rest)

    @property
    def full_header(self):
        return self._header

    @property
    def simple_header(self):
        """2-D WCS subset of the header (reference: main.py:100-127)."""
        keys = (
            "SIMPLE", "BITPIX", "NAXIS", "NAXIS1", "NAXIS2", "WCSAXES",
            "CRPIX1", "CRPIX2", "CDELT1", "CDELT2", "CUNIT1", "CUNIT2",
            "CTYPE1", "CTYPE2", "CRVAL1", "CRVAL2", "RADESYS", "EQUINOX",
        )
        hdict = {k: self._header[k] for k in keys if k in self._header}
        hdict["NAXIS"] = 2
        hdict["WCSAXES"] = 2
        return hdict

    def get_spec_data(self, i_lon, i_lat):
        """(xarr, arr, noise, trans_id, has_nans) for one pixel
        (reference: main.py:168-172)."""
        arr = self.data[i_lon, i_lat, :]
        noise = self.noise_map.get_noise(i_lon, i_lat)
        has_nans = bool(np.isnan(arr).any() or np.isnan(noise))
        return self.xarr, arr, noise, self.trans_id, has_nans

    # --- batched accessors for the vectorized fitter
    def get_flat_data(self):
        """data [n_pix, S] flattened over (l, b) in C order."""
        return self.data.reshape(-1, self.nchan)

    def get_flat_noise(self):
        n_pix = self.spatial_shape[0] * self.spatial_shape[1]
        if self.noise_map.shape is None:
            return np.full(n_pix, self.noise_map.rms, dtype=np.float64)
        return self.noise_map.data.reshape(-1).astype(np.float64)


class CubeStack:
    """Ordered set of DataCubes, one per transition
    (reference: main.py:175-223)."""

    def __init__(self, cubes):
        self.cubes = list(cubes)
        self.n_cubes = len(self.cubes)
        shapes = {c.spatial_shape for c in self.cubes}
        assert len(shapes) == 1, "cubes must share the spatial grid"

    def __iter__(self):
        yield from self.cubes

    @property
    def full_header(self):
        return self.cubes[0].full_header

    @property
    def simple_header(self):
        return self.cubes[0].simple_header

    @property
    def shape(self):
        # reference reports the (S, b, l) cube shape (main.py:193-195)
        c = self.cubes[0]
        return (c.nchan, c.spatial_shape[1], c.spatial_shape[0])

    @property
    def spatial_shape(self):
        return self.cubes[0].spatial_shape

    def get_arrays(self, i_lon, i_lat):
        return [c.get_spec_data(i_lon, i_lat)[1] for c in self.cubes]

    def get_spec_data(self, i_lon, i_lat):
        all_spec_data = []
        any_nans = False
        for dcube in self.cubes:
            *spec_data, has_nans = dcube.get_spec_data(i_lon, i_lat)
            all_spec_data.append(spec_data)
            any_nans |= has_nans
        return all_spec_data, any_nans

    def get_max_snr(self, i_lon, i_lat):
        max_snr = 0.0
        for dcube in self.cubes:
            _, arr, noise, _, _ = dcube.get_spec_data(i_lon, i_lat)
            with np.errstate(invalid="ignore"):
                spec_snr = np.nanmax(arr) / noise
            if spec_snr > max_snr:
                max_snr = spec_snr
        return max_snr

    # --- batched accessors
    def get_flat_batch(self):
        """Dense per-pixel arrays for the whole field.

        Returns
        -------
        datas : list of [n_pix, S_t] per cube
        noises : list of [n_pix] per cube
        nan_mask : [n_pix] bool (any NaN in any cube/noise)
        max_snr : [n_pix]
        """
        datas = [c.get_flat_data() for c in self.cubes]
        noises = [c.get_flat_noise() for c in self.cubes]
        nan_mask = np.zeros(datas[0].shape[0], dtype=bool)
        max_snr = np.zeros(datas[0].shape[0])
        for d, n in zip(datas, noises):
            nan_mask |= np.isnan(d).any(axis=1) | np.isnan(n)
            with np.errstate(invalid="ignore", divide="ignore"):
                snr = np.nanmax(d, axis=1) / n
            max_snr = np.fmax(max_snr, snr)
        return datas, noises, nan_mask, max_snr
