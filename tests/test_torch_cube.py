"""Port parity of the cube data layer: the FITS reader and writer, the
spectral-axis and brightness conversions, and ``DataCube.from_fits`` /
``CubeStack`` on the committed fixtures.  Both sides are NumPy, so every
comparison is exact."""

import os

import numpy as np
import pytest

from nestfit_tpu.cube import cube as jcube
from nestfit_tpu.cube import fits_io as jfits

from nestfit_tpu_torch.cube import cube as tcube
from nestfit_tpu_torch.cube import fits_io as tfits

from _cube_inputs import DATA_DIR, RMS, fixture_stack

FIXTURES = sorted(f for f in os.listdir(DATA_DIR) if f.endswith(".fits"))


def _outcome(fn, *args):
    """``("ok", result)`` or ``("raises", type, message)``."""
    try:
        return ("ok", fn(*args))
    except Exception as exc:                      # noqa: BLE001
        return ("raises", type(exc), str(exc))


def _assert_same(got, want):
    assert got[0] == want[0], (got, want)
    if got[0] == "raises":
        assert got[1:] == want[1:]
        return
    got, want = got[1], want[1]
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(("ok", g), ("ok", w))
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        assert np.asarray(got).dtype == np.asarray(want).dtype


@pytest.mark.parametrize("name", FIXTURES)
def test_read_fits_matches_jax(name):
    path = os.path.join(DATA_DIR, name)
    d_t, h_t = tfits.read_fits(path)
    d_j, h_j = jfits.read_fits(path)
    assert d_t.dtype == d_j.dtype and d_t.shape == d_j.shape
    np.testing.assert_array_equal(d_t, d_j)
    assert list(h_t.items()) == list(h_j.items())


_HEADER = {"OBJECT": "CLUMP 'A'", "BUNIT": "K", "CRVAL3": -1234.5,
           "CDELT3": 1.5e-7, "CRPIX3": 1, "RESTFRQ": 23694495500.0,
           "FLAG": True, "OFF": False, "BLANKVAL": None,
           "NANVAL": float("nan"), "NAXIS3": 99, "LONGKEYWORD": 3}


@pytest.mark.parametrize("case", ["f32_4d", "f64_2d", "int_3d", "no_header"])
def test_write_fits_matches_jax_bytes(case, tmp_path):
    rng = np.random.default_rng(0)
    data, header = {
        "f32_4d": (rng.normal(size=(1, 5, 3, 4)).astype(np.float32),
                   _HEADER),
        "f64_2d": (rng.normal(size=(7, 6)), _HEADER),
        "int_3d": (rng.integers(-9, 9, size=(2, 3, 4)), {"BUNIT": "Jy/beam"}),
        "no_header": (np.full((3, 3), np.nan, dtype=np.float32), None),
    }[case]
    tfits.write_fits(tmp_path / "t.fits", data, header)
    jfits.write_fits(tmp_path / "j.fits", data, header)
    assert (tmp_path / "t.fits").read_bytes() == \
        (tmp_path / "j.fits").read_bytes()
    d_back, _ = tfits.read_fits(tmp_path / "t.fits")
    np.testing.assert_array_equal(d_back, np.asarray(data, dtype=d_back.dtype))


_NU0 = 23694495500.0
_VEL = {"CRVAL3": -5000.0, "CDELT3": 158.0, "CRPIX3": 1.0,
        "RESTFRQ": _NU0, "CUNIT3": "m/s"}
SPECTRAL_HEADERS = {
    "freq_hz": {"CTYPE3": "FREQ", "CRVAL3": _NU0, "CDELT3": -1.2e4,
                "CRPIX3": 5.0, "CUNIT3": "Hz"},
    "freq_khz": {"CTYPE3": "FREQ", "CRVAL3": _NU0 / 1e3, "CDELT3": 12.0,
                 "CUNIT3": "kHz"},
    "freq_mhz": {"CTYPE3": "FREQ-LSR", "CRVAL3": _NU0 / 1e6, "CDELT3": 0.012,
                 "CUNIT3": "MHz"},
    "freq_ghz": {"CTYPE3": "FREQ", "CRVAL3": _NU0 / 1e9, "CDELT3": 1.2e-5,
                 "CUNIT3": "GHz"},
    "freq_default_unit": {"CRVAL3": _NU0, "CDELT3": 1.2e4},
    "vrad": {"CTYPE3": "VRAD", **_VEL},
    "vrad_kms": {"CTYPE3": "VRAD", **_VEL, "CRVAL3": -5.0, "CDELT3": 0.158,
                 "CUNIT3": "km/s"},
    "vopt": {"CTYPE3": "VOPT", **_VEL},
    "felo": {"CTYPE3": "FELO-HEL", **_VEL, "RESTFREQ": _NU0},
    "velo_257": {"CTYPE3": "VELO-LSR", **_VEL, "VELREF": 257},
    "velo_2": {"CTYPE3": "VELO-LSR", **_VEL, "VELREF": 2},
    "velo_none": {"CTYPE3": "VELO", **_VEL},
    "bad_freq_unit": {"CTYPE3": "FREQ", "CRVAL3": 1.0, "CDELT3": 1.0,
                      "CUNIT3": "THz"},
    "bad_vel_unit": {"CTYPE3": "VRAD", **_VEL, "CUNIT3": "pc/yr"},
    "no_rest": {"CTYPE3": "VRAD", "CRVAL3": 0.0, "CDELT3": 1.0},
    "bad_ctype": {"CTYPE3": "WAVE", **_VEL},
}


@pytest.mark.parametrize("case", sorted(SPECTRAL_HEADERS))
def test_spectral_axis_hz_matches_jax(case):
    header = dict(SPECTRAL_HEADERS[case], NAXIS3=17)
    _assert_same(_outcome(tcube.spectral_axis_hz, header),
                 _outcome(jcube.spectral_axis_hz, header))
    _assert_same(_outcome(tcube.spectral_axis_hz, header, 9),
                 _outcome(jcube.spectral_axis_hz, header, 9))


_BEAM = {"BMAJ": 3.1e-3, "BMIN": 2.2e-3, "CDELT1": -1e-3, "CDELT2": 1e-3}
BRIGHTNESS_CASES = {
    "K": ("K", _BEAM), "kelvin": ("Kelvin", {}), "none": (None, {}),
    "ta_star": ("K (Ta*)", {}), "jy_beam": ("Jy/beam", _BEAM),
    "jy_beam_round": ("JY/BEAM", {"BMAJ": 3e-3}),
    "mjy_beam": ("mJy/beam", _BEAM), "jy_pixel": ("Jy/pixel", _BEAM),
    "jy_pix_one_cdelt": ("jy/pix", {"CDELT1": 1e-3}),
    "jy_sr": ("Jy/sr", {}),
    "jy_beam_no_beam": ("Jy/beam", {}),
    "jy_pixel_no_cdelt": ("Jy/pixel", {}),
    "unknown": ("erg/s/cm2", _BEAM),
}


@pytest.mark.parametrize("case", sorted(BRIGHTNESS_CASES))
def test_brightness_scale_matches_jax(case):
    bunit, header = BRIGHTNESS_CASES[case]
    xarr = _NU0 + np.arange(-8, 8) * 1.2e4
    _assert_same(_outcome(tcube.brightness_scale, bunit, header, xarr),
                 _outcome(jcube.brightness_scale, bunit, header, xarr))


def _cube_fields(c):
    return dict(data=c.data, xarr=c.xarr, varr=c.varr, dv=c.dv,
                rest_freq=c.rest_freq, trans_id=c.trans_id, shape=c.shape,
                noise=c.get_flat_noise())


@pytest.mark.parametrize("from_fits", [
    {}, {"mask_channels": [0, 1, 2, 376, 377, 378]}])
def test_from_fits_stack_matches_jax(from_fits):
    got = fixture_stack(tcube, tfits, **from_fits)
    want = fixture_stack(jcube, jfits, **from_fits)
    for ct, cj in zip(got.cubes, want.cubes):
        ft, fj = _cube_fields(ct), _cube_fields(cj)
        for k in fj:
            np.testing.assert_array_equal(ft[k], fj[k], err_msg=k)
        assert ct.simple_header == cj.simple_header
        assert ct.full_header == cj.full_header
        np.testing.assert_array_equal(ct.noise_map.data, cj.noise_map.data)
    assert got.shape == want.shape
    assert got.spatial_shape == want.spatial_shape
    for a, b in zip(got.get_flat_batch(), want.get_flat_batch()):
        if isinstance(b, list):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)       # NaN-aware
        else:
            np.testing.assert_array_equal(a, b)
    assert got.get_max_snr(10, 10) == want.get_max_snr(10, 10)
    st, sj = got.get_spec_data(0, 0), want.get_spec_data(0, 0)
    assert st[1] == sj[1]


def test_uniform_noise_and_dense_constructor_match_jax():
    """The dense constructor's (S, b, l) transpose and descending-axis
    flip, ``NoiseMapUniform``, and the header-RMS default of
    ``from_fits``."""
    rng = np.random.default_rng(5)
    data = rng.normal(size=(40, 3, 5))               # (S, b, l)
    xarr = _NU0 - np.arange(40) * 1.2e4              # descending
    got = tcube.DataCube(data, xarr, 0.2, trans_id=2)
    want = jcube.DataCube(data, xarr, 0.2, trans_id=2)
    for k, v in _cube_fields(want).items():
        np.testing.assert_array_equal(_cube_fields(got)[k], v, err_msg=k)
    assert got.noise_map.get_noise(1, 1) == want.noise_map.get_noise(1, 1)
    path = os.path.join(DATA_DIR, "nh3_22_cutout.fits")
    ct = tcube.DataCube.from_fits(path, trans_id=2)
    cj = jcube.DataCube.from_fits(path, trans_id=2)
    np.testing.assert_array_equal(ct.get_flat_noise(), cj.get_flat_noise())


@pytest.mark.parametrize("shape", [(1, 1, 4, 4), (4,), (2, 4, 4)])
def test_noise_map_from_pbimg_matches_jax(shape):
    pb = np.linspace(0.1, 1.0, int(np.prod(shape))).reshape(shape)
    pb.flat[0] = np.nan
    got = _outcome(lambda: tcube.NoiseMap.from_pbimg(RMS, pb).data)
    want = _outcome(lambda: jcube.NoiseMap.from_pbimg(RMS, pb).data)
    _assert_same(got, want)
