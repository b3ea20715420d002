"""Port parity of the celestial WCS (``nestfit_tpu_torch/wcs.py``) against
``nestfit_tpu/wcs.py``: the cases of ``tests/test_wcs.py`` on the port's
class, and both classes bit for bit on seeded pixels and world points
for every projection."""

import numpy as np
import pytest

from nestfit_tpu.wcs import CelestialWCS as JaxWCS
from nestfit_tpu_torch.wcs import CelestialWCS


def _hdr(code, crval1=83.5, crval2=22.0, cd=-2.8e-4, cd2=None):
    return {
        "CTYPE1": f"RA---{code}", "CTYPE2": f"DEC--{code}",
        "CRVAL1": crval1, "CRVAL2": crval2,
        "CRPIX1": 33.0, "CRPIX2": 17.0,
        "CDELT1": cd, "CDELT2": -cd if cd2 is None else cd2,
    }


@pytest.mark.parametrize("code", ["TAN", "SIN", "ARC"])
def test_reference_pixel_and_roundtrip(code):
    w = CelestialWCS(_hdr(code))
    ra, dec = w.pixel_to_world(33.0, 17.0)
    np.testing.assert_allclose([ra, dec], [83.5, 22.0], atol=1e-12)
    p1, p2 = np.meshgrid(np.arange(1.0, 66.0, 7.0),
                         np.arange(1.0, 34.0, 5.0))
    lon, lat = w.pixel_to_world(p1, p2)
    q1, q2 = w.world_to_pixel(lon, lat)
    np.testing.assert_allclose(q1, p1, atol=1e-6)
    np.testing.assert_allclose(q2, p2, atol=1e-6)


def test_tan_equator_analytic():
    w = CelestialWCS(_hdr("TAN", crval1=180.0, crval2=0.0, cd=1.0, cd2=1.0))
    for d_deg in (0.5, 2.0, 10.0):
        x_expect = np.degrees(np.tan(np.radians(d_deg)))
        p1, p2 = w.world_to_pixel(180.0 + d_deg, 0.0)
        np.testing.assert_allclose(p1 - 33.0, x_expect, rtol=1e-12)
        np.testing.assert_allclose(p2, 17.0, atol=1e-9)
    p1, p2 = w.world_to_pixel(180.0, 5.0)
    np.testing.assert_allclose(
        p2 - 17.0, np.degrees(np.tan(np.radians(5.0))), rtol=1e-12)
    np.testing.assert_allclose(p1, 33.0, atol=1e-9)


def test_sin_equator_analytic():
    w = CelestialWCS(_hdr("SIN", crval1=10.0, crval2=0.0, cd=1.0, cd2=1.0))
    p1, _ = w.world_to_pixel(10.0 + 4.0, 0.0)
    np.testing.assert_allclose(
        p1 - 33.0, np.degrees(np.sin(np.radians(4.0))), rtol=1e-12)


def test_arc_is_angular_distance():
    w = CelestialWCS(_hdr("ARC", crval1=83.5, crval2=54.0, cd=1.0, cd2=1.0))
    ra, dec = 88.0, 57.0
    p1, p2 = w.world_to_pixel(ra, dec)
    r_plane = np.hypot(p1 - 33.0, p2 - 17.0)
    a1, d1, a2, d2 = np.radians([83.5, 54.0, ra, dec])
    sep = np.degrees(np.arccos(
        np.sin(d1) * np.sin(d2) + np.cos(d1) * np.cos(d2) * np.cos(a2 - a1)
    ))
    np.testing.assert_allclose(r_plane, sep, rtol=1e-10)


def test_cos_dec_scaling():
    w = CelestialWCS(_hdr("TAN", crval1=50.0, crval2=60.0, cd=1.0, cd2=1.0))
    d = 0.01
    p1, _ = w.world_to_pixel(50.0 + d, 60.0)
    np.testing.assert_allclose(p1 - 33.0, d * 0.5, rtol=1e-4)


def _car():
    return {"CTYPE1": "RA---CAR", "CTYPE2": "DEC--CAR", "CRVAL1": 30.0,
            "CRVAL2": 0.0, "CRPIX1": 1.0, "CRPIX2": 1.0,
            "CDELT1": 0.1, "CDELT2": 0.1}


@pytest.mark.parametrize("cls", [CelestialWCS, JaxWCS],
                         ids=["port", "jax"])
def test_car_and_errors(cls):
    h = _car()
    w = cls(h)
    ra, dec = w.pixel_to_world(11.0, 21.0)
    np.testing.assert_allclose([ra, dec], [31.0, 2.0], atol=1e-12)
    with pytest.raises(ValueError, match="CRVAL2"):
        cls({**h, "CRVAL2": 5.0})
    with pytest.raises(ValueError, match="unsupported projection"):
        cls(_hdr("AIT"))
    with pytest.raises(ValueError, match="mismatched projections"):
        cls({**_hdr("TAN"), "CTYPE2": "DEC--SIN"})
    # rotated headers raise in both packages; an identity PC is tolerated
    for key, val in (("CD1_1", 2e-4), ("PC1_2", 0.1), ("PC2_2", 0.9),
                     ("CD2_1", 1e-5)):
        with pytest.raises(ValueError, match="rotation matrix"):
            cls({**_hdr("TAN"), key: val})
    cls({**_hdr("TAN"), "PC1_1": 1.0, "PC1_2": 0.0})


@pytest.mark.parametrize("hdr", [
    _hdr("TAN"), _hdr("SIN", crval2=-35.0), _hdr("ARC", crval1=350.0,
                                                 crval2=71.0),
    _car(), {"CTYPE1": "GLON-TAN", "CTYPE2": "GLAT-TAN", "CRVAL1": 28.5,
             "CRVAL2": -0.2, "CRPIX1": 40.5, "CRPIX2": 30.0,
             "CDELT1": -2.2e-3, "CDELT2": 2.2e-3, "LONPOLE": 180.0}],
    ids=["tan", "sin", "arc", "car", "glon-tan"])
def test_bit_for_bit_against_the_jax_class(hdr):
    rng = np.random.default_rng(7)
    port, ref = CelestialWCS(hdr), JaxWCS(hdr)
    assert (port.lon_name, port.lat_name, port.code) == \
        (ref.lon_name, ref.lat_name, ref.code)
    p1, p2 = rng.uniform(-20.0, 90.0, size=(2, 257))
    for got, want in zip(port.pixel_to_world(p1, p2),
                         ref.pixel_to_world(p1, p2)):
        np.testing.assert_array_equal(got, want)
    lon, lat = ref.pixel_to_world(p1, p2)
    lon = lon + rng.normal(scale=1e-3, size=lon.shape)
    for got, want in zip(port.world_to_pixel(lon, lat),
                         ref.world_to_pixel(lon, lat)):
        np.testing.assert_array_equal(got, want)
    # scalars go through as scalars in both
    np.testing.assert_array_equal(port.pixel_to_world(3.0, 4.0),
                                  ref.pixel_to_world(3.0, 4.0))


def test_sexagesimal_formatters():
    from nestfit_tpu_torch.plotting import format_dec_dms, format_ra_hms

    assert format_ra_hms(180.0) == "12:00:00.0"
    assert format_ra_hms(83.63308) == "5:34:31.9"
    assert format_dec_dms(22.0145) == "+22:00:52"
    assert format_dec_dms(-5.5) == "-5:30:00"
