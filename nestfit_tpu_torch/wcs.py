"""Minimal exact celestial WCS (pixel <-> world): the port's own copy of
``nestfit_tpu/wcs.py`` (NumPy only, so the port imports nothing of the
JAX package), used by ``plotting.StorePlotter`` for world-coordinate
ticks.

The FITS celestial-WCS math for the projections survey cubes use -- the
zenithal family ``TAN`` (gnomonic), ``SIN`` (orthographic), ``ARC``
(equidistant), and the equatorial ``CAR`` (plate carree) -- following
Calabretta & Greisen (2002), "Representations of celestial coordinates
in FITS", sections 2-3 and 5.1, without astropy.

Conventions: FITS 1-based pixel coordinates, degrees throughout,
default ``LONPOLE = 180`` for zenithal projections (fiducial point at
the native pole).  Only the CDELT/CRPIX/CRVAL form is supported (no CD
or PC rotation matrices -- none of the pipeline's products carry
them; a header with PC/CD keys raises so a rotated field is never
silently mis-projected).
"""

import numpy as np

_D2R = np.pi / 180.0
_R2D = 180.0 / np.pi

_ZENITHAL = ("TAN", "SIN", "ARC")


class CelestialWCS:
    """2-D celestial WCS from a (simple) FITS header dict.

    Provides ``pixel_to_world`` / ``world_to_pixel`` for the sky axes
    (exact for TAN/SIN/ARC/CAR).  ``lon``/``lat`` follow the header's
    CTYPE1/CTYPE2 (RA/DEC or GLON/GLAT).
    """

    def __init__(self, header):
        h = dict(header)
        for k in ("PC1_1", "PC1_2", "PC2_1", "PC2_2", "CD1_1", "CD1_2",
                  "CD2_1", "CD2_2"):
            if k in h and not (
                k in ("PC1_1", "PC2_2") and float(h[k]) == 1.0
            ) and not (
                k in ("PC1_2", "PC2_1") and float(h[k]) == 0.0
            ):
                raise ValueError(
                    f"rotation matrix keyword {k} unsupported; only "
                    "CDELT/CRPIX/CRVAL headers are handled"
                )
        ct1 = str(h.get("CTYPE1", "RA---TAN")).strip()
        ct2 = str(h.get("CTYPE2", "DEC--TAN")).strip()
        self.lon_name = ct1.split("-")[0]
        self.lat_name = ct2.split("-")[0]
        code1 = ct1.split("-")[-1].upper() if "-" in ct1 else "TAN"
        code2 = ct2.split("-")[-1].upper() if "-" in ct2 else code1
        if code1 != code2:
            raise ValueError(f"mismatched projections {ct1!r}/{ct2!r}")
        if code1 not in _ZENITHAL + ("CAR",):
            raise ValueError(f"unsupported projection {code1!r}")
        self.code = code1
        self.crval1 = float(h.get("CRVAL1", 0.0))
        self.crval2 = float(h.get("CRVAL2", 0.0))
        self.crpix1 = float(h.get("CRPIX1", 1.0))
        self.crpix2 = float(h.get("CRPIX2", 1.0))
        self.cdelt1 = float(h.get("CDELT1", 1.0))
        self.cdelt2 = float(h.get("CDELT2", 1.0))
        if self.code == "CAR" and self.crval2 != 0.0:
            # the general oblique CAR rotation is not implemented;
            # survey headers with CAR always carry CRVAL2 = 0
            raise ValueError("CAR supported only with CRVAL2 == 0")
        self.lonpole = float(h.get("LONPOLE", 180.0))

    # -- native spherical <-> projection plane (C&G 2002 sec. 5.1)
    def _plane_to_native(self, x, y):
        phi = np.degrees(np.arctan2(np.radians(x), -np.radians(y)))
        r = np.hypot(x, y)
        if self.code == "TAN":
            theta = np.degrees(np.arctan2(_R2D, r))
        elif self.code == "SIN":
            theta = np.degrees(np.arccos(np.clip(r * _D2R, 0.0, 1.0)))
        else:  # ARC
            theta = 90.0 - r
        return phi, theta

    def _native_to_plane(self, phi, theta):
        if self.code == "TAN":
            r = _R2D / np.tan(np.radians(theta))
        elif self.code == "SIN":
            r = _R2D * np.cos(np.radians(theta))
        else:  # ARC
            r = 90.0 - theta
        x = r * np.sin(np.radians(phi))
        y = -r * np.cos(np.radians(phi))
        return x, y

    # -- native <-> celestial rotation (C&G 2002 eq. 2); for zenithal
    # projections the celestial pole sits at (alpha_p, delta_p) =
    # (CRVAL1, CRVAL2) and phi_p = LONPOLE
    def _native_to_celestial(self, phi, theta):
        pr = np.radians(phi - self.lonpole)
        tr = np.radians(theta)
        dp = np.radians(self.crval2)
        sd = np.sin(tr) * np.sin(dp) + np.cos(tr) * np.cos(dp) * np.cos(pr)
        dec = np.degrees(np.arcsin(np.clip(sd, -1.0, 1.0)))
        y = -np.cos(tr) * np.sin(pr)
        x = np.sin(tr) * np.cos(dp) - np.cos(tr) * np.sin(dp) * np.cos(pr)
        ra = self.crval1 + np.degrees(np.arctan2(y, x))
        return np.mod(ra, 360.0), dec

    def _celestial_to_native(self, ra, dec):
        ar = np.radians(ra - self.crval1)
        dr = np.radians(dec)
        dp = np.radians(self.crval2)
        st = np.sin(dr) * np.sin(dp) + np.cos(dr) * np.cos(dp) * np.cos(ar)
        theta = np.degrees(np.arcsin(np.clip(st, -1.0, 1.0)))
        y = -np.cos(dr) * np.sin(ar)
        x = np.sin(dr) * np.cos(dp) - np.cos(dr) * np.sin(dp) * np.cos(ar)
        phi = self.lonpole + np.degrees(np.arctan2(y, x))
        return phi, theta

    def pixel_to_world(self, p1, p2):
        """FITS 1-based pixel -> (lon, lat) degrees."""
        p1 = np.asarray(p1, dtype=np.float64)
        p2 = np.asarray(p2, dtype=np.float64)
        x = self.cdelt1 * (p1 - self.crpix1)
        y = self.cdelt2 * (p2 - self.crpix2)
        if self.code == "CAR":
            return np.mod(self.crval1 + x, 360.0), self.crval2 + y
        phi, theta = self._plane_to_native(x, y)
        return self._native_to_celestial(phi, theta)

    def world_to_pixel(self, lon, lat):
        """(lon, lat) degrees -> FITS 1-based pixel."""
        lon = np.asarray(lon, dtype=np.float64)
        lat = np.asarray(lat, dtype=np.float64)
        if self.code == "CAR":
            dx = np.mod(lon - self.crval1 + 180.0, 360.0) - 180.0
            x, y = dx, lat - self.crval2
        else:
            phi, theta = self._celestial_to_native(lon, lat)
            x, y = self._native_to_plane(phi, theta)
        return x / self.cdelt1 + self.crpix1, y / self.cdelt2 + self.crpix2
