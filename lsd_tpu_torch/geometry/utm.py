"""WGS84 <-> UTM transverse-Mercator projection (numpy only; a copy of
``lsd_tpu/geometry/utm.py``).

Host-side float64 numpy (precision matters for GNSS priors; a float32
device version would lose ~meters at UTM scale).  Projects lat/lon to a
metric frame anchored at the first fix, and back.

Uses the standard Krüger series (6th order), accurate to < 1 mm inside a
zone.
"""
from __future__ import annotations

import numpy as np

# WGS84
_A = 6378137.0
_F = 1.0 / 298.257223563
_K0 = 0.9996
_E2 = _F * (2 - _F)
_N = _F / (2 - _F)

_n = _N
# Krüger alpha/beta series coefficients (to n^6)
_ALPHA = np.array([
    _n / 2 - 2 * _n**2 / 3 + 5 * _n**3 / 16 + 41 * _n**4 / 180 - 127 * _n**5 / 288 + 7891 * _n**6 / 37800,
    13 * _n**2 / 48 - 3 * _n**3 / 5 + 557 * _n**4 / 1440 + 281 * _n**5 / 630 - 1983433 * _n**6 / 1935360,
    61 * _n**3 / 240 - 103 * _n**4 / 140 + 15061 * _n**5 / 26880 + 167603 * _n**6 / 181440,
    49561 * _n**4 / 161280 - 179 * _n**5 / 168 + 6601661 * _n**6 / 7257600,
    34729 * _n**5 / 80640 - 3418889 * _n**6 / 1995840,
    212378941 * _n**6 / 319334400,
])
_BETA = np.array([
    _n / 2 - 2 * _n**2 / 3 + 37 * _n**3 / 96 - _n**4 / 360 - 81 * _n**5 / 512 + 96199 * _n**6 / 604800,
    _n**2 / 48 + _n**3 / 15 - 437 * _n**4 / 1440 + 46 * _n**5 / 105 - 1118711 * _n**6 / 3870720,
    17 * _n**3 / 480 - 37 * _n**4 / 840 - 209 * _n**5 / 4480 + 5569 * _n**6 / 90720,
    4397 * _n**4 / 161280 - 11 * _n**5 / 504 - 830251 * _n**6 / 7257600,
    4583 * _n**5 / 161280 - 108847 * _n**6 / 3991680,
    20648693 * _n**6 / 638668800,
])
# Rectifying radius
_A_HAT = _A / (1 + _n) * (1 + _n**2 / 4 + _n**4 / 64 + _n**6 / 256)
_E = np.sqrt(_E2)


def utm_zone(lon_deg) -> int:
    return int(np.floor((np.asarray(lon_deg) + 180.0) / 6.0)) % 60 + 1


def latlon_to_utm(lat_deg, lon_deg, zone: int | None = None):
    """Return (easting, northing, zone).  Southern hemisphere northing is
    negative-continued (no 10,000 km false northing) so a single metric frame
    spans the equator — matching how the reference anchors maps at the first
    GNSS fix."""
    lat = np.deg2rad(np.asarray(lat_deg, dtype=np.float64))
    lon = np.deg2rad(np.asarray(lon_deg, dtype=np.float64))
    if zone is None:
        zone = utm_zone(np.rad2deg(np.mean(lon)))
    lon0 = np.deg2rad((zone - 1) * 6.0 - 180.0 + 3.0)

    # conformal latitude
    t = np.tan(lat)
    sigma = np.sinh(_E * np.arctanh(_E * t / np.sqrt(1 + t * t)))
    tp = t * np.sqrt(1 + sigma * sigma) - sigma * np.sqrt(1 + t * t)
    dlon = lon - lon0
    xi_p = np.arctan2(tp, np.cos(dlon))
    eta_p = np.arcsinh(np.sin(dlon) / np.sqrt(tp * tp + np.cos(dlon) ** 2))

    xi = xi_p.copy()
    eta = eta_p.copy()
    for j in range(6):
        k = 2 * (j + 1)
        xi = xi + _ALPHA[j] * np.sin(k * xi_p) * np.cosh(k * eta_p)
        eta = eta + _ALPHA[j] * np.cos(k * xi_p) * np.sinh(k * eta_p)

    easting = _K0 * _A_HAT * eta + 500000.0
    northing = _K0 * _A_HAT * xi
    return easting, northing, zone


def utm_to_latlon(easting, northing, zone: int):
    """Inverse of latlon_to_utm (same no-false-northing convention)."""
    xi = np.asarray(northing, dtype=np.float64) / (_K0 * _A_HAT)
    eta = (np.asarray(easting, dtype=np.float64) - 500000.0) / (_K0 * _A_HAT)

    xi_p = xi.copy()
    eta_p = eta.copy()
    for j in range(6):
        k = 2 * (j + 1)
        xi_p = xi_p - _BETA[j] * np.sin(k * xi) * np.cosh(k * eta)
        eta_p = eta_p - _BETA[j] * np.cos(k * xi) * np.sinh(k * eta)

    tp = np.sin(xi_p) / np.sqrt(np.sinh(eta_p) ** 2 + np.cos(xi_p) ** 2)
    # iterate to geodetic latitude
    t = tp.copy()
    for _ in range(5):
        sigma = np.sinh(_E * np.arctanh(_E * t / np.sqrt(1 + t * t)))
        f = t * np.sqrt(1 + sigma * sigma) - sigma * np.sqrt(1 + t * t) - tp
        df = (np.sqrt((1 + sigma * sigma) * (1 + t * t)) - sigma * t) * (1 - _E2) * np.sqrt(1 + t * t) / (1 + (1 - _E2) * t * t)
        t = t - f / df
    lat = np.arctan(t)
    lon0 = np.deg2rad((zone - 1) * 6.0 - 180.0 + 3.0)
    dlon = np.arctan2(np.sinh(eta_p), np.cos(xi_p))
    return np.rad2deg(lat), np.rad2deg(lon0 + dlon)


class UTMProjector:
    """Anchored metric projection: first fix becomes the origin.

    Mirrors the role of the reference's UTMProjector in slam.cpp (keyframe
    lat/lon <-> map x/y).
    """

    def __init__(self, zone: int | None = None):
        self.zone = zone
        self.origin = None  # (easting, northing)

    def project(self, lat_deg, lon_deg, relative: bool = True):
        e, n, zone = latlon_to_utm(lat_deg, lon_deg, self.zone)
        if self.zone is None:
            self.zone = zone
        if not relative:
            return e, n
        if self.origin is None:
            self.origin = (float(np.ravel(e)[0]), float(np.ravel(n)[0]))
        return e - self.origin[0], n - self.origin[1]

    def unproject(self, x, y):
        ox, oy = self.origin if self.origin is not None else (0.0, 0.0)
        return utm_to_latlon(np.asarray(x) + ox, np.asarray(y) + oy, self.zone)

    @property
    def lon0(self) -> float:
        """Central meridian of the anchored zone (degrees)."""
        z = self.zone if self.zone is not None else 31
        return (z - 1) * 6.0 - 180.0 + 3.0


def grid_convergence(lon0_deg: float, lat_deg: float,
                     lon_deg: float) -> float:
    """UTM grid convergence (degrees): the angle between grid north and
    true north at (lat, lon) for a zone with central meridian lon0.
    gamma ~ atan(tan(dlon) * sin(lat)) — the reference subtracts this from
    the INS heading before building RTK poses (rtkm.cpp:135
    get_grid_convergence)."""
    dlon = np.deg2rad(lon_deg - lon0_deg)
    lat = np.deg2rad(lat_deg)
    return float(np.rad2deg(np.arctan(np.tan(dlon) * np.sin(lat))))
