"""Transverse Mercator (Krueger/Karney series) reprojection on the host.

The port's copy of the float64 numpy path of ``geotrax_tpu/ops/tmerc.py``,
which is what the georeferencing stage runs (``xp=np``): WGS84 geographic
to a local projected CRS with Karney's 6th-order series (sub-micrometre for
|lon - lon0| < 10 degrees). The CRS registry covers the Korean TM family of
the Songdo deployment and the UTM-style zone families. ``xp`` stays a
parameter so that the functions read as the reference's; numpy is the only
module passed here.
"""

from __future__ import annotations

import math
import re
from functools import lru_cache
from typing import NamedTuple

import numpy as np


class Ellipsoid(NamedTuple):
    a: float  # semi-major axis [m]
    f: float  # flattening


GRS80 = Ellipsoid(a=6378137.0, f=1.0 / 298.257222101)
WGS84 = Ellipsoid(a=6378137.0, f=1.0 / 298.257223563)
BESSEL = Ellipsoid(a=6377397.155, f=1.0 / 299.1528128)


class TMercParams(NamedTuple):
    lat0_deg: float
    lon0_deg: float
    k0: float
    x0: float  # false easting
    y0: float  # false northing
    ellipsoid: Ellipsoid


# Projected CRS registry (EPSG id -> transverse-mercator parameters).
# Explicit entries per EPSG definitions; zone families (UTM/MGA/JPRCS)
# resolve programmatically below. All listed CRS sit on GRS80/WGS84-class
# datums (KGD2002, ETRS89, NAD83, GDA, JGD2011) whose offset from WGS84 is
# at or below the ~1-2 m datum level — the georeference stage anchors to a
# registered orthophoto, so only the PROJECTION must match, which it does.
CRS_REGISTRY: dict[int, TMercParams] = {
    # Korea 2000 belts (2010 numbering, y0 600 km)
    5185: TMercParams(38.0, 125.0, 1.0, 200000.0, 600000.0, GRS80),  # West
    5186: TMercParams(38.0, 127.0, 1.0, 200000.0, 600000.0, GRS80),  # Central
    5187: TMercParams(38.0, 129.0, 1.0, 200000.0, 600000.0, GRS80),  # East
    5188: TMercParams(38.0, 131.0, 1.0, 200000.0, 600000.0, GRS80),  # East Sea
    # Korea 2000 belts (original numbering, y0 500 km) + Jeju 550 km
    5180: TMercParams(38.0, 125.0, 1.0, 200000.0, 500000.0, GRS80),
    5181: TMercParams(38.0, 127.0, 1.0, 200000.0, 500000.0, GRS80),
    5182: TMercParams(38.0, 127.0, 1.0, 200000.0, 550000.0, GRS80),
    5183: TMercParams(38.0, 129.0, 1.0, 200000.0, 500000.0, GRS80),
    5184: TMercParams(38.0, 131.0, 1.0, 200000.0, 500000.0, GRS80),
    # Korea 2000 / Unified CS (UTM-K)
    5179: TMercParams(38.0, 127.5, 0.9996, 1000000.0, 2000000.0, GRS80),
}

# JGD2011 Japan Plane Rectangular CS zones I-XIX (EPSG 6669-6687):
# (lat0, lon0) per zone, k0 0.9999, no false offsets.
_JPRCS_ORIGINS = [
    (33.0, 129.5), (33.0, 131.0), (36.0, 132.0 + 10 / 60), (33.0, 133.5),
    (36.0, 134.0 + 20 / 60), (36.0, 136.0), (36.0, 137.0 + 10 / 60),
    (36.0, 138.5), (36.0, 139.0 + 50 / 60), (40.0, 140.0 + 50 / 60),
    (44.0, 140.25), (44.0, 142.25), (44.0, 144.25), (26.0, 142.0),
    (26.0, 127.5), (26.0, 124.0), (26.0, 131.0), (20.0, 136.0),
    (26.0, 154.0),
]


def _register_utm(epsg: int) -> TMercParams | None:
    """Programmatic zone families (6-degree UTM-style TM grids):
    WGS84 UTM 326xx/327xx, ETRS89 UTM 258xx, NAD83 UTM 269xx,
    GDA94 MGA 283xx, GDA2020 MGA 78xx, JGD2011 zones 6669-6687."""
    if 32601 <= epsg <= 32660:  # WGS84 / UTM north
        zone = epsg - 32600
        return TMercParams(0.0, zone * 6.0 - 183.0, 0.9996, 500000.0, 0.0, WGS84)
    if 32701 <= epsg <= 32760:  # WGS84 / UTM south
        zone = epsg - 32700
        return TMercParams(0.0, zone * 6.0 - 183.0, 0.9996, 500000.0, 10000000.0, WGS84)
    if 25828 <= epsg <= 25838:  # ETRS89 / UTM 28N-38N
        zone = epsg - 25800
        return TMercParams(0.0, zone * 6.0 - 183.0, 0.9996, 500000.0, 0.0, GRS80)
    if 26901 <= epsg <= 26923:  # NAD83 / UTM 1N-23N
        zone = epsg - 26900
        return TMercParams(0.0, zone * 6.0 - 183.0, 0.9996, 500000.0, 0.0, GRS80)
    if 28348 <= epsg <= 28358:  # GDA94 / MGA 48-58 (southern hemisphere)
        zone = epsg - 28300
        return TMercParams(0.0, zone * 6.0 - 183.0, 0.9996, 500000.0, 10000000.0, GRS80)
    if 7846 <= epsg <= 7859:  # GDA2020 / MGA 46-59
        zone = epsg - 7800
        return TMercParams(0.0, zone * 6.0 - 183.0, 0.9996, 500000.0, 10000000.0, GRS80)
    if 6669 <= epsg <= 6687:  # JGD2011 / Japan Plane Rectangular CS I-XIX
        lat0, lon0 = _JPRCS_ORIGINS[epsg - 6669]
        return TMercParams(lat0, lon0, 0.9999, 0.0, 0.0, GRS80)
    return None


def resolve_crs(crs: str | int) -> TMercParams:
    """'epsg:5186' / 5186 -> projection parameters."""
    if isinstance(crs, str):
        match = re.match(r"(?i)epsg:\s*(\d+)", crs.strip())
        if not match:
            raise ValueError(f"Unsupported CRS spec '{crs}' (expected 'epsg:<id>')")
        crs = int(match.group(1))
    if crs in CRS_REGISTRY:
        return CRS_REGISTRY[crs]
    utm = _register_utm(crs)
    if utm is not None:
        return utm
    raise ValueError(
        f"EPSG:{crs} is not in the transverse-mercator registry; add its "
        "parameters to geotrax_tpu_torch.ops.tmerc.CRS_REGISTRY."
    )


@lru_cache(maxsize=16)
def _series_constants(ellipsoid: Ellipsoid):
    """Karney 2011 series coefficients (order n^6) and rectifying radius A."""
    f = ellipsoid.f
    n = f / (2.0 - f)
    n2, n3, n4, n5, n6 = n**2, n**3, n**4, n**5, n**6
    big_a = ellipsoid.a / (1 + n) * (1 + n2 / 4 + n4 / 64 + n6 / 256)
    alpha = np.array([
        n / 2 - 2 * n2 / 3 + 5 * n3 / 16 + 41 * n4 / 180 - 127 * n5 / 288 + 7891 * n6 / 37800,
        13 * n2 / 48 - 3 * n3 / 5 + 557 * n4 / 1440 + 281 * n5 / 630 - 1983433 * n6 / 1935360,
        61 * n3 / 240 - 103 * n4 / 140 + 15061 * n5 / 26880 + 167603 * n6 / 181440,
        49561 * n4 / 161280 - 179 * n5 / 168 + 6601661 * n6 / 7257600,
        34729 * n5 / 80640 - 3418889 * n6 / 1995840,
        212378941 * n6 / 319334400,
    ])
    beta = np.array([
        n / 2 - 2 * n2 / 3 + 37 * n3 / 96 - n4 / 360 - 81 * n5 / 512 + 96199 * n6 / 604800,
        n2 / 48 + n3 / 15 - 437 * n4 / 1440 + 46 * n5 / 105 - 1118711 * n6 / 3870720,
        17 * n3 / 480 - 37 * n4 / 840 - 209 * n5 / 4480 + 5569 * n6 / 90720,
        4397 * n4 / 161280 - 11 * n5 / 504 - 830251 * n6 / 7257600,
        4583 * n5 / 161280 - 108847 * n6 / 3991680,
        20648693 * n6 / 638668800,
    ])
    e = math.sqrt(f * (2 - f))
    return big_a, alpha, beta, e


def _meridian_arc(lat0_rad: float, ellipsoid: Ellipsoid) -> float:
    """Rectifying arc length from the equator to lat0 (for false-origin y)."""
    big_a, alpha, _, e = _series_constants(ellipsoid)
    tau = math.tan(lat0_rad)
    sigma = math.sinh(e * math.atanh(e * tau / math.sqrt(1 + tau * tau)))
    taup = tau * math.sqrt(1 + sigma * sigma) - sigma * math.sqrt(1 + tau * tau)
    # series on the FIXED base angle, exactly like geodetic_to_tmerc's xi_p
    # accumulation — evaluating on the running xi instead disagrees with the
    # forward by ~1.4 cm at lat0 38, shifting every absolute northing
    xi_p = math.atan2(taup, 1.0)
    xi = xi_p
    for j, a_j in enumerate(alpha, start=1):
        xi += a_j * math.sin(2 * j * xi_p)
    return big_a * xi


def geodetic_to_tmerc(lat_deg, lon_deg, params: TMercParams, xp=np):
    """(lat, lon) degrees -> (x=easting, y=northing) metres. Vectorized."""
    big_a, alpha, _, e = _series_constants(params.ellipsoid)
    lat = xp.deg2rad(xp.asarray(lat_deg))
    lam = xp.deg2rad(xp.asarray(lon_deg) - params.lon0_deg)

    tau = xp.tan(lat)
    sigma = xp.sinh(e * xp.arctanh(e * tau / xp.sqrt(1 + tau * tau)))
    taup = tau * xp.sqrt(1 + sigma * sigma) - sigma * xp.sqrt(1 + tau * tau)

    xi_p = xp.arctan2(taup, xp.cos(lam))
    eta_p = xp.arcsinh(xp.sin(lam) / xp.sqrt(taup * taup + xp.cos(lam) ** 2))

    xi = xi_p
    eta = eta_p
    for j, a_j in enumerate(alpha, start=1):
        xi = xi + a_j * xp.sin(2 * j * xi_p) * xp.cosh(2 * j * eta_p)
        eta = eta + a_j * xp.cos(2 * j * xi_p) * xp.sinh(2 * j * eta_p)

    m0 = _meridian_arc(math.radians(params.lat0_deg), params.ellipsoid)
    x = params.x0 + params.k0 * big_a * eta
    y = params.y0 + params.k0 * (big_a * xi - m0)
    return x, y


def tmerc_to_geodetic(x, y, params: TMercParams, xp=np):
    """(x=easting, y=northing) metres -> (lat, lon) degrees. Vectorized."""
    big_a, _, beta, e = _series_constants(params.ellipsoid)
    m0 = _meridian_arc(math.radians(params.lat0_deg), params.ellipsoid)
    xi = (xp.asarray(y) - params.y0 + params.k0 * m0) / (params.k0 * big_a)
    eta = (xp.asarray(x) - params.x0) / (params.k0 * big_a)

    xi_p = xi
    eta_p = eta
    for j, b_j in enumerate(beta, start=1):
        xi_p = xi_p - b_j * xp.sin(2 * j * xi) * xp.cosh(2 * j * eta)
        eta_p = eta_p - b_j * xp.cos(2 * j * xi) * xp.sinh(2 * j * eta)

    taup = xp.sin(xi_p) / xp.sqrt(xp.sinh(eta_p) ** 2 + xp.cos(xi_p) ** 2)

    # Invert tau' -> tau by Newton iteration (3 steps reach double precision).
    tau = taup
    for _ in range(5):
        sigma = xp.sinh(e * xp.arctanh(e * tau / xp.sqrt(1 + tau * tau)))
        f_tau = tau * xp.sqrt(1 + sigma * sigma) - sigma * xp.sqrt(1 + tau * tau) - taup
        d_tau = (xp.sqrt((1 + sigma * sigma) * (1 + tau * tau)) - sigma * tau) * \
            (1 - e * e) * xp.sqrt(1 + tau * tau) / (1 + (1 - e * e) * tau * tau)
        tau = tau - f_tau / d_tau

    lat = xp.rad2deg(xp.arctan(tau))
    lon = params.lon0_deg + xp.rad2deg(xp.arctan2(xp.sinh(eta_p), xp.cos(xi_p)))
    return lat, lon


def geo2local(lat_deg, lon_deg, source_crs: str = "epsg:4326", target_crs: str = "epsg:5186", xp=np):
    """Pipeline entry: WGS84 geographic -> local projected metres.

    Mirrors reference geo2local (georeference.py:618-628). Geographic source
    CRS other than EPSG:4326 would need a datum shift; the supported targets
    (Korea 2000, WGS84 UTM) share the WGS84/GRS80 datum to within <1 mm, so
    no Helmert step is applied.
    """
    src = str(source_crs).lower().replace(" ", "")
    if src not in ("epsg:4326",):
        raise ValueError(f"Unsupported geographic source CRS '{source_crs}'")
    return geodetic_to_tmerc(lat_deg, lon_deg, resolve_crs(target_crs), xp=xp)


def local2geo(x, y, target_crs: str = "epsg:5186", xp=np):
    return tmerc_to_geodetic(x, y, resolve_crs(target_crs), xp=xp)
