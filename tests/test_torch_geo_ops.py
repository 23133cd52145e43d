"""The port's host geometry (geotrax_tpu_torch/ops/tmerc.py, filters.py)
equal bit for bit to the JAX package's numpy paths, which the stage runs,
and its lane assignment (ops/polygon.py) equal to the reference's on the
same float32 points and quads, chunked or not."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geotrax_tpu.ops import filters as jfil
from geotrax_tpu.ops import polygon as jpoly
from geotrax_tpu.ops import tmerc as jtm
from geotrax_tpu_torch.ops import filters as tfil
from geotrax_tpu_torch.ops import polygon as tpoly
from geotrax_tpu_torch.ops import tmerc as ttm

CRS = ["epsg:5186", "EPSG: 5179", "epsg:32652", "epsg:32752", "epsg:6677", "epsg:25832",
       "epsg:7855", 5187]


@pytest.mark.parametrize("crs", CRS)
def test_tmerc_equal(crs):
    rng = np.random.default_rng(0)
    params = ttm.resolve_crs(crs)
    assert params == jtm.resolve_crs(crs)
    lat = params.lat0_deg + rng.uniform(-3, 3, 500) if params.lat0_deg else rng.uniform(-60, 60, 500)
    lon = params.lon0_deg + rng.uniform(-3, 3, 500)
    if str(crs).startswith("epsg:327"):
        lat = -np.abs(lat)
    x, y = ttm.geo2local(lat, lon, "epsg:4326", crs)
    jx, jy = jtm.geo2local(lat, lon, "epsg:4326", crs, xp=np)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    la, lo = ttm.local2geo(x, y, crs)
    jla, jlo = jtm.local2geo(x, y, crs, xp=np)
    np.testing.assert_array_equal(la, jla)
    np.testing.assert_array_equal(lo, jlo)
    np.testing.assert_allclose(la, lat, atol=1e-9)


def test_tmerc_refuses_what_the_reference_refuses():
    for bad in ("epsg:9999", "utm33"):
        with pytest.raises(ValueError):
            ttm.resolve_crs(bad)
    with pytest.raises(ValueError):
        ttm.geo2local(37.0, 127.0, "epsg:4258", "epsg:5186")


@pytest.mark.parametrize("n", [1, 2, 5, 40, 300])
def test_filters_equal(n):
    x = np.cumsum(np.random.default_rng(n).normal(0, 1, n))
    for sigma in (1, 3, 14):
        np.testing.assert_array_equal(tfil.gaussian_filter1d_np(x, sigma),
                                      jfil.gaussian_filter1d_np(x, sigma))
    for window in (5, 14, 15):
        np.testing.assert_array_equal(tfil.savgol_filter_np(x, window),
                                      jfil.savgol_filter_np(x, window))


@pytest.mark.parametrize("chunk", [7, tpoly.CHUNK_POINTS])
def test_assign_first_polygon_equal(chunk):
    rng = np.random.default_rng(3)
    pts = rng.uniform(0, 100, (500, 2)).astype(np.float32)
    base = rng.uniform(0, 80, (12, 1, 2))
    quads = (base + np.array([[0, 0], [0, 15], [18, 16], [17, -1]])
             + rng.uniform(-2, 2, (12, 4, 2))).astype(np.float32)  # overlapping, skewed
    pts[:20] = quads[:5, :, :].reshape(-1, 2)  # on the corners themselves
    ref = np.asarray(jpoly.assign_first_polygon(jnp.asarray(pts), jnp.asarray(quads)))
    hit = tpoly.assign_first_polygon(torch.as_tensor(pts), torch.as_tensor(quads), chunk=chunk)
    np.testing.assert_array_equal(hit.numpy(), ref)
    assert (ref >= 0).sum() > 50 and (ref < 0).sum() > 50
    inside = tpoly.points_in_polygons(torch.as_tensor(pts), torch.as_tensor(quads)).numpy()
    np.testing.assert_array_equal(
        inside, np.asarray(jpoly.points_in_polygons(jnp.asarray(pts), jnp.asarray(quads))))
    assert tpoly.assign_first_polygon(torch.zeros((0, 2)), torch.as_tensor(quads)).shape == (0,)
