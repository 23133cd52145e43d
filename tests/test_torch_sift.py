"""The port's RootSIFT scale space (geotrax_tpu_torch/ops/sift.py) against
the JAX package's on the same seeded images, on the CPU.

Tolerances: the helpers within 1e-5 relative (float32 atan2 and sums round
in the last bits differently in XLA and PyTorch); on a level, the selected
pixels equal and in the same order where the scores are separated, the
descriptors within 1e-4, the scores and angles within 1e-4 relative."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geotrax_tpu.ops import features as jf
from geotrax_tpu.ops import sift as js
from geotrax_tpu_torch.ops import features as tf
from geotrax_tpu_torch.ops import sift as ts

HELPER_RTOL = 1e-5
DESC_ATOL = 1e-4
SCORE_RTOL = 1e-4


def textured(h, w, seed):
    """Smooth random field with blocks and lines: DoG extrema at every scale."""
    rng = np.random.default_rng(seed)
    field = np.kron(rng.uniform(0, 255, (h // 8 + 1, w // 8 + 1)), np.ones((8, 8)))[:h, :w]
    k = np.ones(5) / 5
    field = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, field)
    field = np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, field)
    for _ in range(h * w // 600):
        y, x = rng.integers(0, h - 8), rng.integers(0, w - 8)
        bh, bw = rng.integers(3, 9, 2)
        field[y:y + bh, x:x + bw] = rng.uniform(0, 255)
    for _ in range(4):
        field[rng.integers(0, h - 2):, :][:2] = 200
    return field.astype(np.float32)


def both(x):
    return jnp.asarray(x), torch.as_tensor(x)


@pytest.fixture(scope="module")
def img():
    return textured(96, 128, 0)


def test_gaussian_blur_float32_equal(img):
    j, t = both(img)
    for sigma in (1.6, 2.56, 2.4):
        np.testing.assert_array_equal(tf._gaussian_blur(t, sigma).numpy(),
                                      np.asarray(jf._gaussian_blur(j, sigma)))


def test_helpers_against_jax(img):
    j, t = both(img)
    np.testing.assert_array_equal(ts._triangle_blur(t, 4).numpy(),
                                  np.asarray(js._triangle_blur(j, 4)))
    jp, jm = js._orientation_planes(j)
    tp, tm = ts._orientation_planes(t)
    assert tp.shape == (8, 96, 128)
    scale = float(np.asarray(jm).max())
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=HELPER_RTOL,
                               atol=HELPER_RTOL * scale)
    np.testing.assert_allclose(tp.permute(1, 2, 0).numpy(), np.asarray(jp), rtol=HELPER_RTOL,
                               atol=HELPER_RTOL * scale)

    rng = np.random.default_rng(1)
    planes = rng.uniform(0, 1, (20, 30, 8)).astype(np.float32)
    x = rng.uniform(-3, 33, (50, 16)).astype(np.float32)   # outside the borders too
    y = rng.uniform(-3, 23, (50, 16)).astype(np.float32)
    np.testing.assert_allclose(
        ts._bilinear_planes(torch.as_tensor(planes), torch.as_tensor(x), torch.as_tensor(y)).numpy(),
        np.asarray(js._bilinear_planes(jnp.asarray(planes), jnp.asarray(x), jnp.asarray(y))),
        rtol=HELPER_RTOL, atol=1e-7)

    vals = rng.uniform(0, 1, (50, 16, 8)).astype(np.float32)
    shift = rng.uniform(-1, 9, (50, 1)).astype(np.float32)
    np.testing.assert_allclose(
        ts._circular_shift_bins(torch.as_tensor(vals), torch.as_tensor(shift)).numpy(),
        np.asarray(js._circular_shift_bins(jnp.asarray(vals), jnp.asarray(shift))),
        rtol=HELPER_RTOL, atol=1e-7)


def assert_same_features(jres, tres):
    """Same selected pixels in the same order where the scores are
    separated (the order of exact ties may differ by rounding), and the
    rest within the module's tolerances."""
    jxy, jsc, jan, jva, jde = (np.asarray(a) for a in jres)
    txy, tsc, tan, tva, tde = (a.numpy() for a in tres)
    assert jxy.shape == txy.shape and jde.shape == tde.shape
    scale = max(float(jsc.max()), 1e-6)
    gaps = np.abs(np.diff(jsc)) > SCORE_RTOL * scale
    sep = np.concatenate([[True], gaps]) & np.concatenate([gaps, [True]])
    sep &= jva
    assert sep.sum() > 0.8 * jva.sum() > 0
    np.testing.assert_array_equal(txy[sep], jxy[sep])
    np.testing.assert_array_equal(tva, jva)
    np.testing.assert_allclose(tsc, jsc, rtol=SCORE_RTOL, atol=SCORE_RTOL * scale)
    np.testing.assert_allclose(tde[sep], jde[sep], atol=DESC_ATOL)
    ang = np.angle(np.exp(1j * (tan[sep] - jan[sep])))
    assert np.abs(ang).max() < 1e-3


def test_level_features_against_jax(img):
    j, t = both(img)
    for budget in (200, 5000):  # 5000 > the valid maxima: the zero tail too
        assert_same_features(js._level_features(j, budget), ts._level_features(t, budget))
    mask = np.ones(img.shape, bool)
    mask[20:60, 30:90] = False
    res = ts._level_features(t, 200, mask=torch.as_tensor(mask))
    assert_same_features(js._level_features(j, 200, mask=jnp.asarray(mask)), res)
    xy = res[0].numpy()[res[3].numpy()].astype(int)
    assert mask[xy[:, 1], xy[:, 0]].all()


def test_banded_against_jax(monkeypatch):
    """Banding forced on a small level in both packages, as tests/test_sift.py
    forces it: the same bands, per-band quotas and global cut."""
    level = textured(160, 256, 3)
    limit = 160 * 256 // 3 + 1  # three bands
    monkeypatch.setattr(js, "BAND_PIXEL_LIMIT", limit)
    monkeypatch.setattr(ts, "BAND_PIXEL_LIMIT", limit)
    assert ts.band_layout(160, 256)[0] == 3
    j, t = both(level)
    for budget in (60, 400):
        jres = js._level_features_banded(j, budget)
        tres = ts._level_features_banded(t, budget)
        assert tres[0].shape == (min(budget, 3 * int(np.ceil(2 * budget / 3))), 2)
        assert_same_features(jres, tres)


def test_resize_rules():
    """The pyramid's linear resize and the mask's nearest resize are
    jax.image.resize's."""
    import jax

    g = textured(97, 131, 5)
    for shape in ((69, 93), (48, 65)):
        np.testing.assert_allclose(ts.resize_linear(torch.as_tensor(g), *shape).numpy(),
                                   np.asarray(jax.image.resize(jnp.asarray(g), shape, "linear")),
                                   rtol=1e-5, atol=1e-3)
    mask = np.random.default_rng(2).uniform(size=(97, 131)) > 0.5
    for shape in ((69, 93), (48, 65), (97, 40)):
        ref = np.asarray(jax.image.resize(jnp.asarray(mask, jnp.float32), shape, "nearest")) > 0.5
        np.testing.assert_array_equal(
            ts.resize_mask_nearest(torch.as_tensor(mask), *shape).numpy(), ref)


def test_detect_and_describe_with_mask():
    """Budgets split as 1/s over the kept levels, masked regions empty, xy
    rescaled to level 0 with the half-pixel rule, and the features equal to
    the reference's where scores are separated."""
    g = textured(192, 256, 4)
    mask = np.ones(g.shape, bool)
    mask[40:120, 60:200] = False
    plan = ts.level_plan(192, 256, 3000)
    assert [p[1:3] for p in plan] == [(192, 256), (136, 181), (96, 128), (68, 91)]
    budgets = [p[3] for p in plan]
    w = np.array([1 / p[0] for p in plan])
    assert budgets == list(np.maximum((3000 * w / w.sum()).astype(int), 16))
    jres = js.detect_and_describe(jnp.asarray(g), 3000, mask=jnp.asarray(mask))
    tres = ts.detect_and_describe(torch.as_tensor(g), 3000, mask=torch.as_tensor(mask))
    assert tres.xy.shape == (sum(budgets), 2)
    offset = 0
    for s, lh, lw, b in plan:
        sl = slice(offset, offset + b)
        assert_same_features([getattr(jres, k)[sl] for k in ts.SiftFeatures._fields],
                             [getattr(tres, k)[sl] for k in ts.SiftFeatures._fields])
        offset += b
    xy = tres.xy.numpy()[tres.valid.numpy()]
    assert (xy >= -0.5).all() and (xy[:, 0] < 256).all() and (xy[:, 1] < 192).all()
    inside = (xy[:, 0] > 64) & (xy[:, 0] < 196) & (xy[:, 1] > 44) & (xy[:, 1] < 116)
    assert not inside.any()
    # level 2 (s = 2): level pixel i sits at (i + 0.5) * 2 - 0.5 = 2i + 0.5
    lvl = slice(budgets[0] + budgets[1], budgets[0] + budgets[1] + budgets[2])
    frac = np.mod(tres.xy.numpy()[lvl][tres.valid.numpy()[lvl]], 2.0)
    np.testing.assert_allclose(frac, 0.5, atol=1e-5)


def test_match_l2_on_features(img):
    feats = ts.detect_and_describe(torch.as_tensor(img), 400)
    m = ts.match_l2(feats.desc, feats.valid, feats.desc, feats.valid, ratio=0.99)
    ok = m.valid.numpy()
    assert ok.sum() > 50
    np.testing.assert_array_equal(m.idx_b.numpy()[ok], np.arange(len(ok))[ok])
