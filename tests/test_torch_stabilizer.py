"""The port's sequential Stabilizer (geotrax_tpu_torch/stabilize/stabilizer.py)
against the JAX package's on a shifted and rotated pair, on the CPU, for
both branches: the single-level path (FAST, grid descriptor) and the
RootSIFT path. The reference runs with its 9x9 eigensolve in float64, as
the port solves it (ROADMAP C3).

Tolerances: keypoint, match and inlier counts equal; H within 1e-4 in its
linear entries and 0.05 px in its translation; boxes in reference
coordinates within 0.05 px."""

import jax
import numpy as np
import pytest

import geotrax_tpu.ops.ransac as jr
from geotrax_tpu.stabilize import Stabilizer as JaxStabilizer
from geotrax_tpu_torch.stabilize import Stabilizer
from test_torch_pipeline import fit_homography_normal_eigh64

LIN_TOL = 1e-4
TRANS_TOL = 0.05
BOX_TOL = 0.05


def scene(h, w, seed):
    """Textured RGB scene: smooth field, blocks and lines."""
    rng = np.random.default_rng(seed)
    field = np.kron(rng.uniform(30, 220, (h // 8 + 1, w // 8 + 1)), np.ones((8, 8)))[:h, :w]
    k = np.ones(3) / 3
    field = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, field)
    field = np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, field)
    for _ in range(h * w // 300):
        y, x = rng.integers(0, h - 10), rng.integers(0, w - 10)
        bh, bw = rng.integers(3, 10, 2)
        field[y:y + bh, x:x + bw] = rng.uniform(0, 255)
    rgb = np.stack([field, field * 0.9 + 10, field * 0.8 + 20], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def warp(img, h_dst_to_src, out_hw):
    """Bilinear sample of ``img`` at H @ (x, y, 1) for every output pixel
    (zero outside)."""
    oh, ow = out_hw
    ys, xs = np.mgrid[0:oh, 0:ow].astype(np.float64)
    p = np.stack([xs, ys, np.ones_like(xs)], -1) @ h_dst_to_src.T
    sx, sy = p[..., 0] / p[..., 2], p[..., 1] / p[..., 2]
    x0, y0 = np.floor(sx).astype(int), np.floor(sy).astype(int)
    fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]
    src = np.pad(img.astype(np.float64), ((1, 2), (1, 2), (0, 0)))
    h, w = img.shape[:2]

    def at(yy, xx):
        ok = (yy >= -1) & (yy <= h) & (xx >= -1) & (xx <= w)
        v = src[np.clip(yy + 1, 0, h + 2), np.clip(xx + 1, 0, w + 2)]
        return np.where(ok[..., None], v, 0.0)

    out = (at(y0, x0) * (1 - fx) * (1 - fy) + at(y0, x0 + 1) * fx * (1 - fy)
           + at(y0 + 1, x0) * (1 - fx) * fy + at(y0 + 1, x0 + 1) * fx * fy)
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def similarity(angle_deg, scale, tx, ty, cx, cy):
    a = np.deg2rad(angle_deg)
    c, s = np.cos(a) * scale, np.sin(a) * scale
    return np.array([[c, -s, cx - c * cx + s * cy + tx],
                     [s, c, cy - s * cx - c * cy + ty],
                     [0, 0, 1.0]])


@pytest.fixture(scope="module")
def pair():
    ref = scene(240, 320, 0)
    h_cur_to_ref = similarity(2.0, 1.0, 4.0, -3.0, 160, 120)
    cur = warp(ref, h_cur_to_ref, (240, 320))
    boxes = np.array([[100.0, 80.0, 30.0, 16.0], [220.0, 150.0, 24.0, 40.0]], np.float32)
    return ref, cur, h_cur_to_ref, boxes


@pytest.fixture(scope="module")
def eigh64():
    mp = pytest.MonkeyPatch()
    mp.setattr(jr, "fit_homography_normal", fit_homography_normal_eigh64)
    jax.clear_caches()
    yield
    mp.undo()
    jax.clear_caches()


def run(cls, cfg, pair, **kw):
    ref, cur, _, boxes = pair
    stab = cls(**cfg, **kw)
    stab.set_ref_frame(ref, boxes)
    stab.stabilize(cur, boxes)
    return stab


CONFIGS = {
    "orb": dict(downsample_ratio=0.5, max_features=600, filter_ratio=0.9,
                ransac_epipolar_threshold=2.0, detector_name="orb"),
    "rsift": dict(downsample_ratio=1.0, max_features=1500, ref_multiplier=1.0, filter_ratio=0.8,
                  ransac_epipolar_threshold=3.0, detector_name="rsift"),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_stabilizer_against_jax(name, pair, eigh64):
    j = run(JaxStabilizer, CONFIGS[name], pair)
    t = run(Stabilizer, CONFIGS[name], pair, device="cpu")
    assert t.n_levels == j.n_levels and t.use_sift == (name == "rsift")
    assert t.get_cur_num_keypoints() == j.get_cur_num_keypoints()
    assert t.get_cur_num_matches() == j.get_cur_num_matches() > 50
    assert t.get_cur_inliers_count() == j.get_cur_inliers_count() > 30
    ht, hj = t.get_cur_trans_matrix(), j.get_cur_trans_matrix()
    np.testing.assert_allclose(ht[:, :2], hj[:, :2], atol=LIN_TOL)
    np.testing.assert_allclose(ht[:2, 2], hj[:2, 2], atol=TRANS_TOL)
    assert ht[2, 2] == 1.0
    # the true warp, within a pixel at the frame's corners
    corners = np.array([[0, 0, 1], [319, 0, 1], [319, 239, 1], [0, 239, 1]], float)
    p, q = corners @ ht.T, corners @ pair[2].T
    assert np.abs(p[:, :2] / p[:, 2:] - q[:, :2] / q[:, 2:]).max() < 1.0
    # boxes in reference coordinates
    bt, bj = t.transform_cur_boxes(), j.transform_cur_boxes()
    assert bt.shape == (2, 4) and bt.dtype == np.float32
    np.testing.assert_allclose(bt, bj, atol=BOX_TOL)


def test_stabilizer_fails_without_matches(pair):
    """Fewer than 4 matches: no homography, no boxes, zero inliers."""
    ref, _, _, _ = pair
    flat = np.full_like(ref, 128)
    t = Stabilizer(**CONFIGS["orb"], device="cpu")
    t.set_ref_frame(ref)
    t.stabilize(flat, pair[3])
    assert t.get_cur_trans_matrix() is None and t.transform_cur_boxes() is None
    assert t.get_cur_inliers_count() == 0 and t.get_cur_num_matches() < 4
    with pytest.raises(RuntimeError):
        Stabilizer(device="cpu").stabilize(ref)
