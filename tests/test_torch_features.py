"""Features of the port against the JAX package: gray, downsample, vehicle
mask and FAST keypoints exact; grid descriptors within the stated
tolerance; L2 matching indices and validity exact. The ORB-style library:
oriented FAST's keypoints exact and its angles within ANGLE_TOL;
``describe``'s three routes bit for bit given the same keypoints and
angles; the pyramid exact on textured frames and sharing PYRAMID_OVERLAP
of its keypoints on tie-heavy ones (its deeper levels are resize products
that add in another order: 3e-3 grey levels at level 3);
``match_descriptors`` exact; the pyramid with matching and RANSAC recovers
a 1.6x zoom within 4 px."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from geotrax_tpu.ops import features as jf
from geotrax_tpu.ops import sift as jsift
from geotrax_tpu_torch.ops import features as tf
from geotrax_tpu_torch.ops import sift as tsift

torch.set_num_threads(1)

# describe_grid tolerance: the blur planes are bf16 in both packages and
# round at the same operations, so the planes agree exactly; what remains is
# the float32 order of the mean and norm reductions over 16 / 64 values.
DESC_ATOL = 1e-5
# the orientation's two 961-term float32 sums add in another order than
# XLA's (3.5e-7 rad measured at most)
ANGLE_TOL = 1e-5
# the pyramid's deeper levels differ by up to 3e-3 grey levels, its angles
# there by up to 2.9e-5 rad
PYRAMID_ANGLE_TOL = 1e-4
PYRAMID_OVERLAP = 0.98


def blocky_rgb(h, w, seed, levels=4):
    """Few-level blocky texture: many equal FAST scores (tie-heavy)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, levels, (h // 4, w // 4)) * (255 // (levels - 1))
    img = np.kron(base, np.ones((4, 4))).astype(np.uint8)
    return np.stack([img, img, img], axis=-1)


def textured_rgb(h, w, seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(40, 90, (h, w)).astype(np.float32)
    for _ in range(60):
        y, x = rng.integers(10, h - 20), rng.integers(10, w - 20)
        bh, bw = rng.integers(4, 16, 2)
        img[y:y + bh, x:x + bw] = rng.integers(120, 255)
    for _ in range(8):
        y = rng.integers(0, h)
        img[y:y + 2, :] = 200
    return np.clip(np.stack([img, img, img], axis=-1), 0, 255).astype(np.uint8)


def test_gray_and_downsample_exact():
    rgb = textured_rgb(120, 160, 0)
    jg = jf.rgb_to_gray(jnp.asarray(rgb))
    tg = tf.rgb_to_gray(torch.from_numpy(rgb))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(tf.downsample(tg, 0.5).numpy(), np.asarray(jf.downsample(jg, 0.5)))
    np.testing.assert_array_equal(tf.downsample(tg, 1.0).numpy(), np.asarray(jg))


def test_downsample_general_ratio():
    g = np.random.default_rng(1).uniform(0, 255, (60, 90)).astype(np.float32)
    ref = np.asarray(jf.downsample(jnp.asarray(g), 0.4))
    ours = tf.downsample(torch.from_numpy(g), 0.4).numpy()
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-3)


def test_boxes_mask_exact():
    boxes = np.array([[40, 30, 20, 10], [100, 80, 30, 16], [0, 0, 0, 0], [150, 5, 40, 30]],
                     np.float32)
    ref = np.asarray(jf.boxes_mask((120, 160), jnp.asarray(boxes), 0.15))
    ours = tf.boxes_mask((120, 160), torch.from_numpy(boxes), 0.15).numpy()
    np.testing.assert_array_equal(ours, ref)
    batch = tf.boxes_mask((120, 160), torch.from_numpy(np.stack([boxes, boxes[::-1]])), 0.15)
    np.testing.assert_array_equal(batch[1].numpy(), ref)


@pytest.mark.parametrize("maker,seed,k", [(blocky_rgb, 2, 600), (textured_rgb, 3, 2000)])
def test_fast_detect_exact(maker, seed, k):
    rgb = maker(120, 160, seed)
    gray = np.array(jf.rgb_to_gray(jnp.asarray(rgb)))
    boxes = np.array([[60, 50, 30, 20], [120, 90, 20, 20]], np.float32)
    mask = np.array(jf.boxes_mask(gray.shape, jnp.asarray(boxes), 0.15))
    ref = jf.fast_detect(jnp.asarray(gray), k, mask=jnp.asarray(mask), oriented=False)
    ours = tf.fast_detect(torch.from_numpy(gray), k, mask=torch.from_numpy(mask), oriented=False)
    np.testing.assert_array_equal(ours.xy.numpy(), np.asarray(ref.xy))
    np.testing.assert_array_equal(ours.score.numpy(), np.asarray(ref.score))
    np.testing.assert_array_equal(ours.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(ours.angle.numpy(), np.asarray(ref.angle))
    assert 0 < int(ours.valid.sum()) < k  # zero-score ties fill the tail


def test_fast_detect_batched_equals_single():
    grays = np.stack([np.array(jf.rgb_to_gray(jnp.asarray(textured_rgb(96, 128, s))))
                      for s in range(3)])
    batch = tf.fast_detect(torch.from_numpy(grays), 200, oriented=False)
    for i in range(3):
        one = tf.fast_detect(torch.from_numpy(grays[i]), 200, oriented=False)
        np.testing.assert_array_equal(batch.xy[i].numpy(), one.xy.numpy())


def _keypoints(gray, k):
    kps = jf.fast_detect(jnp.asarray(gray), k, oriented=False)
    return kps, tf.Keypoints(*(torch.from_numpy(np.array(a)) for a in kps))


def test_describe_grid_within_tolerance():
    gray = np.array(jf.rgb_to_gray(jnp.asarray(textured_rgb(120, 160, 4))))
    jk, tk = _keypoints(gray, 300)
    ref = np.asarray(jf.describe_grid(jnp.asarray(gray), jk))
    ours = tf.describe_grid(torch.from_numpy(gray), tk).numpy()
    assert ours.shape == (300, tf.GRID_DESC_DIM)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=DESC_ATOL)
    # the bf16 blur itself is exact
    np.testing.assert_array_equal(
        tf._gaussian_blur_bf16(torch.from_numpy(gray)).float().numpy(),
        np.asarray(jf._gaussian_blur_bf16(jnp.asarray(gray)).astype(jnp.float32)),
    )


def test_match_l2_exact():
    rng = np.random.default_rng(6)
    gray = np.array(jf.rgb_to_gray(jnp.asarray(textured_rgb(120, 160, 5))))
    shifted = np.roll(gray, (2, 3), axis=(0, 1)) + rng.normal(0, 2, gray.shape).astype(np.float32)
    ka, ta = _keypoints(shifted, 300)
    kb, tb = _keypoints(gray, 500)
    da = jf.describe_grid(jnp.asarray(shifted), ka)
    db = jf.describe_grid(jnp.asarray(gray), kb)
    for ratio in (0.9, 0.55):
        ref = jsift.match_l2(da, ka.valid, db, kb.valid, ratio=ratio)
        ours = tsift.match_l2(torch.from_numpy(np.array(da)), ta.valid, torch.from_numpy(np.array(db)),
                              tb.valid, ratio=ratio)
        np.testing.assert_array_equal(ours.idx_b.numpy(), np.asarray(ref.idx_b))
        np.testing.assert_array_equal(ours.valid.numpy(), np.asarray(ref.valid))
        assert int(ours.valid.sum()) > 20
    # blockwise == one block, and a batch of A sets against one B set
    small = tsift.match_l2(torch.from_numpy(np.array(da)), ta.valid, torch.from_numpy(np.array(db)),
                           tb.valid, ratio=0.9, block=64)
    full = tsift.match_l2(torch.from_numpy(np.array(da)), ta.valid, torch.from_numpy(np.array(db)),
                          tb.valid, ratio=0.9)
    np.testing.assert_array_equal(small.valid.numpy(), full.valid.numpy())
    np.testing.assert_array_equal(small.idx_b.numpy(), full.idx_b.numpy())
    batched = tsift.match_l2(torch.from_numpy(np.stack([np.array(da)] * 2)), ta.valid.expand(2, -1),
                             torch.from_numpy(np.array(db)), tb.valid, ratio=0.9)
    np.testing.assert_array_equal(batched.idx_b[1].numpy(), full.idx_b.numpy())
    np.testing.assert_array_equal(batched.valid[1].numpy(), full.valid.numpy())


# ---------------------------------------------------------------------------
# the ORB-style library
# ---------------------------------------------------------------------------

def wrapped_diff(a, b):
    return np.abs(np.remainder(a - b + np.pi, 2 * np.pi) - np.pi)


def jax_kps_to_torch(kps):
    return tf.Keypoints(*(torch.from_numpy(np.array(a)) for a in kps))


@pytest.mark.parametrize("maker,seed,k", [(blocky_rgb, 2, 600), (textured_rgb, 3, 800)])
def test_fast_detect_oriented(maker, seed, k):
    gray = np.array(jf.rgb_to_gray(jnp.asarray(maker(160, 240, seed))))
    mask = np.ones(gray.shape, bool)
    mask[50:90, 100:160] = False
    ref = jf.fast_detect(jnp.asarray(gray), k, mask=jnp.asarray(mask))
    ours = tf.fast_detect(torch.from_numpy(gray), k, mask=torch.from_numpy(mask))
    for name in ("xy", "score", "valid"):
        np.testing.assert_array_equal(getattr(ours, name).numpy(), np.asarray(getattr(ref, name)))
    assert wrapped_diff(ours.angle.numpy(), np.asarray(ref.angle)).max() <= ANGLE_TOL
    assert np.abs(ours.angle.numpy()).max() > 1.0  # oriented by default
    # a batch equals its frames one by one
    batch = tf.fast_detect(torch.from_numpy(np.stack([gray, gray[::-1].copy()])), k,
                           mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(batch.xy[0].numpy(), ours.xy.numpy())
    # the batch's moment sums add in another order too
    assert wrapped_diff(batch.angle[0].numpy(), ours.angle.numpy()).max() <= ANGLE_TOL


@pytest.mark.parametrize("oriented,method", [(True, "patches"), (False, "patches"),
                                             (False, "planes")])
def test_describe_routes_bit_exact(oriented, method):
    gray = np.array(jf.rgb_to_gray(jnp.asarray(textured_rgb(160, 240, 8))))
    jk = jf.fast_detect(jnp.asarray(gray), 500)
    ref = np.asarray(jf.describe(jnp.asarray(gray), jk, oriented=oriented, method=method))
    ours = tf.describe(torch.from_numpy(gray), jax_kps_to_torch(jk), oriented=oriented,
                       method=method).numpy()
    assert ours.shape == (500, 256) and ours.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)
    if not oriented:  # the unoriented routes are the oriented one at angle 0
        zero = jax_kps_to_torch(jk)._replace(angle=torch.zeros(500))
        np.testing.assert_array_equal(ours, tf.describe(torch.from_numpy(gray), zero).numpy())


@pytest.mark.parametrize("maker,seed", [(textured_rgb, 4), (blocky_rgb, 2)])
def test_pyramid(maker, seed):
    gray = np.array(jf.rgb_to_gray(jnp.asarray(maker(240, 320, seed))))
    mask = np.ones(gray.shape, bool)
    mask[100:150, 60:140] = False
    ref_k, ref_d = jf.detect_and_describe_pyramid(jnp.asarray(gray), 1000, mask=jnp.asarray(mask))
    kps, desc = tf.detect_and_describe_pyramid(torch.from_numpy(gray), 1000,
                                               mask=torch.from_numpy(mask))
    assert kps.xy.shape == (1000, 2) and desc.shape == (1000, 256)
    if maker is textured_rgb:
        np.testing.assert_array_equal(kps.xy.numpy(), np.asarray(ref_k.xy))
        np.testing.assert_array_equal(desc.numpy(), np.asarray(ref_d))
        assert wrapped_diff(kps.angle.numpy(), np.asarray(ref_k.angle)).max() <= PYRAMID_ANGLE_TOL
    theirs = {tuple(v) for v in np.round(np.asarray(ref_k.xy), 3).tolist()}
    shared = np.mean([tuple(v) in theirs for v in np.round(kps.xy.numpy(), 3).tolist()])
    assert shared >= PYRAMID_OVERLAP, shared
    # level 0 is fast_detect on the frame itself, exact
    lv0 = tf.fast_detect(torch.from_numpy(gray), 250, mask=torch.from_numpy(mask))
    ref0 = jf.fast_detect(jnp.asarray(gray), 250, mask=jnp.asarray(mask))
    np.testing.assert_array_equal(lv0.xy.numpy(), np.asarray(ref0.xy))


def test_match_descriptors_exact():
    rng = np.random.default_rng(7)
    gray = np.array(jf.rgb_to_gray(jnp.asarray(textured_rgb(160, 240, 9))))
    noisy = np.roll(gray, (3, -2), axis=(0, 1)) + rng.normal(0, 3, gray.shape).astype(np.float32)
    ka, da = jf.detect_and_describe_pyramid(jnp.asarray(gray), 600, n_levels=2)
    kb, db = jf.detect_and_describe_pyramid(jnp.asarray(noisy), 700, n_levels=2)
    for ratio in (0.9, 0.7):
        ref = jf.match_descriptors(da, ka.valid, db, kb.valid, ratio=ratio)
        ours = tf.match_descriptors(torch.from_numpy(np.array(da)), torch.from_numpy(
            np.array(ka.valid)), torch.from_numpy(np.array(db)), torch.from_numpy(
            np.array(kb.valid)), ratio=ratio)
        np.testing.assert_array_equal(ours.idx_a.numpy(), np.asarray(ref.idx_a))
        np.testing.assert_array_equal(ours.idx_b.numpy(), np.asarray(ref.idx_b))
        np.testing.assert_array_equal(ours.valid.numpy(), np.asarray(ref.valid))
        assert int(ours.valid.sum()) > 50


def test_pyramid_match_ransac_recovers_a_zoom():
    """The master -> ortho situation at a small size: a 1.6x zoom about the
    centre recovered within 4 px at four interior corners
    (tests/test_features_stabilize.py's check)."""
    from geotrax_tpu_torch.ops import prng
    from geotrax_tpu_torch.ops.ransac import ransac_fit
    from geotrax_tpu_torch.ops.warp import invert_homography, warp_perspective

    h, w = 240, 320
    gray = tf.rgb_to_gray(torch.from_numpy(textured_rgb(h, w, 21)))
    h_true = np.array([[1.6, 0, -0.6 * w / 2], [0, 1.6, -0.6 * h / 2], [0, 0, 1.0]])
    zoomed = warp_perspective(gray[..., None], invert_homography(h_true), h, w)[..., 0]
    ka, da = tf.detect_and_describe_pyramid(gray, 2000)
    kb, db = tf.detect_and_describe_pyramid(zoomed.contiguous(), 2000)
    m = tf.match_descriptors(da, ka.valid, db, kb.valid)
    r = ransac_fit(ka.xy[m.idx_a], kb.xy[m.idx_b], m.valid, threshold=3.0,
                   key=prng.PRNGKey(0), num_hypotheses=1024)
    corners = np.array([[0.35 * w, 0.35 * h, 1], [0.65 * w, 0.35 * h, 1],
                        [0.65 * w, 0.65 * h, 1], [0.35 * w, 0.65 * h, 1]])
    p, q = corners @ r.h_matrix.double().numpy().T, corners @ h_true.T
    err = np.linalg.norm(p[:, :2] / p[:, 2:] - q[:, :2] / q[:, 2:], axis=1).max()
    assert err < 4.0 and int(r.num_inliers) >= 20, (err, int(r.num_inliers))
