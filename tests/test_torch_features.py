"""Stabilization features of the port against the JAX package: gray,
downsample, vehicle mask and FAST keypoints exact; grid descriptors within
the stated tolerance; L2 matching indices and validity exact."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from geotrax_tpu.ops import features as jf
from geotrax_tpu.ops import sift as jsift
from geotrax_tpu_torch.ops import features as tf
from geotrax_tpu_torch.ops import sift as tsift

# describe_grid tolerance: the blur planes are bf16 in both packages and
# round at the same operations, so the planes agree exactly; what remains is
# the float32 order of the mean and norm reductions over 16 / 64 values.
DESC_ATOL = 1e-5


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
    ours = tf.fast_detect(torch.from_numpy(gray), k, mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(ours.xy.numpy(), np.asarray(ref.xy))
    np.testing.assert_array_equal(ours.score.numpy(), np.asarray(ref.score))
    np.testing.assert_array_equal(ours.valid.numpy(), np.asarray(ref.valid))
    assert 0 < int(ours.valid.sum()) < k  # zero-score ties fill the tail


def test_fast_detect_batched_equals_single():
    grays = np.stack([np.array(jf.rgb_to_gray(jnp.asarray(textured_rgb(96, 128, s))))
                      for s in range(3)])
    batch = tf.fast_detect(torch.from_numpy(grays), 200)
    for i in range(3):
        one = tf.fast_detect(torch.from_numpy(grays[i]), 200)
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
