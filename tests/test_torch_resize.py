"""cv2-exact uint8 resize of the port against the JAX package's
``resize_u8_linear``: bit-exact on the exact-half path and the fixed-point
path, for single images and batches."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from geotrax_tpu.ops.resize import resize_u8_linear as jax_resize
from geotrax_tpu_torch.ops.resize import resize_u8_linear


@pytest.mark.parametrize("src,dst", [
    ((216, 384), (108, 192)),   # exact half (the 4K -> 1920 case, scaled down)
    ((200, 300), (113, 170)),   # general fixed-point path, downscale
    ((37, 53), (61, 80)),       # upscale, odd sizes
    ((120, 160), (120, 96)),    # one axis only
])
def test_resize_bit_exact(src, dst):
    rng = np.random.default_rng(sum(src) + sum(dst))
    img = rng.integers(0, 256, src + (3,), dtype=np.uint8)
    ours = resize_u8_linear(torch.from_numpy(img), *dst).numpy()
    ref = np.asarray(jax_resize(jnp.asarray(img), *dst))
    assert ours.dtype == np.uint8 and ours.shape == dst + (3,)
    np.testing.assert_array_equal(ours, ref)


def test_resize_gray_and_batch():
    rng = np.random.default_rng(7)
    gray = rng.integers(0, 256, (64, 90), dtype=np.uint8)
    np.testing.assert_array_equal(
        resize_u8_linear(torch.from_numpy(gray), 32, 45).numpy(),
        np.asarray(jax_resize(jnp.asarray(gray), 32, 45)),
    )
    batch = rng.integers(0, 256, (3, 50, 70, 3), dtype=np.uint8)
    for dst in [(25, 35), (31, 44)]:
        ours = resize_u8_linear(torch.from_numpy(batch), *dst).numpy()
        for i in range(3):
            np.testing.assert_array_equal(ours[i], np.asarray(jax_resize(jnp.asarray(batch[i]), *dst)))
