"""CLAHE (geotrax_tpu_torch/ops/clahe.py) against the reference's
geotrax_tpu/ops/clahe.py on seeded grays: sizes that are tile multiples and
sizes that are not (symmetric padding), uint8 and float input, other grids
and clip limits, and a batch against the reference frame by frame. The
histograms and their clipping count exactly; the CDF is summed in XLA's
order; the bilinear blend is float32, so the outputs agree within
CLAHE_ATOL grey levels (one float32 step at 255 is 3e-5)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from geotrax_tpu.ops.clahe import clahe as jax_clahe
from geotrax_tpu_torch.ops.clahe import clahe

CLAHE_ATOL = 1e-4


def seeded_gray(shape, seed):
    """Low-contrast aerial-like gray: a dim half, blocks and noise."""
    rng = np.random.default_rng(seed)
    g = rng.uniform(60, 120, shape).astype(np.float32)
    g[: shape[0] // 2] = g[: shape[0] // 2] * 0.3 + 40
    for _ in range(6):
        y, x = rng.integers(0, shape[0] - 4), rng.integers(0, shape[1] - 4)
        g[y:y + 6, x:x + 9] = rng.uniform(150, 255)
    return g


@pytest.mark.parametrize("shape", [(64, 64), (120, 160), (37, 53), (97, 131), (240, 320)])
def test_clahe_equals_the_references(shape):
    g = seeded_gray(shape, sum(shape))
    want = np.asarray(jax_clahe(jnp.asarray(g)))
    got = clahe(torch.from_numpy(g)).numpy()
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_allclose(got, want, rtol=0, atol=CLAHE_ATOL)
    assert np.abs(got - g).max() > 10  # it equalizes


@pytest.mark.parametrize("tiles,clip", [(4, 2.0), (8, 4.0), (2, 1.0)])
def test_clahe_grids_and_limits(tiles, clip):
    g = np.random.default_rng(tiles).integers(0, 256, (90, 130)).astype(np.uint8)
    want = np.asarray(jax_clahe(jnp.asarray(g), tiles=tiles, clip_limit=clip))
    got = clahe(torch.from_numpy(g), tiles=tiles, clip_limit=clip).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=CLAHE_ATOL)


def test_clahe_batch_equals_each_frame():
    frames = np.stack([seeded_gray((50, 70), s) for s in range(3)])
    got = clahe(torch.from_numpy(frames)).numpy()
    for f, g in zip(got, frames):
        np.testing.assert_allclose(f, np.asarray(jax_clahe(jnp.asarray(g))), rtol=0, atol=CLAHE_ATOL)
    np.testing.assert_array_equal(got[1], clahe(torch.from_numpy(frames[1])).numpy())
