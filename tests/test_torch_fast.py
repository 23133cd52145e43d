"""FAST corner score of the port: the plain PyTorch version against the JAX
package's three forms (roll reference, XLA twin, Pallas kernel in interpret
mode), bit for bit. The CUDA kernel against the plain version on the card
is in test_torch_gpu.py."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from geotrax_tpu.ops import features as jfeatures
from geotrax_tpu.ops import pallas_fast
from geotrax_tpu_torch.ops import fast


def textured_gray(h, w, seed):
    """Aerial-like texture (noise + blocks + lines), as float32 gray."""
    rng = np.random.default_rng(seed)
    img = rng.integers(40, 90, (h, w)).astype(np.float32)
    for _ in range(max(4, h * w // 2000)):
        y, x = rng.integers(0, max(h - 6, 1)), rng.integers(0, max(w - 6, 1))
        bh, bw = rng.integers(2, 16, 2)
        img[y:y + bh, x:x + bw] = rng.integers(120, 255)
    for _ in range(4):
        y = rng.integers(0, h)
        img[y:y + 2, :] = 200
    return img


@pytest.mark.parametrize("shape,seed", [((300, 420), 0), ((37, 53), 5)])
@pytest.mark.parametrize("threshold", [20.0, 7.0])
def test_fast_plain_equals_jax_forms(shape, seed, threshold):
    gray = textured_gray(*shape, seed)
    ours = fast.fast_score_map_torch(torch.from_numpy(gray), threshold).numpy()
    ref = np.asarray(pallas_fast.fast_score_map_reference(jnp.asarray(gray), threshold))
    xla = np.asarray(jfeatures.fast_score_map_xla(jnp.asarray(gray), threshold))
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours, xla)
    assert (ours > 0).sum() > 10  # the image has corners to compare


@pytest.mark.parametrize("threshold", [20.0, 7.0])
def test_fast_plain_equals_pallas_interpret(threshold):
    gray = textured_gray(37, 53, 5)
    ours = fast.fast_score_map_torch(torch.from_numpy(gray), threshold).numpy()
    pallas = np.asarray(pallas_fast.fast_score_map(jnp.asarray(gray), threshold, interpret=True))
    np.testing.assert_array_equal(ours, pallas)


def test_fast_batched_equals_per_image():
    batch = np.stack([textured_gray(64, 96, s) for s in range(3)])
    ours = fast.fast_score_map(torch.from_numpy(batch), 20.0).numpy()
    for i in range(3):
        xla = np.asarray(jfeatures.fast_score_map_xla(jnp.asarray(batch[i]), 20.0))
        np.testing.assert_array_equal(ours[i], xla)


def test_wrapper_uses_plain_version_on_cpu():
    before = fast.fast_score_map.launches
    gray = torch.from_numpy(textured_gray(40, 60, 1))
    out = fast.fast_score_map(gray, 20.0)
    assert out.device.type == "cpu"
    assert fast.fast_score_map.launches == before  # no kernel launch on the CPU
    np.testing.assert_array_equal(out.numpy(), fast.fast_score_map_torch(gray, 20.0).numpy())


def test_kernel_source_names_the_tpu_kernel():
    src = (fast._cuda.CSRC / "fast_score.cu").read_text()
    assert "pallas_fast.py:_make_kernel" in src
    assert 'extern "C" int fast_score(' in src
