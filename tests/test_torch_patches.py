"""The port's patch gather against the JAX package: ``patches32_torch`` (the
plain version of ``csrc/patch_gather.cu``) equals ``features.patches32``
(the XLA gather in CLIP mode) exactly, on corners that are already clipped
and on corners anywhere (out of range, at every edge), and equals the Pallas
kernel ``pallas_patches.extract_patches`` in interpret mode on clipped
corners (the only corners that kernel takes)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geotrax_tpu.ops.features import patches32 as jax_patches32
from geotrax_tpu.ops.pallas_patches import extract_patches
from geotrax_tpu_torch.ops import patches


def _planes(b, h, w, seed):
    return np.random.default_rng(seed).uniform(0, 255, (b, h, w)).astype(np.float32)


def _clipped(b, h, w, k, seed):
    rng = np.random.default_rng(seed + 100)
    x0 = rng.integers(0, w - 32 + 1, (b, k)).astype(np.int32)
    y0 = rng.integers(0, h - 32 + 1, (b, k)).astype(np.int32)
    return x0, y0


def _anywhere(b, h, w, k, seed):
    """Corners out of range on every side, exactly at every edge, and inside."""
    rng = np.random.default_rng(seed + 200)
    x0 = rng.integers(-80, w + 80, (b, k)).astype(np.int32)
    y0 = rng.integers(-80, h + 80, (b, k)).astype(np.int32)
    edges_x = np.array([0, w - 32, -1, w - 31, 0, w - 32, -(2 ** 20), 2 ** 20], np.int32)
    edges_y = np.array([0, h - 32, h - 31, -1, h - 32, 0, 2 ** 20, -(2 ** 20)], np.int32)
    x0[:, :8], y0[:, :8] = edges_x, edges_y
    return x0, y0


def _jax_batched(planes, x0, y0):
    return np.asarray(jax.vmap(jax_patches32)(jnp.asarray(planes), jnp.asarray(x0), jnp.asarray(y0)))


SHAPES = [((1, 64, 96), 7), ((3, 160, 384), 130), ((2, 37, 53), 20), ((1, 32, 32), 5),
          ((2, 33, 65), 129)]


@pytest.mark.parametrize("shape,k", SHAPES)
def test_plain_equals_xla_gather_on_clipped_corners(shape, k):
    planes = _planes(*shape, seed=k)
    x0, y0 = _clipped(*shape, k, seed=k)
    ours = patches.patches32_torch(torch.from_numpy(planes), torch.from_numpy(x0),
                                   torch.from_numpy(y0)).numpy()
    assert ours.shape == (shape[0], k, 32, 32)
    np.testing.assert_array_equal(ours, _jax_batched(planes, x0, y0))


@pytest.mark.parametrize("shape,k", SHAPES)
def test_plain_equals_xla_gather_clip_mode(shape, k):
    planes = _planes(*shape, seed=k + 1)
    x0, y0 = _anywhere(*shape, max(k, 8), seed=k)
    ours = patches.patches32_torch(torch.from_numpy(planes), torch.from_numpy(x0),
                                   torch.from_numpy(y0)).numpy()
    np.testing.assert_array_equal(ours, _jax_batched(planes, x0, y0))


@pytest.mark.parametrize("shape,k", [((1, 64, 96), 7), ((3, 160, 384), 130), ((1, 37, 53), 20)])
def test_plain_equals_pallas_kernel_interpret(shape, k):
    planes = _planes(*shape, seed=k + 2)
    x0, y0 = _clipped(*shape, k, seed=k + 3)
    ours = patches.patches32_torch(torch.from_numpy(planes), torch.from_numpy(x0),
                                   torch.from_numpy(y0)).numpy()
    for b in range(shape[0]):
        ref = np.asarray(extract_patches(jnp.asarray(planes[b]), jnp.asarray(x0[b]),
                                         jnp.asarray(y0[b]), interpret=True))
        np.testing.assert_array_equal(ours[b], ref)


def test_wrapper_on_cpu_runs_the_plain_version_and_takes_one_plane():
    planes = _planes(2, 40, 70, seed=9)
    x0, y0 = _anywhere(2, 40, 70, 12, seed=9)
    before = patches.patches32.launches
    batched = patches.patches32(torch.from_numpy(planes), torch.from_numpy(x0), torch.from_numpy(y0))
    one = patches.patches32(torch.from_numpy(planes[1]), torch.from_numpy(x0[1]),
                            torch.from_numpy(y0[1]))
    assert patches.patches32.launches == before  # no kernel on the CPU
    np.testing.assert_array_equal(one.numpy(), batched[1].numpy())
    np.testing.assert_array_equal(one.numpy(), np.asarray(jax_patches32(
        jnp.asarray(planes[1]), jnp.asarray(x0[1]), jnp.asarray(y0[1]))))


def test_plain_version_rejects_what_the_gather_cannot_take():
    with pytest.raises(ValueError):
        patches.patches32_torch(torch.zeros(2, 31, 64), torch.zeros(2, 3, dtype=torch.int32),
                                torch.zeros(2, 3, dtype=torch.int32))
    with pytest.raises(ValueError):
        patches.patches32_torch(torch.zeros(2, 40, 64), torch.zeros(3, 3, dtype=torch.int32),
                                torch.zeros(3, 3, dtype=torch.int32))
    with pytest.raises(TypeError):
        patches.patches32(torch.zeros(2, 40, 64), torch.zeros(2, 3), torch.zeros(2, 3))


def test_a_failing_build_raises(tmp_path, monkeypatch):
    """A compiler that fails makes the build raise with its log; nothing is
    loaded and nothing falls back."""
    from geotrax_tpu_torch import _cuda

    (tmp_path / "patch_gather.cu").write_text("this is not CUDA C++\n")
    monkeypatch.setattr(_cuda, "CSRC", tmp_path)
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_cuda, "nvcc_path", lambda: "false")  # a compiler that always fails
    with pytest.raises(RuntimeError, match="nvcc failed for patch_gather.cu"):
        _cuda.build("patch_gather")
    assert not list((tmp_path / "build").glob("*.so"))
