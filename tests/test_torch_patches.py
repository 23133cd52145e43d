"""The port's patch gathers against the JAX package: ``patches32_torch`` (the
plain version of ``csrc/patch_gather.cu``'s float gather) equals
``features.patches32`` (the XLA gather in CLIP mode) exactly, on corners that
are already clipped and on corners anywhere (out of range, at every edge),
and equals the Pallas kernel ``pallas_patches.extract_patches`` in interpret
mode on clipped corners (the only corners that kernel takes);
``patches32_hwc_torch`` (the plain version of its uint8 HWC entry) equals the
reference embedding's route (2x2 pool, a ``patches32`` per channel, the 4x4
means) exactly in all four modes."""

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


def _image(c, h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (c, h, w, 3)).astype(np.uint8)


def _jax_hwc(image, x0, y0, pool2, mean4):
    """The reference's route (geotrax_tpu/pipeline/device_pipeline.py:
    embed_boxes): the 2x2-pooled frames or the image as float32, one
    ``jax.vmap(patches32)`` per channel, then its reshape-mean; stacked as
    (C,M,3,...)."""
    img = jnp.asarray(image)
    if pool2:
        h2, w2 = image.shape[1] // 2, image.shape[2] // 2
        f = img[:, :h2 * 2, :w2 * 2].astype(jnp.float32)
        pooled = 0.25 * (f[:, 0::2, 0::2] + f[:, 0::2, 1::2] + f[:, 1::2, 0::2] + f[:, 1::2, 1::2])
    else:
        pooled = img.astype(jnp.float32)
    chans = [jax.vmap(jax_patches32)(pooled[..., ch], jnp.asarray(x0), jnp.asarray(y0))
             for ch in range(3)]
    if mean4:
        chans = [p.reshape(p.shape[:2] + (8, 4, 8, 4)).mean(axis=(3, 5)) for p in chans]
    return np.asarray(jnp.stack(chans, axis=2))


# (C,H,W) and M; odd H and W (the 2x2 pool trims them), an image exactly one
# (pooled) patch large, and M=0
HWC_CASES = [((2, 75, 107), 9), ((3, 97, 131), 17), ((1, 64, 64), 5), ((2, 70, 96), 0)]


@pytest.mark.parametrize("pool2", [False, True])
@pytest.mark.parametrize("mean4", [False, True])
@pytest.mark.parametrize("shape,m", HWC_CASES)
def test_hwc_plain_equals_reference_route(shape, m, pool2, mean4):
    image = _image(*shape, seed=sum(shape) + m)
    f = 2 if pool2 else 1
    hp, wp = shape[1] // f, shape[2] // f
    anywhere = [a[:, :m] for a in _anywhere(shape[0], hp, wp, max(m, 8), seed=m)]
    for x0, y0 in (_clipped(shape[0], hp, wp, m, seed=m), anywhere):
        ours = patches.patches32_hwc_torch(torch.from_numpy(image), torch.from_numpy(x0),
                                           torch.from_numpy(y0), pool2, mean4).numpy()
        assert ours.shape == (shape[0], m, 3) + ((8, 8) if mean4 else (32, 32))
        np.testing.assert_array_equal(ours, _jax_hwc(image, x0, y0, pool2, mean4))


def test_hwc_wrapper_on_cpu_runs_the_plain_version_and_checks_its_inputs():
    image = torch.from_numpy(_image(2, 70, 96, seed=3))
    x0, y0 = (torch.from_numpy(a) for a in _anywhere(2, 35, 48, 10, seed=3))
    before = patches.patches32.launches
    got = patches.patches32_hwc(image, x0, y0, True, False)
    assert patches.patches32.launches == before  # no kernel on the CPU
    np.testing.assert_array_equal(got.numpy(), patches.patches32_hwc_torch(image, x0, y0, True,
                                                                           False).numpy())
    with pytest.raises(TypeError):  # the image is never widened to float32 first
        patches.patches32_hwc(image.float(), x0, y0, True, False)
    with pytest.raises(TypeError):
        patches.patches32_hwc(image, x0.float(), y0.float(), True, False)
    with pytest.raises(ValueError):  # (C,H,W,3) only
        patches.patches32_hwc(image[..., :2], x0, y0, True, False)
    with pytest.raises(ValueError):  # (C,M) corners for C images
        patches.patches32_hwc(image, x0[:1], y0[:1], True, False)
    with pytest.raises(ValueError):  # 35 pooled rows hold a patch, 31 do not
        patches.patches32_hwc(image[:, :62], x0, y0, True, False)
