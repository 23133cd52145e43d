"""The port's appearance embedding against the JAX package: ``embed_boxes``
(projection path, with and without a shared half-resolution image, and with
a learned head), what it hands its uint8 gather, ``_emb_projection``, and
the ReID head of track/reid.py read from the reference's own checkpoint
format. Embeddings agree within 1e-5 (projection) and 1e-4 (conv head:
float32 convolutions summed in another order)."""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geotrax_tpu.pipeline import device_pipeline as jdp
from geotrax_tpu.track import reid as jreid
from geotrax_tpu_torch.ops.patches import patches32_hwc
from geotrax_tpu_torch.pipeline import device_pipeline as tdp
from geotrax_tpu_torch.track import reid as treid

EMB_ATOL = 1e-5
HEAD_ATOL = 1e-4


def _frames_and_boxes(c, h, w, m, seed):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (c, h, w, 3)).astype(np.uint8)
    # blocks of colour, so that patches differ from plain noise
    for i in range(c):
        for _ in range(6):
            y, x = rng.integers(0, h - 20), rng.integers(0, w - 20)
            frames[i, y:y + 20, x:x + 20] = rng.integers(0, 256, 3)
    boxes = np.column_stack([rng.uniform(-30, w + 30, c * m), rng.uniform(-30, h + 30, c * m),
                             rng.uniform(8, 60, c * m), rng.uniform(8, 60, c * m)])
    boxes = boxes.reshape(c, m, 4).astype(np.float32)
    boxes[:, 0] = 0.0  # padded detections: zero boxes clip to the corner patch
    boxes[:, 1, :2] = (w - 1.0, h - 1.0)
    return frames, boxes


@pytest.mark.parametrize("c,h,w,m", [(2, 96, 128, 9), (3, 97, 131, 17), (1, 64, 64, 4)])
def test_embed_boxes_matches_jax(c, h, w, m):
    frames, boxes = _frames_and_boxes(c, h, w, m, seed=h + w)
    ref = np.asarray(jdp.embed_boxes(jnp.asarray(frames), jnp.asarray(boxes)))
    ours = tdp.embed_boxes(torch.from_numpy(frames), torch.from_numpy(boxes)).numpy()
    assert ours.shape == (c, m, 64)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=EMB_ATOL)
    np.testing.assert_allclose(np.linalg.norm(ours, axis=-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("c,h,w,m", [(2, 96, 128, 9), (2, 120, 180, 13)])
def test_embed_boxes_with_pooled_matches_jax(c, h, w, m):
    frames, boxes = _frames_and_boxes(c, h, w, m, seed=7)
    pooled = np.random.default_rng(8).integers(0, 256, (c, h // 2, w // 2, 3)).astype(np.uint8)
    ref = np.asarray(jdp.embed_boxes(jnp.asarray(frames), jnp.asarray(boxes),
                                     pooled=jnp.asarray(pooled)))
    ours = tdp.embed_boxes(torch.from_numpy(frames), torch.from_numpy(boxes),
                           pooled=torch.from_numpy(pooled)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=EMB_ATOL)
    # the pooled image is what is read: another one changes the embeddings
    plain = tdp.embed_boxes(torch.from_numpy(frames), torch.from_numpy(boxes)).numpy()
    assert np.abs(plain - ours).max() > 1e-2


def test_emb_projection_matches_jax():
    for din, dout in ((192, 64), (64, 32)):
        np.testing.assert_allclose(tdp._emb_projection(din, dout), jdp._emb_projection(din, dout),
                                   rtol=0, atol=1e-7)


@pytest.fixture(scope="module")
def jax_head_file(tmp_path_factory):
    params = jreid.init_head(jax.random.PRNGKey(3))
    path = tmp_path_factory.mktemp("reid") / "head.npz"
    jreid.save_head(path, params)
    return params, path


def test_head_saved_by_jax_embeds_alike(jax_head_file):
    params, path = jax_head_file
    ours = treid.load_head(path)
    assert ours is not None and ours["conv0_w"].shape == (16, 3, 3, 3)
    patches = np.random.default_rng(0).uniform(0, 255, (6, 32, 32, 3)).astype(np.float32)
    ref = np.asarray(jreid.embed_patches(params, jnp.asarray(patches)))
    got = treid.embed_patches(ours, torch.from_numpy(patches)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=HEAD_ATOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


def test_embed_boxes_with_head_matches_jax(jax_head_file):
    params, path = jax_head_file
    frames, boxes = _frames_and_boxes(2, 96, 128, 5, seed=11)
    ref = np.asarray(jdp.embed_boxes(jnp.asarray(frames), jnp.asarray(boxes), head_params=params))
    ours = tdp.embed_boxes(torch.from_numpy(frames), torch.from_numpy(boxes),
                           head_params=treid.load_head(path)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=HEAD_ATOL)


def test_head_saved_by_the_port_loads_in_jax(tmp_path):
    params = treid.init_head(torch.Generator().manual_seed(4))
    path = tmp_path / "port_head.npz"
    treid.save_head(path, params)
    ref_params = jreid.load_head(path)
    assert ref_params is not None and ref_params["conv1_w"].shape == (3, 3, 16, 32)
    patches = np.random.default_rng(1).uniform(0, 255, (4, 32, 32, 3)).astype(np.float32)
    np.testing.assert_allclose(
        treid.embed_patches(params, torch.from_numpy(patches)).numpy(),
        np.asarray(jreid.embed_patches(ref_params, jnp.asarray(patches))), rtol=0, atol=HEAD_ATOL)
    again = treid.load_head(path)
    for key, value in params.items():
        torch.testing.assert_close(again[key], value, rtol=0, atol=0)


def test_load_head_returns_none_where_the_reference_does(tmp_path, jax_head_file):
    params, _ = jax_head_file
    missing = tmp_path / "nope.npz"
    partial = tmp_path / "partial.npz"
    np.savez(partial, conv0_w=np.zeros((3, 3, 3, 16)))
    garbage = tmp_path / "garbage.npz"
    garbage.write_bytes(b"not a zip file")
    truncated = tmp_path / "truncated.npz"
    truncated.write_bytes(b"PK\x03\x04 cut short")
    wide = tmp_path / "wide.npz"
    arrays = {k: np.asarray(v) for k, v in params.items()}
    np.savez(wide, **{**arrays, "proj_w": np.zeros((64, 128), np.float32),
                      "proj_b": np.zeros((128,), np.float32)})
    bad_proj = tmp_path / "bad_proj.npz"
    np.savez(bad_proj, **{**arrays, "proj_w": np.zeros((32, 64), np.float32)})
    for path in (missing, partial, garbage, truncated, wide, bad_proj):
        assert jreid.load_head(path) is None, path
        assert treid.load_head(path) is None, path


def test_resolve_head(tmp_path, caplog, jax_head_file):
    _, path = jax_head_file
    logger = logging.getLogger("gtx-test-torch-reid")
    assert treid.resolve_head({"model": "auto"}, logger) is None
    assert treid.resolve_head({}, logger) is None
    assert treid.resolve_head(None, logger) is None
    with caplog.at_level(logging.WARNING, logger.name):
        assert treid.resolve_head({"model": "osnet_x0_25.pt"}, logger) is None
        assert treid.resolve_head({"model": str(tmp_path / "missing.npz")}, logger) is None
    assert "only .npz" in caplog.text and "missing or malformed" in caplog.text
    loaded = treid.resolve_head({"model": str(path)}, logger)
    assert loaded is not None and set(loaded) == set(treid._required_shapes(64))


def test_init_head_shapes_and_norm():
    params = treid.init_head(torch.Generator().manual_seed(1), emb_dim=32)
    assert params["conv2_w"].shape == (64, 32, 3, 3) and params["proj_w"].shape == (64, 32)
    patches = torch.from_numpy(
        np.random.default_rng(0).integers(0, 255, (5, 32, 32, 3)).astype(np.float32))
    emb = treid.embed_patches(params, patches)
    assert emb.shape == (5, 32)
    np.testing.assert_allclose(torch.linalg.vector_norm(emb, dim=-1).numpy(), 1.0, atol=1e-5)
    again = treid.init_head(torch.Generator().manual_seed(1), emb_dim=32)
    torch.testing.assert_close(again["proj_w"], params["proj_w"], rtol=0, atol=0)


def test_embed_boxes_separates_colors():
    """tests/test_reid.py's colour check through the port: differently
    coloured targets embed apart, identical ones together."""
    frames = np.full((2, 96, 128, 3), 40, np.uint8)
    frames[0, 32:64, 24:56] = (200, 30, 30)
    frames[0, 32:64, 72:104] = (30, 30, 200)
    frames[1, 32:64, 72:104] = (200, 30, 30)
    frames[1, 32:64, 24:56] = (30, 30, 200)
    boxes = np.array([
        [[40.0, 48.0, 32, 32], [88.0, 48.0, 32, 32]],
        [[88.0, 48.0, 32, 32], [40.0, 48.0, 32, 32]],
    ], np.float32)
    emb = tdp.embed_boxes(torch.from_numpy(frames), torch.from_numpy(boxes)).numpy()
    red0, blue0 = emb[0, 0], emb[0, 1]
    red1, blue1 = emb[1, 0], emb[1, 1]
    assert red0 @ red1 > 0.99 and blue0 @ blue1 > 0.99
    assert red0 @ blue0 < red0 @ red1 - 0.05


@pytest.mark.parametrize("with_pooled", [False, True])
@pytest.mark.parametrize("with_head", [False, True])
def test_embed_boxes_gathers_the_uint8_image_once(with_pooled, with_head, jax_head_file):
    """``embed_boxes`` hands its gather the uint8 image itself (the frames,
    pooled in the gather, or the shared half-resolution image), with no
    float32 copy, and the (C,M) corners once: one call, the 4x4 means for
    the projection, the NCHW patches for the head; the result equals the
    reference's."""
    params, path = jax_head_file
    frames, boxes = _frames_and_boxes(2, 97, 131, 7, seed=21)
    pooled = (np.random.default_rng(22).integers(0, 256, (2, 48, 65, 3)).astype(np.uint8)
              if with_pooled else None)
    head = treid.load_head(path) if with_head else None
    calls = []

    def recording(image, x0, y0, pool2, mean4):
        calls.append((image, x0, pool2, mean4))
        return patches32_hwc(image, x0, y0, pool2, mean4)

    ours = tdp.embed_boxes(torch.from_numpy(frames), torch.from_numpy(boxes),
                           pooled=None if pooled is None else torch.from_numpy(pooled),
                           head_params=head, gather=recording).numpy()
    assert len(calls) == 1
    image, x0, pool2, mean4 = calls[0]
    assert image.dtype == torch.uint8 and x0.shape == (2, 7) and x0.dtype == torch.int32
    np.testing.assert_array_equal(image.numpy(), frames if pooled is None else pooled)
    assert (pool2, mean4) == (pooled is None, head is None)
    ref = np.asarray(jdp.embed_boxes(jnp.asarray(frames), jnp.asarray(boxes),
                                     pooled=None if pooled is None else jnp.asarray(pooled),
                                     head_params=params if with_head else None))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=HEAD_ATOL if with_head else EMB_ATOL)
