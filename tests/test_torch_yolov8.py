"""YOLOv8, NMS and detection post-processing of the port against the JAX
package: weights carried over with ``params_from_jax``; raw boxes and class
probabilities within rtol 1e-4 / atol 1e-3 (float32 convolutions summed in
another order); NMS and ``postprocess_detections`` exact on identical
inputs."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from geotrax_tpu.models import yolov8 as jy
from geotrax_tpu.ops import nms as jnms
from geotrax_tpu_torch.models import yolov8 as ty
from geotrax_tpu_torch.models.detector import Detector
from geotrax_tpu_torch.ops import nms as tnms

SPEC_J = jy.ModelSpec(variant="n", nc=4)
SPEC_T = ty.ModelSpec(variant="n", nc=4)


@pytest.fixture(scope="module")
def models():
    params = jax.tree.map(np.asarray, jy.init_params(jax.random.PRNGKey(0), SPEC_J))
    return params, ty.params_from_jax(params, SPEC_T, device="cpu")


@pytest.fixture(scope="module")
def head_outputs(models):
    params, model = models
    rng = np.random.default_rng(0)
    imgs = rng.uniform(0, 1, (2, 256, 256, 3)).astype(np.float32)
    jb, jp = jy.forward(params, jnp.asarray(imgs), SPEC_J)
    with torch.no_grad():
        tb, tp = ty.forward(model, torch.from_numpy(imgs), SPEC_T)
    return np.array(jb), np.array(jp), tb.numpy(), tp.numpy()


def test_forward_matches_jax(head_outputs):
    jb, jp, tb, tp = head_outputs
    assert tb.shape == jb.shape == (2, 32 * 32 + 16 * 16 + 8 * 8, 4)
    assert tp.shape == jp.shape == (2, 32 * 32 + 16 * 16 + 8 * 8, 4)
    np.testing.assert_allclose(tb, jb, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(tp, jp, rtol=1e-4, atol=1e-3)


def test_stem_s2d_equals_strided_conv(models):
    _, model = models
    x = torch.from_numpy(np.random.default_rng(1).uniform(0, 1, (1, 3, 64, 96)).astype(np.float32))
    with torch.no_grad():
        a = ty.stem_conv_s2d(model.layers["0"], x)
        b = ty.conv_block(model.layers["0"], x, stride=2)
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("agnostic", [True, False])
@pytest.mark.parametrize("conf,max_det", [(0.25, 300), (0.5, 50)])
def test_postprocess_exact_on_same_inputs(head_outputs, agnostic, conf, max_det):
    jb, jp, _, _ = head_outputs
    ref = jax.vmap(lambda b, p: jnms.postprocess_detections(
        b, p, conf, 0.7, max_det, agnostic=agnostic))(jnp.asarray(jb), jnp.asarray(jp))
    ours = tnms.postprocess_detections(torch.from_numpy(jb), torch.from_numpy(jp), conf, 0.7,
                                       max_det, agnostic=agnostic)
    assert int(np.asarray(ref["valid"]).sum()) > 0
    for key in ("boxes_xywh", "scores", "classes", "valid"):
        np.testing.assert_array_equal(ours[key].numpy(), np.asarray(ref[key]), err_msg=key)


def test_nms_exact_on_clustered_boxes():
    rng = np.random.default_rng(3)
    centers = rng.uniform(20, 200, (12, 2))
    boxes, scores, classes = [], [], []
    for c in centers:  # clusters of overlapping duplicates -> deep suppression chains
        for j in range(8):
            xy = c + rng.normal(0, 3, 2)
            wh = rng.uniform(10, 30, 2)
            boxes.append(np.concatenate([xy - wh / 2, xy + wh / 2]))
            scores.append(rng.uniform(0.05, 1.0))
            classes.append(j % 3)
    boxes = np.asarray(boxes, np.float32)
    scores = np.asarray(scores, np.float32)
    scores[::7] = 0.0  # absent candidates
    classes = np.asarray(classes, np.int32)
    for agnostic in (True, False):
        for max_det in (20, 200):
            rk, rv = jnms.nms(jnp.asarray(boxes), jnp.asarray(scores), 0.5, max_det,
                              class_ids=jnp.asarray(classes), agnostic=agnostic)
            tk, tv = tnms.nms(torch.from_numpy(boxes), torch.from_numpy(scores), 0.5, max_det,
                              class_ids=torch.from_numpy(classes), agnostic=agnostic)
            np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))
            np.testing.assert_array_equal(tk.numpy(), np.asarray(rk))


def test_letterbox_and_unletterbox_match_jax():
    assert ty.letterbox_shape(2160, 3840, 1920) == jy.letterbox_shape(2160, 3840, 1920)
    assert ty.letterbox_shape(240, 320, 256) == jy.letterbox_shape(240, 320, 256)
    out_h, out_w, r, top, left = jy.letterbox_shape(120, 160, 128)
    new_h, new_w = round(120 * r), round(160 * r)
    rng = np.random.default_rng(4)
    resized = rng.integers(0, 256, (new_h, new_w, 3), dtype=np.uint8)
    np.testing.assert_array_equal(
        ty.letterbox_pad(torch.from_numpy(resized), out_h, out_w, top, left).numpy(),
        np.asarray(jy.letterbox_pad(jnp.asarray(resized), out_h, out_w, top, left)),
    )
    frame = rng.integers(0, 256, (120, 160, 3), dtype=np.uint8)
    np.testing.assert_array_equal(
        ty.letterbox(torch.from_numpy(frame), out_h, out_w, new_h, new_w, top, left).numpy(),
        np.asarray(jy.letterbox(jnp.asarray(frame), out_h, out_w, new_h, new_w, top, left)),
    )
    boxes = rng.uniform(0, 128, (5, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        ty.unletterbox_boxes(torch.from_numpy(boxes), r, top, left).numpy(),
        np.asarray(jy.unletterbox_boxes(jnp.asarray(boxes), r, top, left)),
    )


def test_detector_resized_path_equals_full_path(models):
    _, model = models
    det = Detector(model, {"imgsz": 128, "conf": 0.25, "max_det": 50}, device="cpu")
    rng = np.random.default_rng(5)
    frames = torch.from_numpy(rng.integers(0, 256, (2, 96, 160, 3), dtype=np.uint8))
    new_h, new_w = det.resize_geometry(96, 160)[:2]
    from geotrax_tpu_torch.ops.resize import resize_u8_linear

    a = det.batch_trace(96, 160)(frames)
    b = det.batch_trace_resized(96, 160)(resize_u8_linear(frames, new_h, new_w))
    for key in a:
        np.testing.assert_array_equal(a[key].numpy(), b[key].numpy())
    assert a["boxes_xywh"].shape == (2, 50, 4) and a["classes"].dtype == torch.int32


def test_init_params_is_seeded_and_cpu_only_when_asked():
    a = ty.init_params(torch.Generator().manual_seed(3), SPEC_T, device="cpu")
    b = ty.init_params(torch.Generator().manual_seed(3), SPEC_T, device="cpu")
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb
        torch.testing.assert_close(va, vb, rtol=0, atol=0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ty.init_params(torch.Generator().manual_seed(3), SPEC_T)
