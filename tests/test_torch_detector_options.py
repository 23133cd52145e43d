"""The detector's options against the reference's Detector built from the
same ``.npz`` (the reference's ``save_npz`` of a seeded YOLOv8n whose head
spreads the class scores over (0, 1), as in tests/test_torch_convert.py),
on a seeded pair of 96x160 frames at imgsz 128:

- ``tiles: 2`` (overlap 16), float32: equal valid slots and classes,
  boxes within 1e-3 px, scores within 1e-5 (the tiles and the merge are
  the reference's; only the convolutions' summation order differs).
- ``half: true``: bfloat16 weights and activations, float32
  post-processing. The bf16 convolutions round differently in XLA and in
  PyTorch, and NMS orders the kept boxes by score, so the detections are
  matched by box: each detection scoring more than HALF_SCORE above
  ``conf`` in one lies within HALF_BOX_PX of a distinct detection of the
  same class in the other, scores within HALF_SCORE, and the counts differ
  by no more than the anchors whose float32 score lies within HALF_SCORE
  of ``conf``.
- ``tile_geometry`` and ``merge_tile_detections`` exactly, and the
  out-of-range ``classes`` warning."""

import logging

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from geotrax_tpu.models import convert as jconv
from geotrax_tpu.models import yolov8 as jy
from geotrax_tpu.models.detector import Detector as JaxDetector
from geotrax_tpu.parallel import tiling as jtiling
from geotrax_tpu_torch.models import yolov8 as ty
from geotrax_tpu_torch.models.detector import Detector
from geotrax_tpu_torch.parallel import tiling as ttiling

CFG = {"imgsz": 128, "conf": 0.5, "iou": 0.7, "max_det": 40, "agnostic_nms": True,
       "classes": [0, 1, 2, 3]}
FRAME_HW = (96, 160)
HALF_BOX_PX = 0.05
HALF_SCORE = 0.02


def sharpened_params(spec, seed=0):
    """As in tests/test_torch_convert.py: class scores spread over (0, 1),
    boxes about one stride wide."""
    params = jax.tree.map(np.array, jy.init_params(jax.random.PRNGKey(seed), spec))
    head = params["layers"][str(spec.head_index)]
    for k in range(len(spec.strides)):
        head["cv3"][k][2]["w"] *= 100.0
        head["cv3"][k][2]["b"] -= 1.9
        head["cv2"][k][2]["w"] *= 0.05
        b = np.zeros(4 * spec.reg_max, np.float32)
        b[0::spec.reg_max] = b[1::spec.reg_max] = 20.0
        head["cv2"][k][2]["b"] = b
    return params


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    path = tmp_path_factory.mktemp("options") / "m.npz"
    jconv.save_npz(path, sharpened_params(jy.ModelSpec(variant="n", nc=4)),
                   class_names={0: "car"}, variant="n", nc=4)
    frame = np.random.default_rng(3).integers(0, 256, (2,) + FRAME_HW + (3,), dtype=np.uint8)
    return path, frame


def run_both(path, frame, **options):
    cfg = {**CFG, **options}
    want = jax.jit(JaxDetector(path, cfg).batch_trace(*FRAME_HW))(frame)
    got = Detector(path, cfg, device="cpu").batch_trace(*FRAME_HW)(torch.from_numpy(frame))
    return {k: np.asarray(v) for k, v in want.items()}, {k: v.numpy() for k, v in got.items()}


def test_tiles_detect_what_the_reference_detects(setup):
    want, got = run_both(*setup, tiles=2, tile_overlap=16)
    assert 20 < want["valid"].sum() < 80
    for key in ("valid", "classes"):
        np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_allclose(got["boxes_xywh"], want["boxes_xywh"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0, atol=1e-5)


def test_tiled_detector_has_no_shared_resize(setup):
    det = Detector(setup[0], {**CFG, "tiles": 2}, device="cpu")
    assert det.resize_geometry(*FRAME_HW) is None and det.batch_trace_resized(*FRAME_HW) is None


def _matched(boxes_a, boxes_b):
    """For each box of ``boxes_a``: the index of the nearest box of
    ``boxes_b`` and the distance (largest coordinate difference)."""
    dist = np.abs(boxes_a[:, None, :] - boxes_b[None, :, :]).max(-1)
    return dist.argmin(1), dist.min(1)


def test_half_detects_what_the_references_half_detects(setup):
    path, frame = setup
    want, got = run_both(path, frame, half=True)
    det = Detector(path, CFG, device="cpu")
    new_h, new_w, _, top, left, out_h, out_w = det.resize_geometry(*FRAME_HW)
    with torch.no_grad():
        _, probs = ty.forward(det.model, ty.letterbox(torch.from_numpy(frame), out_h, out_w,
                                                      new_h, new_w, top, left), det.spec)
    near_conf = ((probs.amax(-1) - CFG["conf"]).abs() <= HALF_SCORE).sum(-1).numpy()
    assert Detector(path, {**CFG, "half": True}, device="cpu").model.layers["0"].weight.dtype \
        == torch.bfloat16
    for f in range(len(frame)):
        wv, gv = want["valid"][f], got["valid"][f]
        assert wv.sum() > 3 and abs(int(gv.sum()) - int(wv.sum())) <= near_conf[f]
        # every detection clear of the threshold in one has its match in the other
        for a, b in ((got, want), (want, got)):
            va, vb = a["valid"][f], b["valid"][f]
            clear = a["scores"][f][va] > CFG["conf"] + HALF_SCORE
            match, dist = _matched(a["boxes_xywh"][f][va][clear], b["boxes_xywh"][f][vb])
            assert len(set(match.tolist())) == len(match) and dist.max() <= HALF_BOX_PX
            np.testing.assert_array_equal(a["classes"][f][va][clear], b["classes"][f][vb][match])
            np.testing.assert_allclose(a["scores"][f][va][clear], b["scores"][f][vb][match],
                                       rtol=0, atol=HALF_SCORE)


def test_half_leaves_the_callers_model_alone(setup):
    model = ty.init_params(torch.Generator().manual_seed(1), ty.ModelSpec("n", 4), device="cpu")
    Detector(model, {**CFG, "half": True}, device="cpu")
    assert model.layers["0"].weight.dtype == torch.float32


@pytest.mark.parametrize("width,tiles,overlap", [(3840, 2, 128), (3840, 3, 128), (160, 2, 16),
                                                 (1000, 4, 300), (100, 1, 0)])
def test_tile_geometry_equals_the_references(width, tiles, overlap):
    assert ttiling.tile_geometry(width, tiles, overlap) == jtiling.tile_geometry(width, tiles, overlap)


def test_merge_tile_detections_equals_the_references():
    rng = np.random.default_rng(9)
    t, k = 3, 12
    dets = {
        "boxes_xywh": np.column_stack([rng.uniform(0, 200, t * k), rng.uniform(0, 100, t * k),
                                       rng.uniform(10, 40, (t * k, 2))]).reshape(t, k, 4)
        .astype(np.float32),
        "scores": rng.uniform(0, 1, (t, k)).astype(np.float32),
        "classes": rng.integers(0, 4, (t, k)).astype(np.int32),
        "valid": rng.random((t, k)) < 0.8,
    }
    dets["boxes_xywh"][1, :4] = dets["boxes_xywh"][0, :4] - [[150, 0, 0, 0]]  # overlap doubles
    offsets = [0.0, 150.0, 300.0]
    want = jtiling.merge_tile_detections({a: jnp.asarray(v) for a, v in dets.items()}, offsets,
                                         0.5, 20)
    got = ttiling.merge_tile_detections({a: torch.from_numpy(v) for a, v in dets.items()},
                                        offsets, 0.5, 20)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))


def test_out_of_range_classes_warn_like_the_reference(setup, caplog):
    cfg = {**CFG, "classes": [0, 2, 7]}
    with caplog.at_level(logging.WARNING):
        JaxDetector(setup[0], cfg, logging.getLogger("ref"))
        det = Detector(setup[0], cfg, logger=logging.getLogger("port"), device="cpu")
    warnings = [r.getMessage() for r in caplog.records if r.levelno == logging.WARNING]
    assert len(warnings) == 2 and warnings[0] == warnings[1]
    assert det.class_mask.tolist() == [True, False, True, False]
