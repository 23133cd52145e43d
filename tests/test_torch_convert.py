"""Checkpoints (geotrax_tpu_torch/models/convert.py) against the reference's
geotrax_tpu/models/convert.py, on files the test writes from seeded
``init_params``:

- a ``.npz`` from the reference's ``save_npz`` and a ``.pt`` from its
  ``export_ultralytics_state_dict`` load into the port with exactly the
  reference's weights (HWIO -> OIHW) and class names, and the port's
  ``Detector`` built from each file detects what the reference's
  ``Detector`` detects from the same file on a seeded frame: equal
  classes and valid slots, boxes within 1e-3 px, scores within 1e-5. The
  head's class logits are sharpened (x100) and its boxes shrunk, so scores
  spread over (0, 1); the frame is one where no score lies within 1e-4 of
  ``conf``.
- the port's ``save_npz`` and ``save_pt`` load in the reference with the
  port's weights exactly; ``save_npz`` writes the reference's key layout.
- Batch-norm folding (eps 1e-3) of a state dict with non-trivial batch
  norm equals the reference's, exactly; P2 and the variants round-trip."""

import numpy as np
import pytest

import jax
import torch

from geotrax_tpu.models import convert as jconv
from geotrax_tpu.models import yolov8 as jy
from geotrax_tpu.models.detector import Detector as JaxDetector
from geotrax_tpu_torch.models import convert as tconv
from geotrax_tpu_torch.models import yolov8 as ty
from geotrax_tpu_torch.models.detector import Detector

NAMES = {0: "car", 1: "bus", 2: "truck", 3: "motorcycle"}
CFG = {"imgsz": 128, "conf": 0.5, "iou": 0.7, "max_det": 40, "agnostic_nms": True,
       "classes": [0, 1, 2, 3]}
FRAME_HW = (96, 160)


def sharpened_params(spec, seed=0):
    """Seeded reference params with a head whose class scores spread over
    (0, 1) and whose boxes are about one stride wide."""
    params = jax.tree.map(np.array, jy.init_params(jax.random.PRNGKey(seed), spec))
    head = params["layers"][str(spec.head_index)]
    for k in range(len(spec.strides)):
        head["cv3"][k][2]["w"] *= 100.0
        head["cv3"][k][2]["b"] -= 1.9  # a few percent of the anchors pass conf 0.5
        head["cv2"][k][2]["w"] *= 0.05
        b = np.zeros(4 * spec.reg_max, np.float32)
        b[0::spec.reg_max] = b[1::spec.reg_max] = 20.0
        head["cv2"][k][2]["b"] = b
    return params


def tree_to_port(params, spec):
    return ty.params_from_jax(params, spec, device="cpu")


def assert_same_weights(model, params):
    want = tree_to_port(params, model.spec).state_dict()
    got = model.state_dict()
    assert list(got) == list(want)
    for key in want:
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("convert")
    spec = jy.ModelSpec(variant="n", nc=4)
    params = sharpened_params(spec)
    jconv.save_npz(tmp / "ref.npz", params, class_names=NAMES, variant="n", nc=4)
    sd = jconv.export_ultralytics_state_dict(params, spec)
    torch.save({"state_dict": {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
                "class_names": NAMES}, tmp / "ref.pt")
    frame = np.random.default_rng(3).integers(0, 256, (2,) + FRAME_HW + (3,), dtype=np.uint8)
    return tmp, params, frame


@pytest.mark.parametrize("suffix", ["npz", "pt"])
def test_reference_file_loads_with_the_references_weights(files, suffix):
    tmp, params, _ = files
    model, spec, names = tconv.load_model(tmp / f"ref.{suffix}")
    assert spec == ty.ModelSpec(variant="n", nc=4) and names == NAMES
    assert tconv.read_class_names(tmp / f"ref.{suffix}") == NAMES
    if suffix == "npz":
        assert_same_weights(model, params)
    else:  # the fold of the identity batch norm reproduces the weights to f32 rounding
        want = tree_to_port(params, spec).state_dict()
        for key, value in model.state_dict().items():
            torch.testing.assert_close(value, want[key], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("suffix", ["npz", "pt"])
def test_detector_from_file_detects_what_the_reference_detects(files, suffix):
    tmp, _, frame = files
    path = tmp / f"ref.{suffix}"
    want = jax.jit(JaxDetector(path, CFG).batch_trace(*FRAME_HW))(frame)
    det = Detector(path, CFG, device="cpu")
    assert det.class_names == NAMES and det.class_mask is None
    got = det.batch_trace(*FRAME_HW)(torch.from_numpy(frame))
    valid = np.asarray(want["valid"])
    assert 10 < valid.sum() < 60
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    np.testing.assert_array_equal(got["classes"].numpy(), np.asarray(want["classes"]))
    np.testing.assert_allclose(got["boxes_xywh"].numpy(), np.asarray(want["boxes_xywh"]),
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]), rtol=0, atol=1e-5)
    # no score near the threshold: the comparison is not decided by rounding
    new_h, new_w, _, top, left, out_h, out_w = det.resize_geometry(*FRAME_HW)
    imgs = ty.letterbox(torch.from_numpy(frame), out_h, out_w, new_h, new_w, top, left)
    with torch.no_grad():
        _, probs = ty.forward(det.model, imgs, det.spec)
    assert float((probs.amax(-1) - CFG["conf"]).abs().min()) > 1e-4


def test_port_files_load_in_the_reference(files):
    tmp, params, _ = files
    spec = ty.ModelSpec(variant="n", nc=4)
    model = tree_to_port(params, spec)
    tconv.save_npz(tmp / "port.npz", model, class_names=NAMES)
    tconv.save_pt(tmp / "port.pt", model, class_names=NAMES)
    with np.load(tmp / "port.npz", allow_pickle=True) as a, np.load(tmp / "ref.npz",
                                                                     allow_pickle=True) as b:
        assert [k for k in a.files if k.startswith("param:")] == [
            k for k in b.files if k.startswith("param:")]
    for suffix in ("npz", "pt"):
        j_params, j_spec, j_names = jconv.load_model(tmp / f"port.{suffix}")
        assert j_spec == jy.ModelSpec(variant="n", nc=4) and j_names == NAMES
        got = tree_to_port(jax.tree.map(np.asarray, j_params), spec).state_dict()
        exact = suffix == "npz"  # the .pt goes through the identity batch-norm fold
        for key, value in model.state_dict().items():
            torch.testing.assert_close(got[key], value, rtol=0 if exact else 1e-6,
                                       atol=0 if exact else 1e-7)


def test_batch_norm_fold_equals_the_references():
    spec = jy.ModelSpec(variant="n", nc=3)
    sd = jconv.export_ultralytics_state_dict(
        jax.tree.map(np.asarray, jy.init_params(jax.random.PRNGKey(1), spec)), spec)
    rng = np.random.default_rng(2)
    for key in [k for k in sd if k.endswith(".bn.weight")]:
        stem = key[: -len(".weight")]
        n = sd[key].shape[0]
        sd[f"{stem}.weight"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
        sd[f"{stem}.bias"] = rng.normal(0, 0.1, n).astype(np.float32)
        sd[f"{stem}.running_mean"] = rng.normal(0, 0.2, n).astype(np.float32)
        sd[f"{stem}.running_var"] = rng.uniform(0.2, 2.0, n).astype(np.float32)
    j_params, j_spec = jconv.convert_ultralytics(sd)
    model, t_spec = tconv.convert_ultralytics(sd)
    assert t_spec == ty.ModelSpec(variant="n", nc=3)
    assert_same_weights(model, jax.tree.map(np.asarray, j_params))
    assert tconv.infer_spec(sd) == t_spec


@pytest.mark.parametrize("variant,p2", [("n", True), ("s", False)])
def test_round_trip_of_other_variants(tmp_path, variant, p2):
    spec = ty.ModelSpec(variant=variant, nc=2, p2=p2)
    model = ty.init_params(torch.Generator().manual_seed(5), spec, device="cpu")
    tconv.save_pt(tmp_path / "m.pt", model)
    tconv.save_npz(tmp_path / "m.npz", model)
    for suffix in ("pt", "npz"):
        loaded, got_spec, names = tconv.load_model(tmp_path / f"m.{suffix}")
        assert got_spec == spec and names is None
        for key, value in model.state_dict().items():
            torch.testing.assert_close(loaded.state_dict()[key], value, rtol=1e-6, atol=1e-7)
    assert jconv.load_model(tmp_path / "m.npz")[1] == jy.ModelSpec(variant=variant, nc=2, p2=p2)
