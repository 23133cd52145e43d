"""RT-DETR in the port against the JAX package, on the CPU.

- ``rtdetr_ul`` (ultralytics' rtdetr-l graph) at the reduced widths of
  tests/test_rtdetr_convert.py (``TINY_SPEC``), converted from that file's
  torch oracle: the converter's tree equal to the reference's leaf for
  leaf, and the backbone, the hybrid encoder, the decoder and the whole
  forward on a seeded 64x96 image within FEATURE_TOL / BOX_TOL_PX /
  PROB_TOL of the JAX functions (only the summation order of the products
  differs; the selected queries are the same, or the decoder's outputs
  would not agree).
- ``rtdetr`` (the native ``.npz`` family) at tests/test_rtdetr.py's
  ``SPEC`` on a seeded 96x96 image, float32 within NATIVE_BOX_TOL_PX /
  PROB_TOL; with ``half``, everything after the backbone on the
  reference's own bfloat16 features, against the reference run op by op
  (``jax.disable_jit``): the jitted reference differs from its own op-by-op
  result by ~17 px on this random model (XLA's rewriting of the bfloat16
  weights' promotion; ROADMAP C6), the port follows the ops as written.
- ``Detector`` on a seeded frame from a native ``.npz`` (imgsz 96) and from
  a full-width rtdetr-l ``.pt`` (imgsz 128): equal valid slots and
  classes, scores within PROB_TOL slot by slot, and each slot's box within
  DET_BOX_TOL_PX of the reference's box in the same slot or, where scores
  tie within PROB_TOL (the random rtdetr-l's queries do), in a slot of
  the same class and score; ``half`` refused for the rtdetr-l graph, tiles
  ignored.

``extract`` with these checkpoints is in tests/test_torch_rtdetr_extract.py."""

import logging

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from geotrax_tpu.models import convert as jconv
from geotrax_tpu.models import rtdetr as jrt
from geotrax_tpu.models import rtdetr_ul as jul
from geotrax_tpu.models.detector import Detector as JaxDetector
from geotrax_tpu_torch.models import convert as tconv
from geotrax_tpu_torch.models import rtdetr as trt
from geotrax_tpu_torch.models import rtdetr_ul as tul
from geotrax_tpu_torch.models.detector import Detector
from test_rtdetr_convert import TINY_SPEC, AIFI, Conv, DWConv, HGBlock, HGStem, RepC3, \
    RTDETRDecoder, TinyRTDETR

FEATURE_TOL = 1e-6
BOX_TOL_PX = 1e-4
NATIVE_BOX_TOL_PX = 1e-3
PROB_TOL = 1e-5
DET_BOX_TOL_PX = 1e-3
NATIVE_SPEC = jrt.RTDETRSpec(variant="n", nc=4, hidden=64, num_queries=30, num_decoder_layers=2,
                             num_heads=4, num_points=2)


# ------------------------------------------------------------ rtdetr_ul, reduced widths

@pytest.fixture(scope="module")
def tiny():
    torch.manual_seed(3)
    model = TinyRTDETR().eval()
    with torch.no_grad():  # non-trivial BN statistics, so that folding is exercised
        for mod in model.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.uniform_(-0.1, 0.1)
                mod.running_var.uniform_(0.8, 1.2)
    sd = {"model." + k: v.detach().numpy() for k, v in model.model.state_dict().items()}
    jparams, _ = jconv.convert_rtdetr_ultralytics(sd, TINY_SPEC)
    port, spec = tconv.convert_rtdetr_ultralytics(sd, tul.ULSpec(*TINY_SPEC))
    x = np.random.default_rng(0).uniform(0, 1, (1, 64, 96, 3)).astype(np.float32)
    return sd, jparams, port, spec, x


def test_converter_tree_equals_the_references(tiny):
    sd, jparams, _, spec, _ = tiny
    want = dict(jax.tree_util.tree_leaves_with_path(jparams))
    got = dict(jax.tree_util.tree_leaves_with_path(tconv.rtdetr_ultralytics_tree(sd, spec)))
    assert want.keys() == got.keys() and len(got) > 300
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], np.asarray(value), err_msg=str(key))


def _np(tensors):
    return [t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t) for t in tensors]


@pytest.mark.parametrize("block", ["backbone", "encoder", "decoder", "forward"])
def test_rtdetr_l_blocks_match_the_reference(tiny, block):
    _, jparams, port, spec, x = tiny
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    j3 = jax.jit(jul.backbone, static_argnums=2)(jparams["backbone"], jx, TINY_SPEC)
    if block == "backbone":
        want, got = j3, tul.backbone(port, tx, spec)
    else:
        jenc = jax.jit(jul.hybrid_encoder, static_argnums=4)(jparams["encoder"], *j3, TINY_SPEC)
        if block == "encoder":
            want = jenc
            got = tul.hybrid_encoder(port, *[torch.from_numpy(np.asarray(f)) for f in j3], spec)
        elif block == "decoder":
            want = jax.jit(jul.decoder, static_argnums=2)(jparams["decoder"], jenc, TINY_SPEC)
            got = tul.decoder(port, [torch.from_numpy(np.asarray(f)) for f in jenc], spec)
        else:
            want, got = jul.forward(jparams, jx, TINY_SPEC), tul.forward(port, tx, spec)
    with torch.no_grad():
        want, got = _np(want), _np(got)
    assert [w.shape for w in want] == [g.shape for g in got]
    if block == "forward":
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=BOX_TOL_PX)
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=PROB_TOL)
    else:
        for w, g in zip(want, got):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=FEATURE_TOL)


# ------------------------------------------------------------ the native family

def native_params():
    return jax.jit(jrt.init_params, static_argnums=1)(jax.random.PRNGKey(0), NATIVE_SPEC)


@pytest.fixture(scope="module")
def native():
    params = native_params()
    tree = jax.tree.map(np.asarray, params)
    x = np.random.default_rng(1).uniform(0, 1, (1, 96, 96, 3)).astype(np.float32)
    return params, tree, x


def test_native_forward_matches_the_reference(native):
    params, tree, x = native
    model = trt.params_from_jax(tree, trt.RTDETRSpec(*NATIVE_SPEC), device="cpu")
    want = _np(jrt.forward(params, jnp.asarray(x), NATIVE_SPEC))
    with torch.no_grad():
        got = _np(trt.forward(model, torch.from_numpy(x), model.spec))
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=NATIVE_BOX_TOL_PX)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=PROB_TOL)


def test_native_half_follows_the_references_ops(native, monkeypatch):
    from geotrax_tpu.models import yolov8 as jy

    params, tree, x = native
    half = jax.tree.map(lambda a: a.astype(jnp.bfloat16), params)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    feats = jax.jit(jy.forward_features, static_argnums=2)(
        {"layers": half["backbone"]}, xb, jy.ModelSpec(variant="n", nc=4))
    # the reference's head op by op, on these features (its backbone is held
    # to the port's by the YOLOv8 tests)
    monkeypatch.setattr(jy, "forward_features", lambda *a: feats)
    with jax.disable_jit():
        want = _np(jrt.forward(half, xb, NATIVE_SPEC))
    model = trt.params_from_jax(tree, trt.RTDETRSpec(*NATIVE_SPEC), device="cpu").to(torch.bfloat16)
    tfeats = [torch.from_numpy(np.asarray(f.astype(jnp.float32))).to(torch.bfloat16) for f in feats]
    with torch.no_grad():
        boxes, probs = trt.forward_head(model, tfeats, 96, 96, model.spec)
        whole = trt.forward(model, torch.from_numpy(x).to(torch.bfloat16), model.spec)
    assert boxes.dtype == probs.dtype == whole[0].dtype == whole[1].dtype == torch.float32
    assert model.p["cls_head"]["w"].dtype == model.backbone.layers["0"].weight.dtype == torch.bfloat16
    np.testing.assert_allclose(boxes.numpy(), want[0], rtol=0, atol=NATIVE_BOX_TOL_PX)
    np.testing.assert_allclose(probs.numpy(), want[1], rtol=0, atol=PROB_TOL)


# ------------------------------------------------------------ Detector

def full_width_rtdetr_l(seed=7):
    """The torch oracle at rtdetr-l's published widths (a random rtdetr-l)."""
    torch.manual_seed(seed)
    model = TinyRTDETR(nc=4, hd=256, nh=8, ndp=4, ndl=6, d_ffn=1024)
    act = torch.nn.ReLU()
    m = model.model
    m["0"] = HGStem(3, 32, 48)
    m["1"] = HGBlock(48, 48, 128, 3, 6, False, False, act)
    m["2"] = DWConv(128, 128, 3, 2, act=False)
    m["3"] = HGBlock(128, 96, 512, 3, 6, False, False, act)
    m["4"] = DWConv(512, 512, 3, 2, act=False)
    m["5"] = HGBlock(512, 192, 1024, 5, 6, True, False, act)
    m["6"] = HGBlock(1024, 192, 1024, 5, 6, True, True, act)
    m["7"] = HGBlock(1024, 192, 1024, 5, 6, True, True, act)
    m["8"] = DWConv(1024, 1024, 3, 2, act=False)
    m["9"] = HGBlock(1024, 384, 2048, 5, 6, True, False, act)
    m["10"] = Conv(2048, 256, 1, act=False)
    m["11"] = AIFI(256, 1024, 8)
    m["14"] = Conv(1024, 256, 1, act=False)
    for i in ("16", "21", "24", "27"):
        m[i] = RepC3(512, 256, 3)
    m["19"] = Conv(512, 256, 1, act=False)
    m["28"] = RTDETRDecoder(4, (256, 256, 256), 256, 300, 4, 8, 6, 1024)
    return model.eval()


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("rtdetr")
    native_path = tmp / "rtdetr_n.npz"
    jconv.save_npz(native_path, native_params(),
                   class_names={0: "car", 1: "bus", 2: "truck", 3: "motorcycle"},
                   variant="n", nc=4, hidden=NATIVE_SPEC.hidden,
                   num_queries=NATIVE_SPEC.num_queries,
                   num_decoder_layers=NATIVE_SPEC.num_decoder_layers,
                   num_heads=NATIVE_SPEC.num_heads, num_points=NATIVE_SPEC.num_points)
    pt_path = tmp / "rtdetr-l-test.pt"
    sd = {"model." + k: v for k, v in full_width_rtdetr_l().model.state_dict().items()}
    torch.save({"state_dict": sd, "class_names": {0: "car", 1: "bus", 2: "truck", 3: "motorcycle"}},
               pt_path)
    frame = np.random.default_rng(0).integers(0, 256, (120, 160, 3), np.uint8)
    return {"npz": native_path, "pt": pt_path, "frame": frame, "tmp": tmp}


def assert_same_boxes(got: dict, want: dict) -> None:
    """Each slot's box equals the reference's box in that slot, or in a
    slot whose class is the same and whose score ties within PROB_TOL (the
    top-k's order among tied scores follows their last bits)."""
    tie = ((np.abs(got["scores"][:, None] - want["scores"][None, :]) <= PROB_TOL)
           & (got["classes"][:, None] == want["classes"][None, :]))
    dist = np.abs(got["boxes_xywh"][:, None, :] - want["boxes_xywh"][None, :, :]).max(-1)
    same_slot = np.diag(dist) <= DET_BOX_TOL_PX
    in_tie = np.where(tie, dist, np.inf).min(1) <= DET_BOX_TOL_PX
    assert (same_slot | in_tie).all(), np.flatnonzero(~(same_slot | in_tie))


@pytest.mark.parametrize("kind,imgsz", [("npz", 96), ("pt", 128)])
def test_detector_detects_what_the_reference_detects(checkpoints, kind, imgsz):
    cfg = {"imgsz": imgsz, "conf": 0.3, "max_det": 320, "classes": [0, 1, 2]}
    want = {k: np.asarray(v) for k, v in
            JaxDetector(checkpoints[kind], cfg)(checkpoints["frame"]).items()}
    det = Detector(checkpoints[kind], cfg, device="cpu")
    assert det.is_rtdetr and det.is_ul_rtdetr == (kind == "pt")
    assert det.class_names[3] == "motorcycle" and det.resize_geometry(120, 160) is None
    got = {k: v.numpy() for k, v in det(checkpoints["frame"]).items()}
    assert got["boxes_xywh"].shape == (320, 4) and 0 < want["valid"].sum() < 320
    for key in ("valid", "classes"):
        np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0, atol=PROB_TOL)
    assert_same_boxes(got, want)
    assert (got["classes"][got["valid"]] != 3).all()
    batch = det.detect_batch(np.stack([checkpoints["frame"]] * 2))
    np.testing.assert_allclose(batch["scores"][1].numpy(), got["scores"], rtol=0, atol=PROB_TOL)


def test_detector_refuses_half_rtdetr_l_and_ignores_tiles(checkpoints, caplog):
    with pytest.raises(ValueError, match="half is not supported for the rtdetr-l graph"):
        Detector(checkpoints["pt"], {"imgsz": 128, "half": True}, device="cpu")
    with caplog.at_level(logging.WARNING):
        det = Detector(checkpoints["npz"], {"imgsz": 96, "tiles": 2, "half": True}, device="cpu",
                       logger=logging.getLogger("test-rtdetr"))
    assert det.tiles == 1 and "tiling is not supported for RT-DETR" in caplog.text
    out = det(checkpoints["frame"])
    assert out["scores"].dtype == torch.float32 and out["boxes_xywh"].shape == (1000, 4)
