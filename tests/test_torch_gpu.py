"""Tests of the port that need a CUDA card: the hand-written kernels have no
CPU mode. Each test skips, with its reason, where ``torch.cuda`` finds no
card. They import neither JAX nor the JAX package, so on the card's machine
(which has no JAX) they run without the suite's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import tempfile

import numpy as np
import pytest
import torch

from geotrax_tpu_torch import _cuda
from geotrax_tpu_torch._device import resolve_device
from geotrax_tpu_torch.ops import fast
from geotrax_tpu_torch.ops import features
from geotrax_tpu_torch.ops import patches
from geotrax_tpu_torch.pipeline.device_pipeline import embed_boxes


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's CUDA kernels have no CPU mode")


def textured_gray(b, h, w, seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(40, 90, (b, h, w)).astype(np.float32)
    for i in range(b):
        for _ in range(max(4, h * w // 2000)):
            y, x = rng.integers(0, max(h - 6, 1)), rng.integers(0, max(w - 6, 1))
            bh, bw = rng.integers(2, 16, 2)
            img[i, y:y + bh, x:x + bw] = rng.integers(120, 255)
    return img


@pytest.mark.gpu
# (4, 1080, 1920): the lockstep step's four grays (batch --parallel-videos 4)
@pytest.mark.parametrize("shape", [(3, 1080, 1920), (2, 37, 53), (1, 3, 5), (4, 1080, 1920)])
@pytest.mark.parametrize("threshold", [20.0, 7.0])
def test_kernel_equals_plain_on_card(shape, threshold):
    _need_card()
    g = torch.from_numpy(textured_gray(*shape, seed=sum(shape))).cuda()
    before = fast.fast_score_map.launches
    out = fast.fast_score_map(g, threshold)
    torch.cuda.synchronize()
    assert fast.fast_score_map.launches == before + 1
    torch.testing.assert_close(out, fast.fast_score_map_torch(g, threshold), rtol=0, atol=0)
    # a single (H,W) image takes the same kernel
    one = fast.fast_score_map(g[0].contiguous(), threshold)
    torch.testing.assert_close(one, out[0], rtol=0, atol=0)


def checkerboard(b, h, w, cell=3):
    """Cells of 3 px: 4 of every 9 pixels are corners, the densest
    checkerboard, and nearly every pixel passes the kernel's cardinal test."""
    y, x = np.mgrid[:h, :w]
    return np.broadcast_to(((x // cell + y // cell) % 2 * 255.0).astype(np.float32), (b, h, w))


EDGE_INPUTS = {
    "checkerboard": lambda: checkerboard(2, 130, 260),
    "constant": lambda: np.full((2, 70, 132), 77.0, np.float32),
    "5x5": lambda: textured_gray(2, 5, 5, seed=1),
    "1x7": lambda: textured_gray(3, 1, 7, seed=2),
    "7x1": lambda: textured_gray(3, 7, 1, seed=3),
    "w%4=1": lambda: textured_gray(2, 45, 129, seed=4),
    "w%4=2": lambda: textured_gray(2, 45, 130, seed=5),
    "w%4=3": lambda: textured_gray(2, 45, 131, seed=6),
    "b=1": lambda: textured_gray(1, 1080, 1920, seed=7),
    "b=33": lambda: textured_gray(33, 96, 260, seed=8),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(EDGE_INPUTS))
@pytest.mark.parametrize("threshold", [20.0, 7.0])
def test_kernel_exact_on_edge_inputs(name, threshold):
    """Every tiling edge of the kernel (images smaller than a tile, widths
    that are not a multiple of 4 and so take the 4-byte path, one image and
    more than 32) and the extremes of its early rejection (a checkerboard,
    a constant image) against the plain version, bit for bit."""
    _need_card()
    g = torch.from_numpy(np.ascontiguousarray(EDGE_INPUTS[name]())).cuda()
    out = fast.fast_score_map(g, threshold)
    plain = fast.fast_score_map_torch(g, threshold)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, plain, rtol=0, atol=0)
    corners = int((plain > 0).sum())
    assert corners > 0
    if name == "constant":  # corners only where the ring reaches the zero padding
        assert int((plain[..., 3:-3, 3:-3] > 0).sum()) == 0
    if name == "checkerboard":
        assert corners > g.numel() // 3
    # the same images from a pointer that is not 16-byte aligned (4-byte path)
    flat = torch.zeros(g.numel() + 1, device="cuda")
    flat[1:] = g.flatten()
    shifted = flat[1:].view(g.shape)
    torch.testing.assert_close(fast.fast_score_map(shifted, threshold), plain, rtol=0, atol=0)


@pytest.mark.gpu
def test_wrapper_rejects_what_the_kernel_does_not_take():
    _need_card()
    g = torch.zeros((2, 32, 48), device="cuda")
    with pytest.raises(TypeError):
        fast.fast_score_map(g.double())
    with pytest.raises(ValueError):
        fast.fast_score_map(g.transpose(1, 2))
    with pytest.raises(ValueError):
        fast.fast_score_map(g[None])


@pytest.mark.gpu
def test_fast_detect_on_card_equals_cpu():
    _need_card()
    gray = torch.from_numpy(textured_gray(4, 120, 160, seed=3))
    mask = torch.ones((120, 160), dtype=torch.bool)
    mask[40:70, 50:90] = False
    cpu = features.fast_detect(gray, 300, mask=mask, oriented=False)
    gpu = features.fast_detect(gray.cuda(), 300, mask=mask.cuda(), oriented=False)
    for a, b in zip(cpu, gpu):
        torch.testing.assert_close(b.cpu(), a, rtol=0, atol=0)


# card vs CPU for the ORB-style library: the orientation's float32 moment
# sums add in another order on the card; an oriented test point that rounds
# at .5 may move with the angle's last bits; the pyramid's deeper levels are
# resize products that add in another order
ANGLE_TOL = 1e-4
ORIENTED_BIT_SHARE = 1e-3
PYRAMID_OVERLAP = 0.98


def _wrapped(a):
    return torch.remainder(a + np.pi, 2 * np.pi) - np.pi


@pytest.mark.gpu
def test_oriented_fast_detect_on_card_equals_cpu():
    _need_card()
    gray = torch.from_numpy(textured_gray(1, 540, 960, seed=12)[0])
    cpu = features.fast_detect(gray, 2000)
    gpu = features.fast_detect(gray.cuda(), 2000)
    for name in ("xy", "score", "valid"):
        torch.testing.assert_close(getattr(gpu, name).cpu(), getattr(cpu, name), rtol=0, atol=0)
    assert float(_wrapped(gpu.angle.cpu() - cpu.angle).abs().max()) <= ANGLE_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("oriented,method", [(True, "patches"), (False, "patches"),
                                             (False, "planes")])
def test_describe_on_card_equals_cpu(oriented, method):
    _need_card()
    gray = torch.from_numpy(textured_gray(1, 540, 960, seed=13)[0])
    kps = features.fast_detect(gray, 2000)
    before = patches.patches32.launches
    gpu = features.describe(gray.cuda(), features.Keypoints(*(t.cuda() for t in kps)),
                            oriented=oriented, method=method)
    torch.cuda.synchronize()
    assert patches.patches32.launches == before + (not oriented and method == "patches")
    cpu = features.describe(gray, kps, oriented=oriented, method=method)
    share = float((gpu.cpu() != cpu).float().mean())
    assert share <= (ORIENTED_BIT_SHARE if oriented else 0.0), share


@pytest.mark.gpu
def test_pyramid_and_match_descriptors_on_card_equal_cpu():
    _need_card()
    a = torch.from_numpy(textured_gray(1, 540, 960, seed=14)[0])
    b = torch.roll(a, (7, -5), dims=(0, 1)).contiguous()
    before = fast.fast_score_map.launches
    (ka, da), (kb, db) = (features.detect_and_describe_pyramid(g.cuda(), 2000) for g in (a, b))
    torch.cuda.synchronize()
    assert fast.fast_score_map.launches == before + 8  # one per level of each image
    cpu_a, _ = features.detect_and_describe_pyramid(a, 2000)
    mine = {tuple(v) for v in torch.round(cpu_a.xy * 1000).to(torch.int64).tolist()}
    card = torch.round(ka.xy.cpu() * 1000).to(torch.int64).tolist()
    assert np.mean([tuple(v) in mine for v in card]) >= PYRAMID_OVERLAP
    m = features.match_descriptors(da, ka.valid, db, kb.valid)
    mc = features.match_descriptors(da.cpu(), ka.valid.cpu(), db.cpu(), kb.valid.cpu())
    for name in ("idx_a", "idx_b", "valid"):
        torch.testing.assert_close(getattr(m, name).cpu(), getattr(mc, name), rtol=0, atol=0)
    assert int(m.valid.sum()) > 100


def seeded_corners(b, h, w, k, seed):
    """Corners out of range, at every edge and inside (int32, on the card)."""
    rng = np.random.default_rng(seed)
    x0 = rng.integers(-48, w + 48, (b, k)).astype(np.int32)
    y0 = rng.integers(-48, h + 48, (b, k)).astype(np.int32)
    n = min(k, 6)
    x0[:, :n] = [0, w - 32, -1, w - 31, 2 ** 20, -(2 ** 20)][:n]
    y0[:, :n] = [h - 32, 0, h - 31, -1, -(2 ** 20), 2 ** 20][:n]
    return torch.from_numpy(x0).cuda(), torch.from_numpy(y0).cuda()


@pytest.mark.gpu
# (1, 1080, 1920) x 2000: describe's plane; (3 | 12 | 96, 1080, 1920) x 1000: a frame's,
# the lockstep step's and a chunk's channel planes (max_det corners); (2, 37, 53):
# 4W is not a multiple of 16 bytes, so the register path
@pytest.mark.parametrize("shape,k", [((96, 1080, 1920), 1000), ((2, 37, 53), 130), ((1, 32, 32), 3),
                                     ((12, 1080, 1920), 1000), ((3, 1080, 1920), 1000),
                                     ((1, 1080, 1920), 2000)])
def test_patch_gather_equals_plain_on_card(shape, k):
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(k)
    planes = torch.rand(shape, generator=gen, device="cuda") * 255.0
    x0, y0 = seeded_corners(shape[0], shape[1], shape[2], k, seed=k)
    before = patches.patches32.launches
    out = patches.patches32(planes, x0, y0)
    torch.cuda.synchronize()
    assert patches.patches32.launches == before + 1
    torch.testing.assert_close(out, patches.patches32_torch(planes, x0, y0), rtol=0, atol=0)
    # one (H,W) plane with (K,) int64 corners, some beyond int32, takes the same kernel
    far = torch.tensor([2 ** 40, -(2 ** 40)], device="cuda")
    x_far, y_far = x0[-1].long(), y0[-1].long()
    x_far[:2], y_far[:2] = far, far.flip(0)
    wide = patches.patches32(planes[-1].contiguous(), x_far, y_far)
    torch.testing.assert_close(wide, patches.patches32_torch(planes[-1], x_far, y_far), rtol=0,
                               atol=0)
    one = patches.patches32(planes[-1].contiguous(), x0[-1].long(), y0[-1].long())
    torch.testing.assert_close(one, out[-1], rtol=0, atol=0)
    assert patches.patches32.launches == before + 3


@pytest.mark.gpu
# 36 columns: TMA; 37: 4W is not a multiple of 16 bytes, the register path
@pytest.mark.parametrize("w", [36, 37])
def test_patch_gather_takes_more_planes_than_a_grid_row(w):
    """The flat grid has no 65535-plane cap (a grid y dimension would have one)."""
    _need_card()
    planes = torch.rand((70000, 32, w), device="cuda") * 255.0
    x0, y0 = seeded_corners(70000, 32, w, 2, seed=1)
    torch.testing.assert_close(patches.patches32(planes, x0, y0),
                               patches.patches32_torch(planes, x0, y0), rtol=0, atol=0)


@pytest.mark.gpu
def test_patch_wrapper_rejects_what_the_kernel_does_not_take():
    _need_card()
    planes = torch.zeros((2, 40, 64), device="cuda")
    x0 = torch.zeros((2, 5), dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError):
        patches.patches32(planes.double(), x0, x0)
    with pytest.raises(ValueError):
        patches.patches32(planes.transpose(1, 2), x0, x0)
    with pytest.raises(ValueError):
        patches.patches32(planes[:, :31], x0, x0)
    with pytest.raises(ValueError):
        patches.patches32(planes, x0.cpu(), x0.cpu())


def seeded_image(c, h, w, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 256, (c, h, w, 3))
                            .astype(np.uint8)).cuda()


@pytest.mark.gpu
# (32, 1080, 1920): a chunk's shared half-resolution image; (1 | 4, 2160, 3840): the
# frames of the sequential loop and of a lockstep step, pooled in the kernel; (2, 75, 107):
# 3W is not a multiple of 16 bytes (the register path), H and W odd
@pytest.mark.parametrize("shape,k,pool2", [((32, 1080, 1920), 1000, False),
                                           ((1, 2160, 3840), 1000, True),
                                           ((4, 2160, 3840), 1000, True),
                                           ((2, 75, 107), 130, False), ((2, 75, 107), 130, True)])
@pytest.mark.parametrize("mean4", [False, True])
def test_hwc_gather_equals_plain_on_card(shape, k, pool2, mean4):
    _need_card()
    image = seeded_image(*shape, seed=k + pool2)
    f = 2 if pool2 else 1
    x0, y0 = seeded_corners(shape[0], shape[1] // f, shape[2] // f, k, seed=k)
    before = patches.patches32.launches
    out = patches.patches32_hwc(image, x0, y0, pool2, mean4)
    torch.cuda.synchronize()
    assert patches.patches32.launches == before + 1
    assert out.shape == (shape[0], k, 3) + ((8, 8) if mean4 else (32, 32))
    torch.testing.assert_close(out, patches.patches32_hwc_torch(image, x0, y0, pool2, mean4),
                               rtol=0, atol=0)


@pytest.mark.gpu
def test_hwc_wrapper_rejects_what_the_kernel_does_not_take():
    _need_card()
    image = seeded_image(2, 80, 96, seed=0)
    x0 = torch.zeros((2, 5), dtype=torch.int32, device="cuda")
    before = patches.patches32.launches
    with pytest.raises(TypeError):
        patches.patches32_hwc(image.float(), x0, x0, False, True)
    with pytest.raises(ValueError):
        patches.patches32_hwc(image.transpose(1, 2), x0, x0, False, True)
    with pytest.raises(ValueError):
        patches.patches32_hwc(image, x0.cpu(), x0.cpu(), False, True)
    with pytest.raises(ValueError):
        patches.patches32_hwc(image[:, :62], x0, x0, True, True)  # 31 pooled rows
    assert patches.patches32.launches == before


@pytest.mark.gpu
def test_failing_build_raises(tmp_path, monkeypatch):
    _need_card()
    (tmp_path / "patch_gather.cu").write_text("this is not CUDA C++\n")
    monkeypatch.setattr(_cuda, "CSRC", tmp_path)
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc failed for patch_gather.cu"):
        _cuda.build("patch_gather")


@pytest.mark.gpu
def test_embed_boxes_on_card_equals_cpu():
    _need_card()
    rng = np.random.default_rng(2)
    frames = rng.integers(0, 256, (3, 120, 160, 3)).astype(np.uint8)
    boxes = np.column_stack([rng.uniform(-20, 180, 30), rng.uniform(-20, 140, 30),
                             rng.uniform(8, 40, 30), rng.uniform(8, 40, 30)])
    boxes = boxes.reshape(3, 10, 4).astype(np.float32)
    cpu = embed_boxes(torch.from_numpy(frames), torch.from_numpy(boxes))
    before = patches.patches32.launches
    card = embed_boxes(torch.from_numpy(frames).cuda(), torch.from_numpy(boxes).cuda())
    torch.cuda.synchronize()
    assert patches.patches32.launches == before + 1  # one launch for all frames and channels
    torch.testing.assert_close(card.cpu(), cpu, rtol=0, atol=1e-5)


def _sharpened_detector_model(seed=0):
    """A seeded YOLOv8n whose class scores spread over (0, 1) with boxes
    about one stride wide (as tests/test_torch_cli.py builds it)."""
    from geotrax_tpu_torch.models import yolov8

    spec = yolov8.ModelSpec(variant="n", nc=4)
    model = yolov8.init_params(torch.Generator().manual_seed(seed), spec, device="cpu")
    head = model.layers[str(spec.head_index)]
    with torch.no_grad():
        for k in range(len(spec.strides)):
            head.cv3[k][2].weight *= 100.0
            head.cv3[k][2].bias -= 1.9
            head.cv2[k][2].weight *= 0.05
            b = torch.zeros(4 * spec.reg_max)
            b[0::spec.reg_max] = b[1::spec.reg_max] = 20.0
            head.cv2[k][2].bias.copy_(b)
    return model


@pytest.mark.gpu
def test_clahe_on_card_equals_cpu():
    """CLAHE (plain tensor operations) on the card against the CPU, within
    1e-4 grey levels, at the stable preset's full-resolution 4K gray."""
    _need_card()
    from geotrax_tpu_torch.ops.clahe import clahe

    gray = torch.from_numpy(textured_gray(2, 2160, 3840, 11))
    torch.testing.assert_close(clahe(gray.cuda()).cpu(), clahe(gray), rtol=0, atol=1e-4)
    odd = torch.from_numpy(textured_gray(3, 97, 131, 12))
    torch.testing.assert_close(clahe(odd.cuda()).cpu(), clahe(odd), rtol=0, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("option", [{"tiles": 2, "tile_overlap": 16}, {"half": True}],
                         ids=["tiles", "half"])
def test_detector_option_on_card_equals_cpu(option):
    """Tiles (float32) and half (bfloat16, cuDNN) on the card against the
    port on the CPU: tiles with equal valid slots and classes, boxes within
    1e-3 px and scores within 1e-5; half matched by box within 0.05 px
    (classes equal, scores within 0.02) for every detection scoring more
    than 0.02 above ``conf`` on either side."""
    _need_card()
    from geotrax_tpu_torch.models.detector import Detector

    cfg = {"imgsz": 128, "conf": 0.5, "iou": 0.7, "max_det": 40, **option}
    model = _sharpened_detector_model()
    frames = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (2, 96, 160, 3),
                                                                dtype=np.uint8))
    cpu = Detector(model, cfg, device="cpu").batch_trace(96, 160)(frames)
    card = {k: v.cpu() for k, v in Detector(model, cfg, device="cuda").batch_trace(96, 160)(
        frames.cuda()).items()}
    assert int(cpu["valid"].sum()) > 6
    if "tiles" in option:
        assert torch.equal(card["valid"], cpu["valid"]) and torch.equal(card["classes"], cpu["classes"])
        torch.testing.assert_close(card["boxes_xywh"], cpu["boxes_xywh"], rtol=0, atol=1e-3)
        torch.testing.assert_close(card["scores"], cpu["scores"], rtol=0, atol=1e-5)
        return
    for f in range(2):
        for a, b in ((card, cpu), (cpu, card)):
            va, vb = a["valid"][f], b["valid"][f]
            clear = a["scores"][f][va] > cfg["conf"] + 0.02
            dist = (a["boxes_xywh"][f][va][clear][:, None] - b["boxes_xywh"][f][vb][None]).abs()
            dist = dist.amax(-1)
            match = dist.argmin(1)
            assert len(set(match.tolist())) == len(match) and float(dist.amin(1).max()) <= 0.05
            assert torch.equal(a["classes"][f][va][clear], b["classes"][f][vb][match])
            torch.testing.assert_close(a["scores"][f][va][clear], b["scores"][f][vb][match],
                                       rtol=0, atol=0.02)


@pytest.mark.gpu
def test_pinned_driver_rows_equal_the_serial_loops_on_card():
    """The double-buffered driver (pinned staging, copy stream, events) and
    the serial loop give the same rows bit for bit on the card, over three
    chunks with a padded tail, on the oracle clip with a moving camera."""
    _need_card()
    from geotrax_tpu_torch import cfg as tcfg
    from geotrax_tpu_torch.io.synthetic import SyntheticVideoReader
    from geotrax_tpu_torch.models.detector import OracleDetector
    from geotrax_tpu_torch.pipeline import extract as textract

    def reader():
        return SyntheticVideoReader(width=320, height=240, n_frames=21, camera=(0.5, -0.3, 0.2, 1.002))

    boxes = reader()
    runs = []
    for pipelined in (True, False, True):
        det = OracleDetector(lambda i: [list(b) + [0.9, i % 2] for b in boxes.boxes_at(i)],
                             device="cuda")
        tracker_cfg, state, step, head = textract.make_extract_tracker(tcfg.DEFAULT, device="cuda")
        fx = textract.make_fused_extractor(tcfg.DEFAULT, det, tracker_cfg, state, step, 240, 320,
                                           head, chunk=8, device="cuda")
        runs.append(textract.track_video_fused(reader(), fx, chunk=8, pipelined=pipelined))
    assert runs[0][2]["chunks"] == 3 and len(runs[0][0]) > 20
    for tracks, transforms, _ in runs[1:]:
        np.testing.assert_array_equal(tracks, runs[0][0])
        np.testing.assert_array_equal(transforms, runs[0][1])


def _separated_equal(card, cpu, gap=1e-5, score_rtol=1e-4, desc_atol=1e-4):
    """SIFT features of the card and the CPU: the same pixels where scores
    are separated by more than ``gap`` (relative to the largest; the
    pyramid's resize products add in another order on the card), scores,
    descriptors and angles within the tolerances."""
    sc_cpu = cpu.score.numpy()
    scale = max(float(sc_cpu.max()), 1e-6)
    gaps = np.abs(np.diff(sc_cpu)) > gap * scale
    sep = np.concatenate([[True], gaps]) & np.concatenate([gaps, [True]]) & cpu.valid.numpy()
    assert sep.sum() > 0.8 * cpu.valid.numpy().sum() > 0
    np.testing.assert_array_equal(card.xy.cpu().numpy()[sep], cpu.xy.numpy()[sep])
    np.testing.assert_allclose(card.score.cpu().numpy(), sc_cpu, rtol=score_rtol,
                               atol=score_rtol * scale)
    np.testing.assert_allclose(card.desc.cpu().numpy()[sep], cpu.desc.numpy()[sep], atol=desc_atol)
    dang = card.angle.cpu().numpy()[sep] - cpu.angle.numpy()[sep]
    assert np.abs(np.angle(np.exp(1j * dang))).max() < 1e-3


@pytest.mark.gpu
def test_detect_and_describe_on_card_equals_cpu():
    """RootSIFT on the card against the plain CPU run, with a mask and with
    banding forced on the first level (as on a 15000 px ortho)."""
    _need_card()
    from geotrax_tpu_torch.ops import sift

    # a smooth random field with blocks: few exactly tied DoG scores
    rng = np.random.default_rng(0)
    field = torch.as_tensor(rng.uniform(0, 255, (1, 1, 64, 64)).astype(np.float32))
    gray = torch.nn.functional.interpolate(field, size=(512, 512), mode="bicubic")[0, 0]
    for _ in range(300):
        y, x = rng.integers(0, 500, 2)
        gray[y:y + rng.integers(3, 12), x:x + rng.integers(3, 12)] = float(rng.uniform(0, 255))
    mask = torch.ones(gray.shape, dtype=torch.bool)
    mask[100:300, 50:200] = False
    cpu = sift.detect_and_describe(gray, 6000, mask=mask)
    card = sift.detect_and_describe(gray.cuda(), 6000, mask=mask.cuda())
    _separated_equal(card, cpu)
    limit = sift.BAND_PIXEL_LIMIT
    try:
        sift.BAND_PIXEL_LIMIT = 512 * 512 // 3
        cpu = sift.detect_and_describe(gray, 6000)
        card = sift.detect_and_describe(gray.cuda(), 6000)
    finally:
        sift.BAND_PIXEL_LIMIT = limit
    _separated_equal(card, cpu)


@pytest.mark.gpu
@pytest.mark.parametrize("detector", ["orb", "rsift"])
def test_stabilizer_on_card_equals_cpu(detector):
    """Both branches of the sequential Stabilizer on a pair of views of one
    scene: the card's homography within 0.1 px of the CPU's at the corners,
    inliers within 2 %, boxes within 0.1 px; two FAST launches on the orb
    path."""
    _need_card()
    import chip_smoke
    from geotrax_tpu_torch.stabilize import Stabilizer

    ortho, _ = chip_smoke.synthetic_ortho(1024, rects=400)
    fw, fh = 640, 360
    h_a = chip_smoke.similarity(0.0, 200.0, 300.0, 0, 0) @ np.diag([1.2, 1.2, 1.0])
    h_b = h_a @ chip_smoke.similarity(1.0, 8.0, -5.0, fw / 2, fh / 2)
    dev = torch.as_tensor(ortho)
    ref = chip_smoke.render_frame(dev, h_a, fw, fh, 1.0, 0)
    cur = chip_smoke.render_frame(dev, h_b, fw, fh, 1.0, 1)
    boxes = np.array([[200.0, 150.0, 40.0, 20.0], [420.0, 260.0, 30.0, 50.0]], np.float32)
    cfg = dict(detector_name=detector, max_features=2000 if detector == "orb" else 20000,
               ransac_epipolar_threshold=2.0 if detector == "orb" else 3.0)
    runs = {}
    for device in ("cpu", "cuda"):
        before = fast.fast_score_map.launches
        stab = Stabilizer(**cfg, device=device)
        stab.set_ref_frame(ref, boxes)
        stab.stabilize(cur, boxes)
        runs[device] = (stab, fast.fast_score_map.launches - before)
    (cpu, _), (card, launches) = runs["cpu"], runs["cuda"]
    assert launches == (2 if detector == "orb" else 0)
    assert chip_smoke.corner_error(card.get_cur_trans_matrix(), cpu.get_cur_trans_matrix(),
                                   fw, fh) < 0.1
    assert abs(card.get_cur_inliers_count() - cpu.get_cur_inliers_count()) <= max(
        2, 0.02 * cpu.get_cur_inliers_count())
    np.testing.assert_allclose(card.transform_cur_boxes(), cpu.transform_cur_boxes(), atol=0.1)
    truth = np.linalg.inv(h_a) @ h_b
    assert chip_smoke.corner_error(card.get_cur_trans_matrix(), truth, fw, fh) < 1.0


@pytest.mark.gpu
def test_assign_first_polygon_on_card_equals_cpu():
    _need_card()
    from geotrax_tpu_torch.ops import polygon

    rng = np.random.default_rng(3)
    pts = torch.as_tensor(rng.uniform(0, 1000, (300_000, 2)).astype(np.float32))
    base = rng.uniform(0, 900, (24, 1, 2))
    quads = torch.as_tensor((base + np.array([[0, 0], [0, 60], [90, 64], [88, -3]])
                             + rng.uniform(-4, 4, (24, 4, 2))).astype(np.float32))
    cpu = polygon.assign_first_polygon(pts, quads)
    card = polygon.assign_first_polygon(pts.cuda(), quads.cuda())
    np.testing.assert_array_equal(card.cpu().numpy(), cpu.numpy())
    assert (cpu >= 0).sum() > 1000


def _oracle_sequential(device: str, stabilizer_frames: str = "numpy"):
    """The sequential loop over a 320x240 oracle clip with a moving camera,
    default configuration with ReID, on ``device``."""
    import copy

    from geotrax_tpu_torch import cfg as tcfg
    from geotrax_tpu_torch.io.synthetic import SyntheticVideoReader
    from geotrax_tpu_torch.models.detector import OracleDetector, SequentialOnly
    from geotrax_tpu_torch.pipeline import extract as textract

    config = copy.deepcopy(tcfg.DEFAULT)
    config["tracker"]["botsort"]["with_reid"] = True
    reader = SyntheticVideoReader(width=320, height=240, n_frames=16, camera=(0.5, -0.3, 0.2, 1.002))
    det = OracleDetector(lambda i: [list(b) + [0.9, i % 2] for b in reader.boxes_at(i)],
                         device=device)
    parts = textract.make_extract_tracker(config, device=device)
    return textract.track_video_sequential(reader, SequentialOnly(det), parts, config)


@pytest.mark.gpu
def test_sequential_loop_on_card_equals_cpu():
    """The per-frame loop on the card against the plain CPU run: equal
    frames, ids and classes, geometry within 0.05 px, homographies within
    0.05; FAST and the patch gather launched once per frame (the ReID
    embedding and the single-level Stabilizer)."""
    _need_card()
    cpu = _oracle_sequential("cpu")
    before = (fast.fast_score_map.launches, patches.patches32.launches)
    card = _oracle_sequential("cuda")
    assert (fast.fast_score_map.launches - before[0], patches.patches32.launches - before[1]) \
        == (16, 16)
    (t_card, h_card, _), (t_cpu, h_cpu, _) = card, cpu
    assert t_card.shape == t_cpu.shape and len(t_cpu) > 20
    np.testing.assert_array_equal(t_card[:, [0, 1, 10, 11]], t_cpu[:, [0, 1, 10, 11]])
    np.testing.assert_allclose(t_card[:, 2:10], t_cpu[:, 2:10], rtol=0, atol=0.05)
    np.testing.assert_allclose(h_card, h_cpu, rtol=0, atol=0.05)


@pytest.mark.gpu
def test_rtdetr_l_on_card_equals_cpu():
    """RT-DETR-L at its published widths (seeded random weights) on a seeded
    256x256 image, on the card against the CPU: the forward's boxes within
    1e-2 px and probabilities within 1e-4 (float32 products summed in other
    orders), and the Detector's slots on a 4K frame equal in validity and
    class."""
    _need_card()
    import copy

    from geotrax_tpu_torch.models import rtdetr_ul
    from geotrax_tpu_torch.models.detector import Detector

    gen = torch.Generator().manual_seed(0)
    ul = rtdetr_ul.init_params(gen, rtdetr_ul.ULSpec(nc=4), device="cpu")
    card = copy.deepcopy(ul).cuda()
    x = torch.rand((1, 256, 256, 3), generator=gen)
    with torch.no_grad():
        want = rtdetr_ul.forward(ul, x, ul.spec)
        got = rtdetr_ul.forward(card, x.cuda(), ul.spec)
    for w, g, tol in zip(want, got, (1e-2, 1e-4)):
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=tol)
    frame = np.random.default_rng(0).integers(0, 256, (2160, 3840, 3), np.uint8)
    cfg = {"imgsz": 256, "conf": 0.5}
    a = Detector(card, cfg, device="cuda")(frame)
    b = Detector(ul, cfg, device="cpu")(frame)
    np.testing.assert_array_equal(a["valid"].cpu().numpy(), b["valid"].numpy())
    np.testing.assert_array_equal(a["classes"].cpu().numpy(), b["classes"].numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["bytetrack", "botsort"])
def test_batched_tracker_step_on_card_equals_single_steps(name):
    """The lockstep's batched tracker step (make_batch_tracker) on the card
    against each video's single-timeline step on the card, at the
    lockstep's 1000 slots and detections with ReID and GMC: every output and
    state equal, as on the CPU."""
    _need_card()
    from geotrax_tpu_torch.track import base as tb

    v, m, k = 4, 1000, 1000
    params = {"with_reid": True, "track_buffer": 30}
    _, states, vstep = tb.make_batch_tracker(name, params, v, max_tracks=k, device="cuda")
    singles = [tb.make_tracker(name, params, max_tracks=k, device="cuda") for _ in range(v)]
    single_states = [s for _, s, _ in singles]
    rng = np.random.default_rng(0)
    start = rng.uniform(40, 3800, (v, m, 2)).astype(np.float32)
    vel = rng.uniform(-3, 3, (v, m, 2)).astype(np.float32)
    for t in range(6):
        xy = start + vel * t + rng.normal(0, 0.5, (v, m, 2)).astype(np.float32)
        boxes = np.concatenate([xy, np.full((v, m, 2), [90, 40], np.float32)], -1)
        gmc = np.tile(np.eye(3, dtype=np.float32), (v, 1, 1))
        gmc[:, :2, 2] = rng.normal(0, 1, (v, 2))
        ins = [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in (
            boxes, rng.uniform(0.05, 1, (v, m)).astype(np.float32),
            rng.integers(0, 4, (v, m)).astype(np.int32), rng.uniform(0, 1, (v, m)) > 0.2, gmc,
            rng.normal(0, 1, (v, m, tb.EMB_DIM)).astype(np.float32))]
        alive = torch.tensor([True, True, True, t < 4], device="cuda")
        states, out = vstep(states, *ins[:4], t + 1, alive, ins[4], ins[5])
        for i in range(v):
            if not bool(alive[i]):
                continue
            single_states[i], one = singles[i][2](single_states[i], *(x[i] for x in ins[:4]),
                                                  t + 1, ins[4][i], ins[5][i])
            for x, y in zip(one, (f[i] for f in out)):
                torch.testing.assert_close(y, x, rtol=0, atol=0)
    for i in range(v):
        for x, y in zip(single_states[i], (f[i] for f in states)):
            torch.testing.assert_close(y, x, rtol=0, atol=0)


@pytest.mark.gpu
def test_warp_on_card_equals_cpu_on_a_4k_frame():
    """The visualize stage's frame warp (modes 1 and 4) on one 3840x2160
    frame: the card's output within one grey level of the CPU's through the
    same host-side float32 inverse (in practice equal)."""
    _need_card()
    from geotrax_tpu_torch.ops.warp import invert_homography, warp_perspective

    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (2160, 3840, 3)).astype(np.uint8)
    hm = np.array([[1.0002, 0.012, 14.5], [-0.011, 0.9998, -7.25], [2e-7, -1e-7, 1.0]], np.float32)
    h_inv = invert_homography(hm)
    cpu = warp_perspective(torch.from_numpy(img), h_inv, 2160, 3840).numpy()
    card = warp_perspective(torch.from_numpy(img).cuda(), h_inv, 2160, 3840).cpu().numpy()
    assert card.dtype == np.uint8 and card.shape == img.shape
    assert np.abs(card.astype(int) - cpu.astype(int)).max() <= 1


@pytest.mark.gpu
def test_mode_1_render_on_card_equals_cpu(tmp_path, monkeypatch):
    """One mode-1 render (warp on the device, drawing on the host) of a
    drifting 640x360 clip, frames in memory, captured before the encoder:
    the card's frames within one grey level of the CPU's."""
    _need_card()
    import chip_smoke
    from geotrax_tpu_torch.io.synthetic import SyntheticVideoReader
    from geotrax_tpu_torch.pipeline import visualize

    reader = SyntheticVideoReader(width=640, height=360, n_frames=8, seed=3,
                                  camera=chip_smoke.CAMERA,
                                  boxes=chip_smoke.vehicle_boxes(640, 360, 6, 3))
    frames = chip_smoke.make_frames(reader)
    source = tmp_path / "R_clip.mp4"
    source.write_bytes(b"x")
    (tmp_path / "results").mkdir()
    tracks, transforms = chip_smoke.render_tracks(reader, 8)
    np.savetxt(tmp_path / "results" / "R_clip.txt", tracks, fmt="%.6g", delimiter=",")
    np.savetxt(tmp_path / "results" / "R_clip_vid_transf.txt", transforms, fmt="%.16g",
               delimiter=",")
    out = {}
    for device in ("cpu", "cuda"):
        sink = chip_smoke.FrameSink(keep_all=True)
        with chip_smoke.InMemoryVisualize({source.name: (reader.info, frames)},
                                          lambda *a, s=sink: s):
            stats = visualize.visualize_results(
                chip_smoke.visualize_args(source, 1, device, tmp_path / "logs"),
                chip_smoke.port_extract._LOG)
        assert stats[0]["frames"] == 8 and stats[0]["warped"] == 7
        out[device] = sink.frames
    for a, b in zip(out["cuda"], out["cpu"]):
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


# ---------------------------------------------------------------- training
TRAIN_LOSS_RTOL = 1e-4   # the card's float32 convolutions (TF32 off) sum in other orders
TRAIN_GRAD_REL_L2 = 1e-4  # the card's gradients against float64
# (the port's entry points turn TF32 off through resolve_device; so do these)


def train_batch(b, imgsz, g, seed):
    """Letterboxed images (a 114 border above and below) and large GT boxes
    (random-init predictions are ~15 strides wide), padded rows masked."""
    rng = np.random.default_rng(seed)
    img = np.full((b, imgsz, imgsz, 3), 114, np.uint8)
    img[:, imgsz // 5: imgsz - imgsz // 5] = rng.integers(0, 256, (b, imgsz - 2 * (imgsz // 5),
                                                                   imgsz, 3))
    xy = rng.uniform(0.3 * imgsz, 0.7 * imgsz, (b, g, 2))
    wh = rng.uniform(0.2 * imgsz, 0.6 * imgsz, (b, g, 2))
    mask = np.zeros((b, g), bool)
    mask[:, : g - 2] = True
    return (img.astype(np.float32) / 255.0, np.concatenate([xy, wh], -1).astype(np.float32),
            rng.integers(0, 2, (b, g)).astype(np.int32), mask)


def rel_l2(a, b):
    return float(torch.linalg.norm(a.cpu() - b.cpu()) / max(float(torch.linalg.norm(b.cpu())),
                                                            1e-30))


@pytest.mark.gpu
@pytest.mark.parametrize("variant,imgsz", [("n", 128), ("s", 320)])
def test_detection_loss_gradients_card_vs_cpu(variant, imgsz):
    """The loss on the card against the CPU's, and every parameter's
    gradient on the card against the CPU's in float64 (relative L2 of the
    parameter's norm, or of 1e-6 of the whole gradient's where larger; the
    CPU's float32 convolutions can be further off than the card)."""
    _need_card()
    import copy

    from geotrax_tpu_torch.models import yolov8
    from geotrax_tpu_torch.models.convert import param_leaves
    from geotrax_tpu_torch.models.loss import detection_loss

    spec = yolov8.ModelSpec(variant=variant, nc=2)
    cpu = yolov8.init_params(torch.Generator().manual_seed(3), spec, device="cpu")
    batch = train_batch(2, imgsz, 8, seed=imgsz)
    out = []
    card = copy.deepcopy(cpu).to(resolve_device("cuda"))
    for model in (cpu, card, copy.deepcopy(cpu).double()):
        model.requires_grad_(True)
        p0 = next(model.parameters())
        images, boxes, cls, mask = (torch.from_numpy(x).to(p0.device) for x in batch)
        loss, metrics = detection_loss(model, images.to(p0.dtype), boxes.to(p0.dtype), cls, mask,
                                       spec)
        loss.backward()
        out.append((float(loss.detach()), int(metrics["fg"]),
                    [p.grad.detach().cpu().double() for p in param_leaves(model)]))
    (l_cpu, fg_cpu, _), (l_card, fg_card, g_card), (_, fg_64, g_64) = out
    assert fg_card == fg_cpu == fg_64 > 0
    assert abs(l_card - l_cpu) <= TRAIN_LOSS_RTOL * abs(l_cpu)
    floor = 1e-6 * float(torch.linalg.norm(torch.cat([g.flatten() for g in g_64])))
    for a, b in zip(g_card, g_64):
        err = float(torch.linalg.norm(a - b)) / max(float(torch.linalg.norm(b)), floor)
        assert err <= TRAIN_GRAD_REL_L2


@pytest.mark.gpu
def test_train_step_card_vs_cpu():
    """Two steps of make_train_step (loss, backward, the SGD update) on the
    card and on the CPU from the same weights: losses and weights agree."""
    _need_card()
    import copy

    from geotrax_tpu_torch.models import yolov8
    from geotrax_tpu_torch.models.convert import param_leaves
    from geotrax_tpu_torch.parallel.mesh import make_train_step
    from geotrax_tpu_torch.train.optim import SGD, build_lr_schedule

    spec = yolov8.ModelSpec(variant="n", nc=2)
    cpu = yolov8.init_params(torch.Generator().manual_seed(4), spec, device="cpu")
    card = copy.deepcopy(cpu).to(resolve_device("cuda"))
    optimizer = SGD(build_lr_schedule(0.01, 0.01, 1, 10, False))
    step = make_train_step(spec, optimizer)
    batches = [train_batch(2, 128, 6, seed=s) for s in (1, 2)]
    losses, weights = [], []
    for model in (cpu, card):
        model.requires_grad_(True)
        dev = next(model.parameters()).device
        state = optimizer.init(param_leaves(model))
        run = []
        for batch in batches:
            b = dict(zip(("images", "gt_boxes", "gt_cls", "gt_mask"),
                         (torch.from_numpy(x).to(dev) for x in batch)))
            state, metrics = step(model, state, b)
            run.append(float(metrics["loss"]))
        assert state.count == 2
        losses.append(run)
        weights.append([p.detach().cpu() for p in param_leaves(model)])
    for a, b in zip(losses[1], losses[0]):
        assert abs(a - b) <= TRAIN_LOSS_RTOL * abs(b)
    for a, b in zip(weights[1], weights[0]):
        assert rel_l2(a, b) <= TRAIN_LOSS_RTOL


@pytest.mark.gpu
def test_two_gloo_ranks_sharing_the_card(tmp_path):
    """The data-parallel step of two ranks that share the card (gloo, as
    NCCL refuses two ranks on one GPU; tests/torch_mesh_worker.py spawned)
    against one rank: the ranks bit-equal, the losses and the momentum
    within TRAIN_LOSS_RTOL of the one-rank run."""
    _need_card()
    import subprocess
    import sys
    from pathlib import Path

    from geotrax_tpu_torch.models import yolov8
    from geotrax_tpu_torch.models.convert import save_npz

    spec = yolov8.ModelSpec(variant="n", nc=2)
    save_npz(tmp_path / "init.npz", yolov8.init_params(torch.Generator().manual_seed(5), spec,
                                                       device="cpu"))
    keys = ("images", "gt_boxes", "gt_cls", "gt_mask")
    np.savez(tmp_path / "batches.npz", **{f"{k}_{i}": v for i, s in enumerate((1, 2))
                                          for k, v in zip(keys, train_batch(4, 256, 6, seed=s))})
    worker = Path(__file__).resolve().parent / "torch_mesh_worker.py"
    runs = {}
    for world in (1, 2):
        out = tmp_path / f"w{world}"
        out.mkdir()
        proc = subprocess.run([sys.executable, str(worker), str(tmp_path / "init.npz"),
                               str(tmp_path / "batches.npz"), str(out), "--world", str(world),
                               "--device", "cuda:0", "--backend", "gloo"],
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
        runs[world] = [dict(np.load(out / f"rank{r}.npz")) for r in range(world)]
    one, (a, b) = runs[1][0], runs[2]
    for k in a:
        if not k.startswith("rows_"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for i in range(2):
        assert abs(float(a[f"loss_{i}"]) - float(one[f"loss_{i}"])) <= \
            TRAIN_LOSS_RTOL * abs(float(one[f"loss_{i}"]))
    traces = [k for k in a if k.startswith("trace_")]
    assert traces and all(rel_l2(torch.from_numpy(a[k]), torch.from_numpy(one[k]))
                          <= TRAIN_LOSS_RTOL for k in traces)


@pytest.mark.gpu
def test_detection_over_two_devices_on_card_bit_equal():
    """make_inference_step over [cuda:0] and [cuda:0, cuda:0], and
    make_tiled_detector with 2 tiles with and without devices: bit-equal."""
    _need_card()
    from geotrax_tpu_torch.models import yolov8
    from geotrax_tpu_torch.parallel.mesh import make_inference_step
    from geotrax_tpu_torch.parallel.tiling import make_tiled_detector

    dev = resolve_device("cuda")
    spec = yolov8.ModelSpec(variant="n", nc=4)
    model = yolov8.init_params(torch.Generator().manual_seed(0), spec, device=dev)
    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.uniform(0, 1, (8, 320, 512, 3)).astype(np.float32)).to(dev)
    kw = dict(conf=0.05, max_det=100)
    one = make_inference_step(spec, [dev], **kw)(model, imgs)
    two = make_inference_step(spec, [dev, dev], **kw)(model, imgs)
    assert int(one["valid"].sum()) > 0
    for k in one:
        torch.testing.assert_close(two[k], one[k], rtol=0, atol=0, msg=k)
    frame = torch.from_numpy(rng.integers(0, 255, (540, 960, 3), np.uint8)).to(dev)
    tkw = dict(n_tiles=2, src_h=540, src_w=960, imgsz=480, conf=0.05, max_det=100)
    plain = make_tiled_detector(model, spec, **tkw)(frame)
    spread = make_tiled_detector(model, spec, devices=[dev, dev], **tkw)(frame)
    for k in plain:
        torch.testing.assert_close(spread[k], plain[k], rtol=0, atol=0, msg=k)


def _auction_cost(case):
    """(cost, max_iters) of one of the smoke's auction shapes, made from a
    seed: masked_assignment's padded costs of tracker-like inputs (the
    default 1000 slots against 1000 detections, the lockstep's four, a
    max_det of 13000 against 1024 slots),
    tie-heavy integer costs, a cap that is hit, odd shapes, RT-DETR's
    matcher."""
    import chip_smoke

    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    if case in ("default", "lockstep", "max_det 13000"):
        lead, k, m, seed = {"default": ((), 1000, 1000, 1), "lockstep": ((4,), 1000, 1000, 2),
                            "max_det 13000": ((), 1024, 13000, 3)}[case]
        inputs = chip_smoke.tracker_inputs(lead, k, m, int(0.8 * k), int(0.9 * m), seed, dev)
        return chip_smoke.padded_cost(*inputs, chip_smoke.AUCTION_THRESHOLD), 512
    if case == "RT-DETR matcher":
        cost = torch.from_numpy(rng.uniform(-5, 10, (8, 36, 300)).astype(np.float32)).to(dev)
        gt = torch.from_numpy(rng.uniform(size=(8, 36)) < 0.8).to(dev)
        return chip_smoke.padded_cost(cost, gt, torch.ones((8, 300), dtype=torch.bool,
                                                           device=dev), 30.0), 512
    if case == "integer ties":
        return torch.from_numpy(rng.integers(0, 4, (256, 512)).astype(np.float32)).to(dev), 512
    if case == "cap hit":
        return torch.from_numpy(rng.uniform(0, 1, (300, 300)).astype(np.float32)).to(dev), 8
    shape = tuple(int(x) for x in case.split()[1].split("x"))
    return torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32)).to(dev), 512


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["default", "lockstep", "max_det 13000", "RT-DETR matcher",
                                  "integer ties", "cap hit", "odd 1x2", "odd 3x7", "odd 37x90"])
def test_auction_kernel_equals_plain_on_card(case):
    """csrc/auction.cu against auction_assignment_torch at the smoke's
    shapes, bit for bit (max_det 13000's state in the cluster's shared memory);
    one launch per call, and its statistics (rounds, bidder rows) in range."""
    _need_card()
    from geotrax_tpu_torch.ops import assignment

    cost, max_iters = _auction_cost(case)
    stats = torch.empty(cost.shape[:-2] + (2,), dtype=torch.int64, device="cuda")
    before = assignment.auction_assignment.launches
    out = assignment.auction_assignment(cost, max_iters=max_iters, stats=stats)
    torch.cuda.synchronize()
    assert assignment.auction_assignment.launches == before + 1
    plain = assignment.auction_assignment_torch(cost, max_iters=max_iters)
    torch.testing.assert_close(out, plain, rtol=0, atol=0)
    rounds, bids = stats[..., 0], stats[..., 1]
    n = cost.shape[-2]
    assert bool((rounds >= 1).all()) and bool((rounds <= max_iters).all())
    assert bool((bids >= n).all()) and bool((bids <= rounds * n).all())
    if case == "cap hit":
        assert bool((plain < 0).any()) and bool((rounds == max_iters).all())


def _cluster_cost(case):
    """A (..., N, M) cost, made from a seed, that drives one part of the
    cluster design: later rounds with more bidders than the cluster has warps
    (uniform costs, many first-round collisions) or fewer (each row has its
    own cheap column but 40 rows share 10), N not a multiple of a block's
    rows, M not a multiple of 4, a base not 16-byte aligned, a batch of 4,
    and a state past shared memory (60000 columns of prices, 64 rows that
    want the same 8 columns, so several rounds run there)."""
    rng = np.random.default_rng(23)
    if case == "more bidders than warps":
        cost = rng.uniform(0, 1, (1000, 1000))
    elif case == "fewer bidders than warps":
        cost = rng.uniform(0.5, 1.0, (1000, 2000))
        cost[np.arange(1000), np.arange(1000)] = 0.0
        cost[np.arange(40), np.arange(40)] = 0.9
        cost[np.arange(40), np.arange(40) // 4] = 0.0
    elif case == "N not a multiple of a block's rows":
        cost = rng.uniform(0, 1, (1001, 2000))
    elif case == "M not a multiple of 4":
        cost = rng.uniform(0, 1, (1000, 2003))
    elif case == "base not 16-byte aligned":
        flat = torch.from_numpy(rng.uniform(0, 1, 1000 * 2000 + 1).astype(np.float32)).cuda()
        return flat[1:].view(1000, 2000)
    elif case == "batch of 4":
        cost = rng.uniform(0, 1, (4, 500, 1000))
    else:  # state in device memory
        cost = rng.uniform(0, 1, (256, 60000))
        cost[:64, :8] = 0.0
    return torch.from_numpy(cost.astype(np.float32)).cuda()


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["more bidders than warps", "fewer bidders than warps",
                                  "N not a multiple of a block's rows", "M not a multiple of 4",
                                  "base not 16-byte aligned", "batch of 4",
                                  "state in device memory"])
def test_auction_cluster_cases_equal_plain_on_card(case):
    """The two kernels (first round over the card, later rounds in a cluster
    per problem) bit-equal to auction_assignment_torch where each part of the
    design is driven; one wrapper call per auction."""
    _need_card()
    from geotrax_tpu_torch.ops import assignment

    cost = _cluster_cost(case)
    plan = assignment.plan_of(cost)
    n = cost.shape[-2]
    warps = plan.cluster * 16
    second = int((assignment.auction_assignment_torch(cost, max_iters=1) < 0).sum())
    if case == "more bidders than warps":
        assert second > warps, (second, plan)
    if case == "fewer bidders than warps":
        assert 0 < second < warps, (second, plan)
    if case == "N not a multiple of a block's rows":
        assert n % plan.rows != 0 and plan.cluster > 1, plan
    if case == "base not 16-byte aligned":
        assert cost.data_ptr() % 16 != 0 and cost.is_contiguous()
    assert plan.shared == (case != "state in device memory"), plan
    stats = torch.empty(cost.shape[:-2] + (2,), dtype=torch.int64, device="cuda")
    before = assignment.auction_assignment.launches
    out = assignment.auction_assignment(cost, stats=stats)
    torch.cuda.synchronize()
    assert assignment.auction_assignment.launches == before + 1
    torch.testing.assert_close(out, assignment.auction_assignment_torch(cost), rtol=0, atol=0)
    assert int(stats[..., 0].max()) >= (2 if second else 1)
    assert bool((stats[..., 1] >= n).all())


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["default", "integer ties", "state in device memory"])
def test_auction_call_captured_in_a_cuda_graph_replays(case):
    """One call captured in a CUDA graph and replayed twice gives the eager
    call's answer each time; with other costs copied into the captured input
    a replay gives their answer: the kernels reset their own keys and
    counters, and the wrapper reads nothing back."""
    _need_card()
    from geotrax_tpu_torch.ops import assignment

    if case == "default":
        cost, _ = _auction_cost("default")
        other, _ = _auction_cost("lockstep")
        other = other[0].contiguous()
    elif case == "integer ties":  # 21 rounds
        cost, _ = _auction_cost(case)
        other = (3.0 - cost).contiguous()
    else:
        cost = _cluster_cost(case)
        other = torch.flip(cost, (1,)).contiguous()
    eager = assignment.auction_assignment(cost)
    expected_other = assignment.auction_assignment(other)
    held = cost.clone()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = assignment.auction_assignment(held)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        torch.testing.assert_close(captured, eager, rtol=0, atol=0)
    held.copy_(other)
    graph.replay()
    torch.cuda.synchronize()
    torch.testing.assert_close(captured, expected_other, rtol=0, atol=0)
    torch.testing.assert_close(eager, assignment.auction_assignment_torch(cost), rtol=0, atol=0)


@pytest.mark.gpu
def test_auction_wrapper_rejects_what_the_kernel_does_not_take():
    _need_card()
    from geotrax_tpu_torch.ops import assignment

    c = torch.rand((6, 10), device="cuda")
    with pytest.raises(TypeError):
        assignment.auction_assignment(c.double())
    with pytest.raises(ValueError):
        assignment.auction_assignment(torch.rand((10, 6), device="cuda").t())  # not contiguous
    with pytest.raises(ValueError):
        assignment.auction_assignment(c.t().contiguous())  # N > M
    with pytest.raises(ValueError):
        assignment.auction_assignment(c[0])
    with pytest.raises(ValueError):
        assignment.auction_assignment(c, stats=torch.empty((3,), dtype=torch.int64,
                                                           device="cuda"))
    assert assignment.auction_assignment(torch.rand((3, 0, 7), device="cuda")).shape == (3, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("name,overrides", [("botsort", {}), ("botsort", {"with_reid": True}),
                                            ("bytetrack", {})])
def test_chunk_tracker_reads_nothing_back_on_card(name, overrides):
    """The fused chunk step's tracker (botsort with GMC, with ReID, and
    bytetrack) runs under torch.cuda.set_sync_debug_mode("error"): no torch
    operation of it waits for the card; the auction kernel launches three
    times a frame and its plain version never."""
    _need_card()
    import chip_smoke
    from geotrax_tpu_torch import cfg as port_cfg
    from geotrax_tpu_torch.io.synthetic import SyntheticVideoReader
    from geotrax_tpu_torch.models.detector import OracleDetector
    from geotrax_tpu_torch.ops import assignment
    from geotrax_tpu_torch.pipeline import extract as port_extract

    reader = SyntheticVideoReader(width=320, height=240, n_frames=12,
                                  camera=(0.5, -0.3, 0.2, 1.002))
    det = OracleDetector(lambda i: [list(b) + [0.9, i % 2] for b in reader.boxes_at(i)],
                         device="cuda")
    config = port_cfg.load_config()
    config["tracker"]["active"] = name
    config["tracker"][name].update(overrides)
    tracker_cfg, state, step, head = port_extract.make_extract_tracker(config, device="cuda")
    fx = port_extract.make_fused_extractor(config, det, tracker_cfg, state, step, 240, 320,
                                           head, chunk=4, device="cuda")
    chip_smoke.reset_auction_counts()
    with tempfile.TemporaryDirectory() as tmp, chip_smoke.tracker_reads_checked(fx, "cuda") as seen:
        stats = port_extract.extract(reader, fx, tmp, "V_sync", config=config, chunk=4)
    torch.cuda.synchronize()
    assert seen["chunks"] == 3 and stats["chunks"] == 3
    assert assignment.auction_assignment.launches == 3 * 12
    assert assignment.auction_assignment_torch.calls == 0


# The NMS kernel's cases: (batch, candidates, vehicles, max_det, classes) of
# chip_smoke.nms_candidates (4 anchors a vehicle), or a chain of boxes.
NMS_CASES = {
    "chunk (32, 2000)": (32, 2000, 250, 1000, 0),   # the default chunk, max_det 1000
    "lockstep (4, 2000)": (4, 2000, 250, 1000, 0),
    "frame (1, 2000)": (1, 2000, 250, 1000, 0),
    "evaluate (8, 1024)": (8, 1024, 256, 300, 4),   # per class, every candidate alive
    "chain of 2000": None,
    "odd 1": (1, 1, 1, 5, 2),
    "odd 3": (1, 3, 1, 9, 2),
    "odd 37": (1, 37, 12, 77, 2),
}


def _nms_inputs(case):
    """(boxes, scores, class ids or None, max_det, agnostic) of a case, on the card."""
    import chip_smoke

    if NMS_CASES[case] is None:
        boxes, scores, _ = chip_smoke.nms_chain(2000, "cuda")
        return boxes, scores, None, 1000, True
    b, n, objects, max_det, classes = NMS_CASES[case]
    boxes, scores, cls = chip_smoke.nms_candidates(b, n, objects, 4, 20 + n, "cuda",
                                                   classes=classes,
                                                   conf=0.001 if classes == 4 else 0.25)
    return boxes, scores, cls, max_det, not classes


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(NMS_CASES))
def test_nms_kernel_equals_plain_on_card(case):
    """csrc/nms.cu (through ``nms``: one launch) gives nms_torch's
    (keep_indices, valid) bit for bit at every detecting path's shape, on a
    chain as deep as its 2000 boxes, and with fewer candidates than slots."""
    _need_card()
    from geotrax_tpu_torch.ops import nms as nms_ops

    boxes, scores, cls, max_det, agnostic = _nms_inputs(case)
    before = nms_ops.nms_sorted.launches
    keep, valid = nms_ops.nms(boxes, scores, 0.7, max_det, class_ids=cls, agnostic=agnostic)
    torch.cuda.synchronize()
    assert nms_ops.nms_sorted.launches == before + 1
    plain_keep, plain_valid = nms_ops.nms_torch(boxes, scores, 0.7, max_det, class_ids=cls,
                                                agnostic=agnostic)
    torch.testing.assert_close(valid, plain_valid, rtol=0, atol=0)
    torch.testing.assert_close(keep, plain_keep, rtol=0, atol=0)
    if case == "chain of 2000":
        assert int(valid.sum()) == 1000
        torch.testing.assert_close(keep[0], torch.arange(0, 2000, 2, device="cuda"), rtol=0,
                                   atol=0)
    if case == "evaluate (8, 1024)":
        assert bool((scores > 0).all())


@pytest.mark.gpu
def test_nms_single_image_and_threshold_bits_on_card():
    """One image's (N, 4) / (N,) arguments, and thresholds that sit on an
    IoU's float32 value (the threshold is compared in float32, as torch
    compares it), equal the plain version."""
    _need_card()
    import chip_smoke
    from geotrax_tpu_torch.ops import nms as nms_ops
    from geotrax_tpu_torch.ops.boxes import iou_matrix

    boxes, scores, _ = chip_smoke.nms_candidates(1, 500, 80, 4, 3, "cuda")
    iou = iou_matrix(boxes[0], boxes[0])
    exact = float(iou[iou > 0.3].min())  # an IoU the data holds exactly
    for t in (0.7, 0.45, exact, float(np.nextafter(np.float32(exact), np.float32(0)))):
        keep, valid = nms_ops.nms(boxes[0], scores[0], t, 300)
        plain_keep, plain_valid = nms_ops.nms_torch(boxes[0], scores[0], t, 300)
        assert keep.shape == (300,)
        torch.testing.assert_close(valid, plain_valid, rtol=0, atol=0)
        torch.testing.assert_close(keep, plain_keep, rtol=0, atol=0)


@pytest.mark.gpu
def test_nms_takes_strided_candidates_on_card():
    """Candidates in another memory order (a column-major batch, as numpy's
    fancy indexing makes them) and class ids as int64 give the plain
    version's answer: the wrapper hands the kernel contiguous copies."""
    _need_card()
    from geotrax_tpu_torch.ops import nms as nms_ops

    boxes, scores, cls, max_det, _ = _nms_inputs("evaluate (8, 1024)")
    boxes_t = boxes.permute(2, 1, 0).contiguous().permute(2, 1, 0)
    scores_t = scores.t().contiguous().t()
    assert not boxes_t.is_contiguous() and not scores_t.is_contiguous()
    keep, valid = nms_ops.nms(boxes_t, scores_t, 0.7, max_det, class_ids=cls.long(),
                              agnostic=False)
    plain_keep, plain_valid = nms_ops.nms_torch(boxes, scores, 0.7, max_det, class_ids=cls,
                                                agnostic=False)
    torch.testing.assert_close(valid, plain_valid, rtol=0, atol=0)
    torch.testing.assert_close(keep, plain_keep, rtol=0, atol=0)


@pytest.mark.gpu
def test_nms_call_captured_in_a_cuda_graph_replays():
    """One call captured in a CUDA graph and replayed gives the eager
    answer, and with other candidates copied into the captured inputs
    their answer: the call reads nothing back."""
    _need_card()
    from geotrax_tpu_torch.ops import nms as nms_ops

    boxes, scores, _, max_det, _ = _nms_inputs("chunk (32, 2000)")
    other_boxes, other_scores, _, _, _ = _nms_inputs("lockstep (4, 2000)")
    other_boxes, other_scores = other_boxes.repeat(8, 1, 1), other_scores.repeat(8, 1)
    eager = nms_ops.nms(boxes, scores, 0.7, max_det)
    expected = nms_ops.nms(other_boxes, other_scores, 0.7, max_det)
    held_boxes, held_scores = boxes.clone(), scores.clone()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = nms_ops.nms(held_boxes, held_scores, 0.7, max_det)
    graph.replay()
    torch.cuda.synchronize()
    for got, want in zip(captured, eager):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    held_boxes.copy_(other_boxes)
    held_scores.copy_(other_scores)
    graph.replay()
    torch.cuda.synchronize()
    for got, want in zip(captured, expected):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.gpu
def test_nms_wrapper_rejects_what_the_kernel_does_not_take():
    """Types, shapes, layouts and sizes the kernel does not take raise a
    ValueError that names them, before any launch; nothing falls back to
    the plain version."""
    _need_card()
    from geotrax_tpu_torch.ops import nms as nms_ops

    boxes, scores, _ = torch.rand((2, 50, 4), device="cuda"), torch.rand((2, 50), device="cuda"), None
    order, sb, ss = nms_ops.sorted_candidates(boxes, scores, None, True)
    launches, calls = nms_ops.nms_sorted.launches, nms_ops.nms_torch.calls
    with pytest.raises(ValueError, match="float32"):
        nms_ops.nms(boxes.double(), scores.double(), 0.7, 10)
    with pytest.raises(ValueError, match="float32"):
        nms_ops.nms(boxes.half(), scores, 0.7, 10)
    with pytest.raises(ValueError, match=r"\(B, N, 4\)"):
        nms_ops.nms(boxes[..., :3], scores, 0.7, 10)
    with pytest.raises(ValueError, match="int64 order"):
        nms_ops.nms_sorted(sb, ss, order.int(), 0.7, 10)
    with pytest.raises(ValueError, match="contiguous"):
        nms_ops.nms_sorted(sb.transpose(0, 1).contiguous().transpose(0, 1), ss, order, 0.7, 10)
    with pytest.raises(ValueError, match="16-byte"):
        flat = torch.empty(2 * 50 * 4 + 1, device="cuda")
        nms_ops.nms_sorted(flat[1:].view(2, 50, 4), ss, order, 0.7, 10)
    big = nms_ops.MAX_CANDIDATES + 1
    with pytest.raises(ValueError, match="at most"):
        nms_ops.nms_sorted(torch.zeros((1, big, 4), device="cuda"),
                           torch.zeros((1, big), device="cuda"),
                           torch.zeros((1, big), dtype=torch.int64, device="cuda"), 0.7, 10)
    assert nms_ops.nms_sorted.launches == launches and nms_ops.nms_torch.calls == calls
    keep, valid = nms_ops.nms(torch.zeros((3, 0, 4), device="cuda"),
                              torch.zeros((3, 0), device="cuda"), 0.7, 4)
    assert keep.shape == (3, 4) and not valid.any() and not keep.any()


# The fused post-processing's cases: the NMS kernel's, and the chunk's
# candidates with fewer slots than they keep.
TOPK_CASES = list(NMS_CASES) + ["max_det under the kept (32, 2000)"]


def _topk_inputs(case):
    """(postprocess_topk's arguments, its plain version's answer) of a case."""
    import chip_smoke
    from geotrax_tpu_torch.ops import nms as nms_ops

    max_det_cut = case == TOPK_CASES[-1]
    boxes, scores, cls, max_det, agnostic = _nms_inputs("chunk (32, 2000)" if max_det_cut
                                                        else case)
    if max_det_cut:
        max_det = 100
    args = (*chip_smoke.topk_inputs(boxes, scores, cls, max_det), 0.7, max_det, agnostic)
    return args, nms_ops.postprocess_topk_torch(*args)


@pytest.mark.gpu
@pytest.mark.parametrize("case", TOPK_CASES)
def test_postprocess_topk_equals_plain_on_card(case):
    """The fused post-processing (csrc/nms.cu's nms_topk: gathers, corners,
    the per-class offset, NMS, the detections; one launch) gives the plain
    chain's detections bit for bit at every detecting path's shape, on a
    chain of 2000, with fewer candidates than slots and with more kept
    candidates than slots."""
    _need_card()
    import chip_smoke
    from geotrax_tpu_torch.ops import nms as nms_ops

    args, plain = _topk_inputs(case)
    before, sorted_before = nms_ops.postprocess_topk.launches, nms_ops.nms_sorted.launches
    out = nms_ops.postprocess_topk(*args)
    torch.cuda.synchronize()
    assert nms_ops.postprocess_topk.launches == before + 1
    assert nms_ops.nms_sorted.launches == sorted_before
    assert chip_smoke.topk_equal(out, plain)
    kept = int(plain["valid"].sum(dim=-1).max())
    if case == TOPK_CASES[-1]:
        assert kept == 100 and bool(plain["valid"].all())
    assert out["classes"].dtype == torch.int32 and bool((out["classes"][~out["valid"]] == -1).all())


@pytest.mark.gpu
@pytest.mark.parametrize("agnostic", [True, False])
def test_postprocess_detections_one_launch_on_card_equals_the_cpu(agnostic):
    """postprocess_detections on the card (a batch of head outputs with a
    class mask) launches the fused kernel once and nothing else of
    csrc/nms.cu, runs no plain version, and gives the CPU's detections bit
    for bit."""
    _need_card()
    import chip_smoke
    from geotrax_tpu_torch.ops import nms as nms_ops

    rng = np.random.default_rng(5)
    boxes, _, _ = chip_smoke.nms_candidates(4, 8400, 600, 4, 5, "cpu")
    xywh = torch.cat([(boxes[..., :2] + boxes[..., 2:]) / 2, boxes[..., 2:] - boxes[..., :2]], -1)
    probs = torch.from_numpy((rng.uniform(0, 1, (4, 8400, 4)) ** 6).astype(np.float32))
    mask = torch.tensor([True, True, False, True])
    cpu = nms_ops.postprocess_detections(xywh, probs, 0.25, 0.7, 300, mask, agnostic=agnostic)
    launches, sorted_launches = nms_ops.postprocess_topk.launches, nms_ops.nms_sorted.launches
    calls = nms_ops.nms_torch.calls
    card = nms_ops.postprocess_detections(xywh.cuda(), probs.cuda(), 0.25, 0.7, 300, mask.cuda(),
                                          agnostic=agnostic)
    torch.cuda.synchronize()
    assert nms_ops.postprocess_topk.launches == launches + 1
    assert nms_ops.nms_sorted.launches == sorted_launches and nms_ops.nms_torch.calls == calls
    assert int(cpu["valid"].sum()) > 100
    assert chip_smoke.topk_equal({k: v.cpu() for k, v in card.items()}, cpu)


# The CPU tests' odd post-processing cases (tests/test_torch_nms.py:topk_case),
# made here without JAX: tied scores, and NaN and infinite box coordinates.
ODD_TOPK_CASES = ["tied scores", "nan and inf boxes"]


def _odd_topk_inputs(case, agnostic):
    """postprocess_topk's arguments of an odd case on the card: two images
    of 1500 seeded anchors in four classes, max_det 1000 (K = 1500)."""
    import chip_smoke

    boxes, scores, cls = chip_smoke.nms_candidates(2, 1500, 120, 4, 21, "cpu", classes=4)
    if case == "tied scores":
        rng = np.random.default_rng(3)
        scores = torch.from_numpy(rng.choice(np.float32([0.0, 0.3, 0.5, 0.5, 0.9]), (2, 1500)))
    xywh, cls, top_scores, top_idx = chip_smoke.topk_inputs(boxes, scores, cls, 1000)
    if case == "nan and inf boxes":
        xywh = xywh.clone()
        xywh[0, top_idx[0, 3], 0] = float("nan")  # a kept candidate's centre
        xywh[0, top_idx[0, 10], 2] = float("inf")  # another's width
        xywh[1, top_idx[1, 5], 1] = float("-inf")
    return (*(t.cuda() for t in (xywh, cls, top_scores, top_idx)), 0.7, 1000, agnostic)


@pytest.mark.gpu
@pytest.mark.parametrize("agnostic", [True, False])
@pytest.mark.parametrize("case", ODD_TOPK_CASES)
def test_postprocess_topk_and_nms_equal_plain_on_odd_inputs_on_card(case, agnostic):
    """On tied scores and on NaN and infinite box coordinates (which make
    the per-class span NaN or infinite), the fused post-processing gives
    the plain chain's detections bit for bit, and the NMS kernel (``nms``
    on the candidates' corners) nms_torch's answer."""
    _need_card()
    import chip_smoke
    from geotrax_tpu_torch.ops import nms as nms_ops
    from geotrax_tpu_torch.ops.boxes import xywh_to_xyxy

    args = _odd_topk_inputs(case, agnostic)
    out = nms_ops.postprocess_topk(*args)
    plain = nms_ops.postprocess_topk_torch(*args)
    assert chip_smoke.topk_equal(out, plain)
    assert bool(plain["valid"].any())
    if case == "nan and inf boxes":
        assert bool(torch.isnan(plain["boxes_xywh"]).any())
    xywh, cls, top_scores, top_idx = args[:4]
    b, k = top_scores.shape
    corners = xywh_to_xyxy(torch.gather(xywh, 1, top_idx[..., None].expand(b, k, 4)))
    kw = {"class_ids": torch.gather(cls, 1, top_idx), "agnostic": agnostic}
    keep, valid = nms_ops.nms(corners.contiguous(), top_scores.contiguous(), 0.7, 1000, **kw)
    plain_keep, plain_valid = nms_ops.nms_torch(corners, top_scores, 0.7, 1000, **kw)
    torch.testing.assert_close(valid, plain_valid, rtol=0, atol=0)
    torch.testing.assert_close(keep, plain_keep, rtol=0, atol=0)


@pytest.mark.gpu
def test_postprocess_topk_replays_from_a_cuda_graph():
    """One fused call captured in a CUDA graph and replayed gives the eager
    answer, and with other inputs copied into the captured ones theirs: the
    call reads nothing back."""
    _need_card()
    import chip_smoke
    from geotrax_tpu_torch.ops import nms as nms_ops

    args, plain = _topk_inputs("chunk (32, 2000)")
    held = [a.clone() if isinstance(a, torch.Tensor) else a for a in args]
    nms_ops.postprocess_topk(*held)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = nms_ops.postprocess_topk(*held)
    graph.replay()
    torch.cuda.synchronize()
    assert chip_smoke.topk_equal(captured, plain)
    boxes, scores, _ = chip_smoke.nms_candidates(32, 2000, 250, 4, 77, "cuda")
    other = chip_smoke.topk_inputs(boxes, scores, None, 1000)
    for dst, src in zip(held[:4], other):
        dst.copy_(src)
    graph.replay()
    torch.cuda.synchronize()
    assert chip_smoke.topk_equal(captured, nms_ops.postprocess_topk_torch(*other, 0.7, 1000, True))


@pytest.mark.gpu
def test_postprocess_topk_takes_strided_inputs_on_card():
    """Boxes in another memory order (copied by the wrapper), the top-K as
    exact_top_k leaves it (a slice of a longer sort, read with its stride)
    and per-class offsets give the plain chain's detections."""
    _need_card()
    import chip_smoke
    from geotrax_tpu_torch.ops import nms as nms_ops
    from geotrax_tpu_torch.ops.topk import exact_top_k

    boxes, scores, cls, max_det, _ = _nms_inputs("evaluate (8, 1024)")
    xywh, cls, _, _ = chip_smoke.topk_inputs(boxes, scores, cls, max_det)
    top_scores, top_idx = exact_top_k(scores, 700)
    assert not top_scores.is_contiguous() and not top_idx.is_contiguous()
    xywh_t = xywh.permute(2, 1, 0).contiguous().permute(2, 1, 0)
    cls_t = cls.t().contiguous().t()
    assert not xywh_t.is_contiguous() and not cls_t.is_contiguous()
    out = nms_ops.postprocess_topk(xywh_t, cls_t, top_scores, top_idx, 0.7, max_det, False)
    plain = nms_ops.postprocess_topk_torch(xywh, cls, top_scores.contiguous(),
                                           top_idx.contiguous(), 0.7, max_det, False)
    assert chip_smoke.topk_equal(out, plain)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["chunk (32, 2000)", "frame (1, 2000)", "chain of 2000",
                                  "odd 37"])
def test_nms_sorted_equals_plain_at_every_cluster_size(case):
    """nms_sorted (the kernel on sorted candidates, ``nms``'s call) equals
    nms_torch at every cluster size from one block an image to 16."""
    _need_card()
    import chip_smoke
    from geotrax_tpu_torch.ops import nms as nms_ops

    boxes, scores, cls, max_det, agnostic = _nms_inputs(case)
    order, sb, ss = nms_ops.sorted_candidates(boxes, scores, cls, agnostic)
    plain_keep, plain_valid = nms_ops.nms_torch(boxes, scores, 0.7, max_det, class_ids=cls,
                                                agnostic=agnostic)
    for cluster in (1, 2, 4, 8, 16):
        with chip_smoke.cluster_forced(cluster):
            keep, valid = nms_ops.nms_sorted(sb.contiguous(), ss.contiguous(),
                                             order.contiguous(), 0.7, max_det)
        torch.testing.assert_close(valid, plain_valid, rtol=0, atol=0)
        torch.testing.assert_close(keep, plain_keep, rtol=0, atol=0)


@pytest.mark.gpu
def test_postprocess_topk_rejects_what_the_kernel_does_not_take():
    """float64 and bfloat16 boxes or scores, other index and class types
    and mismatched shapes raise a ValueError before any launch; a cluster
    too small for the candidates is refused by the library and raises its
    CUDA error; nothing falls back to the plain version."""
    _need_card()
    import chip_smoke
    from geotrax_tpu_torch.ops import nms as nms_ops

    args, _ = _topk_inputs("lockstep (4, 2000)")
    xywh, cls, top_scores, top_idx = args[:4]
    launches, calls = nms_ops.postprocess_topk.launches, nms_ops.postprocess_topk_torch.calls
    bad = [((xywh.double(), cls, top_scores, top_idx), "float32"),
           ((xywh, cls, top_scores.to(torch.bfloat16), top_idx), "float32"),
           ((xywh, cls.long(), top_scores, top_idx), "int32 classes"),
           ((xywh, cls, top_scores, top_idx.int()), "int64 indices"),
           ((xywh[..., :3], cls, top_scores, top_idx), r"\(B, A, 4\)"),
           ((xywh, cls, top_scores[:2], top_idx[:2]), r"\(B, A, 4\)"),
           ((xywh, cls, top_scores, top_idx[:, :5]), r"\(B, A, 4\)")]
    for tensors, match in bad:
        with pytest.raises(ValueError, match=match):
            nms_ops.postprocess_topk(*tensors, 0.7, 1000, True)
    big = nms_ops.MAX_CANDIDATES // 4
    sorted_launches = nms_ops.nms_sorted.launches
    with chip_smoke.cluster_forced(1), pytest.raises(RuntimeError, match="CUDA error 1 "):
        nms_ops.nms_sorted(torch.zeros((1, big, 4), device="cuda"),
                           torch.zeros((1, big), device="cuda"),
                           torch.zeros((1, big), dtype=torch.int64, device="cuda"), 0.7, 10)
    assert nms_ops.nms_sorted.launches == sorted_launches
    assert nms_ops.postprocess_topk.launches == launches
    assert nms_ops.postprocess_topk_torch.calls == calls
    out = nms_ops.postprocess_topk(xywh, cls, top_scores[:, :0], top_idx[:, :0], 0.7, 6, True)
    assert not out["valid"].any() and bool((out["classes"] == -1).all())
    assert not out["boxes_xywh"].any() and not out["scores"].any()


@pytest.mark.gpu
def test_nms_failing_build_raises(tmp_path, monkeypatch):
    """A kernel source that does not compile makes ``nms`` on the card raise
    nvcc's error; it does not run the plain version instead."""
    _need_card()
    from geotrax_tpu_torch.ops import nms as nms_ops

    (tmp_path / "nms.cu").write_text("this is not CUDA C++\n")
    monkeypatch.setattr(_cuda, "CSRC", tmp_path)
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path / "build")
    nms_ops._library.cache_clear()
    calls = nms_ops.nms_torch.calls
    try:
        with pytest.raises(RuntimeError, match="nvcc failed for nms.cu"):
            nms_ops.nms(torch.rand((1, 8, 4), device="cuda"), torch.rand((1, 8), device="cuda"),
                        0.7, 4)
    finally:
        nms_ops._library.cache_clear()
    assert nms_ops.nms_torch.calls == calls


@pytest.mark.gpu
def test_smallest_eigenvector_on_card_equals_eigh_and_reads_nothing_back():
    """RANSAC refinement's eigensolver on the card (inverse iteration, run
    under set_sync_debug_mode("error")) gives the CPU eigh's smallest
    eigenvectors up to their sign: on systems with a near null vector, and
    on systems whose second eigenvalue is 2e-7 of the trace and whose
    smallest is a rounding of either sign (to eigh's own accuracy, 1e-16 of
    the trace over the gap)."""
    _need_card()
    from geotrax_tpu_torch.ops import homography

    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.normal(0, 1, (32, 200, 9)))
    a[..., 8] = a[..., :8].sum(dim=-1) * 0.5 + rng.normal(0, 1e-4, (32, 200))  # a near null vector
    q = torch.linalg.qr(torch.from_numpy(rng.normal(0, 1, (8, 9, 9))))[0]
    spectrum = torch.tensor([0.0, 2e-7, 1e-5, 1e-4, 1e-3, 1e-2, 0.1, 0.3, 0.6], dtype=torch.float64)
    spectrum = spectrum.repeat(8, 1)
    spectrum[:, 0] = torch.from_numpy(rng.uniform(-1e-9, 1e-9, 8))
    systems = [(a.transpose(-1, -2) @ a, 1e-10), ((q * spectrum[:, None, :]) @ q.mT, 1e-16 / 2e-7)]
    for m, atol in systems:
        on_card = m.cuda()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            v = homography.smallest_eigenvector(on_card)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        e = torch.linalg.eigh(m)[1][..., :, 0]
        v = v.cpu()
        sign = torch.sign((e * v).sum(dim=-1, keepdim=True))
        torch.testing.assert_close(v * sign, e, rtol=0, atol=atol)


def _degenerate_correspondences(name, n=60):
    """Correspondences whose RANSAC refinement system is underdetermined or
    NaN (tests/test_torch_ransac.py holds the CPU's results to the
    reference): (src, dst, valid, (64, 4) hypothesis indices)."""
    from geotrax_tpu_torch.ops import prng
    from geotrax_tpu_torch.ops import ransac

    rng = np.random.default_rng(11)
    src = rng.uniform(0, 400, (n, 2))
    h = np.array([[1.01, 0.03, -2.0], [-0.03, 1.0, 1.5], [1e-5, -2e-5, 1.0]])
    p = np.c_[src, np.ones(n)] @ h.T
    dst = p[:, :2] / p[:, 2:] + rng.normal(0, 0.3, (n, 2))
    valid, idx = np.ones(n, bool), None
    if name == "three soft inliers":  # the one hypothesis fits 0-3, and 3 is not valid
        dst[4:] = rng.uniform(0, 400, (n - 4, 2))
        valid[3] = False
        idx = np.tile(np.arange(4), (64, 1))
    elif name == "every sample degenerate":  # three valid points: every draw repeats one
        valid[3:] = False
    else:
        dst[30:] = rng.uniform(0, 400, (n - 30, 2))
        src[5] = np.nan
    src, dst = src.astype(np.float32), dst.astype(np.float32)
    if idx is None:
        idx = ransac.sample_indices(np.asarray(prng.fold_in(prng.PRNGKey(0), 3))[None], 64, 4,
                                    ransac.sample_weights(torch.from_numpy(valid)[None]))[0]
    return torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(valid), \
        torch.as_tensor(idx).long()


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["three soft inliers", "every sample degenerate",
                                  "nan correspondence"])
def test_ransac_degenerate_inputs_on_card_equal_the_cpu(name):
    """ransac_fit where the refinement's weighted system has fewer soft
    inliers than a minimal sample, or is NaN: on the card (under
    set_sync_debug_mode("error")) the CPU's homography (1e-4 relative) and
    inlier mask."""
    _need_card()
    from geotrax_tpu_torch.ops import ransac

    args = _degenerate_correspondences(name)
    cpu = ransac.ransac_fit(*args[:3], 2.0, num_hypotheses=64, sample_idx=args[3])
    on_card = [t.cuda() for t in args]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        card = ransac.ransac_fit(*on_card[:3], 2.0, num_hypotheses=64, sample_idx=on_card[3])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    h = card.h_matrix.cpu().double()
    torch.testing.assert_close(h, cpu.h_matrix.double(), rtol=1e-4,
                               atol=1e-4 * float(cpu.h_matrix.abs().max()))
    assert torch.equal(card.inliers.cpu(), cpu.inliers)
    if name == "three soft inliers":
        assert int(cpu.num_inliers) == 3


@pytest.mark.gpu
def test_steady_chunk_steps_read_nothing_back_on_card():
    """The default extract path (YOLOv8n at imgsz 640 on 1280x720 frames,
    stabilization, botsort): every chunk step after the video's first
    runs whole under set_sync_debug_mode("error") (the smoke's
    tracker_reads_checked), the NMS kernel launches once a chunk and its
    plain version never."""
    _need_card()
    import chip_smoke

    chip_smoke.reset_nms_counts()
    run = chip_smoke.phase_main("cuda", width=1280, height=720, n_frames=12, chunk=4,
                                variant="n", imgsz=640, horizon=20, tol_px=10.0)
    steady = chip_smoke.phase_steady(run["fx"], 1280, 720, 0, 20, 12, chunk=4, n_chunks=2,
                                     tol_px=10.0)
    assert run["sync_checked_steps"] == 2 and steady["sync_checked_steps"] == 2
    assert run["nms_launches"] == 3 and chip_smoke.plain_nms_calls() == 0


def _seeded_nv12(h, w, seed, device="cuda"):
    gen = torch.Generator().manual_seed(seed)
    y = torch.randint(0, 256, (h, w), generator=gen, dtype=torch.uint8)
    uv = torch.randint(0, 256, (h // 2, w), generator=gen, dtype=torch.uint8)
    return y.to(device), uv.to(device)


@pytest.mark.gpu
# 4K, a width of 2 mod 4 (byte stores on odd rows, a half tile at the edge), tiny frames
@pytest.mark.parametrize("size", [(2160, 3840), (1082, 1922), (22, 38), (2, 2), (4, 6),
                                  (1080, 1920)])
def test_nv12_kernel_equals_plain_on_card(size):
    _need_card()
    from geotrax_tpu_torch.ops import yuv

    y, uv = _seeded_nv12(*size, seed=size[0] * size[1])
    before = yuv.nv12_to_rgb24.launches
    got = yuv.nv12_to_rgb24(y, uv)
    assert yuv.nv12_to_rgb24.launches == before + 1
    assert got.shape == (*size, 3) and got.is_contiguous()
    assert torch.equal(got, yuv.nv12_to_rgb24_torch(y, uv))
    assert torch.equal(got.cpu(), yuv.nv12_to_rgb24_torch(y.cpu(), uv.cpu()))


@pytest.mark.gpu
# NVDEC-like pitches (4096), a pitch that misaligns every other row, an offset base
@pytest.mark.parametrize("pitch,offset", [(4096, 0), (3843, 0), (3840, 1)])
def test_nv12_kernel_reads_rows_at_a_pitch(pitch, offset):
    _need_card()
    from geotrax_tpu_torch.ops import yuv

    h, w = 2160, 3840
    y, uv = _seeded_nv12(h, w, seed=pitch + offset)
    flat = torch.zeros(offset + pitch * (h * 3 // 2), dtype=torch.uint8, device="cuda")
    buf = flat[offset:].view(h * 3 // 2, pitch)
    buf[:h, :w], buf[h:, :w] = y, uv
    got = yuv.nv12_to_rgb24(buf[:h, :w], buf[h:, :w])
    assert torch.equal(got, yuv.nv12_to_rgb24_torch(y, uv))


@pytest.mark.gpu
def test_nv12_kernel_refusals():
    _need_card()
    from geotrax_tpu_torch.ops import yuv

    y, uv = _seeded_nv12(8, 12, seed=1)
    with pytest.raises(ValueError):
        yuv.nv12_to_rgb24(y, uv.cpu())                    # planes on two devices
    with pytest.raises(ValueError):
        yuv.nv12_to_rgb24(y[:, ::2], uv[:, ::2])          # rows not contiguous
    with pytest.raises(ValueError):
        yuv.nv12_to_rgb24(y[:7], uv[:3])                  # odd height
    with pytest.raises(TypeError):
        yuv.nv12_to_rgb24(y.to(torch.int16), uv.to(torch.int16))


YUV_FORMATS = ("yuv420p", "yuvj420p", "yuv422p", "yuvj422p", "yuv444p", "yuvj444p",
               "yuv420p10le", "yuv422p10le", "yuv444p10le")


def _seeded_yuv(fmt, h, w, seed, device="cuda"):
    from geotrax_tpu_torch.ops import yuv

    f = yuv.FORMATS[fmt]
    gen = torch.Generator().manual_seed(seed)
    ch, cw = f.chroma_shape(h, w)
    return tuple(torch.randint(0, 1 << f.depth, shape, generator=gen).to(f.dtype).to(device)
                 for shape in ((h, w), (ch, cw), (ch, cw)))


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", YUV_FORMATS)
# 4K, odd sides (the scaler for 4:2:x, its chroma filter across), a width of 2 mod 4,
# 4:2:x's unwritten-tail widths (w % 16 in 1..7), tiny frames
@pytest.mark.parametrize("size", [(2160, 3840), (1081, 1919), (1082, 1922), (36, 50),
                                  (47, 63), (2, 2), (1, 1)])
def test_yuv_kernels_equal_plain_on_card(fmt, size):
    _need_card()
    from geotrax_tpu_torch.ops import yuv

    planes = _seeded_yuv(fmt, *size, seed=size[0] * size[1] + len(fmt))
    launcher = (yuv.yuv_unscaled_to_rgb24 if yuv.route(fmt, *size) == "unscaled"
                else yuv.yuv_scaled_to_rgb24)
    before = launcher.launches
    got = yuv.yuv_to_rgb24(planes, fmt)
    assert launcher.launches == before + 1
    assert got.shape == (*size, 3) and got.is_contiguous()
    assert torch.equal(got, yuv.yuv_to_rgb24_torch(planes, fmt))
    assert torch.equal(got.cpu(), yuv.yuv_to_rgb24_torch(tuple(p.cpu() for p in planes), fmt))


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", YUV_FORMATS)
# a pitch of 4096 samples, one that misaligns every other row, an offset base
@pytest.mark.parametrize("pitch,offset", [(4096, 0), (1923, 0), (1920, 1)])
def test_yuv_kernels_read_rows_at_a_pitch(fmt, pitch, offset):
    _need_card()
    from geotrax_tpu_torch.ops import yuv

    h, w = 1080, 1920
    planes = _seeded_yuv(fmt, h, w, seed=pitch + offset)
    pitched = []
    for plane in planes:
        rows, cols = plane.shape
        flat = torch.zeros(offset + pitch * rows, dtype=plane.dtype, device="cuda")
        buf = flat[offset:].view(rows, pitch)
        buf[:, :cols] = plane
        pitched.append(buf[:, :cols])
    got = yuv.yuv_to_rgb24(tuple(pitched), fmt)
    assert torch.equal(got, yuv.yuv_to_rgb24_torch(planes, fmt))


@pytest.mark.gpu
def test_yuv_kernel_refusals():
    _need_card()
    from geotrax_tpu_torch.ops import yuv

    y, u, v = _seeded_yuv("yuv420p10le", 8, 12, seed=1)
    with pytest.raises(ValueError):
        yuv.yuv_to_rgb24((y, u.cpu(), v), "yuv420p10le")          # planes on two devices
    with pytest.raises(ValueError):
        yuv.yuv_to_rgb24((y[:, ::2], u[:, ::2], v[:, ::2]), "yuv420p10le")  # rows not contiguous
    with pytest.raises(TypeError):
        yuv.yuv_to_rgb24((y, u, v), "yuv420p")                     # 16-bit samples as 8-bit
    wide = torch.zeros((4, 16), dtype=torch.int16, device="cuda")
    with pytest.raises(ValueError):
        yuv.yuv_scaled_to_rgb24(y, u, wide[:, :6], "yuv420p10le")  # U and V at two pitches
    y8, u8, v8 = _seeded_yuv("yuv422p", 8, 12, seed=2)
    with pytest.raises(ValueError):
        yuv.yuv_unscaled_to_rgb24(y8[:7], u8[:7], v8[:7], "yuv422p")  # odd height: the scaler


@pytest.mark.gpu
def test_yuv_kernels_in_a_cuda_graph():
    """One call of each kernel captured in a CUDA graph (the plan's tables
    uploaded before) and replayed on new planes copied into its inputs."""
    _need_card()
    from geotrax_tpu_torch.ops import yuv

    for fmt in ("yuvj422p", "yuv420p10le", "yuv444p"):
        planes = _seeded_yuv(fmt, 1081 if fmt == "yuv444p" else 1080, 1920, seed=3)
        yuv.yuv_to_rgb24(planes, fmt)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = yuv.yuv_to_rgb24(planes, fmt)
        fresh = _seeded_yuv(fmt, *planes[0].shape, seed=4)
        for dst, src in zip(planes, fresh):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, yuv.yuv_to_rgb24_torch(fresh, fmt))


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", YUV_FORMATS)
@pytest.mark.parametrize("size", [(240, 320), (239, 319)])
def test_device_reader_reads_each_format_on_card(fmt, size):
    """DeviceVideoReader over planar planes of ``fmt`` in host memory
    (chip_smoke.planes_decoder with the format): each frame the plain
    conversion's, one launch a frame of the format's kernel (NV12's for
    8-bit 4:2:0 limited range with even sides, from NV12 planes)."""
    _need_card()
    import chip_smoke
    from geotrax_tpu_torch.io.synthetic import SyntheticVideoReader
    from geotrax_tpu_torch.io.video import DeviceVideoReader, describe_reader
    from geotrax_tpu_torch.ops import yuv

    h, w = size
    scene = SyntheticVideoReader(width=w, height=h, n_frames=6, camera=(0.5, -0.3, 0.2, 1.002))
    held, plain = [], []
    nv12 = fmt == "yuv420p" and h % 2 == 0 and w % 2 == 0
    for i, frame in scene:
        if nv12:
            y, uv = chip_smoke.rgb_to_nv12(torch.as_tensor(frame))
            held.append((i, torch.cat([y.reshape(-1), uv.reshape(-1)]).numpy()))
            plain.append(yuv.nv12_to_rgb24_torch(y, uv))
        else:
            planes = chip_smoke.rgb_to_planes(torch.as_tensor(frame), fmt)
            held.append((i, torch.cat([p.reshape(-1) for p in planes]).view(torch.uint8).numpy()))
            plain.append(yuv.yuv_to_rgb24_torch(planes, fmt))
    kernel = "nv12_rgb24" if nv12 else chip_smoke.yuv_kernel(fmt, h, w)
    launchers = {"nv12_rgb24": yuv.nv12_to_rgb24, **chip_smoke.YUV_LAUNCHERS}
    for launcher in launchers.values():
        launcher.launches = 0
    with chip_smoke.planes_decoder({"clip.mp4": (scene.info, held, fmt)}):
        reader = DeviceVideoReader("clip.mp4", device="cuda")
        got = [(i, f.cpu()) for i, f in reader]
    assert reader.converter == kernel and kernel in describe_reader(reader)
    assert [i for i, _ in got] == list(range(6))
    assert all(torch.equal(a, b) for (_, a), b in zip(got, plain))
    assert {k: f.launches for k, f in launchers.items()} == {
        k: (6 if k == kernel else 0) for k in launchers}


def _nv12_video(reader) -> tuple:
    """``reader``'s frames as flat NV12 planes in host memory, as the native
    decoder gives them, and their plain conversion to RGB as numpy."""
    import chip_smoke
    from geotrax_tpu_torch.ops import yuv

    h, w = reader.info.height, reader.info.width
    planes, plain = [], []
    for i, frame in reader:
        y, uv = chip_smoke.rgb_to_nv12(torch.as_tensor(frame))
        planes.append((i, torch.cat([y.reshape(-1), uv.reshape(-1)]).numpy()))
        plain.append((i, yuv.nv12_to_rgb24_torch(y.view(h, w), uv.view(h // 2, w)).numpy()))
    return planes, plain


@pytest.mark.gpu
def test_device_reader_and_drivers_on_card():
    """DeviceVideoReader over NV12 planes in host memory (the native
    decoder's plane source replaced, chip_smoke.planes_decoder): each frame
    the plain conversion's, one launch a frame, start/stop as on the CPU,
    replayable after close; the double-buffered driver and the serial loop
    given its frames write the rows of the same frames given as numpy."""
    _need_card()
    from geotrax_tpu_torch import cfg as tcfg
    from geotrax_tpu_torch.io.synthetic import SyntheticVideoReader
    from geotrax_tpu_torch.io.video import DeviceVideoReader
    from geotrax_tpu_torch.models.detector import OracleDetector
    from geotrax_tpu_torch.ops import yuv
    from geotrax_tpu_torch.pipeline import extract as textract
    import chip_smoke

    scene = SyntheticVideoReader(width=320, height=240, n_frames=21, camera=(0.5, -0.3, 0.2, 1.002))
    planes, plain = _nv12_video(scene)
    info = scene.info
    with chip_smoke.planes_decoder({"clip.mp4": (info, planes)}):
        for start, stop in ((0, None), (3, 11)):
            for _ in range(2):  # a second reader replays the same frames
                reader = DeviceVideoReader("clip.mp4", start=start, stop=stop, device="cuda")
                before = yuv.nv12_to_rgb24.launches
                got = [(i, f.cpu().numpy()) for i, f in reader]
                reader.close()
                want = plain[start:stop]
                assert [i for i, _ in got] == [i for i, _ in want]
                assert yuv.nv12_to_rgb24.launches == before + len(want)
                assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(got, want))
        assert np.array_equal(DeviceVideoReader("clip.mp4").read_frame(5), plain[5][1])

        class Frames:
            def __init__(self, pairs):
                self.info, self.pairs = info, pairs

            def __iter__(self):
                return iter(self.pairs)

        runs = {}
        for name, pipelined in (("pipelined", True), ("serial", False), ("numpy", True)):
            det = OracleDetector(lambda i: [list(b) + [0.9, i % 2] for b in scene.boxes_at(i)],
                                 device="cuda")
            tracker_cfg, state, step, head = textract.make_extract_tracker(tcfg.DEFAULT,
                                                                           device="cuda")
            fx = textract.make_fused_extractor(tcfg.DEFAULT, det, tracker_cfg, state, step, 240,
                                               320, head, chunk=8, device="cuda")
            source = Frames(plain) if name == "numpy" else DeviceVideoReader("clip.mp4")
            runs[name] = textract.track_video_fused(source, fx, chunk=8, pipelined=pipelined)
    assert runs["numpy"][2]["chunks"] == 3 and len(runs["numpy"][0]) > 20
    for name in ("pipelined", "serial"):
        assert runs[name][0].tobytes() == runs["numpy"][0].tobytes()
        assert runs[name][1].tobytes() == runs["numpy"][1].tobytes()


@pytest.mark.gpu
def test_lockstep_on_device_reader_frames_on_card(tmp_path, monkeypatch):
    """``batch --parallel-videos 3`` (extract_videos_batch) with extract's
    own open_reader on the card and GEOTRAX_VIDEO_BACKEND=native: each
    video's DeviceVideoReader frames (planes in host memory in the native
    decoder's place) are copied into the staging buffer on the card, one
    launch a frame, and each video's files, stabilization on, equal those
    of the same frames handed over as numpy."""
    _need_card()
    import chip_smoke
    from geotrax_tpu_torch.io.synthetic import SyntheticVideoReader
    from geotrax_tpu_torch.ops import yuv
    from geotrax_tpu_torch.pipeline import extract as textract

    cameras = ((0.5, -0.3, 0.2, 1.002), (-0.4, 0.6, -0.1, 1.0), (0.3, 0.3, 0.0, 0.999))
    readers = [SyntheticVideoReader(width=320, height=240, n_frames=n, seed=v, camera=cam)
               for v, (n, cam) in enumerate(zip((10, 10, 7), cameras))]
    videos = {f"V{v}.mp4": (r.info, *_nv12_video(r)) for v, r in enumerate(readers)}
    model = tmp_path / "unused.npz"
    np.savez(model, **{"param:none": np.zeros(1)})
    cfg = chip_smoke.config_file(tmp_path / "lock.yaml", 320)
    monkeypatch.setenv("GEOTRAX_VIDEO_BACKEND", "native")
    monkeypatch.setenv("GEOTRAX_DECODE_WORKERS", "1")
    direct = []
    put_device = textract.Staging.put_device
    monkeypatch.setattr(textract.Staging, "put_device",
                        lambda self, *a: direct.append(a[:2]) or put_device(self, *a))
    files = {}
    for name in ("numpy", "device"):
        sources = [tmp_path / name / v for v in videos]
        sources[0].parent.mkdir()
        for src in sources:
            src.write_bytes(b"x")
        oracle = chip_smoke.LockstepOracle(readers, 16, "cuda")
        yuv.nv12_to_rgb24.launches = 0
        if name == "numpy":
            with chip_smoke.InMemory({k: (info, plain) for k, (info, _, plain) in videos.items()},
                                     oracle):
                chip_smoke.run_lockstep(sources, cfg, model, "cuda")
        else:
            monkeypatch.setattr(textract, "load_detector", lambda config, logger: oracle)
            with chip_smoke.planes_decoder({k: (info, planes)
                                            for k, (info, planes, _) in videos.items()}):
                chip_smoke.run_lockstep(sources, cfg, model, "cuda")
        assert yuv.nv12_to_rgb24.launches == (27 if name == "device" else 0)
        files[name] = [(src.parent / "results" / f"{src.stem}{end}").read_bytes()
                       for src in sources for end in (".txt", "_vid_transf.txt")]
    assert len(direct) == 27  # every frame of every step copied on the card
    assert all(files["numpy"]) and files["device"] == files["numpy"]
