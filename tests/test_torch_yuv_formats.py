"""Every pixel format the reference's decoder reads, converted as the port's
card route converts it (geotrax_tpu_torch/ops/yuv.py: yuv_to_rgb24 and its
plain versions), held against libswscale called through ctypes as
geotrax_tpu/io/native/decode.cpp calls it (same size, RGB24,
SWS_BILINEAR, a row pitch of 3 * width) and against the JAX package's
native reader, all exact (the largest difference is 0, no byte differs):

(a) each plain version against swscale on seeded planes at small sizes
    (odd sides, widths that are not multiples of 16), on planes whose rows
    lie at a pitch, on every (y, u, v) of the 8-bit formats and on 2^22
    seeded 10-bit samples;
(b) clips encoded here (make_fixtures.encode: H.264, and HEVC for 10-bit
    and full range) in each format of the set: every frame from the port's
    plane source through the plain version equals the reference reader's;
(c) make_reader's choice from the probed format, a format outside the set
    (HEVC gray) read through the host's swscale equal to the reference's,
    describe_reader's words, and the plane source's refusals."""

import ctypes
import ctypes.util
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from geotrax_tpu.io.video import VideoReader as JaxVideoReader
from geotrax_tpu_torch.io import native
from geotrax_tpu_torch.io import video as tvideo
from geotrax_tpu_torch.ops import yuv

ROOT = Path(__file__).resolve().parents[1]
AV_PIX_FMT_RGB24, SWS_BILINEAR = 2, 2
SIZES = [(48, 64), (47, 63), (22, 38), (37, 50), (1, 1), (135, 241)]


@pytest.fixture(scope="module")
def libs():
    found = {n: ctypes.util.find_library(n) for n in ("swscale", "avutil")}
    if None in found.values():
        pytest.fail(f"FFmpeg's libraries are not installed ({found}): the reference decoder "
                    "needs them")
    sws, avutil = (ctypes.CDLL(found[n]) for n in ("swscale", "avutil"))
    sws.sws_getContext.restype = ctypes.c_void_p
    sws.sws_getContext.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p] * 3
    sws.sws_scale.restype = ctypes.c_int
    sws.sws_scale.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
                              ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int,
                              ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)]
    sws.sws_freeContext.argtypes = [ctypes.c_void_p]
    avutil.av_get_pix_fmt.argtypes = [ctypes.c_char_p]
    avutil.av_log_set_level(8)  # AV_LOG_FATAL: no "deprecated pixel format" for yuvj
    return sws, avutil


def swscale(libs, fmt: str, planes, fill: int = 0) -> np.ndarray:
    """decode.cpp's call on ``planes`` (numpy, rows at any pitch): the
    (h, w, 3) rows it writes into a buffer filled with ``fill`` (slack after
    the last row: it stores whole vectors)."""
    sws, avutil = libs
    h, w = planes[0].shape
    ctx = sws.sws_getContext(w, h, avutil.av_get_pix_fmt(fmt.encode()), w, h, AV_PIX_FMT_RGB24,
                             SWS_BILINEAR, None, None, None)
    assert ctx
    try:
        dst = np.full(3 * w * h + 256, fill, np.uint8)
        src = (ctypes.c_void_p * 4)(*[p.ctypes.data for p in planes], None)
        pitch = (ctypes.c_int * 4)(*[p.strides[0] for p in planes], 0)
        assert sws.sws_scale(ctx, src, pitch, 0, h, (ctypes.c_void_p * 4)(dst.ctypes.data, None,
                                                                          None, None),
                             (ctypes.c_int * 4)(3 * w, 0, 0, 0)) == h
    finally:
        sws.sws_freeContext(ctx)
    return dst[:3 * w * h].reshape(h, w, 3)


def unwritten(w: int) -> int:
    """The pixels at the end of each row that swscale's unscaled SSSE3
    converter leaves unwritten at a pitch of 3 * w: its 16-pixel vectors
    cover a width rounded down to 8."""
    covered = -(-(w // 8 * 8) // 16) * 16
    return max(w - covered, 0) if w > 16 else 0


def seeded(fmt: str, h: int, w: int, seed: int) -> list:
    f = yuv.FORMATS[fmt]
    rng = np.random.default_rng(seed)
    ch, cw = f.chroma_shape(h, w)
    dtype = np.uint8 if f.depth == 8 else np.uint16
    return [rng.integers(0, 1 << f.depth, s).astype(dtype) for s in ((h, w), (ch, cw), (ch, cw))]


def tensors(fmt: str, planes) -> tuple:
    dtype = yuv.FORMATS[fmt].dtype
    return tuple(torch.from_numpy(p.view(np.int16) if dtype == torch.int16 else p)
                 for p in planes)


def assert_equal_stating(got: np.ndarray, want: np.ndarray) -> None:
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert (int(diff.max()), int((diff > 0).sum())) == (0, 0), \
        f"largest difference {diff.max()}, {(diff > 0).sum()} bytes differ"


def check(libs, fmt: str, planes) -> None:
    """The plain version of ``planes`` equals swscale where swscale writes,
    and swscale leaves unwritten only what ``unwritten`` says."""
    h, w = planes[0].shape
    a, b = swscale(libs, fmt, planes, 0), swscale(libs, fmt, planes, 255)
    written = (a == b).all(axis=(0, 2))
    tail = unwritten(w) if yuv.route(fmt, h, w) == "unscaled" else 0
    assert written.sum() == w - tail and written[:w - tail].all(), (fmt, h, w, tail)
    got = yuv.yuv_to_rgb24_torch(tensors(fmt, planes), fmt).numpy()
    assert got.shape == (h, w, 3)
    assert_equal_stating(got[:, written], a[:, written])


# (a) -----------------------------------------------------------------------

@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("fmt", list(yuv.FORMATS))
def test_plain_equals_swscale_on_seeded_planes(fmt, size, libs):
    check(libs, fmt, seeded(fmt, *size, seed=size[0] * size[1] + len(fmt)))


@pytest.mark.parametrize("fmt", list(yuv.FORMATS))
def test_plain_equals_swscale_on_pitched_planes(fmt, libs):
    """Rows at a pitch (a slice of a wider buffer), as libavcodec's frames
    lie: the plain version reads the views, swscale the linesizes."""
    h, w = 31, 46
    planes = []
    for i, p in enumerate(seeded(fmt, h, w, seed=7)):
        wide = np.zeros((p.shape[0], p.shape[1] + 16 + 3 * i), p.dtype)
        wide[:, :p.shape[1]] = p
        planes.append(wide[:, :p.shape[1]])
    assert planes[0].strides[0] > planes[0].shape[1] * planes[0].itemsize
    check(libs, fmt, planes)


def test_unscaled_converter_leaves_a_ragged_tail_unwritten(libs):
    """At a pitch of 3 * width swscale's unscaled converter leaves the last
    w % 16 pixels unwritten where w > 16 and w % 16 is 1..7 (the
    reference's frames hold whatever the buffer held there); the plain
    version converts them as the others, and equals it on the rest."""
    tails = {}
    for w in range(2, 70):
        planes = seeded("yuv422p", 4, w, seed=w)
        check(libs, "yuv422p", planes)
        tails[w] = unwritten(w)
    assert [w for w, n in tails.items() if n] == [*range(17, 24), *range(33, 40),
                                                  *range(49, 56), *range(65, 70)]


def _every_yuv(sx: int, sy: int) -> tuple:
    """Planes that hold every (y, u, v): each chroma sample's pixels walk
    through all 256 y's over its run of samples."""
    if (sx, sy) == (0, 0):
        idx = np.arange(1 << 24)
        y, u, v = (idx & 255), (idx >> 8) & 255, idx >> 16
        return tuple(a.astype(np.uint8).reshape(4096, 4096) for a in (y, u, v))
    if (sx, sy) == (1, 1):  # a 2x2 block a (u, v), four y's
        blocks = np.arange(256 * 256 * 64)
        uv, y4 = blocks // 64, (blocks % 64) * 4
        bw, bh = 512, len(blocks) // 512
        y = np.empty((2 * bh, 2 * bw), np.uint8)
        y4 = y4.reshape(bh, bw)
        y[0::2, 0::2], y[0::2, 1::2], y[1::2, 0::2], y[1::2, 1::2] = y4, y4 + 1, y4 + 2, y4 + 3
        return (y, (uv & 255).astype(np.uint8).reshape(bh, bw),
                (uv >> 8).astype(np.uint8).reshape(bh, bw))
    h, w = 4096, 4096  # 4:2:2: a pair a (u, v), 128 pairs through the 256 y's
    x = np.arange(w)
    y = np.tile(((x // 2 % 128) * 2 + x % 2).astype(np.uint8), (h, 1))
    uv = np.arange(h * w // 2).reshape(h, w // 2) // 128
    return y, (uv & 255).astype(np.uint8), (uv >> 8).astype(np.uint8)


@pytest.mark.parametrize("fmt,odd_height", [
    ("yuvj420p", False), ("yuv422p", False), ("yuvj422p", False),   # the unscaled converter
    ("yuv422p", True), ("yuvj422p", True),                          # the scaler's tables
    ("yuv444p", False), ("yuvj444p", False),                        # its full chroma
])
def test_plain_equals_swscale_on_every_yuv(fmt, odd_height, libs):
    f = yuv.FORMATS[fmt]
    planes = _every_yuv(f.sx, f.sy)
    if odd_height:  # one more row: swscale's generic scaler
        planes = tuple(np.concatenate([p, p[:1]]) for p in planes)
    assert yuv.route(fmt, *planes[0].shape) == ("scaled" if odd_height or f.sx == 0
                                                else "unscaled")
    check(libs, fmt, planes)


@pytest.mark.parametrize("fmt", ["yuv420p10le", "yuv422p10le", "yuv444p10le"])
def test_plain_equals_swscale_on_seeded_10bit_samples(fmt, libs):
    """2^22 seeded pixels (and 2^22 seeded (y, u, v) in 4:4:4), the top of
    the range (1021..1023, which round to 256) among them."""
    planes = seeded(fmt, 2048, 2048, seed=10)
    assert max(int(p.max()) for p in planes) == 1023
    check(libs, fmt, planes)


def test_coefficients_are_swscales():
    """Limited range gives the NV12 kernel's constants; full range the
    special converter's that the yuvj planes above are checked with."""
    lim, full = yuv.COEFFICIENTS[False], yuv.COEFFICIENTS[True]
    assert (lim.y_coeff, lim.y_offset, lim.vr, lim.ug, lim.vg, lim.ub) == (
        yuv.Y_COEFF, yuv.Y_OFFSET, yuv.VR_COEFF, yuv.UG_COEFF, yuv.VG_COEFF, yuv.UB_COEFF)
    assert (full.y_coeff, full.y_offset, full.vr, full.ug, full.vg, full.ub) == (
        8192, 0, 11485, -2819, -5850, 14516)


@pytest.mark.parametrize("fmt,h,w,want", [
    ("yuv420p", 2160, 3840, "unscaled"), ("yuvj420p", 48, 63, "unscaled"),
    ("yuv420p", 47, 64, "scaled"), ("yuv422p", 2160, 3840, "unscaled"),
    ("yuvj422p", 47, 64, "scaled"), ("yuv444p", 2160, 3840, "scaled"),
    ("yuv420p10le", 2160, 3840, "scaled"), ("yuv422p10le", 48, 64, "scaled"),
])
def test_route_is_swscales_path(fmt, h, w, want):
    assert yuv.route(fmt, h, w) == want


def test_scaled_plan_of_4k_420():
    """4:2:0 at an even height: past the first row, pairs of rows take one
    chroma row doubled (the filter's second tap 1024 of 4096) and two rows
    summed (3072); the last row's filter, moved off the border, sums the
    last two rows; 4:2:x chroma at an even width keeps one value per 2
    pixels, with no horizontal filter; an odd width interpolates across."""
    plan = yuv.scaled_plan("yuv420p10le", 2160, 3840)
    assert not plan.full_chroma and plan.columns == 1920 and plan.hpos is None
    assert plan.rows[:5] == ((0, 0), (0, 0), (0, 1), (1, 1), (1, 2))
    assert plan.rows[-2:] == ((1078, 1079), (1078, 1079))
    odd = yuv.scaled_plan("yuv420p", 47, 63)
    assert odd.full_chroma and odd.columns == 63 and len(odd.hpos) == 63
    assert all(sum(c) == 1 << 14 for c in odd.hcoef)
    full = yuv.scaled_plan("yuv444p10le", 47, 63)
    assert full.full_chroma and full.hpos is None and full.rows[5] == (5, 5)


def test_wrapper_runs_the_plain_versions_on_the_cpu():
    before = yuv.yuv_unscaled_to_rgb24.launches, yuv.yuv_scaled_to_rgb24.launches
    for fmt, size in (("yuvj420p", (6, 10)), ("yuv422p10le", (5, 8))):
        planes = tensors(fmt, seeded(fmt, *size, seed=3))
        assert torch.equal(yuv.yuv_to_rgb24(planes, fmt), yuv.yuv_to_rgb24_torch(planes, fmt))
    assert (yuv.yuv_unscaled_to_rgb24.launches, yuv.yuv_scaled_to_rgb24.launches) == before


@pytest.mark.parametrize("case", ["gray", "dtype", "chroma", "route", "device"])
def test_wrapper_refusals(case):
    y, u, v = tensors("yuv420p", seeded("yuv420p", 6, 10, seed=1))
    with pytest.raises((ValueError, TypeError)):
        if case == "gray":
            yuv.yuv_to_rgb24((y, u, v), "gray")
        elif case == "dtype":
            yuv.yuv_to_rgb24((y, u, v), "yuv420p10le")
        elif case == "chroma":
            yuv.yuv_to_rgb24((y, u[:, :4], v), "yuv420p")
        elif case == "route":
            yuv.yuv_unscaled_to_rgb24(y[:5], u, v, "yuv420p")
        else:
            yuv.yuv_to_rgb24((y.to("meta"), u.to("meta"), v.to("meta")), "yuv420p")


# (b) -----------------------------------------------------------------------

@pytest.fixture(scope="module")
def make_fixtures():
    spec = importlib.util.spec_from_file_location(
        "make_fixtures", ROOT / "tests" / "data" / "video" / "make_fixtures.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


X265 = {"x265-params": "log-level=error"}
# (codec, pix_fmt asked of the encoder, full-range flag, width, height) and
# the format libavcodec decodes it to
CLIPS = {
    "h264 yuv420p": (("libx264", "yuv420p", False, 64, 48), "yuv420p"),
    "h264 yuvj420p": (("libx264", "yuvj420p", False, 64, 48), "yuvj420p"),
    "h264 flagged full range": (("libx264", "yuv420p", True, 64, 48), "yuvj420p"),
    "hevc flagged full range": (("libx265", "yuv420p", True, 64, 48), "yuvj420p"),
    "h264 yuv422p": (("libx264", "yuv422p", False, 64, 48), "yuv422p"),
    "h264 yuv422p odd height": (("libx264", "yuv422p", False, 64, 47), "yuv422p"),
    "h264 yuvj422p": (("libx264", "yuvj422p", False, 64, 48), "yuvj422p"),
    "h264 yuvj422p odd height": (("libx264", "yuvj422p", False, 64, 47), "yuvj422p"),
    "h264 yuv444p": (("libx264", "yuv444p", False, 64, 48), "yuv444p"),
    "h264 yuv444p odd sides": (("libx264", "yuv444p", False, 63, 47), "yuv444p"),
    "h264 yuvj444p odd sides": (("libx264", "yuvj444p", False, 63, 47), "yuvj444p"),
    "h264 yuv420p10le": (("libx264", "yuv420p10le", False, 64, 48), "yuv420p10le"),
    "hevc yuv420p10le": (("libx265", "yuv420p10le", False, 64, 48), "yuv420p10le"),
    "hevc 10-bit flagged full range": (("libx265", "yuv420p10le", True, 64, 48),
                                       "yuv420p10le"),
    "h264 yuv422p10le odd height": (("libx264", "yuv422p10le", False, 64, 47), "yuv422p10le"),
    "h264 yuv444p10le": (("libx264", "yuv444p10le", False, 64, 48), "yuv444p10le"),
    "h264 yuv444p10le odd sides": (("libx264", "yuv444p10le", False, 63, 47), "yuv444p10le"),
}


def clip(make_fixtures, path: Path, codec: str, pix_fmt: str, full_range: bool, w: int,
         h: int) -> Path:
    scene = make_fixtures.scene(3, w, h, vehicles=2)
    return make_fixtures.encode(path, (f for _, f in scene), w, h, codec, pix_fmt=pix_fmt,
                                full_range=full_range,
                                opts=X265 if codec == "libx265" else None)


def split(buf, fmt: str, h: int, w: int) -> tuple:
    f = yuv.FORMATS[fmt]
    t = torch.as_tensor(np.asarray(buf))
    if f.dtype != torch.uint8:
        t = t.view(f.dtype)
    ch, cw = f.chroma_shape(h, w)
    u, v = t[h * w:].split(ch * cw)
    return t[:h * w].view(h, w), u.view(ch, cw), v.view(ch, cw)


@pytest.mark.parametrize("case", list(CLIPS))
def test_plane_source_equals_the_reference_readers_frames(case, make_fixtures, tmp_path):
    (codec, pix_fmt, full_range, w, h), want_fmt = CLIPS[case]
    path = clip(make_fixtures, tmp_path / "clip.mp4", codec, pix_fmt, full_range, w, h)
    probed = native.native_pixel_format(path)
    assert probed.name == want_fmt and probed.yuvj == want_fmt.startswith("yuvj"), probed
    f = yuv.FORMATS[want_fmt]
    assert (probed.depth, probed.log2_chroma_w, probed.log2_chroma_h) == (f.depth, f.sx, f.sy)
    seen = 0
    pairs = zip(native.native_frames_planes(path, probed), JaxVideoReader(path, backend="native"))
    for (i, buf), (j, want) in pairs:
        assert i == j and buf.size == f.nbytes(h, w) == native.planes_nbytes(probed, h, w)
        assert_equal_stating(yuv.yuv_to_rgb24_torch(split(buf, want_fmt, h, w),
                                                    want_fmt).numpy(), want)
        seen += 1
    assert seen == 3


def test_nv12_route_keeps_its_planes(make_fixtures, tmp_path):
    """8-bit 4:2:0 limited range: the NV12 planes (DeviceVideoReader's
    route for it) and the planar ones convert to the same frames."""
    path = clip(make_fixtures, tmp_path / "clip.mp4", "libx264", "yuv420p", False, 64, 48)
    probed = native.native_pixel_format(path)
    for (_, nv12), (_, planar) in zip(native.native_frames_yuv(path),
                                      native.native_frames_planes(path, probed)):
        t = torch.from_numpy(nv12)
        assert torch.equal(yuv.nv12_to_rgb24_torch(t[:48 * 64].view(48, 64),
                                                   t[48 * 64:].view(24, 64)),
                           yuv.yuv_to_rgb24_torch(split(planar, "yuv420p", 48, 64), "yuv420p"))


# (c) -----------------------------------------------------------------------

class _Made:
    """Stands in for a reader class: records how it was made."""

    def __init__(self, kind, made):
        self.kind, self.made = kind, made

    def __call__(self, path, **kw):
        self.made.append((self.kind, kw))
        return self


@pytest.mark.parametrize("case", [*CLIPS, "hevc gray"])
def test_make_reader_chooses_from_the_probed_format(case, make_fixtures, tmp_path,
                                                    monkeypatch):
    spec = CLIPS[case][0] if case in CLIPS else ("libx265", "gray", False, 64, 48)
    path = clip(make_fixtures, tmp_path / "clip.mp4", *spec)
    made = []
    monkeypatch.setattr(tvideo, "DeviceVideoReader", _Made("device", made))
    monkeypatch.setattr(tvideo, "VideoReader", _Made("host", made))
    monkeypatch.setenv("GEOTRAX_DECODE_WORKERS", "1")
    monkeypatch.delenv("GEOTRAX_VIDEO_BACKEND", raising=False)
    reader = tvideo.make_reader(path, device="cuda")
    assert [m[0] for m in made] == ["device" if case in CLIPS else "host"]
    if case not in CLIPS:
        assert reader.pixel_format.name == "gray"


def test_a_format_outside_the_set_is_read_by_the_hosts_swscale(make_fixtures, tmp_path,
                                                               monkeypatch):
    """HEVC gray: make_reader on a card hands it to VideoReader (swscale on
    the host, as the reference), says so, and its frames equal the
    reference's; DeviceVideoReader refuses it when it is opened."""
    path = clip(make_fixtures, tmp_path / "gray.mp4", "libx265", "gray", False, 64, 48)
    monkeypatch.setenv("GEOTRAX_DECODE_WORKERS", "1")
    monkeypatch.delenv("GEOTRAX_VIDEO_BACKEND", raising=False)
    reader = tvideo.make_reader(path, device="cuda")
    assert type(reader) is tvideo.VideoReader and reader.pixel_format.name == "gray"
    said = tvideo.describe_reader(reader)
    assert "gray, a format the card does not convert: swscale on the host" in said, said
    got = list(reader)
    want = list(JaxVideoReader(path, backend="native"))
    assert len(got) == len(want) == 3
    for (i, a), (j, b) in zip(got, want):
        assert i == j
        assert_equal_stating(a, b)
    with pytest.raises(ValueError, match="is gray: read it through VideoReader"):
        tvideo.DeviceVideoReader(path, device="cuda")
    with pytest.raises(OSError, match="not planar YUV of 3 planes"):
        next(native.native_frames_planes(path, native.native_pixel_format(path)))


def test_plane_sources_name_the_format_they_refuse(make_fixtures, tmp_path):
    path = clip(make_fixtures, tmp_path / "ten.mp4", "libx264", "yuv420p10le", False, 64, 48)
    with pytest.raises(OSError, match="not yuv420p .*the stream is yuv420p10le at 64x48"):
        next(native.native_frames_yuv(path))
    other = native.native_pixel_format(path)._replace(name="yuv444p10le", value=68)
    with pytest.raises(OSError, match="frame 0 of .* is yuv420p10le, not the stream's "
                                      "yuv444p10le"):
        next(native.native_frames_planes(path, other))
