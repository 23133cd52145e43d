"""The plain NV12 -> RGB24 conversion (geotrax_tpu_torch/ops/yuv.py) held
against the reference decoder's RGB frames and against libswscale called
as that decoder calls it: on libavcodec's own planes of every frame of the
committed fixtures (the port decoder's gtx_read_frame_yuv) against the JAX
package's native reader, on every (y, u, v) and on seeded planes at sizes
that are not multiples of 16 against swscale through ctypes (exact: the
largest difference is 0 and no byte differs); the wrapper's CPU route and
its refusals; the plane source into tensors, and DeviceVideoReader's
refusal of the CPU (its frames on the card: tests/test_torch_gpu.py)."""

import ctypes
import ctypes.util
from pathlib import Path

import numpy as np
import pytest
import torch

from geotrax_tpu.io.video import VideoReader as JaxVideoReader
from geotrax_tpu_torch.io import native
from geotrax_tpu_torch.io.video import DeviceVideoReader
from geotrax_tpu_torch.ops import yuv

VIDEO_DIR = Path(__file__).resolve().parent / "data" / "video"
# geotrax_tpu/io/native/decode.cpp's call: yuv420p -> rgb24, same size, SWS_BILINEAR
AV_PIX_FMT_YUV420P, AV_PIX_FMT_RGB24, SWS_BILINEAR = 0, 2, 2


def _split(planes, h: int, w: int) -> tuple:
    t = torch.as_tensor(np.asarray(planes))
    return t[:h * w].view(h, w), t[h * w:].view(h // 2, w)


@pytest.fixture(scope="module")
def swscale():
    path = ctypes.util.find_library("swscale")
    if path is None:
        pytest.fail("libswscale is not installed: the reference decoder needs it")
    lib = ctypes.CDLL(path)
    lib.sws_getContext.restype = ctypes.c_void_p
    lib.sws_getContext.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                   ctypes.c_void_p, ctypes.c_void_p]
    lib.sws_scale.restype = ctypes.c_int
    lib.sws_scale.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
                              ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int,
                              ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)]
    lib.sws_freeContext.argtypes = [ctypes.c_void_p]
    return lib


def swscale_rgb(lib, y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """decode.cpp's conversion of yuv420p planes: sws_getContext(w, h,
    yuv420p, w, h, rgb24, SWS_BILINEAR) and sws_scale into rows padded to
    64 bytes (it stores whole SIMD vectors)."""
    h, w = y.shape
    ctx = lib.sws_getContext(w, h, AV_PIX_FMT_YUV420P, w, h, AV_PIX_FMT_RGB24, SWS_BILINEAR,
                             None, None, None)
    assert ctx
    try:
        pitch = (3 * w + 63) // 64 * 64
        dst = np.zeros(pitch * h + 64, np.uint8)
        planes = [np.ascontiguousarray(p) for p in (y, u, v)]
        src = (ctypes.c_void_p * 4)(*[p.ctypes.data for p in planes], None)
        src_pitch = (ctypes.c_int * 4)(w, w // 2, w // 2, 0)
        dst_ptr = (ctypes.c_void_p * 4)(dst.ctypes.data, None, None, None)
        dst_pitch = (ctypes.c_int * 4)(pitch, 0, 0, 0)
        assert lib.sws_scale(ctx, src, src_pitch, 0, h, dst_ptr, dst_pitch) == h
    finally:
        lib.sws_freeContext(ctx)
    return dst[:pitch * h].reshape(h, pitch)[:, :3 * w].reshape(h, w, 3)


def _nv12(y, u, v) -> tuple:
    uv = np.stack([u, v], axis=-1).reshape(u.shape[0], 2 * u.shape[1])
    return torch.from_numpy(y), torch.from_numpy(uv)


def _assert_equal_stating(got: np.ndarray, want: np.ndarray) -> None:
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert (int(diff.max()), int((diff > 0).sum())) == (0, 0), \
        f"largest difference {diff.max()}, {(diff > 0).sum()} bytes differ"


@pytest.mark.parametrize("name", ["h264_4k", "hevc_4k"])
def test_plain_equals_the_reference_readers_frames(name):
    path = str(VIDEO_DIR / f"{name}.mp4")
    w, h, _, n = native.native_probe(path)
    pairs = zip(native.native_frames_yuv(path), JaxVideoReader(path, backend="native"))
    seen = 0
    for (i, planes), (j, want) in pairs:
        assert i == j
        _assert_equal_stating(yuv.nv12_to_rgb24_torch(*_split(planes, h, w)).numpy(), want)
        seen += 1
    assert seen == n


def test_plain_equals_swscale_on_every_yuv(swscale):
    """All 2^24 (y, u, v): each 2x2 block holds one (u, v) and four y's."""
    blocks = np.arange(256 * 256 * 64)
    uv_index, y4 = blocks // 64, (blocks % 64) * 4
    bw, bh = 512, len(blocks) // 512
    u = (uv_index & 255).astype(np.uint8).reshape(bh, bw)
    v = (uv_index >> 8).astype(np.uint8).reshape(bh, bw)
    y = np.empty((2 * bh, 2 * bw), np.uint8)
    y4 = y4.reshape(bh, bw)
    y[0::2, 0::2], y[0::2, 1::2], y[1::2, 0::2], y[1::2, 1::2] = y4, y4 + 1, y4 + 2, y4 + 3
    _assert_equal_stating(yuv.nv12_to_rgb24_torch(*_nv12(y, u, v)).numpy(),
                          swscale_rgb(swscale, y, u, v))


@pytest.mark.parametrize("size", [(1082, 1922), (22, 38), (2160, 3840), (2, 2)])
def test_plain_equals_swscale_on_seeded_planes(size, swscale):
    h, w = size
    rng = np.random.default_rng(h * w)
    y = rng.integers(0, 256, (h, w), dtype=np.uint8)
    u = rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8)
    v = rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8)
    _assert_equal_stating(yuv.nv12_to_rgb24_torch(*_nv12(y, u, v)).numpy(),
                          swscale_rgb(swscale, y, u, v))


def test_wrapper_runs_the_plain_version_on_the_cpu():
    rng = np.random.default_rng(1)
    y = torch.from_numpy(rng.integers(0, 256, (6, 10), dtype=np.uint8))
    uv = torch.from_numpy(rng.integers(0, 256, (3, 10), dtype=np.uint8))
    before = yuv.nv12_to_rgb24.launches
    assert torch.equal(yuv.nv12_to_rgb24(y, uv), yuv.nv12_to_rgb24_torch(y, uv))
    assert yuv.nv12_to_rgb24.launches == before
    # rows at a pitch: a slice of a wider buffer
    wide = torch.zeros((9, 16), dtype=torch.uint8)
    wide[:6, :10], wide[6:, :10] = y, uv
    assert torch.equal(yuv.nv12_to_rgb24(wide[:6, :10], wide[6:, :10]),
                       yuv.nv12_to_rgb24_torch(y, uv))


@pytest.mark.parametrize("y_shape,uv_shape,dtype,error", [
    ((5, 10), (2, 10), torch.uint8, ValueError),   # odd height
    ((6, 9), (3, 9), torch.uint8, ValueError),     # odd width
    ((6, 10), (3, 8), torch.uint8, ValueError),    # UV of another frame
    ((6, 10), (3, 10), torch.int16, TypeError),
    ((6, 10, 1), (3, 10), torch.uint8, ValueError),
])
def test_plain_refuses_what_is_not_nv12(y_shape, uv_shape, dtype, error):
    with pytest.raises(error):
        yuv.nv12_to_rgb24(torch.zeros(y_shape, dtype=dtype), torch.zeros(uv_shape, dtype=dtype))


def test_plane_source_fills_the_buffers_it_is_given():
    """native_frames_yuv into tensors made by ``alloc`` (DeviceVideoReader's
    route, which pins them) gives the planes of its numpy default."""
    path = VIDEO_DIR / "hevc_4k.mp4"
    sizes = []

    def alloc(n):
        sizes.append(n)
        return torch.empty(n, dtype=torch.uint8)

    pairs = list(zip(native.native_frames_yuv(path, alloc), native.native_frames_yuv(path)))
    assert len(pairs) == 8 and set(sizes) == {3840 * 2160 * 3 // 2}
    for (i, t), (j, a) in pairs:
        assert i == j and torch.is_tensor(t)
        np.testing.assert_array_equal(t.numpy(), a)


def test_device_reader_refuses_the_cpu():
    with pytest.raises(ValueError, match="converts on a card"):
        DeviceVideoReader(VIDEO_DIR / "hevc_4k.mp4", device="cpu")
