"""Video decoding (geotrax_tpu_torch/io/video.py and its own native decoder,
geotrax_tpu_torch/io/native/decode.cpp, built here with g++ at first use)
against the reference's geotrax_tpu/io/video.py on clips the test encodes
with cv2 (as tests/test_io_video.py does): every frame byte-equal and the
same indices, whole and windowed with start/stop, through the native
backend and through the cv2 backend; equal ``probe_video``; a reader
closed early stops its thread; a missing file raises. One clip is 90 px
wide, a width whose RGB rows are not a multiple of 64 bytes: the port
decodes it through padded rows (the reference's decoder overruns its
buffer there, ROADMAP C5).

The GOP-parallel reader (``ParallelVideoReader``, ``make_reader`` with
``workers`` or GEOTRAX_DECODE_WORKERS) on a 150-frame clip of 13 GOPs that
the port's encoder writes (long enough for 3 segments of 2 GOPs or more,
under which the reader takes fewer workers): frames and indices bit-equal to the sequential
reader's and to the JAX package's ``ParallelVideoReader``, with 2 and 3
workers, whole and windowed; the pts scan equal to the reference's; a
stream without pts (MPEG-1 in a program stream) falls back to the
sequential reader in both packages; a reader closed mid-stream stops its
threads. The same reader on the cv2 backend (``backend="cv2"``: cv2
captures on segments that the port's MP4 frame table locates), on that clip
and on an H.264 clip with open GOPs of 12, 3 B-frames and an edit list:
frames and indices bit-equal to the port's native and cv2 sequential
readers and to the JAX package's ``ParallelVideoReader``; ``make_reader``
takes it where the native decoder is missing; a frame that is not the one
its time in the table says raises naming the file and the frame. The cv2
route's channel swap (``cv2.cvtColor``) equals a reversed channel axis at
its four sites: reading, the cv2 writer, ``write_jpeg`` and ``preview``."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from geotrax_tpu.io import video as jvideo
from geotrax_tpu_torch.io import native
from geotrax_tpu_torch.io import video as tvideo

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    cv2 = pytest.importorskip("cv2")
    tmp = tmp_path_factory.mktemp("video")
    out = {}
    rng = np.random.default_rng(0)
    for name, (w, h, n) in {"small": (64, 48, 12), "odd": (90, 62, 9)}.items():
        path = tmp / f"{name}.mp4"
        writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 30, (w, h))
        for i in range(n):
            frame = rng.integers(0, 255, (h, w, 3), np.uint8)
            frame[8:16, 8:24] = ((i * 17) % 255, 0, 255)
            writer.write(frame)
        writer.release()
        out[name] = path
    return out


def frames(reader):
    return [(i, f.copy()) for i, f in reader]


def assert_same_frames(got, want):
    assert [i for i, _ in got] == [i for i, _ in want] and got
    for (_, a), (_, b) in zip(got, want):
        assert a.dtype == np.uint8 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_the_port_builds_its_own_decoder():
    probe = native.probe()
    assert probe["ok"], probe
    path = native.build()
    assert path.parent.name == "native" and path.parent.parent.name == "build"
    assert native.SOURCE.name == "decode.cpp" and native.SOURCE.parent.parent.name == "io"
    assert tvideo.get_backend() == "native"


@pytest.mark.parametrize("window", [(0, None), (3, 7), (5, None), (0, 1)])
@pytest.mark.parametrize("clip", ["small", "odd"])
def test_native_reader_equals_the_references(clips, clip, window):
    start, stop = window
    # The reference's native decoder writes past its buffer on rows that are
    # not a multiple of 64 bytes (90 px: 270 bytes), so on that clip the
    # port is held to the reference's cv2 reader, which decodes the same
    # pictures.
    ref_backend = "native" if clip == "small" else "cv2"
    want = frames(jvideo.VideoReader(clips[clip], start=start, stop=stop, backend=ref_backend))
    got = frames(tvideo.make_reader(clips[clip], start=start, stop=stop))
    assert_same_frames(got, want)
    assert tvideo.VideoReader(clips[clip]).backend == "native"


@pytest.mark.parametrize("clip", ["small", "odd"])
def test_cv2_reader_equals_the_references(clips, clip):
    want = frames(jvideo.VideoReader(clips[clip], start=2, stop=8, backend="cv2"))
    got = frames(tvideo.VideoReader(clips[clip], start=2, stop=8, backend="cv2"))
    assert_same_frames(got, want)
    # the two backends of the port decode the same pictures
    assert_same_frames(frames(tvideo.VideoReader(clips[clip], backend="cv2")),
                       frames(tvideo.VideoReader(clips[clip], backend="native")))


@pytest.mark.parametrize("backend", ["native", "cv2"])
def test_probe_equals_the_references(clips, backend):
    for path in clips.values():
        assert tvideo.probe_video(path, backend) == tvideo.VideoInfo(
            **vars(jvideo.probe_video(path, backend)))


def test_early_close_and_missing_file(clips, tmp_path):
    reader = tvideo.VideoReader(clips["small"], prefetch=1)
    it = iter(reader)
    assert next(it)[0] == 0
    reader.close()
    assert not reader._thread.is_alive()
    assert list(reader) == []
    with pytest.raises((FileNotFoundError, OSError)):
        tvideo.VideoReader(tmp_path / "missing.mp4")


@pytest.mark.parametrize("index", [0, 5, 11])
def test_read_frame_and_the_stages_video_data(clips, index):
    """``VideoReader.read_frame`` and georeferencing's ``get_video_data``
    equal the reference's on the same clip; a frame past the end raises."""
    import logging

    from geotrax_tpu.pipeline import _georeference_impl as jgeo
    from geotrax_tpu_torch.pipeline import georeference as tgeo

    path = clips["small"]
    got = tvideo.VideoReader(path).read_frame(index)
    np.testing.assert_array_equal(got, jvideo.VideoReader(path).read_frame(index))
    log = logging.getLogger("test-torch-video")
    frame, size, fps = tgeo.get_video_data(path, index, log)
    ref_frame, ref_size, ref_fps = jgeo.get_video_data(path, index, log)
    np.testing.assert_array_equal(frame, ref_frame)
    assert size == ref_size == (48, 64) and fps == ref_fps
    with pytest.raises(IndexError):
        tvideo.VideoReader(path).read_frame(12)


# ---------------------------------------------------------------------------
# the GOP-parallel reader
# ---------------------------------------------------------------------------

GOP_FRAMES = 150


@pytest.fixture(scope="module")
def gop_video(tmp_path_factory):
    """150 frames of 320x192 (960-byte rows, which the reference's decoder
    also reads) through the port's encoder, a keyframe every 12 frames."""
    path = tmp_path_factory.mktemp("gop") / "gop.mp4"
    rng = np.random.default_rng(3)
    base = np.kron(rng.integers(0, 255, (24, 40, 3)), np.ones((8, 8, 1))).astype(np.uint8)
    writer = tvideo.VideoWriter(path, 30.0, 320, 192)
    assert writer.backend == "native"
    for i in range(GOP_FRAMES):
        frame = base.copy()
        frame[50:70, (i * 4) % 280:(i * 4) % 280 + 30] = (255, 0, 0)
        writer.write(frame)
    writer.close()
    return path


def test_scan_frame_pts_equals_the_references(gop_video):
    from geotrax_tpu.io.native import scan_frame_pts as jscan

    pts, keys = native.scan_frame_pts(str(gop_video))
    ref_pts, ref_keys = jscan(str(gop_video))
    np.testing.assert_array_equal(pts, ref_pts)
    np.testing.assert_array_equal(keys, ref_keys)
    assert len(pts) == GOP_FRAMES and keys[0] == 1 and keys.sum() >= 12
    assert (np.diff(pts) > 0).all()


@pytest.mark.parametrize("window", [(0, None), (10, 110), (17, GOP_FRAMES)])
@pytest.mark.parametrize("workers", [2, 3])
def test_parallel_reader_equals_sequential_and_the_reference(gop_video, workers, window):
    start, stop = window
    reader = tvideo.ParallelVideoReader(gop_video, start=start, stop=stop, workers=workers)
    got = frames(reader)
    assert len(reader._segments) == workers
    assert_same_frames(got, frames(tvideo.VideoReader(gop_video, start=start, stop=stop)))
    assert_same_frames(got, frames(jvideo.ParallelVideoReader(gop_video, start=start, stop=stop,
                                                              workers=workers)))
    assert [i for i, _ in got] == list(range(start, stop or GOP_FRAMES))
    assert reader.info.frame_count == GOP_FRAMES


def test_make_reader_takes_decode_workers(gop_video, monkeypatch):
    monkeypatch.setenv("GEOTRAX_DECODE_WORKERS", "3")
    reader = tvideo.make_reader(gop_video)
    assert isinstance(reader, tvideo.ParallelVideoReader) and len(reader._segments) == 3
    assert sum(1 for _ in reader) == GOP_FRAMES
    monkeypatch.setenv("GEOTRAX_DECODE_WORKERS", "1")
    assert type(tvideo.make_reader(gop_video)) is tvideo.VideoReader
    assert isinstance(tvideo.make_reader(gop_video, workers=2), tvideo.ParallelVideoReader)
    # without the native decoder (the card's machine: cv2 and no FFmpeg libraries) the
    # GOP-parallel reader runs on cv2 captures
    monkeypatch.setattr(tvideo, "native_error", lambda: "no FFmpeg libraries")
    monkeypatch.delenv("GEOTRAX_VIDEO_BACKEND", raising=False)
    reader = tvideo.make_reader(gop_video, workers=2)
    assert isinstance(reader, tvideo.ParallelVideoReader) and reader.backend == "cv2"
    assert len(reader._segments) == 2 and reader.codec_threads == tvideo.codec_threads(2)
    assert [i for i, _ in reader] == list(range(GOP_FRAMES))
    assert type(tvideo.make_reader(gop_video)) is tvideo.VideoReader


def test_stream_without_pts_falls_back(tmp_path):
    cv2 = pytest.importorskip("cv2")
    path = tmp_path / "nopts.mpg"
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mpg1"), 30, (64, 48))
    rng = np.random.default_rng(1)
    for _ in range(30):
        writer.write(rng.integers(0, 255, (48, 64, 3), np.uint8))
    writer.release()
    from geotrax_tpu.io.native import scan_frame_pts as jscan

    assert native.scan_frame_pts(str(path)) is None and jscan(str(path)) is None
    with pytest.raises(ValueError, match="no display-pts map"):
        tvideo.ParallelVideoReader(path, workers=2)
    reader = tvideo.make_reader(path, workers=2)
    assert type(reader) is tvideo.VideoReader
    want = frames(jvideo.make_reader(path, workers=2))
    assert_same_frames(frames(reader), want)
    assert len(want) == 30


@pytest.fixture(scope="module")
def h264_video(gop_video, tmp_path_factory):
    """gop_video's 150 frames through libx264 (make_fixtures.encode): open
    GOPs of 12, 3 B-frames, so an edit list shifts the pts."""
    spec = importlib.util.spec_from_file_location(
        "make_fixtures", Path(__file__).resolve().parent / "data" / "video" / "make_fixtures.py")
    make_fixtures = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(make_fixtures)
    frames = [f for _, f in tvideo.VideoReader(gop_video)]
    path = tmp_path_factory.mktemp("h264") / "gop_h264.mp4"
    return make_fixtures.encode(path, frames, 320, 192, fps=(30000, 1001), opts={
        "preset": "faster", "x264-params": "bframes=3:b-adapt=0:keyint=12:open-gop=1:scenecut=0"})


@pytest.mark.parametrize("window", [(0, None), (10, 110), (17, GOP_FRAMES)])
@pytest.mark.parametrize("workers", [2, 3])
@pytest.mark.parametrize("clip", ["gop_video", "h264_video"])
def test_cv2_parallel_reader_equals_the_sequential_readers_and_the_reference(
        clip, workers, window, request):
    path = request.getfixturevalue(clip)
    start, stop = window
    reader = tvideo.ParallelVideoReader(path, start=start, stop=stop, workers=workers,
                                        backend="cv2")
    got = frames(reader)
    assert reader.backend == "cv2" and len(reader._segments) == workers
    assert reader.codec_threads == tvideo.codec_threads(workers)
    assert [i for i, _ in got] == list(range(start, stop or GOP_FRAMES))
    for backend in ("native", "cv2"):
        assert_same_frames(got, frames(tvideo.VideoReader(path, start=start, stop=stop,
                                                          backend=backend)))
    assert_same_frames(got, frames(jvideo.ParallelVideoReader(path, start=start, stop=stop,
                                                              workers=workers)))
    # each capture starts at the keyframe one GOP before its segment's (keys every 12)
    assert [reader._seek_index(a) for a, _ in reader._segments] == [
        max(0, (a // 12 - 1) * 12) for a, _ in reader._segments]


@pytest.mark.parametrize("shift", [1, -1])
def test_cv2_segment_names_a_frame_its_table_does_not_place(gop_video, shift):
    """A frame table one frame off (a capture that lands elsewhere than its
    table says): the segment raises naming the file and the frame, never
    counts on."""
    reader = tvideo.ParallelVideoReader(gop_video, workers=2, backend="cv2")
    ms = np.roll(reader._ms, shift)
    seg = reader._segments[1]
    with pytest.raises(OSError, match=rf"gop\.mp4 where frame {reader._seek_index(seg[0])} "):
        list(tvideo.cv2_frames_segment(str(gop_video), ms, seg, reader._seek_index(seg[0]), 1))


def _swap_sites(monkeypatch, tmp_path, frame):
    """What each cv2 site of the port hands cv2 (or gives back) for ``frame``."""
    import cv2

    seen = {}
    monkeypatch.setattr(cv2, "imwrite", lambda path, img, params: seen.setdefault("jpeg", img)
                        is not None)
    monkeypatch.setattr(cv2, "imshow", lambda title, img: seen.setdefault("preview", img))
    monkeypatch.setattr(cv2, "waitKey", lambda ms: -1)
    tvideo.write_jpeg(tmp_path / "f.jpg", frame)
    tvideo.preview(frame)
    monkeypatch.setenv("GEOTRAX_VIDEO_BACKEND", "cv2")
    writer = tvideo.VideoWriter(tmp_path / "w.mp4", 30.0, frame.shape[1], frame.shape[0])
    assert writer.backend == "cv2"
    writer._writer.release()
    writer._writer = type("Sink", (), {"write": lambda self, img: seen.setdefault("writer", img),
                                       "release": lambda self: None})()
    writer.write(frame)
    writer.close()
    return seen


@pytest.mark.parametrize("site", ["reader", "writer", "jpeg", "preview"])
def test_cvtcolor_swap_equals_the_reversed_channel_axis(site, clips, monkeypatch, tmp_path):
    """cv2.cvtColor's BGR <-> RGB swap, byte for byte the numpy swap
    (``frame[..., ::-1]``) that the reference's cv2 route uses, on seeded
    frames (an odd width among them) and on the frames cv2 decodes."""
    import cv2

    if site == "reader":
        for path in clips.values():
            cap = cv2.VideoCapture(str(path))
            want = []
            while True:
                ok, bgr = cap.read()
                if not ok:
                    break
                want.append((len(want), np.ascontiguousarray(bgr[..., ::-1])))
            cap.release()
            assert_same_frames(frames(tvideo.VideoReader(path, backend="cv2")), want)
        return
    rng = np.random.default_rng(7)
    for h, w in ((48, 64), (37, 91)):
        frame = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        got = _swap_sites(monkeypatch, tmp_path, frame)[site]
        assert got.dtype == np.uint8 and got.flags["C_CONTIGUOUS"]
        np.testing.assert_array_equal(got, frame[..., ::-1])


def test_parallel_reader_close_midstream(gop_video):
    reader = tvideo.ParallelVideoReader(gop_video, workers=3, prefetch=2)
    it = iter(reader)
    for _ in range(5):
        next(it)
    reader.close()  # must not hang with producers blocked on full queues
    assert all(not t.is_alive() for t in reader._threads)
    assert list(reader) == []
