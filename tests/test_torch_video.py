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
threads."""

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
    # the cv2 backend has no GOP-parallel reader
    assert type(tvideo.make_reader(gop_video, workers=2, backend="cv2")) is tvideo.VideoReader


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


def test_parallel_reader_close_midstream(gop_video):
    reader = tvideo.ParallelVideoReader(gop_video, workers=3, prefetch=2)
    it = iter(reader)
    for _ in range(5):
        next(it)
    reader.close()  # must not hang with producers blocked on full queues
    assert all(not t.is_alive() for t in reader._threads)
    assert list(reader) == []
