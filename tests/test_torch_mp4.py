"""The port's MP4 demuxer (geotrax_tpu_torch/io/mp4.py) held against the JAX
package's libav reader (geotrax_tpu/io/video.py) on the committed fixtures
(tests/data/video: 4K H.264 with B-frames, 4K HEVC and a 640x360 H.264 of
open GOPs, made by make_fixtures.py): the size, frame rate and count its
probe gives, the frames its Annex-B stream decodes to, the fixtures'
recorded plane SHA-1s; small clips encoded here with odd sizes (the SPS's
cropping) and the files it must refuse (each exits 1 naming the file and
the property). Its frame table (``frame_table``, from the sample tables
alone) equal to the packet scan of both packages' native decoders
(``scan_frame_pts``) on an mp4v clip of the port's encoder, an H.264 clip of
open GOPs with B-frames and an edit list, and the fixtures; None for a
fragmented MP4 and an MPEG-1 program stream, where the reference has no
map either or the tables cannot give it."""

import hashlib
import importlib.util
import json
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest

from geotrax_tpu.io.video import VideoReader as JaxVideoReader
from geotrax_tpu.io.video import probe_video as jax_probe_video
from geotrax_tpu_torch.io import mp4

VIDEO_DIR = Path(__file__).resolve().parent / "data" / "video"
FIXTURES = ("h264_4k", "hevc_4k", "h264_gop")
FIXTURE_BYTES_MAX = 4 * 2**20


def _fixtures_module():
    spec = importlib.util.spec_from_file_location("make_fixtures", VIDEO_DIR / "make_fixtures.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def make_fixtures():
    return _fixtures_module()


def _rgb_hashes(path) -> list:
    """SHA-1 of every RGB frame the JAX package's native reader decodes."""
    return [hashlib.sha1(f.tobytes()).hexdigest()
            for _, f in JaxVideoReader(path, backend="native")]


@pytest.fixture(scope="module")
def jax_frames():
    """Per fixture, the JAX reader's frame hashes of its .mp4 (decoded once)."""
    return {name: _rgb_hashes(VIDEO_DIR / f"{name}.mp4") for name in FIXTURES}


def _clip(make_fixtures, path, width, height, n=3, **kw):
    rng = np.random.default_rng(width * height)
    frames = [rng.integers(0, 256, (height, width, 3), dtype=np.uint8) for _ in range(n)]
    return make_fixtures.encode(path, frames, width, height, **kw)


@pytest.mark.parametrize("name", FIXTURES)
def test_info_equals_the_reference_probe_and_reader(name, jax_frames):
    path = VIDEO_DIR / f"{name}.mp4"
    with mp4.Mp4Video(path) as video:
        info = video.info
    assert vars(info) == vars(jax_probe_video(path, backend="native"))
    assert info.frame_count == len(jax_frames[name])
    # the reference's RGB frames, recorded beside the fixture for machines without libav
    assert json.loads((VIDEO_DIR / f"{name}.json").read_text())["rgb_sha1"] == jax_frames[name]


def test_fps_of_30000_over_1001_and_the_sample_table():
    """The H.264 fixture: 30000/1001 as libavformat derives it (timescale x
    samples / summed durations), B-frames (decode order is not display
    order), an edit list that shows every frame, one keyframe."""
    with mp4.Mp4Video(VIDEO_DIR / "h264_4k.mp4") as video:
        assert video.fps == Fraction(30000, 1001) and video.codec == "h264"
        order = np.argsort(video.pts, kind="stable")
        assert not np.array_equal(order, np.arange(40))
        assert np.array_equal(np.sort(video.pts), video.pts.min() + 1001 * np.arange(40))
        assert list(video.keyframes) == [0]
        assert video.length_size == 4 and [p[0] & 0x1F for p in video.parameter_sets] == [7, 8]
    with mp4.Mp4Video(VIDEO_DIR / "hevc_4k.mp4") as video:
        assert video.fps == 30 and video.codec == "hevc"
        assert [(p[0] >> 1) & 0x3F for p in video.parameter_sets][:3] == [32, 33, 34]


@pytest.mark.parametrize("name", FIXTURES)
def test_annexb_stream_decodes_to_the_same_frames(name, jax_frames, tmp_path):
    with mp4.Mp4Video(VIDEO_DIR / f"{name}.mp4") as video:
        out = video.write_annexb(tmp_path / f"{name}.{video.codec}")
        first = next(video.samples())
    assert first.startswith(mp4.START_CODE)
    assert _rgb_hashes(out) == jax_frames[name]


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_records_are_libavs(name, make_fixtures):
    """The JSON beside each fixture: libavformat's probe and libavcodec's
    planes (gtx_read_frame_yuv) recomputed now."""
    recorded = json.loads((VIDEO_DIR / f"{name}.json").read_text())
    assert make_fixtures.describe(VIDEO_DIR / f"{name}.mp4") == recorded


def test_fixtures_fit_their_budget():
    total = sum(p.stat().st_size for p in VIDEO_DIR.iterdir() if p.is_file())
    assert total <= FIXTURE_BYTES_MAX, total


@pytest.mark.parametrize("codec,size", [("libx264", (202, 118)), ("libx265", (202, 118)),
                                        ("libx264", (64, 48))])
def test_cropped_sizes_equal_the_reference_probe(codec, size, make_fixtures, tmp_path):
    """Sizes that are not multiples of the coding block: the SPS's cropping
    (H.264) and conformance window (HEVC) give the reference's size."""
    opts = {"x265-params": "log-level=error"} if codec == "libx265" else {}
    path = _clip(make_fixtures, tmp_path / "clip.mp4", *size, codec=codec, opts=opts)
    with mp4.Mp4Video(path) as video:
        assert vars(video.info) == vars(jax_probe_video(path, backend="native"))
        assert (video.sps.width, video.sps.height) == size


REFUSED = {
    "fragmented": (dict(codec="libx264", mux={"movflags": "frag_keyframe+empty_moov"}),
                   "fragmented MP4"),
    "mpeg4 part 2": (dict(codec="mpeg4"), "MPEG-4 Part 2"),
    "10-bit h264": (dict(codec="libx264", pix_fmt="yuv420p10le"), "10-bit h264"),
    "10-bit hevc": (dict(codec="libx265", pix_fmt="yuv420p10le",
                         opts={"x265-params": "log-level=error"}), "10-bit hevc"),
    "4:2:2": (dict(codec="libx264", pix_fmt="yuv422p"), "chroma format 4:2:2"),
    "full range h264": (dict(codec="libx264", full_range=True), "full range"),
    "full range hevc": (dict(codec="libx265", full_range=True,
                             opts={"x265-params": "log-level=error"}), "full range"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_unsupported_files_exit_1_naming_file_and_property(case, make_fixtures, tmp_path,
                                                             capsys):
    kw, said = REFUSED[case]
    path = _clip(make_fixtures, tmp_path / "refused.mp4", 64, 48, **kw)
    with pytest.raises(mp4.UnsupportedVideo, match=said):
        mp4.Mp4Video(path)
    assert mp4.main([str(path)]) == 1
    err = capsys.readouterr().err
    assert str(path) in err and said in err


def test_an_edit_list_that_hides_frames_is_refused(tmp_path, capsys):
    """The H.264 fixture's edit starts at its first frame's presentation
    time; moved one frame later, libavformat would drop the first frame."""
    data = bytearray((VIDEO_DIR / "h264_4k.mp4").read_bytes())
    at = data.index(b"elst")
    version = data[at + 4]
    assert version == 0
    # entry count (4 bytes), then segment duration (4) and media time (4)
    media_at = at + 8 + 4 + 4
    media_time = int.from_bytes(data[media_at:media_at + 4], "big")
    assert media_time == 2002
    data[media_at:media_at + 4] = (media_time + 1001).to_bytes(4, "big")
    path = tmp_path / "late_edit.mp4"
    path.write_bytes(bytes(data))
    assert mp4.main([str(path)]) == 1
    assert "an edit list that hides frames" in capsys.readouterr().err


def test_cli_prints_the_info_and_writes_the_stream(tmp_path, capsys):
    out = tmp_path / "s.hevc"
    assert mp4.main([str(VIDEO_DIR / "hevc_4k.mp4"), "--annexb", str(out)]) == 0
    printed = json.loads(capsys.readouterr().out)
    assert printed == {"codec": "hevc", "width": 3840, "height": 2160, "fps": 30.0,
                       "frame_count": 8, "keyframes": 1}
    assert out.stat().st_size > 0


def _table_clip(kind, make_fixtures, tmp_path) -> Path:
    """A clip of ``kind``: a committed fixture, or one encoded here."""
    if kind in FIXTURES:
        return VIDEO_DIR / f"{kind}.mp4"
    rng = np.random.default_rng(5)
    base = np.kron(rng.integers(0, 255, (12, 20, 3)), np.ones((8, 8, 1))).astype(np.uint8)
    frames = []
    for i in range(40):
        frame = base.copy()
        frame[30:50, (i * 4) % 120:(i * 4) % 120 + 30] = (255, 0, 0)
        frames.append(frame)
    path = tmp_path / f"{kind.replace(' ', '_')}.mp4"
    if kind == "mp4v":  # the port's encoder, the codec the reference writes
        from geotrax_tpu_torch.io.video import VideoWriter

        writer = VideoWriter(path, 30.0, 160, 96)
        for frame in frames:
            writer.write(frame)
        writer.close()
        return path
    if kind == "mpeg1 program stream":
        cv2 = pytest.importorskip("cv2")
        path = path.with_suffix(".mpg")
        writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mpg1"), 30, (160, 96))
        for frame in frames:
            writer.write(frame)
        writer.release()
        return path
    x264 = "bframes=3:b-adapt=0:keyint=12:open-gop=1:scenecut=0"
    mux = {"movflags": "frag_keyframe+empty_moov"} if kind == "fragmented" else None
    return make_fixtures.encode(path, frames, 160, 96, fps=(30000, 1001), mux=mux,
                                opts={"preset": "faster", "x264-params": x264})


@pytest.mark.parametrize("kind", ["mp4v", "h264 open gop"] + list(FIXTURES))
def test_frame_table_equals_the_packet_scans(kind, make_fixtures, tmp_path):
    """pts and key flags of every display index from the sample tables,
    equal to libavformat's packet scan through the port's and the JAX
    package's native decoders (and to the fixture's record)."""
    from geotrax_tpu.io.native import scan_frame_pts as jax_scan
    from geotrax_tpu_torch.io import native

    path = _table_clip(kind, make_fixtures, tmp_path)
    pts, keys = mp4.frame_table(path)
    for want_pts, want_keys in (native.scan_frame_pts(str(path)), jax_scan(str(path))):
        np.testing.assert_array_equal(pts, want_pts)
        np.testing.assert_array_equal(keys, want_keys)
    assert keys.dtype == np.int32 and pts.dtype == np.int64 and keys[0] == 1
    if kind in FIXTURES:
        record = json.loads((VIDEO_DIR / f"{kind}.json").read_text())
        assert pts.tolist() == record["pts"] and keys.tolist() == record["keys"]
    if kind in ("h264 open gop", "h264_gop"):
        # the edit list's shift (the B-frames' delay) and keys mapped to display order
        with mp4.Mp4Tables(path) as tables:
            assert tables.pts.min() == 2002 and tables.edits[0][1] == 2002
            assert list(tables.keyframes[:3]) == [0, 9, 21]
        assert pts[0] == 0 and list(np.flatnonzero(keys)[:3]) == [0, 12, 24]
    if kind == "mp4v":
        with mp4.Mp4Tables(path) as tables:
            assert tables.fourcc == b"mp4v"
        with pytest.raises(mp4.UnsupportedVideo, match="mp4v"):
            mp4.Mp4Video(path)


@pytest.mark.parametrize("kind", ["fragmented", "mpeg1 program stream"])
def test_frame_table_is_none_without_a_sample_table_map(kind, make_fixtures, tmp_path):
    from geotrax_tpu.io.native import scan_frame_pts as jax_scan

    path = _table_clip(kind, make_fixtures, tmp_path)
    assert mp4.frame_table(path) is None
    if kind == "mpeg1 program stream":  # no pts: the reference has no map either
        assert jax_scan(str(path)) is None


def test_frame_table_is_none_where_an_edit_hides_frames(tmp_path):
    data = bytearray((VIDEO_DIR / "h264_gop.mp4").read_bytes())
    media_at = data.index(b"elst") + 8 + 4 + 4
    data[media_at:media_at + 4] = (2002 + 1001).to_bytes(4, "big")
    path = tmp_path / "late_edit.mp4"
    path.write_bytes(bytes(data))
    assert mp4.frame_table(path) is None


def test_exp_golomb_and_emulation_prevention():
    r = mp4.BitReader(bytes([0b10100110, 0b11000000]))  # 1 010 011 011
    assert [r.ue(), r.ue(), r.ue(), r.se()] == [0, 1, 2, -1]
    assert mp4.rbsp(b"\x67\x00\x00\x03\x01\x00\x00\x03", 1) == b"\x00\x00\x01\x00\x00"
