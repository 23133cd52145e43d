"""The port's native video additions and video tools against the JAX
package's, on clips written by each package's own MPEG-4 encoder (12-frame
GOPs, so that keyframes are sparse):

- ``io/video.py:keyframe_indices`` (``gtx_keyframe_indices`` in the port's
  ``decode.cpp``) equal to the reference's, and [] for a file that does not
  open;
- ``io/native/remux.cpp`` through ``remux_concat``, ``remux_cut_frames`` and
  ``validate_video``: the outputs' frames and packet counts equal to the
  reference's (decoded by the port's reader), a cut that does not start on a
  keyframe or leaves the video refused the same way, ``validate_video``
  equal on a good file, a truncated one and a text file;
- ``merge_videos_and_logs`` (session mode with ``--srt-csv``, explicit
  parts, ``--dry-run``), ``recut_video_and_log`` (a cuts file snapped to
  keyframes, an exact cut that re-encodes, ``--rotate``, ``--debug``) and
  ``cut_merged_videos_and_logs`` (session mode with a location map, the
  explicit ``--cuts`` and ``--auto`` modes): the same files, SRT, CSV and
  cut-plan files byte-equal, videos frame-equal.

Each tool runs through its command line in the test's process: the
reference's ``main()`` with ``sys.argv`` set, the port's ``main(argv)``.
"""

import contextlib
import importlib
import io
import json
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pandas as pd
import pytest

from geotrax_tpu.io import native as jnative
from geotrax_tpu.io import video as jvideo
from geotrax_tpu_torch.io import native as tnative
from geotrax_tpu_torch.io import video as tvideo

TOOLS = Path(__file__).resolve().parent.parent / "tools"
sys.path.insert(0, str(TOOLS))


def run_ref(name, *args) -> str:
    mod = importlib.import_module(name)
    out = io.StringIO()
    with mock.patch.object(sys, "argv", [f"{name}.py", *map(str, args)]), \
            contextlib.redirect_stdout(out), contextlib.redirect_stderr(out):
        rc = mod.main()
    assert rc == 0, out.getvalue()[-3000:]
    return out.getvalue()


def run_port(name, *args) -> str:
    mod = importlib.import_module(f"geotrax_tpu_torch.tools.{name}")
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(out):
        rc = mod.main([str(a) for a in args])
    assert rc == 0, out.getvalue()[-3000:]
    return out.getvalue()


def frames_of(path) -> list:
    return [f.copy() for _, f in tvideo.VideoReader(path, backend="native")]


def assert_same_video(got, want) -> None:
    a, b = frames_of(got), frames_of(want)
    assert len(a) == len(b) and a
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert len(tnative.scan_frame_pts(str(got))[0]) == len(jnative.scan_frame_pts(str(want))[0])


def write_clip(path: Path, n: int, seed: int, writer=tvideo.VideoWriter) -> Path:
    """A 160x96 clip of n frames with a moving block (P-frames between the
    encoder's keyframes, one every 12 frames)."""
    rng = np.random.default_rng(seed)
    base = np.repeat(np.repeat(rng.integers(0, 255, (12, 20, 3)).astype(np.uint8), 8, 0), 8, 1)
    w = writer(path, 30.0, 160, 96)
    for i in range(n):
        f = base.copy()
        f[30:50, (i * 4) % 130:(i * 4) % 130 + 24] = (255, (i * 11) % 255, 0)
        w.write(f)
    w.close()
    return path


def srt_text(n: int, lat: float = 37.39, lon: float = 126.66) -> str:
    """A DJI-style SRT: one block per frame with FrameCnt and telemetry."""
    def ts(ms):
        h, rem = divmod(ms, 3_600_000)
        m, rem = divmod(rem, 60_000)
        s, msec = divmod(rem, 1_000)
        return f"{h:02d}:{m:02d}:{s:02d},{msec:03d}"

    return "\n".join(
        f"{i + 1}\n{ts(int(i * 1000 / 30))} --> {ts(int((i + 1) * 1000 / 30))}\n"
        f"<font size=\"28\">FrameCnt: {i + 1}, DiffTime: 33ms\n"
        f"2022-10-07 17:52:13.{i:03d}\n"
        f"[iso: 100] [shutter: 1/1000.0] [fnum: 2.8] [ev: 0] [color_md : default] "
        f"[latitude: {lat + 1e-6 * i:.6f}] [longitude: {lon:.6f}] [rel_alt: {140 + 0.1 * i:.3f} "
        f"abs_alt: 160.000] </font>\n" for i in range(n))


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("clips")
    return {"a": write_clip(tmp / "a.mp4", 40, 0), "b": write_clip(tmp / "b.mp4", 25, 1),
            "ref_a": write_clip(tmp / "ref_a.mp4", 40, 0, jvideo.VideoWriter)}


def test_keyframe_indices_equal_the_references(clips, tmp_path):
    for name in ("a", "b", "ref_a"):
        got = tvideo.keyframe_indices(clips[name])
        assert got == jvideo.keyframe_indices(clips[name])
        assert got[0] == 0 and 1 < len(got) < 10, got
    (tmp_path / "x.mp4").write_text("not a video")
    assert tvideo.keyframe_indices(tmp_path / "x.mp4") == []
    assert tvideo.keyframe_indices(tmp_path / "missing.mp4") == []


def test_remux_concat_and_cut_equal_the_references(clips, tmp_path):
    parts = [clips["a"], clips["b"]]
    assert tnative.remux_concat(parts, tmp_path / "t.mp4")
    assert jnative.remux_concat(parts, tmp_path / "j.mp4")
    assert_same_video(tmp_path / "t.mp4", tmp_path / "j.mp4")
    assert len(frames_of(tmp_path / "t.mp4")) == 65

    keys = tvideo.keyframe_indices(clips["a"])
    for start, end in ((keys[1], 30), (keys[0], 39), (keys[2], keys[2])):
        assert tnative.remux_cut_frames(clips["a"], tmp_path / "tc.mp4", start, end)
        assert jnative.remux_cut_frames(clips["a"], tmp_path / "jc.mp4", start, end)
        assert_same_video(tmp_path / "tc.mp4", tmp_path / "jc.mp4")
        assert len(frames_of(tmp_path / "tc.mp4")) == end - start + 1
        np.testing.assert_array_equal(frames_of(tmp_path / "tc.mp4")[0],
                                      frames_of(clips["a"])[start])
    for start, end in ((5, 2), (0, 40), (-1, 3)):
        assert tnative.remux_cut_frames(clips["a"], tmp_path / "x.mp4", start, end) is False
        assert jnative.remux_cut_frames(clips["a"], tmp_path / "x.mp4", start, end) is False


def test_validate_video_equals_the_references(clips, tmp_path):
    blob = clips["a"].read_bytes()
    (tmp_path / "cut.mp4").write_bytes(blob[: len(blob) // 2])
    (tmp_path / "text.mp4").write_text("not a video")
    for path in (clips["a"], tmp_path / "cut.mp4", tmp_path / "text.mp4",
                 tmp_path / "missing.mp4"):
        assert tnative.validate_video(path) is jnative.validate_video(path), path
    assert tnative.validate_video(clips["a"]) is True
    assert tnative.validate_video(tmp_path / "text.mp4") is False


# ---------------------------------------------------------------------------
# the tools
# ---------------------------------------------------------------------------

def same_tree(port: Path, ref: Path) -> None:
    """The same file names; text files byte-equal, videos frame-equal."""
    names = sorted(p.relative_to(port).as_posix() for p in port.rglob("*") if p.is_file())
    assert names == sorted(p.relative_to(ref).as_posix() for p in ref.rglob("*") if p.is_file())
    assert names
    for name in names:
        if name.endswith(".mp4"):
            assert_same_video(port / name, ref / name)
        else:
            assert (port / name).read_bytes() == (ref / name).read_bytes(), name


def raw_sessions(root: Path) -> Path:
    """Two sessions: three parts with SRTs and CSV logs, and one part whose
    SRT is missing."""
    s1, s2 = root / "RAW" / "2022-10-04" / "D1" / "AM1", root / "RAW" / "2022-10-05" / "D2" / "PM1"
    for d in (s1, s2):
        d.mkdir(parents=True)
    for i, (n, seed) in enumerate(((20, 2), (15, 3), (13, 4))):
        write_clip(s1 / f"DJI_000{i + 1}.mp4", n, seed)
        (s1 / f"DJI_000{i + 1}.SRT").write_text(srt_text(n, lat=37.39 + i * 1e-4))
        pd.DataFrame({"frame": range(n), "latitude": 37.39 + np.arange(n) * 1e-6,
                      "shutter": ["1/1000"] * n}).to_csv(s1 / f"DJI_000{i + 1}.csv", index=False)
    write_clip(s2 / "DJI_0009_trimmed.mp4", 14, 5)
    return root / "RAW"


def test_merge_videos_and_logs_matches_reference(tmp_path):
    raw = raw_sessions(tmp_path)
    common = ("--video-ext", ".mp4", "--srt-csv", "-q", "-lp", tmp_path / "logs")
    run_ref("merge_videos_and_logs", raw, "--output-dir", tmp_path / "ref", *common)
    run_port("merge_videos_and_logs", raw, "--output-dir", tmp_path / "port", *common)
    same_tree(tmp_path / "port", tmp_path / "ref")
    merged = tmp_path / "port" / "2022-10-04" / "D1" / "AM1"
    assert len(frames_of(merged / "0_merged.mp4")) == 48
    assert sorted(p.name for p in merged.iterdir()) == [
        "0_merged.csv", "0_merged.mp4", "0_merged.srt", "0_merged_srt.csv"]

    # explicit parts, and a dry run that writes nothing
    parts = sorted((raw / "2022-10-04" / "D1" / "AM1").glob("*.mp4"))[:2]
    for side in ("ref_parts", "port_parts"):
        (tmp_path / side).mkdir()
    run_ref("merge_videos_and_logs", *parts, "-o", tmp_path / "ref_parts" / "m.mp4", "-q",
            "-lp", tmp_path / "logs")
    run_port("merge_videos_and_logs", *parts, "-o", tmp_path / "port_parts" / "m.mp4", "-q",
             "-lp", tmp_path / "logs")
    same_tree(tmp_path / "port_parts", tmp_path / "ref_parts")
    run_port("merge_videos_and_logs", raw, "--output-dir", tmp_path / "dry", "--dry-run",
             *common)
    assert not (tmp_path / "dry").exists()


def test_recut_video_and_log_matches_reference(clips, tmp_path):
    for side in ("ref", "port"):
        d = tmp_path / side
        d.mkdir()
        write_clip(d / "U.mp4", 40, 7)
        pd.DataFrame({"frame": range(40), "timestamp": [f"t{i}" for i in range(40)],
                      "rel_alt": np.linspace(140, 141, 40)}).to_csv(d / "U.csv", index=False)
        (d / "cuts.txt").write_text("5, 33\n")
        (d / "rot.txt").write_text("3, 20, 90\n")
    keys = tvideo.keyframe_indices(tmp_path / "port" / "U.mp4")
    assert 5 not in keys and 12 in keys  # the cuts file's start snaps forward
    for run, side in ((run_ref, "ref"), (run_port, "port")):
        d = tmp_path / side
        run(("recut_video_and_log"), d / "U.mp4", d / "cuts.txt", "-q", "-lp", tmp_path)
        run("recut_video_and_log", d / "U.mp4", "-s", "3", "-e", "17", "-ec", "-o",
            d / "exact.mp4", "--debug", "-q", "-lp", tmp_path)
        run("recut_video_and_log", d / "U.mp4", d / "rot.txt", "-ec", "-o", d / "rot.mp4",
            "-q", "-lp", tmp_path)
        run("recut_video_and_log", d / "U.mp4", "-s", "12", "-e", "-1", "-o", d / "tail.mp4",
            "-b", "2M", "-q", "-lp", tmp_path)
    same_tree(tmp_path / "port", tmp_path / "ref")
    assert len(frames_of(tmp_path / "port" / "U_cut.mp4")) == 24 - 12 + 1
    assert frames_of(tmp_path / "port" / "rot.mp4")[0].shape == (160, 96, 3)
    cut = pd.read_csv(tmp_path / "port" / "exact.csv")
    assert cut["frame"].tolist() == list(range(15))


def test_cut_merged_videos_and_logs_matches_reference(tmp_path):
    locations = {"U": [37.39, 126.66], "K": [37.40, 126.70]}
    for side in ("ref", "port"):
        d = tmp_path / side / "2022-10-04" / "D1" / "AM1"
        d.mkdir(parents=True)
        write_clip(d / "0_merged.mp4", 60, 8)
        (d / "0_merged.srt").write_text(srt_text(60))
        (d / "0_merged.txt").write_text("3,30\n14,-1,180\n")
        (tmp_path / side / "locations.json").write_text(json.dumps(locations))
        one = tmp_path / side / "one"
        one.mkdir()
        write_clip(one / "K_clip.mp4", 40, 9)
        lat = np.r_[np.full(15, 37.40), 37.40 + np.arange(10) * 1e-4, np.full(15, 37.401)]
        pd.DataFrame({"frame": range(40), "latitude": lat, "longitude": np.full(40, 126.70),
                      "iso": [100] * 40}).to_csv(one / "K_clip.csv", index=False)
    for run, side in ((run_ref, "ref"), (run_port, "port")):
        root = tmp_path / side
        run("cut_merged_videos_and_logs", root, "-lm", root / "locations.json", "-q",
            "-lp", tmp_path / "logs")
        one = root / "one" / "K_clip.mp4"
        run("cut_merged_videos_and_logs", one, "--cuts", "A=5:20", "B=13:31",
            "--snap-keyframes", "-o", root / "explicit")
        run("cut_merged_videos_and_logs", one, "--auto", "--min-hover-frames", "8",
            "-lm", root / "locations.json", "-o", root / "auto")
    same_tree(tmp_path / "port", tmp_path / "ref")
    session = tmp_path / "port" / "2022-10-04" / "D1" / "AM1"
    assert (session / "0_merged_adjusted.txt").read_text() == "13,30,0\n25,60,180\n"
    assert sorted(p.name for p in session.glob("U*")) == ["U1.csv", "U1.mp4", "U2.csv",
                                                          "U2.mp4"]
    assert sorted(p.name for p in (tmp_path / "port" / "auto").iterdir())
