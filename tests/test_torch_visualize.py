"""The port's `visualize` stage against the JAX package's (``_visualize_impl``).

Exact where the reference's own tests are exact: headings, the polygon and
segment clips, the Q25 fallback dimensions, the readers of every tracks
layout in every mode, the transforms and the georeferenced table (its
Frame_ID reconstruction from timestamps included). The renders: the same
320x240 clip, tracks, transforms and georeferenced CSV through the
reference's ``run_visualization`` and the port's, each frame captured
before the encoder (the reference's ``cv2.VideoWriter`` and the port's
``open_writer`` replaced by recorders, and the reference's
``cv2.warpPerspective`` by the JAX package's ``warp_perspective``, the
port's counterpart). The stated tolerances, over every pixel of every frame:

- boxes only (``--hide-labels --hide-tracks``): mean |difference| at most
  0.35 grey levels, at most 0.3 % of pixels off by more than 32 levels;
- labels and tails shown: the same bounds (the text is within one level of
  cv2's; the strokes of boxes and ticks are where the two differ).

The files: ``python -m geotrax_tpu_torch visualize <clip> --device cpu -vm
0 1 2 3 4`` writes the reference's five file names with its frame counts,
and the decoded frames are within a mean of 6 levels of the reference's
decoded files: two MPEG-4 encoders (the port's own, cv2's), each lossy in
its own way.
"""

import argparse
import logging
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from geotrax_tpu.pipeline import _visualize_impl as jviz
from geotrax_tpu_torch.io import video as tvideo
from geotrax_tpu_torch.pipeline import _visualize_impl as timpl
from geotrax_tpu_torch.pipeline import visualize as tviz

LOG = logging.getLogger("test-torch-viz")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for torch: the frames are small, and the suite
    runs a worker on every core, where a thread pool per worker makes every
    one wait."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
CLASS_NAMES = {0: "car", 1: "bus", 2: "truck", 3: "motorcycle"}
W, H, N = 320, 240, 12
MEAN_TOL, SHARE_TOL = 0.35, 0.003


def make_args(**over):
    defaults = dict(
        source=None, cfg="default", output_folder=None, log_path=None, verbose=False,
        save=True, show=False, viz_mode=0, plot_trajectories=False, plot_delay=5,
        show_conf=False, show_lanes=False, show_class_names=False, hide_labels=False,
        hide_tracks=False, hide_speed=False, speed_unit="km/h", speed_deadzone=1,
        class_filter=[], tail_length=10, line_width=2, heading_smoothing=15,
        heading_min_speed=0.5, edge_clip_margin=3, edge_clip_smoothing=5,
        cut_frame_left=0, cut_frame_right=None, model=None,
        class_names=["0=car", "1=bus", "2=truck", "3=motorcycle"], device="cpu",
    )
    defaults.update(over)
    return argparse.Namespace(**defaults)


def random_tracks(seed=0, vehicles=6, n=N, ncols=15, w=W, h=H):
    """Rows of the extract stage's 15-column layout: vehicles on straight
    lines (one parked, one touching the border), a fallback (NaN)
    dimension estimate on one, every fifth row interpolated."""
    rng = np.random.default_rng(seed)
    rows = []
    for v in range(vehicles):
        x0, y0 = rng.uniform(20, w - 20), rng.uniform(20, h - 20)
        vx, vy = (0.0, 0.0) if v == 1 else rng.uniform(-4, 4, 2)
        if v == 3:
            x0, vx = 4.0, 0.5  # touches the left border
        for t in range(n):
            x, y = x0 + vx * t, y0 + vy * t
            bw, bh = rng.uniform(24, 34), rng.uniform(12, 18)
            rows.append([t, v + 1, x, y, bw, bh, x + 2, y - 1, bw, bh, v % 4,
                         rng.uniform(0.3, 1.0), np.nan if v == 2 else bw - 2, bh - 2,
                         float(t % 5 == 4)][:ncols])
    return np.array(rows)


def to_frame(rows) -> pd.DataFrame:
    return pd.DataFrame(rows, columns=range(rows.shape[1]))


# ---------------------------------------------------------------- helpers
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_headings_equal_the_references(seed):
    rows = random_tracks(seed, ncols=14)
    rows[rows[:, 1] == 1, 6:8] += np.arange(N)[:, None] * [[5.0, 0.0]]
    for smoothing, min_speed in ((15, 0.5), (3, 2.0), (0, 0.1)):
        want = jviz.compute_headings(to_frame(rows), smoothing, min_speed, LOG).to_numpy()
        got = timpl.compute_headings(rows, smoothing, min_speed, LOG)
        np.testing.assert_array_equal(got, want)


def test_headings_of_the_references_own_cases():
    def straight(v, n=30):
        return np.array([[t, 1, 500 + v[0] * t, 500 + v[1] * t, 60, 26, 500 + v[0] * t,
                          500 + v[1] * t, 60, 26, 0, 0.9, 60, 25] for t in range(n)], float)

    np.testing.assert_allclose(timpl.compute_headings(straight((5.0, 0.0)), 5, 0.5, LOG), 0.0,
                               atol=1e-6)
    np.testing.assert_allclose(timpl.compute_headings(straight((3.0, 3.0)), 5, 0.5, LOG),
                               np.pi / 4, atol=1e-6)
    still = straight((0.0, 0.0), 10)
    still[:, [4, 5]] = [20, 60]
    np.testing.assert_allclose(timpl.compute_headings(still, 5, 0.5, LOG), np.pi / 2, atol=1e-6)


def test_clips_equal_the_references():
    rng = np.random.default_rng(3)
    for _ in range(200):
        c = rng.uniform(-20, 120, 2)
        a = rng.uniform(0, np.pi)
        u, v = np.array([np.cos(a), np.sin(a)]), np.array([-np.sin(a), np.cos(a)])
        poly = np.array([c + s1 * 30 * u + s2 * 12 * v for s1, s2 in
                         ((1, -1), (1, 1), (-1, 1), (-1, -1))])
        rect = tuple(rng.uniform(0, 50, 2)) + tuple(rng.uniform(60, 110, 2))
        np.testing.assert_array_equal(timpl.clip_poly_to_rect(poly, *rect),
                                      jviz.clip_poly_to_rect(poly, *rect))
        p0, p1 = rng.uniform(-30, 130, 2), rng.uniform(-30, 130, 2)
        want = jviz.clip_segment_to_rect(p0, p1, *rect)
        got = timpl.clip_segment_to_rect(p0, p1, *rect)
        assert (got is None) == (want is None)
        if want is not None:
            np.testing.assert_array_equal(np.array(got), np.array(want))


def test_fallback_dims_equal_the_references():
    rows = random_tracks(4, ncols=14)
    want_l, want_w = jviz.estimate_fallback_dims(to_frame(rows))
    got_l, got_w = timpl.estimate_fallback_dims(rows)
    np.testing.assert_array_equal(got_l, want_l.to_numpy())
    np.testing.assert_array_equal(got_w, want_w.to_numpy())


@pytest.mark.parametrize("ncols", [10, 11, 14, 15])
@pytest.mark.parametrize("mode", [0, 1, 2, 3, 4])
def test_read_tracks_equals_the_references(tmp_path, monkeypatch, ncols, mode):
    rows = random_tracks(5, ncols=ncols)
    if ncols in (10, 11):  # no stabilized columns: frame..conf, length, width (+ interp)
        rows = random_tracks(5, ncols=15)[:, [0, 1, 2, 3, 4, 5, 10, 11, 12, 13, 14][:ncols]]
        rows[:, 8] = np.nan_to_num(rows[:, 8], nan=20.0)
    path = tmp_path / "V.txt"
    np.savetxt(path, rows, fmt="%g", delimiter=",")
    monkeypatch.setattr(jviz, "get_video_dimensions", lambda s: (W, H))
    args = make_args(viz_mode=mode, source=Path("V.mp4"))
    need_stab = mode > 0 and ncols < 14
    if need_stab:
        for impl, kw in ((jviz, {}), (timpl, {"frame_size": (W, H)})):
            with pytest.raises(SystemExit):
                impl.read_tracks(path, CLASS_NAMES, args, LOG, **kw)
        return
    want, want_plot = jviz.read_tracks(path, CLASS_NAMES, args, LOG)
    got, got_plot = timpl.read_tracks(path, CLASS_NAMES, args, LOG, frame_size=(W, H))
    np.testing.assert_array_equal(got, want.to_numpy(dtype=float))
    assert (got_plot is None) == (want_plot is None)
    if want_plot is not None:
        np.testing.assert_array_equal(got_plot, want_plot.to_numpy(dtype=float))


def test_read_tracks_needs_enough_class_names(tmp_path):
    path = tmp_path / "V.txt"
    np.savetxt(path, random_tracks(6, ncols=14), fmt="%g", delimiter=",")
    for impl in (jviz, timpl):
        with pytest.raises(SystemExit):
            impl.read_tracks(path, {0: "car"}, make_args(viz_mode=0), LOG)


def test_read_transforms_equals_the_references(tmp_path):
    path = tmp_path / "V_vid_transf.txt"
    rng = np.random.default_rng(7)
    rows = [np.concatenate([[f], (np.eye(3) + rng.normal(0, 0.01, (3, 3))).ravel()])
            for f in (1, 2, 3, 5)]
    np.savetxt(path, np.array(rows), fmt="%.16g", delimiter=",")
    want, got = jviz.read_transforms(path, LOG), timpl.read_transforms(path, LOG)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k])
    rows.append(np.concatenate([[6], (-np.eye(3)).ravel()]))
    np.savetxt(path, np.array(rows), fmt="%.16g", delimiter=",")
    for impl in (jviz, timpl):
        with pytest.raises(SystemExit):
            impl.read_transforms(path, LOG)


@pytest.mark.parametrize("frame_ref", ["Frame_Number", "Timestamp", "none"])
def test_read_georeferenced_equals_the_references(tmp_path, frame_ref):
    path = tmp_path / "g.csv"
    df = pd.DataFrame({
        "Vehicle_ID": [1, 1, 2, 2, 3],
        "Timestamp": ["10:00:00.2", "10:00:00.1", "10:00:00.1", "10:00:00.1", "10:00:00.3"],
        "Frame_Number": [1, 0, 0, 0, 2],
        "Vehicle_Speed": [10.5, 11.9, np.nan, 20.0, 0.4],
        "Lane_Number": [1, np.nan, 2, 3, 2],
    })
    if frame_ref != "Frame_Number":
        df = df.drop(columns=["Frame_Number"])
    if frame_ref == "none":
        df = df.drop(columns=["Timestamp"])
    df.to_csv(path, index=False)
    want = jviz.read_georeferenced_results(path, Path("v.mp4"), LOG)
    got = timpl.read_georeferenced_results(path, LOG)
    assert (got is None) == (want is None)
    if want is None:
        return
    assert [int(x) for x in got["Frame_ID"]] == want["Frame_ID"].tolist()
    by_frame = timpl.speed_lane_by_frame(got)
    for fid, grp in want.groupby("Frame_ID"):
        ref = grp.drop(columns=["Frame_ID"]).astype({"Vehicle_ID": int}).set_index("Vehicle_ID")
        assert sorted(by_frame[fid]) == sorted(set(ref.index))
        for vid in set(ref.index):
            vd = ref.loc[vid]
            if isinstance(vd, pd.DataFrame):  # the first row wins
                vd = vd.iloc[0]
            speed, lane = by_frame[fid][vid]
            assert (speed == vd["Vehicle_Speed"]) or (np.isnan(speed) and np.isnan(vd["Vehicle_Speed"]))
            assert (lane == vd["Lane_Number"]) or (np.isnan(lane) and np.isnan(vd["Lane_Number"]))


# ---------------------------------------------------------------- renders
@pytest.fixture
def clip(tmp_path):
    """A 12-frame 320x240 mp4v clip with its tracks, transforms (a drifting
    camera) and a georeferenced CSV (speeds, lanes, a vehicle twice in one
    frame, missing lanes)."""
    import cv2

    rng = np.random.default_rng(11)
    source = tmp_path / "V_clip.mp4"
    writer = cv2.VideoWriter(str(source), cv2.VideoWriter_fourcc(*"mp4v"), 30, (W, H))
    ys, xs = np.mgrid[0:H, 0:W]
    background = np.stack([60 + xs // 8, 70 + ys // 6, 90 + (xs + ys) // 12], -1).astype(np.uint8)
    for _ in range(12):
        y, x = rng.integers(0, H - 30), rng.integers(0, W - 30)
        background[y:y + 24, x:x + 24] = rng.integers(100, 220, 3)
    for i in range(N):
        frame = background.copy()
        frame[40:60, 30 + 5 * i:60 + 5 * i] = (200, 60, 60)
        writer.write(frame)
    writer.release()
    out = tmp_path / "results"
    out.mkdir()
    rows = random_tracks(8)
    np.savetxt(out / "V_clip.txt", rows, fmt="%g", delimiter=",")
    transf = [np.concatenate([[f], np.array([[1.0, 0.01, 2.0 * f], [-0.004, 1.0, -1.0 * f],
                                             [1e-5, 0.0, 1.0]]).ravel()]) for f in range(1, N)]
    np.savetxt(out / "V_clip_vid_transf.txt", np.array(transf), fmt="%.16g", delimiter=",")
    geo = pd.DataFrame({"Frame_Number": rows[:, 0].astype(int), "Vehicle_ID": rows[:, 1].astype(int),
                        "Vehicle_Speed": 30.0 + 7.3 * rows[:, 1] + rows[:, 0],
                        "Lane_Number": np.where(rows[:, 1] == 4, np.nan, rows[:, 1] % 3)})
    geo = pd.concat([geo, geo.iloc[[3]].assign(Vehicle_Speed=99.0)], ignore_index=True)
    geo.to_csv(out / "V_clip.csv", index=False)
    return source


class Recorder:
    def __init__(self, store, *args, **kwargs):
        self.frames = store

    def write(self, frame):
        self.frames.append(np.array(frame))

    def release(self):
        pass

    close = release


def reference_frames(monkeypatch, args) -> list:
    """The reference's frames (RGB) before its encoder, warped by the JAX
    package's warp_perspective."""
    import cv2
    import jax.numpy as jnp

    from geotrax_tpu.ops.warp import warp_perspective

    frames = []
    monkeypatch.setattr(cv2, "VideoWriter", lambda *a, **k: Recorder(frames))
    monkeypatch.setattr(cv2, "warpPerspective", lambda f, m, size: np.asarray(
        warp_perspective(jnp.asarray(f), jnp.asarray(m), size[1], size[0])))
    jviz.run_visualization(args, LOG)
    monkeypatch.undo()
    return [f[..., ::-1] for f in frames]


def port_frames(monkeypatch, args) -> tuple:
    frames = []
    monkeypatch.setattr(tviz, "open_writer", lambda *a, **k: Recorder(frames))
    stats = tviz.run_visualization(args, LOG)
    monkeypatch.undo()
    return frames, stats


def differences(want: list, got: list) -> np.ndarray:
    assert len(got) == len(want) and want
    assert all(g.shape == w.shape == (H, W, 3) and g.dtype == np.uint8 for g, w in zip(got, want))
    return np.stack([np.abs(g.astype(int) - w.astype(int)).max(-1) for g, w in zip(got, want)])


SHOWN = {"show_lanes": True, "show_class_names": True, "show_conf": True, "speed_unit": "mi/h"}


@pytest.mark.parametrize("shown", [False, True], ids=["boxes_only", "labels_and_tails"])
@pytest.mark.parametrize("mode", [0, 1, 2, 3, 4])
def test_end_to_end_render(clip, monkeypatch, mode, shown):
    over = SHOWN if shown else {"hide_labels": True, "hide_tracks": True}
    want = reference_frames(monkeypatch, make_args(source=clip, viz_mode=[mode], **over))
    got, stats = port_frames(monkeypatch, make_args(source=clip, viz_mode=[mode], **over))
    d = differences(want, got)
    assert len(got) == N and stats[0]["frames"] == N
    assert stats[0]["warped"] == (N - 1 if mode in (1, 4) else 0)
    assert d.mean() <= MEAN_TOL and (d > 32).mean() <= SHARE_TOL, (d.mean(), (d > 32).mean())


def test_render_with_the_trajectory_intro_and_a_cut(clip, monkeypatch):
    over = dict(plot_trajectories=True, plot_delay=3, cut_frame_left=2, cut_frame_right=9,
                class_filter=[1], line_width=3, **SHOWN)
    want = reference_frames(monkeypatch, make_args(source=clip, viz_mode=[1], **over))
    got, stats = port_frames(monkeypatch, make_args(source=clip, viz_mode=[1], **over))
    d = differences(want, got)
    assert len(got) == 3 + 7 and stats[0]["intro_frames"] == 3
    # the intro frame (addWeighted of the circles over the first frame)
    assert differences(want[:1], got[:1]).mean() <= MEAN_TOL
    assert d.mean() <= MEAN_TOL and (d > 32).mean() <= SHARE_TOL, (d.mean(), (d > 32).mean())


def test_cli_writes_the_references_files(clip, tmp_path):
    """Five modes from the CLI: the reference's file names and frame counts,
    decoded frames close to the reference's decoded files."""
    import cv2

    import shutil

    ref_clip = tmp_path / "ref" / clip.name
    shutil.copytree(clip.parent / "results", ref_clip.parent / "results")
    shutil.copy(clip, ref_clip)
    jviz.run_visualization(make_args(source=ref_clip, viz_mode=[0, 1, 2, 3, 4]), LOG)
    ref_dir = ref_clip.parent / "results"
    assert tviz.main([str(clip), "--device", "cpu", "-vm", "0", "1", "2", "3", "4",
                      "-lp", str(tmp_path / "logs"), "-cn", "0=car", "1=bus", "2=truck",
                      "3=motorcycle"]) == 0
    for mode in range(5):
        ours = clip.parent / "results" / f"V_clip_mode_{mode}.mp4"
        theirs = ref_dir / f"V_clip_mode_{mode}.mp4"
        assert ours.exists() and theirs.exists()
        got = [f for _, f in tvideo.VideoReader(ours, backend="cv2")]
        cap = cv2.VideoCapture(str(theirs))
        want = []
        while True:
            ok, f = cap.read()
            if not ok:
                break
            want.append(f[..., ::-1])
        cap.release()
        d = differences(want, got)
        assert d.mean() <= 6.0, (mode, d.mean())


# ---------------------------------------------------------------- the warp
def random_homography(rng, kind):
    h = np.eye(3) + rng.normal(0, [[0.03, 0.03, 8], [0.03, 0.03, 8], [5e-5, 5e-5, 0]])
    if kind == "partly_out":
        h[0, 2] += 150
    elif kind == "all_out":
        h[0, 2] += 2000
    return h.astype(np.float32)


@pytest.mark.parametrize("kind", ["inside", "partly_out", "all_out"])
def test_warp_equals_the_jax_warp(kind):
    """Equal to JAX's warp_perspective within 1 grey level (both bilinear in
    float32 through a float32 inverse; they part only at .5 ties where an
    ulp moves the rounding), on at most 0.5 % of pixels. Against
    cv2.warpPerspective (fixed-point weights) the distance is stated apart:
    within 1 level on interior pixels, with no bound asked of the border."""
    import cv2
    import jax.numpy as jnp
    import torch

    from geotrax_tpu.ops.warp import warp_perspective as jwarp
    from geotrax_tpu_torch.ops.warp import invert_homography, warp_perspective

    rng = np.random.default_rng({"inside": 0, "partly_out": 1, "all_out": 2}[kind])
    for _ in range(3):
        img = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
        hm = random_homography(rng, kind)
        want = np.asarray(jwarp(jnp.asarray(img), jnp.asarray(hm), H, W))
        got = warp_perspective(torch.from_numpy(img), invert_homography(hm), H, W).numpy()
        d = np.abs(got.astype(int) - want.astype(int))
        assert got.dtype == np.uint8 and d.max() <= 1 and (d > 0).mean() <= 0.005, d.max()
        c = np.abs(got.astype(int) - cv2.warpPerspective(img, hm, (W, H)).astype(int)).max(-1)
        # interior: every source neighbour inside the image
        ys, xs = np.mgrid[0:H, 0:W]
        src = np.stack([xs, ys, np.ones_like(xs)], -1) @ invert_homography(hm).T
        sx, sy = src[..., 0] / src[..., 2], src[..., 1] / src[..., 2]
        interior = (sx >= 1) & (sx < W - 2) & (sy >= 1) & (sy < H - 2)
        if interior.any():
            assert c[interior].max() <= 1


def test_writer_raises_naming_the_missing_libraries(tmp_path, monkeypatch):
    from geotrax_tpu_torch.io import native

    def broken():
        raise RuntimeError("cannot build the native encoder: no libavcodec headers")

    monkeypatch.setattr(native, "load_encoder_library", broken)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="libavcodec.*cv2|cv2.*libavcodec"):
        tvideo.VideoWriter(tmp_path / "x.mp4", 30, 32, 24)
    with pytest.raises(RuntimeError, match="--show needs cv2"):
        tvideo.preview(np.zeros((4, 4, 3), np.uint8))


def test_native_writer_round_trip(tmp_path):
    frames = [np.full((24, 32, 3), 10 * i, np.uint8) for i in range(7)]
    writer = tvideo.VideoWriter(tmp_path / "x.mp4", 25, 32, 24)
    assert writer.backend == "native"
    for f in frames:
        writer.write(f)
    with pytest.raises(ValueError):
        writer.write(np.zeros((10, 10, 3), np.uint8))
    writer.close()
    got = [f for _, f in tvideo.VideoReader(tmp_path / "x.mp4")]
    assert len(got) == 7
    assert max(np.abs(g.astype(int) - f.astype(int)).max() for g, f in zip(got, frames)) <= 3
