"""The port's georeferencing stage (geotrax_tpu_torch/pipeline/georeference.py
with io/geoassets.py, io/table.py and utils/file_utils.py) against the JAX
package's on the same inputs, on the CPU.

- Every function of the stage, given the same arguments, returns what the
  reference returns (exactly: the stage's host math is the same float64
  numpy; the lane assignment's float32 tests are the same operations).
- ``run_georeferencing`` with ``compute_homography`` replaced in both
  packages by the same homographies, and ``get_video_data`` by the same
  in-memory frame (no video file), writes the reference's bytes: the CSV,
  ``_geo_transf.txt`` and the master cache, on both geo sources, the master
  path and ``--no-master``, the cache written then reused, with and without
  a flight log, a segmentation and the interpolation column.
- One unpatched run per package on a synthetic pair at a 2x scale and 5
  degrees: the two homographies within 0.5 px at the frame's corners.
"""

import argparse
import logging
import shutil
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

from geotrax_tpu.io import geoassets as jassets
from geotrax_tpu.pipeline import _georeference_impl as jgeo
from geotrax_tpu.utils import file_utils as jfu
from geotrax_tpu_torch.io import geoassets as tassets
from geotrax_tpu_torch.io import table
from geotrax_tpu_torch.pipeline import georeference as tgeo
from geotrax_tpu_torch.utils import file_utils as tfu

LOG = logging.getLogger("test-torch-georeference")
FPS = 30000 / 1001
FRAME_SIZE = (120, 160)
# corner distance between the two packages' unpatched homographies [px]
H_CORNER_TOL = 0.5

H_REF_MASTER = np.array([[1.01, 0.02, 3.5], [-0.015, 0.995, -2.25], [1e-5, -2e-5, 1.0]])
H_MASTER_ORTHO = np.array([[1.4, -0.12, 20.0], [0.12, 1.4, 11.0], [0.0, 0.0, 1.0]])
H_REF_ORTHO = np.array([[1.39, -0.1, 24.0], [0.13, 1.41, 8.0], [2e-6, 1e-6, 1.0]])


def fake_homography(img_src, img_dst, src_dst, logger, **kw):
    h = {("reference", "master"): H_REF_MASTER, ("master", "ortho"): H_MASTER_ORTHO,
         ("reference", "ortho"): H_REF_ORTHO}[tuple(src_dst)]
    return h.copy(), f"Keypoints in {src_dst[0]} frame: 10, in {src_dst[1]}: 12. Inliers: 9"


def synthetic_tracks(n_frames=60, interpolate=True, seed=0):
    """Extract-stage rows (15 columns with interpolation, 14 without): five
    vehicles crossing the frame, one without dimensions, a short track that
    the min_traj_length filter removes, some rows interpolated."""
    rng = np.random.default_rng(seed)
    rows = []
    for vid, (x0, y0, vx, vy, n) in enumerate([(10, 20, 2.0, 0.3, n_frames),
                                               (150, 60, -2.5, 0.1, n_frames),
                                               (40, 100, 1.2, -0.8, 40), (80, 5, 0.5, 1.4, 50),
                                               (70, 70, 0.4, 0.4, 8)], start=1):
        start = int(rng.integers(0, 10))
        dims = (np.nan, np.nan) if vid == 4 else (14.0 + vid, 6.0 + vid / 2)
        for t in range(start, start + n):
            x, y = x0 + vx * (t - start) + rng.normal(0, 0.3), y0 + vy * (t - start)
            w, h = 12.0, 7.0
            interp = int(t % 11 == 3)
            rows.append([t, vid, x, y, w, h, x + 0.5, y - 0.25, w, h, vid % 3, 0.9, *dims,
                         interp])
    tracks = np.array(rows)[np.lexsort((np.array(rows)[:, 1], np.array(rows)[:, 0]))]
    return tracks if interpolate else tracks[:, :14]


def write_inputs(root: Path, geo_source: str, log: bool, seg: str | None, interpolate: bool):
    """One video's inputs under ``root``; returns the video's path."""
    rng = np.random.default_rng(1)
    ortho_dir = root / "ORTHO"
    (ortho_dir / "master_frames").mkdir(parents=True)
    Image.fromarray(rng.integers(0, 255, (200, 240, 3), dtype=np.uint8)).save(ortho_dir / "U.png")
    Image.fromarray(rng.integers(0, 255, (*FRAME_SIZE, 3), dtype=np.uint8)).save(
        ortho_dir / "master_frames" / "U.png")
    if geo_source == "text-file":
        (ortho_dir / "U.txt").write_text("# lng0 lat0 dlng dlat skew\n126.6 37.4 1.1e-6 -9e-7\n"
                                         "1e-8 -2e-8\n")
    else:
        (ortho_dir / "U_center.txt").write_text("21000 17500\n")
        (ortho_dir / "ortho_parameters.txt").write_text("126.6 37.42 1.13e-6 -9e-7 0 0\n")
    if seg is not None:
        (ortho_dir / "segmentations").mkdir()
        names = {"int": ["01", "01", "02"], "str": ["1_2", "1_2", "3_4"],
                 "float": ["1.5", "", "2"]}[seg]
        lines = ["section,lane,tlx,tly,blx,bly,brx,bry,trx,try,extra"]
        for name, lane, (x0, y0) in zip(names, (1, 2, 1), ((0, 0), (0, 60), (120, 0))):
            quad = [x0, y0, x0, y0 + 60, x0 + 130, y0 + 60, x0 + 130, y0]
            lines.append(",".join([name, str(lane)] + [str(v) for v in quad] + ["x"]))
        (ortho_dir / "segmentations" / "U.csv").write_text("\n".join(lines) + "\n")
    source = root / "U_clip.mp4"
    if log:
        stamps = [f"2022-10-07 17:52:{13 + i // 30:02d}.{(i % 30) * 33:03d}" for i in range(80)]
        frames = [3 + i for i in range(80)]
        frames[10] = frames[9]  # a repeated frame: the first row wins
        pd.DataFrame({"frame": frames, "timestamp": stamps}).to_csv(source.with_suffix(".csv"),
                                                                    index=False)
    (root / "results").mkdir()
    np.savetxt(root / "results" / "U_clip.txt", synthetic_tracks(interpolate=interpolate),
               fmt="%.6g", delimiter=",")
    return source


# GeoTIFF tag sets of the 'metadata-tif' source: tiepoint and scale, with a
# ModelTransformation's skew beside them, a transformation alone, none
_TRANSFORM = (1.1e-6, 3e-9, 0.0, 126.61, -2e-9, -9e-7, 0.0, 37.41, 0.0, 0.0, 0.0, 0.0,
              0.0, 0.0, 0.0, 1.0)
GEOTIFF_TAGS = {
    "tiepoint+scale": {33922: (0.0, 0.0, 0.0, 126.6, 37.4, 0.0), 33550: (1.1e-6, 9e-7, 0.0)},
    "with skew": {33922: (0.0, 0.0, 0.0, 126.6, 37.4, 0.0), 33550: (1.1e-6, 9e-7, 0.0),
                  34264: _TRANSFORM},
    "transform only": {34264: _TRANSFORM},
    "none": {},
}


def write_geotiff(path: Path, rgb: np.ndarray, tags: dict, **kw) -> None:
    """``rgb`` as a TIFF through Pillow with the GeoTIFF ``tags`` as DOUBLE
    (type 12) values."""
    from PIL import TiffImagePlugin

    ifd = TiffImagePlugin.ImageFileDirectory_v2()
    for tag, values in tags.items():
        ifd[tag] = values
        ifd.tagtype[tag] = 12
    Image.fromarray(rgb).save(path, "TIFF", tiffinfo=ifd, **kw)


def args_for(source: Path, no_master: bool, port: bool) -> argparse.Namespace:
    ns = argparse.Namespace(source=source, cfg="default", output_folder=None, log_path=None,
                            verbose=False, ortho_folder=source.parent / "ORTHO", geo_source=None,
                            ref_frame=None, no_master=True if no_master else None,
                            master_folder=None, recompute=None, segmentation_folder=None)
    if port:
        ns.device = "cpu"
    return ns


@pytest.fixture
def patched(monkeypatch):
    frame = np.random.default_rng(9).integers(0, 255, (*FRAME_SIZE, 3), dtype=np.uint8)
    for mod in (jgeo, tgeo):
        monkeypatch.setattr(mod, "compute_homography", fake_homography)
        monkeypatch.setattr(mod, "get_video_data", lambda s, r, lg: (frame, FRAME_SIZE, FPS))


CASES = {
    "center-master-log-intseg-interp": ("center-text-file", False, True, "int", True),
    "text-nomaster-nolog-noseg-plain": ("text-file", True, False, None, False),
    "text-master-log-noseg-plain": ("text-file", False, True, None, False),
    "center-nomaster-nolog-strseg-interp": ("center-text-file", True, False, "str", True),
    "text-master-nolog-floatseg-interp": ("text-file", False, False, "float", True),
}


def outputs(root: Path) -> dict:
    files = {"csv": root / "results" / "U_clip.csv",
             "geo": root / "results" / "U_clip_geo_transf.txt",
             "cache": root / "ORTHO" / "master_frames" / "U.txt"}
    return {k: p.read_bytes() for k, p in files.items() if p.exists()}


@pytest.mark.parametrize("case", list(CASES))
def test_run_georeferencing_bytes_equal(tmp_path, patched, case):
    geo_source, no_master, log, seg, interpolate = CASES[case]
    written = {}
    for name, mod in (("jax", jgeo), ("port", tgeo)):
        root = tmp_path / name
        source = write_inputs(root, geo_source, log, seg, interpolate)
        runs = []
        for _ in range(2):  # the cache is written, then reused
            mod.run_georeferencing(args_for(source, no_master, name == "port"), LOG)
            runs.append(outputs(root))
        written[name] = runs
    for ref, port in zip(written["jax"], written["port"]):
        assert set(port) == set(ref) == ({"csv", "geo"} if no_master else {"csv", "geo", "cache"})
        for key in ref:
            assert port[key] == ref[key], key
    header = written["port"][0]["csv"].split(b"\n")[0].split(b",")
    assert len(header) == 14 + log + 2 * (seg is not None) + interpolate


@pytest.mark.parametrize("no_master", [False, True])
def test_run_georeferencing_from_a_geotiff(tmp_path, patched, no_master):
    """A folder whose ortho is only ``U.tif`` (tiepoint and scale, LZW):
    both packages convert it to ``U.png`` (equal pixels) and write the same
    files, a second run from the PNG and the cache too."""
    written, pngs = {}, {}
    for name, mod in (("jax", jgeo), ("port", tgeo)):
        root = tmp_path / name
        source = write_inputs(root, "text-file", True, "int", True)
        ortho = root / "ORTHO"
        rgb = np.asarray(Image.open(ortho / "U.png").convert("RGB"))
        (ortho / "U.png").unlink()
        (ortho / "U.txt").unlink()
        write_geotiff(ortho / "U.tif", rgb, GEOTIFF_TAGS["tiepoint+scale"],
                      compression="tiff_lzw")
        runs = []
        for _ in range(2):
            mod.run_georeferencing(args_for(source, no_master, name == "port"), LOG)
            runs.append(outputs(root))
        written[name] = runs
        pngs[name] = np.asarray(Image.open(ortho / "U.png").convert("RGB"))
        np.testing.assert_array_equal(pngs[name], rgb)
    np.testing.assert_array_equal(pngs["port"], pngs["jax"])
    for ref, port in zip(written["jax"], written["port"]):
        assert set(port) == set(ref) and "csv" in ref
        for key in ref:
            assert port[key] == ref[key], key


def test_cli_runs_the_stage(tmp_path, patched, capsys):
    """``python -m geotrax_tpu_torch georeference <video> --device cpu``
    writes the files; without --device it asks for the card."""
    from geotrax_tpu_torch import cli

    source = write_inputs(tmp_path, "text-file", True, "int", True)
    argv = ["georeference", str(source), "--ortho-folder", str(tmp_path / "ORTHO"),
            "-lp", str(tmp_path / "logs")]
    assert cli.main(argv + ["--device", "cpu"]) == 0
    assert set(outputs(tmp_path)) == {"csv", "geo", "cache"}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device 'cuda'"):
            cli.main(argv)


# ---------------------------------------------------------------------------
# every function against the reference
# ---------------------------------------------------------------------------

def same(a, b):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            same(x, y)
    elif a is None:
        assert b is None
    else:
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


@pytest.mark.parametrize("interpolate", [True, False])
def test_tracking_data(tmp_path, interpolate):
    source = write_inputs(tmp_path, "text-file", False, None, interpolate)
    same(jgeo.get_tracking_data(source, LOG), tgeo.get_tracking_data(source, LOG))
    np.savetxt(tmp_path / "results" / "U_clip.txt", np.ones((3, 10)), delimiter=",")
    with pytest.raises(SystemExit):
        tgeo.get_tracking_data(source, LOG)
    (tmp_path / "results" / "U_clip.txt").unlink()
    with pytest.raises(SystemExit):
        tgeo.get_tracking_data(source, LOG)


@pytest.mark.parametrize("log", ["rebase-dup", "zero", "none", "empty", "upper"])
def test_timestamps(tmp_path, log):
    source = tmp_path / "U_clip.mp4"
    frames = np.array([0, 1, 5, 9, 40, 82, 83, 200])
    if log in ("rebase-dup", "zero", "upper"):
        start = 0 if log == "zero" else 3
        stamps = [f"2022-10-07 17:52:13.{i:03d}" for i in range(80)]
        fr = list(range(start, start + 80))
        fr[7] = fr[6]
        path = source.with_suffix(".CSV" if log == "upper" else ".csv")
        pd.DataFrame({"frame": fr, "timestamp": stamps}).to_csv(path, index=False)
    elif log == "empty":
        source.with_suffix(".csv").write_text("frame,timestamp\n")
    ref = jgeo.get_timestamps(source, frames, LOG)
    out = tgeo.get_timestamps(source, frames, LOG)
    assert out.dtype == ref.dtype and out.shape == ref.shape
    np.testing.assert_array_equal(out, ref)


def test_coordinate_math():
    rng = np.random.default_rng(2)
    x, y = rng.uniform(0, 160, 300), rng.uniform(0, 120, 300)
    params = (126.6, 37.42, 1.13e-6, -9e-7, 1e-9, -2e-9)
    same(jgeo.apply_homography_np(x, y, H_REF_ORTHO), tgeo.apply_homography_np(x, y, H_REF_ORTHO))
    same(jgeo.ortho2geo(x, y, params), tgeo.ortho2geo(x, y, params))
    lat, lng = tgeo.ortho2geo(x, y, params)
    same(jgeo.geo2local(lat, lng, "epsg:4326", "epsg:5186"),
         tgeo.geo2local(lat, lng, "epsg:4326", "epsg:5186"))
    pts = np.stack([x, y], -1)
    same(jgeo.frame2local(pts, H_REF_ORTHO, params, "epsg:4326", "epsg:5186"),
         tgeo.frame2local(pts, H_REF_ORTHO, params, "epsg:4326", "epsg:5186"))
    tracks = synthetic_tracks()
    ids = tracks[:, 1].astype(int)
    same(jgeo.convert_dimensions(ids, tracks[:, 12:14], FRAME_SIZE, H_REF_ORTHO, params,
                                 "epsg:4326", "epsg:5186"),
         tgeo.convert_dimensions(ids, tracks[:, 12:14], FRAME_SIZE, H_REF_ORTHO, params,
                                 "epsg:4326", "epsg:5186"))
    for margin in (0, 4, 10):
        same(jgeo.calculate_visibility(ids, tracks[:, 2:6], FRAME_SIZE, margin),
             tgeo.calculate_visibility(ids, tracks[:, 2:6], FRAME_SIZE, margin))


@pytest.mark.parametrize("filter_type,kernel", [("gaussian", 14), ("gaussian", 3),
                                                ("savgol", 14), ("savgol", 7)])
def test_kinematics(filter_type, kernel):
    tracks = synthetic_tracks()
    ids, frames = tracks[:, 1].astype(int), tracks[:, 0].astype(int)
    xl, yl = tracks[:, 6] * 0.1 + 200000.0, tracks[:, 7] * 0.1 + 500000.0
    vis = jgeo.calculate_visibility(ids, tracks[:, 2:6], FRAME_SIZE, 4)
    for interp in (tracks[:, 14].astype(int), None):
        same(jgeo.compute_kinematics(ids, frames, xl, yl, vis, FPS, filter_type, kernel,
                                     is_interpolated=interp),
             tgeo.compute_kinematics(ids, frames, xl, yl, vis, FPS, filter_type, kernel,
                                     is_interpolated=interp))
    s = np.array([1.0, 2.0, 4.0, 7.0, 7.5])
    same(jgeo.compute_speed(s, s[::-1], FPS), tgeo.compute_speed(s, s[::-1], FPS))
    same(jgeo.compute_acceleration(s, FPS), tgeo.compute_acceleration(s, FPS))
    same(jgeo.interpolate_missing_points([3, 4, 7], s[:3], s[2:]),
         tgeo.interpolate_missing_points([3, 4, 7], s[:3], s[2:]))
    same(jgeo.apply_filter(s, kernel, filter_type), tgeo.apply_filter(s, kernel, filter_type))
    with pytest.raises(ValueError):
        tgeo.apply_filter(s, kernel, "median")


@pytest.mark.parametrize("seg", ["int", "str", "float", None])
def test_lane_assignment(tmp_path, seg):
    write_inputs(tmp_path, "text-file", False, seg, True)
    ref_seg = jassets.get_road_section_lane_geometry(tmp_path / "ORTHO", None, "U", LOG)
    port_seg = tassets.get_road_section_lane_geometry(tmp_path / "ORTHO", None, "U", LOG)
    assert list(port_seg) == list(ref_seg.columns)
    for name in ref_seg.columns:  # same values and types (repr: NaN equals NaN)
        assert port_seg[name].dtype == ref_seg[name].to_numpy().dtype or seg == "str"
        assert ([repr(v) for v in port_seg[name].tolist()]
                == [repr(v) for v in ref_seg[name].to_numpy(dtype=object).tolist()])
    rng = np.random.default_rng(4)
    ox, oy = rng.uniform(-10, 260, 400), rng.uniform(-10, 130, 400)
    ref = jgeo.assign_road_section_lane(ox, oy, ref_seg)
    out = tgeo.assign_road_section_lane(ox, oy, port_seg, "cpu")
    if seg is None:
        assert out == ref == (None, None)
        return
    np.testing.assert_array_equal(out[1], ref[1])
    assert [repr(v) for v in out[0]] == [repr(v) for v in ref[0]]


@pytest.mark.parametrize("timestamps,seg,interp,min_len", [
    (True, True, True, 15), (False, False, False, 15), (True, False, True, 0),
    (False, True, False, 41)])
def test_output_table_bytes(tmp_path, timestamps, seg, interp, min_len):
    """The columns written by the port's CSV writer are the bytes
    ``create_and_format_georeferenced_df(...).to_csv(index=False)`` writes
    (rounding, NaN, -0.0, absent columns, the min_traj_length filter)."""
    rng = np.random.default_rng(5)
    tracks = synthetic_tracks()
    n = len(tracks)
    ids, frames = tracks[:, 1].astype(int), tracks[:, 0].astype(int)
    stamps = np.array([f"2022-10-07 17:52:13.{i % 1000:03d}" for i in range(n)]) if timestamps \
        else np.array([])
    vals = [rng.normal(0, 1, n) * s for s in (100, 100, 1e5, 1e5, 1, 1)]
    vals[0][:3] = [-0.04, 1e-05, 1e16]
    dims = (np.where(ids == 4, np.nan, 4.123456), np.where(ids == 4, np.nan, 1.87))
    speed = np.where(rng.uniform(size=n) < 0.2, np.nan, rng.normal(40, 10, n))
    accel = np.where(np.isnan(speed), np.nan, rng.normal(0, 1, n))
    section = np.where(rng.uniform(size=n) < 0.5, np.array([3, 4] * (n // 2) + [3] * (n % 2),
                                                            dtype=object), None) if seg else None
    lane = np.where(section != None, 2.0, np.nan) if seg else None  # noqa: E711
    vis = rng.uniform(size=n) < 0.8
    interp_col = tracks[:, 14].astype(int) if interp else None
    args = (ids, stamps, frames, *vals, dims, tracks[:, 10].astype(int), speed, accel, section,
            lane, vis, min_len, interp_col)
    df = jgeo.create_and_format_georeferenced_df(*args, logger=LOG)
    df.to_csv(tmp_path / "ref.csv", index=False)
    table.write_csv(tmp_path / "port.csv", tgeo.create_georeferenced_columns(*args, logger=LOG))
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "ref.csv").read_bytes()


def test_master_cache_and_hash(tmp_path, monkeypatch):
    """Cache written, reused, invalidated by a changed master frame, in
    the reference's format; an unreadable cache ends the run."""
    master = np.random.default_rng(0).integers(0, 255, (50, 50, 3), np.uint8)
    assert tgeo.compute_hash(master) == jgeo.compute_hash(master)
    calls = []
    for mod, assets in ((jgeo, jgeo.geoassets), (tgeo, tgeo.geoassets)):
        monkeypatch.setattr(mod, "compute_homography",
                            lambda *a, **k: (calls.append(1), fake_homography(*a, **k))[1])
        monkeypatch.setattr(assets, "get_orthophoto", lambda f, l, lg: np.zeros((9, 9, 3), np.uint8))
    written = {}
    for name, mod in (("jax", jgeo), ("port", tgeo)):
        folder = tmp_path / name
        (folder / "master_frames").mkdir(parents=True)
        calls.clear()
        h1 = mod.get_master_to_ortho_homography(master, folder, None, "U", False, {}, LOG)
        h2 = mod.get_master_to_ortho_homography(master, folder, None, "U", False, {}, LOG)
        assert len(calls) == 1
        written[name] = (folder / "master_frames" / "U.txt").read_bytes()
        other = master.copy()
        other[0, 0, 0] ^= 1
        mod.get_master_to_ortho_homography(other, folder, None, "U", False, {}, LOG)
        mod.get_master_to_ortho_homography(other, folder, None, "U", True, {}, LOG)
        assert len(calls) == 3
        np.testing.assert_array_equal(h1, H_MASTER_ORTHO)
        np.testing.assert_array_equal(h2, H_MASTER_ORTHO)
    assert written["port"] == written["jax"]
    (tmp_path / "port" / "master_frames" / "U.txt").write_text("garbage\n")
    with pytest.raises(SystemExit):
        tgeo.get_master_to_ortho_homography(master, tmp_path / "port", None, "U", False, {}, LOG)


def test_geoassets(tmp_path, caplog):
    write_inputs(tmp_path, "text-file", False, None, True)
    folder = tmp_path / "ORTHO"
    same(jassets.read_ortho_config_file(folder / "U.txt"),
         tassets.read_ortho_config_file(folder / "U.txt"))
    assert tassets.get_geo_params_source(None, folder, "U", LOG) == "text-file"
    assert (tassets.get_ortho_parameters(folder, "U", "text-file", 15000, LOG)
            == jassets.get_ortho_parameters(folder, "U", "text-file", 15000, LOG))
    (folder / "U_center.txt").write_text("7000 6000\n")
    (folder / "ortho_parameters.txt").write_text("126.0 38.0 1e-6 -1e-6 1e-9 2e-9\n")
    with pytest.raises(SystemExit):  # both sources present
        tassets.get_geo_params_source(None, folder, "U", LOG)
    (folder / "U.txt").unlink()
    assert tassets.get_geo_params_source(None, folder, "U", LOG) == "center-text-file"
    for cutout in (15000, 240, None):
        assert (tassets.get_ortho_parameters(folder, "U", "center-text-file", cutout, LOG)
                == jassets.get_ortho_parameters(folder, "U", "center-text-file", cutout, LOG))
    same(tassets.get_orthophoto(folder, "U", LOG), jassets.get_orthophoto(folder, "U", LOG))
    same(tassets.get_master_frame(folder, None, "U", LOG),
         jassets.get_master_frame(folder, None, "U", LOG))
    with pytest.raises(SystemExit):
        tassets.get_master_frame(folder, tmp_path, "U", LOG)
    with pytest.raises(SystemExit):
        tassets.get_geo_params_source("geotiff", folder, "U", LOG)
    # metadata-tif: a lone GeoTIFF is detected and converted to the PNG (in
    # each package's own folder), its tags read as the reference reads them
    rgb = np.random.default_rng(4).integers(0, 255, (50, 70, 3), dtype=np.uint8)
    pngs = {}
    for name, mod in (("jax", jassets), ("port", tassets)):
        sub = tmp_path / f"TIF_{name}"
        sub.mkdir()
        write_geotiff(sub / "U.tif", rgb, GEOTIFF_TAGS["tiepoint+scale"])
        with pytest.raises(SystemExit):  # a .txt source beside it
            (sub / "U.txt").write_text("1 2 3 4\n")
            mod.get_geo_params_source(None, sub, "U", LOG)
        (sub / "U.txt").unlink()
        assert mod.get_geo_params_source(None, sub, "U", LOG) == "metadata-tif"
        pngs[name] = np.asarray(Image.open(sub / "U.png").convert("RGB"))
    np.testing.assert_array_equal(pngs["port"], pngs["jax"])
    np.testing.assert_array_equal(pngs["port"], rgb)
    for case, tags in GEOTIFF_TAGS.items():
        write_geotiff(folder / "U.tif", rgb, tags)
        if case == "none":
            for mod in (jassets, tassets):
                with pytest.raises(SystemExit):
                    mod.get_ortho_parameters(folder, "U", "metadata-tif", None, LOG)
            continue
        want = jassets.get_ortho_parameters(folder, "U", "metadata-tif", None, LOG)
        assert tassets.get_ortho_parameters(folder, "U", "metadata-tif", None, LOG) == want, case
        assert (want[4], want[5]) != (0.0, 0.0) or case == "tiepoint+scale"
    # not a TIFF, and a layout the port does not read: exit 1 naming it
    (folder / "U.tif").write_bytes(b"\x89PNG\r\n\x1a\n" + bytes(40))
    with pytest.raises(SystemExit):
        tassets.get_ortho_parameters(folder, "U", "metadata-tif", None, LOG)
    sub = tmp_path / "TIF_16"
    sub.mkdir()
    Image.fromarray((rgb[..., 0].astype(np.uint16) * 200)).save(sub / "U.tif")
    with caplog.at_level(logging.CRITICAL, logger=LOG.name):
        with pytest.raises(SystemExit):
            tassets.get_geo_params_source(None, sub, "U", LOG)
    assert "tag 258 BitsPerSample = (16,)" in caplog.text


def test_file_utils(tmp_path):
    for text in ("1,2,3\n4,5,6\n", "1 2 3\n", "a\tb\tc\n1\t2\t3\n"):
        (tmp_path / "f.txt").write_text(text)
        assert tfu.detect_delimiter(tmp_path / "f.txt") == jfu.detect_delimiter(tmp_path / "f.txt")
    for name in ("2025-01-01_A_PM1.mp4", "Songdo_D1.mp4", "AB-3.mp4", "xyz.mp4"):
        assert tfu.determine_location_id(Path(name)) == jfu.determine_location_id(Path(name))
    with pytest.raises(SystemExit):
        tfu.determine_location_id(Path("2025_01.mp4"), LOG)
    video = tmp_path / "PROCESSED" / "2025" / "D1" / "v.mp4"
    video.parent.mkdir(parents=True)
    (tmp_path / "ORTHOPHOTOS").mkdir()
    assert tfu.get_ortho_folder(video, None, LOG) == jfu.get_ortho_folder(video, None, LOG)
    assert tfu.get_ortho_folder(tmp_path / "v.mp4", None, LOG, critical=False) is None
    with pytest.raises(SystemExit):
        tfu.get_ortho_folder(tmp_path / "v.mp4", tmp_path / "missing", LOG)


# ---------------------------------------------------------------------------
# one unpatched registration per package
# ---------------------------------------------------------------------------

def test_unpatched_registration_agrees(tmp_path, monkeypatch):
    """--no-master on a synthetic pair (the frame sees the ortho at a 2x
    scale, turned 5 degrees): both packages' reference -> ortho homographies
    within H_CORNER_TOL at the frame's corners, and near the true warp."""
    import jax

    import chip_smoke
    import geotrax_tpu.ops.ransac as jr
    from test_torch_pipeline import fit_homography_normal_eigh64

    ortho, _ = chip_smoke.synthetic_ortho(512, rects=120)
    fw, fh = 224, 128
    c, s = 2 * np.cos(np.deg2rad(5)), 2 * np.sin(np.deg2rad(5))
    h_true = np.array([[c, -s, 256 - (c * fw / 2 - s * fh / 2)],
                       [s, c, 256 - (s * fw / 2 + c * fh / 2)], [0, 0, 1.0]])
    frame = chip_smoke.render_frame(torch.as_tensor(ortho), h_true, fw, fh, 1.3, 0)
    root = tmp_path
    (root / "ORTHO").mkdir()
    Image.fromarray(ortho).save(root / "ORTHO" / "U.png")
    (root / "ORTHO" / "U.txt").write_text("126.6 37.4 1.1e-6 -9e-7\n")
    (root / "results").mkdir()
    np.savetxt(root / "results" / "U_clip.txt", synthetic_tracks(), fmt="%.6g", delimiter=",")
    cfg = (Path(tgeo.__file__).resolve().parents[1] / "cfg" / "default.yaml").read_text()
    (root / "small.yaml").write_text(cfg.replace("    max_features: 250000\n",
                                                 "    max_features: 3000\n"))
    for mod in (jgeo, tgeo):
        monkeypatch.setattr(mod, "get_video_data", lambda s, r, lg: (frame, (fh, fw), FPS))
    monkeypatch.setattr(jr, "fit_homography_normal", fit_homography_normal_eigh64)
    jax.clear_caches()
    hs = {}
    try:
        for name, mod in (("jax", jgeo), ("port", tgeo)):
            args = args_for(root / "U_clip.mp4", True, name == "port")
            args.cfg = str(root / "small.yaml")
            mod.run_georeferencing(args, LOG)
            hs[name] = np.loadtxt(root / "results" / "U_clip_geo_transf.txt",
                                  delimiter=",").reshape(3, 3)
            shutil.move(root / "results" / "U_clip.csv", root / f"{name}.csv")
    finally:
        jax.clear_caches()
    assert chip_smoke.corner_error(hs["port"], hs["jax"], fw, fh) < H_CORNER_TOL
    assert chip_smoke.corner_error(hs["port"], h_true, fw, fh) < 2.0
