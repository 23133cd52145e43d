"""The port's tools (geotrax_tpu_torch/tools) against the JAX package's
(tools/*.py) on the same seeded inputs, each through its command line: the
reference tool's ``main()`` with ``sys.argv`` set, the port's
``main(argv + ["--device", "cpu"])``, both in the test's process (a
subprocess each would pay for importing JAX and torch again).

- every tool's ``--help`` (the module run as __main__), and every module
  imported with jax, geotrax_tpu, pandas, cv2, PIL, yaml and matplotlib
  refused;
- ``dji_srt``: SRT text and the telemetry CSV byte-equal to the reference's
  (pandas), flight logs equal; ``_common``'s labels and image order equal;
- ``io/table.py``, which the tools' CSVs go through: float cells read
  bit-equal to pandas, tables joined and typed as ``pd.concat`` does;
- ``annotate_frames`` with a seeded YOLOv8s (class head sharpened so that
  scores spread, saved once as .npz and given to both), without and with
  ``--augment``: label lines equal in count and class, boxes within
  BOX_TOL_PX, ``--save-conf`` scores within SCORE_TOL, masked images equal;
- ``benchmark_ortho_matching`` ``--synthetic`` (the same warps: the port's
  warp equals the JAX one), ``--synthetic-cross-domain`` and
  ``--synthetic-ortho`` at small sizes (cv2's fixed-point warp against the
  port's float32 one): inliers and matches equal, corner errors within
  CORNER_TOL_PX of the reference tool's (SYNTHETIC_TOL_PX for --synthetic);
- ``verify_detector_parity``: the converter's raw head output within 1e-5
  of the unfolded-BN oracle on a selftest checkpoint, from memory and as a
  .pt file, with the reference tool's anchor count; the final boxes paired
  one to one within ``--tol-box``, PASS in both packages;
- ``find_master_frames`` and ``sample_frames`` on mp4 clips written by cv2:
  the same frame chosen and the same PNG pixels, the same sampled names in
  every mode.
"""

import contextlib
import importlib
import io
import os
import re
import runpy
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pandas as pd
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
TOOLS = ROOT / "tools"
PORT_TOOLS = ("annotate_frames", "benchmark_ortho_matching", "verify_detector_parity",
              "find_master_frames", "sample_frames", "merge_videos_and_logs",
              "recut_video_and_log", "cut_merged_videos_and_logs",
              # the host-only tools (tests/test_torch_tools_host.py)
              "find_max_annotations", "interpolate_missing_timestamps", "yolo_to_coco",
              "fix_json_annotations", "find_source_id", "check_dataset", "compare_tracking",
              "analyze_bb_ratios", "compute_bb_center_error", "find_cut_video_issues",
              "fix_timestamp_anomalies", "viz_dimension_estimation",
              "compare_av_detections_and_tune_filters", "subset_orthophoto",
              "viz_annotations", "viz_segmentations")
REFUSED = ("jax", "jaxlib", "flax", "optax", "geotrax_tpu", "pandas", "cv2", "PIL", "yaml",
           "matplotlib")
ENV = {**os.environ, "OMP_NUM_THREADS": "2", "JAX_PLATFORMS": "cpu"}

BOX_TOL_PX = 0.01        # a label's box, JAX against the port on the CPU
SCORE_TOL = 1.5e-4       # --save-conf prints 4 decimals: rounding plus float32 noise
SYNTHETIC_TOL_PX = 0.02  # printed with 2 decimals
CORNER_TOL_PX = 1.0      # cv2's 5-bit bilinear against the port's float32 warp

sys.path.insert(0, str(TOOLS))


def run_ref(name, *args) -> str:
    """The reference tool's main() in this process (its module imported from
    tools/, sys.argv set as the command line); its stdout and stderr."""
    mod = importlib.import_module(name)
    out = io.StringIO()
    argv = [f"{name}.py", *map(str, args)]
    with mock.patch.object(sys, "argv", argv), contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(out):
        rc = mod.main()
    assert rc == 0, out.getvalue()[-3000:]
    return out.getvalue()


def run_port(name, *args, device=True) -> str:
    """The port's tool's main(argv) in this process; its stdout and stderr."""
    mod = importlib.import_module(f"geotrax_tpu_torch.tools.{name}")
    out = io.StringIO()
    argv = [*map(str, args), *(("--device", "cpu") if device else ())]
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(out):
        rc = mod.main(argv)
    assert rc == 0, out.getvalue()[-3000:]
    return out.getvalue()


@pytest.mark.parametrize("tool", PORT_TOOLS)
def test_port_tool_help(tool, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", [tool, "--help"])
    with pytest.raises(SystemExit) as exc:
        runpy.run_module(f"geotrax_tpu_torch.tools.{tool}", run_name="__main__")
    assert exc.value.code == 0
    assert "usage" in capsys.readouterr().out.lower()


def test_tools_import_without_jax_or_host_libraries():
    code = f'''
import importlib, importlib.abc, pkgutil, sys
REFUSED = {REFUSED!r}

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError(f"refused import of {{name}}")
        return None

sys.meta_path.insert(0, Refuse())
import geotrax_tpu_torch.tools as tools
names = [m.name for m in pkgutil.iter_modules(tools.__path__, "geotrax_tpu_torch.tools.")]
for name in names:
    importlib.import_module(name)
assert not [m for m in sys.modules if m.split(".")[0] in REFUSED]
print("IMPORTED", len(names))
'''
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=ROOT, env={**ENV, "PYTHONPATH": str(ROOT)})
    assert res.returncode == 0, res.stderr[-3000:]
    assert f"IMPORTED {len(PORT_TOOLS) + 2}" in res.stdout  # + _common, dji_srt


# ---------------------------------------------------------------------------
# dji_srt and _common
# ---------------------------------------------------------------------------

BLOCKS = """1
00:00:00,000 --> 00:00:00,033
<font size="28">FrameCnt: 1, DiffTime: 33ms
2023-10-04 09:12:58.123
[iso: 100] [shutter: 1/1000.0] [fnum: 2.8] [ev: 0] [color_md : default] [focal_len: 24.00] [latitude: 37.382276] [longitude: 126.656415] [rel_alt: 148.800 abs_alt: 163.123] </font>

2
00:00:00,033 --> 00:00:00,066
<font size="28">SrtCnt : 2, DiffTime : 33ms
2023-10-04 09:12:58.156
[iso : 110, shutter : 1/800.0, fnum : 280] [latitude: 37.382279] [longtitude: 126.656418] [altitude: 148.900] </font>

3
00:00:00,066 --> 00:00:00,100
<font size="28">FrameCnt: 3, DiffTime: 33ms
2023-10-04 09:12:58.189
[iso: 100] [shutter: 1/1000.0] [fnum: 2.8] [ev: 0] [color_md : dummy] [latitude: 0.0] [longitude: 0.0] </font>
"""


def assert_same_column(want: np.ndarray, got: np.ndarray) -> None:
    """Equal dtype kind, missing cells (None or NaN) and values."""
    assert got.dtype.kind == want.dtype.kind, (got.dtype, want.dtype)
    missing = pd.isna(want)
    np.testing.assert_array_equal(pd.isna(got), missing)
    assert got[~missing].tolist() == want[~missing].tolist()


def test_dji_srt_matches_reference(tmp_path):
    import dji_srt as ref

    from geotrax_tpu_torch.io import table
    from geotrax_tpu_torch.tools import dji_srt as port

    rb, pb = ref.parse_srt(BLOCKS), port.parse_srt(BLOCKS)
    assert [(b.start_ms, b.end_ms, b.body) for b in rb] == [(b.start_ms, b.end_ms, b.body)
                                                           for b in pb]
    assert [b.telemetry() for b in rb] == [b.telemetry() for b in pb]
    merged_r, merged_p = ref.merge_blocks([rb, rb[:2]]), port.merge_blocks([pb, pb[:2]])
    assert ref.format_srt(merged_r) == port.format_srt(merged_p)
    ref.srt_dataframe(merged_r).to_csv(tmp_path / "ref.csv", index=False)
    table.write_csv(tmp_path / "port.csv", port.srt_table(merged_p))
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "ref.csv").read_bytes()

    # flight_log from the .srt, from a vendor-spelled .csv, and preferring the csv
    video = tmp_path / "DJI_0001_trimmed.mp4"
    (tmp_path / "DJI_0001.SRT").write_text(BLOCKS)
    for prefer in ("srt", "csv"):
        r, p = ref.flight_log(video, prefer=prefer), port.flight_log(video, prefer=prefer)
        assert list(r.columns) == list(p)
        for name in p:
            assert_same_column(r[name].to_numpy(), p[name])
    pd.DataFrame({"FrameCnt": [0, 1, 2], "lat": [37.1, 37.2, np.nan],
                  "altitude": [140.0, 141.5, 142.0]}).to_csv(video.with_suffix(".csv"),
                                                            index=False)
    r, p = ref.flight_log(video, prefer="csv"), port.flight_log(video, prefer="csv")
    assert list(r.columns) == list(p) == ["frame", "latitude", "rel_alt"]
    for name in p:
        assert_same_column(r[name].to_numpy(), p[name])


def test_common_labels_and_images_match_reference(tmp_path):
    import _common as ref

    from geotrax_tpu_torch.tools import _common as port

    (tmp_path / "a.txt").write_text("0 0.5 0.5 0.1 0.2\n3 0.25 0.75 0.05 0.05 0.9\nbad\n")
    np.testing.assert_array_equal(port.load_yolo_labels(tmp_path / "a.txt"),
                                  ref.load_yolo_labels(tmp_path / "a.txt"))
    assert port.load_yolo_labels(tmp_path / "none.txt").shape == (0, 5)
    for name in ("b.png", "a.jpg", "c.bmp", "d.jpeg", "e.txt"):
        (tmp_path / name).write_bytes(b"")
    assert list(port.iter_images(tmp_path)) == list(ref.iter_images(tmp_path))


def float_cells(seed: int) -> list:
    """Seeded decimal cells of every form the tools' and trajectories' CSVs
    hold: shortest reprs (16 and 17 digits), 15 digits, long mantissas,
    exponents at the fast path's edges, leading zeros, subnormals, overflow,
    signed zeros, infinities and padding."""
    rng = np.random.default_rng(seed)
    vals = np.concatenate([rng.uniform(37, 38, 3000), rng.uniform(0, 15000, 3000),
                           rng.normal(0, 1, 3000) * 10.0 ** rng.integers(-30, 30, 3000),
                           rng.normal(0, 1, 300) * 10.0 ** rng.integers(-323, 308, 300)])
    cells = [repr(float(v)) for v in vals]
    cells += [f"{v:.15g}" for v in vals[:3000]] + [f"{v:.16g}" for v in vals[3000:6000]]
    cells += [f"{v:.20e}" for v in vals[6000:7000]] + [f"{v:.3f}" for v in vals[:1000]]
    cells += ["1e22", "1e23", "123456789012345e-22", "123456789012345e-23", "1234567890123456e7",
              "0.00001234567890123456789", "-0000000000000000000012.5", "1" + "0" * 30,
              "12345678901234567e-330", "5e-324", "1e-400", "-1e-700", "-0e-700", "0e400",
              "-0e400", "1e309", "-1e309", "-0.0", "+.5", "5.", "-inf", "Infinity", " 1.25 ",
              "1E5", "-2.5e-310", "9999999999999999999e290"]
    return cells


def test_read_csv_floats_as_pandas(tmp_path):
    """io/table.py's float cells bit-equal to pandas.read_csv's (its C
    parser's precise_xstrtod), on the cells' own and on a trajectory-like
    table written by the port."""
    from geotrax_tpu_torch.io import table

    cells = float_cells(0)
    (tmp_path / "x.csv").write_text("x\n" + "\n".join(cells) + "\n")
    got = table.read_csv(tmp_path / "x.csv")["x"]
    want = pd.read_csv(tmp_path / "x.csv")["x"].to_numpy()
    assert got.dtype == want.dtype == np.float64
    differ = np.nonzero(got.view(np.int64) != want.view(np.int64))[0]
    assert not len(differ), [(cells[i], got[i], want[i]) for i in differ[:10]]
    # a 17-digit cell is read as pandas reads it, not always as float() does
    assert sum(float(c) != v for c, v in zip(cells, got)) > 100
    rng = np.random.default_rng(1)
    n = 5000
    cols = {"Vehicle_ID": rng.integers(0, 50, n), "Ortho_X": rng.uniform(0, 15000, n),
            "Latitude": rng.uniform(37.38, 37.39, n), "Speed": rng.uniform(0, 30, n).round(2),
            "Lane": np.where(rng.random(n) < 0.1, np.nan, rng.integers(1, 4, n).astype(float)),
            "Class": np.array(["car", "bus"] * (n // 2), dtype=object)}
    table.write_csv(tmp_path / "t.csv", cols)
    got, want = table.read_csv(tmp_path / "t.csv"), pd.read_csv(tmp_path / "t.csv")
    assert list(got) == list(want.columns)
    for name in got:
        assert_same_column(want[name].to_numpy(), got[name])
        if got[name].dtype.kind == "f":
            np.testing.assert_array_equal(got[name].view(np.int64),
                                          want[name].to_numpy().view(np.int64))


@pytest.mark.parametrize("case", ["int_float", "missing_column", "object_float", "disjoint",
                                  "same_kind"])
def test_table_concat_as_pandas(case):
    """table.concat (merge_videos_and_logs, plot) and concat_column
    (aggregate) type each column as pd.concat(..., ignore_index=True) does."""
    from geotrax_tpu_torch.io import table

    ints, floats = np.array([1, 2], dtype=np.int64), np.array([0.5, np.nan])
    words = np.array(["a", np.nan], dtype=object)
    parts = {"int_float": [{"a": ints}, {"a": floats}],
             "missing_column": [{"a": ints, "b": words}, {"a": ints}],
             "object_float": [{"a": words}, {"a": floats, "c": ints}],
             "disjoint": [{"a": floats}, {"b": ints, "a": ints}, {"b": words}],
             "same_kind": [{"a": ints}, {"a": ints[::-1].copy()}]}[case]
    got = table.concat(parts)
    want = pd.concat([pd.DataFrame(p) for p in parts], ignore_index=True)
    assert list(got) == list(want.columns)
    for name in got:
        assert_same_column(want[name].to_numpy(), got[name])
    columns = [p["a"] for p in parts if "a" in p]
    want = pd.concat([pd.Series(c) for c in columns], ignore_index=True)
    assert_same_column(want.to_numpy(), table.concat_column(columns))


# ---------------------------------------------------------------------------
# annotate_frames
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def annotate_inputs(tmp_path_factory):
    """A seeded YOLOv8s whose class scores spread over (0, 1) (class head
    sharpened, box head about one stride wide), saved once as .npz, and
    three seeded images: two PNGs and a JPEG."""
    from PIL import Image

    from geotrax_tpu_torch.models import yolov8
    from geotrax_tpu_torch.models.convert import save_npz

    tmp = tmp_path_factory.mktemp("annotate")
    spec = yolov8.ModelSpec(variant="s", nc=4)
    model = yolov8.init_params(torch.Generator().manual_seed(0), spec, device="cpu")
    head = model.layers[str(spec.head_index)]
    with torch.no_grad():
        for k in range(len(spec.strides)):
            head.cv3[k][2].weight *= 100.0
            head.cv3[k][2].bias -= 1.9
            head.cv2[k][2].weight *= 0.05
            b = torch.zeros(4 * spec.reg_max)
            b[0::spec.reg_max] = b[1::spec.reg_max] = 20.0
            head.cv2[k][2].bias.copy_(b)
    save_npz(tmp / "s.npz", model, class_names={0: "car", 1: "bus", 2: "truck", 3: "moto"})
    images = tmp / "data" / "images"
    images.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for name in ("f1.png", "f2.png", "f3.jpg"):
        blocks = rng.integers(0, 255, (13, 22, 3), np.uint8)
        img = np.repeat(np.repeat(blocks, 8, 0), 8, 1)[:100, :170]
        Image.fromarray(img).save(images / name, quality=95)
    return tmp / "s.npz", images


def read_labels(folder: Path) -> dict:
    return {p.name: [[float(v) for v in line.split()] for line in p.read_text().splitlines()]
            for p in sorted(folder.glob("*.txt"))}


def assert_labels_close(port: dict, ref: dict, size=(170, 100)) -> int:
    assert port.keys() == ref.keys() and port
    n = 0
    for name in ref:
        a, b = np.asarray(port[name]), np.asarray(ref[name])
        assert a.shape == b.shape, (name, a.shape, b.shape)
        if not len(a):
            continue
        np.testing.assert_array_equal(a[:, 0], b[:, 0])
        scale = np.array([size[0], size[1], size[0], size[1]])
        np.testing.assert_allclose(a[:, 1:5] * scale, b[:, 1:5] * scale, rtol=0,
                                   atol=BOX_TOL_PX + 1e-6 * size[0])
        if a.shape[1] == 6:
            np.testing.assert_allclose(a[:, 5], b[:, 5], rtol=0, atol=SCORE_TOL)
        n += len(a)
    return n


@pytest.mark.parametrize("augment", [False, True])
def test_annotate_frames_matches_reference(annotate_inputs, tmp_path, augment):
    from geotrax_tpu_torch.io.png import read_png

    model, images = annotate_inputs
    common = ["--model", model, "--imgsz", "128", "--conf", "0.3", "--max-det", "40",
              "--save-conf", "--save-masked", "--margin", "0.1", "-q"]
    if augment:
        common.append("--augment")
    run_ref("annotate_frames", images, "-a", tmp_path / "ref", *common)
    run_port("annotate_frames", images, "-a", tmp_path / "port", *common, "--save-viz")
    n = assert_labels_close(read_labels(tmp_path / "port"), read_labels(tmp_path / "ref"))
    assert n >= 6
    for png in sorted((tmp_path / "ref" / "masked").glob("*.png")):
        np.testing.assert_array_equal(read_png(tmp_path / "port" / "masked" / png.name),
                                      read_png(png))
    viz = sorted((tmp_path / "port" / "visualizations").glob("*.png"))
    assert [p.stem for p in viz] == ["f1", "f2", "f3"]
    assert read_png(viz[0]).shape == (100, 170, 3)

    # an existing label survives, --overwrite rewrites it, per-class thresholds filter
    (tmp_path / "port" / "f1.txt").write_text("9 0.5 0.5 0.1 0.1\n")
    out = run_port("annotate_frames", images, "-a", tmp_path / "port", *common[:-1])
    assert "3 existing annotation(s) skipped" in out
    assert (tmp_path / "port" / "f1.txt").read_text() == "9 0.5 0.5 0.1 0.1\n"
    thresholds = ["-t", "0=1.0", "1=1.0", "2=1.0", "3=1.0"]
    run_port("annotate_frames", images, "-a", tmp_path / "port", *common, "--overwrite",
             *thresholds)
    run_ref("annotate_frames", images, "-a", tmp_path / "ref", *common, "--overwrite",
            *thresholds)
    assert read_labels(tmp_path / "port") == read_labels(tmp_path / "ref")


# ---------------------------------------------------------------------------
# benchmark_ortho_matching
# ---------------------------------------------------------------------------

ROW = re.compile(r"^(\S+)\s+(\d+)\s+(\d+)\s+(\S+)$")


def bench_rows(stdout: str) -> dict:
    rows = {}
    for line in stdout.splitlines():
        m = ROW.match(line.strip())
        if m:
            rows[m.group(1)] = (int(m.group(2)), int(m.group(3)), float(m.group(4)))
    assert rows, stdout
    return rows


@pytest.fixture(scope="module")
def bench_frame(tmp_path_factory):
    from geotrax_tpu_torch.io.png import write_png

    rng = np.random.default_rng(0)
    img = np.repeat(np.repeat(rng.integers(0, 255, (30, 40, 3)).astype(np.uint8), 8, 0), 8, 1)
    for _ in range(60):
        y, x = rng.integers(0, 200, 2)
        img[y:y + rng.integers(5, 30), x:x + rng.integers(5, 30)] = rng.integers(0, 255, 3)
    path = tmp_path_factory.mktemp("bench") / "frame.png"
    write_png(path, img)
    return path


@pytest.mark.parametrize("mode", ["--synthetic", "--synthetic-cross-domain"])
def test_benchmark_ortho_matching_matches_reference(bench_frame, mode):
    args = (bench_frame, mode, "--widths", "1", "2", "--max-features", "2000")
    ref = bench_rows(run_ref("benchmark_ortho_matching", *args))
    port = bench_rows(run_port("benchmark_ortho_matching", *args))
    assert port.keys() == ref.keys()
    tol = SYNTHETIC_TOL_PX if mode == "--synthetic" else CORNER_TOL_PX
    for name, (inl, mat, err) in ref.items():
        assert port[name][:2] == (inl, mat), (name, port[name], ref[name])
        assert abs(port[name][2] - err) <= tol, (name, port[name], ref[name])
    if mode == "--synthetic":
        assert max(r[2] for r in port.values()) < 1.0


def test_benchmark_synthetic_ortho_matches_reference():
    """--synthetic-ortho at a 1024^2 ortho (the 4K frame is the tool's own),
    one trial, 2000 features: the same scene (the ortho recipe's draws), a
    view within one grey level of cv2's, and the reference's registration."""
    from geotrax_tpu_torch.tools.benchmark_ortho_matching import synthetic_ortho_image

    rng = np.random.default_rng(7)
    size = 200
    ortho = np.kron(rng.integers(30, 220, (size // 8, size // 8, 3)),
                    np.ones((8, 8, 1))).astype(np.uint8)
    for k in range(0, size, size // 24):
        ortho[k:k + 12, :] = 72
        ortho[:, k:k + 12] = 72
    for _ in range(4000):
        y, x = rng.integers(0, size - 40, 2)
        ortho[y:y + rng.integers(12, 36), x:x + rng.integers(12, 36)] = rng.integers(0, 255, 3)
    port_rng = np.random.default_rng(7)
    np.testing.assert_array_equal(synthetic_ortho_image(size, port_rng), ortho)
    assert port_rng.bit_generator.state == rng.bit_generator.state

    args = ("--synthetic-ortho", "1024", "--trials", "1", "--max-features", "2000")
    ref = bench_rows(run_ref("benchmark_ortho_matching", *args))
    port = bench_rows(run_port("benchmark_ortho_matching", *args))
    assert port.keys() == ref.keys() == {"t0:1024px"}
    for name, (inl, mat, err) in ref.items():
        assert port[name][:2] == (inl, mat), (port[name], ref[name])
        assert abs(port[name][2] - err) <= CORNER_TOL_PX and port[name][2] < 3.0


def test_benchmark_views_within_a_grey_level_of_cv2():
    """The port's warps of the two cv2 modes (WARP_INVERSE_MAP and the
    inverse matrix) against cv2's on the same image."""
    cv2 = pytest.importorskip("cv2")
    from geotrax_tpu_torch.tools.benchmark_ortho_matching import warp

    rng = np.random.default_rng(3)
    image = np.repeat(np.repeat(rng.integers(0, 255, (40, 60, 3)).astype(np.uint8), 4, 0), 4, 1)
    h = np.array([[0.9, -0.1, 12.0], [0.12, 0.95, -7.0], [1e-4, -2e-4, 1.0]])
    want = cv2.warpPerspective(image, h, (200, 150), flags=cv2.WARP_INVERSE_MAP | cv2.INTER_LINEAR)
    got = warp(image, h, 150, 200, torch.device("cpu"))
    inner = (slice(2, -2), slice(2, -2))
    assert np.abs(got.astype(int) - want.astype(int))[inner].max() <= 1
    want = cv2.warpPerspective(image, np.linalg.inv(h), (200, 150), flags=cv2.INTER_LINEAR)
    assert np.abs(got.astype(int) - want.astype(int))[inner].max() <= 1


# ---------------------------------------------------------------------------
# verify_detector_parity
# ---------------------------------------------------------------------------

def test_verify_detector_parity_converter_matches_oracle(tmp_path):
    from geotrax_tpu_torch.tools import verify_detector_parity as vdp

    args = vdp.parse_cli_args(["--selftest", "--device", "cpu", "--imgsz", "128"])
    res = vdp.check(args)
    assert res["raw_dev"] <= 1e-5 and res["anchors"] == 336, res
    sd = vdp.make_selftest_state_dict()
    torch.save({k: v.clone() for k, v in sd.items()}, tmp_path / "w.pt")
    res_pt = vdp.check(vdp.parse_cli_args([str(tmp_path / "w.pt"), "--device", "cpu",
                                           "--imgsz", "128"]))
    assert res_pt["raw_dev"] == res["raw_dev"] and res_pt["anchors"] == res["anchors"]
    # the selftest's scores spread and its boxes are a stride wide: the
    # final detections (decode and NMS on both sides) pair one to one
    assert res["ok"] and res["unmatched"] == 0 and res["port"] == res["torch"] > 0, res
    assert res["box_dev"] <= args.tol_box, res
    assert (res_pt["port"], res_pt["box_dev"]) == (res["port"], res["box_dev"]), res_pt
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = vdp.main([str(tmp_path / "w.pt"), "--imgsz", "128", "--device", "cpu"])
    assert rc == 0 and "anchors          : 336" in out.getvalue(), out.getvalue()
    assert "unmatched=0" in out.getvalue() and "PARITY: PASS" in out.getvalue(), out.getvalue()
    raw = float(re.search(r"raw head max dev : (\S+)", out.getvalue()).group(1))
    assert raw == pytest.approx(res["raw_dev"], rel=1e-3)
    ref, out = importlib.import_module("verify_detector_parity"), io.StringIO()
    with mock.patch.object(sys, "argv", ["verify_detector_parity.py", str(tmp_path / "w.pt"),
                                         "--imgsz", "128"]), contextlib.redirect_stdout(out):
        ref_rc = ref.main()
    assert ref_rc == 0 and "anchors          : 336" in out.getvalue(), out.getvalue()
    assert f"jax={res['port']} torch={res['torch']} unmatched=0" in out.getvalue(), out.getvalue()
    ref_raw = float(re.search(r"raw head max dev : (\S+)", out.getvalue()).group(1))
    assert raw <= ref_raw <= 5e-3  # the reference's oracle keeps torch's BN eps of 1e-5


# ---------------------------------------------------------------------------
# find_master_frames and sample_frames
# ---------------------------------------------------------------------------

def write_clip(path: Path, n: int, seed: int, w: int = 64, h: int = 48) -> None:
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(seed)
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 30, (w, h))
    for i in range(n):
        frame = rng.integers(0, 255, (h, w, 3), np.uint8)
        frame[8:16, 8:24] = (i * 9 % 255, 0, 255)
        writer.write(frame)
    writer.release()


def test_find_master_frames_matches_reference(tmp_path):
    from geotrax_tpu_torch.io.png import read_png

    videos = tmp_path / "videos"
    videos.mkdir()
    write_clip(videos / "A_clip.mp4", 20, 0)
    write_clip(videos / "B_clip.mp4", 12, 1)
    rng = np.random.default_rng(2)
    dev = rng.normal(0, 1.5e-5, (20, 2))
    pd.DataFrame({"frame": range(20), "latitude": 37.4 + dev[:, 0],
                  "longitude": 126.6 + dev[:, 1]}).to_csv(videos / "A_clip.csv", index=False)
    results = tmp_path / "results"
    results.mkdir()
    np.savetxt(results / "A_clip.txt", np.array([[f, 1, 0, 0, 1, 1] for f in
                                                 (3, 3, 5, 5, 5, 9, 14, 14)]), delimiter=",")
    for extra in ((), ("--results", results, "--hover-radius", "2.5")):
        ref = run_ref("find_master_frames", videos, "-o", tmp_path / "ref", *extra)
        port = run_port("find_master_frames", videos, "-o", tmp_path / "port", *extra,
                        device=False)
        assert port.replace("port", "ref") == ref
        for loc in ("A", "B"):
            np.testing.assert_array_equal(read_png(tmp_path / "port" / f"{loc}.png"),
                                          read_png(tmp_path / "ref" / f"{loc}.png"))


def test_sample_frames_matches_reference(tmp_path):
    from geotrax_tpu_torch.io.png import read_png

    data = tmp_path / "PROCESSED"
    (data / "A").mkdir(parents=True)
    (data / "B").mkdir(parents=True)
    write_clip(data / "A" / "0_merged.mp4", 30, 3)
    write_clip(data / "B" / "0_merged.mp4", 10, 4)
    pd.DataFrame({"frame": range(30), "rel_alt": [100.0] * 10 + [150.0] * 10 + [200.0] * 10,
                  "iso": [100.0] * 15 + [800.0] * 15,
                  "shutter": ["1/1000"] * 30}).to_csv(data / "A" / "0_merged.csv", index=False)
    (data / "B" / "0_merged.SRT").write_text(BLOCKS)
    cases = {"balanced": ("-n", "10", "--balanced"), "global": ("-n", "7", "--seed", "5"),
             "stride": ("--stride", "4", "--skip-start", "2", "--skip-end", "3"),
             "csv": ("-n", "99", "--csv-filter", "rel_alt:130:160", "--csv-filter", "iso::400",
                     "--csv-filter", "shutter::5"),
             "srt": ("-n", "99", "--min-alt", "148.85"),
             "dry": ("-n", "4", "--dry-run")}
    for case, args in cases.items():
        run_ref("sample_frames", data, "-o", tmp_path / "ref" / case, *args, "-lp", tmp_path)
        run_port("sample_frames", data, "-o", tmp_path / "port" / case, *args, "-lp", tmp_path,
                 device=False)
        names = sorted(p.name for p in (tmp_path / "ref" / case).glob("*.png")) \
            if case != "dry" else []
        assert sorted(p.name for p in (tmp_path / "port" / case).glob("*.png")) == names, case
        assert case == "dry" or names, case
        for name in names:
            np.testing.assert_array_equal(read_png(tmp_path / "port" / case / name),
                                          read_png(tmp_path / "ref" / case / name))
    assert not (tmp_path / "port" / "dry").exists()
    one = data / "A" / "0_merged.mp4"
    run_ref("sample_frames", one, "-o", tmp_path / "ref1", "-n", "5", "-of", "jpg", "-lp", tmp_path)
    run_port("sample_frames", one, "-o", tmp_path / "port1", "-n", "5", "-of", "jpg", "-lp",
             tmp_path, device=False)
    names = sorted(p.name for p in (tmp_path / "ref1").iterdir())
    assert sorted(p.name for p in (tmp_path / "port1").iterdir()) == names and names
    for name in names:  # cv2 at quality 75 writes Pillow's default JPEG bytes
        assert (tmp_path / "port1" / name).read_bytes() == (tmp_path / "ref1" / name).read_bytes()
