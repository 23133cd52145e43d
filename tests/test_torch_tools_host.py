"""The port's host-only tools (geotrax_tpu_torch/tools) against the JAX
package's (tools/*.py), one case per reference test of tools/test_tools.py,
each on two copies of the same seeded files: the reference tool's
``main()`` with ``sys.argv`` set and the port's ``main(argv)`` (plus
``--device cpu`` for the two tools that use a device), both in this
process.

Compared: the exit code; stdout and the log lines (stderr) byte for byte,
with the two copies' folder names made equal; CSV, JSON, text and LaTeX
files byte for byte; drawn PNGs: ``viz_segmentations`` within one grey
level of cv2's, ``viz_annotations`` within DRAW_MEAN_TOL levels on average
(its anti-aliased box outlines); the
downscale of ``subset_orthophoto`` bit-equal at an integer inverse scale and
within one grey level of cv2's INTER_AREA at 8/15. Figures (matplotlib PDFs)
are compared by name only.
"""

import contextlib
import importlib
import io
import json
import shutil
import sys
import warnings
from pathlib import Path
from unittest import mock

import numpy as np
import pandas as pd
import pytest

ROOT = Path(__file__).resolve().parent.parent
TOOLS = ROOT / "tools"
sys.path.insert(0, str(TOOLS))

# viz_annotations: mean grey-level difference over the pixels either image
# draws on. Its labels are within one level of cv2 and its label boxes
# exact (tests/test_torch_draw.py); the box outlines are the visualize
# stage's LINE_AA approximation, whose round corners differ most (up to
# ~170 levels at a corner pixel; 1.2-3.3 on average over these images).
DRAW_MEAN_TOL = 3.5
# a JPEG output, over all of its pixels: the drawing's differences spread by
# the encoder's 8x8 blocks (both cv2's encoder at quality 95)
JPEG_MEAN_TOL = 1.5
# the two tools that put tensors on a device and so take --device; the
# other fourteen take none, as the reference's do
DEVICE_TOOLS = ("fix_timestamp_anomalies", "subset_orthophoto")


def _call(fn):
    """(exit code, stdout + stderr) of ``fn()``; Python's warnings (numpy's
    all-NaN slice in the reference) are not the tool's output."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(out), \
            warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            rc = fn()
        except SystemExit as exc:
            rc = exc.code
    return rc, out.getvalue()


def run_ref(name, *args):
    """(exit code, stdout + stderr) of the reference tool's main()."""
    mod = importlib.import_module(name)
    with mock.patch.object(sys, "argv", [f"{name}.py", *map(str, args)]):
        return _call(mod.main)


def run_port(name, *args):
    """(exit code, stdout + stderr) of the port's main(argv), with
    ``--device cpu`` where the tool takes one."""
    mod = importlib.import_module(f"geotrax_tpu_torch.tools.{name}")
    device = ["--device", "cpu"] if name in DEVICE_TOOLS else []
    return _call(lambda: mod.main([*map(str, args), *device]))


def twins(tmp_path, build):
    """Two copies of the files ``build(folder)`` writes: (ref, port)."""
    ref, port = tmp_path / "refr", tmp_path / "port"  # equal lengths: equal column widths
    ref.mkdir()
    build(ref)
    shutil.copytree(ref, port)
    return ref, port


def both(name, ref, port, *args, rc=0, normalize=None):
    """Run the tool on each copy (``{}`` in an argument is the copy's
    folder) and check that the exit codes and the texts are equal
    (``normalize`` first maps the port's text)."""
    def argv(root):
        return [str(a).replace("{}", str(root)) for a in args]

    rc_ref, out_ref = run_ref(name, *argv(ref))
    rc_port, out_port = run_port(name, *argv(port))
    assert rc_ref == rc, out_ref[-3000:]
    assert rc_port == rc, out_port[-3000:]
    if normalize is not None:
        out_port = normalize(out_port)
    assert out_port.replace(str(port), "ROOT") == out_ref.replace(str(ref), "ROOT")
    return out_ref


def same_files(ref, port, pattern="**/*", text=True):
    names = sorted(p.relative_to(ref) for p in ref.glob(pattern) if p.is_file())
    assert names == sorted(p.relative_to(port) for p in port.glob(pattern) if p.is_file())
    for rel in names:
        if rel.suffix.lower() in (".csv", ".json", ".txt", ".tex", ".TXT", ".CSV"):
            a, b = (ref / rel).read_text(), (port / rel).read_text()
            assert b.replace(str(port), "ROOT") == a.replace(str(ref), "ROOT"), rel
    return names


# ---------------------------------------------------------------------------
# find_max_annotations, interpolate_missing_timestamps
# ---------------------------------------------------------------------------

def test_find_max_annotations(tmp_path):
    def build(d):
        rng = np.random.default_rng(0)
        for i in range(6):
            (d / "sub").mkdir(exist_ok=True)
            target = d / "sub" if i % 2 else d
            rows = [f"{rng.integers(0, 4)} 0.5 0.5 0.1 0.1" for _ in range(rng.integers(0, 5))]
            (target / f"f{i}.txt").write_text("\n".join(rows) + ("\n" if rows else ""))

    ref, port = twins(tmp_path, build)
    both("find_max_annotations", ref, port, "{}", "--top", "3")
    empty = tmp_path / "empty"
    empty.mkdir()
    both("find_max_annotations", empty, empty, "{}", rc=1)


def test_interpolate_missing_timestamps(tmp_path):
    def build(d):
        pd.DataFrame({
            "frame": [0, 1, 2, 3, 4, 5],
            "timestamp": [None, "2022-10-07 10:00:00.000", None, None,
                          "2022-10-07 10:00:00.300", None],
            "latitude": [37.1, 37.2, np.nan, 37.4, 37.5, 37.6],
        }).to_csv(d / "U.csv", index=False)

    ref, port = twins(tmp_path, build)
    both("interpolate_missing_timestamps", ref, port, "{}/U.csv", "--fps", "10")
    both("interpolate_missing_timestamps", ref, port, "{}/U.csv", "-o", "{}/out.csv")
    same_files(ref, port)
    assert pd.read_csv(port / "U.csv")["timestamp"][2] == "2022-10-07 10:00:00.100"


# ---------------------------------------------------------------------------
# yolo_to_coco, fix_json_annotations
# ---------------------------------------------------------------------------

def _png(path, h, w, value=40):
    from PIL import Image

    Image.new("RGB", (w, h), (value, value, value)).save(path)


def test_yolo_to_coco_roundtrip(tmp_path):
    def build(d):
        (d / "images" / "train").mkdir(parents=True)
        (d / "labels" / "train").mkdir(parents=True)
        _png(d / "images" / "train" / "a.png", 80, 100)
        from PIL import Image

        Image.new("RGB", (64, 48)).save(d / "images" / "train" / "b.jpg")
        (d / "labels" / "train" / "a.txt").write_text("0 0.5 0.5 0.2 0.25\n2 0.1 0.2 0.3 0.4\n")
        (d / "labels" / "train" / "b.txt").write_text("1 0.33 0.5 0.21 0.7\n")

    ref, port = twins(tmp_path, build)
    both("yolo_to_coco", ref, port, "{}", "--split", "train", "-o", "{}/coco.json")
    same_files(ref, port)


def test_yolo_to_coco_per_image_labelme_mode(tmp_path):
    def build(d):
        (d / "images").mkdir()
        (d / "labels").mkdir()
        _png(d / "images" / "f1.png", 100, 200)
        _png(d / "images" / "f2.png", 50, 60)
        (d / "labels" / "f1.txt").write_text("0 0.5 0.5 0.2 0.4\n1 0.25 0.25 0.1 0.1\n")

    ref, port = twins(tmp_path, build)
    both("yolo_to_coco", ref, port, "{}/labels", "-cm", "0=Car", "1=Bus", "bad",
         "-lp", "{}/logs")
    both("yolo_to_coco", ref, port, "{}/labels", "-ol", "{}/cfg", "-lp", "{}/logs")
    same_files(ref, port, "labels/*")
    same_files(ref, port, "cfg/*")


def test_yolo_to_coco_map_file(tmp_path):
    def build(d):
        (d / "images").mkdir()
        (d / "labels").mkdir()
        _png(d / "images" / "a.png", 50, 50)
        (d / "labels" / "a.txt").write_text("2 0.5 0.5 0.5 0.5\n0 0.1 0.1 0.05 0.05\n")
        (d / "map.json").write_text('{"2": "Truck"}')
        (d / "map.yaml").write_text("- car\n- bus\n- truck\n")

    ref, port = twins(tmp_path, build)
    for map_file, out in (("map.json", "out"), ("map.yaml", "out_yaml")):
        both("yolo_to_coco", ref, port, "{}/labels", "-mf", "{}/" + map_file, "-dp", "1",
             "-ol", "{}/" + out, "-ii", "../images", "-q", "-lp", "{}/logs")
    same_files(ref, port, "out*/*")


def test_fix_json_annotations(tmp_path):
    coco = {
        "images": [{"id": 1, "file_name": "a.png", "width": 100, "height": 100}],
        "annotations": [
            {"id": 7, "image_id": 1, "category_id": 1, "bbox": [10, 10, 20, 20], "area": 400,
             "iscrowd": 0},
            {"id": 8, "image_id": 1, "category_id": 1, "bbox": [50, 50, 0, 10], "area": 0,
             "iscrowd": 0},
            {"id": 9, "image_id": 1, "category_id": 1, "bbox": [90, 90, 30, 30], "area": 900,
             "iscrowd": 0},
            {"id": 10, "image_id": 1, "category_id": 2, "bbox": [0, 0, 1, 1], "area": 1,
             "iscrowd": 0, "segmentation": [[-5.5, 2, 30.25, 2, 30.25, 40, -5.5, 40]]},
        ],
        "categories": [{"id": 1, "name": "car"}],
    }

    def build(d):
        (d / "ann.json").write_text(json.dumps(coco))
        (d / "ann2.json").write_text(json.dumps(coco))

    ref, port = twins(tmp_path, build)
    both("fix_json_annotations", ref, port, "{}/ann.json", "-lp", "{}/logs")
    both("fix_json_annotations", ref, port, "{}/ann2.json", "--obb-to-hbb", "-o",
         "{}/fixed.json", "-lp", "{}/logs")
    same_files(ref, port, "*.json")


def test_fix_json_annotations_labelme_dir(tmp_path):
    ann = {
        "imagePath": "imgs\\sub\\a.png",
        "imageData": "QUJD",
        "shapes": [
            {"label": "car", "shape_type": "rectangle", "points": [[10, 20], [50, 60]]},
            {"label": "bus", "shape_type": "polygon", "points": [[0, 0], [0, 4], [8, 4], [8, 0]]},
            {"label": "tri", "shape_type": "polygon", "points": [[0, 0], [3, 4], [8, 1]]},
        ],
    }

    def build(d):
        (d / "labels" / "deep").mkdir(parents=True)
        (d / "labels" / "a.json").write_text(json.dumps(ann))
        (d / "labels" / "deep" / "b.json").write_text(json.dumps({**ann, "imagePath": "x/y.png"}))

    ref, port = twins(tmp_path, build)
    lp = ("-lp", "{}/logs")
    both("fix_json_annotations", ref, port, "{}/labels", "--remove-image-data", "--debug", *lp)
    both("fix_json_annotations", ref, port, "{}/labels", "--remove-image-data",
         "--normalize-to-unix", "--remove-from-path", "imgs/", "--to-obb", *lp)
    same_files(ref, port, "labels/**/*")
    both("fix_json_annotations", ref, port, "{}/labels", "--to-hbb", "-nw",
         "--replace-path", "sub", "SUB", *lp)
    same_files(ref, port, "labels/**/*")
    empty = tmp_path / "empty"
    empty.mkdir()
    both("fix_json_annotations", empty, empty, "{}", *lp, rc=1)


# ---------------------------------------------------------------------------
# find_source_id, check_dataset
# ---------------------------------------------------------------------------

def _processed_tree(d):
    base = d / "PROCESSED" / "2022-10-07" / "D3" / "PM5" / "results"
    base.mkdir(parents=True)
    pd.DataFrame({"Vehicle_ID": [1, 2, 3]}).to_csv(base / "U_a.csv", index=False)
    base2 = d / "PROCESSED" / "2022-10-07" / "D10" / "PM5" / "results"
    base2.mkdir(parents=True)
    pd.DataFrame({"Vehicle_ID": [1, 2], "x": [0.5, 1.5]}).to_csv(base2 / "U_b.csv", index=False)
    (base2.parent / "U_b.mp4").touch()
    (d / "DATASET").mkdir()


def test_find_source_id(tmp_path):
    ref, port = twins(tmp_path, _processed_tree)
    for vid in ("4", "2", "9"):
        both("find_source_id", ref, port, "{}/PROCESSED", "2022-10-07", "U", "PM5", vid,
             rc=1 if vid == "9" else 0)


def test_find_source_id_dataset_csv_mode(tmp_path):
    def build(d):
        _processed_tree(d)
        (d / "DATASET" / "2022-10-07_U_PM5.csv").touch()

    ref, port = twins(tmp_path, build)
    both("find_source_id", ref, port, "--dataset-csv", "{}/DATASET/2022-10-07_U_PM5.csv", "2")
    both("find_source_id", ref, port, "--dataset-csv", "{}/DATASET/2022-10-07_U_PM5.csv", "5")


def test_check_dataset(tmp_path):
    def build(d):
        pd.DataFrame({
            "Vehicle_ID": [1, 1, 2, 3, 3, 4], "Drone_ID": [2, 2, 2, 2, 2, 2],
            "Vehicle_Class": [0, 0, 1, 2, 2, 0],
            "Vehicle_Speed": [150.0, 160.0, 50.0, 131.25, 170.123456, np.nan],
            "Vehicle_Acceleration": [1.0, 0.5, -14.0, 13.0, 12.5, 2.0],
        }).to_csv(d / "d.csv", index=False)
        sub = d / "dir" / "s"
        sub.mkdir(parents=True)
        pd.DataFrame({"Vehicle_ID": [7, 8], "Vehicle_Speed": [140.0, 10.0],
                      "Vehicle_Acceleration": [20.0, -0.5]}).to_csv(sub / "a.csv", index=False)
        pd.DataFrame({"Vehicle_ID": [9], "Vehicle_Speed": [135.5],
                      "Vehicle_Acceleration": [-30.0]}).to_csv(sub / "b.csv", index=False)
        pd.DataFrame({"other": [1]}).to_csv(sub / "c.csv", index=False)

    ref, port = twins(tmp_path, build)
    out = both("check_dataset", ref, port, "{}/d.csv", "--no-trace")
    assert "2 violating" not in out and "speed > 130" in out
    both("check_dataset", ref, port, "{}/dir", "--speed", "120", "--accel", "10")
    both("check_dataset", ref, port, "{}/missing", rc=1)


def test_check_dataset_traces_source_video(tmp_path):
    def build(d):
        _processed_tree(d)
        pd.DataFrame({"Vehicle_ID": [4, 1, 2], "Vehicle_Speed": [150.0, 140.0, 10.0],
                      "Vehicle_Acceleration": [0.0, 15.0, 0.0]}).to_csv(
            d / "DATASET" / "2022-10-07_U_PM5.csv", index=False)

    ref, port = twins(tmp_path, build)
    out = both("check_dataset", ref, port, "{}/DATASET/2022-10-07_U_PM5.csv")
    assert "U_b.mp4" in out


# ---------------------------------------------------------------------------
# compare_tracking, analyze_bb_ratios, compute_bb_center_error
# ---------------------------------------------------------------------------

def test_compare_tracking(tmp_path):
    def build(d):
        rng = np.random.default_rng(3)
        for name, n in (("a", 20), ("b", 10)):
            (d / name).mkdir()
            rows = []
            for tid in range(1, 6):
                frames = np.sort(rng.choice(np.arange(n + 5), size=int(rng.integers(3, n)),
                                            replace=False))
                rows += [[t, tid, 10, 10, 5, 5, 0, 0.9, 5, 5, int(tid % 3), 0.8, 4, 2]
                         for t in frames]
            np.savetxt(d / name / "V.txt", np.array(rows), fmt="%g", delimiter=",")
            np.savetxt(d / name / "W.txt", np.array([[t, 1, 10, 10, 5, 5, 0, 0.9]
                                                     for t in range(n)]), fmt="%g", delimiter=",")
            (d / name / "V_vid_transf.txt").write_text("1,2,3\n")

    ref, port = twins(tmp_path, build)
    out = both("compare_tracking", ref, port, "{}/a", "{}/b", "--plot", "{}/cmp.pdf")
    assert "KL[lengths](" in out and "KL[gaps](" in out
    assert (ref / "cmp.pdf").exists() and (port / "cmp.pdf").exists()


def test_analyze_bb_ratios_labels_mode(tmp_path):
    def build(d):
        (d / "s").mkdir()
        (d / "a.txt").write_text("0 0.5 0.5 0.4 0.2\n1 0.5 0.5 0.3 0.1\n7 0.5 0.5 0.1 0.3\n")
        (d / "s" / "b.txt").write_text("0 0.5 0.5 0.35 0.2\n0 0.5 0.5 0 0.2\n")

    ref, port = twins(tmp_path, build)
    out = both("analyze_bb_ratios", ref, port, "{}", "--labels")
    assert "car" in out and "bus" in out and "3.00" in out
    both("analyze_bb_ratios", ref, port, "{}/s", "--labels", "--classes", "x", "y")


def test_analyze_bb_ratios_tracks_mode(tmp_path):
    def build(d):
        results = d / "results"
        results.mkdir()
        rows = []
        for t in range(30):
            x = 500.0 + 50 * t  # a clean +x cardinal pass
            rows.append([t, 1, x, 500, 60, 25, x, 500, 60, 25, 0, 0.9])
            rows.append([t, 2, 2000, 800, 50, 30, 2000, 800, 50, 30, 0, 0.9])  # parked
            y = 300.0 + 45 * t
            rows.append([t, 3, 900, y, 22, 70, 900, y, 22, 70, 2, 0.9])
        np.savetxt(results / "V.txt", np.array(rows), fmt="%g", delimiter=",")
        (d / "V.yaml").write_text("video:\n  width: 3840\n  height: 2160\n")

    ref, port = twins(tmp_path, build)
    out = both("analyze_bb_ratios", ref, port, "{}", "--hist")
    assert "Class: car" in out and "Mean: 2.40" in out
    for name in ("car", "truck"):
        assert (port / "plots" / f"bb_ratio_hist_{name}.pdf").exists()
    both("analyze_bb_ratios", ref, port, "{}/V.yaml")
    both("analyze_bb_ratios", ref, port, "{}/results", rc=1)


def test_compute_bb_center_error(tmp_path):
    def build(d):
        from PIL import Image

        images, labels, preds = d / "images", d / "labels", d / "pre-labels"
        for sub in (images, labels, preds):
            sub.mkdir()
        Image.new("RGB", (200, 100), (10, 10, 10)).save(images / "000001.jpg")
        _png(images / "000002.png", 64, 96)
        _png(images / "000003.png", 64, 96)
        (labels / "000001.txt").write_text("0 0.5 0.5 0.2 0.4\n1 0.2 0.3 0.1 0.2\n")
        (preds / "000001.txt").write_text("0 0.52 0.5 0.2 0.4\n0 0.9 0.9 0.05 0.05\n")
        (labels / "000002.txt").write_text("2 0.5 0.5 0.5 0.5\n0 0.3 0.3 0.2 0.2\n")
        (preds / "000002.txt").write_text("2 0.55 0.45 0.4 0.4\n0 0.31 0.33 0.2 0.2\n"
                                          "0 0.29 0.3 0.1 0.1\n")
        (labels / "000003.txt").write_text("0 0.5 0.5 0.2 0.2\n")

    ref, port = twins(tmp_path, build)
    out = both("compute_bb_center_error", ref, port, "{}/images", "--save", "-lp", "{}/logs")
    assert "Class-specific error statistics" in out and "4.00" in out
    assert (port / "error_distribution_by_class.png").exists()
    out = both("compute_bb_center_error", ref, port, "{}/images", "--class-agnostic",
               "-lp", "{}/logs")
    assert "Number of NaN errors: 2" in out
    both("compute_bb_center_error", ref, port, "{}/images", "-ha", "../none",
         "-lp", "{}/logs", rc=1)


# ---------------------------------------------------------------------------
# find_cut_video_issues, fix_timestamp_anomalies
# ---------------------------------------------------------------------------

def test_find_cut_video_issues(tmp_path):
    def build(d):
        pd.DataFrame({
            "frame": [0, 1, 2, 5, 5],  # a gap and a duplicate
            "timestamp": ["2022-01-01 10:00:00.000", "2022-01-01 10:00:00.033",
                          "2022-01-01 10:00:05.000", None, "2022-01-01 10:00:04.100"],
        }).to_csv(d / "U.csv", index=False)

    ref, port = twins(tmp_path, build)
    out = both("find_cut_video_issues", ref, port, "{}/U.csv", rc=1)
    assert "frame-gap" in out and "timestamp-jump" in out and "missing-timestamp" in out


def test_find_cut_video_issues_report(tmp_path):
    def build(d):
        pd.DataFrame({
            "frame": range(5),
            "timestamp": [f"2022-01-01 10:00:00.{i * 33:03d}" for i in range(5)],
        }).to_csv(d / "A1.csv", index=False)
        pd.DataFrame({
            "frame": range(5),
            "timestamp": ["2022-01-01 10:00:00.000", "2022-01-01 10:00:00.033",
                          "2022-01-01 10:00:05.000", "2022-01-01 10:00:05.033",
                          "2022-01-01 10:00:05.066"],
            "latitude": [37.4, 37.4, 37.4001, 37.4, 37.4],
            "longitude": [126.6, 126.6, 126.6, 126.6003, 126.6],
            "rel_alt": [140.0, 140.1, 155.0, 139.9, 140.0],
        }).to_csv(d / "B2.csv", index=False)
        (d / "sub").mkdir()
        pd.DataFrame({
            "frame": [0, 1, 2],
            "timestamp": ["2022-01-01 10:00:00.000", None, "2022-01-01 10:00:00.066"],
            "altitude": [10.0, 10.5, 11.0],
        }).to_csv(d / "sub" / "C3.csv", index=False)
        pd.DataFrame({"x": [1]}).to_csv(d / "sub" / "notalog.csv", index=False)

    ref, port = twins(tmp_path, build)
    both("find_cut_video_issues", ref, port, "{}", "--report", "{}/report", rc=1)
    names = same_files(ref, port, "report/*")
    assert [n.name for n in names] == ["flight_log_anomalies.csv", "flight_log_stats.csv"]
    both("find_cut_video_issues", ref, port, "{}/A1.csv", "--report", "{}/one")
    same_files(ref, port, "one/*")


def _anomaly_files(d, frame=600, rows=1200, name="U3"):
    (d / f"{name}.MP4").write_bytes(b"fake")
    pd.DataFrame({"frame": range(rows), "timestamp": ["t"] * rows}).to_csv(
        d / f"{name}.CSV", index=False)
    pd.DataFrame([{
        "location_id": "U", "video_path": f"{name}.MP4", "timestamp_max_abs_diff": 5.0,
        "timestamp_anomaly_location": "2022-01-01 10:00:20",
        "timestamp_anomaly_frame": frame,
    }, {
        "location_id": "U", "video_path": "U9.MP4", "timestamp_max_abs_diff": 0.25,
        "timestamp_anomaly_location": np.nan, "timestamp_anomaly_frame": np.nan,
    }]).to_csv(d / "flight_log_anomalies.csv", index=False)


def _port_commands(text: str) -> str:
    """The port's subprocess command lines spelt as the reference's: its
    recut tool as a module, its CLI as ``geotrax_tpu_torch``, with
    ``--device``."""
    return (text.replace("-m geotrax_tpu_torch.tools.recut_video_and_log",
                         str(TOOLS / "recut_video_and_log.py"))
            .replace("-m geotrax_tpu_torch batch", "-m geotrax_tpu batch")
            .replace(" --device cpu", ""))


def test_fix_timestamp_anomalies_plan_and_apply(tmp_path):
    ref_mod = importlib.import_module("fix_timestamp_anomalies")
    port_mod = importlib.import_module("geotrax_tpu_torch.tools.fix_timestamp_anomalies")
    for frame in (600, 200, 1180):
        assert port_mod.plan_cuts(tmp_path / "U3.MP4", "U", 3, frame, 1200) == \
            ref_mod.plan_cuts(tmp_path / "U3.MP4", "U", 3, frame, 1200)
    ref, port = twins(tmp_path, _anomaly_files)
    recorded = []  # both modules call the one subprocess.run: the reference runs first
    with mock.patch.object(port_mod.subprocess, "run", lambda cmd, check: recorded.append(cmd)):
        both("fix_timestamp_anomalies", ref, port, "{}/flight_log_anomalies.csv",
             "-lp", "{}/logs", normalize=_port_commands)
    calls = {"ref": recorded[:len(recorded) // 2], "port": recorded[len(recorded) // 2:]}
    assert len(calls["port"]) == 4
    assert [_port_commands(" ".join(c)).replace(str(port), "ROOT") for c in calls["port"]] == \
        [" ".join(c).replace(str(ref), "ROOT") for c in calls["ref"]]
    assert calls["port"][1][1:4] == ["-m", "geotrax_tpu_torch", "batch"]
    assert (port / "U3_original.MP4").exists() and (port / "U3_original.CSV").exists()
    assert (port / "0_U3_U4_recut.TXT").read_text() == "630, -1"
    same_files(ref, port)


def test_fix_timestamp_anomalies_debug_mode(tmp_path):
    ref, port = twins(tmp_path, lambda d: _anomaly_files(d, name="U1"))
    both("fix_timestamp_anomalies", ref, port, "{}/flight_log_anomalies.csv", "--debug",
         "-lp", "{}/logs", normalize=_port_commands)
    assert (port / "U1.MP4").exists() and not list(port.glob("*.TXT"))
    same_files(ref, port)


def test_fix_timestamp_anomalies_skips_higher_sequence(tmp_path):
    def build(d):
        _anomaly_files(d, frame=50, rows=100, name="U1")
        (d / "U2.CSV").write_text("frame\n0\n")
        (d / "bad.csv").write_text("location_id,video_path\nU,U1.MP4\n")

    ref, port = twins(tmp_path, build)
    both("fix_timestamp_anomalies", ref, port, "{}/flight_log_anomalies.csv",
         "-lp", "{}/logs")
    assert (port / "U1.MP4").exists() and not (port / "U1_original.MP4").exists()
    both("fix_timestamp_anomalies", ref, port, "{}/bad.csv", "-lp", "{}/logs", rc=1)


# ---------------------------------------------------------------------------
# viz_dimension_estimation
# ---------------------------------------------------------------------------

def test_viz_dimension_estimation(tmp_path):
    def build(d):
        rows = []
        for t in range(30):
            x = 500.0 + 50 * t  # fast +x motion (cardinal)
            rows.append([t, 3, x, 500, 60, 25, x, 500, 60, 25, 0, 0.9, 60, 25])
            rows.append([t, 4, 900, 900, 40, 20, 900, 900, 40, 20, 1, 0.9, 40, 20])  # parked
            rows.append([t, 5, 3830, 900, 40, 20, 3830, 900, 40, 20, 1, 0.9, 40, 20])  # edge
        np.savetxt(d / "V.txt", np.array(rows), fmt="%g", delimiter=",")

    ref, port = twins(tmp_path, build)
    lp = ("-lp", "{}/logs")
    out = both("viz_dimension_estimation", ref, port, "{}/V.txt", "--id", "3",
               "--frame-size", "3840", "2160", "--save", *lp)
    assert "Q25 estimate" in out
    for fig in ("trajectory_with_dimensions", "dimensions_distribution",
                "estimation_diagnostics"):
        assert (port / "plots" / f"V_{fig}_id3.pdf").exists()
    both("viz_dimension_estimation", ref, port, "{}/V.txt", "--id", "4", *lp)
    both("viz_dimension_estimation", ref, port, "{}/V.txt", "--id", "5", *lp, rc=1)
    out = both("viz_dimension_estimation", ref, port, "{}/V.txt", "--id", "99", *lp, rc=1)
    assert "Available IDs" in out


# ---------------------------------------------------------------------------
# compare_av_detections_and_tune_filters
# ---------------------------------------------------------------------------

def test_seconds_to_ns_is_pandas():
    from geotrax_tpu_torch.io import table

    rng = np.random.default_rng(0)
    t = np.concatenate([rng.uniform(0, 2e9, 2000), np.arange(600) / 29.97,
                        np.round(rng.uniform(1.6e9, 1.7e9, 500), 3)])
    assert np.array_equal(table.seconds_to_ns(t), pd.to_datetime(pd.Series(t), unit="s")
                          .to_numpy().astype("datetime64[ns]").astype(np.int64))


def test_compare_av_detections(tmp_path):
    def build(d):
        fps = 10.0
        frames = np.arange(60)
        rng = np.random.default_rng(0)
        x = 170000 + 2.0 * frames  # 2 m/frame at 10 fps = 72 km/h
        pipeline = pd.DataFrame({
            "Vehicle_ID": np.r_[np.full(60, 7), np.full(20, 9)],
            "Frame_Number": np.r_[frames, frames[:20]],
            "Local_X": np.r_[x + rng.normal(0, 0.02, 60), x[:20] + 30],
            "Local_Y": 532000.0,
            "Vehicle_Speed": np.r_[72.0 + rng.normal(0, 1, 60), np.full(20, 70.0)],
        })
        pipeline.to_csv(d / "p.csv", index=False)
        speed = np.r_[np.zeros(3), np.full(57, 72.0)]
        pd.DataFrame({"frame": frames, "x": x, "y": 532000.0, "speed_kmh": speed}).to_csv(
            d / "gt.csv", index=False)

    ref, port = twins(tmp_path, build)
    lp = ("-lp", "{}/logs")
    out = both("compare_av_detections_and_tune_filters", ref, port, "{}/p.csv", "--probe",
               "{}/gt.csv", "--fps", "10", "--tune", "--grid", "2", "5", "9", *lp)
    assert "Vehicle_ID 7" in out and "length-weighted" in out
    both("compare_av_detections_and_tune_filters", ref, port, "{}/p.csv", "--probe",
         "{}/gt.csv", "--fps", "10", "--tune", "--filter", "savgol", "--grid", "5", "8",
         "--smooth", "3", "--save", "--debug", "--out", "{}/plots_s", *lp)
    same_files(ref, port, "plots_s/*.tex")


def test_compare_av_dataset_mode(tmp_path):
    def build(d):
        from geotrax_tpu.ops.tmerc import local2geo

        av = d / "av_trajectories"
        av.mkdir()
        results = d / "results"
        results.mkdir()
        fps, n = 10.0, 80
        t0 = 1_665_100_000.0
        probe_rows, spd_rows, pmap = [], [], {}
        for vi, video in enumerate(("K1_AV", "K2_AV", "L1_AV")):
            tt = t0 + vi * 1000 + np.arange(n) / fps
            x = 170000.0 + 3.0 / fps * np.arange(n)
            y = 532000.0 + 40.0 * vi
            lat, lon = local2geo(x, np.full(n, y), xp=np)
            sec = np.floor(tt)
            nsec = np.round((tt - sec) * 1e9)
            probe_rows.append(np.column_stack([sec, nsec, np.asarray(lon), np.asarray(lat)]))
            spd_rows.append(np.column_stack([sec, nsec, 3.0 + 0.1 * np.sin(np.arange(n))]))
            pd.DataFrame({
                "Vehicle_ID": 5, "Frame_Number": np.arange(n),
                "Timestamp": pd.to_datetime(tt, unit="s"),
                "Local_X": x + np.random.default_rng(vi).normal(0, 0.05, n),
                "Local_Y": y, "Vehicle_Speed": 10.8 + np.random.default_rng(vi).normal(0, .5, n),
                "Visibility": 1,
            }).to_csv(results / f"{video}.csv", index=False)
            pmap[video] = {"id": 5, "start": str(pd.to_datetime(tt[0], unit="s")),
                           "end": str(pd.to_datetime(tt[-1], unit="s"))}
        pmap["Z9_AV"] = {"id": 1, "start": "2022-01-01", "end": "2022-01-02"}
        np.savetxt(av / "sec_nsec_lon_lat_2022.txt", np.vstack(probe_rows))
        np.savetxt(av / "sec_nsec_horSpd_2022.txt", np.vstack(spd_rows))
        (d / "probes.json").write_text(json.dumps(pmap))
        _png(d / "bg.png", 40, 60)

    ref, port = twins(tmp_path, build)
    lp = ("-lp", "{}/logs")
    out = both("compare_av_detections_and_tune_filters", ref, port, "{}", "--probe-map",
               "{}/probes.json", "--fps", "10", "--tune", "--grid", "2", "6", "--save", *lp)
    assert "Intersection K" in out and "Intersection L" in out
    names = same_files(ref, port, "plots/*")
    assert {n.name for n in names} >= {
        "AV_errors_per_video.tex", "AV_errors_per_intersection.tex",
        "AV_trajectories_local.pdf", "AV_trajectories_all.pdf", "AV_speed_comparison.pdf",
        "AV_acceleration_comparison.pdf", "AV_positional_and_speed_errors.pdf",
        "AV_speed_error_sweep.pdf"}
    both("compare_av_detections_and_tune_filters", ref, port, "{}", "--probe-map",
         "{}/probes.json", "--fps", "10", "--smooth", "4.5", "--coords", "ortho", "--save",
         "--ortho-image", "{}/bg.png",
         "--out", "{}/p2", *lp)
    same_files(ref, port, "p2/*")


# ---------------------------------------------------------------------------
# subset_orthophoto (its downscale is the one device step of these tools)
# ---------------------------------------------------------------------------

def _same_png(a, b):
    from geotrax_tpu_torch.io.png import read_png

    assert np.array_equal(read_png(a), read_png(b))


def test_subset_orthophoto(tmp_path):
    """Pixel centres on a PNG mosaic (loaded whole), with one location out
    of the mosaic (logged, exit 1) and the unscaled and scaled crops."""
    def build(d):
        from PIL import Image

        rng = np.random.default_rng(0)
        Image.fromarray(rng.integers(0, 255, (400, 400, 3), np.uint8)).save(d / "mosaic.png")

    ref, port = twins(tmp_path, build)
    common = ("--orthophoto-filepath", "{}/mosaic.png", "-lp", "{}/logs")
    both("subset_orthophoto", ref, port, *common, "--ortho-cutout-folder", "{}/o",
         "--centers", "U=200,200", "--crop-size", "100", "--scale-factor", "1.0")
    both("subset_orthophoto", ref, port, *common, "--ortho-cutout-folder", "{}/s",
         "--centers", "U=200,200", "V=120,260", "W=390,10", "--crop-size", "150",
         "--scale-factor", "0.6", rc=1)
    for rel in ("o/U.png", "s/U.png", "s/V.png"):
        _same_png(ref / rel, port / rel)
    same_files(ref, port, "*/*.txt")
    assert not (port / "s" / "W.png").exists()


def test_subset_orthophoto_geotiff_mode(tmp_path):
    """GeoTIFF with a location dictionary: windowed reads, the parameters
    and centre files, the downscaled PNG; 0.5 (cv2's block mean) and the
    default 8/15 (cv2's area weights) both equal to cv2's pixels."""
    lng_0, lat_0, scale = 126.60, 37.40, 1e-5

    def build(d):
        from geotrax_tpu_torch.io.tiff_tiled import write_tiled_tiff

        rng = np.random.default_rng(1)
        mosaic = rng.integers(0, 255, (600, 800, 3), np.uint8)
        write_tiled_tiff(d / "ortho.tif", mosaic, tile=256, geo=(lng_0, lat_0, scale, scale))
        (d / "loc.json").write_text(json.dumps({
            "U": [lat_0 - 300 * scale, lng_0 + 400 * scale],
            "K": [lat_0 - 250.5 * scale, lng_0 + 333.25 * scale]}))

    ref, port = twins(tmp_path, build)
    common = ("--orthophoto-filepath", "{}/ortho.tif", "--location-dict-filepath",
              "{}/loc.json", "-lp", "{}/logs")
    both("subset_orthophoto", ref, port, *common, "--ortho-cutout-folder", "{}/half",
         "--crop-size", "200", "--scale-factor", "0.5")
    both("subset_orthophoto", ref, port, *common, "--ortho-cutout-folder", "{}/def",
         "--crop-size", "210")
    same_files(ref, port, "*/*.txt")
    for rel in ("half/U.png", "half/K.png", "def/U.png", "def/K.png"):
        _same_png(ref / rel, port / rel)
    both("subset_orthophoto", ref, port, "--orthophoto-filepath", "{}/ortho.tif",
         "--ortho-cutout-folder", "{}/none", "-lp", "{}/logs", rc=1)


@pytest.mark.parametrize("factor", [0.5, 0.5333333, 8 / 15])
def test_downscale_against_cv2(factor):
    """A seeded 1500^2 crop: the port's INTER_AREA on the CPU against
    cv2's. The bound is one grey level at a non-integer scale; the port
    repeats cv2's float32 operations in cv2's order, so no pixel differs."""
    import cv2

    from geotrax_tpu_torch.tools.subset_orthophoto import downscale, output_size

    rng = np.random.default_rng(2)
    crop = rng.integers(0, 256, (1500, 1500, 3), np.uint8)
    crop[:500] = np.add.outer(np.arange(500), np.arange(1500))[..., None] % 256  # smooth band
    got = downscale(crop, factor, "cpu")
    want = cv2.resize(crop, output_size(crop.shape, factor), interpolation=cv2.INTER_AREA)
    assert got.shape == want.shape == (800 if factor != 0.5 else 750,) * 2 + (3,)
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= (0 if factor == 0.5 else 1)
    assert (diff > 0).mean() == 0.0


def test_subset_orthophoto_upscale(tmp_path):
    """--scale-factor above 1: cv2's INTER_AREA grows the crop through its
    linear path in area mode, and so does the port, pixel for pixel."""
    def build(d):
        from PIL import Image

        rng = np.random.default_rng(3)
        Image.fromarray(rng.integers(0, 255, (300, 300, 3), np.uint8)).save(d / "mosaic.png")

    ref, port = twins(tmp_path, build)
    both("subset_orthophoto", ref, port, "--orthophoto-filepath", "{}/mosaic.png",
         "-lp", "{}/logs", "--ortho-cutout-folder", "{}/up", "--centers", "U=150,150",
         "V=100,180", "--crop-size", "90", "--scale-factor", "1.7")
    for rel in ("up/U.png", "up/V.png"):
        _same_png(ref / rel, port / rel)
    same_files(ref, port, "*/*.txt")


@pytest.mark.parametrize("src, dst", [((90, 90), (153, 153)), ((37, 61), (111, 122)),
                                       ((64, 200), (80, 150)), ((120, 40), (90, 97))])
def test_area_upscale_against_cv2(src, dst):
    """INTER_AREA where an axis grows (both, or one of the two): bit-equal
    to cv2's."""
    import cv2
    import torch

    from geotrax_tpu_torch.ops.resize import resize_area_u8

    rng = np.random.default_rng(sum(src) + sum(dst))
    img = rng.integers(0, 256, (*src, 3), np.uint8)
    got = resize_area_u8(torch.from_numpy(img), dst[1], dst[0]).numpy()
    want = cv2.resize(img, (dst[1], dst[0]), interpolation=cv2.INTER_AREA)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# viz_annotations, viz_segmentations (the port's rasterizer against cv2)
# ---------------------------------------------------------------------------

def _drawn_diff(ref_png, port_png, background):
    """(largest difference, mean difference over the pixels either image
    drew on) of two renderings on a plain ``background``."""
    from geotrax_tpu_torch.io.png import read_png

    a = read_png(ref_png).astype(int)
    b = read_png(port_png).astype(int)
    assert a.shape == b.shape
    drawn = (a != background).any(-1) | (b != background).any(-1)
    diff = np.abs(a - b).max(-1)
    return diff.max(), diff[drawn].mean()


def test_viz_annotations_directory_mode(tmp_path):
    def build(d):
        images, labels = d / "images", d / "labels"
        images.mkdir()
        labels.mkdir()
        _png(images / "f1.png", 80, 100)
        _png(images / "f2.png", 80, 100)
        _png(images / "f3.png", 90, 120)
        (labels / "f1.txt").write_text("0 0.3 0.3 0.2 0.2\n0 0.7 0.7 0.2 0.2\n")
        (labels / "f2.txt").write_text("1 0.5 0.5 0.2 0.2\n1 0.2 0.2 0.1 0.1\n0 0.8 0.2 0.1 0.1\n")
        (labels / "f3.txt").write_text("2 0.5 0.6 0.5 0.3\n3 0.1 0.1 0.15 0.1\n")
        (labels / "orphan.txt").write_text("0 0.5 0.5 0.1 0.1\n")

    ref, port = twins(tmp_path, build)
    lp = ("-lp", "{}/logs")
    both("viz_annotations", ref, port, "{}/images", "-a", "{}/labels", "--save", "-n", "1",
         "--type", "0", "-o", "{}/viz", "-cn", "0:car", "1:bus", "-q", *lp)
    assert (port / "viz" / "f1.png").exists() and not (port / "viz" / "f2.png").exists()
    both("viz_annotations", ref, port, "{}/images", "--save", "-cn", "car", "bus", "truck",
         "-lw", "2", *lp)
    both("viz_annotations", ref, port, "{}/images", "--save", *lp)  # existing: skipped
    both("viz_annotations", ref, port, "{}/images", "--save", "--overwrite", "-lw", "5",
         "-o", "{}/wide", *lp)
    for rel in ("viz/f1.png", "visualizations/f1.png", "visualizations/f2.png",
                "visualizations/f3.png", "wide/f3.png"):
        largest, mean = _drawn_diff(ref / rel, port / rel, 40)
        assert mean <= DRAW_MEAN_TOL, (rel, largest, mean)


def test_viz_annotations_single_image(tmp_path):
    def build(d):
        (d / "data" / "frames").mkdir(parents=True)
        (d / "data" / "labels").mkdir()
        _png(d / "data" / "frames" / "x.png", 60, 60, 10)
        (d / "data" / "labels" / "x.txt").write_text("3 0.5 0.5 0.5 0.5\n")
        (d / "names.yaml").write_text("0: car\n3: motorcycle\n")

    ref, port = twins(tmp_path, build)
    lp = ("-lp", "{}/logs")
    both("viz_annotations", ref, port, "{}/data/frames/x.png", "--save", "--no-show-labels",
         "-q", *lp)
    both("viz_annotations", ref, port, "{}/data/frames/x.png", "--save", "-o", "{}/named",
         "-cn", "{}/names.yaml", *lp)
    for rel in ("data/visualizations/x.png", "named/x.png"):
        largest, mean = _drawn_diff(ref / rel, port / rel, 10)
        assert mean <= DRAW_MEAN_TOL, (rel, largest, mean)
    rc, out = run_port("viz_annotations", port / "data" / "frames" / "x.png")
    assert rc == 1 and "display" in out  # --show (the default without --save)


def test_viz_segmentations(tmp_path):
    """Lane quads inside the orthophoto: fill and 2-px outline are cv2's
    pixels, the labels within one grey level, blended as cv2.addWeighted."""
    def build(d):
        rng = np.random.default_rng(4)
        from PIL import Image

        Image.fromarray(rng.integers(0, 255, (200, 260, 3), np.uint8)).save(d / "U.png")
        Image.new("RGB", (120, 90), (40, 40, 40)).save(d / "K.png")
        seg = d / "seg"
        seg.mkdir()
        pd.DataFrame({
            "section": ["1_2", "1_2", "3_4"], "lane": [1, 2, 1],
            "tlx": [20, 60, 150], "tly": [20, 25, 100], "blx": [22, 64, 140],
            "bly": [80, 90, 180], "brx": [52, 90, 230], "bry": [82, 88, 170],
            "trx": [50, 85, 240], "try": [18, 22, 110], "extra": [0, 0, 0],
        }).to_csv(seg / "U.csv", index=False)
        pd.DataFrame({
            "section": [1, 2], "lane": [1, 2],
            "tlx": [10.7, 50.2], "tly": [10, 15], "blx": [12, 55], "bly": [60, 70],
            "brx": [40, 100], "bry": [55, 80], "trx": [35, 95.9], "try": [8, 12],
        }).to_csv(seg / "K.csv", index=False)
        pd.DataFrame({"section": [1], "lane": [1]}).to_csv(seg / "Z.csv", index=False)

    ref, port = twins(tmp_path, build)
    both("viz_segmentations", ref, port, "{}", "-sf", "{}/seg", "-o", "{}/out")
    from geotrax_tpu_torch.io.png import read_png

    for name in ("U", "K"):
        a = read_png(ref / "out" / f"{name}.png").astype(int)
        b = read_png(port / "out" / f"{name}.png").astype(int)
        assert np.abs(a - b).max() <= 1, name
    empty = tmp_path / "none"
    (empty / "segmentations").mkdir(parents=True)
    both("viz_segmentations", empty, empty, "{}", rc=1)


# ---------------------------------------------------------------------------
# without a card: --device where a tool uses one, and the shared host pieces
# ---------------------------------------------------------------------------

MINIMAL_ARGS = {
    "find_max_annotations": ["labels"],
    "interpolate_missing_timestamps": ["log.csv"],
    "yolo_to_coco": ["labels"],
    "fix_json_annotations": ["labels"],
    "find_source_id": ["--dataset-csv", "d.csv", "1"],
    "check_dataset": ["d.csv"],
    "compare_tracking": ["a", "b"],
    "analyze_bb_ratios": ["v.mp4"],
    "compute_bb_center_error": ["images"],
    "find_cut_video_issues": ["log.csv"],
    "fix_timestamp_anomalies": ["anomalies.csv"],
    "viz_dimension_estimation": ["V.txt", "--id", "1"],
    "compare_av_detections_and_tune_filters": ["p.csv", "--probe", "gt.csv"],
    "subset_orthophoto": ["--orthophoto-filepath", "o.tif", "--ortho-cutout-folder", "out"],
    "viz_annotations": ["images", "--save"],
    "viz_segmentations": ["ortho"],
}


@pytest.mark.parametrize("tool", DEVICE_TOOLS)
def test_device_cuda_without_a_card_exits_1(tool, tmp_path, monkeypatch):
    import torch

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"geotrax_tpu_torch.tools.{tool}")
    rc, out = _call(lambda: mod.main([*MINIMAL_ARGS[tool], "--device", "cuda"]))
    assert rc == 1 and "cuda" in out, out
    assert not list(tmp_path.iterdir())  # nothing written


@pytest.mark.parametrize("tool", sorted(set(MINIMAL_ARGS) - set(DEVICE_TOOLS)))
def test_host_tool_without_a_card_is_the_reference(tool, tmp_path, monkeypatch):
    """A tool that does no tensor work takes no --device and, on a machine
    without a card, answers missing inputs as the reference does: the same
    exit code and text, or the same exception."""
    import torch

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"geotrax_tpu_torch.tools.{tool}")
    rc, out = _call(lambda: mod.main([*MINIMAL_ARGS[tool], "--device", "cpu"]))
    assert rc == 2 and "unrecognized arguments: --device cpu" in out, out

    def outcome(run):
        try:
            return run(tool, *MINIMAL_ARGS[tool])
        except Exception as exc:  # a missing input the tool does not catch
            return type(exc).__name__

    assert outcome(run_port) == outcome(run_ref)


def test_to_string_is_pandas():
    from geotrax_tpu_torch.io import table

    rng = np.random.default_rng(0)
    for _ in range(200):
        n = int(rng.integers(1, 6))
        cols = {}
        for c in range(int(rng.integers(1, 6))):
            name = f"c{c}" + "x" * int(rng.integers(0, 8))
            kind = c % 5
            if kind == 0:
                v = rng.normal(0, 10 ** rng.uniform(-8, 9), n)
                if rng.random() < .5:
                    v = np.round(v, int(rng.integers(0, 4)))
                v[rng.random(n) < .2] = np.nan
            elif kind == 1:
                v = rng.integers(-1000, 100000, n)
            elif kind == 2:
                v = np.array([str(rng.choice(["a.csv", "U_b.mp4", "x y", "p/q.mp4"]))
                              for _ in range(n)], dtype=object)
            elif kind == 3:
                v = np.empty(n, object)
                v[:] = [None if rng.random() < .5 else int(rng.integers(0, 50)) for _ in range(n)]
            else:
                v = rng.random(n) < .5
            cols[name] = v
        frame = pd.DataFrame({k: pd.Series(v, dtype=object) if v.dtype == object else v
                              for k, v in cols.items()})
        assert table.to_string(cols) == frame.to_string(index=False)


def test_to_datetime_ns_is_pandas():
    from geotrax_tpu_torch.io import table

    forms = ["x", "2022-10-07 10:00:00.000", "2022-10-07 10:00:00.5", "2022-10-07 10:00:01",
             "2022-10-07 10:00:00,123", "2022-10-07T10:00:00.25", None, "t",
             "2022-02-30 10:00:00.000", "2022-1-7 1:0:0.000", "2022-10-07",
             "2022-10-07 10:00", "2022-10-07 10:00:00.123456789", " 2022-10-07 10:00:00.100",
             "2022-10-07 10:00:00.100 ", "2022-10-07 24:00:00.000", "00:00:01,033", "00:00:02",
             "2022-13-01 10:00:00.000"]
    rng = np.random.default_rng(1)
    for _ in range(400):
        cells = [forms[i] for i in rng.integers(0, len(forms), int(rng.integers(1, 6)))]
        stamps = pd.to_datetime(pd.Series(cells, dtype=object), errors="coerce")
        want_missing = stamps.isna().to_numpy()
        want = stamps.to_numpy().astype("datetime64[ns]").astype(np.int64)
        ns, missing = table.to_datetime_ns(np.array([np.nan if c is None else c
                                                     for c in cells], dtype=object))
        assert np.array_equal(missing, want_missing), cells
        assert np.array_equal(ns[~missing], want[~want_missing]), cells
        diff = stamps.diff().dt.total_seconds().to_numpy()
        np.testing.assert_array_equal(table.diff_seconds(ns, missing), diff)
    ns = pd.to_datetime(["2022-10-07 10:00:00.1234567", "1999-12-31 23:59:59.9"]).asi8
    assert table.format_datetime_ns(ns) == list(
        pd.to_datetime(ns, unit="ns").strftime("%Y-%m-%d %H:%M:%S.%f"))


def test_grouping_sorting_joining_are_pandas(tmp_path):
    from geotrax_tpu_torch.io import table

    rng = np.random.default_rng(2)
    for _ in range(50):
        n = int(rng.integers(1, 40))
        keys = rng.integers(0, 6, n)
        vals = np.round(rng.normal(0, 3, n), 1)  # ties
        s = pd.Series(vals)
        groups, best = table.idxmax_by(keys, vals)
        want = s.groupby(pd.Series(keys)).idxmax()
        assert groups.tolist() == want.index.tolist() and best.tolist() == want.tolist()
        assert table.argsort_descending(vals).tolist() == \
            s.sort_values(ascending=False).index.tolist()
        left = {"Frame_Number": rng.integers(0, 8, n), "Local_X": rng.normal(size=n)}
        m = int(rng.integers(1, 10))
        right = {"frame": rng.integers(0, 8, m), "Local_X": rng.normal(size=m)}
        joined = table.merge_inner(left, right, "Frame_Number", "frame", suffixes=("", "_gt"))
        want = pd.DataFrame(left).merge(pd.DataFrame(right), left_on="Frame_Number",
                                        right_on="frame", suffixes=("", "_gt"))
        assert list(joined) == list(want.columns)
        for k in joined:
            assert np.array_equal(joined[k], want[k].to_numpy()), k
    pd.DataFrame({"a": [1, 2], "Vehicle_ID": [3.0, np.nan], "b": ["x", "y"]}).to_csv(
        tmp_path / "t.csv", index=False)
    got = table.read_columns(tmp_path / "t.csv", ["Vehicle_ID", "b"])
    want = pd.read_csv(tmp_path / "t.csv", usecols=["Vehicle_ID", "b"])
    assert list(got) == list(want.columns)
    np.testing.assert_array_equal(got["Vehicle_ID"], want["Vehicle_ID"].to_numpy())
    with pytest.raises(ValueError):
        table.read_columns(tmp_path / "t.csv", ["nope"])


def test_image_size_is_pillow_and_cv2(tmp_path):
    import cv2
    from PIL import Image

    from geotrax_tpu_torch.io.image_size import image_size

    rng = np.random.default_rng(3)
    for ext in ("png", "jpg", "bmp", "tif"):
        for h, w in ((80, 100), (37, 251)):
            path = tmp_path / f"im_{h}.{ext}"
            Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8)).save(path)
            assert image_size(path) == Image.open(path).size
            assert image_size(path, exif_orientation=True) == cv2.imread(str(path)).shape[1::-1]
    img = Image.fromarray(rng.integers(0, 255, (40, 90, 3), np.uint8))
    exif = img.getexif()
    exif[0x0112] = 6  # rotated 90 degrees
    img.save(tmp_path / "rot.jpg", exif=exif)
    img.save(tmp_path / "prog.jpg", progressive=True)
    assert image_size(tmp_path / "rot.jpg") == (90, 40)
    assert image_size(tmp_path / "rot.jpg", exif_orientation=True) == \
        cv2.imread(str(tmp_path / "rot.jpg")).shape[1::-1] == (40, 90)
    assert image_size(tmp_path / "prog.jpg") == (90, 40)
    (tmp_path / "x.gif").write_bytes(b"GIF89a")
    with pytest.raises(ValueError):
        image_size(tmp_path / "x.gif")


def test_viz_annotations_jpeg_output(tmp_path):
    """A .jpg image in, a .jpg out: written through io/video.write_jpeg at
    cv2.imwrite's default quality; the decoded pixels within the drawing
    bound plus JPEG_TOL on average."""
    def build(d):
        from PIL import Image

        (d / "images").mkdir()
        (d / "labels").mkdir()
        ramp = np.add.outer(np.arange(90), np.arange(120))[..., None] * [1, 2, 3] % 256
        Image.fromarray(ramp.astype(np.uint8)).save(d / "images" / "a.jpg", quality=95)
        (d / "labels" / "a.txt").write_text("0 0.5 0.5 0.4 0.4\n2 0.2 0.3 0.2 0.2\n")

    ref, port = twins(tmp_path, build)
    both("viz_annotations", ref, port, "{}/images", "--save", "-q", "-lp", "{}/logs")
    from PIL import Image

    a = np.asarray(Image.open(ref / "visualizations" / "a.jpg")).astype(int)
    b = np.asarray(Image.open(port / "visualizations" / "a.jpg")).astype(int)
    assert a.shape == b.shape
    assert np.abs(a - b).mean() <= JPEG_MEAN_TOL
