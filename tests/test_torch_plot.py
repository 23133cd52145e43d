"""The port's `plot` stage against the JAX package's (``_plot_impl``).

The data half exactly: file choice, the CSV and txt readers (every column
equal to the reference's DataFrame column), the class filter, aggregation
by location and the alerts (the same log lines). The figures: ``_save`` is
replaced in both packages by a recorder, and every figure's file name,
title, axis labels, tick labels, texts and drawn data (line data,
collection offsets and paths -- the violins and their quartile lines --
bar rectangles and box patches) must agree (float data within 1e-9
relative). And the port's stage imports neither matplotlib nor seaborn
until it draws a figure."""

import argparse
import logging
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from geotrax_tpu.pipeline import _plot_impl as jplot
from geotrax_tpu_torch.pipeline import plot as tplot

LOG = logging.getLogger("test-torch-plot")
ROOT = Path(__file__).resolve().parent.parent


def geo_csv(path: Path, vehicle_ids=(1, 2, 3), n=30, speed=40.0, seed=0, lanes=True):
    """A georeferenced CSV of the reference's 17 columns plus Frame_Number,
    with a missing speed, a stationary vehicle and a string road section."""
    rng = np.random.default_rng(seed)
    rows = []
    for vid in vehicle_ids:
        moving = vid != 3
        for t in range(n):
            rows.append({
                "Vehicle_ID": vid, "Timestamp": f"2024-05-01 10:00:{t // 30:02d}.{t % 30:03d}",
                "Frame_Number": t,
                "Ortho_X": 100 + 5 * t * moving + vid * 50 + rng.normal(), "Ortho_Y": 200 + vid * 20,
                "Local_X": 170000 + t * moving, "Local_Y": 532000 + vid + rng.normal(),
                "Latitude": 37.39 + 1e-5 * t, "Longitude": 126.66 + 1e-5 * vid,
                "Vehicle_Length": 4.5 + vid * 0.5 + rng.normal(0, 0.1), "Vehicle_Width": 1.9,
                "Vehicle_Class": vid % 3,
                "Vehicle_Speed": (np.nan if t == 5 else (speed + t * 0.1 + rng.normal()) * moving),
                "Vehicle_Acceleration": rng.normal(0, 3), "Road_Section": "1_2",
                "Lane_Number": (1 + vid % 2) if lanes else np.nan, "Visibility": 1,
            })
    pd.DataFrame(rows).to_csv(path, index=False)


def tracks_txt(path: Path, ncols=14, n=20, seed=0):
    rng = np.random.default_rng(seed)
    rows = []
    for vid in (1, 2, 4):
        for t in range(n):
            x, y = 10 + 3 * t + vid, 20 + vid * 7 + rng.normal()
            rows.append([t, vid, x, y, 30, 12, x + 1, y, 30, 12, vid % 2, 0.9, 30 + vid,
                         11 + rng.normal(), t % 4 == 3][:ncols])
    np.savetxt(path, np.array(rows), fmt="%g", delimiter=",")


def make_args(**over):
    defaults = dict(
        input=None, save=True, show=False, cfg="default", output_folder=None,
        log_path=None, verbose=False, aggregate=None, ortho_folder=None,
        segmentation_folder=None, segmentations=None, id=0, points=None,
        class_filter=None, model=None, class_names=["0=car", "1=bus", "2=truck", "3=motorcycle"],
    )
    defaults.update(over)
    return argparse.Namespace(**defaults)


def assert_tables_equal(got: dict, want: pd.DataFrame):
    """Equal columns, names and kinds; floats within 1e-15 relative (pandas'
    C parser rounds some decimals an ulp or two away from Python's
    ``float``, which the port's CSV reader uses)."""
    assert list(got) == list(want.columns)
    for name in want.columns:
        w = want[name].to_numpy()
        g = got[name]
        assert g.dtype.kind == w.dtype.kind, (name, g.dtype, w.dtype)
        if w.dtype.kind == "f":
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=name)
            np.testing.assert_allclose(g, w, rtol=1e-15, atol=0, err_msg=name)
        else:
            assert g.tolist() == w.tolist(), name


# ---------------------------------------------------------------- data half
@pytest.mark.parametrize("kind", ["csv", "txt14", "txt10", "txt15"])
def test_read_trajectory_data_equals_the_references(tmp_path, kind):
    if kind == "csv":
        path = tmp_path / "U_clip.csv"
        geo_csv(path)
    else:
        path = tmp_path / "U_clip.txt"
        tracks_txt(path, ncols=int(kind[3:]))
    assert_tables_equal(tplot.read_trajectory_data(path, LOG), jplot.read_trajectory_data(path, LOG))


def test_read_trajectory_data_refuses_what_the_reference_refuses(tmp_path):
    path = tmp_path / "U_bad.csv"
    pd.DataFrame({"Vehicle_ID": [1], "Ortho_X": [1.0]}).to_csv(path, index=False)
    for impl in (jplot, tplot):
        with pytest.raises(SystemExit):
            impl.read_trajectory_data(path, LOG)


@pytest.mark.parametrize("skip,prefer", [(["transf"], "csv"), (["bus", "ids", "transf"], "csv"),
                                         (["transf"], "txt_only")])
def test_determine_files_equals_the_references(tmp_path, skip, prefer):
    for sub in ("vids/results", "other/results", "other/elsewhere"):
        (tmp_path / sub).mkdir(parents=True)
    geo_csv(tmp_path / "vids/results/U_clip.csv")
    np.savetxt(tmp_path / "vids/results/U_clip.txt", np.ones((3, 14)), delimiter=",")
    np.savetxt(tmp_path / "vids/results/U_clip_vid_transf.txt", np.ones((3, 10)), delimiter=",")
    tracks_txt(tmp_path / "other/results/K_bus.txt")
    tracks_txt(tmp_path / "other/elsewhere/K_x.txt")
    if prefer == "txt_only":
        (tmp_path / "vids/results/U_clip.csv").unlink()
    cfg, out = {"skip_filenames_with": skip}, {"folder": "results"}
    assert (tplot.determine_files_to_process(tmp_path, cfg, out, LOG)
            == jplot.determine_files_to_process(tmp_path, cfg, out, LOG))
    # a video resolves to its georeferenced CSV, else its tracks
    video = tmp_path / "vids" / "U_clip.mp4"
    video.write_bytes(b"x")
    assert (tplot.determine_files_to_process(video, cfg, out, LOG)
            == jplot.determine_files_to_process(video, cfg, out, LOG))


def test_class_filter_equals_the_references(tmp_path):
    path = tmp_path / "U_clip.csv"
    geo_csv(path)
    for flt in ([0], [0, 2], [], None):
        assert_tables_equal(tplot.filter_classes(tplot.read_trajectory_data(path, LOG), flt),
                            jplot.filter_classes(jplot.read_trajectory_data(path, LOG), flt)
                            .reset_index(drop=True))


@pytest.mark.parametrize("speed", [40.0, 95.0])
def test_alerts_equal_the_references(tmp_path, caplog, speed):
    path = tmp_path / "U_fast.csv"
    geo_csv(path, speed=speed)
    with caplog.at_level(logging.WARNING, logger=LOG.name):
        jplot.report_high_value_instances(jplot.read_trajectory_data(path, LOG), LOG)
        want = [r.getMessage() for r in caplog.records]
        caplog.clear()
        tplot.report_high_value_instances(tplot.read_trajectory_data(path, LOG), LOG)
        got = [r.getMessage() for r in caplog.records]
    assert got == want and any("m/s^2" in m for m in got)
    assert any("km/h" in m for m in got) == (speed > 90)


def test_concat_fills_missing_columns_as_pandas(tmp_path):
    geo_csv(tmp_path / "U_a.csv")
    tracks_txt(tmp_path / "U_b.txt")
    t = [tplot.read_trajectory_data(tmp_path / n, LOG) for n in ("U_a.csv", "U_b.txt")]
    j = [jplot.read_trajectory_data(tmp_path / n, LOG) for n in ("U_a.csv", "U_b.txt")]
    merged = tplot.concat(t)
    want = pd.concat(j, ignore_index=True)
    assert list(merged) == list(want.columns)
    for name in want.columns:
        w = want[name].to_numpy()
        if w.dtype.kind == "f":
            g = merged[name].astype(float)
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=name)
            np.testing.assert_allclose(g, w, rtol=1e-15, atol=0, err_msg=name)
        else:
            assert [x if x == x else None for x in merged[name].tolist()] == \
                [x if x == x else None for x in w.tolist()], name


# ---------------------------------------------------------------- figures
def figure_record(fig, stem, title, save) -> dict:
    """What a figure draws, in plain Python and numpy."""
    fig.canvas.draw()
    axes = []
    for ax in fig.axes:
        axes.append({
            "title": ax.get_title(), "xlabel": ax.get_xlabel(), "ylabel": ax.get_ylabel(),
            "xticks": [t.get_text() for t in ax.get_xticklabels()],
            "yticks": [t.get_text() for t in ax.get_yticklabels()],
            "texts": [t.get_text() for t in ax.texts],
            "lines": [np.asarray(l.get_xydata(), float) for l in ax.lines],
            "line_colors": [l.get_color() for l in ax.lines],
            "collections": [(type(c).__name__, np.asarray(c.get_offsets(), float),
                             [np.asarray(p.vertices, float) for p in c.get_paths()])
                            for c in ax.collections],
            "patches": [(type(p).__name__, np.asarray(p.get_path().vertices, float),
                         np.asarray(p.get_patch_transform().get_matrix(), float))
                        for p in ax.patches],
            "images": [np.asarray(im.get_array()) for im in ax.images],
        })
    return {"name": f"{stem}_{title.replace(' ', '_')}.pdf", "save": save, "axes": axes}


def recorded_run(impl, monkeypatch, args) -> list:
    import matplotlib.pyplot as plt

    figures = []

    def record(fig, plots_dir, stem, title, save, show, logger):
        figures.append(figure_record(fig, stem, title, save))
        plt.close(fig)

    monkeypatch.setattr(impl, "_save", record)
    (jplot.run_plotting if impl is jplot else tplot.generate_plots)(args, LOG)
    return figures


def assert_same(a, b, where):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), (where, len(a), len(b))
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.shape == b.shape, (where, a.shape, b.shape)
        if a.dtype.kind == "f" or b.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=1e-9, atol=1e-12, err_msg=where)
        else:
            np.testing.assert_array_equal(b, a, err_msg=where)
    else:
        assert a == b, (where, a, b)


@pytest.mark.parametrize("case", ["csv", "txt", "aggregate", "points_id_filter", "ortho"])
def test_figures_equal_the_references(tmp_path, monkeypatch, case):
    pytest.importorskip("matplotlib")
    pytest.importorskip("seaborn")
    results = tmp_path / "results"
    results.mkdir()
    over = {}
    if case == "csv":
        geo_csv(results / "U_clip.csv")
        over["input"] = results / "U_clip.csv"
    elif case == "txt":
        tracks_txt(results / "U_clip.txt")
        over["input"] = results / "U_clip.txt"
    elif case == "aggregate":
        for name, seed in (("U_a", 1), ("U_b", 2), ("K_a", 3)):
            (tmp_path / name / "results").mkdir(parents=True)
            geo_csv(tmp_path / name / "results" / f"{name}_clip.csv", seed=seed)
        tracks_txt(tmp_path / "U_a" / "results" / "U_c.txt")
        over.update(input=tmp_path, aggregate=True)
    elif case == "points_id_filter":
        geo_csv(results / "U_clip.csv", lanes=False)
        over.update(input=results / "U_clip.csv", points=True, id=2, class_filter=[0])
    else:
        from geotrax_tpu_torch.io import png

        geo_csv(results / "U_clip.csv")
        ortho = tmp_path / "ortho"
        ortho.mkdir()
        rng = np.random.default_rng(5)
        png.write_png(ortho / "U.png", rng.integers(0, 255, (60, 80, 3), dtype=np.uint8))
        png.write_png(ortho / "U_seg.png", rng.integers(0, 255, (60, 80, 3), dtype=np.uint8))
        (ortho / "U_seg.png").rename(tmp_path / "U.png")
        over.update(input=results / "U_clip.csv", ortho_folder=ortho,
                    segmentation_folder=tmp_path, segmentations=True)
    want = recorded_run(jplot, monkeypatch, make_args(**over))
    got = recorded_run(tplot, monkeypatch, make_args(**over))
    assert [f["name"] for f in got] == [f["name"] for f in want] and want
    for w, g in zip(want, got):
        assert_same(w, g, w["name"])


def test_plot_writes_the_references_pdfs(tmp_path):
    """The CLI writes the reference's set of PDFs."""
    pytest.importorskip("seaborn")
    for tag, impl in (("j", None), ("t", tplot)):
        results = tmp_path / tag / "results"
        results.mkdir(parents=True)
        geo_csv(results / "U_clip.csv")
    jplot.run_plotting(make_args(input=tmp_path / "j" / "results" / "U_clip.csv"), LOG)
    assert tplot.main([str(tmp_path / "t" / "results" / "U_clip.csv"), "--device", "cpu",
                       "-lp", str(tmp_path / "logs")]) == 0
    names = {t: sorted(p.name for p in (tmp_path / t / "results" / "plots").glob("*.pdf"))
             for t in ("j", "t")}
    assert names["t"] == names["j"] and len(names["t"]) == 9, names


def test_stage_imports_no_matplotlib_until_a_figure():
    code = ("import sys; import geotrax_tpu_torch.pipeline.plot as p; "
            "import geotrax_tpu_torch.pipeline.visualize as v; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('matplotlib', 'seaborn', 'cv2', 'pandas', 'geotrax_tpu', 'jax')]; "
            "assert not bad, bad; print('ok')")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0 and "ok" in proc.stdout, proc.stderr
