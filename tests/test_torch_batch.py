"""`batch` and `config` of the port against the JAX package's.

The cases of tests/test_batch_process.py on the port's orchestrator, with
its stages replaced (skip-if-exists, overwrite prompting, dry run, stage
selection, exclusion, files the lockstep pre-pass extracted not extracted
again), the lockstep pre-pass itself (groups by resolution, leftovers and a
failing group through the per-file path), the stage gates running
visualize and plot where the reference's run them; and ``config show`` /
``config copy`` printing and copying what the reference's do, apart from
the presets' directory."""

import argparse
import logging
import sys
from pathlib import Path
from unittest.mock import patch

import numpy as np
import pytest

from geotrax_tpu.pipeline import batch as jbatch
from geotrax_tpu.pipeline import config_cmd as jconfig
from geotrax_tpu_torch.cfg import CFG_DIR
from geotrax_tpu_torch.io import video as tvideo
from geotrax_tpu_torch.io.video import VideoInfo
from geotrax_tpu_torch.parallel import extract_batch as teb
from geotrax_tpu_torch.pipeline import batch
from geotrax_tpu_torch.pipeline import config_cmd

LOG = logging.getLogger("test-torch-batch")


def make_args(**over):
    defaults = dict(
        input=None, yes=False, overwrite=False, dry_run=False, viz_only=False,
        geo_only=False, plot_only=False, no_geo=False, folders_exclude=None,
        exclude_patterns=None, cfg="default", output_folder=None, log_path=None,
        verbose=False, model=None, class_names=None, conf=None, classes=None,
        cut_frame_left=None, cut_frame_right=None, interpolate=None,
        ortho_folder=None, geo_source=None, ref_frame=None, no_master=None,
        master_folder=None, recompute=None, segmentation_folder=None,
        save=False, show=False, viz_mode=[0], plot_trajectories=None,
        plot_delay=None, show_conf=None, show_lanes=None, show_class_names=None,
        hide_labels=None, hide_tracks=None, hide_speed=None, speed_unit=None,
        speed_deadzone=None, class_filter=None, tail_length=None, line_width=None,
        heading_smoothing=None, heading_min_speed=None, edge_clip_margin=None,
        edge_clip_smoothing=None, plot_save=False, plot_show=False,
        plot_aggregate=None, plot_points=None, plot_segmentations=None,
        plot_class_filter=None, device="cpu", parallel_videos=1, devices=None,
    )
    defaults.update(over)
    return argparse.Namespace(**defaults)


@pytest.fixture
def stages(monkeypatch):
    """The stage functions replaced by recorders: [(stage, file)]."""
    calls = []
    for name in ("detect_track_stabilize", "georeference", "visualize_results"):
        monkeypatch.setattr(batch, name, lambda a, lg, n=name: calls.append((n, Path(a.source))))
    return calls


def test_filter_files_exclusions(tmp_path):
    files = [tmp_path / "videos" / "a.mp4", tmp_path / "results" / "b.mp4",
             tmp_path / "videos" / "skipme_c.mp4"]
    args = make_args(folders_exclude=["results"], exclude_patterns=["skipme"])
    assert batch.filter_files_to_process(files, args, LOG) == [files[0]]
    assert jbatch.filter_files_to_process(files, args, LOG) == [files[0]]


@pytest.mark.parametrize("overwrite,yes,answer,exists,expected", [
    (False, False, None, True, False),
    (False, False, None, False, True),
    (True, True, None, True, True),
    (True, False, "y", True, True),
    (True, False, "n", True, False),
])
def test_handle_existing_results(overwrite, yes, answer, exists, expected):
    args = make_args(overwrite=overwrite, yes=yes)
    with patch("builtins.input", return_value=answer or ""):
        for mod in (batch, jbatch):
            assert mod.handle_existing_results(Path("v.mp4"), args, LOG, exists, "X") is expected


def test_should_process_georef_requires_tracks_and_extract_skips_existing(tmp_path):
    video = tmp_path / "v.mp4"
    assert batch.should_process_file(video, make_args(), LOG, batch.ACTION_GEOREF) is False
    (tmp_path / "results").mkdir()
    (tmp_path / "results" / "v.txt").write_text("0,1,1,1,1,1\n")
    assert batch.should_process_file(video, make_args(), LOG, batch.ACTION_EXTRACT) is False
    args = make_args(overwrite=True, yes=True)
    assert batch.should_process_file(video, args, LOG, batch.ACTION_EXTRACT) is True
    assert batch.should_process_file(video, make_args(), LOG, batch.ACTION_GEOREF) is True
    # visualization: the mp4 of every requested mode must exist to skip
    for mode in (0, 1):
        assert batch.should_process_file(video, make_args(viz_mode=[mode]), LOG,
                                         batch.ACTION_VISUALIZE) is True
    (tmp_path / "results" / "v_mode_1.mp4").write_bytes(b"x")
    for mode, expected in ((0, True), (1, False)):
        args = make_args(viz_mode=[mode])
        assert batch.should_process_file(video, args, LOG, batch.ACTION_VISUALIZE) is expected
        assert jbatch.should_process_file(video, args, LOG, jbatch.ACTION_VISUALIZE) is expected


def test_dry_run_executes_nothing(tmp_path, stages):
    video = tmp_path / "v.mp4"
    video.write_bytes(b"x")
    batch.process_input(make_args(input=video, dry_run=True, no_geo=True), LOG)
    assert stages == []


def test_single_file_stage_sequence(tmp_path, stages):
    video = tmp_path / "v.mp4"
    video.write_bytes(b"x")
    # no tracks yet: georeferencing is skipped with an error, extraction runs
    batch.process_input(make_args(input=video, save=False, show=False), LOG)
    assert stages == [("detect_track_stabilize", video)]


def test_directory_scan(tmp_path, monkeypatch):
    (tmp_path / "d1").mkdir()
    (tmp_path / "results").mkdir()
    v1 = tmp_path / "d1" / "a.mp4"
    v2 = tmp_path / "results" / "b.mp4"  # excluded folder
    v1.write_bytes(b"x")
    v2.write_bytes(b"x")
    seen = []
    monkeypatch.setattr(batch, "process_file", lambda f, a, lg, oc=None, **kw: seen.append(f))
    args = make_args(input=tmp_path, cut_frame_right=7)
    batch.process_input(args, LOG)
    assert seen == [v1]
    assert args.cut_frame_right is None  # directory mode processes whole videos


def test_geo_only_suppresses_visualization(tmp_path, stages):
    video = tmp_path / "v.mp4"
    video.write_bytes(b"x")
    (tmp_path / "results").mkdir()
    (tmp_path / "results" / "v.txt").write_text("1,1,5,5,4,4,5,5,4,4,0,0.9,5,3\n")
    batch.process_input(make_args(input=video, geo_only=True, save=None, show=None), LOG)
    assert stages == [("georeference", video)]


def test_parallel_extracted_files_not_reextracted(tmp_path, stages):
    video = tmp_path / "v.mp4"
    video.write_bytes(b"x")
    args = make_args(input=video, no_geo=True, overwrite=True, yes=True)
    batch.process_file(video, args, LOG, None, extracted={video})
    assert stages == []
    batch.process_file(video, args, LOG, None, extracted=set())
    assert stages == [("detect_track_stabilize", video)]


@pytest.mark.parametrize("over,stages_named", [
    ({}, ["visualize", "plot"]),
    ({"save": False, "show": False}, ["plot"]),
    ({"plot_save": False, "plot_show": False}, ["visualize"]),
    ({"show": True, "save": False, "plot_save": False, "plot_show": False}, ["visualize"]),
    ({"geo_only": True}, []),
    ({"plot_only": True, "plot_save": False, "plot_show": False}, []),
])
def test_unported_stages_exit_before_any_stage(tmp_path, monkeypatch, over, stages_named):
    """The stage gates run visualize and plot where the reference's do (the
    port used to exit with code 2 here, before they were ported): the same
    stage calls, in the same order, as the JAX package's batch with its
    stages replaced the same way, and exactly the stages named."""
    (tmp_path / "d" / "results").mkdir(parents=True)
    for name in ("a", "b"):
        (tmp_path / "d" / f"{name}.mp4").write_bytes(b"x")
        (tmp_path / "d" / "results" / f"{name}.txt").write_text("1,1,5,5,4,4,5,5,4,4,0,0.9,5,3\n")
    runs = {}
    for name, module in (("port", batch), ("reference", jbatch)):
        calls = []
        for stage in ("detect_track_stabilize", "georeference", "visualize_results",
                      "generate_plots"):
            monkeypatch.setattr(module, stage, lambda a, lg, n=stage: calls.append(
                (n, Path(a.input if n == "generate_plots" else a.source))))
        args = make_args(input=tmp_path, no_geo=True, overwrite=True, yes=True,
                         **{"save": None, "show": None, "plot_save": None, "plot_show": None,
                            **over})
        module.process_input(args, LOG)
        runs[name] = calls
    assert runs["port"] == runs["reference"]
    ran = {"visualize_results": "visualize", "generate_plots": "plot"}
    assert [ran[n] for n in dict.fromkeys(n for n, _ in runs["port"]) if n in ran] == stages_named
    assert ("visualize" in stages_named) == (("visualize_results", tmp_path / "d" / "b.mp4")
                                             in runs["port"])


def test_main_exit_codes(tmp_path, stages):
    (tmp_path / "d").mkdir()
    (tmp_path / "d" / "a.mp4").write_bytes(b"x")
    logs = ["--log-path", str(tmp_path / "logs")]
    # the default gates open visualize and plot; a dry run runs no stage
    assert batch.main([str(tmp_path), "--no-geo", "--dry-run"] + logs) == 0
    assert stages == []
    assert batch.main([str(tmp_path), "--no-geo", "--no-save", "--no-show", "--no-plot-save",
                       "--no-plot-show", "--device", "cpu"] + logs) == 0
    assert stages == [("detect_track_stabilize", tmp_path / "d" / "a.mp4")]


@pytest.fixture
def lockstep(monkeypatch, tmp_path):
    """Five placeholder videos, three at 320x240 and two at 640x480, their
    probe and the lockstep extractor replaced: [group]."""
    (tmp_path / "v").mkdir()
    sizes = {"a": (320, 240), "b": (640, 480), "c": (320, 240), "d": (320, 240), "e": (640, 480)}
    for name in sizes:
        (tmp_path / "v" / f"{name}.mp4").write_bytes(b"x")
    model = tmp_path / "m.npz"
    np.savez(model, **{"param:none": np.zeros(1)})
    monkeypatch.setattr(tvideo, "probe_video",
                        lambda p: VideoInfo(*sizes[Path(p).stem], 30.0, 10))
    groups = []
    monkeypatch.setattr(teb, "extract_videos_batch",
                        lambda files, args, config, logger: groups.append([f.stem for f in files]))
    return tmp_path, model, groups


def test_lockstep_prepass_groups_by_resolution(lockstep, stages):
    root, model, groups = lockstep
    args = make_args(input=root, no_geo=True, parallel_videos=2, model=[str(model)])
    batch.process_input(args, LOG)
    assert groups == [["a", "c"], ["b", "e"]]
    # the leftover of the 320x240 group goes through the per-file path
    assert stages == [("detect_track_stabilize", root / "v" / "d.mp4")]


def test_lockstep_prepass_falls_back_on_error(lockstep, stages, monkeypatch):
    root, model, groups = lockstep

    def fail(files, args, config, logger):
        raise RuntimeError("video group ragged at the first frame")

    monkeypatch.setattr(teb, "extract_videos_batch", fail)
    args = make_args(input=root, no_geo=True, parallel_videos=2, model=[str(model)])
    batch.process_input(args, LOG)
    assert [s[1].stem for s in stages] == ["a", "b", "c", "d", "e"]


# ------------------------------------------------------------------ config

def _config_run(module, argv, monkeypatch, capsys) -> tuple:
    monkeypatch.setattr(sys, "argv", ["geotrax config"] + argv)
    code = module.main(argv) if module is config_cmd else module.main()
    out = capsys.readouterr()
    return code, out.out, out.err


@pytest.mark.parametrize("argv", [["show"], ["show", "default"], ["show", "stable"], []])
def test_config_show_prints_the_references_output(monkeypatch, capsys, argv):
    j = _config_run(jconfig, argv, monkeypatch, capsys)
    t = _config_run(config_cmd, argv, monkeypatch, capsys)
    strip = lambda out: out.replace(str(jconfig.CFG_DIR), "<cfg>").replace(  # noqa: E731
        str(CFG_DIR), "<cfg>").replace("python -m geotrax_tpu_torch config", "geotrax config")
    assert t[0] == j[0] == 0
    assert strip(t[1]) == strip(j[1])


def test_config_copy_copies_the_references_presets(tmp_path, monkeypatch, capsys):
    for module, dest in ((jconfig, tmp_path / "jax"), (config_cmd, tmp_path / "port")):
        dest.mkdir()
        for argv in (["copy", "lenient", "--dest", str(dest)], ["copy", "--dest", str(dest)]):
            code, out, _ = _config_run(module, argv, monkeypatch, capsys)
            assert code == 0 and "_copy.yaml" in out
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir()) and len(names) == 4
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
