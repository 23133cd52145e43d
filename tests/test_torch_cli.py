"""`extract` end to end: the port's ``run_extraction`` and
``python -m geotrax_tpu_torch extract ... --device cpu`` against the
reference's ``run_extraction`` on the same clip and checkpoint.

The clip is the SyntheticVideoReader scene (256x160, 16 frames, its two
moving rectangles, a static camera as in tests/test_torch_extract_file.py)
written as a raw ``.y4m`` (chip_smoke.write_y4m) and read by each
package's own native decoder. The checkpoint is a seeded YOLOv8n
saved by the port as ``.npz`` (the ``.pt`` is held in
tests/test_torch_convert.py), its head sharpened so that a few percent of
the anchors pass ``conf`` with boxes about a stride wide. The
configuration is a user's copy of the ``default`` preset with ``imgsz``
128 and ``max_det`` 64. Both run chunks of 8 frames in process (the
subprocess runs the port's 32), and each writes the files to the same
paths in turn; the reference solves RANSAC's 9x9 normal equations in
float64 as the port does (ROADMAP C3), as tests/test_torch_pipeline.py
runs it for a moving camera. Torch runs on two threads here, so that the
suite's workers do not crowd each other out. Held:

- the tracks file: equal shape, frames, ids and classes; scores within
  rtol 1e-5 (the detector's float32 convolutions sum in another order);
  boxes, stabilized boxes and dimensions within BOX_ATOL px (NaN in the
  same places);
- the transforms file: equal frames, homographies within LIN_TOL in the
  linear and perspective entries and TRANS_TOL px in translation;
- the metadata: equal documents apart from the times, the version and the
  port's ``--device`` argument.

For the default configuration, with ``--interpolate`` (the tracking of
the default run replayed in both packages: the flag changes only the
post-processing) and with ``--cut-frame-left 3 --cut-frame-right 13``;
the ``stable`` preset and
stabilization off are in tests/test_torch_cli_options.py. The
double-buffered driver's rows equal the serial loop's bit for bit."""

import argparse
import copy
import logging
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import chip_smoke
import jax
from geotrax_tpu.ops import ransac as jr
from geotrax_tpu.pipeline import _extract_impl
from geotrax_tpu_torch.io.synthetic import SyntheticVideoReader
from geotrax_tpu_torch.models import convert, yolov8
from geotrax_tpu_torch.pipeline import extract as textract
from geotrax_tpu_torch.utils.config_utils import load_config_all
from test_torch_pipeline import fit_homography_normal_eigh64

ROOT = Path(__file__).resolve().parent.parent
CHUNK = 8
BOX_ATOL = 0.05
LIN_TOL = 1e-4
TRANS_TOL = 0.05
TIMING = ("avg_detect_ms", "avg_stabilization_ms", "pipeline_fps")
LOG = logging.getLogger("test-torch-cli")


def sharpened_model(seed=0):
    """A seeded YOLOv8n whose class scores spread over (0, 1), a few percent
    of anchors above the preset's conf 0.25, with boxes about one stride
    wide."""
    spec = yolov8.ModelSpec(variant="n", nc=4)
    model = yolov8.init_params(torch.Generator().manual_seed(seed), spec, device="cpu")
    head = model.layers[str(spec.head_index)]
    with torch.no_grad():
        for k in range(len(spec.strides)):
            head.cv3[k][2].weight *= 100.0
            head.cv3[k][2].bias -= 2.7
            head.cv2[k][2].weight *= 0.05
            b = torch.zeros(4 * spec.reg_max)
            b[0::spec.reg_max] = b[1::spec.reg_max] = 20.0
            head.cv2[k][2].bias.copy_(b)
    return model


def preset_copy(path: Path, preset: str, **edits) -> Path:
    """A user's copy of a preset with lines replaced: {old line: new line}."""
    text = (ROOT / "geotrax_tpu_torch" / "cfg" / f"{preset}.yaml").read_text()
    edits = {"  imgsz: 1920\n": "  imgsz: 128\n", "  max_det: 1000\n": "  max_det: 64\n", **edits}
    for old, new in edits.items():
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    path.write_text(text)
    return path


def make_assets(tmp: Path) -> dict:
    reader = SyntheticVideoReader(width=256, height=160, n_frames=16)
    clip = tmp / "A_clip.y4m"
    chip_smoke.write_y4m(clip, reader, 256, 160)
    model = tmp / "tiny.npz"
    convert.save_npz(model, sharpened_model(), class_names={0: "car", 1: "bus", 2: "truck",
                                                            3: "motorcycle"})
    return {"clip": clip, "model": model, "tmp": tmp}


def cli_args(assets, cfg, **extra):
    args = argparse.Namespace(
        source=assets["clip"], cfg=str(cfg), output_folder=None, log_path=None, verbose=False,
        model=[str(assets["model"])], class_names=None, conf=None, classes=None,
        cut_frame_left=None, cut_frame_right=None, tiles=None, interpolate=None, profile=None)
    for key, value in extra.items():
        setattr(args, key, value)
    return args


def read_files(source: Path, remove: bool = True):
    out = source.parent / "results"
    paths = [out / f"{source.stem}.txt", out / f"{source.stem}_vid_transf.txt",
             source.with_suffix(".yaml")]
    files = (np.loadtxt(paths[0], delimiter=",", ndmin=2),
             np.loadtxt(paths[1], delimiter=",", ndmin=2) if paths[1].exists() else None,
             yaml.safe_load(paths[2].read_text()))
    if remove:
        for p in paths:
            p.unlink(missing_ok=True)
    return files


@pytest.fixture(scope="module")
def patched():
    """Chunks of 8 in both packages, the reference solving RANSAC's 9x9
    normal equations in float64 as the port does (ROADMAP C3), and torch on
    two threads, for the module's runs."""
    mp = pytest.MonkeyPatch()
    mp.setattr(_extract_impl, "FUSED_CHUNK", CHUNK)
    mp.setattr(textract, "FUSED_CHUNK", CHUNK)
    mp.setattr(jr, "fit_homography_normal", fit_homography_normal_eigh64)
    jax.clear_caches()  # retrace ransac_fit with the float64 eigensolve
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield mp
    torch.set_num_threads(threads)
    mp.undo()
    _extract_impl._EXTRACT_CACHE.clear()
    textract._EXTRACT_CACHE.clear()
    jax.clear_caches()


def run_pair(assets, cfg, **extra) -> tuple:
    """(reference files, port files) of one configuration."""
    _extract_impl.run_extraction(cli_args(assets, cfg, **extra), LOG)
    ref = read_files(assets["clip"])
    textract.run_extraction(cli_args(assets, cfg, device="cpu", **extra), LOG)
    return ref, read_files(assets["clip"])


def assert_files_match(ref, port, stabilize=True, interpolate=False):
    (j_tracks, j_transf, j_meta), (t_tracks, t_transf, t_meta) = ref, port
    j_meta, t_meta = copy.deepcopy(j_meta), copy.deepcopy(t_meta)
    cols = (14 if stabilize else 10) + (1 if interpolate else 0)
    assert t_tracks.shape == j_tracks.shape and t_tracks.shape[1] == cols and len(t_tracks) > 20
    cls = cols - (5 if interpolate else 4)
    exact = [0, 1, cls] + ([cols - 1] if interpolate else [])
    np.testing.assert_array_equal(t_tracks[:, exact], j_tracks[:, exact])
    np.testing.assert_allclose(t_tracks[:, cls + 1], j_tracks[:, cls + 1], rtol=1e-5, atol=0)
    geom = list(range(2, cls)) + [cls + 2, cls + 3]
    assert np.array_equal(np.isnan(t_tracks[:, geom]), np.isnan(j_tracks[:, geom]))
    np.testing.assert_allclose(t_tracks[:, geom], j_tracks[:, geom], rtol=1e-5, atol=BOX_ATOL)
    if stabilize:
        assert t_transf.shape == j_transf.shape and len(t_transf) > 5
        np.testing.assert_array_equal(t_transf[:, 0], j_transf[:, 0])
        t_h, j_h = t_transf[:, 1:].reshape(-1, 3, 3), j_transf[:, 1:].reshape(-1, 3, 3)
        np.testing.assert_allclose(t_h[:, :2, :2], j_h[:, :2, :2], rtol=0, atol=LIN_TOL)
        np.testing.assert_allclose(t_h[:, 2, :2], j_h[:, 2, :2], rtol=0, atol=LIN_TOL)
        np.testing.assert_allclose(t_h[:, :2, 2], j_h[:, :2, 2], rtol=0, atol=TRANS_TOL)
    else:
        assert t_transf is None and j_transf is None
    assert t_meta["args"].pop("device") == "cpu"
    for meta in (t_meta, j_meta):
        meta.pop("geotrax_tpu_version")
        for key in TIMING:
            assert isinstance(meta["runtime"].pop(key), float)
    assert t_meta == j_meta


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    out = make_assets(tmp)
    out["cfg"] = preset_copy(tmp / "default_copy.yaml", "default")
    return out


@pytest.fixture(scope="module")
def default_runs(assets, patched):
    """The reference's and the port's files of the default configuration,
    the subprocess's, and each package's tracking of the clip."""
    tracked = {}
    originals = {name: module.track_video for name, module in (("ref", _extract_impl),
                                                                ("port", textract))}
    for name, module in (("ref", _extract_impl), ("port", textract)):
        def record(*args, _name=name, **kw):
            tracked[_name] = originals[_name](*args, **kw)
            return copy.deepcopy(tracked[_name])
        patched.setattr(module, "track_video", record)
    ref, port = run_pair(assets, assets["cfg"])
    patched.setattr(_extract_impl, "track_video", originals["ref"])
    patched.setattr(textract, "track_video", originals["port"])
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    proc = subprocess.run(
        [sys.executable, "-m", "geotrax_tpu_torch", "extract", str(assets["clip"]), "-m",
         str(assets["model"]), "-c", str(assets["cfg"]), "--device", "cpu", "-lp",
         str(assets["tmp"] / "logs")],
        cwd=ROOT, capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return ref, port, read_files(assets["clip"]), tracked


def test_run_extraction_writes_the_references_files(default_runs):
    ref, port, _, _ = default_runs
    assert_files_match(ref, port)


def test_module_cli_writes_the_references_files(default_runs, assets):
    ref, _, cli, _ = default_runs
    assert cli[2]["args"]["model"] == ref[2]["args"]["model"]
    assert cli[2]["args"]["log_path"] == str(assets["tmp"] / "logs")
    cli[2]["args"]["log_path"] = None
    assert_files_match(ref, cli)


def test_interpolate_writes_the_references_files(default_runs, assets, monkeypatch):
    tracked = default_runs[3]
    for name, module in (("ref", _extract_impl), ("port", textract)):
        monkeypatch.setattr(module, "track_video",
                            lambda *a, _name=name, **k: copy.deepcopy(tracked[_name]))
    ref, port = run_pair(assets, assets["cfg"], interpolate=True)
    assert_files_match(ref, port, interpolate=True)
    assert (port[0][:, 14] == 1).any()


def test_cut_frames_write_the_references_files(default_runs, assets):
    ref, port = run_pair(assets, assets["cfg"], cut_frame_left=3, cut_frame_right=13)
    assert_files_match(ref, port)
    assert port[0][:, 0].min() >= 3 and port[0][:, 0].max() < 13
    assert port[1][0, 0] == 4 and port[1][-1, 0] == 12


def test_double_buffered_rows_equal_the_serial_loops(assets, patched):
    runs = {}
    for pipelined in (True, False, True):
        args = cli_args(assets, assets["cfg"], device="cpu", cut_frame_left=0,
                        cut_frame_right=None)
        config = load_config_all(args, LOG)
        runs.setdefault(pipelined, []).append(
            textract.track_video(args, config, LOG, pipelined=pipelined))
    (a, b), (c,) = runs[True], runs[False]
    assert a[2]["chunks"] == 2 and c[2]["chunks"] == 2
    for run in (a, b):  # the second pipelined run reuses the extractor and its buffers
        np.testing.assert_array_equal(run[0], c[0])
        np.testing.assert_array_equal(run[1], c[1])


@pytest.mark.parametrize("argv,code,text", [
    (["-V"], 0, "geotrax_tpu_torch 0.1.0"),
    (["--help"], 0, "extract"),
    (["batch", "x"], 0, "'x' not found"),
    (["visualize", "--help"], 0, "--viz-mode"),
    (["nope"], 2, "unknown command"),
    (["plot", "--help"], 0, "--plot-save"),
    (["config", "show"], 0, "Available presets"),
])
def test_umbrella_cli_dispatch(capsys, argv, code, text):
    """The seven commands of the reference's usage, all ported: ``visualize``
    and ``plot`` print their help, and ``batch`` under its default gates
    (which run them) gets as far as its input, as the reference's does."""
    from geotrax_tpu_torch import cli

    try:
        rc = cli.main(argv)
    except SystemExit as exc:  # argparse's --help
        rc = exc.code
    assert rc == code
    out = capsys.readouterr()
    assert text in out.out + out.err
    assert list(cli.COMMANDS) == ["batch", "extract", "georeference", "aggregate", "visualize",
                                  "plot", "config"]


def test_profile_writes_a_trace(assets, patched, tmp_path):
    """``--profile DIR``: the extraction under torch.profiler, its chrome
    trace in DIR holding the chunk step's ranges; the files as without."""
    stats = textract.run_extraction(
        cli_args(assets, assets["cfg"], device="cpu", profile=str(tmp_path / "prof")), LOG)
    trace = (tmp_path / "prof" / "extract_trace.json").read_text()
    assert "fx.detect" in trace and "fx.tracker" in trace
    assert stats["n_rows"] > 20 and stats["tracks_file"].exists()
    read_files(assets["clip"])  # removes them for the other tests
