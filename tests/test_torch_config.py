"""The port's configuration layer (geotrax_tpu_torch/utils/config_utils.py)
against the reference's (geotrax_tpu/utils/config_utils.py), exactly:
``load_config_all`` and the backfill of the CLI arguments for each of the
four presets, by name and by path, with and without the CLI overrides of
``--conf``/``--classes``/``--tiles`` and ``--class-names``; a local
``--model`` resolves to the same file with the same class names; an
``hf://`` reference without ``huggingface_hub`` logs a critical error and
exits 1 in both; so do a missing config file and an unknown tracker. The
output paths of utils/file_utils.py equal the reference's too."""

import argparse
import logging
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from geotrax_tpu.utils import config_utils as jcu
from geotrax_tpu.utils import file_utils as jfu
from geotrax_tpu_torch.models import convert, yolov8
from geotrax_tpu_torch.utils import config_utils as tcu
from geotrax_tpu_torch.utils import file_utils as tfu

LOG = logging.getLogger("test-torch-config")
NAMES = {0: "car", 1: "bus", 2: "truck", 3: "motorcycle"}
OVERRIDES = {
    "none": {},
    "cli": {"conf": 0.4, "classes": [0, 2], "tiles": 2, "class_names": ["0=auto", "1=coach"]},
}


@pytest.fixture(scope="module")
def model_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("config") / "tiny.npz"
    model = yolov8.init_params(torch.Generator().manual_seed(0), yolov8.ModelSpec("n", 4), device="cpu")
    convert.save_npz(path, model, class_names=NAMES)
    return path


def make_args(cfg, model, **overrides):
    args = argparse.Namespace(source=Path("V.mp4"), cfg=cfg, output_folder=None, log_path=None,
                              verbose=False, model=[str(model)], class_names=None, conf=None,
                              classes=None, cut_frame_left=None, cut_frame_right=None, tiles=None,
                              interpolate=None, profile=None)
    for key, value in overrides.items():
        setattr(args, key, value)
    return args


def load_both(cfg, model, **overrides):
    out = []
    for cu in (jcu, tcu):
        args = make_args(cfg, model, **overrides)
        config = cu.load_config_all(args, LOG, needs_model=True)
        main = config["main"]
        cu.backfill_args_from_config(args, {
            "cut_frame_left": main["processing"]["cut_frame_left"],
            "cut_frame_right": main["processing"]["cut_frame_right"],
            "interpolate": main["extraction"]["interpolate"],
            "output_folder": main["output"]["folder"],
        })
        assert main.pop("args") is args
        out.append((config, vars(args)))
    return out


@pytest.mark.parametrize("override", list(OVERRIDES))
@pytest.mark.parametrize("preset", ["default", "confident", "lenient", "stable"])
def test_load_config_all_and_backfill_equal_the_references(model_file, preset, override):
    (j_cfg, j_args), (t_cfg, t_args) = load_both(preset, model_file, **OVERRIDES[override])
    assert t_cfg == j_cfg
    assert t_args == j_args
    assert t_cfg["ultralytics"]["model"] == str(model_file)
    if override == "cli":
        assert t_cfg["ultralytics"]["conf"] == 0.4 and t_cfg["ultralytics"]["tiles"] == 2
        assert t_cfg["main"]["class_names"] == {0: "auto", 1: "coach"}
    else:
        assert t_cfg["main"]["class_names"] == NAMES
        assert t_cfg["main"]["class_names_source"] == "model"


@pytest.mark.parametrize("spelling", ["stable.yaml", "cfg/stable.yaml", "path"])
def test_config_spellings_resolve_alike(model_file, spelling):
    cfg = str(Path(tcu.CFG_DIR) / "stable.yaml") if spelling == "path" else spelling
    (j_cfg, _), (t_cfg, _) = load_both(cfg, model_file)
    assert t_cfg == j_cfg and t_cfg["stabilo"]["clahe"] is True


def test_local_model_resolves(model_file, monkeypatch):
    assert tcu.resolve_model_path(str(model_file), LOG) == jcu.resolve_model_path(str(model_file), LOG)
    assert tcu.resolve_model_path(f"hf download {model_file}", LOG) == model_file
    monkeypatch.chdir(model_file.parent)
    assert tcu.resolve_model_path("tiny.npz", LOG) == Path("tiny.npz")


@pytest.mark.parametrize("case", ["hf_without_hub", "missing_cfg", "unknown_tracker"])
def test_terminal_errors_exit_1_like_the_reference(model_file, tmp_path, monkeypatch, case):
    if case == "hf_without_hub":
        monkeypatch.setitem(sys.modules, "huggingface_hub", None)  # the import fails
        calls = [lambda cu: cu.resolve_model_path("hf://rfonod/geo-trax/x.pt", LOG)]
    elif case == "missing_cfg":
        calls = [lambda cu: cu.load_config_all(make_args(str(tmp_path / "nope.yaml"), model_file), LOG)]
    else:
        bad = tmp_path / "bad.yaml"
        bad.write_text("tracker:\n  active: sort\n")
        calls = [lambda cu: cu.load_config_all(make_args(str(bad), model_file), LOG)]
    for cu in (jcu, tcu):
        with pytest.raises(SystemExit) as exc:
            calls[0](cu)
        assert exc.value.code == 1


@pytest.mark.parametrize("result_type", ["processed", "video_transformations", "georeferenced",
                                         "visualized", "video"])
@pytest.mark.parametrize("folder", ["results", "/abs/out"])
def test_result_paths_equal_the_references(tmp_path, result_type, folder):
    source = tmp_path / "site" / "A_clip.mp4"
    out_cfg = {**tfu.DEFAULT_OUTPUT, "folder": folder, "tracks_postfix": "_t"}
    assert tfu.get_output_dir(source, out_cfg) == jfu.get_output_dir(source, out_cfg)
    assert tfu.build_result_path(source, result_type, out_cfg, 2, "mp4") == jfu.build_result_path(
        source, result_type, out_cfg, 2, "mp4")
    assert tfu.check_if_results_exist(source, result_type, 2, "mp4", out_cfg) == \
        jfu.check_if_results_exist(source, result_type, 2, "mp4", out_cfg)
    args = argparse.Namespace(source=source, model=["m.npz"], conf=np.float64(0.5).item())
    assert tfu.convert_to_serializable(args) == jfu.convert_to_serializable(args)
