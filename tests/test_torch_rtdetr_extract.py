"""``extract`` with RT-DETR checkpoints (those of tests/test_torch_rtdetr.py's
fixtures: a seeded native ``.npz`` and a random full-width rtdetr-l
``.pt``) on the clip of tests/test_torch_cli.py:

- the native ``.npz`` through both packages' ``run_extraction`` (the
  sequential loop, one frame at a time), with stabilization on and off:
  every tracker step is given the same frame id, the same detections (as
  tests/test_torch_rtdetr.py holds ``Detector``) and the same GMC (within
  GMC_TOL; the identity in both with stabilization off), and the files
  have the same columns and metadata. The tracks themselves are not
  compared: the random detector's 30 overlapping boxes per frame put the
  tracker's assignments on near-ties that the detections' last bits
  decide (the tracker is held to the reference on separated inputs in
  tests/test_torch_tracker.py and tests/test_torch_sequential.py);
- ``python -m geotrax_tpu_torch extract`` with the rtdetr-l ``.pt`` on the
  CPU: the three files, 16 frames, the 14-column tracks table."""

import os
import subprocess
import sys

import numpy as np
import pytest

from geotrax_tpu_torch.pipeline import extract as textract
from test_torch_cli import ROOT, make_assets, patched, preset_copy, read_files, run_pair  # noqa: F401
from test_torch_rtdetr import PROB_TOL, assert_same_boxes, checkpoints  # noqa: F401

GMC_TOL = 1e-5
STAB_OFF = {"  stabilize: true        # append stabilized box columns to the tracks file\n":
            "  stabilize: false\n"}


@pytest.fixture(scope="module")
def assets(tmp_path_factory, checkpoints):
    out = make_assets(tmp_path_factory.mktemp("rtdetr_cli"))
    out["model"] = checkpoints["npz"]
    return out


def recording(module, seen: list):
    """``module.make_extract_tracker`` with its step recording the host
    copies of what each step is given."""
    make = module.make_extract_tracker

    def make_recording(*args, **kwargs):
        cfg, state, step, head = make(*args, **kwargs)

        def step_recording(st, boxes, scores, cls, valid, fid, gmc_h=None, det_emb=None):
            seen.append({"boxes_xywh": np.asarray(boxes), "scores": np.asarray(scores),
                         "classes": np.asarray(cls), "valid": np.asarray(valid), "fid": int(fid),
                         "gmc": None if gmc_h is None else np.asarray(gmc_h)})
            return step(st, boxes, scores, cls, valid, fid, gmc_h, det_emb)

        return cfg, state, step_recording, head

    return make_recording


@pytest.mark.parametrize("stabilize", [True, False])
def test_extract_with_native_rtdetr_feeds_the_tracker_as_the_reference(assets, patched,
                                                                       stabilize):
    from geotrax_tpu.pipeline import _extract_impl

    cfg = preset_copy(assets["tmp"] / f"rtdetr_{stabilize}.yaml", "default",
                      **{"  imgsz: 1920\n": "  imgsz: 96\n"}, **({} if stabilize else STAB_OFF))
    seen = {"ref": [], "port": []}
    mp = pytest.MonkeyPatch()
    mp.setattr(_extract_impl, "make_extract_tracker", recording(_extract_impl, seen["ref"]))
    mp.setattr(textract, "make_extract_tracker", recording(textract, seen["port"]))
    try:
        ref, port = run_pair(assets, cfg)
    finally:
        mp.undo()
    assert len(seen["ref"]) == len(seen["port"]) == 16
    for want, got in zip(seen["ref"], seen["port"]):
        assert got["fid"] == want["fid"]
        for key in ("valid", "classes"):
            np.testing.assert_array_equal(got[key], want[key])
        np.testing.assert_allclose(got["scores"], want["scores"], rtol=0, atol=PROB_TOL)
        assert_same_boxes(got, want)
        if want["gmc"] is None:
            assert got["gmc"] is None
        else:
            np.testing.assert_allclose(got["gmc"], want["gmc"], rtol=0, atol=GMC_TOL)
            if not stabilize:
                np.testing.assert_array_equal(got["gmc"], np.eye(3, dtype=np.float32))
    (j_tracks, j_transf, j_meta), (t_tracks, t_transf, t_meta) = ref, port
    assert t_tracks.shape[1] == j_tracks.shape[1] == (14 if stabilize else 10)
    assert (t_transf is None) == (j_transf is None) == (not stabilize)
    assert t_meta["args"].pop("device") == "cpu"
    for meta in (t_meta, j_meta):
        meta.pop("geotrax_tpu_version")
        for key in ("avg_detect_ms", "avg_stabilization_ms", "pipeline_fps"):
            meta["runtime"].pop(key)
    assert t_meta == j_meta and t_meta["config"]["model"].endswith("rtdetr_n.npz")


def test_module_cli_runs_rtdetr_l_on_the_cpu(assets, checkpoints):
    cfg = preset_copy(assets["tmp"] / "rtdetr_l.yaml", "default",
                      **{"  imgsz: 1920\n": "  imgsz: 128\n"})
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    proc = subprocess.run(
        [sys.executable, "-m", "geotrax_tpu_torch", "extract", str(assets["clip"]), "-m",
         str(checkpoints["pt"]), "-c", str(cfg), "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "ultralytics rtdetr-l nc=4" in proc.stderr + proc.stdout
    tracks, transf, meta = read_files(assets["clip"])
    assert tracks.shape[1] == 14 and np.isfinite(tracks[:, :12]).all()
    assert transf.shape == (15, 10) and meta["video"]["frames_processed"] == 16
    assert meta["config"]["model"] == str(checkpoints["pt"])
