"""The sequential per-frame extract loop (``track_video_sequential``)
against the reference's (``_extract_impl.track_video``'s per-frame loop),
through each package's ``run_extraction``:

- an oracle detector hidden behind ``SequentialOnly`` on the
  SyntheticVideoReader's 320x240 scene over 16 frames, BoT-SORT with ReID
  and GMC, as tests/test_fused_parity.py runs the reference: the port's
  files against the reference's at tests/test_torch_cli.py's tolerances
  (ids, frames and classes equal; boxes within 0.05 px; H within 1e-4 and
  0.05 px, both packages solving RANSAC's refinement in float64, ROADMAP
  C3), and the port's fused path against its sequential loop: every
  column of both files exactly equal;
- the seeded YOLOv8n checkpoint of tests/test_torch_cli.py with a
  ``stabilo.detector_name: rsift`` copy of the default preset (600 features
  per frame): one ``detect_batch`` group of 16 frames, RootSIFT per frame;
  files as above.

The RT-DETR runs through the loop are in tests/test_torch_rtdetr.py."""

import numpy as np
import pytest

from geotrax_tpu.io.video import SyntheticVideoReader as JaxReader
from geotrax_tpu.models.detector import OracleDetector as JaxOracle
from geotrax_tpu.models.detector import SequentialOnly as JaxSequentialOnly
from geotrax_tpu.pipeline import _extract_impl
from geotrax_tpu_torch.io.synthetic import SyntheticVideoReader
from geotrax_tpu_torch.models.detector import Detector, OracleDetector, SequentialOnly
from geotrax_tpu_torch.pipeline import extract as textract
from test_torch_cli import (LOG, assert_files_match, cli_args, make_assets,  # noqa: F401
                            patched, preset_copy, read_files, run_pair)

W, H, N_FRAMES = 320, 240, 16
REID = {"    appearance_thresh: 0.8\n    with_reid: false\n    model: auto\n":
        "    appearance_thresh: 0.8\n    with_reid: true\n    model: auto\n"}
RSIFT = {"  detector_name: 'orb'           # [orb, sift, rsift, brisk, kaze, akaze]\n":
         "  detector_name: rsift\n",
         "  max_features: 2000\n  ref_multiplier": "  max_features: 600\n  ref_multiplier"}


def oracle_boxes(reader):
    return lambda idx: [list(b) + [0.9, 0] for b in reader.boxes_at(idx)]


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sequential")
    out = make_assets(tmp)
    source = tmp / "V_seq.mp4"
    source.write_bytes(b"placeholder")  # never decoded: the readers are synthetic
    out["oracle_source"] = source
    out["reid_cfg"] = preset_copy(tmp / "reid.yaml", "default", **REID)
    return out


@pytest.fixture(scope="module")
def oracle_runs(assets, patched):
    """{name: files} of the reference's sequential loop, the port's
    sequential loop and the port's fused path on the oracle clip."""
    mp = pytest.MonkeyPatch()
    mp.setattr(_extract_impl, "open_reader",
               lambda *a: JaxReader(width=W, height=H, n_frames=N_FRAMES))
    mp.setattr(_extract_impl, "load_detector", lambda cfg, log: JaxSequentialOnly(
        JaxOracle(oracle_boxes(JaxReader(width=W, height=H, n_frames=N_FRAMES)))))
    mp.setattr(textract, "open_reader",
               lambda *a: SyntheticVideoReader(width=W, height=H, n_frames=N_FRAMES))

    def port_oracle(sequential):
        det = OracleDetector(oracle_boxes(SyntheticVideoReader(width=W, height=H,
                                                               n_frames=N_FRAMES)), device="cpu")
        return SequentialOnly(det) if sequential else det

    oracle = {"clip": assets["oracle_source"], "model": assets["model"]}
    runs = {}
    try:
        mp.setattr(textract, "load_detector", lambda cfg, log: port_oracle(True))
        runs["ref_seq"], runs["port_seq"] = run_pair(oracle, assets["reid_cfg"])
        mp.setattr(textract, "load_detector", lambda cfg, log: port_oracle(False))
        textract.run_extraction(cli_args(oracle, assets["reid_cfg"], device="cpu"), LOG)
        runs["port_fused"] = read_files(assets["oracle_source"])
    finally:
        mp.undo()
    return runs


def test_sequential_loop_writes_the_reference_sequentials_files(oracle_runs):
    assert_files_match(oracle_runs["ref_seq"], oracle_runs["port_seq"])
    assert oracle_runs["port_seq"][1].shape == (N_FRAMES - 1, 10)


def test_fused_path_equals_the_sequential_loop(oracle_runs):
    """The reference's own contract (tests/test_fused_parity.py): the same
    per-frame RANSAC keys and the same functions give equal files."""
    (f_tracks, f_transf, _), (s_tracks, s_transf, _) = oracle_runs["port_fused"], \
        oracle_runs["port_seq"]
    assert f_tracks.shape == s_tracks.shape and len(f_tracks) > 20
    np.testing.assert_array_equal(f_tracks, s_tracks)
    np.testing.assert_array_equal(f_transf, s_transf)


def test_rsift_stabilizer_runs_the_loop_as_the_reference(assets, patched):
    cfg = preset_copy(assets["tmp"] / "rsift.yaml", "default", **RSIFT)
    batches = []
    detect_batch = Detector.detect_batch

    def counted(self, frames):
        batches.append(len(frames))
        return detect_batch(self, frames)

    patched.setattr(Detector, "detect_batch", counted)
    ref, port = run_pair(assets, cfg)
    patched.setattr(Detector, "detect_batch", detect_batch)
    assert batches == [N_FRAMES]  # one group, one upload
    assert_files_match(ref, port)
    assert port[2]["config"]["stabilo"]["detector_name"] == "rsift"
