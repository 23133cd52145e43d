"""The files the port's ``extract`` writes against the files the reference's
``geotrax extract`` writes (``_extract_impl.run_extraction``), on the same
clip: the SyntheticVideoReader's 320x240 scene over 20 frames, with an
oracle detector that alternates each box's class (a class vote with a tie)
and misses frames 7 and 8 (gaps to interpolate), patched into the reference
as tests/test_extract.py patches it. Both run their default RANSAC draw (no
injected sampler), chunks of 8 frames and the default configuration with
``max_det: 256`` (256 tracker slots, to keep the reference's compile short),
with ``interpolate`` off and on.

Held equal: the column count (14, 15 with interpolate), frames, track ids,
voted classes, scores and the interpolation flag. Boxes, stabilized boxes
and dimensions agree within BOX_ATOL px (NaN in the same places);
homographies within the tolerances of tests/test_torch_pipeline.py for the
reference's float32 eigensolve (LIN_TOL_F32, TRANS_TOL). The metadata files
parse to equal documents apart from the run's times and the package
version."""

import argparse
import copy
import logging

import numpy as np
import pytest
import yaml

from geotrax_tpu.io.video import SyntheticVideoReader as JaxReader
from geotrax_tpu.models.detector import OracleDetector as JaxOracle
from geotrax_tpu.pipeline import _extract_impl
from geotrax_tpu.utils.config_utils import load_config
from geotrax_tpu_torch import cfg as tcfg
from geotrax_tpu_torch.io.synthetic import SyntheticVideoReader
from geotrax_tpu_torch.models.detector import OracleDetector
from geotrax_tpu_torch.pipeline import extract as textract

CHUNK = 8
MAX_DET = 256
DROP = (7, 8)
BOX_ATOL = 0.05
LIN_TOL_F32 = 5e-4
TRANS_TOL = 0.05
TIMING = ("avg_detect_ms", "avg_stabilization_ms", "pipeline_fps")


def boxes_fn(reader):
    return lambda idx: [] if idx in DROP else [list(b) + [0.9, idx % 2] for b in reader.boxes_at(idx)]


def read_files(source):
    out = source.parent / "results"
    return (np.loadtxt(out / f"{source.stem}.txt", delimiter=","),
            np.loadtxt(out / f"{source.stem}_vid_transf.txt", delimiter=","),
            yaml.safe_load(source.with_suffix(".yaml").read_text()))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{interpolate: (reference files, port files)} for one source path:
    the reference writes first, its files are read, then the port writes
    the same paths with the reference's arguments. The reference tracks the
    clip once: the run with interpolate on replays the first run's
    track_video output, so that only its post-processing and writing run
    again (the clip's tracking does not depend on that flag)."""
    tmp = tmp_path_factory.mktemp("extract_file")
    cfg_file = tmp / "cfg.yaml"
    full = load_config("default", None)
    full["ultralytics"]["max_det"] = MAX_DET
    cfg_file.write_text(yaml.safe_dump(full, sort_keys=False))
    dummy_model = tmp / "unused.npz"
    np.savez(dummy_model, **{"param:none": np.zeros(1)})
    source = tmp / "V_test.mp4"
    source.write_bytes(b"placeholder")  # never decoded: the readers are synthetic

    port_config = copy.deepcopy(tcfg.DEFAULT)
    port_config["ultralytics"]["max_det"] = MAX_DET

    mp = pytest.MonkeyPatch()
    mp.setattr(_extract_impl, "FUSED_CHUNK", CHUNK)
    mp.setattr(_extract_impl, "load_detector",
               lambda cfg, log: JaxOracle(boxes_fn(JaxReader(width=320, height=240, n_frames=20))))
    mp.setattr(_extract_impl, "open_reader",
               lambda src, start, stop, cfg: JaxReader(width=320, height=240, n_frames=20))
    tracked = []
    track_video = _extract_impl.track_video

    def track_once(args, config, logger):
        if not tracked:
            tracked.append(track_video(args, config, logger))
        return tracked[0]

    mp.setattr(_extract_impl, "track_video", track_once)
    results = {}
    try:
        for interpolate in (False, True):
            args = argparse.Namespace(
                source=source, cfg=str(cfg_file), output_folder=None, log_path=None,
                verbose=False, model=[str(dummy_model)], class_names=["0=car"], conf=None,
                classes=None, cut_frame_left=None, cut_frame_right=None,
                interpolate=interpolate, show=None,
            )
            _extract_impl.run_extraction(args, logging.getLogger("test-torch-extract-file"))
            ref = read_files(source)

            reader = SyntheticVideoReader(width=320, height=240, n_frames=20)
            det = OracleDetector(boxes_fn(reader), device="cpu")
            tracker_cfg, state, step, head = textract.make_extract_tracker(port_config, device="cpu")
            fx = textract.make_fused_extractor(port_config, det, tracker_cfg, state, step, 240, 320,
                                               head, chunk=CHUNK, device="cpu")
            stats = textract.extract(reader, fx, source.parent / "results", source.stem,
                                     config=port_config, chunk=CHUNK, source=source,
                                     args=vars(args))
            results[interpolate] = (ref, read_files(source), stats)
    finally:
        mp.undo()
    return results


@pytest.mark.parametrize("interpolate", [False, True])
def test_tracks_file_equals_the_references(runs, interpolate):
    (j_tracks, j_transf, _), (t_tracks, t_transf, _), stats = runs[interpolate]
    cols = 15 if interpolate else 14
    assert t_tracks.shape == j_tracks.shape and t_tracks.shape[1] == cols
    assert stats["n_rows"] == len(t_tracks) and stats["n_rows_raw"] > 30
    exact = [0, 1, 10, 11] + ([14] if interpolate else [])
    np.testing.assert_array_equal(t_tracks[:, exact], j_tracks[:, exact])
    np.testing.assert_allclose(t_tracks[:, 2:10], j_tracks[:, 2:10], rtol=1e-5, atol=BOX_ATOL)
    np.testing.assert_allclose(t_tracks[:, 12:14], j_tracks[:, 12:14], rtol=1e-5, atol=BOX_ATOL)
    assert np.isfinite(t_tracks[:, 12:14]).any()
    assert set(t_tracks[:, 10]) == {0.0}  # each track's classes tie 10:10 -> the lower id
    if interpolate:
        filled = t_tracks[t_tracks[:, 14] == 1]
        assert len(filled) == 4 and set(filled[:, 0]) == set(DROP)
    else:
        assert not np.isin(t_tracks[:, 0], DROP).any()
    assert t_transf.shape == j_transf.shape == (19, 10)
    np.testing.assert_array_equal(t_transf[:, 0], j_transf[:, 0])
    t_h, j_h = t_transf[:, 1:].reshape(-1, 3, 3), j_transf[:, 1:].reshape(-1, 3, 3)
    np.testing.assert_allclose(t_h[:, :2, :2], j_h[:, :2, :2], rtol=0, atol=LIN_TOL_F32)
    np.testing.assert_allclose(t_h[:, 2, :2], j_h[:, 2, :2], rtol=0, atol=LIN_TOL_F32)
    np.testing.assert_allclose(t_h[:, :2, 2], j_h[:, :2, 2], rtol=0, atol=TRANS_TOL)


@pytest.mark.parametrize("interpolate", [False, True])
def test_metadata_file_equals_the_references(runs, interpolate):
    (_, _, j_meta), (_, _, t_meta), _ = runs[interpolate]
    assert list(t_meta) == list(j_meta) == ["geotrax_tpu_version", "video", "runtime", "config",
                                            "args"]
    for meta in (t_meta, j_meta):
        meta.pop("geotrax_tpu_version")
        for key in TIMING:
            assert isinstance(meta["runtime"].pop(key), float)
    assert t_meta == j_meta
    assert t_meta["args"]["interpolate"] is interpolate
    assert t_meta["config"]["detection"]["max_det"] == MAX_DET
    assert t_meta["runtime"]["extraction_mode"] == "sequential"
