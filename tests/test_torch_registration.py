"""The port's registration helper (geotrax_tpu_torch/utils/registration.py)
against the JAX package's: the retry that halves max_features while the
fit fails and the budget is above 10000, and the warnings for the
reference's inert OpenCV options. The Stabilizer is replaced by a recorder
in both packages, so only the helper's own logic runs."""

import logging

import numpy as np
import pytest

import geotrax_tpu.utils.registration as jreg
import geotrax_tpu_torch.utils.registration as treg

H = np.array([[1.0, 0.01, 3.0], [-0.01, 1.0, -2.0], [0.0, 0.0, 1.0]])


class Recorder:
    """A Stabilizer that fails (``fail`` times, or always) and records the
    budgets it was built with."""

    budgets: list = []
    fail = None
    raise_at = ()

    def __init__(self, max_features, **kwargs):
        self.max_features = max_features
        self.kwargs = kwargs
        Recorder.budgets.append(max_features)

    def set_ref_frame(self, frame):
        self.ref = frame

    def stabilize(self, frame):
        if len(Recorder.budgets) in Recorder.raise_at:
            raise RuntimeError("out of memory")

    def get_cur_trans_matrix(self):
        n = len(Recorder.budgets)
        return None if Recorder.fail is None or n <= Recorder.fail else H

    def get_cur_inliers_count(self):
        return 77

    def get_cur_num_matches(self):
        return 99

    def get_cur_num_keypoints(self):
        return (1000, 900)  # (reference = dst, current = src)


def run(module, monkeypatch, caplog, fail, raise_at=(), **kw):
    Recorder.budgets, Recorder.fail, Recorder.raise_at = [], fail, raise_at
    monkeypatch.setattr(module, "Stabilizer", Recorder)
    img = np.zeros((8, 8, 3), np.uint8)
    logger = logging.getLogger(f"test-registration-{module.__name__}")
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger=logger.name):
        out = module.estimate_homography(img, img, logger, max_features=40000, **kw)
    return out, list(Recorder.budgets), [r.getMessage() for r in caplog.records]


@pytest.mark.parametrize("fail,raise_at", [(None, ()), (1, ()), (2, (1,)), (0, ())])
def test_retry_halves_the_budget(monkeypatch, caplog, fail, raise_at):
    """Always failing: 40000, 20000, 10000, then (None, 0, 0, (0, 0));
    failing once (by a None fit or an exception): the second budget's fit."""
    ref, ref_budgets, ref_log = run(jreg, monkeypatch, caplog, fail, raise_at)
    out, budgets, log = run(treg, monkeypatch, caplog, fail, raise_at, device="cpu")
    assert budgets == ref_budgets
    assert len(log) == len(ref_log)
    if fail is None:
        assert budgets == [40000, 20000, 10000] and out == (None, 0, 0, (0, 0)) == ref
    else:
        assert budgets == [40000, 20000, 10000][:fail + 1]
        assert out[0] is H and out[1:] == ref[1:] == (77, 99, (900, 1000))


def test_inert_options_warn(monkeypatch, caplog):
    """Each reference option that has one implementation here warns by
    name when it is not its default; the defaults stay silent."""
    inert = dict(matcher_name="flann", filter_type="distance",
                 sift_enable_precise_upscale=False, ransac_method=8,
                 ransac_confidence=0.99, rsift_eps=1e-6)
    _, _, quiet = run(treg, monkeypatch, caplog, 0, device="cpu")
    assert quiet == []
    _, _, ref_log = run(jreg, monkeypatch, caplog, 0, **inert)
    out, _, log = run(treg, monkeypatch, caplog, 0, device="cpu", **inert)
    assert len(log) == len(ref_log) == len(inert)
    for name, line in zip(inert, log):
        assert f"'{name}={inert[name]}'" in line and "no effect" in line
    assert out[0] is H


def test_stabilizer_settings(monkeypatch, caplog):
    """The helper's Stabilizer: dst as reference, no downsampling or mask,
    projective, the budget once (ref_multiplier 1), on the given device."""
    built = []

    class Spy(Recorder):
        def __init__(self, max_features, **kwargs):
            super().__init__(max_features, **kwargs)
            built.append(kwargs)

    Recorder.budgets, Recorder.fail, Recorder.raise_at = [], 0, ()
    monkeypatch.setattr(treg, "Stabilizer", Spy)
    treg.estimate_homography(np.zeros((4, 4, 3), np.uint8), np.ones((4, 4, 3), np.uint8),
                             logging.getLogger("t"), device="cpu")
    assert built == [dict(downsample_ratio=1.0, ref_multiplier=1.0, filter_ratio=0.55,
                          transformation_type="projective", ransac_epipolar_threshold=3.0,
                          ransac_max_iter=10000, mask_use=False, clahe=False,
                          detector_name="rsift", device="cpu")]
    assert Recorder.budgets == [250000]
