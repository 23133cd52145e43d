"""The port's post-processing (``pipeline/postprocess.py``) against the
reference's, function by function, on seeded track tables (12-column
stabilized rows and 8-column rows): short tracks, a class tie, tracks that
move along and across the cardinal directions, stationary tracks (the
``tau_c`` fallback, for a known and an unknown class), a track that leaves
the frame (the ``eps`` filter), and gaps of 1, 2, 3 and more than
``max_gap`` frames. Outputs are compared exactly, NaN in the same places."""

import logging

import numpy as np
import pytest

from geotrax_tpu.pipeline import postprocess as ref
from geotrax_tpu_torch import cfg as tcfg
from geotrax_tpu_torch.pipeline import postprocess as port

FRAME_W, FRAME_H = 640, 480
DIMS = tcfg.DEFAULT["extraction"]["dimension_estimation"]
LOG = logging.getLogger("test-torch-postprocess")


def track(tid, frames, xy0, vxy, wh, cls, rng, jitter=0.3):
    """Rows of one track: frame, id, box, stabilized box (the box shifted by
    a small drift), class, score."""
    frames = np.asarray(frames, float)
    t = frames - frames[0]
    cx = xy0[0] + vxy[0] * t + rng.normal(0, jitter, len(t))
    cy = xy0[1] + vxy[1] * t + rng.normal(0, jitter, len(t))
    w = wh[0] + rng.normal(0, 0.5, len(t))
    h = wh[1] + rng.normal(0, 0.5, len(t))
    box = np.column_stack([cx, cy, w, h])
    stab = box + np.array([0.2, -0.1, 0.0, 0.0]) * t[:, None]
    classes = np.asarray(cls, float) * np.ones(len(t))
    scores = rng.uniform(0.3, 0.95, len(t))
    return np.column_stack([frames, np.full(len(t), tid, float), box, stab, classes, scores])


@pytest.fixture(scope="module")
def table():
    rng = np.random.default_rng(0)
    parts = [
        track(1, range(0, 40), (50, 100), (4.0, 0.1), (30, 12), 0, rng),    # east
        track(2, range(0, 40), (300, 60), (0.2, 3.5), (12, 28), 1, rng),    # south
        track(3, range(5, 35), (100, 300), (3.0, 3.0), (20, 20), 2, rng),   # diagonal
        track(4, range(0, 30), (400, 400), (0.0, 0.0), (36, 14), 3, rng),   # stationary
        track(5, range(0, 25), (200, 200), (0.0, 0.0), (15, 14), 7, rng),   # stationary, class 7
        track(6, range(0, 30), (560, 240), (3.0, 0.0), (40, 16), 0, rng),   # leaves the frame
        track(7, range(0, 2), (100, 100), (1.0, 0.0), (10, 5), 1, rng),     # short
        track(8, [3], (120, 100), (1.0, 0.0), (10, 5), 1, rng),             # shorter
        track(9, range(10, 13), (50, 400), (2.0, 0.0), (10, 5), 2, rng),    # exactly 3 rows
        track(10, range(0, 20), (2, 2), (0.0, 0.0), (8, 8), 0, rng),        # never visible
    ]
    rows = np.concatenate(parts)
    # a class tie on track 1 (two classes with equal confidence totals) and
    # mixed classes on track 2
    t1 = np.nonzero(rows[:, 1] == 1)[0]
    rows[t1, 10] = np.where(np.arange(len(t1)) % 2 == 0, 2.0, 1.0)
    rows[t1, 11] = 0.5
    t2 = np.nonzero(rows[:, 1] == 2)[0]
    rows[t2[:5], 10] = 3.0
    # gaps: track 1 loses frames 10 (gap 2) and 20-21 (gap 3); track 2
    # loses 5-36 (a gap of 33, more than max_gap)
    drop = ((rows[:, 1] == 1) & np.isin(rows[:, 0], [10, 20, 21])) | (
        (rows[:, 1] == 2) & (rows[:, 0] >= 5) & (rows[:, 0] < 37))
    rows = rows[~drop]
    return rows[rng.permutation(len(rows))]


def same(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


def test_remove_short_tracks(table):
    for min_length in (1, 2, 3, 4):
        same(port.remove_short_tracks(table, min_length, LOG),
             ref.remove_short_tracks(table, min_length, LOG))
    out = port.remove_short_tracks(table, 3)
    assert {7, 8}.isdisjoint(out[:, 1]) and 9 in out[:, 1]
    empty = np.empty((0, 12))
    same(port.remove_short_tracks(empty, 3), ref.remove_short_tracks(empty, 3))


def test_vote_track_classes(table):
    out = port.vote_track_classes(table)
    same(out, ref.vote_track_classes(table))
    assert (out[out[:, 1] == 1, 10] == 1.0).all()  # the tie goes to the lower class id
    assert len(np.unique(out[out[:, 1] == 2, 10])) == 1 < len(np.unique(table[table[:, 1] == 2, 10]))


@pytest.mark.parametrize("cols", [12, 8])
def test_estimate_vehicle_dimensions(table, cols):
    rows = table if cols == 12 else table[:, [0, 1, 2, 3, 4, 5, 10, 11]]
    out = port.estimate_vehicle_dimensions(rows, DIMS, FRAME_W, FRAME_H)
    same(out, ref.estimate_vehicle_dimensions(rows, DIMS, FRAME_W, FRAME_H))
    assert out.shape[1] == cols + 2
    dims = {int(t): out[out[:, 1] == t, -2:][0] for t in np.unique(out[:, 1])}
    assert np.isnan(dims[10]).all()                # never inside the eps margin
    assert not np.isnan(dims[1]).any() and not np.isnan(dims[4]).any()
    assert dims[1][0] > dims[1][1]                 # length >= width
    # class 7 took tau_c[-1] above; without a -1 entry it takes the fixed 1.7
    unknown = {**DIMS, "tau_c": {k: v for k, v in DIMS["tau_c"].items() if k != -1}}
    same(port.estimate_vehicle_dimensions(rows, unknown, FRAME_W, FRAME_H),
         ref.estimate_vehicle_dimensions(rows, unknown, FRAME_W, FRAME_H))


@pytest.mark.parametrize("max_gap", [1, 2, 3, 30])
def test_interpolate_tracks(table, max_gap):
    rows = port.estimate_vehicle_dimensions(port.vote_track_classes(table), DIMS, FRAME_W, FRAME_H)
    out = port.interpolate_tracks(rows, max_gap, LOG)
    same(out, ref.interpolate_tracks(rows, max_gap, LOG))
    filled = out[out[:, -1] == 1]
    expected = {1: 0, 2: 1, 3: 3, 30: 3}[max_gap]  # gap 2 adds 1 row, gap 3 adds 2
    assert len(filled) == expected
    assert not (filled[:, 1] == 2).any()            # a gap over max_gap stays open
    empty = np.empty((0, 14))
    same(port.interpolate_tracks(empty, max_gap), ref.interpolate_tracks(empty, max_gap))


def test_the_extract_order(table):
    """The four steps in run_extraction's order, as extract applies them."""
    def chain(mod):
        t = mod.remove_short_tracks(table, 3)
        t = mod.vote_track_classes(t)
        t = mod.estimate_vehicle_dimensions(t, DIMS, FRAME_W, FRAME_H)
        return mod.interpolate_tracks(t, 30)
    same(chain(port), chain(ref))
