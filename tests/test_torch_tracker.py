"""Trackers of the port against the JAX package: Kalman steps, the auction
and its gated wrapper, a 30-frame ``byte_step`` sequence for botsort (with
camera-motion homographies) and bytetrack, the step sequences of BoT-SORT,
Deep OC-SORT and TrackTrack with ReID embeddings, OC-SORT and FastTracker,
and the crossing-targets scenario of tests/test_reid.py — identical track
ids and validity, boxes within 1e-4."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from geotrax_tpu.ops import assignment as ja
from geotrax_tpu.ops import kalman as jk
from geotrax_tpu.track import base as jb
from geotrax_tpu_torch.ops import assignment as ta
from geotrax_tpu_torch.ops import kalman as tk
from geotrax_tpu_torch.track import base as tb

BOX_ATOL = 1e-4


@pytest.mark.parametrize("fmt", ["xyah", "xywh"])
def test_kalman_steps(fmt):
    rng = np.random.default_rng(0)
    boxes = np.c_[rng.uniform(50, 400, (6, 2)), rng.uniform(8, 40, (6, 2))].astype(np.float32)
    meas_j = jk.measurement_from_xywh(jnp.asarray(boxes), fmt)
    meas_t = tk.measurement_from_xywh(torch.from_numpy(boxes), fmt)
    sj, st = jk.initiate(meas_j, fmt), tk.initiate(meas_t, fmt)
    for step in range(4):
        sj, st = jk.predict(sj, fmt), tk.predict(st, fmt)
        z = boxes + rng.normal(0, 1, boxes.shape).astype(np.float32) * (step + 1)
        sj = jk.update(sj, jk.measurement_from_xywh(jnp.asarray(z), fmt), fmt)
        st = tk.update(st, tk.measurement_from_xywh(torch.from_numpy(z), fmt), fmt)
    np.testing.assert_allclose(st.mean.numpy(), np.asarray(sj.mean), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(st.cov.numpy(), np.asarray(sj.cov), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        tk.gating_distance(st, torch.from_numpy(boxes), fmt).numpy(),
        np.asarray(jk.gating_distance(sj, jnp.asarray(boxes), fmt)), rtol=1e-4,
    )
    np.testing.assert_allclose(tk.xywh_from_state(st.mean, fmt).numpy(),
                               np.asarray(jk.xywh_from_state(sj.mean, fmt)), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("seed,shape", [(0, (8, 12)), (1, (20, 20)), (2, (5, 30))])
def test_auction_matches_jax(seed, shape):
    cost = np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)
    ref = np.asarray(ja.auction_assignment(jnp.asarray(cost)))
    ours = ta.auction_assignment(torch.from_numpy(cost)).numpy()
    np.testing.assert_array_equal(ours, ref)
    assert len(set(ours.tolist())) == shape[0]


def test_masked_assignment_matches_jax():
    rng = np.random.default_rng(3)
    cost = rng.uniform(0, 1.2, (16, 24)).astype(np.float32)
    rv, cv = rng.random(16) > 0.2, rng.random(24) > 0.3
    rc, rm = ja.masked_assignment(jnp.asarray(cost), jnp.asarray(rv), jnp.asarray(cv), 0.8)
    oc, om = ta.masked_assignment(torch.from_numpy(cost), torch.from_numpy(rv), torch.from_numpy(cv), 0.8)
    np.testing.assert_array_equal(oc.numpy(), np.asarray(rc))
    np.testing.assert_array_equal(om.numpy(), np.asarray(rm))


def _detections(n_frames=30, max_det=16, seed=4):
    """Moving objects with jitter, score spread, dropouts and a late entrant."""
    rng = np.random.default_rng(seed)
    n_obj = 9
    xy0 = rng.uniform(40, 360, (n_obj, 2))
    vel = rng.uniform(-3, 3, (n_obj, 2))
    wh = rng.uniform(12, 40, (n_obj, 2))
    out = []
    for f in range(n_frames):
        b = np.zeros((max_det, 4), np.float32)
        s = np.zeros((max_det,), np.float32)
        c = np.full((max_det,), -1, np.int32)
        v = np.zeros((max_det,), bool)
        k = 0
        for i in range(n_obj):
            if (i == 8 and f < 10) or rng.random() < 0.1:
                continue
            b[k, :2] = xy0[i] + vel[i] * f + rng.normal(0, 0.8, 2)
            b[k, 2:] = wh[i] + rng.normal(0, 0.5, 2)
            s[k] = rng.uniform(0.12, 0.95)
            c[k] = i % 4
            v[k] = True
            k += 1
        out.append((b, s, c, v))
    return out


@pytest.mark.parametrize("name", ["botsort", "bytetrack"])
def test_byte_step_sequence(name):
    params = {"track_high_thresh": 0.25, "track_low_thresh": 0.1, "new_track_thresh": 0.25,
              "track_buffer": 30, "match_thresh": 0.8, "fuse_score": True,
              "gmc_method": "sparseOptFlow"}
    _, js, jstep = jb.make_tracker(name, params, max_tracks=32)
    cfg, ts, tstep = tb.make_tracker(name, params, max_tracks=32, device="cpu")
    rng = np.random.default_rng(5)
    n_tracked = 0
    for f, (b, s, c, v) in enumerate(_detections(), start=1):
        gmc = None
        if cfg.use_gmc:
            gmc = np.eye(3, dtype=np.float32)
            gmc[:2, 2] = rng.normal(0, 0.5, 2)
        js, jo = jstep(js, jnp.asarray(b), jnp.asarray(s), jnp.asarray(c), jnp.asarray(v), f,
                       None if gmc is None else jnp.asarray(gmc))
        ts, to = tstep(ts, torch.from_numpy(b), torch.from_numpy(s), torch.from_numpy(c),
                       torch.from_numpy(v), f, None if gmc is None else torch.from_numpy(gmc))
        np.testing.assert_array_equal(to.valid.numpy(), np.asarray(jo.valid), err_msg=f"frame {f}")
        np.testing.assert_array_equal(to.track_id.numpy(), np.asarray(jo.track_id))
        np.testing.assert_array_equal(ts.status.numpy(), np.asarray(js.status))
        np.testing.assert_array_equal(to.cls.numpy(), np.asarray(jo.cls))
        valid = to.valid.numpy()
        np.testing.assert_allclose(to.box_xywh.numpy()[valid], np.asarray(jo.box_xywh)[valid],
                                   rtol=0, atol=BOX_ATOL)
        n_tracked += int(valid.sum())
    assert int(ts.next_id) == int(js.next_id) > 5
    assert n_tracked > 100


# The trackers of the ReID family, each from its block of the port's default
# configuration with these overrides. Deep OC-SORT also runs with GMC, and
# OC-SORT once with its BYTE second pass.
TRACKERS = {
    "botsort+reid": ("botsort", {"with_reid": True}),
    "deepocsort+reid": ("deepocsort", {"with_reid": True, "gmc_method": "sparseOptFlow"}),
    "tracktrack+reid": ("tracktrack", {"with_reid": True}),
    "ocsort": ("ocsort", {}),
    "ocsort+byte": ("ocsort", {"use_byte": True}),
    "fasttrack": ("fasttrack", {}),
}


def _embeddings(n_frames, max_det, seed):
    """Per-detection embeddings: one base vector per detection slot plus
    noise, so that appearance costs separate the targets."""
    rng = np.random.default_rng(seed)
    base = rng.normal(0, 1, (max_det, tb.EMB_DIM))
    return [(base + rng.normal(0, 0.3, base.shape)).astype(np.float32) for _ in range(n_frames)]


def _occlusion_detections(n_frames=40, max_det=8):
    """A vehicle passes over a parked one (covering it for several frames,
    during which the parked one is not detected), beside two free movers."""
    out = []
    for f in range(n_frames):
        b = np.zeros((max_det, 4), np.float32)
        s = np.zeros((max_det,), np.float32)
        v = np.zeros((max_det,), bool)
        objs = [(200.0, 200.0, 40.0, 40.0, 0.9), (110.0 + 6.0 * f, 202.0, 46.0, 44.0, 0.85),
                (60.0 + 2.0 * f, 80.0, 30.0, 20.0, 0.7), (320.0, 300.0 - 3.0 * f, 24.0, 36.0, 0.3)]
        k = 0
        for i, (x, y, w, h, sc) in enumerate(objs):
            if i == 0 and 12 <= f <= 17:
                continue  # the parked vehicle hidden under the passing one
            b[k] = (x, y, w, h)
            s[k] = sc
            v[k] = True
            k += 1
        out.append((b, s, np.where(v, 0, -1).astype(np.int32), v))
    return out


@pytest.mark.parametrize("scenario", ["sequence", "occlusion"])
@pytest.mark.parametrize("key", list(TRACKERS))
def test_tracker_step_sequence(key, scenario):
    """Step sequences of the ReID family against the reference: identical
    ids, validity, status and classes, boxes within BOX_ATOL, embeddings
    within 1e-5 (the repair gate of the ReID code in track/base.py:
    the EMA of _apply_matches, _spawn_new and byte_associate's appearance
    cost, with seeded embeddings)."""
    from geotrax_tpu_torch import cfg as tcfg

    name, overrides = TRACKERS[key]
    params = {**tcfg.DEFAULT["tracker"][name], **overrides}
    jcfg, js, jstep = jb.make_tracker(name, params, max_tracks=32)
    cfg, ts, tstep = tb.make_tracker(name, params, max_tracks=32, device="cpu")
    assert cfg == jcfg
    dets = _detections() if scenario == "sequence" else _occlusion_detections()
    embs = _embeddings(len(dets), dets[0][0].shape[0], seed=6) if cfg.with_reid else None
    rng = np.random.default_rng(5)
    n_tracked, occluded = 0, 0
    for f, (b, s, c, v) in enumerate(dets, start=1):
        gmc = None
        if cfg.use_gmc:
            gmc = np.eye(3, dtype=np.float32)
            gmc[:2, 2] = rng.normal(0, 0.5, 2)
        e = None if embs is None else embs[f - 1]
        js, jo = jstep(js, *(jnp.asarray(a) for a in (b, s, c, v)), f,
                       None if gmc is None else jnp.asarray(gmc), None if e is None else jnp.asarray(e))
        ts, to = tstep(ts, *(torch.from_numpy(a) for a in (b, s, c, v)), f,
                       None if gmc is None else torch.from_numpy(gmc),
                       None if e is None else torch.from_numpy(e))
        np.testing.assert_array_equal(to.valid.numpy(), np.asarray(jo.valid), err_msg=f"frame {f}")
        np.testing.assert_array_equal(to.track_id.numpy(), np.asarray(jo.track_id))
        np.testing.assert_array_equal(ts.status.numpy(), np.asarray(js.status))
        np.testing.assert_array_equal(ts.occ.numpy(), np.asarray(js.occ))
        np.testing.assert_array_equal(to.cls.numpy(), np.asarray(jo.cls))
        valid = to.valid.numpy()
        np.testing.assert_allclose(to.box_xywh.numpy()[valid], np.asarray(jo.box_xywh)[valid],
                                   rtol=0, atol=BOX_ATOL)
        np.testing.assert_allclose(ts.emb.numpy(), np.asarray(js.emb), rtol=0, atol=1e-5)
        n_tracked += int(valid.sum())
        occluded += int((ts.occ.numpy() > 0).sum())
    assert int(ts.next_id) == int(js.next_id) > 3
    assert n_tracked > 40
    if cfg.with_reid:
        assert np.abs(ts.emb.numpy()).sum() > 0
    if name == "fasttrack" and scenario == "occlusion":
        assert occluded > 0  # the occlusion branch ran


E1 = np.eye(tb.EMB_DIM, dtype=np.float32)[0]
E2 = np.eye(tb.EMB_DIM, dtype=np.float32)[1]
CROSSING = {
    "botsort": {"track_high_thresh": 0.25, "track_low_thresh": 0.1, "new_track_thresh": 0.25,
                "track_buffer": 30, "match_thresh": 0.9, "fuse_score": False,
                "gmc_method": "none", "with_reid": True, "proximity_thresh": 0.7,
                "appearance_thresh": 0.8},
    "deepocsort": {"track_high_thresh": 0.25, "track_low_thresh": 0.1, "new_track_thresh": 0.25,
                   "track_buffer": 30, "match_thresh": 0.9, "fuse_score": False, "delta_t": 3,
                   "inertia": 0.0, "use_byte": False, "gmc_method": "none", "with_reid": True,
                   "proximity_thresh": 0.7, "appearance_thresh": 0.9, "alpha_fixed_emb": 0.95},
    "tracktrack": {"track_high_thresh": 0.25, "track_low_thresh": 0.1, "new_track_thresh": 0.25,
                   "track_buffer": 30, "match_thresh": 0.9, "fuse_score": False,
                   "iou_weight": 0.5, "reid_weight": 0.5, "conf_weight": 0.0, "angle_weight": 0.0,
                   "penalty_p": 0.0, "penalty_q": 0.0, "reduce_step": 0.05, "tai_thr": 0.55,
                   "min_track_len": 1, "lost_match_thr": 0.0, "gmc_method": "none",
                   "with_reid": True},
}


def _crossing_ids(make, to_array, params, use_emb):
    """The crossing-targets scenario of tests/test_reid.py: two targets whose
    detections land closer to each other's track at the swap frame; the
    (left, right) ids per frame."""
    _, state, step = make(params)
    frames = [([100.0, 100.0, 40, 40], [112.0, 100.0, 40, 40])] * 2 + \
             [([109.0, 100.0, 40, 40], [103.0, 100.0, 40, 40])] * 2
    ids_by_frame = []
    for t, (b1, b2) in enumerate(frames):
        b = np.zeros((8, 4), np.float32)
        b[:2] = [b1, b2]
        v = np.arange(8) < 2
        s = np.where(v, 0.9, 0.0).astype(np.float32)
        e = np.zeros((8, tb.EMB_DIM), np.float32)
        e[:2] = [E1, E2]
        state, out = step(state, to_array(b), to_array(s), to_array(np.zeros(8, np.int32)),
                          to_array(v), t + 1, None, to_array(e) if use_emb else None)
        valid = np.asarray(out.valid)
        boxes, ids = np.asarray(out.box_xywh)[valid], np.asarray(out.track_id)[valid]
        ids_by_frame.append(tuple(ids[np.argsort(boxes[:, 0])].tolist()))
    return ids_by_frame


@pytest.mark.parametrize("name", list(CROSSING))
def test_reid_keeps_ids_through_crossing(name):
    """With ReID the ids follow the targets through the swap (the right box
    carries id 1 afterwards); without, they bind by proximity. The port
    gives the reference's ids frame by frame in both cases."""
    for use_emb in (True, False):
        params = {**CROSSING[name], "with_reid": use_emb}
        ours = _crossing_ids(lambda p: tb.make_tracker(name, p, max_tracks=16, device="cpu"),
                             torch.from_numpy, params, use_emb)
        ref = _crossing_ids(lambda p: jb.make_tracker(name, p, max_tracks=16), jnp.asarray,
                            params, use_emb)
        assert ours == ref
        assert ours[3] == ((2, 1) if use_emb else (1, 2))


def test_unknown_tracker_raises():
    with pytest.raises(ValueError):
        tb.make_tracker("nope", {}, device="cpu")
