"""Tracker core of the port against the JAX package: Kalman steps, the
auction and its gated wrapper, and a 30-frame ``byte_step`` sequence for
botsort (with camera-motion homographies) and bytetrack — identical track
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


def test_unported_trackers_name_the_roadmap():
    for name in ("ocsort", "deepocsort", "fasttrack", "tracktrack"):
        with pytest.raises(NotImplementedError, match="ROADMAP A13"):
            tb.make_tracker(name, {}, device="cpu")
    with pytest.raises(ValueError):
        tb.make_tracker("nope", {}, device="cpu")
