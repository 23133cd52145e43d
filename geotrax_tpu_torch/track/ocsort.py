"""OC-SORT / Deep OC-SORT on the slot-based core.

Counterpart of ``geotrax_tpu/track/ocsort.py``. On top of the BYTE schedule
this adds the observation-centric motion cost (OCM): a velocity-direction
consistency term weighted by ``inertia``, from the observation history over
a ``delta_t`` window; and observation-centric re-update (OCR): a lost
track that re-matches is re-anchored on its last observation rather than
the drifted KF prediction. ``use_byte`` toggles the low-confidence second
pass. Deep OC-SORT adds optional GMC and, with ReID, EMA appearance
embeddings with a confidence-adaptive factor.
"""

from __future__ import annotations

import math

import torch

from geotrax_tpu_torch.ops import kalman
from geotrax_tpu_torch.ops.assignment import masked_assignment
from geotrax_tpu_torch.track import base
from geotrax_tpu_torch.track.base import (
    EMPTY,
    HIST,
    LOST,
    TENTATIVE,
    TRACKED,
    TrackerConfig,
    TrackerState,
)


def _velocity_direction(state: TrackerState, delta_t: int):
    """Per-track unit velocity direction from the observation ``delta_t``
    entries back to the newest observation (OCM reference direction)."""
    newest = state.obs_hist[:, HIST - 1, :2]
    lag = max(1, min(delta_t, HIST - 1))
    past = state.obs_hist[:, HIST - 1 - lag, :2]
    has_past = state.hist_frame[:, HIST - 1 - lag] > 0
    d = newest - past
    norm = torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    direction = torch.where(norm > 1e-6, d / torch.clamp_min(norm, 1e-6), 0.0)
    return direction, has_past & (norm[:, 0] > 1e-6)


def _ocm_cost(state: TrackerState, det_boxes, delta_t: int, inertia: float):
    """Angle-consistency cost between each track's historical motion
    direction and the direction toward each candidate detection."""
    direction, valid_dir = _velocity_direction(state, delta_t)
    to_det = det_boxes[None, :, :2] - state.obs_hist[:, None, HIST - 1, :2]
    norm = torch.linalg.vector_norm(to_det, dim=-1)
    to_det_unit = to_det / torch.clamp_min(norm[..., None], 1e-6)
    cos = torch.sum(direction[:, None, :] * to_det_unit, dim=-1)
    angle = torch.arccos(torch.clamp(cos, -1.0, 1.0))  # [0, pi]
    cost = inertia * (angle / math.pi)
    return torch.where(valid_dir[:, None] & (norm > 1e-6), cost, 0.0)


def make_ocsort_step(params: dict, common: dict, deep: bool = False):
    """(cfg, step) of OC-SORT, or of Deep OC-SORT with ``deep``."""
    delta_t = int(params.get("delta_t", 3))
    inertia = float(params.get("inertia", 0.2))
    use_byte = bool(params.get("use_byte", False))
    use_gmc = deep and params.get("gmc_method", "none") not in (None, "none", "None")
    reid = {}
    if deep:
        reid = dict(
            with_reid=bool(params.get("with_reid", False)),
            proximity_thresh=float(params.get("proximity_thresh", 0.5)),
            appearance_thresh=float(params.get("appearance_thresh", 0.9)),
            emb_alpha=float(params.get("alpha_fixed_emb", 0.95)),
            adaptive_alpha=True,
        )
    cfg = TrackerConfig(kf_fmt="xyah", use_gmc=use_gmc, **common, **reid)

    def step(state, det_boxes, det_scores, det_cls, det_valid, frame_id, cfg_,
             gmc_h=None, det_emb=None):
        frame_id = int(frame_id)
        m = det_boxes.shape[0]
        state = base.predict_stage(state, cfg_, gmc_h)

        high = det_valid & (det_scores >= cfg_.track_high_thresh)
        low = det_valid & (det_scores > cfg_.track_low_thresh) & (
            det_scores < cfg_.track_high_thresh)

        # stage 1: tracked + lost vs high dets, IoU + OCM velocity cost
        pool = (state.status == TRACKED) | (state.status == LOST)
        was_lost = state.status == LOST
        iou_d = base._iou_cost(state, cfg_, det_boxes)
        cost = iou_d + _ocm_cost(state, det_boxes, delta_t, inertia)
        cost = base._fused(cost, det_scores, cfg_.fuse_score)
        if cfg_.with_reid and det_emb is not None:
            # halved cosine distance, gated by the appearance threshold and
            # IoU proximity (Deep OC-SORT flavour of the BoT-SORT fusion)
            emb_d = base._emb_distance(state.emb, base._l2_normalize(det_emb)) / 2.0
            emb_d = torch.where(emb_d > cfg_.appearance_thresh, 1.0, emb_d)
            emb_d = torch.where(iou_d > cfg_.proximity_thresh, 1.0, emb_d)
            cost = torch.minimum(cost, emb_d)
        col1, m1 = masked_assignment(cost, pool, high, cfg_.match_thresh)

        # OCR: re-anchor re-found lost tracks on their last observation
        # before the measurement update
        refound = m1 & was_lost
        re_init = kalman.initiate(kalman.measurement_from_xywh(state.obs_box, fmt=cfg_.kf_fmt),
                                  fmt=cfg_.kf_fmt)
        state = state._replace(
            kf_mean=torch.where(refound[:, None], re_init.mean, state.kf_mean),
            kf_cov=torch.where(refound[:, None, None], re_init.cov, state.kf_cov),
        )
        state = base._apply_matches(state, cfg_, det_boxes, det_scores, det_cls, col1, m1,
                                    frame_id, det_emb)
        det_used = base._scatter_drop(torch.zeros_like(det_valid), torch.where(m1, col1, m), True)

        # optional BYTE second pass on low-confidence dets
        if use_byte:
            r_tracked = (state.status == TRACKED) & ~m1 & (state.last_frame < frame_id)
            cost2 = base._iou_cost(state, cfg_, det_boxes)
            col2, m2 = masked_assignment(cost2, r_tracked, low & ~det_used,
                                         cfg_.second_match_thresh)
            state = base._apply_matches(state, cfg_, det_boxes, det_scores, det_cls, col2, m2,
                                        frame_id)
            det_used = base._scatter_drop(det_used, torch.where(m2, col2, m), True)

        went_lost = (state.status == TRACKED) & (state.last_frame < frame_id)
        state = state._replace(status=torch.where(went_lost, LOST, state.status))

        # tentative pass, spawning and pruning as in the BYTE core
        unconfirmed = state.status == TENTATIVE
        cost3 = base._fused(base._iou_cost(state, cfg_, det_boxes), det_scores, cfg_.fuse_score)
        col3, m3 = masked_assignment(cost3, unconfirmed, high & ~det_used,
                                     cfg_.tentative_match_thresh)
        state = base._apply_matches(state, cfg_, det_boxes, det_scores, det_cls, col3, m3,
                                    frame_id)
        det_used = base._scatter_drop(det_used, torch.where(m3, col3, m), True)
        drop_tent = (state.status == TENTATIVE) & (state.last_frame < frame_id)
        state = state._replace(status=torch.where(drop_tent, EMPTY, state.status))

        spawn = high & ~det_used & (det_scores >= cfg_.new_track_thresh)
        state = base._spawn_new(state, cfg_, det_boxes, det_scores, det_cls, spawn, frame_id,
                                det_emb)
        expired = (state.status == LOST) & (frame_id - state.last_frame > cfg_.track_buffer)
        state = state._replace(status=torch.where(expired, EMPTY, state.status))
        return state, base.frame_output(state, cfg_, frame_id)

    return cfg, step
