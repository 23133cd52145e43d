"""TrackTrack: multi-cue cost and iterative assignment on the slot-based core.

Counterpart of ``geotrax_tpu/track/tracktrack.py``. The association cost
combines Height-Modulated IoU, an appearance term (the cosine distance of
the ReID embeddings, or HMIoU again when ReID is off), a confidence-distance
term and a corner-angle term with configurable weights; penalties p/q raise
the cost of low-confidence detections and of lost tracks; assignment
iterates from a tight gate that relaxes by ``reduce_step`` per round, so
confident pairs bind first; track-aware initialisation (TAI) suppresses new
tracks overlapping used detections above ``tai_thr``; tracks are output only
after ``min_track_len`` hits; still-lost tracks get a relaxed second chance
when ``lost_match_thr`` > 0.
"""

from __future__ import annotations

import math

import torch

from geotrax_tpu_torch.ops.assignment import masked_assignment
from geotrax_tpu_torch.ops.boxes import hmiou_matrix, iou_matrix, xywh_to_xyxy
from geotrax_tpu_torch.track import base
from geotrax_tpu_torch.track.base import EMPTY, LOST, TENTATIVE, TRACKED, TrackerConfig


def _corner_angle_cost(track_boxes_xywh, det_boxes_xywh):
    """Angle between the track->det displacement and the track's box
    diagonal orientation, over pi (0 where the box hardly moved)."""
    d = det_boxes_xywh[None, :, :2] - track_boxes_xywh[:, None, :2]
    disp_angle = torch.atan2(d[..., 1], d[..., 0])
    diag_angle = torch.atan2(track_boxes_xywh[:, 3], track_boxes_xywh[:, 2])[:, None]
    diff = torch.abs(torch.remainder(disp_angle - diag_angle + math.pi, 2 * math.pi) - math.pi)
    moved = torch.linalg.vector_norm(d, dim=-1) > 1.0
    return torch.where(moved, diff / math.pi, 0.0)


def make_tracktrack_step(params: dict, common: dict):
    """(cfg, step) of TrackTrack."""
    iou_w = float(params.get("iou_weight", 0.5))
    reid_w = float(params.get("reid_weight", 0.5))
    conf_w = float(params.get("conf_weight", 0.1))
    angle_w = float(params.get("angle_weight", 0.05))
    penalty_p = float(params.get("penalty_p", 0.2))
    penalty_q = float(params.get("penalty_q", 0.4))
    reduce_step = float(params.get("reduce_step", 0.05))
    tai_thr = float(params.get("tai_thr", 0.55))
    min_track_len = int(params.get("min_track_len", 3))
    lost_match_thr = float(params.get("lost_match_thr", 0.0))
    use_gmc = params.get("gmc_method", "sparseOptFlow") not in (None, "none", "None")
    cfg = TrackerConfig(
        kf_fmt="xywh", use_gmc=use_gmc,
        with_reid=bool(params.get("with_reid", False)),
        proximity_thresh=float(params.get("proximity_thresh", 0.5)),
        appearance_thresh=float(params.get("appearance_thresh", 0.8)),
        **common,
    )
    num_rounds = max(1, int(round(cfg.match_thresh / max(reduce_step, 1e-3))) // 4)
    num_rounds = min(num_rounds, 4)
    total_w = max(iou_w + reid_w + conf_w + angle_w, 1e-6)

    def multi_cue_cost(state, cfg_, det_boxes, det_scores, det_emb=None):
        track_boxes = base._track_boxes(state, cfg_)
        hm = 1.0 - hmiou_matrix(xywh_to_xyxy(track_boxes), xywh_to_xyxy(det_boxes))
        if cfg_.with_reid and det_emb is not None:
            appearance = base._emb_distance(state.emb, base._l2_normalize(det_emb))
        else:
            appearance = hm  # ReID off: HMIoU fallback
        conf_dist = torch.abs(state.score[:, None] - det_scores[None, :])
        angle = _corner_angle_cost(track_boxes, det_boxes)
        cost = iou_w * hm + reid_w * appearance + conf_w * conf_dist + angle_w * angle
        cost = cost / total_w
        # penalties: low-confidence detections (p), lost tracks (q)
        low_det = det_scores[None, :] < cfg_.track_high_thresh
        lost_track = (state.status == LOST)[:, None]
        return cost + penalty_p * low_det + penalty_q * lost_track

    def step(state, det_boxes, det_scores, det_cls, det_valid, frame_id, cfg_,
             gmc_h=None, det_emb=None):
        frame_id = int(frame_id)
        m = det_boxes.shape[0]
        state = base.predict_stage(state, cfg_, gmc_h)

        considered = det_valid & (det_scores > cfg_.track_low_thresh)
        pool = (state.status == TRACKED) | (state.status == LOST)

        # iterative assignment from the tightest gate, relaxing by
        # reduce_step per round up to match_thresh
        det_used = torch.zeros_like(det_valid)
        track_done = torch.zeros_like(pool)
        for r in range(num_rounds):
            gate = cfg_.match_thresh - (num_rounds - 1 - r) * reduce_step
            cost = multi_cue_cost(state, cfg_, det_boxes, det_scores, det_emb)
            col, matched = masked_assignment(cost, pool & ~track_done, considered & ~det_used, gate)
            state = base._apply_matches(state, cfg_, det_boxes, det_scores, det_cls, col, matched,
                                        frame_id, det_emb)
            det_used = base._scatter_drop(det_used, torch.where(matched, col, m), True)
            track_done = track_done | matched

        # relaxed rebind for still-lost tracks
        if lost_match_thr > 0.0:
            still_lost = (state.status == LOST) & ~track_done
            cost = multi_cue_cost(state, cfg_, det_boxes, det_scores, det_emb)
            col, matched = masked_assignment(cost, still_lost, considered & ~det_used,
                                             lost_match_thr)
            state = base._apply_matches(state, cfg_, det_boxes, det_scores, det_cls, col, matched,
                                        frame_id, det_emb)
            det_used = base._scatter_drop(det_used, torch.where(matched, col, m), True)

        went_lost = (state.status == TRACKED) & (state.last_frame < frame_id)
        state = state._replace(status=torch.where(went_lost, LOST, state.status))

        # tentative pass: only remaining high-confidence dets confirm
        high = det_valid & (det_scores >= cfg_.track_high_thresh)
        unconfirmed = state.status == TENTATIVE
        cost3 = base._iou_cost(state, cfg_, det_boxes)
        col3, m3 = masked_assignment(cost3, unconfirmed, high & ~det_used,
                                     cfg_.tentative_match_thresh)
        state = base._apply_matches(state, cfg_, det_boxes, det_scores, det_cls, col3, m3,
                                    frame_id)
        det_used = base._scatter_drop(det_used, torch.where(m3, col3, m), True)
        drop_tent = (state.status == TENTATIVE) & (state.last_frame < frame_id)
        state = state._replace(status=torch.where(drop_tent, EMPTY, state.status))

        # TAI: candidates overlapping a used detection above tai_thr do not spawn
        cand = considered & ~det_used & (det_scores >= cfg_.new_track_thresh)
        db = xywh_to_xyxy(det_boxes)
        overlap = iou_matrix(db, db)
        vs_used = torch.where(cand[:, None] & det_used[None, :], overlap, 0.0)
        cand = cand & (torch.amax(vs_used, dim=1) < tai_thr)
        state = base._spawn_new(state, cfg_, det_boxes, det_scores, det_cls, cand, frame_id,
                                det_emb)

        expired = (state.status == LOST) & (frame_id - state.last_frame > cfg_.track_buffer)
        state = state._replace(status=torch.where(expired, EMPTY, state.status))

        # output only tracks with min_track_len hits (or in the first frames)
        out = base.frame_output(state, cfg_, frame_id)
        if frame_id > min_track_len:
            out = out._replace(valid=out.valid & (state.hits >= min_track_len))
        return state, out

    return cfg, step
