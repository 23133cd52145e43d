"""FastTracker: occlusion-aware ByteTrack on the slot-based core.

Counterpart of ``geotrax_tpu/track/fasttrack.py``. It detects occlusion
onset by box-coverage analysis, then (a) rolls the Kalman velocity and
position back to the pre-occlusion history, (b) enlarges the search box
once, (c) dampens motion while occluded, (d) moves long-occluded tracks to
lost with an extended re-find window, and (e) suppresses new tracks that
overlap an older track (``init_iou_suppress``).
"""

from __future__ import annotations

import torch

from geotrax_tpu_torch.ops.boxes import box_area, iou_matrix, xywh_to_xyxy
from geotrax_tpu_torch.track import base
from geotrax_tpu_torch.track.base import EMPTY, HIST, LOST, TENTATIVE, TRACKED, TrackerConfig


def _cover_fraction(boxes_xyxy):
    """(K,K) fraction of box i's area covered by box j."""
    lt = torch.maximum(boxes_xyxy[:, None, :2], boxes_xyxy[None, :, :2])
    rb = torch.minimum(boxes_xyxy[:, None, 2:], boxes_xyxy[None, :, 2:])
    wh = torch.clamp_min(rb - lt, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / torch.clamp_min(box_area(boxes_xyxy)[:, None], 1e-6)


def make_fasttrack_step(params: dict, common: dict):
    """(cfg, step) of FastTracker."""
    reset_vel = int(params.get("reset_velocity_offset_occ", 5))
    reset_pos = int(params.get("reset_pos_offset_occ", 3))
    enlarge = float(params.get("enlarge_bbox_occ", 1.1))
    dampen = float(params.get("dampen_motion_occ", 0.5))
    occ_to_lost = int(params.get("active_occ_to_lost_thresh", 10))
    cover_thresh = float(params.get("occ_cover_thresh", 0.7))
    reappear = int(params.get("occ_reappear_window", 40))
    init_iou_suppress = float(params.get("init_iou_suppress", 0.7))
    cfg = TrackerConfig(kf_fmt="xyah", use_gmc=False, **common)
    v_lag = max(1, min(reset_vel, HIST - 1))
    p_lag = max(1, min(reset_pos, HIST - 1))

    def step(state, det_boxes, det_scores, det_cls, det_valid, frame_id, cfg_,
             gmc_h=None, det_emb=None):
        frame_id = int(frame_id)
        # ---- occlusion onset analysis on the current track boxes
        tboxes = xywh_to_xyxy(base._track_boxes(state, cfg_))
        live = state.status == TRACKED
        k = tboxes.shape[0]
        others = ~torch.eye(k, dtype=torch.bool, device=tboxes.device)
        cover = torch.where(live[:, None] & live[None, :] & others, _cover_fraction(tboxes), 0.0)
        occluded_now = live & (torch.amax(cover, dim=1) >= cover_thresh)
        newly_occluded = occluded_now & (state.occ == 0)
        # occ persists while LOST (the loss was caused by occlusion: the key
        # to the extended window below) and resets otherwise
        occ = torch.where(occluded_now, state.occ + 1,
                          torch.where(state.status == LOST, state.occ, 0))

        # (a) KF rollback at occlusion onset: velocity from the observation
        # history, position from a shallower history point
        hist_c = state.obs_hist[:, :, :2]
        vel_est = (hist_c[:, HIST - 1] - hist_c[:, HIST - 1 - v_lag]) / v_lag
        has_v = state.hist_frame[:, HIST - 1 - v_lag] > 0
        pos_roll = hist_c[:, HIST - 1 - p_lag]
        has_p = state.hist_frame[:, HIST - 1 - p_lag] > 0
        mean = state.kf_mean.clone()
        mean[:, 4:6] = torch.where((newly_occluded & has_v)[:, None], vel_est, mean[:, 4:6])
        mean[:, :2] = torch.where((newly_occluded & has_p)[:, None], pos_roll, mean[:, :2])
        # (b) one-shot box enlargement on entering occlusion (wider search)
        mean[:, 3] = torch.where(newly_occluded, mean[:, 3] * enlarge, mean[:, 3])
        # (c) dampen motion while occluded
        mean[:, 4:6] = torch.where(occluded_now[:, None], mean[:, 4:6] * dampen, mean[:, 4:6])
        state = state._replace(kf_mean=mean, occ=occ)

        # (d) long occlusion -> lost
        force_lost = live & (occ >= occ_to_lost)
        state = state._replace(status=torch.where(force_lost, LOST, state.status))

        # ---- the BYTE association schedule of the shared core
        state = base.predict_stage(state, cfg_, gmc_h)
        state = base.byte_associate(state, cfg_, det_boxes, det_scores, det_cls, det_valid,
                                    frame_id)

        # (e) drop fresh tracks overlapping an older track beyond
        # init_iou_suppress (1.0 disables)
        if init_iou_suppress < 1.0:
            fresh = (state.status == TRACKED) | (state.status == TENTATIVE)
            fresh = fresh & (state.start_frame == frame_id)
            older = ((state.status == TRACKED) | (state.status == LOST)) & (
                state.start_frame < frame_id)
            tb = xywh_to_xyxy(base._track_boxes(state, cfg_))
            iou = torch.where(fresh[:, None] & older[None, :], iou_matrix(tb, tb), 0.0)
            kill = fresh & (torch.amax(iou, dim=1) >= init_iou_suppress)
            state = state._replace(status=torch.where(kill, EMPTY, state.status))

        # extended window for occlusion-lost tracks: byte_associate pruned
        # every LOST track past track_buffer; the slots are intact, so the
        # ones still inside the extended window come back as LOST
        extended_buffer = max(cfg_.track_buffer, reappear)
        age = frame_id - state.last_frame
        resurrect = ((state.status == EMPTY) & (state.occ > 0)
                     & (age > cfg_.track_buffer) & (age <= extended_buffer))
        state = state._replace(status=torch.where(resurrect, LOST, state.status))
        return state, base.frame_output(state, cfg_, frame_id)

    return cfg, step
