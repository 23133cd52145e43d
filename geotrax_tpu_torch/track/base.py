"""Slot-based multi-object tracking core (BYTE-style two-stage association).

Counterpart of ``geotrax_tpu/track/base.py``. The tracker is a function over
a fixed array of track slots,

    state', frame_outputs = step(state, detections, frame_id)

with track creation and deletion as slot allocation under status codes:

    0 EMPTY    free slot
    1 TENTATIVE activated=False (seen once, awaiting confirmation)
    2 TRACKED  actively matched
    3 LOST     unmatched for <= track_buffer frames (recoverable)

The update follows the BYTE association schedule of bytetrack/botsort
(ultralytics semantics): stage 1 high-confidence dets vs tracked+lost pool
(cost 1 - IoU, optionally fused with det score, gate match_thresh); stage 2
low-confidence dets vs still-unmatched tracked (gate 0.5); stage 3
remaining high dets vs tentative tracks (gate 0.7, fused); new tracks from
remaining high dets above new_track_thresh; lost tracks pruned after
track_buffer frames. Output boxes are the KF means.

The BYTE step takes one timeline's state or, with a leading video axis, V
timelines' at once (``make_batch_tracker``, the lockstep multi-video
extractor's tracker): every video steps exactly as it steps alone.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from geotrax_tpu_torch._device import resolve_device
from geotrax_tpu_torch.ops import kalman
from geotrax_tpu_torch.ops.assignment import masked_assignment
from geotrax_tpu_torch.ops.boxes import iou_matrix, xywh_to_xyxy
from geotrax_tpu_torch.ops.homography import apply_homography

EMPTY, TENTATIVE, TRACKED, LOST = 0, 1, 2, 3


class TrackerConfig(NamedTuple):
    """Static tracker parameters."""
    track_high_thresh: float = 0.25
    track_low_thresh: float = 0.1
    new_track_thresh: float = 0.25
    track_buffer: int = 30
    match_thresh: float = 0.8
    fuse_score: bool = True
    second_match_thresh: float = 0.5
    tentative_match_thresh: float = 0.7
    kf_fmt: str = "xyah"          # 'xyah' (bytetrack lineage) | 'xywh' (botsort)
    use_gmc: bool = False         # apply camera-motion homography to predictions
    max_tracks: int = 256
    # ReID appearance modeling (BoT-SORT, Deep OC-SORT, TrackTrack)
    with_reid: bool = False
    proximity_thresh: float = 0.5
    appearance_thresh: float = 0.8
    emb_alpha: float = 0.9        # EMA factor for track embeddings
    adaptive_alpha: bool = False  # Deep OC-SORT confidence-adaptive EMA


EMB_DIM = 64  # appearance-embedding width
HIST = 8      # observation-history ring length


class TrackerState(NamedTuple):
    kf_mean: torch.Tensor      # (K, 8)
    kf_cov: torch.Tensor       # (K, 4, 3) factored per-coordinate [p_xx,p_xv,p_vv]
    status: torch.Tensor       # (K,) int32
    track_id: torch.Tensor     # (K,) int32
    score: torch.Tensor        # (K,)
    cls: torch.Tensor          # (K,) int32
    last_frame: torch.Tensor   # (K,) int32 frame of last match
    start_frame: torch.Tensor  # (K,) int32
    hits: torch.Tensor         # (K,) int32 number of matches
    next_id: torch.Tensor      # () int32
    obs_box: torch.Tensor      # (K, 4) last raw observation (xywh)
    obs_hist: torch.Tensor     # (K, HIST, 4) observation ring, newest last
    hist_frame: torch.Tensor   # (K, HIST) frame id per ring entry (0 = none)
    occ: torch.Tensor          # (K,) int32 occlusion counter (fasttrack)
    emb: torch.Tensor          # (K, EMB_DIM) EMA appearance embedding


class FrameOutput(NamedTuple):
    """Fixed-size per-frame results; ``valid`` marks live entries."""
    track_id: torch.Tensor   # (K,)
    box_xywh: torch.Tensor   # (K, 4) KF-state box
    score: torch.Tensor      # (K,)
    cls: torch.Tensor        # (K,) int32
    valid: torch.Tensor      # (K,) bool


def init_state(cfg: TrackerConfig, device="cuda") -> TrackerState:
    dev = resolve_device(device)
    k = cfg.max_tracks
    i32 = dict(dtype=torch.int32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    return TrackerState(
        kf_mean=torch.zeros((k, 8), **f32),
        kf_cov=torch.zeros((k, 4, kalman.COV_DIM), **f32),
        status=torch.zeros((k,), **i32),
        track_id=torch.zeros((k,), **i32),
        score=torch.zeros((k,), **f32),
        cls=torch.full((k,), -1, **i32),
        last_frame=torch.zeros((k,), **i32),
        start_frame=torch.zeros((k,), **i32),
        hits=torch.zeros((k,), **i32),
        next_id=torch.tensor(1, **i32),
        obs_box=torch.zeros((k, 4), **f32),
        obs_hist=torch.zeros((k, HIST, 4), **f32),
        hist_frame=torch.zeros((k, HIST), **i32),
        occ=torch.zeros((k,), **i32),
        emb=torch.zeros((k, EMB_DIM), **f32),
    )


def _track_boxes(state: TrackerState, cfg: TrackerConfig) -> torch.Tensor:
    return kalman.xywh_from_state(state.kf_mean, fmt=cfg.kf_fmt)


def _iou_cost(state, cfg, det_boxes):
    return 1.0 - iou_matrix(xywh_to_xyxy(_track_boxes(state, cfg)), xywh_to_xyxy(det_boxes))


def _fused(cost, det_scores, enable: bool):
    if not enable:
        return cost
    return 1.0 - (1.0 - cost) * det_scores[..., None, :]


def _l2_normalize(v, dim=-1, eps=1e-12):
    return v / torch.clamp_min(torch.linalg.vector_norm(v, dim=dim, keepdim=True), eps)


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b``; with a leading video axis, one product per video: a
    batched product may add in another order than one timeline's (the
    CPU's small-matrix batched kernel, cuBLAS's batched kernels), and each
    video must step exactly as it steps alone."""
    if a.dim() == 2:
        return a @ b
    return torch.stack([x @ y for x, y in zip(a, b)])


def _emb_distance(track_emb, det_emb):
    """Cosine distance (..., K, M) between L2-normalized embeddings."""
    return 1.0 - _matmul(track_emb, det_emb.transpose(-1, -2))


def _ema_alpha(cfg: TrackerConfig, det_scores):
    """Per-detection EMA factor: BoT-SORT's fixed alpha, or Deep OC-SORT's
    confidence-scaled one."""
    if not cfg.adaptive_alpha:
        return torch.full_like(det_scores, cfg.emb_alpha)
    trust = torch.clamp(
        (det_scores - cfg.track_high_thresh) / max(1.0 - cfg.track_high_thresh, 1e-6), 0.0, 1.0
    )
    return cfg.emb_alpha + (1.0 - cfg.emb_alpha) * (1.0 - trust)


def _scatter_drop(base: torch.Tensor, index: torch.Tensor, values) -> torch.Tensor:
    """``base.at[index].set(values, mode="drop")`` along the last axis, for
    each leading (video) index: indices outside [0, size) are dropped
    (written to a sink slot)."""
    size = base.shape[-1]
    sink = torch.cat([base, base[..., :1]], dim=-1)
    safe = torch.where((index >= 0) & (index < size), index, size)
    if isinstance(values, torch.Tensor):
        sink.scatter_(-1, safe, values.to(sink.dtype).expand(safe.shape))
    else:
        sink.scatter_(-1, safe, values)
    return sink[..., :size]


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of ``x`` at ``idx``: ``x[idx]`` for one timeline, and per video
    for a leading video axis ((V, M, ...) at (V, K) -> (V, K, ...))."""
    if idx.dim() == 1:
        return x[idx]
    return x[torch.arange(idx.shape[0], device=idx.device)[:, None], idx]


def _frame_tensor(frame_id, device) -> torch.Tensor:
    """``frame_id`` as a 0-dim int32 tensor on ``device``: a tensor is cast
    where it lies (the chunk step's ids are already on the device), a Python
    int is filled there, so neither reads the card back."""
    if isinstance(frame_id, torch.Tensor):
        return frame_id.to(device=device, dtype=torch.int32)
    return torch.full((), int(frame_id), dtype=torch.int32, device=device)


def _apply_matches(state: TrackerState, cfg: TrackerConfig, det_boxes, det_scores,
                   det_cls, row_col, matched, frame_id, det_emb=None) -> TrackerState:
    """KF-update every matched slot with its assigned detection."""
    frame_id = _frame_tensor(frame_id, state.status.device)
    safe_col = torch.clamp(row_col, 0, det_boxes.shape[-2] - 1)
    boxes = _take(det_boxes, safe_col)
    meas = kalman.measurement_from_xywh(boxes, fmt=cfg.kf_fmt)
    upd = kalman.update(kalman.KFState(state.kf_mean, state.kf_cov), meas, fmt=cfg.kf_fmt)
    m = matched
    shifted_hist = torch.cat([state.obs_hist[..., 1:, :], boxes[..., None, :]], dim=-2)
    shifted_frames = torch.cat(
        [state.hist_frame[..., 1:], frame_id.expand(state.hist_frame[..., :1].shape)], dim=-1
    )
    new_emb = state.emb
    if cfg.with_reid and det_emb is not None:
        feat = _l2_normalize(_take(det_emb, safe_col))
        alpha = _ema_alpha(cfg, _take(det_scores, safe_col))[..., None]
        smooth = _l2_normalize(alpha * state.emb + (1.0 - alpha) * feat)
        new_emb = torch.where(m[..., None], smooth, state.emb)
    return state._replace(
        emb=new_emb,
        kf_mean=torch.where(m[..., None], upd.mean, state.kf_mean),
        kf_cov=torch.where(m[..., None, None], upd.cov, state.kf_cov),
        status=torch.where(m, TRACKED, state.status),
        score=torch.where(m, _take(det_scores, safe_col), state.score),
        cls=torch.where(m, _take(det_cls, safe_col).to(state.cls.dtype), state.cls),
        last_frame=torch.where(m, frame_id, state.last_frame),
        hits=torch.where(m, state.hits + 1, state.hits),
        obs_box=torch.where(m[..., None], boxes, state.obs_box),
        obs_hist=torch.where(m[..., None, None], shifted_hist, state.obs_hist),
        hist_frame=torch.where(m[..., None], shifted_frames, state.hist_frame),
    )


def _spawn_new(state: TrackerState, cfg: TrackerConfig, det_boxes, det_scores,
               det_cls, spawn_mask, frame_id, det_emb=None) -> TrackerState:
    """Allocate empty slots for new tracks, preserving detection order for ID
    sequencing: each empty slot computes its rank among empty slots and
    gathers the same-ranked spawning detection. A track born on frame 1 is
    TRACKED at once, later ones TENTATIVE, chosen on the device."""
    frame_id = _frame_tensor(frame_id, state.status.device)
    k = cfg.max_tracks
    m = det_boxes.shape[-2]
    lead = det_boxes.shape[:-2]  # () for one timeline, (V,) for a video axis
    dev = det_boxes.device
    empty = state.status == EMPTY
    slot_rank = torch.cumsum(empty, dim=-1) - 1          # rank among empty slots
    spawn_rank = torch.cumsum(spawn_mask, dim=-1) - 1    # rank among spawning dets
    num_spawn = spawn_mask.sum(dim=-1)

    # rank -> detection index table (ranks >= k are dropped)
    det_of_rank = _scatter_drop(torch.full(lead + (k,), m, dtype=torch.int64, device=dev),
                                torch.where(spawn_mask, spawn_rank, k), torch.arange(m, device=dev))
    recv = empty & (slot_rank < num_spawn[..., None])
    safe_det = torch.clamp(_take(det_of_rank, torch.clamp(slot_rank, 0, k - 1)), 0, m - 1)

    boxes_new = _take(det_boxes, safe_det)
    meas = kalman.measurement_from_xywh(boxes_new, fmt=cfg.kf_fmt)
    init = kalman.initiate(meas, fmt=cfg.kf_fmt)
    new_ids = state.next_id[..., None] + slot_rank.to(torch.int32)

    status_new = torch.where(frame_id == 1, TRACKED, TENTATIVE).to(state.status.dtype)
    hist_new = torch.cat(
        [torch.zeros(lead + (k, HIST - 1, 4), dtype=boxes_new.dtype, device=dev),
         boxes_new[..., None, :]],
        dim=-2,
    )
    hist_frame_new = torch.zeros(lead + (k, HIST), dtype=torch.int32, device=dev)
    hist_frame_new[..., -1] = frame_id

    def pick(new, old):
        mask = recv.reshape(recv.shape + (1,) * (old.dim() - recv.dim()))
        return torch.where(mask, new, old)

    emb_new = state.emb
    if cfg.with_reid and det_emb is not None:
        emb_new = pick(_l2_normalize(_take(det_emb, safe_det)), state.emb)

    return state._replace(
        emb=emb_new,
        kf_mean=pick(init.mean, state.kf_mean),
        kf_cov=pick(init.cov, state.kf_cov),
        status=pick(status_new.expand_as(state.status), state.status),
        track_id=pick(new_ids, state.track_id),
        score=pick(_take(det_scores, safe_det), state.score),
        cls=pick(_take(det_cls, safe_det).to(state.cls.dtype), state.cls),
        last_frame=pick(frame_id.expand_as(state.last_frame), state.last_frame),
        start_frame=pick(frame_id.expand_as(state.start_frame), state.start_frame),
        hits=pick(torch.ones_like(state.hits), state.hits),
        obs_box=pick(boxes_new, state.obs_box),
        obs_hist=pick(hist_new, state.obs_hist),
        hist_frame=pick(hist_frame_new, state.hist_frame),
        occ=pick(torch.zeros_like(state.occ), state.occ),
        next_id=state.next_id + torch.minimum(num_spawn, empty.sum(dim=-1)).to(torch.int32),
    )


def predict_stage(state: TrackerState, cfg: TrackerConfig,
                  gmc_h: Optional[torch.Tensor]) -> TrackerState:
    """KF time update for all live tracks; non-tracked tracks get their size
    velocities zeroed (ultralytics multi_predict semantics); optional global
    motion compensation maps predicted positions through a homography."""
    live = state.status > EMPTY
    mean = state.kf_mean.clone()
    not_tracked = state.status != TRACKED
    if cfg.kf_fmt == "xyah":
        mean[..., 7] = torch.where(not_tracked, 0.0, mean[..., 7])
    else:
        mean[..., 6] = torch.where(not_tracked, 0.0, mean[..., 6])
        mean[..., 7] = torch.where(not_tracked, 0.0, mean[..., 7])
    pred = kalman.predict(kalman.KFState(mean, state.kf_cov), fmt=cfg.kf_fmt)
    new_mean = torch.where(live[..., None], pred.mean, state.kf_mean)
    new_cov = torch.where(live[..., None, None], pred.cov, state.kf_cov)

    if cfg.use_gmc and gmc_h is not None:
        # Track centers go through the camera-motion homography; its linear
        # part also maps the velocity and, for xywh, the size and its
        # velocity (ultralytics multi_gmc applies kron(eye(4), R)). The
        # factored covariance cannot hold R C R^T; those second-order terms
        # are dropped, as in the reference.
        centers = new_mean[..., :2]
        moved = apply_homography(gmc_h, centers)
        lin_t = gmc_h[..., :2, :2].transpose(-1, -2)
        vel = _matmul(new_mean[..., 4:6], lin_t)
        new_mean = new_mean.clone()
        new_mean[..., :2] = torch.where(live[..., None], moved, centers)
        new_mean[..., 4:6] = torch.where(live[..., None], vel, new_mean[..., 4:6])
        if cfg.kf_fmt == "xywh":
            wh = _matmul(new_mean[..., 2:4], lin_t)
            vwh = _matmul(new_mean[..., 6:8], lin_t)
            new_mean[..., 2:4] = torch.where(live[..., None], wh, new_mean[..., 2:4])
            new_mean[..., 6:8] = torch.where(live[..., None], vwh, new_mean[..., 6:8])
    return state._replace(kf_mean=new_mean, kf_cov=new_cov)


def byte_associate(state: TrackerState, cfg: TrackerConfig, det_boxes, det_scores,
                   det_cls, det_valid, frame_id, det_emb=None):
    """The BYTE two-stage association schedule; returns the updated state."""
    m = det_boxes.shape[-2]
    high = det_valid & (det_scores >= cfg.track_high_thresh)
    low = det_valid & (det_scores > cfg.track_low_thresh) & (det_scores < cfg.track_high_thresh)

    # ---- stage 1: tracked + lost vs high-confidence detections
    pool = (state.status == TRACKED) | (state.status == LOST)
    iou_d = _iou_cost(state, cfg, det_boxes)
    cost1 = _fused(iou_d, det_scores, cfg.fuse_score)
    if cfg.with_reid and det_emb is not None:
        # BoT-SORT appearance fusion: halved cosine distance, gated by
        # appearance and IoU proximity, min-combined with the motion cost
        emb_d = _emb_distance(state.emb, _l2_normalize(det_emb)) / 2.0
        emb_d = torch.where(emb_d > cfg.appearance_thresh, 1.0, emb_d)
        emb_d = torch.where(iou_d > cfg.proximity_thresh, 1.0, emb_d)
        cost1 = torch.minimum(cost1, emb_d)
    col1, m1 = masked_assignment(cost1, pool, high, cfg.match_thresh)
    state = _apply_matches(state, cfg, det_boxes, det_scores, det_cls, col1, m1,
                           frame_id, det_emb)
    det_used = _scatter_drop(torch.zeros_like(det_valid), torch.where(m1, col1, m), True)

    # ---- stage 2: still-unmatched TRACKED vs low-confidence detections
    r_tracked = (state.status == TRACKED) & ~m1 & (state.last_frame < frame_id)
    cost2 = _iou_cost(state, cfg, det_boxes)
    col2, m2 = masked_assignment(cost2, r_tracked, low & ~det_used, cfg.second_match_thresh)
    state = _apply_matches(state, cfg, det_boxes, det_scores, det_cls, col2, m2, frame_id)
    det_used = _scatter_drop(det_used, torch.where(m2, col2, m), True)

    # tracked tracks that matched nothing this frame -> lost
    went_lost = (state.status == TRACKED) & (state.last_frame < frame_id)
    state = state._replace(status=torch.where(went_lost, LOST, state.status))

    # ---- stage 3: tentative (unconfirmed) vs remaining high dets
    unconfirmed = state.status == TENTATIVE
    cost3 = _fused(_iou_cost(state, cfg, det_boxes), det_scores, cfg.fuse_score)
    col3, m3 = masked_assignment(cost3, unconfirmed, high & ~det_used, cfg.tentative_match_thresh)
    state = _apply_matches(state, cfg, det_boxes, det_scores, det_cls, col3, m3, frame_id)
    det_used = _scatter_drop(det_used, torch.where(m3, col3, m), True)

    # unmatched tentative tracks are dropped
    drop_tentative = (state.status == TENTATIVE) & (state.last_frame < frame_id)
    state = state._replace(status=torch.where(drop_tentative, EMPTY, state.status))

    # ---- new tracks from remaining high dets above the init threshold
    spawn = high & ~det_used & (det_scores >= cfg.new_track_thresh)
    state = _spawn_new(state, cfg, det_boxes, det_scores, det_cls, spawn, frame_id, det_emb)

    # ---- prune expired lost tracks
    expired = (state.status == LOST) & (frame_id - state.last_frame > cfg.track_buffer)
    return state._replace(status=torch.where(expired, EMPTY, state.status))


def frame_output(state: TrackerState, cfg: TrackerConfig, frame_id) -> FrameOutput:
    """Every slot's output; valid where the track is tracked and matched in
    this frame."""
    return FrameOutput(
        track_id=state.track_id,
        box_xywh=_track_boxes(state, cfg),
        score=state.score,
        cls=state.cls,
        valid=(state.status == TRACKED) & (state.last_frame == frame_id),
    )


def byte_step(state: TrackerState, det_boxes, det_scores, det_cls, det_valid,
              frame_id, cfg: TrackerConfig, gmc_h=None, det_emb=None):
    """One tracker frame: predict -> associate -> emit active tracks.
    ``frame_id`` is a 0-dim integer tensor (the chunk step's ids, on the
    device) or a Python int; like the reference's step, this one reads
    nothing back to the host: its branches are device selects and its three
    auctions run on the device."""
    frame_id = _frame_tensor(frame_id, state.status.device)
    state = predict_stage(state, cfg, gmc_h)
    state = byte_associate(state, cfg, det_boxes, det_scores, det_cls, det_valid,
                           frame_id, det_emb)
    return state, frame_output(state, cfg, frame_id)


def make_tracker(name: str, params: dict, max_tracks: int = 256, device="cuda"):
    """Build (cfg, init_state, step_fn) for a named tracker from its config
    block (cfg tracker.<name>). Step signature:
        state, out = step(state, boxes, scores, cls, valid, frame_id, gmc_h, det_emb)
    """
    name = name.lower()
    common = dict(
        track_high_thresh=float(params.get("track_high_thresh", 0.25)),
        track_low_thresh=float(params.get("track_low_thresh", 0.1)),
        new_track_thresh=float(params.get("new_track_thresh", 0.25)),
        track_buffer=int(params.get("track_buffer", 30)),
        match_thresh=float(params.get("match_thresh", 0.8)),
        fuse_score=bool(params.get("fuse_score", True)),
        max_tracks=max_tracks,
    )
    reid = dict(
        with_reid=bool(params.get("with_reid", False)),
        proximity_thresh=float(params.get("proximity_thresh", 0.5)),
        appearance_thresh=float(params.get("appearance_thresh", 0.8)),
    )
    step = byte_step
    if name == "bytetrack":
        cfg = TrackerConfig(kf_fmt="xyah", use_gmc=False, **common)
    elif name == "botsort":
        use_gmc = params.get("gmc_method", "sparseOptFlow") not in (None, "none", "None")
        cfg = TrackerConfig(kf_fmt="xywh", use_gmc=use_gmc, **common, **reid)
    elif name in ("ocsort", "deepocsort"):
        from geotrax_tpu_torch.track.ocsort import make_ocsort_step

        cfg, step = make_ocsort_step(params, common, deep=(name == "deepocsort"))
    elif name == "fasttrack":
        from geotrax_tpu_torch.track.fasttrack import make_fasttrack_step

        cfg, step = make_fasttrack_step(params, common)
    elif name == "tracktrack":
        from geotrax_tpu_torch.track.tracktrack import make_tracktrack_step

        cfg, step = make_tracktrack_step(params, common)
    else:
        raise ValueError(f"Unknown tracker '{name}'")

    def step_fn(state, boxes, scores, cls, valid, frame_id, gmc_h=None, det_emb=None):
        return step(state, boxes, scores, cls, valid, frame_id, cfg, gmc_h, det_emb)

    return cfg, init_state(cfg, device), step_fn


# Trackers whose step runs on a leading video axis as one batched step (the
# BYTE family through byte_step); the others step their live videos one by
# one behind the same interface (ROADMAP queues their batching).
BATCHED_TRACKERS = ("botsort", "bytetrack")


def stack_states(state: TrackerState, num_videos: int) -> TrackerState:
    """``num_videos`` copies of one timeline's state on a leading axis."""
    return TrackerState(*(t.expand((num_videos,) + t.shape).clone() for t in state))


def _frozen(new: TrackerState, old: TrackerState, alive: torch.Tensor) -> TrackerState:
    """``new`` where the video is alive, ``old`` (its state unchanged) where
    it has ended."""
    return TrackerState(*(
        torch.where(alive.reshape(alive.shape + (1,) * (n.dim() - 1)), n, o)
        for n, o in zip(new, old)))


def make_batch_tracker(name: str, params: dict, num_videos: int, max_tracks: int = 256,
                       device="cuda"):
    """Build (cfg, states, vstep) for ``num_videos`` timelines of a named
    tracker, the counterpart of the reference's ``vmap`` of the step
    (``geotrax_tpu/parallel/extract_batch.py:tracker_vstep``):

        states, out = vstep(states, boxes, scores, cls, valid, frame_id,
                            alive, gmc_h=None, det_emb=None)

    with (V, M, ...) detections, (V,) bool ``alive``, (V, 3, 3) GMC and
    (V, M, EMB_DIM) embeddings; ``out`` is a (V, K, ...) FrameOutput. A
    video that has ended (``alive`` False) keeps its state and has no valid
    output. botsort and bytetrack run one batched ``byte_step`` (one
    auction per association stage for the group); the other trackers run
    their own step on each live video."""
    name = name.lower()
    cfg, state0, step = make_tracker(name, params, max_tracks=max_tracks, device=device)
    states = stack_states(state0, num_videos)

    if name in BATCHED_TRACKERS:
        def vstep(states, boxes, scores, cls, valid, frame_id, alive, gmc_h=None, det_emb=None):
            new, out = step(states, boxes, scores, cls, valid, frame_id, gmc_h, det_emb)
            return _frozen(new, states, alive), out._replace(valid=out.valid & alive[:, None])
        return cfg, states, vstep

    def vstep(states, boxes, scores, cls, valid, frame_id, alive, gmc_h=None, det_emb=None):
        new, outs = [], []
        for v, live in enumerate(alive.tolist()):
            state = TrackerState(*(t[v] for t in states))
            if live:
                state, out = step(state, boxes[v], scores[v], cls[v], valid[v], frame_id,
                                  None if gmc_h is None else gmc_h[v],
                                  None if det_emb is None else det_emb[v])
            else:
                out = frame_output(state, cfg, frame_id)
                out = out._replace(valid=torch.zeros_like(out.valid))
            new.append(state)
            outs.append(out)
        return (TrackerState(*(torch.stack(f) for f in zip(*new))),
                FrameOutput(*(torch.stack(f) for f in zip(*outs))))
    return cfg, states, vstep
