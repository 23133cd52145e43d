"""Lockstep multi-video extraction: V videos of one resolution advance
together, one frame of each per step. The port of
``geotrax_tpu/parallel/extract_batch.py``, which ``batch --parallel-videos
N`` runs:

  one upload of the live videos' frames (a pinned staging buffer; frames
  a reader gives on the card already are copied there, ``Staging.put``)
    -> one batched detection                     (V frames per call)
    -> one batched single-level stabilization    (one FAST launch over the
       against each video's reference frame       V grays, RANSAC keyed
                                                  per video)
    -> with ReID, one patch gather               (``patches32_hwc`` on the V
                                                  uint8 (H, W, 3) frames, the
                                                  2x2 pool in the kernel)
    -> one tracker step over V timelines         (``make_batch_tracker``)

A video that ends drops out of the live set and the rest go on in lockstep;
its tracker state and its RANSAC key stay as they were. Each video's rows
are post-processed and written by the extract stage's own functions, with
``extraction_mode: parallel-group-V`` in its metadata.

RANSAC draws follow the reference's lockstep keys, not the sequential
``Stabilizer``'s: video ``v`` starts from ``split(PRNGKey(0), V)[v]`` and
each later step replaces a live video's key by ``split(key)[0]``. With
stabilization off every video's files equal those of the sequential
per-frame loop run on it alone.

``devices`` (``batch --devices D``) splits the video axis into D
contiguous sub-groups when V is divisible by D; sub-group d's tracker state
and its tracker step live on device d. Detection and stabilization stay on
the first device, as in the reference, where only the tracker state is
sharded; no information crosses videos, so no collective is needed.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import record_function

from geotrax_tpu_torch._device import resolve_device
from geotrax_tpu_torch.ops import features, prng
from geotrax_tpu_torch.ops.ransac import ransac_fit
from geotrax_tpu_torch.ops.sift import match_l2
from geotrax_tpu_torch.pipeline import extract as stage
from geotrax_tpu_torch.pipeline.device_pipeline import _transform_boxes_h, embed_boxes, gmc_from_h
from geotrax_tpu_torch.stabilize.stabilizer import Stabilizer
from geotrax_tpu_torch.track.base import EMB_DIM, make_batch_tracker
from geotrax_tpu_torch.track.reid import resolve_head
from geotrax_tpu_torch.utils.config_utils import backfill_args_from_config
from geotrax_tpu_torch.utils.file_utils import get_output_dir


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, D) rows at (B, K) indices -> (B, K, D)."""
    return torch.gather(x, 1, idx[..., None].expand(idx.shape + x.shape[-1:]))


def mask_boxes(boxes: torch.Tensor, valid: torch.Tensor, slots: int) -> torch.Tensor:
    """(B, M, 4) detections -> (B, min(M, slots), 4): each frame's valid
    boxes first, in detection order, the rest zero (the reference's fixed
    box-mask slots)."""
    order = torch.sort((~valid).to(torch.int8), dim=-1, stable=True).indices[..., :slots]
    kept = _gather_rows(boxes[..., :4], order)
    return torch.where(torch.gather(valid, -1, order)[..., None], kept, 0.0)


class BatchStabilizer:
    """V single-level Stabilizer pipelines batched over the live videos:
    per-video reference features and RANSAC keys, one pass of gray, mask,
    FAST, grid descriptors, ``match_l2`` and RANSAC per step."""

    def __init__(self, num_videos: int, stabilo_cfg: dict, device="cuda"):
        self.num_videos = num_videos
        # one prototype supplies the configuration and the reference frames'
        # features; per-video state lives in the stacked tensors below
        self.proto = Stabilizer(**stabilo_cfg, device=device)
        if self.proto.n_levels != 1:
            raise ValueError("BatchStabilizer supports the single-level (orb-class) path")
        self.device = self.proto.device
        self.mask_slots = self.proto.mask_slots
        self._ref = None     # stacked (xy, desc, valid)
        self._keys = None    # (V, 2) threefry keys

    def set_ref_frames(self, frames: torch.Tensor, boxes_per_video) -> None:
        """frames: (V,H,W,3) uint8; boxes_per_video: V (Ni,4) host arrays."""
        refs = [self.proto._prepare(frames[v], boxes_per_video[v], self.proto.ref_features)
                for v in range(self.num_videos)]
        self._ref = tuple(torch.stack(parts) for parts in zip(
            *((kps.xy, desc, kps.valid) for kps, desc in refs)))
        self._keys = prng.split(prng.PRNGKey(0), self.num_videos)

    def stabilize_batch(self, frames: torch.Tensor, boxes_padded: torch.Tensor,
                        video_idx=None) -> tuple:
        """frames (L,H,W,3) uint8 of the videos ``video_idx`` (default: all),
        boxes_padded (L, slots, 4) -> (cur->ref homographies (L,3,3) float64,
        inliers (L,), matches (L,)) on the host; a video with fewer than 4
        matches or a degenerate fit gets the identity and 0 inliers."""
        p = self.proto
        idx = list(range(self.num_videos)) if video_idx is None else list(video_idx)
        keys = prng.split(self._keys[idx])[:, 0]
        self._keys[idx] = keys
        ref_xy, ref_desc, ref_valid = (t[idx] for t in self._ref)
        gray = features.downsample(features.rgb_to_gray(frames), p.downsample_ratio)
        if p.clahe:
            from geotrax_tpu_torch.ops.clahe import clahe

            gray = clahe(gray)
        mask = (features.boxes_mask(gray.shape[-2:], boxes_padded * p.downsample_ratio,
                                    p.mask_margin_ratio) if p.mask_use else None)
        kps = features.fast_detect(gray, p.max_features, mask=mask, oriented=False)
        desc = features.describe_grid(gray, kps)
        matches = match_l2(desc, kps.valid, ref_desc, ref_valid, ratio=p.filter_ratio)
        result = ransac_fit(_gather_rows(kps.xy, matches.idx_a),
                            _gather_rows(ref_xy, matches.idx_b), matches.valid,
                            threshold=p.ransac_threshold, key=keys,
                            num_hypotheses=p.num_hypotheses, transformation=p._transformation())
        h_ds = result.h_matrix.cpu().numpy()
        inliers = result.num_inliers.cpu().numpy()
        n_matches = matches.valid.sum(dim=-1).cpu().numpy()
        s = p.downsample_ratio
        scale = np.diag([s, s, 1.0])
        h_full = np.einsum("ij,vjk,kl->vil", np.linalg.inv(scale), h_ds, scale)
        denom = h_full[:, 2, 2]
        ok = ((n_matches >= 4) & np.isfinite(h_full).all(axis=(1, 2))
              & (np.abs(denom) > 1e-12))
        h_full = np.where(ok[:, None, None], h_full / np.where(ok, denom, 1.0)[:, None, None],
                          np.eye(3)[None])
        return h_full, np.where(ok, inliers, 0), n_matches


def device_groups(num_videos: int, requested, device: torch.device, devices=None,
                  logger=None) -> list:
    """[(device, [video indices])]: the video axis split over
    ``n = min(requested, len(devices), num_videos)`` devices when
    ``num_videos`` is divisible by n, else one group on ``device``.
    ``devices`` defaults to every card (on the CPU: ``requested`` CPU
    devices, so that a CPU run splits as the card's would)."""
    n_dev = int(requested or 1)
    if n_dev > 1:
        if devices is None:
            devices = ([torch.device(f"cuda:{i}") for i in range(torch.cuda.device_count())]
                       if device.type == "cuda" else [device] * n_dev)
        n_dev = min(n_dev, len(devices), num_videos)
        if n_dev > 1 and num_videos % n_dev == 0:
            size = num_videos // n_dev
            if logger:
                logger.info(f"Video group sharded over {n_dev} devices.")
            return [(torch.device(devices[d]), list(range(d * size, (d + 1) * size)))
                    for d in range(n_dev)]
        if logger:
            logger.warning(f"--devices {n_dev}: group of {num_videos} videos not divisible; "
                           "running single-device.")
    return [(device, list(range(num_videos)))]


def extract_videos_batch(sources: list, args, config: dict, logger, devices=None) -> dict:
    """Extract a group of same-resolution videos in lockstep and write each
    video's files (the extract stage's). ``config`` is ``load_config_all``'s
    split configuration; ``devices`` overrides the device list that
    ``args.devices`` splits the tracker over. Returns the run's stats:
    ``steps``, ``step_s`` (wall seconds per step, outputs read back),
    ``frames`` per video, ``fps`` (aggregate) and ``videos`` (each video's
    write_outputs stats)."""
    main = config["main"]
    stabilize_on = bool(main["extraction"].get("stabilize", True))
    device = resolve_device(stage._device(config))
    detector = stage.load_detector(config, logger)
    max_det = int(config["ultralytics"].get("max_det", 1000) or 1000)

    # run_extraction's backfill, so that cut frames, interpolation and the
    # output folder are the configured ones for every video of a batch run
    backfill_args_from_config(args, {
        "cut_frame_left": main["processing"]["cut_frame_left"],
        "cut_frame_right": main["processing"]["cut_frame_right"],
        "interpolate": main["extraction"]["interpolate"],
        "output_folder": main["output"]["folder"],
    })
    cut_left = int(args.cut_frame_left or 0)
    readers = [stage.open_reader(s, cut_left, args.cut_frame_right, config) for s in sources]
    iters = [iter(r) for r in readers]
    num_videos = len(sources)

    groups = device_groups(num_videos, getattr(args, "devices", None), device, devices, logger)
    max_tracks = max(256, min(max_det, 1024))
    trackers = [make_batch_tracker(main["tracker_active"], main["tracker_params"], len(vids),
                                   max_tracks=max_tracks, device=dev) for dev, vids in groups]
    states = [states for _, states, _ in trackers]
    tracker_cfg = trackers[0][0]
    use_gmc, with_reid = bool(tracker_cfg.use_gmc), bool(tracker_cfg.with_reid)
    head = None
    if with_reid:
        params = resolve_head(main["tracker_params"], logger)
        head = None if params is None else {k: v.to(device) for k, v in params.items()}

    stab = BatchStabilizer(num_videos, config.get("stabilo", {}), device) if stabilize_on else None
    mask_slots = stab.mask_slots if stab is not None else 1024
    info = readers[0].info
    staging = stage.Staging(num_videos, int(info.height), int(info.width), device)

    rows = [[] for _ in range(num_videos)]
    transforms = [[] for _ in range(num_videos)]
    h_prev = [np.eye(3) for _ in range(num_videos)]
    alive = [True] * num_videos
    n_frames = [0] * num_videos
    frame_idx, first, step_s = cut_left, True, []
    t_start = time.perf_counter()
    with torch.no_grad():
        while any(alive):
            t0 = time.perf_counter()
            frames, live = [], []  # the next frame of every video still going
            for v in range(num_videos):
                if not alive[v]:
                    continue
                try:
                    with staging.streamed():
                        idx, frame = next(iters[v])
                except StopIteration:
                    alive[v] = False
                    continue
                assert idx == frame_idx, f"video {v} desynchronized"
                frames.append(frame)
                live.append(v)
            if not live:
                break
            n_live = len(live)
            slot = len(step_s) % 2
            with record_function("lock.upload"):
                staging.wait_uploaded(slot)  # the slot's last upload has left it
                staging.put(slot, frames)
                stacked = staging.frames(slot)[:n_live]
            with record_function("lock.detect"):
                det = detector.detect_batch(stacked)
            boxes, valid = det["boxes_xywh"], det["valid"]

            h_cur = {v: np.eye(3) for v in live}
            if stab is not None:
                with record_function("lock.stabilize"):
                    padded = mask_boxes(boxes, valid, mask_slots)
                    if first:
                        if n_live < num_videos:
                            # a video with no frame: the reference features would be misaligned
                            raise RuntimeError("video group ragged at the first frame")
                        host = padded.cpu().numpy()
                        stab.set_ref_frames(stacked, [b[b[:, 2] > 0] for b in host])
                    else:
                        h_arr, inliers, _ = stab.stabilize_batch(stacked, padded, live)
                        for p, v in enumerate(live):
                            h_cur[v] = h_arr[p]
                            if inliers[p] == 0:
                                logger.warning(f"Frame {frame_idx}, video {v}: stabilization "
                                               "failed; identity used.")
                            transforms[v].append(
                                np.concatenate([[frame_idx], h_arr[p].reshape(-1)]))

            with record_function("lock.reid"):
                emb = (embed_boxes(stacked, boxes, head_params=head) if with_reid else None)
            with record_function("lock.tracker"):
                # the live detections scattered into full-V tensors (ended videos: none valid)
                md = boxes.shape[1]
                live_t = torch.as_tensor(live, device=device)
                full_b = boxes.new_zeros((num_videos, md, 4)).index_copy_(0, live_t, boxes)
                full_s = det["scores"].new_zeros((num_videos, md)).index_copy_(
                    0, live_t, det["scores"])
                full_c = torch.full((num_videos, md), -1, dtype=det["classes"].dtype,
                                    device=device).index_copy_(0, live_t, det["classes"])
                full_v = valid.new_zeros((num_videos, md)).index_copy_(0, live_t, valid)
                full_e = (torch.zeros((num_videos, md, EMB_DIM), device=device).index_copy_(
                    0, live_t, emb) if with_reid else None)
                alive_mask = torch.zeros((num_videos,), dtype=torch.bool, device=device)
                alive_mask[live_t] = True
                h_live = torch.as_tensor(np.stack([h_cur[v] for v in live]), dtype=torch.float32,
                                         device=device)
                gmc = torch.eye(3, device=device).repeat(num_videos, 1, 1)
                if not first:
                    # the same float32 program as the sequential and fused paths
                    h_before = torch.as_tensor(np.stack([h_prev[v] for v in live]),
                                               dtype=torch.float32, device=device)
                    gmc[live_t] = gmc_from_h(h_live, h_before)
                for v in live:
                    h_prev[v] = h_cur[v]

                outs = []
                internal_frame = frame_idx - cut_left + 1
                for g, (dev, vids) in enumerate(groups):
                    sel = (lambda t: t) if len(groups) == 1 else (lambda t: t[vids].to(dev))
                    states[g], out = trackers[g][2](
                        states[g], sel(full_b), sel(full_s), sel(full_c), sel(full_v),
                        internal_frame, sel(alive_mask), sel(gmc) if use_gmc else None,
                        sel(full_e) if with_reid else None)
                    outs.append(out)
                out = (outs[0] if len(groups) == 1 else
                       type(outs[0])(*(torch.cat([t.to(device) for t in f]) for f in zip(*outs))))
            with record_function("lock.rows"):
                cols = [out.valid[live_t], out.track_id[live_t], out.cls[live_t],
                        out.score[live_t], out.box_xywh[live_t]]
                if stabilize_on and not first:
                    cols.append(_transform_boxes_h(h_live, out.box_xywh[live_t]))
                host = [t.cpu().numpy() for t in cols]
                for p, v in enumerate(live):
                    ok = host[0][p]
                    ids, classes, scores, kf_boxes = (h[p][ok] for h in host[1:5])
                    head_cols = [np.full(len(ids), frame_idx, float), ids.astype(float), kf_boxes]
                    if stabilize_on:
                        head_cols.append(kf_boxes if first else host[5][p][ok])
                    rows[v].append(np.column_stack(head_cols + [classes.astype(float), scores]))
                    n_frames[v] += 1
            staging.done(slot)
            first = False
            frame_idx += 1
            step_s.append(time.perf_counter() - t0)

    elapsed = max(time.perf_counter() - t_start, 1e-9)
    total = sum(n_frames)
    logger.info(f"Parallel extraction: {total} frames over {num_videos} videos "
                f"({total / elapsed:.1f} frames/s aggregate).")

    # per-video post-processing and files through the extract stage's functions
    flat = stage.flat_config(config)
    flat["output"] = {**main["output"], "folder": args.output_folder}
    n_cols = 12 if stabilize_on else 8
    videos = []
    for v, source in enumerate(sources):
        tracks = np.concatenate(rows[v], axis=0) if rows[v] else np.empty((0, n_cols))
        transforms_arr = np.asarray(transforms[v]) if transforms[v] else np.empty((0, 10))
        info = readers[v].info
        stats = {
            "frames": n_frames[v],
            "avg_detect_ms": 0.0, "avg_stab_ms": 0.0,
            "fps": total / elapsed / max(num_videos, 1),
            "frame_size": (int(info.width), int(info.height)),
            "video_fps": float(info.fps),
            "extraction_mode": f"parallel-group-{num_videos}",
        }
        video_args = argparse.Namespace(**{**vars(args), "source": source})
        videos.append(stage.write_outputs(
            tracks, transforms_arr, stats, flat, get_output_dir(Path(source), flat["output"]),
            Path(source).stem, source=source, args=vars(video_args),
            interpolate=bool(args.interpolate), logger=logger))
    return {"steps": len(step_s), "step_s": step_s, "frames": n_frames,
            "fps": total / elapsed, "wall_s": elapsed, "videos": videos}
