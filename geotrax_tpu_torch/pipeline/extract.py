"""Row emission and the two text files of ``geotrax extract``, fed by the
fused chunk step.

Counterpart of ``geotrax_tpu/pipeline/_extract_impl.py``'s
``_track_video_fused`` (:356-491) and the tracks / transforms files of
``save_results`` (:530-549), with the same columns and formats:

  <out>/<stem><tracks_postfix>.txt   frame, id, box (4), stabilized box (4),
                                     class, score — ``%g``, comma separated
  <out>/<stem><stab_postfix>.txt     frame + row-major 3x3 cur->ref
                                     homography — ``%.16g``

``make_extract_tracker`` and ``make_fused_extractor`` build the tracker
(with the learned ReID head that ``tracker.<active>.model`` names) and the
chunk step as ``_extract_impl.py:make_extract_tracker`` (:105-126) and
``make_fused_extractor`` (:131-145) do.

The YAML metadata file, the track post-processing, the CLI, video decoding
and the sequential per-frame path wait for later slices of the port
(ROADMAP A10), and so does extraction with stabilization off (ROADMAP A13).
"""

from __future__ import annotations

import logging
import time
from pathlib import Path

import numpy as np
import torch

from geotrax_tpu_torch.cfg import DEFAULT, select_tracker
from geotrax_tpu_torch.pipeline.device_pipeline import FusedExtractor
from geotrax_tpu_torch.track import make_tracker
from geotrax_tpu_torch.track.reid import resolve_head

# One chunk per fused dispatch (the JAX package's _extract_impl.FUSED_CHUNK).
FUSED_CHUNK = 32

_LOG = logging.getLogger("geotrax")


def make_extract_tracker(config: dict, device="cuda", logger=_LOG):
    """Tracker construction as the extract stage performs it:
    (tracker_cfg, tracker_state, tracker_step, reid_params) with max_tracks =
    max(256, min(max_det, 1024)). With ReID on, ``reid_params`` is the
    learned head that ``tracker.<active>.model`` names (track/reid.py), or
    None to embed by projection (``model: auto``, or a missing or malformed
    file, with a warning)."""
    name, params = select_tracker(config["tracker"])
    max_det = int(config["ultralytics"].get("max_det", 1000) or 1000)
    tracker_cfg, state, step = make_tracker(name, params, max_tracks=max(256, min(max_det, 1024)),
                                            device=device)
    reid_params = resolve_head(params, logger) if tracker_cfg.with_reid else None
    return tracker_cfg, state, step, reid_params


def make_fused_extractor(config: dict, detector, tracker_cfg, tracker_state, tracker_step,
                         src_h: int, src_w: int, reid_params=None, chunk: int = FUSED_CHUNK,
                         rng_seed: int = 0, device="cuda") -> FusedExtractor:
    """The FusedExtractor as the extract stage builds it: the ``stabilo``
    section, the tracker's GMC and ReID flags and the learned head."""
    extraction = config.get("extraction", DEFAULT["extraction"])
    if not extraction.get("stabilize", True):
        raise NotImplementedError("extraction with stabilize: false is not ported yet (ROADMAP A13)")
    return FusedExtractor(
        detector, config.get("stabilo", DEFAULT["stabilo"]), tracker_step, tracker_state,
        src_h, src_w, use_gmc=tracker_cfg.use_gmc, chunk=chunk, rng_seed=rng_seed,
        with_reid=tracker_cfg.with_reid, reid_params=reid_params, device=device,
    )


def track_video_fused(reader, fx, cut_left: int = 0, chunk: int = FUSED_CHUNK) -> tuple:
    """Drive ``fx`` (a FusedExtractor) over ``reader``'s (index, frame)
    pairs, one chunk at a time; returns (tracks rows, transform rows,
    stats). The tail chunk is padded with its last frame to the chunk size,
    as the JAX package pads it to its compiled shape."""
    min_match_warning = 4
    rows, transforms, hs, matches, inliers = [], [], [], [], []
    n_frames = 0
    chunk_s = []
    t_start = time.perf_counter()

    def run(buf):
        nonlocal n_frames
        n = len(buf)
        idxs = [i for i, _ in buf]
        frames = np.stack([f for _, f in buf])
        if n < chunk:
            frames = np.concatenate([frames, np.repeat(frames[-1:], chunk - n, axis=0)], axis=0)
            idxs = idxs + [idxs[-1]] * (chunk - n)
        fids = np.asarray(idxs, np.int64) - cut_left + 1
        t0 = time.perf_counter()
        out = fx.process_chunk(frames, fids, n)
        out = type(out)(*(t.cpu().numpy() for t in out))
        chunk_s.append(time.perf_counter() - t0)
        hs.append(out.h[:n])
        matches.append(out.matches[:n])
        inliers.append(out.inliers[:n])

        for i in range(n):
            frame_idx = idxs[i]
            valid = out.valid[i]
            ids = out.track_id[i][valid]
            boxes = out.box_xywh[i][valid]
            scores = out.score[i][valid]
            classes = out.cls[i][valid]
            if frame_idx > cut_left:
                if out.matches[i] < min_match_warning:
                    _LOG.warning(f"Frame {frame_idx}: stabilization failed; identity used.")
                transforms.append(np.concatenate([[frame_idx], out.h[i].reshape(-1)]))
            # ref frame: stabilized box = raw box by definition
            boxes_stab = boxes if frame_idx == cut_left else out.box_stab[i][valid]
            rows.append(np.column_stack([
                np.full(len(ids), frame_idx, float), ids.astype(float),
                boxes, boxes_stab, classes.astype(float), scores,
            ]))
            n_frames += 1

    buf = []
    for item in reader:
        buf.append(item)
        if len(buf) == chunk:
            run(buf)
            buf = []
    if buf:
        run(buf)

    elapsed = max(time.perf_counter() - t_start, 1e-9)
    stats = {
        "frames": n_frames,
        "chunks": len(chunk_s),
        "chunk_s": chunk_s,
        "h": np.concatenate(hs) if hs else np.empty((0, 3, 3)),
        "matches": np.concatenate(matches) if matches else np.empty((0,), np.int32),
        "inliers": np.concatenate(inliers) if inliers else np.empty((0,), np.int32),
        "fps": n_frames / elapsed,
        "frame_size": (reader.info.width, reader.info.height),
        "video_fps": reader.info.fps,
    }
    tracks = np.concatenate(rows, axis=0) if rows else np.empty((0, 12))
    transforms_arr = np.asarray(transforms) if transforms else np.empty((0, 10))
    return tracks, transforms_arr, stats


def save_results(tracks: np.ndarray, transforms: np.ndarray, out_dir, stem: str,
                 tracks_postfix: str = "", stab_postfix: str = "_vid_transf",
                 save_stab: bool = True) -> tuple:
    """Write ``<stem><tracks_postfix>.txt`` (``%g``) and
    ``<stem><stab_postfix>.txt`` (``%.16g``) into ``out_dir``; returns the
    two paths (a file with no rows is not written, as in the reference)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    tracks_file = out_dir / f"{stem}{tracks_postfix}.txt"
    transf_file = out_dir / f"{stem}{stab_postfix}.txt"
    if tracks.size:
        np.savetxt(tracks_file, tracks, fmt="%g", delimiter=",")
    if transforms.size and save_stab:
        frame_nums = transforms[:, 0].astype(int)
        matrices = transforms[:, 1:].reshape(-1, 3, 3)
        if len(frame_nums) and not np.all(np.diff(frame_nums) == 1):
            _LOG.warning(f"Missing frame ids found in: '{transf_file}'.")
        if len(matrices) and not np.all(np.linalg.det(matrices) > 0):
            _LOG.warning(f"Invalid transforms found in: '{transf_file}'.")
        np.savetxt(transf_file, transforms, fmt="%.16g", delimiter=",")
    return tracks_file, transf_file


def extract(reader, fx, out_dir, stem: str, config: dict | None = None,
            cut_left: int = 0, chunk: int = FUSED_CHUNK) -> dict:
    """The fused extract of one frame source into ``out_dir``: tracks and
    transforms files named after ``stem``. ``config`` supplies the
    ``extraction`` and ``output`` keys (defaults: the port's ``cfg.DEFAULT``).
    Returns the run's stats with the two file paths."""
    config = config or DEFAULT
    extraction = config.get("extraction", DEFAULT["extraction"])
    output = config.get("output", {})
    if not extraction.get("stabilize", True):
        raise NotImplementedError("extraction with stabilize: false is not ported yet (ROADMAP A13)")
    tracks, transforms, stats = track_video_fused(reader, fx, cut_left=cut_left, chunk=chunk)
    tracks_file, transf_file = save_results(
        tracks, transforms, out_dir, stem,
        tracks_postfix=output.get("tracks_postfix", ""),
        stab_postfix=output.get("stab_transform_postfix", "_vid_transf"),
        save_stab=bool(extraction.get("save_stab", True)),
    )
    stats.update(tracks_file=tracks_file, transforms_file=transf_file,
                 n_rows=len(tracks), n_transforms=len(transforms))
    if torch.cuda.is_available() and fx.device.type == "cuda":
        stats["device"] = torch.cuda.get_device_name(fx.device)
    return stats
