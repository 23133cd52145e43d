"""Row emission, post-processing and the files of ``geotrax extract``, fed
by the fused chunk step.

Counterpart of ``geotrax_tpu/pipeline/_extract_impl.py``'s
``_track_video_fused`` (:356-491), the post-processing of ``run_extraction``
(:514-527) and ``save_results`` (:530-589), with the same columns, formats
and keys:

  <out>/<stem><tracks_postfix>.txt   frame, id, box (4), stabilized box (4),
                                     class (the track's vote), score,
                                     length, width (+ is_interpolated with
                                     ``interpolate``) — ``%g``, comma
                                     separated; tracks shorter than
                                     ``min_track_length`` removed
  <out>/<stem><stab_postfix>.txt     frame + row-major 3x3 cur->ref
                                     homography — ``%.16g``
  <source>.yaml                      the run's metadata next to the source

``make_extract_tracker`` and ``make_fused_extractor`` build the tracker
(with the learned ReID head that ``tracker.<active>.model`` names) and the
chunk step as ``_extract_impl.py:make_extract_tracker`` (:105-126) and
``make_fused_extractor`` (:131-145) do.

The CLI, video decoding, the double-buffered dispatch and the sequential
per-frame path wait for later slices of the port (ROADMAP A10), and so
does extraction with stabilization off (ROADMAP A13).
"""

from __future__ import annotations

import logging
import time
from pathlib import Path

import numpy as np
import torch

from geotrax_tpu_torch import __version__
from geotrax_tpu_torch.cfg import DEFAULT, select_tracker
from geotrax_tpu_torch.io import yaml_emit
from geotrax_tpu_torch.pipeline import postprocess
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
    as the JAX package pads it to its compiled shape. ``avg_detect_ms`` is
    the time per frame of the chunk steps and the copies of their outputs to
    the host, as the reference's fused path counts its device time;
    ``avg_stab_ms`` is 0 (stabilization runs inside the chunk step)."""
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
        "avg_detect_ms": sum(chunk_s) * 1e3 / max(n_frames, 1),
        "avg_stab_ms": 0.0,
        "chunks": len(chunk_s),
        "chunk_s": chunk_s,
        "h": np.concatenate(hs) if hs else np.empty((0, 3, 3)),
        "matches": np.concatenate(matches) if matches else np.empty((0,), np.int32),
        "inliers": np.concatenate(inliers) if inliers else np.empty((0,), np.int32),
        "fps": n_frames / elapsed,
        "frame_size": (int(reader.info.width), int(reader.info.height)),
        "video_fps": float(reader.info.fps),
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


def _serializable(obj):
    """Paths as str and tuples as lists, recursively (the reference's
    ``convert_to_serializable`` for the types a mapping of arguments
    holds)."""
    if isinstance(obj, Path):
        return str(obj)
    if isinstance(obj, dict):
        return {k: _serializable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_serializable(v) for v in obj]
    return obj


def run_metadata(config: dict, stats: dict, source, args: dict) -> dict:
    """The metadata ``save_results`` writes beside the source, with the
    reference's keys in its order: the port's version, the source's size and
    frame rate, the run's times, the configuration (model, tracker, the
    ``extraction`` and ``stabilo`` sections and the detection keys) and the
    run's arguments. ``model`` is the ``model`` argument (a list joined by
    spaces) or else the configured one, as the reference resolves it."""
    extraction = config.get("extraction", DEFAULT["extraction"])
    detection = config.get("ultralytics", DEFAULT["ultralytics"])
    model = args.get("model")
    if isinstance(model, list):
        model = " ".join(model)
    model = model or extraction.get("model") or detection.get("model")
    return {
        "geotrax_tpu_version": __version__,
        "video": {
            "source": str(source),
            "width": stats["frame_size"][0],
            "height": stats["frame_size"][1],
            "fps": stats["video_fps"],
            "frames_processed": stats["frames"],
        },
        "runtime": {
            "avg_detect_ms": round(stats["avg_detect_ms"], 2),
            "avg_stabilization_ms": round(stats["avg_stab_ms"], 2),
            "pipeline_fps": round(stats["fps"], 2),
            "extraction_mode": stats.get("extraction_mode", "sequential"),
        },
        "config": {
            "model": str(model),
            "tracker": select_tracker(config.get("tracker", DEFAULT["tracker"]))[0],
            "extraction": extraction,
            "stabilo": config.get("stabilo"),
            "detection": {k: detection.get(k) for k in (
                "imgsz", "conf", "iou", "max_det", "classes", "agnostic_nms", "tiles")},
        },
        "args": _serializable(args),
    }


def extract(reader, fx, out_dir, stem: str, config: dict | None = None,
            cut_left: int = 0, chunk: int = FUSED_CHUNK, source=None,
            args: dict | None = None) -> dict:
    """The fused extract of one frame source into ``out_dir``: the tracks
    and transforms files named after ``stem``, the tracks post-processed as
    ``run_extraction`` does (short tracks removed, classes voted, dimensions
    estimated, gaps up to the active tracker's ``track_buffer`` filled when
    ``interpolate`` is on), and, when ``source`` (the video's path) is
    given, ``<source>.yaml`` with the run's metadata. ``config`` supplies
    the ``extraction``, ``output``, ``tracker``, ``stabilo`` and
    ``ultralytics`` keys (defaults: the port's ``cfg.DEFAULT``); ``args``
    holds the run's arguments, written into the metadata, and an
    ``interpolate`` there (when not None) overrides the configured one, as
    the CLI's flag does. Returns the run's stats with the file paths."""
    config = config or DEFAULT
    args = dict(args or {})
    extraction = config.get("extraction", DEFAULT["extraction"])
    output = config.get("output", {})
    if not extraction.get("stabilize", True):
        raise NotImplementedError("extraction with stabilize: false is not ported yet (ROADMAP A13)")
    tracks, transforms, stats = track_video_fused(reader, fx, cut_left=cut_left, chunk=chunk)
    n_raw = len(tracks)

    tracks = postprocess.remove_short_tracks(tracks, int(extraction["min_track_length"]), _LOG)
    tracks = postprocess.vote_track_classes(tracks)
    frame_w, frame_h = stats["frame_size"]
    tracks = postprocess.estimate_vehicle_dimensions(
        tracks, extraction["dimension_estimation"], frame_w, frame_h)
    interpolate = args.get("interpolate")
    if interpolate is None:
        interpolate = extraction.get("interpolate", False)
    if interpolate:
        tracker = select_tracker(config.get("tracker", DEFAULT["tracker"]))[1]
        max_gap = int(tracker.get("track_buffer", 30))
        tracks = postprocess.interpolate_tracks(tracks, max_gap, _LOG)

    tracks_file, transf_file = save_results(
        tracks, transforms, out_dir, stem,
        tracks_postfix=output.get("tracks_postfix", ""),
        stab_postfix=output.get("stab_transform_postfix", "_vid_transf"),
        save_stab=bool(extraction.get("save_stab", True)),
    )
    stats.update(tracks_file=tracks_file, transforms_file=transf_file, n_rows_raw=n_raw,
                 n_rows=len(tracks), n_transforms=len(transforms))
    if source is not None:
        meta_file = Path(source).with_suffix(".yaml")
        try:
            meta_file.write_text(yaml_emit.dump(run_metadata(config, stats, source, args)))
            stats["metadata_file"] = meta_file
        except OSError as exc:
            _LOG.warning(f"Could not write metadata: {exc}")
    if torch.cuda.is_available() and fx.device.type == "cuda":
        stats["device"] = torch.cuda.get_device_name(fx.device)
    return stats
