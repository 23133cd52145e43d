"""`visualize`: annotated videos in five rendering modes.

The port of ``geotrax_tpu/pipeline/visualize.py`` and the stage half of
``_visualize_impl.py``: modes 0 original / 1 stabilized / 2 static
reference frame / 3 rotated (oriented) boxes on the original frame / 4
rotated boxes on the stabilized frame; fading track tails, labels
(id/class/speed/lane/conf), dashed outlines for fallback and interpolated
boxes, clipping of edge-touching oriented boxes, the optional
trajectory-overlay intro and the live preview (``--show``, through cv2).

In modes 1 and 4 a frame that has a transform goes to ``--device`` (the
card unless ``--device cpu``), is warped there (``ops/warp.py``, the
inverse taken on the host) and comes back for drawing; modes 0, 2 and 3 do
no device work. Drawing is the port's own rasterizer on the host
(``ops/draw.py``), in RGB; the file is written by ``io/video.py``'s
``VideoWriter`` (the port's MPEG-4 encoder, else cv2, else it raises).
``open_reader`` and ``open_writer`` are the stage's patch points, and the
video's size comes from ``io.video.probe_video``. The geometry and the
readers are in ``_visualize_impl.py``.
"""

from __future__ import annotations

import argparse
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np

from geotrax_tpu_torch.io import video
from geotrax_tpu_torch.ops import draw
from geotrax_tpu_torch.pipeline._visualize_impl import (_project, clip_poly_to_rect,
                                                        clip_segment_to_rect,
                                                        read_georeferenced_results, read_tracks,
                                                        read_transforms, speed_and_lane,
                                                        speed_lane_by_frame)
from geotrax_tpu_torch.utils.cli_utils import add_common_args
from geotrax_tpu_torch.utils.config_utils import (backfill_args_from_config, load_config_all,
                                                  resolve_class_names)
from geotrax_tpu_torch.utils.data_utils import VizColors
from geotrax_tpu_torch.utils.file_utils import (build_result_path, check_if_results_exist,
                                                determine_suffix_and_fourcc, get_output_dir)
from geotrax_tpu_torch.utils.logging_utils import setup_logger

TXT_COLOR = (255, 255, 255)


def add_visualization_args(group, include_frame_range: bool = True) -> None:
    """The visualization flags of `visualize` and `batch`."""
    opt = argparse.BooleanOptionalAction
    group.add_argument("--save", "-s", action=opt, default=None,
                       help="Save the annotated output video to file.")
    group.add_argument("--show", "-sh", action=opt, default=None,
                       help="Open a live preview window during processing.")
    group.add_argument("--viz-mode", "-vm", type=int, nargs="+", default=None,
                       choices=[0, 1, 2, 3, 4], metavar="MODE",
                       help="Frame source(s): 0 original, 1 stabilized, 2 reference frame, "
                            "3/4 rotated boxes on original/stabilized frame. One video per mode.")
    group.add_argument("--plot-trajectories", "-pt", action=opt, default=None,
                       help="Overlay trajectory positions on the first frame.")
    group.add_argument("--plot-delay", "-pd", type=int, default=None,
                       help="Frames to hold the trajectory overlay.")
    group.add_argument("--show-conf", "-sc", action=opt, default=None,
                       help="Include detection confidence in box labels.")
    group.add_argument("--show-lanes", "-sl", action=opt, default=None,
                       help="Include lane ID in box labels (requires georeferencing).")
    group.add_argument("--show-class-names", "-scn", action=opt, default=None,
                       help="Include class name in box labels.")
    group.add_argument("--hide-labels", "-hl", action=opt, default=None,
                       help="Suppress all label text overlays.")
    group.add_argument("--hide-tracks", "-ht", action=opt, default=None,
                       help="Suppress track tail lines.")
    group.add_argument("--hide-speed", "-hs", action=opt, default=None,
                       help="Suppress speed values in labels.")
    group.add_argument("--speed-unit", "-su", type=str, default=None, choices=["km/h", "mi/h"],
                       help="Speed display unit.")
    group.add_argument("--speed-deadzone", "-sdz", type=float, default=None,
                       help="Floor displayed speeds <= this value to 0; 0 disables.")
    group.add_argument("--class-filter", "-cf", type=int, nargs="+", default=None,
                       help="Class IDs to exclude from visualization.")
    group.add_argument("--tail-length", "-tl", type=int, default=None,
                       help="Track tail length [frames].")
    group.add_argument("--line-width", "-lw", type=int, default=None,
                       help="Box and track stroke width [px].")
    group.add_argument("--heading-smoothing", "-hsm", type=int, default=None,
                       help="(modes 3/4) Gaussian smoothing window [frames] for headings.")
    group.add_argument("--heading-min-speed", "-hms", type=float, default=None,
                       help="(modes 3/4) Min smoothed pixel speed for a reliable heading.")
    group.add_argument("--edge-clip-margin", "-ecm", type=float, default=None,
                       help="(modes 3/4) Edge-touch distance [px] that triggers oriented-box clipping.")
    group.add_argument("--edge-clip-smoothing", "-ecs", type=float, default=None,
                       help="(modes 3/4) Gaussian window [frames] for smoothing the clip rectangle.")
    if include_frame_range:
        group.add_argument("--cut-frame-left", "-cfl", type=int, default=None,
                           help="Skip the first N frames.")
        group.add_argument("--cut-frame-right", "-cfr", type=int, default=None,
                           help="Stop processing after this frame.")


def resolve_viz_modes(args: argparse.Namespace, logger) -> list:
    """Normalized viz modes, reading the config default when --viz-mode was
    not given; the resolved value is cached on args."""
    if args.viz_mode is None:
        from geotrax_tpu_torch.utils.config_utils import load_config

        args.viz_mode = load_config(args.cfg, logger)["visualization"]["viz_mode"]
    return normalize_viz_modes(args.viz_mode, logger)


def normalize_viz_modes(viz_mode, logger) -> list:
    """Coerce a mode or list of modes into an ordered, de-duplicated list of
    valid mode ids; exits on invalid or empty input."""
    modes = list(viz_mode) if isinstance(viz_mode, (list, tuple)) else [viz_mode]
    valid: list[int] = []
    for mode in modes:
        if mode not in (0, 1, 2, 3, 4):
            logger.critical(f"Invalid visualization mode '{mode}'. Valid modes: 0-4.")
            sys.exit(1)
        if mode not in valid:
            valid.append(mode)
    if not valid:
        logger.critical("No visualization mode specified.")
        sys.exit(1)
    return valid


def open_reader(source, start: int = 0, stop=None):
    """The stage's frame source: (index, RGB frame) pairs of ``source`` from
    ``start`` to ``stop`` (exclusive). Tests and the smoke replace it."""
    return video.VideoReader(source, start=start, stop=stop)


def open_writer(path, fps: float, width: int, height: int):
    """The stage's video sink (``write(rgb)``, ``close()``). Tests and the
    smoke replace it."""
    return video.VideoWriter(path, fps, width, height)


# ---------------------------------------------------------------------------
# Drawing
# ---------------------------------------------------------------------------

def draw_dashed_poly(frame, corners, color, thickness, dash: int = 10, gap: int = 5):
    n = len(corners)
    for i in range(n):
        p1 = corners[i].astype(float)
        p2 = corners[(i + 1) % n].astype(float)
        dist = float(np.hypot(*(p2 - p1)))
        if dist < 1:
            continue
        direction = (p2 - p1) / dist
        t = 0.0
        while t < dist:
            a = (p1 + direction * t).astype(np.int32)
            b = (p1 + direction * min(t + dash, dist)).astype(np.int32)
            draw.line(frame, a, b, color, thickness)
            t += dash + gap


def draw_oriented_box(frame, cx, cy, length, width, heading, h_inv, color,
                      line_width, dashed=False, clip_w=None, clip_h=None,
                      on_border=False) -> tuple:
    """Rotated box built in stabilized space, optionally clipped to the
    visible footprint, projected via h_inv, drawn (dashed for fallback /
    interpolated rows) with a heading tick. Returns the projected center."""
    if heading is None or np.isnan(heading):
        ux, uy = 1.0, 0.0
    else:
        ux, uy = np.cos(heading), np.sin(heading)
    vx, vy = -uy, ux
    hl, hw = length / 2.0, width / 2.0
    corners = np.array([
        [cx + hl * ux - hw * vx, cy + hl * uy - hw * vy],
        [cx + hl * ux + hw * vx, cy + hl * uy + hw * vy],
        [cx - hl * ux + hw * vx, cy - hl * uy + hw * vy],
        [cx - hl * ux - hw * vx, cy - hl * uy - hw * vy],
    ], np.float32)
    center = np.array([cx, cy], np.float32)
    front = np.array([cx + hl * ux, cy + hl * uy], np.float32)
    tick = (center, front)

    if on_border and clip_w is not None and clip_h is not None:
        xmin, ymin = cx - clip_w / 2.0, cy - clip_h / 2.0
        xmax, ymax = cx + clip_w / 2.0, cy + clip_h / 2.0
        clipped = clip_poly_to_rect(corners, xmin, ymin, xmax, ymax)
        if len(clipped) >= 3:
            corners = clipped
        tick = clip_segment_to_rect(center, front, xmin, ymin, xmax, ymax)

    proj = _project(corners, h_inv).astype(np.int32)
    center_proj = _project(center[None], h_inv)[0].astype(np.int32)
    if dashed:
        draw_dashed_poly(frame, proj, color, line_width)
    else:
        draw.polylines(frame, proj, True, color, line_width)
    if tick is not None:
        tick_proj = _project(np.array(tick, np.float32), h_inv).astype(np.int32)
        draw.line(frame, tick_proj[0], tick_proj[1], color, line_width)
    return int(center_proj[0]), int(center_proj[1])


def plot_trajectories_overlay(ref_frame, tracks_plotting, cut_left, cut_right,
                              line_width: int) -> np.ndarray:
    """Every stabilized position as a circle in its class colour on the
    reference frame, blended 3:1 over it."""
    keep = tracks_plotting[:, 0] >= cut_left
    if cut_right is not None:
        keep &= tracks_plotting[:, 0] <= cut_right
    plot = tracks_plotting[keep]
    overlay = ref_frame.copy()
    colors = np.array([VizColors.rgb(int(c)) for c in plot[:, 3]], np.uint8).reshape(-1, 3)
    draw.circles(overlay, np.trunc(plot[:, 1:3]), np.ones(len(plot), np.int64), colors,
                 line_width)
    return draw.add_weighted(overlay, 0.75, ref_frame, 0.25, 0)


def annotate_frame(frame, frame_num, tracks_frame, track_history, class_names,
                   speed_lane_frame, args, logger, h_inv=None):
    """A copy of ``frame`` (RGB) with this frame's rows drawn; ``tracks_frame``
    is the frame's rows of ``read_tracks``' layout, ``speed_lane_frame``
    {vehicle id: (speed, lane)} or None."""
    line_width = args.line_width
    annotated = frame.copy()
    if len(tracks_frame) == 0:
        return annotated
    is_oriented = args.viz_mode in (3, 4)
    ncols = tracks_frame.shape[1]

    for row in tracks_frame.tolist():
        track_id = int(row[1])
        c = int(row[6])
        if args.class_filter and c in args.class_filter:
            continue
        color = VizColors.rgb(c)

        speed = lane = None
        if speed_lane_frame is not None and track_id in speed_lane_frame:
            speed, lane = speed_and_lane(speed_lane_frame[track_id], args.speed_unit,
                                         args.speed_deadzone)

        if is_oriented:
            x_draw, y_draw = draw_oriented_box(
                annotated, row[2], row[3], row[4], row[5], row[8],
                h_inv if h_inv is not None else np.eye(3, dtype=np.float32),
                color, line_width, dashed=bool(row[9]),
                clip_w=row[10], clip_h=row[11], on_border=bool(row[12]),
            )
            x1, y1 = x_draw, y_draw
            conf = row[7]
        else:
            xc, yc, w, h = row[2], row[3], row[4], row[5]
            x1, y1 = int(xc - w / 2), int(yc - h / 2)
            x2, y2 = int(xc + w / 2), int(yc + h / 2)
            is_interp = bool(row[ncols - 1]) if ncols in (9, 11) else False
            if is_interp:
                corners = np.array([[x1, y1], [x2, y1], [x2, y2], [x1, y2]], np.int32)
                draw_dashed_poly(annotated, corners, color, line_width)
            else:
                draw.rectangle(annotated, (x1, y1), (x2, y2), color, line_width)
            x_draw, y_draw = xc, yc
            conf = row[7] if ncols >= 8 else None

        if not args.hide_labels:
            parts = [f"id:{track_id}"]
            if args.show_class_names:
                parts.append(str(class_names.get(c, c)))
            if not args.hide_speed and speed is not None:
                parts.append(f"{speed} {args.speed_unit}")
            if args.show_lanes and lane is not None:
                parts.append(f"L{lane}")
            if args.show_conf and conf is not None and conf == conf:
                parts.append(f"{conf:.2f}")
            label = " ".join(parts)
            tw, th = draw.text_size(label, line_width)
            outside = y1 - th >= 3
            y_text = y1 - th - 3 if outside else y1 + th + 3
            draw.rectangle(annotated, (int(x1), int(y1)), (int(x1 + tw), int(y_text)), color, -1)
            draw.put_text(annotated, label, (int(x1), int(y1 - 2 if outside else y1 + th + 2)),
                          line_width, TXT_COLOR)

        if not args.hide_tracks:
            history = track_history[track_id]
            history.append((float(x_draw), float(y_draw)))
            if len(history) > args.tail_length:
                history.pop(0)
            pts = np.array(history, np.int32)
            radii = [int(1 + 8 * (i + 1) / len(pts)) for i in range(len(pts))]
            draw.circles(annotated, pts, radii, color, line_width)
    return annotated


# ---------------------------------------------------------------------------
# The stage
# ---------------------------------------------------------------------------

def run_visualization(args, logger) -> list:
    """Render every requested mode of ``args.source``; one dict of counts
    and seconds per mode (frames; read, warp, draw and write seconds)."""
    config = load_config_all(args, logger, needs_model=False)
    viz_cfg = config["main"]["visualization"]
    out_cfg_raw = config["main"].get("output", {})
    backfill_args_from_config(args, {
        "save": viz_cfg["save"], "show": viz_cfg["show"],
        "viz_mode": viz_cfg["viz_mode"],
        "tail_length": viz_cfg["tail_length"], "line_width": viz_cfg["line_width"],
        "heading_smoothing": viz_cfg["heading_smoothing"],
        "heading_min_speed": viz_cfg["heading_min_speed"],
        "edge_clip_margin": viz_cfg["edge_clip_margin"],
        "edge_clip_smoothing": viz_cfg["edge_clip_smoothing"],
        "plot_trajectories": viz_cfg["plot_trajectories"],
        "plot_delay": viz_cfg["plot_delay"],
        "show_conf": viz_cfg["show_conf"], "show_lanes": viz_cfg["show_lanes"],
        "show_class_names": viz_cfg["show_class_names"],
        "hide_labels": viz_cfg["hide_labels"], "hide_tracks": viz_cfg["hide_tracks"],
        "hide_speed": viz_cfg["hide_speed"], "speed_unit": viz_cfg["speed_unit"],
        "speed_deadzone": viz_cfg["speed_deadzone"],
        "class_filter": viz_cfg["class_filter"],
        "cut_frame_left": config["main"]["processing"]["cut_frame_left"],
        "cut_frame_right": config["main"]["processing"]["cut_frame_right"],
        "output_folder": out_cfg_raw.get("folder", "results"),
    })
    out_cfg = {**out_cfg_raw, "folder": args.output_folder}

    # class names without a model: CLI, then config, then integer ids
    class_names = config["main"].get("class_names") or {}
    if not class_names:
        class_names, _ = resolve_class_names(
            Path("none"), getattr(args, "class_names", None),
            config["main"].get("extraction", {}).get("class_rename"),
            config["ultralytics"].get("classes"), logger,
        )

    modes = normalize_viz_modes(args.viz_mode, logger)
    source = Path(args.source)

    tracks_exists, tracks_path = check_if_results_exist(source, "processed", output_cfg=out_cfg)
    if not tracks_exists:
        logger.critical(f"No tracking results for '{source}'; run 'extract' first.")
        sys.exit(1)

    geo_exists, geo_path = check_if_results_exist(source, "georeferenced", output_cfg=out_cfg)
    speed_lane = read_georeferenced_results(geo_path, logger) if geo_exists else None

    stats = []
    for mode in modes:
        args.viz_mode = mode
        stats.append(_render_one_mode(source, tracks_path, speed_lane, class_names, args,
                                      out_cfg, logger))
    args.viz_mode = modes
    return stats


def _render_one_mode(source, tracks_path, speed_lane, class_names, args, out_cfg, logger) -> dict:
    mode = args.viz_mode
    info = video.probe_video(source)
    frame_size = (info.width, info.height) if mode in (3, 4) else None
    tracks, tracks_plotting = read_tracks(tracks_path, class_names, args, logger, frame_size)

    transforms = {}
    if mode in (1, 3, 4):
        t_exists, t_path = check_if_results_exist(source, "video_transformations", output_cfg=out_cfg)
        if not t_exists:
            logger.critical(f"Viz mode {mode} needs stabilization transforms; none at '{t_path}'.")
            sys.exit(1)
        transforms = read_transforms(t_path, logger)
    device = None
    if mode in (1, 4) and transforms:
        from geotrax_tpu_torch._device import resolve_device

        device = resolve_device(getattr(args, "device", "cuda"))

    writer = None
    stats = {"mode": mode, "frames": 0, "intro_frames": 0, "warped": 0, "read_s": 0.0,
             "warp_s": 0.0, "draw_s": 0.0, "write_s": 0.0, "path": None}
    if args.save is not False:
        suffix, _ = determine_suffix_and_fourcc()
        out_path = build_result_path(source, "visualized", out_cfg, mode, suffix)
        get_output_dir(source, out_cfg).mkdir(parents=True, exist_ok=True)
        writer = open_writer(out_path, info.fps, info.width, info.height)
        stats["path"] = out_path
        if getattr(writer, "backend", None) == "cv2":
            logger.warning(f"Native encoder unavailable ({writer.native_error}); "
                           f"writing '{out_path}' with cv2.")

    cut_left = int(args.cut_frame_left or 0)
    cut_right = args.cut_frame_right
    frame_ids = tracks[:, 0].astype(np.int64)
    order = np.argsort(frame_ids, kind="stable")
    uniq, starts = np.unique(frame_ids[order], return_index=True)
    tracks_by_frame = {int(f): tracks[order[s:e]] for f, s, e in
                       zip(uniq, starts, list(starts[1:]) + [len(order)])}
    empty = tracks[:0]
    sl_by_frame = speed_lane_by_frame(speed_lane) if speed_lane is not None else None

    track_history: dict = defaultdict(list)
    ref_frame = None
    try:
        if args.plot_trajectories and tracks_plotting is not None:
            first = next(iter(open_reader(source, cut_left, cut_left + 1)))[1]
            overlay = plot_trajectories_overlay(first, tracks_plotting, cut_left, cut_right,
                                                args.line_width)
            stats["intro_frames"] = int(args.plot_delay or 30)
            for _ in range(stats["intro_frames"]):
                if writer is not None:
                    writer.write(overlay)

        frames = iter(open_reader(source, cut_left, cut_right))
        while True:
            t0 = time.perf_counter()
            item = next(frames, None)
            t1 = time.perf_counter()
            stats["read_s"] += t1 - t0
            if item is None:
                break
            frame_idx, frame = item
            if frame_idx == cut_left:
                ref_frame = frame.copy()

            h_inv = None
            if mode in (1, 4) and frame_idx in transforms:
                frame = warp_frame(frame, transforms[frame_idx], device)
                stats["warped"] += 1
            elif mode == 2 and ref_frame is not None:
                frame = ref_frame
            elif mode == 3:
                m = transforms.get(frame_idx)
                h_inv = (np.linalg.inv(m) if m is not None else np.eye(3)).astype(np.float32)
            if mode == 4:
                h_inv = np.eye(3, dtype=np.float32)
            t2 = time.perf_counter()
            stats["warp_s"] += t2 - t1

            tracks_frame = tracks_by_frame.get(int(frame_idx), empty)
            sl_frame = sl_by_frame.get(int(frame_idx)) if sl_by_frame else None
            annotated = annotate_frame(frame, frame_idx, tracks_frame, track_history, class_names,
                                       sl_frame, args, logger, h_inv)
            t3 = time.perf_counter()
            stats["draw_s"] += t3 - t2
            if writer is not None:
                writer.write(annotated)
            stats["write_s"] += time.perf_counter() - t3
            stats["frames"] += 1
            if args.show and video.preview(annotated) == ord("q"):
                logger.warning("Visualization interrupted by user.")
                break
    finally:
        if writer is not None:
            t4 = time.perf_counter()
            writer.close()
            stats["write_s"] += time.perf_counter() - t4
            logger.info(f"Annotated video (mode {mode}) saved.")
        if args.show:
            video.close_preview()
    return stats


def warp_frame(frame: np.ndarray, h_matrix: np.ndarray, device) -> np.ndarray:
    """``frame`` (RGB u8) warped by ``h_matrix`` on ``device`` and brought
    back to the host."""
    import torch

    from geotrax_tpu_torch.ops.warp import invert_homography, warp_perspective

    h, w = frame.shape[:2]
    src = torch.from_numpy(np.ascontiguousarray(frame)).to(device)
    return warp_perspective(src, invert_homography(h_matrix), h, w).cpu().numpy()


def visualize_results(args: argparse.Namespace, logger) -> list:
    """Run the visualization stage for one video (library entry point)."""
    return run_visualization(args, logger)


def parse_cli_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(prog="python -m geotrax_tpu_torch visualize",
                                     description="Tracking results visualization (PyTorch/CUDA)")
    parser.add_argument("source", type=Path, help="Path to the input video file.")
    optional = parser.add_argument_group("Optional arguments")
    add_common_args(optional)
    optional.add_argument("--model", "-m", nargs="+", default=None, metavar="MODEL",
                          help="Model used only to resolve vehicle class names.")
    optional.add_argument("--class-names", "-cn", nargs="+", default=None, metavar="ID=NAME|FILE",
                          help="Class-id -> name mapping: a .yaml/.json file or ID=NAME pairs.")
    viz = parser.add_argument_group("Visualization arguments")
    add_visualization_args(viz)
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_cli_args(argv)
    logger = setup_logger("geotrax.visualize", args.verbose, args.log_path)
    visualize_results(args, logger)
    return 0


if __name__ == "__main__":
    sys.exit(main())
