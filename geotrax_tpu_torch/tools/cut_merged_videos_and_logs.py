"""Cut merged session videos and DJI SRT logs into per-location clips: the
port of ``tools/cut_merged_videos_and_logs.py``.

Session mode: point it at a data directory and it finds the merged videos
(stem containing --name-filter) recursively, reads each one's cut plan
``<stem>.txt`` (one ``start,end[,rotation]`` line per cut, 1-indexed,
end=-1 for the end of the video), checks it, moves every cut start FORWARD
onto the next keyframe (``io/video.py:keyframe_indices``, so that the
stream-copy cut decodes from its first frame), saves
``<stem>_adjusted.txt``, cuts the merged SRT into a 13-column flight-log CSV
per cut (``io/table.py``), names each clip by the GPS-nearest location of
--location-map (``<LABEL><n>.mp4``) and stream-copies the video cut through
``io/native/remux.cpp``. --cleanup deletes the merged sources after
confirmation; --dry-run previews everything.

  python -m geotrax_tpu_torch.tools.cut_merged_videos_and_logs DATA_DIR -lm locations.json

Explicit single-video mode: a video file with --cuts "U=0:1800" ... or
--auto (GPS hover segments of its flight log).
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

import numpy as np

from geotrax_tpu_torch.io import table
from geotrax_tpu_torch.io.video import keyframe_indices, probe_video
from geotrax_tpu_torch.tools import dji_srt
from geotrax_tpu_torch.tools.recut_video_and_log import cut_video, rebase_rows, recut, verify_cut
from geotrax_tpu_torch.utils.logging_utils import setup_logger

VIDEO_FORMATS = {".mp4", ".mov", ".avi", ".mkv"}
ROTATIONS = {0, 90, 180, 270, -90, -180, -270}

# the column order of the flight-log CSV cut from the SRT
LOG_COLUMNS = ["frame", "timestamp", "iso", "shutter", "fnum", "ev", "ct",
               "color_md", "focal_len", "latitude", "longitude", "rel_alt",
               "abs_alt"]


# ---------------------------------------------------------------------------
# shared geometry
# ---------------------------------------------------------------------------

def nearest_location(locations: dict, lat: float, lon: float) -> str | None:
    """GPS-nearest named location (equirectangular metric — the candidates
    are hundreds of meters apart, the hover jitter is centimeters)."""
    best, best_d = None, float("inf")
    for name, (llat, llon) in locations.items():
        dx = (lon - llon) * 111320.0 * np.cos(np.deg2rad(lat))
        dy = (lat - llat) * 111320.0
        d = float(np.hypot(dx, dy))
        if d < best_d:
            best, best_d = name, d
    return best


def determine_intersection(avg_lat: float, avg_lon: float,
                           location_map: dict, logger) -> str:
    """The clip's location label: 'unknown' when the map is empty or the SRT
    carried only dummy telemetry."""
    if not location_map:
        return "unknown"
    if avg_lat == 0.0 or avg_lon == 0.0:
        logger.warning("Could not determine location label: flight log "
                       "contained no usable GPS values.")
        return "unknown"
    return nearest_location(location_map, avg_lat, avg_lon) or "unknown"


# ---------------------------------------------------------------------------
# session mode
# ---------------------------------------------------------------------------

def find_merged_videos(data_dir: Path, name_filter: str, logger) -> list[Path]:
    videos = sorted(
        p for p in data_dir.rglob("*")
        if p.suffix.lower() in VIDEO_FORMATS
        and name_filter.lower() in p.stem.lower()
    )
    logger.info(f"Found {len(videos)} merged video file(s) under '{data_dir}'.")
    return videos


def find_session_files(video_path: Path, logger) -> dict | None:
    """Companion files next to a merged video: the cuts plan (required) and
    the merged SRT (optional — without it clips get no CSV)."""
    cuts_path = video_path.with_suffix(".txt")
    srt_path = video_path.with_suffix(".srt")
    if not cuts_path.exists():
        logger.warning(f"No cuts file '{cuts_path.name}' next to "
                       f"'{video_path.name}', skipping.")
        return None
    srt = srt_path if srt_path.exists() else None
    if srt is None:
        logger.info(f"No SRT flight log '{srt_path.name}' found; video will "
                    "be cut without CSV output.")
    return {"merged_video": video_path, "merged_srt": srt, "cuts_txt": cuts_path}


def load_location_map(path: Path, logger) -> dict:
    try:
        raw = json.loads(Path(path).read_text())
        location_map = {k: (float(v[0]), float(v[1])) for k, v in raw.items()}
        logger.info(f"Loaded {len(location_map)} location(s) from '{path}'.")
        return location_map
    except Exception as exc:  # noqa: BLE001
        logger.error(f"Failed to load location map from '{path}': {exc}")
        sys.exit(1)


def get_cuts(cuts_txt_path: Path, logger) -> dict:
    """{cut_num: (start, end, rotation)} from the plan file; 1-indexed
    frames, end=-1 = end of video, rotation optional (default 0)."""
    try:
        lines = [ln.rstrip().split(",") for ln in cuts_txt_path.read_text().splitlines()
                 if ln.strip()]
    except Exception as exc:  # noqa: BLE001
        logger.error(f"Problem reading '{cuts_txt_path}': {exc}")
        return {}
    if not lines:
        logger.error(f"The file '{cuts_txt_path}' is empty!")
        return {}
    cuts = {}
    for cut_num, line in enumerate(lines, start=1):
        start, end = int(line[0].strip()), int(line[1].strip())
        try:
            rotation = int(line[2].strip())
        except (IndexError, ValueError):
            rotation = 0
        cuts[cut_num] = (start, end, rotation)
    return cuts


def perform_sanity_checks(all_cuts: dict, filepaths: dict, logger) -> None:
    frame_count = probe_video(filepaths["merged_video"]).frame_count
    for cut_num, (start, end, rotation) in all_cuts.items():
        effective_end = frame_count if end == -1 else end
        assert start > 0 and effective_end > 0, (
            f"Cut {cut_num}: 'cut_start' must be positive and 'cut_end' must "
            f"be positive or -1 in '{filepaths['cuts_txt']}'")
        assert start < effective_end, (
            f"Cut {cut_num}: 'cut_start' >= 'cut_end' in '{filepaths['cuts_txt']}'")
        assert effective_end - 1 <= frame_count, (
            f"Cut {cut_num}: 'cut_end' exceeds total frame count "
            f"({frame_count}) in '{filepaths['cuts_txt']}'")
        assert rotation in ROTATIONS, (
            f"Cut {cut_num}: invalid rotation {rotation} in '{filepaths['cuts_txt']}'")


def get_and_save_adjusted_cuts(all_cuts: dict, filepaths: dict, logger,
                               debug: bool = False,
                               dry_run: bool = False) -> dict:
    """Snap each cut start FORWARD to the next keyframe (so that the clip
    starts at a decodable frame under stream copy) and persist
    ``<stem>_adjusted.txt``. The keyframes come from the native scan of the
    packets (``keyframe_indices``), not from ffprobe."""
    video = filepaths["merged_video"]
    frame_count = probe_video(video).frame_count
    kf = np.asarray(keyframe_indices(video))  # 0-indexed display frames
    if kf.size == 0:
        logger.error(f"Failed to retrieve keyframes from '{video}'.")
        sys.exit(1)

    adjusted: dict = {}
    for cut_num, (start, end, rotation) in all_cuts.items():
        resolved_end = frame_count if end == -1 else end
        start0 = start - 1  # plan is 1-indexed (SRT numbering)
        later = kf[kf >= start0]
        snapped0 = int(later[0]) if later.size else int(kf[-1])
        adjusted[cut_num] = (snapped0 + 1, resolved_end, rotation)
        if debug or dry_run:
            logger.info(f"Cut {cut_num}: start adjusted from {start} to "
                        f"{snapped0 + 1} (keyframe at display frame {snapped0}).")

    adjusted_txt = filepaths["cuts_txt"].with_name(
        filepaths["cuts_txt"].stem + "_adjusted.txt")
    if dry_run:
        logger.info(f"[DRY RUN] Would save adjusted cuts to '{adjusted_txt}'.")
    else:
        adjusted_txt.write_text(
            "".join("{},{},{}\n".format(*cut) for cut in adjusted.values()))
        logger.info(f"Adjusted cuts saved to '{adjusted_txt}'.")
    return adjusted


def get_cut_filepath(session_dir: Path, label: str, intersections: dict,
                     suffix: str) -> Path:
    intersections[label] = intersections.get(label, 0) + 1
    return session_dir / f"{label}{intersections[label]}{suffix}"


def cut_and_save_srt(filepaths: dict, cut: tuple, location_map: dict,
                     intersections: dict, dry_run: bool, logger) -> Path:
    """Slice the merged SRT's telemetry into the cut's 13-column flight-log
    CSV, label the clip by its mean GPS position, and return the clip path."""
    cut_start, cut_end, _ = cut
    session_dir = filepaths["merged_video"].parent
    if filepaths["merged_srt"] is None:
        label = determine_intersection(0.0, 0.0, location_map, logger)
        return get_cut_filepath(session_dir, label, intersections, ".mp4")

    try:
        blocks = dji_srt.read_srt(filepaths["merged_srt"])
    except Exception as exc:  # noqa: BLE001
        logger.error(f"Problem reading '{filepaths['merged_srt']}': {exc}")
        label = determine_intersection(0.0, 0.0, location_map, logger)
        return get_cut_filepath(session_dir, label, intersections, ".mp4")

    rows = []
    local = 0
    for i, b in enumerate(blocks):
        count = b.frame_count
        frame_global = count if count is not None else i + 1  # 1-indexed
        if not (cut_start <= frame_global < cut_end):
            continue
        t = b.telemetry()
        # the wall-clock datetime line, else the block's start timecode
        m = re.search(r"\d{4}-\d{2}-\d{2} \d{2}:\d{2}:\d{2}[.,]?\d*", b.body)
        rows.append({
            "frame": local,
            "timestamp": m.group(0) if m else dji_srt.ms_to_timestamp(b.start_ms),
            **{k: t.get(k) for k in LOG_COLUMNS[2:]},
        })
        local += 1

    usable = [(r["latitude"], r["longitude"]) for r in rows
              if r.get("color_md") != "dummy"
              and r.get("latitude") is not None and r.get("longitude") is not None]
    avg_lat = float(np.mean([u[0] for u in usable])) if usable else 0.0
    avg_lon = float(np.mean([u[1] for u in usable])) if usable else 0.0

    label = determine_intersection(avg_lat, avg_lon, location_map, logger)
    video_path = get_cut_filepath(session_dir, label, intersections, ".mp4")
    csv_path = video_path.with_suffix(".csv")
    if dry_run:
        logger.info(f"[DRY RUN] Would save cut flight log to '{csv_path}'.")
    else:
        try:
            table.write_csv(csv_path, table.from_records(rows, LOG_COLUMNS))
            logger.info(f"Cut flight log saved to '{csv_path}'.")
        except Exception as exc:  # noqa: BLE001
            logger.error(f"Problem saving '{csv_path}': {exc}")
    return video_path


def cut_and_save_video(filepaths: dict, cut: tuple, cut_video_path: Path,
                       debug: bool, dry_run: bool, logger) -> None:
    """Cut [start, end) out of the merged video. The adjusted start is a
    keyframe, so recut's cut_video takes the native stream-copy path (no
    re-encode, bit-identical packets); rotation falls back to re-encode with
    physical rotation, where ffmpeg would write a rotation tag that many
    decoders ignore."""
    start, end, rotation = cut
    start0, end0_incl = start - 1, end - 1 - 1  # 1-indexed, end exclusive
    if dry_run:
        logger.info(f"[DRY RUN] Would cut frames [{start0}, {end0_incl}] "
                    f"(rotation {rotation}) -> '{cut_video_path}'.")
        return
    n = cut_video(filepaths["merged_video"], start0, end0_incl,
                  cut_video_path, rotation, 0, logger)
    logger.info(f"Cut video saved to '{cut_video_path}' ({n} frames).")
    if debug:
        verify_cut(filepaths["merged_video"], cut_video_path, start0,
                   end0_incl, logger)


def process_session(filepaths: dict, location_map: dict, debug: bool,
                    dry_run: bool, logger) -> None:
    intersections: dict = {}
    all_cuts = get_cuts(filepaths["cuts_txt"], logger)
    if not all_cuts:
        return
    try:
        perform_sanity_checks(all_cuts, filepaths, logger)
    except AssertionError as exc:
        logger.error(str(exc))
        return
    adjusted = get_and_save_adjusted_cuts(all_cuts, filepaths, logger, debug,
                                          dry_run)
    for cut_num in adjusted:
        clip = cut_and_save_srt(filepaths, adjusted[cut_num], location_map,
                                intersections, dry_run, logger)
        cut_and_save_video(filepaths, adjusted[cut_num], clip, debug,
                           dry_run, logger)


def cleanup_merged_files(merged_videos: list, dry_run: bool, logger) -> None:
    """Delete merged sources (+ their .srt) after an interactive confirm."""
    to_delete: list[Path] = []
    for video_path in merged_videos:
        to_delete.append(video_path)
        for p in video_path.parent.iterdir():
            if p.stem == video_path.stem and p.suffix.lower() == ".srt":
                to_delete.append(p)
    if not to_delete:
        return
    if dry_run:
        logger.info("[DRY RUN] Would permanently delete the following merged "
                    "source files:")
        for p in to_delete:
            logger.info(f"  {p}")
        return
    logger.warning("The following merged source files will be permanently deleted:")
    for p in to_delete:
        logger.warning(f"  {p}")
    try:
        answer = input("\nProceed with deletion? [y/N] ").strip().lower()
    except EOFError:
        answer = ""
    if answer not in ("y", "yes"):
        logger.info("Cleanup cancelled.")
        return
    for p in to_delete:
        p.unlink(missing_ok=True)
        logger.info(f"Deleted '{p}'.")
    logger.info(f"Cleanup complete: {len(to_delete)} file(s) deleted.")


# ---------------------------------------------------------------------------
# explicit single-video mode (this repo's original surface)
# ---------------------------------------------------------------------------

def load_flight_log(video: Path, parser) -> dict:
    log = dji_srt.flight_log(video, prefer="csv")
    if log is None:
        parser.error(f"--auto needs a usable flight log next to {video} (.csv or .srt)")
    return log


def hover_segments(log: dict, min_frames: int = 300,
                   max_speed_mps: float = 0.5) -> list:
    """[(start, end)] frame ranges where the drone hovers (low GPS speed)."""
    lat = np.asarray(log["latitude"], np.float64)
    lon = np.asarray(log["longitude"], np.float64)
    frame = np.asarray(log["frame"])
    mean_lat = np.nanmean(lat)
    dx = np.gradient(lon) * 111320.0 * np.cos(np.deg2rad(mean_lat))
    dy = np.gradient(lat) * 111320.0
    fps = 30.0
    speed = np.hypot(dx, dy) * fps
    calm = speed < max_speed_mps
    segments = []
    start = None
    for i, c in enumerate(calm):
        if c and start is None:
            start = i
        elif not c and start is not None:
            if i - start >= min_frames:
                segments.append((int(frame[start]), int(frame[i])))
            start = None
    if start is not None and len(calm) - start >= min_frames:
        segments.append((int(frame[start]), int(frame[-1])))
    return segments


def run_explicit(args, parser) -> int:
    log = None
    plans = []
    if args.cuts:
        for entry in args.cuts:
            loc, rng = entry.split("=")
            start, end = (int(v) for v in rng.split(":"))
            plans.append((loc, start, end))
    else:  # --auto
        log = load_flight_log(args.input, parser)
        locations = None
        if args.location_map is not None:
            locations = load_location_map(
                args.location_map,
                setup_logger("cut_merged_videos_and_logs", verbose=False))
        for i, (start, end) in enumerate(hover_segments(log, args.min_hover_frames)):
            name = f"H{i}"
            if locations:
                seg = rebase_rows(log, start, end)
                lat = float(np.nanmedian(seg["latitude"]))
                lon = float(np.nanmedian(seg["longitude"]))
                name = nearest_location(locations, lat, lon) or name
            plans.append((name, start, end))
        if not plans:
            print("No hover segments found.")
            return 1

    keyframes = None
    if args.snap_keyframes:
        keyframes = np.asarray(keyframe_indices(args.input))
        if keyframes.size == 0:
            print("warning: no keyframe info available (cv2 backend?); not snapping")
            keyframes = None

    args.out.mkdir(parents=True, exist_ok=True)
    for loc, start, end in plans:
        if keyframes is not None:
            earlier = keyframes[keyframes <= start]
            snapped = int(earlier[-1]) if earlier.size else 0
            if snapped != start:
                print(f"{loc}: cut start {start} snapped to keyframe {snapped}")
            start = snapped
        out = args.out / f"{loc}_{args.input.stem}.mp4"
        recut(args.input, start, end, out, cut_log=True)
        if log is not None:
            table.write_csv(out.with_suffix(".csv"), rebase_rows(log, start, end))
    return 0


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Recursively cut merged drone videos and DJI SRT flight "
                    "logs into per-location clips.")
    parser.add_argument("input", type=Path,
                        help="Data directory (session mode: recursive scan "
                             "for merged videos + <stem>.txt cut plans) or a "
                             "single video file (explicit mode with "
                             "--cuts/--auto)")
    parser.add_argument("--location-map", "-lm", "--locations", type=Path,
                        default=None, dest="location_map",
                        help='JSON {"name": [lat, lon], ...} used to label '
                             "each clip with its GPS-nearest location")
    parser.add_argument("--name-filter", "-nf", type=str, default="merged",
                        help="Substring a video stem must contain to count "
                             "as a merged session video (session mode)")
    parser.add_argument("--cleanup", action="store_true",
                        help="Delete merged source videos (+ .srt) after "
                             "cutting, with interactive confirmation")
    parser.add_argument("--dry-run", "-dr", action="store_true")
    parser.add_argument("--debug", "-d", action="store_true",
                        help="Verbose + per-cut RMSE verification of sampled frames")
    parser.add_argument("--log-path", "-lp", type=Path, default=None)
    parser.add_argument("--quiet", "-q", action="store_true")
    # explicit single-video mode
    parser.add_argument("--cuts", nargs="+", default=None,
                        help="LOC=start:end frame ranges (explicit mode)")
    parser.add_argument("--auto", action="store_true",
                        help="Derive cut ranges from GPS hover segments in "
                             "the flight log (explicit mode)")
    parser.add_argument("--snap-keyframes", action="store_true",
                        help="Explicit mode: snap cut starts backward onto keyframes")
    parser.add_argument("--min-hover-frames", type=int, default=300)
    parser.add_argument("--out", "-o", type=Path, default=None,
                        help="Output directory (explicit mode)")
    args = parser.parse_args(argv)

    if args.input.is_file() or args.cuts or args.auto:
        if not args.input.is_file():
            parser.error("--cuts/--auto need a video FILE as input")
        if args.out is None:
            parser.error("explicit mode needs --out")
        return run_explicit(args, parser)

    logger = setup_logger("cut_merged_videos_and_logs", verbose=not args.quiet,
                          log_path=args.log_path)
    location_map = (load_location_map(args.location_map, logger)
                    if args.location_map else {})
    merged = find_merged_videos(args.input, args.name_filter, logger)
    for video in merged:
        filepaths = find_session_files(video, logger)
        if filepaths is None:
            continue
        process_session(filepaths, location_map, args.debug, args.dry_run, logger)
    if args.cleanup:
        cleanup_merged_files(merged, args.dry_run, logger)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
