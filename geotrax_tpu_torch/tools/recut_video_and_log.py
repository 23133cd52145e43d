"""Cut a video and its flight log to a frame range: the port of
``tools/recut_video_and_log.py``.

The range comes from a cuts file (``start, end[, rotation]``) or from
``--start/--end``; the companion flight-log CSV is cut with its frames
rebased (``io/table.py``), the video optionally rotated, and ``--debug``
checks the cut by the RMSE of sampled frames.

- By default the range snaps to keyframes (``io/video.py:keyframe_indices``:
  the start forward, the end backward, the window the reference's ``-c
  copy`` gives); ``--exact-cut`` cuts at the exact frames.
- A cut whose start is a keyframe, without rotation or bitrate, is a stream
  copy (``io/native/remux.cpp``, ``remux_cut_frames``): the packets bit for
  bit. Otherwise the frames are decoded and re-encoded through the port's
  MPEG-4 encoder, which has no rotation tag, so ``--rotate`` turns the
  pixels.

Usage:
  python -m geotrax_tpu_torch.tools.recut_video_and_log VIDEO.MP4 cuts.txt [-o OUT.MP4]
  python -m geotrax_tpu_torch.tools.recut_video_and_log VIDEO.mp4 -s 90 -e 400 -ec -o OUT.mp4
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from geotrax_tpu_torch.io import table
from geotrax_tpu_torch.io.native import remux_cut_frames
from geotrax_tpu_torch.io.video import VideoReader, VideoWriter, keyframe_indices, probe_video
from geotrax_tpu_torch.utils.logging_utils import setup_logger

VALID_ROTATIONS = {0, 90, 180, 270, -90, -180, -270}


def rebase_rows(df: dict, start: int, stop: int) -> dict:
    """The rows of a flight-log table whose frame lies in [start, stop),
    frames rebased to start at 0."""
    frame = df["frame"]
    keep = (frame >= start) & (frame < stop)
    out = {k: v[keep] for k, v in df.items()}
    out["frame"] = out["frame"] - start
    return out


def parse_bitrate(text: Optional[str]) -> int:
    """'5M' / '10000k' / '800000' -> bits per second (0 when unset)."""
    if not text:
        return 0
    s = text.strip().lower()
    mult = 1
    if s.endswith("m"):
        mult, s = 1_000_000, s[:-1]
    elif s.endswith("k"):
        mult, s = 1_000, s[:-1]
    return int(float(s) * mult)


def read_cuts_file(path: Path) -> Tuple[int, int, int]:
    """One-line cuts spec: 'start, end[, rotation]'."""
    lines = [ln for ln in path.read_text().splitlines() if ln.strip()]
    if not lines:
        raise SystemExit(f"The cuts file '{path}' is empty")
    if len(lines) > 1:
        raise SystemExit(f"The cuts file '{path}' contains more than one line")
    parts = [p.strip() for p in lines[0].split(",")]
    start, end = int(parts[0]), int(parts[1])
    rotation = int(parts[2]) if len(parts) > 2 and parts[2] else 0
    return start, end, rotation


def sanity_check(start: int, end: int, rotation: int, frame_count: int,
                 origin: str) -> None:
    if start < 0:
        raise SystemExit(f"'cut_start' must be non-negative in {origin}")
    eff_end = frame_count - 1 if end == -1 else end
    if start >= eff_end:
        raise SystemExit(f"'cut_start' >= 'cut_end' in {origin}")
    if eff_end > frame_count - 1:
        raise SystemExit(
            f"'cut_end' in {origin} exceeds the video's {frame_count} frames"
        )
    if rotation not in VALID_ROTATIONS:
        raise SystemExit(f"invalid rotation {rotation} in {origin}")


def snap_to_keyframes(video: Path, start: int, end: int,
                      logger: logging.Logger) -> Tuple[int, int]:
    """The default mode's window: start snaps FORWARD to the nearest
    keyframe >= start (start 0 stays at the first keyframe), end snaps
    BACKWARD to the nearest keyframe <= end."""
    kf = np.asarray(keyframe_indices(video), dtype=np.int64)
    if kf.size == 0:
        logger.warning("No keyframe index available; cutting at exact frames")
        return start, end
    later = kf[kf >= start]
    new_start = int(later[0]) if later.size else int(kf[-1])
    earlier = kf[kf <= end]
    new_end = int(earlier[-1]) if earlier.size else int(kf[0])
    if new_start != start:
        logger.info(f"Adjusted cut start {start} -> {new_start} "
                    f"(+{new_start - start} frames to nearest keyframe)")
    if new_end != end:
        logger.info(f"Adjusted cut end {end} -> {new_end} "
                    f"({new_end - end:+d} frames to nearest keyframe)")
    return new_start, new_end


def _rotate_frame(frame: np.ndarray, rotation: int) -> np.ndarray:
    """Counter-clockwise rotation in 90-degree steps."""
    k = (rotation % 360) // 90
    return np.rot90(frame, k) if k else frame


def cut_video(video: Path, start: int, end_incl: int, out: Path,
              rotation: int, bitrate: int, logger: logging.Logger) -> int:
    """Cut frames [start, end_incl] to ``out``. When the start lands on a
    keyframe and no rotation/bitrate change is requested, the cut is a
    native STREAM COPY (io/native/remux.cpp gtx_remux_cut): bit-identical
    packets, no generation loss, as ``ffmpeg -ss .. -c copy`` cuts.
    Otherwise decode + re-encode. Returns the number of frames written."""
    if rotation % 360 == 0 and not bitrate:
        if start in set(keyframe_indices(video)) and remux_cut_frames(
                video, out, start, end_incl):
            n = end_incl - start + 1
            logger.info(f"Stream-copied {n} frames [{start}, {end_incl}] -> {out}")
            return n
    info = probe_video(video)
    swap = rotation % 180 != 0
    w, h = (info.height, info.width) if swap else (info.width, info.height)
    writer = VideoWriter(out, info.fps, w, h, bitrate=bitrate)
    n = 0
    try:
        for _idx, frame in VideoReader(video, start=start, stop=end_incl + 1):
            writer.write(_rotate_frame(frame, rotation))
            n += 1
    finally:
        writer.close()
    logger.info(f"Wrote {n} frames [{start}, {end_incl}] -> {out}")
    return n


def cut_csv(input_csv: Path, output_csv: Path, start: int, end_incl: int,
            logger: logging.Logger) -> None:
    """Cut and rebase the flight log (the frame range includes its end)."""
    if not input_csv.exists():
        logger.warning(f"No flight log found at '{input_csv}', skipping CSV cut")
        return
    try:
        df = table.read_csv(input_csv)
    except Exception as exc:  # noqa: BLE001
        logger.error(f"Problem with cutting the flight log '{input_csv}': {exc}")
        return
    if "frame" not in df:
        logger.warning(f"'frame' column not found in '{input_csv}', skipping CSV cut")
        return
    table.write_csv(output_csv, rebase_rows(df, start, end_incl + 1))
    logger.info(f"Saved the cut flight log to '{output_csv}'")


def verify_cut(video: Path, out: Path, start: int, end_incl: int,
               logger: logging.Logger, verify_n: int = 30) -> float:
    """Debug verification: sample every Nth frame from both videos at corresponding indices and
    report the per-frame RMSE. Returns the max RMSE observed."""
    total = end_incl - start + 1
    step = max(1, total // verify_n)
    wanted = list(range(0, total, step))
    worst = 0.0
    src = {}
    for idx, frame in VideoReader(video, start=start, stop=end_incl + 1):
        rel = idx - start
        if rel in wanted:
            src[rel] = frame.astype(np.int16)
    for idx, frame in VideoReader(out):
        if idx in src:
            diff = np.abs(frame.astype(np.int16) - src[idx])
            rmse = float(np.sqrt(np.mean(diff.astype(np.float64) ** 2)))
            worst = max(worst, rmse)
            logger.info(f"cut frame {idx} vs input frame {start + idx}: "
                        f"RMSE {rmse:.2f}")
    logger.info(f"verification max RMSE over {len(src)} sampled frames: {worst:.2f}")
    return worst


def recut(video: Path, start: int, end, out: Path, cut_log: bool,
          logger=None) -> int:
    """Library entry kept for find_cut_video_issues.py: end is EXCLUSIVE
    (None = end of video)."""
    log = logger or logging.getLogger("recut")
    info = probe_video(video)
    end_incl = (info.frame_count - 1) if end is None else int(end) - 1
    n = cut_video(Path(video), start, end_incl, Path(out), 0, 0, log)
    if cut_log:
        in_csv = Path(video).with_suffix(".csv")
        cut_csv(in_csv, Path(out).with_suffix(".csv"), start, end_incl, log)
    return n


def default_csv_path(video: Path) -> Path:
    """Companion CSV, trying the video-suffix case first then the other."""
    primary = video.with_suffix(".csv" if video.suffix.islower() else ".CSV")
    fallback = video.with_suffix(".CSV" if video.suffix.islower() else ".csv")
    if primary.exists():
        return primary
    if fallback.exists():
        return fallback
    return primary


def parse_cli_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Cut video and flight log according to specified frame ranges.")
    parser.add_argument("input_video", type=Path)
    parser.add_argument("cuts", type=Path, nargs="?",
                        help="Cuts specification file 'start, end[, rotation]' "
                             "(mutually exclusive with --start/--end)")
    parser.add_argument("--input-csv", "-i", type=Path, default=None,
                        help="Flight-log CSV (default: video stem, .csv/.CSV)")
    parser.add_argument("--start", "-s", type=int, default=None)
    parser.add_argument("--end", "-e", type=int, default=None,
                        help="Cut end frame (INCLUSIVE; -1 = end of video)")
    parser.add_argument("--rotate", "-r", type=int, default=None,
                        help="Counter-clockwise rotation (0, ±90, ±180, ±270)")
    parser.add_argument("--output", "-o", type=Path, default=None,
                        help="Output video path (default: <stem>_cut<ext>)")
    parser.add_argument("--exact-cut", "-ec", action="store_true",
                        help="Cut at the exact frames (skip keyframe snapping)")
    parser.add_argument("--bitrate", "-b", type=str, default=None,
                        help="Re-encode bitrate, e.g. '5M', '10000k' (default: auto)")
    parser.add_argument("--debug", "-d", action="store_true",
                        help="Verify the cut by RMSE-comparing sampled frames")
    parser.add_argument("--log-path", "-lp", type=Path, default=None)
    parser.add_argument("--quiet", "-q", action="store_true")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_cli_args(argv)
    logger = setup_logger("recut_video_and_log", verbose=not args.quiet,
                          log_path=args.log_path)

    if args.start is not None or args.end is not None:
        if args.start is None or args.end is None:
            raise SystemExit("When using --start/--end, both must be provided.")
        start, end = int(args.start), int(args.end)
        rotation = args.rotate if args.rotate is not None else 0
        origin = "<cli-args>"
    else:
        if not args.cuts:
            raise SystemExit("Provide either a cuts file or --start and --end.")
        start, end, rotation = read_cuts_file(args.cuts)
        if args.rotate is not None:
            rotation = args.rotate
        origin = str(args.cuts)
    logger.info(f"Requested cut [{start}, {end}] rotation {rotation}")

    info = probe_video(args.input_video)
    sanity_check(start, end, rotation, info.frame_count, origin)
    end_incl = info.frame_count - 1 if end == -1 else end
    if not args.exact_cut:
        start, end_incl = snap_to_keyframes(args.input_video, start, end_incl,
                                            logger)

    video = args.input_video
    csv_suffix = ".csv" if video.suffix.islower() else ".CSV"
    out = args.output or video.with_name(f"{video.stem}_cut{video.suffix}")
    out_csv_suffix = ".csv" if out.suffix.islower() else ".CSV"
    in_csv = args.input_csv or default_csv_path(video)

    cut_video(video, start, end_incl, out, rotation,
              parse_bitrate(args.bitrate), logger)
    cut_csv(in_csv, out.with_suffix(out_csv_suffix if args.output else csv_suffix),
            start, end_incl, logger)
    if args.debug:
        verify_cut(video, out, start, end_incl, logger)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
