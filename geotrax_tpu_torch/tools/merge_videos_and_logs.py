"""Concatenate split drone videos and their DJI flight logs per session:
the port of ``tools/merge_videos_and_logs.py``.

DJI splits long recordings into numbered parts (the 4 GB FAT32 cap) with
companion .SRT telemetry. This tool finds session directories recursively
under a root, checks each part, concatenates the videos without
re-encoding (stream copy through the port's ``io/native/remux.cpp``, what
``ffmpeg -f concat -codec copy`` does), and
merges the SRT blocks with continuous wall-clock timestamps and frame
counters (``dji_srt``). Edited video stems (DJI_0212_trimmed.mp4) still
find their SRT. Where the remux library cannot be built, the parts are
decoded and re-encoded through ``io/video.py``, as the reference tool
does. Per-part .csv logs are joined with ``io/table.py``.

Session mode:
  python -m geotrax_tpu_torch.tools.merge_videos_and_logs RAW/ --output-dir PROCESSED/ \
      [--output-stem 0_merged] [--video-ext .MP4] [--overwrite] [--dry-run]

Explicit-parts mode:
  python -m geotrax_tpu_torch.tools.merge_videos_and_logs PART1.mp4 PART2.mp4 ... -o MERGED.mp4
  python -m geotrax_tpu_torch.tools.merge_videos_and_logs --glob "session1/*.mp4" -o MERGED.mp4
"""

from __future__ import annotations

import argparse
from pathlib import Path

from geotrax_tpu_torch.io import table
from geotrax_tpu_torch.io.native import remux_concat, validate_video
from geotrax_tpu_torch.io.video import VideoReader, VideoWriter, probe_video
from geotrax_tpu_torch.tools import dji_srt
from geotrax_tpu_torch.utils.logging_utils import setup_logger


def find_session_dirs(source_dir: Path, video_ext: str) -> list:
    """All directories under source_dir directly containing >=1 video file."""
    return sorted({
        p.parent for p in source_dir.rglob("*")
        if p.is_file() and p.suffix.lower() == video_ext.lower()
    })


def find_video_srt_pairs(session_dir: Path, video_ext: str, logger) -> list:
    """[(video, srt-or-None)] sorted by name, corrupted videos skipped."""
    videos = sorted(
        p for p in session_dir.iterdir()
        if p.is_file() and p.suffix.lower() == video_ext.lower()
    )
    pairs = []
    for video in videos:
        ok = validate_video(video)
        if ok is False:
            logger.warning(f"Skipping corrupted or unreadable video: '{video.name}'.")
            continue
        if ok is None and probe_video(video) is None:
            logger.warning(f"Skipping unreadable video: '{video.name}'.")
            continue
        srt = dji_srt.companion_srt(video)
        if srt is None:
            logger.warning(f"No SRT companion found for '{video.name}'; this "
                           "flight will be excluded from the SRT merge.")
        elif srt.stat().st_size == 0:
            logger.warning(f"'{srt.name}' is empty; skipping SRT for this flight.")
            srt = None
        pairs.append((video, srt))
    return pairs


def merge_videos(parts: list, out_path: Path, logger,
                 overwrite: bool = False, dry_run: bool = False) -> int:
    """Concatenate video parts into out_path. Stream-copy remux first (no
    quality loss); decode/re-encode through the first-party pipeline when the
    native remux library is unavailable. Returns total frames (re-encode
    path) or -1 (remux path: frames not counted)."""
    if out_path.exists() and not overwrite:
        logger.info(f"Merged video already exists at '{out_path}'; skipping "
                    "(use --overwrite to force).")
        return -1
    logger.info(f"Merging {len(parts)} video file(s) into '{out_path.name}':")
    for p in parts:
        logger.info(f"  + {p.name}")
    if dry_run:
        logger.info(f"[dry-run] Would write merged video to '{out_path}'.")
        return -1
    if remux_concat(parts, out_path):
        logger.info(f"Merged video saved to '{out_path}' (stream copy).")
        return -1
    logger.warning("Native remux unavailable; falling back to decode/re-encode.")
    info = probe_video(parts[0])
    writer = VideoWriter(out_path, info.fps, info.width, info.height)
    total = 0
    for part in parts:
        for _idx, frame in VideoReader(part):
            writer.write(frame)
            total += 1
    writer.close()
    logger.info(f"Merged video saved to '{out_path}' ({total} frames re-encoded).")
    return total


def merge_logs(pairs: list, out_base: Path, logger, srt_csv: bool = False,
               overwrite: bool = False, dry_run: bool = False) -> None:
    """Merge companion SRTs (continuous timestamps/counters) and any
    per-part CSV logs (frame renumbering) next to the merged video."""
    srt_out = out_base.with_suffix(".srt")
    srt_parts = [dji_srt.read_srt(s) for _, s in pairs if s is not None]
    if srt_parts and (overwrite or not srt_out.exists()):
        missing = sum(1 for _, s in pairs if s is None)
        if missing:
            logger.warning(f"{missing} flight(s) have no SRT; their metadata "
                           "will be absent from the merged log.")
        merged = dji_srt.merge_blocks(srt_parts)
        if dry_run:
            logger.info(f"[dry-run] Would write merged SRT ({len(merged)} "
                        f"blocks) to '{srt_out}'.")
        else:
            dji_srt.write_srt(srt_out, merged)
            logger.info(f"Merged SRT -> {srt_out} ({len(merged)} blocks)")
            if srt_csv:
                csv_out = out_base.with_name(out_base.stem + "_srt.csv")
                table.write_csv(csv_out, dji_srt.srt_table(merged))
                logger.info(f"SRT telemetry CSV -> {csv_out}")
    elif srt_parts:
        logger.info(f"Merged SRT already exists at '{srt_out}'; skipping.")
    else:
        logger.warning("No SRT flight logs found; only the video was merged.")

    logs, offset = [], 0
    for video, _ in pairs:
        log = video.with_suffix(".csv")
        n = None
        if log.exists():
            df = table.read_csv(log)
            df["frame"] = df["frame"] + offset
            logs.append(df)
            n = dji_srt.table_rows(df)
        if n is None:
            info = probe_video(video)
            n = info.frame_count if info else 0
        offset += n
    if logs and not dry_run:
        csv_out = out_base.with_suffix(".csv")
        if overwrite or not csv_out.exists():
            table.write_csv(csv_out, table.concat(logs))
            logger.info(f"Merged log -> {csv_out}")


def run_session_mode(args, logger) -> int:
    source_dir = args.source_dir.resolve()
    output_root = (args.output_dir or source_dir).resolve()
    sessions = find_session_dirs(source_dir, args.video_ext)
    if not sessions:
        logger.error(f"No '{args.video_ext}' files found under '{source_dir}'.")
        return 1
    logger.info(f"Found {len(sessions)} session director"
                f"{'y' if len(sessions) == 1 else 'ies'} under '{source_dir}'.")
    ext = args.video_ext.lstrip(".").lower()
    for session in sessions:
        out_dir = output_root / session.relative_to(source_dir)
        logger.info(f"--- Session: '{session}' ---")
        pairs = find_video_srt_pairs(session, args.video_ext, logger)
        if not pairs:
            logger.warning(f"No valid video files in '{session}'; skipping.")
            continue
        if not args.dry_run:
            out_dir.mkdir(parents=True, exist_ok=True)
        out_video = out_dir / f"{args.output_stem}.{ext}"
        merge_videos([v for v, _ in pairs], out_video, logger,
                     overwrite=args.overwrite, dry_run=args.dry_run)
        merge_logs(pairs, out_video, logger, srt_csv=args.srt_csv,
                   overwrite=args.overwrite, dry_run=args.dry_run)
    return 0


def run_parts_mode(args, logger) -> int:
    parts = sorted(Path(".").glob(args.glob)) if args.glob else list(args.parts)
    if not parts:
        logger.error("No input parts.")
        return 1
    pairs = [(p, dji_srt.companion_srt(p)) for p in parts]
    merge_videos(parts, args.out, logger, overwrite=True, dry_run=args.dry_run)
    merge_logs(pairs, args.out, logger, srt_csv=args.srt_csv,
               overwrite=True, dry_run=args.dry_run)
    logger.info(f"Merged {len(parts)} part(s) -> {args.out}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Concatenate split drone videos and their DJI flight logs per session.")
    parser.add_argument("source_dir", nargs="?", type=Path, default=None,
                        help="Root directory to search recursively for per-flight videos.")
    parser.add_argument("parts", nargs="*", type=Path,
                        help="Explicit video parts (with -o).")
    parser.add_argument("--output-dir", "-od", type=Path, default=None,
                        help="Root for merged outputs; the structure under "
                             "source_dir is mirrored (default: source_dir).")
    parser.add_argument("--output-stem", "-os", type=str, default="0_merged",
                        help="Stem for merged output filenames (default: 0_merged).")
    parser.add_argument("--video-ext", "-ve", type=str, default=".MP4",
                        help="Video extension to search for, with the leading "
                             "dot (default: .MP4). Case-insensitive.")
    parser.add_argument("--overwrite", "-ow", action="store_true",
                        help="Overwrite existing merged output files.")
    parser.add_argument("--dry-run", "-dr", action="store_true",
                        help="Simulate merging without writing files.")
    parser.add_argument("--glob", type=str, default=None,
                        help="Glob for explicit parts (with -o).")
    parser.add_argument("--out", "-o", type=Path, default=None,
                        help="Output video path (explicit-parts mode).")
    parser.add_argument("--srt-csv", action="store_true",
                        help="Also export merged SRT telemetry as a flight-log CSV.")
    parser.add_argument("--log-path", "-lp", type=Path, default=None,
                        help="Log directory or file path.")
    parser.add_argument("--quiet", "-q", action="store_true",
                        help="Reduce console verbosity.")
    args = parser.parse_args(argv)
    logger = setup_logger("merge_videos_and_logs", verbose=not args.quiet,
                          log_path=args.log_path, dry_run=args.dry_run)

    if args.out is not None:
        # explicit-parts mode: the positional source_dir (if any) is a part
        if args.source_dir is not None:
            args.parts = [args.source_dir] + list(args.parts)
        return run_parts_mode(args, logger)
    if args.source_dir is None or not args.source_dir.is_dir():
        parser.error("source_dir must be a directory (or pass parts with -o).")
    return run_session_mode(args, logger)


if __name__ == "__main__":
    raise SystemExit(main())
