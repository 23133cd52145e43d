"""Timestamp anomaly correction, cutting videos and flight logs at the
anomaly frames: the port of ``tools/fix_timestamp_anomalies.py``.

Reads an anomaly CSV (``find_cut_video_issues --report``), plans one or two
cut windows around each anomaly frame (a 1 s margin, no segment shorter
than 15 s), writes the cut-specification TXT files, keeps the originals
with an ``_original`` suffix, recuts with ``python -m
geotrax_tpu_torch.tools.recut_video_and_log`` and reprocesses each segment
with ``python -m geotrax_tpu_torch batch --yes --overwrite`` on
``--device``. Tables go through ``io/table.py``; the anomalies are logged
as ``DataFrame.to_string(index=False)`` prints them.

Usage:
  python -m geotrax_tpu_torch.tools.fix_timestamp_anomalies flight_log_anomalies.csv
  python -m geotrax_tpu_torch.tools.fix_timestamp_anomalies anomalies.csv -o /data/PROCESSED -d

Input CSV columns: location_id, video_path, timestamp_max_abs_diff,
timestamp_anomaly_location, timestamp_anomaly_frame.
"""

from __future__ import annotations

import argparse
import logging
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

from geotrax_tpu_torch.io import table
from geotrax_tpu_torch.tools._common import add_device_argument, resolve_tool_device
from geotrax_tpu_torch.utils.logging_utils import setup_logger

MIN_VIDEO_DURATION = 15  # seconds; no shorter segments
FPS = 30                 # margin and duration bookkeeping
NEEDED = ["location_id", "video_path", "timestamp_max_abs_diff",
          "timestamp_anomaly_location", "timestamp_anomaly_frame"]


def plan_cuts(video_path: Path, location_id: str, sequence: int,
              anomaly_frame: int, last_frame: int) -> list[tuple[Path, int, int]]:
    """[(cut_spec_path, start, end)]: one cut when the anomaly lies within
    15 s of either end of the video, else two segments around it."""
    cuts = []
    if anomaly_frame / FPS < MIN_VIDEO_DURATION:
        spec = video_path.with_name(f"0_{location_id}{sequence}_recut.TXT")
        cuts.append((spec, round(anomaly_frame + FPS), -1))
    elif (last_frame - anomaly_frame) / FPS < MIN_VIDEO_DURATION:
        spec = video_path.with_name(f"0_{location_id}{sequence}_recut.TXT")
        cuts.append((spec, 0, round(anomaly_frame - FPS)))
    else:
        spec1 = video_path.with_name(
            f"0_{location_id}{sequence}_{location_id}{sequence}_recut.TXT")
        spec2 = video_path.with_name(
            f"0_{location_id}{sequence}_{location_id}{sequence + 1}_recut.TXT")
        cuts.append((spec1, 0, round(anomaly_frame - FPS)))
        cuts.append((spec2, round(anomaly_frame + FPS), -1))
    return cuts


def _read_anomalies(path: Path) -> dict | None:
    """The needed columns of the rows with an anomaly frame; None when a
    column is missing (the names are logged)."""
    df = table.read_csv(path)
    if [c for c in NEEDED if c not in df]:
        return None
    keep = ~np.isnan(table.to_numeric(df["timestamp_anomaly_frame"]))
    return {c: np.asarray(df[c])[keep] for c in NEEDED}


def _commands(backup_video, spec, backup_csv, out_video, device) -> tuple:
    recut = [sys.executable, "-m", "geotrax_tpu_torch.tools.recut_video_and_log",
             str(backup_video), str(spec), "-i", str(backup_csv),
             "-o", str(out_video), "--exact-cut", "-q"]
    batch = [sys.executable, "-m", "geotrax_tpu_torch", "batch",
             str(out_video), "--yes", "--overwrite", "--device", str(device)]
    return recut, batch


def fix_timestamp_anomalies(args: argparse.Namespace, logger: logging.Logger) -> int:
    df = _read_anomalies(args.input)
    if df is None:
        missing = [c for c in NEEDED if c not in table.read_csv(args.input)]
        logger.error(f"Anomaly CSV is missing columns: {missing}")
        return 1
    n = len(df["location_id"])
    logger.info(f"Found {n} anomalies in total.")
    if n == 0:
        return 0
    logger.info("\n%s", table.to_string(df))

    processed = args.processed_folder or args.input.parent
    for i in range(n):
        video_rel = Path(df["video_path"][i])
        video = processed / video_rel
        csv_path = video.with_suffix(".CSV")
        if not csv_path.exists():
            csv_path = video.with_suffix(".csv")
        location_id = str(df["location_id"][i])
        try:
            sequence = int(video_rel.stem.replace(location_id, ""))
        except ValueError:
            logger.warning(f"Skipping: {video} (stem does not match "
                           f"'<location_id><sequence>' naming)")
            continue
        anomaly_frame = int(df["timestamp_anomaly_frame"][i])

        if not video.exists() or not csv_path.exists():
            logger.warning(f"Skipping: {video} (not found)")
            continue
        next_seq = video.with_name(f"{location_id}{sequence + 1}.CSV")
        next_seq_lower = video.with_name(f"{location_id}{sequence + 1}.csv")
        if next_seq.exists() or next_seq_lower.exists():
            logger.warning(f"Skipping: {video} (higher sequence number exists). "
                           "Rename the subsequent files manually and rerun.")
            continue

        logger.info(f"Fixing: {video}")
        last_frame = int(np.nanmax(table.to_numeric(table.read_csv(csv_path)["frame"])))
        cuts = plan_cuts(video, location_id, sequence, anomaly_frame, last_frame)

        for spec, start, end in cuts:
            logger.info(f"Creating cut: {spec} with start: {start} end: {end}")
            if not args.debug:
                spec.write_text(f"{start}, {end}")

        backup_video = video.with_name(video.stem + "_original" + video.suffix)
        backup_csv = csv_path.with_name(csv_path.stem + "_original" + csv_path.suffix)
        logger.info(f"Renaming: {video} -> {backup_video}")
        logger.info(f"Renaming: {csv_path} -> {backup_csv}")
        if not args.debug:
            os.rename(video, backup_video)
            os.rename(csv_path, backup_csv)

        for spec, _start, _end in cuts:
            out_video = spec.with_name(spec.stem.split("_")[-2] + video.suffix)
            cmd1, cmd2 = _commands(backup_video, spec, backup_csv, out_video, args.device)
            logger.info(f"Running: {' '.join(cmd1)}")
            if not args.debug:
                try:
                    subprocess.run(cmd1, check=True)
                except subprocess.CalledProcessError as exc:
                    logger.error(f"Recut failed for '{out_video}': {exc}")
                    continue
            logger.info(f"Running: {' '.join(cmd2)}")
            if not args.debug:
                try:
                    subprocess.run(cmd2, check=True)
                except subprocess.CalledProcessError as exc:
                    logger.error(f"Batch processing failed for '{out_video}': {exc}")
    return 0


def parse_cli_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Fix timestamp anomalies in flight logs by cutting videos "
                    "and logs at anomaly frames.")
    parser.add_argument("input", type=Path,
                        help="CSV with flight-log anomalies "
                             "(from find_cut_video_issues --report)")
    parser.add_argument("--processed-folder", "-o", type=Path, default=None,
                        help="Root of the processed folder with cut videos and "
                             "flight logs (default: same as input)")
    parser.add_argument("--debug", "-d", action="store_true",
                        help="Dry run: log operations, modify no files")
    parser.add_argument("--log-path", "-lp", type=Path, default=None)
    parser.add_argument("--quiet", "-q", action="store_true")
    add_device_argument(parser)
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_cli_args(argv)
    resolve_tool_device(args)
    logger = setup_logger("fix_timestamp_anomalies", verbose=not args.quiet,
                          log_path=args.log_path)
    return fix_timestamp_anomalies(args, logger)


if __name__ == "__main__":
    raise SystemExit(main())
