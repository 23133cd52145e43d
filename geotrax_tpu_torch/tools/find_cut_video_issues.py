"""Flight-log anomalies of cut videos, with a recut fix and reports: the port
of ``tools/find_cut_video_issues.py``.

Scans flight-log CSVs for frame gaps and duplicates, missing, backward or
jumping timestamps, GPS jumps and altitude spikes; ``--fix`` recuts the
sibling video before the first anomaly (``tools/recut_video_and_log.py``'s
``recut``: stream copy, which needs FFmpeg's libraries); ``--report DIR``
writes ``flight_log_stats.csv`` and ``flight_log_anomalies.csv`` (the input of
``fix_timestamp_anomalies``). Logs and reports go through ``io/table.py``,
timestamps through ``table.to_datetime_ns`` and ``table.diff_seconds``
(``pd.to_datetime(..., errors="coerce").diff().dt.total_seconds()``).

Usage:
  python -m geotrax_tpu_torch.tools.find_cut_video_issues DIR_OR_LOG.csv [--fps 29.97] [--fix]
  python -m geotrax_tpu_torch.tools.find_cut_video_issues PROCESSED/ --report PROCESSED/
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from geotrax_tpu_torch.io import table
from geotrax_tpu_torch.utils.file_utils import determine_location_id

ALTITUDE_COLUMNS = ("rel_alt", "abs_alt", "altitude")


def _float_column(log: dict, name: str) -> np.ndarray:
    return np.asarray(log[name], dtype=float)


def find_anomalies(log: dict, fps: float, tolerance: float = 3.0,
                   gps_jump_m: float = 15.0, alt_jump_m: float = 10.0) -> list:
    """[(frame, kind, detail)] of a flight log's anomalies: frame gaps and
    duplicates, missing or backward/jumping timestamps, GPS position
    glitches and altitude spikes (per-frame jumps far beyond what the
    platform can fly), sorted."""
    out = []
    frames = np.asarray(log["frame"])
    gaps = np.diff(frames)
    for i in np.where(gaps != 1)[0]:
        kind = "frame-duplicate" if gaps[i] == 0 else "frame-gap"
        out.append((int(frames[i]), kind, f"jump {gaps[i]}"))
    ns, missing = table.to_datetime_ns(log["timestamp"])
    for i in np.where(missing)[0]:
        out.append((int(frames[i]), "missing-timestamp", ""))
    dt = table.diff_seconds(ns, missing)
    period = 1.0 / fps
    with np.errstate(invalid="ignore"):
        bad = np.where((dt[1:] < 0) | (dt[1:] > tolerance * period))[0] + 1
    for i in bad:
        if not missing[i] and not missing[i - 1]:
            out.append((int(frames[i]), "timestamp-jump", f"dt={dt[i]:.3f}s"))
    if {"latitude", "longitude"} <= set(log):
        lat, lon = _float_column(log, "latitude"), _float_column(log, "longitude")
        mean_lat = np.nanmean(lat) if np.isfinite(lat).any() else 0.0
        dx = np.diff(lon) * 111320.0 * np.cos(np.deg2rad(mean_lat))
        dy = np.diff(lat) * 111320.0
        step = np.hypot(dx, dy)
        for i in np.where(step > gps_jump_m)[0]:
            out.append((int(frames[i + 1]), "gps-jump", f"{step[i]:.1f} m/frame"))
    alt_col = next((c for c in ALTITUDE_COLUMNS if c in log), None)
    if alt_col is not None:
        dalt = np.abs(np.diff(_float_column(log, alt_col)))
        for i in np.where(dalt > alt_jump_m)[0]:
            out.append((int(frames[i + 1]), "altitude-spike",
                        f"{dalt[i]:.1f} m/frame ({alt_col})"))
    return sorted(out)


def log_stats_row(log_path: Path, log: dict, fps: float, anomalies: list) -> dict:
    """One log's row of ``flight_log_stats.csv``: hover-circle deviations,
    frame and timestamp deviation maxima, and where the first timestamp
    anomaly lies."""
    ns, missing = table.to_datetime_ns(log["timestamp"])
    dt = table.diff_seconds(ns, missing)[1:]
    period = 1.0 / fps
    if not len(dt):
        ts_max_abs_diff = 0.0
    elif np.isnan(dt).all():  # np.nanmax of no number: NaN
        ts_max_abs_diff = float("nan")
    else:
        ts_max_abs_diff = float(np.nanmax(np.abs(dt - period)))
    frames = np.asarray(log["frame"])
    frame_max_abs_diff = int(np.abs(np.diff(frames) - 1).max()) if len(frames) > 1 else 0

    ts_anoms = [a for a in anomalies if a[1] in ("timestamp-jump", "missing-timestamp")]
    anomaly_frame = ts_anoms[0][0] if ts_anoms else np.nan
    anomaly_loc = ""
    if ts_anoms:
        hit = np.asarray(log["timestamp"])[frames == anomaly_frame]
        anomaly_loc = str(hit[0]) if len(hit) else ""

    row = {
        "location_id": determine_location_id(log_path),
        "video_path": log_path.with_suffix(".MP4").name,
        "radius_max_deviation": np.nan,
        "x_max_deviation": np.nan,
        "y_max_deviation": np.nan,
        "rel_altitude_max_deviation": np.nan,
        "frame_max_abs_diff": frame_max_abs_diff,
        "timestamp_max_abs_diff": round(ts_max_abs_diff, 4),
        "timestamp_anomaly_location": anomaly_loc,
        "timestamp_anomaly_frame": anomaly_frame,
        "n_anomalies": len(anomalies),
    }
    # distance of each fix from the log's mean position, and the altitude's excursion
    if {"latitude", "longitude"} <= set(log):
        lat, lon = _float_column(log, "latitude"), _float_column(log, "longitude")
        if np.isfinite(lat).any() and np.isfinite(lon).any():
            mean_lat, mean_lon = np.nanmean(lat), np.nanmean(lon)
            dx = (lon - mean_lon) * 111320.0 * np.cos(np.deg2rad(mean_lat))
            dy = (lat - mean_lat) * 111320.0
            r = np.hypot(dx, dy)
            row["radius_max_deviation"] = round(float(np.nanmax(r)), 2)
            row["x_max_deviation"] = round(float(np.nanmax(np.abs(dx))), 2)
            row["y_max_deviation"] = round(float(np.nanmax(np.abs(dy))), 2)
    alt_col = next((c for c in ALTITUDE_COLUMNS if c in log), None)
    if alt_col is not None:
        alt = _float_column(log, alt_col)
        if np.isfinite(alt).any():
            row["rel_altitude_max_deviation"] = round(
                float(np.nanmax(np.abs(alt - np.nanmean(alt)))), 2)
    return row


def write_report(out_dir: Path, stats_rows: list, threshold: float) -> None:
    out_dir.mkdir(parents=True, exist_ok=True)
    rows = sorted(stats_rows, key=lambda r: (r["location_id"], r["video_path"]))
    stats = table.from_records(rows)
    table.write_csv(out_dir / "flight_log_stats.csv", stats)
    keep = (~np.isnan(table.to_numeric(stats["timestamp_anomaly_frame"]))
            & (table.to_numeric(stats["timestamp_max_abs_diff"]) >= threshold))
    flagged = {k: np.asarray(v)[keep] for k, v in stats.items()}
    table.write_csv(out_dir / "flight_log_anomalies.csv", flagged)
    print(f"Report: {len(rows)} logs, {int(keep.sum())} flagged -> "
          f"{out_dir / 'flight_log_anomalies.csv'}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("path", type=Path, help="A flight-log CSV or a directory")
    parser.add_argument("--fps", type=float, default=30000 / 1001)
    parser.add_argument("--fix", action="store_true",
                        help="Recut the sibling video up to the first anomaly")
    parser.add_argument("--report", type=Path, default=None, metavar="DIR",
                        help="Write flight_log_stats.csv + flight_log_anomalies.csv "
                             "(input for fix_timestamp_anomalies)")
    parser.add_argument("--timestamp-threshold", type=float, default=0.5,
                        help="timestamp_max_abs_diff (s) above which a log is "
                             "reported as an anomaly")
    args = parser.parse_args(argv)

    logs = [args.path] if args.path.is_file() else sorted(args.path.rglob("*.csv"))
    issues_total = 0
    stats_rows = []
    for log_path in logs:
        try:
            log = table.read_csv(log_path)
            if "frame" not in log or "timestamp" not in log:
                continue
        except Exception:  # noqa: BLE001
            continue
        anomalies = find_anomalies(log, args.fps)
        if args.report is not None:
            stats_rows.append(log_stats_row(log_path, log, args.fps, anomalies))
        if not anomalies:
            continue
        issues_total += len(anomalies)
        print(f"{log_path}: {len(anomalies)} anomalie(s)")
        for frame, kind, detail in anomalies[:10]:
            print(f"  frame {frame}: {kind} {detail}")
        if args.fix:
            video = log_path.with_suffix(".mp4")
            if video.exists():
                from geotrax_tpu_torch.tools.recut_video_and_log import recut

                first = anomalies[0][0]
                out = video.with_name(video.stem + "_fixed.mp4")
                recut(video, 0, first, out, cut_log=True)

    if args.report is not None and stats_rows:
        write_report(args.report, stats_rows, args.timestamp_threshold)

    print(f"Scanned {len(logs)} log(s); {issues_total} anomalies.")
    return 0 if issues_total == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
