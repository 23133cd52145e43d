"""Trace an aggregated Vehicle_ID back to its source video: the port of
``tools/find_source_id.py``.

Aggregation offsets the vehicle ids of each source CSV
(``pipeline/aggregate.py``); this replays its grouping (``_group_files``)
and offsets to report the source CSV, video, drone and original id of an
aggregated id. ``find_source`` is the library entry ``check_dataset``
uses. Each shard's largest Vehicle_ID is read with ``io/table.py`` (only
that column, as pandas' ``usecols``).

Usage:
  python -m geotrax_tpu_torch.tools.find_source_id PROCESSED_DIR DATE LOCATION SESSION VEHICLE_ID
  python -m geotrax_tpu_torch.tools.find_source_id --dataset-csv DATASET/2022-10-04_U_AM1.csv VEHICLE_ID
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

import numpy as np

from geotrax_tpu_torch.io import table
from geotrax_tpu_torch.pipeline.aggregate import _group_files
from geotrax_tpu_torch.utils.constants import VIDEO_FORMATS
from geotrax_tpu_torch.utils.file_utils import DEFAULT_OUTPUT

_log = logging.getLogger("find_source_id")


def resolve_processed(dataset_csv: Path, processed: Path | None) -> Path | None:
    """The PROCESSED tree of an aggregated CSV: ``processed`` when given,
    else the sibling of its DATASET ancestor (<root>/DATASET/<date>_<loc>_
    <session>.csv next to <root>/PROCESSED/<date>/D*/...)."""
    if processed is not None:
        return processed
    for parent in Path(dataset_csv).resolve().parents:
        if parent.name == "DATASET":
            cand = parent.parent / "PROCESSED"
            return cand if cand.is_dir() else None
    return None


def source_video_for(results_csv: Path) -> Path | None:
    """The source video of a per-video results CSV: <stem>.<video ext>
    (either case) in the folder that holds the results directory."""
    clip_dir = results_csv.parents[1]
    for ext in VIDEO_FORMATS:
        for cand in (clip_dir / (results_csv.stem + ext),
                     clip_dir / (results_csv.stem + ext.upper())):
            if cand.exists():
                return cand
    return None


def _largest_id(path: Path) -> int:
    ids = table.to_numeric(table.read_columns(path, ["Vehicle_ID"])["Vehicle_ID"])
    return int(np.nanmax(ids))


def find_source(dataset_csv: Path, vehicle_id: int, processed: Path | None = None,
                results_folder: str = DEFAULT_OUTPUT["folder"]):
    """(original_id, source_csv, source_video, drone_id) of an aggregated
    vehicle id, or None when the trace fails (no PROCESSED tree, unknown
    group, or an id out of range)."""
    processed = resolve_processed(dataset_csv, processed)
    if processed is None:
        return None
    parts = Path(dataset_csv).stem.split("_")
    if len(parts) < 3:
        return None
    key = tuple(parts[:3])
    groups = _group_files(list(processed.rglob(f"**/{results_folder}/*.csv")), _log)
    entries = groups.get(key)
    if not entries:
        return None
    offset = 0
    for path, drone_id in entries:
        try:
            local_max = _largest_id(path)
        except Exception as exc:  # an unreadable shard: keep tracing the rest
            _log.warning("skipping %s: %s", path, exc)
            continue
        if offset < vehicle_id <= offset + local_max:
            return vehicle_id - offset, path, source_video_for(path), drone_id
        offset += local_max
    return None


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("processed", type=Path, nargs="?",
                        help="PROCESSED folder used for aggregation")
    parser.add_argument("date", nargs="?")
    parser.add_argument("location", nargs="?")
    parser.add_argument("session", nargs="?")
    parser.add_argument("vehicle_id", type=int)
    parser.add_argument("--dataset-csv", type=Path, default=None,
                        help="Aggregated <date>_<loc>_<session>.csv; its name and "
                             "DATASET location imply the positional arguments")
    parser.add_argument("--results-folder", default=DEFAULT_OUTPUT["folder"])
    args = parser.parse_args(argv)

    if args.dataset_csv is not None:
        hit = find_source(args.dataset_csv, args.vehicle_id, processed=args.processed,
                          results_folder=args.results_folder)
    else:
        if not (args.processed and args.date and args.location and args.session):
            parser.error("either --dataset-csv or PROCESSED DATE LOCATION SESSION")
        synthetic = Path(f"{args.date}_{args.location}_{args.session}.csv")
        hit = find_source(synthetic, args.vehicle_id, processed=args.processed,
                          results_folder=args.results_folder)

    if hit is None:
        print(f"Vehicle {args.vehicle_id}: no source found (check the PROCESSED "
              f"tree / group naming).")
        return 1
    original, csv_path, video, drone_id = hit
    print(f"Vehicle {args.vehicle_id} -> '{csv_path}' (drone {drone_id}, "
          f"original id {original})")
    if video is not None:
        print(f"Source video: {video}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
