"""Dataset QA: kinematic-threshold violations in aggregated or georeferenced
CSVs: the port of ``tools/check_dataset.py``.

Scans CSVs for speed > 130 km/h or |acceleration| > 12 m/s^2 (defaults),
keeps each vehicle's worst row, prints the violations sorted by magnitude,
and traces each violating vehicle back to its source video by replaying the
aggregation's id offsets (``find_source_id``). Tables go through
``io/table.py``; the report is the text ``DataFrame.to_string(index=False)``
prints (``table.to_string``), with pandas' row order: per-vehicle
``idxmax``, ``pd.concat`` keeping each file's row labels, and a descending
``sort_values`` whose labels select rows as ``.loc`` does (a label two
files share selects both rows).

Usage:
  python -m geotrax_tpu_torch.tools.check_dataset DATASET_OR_RESULTS_DIR [--speed 130] [--accel 12]
          [--processed-folder PROCESSED] [--results-folder <name>] [--no-trace]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from geotrax_tpu_torch.io import table as tbl
from geotrax_tpu_torch.tools.find_source_id import find_source

REPORT_COLUMNS = ("Dataset", "Vehicle_ID", "Drone_ID", "Vehicle_Class", "Vehicle_Speed",
                  "Vehicle_Acceleration", "Source_ID", "Source_Video")


class Rows:
    """A table with pandas row labels: {name: column} and ``labels``."""

    def __init__(self, columns: dict, labels: np.ndarray):
        self.columns, self.labels = columns, np.asarray(labels, np.int64)

    def __len__(self) -> int:
        return len(self.labels)

    def take(self, positions) -> "Rows":
        positions = np.asarray(positions, np.int64)
        return Rows({k: np.asarray(v)[positions] for k, v in self.columns.items()},
                    self.labels[positions])

    def loc(self, labels) -> "Rows":
        """``.loc[labels]``: every row of each label, label by label."""
        return self.take([p for lab in np.asarray(labels).tolist()
                          for p in np.nonzero(self.labels == lab)[0].tolist()])


def collect_files(path: Path) -> list[Path]:
    """A file as it is; a directory's own *.csv, else those one level of
    subfolders down."""
    if path.is_file():
        return [path]
    files = sorted(f for f in path.iterdir() if f.suffix.lower() == ".csv")
    if not files:
        for sub in sorted(p for p in path.iterdir() if p.is_dir()):
            files.extend(sorted(f for f in sub.iterdir() if f.suffix.lower() == ".csv"))
    return files


def _magnitude(column, absolute: bool) -> np.ndarray:
    values = np.asarray(column, np.float64)
    return np.abs(values) if absolute else values


def violations_in(df: Rows, column: str, thr: float, absolute: bool) -> Rows | None:
    """The rows over the threshold, one per vehicle (its worst); None where
    the table lacks the columns (pandas' empty frame)."""
    if column not in df.columns or "Vehicle_ID" not in df.columns:
        return None
    over = np.nonzero(_magnitude(df.columns[column], absolute) > thr)[0]
    if not len(over):
        return df.take(over)
    mag = _magnitude(df.columns[column], absolute)[over]
    _, worst = tbl.idxmax_by(np.asarray(df.columns["Vehicle_ID"])[over], mag)
    return df.take(over[worst])


def concat(parts: list) -> Rows | None:
    """``pd.concat`` of the files' violations, row labels kept."""
    parts = [p for p in parts if p is not None]
    if not parts:
        return None
    columns = tbl.concat([p.columns for p in parts])
    return Rows(columns, np.concatenate([p.labels for p in parts]))


def trace_sources(table: Rows, processed: Path | None, results_folder: str | None) -> Rows:
    """Source_ID / Source_Video of each row, by replaying the aggregation
    offsets; a hit is set on every row of its label, as ``.at`` does."""
    n = len(table)
    source_id = np.empty(n, object)
    source_video = np.empty(n, object)
    cache: dict[tuple, object] = {}
    datasets, ids = table.columns["Dataset"], table.columns["Vehicle_ID"]
    for i in range(n):
        key = (datasets[i], int(ids[i]))
        if key not in cache:
            kwargs = {"processed": processed}
            if results_folder:
                kwargs["results_folder"] = results_folder
            cache[key] = find_source(Path(datasets[i]), int(ids[i]), **kwargs)
        hit = cache[key]
        if hit is not None:
            original, _csv_path, video, _drone = hit
            same = table.labels == table.labels[i]
            source_id[same] = int(original)
            source_video[same] = str(video) if video is not None else None
    return Rows({**table.columns, "Source_ID": source_id, "Source_Video": source_video},
                table.labels)


def report(table: Rows | None, sort_col: str, absolute: bool, label: str, args) -> int:
    if table is None or not len(table):
        print(f"No {label} violations.")
        return 0
    order = tbl.argsort_descending(_magnitude(table.columns[sort_col], absolute))
    table = table.loc(table.labels[order])
    if not args.no_trace:
        table = trace_sources(table, args.processed_folder, args.results_folder)
    cols = {c: table.columns[c] for c in REPORT_COLUMNS if c in table.columns}
    cols["Dataset"] = np.array([Path(p).name for p in cols["Dataset"]], dtype=object)
    print(f"\n{len(table)} {label} violation(s):")
    print(tbl.to_string(cols))
    return len(table)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("path", type=Path, help="A CSV file or a directory of CSVs")
    parser.add_argument("--speed", "-st", type=float, default=130.0,
                        help="Speed threshold [km/h]")
    parser.add_argument("--accel", "-at", type=float, default=12.0,
                        help="|Acceleration| threshold [m/s^2]")
    parser.add_argument("--processed-folder", type=Path, default=None,
                        help="PROCESSED tree for source tracing (default: the "
                             "DATASET ancestor's sibling)")
    parser.add_argument("--results-folder", default=None,
                        help="Per-video results folder name inside PROCESSED")
    parser.add_argument("--no-trace", action="store_true",
                        help="Skip tracing violations back to source videos")
    args = parser.parse_args(argv)

    if not args.path.exists():
        print(f"'{args.path}' not found.")
        return 1
    files = collect_files(args.path)
    if not files:
        print(f"No .csv files under '{args.path}'.")
        return 1

    speeding, harsh = [], []
    for f in files:
        try:
            columns = tbl.read_csv(f)
        except Exception as exc:  # noqa: BLE001
            print(f"{f}: unreadable ({exc})")
            continue
        n = len(next(iter(columns.values()))) if columns else 0
        columns["Dataset"] = np.full(n, str(f), dtype=object)
        df = Rows(columns, np.arange(n))
        speeding.append(violations_in(df, "Vehicle_Speed", args.speed, absolute=False))
        harsh.append(violations_in(df, "Vehicle_Acceleration", args.accel, absolute=True))

    n = report(concat(speeding), "Vehicle_Speed", False, f"speed > {args.speed:g} km/h", args)
    n += report(concat(harsh), "Vehicle_Acceleration", True,
                f"|accel| > {args.accel:g} m/s^2", args)
    print(f"\nChecked {len(files)} file(s); {n} violating vehicle-row(s).")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
