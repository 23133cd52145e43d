"""`aggregate`: merge per-video georeferenced CSVs into a dataset.

The port of ``geotrax_tpu/pipeline/aggregate.py`` without pandas (the
card's machine has none; tables go through ``io/table.py``): scan
``**/<output.folder>/*.csv`` under the PROCESSED tree, group by (date,
location, session) from the path convention
``<date>/D<k>/<session>/<results>/<file>.csv``, order each group by drone
number, offset vehicle IDs for uniqueness (each file's offset is the
previous file's maximum ID after its own offset), add ``Local_Time``
(``%H:%M:%S.%f`` cut to milliseconds) and ``Drone_ID``, write
``Lane_Number`` as a string, sort stably by (``Vehicle_ID``,
``Local_Time``) and write one CSV per group, in the fixed 17-column order,
plus one zip per (date, location).
"""

from __future__ import annotations

import argparse
import logging
import math
import sys
import zipfile
from datetime import datetime
from pathlib import Path

import numpy as np

from geotrax_tpu_torch.io import table
from geotrax_tpu_torch.utils.cli_utils import add_common_args
from geotrax_tpu_torch.utils.config_utils import load_config
from geotrax_tpu_torch.utils.file_utils import DEFAULT_OUTPUT, determine_location_id
from geotrax_tpu_torch.utils.logging_utils import setup_logger

AGGREGATED_COLUMNS = [
    "Vehicle_ID", "Local_Time", "Drone_ID",
    "Ortho_X", "Ortho_Y", "Local_X", "Local_Y", "Latitude", "Longitude",
    "Vehicle_Length", "Vehicle_Width", "Vehicle_Class",
    "Vehicle_Speed", "Vehicle_Acceleration",
    "Road_Section", "Lane_Number", "Visibility",
]


def _missing(x) -> bool:
    return x is None or (isinstance(x, float) and math.isnan(x))


def _group_files(csv_files, logger):
    """Group files by (date, location, session); each entry is (path, drone_id)."""
    groups: dict[tuple, list] = {}
    for path in csv_files:
        try:
            date = path.parents[3].name
            drone_id = path.parents[2].name
            session = path.parents[1].name
            int(drone_id[1:])  # enforce D<number> here, not in the post-loop sort
            location_id = determine_location_id(path, logger)
            groups.setdefault((date, location_id, session), []).append((path, drone_id))
        except Exception as exc:  # noqa: BLE001 — malformed layout: skip, keep batch alive
            logger.warning(f"Skipping invalid file path {path}: {exc}")
    # deterministic order: numeric drone id ('D10' -> 10), then path
    for key, files in groups.items():
        groups[key] = sorted(files, key=lambda item: (int(item[1][1:]), item[0]))
    return groups


def local_time(stamps) -> np.ndarray:
    """Timestamps ('YYYY-MM-DD HH:MM:SS.fff') -> 'HH:MM:SS.mmm' strings (NaN
    stays NaN); an unparseable one raises ValueError."""
    out = [np.nan if _missing(s) else
           datetime.fromisoformat(str(s).strip()).strftime("%H:%M:%S.%f")[:-3] for s in stamps]
    return np.array(out, dtype=object)


def _load_one(path: Path, drone_id: str, vehicle_id_offset: int) -> dict:
    df = table.read_csv(path)
    n = len(df["Vehicle_ID"])
    df["Local_Time"] = local_time(df["Timestamp"])
    df["Drone_ID"] = np.full(n, int(drone_id[1:]), dtype=np.int64)
    df["Vehicle_ID"] = df["Vehicle_ID"] + vehicle_id_offset
    df["Lane_Number"] = np.array(["" if _missing(x) else str(int(x))
                                  for x in df["Lane_Number"].tolist()], dtype=object)
    return {name: df[name] for name in AGGREGATED_COLUMNS}


def _concat(parts: list) -> np.ndarray:
    """One column of several files, typed as ``pd.concat`` types it:
    integers and floats together become float64, other mixtures object."""
    kinds = {p.dtype.kind for p in parts}
    if len(kinds) == 1:
        return np.concatenate(parts)
    if kinds <= {"i", "u", "f"}:
        return np.concatenate([p.astype(np.float64) for p in parts])
    return np.concatenate([p.astype(object) for p in parts])


def _sort_order(vehicle_id: np.ndarray, times: np.ndarray) -> np.ndarray:
    """Stable order by (Vehicle_ID, Local_Time), missing times last (the
    default ``sort_values`` of two columns)."""
    names = sorted({t for t in times.tolist() if not _missing(t)})
    rank = {t: i for i, t in enumerate(names)}
    keys = np.array([len(names) if _missing(t) else rank[t] for t in times.tolist()], np.int64)
    return np.lexsort((keys, vehicle_id))


def aggregate_results(args: argparse.Namespace, logger: logging.Logger) -> None:
    input_path = Path(args.input)
    output_path = Path(args.output_folder) if args.output_folder else input_path.parent / "DATASET"
    logger.info(f"Aggregating: input={input_path} output={output_path}")

    if not input_path.exists():
        logger.critical(f"Input folder '{input_path}' does not exist.")
        sys.exit(1)
    output_path.mkdir(parents=True, exist_ok=True)

    output_cfg = load_config(args.cfg, logger).get("output", DEFAULT_OUTPUT)
    folder_name = output_cfg.get("folder", DEFAULT_OUTPUT["folder"])
    csv_files = list(input_path.rglob(f"**/{folder_name}/*.csv"))
    if not csv_files:
        logger.critical(f"No CSV files found in '{input_path}'")
        sys.exit(1)

    groups = _group_files(csv_files, logger)
    total_unique = 0

    for (date, location_id, session), files in groups.items():
        try:
            subfolder = output_path / f"{date}_{location_id}"
            subfolder.mkdir(exist_ok=True)
            out_file = subfolder / f"{date}_{location_id}_{session}.csv"

            frames = []
            offset = 0
            for path, drone_id in files:
                try:
                    df = _load_one(path, drone_id, offset)
                    offset = int(np.max(df["Vehicle_ID"]))
                    frames.append(df)
                except Exception as exc:  # noqa: BLE001
                    logger.warning(f"Error processing {path}: {exc}")

            if not frames:
                continue
            merged = {name: _concat([f[name] for f in frames]) for name in AGGREGATED_COLUMNS}
            order = _sort_order(merged["Vehicle_ID"], merged["Local_Time"])
            merged = {name: col[order] for name, col in merged.items()}
            ids = merged["Vehicle_ID"]
            unique = len(np.unique(ids[~np.isnan(ids)] if ids.dtype.kind == "f" else ids))
            total_unique += unique
            logger.info(
                f"Group {date}_{location_id}_{session}: {unique} vehicles, {len(ids)} points."
            )
            table.write_csv(out_file, merged)

            zip_path = output_path / f"{date}_{location_id}.zip"
            with zipfile.ZipFile(zip_path, "w", zipfile.ZIP_DEFLATED) as zf:
                for csv in subfolder.glob("*.csv"):
                    zf.write(csv, csv.name)
        except Exception as exc:  # noqa: BLE001 — per-group isolation
            logger.error(f"Error in group {date}_{location_id}_{session}: {exc}")

    logger.info(f"Total unique vehicles: {total_unique}. Aggregation complete.")


def parse_cli_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(prog="python -m geotrax_tpu_torch aggregate",
                                     description="Aggregate georeferenced tracking results")
    parser.add_argument("input", type=Path, help="Path to the PROCESSED folder of georeferenced results.")
    optional = parser.add_argument_group("Optional arguments")
    optional.add_argument(
        "--output-folder", "-of", type=Path, default=None,
        help="Output folder for aggregated results; default: a DATASET folder next to PROCESSED.",
    )
    add_common_args(optional, output_folder=False)
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_cli_args(argv)
    logger = setup_logger("geotrax.aggregate", args.verbose, args.log_path)
    aggregate_results(args, logger)
    return 0


if __name__ == "__main__":
    sys.exit(main())
