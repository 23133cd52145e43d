"""`plot`: trajectory, kinematics and distribution figures.

The port of ``geotrax_tpu/pipeline/plot.py`` and ``_plot_impl.py``:
trajectory maps in every coordinate system the pipeline produced
(unstabilized/stabilized pixels, orthophoto pixels -- plain, on the
orthophoto, on the segmentation overlay -- local metres, WGS84 degrees),
violin speed/acceleration distributions (and the joint twin-axis figure),
class counts, vehicle length/width box plots, one vehicle's kinematics,
per file or aggregated per location ID, data-quality alerts (speed above
90 km/h, |acceleration| above 5 m/s^2), PDFs in a ``plots/`` folder.

The data half (file choice, readers, class filter, aggregation, alerts) is
numpy on the host, with tables as ``io/table.py`` columns (no pandas). The
figures need matplotlib (Agg) and seaborn, imported only when figures are
drawn, and given numpy arrays; without them the stage raises
``RuntimeError``. Plot does no device work, as in the reference.
"""

from __future__ import annotations

import argparse
import math
import sys
from pathlib import Path

import numpy as np

from geotrax_tpu_torch.io import table
from geotrax_tpu_torch.utils.cli_utils import DEFAULT_CFG, add_common_args
from geotrax_tpu_torch.utils.config_utils import (backfill_args_from_config, load_config,
                                                  resolve_class_names)
from geotrax_tpu_torch.utils.constants import (ACCELERATION_ALERT_MS2, RESULTS_FORMATS,
                                               SPEED_ALERT_KMH, VIDEO_FORMATS)
from geotrax_tpu_torch.utils.data_utils import PlotColors
from geotrax_tpu_torch.utils.file_utils import (build_result_path, detect_delimiter,
                                                determine_location_id)
from geotrax_tpu_torch.utils.logging_utils import setup_logger


def default_plot_args(**overrides) -> argparse.Namespace:
    """Namespace carrying this stage's defaults (for callers like `batch`)."""
    defaults = {
        "input": None,
        "save": None,
        "show": None,
        "cfg": DEFAULT_CFG,
        "output_folder": None,
        "log_path": None,
        "verbose": False,
        "aggregate": None,
        "ortho_folder": None,
        "segmentation_folder": None,
        "segmentations": None,
        "id": 0,
        "points": None,
        "class_filter": None,
        "model": None,
        "class_names": None,
    }
    defaults.update(overrides)
    return argparse.Namespace(**defaults)


def add_plotting_args(group, dest_prefix: str = "") -> None:
    """The plotting flags of `plot` and `batch`; ``dest_prefix='plot_'``
    avoids attribute collisions in batch's combined parser."""
    opt = argparse.BooleanOptionalAction
    group.add_argument("--plot-save", "-ps", dest=f"{dest_prefix}save", action=opt, default=None,
                       help="Save the plots as .pdf files.")
    group.add_argument("--plot-show", "-psh", dest=f"{dest_prefix}show", action=opt, default=None,
                       help="Show plots in an interactive window.")
    group.add_argument("--plot-aggregate", "-pa", dest=f"{dest_prefix}aggregate", action=opt,
                       default=None,
                       help="Merge trajectories from all videos sharing a location ID into one plot.")
    group.add_argument("--plot-points", "-pp", dest=f"{dest_prefix}points", action=opt, default=None,
                       help="Plot discrete trajectory points instead of connected lines.")
    group.add_argument("--plot-segmentations", "-pseg", dest=f"{dest_prefix}segmentations",
                       action=opt, default=None,
                       help="Also plot on the lane segmentation overlay PNG.")
    group.add_argument("--plot-class-filter", "-pcf", dest=f"{dest_prefix}class_filter",
                       type=int, nargs="+", default=None,
                       help="Class IDs to exclude from plots.")


GEO_COLUMNS = {"Vehicle_ID", "Ortho_X", "Ortho_Y", "Local_X", "Local_Y",
               "Latitude", "Longitude"}


# ---------------------------------------------------------------------------
# Tables: {column name: numpy column}, the rows in file order
# ---------------------------------------------------------------------------

def _rows(df: dict, mask: np.ndarray) -> dict:
    return {k: v[mask] for k, v in df.items()}


def _nan(col: np.ndarray) -> np.ndarray:
    """Missing cells of a column (NaN, or None/NaN in an object column)."""
    if col.dtype.kind == "f":
        return np.isnan(col)
    if col.dtype.kind == "O":
        return np.array([x is None or (isinstance(x, float) and math.isnan(x)) for x in col], bool)
    return np.zeros(len(col), bool)


def concat(frames: list) -> dict:
    """The rows of ``frames`` one after another over the union of their
    columns (first-seen order); a column a frame lacks is NaN there, as
    ``pd.concat(..., ignore_index=True)`` fills it."""
    names: list = []
    for df in frames:
        names += [k for k in df if k not in names]
    out = {}
    for name in names:
        parts = []
        for df in frames:
            n = len(next(iter(df.values()))) if df else 0
            parts.append(df[name] if name in df else np.full(n, np.nan))
        out[name] = np.concatenate(parts) if parts else np.empty(0)
    return out


def groups(keys: np.ndarray) -> list:
    """(key, row indices) per distinct non-missing key, in sorted key order,
    the rows of a group in table order (pandas' groupby)."""
    rows = np.nonzero(~_nan(keys))[0]
    order = rows[np.argsort(keys[rows], kind="stable")]
    if not len(order):
        return []
    uniq, starts = np.unique(keys[order], return_index=True)
    ends = list(starts[1:]) + [len(order)]
    return [(k, order[s:e]) for k, s, e in zip(uniq.tolist(), starts.tolist(), ends)]


def first_valid(col: np.ndarray, rows: np.ndarray):
    """The first non-missing cell of ``col`` in ``rows`` (groupby's
    ``first``), or NaN."""
    valid = rows[~_nan(col[rows])]
    return col[valid[0]] if len(valid) else np.nan


def moving_vehicles(df: dict, column: str, cutoff) -> np.ndarray:
    """Rows of the vehicles whose largest ``column`` value exceeds ``cutoff``."""
    keep = np.zeros(len(df["Vehicle_ID"]), bool)
    for _, rows in groups(df["Vehicle_ID"]):
        vals = df[column][rows].astype(float)
        if np.any(~np.isnan(vals)) and np.nanmax(vals) > cutoff:
            keep[rows] = True
    return keep


# ---------------------------------------------------------------------------
# Input discovery and loading
# ---------------------------------------------------------------------------

def determine_files_to_process(input_path: Path, plotting_cfg: dict, out_cfg: dict,
                               logger) -> list:
    """Result files to plot: a video resolves to its result files; a results
    file is used directly; a folder is scanned recursively."""
    skip = plotting_cfg.get("skip_filenames_with") or []

    def keep(p: Path) -> bool:
        return not any(token in p.stem for token in skip)

    if input_path.is_file():
        if input_path.suffix.lower() in VIDEO_FORMATS:
            candidates = [
                build_result_path(input_path, "georeferenced", out_cfg),
                build_result_path(input_path, "processed", out_cfg),
            ]
            files = [c for c in candidates if c.exists()]
            if not files:
                logger.critical(f"No result files found for video '{input_path}'.")
                sys.exit(1)
            return [files[0]]
        if input_path.suffix.lower() in RESULTS_FORMATS:
            return [input_path]
        logger.critical(f"Unsupported input '{input_path}'.")
        sys.exit(1)

    folder_name = out_cfg.get("folder", "results")
    files = sorted(
        p for p in input_path.rglob(f"**/{folder_name}/*")
        if p.suffix.lower() in RESULTS_FORMATS and keep(p)
    )
    # prefer the georeferenced CSV over the pixel txt of the same stem
    by_stem: dict = {}
    for p in files:
        cur = by_stem.get((p.parent, p.stem))
        if cur is None or (cur.suffix == ".txt" and p.suffix == ".csv"):
            by_stem[(p.parent, p.stem)] = p
    files = sorted(by_stem.values())
    if not files:
        logger.critical(f"No result files found under '{input_path}'.")
        sys.exit(1)
    return files


def read_trajectory_data(path: Path, logger) -> dict:
    """Load either a georeferenced CSV (named columns) or a pixel tracks txt
    into one table of named columns."""
    if path.suffix.lower() == ".csv":
        df = table.read_csv(path)
        if not GEO_COLUMNS.issubset(df):
            logger.critical(f"'{path}' lacks the georeferenced schema.")
            sys.exit(1)
        return df
    arr = np.loadtxt(path, delimiter=detect_delimiter(path), ndmin=2)
    df = {
        "Frame_Number": arr[:, 0].astype(int),
        "Vehicle_ID": arr[:, 1].astype(int),
        "Unstab_X": arr[:, 2], "Unstab_Y": arr[:, 3],
    }
    if arr.shape[1] >= 14:
        df.update(Stab_X=arr[:, 6], Stab_Y=arr[:, 7], Vehicle_Class=arr[:, 10].astype(int),
                  Pixel_Length=arr[:, 12], Pixel_Width=arr[:, 13])
    elif arr.shape[1] >= 10:
        df.update(Vehicle_Class=arr[:, 6].astype(int), Pixel_Length=arr[:, 8],
                  Pixel_Width=arr[:, 9])
    return df


def filter_classes(df: dict, class_filter) -> dict:
    if class_filter and "Vehicle_Class" in df:
        return _rows(df, ~np.isin(df["Vehicle_Class"], list(class_filter)))
    return df


def report_high_value_instances(df: dict, logger) -> None:
    """Data-quality alerts (speed above 90 km/h, |acceleration| above 5 m/s^2)."""
    if "Vehicle_Speed" in df:
        speeding = df["Vehicle_Speed"].astype(float) > SPEED_ALERT_KMH
        if speeding.any():
            ids = sorted(np.unique(df["Vehicle_ID"][speeding]))
            logger.warning(
                f"{len(ids)} vehicle(s) exceed {SPEED_ALERT_KMH:.0f} km/h: {ids[:20]}"
            )
    if "Vehicle_Acceleration" in df:
        harsh = np.abs(df["Vehicle_Acceleration"].astype(float)) > ACCELERATION_ALERT_MS2
        if harsh.any():
            ids = sorted(np.unique(df["Vehicle_ID"][harsh]))
            logger.warning(
                f"{len(ids)} vehicle(s) exceed |{ACCELERATION_ALERT_MS2:.0f}| m/s^2: {ids[:20]}"
            )


def plot_jobs(args, files: list, logger) -> list:
    """(stem, plots_dir, [(label, table)]) per figure set: one per file, or
    with ``aggregate`` on a folder one per location ID."""
    input_path = Path(args.input)

    def load(f):
        return filter_classes(read_trajectory_data(f, logger), args.class_filter)

    if args.aggregate and input_path.is_dir():
        by_location: dict = {}
        for f in files:
            by_location.setdefault(determine_location_id(f, logger), []).append(f)
        return [(loc, input_path / "plots", [(m.stem, load(m)) for m in members])
                for loc, members in by_location.items()]
    return [(f.stem, f.parent / "plots", [(f.stem, load(f))]) for f in files]


# ---------------------------------------------------------------------------
# Figures (matplotlib and seaborn, imported when figures are drawn)
# ---------------------------------------------------------------------------

def pyplot():
    """matplotlib's pyplot on the Agg backend; raises RuntimeError without
    matplotlib."""
    try:
        import matplotlib
    except ImportError:
        raise RuntimeError("the plot stage's figures need matplotlib (and seaborn), which "
                           "is not installed") from None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def seaborn():
    try:
        import seaborn as sns
    except ImportError:
        raise RuntimeError("the plot stage's distribution figures need seaborn, which is not "
                           "installed") from None
    return sns


def _save(fig, plots_dir: Path, stem: str, title: str, save: bool, show: bool, logger):
    plt = pyplot()
    if save:
        plots_dir.mkdir(parents=True, exist_ok=True)
        out = plots_dir / f"{stem}_{title.replace(' ', '_')}.pdf"
        fig.savefig(out, bbox_inches="tight")
        logger.info(f"Saved plot: '{out}'")
    if show:  # pragma: no cover - interactive
        plt.show()
    plt.close(fig)


def plot_trajectories_xy(datasets, x_col, y_col, title, xlabel, ylabel,
                         plots_dir, stem, cfg, logger, background=None,
                         invert_y=False, points=False):
    """One trajectory map; ``datasets`` is [(label, table)] so aggregation
    can overlay several sources in distinct colors."""
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(10, 7))
    colors = PlotColors(cfg.get("colors"))
    if background is not None:
        ax.imshow(background)
    plotted = 0
    for src_idx, (label, df) in enumerate(datasets):
        if x_col not in df:
            # skip just this member (e.g. a pixel-only .txt in an aggregated
            # group): the others still draw; only an all-miss aborts
            logger.info(f"'{label}': no {x_col} column; omitted from '{title}'.")
            continue
        plotted += 1
        color = colors(src_idx) if len(datasets) > 1 else None
        for _, rows in groups(df["Vehicle_ID"]):
            if points:
                ax.scatter(df[x_col][rows], df[y_col][rows], s=1, color=color or colors(0))
            else:
                ax.plot(df[x_col][rows], df[y_col][rows], linewidth=0.7, color=color, alpha=0.8)
    if plotted == 0:
        plt.close(fig)
        return
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.set_title(title.replace("_", " "))
    if invert_y and background is None:
        ax.invert_yaxis()
    ax.set_aspect("equal", adjustable="datalim")
    _save(fig, plots_dir, stem, title, cfg["save"], cfg["show"], logger)


def plot_kinematic_distribution(df, column, unit, title, plots_dir, stem, cfg, logger,
                                cutoff=None):
    if column not in df:
        return
    sns, plt = seaborn(), pyplot()
    keep = ~_nan(df[column])
    if cutoff is not None and column == "Vehicle_Speed":
        keep &= moving_vehicles(df, column, cutoff)
    values = df[column][keep].astype(float)
    if not len(values):
        return
    fig, ax = plt.subplots(figsize=(8, 5))
    sns.violinplot(x=values, ax=ax, inner="quartile")
    ax.set_xlabel(f"{column.replace('_', ' ')} [{unit}]")
    ax.set_title(title.replace("_", " "))
    _save(fig, plots_dir, stem, title, cfg["save"], cfg["show"], logger)


def plot_kinematics_jointly(df, plots_dir, stem, cfg, logger, cutoff=None):
    if "Vehicle_Speed" not in df or "Vehicle_Acceleration" not in df:
        return
    sns, plt = seaborn(), pyplot()
    sub = _rows(df, ~_nan(df["Vehicle_Speed"]) & ~_nan(df["Vehicle_Acceleration"]))
    if cutoff is not None:
        sub = _rows(sub, moving_vehicles(sub, "Vehicle_Speed", cutoff))
    if not len(sub["Vehicle_ID"]):
        return
    fig, ax1 = plt.subplots(figsize=(9, 5))
    sns.violinplot(x=sub["Vehicle_Speed"].astype(float), ax=ax1, inner="quartile",
                   color="#3274d9")
    ax1.set_xlabel("Vehicle Speed [km/h]")
    ax2 = ax1.twiny()
    sns.violinplot(x=sub["Vehicle_Acceleration"].astype(float), ax=ax2, inner="quartile",
                   color="#ff9d00")
    ax2.set_xlabel("Vehicle Acceleration [m/s$^2$]")
    ax1.set_title("Speed and acceleration distribution")
    _save(fig, plots_dir, stem, "Speed_and_acceleration_distribution",
          cfg["save"], cfg["show"], logger)


def plot_class_distribution(df, class_names, plots_dir, stem, cfg, logger):
    if "Vehicle_Class" not in df:
        return
    plt = pyplot()
    per_vehicle = np.array([first_valid(df["Vehicle_Class"], rows)
                            for _, rows in groups(df["Vehicle_ID"])])
    per_vehicle = per_vehicle[~_nan(per_vehicle)] if len(per_vehicle) else per_vehicle
    classes, counts = np.unique(per_vehicle, return_counts=True)
    fig, ax = plt.subplots(figsize=(7, 5))
    labels = [str(class_names.get(int(c), int(c))) for c in classes]
    ax.bar(labels, counts, color=[PlotColors()(i) for i in range(len(counts))])
    ax.set_ylabel("Vehicle count")
    ax.set_title("Class distribution")
    for i, v in enumerate(counts):
        ax.text(i, v, str(v), ha="center", va="bottom")
    _save(fig, plots_dir, stem, "Class_distribution", cfg["save"], cfg["show"], logger)


def plot_dimension_distribution(df, column, title, unit, plots_dir, stem, cfg, logger):
    if column not in df:
        return
    sns, plt = seaborn(), pyplot()
    per = [(first_valid(df[column], rows), first_valid(df["Vehicle_Class"], rows))
           for _, rows in groups(df["Vehicle_ID"])]
    per = [(v, c) for v, c in per if not (_missing(v) or _missing(c))]
    if not per:
        return
    values = np.array([v for v, _ in per], dtype=df[column].dtype)
    classes = np.array([c for _, c in per], dtype=df["Vehicle_Class"].dtype)
    fig, ax = plt.subplots(figsize=(8, 5))
    sns.boxplot(x=classes, y=values, ax=ax)
    ax.set_xlabel("Vehicle_Class")
    ax.set_ylabel(f"{title.replace('_', ' ')} [{unit}]")
    _save(fig, plots_dir, stem, title, cfg["save"], cfg["show"], logger)


def plot_vehicle_detail(df, vehicle_id, plots_dir, stem, cfg, logger):
    if vehicle_id <= 0 or "Vehicle_Speed" not in df:
        return
    sub = _rows(df, df["Vehicle_ID"] == vehicle_id)
    if not len(sub["Vehicle_ID"]):
        logger.warning(f"Vehicle {vehicle_id} not found; skipping detail plot.")
        return
    plt = pyplot()
    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(9, 6), sharex=True)
    x = sub["Frame_Number"] if "Frame_Number" in sub else np.arange(len(sub["Vehicle_ID"]))
    ax1.plot(x, sub["Vehicle_Speed"], color="#3274d9")
    ax1.set_ylabel("Speed [km/h]")
    ax2.plot(x, sub["Vehicle_Acceleration"], color="#ff9d00")
    ax2.set_ylabel("Acceleration [m/s$^2$]")
    ax2.set_xlabel("Frame")
    ax1.set_title(f"Vehicle {vehicle_id} kinematics")
    _save(fig, plots_dir, stem, f"Vehicle_{vehicle_id}_kinematics",
          cfg["save"], cfg["show"], logger)


def _missing(x) -> bool:
    return x is None or (isinstance(x, float) and math.isnan(x))


def plot_dataset(datasets, stem, plots_dir, plotting_cfg, class_names, args, logger):
    """All figures for one dataset (or one aggregated location)."""
    plt = pyplot()
    merged = concat([df for _, df in datasets])
    cfg = {
        "save": args.save if args.save is not None else plotting_cfg.get("save", True),
        "show": args.show if args.show is not None else plotting_cfg.get("show", False),
        "colors": plotting_cfg.get("colors"),
    }
    points = bool(args.points) if args.points is not None else plotting_cfg.get("plot_points", False)
    cutoff = plotting_cfg.get("stationary_speed_cutoff", 1)
    plt.rcParams.update({"font.size": plotting_cfg.get("savefig_font_size", 14)})

    coordinate_maps = [
        ("Unstab_X", "Unstab_Y", "Unstabilized_image_coordinates", "x [px]", "y [px]", True),
        ("Stab_X", "Stab_Y", "Stabilized_image_coordinates", "x [px]", "y [px]", True),
        ("Ortho_X", "Ortho_Y", "Orthophoto_image_coordinates", "x [px]", "y [px]", True),
        ("Local_X", "Local_Y", "Local_planar_coordinates", "East [m]", "North [m]", False),
        ("Longitude", "Latitude", "Geographic_coordinates", "Longitude [deg]", "Latitude [deg]", False),
    ]
    for x_col, y_col, title, xl, yl, invert in coordinate_maps:
        if x_col in merged:
            plot_trajectories_xy(datasets, x_col, y_col, title, xl, yl,
                                 plots_dir, stem, cfg, logger,
                                 invert_y=invert, points=points)

    # ortho-background variants
    if "Ortho_X" in merged and args.ortho_folder:
        from geotrax_tpu_torch.io.geoassets import load_image

        location = determine_location_id(Path(stem + ".x"), logger)
        ortho_png = Path(args.ortho_folder) / f"{location}.png"
        if ortho_png.exists():
            plot_trajectories_xy(
                datasets, "Ortho_X", "Ortho_Y",
                "Orthophoto_image_coordinates_on_orthophoto", "x [px]", "y [px]",
                plots_dir, stem, cfg, logger, background=load_image(ortho_png),
                points=points,
            )
        use_seg = (args.segmentations if args.segmentations is not None
                   else plotting_cfg.get("use_segmentations"))
        if use_seg and args.segmentation_folder:
            seg_png = Path(args.segmentation_folder) / f"{location}.png"
            if seg_png.exists():
                plot_trajectories_xy(
                    datasets, "Ortho_X", "Ortho_Y",
                    "Orthophoto_image_coordinates_on_segmentation_overlay",
                    "x [px]", "y [px]", plots_dir, stem, cfg, logger,
                    background=load_image(seg_png), points=points,
                )

    plot_kinematic_distribution(merged, "Vehicle_Speed", "km/h", "Speed_distribution",
                                plots_dir, stem, cfg, logger, cutoff)
    plot_kinematic_distribution(merged, "Vehicle_Acceleration", "m/s$^2$",
                                "Acceleration_distribution", plots_dir, stem, cfg, logger)
    plot_kinematics_jointly(merged, plots_dir, stem, cfg, logger, cutoff)
    plot_class_distribution(merged, class_names, plots_dir, stem, cfg, logger)
    for col, title in (("Vehicle_Length", "Vehicle_length_distribution"),
                       ("Vehicle_Width", "Vehicle_width_distribution"),
                       ("Pixel_Length", "Vehicle_length_distribution"),
                       ("Pixel_Width", "Vehicle_width_distribution")):
        plot_dimension_distribution(
            merged, col, title, "m" if col.startswith("Vehicle") else "px",
            plots_dir, stem, cfg, logger,
        )
    plot_vehicle_detail(merged, int(getattr(args, "id", 0) or 0), plots_dir, stem, cfg, logger)
    report_high_value_instances(merged, logger)


# ---------------------------------------------------------------------------
# The stage
# ---------------------------------------------------------------------------

def prepare(args, logger) -> tuple:
    """Config backfill, class names and the files to plot:
    (plotting config, class names, files)."""
    full = load_config(args.cfg, logger)
    plotting_cfg = full.get("plotting", {})
    out_cfg_raw = full.get("output", {})
    backfill_args_from_config(args, {
        "save": plotting_cfg.get("save", True),
        "show": plotting_cfg.get("show", False),
        "aggregate": plotting_cfg.get("aggregate", False),
        "points": plotting_cfg.get("plot_points", False),
        "segmentations": plotting_cfg.get("use_segmentations", False),
        "class_filter": plotting_cfg.get("class_filter", []),
        "ortho_folder": full.get("input", {}).get("ortho_folder"),
        "segmentation_folder": full.get("input", {}).get("segmentation_folder"),
        "output_folder": out_cfg_raw.get("folder", "results"),
    })
    out_cfg = {**out_cfg_raw, "folder": args.output_folder}
    class_names, _ = resolve_class_names(
        Path("none"), getattr(args, "class_names", None),
        full.get("extraction", {}).get("class_rename"),
        full.get("ultralytics", {}).get("classes"), logger,
    )
    files = determine_files_to_process(Path(args.input), plotting_cfg, out_cfg, logger)
    return plotting_cfg, class_names, files


def run_plotting(args, logger) -> None:
    plotting_cfg, class_names, files = prepare(args, logger)
    try:
        for stem, plots_dir, datasets in plot_jobs(args, files, logger):
            plot_dataset(datasets, stem, plots_dir, plotting_cfg, class_names, args, logger)
    except KeyboardInterrupt:
        logger.error("Plotting interrupted by user.")


def generate_plots(args: argparse.Namespace, logger) -> None:
    """Run the plotting stage (library entry point)."""
    run_plotting(args, logger)


def parse_cli_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(prog="python -m geotrax_tpu_torch plot",
                                     description="Trajectory and distribution plotting "
                                                 "(PyTorch/CUDA port)")
    parser.add_argument("input", type=Path,
                        help="A video file, a .txt/.csv results file, or a folder containing any of these.")
    optional = parser.add_argument_group("Optional arguments")
    add_common_args(optional)
    optional.add_argument("--model", "-m", nargs="+", default=None, metavar="MODEL",
                          help="Model used only to resolve vehicle class names.")
    optional.add_argument("--class-names", "-cn", nargs="+", default=None, metavar="ID=NAME|FILE",
                          help="Class-id -> name mapping.")
    background = parser.add_argument_group("Plot background arguments")
    background.add_argument("--ortho-folder", "-orf", type=Path, default=None,
                            help="Folder with orthophoto images used as plot backgrounds.")
    background.add_argument("--segmentation-folder", "-osf", type=Path, default=None,
                            help="Folder with lane segmentation CSVs and overlay PNGs.")
    plotting = parser.add_argument_group("Plotting arguments")
    add_plotting_args(plotting)
    plotting.add_argument("--id", "-i", type=int, default=0,
                          help="Vehicle ID to print/plot in detail (non-folder input only).")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_cli_args(argv)
    logger = setup_logger("geotrax.plot", args.verbose, args.log_path)
    generate_plots(args, logger)
    return 0


if __name__ == "__main__":
    sys.exit(main())
