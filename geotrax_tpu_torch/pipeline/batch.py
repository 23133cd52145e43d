"""`batch`: the full pipeline over a video or a directory tree.

The port of ``geotrax_tpu/pipeline/batch.py``: skip-if-exists staged
execution (each stage's output file is its checkpoint), --overwrite/--yes
prompting, --dry-run preview, the stage selectors (--viz-only, --geo-only,
--plot-only, --no-geo), folder and pattern exclusion, per-file exception
isolation, ``cut_frame_right`` forced to None in directory mode, and with
``--parallel-videos N`` a pre-pass that groups the videos still to extract
by resolution and runs each full group of N through the lockstep extractor
(``parallel/extract_batch.py``; leftovers go through the per-file path, and
an error in a group falls back to it, as in the reference), then the
visualize stage per video and the plot stage (per video for a file, once
over the tree for a directory) where their gates open, as by default.
"""

from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path

from geotrax_tpu_torch.pipeline.extract import add_processing_args, detect_track_stabilize
from geotrax_tpu_torch.pipeline.georeference import add_georeferencing_args, georeference
from geotrax_tpu_torch.pipeline.plot import add_plotting_args, default_plot_args, generate_plots
from geotrax_tpu_torch.pipeline.visualize import (add_visualization_args, resolve_viz_modes,
                                                  visualize_results)
from geotrax_tpu_torch.utils.cli_utils import add_common_args
from geotrax_tpu_torch.utils.config_utils import backfill_args_from_config, load_config
from geotrax_tpu_torch.utils.constants import VIDEO_FORMATS
from geotrax_tpu_torch.utils.file_utils import (DEFAULT_OUTPUT, check_if_results_exist,
                                                determine_suffix_and_fourcc)
from geotrax_tpu_torch.utils.logging_utils import AnsiColors, setup_logger

ACTION_EXTRACT = "Detecting, tracking, and stabilizing"
ACTION_GEOREF = "Georeferencing"
ACTION_VISUALIZE = "Visualizing"


def process_input(args: argparse.Namespace, logger: logging.Logger) -> None:
    """Run the staged pipeline for a single video or every video in a tree."""
    input_path = args.input
    if not input_path.exists():
        logger.critical(f"File or directory '{input_path}' not found.")
        return

    full_cfg = load_config(args.cfg, logger)
    batch_cfg = full_cfg["batch"]
    out_cfg_raw = full_cfg.get("output", DEFAULT_OUTPUT)
    backfill_args_from_config(args, {
        "folders_exclude": batch_cfg["folders_exclude"],
        "exclude_patterns": batch_cfg["exclude_patterns"],
        "output_folder": out_cfg_raw.get("folder", DEFAULT_OUTPUT["folder"]),
    })
    out_cfg = {**out_cfg_raw, "folder": args.output_folder}

    try:
        if input_path.is_file() and input_path.suffix.lower() in VIDEO_FORMATS:
            process_file(input_path, args, logger, out_cfg)
        elif input_path.is_dir():
            logger.notice(f"Batch processing all videos in: '{input_path}'")
            # Directory mode processes whole videos; a single cut would apply to all.
            args.cut_frame_right = None
            candidates = [
                f for f in input_path.rglob("*")
                if f.is_file() and f.suffix.lower() in VIDEO_FORMATS
            ]
            files = sorted(filter_files_to_process(candidates, args, logger))
            extracted: set = set()
            if getattr(args, "parallel_videos", 1) > 1 and not args.dry_run:
                extracted = run_parallel_extraction(files, args, logger, out_cfg)
            for i, file in enumerate(files):
                logger.info(f"Processing ({i + 1}/{len(files)}): '{file}'")
                process_file(file, args, logger, out_cfg, extracted=extracted)
    except KeyboardInterrupt:
        logger.error("Batch processing interrupted by user.")
        return

    if (
        (args.plot_save is not False or args.plot_show is not False)
        and not args.viz_only and not args.geo_only and input_path.is_dir()
    ):
        run_plotting(input_path, args, logger)


def run_parallel_extraction(files: list, args, logger, out_cfg: dict) -> set:
    """Group the videos still to extract by resolution and run each full
    group of ``--parallel-videos`` through the lockstep extractor. Returns
    the files it extracted, so that the per-file pass does not extract them
    again (with --overwrite it would)."""
    done: set = set()
    if args.viz_only or args.geo_only or args.plot_only:
        return done
    pending = [
        f for f in files
        if should_process_file(f, args, logger, ACTION_EXTRACT, out_cfg)
    ]
    if len(pending) < 2:
        return done
    from geotrax_tpu_torch.io import video
    from geotrax_tpu_torch.parallel.extract_batch import extract_videos_batch
    from geotrax_tpu_torch.utils.config_utils import load_config_all

    groups: dict = {}
    for f in pending:
        info = video.probe_video(f)
        groups.setdefault((info.width, info.height), []).append(f)

    args.source = pending[0]
    config = load_config_all(args, logger, needs_model=True)
    group_size = int(args.parallel_videos)
    for (w, h), members in groups.items():
        for start in range(0, len(members) - group_size + 1, group_size):
            group = members[start:start + group_size]
            logger.notice(
                f"Parallel extraction of {len(group)} videos at {w}x{h}: "
                f"{[m.name for m in group]}"
            )
            try:
                extract_videos_batch(group, args, config, logger)
                done.update(group)
            except Exception as exc:  # noqa: BLE001 — fall back to the per-file path
                logger.error(f"Parallel extraction failed ({exc}); falling back to sequential.")
                return done
    return done


def run_plotting(path: Path, args: argparse.Namespace, logger: logging.Logger) -> None:
    logger.info(f"Generating plots for: '{path}'")
    if args.dry_run:
        return
    plot_args = default_plot_args(
        input=path,
        save=args.plot_save,
        show=args.plot_show,
        cfg=args.cfg,
        output_folder=args.output_folder,
        log_path=args.log_path,
        verbose=args.verbose,
        aggregate=args.plot_aggregate,
        ortho_folder=args.ortho_folder,
        segmentation_folder=args.segmentation_folder,
        segmentations=args.plot_segmentations,
        points=args.plot_points,
        class_filter=args.plot_class_filter,
        model=getattr(args, "model", None),
        class_names=getattr(args, "class_names", None),
    )
    generate_plots(plot_args, logger)


def process_file(file: Path, args, logger, out_cfg: dict | None = None,
                 extracted: set | None = None) -> None:
    """All requested stages for one video; exceptions are isolated per file.
    ``extracted`` = files the parallel pre-pass already extracted this run.
    --geo-only suppresses the visualization stage, as the JAX package does
    (its documented contract: only georeferencing)."""
    try:
        logger.info(f"Processing: '{file}'")
        if (not args.viz_only and not args.geo_only and not args.plot_only
                and file not in (extracted or ())):
            process_step(file, args, logger, ACTION_EXTRACT, detect_track_stabilize, out_cfg)
        if not args.viz_only and not args.no_geo and not args.plot_only:
            process_step(file, args, logger, ACTION_GEOREF, georeference, out_cfg)
        if ((args.save is not False or args.show is not False)
                and not args.plot_only and not args.geo_only):
            process_step(file, args, logger, ACTION_VISUALIZE, visualize_results, out_cfg)
        if (
            (args.plot_save is not False or args.plot_show is not False)
            and not args.viz_only and not args.geo_only and not args.input.is_dir()
        ):
            run_plotting(file, args, logger)
    except Exception as exc:  # noqa: BLE001 — one bad video must not kill the batch
        logger.error(f"Error with {file}: {exc}")


def process_step(file: Path, args, logger, action: str, func, out_cfg=None) -> None:
    if should_process_file(file, args, logger, action, out_cfg):
        logger.info(f"{action}: '{file}'")
        if not args.dry_run:
            args.source = file
            func(args, logger)


def filter_files_to_process(files: list, args, logger) -> list:
    kept = []
    for file in files:
        if file.parent.name in args.folders_exclude:
            logger.info(f"Skipping '{file}' (excluded folder).")
            continue
        if args.exclude_patterns and any(p in file.name for p in args.exclude_patterns):
            logger.info(f"Skipping '{file}' (matches exclusion pattern).")
            continue
        kept.append(file)
    return kept


def should_process_file(file: Path, args, logger, action: str, out_cfg=None) -> bool:
    """Skip-if-exists logic per stage; georef/viz require extraction output."""
    txt_exists = check_if_results_exist(file, "processed", output_cfg=out_cfg)[0]
    extract_label = "detection, tracking, and stabilization"

    if action == ACTION_EXTRACT:
        return handle_existing_results(file, args, logger, txt_exists, extract_label)
    if action == ACTION_GEOREF:
        if not txt_exists:
            logger.error(f"'{file}' - No {extract_label} results found. Skipping georeferencing.")
            return False
        csv_exists = check_if_results_exist(file, "georeferenced", output_cfg=out_cfg)[0]
        return handle_existing_results(file, args, logger, csv_exists, action)
    if action == ACTION_VISUALIZE:
        if not txt_exists:
            logger.error(f"'{file}' - No {extract_label} results found. Skipping visualization.")
            return False
        suffix = determine_suffix_and_fourcc()[0]
        modes = resolve_viz_modes(args, logger)
        vid_exists = all(
            check_if_results_exist(file, "visualized", m, suffix, output_cfg=out_cfg)[0]
            for m in modes
        )
        return handle_existing_results(file, args, logger, vid_exists, action)
    return False


def handle_existing_results(file: Path, args, logger, exists: bool, action: str) -> bool:
    if exists and not args.overwrite:
        logger.warning(f"'{file}' - {action} results already exist and overwrite not allowed.")
        return False
    if exists and args.overwrite and not args.yes:
        prompt = f"{AnsiColors.BOLD}Overwrite {action} results for: '{file}'? [y/n]: {AnsiColors.RESET}"
        return input(prompt).lower() == "y"
    return True


def parse_cli_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        prog="python -m geotrax_tpu_torch batch",
        description="Primary entry point for the full pipeline: extraction, georeferencing, "
        "visualization, and plotting for a video file or a directory tree (PyTorch/CUDA). "
        "Stages are skipped when their output already exists; use --overwrite to force."
    )
    parser.add_argument("input", type=Path,
                        help="A video file or a directory of video files (searched recursively).")

    batch = parser.add_argument_group("Batch processing options")
    batch.add_argument("--yes", "-y", action="store_true", help="Auto-confirm prompts.")
    batch.add_argument("--overwrite", "-o", action="store_true", help="Overwrite existing results.")
    batch.add_argument("--dry-run", "-dr", action="store_true",
                       help="Preview which files and stages would run without executing.")
    batch.add_argument("--viz-only", "-vo", action="store_true",
                       help="Only (re-)run visualization (requires existing .txt results).")
    batch.add_argument("--geo-only", "-go", action="store_true", help="Only run georeferencing.")
    batch.add_argument("--plot-only", "-po", action="store_true", help="Only generate plots.")
    batch.add_argument("--no-geo", "-ng", action="store_true", help="Skip georeferencing.")
    batch.add_argument("--parallel-videos", "-pv", type=int, default=1,
                       help="Extract N same-resolution videos in lockstep on the card "
                            "(batched detection, stabilization and tracking).")
    batch.add_argument("--devices", "-dv", type=int, default=None,
                       help="Split the lockstep group's tracker timelines over the first D "
                            "cards (requires --parallel-videos divisible by D).")
    batch.add_argument("--folders-exclude", "-fe", type=str, nargs="+", default=None,
                       help="Folders to exclude from batch scanning.")
    batch.add_argument("--exclude-patterns", "-ep", type=str, nargs="+", default=None,
                       help="Skip videos whose filename contains any of these substrings.")

    shared = parser.add_argument_group("Shared options")
    add_common_args(shared)
    processing = parser.add_argument_group("Processing options")
    add_processing_args(processing)
    georef = parser.add_argument_group("Georeferencing options")
    add_georeferencing_args(georef)
    viz = parser.add_argument_group("Visualization options")
    add_visualization_args(viz, include_frame_range=False)
    plotting = parser.add_argument_group("Plotting options")
    add_plotting_args(plotting, dest_prefix="plot_")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_cli_args(argv)
    logger = setup_logger("geotrax.batch", args.verbose, args.log_path, args.dry_run)
    try:
        process_input(args, logger)
    except SystemExit as exc:
        return int(exc.code or 0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
