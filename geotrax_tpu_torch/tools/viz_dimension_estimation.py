"""Step-by-step view of the azimuth dimension estimator for one vehicle:
the port of ``tools/viz_dimension_estimation.py``.

Given a VIDEO processed by ``extract`` (its tracks found through the
config's output folder and postfix, its frame size from the video) or a
results ``.txt`` (``--frame-size`` then gives the frame), the estimator of
``pipeline/postprocess.py`` is replayed for one vehicle id: the visibility
filter, the azimuth mask (``_azimuth_mask``) against ``CARDINALS`` and the
Q25 estimate, which is logged. Figures (matplotlib, when installed; one
log line says when they were skipped):

- ``trajectory_with_dimensions``: the trajectory with its boxes by filter
  stage (red = rejected, green = accepted)
- ``dimensions_distribution``: the accepted candidate boxes and the Q25
  estimate (blue dashed)
- ``estimation_diagnostics``: the filter funnel and the step azimuths
  against the cardinal directions

``--id 0`` (default) lists the ids and prompts; ``--save`` writes PDFs to
``<output>/plots/``; ``--show`` displays the figures.

Usage:
  python -m geotrax_tpu_torch.tools.viz_dimension_estimation VIDEO.mp4 --id 42 --save [-c default]
"""

from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path

import numpy as np

from geotrax_tpu_torch.pipeline.postprocess import CARDINALS, _azimuth_mask
from geotrax_tpu_torch.tools._common import pyplot
from geotrax_tpu_torch.utils.config_utils import load_config
from geotrax_tpu_torch.utils.file_utils import (
    DEFAULT_OUTPUT,
    detect_delimiter,
    get_output_dir,
    get_video_dimensions,
)
from geotrax_tpu_torch.utils.logging_utils import setup_logger


def load_tracks(args, logger) -> tuple[np.ndarray, tuple[int, int]]:
    """(tracks array, (frame_w, frame_h)) for a video source (results
    resolved through the config) or a direct results .txt."""
    if args.source.suffix.lower() == ".txt":
        tracks_file = args.source
        frame_w, frame_h = args.frame_size
    else:
        output_cfg = load_config(args.cfg, logging.getLogger("viz_dim")).get(
            "output", DEFAULT_OUTPUT
        )
        postfix = output_cfg.get("tracks_postfix",
                                 DEFAULT_OUTPUT["tracks_postfix"])
        tracks_file = (get_output_dir(args.source, output_cfg)
                       / f"{args.source.stem}{postfix}.txt")
        if not tracks_file.exists():
            logger.critical(
                f"Tracking results not found: '{tracks_file}'. Run "
                "'geotrax extract' on the video first."
            )
            sys.exit(1)
        frame_w, frame_h = get_video_dimensions(args.source)
    data = np.loadtxt(tracks_file, delimiter=detect_delimiter(tracks_file))
    if data.ndim == 1:
        data = data.reshape(1, -1)
    return data, (frame_w, frame_h)


def resolve_vehicle_id(tracks: np.ndarray, args, logger) -> int:
    unique_ids = np.unique(tracks[:, 1]).astype(int)
    vehicle_id = args.id
    if vehicle_id == 0:
        while vehicle_id not in unique_ids:
            try:
                vehicle_id = int(
                    input(f"Enter a vehicle ID to visualize {unique_ids.tolist()}: ")
                )
            except ValueError:
                continue
            except EOFError:  # non-interactive stdin: list IDs and exit clean
                logger.critical(
                    f"No --id given and stdin is not interactive. "
                    f"Available IDs: {unique_ids.tolist()}"
                )
                sys.exit(1)
            if vehicle_id not in unique_ids:
                logger.warning(
                    f"ID {vehicle_id} not found. Available: {unique_ids.tolist()}"
                )
    elif vehicle_id not in unique_ids:
        logger.critical(
            f"ID {vehicle_id} not found in the tracks. "
            f"Available IDs: {unique_ids.tolist()}"
        )
        sys.exit(1)
    return vehicle_id


def _plot_box_outlines(ax, rows, idx_x, idx_y, color, lw=0.5, alpha=0.1):
    for track in rows:
        x_c, y_c, w, h = track[idx_x], track[idx_y], track[4], track[5]
        ax.plot(
            [x_c - w / 2, x_c + w / 2, x_c + w / 2, x_c - w / 2, x_c - w / 2],
            [y_c - h / 2, y_c - h / 2, y_c + h / 2, y_c + h / 2, y_c - h / 2],
            linewidth=lw, alpha=alpha, color=color,
        )


def visualize(args, logger) -> int:
    cfg = load_config(args.cfg, logging.getLogger("viz_dim"))
    dim = cfg["extraction"]["dimension_estimation"]

    data, (w_frame, h_frame) = load_tracks(args, logger)
    vehicle_id = resolve_vehicle_id(data, args, logger)
    rows = data[data[:, 1] == vehicle_id]
    rows = rows[np.argsort(rows[:, 0])]
    # stabilized coordinate columns when present, raw as fallback
    idx_x, idx_y = (6, 7) if rows.shape[1] >= 12 else (2, 3)
    eps = float(dim["eps"])

    vis = (
        (rows[:, 2] - rows[:, 4] / 2 > eps) & (rows[:, 3] - rows[:, 5] / 2 > eps)
        & (rows[:, 2] + rows[:, 4] / 2 < w_frame - 1 - eps)
        & (rows[:, 3] + rows[:, 5] / 2 < h_frame - 1 - eps)
    )
    valid = rows[vis]
    if not len(valid):
        logger.critical(f"All boxes of id {vehicle_id} fail the visibility filter.")
        return 1
    lengths = np.maximum(valid[:, 4], valid[:, 5])
    widths = np.minimum(valid[:, 4], valid[:, 5])
    radius = float(dim["r0"]) / float(dim["gsd"])
    mask, saw = _azimuth_mask(valid[:, idx_x], valid[:, idx_y], radius,
                              np.deg2rad(float(dim["theta_bar"])))
    l_est = np.percentile(lengths[mask], 25) if mask.any() else float("nan")
    w_est = np.percentile(widths[mask], 25) if mask.any() else float("nan")

    plt = pyplot("Figures", show=args.show, say=logger.info)
    if plt is not None:
        _figures(plt, args, logger, rows, vis, valid, mask, lengths, widths, l_est, w_est,
                 vehicle_id, (idx_x, idx_y))
    if mask.any():
        logger.notice(
            f"Track {vehicle_id}: Q25 estimate length {l_est:.1f} px, "
            f"width {w_est:.1f} px over {int(mask.sum())} accepted boxes."
        )
    else:
        logger.warning(
            "No accepted samples"
            + (" (stationary fallback applies)." if saw
               else " (azimuth never computed).")
        )
    return 0


def _figures(plt, args, logger, rows, vis, valid, mask, lengths, widths, l_est, w_est,
             vehicle_id, idx) -> None:
    """The trajectory with its boxes by filter stage, the accepted
    dimension candidates with the Q25 estimate, and the filter funnel with
    the step azimuths; saved as PDFs and/or shown."""
    idx_x, idx_y = idx
    figures = {}

    # ---- figure 1: trajectory + stage-coloured boxes
    fig1, ax = plt.subplots(figsize=(10, 7))
    ax.plot(rows[:, idx_x], rows[:, idx_y], "k-", alpha=0.9, lw=1,
            label="trajectory")
    _plot_box_outlines(ax, rows[~vis], idx_x, idx_y, "r", alpha=0.3)
    _plot_box_outlines(ax, valid[~mask], idx_x, idx_y, "r")
    _plot_box_outlines(ax, valid[mask], idx_x, idx_y, "g", alpha=0.25)
    ax.invert_yaxis()
    ax.set_title(
        f"Track {vehicle_id}: trajectory + candidate boxes "
        f"(red = rejected, green = accepted)"
    )
    figures["trajectory_with_dimensions"] = fig1

    # ---- figure 2: accepted dimension candidates + Q25 estimate
    fig2, ax = plt.subplots(figsize=(8, 6))
    for length, width in zip(lengths[mask], widths[mask]):
        ax.plot(
            [-length / 2, length / 2, length / 2, -length / 2, -length / 2],
            [-width / 2, -width / 2, width / 2, width / 2, -width / 2],
            linewidth=0.5, alpha=0.1, color="g",
        )
    if np.isfinite(l_est):
        ax.plot(
            [-l_est / 2, l_est / 2, l_est / 2, -l_est / 2, -l_est / 2],
            [-w_est / 2, -w_est / 2, w_est / 2, w_est / 2, -w_est / 2],
            linewidth=1.5, alpha=0.9, color="b", linestyle="dashed",
            label=f"Q25 estimate {l_est:.1f} x {w_est:.1f} px",
        )
        ax.legend()
    ax.set_aspect("equal")
    ax.set_title(f"Track {vehicle_id}: dimension candidates ({int(mask.sum())} accepted)")
    figures["dimensions_distribution"] = fig2

    # ---- the diagnostic panel
    fig3, axes = plt.subplots(1, 2, figsize=(12, 4.5))
    axes[0].bar(["rows", "visible", "accepted"],
                [len(rows), int(vis.sum()), int(mask.sum())],
                color=["#7f7f7f", "#3274d9", "#2ca02c"])
    axes[0].set_title("filter funnel")
    if len(valid) > 1:
        d = np.diff(np.stack([valid[:, idx_x], valid[:, idx_y]], 1), axis=0)
        az = np.arctan2(-d[:, 1], d[:, 0])
        axes[1].hist(np.rad2deg(az), bins=36, color="#9954bb")
        for c in np.rad2deg(CARDINALS):
            axes[1].axvline(c, color="#2ca02c", ls=":")
    axes[1].set_title("step azimuths vs cardinal directions")
    figures["estimation_diagnostics"] = fig3

    if args.save:
        if args.source.suffix.lower() == ".txt":
            plots_dir = args.source.parent / "plots"
        else:
            plots_dir = get_output_dir(args.source).parent / "plots"
        plots_dir.mkdir(parents=True, exist_ok=True)
        for name, fig in figures.items():
            out = plots_dir / f"{args.source.stem}_{name}_id{vehicle_id}.pdf"
            fig.savefig(out, bbox_inches="tight")
            logger.notice(f"Saved {out}")
    if args.show:
        plt.show()
    for fig in figures.values():
        plt.close(fig)


def parse_cli_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Visualize the azimuth-based vehicle dimension estimation."
    )
    parser.add_argument("source", type=Path,
                        help="Video processed by 'geotrax extract' (or a "
                             "results .txt directly)")
    parser.add_argument("--id", "-i", type=int, default=0,
                        help="Vehicle ID (0 prompts interactively)")
    parser.add_argument("--show", action="store_true",
                        help="Display plots interactively")
    parser.add_argument("--save", "-s", action="store_true",
                        help="Save plots as PDFs to <output>/plots/")
    parser.add_argument("--cfg", "-c", default="default",
                        help="Pipeline config (resolves output folder/postfix)")
    parser.add_argument("--frame-size", type=int, nargs=2, default=[3840, 2160],
                        metavar=("W", "H"),
                        help="Frame dimensions when source is a .txt")
    parser.add_argument("--log-path", "-lp", type=Path, default=None)
    parser.add_argument("--quiet", "-q", action="store_true")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_cli_args(argv)
    logger = setup_logger("viz_dimension_estimation", verbose=not args.quiet,
                          log_path=args.log_path)
    return visualize(args, logger)


if __name__ == "__main__":
    raise SystemExit(main())
