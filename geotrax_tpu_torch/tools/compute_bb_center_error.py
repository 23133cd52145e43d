"""Bounding-box centre accuracy, human against predicted YOLO labels: the
port of ``tools/compute_bb_center_error.py``.

For every image of ``source``: the human labels (``--human-annotations``,
default ``../labels``) and the predicted ones (``--predicted-annotations``,
default ``../pre-labels``); a prediction matches a ground-truth box when its
centre lies inside it, and each ground-truth box's error is the smallest
centre distance in pixels (NaN without a match). Reported: mean, median,
std, valid and NaN counts, class-agnostic (``--class-agnostic``) or per
class with an overall row. Image sizes come from the file headers
(``io/image_size.py``, turned by a JPEG's EXIF orientation as
``cv2.imread`` turns it). ``--save`` writes the error-distribution figures
(PDF and PNG, matplotlib when installed) next to the source folder.

Usage:
  python -m geotrax_tpu_torch.tools.compute_bb_center_error /path/to/images [options]
"""

from __future__ import annotations

import argparse
from collections import defaultdict
from pathlib import Path

import numpy as np

from geotrax_tpu_torch.io.image_size import image_size
from geotrax_tpu_torch.tools._common import pyplot
from geotrax_tpu_torch.utils.logging_utils import setup_logger

IMG_EXTS = (".jpg", ".jpeg", ".png")


def load_annotations(image_id: str, folder: Path):
    """YOLO-format rows (class, cx, cy, w, h) normalized to [0,1]; None when
    the .txt is missing (reference load_annotations semantics)."""
    path = folder / f"{image_id}.txt"
    if not path.exists():
        return None
    rows = []
    for line in path.read_text().splitlines():
        parts = line.split()
        if len(parts) >= 5:
            rows.append([float(parts[0])] + [float(v) for v in parts[1:5]])
    return np.asarray(rows, dtype=np.float64).reshape(-1, 5)


def center_errors(gt: np.ndarray, pred: np.ndarray, w: int, h: int):
    """Per-GT-box minimum center distance in pixels over predictions whose
    center lies INSIDE the GT box (reference compute_error matching); NaN
    where no prediction is contained. Returns (G,) errors + (G,) class ids."""
    scale = np.asarray([w, h], dtype=np.float64)
    g_cls = gt[:, 0].astype(int)
    g_c = gt[:, 1:3] * scale                      # (G,2) centers px
    g_half = gt[:, 3:5] * scale / 2.0             # (G,2) half extents px
    if pred is None or not len(pred):
        return np.full(len(gt), np.nan), g_cls
    p_c = pred[:, 1:3] * scale                    # (P,2)
    inside = np.all(
        np.abs(p_c[None, :, :] - g_c[:, None, :]) < g_half[:, None, :], axis=-1
    )                                             # (G,P) strict containment
    dist = np.linalg.norm(p_c[None, :, :] - g_c[:, None, :], axis=-1)
    dist = np.where(inside, dist, np.inf)
    best = dist.min(axis=1)
    return np.where(np.isfinite(best), best, np.nan), g_cls


def _stats(errors: np.ndarray):
    nan_count = int(np.sum(np.isnan(errors)))
    if len(errors) == nan_count:
        return np.nan, np.nan, np.nan, 0, nan_count
    return (
        float(np.nanmean(errors)),
        float(np.nanmedian(errors)),
        float(np.nanstd(errors)),
        len(errors) - nan_count,
        nan_count,
    )


def report_agnostic(errors: np.ndarray, logger) -> None:
    mean, median, std, valid, nans = _stats(errors)
    logger.notice(
        "Class-agnostic error statistics:\n"
        f"Mean error: {mean:.2f}\n"
        f"Median error: {median:.2f}\n"
        f"Standard deviation: {std:.2f}\n"
        f"Number of valid errors: {valid}\n"
        f"Number of NaN errors: {nans}"
    )


def report_by_class(errors_by_class: dict, logger) -> None:
    sep = "-" * 80
    lines = [
        "Class-specific error statistics:",
        sep,
        f"{'Class ID':^10} | {'Mean':^10} | {'Median':^10} | {'Std Dev':^10} "
        f"| {'Valid Errors':^15} | {'NaN Errors':^10}",
        sep,
    ]
    for class_id in sorted(errors_by_class):
        mean, median, std, valid, nans = _stats(errors_by_class[class_id])
        lines.append(
            f"{class_id:^10} | {mean:^10.2f} | {median:^10.2f} | {std:^10.2f} "
            f"| {valid:^15} | {nans:^10}"
        )
    lines.append(sep)
    all_errors = np.concatenate(list(errors_by_class.values()))
    mean, median, std, valid, nans = _stats(all_errors)
    lines.append(
        f"{'All':^10} | {mean:^10.2f} | {median:^10.2f} | {std:^10.2f} "
        f"| {valid:^15} | {nans:^10}"
    )
    lines.append(sep)
    logger.notice("\n".join(lines))


def _plot_one(ax, errors: np.ndarray, title: str) -> None:
    """One distribution panel: scatter + mean/median lines + 1-sigma band +
    90th percentile (reference plot_single_distribution layout)."""
    clean = errors[~np.isnan(errors)]
    if not len(clean):
        ax.set_title(f"{title} (no matches)")
        return
    mean, median, std = clean.mean(), float(np.median(clean)), clean.std()
    p90 = float(np.percentile(clean, 90))
    ax.plot(np.arange(len(clean)), clean, "o", markersize=0.8, alpha=0.2,
            color="#3274A1", rasterized=True)
    ax.axhline(mean, color="#C44E52", linewidth=2,
               label=f"Mean error: {mean:.2f} px")
    ax.axhline(median, color="#55A868", linestyle="--", linewidth=2,
               label=f"Median error: {median:.2f} px")
    ax.axhspan(mean - std, mean + std, color="#C44E52", alpha=0.15,
               label=f"Standard deviation: {std:.2f} px")
    ax.axhline(p90, color="#8172B3", linestyle=":", linewidth=1.5,
               label=f"90th percentile: {p90:.2f} px")
    ax.set_ylim(0, max(p90 * 1.5, mean + 2 * std, 1e-6))
    ax.grid(True, linestyle="--", alpha=0.7)
    ax.set_xlabel("Bounding box index")
    ax.set_ylabel("Error (pixels)")
    ax.set_title(f"{title} (n={len(errors):,})")
    ax.legend(loc="upper right", framealpha=0.9, fontsize=9)


def save_plots(errors_by_class: dict | None, errors: np.ndarray | None,
               source: Path, logger) -> None:
    plt = pyplot("Error distribution figure", say=logger.info)
    if plt is None:
        return
    if errors_by_class is None:
        fig, ax = plt.subplots(figsize=(10, 6), dpi=150)
        _plot_one(ax, errors, "Bounding Box Center Error Distribution")
        stem = "error_distribution"
    else:
        n = len(errors_by_class)
        fig, axs = plt.subplots(n + 1, 1, figsize=(10, 4 * (n + 1)), dpi=150)
        axs = np.atleast_1d(axs)
        _plot_one(axs[0], np.concatenate(list(errors_by_class.values())),
                  "All Classes Combined")
        for i, class_id in enumerate(sorted(errors_by_class)):
            _plot_one(axs[i + 1], errors_by_class[class_id],
                      f"Class ID: {class_id}")
        stem = "error_distribution_by_class"
    fig.tight_layout()
    for ext in ("pdf", "png"):
        fig.savefig(source.parent / f"{stem}.{ext}", bbox_inches="tight")
    plt.close(fig)
    logger.info(f"Saved {stem}.pdf/.png to {source.parent}")


def compute_bb_center_error(args: argparse.Namespace, logger) -> int:
    human_dir = (args.source / args.human_annotations).resolve()
    pred_dir = (args.source / args.predicted_annotations).resolve()
    if not human_dir.is_dir():
        logger.error(f"{human_dir} is not a valid directory.")
        return 1
    if not pred_dir.is_dir():
        logger.error(f"{pred_dir} is not a valid directory.")
        return 1

    images = sorted(
        p for p in args.source.iterdir() if p.suffix.lower() in IMG_EXTS
    )
    if not images:
        logger.error(f"No images found under {args.source}.")
        return 1

    errors_by_class: dict[int, list] = defaultdict(list)
    for image in images:
        gt = load_annotations(image.stem, human_dir)
        pred = load_annotations(image.stem, pred_dir)
        if gt is None:
            logger.warning(f"{human_dir / (image.stem + '.txt')} does not exist.")
            continue
        if pred is None:
            logger.warning(f"{pred_dir / (image.stem + '.txt')} does not exist.")
        if not len(gt):
            continue
        w, h = image_size(image, exif_orientation=True)
        errs, classes = center_errors(gt, pred, w, h)
        for e, c in zip(errs, classes):
            errors_by_class[int(c)].append(e)

    if not errors_by_class:
        logger.error("No ground-truth annotations found.")
        return 1
    errors_by_class = {k: np.asarray(v) for k, v in errors_by_class.items()}
    all_errors = np.concatenate(list(errors_by_class.values()))

    if args.class_agnostic:
        report_agnostic(all_errors, logger)
        if args.save:
            save_plots(None, all_errors, args.source, logger)
    else:
        report_by_class(errors_by_class, logger)
        if args.save:
            save_plots(errors_by_class, None, args.source, logger)
    return 0


def parse_cli_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Compute bounding box center error statistics."
    )
    parser.add_argument("source", type=Path,
                        help="Path to the images to be analyzed")
    parser.add_argument("--human-annotations", "-ha", type=Path,
                        default=Path("../labels"),
                        help="Relative path to the human annotations")
    parser.add_argument("--predicted-annotations", "-pa", type=Path,
                        default=Path("../pre-labels"),
                        help="Relative path to the predicted annotations")
    parser.add_argument("--save", "-s", action="store_true",
                        help="Save the error distribution as a figure")
    parser.add_argument("--class-agnostic", "-ca", action="store_true",
                        help="Class-agnostic statistics instead of per-class")
    parser.add_argument("--log-path", "-lp", type=Path, default=None)
    parser.add_argument("--quiet", "-q", action="store_true")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_cli_args(argv)
    logger = setup_logger("compute_bb_center_error", verbose=not args.quiet,
                          log_path=args.log_path)
    return compute_bb_center_error(args, logger)


if __name__ == "__main__":
    raise SystemExit(main())
