"""Per-class length/width ratio statistics of the tracked boxes (the source
of the dimension estimator's tau_c): the port of
``tools/analyze_bb_ratios.py``.

For a video or run-metadata ``.yaml`` (or a folder, scanned recursively),
the tracks of its results folder are re-estimated by
``pipeline/postprocess.estimate_vehicle_dimensions`` under restrictive
thresholds (tau_c = 100 for every class, theta_bar = 5 degrees: only clean
cardinal passes count), and each class's L/W ratios are reported (N, mean,
std, median, min, max, Q10, Q5, Q1). The frame size comes from the run
metadata (``io/yaml_load.py``), else from probing the video, else 4K.
``--hist`` writes per-class histogram PDFs (matplotlib, when installed).
``--labels`` reads a YOLO label folder instead.

Usage:
  python -m geotrax_tpu_torch.tools.analyze_bb_ratios VIDEO_OR_DIR [--hist]
  python -m geotrax_tpu_torch.tools.analyze_bb_ratios LABELS_DIR --labels
"""

from __future__ import annotations

import argparse
from collections import defaultdict
from pathlib import Path

import numpy as np

from geotrax_tpu_torch.pipeline.postprocess import estimate_vehicle_dimensions
from geotrax_tpu_torch.tools._common import load_yolo_labels, pyplot
from geotrax_tpu_torch.utils.constants import VIDEO_FORMATS
from geotrax_tpu_torch.utils.file_utils import detect_delimiter, get_output_dir

CLASS_NAMES = ["car", "bus", "truck", "motorcycle", "pedestrian", "bicycle"]

# tau_c so high that the stationary fallback never passes, theta_bar so
# tight that only clean cardinal passes contribute
RESTRICTIVE_DIM_CFG = {
    "gsd": 0.02725, "eps": 4, "r0": 1.25, "theta_bar": 5,
    "tau_c": {0: 100, 1: 100, 2: 100, 3: 100, -1: 100},
}


def frame_size_for(source: Path) -> tuple[int, int]:
    """(width, height) from the run metadata next to the video, else by
    probing the video; 4K when neither is available."""
    meta = source.with_suffix(".yaml")
    if meta.exists():
        from geotrax_tpu_torch.io import yaml_load

        try:
            video = (yaml_load.safe_load(meta.read_text()) or {}).get("video", {})
            if video.get("width") and video.get("height"):
                return int(video["width"]), int(video["height"])
        except Exception:
            pass
    if source.suffix.lower() in VIDEO_FORMATS and source.exists():
        from geotrax_tpu_torch.io.video import probe_video

        try:
            info = probe_video(source)
            return info.width, info.height
        except Exception:
            pass
    return 3840, 2160


def ratios_for_file(source: Path, results_folder: str) -> dict[int, list[float]] | None:
    """Per-class L/W ratios of one video's tracks under the restrictive
    thresholds; None when there are no tracks."""
    if source.parent.name == results_folder:
        return None  # a file inside the output folder itself
    tracks_file = get_output_dir(source, {"folder": results_folder}) / f"{source.stem}.txt"
    if not tracks_file.exists():
        return None
    tracks = np.loadtxt(tracks_file, delimiter=detect_delimiter(tracks_file), ndmin=2)
    if tracks.size == 0:
        return None
    # drop existing dimension columns: 12 base columns with stabilization
    # (14/15 with dimensions and interpolation), 8 without (10/11)
    base_cols = 12 if tracks.shape[1] >= 12 else 8
    w, h = frame_size_for(source)
    tracks = estimate_vehicle_dimensions(tracks[:, :base_cols], RESTRICTIVE_DIM_CFG, w, h)
    idx_c = 10 if base_cols == 12 else 6
    out: dict[int, list[float]] = defaultdict(list)
    for tid in np.unique(tracks[:, 1]).astype(int):
        rows = tracks[tracks[:, 1] == tid]
        length, width = rows[0, base_cols], rows[0, base_cols + 1]
        if np.isfinite(length) and np.isfinite(width) and width > 0:
            out[int(rows[0, idx_c])].append(float(length / width))
    return out


def collect(source: Path, results_folder: str) -> dict[int, list[float]]:
    """Ratios over a file or a folder tree."""
    merged: dict[int, list[float]] = defaultdict(list)
    files = [source] if source.is_file() else sorted(source.rglob("*"))
    for f in files:
        if not f.is_file() or f.suffix.lower() not in ({".yaml"} | VIDEO_FORMATS):
            continue
        found = ratios_for_file(f, results_folder)
        if found:
            print(f"  {f}: " + ", ".join(
                f"{CLASS_NAMES[c] if c < len(CLASS_NAMES) else c}: {len(v)}"
                for c, v in sorted(found.items())))
            for cls, vals in found.items():
                merged[cls].extend(vals)
    return merged


def _histogram(plt, r: np.ndarray, stats: dict, name: str, hist_dir: Path) -> None:
    fig, ax = plt.subplots()
    ax.hist(r, bins=50, color="c", edgecolor="k", alpha=0.7)
    ax.axvline(stats["Mean"], color="k", ls="--", label="Mean")
    for mult, color in ((1, "r"), (2, "gray"), (3, "orange")):
        ax.axvline(stats["Mean"] - mult * stats["Std"], color=color, ls="-.",
                   label=f"Mean +/- {mult}*Std")
        ax.axvline(stats["Mean"] + mult * stats["Std"], color=color, ls="-.")
    for q, color in (("Q10", "g"), ("Q5", "m"), ("Q1", "b")):
        ax.axvline(stats[q], color=color, label=q)
    ax.set_xlabel("L/W ratio")
    ax.set_ylabel("Frequency")
    ax.set_title(name)
    ax.legend(fontsize=7)
    hist_dir.mkdir(parents=True, exist_ok=True)
    out = hist_dir / f"bb_ratio_hist_{name}.pdf"
    fig.savefig(out)
    plt.close(fig)
    print(f"  histogram -> {out}")


def report(class2ratios: dict[int, list[float]], hist_dir: Path | None) -> None:
    for cls in sorted(class2ratios):
        r = np.asarray(class2ratios[cls], dtype=float)
        if r.size == 0:
            continue
        name = CLASS_NAMES[cls] if cls < len(CLASS_NAMES) else str(cls)
        stats = {
            "N": r.size, "Mean": r.mean(), "Std": r.std(),
            "Median": np.median(r), "Min": r.min(), "Max": r.max(),
            "Q10": np.percentile(r, 10), "Q5": np.percentile(r, 5),
            "Q1": np.percentile(r, 1),
        }
        print(f"Class: {name}")
        for k, v in stats.items():
            print(f"  {k}: {v:.2f}" if k != "N" else f"  N: {v}")
        if hist_dir is not None:
            plt = pyplot("  histogram")
            if plt is not None:
                _histogram(plt, r, stats, name, hist_dir)


def labels_mode(labels: Path, class_names: list[str]) -> int:
    ratios = defaultdict(list)
    for txt in sorted(Path(labels).rglob("*.txt")):
        for cls, _cx, _cy, w, h in load_yolo_labels(txt):
            if w > 0 and h > 0:
                ratios[int(cls)].append(max(w, h) / min(w, h))
    if not ratios:
        print("No labels found.")
        return 1
    print(f"{'class':<12}{'n':>8}{'mean':>8}{'p10':>8}{'p25':>8}{'median':>8}{'p75':>8}")
    for cls in sorted(ratios):
        r = np.asarray(ratios[cls])
        name = class_names[cls] if cls < len(class_names) else str(cls)
        print(f"{name:<12}{len(r):>8}{r.mean():>8.2f}{np.percentile(r, 10):>8.2f}"
              f"{np.percentile(r, 25):>8.2f}{np.median(r):>8.2f}{np.percentile(r, 75):>8.2f}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("source", type=Path,
                        help="Video/.yaml file or directory of tracking runs "
                             "(or a YOLO label folder with --labels)")
    parser.add_argument("--labels", action="store_true",
                        help="Treat source as a YOLO label folder")
    parser.add_argument("--hist", "-hs", action="store_true",
                        help="Write per-class ratio histogram PDFs next to the source")
    parser.add_argument("--results-folder", default="results",
                        help="Results folder name holding the tracks .txt")
    parser.add_argument("--classes", nargs="+", default=CLASS_NAMES)
    args = parser.parse_args(argv)

    if not args.source.exists():
        print(f"'{args.source}' not found.")
        return 1
    if args.labels:
        return labels_mode(args.source, args.classes)

    merged = collect(args.source, args.results_folder)
    if not merged:
        print("No tracking results found (expected <source dir>/"
              f"{args.results_folder}/<stem>.txt next to each video).")
        return 1
    base = args.source if args.source.is_dir() else args.source.parent
    report(merged, (base / "plots") if args.hist else None)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
