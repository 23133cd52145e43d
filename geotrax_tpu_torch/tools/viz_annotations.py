"""Draw YOLO labels onto their images for inspection: the port of
``tools/viz_annotations.py``.

Single-image or folder mode; the folder's images ranked by label count
(respecting ``--type``, ``find_max_annotations``); class names from a
YAML/JSON file, ``key:value`` pairs or positional names; boxes as cv2's
``LINE_AA`` rectangles and labels in cv2's font at ``fontScale = max(0.35,
0.18 * lw)``, ``thickness = lw // 2`` on a filled box, through
``ops/draw.py`` (glyph tables derived from cv2 by
``tools/make_torch_raster_tables.py``); saved with ``tools/_common.save_frame``
(PNG lossless; JPEG through ``io/video.write_jpeg`` at cv2.imwrite's default
quality 95, which needs cv2); existing files are skipped unless
``--overwrite``.

The reference shows images in a cv2 window (``--show``, the default without
``--save``). The port has no display window: ``--show`` exits 1 and says so.

Usage:
  python -m geotrax_tpu_torch.tools.viz_annotations IMAGE_OR_DIR --save [options]
  python -m geotrax_tpu_torch.tools.viz_annotations images/ --save -n 20 -cn 0:car 1:bus
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from geotrax_tpu_torch.ops import draw
from geotrax_tpu_torch.tools._common import load_yolo_labels, save_frame
from geotrax_tpu_torch.tools.find_max_annotations import find_max_annotations
from geotrax_tpu_torch.utils.data_utils import VizColors
from geotrax_tpu_torch.utils.logging_utils import setup_logger

IMAGE_FORMATS = (".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff")
NO_DISPLAY = ("--show needs a display window (cv2.imshow), which this port does not "
              "open; pass --save (and --no-show) to write the images instead")


def resolve_class_names(raw: list | None) -> dict | None:
    """--class-names: a YAML/JSON file path, key:value pairs (0:car 1:bus),
    or positional names for ids 0..N-1."""
    if raw is None:
        return None
    if len(raw) == 1 and Path(raw[0]).suffix.lower() in (".yaml", ".yml", ".json"):
        from geotrax_tpu_torch.io import yaml_load

        path = Path(raw[0])
        with open(path) as f:
            data = json.load(f) if path.suffix.lower() == ".json" else yaml_load.safe_load(f)
        if isinstance(data, list):
            return {i: str(n) for i, n in enumerate(data)}
        return {int(k): str(v) for k, v in data.items()}
    if all(":" in item for item in raw):
        return {int(k): v for item in raw for k, v in [item.split(":", 1)]}
    return {i: n for i, n in enumerate(raw)}


def draw_annotation(img, cls: int, x0: int, y0: int, x1: int, y1: int,
                    line_width: int, class_names: dict | None, show_labels: bool) -> None:
    """One box (and its label) on an RGB image, in place."""
    color = VizColors.rgb(cls)
    draw.rectangle(img, (x0, y0), (x1, y1), color, line_width)
    if show_labels:
        label = (class_names or {}).get(cls, str(cls))
        font = f"ann{line_width}"
        tw, th = draw.text_size(label, font)
        base = draw.text_baseline(label, font)
        ty = max(y0 - base, th + base)
        draw.fill_rect(img, (x0, ty - th - base), (x0 + tw + 2, ty + base), color)
        draw.put_text(img, label, (x0 + 1, ty), font, (255, 255, 255))


def visualize_one(image_path: Path, label_path: Path, args, logger) -> None:
    from geotrax_tpu_torch.train.data import load_image

    if not label_path.exists():
        logger.warning(f"Annotation file not found, skipping: {label_path}")
        return
    try:
        img = load_image(image_path).copy()
    except Exception as exc:
        logger.warning(f"Image not found or unreadable: {image_path} ({exc})")
        return
    h, w = img.shape[:2]
    drawn = 0
    for cls, cx, cy, bw, bh in load_yolo_labels(label_path):
        cls = int(cls)
        if args.type is not None and cls not in args.type:
            continue
        draw_annotation(
            img, cls,
            int((cx - bw / 2) * w), int((cy - bh / 2) * h),
            int((cx + bw / 2) * w), int((cy + bh / 2) * h),
            args.line_width, args.class_names, args.show_labels,
        )
        drawn += 1
    logger.info(f"{image_path.name}: {drawn} annotation(s) drawn")

    if args.save:
        out_path = args.output_dir / image_path.name
        if out_path.exists() and not args.overwrite:
            logger.warning(f"Skipping existing file (use --overwrite): {out_path}")
        else:
            args.output_dir.mkdir(parents=True, exist_ok=True)
            save_frame(out_path, img, jpeg_quality=95)
            logger.info(f"Saved: {out_path}")


def run_visualizer(args, logger) -> None:
    try:
        args.class_names = resolve_class_names(args.class_names)
    except (FileNotFoundError, KeyError, ValueError) as exc:
        logger.error(f"Failed to parse --class-names: {exc}")
        return

    if args.source.is_dir():
        ann_dir = (args.annotations if args.annotations and args.annotations.is_dir()
                   else args.source.parent / "labels")
        if not ann_dir.is_dir():
            logger.error(f"Annotations directory not found: {ann_dir}")
            return
        if args.output_dir is None:
            args.output_dir = args.source.parent / "visualizations"
        top = find_max_annotations(ann_dir, args.top_n, args.type)
        if not top:
            logger.warning(f"No annotation files found in: {ann_dir}")
            return
        exts = ([f".{args.ext.lstrip('.')}", f".{args.ext.lstrip('.').upper()}"]
                if args.ext else list(IMAGE_FORMATS))
        processed = 0
        for _count, ann_file in top:
            image_file = next(
                (args.source / f"{ann_file.stem}{e}" for e in exts
                 if (args.source / f"{ann_file.stem}{e}").exists()), None)
            if image_file is None:
                logger.warning(f"No matching image for annotation: {ann_file.name}")
                continue
            visualize_one(image_file, ann_file, args, logger)
            processed += 1
        logger.info(f"Done. {processed} image(s) processed.")
    else:
        if not args.source.exists():
            logger.error(f"Source image not found: {args.source}")
            return
        if args.annotations is not None:
            ann_file = (args.annotations if args.annotations.is_file()
                        else args.annotations / f"{args.source.stem}.txt")
        else:
            ann_file = args.source.parent.parent / "labels" / f"{args.source.stem}.txt"
        if args.output_dir is None:
            args.output_dir = args.source.parent.parent / "visualizations"
        visualize_one(args.source, ann_file, args, logger)


def parse_cli_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Visualize YOLO-format annotations on images.")
    parser.add_argument("source", type=Path, help="Image file or directory containing images.")
    parser.add_argument("--annotations", "-a", type=Path, default=None,
                        help="Annotations directory or file (default: <source>/../labels).")
    parser.add_argument("--ext", "-e", type=str, default=None,
                        help="Image extension to match in directory mode.")
    parser.add_argument("--top-n", "-n", type=int, default=10,
                        help="Top-N most-annotated frames in directory mode (default: 10).")
    parser.add_argument("--save", "-s", action="store_true",
                        help="Save visualizations to the output directory.")
    parser.add_argument("--show", action=argparse.BooleanOptionalAction, default=None,
                        help="Display interactively (default: True unless --save); "
                             "not available in this port (exits 1).")
    parser.add_argument("--output-dir", "-o", type=Path, default=None,
                        help="Output directory (default: <source>/../visualizations).")
    parser.add_argument("--overwrite", "-ow", action="store_true",
                        help="Overwrite existing output files when saving.")
    parser.add_argument("--line-width", "-lw", type=int, default=3,
                        help="Bounding box line width in pixels (default: 3).")
    parser.add_argument("--show-labels", action=argparse.BooleanOptionalAction,
                        default=True, help="Overlay class name on each box.")
    parser.add_argument("--class-names", "-cn", nargs="+", default=None,
                        metavar="NAME_OR_PATH",
                        help="YAML/JSON file, key:value pairs (0:car), or positional names.")
    parser.add_argument("--type", "-t", nargs="+", type=int, default=None,
                        help="Class IDs to visualize (default: all).")
    parser.add_argument("--log-path", "-lp", type=Path, default=None,
                        help="Log directory or file path.")
    parser.add_argument("--quiet", "-q", action="store_true",
                        help="Reduce console verbosity.")
    args = parser.parse_args(argv)
    if args.show is None:
        args.show = not args.save
    return args


def main(argv=None) -> int:
    args = parse_cli_args(argv)
    logger = setup_logger("viz_annotations", verbose=not args.quiet, log_path=args.log_path)
    if args.show:
        logger.error(NO_DISPLAY)
        return 1
    run_visualizer(args, logger)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
