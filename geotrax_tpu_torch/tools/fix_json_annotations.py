"""Clean and fix JSON annotation files (labelme folders and COCO files):
the port of ``tools/fix_json_annotations.py``.

A DIRECTORY of labelme JSONs, each file in turn (in the reference's order:
normalize -> remove -> replace -> convert), then a summary:
  --remove-image-data        null the embedded base64 ``imageData``
  --normalize-to-unix / --normalize-to-windows   flip ``imagePath`` separators
  --remove-from-path S / --replace-path OLD NEW  edit ``imagePath``
  --to-obb                   rectangles -> 4-point polygons (TL, BL, BR, TR)
  --to-hbb                   polygons -> axis-aligned 2-point rectangles
  --debug                    preview without writing
One COCO .json file: drop degenerate boxes, clip to the image, renumber
the annotations, ``--obb-to-hbb`` from ``segmentation`` polygons.

Usage:
  python -m geotrax_tpu_torch.tools.fix_json_annotations LABELS_DIR --remove-image-data --to-obb
  python -m geotrax_tpu_torch.tools.fix_json_annotations ANN.json [-o FIXED.json] [--obb-to-hbb]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from geotrax_tpu_torch.utils.logging_utils import setup_logger


def fix(coco: dict, obb_to_hbb: bool = False) -> tuple[dict, dict]:
    sizes = {img["id"]: (img["width"], img["height"]) for img in coco.get("images", [])}
    kept = []
    stats = {"dropped": 0, "clipped": 0, "converted": 0}
    for ann in coco.get("annotations", []):
        if obb_to_hbb and ann.get("segmentation"):
            seg = ann["segmentation"][0]
            xs, ys = seg[0::2], seg[1::2]
            ann["bbox"] = [min(xs), min(ys), max(xs) - min(xs), max(ys) - min(ys)]
            stats["converted"] += 1
        x, y, w, h = ann["bbox"]
        if w <= 0 or h <= 0:
            stats["dropped"] += 1
            continue
        img_w, img_h = sizes.get(ann["image_id"], (float("inf"), float("inf")))
        x2, y2 = min(x + w, img_w), min(y + h, img_h)
        x, y = max(x, 0), max(y, 0)
        if (x, y, x2 - x, y2 - y) != tuple(ann["bbox"]):
            stats["clipped"] += 1
        if x2 - x <= 0 or y2 - y <= 0:
            stats["dropped"] += 1
            continue
        ann["bbox"] = [round(x, 2), round(y, 2), round(x2 - x, 2), round(y2 - y, 2)]
        ann["area"] = round((x2 - x) * (y2 - y), 2)
        kept.append(ann)
    for i, ann in enumerate(kept, start=1):
        ann["id"] = i
    coco["annotations"] = kept
    return coco, stats


def run_coco_mode(args, logger) -> int:
    coco = json.loads(args.labels.read_text())
    fixed, stats = fix(coco, args.obb_to_hbb or args.to_hbb)
    out = args.out or args.labels
    out.write_text(json.dumps(fixed, indent=2))
    print(f"{stats['dropped']} dropped, {stats['clipped']} clipped, "
          f"{stats['converted']} OBB->HBB -> {out}")
    return 0


def _to_obb(ann: dict, label_path: Path, logger) -> int:
    converted = 0
    for shape in ann.get("shapes", []):
        if shape.get("shape_type") == "rectangle":
            (x_tl, y_tl), (x_br, y_br) = shape["points"][:2]
            shape["shape_type"] = "polygon"
            shape["points"] = [[x_tl, y_tl], [x_tl, y_br], [x_br, y_br], [x_br, y_tl]]
            converted += 1
        elif shape.get("shape_type") == "polygon" and len(shape["points"]) != 4:
            logger.error(f"Polygon in '{label_path}' does not contain exactly 4 points.")
    return converted


def _to_hbb(ann: dict) -> int:
    converted = 0
    for shape in ann.get("shapes", []):
        if shape.get("shape_type") == "polygon":
            xs = [p[0] for p in shape["points"]]
            ys = [p[1] for p in shape["points"]]
            shape["shape_type"] = "rectangle"
            shape["points"] = [[min(xs), min(ys)], [max(xs), max(ys)]]
            converted += 1
    return converted


def _edit_path(ann: dict, args, counts: dict) -> None:
    path = ann.get("imagePath", "")
    if args.normalize_to_unix and "\\" in path:
        ann["imagePath"] = path = path.replace("\\", "/")
        counts["path_norm"] += 1
    if args.normalize_to_windows and "/" in path:
        ann["imagePath"] = path = path.replace("/", "\\")
        counts["path_norm"] += 1
    if args.remove_from_path and args.remove_from_path in path:
        ann["imagePath"] = path = path.replace(args.remove_from_path, "")
        counts["path_mod"] += 1
    if args.replace_path and args.replace_path[0] in path:
        ann["imagePath"] = path.replace(args.replace_path[0], args.replace_path[1])
        counts["path_mod"] += 1


def run_labelme_mode(args, logger) -> int:
    label_paths = [p for p in args.labels.rglob("*")
                   if p.is_file() and p.suffix.lower() == ".json"]
    if not label_paths:
        logger.error(f"No label files found in input directory '{args.labels}'.")
        return 1
    logger.notice(f"Found {len(label_paths)} JSON annotation files in '{args.labels}'.")
    if args.debug:
        logger.info("Running in DEBUG mode - no files will be modified.")

    counts = {"processed": 0, "image_data": 0, "to_obb": 0, "to_hbb": 0,
              "path_mod": 0, "path_norm": 0}
    for label_path in sorted(label_paths):
        ann = json.loads(label_path.read_text())
        if args.remove_image_data and ann.get("imageData") is not None:
            ann["imageData"] = None
            counts["image_data"] += 1
        _edit_path(ann, args, counts)
        if args.to_obb:
            converted = _to_obb(ann, label_path, logger)
            if converted:
                counts["to_obb"] += 1
                logger.info(f"  Converted {converted} HBB rectangle(s) to OBB "
                            f"polygon(s) in '{label_path.name}'")
        if args.to_hbb:
            converted = _to_hbb(ann)
            if converted:
                counts["to_hbb"] += 1
                logger.info(f"  Converted {converted} OBB polygon(s) to HBB "
                            f"rectangle(s) in '{label_path.name}'")
        if not args.debug:
            label_path.write_text(json.dumps(ann, indent=2))
        counts["processed"] += 1

    summary = [f"Total files processed: {counts['processed']}"]
    if args.remove_image_data:
        summary.append(f"Files with image data removed: {counts['image_data']}")
    if args.normalize_to_unix or args.normalize_to_windows:
        summary.append(f"Files with normalized paths: {counts['path_norm']}")
    if args.remove_from_path or args.replace_path:
        summary.append(f"Files with modified paths: {counts['path_mod']}")
    if args.to_obb:
        summary.append(f"Files with HBB to OBB conversions: {counts['to_obb']}")
    if args.to_hbb:
        summary.append(f"Files with OBB to HBB conversions: {counts['to_hbb']}")
    summary.append("Note: No files were modified (debug mode)" if args.debug
                   else "All changes saved successfully.")
    logger.notice("Summary:\n  " + "\n  ".join(summary))
    return 0


def parse_cli_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Clean and fix JSON annotation files")
    parser.add_argument("labels", type=Path,
                        help="LabelMe annotations directory, or one COCO .json")
    parser.add_argument("--remove-image-data", "-ri", action="store_true",
                        help="Null embedded base64 image data")
    conv = parser.add_mutually_exclusive_group()
    conv.add_argument("--to-obb", "-to", action="store_true",
                      help="HBB rectangles -> OBB 4-point polygons")
    conv.add_argument("--to-hbb", "-th", action="store_true",
                      help="OBB polygons -> HBB rectangles")
    norm = parser.add_mutually_exclusive_group()
    norm.add_argument("--normalize-to-unix", "-nu", action="store_true")
    norm.add_argument("--normalize-to-windows", "-nw", action="store_true")
    parser.add_argument("--remove-from-path", "-r", type=str, default=None)
    parser.add_argument("--replace-path", "-p", nargs=2, metavar=("OLD", "NEW"), default=None)
    parser.add_argument("--debug", "-d", action="store_true",
                        help="Preview changes without modifying files")
    parser.add_argument("--out", "-o", type=Path, default=None,
                        help="(COCO mode) output path; default in-place")
    parser.add_argument("--obb-to-hbb", action="store_true",
                        help="(COCO mode) rebuild bbox from segmentation")
    parser.add_argument("--log-path", "-lp", type=Path, default=None)
    parser.add_argument("--quiet", "-q", action="store_true")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_cli_args(argv)
    logger = setup_logger("fix_json_annotations", verbose=not args.quiet,
                          log_path=args.log_path)
    if args.labels.is_dir():
        return run_labelme_mode(args, logger)
    return run_coco_mode(args, logger)


if __name__ == "__main__":
    raise SystemExit(main())
