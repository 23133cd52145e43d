"""YOLO-format annotations to labelme or COCO JSON: the port of
``tools/yolo_to_coco.py``.

Two modes:
  per-image (default): one labelme-schema JSON per image (rectangle shapes
    in pixels), the class map from ``--class-map`` > ``--map-file`` (YAML
    through ``io/yaml_load.py``, or JSON) > ``--cfg`` (the names stored in
    the checkpoint the config's ``ultralytics.model`` names);
  ``--split``: one COCO detection JSON over a dataset split.
Image sizes come from the files' headers (``io/image_size.py``), as
Pillow's ``Image.size`` gives them.

Usage:
  python -m geotrax_tpu_torch.tools.yolo_to_coco LABELS_DIR [-ii ../images] [-ol OUT]
      [-cm 0=Car 1=Bus | -mf map.yaml | -c default] [-dp 2]
  python -m geotrax_tpu_torch.tools.yolo_to_coco DATASET_DIR --split train -o annotations.json
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from geotrax_tpu_torch.io.image_size import image_size
from geotrax_tpu_torch.train.data import list_samples, load_label
from geotrax_tpu_torch.utils.logging_utils import setup_logger

IMAGE_FORMATS = (".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff")


def parse_class_map(pairs: list, logger) -> dict:
    """['0=Car', '1=Bus'] -> {0: 'Car', 1: 'Bus'}."""
    out = {}
    for pair in pairs:
        try:
            k, name = pair.split("=", 1)
            out[int(k)] = name
        except ValueError:
            logger.warning(f"Skipping invalid --class-map entry '{pair}' "
                           "(expected ID=Name, e.g. 0=Car).")
    return out


def load_class_map_from_file(path: Path, logger) -> dict:
    from geotrax_tpu_torch.io import yaml_load

    try:
        with open(path) as f:
            data = json.load(f) if path.suffix.lower() == ".json" else yaml_load.safe_load(f)
        if isinstance(data, list):
            return {i: str(n) for i, n in enumerate(data)}
        return {int(k): str(v) for k, v in data.items()}
    except Exception as exc:
        logger.error(f"Error loading class map file '{path}': {exc}.")
        return {}


def resolve_class_map(args, logger) -> dict:
    """Priority: --class-map > --map-file > --cfg (model class names)."""
    if args.class_map:
        return parse_class_map(args.class_map, logger)
    if args.map_file:
        return load_class_map_from_file(args.map_file, logger)
    try:
        from geotrax_tpu_torch.models.convert import read_class_names
        from geotrax_tpu_torch.utils.config_utils import load_config, resolve_asset_path

        config = load_config(args.cfg, logger)
        model_path = resolve_asset_path(config["ultralytics"]["model"])
        names = read_class_names(Path(model_path))
        if names:
            logger.info(f"Class names loaded from model: '{model_path}'.")
            return {int(k): str(v) for k, v in names.items()}
    except Exception as exc:
        logger.error(f"Error loading class names via --cfg: {exc}. "
                     "Class IDs will be used as labels.")
    return {}


def convert_per_image(args, logger) -> None:
    """One labelme-schema JSON next to each label file."""
    labels_dir = args.input_labels
    output_dir = args.output_labels or labels_dir
    images_dir = (output_dir / args.input_images).resolve()
    if not images_dir.is_dir():
        logger.error(f"Input images path '{images_dir}' is not a directory.")
        return
    image_paths = [p for p in sorted(images_dir.rglob("*"))
                   if p.is_file() and p.suffix.lower() in IMAGE_FORMATS]
    if not image_paths:
        logger.error(f"No image files found in '{images_dir}'.")
        return
    class_map = resolve_class_map(args, logger)
    dp = args.decimal_places

    processed = skipped = 0
    for image_path in image_paths:
        label_path = labels_dir / f"{image_path.stem}.txt"
        if not label_path.exists():
            logger.warning(f"Label file '{label_path}' not found. "
                           f"Skipping image '{image_path.name}'.")
            skipped += 1
            continue
        try:
            width, height = image_size(image_path)
        except Exception as exc:
            logger.error(f"Unable to read image '{image_path}': {exc}. Skipping.")
            skipped += 1
            continue
        shapes = []
        for cls, cx, cy, w, h in load_label(label_path).astype(float):
            shapes.append({
                "label": class_map.get(int(cls), str(int(cls))),
                "points": [
                    [round((cx - w / 2) * width, dp), round((cy - h / 2) * height, dp)],
                    [round((cx + w / 2) * width, dp), round((cy + h / 2) * height, dp)],
                ],
                "group_id": None,
                "description": "",
                "shape_type": "rectangle",
                "flags": {},
                "mask": None,
            })
        output_dir.mkdir(parents=True, exist_ok=True)
        (output_dir / f"{image_path.stem}.json").write_text(json.dumps({
            "version": "5.5.0",
            "flags": {},
            "shapes": shapes,
            "imagePath": str(args.input_images / image_path.name),
            "imageData": None,
            "imageHeight": height,
            "imageWidth": width,
        }, indent=2))
        processed += 1
        if processed % 10 == 0:
            logger.info(f"Processed {processed} images...")
    logger.info(f"Conversion complete: {processed} files processed, "
                f"{skipped} files skipped.")


def convert_dataset(dataset_dir: Path, split: str, class_names: list) -> dict:
    """Aggregated COCO detection JSON over a dataset split."""
    images, annotations = [], []
    ann_id = 1
    for img_id, (img_path, lbl_path) in enumerate(list_samples(dataset_dir, split), start=1):
        w, h = image_size(img_path)
        images.append({"id": img_id, "file_name": img_path.name, "width": w, "height": h})
        for cls, cx, cy, bw, bh in load_label(lbl_path).astype(float):
            x0 = float((cx - bw / 2) * w)
            y0 = float((cy - bh / 2) * h)
            annotations.append({
                "id": ann_id, "image_id": img_id, "category_id": int(cls) + 1,
                "bbox": [round(x0, 2), round(y0, 2), round(float(bw * w), 2),
                         round(float(bh * h), 2)],
                "area": round(float(bw * w * bh * h), 2), "iscrowd": 0,
            })
            ann_id += 1
    categories = [{"id": i + 1, "name": n} for i, n in enumerate(class_names)]
    return {"images": images, "annotations": annotations, "categories": categories}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("input_labels", type=Path,
                        help="YOLO labels directory (per-image mode) or dataset root (--split mode).")
    parser.add_argument("--input-images", "-ii", type=Path, default=Path("../images"),
                        help="Images path relative to the output labels directory (default: ../images).")
    parser.add_argument("--output-labels", "-ol", type=Path, default=None,
                        help="Where to save the per-image JSONs (default: input_labels).")
    map_group = parser.add_argument_group("class map (first match wins)")
    map_group.add_argument("--class-map", "-cm", nargs="+", metavar="ID=Name",
                           help="Inline pairs, e.g. -cm 0=Car 1=Bus 2=Truck.")
    map_group.add_argument("--map-file", "-mf", type=Path,
                           help="YAML or JSON file mapping class IDs to labels.")
    map_group.add_argument("--cfg", "-c", type=str, default="default",
                           help="Pipeline config whose ultralytics.model supplies class names.")
    parser.add_argument("--decimal-places", "-dp", type=int, default=2,
                        help="Decimal places for box coordinates (default: 2).")
    parser.add_argument("--split", default=None,
                        help="Dataset split -> aggregated COCO JSON mode.")
    parser.add_argument("--classes", nargs="+",
                        default=["car", "bus", "truck", "motorcycle"],
                        help="Category names for --split mode.")
    parser.add_argument("--out", "-o", type=Path, default=None,
                        help="Output JSON for --split mode.")
    parser.add_argument("--log-path", "-lp", type=Path, default=None)
    parser.add_argument("--quiet", "-q", action="store_true")
    args = parser.parse_args(argv)
    logger = setup_logger("yolo_to_coco", verbose=not args.quiet, log_path=args.log_path)

    if args.split:
        coco = convert_dataset(args.input_labels, args.split, args.classes)
        out = args.out or args.input_labels / f"{args.split}_coco.json"
        out.write_text(json.dumps(coco, indent=2))
        print(f"{len(coco['images'])} images, {len(coco['annotations'])} annotations -> {out}")
    else:
        convert_per_image(args, logger)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
