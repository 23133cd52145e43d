"""YOLO-format pre-labels of an image folder from the detector: the port of
``tools/annotate_frames.py``.

Runs the port's ``Detector`` on ``--device`` (the card unless ``--device
cpu``) over every image of a folder and writes one ``class_id cx cy w h``
line per box (normalized; an empty .txt for an image without boxes), with
the reference tool's workflow:

- default output ``<source>/../pre-labels``; an existing .txt is skipped
  (hand-edited labels survive) unless ``--overwrite``
- detection settings from the config's ``ultralytics:`` section with
  one-off overrides ``--conf --iou --imgsz --max-det --agnostic-nms
  --classes --augment`` (test-time augmentation: the horizontally flipped
  image's boxes merged in, on the host)
- per-class confidence thresholds ``-t 0=0.3 1=0.5`` on top of the base conf
- ``--save-conf`` appends the score to each line
- ``--save-viz`` draws the boxes (``--hide-conf --hide-labels
  --line-width``; class names from the checkpoint, ``-cn 0=car`` or a
  YAML/JSON map) through ``ops/draw.py``; ``--save-masked --margin``
  blacks out the (enlarged) boxes

The labels text is drawn in the stage font of ``ops/draw.py`` at half the
box line width: the reference's cv2 font scale (``lw / 6``) with a thinner
stroke, since cv2 is not used.

Usage:
  python -m geotrax_tpu_torch.tools.annotate_frames IMAGES_DIR -m weights.npz [options]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from geotrax_tpu_torch.tools._common import iter_images
from geotrax_tpu_torch.utils.logging_utils import setup_logger


def parse_class_conf(pairs) -> dict[int, float]:
    out = {}
    for pair in pairs or []:
        cid, thr = pair.split("=")
        out[int(cid)] = float(thr)
    return out


def parse_class_names(entries, default: dict) -> dict:
    """-cn 0=car 1=bus pairs or one YAML/JSON mapping file."""
    if not entries:
        return default
    if len(entries) == 1 and "=" not in entries[0]:
        path = Path(entries[0])
        text = path.read_text()
        if path.suffix in (".yml", ".yaml"):
            from geotrax_tpu_torch.io import yaml_load

            return {int(k): str(v) for k, v in yaml_load.safe_load(text).items()}
        return {int(k): str(v) for k, v in json.loads(text).items()}
    return {int(p.split("=")[0]): p.split("=")[1] for p in entries}


def _merge_tta(boxes, scores, classes, iou_thr: float):
    """Greedy score-ordered dedup of the direct and flipped detections (host
    numpy: a handful of boxes per image). ``np.argsort(-scores)`` is the
    reference's order, ties included."""
    order = np.argsort(-scores)
    keep = []
    for i in order:
        dup = False
        for j in keep:
            bi, bj = boxes[i], boxes[j]
            x1 = max(bi[0] - bi[2] / 2, bj[0] - bj[2] / 2)
            y1 = max(bi[1] - bi[3] / 2, bj[1] - bj[3] / 2)
            x2 = min(bi[0] + bi[2] / 2, bj[0] + bj[2] / 2)
            y2 = min(bi[1] + bi[3] / 2, bj[1] + bj[3] / 2)
            inter = max(0.0, x2 - x1) * max(0.0, y2 - y1)
            union = bi[2] * bi[3] + bj[2] * bj[3] - inter
            if union > 0 and inter / union >= iou_thr:
                dup = True
                break
        if not dup:
            keep.append(i)
    keep = np.asarray(keep, int)
    return boxes[keep], scores[keep], classes[keep]


def _host(det: dict) -> tuple:
    """(boxes xywh float64, scores float64, classes) of the valid slots."""
    det = {k: v.cpu().numpy() for k, v in det.items()}
    valid = det["valid"]
    return (det["boxes_xywh"].astype(np.float64)[valid],
            det["scores"].astype(np.float64)[valid], det["classes"][valid])


def detect_image(detector, img, augment: bool, iou_thr: float):
    """(boxes_xywh px, scores, classes) with optional hflip TTA."""
    boxes, scores, classes = _host(detector(img))
    if not augment:
        return boxes, scores, classes
    boxes_f, scores_f, classes_f = _host(detector(np.ascontiguousarray(img[:, ::-1])))
    boxes_f[:, 0] = img.shape[1] - boxes_f[:, 0]  # unflip centers
    boxes = np.concatenate([boxes, boxes_f])
    scores = np.concatenate([scores, scores_f])
    classes = np.concatenate([classes, classes_f])
    return _merge_tta(boxes, scores, classes, iou_thr)


def draw_viz(img, boxes, scores, classes, names, hide_conf, hide_labels, line_width):
    from geotrax_tpu_torch.ops import draw
    from geotrax_tpu_torch.utils.data_utils import VizColors

    canvas = img.copy()
    lw = line_width or max(round(sum(img.shape[:2]) / 2 * 0.003), 2)
    for b, s, c in zip(boxes, scores, classes):
        x0, y0 = int(b[0] - b[2] / 2), int(b[1] - b[3] / 2)
        x1, y1 = int(b[0] + b[2] / 2), int(b[1] + b[3] / 2)
        color = VizColors.rgb(int(c))
        draw.rectangle(canvas, (x0, y0), (x1, y1), color, lw)
        label = "" if hide_labels else names.get(int(c), str(int(c)))
        if not hide_conf:
            label = f"{label} {s:.2f}".strip()
        if label:
            draw.put_text(canvas, label, (x0, max(y0 - 4, 10)), max(lw // 2, 1), color)
    return canvas


def mask_image(img, boxes, margin: float):
    out = img.copy()
    h, w = img.shape[:2]
    for b in boxes:
        bw, bh = b[2] * (1 + margin), b[3] * (1 + margin)
        x0 = max(int(b[0] - bw / 2), 0)
        y0 = max(int(b[1] - bh / 2), 0)
        x1 = min(int(b[0] + bw / 2), w)
        y1 = min(int(b[1] + bh / 2), h)
        out[y0:y1, x0:x1] = 0
    return out


def build_detector(args, logger) -> tuple:
    """(the port's Detector on ``args.device``, its detection config)."""
    from geotrax_tpu_torch.models.detector import Detector
    from geotrax_tpu_torch.utils.config_utils import load_config

    detect_cfg = dict(load_config(args.cfg, logger).get("ultralytics", {}))
    for key, val in (("conf", args.conf), ("iou", args.iou), ("imgsz", args.imgsz),
                     ("max_det", args.max_det), ("classes", args.classes)):
        if val is not None:
            detect_cfg[key] = val
    if args.agnostic_nms is not None:
        detect_cfg["agnostic_nms"] = args.agnostic_nms
    return Detector(Path(args.model), detect_cfg, logger=logger, device=args.device), detect_cfg


def annotate(args, logger) -> int:
    from geotrax_tpu_torch.io.png import write_png
    from geotrax_tpu_torch.models.convert import read_class_names
    from geotrax_tpu_torch.train.data import load_image

    detector, detect_cfg = build_detector(args, logger)
    class_conf = parse_class_conf(args.class_conf)
    names = parse_class_names(args.class_names, read_class_names(Path(args.model)) or {})

    labels_dir = (args.annotations or args.source.parent / "pre-labels").resolve()
    labels_dir.mkdir(parents=True, exist_ok=True)
    viz_dir = None
    if args.save_viz:
        viz_dir = (args.viz_dir or labels_dir / "visualizations").resolve()
        viz_dir.mkdir(parents=True, exist_ok=True)
    masked_dir = None
    if args.save_masked:
        masked_dir = (labels_dir / "masked").resolve()
        masked_dir.mkdir(parents=True, exist_ok=True)

    n_images = n_boxes = n_skipped = 0
    for img_path in iter_images(args.source):
        out_txt = labels_dir / f"{img_path.stem}.txt"
        if out_txt.exists() and not args.overwrite:
            n_skipped += 1
            continue
        img = load_image(img_path)
        h, w = img.shape[:2]
        boxes, scores, classes = detect_image(detector, img, args.augment,
                                              float(detect_cfg.get("iou", 0.7)))
        if class_conf:
            thr = np.asarray([class_conf.get(int(c), -1.0) for c in classes])
            keep = scores >= np.maximum(thr, float(detect_cfg.get("conf", 0.25)))
            boxes, scores, classes = boxes[keep], scores[keep], classes[keep]

        lines = []
        for b, s, c in zip(boxes, scores, classes):
            line = f"{int(c)} {b[0] / w:.6f} {b[1] / h:.6f} {b[2] / w:.6f} {b[3] / h:.6f}"
            if args.save_conf:
                line += f" {s:.4f}"
            lines.append(line)
        out_txt.write_text("\n".join(lines) + ("\n" if lines else ""))
        n_images += 1
        n_boxes += len(lines)
        if viz_dir is not None:
            write_png(viz_dir / f"{img_path.stem}.png",
                      draw_viz(img, boxes, scores, classes, names, args.hide_conf,
                               args.hide_labels, args.line_width))
        if masked_dir is not None:
            write_png(masked_dir / f"{img_path.stem}.png", mask_image(img, boxes, args.margin))

    logger.notice(
        f"Annotated {n_images} image(s), {n_boxes} box(es) -> {labels_dir}"
        + (f" ({n_skipped} existing annotation(s) skipped; use --overwrite "
           "to regenerate)" if n_skipped else "")
    )
    return 0


def parse_cli_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Generate YOLO-format annotations for images.")
    parser.add_argument("source", type=Path, help="Directory containing images to annotate")
    parser.add_argument("--annotations", "-a", type=Path, default=None,
                        help="Annotation output dir (default <source>/../pre-labels)")
    parser.add_argument("--cfg", "-c", default="default", help="Pipeline config or preset name")
    parser.add_argument("--model", "-m", required=True,
                        help="Detector weights (.npz, or .pt to convert)")
    parser.add_argument("--class-names", "-cn", nargs="+", default=None,
                        help="ID=NAME pairs or one YAML/JSON mapping file")
    parser.add_argument("--save-viz", "-v", action="store_true")
    parser.add_argument("--viz-dir", "-z", type=Path, default=None)
    parser.add_argument("--save-masked", "-mk", action="store_true")
    parser.add_argument("--margin", "-g", type=float, default=0.0,
                        help="Box enlargement factor for masked images")
    parser.add_argument("--conf", "-f", type=float, default=None)
    parser.add_argument("--iou", "-i", type=float, default=None)
    parser.add_argument("--imgsz", "-sz", type=int, default=None)
    parser.add_argument("--augment", "-ag", action=argparse.BooleanOptionalAction,
                        default=False, help="Test-time augmentation (hflip merge)")
    parser.add_argument("--max-det", "-md", type=int, default=None)
    parser.add_argument("--agnostic-nms", "-an", action=argparse.BooleanOptionalAction,
                        default=None)
    parser.add_argument("--classes", "-k", type=int, nargs="+", default=None)
    parser.add_argument("--class-conf", "-t", nargs="+", default=None, metavar="ID=THRESH",
                        help="Per-class confidence thresholds")
    parser.add_argument("--save-conf", "-s", action="store_true",
                        help="Append confidence to annotation lines")
    parser.add_argument("--overwrite", "-o", action="store_true",
                        help="Regenerate existing annotation files")
    parser.add_argument("--hide-conf", "-hc", action="store_true")
    parser.add_argument("--hide-labels", "-hl", action="store_true")
    parser.add_argument("--line-width", "-w", type=int, default=None)
    parser.add_argument("--log-path", "-lp", type=Path, default=None)
    parser.add_argument("--quiet", "-q", action="store_true")
    parser.add_argument("--device", type=str, default="cuda",
                        help="Torch device of the detector (default cuda; 'cpu' runs the plain "
                             "PyTorch path)")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_cli_args(argv)
    logger = setup_logger("annotate_frames", verbose=not args.quiet, log_path=args.log_path)
    return annotate(args, logger)


if __name__ == "__main__":
    raise SystemExit(main())
