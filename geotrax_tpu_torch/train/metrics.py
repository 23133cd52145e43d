"""Detection evaluation: precision / recall / mAP@50 / mAP@50-95.

The port's copy of ``geotrax_tpu/train/metrics.py`` (numpy only); its results
equal the reference's.

COCO-style AP with the 101-point interpolation the reference reports its
headline numbers in (SURVEY.md §6 / BASELINE.md: mAP@50 0.951 etc. via the
ultralytics validator): predictions matched to GT greedily by descending
confidence at each IoU threshold, one match per GT, AP = area under the
interpolated PR curve, averaged over classes (and thresholds for 50-95).
"""

from __future__ import annotations

import numpy as np


def _iou_np(a_xyxy: np.ndarray, b_xyxy: np.ndarray) -> np.ndarray:
    x1 = np.maximum(a_xyxy[:, None, 0], b_xyxy[None, :, 0])
    y1 = np.maximum(a_xyxy[:, None, 1], b_xyxy[None, :, 1])
    x2 = np.minimum(a_xyxy[:, None, 2], b_xyxy[None, :, 2])
    y2 = np.minimum(a_xyxy[:, None, 3], b_xyxy[None, :, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    area_a = (a_xyxy[:, 2] - a_xyxy[:, 0]) * (a_xyxy[:, 3] - a_xyxy[:, 1])
    area_b = (b_xyxy[:, 2] - b_xyxy[:, 0]) * (b_xyxy[:, 3] - b_xyxy[:, 1])
    return inter / (area_a[:, None] + area_b[None, :] - inter + 1e-9)


def _xywh_to_xyxy(b):
    out = b.copy()
    out[:, 0] = b[:, 0] - b[:, 2] / 2
    out[:, 1] = b[:, 1] - b[:, 3] / 2
    out[:, 2] = b[:, 0] + b[:, 2] / 2
    out[:, 3] = b[:, 1] + b[:, 3] / 2
    return out


def _average_precision(recall: np.ndarray, precision: np.ndarray) -> float:
    """101-point interpolated AP."""
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[1.0], precision, [0.0]])
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
    x = np.linspace(0, 1, 101)
    return float(np.trapezoid(np.interp(x, mrec, mpre), x))


def evaluate_detections(predictions: list, ground_truths: list, num_classes: int,
                        iou_thresholds=None) -> dict:
    """predictions / ground_truths: per-image lists.

    prediction: dict(boxes_xywh (N,4), scores (N,), classes (N,))
    ground truth: dict(boxes_xywh (M,4), classes (M,))
    Returns {'precision','recall','map50','map50_95','per_class_ap50'}.
    """
    if iou_thresholds is None:
        iou_thresholds = np.arange(0.5, 1.0, 0.05)

    ap_table = np.zeros((len(iou_thresholds), num_classes))
    p_at_50 = np.zeros(num_classes)
    r_at_50 = np.zeros(num_classes)
    class_has_gt = np.zeros(num_classes, bool)

    for c in range(num_classes):
        records = []  # (score, image_idx, box)
        gts = []
        for img_idx, (pred, gt) in enumerate(zip(predictions, ground_truths)):
            pc = np.asarray(pred["classes"])
            for j in np.where(pc == c)[0]:
                records.append((float(pred["scores"][j]), img_idx,
                                np.asarray(pred["boxes_xywh"][j], float)))
            gc = np.asarray(gt["classes"])
            gts.append(np.asarray(gt["boxes_xywh"], float)[gc == c])
        n_gt = sum(len(g) for g in gts)
        if n_gt == 0:
            continue
        class_has_gt[c] = True
        if not records:
            continue  # AP stays 0: GT exists but nothing was predicted
        records.sort(key=lambda r: -r[0])

        for ti, thr in enumerate(iou_thresholds):
            matched = [np.zeros(len(g), bool) for g in gts]
            tp = np.zeros(len(records))
            fp = np.zeros(len(records))
            for ri, (score, img_idx, box) in enumerate(records):
                g = gts[img_idx]
                if len(g) == 0:
                    fp[ri] = 1
                    continue
                ious = _iou_np(_xywh_to_xyxy(box[None]), _xywh_to_xyxy(g))[0]
                # best UNMATCHED GT above threshold (COCO/ultralytics): the
                # plain argmax could point at an already-matched GT while a
                # second overlapping GT was still free — undercounting TPs
                # in exactly the dense-traffic scenes this dataset is about
                free = ~matched[img_idx]
                cand = np.where(free, ious, -1.0)
                best = int(np.argmax(cand))
                if cand[best] >= thr:
                    matched[img_idx][best] = True
                    tp[ri] = 1
                else:
                    fp[ri] = 1
            cum_tp = np.cumsum(tp)
            cum_fp = np.cumsum(fp)
            recall = cum_tp / n_gt
            precision = cum_tp / np.maximum(cum_tp + cum_fp, 1e-9)
            ap_table[ti, c] = _average_precision(recall, precision)
            if ti == 0 and len(records):
                # report P/R at the max-F1 point of the curve (ultralytics
                # semantics), not at the 0.001-conf tail where cumulative
                # precision collapses for any model with low-conf noise
                f1 = 2 * precision * recall / np.maximum(precision + recall, 1e-9)
                best_op = int(np.argmax(f1))
                p_at_50[c] = precision[best_op]
                r_at_50[c] = recall[best_op]

    valid = class_has_gt
    return {
        "precision": float(p_at_50[valid].mean()) if valid.any() else 0.0,
        "recall": float(r_at_50[valid].mean()) if valid.any() else 0.0,
        "map50": float(ap_table[0, valid].mean()) if valid.any() else 0.0,
        "map50_95": float(ap_table[:, valid].mean()) if valid.any() else 0.0,
        "per_class_ap50": {int(c): float(ap_table[0, c]) for c in range(num_classes) if valid[c]},
        # full per-class metric set — the reference reports per-class
        # P / R / mAP@50 / mAP@50-95 (reference README.md:192-200)
        "per_class": {
            int(c): {
                "precision": float(p_at_50[c]),
                "recall": float(r_at_50[c]),
                "ap50": float(ap_table[0, c]),
                "ap50_95": float(ap_table[:, c].mean()),
            }
            for c in range(num_classes) if valid[c]
        },
    }
