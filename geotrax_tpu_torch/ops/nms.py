"""Fixed-shape NMS and detection post-processing.

Counterpart of ``geotrax_tpu/ops/nms.py``. Static shapes throughout: the
caller supplies a fixed candidate count and ``max_det`` output slots; empty
slots carry index 0 and ``valid=False``. Both functions take one image's
arrays or a batch of them (a leading axis), which is how the fused chunk
step runs them: one call for all frames of a chunk.
"""

from __future__ import annotations

import torch

from geotrax_tpu_torch.ops.boxes import iou_matrix, xywh_to_xyxy
from geotrax_tpu_torch.ops.topk import exact_top_k

# Greedy rounds run between two host reads of the convergence flag: the JAX
# reference tests it on the device every round (lax.while_loop); here each
# test is a device->host sync, so it is taken once per block of rounds.
# Rounds past the fixed point change nothing, so the result is the same.
NMS_ROUNDS_PER_CHECK = 4


def nms(boxes_xyxy: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
        max_det: int, class_ids: torch.Tensor | None = None, agnostic: bool = True):
    """Greedy NMS over (N,4) boxes and (N,) scores, or a batch (B,N,4)/(B,N).

    Returns (keep_indices (...,max_det), valid_mask (...,max_det)); invalid
    slots hold index 0 with valid=False. Scores <= 0 are absent candidates.
    """
    single = scores.dim() == 1
    if single:
        boxes_xyxy, scores = boxes_xyxy[None], scores[None]
        class_ids = None if class_ids is None else class_ids[None]
    dev = scores.device
    b, n = scores.shape
    order = torch.argsort(-scores, dim=-1, stable=True)
    boxes_sorted = torch.gather(boxes_xyxy, 1, order[..., None].expand(b, n, 4))
    scores_sorted = torch.gather(scores, 1, order)

    offset_boxes = boxes_sorted
    if not agnostic and class_ids is not None:
        # per-class coordinate offset: boxes of different classes never overlap
        span = (boxes_sorted.amax(dim=(1, 2)) - boxes_sorted.amin(dim=(1, 2))) + 1.0
        cls_sorted = torch.gather(class_ids, 1, order).to(boxes_sorted.dtype)
        offset_boxes = boxes_sorted + (cls_sorted * span[:, None])[..., None]

    iou = iou_matrix(offset_boxes, offset_boxes)
    positions = torch.arange(n, device=dev)

    # Fixed-point form of greedy NMS: keep_i = ~exists j<i kept with
    # iou(i,j) > t. Iterating from all-kept converges to the exact greedy
    # solution in as many rounds as the deepest suppression chain (<= n).
    alive = scores_sorted > 0.0
    suppress_mask = (iou > iou_threshold) & (positions[:, None] < positions[None, :])
    suppress_mask = suppress_mask & alive[:, :, None]
    del iou

    keep = alive
    rounds = 0
    while rounds < n:
        for _ in range(min(NMS_ROUNDS_PER_CHECK, n - rounds)):
            prev = keep
            suppressed = (suppress_mask & keep[:, :, None]).any(dim=1)
            keep = alive & ~suppressed
            rounds += 1
        if not bool((keep != prev).any()):
            break

    # Compact kept indices into max_det slots, preserving score order.
    kept_rank = torch.cumsum(keep, dim=1) - 1
    sort_key = torch.where(keep, kept_rank, n + positions[None, :])
    compact = torch.argsort(sort_key, dim=1)[:, : min(max_det, n)]
    if n < max_det:
        # fewer candidates than output slots: pad with index 0, masked
        # invalid below since sum(kept) <= n
        compact = torch.nn.functional.pad(compact, (0, max_det - n))
    valid = torch.arange(max_det, device=dev)[None, :] < keep.sum(dim=1, keepdim=True)
    keep_indices = torch.where(valid, torch.gather(order, 1, compact), 0)
    if single:
        return keep_indices[0], valid[0]
    return keep_indices, valid


def postprocess_detections(boxes_xywh: torch.Tensor, class_scores: torch.Tensor,
                           conf_threshold: float, iou_threshold: float, max_det: int,
                           class_mask: torch.Tensor | None = None,
                           agnostic: bool = True) -> dict:
    """Detector-head output -> final detections (ultralytics-compatible).

    boxes_xywh: (N,4) or (B,N,4); class_scores: (N,C) or (B,N,C)
    post-sigmoid. Per anchor the best class is taken; anchors below
    ``conf_threshold`` or outside ``class_mask`` are dropped; NMS keeps at
    most ``max_det``. Returns a dict of fixed-shape tensors: boxes_xywh
    (...,max_det,4), scores, classes (int32, -1 when empty), valid.
    """
    single = boxes_xywh.dim() == 2
    if single:
        boxes_xywh, class_scores = boxes_xywh[None], class_scores[None]
    if class_mask is not None:
        class_scores = torch.where(class_mask[None, None, :], class_scores, 0.0)
    scores = class_scores.amax(dim=-1)
    classes = torch.argmax(class_scores, dim=-1).to(torch.int32)
    scores = torch.where(scores >= conf_threshold, scores, 0.0)

    # Candidate pre-selection: NMS is O(K^2) in candidates, so top-K first
    # (floored at 1024 so a small max_det still sees enough candidates).
    b, n = scores.shape
    k = min(max(2 * max_det, 1024), n)
    top_scores, top_idx = exact_top_k(scores, k)
    cand_boxes = torch.gather(boxes_xywh, 1, top_idx[..., None].expand(b, k, 4))
    cand_classes = torch.gather(classes, 1, top_idx)

    keep, valid = nms(xywh_to_xyxy(cand_boxes), top_scores, iou_threshold, max_det,
                      class_ids=cand_classes, agnostic=agnostic)
    boxes = torch.gather(cand_boxes, 1, keep[..., None].expand(b, max_det, 4))
    out = {
        "boxes_xywh": torch.where(valid[..., None], boxes, 0.0),
        "scores": torch.where(valid, torch.gather(top_scores, 1, keep), 0.0),
        "classes": torch.where(valid, torch.gather(cand_classes, 1, keep), -1),
        "valid": valid,
    }
    if single:
        return {key: v[0] for key, v in out.items()}
    return out
