"""YOLOv8 detection loss (task-aligned assignment + CIoU + DFL + BCE).

Counterpart of ``geotrax_tpu/models/loss.py``: the same loss and the same
gradients as ``jax.value_and_grad`` of the reference's ``detection_loss``,
batched over a leading image axis instead of ``vmap``. Fixed shapes: GT
boxes are padded to ``max_gt`` rows with a mask.

Gradients follow the reference's rules, not ultralytics':

- the task-aligned assignment is not detached: ``align``, the per-GT
  maxima and the soft targets carry gradient into the BCE targets and the
  box and DFL weights (only CIoU's ``alpha`` is detached, as in the
  reference);
- JAX's ``maximum``, ``minimum`` and ``clip`` give half the gradient to
  each side at a tie, which ``torch.maximum``/``torch.minimum`` with tensor
  bounds do too (``torch.clamp`` passes all of it), and a max over an axis
  splits it evenly among tied maxima (``torch.amax``);
- ``argmax`` picks the lowest index among ties on both.
"""

from __future__ import annotations

import math

import torch

from geotrax_tpu_torch.models import yolov8
from geotrax_tpu_torch.ops.boxes import iou_matrix, xywh_to_xyxy


def _scalar(value: float) -> torch.Tensor:
    """A 0-dim CPU tensor: a scalar operand of a binary op on any device
    (no host-to-device copy)."""
    return torch.tensor(value, dtype=torch.float32)


def clip(x: torch.Tensor, lo: float, hi: float | None = None) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)``: maximum, then minimum, with JAX's tie rule."""
    x = torch.maximum(x, _scalar(lo))
    return x if hi is None else torch.minimum(x, _scalar(hi))


def ciou(boxes1_xyxy: torch.Tensor, boxes2_xyxy: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Complete IoU between aligned (..., 4) boxes."""
    b1, b2 = boxes1_xyxy, boxes2_xyxy
    x1 = torch.maximum(b1[..., 0], b2[..., 0])
    y1 = torch.maximum(b1[..., 1], b2[..., 1])
    x2 = torch.minimum(b1[..., 2], b2[..., 2])
    y2 = torch.minimum(b1[..., 3], b2[..., 3])
    inter = clip(x2 - x1, 0.0) * clip(y2 - y1, 0.0)
    w1 = b1[..., 2] - b1[..., 0]
    h1 = b1[..., 3] - b1[..., 1]
    w2 = b2[..., 2] - b2[..., 0]
    h2 = b2[..., 3] - b2[..., 1]
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union

    cw = torch.maximum(b1[..., 2], b2[..., 2]) - torch.minimum(b1[..., 0], b2[..., 0])
    ch = torch.maximum(b1[..., 3], b2[..., 3]) - torch.minimum(b1[..., 1], b2[..., 1])
    c2 = cw**2 + ch**2 + eps
    rho2 = ((b1[..., 0] + b1[..., 2] - b2[..., 0] - b2[..., 2]) ** 2
            + (b1[..., 1] + b1[..., 3] - b2[..., 1] - b2[..., 3]) ** 2) / 4
    v = (4 / math.pi**2) * (torch.atan(w2 / (h2 + eps)) - torch.atan(w1 / (h1 + eps))) ** 2
    alpha = v / (v - iou + 1 + eps)
    return iou - rho2 / c2 - alpha.detach() * v


def task_aligned_assign(pred_scores, pred_boxes_xyxy, anchors_px, gt_boxes_xywh, gt_cls, gt_mask,
                        topk: int = 10, alpha: float = 0.5, beta: float = 6.0):
    """Assign each anchor at most one GT, for a batch of images.

    pred_scores (B,A,C) sigmoid probs; pred_boxes (B,A,4) xyxy px;
    anchors_px (A,2); gt_* (B,G,...) with validity gt_mask (B,G).
    Returns (best_gt (B,A), fg (B,A), align (B,A,G), ious (B,A,G),
    pos_mask (B,A,G)).
    """
    b, a, c = pred_scores.shape
    g = gt_boxes_xywh.shape[1]
    gt_xyxy = xywh_to_xyxy(gt_boxes_xywh)  # (B,G,4)
    # candidates: anchor centers inside the GT box
    ax = anchors_px[None, :, None, 0]
    ay = anchors_px[None, :, None, 1]
    in_box = ((ax > gt_xyxy[:, None, :, 0]) & (ax < gt_xyxy[:, None, :, 2])
              & (ay > gt_xyxy[:, None, :, 1]) & (ay < gt_xyxy[:, None, :, 3])
              & gt_mask[:, None, :])

    ious = iou_matrix(pred_boxes_xyxy, gt_xyxy)  # (B,A,G)
    cls_idx = gt_cls.long().clamp(0, c - 1)[:, None, :].expand(b, a, g)
    cls_prob = torch.gather(pred_scores, 2, cls_idx)  # (B,A,G)
    align = (cls_prob**alpha) * (clip(ious, 0.0) ** beta)
    align = torch.where(in_box, align, 0.0)

    # top-k anchors per GT
    kth = torch.topk(align.transpose(1, 2), topk, dim=-1).values[..., -1][:, None, :]  # (B,1,G)
    is_topk = (align >= clip(kth, 1e-9)) & (align > 0)

    # resolve multi-GT anchors: keep the GT with the highest IoU
    masked_iou = torch.where(is_topk, ious, -1.0)
    best_gt = torch.argmax(masked_iou, dim=-1)
    fg = is_topk.any(dim=-1)
    # the final (A,G) positive mask after the multi-GT resolution: the
    # candidate set the soft-target normalizers reduce over
    pos_mask = is_topk & fg[..., None] & (
        best_gt[..., None] == torch.arange(g, device=best_gt.device))
    return best_gt, fg, align, ious, pos_mask


def detection_loss(model: yolov8.YOLOv8, images: torch.Tensor, gt_boxes: torch.Tensor,
                   gt_cls: torch.Tensor, gt_mask: torch.Tensor, spec: yolov8.ModelSpec,
                   box_gain: float = 7.5, cls_gain: float = 0.5, dfl_gain: float = 1.5):
    """Batched loss. images (B,H,W,3); gt_boxes (B,G,4) xywh px; gt_cls
    (B,G) int; gt_mask (B,G) bool. Returns (scalar loss, metrics dict with
    loss, box, cls, dfl and fg)."""
    feats = yolov8.forward_features(model, images, spec)
    raw = yolov8.detect_head(model.layers[str(spec.head_index)], feats, spec)  # (B,A,4R+C)
    feat_shapes = [(f.shape[1], f.shape[2]) for f in feats]
    anchors, strides = yolov8.make_anchors(feat_shapes, spec.strides, device=images.device)
    boxes_xywh, probs = yolov8.decode_boxes(raw, anchors, strides, spec)
    boxes_xyxy = xywh_to_xyxy(boxes_xywh)
    anchors_px = anchors * strides[:, None]
    reg_max = spec.reg_max
    reg = raw[..., : 4 * reg_max]
    cls_logits = raw[..., 4 * reg_max:]

    best_gt, fg, align, ious, pos_mask = task_aligned_assign(
        probs, boxes_xyxy, anchors_px, gt_boxes, gt_cls, gt_mask)
    b, a, c = probs.shape
    g = gt_boxes.shape[1]
    gt_xyxy = xywh_to_xyxy(gt_boxes)
    tgt_boxes = torch.gather(gt_xyxy, 1, best_gt[..., None].expand(b, a, 4))  # (B,A,4)
    tgt_cls = torch.gather(gt_cls.long(), 1, best_gt)

    # normalized soft cls targets (TAL): align / max_align * max_iou per GT,
    # both maxima over the GT's assigned candidates
    pos_align = torch.where(fg, torch.gather(align, 2, best_gt[..., None])[..., 0], 0.0)
    gt_max_align = torch.amax(torch.where(pos_mask, align, 0.0), dim=1)  # (B,G)
    gt_max_iou = torch.amax(torch.where(pos_mask, ious, 0.0), dim=1)
    norm = torch.gather(gt_max_iou, 1, best_gt) / clip(torch.gather(gt_max_align, 1, best_gt), 1e-9)
    soft_tgt = clip(pos_align * norm, 0.0, 1.0)  # (B,A)

    # one-hot as jax.nn.one_hot: a class outside 0..C-1 gives a zero row
    onehot = (tgt_cls[..., None] == torch.arange(c, device=tgt_cls.device)).to(probs.dtype)
    onehot = torch.where(fg[..., None], onehot * soft_tgt[..., None], 0.0)
    one = _scalar(1.0)
    bce = torch.mean(
        torch.sum(clip(cls_logits, 0.0) - cls_logits * onehot
                  + torch.log1p(torch.exp(-torch.abs(cls_logits))), dim=-1),
        dim=-1,
    ) * a / torch.maximum(soft_tgt.sum(-1), one)

    weight = soft_tgt
    box_l = torch.where(fg, (1.0 - ciou(boxes_xyxy, tgt_boxes)) * weight, 0.0)
    box_loss = box_l.sum(-1) / torch.maximum(weight.sum(-1), one)

    # DFL: target ltrb distances in stride units, two-bin soft labels
    tgt_lt = (anchors_px - tgt_boxes[..., :2]) / strides[:, None]
    tgt_rb = (tgt_boxes[..., 2:] - anchors_px) / strides[:, None]
    tgt_dist = clip(torch.cat([tgt_lt, tgt_rb], dim=-1), 0.0, reg_max - 1.01)  # (B,A,4)
    low = torch.floor(tgt_dist)
    w_high = tgt_dist - low
    logp = torch.log_softmax(reg.reshape(b, a, 4, reg_max), dim=-1)
    idx_low = low.long()
    lp_low = torch.gather(logp, -1, idx_low[..., None])[..., 0]
    lp_high = torch.gather(logp, -1, (idx_low + 1).clamp(0, reg_max - 1)[..., None])[..., 0]
    dfl = -(lp_low * (1 - w_high) + lp_high * w_high).mean(dim=-1)
    dfl_loss = torch.where(fg, dfl * weight, 0.0).sum(-1) / torch.maximum(weight.sum(-1), one)

    loss = box_gain * box_loss.mean() + cls_gain * bce.mean() + dfl_gain * dfl_loss.mean()
    metrics = {"loss": loss, "box": box_loss.mean(), "cls": bce.mean(),
               "dfl": dfl_loss.mean(), "fg": fg.sum()}
    return loss, metrics
