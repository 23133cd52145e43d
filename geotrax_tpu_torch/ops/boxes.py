"""Bounding-box format conversion and IoU matrices.

Boxes flow through the pipeline as (cx, cy, w, h), with conversion helpers to
corner form for IoU and NMS. Counterpart of ``geotrax_tpu/ops/boxes.py``.
"""

from __future__ import annotations

import torch


def xywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 4) center form -> corner form."""
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)


def xyxy_to_xywh(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 4) corner form -> center form."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], dim=-1)


# a 0-dim CPU tensor is a scalar operand of a binary op on any device
_ZERO = torch.tensor(0.0)


def box_area(boxes_xyxy: torch.Tensor) -> torch.Tensor:
    # torch.maximum, not clamp_min: at a tie JAX's maximum gives each side
    # half the gradient, and the training loss differentiates through IoUs
    w = torch.maximum(boxes_xyxy[..., 2] - boxes_xyxy[..., 0], _ZERO)
    h = torch.maximum(boxes_xyxy[..., 3] - boxes_xyxy[..., 1], _ZERO)
    return w * h


def iou_matrix(a_xyxy: torch.Tensor, b_xyxy: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """Pairwise IoU of (..., N, 4) x (..., M, 4) corner boxes -> (..., N, M)."""
    lt = torch.maximum(a_xyxy[..., :, None, :2], b_xyxy[..., None, :, :2])
    rb = torch.minimum(a_xyxy[..., :, None, 2:], b_xyxy[..., None, :, 2:])
    wh = torch.maximum(rb - lt, _ZERO)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a_xyxy)[..., :, None] + box_area(b_xyxy)[..., None, :] - inter
    return inter / (union + eps)


def hmiou_matrix(a_xyxy: torch.Tensor, b_xyxy: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """Height-Modulated IoU (TrackTrack cost term): IoU scaled by the overlap
    ratio of the vertical extents."""
    iou = iou_matrix(a_xyxy, b_xyxy, eps)
    y1 = torch.maximum(a_xyxy[..., :, None, 1], b_xyxy[..., None, :, 1])
    y2 = torch.minimum(a_xyxy[..., :, None, 3], b_xyxy[..., None, :, 3])
    inter_h = torch.clamp_min(y2 - y1, 0.0)
    uy1 = torch.minimum(a_xyxy[..., :, None, 1], b_xyxy[..., None, :, 1])
    uy2 = torch.maximum(a_xyxy[..., :, None, 3], b_xyxy[..., None, :, 3])
    union_h = torch.clamp_min(uy2 - uy1, eps)
    return iou * inter_h / union_h
