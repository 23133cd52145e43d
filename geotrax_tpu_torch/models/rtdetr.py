"""The native RT-DETR-class detector (``.npz``), in PyTorch.

Counterpart of ``geotrax_tpu/models/rtdetr.py``: YOLOv8 backbone features
(the port's ``yolov8.forward_features``), a 1x1 projection of each level to
the hidden width, one AIFI-style encoder layer on the P5 tokens, query
selection of the top tokens by class logit, and a deformable-attention
decoder with iterative box refinement; NMS-free. ``init_params`` of the
reference or a ``.npz`` written by its ``save_npz`` loads through
``params_from_jax``. ``detr_loss`` is the reference's set-prediction
loss; ``model.requires_grad_(True)`` makes the parameters trainable.

With ``half`` the whole model is cast to bfloat16, as the reference casts
every float leaf: the backbone runs the YOLOv8 port's bfloat16 path, the
projections multiply bfloat16 features and weights with float32 results,
and everything after them runs in float32 on the bfloat16 weights' values
(the reference's float32 activations promote its bfloat16 weights).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from geotrax_tpu_torch._device import resolve_device
from geotrax_tpu_torch.models import yolov8
from geotrax_tpu_torch.models.loss import clip, ciou
from geotrax_tpu_torch.models.rtdetr_ul import ParamTree
from geotrax_tpu_torch.ops.assignment import masked_assignment
from geotrax_tpu_torch.ops.boxes import xywh_to_xyxy
from geotrax_tpu_torch.ops.topk import exact_top_k


class RTDETRSpec(NamedTuple):
    variant: str = "s"        # backbone variant (yolov8 scaling)
    nc: int = 4
    hidden: int = 256
    num_queries: int = 300
    num_decoder_layers: int = 4
    num_heads: int = 8
    num_points: int = 4       # deformable sampling points per level/head
    reg_max: int = 16         # unused (direct box regression); kept for API parity

    @property
    def strides(self):
        return (8, 16, 32)


class RTDETR(nn.Module):
    """The YOLOv8 backbone (``backbone``) and the rest (``p``, a
    ``ParamTree`` of the reference's keys)."""

    def __init__(self, tree: dict, spec: RTDETRSpec):
        super().__init__()
        self.spec = spec
        self.backbone = yolov8.params_from_jax({"layers": tree["backbone"]},
                                               _backbone_spec(spec), device="cpu")
        self.p = ParamTree({k: v for k, v in tree.items() if k != "backbone"})

    def forward(self, images: torch.Tensor):
        return forward(self, images, self.spec)


def _backbone_spec(spec: RTDETRSpec) -> yolov8.ModelSpec:
    return yolov8.ModelSpec(variant=spec.variant, nc=spec.nc)


def params_from_jax(tree: dict, spec: RTDETRSpec, device="cuda") -> RTDETR:
    """The nested numpy tree of the reference's ``init_params`` (lists
    restored, as ``convert._restore_lists`` does for a ``.npz``) as an
    ``RTDETR`` on ``device``."""
    dev = resolve_device(device)
    return RTDETR(tree, spec).to(dev).eval()


# ---------------------------------------------------------------------------
# blocks (float32 on the weights' values)
# ---------------------------------------------------------------------------

def _linear(p, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"].float() + p["b"].float()


def _layer_norm(x: torch.Tensor, p, eps: float = 1e-5) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * p["scale"].float() + p["bias"].float()


def _mha(p, q, k, v, num_heads: int) -> torch.Tensor:
    b, nq, d = q.shape
    dh = d // num_heads

    def split(x):
        return x.reshape(b, -1, num_heads, dh).transpose(1, 2)

    qh, kh, vh = split(_linear(p["q"], q)), split(_linear(p["k"], k)), split(_linear(p["v"], v))
    attn = torch.softmax(qh @ kh.transpose(-1, -2) / math.sqrt(dh), dim=-1)
    return _linear(p["o"], (attn @ vh).transpose(1, 2).reshape(b, nq, d))


def _ffn(p, x: torch.Tensor) -> torch.Tensor:
    return _linear(p["fc2"], F.relu(_linear(p["fc1"], x)))


def _mlp3(p, x: torch.Tensor) -> torch.Tensor:
    return _linear(p["out"], F.relu(_ffn(p, x)))


def _bilinear_sample(value: torch.Tensor, x: torch.Tensor, y: torch.Tensor, h: int, w: int):
    """Bilinear samples of ``value`` (N, H*W, dh) at pixel coordinates
    ``x``, ``y`` (N, P), the taps clamped to the map's edge (the
    reference's ``_bilinear_sample``) -> (N, P, dh)."""
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = x0.to(torch.int64).clamp(0, w - 1)
    x1i = (x0i + 1).clamp(0, w - 1)
    y0i = y0.to(torch.int64).clamp(0, h - 1)
    y1i = (y0i + 1).clamp(0, h - 1)
    dh = value.shape[-1]

    def tap(yi, xi):
        return torch.gather(value, 1, (yi * w + xi)[..., None].expand(-1, -1, dh))

    return (tap(y0i, x0i) * (1 - fx) * (1 - fy) + tap(y0i, x1i) * fx * (1 - fy)
            + tap(y1i, x0i) * (1 - fx) * fy + tap(y1i, x1i) * fx * fy)


def _deform_attn(p, queries, ref_points, level_feats, spec: RTDETRSpec):
    """queries (B,Q,D); ref_points (B,Q,2) normalized; level_feats (B,H,W,D)
    maps. Multi-scale deformable attention."""
    b, nq, d = queries.shape
    n_levels = len(level_feats)
    heads, pts = spec.num_heads, spec.num_points
    dh = d // heads
    offsets = _linear(p["offsets"], queries).reshape(b, nq, heads, n_levels, pts, 2)
    weights = torch.softmax(
        _linear(p["weights"], queries).reshape(b, nq, heads, n_levels * pts), dim=-1
    ).reshape(b, nq, heads, n_levels, pts)

    out = torch.zeros((b, nq, heads, dh), dtype=torch.float32, device=queries.device)
    for li, feat in enumerate(level_feats):
        h, w = feat.shape[1], feat.shape[2]
        value = _linear(p["value"], feat).reshape(b, h * w, heads, dh)
        value = value.transpose(1, 2).reshape(b * heads, h * w, dh)
        scale = torch.tensor([1.0 / w, 1.0 / h], dtype=torch.float32, device=queries.device)
        loc = ref_points[:, :, None, None, :] + offsets[:, :, :, li] * scale   # (B,Q,Hd,P,2)
        x = loc[..., 0] * w - 0.5
        y = loc[..., 1] * h - 0.5
        x = x.permute(0, 2, 1, 3).reshape(b * heads, nq * pts)
        y = y.permute(0, 2, 1, 3).reshape(b * heads, nq * pts)
        sampled = _bilinear_sample(value, x, y, h, w).reshape(b, heads, nq, pts, dh)
        out = out + torch.sum(sampled.permute(0, 2, 1, 3, 4) * weights[:, :, :, li, :, None], dim=3)
    return _linear(p["out"], out.reshape(b, nq, d))


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def forward(model: RTDETR, images: torch.Tensor, spec: RTDETRSpec):
    """(B,H,W,3) images in [0,1] (bfloat16 with a bfloat16 model) ->
    (boxes_xywh px (B,Q,4), class_probs (B,Q,nc)), float32. NMS-free."""
    feats = yolov8.forward_features(model.backbone, images, _backbone_spec(spec))
    return forward_head(model, feats, images.shape[1], images.shape[2], spec)


def forward_head(model: RTDETR, feats, img_h: int, img_w: int, spec: RTDETRSpec):
    """Everything after the backbone: NHWC [P3, P4, P5] features (bfloat16
    with a bfloat16 model) of an img_h x img_w input -> (boxes_xywh px,
    class_probs), float32."""
    p = model.p
    dev = feats[0].device

    projected = []
    for proj, f in zip(p["proj"], feats):
        w = proj["w"].float()
        y = F.conv2d(f.permute(0, 3, 1, 2).float(), w) + proj["b"].float()[:, None, None]
        projected.append(y.permute(0, 2, 3, 1))

    # AIFI on the P5 tokens
    b, h5, w5, d = projected[2].shape
    tokens = projected[2].reshape(b, h5 * w5, d)
    a = p["aifi"]
    tokens = _layer_norm(tokens + _mha(a["attn"], tokens, tokens, tokens, spec.num_heads), a["ln1"])
    tokens = _layer_norm(tokens + _ffn(a["ffn"], tokens), a["ln2"])
    projected[2] = tokens.reshape(b, h5, w5, d)

    # memory: all levels flattened, with each token's normalized centre
    mem_tokens, mem_centers = [], []
    for f in projected:
        hh, ww = f.shape[1], f.shape[2]
        mem_tokens.append(f.reshape(b, hh * ww, d))
        ys, xs = np.mgrid[0:hh, 0:ww]
        centers = np.stack([(xs + 0.5) / ww, (ys + 0.5) / hh], -1).reshape(-1, 2)
        mem_centers.append(torch.as_tensor(centers.astype(np.float32), device=dev))
    memory = torch.cat(mem_tokens, dim=1)
    centers = torch.cat(mem_centers, dim=0)

    # query selection: the top tokens by their largest class logit
    enc_logits = _linear(p["enc_score"], memory)
    enc_boxes = torch.sigmoid(_mlp3(p["enc_box"], memory)
                              + torch.cat([centers, torch.zeros_like(centers)], -1)[None])
    num_queries = min(spec.num_queries, enc_logits.shape[1])
    _, top_idx = exact_top_k(enc_logits.amax(dim=-1), num_queries)
    queries = torch.gather(memory, 1, top_idx[..., None].expand(-1, -1, d))
    ref_boxes = torch.gather(enc_boxes, 1, top_idx[..., None].expand(-1, -1, 4))

    for layer in p["layers"]:
        pos = _mlp3(p["query_pos"], ref_boxes)
        q = queries + pos
        queries = _layer_norm(
            queries + _mha(layer["self_attn"], q, q, queries, spec.num_heads), layer["ln1"])
        cross = _deform_attn(layer["cross"], queries + pos, ref_boxes[..., :2], projected, spec)
        queries = _layer_norm(queries + cross, layer["ln2"])
        queries = _layer_norm(queries + _ffn(layer["ffn"], queries), layer["ln3"])
        delta = _mlp3(layer["refine"], queries)
        rb = clip(ref_boxes, 1e-5, 1.0 - 1e-5)
        ref_boxes = torch.sigmoid(delta + torch.log(rb / (1.0 - rb)))

    probs = torch.sigmoid(_linear(p["cls_head"], queries))
    scale = torch.tensor([img_w, img_h, img_w, img_h], dtype=torch.float32, device=dev)
    return ref_boxes * scale, probs


# ---------------------------------------------------------------------------
# set-prediction loss (auction-based bipartite matching)
# ---------------------------------------------------------------------------

def detr_loss(model: RTDETR, images: torch.Tensor, gt_boxes: torch.Tensor, gt_cls: torch.Tensor,
              gt_mask: torch.Tensor, spec: RTDETRSpec, cls_gain: float = 1.0,
              l1_gain: float = 5.0, giou_gain: float = 2.0):
    """The reference's Hungarian-matched DETR loss, batched over images:
    each GT (row) gets its best query (column) through the auction
    (``ops/assignment.py:masked_assignment`` on the transposed, clipped
    cost, threshold 30); the matching carries no gradient. images
    (B,H,W,3); gt_boxes (B,G,4) xywh px; gt_cls (B,G); gt_mask (B,G).
    Returns (scalar loss, metrics with loss, cls, l1 and giou)."""
    boxes, probs = forward(model, images, spec)   # (B,Q,4) px, (B,Q,C)
    b, nq, nc = probs.shape
    g = gt_boxes.shape[1]
    img_h, img_w = images.shape[1], images.shape[2]
    norm = torch.tensor([img_w, img_h, img_w, img_h], dtype=torch.float32, device=boxes.device)
    gt_cls = gt_cls.long()

    with torch.no_grad():
        cls_idx = gt_cls.clamp(0, nc - 1)[:, None, :].expand(b, nq, g)
        cls_cost = -torch.gather(probs, 2, cls_idx)                                  # (B,Q,G)
        l1_cost = torch.abs(boxes[:, :, None] / norm - gt_boxes[:, None] / norm).sum(-1)
        iou_cost = 1.0 - ciou(xywh_to_xyxy(boxes)[:, :, None].expand(b, nq, g, 4),
                              xywh_to_xyxy(gt_boxes)[:, None].expand(b, nq, g, 4))
        cost = clip(cls_gain * cls_cost + l1_gain * l1_cost + giou_gain * iou_cost,
                     -20.0, 20.0)
        col, matched = masked_assignment(cost.transpose(1, 2), gt_mask,
                                         torch.ones((b, nq), dtype=torch.bool,
                                                    device=boxes.device), threshold=30.0)
    safe_col = col.clamp(0, nq - 1)

    # classification: matched queries get their GT class, the rest background;
    # unmatched GT rows write nothing (the reference scatters at the
    # unclipped index with mode="drop")
    onehot = (gt_cls[..., None] == torch.arange(nc, device=gt_cls.device)).to(probs.dtype)
    bi, gi = matched.nonzero(as_tuple=True)
    target = torch.zeros((b, nq, nc), dtype=probs.dtype, device=probs.device)
    target[bi, col[bi, gi]] = onehot[bi, gi]
    bce = -(target * torch.log(probs + 1e-8)
            + (1 - target) * torch.log(1 - probs + 1e-8)).mean(dim=(1, 2))

    mb = torch.gather(boxes, 1, safe_col[..., None].expand(b, g, 4))             # (B,G,4)
    l1 = torch.where(matched[..., None], torch.abs(mb / norm - gt_boxes / norm), 0.0).sum((1, 2))
    giou = torch.where(matched, 1.0 - ciou(xywh_to_xyxy(mb), xywh_to_xyxy(gt_boxes)), 0.0).sum(1)
    denom = matched.sum(1).clamp_min(1)
    l1, giou = l1 / denom, giou / denom
    loss = cls_gain * bce.mean() + l1_gain * l1.mean() + giou_gain * giou.mean()
    return loss, {"loss": loss, "cls": bce.mean(), "l1": l1.mean(), "giou": giou.mean()}
