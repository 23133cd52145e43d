"""Spatial frame tiling: detection over overlapping vertical tiles.

The port's copy of ``geotrax_tpu/parallel/tiling.py`` for one card
(``ultralytics.tiles`` / ``extract --tiles``): a frame is split into T
overlapping vertical tiles of one width, each tile is letterboxed to
``imgsz`` (so T tiles see the scene at about T/2 the default scale, the
small-object lever at 4K), and the per-tile detections are merged into one
set: x offsets, then one fixed-shape NMS over all tiles that keeps a single
box for an object seen by two neighbours. The C x T tiles of a chunk run as
one batch (``tiled_batch_trace``, the extract path); ``make_tiled_detector``
detects on one frame with the tile axis spread over several devices, as the
reference's shards it over a mesh.
"""

from __future__ import annotations

import numpy as np
import torch

from geotrax_tpu_torch.models import yolov8
from geotrax_tpu_torch.ops.boxes import xywh_to_xyxy
from geotrax_tpu_torch.ops.nms import nms, postprocess_detections
from geotrax_tpu_torch.parallel.mesh import replica


def tile_geometry(width: int, n_tiles: int, overlap: int) -> list[tuple[int, int]]:
    """[(x0, tile_width)] covering [0, width) with ``overlap`` px shared on
    each interior boundary; all tiles the same width."""
    core = int(np.ceil(width / n_tiles))
    tw = min(core + 2 * overlap, width)
    return [(min(max(i * core - overlap, 0), width - tw), tw) for i in range(n_tiles)]


def _merge(boxes, scores, classes, iou: float, max_det: int, agnostic: bool) -> dict:
    """(B, N, ...) candidates in frame coordinates -> (B, max_det, ...)
    detections after one NMS per frame."""
    keep, valid = nms(xywh_to_xyxy(boxes), scores, iou, max_det, class_ids=classes,
                      agnostic=agnostic)
    b = keep.shape[0]
    kept_boxes = torch.gather(boxes, 1, keep[..., None].expand(b, max_det, 4))
    return {
        "boxes_xywh": torch.where(valid[..., None], kept_boxes, 0.0),
        "scores": torch.where(valid, torch.gather(scores, 1, keep), 0.0),
        "classes": torch.where(valid, torch.gather(classes, 1, keep), -1),
        "valid": valid,
    }


def make_tiled_detector(model: yolov8.YOLOv8, spec: yolov8.ModelSpec, n_tiles: int, src_h: int,
                        src_w: int, imgsz: int = 1920, conf: float = 0.25, iou: float = 0.7,
                        max_det: int = 1000, overlap: int = 128, devices=None):
    """``run(frame_u8 (H,W,3))`` -> fixed-slot detections of one frame: each
    tile letterboxed, through the detector and a class-agnostic NMS keeping
    ``max_det // 2``; then x offsets and one global NMS over all tiles on
    the first device, so that an object seen by two neighbours keeps one
    box. With ``devices`` (a list of torch devices; one may repeat), tile i
    runs on ``devices[i % D]`` with a replica of the weights there, where
    the reference shards the tile axis over its mesh's 'data' axis; without,
    every tile runs on the model's device.

    Each tile is its own forward on every path: convolution libraries pick
    their kernels by batch size, so a batch of T tiles and T batches of one
    can differ in the last bits, and a tile's detections would then depend
    on how the tiles were spread."""
    geom = tile_geometry(src_w, n_tiles, overlap)
    tw = geom[0][1]
    out_h, out_w, r, top, left = yolov8.letterbox_shape(src_h, tw, imgsz)
    new_h, new_w = round(src_h * r), round(tw * r)
    per_tile = max_det // 2
    devices = [torch.device(d) for d in devices] if devices else None
    copies: dict = {}

    def detect(dev, tile_u8):
        m = replica(model, dev, copies)
        imgs = yolov8.letterbox(tile_u8[None].to(dev), out_h, out_w, new_h, new_w, top, left)
        boxes, probs = yolov8.forward(m, imgs, spec)
        # global coordinates (x offsets up to src_w) need float32 past a
        # bfloat16 checkpoint's forward
        return postprocess_detections(boxes.float(), probs.float(), conf, iou, per_tile,
                                      agnostic=True)

    def run(frame_u8):
        home = devices or [next(model.parameters()).device]
        with torch.no_grad():
            per = [detect(home[i % len(home)], frame_u8[:, x0:x0 + tw])
                   for i, (x0, _) in enumerate(geom)]
        det = {k: torch.cat([p[k].to(home[0]) for p in per]) for k in per[0]}
        offsets = torch.tensor([float(x0) for x0, _ in geom], device=home[0])
        tile_boxes = yolov8.unletterbox_boxes(det["boxes_xywh"], r, top, left)
        tile_boxes = torch.cat([tile_boxes[..., :1] + offsets[:, None, None],
                                tile_boxes[..., 1:]], dim=-1)
        scores = torch.where(det["valid"], det["scores"], 0.0)
        out = _merge(tile_boxes.reshape(1, -1, 4), scores.reshape(1, -1),
                     det["classes"].reshape(1, -1), iou, max_det, agnostic=True)
        return {k: v[0] for k, v in out.items()}

    return run


def tiled_batch_trace(model: yolov8.YOLOv8, spec: yolov8.ModelSpec, n_tiles: int, src_h: int,
                      src_w: int, imgsz: int = 1920, conf: float = 0.25, iou: float = 0.7,
                      max_det: int = 1000, overlap: int = 128, class_mask=None,
                      agnostic: bool = True, half: bool = False):
    """``run(frames_u8 (C,H,W,3), fids=None)`` -> the fixed-slot detection
    dict of the whole-frame path, from all C*T tiles in one forward: each
    tile keeps ``max_det // 2`` detections, the merge ``max_det``."""
    geom = tile_geometry(src_w, n_tiles, overlap)
    tw = geom[0][1]
    out_h, out_w, r, top, left = yolov8.letterbox_shape(src_h, tw, imgsz)
    new_h, new_w = round(src_h * r), round(tw * r)
    per_tile = max_det // 2

    def run(frames_u8, fids=None):
        c = frames_u8.shape[0]
        tiles = torch.cat([frames_u8[:, :, x0:x0 + tw] for x0, _ in geom])  # (T*C,H,tw,3)
        imgs = yolov8.letterbox(tiles, out_h, out_w, new_h, new_w, top, left)
        if half:
            imgs = imgs.to(torch.bfloat16)
        with torch.no_grad():
            boxes, probs = yolov8.forward(model, imgs, spec)
            det = postprocess_detections(boxes.float(), probs.float(), conf, iou, per_tile,
                                         class_mask=class_mask, agnostic=agnostic)
        offsets = torch.tensor([float(x0) for x0, _ in geom], device=frames_u8.device)
        tile_boxes = yolov8.unletterbox_boxes(det["boxes_xywh"], r, top, left)
        tile_boxes = tile_boxes.reshape(n_tiles, c, per_tile, 4)
        tile_boxes = torch.cat([tile_boxes[..., :1] + offsets[:, None, None, None],
                                tile_boxes[..., 1:]], dim=-1)

        def per_frame(x, width):  # (T*C, K, ...) -> (C, T*K, ...)
            return x.reshape((n_tiles, c, per_tile) + width).transpose(0, 1).reshape(
                (c, n_tiles * per_tile) + width)

        scores = torch.where(det["valid"], det["scores"], 0.0)
        return _merge(per_frame(tile_boxes, (4,)), per_frame(scores, ()),
                      per_frame(det["classes"], ()), iou, max_det, agnostic)

    return run


def merge_tile_detections(tile_dets: dict, x_offsets, iou: float, max_det: int) -> dict:
    """Offset + one class-agnostic NMS over a (T, K, ...) per-tile detection
    dict -> (max_det, ...) detections."""
    offsets = torch.as_tensor(np.asarray(x_offsets, np.float32),
                              device=tile_dets["boxes_xywh"].device)
    boxes = tile_dets["boxes_xywh"]
    boxes = torch.cat([boxes[..., :1] + offsets[:, None, None], boxes[..., 1:]], dim=-1)
    scores = torch.where(tile_dets["valid"], tile_dets["scores"], 0.0)
    out = _merge(boxes.reshape(1, -1, 4), scores.reshape(1, -1),
                 tile_dets["classes"].reshape(1, -1), iou, max_det, agnostic=True)
    return {k: v[0] for k, v in out.items()}
