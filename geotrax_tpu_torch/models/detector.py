"""Host-facing detector: YOLOv8 (letterbox, forward, NMS) or RT-DETR
(square stretch, forward, top-k), batched or one frame at a time.

Counterpart of ``geotrax_tpu/models/detector.py``: built from a checkpoint
(``.pt`` or ``.npz``, ``models/convert.py``) or from a model made in memory
(``yolov8.init_params`` / ``params_from_jax``, ``rtdetr_ul.init_params``,
``rtdetr.params_from_jax``), with the reference's config surface:
``imgsz``, ``conf``, ``iou``, ``max_det``, ``agnostic_nms``, ``classes``,
``half`` (bfloat16 weights and activations, float32 post-processing) and
``tiles`` / ``tile_overlap`` (``parallel/tiling.py``, YOLOv8 only). A path
whose name contains ``rtdetr`` is an RT-DETR checkpoint, as in the
reference: a ``.pt`` the ultralytics rtdetr-l graph, a ``.npz`` the native
family. Every call returns ``(max_det,)``-slot dicts (``boxes_xywh``,
``scores``, ``classes``, ``valid``) on the detector's device.
"""

from __future__ import annotations

import copy
from pathlib import Path

import numpy as np
import torch

from geotrax_tpu_torch._device import resolve_device
from geotrax_tpu_torch.models import rtdetr, rtdetr_ul, yolov8
from geotrax_tpu_torch.ops.nms import postprocess_detections
from geotrax_tpu_torch.ops.resize import resize_u8_linear
from geotrax_tpu_torch.ops.topk import exact_top_k

_INV_255 = float(np.float32(1.0) / np.float32(255.0))


class Detector:
    """YOLOv8 + NMS, or NMS-free RT-DETR, over frames. ``model`` is a
    ``YOLOv8``, an ``RTDETRL``, an ``RTDETR`` or the path of a checkpoint,
    whose class names then replace ``class_names``."""

    def __init__(self, model, detect_cfg: dict, class_names=None, logger=None, device="cuda"):
        self.device = resolve_device(device)
        self.imgsz = int(detect_cfg.get("imgsz", 1920) or 1920)
        self.conf = float(detect_cfg.get("conf", 0.25) or 0.25)
        self.iou = float(detect_cfg.get("iou", 0.7) or 0.7)
        self.max_det = int(detect_cfg.get("max_det", 1000) or 1000)
        self.agnostic = bool(detect_cfg.get("agnostic_nms", True))
        self.half = bool(detect_cfg.get("half", False))
        self.tiles = int(detect_cfg.get("tiles", 1) or 1)
        self.tile_overlap = int(detect_cfg.get("tile_overlap", 128) or 128)
        if isinstance(model, (str, Path)):
            from geotrax_tpu_torch.models.convert import load_model, load_rtdetr

            load = load_rtdetr if "rtdetr" in str(model).lower() else load_model
            model, _, names = load(model)
            class_names = names or class_names
        elif self.half:
            model = copy.deepcopy(model)  # the cast below must not touch the caller's model
        self.is_ul_rtdetr = isinstance(model, rtdetr_ul.RTDETRL)
        self.is_rtdetr = self.is_ul_rtdetr or isinstance(model, rtdetr.RTDETR)
        if self.is_ul_rtdetr and self.half:
            raise ValueError(
                "half is not supported for the rtdetr-l graph: the reference's bfloat16 rtdetr-l "
                "does not run (its float32 convolution results meet bfloat16 weights; ROADMAP C6)")
        if self.is_rtdetr and self.tiles > 1:
            if logger:
                logger.warning("Spatial tiling is not supported for RT-DETR; ignored.")
            self.tiles = 1
        self.model = model.to(self.device).eval()
        if self.half:
            self.model = self.model.to(torch.bfloat16)
        self.spec = model.spec
        self.class_names = class_names or {0: "car", 1: "bus", 2: "truck", 3: "motorcycle"}
        classes = detect_cfg.get("classes")
        self.class_mask = None
        if classes is not None:
            ids = np.asarray(classes, int)
            in_range = ids[(ids >= 0) & (ids < self.spec.nc)]
            if logger and len(in_range) < len(ids):
                logger.warning(
                    f"Class filter {sorted(set(ids.tolist()) - set(in_range.tolist()))} "
                    f"outside model range (nc={self.spec.nc}); ignored."
                )
            if len(in_range) and len(in_range) < self.spec.nc:
                mask = np.zeros((self.spec.nc,), bool)
                mask[in_range] = True
                self.class_mask = torch.as_tensor(mask, device=self.device)
        if logger:
            if self.is_ul_rtdetr:
                logger.info(f"Detector: ultralytics rtdetr-l nc={self.spec.nc} (NMS-free)")
            elif self.is_rtdetr:
                logger.info(f"Detector: rtdetr-{self.spec.variant} nc={self.spec.nc} (NMS-free)")
            else:
                logger.info(
                    f"Detector: yolov8{self.spec.variant} nc={self.spec.nc} "
                    f"imgsz={self.imgsz} conf={self.conf} iou={self.iou} max_det={self.max_det}"
                )

    def resize_geometry(self, src_h: int, src_w: int):
        """(new_h, new_w, r, top, left, out_h, out_w) of the letterbox resize
        for a source resolution, or None where there is no shared resize
        (tiles, RT-DETR)."""
        if self.tiles > 1 or self.is_rtdetr:
            return None
        out_h, out_w, r, top, left = yolov8.letterbox_shape(src_h, src_w, self.imgsz)
        return round(src_h * r), round(src_w * r), r, top, left, out_h, out_w

    def _detect_letterboxed(self, imgs: torch.Tensor, r: float, top: int, left: int) -> dict:
        if self.half:
            imgs = imgs.to(torch.bfloat16)
        with torch.no_grad():
            boxes, probs = yolov8.forward(self.model, imgs, self.spec)
            det = postprocess_detections(
                boxes, probs, self.conf, self.iou, self.max_det,
                class_mask=self.class_mask, agnostic=self.agnostic,
            )
        det["boxes_xywh"] = yolov8.unletterbox_boxes(det["boxes_xywh"], r, top, left)
        return det

    def batch_trace_resized(self, src_h: int, src_w: int):
        """A function of ALREADY-RESIZED (C,new_h,new_w,3) uint8 frames (the
        fused chunk runs the cv2-exact resize itself, so one pass over the 4K
        frame feeds both detection and the stabilization gray) -> dict of
        (C, max_det, ...) detections in source pixels; None with tiles."""
        geom = self.resize_geometry(src_h, src_w)
        if geom is None:
            return None
        new_h, new_w, r, top, left, out_h, out_w = geom

        def run(resized_u8, fids=None):
            imgs = yolov8.letterbox_pad(resized_u8, out_h, out_w, top, left)
            return self._detect_letterboxed(imgs, r, top, left)

        return run

    def batch_trace(self, src_h: int, src_w: int):
        """YOLOv8 detection on full (C,H,W,3) uint8 frames: the letterbox
        (resize and padding) inside, or the tiled detector with ``tiles`` > 1."""
        if self.tiles > 1:
            from geotrax_tpu_torch.parallel.tiling import tiled_batch_trace

            return tiled_batch_trace(
                self.model, self.spec, self.tiles, src_h, src_w, imgsz=self.imgsz,
                conf=self.conf, iou=self.iou, max_det=self.max_det, overlap=self.tile_overlap,
                class_mask=self.class_mask, agnostic=self.agnostic, half=self.half,
            )
        new_h, new_w, r, top, left, out_h, out_w = self.resize_geometry(src_h, src_w)

        def run(frames_u8, fids=None):
            imgs = yolov8.letterbox(frames_u8, out_h, out_w, new_h, new_w, top, left)
            return self._detect_letterboxed(imgs, r, top, left)

        return run

    def _rtdetr_detect(self, frames_u8: torch.Tensor) -> dict:
        """RT-DETR on (B,H,W,3) uint8 frames: the square stretch to imgsz x
        imgsz (ultralytics' RTDETRPredictor, not a letterbox), the forward,
        the class mask, score = largest probability, class = its index, the
        top ``max_det`` queries (invalid slots past the query count) and
        ``valid = score >= conf``; boxes un-stretched to source pixels."""
        src_h, src_w = frames_u8.shape[1], frames_u8.shape[2]
        imgs = resize_u8_linear(frames_u8, self.imgsz, self.imgsz).to(torch.float32) * _INV_255
        if self.half:
            imgs = imgs.to(torch.bfloat16)
        forward = rtdetr_ul.forward if self.is_ul_rtdetr else rtdetr.forward
        with torch.no_grad():
            boxes, probs = forward(self.model, imgs, self.spec)
        boxes, probs = boxes.float(), probs.float()
        if self.class_mask is not None:
            probs = torch.where(self.class_mask, probs, 0.0)
        scores, classes = probs.amax(dim=-1), probs.argmax(dim=-1)
        k = min(self.max_det, scores.shape[-1])
        top_scores, idx = exact_top_k(scores, k)
        sx, sy = src_w / self.imgsz, src_h / self.imgsz
        unstretch = torch.tensor([sx, sy, sx, sy], dtype=torch.float32, device=boxes.device)
        det_boxes = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4)) * unstretch
        pad = self.max_det - k
        return {
            "boxes_xywh": torch.nn.functional.pad(det_boxes, (0, 0, 0, pad)),
            "scores": torch.nn.functional.pad(top_scores, (0, pad)),
            "classes": torch.nn.functional.pad(torch.gather(classes, 1, idx), (0, pad), value=-1),
            "valid": torch.nn.functional.pad(top_scores >= self.conf, (0, pad)),
        }

    def _frames(self, frames) -> torch.Tensor:
        return torch.as_tensor(frames).to(self.device)

    def detect_batch(self, frames_rgb_u8) -> dict:
        """Detection on (B,H,W,3) uint8 frames (numpy or a tensor, on the
        host or the card) -> dict of (B, max_det, ...) tensors."""
        frames = self._frames(frames_rgb_u8)
        if self.is_rtdetr:
            return self._rtdetr_detect(frames)
        return self.batch_trace(frames.shape[1], frames.shape[2])(frames)

    def __call__(self, frame_rgb_u8, frame_index: int = 0) -> dict:
        """Detection on one (H,W,3) uint8 frame -> dict of (max_det,) tensors."""
        return {k: v[0] for k, v in self.detect_batch(self._frames(frame_rgb_u8)[None]).items()}


class OracleDetector:
    """Test double: 'detects' ground-truth boxes supplied per frame index, so
    the extract pipeline runs hermetically with ``SyntheticVideoReader``."""

    is_rtdetr = False

    def __init__(self, boxes_by_frame, max_det: int = 8, score: float = 0.9,
                 cls: int = 0, table_frames: int = 512, frame_offset: int = 0,
                 device="cuda"):
        self.device = resolve_device(device)
        self.boxes_by_frame = boxes_by_frame
        self.max_det = max_det
        self.score = score
        self.cls = cls
        self.table_frames = table_frames
        self.frame_offset = frame_offset
        self.class_names = {0: "car", 1: "bus", 2: "truck", 3: "motorcycle"}

    def _frame_arrays(self, frame_index: int):
        boxes = self.boxes_by_frame(frame_index)
        b = np.zeros((self.max_det, 4), np.float32)
        s = np.zeros((self.max_det,), np.float32)
        c = np.full((self.max_det,), -1, np.int32)
        v = np.zeros((self.max_det,), bool)
        n = min(len(boxes), self.max_det)
        if n:
            arr = np.asarray(boxes, np.float32)[:n]
            b[:n] = arr[:, :4]
            s[:n] = arr[:, 4] if arr.shape[1] > 4 else self.score
            c[:n] = arr[:, 5].astype(np.int32) if arr.shape[1] > 5 else self.cls
            v[:n] = True
        return b, s, c, v

    def __call__(self, frame_rgb_u8, frame_index: int = 0) -> dict:
        b, s, c, v = self._frame_arrays(frame_index)
        return {
            "boxes_xywh": torch.as_tensor(b, device=self.device),
            "scores": torch.as_tensor(s, device=self.device),
            "classes": torch.as_tensor(c, device=self.device),
            "valid": torch.as_tensor(v, device=self.device),
        }

    def batch_trace(self, src_h: int, src_w: int):
        """Batched lookup: the per-frame oracle boxes sit in a device table
        indexed by the chunk's (1-based) internal frame ids; frames beyond
        ``table_frames`` read the empty tail row."""
        t = self.table_frames
        tb = np.zeros((t + 1, self.max_det, 4), np.float32)
        ts = np.zeros((t + 1, self.max_det), np.float32)
        tc = np.full((t + 1, self.max_det), -1, np.int32)
        tv = np.zeros((t + 1, self.max_det), bool)
        for f in range(t):
            tb[f], ts[f], tc[f], tv[f] = self._frame_arrays(f + self.frame_offset)
        tb, ts, tc, tv = (torch.as_tensor(a, device=self.device) for a in (tb, ts, tc, tv))

        def run(frames_u8, fids=None):
            c = frames_u8.shape[0]
            if fids is None:
                idx = torch.arange(c, device=self.device)
            else:
                idx = torch.clamp(torch.as_tensor(fids, device=self.device).long() - 1, 0, t)
            return {"boxes_xywh": tb[idx], "scores": ts[idx], "classes": tc[idx], "valid": tv[idx]}

        return run


class SequentialOnly:
    """Hides ``batch_trace`` and ``detect_batch``, so that extraction takes
    the sequential per-frame loop, one detection per frame, with a detector
    that could take the fused path (the reference's parity tests)."""

    is_rtdetr = False

    def __init__(self, detector):
        self._d = detector
        self.max_det = detector.max_det
        self.class_names = detector.class_names

    def __call__(self, frame_rgb_u8, frame_index: int = 0):
        return self._d(frame_rgb_u8, frame_index)
