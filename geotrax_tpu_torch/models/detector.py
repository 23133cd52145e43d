"""Host-facing detector: letterbox -> YOLOv8 forward -> NMS, batched.

Counterpart of ``geotrax_tpu/models/detector.py`` for a model made in memory
(``yolov8.init_params`` or ``yolov8.params_from_jax``). Loading a ``.pt`` or
``hf://`` checkpoint, RT-DETR, tiling and half precision wait for later
slices of the port (ROADMAP A9/A14).
"""

from __future__ import annotations

import numpy as np
import torch

from geotrax_tpu_torch._device import resolve_device
from geotrax_tpu_torch.models import yolov8
from geotrax_tpu_torch.ops.nms import postprocess_detections
from geotrax_tpu_torch.ops.resize import resize_u8_linear


class Detector:
    """YOLOv8 + NMS over batches of frames, with the JAX detector's config
    surface (``imgsz``, ``conf``, ``iou``, ``max_det``, ``agnostic_nms``,
    ``classes``)."""

    is_rtdetr = False

    def __init__(self, model: yolov8.YOLOv8, detect_cfg: dict, class_names=None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.imgsz = int(detect_cfg.get("imgsz", 1920) or 1920)
        self.conf = float(detect_cfg.get("conf", 0.25) or 0.25)
        self.iou = float(detect_cfg.get("iou", 0.7) or 0.7)
        self.max_det = int(detect_cfg.get("max_det", 1000) or 1000)
        self.agnostic = bool(detect_cfg.get("agnostic_nms", True))
        if bool(detect_cfg.get("half", False)):
            raise NotImplementedError("half-precision detection is not ported yet (ROADMAP A9)")
        if int(detect_cfg.get("tiles", 1) or 1) > 1:
            raise NotImplementedError("tiled detection is not ported yet (ROADMAP A9)")
        self.model = model.to(self.device).eval()
        self.spec = model.spec
        self.class_names = class_names or {0: "car", 1: "bus", 2: "truck", 3: "motorcycle"}
        classes = detect_cfg.get("classes")
        self.class_mask = None
        if classes is not None:
            ids = np.asarray(classes, int)
            in_range = ids[(ids >= 0) & (ids < self.spec.nc)]
            if len(in_range) and len(in_range) < self.spec.nc:
                mask = np.zeros((self.spec.nc,), bool)
                mask[in_range] = True
                self.class_mask = torch.as_tensor(mask, device=self.device)

    def resize_geometry(self, src_h: int, src_w: int):
        """(new_h, new_w, r, top, left, out_h, out_w) of the letterbox resize
        for a source resolution."""
        out_h, out_w, r, top, left = yolov8.letterbox_shape(src_h, src_w, self.imgsz)
        return round(src_h * r), round(src_w * r), r, top, left, out_h, out_w

    def _detect_letterboxed(self, imgs: torch.Tensor, r: float, top: int, left: int) -> dict:
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
        (C, max_det, ...) detections in source pixels."""
        new_h, new_w, r, top, left, out_h, out_w = self.resize_geometry(src_h, src_w)

        def run(resized_u8, fids=None):
            imgs = yolov8.letterbox_pad(resized_u8, out_h, out_w, top, left)
            return self._detect_letterboxed(imgs, r, top, left)

        return run

    def batch_trace(self, src_h: int, src_w: int):
        """Like ``batch_trace_resized`` but on full (C,H,W,3) uint8 frames."""
        new_h, new_w, r, top, left, out_h, out_w = self.resize_geometry(src_h, src_w)

        def run(frames_u8, fids=None):
            resized = frames_u8
            if (src_h, src_w) != (new_h, new_w):
                resized = resize_u8_linear(frames_u8, new_h, new_w)
            imgs = yolov8.letterbox_pad(resized, out_h, out_w, top, left)
            return self._detect_letterboxed(imgs, r, top, left)

        return run


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
