"""Procedural frame source: the port's copy of
``geotrax_tpu/io/video.py:SyntheticVideoReader``, numpy only.

It feeds the tests and ``chip_smoke.py`` with deterministic moving-rectangle
frames, so the pipeline runs without a codec or a video file.
"""

from __future__ import annotations

import numpy as np

from geotrax_tpu_torch.io.video import VideoInfo


class SyntheticVideoReader:
    """Deterministic moving-rectangle frames.

    Yields ``(index, frame)`` with ``frame`` an (H,W,3) uint8 RGB array;
    ``boxes_at(index)`` gives the ground-truth rectangles drawn, so tests can
    check detection and tracking without a model.

    ``camera=(dx, dy, deg, zoom)`` moves the camera by that much per frame
    (translation in px, rotation in degrees about the frame centre, scale
    factor): frame ``i``
    shows the scene through ``camera_h(i)``, the homography from frame-``i``
    pixels to frame-0 pixels, i.e. the stabilization homography a
    stabilizer should recover. The background is then drawn on a canvas
    with a margin that covers every frame up to ``n_frames`` and sampled
    bilinearly; the rectangles stay in frame coordinates. With no camera
    the frames are those of ``geotrax_tpu/io/video.py:SyntheticVideoReader``.
    ``start``/``stop`` yield only frames ``start..stop-1`` of the same video.
    """

    def __init__(self, width=256, height=192, n_frames=30, fps=30.0, boxes=None, seed=0,
                 camera=None, start=0, stop=None):
        self.info = VideoInfo(width, height, fps, n_frames)
        self.n_frames = n_frames
        self.start, self.stop = start, n_frames if stop is None else min(stop, n_frames)
        self.camera = camera
        rng = np.random.default_rng(seed)
        if boxes is None:
            # two elongated vehicle-like boxes moving on straight lines
            boxes = [
                {"xy0": (30.0, 40.0), "v": (2.0, 0.5), "wh": (30, 12), "color": (255, 40, 40)},
                {"xy0": (180.0, 120.0), "v": (-1.5, -0.8), "wh": (24, 10), "color": (40, 255, 40)},
            ]
        self.boxes = boxes
        # Structured background (blocks + lines): per-pixel noise would give
        # feature descriptors nothing stable to match against.
        self._margin = self._camera_margin() if camera is not None else 0
        h, w = self.info.height + 2 * self._margin, self.info.width + 2 * self._margin
        bg = rng.integers(40, 90, size=(h, w)).astype(np.uint8)
        for _ in range(max(40, h * w // 1000)):
            y, x = int(rng.integers(0, h - 12)), int(rng.integers(0, w - 12))
            bh, bw = rng.integers(4, 12, size=2)
            bg[y:y + bh, x:x + bw] = rng.integers(120, 255)
        for _ in range(6):
            y = int(rng.integers(0, h - 2))
            bg[y:y + 2, :] = 200
        self._bg = np.stack([bg, bg, bg], axis=-1)
        self._bg_flat = bg.reshape(-1).astype(np.float32) if camera is not None else None

    def camera_h(self, idx: int) -> np.ndarray:
        """(3,3) float64 homography from frame-``idx`` pixels to frame-0
        pixels (the identity without a camera)."""
        if self.camera is None:
            return np.eye(3)
        dx, dy, deg, zoom = self.camera
        cx, cy = (self.info.width - 1) / 2.0, (self.info.height - 1) / 2.0
        a = np.deg2rad(deg * idx)
        s = zoom ** idx
        lin = s * np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
        h = np.eye(3)
        h[:2, :2] = lin
        h[:2, 2] = np.array([cx + dx * idx, cy + dy * idx]) - lin @ np.array([cx, cy])
        return h

    def _camera_margin(self) -> int:
        w, h = self.info.width, self.info.height
        corners = np.array([[0, 0, 1], [w, 0, 1], [0, h, 1], [w, h, 1]], float)
        reach = 0.0
        for idx in range(self.n_frames):
            m = corners @ self.camera_h(idx).T
            reach = max(reach, float(np.abs(m[:, :2] / m[:, 2:] - corners[:, :2]).max()))
        return int(np.ceil(reach)) + 2

    def _background(self, idx: int) -> np.ndarray:
        if self.camera is None:
            return self._bg.copy()
        h, w = self.info.height, self.info.width
        hm = self.camera_h(idx).astype(np.float32)
        xs = np.arange(w, dtype=np.float32)[None, :]
        ys = np.arange(h, dtype=np.float32)[:, None]
        den = hm[2, 0] * xs + (hm[2, 1] * ys + hm[2, 2])
        sx = (hm[0, 0] * xs + (hm[0, 1] * ys + hm[0, 2])) / den + self._margin
        sy = (hm[1, 0] * xs + (hm[1, 1] * ys + hm[1, 2])) / den + self._margin
        x0, y0 = np.floor(sx), np.floor(sy)
        fx, fy = sx - x0, sy - y0
        stride = self._bg.shape[1]
        flat = self._bg_flat
        i00 = y0.astype(np.int32) * stride + x0.astype(np.int32)
        top = flat.take(i00) * (1 - fx) + flat.take(i00 + 1) * fx
        bot = flat.take(i00 + stride) * (1 - fx) + flat.take(i00 + stride + 1) * fx
        gray = np.rint(top * (1 - fy) + bot * fy).astype(np.uint8)
        return np.repeat(gray[..., None], 3, axis=-1)

    def boxes_at(self, idx: int):
        out = []
        for b in self.boxes:
            cx = b["xy0"][0] + b["v"][0] * idx
            cy = b["xy0"][1] + b["v"][1] * idx
            out.append((cx, cy, b["wh"][0], b["wh"][1]))
        return out

    def frame(self, idx: int) -> np.ndarray:
        """Frame ``idx`` of the video (each frame depends on its index only,
        so frames can be made in any order, or in parallel)."""
        frame = self._background(idx)
        for b, (cx, cy, w, h) in zip(self.boxes, self.boxes_at(idx)):
            x0, y0 = int(cx - w / 2), int(cy - h / 2)
            x1, y1 = int(cx + w / 2), int(cy + h / 2)
            x0c, y0c = max(x0, 0), max(y0, 0)
            x1c, y1c = min(x1, self.info.width), min(y1, self.info.height)
            if x1c > x0c and y1c > y0c:
                frame[y0c:y1c, x0c:x1c] = b["color"]
        return frame

    def __iter__(self):
        for idx in range(self.start, self.stop):
            yield idx, self.frame(idx)

    def close(self):
        pass
