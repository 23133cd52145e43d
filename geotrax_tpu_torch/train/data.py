"""YOLO-format dataset loading for training.

The port's copy of ``geotrax_tpu/train/data.py``; its batches equal the
reference's bit for bit. Dataset layout:

    dataset/
      images/{train,val}/*.jpg|png
      labels/{train,val}/*.txt     one 'cls cx cy w h' (normalized) per line

Batches are fixed-shape: images letterboxed to imgsz (square), GT padded to
``max_gt`` with a mask. Augmentation: horizontal flip + HSV value jitter.

Host pieces without Pillow: PNG files are read by the port's codec
(``io/png.py``, with ``convert("RGB")``'s handling of gray, palette and
alpha) and the letterbox resize is the port's copy of Pillow's bicubic
resampler (``train/resample.py``). JPEG and BMP files go through Pillow,
imported only when such a file is met, as the reference reads every image.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator

import numpy as np

from geotrax_tpu_torch.io.png import read_png
from geotrax_tpu_torch.train.resample import resize_bicubic

IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


def list_samples(dataset_dir: Path, split: str) -> list:
    """[(image_path, label_path)] for a split; labels may be missing (empty)."""
    img_dir = Path(dataset_dir) / "images" / split
    lbl_dir = Path(dataset_dir) / "labels" / split
    samples = []
    for img in sorted(img_dir.iterdir()):
        if img.suffix.lower() not in IMG_EXTS:
            continue
        samples.append((img, lbl_dir / f"{img.stem}.txt"))
    if not samples:
        raise FileNotFoundError(f"No images under {img_dir}")
    return samples


def load_label(path: Path) -> np.ndarray:
    """(N,5) [cls, cx, cy, w, h] normalized; empty (0,5) when absent."""
    if not Path(path).exists():
        return np.zeros((0, 5), np.float32)
    rows = []
    for line in Path(path).read_text().splitlines():
        parts = line.split()
        if len(parts) >= 5:
            rows.append([float(p) for p in parts[:5]])
    return np.asarray(rows, np.float32) if rows else np.zeros((0, 5), np.float32)


def load_image(path: Path) -> np.ndarray:
    """(H, W, 3) uint8 RGB."""
    if Path(path).suffix.lower() == ".png":
        return read_png(path)
    from PIL import Image

    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"))


def letterbox_sample(image: np.ndarray, boxes_norm: np.ndarray, imgsz: int):
    """Resize keeping aspect, pad to (imgsz, imgsz) with gray 114; boxes go
    to absolute pixels in the letterboxed frame."""
    h, w = image.shape[:2]
    r = min(imgsz / h, imgsz / w)
    new_h, new_w = round(h * r), round(w * r)
    resized = resize_bicubic(image, new_w, new_h)
    canvas = np.full((imgsz, imgsz, 3), 114, np.uint8)
    top = (imgsz - new_h) // 2
    left = (imgsz - new_w) // 2
    canvas[top:top + new_h, left:left + new_w] = resized
    boxes = boxes_norm.copy()
    if len(boxes):
        boxes[:, 1] = boxes_norm[:, 1] * w * r + left   # cx
        boxes[:, 2] = boxes_norm[:, 2] * h * r + top    # cy
        boxes[:, 3] = boxes_norm[:, 3] * w * r           # w
        boxes[:, 4] = boxes_norm[:, 4] * h * r           # h
    return canvas, boxes


def augment_draws(rng: np.random.Generator, fliplr: float = 0.5, hsv_v: float = 0.2) -> tuple:
    """The random draws of one sample's ``augment``: (flip, value gain or
    None). A rank that skips another rank's sample makes them too, so that
    every rank's generator stays where one process's would be."""
    flip = bool(fliplr) and rng.uniform() < fliplr
    gain = 1.0 + rng.uniform(-hsv_v, hsv_v) if hsv_v else None
    return flip, gain


def augment(image: np.ndarray, boxes: np.ndarray, rng: np.random.Generator,
            fliplr: float = 0.5, scale: float = 0.2, hsv_v: float = 0.2):
    """Light geometric + photometric augmentation on a letterboxed sample."""
    imgsz = image.shape[0]
    flip, gain = augment_draws(rng, fliplr, hsv_v)
    if flip:
        image = image[:, ::-1].copy()
        if len(boxes):
            boxes = boxes.copy()
            boxes[:, 1] = imgsz - boxes[:, 1]
    if gain is not None:
        image = np.clip(image.astype(np.float32) * gain, 0, 255).astype(np.uint8)
    return image, boxes


class Loader:
    """Deterministic shuffled epoch iterator yielding fixed-shape batches.

    ``rows`` (a slice of the batch, ``parallel/mesh.py:batch_rows``) makes
    it yield only those rows of each batch of ``batch_size``, decoding only
    their images: one rank's share of a global batch. Every rank draws the
    same epoch permutation and augmentation, so the rows equal those of the
    whole batch."""

    def __init__(self, dataset_dir: Path, split: str, imgsz: int = 640,
                 batch_size: int = 8, max_gt: int = 64, training: bool = True,
                 seed: int = 0, fraction: float = 1.0, rows: slice | None = None):
        self.samples = list_samples(dataset_dir, split)
        if fraction < 1.0:
            self.samples = self.samples[: max(1, int(len(self.samples) * fraction))]
        self.imgsz = imgsz
        self.batch_size = batch_size
        self.max_gt = max_gt
        self.training = training
        self.seed = seed
        self.rows = range(batch_size)[rows or slice(None)]

    def __len__(self):
        n = len(self.samples)
        if self.training:
            return max(1, n // self.batch_size)
        return -(-n // self.batch_size)  # ceil: validation sees EVERY image

    def epoch(self, epoch_idx: int = 0) -> Iterator[dict]:
        rng = np.random.default_rng(self.seed + epoch_idx)
        n = len(self.samples)
        order = rng.permutation(n) if self.training else np.arange(n)
        if self.training:
            if n < self.batch_size:
                # tiny datasets: fill one batch with replacement so an epoch
                # is never silently zero steps (NaN mean loss)
                order = rng.choice(n, size=self.batch_size, replace=True)
            # drop-last like the ultralytics trainer (stable shapes)
            starts = range(0, len(order) - self.batch_size + 1, self.batch_size)
        else:
            # validation scores every image: the tail batch is padded to full
            # shape; n_valid tells the consumer how many rows are real
            starts = range(0, n, self.batch_size)
        rows = self.rows
        for start in starts:
            idx = order[start:start + self.batch_size]
            images = np.zeros((len(rows), self.imgsz, self.imgsz, 3), np.float32)
            gt_boxes = np.zeros((len(rows), self.max_gt, 4), np.float32)
            gt_cls = np.zeros((len(rows), self.max_gt), np.int32)
            gt_mask = np.zeros((len(rows), self.max_gt), bool)
            for row, si in enumerate(idx):
                if row not in rows:
                    if self.training:
                        augment_draws(rng)
                    continue
                bi = row - rows.start
                img_path, lbl_path = self.samples[si]
                img = load_image(img_path)
                labels = load_label(lbl_path)
                img, boxes = letterbox_sample(img, labels, self.imgsz)
                if self.training:
                    img, boxes = augment(img, boxes, rng)
                images[bi] = img.astype(np.float32) / 255.0
                n = min(len(boxes), self.max_gt)
                if n:
                    gt_boxes[bi, :n] = boxes[:n, 1:5]
                    gt_cls[bi, :n] = boxes[:n, 0].astype(np.int32)
                    gt_mask[bi, :n] = True
            yield {
                "images": images, "gt_boxes": gt_boxes,
                "gt_cls": gt_cls, "gt_mask": gt_mask,
                "n_valid": len(range(len(idx))[rows.start:rows.stop]),
            }
