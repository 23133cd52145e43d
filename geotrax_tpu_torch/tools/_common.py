"""Helpers shared by the port's tools."""

from __future__ import annotations

from pathlib import Path

import numpy as np


def load_yolo_labels(label_path: Path) -> np.ndarray:
    """(N, 5) [cls, cx, cy, w, h] normalized; empty when the file is absent."""
    from geotrax_tpu_torch.train.data import load_label

    return load_label(label_path)


def iter_images(folder: Path):
    for ext in ("*.jpg", "*.jpeg", "*.png", "*.bmp"):
        yield from sorted(Path(folder).glob(ext))


def save_frame(path: Path, rgb: np.ndarray) -> None:
    """Write an image: a .png through the port's writer, a .jpg or .jpeg
    through ``io/video.py:write_jpeg`` (the bytes of the reference's Pillow
    writer; a host-only option: the tools that write frames decode video,
    which the card's machine cannot)."""
    if Path(path).suffix.lower() == ".png":
        from geotrax_tpu_torch.io.png import write_png

        write_png(path, rgb)
    else:
        from geotrax_tpu_torch.io.video import write_jpeg

        write_jpeg(path, rgb)
