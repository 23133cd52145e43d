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


def save_frame(path: Path, rgb: np.ndarray, jpeg_quality: int = 75) -> None:
    """Write an image: a .png through the port's writer, a .jpg or .jpeg
    through ``io/video.py:write_jpeg`` at ``jpeg_quality`` (75: the bytes of
    the reference's Pillow writer; it needs cv2, which the card's machine
    lacks)."""
    if Path(path).suffix.lower() == ".png":
        from geotrax_tpu_torch.io.png import write_png

        write_png(path, rgb)
    else:
        from geotrax_tpu_torch.io.video import write_jpeg

        write_jpeg(path, rgb, jpeg_quality)


def add_device_argument(parser) -> None:
    """The port's ``--device`` flag (default ``cuda``; ``cpu`` for the
    plain path)."""
    parser.add_argument("--device", default="cuda",
                        help="Torch device (default: cuda; cpu runs the plain path)")


def resolve_tool_device(args):
    """``torch.device`` of ``args.device``; prints why and exits 1 when it
    names a card this machine lacks (no fallback to the CPU)."""
    import sys

    from geotrax_tpu_torch._device import resolve_device

    try:
        return resolve_device(args.device)
    except RuntimeError as exc:
        print(f"error: {exc}", file=sys.stderr)
        raise SystemExit(1) from None


def pyplot(what: str, show: bool = False, say=print):
    """``matplotlib.pyplot`` on the Agg backend (the interactive one when
    ``show``), or None after one line through ``say`` that ``what`` was
    skipped: figures are optional and host-only (the card's machine has no
    matplotlib)."""
    try:
        import matplotlib
    except ImportError:
        say(f"{what} skipped: matplotlib is not installed")
        return None
    if not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt
