"""Video decoding with a prefetch thread, and the MPEG-4 writer.

The port's copy of the sequential part of ``geotrax_tpu/io/video.py``:

- 'native': the port's libavformat/libavcodec decoder and encoder
  (``io/native``), built with g++ at first use; deterministic frame
  indexing, RGB in and out.
- 'cv2': OpenCV, imported only inside this backend's functions (the card's
  machine has no cv2), for reading, for writing when the native encoder
  cannot be built, and for the live preview of ``visualize --show``.

Frames are numpy uint8 HxWx3 in RGB order. ``VideoReader`` decodes in a
background thread that keeps a few frames ahead of the consumer.
``VideoWriter`` raises ``RuntimeError`` naming the missing libraries where
neither backend exists. The GOP-parallel reader waits for ROADMAP A15b.
"""

from __future__ import annotations

import os
import queue
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, Optional

import numpy as np


@dataclass
class VideoInfo:
    width: int
    height: int
    fps: float
    frame_count: int


def native_available() -> bool:
    """Whether the native decoder builds (or is built) and loads here."""
    from geotrax_tpu_torch.io import native

    try:
        native.load_library()
    except (OSError, RuntimeError):
        return False
    return True


def get_backend(requested: Optional[str] = None) -> str:
    requested = requested or os.environ.get("GEOTRAX_VIDEO_BACKEND")
    if requested in ("native", "cv2"):
        return requested
    return "native" if native_available() else "cv2"


def probe_video(path: Path | str, backend: Optional[str] = None) -> VideoInfo:
    path = str(path)
    if get_backend(backend) == "native":
        from geotrax_tpu_torch.io.native import native_probe

        info = native_probe(path)
        if info is not None:
            return VideoInfo(*info)
    import cv2

    cap = cv2.VideoCapture(path)
    try:
        if not cap.isOpened():
            raise FileNotFoundError(f"Cannot open video: {path}")
        return VideoInfo(
            width=int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
            height=int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
            fps=float(cap.get(cv2.CAP_PROP_FPS)),
            frame_count=int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
        )
    finally:
        cap.release()


def _cv2_frames(path: str):
    import cv2

    cap = cv2.VideoCapture(path)
    try:
        idx = 0
        while True:
            ok, bgr = cap.read()
            if not ok:
                break
            yield idx, np.ascontiguousarray(bgr[..., ::-1])
            idx += 1
    finally:
        cap.release()


class VideoReader:
    """Sequential frame reader with deterministic indexing and prefetch.

    Iterates (frame_index, frame_rgb) from ``start`` (inclusive) to ``stop``
    (exclusive; None = end of stream). Skipped head frames are decoded and
    discarded rather than seeked, so frame indices are exact regardless of
    keyframe placement.
    """

    def __init__(self, path: Path | str, start: int = 0, stop: Optional[int] = None,
                 prefetch: int = 4, backend: Optional[str] = None):
        self.path = str(path)
        self.start = int(start)
        self.stop = stop
        self.backend = get_backend(backend)
        self.info = probe_video(self.path, self.backend)
        self._queue: queue.Queue = queue.Queue(maxsize=max(1, int(prefetch)))
        self._stop_event = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._started = False
        self._finished = False
        self._error: Optional[BaseException] = None

    # -- producer -----------------------------------------------------------
    def _put(self, item) -> bool:
        """Blocking put that honors the stop event (a plain put() could block
        forever once close() stops consuming with the queue full)."""
        while not self._stop_event.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self):
        try:
            if self.backend == "native":
                from geotrax_tpu_torch.io.native import native_frames

                frame_iter = native_frames(self.path)
            else:
                frame_iter = _cv2_frames(self.path)
            for idx, frame in frame_iter:
                if self._stop_event.is_set():
                    break
                if idx < self.start:
                    continue
                if self.stop is not None and idx >= self.stop:
                    break
                if not self._put((idx, frame)):
                    break
        except BaseException as exc:  # noqa: BLE001 — re-raised in the consumer
            self._error = exc
        finally:
            # the sentinel blocks until delivered or the reader is closing
            if not self._put(None):
                try:
                    self._queue.put_nowait(None)
                except queue.Full:
                    pass

    # -- consumer -----------------------------------------------------------
    def __iter__(self) -> Iterator[tuple[int, np.ndarray]]:
        if self._finished:
            if self._error is not None:
                raise self._error
            return
        if not self._started:
            self._thread = threading.Thread(target=self._produce, daemon=True)
            self._thread.start()
            self._started = True
        while True:
            item = self._queue.get()
            if item is None:
                break
            yield item
        self._finished = True
        if self._error is not None:
            raise self._error

    def read_frame(self, index: int) -> np.ndarray:
        """Decode one frame by its exact index (a sequential walk; for the
        reference and master frames, not the hot loop)."""
        for _, frame in VideoReader(self.path, start=index, stop=index + 1, backend=self.backend):
            return frame
        raise IndexError(f"Frame {index} not found in {self.path}")

    def close(self):
        self._stop_event.set()
        if self._thread is not None:
            try:
                while True:
                    self._queue.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=2.0)
        self._finished = True


def make_reader(path: Path | str, start: int = 0, stop: Optional[int] = None, prefetch: int = 4,
                backend: Optional[str] = None) -> VideoReader:
    """The sequential reader (the GOP-parallel one is ROADMAP A15b)."""
    return VideoReader(path, start=start, stop=stop, prefetch=prefetch, backend=backend)


ENCODER_LIBRARIES = ("g++ and FFmpeg's libavformat, libavcodec, libavutil and libswscale "
                     "with their headers (the port's native encoder)")


class VideoWriter:
    """Annotated-video writer: the port's MPEG-4 encoder (``io/native/
    encode.cpp``, the mp4v codec cv2 writes on linux) where the platform's
    fourcc is mp4v, else cv2's writer (also when GEOTRAX_VIDEO_BACKEND is
    'cv2', as for reading). ``backend`` says which was taken and
    ``native_error`` why the native one was not; without either it raises
    ``RuntimeError``. Frames are RGB uint8 of (height, width, 3)."""

    def __init__(self, path: Path | str, fps: float, width: int, height: int):
        from geotrax_tpu_torch.utils.file_utils import determine_suffix_and_fourcc

        _, fourcc = determine_suffix_and_fourcc()
        self.path = str(path)
        self.width, self.height = int(width), int(height)
        self._native = None
        self._writer = None
        self.native_error = None
        if os.environ.get("GEOTRAX_VIDEO_BACKEND") == "cv2":
            self.native_error = "cv2 requested"
        elif fourcc.lower() != "mp4v":
            self.native_error = f"the native encoder writes mp4v only, not {fourcc}"
        else:
            from geotrax_tpu_torch.io import native

            try:
                lib = native.load_encoder_library()
            except (OSError, RuntimeError) as exc:
                self.native_error = str(exc)
            else:
                handle = lib.gtx_enc_open(self.path.encode(), self.width, self.height,
                                          float(fps), 0)  # 0: the encoder's own rate
                if not handle:
                    raise OSError(f"Native encoder cannot open: {self.path}")
                self._native = (lib, handle)
        self.backend = "native" if self._native is not None else "cv2"
        if self._native is None:
            try:
                import cv2
            except ImportError:
                raise RuntimeError(
                    f"cannot write '{self.path}': the native encoder is unavailable "
                    f"({self.native_error}) and cv2 is not installed; writing a video needs "
                    f"{ENCODER_LIBRARIES}, or OpenCV") from None
            self._writer = cv2.VideoWriter(self.path, cv2.VideoWriter_fourcc(*fourcc), fps,
                                           (self.width, self.height))
            if not self._writer.isOpened():
                raise OSError(f"Cannot open video writer: {self.path}")

    def write(self, frame_rgb: np.ndarray) -> None:
        frame = np.ascontiguousarray(frame_rgb, dtype=np.uint8)
        if frame.shape != (self.height, self.width, 3):
            # the encoder reads exactly 3*w*h bytes
            raise ValueError(f"frame shape {frame.shape} != writer ({self.height}, {self.width}, 3)")
        if self._native is not None:
            import ctypes

            lib, handle = self._native
            rc = lib.gtx_enc_write(handle, frame.ctypes.data_as(ctypes.c_void_p))
            if rc < 0:
                raise OSError(f"Native encoder write failed ({rc}): {self.path}")
            return
        self._writer.write(np.ascontiguousarray(frame[..., ::-1]))

    def close(self) -> None:
        if self._native is not None:
            lib, handle = self._native
            self._native = None
            rc = lib.gtx_enc_close(handle)
            if rc < 0:
                raise OSError(f"Native encoder close failed ({rc}): {self.path}")
        elif self._writer is not None:
            self._writer.release()
            self._writer = None


def preview(frame_rgb: np.ndarray, title: str = "geotrax-tpu") -> int:
    """Show one frame in a window (``visualize --show``); the key pressed
    within 1 ms, or -1. Needs cv2's GUI."""
    try:
        import cv2
    except ImportError:
        raise RuntimeError("--show needs cv2 (OpenCV) for its preview window, and cv2 is "
                           "not installed; run without --show") from None
    cv2.imshow(title, np.ascontiguousarray(frame_rgb[..., ::-1]))
    return cv2.waitKey(1)


def close_preview() -> None:
    import cv2

    cv2.destroyAllWindows()
