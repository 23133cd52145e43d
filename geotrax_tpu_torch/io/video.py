"""Video decoding with prefetch threads, and the MPEG-4 writer.

The port's copy of ``geotrax_tpu/io/video.py``:

- 'native': the port's libavformat/libavcodec decoder and encoder
  (``io/native``), built with g++ at first use; deterministic frame
  indexing, RGB in and out.
- 'cv2': OpenCV, imported only inside this backend's functions (the card's
  machine has no cv2), for reading, for writing when the native encoder
  cannot be built, for the live preview of ``visualize --show``, and for a
  frame saved as JPEG (``write_jpeg``, the frame tools' ``-of jpg``).

Frames are numpy uint8 HxWx3 in RGB order. ``VideoReader`` decodes in a
background thread that keeps a few frames ahead of the consumer;
``DeviceVideoReader`` (``make_reader`` with a CUDA ``device`` and the
native backend) decodes to the planes before swscale, uploads them and
converts them on the card (``ops/yuv.py``), its frames uint8 tensors there
equal to ``VideoReader``'s bit for bit;
``ParallelVideoReader`` decodes disjoint GOP-aligned segments of one video
in several threads (native backend), and ``make_reader`` takes it when
``workers`` (or GEOTRAX_DECODE_WORKERS) is above 1. ``VideoWriter`` raises
``RuntimeError`` naming the missing libraries where neither backend exists.
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


def native_error() -> Optional[str]:
    """Why the native decoder does not build (or is not built) and load
    here; None when it does."""
    from geotrax_tpu_torch.io import native

    try:
        native.load_library()
    except (OSError, RuntimeError) as exc:
        return str(exc)
    return None


def native_available() -> bool:
    """Whether the native decoder builds (or is built) and loads here."""
    return native_error() is None


DECODER_LIBRARIES = ("g++ and FFmpeg's libavformat, libavcodec, libavutil and libswscale with "
                     "their headers (the 'native' backend), or OpenCV (the 'cv2' backend)")


def _import_cv2(path: str, why: str):
    """cv2, or a RuntimeError that says what reading ``path`` lacks: the
    native decoder failed (``why``) and cv2 is not installed."""
    try:
        import cv2
    except ImportError:
        raise RuntimeError(
            f"cannot read '{path}': {why}, and cv2 is not installed. Reading a video file "
            f"needs {DECODER_LIBRARIES}; GEOTRAX_VIDEO_BACKEND chooses between them. The port "
            f"does not decode on the card (NVDEC) yet; without either decoder, frames held in "
            f"memory can still go through pipeline.extract.extract") from None
    return cv2


def get_backend(requested: Optional[str] = None) -> str:
    requested = requested or os.environ.get("GEOTRAX_VIDEO_BACKEND")
    if requested in ("native", "cv2"):
        return requested
    return "native" if native_available() else "cv2"


def probe_video(path: Path | str, backend: Optional[str] = None) -> VideoInfo:
    path = str(path)
    backend = get_backend(backend)
    if backend == "native":
        from geotrax_tpu_torch.io.native import native_probe

        info = native_probe(path)
        if info is not None:
            return VideoInfo(*info)
        why = "the native decoder cannot open it"
    else:
        err = native_error()
        why = f"the native decoder is unavailable ({err})" if err else "cv2 was requested"
    cv2 = _import_cv2(path, why)

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


def keyframe_indices(path: Path | str, max_count: int = 1 << 18) -> list[int]:
    """Display indices of the video's I-frames (a scan of its packets, no
    decoding) through the native decoder; empty when only the cv2 backend
    exists (cv2 shows no packet flags). The cut tools snap cut starts onto
    these. ``max_count`` (2 h of all-intra 30 fps video) bounds the list."""
    import ctypes

    from geotrax_tpu_torch.io import native

    try:
        lib = native.load_library()
    except (OSError, RuntimeError):
        return []
    buf = (ctypes.c_long * max_count)()
    n = lib.gtx_keyframe_indices(str(path).encode(), buf, max_count)
    return [int(buf[i]) for i in range(n)] if n > 0 else []


def _cv2_frames(path: str):
    cv2 = _import_cv2(path, "the cv2 backend was chosen")

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

    def _source(self) -> Iterator[tuple[int, object]]:
        """The decoder's (index, frame) pairs, from the first frame on."""
        if self.backend == "native":
            from geotrax_tpu_torch.io.native import native_frames

            return native_frames(self.path)
        return _cv2_frames(self.path)

    def _prepare(self, idx: int, frame):
        """The queue's item for a decoded frame in [start, stop)."""
        return idx, frame

    def _deliver(self, item) -> tuple:
        """The (index, frame) pair the consumer gets for a queue item."""
        return item

    def _produce(self):
        try:
            for idx, frame in self._source():
                if self._stop_event.is_set():
                    break
                if idx < self.start:
                    continue
                if self.stop is not None and idx >= self.stop:
                    break
                if not self._put(self._prepare(idx, frame)):
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
            yield self._deliver(item)
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


class DeviceVideoReader(VideoReader):
    """``VideoReader`` whose frames are converted on a card: the native
    decoder gives each frame's NV12 planes before swscale
    (``gtx_read_frame_yuv``, into pinned host memory), the background thread
    uploads them on a stream of its own (1.5 bytes a pixel instead of RGB's
    3) and converts them there with ``ops/yuv.nv12_to_rgb24``, one kernel
    launch a frame. Frames are (H, W, 3) uint8 tensors on the CUDA
    ``device``, equal to ``VideoReader``'s bit for bit, ready on the stream
    that is current when the consumer takes them (it waits for the frame's
    event, and the frame's memory is kept for it)."""

    def __init__(self, path: Path | str, start: int = 0, stop: Optional[int] = None,
                 prefetch: int = 4, device="cuda"):
        import torch

        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"DeviceVideoReader converts on a card, not on {self.device}")
        self._stream = None
        super().__init__(path, start=start, stop=stop, prefetch=prefetch, backend="native")

    def _source(self):
        import torch

        from geotrax_tpu_torch.io.native import native_frames_yuv

        return native_frames_yuv(self.path, lambda n: torch.empty(n, dtype=torch.uint8,
                                                                  pin_memory=True))

    def _prepare(self, idx: int, planes):
        import torch

        from geotrax_tpu_torch.ops.yuv import nv12_to_rgb24

        h, w = self.info.height, self.info.width
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._stream):
            dev = planes.to(self.device, non_blocking=True)
            frame = nv12_to_rgb24(dev[:h * w].view(h, w), dev[h * w:].view(h // 2, w))
            ready = torch.cuda.Event()
            ready.record(self._stream)
        return idx, frame, ready

    def _deliver(self, item) -> tuple:
        import torch

        idx, frame, ready = item
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(ready)
        frame.record_stream(stream)
        return idx, frame

    def read_frame(self, index: int) -> np.ndarray:
        """One frame by its exact index as numpy (a sequential walk)."""
        reader = DeviceVideoReader(self.path, start=index, stop=index + 1, device=self.device)
        for _, frame in reader:
            return frame.cpu().numpy()
        raise IndexError(f"Frame {index} not found in {self.path}")


class ParallelVideoReader:
    """GOP-parallel frame reader: worker threads decode disjoint index
    ranges of one video at once, merged in display order.

    The display-order pts map is scanned from the packets (no decoding),
    the index range is split into ``workers`` equal segments, and every
    worker opens its own decoder, seeks backward to the keyframe before its
    segment (one more GOP back for open-GOP streams), drops the warm-up
    frames and serves exactly its slice of pts. ctypes releases the GIL in
    the decoder's calls, so the threads run on as many cores.

    The merged stream equals ``VideoReader``'s bit for bit, because segment
    membership is decided by the scanned display pts, never by counting
    frames after a seek. Raises ``ValueError`` when the stream has no
    usable pts map; ``make_reader`` then takes the sequential reader."""

    def __init__(self, path: Path | str, start: int = 0, stop: Optional[int] = None,
                 workers: int = 2, prefetch: int = 8):
        from geotrax_tpu_torch.io.native import scan_frame_pts

        self.path = str(path)
        self.backend = "native"
        scan = scan_frame_pts(self.path)
        if scan is None:
            raise ValueError(f"no display-pts map for {path} (the stream lacks pts): use "
                             "the sequential VideoReader")
        self._pts, keys = scan
        n = len(self._pts)
        info = probe_video(self.path, "native")
        # the packet scan counts the actual frames: trust it over the
        # container's estimate, so that no segment runs past the end
        self.info = VideoInfo(info.width, info.height, info.fps, n)
        self._kf = np.flatnonzero(keys)
        if n == 0 or len(self._kf) == 0 or self._kf[0] != 0:
            raise ValueError(f"{path}: no keyframes (corrupt index?)")
        self.start = max(0, int(start))
        self.stop = n if stop is None else max(self.start, min(int(stop), n))
        total = self.stop - self.start
        self._workers = max(1, min(int(workers), max(1, total)))
        # segments shorter than about 2 GOPs pay more seek warm-up than they win
        approx_gop = max(1, int(np.median(np.diff(self._kf))) if len(self._kf) > 1 else n)
        while self._workers > 1 and total / self._workers < 2 * approx_gop:
            self._workers -= 1
        bounds = [self.start + (total * j) // self._workers for j in range(self._workers + 1)]
        self._segments = [(bounds[j], bounds[j + 1]) for j in range(self._workers)
                          if bounds[j] < bounds[j + 1]]
        self._queues = [queue.Queue(maxsize=max(1, int(prefetch))) for _ in self._segments]
        self._stop_event = threading.Event()
        self._threads: list[threading.Thread] = []
        self._errors: list[Optional[BaseException]] = [None] * len(self._segments)
        self._started = False
        self._finished = False

    def _seek_pts(self, seg_start: int) -> int:
        """The keyframe at or before the segment's start, then one more
        keyframe back: in an open-GOP stream the frames just after an
        I-frame may reference the GOP before it. Warm-up frames are dropped
        by pts, so the margin costs decoding time only."""
        k = int(self._kf[self._kf <= seg_start][-1])
        before = self._kf[self._kf < k]
        if len(before):
            k = int(before[-1])
        return int(self._pts[k])

    def _produce(self, slot: int, seg: tuple) -> None:
        from geotrax_tpu_torch.io.native import native_frames_segment

        q = self._queues[slot]
        try:
            # one codec thread per worker: GOP parallelism replaces frame
            # threading, and workers x cores codec threads would thrash
            for item in native_frames_segment(self.path, self._pts[seg[0]:seg[1]], seg[0],
                                              seek_pts=self._seek_pts(seg[0]), threads=1):
                if not self._put(q, item):
                    return
        except BaseException as exc:  # noqa: BLE001 — re-raised in the consumer
            self._errors[slot] = exc
        finally:
            if not self._put(q, None):
                try:
                    q.put_nowait(None)
                except queue.Full:
                    pass

    def _put(self, q: queue.Queue, item) -> bool:
        while not self._stop_event.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def __iter__(self) -> Iterator[tuple[int, np.ndarray]]:
        if self._finished:
            return
        if not self._started:
            for slot, seg in enumerate(self._segments):
                t = threading.Thread(target=self._produce, args=(slot, seg), daemon=True)
                t.start()
                self._threads.append(t)
            self._started = True
        for slot in range(len(self._segments)):
            while True:
                item = self._queues[slot].get()
                if item is None:
                    break
                yield item
            if self._errors[slot] is not None:
                self._finished = True
                raise self._errors[slot]
        self._finished = True

    def read_frame(self, index: int) -> np.ndarray:
        for _, frame in VideoReader(self.path, start=index, stop=index + 1, backend="native"):
            return frame
        raise IndexError(f"Frame {index} not found in {self.path}")

    def close(self):
        self._stop_event.set()
        for q in self._queues:
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
        for t in self._threads:
            t.join(timeout=2.0)
        self._finished = True


def make_reader(path: Path | str, start: int = 0, stop: Optional[int] = None, prefetch: int = 4,
                backend: Optional[str] = None, workers: Optional[int] = None, device=None):
    """The GOP-parallel reader when ``workers`` (the argument, else
    GEOTRAX_DECODE_WORKERS) is above 1, the backend is the native one and
    the stream has a pts map; else, for a CUDA ``device`` and the native
    backend, ``DeviceVideoReader`` (frames converted on the card); the
    sequential ``VideoReader`` otherwise. The default stays sequential: on
    a host with one core the parallel reader's seek warm-up per segment
    costs more than it wins."""
    if workers is None:
        workers = int(os.environ.get("GEOTRAX_DECODE_WORKERS", "1") or 1)
    native = get_backend(backend) == "native"
    if workers > 1 and native:
        try:
            return ParallelVideoReader(path, start=start, stop=stop, workers=workers,
                                       prefetch=max(prefetch, 2 * workers))
        except (ValueError, OSError):
            pass
    if native and device is not None and str(device).startswith("cuda"):
        return DeviceVideoReader(path, start=start, stop=stop, prefetch=prefetch, device=device)
    return VideoReader(path, start=start, stop=stop, prefetch=prefetch, backend=backend)


ENCODER_LIBRARIES = ("g++ and FFmpeg's libavformat, libavcodec, libavutil and libswscale "
                     "with their headers (the port's native encoder)")


class VideoWriter:
    """Annotated-video writer: the port's MPEG-4 encoder (``io/native/
    encode.cpp``, the mp4v codec cv2 writes on linux) where the platform's
    fourcc is mp4v, else cv2's writer (also when GEOTRAX_VIDEO_BACKEND is
    'cv2', as for reading). ``backend`` says which was taken and
    ``native_error`` why the native one was not; without either it raises
    ``RuntimeError``. Frames are RGB uint8 of (height, width, 3);
    ``bitrate`` (bits/s, 0 for the encoder's own 4*w*h) sets the native
    encoder's rate (the recut tools' ``--bitrate``)."""

    def __init__(self, path: Path | str, fps: float, width: int, height: int, bitrate: int = 0):
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
                                          float(fps), int(bitrate))
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


def write_jpeg(path: Path | str, frame_rgb: np.ndarray, quality: int = 75) -> None:
    """Write one RGB frame as a JPEG at ``quality``; 75, Pillow's default,
    gives the bytes the reference's Pillow writer gives (95 is
    ``cv2.imwrite``'s default). Needs cv2."""
    try:
        import cv2
    except ImportError:
        raise RuntimeError(f"cannot write '{path}': JPEG output needs cv2 (OpenCV), which is "
                           "not installed; write PNG frames instead") from None
    if not cv2.imwrite(str(path), np.ascontiguousarray(frame_rgb[..., ::-1]),
                       [cv2.IMWRITE_JPEG_QUALITY, int(quality)]):
        raise OSError(f"cv2 could not write '{path}'")


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
