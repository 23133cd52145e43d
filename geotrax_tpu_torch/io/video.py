"""Video decoding with prefetch threads, and the MPEG-4 writer.

The port's copy of ``geotrax_tpu/io/video.py``:

- 'native': the port's libavformat/libavcodec decoder and encoder
  (``io/native``), built with g++ at first use; deterministic frame
  indexing, RGB in and out.
- 'cv2': OpenCV, imported only inside this backend's functions, for
  reading (the card's machine reads files this way: it has cv2 and no
  FFmpeg libraries), for writing when the native encoder cannot be built,
  for the live preview of ``visualize --show``, and for a frame saved as
  JPEG (``write_jpeg``, the frame tools' ``-of jpg``). Its BGR frames
  become RGB, and RGB frames BGR, through ``cv2.cvtColor``: byte-equal to
  the reference's reversed channel axis, at a fraction of its cost.

Frames are numpy uint8 HxWx3 in RGB order. ``VideoReader`` decodes in a
background thread that keeps a few frames ahead of the consumer;
``DeviceVideoReader`` (``make_reader`` with a CUDA ``device``, the
native backend and a pixel format of ``ops/yuv.FORMATS``) decodes to the
planes before swscale, uploads them and converts them on the card
(``ops/yuv.py``), its frames uint8 tensors there equal to
``VideoReader``'s bit for bit;
``ParallelVideoReader`` decodes disjoint GOP-aligned segments of one video
in several threads, on either backend: each segment through a native
decoder of its own, its frames located by the packet scan's pts map, or
through a cv2 capture of its own, located by the port's MP4 frame table
(``io/mp4.frame_table``) and sharing the cores' codec threads with the
others. ``make_reader`` takes it when ``workers`` (or
GEOTRAX_DECODE_WORKERS) is above 1. ``VideoWriter`` raises
``RuntimeError`` naming the missing libraries where neither backend exists.
"""

from __future__ import annotations

import os
import queue
import threading
import time
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
            f"needs {DECODER_LIBRARIES}; GEOTRAX_VIDEO_BACKEND chooses between them (a card's "
            f"machine without FFmpeg reads through cv2: the port does not decode through NVDEC "
            f"yet). Without either decoder, frames held in memory can still go through "
            f"pipeline.extract.extract") from None
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


def cv2_probe() -> dict:
    """cv2's version and thread count, None for both without cv2."""
    try:
        import cv2
    except ImportError:
        return {"version": None, "threads": None}
    return {"version": cv2.__version__, "threads": cv2.getNumThreads()}


def _cv2_frames(path: str, spent: Optional[dict] = None):
    """(index, RGB frame) of every frame through one cv2 capture; with
    ``spent``, the seconds in ``read()`` and in the channel swap are added
    to its "read" and "swap"."""
    cv2 = _import_cv2(path, "the cv2 backend was chosen")

    cap = cv2.VideoCapture(path)
    try:
        idx = 0
        while True:
            t0 = time.perf_counter()
            ok, bgr = cap.read()
            if not ok:
                break
            t1 = time.perf_counter()
            rgb = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
            if spent is not None:
                spent["read"] += t1 - t0
                spent["swap"] += time.perf_counter() - t1
            yield idx, rgb
            idx += 1
    finally:
        cap.release()


def codec_threads(workers: int) -> int:
    """Codec threads for each of ``workers`` cv2 captures: the cores this
    process may run on, shared among them (one capture alone takes them
    all)."""
    try:
        cores = len(os.sched_getaffinity(0))
    except AttributeError:  # no affinity call on this platform
        cores = os.cpu_count() or 1
    return max(1, cores // max(1, int(workers)))


def cv2_frames_segment(path: str, ms: np.ndarray, seg: tuple, seek_index: int,
                       threads: int) -> Iterator[tuple[int, np.ndarray]]:
    """Yield (display index, RGB frame) for exactly the display indices
    ``seg`` = [first, stop) through a cv2 capture of its own with
    ``threads`` codec threads: it seeks to the keyframe at display index
    ``seek_index`` (at or before the segment, with an open-GOP margin) and
    drops the warm-up frames before the segment. ``ms`` holds each display
    index's presentation time in ms from the first frame's (the frame
    table's); every frame read must be the next display index by its own
    time (``CAP_PROP_POS_MSEC``), else ``OSError`` names the file and the
    frame: the frames are located, never counted."""
    cv2 = _import_cv2(path, "the cv2 backend was chosen")

    gaps = np.diff(ms)
    tol = float(gaps[gaps > 0].min()) / 4 if (gaps > 0).any() else 0.5
    cap = cv2.VideoCapture(path, cv2.CAP_FFMPEG, [cv2.CAP_PROP_N_THREADS, int(threads)])
    try:
        if not cap.isOpened():
            raise OSError(f"cv2 cannot open {path}")
        if seek_index > 0 and not cap.set(cv2.CAP_PROP_POS_FRAMES, int(seek_index)):
            raise OSError(f"cv2 cannot seek {path} to frame {seek_index}")
        idx = int(seek_index)
        while idx < seg[1]:
            ok, bgr = cap.read()
            if not ok:
                raise OSError(f"cv2 read no frame {idx} of {path} (a segment of frames "
                              f"{seg[0]}-{seg[1] - 1}, sought from frame {seek_index})")
            at = cap.get(cv2.CAP_PROP_POS_MSEC)
            if abs(at - ms[idx]) > tol:
                near = int(np.abs(ms - at).argmin())
                raise OSError(f"cv2 gave the frame at {at:.3f} ms of {path} where frame {idx} "
                              f"({ms[idx]:.3f} ms in its frame table) was due; the table's "
                              f"nearest is frame {near} (sought from frame {seek_index})")
            if idx >= seg[0]:
                yield idx, cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
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


def card_format(path: Path | str):
    """(the stream's pixel format as the native decoder probes it, or None;
    its ``ops/yuv.FORMATS`` entry where the card converts it, else None)."""
    from geotrax_tpu_torch.io import native
    from geotrax_tpu_torch.ops import yuv

    probed = native.native_pixel_format(str(path))
    return probed, (yuv.FORMATS.get(probed.name) if probed is not None else None)


class DeviceVideoReader(VideoReader):
    """``VideoReader`` whose frames are converted on a card: the native
    decoder gives each frame's planes before swscale (into pinned host
    memory), the background thread uploads them on a stream of its own
    and converts them there, one kernel launch a frame, by the kernel
    whose arithmetic is the reference's swscale call for the stream's
    format (``ops/yuv.py``): 8-bit 4:2:0 limited range with even sides as
    NV12 planes (``gtx_read_frame_yuv``, 1.5 bytes a pixel) through
    ``nv12_to_rgb24``; the other formats of ``ops/yuv.FORMATS`` as planar
    Y, U, V (``gtx_read_frame_planes``) through ``yuv_to_rgb24``. The
    format is probed when the file is opened (``pixel_format``,
    ``converter`` names the kernel); a format outside the set raises
    ``ValueError`` (``make_reader`` hands such a file to ``VideoReader``),
    and a frame of another format than the probed one ``OSError``. Frames are
    (H, W, 3) uint8 tensors on the CUDA ``device``, equal to
    ``VideoReader``'s bit for bit, ready on the stream that is current when
    the consumer takes them (it waits for the frame's event, and the
    frame's memory is kept for it)."""

    def __init__(self, path: Path | str, start: int = 0, stop: Optional[int] = None,
                 prefetch: int = 4, device="cuda"):
        import torch

        from geotrax_tpu_torch.ops import yuv

        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"DeviceVideoReader converts on a card, not on {self.device}")
        self._stream = None
        super().__init__(path, start=start, stop=stop, prefetch=prefetch, backend="native")
        self.pixel_format, self.format = card_format(self.path)
        if self.format is None:
            name = self.pixel_format.name if self.pixel_format else "an unknown pixel format"
            raise ValueError(f"DeviceVideoReader converts {', '.join(yuv.FORMATS)} on the card; "
                             f"{self.path} is {name}: read it through VideoReader (swscale on "
                             "the host, as the reference)")
        h, w = self.info.height, self.info.width
        self.nv12 = self.format.name == "yuv420p" and h % 2 == 0 and w % 2 == 0
        self.converter = ("nv12_rgb24" if self.nv12 else yuv.UNSCALED_KERNEL
                          if yuv.route(self.format, h, w) == "unscaled" else yuv.SCALED_KERNEL)

    def _source(self):
        import torch

        from geotrax_tpu_torch.io import native

        def pinned(n):
            return torch.empty(n, dtype=torch.uint8, pin_memory=True)

        if self.nv12:
            return native.native_frames_yuv(self.path, pinned)
        return native.native_frames_planes(self.path, self.pixel_format, pinned)

    def _prepare(self, idx: int, planes):
        import torch

        from geotrax_tpu_torch.ops.yuv import nv12_to_rgb24, yuv_to_rgb24

        h, w = self.info.height, self.info.width
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._stream):
            dev = planes.to(self.device, non_blocking=True)
            if self.nv12:
                frame = nv12_to_rgb24(dev[:h * w].view(h, w), dev[h * w:].view(h // 2, w))
            else:
                fmt = self.format
                if fmt.dtype != torch.uint8:
                    dev = dev.view(fmt.dtype)
                ch, cw = fmt.chroma_shape(h, w)
                y = dev[:h * w].view(h, w)
                u = dev[h * w:h * w + ch * cw].view(ch, cw)
                v = dev[h * w + ch * cw:].view(ch, cw)
                frame = yuv_to_rgb24((y, u, v), fmt)
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

    The display-order pts map comes from the file without decoding: the
    native decoder's packet scan (``backend`` 'native') or the port's MP4
    frame table (``io/mp4.frame_table``, 'cv2'). The index range is split
    into ``workers`` equal segments, and every worker opens its own decoder,
    seeks backward to the keyframe before its segment (one more GOP back
    for open-GOP streams), drops the warm-up frames and serves exactly its
    slice of the map. A native worker decodes on one codec thread and
    selects its frames by pts; a cv2 worker's capture takes its share of
    the cores' codec threads (``codec_threads``) and checks every frame's
    time against the table (``cv2_frames_segment``). ctypes and cv2 release
    the GIL in their decoding calls, so the threads run on as many cores.

    The merged stream equals ``VideoReader``'s bit for bit, because segment
    membership is decided by the display pts, never by counting frames
    after a seek. Raises ``ValueError`` when the file has no usable map (no
    pts, or for cv2 not an MP4 whose tables map it exactly); ``make_reader``
    then takes the sequential reader."""

    def __init__(self, path: Path | str, start: int = 0, stop: Optional[int] = None,
                 workers: int = 2, prefetch: int = 8, backend: Optional[str] = None):
        self.path = str(path)
        self.backend = get_backend(backend)
        if self.backend == "native":
            from geotrax_tpu_torch.io.native import scan_frame_pts

            scan = scan_frame_pts(self.path)
            timescale = None
        else:
            from geotrax_tpu_torch.io import mp4

            try:
                with mp4.Mp4Tables(self.path) as tables:
                    scan, timescale = tables.frame_table(), tables.timescale
            except mp4.PARSE_ERRORS as exc:
                raise ValueError(f"no display-pts map for {path} ({exc}): use the sequential "
                                 "VideoReader") from None
        if scan is None:
            raise ValueError(f"no display-pts map for {path} (the stream lacks pts, or its "
                             "tables do not map it exactly): use the sequential VideoReader")
        self._pts, keys = scan
        n = len(self._pts)
        # each frame's time from the first's, which cv2 reports (CAP_PROP_POS_MSEC)
        self._ms = None if timescale is None else (self._pts - self._pts[0]) * (1e3 / timescale)
        info = probe_video(self.path, self.backend)
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
        self.workers = len(self._segments)
        self.codec_threads = 1 if self.backend == "native" else codec_threads(self.workers)
        self._queues = [queue.Queue(maxsize=max(1, int(prefetch))) for _ in self._segments]
        self._stop_event = threading.Event()
        self._threads: list[threading.Thread] = []
        self._errors: list[Optional[BaseException]] = [None] * len(self._segments)
        self._started = False
        self._finished = False

    def _seek_index(self, seg_start: int) -> int:
        """The display index of the keyframe at or before the segment's
        start, then of one more keyframe back: in an open-GOP stream the
        frames just after an I-frame may reference the GOP before it.
        Warm-up frames are dropped by pts, so the margin costs decoding
        time only."""
        k = int(self._kf[self._kf <= seg_start][-1])
        before = self._kf[self._kf < k]
        return int(before[-1]) if len(before) else k

    def _frames(self, seg: tuple):
        """The segment's (display index, frame) pairs from a decoder of its
        own."""
        seek = self._seek_index(seg[0])
        if self.backend == "cv2":
            return cv2_frames_segment(self.path, self._ms, seg, seek, self.codec_threads)
        from geotrax_tpu_torch.io.native import native_frames_segment

        # one codec thread per worker: GOP parallelism replaces frame
        # threading, and workers x cores codec threads would thrash
        return native_frames_segment(self.path, self._pts[seg[0]:seg[1]], seg[0],
                                     seek_pts=int(self._pts[seek]), threads=1)

    def _produce(self, slot: int, seg: tuple) -> None:
        q = self._queues[slot]
        try:
            for item in self._frames(seg):
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
        for _, frame in VideoReader(self.path, start=index, stop=index + 1, backend=self.backend):
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
    GEOTRAX_DECODE_WORKERS) is above 1 and the file has a pts map, on
    either backend: the native decoder's packet scan, or for cv2 (the card's
    machine, which has no FFmpeg libraries) the port's MP4 frame table;
    else, for a CUDA ``device`` and the native backend,
    ``DeviceVideoReader`` (frames converted on the card) where the stream's
    probed pixel format is one the card converts (``ops/yuv.FORMATS``), and
    for any other format (gray, 12-bit, alpha, packed RGB...) ``VideoReader``,
    whose swscale on the host converts it as the reference's does, with the
    probed format in its ``pixel_format``; the sequential ``VideoReader``
    otherwise (cv2's frames reach the card from the host). The choice is
    made once, here, from the probe: never on a failure.
    The default stays sequential, as the reference's: on a host with one
    core the parallel reader's seek warm-up per segment costs more than it
    wins, and one cv2 capture already decodes on every core."""
    if workers is None:
        workers = int(os.environ.get("GEOTRAX_DECODE_WORKERS", "1") or 1)
    backend = get_backend(backend)
    native = backend == "native"
    if workers > 1:
        try:
            return ParallelVideoReader(path, start=start, stop=stop, workers=workers,
                                       prefetch=max(prefetch, 2 * workers), backend=backend)
        except (ValueError, OSError):
            pass
    if native and device is not None and str(device).startswith("cuda"):
        probed, fmt = card_format(path)
        if fmt is not None:
            return DeviceVideoReader(path, start=start, stop=stop, prefetch=prefetch,
                                     device=device)
        reader = VideoReader(path, start=start, stop=stop, prefetch=prefetch, backend=backend)
        reader.pixel_format = probed
        return reader
    return VideoReader(path, start=start, stop=stop, prefetch=prefetch, backend=backend)


def describe_reader(reader) -> str:
    """The reader extract was handed, its backend, workers and codec
    threads, in words (``track_video`` logs it)."""
    backend = getattr(reader, "backend", None)
    if isinstance(reader, ParallelVideoReader):
        return (f"ParallelVideoReader ({backend} backend, {reader.workers} workers on segments "
                f"{reader._segments}, {reader.codec_threads} codec threads each)")
    if backend is None:
        return type(reader).__name__
    threads = "cv2's own codec threads" if backend == "cv2" else "libavcodec's own codec threads"
    text = f"{type(reader).__name__} ({backend} backend, 1 worker, {threads}"
    fmt = getattr(reader, "pixel_format", None)
    if isinstance(reader, DeviceVideoReader):
        text += (f"; {fmt.name} {reader.info.width}x{reader.info.height} converted on the card "
                 f"by {reader.converter}")
    elif fmt is not None:
        text += f"; {fmt.name}, a format the card does not convert: swscale on the host"
    return text + ")"


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
        import cv2

        self._writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))

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
    bgr = cv2.cvtColor(np.ascontiguousarray(frame_rgb, dtype=np.uint8), cv2.COLOR_RGB2BGR)
    if not cv2.imwrite(str(path), bgr, [cv2.IMWRITE_JPEG_QUALITY, int(quality)]):
        raise OSError(f"cv2 could not write '{path}'")


def preview(frame_rgb: np.ndarray, title: str = "geotrax-tpu") -> int:
    """Show one frame in a window (``visualize --show``); the key pressed
    within 1 ms, or -1. Needs cv2's GUI."""
    try:
        import cv2
    except ImportError:
        raise RuntimeError("--show needs cv2 (OpenCV) for its preview window, and cv2 is "
                           "not installed; run without --show") from None
    cv2.imshow(title, cv2.cvtColor(np.ascontiguousarray(frame_rgb, dtype=np.uint8),
                                   cv2.COLOR_RGB2BGR))
    return cv2.waitKey(1)


def close_preview() -> None:
    import cv2

    cv2.destroyAllWindows()
