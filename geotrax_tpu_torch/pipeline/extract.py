"""`extract`: detection, tracking and stabilization of one video (pixel
coordinates), and the files it writes.

The port's counterpart of ``geotrax_tpu/pipeline/extract.py`` (the CLI:
``add_processing_args``, ``parse_cli_args``, ``main``) and
``geotrax_tpu/pipeline/_extract_impl.py`` (``load_detector`` and
``open_reader``, both patch points; ``track_video`` with its process-level
cache of detector and extractors; ``run_extraction``; the row emission of
``_track_video_fused``; the post-processing and ``save_results``), with
the same columns, formats and keys:

  <out>/<stem><tracks_postfix>.txt   frame, id, box (4), stabilized box (4,
                                     with stabilization), class (the
                                     track's vote), score, length, width
                                     (+ is_interpolated with
                                     ``interpolate``) — ``%g``, comma
                                     separated; tracks shorter than
                                     ``min_track_length`` removed
  <out>/<stem><stab_postfix>.txt     frame + row-major 3x3 cur->ref
                                     homography — ``%.16g``
  <source>.yaml                      the run's metadata next to the source

The chunks go through the fused chunk step (``device_pipeline.py``)
double-buffered: a host thread copies decoded frames into two reused
staging buffers (pinned on the card), each chunk is uploaded on a copy
stream while the previous one computes, and chunk k's rows are emitted
after chunk k+1 is dispatched. ``pipelined=False`` runs the chunks one
after another from pageable memory; both give the same rows.

Where the fused step does not apply (an RT-DETR detector, a multi-level
stabilizer: ``stabilo.detector_name`` sift/rsift/kaze/akaze, or a detector
without ``batch_trace``), ``track_video_sequential`` runs the reference's
per-frame loop: detection in groups of ``SEQUENTIAL_GROUP`` frames
(``detect_batch``; one frame at a time for RT-DETR), one upload per group
shared by the detector, the sequential ``Stabilizer`` and the ReID gather,
then per frame the homography, GMC, embeddings, tracker step and
stabilized boxes, through the same functions as the fused step, so that
both paths write the same rows.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import queue
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

from geotrax_tpu_torch import __version__
from geotrax_tpu_torch.cfg import DEFAULT, select_tracker
from geotrax_tpu_torch.io import yaml_emit
from geotrax_tpu_torch.pipeline import postprocess
from geotrax_tpu_torch.pipeline.device_pipeline import (FusedExtractor, _transform_boxes_h,
                                                         embed_boxes, gmc_from_h)
from geotrax_tpu_torch.stabilize.config import StabilizerConfig
from geotrax_tpu_torch.stabilize.stabilizer import Stabilizer
from geotrax_tpu_torch.track import make_tracker
from geotrax_tpu_torch.track.reid import resolve_head
from geotrax_tpu_torch.utils.cli_utils import add_common_args
from geotrax_tpu_torch.utils.file_utils import convert_to_serializable, get_output_dir

# One chunk per fused dispatch (the JAX package's _extract_impl.FUSED_CHUNK).
FUSED_CHUNK = 32
MIN_MATCH_WARNING = 4
# Frames per detect_batch call of the sequential loop (the reference's group).
SEQUENTIAL_GROUP = 16
# The sequential loop logs its progress every this many frames.
PROGRESS_FRAMES = 100

_LOG = logging.getLogger("geotrax")


# --------------------------------------------------------------------------
# construction
# --------------------------------------------------------------------------

def make_extract_tracker(config: dict, device="cuda", logger=_LOG):
    """Tracker construction as the extract stage performs it:
    (tracker_cfg, tracker_state, tracker_step, reid_params) with max_tracks =
    max(256, min(max_det, 1024)). With ReID on, ``reid_params`` is the
    learned head that ``tracker.<active>.model`` names (track/reid.py), or
    None to embed by projection (``model: auto``, or a missing or malformed
    file, with a warning)."""
    name, params = select_tracker(config["tracker"])
    max_det = int(config["ultralytics"].get("max_det", 1000) or 1000)
    tracker_cfg, state, step = make_tracker(name, params, max_tracks=max(256, min(max_det, 1024)),
                                            device=device)
    reid_params = resolve_head(params, logger) if tracker_cfg.with_reid else None
    return tracker_cfg, state, step, reid_params


def make_fused_extractor(config: dict, detector, tracker_cfg, tracker_state, tracker_step,
                         src_h: int, src_w: int, reid_params=None, chunk: int = FUSED_CHUNK,
                         rng_seed: int = 0, device="cuda") -> FusedExtractor:
    """The FusedExtractor as the extract stage builds it: the ``stabilo``
    section (None with ``extraction.stabilize: false``), the tracker's GMC
    and ReID flags and the learned head."""
    stabilize = config.get("extraction", DEFAULT["extraction"]).get("stabilize", True)
    return FusedExtractor(
        detector, config.get("stabilo", DEFAULT["stabilo"]) if stabilize else None, tracker_step,
        tracker_state, src_h, src_w, use_gmc=tracker_cfg.use_gmc, chunk=chunk, rng_seed=rng_seed,
        with_reid=tracker_cfg.with_reid, reid_params=reid_params, device=device,
    )


# --------------------------------------------------------------------------
# the chunk drivers
# --------------------------------------------------------------------------

class _Rows:
    """Emits each chunk's rows once its outputs are on the host: 12 columns
    (frame, id, box, stabilized box, class, score) with stabilization, 8
    without, and the transforms of the frames after the reference frame."""

    def __init__(self, cut_left: int, stabilize: bool, logger):
        self.cut_left, self.stabilize, self.logger = cut_left, stabilize, logger
        self.rows, self.transforms, self.hs, self.matches, self.inliers = [], [], [], [], []
        self.chunk_s = []
        self.n_frames = 0

    def drain(self, out, idxs, n: int, dispatch_s: float) -> None:
        t0 = time.perf_counter()
        out = type(out)(*(t.cpu().numpy() for t in out))
        self.chunk_s.append(dispatch_s + time.perf_counter() - t0)
        self.hs.append(out.h[:n])
        self.matches.append(out.matches[:n])
        self.inliers.append(out.inliers[:n])
        for i in range(n):
            frame_idx = idxs[i]
            valid = out.valid[i]
            ids = out.track_id[i][valid]
            boxes = out.box_xywh[i][valid]
            scores = out.score[i][valid]
            classes = out.cls[i][valid]
            head = [np.full(len(ids), frame_idx, float), ids.astype(float), boxes]
            if self.stabilize:
                if frame_idx > self.cut_left:
                    if out.matches[i] < MIN_MATCH_WARNING:
                        self.logger.warning(f"Frame {frame_idx}: stabilization failed; identity used.")
                    self.transforms.append(np.concatenate([[frame_idx], out.h[i].reshape(-1)]))
                # ref frame: stabilized box = raw box by definition
                head.append(boxes if frame_idx == self.cut_left else out.box_stab[i][valid])
            self.rows.append(np.column_stack(head + [classes.astype(float), scores]))
            self.n_frames += 1

    def result(self, reader, elapsed: float) -> tuple:
        n_cols = 12 if self.stabilize else 8
        stats = {
            "frames": self.n_frames,
            "avg_detect_ms": sum(self.chunk_s) * 1e3 / max(self.n_frames, 1),
            "avg_stab_ms": 0.0,
            "chunks": len(self.chunk_s),
            "chunk_s": self.chunk_s,
            "wall_s": elapsed,
            "h": np.concatenate(self.hs) if self.hs else np.empty((0, 3, 3)),
            "matches": np.concatenate(self.matches) if self.matches else np.empty((0,), np.int32),
            "inliers": np.concatenate(self.inliers) if self.inliers else np.empty((0,), np.int32),
            "fps": self.n_frames / max(elapsed, 1e-9),
            "frame_size": (int(reader.info.width), int(reader.info.height)),
            "video_fps": float(reader.info.fps),
        }
        tracks = np.concatenate(self.rows, axis=0) if self.rows else np.empty((0, n_cols))
        transforms = np.asarray(self.transforms) if self.transforms else np.empty((0, 10))
        return tracks, transforms, stats


def _fids(idxs, cut_left: int) -> np.ndarray:
    return np.asarray(idxs, np.int64) - cut_left + 1


def _groups(reader, size: int):
    """``reader``'s (index, frame) pairs in lists of ``size`` (the last one
    shorter)."""
    buf = []
    for item in reader:
        buf.append(item)
        if len(buf) == size:
            yield buf
            buf = []
    if buf:
        yield buf


def _stack_frames(frames: list):
    """One chunk's frames stacked: with torch where the reader gives tensors
    (on the card already, or CPU tensors), else with numpy on the host."""
    if torch.is_tensor(frames[0]):
        return torch.stack(frames)
    return np.stack(frames)


def _drive_serial(reader, fx, chunk: int, cut_left: int, rows: _Rows) -> None:
    """One chunk after another: stack the frames (on the host, or on the
    card where the reader's frames are there), run the chunk step (which
    uploads host frames from pageable memory), fetch, emit."""
    def run(buf):
        n = len(buf)
        idxs = [i for i, _ in buf]
        frames = _stack_frames([f for _, f in buf])
        if n < chunk:  # pad the tail chunk with its last frame
            pad = frames[-1:].repeat(chunk - n, 1, 1, 1) if torch.is_tensor(frames) \
                else np.repeat(frames[-1:], chunk - n, axis=0)
            frames = torch.cat([frames, pad]) if torch.is_tensor(frames) \
                else np.concatenate([frames, pad], axis=0)
            idxs = idxs + [idxs[-1]] * (chunk - n)
        t0 = time.perf_counter()
        out = fx.process_chunk(frames, _fids(idxs, cut_left), n)
        rows.drain(out, idxs, n, time.perf_counter() - t0)

    for buf in _groups(reader, chunk):
        run(buf)


class Staging:
    """Two host buffers of one chunk of frames (pinned on the card) and two
    device buffers, reused across chunks and videos, with the copy stream
    and the events that order the uploads against the chunk steps. A frame
    that is a tensor already on the device (a ``DeviceVideoReader``'s) is
    copied into its device buffer on the copy stream (``put_device``), and
    its slot's upload then only marks it ready."""

    def __init__(self, chunk: int, height: int, width: int, device: torch.device):
        self.shape = (chunk, height, width, 3)
        self.cuda = device.type == "cuda"
        self.host = [torch.empty(self.shape, dtype=torch.uint8, pin_memory=self.cuda)
                     for _ in range(2)]
        self.dev = [torch.empty(self.shape, dtype=torch.uint8, device=device) for _ in range(2)]
        if self.cuda:
            self.stream = torch.cuda.Stream(device)
            self.uploaded = [torch.cuda.Event() for _ in range(2)]
            self.consumed = [torch.cuda.Event() for _ in range(2)]

    def streamed(self):
        """The copy stream made current: a reader's device frames taken
        under it are ready on the stream that copies them
        (``DeviceVideoReader``)."""
        return torch.cuda.stream(self.stream) if self.cuda else contextlib.nullcontext()

    def on_device(self, frame) -> bool:
        """Whether ``frame`` is a tensor on the device buffers' device."""
        return torch.is_tensor(frame) and frame.device == self.dev[0].device

    def put_host(self, slot: int, i: int, frame) -> None:
        """Copy a frame (numpy, or a tensor anywhere) into row ``i`` of
        ``slot``'s host buffer."""
        self.host[slot][i].copy_(frame if torch.is_tensor(frame) else
                                 torch.from_numpy(np.ascontiguousarray(frame)))

    def put(self, slot: int, frames: list) -> None:
        """Fill ``slot``'s first rows with ``frames`` and start their upload:
        when every frame is on the device already, each is copied there
        (``put_device``) and the slot marked ready; else through the host
        buffer (``upload``)."""
        if all(self.on_device(f) for f in frames):
            for i, frame in enumerate(frames):
                self.put_device(slot, i, frame)
            self.mark_uploaded(slot)
            return
        with self.streamed():  # a frame elsewhere on the card is read after it is ready
            for i, frame in enumerate(frames):
                self.put_host(slot, i, frame)
        self.upload(slot, len(frames))

    def put_device(self, slot: int, i: int, frame: torch.Tensor) -> None:
        """Copy a frame already on the device into row ``i`` of ``slot``'s
        device buffer: on the card on the copy stream, after the chunk step
        that last read that buffer (checked at the slot's first row), the
        frame's memory kept until the copy is done. The calling thread takes
        the reader's frames under ``streamed``, so the copy also waits for
        the frame."""
        if not self.cuda:
            self.dev[slot][i].copy_(frame)
            return
        with torch.cuda.stream(self.stream):
            if i == 0:
                self.stream.wait_event(self.consumed[slot])
            self.dev[slot][i].copy_(frame, non_blocking=True)
            frame.record_stream(self.stream)

    def pad_device(self, slot: int, n: int) -> None:
        """Repeat row ``n - 1`` of ``slot``'s device buffer into its later
        rows (the tail chunk's padding), in stream order after its copies."""
        if not self.cuda:
            self.dev[slot][n:] = self.dev[slot][n - 1]
            return
        with torch.cuda.stream(self.stream):
            self.dev[slot][n:] = self.dev[slot][n - 1]

    def mark_uploaded(self, slot: int) -> None:
        """Mark ``slot``'s device buffer, filled by ``put_device``, ready."""
        if self.cuda:
            self.uploaded[slot].record(self.stream)

    def upload(self, slot: int, n: int | None = None) -> None:
        """Copy host slot ``slot`` (its first ``n`` frames, all by default)
        into its device buffer once the chunk step that last read that
        buffer is done; non-blocking on the card."""
        n = self.shape[0] if n is None else n
        if not self.cuda:
            self.dev[slot][:n].copy_(self.host[slot][:n])
            return
        with torch.cuda.stream(self.stream):
            self.stream.wait_event(self.consumed[slot])
            self.dev[slot][:n].copy_(self.host[slot][:n], non_blocking=True)
            self.uploaded[slot].record(self.stream)

    def frames(self, slot: int) -> torch.Tensor:
        """The device buffer of ``slot``, once the compute stream has waited
        for its upload."""
        if self.cuda:
            torch.cuda.current_stream().wait_event(self.uploaded[slot])
        return self.dev[slot]

    def done(self, slot: int) -> None:
        """Mark the end of the chunk step that reads ``slot``'s buffer."""
        if self.cuda:
            self.consumed[slot].record()

    def wait_uploaded(self, slot: int) -> None:
        """Block the calling host thread until ``slot``'s upload is done."""
        if self.cuda:
            self.uploaded[slot].synchronize()


def _staging(fx, chunk: int, height: int, width: int) -> Staging:
    """The extractor's staging buffers (made on its first pipelined run)."""
    st = getattr(fx, "_staging", None)
    if st is None or st.shape != (chunk, height, width, 3):
        st = fx._staging = Staging(chunk, height, width, fx.device)
    return st


def _drive_pipelined(reader, fx, chunk: int, cut_left: int, rows: _Rows) -> None:
    """Dispatch/drain double-buffering: a thread fills the next staging
    slot from ``reader`` while the card works; each chunk is uploaded on
    the copy stream before the previous chunk's step runs, and a chunk's
    rows are emitted after the next chunk is dispatched. Frames that are
    tensors on the extractor's device skip the host slot: each is copied
    into the device slot on the copy stream as it arrives, and a slot so
    filled is handed back to the thread once the step that reads it has
    been dispatched."""
    st = _staging(fx, chunk, int(reader.info.height), int(reader.info.width))
    free: queue.Queue = queue.Queue()
    filled: queue.Queue = queue.Queue()
    for slot in range(2):
        free.put(slot)
    stop = threading.Event()

    def take(q):
        while not stop.is_set():
            try:
                return q.get(timeout=0.1)
            except queue.Empty:
                continue
        return None

    def produce():
        try:
            with st.streamed():
                slot, idxs, direct = None, [], False
                for idx, frame in reader:
                    if slot is None:
                        slot = take(free)
                        if slot is None:
                            return
                        st.wait_uploaded(slot)  # the slot's last upload has left it
                        direct = st.on_device(frame)
                    if direct:
                        st.put_device(slot, len(idxs), frame)
                    else:
                        st.put_host(slot, len(idxs), frame)
                    idxs.append(idx)
                    if len(idxs) == chunk:
                        filled.put((slot, idxs, chunk, direct))
                        slot, idxs = None, []
                if idxs:  # pad the tail chunk with its last frame
                    n = len(idxs)
                    if direct:
                        st.pad_device(slot, n)
                    else:
                        st.host[slot][n:] = st.host[slot][n - 1]
                    filled.put((slot, idxs + [idxs[-1]] * (chunk - n), n, direct))
            filled.put(None)
        except BaseException as exc:  # noqa: BLE001 — re-raised by the consumer
            filled.put(exc)

    def get():
        item = take(filled)
        if isinstance(item, BaseException):
            raise item
        return item

    def upload(item):
        if item is not None:
            slot, _, _, direct = item
            if direct:  # filled on the device: free once its chunk step is dispatched
                st.mark_uploaded(slot)
            else:
                st.upload(slot)
                free.put(slot)  # refilled once its upload is done (wait_uploaded)

    thread = threading.Thread(target=produce, daemon=True)
    thread.start()
    try:
        cur = get()
        upload(cur)
        pending = None
        while cur is not None:
            nxt = get()
            upload(nxt)  # overlaps the step of ``cur``
            slot, idxs, n, direct = cur
            t0 = time.perf_counter()
            out = fx.process_chunk(st.frames(slot), _fids(idxs, cut_left), n)
            st.done(slot)
            if direct:  # its next copies wait for this step (put_device)
                free.put(slot)
            dispatch_s = time.perf_counter() - t0
            if pending is not None:
                rows.drain(*pending)
            pending = (out, idxs, n, dispatch_s)
            cur = nxt
        if pending is not None:
            rows.drain(*pending)
    finally:
        stop.set()
        thread.join(timeout=10.0)


def track_video_fused(reader, fx, cut_left: int = 0, chunk: int = FUSED_CHUNK,
                      stabilize: bool = True, pipelined: bool = True, logger=_LOG) -> tuple:
    """Drive ``fx`` (a FusedExtractor) over ``reader``'s (index, frame)
    pairs; returns (tracks rows, transform rows, stats). The tail chunk is
    padded with its last frame to the chunk size, as the JAX package pads
    it to its compiled shape. ``chunk_s`` is each chunk's step plus the copy
    of its outputs to the host (``avg_detect_ms`` their mean per frame, as
    the reference's fused path counts its device time); ``wall_s`` is the
    whole run; ``avg_stab_ms`` is 0 (stabilization runs inside the step)."""
    rows = _Rows(cut_left, stabilize, logger)
    t_start = time.perf_counter()
    (_drive_pipelined if pipelined else _drive_serial)(reader, fx, chunk, cut_left, rows)
    tracks, transforms, stats = rows.result(reader, time.perf_counter() - t_start)
    logger.info(f"Extraction (fused): {stats['frames']} frames, device "
                f"{stats['avg_detect_ms']:.1f} ms/f, pipeline {stats['fps']:.1f} fps")
    return tracks, transforms, stats


# --------------------------------------------------------------------------
# the sequential per-frame loop
# --------------------------------------------------------------------------

def track_video_sequential(reader, detector, tracker_parts: tuple, config: dict,
                           cut_left: int = 0, logger=_LOG) -> tuple:
    """The per-frame loop of the reference's ``track_video`` over
    ``reader``'s (index, frame) pairs, on ``detector``'s device; returns
    (tracks rows, transform rows, stats). ``tracker_parts`` is
    ``make_extract_tracker``'s result. Detection runs in groups of
    ``SEQUENTIAL_GROUP`` frames through ``detect_batch`` (one frame at a time
    for RT-DETR or a detector without it); each group is uploaded once. The
    reference frame (``cut_left``) sets the stabilizer's reference; every
    later frame adds a transform row (the identity, with a warning, where
    stabilization fails). GMC comes from consecutive homographies on the
    card in float32, the tracker counts frames from 1, and the stabilized
    boxes transform the whole slot table before the valid rows are taken.
    Rows have 12 columns, 8 with stabilization off. ``avg_detect_ms``,
    ``avg_stab_ms`` and ``avg_track_ms`` are host times per frame (the
    detections, the homography and the embeddings, tracker and rows each
    read back to the host)."""
    tracker_cfg, state, step, reid_params = tracker_parts
    stabilize = bool(config.get("extraction", DEFAULT["extraction"]).get("stabilize", True))
    dev = torch.device(detector.device) if hasattr(detector, "device") else state.track_id.device
    stabilizer = (Stabilizer(**config.get("stabilo", DEFAULT["stabilo"]), device=dev)
                  if stabilize else None)
    head = None if reid_params is None else {k: v.to(dev) for k, v in reid_params.items()}
    group = (SEQUENTIAL_GROUP if hasattr(detector, "detect_batch")
             and not getattr(detector, "is_rtdetr", False) else 1)
    class_names = config.get("class_names") or {}
    class_counts: dict = {}
    rows, transforms = [], []
    h_prev = None
    detect_s = stab_s = track_s = 0.0
    n_frames = 0
    t_start = time.perf_counter()
    with torch.no_grad():
        for chunk in _groups(reader, group):
            t0 = time.perf_counter()
            frames = torch.as_tensor(_stack_frames([f for _, f in chunk])).to(dev)
            if group > 1 and len(chunk) > 1:
                batch = detector.detect_batch(frames)
                dets = [{k: v[i] for k, v in batch.items()} for i in range(len(chunk))]
            else:
                dets = [detector(frames[i], idx) for i, (idx, _) in enumerate(chunk)]
            host = [(d["boxes_xywh"].cpu().numpy(), d["valid"].cpu().numpy()) for d in dets]
            detect_s += time.perf_counter() - t0

            for i, ((frame_idx, _), det) in enumerate(zip(chunk, dets)):
                frame = frames[i]
                det_boxes, det_valid = host[i]
                t0 = time.perf_counter()
                h_cur = np.eye(3, dtype=np.float32)
                if stabilizer is not None:
                    if frame_idx == cut_left:
                        stabilizer.set_ref_frame(frame, det_boxes[det_valid])
                    else:
                        stabilizer.stabilize(frame, det_boxes[det_valid])
                        h_est = stabilizer.get_cur_trans_matrix()
                        if h_est is not None:
                            h_cur = h_est.astype(np.float32)
                        else:
                            logger.warning(f"Frame {frame_idx}: stabilization failed; identity used.")
                        transforms.append(np.concatenate([[frame_idx], h_cur.reshape(-1)]))
                stab_s += time.perf_counter() - t0

                t0 = time.perf_counter()
                h_t = torch.as_tensor(h_cur, device=dev)
                gmc_h = None if h_prev is None else gmc_from_h(h_t[None], h_prev[None])[0]
                h_prev = h_t
                det_emb = None
                if tracker_cfg.with_reid:
                    det_emb = embed_boxes(frame[None], det["boxes_xywh"][None], head_params=head)[0]
                state, out = step(state, det["boxes_xywh"], det["scores"], det["classes"],
                                  det["valid"], frame_idx - cut_left + 1, gmc_h, det_emb)
                head_cols = [out.track_id, out.box_xywh]
                if stabilize and frame_idx != cut_left:
                    head_cols.append(_transform_boxes_h(h_t[None], out.box_xywh[None])[0])
                out_np = [t.cpu().numpy() for t in head_cols + [out.cls, out.score, out.valid]]
                valid = out_np[-1]
                ids, boxes = out_np[0][valid], out_np[1][valid]
                classes, scores = out_np[-3][valid], out_np[-2][valid]
                cols = [np.full(len(ids), frame_idx, float), ids.astype(float), boxes]
                if stabilize:
                    cols.append(boxes if frame_idx == cut_left else out_np[2][valid])
                rows.append(np.column_stack(cols + [classes.astype(float), scores]))
                track_s += time.perf_counter() - t0
                n_frames += 1
                for tid, c in zip(ids, classes):
                    class_counts.setdefault(int(c), set()).add(int(tid))
                if n_frames % PROGRESS_FRAMES == 0:
                    counts = ", ".join(f"{class_names.get(c, c)}: {len(v)}"
                                       for c, v in sorted(class_counts.items()))
                    logger.info(f"Extracting: {n_frames} frames [{counts}] det "
                                f"{detect_s * 1e3 / n_frames:.0f} ms/f, stab "
                                f"{stab_s * 1e3 / n_frames:.0f} ms/f")

    elapsed = max(time.perf_counter() - t_start, 1e-9)
    per = 1e3 / max(n_frames, 1)
    stats = {
        "frames": n_frames,
        "avg_detect_ms": detect_s * per,
        "avg_stab_ms": stab_s * per,
        "avg_track_ms": track_s * per,
        "fps": n_frames / elapsed,
        "wall_s": elapsed,
        "frame_size": (int(reader.info.width), int(reader.info.height)),
        "video_fps": float(reader.info.fps),
    }
    logger.info(f"Extraction: {n_frames} frames, detect {stats['avg_detect_ms']:.1f} ms/f, "
                f"stab {stats['avg_stab_ms']:.1f} ms/f, pipeline {stats['fps']:.1f} fps")
    n_cols = 12 if stabilize else 8
    tracks = np.concatenate(rows, axis=0) if rows else np.empty((0, n_cols))
    transforms_arr = np.asarray(transforms) if transforms else np.empty((0, 10))
    return tracks, transforms_arr, stats


# --------------------------------------------------------------------------
# files
# --------------------------------------------------------------------------

def save_results(tracks: np.ndarray, transforms: np.ndarray, out_dir, stem: str,
                 tracks_postfix: str = "", stab_postfix: str = "_vid_transf",
                 save_stab: bool = True, logger=_LOG) -> tuple:
    """Write ``<stem><tracks_postfix>.txt`` (``%g``) and
    ``<stem><stab_postfix>.txt`` (``%.16g``) into ``out_dir``; returns the
    two paths (a file with no rows is not written, as in the reference)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    tracks_file = out_dir / f"{stem}{tracks_postfix}.txt"
    transf_file = out_dir / f"{stem}{stab_postfix}.txt"
    if tracks.size:
        np.savetxt(tracks_file, tracks, fmt="%g", delimiter=",")
        logger.info(f"Tracking results saved to: '{tracks_file.resolve()}'")
    if transforms.size and save_stab:
        frame_nums = transforms[:, 0].astype(int)
        matrices = transforms[:, 1:].reshape(-1, 3, 3)
        if len(frame_nums) and not np.all(np.diff(frame_nums) == 1):
            logger.warning(f"Missing frame ids found in: '{transf_file}'.")
        if len(matrices) and not np.all(np.linalg.det(matrices) > 0):
            logger.warning(f"Invalid transforms found in: '{transf_file}'.")
        np.savetxt(transf_file, transforms, fmt="%.16g", delimiter=",")
        logger.info(f"Stabilization transforms saved to: '{transf_file.resolve()}'")
    return tracks_file, transf_file


def run_metadata(config: dict, stats: dict, source, args: dict) -> dict:
    """The metadata ``save_results`` writes beside the source, with the
    reference's keys in its order: the port's version, the source's size and
    frame rate, the run's times, the configuration (model, tracker, the
    ``extraction`` and ``stabilo`` sections and the detection keys) and the
    run's arguments. ``model`` is the ``model`` argument (a list joined by
    spaces) or else the configured one, as the reference resolves it."""
    extraction = config.get("extraction", DEFAULT["extraction"])
    detection = config.get("ultralytics", DEFAULT["ultralytics"])
    model = args.get("model")
    if isinstance(model, list):
        model = " ".join(model)
    model = model or extraction.get("model") or detection.get("model")
    return {
        "geotrax_tpu_version": __version__,
        "video": {
            "source": str(source),
            "width": stats["frame_size"][0],
            "height": stats["frame_size"][1],
            "fps": stats["video_fps"],
            "frames_processed": stats["frames"],
        },
        "runtime": {
            "avg_detect_ms": round(stats["avg_detect_ms"], 2),
            "avg_stabilization_ms": round(stats["avg_stab_ms"], 2),
            "pipeline_fps": round(stats["fps"], 2),
            "extraction_mode": stats.get("extraction_mode", "sequential"),
        },
        "config": {
            "model": str(model),
            "tracker": select_tracker(config.get("tracker", DEFAULT["tracker"]))[0],
            "extraction": extraction,
            "stabilo": config.get("stabilo"),
            "detection": {k: detection.get(k) for k in (
                "imgsz", "conf", "iou", "max_det", "classes", "agnostic_nms", "tiles")},
        },
        "args": convert_to_serializable(args),
    }


def write_outputs(tracks, transforms, stats: dict, config: dict, out_dir, stem: str,
                  source=None, args: dict | None = None, interpolate=None, logger=_LOG) -> dict:
    """Post-process the rows as ``run_extraction`` does (short tracks
    removed, classes voted, dimensions estimated, gaps up to the active
    tracker's ``track_buffer`` filled with ``interpolate``) and write the
    files; returns ``stats`` with their paths."""
    args = dict(args or {})
    extraction = config.get("extraction", DEFAULT["extraction"])
    output = config.get("output", {})
    n_raw = len(tracks)
    tracks = postprocess.remove_short_tracks(tracks, int(extraction["min_track_length"]), logger)
    tracks = postprocess.vote_track_classes(tracks)
    frame_w, frame_h = stats["frame_size"]
    tracks = postprocess.estimate_vehicle_dimensions(
        tracks, extraction["dimension_estimation"], frame_w, frame_h)
    if interpolate is None:
        interpolate = extraction.get("interpolate", False)
    if interpolate:
        tracker = select_tracker(config.get("tracker", DEFAULT["tracker"]))[1]
        tracks = postprocess.interpolate_tracks(tracks, int(tracker.get("track_buffer", 30)), logger)

    tracks_file, transf_file = save_results(
        tracks, transforms, out_dir, stem,
        tracks_postfix=output.get("tracks_postfix", ""),
        stab_postfix=output.get("stab_transform_postfix", "_vid_transf"),
        save_stab=bool(extraction.get("save_stab", True)), logger=logger,
    )
    stats.update(tracks_file=tracks_file, transforms_file=transf_file, n_rows_raw=n_raw,
                 n_rows=len(tracks), n_transforms=len(transforms))
    if source is not None:
        meta_file = Path(source).with_suffix(".yaml")
        try:
            meta_file.write_text(yaml_emit.dump(run_metadata(config, stats, source, args)))
            stats["metadata_file"] = meta_file
            logger.info(f"Run metadata saved to: '{meta_file.resolve()}'")
        except OSError as exc:
            logger.warning(f"Could not write metadata: {exc}")
    return stats


def extract(reader, fx, out_dir, stem: str, config: dict | None = None,
            cut_left: int = 0, chunk: int = FUSED_CHUNK, source=None,
            args: dict | None = None) -> dict:
    """The fused extract of one frame source into ``out_dir`` (the library
    form of ``run_extraction`` for a reader and an extractor already made):
    the tracks and transforms files named after ``stem`` and, when
    ``source`` (the video's path) is given, ``<source>.yaml``. ``config``
    supplies the ``extraction``, ``output``, ``tracker``, ``stabilo`` and
    ``ultralytics`` sections (defaults: the port's ``cfg.DEFAULT``);
    ``args`` holds the run's arguments, written into the metadata, and an
    ``interpolate`` there (when not None) overrides the configured one, as
    the CLI's flag does. Returns the run's stats with the file paths."""
    config = config or DEFAULT
    args = dict(args or {})
    stabilize = bool(config.get("extraction", DEFAULT["extraction"]).get("stabilize", True))
    tracks, transforms, stats = track_video_fused(reader, fx, cut_left=cut_left, chunk=chunk,
                                                  stabilize=stabilize)
    stats = write_outputs(tracks, transforms, stats, config, out_dir, stem, source=source,
                          args=args, interpolate=args.get("interpolate"))
    if fx.device.type == "cuda":
        stats["device"] = torch.cuda.get_device_name(fx.device)
    return stats


# --------------------------------------------------------------------------
# run_extraction: the CLI's stage
# --------------------------------------------------------------------------

def flat_config(config: dict) -> dict:
    """The sections the chunk step and the files read, from the split
    configuration of ``load_config_all``: the ``main`` sections, ``stabilo``,
    ``ultralytics`` and a ``tracker`` section holding the active block."""
    main = config["main"]
    flat = {k: v for k, v in main.items()
            if isinstance(v, dict) and k not in ("class_names", "tracker_params")}
    flat.update(stabilo=config["stabilo"], ultralytics=config["ultralytics"],
                tracker={"active": main["tracker_active"],
                         main["tracker_active"]: main["tracker_params"]})
    return flat


def _device(config: dict) -> str:
    return getattr(config["main"].get("args"), "device", None) or "cuda"


def load_detector(config: dict, logger):
    """Build the detector from ``ultralytics.model`` (tests patch this, as
    the reference's tests patch its counterpart)."""
    from geotrax_tpu_torch.models.detector import Detector

    return Detector(Path(config["ultralytics"]["model"]), config["ultralytics"], logger=logger,
                    device=_device(config))


def open_reader(source: Path, start: int, stop, config: dict):
    """Video reader factory (tests patch this with a synthetic reader). On
    a card with the native decoder the frames are converted there
    (``DeviceVideoReader``) and reach the chunk step without a host copy;
    GEOTRAX_DECODE_WORKERS above 1 takes the GOP-parallel reader on either
    backend (``track_video`` logs the reader taken)."""
    from geotrax_tpu_torch.io.video import make_reader

    return make_reader(source, start=start, stop=stop, device=_device(config))


# Process-level reuse of the loaded detector and the extractors across
# extract calls (a batch over many videos of one configuration): keyed on
# the model file's identity (path, mtime, size), the detection, stabilo and
# tracker configuration and the device; the extractors per source
# resolution, reset for each video. Only real Detector instances are kept.
_EXTRACT_CACHE: dict = {}
_EXTRACT_CACHE_MAX = 4


def _extract_cache_key(config: dict, stabilize_on: bool) -> str:
    det_cfg = dict(config["ultralytics"])
    model = str(det_cfg.get("model", ""))
    try:
        st = Path(model).stat()
        mstamp = (st.st_mtime_ns, st.st_size)
    except OSError:
        mstamp = None
    main = config["main"]
    return json.dumps({
        "model": model, "mstamp": mstamp, "det": det_cfg,
        "stab": config.get("stabilo") if stabilize_on else None,
        "tracker": [main["tracker_active"], main["tracker_params"]],
        "chunk": FUSED_CHUNK, "device": _device(config),
    }, sort_keys=True, default=str)


def track_video(args, config: dict, logger, pipelined: bool = True) -> tuple:
    """Decode, detect, track and stabilize ``args.source``; returns (tracks
    rows, transforms rows, stats). The fused chunk step runs where the
    detector has ``batch_trace`` and is not RT-DETR and the stabilizer is
    single-level; the sequential per-frame loop everywhere else."""
    from geotrax_tpu_torch.io.video import describe_reader
    from geotrax_tpu_torch.models.detector import Detector

    main = config["main"]
    stabilize_on = bool(main["extraction"].get("stabilize", True))
    flat = flat_config(config)
    device = _device(config)
    cache_key = _extract_cache_key(config, stabilize_on)
    cached = _EXTRACT_CACHE.get(cache_key)
    if cached is not None:
        detector, tracker_parts, fx_by_shape = cached
    else:
        detector = load_detector(config, logger)
        tracker_parts = make_extract_tracker(flat, device=device, logger=logger)
        fx_by_shape = {}
        if type(detector) is Detector:
            while len(_EXTRACT_CACHE) >= _EXTRACT_CACHE_MAX:
                _EXTRACT_CACHE.pop(next(iter(_EXTRACT_CACHE)))
            _EXTRACT_CACHE[cache_key] = (detector, tracker_parts, fx_by_shape)

    cut_left = int(args.cut_frame_left or 0)
    reader = open_reader(args.source, cut_left, args.cut_frame_right, config)
    logger.info(f"Reading '{args.source}' through {describe_reader(reader)}")
    fused_ok = (hasattr(detector, "batch_trace") and not getattr(detector, "is_rtdetr", False)
                and (not stabilize_on
                     or StabilizerConfig(**config.get("stabilo", {})).n_levels == 1))
    if not fused_ok:
        flat["class_names"] = main.get("class_names")
        return track_video_sequential(reader, detector, tracker_parts, flat, cut_left=cut_left,
                                      logger=logger)
    src_w, src_h = int(reader.info.width), int(reader.info.height)
    fx = fx_by_shape.get((src_h, src_w))
    if fx is not None:
        fx.reset()  # fresh per-video state, same extractor and staging buffers
    else:
        fx = fx_by_shape[(src_h, src_w)] = make_fused_extractor(
            flat, detector, *tracker_parts[:3], src_h, src_w, tracker_parts[3],
            chunk=FUSED_CHUNK, device=device)
    return track_video_fused(reader, fx, cut_left=cut_left, chunk=FUSED_CHUNK,
                             stabilize=stabilize_on, pipelined=pipelined, logger=logger)


def detect_track_stabilize(args, logger) -> dict:
    """The extract stage for one video (the library entry point that
    ``batch`` calls): ``run_extraction``."""
    return run_extraction(args, logger)


def run_extraction(args, logger) -> dict:
    """``geotrax extract``'s stage for one video: the configuration (preset
    or file, CLI overrides, the backfill of the frame range, ``interpolate``
    and the output folder), the fused extraction, optionally under
    ``torch.profiler`` (``args.profile``: a chrome trace in that directory),
    post-processing and the three files. Returns the run's stats."""
    from geotrax_tpu_torch.utils import logging_utils  # noqa: F401 — logger.notice
    from geotrax_tpu_torch.utils.config_utils import backfill_args_from_config, load_config_all

    config = load_config_all(args, logger, needs_model=True)
    main = config["main"]
    backfill_args_from_config(args, {
        "cut_frame_left": main["processing"]["cut_frame_left"],
        "cut_frame_right": main["processing"]["cut_frame_right"],
        "interpolate": main["extraction"]["interpolate"],
        "output_folder": main["output"]["folder"],
    })
    out_cfg = {**main["output"], "folder": args.output_folder}

    profile_dir = getattr(args, "profile", None)
    if profile_dir:
        from torch.profiler import ProfilerActivity, profile

        logger.notice(f"Profiling the extraction loop into '{profile_dir}'.")
        activities = [ProfilerActivity.CPU]
        if _device(config).startswith("cuda"):
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            tracks, transforms, stats = track_video(args, config, logger)
        Path(profile_dir).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(profile_dir) / "extract_trace.json"))
    else:
        tracks, transforms, stats = track_video(args, config, logger)

    source = Path(args.source)
    flat = flat_config(config)
    flat["output"] = out_cfg
    return write_outputs(tracks, transforms, stats, flat, get_output_dir(source, out_cfg),
                         source.stem, source=source, args=vars(args),
                         interpolate=bool(args.interpolate), logger=logger)


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------

def add_processing_args(group) -> None:
    """Detection and frame-range flags of `extract`; all default to None and
    are backfilled from the config."""
    group.add_argument("--model", "-m", nargs="+", default=None, metavar="MODEL",
                       help="Detection model: local path (.pt/.npz) or hf://<org>/<repo>/<file> reference.")
    group.add_argument("--class-names", "-cn", nargs="+", default=None, metavar="ID=NAME|FILE",
                       help="Class-id -> name override: .yaml/.json file or inline ID=NAME pairs.")
    group.add_argument("--conf", "-co", type=float, default=None,
                       help="Detection confidence threshold (cfg -> ultralytics -> conf).")
    group.add_argument("--classes", "-cls", nargs="+", type=int, default=None,
                       help="Class IDs to extract (cfg -> ultralytics -> classes).")
    group.add_argument("--cut-frame-left", "-cfl", type=int, default=None,
                       help="Skip the first N frames (cfg -> processing -> cut_frame_left).")
    group.add_argument("--cut-frame-right", "-cfr", type=int, default=None,
                       help="Stop after this frame (cfg -> processing -> cut_frame_right).")
    group.add_argument("--tiles", "-t", type=int, default=None,
                       help="Detect over N overlapping vertical tiles merged by a global NMS "
                            "(small-object accuracy at 4K; cfg -> ultralytics -> tiles).")
    group.add_argument("--interpolate", action=argparse.BooleanOptionalAction, default=None,
                       help="Fill per-track frame gaps by linear interpolation (adds is_interpolated column).")
    group.add_argument("--profile", type=str, default=None, metavar="DIR",
                       help="Write a torch.profiler chrome trace of the extraction loop into DIR.")


def parse_cli_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        prog="python -m geotrax_tpu_torch extract",
        description="Vehicle detection, tracking, and stabilization (PyTorch/CUDA)")
    parser.add_argument("source", type=Path, help="Path to the input video file.")
    optional = parser.add_argument_group("Optional arguments")
    add_common_args(optional)
    processing = parser.add_argument_group("Processing arguments")
    add_processing_args(processing)
    return parser.parse_args(argv)


def main(argv=None) -> int:
    from geotrax_tpu_torch.utils.logging_utils import setup_logger

    args = parse_cli_args(argv)
    logger = setup_logger("geotrax.extract", args.verbose, args.log_path)
    run_extraction(args, logger)
    return 0


if __name__ == "__main__":
    sys.exit(main())
