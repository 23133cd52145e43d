"""Smoke run of the PyTorch/H100 port (geotrax_tpu_torch) on one CUDA card.

    python3 chip_smoke.py                  # every phase; the last line is the result
    python3 chip_smoke.py --kernels-only   # phases 0-2 only, no result line
    python3 chip_smoke.py --georef-only    # phases 0, 1 and 10 only, no result line
    python3 chip_smoke.py --lockstep-only  # phases 0, 1 and 12 only, no result line
    python3 chip_smoke.py --render-only    # phases 0, 1 and 13 only, no result line
    python3 chip_smoke.py --train-only     # phases 0, 1 and 14 only, no result line
    python3 chip_smoke.py --features-only  # phases 0, 1 and 15 only, no result line
    python3 chip_smoke.py --multi-only     # phases 0, 1 and 16 only, no result line
    python3 chip_smoke.py --tools-only     # phases 0, 1 and 17 only, no result line
    python3 chip_smoke.py --host-tools-only  # phases 0, 1 and 18 only, no result line

Phases, one ``[smoke] <phase> ok <seconds>s ...`` line each; a failing phase
ends the run with a non-zero exit and no result line:

  0 device     the card's name and power limit (exit 1 without a card)
  1 build      nvcc builds csrc/fast_score.cu and csrc/patch_gather.cu for
               sm_90a and g++ the TIFF reader's io/native/tiff.cpp and the
               exact assignment's io/native/lapjv.cpp, all at once
               (-Xptxas -v shown)
  2 kernel     the FAST kernel equals its plain PyTorch version exactly on a
               seeded (33,1080,1920) batch, an odd (2,37,53) batch, a
               3-pixel checkerboard and a constant image, at thresholds 20
               and 7; the float patch gather equals its plain version
               exactly at each path's shape (TMA: describe's (1,1080,1920)
               x 2000 and the (3, 12 and 96,1080,1920) x 1000 channel
               planes of a frame, four frames and a chunk; corners out of
               range, at every edge, inside) and on an odd (2,37,53) x 130
               case (the register path); CUDA-event times of each kernel and
               its plain version; for the gather at each shape its device
               time (CUDA graphs, in turns with one PyTorch call computing
               it, an advanced index on an unfold view), its time as called,
               and its bound; for FAST also the achieved GB/s, the share of
               the bound and the share of pixels that take its full test
  3 main       the default extract configuration: YOLOv8s at imgsz 1920
               (random weights from a seeded generator, class biases set so
               that about VEHICLES_PER_4K_FRAME boxes pass ``conf``) on two
               32-frame chunks of 3840x2160 synthetic frames seen by a
               moving camera, through the fused chunk step and the extract
               entry point into its files (the post-processed 14-column
               tracks file, the transforms file, the metadata file with the
               reference's top-level keys), read back and checked; the FAST
               launch counter must rise by 3, and every frame's homography
               must be the camera's; then the FAST kernel exact and timed on
               the first chunk's own gray
  4 steady     three more chunks of the same video through the same
               extractor: ms per chunk (median, min, max), checked as above
  5 breakdown  one more chunk under torch.profiler, checked as above: host
               and device time per stage and the largest device items
               (device times read 0 where the profiler sees none)
  6 reid       the same configuration with tracker.botsort.with_reid: true,
               through the extract entry point on the main phase's frames
               (kept in host memory): files and homographies checked as in
               the main phase, the patch launch counter must rise by one per
               chunk, the embeddings of valid detections have unit norm and,
               on the first chunk, equal those of the plain gather on the
               card; the HWC gather on that chunk's own inputs exact and
               timed (``hwc_kernel_check``: against its bound and an unfold
               yardstick);
               one more chunk timed beside the steady median, and the
               three kept chunks through fresh extractors without and with
               ReID in turns; then one chunk with a learned head (seeded
               init_head, saved to .npz, loaded through resolve_head)
  7 cli        ``extract`` as users run it: the calibrated detector saved as
               .npz and .pt and loaded back (equal detections on frame 0),
               run_extraction with -m ckpt.npz -c default on the main
               phase's frames, files checked as in the main phase, FAST
               launches counted; a ``decode:`` line with the decode probe's
               outcome: with FFmpeg's headers and libraries the port's
               decoder is built and ``python -m geotrax_tpu_torch extract``
               decodes a .y4m clip of the frames in a subprocess, without
               them run_extraction reads the frames in memory (open_reader
               replaced, the reference's own test patch point); then the
               double-buffered driver and the serial loop in turns on the
               same 96 frames, rows equal
  8 options    a fresh detector and extractor per option on the main phase's
               first two chunks: the stable preset (CLAHE), tiles=2, half,
               stabilization off with botsort (standalone GMC, checked
               against the camera's motion) and with bytetrack (no FAST
               launch); ms of both chunks, FAST launches, homographies
               against the camera
  9 sequential the sequential per-frame extract path on 16 frames of a
               drifting 3840x2160 video with 36 moving vehicles: (a) the
               reader's vehicles as oracle detections through the fused
               chunk step and through the sequential loop (SequentialOnly),
               default configuration with ReID: with 1-frame chunks
               every value equal; with one 16-frame chunk frames, ids,
               classes and scores equal, boxes and homographies within
               0.05 px (a chunk's batched RANSAC refinement and ReID
               projection add in another order on the card);
               (b) YOLOv8s at imgsz 1920 with a ``stabilo.detector_name:
               rsift`` copy of the default preset through run_extraction
               (one detect_batch group, every homography within 2 px of the
               camera's); (c) RT-DETR-L at ULSpec's published widths (nc=4,
               seeded random weights, the last score head's bias set for 36
               detections per frame) at imgsz 1920 with the orb Stabilizer
               and ReID through run_extraction (the detector in memory):
               FAST and the patch gather launched once per frame, files
               checked; its forward timed (CUDA events) against the float32
               bound of its counted FLOPs, the stage's peak memory, one
               frame at imgsz 640 on the card against the CPU; then both
               kernels exact and timed on the path's own per-frame inputs,
               and embed_boxes on them timed
 10 georef     ``georeference`` as users run it at the reference regime: a
               synthetic 15000^2 orthophoto (tools/benchmark_ortho_matching.py's
               recipe), 4K reference and master frames rendered from it in
               torch, the assets written as files (PNG through the port's
               writer, center-text-file parameters, lane segmentation,
               flight log, 5 minutes of 4K tracks at 36 vehicles per
               frame); run_georeferencing with the master path, then again
               from the cache (the reference frame in memory:
               get_video_data replaced): corner errors against the true
               warps (3 px), 50 inliers, the feature counts, the CSV's
               columns, sections and lanes, the rerun's homography within
               0.01 px; the registration's device steps timed alone (CUDA
               events) with match_l2's float32 bound, and the ortho's
               RootSIFT by level and by piece of a band against each
               bound; the single-level Stabilizer on a pair of the
               reference view (two FAST launches)
 11 reference  the same port on a small oracle clip with a moving camera,
               on the card and on the CPU (plain versions), for botsort,
               botsort with ReID, deepocsort with ReID, tracktrack with
               ReID, ocsort and fasttrack: equal track ids, close geometry
 12 lockstep  ``batch --parallel-videos 4`` on four drifting 3840x2160
               videos of 16, 16, 16 and 12 frames with 36 moving vehicles
               each: (a) the readers' vehicles as oracle detections,
               stabilization off, bytetrack and botsort: each video's
               lockstep files against run_extraction of that video alone
               (the sequential loop), equal or the largest difference per
               column; (b) YOLOv8s imgsz 1920 (the main phase's calibrated
               detector) with ReID under the default preset through
               extract_videos_batch: files, homographies within 2 px of each
               video's camera, FAST launched once per video's reference
               frame and once per later step, the gather once per step, unit
               embeddings; ms per step, frames/s in turns against the four
               videos through run_extraction one after another, peak
               memory; (c) both kernels exact and timed on the phase's own
               (4,1080,1920) grays and (4,2160,3840,3) frames x max_det
               corners (the HWC gather, pooling in the kernel), and
               embed_boxes on them timed; (d)
               process_input on a directory of the four videos
               (open_reader, probe_video and load_detector replaced), every
               metadata file parallel-group-4, a second run runs no stage
 13 render     ``visualize`` and ``plot`` as users run them, and ``batch``
               under its default gates: (a) the five modes of
               visualize_results at the default preset's line width and tail
               (lanes and class names shown) on a drifting 16-frame
               3840x2160 clip with 36 vehicles, its tracks, transforms and a
               georeferenced speed/lane CSV written from the reader's known
               boxes and camera, frames from memory, on the card and on the
               CPU: 16 frames per mode, the card's frames within one grey
               level of the CPU's (bit-equal in modes 0, 2 and 3, which do
               no device work); with FFmpeg's libraries the port's encoder
               writes each file and its decoder counts 16 frames back, else
               the writer keeps each frame's digest in memory; (b) ms per
               frame by mode (read, warp, draw, write) and the warp of one
               4K frame (CUDA events) against its bound, with the upload
               and download; (c) plot on a georeferenced CSV of 324,000
               rows: the PDFs plot_dataset names, or, where matplotlib or
               seaborn is missing, a line saying so and the data half alone;
               (d) process_input on four videos with --no-geo and the
               visualize and plot gates left open: extract (lockstep),
               visualize and plot ran for each video
 14 train      ``python -m geotrax_tpu_torch.train`` as users run it: (a) a
               YOLO-format dataset written through the port's PNG writer,
               16 train and 8 val 3840x2160 images with 36 vehicles each
               over classes 0-3; (b) YOLOv8s nc=4 fine-tuned (--model) from
               a seeded checkpoint with a detector's head priors at the
               default preset's imgsz 1920 and batch 8 for 2 epochs, then a
               1-epoch run resumed to 2: every file checked, finite losses
               and weights, the resumed run's distance from the
               uninterrupted one stated; (c) one loss and backward on the
               card against the CPU at imgsz 640, batch 2 (loss and each
               gradient's relative L2 error); (d) the trainer's loop
               instrumented: forward with the loss, backward and update by
               CUDA events, the loader's host ms per batch, the device's
               idle share, peak memory, the step's counted FLOPs and
               bound, evaluate's ms per image; neither hand kernel
               launches. Depth cut: 2 epochs of 16 images, 4 timed steps
 15 features   (run after the georef phase, on its assets) the ORB-style
               library, the exact assignment and GeoTIFF orthophotos: (a)
               the 0.5x gray (1080x1920) of a drifting 4K frame and a copy
               zoomed 1.6x about its centre: oriented fast_detect (K=2000),
               describe on its three routes, the 4-level pyramid of both,
               match_descriptors and ransac_fit, each step timed (CUDA
               events, median of 3), FAST launched once in fast_detect and
               once per pyramid level and the patch gather once (counted
               over the first run); against the CPU's plain versions:
               keypoints equal, angles within ANGLE_TOL, unoriented bits
               equal and oriented ones within ORIENTED_BIT_SHARE, pyramid
               keypoints shared at PYRAMID_OVERLAP, matches equal; the zoom
               recovered within 4 px at four interior corners; both kernels
               exact on these inputs; (b) lapjv_exact on a seeded 1000x2000
               float64 cost equal to scipy's linear_sum_assignment, both
               timed; (c) the TIFF fixtures of tests/data/tiff (LZW,
               deflate with predictor 2, PackBits, palette, JPEG through
               Pillow) equal to Pillow's pixel digests; the georef phase's
               15000^2 ortho written as a tiled GeoTIFF (tiepoint and scale
               from its parameters), georeference from the cache on a
               text-file folder and on a folder holding only <loc>.tif: the
               converted PNG equal to the ortho, the parameters equal, the
               CSVs byte-equal, the conversion's host seconds
 16 multi      several ranks and several devices (parallel/mesh.py,
               tiling.py:make_tiled_detector) at full width: YOLOv8s nc=4
               at the preset's imgsz 1920, global batch 8, on the train
               phase's recipe (16 train and 8 val 3840x2160 PNGs, 36
               vehicles each), MULTI_STEPS steps: (a) in a process of its
               own under PyTorch's deterministic algorithms, the steps
               twice without a process group and once as the one rank of
               an NCCL group: weights and momentum bit-equal;
               (b) two ranks sharing the card through gloo (spawned, 4 rows
               each, each decoding only its own): weights bit-equal on both
               ranks (digests gathered), within MULTI_REL_TOL of (a); per
               rank step ms by CUDA events with the all-reduce, the
               loader's host ms, peak memory; (c) ``python -m
               geotrax_tpu_torch.train --devices <cards + 1>`` exits naming
               both counts, ``--devices 1`` writes every run file; (d)
               make_inference_step on 16 letterboxed 4K frames over
               [cuda:0] and [cuda:0, cuda:0], make_tiled_detector with 2
               tiles with and without devices: each pair bit-equal; (e)
               only with two cards or more: NCCL over min(4, cards) cards
               held as (b), (d) over the cards, and ``batch
               --parallel-videos 4 --devices <cards>`` through the lockstep
               equal to ``--devices 1``; else a line says (e) did not run
 17 tools      the port's tools as users run them (``python -m
               geotrax_tpu_torch.tools.<name>``'s main): (a) annotate_frames
               on TOOLS_IMAGES seeded 3840x2160 PNGs with 36 vehicles each,
               YOLOv8s nc=4 at the preset's imgsz 1920 (seeded, class biases
               calibrated as in the main phase on the first image, saved as
               .npz),
               without and with --augment, on the card and on the CPU: every
               label line with a partner on the other device (class equal,
               box within 1e-3 px, score within 1e-5, both plus the printed
               digits) unless its score sits at ``conf``; masked images
               written; the tool's detection ms per image; (b)
               benchmark_ortho_matching --synthetic-ortho 15000 at 250k
               features with rsift and orb (trials cut from 2 to 1; widths
               not cut): corner error, inliers, seconds and peak memory per
               registration, the rsift one within 3 px with 50 inliers; the
               FAST launches of the orb registration (through fast_detect),
               and the kernel exact against its plain version on the grays
               that path gave it; (c) where FFmpeg's libraries exist,
               merge_videos_and_logs and recut_video_and_log on two small
               clips, else one line saying the video tools did not run
 18 host-tools the host-only tools and the device filters: (a)
               ops/filters.py's gaussian_filter1d (sigma 14), savgol_filter
               (15) and gradient on a seeded (4096, 1800) float32 batch of
               tracks on the card against the CPU, with CUDA-event ms and
               bounds; (b) subset_orthophoto --crop-size 15000
               --scale-factor 0.5333333 on the card from a seeded 15000^2
               tiled GeoTIFF (written by io/tiff_tiled.py): the tool's run,
               then its host read, upload, downscale (CUDA events, against
               its bytes bound) and download; the cutout the tool wrote,
               read back from its PNG, equal to that downscale and a 2000^2
               window of it equal to the same downscale on the CPU; (c) the
               other fifteen host tools once each on seeded files: exit 0
               and their files present (figures are skipped, with a log
               line, where matplotlib is missing)
Then a JSON line describing each kernel, the card's nvidia-smi line, and as
the last line {"ok": true, "device": {...}}. ``--kernels-only`` serves to
time the kernels of two checkouts in one call: copy this script into the
other checkout and run it there too. ``--georef-only`` runs phases 0, 1 and
10, ``--lockstep-only`` phases 0, 1 and 12 with its own calibrated detector,
``--render-only`` phases 0, 1 and 13, ``--train-only`` phases 0, 1 and 14,
``--features-only`` phases 0, 1 and 15 with its own georef assets,
``--multi-only`` phases 0, 1 and 16, ``--tools-only`` phases 0, 1 and 17,
``--host-tools-only`` phases 0, 1 and 18 (no result line).
"""

from __future__ import annotations

import contextlib
import json
import logging
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from geotrax_tpu_torch import cfg as port_cfg
from geotrax_tpu_torch._device import resolve_device
from geotrax_tpu_torch.io.synthetic import SyntheticVideoReader
from geotrax_tpu_torch.models import rtdetr_ul, yolov8
from geotrax_tpu_torch.models.detector import Detector, OracleDetector
from geotrax_tpu_torch.ops import fast, features, patches
from geotrax_tpu_torch.ops.resize import resize_u8_linear
from geotrax_tpu_torch.pipeline import extract as port_extract
from geotrax_tpu_torch.pipeline.device_pipeline import FusedExtractor, embed_boxes
from geotrax_tpu_torch.track import reid

# H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth and float32
# rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# FAST per pixel: 2 threshold adds, then per ring sample 2 compares, a
# subtract, an abs and an add.
FAST_FLOPS_PER_PIXEL = 2 + 16 * 5

FAST_SOURCE = "geotrax_tpu_torch/csrc/fast_score.cu"
FAST_REPLACES = "geotrax_tpu/ops/pallas_fast.py:36"
PATCH_SOURCE = "geotrax_tpu_torch/csrc/patch_gather.cu"
PATCH_REPLACES = "geotrax_tpu/ops/pallas_patches.py:40"
# The ReID path's gather per 32-frame 4K chunk: 3 channel planes of each
# frame at half resolution, max_det = 1000 corners each.
PATCH_SHAPE = (96, 1080, 1920)
PATCH_CORNERS = 1000
# The float gather at each path's shape: describe's one (1080,1920) plane
# with 2000 keypoints (features), and a frame's (sequential), four frames'
# (lockstep) and a chunk's 3 channel planes at half resolution with 1000
# corners each, the shapes the ReID paths gathered on before the HWC entry.
PATCH_SHAPES = (((1, 1080, 1920), 2000), ((3, 1080, 1920), 1000), ((12, 1080, 1920), 1000),
                (PATCH_SHAPE, PATCH_CORNERS))

# Vehicles per 4K frame: the geo-trax detector's training set (Songdo
# Vision, upstream README) holds ~679k labelled vehicles in >19,000 aerial
# 4K images, about 36 per image. The random detector is calibrated to that
# many boxes per frame, scaled by frame area at other sizes.
VEHICLES_PER_4K_FRAME = 36
# Camera drift per frame (px right, px down, degrees, zoom factor): a
# hovering drone's slow drift, so that stabilization and GMC are not the
# identity.
CAMERA = (1.0, -0.5, 0.01, 1.0001)
STEADY_CHUNKS = 3


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def textured_batch(b: int, h: int, w: int, seed: int) -> np.ndarray:
    """Seeded aerial-like float32 gray frames (noise, blocks, lines)."""
    rng = np.random.default_rng(seed)
    img = rng.integers(40, 90, (b, h, w)).astype(np.float32)
    n_blocks = max(4, h * w // 800)
    ys = rng.integers(0, max(h - 16, 1), (b, n_blocks))
    xs = rng.integers(0, max(w - 16, 1), (b, n_blocks))
    hw = rng.integers(2, 16, (b, n_blocks, 2))
    val = rng.integers(120, 255, (b, n_blocks))
    for i in range(b):
        for y, x, (bh, bw), v in zip(ys[i], xs[i], hw[i], val[i]):
            img[i, y:y + bh, x:x + bw] = v
        for y in rng.integers(0, h, 4):
            img[i, y:y + 2, :] = 200
    return img


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def called_ms(fn, reps: int, samples: int = 5) -> float:
    """Ms of one call of ``fn`` as called (CUDA events around ``reps`` eager
    calls, the host's cost included): the median of ``samples`` such
    runs, since the host's share moves from run to run."""
    return float(np.median([cuda_ms(fn, reps) for _ in range(samples)]))


def fast_bound_ms(shape) -> tuple:
    """Least time of one FAST score map over ``shape`` on an H100: each
    input read once and each output written once, against the float32
    operations; returns (ms, "bytes" | "operations")."""
    pixels = int(np.prod(shape))
    bytes_ms = 2 * 4 * pixels / HBM_BYTES_PER_S * 1e3
    ops_ms = FAST_FLOPS_PER_PIXEL * pixels / FP32_FLOP_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("[smoke] device FAILED: torch.cuda.is_available() is False")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return {"name": name, "count": torch.cuda.device_count(),
            "smi": smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "not read"}


def phase_build() -> dict:
    """Both kernels, each by its own nvcc, and the host libraries of the
    TIFF reader and the exact assignment, each by its own g++, all started
    together; their logs (a g++ build's: the library's path)."""
    from geotrax_tpu_torch.io import native, tiff
    from geotrax_tpu_torch.ops.assignment import LAPJV_SOURCE

    modules = {"fast_score": fast, "patch_gather": patches}
    host = {"tiff.cpp": tiff.SOURCE, "lapjv.cpp": LAPJV_SOURCE}
    with ThreadPoolExecutor(len(modules) + len(host)) as pool:
        futures = {name: pool.submit(mod.build, verbose=True) for name, mod in modules.items()}
        built = {name: pool.submit(native.build_plain, src) for name, src in host.items()}
        return {**{name: fut.result()[1] for name, fut in futures.items()},
                **{name: f"g++ built {fut.result().name}" for name, fut in built.items()}}


def checkerboard(b: int, h: int, w: int, cell: int = 3) -> np.ndarray:
    """3-pixel cells: 4 of every 9 pixels are corners and nearly every pixel
    passes the kernel's cardinal test (its densest case)."""
    y, x = np.mgrid[:h, :w]
    board = ((x // cell + y // cell) % 2 * 255.0).astype(np.float32)
    return np.ascontiguousarray(np.broadcast_to(board, (b, h, w)))


def cardinal_pass_share(gray: torch.Tensor, thr: float) -> float:
    """Share of pixels that pass the FAST kernel's exact early test (two
    cyclically adjacent samples of ring positions 0, 4, 8, 12 all brighter
    than c + t, or all darker than c - t); the rest skip the full test."""
    p = torch.nn.functional.pad(gray, (3, 3, 3, 3))
    h, w = gray.shape[-2:]
    s0, s4, s8, s12 = (p[..., 3 + dy:3 + dy + h, 3 + dx:3 + dx + w]
                       for dx, dy in ((0, -3), (3, 0), (0, 3), (-3, 0)))
    hi, lo = gray + thr, gray - thr
    bright = ((s0 > hi) | (s8 > hi)) & ((s4 > hi) | (s12 > hi))
    dark = ((s0 < lo) | (s8 < lo)) & ((s4 < lo) | (s12 < lo))
    return float((bright | dark).float().mean())


def time_fast(gray: torch.Tensor, reps: int, thr: float = 20.0) -> dict:
    """The kernel's and the plain version's CUDA-event times on ``gray``,
    its bound, achieved rate and share of the bound, and the share of
    pixels that take the kernel's full test."""
    bound, bound_by = fast_bound_ms(tuple(gray.shape))
    ms = cuda_ms(lambda: fast.fast_score_map(gray, thr), reps)
    return {"ms": ms, "plain_ms": cuda_ms(lambda: fast.fast_score_map_torch(gray, thr),
                                          max(reps // 4, 2)),
            "bound_ms": bound, "bound_by": bound_by,
            "gb_per_s": 2 * 4 * gray.numel() / ms / 1e6, "share": bound / ms,
            "full_test_share": cardinal_pass_share(gray, thr)}


def phase_kernel(device: str = "cuda", check_shape=(33, 1080, 1920), odd_shape=(2, 37, 53),
                 time_shape=(32, 1080, 1920), reps: int = 20) -> dict:
    """FAST kernel == plain version (exactly) on seeded textured frames, an
    odd shape, a checkerboard and a constant image, and the times on seeded
    frames at the main path's shape. On the CPU (a rehearsal) the wrapper
    itself runs the plain version, so the comparison is trivial and nothing
    is timed."""
    dev = torch.device(device)
    max_err = 0.0
    inputs = (("textured", lambda: textured_batch(*check_shape, 1)),
              ("odd", lambda: textured_batch(*odd_shape, 2)),
              ("checkerboard", lambda: checkerboard(2, *check_shape[1:])),
              ("constant", lambda: np.full((2,) + tuple(check_shape[1:]), 77.0, np.float32)))
    for name, make in inputs:
        gray = torch.from_numpy(make()).to(dev)
        for thr in (20.0, 7.0):
            out = fast.fast_score_map(gray, thr)
            plain = fast.fast_score_map_torch(gray, thr)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            err = float((out - plain).abs().max())
            corners = int((plain > 0).sum())
            # a constant image has corners only where the ring reaches the
            # zero padding, within 3 px of its edge
            inner = int((plain[..., 3:-3, 3:-3] > 0).sum())
            if err != 0.0 or not torch.equal(out, plain) or corners == 0 or (
                    name == "constant" and inner != 0):
                raise AssertionError(f"FAST kernel != plain on {name} {tuple(gray.shape)} t={thr}: "
                                     f"max err {err}, {corners} corners")
            max_err = max(max_err, err)
        del gray, out, plain
    bound, bound_by = fast_bound_ms(time_shape)
    res = {"max_abs_err": max_err, "bound_ms": bound, "bound_by": bound_by,
           "ms": None, "plain_ms": None}
    if dev.type == "cuda":
        gray = torch.from_numpy(textured_batch(*time_shape, 3)).to(dev)
        res.update(time_fast(gray, reps))
    return res


def phase_kernel_on_path(frames, device: str = "cuda", reps: int = 20) -> dict:
    """The FAST kernel on the main path's own gray (the first chunk's
    frames, resized and converted as the chunk step does): exact against
    the plain version, and timed as on the seeded frames."""
    frames_t = torch.as_tensor(np.stack([f for _, f in frames])).to(device)
    h, w = frames_t.shape[1] // 2, frames_t.shape[2] // 2
    gray = features.rgb_to_gray(resize_u8_linear(frames_t, h, w)).contiguous()
    del frames_t
    out = fast.fast_score_map(gray, 20.0)
    if not torch.equal(out, fast.fast_score_map_torch(gray, 20.0)):
        raise AssertionError("FAST kernel != plain on the main path's gray")
    return time_fast(gray, reps) if device == "cuda" else {}


def seeded_planes(shape, seed: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.rand(shape, generator=gen, device=device) * 255.0


def seeded_corners(b: int, h: int, w: int, k: int, seed: int, device) -> tuple:
    """(B,K) int32 corners: out of range on every side, exactly at every
    edge (the first 8 of each plane), and inside."""
    rng = np.random.default_rng(seed)
    x0 = rng.integers(-48, w + 48, (b, k)).astype(np.int32)
    y0 = rng.integers(-48, h + 48, (b, k)).astype(np.int32)
    x0[:, :8] = [0, w - 32, -1, w - 31, 0, w - 32, -(2 ** 20), 2 ** 20]
    y0[:, :8] = [0, h - 32, h - 31, -1, h - 32, 0, 2 ** 20, -(2 ** 20)]
    return torch.from_numpy(x0).to(device), torch.from_numpy(y0).to(device)


def unfold_gather(planes: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor) -> torch.Tensor:
    """The same function as one PyTorch call: an advanced index on an
    unfold view (corners clamped first). A yardstick; the port never runs it."""
    h, w = planes.shape[-2:]
    b = torch.arange(planes.shape[0], device=planes.device)[:, None]
    return planes.unfold(1, 32, 1).unfold(2, 32, 1)[
        b, torch.clamp(y0.long(), 0, h - 32), torch.clamp(x0.long(), 0, w - 32)]


def covered_pixels(h: int, w: int, x0: torch.Tensor, y0: torch.Tensor) -> int:
    """Distinct pixels of (B,) h x w images that the (B,K) 32x32 patches at
    these corners (clamped) cover, by a 2-D difference array per image."""
    xs = torch.clamp(x0.long(), 0, w - 32)
    ys = torch.clamp(y0.long(), 0, h - 32)
    ones = torch.ones(x0.shape[1], dtype=torch.int32, device=x0.device)
    covered = 0
    for i in range(x0.shape[0]):
        d = torch.zeros((h + 1, w + 1), dtype=torch.int32, device=x0.device)
        for dy, dx, sign in ((0, 0, 1), (0, 32, -1), (32, 0, -1), (32, 32, 1)):
            d.index_put_((ys[i] + dy, xs[i] + dx), ones * sign, accumulate=True)
        inside = d.cumsum(0, dtype=torch.int32).cumsum(1, dtype=torch.int32)[:h, :w] > 0
        covered += int(inside.sum())
    return covered


def patch_bound_ms(planes: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor) -> tuple:
    """Least time of one gather on an H100: the patches written once, the
    distinct plane pixels they cover read once and the corners read once,
    over the memory rate (it does no arithmetic); returns (ms, "bytes",
    bytes moved)."""
    b, h, w = planes.shape
    k = x0.shape[1]
    moved = 4 * (b * k * 32 * 32 + covered_pixels(h, w, x0, y0) + 2 * b * k)
    return moved / HBM_BYTES_PER_S * 1e3, "bytes", moved


def hwc_bound_ms(image: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor, pool2: bool,
                 mean4: bool) -> tuple:
    """Least time of one HWC gather on an H100: the uint8 pixels the patches
    cover read once (each pooled pixel is 2x2 of them with ``pool2``, 3
    bytes each), the float32 patches or 4x4 means written once, the corners
    read once, over the memory rate; returns (ms, "bytes", bytes moved)."""
    c, h, w = image.shape[:3]
    f = 2 if pool2 else 1
    m = x0.shape[1]
    per_patch = 3 * (64 if mean4 else 32 * 32)
    moved = (3 * f * f * covered_pixels(h // f, w // f, x0, y0) + 4 * c * m * per_patch
             + 8 * c * m)
    return moved / HBM_BYTES_PER_S * 1e3, "bytes", moved


def graph_ms(fn, reps: int = 20, replays: int = 3) -> float:
    """Device ms of one call of ``fn``: ``reps`` calls captured in one CUDA
    graph and replayed, so that the host's cost of each call (the wrapper's
    checks and allocation, the ctypes call) stays out of the time. Each
    call's output is freed before the next, so the graph's pool holds one."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (replays * reps)


def in_turns(calls: dict, reps: int) -> dict:
    """Graph-timed ms of each call, taken twice in mirrored order (a, b, ...,
    ..., b, a); returns name -> mean of the two."""
    names = list(calls)
    ms = {name: [] for name in names}
    for name in names + names[::-1]:
        ms[name].append(graph_ms(calls[name], reps))
    return {name: sum(v) / 2 for name, v in ms.items()}


def time_gather(planes: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor, reps: int) -> dict:
    """The float gather's device ms and the unfold-gather's, in turns (CUDA
    graphs); the kernel's as called (``called_ms``: the wrapper's host cost
    included); the plain version's."""
    calls = {"ms": lambda: patches.patches32(planes, x0, y0),
             "library_ms": lambda: unfold_gather(planes, x0, y0)}
    res = in_turns(calls, reps)
    res["eager_ms"] = called_ms(calls["ms"], reps)
    res["plain_ms"] = cuda_ms(lambda: patches.patches32_torch(planes, x0, y0), max(reps // 4, 2))
    return res


def phase_patches(device: str = "cuda", shapes=PATCH_SHAPES, odd_shape=(2, 37, 53),
                  odd_k: int = 130, reps: int = 20) -> dict:
    """The float patch gather == its plain version (exactly), and so is the
    unfold-gather: on an odd (2,37,53) x 130 case (4W not a multiple of 16
    bytes: the register path) and at each path's shape (TMA) with seeded
    planes and corners out of range, at every edge and inside; at each
    path's shape the times of ``time_gather`` and the bound. On the CPU (a
    rehearsal) nothing is timed."""
    dev = torch.device(device)
    res = {"max_abs_err": 0.0, "shapes": []}
    for i, (shape, k) in enumerate(((odd_shape, odd_k),) + tuple(shapes)):
        planes = seeded_planes(shape, 4 + i, dev)
        x0, y0 = seeded_corners(shape[0], shape[1], shape[2], k, 4 + i, dev)
        plain = patches.patches32_torch(planes, x0, y0)
        outs = {"kernel": patches.patches32(planes, x0, y0),
                "unfold-gather": unfold_gather(planes, x0, y0)}
        if dev.type == "cuda":
            torch.cuda.synchronize()
        for name, out in outs.items():
            if not torch.equal(out, plain):
                raise AssertionError(f"patch gather ({name}) != plain at {shape} x {k}: max err "
                                     f"{float((out - plain).abs().max())}")
        del outs, plain
        if shape == odd_shape:
            continue
        row = {"shape": shape, "corners": k}
        row["bound_ms"], row["bound_by"], row["bytes"] = patch_bound_ms(planes, x0, y0)
        if dev.type == "cuda":
            row.update(time_gather(planes, x0, y0, reps))
        res["shapes"].append(row)
        del planes, x0, y0
    return res


def unfold_gather_hwc(image: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor, pool2: bool,
                      mean4: bool) -> torch.Tensor:
    """The HWC gather in a few PyTorch calls: an advanced index on an unfold
    view of the uint8 image (64x64 windows at stride 2 with ``pool2``), then
    ``.float()`` and the 2x2 and 4x4 means as reshape-sums. A yardstick; the
    port never runs it."""
    c, h, w = image.shape[:3]
    f = 2 if pool2 else 1
    hp, wp = h // f, w // f
    m = x0.shape[1]
    win = image[:, :hp * f, :wp * f].unfold(1, 32 * f, f).unfold(2, 32 * f, f)
    ci = torch.arange(c, device=image.device)[:, None]
    out = win[ci, torch.clamp(y0.long(), 0, hp - 32), torch.clamp(x0.long(), 0, wp - 32)].float()
    if pool2:
        out = out.reshape(c, m, 3, 32, 2, 32, 2).sum(dim=(4, 6)) * 0.25
    if mean4:
        out = out.reshape(c, m, 3, 8, 4, 8, 4).mean(dim=(4, 6))
    return out


def hwc_kernel_check(g: dict, reps: int) -> dict:
    """The HWC gather on one path's own inputs (``g``: what ``embed_boxes``
    handed its gather): the kernel and the unfold yardstick each equal to
    the plain version exactly; on the card their device ms in turns (CUDA
    graphs), the kernel as called, the memory it takes, the plain version's
    ms and the bound."""
    args = (g["image"], g["x0"], g["y0"], g["pool2"], g["mean4"])
    calls = {"ms": lambda: patches.patches32_hwc(*args),
             "library_ms": lambda: unfold_gather_hwc(*args)}
    plain = patches.patches32_hwc_torch(*args)
    for name, call in (("kernel", calls["ms"]), ("unfold", calls["library_ms"])):
        out = call()
        if not torch.equal(out, plain):
            err = float((out - plain).abs().max())
            raise AssertionError(f"HWC gather ({name}) != plain on {tuple(g['image'].shape)} "
                                 f"x {g['x0'].shape[1]}: max err {err}")
        del out
    del plain
    res = {"shape": tuple(g["image"].shape), "corners": int(g["x0"].shape[1]),
           "pool2": g["pool2"], "mean4": g["mean4"], "max_abs_err": 0.0}
    res["bound_ms"], res["bound_by"], res["bytes"] = hwc_bound_ms(*args)
    if g["image"].device.type == "cuda":
        res["kernel_gib"] = extra_memory_gib(calls["ms"])
        res.update(in_turns(calls, reps))
        res["eager_ms"] = called_ms(calls["ms"], reps)
        res["plain_ms"] = cuda_ms(lambda: patches.patches32_hwc_torch(*args), max(reps // 4, 2))
    return res


def extra_memory_gib(fn) -> float:
    """GiB that one call of ``fn`` holds at its peak beyond what was
    allocated before it (resets the card's peak-memory counter)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**30


def hwc_recorder(seen: dict):
    """A ``gather`` for embed_boxes that runs the plain version and keeps
    its inputs in ``seen``."""
    def plain_gather(image, x0, y0, pool2, mean4):
        seen.update(image=image, x0=x0, y0=y0, pool2=pool2, mean4=mean4)
        return patches.patches32_hwc_torch(image, x0, y0, pool2, mean4)
    return plain_gather


def hwc_text(k: dict) -> str:
    """One path's HWC gather numbers for a phase's line."""
    text = (f"patches32_hwc {k['shape']} x {k['corners']} pool2={k['pool2']} mean4={k['mean4']} "
            f"exact (kernel, unfold)")
    if "ms" in k:
        text += (f": kernel {k['ms']:.4f} ms ({100 * k['bound_ms'] / k['ms']:.1f}% of the bound "
                 f"{k['bound_ms']:.4f} ms, {k['bytes'] / 1e6:.1f} MB), as called "
                 f"{k['eager_ms']:.4f}, unfold-gather {k['library_ms']:.4f}, plain "
                 f"{k['plain_ms']:.3f}; memory beyond the inputs {k['kernel_gib']:.3f} GiB")
    return text


def calibrate_class_bias(detector: Detector, frame_u8: np.ndarray, boxes: int) -> int:
    """Shift the class-score biases of a randomly initialized detector so that
    about ``boxes`` anchors of ``frame_u8`` score at or above the confidence
    threshold; returns the number of detections NMS then keeps on that frame.

    A random YOLOv8 scores every anchor at about 0.5 (its class logits
    spread by ~0.01), so all of them pass ``conf`` and the 1000 kept boxes
    mask the whole frame out of the stabilizer."""
    h, w = frame_u8.shape[:2]
    new_h, new_w, _, top, left, out_h, out_w = detector.resize_geometry(h, w)
    x = torch.as_tensor(frame_u8[None]).to(detector.device)
    imgs = yolov8.letterbox_pad(resize_u8_linear(x, new_h, new_w), out_h, out_w, top, left)
    with torch.no_grad():
        _, probs = yolov8.forward(detector.model, imgs, detector.spec)
        logits = torch.logit(probs.amax(dim=-1).double()).flatten()
        kth = float(torch.topk(logits, boxes).values[-1])
        shift = math.log(detector.conf / (1.0 - detector.conf)) - kth + 1e-6
        head = detector.model.layers[str(detector.spec.head_index)]
        for branch in head.cv3:
            branch[2].bias += shift
    return int(detector.batch_trace(h, w)(x)["valid"].sum())


def vehicles_per_frame(width: int, height: int) -> int:
    return max(1, round(VEHICLES_PER_4K_FRAME * width * height / (3840 * 2160)))


def smoke_reader(width: int, height: int, seed: int, horizon: int, start: int = 0,
                 stop=None, boxes=None) -> SyntheticVideoReader:
    """Frames ``start..stop-1`` of one ``horizon``-frame video seen by the
    drifting camera (the same video whatever the slice), with the reader's
    two rectangles or ``boxes`` (``vehicle_boxes``)."""
    return SyntheticVideoReader(width=width, height=height, n_frames=horizon, seed=seed,
                                camera=CAMERA, start=start, stop=stop, boxes=boxes)


def vehicle_boxes(width: int, height: int, n: int, seed: int) -> list:
    """``n`` seeded vehicle-sized rectangles (about 100x40 px at 4K, scaled
    with the frame) moving at up to 3 px per frame: the reader's boxes."""
    rng = np.random.default_rng(seed)
    scale = width / 3840
    out = []
    for _ in range(n):
        w, h = rng.uniform(70, 130) * scale, rng.uniform(30, 50) * scale
        out.append({"xy0": (float(rng.uniform(w, width - w)), float(rng.uniform(h, height - h))),
                    "v": tuple(float(v) for v in rng.uniform(-3, 3, 2)),
                    "wh": (int(w), int(h)),
                    "color": tuple(int(c) for c in rng.integers(100, 256, 3))})
    return out


def make_frames(reader: SyntheticVideoReader) -> list:
    """All (index, frame) pairs of ``reader``, made on the host's cores
    before anything is timed (a 4K frame takes about half a second alone)."""
    indices = range(reader.start, reader.stop)
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        return list(zip(indices, pool.map(reader.frame, indices)))


def write_y4m(path, frames, width: int, height: int, fps: int = 25) -> None:
    """(index, RGB frame) pairs -> a raw YUV 4:4:4 ``.y4m`` clip (BT.601,
    studio range), written in plain numpy."""
    with open(path, "wb") as fh:
        fh.write(f"YUV4MPEG2 W{width} H{height} F{fps}:1 Ip A1:1 C444\n".encode())
        for _, frame in frames:
            rgb = frame.astype(np.float32)
            r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
            y = 16.0 + (65.481 * r + 128.553 * g + 24.966 * b) / 255.0
            cb = 128.0 + (-37.797 * r - 74.203 * g + 112.0 * b) / 255.0
            cr = 128.0 + (112.0 * r - 93.786 * g - 18.214 * b) / 255.0
            fh.write(b"FRAME\n")
            fh.write(np.clip(np.rint(y), 0, 255).astype(np.uint8).tobytes())
            for c in (cb, cr):
                fh.write(np.clip(np.rint(c), 0, 255).astype(np.uint8).tobytes())


class FrameList:
    """A frame source over (index, frame) pairs already in memory."""

    def __init__(self, info, frames):
        self.info, self.frames = info, frames

    def __iter__(self):
        return iter(self.frames)


def smoke_config(imgsz: int, tracker_overrides=None) -> dict:
    config = port_cfg.load_config()
    config["ultralytics"]["imgsz"] = imgsz
    config["tracker"]["botsort"].update(tracker_overrides or {})
    return config


def build_extractor(device: str, width: int, height: int, variant: str, imgsz: int, seed: int,
                    chunk: int, first_frame: np.ndarray):
    config = smoke_config(imgsz)
    spec = yolov8.ModelSpec(variant=variant, nc=4)
    model = yolov8.init_params(torch.Generator().manual_seed(seed), spec, device=device)
    detector = Detector(model, config["ultralytics"], device=device)
    n_det = calibrate_class_bias(detector, first_frame, vehicles_per_frame(width, height))
    return config, build_fused(config, detector, height, width, chunk, seed, device), n_det


def build_fused(config: dict, detector, height: int, width: int, chunk: int, seed: int,
                device: str) -> FusedExtractor:
    """The extract stage's tracker and chunk step for ``config``."""
    tracker_cfg, state, step, reid_params = port_extract.make_extract_tracker(config, device=device)
    return port_extract.make_fused_extractor(config, detector, tracker_cfg, state, step, height,
                                             width, reid_params, chunk=chunk, rng_seed=seed,
                                             device=device)


def camera_error(h: np.ndarray, frame_ids, reader: SyntheticVideoReader) -> float:
    """Largest distance [px] between where each frame's homography and the
    camera's true one map the frame's corners and centre."""
    w, hh = reader.info.width, reader.info.height
    pts = np.array([[0, 0, 1], [w, 0, 1], [0, hh, 1], [w, hh, 1], [w / 2, hh / 2, 1]], float)

    def mapped(m):
        q = pts @ m.T
        return q[:, :2] / q[:, 2:]

    return max(float(np.abs(mapped(hf) - mapped(reader.camera_h(i))).max())
               for hf, i in zip(h, frame_ids))


def check_homographies(h: np.ndarray, frame_ids, reader: SyntheticVideoReader,
                       tol_px: float) -> float:
    """Every homography finite and within ``tol_px`` of the camera's at the
    frame's corners and centre; returns the largest deviation."""
    if not np.isfinite(h).all():
        raise AssertionError("homographies are not finite")
    err = camera_error(h, frame_ids, reader)
    if err > tol_px:
        raise AssertionError(f"stabilization is {err:.3f} px off the camera's homography "
                             f"(limit {tol_px} px)")
    return err


# The top-level keys of the reference's run metadata (save_results), in order.
METADATA_KEYS = ["geotrax_tpu_version", "video", "runtime", "config", "args"]


def check_files(tracks_file, transforms_file, metadata_file, n_frames: int,
                reader: SyntheticVideoReader, tol_px: float, may_lack_tracks: bool = False) -> dict:
    """Hold the files of one extract run to the contract: the tracks file is
    the post-processed table of 14 columns (12 finite ones, then each
    track's length and width, NaN where no row of the track qualified),
    tracks of fewer than ``min_track_length`` rows removed; the transforms
    file has frames 1..n-1, each homography within ``tol_px`` of the
    camera's true one at the frame's corners; the metadata file, where one
    was asked for, has the reference's top-level keys. With
    ``may_lack_tracks`` a run that kept no track (and so wrote no tracks
    file) passes the other checks alone."""
    transf = np.loadtxt(transforms_file, delimiter=",", ndmin=2)
    if may_lack_tracks and not Path(tracks_file).exists():
        tracks = np.empty((0, 14))
        res = {"rows": 0}
    else:
        tracks = np.loadtxt(tracks_file, delimiter=",", ndmin=2)
        res = check_tracks(tracks, n_frames)
    if transf.shape != (n_frames - 1, 10) or not np.isfinite(transf).all():
        raise AssertionError(f"transforms file: shape {transf.shape}")
    if not np.array_equal(transf[:, 0], np.arange(1, n_frames)):
        raise AssertionError("transforms file: frame numbers are not 1..n-1")
    res["camera_err_px"] = check_homographies(transf[:, 1:].reshape(-1, 3, 3),
                                              range(1, n_frames), reader, tol_px)
    if metadata_file is not None:
        keys = [line.split(":")[0] for line in Path(metadata_file).read_text().splitlines()
                if line and not line[0].isspace() and not line.startswith("-")]
        if keys != METADATA_KEYS:
            raise AssertionError(f"metadata file: top-level keys {keys}, expected {METADATA_KEYS}")
        res["metadata_keys"] = keys
    return res


def check_tracks(tracks: np.ndarray, n_frames: int) -> dict:
    """The post-processed tracks table of a stabilized run."""
    if tracks.shape[1] != 14 or len(tracks) == 0 or not np.isfinite(tracks[:, :12]).all():
        raise AssertionError(f"tracks file: shape {tracks.shape}")
    dims = tracks[:, 12:]
    if not ((np.isfinite(dims) & (dims > 0)) | np.isnan(dims)).all():
        raise AssertionError("tracks file: dimension columns neither positive nor NaN")
    ids, first, counts = np.unique(tracks[:, 1], return_index=True, return_counts=True)
    if counts.min() < port_cfg.DEFAULT["extraction"]["min_track_length"]:
        raise AssertionError(f"tracks file: a track of {counts.min()} rows was kept")
    frames = np.unique(tracks[:, 0])
    if frames.min() < 0 or frames.max() >= n_frames or (tracks[:, 1] < 1).any():
        raise AssertionError("tracks file: frame or id out of range")
    return {"rows": int(len(tracks)), "tracks": int(len(ids)), "frames_with_tracks": int(len(frames)),
            "tracks_with_dims": int(np.isfinite(dims[first, 0]).sum())}


def check_outputs(stats: dict, n_frames: int, reader: SyntheticVideoReader,
                  tol_px: float) -> dict:
    """The run's stats and files: h[0] (the reference frame) is the
    identity, every frame stabilizes (>= 4 matches), and the files hold to
    ``check_files``."""
    h = stats["h"]
    if h.shape != (n_frames, 3, 3):
        raise AssertionError(f"homographies: shape {h.shape}")
    if not np.array_equal(h[0], np.eye(3, dtype=h.dtype)):
        raise AssertionError(f"h[0] (the reference frame) is not the identity: {h[0]}")
    failed = int((stats["matches"][1:] < 4).sum())
    if failed:
        raise AssertionError(f"stabilization failed on {failed} frames")
    res = check_files(stats["tracks_file"], stats["transforms_file"], stats.get("metadata_file"),
                      n_frames, reader, tol_px)
    res.update(rows_raw=int(stats["n_rows_raw"]), min_matches=int(stats["matches"][1:].min()),
               min_inliers=int(stats["inliers"][1:].min()))
    return res


def phase_main(device: str = "cuda", width: int = 3840, height: int = 2160, n_frames: int = 64,
               chunk: int = 32, variant: str = "s", imgsz: int = 1920, seed: int = 0,
               horizon=None, tol_px: float = 2.0) -> dict:
    """The port's default extract path, driven through its entry points,
    over the first ``n_frames`` of a ``horizon``-frame video (the frames are
    made first and kept for the ReID phase; ``setup_s`` includes them)."""
    t0 = time.perf_counter()
    horizon = horizon or n_frames
    reader = smoke_reader(width, height, seed, horizon, stop=n_frames)
    frames = make_frames(reader)
    config, fx, n_det = build_extractor(device, width, height, variant, imgsz, seed, chunk,
                                        frames[0][1])
    setup_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        source = Path(tmp) / "V_smoke.mp4"  # the metadata goes beside it; never read
        stats = port_extract.extract(FrameList(reader.info, frames), fx, Path(tmp) / "results",
                                     source.stem, config=config, chunk=chunk, source=source,
                                     args={"source": source, "cfg": "default"})
        if device == "cuda":
            torch.cuda.synchronize()
        checks = check_outputs(stats, n_frames, reader, tol_px)
        if "metadata_keys" not in checks:
            raise AssertionError("the extract wrote no metadata file")
    return {"setup_s": setup_s, "stats": stats, "checks": checks, "fx": fx,
            "detections_frame0": n_det, "horizon": horizon, "frames": frames,
            "reader": reader}


def phase_steady(fx, width: int, height: int, seed: int, horizon: int, start: int,
                 chunk: int = 32, n_chunks: int = STEADY_CHUNKS, tol_px: float = 2.0) -> dict:
    """``n_chunks`` more chunks of the same video through the same
    extractor (tracker state and reference frame carried on), with the
    tracks and transforms rows checked; ms per chunk as the row emitter
    measures it (chunk step plus the copy of its outputs to the host). The
    first chunk's frames are kept for the ReID phase."""
    reader = smoke_reader(width, height, seed, horizon, start, start + n_chunks * chunk)
    frames = make_frames(reader)
    tracks, transforms, stats = port_extract.track_video_fused(FrameList(reader.info, frames), fx,
                                                               chunk=chunk)
    if stats["chunks"] != n_chunks or stats["frames"] != n_chunks * chunk:
        raise AssertionError(f"steady run: {stats['chunks']} chunks, {stats['frames']} frames")
    if tracks.shape[1] != 12 or not np.isfinite(tracks).all() or len(transforms) != stats["frames"]:
        raise AssertionError(f"steady run: tracks {tracks.shape}, transforms {transforms.shape}")
    cam_err = check_homographies(stats["h"], range(start, start + stats["frames"]), reader, tol_px)
    ms = np.asarray(stats["chunk_s"]) * 1e3
    return {"chunk_ms": ms.tolist(), "median_ms": float(np.median(ms)), "min_ms": float(ms.min()),
            "max_ms": float(ms.max()), "camera_err_px": cam_err, "rows": int(len(tracks)),
            "frames": frames[:chunk]}


REFERENCE_TRACKERS = (
    ("botsort", {}),
    ("botsort", {"with_reid": True}),
    ("deepocsort", {"with_reid": True}),
    ("tracktrack", {"with_reid": True}),
    ("ocsort", {}),
    ("fasttrack", {}),
)


def phase_reference(device: str = "cuda", n_frames: int = 16, chunk: int = 8,
                    trackers=REFERENCE_TRACKERS) -> dict:
    """The port on ``device`` against the port on the CPU (plain versions),
    on a small oracle clip with a moving camera, for each tracker of
    ``trackers`` ((name, overrides of its default block)): same track ids,
    geometry (boxes and dimensions) within 0.05 px."""
    results = {}
    for name, overrides in trackers:
        runs = []
        for dev in (device, "cpu"):
            reader = SyntheticVideoReader(width=320, height=240, n_frames=n_frames,
                                          camera=(0.5, -0.3, 0.2, 1.002))
            det = OracleDetector(lambda i, r=reader: [list(b) + [0.9, i % 2] for b in r.boxes_at(i)],
                                 device=dev)
            config = port_cfg.load_config()
            config["tracker"]["active"] = name
            config["tracker"][name].update(overrides)
            tracker_cfg, state, step, head = port_extract.make_extract_tracker(config, device=dev)
            fx = port_extract.make_fused_extractor(config, det, tracker_cfg, state, step, 240, 320,
                                                   head, chunk=chunk, device=dev)
            with tempfile.TemporaryDirectory() as tmp:
                stats = port_extract.extract(reader, fx, tmp, "V_ref", config=config, chunk=chunk)
                runs.append((np.loadtxt(stats["tracks_file"], delimiter=",", ndmin=2),
                             np.loadtxt(stats["transforms_file"], delimiter=",", ndmin=2)))
        (t_dev, h_dev), (t_cpu, h_cpu) = runs
        label = name + ("+reid" if overrides.get("with_reid") else "")
        if len(t_dev) == 0 or t_dev.shape != t_cpu.shape or not np.array_equal(
                t_dev[:, [0, 1, 10, 11]], t_cpu[:, [0, 1, 10, 11]]):
            raise AssertionError(f"{label}: track rows differ: {t_dev.shape} vs {t_cpu.shape}")
        if not np.array_equal(np.isnan(t_dev), np.isnan(t_cpu)):
            raise AssertionError(f"{label}: dimensions are NaN in other rows")
        box_err = float(np.nanmax(np.abs(t_dev[:, 2:14] - t_cpu[:, 2:14])))
        h_err = float(np.abs(h_dev - h_cpu).max())
        if box_err > 0.05 or h_err > 0.05:
            raise AssertionError(f"{label}: geometry differs: boxes {box_err} px, H {h_err}")
        results[label] = {"rows": int(len(t_dev)), "tracks": int(len(np.unique(t_dev[:, 1]))),
                          "box_err": box_err, "h_err": h_err}
    return results


def embedding_checks(fx, seen, frames, gather_check: bool = True) -> dict:
    """The embeddings the tracker was given over one chunk (``seen``: the
    (boxes, valid, det_emb) of each step): unit norm for the valid
    detections and, with ``gather_check``, equal within 1e-5 to the same
    embedding computed with the plain gather on the same device."""
    boxes = torch.stack([b for b, _, _ in seen])
    valid = torch.stack([v for _, v, _ in seen])
    emb = torch.stack([e for _, _, e in seen])
    if emb.shape[:2] != boxes.shape[:2] or not bool(torch.isfinite(emb).all()) or not bool(valid.any()):
        raise AssertionError(f"embeddings: shape {tuple(emb.shape)}, {int(valid.sum())} valid")
    norm_err = float((torch.linalg.vector_norm(emb[valid], dim=-1) - 1.0).abs().max())
    if norm_err > 1e-5:
        raise AssertionError(f"embeddings of valid detections are {norm_err} off unit norm")
    res = {"valid": int(valid.sum()), "norm_err": norm_err, "emb": emb}
    if gather_check:
        frames_t = torch.as_tensor(np.stack([f for _, f in frames])).to(emb.device)
        half = (frames_t.shape[1] // 2, frames_t.shape[2] // 2)
        pooled = resize_u8_linear(frames_t, *half) if fx._resize_geom == half else None
        gathered = {}
        plain = embed_boxes(frames_t, boxes, pooled=pooled, head_params=fx.reid_params,
                            gather=hwc_recorder(gathered))
        res["plain_err"] = float((emb - plain).abs().max())
        if res["plain_err"] > 1e-5:
            raise AssertionError(f"embeddings differ from the plain gather's by {res['plain_err']}")
        # the chunk's own gather, exact and timed alone (after the launch
        # counts were read), and its embedding as called
        res["gather"] = hwc_kernel_check(gathered, 10)
        if emb.device.type == "cuda":
            res["embed_ms"] = cuda_ms(lambda: embed_boxes(frames_t, boxes, pooled=pooled,
                                                          head_params=fx.reid_params), 5)
    return res


def reid_extractor(config: dict, detector, height: int, width: int, chunk: int, seed: int,
                   device: str) -> tuple:
    """The extract stage's tracker and extractor for ``config``, with the
    tracker step wrapped to record what each step is given."""
    tracker_cfg, state, step, head = port_extract.make_extract_tracker(config, device=device)
    if not tracker_cfg.with_reid:
        raise AssertionError("the tracker was built without ReID")
    seen = []

    def recording_step(st, boxes, scores, cls, valid, fid, gmc_h=None, det_emb=None):
        seen.append((boxes, valid, det_emb))
        return step(st, boxes, scores, cls, valid, fid, gmc_h, det_emb)

    fx = port_extract.make_fused_extractor(config, detector, tracker_cfg, state, recording_step,
                                           height, width, head, chunk=chunk, rng_seed=seed,
                                           device=device)
    return fx, head, seen


def chunks_in_turns(extractors: dict, frames, info, chunk: int) -> dict:
    """ms per chunk of each extractor (name -> fresh FusedExtractor) over
    the same held chunks, taken in turns (AB, BA, AB, ...), as the row
    emitter measures a chunk."""
    names = list(extractors)
    ms = {name: [] for name in names}
    for i in range(len(frames) // chunk):
        part = FrameList(info, frames[i * chunk:(i + 1) * chunk])
        for name in (names if i % 2 == 0 else names[::-1]):
            _, _, stats = port_extract.track_video_fused(part, extractors[name], chunk=chunk)
            ms[name].append(stats["chunk_s"][0] * 1e3)
    return ms


def phase_reid(detector, frames, timed_frames, reader, device: str = "cuda", imgsz: int = 1920,
               chunk: int = 32, seed: int = 0, tol_px: float = 2.0) -> dict:
    """The default extract configuration with tracker.botsort.with_reid:
    true, on frames already made (``frames`` from the video's start,
    ``timed_frames`` right after them) with the main phase's detector."""
    info = reader.info
    height, width = info.height, info.width
    n = len(frames)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    config = smoke_config(imgsz, {"with_reid": True})
    fx, head, seen = reid_extractor(config, detector, height, width, chunk, seed, device)
    if head is not None:
        raise AssertionError("model: auto loaded a learned head")
    with tempfile.TemporaryDirectory() as tmp:
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        fast.fast_score_map.launches = 0
        patches.patches32.launches = 0
        stats = port_extract.extract(FrameList(info, frames), fx, tmp, "V_reid", config=config,
                                     chunk=chunk)
        sync()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30 if device == "cuda" else None
        launches = {"fast_score": fast.fast_score_map.launches,
                    "patch_gather": patches.patches32.launches}
        checks = check_outputs(stats, n, reader, tol_px)
    # on the CPU (a rehearsal) the wrappers run the plain versions: no launch
    on_card = device == "cuda"
    if launches != {"fast_score": (stats["chunks"] + 1) * on_card,
                    "patch_gather": stats["chunks"] * on_card}:
        raise AssertionError(f"kernel launches on the ReID path: {launches} over "
                             f"{stats['chunks']} chunks")
    emb = embedding_checks(fx, seen[:chunk], frames[:chunk])
    projection = emb.pop("emb")

    # one more chunk of the same video, timed
    tracks, _, tstats = port_extract.track_video_fused(FrameList(info, timed_frames), fx,
                                                       chunk=chunk)
    if tstats["chunks"] != 1 or tracks.shape[1] != 12 or not np.isfinite(tracks).all():
        raise AssertionError(f"timed ReID chunk: {tstats['chunks']} chunks, tracks {tracks.shape}")
    timed_err = check_homographies(tstats["h"], [i for i, _ in timed_frames], reader, tol_px)

    # the same held chunks without and with ReID, in turns, on fresh extractors
    turns = chunks_in_turns(
        {"plain": build_fused(smoke_config(imgsz), detector, height, width, chunk, seed, device),
         "reid": reid_extractor(config, detector, height, width, chunk, seed, device)[0]},
        frames + timed_frames, info, chunk)

    # a learned head, made from a seed, saved and loaded as a user's would be
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "reid_head.npz"
        reid.save_head(path, reid.init_head(torch.Generator().manual_seed(seed)))
        config_h = smoke_config(imgsz, {"with_reid": True, "model": str(path)})
        fx_h, head, seen_h = reid_extractor(config_h, detector, height, width, chunk, seed, device)
        if head is None:
            raise AssertionError(f"resolve_head did not load {path}")
        patches.patches32.launches = 0
        stats_h = port_extract.extract(FrameList(info, frames[:chunk]), fx_h, tmp, "V_head",
                                       config=config_h, chunk=chunk)
        sync()
        head_launches = patches.patches32.launches
        checks_h = check_outputs(stats_h, chunk, reader, tol_px)
    if head_launches != on_card:
        raise AssertionError(f"patch gather launched {head_launches} times for one head chunk")
    emb_h = embedding_checks(fx_h, seen_h[:chunk], frames[:chunk])
    head_vs_projection = float((emb_h.pop("emb") - projection).abs().max())
    if head_vs_projection < 0.1:
        raise AssertionError("the learned head's embeddings equal the projection's")
    return {"stats": stats, "checks": checks, "launches": launches, "emb": emb,
            "peak_gib": peak_gib, "timed_ms": tstats["chunk_s"][0] * 1e3,
            "timed_camera_err_px": timed_err,
            "timed_rows": int(len(tracks)), "turns": turns,
            "turn_diff_ms": float(np.median(np.subtract(turns["reid"], turns["plain"]))),
            "head_checks": checks_h, "head_emb": emb_h,
            "head_ms": stats_h["chunk_s"][0] * 1e3, "head_vs_projection": head_vs_projection}


def same_detections(a: dict, b: dict) -> float:
    """Equal valid slots and classes; returns the largest difference of the
    valid boxes and scores."""
    if not (torch.equal(a["valid"], b["valid"]) and torch.equal(a["classes"], b["classes"])):
        raise AssertionError("the detections differ in their valid slots or classes")
    v = a["valid"]
    if not bool(v.any()):
        return 0.0
    return max(float((a["boxes_xywh"][v] - b["boxes_xywh"][v]).abs().max()),
               float((a["scores"][v] - b["scores"][v]).abs().max()))


def cli_args(source, cfg: str, model, device: str, **extra):
    """The arguments ``python -m geotrax_tpu_torch extract`` parses."""
    return port_extract.parse_cli_args(
        [str(source), "-m", str(model), "-c", cfg, "--device", device, *extra.get("argv", [])])


def driver_turns(config: dict, detector, frames, info, chunk: int, device: str,
                 rounds: int) -> dict:
    """ms per chunk (wall time of the whole run over the chunks) of the
    double-buffered driver and of the serial loop on the same frames, taken
    in turns (pipelined, serial, serial, pipelined, ...), each on its own
    extractor reset between runs; their rows must be equal bit for bit."""
    fxs = {mode: build_fused(config, detector, info.height, info.width, chunk, 0, device)
           for mode in ("pipelined", "serial")}
    ms = {mode: [] for mode in fxs}
    rows = {}
    for r in range(rounds):
        for mode in (("pipelined", "serial") if r % 2 == 0 else ("serial", "pipelined")):
            fxs[mode].reset()
            tracks, transforms, stats = port_extract.track_video_fused(
                FrameList(info, frames), fxs[mode], chunk=chunk, pipelined=mode == "pipelined")
            ms[mode].append(stats["wall_s"] * 1e3 / stats["chunks"])
            rows.setdefault(mode, (tracks, transforms))
    (pt, ph), (st, sh) = rows["pipelined"], rows["serial"]
    if not (np.array_equal(pt, st) and np.array_equal(ph, sh)):
        raise AssertionError("the double-buffered driver's rows differ from the serial loop's")
    return {"ms": ms, "rows": int(len(pt))}


def phase_cli(detector, frames, reader, device: str = "cuda", chunk: int = 32,
              tol_px: float = 2.0, turn_frames=None, turn_rounds: int = 2) -> dict:
    """``extract`` as a user runs it: the main phase's calibrated detector
    saved as ``.npz`` and ``.pt`` and loaded back (equal detections on frame
    0), then ``run_extraction`` with ``-m <ckpt.npz> -c default`` on the
    main phase's frames. With FFmpeg's headers and libraries (the decode
    probe), the port's decoder is built, the frames are written as a
    ``.y4m`` clip and ``python -m geotrax_tpu_torch extract`` decodes it in
    a subprocess; without them ``open_reader`` is replaced by the frames in
    memory, as the reference's tests replace it. Then the double-buffered
    driver and the serial loop in turns."""
    from geotrax_tpu_torch.io import native
    from geotrax_tpu_torch.models import convert

    info = reader.info
    n = len(frames)
    res = {"probe": native.probe()}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        names = {0: "car", 1: "bus", 2: "truck", 3: "motorcycle"}
        convert.save_npz(tmp / "ckpt.npz", detector.model, class_names=names)
        convert.save_pt(tmp / "ckpt.pt", detector.model, class_names=names)
        frame0 = torch.as_tensor(frames[0][1][None]).to(detector.device)
        dets = {suffix: Detector(tmp / f"ckpt.{suffix}", smoke_config(detector.imgsz)["ultralytics"],
                                 device=device).batch_trace(info.height, info.width)(frame0)
                for suffix in ("npz", "pt")}
        in_memory = detector.batch_trace(info.height, info.width)(frame0)
        res["npz_vs_memory"] = same_detections(dets["npz"], in_memory)
        res["pt_vs_npz"] = same_detections(dets["pt"], dets["npz"])
        res["detections"] = int(dets["npz"]["valid"].sum())
        if res["npz_vs_memory"] != 0.0 or res["pt_vs_npz"] > 1e-3:
            raise AssertionError(f"checkpoint detections differ: {res}")

        cfg = "default"
        if detector.imgsz != port_cfg.DEFAULT["ultralytics"]["imgsz"]:  # a rehearsal's size
            cfg = str(tmp / "default_copy.yaml")
            text = (port_cfg.CFG_DIR / "default.yaml").read_text()
            Path(cfg).write_text(text.replace("  imgsz: 1920\n", f"  imgsz: {detector.imgsz}\n"))
        source = tmp / "V_cli.mp4"
        args = cli_args(source, cfg, tmp / "ckpt.npz", device)
        replaced = port_extract.open_reader
        port_extract.open_reader = lambda src, start, stop, config: FrameList(info, frames)
        fast.fast_score_map.launches = 0
        try:
            t0 = time.perf_counter()
            stats = port_extract.run_extraction(args, port_extract._LOG)
            res["run_s"] = time.perf_counter() - t0
        finally:
            port_extract.open_reader = replaced
        res["launches"] = fast.fast_score_map.launches
        if res["launches"] != (stats["chunks"] + 1) * (device == "cuda"):
            raise AssertionError(f"FAST launched {res['launches']} times in run_extraction")
        res["stats"], res["checks"] = stats, check_outputs(stats, n, reader, tol_px)

        if res["probe"]["ok"]:
            clip = tmp / "V_clip.y4m"
            write_y4m(clip, frames, info.width, info.height)
            from geotrax_tpu_torch.io.video import VideoReader

            t0 = time.perf_counter()
            decoded = sum(1 for _ in VideoReader(clip, backend="native"))
            res["decode_fps"] = decoded / (time.perf_counter() - t0)
            cmd = [sys.executable, "-m", "geotrax_tpu_torch", "extract", str(clip), "-m",
                   str(tmp / "ckpt.npz"), "-c", cfg, "--device", device, "-lp", str(tmp)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, cwd=Path(__file__).resolve().parent, capture_output=True,
                                  text=True, timeout=600)
            res["subprocess_s"] = time.perf_counter() - t0
            if proc.returncode != 0:
                raise AssertionError(f"extract subprocess failed (exit {proc.returncode}):\n"
                                     f"{proc.stderr[-3000:]}")
            # decoding moves pixels by a grey level, which moves a random
            # detector's few boxes at a rehearsal's size: no track may last
            res["subprocess_checks"] = check_files(
                tmp / "results" / "V_clip.txt", tmp / "results" / "V_clip_vid_transf.txt",
                clip.with_suffix(".yaml"), decoded, reader, tol_px,
                may_lack_tracks=detector.imgsz != port_cfg.DEFAULT["ultralytics"]["imgsz"])
    res["turns"] = driver_turns(smoke_config(detector.imgsz), detector,
                                turn_frames or frames, info, chunk, device, turn_rounds)
    return res


OPTIONS = (
    ("stable", "stable"),
    ("tiles=2", {"ultralytics": {"tiles": 2}}),
    ("half", {"ultralytics": {"half": True}}),
    ("stabilize off, botsort", {"extraction": {"stabilize": False}}),
    ("stabilize off, bytetrack", {"extraction": {"stabilize": False},
                                  "tracker": {"active": "bytetrack"}}),
)


def option_config(imgsz: int, option) -> dict:
    """The default configuration with one option: a preset's name or
    overrides of some sections' keys."""
    if isinstance(option, str):
        config = port_cfg.load_config(port_cfg.CFG_DIR / f"{option}.yaml")
    else:
        config = port_cfg.load_config()
        for section, values in option.items():
            config[section].update(values)
    config["ultralytics"]["imgsz"] = imgsz
    return config


def gmc_error(gmc: np.ndarray, frame_ids, reader: SyntheticVideoReader) -> float:
    """Largest distance [px] between where each frame's GMC (previous frame
    -> this frame) and the camera's true motion map the frame's corners and
    centre; the first frame of the video has no previous frame."""
    w, hh = reader.info.width, reader.info.height
    pts = np.array([[0, 0, 1], [w, 0, 1], [0, hh, 1], [w, hh, 1], [w / 2, hh / 2, 1]], float)
    err = 0.0
    for g, i in zip(gmc, frame_ids):
        if i == 0:
            continue
        true = np.linalg.inv(reader.camera_h(i)) @ reader.camera_h(i - 1)
        a, b = pts @ g.T, pts @ true.T
        err = max(err, float(np.abs(a[:, :2] / a[:, 2:] - b[:, :2] / b[:, 2:]).max()))
    return err


def phase_options(detector, frames, reader, device: str = "cuda", imgsz: int = 1920,
                  chunk: int = 32, tol_px: float = 2.0) -> dict:
    """Each option of the extract config through a fresh detector and
    extractor (the extract stage's constructors) on the main phase's first
    two chunks: ms of each chunk step (the upload of the stacked frames from
    pageable memory included) with the copy of its outputs, FAST
    launches, and the homographies against the camera (stabilized), the
    standalone GMC against the camera's frame-to-frame motion (stabilize
    off, botsort), or identity and no FAST launch (bytetrack)."""
    from geotrax_tpu_torch.models import convert

    info = reader.info
    results = {}
    tmp = tempfile.TemporaryDirectory()
    model_path = Path(tmp.name) / "ckpt.npz"
    convert.save_npz(model_path, detector.model)
    for name, option in OPTIONS:
        config = option_config(imgsz, option)
        det = Detector(model_path, config["ultralytics"], device=device)
        fx = build_fused(config, det, info.height, info.width, chunk, 0, device)
        fast.fast_score_map.launches = 0
        ms, hs, gmcs = [], [], []
        for k in range(2):
            part = frames[k * chunk:(k + 1) * chunk]
            fids = np.asarray([i for i, _ in part]) + 1
            stacked = np.stack([f for _, f in part])
            t0 = time.perf_counter()
            out = fx.process_chunk(stacked, fids, len(part))
            hs.append(out.h.cpu().numpy())
            gmcs.append(out.gmc.cpu().numpy())
            ms.append((time.perf_counter() - t0) * 1e3)
        ids = [i for i, _ in frames[:2 * chunk]]
        h, gmc = np.concatenate(hs), np.concatenate(gmcs)
        stab, use_gmc = fx.stab_on, fx.use_gmc
        res = {"ms": ms, "launches": fast.fast_score_map.launches}
        expected = (3 if stab else 2 if use_gmc else 0) * (device == "cuda")
        if res["launches"] != expected:
            raise AssertionError(f"{name}: FAST launched {res['launches']} times, "
                                 f"expected {expected}")
        if stab:
            res["camera_err_px"] = check_homographies(h, ids, reader, tol_px)
        else:
            if not np.array_equal(h, np.broadcast_to(np.eye(3), h.shape)):
                raise AssertionError(f"{name}: homographies with stabilization off")
            if use_gmc:
                res["gmc_err_px"] = gmc_error(gmc, ids, reader)
                if res["gmc_err_px"] > tol_px:
                    raise AssertionError(f"{name}: GMC {res['gmc_err_px']:.3f} px off the camera")
            elif not np.array_equal(gmc, np.broadcast_to(np.eye(3), gmc.shape)):
                raise AssertionError(f"{name}: GMC without a GMC tracker")
        results[name] = res
        del fx, det
    tmp.cleanup()
    return results


def breakdown(fx, width: int, height: int, seed: int, horizon: int, start: int,
              chunk: int = 32, top: int = 12, tol_px: float = 2.0) -> dict:
    """Host and device time by stage (the chunk step's ``fx.*`` ranges) and
    by kernel over one more chunk of the same video, under torch.profiler;
    the chunk's homographies are checked as in the other phases."""
    from torch.profiler import ProfilerActivity, profile

    reader = smoke_reader(width, height, seed, horizon, start, start + chunk)
    frames = np.stack([frame for _, frame in make_frames(reader)])
    fids = np.arange(start, start + chunk) + 1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fx.process_chunk(frames, fids, chunk)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    check_homographies(out.h.cpu().numpy(), range(start, start + chunk), reader, tol_px)
    return {"wall_ms": wall_ms, **profile_ranges(prof, "fx.", top)}


def profile_ranges(prof, prefix: str, top: int = 12) -> dict:
    """Host and device ms of each ``prefix`` range of a torch.profiler run,
    the device's busy ms and its largest kernels."""
    from torch.profiler import DeviceType

    events = prof.key_averages()

    def device_us(e, attr):
        return getattr(e, attr, getattr(e, attr.replace("device", "cuda"), 0.0)) or 0.0

    # a range shows twice: its host row (host time, device time of the
    # kernels it launched) and its device-timeline row (span on the card)
    span = {e.key: device_us(e, "self_device_time_total") / 1e3 for e in events
            if e.key.startswith(prefix) and e.device_type == DeviceType.CUDA}
    stages = [(e.key, e.cpu_time_total / 1e3, device_us(e, "device_time_total") / 1e3,
               span.get(e.key, 0.0))
              for e in events if e.key.startswith(prefix) and e.device_type == DeviceType.CPU]
    kernels = sorted(((device_us(e, "self_device_time_total"), e.key, e.count) for e in events
                      if e.device_type == DeviceType.CUDA and not e.key.startswith(prefix)),
                     reverse=True)
    return {"device_busy_ms": sum(k[0] for k in kernels) / 1e3,
            "stages": stages,
            "top": [(k, us / 1e3, n) for us, k, n in kernels[:top]]}


# --------------------------------------------------------------------------
# georeferencing
# --------------------------------------------------------------------------

# The reference regime (cfg/default.yaml, georef): 4K reference and master
# frames registered against a 15000 px orthophoto cutout
# (transformation.cutout_width_px) with 250k RootSIFT features.
GEO_ORTHO_PX = 15000
GEO_RECTS = 4000
GEO_LOCATION = "A"
# The Songdo load of PERF.md §4: 5 minutes of 4K video at 30 fps with
# VEHICLES_PER_4K_FRAME vehicles in every frame.
GEO_FPS = 30
GEO_FRAMES = 5 * 60 * GEO_FPS
GEO_LANES, GEO_SECTIONS = 8, 3
# The ortho mosaic's affine (EPSG:4326 degrees per pixel, about 0.1 m at
# 37.4 N) and the cutout's centre in it, Songdo-like.
GEO_MOSAIC = (126.60, 37.42, 1.13e-6, -0.9e-6, 0.0, 0.0)
GEO_CENTER = (21000.0, 17500.0)
GEO_COLUMNS = ["Vehicle_ID", "Timestamp", "Frame_Number", "Ortho_X", "Ortho_Y", "Local_X",
               "Local_Y", "Latitude", "Longitude", "Vehicle_Length", "Vehicle_Width",
               "Vehicle_Class", "Vehicle_Speed", "Vehicle_Acceleration", "Road_Section",
               "Lane_Number", "Visibility", "Is_Interpolated"]


def synthetic_ortho(size: int, rects: int = GEO_RECTS, seed: int = 7) -> tuple:
    """tools/benchmark_ortho_matching.py's synthetic orthophoto (its
    --synthetic-ortho recipe, the same draws): 8 px blocks of random colour,
    a road grid and vehicle-sized rectangles. Returns (ortho, generator)."""
    rng = np.random.default_rng(seed)
    blocks = rng.integers(30, 220, (size // 8, size // 8, 3)).astype(np.uint8)
    ortho = np.repeat(np.repeat(blocks, 8, axis=0), 8, axis=1)
    for k in range(0, size, size // 24):  # road grid
        ortho[k:k + 12, :] = 72
        ortho[:, k:k + 12] = 72
    for _ in range(rects):  # vehicle-scale rectangles
        y, x = rng.integers(0, size - 40, 2)
        ortho[y:y + rng.integers(12, 36), x:x + rng.integers(12, 36)] = (
            rng.integers(0, 255, 3))
    return ortho, rng


def frame_to_ortho(rng, size: int, fw: int, fh: int) -> np.ndarray:
    """The recipe's frame -> ortho homography: a central ground patch at
    0.82-0.95 of the ortho's width, rotated by up to 15 degrees."""
    scale = rng.uniform(0.82, 0.95) * size / fw
    ang = rng.uniform(-np.pi / 12, np.pi / 12)
    c_, s_ = np.cos(ang) * scale, np.sin(ang) * scale
    cx, cy = fw / 2, fh / 2
    jitter = 80 * size / GEO_ORTHO_PX
    tx = size / 2 - (c_ * cx - s_ * cy) + rng.uniform(-jitter, jitter)
    ty = size / 2 - (s_ * cx + c_ * cy) + rng.uniform(-jitter, jitter)
    return np.array([[c_, -s_, tx], [s_, c_, ty], [0, 0, 1.0]])


def similarity(angle_deg: float, tx: float, ty: float, cx: float, cy: float) -> np.ndarray:
    a = np.deg2rad(angle_deg)
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, cx - c * cx + s * cy + tx], [s, c, cy - s * cx - c * cy + ty],
                     [0, 0, 1.0]])


def render_frame(ortho: torch.Tensor, h: np.ndarray, fw: int, fh: int, gamma: float,
                 seed: int) -> np.ndarray:
    """The frame a camera with frame -> ortho homography ``h`` sees: the
    ortho (a (S,S,3) uint8 tensor) sampled bilinearly at h @ (x, y, 1), zero
    outside (cv2.warpPerspective with WARP_INVERSE_MAP, in torch), then the
    recipe's gamma, contrast and N(0, 5) noise."""
    dev = ortho.device
    ys, xs = torch.meshgrid(torch.arange(fh, device=dev, dtype=torch.float64),
                            torch.arange(fw, device=dev, dtype=torch.float64), indexing="ij")
    hh = [float(v) for v in h.reshape(-1)]
    den = hh[6] * xs + hh[7] * ys + hh[8]
    sx = (hh[0] * xs + hh[1] * ys + hh[2]) / den
    sy = (hh[3] * xs + hh[4] * ys + hh[5]) / den
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = (sx - x0).float()[..., None], (sy - y0).float()[..., None]
    x0, y0 = x0.long(), y0.long()
    size_y, size_x = ortho.shape[:2]

    def tap(yy, xx):
        ok = (yy >= 0) & (yy < size_y) & (xx >= 0) & (xx < size_x)
        v = ortho[yy.clamp(0, size_y - 1), xx.clamp(0, size_x - 1)].float()
        return torch.where(ok[..., None], v, 0.0)

    out = (tap(y0, x0) * (1 - fx) * (1 - fy) + tap(y0, x0 + 1) * fx * (1 - fy)
           + tap(y0 + 1, x0) * (1 - fx) * fy + tap(y0 + 1, x0 + 1) * fx * fy)
    out = 255.0 * (out.clamp(0, 255) / 255.0) ** gamma
    gen = torch.Generator(device=dev).manual_seed(seed)
    noise = torch.randn(out.shape, generator=gen, device=dev)
    return (out * 0.85 + 15 + 5 * noise).clamp(0, 255).to(torch.uint8).cpu().numpy()


def lane_layout(fw: int, fh: int) -> tuple:
    """Lane centres, lane height and section x-edges in the reference frame."""
    lane_h = 0.4 * fh / GEO_LANES
    centers = fh * 0.3 + lane_h * (np.arange(GEO_LANES) + 0.5)
    edges = np.linspace(0.05 * fw, 0.95 * fw, GEO_SECTIONS + 1)
    return centers, lane_h, edges


def segmentation_rows(h_ref: np.ndarray, fw: int, fh: int) -> list:
    """Lane polygons in ortho pixels (section, lane, tl, bl, br, tr and a
    note column past the ten the stage reads): each lane's strip of the
    reference frame in each section, mapped by the true reference -> ortho
    homography. Sections are written zero-padded ('01'), which the stage
    reads as integers, as pandas does."""
    centers, lane_h, edges = lane_layout(fw, fh)
    rows = []
    for j in range(GEO_SECTIONS):
        for k, yc in enumerate(centers):
            quad = np.array([[edges[j], yc - lane_h / 2], [edges[j], yc + lane_h / 2],
                             [edges[j + 1], yc + lane_h / 2], [edges[j + 1], yc - lane_h / 2]])
            p = np.concatenate([quad, np.ones((4, 1))], 1) @ h_ref.T
            p = p[:, :2] / p[:, 2:]
            rows.append([f"{j + 1:02d}", str(k + 1)] + [f"{v:.3f}" for v in p.reshape(-1)]
                        + [f"lane {k + 1}"])
    return rows


def synthetic_tracks(n_frames: int, vehicles: int, fw: int, fh: int, seed: int = 11) -> np.ndarray:
    """The extract stage's 15-column tracks of ``vehicles`` vehicles per
    frame over ``n_frames`` frames in reference-frame pixels: each vehicle
    drives along its lane at its own speed and, once it leaves the frame,
    comes back as a new track; every 37th frame of a track is interpolated.
    Columns: frame, id, box (cx, cy, w, h), stabilized centre, stabilized
    size, class, score, length and width [px], is_interpolated."""
    rng = np.random.default_rng(seed)
    centers, _, _ = lane_layout(fw, fh)
    lane = np.arange(vehicles) % GEO_LANES
    speed = rng.uniform(4.0, 12.0, vehicles) * fw / 3840
    start = rng.uniform(0, fw, vehicles)
    length = rng.uniform(40, 70, vehicles) * fw / 3840
    width = rng.uniform(18, 26, vehicles) * fw / 3840
    cls = rng.integers(0, 4, vehicles)
    period = fw + 200.0 * fw / 3840
    t = np.arange(n_frames)[:, None]
    travel = start[None, :] + speed[None, :] * t
    laps = np.floor(travel / period).astype(np.int64)
    x = travel - laps * period - 100.0 * fw / 3840
    x = np.where(lane[None, :] % 2 == 0, x, fw - x)
    y = centers[lane][None, :] + 3.0 * np.sin(t / 25.0 + lane[None, :])
    ids = laps * vehicles + np.arange(vehicles)[None, :] + 1
    first = np.zeros_like(laps)
    for v in range(vehicles):  # frame of each lap's first appearance
        _, idx = np.unique(laps[:, v], return_index=True)
        starts = np.zeros(n_frames, np.int64)
        starts[idx] = idx
        first[:, v] = np.maximum.accumulate(starts)
    interp = ((t - first) % 37 == 36).astype(np.float64)
    cols = [np.broadcast_to(a, (n_frames, vehicles)).astype(np.float64) for a in (
        t, ids, x, y, length, width, x, y, length, width, cls, 0.9, length, width, interp)]
    return np.stack(cols, -1).reshape(-1, 15)


def write_tracks(path, tracks: np.ndarray) -> None:
    fmt = ["%d", "%d"] + ["%.2f"] * 8 + ["%d", "%.2f", "%.2f", "%.2f", "%d"]
    np.savetxt(path, tracks, fmt=fmt, delimiter=",")


def expected_lanes(tracks: np.ndarray, fw: int, fh: int, margin: float = 8.0) -> dict:
    """{(id, frame): (section, lane)} of the rows farther than ``margin``
    px from every strip's edge: ('', '') outside every section."""
    centers, lane_h, edges = lane_layout(fw, fh)
    x, y = tracks[:, 6], tracks[:, 7]
    lane = np.argmin(np.abs(y[:, None] - centers[None, :]), axis=1)
    sec = np.searchsorted(edges, x) - 1
    inside = (sec >= 0) & (sec < GEO_SECTIONS)
    y_edges = np.concatenate([centers - lane_h / 2, centers[-1:] + lane_h / 2])
    far = ((np.min(np.abs(x[:, None] - edges[None, :]), axis=1) > margin)
           & (np.min(np.abs(y[:, None] - y_edges[None, :]), axis=1) > margin))
    out = {}
    for i in np.nonzero(far)[0]:
        key = (int(tracks[i, 1]), int(tracks[i, 0]))
        out[key] = (str(sec[i] + 1), str(lane[i] + 1)) if inside[i] else ("", "")
    return out


def corner_error(h_est: np.ndarray, h_true: np.ndarray, w: int, h: int) -> float:
    """Largest distance [px] between where the two homographies map a
    w x h frame's corners."""
    c = np.array([[0, 0, 1], [w - 1, 0, 1], [w - 1, h - 1, 1], [0, h - 1, 1]], float)
    p, q = c @ h_est.T, c @ h_true.T
    return float(np.abs(p[:, :2] / p[:, 2:] - q[:, :2] / q[:, 2:]).max())


def feature_slots(h: int, w: int, max_features: int) -> int:
    """How many features detect_and_describe returns at this size: each
    level's budget, cut by TOPK_CAP where the reference caps it."""
    from geotrax_tpu_torch.ops import sift

    total = 0
    for _, lh, lw, budget in sift.level_plan(h, w, max_features):
        if lh * lw > sift.BAND_PIXEL_LIMIT:
            n_bands = sift.band_layout(lh, lw)[0]
            total += min(budget, n_bands * int(min(np.ceil(2 * budget / n_bands), sift.TOPK_CAP)))
        else:
            total += min(budget, sift.TOPK_CAP) if lh * lw > sift.TOPK_CAP_MIN_INPUT else budget
    return total


class LogLines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def events_ms(fn, device: str) -> tuple:
    """(ms of one call, its result): CUDA events on the card, the host's
    clock on the CPU."""
    if device != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return (time.perf_counter() - t0) * 1e3, out
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def bound_ms(moved_bytes: float, flops: float) -> tuple:
    """(ms, "bytes" | "operations"): the larger of the bytes over HBM's rate
    and the float32 operations over the card's float32 rate."""
    by_bytes = moved_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / FP32_FLOP_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def sift_breakdown(gray: torch.Tensor, max_features: int, device: str) -> dict:
    """Where ``detect_and_describe``'s time goes on ``gray``, each piece
    timed alone (CUDA events) beside its bound: per level the resize (a
    dense float32 product per axis, the reference's form) and the level's
    features; on the largest level's first band (the level itself when it
    is not banded) the DoG's two blurs, the eight orientation planes' blur,
    their tent filter and the exact top-k (a stable sort)."""
    from geotrax_tpu_torch.ops import features as feat
    from geotrax_tpu_torch.ops import sift
    from geotrax_tpu_torch.ops.topk import exact_top_k

    h, w = gray.shape
    levels = []
    for s, lh, lw, budget in sift.level_plan(h, w, max_features):
        resize_ms, level = events_ms(
            lambda: gray if s == 1.0 else sift.resize_linear(gray, lh, lw), device)
        flops = 0 if s == 1.0 else 2.0 * lh * h * w + 2.0 * lh * w * lw
        banded = lh * lw > sift.BAND_PIXEL_LIMIT
        fn = sift._level_features_banded if banded else sift._level_features
        features_ms, _ = events_ms(lambda: fn(level, budget), device)
        levels.append({"shape": (lh, lw), "budget": budget, "banded": banded,
                       "resize_ms": resize_ms,
                       "resize_bound_ms": bound_ms(4.0 * (h * w + lh * lw), flops)[0],
                       "features_ms": features_ms})
        del level
    _, band_h, bands = sift.band_layout(h, w)
    band = gray[bands[0][0]:bands[0][0] + band_h] if h * w > sift.BAND_PIXEL_LIMIT else gray
    px = band.numel()
    planes = sift._orientation_planes(band)[0]
    pieces = {}
    for name, fn, channels, taps in (
            ("blur 1.6", lambda: feat._gaussian_blur(band, 1.6), 1, 11),
            ("blur 2.56", lambda: feat._gaussian_blur(band, 2.56), 1, 17),
            ("planes blur 2.4", lambda: feat._gaussian_blur(planes, 2.4), 8, 15),
            ("planes tent 4", lambda: sift._triangle_blur(planes, 4), 8, 9)):
        ms, _ = events_ms(fn, device)
        pieces[name] = (ms, *bound_ms(8.0 * channels * px, 4.0 * taps * channels * px))
    k = min(sift.TOPK_CAP, px)
    ms, _ = events_ms(lambda: exact_top_k(band.reshape(-1), k), device)
    pieces["top-k"] = (ms, *bound_ms(4.0 * px + 8.0 * k, 0.0))
    return {"levels": levels, "band": tuple(band.shape), "pieces": pieces}


@contextlib.contextmanager
def scratch_dir(keep: bool = False):
    """A temporary folder, removed on leaving unless ``keep`` (its user
    then removes it), and whenever an exception leaves."""
    tmp = tempfile.mkdtemp()
    try:
        yield tmp
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if not keep:
        shutil.rmtree(tmp, ignore_errors=True)


def geo_assets(root: Path, device: str, size: int, fw: int, fh: int, n_frames: int,
               vehicles: int, rects: int) -> dict:
    """The georeferencing inputs of one video, as files: the orthophoto
    (through the port's PNG writer), its center-text-file parameters, the
    master frame, the lane segmentation, the flight log and the extract
    stage's tracks; the reference frame stays in memory (the card's machine
    cannot decode a video). Returns the true homographies and the frames."""
    from geotrax_tpu_torch.io import png

    t0 = time.perf_counter()
    ortho, rng = synthetic_ortho(size, rects)
    h_master = frame_to_ortho(rng, size, fw, fh)
    gammas = rng.uniform(1.3, 1.6, 2)
    # the reference frame: the master's view turned 1.5 degrees and moved,
    # seen in another light
    h_ref_to_master = similarity(1.5, 25.0 * fw / 3840, -15.0 * fw / 3840, fw / 2, fh / 2)
    h_ref = h_master @ h_ref_to_master
    ortho_dev = torch.as_tensor(ortho).to(device)
    master = render_frame(ortho_dev, h_master, fw, fh, float(gammas[0]), 1)
    ref = render_frame(ortho_dev, h_ref, fw, fh, float(gammas[1]), 2)
    # a second frame of the reference view for the orb-path Stabilizer pair
    h_next = h_ref @ similarity(0.3, 6.0, -4.0, fw / 2, fh / 2)
    nxt = render_frame(ortho_dev, h_next, fw, fh, float(gammas[1]), 3)
    del ortho_dev
    scene_s = time.perf_counter() - t0

    ortho_dir = root / "ORTHOPHOTOS"
    for sub in ("master_frames", "segmentations"):
        (ortho_dir / sub).mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    png.write_png(ortho_dir / f"{GEO_LOCATION}.png", ortho, compress_level=1)
    png.write_png(ortho_dir / "master_frames" / f"{GEO_LOCATION}.png", master, compress_level=1)
    png_s = time.perf_counter() - t0
    (ortho_dir / f"{GEO_LOCATION}_center.txt").write_text(
        f"# cutout centre in the mosaic [px]\n{GEO_CENTER[0]} {GEO_CENTER[1]}\n")
    (ortho_dir / "ortho_parameters.txt").write_text(
        "# lng0 lat0 dlng dlat skew_x skew_y\n" + " ".join(repr(v) for v in GEO_MOSAIC) + "\n")
    seg = ["section,lane,tlx,tly,blx,bly,brx,bry,trx,try,note"]
    seg += [",".join(r) for r in segmentation_rows(h_ref, fw, fh)]
    (ortho_dir / "segmentations" / f"{GEO_LOCATION}.csv").write_text("\n".join(seg) + "\n")

    source = root / f"{GEO_LOCATION}_smoke.mp4"
    t0 = time.perf_counter()
    stamps = [f"2024-05-14 08:{(f // GEO_FPS) // 60 % 60:02d}:{(f // GEO_FPS) % 60:02d}."
              f"{(f % GEO_FPS) * 1000 // GEO_FPS:03d}" for f in range(n_frames)]
    source.with_suffix(".csv").write_text(
        "frame,timestamp\n" + "".join(f"{f},{t}\n" for f, t in enumerate(stamps)))
    tracks = synthetic_tracks(n_frames, vehicles, fw, fh)
    (root / "results").mkdir(exist_ok=True)
    write_tracks(root / "results" / f"{source.stem}.txt", tracks)
    tracks_s = time.perf_counter() - t0
    return {"source": source, "ortho_dir": ortho_dir, "ortho": ortho, "master": master,
            "ref": ref, "next": nxt, "h_master": h_master, "h_ref": h_ref,
            "h_ref_to_master": h_ref_to_master, "h_next_to_ref": np.linalg.inv(h_ref) @ h_next,
            "tracks": tracks, "scene_s": scene_s, "png_s": png_s, "tracks_s": tracks_s}


def check_geo_csv(path: Path, tracks: np.ndarray, fw: int, fh: int, margin: float) -> dict:
    """The written CSV: the 18 columns, finite coordinates, and every row's
    section and lane those of its place in the layout (rows within
    ``margin`` px of a strip's edge aside)."""
    from geotrax_tpu_torch.io import table

    with open(path) as fh_:
        header = fh_.readline().strip().split(",")
    if header != GEO_COLUMNS:
        raise AssertionError(f"georeferenced CSV columns {header}")
    t = time.perf_counter()
    cols = table.read_csv(path)
    read_s = [time.perf_counter() - t]
    # the same read with the float cells through float() (correctly rounded,
    # not pandas' values), the cost of matching pandas; then the port's again
    parse_floats = table.parse_floats
    table.parse_floats = lambda cells: np.array([float(c) for c in cells])
    try:
        t = time.perf_counter()
        table.read_csv(path)
        float_s = time.perf_counter() - t
    finally:
        table.parse_floats = parse_floats
    t = time.perf_counter()
    table.read_csv(path)
    read_s.append(time.perf_counter() - t)
    n = len(cols["Vehicle_ID"])
    if not n > 0.5 * len(tracks):
        raise AssertionError(f"{n} rows of {len(tracks)} tracked rows")
    for name in ("Ortho_X", "Ortho_Y", "Local_X", "Local_Y", "Latitude", "Longitude"):
        if not np.isfinite(cols[name]).all():
            raise AssertionError(f"non-finite {name}")
    expected = expected_lanes(tracks, fw, fh, margin)
    # read back typed: a column with empty cells comes back as floats
    sections, lanes = ([("" if np.isnan(v) else str(int(v))) for v in cols[name].tolist()]
                       for name in ("Road_Section", "Lane_Number"))
    checked = wrong = assigned = 0
    for i, key in enumerate(zip(cols["Vehicle_ID"].tolist(), cols["Frame_Number"].tolist())):
        want = expected.get(key)
        assigned += lanes[i] != ""
        if want is None:
            continue
        checked += 1
        wrong += (sections[i], lanes[i]) != want
    if wrong or checked < 0.5 * n or assigned == 0:
        raise AssertionError(f"sections/lanes: {wrong} of {checked} checked rows differ "
                             f"({assigned} of {n} rows assigned)")
    return {"rows": n, "checked": checked, "assigned": assigned,
            "tracks": int(len(np.unique(cols["Vehicle_ID"]))), "read_s": read_s,
            "float_read_s": float_s, "bytes": path.stat().st_size}


def phase_georef(device: str = "cuda", size: int = GEO_ORTHO_PX, fw: int = 3840, fh: int = 2160,
                 n_frames: int = GEO_FRAMES, vehicles: int = VEHICLES_PER_4K_FRAME,
                 rects: int = GEO_RECTS, max_features: int = 250_000,
                 tol_px: float = 3.0, min_inliers: int = 50, min_share: float = 0.9,
                 keep: bool = False) -> dict:
    """``georeference`` as users run it at the reference regime: the master
    path (reference -> master and master -> ortho registrations, the second
    cached), then the same command again from the cache; the files checked;
    then the registration's device steps timed alone on the same images,
    and the single-level Stabilizer on a pair of the reference view. At
    least ``min_share`` of each image's feature slots must be valid. With
    ``keep`` the assets and their folder stay, under ``res["kept"]``."""
    from geotrax_tpu_torch.ops import prng, sift
    from geotrax_tpu_torch.ops.ransac import ransac_fit
    from geotrax_tpu_torch.pipeline import georeference as port_geo
    from geotrax_tpu_torch.stabilize import Stabilizer, StabilizerConfig

    res = {}
    with scratch_dir(keep) as tmp:
        root = Path(tmp)
        a = geo_assets(root, device, size, fw, fh, n_frames, vehicles, rects)
        res.update({k: a[k] for k in ("scene_s", "png_s", "tracks_s")})
        res["tracked_rows"] = len(a["tracks"])
        argv = georef_argv(root, a["ortho_dir"], a["source"], device, max_features)
        logger = logging.getLogger("smoke.georeference")
        logger.setLevel(logging.INFO)
        lines = LogLines()
        logger.addHandler(lines)
        replaced = port_geo.get_video_data
        port_geo.get_video_data = lambda src, ref_frame, log: (a["ref"], (fh, fw), float(GEO_FPS))
        runs = []
        try:
            for _ in range(2):  # the master path, then again from the cache
                lines.lines.clear()
                base = 0
                if device == "cuda":
                    torch.cuda.empty_cache()
                    torch.cuda.reset_peak_memory_stats()
                    base = torch.cuda.memory_allocated()
                t0 = time.perf_counter()
                out = port_geo.run_georeferencing(port_geo.parse_cli_args(argv), logger)
                out["wall_s"] = time.perf_counter() - t0
                # the stage's own peak, above what earlier phases still hold
                out["peak_gib"] = ((torch.cuda.max_memory_allocated() - base) / 2**30
                                   if device == "cuda" else None)
                out["log"] = list(lines.lines)
                runs.append(out)
        finally:
            port_geo.get_video_data = replaced
            logger.removeHandler(lines)

        first, second = runs
        cache = (a["ortho_dir"] / "master_frames" / f"{GEO_LOCATION}.txt").read_text().splitlines()
        h_m2o = np.array([float(v) for v in cache[0].split(",")]).reshape(3, 3)
        stats = cache[-1]
        nums = [int(t.strip(".,")) for t in stats.split() if t.strip(".,").isdigit()]
        res["n_master"], res["n_ortho"], res["inliers"], res["matches"] = nums[:4]
        res["master_err_px"] = corner_error(h_m2o, a["h_master"], fw, fh)
        res["ref_err_px"] = corner_error(first["h_ref_to_ortho"], a["h_ref"], fw, fh)
        res["ortho_slots"] = feature_slots(size, size, max_features)
        res["frame_slots"] = feature_slots(fh, fw, max_features)
        if res["master_err_px"] > tol_px or res["ref_err_px"] > tol_px:
            raise AssertionError(f"georeferencing error: master -> ortho "
                                 f"{res['master_err_px']:.2f} px, reference -> ortho "
                                 f"{res['ref_err_px']:.2f} px (limit {tol_px})")
        if res["inliers"] < min_inliers:
            raise AssertionError(f"{res['inliers']} master -> ortho inliers, fewer than "
                                 f"{min_inliers}")
        if not (min_share * res["ortho_slots"] <= res["n_ortho"] <= res["ortho_slots"]
                and min_share * res["frame_slots"] <= res["n_master"] <= res["frame_slots"]):
            raise AssertionError(f"feature counts {res['n_master']} / {res['n_ortho']}, "
                                 f"expected up to {res['frame_slots']} / {res['ortho_slots']}")
        if not any("Loaded cached master->ortho homography" in line for line in second["log"]):
            raise AssertionError("the second run did not load the cached homography")
        # the cache holds the float32 fit in float64, so the rerun's product
        # is taken in float64: the same homography to float32 precision
        res["rerun_px"] = corner_error(second["h_ref_to_ortho"], first["h_ref_to_ortho"], fw, fh)
        if res["rerun_px"] > 0.01 or second["rows"] != first["rows"]:
            raise AssertionError(f"the cached rerun moved the homography by "
                                 f"{res['rerun_px']:.4f} px, {second['rows']} rows")
        # rows farther from a strip's edge than the registration's error
        res["csv"] = check_geo_csv(first["csv"], a["tracks"], fw, fh,
                                   max(8.0 * fw / 3840, 2.0 * res["ref_err_px"]))
        res["runs"] = [{k: r[k] for k in ("seconds", "wall_s", "peak_gib", "rows")} for r in runs]

        # the registration's device steps alone, on the stage's images
        dev = torch.device(device)
        ortho_gray = features.rgb_to_gray(torch.as_tensor(a["ortho"]).to(dev))
        master_gray = features.rgb_to_gray(torch.as_tensor(a["master"]).to(dev))
        res["ortho_ms"], fo = events_ms(lambda: sift.detect_and_describe(ortho_gray, max_features),
                                        device)
        res["ortho_breakdown"] = sift_breakdown(ortho_gray, max_features, device)
        del ortho_gray
        res["frame_ms"], fm = events_ms(lambda: sift.detect_and_describe(master_gray,
                                                                         max_features), device)
        ratio = port_cfg.DEFAULT["georef"]["matching"]["filter_ratio"]
        res["match_ms"], m = events_ms(lambda: sift.match_l2(fm.desc, fm.valid, fo.desc, fo.valid,
                                                             ratio=ratio), device)
        ka, kb = fm.desc.shape[0], fo.desc.shape[0]
        res["match_shape"] = (ka, kb)
        res["match_bound_ms"] = 2 * ka * kb * 128 / FP32_FLOP_PER_S * 1e3
        stab_cfg = StabilizerConfig(detector_name="rsift", ransac_max_iter=10000)
        res["ransac_ms"], r = events_ms(lambda: ransac_fit(
            fm.xy[m.idx_a], fo.xy[m.idx_b], m.valid, threshold=3.0,
            key=prng.fold_in(prng.PRNGKey(0), 2), num_hypotheses=stab_cfg.num_hypotheses), device)
        res["ransac_hypotheses"] = stab_cfg.num_hypotheses
        res["timed_inliers"] = int(r.num_inliers)
        res["timed_err_px"] = corner_error(r.h_matrix.double().cpu().numpy(), a["h_master"], fw, fh)

        # the single-level (orb) Stabilizer on a pair of the reference view
        fast.fast_score_map.launches = 0
        stab = Stabilizer(**port_cfg.DEFAULT["stabilo"], device=device)
        stab.set_ref_frame(a["ref"])
        stab.stabilize(a["next"])
        res["orb_launches"] = fast.fast_score_map.launches
        res["orb_err_px"] = corner_error(stab.get_cur_trans_matrix(), a["h_next_to_ref"], fw, fh)
        res["orb_inliers"] = stab.get_cur_inliers_count()
        if res["orb_launches"] != 2 * (device == "cuda") or res["orb_err_px"] > 2.0:
            raise AssertionError(f"orb-path Stabilizer: {res['orb_launches']} FAST launches, "
                                 f"corner error {res['orb_err_px']:.2f} px")
    if keep:  # for the features phase's GeoTIFF leg, which removes the folder
        res["kept"] = {"root": Path(tmp), "assets": a}
    return res


# --------------------------------------------------------------------------
# main
# --------------------------------------------------------------------------

# --------------------------------------------------------------------------
# the sequential per-frame path
# --------------------------------------------------------------------------

SEQ_FRAMES = 16
RTDETR_CHECK_IMGSZ = 640
# card against CPU at RTDETR_CHECK_IMGSZ: float32 products summed in other
# orders through ~100 layers move scores by ~1e-5 and boxes by ~1e-5 of the
# frame's width once un-stretched (6x from 640 to 3840 px)
RTDETR_SCORE_TOL = 1e-4
RTDETR_BOX_TOL_PX = 0.2
# fused (a chunk of frames) against sequential on the card: the tolerance of
# the card against the CPU (phase_reference)
FUSED_SEQ_TOL_PX = 0.05
_INV_255 = float(np.float32(1.0) / np.float32(255.0))


def config_file(path: Path, imgsz: int, **edits) -> str:
    """A user's copy of the default preset at ``imgsz`` with lines replaced
    ({old line: new line}); returns its path."""
    text = (port_cfg.CFG_DIR / "default.yaml").read_text()
    for old, new in {"  imgsz: 1920\n": f"  imgsz: {imgsz}\n", **edits}.items():
        if text.count(old) != 1:
            raise AssertionError(f"the default preset has {text.count(old)} lines {old!r}")
        text = text.replace(old, new)
    path.write_text(text)
    return str(path)


REID_ON = {"    appearance_thresh: 0.8\n    with_reid: false\n":
           "    appearance_thresh: 0.8\n    with_reid: true\n"}


def rtdetr_images(frames_u8: torch.Tensor, imgsz: int) -> torch.Tensor:
    """The Detector's RT-DETR input: the square stretch, scaled to [0,1]."""
    return resize_u8_linear(frames_u8, imgsz, imgsz).to(torch.float32) * _INV_255


def calibrate_rtdetr_bias(detector: Detector, frame_u8: np.ndarray, boxes: int) -> int:
    """Shift the last score head's biases of a random RT-DETR so that
    ``boxes`` queries of ``frame_u8`` score at or above ``conf`` (one shift
    for every class keeps each query's best class); returns the valid
    detections on that frame."""
    x = torch.as_tensor(frame_u8[None]).to(detector.device)
    spec = detector.spec
    with torch.no_grad():
        _, probs = rtdetr_ul.forward(detector.model, rtdetr_images(x, detector.imgsz), spec)
        logits = torch.logit(probs.amax(dim=-1).double()).flatten()
        kth = float(torch.topk(logits, boxes).values[-1])
        shift = math.log(detector.conf / (1.0 - detector.conf)) - kth + 1e-6
        detector.model.p["decoder"][f"dec_score_head{spec.ndl - 1}"]["b"].add_(shift)
    return int(detector(x[0])["valid"].sum())


class CountFlops:
    """Within the block, counts the operations of every convolution
    (``F.conv2d``) and matrix product (``@``) that runs: 2 x each output
    element x its reduction length (the work that bounds a forward in
    float32; elementwise work and gathers are left out); ``per_call`` keeps
    each call's count in order."""

    def __enter__(self):
        import torch.nn.functional as F

        self.flops = 0.0
        self.per_call = []
        self._conv, self._matmul = F.conv2d, torch.Tensor.__matmul__

        def count(flops):
            self.flops += flops
            self.per_call.append(flops)

        def conv2d(x, w, *args, **kwargs):
            out = self._conv(x, w, *args, **kwargs)
            count(2.0 * out.numel() * w.shape[1] * w.shape[2] * w.shape[3])
            return out

        def matmul(a, b):
            out = self._matmul(a, b)
            count(2.0 * out.numel() * a.shape[-1])
            return out

        F.conv2d, torch.Tensor.__matmul__ = conv2d, matmul
        return self

    def __exit__(self, *exc):
        import torch.nn.functional as F

        F.conv2d, torch.Tensor.__matmul__ = self._conv, self._matmul


def run_extraction_in_memory(args, frames, info, detector=None) -> dict:
    """``run_extraction`` with the frames in memory (``open_reader``
    replaced, the card's machine cannot decode) and, when given, the
    detector in memory (``load_detector`` replaced): the reference's own
    patch points."""
    replaced = port_extract.open_reader, port_extract.load_detector
    port_extract.open_reader = lambda src, start, stop, config: FrameList(info, frames)
    if detector is not None:
        port_extract.load_detector = lambda config, logger: detector
    try:
        return port_extract.run_extraction(args, port_extract._LOG)
    finally:
        port_extract.open_reader, port_extract.load_detector = replaced


def reset_launches() -> None:
    fast.fast_score_map.launches = 0
    patches.patches32.launches = 0


def launches() -> dict:
    return {"fast_score": fast.fast_score_map.launches,
            "patch_gather": patches.patches32.launches}


def fused_vs_sequential(frames, reader, device: str, imgsz: int, vehicles: int) -> dict:
    """(a) The same frames and oracle detections (the reader's vehicles)
    through the sequential loop with ``SequentialOnly`` (one frame at a
    time) and through the fused chunk step, the default configuration with
    ReID, the reference's contract (tests/test_fused_parity.py):

    - with chunks of one frame, the step's batched functions run at the
      loop's shapes: every value of the rows and transforms must be equal;
    - with one chunk of all the frames, frames, ids, classes and scores must
      be equal, and boxes and homographies within FUSED_SEQ_TOL_PX (on the
      card a chunk's batched RANSAC refinement and ReID projection add in
      another order than one frame's; on the CPU every value is equal)."""
    from geotrax_tpu_torch.models.detector import SequentialOnly

    info = reader.info
    config = smoke_config(imgsz, {"with_reid": True})

    def oracle():
        return OracleDetector(lambda i: [list(b) + [0.9, 0] for b in reader.boxes_at(i)],
                              max_det=2 * vehicles, device=device)

    def fused(chunk):
        parts = port_extract.make_extract_tracker(config, device=device)
        fx = port_extract.make_fused_extractor(config, oracle(), *parts[:3], info.height,
                                               info.width, parts[3], chunk=chunk, device=device)
        return port_extract.track_video_fused(FrameList(info, frames), fx, chunk=chunk)[:2]

    st, sh = port_extract.track_video_sequential(
        FrameList(info, frames), SequentialOnly(oracle()),
        port_extract.make_extract_tracker(config, device=device), config)[:2]
    res = {"rows": int(len(st))}
    for name, chunk in (("chunk1", 1), ("chunk", len(frames))):
        ft, fh = fused(chunk)
        if ft.shape != st.shape or fh.shape != sh.shape or len(st) == 0:
            raise AssertionError(f"fused ({chunk}-frame chunks) != sequential: rows {ft.shape} vs "
                                 f"{st.shape}, transforms {fh.shape} vs {sh.shape}")
        r = res[name] = {
            "equal": bool(np.array_equal(ft, st) and np.array_equal(fh, sh)),
            "same_ids": bool(np.array_equal(ft[:, [0, 1, 10, 11]], st[:, [0, 1, 10, 11]])
                             and np.array_equal(fh[:, 0], sh[:, 0])),
            "box_diff_px": float(np.abs(ft[:, 2:10] - st[:, 2:10]).max()),
            "h_diff": float(np.abs(fh - sh).max()),
            "h_diff_px": max(corner_error(a.reshape(3, 3), b.reshape(3, 3), info.width,
                                          info.height) for a, b in zip(fh[:, 1:], sh[:, 1:]))}
        if (chunk == 1 and not r["equal"]) or not r["same_ids"] or max(
                r["box_diff_px"], r["h_diff_px"]) > FUSED_SEQ_TOL_PX:
            raise AssertionError(f"fused ({chunk}-frame chunks) != sequential: {r}")
    res["camera_err_px"] = camera_error(sh[:, 1:].reshape(-1, 3, 3), sh[:, 0].astype(int), reader)
    return res


def path_kernels(detector: Detector, frame: np.ndarray, device: str, reps: int) -> dict:
    """Both kernels on the sequential path's own per-frame inputs: FAST on
    the Stabilizer's gray of ``frame``, the HWC gather on what
    ``embed_boxes`` gives it for ``frame`` and its detections (the frame
    itself, pooled in the kernel); each exact against its plain version,
    timed with its bound on the card (``hwc_kernel_check``)."""
    x = torch.as_tensor(frame).to(device)
    gray = features.downsample(features.rgb_to_gray(x), 0.5)[None].contiguous()
    if not torch.equal(fast.fast_score_map(gray, 20.0), fast.fast_score_map_torch(gray, 20.0)):
        raise AssertionError("FAST kernel != plain on the sequential path's gray")
    seen = {}
    det = detector(x)
    embed_boxes(x[None], det["boxes_xywh"][None], gather=hwc_recorder(seen))
    res = {"gray_shape": tuple(gray.shape), "gather": hwc_kernel_check(seen, reps)}
    if device == "cuda":
        res["fast"] = time_fast(gray, reps)
        res["embed_ms"] = cuda_ms(lambda: embed_boxes(x[None], det["boxes_xywh"][None]), reps)
    return res


def rtdetr_card_vs_cpu(model, frame: np.ndarray, config: dict, imgsz: int) -> dict:
    """One frame through the Detector at ``imgsz`` on the model's device and
    on a CPU copy of the model: equal valid slots and classes, scores
    within RTDETR_SCORE_TOL, each box within RTDETR_BOX_TOL_PX of the CPU's
    box in its slot or in a slot of the same class whose score ties."""
    import copy

    cfg = {**config["ultralytics"], "imgsz": imgsz}
    dev = Detector(model, cfg, device=str(next(model.parameters()).device))
    cpu = Detector(copy.deepcopy(model).cpu(), cfg, device="cpu")
    a = {k: v.cpu() for k, v in dev(frame).items()}
    b = cpu(frame)
    if not (torch.equal(a["valid"], b["valid"]) and torch.equal(a["classes"], b["classes"])):
        raise AssertionError("RT-DETR on the card and on the CPU differ in valid slots or classes")
    score_err = float((a["scores"] - b["scores"]).abs().max())
    tie = ((a["scores"][:, None] - b["scores"][None, :]).abs() <= RTDETR_SCORE_TOL) & (
        a["classes"][:, None] == b["classes"][None, :])
    dist = (a["boxes_xywh"][:, None, :] - b["boxes_xywh"][None, :, :]).abs().amax(-1)
    slot_err = dist.diagonal()
    tied_err = torch.where(tie, dist, torch.inf).amin(1)
    box_err = float(torch.minimum(slot_err, tied_err).max())
    if score_err > RTDETR_SCORE_TOL or box_err > RTDETR_BOX_TOL_PX:
        raise AssertionError(f"RT-DETR card vs CPU: scores {score_err}, boxes {box_err} px")
    return {"score_err": score_err, "box_err_px": box_err, "slot_box_err_px": float(slot_err.max()),
            "valid": int(a["valid"].sum())}


def phase_sequential(device: str = "cuda", width: int = 3840, height: int = 2160,
                     n_frames: int = SEQ_FRAMES, imgsz: int = 1920, seed: int = 0,
                     tol_px: float = 2.0, check_imgsz: int = RTDETR_CHECK_IMGSZ,
                     variant: str = "s", rsift_features: int = 2000, reps: int = 10) -> dict:
    """The sequential per-frame path on ``n_frames`` frames of a drifting
    video with ``vehicles_per_frame`` vehicles: (a) fused == sequential,
    (b) YOLOv8 with the rsift stabilizer through ``run_extraction`` (one
    ``detect_batch`` group), (c) RT-DETR-L (ULSpec's published widths, nc=4,
    random weights calibrated to the vehicle count) with the orb stabilizer
    and ReID through ``run_extraction``, its forward timed and bounded,
    card against CPU at ``check_imgsz``, and both kernels on the path's own
    per-frame inputs."""
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    vehicles = vehicles_per_frame(width, height)
    reader = smoke_reader(width, height, seed, n_frames,
                          boxes=vehicle_boxes(width, height, vehicles, seed))
    frames = make_frames(reader)
    info = reader.info
    res = {"vehicles": vehicles, "frames": n_frames, "size": (width, height), "imgsz": imgsz,
           "check_imgsz": check_imgsz, "variant": variant}
    t0 = time.perf_counter()
    res["a"] = fused_vs_sequential(frames, reader, device, imgsz, vehicles)
    res["a"]["s"] = time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        from geotrax_tpu_torch.models import convert

        # (b) YOLOv8 and the rsift stabilizer, as a user's -c copy runs them
        t0 = time.perf_counter()
        model = yolov8.init_params(torch.Generator().manual_seed(seed),
                                   yolov8.ModelSpec(variant=variant, nc=4), device=device)
        det = Detector(model, smoke_config(imgsz)["ultralytics"], device=device)
        res["b_detections_frame0"] = calibrate_class_bias(det, frames[0][1], vehicles)
        convert.save_npz(tmp / "yolo.npz", det.model)
        cfg = config_file(tmp / "rsift.yaml", imgsz, **{
            "  detector_name: 'orb'           # [orb, sift, rsift, brisk, kaze, akaze]\n":
            "  detector_name: rsift\n",
            "  max_features: 2000\n  ref_multiplier":
            f"  max_features: {rsift_features}\n  ref_multiplier"})
        batches = []
        detect_batch = Detector.detect_batch

        def counted(self, frames_u8):
            batches.append(len(frames_u8))
            return detect_batch(self, frames_u8)

        Detector.detect_batch = counted
        reset_launches()
        try:
            stats = run_extraction_in_memory(cli_args(tmp / "V_rsift.mp4", cfg, tmp / "yolo.npz",
                                                      device), frames, info)
        finally:
            Detector.detect_batch = detect_batch
        sync()
        if batches != [n_frames] or launches() != {"fast_score": 0, "patch_gather": 0}:
            raise AssertionError(f"rsift run: detect_batch groups {batches}, launches {launches()}")
        res["b"] = {"stats": stats, "s": time.perf_counter() - t0, "checks": check_files(
            stats["tracks_file"], stats["transforms_file"], stats.get("metadata_file"), n_frames,
            reader, tol_px, may_lack_tracks=True)}
        del det, model

        # (c) RT-DETR-L at its published widths, orb stabilizer and ReID
        t0 = time.perf_counter()
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        ul = rtdetr_ul.init_params(torch.Generator().manual_seed(seed), rtdetr_ul.ULSpec(nc=4),
                                   device=device)
        cfg = config_file(tmp / "rtdetr_reid.yaml", imgsz, **REID_ON)
        config_c = port_cfg.load_config(cfg)
        det = Detector(ul, config_c["ultralytics"], device=device)
        res["c_detections_frame0"] = calibrate_rtdetr_bias(det, frames[0][1], vehicles)
        placeholder = tmp / "rtdetr-l.pt"  # the detector comes from memory (load_detector)
        torch.save({"class_names": {0: "car", 1: "bus", 2: "truck", 3: "motorcycle"}}, placeholder)
        reset_launches()
        stats = run_extraction_in_memory(cli_args(tmp / "V_rtdetr.mp4", cfg, placeholder, device),
                                         frames, info, detector=det)
        sync()
        res["c_launches"] = launches()
        expected = {"fast_score": n_frames * (device == "cuda"),
                    "patch_gather": n_frames * (device == "cuda")}
        if res["c_launches"] != expected:
            raise AssertionError(f"RT-DETR run: launches {res['c_launches']}, expected {expected}")
        res["c"] = {"stats": stats, "s": time.perf_counter() - t0, "checks": check_files(
            stats["tracks_file"], stats["transforms_file"], stats.get("metadata_file"), n_frames,
            reader, tol_px, may_lack_tracks=True)}
        if device == "cuda":
            res["c"]["peak_gib"] = (torch.cuda.max_memory_allocated() - base) / 2**30

    x = torch.as_tensor(np.stack([f for _, f in frames[:1]])).to(device)
    imgs = rtdetr_images(x, imgsz)
    with torch.no_grad():
        dets = det.detect_batch(x)
        res["c_valid_frame0"] = int(dets["valid"].sum())
        with CountFlops() as counter:
            rtdetr_ul.forward(det.model, imgs, det.spec)
        res["c_flops"] = counter.flops
        res["c_bound_ms"] = res["c_flops"] / FP32_FLOP_PER_S * 1e3
        if device == "cuda":
            res["c_forward_ms"] = cuda_ms(lambda: rtdetr_ul.forward(det.model, imgs, det.spec), 5)
            res["c_detect_ms"] = cuda_ms(lambda: det.detect_batch(x), 5)
    res["c_card_vs_cpu"] = rtdetr_card_vs_cpu(det.model, frames[0][1], config_c, check_imgsz)
    res["kernels"] = path_kernels(det, frames[0][1], device, reps)
    return res


# --------------------------------------------------------------------------
# the lockstep multi-video path (batch --parallel-videos)
# --------------------------------------------------------------------------

# Four videos of one resolution, one shorter, so that the group goes ragged.
LOCK_LENGTHS = (16, 16, 16, 12)
# each video's own camera drift per frame (px right, px down, degrees, zoom)
LOCK_CAMERAS = ((1.0, -0.5, 0.01, 1.0001), (-0.8, 0.6, -0.012, 0.9999),
                (0.6, 0.9, 0.006, 1.0), (-1.1, -0.4, 0.0, 1.00005))
LOCK_TRACKER = {"bytetrack": "  active: bytetrack\n", "botsort": "  active: botsort\n"}
STABILIZE_OFF = {"  stabilize: true        # append stabilized box columns to the tracks file\n":
                 "  stabilize: false\n"}


class LockstepOracle:
    """The readers' vehicles as detections with the lockstep's batch
    interface: at call t the videos longer than t are the batch, in video
    order (as tests/test_parallel_extract.py's oracle)."""

    is_rtdetr = False

    def __init__(self, readers, max_det: int, device: str):
        self.lengths = [r.n_frames for r in readers]
        self.oracles = [OracleDetector(lambda i, r=r: [list(b) + [0.9, 0] for b in r.boxes_at(i)],
                                       max_det=max_det, device=device) for r in readers]
        self.max_det, self.class_names = max_det, self.oracles[0].class_names
        self._frame = 0

    def detect_batch(self, stacked):
        live = [v for v, n in enumerate(self.lengths) if n > self._frame]
        if stacked.shape[0] != len(live):
            raise AssertionError(f"step {self._frame}: {stacked.shape[0]} frames, {len(live)} live")
        outs = [self.oracles[v](None, self._frame) for v in live]
        self._frame += 1
        return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


class InMemory:
    """The lockstep's patch points (the reference's test patch points):
    ``open_reader`` gives each source's frames from memory, ``load_detector``
    the detector given, ``probe_video`` each source's size."""

    def __init__(self, videos: dict, detector):
        from geotrax_tpu_torch.io import video

        self.videos, self.detector, self.video = videos, detector, video

    def __enter__(self):
        self.saved = (port_extract.open_reader, port_extract.load_detector, self.video.probe_video)
        port_extract.open_reader = lambda src, start, stop, config: FrameList(
            *self.videos[Path(src).name])
        port_extract.load_detector = lambda config, logger: self.detector
        self.video.probe_video = lambda src, backend=None: self.videos[Path(src).name][0]
        return self

    def __exit__(self, *exc):
        port_extract.open_reader, port_extract.load_detector, self.video.probe_video = self.saved


def lockstep_args(folder: Path, cfg: str, model, device: str, *argv):
    """``batch``'s arguments for ``folder``: no georeferencing, and visualize
    and plot turned off (the render phase runs them)."""
    from geotrax_tpu_torch.pipeline import batch as port_batch

    return port_batch.parse_cli_args(
        [str(folder), "-m", str(model), "-c", cfg, "--device", device, "--no-geo", "--no-save",
         "--no-show", "--no-plot-save", "--no-plot-show", "--log-path", str(folder / "logs"),
         *argv])


def run_lockstep(sources, cfg: str, model, device: str, **args_extra) -> dict:
    """``extract_videos_batch`` on ``sources`` as ``batch`` calls it."""
    from geotrax_tpu_torch.parallel.extract_batch import extract_videos_batch
    from geotrax_tpu_torch.utils.config_utils import load_config_all

    args = lockstep_args(sources[0].parent, cfg, model, device, "--parallel-videos",
                         str(len(sources)))
    for k, v in args_extra.items():
        setattr(args, k, v)
    args.source = sources[0]
    config = load_config_all(args, port_extract._LOG, needs_model=True)
    return extract_videos_batch(sources, args, config, port_extract._LOG)


def read_run(tracks_file, transforms_file=None) -> tuple:
    tracks = np.loadtxt(tracks_file, delimiter=",", ndmin=2) if Path(tracks_file).exists() else None
    transf = (np.loadtxt(transforms_file, delimiter=",", ndmin=2)
              if transforms_file is not None and Path(transforms_file).exists() else None)
    return tracks, transf


def column_diffs(a: np.ndarray, b: np.ndarray) -> list:
    return [float(np.abs(a[:, c] - b[:, c]).max()) for c in range(a.shape[1])]


def lockstep_oracle_runs(tmp: Path, readers, frames, sources, model, imgsz: int,
                         device: str, edits: dict) -> dict:
    """(a) The readers' vehicles as oracle detections, stabilization off,
    bytetrack and botsort: each video's lockstep files against
    ``run_extraction`` of that video alone (its detector without a batch
    interface: the sequential per-frame loop)."""
    from geotrax_tpu_torch.models.detector import SequentialOnly

    vehicles = vehicles_per_frame(readers[0].info.width, readers[0].info.height)
    res = {}
    for tracker, line in LOCK_TRACKER.items():
        cfg = config_file(tmp / f"lock_{tracker}.yaml", imgsz,
                          **{"  active: botsort\n": line}, **STABILIZE_OFF, **edits)
        oracle = LockstepOracle(readers, 2 * vehicles, device)
        with InMemory({s.name: (r.info, f) for s, r, f in zip(sources, readers, frames)}, oracle):
            run_lockstep(sources, cfg, model, device)
        lock = [read_run(s.parent / "results" / f"{s.stem}.txt") for s in sources]
        out = res[tracker] = {"equal": True, "rows": 0, "col_diff": None}
        for v, (src, reader) in enumerate(zip(sources, readers)):
            single = SequentialOnly(LockstepOracle([reader], 2 * vehicles, device).oracles[0])
            seq_dir = tmp / f"seq_{tracker}"
            run_extraction_in_memory(cli_args(src, cfg, model, device,
                                              argv=["-of", str(seq_dir)]),
                                     frames[v], reader.info, detector=single)
            seq = read_run(seq_dir / f"{src.stem}.txt")[0]
            got = lock[v][0]
            if got is None or seq is None or got.shape != seq.shape:
                raise AssertionError(f"(a) {tracker} video {v}: lockstep rows "
                                     f"{None if got is None else got.shape} vs sequential "
                                     f"{None if seq is None else seq.shape}")
            out["rows"] += len(got)
            if not np.array_equal(got, seq, equal_nan=True):
                out["equal"] = False
                diffs = column_diffs(got, seq)
                out["col_diff"] = [max(a, b) for a, b in zip(out["col_diff"] or diffs, diffs)]
                # frame, id, class and score exact; geometry within the card's rounding
                if max(diffs[0], diffs[1], diffs[6], diffs[7]) > 0 or max(diffs[2:6]) > \
                        FUSED_SEQ_TOL_PX:
                    raise AssertionError(f"(a) {tracker} video {v}: lockstep != sequential, "
                                         f"largest difference per column {diffs}")
    return res


PROFILE_STEPS = 3


def lockstep_profile(sources, cfg: str, model, device: str, readers, frames, detector,
                     steps: int) -> dict:
    """The first ``steps`` frames of each video through the lockstep under
    torch.profiler: host and device ms of each ``lock.*`` range per step
    (host times inflated by the profiler), the device's busy ms."""
    from torch.profiler import ProfilerActivity, profile

    videos = {s.name: (r.info, f[:steps]) for s, r, f in zip(sources, readers, frames)}
    with InMemory(videos, detector):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run_lockstep(sources, cfg, model, device)
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return {"wall_ms": wall_ms, "steps": steps, **profile_ranges(prof, "lock.")}


def lockstep_kernels(detector, frames: list, device: str, reps: int) -> dict:
    """Both kernels on this phase's own inputs: FAST on the four grays of
    the first step after the reference, the HWC gather on what
    ``embed_boxes`` gives it for those frames and their detections; exact
    against their plain versions, timed with their bounds on the card."""
    x = torch.as_tensor(np.stack([f[1][1] for f in frames])).to(device)
    gray = features.downsample(features.rgb_to_gray(x), 0.5).contiguous()
    if not torch.equal(fast.fast_score_map(gray, 20.0), fast.fast_score_map_torch(gray, 20.0)):
        raise AssertionError("FAST kernel != plain on the lockstep step's grays")
    seen = {}
    with torch.no_grad():
        det = detector.detect_batch(x)
        embed_boxes(x, det["boxes_xywh"], gather=hwc_recorder(seen))
    res = {"gray_shape": tuple(gray.shape), "gather": hwc_kernel_check(seen, reps)}
    res["fast_bound_ms"], res["fast_bound_by"] = fast_bound_ms(tuple(gray.shape))
    if device == "cuda":
        res["fast"] = time_fast(gray, reps)
        res["embed_ms"] = cuda_ms(lambda: embed_boxes(x, det["boxes_xywh"]), reps)
        # the detector per frame at the step's batch and at four times it
        with torch.no_grad():
            res["detect_ms_per_frame"] = {
                len(b): cuda_ms(lambda b=b: detector.detect_batch(b), 3, warmup=1) / len(b)
                for b in (x, x.repeat(4, 1, 1, 1))}
    return res


def phase_lockstep(detector=None, device: str = "cuda", width: int = 3840, height: int = 2160,
                   lengths=LOCK_LENGTHS, imgsz: int = 1920, variant: str = "s", seed: int = 0,
                   tol_px: float = 2.0, max_det: int = 1000, max_features: int = 2000,
                   rounds: int = 2, reps: int = 10) -> dict:
    """The lockstep multi-video path (``batch --parallel-videos 4``) on four
    drifting videos of ``lengths`` frames with ``vehicles_per_frame``
    vehicles each: (a) oracle detections, stabilization off, lockstep ==
    sequential per video; (b) YOLOv8 (``detector``, or a calibrated random
    one) with ReID under the default preset through
    ``extract_videos_batch``: files, homographies, launches, embeddings,
    ms per step, frames/s against the videos one after another through
    ``run_extraction`` (in turns), peak memory; (c) both kernels on the
    phase's own inputs; (d) ``batch`` as users run it, twice. ``max_det``
    and ``max_features`` (the preset's 1000 and 2000) shrink the rehearsal
    on the CPU."""
    from geotrax_tpu_torch.io import yaml_load
    from geotrax_tpu_torch.parallel import extract_batch
    from geotrax_tpu_torch.pipeline import batch as port_batch

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    vehicles = vehicles_per_frame(width, height)
    readers = [SyntheticVideoReader(width=width, height=height, n_frames=n, seed=seed + 1 + v,
                                    camera=LOCK_CAMERAS[v % len(LOCK_CAMERAS)],
                                    boxes=vehicle_boxes(width, height, vehicles, seed + 1 + v))
               for v, n in enumerate(lengths)]
    frames = [make_frames(r) for r in readers]
    steps, n_total = max(lengths), sum(lengths)
    res = {"vehicles": vehicles, "lengths": list(lengths), "size": (width, height),
           "imgsz": imgsz}
    edits = {} if max_det == 1000 else {"  max_det: 1000\n": f"  max_det: {max_det}\n"}
    if max_features != 2000:
        edits["  max_features: 2000\n  ref_multiplier"] = \
            f"  max_features: {max_features}\n  ref_multiplier"
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        folder = tmp / "campaign"
        folder.mkdir()
        sources = [folder / f"V{v}.mp4" for v in range(len(lengths))]
        for s in sources:
            s.write_bytes(b"placeholder")  # never decoded: the frames are in memory
        model = tmp / "model.pt"  # the detector comes from memory (load_detector)
        torch.save({"class_names": {0: "car", 1: "bus", 2: "truck", 3: "motorcycle"}}, model)
        videos = {s.name: (r.info, f) for s, r, f in zip(sources, readers, frames)}

        t0 = time.perf_counter()
        res["a"] = lockstep_oracle_runs(tmp, readers, frames, sources, model, imgsz, device, edits)
        for s in sources:
            (folder / "results" / f"{s.stem}.txt").unlink(missing_ok=True)
        res["a_s"] = time.perf_counter() - t0

        # (b) YOLOv8 with ReID under the default preset
        t0 = time.perf_counter()
        if detector is None:
            model_p = yolov8.init_params(torch.Generator().manual_seed(seed),
                                         yolov8.ModelSpec(variant=variant, nc=4), device=device)
            detect_cfg = {**smoke_config(imgsz)["ultralytics"], "max_det": max_det}
            detector = Detector(model_p, detect_cfg, device=device)
            res["detections_frame0"] = calibrate_class_bias(detector, frames[0][0][1], vehicles)
        cfg = config_file(tmp / "lock_reid.yaml", imgsz, **REID_ON, **edits)
        embeddings = []
        embed = extract_batch.embed_boxes

        def kept(*a, **kw):  # the lockstep's embeddings, kept for the norm check
            out = embed(*a, **kw)
            embeddings.append(out)
            return out

        extract_batch.embed_boxes = kept
        runs = {"lockstep": [], "serial": []}
        try:
            with InMemory(videos, detector):
                for r in range(rounds):
                    for mode in ("lockstep", "serial"):
                        if device == "cuda":
                            torch.cuda.reset_peak_memory_stats()
                        reset_launches()
                        t1 = time.perf_counter()
                        if mode == "lockstep":
                            stats = run_lockstep(sources, cfg, model, device)
                        else:
                            stats = [run_extraction_in_memory(
                                cli_args(s, cfg, model, device, argv=["-of", str(tmp / "serial")]),
                                frames[v], readers[v].info) for v, s in enumerate(sources)]
                        sync()
                        wall = time.perf_counter() - t1
                        runs[mode].append({"wall_s": wall, "fps": n_total / wall,
                                           "launches": launches(), "stats": stats,
                                           "peak_gib": (torch.cuda.max_memory_allocated() / 2**30
                                                        if device == "cuda" else None)})
                        if mode == "lockstep" and r == 0:
                            res["b_checks"] = [check_files(
                                st["tracks_file"], st["transforms_file"], st.get("metadata_file"),
                                lengths[v], readers[v], tol_px, may_lack_tracks=True)
                                for v, st in enumerate(stats["videos"])]
                            modes = [yaml_load.safe_load(Path(st["metadata_file"]).read_text())
                                     ["runtime"]["extraction_mode"] for st in stats["videos"]]
                            if modes != [f"parallel-group-{len(lengths)}"] * len(lengths):
                                raise AssertionError(f"(b) extraction modes {modes}")
                            norms = torch.cat([torch.linalg.vector_norm(e, dim=-1).flatten()
                                               for e in embeddings])
                            res["emb_norm_err"] = float((norms - 1).abs().max())
                            res["emb_rows"] = int(norms.numel())
                            if res["emb_norm_err"] > 1e-5 or len(embeddings) != steps:
                                raise AssertionError(f"(b) {len(embeddings)} embedding calls, "
                                                     f"norm error {res['emb_norm_err']}")
        finally:
            extract_batch.embed_boxes = embed
        on_card = device == "cuda"
        expected = {"fast_score": (len(lengths) + steps - 1) * on_card,
                    "patch_gather": steps * on_card}
        for run in runs["lockstep"]:
            if run["launches"] != expected:
                raise AssertionError(f"(b) lockstep launches {run['launches']}, "
                                     f"expected {expected}")
        if device == "cuda":  # one more group of the first frames, under the profiler
            res["b_profile"] = lockstep_profile(sources, cfg, model, device, readers, frames,
                                                detector, PROFILE_STEPS)
        first = runs["lockstep"][0]["stats"]
        last = runs["lockstep"][-1]["stats"]
        step_ms = sorted(s * 1e3 for s in first["step_s"][1:])
        last_ms = sorted(s * 1e3 for s in last["step_s"][1:])
        res["b"] = {"runs": runs, "launches": expected, "steps": first["steps"],
                    "step_ms": [s * 1e3 for s in first["step_s"]],
                    "step_median_ms": step_ms[len(step_ms) // 2],
                    "last_step_ms": [s * 1e3 for s in last["step_s"]],
                    "last_step_median_ms": last_ms[len(last_ms) // 2],
                    "camera_err_px": max(c["camera_err_px"] for c in res["b_checks"]),
                    "rows": sum(c["rows"] for c in res["b_checks"]), "s": time.perf_counter() - t0}

        # (c) both kernels on this phase's own inputs
        t0 = time.perf_counter()
        res["kernels"] = lockstep_kernels(detector, frames, device, reps)
        res["c_s"] = time.perf_counter() - t0

        # (d) batch as users run it: a directory of four videos, then again
        for s in sources:
            for stale in (folder / "results").glob(f"{s.stem}*"):
                stale.unlink()
        t0 = time.perf_counter()
        cfg_default = config_file(tmp / "lock_default.yaml", imgsz, **edits)
        calls = {"lockstep": 0, "per_file": 0}
        batch_fn, per_file = extract_batch.extract_videos_batch, port_batch.detect_track_stabilize

        def counted_batch(*a, **kw):
            calls["lockstep"] += 1
            return batch_fn(*a, **kw)

        def counted_file(*a, **kw):
            calls["per_file"] += 1
            return per_file(*a, **kw)

        extract_batch.extract_videos_batch = counted_batch
        port_batch.detect_track_stabilize = counted_file
        try:
            # the readers' vehicles as detections, so that every video keeps
            # tracks and so a tracks file, the extract stage's checkpoint
            with InMemory(videos, LockstepOracle(readers, 2 * vehicles, device)):
                for run in range(2):
                    args = lockstep_args(folder, cfg_default, model, device,
                                         "--parallel-videos", str(len(lengths)), "-y")
                    before = dict(calls)
                    port_batch.process_input(args, port_extract._LOG)
                    res[f"d_calls_{run}"] = {k: calls[k] - before[k] for k in calls}
        finally:
            extract_batch.extract_videos_batch = batch_fn
            port_batch.detect_track_stabilize = per_file
        modes = [yaml_load.safe_load(s.with_suffix(".yaml").read_text())["runtime"]
                 ["extraction_mode"] for s in sources]
        if modes != [f"parallel-group-{len(lengths)}"] * len(lengths):
            raise AssertionError(f"(d) extraction modes {modes}")
        if res["d_calls_0"] != {"lockstep": 1, "per_file": 0} or res["d_calls_1"] != {
                "lockstep": 0, "per_file": 0}:
            raise AssertionError(f"(d) stage calls {res['d_calls_0']}, then {res['d_calls_1']}")
        res["d_modes"] = modes
        res["d_s"] = time.perf_counter() - t0
    return res


# --------------------------------------------------------------------------
# render: visualize and plot (phase 13)
# --------------------------------------------------------------------------

RENDER_FRAMES = 16
RENDER_CLASSES = ["0=car", "1=bus", "2=truck", "3=motorcycle"]
# metres per pixel of 4K drone footage at the altitude of the georef phase
RENDER_GSD_M = 0.1
# the figures plot_dataset names for a georeferenced CSV (no pixel columns)
GEO_FIGURES = ["Orthophoto_image_coordinates", "Local_planar_coordinates",
               "Geographic_coordinates", "Speed_distribution", "Acceleration_distribution",
               "Speed_and_acceleration_distribution", "Class_distribution",
               "Vehicle_length_distribution", "Vehicle_width_distribution"]
# ... and for a tracks file of the extract stage (14 or 15 columns)
TRACK_FIGURES = ["Unstabilized_image_coordinates", "Stabilized_image_coordinates",
                 "Class_distribution", "Vehicle_length_distribution", "Vehicle_width_distribution"]


def render_tracks(reader: SyntheticVideoReader, n_frames: int) -> tuple:
    """The extract stage's 15-column tracks of the reader's vehicles (those
    whose centre is in the frame) and its transforms rows (frames 1..n-1),
    written from the known boxes and camera homographies."""
    w, h = reader.info.width, reader.info.height
    rows, transforms = [], []
    for i in range(n_frames):
        hm = reader.camera_h(i)
        scale = math.sqrt(abs(np.linalg.det(hm[:2, :2])))
        if i > 0:
            transforms.append(np.concatenate([[i], hm.ravel()]))
        for v, (cx, cy, bw, bh) in enumerate(reader.boxes_at(i)):
            if not (0 <= cx < w and 0 <= cy < h):
                continue
            p = hm @ np.array([cx, cy, 1.0])
            sx, sy = p[0] / p[2], p[1] / p[2]
            rows.append([i, v + 1, cx, cy, bw, bh, sx, sy, bw * scale, bh * scale, v % 4,
                         0.5 + 0.5 * ((v * 7) % 10) / 10, max(bw, bh) * scale,
                         min(bw, bh) * scale, float(i % 7 == 6)])
    return np.array(rows), np.array(transforms)


def write_speed_lane_csv(path: Path, tracks: np.ndarray, reader: SyntheticVideoReader) -> None:
    """A georeferenced CSV for the same tracks: speed from each vehicle's
    known motion (px/frame at RENDER_GSD_M m/px and the clip's rate), lane
    from its height in the frame."""
    from geotrax_tpu_torch.io import table

    v = np.array([b["v"] for b in reader.boxes])[tracks[:, 1].astype(int) - 1]
    speed = np.hypot(v[:, 0], v[:, 1]) * reader.info.fps * RENDER_GSD_M * 3.6
    lanes = 1 + (tracks[:, 3] // (reader.info.height / 8)).astype(np.int64)
    table.write_csv(path, {"Frame_Number": tracks[:, 0].astype(np.int64),
                           "Vehicle_ID": tracks[:, 1].astype(np.int64),
                           "Vehicle_Speed": np.round(speed, 2), "Lane_Number": lanes})


def write_plot_csv(path: Path, n_frames: int, vehicles: int, fw: int, fh: int) -> int:
    """A georeferenced CSV of the georef phase's size (``synthetic_tracks``'
    recipe) with the columns plot reads; returns its rows."""
    tr = synthetic_tracks(n_frames, vehicles, fw, fh)
    x, y = tr[:, 6], tr[:, 7]
    ids = tr[:, 1].astype(np.int64)
    speed = np.zeros(len(tr))
    accel = np.zeros(len(tr))
    order = np.lexsort((tr[:, 0], ids))
    same = ids[order][1:] == ids[order][:-1]
    step = np.hypot(np.diff(x[order]), np.diff(y[order])) * GEO_FPS * RENDER_GSD_M * 3.6
    speed[order[1:]] = np.where(same, step, 0.0)
    accel[order[1:]] = np.where(same, np.diff(speed[order]) / 3.6 * GEO_FPS, 0.0)
    cols = {"Vehicle_ID": ids, "Frame_Number": tr[:, 0].astype(np.int64),
            "Ortho_X": GEO_CENTER[0] + x, "Ortho_Y": GEO_CENTER[1] + y,
            "Local_X": 170000.0 + x * RENDER_GSD_M, "Local_Y": 532000.0 - y * RENDER_GSD_M,
            "Latitude": GEO_MOSAIC[1] + (GEO_CENTER[1] + y) * GEO_MOSAIC[3],
            "Longitude": GEO_MOSAIC[0] + (GEO_CENTER[0] + x) * GEO_MOSAIC[2],
            "Vehicle_Length": tr[:, 12] * RENDER_GSD_M, "Vehicle_Width": tr[:, 13] * RENDER_GSD_M,
            "Vehicle_Class": tr[:, 10].astype(np.int64), "Vehicle_Speed": speed,
            "Vehicle_Acceleration": accel,
            "Lane_Number": 1 + (y // (fh / 8)).astype(np.int64)}
    names = list(cols)
    fmt = ["%d" if cols[k].dtype.kind == "i" else "%.6f" for k in names]
    np.savetxt(path, np.stack([cols[k].astype(np.float64) for k in names], 1), fmt=fmt,
               delimiter=",", header=",".join(names), comments="")
    return len(tr)


class FrameSink:
    """The visualize stage's writer in memory: each frame's digest, the
    frames asked to be kept, and ``on_frame`` called with each frame (a
    real writer behind it where there is one)."""

    def __init__(self, on_frame=None, keep_all: bool = False, inner=None):
        self.digests, self.frames = [], []
        self.on_frame, self.keep_all, self.inner = on_frame, keep_all, inner

    def write(self, frame: np.ndarray) -> None:
        import hashlib

        self.digests.append(hashlib.sha1(np.ascontiguousarray(frame).tobytes()).hexdigest())
        if self.keep_all:
            self.frames.append(np.array(frame))
        if self.on_frame is not None:
            self.on_frame(frame, self.digests[-1])
        if self.inner is not None:
            self.inner.write(frame)

    def close(self) -> None:
        if self.inner is not None:
            self.inner.close()


class InMemoryVisualize:
    """The visualize stage's patch points: ``open_reader`` gives each
    source's frames from memory, ``open_writer`` the ``make_writer(path,
    fps, w, h)`` given, ``probe_video`` each source's size."""

    def __init__(self, videos: dict, make_writer):
        from geotrax_tpu_torch.io import video
        from geotrax_tpu_torch.pipeline import visualize as port_visualize

        self.videos, self.make_writer = videos, make_writer
        self.video, self.viz = video, port_visualize

    def __enter__(self):
        self.saved = (self.viz.open_reader, self.viz.open_writer, self.video.probe_video)

        def reader(src, start=0, stop=None):
            info, frames = self.videos[Path(src).name]
            return FrameList(info, [(i, f) for i, f in frames
                                    if i >= start and (stop is None or i < stop)])

        self.viz.open_reader = reader
        self.viz.open_writer = self.make_writer
        self.video.probe_video = lambda src, backend=None: self.videos[Path(src).name][0]
        return self

    def __exit__(self, *exc):
        self.viz.open_reader, self.viz.open_writer, self.video.probe_video = self.saved


def visualize_args(source: Path, mode: int, device: str, logs: Path):
    """``visualize``'s arguments for one mode at the default preset's line
    width and tail, with lanes and class names in the labels."""
    from geotrax_tpu_torch.pipeline import visualize as port_visualize

    return port_visualize.parse_cli_args(
        [str(source), "-vm", str(mode), "--device", device, "--show-lanes",
         "--show-class-names", "-lp", str(logs), "-cn", *RENDER_CLASSES])


def warp_timing(frame: np.ndarray, h_matrix: np.ndarray, device: str, reps: int) -> dict:
    """The warp of one frame on the card (CUDA events) against its bound
    (each input byte read once, each output byte written once), with the
    upload and the download beside it."""
    from geotrax_tpu_torch.ops.warp import invert_homography, warp_perspective

    h, w = frame.shape[:2]
    h_inv = invert_homography(h_matrix)
    host = torch.from_numpy(np.ascontiguousarray(frame))
    moved = 2 * frame.nbytes
    # per pixel: 9 multiply-adds, 2 divides, 4 taps of 3 channels blended (3 fma each)
    ms_bound, by = bound_ms(moved, h * w * (18 + 2 + 12 * 3 + 6))
    res = {"bytes": moved, "bound_ms": ms_bound, "bound_by": by, "shape": (h, w, 3)}
    if device != "cuda":
        t0 = time.perf_counter()
        warp_perspective(host, h_inv, h, w)
        res.update(ms=(time.perf_counter() - t0) * 1e3, upload_ms=None, download_ms=None)
        return res
    on_card = host.to(device)
    out = warp_perspective(on_card, h_inv, h, w)
    res["upload_ms"] = cuda_ms(lambda: host.to(device), reps)
    res["ms"] = cuda_ms(lambda: warp_perspective(on_card, h_inv, h, w), reps)
    res["download_ms"] = cuda_ms(lambda: out.cpu(), reps)
    return res


def plot_run(csv_path: Path, logs: Path) -> dict:
    """``plot`` on one georeferenced CSV: the figures where matplotlib and
    seaborn import, else the data half alone (file choice, the reader,
    class filter, alerts), said so."""
    from geotrax_tpu_torch.pipeline import plot as port_plot

    args = port_plot.parse_cli_args([str(csv_path), "-lp", str(logs)])
    res = {"figures": None}
    try:
        port_plot.pyplot()
        port_plot.seaborn()
    except RuntimeError as exc:
        res["missing"] = str(exc)
    t0 = time.perf_counter()
    if "missing" in res:
        _, _, files = port_plot.prepare(args, port_extract._LOG)
        jobs = port_plot.plot_jobs(args, files, port_extract._LOG)
        for _, _, datasets in jobs:
            port_plot.report_high_value_instances(port_plot.concat([d for _, d in datasets]),
                                                  port_extract._LOG)
        res["rows"] = sum(len(d["Vehicle_ID"]) for _, _, ds in jobs for _, d in ds)
        res["columns"] = sorted(jobs[0][2][0][1])
        if [f.name for f in files] != [csv_path.name] or res["rows"] == 0:
            raise AssertionError(f"(c) plot's data half chose {files}, read {res['rows']} rows")
    else:
        named = []
        save = port_plot._save

        def kept(fig, plots_dir, stem, title, *a, **kw):
            named.append(f"{stem}_{title.replace(' ', '_')}.pdf")
            return save(fig, plots_dir, stem, title, *a, **kw)

        port_plot._save = kept
        try:
            port_plot.generate_plots(args, port_extract._LOG)
        finally:
            port_plot._save = save
        written = sorted(p.name for p in (csv_path.parent / "plots").glob("*.pdf"))
        expected = sorted(f"{csv_path.stem}_{t}.pdf" for t in GEO_FIGURES)
        if sorted(named) != written or written != expected:
            raise AssertionError(f"(c) PDFs {written}, named {sorted(named)}, "
                                 f"expected {expected}")
        res["figures"] = written
    res["s"] = time.perf_counter() - t0
    return res


def phase_render(device: str = "cuda", width: int = 3840, height: int = 2160,
                 n_frames: int = RENDER_FRAMES, lengths=LOCK_LENGTHS, plot_frames: int = GEO_FRAMES,
                 seed: int = 5, edits=None, reps: int = 10) -> dict:
    """``visualize`` and ``plot`` as users run them, and ``batch`` under its
    default gates. (a) the five modes of ``visualize_results`` on a drifting
    clip with ``vehicles_per_frame`` vehicles, its tracks, transforms and a
    georeferenced CSV written from the reader's known boxes and camera, on
    ``device`` and on the CPU: frame counts, the device's frames against
    the CPU's within one grey level; where the decode probe succeeds the
    real writer writes each file and the port's decoder counts its frames;
    (b) ms per frame by mode (read, warp, draw, write) and the warp's
    CUDA-event time against its bound; (c) ``plot`` on a georeferenced CSV
    of the georef phase's size; (d) ``process_input`` on four videos
    without the flags that turn visualize and plot off (``--no-geo``): the
    gates run extract, visualize and plot for each."""
    from geotrax_tpu_torch.io import native
    from geotrax_tpu_torch.io.video import VideoReader, VideoWriter
    from geotrax_tpu_torch.parallel import extract_batch
    from geotrax_tpu_torch.pipeline import batch as port_batch
    from geotrax_tpu_torch.pipeline import plot as port_plot
    from geotrax_tpu_torch.pipeline import visualize as port_visualize

    vehicles = vehicles_per_frame(width, height)
    probe = native.probe()
    res = {"size": (width, height), "frames": n_frames, "vehicles": vehicles,
           "decode": probe["ok"], "probe": probe["found"], "modes": {}}
    reader = SyntheticVideoReader(width=width, height=height, n_frames=n_frames, seed=seed,
                                  camera=CAMERA, boxes=vehicle_boxes(width, height, vehicles, seed))
    frames = make_frames(reader)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        source = tmp / "R_clip.mp4"
        source.write_bytes(b"placeholder")  # never decoded: the frames are in memory
        (tmp / "results").mkdir()
        tracks, transforms = render_tracks(reader, n_frames)
        np.savetxt(tmp / "results" / "R_clip.txt", tracks, fmt="%.6g", delimiter=",")
        np.savetxt(tmp / "results" / "R_clip_vid_transf.txt", transforms, fmt="%.16g",
                   delimiter=",")
        write_speed_lane_csv(tmp / "results" / "R_clip.csv", tracks, reader)
        res["rows"] = len(tracks)
        videos = {source.name: (reader.info, frames)}

        # (a) the five modes, on the CPU and on the device
        t0 = time.perf_counter()
        for mode in range(5):
            runs = {}
            for dev in ("cpu", device) if device != "cpu" else ("cpu",):
                cpu_frames = runs.get("cpu", {}).get("sink")
                diff = {"max": 0, "pixels": 0, "n": 0}

                def compare(frame, digest, ref=cpu_frames, diff=diff):
                    if ref is None:
                        return
                    if digest != ref.digests[diff["n"]]:
                        d = np.abs(frame.astype(np.int16) - ref.frames[diff["n"]])
                        diff["max"] = max(diff["max"], int(d.max()))
                        diff["pixels"] += int((d.max(-1) > 0).sum())
                    diff["n"] += 1

                def make_writer(path, fps, w, h, dev=dev, compare=compare):
                    inner = VideoWriter(path, fps, w, h) if probe["ok"] else None
                    runs[dev]["sink"] = FrameSink(compare, keep_all=dev == "cpu", inner=inner)
                    return runs[dev]["sink"]

                runs[dev] = {}
                with InMemoryVisualize(videos, make_writer):
                    t1 = time.perf_counter()
                    stats = port_visualize.visualize_results(
                        visualize_args(source, mode, dev, tmp / "logs"), port_extract._LOG)[0]
                    runs[dev]["wall_s"] = time.perf_counter() - t1
                runs[dev]["stats"], runs[dev]["diff"] = stats, diff
                if stats["frames"] != n_frames or len(runs[dev]["sink"].digests) != n_frames:
                    raise AssertionError(f"(a) mode {mode} on {dev}: {stats['frames']} frames")
                if probe["ok"]:
                    decoded = sum(1 for _ in VideoReader(stats["path"], backend="native"))
                    if decoded != n_frames:
                        raise AssertionError(f"(a) mode {mode}: {decoded} frames decoded")
                    runs[dev]["decoded"] = decoded
            dev_run = runs[device]
            if device != "cpu":
                diff = dev_run["diff"]
                if diff["n"] != n_frames or diff["max"] > 1:
                    raise AssertionError(f"(a) mode {mode}: {device} vs cpu {diff}")
                same = dev_run["sink"].digests == runs["cpu"]["sink"].digests
                if mode in (0, 2, 3) and not same:
                    raise AssertionError(f"(a) mode {mode} does no device work, yet its frames "
                                         f"differ between {device} and cpu")
            st = dev_run["stats"]
            res["modes"][mode] = {
                "frames": st["frames"], "warped": st["warped"], "wall_s": dev_run["wall_s"],
                "cpu_wall_s": runs["cpu"]["wall_s"], "decoded": dev_run.get("decoded"),
                "max_diff": dev_run["diff"]["max"],
                "share_diff": dev_run["diff"]["pixels"] / (n_frames * width * height),
                **{f"{k}_ms": st[f"{k}_s"] * 1e3 / st["frames"]
                   for k in ("read", "warp", "draw", "write")}}
            del runs
        res["a_s"] = time.perf_counter() - t0

        # (b) the warp alone on one frame
        res["warp"] = warp_timing(frames[1][1], transforms[0, 1:].reshape(3, 3), device, reps)

        # (c) plot on a georeferenced CSV of the georef phase's size
        t0 = time.perf_counter()
        (tmp / "plot" / "results").mkdir(parents=True)
        csv_path = tmp / "plot" / "results" / "A_plot.csv"
        res["plot_rows"] = write_plot_csv(csv_path, plot_frames, vehicles, width, height)
        res["plot"] = plot_run(csv_path, tmp / "logs")
        res["c_s"] = time.perf_counter() - t0

        # (d) batch under its default gates: extract, visualize and plot
        t0 = time.perf_counter()
        res["d"] = render_batch(tmp, device, width, height, lengths, seed, edits,
                                extract_batch, port_batch, port_plot, probe["ok"])
        res["d_s"] = time.perf_counter() - t0
    return res


def render_batch(tmp: Path, device: str, width: int, height: int, lengths, seed: int, edits,
                 extract_batch, port_batch, port_plot, can_write: bool) -> dict:
    """``process_input`` on a directory of ``len(lengths)`` drifting videos
    with the readers' vehicles as detections, ``--parallel-videos`` their
    number and ``--no-geo``, visualize and plot left on: the stage calls."""
    from geotrax_tpu_torch.io.video import VideoWriter

    vehicles = vehicles_per_frame(width, height)
    readers = [SyntheticVideoReader(width=width, height=height, n_frames=n, seed=seed + 1 + v,
                                    camera=LOCK_CAMERAS[v % len(LOCK_CAMERAS)],
                                    boxes=vehicle_boxes(width, height, vehicles, seed + 1 + v))
               for v, n in enumerate(lengths)]
    folder = tmp / "campaign"
    folder.mkdir()
    sources = [folder / f"V{v}.mp4" for v in range(len(lengths))]
    for s in sources:
        s.write_bytes(b"placeholder")
    model = tmp / "model.pt"
    torch.save({"class_names": {0: "car", 1: "bus", 2: "truck", 3: "motorcycle"}}, model)
    videos = {s.name: (r.info, make_frames(r)) for s, r in zip(sources, readers)}
    cfg = config_file(tmp / "render_default.yaml", 1920, **(edits or {}))
    calls = {"lockstep": [], "visualize": [], "plot": []}
    batch_fn, viz_fn, plot_fn = (extract_batch.extract_videos_batch, port_batch.visualize_results,
                                 port_batch.generate_plots)
    frames_written = {}

    def counted_batch(group, *a, **kw):
        calls["lockstep"].append([Path(g).name for g in group])
        return batch_fn(group, *a, **kw)

    def counted_viz(args, logger):
        calls["visualize"].append(Path(args.source).name)
        return viz_fn(args, logger)

    def counted_plot(args, logger):
        calls["plot"].append(Path(args.input).name)
        try:
            port_plot.pyplot()
            port_plot.seaborn()
        except RuntimeError:  # the data half alone, as in (c)
            _, _, files = port_plot.prepare(args, logger)
            for _, _, datasets in port_plot.plot_jobs(args, files, logger):
                port_plot.report_high_value_instances(datasets[0][1], logger)
            return None
        return plot_fn(args, logger)

    def make_writer(path, fps, w, h):
        sink = FrameSink(inner=VideoWriter(path, fps, w, h) if can_write else None)
        frames_written[Path(path).name] = sink.digests
        return sink

    extract_batch.extract_videos_batch = counted_batch
    port_batch.visualize_results, port_batch.generate_plots = counted_viz, counted_plot
    try:
        with InMemory(videos, LockstepOracle(readers, 2 * vehicles, device)), \
                InMemoryVisualize(videos, make_writer):
            args = port_batch.parse_cli_args(
                [str(folder), "-m", str(model), "-c", cfg, "--device", device, "--no-geo",
                 "--parallel-videos", str(len(lengths)), "-y", "--log-path", str(folder / "logs")])
            port_batch.process_input(args, port_extract._LOG)
    finally:
        extract_batch.extract_videos_batch = batch_fn
        port_batch.visualize_results, port_batch.generate_plots = viz_fn, plot_fn
    names = [s.name for s in sources]
    want_frames = {f"V{v}_mode_0.mp4": n for v, n in enumerate(lengths)}
    got_frames = {k: len(v) for k, v in frames_written.items()}
    if (calls["lockstep"] != [names] or calls["visualize"] != names
            or calls["plot"] != [folder.name] or got_frames != want_frames):
        raise AssertionError(f"(d) stage calls {calls}, frames written {got_frames}")
    pdfs = sorted(p.name for p in (folder / "results" / "plots").glob("*.pdf"))
    if calls["plot"] and pdfs:
        want = sorted(f"V{v}_{t}.pdf" for v in range(len(lengths)) for t in TRACK_FIGURES)
        if pdfs != want:
            raise AssertionError(f"(d) PDFs {pdfs}, expected {want}")
    return {"calls": calls, "frames_written": got_frames, "pdfs": len(pdfs)}


# ---------------------------------------------------------------------------
# phase 14: train
# ---------------------------------------------------------------------------

TRAIN_IMAGES = (16, 8)      # train, val images of the smoke's dataset
TRAIN_EPOCHS = 2
TRAIN_CHECK_IMGSZ, TRAIN_CHECK_BATCH = 640, 2
TRAIN_TIMED_STEPS = 4
# rel L2 error of one step's loss against the CPU's, and of each parameter's
# gradient on the card against float64 on the CPU (the CPU's own float32
# gradients can be further off: its convolutions' weight gradients sum long
# rows in float32, PERF.md PR 12)
TRAIN_GRAD_TOL = 1e-4
# a class's footprint at 4K aerial scale (long x short side, px): car, bus,
# truck, motorcycle
TRAIN_VEHICLE_PX = ((90, 40), (240, 60), (180, 60), (40, 18))
TRAIN_FILES = ("last.npz", "best.npz", "trainer_state.npz", "results.csv", "metrics.jsonl",
               "history.json", "val_summary.json")
# the fine-tuned checkpoint's head: its last convolutions' random weights
# scaled by this, box bins biased to 2 strides a side (small aerial boxes)
TRAIN_HEAD_SCALE, TRAIN_BOX_BIN, TRAIN_BOX_BIAS = 0.1, 2, 4.0


def train_start_model(seed: int, device: str) -> yolov8.YOLOv8:
    """The smoke's stand-in for a pretrained YOLOv8s (nc=4): seeded random
    weights with a detector's head priors, the class biases at ultralytics'
    ``Detect.bias_init`` (log(5 / nc / (640 / stride)^2)) and the box bins
    biased to small boxes. From the plain random init the BCE over 75,600
    background anchors dominates, no anchor is assigned and the second
    epoch's updates diverge; users fine-tune from a trained checkpoint."""
    spec = yolov8.ModelSpec(variant="s", nc=4)
    model = yolov8.init_params(torch.Generator().manual_seed(seed), spec, device="cpu")
    head = model.layers[str(spec.head_index)]
    with torch.no_grad():
        for k, stride in enumerate(spec.strides):
            box, cls = head.cv2[k][2], head.cv3[k][2]
            box.weight.mul_(TRAIN_HEAD_SCALE)
            cls.weight.mul_(TRAIN_HEAD_SCALE)
            cls.bias.fill_(math.log(5 / spec.nc / (640 / stride) ** 2))
            bins = torch.zeros(4, spec.reg_max)
            bins[:, TRAIN_BOX_BIN] = TRAIN_BOX_BIAS
            box.bias.copy_(bins.reshape(-1))
    return model.to(resolve_device(device))


def write_train_dataset(root: Path, width: int, height: int, counts=TRAIN_IMAGES,
                        vehicles: int = VEHICLES_PER_4K_FRAME, seed: int = 5) -> int:
    """A YOLO-format dataset (images/{train,val}/*.png through the port's
    PNG writer, labels/{train,val}/*.txt) of width x height aerial-like
    images: a blocky asphalt texture and ``vehicles`` boxes each over
    classes 0-3. Returns the number of labels."""
    from geotrax_tpu_torch.io.png import write_png

    rng = np.random.default_rng(seed)
    n_labels = 0
    for split, n in zip(("train", "val"), counts):
        (root / "images" / split).mkdir(parents=True)
        (root / "labels" / split).mkdir(parents=True)
        for i in range(n):
            base = rng.integers(60, 120, (-(-height // 16), -(-width // 16), 3), dtype=np.uint8)
            img = np.repeat(np.repeat(base, 16, 0), 16, 1)[:height, :width].copy()
            lines = []
            for _ in range(vehicles):
                c = int(rng.integers(0, 4))
                long, short = TRAIN_VEHICLE_PX[c]
                bw, bh = (long, short) if rng.uniform() < 0.5 else (short, long)
                bw, bh = min(bw, width - 1), min(bh, height - 1)
                x0, y0 = int(rng.integers(0, width - bw)), int(rng.integers(0, height - bh))
                img[y0:y0 + bh, x0:x0 + bw] = rng.integers(0, 256, 3, dtype=np.uint8)
                lines.append(f"{c} {(x0 + bw / 2) / width:.6f} {(y0 + bh / 2) / height:.6f} "
                             f"{bw / width:.6f} {bh / height:.6f}")
            write_png(root / "images" / split / f"{i:03d}.png", img, compress_level=1)
            (root / "labels" / split / f"{i:03d}.txt").write_text("\n".join(lines) + "\n")
            n_labels += len(lines)
    return n_labels


def train_argv(data: Path, model: Path, out: Path, epochs: int, device: str, *extra) -> list:
    return ["--data", str(data), "--model", str(model), "-c", "default", "--epochs", str(epochs),
            "--out", str(out), "--no-tb", "--device", device, *extra]


def check_train_run(out: Path, epochs: int, steps_per_epoch: int, n_params: int) -> dict:
    """Every file of a run, one row per epoch, finite losses, the optimizer
    state's leaves and count."""
    missing = [f for f in TRAIN_FILES if not (out / f).exists()]
    if missing:
        raise AssertionError(f"train run in {out} wrote no {missing}")
    rows = [json.loads(ln) for ln in (out / "metrics.jsonl").read_text().splitlines()]
    csv_rows = (out / "results.csv").read_text().splitlines()
    history = json.loads((out / "history.json").read_text())
    summary = json.loads((out / "val_summary.json").read_text())
    if [r["epoch"] for r in rows] != list(range(epochs)) or len(csv_rows) != epochs + 1:
        raise AssertionError(f"{out}: epochs {[r['epoch'] for r in rows]}, "
                             f"{len(csv_rows)} csv rows")
    if len(history) != epochs or "single_cls_val" not in summary:
        raise AssertionError(f"{out}: history of {len(history)} epochs, summary {list(summary)}")
    losses = [r["loss"] for r in rows]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{out}: losses {losses}")
    if not all(np.isfinite(v).all() for v in npz_params(out / "last.npz").values()):
        raise AssertionError(f"{out}: last.npz holds non-finite weights")
    with np.load(out / "trainer_state.npz") as z:
        leaves = [k for k in z.files if k.startswith("leaf_")]
        count = int(z[f"leaf_{n_params}"])
    if len(leaves) != n_params + 1 or count != epochs * steps_per_epoch:
        raise AssertionError(f"{out}: {len(leaves)} state leaves for {n_params} parameters, "
                             f"count {count}")
    return {"losses": losses, "lr": [r["lr"] for r in rows], "map50": [r["map50"] for r in rows],
            "epoch_s": [r["epoch_s"] for r in rows], "count": count}


def npz_params(path: Path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files if k.startswith("param:")}


class CachedLoader:
    """Batches already in memory, served as a loader's epoch."""

    def __init__(self, batches):
        self.batches = batches

    def epoch(self, epoch_idx: int = 0):
        return iter(self.batches)


def train_step_card_vs_cpu(data: Path, device: str, imgsz: int, batch: int, seed: int) -> dict:
    """One loss and backward of the seeded start model on a loader batch at
    ``imgsz``: on the card, on the CPU, and on the CPU in float64 (the
    reference both float32 runs are held to). Relative L2 errors per
    parameter (of its norm, or of 1e-6 of the whole gradient's norm where
    that is larger) and over all parameters at once. Fails if the card is
    off the float64 gradients by more than TRAIN_GRAD_TOL, or off the CPU
    by more than the CPU's own error allows."""
    import copy

    from geotrax_tpu_torch.models.convert import param_leaves
    from geotrax_tpu_torch.models.loss import detection_loss
    from geotrax_tpu_torch.train.data import Loader

    spec = yolov8.ModelSpec(variant="s", nc=4)
    b = next(Loader(data, "train", imgsz=imgsz, batch_size=batch, training=True).epoch(0))
    cpu = train_start_model(seed, "cpu")
    out = {}
    for name, model in (("cpu", cpu), ("card", copy.deepcopy(cpu).to(resolve_device(device))),
                        ("f64", copy.deepcopy(cpu).double())):
        model.requires_grad_(True)
        p0 = next(model.parameters())
        images, boxes, cls, mask = (torch.from_numpy(b[k]).to(p0.device) for k in (
            "images", "gt_boxes", "gt_cls", "gt_mask"))
        loss, metrics = detection_loss(model, images.to(p0.dtype), boxes.to(p0.dtype), cls, mask,
                                       spec)
        loss.backward()
        out[name] = (float(loss.detach()), int(metrics["fg"]),
                     [p.grad.detach().cpu().double() for p in param_leaves(model)])
    ref = out["f64"][2]
    floor = 1e-6 * float(torch.linalg.norm(torch.cat([g.flatten() for g in ref])))

    def errors(a, b):
        per = [float(torch.linalg.norm(x - y)) / max(float(torch.linalg.norm(y)), floor)
               for x, y in zip(out[a][2], out[b][2])]
        flat = [torch.cat([g.flatten() for g in out[k][2]]) for k in (a, b)]
        return max(per), float(torch.linalg.norm(flat[0] - flat[1]) / torch.linalg.norm(flat[1]))

    res = {"loss_cpu": out["cpu"][0], "loss_card": out["card"][0], "loss_f64": out["f64"][0],
           "fg": (out["cpu"][1], out["card"][1], out["f64"][1]), "params": len(ref)}
    res["loss_rel"] = abs(res["loss_card"] - res["loss_cpu"]) / abs(res["loss_cpu"])
    for a, b_ in (("card", "cpu"), ("card", "f64"), ("cpu", "f64")):
        res[f"{a}_{b_}_max"], res[f"{a}_{b_}_all"] = errors(a, b_)
    if len(set(res["fg"])) != 1 or not res["fg"][0] or res["loss_rel"] > TRAIN_GRAD_TOL \
            or res["card_f64_max"] > TRAIN_GRAD_TOL \
            or res["card_cpu_all"] > res["cpu_f64_all"] + TRAIN_GRAD_TOL:
        raise AssertionError(f"train step on the card vs the CPU: {res}")
    return res


def time_train_steps(data: Path, device: str, imgsz: int, batch: int, steps: int,
                     seed: int, hp: dict) -> dict:
    """The trainer's synchronous loop, instrumented: two loader batches
    (host ms each), then ``steps`` train steps on them in turn, each with
    CUDA events after the forward with the loss, the backward and the
    update, and its host wall time (upload to the loss read); the device's
    idle share of the loop (loader + step); peak memory; the step's FLOPs
    and bound; evaluate on the val batches already loaded, ms per image,
    and its forward + NMS alone. ``hp`` is the preset's ultralytics
    section (the optimizer's settings)."""
    from geotrax_tpu_torch.models.convert import param_leaves
    from geotrax_tpu_torch.models.loss import detection_loss
    from geotrax_tpu_torch.ops.nms import postprocess_detections
    from geotrax_tpu_torch.parallel.mesh import make_train_step
    from geotrax_tpu_torch.train.data import Loader
    from geotrax_tpu_torch.train.train import evaluate

    spec = yolov8.ModelSpec(variant="s", nc=4)
    model = train_start_model(seed, device)
    model.requires_grad_(True)
    loader = Loader(data, "train", imgsz=imgsz, batch_size=batch, training=True)
    batches, load_ms = [], []
    it = loader.epoch(0)
    for _ in range(min(2, len(loader))):
        t = time.perf_counter()
        b = next(it)
        load_ms.append((time.perf_counter() - t) * 1e3)
        b.pop("n_valid")
        batches.append(b)
    optimizer = preset_optimizer(hp, len(loader))
    step = make_train_step(spec, optimizer)
    params = param_leaves(model)
    state = optimizer.init(params)

    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    rows = []
    for i in range(steps):
        marks = Marks(cuda)
        t = time.perf_counter()
        b = {k: torch.from_numpy(v).to(device) for k, v in batches[i % len(batches)].items()}
        marks("start")
        state, metrics = step(model, state, b, marks)
        loss = float(metrics["loss"])
        wall = (time.perf_counter() - t) * 1e3
        sync()
        rows.append({"forward": marks.ms("start", "forward"),
                     "backward": marks.ms("forward", "backward"),
                     "update": marks.ms("backward", "update"), "wall": wall, "loss": loss})
    peak = torch.cuda.max_memory_allocated() / 2**30 if cuda else float("nan")
    steady = rows[1:] if len(rows) > 1 else rows
    med = {k: float(np.median([r[k] for r in steady])) for k in ("forward", "backward", "update",
                                                                  "wall")}
    span = med["forward"] + med["backward"] + med["update"]
    loop_ms = float(np.mean(load_ms)) + med["wall"]

    with torch.no_grad(), CountFlops() as counter:
        b = {k: torch.from_numpy(v).to(device) for k, v in batches[0].items()}
        detection_loss(model, b["images"], b["gt_boxes"], b["gt_cls"], b["gt_mask"], spec)
    # backward: the input and the weight gradient of every convolution,
    # except the stem's input gradient (the images need none)
    step_flops = 3 * counter.flops - counter.per_call[0]
    n_param = sum(p.numel() for p in params)
    # images read, each parameter, gradient and trace read and written once
    step_bytes = batches[0]["images"].nbytes + 4 * n_param * 6
    bound, bound_by = bound_ms(step_bytes, step_flops)

    val_loader = Loader(data, "val", imgsz=imgsz, batch_size=batch, training=False)
    t = time.perf_counter()
    val_batches = list(val_loader.epoch(0))
    val_load_ms = (time.perf_counter() - t) * 1e3
    n_val = sum(vb["n_valid"] for vb in val_batches)
    evaluate(model, spec, CachedLoader(val_batches))  # warm
    sync()
    t = time.perf_counter()
    val = evaluate(model, spec, CachedLoader(val_batches))
    sync()
    eval_ms = (time.perf_counter() - t) * 1e3
    # of which the forward and NMS (the rest is the host's mAP)
    t = time.perf_counter()
    with torch.no_grad():
        for vb in val_batches:
            boxes, probs = yolov8.forward(model, torch.from_numpy(vb["images"]).to(device), spec)
            postprocess_detections(boxes, probs, 0.001, 0.7, 300, agnostic=False)
    sync()
    infer_ms = (time.perf_counter() - t) * 1e3
    return {"load_ms": load_ms, "steps": rows, "median": med, "span_ms": span,
            "idle_share": 1.0 - span / loop_ms, "peak_gib": peak, "flops": step_flops,
            "forward_flops": counter.flops, "bound_ms": bound, "bound_by": bound_by,
            "eval_ms_per_image": eval_ms / n_val, "infer_ms_per_image": infer_ms / n_val,
            "val_load_ms_per_image": val_load_ms / n_val,
            "val_images": n_val, "val_map50": val["map50"]}


def phase_train(device: str = "cuda", width: int = 3840, height: int = 2160,
                counts=TRAIN_IMAGES, epochs: int = TRAIN_EPOCHS, imgsz=None, batch=None,
                check_imgsz: int = TRAIN_CHECK_IMGSZ, check_batch: int = TRAIN_CHECK_BATCH,
                timed_steps: int = TRAIN_TIMED_STEPS, seed: int = 0,
                vehicles: int = VEHICLES_PER_4K_FRAME) -> dict:
    """``python -m geotrax_tpu_torch.train`` as users run it (see the
    module's docstring, phase 14). ``imgsz`` and ``batch`` default to the
    preset's; the CPU rehearsal passes smaller ones as ``--imgsz`` and
    ``--batch``, and fewer ``vehicles`` (36 boxes in a tiny image overlap
    so much that an anchor's IoUs with two of them tie within float32
    rounding, and the assignment then differs from float64's)."""
    from geotrax_tpu_torch.models.convert import load_model, save_npz
    from geotrax_tpu_torch.train.train import parse_cli_args, train
    from geotrax_tpu_torch.utils.config_utils import load_config
    from geotrax_tpu_torch.utils.logging_utils import setup_logger

    logger = setup_logger("smoke.train", dry_run=True)
    hp = load_config("default", logger)["ultralytics"]
    extra = [] if imgsz is None else ["--imgsz", str(imgsz), "--batch", str(batch)]
    imgsz, batch = int(imgsz or hp["imgsz"]), int(batch or hp["batch"])
    cuda = torch.device(device).type == "cuda"
    res = {"size": (width, height), "counts": counts, "imgsz": imgsz, "batch": batch,
           "epochs": epochs}
    with tempfile.TemporaryDirectory() as tmpdir:
        tmp = Path(tmpdir)
        data = tmp / "data"
        t = time.perf_counter()
        res["labels"] = write_train_dataset(data, width, height, counts, vehicles)
        res["write_s"] = time.perf_counter() - t
        ckpt = tmp / "start.npz"
        save_npz(ckpt, train_start_model(seed, "cpu"), class_names=dict(enumerate(
            ("car", "bus", "truck", "motorcycle"))))

        # (b) train as users run it, then a 1-epoch run resumed to ``epochs``
        steps_per_epoch = max(1, counts[0] // batch)
        reset_launches()
        runs = {}
        for name, argv in (("full", train_argv(data, ckpt, tmp / "full", epochs, device, *extra)),
                           ("part", train_argv(data, ckpt, tmp / "resumed", 1, device, *extra)),
                           ("resumed", train_argv(data, ckpt, tmp / "resumed", epochs, device,
                                                  "--resume", *extra))):
            t = time.perf_counter()
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            runs[name] = {"out": train(parse_cli_args(argv), logger),
                          "s": time.perf_counter() - t,
                          "peak_gib": torch.cuda.max_memory_allocated() / 2**30 if cuda
                          else float("nan")}
        res["launches"] = launches()
        if res["launches"] != {"fast_score": 0, "patch_gather": 0}:
            raise AssertionError(f"train launched a hand kernel: {res['launches']}")
        model, spec, _ = load_model(tmp / "full" / "last.npz", device="cpu")
        n_params = 2 * sum(1 for m in model.modules() if isinstance(m, yolov8.ConvBN))
        full = check_train_run(tmp / "full", epochs, steps_per_epoch, n_params)
        resumed = check_train_run(tmp / "resumed", epochs, steps_per_epoch, n_params)
        if [h["epoch"] for h in runs["resumed"]["out"]["history"]] != list(range(epochs)):
            raise AssertionError("the resumed run repeated or skipped an epoch")
        if full["lr"] != resumed["lr"]:
            raise AssertionError(f"lr: uninterrupted {full['lr']}, resumed {resumed['lr']}")
        pa, pb = npz_params(tmp / "full" / "last.npz"), npz_params(tmp / "resumed" / "last.npz")
        res["resume"] = {
            "loss_rel": [abs(a - b) / abs(a) for a, b in zip(full["losses"], resumed["losses"])],
            "weight_max_abs": max(float(np.abs(pa[k] - pb[k]).max()) for k in pa),
            "weight_rel_l2": max(float(np.linalg.norm(pa[k] - pb[k])
                                       / max(np.linalg.norm(pa[k]), 1e-30)) for k in pa)}
        res.update(full=full, resumed=resumed, full_s=runs["full"]["s"],
                   part_s=runs["part"]["s"], resumed_s=runs["resumed"]["s"],
                   run_peak_gib=runs["full"]["peak_gib"], n_params=n_params,
                   single_cls=runs["full"]["out"]["single_cls_val"]["map50"])

        # (c) one step on the card against the same step on the CPU
        res["check_imgsz"], res["check_batch"] = check_imgsz, check_batch
        res["card_vs_cpu"] = train_step_card_vs_cpu(data, device, check_imgsz, check_batch, seed)

        # (d) the step's times, bound, idle share and peak memory
        res["timed"] = time_train_steps(data, device, imgsz, batch, timed_steps, seed, hp)
        if launches() != {"fast_score": 0, "patch_gather": 0}:
            raise AssertionError(f"train launched a hand kernel: {launches()}")
    return res


# --------------------------------------------------------------------------
# several ranks and several devices
# --------------------------------------------------------------------------

MULTI_STEPS = 2
MULTI_FRAMES = 16
MULTI_TILES = 2
MULTI_MAX_DET = 300
# (b) against (a): the same steps with the gradients of two ranks averaged,
# float32 sums in another order (the train phase holds the card's own
# gradients within TRAIN_GRAD_TOL of float64): relative L2 of the momentum
# trace over all parameters, of the weights, and relative difference of
# each step's loss
MULTI_REL_TOL = 1e-4
MULTI_LOCK_FRAMES = 8


class Marks:
    """Named points of a step (the step's ``mark``): CUDA events on the
    card, the host clock on the CPU."""

    def __init__(self, cuda: bool):
        self.cuda, self.at = cuda, {}

    def __call__(self, name: str) -> None:
        if self.cuda:
            self.at[name] = torch.cuda.Event(enable_timing=True)
            self.at[name].record()
        else:
            self.at[name] = time.perf_counter()

    def ms(self, a: str, b: str) -> float:
        if self.cuda:
            return self.at[a].elapsed_time(self.at[b])
        return (self.at[b] - self.at[a]) * 1e3


def preset_optimizer(hp: dict, steps_per_epoch: int):
    """The trainer's SGD with the preset's schedule (``hp``: its ultralytics
    section)."""
    from geotrax_tpu_torch.train.optim import SGD, build_lr_schedule

    schedule = build_lr_schedule(float(hp["lr0"]), float(hp["lrf"]),
                                 int(float(hp["warmup_epochs"]) * steps_per_epoch),
                                 int(hp["epochs"]) * steps_per_epoch, bool(hp["cos_lr"]))
    return SGD(schedule, float(hp["momentum"]), float(hp["weight_decay"]))


def multi_steps(mesh, data: Path, imgsz: int, batch: int, steps: int, seed: int, hp: dict,
                batches=None) -> dict:
    """``steps`` train steps of the seeded start model over ``mesh``'s ranks
    (``make_train_step``), each rank on its rows of each global batch: from
    ``batches`` (already loaded) or decoded by this rank's loader (only its
    rows, timed). Per step: CUDA-event ms of the forward with the loss, the
    backward, the all-reduce and the update; the loss; peak memory."""
    from geotrax_tpu_torch.models.convert import param_leaves
    from geotrax_tpu_torch.parallel.mesh import batch_rows, make_train_step, shard_params
    from geotrax_tpu_torch.train.data import Loader

    spec = yolov8.ModelSpec(variant="s", nc=4)
    model = train_start_model(seed, mesh.device)
    model.requires_grad_(True)
    shard_params(model, mesh)
    loader = Loader(data, "train", imgsz=imgsz, batch_size=batch, training=True,
                    rows=batch_rows(batch, mesh))
    optimizer = preset_optimizer(hp, len(loader))
    step = make_train_step(spec, optimizer, mesh)
    state = optimizer.init(param_leaves(model))
    load_ms = []
    if batches is None:
        batches, it = [], loader.epoch(0)
        for _ in range(steps):
            t = time.perf_counter()
            b = next(it)
            load_ms.append((time.perf_counter() - t) * 1e3)
            b.pop("n_valid")
            batches.append(b)
    cuda = mesh.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(mesh.device)
    rows = []
    for i in range(steps):
        b = {k: torch.from_numpy(v).to(mesh.device) for k, v in batches[i].items()}
        marks = Marks(cuda)
        marks("start")
        state, metrics = step(model, state, b, marks)
        loss = float(metrics["loss"])
        if cuda:
            torch.cuda.synchronize(mesh.device)
        reduced = "all_reduce" if mesh.world_size > 1 else "backward"
        rows.append({"forward": marks.ms("start", "forward"),
                     "backward": marks.ms("forward", "backward"),
                     "all_reduce": marks.ms("backward", reduced),
                     "update": marks.ms(reduced, "update"), "loss": loss,
                     "fg": int(metrics["fg"])})
    return {"params": [p.detach() for p in param_leaves(model)], "trace": list(state.trace),
            "steps": rows, "load_ms": load_ms, "batches": batches, "rows": len(batches[0]["images"]),
            "peak_gib": torch.cuda.max_memory_allocated(mesh.device) / 2**30 if cuda
            else float("nan")}


def weights_digest(tensors) -> str:
    import hashlib

    h = hashlib.sha1()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def multi_rank(data: str, imgsz: int, batch: int, steps: int, seed: int, hp: dict, out: str,
               device: str, backend) -> None:
    """One rank of (b) / (e) (``parallel/mesh.py:spawn`` starts it): the
    steps on its rows, the digests of every rank's weights and momentum
    gathered, its numbers to ``out/rank<r>.json``; rank 0 also saves its
    weights and trace."""
    import torch.distributed as dist

    from geotrax_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(device=device, backend=backend)
    res = multi_steps(mesh, Path(data), imgsz, batch, steps, seed, hp)
    digest = weights_digest(res["params"] + res["trace"])
    digests = [None] * mesh.world_size
    dist.all_gather_object(digests, digest)
    if mesh.rank == 0:
        torch.save({"params": [p.cpu() for p in res["params"]],
                    "trace": [t.cpu() for t in res["trace"]]}, Path(out) / "rank0.pt")
    (Path(out) / f"rank{mesh.rank}.json").write_text(json.dumps({
        "rank": mesh.rank, "world": mesh.world_size, "device": str(mesh.device),
        "backend": dist.get_backend(), "digest": digest, "digests": digests,
        "steps": res["steps"], "load_ms": res["load_ms"], "rows": res["rows"],
        "peak_gib": res["peak_gib"]}))


def multi_alone(data: str, imgsz: int, batch: int, steps: int, seed: int, hp: dict, out: str,
                device: str) -> None:
    """(a), in a process of its own (``spawn`` with a world of one, so that
    the determinism settings stay there): PyTorch's deterministic
    algorithms (the loss's backward accumulates with atomics otherwise, and
    two runs differ in the last bits), the steps twice outside any process
    group, then ``make_mesh`` joins the group of one that the environment
    describes (NCCL on the card) and the steps run again; to ``out/a.pt``."""
    import torch.distributed as dist

    from geotrax_tpu_torch.parallel.mesh import Mesh, make_mesh

    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    dev = resolve_device(device)
    alone = multi_steps(Mesh({"data": 1}, 1, 0, 0, dev), Path(data), imgsz, batch, steps, seed,
                        hp)
    again = multi_steps(Mesh({"data": 1}, 1, 0, 0, dev), Path(data), imgsz, batch, steps, seed,
                        hp, batches=alone["batches"])
    mesh = make_mesh(device=device)
    grouped = multi_steps(mesh, Path(data), imgsz, batch, steps, seed, hp,
                          batches=alone["batches"])

    def same(x, y):
        return all(torch.equal(p, q) for p, q in zip(x["params"] + x["trace"],
                                                      y["params"] + y["trace"]))

    torch.save({"params": [p.cpu() for p in alone["params"]],
                "trace": [t.cpu() for t in alone["trace"]],
                "repeat_equal": same(alone, again), "group_equal": same(alone, grouped),
                "backend": dist.get_backend(), "world": mesh.world_size,
                **{k: alone[k] for k in ("steps", "load_ms", "peak_gib", "rows")}},
               Path(out) / "a.pt")


def rel_l2(a: list, b: list) -> tuple:
    """(worst parameter, all at once) relative L2 of ``a`` against ``b``."""
    a = [x.detach().double().cpu() for x in a]
    b = [x.detach().double().cpu() for x in b]
    per = [float(torch.linalg.norm(x - y) / max(float(torch.linalg.norm(y)), 1e-30))
           for x, y in zip(a, b)]
    flat = [torch.cat([x.flatten() for x in v]) for v in (a, b)]
    return max(per), float(torch.linalg.norm(flat[0] - flat[1]) / torch.linalg.norm(flat[1]))


def ranks_against(base: dict, world: int, tmp: Path, data: Path, imgsz: int, batch: int,
                  steps: int, seed: int, hp: dict, device: str, backend) -> dict:
    """``world`` ranks spawned on ``device`` (``backend``), held to
    ``base`` (one rank's run of the same steps): the ranks bit-equal to each
    other, rank 0 within MULTI_REL_TOL of ``base``."""
    from geotrax_tpu_torch.parallel.mesh import spawn

    out = tmp / f"ranks{world}_{backend or 'default'}"
    out.mkdir()
    t = time.perf_counter()
    spawn(multi_rank, world, str(data), imgsz, batch, steps, seed, hp, str(out), device, backend)
    ranks = [json.loads((out / f"rank{r}.json").read_text()) for r in range(world)]
    got = torch.load(out / "rank0.pt")
    res = {"s": time.perf_counter() - t, "ranks": ranks, "world": world,
           "backend": ranks[0]["backend"], "rows": ranks[0]["rows"]}
    if len({d for r in ranks for d in r["digests"] + [r["digest"]]}) != 1:
        raise AssertionError(f"{world} ranks hold different weights: "
                             f"{[r['digests'] for r in ranks]}")
    res["trace_max"], res["trace_all"] = rel_l2(got["trace"], base["trace"])
    res["param_max"], res["param_all"] = rel_l2(got["params"], base["params"])
    res["loss_rel"] = [abs(r["loss"] - b["loss"]) / abs(b["loss"])
                       for r, b in zip(ranks[0]["steps"], base["steps"])]
    res["fg"] = ([r["fg"] for r in ranks[0]["steps"]], [b["fg"] for b in base["steps"]])
    if (res["trace_all"] > MULTI_REL_TOL or res["param_all"] > MULTI_REL_TOL
            or max(res["loss_rel"]) > MULTI_REL_TOL or res["fg"][0] != res["fg"][1]):
        raise AssertionError(f"{world} ranks against one: {res}")
    return res


def letterboxed(detector: Detector, frames_u8: torch.Tensor) -> torch.Tensor:
    """(B,H,W,3) uint8 frames -> the detector's (B,h,w,3) float input."""
    h, w = frames_u8.shape[1:3]
    new_h, new_w, _, top, left, out_h, out_w = detector.resize_geometry(h, w)
    return yolov8.letterbox_pad(resize_u8_linear(frames_u8, new_h, new_w), out_h, out_w, top,
                                left)


def timed(fn, device: torch.device) -> tuple:
    """(result, seconds) of ``fn()`` after a first call, synchronised."""
    fn()
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
    sync()
    t = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t


def multi_detection(detector: Detector, frames_u8: torch.Tensor, devices: list) -> dict:
    """``make_inference_step`` over ``[devices[0]]`` and over ``devices``,
    ``make_tiled_detector`` on frame 0 with and without them: each pair
    bit-equal (the largest difference of the valid boxes and scores 0, the
    valid slots and classes equal); detections and seconds of each."""
    from geotrax_tpu_torch.parallel.mesh import make_inference_step
    from geotrax_tpu_torch.parallel.tiling import make_tiled_detector

    model, spec, home = detector.model, detector.spec, detector.device
    imgs = letterboxed(detector, frames_u8.to(home))
    kw = dict(conf=detector.conf, iou=0.7, max_det=MULTI_MAX_DET)
    one, one_s = timed(lambda: make_inference_step(spec, [home], **kw)(model, imgs), home)
    many, many_s = timed(lambda: make_inference_step(spec, devices, **kw)(model, imgs), home)
    h, w = frames_u8.shape[1:3]
    tkw = dict(n_tiles=MULTI_TILES, src_h=h, src_w=w, imgsz=detector.imgsz, conf=detector.conf)
    frame = frames_u8[0].to(home)
    tiled, tiled_s = timed(lambda: make_tiled_detector(model, spec, **tkw)(frame), home)
    spread, spread_s = timed(
        lambda: make_tiled_detector(model, spec, devices=devices, **tkw)(frame), home)
    res = {"frames": int(imgs.shape[0]), "input": tuple(imgs.shape), "devices": len(devices),
           "per_frame": [int(v) for v in one["valid"].sum(dim=1)], "tiled": int(tiled["valid"].sum()),
           "one_s": one_s, "many_s": many_s, "tiled_s": tiled_s, "spread_s": spread_s,
           "step_diff": same_detections(one, many), "tiled_diff": same_detections(tiled, spread)}
    if res["step_diff"] or res["tiled_diff"] or not sum(res["per_frame"]):
        raise AssertionError(f"detection over {devices}: {res}")
    return res


def multi_lockstep(detector: Detector, width: int, height: int, cards: int, imgsz: int,
                   seed: int, frames: int = MULTI_LOCK_FRAMES) -> dict:
    """``batch --parallel-videos 4`` through the lockstep (frames in memory)
    with ``--devices 1`` and ``--devices cards``: each video's tracks and
    transforms equal."""
    vehicles = vehicles_per_frame(width, height)
    readers = [SyntheticVideoReader(width=width, height=height, n_frames=frames, seed=seed + 1 + v,
                                    camera=LOCK_CAMERAS[v % len(LOCK_CAMERAS)],
                                    boxes=vehicle_boxes(width, height, vehicles, seed + 1 + v))
               for v in range(4)]
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        folder = tmp / "campaign"
        folder.mkdir()
        sources = [folder / f"V{v}.mp4" for v in range(4)]
        for s in sources:
            s.write_bytes(b"placeholder")  # never decoded: the frames are in memory
        model = tmp / "model.pt"  # the detector comes from memory (load_detector)
        torch.save({"class_names": {0: "car", 1: "bus", 2: "truck", 3: "motorcycle"}}, model)
        videos = {s.name: (r.info, make_frames(r)) for s, r in zip(sources, readers)}
        cfg = config_file(tmp / "multi.yaml", imgsz)
        runs = {}
        with InMemory(videos, detector):
            for n in (1, cards):
                t = time.perf_counter()
                stats = run_lockstep(sources, cfg, model, detector.device.type, devices=n)
                runs[n] = [read_run(st["tracks_file"], st["transforms_file"])
                           for st in stats["videos"]]
                res[f"devices{n}_s"] = time.perf_counter() - t
    res["rows"] = [0 if t is None else len(t) for t, _ in runs[1]]
    def equal(a, b):  # a video without tracks has no tracks file
        return (a is None and b is None) or (a is not None and b is not None
                                             and np.array_equal(a, b, equal_nan=True))

    for (ta, ha), (tb, hb) in zip(runs[1], runs[cards]):
        if not (equal(ta, tb) and equal(ha, hb)):
            raise AssertionError(f"lockstep over {cards} devices differs from one")
    if not sum(res["rows"]):
        raise AssertionError(f"lockstep rows {res['rows']}")
    return res


def phase_multi(device: str = "cuda", width: int = 3840, height: int = 2160,
                counts=TRAIN_IMAGES, imgsz=None, batch=None, steps: int = MULTI_STEPS,
                n_frames: int = MULTI_FRAMES, seed: int = 0,
                vehicles: int = VEHICLES_PER_4K_FRAME, cards=None, lock_frames=MULTI_LOCK_FRAMES,
                variant: str = "s") -> dict:
    """Several ranks and several devices (see the module's docstring, phase
    16). ``imgsz`` and ``batch`` default to the preset's; ``cards`` (the
    machine's count on the card) lets the CPU rehearsal run (e) on stand-in
    devices."""
    from geotrax_tpu_torch.models.convert import load_model, save_npz
    from geotrax_tpu_torch.parallel.mesh import spawn
    from geotrax_tpu_torch.utils.config_utils import load_config
    from geotrax_tpu_torch.utils.logging_utils import setup_logger

    hp = load_config("default", setup_logger("smoke.multi", dry_run=True))["ultralytics"]
    extra = [] if imgsz is None else ["--imgsz", str(imgsz), "--batch", str(batch)]
    imgsz, batch = int(imgsz or hp["imgsz"]), int(batch or hp["batch"])
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    cards = torch.cuda.device_count() if cuda else int(cards or 1)
    res = {"size": (width, height), "imgsz": imgsz, "batch": batch, "steps": steps,
           "counts": counts, "cards": cards}
    with tempfile.TemporaryDirectory() as tmpdir:
        tmp = Path(tmpdir)
        data = tmp / "data"
        t = time.perf_counter()
        res["labels"] = write_train_dataset(data, width, height, counts, vehicles)
        res["write_s"] = time.perf_counter() - t

        # (a) one rank through NCCL (gloo on the CPU) against no process group
        t = time.perf_counter()
        cublas = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"  # deterministic cuBLAS, (a) only
        try:
            spawn(multi_alone, 1, str(data), imgsz, batch, steps, seed, hp, str(tmp), device)
        finally:
            if cublas is None:
                del os.environ["CUBLAS_WORKSPACE_CONFIG"]
            else:
                os.environ["CUBLAS_WORKSPACE_CONFIG"] = cublas
        base = torch.load(tmp / "a.pt")
        res["a"] = {k: base[k] for k in ("repeat_equal", "group_equal", "steps", "load_ms",
                                         "peak_gib", "rows", "backend", "world")}
        res["a"]["s"] = time.perf_counter() - t
        if not (res["a"]["group_equal"] and res["a"]["repeat_equal"]) or base["world"] != 1:
            raise AssertionError(f"(a) one rank in a {base['backend']} group against no group: "
                                 f"equal {res['a']['group_equal']} (no group twice: "
                                 f"{res['a']['repeat_equal']})")

        # (b) two ranks sharing the card through gloo
        res["b"] = ranks_against(base, 2, tmp, data, imgsz, batch, steps, seed, hp,
                                 "cuda:0" if cuda else "cpu", "gloo")

        # (c) the CLI: more ranks than cards exits naming both; one rank writes the run
        t = time.perf_counter()
        ckpt = tmp / "start.npz"
        save_npz(ckpt, train_start_model(seed, "cpu"), class_names=dict(enumerate(
            ("car", "bus", "truck", "motorcycle"))))
        n = cards + 1 if cuda else batch + 1
        want = ([f"--devices {n} needs {n} cards", f"this machine has {cards}"] if cuda
                else [f"--batch {batch}", f"{n} ranks"])
        cli = [sys.executable, "-m", "geotrax_tpu_torch.train"]
        proc = subprocess.run(cli + train_argv(data, ckpt, tmp / "too_many", 1, device, "--devices",
                                               str(n), *extra),
                              capture_output=True, text=True, timeout=300, cwd=Path(__file__).parent)
        if proc.returncode == 0 or not all(w in proc.stderr for w in want) \
                or (tmp / "too_many").exists():
            raise AssertionError(f"(c) --devices {n}: rc {proc.returncode}, "
                                 f"{proc.stderr[-1500:]}")
        res["c_refused"] = proc.stderr.strip().splitlines()[-1]
        proc = subprocess.run(cli + train_argv(data, ckpt, tmp / "one", 1, device, "--devices", "1",
                                               *extra),
                              capture_output=True, text=True, timeout=600, cwd=Path(__file__).parent)
        if proc.returncode != 0:
            raise AssertionError(f"(c) --devices 1: {proc.stderr[-3000:]}")
        model, _, _ = load_model(tmp / "one" / "last.npz", device="cpu")
        n_params = 2 * sum(1 for m in model.modules() if isinstance(m, yolov8.ConvBN))
        res["c_run"] = check_train_run(tmp / "one", 1, max(1, counts[0] // batch), n_params)
        res["c_s"] = time.perf_counter() - t

    # (d) detection over [dev] and [dev, dev]
    t = time.perf_counter()
    spec = yolov8.ModelSpec(variant=variant, nc=4)
    detector = Detector(yolov8.init_params(torch.Generator().manual_seed(seed), spec, device=dev),
                        {**smoke_config(imgsz)["ultralytics"], "max_det": MULTI_MAX_DET},
                        device=dev)
    reader = smoke_reader(width, height, seed, n_frames,
                          boxes=vehicle_boxes(width, height, vehicles_per_frame(width, height),
                                              seed))
    frames = torch.from_numpy(np.stack([f for _, f in make_frames(reader)]))
    res["d_calibrated"] = calibrate_class_bias(detector, frames[0].numpy(),
                                               vehicles_per_frame(width, height))
    reset_launches()
    res["d"] = multi_detection(detector, frames, [dev, dev])
    res["d"]["launches"] = launches()
    res["d_s"] = time.perf_counter() - t

    # (e) several cards
    res["e"] = None
    if cards >= 2:
        t = time.perf_counter()
        world = min(4, cards)
        e_dev = [torch.device(f"cuda:{i}") for i in range(cards)] if cuda else [dev] * cards
        with tempfile.TemporaryDirectory() as tmpdir:
            tmp = Path(tmpdir)
            data = tmp / "data"
            write_train_dataset(data, width, height, counts, vehicles)
            res["e"] = {"ranks": ranks_against(base, world, tmp, data, imgsz, batch, steps, seed,
                                               hp, "cuda" if cuda else "cpu", None)}
        res["e"]["d"] = multi_detection(detector, frames, e_dev)
        res["e"]["lockstep"] = multi_lockstep(detector, width, height, cards, imgsz, seed,
                                              lock_frames)
        res["e"]["s"] = time.perf_counter() - t
    return res


# --------------------------------------------------------------------------
# the feature library, the exact assignment and GeoTIFF orthophotos
# --------------------------------------------------------------------------

FEATURE_K = 2000
FEATURE_ZOOM = 1.6
FEATURE_LEVELS = 4
# the recovered zoom at four interior corners (tests/test_features_stabilize.py)
FEATURE_H_TOL_PX = 4.0
# card vs CPU: the orientation's two 961-term float32 sums add in another
# order on the card; an oriented test point that rounds at .5 may move with
# the angle's last bits; the pyramid's deeper levels are resize products
# that add in another order
ANGLE_TOL = 1e-4
ORIENTED_BIT_SHARE = 1e-3
PYRAMID_OVERLAP = 0.98
LAPJV_SHAPE = (1000, 2000)
TIFF_FIXTURES = Path(__file__).resolve().parent / "tests" / "data" / "tiff"


def zoom_about(cx: float, cy: float, zoom: float) -> np.ndarray:
    """The homography that zooms by ``zoom`` about (cx, cy)."""
    return np.array([[zoom, 0.0, (1 - zoom) * cx], [0.0, zoom, (1 - zoom) * cy], [0, 0, 1.0]])


def interior_error(h_est: np.ndarray, h_true: np.ndarray, w: int, h: int) -> float:
    """Largest distance [px] between where the two homographies map four
    interior corners (0.35 and 0.65 of each side), which stay in view
    under the zoom."""
    c = np.array([[0.35 * w, 0.35 * h, 1], [0.65 * w, 0.35 * h, 1], [0.65 * w, 0.65 * h, 1],
                  [0.35 * w, 0.65 * h, 1]])
    p, q = c @ h_est.T, c @ h_true.T
    return float(np.linalg.norm(p[:, :2] / p[:, 2:] - q[:, :2] / q[:, 2:], axis=1).max())


def feature_steps(ga: torch.Tensor, gb: torch.Tensor, device: str, k: int, levels: int) -> dict:
    """The library's steps on a pair of grays, each timed (CUDA events on
    the card): oriented FAST, ``describe`` on its three routes, the pyramid
    of both images, ``match_descriptors`` and RANSAC."""
    from geotrax_tpu_torch.ops import prng
    from geotrax_tpu_torch.ops.ransac import ransac_fit

    ms, out = {}, {}
    ms["fast_oriented"], out["kps"] = events_ms(lambda: features.fast_detect(ga, k), device)
    for name, oriented, method in (("describe_patches", False, "patches"),
                                   ("describe_planes", False, "planes"),
                                   ("describe_oriented", True, "patches")):
        ms[name], out[name] = events_ms(lambda: features.describe(
            ga, out["kps"], oriented=oriented, method=method), device)
    ms["pyramid_a"], out["pyr_a"] = events_ms(
        lambda: features.detect_and_describe_pyramid(ga, k, n_levels=levels), device)
    ms["pyramid_b"], out["pyr_b"] = events_ms(
        lambda: features.detect_and_describe_pyramid(gb, k, n_levels=levels), device)
    (ka, da), (kb, db) = out["pyr_a"], out["pyr_b"]
    ms["match"], m = events_ms(lambda: features.match_descriptors(da, ka.valid, db, kb.valid),
                               device)
    ms["ransac"], r = events_ms(lambda: ransac_fit(
        ka.xy[m.idx_a], kb.xy[m.idx_b], m.valid, threshold=3.0, key=prng.PRNGKey(0),
        num_hypotheses=2048), device)
    out["matches"], out["ransac"] = m, r
    return {"ms": ms, **out}


def wrapped(a: torch.Tensor) -> torch.Tensor:
    return torch.remainder(a + math.pi, 2 * math.pi) - math.pi


def feature_library(device: str, width: int, height: int, seed: int, k: int = FEATURE_K,
                    levels: int = FEATURE_LEVELS, reps: int = 3) -> dict:
    """(a): the 0.5x gray of a drifting frame and a copy zoomed by
    FEATURE_ZOOM about its centre, through the library on ``device`` (the
    launches counted over the first run, each step's time the median of
    ``reps`` runs), held against the CPU's plain versions and the true
    homography; then both kernels exact on the phase's own inputs."""
    from geotrax_tpu_torch.ops.warp import invert_homography, warp_perspective

    dev = torch.device(device)
    _, frame = next(iter(smoke_reader(width, height, seed, horizon=1)))
    ga = features.downsample(features.rgb_to_gray(torch.as_tensor(frame).to(dev)), 0.5)
    h, w = ga.shape
    h_true = zoom_about(w / 2, h / 2, FEATURE_ZOOM)
    gb = warp_perspective(ga[..., None], invert_homography(h_true), h, w)[..., 0].contiguous()

    reset_launches()
    runs = [feature_steps(ga, gb, device, k, levels)]
    counted = launches()
    runs += [feature_steps(ga, gb, device, k, levels) for _ in range(reps - 1)]
    card = runs[0]
    res = {"shape": (h, w), "k": k, "levels": levels, "launches": counted,
           "ms": {n: float(np.median([r["ms"][n] for r in runs])) for n in card["ms"]}}
    want = {"fast_score": (1 + 2 * levels) * (device == "cuda"),
            "patch_gather": 1 * (device == "cuda")}
    if counted != want:
        raise AssertionError(f"feature library launches {counted}, expected {want}")

    r = card["ransac"]
    res["matches"] = int(card["matches"].valid.sum())
    res["inliers"] = int(r.num_inliers)
    res["h_err_px"] = interior_error(r.h_matrix.double().cpu().numpy(), h_true, w, h)
    if res["h_err_px"] > FEATURE_H_TOL_PX:
        raise AssertionError(f"the {FEATURE_ZOOM}x zoom recovered within {res['h_err_px']:.2f} "
                             f"px (limit {FEATURE_H_TOL_PX})")

    # the CPU's plain versions on the same inputs
    ga_c, gb_c = ga.cpu(), gb.cpu()
    kps = card["kps"]
    kps_c = features.fast_detect(ga_c, k)
    for name in ("xy", "score", "valid"):
        if not torch.equal(getattr(kps, name).cpu(), getattr(kps_c, name)):
            raise AssertionError(f"oriented FAST: card and CPU {name} differ")
    res["angle_err"] = float(wrapped(kps.angle.cpu() - kps_c.angle).abs().max())
    if res["angle_err"] > ANGLE_TOL:
        raise AssertionError(f"angles differ by {res['angle_err']:.2e} rad (limit {ANGLE_TOL})")
    kps_on_cpu = features.Keypoints(*(t.cpu() for t in kps))
    res["bits"] = {}
    for name, oriented, method in (("describe_patches", False, "patches"),
                                   ("describe_planes", False, "planes"),
                                   ("describe_oriented", True, "patches")):
        plain = features.describe(ga_c, kps_on_cpu, oriented=oriented, method=method)
        res["bits"][name] = float((card[name].cpu() != plain).float().mean())
        limit = ORIENTED_BIT_SHARE if oriented else 0.0
        if res["bits"][name] > limit:
            raise AssertionError(f"{name}: {res['bits'][name]:.2e} of the bits differ from the "
                                 f"CPU's (limit {limit})")
    res["overlap"] = []
    for key, g in (("pyr_a", ga_c), ("pyr_b", gb_c)):
        kc, _ = features.detect_and_describe_pyramid(g, k, n_levels=levels)
        on_cpu = {tuple(v) for v in torch.round(kc.xy * 1000).to(torch.int64).tolist()}
        mine = torch.round(card[key][0].xy.cpu() * 1000).to(torch.int64).tolist()
        res["overlap"].append(float(np.mean([tuple(v) in on_cpu for v in mine])))
    if min(res["overlap"]) < PYRAMID_OVERLAP:
        raise AssertionError(f"pyramid keypoints shared with the CPU's: {res['overlap']} "
                             f"(limit {PYRAMID_OVERLAP})")
    (ka, da), (kb, db) = card["pyr_a"], card["pyr_b"]
    mc = features.match_descriptors(da.cpu(), ka.valid.cpu(), db.cpu(), kb.valid.cpu())
    m = card["matches"]
    if not (torch.equal(m.idx_b.cpu(), mc.idx_b) and torch.equal(m.valid.cpu(), mc.valid)):
        raise AssertionError("match_descriptors: card and CPU differ")

    # both kernels exact on this phase's own inputs (these launches are not counted)
    res["kernel_err"] = {}
    res["kernel_err"]["fast_score"] = float(
        (fast.fast_score_map(ga, 20.0).cpu() - fast.fast_score_map_torch(ga_c, 20.0)).abs().max())
    smooth = features._gaussian_blur(ga)
    x0 = torch.clamp(kps.xy[:, 0].to(torch.int32) - 15, 0, w - 32)
    y0 = torch.clamp(kps.xy[:, 1].to(torch.int32) - 15, 0, h - 32)
    res["kernel_err"]["patch_gather"] = float((patches.patches32(smooth, x0, y0).cpu()
                                               - patches.patches32_torch(smooth.cpu(), x0.cpu(),
                                                                         y0.cpu())).abs().max())
    if any(res["kernel_err"].values()):
        raise AssertionError(f"kernels against their plain versions: {res['kernel_err']}")
    return res


def lapjv_check(shape=LAPJV_SHAPE, seed: int = 0) -> dict:
    """(b): ``lapjv_exact`` on a seeded float64 cost against scipy's
    ``linear_sum_assignment``, both timed on the host."""
    from scipy.optimize import linear_sum_assignment

    from geotrax_tpu_torch.ops.assignment import lapjv_exact

    cost = np.random.default_rng(seed).uniform(0.0, 1.0, shape)
    t0 = time.perf_counter()
    cols = lapjv_exact(cost)
    lap_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows, want = linear_sum_assignment(cost)
    scipy_s = time.perf_counter() - t0
    if not (np.array_equal(rows, np.arange(shape[0])) and np.array_equal(cols, want)):
        raise AssertionError(f"lapjv_exact differs from scipy on {int((cols != want).sum())} rows")
    return {"shape": shape, "s": lap_s, "scipy_s": scipy_s, "cost": float(cost[rows, cols].sum())}


def tiff_fixtures() -> dict:
    """The committed compressed fixtures (LZW, deflate with predictor 2,
    PackBits, palette, JPEG) decoded by the port against Pillow's pixel
    digests."""
    import hashlib

    from geotrax_tpu_torch.io import tiff

    want = json.loads((TIFF_FIXTURES / "pixels.json").read_text())
    got = {name: hashlib.sha1(tiff.read_tiff(TIFF_FIXTURES / name).tobytes()).hexdigest()
           for name in want}
    bad = [name for name in want if got[name] != want[name]]
    if bad:
        raise AssertionError(f"TIFF fixtures decoded unlike Pillow: {bad}")
    return {"files": sorted(want)}


def georef_argv(root: Path, ortho_dir: Path, source: Path, device: str,
                max_features: int) -> list:
    """``georeference``'s arguments: the default preset, or a copy of it with
    a rehearsal's smaller feature budget."""
    cfg = "default"
    if max_features != port_cfg.DEFAULT["georef"]["matching"]["max_features"]:
        cfg = str(root / "default_copy.yaml")
        text = (port_cfg.CFG_DIR / "default.yaml").read_text()
        Path(cfg).write_text(text.replace("    max_features: 250000\n",
                                          f"    max_features: {max_features}\n"))
    return [str(source), "-c", cfg, "--device", device, "--ortho-folder", str(ortho_dir)]


def geotiff_leg(root: Path, a: dict, device: str, fw: int, fh: int, max_features: int) -> dict:
    """(c): the georef assets' ortho as a tiled GeoTIFF (tiepoint and scale
    from the center-text-file parameters), ``georeference`` on a text-file
    folder and on a folder holding only ``<loc>.tif`` from the text-file
    run's master -> ortho cache: the PNG converted from the .tif equal to the
    ortho, the parameters equal, the two CSVs byte-equal."""
    from geotrax_tpu_torch.io import geoassets, png
    from geotrax_tpu_torch.io.tiff_tiled import write_tiled_tiff
    from geotrax_tpu_torch.pipeline import georeference as port_geo

    logger = logging.getLogger("smoke.geotiff")
    src_dir = a["ortho_dir"]
    params = geoassets.get_ortho_parameters(src_dir, GEO_LOCATION, "center-text-file", None,
                                            logger)
    res = {"params": params}

    def folder(name: str, cache) -> Path:
        d = root / name
        (d / "master_frames").mkdir(parents=True)
        shutil.copytree(src_dir / "segmentations", d / "segmentations")
        shutil.copy(src_dir / "master_frames" / f"{GEO_LOCATION}.png", d / "master_frames")
        if cache is not None and cache.exists():
            shutil.copy(cache, d / "master_frames")
        return d

    txt_dir = folder("ORTHO_TEXT", src_dir / "master_frames" / f"{GEO_LOCATION}.txt")
    os.link(src_dir / f"{GEO_LOCATION}.png", txt_dir / f"{GEO_LOCATION}.png")
    (txt_dir / f"{GEO_LOCATION}.txt").write_text(
        "# lng0 lat0 dlng dlat skew_x skew_y\n" + " ".join(repr(v) for v in params) + "\n")
    tif_dir = folder("ORTHO_TIF", None)
    lng0, lat0, dlng, dlat = params[:4]
    tif = tif_dir / f"{GEO_LOCATION}.tif"

    def run(ortho_dir: Path) -> dict:
        return port_geo.run_georeferencing(port_geo.parse_cli_args(
            georef_argv(root, ortho_dir, a["source"], device, max_features)), logger)

    cache = txt_dir / "master_frames" / f"{GEO_LOCATION}.txt"
    replaced = port_geo.get_video_data
    port_geo.get_video_data = lambda src, ref_frame, log: (a["ref"], (fh, fw), float(GEO_FPS))
    try:
        res["cache_s"] = None
        if not cache.exists():  # without the georef phase's cache: the master path writes it
            t0 = time.perf_counter()
            run(txt_dir)
            res["cache_s"] = time.perf_counter() - t0
        # both runs from the cache (a fresh fit and its cached copy give
        # homographies equal to float32 precision only)
        t0 = time.perf_counter()
        text_run = run(txt_dir)
        res["text_s"] = time.perf_counter() - t0
        text_csv = Path(text_run["csv"]).read_bytes()
        shutil.copy(cache, tif_dir / "master_frames")
        t0 = time.perf_counter()
        write_tiled_tiff(tif, a["ortho"], tile=256, geo=(lng0, lat0, dlng, -dlat))
        res["write_s"] = time.perf_counter() - t0
        res["tif_bytes"] = tif.stat().st_size

        timed = geoassets.get_geo_params_source
        spent = []

        def timed_source(*args):
            t = time.perf_counter()
            out = timed(*args)
            spent.append(time.perf_counter() - t)
            return out

        geoassets.get_geo_params_source = timed_source
        try:
            t0 = time.perf_counter()
            tif_run = run(tif_dir)
            res["tif_s"] = time.perf_counter() - t0
        finally:
            geoassets.get_geo_params_source = timed
    finally:
        port_geo.get_video_data = replaced
    res["convert_s"] = spent[0]
    if geoassets.get_geo_params_source(None, tif_dir, GEO_LOCATION, logger) != "metadata-tif":
        raise AssertionError("the .tif folder is not detected as metadata-tif")
    tif_params = geoassets.get_ortho_parameters(tif_dir, GEO_LOCATION, "metadata-tif", None,
                                                logger)
    text_params = geoassets.get_ortho_parameters(txt_dir, GEO_LOCATION, "text-file", None, logger)
    if tif_params != text_params:
        raise AssertionError(f"GeoTIFF parameters {tif_params} != text-file {text_params}")
    if not np.array_equal(png.read_png(tif_dir / f"{GEO_LOCATION}.png"), a["ortho"]):
        raise AssertionError("the PNG converted from the .tif differs from the ortho")
    if Path(tif_run["csv"]).read_bytes() != text_csv:
        raise AssertionError("the GeoTIFF run's CSV differs from the text-file run's")
    res["rows"] = tif_run["rows"]
    res["csv_bytes"] = len(text_csv)
    res["seconds"] = tif_run["seconds"]
    return res


def phase_features(device: str = "cuda", geo: dict | None = None, width: int = 3840,
                   height: int = 2160, seed: int = 0, k: int = FEATURE_K,
                   lap_shape=LAPJV_SHAPE, size: int = GEO_ORTHO_PX, fw: int = 3840,
                   fh: int = 2160, n_frames: int = GEO_FRAMES,
                   vehicles: int = VEHICLES_PER_4K_FRAME, rects: int = GEO_RECTS,
                   max_features: int = 250_000) -> dict:
    """The feature library (a), ``lapjv_exact`` (b) and the GeoTIFF leg
    with the TIFF fixtures (c). ``geo`` holds the georef phase's assets and
    folder (``phase_georef(keep=True)``); without it the phase writes them."""
    res = {}
    t0 = time.perf_counter()
    res["a"] = feature_library(device, width, height, seed, k)
    res["a_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["b"] = lapjv_check(lap_shape, seed)
    res["b_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["fixtures"] = tiff_fixtures()
    if geo is None:
        root = Path(tempfile.mkdtemp())
        geo = {"root": root, "assets": geo_assets(root, device, size, fw, fh, n_frames,
                                                  vehicles, rects)}
    try:
        res["c"] = geotiff_leg(geo["root"], geo["assets"], device, fw, fh, max_features)
    finally:
        shutil.rmtree(geo["root"], ignore_errors=True)
    res["c_s"] = time.perf_counter() - t0
    return res


# ---------------------------------------------------------------------------
# Phase 17: the tools layer (python -m geotrax_tpu_torch.tools.*)
# ---------------------------------------------------------------------------

TOOLS_IMAGES = 2        # 4K PNGs annotate_frames labels in each run
TOOLS_TRIALS = 1        # --synthetic-ortho trials (the tool's default is 2)
TOOLS_DETECTORS = ("rsift", "orb")
# the detector's float32 card-against-CPU tolerance (tests/test_torch_gpu.py)
TOOLS_BOX_TOL_PX, TOOLS_SCORE_TOL = 1e-3, 1e-5
TOOLS_ERR_PX, TOOLS_INLIERS = 3.0, 50  # the rsift registration, as in the georef phase


def label_rows(folder: Path) -> dict:
    """{image stem: (N, 6) class, cx, cy, w, h, score} of a label folder."""
    return {p.stem: np.array([[float(v) for v in line.split()]
                              for line in p.read_text().splitlines()]).reshape(-1, 6)
            for p in sorted(folder.glob("*.txt"))}


def compare_labels(card: dict, cpu: dict, width: int, height: int, conf: float) -> dict:
    """The card's label lines against the CPU's: every line has a partner on
    the other side with its class, a box within TOOLS_BOX_TOL_PX and a score
    within TOOLS_SCORE_TOL (each plus the printed digits' rounding), except a
    line whose score is that close to ``conf`` (it may fall either side)."""
    if card.keys() != cpu.keys():
        raise AssertionError(f"label files differ: {sorted(card)} vs {sorted(cpu)}")
    scale = np.array([width, height, width, height], np.float64)
    box_tol = TOOLS_BOX_TOL_PX + 1e-6 * width   # 6 printed decimals
    score_tol = TOOLS_SCORE_TOL + 1e-4          # 4 printed decimals
    res = {"lines": sum(len(v) for v in card.values()),
           "cpu_lines": sum(len(v) for v in cpu.values()),
           "box_px": 0.0, "score": 0.0, "at_threshold": 0}
    for name in cpu:
        for a, b in ((card[name], cpu[name]), (cpu[name], card[name])):
            for row in a:
                d = (np.abs(b[:, 1:5] - row[1:5]) * scale).max(1) if len(b) else np.array([np.inf])
                j = int(np.argmin(d))
                if d[j] > box_tol or b[j, 0] != row[0]:
                    if row[5] - conf <= score_tol:
                        res["at_threshold"] += 1
                        continue
                    raise AssertionError(f"{name}: line {row.tolist()} has no partner on the "
                                         f"other device (nearest {d[j]:.4g} px)")
                res["box_px"] = max(res["box_px"], float(d[j]))
                res["score"] = max(res["score"], abs(float(b[j, 5] - row[5])))
    if res["score"] > score_tol:
        raise AssertionError(f"label scores differ by {res['score']}")
    return res


def fast_recorder(seen: dict):
    """A ``fast_score_map`` for ops/features.py that keeps the first gray of
    each shape it is given and runs the kernel wrapper (whose count rises)."""
    def record(gray, threshold=20.0):
        key = (tuple(gray.shape), float(threshold))
        if key not in seen:  # cloned once per shape, not on every call
            seen[key] = gray.clone()
        return fast.fast_score_map(gray, threshold)
    return record


def phase_tools(device: str = "cuda", width: int = 3840, height: int = 2160,
                n_images: int = TOOLS_IMAGES, variant: str = "s", imgsz=None,
                ortho_px: int = GEO_ORTHO_PX, max_features: int = 250000,
                frame_size=(3840, 2160), trials: int = TOOLS_TRIALS, seed: int = 0,
                vehicles: int = VEHICLES_PER_4K_FRAME) -> dict:
    """The tools that reach the card, as users run them (see the module's
    docstring, phase 17); the CPU rehearsal passes small sizes."""
    from geotrax_tpu_torch.io import native
    from geotrax_tpu_torch.io.png import write_png
    from geotrax_tpu_torch.models.convert import save_npz
    from geotrax_tpu_torch.tools import annotate_frames, benchmark_ortho_matching
    from geotrax_tpu_torch.train.data import load_image
    from geotrax_tpu_torch.utils.logging_utils import setup_logger

    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    config = smoke_config(imgsz or port_cfg.load_config()["ultralytics"]["imgsz"])
    detect_cfg = config["ultralytics"]
    res = {"size": (width, height), "images": n_images, "imgsz": detect_cfg["imgsz"],
           "variant": variant}
    logger = setup_logger("smoke.tools", dry_run=True)
    logger.setLevel(logging.WARNING)
    with tempfile.TemporaryDirectory() as tmpdir:
        tmp = Path(tmpdir)
        # (a) annotate_frames on seeded 4K PNGs with a calibrated detector
        t = time.perf_counter()
        reader = smoke_reader(width, height, seed, n_images,
                              boxes=vehicle_boxes(width, height, vehicles, seed))
        images = tmp / "data" / "images"
        images.mkdir(parents=True)
        for i, frame in make_frames(reader):
            write_png(images / f"f{i}.png", frame)
        spec = yolov8.ModelSpec(variant=variant, nc=4)
        model = yolov8.init_params(torch.Generator().manual_seed(seed), spec, device=device)
        detector = Detector(model, detect_cfg, device=device)
        res["calibrated"] = calibrate_class_bias(detector, load_image(images / "f0.png"),
                                                 vehicles_per_frame(width, height))
        ckpt = tmp / "yolov8s_nc4.npz"
        save_npz(ckpt, detector.model, class_names={0: "car", 1: "bus", 2: "truck",
                                                    3: "motorcycle"})
        res["a_write_s"] = time.perf_counter() - t
        runs = {}
        for augment in (False, True):
            for side, where in (("card", device), ("cpu", "cpu")):
                out = tmp / f"labels_{side}_{augment}"
                argv = [str(images), "-m", str(ckpt), "-a", str(out), "--imgsz",
                        str(detect_cfg["imgsz"]), "--save-conf", "--save-masked", "-q",
                        "-lp", str(tmp / "logs"), "--device", where] + (
                            ["--augment"] if augment else [])
                t = time.perf_counter()
                if annotate_frames.main(argv) != 0:
                    raise AssertionError(f"annotate_frames {argv} failed")
                runs[side] = {"s": time.perf_counter() - t, "labels": label_rows(out),
                              "masked": len(list((out / "masked").glob("*.png")))}
            card, cpu = runs["card"], runs["cpu"]
            if card["masked"] != n_images:
                raise AssertionError(f"{card['masked']} masked images for {n_images}")
            key = "augment" if augment else "plain"
            res[key] = {"card_s": card["s"], "cpu_s": cpu["s"],
                        **compare_labels(card["labels"], cpu["labels"], width, height,
                                         detector.conf)}
            if res[key]["lines"] == 0:
                raise AssertionError(f"annotate_frames ({key}) wrote no label line")
        # ms per image of the tool's detection step (the hflip merge included)
        det = Detector(ckpt, detect_cfg, device=device)
        frames = [load_image(p) for p in sorted(images.glob("*.png"))]
        for augment in (False, True):
            times = []
            for _ in range(3):
                for img in frames:
                    if cuda:
                        torch.cuda.synchronize()
                    t = time.perf_counter()
                    annotate_frames.detect_image(det, img, augment, det.iou)
                    if cuda:
                        torch.cuda.synchronize()
                    times.append((time.perf_counter() - t) * 1e3)
            res["augment" if augment else "plain"]["ms_per_image"] = float(np.median(times[1:]))
        del det, detector, model

        # (b) benchmark_ortho_matching --synthetic-ortho at the reference regime
        args = benchmark_ortho_matching.parse_cli_args(
            ["--synthetic-ortho", str(ortho_px), "--trials", str(trials), "--max-features",
             str(max_features), "--detectors", *TOOLS_DETECTORS, "--device", device])
        seen: dict = {}
        original = features.fast_score_map
        features.fast_score_map = fast_recorder(seen)
        reset_launches()
        t = time.perf_counter()
        try:
            rows = benchmark_ortho_matching.synthetic_ortho_rows(args, logger, dev,
                                                                 frame_size=frame_size)
        finally:
            features.fast_score_map = original
        res["b"] = {"rows": rows, "s": time.perf_counter() - t, "launches": launches(),
                    "ortho_px": ortho_px, "max_features": max_features, "trials": trials}
        sift_rows = [r for r in rows if r["detector"] == "rsift"]
        for r in sift_rows:
            if r["err"] > TOOLS_ERR_PX or r["inliers"] < TOOLS_INLIERS:
                raise AssertionError(f"rsift registration: {r}")
        if cuda and res["b"]["launches"]["fast_score"] == 0:
            raise AssertionError("the orb registration launched no FAST kernel")
        # FAST exact on the orb path's own grays
        grays = []
        for (shape, thr), gray in seen.items():
            plain = fast.fast_score_map_torch(gray, thr)
            if not torch.equal(fast.fast_score_map(gray, thr), plain):
                raise AssertionError(f"FAST kernel != plain on the orb path's gray {shape}")
            grays.append(shape)
        if not grays:
            raise AssertionError("the orb registration computed no FAST score map")
        res["b"]["grays"] = grays
        if cuda:  # the kernel timed on the path's largest gray (the ortho's)
            (_, thr), gray = max(seen.items(), key=lambda kv: kv[1].numel())
            res["b"]["fast"] = {"shape": tuple(gray.shape), **time_fast(gray, 10, thr)}
        del seen

        # (c) the video tools need FFmpeg's libraries for the port's remuxer
        probe = native.probe()
        res["c"] = {"probe": probe["found"], "ran": probe["ok"]}
        if probe["ok"]:
            res["c"].update(video_tools(tmp / "video"))
    return res


def video_tools(root: Path) -> dict:
    """merge_videos_and_logs and recut_video_and_log on two small clips of
    the port's encoder (where FFmpeg exists): frame counts checked."""
    from geotrax_tpu_torch.io.video import VideoReader, VideoWriter, keyframe_indices
    from geotrax_tpu_torch.tools import merge_videos_and_logs, recut_video_and_log

    session = root / "RAW" / "S1"
    session.mkdir(parents=True)
    rng = np.random.default_rng(0)
    base = rng.integers(0, 255, (96, 160, 3), np.uint8)
    for part, n in ((1, 30), (2, 20)):
        w = VideoWriter(session / f"DJI_000{part}.mp4", 30.0, 160, 96)
        for i in range(n):
            f = base.copy()
            f[30:50, (4 * i) % 130:(4 * i) % 130 + 24] = 255
            w.write(f)
        w.close()
    quiet = ["-q", "-lp", str(root / "logs")]
    if merge_videos_and_logs.main([str(root / "RAW"), "--video-ext", ".mp4", *quiet]) != 0:
        raise AssertionError("merge_videos_and_logs failed")
    merged = session / "0_merged.mp4"
    keys = keyframe_indices(merged)
    if recut_video_and_log.main([str(merged), "-s", "3", "-e", "40", "-o",
                                 str(root / "cut.mp4"), *quiet]) != 0:
        raise AssertionError("recut_video_and_log failed")
    counts = {"merged": sum(1 for _ in VideoReader(merged)),
              "cut": sum(1 for _ in VideoReader(root / "cut.mp4")), "keyframes": len(keys)}
    if counts["merged"] != 50:
        raise AssertionError(f"merged {counts['merged']} frames of 50")
    return counts


HOST_FILTER_SHAPE = (4096, 1800)  # a campaign's tracks x samples (one minute at 30 fps)
HOST_MOSAIC_PX = 15000            # subset_orthophoto's default --crop-size
HOST_SCALE = 0.5333333            # its --scale-factor as users pass it (8000 px out)
HOST_WINDOW = 2000                # the downscale's card-against-CPU window


def filter_bounds(shape, taps: int) -> tuple:
    """Least time of one (..., n) float32 filter on an H100: the signal read
    and the result written once, against one product and one sum per tap
    and sample."""
    n = int(np.prod(shape))
    return bound_ms(2 * 4 * n, 2 * taps * n)


def host_filters(device: str, shape=HOST_FILTER_SHAPE, seed: int = 0) -> dict:
    """(a): A23's filters on a seeded batch of random-walk tracks on
    ``device`` against the CPU, with their ms (CUDA events on the card)."""
    from geotrax_tpu_torch.ops import filters

    rng = np.random.default_rng(seed)
    host = torch.from_numpy(np.cumsum(rng.normal(0, 1, shape), -1).astype(np.float32))
    x = host.to(device)
    calls = {"gaussian": (lambda t: filters.gaussian_filter1d(t, 14.0),
                          len(filters._gaussian_weights(14.0))),
             "savgol": (lambda t: filters.savgol_filter(t, 15), 15),
             "gradient": (filters.gradient, 2)}
    res = {"shape": tuple(shape)}
    for name, (fn, taps) in calls.items():
        got = fn(x).cpu()
        want = fn(host)
        err = float((got - want).abs().max())
        if err > 2e-6 * float(want.abs().max()):
            raise AssertionError(f"{name} on {device} differs from the CPU by {err}")
        b_ms, b_by = filter_bounds(shape, taps)
        res[name] = {"max_abs_err": err, "taps": taps, "bound_ms": b_ms, "bound_by": b_by,
                     "ms": cuda_ms(lambda: fn(x), 5) if device == "cuda" else None}
    return res


def area_window_cpu(crop: np.ndarray, out_w: int, out_h: int, r0: int, c0: int,
                    size: int) -> np.ndarray:
    """Rows r0.. and columns c0.. (``size`` each) of the INTER_AREA
    downscale of ``crop``, computed on the CPU from the input rows and
    columns they read (the taps of ops/resize.py, offset)."""
    from geotrax_tpu_torch.ops import resize

    ix, ax = resize._area_taps(crop.shape[1], out_w)
    iy, ay = resize._area_taps(crop.shape[0], out_h)
    ix, ax, iy, ay = ix[c0:c0 + size], ax[c0:c0 + size], iy[r0:r0 + size], ay[r0:r0 + size]
    x0, y0 = int(ix[ax > 0].min()), int(iy[ay > 0].min())
    x1, y1 = int(ix.max()) + 1, int(iy.max()) + 1
    part = torch.from_numpy(np.ascontiguousarray(crop[y0:y1, x0:x1]))
    rows = resize._weighted_taps(part, np.where(ax > 0, ix - x0, 0), ax, dim=1)
    out = resize._weighted_taps(rows, np.where(ay > 0, iy - y0, 0), ay, dim=0)
    return torch.round(out).clamp(0, 255).to(torch.uint8).numpy()


def host_subset(root: Path, device: str, px: int = HOST_MOSAIC_PX, factor: float = HOST_SCALE,
                window: int = HOST_WINDOW, seed: int = 0) -> dict:
    """(b): subset_orthophoto on a seeded px^2 GeoTIFF mosaic (written by
    io/tiff_tiled.py) with a location at its centre: the tool's run, then
    its steps timed (host read, upload, downscale by CUDA events against
    its bytes bound, download) and the cutout the tool wrote, read back
    from its PNG: equal to the timed downscale, and a window of it equal
    to the CPU's."""
    from geotrax_tpu_torch.io.image_size import image_size
    from geotrax_tpu_torch.io.png import read_png
    from geotrax_tpu_torch.io.tiff_tiled import write_tiled_tiff
    from geotrax_tpu_torch.ops.resize import resize_area_u8
    from geotrax_tpu_torch.tools import subset_orthophoto

    t = time.perf_counter()
    rng = np.random.default_rng(seed)
    lng0, lat0, step = 126.6, 37.4, 1e-6
    mosaic = root / "mosaic.tif"
    write_tiled_tiff(mosaic, rng.integers(0, 256, (px, px, 3), dtype=np.uint8), tile=256,
                     geo=(lng0, lat0, step, step))
    centre = px // 2 + 0.5
    (root / "loc.json").write_text(json.dumps({"C": [lat0 - centre * step,
                                                     lng0 + centre * step]}))
    res = {"px": px, "factor": factor, "write_s": time.perf_counter() - t,
           "mosaic_mb": mosaic.stat().st_size / 1e6}
    out = root / "cutouts"
    t = time.perf_counter()
    rc = subset_orthophoto.main(
        ["--orthophoto-filepath", str(mosaic), "--ortho-cutout-folder", str(out),
         "--location-dict-filepath", str(root / "loc.json"), "--crop-size", str(px),
         "--scale-factor", str(factor), "-q", "-lp", str(root / "logs"), "--device", device])
    res["tool_s"] = time.perf_counter() - t
    out_w, out_h = subset_orthophoto.output_size((px, px), factor)
    if rc != 0 or image_size(out / "C.png") != (out_w, out_h):
        raise AssertionError(f"subset_orthophoto exit {rc}, cutout {out / 'C.png'}")
    if not (out / "C_center.txt").exists() or not (out / "ortho_parameters.txt").exists():
        raise AssertionError("subset_orthophoto wrote no centre or parameter file")
    logger = logging.getLogger("smoke.subset")
    t = time.perf_counter()
    crop = subset_orthophoto.MosaicSource(mosaic, logger).crop(0, 0, px, px)
    res["read_s"] = time.perf_counter() - t
    cuda = device == "cuda"
    res["upload_ms"], on_dev = events_ms(lambda: torch.from_numpy(crop).to(device), device)
    resize_area_u8(on_dev, out_w, out_h)  # the tap tables built once
    if cuda:
        torch.cuda.synchronize()
    times = [events_ms(lambda: resize_area_u8(on_dev, out_w, out_h), device) for _ in range(3)]
    res["downscale_ms"] = float(np.median([ms for ms, _ in times]))
    res["download_ms"], small = events_ms(lambda: times[-1][1].cpu().numpy(), device)
    res["bound_ms"], res["bound_by"] = bound_ms(crop.nbytes + small.nbytes,
                                                 6 * 3 * (px * out_w + out_w * out_h))
    t = time.perf_counter()
    written = read_png(out / "C.png")
    res["readback_s"] = time.perf_counter() - t
    if not np.array_equal(written, small):
        raise AssertionError("the cutout subset_orthophoto wrote differs from the timed "
                             "downscale of the same crop")
    r0 = c0 = (out_w - window) // 2
    want = area_window_cpu(crop, out_w, out_h, r0, c0, window)
    got = written[r0:r0 + window, c0:c0 + window]
    res["window_differ"] = int((got != want).any(-1).sum())
    if res["window_differ"]:
        raise AssertionError(f"downscale: {res['window_differ']} pixels of the {window}^2 "
                             "window of the written cutout differ from the CPU's")
    res.update(out=(out_w, out_h), window=window)
    return res


def host_tool_runs(root: Path, device: str) -> dict:
    """(c): each other host tool once on seeded files (written without
    pandas, Pillow or cv2), through its main() as users run it (only
    fix_timestamp_anomalies takes ``--device``, for the batch it would
    start): exit 0 and its output files present. Their text goes to a
    buffer (shown on a failure)."""
    import io

    from geotrax_tpu_torch.io import table
    from geotrax_tpu_torch.io.png import write_png
    from geotrax_tpu_torch.tools import (analyze_bb_ratios, check_dataset,
                                         compare_av_detections_and_tune_filters,
                                         compare_tracking, compute_bb_center_error,
                                         find_cut_video_issues, find_max_annotations,
                                         find_source_id, fix_json_annotations,
                                         fix_timestamp_anomalies, interpolate_missing_timestamps,
                                         viz_annotations, viz_dimension_estimation,
                                         viz_segmentations, yolo_to_coco)

    rng = np.random.default_rng(1)
    logs = ["-lp", str(root / "logs")]
    # labels and images
    for split in ("images/train", "labels/train", "pre-labels"):
        (root / "ds" / split).mkdir(parents=True)
    for i in range(3):
        write_png(root / "ds" / "images" / "train" / f"f{i}.png",
                  rng.integers(0, 255, (120, 160, 3), np.uint8))
        rows = "".join(f"{k % 4} {0.2 + 0.2 * k:.2f} 0.5 0.15 0.2\n" for k in range(i + 1))
        (root / "ds" / "labels" / "train" / f"f{i}.txt").write_text(rows)
        (root / "ds" / "pre-labels" / f"f{i}.txt").write_text(rows.replace(" 0.5 ", " 0.51 "))
    # labelme JSON
    (root / "labelme").mkdir()
    (root / "labelme" / "a.json").write_text(json.dumps({
        "imagePath": "x\\a.png", "imageData": "QUJD",
        "shapes": [{"label": "car", "shape_type": "rectangle", "points": [[1, 2], [5, 6]]}]}))
    # flight logs
    stamps = [f"2022-10-07 10:00:{i // 30:02d}.{(i % 30) * 33:03d}" for i in range(90)]
    table.write_csv(root / "U1.csv", {"frame": np.arange(90),
                                      "timestamp": np.array(stamps, dtype=object)})
    holes = np.array(stamps, dtype=object)
    holes[[3, 4, 50]] = np.nan
    table.write_csv(root / "gaps.csv", {"frame": np.arange(90), "timestamp": holes})
    (root / "U1.MP4").write_bytes(b"")
    table.write_csv(root / "anomalies.csv", {
        "location_id": np.array(["U"], dtype=object),
        "video_path": np.array(["U1.MP4"], dtype=object),
        "timestamp_max_abs_diff": np.array([1.5]),
        "timestamp_anomaly_location": np.array([stamps[40]], dtype=object),
        "timestamp_anomaly_frame": np.array([40])})
    # aggregated ids, trajectories, tracks
    for drone, n in (("D3", 3), ("D10", 2)):
        res_dir = root / "PROCESSED" / "2022-10-07" / drone / "PM5" / "results"
        res_dir.mkdir(parents=True)
        table.write_csv(res_dir / f"U_{drone}.csv", {"Vehicle_ID": np.arange(1, n + 1)})
    table.write_csv(root / "speeds.csv", {"Vehicle_ID": np.array([1, 1, 2]),
                                          "Vehicle_Speed": np.array([150.0, 160.0, 50.0]),
                                          "Vehicle_Acceleration": np.array([1.0, 0.5, -14.0])})
    rows = []
    for t in range(30):
        x = 500.0 + 50 * t
        rows.append([t, 3, x, 500, 60, 25, x, 500, 60, 25, 0, 0.9, 60, 25])
        rows.append([t, 4, 900, 900 + 30 * t, 20, 40, 900, 900 + 30 * t, 20, 40, 1, 0.9, 40, 20])
    for run in ("runA", "runB"):
        (root / run / "results").mkdir(parents=True)
        keep = rows if run == "runA" else rows[::2]
        np.savetxt(root / run / "results" / "V.txt", np.array(keep), fmt="%g", delimiter=",")
    (root / "runA" / "V.yaml").write_text("video:\n  width: 3840\n  height: 2160\n")
    frames = np.arange(60)
    x = 170000 + 2.0 * frames
    table.write_csv(root / "p.csv", {"Vehicle_ID": np.full(60, 7), "Frame_Number": frames,
                                     "Local_X": x + rng.normal(0, 0.02, 60),
                                     "Local_Y": np.full(60, 532000.0),
                                     "Vehicle_Speed": np.full(60, 72.0)})
    table.write_csv(root / "gt.csv", {"frame": frames, "x": x, "y": np.full(60, 532000.0),
                                      "speed_kmh": np.full(60, 72.0)})
    # an orthophoto and its lane quads
    (root / "ortho" / "segmentations").mkdir(parents=True)
    write_png(root / "ortho" / "U.png", rng.integers(0, 255, (200, 260, 3), np.uint8))
    table.write_csv(root / "ortho" / "segmentations" / "U.csv", {
        "section": np.array(["1_2", "3_4"], dtype=object), "lane": np.array([1, 2]),
        "tlx": np.array([20, 150]), "tly": np.array([20, 100]), "blx": np.array([22, 140]),
        "bly": np.array([80, 180]), "brx": np.array([52, 230]), "bry": np.array([82, 170]),
        "trx": np.array([50, 240]), "try": np.array([18, 110])})

    ds, tr = root / "ds", root / "runA" / "results" / "V.txt"
    runs = [
        (find_max_annotations, [str(ds / "labels")], []),
        (interpolate_missing_timestamps, [str(root / "gaps.csv"), "-o", str(root / "filled.csv")],
         [root / "filled.csv"]),
        (yolo_to_coco, [str(ds), "--split", "train", "-o", str(root / "coco.json"), *logs],
         [root / "coco.json"]),
        (fix_json_annotations, [str(root / "labelme"), "--to-obb", "-nu", "-q", *logs],
         [root / "labelme" / "a.json"]),
        (find_source_id, [str(root / "PROCESSED"), "2022-10-07", "U", "PM5", "4"], []),
        (check_dataset, [str(root / "speeds.csv"), "--no-trace"], []),
        (compare_tracking, [str(root / "runA" / "results"), str(root / "runB" / "results"),
                            "--plot", str(root / "cmp.pdf")], []),
        (analyze_bb_ratios, [str(root / "runA"), "--hist"], []),
        (compute_bb_center_error, [str(ds / "images" / "train"), "-ha", "../../labels/train",
                                   "-pa", "../../pre-labels", "--save", "-q", *logs], []),
        (find_cut_video_issues, [str(root / "U1.csv"), "--report", str(root / "report")],
         [root / "report" / "flight_log_stats.csv"]),
        (fix_timestamp_anomalies, [str(root / "anomalies.csv"), "--debug", "-q", *logs,
                                   "--device", device], []),
        (viz_dimension_estimation, [str(tr), "--id", "3", "--frame-size", "3840", "2160",
                                    "--save", "-q", *logs], []),
        (compare_av_detections_and_tune_filters,
         [str(root / "p.csv"), "--probe", str(root / "gt.csv"), "--fps", "10", "--tune",
          "--grid", "2", "5", "--save", "--out", str(root / "av"), "-q", *logs],
         [root / "av" / "AV_errors_per_video.tex"]),
        (viz_annotations, [str(ds / "images" / "train"), "-a", str(ds / "labels" / "train"),
                           "--save", "-o", str(root / "viz"), "-q", *logs],
         [root / "viz" / "f2.png"]),
        (viz_segmentations, [str(root / "ortho"), "-o", str(root / "lanes")],
         [root / "lanes" / "U.png"]),
    ]
    res = {}
    for module, argv, outputs in runs:
        name = module.__name__.rsplit(".", 1)[-1]
        text = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(text), contextlib.redirect_stderr(text):
            rc = module.main(argv)
        missing = [str(p) for p in outputs if not p.exists()]
        if rc != 0 or missing:
            raise AssertionError(f"{name} exit {rc}, missing {missing}:\n"
                                 f"{text.getvalue()[-2000:]}")
        res[name] = time.perf_counter() - t
    if json.loads((root / "labelme" / "a.json").read_text())["shapes"][0]["shape_type"] \
            != "polygon":
        raise AssertionError("fix_json_annotations --to-obb left the rectangle")
    return res


def phase_host_tools(device: str = "cuda", filter_shape=HOST_FILTER_SHAPE,
                     mosaic_px: int = HOST_MOSAIC_PX, window: int = HOST_WINDOW) -> dict:
    """Phase 18 (see the module's docstring); the CPU rehearsal passes
    small sizes."""
    dev = resolve_device(device)
    res = {"a": host_filters(dev.type, filter_shape)}
    with tempfile.TemporaryDirectory() as tmpdir:
        t = time.perf_counter()
        res["b"] = host_subset(Path(tmpdir), dev.type, px=mosaic_px, window=window)
        res["b"]["s"] = time.perf_counter() - t
    with tempfile.TemporaryDirectory() as tmpdir:
        res["c"] = host_tool_runs(Path(tmpdir), dev.type)
    return res


def host_tools_line(ht: dict, seconds: float, smi: str) -> str:
    a, b, c = ht["a"], ht["b"], ht["c"]
    filt = "; ".join(
        f"{name} ({a[name]['taps']} taps): "
        + (f"{a[name]['ms']:.4f} ms" if a[name]["ms"] is not None else "not timed")
        + f" against a {a[name]['bound_ms']:.4f} ms bound ({a[name]['bound_by']}), max |card - "
          f"CPU| {a[name]['max_abs_err']:.1e}" for name in ("gaussian", "savgol", "gradient"))
    share = b["bound_ms"] / b["downscale_ms"] if b["downscale_ms"] else float("nan")
    return (f"host-tools ok {seconds:.1f}s (a) ops/filters.py on {a['shape']} float32 tracks: "
            f"{filt}; (b) subset_orthophoto --crop-size {b['px']} --scale-factor {b['factor']} "
            f"({b['mosaic_mb']:.1f} MB tiled GeoTIFF written in {b['write_s']:.1f}s) to "
            f"{b['out'][0]}x{b['out'][1]}: the tool's run {b['tool_s']:.1f}s; host read "
            f"{b['read_s']:.2f}s, upload {b['upload_ms']:.1f} ms, downscale "
            f"{b['downscale_ms']:.3f} ms against a {b['bound_ms']:.4f} ms bound "
            f"({b['bound_by']}, {100 * share:.1f} %), download {b['download_ms']:.1f} ms; the "
            f"written cutout (read back in {b['readback_s']:.2f}s) equal to it and its "
            f"{b['window']}^2 window equal to the CPU's; (c) {len(c)} tools exit 0 with their "
            f"files: " + ", ".join(f"{k} {v:.2f}s" for k, v in c.items()) + f" [{smi}]")


def tools_line(tl: dict, seconds: float, smi: str) -> str:
    w, h = tl["size"]
    a = "; ".join(
        f"{k}: {tl[k]['lines']} lines (CPU {tl[k]['cpu_lines']}), box within "
        f"{tl[k]['box_px']:.2e} px, score within {tl[k]['score']:.1e}, {tl[k]['at_threshold']} "
        f"at the threshold, {tl[k]['ms_per_image']:.1f} ms per image (the tool's run "
        f"{tl[k]['card_s']:.1f}s, on the CPU {tl[k]['cpu_s']:.1f}s)" for k in ("plain", "augment"))
    b = tl["b"]
    rows = "; ".join(
        f"{r['name']} {r['detector']}: corner error {r['err']:.3f} px, {r['inliers']} inliers of "
        f"{r['matches']} matches, {r['wall_s']:.2f}s"
        + (f", peak {r['peak_gib']:.2f} GiB" if r["peak_gib"] is not None else "")
        for r in b["rows"])
    c = tl["c"]
    c_text = (f"(c) merge_videos_and_logs and recut_video_and_log ran: {c['merged']} frames "
              f"merged, {c['cut']} cut, {c['keyframes']} keyframes" if c["ran"] else
              f"(c) the video tools did not run: this machine lacks libav ({c['probe']})")
    return (f"tools ok {seconds:.1f}s (a) annotate_frames YOLOv8{tl['variant']} nc=4 imgsz "
            f"{tl['imgsz']} on {tl['images']} PNGs {w}x{h} ({tl['calibrated']} detections "
            f"calibrated on the first), card against CPU: {a}; (b) benchmark_ortho_matching "
            f"--synthetic-ortho {b['ortho_px']} --max-features {b['max_features']} --trials "
            f"{b['trials']} (cut from 2): {rows}; FAST launches {b['launches']['fast_score']}, "
            f"exact on the path's grays {b['grays']}"
            + (f", on {b['fast']['shape']} {fast_line(b['fast'])}" if "fast" in b else "")
            + f"; {b['s']:.1f}s; {c_text} [{smi}]")


def features_line(ft: dict, seconds: float, smi: str) -> str:
    a, b, c = ft["a"], ft["b"], ft["c"]
    steps = ", ".join(f"{n} {v:.2f}" for n, v in a["ms"].items())
    cache = ("" if c["cache_s"] is None else
             f"text-file run with the master path {c['cache_s']:.1f}s; ")
    return (f"features ok {seconds:.1f}s (a) {a['shape'][0]}x{a['shape'][1]} gray of a drifting "
            f"4K frame and its {FEATURE_ZOOM}x zoom, K={a['k']}, {a['levels']}-level pyramids: ms "
            f"(median of 3; CUDA events on the card) {steps}; launches {a['launches']}; "
            f"{a['matches']} matches, {a['inliers']} inliers, zoom recovered within "
            f"{a['h_err_px']:.3f} px; card vs CPU: keypoints equal, angles within "
            f"{a['angle_err']:.2e} rad, bits differing {a['bits']}, pyramid keypoints shared "
            f"{a['overlap']}, matches equal; kernels exact on these inputs; (b) lapjv_exact "
            f"{b['shape'][0]}x{b['shape'][1]} {b['s']:.3f}s, equal to scipy ({b['scipy_s']:.3f}s);"
            f" (c) fixtures {ft['fixtures']['files']} equal to Pillow's pixels; GeoTIFF "
            f"{c['tif_bytes'] / 1e6:.1f} MB written in {c['write_s']:.1f}s; {cache}text-file run "
            f"from the cache {c['text_s']:.1f}s, .tif-only run {c['tif_s']:.1f}s of which the "
            f".tif -> .png conversion {c['convert_s']:.1f}s (host); PNG equal to the ortho, "
            f"parameters equal, CSV byte-equal ({c['rows']} rows, {c['csv_bytes']} bytes); "
            f"seconds (a) {ft['a_s']:.1f}, (b) {ft['b_s']:.1f}, (c) {ft['c_s']:.1f} [{smi}]")


def train_line(tr: dict, seconds: float, smi: str) -> str:
    w, h = tr["size"]
    tm, md = tr["timed"], tr["timed"]["median"]
    cc, rs = tr["card_vs_cpu"], tr["resume"]
    return (f"train ok {seconds:.1f}s YOLOv8s nc=4 fine-tuned from a seeded checkpoint (head "
            f"priors) at the default preset's imgsz "
            f"{tr['imgsz']}, batch {tr['batch']} on {tr['counts'][0]} train + {tr['counts'][1]} "
            f"val PNGs {w}x{h} ({tr['labels']} labels, written in {tr['write_s']:.1f}s): "
            f"(b) {tr['epochs']} epochs {tr['full_s']:.1f}s, epoch_s {tr['full']['epoch_s']}, "
            f"losses {tr['full']['losses']}, lr {tr['full']['lr']}, mAP50 {tr['full']['map50']}, "
            f"single-class mAP50 {tr['single_cls']:.4f}, {tr['n_params']} parameters, every file "
            f"written, run peak {tr['run_peak_gib']:.2f} GiB; 1 epoch ({tr['part_s']:.1f}s) "
            f"resumed to {tr['epochs']} ({tr['resumed_s']:.1f}s): losses {tr['resumed']['losses']},"
            f" lr equal, loss rel diff {[f'{x:.2e}' for x in rs['loss_rel']]}, last.npz weights "
            f"max abs diff {rs['weight_max_abs']:.3e} (rel L2 {rs['weight_rel_l2']:.3e}); "
            f"(c) card vs CPU at imgsz {tr['check_imgsz']} batch {tr['check_batch']}: loss "
            f"{cc['loss_card']:.6f} vs {cc['loss_cpu']:.6f} (rel {cc['loss_rel']:.2e}; float64 "
            f"{cc['loss_f64']:.6f}), fg {cc['fg'][0]}, gradients' rel L2 over {cc['params']} "
            f"parameters, worst parameter / all at once: card vs CPU {cc['card_cpu_max']:.2e} / "
            f"{cc['card_cpu_all']:.2e}, card vs float64 {cc['card_f64_max']:.2e} / "
            f"{cc['card_f64_all']:.2e}, CPU vs float64 {cc['cpu_f64_max']:.2e} / "
            f"{cc['cpu_f64_all']:.2e}; (d) per step (median of {len(tm['steps']) - 1} after "
            f"the first, CUDA events): forward+loss {md['forward']:.2f} ms, backward {md['backward']:.2f} ms, "
            f"update {md['update']:.2f} ms, wall {md['wall']:.1f} ms, bound "
            f"{tm['bound_ms']:.2f} ms "
            f"({tm['bound_by']}, {tm['flops'] / 1e12:.3f} TFLOP, forward "
            f"{tm['forward_flops'] / 1e12:.3f}), {100 * tm['bound_ms'] / tm['span_ms']:.1f}% of "
            f"it; loader {[round(x, 1) for x in tm['load_ms']]} ms per batch of {tr['batch']} "
            f"PNGs; idle share {100 * tm['idle_share']:.1f}%; peak {tm['peak_gib']:.2f} GiB; "
            f"evaluate {tm['eval_ms_per_image']:.1f} ms/image, of which forward + NMS "
            f"{tm['infer_ms_per_image']:.1f} (+ loading "
            f"{tm['val_load_ms_per_image']:.1f}); launches {tr['launches']} [{smi}]")


def ranks_text(rk: dict, base_rows: int) -> str:
    steps = "; ".join(
        f"rank {r['rank']} ({r['device']}, {r['rows']} rows): step ms forward "
        f"{[round(x['forward'], 2) for x in r['steps']]}, backward "
        f"{[round(x['backward'], 2) for x in r['steps']]}, all-reduce "
        f"{[round(x['all_reduce'], 2) for x in r['steps']]}, update "
        f"{[round(x['update'], 2) for x in r['steps']]}, loader "
        f"{[round(x, 1) for x in r['load_ms']]} ms per {r['rows']} PNGs, peak "
        f"{r['peak_gib']:.2f} GiB" for r in rk["ranks"])
    return (f"{rk['world']} ranks over {rk['backend']} ({rk['s']:.1f}s): weights bit-equal on "
            f"every rank; against one rank of {base_rows} rows: loss rel "
            f"{[f'{x:.2e}' for x in rk['loss_rel']]}, momentum rel L2 worst parameter / all "
            f"{rk['trace_max']:.2e} / {rk['trace_all']:.2e}, weights {rk['param_max']:.2e} / "
            f"{rk['param_all']:.2e} (tolerance {MULTI_REL_TOL:g} all at once), fg {rk['fg'][0]}; "
            f"{steps}")


def detection_text(d: dict) -> str:
    return (f"make_inference_step on {d['frames']} frames {d['input']} over 1 device "
            f"{d['one_s'] * 1e3:.1f} ms and {d['devices']} {d['many_s'] * 1e3:.1f} ms, "
            f"bit-equal ({sum(d['per_frame'])} detections, {min(d['per_frame'])}-"
            f"{max(d['per_frame'])} per frame); make_tiled_detector {MULTI_TILES} tiles "
            f"{d['tiled_s'] * 1e3:.1f} ms, over {d['devices']} devices {d['spread_s'] * 1e3:.1f}"
            f" ms, bit-equal ({d['tiled']} detections)")


def multi_line(mu: dict, seconds: float, smi: str) -> str:
    w, h = mu["size"]
    a, c = mu["a"], mu["c_run"]
    a_steps = "; ".join(f"forward {x['forward']:.2f} backward {x['backward']:.2f} update "
                        f"{x['update']:.2f}" for x in a["steps"])
    e, n = mu["e"], mu["cards"]
    e_text = (f"(e) did not run for want of cards: {n} card, it needs 2" if e is None else
              f"(e) {ranks_text(e['ranks'], a['rows'])}; {detection_text(e['d'])}; lockstep "
              f"--parallel-videos 4 --devices {n} equal to --devices 1 "
              f"({e['lockstep']['rows']} rows; {e['lockstep']['devices1_s']:.1f}s and "
              f"{e['lockstep'][f'devices{n}_s']:.1f}s)")
    return (f"multi ok {seconds:.1f}s YOLOv8s nc=4 at imgsz {mu['imgsz']}, global batch "
            f"{mu['batch']}, {mu['steps']} steps on {mu['counts'][0]} train PNGs {w}x{h} "
            f"({mu['labels']} labels, written in {mu['write_s']:.1f}s): (a) one rank in a "
            f"{a['backend']} group bit-equal to no group, and no group twice (PyTorch's "
            f"deterministic algorithms), per step ms {a_steps}, loader "
            f"{[round(x, 1) for x in a['load_ms']]} ms per {a['rows']} PNGs, peak "
            f"{a['peak_gib']:.2f} GiB ({a['s']:.1f}s); (b) {ranks_text(mu['b'], a['rows'])}; "
            f"(c) {mu['c_refused']!r}; --devices 1 wrote every run file, loss "
            f"{c['losses']} ({mu['c_s']:.1f}s); (d) {detection_text(mu['d'])}, calibrated "
            f"{mu['d_calibrated']} detections on frame 0, launches {mu['d']['launches']}; "
            f"{e_text} [{smi}]")


def render_line(rd: dict, seconds: float, smi: str) -> str:
    w, h = rd["size"]
    modes = "; ".join(
        f"mode {m}: {v['frames']} frames ({v['warped']} warped), ms/frame read "
        f"{v['read_ms']:.1f} warp {v['warp_ms']:.1f} draw {v['draw_ms']:.1f} write "
        f"{v['write_ms']:.1f}, card vs cpu max {v['max_diff']} level(s) on "
        f"{100 * v['share_diff']:.4f} % of pixels"
        + (f", {v['decoded']} decoded" if v["decoded"] is not None else "")
        for m, v in rd["modes"].items())
    wp = rd["warp"]
    warp = (f"warp of one {w}x{h} frame {wp['ms']:.4f} ms (bound {wp['bound_ms']:.4f} ms, "
            f"{wp['bound_by']}, {wp['bytes'] / 1e6:.1f} MB)")
    if wp["upload_ms"] is not None:
        warp += f", upload {wp['upload_ms']:.3f} ms, download {wp['download_ms']:.3f} ms"
    pl = rd["plot"]
    plot = (f"{len(pl['figures'])} PDFs as plot_dataset names them" if pl["figures"] is not None
            else f"figures NOT drawn ({pl['missing']}); data half only: {pl['rows']} rows read, "
                 f"file choice, class filter and alerts run")
    d = rd["d"]
    return (f"render ok {seconds:.1f}s {rd['frames']} frames {w}x{h}, {rd['vehicles']} vehicles, "
            f"{rd['rows']} track rows, writer "
            + ("the port's encoder (decoded back)" if rd["decode"] else
               f"in memory (no encoder: {rd['probe']})")
            + f": (a) {modes}; (b) {warp}; (c) plot on {rd['plot_rows']} rows: {plot} in "
              f"{pl['s']:.1f}s; (d) batch with its default gates and --no-geo: lockstep "
              f"{d['calls']['lockstep']}, visualize {d['calls']['visualize']}, plot "
              f"{d['calls']['plot']}, frames written {d['frames_written']}, {d['pdfs']} PDFs; "
              f"seconds (a) {rd['a_s']:.1f}, (c) {rd['c_s']:.1f}, (d) {rd['d_s']:.1f} [{smi}]")


def lockstep_line(lk: dict, seconds: float, smi: str) -> str:
    b, k = lk["b"], lk["kernels"]
    lock = [r["fps"] for r in b["runs"]["lockstep"]]
    serial = [r["fps"] for r in b["runs"]["serial"]]
    a = "; ".join(f"{t} " + ("equal" if r["equal"] else
                             f"largest difference per column {r['col_diff']}")
                  + f" ({r['rows']} rows)" for t, r in lk["a"].items())
    peak = [None if r["peak_gib"] is None else round(r["peak_gib"], 1)
            for r in b["runs"]["lockstep"]]
    line = (f"lockstep ok {seconds:.1f}s 4 videos {lk['size'][0]}x{lk['size'][1]} of "
            f"{lk['lengths']} frames, {lk['vehicles']} vehicles each: (a) oracle, stabilization "
            f"off, lockstep vs run_extraction alone: {a}; (b) YOLOv8 imgsz {lk['imgsz']} with "
            f"ReID, {b['steps']} steps: ms/step {[round(m, 1) for m in b['step_ms']]}, median "
            f"after the first {b['step_median_ms']:.1f} ms (last run "
            f"{[round(m, 1) for m in b['last_step_ms']]}, median {b['last_step_median_ms']:.1f} "
            f"ms); frames/s in turns lockstep "
            f"{[round(x, 2) for x in lock]}, run_extraction one video after another "
            f"{[round(x, 2) for x in serial]}; {b['rows']} rows, camera error "
            f"{b['camera_err_px']:.3f} px, launches {b['launches']}, embedding norm err "
            f"{lk['emb_norm_err']:.2e}; peak mem {peak} GiB; (c) FAST {k['gray_shape']} exact")
    if "fast" in k:
        line += (f": {k['fast']['ms']:.4f} ms (plain {k['fast']['plain_ms']:.3f}, bound "
                 f"{k['fast_bound_ms']:.4f})")
    line += f"; {hwc_text(k['gather'])}"
    if "fast" in k:
        line += f", embed_boxes {k['embed_ms']:.3f} ms"
        line += ", detect_batch ms per frame at batch " + ", ".join(
            f"{n}: {ms:.1f}" for n, ms in k["detect_ms_per_frame"].items())
    return line + (f"; (d) batch --parallel-videos 4 twice: stage calls {lk['d_calls_0']} then "
                   f"{lk['d_calls_1']}, modes {sorted(set(lk['d_modes']))}; seconds (a) "
                   f"{lk['a_s']:.1f}, (b) {b['s']:.1f}, (c) {lk['c_s']:.1f}, (d) {lk['d_s']:.1f}"
                   f" [{smi}]")


def lockstep_profile_lines(prof: dict) -> list:
    n = prof["steps"]
    lines = [f"    lockstep profile: {n} steps in {prof['wall_ms']:.1f} ms under the profiler, "
             f"device busy {prof['device_busy_ms']:.1f} ms"]
    lines += [f"    stage {name:16s} host {cpu / n:8.1f} ms/step  kernels {dev / n:8.1f} ms/step  "
              f"device span {span / n:8.1f} ms/step" for name, cpu, dev, span in prof["stages"]]
    lines += [f"    kernel {ms:9.3f} ms  x{count:<6d} {name[:90]}" for name, ms, count in
              prof["top"][:8]]
    return lines


def sequential_line(sq: dict, seconds: float, smi: str) -> str:
    a, b, c = sq["a"], sq["b"], sq["c"]
    ms = lambda st: (f"detect {st['avg_detect_ms']:.1f}, stabilize {st['avg_stab_ms']:.1f}, "  # noqa: E731
                     f"track {st['avg_track_ms']:.1f} ms/frame")
    k = sq["kernels"]
    w, h = sq["size"]
    line = (f"sequential ok {seconds:.1f}s {sq['frames']} frames {w}x{h}, {sq['vehicles']} "
            f"vehicles: (a) fused vs sequential (oracle, ReID, {a['rows']} rows): 1-frame chunks "
            f"every value equal {a['chunk1']['equal']}; one {sq['frames']}-frame chunk: frames, "
            f"ids, classes, scores equal, every value equal {a['chunk']['equal']}, boxes within "
            f"{a['chunk']['box_diff_px']:.3g} px, H within {a['chunk']['h_diff']:.3g} "
            f"({a['chunk']['h_diff_px']:.3g} px at the corners); camera error "
            f"{a['camera_err_px']:.3f} px; "
            f"(b) YOLOv8{sq['variant']} imgsz {sq['imgsz']} + rsift, one detect_batch group: "
            f"{ms(b['stats'])}, "
            f"{sq['b_detections_frame0']} detections on frame 0, {b['checks']['rows']} rows, "
            f"camera error {b['checks']['camera_err_px']:.3f} px, run {b['s']:.1f}s; (c) RT-DETR-L "
            f"(ULSpec nc=4) imgsz {sq['imgsz']} + orb + ReID: {ms(c['stats'])}, "
            f"{sq['c_detections_frame0']} "
            f"detections on frame 0, {c['checks']['rows']} rows, camera error "
            f"{c['checks']['camera_err_px']:.3f} px, launches {sq['c_launches']}, run {c['s']:.1f}s")
    if "c_forward_ms" in sq:
        line += (f"; forward {sq['c_forward_ms']:.2f} ms/frame (detect_batch "
                 f"{sq['c_detect_ms']:.2f} ms) against the float32 bound {sq['c_bound_ms']:.2f} ms "
                 f"({sq['c_flops'] / 1e12:.3f} TFLOP), stage peak {c['peak_gib']:.2f} GiB")
    cc = sq["c_card_vs_cpu"]
    line += (f"; card vs CPU at imgsz {sq['check_imgsz']}: {cc['valid']} valid, scores "
             f"{cc['score_err']:.2e}, boxes {cc['box_err_px']:.2e} px (slot-wise "
             f"{cc['slot_box_err_px']:.2e})")
    line += "; on the path's own inputs: "
    if "fast" in k:
        line += (f"fast_score {k['gray_shape']} {fast_line(k['fast'])}, embed_boxes "
                 f"{k['embed_ms']:.3f} ms, ")
    return line + hwc_text(k["gather"]) + f" [{smi}]"


def fast_line(res: dict) -> str:
    return (f"kernel_ms={res['ms']:.4f} plain_ms={res['plain_ms']:.3f} "
            f"bound_ms={res['bound_ms']:.4f} ({res['bound_by']}), {res['gb_per_s']:.0f} GB/s, "
            f"{100 * res['share']:.1f}% of the bound, {100 * res['full_test_share']:.1f}% of "
            f"pixels take the full test")


def georef_line(geo: dict, seconds: float, smi: str) -> str:
    first, second = geo["runs"]
    steps = "; ".join(f"{k} {v:.2f}" for k, v in first["seconds"].items())
    cached = "; ".join(f"{k} {v:.2f}" for k, v in second["seconds"].items())
    ka, kb = geo["match_shape"]
    return (
        f"georef ok {seconds:.1f}s georeference with the master path, 3840x2160 reference and "
        f"master frames against a {GEO_ORTHO_PX}^2 ortho at 250k features: assets (scene "
        f"{geo['scene_s']:.1f}s, PNG writes {geo['png_s']:.1f}s, flight log and "
        f"{geo['tracked_rows']} tracked rows {geo['tracks_s']:.1f}s); run 1 {first['wall_s']:.1f}s"
        f" (stage peak mem {first['peak_gib']:.1f} GiB; s per step: {steps}), run 2 from the cache "
        f"{second['wall_s']:.1f}s (peak mem {second['peak_gib']:.1f} GiB; {cached}); "
        f"keypoints master {geo['n_master']} (slots {geo['frame_slots']}), ortho "
        f"{geo['n_ortho']} (slots {geo['ortho_slots']}), inliers {geo['inliers']} of "
        f"{geo['matches']} matches, corner error master->ortho {geo['master_err_px']:.3f} px, "
        f"reference->ortho {geo['ref_err_px']:.3f} px; CSV {geo['csv']['rows']} rows / "
        f"{geo['csv']['tracks']} tracks, lanes and sections equal on {geo['csv']['checked']} "
        f"rows, rerun within {geo['rerun_px']:.2e} px; read_csv of it "
        f"({geo['csv']['bytes']} bytes, host) {geo['csv']['read_s'][0]:.3f}s and "
        f"{geo['csv']['read_s'][1]:.3f}s, with float() for the float cells "
        f"{geo['csv']['float_read_s']:.3f}s; device steps alone (CUDA events): ortho features "
        f"{geo['ortho_ms']:.1f} ms, frame features {geo['frame_ms']:.1f} ms, match_l2 "
        f"{ka}x{kb} {geo['match_ms']:.1f} ms (float32 bound {geo['match_bound_ms']:.1f} ms), "
        f"RANSAC {geo['ransac_hypotheses']} hypotheses {geo['ransac_ms']:.1f} ms "
        f"({geo['timed_inliers']} inliers, {geo['timed_err_px']:.3f} px); orb-path Stabilizer "
        f"pair: {geo['orb_launches']} FAST launches, {geo['orb_inliers']} inliers, corner error "
        f"{geo['orb_err_px']:.3f} px [{smi}]")


def breakdown_lines(brk: dict) -> list:
    lines = [f"    ortho level {i} {lv['shape'][0]}x{lv['shape'][1]} budget {lv['budget']}"
             f"{' banded' if lv['banded'] else ''}: resize {lv['resize_ms']:.1f} ms (bound "
             f"{lv['resize_bound_ms']:.1f} ms), features {lv['features_ms']:.1f} ms"
             for i, lv in enumerate(brk["levels"])]
    lines += [f"    ortho band {brk['band'][0]}x{brk['band'][1]}: {name} {ms:.2f} ms (bound "
              f"{bound:.3f} ms, {by})" for name, (ms, bound, by) in brk["pieces"].items()]
    return lines


def gather_text(r: dict) -> str:
    """One shape's float-gather numbers for the kernel phase's line."""
    text = f"{r['shape']} x {r['corners']}"
    if "ms" in r:
        text += (f": kernel_ms={r['ms']:.4f} ({100 * r['bound_ms'] / r['ms']:.1f}% of the bound) "
                 f"as_called_ms={r['eager_ms']:.4f} unfold_gather_ms={r['library_ms']:.4f} "
                 f"plain_ms={r['plain_ms']:.3f}")
    return text + f" bound_ms={r['bound_ms']:.4f} ({r['bound_by']}, {r['bytes'] / 1e6:.1f} MB)"


GATHER_KEYS = ("shape", "corners", "ms", "eager_ms", "library_ms", "plain_ms", "bound_ms")
HWC_KEYS = ("shape", "corners", "pool2", "mean4", "ms", "eager_ms", "library_ms", "plain_ms",
            "bound_ms", "kernel_gib")


def kernel_entry(name: str, source: str, replaces: str, launches: int, res: dict,
                 sequential_launches: int, lockstep_launches: int, lockstep: dict,
                 render_launches: int, train_launches: int, features_launches: int,
                 **extra) -> dict:
    """One kernel's entry of the JSON line; ``lockstep`` holds its shape,
    time and bound on the lockstep phase's own inputs; ``extra`` adds keys."""
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": res["max_abs_err"], "ms": res["ms"],
            "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"], "bound_by": res["bound_by"],
            "library_ms": res.get("library_ms"), "launches_sequential": sequential_launches,
            "launches_lockstep": lockstep_launches, **{f"{k}_lockstep": v
                                                        for k, v in lockstep.items()},
            "launches_render": render_launches, "launches_train": train_launches,
            "launches_features": features_launches, **extra}


def multi_entry(mu: dict) -> dict:
    """Phase 16's numbers for the JSON line: no kernel of its own (the
    training step and detection run cuDNN convolutions and torch ops)."""
    def ranks(rk):
        return {"world": rk["world"], "backend": rk["backend"], "rows": rk["rows"],
                "trace_rel_l2": rk["trace_all"], "loss_rel": rk["loss_rel"],
                "step_ms": [[x["forward"] + x["backward"] + x["all_reduce"] + x["update"]
                             for x in r["steps"]] for r in rk["ranks"]],
                "all_reduce_ms": [[x["all_reduce"] for x in r["steps"]] for r in rk["ranks"]],
                "load_ms": [r["load_ms"] for r in rk["ranks"]],
                "peak_gib": [r["peak_gib"] for r in rk["ranks"]]}

    a = mu["a"]
    return {"a": {"group_equal": a["group_equal"], "repeat_equal": a["repeat_equal"],
                  "step_ms": [x["forward"] + x["backward"] + x["update"] for x in a["steps"]],
                  "load_ms": a["load_ms"], "peak_gib": a["peak_gib"]},
            "b": ranks(mu["b"]), "d": {k: mu["d"][k] for k in ("one_s", "many_s", "tiled_s",
                                                              "spread_s", "step_diff",
                                                              "tiled_diff")},
            "e": None if mu["e"] is None else {"ranks": ranks(mu["e"]["ranks"]),
                                               "lockstep_rows": mu["e"]["lockstep"]["rows"]},
            "cards": mu["cards"]}


def main(argv) -> int:
    kernels_only = "--kernels-only" in argv
    georef_only = "--georef-only" in argv
    lockstep_only = "--lockstep-only" in argv
    render_only = "--render-only" in argv
    train_only = "--train-only" in argv
    features_only = "--features-only" in argv
    multi_only = "--multi-only" in argv
    tools_only = "--tools-only" in argv
    host_tools_only = "--host-tools-only" in argv
    t_all = time.perf_counter()
    width, height, chunk, seed = 3840, 2160, 32, 0
    n_main = 2 * chunk
    horizon = n_main + (STEADY_CHUNKS + 1) * chunk  # main, steady, breakdown
    try:
        t = time.perf_counter()
        dev = phase_device()
        log(f"device ok {time.perf_counter() - t:.1f}s {dev['name']} x{dev['count']} | {dev['smi']}")

        t = time.perf_counter()
        build_logs = phase_build()
        log(f"build ok {time.perf_counter() - t:.1f}s (all at once) nvcc -Xptxas -v and g++:")
        for name, build_log in build_logs.items():
            for line in build_log.strip().splitlines():
                print(f"    {name}: {line}", flush=True)

        t = time.perf_counter()
        kern = phase_kernel("cuda")
        log(f"kernel ok {time.perf_counter() - t:.1f}s fast_score exact on textured (33,1080,1920), "
            f"(2,37,53), a checkerboard and a constant image at t=20,7; seeded (32,1080,1920): "
            f"{fast_line(kern)} [{dev['smi']}]")
        t = time.perf_counter()
        pg = phase_patches("cuda")
        log(f"kernel ok {time.perf_counter() - t:.1f}s patch_gather exact (and unfold-gather) "
            f"on (2,37,53) x 130 and " + "; ".join(gather_text(r) for r in pg["shapes"])
            + f" [{dev['smi']}]")
        if kernels_only:
            log(f"kernels-only ok {time.perf_counter() - t_all:.1f}s")
            return 0
        if georef_only:
            t = time.perf_counter()
            geo = phase_georef("cuda")
            log(georef_line(geo, time.perf_counter() - t, dev["smi"]))
            print("\n".join(breakdown_lines(geo["ortho_breakdown"])), flush=True)
            log(f"georef-only ok {time.perf_counter() - t_all:.1f}s")
            return 0
        if render_only:
            t = time.perf_counter()
            reset_launches()
            rn = phase_render("cuda")
            log(render_line(rn, time.perf_counter() - t, dev["smi"]) + f", launches {launches()}")
            log(f"render-only ok {time.perf_counter() - t_all:.1f}s")
            return 0
        if train_only:
            t = time.perf_counter()
            tr = phase_train("cuda")
            log(train_line(tr, time.perf_counter() - t, dev["smi"]))
            log(f"train-only ok {time.perf_counter() - t_all:.1f}s")
            return 0
        if multi_only:
            t = time.perf_counter()
            mu = phase_multi("cuda")
            log(multi_line(mu, time.perf_counter() - t, dev["smi"]))
            log(f"multi-only ok {time.perf_counter() - t_all:.1f}s")
            return 0
        if tools_only:
            t = time.perf_counter()
            tl = phase_tools("cuda")
            log(tools_line(tl, time.perf_counter() - t, dev["smi"]))
            log(f"tools-only ok {time.perf_counter() - t_all:.1f}s")
            return 0
        if host_tools_only:
            t = time.perf_counter()
            ht = phase_host_tools("cuda")
            log(host_tools_line(ht, time.perf_counter() - t, dev["smi"]))
            log(f"host-tools-only ok {time.perf_counter() - t_all:.1f}s")
            return 0
        if features_only:  # its own georef assets, at the georef phase's size
            t = time.perf_counter()
            ft = phase_features("cuda")
            log(features_line(ft, time.perf_counter() - t, dev["smi"]))
            log(f"features-only ok {time.perf_counter() - t_all:.1f}s")
            return 0
        if lockstep_only:  # its own calibrated detector
            t = time.perf_counter()
            lk = phase_lockstep(None, "cuda")
            log(lockstep_line(lk, time.perf_counter() - t, dev["smi"]))
            print("\n".join(lockstep_profile_lines(lk["b_profile"])), flush=True)
            log(f"lockstep-only ok {time.perf_counter() - t_all:.1f}s")
            return 0

        t = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        fast.fast_score_map.launches = 0
        patches.patches32.launches = 0
        main_run = phase_main("cuda", width, height, n_main, chunk, seed=seed, horizon=horizon)
        main_launches = fast.fast_score_map.launches
        stats, checks = main_run["stats"], main_run["checks"]
        expected = stats["chunks"] + 1  # one per chunk + the reference frame
        if main_launches != expected or patches.patches32.launches != 0:
            raise AssertionError(f"FAST kernel launched {main_launches} times on the main path, "
                                 f"expected {expected}; patch gather "
                                 f"{patches.patches32.launches} times, expected 0")
        chunk_ms = [round(s * 1e3, 1) for s in stats["chunk_s"]]
        log(f"main ok {time.perf_counter() - t:.1f}s YOLOv8s imgsz 1920, 2x{chunk} frames "
            f"{width}x{height}: setup {main_run['setup_s']:.1f}s, ms/chunk {chunk_ms}, "
            f"whole run {stats['fps']:.2f} frames/s, {main_run['detections_frame0']} detections "
            f"on frame 0 (target {VEHICLES_PER_4K_FRAME}), {checks['rows_raw']} rows, "
            f"post-processed to {checks['rows']} rows of 14 columns "
            f"({checks['rows'] / n_main:.1f}/frame) / {checks['tracks']} tracks "
            f"({checks['tracks_with_dims']} with dimensions), metadata keys "
            f"{checks['metadata_keys']}, "
            f"matches >= {checks['min_matches']}, inliers >= {checks['min_inliers']}, "
            f"camera error {checks['camera_err_px']:.3f} px, fast launches {main_launches}, peak mem "
            f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB [{dev['smi']}]")

        t = time.perf_counter()
        kpath = phase_kernel_on_path(main_run["frames"][:chunk])
        log(f"kernel ok {time.perf_counter() - t:.1f}s fast_score exact on the main path's own "
            f"gray (the first chunk's, ({chunk},{height // 2},{width // 2})): {fast_line(kpath)} "
            f"[{dev['smi']}]")

        t = time.perf_counter()
        fast.fast_score_map.launches = 0
        steady = phase_steady(main_run["fx"], width, height, seed, horizon, n_main, chunk)
        if fast.fast_score_map.launches != STEADY_CHUNKS:
            raise AssertionError(f"FAST kernel launched {fast.fast_score_map.launches} times "
                                 f"over {STEADY_CHUNKS} steady chunks")
        log(f"steady ok {time.perf_counter() - t:.1f}s {STEADY_CHUNKS} more {chunk}-frame chunks: "
            f"ms/chunk {[round(m, 1) for m in steady['chunk_ms']]}, median "
            f"{steady['median_ms']:.1f} ms = {chunk / steady['median_ms'] * 1e3:.2f} frames/s "
            f"(min {steady['min_ms']:.1f}, max {steady['max_ms']:.1f}), camera error "
            f"{steady['camera_err_px']:.3f} px, {steady['rows']} rows [{dev['smi']}]")

        t = time.perf_counter()
        brk = breakdown(main_run["fx"], width, height, seed, horizon,
                        n_main + STEADY_CHUNKS * chunk, chunk)
        log(f"breakdown ok {time.perf_counter() - t:.1f}s one more {chunk}-frame chunk under the "
            f"profiler: wall {brk['wall_ms']:.1f} ms, device busy {brk['device_busy_ms']:.1f} ms "
            f"[{dev['smi']}]")
        for name, cpu_ms, dev_ms, span_ms in brk["stages"]:
            print(f"    stage {name:18s} host {cpu_ms:9.1f} ms  kernels {dev_ms:9.1f} ms  "
                  f"device span {span_ms:9.1f} ms", flush=True)
        for name, ms, count in brk["top"]:
            print(f"    kernel {ms:9.3f} ms  x{count:<6d} {name[:90]}", flush=True)

        t = time.perf_counter()
        rd = phase_reid(main_run["fx"].detector, main_run["frames"], steady["frames"],
                        main_run["reader"], "cuda", chunk=chunk, seed=seed)
        rchecks, remb = rd["checks"], rd["emb"]
        log(f"reid ok {time.perf_counter() - t:.1f}s botsort with_reid, YOLOv8s imgsz 1920, "
            f"2x{chunk} frames {width}x{height}: ms/chunk "
            f"{[round(s * 1e3, 1) for s in rd['stats']['chunk_s']]}, {rchecks['rows']} rows / "
            f"{rchecks['tracks']} tracks, camera error {rchecks['camera_err_px']:.3f} px, launches "
            f"{rd['launches']}, {remb['valid']} valid embeddings: norm err {remb['norm_err']:.2e}, "
            f"vs plain gather {remb['plain_err']:.2e}; on the first chunk's own inputs "
            f"embed_boxes {remb['embed_ms']:.3f} ms, {hwc_text(remb['gather'])}; "
            f"one more chunk {rd['timed_ms']:.1f} ms with "
            f"ReID against the steady median {steady['median_ms']:.1f} ms without (camera error "
            f"{rd['timed_camera_err_px']:.3f} px); the same {len(rd['turns']['reid'])} held chunks "
            f"in turns on fresh extractors: without ReID "
            f"{[round(m, 1) for m in rd['turns']['plain']]} ms, with "
            f"{[round(m, 1) for m in rd['turns']['reid']]} ms, median difference "
            f"{rd['turn_diff_ms']:.1f} ms; learned head chunk {rd['head_ms']:.1f} ms "
            f"(first, embed_boxes {rd['head_emb']['embed_ms']:.3f} ms, "
            f"{hwc_text(rd['head_emb']['gather'])}), "
            f"{rd['head_checks']['rows']} rows, norm err {rd['head_emb']['norm_err']:.2e}, vs "
            f"plain gather {rd['head_emb']['plain_err']:.2e}, max |head - projection| "
            f"{rd['head_vs_projection']:.3f}; the extract run's peak mem "
            f"{rd['peak_gib']:.2f} GiB [{dev['smi']}]")

        t = time.perf_counter()
        cli = phase_cli(main_run["fx"].detector, main_run["frames"], main_run["reader"], "cuda",
                        chunk=chunk, turn_frames=main_run["frames"] + steady["frames"])
        print("decode: " + (f"native decoder built; {cli['decode_fps']:.1f} frames/s decoding "
                            f"the {n_main}-frame {width}x{height} .y4m alone" if cli["probe"]["ok"]
                            else f"unavailable ({cli['probe']['found']}); run_extraction read "
                                 f"the frames in memory (open_reader replaced)"), flush=True)
        cst, turns = cli["checks"], cli["turns"]["ms"]
        log(f"cli ok {time.perf_counter() - t:.1f}s checkpoint .npz and .pt loaded, frame 0 "
            f"detections equal ({cli['detections']}; .pt vs .npz max diff {cli['pt_vs_npz']:.2e}); "
            f"run_extraction -m ckpt.npz -c default on {n_main} frames {width}x{height}: "
            f"{cli['run_s']:.1f}s, ms/chunk {[round(x * 1e3, 1) for x in cli['stats']['chunk_s']]}, "
            f"{cst['rows']} rows, camera error {cst['camera_err_px']:.3f} px, fast launches "
            f"{cli['launches']}"
            + (f"; subprocess extract of the .y4m {cli['subprocess_s']:.1f}s, "
               f"{cli['subprocess_checks']['rows']} rows" if cli["probe"]["ok"] else "")
            + f"; ms/chunk over {len(main_run['frames']) + len(steady['frames'])} frames in turns: "
              f"double-buffered {[round(x, 1) for x in turns['pipelined']]}, serial "
              f"{[round(x, 1) for x in turns['serial']]} (rows equal) [{dev['smi']}]")

        t = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        opts = phase_options(main_run["fx"].detector, main_run["frames"], main_run["reader"],
                             "cuda", chunk=chunk)
        log(f"options ok {time.perf_counter() - t:.1f}s fresh extractor per option, 2x{chunk} "
            f"frames {width}x{height}: " + "; ".join(
                f"{k}: ms {[round(m, 1) for m in v['ms']]}, fast launches {v['launches']}"
                + (f", camera error {v['camera_err_px']:.3f} px" if "camera_err_px" in v else "")
                + (f", GMC error {v['gmc_err_px']:.3f} px" if "gmc_err_px" in v else "")
                for k, v in opts.items())
            + f"; peak mem {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB [{dev['smi']}]")

        t = time.perf_counter()
        sq = phase_sequential("cuda")
        log(sequential_line(sq, time.perf_counter() - t, dev["smi"]))

        t = time.perf_counter()
        geo = phase_georef("cuda", keep=True)
        log(georef_line(geo, time.perf_counter() - t, dev["smi"]))
        print("\n".join(breakdown_lines(geo["ortho_breakdown"])), flush=True)

        t = time.perf_counter()
        ft = phase_features("cuda", geo.pop("kept"))
        log(features_line(ft, time.perf_counter() - t, dev["smi"]))

        t = time.perf_counter()
        ref = phase_reference("cuda")
        log(f"reference ok {time.perf_counter() - t:.1f}s cuda vs cpu on 320x240 oracle clip, ids "
            f"equal: " + "; ".join(f"{k} {v['rows']} rows/{v['tracks']} tracks box err "
                                    f"{v['box_err']:.2e} px H err {v['h_err']:.2e}"
                                    for k, v in ref.items()))

        t = time.perf_counter()
        lk = phase_lockstep(main_run["fx"].detector, "cuda")
        log(lockstep_line(lk, time.perf_counter() - t, dev["smi"]))
        print("\n".join(lockstep_profile_lines(lk["b_profile"])), flush=True)

        t = time.perf_counter()
        reset_launches()
        rn = phase_render("cuda")
        render_launches = launches()
        log(render_line(rn, time.perf_counter() - t, dev["smi"])
            + f", launches {render_launches}")

        t = time.perf_counter()
        tr = phase_train("cuda")
        log(train_line(tr, time.perf_counter() - t, dev["smi"]))

        t = time.perf_counter()
        mu = phase_multi("cuda")
        log(multi_line(mu, time.perf_counter() - t, dev["smi"]))

        t = time.perf_counter()
        tl = phase_tools("cuda")
        log(tools_line(tl, time.perf_counter() - t, dev["smi"]))

        t = time.perf_counter()
        ht = phase_host_tools("cuda")
        log(host_tools_line(ht, time.perf_counter() - t, dev["smi"]))

    except Exception as exc:  # noqa: BLE001 — every phase failure ends the run
        import traceback

        traceback.print_exc()
        log(f"FAILED after {time.perf_counter() - t_all:.1f}s: {type(exc).__name__}: {exc}")
        return 1

    log(f"all phases ok {time.perf_counter() - t_all:.1f}s")
    lk_k = lk["kernels"]
    kernels = {"kernels": [
        kernel_entry("fast_score", FAST_SOURCE, FAST_REPLACES, main_launches, kern,
                     sq["c_launches"]["fast_score"], lk["b"]["launches"]["fast_score"],
                     {"shape": lk_k["gray_shape"], "ms": lk_k["fast"]["ms"],
                      "bound_ms": lk_k["fast_bound_ms"]}, render_launches["fast_score"],
                     tr["launches"]["fast_score"], ft["a"]["launches"]["fast_score"],
                     launches_tools=tl["b"]["launches"]["fast_score"]),
        # the ReID path launches the HWC entry: its numbers on the chunk's own
        # inputs lead; the float gather's (describe's) shapes follow
        kernel_entry("patch_gather", PATCH_SOURCE, PATCH_REPLACES,
                     rd["launches"]["patch_gather"],
                     {**remb["gather"], "max_abs_err": max(pg["max_abs_err"],
                                                           remb["gather"]["max_abs_err"])},
                     sq["c_launches"]["patch_gather"],
                     lk["b"]["launches"]["patch_gather"],
                     {"shape": lk_k["gather"]["shape"] + (lk_k["gather"]["corners"],),
                      "ms": lk_k["gather"]["ms"], "bound_ms": lk_k["gather"]["bound_ms"]},
                     render_launches["patch_gather"], tr["launches"]["patch_gather"],
                     ft["a"]["launches"]["patch_gather"],
                     launches_tools=tl["b"]["launches"]["patch_gather"],
                     shapes=[{k: r.get(k) for k in GATHER_KEYS} for r in pg["shapes"]],
                     hwc={name: {k: g.get(k) for k in HWC_KEYS}
                          for name, g in (("reid", remb["gather"]),
                                          ("reid_head", rd["head_emb"]["gather"]),
                                          ("sequential", sq["kernels"]["gather"]),
                                          ("lockstep", lk_k["gather"]))}),
    ], "multi": multi_entry(mu)}
    print(json.dumps(kernels), flush=True)
    print(dev["smi"], flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                             "count": dev["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
