"""Reprojection-error benchmark of the ortho registration: the port of
``tools/benchmark_ortho_matching.py``.

Registers a source frame against variants of the orthophoto with the port's
``utils/registration.py:estimate_homography`` on ``--device`` (the card
unless ``--device cpu``) and prints inliers, matches and the corner error
per case (``--latex`` for a LaTeX table). Without real assets it measures
itself against known homographies:

- ``--synthetic``: random small warps of the frame itself;
- ``--synthetic-cross-domain``: scale 1.5-2.5x, rotation, gamma, contrast
  and noise, with each of ``--detectors`` (default rsift and orb);
- ``--synthetic-ortho SIZE``: a SIZExSIZE synthetic orthophoto, a 4K view
  of it through a known homography with a photometric shift, registered
  frame -> ortho at ``--max-features`` (the reference regime: a 15000 px
  cutout and 250k features), ``--trials`` times; with ``--detectors`` each
  named family in turn (default rsift alone, as the reference runs it).
  Each trial prints its seconds and, on a CUDA device, the peak device
  memory of the registration (``torch.cuda.max_memory_allocated``).

The warps go through the port's ``ops/warp.py:warp_perspective``. The
reference renders the ``--synthetic-ortho`` and ``--synthetic-cross-domain``
views with ``cv2.warpPerspective``, whose bilinear weights are 5-bit fixed
point; the port's are float32, so those views differ from the reference's
by a grey level here and there and the corner errors agree within a
tolerance, not bit for bit. ``--synthetic`` uses the JAX package's warp in
the reference, which the port's equals.

Usage:
  python -m geotrax_tpu_torch.tools.benchmark_ortho_matching FRAME.png ORTHO.png \\
      --widths 2000 4000 8000 [--latex]
  python -m geotrax_tpu_torch.tools.benchmark_ortho_matching FRAME.png --synthetic
"""

from __future__ import annotations

import argparse
import logging
import time
from pathlib import Path

import numpy as np
import torch

from geotrax_tpu_torch.ops.warp import invert_homography, warp_perspective
from geotrax_tpu_torch.utils.registration import estimate_homography


def corner_error(h_est, h_true, w, h):
    corners = np.array([[0, 0, 1], [w, 0, 1], [w, h, 1], [0, h, 1]], float)

    def apply(m):
        out = corners @ m.T
        return out[:, :2] / out[:, 2:3]

    return float(np.linalg.norm(apply(h_est) - apply(h_true), axis=1).max())


def synthetic_ortho_image(size: int, rng) -> np.ndarray:
    """The reference's synthetic orthophoto with its draws in its order:
    8 px blocks of random colour, a road grid and 4000 vehicle-scale
    rectangles (the blocks repeated in uint8, the values the reference's
    ``np.kron`` gives)."""
    blocks = rng.integers(30, 220, (size // 8, size // 8, 3)).astype(np.uint8)
    ortho = np.repeat(np.repeat(blocks, 8, axis=0), 8, axis=1)
    for k in range(0, size, size // 24):  # road grid
        ortho[k:k + 12, :] = 72
        ortho[:, k:k + 12] = 72
    for _ in range(4000):  # vehicle-scale rectangles
        y, x = rng.integers(0, size - 40, 2)
        ortho[y:y + rng.integers(12, 36), x:x + rng.integers(12, 36)] = rng.integers(0, 255, 3)
    return ortho


def warp(image, h_inv, out_h: int, out_w: int, device) -> np.ndarray:
    """``image`` sampled at ``h_inv @ p`` for every output pixel ``p``
    (bilinear, black border), on ``device``, back as numpy."""
    src = torch.as_tensor(np.ascontiguousarray(image)).to(device)
    return warp_perspective(src, np.asarray(h_inv, np.float32), out_h, out_w).cpu().numpy()


def memory_text(device: torch.device) -> str:
    if device.type != "cuda":
        return ""
    return f"  peak_mem={torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB"


def synthetic_ortho_rows(args, logger, device, frame_size=(3840, 2160)) -> list:
    """``--synthetic-ortho``: one row per trial and detector, with
    ``wall_s`` and ``peak_gib`` (None off CUDA). ``frame_size`` (width,
    height) is the tool's 4K view; a smaller one serves rehearsals on the
    CPU."""
    rows = []
    size = args.synthetic_ortho
    rng = np.random.default_rng(7)
    ortho = synthetic_ortho_image(size, rng)
    fw, fh = frame_size
    for trial in range(args.trials):
        # the frame covers a central ground patch: frame -> ortho scale in the
        # reference regime (a 15000 px cutout over a ~4K frame's footprint)
        scale = rng.uniform(0.82, 0.95) * size / fw
        ang = rng.uniform(-np.pi / 12, np.pi / 12)
        c_, s_ = np.cos(ang) * scale, np.sin(ang) * scale
        cx, cy = fw / 2, fh / 2
        tx = size / 2 - (c_ * cx - s_ * cy) + rng.uniform(-80, 80)
        ty = size / 2 - (s_ * cx + c_ * cy) + rng.uniform(-80, 80)
        h_true = np.array([[c_, -s_, tx], [s_, c_, ty], [0, 0, 1.0]])
        # cv2.warpPerspective(ortho, h_true, WARP_INVERSE_MAP): h_true maps
        # frame pixels to the ortho pixels they sample
        frame = warp(ortho, h_true, fh, fw, device).astype(np.float32)
        gamma = rng.uniform(1.3, 1.6)
        frame = 255.0 * (np.clip(frame, 0, 255) / 255.0) ** gamma
        frame = np.clip(frame * 0.85 + 15 + rng.normal(0, 5, frame.shape), 0, 255)
        frame = frame.astype(np.uint8)
        for det in args.detectors or ["rsift"]:
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            h_est, inliers, matches, _ = estimate_homography(
                frame, ortho, logger, detector_name=det, max_features=args.max_features,
                device=device)
            wall = time.perf_counter() - t0
            err = corner_error(h_est, h_true, fw, fh) if h_est is not None else float("inf")
            name = f"t{trial}:{size}px" + (f":{det}" if args.detectors else "")
            peak = (torch.cuda.max_memory_allocated(device) / 2**30
                    if device.type == "cuda" else None)
            rows.append({"name": name, "inliers": inliers, "matches": matches, "err": err,
                         "wall_s": wall, "peak_gib": peak, "detector": det})
            print(f"t{trial}: {size}px/{args.max_features} feats"
                  + (f" {det}" if args.detectors else "")
                  + f"  wall={wall:.1f}s{memory_text(device)}", flush=True)
    return rows


def cross_domain_rows(args, logger, device) -> list:
    from geotrax_tpu_torch.train.data import load_image

    frame = load_image(args.frame)
    rng = np.random.default_rng(0)
    h_img, w_img = frame.shape[:2]
    rows = []
    for trial in range(4):
        scale = rng.uniform(1.5, 2.5)
        ang = rng.uniform(-np.pi / 6, np.pi / 6)
        s_, c_ = np.sin(ang) / scale, np.cos(ang) / scale
        h_true = np.array([[c_, -s_, rng.uniform(-30, 30)], [s_, c_, rng.uniform(-30, 30)],
                           [0.0, 0.0, 1.0]])
        # cv2.warpPerspective(frame, inv(h_true)): output p samples h_true @ p
        src = warp(frame, h_true, h_img, w_img, device).astype(np.float32)
        gamma = rng.uniform(1.3, 1.8)
        src = 255.0 * (np.clip(src, 0, 255) / 255.0) ** gamma
        src = np.clip(src * 0.8 + 20 + rng.normal(0, 6, src.shape), 0, 255)
        src = src.astype(np.uint8)
        for det in args.detectors or ["rsift", "orb"]:
            h_est, inliers, matches, _ = estimate_homography(
                src, frame, logger, detector_name=det, max_features=args.max_features,
                filter_ratio=0.75 if det in ("sift", "rsift") else 0.8, device=device)
            err = (corner_error(h_est, h_true, w_img, h_img)
                   if h_est is not None else float("inf"))
            rows.append({"name": f"t{trial}:{det}", "inliers": inliers, "matches": matches,
                         "err": err})
    return rows


def synthetic_rows(args, logger, device) -> list:
    from geotrax_tpu_torch.train.data import load_image

    frame = load_image(args.frame)
    rng = np.random.default_rng(0)
    rows = []
    for trial in range(len(args.widths)):
        h_true = np.eye(3)
        ang = rng.uniform(-0.08, 0.08)
        c, s = np.cos(ang), np.sin(ang)
        h_true[:2, :2] = np.array([[c, -s], [s, c]]) * rng.uniform(0.9, 1.1)
        h_true[:2, 2] = rng.uniform(-20, 20, 2)
        warped = warp(frame, invert_homography(h_true), frame.shape[0], frame.shape[1], device)
        h_est, inliers, matches, _ = estimate_homography(
            frame, warped, logger, max_features=args.max_features, device=device)
        err = (corner_error(h_est, h_true, frame.shape[1], frame.shape[0])
               if h_est is not None else float("inf"))
        rows.append({"name": f"trial{trial}", "inliers": inliers, "matches": matches, "err": err})
    return rows


def widths_rows(args, logger, device) -> list:
    """Real assets: the ortho resized to each width (Pillow's bicubic,
    ``train/resample.py``); the corner error is not known (NaN)."""
    from geotrax_tpu_torch.train.data import load_image
    from geotrax_tpu_torch.train.resample import resize_bicubic

    frame = load_image(args.frame)
    ortho_full = load_image(args.ortho)
    full_h, full_w = ortho_full.shape[:2]
    rows = []
    for width in args.widths:
        scale = width / full_w
        ortho = resize_bicubic(ortho_full, width, int(full_h * scale))
        h_est, inliers, matches, _ = estimate_homography(
            frame, ortho, logger, max_features=args.max_features, device=device)
        rows.append({"name": str(width), "inliers": inliers, "matches": matches,
                     "err": float("nan")})
    return rows


def parse_cli_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Reprojection-error benchmark of the ortho registration vs resolution.")
    parser.add_argument("frame", type=Path, nargs="?")
    parser.add_argument("ortho", type=Path, nargs="?")
    parser.add_argument("--widths", type=int, nargs="+",
                        default=[2000, 4000, 6000, 8000, 10000, 15000])
    parser.add_argument("--max-features", type=int, default=250000)
    parser.add_argument("--synthetic", action="store_true",
                        help="Benchmark against known random warps of the frame itself")
    parser.add_argument("--synthetic-cross-domain", action="store_true",
                        help="Known H with scale 1.5-2.5x, rotation, gamma/illumination "
                             "shift and noise, the regime where RootSIFT is required "
                             "and binary descriptors fail")
    parser.add_argument("--synthetic-ortho", type=int, metavar="SIZE", default=0,
                        help="Reference-scale self-benchmark: generate a SIZExSIZE "
                             "synthetic orthophoto (FRAME arg is ignored), render a 4K "
                             "master-frame view of it through a known homography with a "
                             "cross-domain photometric shift, and register frame->ortho "
                             "at --max-features budget (the reference regime: 15000 px "
                             "cutout / 250k features)")
    parser.add_argument("--trials", type=int, default=2,
                        help="Number of random warps in --synthetic-ortho mode")
    parser.add_argument("--detectors", nargs="+", default=None,
                        help="Detector families to compare (cross-domain mode: default rsift "
                             "and orb; --synthetic-ortho: default rsift alone)")
    parser.add_argument("--latex", action="store_true")
    parser.add_argument("--device", type=str, default="cuda",
                        help="Torch device of the registration (default cuda; 'cpu' runs the "
                             "plain PyTorch path)")
    args = parser.parse_args(argv)
    if not args.synthetic_ortho and args.frame is None:
        parser.error("FRAME image required unless --synthetic-ortho")
    if not (args.synthetic_ortho or args.synthetic_cross_domain or args.synthetic) \
            and args.ortho is None:
        parser.error("ORTHO image required unless --synthetic")
    return args


def run(args, logger=None) -> list:
    """The benchmark's rows (dicts with name, inliers, matches, err)."""
    from geotrax_tpu_torch._device import resolve_device

    logger = logger or logging.getLogger("bench_ortho")
    device = resolve_device(args.device)
    if args.synthetic_ortho:
        return synthetic_ortho_rows(args, logger, device)
    if args.synthetic_cross_domain:
        return cross_domain_rows(args, logger, device)
    if args.synthetic:
        return synthetic_rows(args, logger, device)
    return widths_rows(args, logger, device)


def print_rows(rows: list, latex: bool) -> None:
    if latex:
        print("resolution & inliers & matches & corner error [px] \\\\")
        for r in rows:
            print(f"{r['name']} & {r['inliers']} & {r['matches']} & {r['err']:.2f} \\\\")
    else:
        print(f"{'case':<10}{'inliers':>8}{'matches':>9}{'corner err px':>15}")
        for r in rows:
            print(f"{r['name']:<10}{r['inliers']:>8}{r['matches']:>9}{r['err']:>15.2f}")


def main(argv=None) -> int:
    args = parse_cli_args(argv)
    print_rows(run(args), args.latex)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
