"""RootSIFT scale-space features and L2 descriptor matching.

The port of ``geotrax_tpu/ops/sift.py``, the features georeferencing
registers with (the reference configuration's ``rsift`` at a 250k budget):

- scale space: pyramid levels resized with ``jax.image.resize``'s
  antialiased linear kernel, a difference of Gaussians, an edge test on its
  Hessian, 3x3 non-max suppression and an exact top-k per level, the
  budget split over the levels as ``1/s``;
- orientation: 8 linearly interpolated gradient-direction planes blurred
  at the keypoint scale, the histogram's peak refined by a parabola;
- descriptor: the planes tent-smoothed per cell, sampled bilinearly on a
  rotated 4x4 grid, the bins shifted into the keypoint's frame, then
  L2-normalized, clipped at 0.2, renormalized and mapped to RootSIFT;
- levels above ``BAND_PIXEL_LIMIT`` pixels run in horizontal bands with a
  halo, each band oversampled 2x and the level cut to its budget by score;
- matching: blockwise squared L2 distances with a ratio test and a mutual
  check, so a 250k x 250k match streams through (block, Kb) tiles.

Every step adds and multiplies in the reference's order, so that scores tie
and descriptors round as they do there. The orientation planes are kept
channel-first, (8, H, W), so that each blur is a batched tap sum.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from geotrax_tpu_torch.ops.features import (
    Matches,
    _gaussian_blur,
    _tap_sum,
    linear_resize_weights,
)
from geotrax_tpu_torch.ops.topk import exact_top_k

N_BINS = 8
N_CELLS = 4          # 4x4 spatial cells
DESC_DIM = N_BINS * N_CELLS * N_CELLS  # 128

# Levels above this pixel count run in horizontal bands (the reference's
# bound on the orientation planes' working set).
BAND_PIXEL_LIMIT = 32_000_000
BAND_OVERLAP = 32  # blur/descriptor halo (DoG r8 + orientation r7 + grid 7)
# The reference caps a level's (and a band's) selection at TOPK_CAP when
# its score map holds more than TOPK_CAP_MIN_INPUT pixels, on every backend.
# The cap is part of the result: at the 15000^2 / 250k regime it leaves
# level 3 with 24k of its ~27.6k share, so an uncapped selection would
# return other features than the reference.
TOPK_CAP = 24_000
TOPK_CAP_MIN_INPUT = 16_000_000


class SiftFeatures(NamedTuple):
    xy: torch.Tensor      # (K, 2) level-0 pixel coords
    score: torch.Tensor   # (K,)
    angle: torch.Tensor   # (K,) radians
    valid: torch.Tensor   # (K,)
    desc: torch.Tensor    # (K, 128) RootSIFT


def _remainder(x: torch.Tensor, m: float) -> torch.Tensor:
    """``jnp.remainder`` for floats: the truncated remainder, moved into the
    divisor's sign (m > 0 here)."""
    r = torch.fmod(x, m)
    return torch.where((r != 0) & (r < 0), r + m, r)


def _triangle_taps(radius: int) -> tuple:
    taps = np.arange(-radius, radius + 1)
    k = (1.0 - np.abs(taps) / (radius + 1)).astype(np.float32)
    return tuple(float(v) for v in k / k.sum())


def _triangle_blur(img: torch.Tensor, radius: int) -> torch.Tensor:
    """Separable tent filter (SIFT's trilinear spatial weighting) over the
    last two axes: triangle taps of half-width ``radius``, zero borders."""
    return _tap_sum(img, _triangle_taps(int(radius)))


def _orientation_planes(level_img: torch.Tensor) -> tuple:
    """Gradient magnitude and orientation of (H, W) -> ((8, H, W) linearly
    interpolated orientation-bin planes, magnitude): each pixel puts
    m*(1-f) into its bin and m*f into the next. Built one bin at a time from
    an int32 bin map, with no (H, W, 8) index tensor."""
    gx = 0.5 * (torch.roll(level_img, -1, dims=1) - torch.roll(level_img, 1, dims=1))
    gy = 0.5 * (torch.roll(level_img, -1, dims=0) - torch.roll(level_img, 1, dims=0))
    mag = torch.sqrt(gx * gx + gy * gy)
    theta = torch.atan2(gy, gx)  # (-pi, pi]
    b = _remainder(theta / (2 * math.pi) * N_BINS, N_BINS)
    b0f = torch.floor(b)
    frac = b - b0f
    b0 = torch.remainder(b0f.to(torch.int32), N_BINS)
    b1 = torch.remainder(b0 + 1, N_BINS)
    w0 = mag * (1 - frac)
    w1 = mag * frac
    del gx, gy, theta, b, b0f, frac
    planes = torch.empty((N_BINS,) + level_img.shape, dtype=torch.float32,
                         device=level_img.device)
    for c in range(N_BINS):
        planes[c] = torch.where(b0 == c, w0, 0.0)
        planes[c] += torch.where(b1 == c, w1, 0.0)
    return planes, mag


def _bilinear_planes(planes: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """planes (H, W, B) (any strides); x, y (...) float -> (..., B) bilinear
    samples with clamped borders."""
    h, w = planes.shape[:2]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = torch.clamp(x0.to(torch.int64), 0, w - 1)
    x1i = torch.clamp(x0i + 1, 0, w - 1)
    y0i = torch.clamp(y0.to(torch.int64), 0, h - 1)
    y1i = torch.clamp(y0i + 1, 0, h - 1)
    v00 = planes[y0i, x0i]
    v01 = planes[y0i, x1i]
    v10 = planes[y1i, x0i]
    v11 = planes[y1i, x1i]
    return (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy + v11 * fx * fy)


def _circular_shift_bins(vals: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """vals (..., B) circularly resampled by a fractional bin ``shift``
    (broadcast over leading dims): rotation invariance of the histogram."""
    base = torch.arange(N_BINS, dtype=torch.float32, device=vals.device)
    pos = _remainder(base + shift[..., None], N_BINS)
    p0f = torch.floor(pos)
    frac = pos - p0f
    p0 = torch.remainder(p0f.to(torch.int64), N_BINS)
    p1 = torch.remainder(p0 + 1, N_BINS)
    p0, p1 = (torch.broadcast_to(p, vals.shape) for p in (p0, p1))
    v0 = torch.gather(vals, -1, p0)
    v1 = torch.gather(vals, -1, p1)
    return v0 * (1 - frac) + v1 * frac


def _grid() -> np.ndarray:
    centers = (np.arange(N_CELLS) - (N_CELLS - 1) / 2.0)  # cell units: -1.5 .. 1.5
    gy_, gx_ = np.meshgrid(centers, centers, indexing="ij")
    return np.stack([gx_.ravel(), gy_.ravel()], -1)  # (16, 2)


def _level_features(level_img: torch.Tensor, budget: int, cell: int = 4,
                    dog_sigma: float = 1.6, edge_thresh: float = 12.0,
                    row_bounds=None, mask: torch.Tensor | None = None) -> tuple:
    """Detect and describe on one pyramid level (H, W) float32.

    Returns (xy (K, 2) in this level's pixels, score, angle, valid,
    desc (K, 128)). ``row_bounds`` (lo, hi) keeps keypoints to a band's core
    rows; ``mask`` (True = usable) zeroes scores before the top-``budget``
    selection, so masked regions do not use up the budget."""
    h, w = level_img.shape
    dev = level_img.device
    g1 = _gaussian_blur(level_img, dog_sigma)
    dog = g1 - _gaussian_blur(level_img, dog_sigma * 1.6)

    # |DoG| where the DoG Hessian's curvature ratio passes the edge test
    dxx = torch.roll(dog, -1, 1) + torch.roll(dog, 1, 1) - 2 * dog
    dyy = torch.roll(dog, -1, 0) + torch.roll(dog, 1, 0) - 2 * dog
    dxy = 0.25 * (torch.roll(dog, (-1, -1), (0, 1)) + torch.roll(dog, (1, 1), (0, 1))
                  - torch.roll(dog, (-1, 1), (0, 1)) - torch.roll(dog, (1, -1), (0, 1)))
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    del dxx, dyy, dxy
    edge_ok = (det > 0) & (tr * tr / torch.clamp_min(det, 1e-12)
                           < (edge_thresh + 1) ** 2 / edge_thresh)
    score = torch.where(edge_ok, torch.abs(dog), 0.0)
    del dog, tr, det, edge_ok

    border = 4 * cell  # the descriptor's support stays inside the image
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    inside = (ys >= border) & (ys < h - border) & (xs >= border) & (xs < w - border)
    if row_bounds is not None:
        lo, hi = row_bounds
        inside = inside & (ys >= lo) & (ys < hi)
    if mask is not None:
        inside = inside & mask
    score = torch.where(inside, score, 0.0)
    del inside
    neighborhood = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    score = torch.where(score >= neighborhood, score, 0.0)
    del neighborhood

    k_eff = min(budget, TOPK_CAP) if score.numel() > TOPK_CAP_MIN_INPUT else budget
    top, flat = exact_top_k(score.reshape(-1), k_eff)
    del score
    kx = (flat % w).to(torch.float32)
    ky = torch.div(flat, w, rounding_mode="floor").to(torch.float32)
    valid = top > 1e-6

    planes, _ = _orientation_planes(g1)
    del g1

    # orientation: bins of the scale-smoothed planes at the keypoint
    hist = _bilinear_planes(_gaussian_blur(planes, 1.5 * dog_sigma).permute(1, 2, 0), kx, ky)
    peak = torch.argmax(hist, dim=-1, keepdim=True)
    left = torch.gather(hist, 1, torch.remainder(peak - 1, N_BINS))[:, 0]
    right = torch.gather(hist, 1, torch.remainder(peak + 1, N_BINS))[:, 0]
    center = torch.gather(hist, 1, peak)[:, 0]
    denom = left - 2 * center + right
    offset = torch.where(torch.abs(denom) > 1e-9, 0.5 * (left - right) / denom, 0.0)
    angle = (peak[:, 0] + offset) * (2 * math.pi / N_BINS)

    # descriptor: tent-smoothed planes sampled on a rotated 4x4 cell grid,
    # bins rotated into the keypoint's frame
    cell_planes = _triangle_blur(planes, cell).permute(1, 2, 0)
    del planes
    grid = torch.as_tensor(_grid() * cell, dtype=torch.float32, device=dev)
    cos_a = torch.cos(angle)
    sin_a = torch.sin(angle)
    gx_r = cos_a[:, None] * grid[None, :, 0] - sin_a[:, None] * grid[None, :, 1]
    gy_r = sin_a[:, None] * grid[None, :, 0] + cos_a[:, None] * grid[None, :, 1]
    cell_vals = _bilinear_planes(cell_planes, kx[:, None] + gx_r, ky[:, None] + gy_r)  # (K,16,8)
    shift = angle / (2 * math.pi / N_BINS)
    cell_vals = _circular_shift_bins(cell_vals, shift[:, None])

    desc = cell_vals.reshape(-1, DESC_DIM)
    desc = desc / torch.clamp_min(torch.linalg.vector_norm(desc, dim=-1, keepdim=True), 1e-12)
    desc = torch.clamp(desc, 0.0, 0.2)
    desc = desc / torch.clamp_min(torch.linalg.vector_norm(desc, dim=-1, keepdim=True), 1e-12)
    # RootSIFT: L1 normalize, then sqrt
    desc = torch.sqrt(desc / torch.clamp_min(desc.sum(-1, keepdim=True), 1e-8))
    return torch.stack([kx, ky], -1), top, angle, valid, desc


def band_layout(h: int, w: int) -> tuple:
    """(n_bands, band_h, [(start, (core_lo, core_hi)), ...]) of a level the
    banded path splits: equal cores, each band widened by ``BAND_OVERLAP``
    rows on both sides and kept inside the image."""
    n_bands = int(np.ceil(h * w / BAND_PIXEL_LIMIT))
    core = int(np.ceil(h / n_bands))
    band_h = min(core + 2 * BAND_OVERLAP, h)
    bands = []
    for i in range(n_bands):
        c0 = i * core
        c1 = min(c0 + core, h)
        s0 = min(max(c0 - BAND_OVERLAP, 0), h - band_h)
        bands.append((s0, (c0 - s0, c1 - s0)))
    return n_bands, band_h, bands


def _level_features_banded(level_img: torch.Tensor, budget: int,
                           mask: torch.Tensor | None = None) -> tuple:
    """``_level_features`` over horizontal bands, one band's working set at
    a time. Each band selects up to 2x its share of ``budget`` (capped at
    ``TOPK_CAP``) within its core rows; the bands' features are then cut to
    ``budget`` by score across the level, as the reference cuts them."""
    h, w = level_img.shape
    n_bands, band_h, bands = band_layout(h, w)
    band_budget = int(min(np.ceil(2 * budget / n_bands), TOPK_CAP))
    parts = []
    for s0, bounds in bands:
        mb = None if mask is None else mask[s0:s0 + band_h]
        xy, sc, an, va, de = _level_features(level_img[s0:s0 + band_h], band_budget,
                                             row_bounds=bounds, mask=mb)
        xy = xy + torch.tensor([0.0, float(s0)], device=xy.device)
        parts.append((xy, sc, an, va, de))
    xy, sc, an, va, de = (torch.cat(p) for p in zip(*parts))
    if sc.shape[0] > budget:
        top_sc, idx = exact_top_k(torch.where(va, sc, 0.0), budget)
        xy, sc, an, va, de = xy[idx], sc[idx], an[idx], va[idx] & (top_sc > 0), de[idx]
    return xy, sc, an, va, de


def resize_linear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(H, W) float32 resized as ``jax.image.resize(..., "linear")`` (the
    antialiased triangle kernel) by one dense weight product per axis, the
    reference's own form."""
    h, w = img.shape
    out = img
    if out_h != h:
        out = torch.matmul(linear_resize_weights(h, out_h, img.device).T, out)
    if out_w != w:
        out = torch.matmul(out, linear_resize_weights(w, out_w, img.device))
    return out


def nearest_indices(in_size: int, out_size: int) -> np.ndarray:
    """Source index of each output sample of ``jax.image.resize(...,
    "nearest")`` along one axis: floor((i + 0.5) * in / out) in float32."""
    if in_size == out_size:
        return np.arange(out_size)
    pos = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * np.float32(in_size)
    return np.floor(pos / np.float32(out_size)).astype(np.int64)


def resize_mask_nearest(mask: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(H, W) bool mask at (out_h, out_w), nearest neighbour as the
    reference resizes it."""
    h, w = mask.shape
    iy = torch.as_tensor(nearest_indices(h, out_h), device=mask.device)
    ix = torch.as_tensor(nearest_indices(w, out_w), device=mask.device)
    return mask[iy][:, ix]


def level_plan(h: int, w: int, max_features: int, n_octaves: int = 4,
               scales_per_octave: int = 2) -> list:
    """[(scale, level_h, level_w, budget), ...] of ``detect_and_describe``:
    levels whose smaller side is at least 64 (level 0 always), the budget
    split over them as 1/s (at least 16 each)."""
    n_levels = n_octaves * scales_per_octave
    r = 2.0 ** (1.0 / scales_per_octave)
    all_scales = [r ** i for i in range(n_levels)]
    level_scales = [
        s for i, s in enumerate(all_scales)
        if i == 0 or min(int(round(h / s)), int(round(w / s))) >= 64
    ]
    weights = np.array([1.0 / s for s in level_scales])
    budgets = np.maximum((max_features * weights / weights.sum()).astype(int), 16)
    return [(s, int(round(h / s)), int(round(w / s)), int(b))
            for s, b in zip(level_scales, budgets)]


def detect_and_describe(gray: torch.Tensor, max_features: int, n_octaves: int = 4,
                        scales_per_octave: int = 2,
                        mask: torch.Tensor | None = None) -> SiftFeatures:
    """Multi-octave RootSIFT features of (H, W) float32 ``gray`` with a total
    ``max_features`` budget (``level_plan``). Keypoints come back in level-0
    pixels: a level pixel i sits at (i + 0.5) * ratio - 0.5, per axis."""
    h, w = gray.shape
    parts = []
    for s, lh, lw, budget in level_plan(h, w, max_features, n_octaves, scales_per_octave):
        level = gray if s == 1.0 else resize_linear(gray, lh, lw)
        level_mask = None
        if mask is not None:
            level_mask = mask if s == 1.0 else resize_mask_nearest(mask, lh, lw)
        if lh * lw > BAND_PIXEL_LIMIT:
            xy, sc, an, va, de = _level_features_banded(level, budget, mask=level_mask)
        else:
            xy, sc, an, va, de = _level_features(level, budget, mask=level_mask)
        del level
        ratio = torch.tensor([w / lw, h / lh], dtype=xy.dtype, device=xy.device)
        parts.append(((xy + 0.5) * ratio - 0.5, sc, an, va, de))
    return SiftFeatures(*(torch.cat(p) for p in zip(*parts)))


def match_l2(desc_a: torch.Tensor, valid_a: torch.Tensor, desc_b: torch.Tensor,
             valid_b: torch.Tensor, ratio: float = 0.55, block: int = 4096) -> Matches:
    """L2 matching with Lowe ratio + mutual cross-check.

    ``desc_a`` (..., Ka, T) against ``desc_b`` (..., Kb, T) (leading axes
    broadcast). Distances are squared: sqrt is monotonic, so the argmins, the
    mutual check and the ratio test (against ratio² · second²) decide as on
    distances. Invalid rows and columns get +1e9 on their squared norms, so
    every one of their distances passes the sentinel. A rows are processed
    ``block`` at a time to bound the (block, Kb) distance tile; ties in the
    column minimum go to the earlier row, as in the reference's running best.
    The product is plain float32 (``torch.matmul``; the port turns TF32
    off on the card)."""
    ka = desc_a.shape[-2]
    big = 1e9
    nb2 = torch.sum(desc_b * desc_b, dim=-1) + torch.where(valid_b, 0.0, big)
    na2_all = torch.sum(desc_a * desc_a, dim=-1) + torch.where(valid_a, 0.0, big)
    lead = torch.broadcast_shapes(desc_a.shape[:-2], desc_b.shape[:-2])
    kb = desc_b.shape[-2]
    dev = desc_a.device

    best_parts, second_parts, idx_parts = [], [], []
    b_best = torch.full(lead + (kb,), big, device=dev)
    b_row = torch.full(lead + (kb,), -1, dtype=torch.int64, device=dev)
    cols = torch.arange(kb, device=dev)
    for start in range(0, ka, block):
        a = desc_a[..., start:start + block, :]
        na2 = na2_all[..., start:start + block]
        dots = torch.matmul(a, desc_b.transpose(-1, -2))
        d2 = torch.clamp_min(na2[..., :, None] + nb2[..., None, :] - 2.0 * dots, 0.0)
        del dots

        best = d2.amin(dim=-1)
        best_idx = torch.argmin(d2, dim=-1)
        second = torch.where(cols == best_idx[..., None], big, d2).amin(dim=-1)

        col_best = d2.amin(dim=-2)
        col_row = torch.argmin(d2, dim=-2) + start
        del d2
        better = col_best < b_best
        b_best = torch.where(better, col_best, b_best)
        b_row = torch.where(better, col_row, b_row)
        best_parts.append(best)
        second_parts.append(second)
        idx_parts.append(best_idx)

    best = torch.cat(best_parts, dim=-1)
    second = torch.cat(second_parts, dim=-1)
    best_idx = torch.cat(idx_parts, dim=-1)
    rows = torch.arange(ka, device=dev)
    ratio_ok = best < (ratio * ratio) * second
    mutual = torch.gather(b_row, -1, best_idx) == rows
    valid = valid_a & ratio_ok & mutual & (best < big / 2)
    return Matches(idx_a=rows.expand(best_idx.shape), idx_b=best_idx, valid=valid)
