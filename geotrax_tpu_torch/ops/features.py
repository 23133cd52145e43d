"""Keypoint detection and grid descriptors for the stabilization path.

Counterpart of the parts of ``geotrax_tpu/ops/features.py`` that the fused
extract chunk runs: gray conversion, the 0.5x downsample, the vehicle-box
mask, unoriented FAST detection (score map from ``ops/fast.py``, 3x3
non-max suppression, exact top-k) and the 64-D grid descriptor with its bf16
blur planes. Every function takes one image or a batch (leading axis), so
the chunk step handles all of its frames in one call.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from geotrax_tpu_torch.ops.fast import fast_score_map
from geotrax_tpu_torch.ops.topk import approx_top_k


class Keypoints(NamedTuple):
    xy: torch.Tensor      # (..., K, 2) float, x then y
    score: torch.Tensor   # (..., K)
    angle: torch.Tensor   # (..., K) radians (0: the port detects unoriented)
    valid: torch.Tensor   # (..., K) bool


class Matches(NamedTuple):
    idx_a: torch.Tensor   # (..., M) indices into A's keypoints
    idx_b: torch.Tensor   # (..., M)
    valid: torch.Tensor   # (..., M) bool


def rgb_to_gray(image: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) uint8/float RGB -> (..., H, W) float32 luma (BT.601)."""
    img = image.to(torch.float32)
    return img[..., 0] * 0.299 + img[..., 1] * 0.587 + img[..., 2] * 0.114


def linear_resize_weights(in_size: int, out_size: int, device) -> torch.Tensor:
    """(in, out) float32 weights of ``jax.image.resize(method="linear")``
    along one axis, made on ``device``: a triangle kernel widened by the
    downscale factor (antialiasing), normalized per output sample."""
    scale = np.float32(out_size) / np.float32(in_size)
    inv_scale = np.float32(1.0) / scale
    kernel_scale = float(max(inv_scale, np.float32(1.0)))
    sample_f = ((torch.arange(out_size, dtype=torch.float32, device=device) + 0.5)
                * float(inv_scale) - 0.5)
    src = torch.arange(in_size, dtype=torch.float32, device=device)
    weights = torch.clamp_min(1.0 - torch.abs(sample_f[None, :] - src[:, None]) / kernel_scale,
                              0.0)
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(torch.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                          weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], weights, 0.0)


def downsample(gray: torch.Tensor, ratio: float) -> torch.Tensor:
    """(..., H, W) gray at ``ratio``. At 0.5 with even dims this is the 2x2
    box mean (== cv2 INTER_LINEAR 0.5x); other ratios use the triangle
    kernel of ``jax.image.resize(method="linear")``, whose numerics differ
    slightly (the two paths are not interchangeable per video)."""
    if ratio >= 1.0:
        return gray
    h, w = gray.shape[-2], gray.shape[-1]
    if ratio == 0.5 and h % 2 == 0 and w % 2 == 0:
        s = gray[..., 0::2, 0::2] + gray[..., 0::2, 1::2]
        s = s + gray[..., 1::2, 0::2]
        s = s + gray[..., 1::2, 1::2]
        return s * 0.25
    new_h, new_w = int(h * ratio), int(w * ratio)
    wy = linear_resize_weights(h, new_h, gray.device)
    wx = linear_resize_weights(w, new_w, gray.device)
    return torch.matmul(torch.matmul(wy.T, gray), wx)


def boxes_mask(shape: tuple, boxes_xywh: torch.Tensor, margin_ratio: float = 0.15) -> torch.Tensor:
    """(H, W) or (B, H, W) bool mask, False inside each (cx,cy,w,h) box of
    (N,4) / (B,N,4) inflated by ``margin_ratio`` — the stabilizer's
    moving-object exclusion. Zero-width rows are ignored, so fixed-slot
    padded box arrays work directly. Axis-aligned boxes separate into row and
    column interval indicators, so the union is one (H,N)@(N,W) product of
    0/1 values (exact in float32)."""
    h, w = shape
    boxes = boxes_xywh.to(torch.float32)
    dev = boxes.device
    cx, cy = boxes[..., 0], boxes[..., 1]
    bw = boxes[..., 2] * (1 + margin_ratio)
    bh = boxes[..., 3] * (1 + margin_ratio)
    ys = torch.arange(h, dtype=torch.float32, device=dev)
    xs = torch.arange(w, dtype=torch.float32, device=dev)
    rows = (
        (ys >= (cy - bh / 2)[..., None])
        & (ys <= (cy + bh / 2)[..., None])
        & (boxes[..., 2] > 0)[..., None]
    ).to(torch.float32)  # (..., N, H)
    cols = (
        (xs >= (cx - bw / 2)[..., None])
        & (xs <= (cx + bw / 2)[..., None])
    ).to(torch.float32)  # (..., N, W)
    inside = torch.matmul(rows.transpose(-1, -2), cols)  # count of covering boxes
    return inside < 0.5


def fast_detect(gray: torch.Tensor, max_features: int, threshold: float = 20.0,
                mask: torch.Tensor | None = None, oriented: bool = False) -> Keypoints:
    """FAST-9/16 corners: score map, 16 px border and mask exclusion, 3x3
    non-max suppression, and the top ``max_features`` (``lax.top_k`` order).

    ``gray`` is (H,W) or (B,H,W); one score-map launch covers the batch."""
    if oriented:
        raise NotImplementedError(
            "fast_detect(oriented=True) is not ported yet (ROADMAP A18: no "
            "command of the reference reaches oriented FAST)"
        )
    h, w = gray.shape[-2], gray.shape[-1]
    score = fast_score_map(gray.contiguous(), threshold)

    # Exclude borders and masked (vehicle) regions.
    border = 16
    dev = gray.device
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    ok = (ys >= border) & (ys < h - border) & (xs >= border) & (xs < w - border)
    if mask is not None:
        ok = ok & mask
    score = torch.where(ok, score, 0.0)

    # 3x3 non-max suppression (max_pool2d pads with -inf, like the
    # reference's reduce_window init).
    flat = score.reshape((-1, 1, h, w))
    neighborhood = F.max_pool2d(flat, 3, stride=1, padding=1).reshape(score.shape)
    score = torch.where(score >= neighborhood, score, 0.0)

    top_scores, flat_idx = approx_top_k(score.reshape(score.shape[:-2] + (h * w,)), max_features)
    kp_y = torch.div(flat_idx, w, rounding_mode="floor").to(torch.float32)
    kp_x = (flat_idx % w).to(torch.float32)
    return Keypoints(
        xy=torch.stack([kp_x, kp_y], dim=-1),
        score=top_scores,
        angle=torch.zeros_like(kp_x),
        valid=top_scores > 0.0,
    )


_GRID_OFFS = np.array([-9, -3, 3, 9], dtype=np.int64)
GRID_DESC_DIM = 64  # 16 grid points x 4 channels


@lru_cache(maxsize=16)
def _blur_taps(sigma: float) -> tuple:
    """Normalized Gaussian taps of radius ``int(3*sigma+0.5)``, made in
    float64 and rounded to float32 as the reference makes them, returned as
    Python floats (exact float32 values)."""
    radius = int(3 * sigma + 0.5)
    x = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return tuple(float(v) for v in (k / k.sum()).astype(np.float32))


def _tap_sum(img: torch.Tensor, taps: tuple) -> torch.Tensor:
    """Separable float32 tap sum over the last two axes of (..., H, W),
    zero-padded borders: rows first, then columns, each adding its taps in
    order from tap 0 (the reference's order; a convolution adds in another
    and moves ties between scores)."""
    radius = len(taps) // 2
    h, w = img.shape[-2], img.shape[-1]
    rows = F.pad(img, (radius, radius))
    out = sum(taps[i] * rows[..., :, i:i + w] for i in range(len(taps)))
    cols = F.pad(out, (0, 0, radius, radius))
    return sum(taps[i] * cols[..., i:i + h, :] for i in range(len(taps)))


def _gaussian_blur(gray: torch.Tensor, sigma: float = 2.0) -> torch.Tensor:
    """Float32 separable Gaussian blur of (..., H, W) (the reference's
    ``_gaussian_blur``: tap sums over zero-padded borders)."""
    return _tap_sum(gray, _blur_taps(float(sigma)))


@lru_cache(maxsize=4)
def _blur_taps_bf16(sigma: float) -> tuple:
    """``_blur_taps`` rounded to bf16 (as ``jnp.bfloat16(k[i])``), returned
    as Python floats: a bf16 tensor times one of these rounds once to bf16,
    exactly like the reference's bf16 x bf16 product."""
    return tuple(float(torch.tensor(v).to(torch.bfloat16)) for v in _blur_taps(sigma))


def _gaussian_blur_bf16(gray: torch.Tensor, sigma: float = 2.0) -> torch.Tensor:
    """Separable bf16 tap-sum blur of (..., H, W), zero-padded borders. Every
    product and every partial sum rounds to bf16, as the reference's
    elementwise bf16 chain does on the CPU."""
    return _tap_sum(gray.to(torch.bfloat16), _blur_taps_bf16(float(sigma)))


def describe_grid(gray: torch.Tensor, kps: Keypoints) -> torch.Tensor:
    """64-D float descriptors (..., K, 64) for same-scale matching.

    Two smoothing scales + x/y gradients sampled at a 4x4 grid (offsets
    ±3/±9 px) around each keypoint: 16 points x 4 channels, mean brightness
    removed from the intensity channels, L2-normalized. The dense planes are
    bf16 like the reference's; the normalization runs in float32."""
    single = gray.dim() == 2
    if single:
        gray = gray[None]
        kps = Keypoints(*(t[None] for t in kps))
    b, h, w = gray.shape
    dev = gray.device
    s2 = _gaussian_blur_bf16(gray, sigma=2.0)
    gx = 0.5 * (torch.roll(s2, -1, dims=2) - torch.roll(s2, 1, dims=2))
    gy = 0.5 * (torch.roll(s2, -1, dims=1) - torch.roll(s2, 1, dims=1))
    s4 = _gaussian_blur_bf16(s2, sigma=2.0)
    planes = torch.stack([s2, gx, gy, s4], dim=-1)  # (B,H,W,4) bf16

    dy, dx = np.meshgrid(_GRID_OFFS, _GRID_OFFS, indexing="ij")
    dy = torch.as_tensor(dy.reshape(-1), device=dev)
    dx = torch.as_tensor(dx.reshape(-1), device=dev)
    ky = torch.clamp(kps.xy[..., 1].to(torch.int64)[..., None] + dy, 0, h - 1)
    kx = torch.clamp(kps.xy[..., 0].to(torch.int64)[..., None] + dx, 0, w - 1)
    bidx = torch.arange(b, device=dev)[:, None, None]
    vals = planes[bidx, ky, kx].to(torch.float32)  # (B,K,16,4)

    m2 = vals[..., 0].mean(dim=-1, keepdim=True)
    m4 = vals[..., 3].mean(dim=-1, keepdim=True)
    desc = torch.cat([vals[..., 0] - m2, vals[..., 1], vals[..., 2], vals[..., 3] - m4], dim=-1)
    desc = desc / torch.clamp_min(torch.linalg.vector_norm(desc, dim=-1, keepdim=True), 1e-6)
    return desc[0] if single else desc
