"""Keypoint detection, descriptors and matching.

The port of ``geotrax_tpu/ops/features.py``. The stabilization path (the
fused extract chunk, the lockstep step, the orb ``Stabilizer``) runs gray
conversion, the 0.5x downsample, the vehicle-box mask, unoriented FAST
detection (score map from ``ops/fast.py``, 3x3 non-max suppression, exact
top-k) and the 64-D grid descriptor with its bf16 blur planes; each of
these takes one image or a batch (leading axis), so the chunk step handles
all of its frames in one call.

The ORB-style library, for one image at a time: oriented FAST (the
intensity centroid over a radius-15 disc), the steered binary descriptor
``describe`` on its three routes (unoriented 32x32 patches through the
patch-gather kernel of ``ops/patches.py`` and one exact one-hot selection
product; unoriented packed comparison planes; the oriented per-keypoint
gather), the multi-scale ``detect_and_describe_pyramid`` and Hamming
matching with the ratio test and the mutual check, ``match_descriptors``.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from geotrax_tpu_torch.ops.fast import fast_score_map
from geotrax_tpu_torch.ops.patches import patches32
from geotrax_tpu_torch.ops.topk import approx_top_k, exact_top_k


class Keypoints(NamedTuple):
    xy: torch.Tensor      # (..., K, 2) float, x then y
    score: torch.Tensor   # (..., K)
    angle: torch.Tensor   # (..., K) radians (0 when detected unoriented)
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
                mask: torch.Tensor | None = None, oriented: bool = True) -> Keypoints:
    """FAST-9/16 corners: score map, 16 px border and mask exclusion, 3x3
    non-max suppression, and the top ``max_features`` (``lax.top_k`` order).

    ``gray`` is (H,W) or (B,H,W); one score-map launch covers the batch.
    ``oriented=False`` skips the intensity-centroid pass (angle 0): the
    per-frame stabilization match is same-scale and near-same-rotation."""
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
    angle = _orientation(gray, kp_x, kp_y) if oriented else torch.zeros_like(kp_x)
    return Keypoints(
        xy=torch.stack([kp_x, kp_y], dim=-1),
        score=top_scores,
        angle=angle,
        valid=top_scores > 0.0,
    )


@lru_cache(maxsize=4)
def _disc_offsets(radius: int = 15) -> np.ndarray:
    """(N, 2) int32 (dx, dy) offsets of the pixels within ``radius``."""
    ys, xs = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    inside = xs**2 + ys**2 <= radius**2
    return (np.stack([xs[inside], ys[inside]], axis=-1)).astype(np.int32)


@lru_cache(maxsize=8)
def _disc_weights(radius: int, device: str) -> tuple:
    """The (2R+1)^2 x and y moment weights of the disc, zero outside it."""
    ys, xs = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    inside = (xs**2 + ys**2 <= radius**2).astype(np.float32)
    return (torch.as_tensor((xs * inside).astype(np.float32), device=device),
            torch.as_tensor((ys * inside).astype(np.float32), device=device))


def _block(img: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor, p: int) -> torch.Tensor:
    """(..., K, p, p) blocks of (..., H, W) at top-left corners (..., K)
    already clipped into the image."""
    ar = torch.arange(p, device=img.device)
    rows = (y0[..., None] + ar)[..., :, None]
    cols = (x0[..., None] + ar)[..., None, :]
    if img.dim() == 2:
        return img[rows, cols]
    b = torch.arange(img.shape[0], device=img.device).reshape((-1,) + (1,) * (rows.dim() - 1))
    return img[b, rows, cols]


def _orientation(gray: torch.Tensor, kp_x: torch.Tensor, kp_y: torch.Tensor,
                 radius: int = 15) -> torch.Tensor:
    """Intensity-centroid orientation (ORB flavour): each keypoint's
    (2R+1)^2 block (CLIP: clipped into the image) weighted by the disc's x
    and y moments, then atan2(m01, m10)."""
    h, w = gray.shape[-2], gray.shape[-1]
    p = 2 * radius + 1
    x0 = torch.clamp(kp_x.to(torch.int64) - radius, 0, w - p)
    y0 = torch.clamp(kp_y.to(torch.int64) - radius, 0, h - p)
    patch = _block(gray, x0, y0, p)  # (..., K, P, P)
    wx, wy = _disc_weights(radius, str(gray.device))
    m10 = torch.sum(patch * wx, dim=(-2, -1))
    m01 = torch.sum(patch * wy, dim=(-2, -1))
    return torch.atan2(m01, m10)


@lru_cache(maxsize=4)
def _brief_pattern(n_tests: int = 256, patch: int = 31, seed: int = 7) -> np.ndarray:
    """(n_tests, 2, 2) float32 test-point pairs (x, y), Gaussian around the
    keypoint and clipped to the patch (the reference's draws)."""
    rng = np.random.default_rng(seed)
    sd = patch / 5.0
    pts = rng.normal(0.0, sd, size=(n_tests, 2, 2))
    return np.clip(pts, -(patch // 2), patch // 2).astype(np.float32)


_DESC_PATCH_UNORIENTED = 32  # the unrotated test extent is +-15 px


def _packed_test_planes(smoothed: torch.Tensor, n_tests: int) -> torch.Tensor:
    """(H,W) smoothed luma -> (H,W,n_tests//32) int32 planes where bit b of
    plane w at pixel p is test t = w*32+b: s(p+o1_t) < s(p+o2_t), offsets
    from the rounded BRIEF pattern (zero padding beyond the borders)."""
    if n_tests % 32:
        raise ValueError(f"n_tests must be a multiple of 32, got {n_tests}")
    h, w = smoothed.shape
    half = _DESC_PATCH_UNORIENTED // 2  # 16 >= max |offset|
    pts = np.round(_brief_pattern(n_tests)).astype(np.int64)  # (T,2,2)
    padded = F.pad(smoothed, (half, half, half, half))

    def view(dx, dy):
        return padded[half + dy:half + dy + h, half + dx:half + dx + w]

    planes = []
    for word in range(n_tests // 32):
        acc = torch.zeros((h, w), dtype=torch.int32, device=smoothed.device)
        for b in range(32):
            (x1, y1), (x2, y2) = pts[word * 32 + b]
            bit = view(int(x1), int(y1)) < view(int(x2), int(y2))
            acc = acc | (bit.to(torch.int32) << b)
        planes.append(acc)
    return torch.stack(planes, dim=-1)


@lru_cache(maxsize=4)
def _unoriented_selection(n_tests: int, patch: int) -> np.ndarray:
    """Constant (patch*patch, n_tests*2) one-hot selection matrix: at angle
    0 the rounded test offsets are fixed integers, so reading every test
    point of a keypoint's patch is one constant product."""
    half = patch // 2 - 1  # 15 for patch 32
    pts = np.round(_brief_pattern(n_tests)).astype(np.int64)  # (T,2,2) in [-15,15]
    flat_idx = (pts[..., 1] + half) * patch + (pts[..., 0] + half)  # (T,2)
    sel = np.zeros((patch * patch, n_tests * 2), np.float32)
    sel[flat_idx.reshape(-1), np.arange(n_tests * 2)] = 1.0
    return sel


@lru_cache(maxsize=8)
def _selection_on(n_tests: int, patch: int, device: str) -> torch.Tensor:
    return torch.as_tensor(_unoriented_selection(n_tests, patch), device=device)


def describe(gray: torch.Tensor, kps: Keypoints, n_tests: int = 256, oriented: bool = True,
             method: str = "patches") -> torch.Tensor:
    """Steered binary descriptors (K, n_tests) in {0,1} float32 of one
    (H,W) image: BRIEF pixel-pair tests on the image blurred at sigma 2,
    the test offsets rotated by each keypoint's angle.

    ``oriented=False`` (angle 0) reads each keypoint's 32x32 patch through
    the patch-gather kernel (``method="patches"``) and selects the test
    points with one constant one-hot product, exact in float32 (every
    output sums one nonzero product); ``method="planes"`` reads the bits
    from packed full-image comparison planes. Both give the oriented
    route's bits at angle 0. The oriented route gathers the rounded,
    clipped rotated test points of the blurred image directly."""
    smoothed = _gaussian_blur(gray, sigma=2.0)
    h, w = gray.shape
    k = kps.xy.shape[0]
    dev = gray.device
    if not oriented and min(h, w) >= _DESC_PATCH_UNORIENTED:
        if method == "planes":
            planes = _packed_test_planes(smoothed, n_tests)  # (H,W,T/32) int32
            kx = torch.clamp(kps.xy[:, 0].to(torch.int64), 0, w - 1)
            ky = torch.clamp(kps.xy[:, 1].to(torch.int64), 0, h - 1)
            ints = planes[ky, kx]  # (K, T/32)
            shifts = torch.arange(32, dtype=torch.int32, device=dev)
            bits = (ints[:, :, None] >> shifts) & 1
            return bits.reshape(k, n_tests).to(torch.float32)
        p = _DESC_PATCH_UNORIENTED
        half = p // 2 - 1
        x0 = torch.clamp(kps.xy[:, 0].to(torch.int32) - half, 0, w - p)
        y0 = torch.clamp(kps.xy[:, 1].to(torch.int32) - half, 0, h - p)
        patches = patches32(smoothed.contiguous(), x0, y0)
        vals = (patches.reshape(k, p * p) @ _selection_on(n_tests, p, str(dev)))
        vals = vals.reshape(k, n_tests, 2)
        return (vals[..., 0] < vals[..., 1]).to(torch.float32)
    pattern = torch.as_tensor(_brief_pattern(n_tests), device=dev)  # (T,2,[x,y])
    cos = torch.cos(kps.angle)[:, None, None]
    sin = torch.sin(kps.angle)[:, None, None]
    px_, py_ = pattern[..., 0], pattern[..., 1]
    # the rotation of every test point of every keypoint: (K,T,2)
    rx = cos * px_ + (-sin) * py_
    ry = sin * px_ + cos * py_
    px = torch.clamp(torch.round(kps.xy[:, None, None, 0] + rx), 0, w - 1).to(torch.int64)
    py = torch.clamp(torch.round(kps.xy[:, None, None, 1] + ry), 0, h - 1).to(torch.int64)
    vals = smoothed[py, px]  # (K,T,2)
    return (vals[..., 0] < vals[..., 1]).to(torch.float32)


def detect_and_describe_pyramid(gray: torch.Tensor, max_features: int, n_levels: int = 4,
                                scale: float = 1.25, threshold: float = 20.0,
                                mask: torch.Tensor | None = None) -> tuple:
    """Multi-scale oriented detection and description of one (H,W) image
    over a ``scale`` pyramid of ``n_levels`` levels: the budget split evenly
    over the levels, keypoints mapped back to level-0 pixels with each
    level's actual per-axis ratio and resize's half-pixel centres, and the
    global top ``max_features`` by score. Returns (Keypoints, (N, 256)
    descriptors). Levels and mask levels are resized as
    ``jax.image.resize``'s linear and nearest (``ops/sift.py``)."""
    from geotrax_tpu_torch.ops.sift import resize_linear, resize_mask_nearest

    per_level = max(max_features // n_levels, 32)
    all_xy, all_score, all_angle, all_valid, all_desc = [], [], [], [], []
    current = gray
    h0, w0 = gray.shape
    for level in range(n_levels):
        level_mask = None
        if mask is not None:
            level_mask = mask if level == 0 else resize_mask_nearest(mask, *current.shape)
        kps = fast_detect(current, per_level, threshold=threshold, mask=level_mask)
        desc = describe(current, kps)
        lh, lw = current.shape
        ratio = torch.tensor([w0 / lw, h0 / lh], dtype=kps.xy.dtype, device=gray.device)
        all_xy.append((kps.xy + 0.5) * ratio - 0.5)
        all_score.append(kps.score)
        all_angle.append(kps.angle)
        all_valid.append(kps.valid)
        all_desc.append(desc)
        if level + 1 < n_levels:
            current = resize_linear(current, int(lh / scale), int(lw / scale))

    xy = torch.cat(all_xy)
    score = torch.where(torch.cat(all_valid), torch.cat(all_score), 0.0)
    angle = torch.cat(all_angle)
    desc = torch.cat(all_desc)
    top_scores, idx = exact_top_k(score, min(max_features, score.shape[0]))
    return (Keypoints(xy=xy[idx], score=top_scores, angle=angle[idx], valid=top_scores > 0),
            desc[idx])


def match_descriptors(desc_a: torch.Tensor, valid_a: torch.Tensor, desc_b: torch.Tensor,
                      valid_b: torch.Tensor, ratio: float = 0.9) -> Matches:
    """Brute-force Hamming matching of {0,1} descriptors with Lowe's ratio
    test and the mutual check: one candidate per A keypoint (Ka,), valid
    where the ratio test passes, both ends are valid and B's best is A.

    dist(a, b) = sum a + sum b - 2 a.b as one float32 product, exact since
    every product is 0 or 1; invalid pairs sit at the 1e9 sentinel."""
    ka = desc_a.shape[0]
    a, b = desc_a.to(torch.float32), desc_b.to(torch.float32)
    dots = a @ b.T
    dist = a.sum(dim=1, keepdim=True) + b.sum(dim=1)[None, :] - 2.0 * dots
    big = torch.tensor(1e9, dtype=torch.float32, device=dist.device)
    dist = torch.where(valid_a[:, None] & valid_b[None, :], dist, big)

    best_d, best_b = torch.min(dist, dim=1)
    cols = torch.arange(dist.shape[1], device=dist.device)
    second_d = torch.min(torch.where(cols[None, :] == best_b[:, None], big, dist), dim=1).values
    ratio_ok = best_d < torch.tensor(ratio, dtype=torch.float32, device=dist.device) * second_d

    # mutual cross-check
    best_a_of_b = torch.argmin(dist, dim=0)
    rows = torch.arange(ka, device=dist.device)
    mutual = best_a_of_b[best_b] == rows

    valid = valid_a & ratio_ok & mutual & (best_d < big / 2)
    return Matches(idx_a=rows, idx_b=best_b, valid=valid)


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


@lru_cache(maxsize=8)
def _grid_offsets(device: str) -> tuple:
    """The (16,) row and column offsets of describe_grid's 4x4 grid on
    ``device`` (made once: a chunk step copies nothing from the host)."""
    dy, dx = np.meshgrid(_GRID_OFFS, _GRID_OFFS, indexing="ij")
    return (torch.as_tensor(dy.reshape(-1), device=device),
            torch.as_tensor(dx.reshape(-1), device=device))


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

    dy, dx = _grid_offsets(str(dev))
    ky = torch.clamp(kps.xy[..., 1].to(torch.int64)[..., None] + dy, 0, h - 1)
    kx = torch.clamp(kps.xy[..., 0].to(torch.int64)[..., None] + dx, 0, w - 1)
    bidx = torch.arange(b, device=dev)[:, None, None]
    vals = planes[bidx, ky, kx].to(torch.float32)  # (B,K,16,4)

    m2 = vals[..., 0].mean(dim=-1, keepdim=True)
    m4 = vals[..., 3].mean(dim=-1, keepdim=True)
    desc = torch.cat([vals[..., 0] - m2, vals[..., 1], vals[..., 2], vals[..., 3] - m4], dim=-1)
    desc = desc / torch.clamp_min(torch.linalg.vector_norm(desc, dim=-1, keepdim=True), 1e-6)
    return desc[0] if single else desc
