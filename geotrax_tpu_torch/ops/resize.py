"""cv2-bit-exact INTER_LINEAR and INTER_AREA resizes for uint8 images.

Counterpart of ``geotrax_tpu/ops/resize.py``. OpenCV's 8-bit path is fixed
point: coefficients rounded to 11-bit integers (INTER_RESIZE_COEF_SCALE =
2048), an alpha-weighted int32 horizontal pass, and the SSE2
``VResizeLinearVec_32s8u`` vertical rounding

    dst = (((row0 >> 4) * b0) >> 16 + ((row1 >> 4) * b1) >> 16 + 2) >> 2

This module repeats that integer arithmetic, so its output equals the JAX
function's, and cv2's, bit for bit.

``resize_area_u8`` is cv2's INTER_AREA on the tensor's device
(``subset_orthophoto``'s cutouts, where the reference calls cv2): for a
downscale the whole-block mean at an integer inverse scale, else the
area-overlap weights in float32 in cv2's order of operations, which gives
cv2's pixels; for an upscale the fixed-point linear path above with cv2's
area-mode weights.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

COEF_BITS = 11
COEF_SCALE = 1 << COEF_BITS  # 2048


@lru_cache(maxsize=64)
def _axis_coeffs(src: int, dst: int):
    """cv2 resize coefficient table for one axis: (idx0 (dst,), a0, a1) with
    a0 + a1 == 2048 (int32). Border handling matches cv2: clamp + full
    weight on the surviving sample."""
    scale = src / dst
    d = np.arange(dst, dtype=np.float64)
    fx = (d + 0.5) * scale - 0.5
    sx = np.floor(fx).astype(np.int64)
    fx = fx - sx
    # cv2 border rules (resize.cpp): sx<0 -> (0, fx=0); sx>=src-1 -> (src-2, fx=1)
    low = sx < 0
    sx = np.where(low, 0, sx)
    fx = np.where(low, 0.0, fx)
    high = sx >= src - 1
    sx = np.where(high, max(src - 2, 0), sx)
    fx = np.where(high, 1.0, fx)
    a1 = np.rint(fx * COEF_SCALE).astype(np.int32)  # SSE cvRound: half to even
    a0 = COEF_SCALE - a1
    return sx.astype(np.int64), a0, a1


def resize_u8_linear(img_u8: torch.Tensor, dst_h: int, dst_w: int) -> torch.Tensor:
    """(H,W), (H,W,C) or (B,H,W,C) uint8 -> the same layout at (dst_h, dst_w),
    bit-equal to ``cv2.resize(img, (dst_w, dst_h), interpolation=INTER_LINEAR)``
    on each image."""
    ndim = img_u8.dim()
    if ndim == 2:
        x = img_u8[None, :, :, None]
    elif ndim == 3:
        x = img_u8[None]
    elif ndim == 4:
        x = img_u8
    else:
        raise ValueError(f"resize_u8_linear takes (H,W), (H,W,C) or (B,H,W,C), got {tuple(img_u8.shape)}")
    if img_u8.dtype != torch.uint8:
        raise TypeError(f"resize_u8_linear takes uint8, got {img_u8.dtype}")
    src_h, src_w = x.shape[1], x.shape[2]

    if src_h == 2 * dst_h and src_w == 2 * dst_w:
        # 0.5x: every coefficient is 1024 and the fixed-point pipeline
        # reduces exactly to (p00 + p01 + p10 + p11 + 2) >> 2 (sums <= 1020
        # fit int16).
        v = x[:, 0::2].to(torch.int16) + x[:, 1::2].to(torch.int16)
        out = ((v[:, :, 0::2] + v[:, :, 1::2] + 2) >> 2).to(torch.uint8)
    else:
        out = _fixed_point_linear(x, _axis_coeffs(src_w, dst_w), _axis_coeffs(src_h, dst_h))

    if ndim == 2:
        return out[0, :, :, 0]
    if ndim == 3:
        return out[0]
    return out


def _fixed_point_linear(x: torch.Tensor, x_coeffs, y_coeffs) -> torch.Tensor:
    """cv2's fixed-point two-tap resize of a (B, H, W, C) uint8 tensor,
    given each axis's (idx0, a0, a1) table."""
    dev = x.device
    src_h, src_w = x.shape[1], x.shape[2]
    x_idx, xa0, xa1 = x_coeffs
    y_idx, yb0, yb1 = y_coeffs
    img_i = x.to(torch.int32)
    # horizontal pass: alpha-weighted int32 sums (static column gather)
    c0 = img_i.index_select(2, torch.as_tensor(x_idx, device=dev))
    c1 = img_i.index_select(2, torch.as_tensor(np.minimum(x_idx + 1, src_w - 1), device=dev))
    rows = (c0 * torch.as_tensor(xa0, device=dev)[None, None, :, None]
            + c1 * torch.as_tensor(xa1, device=dev)[None, None, :, None])
    # vertical pass with the SSE2 fixed-point rounding
    r0 = rows.index_select(1, torch.as_tensor(y_idx, device=dev)) >> 4
    r1 = rows.index_select(1, torch.as_tensor(np.minimum(y_idx + 1, src_h - 1), device=dev)) >> 4
    b0 = torch.as_tensor(yb0, device=dev)[None, :, None, None]
    b1 = torch.as_tensor(yb1, device=dev)[None, :, None, None]
    acc = ((r0 * b0) >> 16) + ((r1 * b1) >> 16)
    return torch.clamp((acc + 2) >> 2, 0, 255).to(torch.uint8)


# ---------------------------------------------------------------------------
# INTER_AREA (subset_orthophoto's cutouts)
# ---------------------------------------------------------------------------

@lru_cache(maxsize=16)
def _area_linear_coeffs(src: int, dst: int):
    """cv2's INTER_AREA table for one axis of an upscale, where cv2 runs its
    linear path "in area mode": ``sx = floor(d * scale)``, ``fx = (d + 1) -
    (sx + 1) / scale`` in float32 (0 where not positive, else its
    fraction), each weight rounded to 11 bits on its own."""
    inv_scale = dst / src
    scale = 1.0 / inv_scale
    d = np.arange(dst, dtype=np.float64)
    sx = np.floor(d * scale).astype(np.int64)
    fx = ((d + 1) - (sx + 1) * inv_scale).astype(np.float32)
    fx = np.where(fx <= 0, np.float32(0), fx - np.floor(fx)).astype(np.float32)
    a0 = np.rint((np.float32(1) - fx) * np.float32(COEF_SCALE)).astype(np.int32)
    a1 = np.rint(fx * np.float32(COEF_SCALE)).astype(np.int32)
    return np.minimum(sx, src - 1), a0, a1


@lru_cache(maxsize=16)
def _area_taps(src: int, dst: int) -> tuple:
    """cv2's ``computeResizeAreaTab`` for one axis, as (dst, K) source
    indices and float32 weights, K the most taps an output has (unused
    taps: index 0, weight 0; an output's taps in cv2's order).
    ``scale = 1 / (dst / src)`` in double, as cv2 derives it."""
    scale = 1.0 / (dst / src)
    taps = []
    for d in range(dst):
        fsx1 = d * scale
        fsx2 = fsx1 + scale
        cell = min(scale, src - fsx1)
        sx1, sx2 = int(np.ceil(fsx1)), int(np.floor(fsx2))
        sx2 = min(sx2, src - 1)
        sx1 = min(sx1, sx2)
        row = []
        if sx1 - fsx1 > 1e-3:
            row.append((sx1 - 1, (sx1 - fsx1) / cell))
        row += [(sx, 1.0 / cell) for sx in range(sx1, sx2)]
        if fsx2 - sx2 > 1e-3:
            row.append((sx2, min(min(fsx2 - sx2, 1.0), cell) / cell))
        taps.append(row)
    idx = np.zeros((dst, max(map(len, taps))), np.int64)
    alpha = np.zeros(idx.shape, np.float32)
    for d, row in enumerate(taps):
        for k, (s_, a) in enumerate(row):
            idx[d, k], alpha[d, k] = s_, np.float32(a)
    return idx, alpha


def _weighted_taps(x: torch.Tensor, idx: np.ndarray, alpha: np.ndarray, dim: int):
    """sum_k x.index_select(dim, idx[:, k]) * alpha[:, k] in float32, tap by
    tap from zero (a product, then a sum: no fused multiply-add)."""
    shape = [1] * x.dim()
    shape[dim] = -1
    acc = None
    for k in range(idx.shape[1]):
        i = torch.as_tensor(idx[:, k], device=x.device)
        a = torch.as_tensor(alpha[:, k], device=x.device).view(shape)
        term = x.index_select(dim, i).float() * a
        acc = term if acc is None else acc + term
    return acc


def _area_fast(img: torch.Tensor, kx: int, ky: int) -> torch.Tensor:
    """cv2's ``resizeAreaFast``: the mean of each whole kx x ky block;
    ``(sum + 2) >> 2`` for 2 x 2 (its vector path), else
    ``round(float(sum) * float32(1 / area))``."""
    h, w, c = img.shape
    blocks = img.view(h // ky, ky, w // kx, kx, c).to(torch.int32).sum((1, 3))
    if kx == 2 and ky == 2:
        return ((blocks + 2) >> 2).to(torch.uint8)
    scale = torch.tensor(1.0 / (kx * ky), dtype=torch.float32, device=img.device)
    return torch.round(blocks.float() * scale).clamp(0, 255).to(torch.uint8)


def resize_area_u8(img: torch.Tensor, out_w: int, out_h: int) -> torch.Tensor:
    """``cv2.resize(img, (out_w, out_h), interpolation=cv2.INTER_AREA)`` of
    an (H, W, C) uint8 tensor on its device. A downscale with an integer
    inverse scale takes cv2's block mean (``resizeAreaFast``); any other
    downscale cv2's area-overlap weights, a float32 pass along each row's
    taps (at most 3 for an inverse scale below 2), then along the columns,
    rounded half to even and saturated, as ``resizeArea_Invoker`` adds
    them. Where either axis grows, cv2's fixed-point linear path with its
    area-mode weights."""
    h, w = int(img.shape[0]), int(img.shape[1])
    scale_x, scale_y = 1.0 / (out_w / w), 1.0 / (out_h / h)
    if scale_x < 1 or scale_y < 1:
        return _fixed_point_linear(img[None], _area_linear_coeffs(w, out_w),
                                   _area_linear_coeffs(h, out_h))[0]
    kx, ky = int(round(scale_x)), int(round(scale_y))
    eps = np.finfo(np.float64).eps
    if abs(scale_x - kx) < eps and abs(scale_y - ky) < eps:
        return _area_fast(img, kx, ky)
    rows = _weighted_taps(img, *_area_taps(w, out_w), dim=1)
    out = _weighted_taps(rows, *_area_taps(h, out_h), dim=0)
    return torch.round(out).clamp(0, 255).to(torch.uint8)
