"""cv2-bit-exact INTER_LINEAR resize for uint8 images.

Counterpart of ``geotrax_tpu/ops/resize.py``. OpenCV's 8-bit path is fixed
point: coefficients rounded to 11-bit integers (INTER_RESIZE_COEF_SCALE =
2048), an alpha-weighted int32 horizontal pass, and the SSE2
``VResizeLinearVec_32s8u`` vertical rounding

    dst = (((row0 >> 4) * b0) >> 16 + ((row1 >> 4) * b1) >> 16 + 2) >> 2

This module repeats that integer arithmetic, so its output equals the JAX
function's, and cv2's, bit for bit.
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
        dev = x.device
        x_idx, xa0, xa1 = _axis_coeffs(src_w, dst_w)
        y_idx, yb0, yb1 = _axis_coeffs(src_h, dst_h)
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
        out = torch.clamp((acc + 2) >> 2, 0, 255).to(torch.uint8)

    if ndim == 2:
        return out[0, :, :, 0]
    if ndim == 3:
        return out[0]
    return out
