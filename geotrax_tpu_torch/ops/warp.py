"""Perspective image warp in torch: the port of ``geotrax_tpu/ops/warp.py``.

The visualize stage's modes 1 and 4 warp each frame that has a transform
(the reference's stage calls ``cv2.warpPerspective``, which the card's
machine lacks; the JAX package names ``warp_perspective`` as its
replacement). For each destination pixel the source point is ``H^-1 @ p``
in float32; the four neighbours are gathered at once and blended
bilinearly with a constant border, and u8 images are rounded (half to
even) and clipped.

The inverse is taken on the host in float32 (``invert_homography``), once
per frame, so the card and the CPU map every pixel through the same
matrix. The warp itself is a plain torch gather (as its counterpart is
plain XLA); it runs on the device of its image.
"""

from __future__ import annotations

import numpy as np
import torch


def invert_homography(h_matrix) -> np.ndarray:
    """float32 inverse of a 3x3 homography (as the JAX function inverts it)."""
    return np.linalg.inv(np.asarray(h_matrix, np.float32)).astype(np.float32)


def warp_perspective(image: torch.Tensor, h_inv, out_height: int, out_width: int) -> torch.Tensor:
    """Warp an (H,W,C) ``image`` so that output pixel ``p`` samples the
    source at ``h_inv @ p`` (``h_inv`` the inverse of cv2's src->dst
    matrix, from ``invert_homography``). Bilinear, black border; integer
    images are rounded and clipped to [0, 255]."""
    dev = image.device
    hi = torch.as_tensor(np.asarray(h_inv, np.float32), device=dev)
    ys = torch.arange(out_height, device=dev, dtype=torch.float32)[:, None]
    xs = torch.arange(out_width, device=dev, dtype=torch.float32)[None, :]
    # the three rows of H^-1 @ [x, y, 1], each a float32 multiply-add chain
    sx = hi[0, 0] * xs + hi[0, 1] * ys + hi[0, 2]
    sy = hi[1, 0] * xs + hi[1, 1] * ys + hi[1, 2]
    sw = hi[2, 0] * xs + hi[2, 1] * ys + hi[2, 2]
    sx, sy = sx / sw, sy / sw

    in_h, in_w = image.shape[0], image.shape[1]
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]
    # the four neighbours (y0, x0), (y0, x0+1), (y0+1, x0), (y0+1, x0+1) in one
    # gather; those outside the image read 0 (the constant border)
    xi = x0.to(torch.int64)[..., None] + torch.tensor([0, 1, 0, 1], device=dev)
    yi = y0.to(torch.int64)[..., None] + torch.tensor([0, 0, 1, 1], device=dev)
    valid = (xi >= 0) & (xi < in_w) & (yi >= 0) & (yi < in_h)
    idx = yi.clamp_(0, in_h - 1).mul_(in_w).add_(xi.clamp_(0, in_w - 1))
    taps = image.reshape(in_h * in_w, -1)[idx]
    taps.mul_(valid[..., None])
    s = taps.to(torch.float32)
    # JAX's blend, term for term: top = s00 (1-fx) + s01 fx, bot likewise,
    # out = top (1-fy) + bot fy (in place, the same float32 operations)
    gx = 1 - fx
    top = s[:, :, 0] * gx
    top += s[:, :, 1] * fx
    bot = s[:, :, 2] * gx
    bot += s[:, :, 3] * fx
    top *= 1 - fy
    bot *= fy
    top += bot
    if not image.dtype.is_floating_point:
        top = torch.round(top).clamp_(0, 255)
    return top.to(image.dtype)
