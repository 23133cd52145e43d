"""FAST-9/16 corner score: the hand-written CUDA kernel and its plain version.

Replaces ``geotrax_tpu/ops/pallas_fast.py`` (the Pallas kernel
``_make_kernel`` behind ``fast_score_map``) and the XLA twin
``geotrax_tpu/ops/features.py:fast_score_map_xla`` that the JAX fused path
runs. ``fast_score_map`` launches ``csrc/fast_score.cu`` for a CUDA tensor
and runs ``fast_score_map_torch``, the plain PyTorch version, for a CPU
tensor; the two agree bit for bit. The kernel is bound by memory (one read
and one write of each pixel; see the note in the source).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from geotrax_tpu_torch import _cuda

# Bresenham circle radius-3, clockwise from 12 o'clock: (dx, dy)
CIRCLE = (
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)
RADIUS = 3
KERNEL = "fast_score"


def fast_score_map_torch(gray: torch.Tensor, threshold: float = 20.0) -> torch.Tensor:
    """Plain PyTorch FAST score map of (..., H, W) float32 -> same shape.

    The bit-packed form of ``fast_score_map_xla``: the 16 ring comparisons
    pack into two int32 masks, the >= 9 contiguous run test is log-doubling
    shift-ANDs on the doubled mask, and the score sums |ring - c| in CIRCLE
    order starting from 0 — the same float32 operations in the same order."""
    center = gray.to(torch.float32)
    h, w = center.shape[-2], center.shape[-1]
    pad = RADIUS
    padded = torch.nn.functional.pad(center, (pad, pad, pad, pad))
    hi = center + threshold
    lo = center - threshold
    bits_b = torch.zeros(center.shape, dtype=torch.int32, device=center.device)
    bits_d = torch.zeros_like(bits_b)
    score = torch.zeros_like(center)
    for k, (dx, dy) in enumerate(CIRCLE):
        ring = padded[..., pad + dy:pad + dy + h, pad + dx:pad + dx + w]
        bits_b = bits_b + ((ring > hi).to(torch.int32) << k)
        bits_d = bits_d + ((ring < lo).to(torch.int32) << k)
        score = score + torch.abs(ring - center)

    def has_run9(bits):
        dbl = bits | (bits << 16)
        r = dbl & (dbl >> 1)
        r = r & (r >> 2)
        r = r & (r >> 4)
        r = r & (dbl >> 8)
        return (r & 0xFFFF) != 0

    is_corner = has_run9(bits_b) | has_run9(bits_d)
    return torch.where(is_corner, score, 0.0)


@lru_cache(maxsize=1)
def _kernel():
    """The C entry point ``fast_score`` (library built and loaded once)."""
    fn = _cuda.load(KERNEL).fast_score
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def build(verbose: bool = False) -> tuple:
    """Compile the kernel (see ``_cuda.build``); returns (path, log)."""
    return _cuda.build(KERNEL, verbose=verbose)


def fast_score_map(gray: torch.Tensor, threshold: float = 20.0) -> torch.Tensor:
    """FAST score map of (H,W) or (B,H,W) float32 -> same shape.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    (one launch for the whole batch) or raises. ``fast_score_map.launches``
    counts the kernel launches."""
    if gray.device.type == "cpu":
        return fast_score_map_torch(gray, threshold)
    if gray.device.type != "cuda":
        raise ValueError(f"fast_score_map: unsupported device {gray.device}")
    if gray.dtype != torch.float32:
        raise TypeError(f"fast_score_map: the kernel takes float32, got {gray.dtype}")
    if gray.dim() not in (2, 3):
        raise ValueError(f"fast_score_map: the kernel takes (H,W) or (B,H,W), got {tuple(gray.shape)}")
    if not gray.is_contiguous():
        raise ValueError("fast_score_map: the kernel takes a contiguous tensor")
    b = gray.shape[0] if gray.dim() == 3 else 1
    h, w = gray.shape[-2], gray.shape[-1]
    if b == 0 or h == 0 or w == 0:
        return torch.zeros_like(gray)
    if b > 65535:
        raise ValueError(f"fast_score_map: batch {b} exceeds the launch grid's 65535")
    out = torch.empty_like(gray)
    kernel = _kernel()
    with torch.cuda.device(gray.device):
        stream = torch.cuda.current_stream(gray.device).cuda_stream
        rc = kernel(gray.data_ptr(), out.data_ptr(), b, h, w, float(threshold), stream)
    if rc != 0:
        raise RuntimeError(f"fast_score kernel launch failed with CUDA error {rc}")
    fast_score_map.launches += 1
    return out


fast_score_map.launches = 0
