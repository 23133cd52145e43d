"""32x32 patch gather: the hand-written CUDA kernel and its plain version.

Replaces ``geotrax_tpu/ops/pallas_patches.py`` (the Pallas kernel
``_make_kernel`` behind ``extract_patches``) and computes exactly
``geotrax_tpu/ops/features.py:patches32``, the XLA block gather in CLIP
mode that the JAX appearance embedding runs: each corner is clamped to
``[0, H-32] x [0, W-32]`` before the patch is read. ``patches32`` launches
``csrc/patch_gather.cu`` for a CUDA tensor and runs ``patches32_torch``, the
plain PyTorch version, for a CPU tensor; the two agree bit for bit (a copy).
The kernel is bound by memory (see the note in the source).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from geotrax_tpu_torch import _cuda

PATCH = 32
KERNEL = "patch_gather"


def _batched(planes: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor) -> tuple:
    """(H,W) + (K,) or (B,H,W) + (B,K) -> the batched form and whether the
    input was a single plane."""
    if x0.is_floating_point() or y0.is_floating_point():
        raise TypeError("patches32: corners must be integers")
    if planes.dim() == 2:
        if x0.dim() != 1 or y0.dim() != 1:
            raise ValueError("patches32: an (H,W) plane takes (K,) corners")
        return planes[None], x0[None], y0[None], True
    if planes.dim() != 3 or x0.dim() != 2 or x0.shape != y0.shape or x0.shape[0] != planes.shape[0]:
        raise ValueError(f"patches32: (B,H,W) planes take (B,K) corners, got "
                         f"{tuple(planes.shape)}, {tuple(x0.shape)}, {tuple(y0.shape)}")
    return planes, x0, y0, False


def patches32_torch(planes: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch gather of (K,32,32) patches at each (x0, y0) top-left
    corner of an (H,W) plane, or (B,K,32,32) from (B,H,W) planes with
    (B,K) corners. CLIP semantics: a corner is clamped so that the patch
    lies in the plane."""
    p, x, y, single = _batched(planes, x0, y0)
    h, w = p.shape[-2:]
    if h < PATCH or w < PATCH:
        raise ValueError(f"patches32: planes of {h}x{w} are smaller than a {PATCH}x{PATCH} patch")
    ar = torch.arange(PATCH, device=p.device)
    rows = torch.clamp(y.long(), 0, h - PATCH)[..., None] + ar            # (B,K,32)
    cols = torch.clamp(x.long(), 0, w - PATCH)[..., None] + ar            # (B,K,32)
    b = torch.arange(p.shape[0], device=p.device)[:, None, None, None]
    out = p[b, rows[..., :, None], cols[..., None, :]]                    # (B,K,32,32)
    return out[0] if single else out


@lru_cache(maxsize=1)
def _kernel():
    """The C entry point ``patch_gather`` (library built and loaded once)."""
    fn = _cuda.load(KERNEL).patch_gather
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def build(verbose: bool = False) -> tuple:
    """Compile the kernel (see ``_cuda.build``); returns (path, log)."""
    return _cuda.build(KERNEL, verbose=verbose)


def patches32(planes: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor) -> torch.Tensor:
    """(K,32,32) patches of an (H,W) float32 plane, or (B,K,32,32) of
    (B,H,W) planes, at integer top-left corners (CLIP semantics).

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    (one launch for the whole batch) or raises. ``patches32.launches``
    counts the kernel launches."""
    if planes.device.type == "cpu":
        return patches32_torch(planes, x0, y0)
    if planes.device.type != "cuda":
        raise ValueError(f"patches32: unsupported device {planes.device}")
    if planes.dtype != torch.float32:
        raise TypeError(f"patches32: the kernel takes float32 planes, got {planes.dtype}")
    if not planes.is_contiguous():
        raise ValueError("patches32: the kernel takes contiguous planes")
    p, x, y, single = _batched(planes, x0, y0)
    if x.device != p.device or y.device != p.device:
        raise ValueError("patches32: corners must lie on the planes' device")
    b, k = x.shape
    h, w = p.shape[-2:]
    if h < PATCH or w < PATCH:
        raise ValueError(f"patches32: planes of {h}x{w} are smaller than a {PATCH}x{PATCH} patch")
    if b > 65535:
        raise ValueError(f"patches32: {b} planes exceed the launch grid's 65535")
    out = torch.empty((b, k, PATCH, PATCH), dtype=torch.float32, device=p.device)
    if b and k:
        # wider corners are clamped before the cast so they cannot wrap
        xi = (x if x.dtype == torch.int32 else torch.clamp(x, 0, w - PATCH)).to(torch.int32)
        yi = (y if y.dtype == torch.int32 else torch.clamp(y, 0, h - PATCH)).to(torch.int32)
        xi, yi = xi.contiguous(), yi.contiguous()
        kernel = _kernel()
        with torch.cuda.device(p.device):
            stream = torch.cuda.current_stream(p.device).cuda_stream
            rc = kernel(p.data_ptr(), xi.data_ptr(), yi.data_ptr(), out.data_ptr(), b, k, h, w,
                        stream)
        if rc != 0:
            raise RuntimeError(f"patch_gather kernel launch failed with CUDA error {rc}")
        patches32.launches += 1
    return out[0] if single else out


patches32.launches = 0
