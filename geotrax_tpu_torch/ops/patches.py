"""32x32 patch gathers: the hand-written CUDA kernels and their plain versions.

``patches32`` replaces ``geotrax_tpu/ops/pallas_patches.py`` (the Pallas
kernel ``_make_kernel`` behind ``extract_patches``) and computes exactly
``geotrax_tpu/ops/features.py:patches32``, the XLA block gather in CLIP
mode: each corner is clamped to ``[0, H-32] x [0, W-32]`` before the patch
is read. ``patches32_hwc`` computes what the JAX appearance embedding
(``geotrax_tpu/pipeline/device_pipeline.py:embed_boxes``) builds around that
gather, straight from the (C,H,W,3) uint8 image: the optional 2x2 average,
the gather of each channel, and the optional 4x4 means.

Both launch ``csrc/patch_gather.cu`` for a CUDA tensor and run their plain
PyTorch version (``patches32_torch``, ``patches32_hwc_torch``) for a CPU
tensor; the two agree bit for bit (copies and exact sums of small
integers). ``patches32.launches`` counts the launches of either kernel. The
kernels are bound by memory (see the note in the source).
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


def _check_size(name: str, h: int, w: int) -> None:
    if h < PATCH or w < PATCH:
        raise ValueError(f"{name}: images of {h}x{w} are smaller than a {PATCH}x{PATCH} patch")


def _clamped_indices(x0: torch.Tensor, y0: torch.Tensor, h: int, w: int) -> tuple:
    """(..., 32) row and column indices of each patch, corners clamped."""
    ar = torch.arange(PATCH, device=x0.device)
    rows = torch.clamp(y0.long(), 0, h - PATCH)[..., None] + ar
    cols = torch.clamp(x0.long(), 0, w - PATCH)[..., None] + ar
    return rows, cols


def _int32_corners(x: torch.Tensor, hi: int) -> torch.Tensor:
    """Contiguous int32 corners; wider ones are clamped before the cast so
    that they cannot wrap."""
    return (x if x.dtype == torch.int32 else torch.clamp(x, 0, hi)).to(torch.int32).contiguous()


def _check_launch(rc: int) -> None:
    if rc == -1:
        raise RuntimeError("patch_gather: the CUDA driver has no cuTensorMapEncodeTiled "
                           "(libcuda.so.1), which the TMA path needs")
    if rc <= -1000:
        raise RuntimeError(f"patch_gather: cuTensorMapEncodeTiled failed with CUresult "
                           f"{-1000 - rc}")
    if rc != 0:
        raise RuntimeError(f"patch_gather kernel launch failed with CUDA error {rc}")


@lru_cache(maxsize=1)
def _library():
    """The kernels' library, built and loaded once, with its C signatures."""
    lib = _cuda.load(KERNEL)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.patch_gather.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, ptr]
    lib.patch_gather.restype = i32
    lib.patch_gather_hwc.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, ptr]
    lib.patch_gather_hwc.restype = i32
    return lib


def build(verbose: bool = False) -> tuple:
    """Compile the kernels (see ``_cuda.build``); returns (path, log)."""
    return _cuda.build(KERNEL, verbose=verbose)


def patches32_torch(planes: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch gather of (K,32,32) patches at each (x0, y0) top-left
    corner of an (H,W) plane, or (B,K,32,32) from (B,H,W) planes with
    (B,K) corners. CLIP semantics: a corner is clamped so that the patch
    lies in the plane."""
    p, x, y, single = _batched(planes, x0, y0)
    h, w = p.shape[-2:]
    _check_size("patches32", h, w)
    rows, cols = _clamped_indices(x, y, h, w)                              # (B,K,32)
    b = torch.arange(p.shape[0], device=p.device)[:, None, None, None]
    out = p[b, rows[..., :, None], cols[..., None, :]]                    # (B,K,32,32)
    return out[0] if single else out


def patches32(planes: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor) -> torch.Tensor:
    """(K,32,32) patches of an (H,W) float32 plane, or (B,K,32,32) of
    (B,H,W) planes, at integer top-left corners (CLIP semantics).

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    (one launch for the whole batch) or raises. The kernel loads each patch
    by TMA where the planes' base and row pitch are multiples of 16 bytes
    and through registers (the register path) elsewhere."""
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
    _check_size("patches32", h, w)
    out = torch.empty((b, k, PATCH, PATCH), dtype=torch.float32, device=p.device)
    if b and k:
        xi, yi = _int32_corners(x, w - PATCH), _int32_corners(y, h - PATCH)
        with torch.cuda.device(p.device):
            stream = torch.cuda.current_stream(p.device).cuda_stream
            rc = _library().patch_gather(p.data_ptr(), xi.data_ptr(), yi.data_ptr(),
                                         out.data_ptr(), b, k, h, w, stream)
        _check_launch(rc)
        patches32.launches += 1
    return out[0] if single else out


patches32.launches = 0


def _hwc_args(image: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor, pool2: bool) -> tuple:
    """Checks shared by both versions; returns the (pooled) height and width."""
    if image.dtype != torch.uint8:
        raise TypeError(f"patches32_hwc: takes a uint8 image, got {image.dtype}")
    if image.dim() != 4 or image.shape[-1] != 3:
        raise ValueError(f"patches32_hwc: takes a (C,H,W,3) image, got {tuple(image.shape)}")
    if x0.is_floating_point() or y0.is_floating_point():
        raise TypeError("patches32_hwc: corners must be integers")
    if x0.dim() != 2 or x0.shape != y0.shape or x0.shape[0] != image.shape[0]:
        raise ValueError(f"patches32_hwc: (C,H,W,3) images take (C,M) corners, got "
                         f"{tuple(image.shape)}, {tuple(x0.shape)}, {tuple(y0.shape)}")
    h, w = image.shape[1:3]
    hp, wp = (h // 2, w // 2) if pool2 else (h, w)
    _check_size("patches32_hwc", hp, wp)
    return hp, wp


def patches32_hwc_torch(image_u8: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor,
                        pool2: bool, mean4: bool) -> torch.Tensor:
    """Plain PyTorch version of ``patches32_hwc``: the (C,M,3,32,32) float32
    patches of a (C,H,W,3) uint8 image at (C,M) top-left corners (CLIP
    semantics), of its 2x2 average when ``pool2`` (H and W trimmed to even
    first); with ``mean4`` their (C,M,3,8,8) 4x4 means instead."""
    hp, wp = _hwc_args(image_u8, x0, y0, pool2)
    if pool2:
        f = image_u8[:, :2 * hp, :2 * wp].to(torch.float32)
        img = 0.25 * (f[:, 0::2, 0::2] + f[:, 0::2, 1::2] + f[:, 1::2, 0::2] + f[:, 1::2, 1::2])
    else:
        img = image_u8.to(torch.float32)
    c, m = x0.shape
    rows, cols = _clamped_indices(x0, y0, hp, wp)                          # (C,M,32)
    ci = torch.arange(c, device=img.device)[:, None, None, None, None]
    ch = torch.arange(3, device=img.device)[None, None, :, None, None]
    out = img[ci, rows[:, :, None, :, None], cols[:, :, None, None, :], ch]  # (C,M,3,32,32)
    if mean4:
        out = out.reshape(c, m, 3, 8, 4, 8, 4).mean(dim=(4, 6))            # (C,M,3,8,8)
    return out


def patches32_hwc(image_u8: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor, pool2: bool,
                  mean4: bool) -> torch.Tensor:
    """(C,M,3,32,32) float32 patches of a (C,H,W,3) uint8 image at (C,M)
    integer top-left corners (CLIP semantics), read from its 2x2 average
    when ``pool2`` (the average is taken where the pixels are read); with
    ``mean4`` the (C,M,3,8,8) 4x4 means of those patches instead.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    (one launch for every image and channel) or raises: it takes only a
    contiguous uint8 image and corners on the image's device, and never
    widens the image. TMA where the image's base and row pitch (3W bytes)
    are multiples of 16 bytes, else the register path. Counted in
    ``patches32.launches``."""
    if image_u8.device.type == "cpu":
        return patches32_hwc_torch(image_u8, x0, y0, pool2, mean4)
    if image_u8.device.type != "cuda":
        raise ValueError(f"patches32_hwc: unsupported device {image_u8.device}")
    hp, wp = _hwc_args(image_u8, x0, y0, pool2)
    if not image_u8.is_contiguous():
        raise ValueError("patches32_hwc: the kernel takes a contiguous image")
    if x0.device != image_u8.device or y0.device != image_u8.device:
        raise ValueError("patches32_hwc: corners must lie on the image's device")
    c, m = x0.shape
    h, w = image_u8.shape[1:3]
    tail = (8, 8) if mean4 else (PATCH, PATCH)
    out = torch.empty((c, m, 3) + tail, dtype=torch.float32, device=image_u8.device)
    if c and m:
        xi, yi = _int32_corners(x0, wp - PATCH), _int32_corners(y0, hp - PATCH)
        with torch.cuda.device(image_u8.device):
            stream = torch.cuda.current_stream(image_u8.device).cuda_stream
            rc = _library().patch_gather_hwc(image_u8.data_ptr(), xi.data_ptr(), yi.data_ptr(),
                                             out.data_ptr(), c, m, h, w, int(pool2), int(mean4),
                                             stream)
        _check_launch(rc)
        patches32.launches += 1
    return out
