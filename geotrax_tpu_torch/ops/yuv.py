"""NV12 -> packed RGB24, the YUV -> RGB step of decoding: the hand-written
CUDA kernel and its plain version.

Replaces no Pallas kernel: the reference converts each decoded frame on the
host with swscale (``geotrax_tpu/io/native/decode.cpp:169-172``,
``sws_getContext(w, h, yuv420p, w, h, AV_PIX_FMT_RGB24, SWS_BILINEAR,
...)`` with no ``sws_setColorspaceDetails``: BT.601 limited-range
coefficients whatever the stream signals). ``nv12_to_rgb24`` launches
``csrc/nv12_rgb24.cu`` for CUDA tensors and runs ``nv12_to_rgb24_torch``
for CPU tensors; the two agree bit for bit.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from geotrax_tpu_torch import _cuda

KERNEL = "nv12_rgb24"
# libswscale 6.7's x86 SIMD converter: ff_yuv2rgb_c_init_tables' BT.601
# limited-range coefficients times 2^13, rounded to 16 bits, and the
# offsets of Y (16 << 3) and of U and V (128 << 3)
Y_COEFF, Y_OFFSET, C_OFFSET = 9539, 128, 1024
VR_COEFF, UG_COEFF, VG_COEFF, UB_COEFF = 13075, -3209, -6660, 16525


def _check_planes(y: torch.Tensor, uv: torch.Tensor, name: str) -> tuple:
    if y.dtype != torch.uint8 or uv.dtype != torch.uint8:
        raise TypeError(f"{name}: the planes are uint8, got {y.dtype} and {uv.dtype}")
    if y.dim() != 2 or uv.dim() != 2:
        raise ValueError(f"{name}: Y is (H, W) and UV (H/2, W), got {tuple(y.shape)} and "
                         f"{tuple(uv.shape)}")
    h, w = y.shape
    if h % 2 or w % 2:
        raise ValueError(f"{name}: 4:2:0 planes have even sides, got {h}x{w}")
    if tuple(uv.shape) != (h // 2, w):
        raise ValueError(f"{name}: UV of a {h}x{w} frame is ({h // 2}, {w}), got "
                         f"{tuple(uv.shape)}")
    return h, w


def nv12_to_rgb24_torch(y: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch NV12 -> RGB24: ``y`` (H, W) and ``uv`` (H/2, W, U and V
    interleaved) uint8 -> (H, W, 3) uint8, H and W even.

    The bytes of the reference decoder's swscale call on this repository's
    x86 hosts: for same-size yuv420p -> rgb24 with even height swscale
    takes its unscaled special converter, one chroma sample for each 2x2
    pixels with no interpolation, and where the CPU has MMXEXT or SSSE3 that
    is libswscale 6.7's SIMD converter (``yuv420_rgb24``; both give the same
    bytes). Its 16-bit fixed point: Y' = ((y << 3) - 128) * 9539 >> 16, Cb =
    (u << 3) - 1024, Cr = (v << 3) - 1024, R = Y' + (Cr * 13075 >> 16), G =
    Y' + (Cb * -3209 >> 16) + (Cr * -6660 >> 16), B = Y' + (Cb * 16525 >> 16),
    each clamped to 0..255 (pmulhw's floor of the high half, packuswb's
    saturation). Equal to that converter on all 2^24 (y, u, v). swscale's C
    table converter (a CPU without MMXEXT) rounds otherwise and is not
    this."""
    h, w = _check_planes(y, uv, "nv12_to_rgb24_torch")
    luma = (((y.to(torch.int32) << 3) - Y_OFFSET) * Y_COEFF) >> 16
    cb = (uv[:, 0::2].to(torch.int32) << 3) - C_OFFSET
    cr = (uv[:, 1::2].to(torch.int32) << 3) - C_OFFSET
    chroma = torch.stack([(cr * VR_COEFF) >> 16,
                          ((cb * UG_COEFF) >> 16) + ((cr * VG_COEFF) >> 16),
                          (cb * UB_COEFF) >> 16], dim=-1)
    up = chroma[:, None, :, None, :].expand(h // 2, 2, w // 2, 2, 3).reshape(h, w, 3)
    return (luma[..., None] + up).clamp_(0, 255).to(torch.uint8)


@lru_cache(maxsize=1)
def _kernel():
    """The C entry point ``gtx_nv12_rgb24`` (library built and loaded once)."""
    fn = _cuda.load(KERNEL).gtx_nv12_rgb24
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def build(verbose: bool = False) -> tuple:
    """Compile the kernel (see ``_cuda.build``); returns (path, log)."""
    return _cuda.build(KERNEL, verbose=verbose)


def nv12_to_rgb24(y: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """NV12 planes -> (H, W, 3) uint8 RGB, as ``nv12_to_rgb24_torch``.

    CPU tensors run the plain version; CUDA tensors launch the kernel on the
    current stream (one launch a frame) or raise. Each plane's rows may lie
    at any pitch (a row slice of a larger buffer), its bytes within a row
    contiguous. ``nv12_to_rgb24.launches`` counts the kernel launches."""
    if y.device.type == "cpu" and uv.device.type == "cpu":
        return nv12_to_rgb24_torch(y, uv)
    if y.device.type != "cuda" or uv.device != y.device:
        raise ValueError(f"nv12_to_rgb24: the planes lie on {y.device} and {uv.device}; the "
                         "kernel takes both on one CUDA device")
    h, w = _check_planes(y, uv, "nv12_to_rgb24")
    if y.stride(1) != 1 or uv.stride(1) != 1:
        raise ValueError("nv12_to_rgb24: the kernel takes planes whose rows are contiguous")
    if y.stride(0) < w or uv.stride(0) < w:
        raise ValueError(f"nv12_to_rgb24: row pitches {y.stride(0)} and {uv.stride(0)} are "
                         f"shorter than the width {w}")
    out = torch.empty((h, w, 3), dtype=torch.uint8, device=y.device)
    if h == 0 or w == 0:
        return out
    kernel = _kernel()
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        rc = kernel(y.data_ptr(), y.stride(0), uv.data_ptr(), uv.stride(0), out.data_ptr(), h, w,
                    stream)
    if rc != 0:
        raise RuntimeError(f"nv12_rgb24 kernel launch failed with CUDA error {rc}")
    nv12_to_rgb24.launches += 1
    return out


nv12_to_rgb24.launches = 0
