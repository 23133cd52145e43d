"""The port's native video decoder, encoder and remuxer: ``decode.cpp``,
``encode.cpp`` (its copy of the reference's MPEG-4 writer) and
``remux.cpp`` (stream-copy concatenation and cut, and the container check
of the data-prep tools), each built with ``g++`` at first use and bound
with ``ctypes``; ``build_plain`` builds the
sources that need no library beyond C++'s own (``tiff.cpp`` for
``io/tiff.py``, ``lapjv.cpp`` for ``ops/assignment.py``).

Each library goes under ``build/native/`` at the root of the checkout (a
git-ignored directory), with a hash of the source and flags in its name,
so an edited source is rebuilt and an unchanged one reused. The FFmpeg
headers and libraries (libavformat, libavcodec, libavutil, libswscale) are
found with ``pkg-config``, else under ``/usr/include/<multiarch triplet>``;
``probe()`` says which, or why there are none, without building.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sysconfig
from pathlib import Path
from typing import Iterator

import numpy as np

SOURCE = Path(__file__).resolve().parent / "decode.cpp"
ENCODER_SOURCE = Path(__file__).resolve().parent / "encode.cpp"
REMUX_SOURCE = Path(__file__).resolve().parent / "remux.cpp"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "native"
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared")
PACKAGES = ("libavformat", "libavcodec", "libavutil", "libswscale")
LIBS = ("-lavformat", "-lavcodec", "-lavutil", "-lswscale")
BUILD_TIMEOUT_S = 300

_lib = None
_enc_lib = None
_remux_lib = None


def _multiarch_include() -> Path | None:
    triplet = sysconfig.get_config_var("MULTIARCH")
    if triplet:
        inc = Path("/usr/include") / triplet
        if (inc / "libavcodec" / "avcodec.h").is_file():
            return inc
    if Path("/usr/include/libavcodec/avcodec.h").is_file():
        return Path("/usr/include")
    return None


def probe() -> dict:
    """Where the compiler and the FFmpeg development files are:
    {"ok": bool, "cxx": path or None, "flags": [...], "found": text}."""
    cxx = shutil.which(os.environ.get("CXX", "g++")) or shutil.which("c++")
    res = {"ok": False, "cxx": cxx, "flags": [], "found": ""}
    if shutil.which("pkg-config"):
        proc = subprocess.run(["pkg-config", "--cflags", "--libs", *PACKAGES],
                              capture_output=True, text=True, timeout=30)
        if proc.returncode == 0:
            res.update(flags=proc.stdout.split(), found="pkg-config " + " ".join(PACKAGES))
    if not res["found"]:
        inc = _multiarch_include()
        if inc is not None:
            res.update(flags=[f"-I{inc}", *LIBS], found=f"headers under {inc}")
    if not res["found"]:
        res["found"] = "no libavcodec headers (pkg-config and /usr/include)"
    elif cxx is None:
        res["found"] += ", but no C++ compiler"
    res["ok"] = bool(res["flags"]) and cxx is not None
    return res


def library_path(flags, source: Path = SOURCE) -> Path:
    digest = hashlib.sha1(source.read_bytes() + " ".join((*CXX_FLAGS, *flags)).encode())
    return BUILD_DIR / f"libgeotrax_{source.stem}-{digest.hexdigest()[:12]}.so"


def build(source: Path = SOURCE) -> Path:
    """Compile ``source`` (``decode.cpp``, ``encode.cpp`` or ``remux.cpp``) unless its
    library exists; return its path. Raises ``RuntimeError`` when the
    toolchain or FFmpeg is missing."""
    found = probe()
    if not found["ok"]:
        raise RuntimeError(f"cannot build the native {source.stem}r: {found['found']}")
    out = library_path(found["flags"], source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [found["cxx"], *CXX_FLAGS, "-o", str(tmp), str(source), *found["flags"]]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {source.name} (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent process never loads a partial file
    return out


def build_plain(source: Path) -> Path:
    """Compile ``source``, which needs only the C++ standard library,
    unless its library exists; return its path. Raises ``RuntimeError``
    when there is no compiler or the build fails: there is no slower path
    in Python to fall back to."""
    out = library_path((), source)
    if out.exists():
        return out
    cxx = shutil.which(os.environ.get("CXX", "g++")) or shutil.which("c++")
    if cxx is None:
        raise RuntimeError(f"cannot build {source.name}: no C++ compiler")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(source)],
                          capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {source.name} (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent process never loads a partial file
    return out


def load_library() -> ctypes.CDLL:
    """The decoder library, built if needed; raises ``RuntimeError`` or
    ``OSError`` when it cannot be built or loaded."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    lib.gtx_open.restype = ctypes.c_void_p
    lib.gtx_open.argtypes = [ctypes.c_char_p]
    for name in ("gtx_width", "gtx_height"):
        getattr(lib, name).restype = ctypes.c_int
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    lib.gtx_fps.restype = ctypes.c_double
    lib.gtx_fps.argtypes = [ctypes.c_void_p]
    lib.gtx_frame_count.restype = ctypes.c_long
    lib.gtx_frame_count.argtypes = [ctypes.c_void_p]
    lib.gtx_read_frame.restype = ctypes.c_int
    lib.gtx_read_frame.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.gtx_close.restype = None
    lib.gtx_close.argtypes = [ctypes.c_void_p]
    lib.gtx_open_at.restype = ctypes.c_void_p
    lib.gtx_open_at.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int]
    lib.gtx_read_frame_pts.restype = ctypes.c_int
    lib.gtx_read_frame_pts.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_int64)]
    lib.gtx_scan_pts.restype = ctypes.c_long
    lib.gtx_scan_pts.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
                                 ctypes.POINTER(ctypes.c_int), ctypes.c_long]
    lib.gtx_keyframe_indices.restype = ctypes.c_long
    lib.gtx_keyframe_indices.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_long),
                                         ctypes.c_long]
    _lib = lib
    return lib


def load_encoder_library() -> ctypes.CDLL:
    """The MPEG-4 encoder library, built if needed; raises ``RuntimeError``
    or ``OSError`` when it cannot be built or loaded."""
    global _enc_lib
    if _enc_lib is not None:
        return _enc_lib
    lib = ctypes.CDLL(str(build(ENCODER_SOURCE)))
    lib.gtx_enc_open.restype = ctypes.c_void_p
    lib.gtx_enc_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_double,
                                 ctypes.c_long]
    lib.gtx_enc_write.restype = ctypes.c_int
    lib.gtx_enc_write.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.gtx_enc_close.restype = ctypes.c_int
    lib.gtx_enc_close.argtypes = [ctypes.c_void_p]
    _enc_lib = lib
    return lib


def native_probe(path: str):
    """(width, height, fps, frame_count) of a video, or None when the
    decoder cannot open it."""
    lib = load_library()
    handle = lib.gtx_open(str(path).encode())
    if not handle:
        return None
    try:
        return (lib.gtx_width(handle), lib.gtx_height(handle), lib.gtx_fps(handle),
                int(lib.gtx_frame_count(handle)))
    finally:
        lib.gtx_close(handle)


def native_frames(path: str) -> Iterator[tuple[int, np.ndarray]]:
    """Yield (index, RGB frame) sequentially from the native decoder."""
    lib = load_library()
    handle = lib.gtx_open(str(path).encode())
    if not handle:
        raise OSError(f"native decoder failed to open {path}")
    try:
        h, w = lib.gtx_height(handle), lib.gtx_width(handle)
        idx = 0
        while True:
            frame = np.empty((h, w, 3), dtype=np.uint8)
            rc = lib.gtx_read_frame(handle, frame.ctypes.data_as(ctypes.c_void_p))
            if rc < 0:
                # C ABI: 1 = clean EOF, <0 = error; an error is not an EOF
                raise OSError(f"native decoder error {rc} at frame {idx} of {path}")
            if rc != 0:
                break
            yield idx, frame
            idx += 1
    finally:
        lib.gtx_close(handle)


def scan_frame_pts(path: str, max_count: int = 1 << 18):
    """Display-order (pts, is_keyframe) arrays of every frame, the index
    ``ParallelVideoReader`` splits on; None when the stream has no usable
    pts or does not open (the caller decodes sequentially)."""
    lib = load_library()
    pts = np.empty(max_count, dtype=np.int64)
    keys = np.empty(max_count, dtype=np.int32)
    n = lib.gtx_scan_pts(str(path).encode(), pts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                         keys.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), max_count)
    if n < 0 or n > max_count:
        return None
    return pts[:n].copy(), keys[:n].copy()


def native_frames_segment(path: str, seg_pts: np.ndarray, first_index: int,
                          seek_pts: int | None = None,
                          threads: int = 1) -> Iterator[tuple[int, np.ndarray]]:
    """Yield (display index, RGB frame) for exactly the frames whose pts are
    in ``seg_pts`` (a contiguous display-order slice of ``scan_frame_pts``).
    Opens its own decoder, seeks backward to ``seek_pts`` (a keyframe at or
    before the segment, with an open-GOP margin) and drops the warm-up
    frames whose pts are not in the segment, so concurrent segments give
    the sequential stream bit for bit."""
    lib = load_library()
    if seek_pts is None:
        seek_pts = int(seg_pts[0])
    handle = lib.gtx_open_at(str(path).encode(), int(seek_pts), threads)
    if not handle:
        raise OSError(f"native decoder failed to open or seek {path}")
    try:
        h, w = lib.gtx_height(handle), lib.gtx_width(handle)
        pts_out = ctypes.c_int64()
        want = {int(p): first_index + i for i, p in enumerate(seg_pts)}
        served = 0
        while served < len(seg_pts):
            frame = np.empty((h, w, 3), dtype=np.uint8)
            rc = lib.gtx_read_frame_pts(handle, frame.ctypes.data_as(ctypes.c_void_p),
                                        ctypes.byref(pts_out))
            if rc < 0:
                raise OSError(f"native decoder error {rc} in a segment of {path}")
            if rc != 0:
                raise OSError(f"end of stream after {served}/{len(seg_pts)} frames of a "
                              f"segment of {path}")
            idx = want.get(int(pts_out.value))
            if idx is None:
                continue  # a warm-up frame before the segment
            yield idx, frame
            served += 1
    finally:
        lib.gtx_close(handle)


def load_remux_library() -> ctypes.CDLL | None:
    """The remux library, built if needed; None when it cannot be built or
    loaded (the tools then decode and re-encode, as the reference's do)."""
    global _remux_lib
    if _remux_lib is not None:
        return _remux_lib
    try:
        lib = ctypes.CDLL(str(build(REMUX_SOURCE)))
    except (OSError, RuntimeError):
        return None
    lib.gtx_remux_concat.restype = ctypes.c_int
    lib.gtx_remux_concat.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                                     ctypes.c_char_p]
    lib.gtx_validate.restype = ctypes.c_int
    lib.gtx_validate.argtypes = [ctypes.c_char_p]
    lib.gtx_remux_cut.restype = ctypes.c_int
    lib.gtx_remux_cut.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64,
                                  ctypes.c_int64]
    _remux_lib = lib
    return lib


def remux_concat(inputs, output) -> bool:
    """Concatenate videos by stream copy (no re-encode) into ``output``;
    False when the library is unavailable or the remux failed (the caller
    decodes and re-encodes)."""
    lib = load_remux_library()
    if lib is None:
        return False
    arr = (ctypes.c_char_p * len(inputs))(*[str(p).encode() for p in inputs])
    return lib.gtx_remux_concat(arr, len(inputs), str(output).encode()) == 0


def remux_cut_frames(path, output, start_frame: int, end_frame: int) -> bool:
    """Stream-copy the display frames [start_frame, end_frame] (inclusive)
    into ``output`` without re-encoding. ``start_frame`` must be a keyframe
    (``io.video.keyframe_indices``) or the head of the clip does not decode,
    the contract of ``ffmpeg -ss .. -c copy``. False when the library or the
    stream's pts map is unavailable, or the range is outside the video (the
    caller decodes and re-encodes)."""
    lib = load_remux_library()
    if lib is None:
        return False
    scan = scan_frame_pts(str(path))
    if scan is None:
        return False
    pts, _keys = scan
    if not 0 <= start_frame <= end_frame < len(pts):
        return False
    return lib.gtx_remux_cut(str(path).encode(), str(output).encode(), int(pts[start_frame]),
                             int(pts[end_frame])) == 0


def validate_video(path) -> bool | None:
    """``ffprobe -v error``'s check: True when the container opens, has a
    video stream and every packet reads; None when the library is
    unavailable (the caller cannot check)."""
    lib = load_remux_library()
    if lib is None:
        return None
    return lib.gtx_validate(str(path).encode()) == 0
