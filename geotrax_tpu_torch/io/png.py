"""A PNG codec of the port's own (no Pillow on the card's machine).

``read_png(path)`` returns (H, W, 3) uint8 RGB, as the reference's
``PIL.Image.open(p).convert("RGB")`` does: 8-bit RGB as it is, RGBA and
gray+alpha with the alpha dropped, 8-bit gray repeated into three channels,
palette images (1, 2, 4 or 8 bits) looked up in their PLTE. 16-bit and
interlaced files raise ``ValueError``. The IDAT stream is inflated with
``zlib`` and unfiltered (None/Sub/Up/Average/Paeth) by ``native/png.cpp``,
built with ``g++`` into ``build/native/`` at first use; a failed build
raises, there is no slower path in Python. ``unfilter_numpy`` is the plain
numpy version the tests hold the native one to.

``write_png(path, rgb)`` writes 8-bit RGB with filter 0 on every row.
``read_png_size(path)`` reads (width, height) from the header alone.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from pathlib import Path

import numpy as np

from geotrax_tpu_torch.io import native

SIGNATURE = b"\x89PNG\r\n\x1a\n"
SOURCE = Path(__file__).resolve().parent / "native" / "png.cpp"
# channels per PNG color type: gray, RGB, palette, gray+alpha, RGBA
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}

_lib = None


def build() -> Path:
    """Compile ``png.cpp`` unless its library exists; return its path.
    Raises ``RuntimeError`` when there is no compiler or the build fails."""
    return native.build_plain(SOURCE)


def load_library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.gtx_png_unfilter.restype = ctypes.c_long
        lib.gtx_png_unfilter.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
                                         ctypes.c_long, ctypes.c_int]
        _lib = lib
    return _lib


def unfilter(data: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """(height, stride) uint8 raw rows of the inflated stream ``data``."""
    src = np.frombuffer(data, np.uint8)
    if src.size != height * (stride + 1):
        raise ValueError(f"PNG image data holds {src.size} bytes, expected "
                         f"{height * (stride + 1)}")
    out = np.empty((height, stride), np.uint8)
    rc = load_library().gtx_png_unfilter(src.ctypes.data, out.ctypes.data, height, stride, bpp)
    if rc != 0:
        raise ValueError(f"PNG row {-rc - 1} has an unknown filter type")
    return out


def unfilter_numpy(data: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """The plain version of ``unfilter``: row by row in numpy, the left
    neighbours of Sub, Average and Paeth one pixel column at a time."""
    rows = np.frombuffer(data, np.uint8).reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(height):
        kind, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        cur = np.zeros(stride + bpp, np.int32)  # bpp zero bytes on the left
        if kind in (0, 2):
            cur[bpp:] = (line + (prev if kind == 2 else 0)) & 0xFF
        elif kind in (1, 3, 4):
            up = np.concatenate([np.zeros(bpp, np.int32), prev])
            for x0 in range(0, stride, bpp):
                sl = slice(bpp + x0, bpp + min(x0 + bpp, stride))
                n = sl.stop - sl.start
                left, above = cur[x0:x0 + n], up[sl]
                if kind == 1:
                    pred = left
                elif kind == 3:
                    pred = (left + above) >> 1
                else:
                    upleft = up[x0:x0 + n]
                    p = left + above - upleft
                    pa, pb, pc = np.abs(p - left), np.abs(p - above), np.abs(p - upleft)
                    pred = np.where((pa <= pb) & (pa <= pc), left,
                                    np.where(pb <= pc, above, upleft))
                cur[sl] = (line[x0:x0 + n] + pred) & 0xFF
        else:
            raise ValueError(f"PNG row {y} has an unknown filter type")
        out[y] = cur[bpp:]
        prev = cur[bpp:]
    return out


def _chunks(blob: bytes):
    if blob[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 8 <= len(blob):
        length, kind = struct.unpack(">I4s", blob[pos:pos + 8])
        yield kind, blob[pos + 8:pos + 8 + length]
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG file ends before its IEND chunk")


def _header(ihdr: bytes) -> tuple:
    return struct.unpack(">IIBBBBB", ihdr)  # w, h, depth, color, compression, filter, interlace


def read_png_size(path) -> tuple:
    """(width, height) of a PNG file, from its header chunk."""
    with open(path, "rb") as fh:
        head = fh.read(33)
    if head[:8] != SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"'{path}' is not a PNG file")
    width, height = struct.unpack(">II", head[16:24])
    return int(width), int(height)


def read_png(path, unfilter_fn=None) -> np.ndarray:
    """(H, W, 3) uint8 RGB of a PNG file (see the module's docstring)."""
    blob = Path(path).read_bytes()
    header, palette, idat = None, None, []
    for kind, body in _chunks(blob):
        if kind == b"IHDR":
            header = _header(body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"'{path}' has no IHDR chunk")
    width, height, depth, color, _, _, interlace = header
    if color not in CHANNELS:
        raise ValueError(f"'{path}': unknown PNG color type {color}")
    if interlace:
        raise ValueError(f"'{path}': interlaced PNG files are not supported")
    if depth == 16:
        raise ValueError(f"'{path}': 16-bit PNG files are not supported")
    if depth != 8 and color != 3:
        raise ValueError(f"'{path}': {depth}-bit PNG files of color type {color} are not "
                         "supported (8-bit, or a palette of 1-8 bits)")
    channels = CHANNELS[color]
    stride = (width * channels * depth + 7) // 8
    raw = (unfilter_fn or unfilter)(zlib.decompress(b"".join(idat)), height, stride,
                                    max(1, channels * depth // 8))
    if color == 3:
        if palette is None:
            raise ValueError(f"'{path}': palette image without a PLTE chunk")
        if depth < 8:
            shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
            raw = ((raw[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(height, -1)
        return palette[raw[:, :width]]
    img = raw.reshape(height, width, channels)
    if channels <= 2:
        return np.repeat(img[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(img[:, :, :3])


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path, rgb: np.ndarray, compress_level: int = 6) -> None:
    """Write (H, W, 3) uint8 ``rgb`` as an 8-bit RGB PNG, filter 0 on every
    row, the stream deflated at ``compress_level``."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"write_png takes (H, W, 3) uint8, got {rgb.shape}")
    height, width = rgb.shape[:2]
    comp = zlib.compressobj(compress_level)
    parts = []
    zero = b"\x00"
    rows_per_piece = max(1, (1 << 24) // (3 * width + 1))
    for y in range(0, height, rows_per_piece):
        piece = rgb[y:y + rows_per_piece].reshape(-1, 3 * width)
        framed = np.empty((piece.shape[0], 3 * width + 1), np.uint8)
        framed[:, 0] = zero[0]
        framed[:, 1:] = piece
        parts.append(comp.compress(framed.tobytes()))
    parts.append(comp.flush())
    ihdr = struct.pack(">IIBBBBB", width, height, 8, 2, 0, 0, 0)
    with open(path, "wb") as fh:
        fh.write(SIGNATURE + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", b"".join(parts))
                 + _chunk(b"IEND", b""))
