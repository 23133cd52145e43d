"""Whole-image TIFF reading for GeoTIFF orthophotos.

The reference reads a ``<loc>.tif`` orthophoto through Pillow twice: its
GeoTIFF tags (``tag_v2``) for the 'metadata-tif' geo source, and its pixels
(``Image.open(p).convert("RGB")``) when it converts the file to the
``<loc>.png`` the rest of the stage reads. The port does both itself:

- ``read_ifd(path)`` parses the header and the first IFD of a classic (42)
  or BigTIFF (43) file in either byte order into ``{tag: [values]}``.
- ``read_tiff(path)`` returns (H, W, 3) uint8 RGB as ``convert("RGB")``
  does: strips or tiles of 8-bit samples, planar configuration 1; gray
  (and gray + alpha) repeated into three channels, RGB as it is, RGBA with
  the alpha dropped, a palette looked up in its ColorMap (each 16-bit entry
  shifted right by 8, as Pillow does); compression none (1), LZW (5),
  deflate (8, 32946) or PackBits (32773), each with or without the
  horizontal predictor (2). LZW and PackBits are decoded by
  ``native/tiff.cpp`` (built with g++ at first use; a failed build raises),
  deflate by ``zlib``. JPEG-compressed files (6, 7) are the one layout read
  through Pillow, imported inside ``_read_jpeg``: the port has no JPEG
  decoder. Any other layout raises ``ValueError`` naming the tag and its
  value.

``lzw_decode_plain`` (and ``tiff_tiled._unpackbits`` for PackBits) are the
plain Python versions the tests hold the native decoders to.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "native" / "tiff.cpp"

TAG_NAMES = {
    256: "ImageWidth", 257: "ImageLength", 258: "BitsPerSample", 259: "Compression",
    262: "PhotometricInterpretation", 273: "StripOffsets", 277: "SamplesPerPixel",
    278: "RowsPerStrip", 279: "StripByteCounts", 284: "PlanarConfiguration", 317: "Predictor",
    320: "ColorMap", 322: "TileWidth", 323: "TileLength", 324: "TileOffsets",
    325: "TileByteCounts", 338: "ExtraSamples", 339: "SampleFormat",
}
# TIFF field type -> (struct format, size); ASCII and UNDEFINED read as bytes
_TYPES = {1: ("B", 1), 2: ("s", 1), 3: ("H", 2), 4: ("I", 4), 5: ("I", 4), 6: ("b", 1),
          7: ("s", 1), 8: ("h", 2), 9: ("i", 4), 10: ("i", 4), 11: ("f", 4), 12: ("d", 8),
          13: ("I", 4), 16: ("Q", 8), 17: ("q", 8), 18: ("Q", 8)}
JPEG = (6, 7)
DECODED = (1, 5, 8, 32946, 32773)  # none, LZW, deflate (two codes), PackBits

_lib = None


def _unsupported(tag: int, value) -> ValueError:
    return ValueError(f"unsupported TIFF layout: tag {tag} {TAG_NAMES.get(tag, '')} = {value}")


def read_ifd(path) -> tuple:
    """(byte order '<' or '>', {tag: [values]}) of the first IFD of
    ``path``. RATIONAL values come as (numerator, denominator) pairs
    flattened, ASCII and UNDEFINED as one ``bytes``."""
    with open(path, "rb") as fh:
        head = fh.read(16)
        if head[:2] == b"II":
            bo = "<"
        elif head[:2] == b"MM":
            bo = ">"
        else:
            raise ValueError(f"'{path}' is not a TIFF file")
        magic = struct.unpack(bo + "H", head[2:4])[0]
        if magic not in (42, 43):
            raise ValueError(f"'{path}' is not a TIFF file")
        big = magic == 43
        if big:
            ifd = struct.unpack(bo + "Q", head[8:16])[0]
            count_fmt, entry_size, inline = "Q", 20, 8
        else:
            ifd = struct.unpack(bo + "I", head[4:8])[0]
            count_fmt, entry_size, inline = "H", 12, 4
        fh.seek(ifd)
        n = struct.unpack(bo + count_fmt, fh.read(struct.calcsize(count_fmt)))[0]
        entries = fh.read(int(n) * entry_size)
        tags = {}
        for i in range(int(n)):
            entry = entries[i * entry_size:(i + 1) * entry_size]
            tag, ftype = struct.unpack(bo + "HH", entry[:4])
            count = struct.unpack(bo + ("Q" if big else "I"), entry[4:4 + inline])[0]
            if ftype not in _TYPES:
                continue
            fmt, size = _TYPES[ftype]
            count *= 2 if ftype in (5, 10) else 1
            total = size * count
            payload = entry[4 + inline:]
            if total <= inline:
                raw = payload[:total]
            else:
                fh.seek(struct.unpack(bo + ("Q" if big else "I"), payload)[0])
                raw = fh.read(total)
            tags[tag] = ([raw] if fmt == "s" else
                         list(struct.unpack(f"{bo}{count}{fmt}", raw)))
    return bo, tags


def load_library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from geotrax_tpu_torch.io import native

        lib = ctypes.CDLL(str(native.build_plain(SOURCE)))
        for name in ("gtx_lzw_decode", "gtx_packbits_decode"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_long
            fn.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long]
        _lib = lib
    return _lib


def _native(name: str, data: bytes, size: int) -> np.ndarray:
    out = np.empty(size, np.uint8)
    n = getattr(load_library(), name)(data, len(data), out.ctypes.data, size)
    if n == -2:
        raise ValueError("old-style (TIFF 5.0) LZW is not supported")
    if n < 0:
        raise ValueError("malformed LZW stream")
    return out[:n]


def lzw_decode(data: bytes, size: int) -> np.ndarray:
    """At most ``size`` bytes (uint8) of TIFF LZW ``data`` (MSB-first
    codes, early change), by ``native/tiff.cpp``."""
    return _native("gtx_lzw_decode", data, size)


def packbits_decode(data: bytes, size: int) -> np.ndarray:
    return _native("gtx_packbits_decode", data, size)


def lzw_decode_plain(data: bytes, size: int) -> bytes:
    """The plain version of ``lzw_decode``, code by code in Python."""
    if len(data) >= 2 and data[0] == 0 and data[1] & 1:
        raise ValueError("old-style (TIFF 5.0) LZW is not supported")
    bits = np.unpackbits(np.frombuffer(data, np.uint8))
    table = [bytes([c]) for c in range(256)] + [b"", b""]  # 256 clear, 257 end
    out, old, pos, width = bytearray(), None, 0, 9
    while pos + width <= len(bits) and len(out) < size:
        code = int("".join(map(str, bits[pos:pos + width])), 2)
        pos += width
        if code == 257:
            break
        if code == 256:
            table, old, width = table[:258], None, 9
            continue
        if old is None:
            if code >= 256:
                raise ValueError("malformed LZW stream")
            out += table[code]
            old = code
            continue
        if code < len(table):
            string = table[code]
        elif code == len(table) and len(table) < 4096:
            string = table[old] + table[old][:1]
        else:
            raise ValueError("malformed LZW stream")
        if len(table) < 4096:
            table.append(table[old] + string[:1])
        out += string
        old = code
        if len(table) + 1 >= (1 << width) and width < 12:
            width += 1
    return bytes(out[:size])


def _first(tags: dict, tag: int, default):
    return int(tags[tag][0]) if tag in tags else default


def _layout(tags: dict) -> dict:
    """The page's layout, or ``ValueError`` naming the first tag outside
    what ``read_tiff`` decodes."""
    for tag in (256, 257):
        if tag not in tags:
            raise ValueError(f"TIFF has no tag {tag} {TAG_NAMES[tag]}")
    samples = _first(tags, 277, 1)
    compression = _first(tags, 259, 1)
    photometric = _first(tags, 262, None)
    if compression not in DECODED and compression not in JPEG:
        raise _unsupported(259, compression)
    bits = tags.get(258, [1])
    if any(b != 8 for b in bits):
        raise _unsupported(258, tuple(bits))
    if _first(tags, 284, 1) != 1:
        raise _unsupported(284, _first(tags, 284, 1))
    if any(f != 1 for f in tags.get(339, [1])):
        raise _unsupported(339, tuple(tags[339]))
    if _first(tags, 317, 1) not in (1, 2):
        raise _unsupported(317, _first(tags, 317, 1))
    if compression not in JPEG:
        base = {1: 1, 2: 3, 3: 1}.get(photometric)
        if base is None:
            raise _unsupported(262, photometric)
        if samples not in (base, base + 1) or (photometric == 3 and samples != 1):
            raise _unsupported(277, samples)
        if samples > base and any(e == 1 for e in tags.get(338, [0])):
            # Pillow un-premultiplies an associated alpha before it drops it
            raise _unsupported(338, tuple(tags[338]))
        if photometric == 3 and len(tags.get(320, ())) != 3 * 256:
            raise _unsupported(320, f"{len(tags.get(320, ()))} entries")
    tiled = 322 in tags
    for tag in ((322, 323, 324, 325) if tiled else (273, 279)):
        if tag not in tags:
            raise ValueError(f"TIFF has no tag {tag} {TAG_NAMES[tag]}")
    return {"width": int(tags[256][0]), "length": int(tags[257][0]), "samples": samples,
            "compression": compression, "photometric": photometric,
            "predictor": _first(tags, 317, 1), "tiled": tiled}


def _read_jpeg(path) -> np.ndarray:
    """A JPEG-compressed TIFF through Pillow: the port has no JPEG decoder."""
    from PIL import Image

    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"))


def _decode(data: bytes, size: int, compression: int) -> bytes:
    if compression == 5:
        return lzw_decode(data, size)
    if compression in (8, 32946):
        return zlib.decompressobj().decompress(data, size)
    if compression == 32773:
        return packbits_decode(data, size)
    return data[:size]


def _block(data: bytes, rows: int, cols: int, samples: int, predictor: int, what: str):
    need = rows * cols * samples
    if len(data) < need:
        raise ValueError(f"TIFF {what} holds {len(data)} bytes, expected {need}")
    arr = np.frombuffer(data, np.uint8, need).reshape(rows, cols, samples)
    if predictor == 2:
        arr = np.cumsum(arr, axis=1, dtype=np.uint8)
    return arr


def read_tiff(path) -> np.ndarray:
    """(H, W, 3) uint8 RGB of the first page of a TIFF file, as Pillow's
    ``convert("RGB")`` gives it (see the module's docstring)."""
    _, tags = read_ifd(path)
    lay = _layout(tags)
    if lay["compression"] in JPEG:
        return _read_jpeg(path)
    h, w, s = lay["length"], lay["width"], lay["samples"]
    comp, pred = lay["compression"], lay["predictor"]
    img = np.empty((h, w, s), np.uint8)
    with open(path, "rb") as fh:
        def chunk(offset, count, size):
            fh.seek(int(offset))
            return _decode(fh.read(int(count)), size, comp)

        if lay["tiled"]:
            tw, tl = int(tags[322][0]), int(tags[323][0])
            across = -(-w // tw)
            offsets, counts = tags[324], tags[325]
            if len(offsets) < across * -(-h // tl):
                raise ValueError(f"TIFF has {len(offsets)} tiles, expected {across * -(-h // tl)}")
            for i, (off, cnt) in enumerate(zip(offsets, counts)):
                y, x = (i // across) * tl, (i % across) * tw
                if y >= h:
                    break
                tile = _block(chunk(off, cnt, tl * tw * s), tl, tw, s, pred, f"tile {i}")
                img[y:y + tl, x:x + tw] = tile[:h - y, :w - x]
        else:
            rps = min(_first(tags, 278, h), h)
            offsets, counts = tags[273], tags[279]
            if len(offsets) < -(-h // rps):
                raise ValueError(f"TIFF has {len(offsets)} strips, expected {-(-h // rps)}")
            for i, (off, cnt) in enumerate(zip(offsets, counts)):
                y = i * rps
                if y >= h:
                    break
                rows = min(rps, h - y)
                img[y:y + rows] = _block(chunk(off, cnt, rows * w * s), rows, w, s, pred,
                                         f"strip {i}")
    if lay["photometric"] == 3:
        cmap = (np.asarray(tags[320], np.uint16) >> 8).astype(np.uint8).reshape(3, 256).T
        return cmap[img[..., 0]]
    if lay["photometric"] == 1:
        return np.repeat(img[..., :1], 3, axis=2)
    return img if s == 3 else np.ascontiguousarray(img[..., :3])
