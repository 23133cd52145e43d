"""Out-of-core tiled-TIFF window reads and the tiled-TIFF writer.

The port's copy of ``geotrax_tpu/io/tiff_tiled.py``, with the same names
and behaviour: a minimal TIFF IFD parser plus a windowed crop that touches
only the tiles intersecting the request, so a city-scale orthophoto mosaic
is never loaded whole.

Supported: classic (II/MM 42) and BigTIFF (43) headers, tiled RGB(A)/gray
uint8 pages, compression none(1), deflate(8/32946) and PackBits(32773), with
optional horizontal-differencing predictor(2). Stripped or exotically
compressed TIFFs raise ValueError; ``io/tiff.py`` reads those whole.

GeoTIFF tags ride along: ModelTiepoint(33922) / ModelPixelScale(33550)
feed the lat/lng -> pixel mapping. ``write_tiled_tiff`` writes the same
bytes as the reference's writer.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

_TAG_WIDTH = 256
_TAG_LENGTH = 257
_TAG_BITS = 258
_TAG_COMPRESSION = 259
_TAG_SAMPLES = 277
_TAG_PREDICTOR = 317
_TAG_TILE_WIDTH = 322
_TAG_TILE_LENGTH = 323
_TAG_TILE_OFFSETS = 324
_TAG_TILE_COUNTS = 325
_TAG_MODEL_SCALE = 33550
_TAG_MODEL_TIEPOINT = 33922

# TIFF type -> (struct fmt char, size)
_TYPES = {1: ("B", 1), 3: ("H", 2), 4: ("I", 4), 5: ("II", 8), 8: ("h", 2),
          9: ("i", 4), 11: ("f", 4), 12: ("d", 8), 16: ("Q", 8), 17: ("q", 8)}


@dataclass
class TiledTiff:
    """Parsed first page of a tiled TIFF + the open file handle."""

    path: Path
    byteorder: str = "<"
    width: int = 0
    length: int = 0
    tile_width: int = 0
    tile_length: int = 0
    samples: int = 1
    compression: int = 1
    predictor: int = 1
    tile_offsets: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    tile_counts: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    tags: dict = field(default_factory=dict)

    @property
    def tiles_per_row(self) -> int:
        return -(-self.width // self.tile_width)

    def geo_params(self):
        """(lng_0, lat_0, lng_scale, lat_scale) from the GeoTIFF tags, or
        None when the file carries no geo metadata."""
        tie = self.tags.get(_TAG_MODEL_TIEPOINT)
        scale = self.tags.get(_TAG_MODEL_SCALE)
        if tie is None or scale is None or len(tie) < 6 or len(scale) < 2:
            return None
        return float(tie[3]), float(tie[4]), float(scale[0]), float(scale[1])

    def _decode_tile(self, fh, index: int) -> np.ndarray:
        fh.seek(int(self.tile_offsets[index]))
        data = fh.read(int(self.tile_counts[index]))
        if self.compression in (8, 32946):
            data = zlib.decompress(data)
        elif self.compression == 32773:
            data = _unpackbits(data)
        elif self.compression != 1:
            raise ValueError(f"unsupported TIFF compression {self.compression}")
        n = self.tile_length * self.tile_width * self.samples
        arr = np.frombuffer(data[:n], np.uint8).reshape(
            self.tile_length, self.tile_width, self.samples
        )
        if self.predictor == 2:
            arr = np.cumsum(arr.astype(np.uint32), axis=1).astype(np.uint8)
        return arr

    def read_window(self, i0: int, j0: int, h: int, w: int) -> np.ndarray:
        """(h, w, samples) uint8 crop with top-left (row i0, col j0); only the
        intersecting tiles are read and decoded."""
        if h < 1 or w < 1:
            raise ValueError("h and w must be strictly positive.")
        if i0 < 0 or j0 < 0 or i0 + h > self.length or j0 + w > self.width:
            raise ValueError(
                f"Requested crop [({i0},{i0 + h}),({j0},{j0 + w})] is out of "
                f"image bounds ({self.length},{self.width})"
            )
        ti0, tj0 = i0 // self.tile_length, j0 // self.tile_width
        ti1 = -(-(i0 + h) // self.tile_length)
        tj1 = -(-(j0 + w) // self.tile_width)
        out = np.zeros(
            ((ti1 - ti0) * self.tile_length, (tj1 - tj0) * self.tile_width,
             self.samples), np.uint8,
        )
        with open(self.path, "rb") as fh:
            for ti in range(ti0, ti1):
                for tj in range(tj0, tj1):
                    tile = self._decode_tile(fh, ti * self.tiles_per_row + tj)
                    oi = (ti - ti0) * self.tile_length
                    oj = (tj - tj0) * self.tile_width
                    out[oi:oi + self.tile_length, oj:oj + self.tile_width] = tile
        oi0, oj0 = i0 - ti0 * self.tile_length, j0 - tj0 * self.tile_width
        return out[oi0:oi0 + h, oj0:oj0 + w]


def _unpackbits(data: bytes) -> bytes:
    out = bytearray()
    i = 0
    while i < len(data):
        n = data[i]
        i += 1
        if n < 128:
            out += data[i:i + n + 1]
            i += n + 1
        elif n > 128:
            out += data[i:i + 1] * (257 - n)
            i += 1
    return bytes(out)


def _read_values(fh, bo: str, ftype: int, count: int, payload: bytes, big: bool):
    fmt, size = _TYPES.get(ftype, ("B", 1))
    if ftype == 5:  # RATIONAL: pairs of uint32
        fmt, size = "I", 4
        count *= 2
    total = size * count
    inline = 8 if big else 4
    if total <= inline:
        raw = payload[:total]
    else:
        offset = struct.unpack(bo + ("Q" if big else "I"), payload[:inline])[0]
        pos = fh.tell()
        fh.seek(offset)
        raw = fh.read(total)
        fh.seek(pos)
    return list(struct.unpack(f"{bo}{count}{fmt}", raw))


def open_tiled_tiff(path) -> TiledTiff:
    """Parse the first IFD of ``path``; raises ValueError for non-tiled or
    unsupported layouts (callers fall back to a whole-image load)."""
    path = Path(path)
    with open(path, "rb") as fh:
        head = fh.read(8)
        if head[:2] == b"II":
            bo = "<"
        elif head[:2] == b"MM":
            bo = ">"
        else:
            raise ValueError("not a TIFF file")
        magic = struct.unpack(bo + "H", head[2:4])[0]
        big = magic == 43
        if magic not in (42, 43):
            raise ValueError("not a TIFF file")
        if big:
            fh.seek(8)
            ifd_off = struct.unpack(bo + "Q", fh.read(8))[0]
            n_fmt, entry_size = "Q", 20
        else:
            ifd_off = struct.unpack(bo + "I", head[4:8])[0]
            n_fmt, entry_size = "H", 12
        fh.seek(ifd_off)
        n_entries = struct.unpack(bo + n_fmt, fh.read(struct.calcsize(n_fmt)))[0]
        tags: dict = {}
        for _ in range(int(n_entries)):
            entry = fh.read(entry_size)
            if big:
                tag, ftype = struct.unpack(bo + "HH", entry[:4])
                count = struct.unpack(bo + "Q", entry[4:12])[0]
                payload = entry[12:]
            else:
                tag, ftype = struct.unpack(bo + "HH", entry[:4])
                count = struct.unpack(bo + "I", entry[4:8])[0]
                payload = entry[8:]
            if ftype in _TYPES:
                tags[tag] = _read_values(fh, bo, ftype, int(count), payload, big)

    # every tag read below must be present (a tag stored with a field type
    # outside _TYPES was dropped above) — keep the error a ValueError so
    # callers can fall back to a whole-image load
    required = (_TAG_TILE_WIDTH, _TAG_TILE_OFFSETS, _TAG_TILE_LENGTH,
                _TAG_TILE_COUNTS, _TAG_WIDTH, _TAG_LENGTH)
    if any(t not in tags for t in required):
        raise ValueError("TIFF is not tiled (or required tags unreadable)")
    bits = tags.get(_TAG_BITS, [8])
    if any(b != 8 for b in bits):
        raise ValueError("only 8-bit samples supported")
    return TiledTiff(
        path=path,
        byteorder=bo,
        width=int(tags[_TAG_WIDTH][0]),
        length=int(tags[_TAG_LENGTH][0]),
        tile_width=int(tags[_TAG_TILE_WIDTH][0]),
        tile_length=int(tags[_TAG_TILE_LENGTH][0]),
        samples=int(tags.get(_TAG_SAMPLES, [1])[0]),
        compression=int(tags.get(_TAG_COMPRESSION, [1])[0]),
        predictor=int(tags.get(_TAG_PREDICTOR, [1])[0]),
        tile_offsets=np.asarray(tags[_TAG_TILE_OFFSETS], np.int64),
        tile_counts=np.asarray(tags[_TAG_TILE_COUNTS], np.int64),
        tags=tags,
    )


def write_tiled_tiff(path, image: np.ndarray, tile: int = 256,
                     geo: tuple | None = None) -> None:
    """Write ``image`` (H,W,C) uint8 as an uncompressed tiled TIFF (+ optional
    GeoTIFF tags ``geo`` = (lng_0, lat_0, lng_scale, lat_scale)). Exists so
    tests and synthetic-data tooling can produce inputs for read_window
    without external writers."""
    image = np.ascontiguousarray(image)
    if image.ndim == 2:
        image = image[:, :, None]
    h, w, c = image.shape
    th = tw = int(tile)
    tiles_y, tiles_x = -(-h // th), -(-w // tw)
    tile_data = []
    for ty in range(tiles_y):
        for tx in range(tiles_x):
            block = np.zeros((th, tw, c), np.uint8)
            ys, xs = ty * th, tx * tw
            sub = image[ys:ys + th, xs:xs + tw]
            block[: sub.shape[0], : sub.shape[1]] = sub
            tile_data.append(block.tobytes())

    entries = []  # (tag, type, count, values)
    n_tiles = len(tile_data)
    entries.append((_TAG_WIDTH, 4, 1, [w]))
    entries.append((_TAG_LENGTH, 4, 1, [h]))
    entries.append((_TAG_BITS, 3, c, [8] * c))
    entries.append((_TAG_COMPRESSION, 3, 1, [1]))
    entries.append((262, 3, 1, [2 if c >= 3 else 1]))  # photometric
    entries.append((_TAG_SAMPLES, 3, 1, [c]))
    entries.append((_TAG_TILE_WIDTH, 3, 1, [tw]))
    entries.append((_TAG_TILE_LENGTH, 3, 1, [th]))
    entries.append((_TAG_TILE_OFFSETS, 4, n_tiles, None))  # patched below
    entries.append((_TAG_TILE_COUNTS, 4, n_tiles, [len(t) for t in tile_data]))
    if geo is not None:
        lng_0, lat_0, lng_scale, lat_scale = geo
        entries.append((_TAG_MODEL_SCALE, 12, 3, [lng_scale, lat_scale, 0.0]))
        entries.append((_TAG_MODEL_TIEPOINT, 12, 6,
                        [0.0, 0.0, 0.0, lng_0, lat_0, 0.0]))
    entries.sort(key=lambda e: e[0])

    header_size = 8
    ifd_size = 2 + 12 * len(entries) + 4
    # external value areas come after the IFD; tiles after those
    pos = header_size + ifd_size
    ext: dict[int, tuple[int, bytes]] = {}
    for tag, ftype, count, values in entries:
        fmt, size = _TYPES[ftype]
        if values is None:
            continue
        total = size * count
        if total > 4:
            ext[tag] = (pos, struct.pack(f"<{count}{fmt}", *values))
            pos += total
    offsets_pos = pos if 4 * n_tiles > 4 else None
    if offsets_pos is not None:
        pos += 4 * n_tiles
    tile_offsets = []
    for t in tile_data:
        tile_offsets.append(pos)
        pos += len(t)

    with open(path, "wb") as fh:
        fh.write(b"II" + struct.pack("<HI", 42, 8))
        fh.write(struct.pack("<H", len(entries)))
        for tag, ftype, count, values in entries:
            fmt, size = _TYPES[ftype]
            if tag == _TAG_TILE_OFFSETS:
                values = tile_offsets
            total = size * count
            fh.write(struct.pack("<HHI", tag, ftype, count))
            if total <= 4:
                payload = struct.pack(f"<{count}{fmt}", *values)
                fh.write(payload + b"\0" * (4 - total))
            elif tag == _TAG_TILE_OFFSETS and offsets_pos is not None:
                fh.write(struct.pack("<I", offsets_pos))
            else:
                fh.write(struct.pack("<I", ext[tag][0]))
        fh.write(struct.pack("<I", 0))  # next IFD
        for tag in sorted(ext):
            fh.write(ext[tag][1])
        if offsets_pos is not None:
            fh.write(struct.pack(f"<{n_tiles}I", *tile_offsets))
        for t in tile_data:
            fh.write(t)
