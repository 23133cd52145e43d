"""Image sizes from file headers, without decoding the pixels (and without
Pillow or cv2): the PNG IHDR chunk, the JPEG SOF marker, the BMP info header
and the TIFF tags 256/257.

``image_size(path)`` is Pillow's ``Image.open(path).size``;
``image_size(path, exif_orientation=True)`` is the size of
``cv2.imread(path)``, which turns a JPEG by its EXIF orientation (tags 5 to
8 swap width and height).
"""

from __future__ import annotations

import struct
from pathlib import Path

# JPEG start-of-frame markers (baseline, progressive, lossless, arithmetic)
_SOF = {0xC0, 0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF}


def _exif_orientation(app1: bytes) -> int:
    """The orientation tag (0x0112) of an APP1 Exif segment's IFD0; 1 when
    absent."""
    if app1[:6] != b"Exif\0\0" or len(app1) < 14:
        return 1
    tiff = app1[6:]
    bo = {b"II": "<", b"MM": ">"}.get(tiff[:2])
    if bo is None:
        return 1
    ifd = struct.unpack(bo + "I", tiff[4:8])[0]
    if ifd + 2 > len(tiff):
        return 1
    n = struct.unpack(bo + "H", tiff[ifd:ifd + 2])[0]
    for i in range(n):
        entry = tiff[ifd + 2 + 12 * i:ifd + 14 + 12 * i]
        if len(entry) < 12:
            break
        if struct.unpack(bo + "H", entry[:2])[0] == 0x0112:
            return struct.unpack(bo + "H", entry[8:10])[0]
    return 1


def _jpeg_size(fh, exif_orientation: bool) -> tuple:
    orientation = 1
    fh.seek(2)
    while True:
        byte = fh.read(1)
        while byte and byte != b"\xff":
            byte = fh.read(1)
        while byte == b"\xff":
            byte = fh.read(1)
        if not byte:
            raise ValueError("JPEG file ends before its frame header")
        marker = byte[0]
        if marker in (0x01, *range(0xD0, 0xD9)):  # no length
            continue
        length = struct.unpack(">H", fh.read(2))[0]
        body = fh.read(length - 2)
        if marker == 0xE1 and orientation == 1:
            orientation = _exif_orientation(body)
        if marker in _SOF:
            height, width = struct.unpack(">HH", body[1:5])
            if exif_orientation and orientation in (5, 6, 7, 8):
                return height, width
            return width, height


def image_size(path, exif_orientation: bool = False) -> tuple:
    """(width, height) of a PNG, JPEG, BMP or TIFF file."""
    with open(path, "rb") as fh:
        head = fh.read(26)
        if head[:8] == b"\x89PNG\r\n\x1a\n" and head[12:16] == b"IHDR":
            return struct.unpack(">II", head[16:24])
        if head[:2] == b"\xff\xd8":
            return _jpeg_size(fh, exif_orientation)
        if head[:2] == b"BM":
            width, height = struct.unpack("<ii", head[18:26])
            return width, abs(height)
    if head[:4] in (b"II*\0", b"MM\0*", b"II+\0", b"MM\0+"):
        from geotrax_tpu_torch.io.tiff import read_ifd

        _, tags = read_ifd(path)
        return int(tags[256][0]), int(tags[257][0])
    raise ValueError(f"'{Path(path)}': not a PNG, JPEG, BMP or TIFF file")
