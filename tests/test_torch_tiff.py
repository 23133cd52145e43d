"""The port's TIFF readers and writer against the JAX package and Pillow.

- ``io/tiff_tiled.py`` against ``geotrax_tpu/io/tiff_tiled.py``: the
  writer's files byte-equal, ``open_tiled_tiff``'s fields, ``geo_params``
  and ``read_window``'s crops equal, the same ``ValueError``s.
- ``io/tiff.py:read_tiff`` against Pillow's ``convert("RGB")`` (the
  reference reads the orthophoto so): Pillow-written strips (none, LZW,
  deflate, PackBits, JPEG; gray, gray + alpha, RGB, RGBA, palette; with the
  horizontal predictor), ``write_tiled_tiff`` tiles, compressed tiles,
  big-endian and BigTIFF files; pixels equal. Where Pillow cannot read a
  file the JAX package's ``open_tiled_tiff`` is the oracle.
- The native LZW and PackBits decoders against their plain versions.
- Every unsupported layout raises ``ValueError`` naming its tag and value.
- The committed fixtures of tests/data/tiff against their digests.
"""

import hashlib
import io
import json
import re
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from geotrax_tpu.io import tiff_tiled as jtiled
from geotrax_tpu_torch.io import native, tiff
from geotrax_tpu_torch.io import tiff_tiled as ttiled

torch.set_num_threads(1)
FIXTURES = Path(__file__).resolve().parent / "data" / "tiff"


def scene(h, w, c, seed):
    """Blocky content with noisy rows: long runs and edges."""
    rng = np.random.default_rng(seed)
    img = np.kron(rng.integers(0, 255, (h // 5 + 1, w // 5 + 1, c)), np.ones((5, 5, 1)))
    img = img[:h, :w].astype(np.uint8)
    img[::9] = rng.integers(0, 255, img[::9].shape)
    return img


def pillow(path):
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


# ---------------------------------------------------------------------------
# tiff_tiled: the reference's module, copied
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,tile,geo", [((70, 90, 3), 32, (126.6, 37.4, 1.1e-6, 9e-7)),
                                            ((64, 64, 1), 16, None), ((33, 47, 4), 16, None),
                                            ((20, 30), 64, (1.0, 2.0, 0.5, 0.25))])
def test_tiled_writer_reader_and_window_equal_the_reference(tmp_path, shape, tile, geo):
    img = scene(shape[0], shape[1], shape[2] if len(shape) == 3 else 1, sum(shape))
    img = img.reshape(shape)
    ttiled.write_tiled_tiff(tmp_path / "t.tif", img, tile=tile, geo=geo)
    jtiled.write_tiled_tiff(tmp_path / "j.tif", img, tile=tile, geo=geo)
    assert (tmp_path / "t.tif").read_bytes() == (tmp_path / "j.tif").read_bytes()
    ours = ttiled.open_tiled_tiff(tmp_path / "t.tif")
    ref = jtiled.open_tiled_tiff(tmp_path / "t.tif")
    for name in ("byteorder", "width", "length", "tile_width", "tile_length", "samples",
                 "compression", "predictor", "tiles_per_row", "tags"):
        assert getattr(ours, name) == getattr(ref, name), name
    np.testing.assert_array_equal(ours.tile_offsets, ref.tile_offsets)
    assert ours.geo_params() == ref.geo_params()
    h, w = shape[:2]
    for window in ((0, 0, h, w), (3, 5, 7, 11), (h - 4, w - 9, 4, 9),
                   (min(tile, h - 1) - 1, 1, 2, w - 2)):
        np.testing.assert_array_equal(ours.read_window(*window), ref.read_window(*window))
    # the whole-image reader reads the writer's tiles as Pillow does
    np.testing.assert_array_equal(tiff.read_tiff(tmp_path / "t.tif"), pillow(tmp_path / "t.tif"))
    for bad in ((0, 0, 0, 1), (0, 0, h + 1, 1), (-1, 0, 1, 1)):
        with pytest.raises(ValueError) as want:
            ref.read_window(*bad)
        with pytest.raises(ValueError, match=re.escape(str(want.value))):
            ours.read_window(*bad)


def test_tiled_reader_errors_equal_the_reference(tmp_path):
    Image.fromarray(scene(20, 30, 3, 1)).save(tmp_path / "stripped.tif")
    (tmp_path / "junk.tif").write_bytes(b"GIF89a" + bytes(20))
    bits16 = write_tiff(tmp_path / "b16.tif", scene(8, 8, 1, 2).astype(np.uint16) * 200,
                        tiles=(16, 16))
    for path in (tmp_path / "stripped.tif", tmp_path / "junk.tif", bits16):
        with pytest.raises(ValueError) as want:
            jtiled.open_tiled_tiff(path)
        with pytest.raises(ValueError, match=re.escape(str(want.value))):
            ttiled.open_tiled_tiff(path)


# ---------------------------------------------------------------------------
# a minimal writer for the layouts Pillow does not write
# ---------------------------------------------------------------------------

def write_tiff(path, img, tiles=None, rows=None, compress=lambda b: b, compression=1,
               predictor=1, photometric=None, big=False, bo="<", extra=None) -> Path:
    """Write ``img`` (H,W[,C], uint8 or uint16) as one TIFF page: tiles of
    ``tiles`` = (tw, tl) or strips of ``rows``, each block passed through
    ``compress`` (after the horizontal predictor when ``predictor`` is 2),
    classic or BigTIFF, in byte order ``bo``; ``extra`` adds or replaces
    tags as {tag: (type, values)}."""
    img = img if img.ndim == 3 else img[:, :, None]
    h, w, c = img.shape
    blocks = []
    if tiles:
        tw, tl = tiles
        for y in range(0, h, tl):
            for x in range(0, w, tw):
                block = np.zeros((tl, tw, c), img.dtype)
                sub = img[y:y + tl, x:x + tw]
                block[:sub.shape[0], :sub.shape[1]] = sub
                blocks.append(block)
    else:
        rows = rows or h
        blocks = [img[y:y + rows] for y in range(0, h, rows)]
    data = []
    for block in blocks:
        if predictor == 2:
            block = block.copy()
            block[:, 1:] = np.diff(block, axis=1)
        data.append(compress(block.astype(img.dtype.newbyteorder(bo)).tobytes()))
    bits = 8 * img.dtype.itemsize
    off_type = 16 if big else 4
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * c), 259: (3, [compression]),
            262: (3, [photometric if photometric is not None else (2 if c >= 3 else 1)]),
            277: (3, [c]), 317: (3, [predictor])}
    if c in (2, 4):
        tags[338] = (3, [2])
    if tiles:
        tags.update({322: (3, [tiles[0]]), 323: (3, [tiles[1]]), 324: (off_type, None),
                     325: (off_type, [len(d) for d in data])})
    else:
        tags.update({278: (3, [rows]), 273: (off_type, None),
                     279: (off_type, [len(d) for d in data])})
    tags.update(extra or {})
    fmt = {1: "B", 3: "H", 4: "I", 12: "d", 16: "Q"}
    size = {1: 1, 3: 2, 4: 4, 12: 8, 16: 8}
    inline, entry = (8, 20) if big else (4, 12)
    head = 16 if big else 8
    ifd_size = (8 if big else 2) + entry * len(tags) + (8 if big else 4)
    pos = head + ifd_size
    ext = {}
    offsets_tag = 324 if tiles else 273
    values = dict(tags)
    # external value areas after the IFD, then the blocks
    lengths = {t: size[ty] * (len(data) if v is None else len(v)) for t, (ty, v) in tags.items()}
    for t in sorted(tags):
        if lengths[t] > inline:
            ext[t] = pos
            pos += lengths[t]
    block_pos = []
    for d in data:
        block_pos.append(pos)
        pos += len(d)
    values[offsets_tag] = (off_type, block_pos)
    out = bytearray(b"II" if bo == "<" else b"MM")
    if big:
        out += struct.pack(bo + "HHHQ", 43, 8, 0, head)
    else:
        out += struct.pack(bo + "HI", 42, head)
    out += struct.pack(bo + ("Q" if big else "H"), len(tags))
    for t in sorted(tags):
        ty, v = values[t]
        out += struct.pack(bo + "HH", t, ty) + struct.pack(bo + ("Q" if big else "I"), len(v))
        raw = struct.pack(f"{bo}{len(v)}{fmt[ty]}", *v)
        if len(raw) <= inline:
            out += raw + bytes(inline - len(raw))
        else:
            out += struct.pack(bo + ("Q" if big else "I"), ext[t])
    out += bytes(8 if big else 4)
    for t in sorted(ext):
        ty, v = values[t]
        out += struct.pack(f"{bo}{len(v)}{fmt[ty]}", *v)
    for d in data:
        out += d
    Path(path).write_bytes(bytes(out))
    return Path(path)


def pillow_strip(block: bytes, width: int, samples: int, compression: str) -> bytes:
    """``block`` (raw rows of ``width`` x ``samples``) compressed by Pillow's
    libtiff writer as one strip: how a TIFF file stores an LZW block."""
    buf = io.BytesIO()
    arr = np.frombuffer(block, np.uint8).reshape(-1, width, samples)
    Image.fromarray(arr if arr.shape[2] > 1 else arr[:, :, 0]).save(
        buf, "TIFF", compression=compression)
    buf.seek(0)
    with Image.open(buf) as im:
        off, cnt = im.tag_v2[273][0], im.tag_v2[279][0]
    return buf.getvalue()[off:off + cnt]


# ---------------------------------------------------------------------------
# read_tiff against Pillow
# ---------------------------------------------------------------------------

MODES = {"RGB": 3, "RGBA": 4, "L": 1, "LA": 2}


# Pillow writes JPEG-in-TIFF of RGB and L only
STRIP_CASES = [(c, m) for c in (None, "tiff_lzw", "tiff_adobe_deflate", "tiff_deflate", "packbits",
                                "jpeg")
               for m in list(MODES) + ["P"] if c != "jpeg" or m in ("RGB", "L")]


@pytest.mark.parametrize("compression,mode", STRIP_CASES)
def test_pillow_strips(tmp_path, compression, mode):
    img = scene(61, 83, 3, 7)
    im = (Image.fromarray(img).convert("P", palette=Image.ADAPTIVE, colors=50) if mode == "P"
          else Image.fromarray(scene(61, 83, MODES[mode], 7).squeeze(), mode))
    kw = {"strip_size": 1500}  # several strips, the last one short
    if compression:
        kw["compression"] = compression
    predictors = [1, 2] if compression in ("tiff_lzw", "tiff_adobe_deflate") else [1]
    for pred in predictors:
        path = tmp_path / f"{pred}.tif"
        im.save(path, "TIFF", **kw, **({"tiffinfo": {317: 2}} if pred == 2 else {}))
        _, tags = tiff.read_ifd(path)
        assert tags.get(317, [1])[0] == pred
        assert len(tags[273]) > 1 or compression in (None, "jpeg")
        np.testing.assert_array_equal(tiff.read_tiff(path), pillow(path))


@pytest.mark.parametrize("compression", ["raw", "lzw", "deflate", "packbits"])
@pytest.mark.parametrize("layout", ["tiles-le", "tiles-be-big", "strips-be", "strips-big"])
def test_compressed_tiles_big_endian_and_bigtiff(tmp_path, compression, layout):
    img = scene(45, 70, 3, 11)
    code = {"raw": 1, "lzw": 5, "deflate": 8, "packbits": 32773}[compression]
    width = 32 if layout.startswith("tiles") else 70
    compress = {"raw": lambda b: b, "deflate": zlib.compress,
                "lzw": lambda b: pillow_strip(b, width, 3, "tiff_lzw"),
                "packbits": lambda b: pillow_strip(b, width, 3, "packbits")}[compression]
    kw = {"tiles": (32, 16)} if layout.startswith("tiles") else {"rows": 8}
    path = write_tiff(tmp_path / "x.tif", img, compress=compress, compression=code,
                      big="big" in layout, bo=">" if "be" in layout else "<", **kw)
    got = tiff.read_tiff(path)
    np.testing.assert_array_equal(got, img)
    if layout != "tiles-be-big":  # Pillow reads BigTIFF, but not a big-endian one
        np.testing.assert_array_equal(got, pillow(path))
    if layout.startswith("tiles") and compression in ("raw", "deflate", "packbits"):
        ref = jtiled.open_tiled_tiff(path)
        np.testing.assert_array_equal(got, ref.read_window(0, 0, 45, 70))


def test_predictor_on_tiles_and_gray_against_the_reference(tmp_path):
    img = scene(40, 50, 1, 3)[:, :, 0]
    path = write_tiff(tmp_path / "p.tif", img, tiles=(16, 16), compress=zlib.compress,
                      compression=8, predictor=2, big=True)
    want = jtiled.open_tiled_tiff(path).read_window(0, 0, 40, 50)
    np.testing.assert_array_equal(tiff.read_tiff(path), np.repeat(want, 3, axis=2))


# ---------------------------------------------------------------------------
# the native decoders against their plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["blocky", "noise", "flat"])
def test_native_lzw_equals_plain(tmp_path, kind):
    rng = np.random.default_rng(5)
    img = {"blocky": scene(120, 160, 3, 5), "noise": rng.integers(0, 255, (120, 160, 3)),
           "flat": np.full((120, 160, 3), 77)}[kind].astype(np.uint8)
    Image.fromarray(img).save(tmp_path / "l.tif", compression="tiff_lzw")
    _, tags = tiff.read_ifd(tmp_path / "l.tif")
    blob = (tmp_path / "l.tif").read_bytes()
    size = tags[278][0] * 160 * 3
    for off, cnt in zip(tags[273], tags[279]):
        data = blob[off:off + cnt]
        native_out = tiff.lzw_decode(data, size).tobytes()
        assert native_out == tiff.lzw_decode_plain(data, size)
        # a shorter request stops early in both
        assert tiff.lzw_decode(data, 1000).tobytes() == tiff.lzw_decode_plain(data, 1000)
    with pytest.raises(ValueError, match="old-style"):
        tiff.lzw_decode(b"\x00\x01\x02", 10)
    with pytest.raises(ValueError, match="malformed"):
        tiff.lzw_decode(bytes([0x80, 0x7F, 0xF0]), 10)  # clear, then code 4095


def test_native_packbits_equals_the_plain_version_and_the_reference():
    rng = np.random.default_rng(2)
    raw = bytes(np.repeat(rng.integers(0, 255, 400), rng.integers(1, 9, 400)).astype(np.uint8))
    buf = io.BytesIO()
    Image.fromarray(np.frombuffer(raw[:len(raw) // 40 * 40], np.uint8).reshape(-1, 40)).save(
        buf, "TIFF", compression="packbits")
    with Image.open(buf) as im:
        off, cnt = im.tag_v2[273][0], im.tag_v2[279][0]
    data = buf.getvalue()[off:off + cnt] + bytes([128, 0xFE, 7])  # a no-op, then a run of 3
    want = jtiled._unpackbits(data)
    assert ttiled._unpackbits(data) == want
    assert tiff.packbits_decode(data, len(want)).tobytes() == want
    assert tiff.packbits_decode(data, 100).tobytes() == want[:100]


def test_failing_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "tiff.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tiff, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tiff, "_lib", None)
    Image.fromarray(scene(8, 8, 3, 1)).save(tmp_path / "l.tif", compression="tiff_lzw")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for tiff.cpp"):
        tiff.read_tiff(tmp_path / "l.tif")


# ---------------------------------------------------------------------------
# what read_tiff does not read
# ---------------------------------------------------------------------------

UNSUPPORTED = {
    "16-bit": (258, lambda p: write_tiff(p, scene(8, 8, 1, 1).astype(np.uint16))),
    "planar": (284, lambda p: write_tiff(p, scene(8, 8, 3, 1), extra={284: (3, [2])})),
    "float": (339, lambda p: write_tiff(p, scene(8, 8, 1, 1), extra={339: (3, [3])})),
    "zstd": (259, lambda p: write_tiff(p, scene(8, 8, 3, 1), compression=50000)),
    "predictor 3": (317, lambda p: write_tiff(p, scene(8, 8, 3, 1), predictor=3)),
    "YCbCr": (262, lambda p: write_tiff(p, scene(8, 8, 3, 1), photometric=6)),
    "CMYK": (262, lambda p: write_tiff(p, scene(8, 8, 4, 1), photometric=5)),
    "associated alpha": (338, lambda p: write_tiff(p, scene(8, 8, 4, 1),
                                                   extra={338: (3, [1])})),
    "palette without map": (320, lambda p: write_tiff(p, scene(8, 8, 1, 1), photometric=3)),
    "RGB of 2 samples": (277, lambda p: write_tiff(p, scene(8, 8, 2, 1), photometric=2)),
}


@pytest.mark.parametrize("name", list(UNSUPPORTED))
def test_unsupported_layouts_name_their_tag(tmp_path, name):
    tag, make = UNSUPPORTED[name]
    path = make(tmp_path / "u.tif")
    with pytest.raises(ValueError, match=f"tag {tag} "):
        tiff.read_tiff(path)


def test_not_a_tiff(tmp_path):
    (tmp_path / "x.tif").write_bytes(b"\x89PNG\r\n\x1a\n" + bytes(20))
    with pytest.raises(ValueError, match="not a TIFF"):
        tiff.read_ifd(tmp_path / "x.tif")


def test_committed_fixtures_match_their_digests():
    want = json.loads((FIXTURES / "pixels.json").read_text())
    assert sorted(want) == ["deflate_predictor2_rgb.tif", "jpeg_rgb.tif", "lzw_rgb_strips.tif",
                            "packbits_gray.tif", "palette_lzw.tif"]
    for name, digest in want.items():
        assert hashlib.sha1(pillow(FIXTURES / name).tobytes()).hexdigest() == digest, name
        assert hashlib.sha1(tiff.read_tiff(FIXTURES / name).tobytes()).hexdigest() == digest
