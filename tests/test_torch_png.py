"""The port's PNG codec (geotrax_tpu_torch/io/png.py, native/png.cpp)
against Pillow, the reference's image library: every file reads back equal
to ``np.asarray(Image.open(p).convert("RGB"))``, through the native
unfilter and through its plain numpy version; the port's writer reads back
equal in Pillow."""

import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from geotrax_tpu_torch.io import png


def image(h, w, seed):
    rng = np.random.default_rng(seed)
    img = np.kron(rng.integers(0, 256, (h // 4 + 1, w // 4 + 1, 3)), np.ones((4, 4, 1)))
    img = img[:h, :w] + rng.integers(0, 20, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def pillow(path):
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def both_reads(path):
    native = png.read_png(path)
    plain = png.read_png(path, unfilter_fn=png.unfilter_numpy)
    np.testing.assert_array_equal(native, plain)
    return native


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "P", "P16", "P2", "LA"])
def test_pillow_files(tmp_path, mode):
    rgb = image(37, 53, 1)
    if mode == "RGB":
        im = Image.fromarray(rgb)
    elif mode == "RGBA":
        im = Image.fromarray(np.dstack([rgb, rgb[..., :1]]), "RGBA")
    elif mode == "L":
        im = Image.fromarray(rgb[..., 0])
    elif mode == "LA":
        im = Image.fromarray(np.dstack([rgb[..., 0], rgb[..., 1]]), "LA")
    elif mode == "P":
        im = Image.fromarray(rgb).convert("P", palette=Image.Palette.ADAPTIVE, colors=256)
    else:  # 16 and 4 colours: Pillow writes 4- and 2-bit palettes
        im = Image.fromarray(rgb).quantize(int(mode[1:]))
    path = tmp_path / f"{mode}.png"
    im.save(path)
    if mode == "P16":
        assert png._header(open(path, "rb").read()[16:29])[2] == 4  # a 4-bit palette
    np.testing.assert_array_equal(both_reads(path), pillow(path))
    assert png.read_png_size(path) == (53, 37)


def filtered(raw: np.ndarray, kinds, bpp: int) -> bytes:
    """The IDAT stream of (H, stride) ``raw``, row y filtered with
    ``kinds[y % len(kinds)]``."""
    out = []
    prev = np.zeros(raw.shape[1], np.int32)
    for y, row in enumerate(raw.astype(np.int32)):
        kind = kinds[y % len(kinds)]
        left = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        if kind == 0:
            f = row
        elif kind == 1:
            f = row - left
        elif kind == 2:
            f = row - prev
        elif kind == 3:
            f = row - (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            f = row - np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        out.append(bytes([kind]) + (f & 0xFF).astype(np.uint8).tobytes())
        prev = row
    return b"".join(out)


def encode(path, raw, width, height, color, kinds, interlace=0):
    """A PNG of 8-bit (H, stride) ``raw`` with the given row filters."""
    body = filtered(raw, kinds, png.CHANNELS[color])
    with open(path, "wb") as fh:
        fh.write(png.SIGNATURE
                 + png._chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, color, 0, 0,
                                                   interlace))
                 + png._chunk(b"IDAT", zlib.compress(body)) + png._chunk(b"IEND", b""))


@pytest.mark.parametrize("kinds", [[0], [1], [2], [3], [4], [0, 1, 2, 3, 4]])
@pytest.mark.parametrize("color", [2, 6])
def test_every_filter_type(tmp_path, kinds, color):
    rgb = image(23, 31, 2)
    pix = rgb if color == 2 else np.dstack([rgb, 255 - rgb[..., :1]])
    path = tmp_path / "f.png"
    encode(path, pix.reshape(23, -1), 31, 23, color, kinds)
    out = both_reads(path)
    np.testing.assert_array_equal(out, pillow(path))
    np.testing.assert_array_equal(out, rgb)


def test_writer_reads_back_in_pillow(tmp_path):
    rgb = image(41, 67, 3)
    for level in (1, 6):
        path = tmp_path / f"w{level}.png"
        png.write_png(path, rgb, compress_level=level)
        np.testing.assert_array_equal(pillow(path), rgb)
        np.testing.assert_array_equal(both_reads(path), rgb)
    with pytest.raises(ValueError):
        png.write_png(tmp_path / "x.png", rgb[..., 0])


def test_refuses_16_bit_and_interlaced(tmp_path):
    path = tmp_path / "i16.png"
    Image.fromarray(np.arange(64, dtype=np.uint16).reshape(8, 8) * 1000).save(path)
    with pytest.raises(ValueError, match="16-bit"):
        png.read_png(path)
    path = tmp_path / "adam7.png"
    encode(path, image(8, 8, 4).reshape(8, -1), 8, 8, 2, [0], interlace=1)
    with pytest.raises(ValueError, match="interlaced"):
        png.read_png(path)
    (tmp_path / "bad.png").write_bytes(b"GIF89a")
    with pytest.raises(ValueError, match="not a PNG"):
        png.read_png(tmp_path / "bad.png")


def test_failing_build_raises(tmp_path, monkeypatch):
    """A source g++ cannot build raises RuntimeError on the first read;
    nothing carries on in Python."""
    bad = tmp_path / "png.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(png, "SOURCE", bad)
    monkeypatch.setattr(png.native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(png, "_lib", None)
    path = tmp_path / "ok.png"
    png.write_png(path, image(8, 8, 5))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for png.cpp"):
        png.read_png(path)
