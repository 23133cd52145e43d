"""Write the small compressed TIFF fixtures of tests/data/tiff with Pillow
and their pixel digests (SHA-1 of Pillow's ``convert("RGB")`` bytes) into
tests/data/tiff/pixels.json. ``chip_smoke.py``'s features phase decodes
them with ``geotrax_tpu_torch.io.tiff.read_tiff`` on a machine where both
Pillow (for the JPEG one) and g++ (for LZW) run, and
tests/test_torch_tiff.py holds the files to the digests here.

    python tests/make_torch_tiff_fixtures.py
"""

import hashlib
import json
from pathlib import Path

import numpy as np
from PIL import Image

OUT = Path(__file__).resolve().parent / "data" / "tiff"


def scene(h: int = 48, w: int = 72, seed: int = 5) -> np.ndarray:
    """A blocky RGB scene with a few noisy rows: runs for LZW and PackBits,
    edges for the predictor."""
    rng = np.random.default_rng(seed)
    img = np.kron(rng.integers(0, 255, (h // 6, w // 6, 3)), np.ones((6, 6, 1))).astype(np.uint8)
    img[::11] = rng.integers(0, 255, img[::11].shape)
    return img


def pixel_sha1(path: Path) -> str:
    with Image.open(path) as img:
        return hashlib.sha1(np.asarray(img.convert("RGB")).tobytes()).hexdigest()


def main() -> None:
    OUT.mkdir(parents=True, exist_ok=True)
    rgb = scene()
    files = {
        "lzw_rgb_strips.tif": (Image.fromarray(rgb), {"compression": "tiff_lzw",
                                                      "strip_size": 1024}),
        "deflate_predictor2_rgb.tif": (Image.fromarray(rgb), {"compression": "tiff_adobe_deflate",
                                                              "tiffinfo": {317: 2}}),
        "packbits_gray.tif": (Image.fromarray(rgb[..., 1]), {"compression": "packbits"}),
        "palette_lzw.tif": (Image.fromarray(rgb).convert("P", palette=Image.ADAPTIVE, colors=64),
                            {"compression": "tiff_lzw"}),
        "jpeg_rgb.tif": (Image.fromarray(rgb), {"compression": "jpeg"}),
    }
    digests = {}
    for name, (img, kw) in files.items():
        img.save(OUT / name, "TIFF", **kw)
        digests[name] = pixel_sha1(OUT / name)
    (OUT / "pixels.json").write_text(json.dumps(digests, indent=1, sort_keys=True) + "\n")


if __name__ == "__main__":
    main()
