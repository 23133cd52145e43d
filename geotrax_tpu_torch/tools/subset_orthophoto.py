"""Square cutouts of a large orthophoto around geographic or pixel centres,
downscaled on the card: the port of ``tools/subset_orthophoto.py``.

Given a city-scale GeoTIFF mosaic and a JSON location dictionary
``{"U": [lat, lng], ...}``, each location goes to mosaic pixels through the
ModelTiepoint/ModelPixelScale tags; a ``--crop-size`` square around it is
read without loading the mosaic (``io/tiff_tiled.py``'s windowed reads;
other TIFFs through ``io/tiff.py`` and PNG mosaics through ``io/png.py``
load whole), uploaded, scaled by ``--scale-factor`` on ``--device``
(``ops/resize.resize_area_u8``: cv2's INTER_AREA, which the reference calls,
pixel for pixel, a factor above 1 included) and written:

- ``<loc>.png``             the cutout the georeference stage registers against
- ``<loc>_center.txt``      the cutout's centre in mosaic pixels
- ``ortho_parameters.txt``  (lng_0, lat_0, lng_scale, -lat_scale)

``--centers "U=cx,cy"`` takes mosaic pixel centres for mosaics without geo
metadata.

Usage:
  python -m geotrax_tpu_torch.tools.subset_orthophoto --orthophoto-filepath ortho.tif \
      --ortho-cutout-folder out/ --location-dict-filepath locations.json \
      [--crop-size 15000] [--scale-factor 0.533] [--device cuda]
  python -m geotrax_tpu_torch.tools.subset_orthophoto --orthophoto-filepath mosaic.png \
      --ortho-cutout-folder out/ --centers "U=7000,6000" --crop-size 15000
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from geotrax_tpu_torch.io.png import write_png
from geotrax_tpu_torch.ops.resize import resize_area_u8
from geotrax_tpu_torch.tools._common import add_device_argument, resolve_tool_device
from geotrax_tpu_torch.utils.logging_utils import setup_logger


def output_size(shape, factor: float) -> tuple[int, int]:
    """(width, height) of a crop of ``shape`` scaled by ``factor``."""
    return int(round(shape[1] * factor)), int(round(shape[0] * factor))


def downscale(image: np.ndarray, factor: float, device) -> np.ndarray:
    """The crop scaled by ``factor`` (cv2 INTER_AREA) on ``device``."""
    if factor == 1.0:
        return image
    out_w, out_h = output_size(image.shape, factor)
    on_device = torch.from_numpy(np.ascontiguousarray(image)).to(device)
    return resize_area_u8(on_device, out_w, out_h).cpu().numpy()


def _whole_image(path: Path):
    """(RGB, geo parameters or None) of a mosaic read whole."""
    if path.suffix.lower() in (".tif", ".tiff"):
        from geotrax_tpu_torch.io.tiff import read_ifd, read_tiff

        _, tags = read_ifd(path)
        tie, scale = tags.get(33922), tags.get(33550)
        geo = (float(tie[3]), float(tie[4]), float(scale[0]), float(scale[1])) \
            if tie is not None and scale is not None else None
        return read_tiff(path), geo
    from geotrax_tpu_torch.train.data import load_image

    return load_image(path), None


class MosaicSource:
    """Windowed reads of the mosaic: a tiled TIFF's tiles when the tiled
    reader takes the file, else one whole-image load shared by all crops."""

    def __init__(self, path: Path, logger):
        self.tiled = None
        self.full = None
        self.geo = None
        try:
            from geotrax_tpu_torch.io.tiff_tiled import open_tiled_tiff

            self.tiled = open_tiled_tiff(path)
            self.geo = self.tiled.geo_params()
            self.height, self.width = self.tiled.length, self.tiled.width
            logger.info(
                f"Tiled mosaic {self.width}x{self.height}: windowed reads "
                f"({self.tiled.tile_width}px tiles)."
            )
        except ValueError:
            self.full, self.geo = _whole_image(path)
            self.height, self.width = self.full.shape[:2]
            logger.info(
                f"Mosaic {self.width}x{self.height} loaded whole "
                "(not a supported tiled TIFF)."
            )

    def crop(self, i0: int, j0: int, h: int, w: int) -> np.ndarray:
        if self.tiled is not None:
            rgb = self.tiled.read_window(i0, j0, h, w)
            return rgb[..., :3] if rgb.shape[-1] >= 3 else np.repeat(rgb, 3, -1)
        if i0 < 0 or j0 < 0 or i0 + h > self.height or j0 + w > self.width:
            raise ValueError(
                f"Requested crop [({i0},{i0 + h}),({j0},{j0 + w})] is out of "
                f"image bounds ({self.height},{self.width})"
            )
        return self.full[i0:i0 + h, j0:j0 + w]


def process_ortho(args, logger, device) -> int:
    mosaic = MosaicSource(args.orthophoto_filepath, logger)
    out = args.ortho_cutout_folder
    out.mkdir(parents=True, exist_ok=True)

    # location name -> mosaic pixel centre
    centers: dict[str, tuple[int, int]] = {}
    if args.location_dict_filepath is not None:
        if mosaic.geo is None:
            logger.error(
                "Mosaic has no GeoTIFF ModelTiepoint/ModelPixelScale tags; "
                "use --centers with pixel coordinates instead."
            )
            return 1
        lng_0, lat_0, lng_scale, lat_scale = mosaic.geo
        np.savetxt(out / "ortho_parameters.txt",
                   np.array([lng_0, lat_0, lng_scale, -lat_scale]))
        location_dict = json.loads(Path(args.location_dict_filepath).read_text())
        for location, (lat, lng) in location_dict.items():
            centers[location] = (
                int((lng - lng_0) / lng_scale),
                -int((lat - lat_0) / lat_scale),
            )
    for entry in args.centers or []:
        location, coords = entry.split("=")
        cx, cy = (int(v) for v in coords.split(","))
        centers[location] = (cx, cy)
    if not centers:
        logger.error("No locations given: pass --location-dict-filepath or --centers.")
        return 1

    half = args.crop_size // 2
    failed = 0
    for location, (p_x, p_y) in centers.items():
        try:
            cropped = mosaic.crop(p_y - half, p_x - half, args.crop_size, args.crop_size)
            resized = downscale(cropped, args.scale_factor, device)
            write_png(out / f"{location}.png", np.ascontiguousarray(resized))
        except (ValueError, OSError) as exc:
            logger.error(f"{location}: {exc}")
            failed += 1
            continue
        # only once the .png is on disk: a <loc>_center.txt without its image
        # would hand the georeference stage a half-built location
        np.savetxt(out / f"{location}_center.txt", np.array([p_x, p_y]))
        logger.notice(f"Processed and saved orthophoto for intersection: {location}")
    return 1 if failed else 0


def parse_cli_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Subset large orthophotos around specified geographic locations.")
    parser.add_argument("--orthophoto-filepath", type=Path, required=True,
                        help="Orthophoto file to be subsetted (GeoTIFF/PNG)")
    parser.add_argument("--ortho-cutout-folder", type=Path, required=True,
                        help="Output folder for cutouts and meta files")
    parser.add_argument("--location-dict-filepath", type=Path, default=None,
                        help="JSON mapping location name -> [lat, lng]")
    parser.add_argument("--centers", nargs="+", default=None,
                        help="LOC=cx,cy entries in mosaic PIXEL coordinates "
                             "(mosaics without geo metadata)")
    parser.add_argument("--crop-size", type=int, default=15000,
                        help="Square crop size of the orthophoto (in pixels)")
    parser.add_argument("--scale-factor", type=float, default=8 / 15,
                        help="Downscale factor applied before saving")
    parser.add_argument("--log-path", "-lp", type=Path, default=None)
    parser.add_argument("--quiet", "-q", action="store_true")
    add_device_argument(parser)
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_cli_args(argv)
    device = resolve_tool_device(args)
    logger = setup_logger("subset_orthophoto", verbose=not args.quiet,
                          log_path=args.log_path)
    return process_ortho(args, logger, device)


if __name__ == "__main__":
    raise SystemExit(main())
