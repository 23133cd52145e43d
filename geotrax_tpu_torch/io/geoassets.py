"""Geo-assets: orthophotos, geo-parameters, master frames, lane segmentation.

The port of ``geotrax_tpu/io/geoassets.py``. Images are read through the
port's PNG codec (``io/png.py``) and the segmentation CSV through
``io/table.py``, typed as pandas types it. The geo-parameters come from the
GeoTIFF tags of ``<loc>.tif`` ('metadata-tif', read by ``io/tiff.py``,
which also converts the file to the ``<loc>.png`` the stage reads), from a
plain ``<loc>.txt`` ('text-file') or from the Songdo cutout's
``<loc>_center.txt`` and ``ortho_parameters.txt`` ('center-text-file').
"""

from __future__ import annotations

import logging
import sys
from pathlib import Path
from typing import Optional

import numpy as np

from geotrax_tpu_torch.io import png, table, tiff

SEGMENTATION_COLUMNS = 10


def load_image(path: Path) -> np.ndarray:
    """(H,W,3) uint8 RGB image."""
    return png.read_png(path)


def save_image(path: Path, rgb: np.ndarray) -> None:
    png.write_png(path, rgb)


def read_ortho_config_file(filepath: Path) -> np.ndarray:
    """Whitespace-separated numbers, '#' comments ignored."""
    values = []
    with open(filepath, "r") as fh:
        for line in fh:
            stripped = line.strip()
            if stripped and not stripped.startswith("#"):
                values.extend(float(tok) for tok in stripped.split())
    return np.asarray(values)


def _tiff_or_exit(read, tif: Path, logger: logging.Logger, what: str):
    """``read(tif)``, or exit 1 naming what the file lacks (the reference
    reads the file through Pillow, which exits or raises there)."""
    try:
        return read(tif)
    except ValueError as exc:
        logger.critical(f"Cannot {what} '{tif}': {exc}")
        sys.exit(1)


def get_geo_params_source(
    geo_source: Optional[str], ortho_folder: Path, location_id: str, logger: logging.Logger
) -> str:
    """Auto-detect (or validate) which geo-parameter source applies;
    converts a lone .tif into the .png the rest of the pipeline uses."""
    if geo_source is not None:
        if geo_source not in ("metadata-tif", "text-file", "center-text-file"):
            logger.critical(f"Invalid --geo-source '{geo_source}'.")
            sys.exit(1)
        return geo_source

    base = ortho_folder / f"{location_id}.png"
    tif = base.with_suffix(".tif")
    txt = base.with_suffix(".txt")
    center = base.with_name(f"{location_id}_center.txt")
    params = base.with_name("ortho_parameters.txt")

    if tif.exists() and (txt.exists() or (center.exists() and params.exists())):
        logger.error(f"Both .tif and .txt geo sources present for '{base}'; use --geo-source.")
        sys.exit(1)
    if tif.exists():
        if not base.exists():
            logger.warning(f"Converting '{tif}' to '{base}'.")
            save_image(base, _tiff_or_exit(tiff.read_tiff, tif, logger, "convert"))
        return "metadata-tif"
    if txt.exists() and center.exists() and params.exists():
        logger.error(f"Both '.txt' and '_center.txt' present for '{base}'; use --geo-source.")
        sys.exit(1)
    if txt.exists():
        return "text-file"
    if center.exists() and params.exists():
        return "center-text-file"
    logger.error(f"No georeferencing parameters found for '{base}'.")
    sys.exit(1)


def get_ortho_parameters(
    ortho_folder: Path,
    location_id: str,
    geo_source: str,
    cutout_width_px: Optional[int],
    logger: logging.Logger,
) -> tuple:
    """(lng0, lat0, dlng, dlat, skew_x, skew_y): the affine mapping ortho px
    -> geographic degrees."""
    base = ortho_folder / f"{location_id}.png"

    if geo_source == "metadata-tif":
        tif = base.with_suffix(".tif")
        _, tags = _tiff_or_exit(tiff.read_ifd, tif, logger, "read GeoTIFF tags from")
        if 33922 in tags and 33550 in tags:
            tiepoint = tags[33922]
            scale = tags[33550]
            lng0, lat0 = float(tiepoint[3]), float(tiepoint[4])
            dlng, dlat = float(scale[0]), -float(scale[1])
            skew_x = skew_y = 0.0
            if 34264 in tags:
                # ModelTransformation is 4x4 row-major: X' row is t[0..3],
                # Y' row is t[4..7]; skew_y lives at t[4]
                transform = tags[34264]
                skew_x, skew_y = float(transform[1]), float(transform[4])
        elif 34264 in tags:
            # a transformation-only GeoTIFF (gdalwarp with a rotation writes
            # ModelTransformation instead of tiepoint and scale)
            t = tags[34264]
            dlng, skew_x, lng0 = float(t[0]), float(t[1]), float(t[3])
            skew_y, dlat, lat0 = float(t[4]), float(t[5]), float(t[7])
        else:
            logger.critical(f"GeoTIFF '{tif}' has neither ModelTiepoint+ModelPixelScale nor "
                            "ModelTransformation tags.")
            sys.exit(1)
        return lng0, lat0, dlng, dlat, skew_x, skew_y

    if geo_source == "text-file":
        vals = read_ortho_config_file(base.with_suffix(".txt"))
        lng0, lat0, dlng, dlat = vals[:4]
        skew_x, skew_y = (vals[4], vals[5]) if len(vals) >= 6 else (0.0, 0.0)
        return float(lng0), float(lat0), float(dlng), float(dlat), float(skew_x), float(skew_y)

    if geo_source == "center-text-file":
        # The Songdo cutouts: <loc>_center.txt gives the cutout center in the
        # big ortho mosaic; ortho_parameters.txt the mosaic's affine. The
        # cutout's top-left anchor and (rescaled) pixel sizes follow.
        center = read_ortho_config_file(base.with_name(f"{location_id}_center.txt"))
        cx, cy = float(center[0]), float(center[1])
        if not base.exists():
            logger.critical(f"Orthophoto '{base}' not found.")
            sys.exit(1)
        ortho_width_px = png.read_png_size(base)[0]
        width_half = (cutout_width_px if cutout_width_px is not None else ortho_width_px) // 2

        vals = read_ortho_config_file(base.with_name("ortho_parameters.txt"))
        lngs, lats, dlng, dlat = (float(v) for v in vals[:4])
        skew_x, skew_y = (float(vals[4]), float(vals[5])) if len(vals) >= 6 else (0.0, 0.0)

        lng0 = lngs + (cx - width_half) * dlng + (cy - width_half) * skew_x
        lat0 = lats + (cy - width_half) * dlat + (cx - width_half) * skew_y

        if cutout_width_px is not None and cutout_width_px != ortho_width_px:
            scale = cutout_width_px / ortho_width_px
            dlng, dlat, skew_x, skew_y = (p * scale for p in (dlng, dlat, skew_x, skew_y))
        return lng0, lat0, dlng, dlat, skew_x, skew_y

    logger.error(f"Invalid geo_source '{geo_source}'.")
    sys.exit(1)


def get_orthophoto(ortho_folder: Path, location_id: str, logger: logging.Logger) -> np.ndarray:
    path = ortho_folder / f"{location_id}.png"
    if not path.exists():
        logger.critical(f"Orthophoto file '{path}' not found.")
        sys.exit(1)
    img = load_image(path)
    logger.info(f"Loaded orthophoto '{path}' with shape {img.shape}.")
    return img


def get_master_frame(
    ortho_folder: Path, master_folder: Optional[Path], location_id: str, logger: logging.Logger
) -> np.ndarray:
    folder = master_folder if master_folder is not None else ortho_folder / "master_frames"
    path = Path(folder) / f"{location_id}.png"
    if not path.exists():
        logger.error(f"Master frame '{path}' not found; use --no-master to skip the master path.")
        sys.exit(1)
    logger.info(f"Loaded master frame '{path}'.")
    return load_image(path)


def get_road_section_lane_geometry(
    ortho_folder: Path, segmentation_folder: Optional[Path], location_id: str,
    logger: logging.Logger,
) -> dict:
    """{column: values} of the first 10 columns of ``<loc>.csv`` (section,
    lane, then the four corners), typed as pandas types them; {} when there
    is no file."""
    folder = segmentation_folder if segmentation_folder is not None else ortho_folder / "segmentations"
    path = Path(folder) / f"{location_id}.csv"
    if path.exists():
        logger.info(f"Loaded lane geometry from '{path}'.")
        columns = table.read_csv(path)
        return dict(list(columns.items())[:SEGMENTATION_COLUMNS])
    logger.warning(f"No segmentation file at '{path}'; road section/lane not assigned.")
    return {}
