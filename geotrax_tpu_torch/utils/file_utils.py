"""Output paths and serialization: the port's copy of the parts of
``geotrax_tpu/utils/file_utils.py`` that ``extract``, ``georeference``,
``batch`` and ``aggregate`` use (the results folder with its configurable
name and postfixes, the delimiter sniffing, the location ID of a video's
name, the orthophoto folder's lookup, the platform's video container and a
video's dimensions)."""

from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path
from typing import Optional, Tuple, Union

from geotrax_tpu_torch.utils.constants import IS_MACOS, IS_WINDOWS

# Historical output-naming defaults, used only when no config dict is supplied.
DEFAULT_OUTPUT = {
    "folder": "results",
    "tracks_postfix": "",
    "georeferenced_postfix": "",
    "stab_transform_postfix": "_vid_transf",
    "geo_transform_postfix": "_geo_transf",
    "visualization_postfix": "",
}

# result_type -> (postfix config key, extension); 'visualized' is handled
# specially because its name embeds the viz mode and a platform extension.
_RESULT_KINDS = {
    "processed": ("tracks_postfix", ".txt"),
    "video_transformations": ("stab_transform_postfix", ".txt"),
    "geo_transformations": ("geo_transform_postfix", ".txt"),
    "georeferenced": ("georeferenced_postfix", ".csv"),
}


def get_output_dir(source: Path, output_cfg: Optional[dict] = None) -> Path:
    """Output directory for *source*: absolute config folder as-is, else a
    sub-folder next to the input video."""
    cfg = output_cfg or DEFAULT_OUTPUT
    folder = Path(cfg.get("folder", DEFAULT_OUTPUT["folder"]))
    return folder if folder.is_absolute() else Path(source).parent / folder


def build_result_path(source: Path, result_type: str, output_cfg: Optional[dict] = None,
                      viz_mode: Optional[int] = None, ext: Optional[str] = None) -> Optional[Path]:
    """Expected output path for *result_type* of input *source* (None if unknown)."""
    source = Path(source)
    if result_type == "video":
        return source
    cfg = output_cfg or DEFAULT_OUTPUT
    out_dir = get_output_dir(source, cfg)
    if result_type == "visualized":
        postfix = cfg.get("visualization_postfix", DEFAULT_OUTPUT["visualization_postfix"])
        return out_dir / f"{source.stem}{postfix}_mode_{viz_mode}.{ext}"
    if result_type in _RESULT_KINDS:
        key, extension = _RESULT_KINDS[result_type]
        postfix = cfg.get(key, DEFAULT_OUTPUT[key])
        return out_dir / f"{source.stem}{postfix}{extension}"
    return None


def check_if_results_exist(file: Path, result_type: str, viz_mode: Optional[int] = None,
                           ext: Optional[str] = None,
                           output_cfg: Optional[dict] = None) -> Tuple[bool, Optional[Path]]:
    """(exists, expected_path) for a given result kind of *file*."""
    path = build_result_path(file, result_type, output_cfg, viz_mode, ext)
    return (path.exists() if path else False), path


def detect_delimiter(filepath: Path, lines_to_check: int = 5) -> str:
    """Pick the most frequent of ',', ' ', '\\t' over the first few lines."""
    counts = {",": 0, " ": 0, "\t": 0}
    with open(filepath, "r") as fh:
        for _ in range(lines_to_check):
            line = fh.readline()
            if not line:
                break
            for d in counts:
                counts[d] += line.count(d)
    return max(counts, key=counts.get)


def determine_location_id(source: Path, logger: Optional[logging.Logger] = None) -> str:
    """Leading alphabetic run of the filename stem ('2025-01-01_A_PM1' -> 'A').

    Alphabetic characters accumulate; once at least one has been seen, a digit
    or '_'/'-' terminates the ID. Exits on failure (matches reference
    file_utils.py:102-130 semantics).
    """
    chars: list[str] = []
    for ch in source.stem:
        if ch.isalpha():
            chars.append(ch)
        elif chars and (ch in "_-" or ch.isdigit()):
            break
    location_id = "".join(chars)
    if not location_id:
        msg = f"Failed to extract location ID from filename {source}."
        (logger.error if logger else print)(msg)
        sys.exit(1)
    if logger:
        logger.info(f"Detected location ID '{location_id}' from {source.name}.")
    return location_id


def get_ortho_folder(
    source: Path,
    ortho_folder: Union[Path, None],
    logger: logging.Logger,
    critical: bool = True,
) -> Optional[Path]:
    """Resolve the orthophoto folder.

    When not given explicitly, walk up from the video until a 'PROCESSED' or
    'DATASET' ancestor is found and use its sibling 'ORTHOPHOTOS' folder
    (reference file_utils.py:133-173).
    """
    if ortho_folder is None:
        node = source.parent
        while node != node.parent and node.name not in ("PROCESSED", "DATASET"):
            node = node.parent
        if node.name not in ("PROCESSED", "DATASET"):
            msg = (
                f"Could not auto-detect the orthophoto folder for '{source}'. "
                f"Provide --ortho-folder, skip georeferencing with --no-geo, or "
                f"use the PROCESSED/ORTHOPHOTOS folder layout."
            )
            if critical:
                logger.critical(msg)
                sys.exit(1)
            logger.info(msg)
            return None
        ortho_folder = node.parent / "ORTHOPHOTOS"

    ortho_folder = Path(ortho_folder)
    if not ortho_folder.exists():
        msg = f"Orthophoto folder '{ortho_folder}' not found."
        if critical:
            logger.critical(msg)
            sys.exit(1)
        logger.info(msg)
        return None
    logger.info(f"Using orthophoto folder: '{ortho_folder}'.")
    return ortho_folder


def determine_suffix_and_fourcc() -> Tuple[str, str]:
    """Platform-appropriate output video container + codec fourcc."""
    if IS_MACOS:
        return "mp4", "avc1"
    if IS_WINDOWS:
        return "avi", "WMV2"
    return "mp4", "mp4v"


def get_video_dimensions(video_path: Path) -> Tuple[int, int]:
    """(width, height) of a video file, from the port's decoder."""
    from geotrax_tpu_torch.io.video import probe_video

    info = probe_video(video_path)
    return info.width, info.height


def convert_to_serializable(obj):
    """Recursively convert Paths/Namespaces/containers into YAML-safe values."""
    if isinstance(obj, Path):
        return str(obj)
    if isinstance(obj, argparse.Namespace):
        return {k: convert_to_serializable(v) for k, v in vars(obj).items()}
    if isinstance(obj, dict):
        return {k: convert_to_serializable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [convert_to_serializable(v) for v in obj]
    return obj
