"""Output paths and serialization: the port's copy of the parts of
``geotrax_tpu/utils/file_utils.py`` that ``extract`` uses (the results
folder with its configurable name and postfixes)."""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional, Tuple

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
