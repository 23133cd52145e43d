"""Unified YAML configuration: resolution, loading, splitting, CLI backfill.

The port's copy of ``geotrax_tpu/utils/config_utils.py``: one
self-contained YAML with sections input/output/processing/batch/
extraction/stabilo/georef/visualization/plotting/ultralytics/tracker;
presets by bare name ('default', 'confident', 'lenient', 'stable', the
port's copies under ``geotrax_tpu_torch/cfg/``), legacy 'cfg/<name>.yaml'
paths; model references as a local path or 'hf://<org>/<repo>/<file>';
class names by precedence CLI > config > model > integer fallback; CLI
flags that default to None, backfilled from the config. YAML is read by
the port's own reader (``io/yaml_load.py``).
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from pathlib import Path
from typing import Optional, Union

from geotrax_tpu_torch import cfg as port_cfg
from geotrax_tpu_torch.io import yaml_load

CFG_DIR = port_cfg.CFG_DIR
ROOT_DIR = CFG_DIR.parent.parent

HF_PREFIX = "hf://"


def resolve_config_path(cfg_filepath: Union[str, Path]) -> Path:
    """Resolve a config path: as given, relative to the repo root, or a bundled
    preset ('confident' -> <pkg>/cfg/confident.yaml). Legacy 'cfg/x.yaml' is
    tolerated. Returns the input unchanged when nothing matches."""
    path = Path(cfg_filepath)
    if not path.suffix:
        path = path.with_suffix(".yaml")
    candidates = [path]
    if not path.is_absolute():
        stripped = Path(*path.parts[1:]) if path.parts and path.parts[0] == "cfg" else path
        candidates += [ROOT_DIR / path, CFG_DIR / stripped]
    for cand in candidates:
        if cand.is_file():
            return cand
    return Path(cfg_filepath)


def resolve_asset_path(filepath: Union[str, Path]) -> Path:
    """Resolve a non-config asset (e.g. weights) against cwd then the repo root."""
    path = Path(filepath)
    if not path.is_absolute() and not path.is_file() and (ROOT_DIR / path).is_file():
        return ROOT_DIR / path
    return path


def resolve_model_path(model_ref: Union[str, Path], logger: logging.Logger) -> Path:
    """Resolve a model reference to a local file.

    'hf://<org>/<repo>/<file>' refs download once into the Hugging Face cache
    (requires huggingface_hub and network access; without the package this
    logs a critical error and exits 1); anything else is a local path."""
    model_str = str(model_ref).strip()
    if model_str.startswith("hf download "):
        model_str = model_str[len("hf download "):].strip()
    if not model_str.startswith(HF_PREFIX):
        return resolve_asset_path(model_str)

    try:
        from huggingface_hub import hf_hub_download
    except ImportError:
        logger.critical(
            f"Model '{model_str}' is a Hugging Face reference but huggingface_hub "
            "is unavailable. Point the config extraction->model (or --model) at a "
            "local weights file (.pt torch checkpoint or .npz params)."
        )
        sys.exit(1)

    parts = model_str[len(HF_PREFIX):].split("/")
    if len(parts) < 3:
        logger.critical(
            f"Malformed model reference '{model_str}'; expected "
            f"'{HF_PREFIX}<org>/<repo>/<path/to/file>'."
        )
        sys.exit(1)
    repo_id, filename = "/".join(parts[:2]), "/".join(parts[2:])
    try:
        local = hf_hub_download(repo_id=repo_id, filename=filename)
    except Exception as exc:  # noqa: BLE001 — network/cache errors are terminal here
        logger.critical(f"Failed to fetch '{filename}' from '{repo_id}': {exc}")
        sys.exit(1)
    return Path(local)


def load_config(cfg_filepath: Union[str, Path], logger: logging.Logger) -> dict:
    """Load a YAML config file into a dict; exit on a missing or unreadable
    file."""
    resolved = resolve_config_path(cfg_filepath)
    try:
        with open(resolved, "r") as fh:
            cfg = yaml_load.safe_load(fh)
    except FileNotFoundError:
        logger.critical(f"Configuration file '{cfg_filepath}' not found.")
        sys.exit(1)
    except yaml_load.YAMLSubsetError as exc:
        logger.critical(f"Configuration file '{cfg_filepath}' is not valid YAML: {exc}")
        sys.exit(1)
    if not isinstance(cfg, dict):
        logger.critical(f"Configuration file '{cfg_filepath}' has no mapping at top level.")
        sys.exit(1)
    return cfg


def select_tracker(tracker_section: dict, cfg_name, logger: logging.Logger) -> tuple[str, dict]:
    """Validate and return (active_tracker_name, its parameter block); log
    and exit on an invalid section."""
    try:
        return port_cfg.select_tracker(tracker_section, cfg_name)
    except ValueError as exc:
        logger.critical(str(exc))
        sys.exit(1)


def load_config_all(args: argparse.Namespace, logger: logging.Logger, needs_model: bool = True) -> dict:
    """Load the pipeline config and split it into runtime sections.

    Returns {'main': ..., 'stabilo': ..., 'ultralytics': ..., 'georef': ...}
    where 'main' carries every other top-level section plus resolved model,
    class names, and the active tracker's name/params."""
    full = load_config(args.cfg, logger)

    tracker_section = full.get("tracker", {})
    kwargs_stabilo = full.get("stabilo", {})
    kwargs_detect = dict(full.get("ultralytics", {}))
    kwargs_georef = full.get("georef", {})
    kwargs_main = {
        k: v for k, v in full.items() if k not in ("tracker", "stabilo", "ultralytics", "georef")
    }

    if needs_model:
        active, tracker_params = select_tracker(tracker_section, args.cfg, logger)
        kwargs_main["tracker_active"] = active
        kwargs_main["tracker_params"] = tracker_params
        kwargs_detect["tracker"] = tracker_params

        extraction_cfg = full.get("extraction", {})
        raw_model = getattr(args, "model", None)
        if isinstance(raw_model, list):
            raw_model = " ".join(raw_model)
        model_ref = raw_model or extraction_cfg.get("model") or kwargs_detect.get("model")
        kwargs_main["model_configured"] = str(model_ref)
        kwargs_detect["model"] = str(resolve_model_path(model_ref, logger))
        kwargs_main["class_names"], kwargs_main["class_names_source"] = resolve_class_names(
            Path(kwargs_detect["model"]),
            getattr(args, "class_names", None),
            extraction_cfg.get("class_rename"),
            kwargs_detect.get("classes"),
            logger,
        )
    else:
        kwargs_main["tracker_active"] = None
        kwargs_main["tracker_params"] = {}
        kwargs_main["model_configured"] = None
        kwargs_main["class_names"] = {}
        kwargs_main["class_names_source"] = None

    kwargs_main["args"] = args

    # Detection keys that a CLI flag may override at run time.
    for key in ("classes", "conf", "show", "tiles"):
        value = getattr(args, key, None)
        if value is not None:
            kwargs_detect[key] = value
            logger.info(f"Detection setting '{key}' overridden from CLI: {value}.")

    logger.info(f"Pipeline configuration loaded from: '{args.cfg}'.")
    return {
        "main": kwargs_main,
        "stabilo": kwargs_stabilo,
        "ultralytics": kwargs_detect,
        "georef": kwargs_georef,
    }


def backfill_args_from_config(args: argparse.Namespace, mapping: dict) -> None:
    """Fill each still-None CLI arg from the matching config value (config is the
    persistent default; the CLI is a per-run override)."""
    for name, value in mapping.items():
        if getattr(args, name) is None:
            setattr(args, name, value)


def load_class_names_from_model(model_path: Path, logger: logging.Logger) -> Optional[dict]:
    """The class-id -> name mapping embedded in a model checkpoint (.pt or
    .npz), or None."""
    try:
        from geotrax_tpu_torch.models.convert import read_class_names

        names = read_class_names(model_path)
        if names:
            logger.info(f"Class names loaded from model: '{model_path}'.")
        return names
    except Exception as exc:  # noqa: BLE001
        logger.error(f"Failed to load class names from '{model_path}': {exc}.")
        return None


def _load_class_names_mapping(value, logger: logging.Logger) -> Optional[dict]:
    """Coerce an override (dict, ID=NAME token list, or yaml/json path) into {int: str}."""
    mapping = None
    if isinstance(value, dict):
        mapping = value
    elif isinstance(value, list):
        if len(value) == 1 and Path(value[0]).is_file():
            return _load_class_names_mapping(value[0], logger)
        mapping = {}
        for token in value:
            if "=" not in token:
                logger.error(f"Invalid class-names entry '{token}'; expected ID=NAME or a file path.")
                return None
            key, name = token.split("=", 1)
            mapping[key] = name
    else:
        path = Path(value)
        if not path.is_file():
            logger.error(f"Class names file '{path}' not found.")
            return None
        try:
            with open(path, "r") as fh:
                mapping = json.load(fh) if path.suffix.lower() == ".json" else yaml_load.safe_load(fh)
        except Exception as exc:  # noqa: BLE001
            logger.error(f"Failed to read class names from '{path}': {exc}.")
            return None
    if not isinstance(mapping, dict) or not mapping:
        logger.error(f"Class names override '{value}' did not yield a non-empty mapping.")
        return None
    try:
        return {int(k): str(v) for k, v in mapping.items()}
    except (TypeError, ValueError) as exc:
        logger.error(f"Class names override '{value}' has non-integer keys: {exc}.")
        return None


def resolve_class_names(model_path, cli_value, cfg_value, classes, logger) -> tuple:
    """(mapping, source) by precedence CLI > config > model > integer fallback."""
    for source, tag, value in (("cli", "--class-names", cli_value), ("config", "class_rename", cfg_value)):
        if value is not None:
            mapping = _load_class_names_mapping(value, logger)
            if mapping is not None:
                logger.info(f"Class names taken from {tag}: {mapping}.")
                return mapping, source

    model_names = load_class_names_from_model(Path(model_path), logger)
    if model_names:
        return model_names, "model"

    ids = classes if classes else range(100)
    logger.warning(
        "No class-name mapping found (CLI, config, or model); using integer class IDs."
    )
    return {int(i): str(int(i)) for i in ids}, "fallback"
