"""The configuration presets of the port and the sections its extract path
reads.

``default.yaml``, ``confident.yaml``, ``lenient.yaml`` and ``stable.yaml``
beside this file are copies of the JAX package's presets. ``DEFAULT`` is
``default.yaml`` as read by the port's own YAML reader (``io/yaml_load.py``;
the card's machine has no PyYAML). ``load_config(path)`` overlays a YAML
file on these defaults.
"""

from __future__ import annotations

import copy
from pathlib import Path
from typing import Optional, Union

from geotrax_tpu_torch.io import yaml_load

CFG_DIR = Path(__file__).resolve().parent
TRACKER_CHOICES = ("botsort", "bytetrack", "ocsort", "deepocsort", "fasttrack", "tracktrack")

DEFAULT = yaml_load.safe_load((CFG_DIR / "default.yaml").read_text())


def load_config(path: Optional[Union[str, Path]] = None) -> dict:
    """A deep copy of ``DEFAULT``; with ``path``, the YAML file's top-level
    sections replace the defaults key by key (one level deep)."""
    cfg = copy.deepcopy(DEFAULT)
    if path is None:
        return cfg
    with open(path) as fh:
        user = yaml_load.safe_load(fh)
    if not isinstance(user, dict):
        raise ValueError(f"Configuration file '{path}' has no mapping at top level.")
    for section, values in user.items():
        if isinstance(values, dict) and isinstance(cfg.get(section), dict):
            cfg[section].update(values)
        else:
            cfg[section] = values
    return cfg


def select_tracker(tracker_section: dict, cfg_name="default") -> tuple:
    """Validate and return (active_tracker_name, its parameter block).

    The port's copy of ``geotrax_tpu/utils/config_utils.py:select_tracker``;
    it raises ``ValueError`` where the CLI helper logs and exits."""
    active = tracker_section.get("active")
    if active is None:
        raise ValueError(f"No 'active' tracker selector in the 'tracker' section of '{cfg_name}'.")
    if active not in TRACKER_CHOICES:
        raise ValueError(
            f"Unknown tracker '{active}' in '{cfg_name}'. Supported: {list(TRACKER_CHOICES)}."
        )
    if active not in tracker_section:
        available = [k for k in tracker_section if k != "active"]
        raise ValueError(
            f"Active tracker '{active}' has no parameter block in '{cfg_name}'. "
            f"Available: {available}."
        )
    return active, tracker_section[active]
