"""Shared CLI argument groups: the port's copy of
``geotrax_tpu/utils/cli_utils.py``. Every stage exposes the same
--cfg/--output-folder/--log-path/--verbose group, and the port's stages
also --device."""

from __future__ import annotations

from pathlib import Path

DEFAULT_CFG = "default"


def add_common_args(group, output_folder: bool = True) -> None:
    """Register the flags every stage shares on an argparse parser or group."""
    group.add_argument(
        "--cfg", "-c", type=str, default=DEFAULT_CFG,
        help="Pipeline config: a preset name (default/confident/lenient/stable) or a YAML path",
    )
    if output_folder:
        group.add_argument(
            "--output-folder", "-of", type=str, default=None,
            help="Output folder: bare name (created next to each input video) or absolute path",
        )
    group.add_argument("--log-path", "-lp", type=Path, default=None, help="Override the log-file directory")
    group.add_argument("--verbose", "-v", action="store_true", help="Debug-level console logging")
    group.add_argument("--device", type=str, default="cuda",
                       help="Torch device to run on (default cuda; 'cpu' runs each kernel's "
                            "plain PyTorch version)")
