"""`python -m geotrax_tpu_torch`: the port's umbrella CLI.

The counterpart of ``geotrax_tpu/cli.py``: the reference's seven commands
and ``-V/--version``, each stage module imported only when its command
runs and given its own argv. ``extract``, ``georeference``, ``batch`` and
``visualize`` (its frame warp) run on the card unless ``--device cpu`` is
given (the counterpart of the reference's ``JAX_PLATFORMS``); ``plot``,
``config`` and ``aggregate`` run on the host.
"""

from __future__ import annotations

import importlib
import sys

from geotrax_tpu_torch import __version__

# command -> (module path, one-line help)
COMMANDS = {
    "batch": ("geotrax_tpu_torch.pipeline.batch",
              "Run the full pipeline over a video or a directory tree"),
    "extract": ("geotrax_tpu_torch.pipeline.extract",
                "Detect, track and stabilize vehicle trajectories (pixel coords)"),
    "georeference": ("geotrax_tpu_torch.pipeline.georeference",
                     "Map extracted tracks to WGS84 + local CRS with kinematics"),
    "aggregate": ("geotrax_tpu_torch.pipeline.aggregate",
                  "Merge per-video georeferenced CSVs across drones/sessions"),
    "visualize": ("geotrax_tpu_torch.pipeline.visualize",
                  "Render annotated videos (5 modes incl. oriented boxes)"),
    "plot": ("geotrax_tpu_torch.pipeline.plot",
             "Generate trajectory / kinematics / class-distribution plots"),
    "config": ("geotrax_tpu_torch.pipeline.config_cmd",
               "Show or copy the bundled configuration presets"),
}

PROG = "python -m geotrax_tpu_torch"


def build_usage() -> str:
    lines = [
        f"usage: {PROG} <command> [options]",
        "",
        "Georeferenced trajectory extraction from BEV drone video on an NVIDIA GPU.",
        "",
        "commands:",
    ]
    width = max(len(name) for name in COMMANDS)
    for name, (_, help_text) in COMMANDS.items():
        lines.append(f"  {name:<{width}}  {help_text}")
    lines += [
        "",
        f"Run '{PROG} <command> --help' for command-specific options.",
        "  -V, --version   show version and exit",
    ]
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(build_usage())
        return 0
    if argv[0] in ("-V", "--version"):
        print(f"geotrax_tpu_torch {__version__}")
        return 0

    command = argv[0]
    if command not in COMMANDS:
        print(f"{PROG}: unknown command '{command}'\n", file=sys.stderr)
        print(build_usage(), file=sys.stderr)
        return 2
    module = importlib.import_module(COMMANDS[command][0])
    result = module.main(argv[1:])
    return int(result) if result is not None else 0


if __name__ == "__main__":
    sys.exit(main())
