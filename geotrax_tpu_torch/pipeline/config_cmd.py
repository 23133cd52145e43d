"""`config`: inspect or copy the bundled configuration presets.

The port of ``geotrax_tpu/pipeline/config_cmd.py`` over the port's own
presets (``geotrax_tpu_torch/cfg/``): ``config show [preset]`` prints the
presets' directory and descriptions, or one preset's contents; ``config
copy [preset]`` copies presets into the current directory (or ``--dest``)
as ``<name>_copy.yaml``.
"""

from __future__ import annotations

import argparse
import shutil
import sys
from pathlib import Path

from geotrax_tpu_torch.cfg import CFG_DIR

PRESETS = ("default", "confident", "lenient", "stable")
PRESET_DESCRIPTIONS = {
    "default": "Balanced settings tuned for 4K DJI Mavic 3 footage at 140-150 m",
    "confident": "Stricter detections (conf 0.4, iou 0.6) and longer minimum tracks",
    "lenient": "Recall-leaning detection and looser association for difficult footage",
    "stable": "Maximum-quality stabilization (full-res frames, CLAHE, bigger feature budget)",
}


def _run_show(preset: str | None) -> int:
    if preset is None:
        print(f"Bundled configuration directory: {CFG_DIR}\n")
        print("Available presets:")
        for name in PRESETS:
            path = CFG_DIR / f"{name}.yaml"
            marker = "" if path.is_file() else "  [missing]"
            print(f"  {name:<10} {PRESET_DESCRIPTIONS[name]}{marker}")
        print("\nUse 'geotrax config show <preset>' to print a preset's contents.")
        return 0
    path = CFG_DIR / f"{preset}.yaml"
    if not path.is_file():
        print(f"Unknown preset '{preset}'. Available: {', '.join(PRESETS)}", file=sys.stderr)
        return 2
    print(path.read_text())
    return 0


def _run_copy(preset: str | None, dest: Path) -> int:
    names = [preset] if preset else list(PRESETS)
    if preset and preset not in PRESETS:
        print(f"Unknown preset '{preset}'. Available: {', '.join(PRESETS)}", file=sys.stderr)
        return 2
    for name in names:
        src = CFG_DIR / f"{name}.yaml"
        target = dest / f"{name}_copy.yaml"
        if target.exists():
            print(f"Skipping '{target}' (already exists).")
            continue
        shutil.copyfile(src, target)
        print(f"Copied preset '{name}' -> {target}")
    print("\nPass an edited copy to any command with -c, e.g. 'geotrax extract video.mp4 -c default_copy.yaml'.")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m geotrax_tpu_torch config",
                                     description="Show or copy the bundled configuration presets.")
    sub = parser.add_subparsers(dest="action")
    show = sub.add_parser("show", help="List presets, or print one preset's contents")
    show.add_argument("preset", nargs="?", choices=PRESETS)
    copy = sub.add_parser("copy", help="Copy preset(s) into the current directory")
    copy.add_argument("preset", nargs="?", choices=PRESETS)
    copy.add_argument("--dest", type=Path, default=Path.cwd(), help="Destination directory")
    args = parser.parse_args(argv)

    if args.action == "show":
        return _run_show(args.preset)
    if args.action == "copy":
        return _run_copy(args.preset, args.dest)
    parser.print_help()
    return 0


if __name__ == "__main__":
    sys.exit(main())
