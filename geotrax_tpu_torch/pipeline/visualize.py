"""`visualize`'s arguments: the port's copy of the argument half of
``geotrax_tpu/pipeline/visualize.py`` (``add_visualization_args``,
``resolve_viz_modes``, ``normalize_viz_modes``), from which ``batch``
builds its parser and its skip-if-exists check. The stage itself (drawing
and the MPEG-4 writer) is not ported yet: ``visualize_results`` raises."""

from __future__ import annotations

import argparse
import sys

NOT_PORTED = ("the visualize stage is not ported to PyTorch yet (ROADMAP A17b); "
              "run it with the JAX package ('geotrax visualize')")


def add_visualization_args(group, include_frame_range: bool = True) -> None:
    """The visualization flags of `visualize` and `batch`."""
    opt = argparse.BooleanOptionalAction
    group.add_argument("--save", "-s", action=opt, default=None,
                       help="Save the annotated output video to file.")
    group.add_argument("--show", "-sh", action=opt, default=None,
                       help="Open a live preview window during processing.")
    group.add_argument("--viz-mode", "-vm", type=int, nargs="+", default=None,
                       choices=[0, 1, 2, 3, 4], metavar="MODE",
                       help="Frame source(s): 0 original, 1 stabilized, 2 reference frame, "
                            "3/4 rotated boxes on original/stabilized frame. One video per mode.")
    group.add_argument("--plot-trajectories", "-pt", action=opt, default=None,
                       help="Overlay trajectory positions on the first frame.")
    group.add_argument("--plot-delay", "-pd", type=int, default=None,
                       help="Frames to hold the trajectory overlay.")
    group.add_argument("--show-conf", "-sc", action=opt, default=None,
                       help="Include detection confidence in box labels.")
    group.add_argument("--show-lanes", "-sl", action=opt, default=None,
                       help="Include lane ID in box labels (requires georeferencing).")
    group.add_argument("--show-class-names", "-scn", action=opt, default=None,
                       help="Include class name in box labels.")
    group.add_argument("--hide-labels", "-hl", action=opt, default=None,
                       help="Suppress all label text overlays.")
    group.add_argument("--hide-tracks", "-ht", action=opt, default=None,
                       help="Suppress track tail lines.")
    group.add_argument("--hide-speed", "-hs", action=opt, default=None,
                       help="Suppress speed values in labels.")
    group.add_argument("--speed-unit", "-su", type=str, default=None, choices=["km/h", "mi/h"],
                       help="Speed display unit.")
    group.add_argument("--speed-deadzone", "-sdz", type=float, default=None,
                       help="Floor displayed speeds <= this value to 0; 0 disables.")
    group.add_argument("--class-filter", "-cf", type=int, nargs="+", default=None,
                       help="Class IDs to exclude from visualization.")
    group.add_argument("--tail-length", "-tl", type=int, default=None,
                       help="Track tail length [frames].")
    group.add_argument("--line-width", "-lw", type=int, default=None,
                       help="Box and track stroke width [px].")
    group.add_argument("--heading-smoothing", "-hsm", type=int, default=None,
                       help="(modes 3/4) Gaussian smoothing window [frames] for headings.")
    group.add_argument("--heading-min-speed", "-hms", type=float, default=None,
                       help="(modes 3/4) Min smoothed pixel speed for a reliable heading.")
    group.add_argument("--edge-clip-margin", "-ecm", type=float, default=None,
                       help="(modes 3/4) Edge-touch distance [px] that triggers oriented-box clipping.")
    group.add_argument("--edge-clip-smoothing", "-ecs", type=float, default=None,
                       help="(modes 3/4) Gaussian window [frames] for smoothing the clip rectangle.")
    if include_frame_range:
        group.add_argument("--cut-frame-left", "-cfl", type=int, default=None,
                           help="Skip the first N frames.")
        group.add_argument("--cut-frame-right", "-cfr", type=int, default=None,
                           help="Stop processing after this frame.")


def resolve_viz_modes(args: argparse.Namespace, logger) -> list:
    """Normalized viz modes, reading the config default when --viz-mode was
    not given; the resolved value is cached on args."""
    if args.viz_mode is None:
        from geotrax_tpu_torch.utils.config_utils import load_config

        args.viz_mode = load_config(args.cfg, logger)["visualization"]["viz_mode"]
    return normalize_viz_modes(args.viz_mode, logger)


def normalize_viz_modes(viz_mode, logger) -> list:
    """Coerce a mode or list of modes into an ordered, de-duplicated list of
    valid mode ids; exits on invalid or empty input."""
    modes = list(viz_mode) if isinstance(viz_mode, (list, tuple)) else [viz_mode]
    valid: list[int] = []
    for mode in modes:
        if mode not in (0, 1, 2, 3, 4):
            logger.critical(f"Invalid visualization mode '{mode}'. Valid modes: 0-4.")
            sys.exit(1)
        if mode not in valid:
            valid.append(mode)
    if not valid:
        logger.critical("No visualization mode specified.")
        sys.exit(1)
    return valid


def visualize_results(args: argparse.Namespace, logger) -> None:
    """The visualize stage (not ported yet)."""
    raise NotImplementedError(NOT_PORTED)
