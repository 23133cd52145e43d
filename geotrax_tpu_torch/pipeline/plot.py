"""`plot`'s arguments: the port's copy of the argument half of
``geotrax_tpu/pipeline/plot.py`` (``default_plot_args``,
``add_plotting_args``), from which ``batch`` builds its parser. The stage
itself (matplotlib figures) is not ported yet: ``generate_plots`` raises."""

from __future__ import annotations

import argparse

from geotrax_tpu_torch.utils.cli_utils import DEFAULT_CFG

NOT_PORTED = ("the plot stage is not ported to PyTorch yet (ROADMAP A17b); "
              "run it with the JAX package ('geotrax plot')")


def default_plot_args(**overrides) -> argparse.Namespace:
    """Namespace carrying this stage's defaults (for callers like `batch`)."""
    defaults = {
        "input": None,
        "save": None,
        "show": None,
        "cfg": DEFAULT_CFG,
        "output_folder": None,
        "log_path": None,
        "verbose": False,
        "aggregate": None,
        "ortho_folder": None,
        "segmentation_folder": None,
        "segmentations": None,
        "id": 0,
        "points": None,
        "class_filter": None,
        "model": None,
        "class_names": None,
    }
    defaults.update(overrides)
    return argparse.Namespace(**defaults)


def add_plotting_args(group, dest_prefix: str = "") -> None:
    """The plotting flags of `plot` and `batch`; ``dest_prefix='plot_'``
    avoids attribute collisions in batch's combined parser."""
    opt = argparse.BooleanOptionalAction
    group.add_argument("--plot-save", "-ps", dest=f"{dest_prefix}save", action=opt, default=None,
                       help="Save the plots as .pdf files.")
    group.add_argument("--plot-show", "-psh", dest=f"{dest_prefix}show", action=opt, default=None,
                       help="Show plots in an interactive window.")
    group.add_argument("--plot-aggregate", "-pa", dest=f"{dest_prefix}aggregate", action=opt,
                       default=None,
                       help="Merge trajectories from all videos sharing a location ID into one plot.")
    group.add_argument("--plot-points", "-pp", dest=f"{dest_prefix}points", action=opt, default=None,
                       help="Plot discrete trajectory points instead of connected lines.")
    group.add_argument("--plot-segmentations", "-pseg", dest=f"{dest_prefix}segmentations",
                       action=opt, default=None,
                       help="Also plot on the lane segmentation overlay PNG.")
    group.add_argument("--plot-class-filter", "-pcf", dest=f"{dest_prefix}class_filter",
                       type=int, nargs="+", default=None,
                       help="Class IDs to exclude from plots.")


def generate_plots(args: argparse.Namespace, logger) -> None:
    """The plot stage (not ported yet)."""
    raise NotImplementedError(NOT_PORTED)
