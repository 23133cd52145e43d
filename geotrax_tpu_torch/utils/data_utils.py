"""Color palettes for visualization and plotting: the port's copy of
``geotrax_tpu/utils/data_utils.py``. A class-stable 20-color visualization
palette (car=blue, bus=red, truck=orange, motorcycle=green for ids 0-3);
the port draws in RGB (``VizColors.rgb``), and ``bgr`` serves comparisons
with cv2. A plotting palette falls back to deterministic pseudo-random
colors past its fixed entries.
"""

from __future__ import annotations

import hashlib


class VizColors:
    """Class-id -> stable RGB color for video annotation."""

    # ids 0..3 are the vehicle taxonomy; the rest cycle for unknown ids.
    _PALETTE = [
        (52, 110, 235),   # 0 car: blue
        (220, 46, 46),    # 1 bus: red
        (245, 146, 24),   # 2 truck: orange
        (46, 204, 87),    # 3 motorcycle: green
        (148, 87, 235),   # purple
        (240, 200, 20),   # yellow
        (26, 188, 210),   # cyan
        (235, 87, 178),   # pink
        (121, 85, 61),    # brown
        (110, 110, 110),  # grey
        (60, 160, 120),
        (200, 120, 60),
        (90, 90, 220),
        (180, 180, 40),
        (40, 140, 200),
        (200, 60, 120),
        (120, 200, 60),
        (60, 60, 60),
        (160, 100, 200),
        (100, 160, 40),
    ]

    @classmethod
    def rgb(cls, class_id: int) -> tuple[int, int, int]:
        return cls._PALETTE[int(class_id) % len(cls._PALETTE)]

    @classmethod
    def bgr(cls, class_id: int) -> tuple[int, int, int]:
        r, g, b = cls.rgb(class_id)
        return (b, g, r)


class PlotColors:
    """Index -> hex color for per-source trajectory plots.

    Past the fixed list, colors are derived deterministically from the index
    hash so aggregated plots with many sources stay reproducible.
    """

    _FIXED = [
        "#76b041", "#3274d9", "#ff61b4", "#ff9d00", "#9954bb", "#ffc000",
        "#e84343", "#17becf", "#ef843c", "#2ca02c", "#8c564b", "#e377c2",
        "#7f7f7f", "#bcbd22", "#1f60c4", "#a05195",
    ]

    def __init__(self, colors: list[str] | None = None):
        self.colors = list(colors) if colors else list(self._FIXED)

    def __call__(self, index: int) -> str:
        if index < len(self.colors):
            return self.colors[index]
        digest = hashlib.md5(str(index).encode()).hexdigest()
        return "#" + digest[:6]
