"""Slot-based multi-object tracking: the port of ``geotrax_tpu/track``.

The six config-selectable trackers (botsort, bytetrack, ocsort, deepocsort,
fasttrack, tracktrack) share one Kalman + IoU + assignment core
(``track/base.py``) with tracker-specific cost assembly and state flags;
``track/reid.py`` is the learned ReID head.
"""

from geotrax_tpu_torch.track.base import TrackerState, make_tracker

__all__ = ["TrackerState", "make_tracker"]
