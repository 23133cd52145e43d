"""Slot-based multi-object tracking: the port of ``geotrax_tpu/track``
(botsort and bytetrack; the other trackers wait for ROADMAP A13)."""

from geotrax_tpu_torch.track.base import TrackerState, make_tracker

__all__ = ["TrackerState", "make_tracker"]
