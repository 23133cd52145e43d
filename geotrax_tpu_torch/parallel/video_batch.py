"""Several video timelines advanced together: the port of
``geotrax_tpu/parallel/video_batch.py``.

``VideoBatchTracker`` steps V tracker timelines through a (V, T) block of
detections: one batched ``byte_step`` per frame over the leading video axis
(``track/base.py``), frame after frame. No information crosses videos, so
each timeline is the one it has alone.

The aggregation's arithmetic runs on the device: ``offset_vehicle_ids`` is
the exclusive prefix sum of per-video ID counts (the offset each video adds
to its vehicle IDs in a merged dataset) and ``aggregate_track_counts`` the
per-video maximum ID and row count of an output block.
"""

from __future__ import annotations

import torch

from geotrax_tpu_torch.track.base import (FrameOutput, TrackerConfig, byte_step, init_state,
                                          stack_states)


class VideoBatchTracker:
    """BYTE tracker over a fixed batch of video timelines on one device."""

    def __init__(self, cfg: TrackerConfig, num_videos: int, device="cuda"):
        self.cfg = cfg
        self.num_videos = num_videos
        self.state = stack_states(init_state(cfg, device), num_videos)

    def step_chunk(self, det_boxes, det_scores, det_cls, det_valid, frame_id0: int) -> FrameOutput:
        """Advance every video by the chunk's T frames ((V, T, M, ...)
        detections, frame ids from ``frame_id0``); returns the per-frame
        outputs as a (V, T, K, ...) FrameOutput."""
        outs = []
        for t in range(det_boxes.shape[1]):
            self.state, out = byte_step(self.state, det_boxes[:, t], det_scores[:, t],
                                        det_cls[:, t], det_valid[:, t], frame_id0 + t, self.cfg)
            outs.append(out)
        return FrameOutput(*(torch.stack(field, dim=1) for field in zip(*outs)))


def offset_vehicle_ids(per_video_max_id: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum of per-video max IDs -> the offset each video
    adds to its vehicle IDs in the aggregated dataset."""
    ids = per_video_max_id
    return torch.cat([ids.new_zeros((1,)), torch.cumsum(ids, 0, dtype=ids.dtype)[:-1]])


def aggregate_track_counts(track_ids: torch.Tensor, valid: torch.Tensor) -> tuple:
    """Per-video (leading axis) maximum track id over valid entries and the
    number of valid rows."""
    dims = tuple(range(1, track_ids.dim()))
    max_ids = torch.amax(torch.where(valid, track_ids, 0), dim=dims)
    rows = valid.sum(dim=tuple(range(1, valid.dim())))
    return max_ids, rows
