"""Several frames, tiles or videos at once: spatial tiling of the detector
(``tiling.py``), the lockstep multi-video extractor that ``batch
--parallel-videos`` runs (``extract_batch.py``, with ``--devices`` splitting
its tracker timelines over cards) and V tracker timelines over a block of
detections with the aggregation's device arithmetic (``video_batch.py``),
and the training step on one card (``mesh.py``). Tiles sharded over cards
and data-parallel training wait for ROADMAP A15b; the GOP-parallel reader
is ``io/video.py:ParallelVideoReader``."""
