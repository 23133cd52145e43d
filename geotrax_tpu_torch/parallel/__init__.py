"""Several frames, tiles or videos at once: spatial tiling of the detector
(``tiling.py``), the lockstep multi-video extractor that ``batch
--parallel-videos`` runs (``extract_batch.py``, with ``--devices`` splitting
its tracker timelines over cards) and V tracker timelines over a block of
detections with the aggregation's device arithmetic (``video_batch.py``),
and the process layout of a run over several ranks with its data-parallel
training step and detection over several devices (``mesh.py``; tiles over
devices in ``tiling.py:make_tiled_detector``). The GOP-parallel reader is
``io/video.py:ParallelVideoReader``."""
