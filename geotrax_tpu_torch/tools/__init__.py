"""The port's tools: the counterparts of ``tools/<name>.py`` that reach the
detector, the registration or the native video code, each run as
``python -m geotrax_tpu_torch.tools.<name>`` with the reference tool's
flags and output files.

- ``annotate_frames``: YOLO pre-labels of an image folder from the detector.
- ``benchmark_ortho_matching``: the registration's corner errors against
  known warps (``--synthetic``, ``--synthetic-cross-domain``,
  ``--synthetic-ortho``) or across ortho widths.
- ``verify_detector_parity``: a ``.pt`` checkpoint through the port's
  converter against an unfolded-BN torch oracle (``--selftest`` without
  weights).
- ``find_master_frames``, ``sample_frames``: frames out of videos.
- ``merge_videos_and_logs``, ``recut_video_and_log``,
  ``cut_merged_videos_and_logs``: stream-copy concatenation and cuts
  (``io/native/remux.cpp``) with the DJI flight logs (``dji_srt``).

Entry points that run the model or the registration take ``--device``
(default ``cuda``; ``cpu`` runs the plain PyTorch path). Tables go through
``io/table.py``, images through ``io/geoassets.py``, drawing through
``ops/draw.py``, warps through ``ops/warp.py``: none of these tools needs
pandas, cv2 or matplotlib.
"""
