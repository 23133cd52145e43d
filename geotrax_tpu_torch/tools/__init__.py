"""The port's tools: the counterparts of ``tools/<name>.py``, each run as
``python -m geotrax_tpu_torch.tools.<name>`` with the reference tool's
flags, exit codes, printed lines and output files. Those that put
tensors on a device (the detector, the registration, the downscale of
``subset_orthophoto``, the ``batch`` that ``fix_timestamp_anomalies``
starts) add ``--device`` (default ``cuda``; ``cpu`` runs the plain path; a
card this machine lacks exits 1); the others run as the reference does on
any host. Tables go through ``io/table.py`` (pandas' typing, CSV text and
``to_string``), YAML through ``io/yaml_load.py``, images through
``io/png.py`` and ``io/image_size.py``, drawing through ``ops/draw.py``:
none of these tools needs pandas, cv2, yaml or matplotlib; figures are
drawn where matplotlib imports and skipped with one line where it does not.

Index of ``tools/`` (reference file: the port's counterpart):

- ``_common.py``: ``_common.py`` (labels, image order, ``save_frame``, ``--device``
  of the tools that use a device)
- ``dji_srt.py``: ``dji_srt.py`` (DJI SRT telemetry and flight logs)
- ``annotate_frames.py``: YOLO pre-labels from the detector, on the card
- ``benchmark_ortho_matching.py``: the registration's corner errors, on the card
- ``verify_detector_parity.py``: a ``.pt`` through the converter against an oracle
- ``find_master_frames.py``, ``sample_frames.py``: frames out of videos
- ``merge_videos_and_logs.py``, ``recut_video_and_log.py``,
  ``cut_merged_videos_and_logs.py``: stream-copy cuts (``io/native/remux.cpp``)
- ``find_max_annotations.py``: label counts per image
- ``interpolate_missing_timestamps.py``: a flight log's missing stamps filled
- ``yolo_to_coco.py``: labelme or COCO JSON from YOLO labels
- ``fix_json_annotations.py``: labelme folders and COCO files cleaned
- ``find_source_id.py``: an aggregated Vehicle_ID traced to its source video
- ``check_dataset.py``: speed and acceleration violations, traced
- ``compare_tracking.py``: track-length and gap statistics across runs
- ``analyze_bb_ratios.py``: per-class L/W ratios (the estimator's tau_c)
- ``compute_bb_center_error.py``: box-centre error, human against predicted labels
- ``find_cut_video_issues.py``: flight-log anomalies, reports, recut fixes
- ``fix_timestamp_anomalies.py``: cuts at the anomalies, then ``batch``
- ``viz_dimension_estimation.py``: the dimension estimator replayed for one vehicle
- ``compare_av_detections_and_tune_filters.py``: trajectories against RTK probes, the
  smoothing sweep
- ``subset_orthophoto.py``: cutouts of a mosaic, downscaled on the card
  (``ops/resize.resize_area_u8``, cv2's INTER_AREA)
- ``viz_annotations.py``: labels drawn on their images (no display window: ``--show``
  exits 1)
- ``viz_segmentations.py``: lane quads drawn over an orthophoto
- ``export_model.py``: ``python -m geotrax_tpu_torch.models.convert``
- ``profile_fused_stages.py``: none yet; the port's benchmark (ROADMAP A20) times
  each stage with CUDA events
- ``verify_device_parity.py``: ``chip_smoke.py``'s card-against-CPU checks
- ``make_torch_raster_tables.py``: the port's own (it derives ``ops/raster_tables.npz``
  from cv2)
"""
