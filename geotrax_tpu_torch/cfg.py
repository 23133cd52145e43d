"""The configuration sections the port's extract path reads.

A Python-literal copy of the ``extraction``, ``stabilo``, ``ultralytics``
(detection keys) and ``tracker`` sections of ``geotrax_tpu/cfg/default.yaml``,
so the port needs no YAML parser to run its default configuration.
``load_config(path)`` overlays a YAML file on these defaults; ``yaml`` is
imported only then.
"""

from __future__ import annotations

import copy
from pathlib import Path
from typing import Optional, Union

TRACKER_CHOICES = ("botsort", "bytetrack", "ocsort", "deepocsort", "fasttrack", "tracktrack")

DEFAULT = {
    "extraction": {
        "model": "hf://rfonod/geo-trax/geotrax_hbb_yolov8s_1920_v1.pt",
        "class_rename": None,
        "stabilize": True,
        "save_stab": True,
        "min_track_length": 3,
        "interpolate": False,
        "dimension_estimation": {
            "gsd": 0.02725,
            "eps": 4,
            "r0": 1.25,
            "theta_bar": 15,
            "tau_c": {0: 1.83, 1: 2.85, 2: 1.70, 3: 1.80, -1: 1.70},
        },
    },
    "stabilo": {
        "clahe": False,
        "downsample_ratio": 0.5,
        "detector_name": "orb",
        "max_features": 2000,
        "ref_multiplier": 2.0,
        "sift_enable_precise_upscale": False,
        "rsift_eps": 0.00000001,
        "matcher_name": "bf",
        "filter_type": "ratio",
        "filter_ratio": 0.9,
        "transformation_type": "projective",
        "ransac_method": 38,
        "ransac_epipolar_threshold": 2.0,
        "ransac_max_iter": 5000,
        "ransac_confidence": 0.999999,
        "mask_use": True,
        "mask_margin_ratio": 0.15,
        "brisk_threshold": 130,
        "kaze_threshold": 0.01,
        "akaze_threshold": 0.01,
        "gpu": False,
        "viz": False,
        "benchmark": False,
        "min_good_match_count_warning": 20,
        "min_inliers_match_count_warning": 10,
    },
    "ultralytics": {
        "task": "detect",
        "mode": "track",
        "data": None,
        "imgsz": 1920,
        "device": None,
        "conf": 0.25,
        "iou": 0.7,
        "max_det": 1000,
        "classes": [0, 1, 2, 3],
        "augment": False,
        "agnostic_nms": True,
        "half": False,
        "tiles": 1,
        "tile_overlap": 128,
    },
    "tracker": {
        "active": "botsort",
        "botsort": {
            "tracker_type": "botsort",
            "track_high_thresh": 0.25,
            "track_low_thresh": 0.1,
            "new_track_thresh": 0.25,
            "track_buffer": 30,
            "match_thresh": 0.8,
            "fuse_score": True,
            "gmc_method": "sparseOptFlow",
            "proximity_thresh": 0.5,
            "appearance_thresh": 0.8,
            "with_reid": False,
            "model": "auto",
        },
        "bytetrack": {
            "tracker_type": "bytetrack",
            "track_high_thresh": 0.25,
            "track_low_thresh": 0.1,
            "new_track_thresh": 0.25,
            "track_buffer": 30,
            "match_thresh": 0.8,
            "fuse_score": True,
        },
        "ocsort": {
            "tracker_type": "ocsort",
            "track_high_thresh": 0.25,
            "track_low_thresh": 0.1,
            "new_track_thresh": 0.25,
            "track_buffer": 30,
            "match_thresh": 0.8,
            "fuse_score": True,
            "delta_t": 3,        # temporal window [frames] for velocity-direction estimation
            "inertia": 0.2,      # weight of the velocity-consistency cost
            "use_byte": False,   # enable a ByteTrack-style low-confidence second pass
        },
        "deepocsort": {
            "tracker_type": "deepocsort",
            "track_high_thresh": 0.3,
            "track_low_thresh": 0.1,
            "new_track_thresh": 0.3,
            "track_buffer": 30,
            "match_thresh": 0.8,
            "fuse_score": True,
            "delta_t": 3,
            "inertia": 0.2,
            "use_byte": False,
            "gmc_method": "none",
            "with_reid": False,
            "model": "auto",
            "proximity_thresh": 0.5,
            "appearance_thresh": 0.9,
            "alpha_fixed_emb": 0.95,   # base EMA factor for track-embedding updates
        },
        "fasttrack": {
            "tracker_type": "fasttrack",
            "track_high_thresh": 0.25,
            "track_low_thresh": 0.1,
            "new_track_thresh": 0.25,
            "track_buffer": 30,
            "match_thresh": 0.8,
            "fuse_score": True,
            "reset_velocity_offset_occ": 5,   # KF velocity rollback depth at occlusion onset
            "reset_pos_offset_occ": 3,        # KF position rollback depth at occlusion onset
            "enlarge_bbox_occ": 1.1,          # one-shot bbox scale while occluded
            "dampen_motion_occ": 0.5,         # velocity dampening while occluded
            "active_occ_to_lost_thresh": 10,  # occluded frames before a track goes lost
            "occ_cover_thresh": 0.7,          # covered-area fraction that declares occlusion
            "occ_reappear_window": 40,        # frames a recently occluded lost track stays findable
            "init_iou_suppress": 0.7,         # suppress new-track init above this IoU with an active track
        },
        "tracktrack": {
            "tracker_type": "tracktrack",
            "track_high_thresh": 0.6,
            "track_low_thresh": 0.25,
            "new_track_thresh": 0.7,
            "track_buffer": 30,
            "match_thresh": 0.7,
            "lost_match_thr": 0.0,   # relaxed rebind gate for still-lost tracks (0 disables)
            "iou_weight": 0.5,       # HMIoU term weight in the multi-cue cost
            "reid_weight": 0.5,
            "conf_weight": 0.1,
            "angle_weight": 0.05,
            "penalty_p": 0.2,        # cost penalty for low-confidence detections
            "penalty_q": 0.4,        # cost penalty for deleted/recovered detections
            "reduce_step": 0.05,     # per-iteration threshold reduction (iterative assignment)
            "tai_thr": 0.55,         # track-aware-initialisation NMS IoU threshold
            "min_track_len": 3,
            "gmc_method": "sparseOptFlow",
            "with_reid": False,
            "model": "auto",
        },
    },
}


def load_config(path: Optional[Union[str, Path]] = None) -> dict:
    """A deep copy of ``DEFAULT``; with ``path``, the YAML file's top-level
    sections replace the defaults key by key (one level deep)."""
    cfg = copy.deepcopy(DEFAULT)
    if path is None:
        return cfg
    import yaml  # only a caller with a YAML file needs the parser

    with open(path) as fh:
        user = yaml.safe_load(fh)
    if not isinstance(user, dict):
        raise ValueError(f"Configuration file '{path}' has no mapping at top level.")
    for section, values in user.items():
        if isinstance(values, dict) and isinstance(cfg.get(section), dict):
            cfg[section].update(values)
        else:
            cfg[section] = values
    return cfg


def select_tracker(tracker_section: dict, cfg_name="default") -> tuple:
    """Validate and return (active_tracker_name, its parameter block).

    The port's copy of ``geotrax_tpu/utils/config_utils.py:select_tracker``;
    it raises ``ValueError`` where the CLI helper logs and exits."""
    active = tracker_section.get("active")
    if active is None:
        raise ValueError(f"No 'active' tracker selector in the 'tracker' section of '{cfg_name}'.")
    if active not in TRACKER_CHOICES:
        raise ValueError(
            f"Unknown tracker '{active}' in '{cfg_name}'. Supported: {list(TRACKER_CHOICES)}."
        )
    if active not in tracker_section:
        available = [k for k in tracker_section if k != "active"]
        raise ValueError(
            f"Active tracker '{active}' has no parameter block in '{cfg_name}'. "
            f"Available: {available}."
        )
    return active, tracker_section[active]
