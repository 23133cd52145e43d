"""The configuration surface of ``geotrax_tpu/stabilize/stabilizer.py:Stabilizer``.

``StabilizerConfig(**cfg["stabilo"])`` derives the same settings the JAX
``Stabilizer.__init__`` does (feature budgets, hypothesis count, thresholds,
detector family); the fused chunk step reads them, and the sequential
``Stabilizer`` (``stabilize/stabilizer.py``) is built on them.
"""

from __future__ import annotations


class StabilizerConfig:
    def __init__(
        self,
        downsample_ratio: float = 0.5,
        max_features: int = 2000,
        ref_multiplier: float = 2.0,
        filter_ratio: float = 0.9,
        transformation_type: str = "projective",
        ransac_epipolar_threshold: float = 2.0,
        ransac_max_iter: int = 5000,
        mask_use: bool = True,
        mask_margin_ratio: float = 0.15,
        clahe: bool = False,
        detector_name: str = "orb",
        min_good_match_count_warning: int = 20,
        min_inliers_match_count_warning: int = 10,
        **_ignored,  # full stabilo config surface accepted
    ):
        self.downsample_ratio = float(downsample_ratio)
        self.max_features = int(max_features)
        self.ref_features = int(max_features * ref_multiplier)
        self.filter_ratio = float(filter_ratio)
        self.transformation_type = transformation_type
        self.ransac_threshold = float(ransac_epipolar_threshold)
        # parallel hypotheses replace sequential RANSAC iterations:
        # iterations/8, floored at 512 and capped at 4096
        self.num_hypotheses = int(min(max(ransac_max_iter // 8, 512), 4096))
        self.mask_use = bool(mask_use)
        self.mask_margin_ratio = float(mask_margin_ratio)
        self.clahe = bool(clahe)
        self.detector_name = detector_name
        # SIFT-class names run the multi-level gradient pipeline; the
        # ORB-class per-frame stabilization is single-level
        self.use_sift = detector_name in ("sift", "rsift", "kaze", "akaze")
        self.n_levels = 4 if self.use_sift else 1
        self.min_match_warning = min_good_match_count_warning
        self.min_inlier_warning = min_inliers_match_count_warning
