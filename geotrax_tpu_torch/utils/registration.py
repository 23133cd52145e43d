"""The one homography estimator of georeferencing: the port of
``geotrax_tpu/utils/registration.py``.

A one-shot src -> dst registration built on the sequential ``Stabilizer``
(dst becomes the reference frame, src is stabilized onto it): projective,
no mask, no downsampling, and a retry that halves ``max_features`` while
the fit fails and the budget is above 10000.
"""

from __future__ import annotations

import logging

import numpy as np

from geotrax_tpu_torch.stabilize.stabilizer import Stabilizer


def estimate_homography(
    img_src: np.ndarray,
    img_dst: np.ndarray,
    logger: logging.Logger,
    detector_name: str = "rsift",
    matcher_name: str = "bf",
    filter_type: str = "ratio",
    sift_enable_precise_upscale: bool = True,
    max_features: int = 250000,
    filter_ratio: float = 0.55,
    ransac_method: int = 38,
    ransac_epipolar_threshold: float = 3.0,
    ransac_max_iter: int = 10000,
    ransac_confidence: float = 0.999999,
    rsift_eps: float = 1e-8,
    device="cuda",
) -> tuple:
    """The src -> dst homography on ``device``.

    Returns (homography | None, inliers_count, num_matches,
    (src_keypoints, dst_keypoints)).

    The reference's OpenCV backend selectors (``matcher_name``,
    ``filter_type``, ``sift_enable_precise_upscale``, ``ransac_method``,
    ``ransac_confidence``, ``rsift_eps``) have one implementation here; they
    are accepted so that reference configs load, and a value other than the
    default is reported with a warning.
    """
    inert = {
        "matcher_name": (matcher_name, "bf"),
        "filter_type": (filter_type, "ratio"),
        "sift_enable_precise_upscale": (sift_enable_precise_upscale, True),
        "ransac_method": (ransac_method, 38),
        "ransac_confidence": (ransac_confidence, 0.999999),
        "rsift_eps": (rsift_eps, 1e-8),
    }
    for name, (value, default) in inert.items():
        if value != default:
            logger.warning(
                f"registration option '{name}={value}' has no effect on the "
                "port (single built-in implementation); proceeding."
            )
    features = int(max_features)
    while True:
        stab = Stabilizer(
            downsample_ratio=1.0,
            max_features=features,
            ref_multiplier=1.0,
            filter_ratio=filter_ratio,
            transformation_type="projective",
            ransac_epipolar_threshold=ransac_epipolar_threshold,
            ransac_max_iter=ransac_max_iter,
            mask_use=False,
            clahe=False,
            detector_name=detector_name,
            device=device,
        )
        try:
            stab.set_ref_frame(img_dst)
            stab.stabilize(img_src)
            homography = stab.get_cur_trans_matrix()
        except Exception as exc:  # noqa: BLE001 — a failed fit is retried smaller
            logger.warning(f"Homography estimation failed ({exc}).")
            homography = None

        if homography is not None:
            return (
                homography,
                stab.get_cur_inliers_count(),
                stab.get_cur_num_matches(),
                tuple(reversed(stab.get_cur_num_keypoints())),  # (src, dst)
            )
        if features <= 10000:
            logger.error("Homography estimation failed at the minimum feature budget.")
            return None, 0, 0, (0, 0)
        features //= 2
        logger.warning(f"Retrying homography estimation with max_features={features}.")
