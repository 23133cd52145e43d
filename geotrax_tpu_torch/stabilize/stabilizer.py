"""The sequential stabilization engine with the Stabilo API surface.

The port of ``geotrax_tpu/stabilize/stabilizer.py:Stabilizer``: one frame at
a time, the homography from the current frame to a reference frame, with
vehicle masking, downsampled features, ratio-test matching and the
parallel-hypothesis RANSAC. Georeferencing registers images with it
(``utils/registration.py``: the destination is set as the reference and the
source is "stabilized" onto it).

    Stabilizer(**cfg, device=...)          cfg = the YAML 'stabilo' section
    set_ref_frame(frame, boxes|None)
    stabilize(frame, boxes|None)
    transform_cur_boxes() -> (N,4) boxes in reference coords | None
    get_cur_trans_matrix() -> 3x3 cur->ref homography | None
    get_cur_num_keypoints() -> (ref_count, cur_count)
    get_cur_num_matches() -> int
    get_cur_inliers_count() -> int

Two branches, as the reference takes them: SIFT-class detector names run
the RootSIFT scale space (``ops/sift.py``) with L2 matching; every other
name runs the single-level path (unoriented FAST through the CUDA score
kernel, the grid descriptor, ``match_l2``). Frame ``fid`` (the reference
frame is 1) draws its RANSAC samples from ``fold_in(PRNGKey(0), fid)``.
A frame may be a host array or a tensor; a tensor on the stabilizer's
device is used where it lies (the extract loop's frames are already on the
card).
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from geotrax_tpu_torch._device import resolve_device
from geotrax_tpu_torch.ops import features, prng, sift
from geotrax_tpu_torch.ops.homography import apply_homography
from geotrax_tpu_torch.ops.ransac import ransac_fit
from geotrax_tpu_torch.stabilize.config import StabilizerConfig

_LOG = logging.getLogger("geotrax")


class Stabilizer(StabilizerConfig):
    def __init__(self, *args, device="cuda", **kwargs):
        super().__init__(*args, **kwargs)
        self.device = resolve_device(device)
        self._ref = None      # (keypoints, descriptors)
        self._key = prng.PRNGKey(0)
        self._fid = 1
        self._cur_boxes = None
        self._cur_h: Optional[np.ndarray] = None
        self._cur_boxes_ref: Optional[np.ndarray] = None
        self._cur_counts = (0, 0)
        self._cur_matches = 0
        self._cur_inliers = 0
        # box-mask slots of the single-level path: the detector's max_det
        # default (1000), so no vehicle goes unmasked
        self.mask_slots = 1024

    # ------------------------------------------------------------------ internals
    def _gray(self, frame) -> torch.Tensor:
        if not isinstance(frame, torch.Tensor):
            frame = torch.as_tensor(np.asarray(frame))
        gray = features.rgb_to_gray(frame.to(self.device))
        gray = features.downsample(gray, self.downsample_ratio)
        if self.clahe:
            from geotrax_tpu_torch.ops.clahe import clahe

            gray = clahe(gray)
        return gray

    def _features(self, gray: torch.Tensor, mask, n_features: int) -> tuple:
        if self.use_sift:
            # masked before the per-level budget selection, so vehicles do
            # not use up the static background's budget
            feats = sift.detect_and_describe(gray, n_features, mask=mask)
            kps = features.Keypoints(xy=feats.xy, score=feats.score, angle=feats.angle,
                                     valid=feats.valid)
            return kps, feats.desc
        # same-scale consecutive frames: float grid descriptors
        kps = features.fast_detect(gray, n_features, mask=mask, oriented=False)
        return kps, features.describe_grid(gray, kps)

    def _prepare(self, frame, boxes, n_features: int) -> tuple:
        gray = self._gray(frame)
        mask = None
        if self.mask_use and boxes is not None and len(boxes):
            scaled = torch.as_tensor(np.asarray(boxes, np.float32)[:, :4],
                                     device=self.device) * self.downsample_ratio
            mask = features.boxes_mask(tuple(gray.shape), scaled, self.mask_margin_ratio)
        return self._features(gray, mask, n_features)

    def _transformation(self) -> str:
        return "projective" if self.transformation_type == "projective" else "affine"

    def _fail(self) -> None:
        self._cur_h = None
        self._cur_inliers = 0
        self._cur_boxes_ref = None

    # ------------------------------------------------------------------ API
    def set_ref_frame(self, frame, boxes=None) -> None:
        """Fix the reference frame (its features at the ref_multiplier budget)."""
        self._ref = self._prepare(frame, boxes, self.ref_features)
        self._fid = 1

    def stabilize(self, frame, boxes=None) -> None:
        """Estimate the cur->ref homography of this frame."""
        if self._ref is None:
            raise RuntimeError("set_ref_frame must be called before stabilize")
        self._cur_boxes = None if boxes is None else np.asarray(boxes, np.float32)
        ref_kps, ref_desc = self._ref
        self._fid += 1
        key = prng.fold_in(self._key, self._fid)
        mask_boxes = self._cur_boxes
        if mask_boxes is not None and not self.use_sift:
            mask_boxes = mask_boxes[:self.mask_slots]  # the reference's fixed mask slots
        kps, desc = self._prepare(frame, mask_boxes, self.max_features)
        self._cur_counts = (int(ref_kps.valid.sum()), int(kps.valid.sum()))
        matches = sift.match_l2(desc, kps.valid, ref_desc, ref_kps.valid, ratio=self.filter_ratio)
        self._cur_matches = int(matches.valid.sum())
        if self._cur_matches < 4:
            return self._fail()
        result = ransac_fit(kps.xy[matches.idx_a], ref_kps.xy[matches.idx_b], matches.valid,
                            threshold=self.ransac_threshold, key=key,
                            num_hypotheses=self.num_hypotheses,
                            transformation=self._transformation())
        self._cur_inliers = int(result.num_inliers)
        result_h = result.h_matrix.cpu().numpy()

        if self._cur_matches < self.min_match_warning:
            _LOG.warning(f"Low match count ({self._cur_matches} < {self.min_match_warning}); "
                         "homography may be unreliable.")
        if self._cur_inliers < self.min_inlier_warning:
            _LOG.warning(f"Low inlier count ({self._cur_inliers} < {self.min_inlier_warning}); "
                         "homography may be unreliable.")

        # undo the downsampling: H_full = S^-1 · H_ds · S
        s = self.downsample_ratio
        scale = np.diag([s, s, 1.0]).astype(np.float32)
        h_full = np.linalg.inv(scale) @ result_h @ scale
        # a degenerate fit (near-collinear matches) is reported as a failure
        if not np.all(np.isfinite(h_full)) or abs(h_full[2, 2]) < 1e-12:
            self._cur_h = None
            self._cur_boxes_ref = None
            return None
        self._cur_h = h_full / h_full[2, 2]

        if self._cur_boxes is not None and len(self._cur_boxes):
            # move the four corners, refit the axis-aligned box
            cx, cy, w, h = (self._cur_boxes[:, i] for i in range(4))
            corners = np.stack([
                np.stack([cx - w / 2, cy - h / 2], -1),
                np.stack([cx + w / 2, cy - h / 2], -1),
                np.stack([cx + w / 2, cy + h / 2], -1),
                np.stack([cx - w / 2, cy + h / 2], -1),
            ], axis=1)  # (N,4,2)
            moved = apply_homography(torch.as_tensor(self._cur_h, dtype=torch.float32),
                                     torch.as_tensor(corners.reshape(-1, 2))[None])[0]
            moved = moved.numpy().reshape(-1, 4, 2)
            mins = moved.min(axis=1)
            maxs = moved.max(axis=1)
            out = self._cur_boxes.copy()
            out[:, 0:2] = (mins + maxs) / 2
            out[:, 2:4] = maxs - mins
            self._cur_boxes_ref = out
        else:
            self._cur_boxes_ref = self._cur_boxes
        return None

    def transform_cur_boxes(self):
        return self._cur_boxes_ref

    def get_cur_trans_matrix(self):
        return self._cur_h

    def get_cur_num_keypoints(self):
        return self._cur_counts

    def get_cur_num_matches(self):
        return self._cur_matches

    def get_cur_inliers_count(self):
        return self._cur_inliers
