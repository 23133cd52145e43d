"""Fused extraction chunk step: the whole per-chunk computation on the card.

Counterpart of ``geotrax_tpu/pipeline/device_pipeline.py:FusedExtractor``.
With stabilization on (the default ``extract`` configuration):

    cv2-exact 0.5x resize -> YOLOv8 forward -> NMS     (batched over the chunk)
    -> FAST (CUDA kernel) / grid descriptors / L2      (batched over the chunk,
       match / RANSAC against the reference frame       masked by this chunk's
                                                        own detections)
    -> GMC homographies                                (consecutive-frame motion)
    -> ReID embeddings (with_reid: patch gather        (batched; CUDA kernel)
       kernel, projection or learned head)
    -> tracker over the chunk's frames                 (sequential, on the card)
    -> stabilized-box corner transform                 (batched)

The host uploads the raw uint8 frames once per chunk; tracker state, the
reference-frame features and the previous frame's homography stay on the
card between chunks. RANSAC draws are the reference's: uniforms from
``fold_in(PRNGKey(rng_seed), frame id)`` (JAX's threefry, ``ops/prng.py``),
so they equal the reference's and do not depend on where the chunk
boundaries fall. With ``stabilo.clahe`` the gray is equalized
(``ops/clahe.py``) and the detector letterboxes the full frame itself.

With stabilization off (``stabilo_cfg=None``) the chunk detects and tracks
only, after the same hoisted resize; a tracker that wants camera-motion
compensation gets it from a standalone GMC: ``GMC_FEATURES`` corners per
frame matched against the previous frame's and an affine fit of
``GMC_HYPOTHESES`` hypotheses, the previous chunk's last features carried
into the next chunk's first fit, each frame's draw keyed as above.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function

from geotrax_tpu_torch._device import resolve_device, to_device
from geotrax_tpu_torch.ops import features, prng
from geotrax_tpu_torch.ops.clahe import clahe
from geotrax_tpu_torch.ops.homography import adjugate3, normalize_h
from geotrax_tpu_torch.ops.patches import PATCH, patches32_hwc
from geotrax_tpu_torch.ops.ransac import ransac_fit, sample_indices, sample_weights
from geotrax_tpu_torch.ops.resize import resize_u8_linear
from geotrax_tpu_torch.ops.sift import match_l2
from geotrax_tpu_torch.stabilize.config import StabilizerConfig
from geotrax_tpu_torch.track import reid
from geotrax_tpu_torch.track.base import EMB_DIM, FrameOutput

GMC_FEATURES = 512         # standalone-GMC corner budget per frame
GMC_HYPOTHESES = 256

@lru_cache(maxsize=2)
def _emb_projection(din: int, dout: int) -> np.ndarray:
    """Fixed orthonormal-ish projection for the appearance embedding: the
    reference's seeded numpy QR (``default_rng(11)``), as the port's copy."""
    rng = np.random.default_rng(11)
    m = rng.normal(0.0, 1.0, (din, dout))
    q, _ = np.linalg.qr(m)
    return q.astype(np.float32)


@lru_cache(maxsize=8)
def _scale_pair(s: float, device: str) -> tuple:
    """(S, S^-1) for the feature-space ratio ``s`` on ``device``, made once."""
    return (torch.as_tensor(np.diag([s, s, 1.0]), dtype=torch.float32, device=device),
            torch.as_tensor(np.diag([1.0 / s, 1.0 / s, 1.0]), dtype=torch.float32,
                            device=device))


@lru_cache(maxsize=4)
def _projection_on(din: int, dout: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_emb_projection(din, dout)).to(device)


def embed_boxes(frames_u8: torch.Tensor, boxes_xywh: torch.Tensor, emb_dim: int = EMB_DIM,
                pooled: Optional[torch.Tensor] = None, head_params: Optional[dict] = None,
                gather: Callable = patches32_hwc) -> torch.Tensor:
    """(C,H,W,3) uint8 + (C,M,4) full-res cxcywh -> (C,M,emb_dim) L2-normed
    appearance embeddings: a 32x32 RGB patch at each box centre on the
    0.5x-pooled image, 4x4-averaged per channel and projected through a
    fixed orthonormal matrix, or fed to the learned head ``head_params``
    (track/reid.py). ``pooled`` is an existing (C,H/2,W/2,3) uint8
    half-resolution image (the shared resize) used instead of 2x2-pooling
    the frames.

    The patches (or their 4x4 means) of every channel of every frame come
    from one ``gather`` call on the uint8 image itself: the CUDA kernel on
    the card (``ops/patches.py:patches32_hwc``), which pools the frames where
    it reads them; ``gather`` is replaceable only so that a check can run
    the plain version on the same inputs."""
    c, h, w = frames_u8.shape[:3]
    h2, w2 = h // 2, w // 2
    half = PATCH // 2
    # the int32 cast truncates toward zero, as the reference's astype does
    x0 = torch.clamp((boxes_xywh[..., 0] * 0.5).to(torch.int32) - half, 0, w2 - PATCH)
    y0 = torch.clamp((boxes_xywh[..., 1] * 0.5).to(torch.int32) - half, 0, h2 - PATCH)
    m = x0.shape[1]
    image = frames_u8 if pooled is None else pooled
    got = gather(image.contiguous(), x0, y0, pool2=pooled is None, mean4=head_params is None)
    if head_params is not None:                                          # (C,M,3,32,32)
        return reid._embed_nchw(head_params, got.reshape(c * m, 3, PATCH, PATCH)).reshape(c, m, -1)
    flat = got.reshape(c, m, 3 * 64)                                     # (C,M,3,8,8)
    emb = flat @ _projection_on(flat.shape[-1], emb_dim, flat.device)
    return emb / torch.clamp_min(torch.linalg.vector_norm(emb, dim=-1, keepdim=True), 1e-12)


class RefFeatures(NamedTuple):
    xy: torch.Tensor     # (K, 2)
    desc: torch.Tensor   # (K, T)
    valid: torch.Tensor  # (K,)


class ChunkOutput(NamedTuple):
    """Per-frame results for one chunk, stacked on the leading chunk axis."""
    track_id: torch.Tensor   # (C, K)
    box_xywh: torch.Tensor   # (C, K, 4)
    box_stab: torch.Tensor   # (C, K, 4) boxes in reference-frame coords
    score: torch.Tensor      # (C, K)
    cls: torch.Tensor        # (C, K)
    valid: torch.Tensor      # (C, K)
    h: torch.Tensor          # (C, 3, 3) cur->ref stabilization homographies
    gmc: torch.Tensor        # (C, 3, 3) prev->cur camera-motion homographies
    inliers: torch.Tensor    # (C,)
    matches: torch.Tensor    # (C,)


def _transform_boxes_h(h: torch.Tensor, boxes_xywh: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) x (..., K, 4) cxcywh -> corner transform + axis-aligned
    refit (the convention of Stabilizer.transform_cur_boxes)."""
    cx, cy, w, hh = boxes_xywh.unbind(-1)
    corners = torch.stack([
        torch.stack([cx - w / 2, cy - hh / 2], -1),
        torch.stack([cx + w / 2, cy - hh / 2], -1),
        torch.stack([cx + w / 2, cy + hh / 2], -1),
        torch.stack([cx - w / 2, cy + hh / 2], -1),
    ], dim=-2)  # (..., K, 4, 2)
    lead = corners.shape[:-3]
    corners = corners.reshape(lead + (-1, 2))
    ones = torch.ones(corners.shape[:-1] + (1,), dtype=corners.dtype, device=corners.device)
    mapped = torch.matmul(torch.cat([corners, ones], -1), h.transpose(-1, -2))
    pts = (mapped[..., :2] / (mapped[..., 2:3] + 1e-12)).reshape(lead + (-1, 4, 2))
    mins, maxs = pts.amin(dim=-2), pts.amax(dim=-2)
    return torch.cat([(mins + maxs) / 2, maxs - mins], dim=-1)



def gmc_from_h(h_cur: torch.Tensor, h_prev: torch.Tensor) -> torch.Tensor:
    """prev->cur camera motion from consecutive stabilization H's:
    gmc = H_cur^-1 @ H_prev via the scale-free adjugate."""
    return normalize_h(adjugate3(h_cur) @ h_prev)


class FusedExtractor:
    """Per-video fused extraction over fixed-size frame chunks.

        fx = FusedExtractor(detector, stabilo_cfg, tracker_step, tracker_state,
                            src_h, src_w, use_gmc=..., chunk=32)
        for frames, fids, n_valid in chunks:        # frames (C,H,W,3) uint8
            out = fx.process_chunk(frames, fids, n_valid)

    ``sampler(fids, weights, num_hypotheses, sample_size) -> (C,H,S)`` draws
    the RANSAC hypothesis indices; the default draws the reference's:
    frame ``fid`` from ``fold_in(PRNGKey(rng_seed), fid)``, made on the host,
    so every device draws the same indices.
    """

    def __init__(self, detector, stabilo_cfg: Optional[dict], tracker_step,
                 tracker_state, src_h: int, src_w: int, use_gmc: bool,
                 chunk: int = 16, rng_seed: int = 0, with_reid: bool = False,
                 reid_params: Optional[dict] = None, device="cuda",
                 sampler: Optional[Callable] = None):
        self.device = resolve_device(device)
        self.detector = detector
        self.chunk = chunk
        self.src_h, self.src_w = src_h, src_w
        self.tracker_step = tracker_step
        self.state = tracker_state
        self.use_gmc = use_gmc
        self.with_reid = with_reid
        # learned ReID head (track/reid.py); None embeds by projection
        self.reid_params = None if reid_params is None else {
            k: v.to(self.device) for k, v in reid_params.items()}
        self._detect = detector.batch_trace(src_h, src_w)
        self._detect_resized = None
        self._resize_geom = None
        self.stab_on = stabilo_cfg is not None
        self.proto = None
        geom = detector.resize_geometry(src_h, src_w) if hasattr(
            detector, "batch_trace_resized") else None
        if self.stab_on:
            proto = StabilizerConfig(**stabilo_cfg)
            if proto.n_levels != 1:
                raise ValueError("FusedExtractor supports the single-level (orb-class) path")
            self.proto = proto
            # Shared-resize fast path: when the stabilizer's downsample
            # ratio equals the letterbox scale (the default 4K @ imgsz 1920
            # config: both 0.5) and no CLAHE intervenes, ONE cv2-exact
            # resize of the raw frame feeds both the detector letterbox and
            # the stabilization gray.
            if geom is not None and not proto.clahe and (
                abs(geom[2] - proto.downsample_ratio) < 1e-12
                and geom[0] == round(src_h * proto.downsample_ratio)
                and geom[1] == round(src_w * proto.downsample_ratio)
            ):
                self._resize_geom = geom[:2]
        elif geom is not None:
            # detect + track only: the hoisted resize gives the same
            # detections as the letterbox inside the detector
            self._resize_geom = geom[:2]
        if self._resize_geom is not None:
            self._detect_resized = detector.batch_trace_resized(src_h, src_w)

        self._seed0 = rng_seed
        self._key = prng.PRNGKey(rng_seed)
        self._sampler = sampler if sampler is not None else self._draw_indices
        self._state0 = tracker_state
        self._h_prev = torch.eye(3, device=self.device)
        self._ref: Optional[RefFeatures] = None
        self._gmc_carry: Optional[RefFeatures] = None  # standalone GMC: the previous frame's

    # ------------------------------------------------------------ stages
    def _draw_indices(self, fids, weights, num_hypotheses: int, sample_size: int):
        keys = prng.fold_in(self._key, np.asarray(fids, np.int64))
        return sample_indices(keys, num_hypotheses, sample_size, weights)

    def _ratio(self) -> float:
        return self.proto.downsample_ratio if self.proto else 0.5

    def _gray(self, frames_u8):
        gray = features.downsample(features.rgb_to_gray(frames_u8), self._ratio())
        if self.proto and self.proto.clahe:
            gray = clahe(gray)
        return gray

    def _feats(self, gray, det_boxes, det_valid, n_features):
        mask = None
        if self.proto is None or self.proto.mask_use:
            margin = self.proto.mask_margin_ratio if self.proto else 0.15
            boxes = torch.where(det_valid[..., None], det_boxes, 0.0) * self._ratio()
            mask = features.boxes_mask(gray.shape[-2:], boxes, margin)
        kps = features.fast_detect(gray, n_features, mask=mask, oriented=False)
        desc = features.describe_grid(gray, kps)
        return kps.xy, desc, kps.valid

    def _fit(self, xy, valid_kp, desc, ref: RefFeatures, fids, *, n_hyps,
             transformation, threshold, filter_ratio):
        matches = match_l2(desc, valid_kp, ref.desc, ref.valid, ratio=filter_ratio)
        sample_size = 4 if transformation == "projective" else 3
        idx = self._sampler(fids, sample_weights(matches.valid), n_hyps, sample_size)
        if ref.xy.dim() == 2:  # one reference frame for every frame
            dst = ref.xy[matches.idx_b]
        else:  # a reference per frame (standalone GMC: the previous frame)
            dst = torch.gather(ref.xy, 1, matches.idx_b[..., None].expand(-1, -1, 2))
        res = ransac_fit(xy, dst, matches.valid, threshold=threshold,
                         num_hypotheses=n_hyps, transformation=transformation,
                         sample_idx=idx)
        return res.h_matrix, res.num_inliers, matches.valid.sum(dim=-1)

    def _unscale(self, h_ds):
        """Undo feature-space downsampling: H_full = S^-1 H_ds S."""
        scale, inv_scale = _scale_pair(self._ratio(), str(h_ds.device))
        return inv_scale @ h_ds @ scale

    def _run_tracker(self, det, gmc, fids_t, n_valid: int, det_emb=None) -> FrameOutput:
        """The tracker over the chunk's frames in order (frames past
        ``n_valid`` are padding: state unchanged, no valid output). Each
        step gets its frame id as a tensor on the device (``fids_t[t]``), so
        botsort's and bytetrack's steps read nothing back to the host."""
        state = self.state
        outs = []
        for t in range(fids_t.shape[0]):
            if t < n_valid:
                state, out = self.tracker_step(
                    state, det["boxes_xywh"][t], det["scores"][t], det["classes"][t],
                    det["valid"][t], fids_t[t], gmc[t] if self.use_gmc else None,
                    det_emb[t] if det_emb is not None else None,
                )
            else:
                k = state.track_id.shape[0]
                dev = state.track_id.device
                out = FrameOutput(
                    track_id=state.track_id,
                    box_xywh=torch.zeros((k, 4), device=dev),
                    score=torch.zeros((k,), device=dev),
                    cls=state.cls,
                    valid=torch.zeros((k,), dtype=torch.bool, device=dev),
                )
            outs.append(out)
        self.state = state
        return FrameOutput(*(torch.stack(field) for field in zip(*outs)))

    def _chunk_impl(self, frames_u8, fids, n_valid: int, first: bool):
        c = frames_u8.shape[0]
        dev = frames_u8.device
        fids_t = to_device(fids, dev)
        resized = None
        with record_function("fx.detect"):
            if self._detect_resized is not None:
                nh, nw = self._resize_geom
                resized = resize_u8_linear(frames_u8, nh, nw)
                det = self._detect_resized(resized, fids_t)
            else:
                det = self._detect(frames_u8, fids_t)
        det_boxes, det_valid = det["boxes_xywh"], det["valid"]
        det_emb = None
        if self.with_reid:
            with record_function("fx.reid"):
                half_geom = (frames_u8.shape[1] // 2, frames_u8.shape[2] // 2)
                det_emb = embed_boxes(
                    frames_u8, det_boxes,
                    pooled=resized if self._resize_geom == half_geom else None,
                    head_params=self.reid_params,
                )
        eye = torch.eye(3, device=dev)
        h = eye.expand(c, 3, 3).clone()
        inliers = torch.zeros((c,), dtype=torch.int32, device=dev)
        n_matches = torch.zeros((c,), dtype=torch.int32, device=dev)
        gmc = eye.expand(c, 3, 3).clone()
        if self.stab_on:
            h, inliers, n_matches = self._stabilize(frames_u8, resized, det_boxes, det_valid,
                                                    fids, first)
            if self.use_gmc:
                # gmc_t = H_t^-1 . H_{t-1}  (adjugate = scale-free inverse)
                gmc = gmc_from_h(h, torch.cat([self._h_prev[None], h[:-1]], dim=0))
        elif self.use_gmc:
            gmc = self._standalone_gmc(frames_u8, det_boxes, det_valid, fids)

        with record_function("fx.tracker"):
            outs = self._run_tracker(det, gmc, fids_t, n_valid, det_emb)

        box_stab = _transform_boxes_h(h, outs.box_xywh)
        self._h_prev = h[-1]
        return ChunkOutput(
            track_id=outs.track_id, box_xywh=outs.box_xywh, box_stab=box_stab,
            score=outs.score, cls=outs.cls, valid=outs.valid,
            h=h, gmc=gmc, inliers=inliers, matches=n_matches,
        )

    def _stabilize(self, frames_u8, resized, det_boxes, det_valid, fids, first: bool) -> tuple:
        """(cur->ref homographies, inliers, matches) of the chunk's frames
        against the reference frame (this chunk's frame 0 when ``first``)."""
        eye = torch.eye(3, device=frames_u8.device)
        with record_function("fx.features"):
            grays = features.rgb_to_gray(resized) if resized is not None else self._gray(frames_u8)
            xy, desc, val = self._feats(grays, det_boxes, det_valid, self.proto.max_features)
            if first:
                # the reference frame is this chunk's frame 0, with the
                # larger reference feature budget
                rxy, rdesc, rval = self._feats(grays[:1], det_boxes[:1], det_valid[:1],
                                               self.proto.ref_features)
                self._ref = RefFeatures(rxy[0], rdesc[0], rval[0])
        transformation = "projective" if self.proto.transformation_type == "projective" else "affine"
        with record_function("fx.match_ransac"):
            h_ds, inl, nm = self._fit(
                xy, val, desc, self._ref, fids,
                n_hyps=self.proto.num_hypotheses, transformation=transformation,
                threshold=self.proto.ransac_threshold, filter_ratio=self.proto.filter_ratio,
            )
        h_full = self._unscale(h_ds)
        denom = h_full[:, 2, 2]
        ok = (nm >= 4) & torch.isfinite(h_full).all(dim=2).all(dim=1) & (denom.abs() > 1e-12)
        h = torch.where(
            ok[:, None, None],
            h_full / torch.where(ok, denom, 1.0)[:, None, None],
            eye[None],
        )
        if first:
            # frame 0 IS the reference frame -> exact identity
            h[0] = eye
        return h, torch.where(ok, inl, 0).to(torch.int32), nm.to(torch.int32)

    def _standalone_gmc(self, frames_u8, det_boxes, det_valid, fids) -> torch.Tensor:
        """prev->cur camera motion with stabilization off: each frame's
        corners matched against the previous frame's (the carry from the
        previous chunk for the first frame), one affine fit per frame."""
        eye = torch.eye(3, device=frames_u8.device)
        with record_function("fx.features"):
            xy, desc, val = self._feats(self._gray(frames_u8), det_boxes, det_valid, GMC_FEATURES)
        prev = self._gmc_carry
        if prev is None:  # the video's first frame: no features to match
            prev = RefFeatures(torch.zeros_like(xy[0]), torch.zeros_like(desc[0]),
                               torch.zeros_like(val[0]))
        with record_function("fx.match_ransac"):
            h_ds, _, nm = self._fit(
                torch.cat([prev.xy[None], xy[:-1]]), torch.cat([prev.valid[None], val[:-1]]),
                torch.cat([prev.desc[None], desc[:-1]]), RefFeatures(xy, desc, val), fids,
                n_hyps=GMC_HYPOTHESES, transformation="affine", threshold=2.0, filter_ratio=0.9,
            )
        h_full = self._unscale(h_ds)
        self._gmc_carry = RefFeatures(xy[-1], desc[-1], val[-1])
        ok = (nm >= 3) & torch.isfinite(h_full).all(dim=2).all(dim=1)
        return torch.where(ok[:, None, None], h_full, eye[None])

    # ------------------------------------------------------------ host API
    def reset(self, rng_seed: Optional[int] = None) -> None:
        """Restart per-video state (tracker slots, reference features,
        standalone-GMC carry, h_prev, RNG base key)."""
        self.state = self._state0
        self._h_prev = torch.eye(3, device=self.device)
        self._ref = None
        self._gmc_carry = None
        self._key = prng.PRNGKey(self._seed0 if rng_seed is None else rng_seed)

    def process_chunk(self, frames_u8, fids, n_valid: int) -> ChunkOutput:
        """frames (C,H,W,3) uint8 (numpy or tensor), fids (C,) internal frame
        ids (1-based), n_valid <= C real frames. Returns tensors on the
        extractor's device."""
        frames = torch.as_tensor(frames_u8).to(self.device)
        fids = [int(f) for f in np.asarray(fids).reshape(-1)]
        first = self._ref is None and self.stab_on
        with torch.no_grad():
            return self._chunk_impl(frames, fids, int(n_valid), first)
