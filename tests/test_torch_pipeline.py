"""The whole extract chunk path of the port against the JAX package.

The same SyntheticVideoReader clip (320x240, 20 frames) and oracle
detections go through both FusedExtractors (chunk 8, default stabilo and
botsort configuration, GMC on) and both row emitters (the rows before
post-processing; tests/test_torch_extract_file.py compares the files that
``extract`` writes). The port's RANSAC is handed the indices that the JAX
package draws from fold_in(key, frame id) (``jax_sampler``), except in
``test_rows_match_jax_moving_camera_default_draw``, where the port draws
them itself, as it does by default. Frame numbers, track ids, classes and
scores must be equal; boxes and stabilized boxes agree within BOX_ATOL px;
homographies within LIN_TOL in their linear and perspective entries and
TRANS_TOL px in translation.

Two clips:

- the static background of the reference's reader, against the reference
  as it is. It solves RANSAC's 9x9 normal equations in float32, whose
  smallest eigenvector on this clip's near-exact integer correspondences is
  off by up to ~0.02 px of translation and ~2e-4 in the linear entries
  against a float64 solve; the port solves them in float64
  (ops/homography.py), so the two differ by the reference's own float32
  error (LIN_TOL_F32 for the linear and perspective entries).
- a moving camera (translation, rotation and zoom per frame), so that the
  stabilization homographies, the GMC matrices, the S^-1 H S unscaling and
  the tracker's GMC compensation are far from the identity. On noisy
  correspondences the reference's float32 eigensolve is off by ~0.1 px, so
  here the reference's eigensolve runs in float64 as the port's does (a
  pure_callback to numpy inside the reference's own fit, patched for this
  run only); everything else is the reference's. Both are also held to the
  camera's true homographies."""

import logging
import tempfile

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from geotrax_tpu.io.video import SyntheticVideoReader as JaxReader
from geotrax_tpu.models.detector import OracleDetector as JaxOracle
from geotrax_tpu.ops import homography as jh
from geotrax_tpu.ops import ransac as jr
from geotrax_tpu.pipeline import _extract_impl
from geotrax_tpu.pipeline import device_pipeline as jdp
from geotrax_tpu.track import make_tracker as jax_make_tracker
from geotrax_tpu_torch import cfg as tcfg
from geotrax_tpu_torch.io.synthetic import SyntheticVideoReader
from geotrax_tpu_torch.models.detector import OracleDetector
from geotrax_tpu_torch.pipeline import extract as textract
from geotrax_tpu_torch.pipeline import device_pipeline as tdp
from geotrax_tpu_torch.pipeline.device_pipeline import FusedExtractor
from geotrax_tpu_torch.track import make_tracker

CHUNK = 8
TRACKS = 256
BOX_ATOL = 0.05
LIN_TOL = 1e-4
TRANS_TOL = 0.05
# against the reference's float32 eigensolve (static clip): its linear
# entries differ from a float64 solve's by up to 1.75e-4 here
LIN_TOL_F32 = 5e-4
# per frame: 0.5 px right, 0.3 px up, 0.2 degrees, 0.2 % zoom
CAMERA = (0.5, -0.3, 0.2, 1.002)


def jax_sampler(fids, weights, num_hypotheses, sample_size):
    """The indices the JAX chunk step draws for these frames and weights."""
    base = jax.random.PRNGKey(0)
    w = weights.cpu().numpy()
    idx = [
        np.array(jr._sample_indices(jax.random.fold_in(base, f), num_hypotheses, sample_size,
                                    w.shape[-1], jnp.asarray(w[i])))
        for i, f in enumerate(fids)
    ]
    return torch.from_numpy(np.stack(idx)).long()


def boxes_fn(reader):
    return lambda idx: [list(b) + [0.9, idx % 2] for b in reader.boxes_at(idx)]


def fit_homography_normal_eigh64(src, dst, weights=None):
    """The reference's ``fit_homography_normal`` with its 9x9 eigensolve done
    in float64 on the host, as the port does it."""
    t_src = jh._normalization_transform(src)
    t_dst = jh._normalization_transform(dst)
    s = jh.apply_homography(t_src, src)
    d = jh.apply_homography(t_dst, dst)
    x, y = s[..., 0], s[..., 1]
    u, v = d[..., 0], d[..., 1]
    zero = jnp.zeros_like(x)
    one = jnp.ones_like(x)
    row1 = jnp.stack([-x, -y, -one, zero, zero, zero, u * x, u * y, u], axis=-1)
    row2 = jnp.stack([zero, zero, zero, -x, -y, -one, v * x, v * y, v], axis=-1)
    a = jnp.concatenate([row1, row2], axis=-2)
    if weights is not None:
        w = jnp.concatenate([weights, weights], axis=-1)[..., None]
        a = a * jnp.sqrt(jnp.maximum(w, 0.0))
    with jax.default_matmul_precision("highest"):
        ata = jnp.einsum("...ni,...nj->...ij", a, a)
        vecs = jax.pure_callback(
            lambda m: np.linalg.eigh(np.asarray(m, np.float64))[1].astype(np.float32),
            jax.ShapeDtypeStruct(ata.shape, jnp.float32), ata, vmap_method="broadcast_all",
        )
        h_norm = vecs[..., :, 0].reshape(src.shape[:-2] + (3, 3))
        h = jh._sim_inverse(t_dst) @ h_norm @ t_src
    return jh.normalize_h(h)


def botsort_params(reid=False):
    return {**tcfg.DEFAULT["tracker"]["botsort"], "with_reid": reid}


def run_jax(reader, eigh64=False, reid=False):
    det = JaxOracle(boxes_fn(reader))
    tracker = botsort_params(reid)
    tcfg_j, tstate, tstep = jax_make_tracker("botsort", tracker, max_tracks=TRACKS)
    config = {"main": {"class_names": {}}, "stabilo": dict(tcfg.DEFAULT["stabilo"])}
    mp = pytest.MonkeyPatch()
    mp.setattr(_extract_impl, "FUSED_CHUNK", CHUNK)
    if eigh64:
        mp.setattr(jr, "fit_homography_normal", fit_homography_normal_eigh64)
        jax.clear_caches()  # retrace ransac_fit with the patched fit
    try:
        tracks, transforms, _ = _extract_impl._track_video_fused(
            None, config, logging.getLogger("test-torch-pipeline"), reader, det, tcfg_j,
            tstate, tstep, True, 0,
        )
    finally:
        mp.undo()
        if eigh64:
            jax.clear_caches()
    return tracks, transforms


def run_port(reader, out_dir, reid=False, sampler=jax_sampler):
    """The port's rows and transforms, written by its row emitter; the
    stats of the run with the two file paths."""
    det = OracleDetector(boxes_fn(reader), device="cpu")
    tracker_cfg, tstate, tstep = make_tracker("botsort", botsort_params(reid), max_tracks=TRACKS,
                                              device="cpu")
    fx = FusedExtractor(det, tcfg.DEFAULT["stabilo"], tstep, tstate, 240, 320, use_gmc=True,
                        chunk=CHUNK, device="cpu", sampler=sampler,
                        with_reid=tracker_cfg.with_reid)
    tracks, transforms, stats = textract.track_video_fused(reader, fx, chunk=CHUNK)
    tracks_file, transforms_file = textract.save_results(tracks, transforms, out_dir, "V_torch")
    stats.update(tracks_file=tracks_file, transforms_file=transforms_file,
                 n_transforms=len(transforms))
    return stats


def moving_reader():
    return SyntheticVideoReader(width=320, height=240, n_frames=20, camera=CAMERA)


@pytest.fixture(scope="module")
def jax_rows():
    return run_jax(JaxReader(width=320, height=240, n_frames=20))


@pytest.fixture(scope="module")
def torch_run(tmp_path_factory):
    # the extract default (max_det 1000 -> 1000 slots); the parity run uses
    # fewer slots to keep the JAX compile short
    assert textract.make_extract_tracker(tcfg.DEFAULT, device="cpu")[1].track_id.shape[0] == 1000
    return run_port(SyntheticVideoReader(width=320, height=240, n_frames=20),
                    tmp_path_factory.mktemp("torch_extract"))


@pytest.fixture(scope="module")
def jax_rows_moving():
    return run_jax(moving_reader(), eigh64=True)


@pytest.fixture(scope="module")
def torch_run_moving(tmp_path_factory):
    return run_port(moving_reader(), tmp_path_factory.mktemp("torch_extract_moving"))


@pytest.fixture(scope="module")
def torch_run_moving_default_draw(tmp_path_factory):
    return run_port(moving_reader(), tmp_path_factory.mktemp("torch_extract_default_draw"),
                    sampler=None)


@pytest.fixture(scope="module")
def jax_rows_reid():
    return run_jax(moving_reader(), eigh64=True, reid=True)


@pytest.fixture(scope="module")
def torch_run_reid(tmp_path_factory):
    return run_port(moving_reader(), tmp_path_factory.mktemp("torch_extract_reid"), reid=True)


def assert_rows_match(t_tracks, t_transf, j_tracks, j_transf, lin_tol=LIN_TOL):
    assert t_tracks.shape == j_tracks.shape and t_tracks.shape[1] == 12
    assert len(t_tracks) > 30
    # %g keeps 6 significant digits: compare the JAX rows as they would be written
    j_tracks = np.array([[float(f"{v:g}") for v in row] for row in j_tracks])
    for col, name in [(0, "frame"), (1, "id"), (10, "class"), (11, "score")]:
        np.testing.assert_array_equal(t_tracks[:, col], j_tracks[:, col], err_msg=name)
    np.testing.assert_allclose(t_tracks[:, 2:6], j_tracks[:, 2:6], rtol=1e-5, atol=BOX_ATOL)
    np.testing.assert_allclose(t_tracks[:, 6:10], j_tracks[:, 6:10], rtol=1e-5, atol=BOX_ATOL)
    assert t_transf.shape == j_transf.shape == (19, 10)
    np.testing.assert_array_equal(t_transf[:, 0], j_transf[:, 0])
    t_h, j_h = t_transf[:, 1:].reshape(-1, 3, 3), j_transf[:, 1:].reshape(-1, 3, 3)
    np.testing.assert_allclose(t_h[:, :2, :2], j_h[:, :2, :2], rtol=0, atol=lin_tol,
                               err_msg="linear")
    np.testing.assert_allclose(t_h[:, 2, :2], j_h[:, 2, :2], rtol=0, atol=lin_tol,
                               err_msg="perspective")
    np.testing.assert_allclose(t_h[:, :2, 2], j_h[:, :2, 2], rtol=0, atol=TRANS_TOL,
                               err_msg="translation")
    np.testing.assert_array_equal(t_h[:, 2, 2], 1.0)


def read_rows(stats):
    return (np.loadtxt(stats["tracks_file"], delimiter=","),
            np.loadtxt(stats["transforms_file"], delimiter=","))


def test_rows_match_jax(jax_rows, torch_run):
    assert_rows_match(*read_rows(torch_run), *jax_rows, lin_tol=LIN_TOL_F32)


def test_rows_match_jax_moving_camera(jax_rows_moving, torch_run_moving):
    assert_rows_match(*read_rows(torch_run_moving), *jax_rows_moving)


def test_rows_match_jax_moving_camera_default_draw(jax_rows_moving, torch_run_moving_default_draw,
                                                   torch_run_moving):
    """The same parity with the port's own RANSAC draw (its default
    sampler, JAX's threefry keyed by frame id) in place of ``jax_sampler``:
    it draws the reference's indices, so the files equal those of the run
    with the injected draw."""
    rows, transf = read_rows(torch_run_moving_default_draw)
    assert_rows_match(rows, transf, *jax_rows_moving)
    injected = read_rows(torch_run_moving)
    np.testing.assert_array_equal(rows, injected[0])
    np.testing.assert_array_equal(transf, injected[1])


def test_rows_match_jax_with_reid(jax_rows_reid, torch_run_reid, torch_run_moving):
    """BoT-SORT with ReID through the whole chunk step (the appearance
    embedding of every detection, the tracker's appearance cost and EMA)
    on the moving-camera clip, against the reference's FusedExtractor with
    with_reid; the homographies are those of the run without ReID."""
    rows, transf = read_rows(torch_run_reid)
    assert_rows_match(rows, transf, *jax_rows_reid)
    np.testing.assert_array_equal(transf, read_rows(torch_run_moving)[1])


def test_moving_camera_homographies_are_the_cameras(jax_rows_moving, torch_run_moving):
    """Both packages recover the camera: each frame's cur->ref homography
    maps the frame's corners and centre within 2.5 px of where the camera's
    true homography maps them (features at half resolution, 320x240). By
    the last frame the camera has moved those points by over 10 px, so an
    inverted H (off by twice that) cannot pass."""
    reader = moving_reader()
    pts = np.array([[0, 0, 1], [320, 0, 1], [0, 240, 1], [320, 240, 1], [160, 120, 1]], float)

    def mapped(h):
        m = pts @ h.T
        return m[:, :2] / m[:, 2:]

    for transf in (read_rows(torch_run_moving)[1], jax_rows_moving[1]):
        for row in transf:
            true = mapped(reader.camera_h(int(row[0])))
            err = np.abs(mapped(row[1:].reshape(3, 3)) - true).max()
            assert err < 2.5, (int(row[0]), err)
    assert np.abs(mapped(reader.camera_h(19)) - pts[:, :2]).max() > 10.0


def test_extract_stats_and_chunking(torch_run):
    assert torch_run["frames"] == 20
    assert torch_run["chunks"] == 3  # 8 + 8 + a padded tail of 4
    assert torch_run["n_transforms"] == 19


def test_gmc_and_box_transform_match_jax_on_moving_homographies():
    """gmc_from_h (argument order, adjugate inverse) and the stabilized-box
    corner refit against the reference, on homographies far from the
    identity (rotation, scale, shift, perspective)."""
    rng = np.random.default_rng(7)
    reader = moving_reader()
    h = np.stack([reader.camera_h(i) for i in (3, 4, 11, 19)]).astype(np.float32)
    h[:, 2, :2] = rng.normal(0, 2e-5, (4, 2))
    boxes = np.column_stack([rng.uniform(20, 300, 6), rng.uniform(20, 220, 6),
                             rng.uniform(8, 40, 6), rng.uniform(6, 20, 6)]).astype(np.float32)
    for cur, prev in ((1, 0), (3, 2), (0, 3)):
        want = np.asarray(jdp.gmc_from_h(jnp.asarray(h[cur]), jnp.asarray(h[prev])))
        got = tdp.gmc_from_h(torch.from_numpy(h[cur]), torch.from_numpy(h[prev])).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        assert np.abs(want - np.eye(3)).max() > 1e-3
    for hi in h:
        want = np.asarray(jdp.transform_boxes(jnp.asarray(hi), jnp.asarray(boxes)))
        got = tdp._transform_boxes_h(torch.from_numpy(hi), torch.from_numpy(boxes)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    # the batched form the chunk step uses
    got = tdp._transform_boxes_h(torch.from_numpy(h), torch.from_numpy(np.stack([boxes] * 4)))
    want = np.stack([np.asarray(jdp.transform_boxes(jnp.asarray(hi), jnp.asarray(boxes))) for hi in h])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


def test_stabilization_off_is_not_ported():
    """Stabilization off is ported now (the name is kept from when it was
    not): detect + track only, bytetrack on the oracle clip, the 8-column
    rows equal the reference's, and ``extract`` writes the 10-column tracks
    file and no transforms file."""
    reader = SyntheticVideoReader(width=64, height=48, n_frames=6)
    det = OracleDetector(boxes_fn(reader), device="cpu")
    _, tstate, tstep = make_tracker("bytetrack", tcfg.DEFAULT["tracker"]["bytetrack"],
                                    max_tracks=TRACKS, device="cpu")
    fx = FusedExtractor(det, None, tstep, tstate, 48, 64, use_gmc=False, chunk=4, device="cpu")
    tracks, transforms, _ = textract.track_video_fused(reader, fx, chunk=4, stabilize=False)
    tcfg_j, jstate, jstep = jax_make_tracker("bytetrack", tcfg.DEFAULT["tracker"]["bytetrack"],
                                             max_tracks=TRACKS)
    mp = pytest.MonkeyPatch()
    mp.setattr(_extract_impl, "FUSED_CHUNK", 4)
    try:
        j_tracks, j_transforms, _ = _extract_impl._track_video_fused(
            None, {"main": {"class_names": {}}}, logging.getLogger("test-torch-pipeline"),
            JaxReader(width=64, height=48, n_frames=6), JaxOracle(boxes_fn(reader)), tcfg_j,
            jstate, jstep, False, 0)
    finally:
        mp.undo()
    assert tracks.shape == j_tracks.shape and tracks.shape[1] == 8 and len(tracks) > 0
    assert transforms.shape == j_transforms.shape == (0, 10)
    np.testing.assert_array_equal(tracks[:, [0, 1, 6, 7]], j_tracks[:, [0, 1, 6, 7]])
    np.testing.assert_allclose(tracks[:, 2:6], j_tracks[:, 2:6], rtol=1e-5, atol=BOX_ATOL)

    fx.reset()
    config = {**tcfg.DEFAULT, "extraction": {**tcfg.DEFAULT["extraction"], "stabilize": False,
                                              "min_track_length": 1}}
    with tempfile.TemporaryDirectory() as tmp:
        stats = textract.extract(reader, fx, tmp, "V", config=config, chunk=4)
        assert np.loadtxt(stats["tracks_file"], delimiter=",", ndmin=2).shape[1] == 10
        assert not stats["transforms_file"].exists()
