"""The lockstep multi-video extractor of the port (``parallel/``) against
the JAX package's, on the CPU:

- ``prng.split`` bit-equal to ``jax.random.split``, and the lockstep's key
  chain (``split(PRNGKey(0), V)``, then ``split(key)[0]`` per live video
  per step) over a ragged live subset;
- the batched tracker step (``make_batch_tracker``) equal to V
  single-timeline steps exactly, for all six trackers, with videos that
  end (alive mask), and to the reference's ``vmap`` of its step with that
  mask (ids, validity and status equal, boxes within 1e-4, embeddings
  within 1e-5, as tests/test_torch_tracker.py holds one timeline);
- ``VideoBatchTracker``, ``offset_vehicle_ids`` and
  ``aggregate_track_counts`` against the reference's;
- ``extract_videos_batch`` against the reference's on the three 320x240
  oracle videos of tests/test_parallel_extract.py: with stabilization off
  (bytetrack with equal and ragged lengths, botsort with ReID) every file
  equal, also with the tracker split over three CPU devices and against
  the port's own sequential loop on each video alone; with stabilization
  on (botsort, ragged) the reference's RANSAC refinement solves its 9x9 in
  float64 as the port does (ROADMAP C3, tests/test_torch_pipeline.py), and
  the files agree within its tolerances.
"""

import logging

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

import test_parallel_extract as ref_pex
from geotrax_tpu.ops import ransac as jr
from geotrax_tpu.parallel import extract_batch as jeb
from geotrax_tpu.parallel import video_batch as jvb
from geotrax_tpu.pipeline import _extract_impl
from geotrax_tpu.track import make_tracker as jax_make_tracker
from geotrax_tpu_torch import cfg as tcfg
from geotrax_tpu_torch.io.synthetic import SyntheticVideoReader
from geotrax_tpu_torch.models.detector import OracleDetector, SequentialOnly
from geotrax_tpu_torch.ops import prng
from geotrax_tpu_torch.parallel import extract_batch as teb
from geotrax_tpu_torch.parallel import video_batch as tvb
from geotrax_tpu_torch.pipeline import extract as textract
from geotrax_tpu_torch.track import base as tb
from geotrax_tpu_torch.utils import config_utils as tcu
from test_torch_pipeline import fit_homography_normal_eigh64

LOG = logging.getLogger("test-torch-lockstep")
BOX_ATOL = 1e-4
N_VIDEOS = ref_pex.N_VIDEOS
RAGGED = [10, 14, 12]
EQUAL = [ref_pex.N_FRAMES] * N_VIDEOS
# stabilization on: the C3 tolerances (linear and perspective entries, px)
LIN_TOL, TRANS_TOL, GEOM_ATOL = 5e-4, 0.05, 0.05
STAB_FEATURES = 500


# ----------------------------------------------------------------------- keys

def test_split_equals_jax():
    for seed in (0, 1, 123456789):
        for num in (2, 3, 7):
            np.testing.assert_array_equal(
                prng.split(prng.PRNGKey(seed), num),
                np.asarray(jax.random.split(jax.random.PRNGKey(seed), num)))
    keys = jax.random.split(jax.random.PRNGKey(5), 4)
    np.testing.assert_array_equal(prng.split(np.asarray(keys), 3),
                                  np.asarray(jax.vmap(lambda k: jax.random.split(k, 3))(keys)))


def test_lockstep_key_chain_over_a_ragged_group():
    """The keys each live video draws from, step after step, as the
    reference's BatchStabilizer advances them while videos end."""
    lengths = [3, 6, 4]
    jkeys = jax.random.split(jax.random.PRNGKey(0), 3)
    tkeys = prng.split(prng.PRNGKey(0), 3)
    for step in range(1, max(lengths)):
        idx = np.asarray([v for v in range(3) if step < lengths[v]])
        new = jax.vmap(lambda k: jax.random.split(k)[0])(jkeys[idx])
        jkeys = jkeys.at[idx].set(new)
        tkeys[idx] = prng.split(tkeys[idx])[:, 0]
        np.testing.assert_array_equal(tkeys, np.asarray(jkeys))


# ------------------------------------------------------------------- tracker

TRACKERS = {
    "bytetrack": ("bytetrack", {}),
    "botsort+reid": ("botsort", {"with_reid": True}),
    "ocsort": ("ocsort", {}),
    "deepocsort+reid": ("deepocsort", {"with_reid": True, "gmc_method": "sparseOptFlow"}),
    "fasttrack": ("fasttrack", {}),
    "tracktrack+reid": ("tracktrack", {"with_reid": True}),
}
STEP_LENGTHS = [9, 12, 6]   # the third video ends first, then the first
K_SLOTS, M_DETS = 32, 8


def step_inputs(seed: int = 0):
    """Per step (boxes, scores, classes, valid, gmc, emb, alive) for three
    videos of movers with noisy boxes, low- and high-score detections,
    small camera motions and per-slot embeddings."""
    rng = np.random.default_rng(seed)
    v, m = N_VIDEOS, M_DETS
    start = rng.uniform(30, 300, (v, m, 2)).astype(np.float32)
    vel = rng.uniform(-4, 4, (v, m, 2)).astype(np.float32)
    base_emb = rng.normal(0, 1, (v, m, tb.EMB_DIM))
    steps = []
    for t in range(max(STEP_LENGTHS)):
        xy = start + vel * t + rng.normal(0, 0.6, (v, m, 2))
        wh = np.broadcast_to(np.float32([28, 14]), (v, m, 2))
        boxes = np.concatenate([xy, wh], -1).astype(np.float32)
        scores = rng.uniform(0.05, 1.0, (v, m)).astype(np.float32)
        classes = rng.integers(0, 3, (v, m)).astype(np.int32)
        valid = rng.uniform(0, 1, (v, m)) > 0.15
        gmc = np.tile(np.eye(3, dtype=np.float32), (v, 1, 1))
        gmc[:, :2, 2] = rng.normal(0, 1.0, (v, 2))
        gmc[:, 0, 1] = rng.normal(0, 0.003, v)
        gmc[:, 1, 0] = -gmc[:, 0, 1]
        emb = (base_emb + rng.normal(0, 0.3, base_emb.shape)).astype(np.float32)
        alive = np.asarray([t < n for n in STEP_LENGTHS])
        steps.append((boxes, scores, classes, valid, gmc, emb, alive))
    return steps


def jax_vstep(jcfg, jstep):
    """The reference's lockstep tracker step (extract_batch.tracker_vstep)."""
    use_gmc = bool(getattr(jcfg, "use_gmc", False))
    with_reid = bool(getattr(jcfg, "with_reid", False))

    @jax.jit
    def vstep(states, boxes, scores, cls_, valid, alive_mask, frame_id, gmc, emb):
        def one(s, b, sc, c, v, g, al, e):
            s2, out = jstep(s, b, sc, c, v, frame_id, g if use_gmc else None,
                            det_emb=e if with_reid else None)
            s3 = jax.tree.map(
                lambda new, old: jnp.where(al.reshape((1,) * new.ndim) if new.ndim else al,
                                           new, old), s2, s)
            return s3, out._replace(valid=out.valid & al)

        return jax.vmap(one)(states, boxes, scores, cls_, valid, gmc, alive_mask, emb)

    return vstep


@pytest.mark.parametrize("key", list(TRACKERS))
def test_batched_step_equals_single_steps_and_jax_vmap(key):
    name, overrides = TRACKERS[key]
    params = {**tcfg.DEFAULT["tracker"][name], **overrides}
    cfg, states, vstep = tb.make_batch_tracker(name, params, N_VIDEOS, max_tracks=K_SLOTS,
                                               device="cpu")
    singles = [tb.make_tracker(name, params, max_tracks=K_SLOTS, device="cpu")
               for _ in range(N_VIDEOS)]
    single_states = [s for _, s, _ in singles]
    jcfg, jstate0, jstep = jax_make_tracker(name, params, max_tracks=K_SLOTS)
    jstates = jax.tree.map(lambda a: jnp.broadcast_to(a, (N_VIDEOS,) + a.shape).copy(), jstate0)
    jv = jax_vstep(jcfg, jstep)
    tracked = 0
    for t, (b, s, c, va, g, e, alive) in enumerate(step_inputs()):
        tensors = [torch.from_numpy(np.ascontiguousarray(a)) for a in (b, s, c, va, g, e, alive)]
        states, out = vstep(states, *tensors[:4], t + 1, tensors[6], tensors[4], tensors[5])
        jstates, jout = jv(jstates, *map(jnp.asarray, (b, s, c, va, alive)), t + 1,
                           jnp.asarray(g), jnp.asarray(e))
        for v in range(N_VIDEOS):
            if not alive[v]:
                assert not out.valid[v].any()
                continue
            single_states[v], one = singles[v][2](single_states[v], *(x[v] for x in tensors[:4]),
                                                  t + 1, tensors[4][v], tensors[5][v])
            for field, x, y in zip(one._fields, one, (f[v] for f in out)):
                assert torch.equal(x, y), f"{key} step {t} video {v} output {field}"
        # an ended video's outputs are invalid; the reference computes them
        # from a step it then discards, the port does not step it
        ok = out.valid.numpy()
        np.testing.assert_array_equal(ok, np.asarray(jout.valid), err_msg=f"step {t}")
        np.testing.assert_array_equal(out.track_id.numpy()[ok], np.asarray(jout.track_id)[ok])
        np.testing.assert_array_equal(states.status.numpy(), np.asarray(jstates.status))
        np.testing.assert_array_equal(states.track_id.numpy(), np.asarray(jstates.track_id))
        np.testing.assert_allclose(out.box_xywh.numpy()[ok], np.asarray(jout.box_xywh)[ok],
                                   rtol=0, atol=BOX_ATOL)
        np.testing.assert_allclose(states.emb.numpy(), np.asarray(jstates.emb), rtol=0, atol=1e-5)
        tracked += int(ok.sum())
    for v in range(N_VIDEOS):  # an ended video's state stays as it was at its end
        for field, x, y in zip(states._fields, single_states[v], (f[v] for f in states)):
            assert torch.equal(x, y), f"{key} final state of video {v}: {field}"
    assert tracked > 40  # the scenario confirms tracks in every tracker


def test_video_batch_tracker_and_aggregation_match_jax():
    cfg = tb.TrackerConfig(max_tracks=16)
    boxes, scores, classes, valid = (np.array(a) for a in ref_pex_dets())
    jout = jvb.VideoBatchTracker(jvb.TrackerConfig(max_tracks=16), 4).step_chunk(
        *map(jnp.asarray, (boxes, scores, classes, valid)), 1)
    batch = tvb.VideoBatchTracker(cfg, 4, device="cpu")
    out = batch.step_chunk(*map(torch.from_numpy, (boxes, scores, classes, valid)), 1)
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(jout.valid))
    np.testing.assert_array_equal(out.track_id.numpy(), np.asarray(jout.track_id))
    ok = out.valid.numpy()
    assert ok.sum() > 30
    np.testing.assert_allclose(out.box_xywh.numpy()[ok], np.asarray(jout.box_xywh)[ok],
                               atol=BOX_ATOL)
    for v in range(4):  # each timeline as it runs alone
        state = tb.init_state(cfg, "cpu")
        for t in range(boxes.shape[1]):
            state, one = tb.byte_step(state, *(torch.from_numpy(a[v, t]) for a in
                                               (boxes, scores, classes, valid)), t + 1, cfg)
            assert torch.equal(one.box_xywh, out.box_xywh[v, t])

    max_ids = np.asarray([5, 3, 0, 7], np.int32)
    np.testing.assert_array_equal(tvb.offset_vehicle_ids(torch.from_numpy(max_ids)).numpy(),
                                  np.asarray(jvb.offset_vehicle_ids(jnp.asarray(max_ids))))
    ids = np.asarray(out.track_id) * ok
    t_max, t_rows = tvb.aggregate_track_counts(torch.from_numpy(ids), torch.from_numpy(ids > 0))
    j_max, j_rows = jvb.aggregate_track_counts(jnp.asarray(ids), jnp.asarray(ids > 0),
                                               num_segments=4)
    np.testing.assert_array_equal(t_max.numpy(), np.asarray(j_max))
    np.testing.assert_array_equal(t_rows.numpy(), np.asarray(j_rows))


def ref_pex_dets():
    """tests/test_parallel.py's (V=4, T=10) block: one mover per video."""
    from test_parallel import make_dets

    return make_dets(np.random.default_rng(0), 4, 10)


# ------------------------------------------------------------ extract_videos_batch

class PortBatchOracle(ref_pex.BatchOracle):
    """The reference test's batch oracle returning tensors."""

    def detect_batch(self, stacked):
        return {k: torch.from_numpy(np.array(v)) for k, v in super().detect_batch(stacked).items()}


def port_readers(lengths):
    return [SyntheticVideoReader(width=320, height=240, n_frames=lengths[v], seed=7, boxes=[{
        "xy0": (40.0 + 15 * v, 50.0 + 10 * v), "v": (2.0 + v, 0.5), "wh": (30, 12),
        "color": (255, 40, 40)}]) for v in range(N_VIDEOS)]


def tune(config, stabilize, tracker, params):
    config["main"]["tracker_active"] = tracker
    config["main"]["tracker_params"] = dict(params)
    config["main"]["extraction"]["stabilize"] = stabilize
    config["ultralytics"]["max_det"] = 8
    # a 160x120 gray holds fewer corners than the preset's 2000 (4000 for
    # the reference frame); the smaller budget keeps the runs short
    config["stabilo"]["max_features"] = STAB_FEATURES
    return config


def read_outputs(out_dir, stems):
    files = []
    for stem in stems:
        transf = out_dir / f"{stem}_vid_transf.txt"
        files.append((np.loadtxt(out_dir / f"{stem}.txt", delimiter=","),
                      np.loadtxt(transf, delimiter=",") if transf.exists() else None))
    return files


def run_jax_lockstep(tmp, lengths, stabilize, tracker, params):
    mp = pytest.MonkeyPatch()
    readers = ref_pex.make_readers(lengths)
    oracle = ref_pex.BatchOracle(readers)
    mp.setattr(_extract_impl, "load_detector", lambda cfg, lg: oracle)
    sources = [ref_pex.make_args(tmp, i).source for i in range(N_VIDEOS)]
    reader_of = {str(s): r for s, r in zip(sources, readers)}
    mp.setattr(_extract_impl, "open_reader", lambda s, a, b, c: reader_of[str(s)])
    if stabilize:
        mp.setattr(jr, "fit_homography_normal", fit_homography_normal_eigh64)
        jax.clear_caches()  # retrace ransac_fit with the patched fit
    try:
        from geotrax_tpu.utils.config_utils import load_config_all

        args = ref_pex.make_args(tmp, 0)
        config = tune(load_config_all(args, LOG, needs_model=False), stabilize, tracker, params)
        jeb.extract_videos_batch(sources, args, config, LOG)
    finally:
        mp.undo()
        if stabilize:
            jax.clear_caches()
    return read_outputs(tmp / "out", [f"V{i}" for i in range(N_VIDEOS)])


def port_args(tmp, i, **extra):
    args = ref_pex.make_args(tmp, i)
    args.device = "cpu"
    for k, v in extra.items():
        setattr(args, k, v)
    return args


def run_port_lockstep(tmp, lengths, stabilize, tracker, params, devices=None):
    mp = pytest.MonkeyPatch()
    readers = port_readers(lengths)
    oracle = PortBatchOracle(readers)
    mp.setattr(textract, "load_detector", lambda cfg, lg: oracle)
    sources = [port_args(tmp, i).source for i in range(N_VIDEOS)]
    reader_of = {str(s): r for s, r in zip(sources, readers)}
    mp.setattr(textract, "open_reader", lambda s, a, b, c: reader_of[str(s)])
    try:
        args = port_args(tmp, 0, devices=None if devices is None else len(devices))
        config = tune(tcu.load_config_all(args, LOG, needs_model=False), stabilize, tracker, params)
        stats = teb.extract_videos_batch(sources, args, config, LOG, devices=devices)
    finally:
        mp.undo()
    meta = [yaml.safe_load(s.with_suffix(".yaml").read_text()) for s in sources]
    return read_outputs(tmp / "out", [f"V{i}" for i in range(N_VIDEOS)]), meta, stats


def run_port_sequential(tmp, lengths, stabilize, tracker, params):
    """Each video alone through the port's run_extraction, its detector
    without a batch interface (the sequential per-frame loop)."""
    mp = pytest.MonkeyPatch()
    load = tcu.load_config_all
    mp.setattr(tcu, "load_config_all", lambda args, lg, needs_model=True: tune(
        load(args, lg, needs_model=needs_model), stabilize, tracker, params))
    files = []
    try:
        for i, reader in enumerate(port_readers(lengths)):
            det = SequentialOnly(OracleDetector(
                lambda idx, r=reader: [list(b) + [0.9, 0] for b in r.boxes_at(idx)], max_det=8,
                device="cpu"))
            mp.setattr(textract, "load_detector", lambda cfg, lg, d=det: d)
            mp.setattr(textract, "open_reader", lambda s, a, b, c, r=reader: r)
            args = port_args(tmp, i, output_folder=str(tmp / f"seq{i}"))
            textract.run_extraction(args, LOG)
            files += read_outputs(tmp / f"seq{i}", [f"V{i}"])
    finally:
        mp.undo()
    return files


BOTSORT_REID = ("botsort", {**ref_pex.TRACKER_PARAMS, "with_reid": True, "model": "auto"})
BYTETRACK = ("bytetrack", ref_pex.TRACKER_PARAMS)
RUNS = {  # name: (lengths, stabilize, tracker, params)
    "equal": (EQUAL, False) + BYTETRACK,
    "ragged": (RAGGED, False) + BYTETRACK,
    "botsort_reid": (RAGGED, False) + BOTSORT_REID,
    "stabilized": (RAGGED, True, "botsort", ref_pex.TRACKER_PARAMS),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One reference lockstep run and one port lockstep run per
    configuration, the port also split over three CPU devices and its
    sequential loop on each video alone; torch on two threads for them (the
    suite's workers share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    out = {}
    for name, (lengths, stabilize, tracker, params) in RUNS.items():
        out[name] = {
            "jax": run_jax_lockstep(tmp_path_factory.mktemp(f"jax_{name}"), lengths, stabilize,
                                    tracker, params),
            "port": run_port_lockstep(tmp_path_factory.mktemp(f"port_{name}"), lengths,
                                      stabilize, tracker, params),
        }
    lengths, stabilize, tracker, params = RUNS["ragged"]
    out["ragged"]["devices"] = run_port_lockstep(tmp_path_factory.mktemp("port_devices"), lengths,
                                                 stabilize, tracker, params, devices=["cpu"] * 3)
    out["ragged"]["sequential"] = run_port_sequential(tmp_path_factory.mktemp("port_seq"),
                                                      lengths, stabilize, tracker, params)
    torch.set_num_threads(threads)
    return out


@pytest.mark.parametrize("name", ["equal", "ragged", "botsort_reid"])
def test_lockstep_files_equal_jax_with_stabilization_off(runs, name):
    lengths = RUNS[name][0]
    (port, meta, stats), ref = runs[name]["port"], runs[name]["jax"]
    for v in range(N_VIDEOS):
        (p_tracks, p_transf), (j_tracks, _) = port[v], ref[v]
        assert p_tracks.shape == j_tracks.shape and p_tracks.shape[1] == 10
        np.testing.assert_array_equal(p_tracks, j_tracks)
        assert p_transf is None
        assert p_tracks[:, 0].max() == lengths[v] - 1  # no tail frame dropped
        assert meta[v]["runtime"]["extraction_mode"] == f"parallel-group-{N_VIDEOS}"
        assert meta[v]["video"]["frames_processed"] == lengths[v] == stats["frames"][v]
    assert stats["steps"] == max(lengths)


def test_lockstep_equals_the_ports_sequential_loop(runs):
    """The reference's contract (tests/test_parallel_extract.py): with
    stabilization off each video's lockstep files equal those of the
    per-video run."""
    port, seq = runs["ragged"]["port"][0], runs["ragged"]["sequential"]
    for v in range(N_VIDEOS):
        np.testing.assert_array_equal(port[v][0], seq[v][0])


def test_lockstep_split_over_three_devices_gives_the_same_files(runs):
    port, split = runs["ragged"]["port"][0], runs["ragged"]["devices"][0]
    for v in range(N_VIDEOS):
        np.testing.assert_array_equal(split[v][0], port[v][0])


def test_stabilized_lockstep_within_c3_of_jax(runs):
    (port, meta, stats), ref = runs["stabilized"]["port"], runs["stabilized"]["jax"]
    for v in range(N_VIDEOS):
        (p_tracks, p_transf), (j_tracks, j_transf) = port[v], ref[v]
        assert p_tracks.shape == j_tracks.shape and p_tracks.shape[1] == 14
        exact = [0, 1, 10, 11]  # frame, id, class, score
        np.testing.assert_array_equal(p_tracks[:, exact], j_tracks[:, exact])
        np.testing.assert_allclose(p_tracks[:, 2:10], j_tracks[:, 2:10], rtol=0, atol=GEOM_ATOL)
        assert p_transf.shape == j_transf.shape == (RAGGED[v] - 1, 10)
        np.testing.assert_array_equal(p_transf[:, 0], j_transf[:, 0])
        p_h, j_h = p_transf[:, 1:].reshape(-1, 3, 3), j_transf[:, 1:].reshape(-1, 3, 3)
        np.testing.assert_allclose(p_h[:, :2, :2], j_h[:, :2, :2], rtol=0, atol=LIN_TOL)
        np.testing.assert_allclose(p_h[:, 2, :2], j_h[:, 2, :2], rtol=0, atol=LIN_TOL)
        np.testing.assert_allclose(p_h[:, :2, 2], j_h[:, :2, 2], rtol=0, atol=TRANS_TOL)
        # a static camera: near the identity
        assert np.abs(p_h - np.eye(3)).max() < 1.5
        assert meta[v]["runtime"]["extraction_mode"] == f"parallel-group-{N_VIDEOS}"


def test_multi_level_stabilizer_and_ragged_first_frame_are_refused(tmp_path):
    with pytest.raises(ValueError, match="single-level"):
        teb.BatchStabilizer(2, {"detector_name": "rsift"}, device="cpu")
    with pytest.raises(RuntimeError, match="ragged at the first frame"):
        run_port_lockstep(tmp_path, [0, 4, 4], True, *BYTETRACK)


def test_device_groups_split_only_divisible_groups():
    cpu = torch.device("cpu")
    assert teb.device_groups(4, None, cpu) == [(cpu, [0, 1, 2, 3])]
    assert teb.device_groups(4, 2, cpu) == [(cpu, [0, 1]), (cpu, [2, 3])]
    assert teb.device_groups(3, 2, cpu, logger=LOG) == [(cpu, [0, 1, 2])]
    assert teb.device_groups(2, 8, cpu) == [(cpu, [0]), (cpu, [1])]

