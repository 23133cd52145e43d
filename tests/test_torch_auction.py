"""The tracker's auction and its gated wrapper against the JAX package's, on
the CPU, compared exactly: ``auction_assignment`` (whose CPU route is the
plain version ``auction_assignment_torch``, the oracle of csrc/auction.cu)
and ``masked_assignment`` at tracker-like shapes with uniform and tie-heavy
costs, a batched call against one call per problem, the iteration cap's -1
rows; and the BYTE step with its frame id as a 0-dim tensor (as the chunk
step hands it) against the int call and the JAX step over the 30-frame
botsort and bytetrack sequences, reading nothing back to the host outside
the plain auction."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from geotrax_tpu.ops import assignment as ja
from geotrax_tpu.track import base as jb
from geotrax_tpu_torch.ops import assignment as ta
from geotrax_tpu_torch.track import base as tb
from test_torch_tracker import BOX_ATOL, _detections

torch.set_num_threads(1)


def costs(kind: str, shape, seed: int) -> np.ndarray:
    """Seeded float32 costs: ``uniform`` in [0, 1.2), ``fifths`` in
    multiples of 0.2 (the gated tracker costs' ties), ``integer`` in 0..3."""
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return rng.uniform(0, 1.2, shape).astype(np.float32)
    if kind == "fifths":
        return (rng.integers(0, 6, shape) * 0.2).astype(np.float32)
    return rng.integers(0, 4, shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(256, 256), (64, 200), (120, 300)])
@pytest.mark.parametrize("kind", ["uniform", "fifths", "integer"])
@pytest.mark.parametrize("seed", [0, 1])
def test_auction_equals_the_reference(shape, kind, seed):
    cost = costs(kind, shape, seed)
    ref = np.asarray(ja.auction_assignment(jnp.asarray(cost)))
    before = ta.auction_assignment_torch.calls
    ours = ta.auction_assignment(torch.from_numpy(cost))
    assert ta.auction_assignment_torch.calls == before + 1
    assert ours.dtype == torch.int64 and tuple(ours.shape) == shape[:1]
    np.testing.assert_array_equal(ours.numpy(), ref)


@pytest.mark.parametrize("shape", [(256, 256), (300, 120), (64, 200)])
@pytest.mark.parametrize("kind", ["uniform", "fifths", "integer"])
@pytest.mark.parametrize("seed", [0, 1])
def test_masked_assignment_equals_the_reference(shape, kind, seed):
    rng = np.random.default_rng(100 + seed)
    cost = costs(kind, shape, seed)
    rv, cv = rng.random(shape[0]) > 0.2, rng.random(shape[1]) > 0.3
    rc, rm = ja.masked_assignment(jnp.asarray(cost), jnp.asarray(rv), jnp.asarray(cv), 0.8)
    oc, om = ta.masked_assignment(torch.from_numpy(cost), torch.from_numpy(rv),
                                  torch.from_numpy(cv), 0.8)
    np.testing.assert_array_equal(oc.numpy(), np.asarray(rc))
    np.testing.assert_array_equal(om.numpy(), np.asarray(rm))
    assert om.any()


@pytest.mark.parametrize("kind", ["uniform", "fifths"])
def test_batched_auction_equals_one_call_per_problem(kind):
    """A (V, N, M) batch (the lockstep's videos, RT-DETR's images) gives each
    problem the columns it gets alone, and the reference's."""
    cost = np.stack([costs(kind, (48, 96), seed) for seed in range(4)])
    batched = ta.auction_assignment(torch.from_numpy(cost))
    assert tuple(batched.shape) == (4, 48)
    for v in range(4):
        alone = ta.auction_assignment(torch.from_numpy(cost[v]))
        np.testing.assert_array_equal(batched[v].numpy(), alone.numpy())
        np.testing.assert_array_equal(batched[v].numpy(),
                                      np.asarray(ja.auction_assignment(jnp.asarray(cost[v]))))
    rng = np.random.default_rng(7)
    rv, cv = rng.random((4, 48)) > 0.2, rng.random((4, 96)) > 0.3
    col, matched = ta.masked_assignment(torch.from_numpy(cost), torch.from_numpy(rv),
                                        torch.from_numpy(cv), 0.8)
    for v in range(4):
        rc, rm = ja.masked_assignment(jnp.asarray(cost[v]), jnp.asarray(rv[v]),
                                      jnp.asarray(cv[v]), 0.8)
        np.testing.assert_array_equal(col[v].numpy(), np.asarray(rc))
        np.testing.assert_array_equal(matched[v].numpy(), np.asarray(rm))


@pytest.mark.parametrize("max_iters", [0, 1, 8])
def test_rows_unassigned_at_the_cap_return_minus_one(max_iters):
    cost = costs("uniform", (100, 100), 9)
    ours = ta.auction_assignment(torch.from_numpy(cost), max_iters=max_iters).numpy()
    ref = np.asarray(ja.auction_assignment(jnp.asarray(cost), max_iters=max_iters))
    np.testing.assert_array_equal(ours, ref)
    assert (ours == -1).sum() > 0
    assigned = ours[ours >= 0]
    assert len(np.unique(assigned)) == len(assigned)


def test_wrapper_routes_and_refusals_on_the_cpu():
    """A CPU tensor takes the plain version and launches nothing; the
    kernel's statistics exist only on the card; a device the port has no
    route for is refused."""
    cost = torch.from_numpy(costs("uniform", (5, 9), 3))
    launches = ta.auction_assignment.launches
    np.testing.assert_array_equal(ta.auction_assignment(cost).numpy(),
                                  ta.auction_assignment_torch(cost).numpy())
    assert ta.auction_assignment.launches == launches
    with pytest.raises(ValueError, match="stats"):
        ta.auction_assignment(cost, stats=torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError, match="unsupported device"):
        ta.auction_assignment(cost.to("meta"))


# An H100's 132 SMs and the opt-in shared memory of a block (227 KB) less
# phase B's static arrays: the numbers the card reports to the plan.
H100_SMS = 132
H100_SHARED = 232448 - 512


def every_cluster(cluster, shared):
    return 1


@pytest.mark.parametrize("n,m,cluster", [(1000, 2000, 16), (1024, 14024, 16), (36, 336, 1),
                                         (37, 90, 1), (1, 2, 1), (300, 300, 8), (64, 61024, 1)])
def test_region_bytes_hold_a_blocks_state(n, m, cluster):
    """One block's state: a count from each block (16 blocks at most), every
    price (padded to 4 columns), a key and an owner per owned column, two ints
    a row owned, rounded up to 16 bytes; the blocks together own every row and
    column."""
    cols, rows = -(-m // cluster), -(-n // cluster)
    raw = 4 * 16 + 4 * (-(-m // 4) * 4) + cols * (8 + 4) + rows * (4 + 4)
    got = ta.region_bytes(n, m, cluster)
    assert got % 16 == 0 and raw <= got < raw + 16
    assert cols * cluster >= m and rows * cluster >= n


@pytest.mark.parametrize("shape,split,cluster,shared", [
    ((1, 1000, 2000), 4, 16, True),     # the tracker's padded cost
    ((4, 1000, 2000), 1, 16, True),     # the lockstep's four videos
    ((1, 1024, 14024), 4, 16, True),    # max_det 13000: on chip under the cluster
    ((1, 1024, 61024), 4, 16, False),   # max_det 60000: prices past shared memory
    ((8, 36, 336), 1, 1, True),         # RT-DETR's matcher
    ((1, 256, 512), 2, 16, True),      # tie-heavy integer costs
    ((1, 300, 300), 1, 16, True),      # the capped contest
    ((1, 64, 1000), 2, 1, True),       # the most rows one block takes
    ((1, 65, 1000), 2, 16, True),
    ((1, 3, 7), 1, 1, True),
])
def test_launch_plan_at_the_smoke_shapes(shape, split, cluster, shared):
    b, n, m = shape
    plan = ta.launch_plan(b, n, m, H100_SMS, H100_SHARED, every_cluster)
    assert (plan.split, plan.cluster, plan.shared) == (split, cluster, shared)
    assert (plan.cols, plan.rows) == (-(-m // cluster), -(-n // cluster))
    assert plan.stride == ta.region_bytes(n, m, cluster)
    bids = -(-8 * b * n // 256) * 256
    assert plan.work == bids + (0 if shared else b * cluster * plan.stride)
    if shared:
        assert plan.stride <= H100_SHARED


def test_launch_plan_takes_the_sizes_the_card_launches():
    """A cluster size the card cannot hold is passed over: first larger ones
    (smaller shares of the columns), then smaller ones; device memory takes
    the largest launchable size up to the wanted one (1 block up to 64 rows,
    else 16)."""
    seen = []

    def upto(limit):
        def clusters(cluster, shared):
            seen.append((cluster, shared))
            return int(cluster <= limit)
        return clusters

    plan = ta.launch_plan(1, 1000, 2000, H100_SMS, H100_SHARED, upto(8))
    assert (plan.cluster, plan.shared) == (8, True)
    assert [c for c, _ in seen] == [16, 8]
    seen.clear()
    plan = ta.launch_plan(1, 200, 2000, H100_SMS, H100_SHARED, upto(2))
    assert (plan.cluster, plan.shared) == (2, True)
    assert [c for c, _ in seen] == [16, 8, 4, 2]
    seen.clear()
    plan = ta.launch_plan(1, 40, 60000, H100_SMS, H100_SHARED, upto(16))
    assert (plan.cluster, plan.shared) == (1, False)    # a replica of 60000 prices fits no block
    assert seen == [(1, 0)]
    seen.clear()
    plan = ta.launch_plan(1, 1024, 61024, H100_SMS, H100_SHARED, upto(4))
    assert (plan.cluster, plan.shared) == (4, False)
    assert seen[-3:] == [(16, 0), (8, 0), (4, 0)]
    with pytest.raises(RuntimeError, match="no cluster"):
        ta.launch_plan(1, 10, 20, H100_SMS, H100_SHARED, lambda c, s: 0)


@pytest.mark.parametrize("rows,m,split", [(1000, 2000, 4), (4000, 2000, 1), (288, 336, 1),
                                          (1, 2, 1), (1, 100000, 8), (100, 1000, 2),
                                          (2112, 8192, 1), (2111, 8192, 2)])
def test_first_round_split(rows, m, split):
    """Warps per row in the first round: enough warps for 16 an SM, a power of
    two up to 8, each over 256 columns at least."""
    got = ta.first_round_split(rows, m, H100_SMS)
    assert got == split
    assert got & (got - 1) == 0 and 1 <= got <= ta.FIRST_ROUND_WARPS
    assert got == 1 or m // got >= ta.COLS_PER_WARP


PARAMS = {"track_high_thresh": 0.25, "track_low_thresh": 0.1, "new_track_thresh": 0.25,
          "track_buffer": 30, "match_thresh": 0.8, "fuse_score": True,
          "gmc_method": "sparseOptFlow"}


class HostReads(TorchDispatchMode):
    """Counts the operations that read a tensor's value back to the host
    (``item``, ``int()``, ``bool()``: ``_local_scalar_dense``; ``nonzero``),
    except inside the plain auction, whose convergence test is such a read
    (the kernel on the card has none)."""

    def __init__(self):
        super().__init__()
        self.reads, self.in_plain = [], 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.__name__.split(".")[0] in ("_local_scalar_dense", "nonzero", "is_nonzero") \
                and not self.in_plain:
            self.reads.append(func.__name__)
        return func(*args, **(kwargs or {}))


@pytest.fixture
def host_reads(monkeypatch):
    mode = HostReads()
    plain = ta.auction_assignment

    def counted_plain(*a, **kw):
        mode.in_plain += 1
        try:
            return plain(*a, **kw)
        finally:
            mode.in_plain -= 1

    monkeypatch.setattr(ta, "auction_assignment", counted_plain)
    return mode


@pytest.mark.parametrize("name", ["botsort", "bytetrack"])
@pytest.mark.parametrize("reid", [False, True])
def test_byte_step_with_a_tensor_frame_id(name, reid, host_reads):
    """The 30-frame sequence with ``frame_id`` a 0-dim int64 tensor (the
    chunk step's ids) equals the int call and the JAX step frame by frame,
    and the step reads nothing back to the host (GMC on for botsort)."""
    params = {**PARAMS, "with_reid": reid}
    _, js, jstep = jb.make_tracker(name, params, max_tracks=32)
    cfg, ts, tstep = tb.make_tracker(name, params, max_tracks=32, device="cpu")
    ti = ts
    rng = np.random.default_rng(5)
    dets = _detections()
    fids = torch.arange(1, len(dets) + 1)
    for f, (b, s, c, v) in enumerate(dets, start=1):
        gmc = None
        if cfg.use_gmc:
            gmc = np.eye(3, dtype=np.float32)
            gmc[:2, 2] = rng.normal(0, 0.5, 2)
        emb = rng.normal(0, 1, (len(b), tb.EMB_DIM)).astype(np.float32) if reid else None
        js, jo = jstep(js, jnp.asarray(b), jnp.asarray(s), jnp.asarray(c), jnp.asarray(v), f,
                       None if gmc is None else jnp.asarray(gmc),
                       None if emb is None else jnp.asarray(emb))
        ins = [torch.from_numpy(x) for x in (b, s, c, v)]
        g = None if gmc is None else torch.from_numpy(gmc)
        e = None if emb is None else torch.from_numpy(emb)
        with host_reads:
            ts, to = tstep(ts, *ins, fids[f - 1], g, e)
        ti, io = tstep(ti, *ins, f, g, e)
        for x, y in zip(tuple(to) + tuple(ts), tuple(io) + tuple(ti)):
            assert x.dtype == y.dtype
            torch.testing.assert_close(x, y, rtol=0, atol=0)
        np.testing.assert_array_equal(to.valid.numpy(), np.asarray(jo.valid), err_msg=f"frame {f}")
        np.testing.assert_array_equal(to.track_id.numpy(), np.asarray(jo.track_id))
        np.testing.assert_array_equal(ts.status.numpy(), np.asarray(js.status))
        np.testing.assert_array_equal(ts.start_frame.numpy(), np.asarray(js.start_frame))
        np.testing.assert_array_equal(ts.hist_frame.numpy(), np.asarray(js.hist_frame))
        valid = to.valid.numpy()
        np.testing.assert_allclose(to.box_xywh.numpy()[valid], np.asarray(jo.box_xywh)[valid],
                                   rtol=0, atol=BOX_ATOL)
    assert host_reads.reads == []
    assert int(ts.next_id) == int(js.next_id) > 5


@pytest.mark.parametrize("name", ["botsort", "bytetrack"])
def test_batched_vstep_reads_nothing_back(name, host_reads):
    """make_batch_tracker's batched step (the lockstep's) with an int frame
    id reads nothing back to the host, and equals each video's own step."""
    v = 3
    _, states, vstep = tb.make_batch_tracker(name, PARAMS, v, max_tracks=32, device="cpu")
    singles = [tb.make_tracker(name, PARAMS, max_tracks=32, device="cpu") for _ in range(v)]
    single_states = [s for _, s, _ in singles]
    seqs = [_detections(n_frames=8, seed=10 + i) for i in range(v)]
    for f in range(8):
        ins = [torch.from_numpy(np.stack([seqs[i][f][k] for i in range(v)])) for k in range(4)]
        alive = torch.tensor([True, True, f < 5])
        with host_reads:
            states, out = vstep(states, *ins, f + 1, alive)
        for i in range(v):
            if f >= 5 and i == 2:
                continue
            single_states[i], one = singles[i][2](single_states[i], *(x[i] for x in ins), f + 1)
            for x, y in zip(one, (t[i] for t in out)):
                torch.testing.assert_close(y, x, rtol=0, atol=0)
    assert host_reads.reads == []
