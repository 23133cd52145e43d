"""Linear assignment: the tracker's forward auction and an exact host solver.

Counterpart of ``geotrax_tpu/ops/assignment.py``. ``auction_assignment``
and ``masked_assignment`` are a single-phase Jacobi forward auction from
zero prices over a cost matrix padded with a private dummy column per row,
so rows never compete for dummies and gated tracking matrices converge in a
few vectorized rounds. On a CUDA tensor ``auction_assignment`` launches
``csrc/auction.cu``, which runs every round of every problem of the batch on
the card with no host read (the first round over the whole card, the later
ones in one thread-block cluster per problem), as the reference's
``lax.while_loop`` runs on the device; on a CPU tensor it runs
``auction_assignment_torch``, the plain version, which the kernels equal bit
for bit. ``lapjv_exact`` is the exact min-cost
assignment on the host, by the port's Jonker-Volgenant solver
(``io/native/lapjv.cpp``, built with g++ at first use); where it cannot be
built it raises, it does not fall back to another solver.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
from functools import lru_cache
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch

from geotrax_tpu_torch import _cuda

LAPJV_SOURCE = Path(__file__).resolve().parents[1] / "io" / "native" / "lapjv.cpp"
_lap_lib = None
KERNEL = "auction"

# Auction rounds between two host reads of "every row assigned?" in the
# plain version: the JAX reference tests it on the device every round
# (lax.while_loop), as the kernel does; here each test is a device->host
# sync. A round after convergence changes nothing (no row bids), and
# max_iters is a multiple of this, so the result is the reference's.
AUCTION_ROUNDS_PER_CHECK = 8


def auction_assignment_torch(cost: torch.Tensor, eps: float = 2e-4,
                             max_iters: int = 512) -> torch.Tensor:
    """Plain PyTorch auction: min-cost assignment of (..., N, M) cost rows to
    distinct columns, N <= M, for each leading (video) index.

    Jacobi forward auction (every unassigned row bids at once) from zero
    prices; optimal within N*eps. Returns (..., N) int64 column per row; rows
    still unassigned at the iteration cap return -1. A batch of problems
    runs until every one has converged: a converged problem makes no bid
    in later rounds, so its prices and owners stay put and each result is
    the one it has alone. ``auction_assignment_torch.calls`` counts its
    calls."""
    auction_assignment_torch.calls += 1
    n, m = cost.shape[-2:]
    lead = cost.shape[:-2]
    dev = cost.device
    benefit = -cost
    cols = torch.arange(m, device=dev)
    neg_inf = float("-inf")
    prices = torch.zeros(lead + (m,), dtype=cost.dtype, device=dev)
    owner = torch.full(lead + (m,), -1, dtype=torch.int64, device=dev)
    assigned = torch.full(lead + (n,), -1, dtype=torch.int64, device=dev)
    cols_b = cols.expand(lead + (m,))

    it = 0
    while it < max_iters:
        for _ in range(min(AUCTION_ROUNDS_PER_CHECK, max_iters - it)):
            unassigned = assigned < 0
            values = benefit - prices[..., None, :]
            best_col = torch.argmax(values, dim=-1)
            best_val = values.gather(-1, best_col[..., None])[..., 0]
            second_val = values.scatter(-1, best_col[..., None], neg_inf).amax(dim=-1)
            second_val = torch.where(torch.isfinite(second_val), second_val, best_val - 1.0)
            bid = torch.where(unassigned, best_val - second_val + eps, neg_inf)

            bid_matrix = torch.where(best_col[..., :, None] == cols, bid[..., :, None], neg_inf)
            win_bid = bid_matrix.amax(dim=-2)
            win_row = torch.argmax(bid_matrix, dim=-2)
            col_has_bid = torch.isfinite(win_bid)

            # rows outbid this round lose their column (slot n is a sink)
            displaced = torch.where(col_has_bid & (owner >= 0), owner, n)
            lost = torch.zeros(lead + (n + 1,), dtype=torch.bool, device=dev).scatter_(
                -1, displaced, True)
            assigned = torch.where(lost[..., :n], -1, assigned)

            owner = torch.where(col_has_bid, win_row, owner)
            prices = prices + torch.where(col_has_bid, win_bid, 0.0)
            winner_rows = torch.where(col_has_bid, win_row, n)
            sink = torch.cat([assigned, assigned.new_full(lead + (1,), -1)], dim=-1)
            assigned = sink.scatter_(-1, winner_rows, cols_b)[..., :n]
            it += 1
        if not bool((assigned < 0).any()):
            break
    return assigned


auction_assignment_torch.calls = 0


# The launch plan (csrc/auction.cu). Phase B, the later rounds, runs one
# block per problem of at most ONE_BLOCK_ROWS rows (a cluster's barriers and
# remote accesses cost more than such a problem's rounds), else a cluster of
# MAX_CLUSTER blocks (the card's non-portable cluster size), which fills a
# round's many bidders fastest; phase A, the first round, puts up to
# FIRST_ROUND_WARPS warps of a block on a row where the batch has too few
# rows to keep WARPS_PER_SM warps of each SM loading.
MAX_CLUSTER = 16
ONE_BLOCK_ROWS = 64
FIRST_ROUND_WARPS = 8
WARPS_PER_SM = 16
# A warp of either phase scans at least this many columns of a row.
COLS_PER_WARP = 256
WORK_ALIGN = 256


class LaunchPlan(NamedTuple):
    """How one call of the kernels lays out a (b, n, m) batch."""
    split: int     # phase A: warps per row
    cluster: int   # phase B: blocks per problem
    shared: bool   # phase B's state in shared memory, else in device memory
    cols: int      # columns one block owns
    rows: int      # rows one block owns
    stride: int    # bytes of one block's state
    work: int      # bytes of the work buffer: the first round's bids, then any state


def _pow2_ceil(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def _pow2_floor(x: int) -> int:
    return 1 << (max(x, 1).bit_length() - 1)


def region_bytes(n: int, m: int, cluster: int) -> int:
    """Bytes of one block's phase-B state (csrc/auction.cu:region_bytes): the
    count each block of the cluster sent in a round (4 B a block), a replica
    of every price (4 B a column, padded to 4 columns), a bid key and an
    owner per owned column (12 B), and per owned row its column and a place
    in the round's list of bidders (8 B)."""
    cols, rows = -(-m // cluster), -(-n // cluster)
    return (4 * MAX_CLUSTER + 4 * (-(-m // 4) * 4) + 12 * cols + 8 * rows + 15) // 16 * 16


def first_round_split(rows: int, m: int, sms: int) -> int:
    """Phase A's warps per row for ``rows`` rows (the whole batch's) of
    ``m`` costs on a card of ``sms`` SMs: a power of two, enough for
    WARPS_PER_SM warps an SM, at most FIRST_ROUND_WARPS, and COLS_PER_WARP
    columns a warp at least."""
    want = _pow2_ceil(-(-sms * WARPS_PER_SM // max(rows, 1)))
    return max(1, min(want, FIRST_ROUND_WARPS, _pow2_floor(m // COLS_PER_WARP)))


def launch_plan(b: int, n: int, m: int, sms: int, shared_limit: int, clusters) -> LaunchPlan:
    """The plan of a (b, n, m) batch. ``clusters(cluster, shared_bytes)``
    says how many clusters of that many blocks, each with that much shared
    state (0: state in device memory), the card holds at once (0: none).

    The cluster size wanted is 1 up to ONE_BLOCK_ROWS rows, else MAX_CLUSTER.
    The state goes to shared
    memory at the first size that fits and launches, trying the wanted size,
    then larger ones (smaller shares of the columns), then smaller ones; else
    to device memory at the largest size up to the wanted one that launches."""
    want = 1 if n <= ONE_BLOCK_ROWS else MAX_CLUSTER
    larger = [c for c in (want << k for k in range(1, 5)) if c <= MAX_CLUSTER]
    smaller = [c for c in (want >> k for k in range(1, 5)) if c >= 1]
    cluster, shared = None, True
    for c in [want] + larger + smaller:
        stride = region_bytes(n, m, c)
        if stride <= shared_limit and clusters(c, stride) > 0:
            cluster = c
            break
    if cluster is None:
        shared = False
        cluster = next((c for c in [want] + smaller if clusters(c, 0) > 0), None)
        if cluster is None:
            raise RuntimeError(f"auction: no cluster of phase-B blocks launches for ({n}, {m})")
    stride = region_bytes(n, m, cluster)
    bids = -(-8 * b * n // WORK_ALIGN) * WORK_ALIGN
    return LaunchPlan(first_round_split(b * n, m, sms), cluster, shared, -(-m // cluster),
                      -(-n // cluster), stride, bids + (0 if shared else b * cluster * stride))


@lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    """``csrc/auction.cu``'s library (built and loaded once), its entry
    points typed."""
    lib = _cuda.load(KERNEL)
    lib.auction.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                            ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
                            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                            ctypes.c_size_t, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.auction.restype = ctypes.c_int
    lib.auction_shared_limit.argtypes = [ctypes.c_int]
    lib.auction_shared_limit.restype = ctypes.c_int
    lib.auction_max_clusters.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.auction_max_clusters.restype = ctypes.c_int
    return lib


@lru_cache(maxsize=1024)
def _plan(device_index: int, b: int, n: int, m: int) -> LaunchPlan:
    """The launch plan on one card, kept per (device, b, n, m)."""
    lib = _library()
    with torch.cuda.device(device_index):
        limit = lib.auction_shared_limit(device_index)
        if limit < 0:
            raise RuntimeError(f"auction: cannot query cuda:{device_index}")

        def clusters(cluster: int, shared: int) -> int:
            count = lib.auction_max_clusters(cluster, shared)
            if count < 0:
                raise RuntimeError(f"auction: cluster occupancy query failed with CUDA error "
                                   f"{-count}")
            return count

        sms = torch.cuda.get_device_properties(device_index).multi_processor_count
        return launch_plan(b, n, m, sms, limit, clusters)


def plan_of(cost: torch.Tensor) -> LaunchPlan:
    """The launch plan ``auction_assignment`` takes for a (..., N, M) CUDA
    cost."""
    n, m = cost.shape[-2:]
    return _plan(cost.device.index, math.prod(cost.shape[:-2]), n, m)


def build(verbose: bool = False) -> tuple:
    """Compile the kernel (see ``_cuda.build``); returns (path, log)."""
    return _cuda.build(KERNEL, verbose=verbose)


def auction_assignment(cost: torch.Tensor, eps: float = 2e-4, max_iters: int = 512, *,
                       stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Min-cost assignment of (..., N, M) cost rows to distinct columns, N <= M,
    for each leading (video) index; returns (..., N) int64 columns, -1 for
    rows still unassigned after ``max_iters`` rounds.

    A CPU tensor runs ``auction_assignment_torch``. A CUDA tensor takes
    contiguous float32 costs with N <= M, or raises; one call launches two
    kernels on the current stream for the whole batch (the first round over
    the whole card, then the later rounds in one thread-block cluster per
    problem, chained by programmatic dependent launch) and reads nothing
    back, so it can be captured in a CUDA graph. Each problem's state lives
    in the cluster's shared memory where it fits, else in device memory
    allocated here. ``stats``, a contiguous (..., 2) int64 CUDA tensor,
    receives each problem's rounds and its bidder rows summed over the
    rounds. ``auction_assignment.launches`` counts the calls that launched
    the kernels (two kernels each)."""
    if cost.device.type == "cpu":
        if stats is not None:
            raise ValueError("auction_assignment: stats are counted by the kernel only")
        return auction_assignment_torch(cost, eps=eps, max_iters=max_iters)
    if cost.device.type != "cuda":
        raise ValueError(f"auction_assignment: unsupported device {cost.device}")
    if cost.dtype != torch.float32:
        raise TypeError(f"auction_assignment: the kernel takes float32, got {cost.dtype}")
    if cost.dim() < 2:
        raise ValueError(f"auction_assignment: the kernel takes (..., N, M), got {tuple(cost.shape)}")
    if not cost.is_contiguous():
        raise ValueError("auction_assignment: the kernel takes a contiguous tensor")
    n, m = cost.shape[-2:]
    lead = cost.shape[:-2]
    b = math.prod(lead)
    if n > m:
        raise ValueError(f"auction_assignment: the kernel takes N <= M, got N={n}, M={m}")
    if stats is not None and (stats.device != cost.device or stats.dtype != torch.int64
                              or tuple(stats.shape) != tuple(lead) + (2,)
                              or not stats.is_contiguous()):
        raise ValueError(f"auction_assignment: stats must be a contiguous {tuple(lead) + (2,)} "
                         f"int64 tensor on {cost.device}")
    out = torch.empty(lead + (n,), dtype=torch.int64, device=cost.device)
    if b == 0 or n == 0:
        return out
    if b > 2 ** 31 - 1:
        raise ValueError(f"auction_assignment: batch {b} exceeds the launch grid")
    index = cost.device.index
    plan = _plan(index, b, n, m)
    work = torch.empty((plan.work,), dtype=torch.uint8, device=cost.device)
    with (contextlib.nullcontext() if torch.cuda.current_device() == index
          else torch.cuda.device(index)):
        rc = _library().auction(
            cost.data_ptr(), out.data_ptr(), b, n, m, eps, max_iters, plan.split, plan.cluster,
            plan.shared, plan.cols, plan.rows, plan.stride, work.data_ptr(),
            None if stats is None else stats.data_ptr(),
            torch.cuda.current_stream(index).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"auction kernel launch failed with CUDA error {rc} ({plan})")
    auction_assignment.launches += 1
    return out


auction_assignment.launches = 0


def masked_assignment(cost: torch.Tensor, row_valid: torch.Tensor, col_valid: torch.Tensor,
                      threshold: float, eps: float = 2e-4, max_iters: int = 512):
    """Gated rectangular assignment (the tracker-association primitive).

    cost: (..., N, M); invalid rows/columns and pairs with cost >
    ``threshold`` may not match. Returns (row_to_col (..., N), matched
    (..., N)); unmatched rows get -1. Each row gets a private dummy column
    at ``threshold + delta``, every other dummy is at the gated level
    ``threshold + 2*delta``, so an unmatched row takes its own dummy without
    contention. A leading (video) axis runs one auction for the group."""
    n, m = cost.shape[-2:]
    dev = cost.device
    delta = 0.05 * max(float(threshold), 1.0)
    gated_cost = threshold + 2.0 * delta
    gated = torch.where(
        row_valid[..., :, None] & col_valid[..., None, :] & (cost <= threshold), cost, gated_cost
    )
    eye = torch.eye(n, dtype=torch.bool, device=dev)
    dummies = torch.where(eye, threshold + delta, gated_cost).to(gated.dtype)
    padded = torch.cat([gated, dummies.expand(gated.shape[:-1] + (n,))], dim=-1)
    col = auction_assignment(padded, eps=eps, max_iters=max_iters)
    pair_cost = padded.gather(-1, torch.clamp(col, 0, m + n - 1)[..., None])[..., 0]
    matched = (col >= 0) & (col < m) & row_valid & (pair_cost <= threshold)
    return torch.where(matched, col, -1), matched


# ---------------------------------------------------------------------------
# Exact host solver (the native Jonker-Volgenant solver)
# ---------------------------------------------------------------------------

def _lapjv_library() -> ctypes.CDLL:
    global _lap_lib
    if _lap_lib is None:
        from geotrax_tpu_torch.io import native

        lib = ctypes.CDLL(str(native.build_plain(LAPJV_SOURCE)))
        lib.gtx_lapjv.restype = ctypes.c_int
        lib.gtx_lapjv.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        _lap_lib = lib
    return _lap_lib


def lapjv_exact(cost: np.ndarray) -> np.ndarray:
    """Exact min-cost assignment of an (N, M) cost on the host; returns (N,)
    int64 columns, -1 for the rows left over when N > M (the problem is then
    solved transposed). Raises ``RuntimeError`` when the solver cannot be
    built and ``ValueError`` when it finds no finite assignment."""
    cost = np.ascontiguousarray(cost, dtype=np.float64)
    n, m = cost.shape
    if n == 0 or m == 0:
        return np.full(n, -1, dtype=np.int64)
    if n > m:
        cols = lapjv_exact(cost.T)
        result = np.full(n, -1, dtype=np.int64)
        result[cols] = np.arange(m)
        return result
    out = np.empty(n, dtype=np.int64)
    rc = _lapjv_library().gtx_lapjv(cost.ctypes.data, n, m, out.ctypes.data)
    if rc != 0:
        raise ValueError(f"gtx_lapjv found no assignment (code {rc}): is the cost finite?")
    return out
