// Forward auction for a batch of min-cost assignment problems (sm_90a).
//
// Replaces no Pallas kernel: it ports the reference's device loop
// geotrax_tpu/ops/assignment.py:auction_assignment, a lax.while_loop (:77)
// that runs every round on the accelerator and tests convergence there. One
// call runs every round of every problem of the batch on the card, with no
// host read between rounds.
//
// The auction (ops/assignment.py:auction_assignment_torch, the plain
// version, which is bit-equal to the reference): from zero prices, each
// round every unassigned row bids on its best column
//
//   value[j] = (-cost[j]) - price[j]
//   best     = max value, the lowest column on ties (argmax)
//   second   = max over every other column (best again when two tie);
//              best - 1 where it is not finite (a one-column problem)
//   bid      = (best - second) + eps
//
// and each column that received a bid goes to its highest bidder (the
// lowest row on ties): the old owner becomes unassigned, the price rises by
// the winning bid. Rows still unassigned after max_iters rounds return -1.
// Every value is rounded as the plain version's float32 tensor operations
// round it: __fsub_rn / __fadd_rn, no fused multiply-add.
//
// Bound. The work depends on the data: each round reads the rows of its
// bidders once (4 B a cost), and the answer is written once (8 B a row), so
// the least time is (sum over rounds of bidders x M x 4 + N x 8) bytes over
// the card's 3.35 TB/s; the few float operations per cost are far below the
// float32 rate. The first round reads every row (every row starts
// unassigned), and on the tracker's path it is most often the only round.
//
// Design: two kernels on one stream, chained by programmatic dependent
// launch, so the second one's set-up overlaps the first one's tail and no
// host read separates them.
//
//  * first_round (phase A). Every row of every problem bids against zero
//    prices: a pure row reduction of -cost that depends on no state. It is
//    spread over the whole card, one warp per row, or ``split`` warps of one
//    block per row where the batch has few rows; coalesced 16-byte loads of
//    the cost (4-byte ones where the width is not a multiple of 4 or the base
//    is not 16-byte aligned), eight in flight per lane. Each row writes its
//    (column, bid) to the wrapper's work buffer.
//  * later_rounds (phase B). One thread-block cluster of ``cluster`` blocks
//    (16, non-portable; one block alone for a problem of at most 64 rows)
//    per problem posts the first round's bids, makes its awards and runs
//    every later round. Its state is split over the cluster's shared memory
//    and reached through distributed shared memory: each block holds the
//    bid keys and owners of 1/cluster of the columns, the assignment of
//    1/cluster of the rows, and a replica of every price, so a bidder's scan
//    reads its prices from its own block. A round takes two cluster
//    barriers:
//      bids: each block lists its unassigned rows and scans them, one warp a
//      row, or several warps a row where it has fewer bidders than warps
//      (the rows come back from L2, read there in the first round); each
//      bidder posts the 64-bit key (order-preserving bits of the bid << 32)
//      | (0xFFFFFFFF - row) on its column's key in the block that owns the
//      column, by compare-and-swap, so the highest bid and then the lowest
//      row wins in any order; barrier;
//      awards: each block reads its own columns' keys, clears them, and
//      gives each column to its key's row if the bid is finite: the old
//      owner (assigned before the round, so no two writes collide) is
//      unassigned in its row's block, the new price goes to every replica;
//      each block sends every block its count of rows assigned less rows
//      displaced, whose sum says how many bid next; barrier.
//    Only stores and the key's compare-and-swap cross blocks, and each block
//    reaches its own state by its local address. The (best, column, second)
//    merge of a split row is exact in any order (but for the sign of a zero
//    second, which moves a bid only when eps is 0), so the split changes no
//    bit. A one-block problem runs a build of the same code without the
//    cluster: its barriers are the block's, with no GPU-wide fence.
//  * A problem whose state exceeds a block's shared memory (a price replica
//    is 4 B a column: past ~49,000 columns) runs the same code on the same
//    layout in device memory (the wrapper's work buffer), through L2.
//
// Scratch: the wrapper allocates the work buffer (the first round's bids, 8 B
// a row, and the device-memory state) with torch.empty; phase B sets every
// key and count it uses itself, so a call captured in a CUDA graph replays
// correctly.
//
// Registers, shared memory and spills (nvcc -Xptxas -v, printed by
// chip_smoke.py's build phase) and the times are in PERF.md.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int A_THREADS = 256;  // phase A: 8 warps a block
constexpr int A_WARPS = A_THREADS / 32;
constexpr int B_THREADS = 512;  // phase B: 16 warps a block
constexpr int B_WARPS = B_THREADS / 32;
constexpr int MAX_CLUSTER = 16;
constexpr int LOADS = 8;  // loads in flight per lane
constexpr int NO_COL = 0x7fffffff;
constexpr unsigned int NEG_INF_BITS = 0xff800000u;

// One block's state in phase B; the layout is the same in shared and in
// device memory. ``cols`` and ``rows`` are the columns and rows one block
// owns (ceil(m / cluster), ceil(n / cluster)).
__host__ __device__ inline size_t region_bytes(int n, int m, int cluster) {
    const size_t cols = (size_t)((m + cluster - 1) / cluster);
    const size_t rows = (size_t)((n + cluster - 1) / cluster);
    const size_t m4 = (size_t)((m + 3) & ~3);
    const size_t bytes = 4 * MAX_CLUSTER + 4 * m4 + cols * (8 + 4) + rows * (4 + 4);
    return (bytes + 15) & ~(size_t)15;
}

struct Region {
    int* nets;                 // each block's rows assigned less rows displaced this round
    float* price;              // every column's price (this block's replica)
    unsigned long long* key;   // the owned columns' bid keys
    int* owner;                // the owned columns' rows, -1 for none
    int* assigned;             // the owned rows' columns, -1 for none
    int* bidders;              // the owned rows that bid this round
};

__device__ __forceinline__ Region carve(unsigned char* base, int m, int cols, int rows) {
    Region s;
    s.nets = reinterpret_cast<int*>(base);
    s.price = reinterpret_cast<float*>(base + 4 * MAX_CLUSTER);
    s.key = reinterpret_cast<unsigned long long*>(s.price + ((m + 3) & ~3));
    s.owner = reinterpret_cast<int*>(s.key + cols);
    s.assigned = s.owner + cols;
    s.bidders = s.assigned + rows;
    return s;
}

// float -> uint32 whose unsigned order is the float order (NaN aside)
__device__ __forceinline__ unsigned int ordered_bits(float f) {
    unsigned int u = __float_as_uint(f);
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ unsigned long long key_of(float bid, int row) {
    return ((unsigned long long)ordered_bits(bid) << 32) | (0xffffffffu - (unsigned int)row);
}

// Raise the 64-bit key at ``addr`` to ``key`` if it is larger: a
// compare-and-swap loop that starts from the key it reads, so a bid below
// the column's best so far costs no atomic. (A 64-bit atomicMax on another
// block's shared memory is not atomic against the same block's own, which
// the compiler emulates differently.) ``local``: ``addr`` is this block's
// shared memory, swapped there directly.
__device__ __forceinline__ void post_key(unsigned long long* addr, unsigned long long key,
                                         bool local) {
    const unsigned int at = local ? (unsigned int)__cvta_generic_to_shared(addr) : 0u;
    unsigned long long seen;
    if (local)
        asm volatile("ld.volatile.shared.u64 %0, [%1];" : "=l"(seen) : "r"(at) : "memory");
    else
        seen = *reinterpret_cast<volatile unsigned long long*>(addr);
    while (seen < key) {
        unsigned long long prev;
        if (local) {
            asm volatile("atom.shared.cas.b64 %0, [%1], %2, %3;"
                         : "=l"(prev) : "r"(at), "l"(seen), "l"(key) : "memory");
        } else {
            prev = atomicCAS(addr, seen, key);
        }
        if (prev == seen) break;
        seen = prev;
    }
}

__device__ __forceinline__ float larger(float a, float b) { return a > b ? a : b; }

// Fold value v of column j into (best, col, second): v beats best when it is
// larger, or equal at a lower column; second is the largest of the rest.
__device__ __forceinline__ void take(float v, int j, float& best, int& col, float& second) {
    if (v > best || (v == best && j < col)) {
        second = larger(second, best);
        best = v;
        col = j;
    } else {
        second = larger(second, v);
    }
}

// Merge another partial (ob, oc, os) into (best, col, second): the winner
// keeps its best, second is the larger of its own second and the loser's
// best. Exact in any order and grouping.
__device__ __forceinline__ void merge(float ob, int oc, float os, float& best, int& col,
                                      float& second) {
    if (ob > best || (ob == best && oc < col)) {
        second = larger(os, best);
        best = ob;
        col = oc;
    } else {
        second = larger(second, ob);
    }
}

__device__ __forceinline__ void warp_merge(float& best, int& col, float& second) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best, off);
        const float os = __shfl_xor_sync(0xffffffffu, second, off);
        const int oc = __shfl_xor_sync(0xffffffffu, col, off);
        merge(ob, oc, os, best, col, second);
    }
}

// Where the prices come from: none (all zero, the first round), this block's
// shared memory, or device memory written by other blocks (read through L2).
enum { PRICE_ZERO = 0, PRICE_SHARED = 1, PRICE_GLOBAL = 2 };

template <int PRICE>
__device__ __forceinline__ float4 price4(const float4* p, int q) {
    if (PRICE == PRICE_ZERO) return make_float4(0.f, 0.f, 0.f, 0.f);
    if (PRICE == PRICE_SHARED) return p[q];
    return __ldcg(p + q);
}

template <int PRICE>
__device__ __forceinline__ float price1(const float* p, int j) {
    if (PRICE == PRICE_ZERO) return 0.0f;
    if (PRICE == PRICE_SHARED) return p[j];
    return __ldcg(p + j);
}

// Fold one lane's columns of one row into (best, col, second): with VEC4 the
// float4 groups first, first + stride, ...; else the columns so. Prices of
// zero give (-c) - 0 = -c exactly, as the plain version's first round does.
template <bool VEC4, int PRICE>
__device__ __forceinline__ void scan(const float* __restrict__ row, const float* price, int m,
                                     int first, int stride, float& best, int& col,
                                     float& second) {
    if (VEC4) {
        const float4* r4 = reinterpret_cast<const float4*>(row);
        const float4* p4 = reinterpret_cast<const float4*>(price);
        const int m4 = m >> 2;
        for (int q0 = first; q0 < m4; q0 += LOADS * stride) {
            float4 a[LOADS];
#pragma unroll
            for (int u = 0; u < LOADS; ++u) {
                const int q = q0 + u * stride;
                a[u] = q < m4 ? __ldg(r4 + q) : make_float4(0.f, 0.f, 0.f, 0.f);
            }
#pragma unroll
            for (int u = 0; u < LOADS; ++u) {
                const int q = q0 + u * stride;
                if (q < m4) {
                    const float4 p = price4<PRICE>(p4, q);
                    const int j = 4 * q;
                    take(__fsub_rn(-a[u].x, p.x), j, best, col, second);
                    take(__fsub_rn(-a[u].y, p.y), j + 1, best, col, second);
                    take(__fsub_rn(-a[u].z, p.z), j + 2, best, col, second);
                    take(__fsub_rn(-a[u].w, p.w), j + 3, best, col, second);
                }
            }
        }
    } else {
        for (int j0 = first; j0 < m; j0 += LOADS * stride) {
            float a[LOADS];
#pragma unroll
            for (int u = 0; u < LOADS; ++u) {
                const int j = j0 + u * stride;
                a[u] = j < m ? __ldg(row + j) : 0.0f;
            }
#pragma unroll
            for (int u = 0; u < LOADS; ++u) {
                const int j = j0 + u * stride;
                if (j < m) take(__fsub_rn(-a[u], price1<PRICE>(price, j)), j, best, col, second);
            }
        }
    }
}

// The partial of no column yet.
__device__ __forceinline__ void no_columns(float& best, int& col, float& second) {
    best = __uint_as_float(NEG_INF_BITS);
    second = best;
    col = NO_COL;
}

// The bid of a row whose scan gave (best, second).
__device__ __forceinline__ float bid_of(float best, float second, float eps) {
    if (!isfinite(second)) second = __fsub_rn(best, 1.0f);
    return __fadd_rn(__fsub_rn(best, second), eps);
}

// A row of NaN costs compares with nothing; argmax then names column 0.
__device__ __forceinline__ int named(int col) { return col == NO_COL ? 0 : col; }

// Phase A: the first round of every problem, ``rows`` = b * n rows of ``m``
// costs; row r's (column, bid) to bid_col[r], bid_val[r].
template <bool VEC4>
__global__ void __launch_bounds__(A_THREADS)
first_round(const float* __restrict__ cost, int* __restrict__ bid_col,
            float* __restrict__ bid_val, long long rows, int m, float eps, int split) {
    __shared__ float s_best[A_WARPS], s_second[A_WARPS];
    __shared__ int s_col[A_WARPS];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int per_block = A_WARPS / split;
    const long long row = (long long)blockIdx.x * per_block + warp / split;
    float best, second;
    int col;
    no_columns(best, col, second);
    if (row < rows) {
        scan<VEC4, PRICE_ZERO>(cost + row * m, nullptr, m, (warp % split) * 32 + lane,
                               32 * split, best, col, second);
        warp_merge(best, col, second);
    }
    if (split == 1) {
        if (lane == 0 && row < rows) {
            bid_col[row] = named(col);
            bid_val[row] = bid_of(best, second, eps);
        }
    } else {
        if (lane == 0) {
            s_best[warp] = best;
            s_col[warp] = col;
            s_second[warp] = second;
        }
        __syncthreads();
        const long long r = (long long)blockIdx.x * per_block + threadIdx.x;
        if (threadIdx.x < per_block && r < rows) {
            const int w0 = threadIdx.x * split;
            best = s_best[w0];
            col = s_col[w0];
            second = s_second[w0];
            for (int s = 1; s < split; ++s)
                merge(s_best[w0 + s], s_col[w0 + s], s_second[w0 + s], best, col, second);
            bid_col[r] = named(col);
            bid_val[r] = bid_of(best, second, eps);
        }
    }
    asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// Block r's copy of a location of this block's state: this block's own
// address for itself (local shared memory is far quicker than the cluster's
// window onto it), else through distributed shared memory, or at the same
// offset of its region in device memory.
template <bool SHARED, bool ONE, typename T>
__device__ __forceinline__ T* at_rank(T* p, int r, int rank, size_t stride) {
    if (ONE || r == rank) return p;
    if (SHARED) return cg::this_cluster().map_shared_rank(p, r);
    return reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(p)
                                + ((ptrdiff_t)r - rank) * (ptrdiff_t)stride);
}

// Loads of state other blocks write: device memory is read through L2.
template <bool SHARED, typename T>
__device__ __forceinline__ T load(const T* p) {
    if (SHARED) return *p;
    return __ldcg(p);
}

template <bool SHARED>
__device__ __forceinline__ void cluster_arrive() {
    if (!SHARED) __threadfence();
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// A barrier of the cluster (of the block alone for a cluster of one).
template <bool SHARED, bool ONE>
__device__ __forceinline__ void cluster_sync() {
    if (ONE) {
        __syncthreads();
        return;
    }
    cluster_arrive<SHARED>();
    cluster_wait();
}

// float from ordered_bits (its inverse)
__device__ __forceinline__ float from_ordered(unsigned int o) {
    return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

// Phase B: one cluster per problem; see the header. ONE: a cluster of one
// block, compiled without the cluster's window, fences and barriers.
template <bool VEC4, bool SHARED, bool ONE>
__global__ void __launch_bounds__(B_THREADS, 1)
later_rounds(const float* __restrict__ cost, const int* __restrict__ bid_col,
             const float* __restrict__ bid_val, long long* __restrict__ out, int n, int m,
             float eps, int max_iters, int cols, int rows, size_t stride,
             unsigned char* scratch, long long* stats) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ float s_best[B_WARPS], s_second[B_WARPS];
    __shared__ int s_col[B_WARPS], s_row[B_WARPS];
    __shared__ int s_count, s_net;

    const int cs = ONE ? 1 : (int)cg::this_cluster().num_blocks();
    const int rank = ONE ? 0 : (int)cg::this_cluster().block_rank();
    const int p = blockIdx.x / cs;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    Region s = carve(SHARED ? smem : scratch + (size_t)blockIdx.x * stride, m, cols, rows);
    const float* c = cost + (size_t)p * n * m;
    const int row0 = rank * rows, col0 = rank * cols;
    const int rows_here = max(0, min(rows, n - row0));
    const int cols_here = max(0, min(cols, m - col0));

    for (int j = tid; j < ((m + 3) & ~3); j += B_THREADS) s.price[j] = 0.0f;
    for (int j = tid; j < cols; j += B_THREADS) {
        s.key[j] = 0ull;
        s.owner[j] = -1;
    }
    for (int i = tid; i < rows; i += B_THREADS) s.assigned[i] = -1;
    if (tid == 0) s_count = 0;
    // every block's state is set before another block touches it, and the
    // first round's bids are complete and visible
    if (!ONE) cluster_arrive<SHARED>();
    asm volatile("griddepcontrol.wait;" ::: "memory");
    if (ONE)
        __syncthreads();
    else
        cluster_wait();

    // split m into up to B_WARPS warps a row, at least 256 columns a warp
    int max_split = 1;
    while (max_split < B_WARPS && 256 * 2 * max_split <= m) max_split *= 2;

    long long rounds = 0, bids = 0;
    int nb = n;
    for (int t = 1; max_iters >= 1; ++t) {
        // bids: each block's unassigned rows (every row in the first round,
        // whose bids phase A made) post their keys on their columns' blocks
        if (t == 1) {
            for (int k = tid; k < rows_here; k += B_THREADS) {
                const int i = row0 + k, j = bid_col[(size_t)p * n + i];
                post_key(at_rank<SHARED, ONE>(s.key, j / cols, rank, stride) + j % cols,
                         key_of(bid_val[(size_t)p * n + i], i), SHARED && (ONE || j / cols == rank));
            }
        } else {
            for (int k = tid; k < rows_here; k += B_THREADS)
                if (load<SHARED>(s.assigned + k) < 0) s.bidders[atomicAdd(&s_count, 1)] = row0 + k;
            __syncthreads();
            const int cnt = s_count;
            int split = 1;
            while (split < max_split && 2 * split * cnt <= B_WARPS) split *= 2;
            const int groups = B_WARPS / split, g = warp / split;
            for (int k0 = 0; k0 < cnt; k0 += groups) {  // one pass where split > 1
                const int k = k0 + g;
                float best, second;
                int col, i = -1;
                no_columns(best, col, second);
                if (k < cnt) {
                    i = s.bidders[k];
                    scan<VEC4, SHARED ? PRICE_SHARED : PRICE_GLOBAL>(
                        c + (size_t)i * m, s.price, m, (warp % split) * 32 + lane, 32 * split,
                        best, col, second);
                    warp_merge(best, col, second);
                }
                if (split > 1) {
                    if (lane == 0) {
                        s_best[warp] = best;
                        s_col[warp] = col;
                        s_second[warp] = second;
                        s_row[warp] = i;
                    }
                    __syncthreads();
                    i = -1;
                    if (tid < groups && k0 + tid < cnt) {
                        const int w0 = tid * split;
                        best = s_best[w0];
                        col = s_col[w0];
                        second = s_second[w0];
                        for (int q = 1; q < split; ++q)
                            merge(s_best[w0 + q], s_col[w0 + q], s_second[w0 + q], best, col,
                                  second);
                        i = s_row[w0];
                    }
                } else if (lane != 0 || k >= cnt) {
                    i = -1;
                }
                if (i >= 0) {  // one thread per bidder posts its bid
                    const int j = named(col);
                    post_key(at_rank<SHARED, ONE>(s.key, j / cols, rank, stride) + j % cols,
                             key_of(bid_of(best, second, eps), i),
                             SHARED && (ONE || j / cols == rank));
                }
            }
        }
        if (tid == 0) s_net = 0;
        cluster_sync<SHARED, ONE>();  // every bid of round t posted

        // awards: each block gives its own columns to their highest bidders
        // and clears their keys for the next round; the assignment changes
        // go to the rows' blocks, the prices to every replica
        int net = 0;  // rows assigned less rows displaced
        if (tid == 0) s_count = 0;  // for the next round's list
        for (int jj = tid; jj < cols_here; jj += B_THREADS) {
            const unsigned long long key = load<SHARED>(s.key + jj);
            if (key == 0ull) continue;
            s.key[jj] = 0ull;
            const int i = (int)(0xffffffffu - (unsigned int)(key & 0xffffffffull));
            const float bid = from_ordered((unsigned int)(key >> 32));
            if (!isfinite(bid)) continue;
            const int j = col0 + jj, old = load<SHARED>(s.owner + jj);
            if (old >= 0) {
                *(at_rank<SHARED, ONE>(s.assigned, old / rows, rank, stride) + old % rows) = -1;
                --net;
            }
            s.owner[jj] = i;
            *(at_rank<SHARED, ONE>(s.assigned, i / rows, rank, stride) + i % rows) = j;
            ++net;
            const float price = __fadd_rn(load<SHARED>(s.price + j), bid);
            for (int q = 0; q < cs; ++q) *(at_rank<SHARED, ONE>(s.price, q, rank, stride) + j) = price;
        }
        if (net != 0) atomicAdd(&s_net, net);
        __syncthreads();  // this block's net count complete: send it to every block
        rounds += 1;
        bids += nb;
        if (ONE) {
            nb -= s_net;
        } else {
            if (tid < cs) *(at_rank<SHARED, ONE>(s.nets, tid, rank, stride) + rank) = s_net;
            cluster_sync<SHARED, ONE>();  // round t's awards done
            for (int q = 0; q < cs; ++q) nb -= load<SHARED>(s.nets + q);
        }
        if (nb == 0 || t >= max_iters) break;
    }
    // no block touches another's state after the round's last barrier, so
    // each may leave now

    long long* o = out + (size_t)p * n + row0;
    for (int k = tid; k < rows_here; k += B_THREADS) o[k] = load<SHARED>(s.assigned + k);
    if (stats != nullptr && rank == 0 && tid == 0) {
        stats[2 * (size_t)p] = rounds;
        stats[2 * (size_t)p + 1] = bids;
    }
}

using RoundsKernel = void (*)(const float*, const int*, const float*, long long*, int, int,
                              float, int, int, int, size_t, unsigned char*, long long*);

template <bool VEC4>
RoundsKernel rounds_of(bool shared, bool one) {
    if (shared) return one ? &later_rounds<VEC4, true, true> : &later_rounds<VEC4, true, false>;
    return one ? &later_rounds<VEC4, false, true> : &later_rounds<VEC4, false, false>;
}

RoundsKernel rounds_for(bool vec4, bool shared, bool one) {
    return vec4 ? rounds_of<true>(shared, one) : rounds_of<false>(shared, one);
}

// The most dynamic shared memory phase B may take on ``device`` (its static
// arrays aside), with each instance's attributes set once per device.
constexpr int MAX_DEVICES = 64;
int shared_limits[MAX_DEVICES];

int prepare(int device) {
    if (device < 0 || device >= MAX_DEVICES) return -1;
    if (shared_limits[device] > 0) return shared_limits[device];
    int optin = 0;
    if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)
        != cudaSuccess)
        return -1;
    cudaFuncAttributes attr;
    if (cudaFuncGetAttributes(&attr, reinterpret_cast<const void*>(rounds_for(true, true, false)))
        != cudaSuccess)
        return -1;
    const int limit = optin - (int)attr.sharedSizeBytes;
    for (int k = 0; k < 8; ++k) {
        const bool shared = k & 2, one = k & 4;
        const void* f = reinterpret_cast<const void*>(rounds_for(k & 1, shared, one));
        if ((!one && cudaFuncSetAttribute(f, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)
                         != cudaSuccess)
            || cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    shared ? limit : 0) != cudaSuccess)
            return -1;
    }
    shared_limits[device] = limit;
    return limit;
}

}  // namespace

extern "C" {

// The most shared memory one block's state may take on ``device`` (-1 when
// the device cannot be queried).
int auction_shared_limit(int device) {
    int current = 0;
    cudaGetDevice(&current);
    if (current != device) return -1;
    return prepare(device);
}

// How many clusters of ``cluster`` phase-B blocks with ``shared`` bytes of
// state each (0: the state in device memory) the device can hold at once; 0
// when such a cluster cannot be launched, negative on a CUDA error.
int auction_max_clusters(int cluster, int shared) {
    int device = 0;
    cudaGetDevice(&device);
    if (prepare(device) < 0) return -1;
    cudaLaunchConfig_t config = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    config.gridDim = dim3(cluster, 1, 1);
    config.blockDim = dim3(B_THREADS, 1, 1);
    config.dynamicSmemBytes = shared;
    config.attrs = attr;
    config.numAttrs = 1;
    int count = 0;
    cudaError_t err = cudaOccupancyMaxActiveClusters(
        &count, reinterpret_cast<const void*>(rounds_for(true, shared > 0, false)), &config);
    if (err != cudaSuccess) {
        cudaGetLastError();
        return err == cudaErrorInvalidClusterSize ? 0 : -(int)err;
    }
    return count;
}

// Assign each of b problems of a contiguous (b, n, m) float32 cost; writes
// (b, n) int64 columns to ``out`` and, if ``stats`` is not null, (b, 2)
// int64 (rounds run, bidder rows summed over the rounds). The launch plan
// comes from the wrapper: phase A's ``split`` warps a row, phase B's
// ``cluster`` blocks a problem owning ``cols`` columns and ``rows`` rows
// each, ``stride`` bytes of state a block, in shared memory when ``shared``.
// ``work`` holds phase A's bids (8 B a row, the part rounded up to 256 B)
// and, unless ``shared``, b * cluster * stride bytes of state. Launches the
// kernels on ``stream`` and returns the CUDA error code (0 on success); it
// does not synchronise.
int auction(const float* cost, long long* out, int b, int n, int m, float eps, int max_iters,
            int split, int cluster, int shared, int cols, int rows, size_t stride,
            unsigned char* work, long long* stats, cudaStream_t stream) {
    if (b <= 0 || n <= 0) return 0;
    if (n > m || split < 1 || split > A_WARPS || (split & (split - 1)) || cluster < 1
        || cluster > MAX_CLUSTER || cols * cluster < m || rows * cluster < n
        || stride < region_bytes(n, m, cluster))
        return (int)cudaErrorInvalidValue;
    int device = 0;
    cudaGetDevice(&device);
    const int limit = prepare(device);
    if (limit < 0) return (int)cudaErrorInvalidDevice;
    if (shared && stride > (size_t)limit) return (int)cudaErrorInvalidValue;
    const bool vec4 = (m % 4 == 0) && (reinterpret_cast<uintptr_t>(cost) % 16 == 0);
    const long long total = (long long)b * n;
    int* bid_col = reinterpret_cast<int*>(work);
    float* bid_val = reinterpret_cast<float*>(work + 4 * total);
    unsigned char* scratch = shared ? nullptr : work + ((8 * total + 255) & ~255ll);
    const long long per_block = A_WARPS / split;
    const long long blocks = (total + per_block - 1) / per_block;
    if (blocks > 0x7fffffffll || (long long)b * cluster > 0x7fffffffll)
        return (int)cudaErrorInvalidValue;

    if (vec4)
        first_round<true><<<(unsigned int)blocks, A_THREADS, 0, stream>>>(
            cost, bid_col, bid_val, total, m, eps, split);
    else
        first_round<false><<<(unsigned int)blocks, A_THREADS, 0, stream>>>(
            cost, bid_col, bid_val, total, m, eps, split);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    // a cluster of one block launches as a plain grid: a cluster launch
    // makes every barrier of such a small problem slower
    cudaLaunchConfig_t config = {};
    cudaLaunchAttribute attr[2];
    int attrs = 0;
    if (cluster > 1) {
        attr[attrs].id = cudaLaunchAttributeClusterDimension;
        attr[attrs].val.clusterDim.x = cluster;
        attr[attrs].val.clusterDim.y = 1;
        attr[attrs].val.clusterDim.z = 1;
        ++attrs;
    }
    attr[attrs].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[attrs].val.programmaticStreamSerializationAllowed = 1;
    ++attrs;
    config.gridDim = dim3((unsigned int)(b * cluster), 1, 1);
    config.blockDim = dim3(B_THREADS, 1, 1);
    config.dynamicSmemBytes = shared ? stride : 0;
    config.stream = stream;
    config.attrs = attr;
    config.numAttrs = attrs;

    err = cudaLaunchKernelEx(&config, rounds_for(vec4, shared, cluster == 1), cost,
                             static_cast<const int*>(bid_col), static_cast<const float*>(bid_val),
                             out, n, m, eps, max_iters, cols, rows, stride, scratch, stats);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

}  // extern "C"
