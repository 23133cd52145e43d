// Forward auction for a batch of min-cost assignment problems (sm_90a).
//
// Replaces no Pallas kernel: it ports the reference's device loop
// geotrax_tpu/ops/assignment.py:auction_assignment, a lax.while_loop (:77)
// that runs every round on the accelerator and tests convergence there. The
// port drove that loop from the host (about 28 small launches a round and a
// read of the card every 8 rounds); this kernel runs the whole auction of
// each problem in one launch, with no host read between rounds.
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
// Design. One block of 1024 threads owns one problem (the lockstep's V
// videos and RT-DETR's images are the batch) and loops over its rounds:
//
//  * Compaction. The unassigned rows are listed at the start of each round,
//    so a round scans only its bidders; a problem stops when the list is
//    empty (the reference's convergence test) or after max_iters rounds.
//  * Bids. One warp scans one bidder's row: coalesced 16-byte loads of the
//    cost (4-byte ones where the width is not a multiple of 4), four in
//    flight per lane, prices from the state, a running (best, column,
//    second) per lane merged across the warp by shuffles.
//  * Awards. A bidder posts the 64-bit key (order-preserving bits of the
//    bid << 32) | (0xFFFFFFFF - row) with atomicMax on its column, so the
//    highest bid and then the lowest row wins, whatever the order of the
//    atomics. After a barrier each winner updates its column alone: the
//    column's old owner was assigned and the winner was not, so no two
//    writes collide. A winning bid that is not finite changes nothing, as in
//    the plain version.
//  * State. Prices, owners and keys (16 B a column) and the assignment, the
//    bidder list and the bids (16 B a row) live in shared memory: 48 KB at
//    the tracker's (1000, 2000). A problem whose state exceeds the block's
//    shared memory gets it in device memory from the wrapper (torch.empty)
//    and runs the same code through generic pointers.
//
// Bound. The work depends on the data: each round reads the rows of its
// bidders once (4 B a cost), and the answer is written once (8 B a row), so
// the least time is (sum over rounds of bidders x M x 4 + N x 8) bytes over
// the card's 3.35 TB/s; the few float operations per cost are far below the
// float32 rate. One block reads its first round, every row, at the rate of
// one SM, not of the card: about 8 MB at the tracker's shape. A cluster of
// blocks splitting the rows and sharing the column keys through distributed
// shared memory is the Hopper redesign that would fill the card (ROADMAP).
//
// Registers, shared memory and spills (nvcc -Xptxas -v, printed by
// chip_smoke.py's build phase) and the times are in PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr size_t HEADER = 16;  // the round's bidder count, padded to 16 B
constexpr unsigned int NEG_INF_BITS = 0xff800000u;

__host__ __device__ inline size_t state_bytes(int n, int m) {
    return HEADER + (size_t)m * (8 + 4 + 4) + (size_t)n * (4 + 4 + 4 + 4);
}

// float -> uint32 whose unsigned order is the float order (NaN aside)
__device__ __forceinline__ unsigned int ordered_bits(float f) {
    unsigned int u = __float_as_uint(f);
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
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

__device__ __forceinline__ void take4(float4 c, float4 p, int j, float& best, int& col,
                                      float& second) {
    take(__fsub_rn(-c.x, p.x), j, best, col, second);
    take(__fsub_rn(-c.y, p.y), j + 1, best, col, second);
    take(__fsub_rn(-c.z, p.z), j + 2, best, col, second);
    take(__fsub_rn(-c.w, p.w), j + 3, best, col, second);
}

// (best, col, second) of one row over the whole warp
template <bool VEC4>
__device__ __forceinline__ void row_best(const float* __restrict__ row, const float* price,
                                         int m, int lane, float& best, int& col, float& second) {
    best = __uint_as_float(NEG_INF_BITS);
    second = best;
    col = 0x7fffffff;
    if (VEC4) {
        const float4* r4 = reinterpret_cast<const float4*>(row);
        const float4* p4 = reinterpret_cast<const float4*>(price);
        const int m4 = m >> 2;
        int q = lane;
        for (; q + 96 < m4; q += 128) {
            const float4 a0 = __ldg(r4 + q), a1 = __ldg(r4 + q + 32);
            const float4 a2 = __ldg(r4 + q + 64), a3 = __ldg(r4 + q + 96);
            take4(a0, p4[q], 4 * q, best, col, second);
            take4(a1, p4[q + 32], 4 * (q + 32), best, col, second);
            take4(a2, p4[q + 64], 4 * (q + 64), best, col, second);
            take4(a3, p4[q + 96], 4 * (q + 96), best, col, second);
        }
        for (; q < m4; q += 32) take4(__ldg(r4 + q), p4[q], 4 * q, best, col, second);
    } else {
        int j = lane;
        for (; j + 96 < m; j += 128) {
            const float a0 = __ldg(row + j), a1 = __ldg(row + j + 32);
            const float a2 = __ldg(row + j + 64), a3 = __ldg(row + j + 96);
            take(__fsub_rn(-a0, price[j]), j, best, col, second);
            take(__fsub_rn(-a1, price[j + 32]), j + 32, best, col, second);
            take(__fsub_rn(-a2, price[j + 64]), j + 64, best, col, second);
            take(__fsub_rn(-a3, price[j + 96]), j + 96, best, col, second);
        }
        for (; j < m; j += 32) take(__fsub_rn(-__ldg(row + j), price[j]), j, best, col, second);
    }
    // merge the lanes: the pair's winner keeps its best, second is the
    // larger of its own second and the loser's best
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best, off);
        const float os = __shfl_xor_sync(0xffffffffu, second, off);
        const int oc = __shfl_xor_sync(0xffffffffu, col, off);
        if (ob > best || (ob == best && oc < col)) {
            second = larger(os, best);
            best = ob;
            col = oc;
        } else {
            second = larger(second, ob);
        }
    }
}

template <bool VEC4>
__global__ void __launch_bounds__(THREADS, 1)
auction_kernel(const float* __restrict__ cost, long long* __restrict__ out, int n, int m,
               float eps, int max_iters, unsigned char* scratch, size_t scratch_stride,
               long long* stats) {
    extern __shared__ __align__(16) unsigned char smem[];
    unsigned char* base = scratch ? scratch + (size_t)blockIdx.x * scratch_stride : smem;
    int* count = reinterpret_cast<int*>(base);
    unsigned long long* key = reinterpret_cast<unsigned long long*>(base + HEADER);
    float* price = reinterpret_cast<float*>(key + m);
    int* owner = reinterpret_cast<int*>(price + m);
    int* assigned = owner + m;
    int* bidders = assigned + n;
    int* bid_col = bidders + n;
    float* bid_val = reinterpret_cast<float*>(bid_col + n);

    const float* c = cost + (size_t)blockIdx.x * n * m;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

    for (int j = tid; j < m; j += THREADS) {
        key[j] = 0ull;
        price[j] = 0.0f;
        owner[j] = -1;
    }
    for (int i = tid; i < n; i += THREADS) assigned[i] = -1;

    long long rounds = 0, bids = 0;
    for (int it = 0;; ++it) {
        if (tid == 0) count[0] = 0;
        __syncthreads();
        for (int i = tid; i < n; i += THREADS) {
            if (assigned[i] < 0) bidders[atomicAdd(count, 1)] = i;
        }
        __syncthreads();
        const int nb = count[0];
        if (nb == 0 || it >= max_iters) break;

        for (int k = warp; k < nb; k += WARPS) {
            const int i = bidders[k];
            float best, second;
            int col;
            row_best<VEC4>(c + (size_t)i * m, price, m, lane, best, col, second);
            if (lane == 0) {
                if (!isfinite(second)) second = __fsub_rn(best, 1.0f);
                const float bid = __fadd_rn(__fsub_rn(best, second), eps);
                bid_col[k] = col;
                bid_val[k] = bid;
                atomicMax(&key[col], ((unsigned long long)ordered_bits(bid) << 32)
                                         | (0xffffffffu - (unsigned int)i));
            }
        }
        __syncthreads();

        for (int k = tid; k < nb; k += THREADS) {
            const int i = bidders[k], j = bid_col[k];
            const float bid = bid_val[k];
            if ((unsigned int)(key[j] & 0xffffffffull) == 0xffffffffu - (unsigned int)i
                && isfinite(bid)) {
                const int old = owner[j];
                if (old >= 0) assigned[old] = -1;
                owner[j] = i;
                price[j] = __fadd_rn(price[j], bid);
                assigned[i] = j;
            }
        }
        __syncthreads();
        for (int k = tid; k < nb; k += THREADS) key[bid_col[k]] = 0ull;
        rounds += 1;
        bids += nb;
    }

    long long* o = out + (size_t)blockIdx.x * n;
    for (int i = tid; i < n; i += THREADS) o[i] = assigned[i];
    if (stats != nullptr && tid == 0) {
        stats[2 * (size_t)blockIdx.x] = rounds;
        stats[2 * (size_t)blockIdx.x + 1] = bids;
    }
}

}  // namespace

extern "C" {

// Bytes of one problem's state (its shared memory, or its scratch stride
// before rounding).
size_t auction_state_bytes(int n, int m) { return state_bytes(n, m); }

// The most shared memory a block of this kernel may use on ``device``.
int auction_shared_limit(int device) {
    int v = 0;
    if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) != cudaSuccess)
        return 0;
    return v;
}

// Assign each of b problems of a contiguous (b, n, m) float32 cost; writes
// (b, n) int64 columns to ``out`` and, if ``stats`` is not null, (b, 2)
// int64 (rounds run, bidder rows summed over the rounds). ``scratch`` null:
// the state lives in shared memory; else problem p's state is at scratch +
// p * scratch_stride. Launches on ``stream`` and returns the launch's CUDA
// error code (0 on success); it does not synchronise.
int auction(const float* cost, long long* out, int b, int n, int m, float eps, int max_iters,
            unsigned char* scratch, size_t scratch_stride, long long* stats,
            cudaStream_t stream) {
    if (b <= 0 || n <= 0) return 0;
    if (n > m) return (int)cudaErrorInvalidValue;
    const bool vec4 = (m % 4 == 0) && (reinterpret_cast<uintptr_t>(cost) % 16 == 0);
    size_t shared = 0;
    if (scratch == nullptr) {
        shared = state_bytes(n, m);
        int device = 0;
        cudaGetDevice(&device);
        if (shared > (size_t)auction_shared_limit(device)) return (int)cudaErrorInvalidValue;
        cudaError_t err = vec4
            ? cudaFuncSetAttribute(auction_kernel<true>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared)
            : cudaFuncSetAttribute(auction_kernel<false>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
        if (err != cudaSuccess) return (int)err;
    }
    if (vec4) {
        auction_kernel<true><<<b, THREADS, shared, stream>>>(cost, out, n, m, eps, max_iters,
                                                             scratch, scratch_stride, stats);
    } else {
        auction_kernel<false><<<b, THREADS, shared, stream>>>(cost, out, n, m, eps, max_iters,
                                                              scratch, scratch_stride, stats);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
