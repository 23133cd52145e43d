// Greedy non-maximum suppression for a batch of score-sorted candidate sets
// (sm_90a).
//
// Replaces no Pallas kernel: it ports the reference's device loop
// geotrax_tpu/ops/nms.py:nms, a lax.while_loop (:81) that iterates the
// fixed point of greedy NMS on the accelerator and tests convergence there.
// One launch runs every image of the batch on the card, with no host read.
//
// What it computes (ops/nms.py:nms_torch, the plain version, which is
// bit-equal to the reference). Per image, the N candidates come sorted by
// score (descending, stable), with their per-class coordinate offset
// already added; a candidate is alive where its score is > 0. Greedy NMS
//
//   keep_i = alive_i and no j < i with keep_j and iou(j, i) > t
//
// is the unique fixed point the reference iterates to, so one sweep in
// score order gives it. The output is ``order`` at the first max_det kept
// positions (index 0 after them) and valid = slot < the number kept. Each
// IoU is rounded as ops/boxes.py:iou_matrix's float32 tensor operations
// round it, one operation at a time: maximum/minimum (NaN propagating),
// rb - lt, the clamp at 0, w * h, each area (x2 - x1) * (y2 - y1) clamped,
// area_a + area_b, - inter, + 1e-9f, the division; __fsub_rn / __fadd_rn /
// __fmul_rn / __fdiv_rn, so nvcc contracts nothing into a fused
// multiply-add. The comparison is iou > t in float32.
//
// Bound. The work depends on the data. Bytes: the sorted boxes and scores
// and ``order`` read once (28 B a candidate) and the outputs written once
// (9 B a slot). Operations: an IoU (14 float operations) for each pair of
// alive candidates, and an area (5) for each alive one, over the card's
// float32 rate; with many alive candidates the operations bound it.
//
// Design: one block of 1024 threads per image; the matrix of IoUs is never
// materialized. A bit per candidate in shared memory says "suppressed by a
// kept candidate". The block walks the candidates in tiles of 64, up to the
// last alive one:
//   (a) the tile's boxes and areas go to shared memory, its alive bits to a
//       64-bit word;
//   (b) for each row of the tile still open (alive, not suppressed), one
//       warp computes the row's IoUs with the later rows of the tile: two
//       ballots make its 64-bit word of in-tile suppressions;
//   (c) one warp resolves the tile in order from those words (a loop over
//       the open rows that stay unsuppressed, in registers) and writes the
//       kept rows' ``order`` entries into their output slots by rank;
//   (d) every later alive candidate not yet suppressed tests itself against
//       the tile's kept rows (one thread a candidate, stopping at the first
//       overlap); a ballot per 32 candidates sets their bits.
// The walk stops once max_det candidates are kept (every slot is then
// valid). The work is a kept row against the later candidates: O(kept x
// alive) IoUs, and no state besides the bits.
//
// Registers, shared memory and spills (nvcc -Xptxas -v, printed by
// chip_smoke.py's build phase) and the times are in PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 64;

// torch.maximum / torch.minimum: a NaN on either side propagates
__device__ __forceinline__ float tmax(float a, float b) {
    return a != a ? a : (b != b ? b : fmaxf(a, b));
}

__device__ __forceinline__ float tmin(float a, float b) {
    return a != a ? a : (b != b ? b : fminf(a, b));
}

// ops/boxes.py:box_area
__device__ __forceinline__ float box_area(float4 b) {
    return __fmul_rn(tmax(__fsub_rn(b.z, b.x), 0.0f), tmax(__fsub_rn(b.w, b.y), 0.0f));
}

// iou_matrix(a, b) > t for the earlier box a and the later box b. Most pairs
// do not intersect: their IoU is 0 / (union + eps), which is 0 (or NaN where
// an area is NaN; the union is >= 0 otherwise, so the divisor is > 0), and the
// division is skipped.
__device__ __forceinline__ bool overlaps(float4 a, float area_a, float4 b, float area_b, float t) {
    const float w = tmax(__fsub_rn(tmin(a.z, b.z), tmax(a.x, b.x)), 0.0f);
    const float h = tmax(__fsub_rn(tmin(a.w, b.w), tmax(a.y, b.y)), 0.0f);
    const float inter = __fmul_rn(w, h);
    const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
    if (inter == 0.0f) {
        return uni == uni && 0.0f > t;
    }
    return __fdiv_rn(inter, __fadd_rn(uni, 1e-9f)) > t;
}

__global__ void __launch_bounds__(THREADS)
nms_kernel(const float4* __restrict__ boxes, const float* __restrict__ scores,
           const int64_t* __restrict__ order, int n, float t, int max_det,
           int64_t* __restrict__ keep, unsigned char* __restrict__ valid) {
    extern __shared__ unsigned long long removed[];  // a bit per candidate
    __shared__ float4 s_box[TILE];
    __shared__ float s_area[TILE];
    __shared__ unsigned long long s_diag[TILE];
    __shared__ unsigned int s_alive[2];
    __shared__ unsigned long long s_kept;
    __shared__ int s_last, s_count;

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const size_t img = blockIdx.x;
    const float4* bx = boxes + img * n;
    const float* sc = scores + img * n;
    const int64_t* ord = order + img * n;
    int64_t* out = keep + img * max_det;
    unsigned char* ok = valid + img * max_det;
    unsigned int* removed32 = reinterpret_cast<unsigned int*>(removed);

    for (int w = tid; w < (n + 63) / 64; w += THREADS) {
        removed[w] = 0ull;
    }
    if (tid == 0) {
        s_last = -1;
        s_count = 0;
    }
    __syncthreads();
    int last = -1;  // the last alive position
    for (int i = tid; i < n; i += THREADS) {
        if (sc[i] > 0.0f) {
            last = i;
        }
    }
    for (int o = 16; o; o >>= 1) {
        last = max(last, __shfl_xor_sync(0xffffffffu, last, o));
    }
    if (lane == 0 && last >= 0) {
        atomicMax(&s_last, last);
    }
    __syncthreads();
    last = s_last;

    for (int base = 0; base <= last; base += TILE) {
        const int rows = min(TILE, n - base);
        // (a) the tile's boxes, areas and alive bits
        if (tid < TILE) {
            bool alive = false;
            if (tid < rows) {
                const float4 b = bx[base + tid];
                s_box[tid] = b;
                s_area[tid] = box_area(b);
                alive = sc[base + tid] > 0.0f;
            }
            const unsigned int bits = __ballot_sync(0xffffffffu, alive);
            if (lane == 0) {
                s_alive[warp] = bits;
            }
        }
        __syncthreads();
        const unsigned long long open =
            (((unsigned long long)s_alive[1] << 32) | s_alive[0]) & ~removed[base / TILE];
        // (b) each open row's suppressions of the later rows of the tile
        for (int r = warp; r < rows; r += WARPS) {
            if (!((open >> r) & 1ull)) {
                continue;  // the same for the whole warp
            }
            const float4 a = s_box[r];
            const float area_a = s_area[r];
            const int c0 = lane, c1 = lane + 32;
            const bool b0 = c0 > r && c0 < rows && overlaps(a, area_a, s_box[c0], s_area[c0], t);
            const bool b1 = c1 > r && c1 < rows && overlaps(a, area_a, s_box[c1], s_area[c1], t);
            const unsigned int lo = __ballot_sync(0xffffffffu, b0);
            const unsigned int hi = __ballot_sync(0xffffffffu, b1);
            if (lane == 0) {
                s_diag[r] = ((unsigned long long)hi << 32) | lo;
            }
        }
        __syncthreads();
        // (c) the tile in score order: a row is kept unless a kept row
        // before it in the tile suppresses it
        if (warp == 0) {
            unsigned long long cand = open, kept = 0ull;
            while (cand) {
                const int r = __ffsll((long long)cand) - 1;
                kept |= 1ull << r;
                cand &= ~(1ull << r) & ~s_diag[r];
            }
            const int count = s_count;
            for (int r = lane; r < TILE; r += 32) {
                if ((kept >> r) & 1ull) {
                    const int rank = count + __popcll(kept & ((1ull << r) - 1ull));
                    if (rank < max_det) {
                        out[rank] = ord[base + r];
                    }
                }
            }
            __syncwarp();
            if (lane == 0) {
                s_kept = kept;
                s_count = count + __popcll(kept);
            }
        }
        __syncthreads();
        if (s_count >= max_det) {
            break;  // every slot holds a kept candidate
        }
        const unsigned long long kept = s_kept;
        // (d) the later alive candidates the tile's kept rows suppress; each
        // 32-bit word of bits belongs to one warp
        if (kept) {
            for (int w = (base + TILE) / 32 + warp; w <= last / 32; w += WARPS) {
                const int j = w * 32 + lane;
                bool hit = false;
                if (j <= last && !((removed32[w] >> lane) & 1u) && sc[j] > 0.0f) {
                    const float4 b = bx[j];
                    const float area_b = box_area(b);
                    for (unsigned long long k = kept; k; k &= k - 1) {
                        const int r = __ffsll((long long)k) - 1;
                        if (overlaps(s_box[r], s_area[r], b, area_b, t)) {
                            hit = true;
                            break;
                        }
                    }
                }
                const unsigned int m = __ballot_sync(0xffffffffu, hit);
                if (lane == 0 && m) {
                    removed32[w] |= m;
                }
            }
        }
        __syncthreads();
    }
    // the slots past the kept candidates
    const int count = s_count;
    for (int k = tid; k < max_det; k += THREADS) {
        if (k >= count) {
            out[k] = 0;
        }
        ok[k] = k < count ? 1 : 0;
    }
}

}  // namespace

// boxes (B, N, 4) float32 sorted by score, scores (B, N) float32 in that
// order, order (B, N) int64; keep (B, max_det) int64 and valid (B, max_det)
// bool out. Returns the launch's CUDA error (0 on success).
extern "C" int nms(const float* boxes, const float* scores, const int64_t* order, int B, int N,
                   float iou_threshold, int max_det, int64_t* keep, unsigned char* valid,
                   void* stream) {
    if (B <= 0 || N <= 0 || max_det <= 0 || (uintptr_t)boxes % 16 != 0) {
        return (int)cudaErrorInvalidValue;
    }
    const size_t shared = (size_t)((N + 63) / 64) * sizeof(unsigned long long);
    nms_kernel<<<B, THREADS, shared, (cudaStream_t)stream>>>(
        reinterpret_cast<const float4*>(boxes), scores, order, N, iou_threshold, max_det, keep,
        valid);
    return (int)cudaGetLastError();
}
