// Greedy non-maximum suppression for a batch of score-sorted candidate sets,
// and the detector's post-processing from its top-K candidates (sm_90a).
//
// Replaces no Pallas kernel: it ports the reference's device loop
// geotrax_tpu/ops/nms.py:nms, a lax.while_loop (:81) that iterates the
// fixed point of greedy NMS on the accelerator and tests convergence there,
// and the gathers around it in postprocess_detections (:98-146). One launch
// runs every image of the batch on the card, with no host read.
//
// What it computes (ops/nms.py: nms_torch and postprocess_topk_torch, the
// plain versions, which are bit-equal to the reference). Per image, the N
// candidates come sorted by score (descending, stable); a candidate is alive
// where its score is > 0. Greedy NMS
//
//   keep_i = alive_i and no j < i with keep_j and iou(j, i) > t
//
// is the unique fixed point the reference iterates to, so one sweep in
// score order gives it. Each IoU is rounded as ops/boxes.py:iou_matrix's
// float32 tensor operations round it, one operation at a time:
// maximum/minimum (NaN propagating), rb - lt, the clamp at 0, w * h, each
// area (x2 - x1) * (y2 - y1) clamped, area_a + area_b, - inter, + 1e-9f, the
// division; __fsub_rn / __fadd_rn / __fmul_rn / __fdiv_rn, so nvcc
// contracts nothing into a fused multiply-add. The comparison is iou > t in
// float32. Two entries:
//  * nms: boxes already in corner form with any per-class offset added, and
//    ``order`` (the sort's permutation); writes ``order`` at the first
//    max_det kept positions (index 0 after them) and valid = slot < kept.
//  * nms_topk: the detector's anchors (xywh boxes, int32 classes) and the
//    top-K (scores, anchor indices) of exact_top_k, whose order is the
//    stable descending sort's, so no sort is needed. The kernel gathers each
//    candidate's box and class, forms its corners as xywh_to_xyxy rounds
//    them (cx - w / 2, ...: a division by 2), and where ``agnostic`` is 0
//    adds the per-class offset of sorted_candidates: span = (max - min) + 1
//    over the image's K corner boxes (NaN propagating, as amax / amin),
//    box + cls * span. It writes the detections: xywh boxes, scores, int32
//    classes (-1 when empty) and valid, for the max_det slots.
//
// Bound. The work depends on the data. Bytes: the candidates' boxes and
// scores (and order, or indices, classes) read once, the outputs written
// once. Operations: an IoU (14 float operations) for each pair of kept
// candidates and for each suppressed one, and an area (5) for each needed
// one, over the card's float32 rate. Both are far below what the kernel
// takes: greedy NMS is a chain of dependent tiles, so latency bounds it.
//
// Design: one thread-block cluster of ``cluster`` blocks (1024 threads
// each; up to 16, non-portable) per image, with the image held on chip. The
// candidates are cut into tiles of 64; tile t belongs to block t % cluster,
// which keeps the boxes and areas of its tiles in its shared memory (loaded
// once: 20 B a candidate, 40 KB for K = 2000 over the cluster), an alive
// bit and a suppression bit for each. The tiles are resolved in order, one
// cluster barrier each (barrier.cluster arrive / wait, split). In tile t:
//   (a) the owner computes, one warp a row, the words of tile t-1's kept
//       rows over the tile's rows (two ballots a row: bit c says the row
//       suppresses row c); the tile's own in-tile words (each open row's
//       suppressions of the later rows of the tile) were made before;
//   (b) one warp resolves the tile in score order from those words, by
//       rounds: an open row that no open row before it suppresses is kept,
//       and the rows the kept ones suppress close (warp-wide ORs, as many
//       rounds as the tile's deepest chain of suppressions);
//   (c) the owner writes the kept rows' boxes and areas, their number and
//       the running count into every block's mailbox for tile t through
//       distributed shared memory (map_shared_rank), and arrives;
//   (d) between arrive and wait, off the chain's critical path: the owner
//       of tile t+1 makes that tile's in-tile words, and every block tests
//       its later alive, unsuppressed candidates against tile t-1's kept
//       rows from its own mailbox (a warp a word of 32 candidates, stopping
//       at the first overlap; where the words are fewer than the warps,
//       each warp takes a share of the kept rows), setting their bits;
//   (e) every block waits (and syncs its threads, whose step (d) may still
//       run), reads the count, and stops once max_det are kept.
// Three mailboxes rotate: the owner of tile t writes mailbox t % 3 after
// every block has arrived at tile t-1's barrier, which each block does only
// after its step (d) of tile t-2 finished reading mailbox (t-3) % 3. The
// walk also stops after the last alive candidate. A resolved tile's words
// then hold its kept rows and their first rank, and after the walk every
// block writes the outputs of its tiles' kept rows. With nms_topk and
// agnostic 0, each block first reduces its candidates' corners, the blocks
// read each other's partial max / min after one cluster barrier, and every
// block adds the offset to its own boxes.
//
// The IoU test is exact but skips work: where neither box has a NaN
// coordinate (its area is not NaN) the maximum and minimum need no NaN
// test and a pair that does not intersect is settled at once, and an
// approximate quotient settles the comparison with t unless it lies within
// 1e-5 of t (see overlaps).
//
// The wrapper chooses the cluster size (ops/nms.py:cluster_size): the
// largest power of two up to 16, and up to the image's tiles, whose B
// clusters the card holds at once (nms_max_clusters; an H100 holds 7
// clusters of 16, 15 of 8, 30 of 4, 66 of 2), and whose blocks' shared
// memory holds the image.
//
// Registers, shared memory and spills (nvcc -Xptxas -v, printed by
// chip_smoke.py's build phase) and the times are in PERF.md.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 64;
constexpr int MAX_CLUSTER = 16;
constexpr int MAILBOXES = 3;
constexpr int MAX_DEVICES = 64;
// Dynamic shared memory per owned tile: 64 boxes (16 B), 64 areas (4 B), an
// alive word and a suppression word (8 B each).
constexpr int TILE_BYTES = TILE * 20 + 16;

// One tile's kept rows, as its owner sends them to every block.
struct Mailbox {
    float4 box[TILE];
    float area[TILE];
    int kept;   // rows kept in the tile
    int count;  // rows kept in this tile and every earlier one
};

// The operands of both entries (the other entry's are null).
struct Args {
    // nms: sorted corner boxes (B, N, 4), scores (B, N), order (B, N) in;
    // keep (B, max_det) int64 out
    const float4* boxes;
    const int64_t* order;
    int64_t* keep;
    // nms_topk: anchors' xywh boxes (B, A, 4) and int32 classes (B, A), the
    // top-K's anchor indices (B, N) in; xywh (B, max_det, 4), scores and
    // int32 classes (B, max_det) out
    const float4* xywh;
    const int* classes;
    const int64_t* idx;
    float4* out_boxes;
    float* out_scores;
    int* out_classes;
    long long xywh_stride, classes_stride, idx_stride;  // elements between images
    int agnostic;
    // both: scores (B, N) and valid (B, max_det)
    const float* scores;
    long long scores_stride;
    unsigned char* valid;
};

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

// iou_matrix(a, b) > t for the earlier box a and the later box b, from the
// intersection's width and height (each already clamped at 0) and the areas.
// Most pairs do not intersect: their IoU is 0 / (union + eps), which is 0 (or
// NaN where an area is NaN; the union is >= 0 otherwise, so the divisor is
// > 0), and the division is skipped. Where they do, the quotient rounded to
// nearest decides: an approximate one (__fdividef, at most 2 ulp off for
// operands in [1e-30, 1e30)) settles the comparison where it lies more than
// 1e-5 of t away from t, and the rounded division runs only near t or out of
// that range.
__device__ __forceinline__ bool iou_above(float w, float h, float area_a, float area_b, float t) {
    const float inter = __fmul_rn(w, h);
    const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
    if (inter == 0.0f) {
        return uni == uni && 0.0f > t;
    }
    const float d = __fadd_rn(uni, 1e-9f);
    if (t >= 1e-30f && inter >= 1e-30f && d >= 1e-30f && d < 1e30f) {
        const float q = __fdividef(inter, d);
        if (q > t * 1.00001f) return true;
        if (q < t * 0.99999f) return false;
    }
    return __fdiv_rn(inter, d) > t;
}

// iou_matrix(a, b) > t. A NaN coordinate makes its box's area NaN, so where
// neither area is NaN the maximum and minimum need no NaN test, and with
// t >= 0 a pair whose intersection is empty (a width or height <= 0, which
// clamps to 0: an IoU of 0, or NaN against an infinite side) is not over t.
__device__ __forceinline__ bool overlaps(float4 a, float area_a, float4 b, float area_b, float t) {
    if (t >= 0.0f && area_a == area_a && area_b == area_b) {
        const float w = __fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x));
        const float h = __fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y));
        if (!(w > 0.0f && h > 0.0f)) {
            return false;
        }
        return iou_above(w, h, area_a, area_b, t);
    }
    const float w = tmax(__fsub_rn(tmin(a.z, b.z), tmax(a.x, b.x)), 0.0f);
    const float h = tmax(__fsub_rn(tmin(a.w, b.w), tmax(a.y, b.y)), 0.0f);
    return iou_above(w, h, area_a, area_b, t);
}

// The OR of x over the warp.
__device__ __forceinline__ unsigned long long warp_or(unsigned long long x) {
    const unsigned int lo = __reduce_or_sync(0xffffffffu, (unsigned int)x);
    const unsigned int hi = __reduce_or_sync(0xffffffffu, (unsigned int)(x >> 32));
    return ((unsigned long long)hi << 32) | lo;
}

// One warp: the words of rows [first, end) of a tile (boxes tb, areas ta, the
// tile's ``rows`` rows) whose bits in ``need`` are set, one row at a time:
// bit c of row r's word says row r suppresses row c > r.
__device__ __forceinline__ void tile_words(const float4* tb, const float* ta, int rows,
                                           unsigned long long need, float t,
                                           unsigned long long* words, int first, int step) {
    const int lane = threadIdx.x & 31;
    for (int r = first; r < rows; r += step) {
        if (!((need >> r) & 1ull)) {
            continue;  // the same for the whole warp
        }
        const float4 a = tb[r];
        const float area_a = ta[r];
        const int c0 = lane, c1 = lane + 32;
        const bool b0 = c0 > r && c0 < rows && overlaps(a, area_a, tb[c0], ta[c0], t);
        const bool b1 = c1 > r && c1 < rows && overlaps(a, area_a, tb[c1], ta[c1], t);
        const unsigned int lo = __ballot_sync(0xffffffffu, b0);
        const unsigned int hi = __ballot_sync(0xffffffffu, b1);
        if (lane == 0) {
            words[r] = ((unsigned long long)hi << 32) | lo;
        }
    }
}

// ops/boxes.py:xywh_to_xyxy
__device__ __forceinline__ float4 corners(float4 b) {
    const float hw = __fdiv_rn(b.z, 2.0f), hh = __fdiv_rn(b.w, 2.0f);
    return make_float4(__fsub_rn(b.x, hw), __fsub_rn(b.y, hh), __fadd_rn(b.x, hw),
                       __fadd_rn(b.y, hh));
}

__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// The (max, min) of every thread's mx and mn over the block, NaN
// propagating; every thread gets it. ``red`` holds 2 * WARPS floats.
__device__ __forceinline__ float2 block_max_min(float mx, float mn, float* red) {
    for (int o = 16; o; o >>= 1) {
        mx = tmax(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        mn = tmin(mn, __shfl_xor_sync(0xffffffffu, mn, o));
    }
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) {
        red[warp] = mx;
        red[WARPS + warp] = mn;
    }
    __syncthreads();
    mx = red[0];
    mn = red[WARPS];
    for (int w = 1; w < WARPS; ++w) {
        mx = tmax(mx, red[w]);
        mn = tmin(mn, red[WARPS + w]);
    }
    return make_float2(mx, mn);
}

template <bool TOPK>
__global__ void __launch_bounds__(THREADS, 1)
nms_kernel(const Args a, int n, float t, int max_det) {
    extern __shared__ __align__(16) unsigned char dyn[];
    __shared__ Mailbox mail[MAILBOXES];
    __shared__ unsigned long long s_diag[TILE];   // open row r's suppressions in its tile
    __shared__ unsigned long long s_prior[TILE];  // tile t-1's kept row k's suppressions
    __shared__ unsigned long long s_kept;
    __shared__ float s_red[2 * WARPS];
    __shared__ float2 s_part;                     // this block's (max, min) of the corners
    __shared__ int s_last;

    cg::cluster_group cluster = cg::this_cluster();
    const int cs = (int)cluster.num_blocks();
    const int rank = (int)cluster.block_rank();
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const size_t img = blockIdx.x / cs;
    const int tiles = (n + TILE - 1) / TILE;
    const int nlt = (tiles + cs - 1) / cs;  // the block's tiles: rank, rank + cs, ...
    float4* box = reinterpret_cast<float4*>(dyn);
    float* area = reinterpret_cast<float*>(box + nlt * TILE);
    unsigned long long* alive = reinterpret_cast<unsigned long long*>(area + nlt * TILE);
    unsigned long long* removed = alive + nlt;
    unsigned int* alive32 = reinterpret_cast<unsigned int*>(alive);
    unsigned int* removed32 = reinterpret_cast<unsigned int*>(removed);
    const float* sc = a.scores + img * a.scores_stride;

    if (tid == 0) {
        s_last = -1;
    }
    // the block's candidates into shared memory; with a per-class offset to
    // come, ``area`` holds the class until the span is known
    const bool offset = TOPK && !a.agnostic;
    float mx = __int_as_float((int)0xff800000u), mn = __int_as_float(0x7f800000);
    for (int i = tid; i < nlt * TILE; i += THREADS) {
        const int j = ((i / TILE) * cs + rank) * TILE + i % TILE;
        float4 b = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        float ar = 0.0f;
        bool live = false;
        if (j < n) {
            if (TOPK) {
                const long long k = a.idx[img * a.idx_stride + j];
                b = corners(a.xywh[(img * a.xywh_stride >> 2) + k]);
                if (offset) {
                    ar = __int2float_rn(a.classes[img * a.classes_stride + k]);
                    mx = tmax(mx, tmax(tmax(b.x, b.y), tmax(b.z, b.w)));
                    mn = tmin(mn, tmin(tmin(b.x, b.y), tmin(b.z, b.w)));
                }
            } else {
                b = a.boxes[img * n + j];
            }
            if (!offset) {
                ar = box_area(b);
            }
            live = sc[j] > 0.0f;
        }
        box[i] = b;
        area[i] = ar;
        const unsigned int bits = __ballot_sync(0xffffffffu, live);
        if (lane == 0) {
            alive32[i / 32] = bits;
            removed32[i / 32] = 0u;
        }
    }
    if (offset) {
        const float2 part = block_max_min(mx, mn, s_red);
        if (tid == 0) {
            s_part = part;
        }
    }
    __syncthreads();  // s_last set
    int last = -1;  // the last alive position, from every score of the image
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
    // every block of the cluster running, and its partial written, before
    // any access to another block's shared memory
    cluster_arrive();
    cluster_wait();
    last = s_last;
    const int last_tile = last < 0 ? -1 : last / TILE;
    if (offset) {
        // the image's span from every block's partial, in rank order
        float2 all = *cluster.map_shared_rank(&s_part, 0);
        for (int r = 1; r < cs; ++r) {
            const float2 p = *cluster.map_shared_rank(&s_part, r);
            all.x = tmax(all.x, p.x);
            all.y = tmin(all.y, p.y);
        }
        const float span = __fadd_rn(__fsub_rn(all.x, all.y), 1.0f);
        for (int i = tid; i < nlt * TILE; i += THREADS) {
            const float o = __fmul_rn(area[i], span);
            float4 b = box[i];
            b = make_float4(__fadd_rn(b.x, o), __fadd_rn(b.y, o), __fadd_rn(b.z, o),
                            __fadd_rn(b.w, o));
            box[i] = b;
            area[i] = box_area(b);
        }
        if (last_tile < 0) {
            // no tile barrier follows: no block leaves while another may
            // still read its partial
            cluster_arrive();
            cluster_wait();
        }
    }
    __syncthreads();

    // the block's tiles up to the last alive candidate's: local tiles [0, lt_end)
    const int lt_end = last_tile < rank ? 0 : (last_tile - rank) / cs + 1;
    // tile 0's in-tile words, by its owner
    if (rank == 0 && last_tile >= 0) {
        tile_words(box, area, min(TILE, n), alive[0], t, s_diag, warp, WARPS);
    }
    __syncthreads();
    int count = 0, done = -1;  // kept so far; the last tile resolved
    for (int tile = 0; tile <= last_tile; ++tile) {
        const int slot = tile % MAILBOXES;
        const Mailbox& prev = mail[(tile + MAILBOXES - 1) % MAILBOXES];
        const int pk = tile > 0 ? prev.kept : 0;  // tile t-1's kept rows
        const bool own = tile % cs == rank;
        unsigned long long kept = 0ull;
        if (own) {
            const int lt = tile / cs;
            const int rows = min(TILE, n - tile * TILE);
            const float4* tb = box + lt * TILE;
            const float* ta = area + lt * TILE;
            // (a) tile t-1's kept rows' words over the tile, one warp a row
            // (the tile's own words were made before this tile's barrier)
            for (int k = warp; k < pk; k += WARPS) {
                const float4 a = prev.box[k];
                const float area_a = prev.area[k];
                const bool b0 = lane < rows && overlaps(a, area_a, tb[lane], ta[lane], t);
                const bool b1 = lane + 32 < rows
                                && overlaps(a, area_a, tb[lane + 32], ta[lane + 32], t);
                const unsigned int lo = __ballot_sync(0xffffffffu, b0);
                const unsigned int hi = __ballot_sync(0xffffffffu, b1);
                if (lane == 0) {
                    s_prior[k] = ((unsigned long long)hi << 32) | lo;
                }
            }
            __syncthreads();
            // (b) the tile in score order, by rounds: an open row that no
            // open row before it suppresses is kept, and the rows the kept
            // ones suppress close; as many rounds as the tile's deepest
            // chain of suppressions
            if (warp == 0) {
                unsigned long long hit = 0ull;
                for (int k = lane; k < pk; k += 32) {
                    hit |= s_prior[k];
                }
                unsigned long long cand = alive[lt] & ~removed[lt] & ~warp_or(hit), got = 0ull;
                const unsigned long long d0 = s_diag[lane], d1 = s_diag[lane + 32];
                while (cand) {
                    const unsigned long long free =
                        cand & ~warp_or(((cand >> lane) & 1ull ? d0 : 0ull)
                                        | ((cand >> (lane + 32)) & 1ull ? d1 : 0ull));
                    got |= free;
                    cand &= ~free & ~warp_or(((free >> lane) & 1ull ? d0 : 0ull)
                                             | ((free >> (lane + 32)) & 1ull ? d1 : 0ull));
                }
                if (lane == 0) {
                    s_kept = got;
                }
            }
            __syncthreads();
            kept = s_kept;
            // (c) the kept rows to every block's mailbox
            if (tid < TILE * cs) {
                const int r = tid % TILE, d = tid / TILE;
                Mailbox* m = cluster.map_shared_rank(&mail[slot], d);
                if ((kept >> r) & 1ull) {
                    const int k = __popcll(kept & ((1ull << r) - 1ull));
                    m->box[k] = tb[r];
                    m->area[k] = ta[r];
                }
                if (r == 0) {
                    m->kept = __popcll(kept);
                    m->count = count + __popcll(kept);
                }
            }
            // the resolved tile's bits are not read again: its words keep
            // the kept rows and their first rank for the outputs
            if (tid == 0) {
                alive[lt] = kept;
                removed[lt] = (unsigned long long)count;
            }
        }
        cluster_arrive();
        // (d) off the critical path: the next tile's in-tile words by its
        // owner (for every row still open; tile t-1's kept rows may close
        // some below, which only leaves their words unused)
        if (tile + 1 <= last_tile && (tile + 1) % cs == rank) {
            const int lt = (tile + 1) / cs;
            tile_words(box + lt * TILE, area + lt * TILE, min(TILE, n - (tile + 1) * TILE),
                       alive[lt] & ~removed[lt], t, s_diag, warp, WARPS);
        }
        // (d) the block's later candidates against tile t-1's kept rows: a
        // warp takes a 32-candidate word of bits and, where the words are
        // fewer than the warps, a share of the kept rows
        const int first = 2 * (tile + 1 <= rank ? 0 : (tile + 1 - rank + cs - 1) / cs);
        const int words = 2 * lt_end - first;
        if (pk > 0 && words > 0) {
            const int span = min(words, WARPS), shares = WARPS / span;
            if (warp < span * shares) {
                for (int h = first + warp % span; h < first + words; h += span) {
                    const unsigned int open = alive32[h] & ~removed32[h];
                    if (!open) {
                        continue;
                    }
                    bool hit = false;
                    if ((open >> lane) & 1u) {
                        const float4 b = box[h * 32 + lane];
                        const float area_b = area[h * 32 + lane];
                        for (int k = warp / span; k < pk; k += shares) {
                            if (overlaps(prev.box[k], prev.area[k], b, area_b, t)) {
                                hit = true;
                                break;
                            }
                        }
                    }
                    const unsigned int m = __ballot_sync(0xffffffffu, hit);
                    if (lane == 0 && m) {
                        atomicOr(&removed32[h], m);
                    }
                }
            }
        }
        // (e) the block's threads done with step (d) too, before the block
        // resolves its next tile or reads its bits again
        cluster_wait();
        __syncthreads();
        count = mail[slot].count;
        done = tile;
        if (count >= max_det) {
            break;  // every slot holds a kept candidate
        }
    }
    // the kept rows' outputs, each block its resolved tiles'
    for (int i = tid; i < nlt * TILE; i += THREADS) {
        const int lt = i / TILE, r = i % TILE, tile = lt * cs + rank;
        const unsigned long long kept = alive[lt];
        if (tile > done || !((kept >> r) & 1ull)) {
            continue;
        }
        const int k = (int)removed[lt] + __popcll(kept & ((1ull << r) - 1ull));
        if (k < max_det) {
            const int j = tile * TILE + r;
            const size_t o = img * (size_t)max_det + k;
            if (TOPK) {
                const long long src = a.idx[img * a.idx_stride + j];
                a.out_boxes[o] = a.xywh[(img * a.xywh_stride >> 2) + src];
                a.out_scores[o] = sc[j];
                a.out_classes[o] = a.classes[img * a.classes_stride + src];
            } else {
                a.keep[o] = a.order[img * n + j];
            }
        }
    }
    // the slots past the kept candidates, spread over the cluster
    for (int k = rank * THREADS + tid; k < max_det; k += cs * THREADS) {
        const size_t o = img * (size_t)max_det + k;
        if (k >= count) {
            if (TOPK) {
                a.out_boxes[o] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
                a.out_scores[o] = 0.0f;
                a.out_classes[o] = -1;
            } else {
                a.keep[o] = 0;
            }
        }
        a.valid[o] = k < count ? 1 : 0;
    }
}

int shared_limits[MAX_DEVICES] = {};

// Lets both kernels take non-portable clusters and the most dynamic shared
// memory the device allows; returns that many bytes (-1 on an error).
int prepare(int device) {
    if (device < 0 || device >= MAX_DEVICES) return -1;
    if (shared_limits[device] > 0) return shared_limits[device];
    int optin = 0;
    if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)
        != cudaSuccess)
        return -1;
    const void* kernels[2] = {reinterpret_cast<const void*>(nms_kernel<false>),
                              reinterpret_cast<const void*>(nms_kernel<true>)};
    int limit = optin;
    for (const void* f : kernels) {
        cudaFuncAttributes attr;
        if (cudaFuncGetAttributes(&attr, f) != cudaSuccess) return -1;
        const int left = optin - (int)attr.sharedSizeBytes;
        limit = left < limit ? left : limit;
    }
    for (const void* f : kernels) {
        if (cudaFuncSetAttribute(f, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)
                != cudaSuccess
            || cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize, limit)
                   != cudaSuccess)
            return -1;
    }
    shared_limits[device] = limit;
    return limit;
}

int launch(bool topk, const Args& a, int b, int n, float t, int max_det, int cluster,
           cudaStream_t stream) {
    if (b <= 0 || n <= 0 || max_det <= 0 || cluster < 1 || cluster > MAX_CLUSTER
        || (long long)b * cluster > 0x7fffffffll)
        return (int)cudaErrorInvalidValue;
    int device = 0;
    cudaGetDevice(&device);
    const int limit = prepare(device);
    if (limit < 0) return (int)cudaErrorInvalidDevice;
    const long long tiles = (n + TILE - 1) / TILE;
    const long long shared = (tiles + cluster - 1) / cluster * TILE_BYTES;
    if (shared > limit) return (int)cudaErrorInvalidValue;
    cudaLaunchConfig_t config = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    config.gridDim = dim3((unsigned int)(b * cluster), 1, 1);
    config.blockDim = dim3(THREADS, 1, 1);
    config.dynamicSmemBytes = (size_t)shared;
    config.stream = stream;
    config.attrs = attr;
    config.numAttrs = 1;
    const cudaError_t err = topk ? cudaLaunchKernelEx(&config, nms_kernel<true>, a, n, t, max_det)
                                 : cudaLaunchKernelEx(&config, nms_kernel<false>, a, n, t, max_det);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The dynamic shared memory one block may take on ``device`` (the current
// one), after allowing it to both kernels; -1 on an error.
int nms_shared_limit(int device) {
    int current = 0;
    cudaGetDevice(&current);
    if (current != device) return -1;
    return prepare(device);
}

// How many clusters of ``cluster`` blocks, each with ``shared`` bytes of
// dynamic shared memory, the current device holds at once; 0 when such a
// cluster cannot be launched, negative on a CUDA error.
int nms_max_clusters(int cluster, int shared) {
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
    config.blockDim = dim3(THREADS, 1, 1);
    config.dynamicSmemBytes = shared;
    config.attrs = attr;
    config.numAttrs = 1;
    int count = 0;
    const cudaError_t err = cudaOccupancyMaxActiveClusters(
        &count, reinterpret_cast<const void*>(nms_kernel<false>), &config);
    if (err != cudaSuccess) {
        cudaGetLastError();
        return err == cudaErrorInvalidClusterSize ? 0 : -(int)err;
    }
    return count;
}

// boxes (B, N, 4) float32 sorted by score, scores (B, N) float32 in that
// order, order (B, N) int64, all contiguous; keep (B, max_det) int64 and
// valid (B, max_det) bool out; ``cluster`` blocks an image. Returns the
// launch's CUDA error (0 on success).
int nms(const float* boxes, const float* scores, const int64_t* order, int B, int N,
        float iou_threshold, int max_det, int cluster, int64_t* keep, unsigned char* valid,
        void* stream) {
    if ((uintptr_t)boxes % 16 != 0) return (int)cudaErrorInvalidValue;
    Args a = {};
    a.boxes = reinterpret_cast<const float4*>(boxes);
    a.order = order;
    a.keep = keep;
    a.scores = scores;
    a.scores_stride = N;
    a.valid = valid;
    return launch(false, a, B, N, iou_threshold, max_det, cluster, (cudaStream_t)stream);
}

// The detector's post-processing after its top-K: xywh (B, A, 4) float32
// and classes (B, A) int32 per anchor, scores (B, K) float32 in exact_top_k's
// order (no NaN) and idx (B, K) int64 anchor indices, each image's rows
// ``*_stride`` elements apart (the last dimension contiguous; xywh's stride
// a multiple of 4 and its base 16-byte aligned); out_boxes (B, max_det, 4),
// out_scores (B, max_det) float32, out_classes (B, max_det) int32 and valid
// (B, max_det) bool out, contiguous. ``agnostic`` 0 adds the per-class
// offset. Returns the launch's CUDA error (0 on success).
int nms_topk(const float* xywh, long long xywh_stride, const int* classes,
             long long classes_stride, const float* scores, long long scores_stride,
             const int64_t* idx, long long idx_stride, int B, int K, float iou_threshold,
             int max_det, int agnostic, int cluster, float* out_boxes, float* out_scores,
             int* out_classes, unsigned char* valid, void* stream) {
    if ((uintptr_t)xywh % 16 != 0 || xywh_stride % 4 != 0 || (uintptr_t)out_boxes % 16 != 0)
        return (int)cudaErrorInvalidValue;
    Args a = {};
    a.xywh = reinterpret_cast<const float4*>(xywh);
    a.xywh_stride = xywh_stride;
    a.classes = classes;
    a.classes_stride = classes_stride;
    a.idx = idx;
    a.idx_stride = idx_stride;
    a.out_boxes = reinterpret_cast<float4*>(out_boxes);
    a.out_scores = out_scores;
    a.out_classes = out_classes;
    a.agnostic = agnostic;
    a.scores = scores;
    a.scores_stride = scores_stride;
    a.valid = valid;
    return launch(true, a, B, K, iou_threshold, max_det, cluster, (cudaStream_t)stream);
}

}  // extern "C"
