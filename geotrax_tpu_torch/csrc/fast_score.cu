// FAST-9/16 corner score map for a batch of float32 gray images (sm_90a).
//
// Replaces geotrax_tpu/ops/pallas_fast.py:_make_kernel (the Pallas TPU
// kernel behind fast_score_map) and its XLA twin
// geotrax_tpu/ops/features.py:fast_score_map_xla, which the JAX fused path
// runs. For each pixel, the 16 samples of the radius-3 Bresenham ring
// (CIRCLE, clockwise from 12 o'clock) are compared with c + t and c - t;
// the pixel is a corner when 9 or more contiguous samples are all brighter
// or all darker, and its score is then sum |ring - c| (0 elsewhere).
// Pixels outside the image read 0, like the reference's zero padding.
//
// Bound. The function reads each input pixel once and writes each output
// pixel once: per 1080x1920 frame 8.3 MB in and 8.3 MB out, about 5 us at
// the H100's 3.35 TB/s, or 0.16 ms for a 32-frame chunk. Its ~80 float
// operations per pixel take less than that at 67 TFLOP/s, so it is bound by
// memory. The fused extract path launches it once per chunk, plus once for
// the reference frame on the first chunk.
//
// The first design (one pixel per thread in 32x16 tiles) spent ~130
// instructions on every pixel, corner or not, and reached 16 % of the
// bound. This one cuts the work of the pixels that cannot be corners:
//
//  * Exact early rejection (phase 1). Any run of 9 contiguous ring samples
//    covers two cyclically adjacent samples of {0, 4, 8, 12}, so a pixel
//    can be a bright corner only if (s0 | s8) & (s4 | s12) are brighter
//    than c + t, and a dark one only if the same holds for darker than
//    c - t. Every pixel is tested, 4 per thread along x: the centre row
//    and the rows 3 above and below come from shared memory as float4
//    vectors, the test is branch-free predicate logic, and the 4 outputs
//    are written 0 with one 16-byte streaming store. A pixel that passes is
//    appended to the tile's list (a warp-wide prefix sum of the counts, one
//    shared atomic per warp).
//  * Dense full test (phase 2). One list entry per thread, so the
//    candidates run without idle lanes however they are scattered: the 16
//    samples, the two masks from the sign bits of hi - s and s - lo (exact:
//    a difference rounded to nearest keeps its sign and is 0 only for equal
//    operands) gathered by funnel shifts, and the score. A corner's score
//    overwrites its 0 (the block barrier orders the two stores).
//  * Column strips. A block owns 128 columns and two 32-row tiles down
//    them (~15 waves of blocks over 132 SMs at 1080x1920x32). Each tile is
//    staged with its 3-row and 4-column halo (4 keeps 16-byte alignment) by
//    cp.async 16-byte copies, zero-filled outside the image, one warp per
//    row; the second tile's copies run while the block works on the first.
//    Halo columns add 8/128 to the reads, halo rows 6/32, mostly from L2.
//  * A width that is not a multiple of 4 (or a pointer not 16-byte aligned)
//    takes the same kernel with 4-byte copies and scalar stores.
//
// Exactness: c + t and c - t by __fadd_rn / __fsub_rn, the score summed in
// CIRCLE order from 0 with __fadd_rn (no fused multiply-add), so the map
// equals fast_score_map_torch bit for bit. A rejected pixel keeps its 0,
// which is what the full test gives it.
//
// Registers, shared memory and spills (nvcc -Xptxas -v, printed by
// chip_smoke.py's build phase) and the times are in PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TW = 128;                        // output columns per tile
constexpr int TH = 32;                         // output rows per tile
constexpr int RADIUS = 3;
constexpr int PAD = 4;                         // halo columns, 16-byte aligned
constexpr int SW = TW + 2 * PAD;               // staged row: 136 floats
constexpr int SH = TH + 2 * RADIUS;            // staged rows: 38
constexpr int THREADS = 256;
constexpr int GROUPS = TW / 4;                 // float4 groups per output row
constexpr int ROWS_PER_PASS = THREADS / GROUPS;
constexpr int PASSES = TH / ROWS_PER_PASS;
constexpr int STRIP_TILES = 2;                 // tiles per block (at most)
constexpr int IN_FLOATS = SH * SW;
constexpr size_t SMEM_BYTES = 2 * IN_FLOATS * sizeof(float) + TH * TW * sizeof(uint16_t);

static_assert(PASSES * 4 <= 32, "phase 1 keeps a thread's candidates in one 32-bit mask");
static_assert(TW == 128 && TH <= 32, "list entries pack (row << 7) | column into 16 bits");

// (dx, dy) of the ring, clockwise from 12 o'clock (pallas_fast.CIRCLE)
__device__ __forceinline__ constexpr int ring_dx(int k) {
    constexpr int d[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
    return d[k];
}

__device__ __forceinline__ constexpr int ring_dy(int k) {
    constexpr int d[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
    return d[k];
}

__device__ __forceinline__ bool has_run9(uint32_t bits) {
    uint32_t dbl = bits | (bits << 16);
    uint32_t r = dbl & (dbl >> 1);
    r = r & (r >> 2);
    r = r & (r >> 4);
    r = r & (dbl >> 8);
    return (r & 0xFFFFu) != 0u;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool inside) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    const int n = inside ? 16 : 0;  // 0 bytes read: the 16 are zero-filled
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool inside) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    const int n = inside ? 4 : 0;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_prev() {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Stage the input rows y0-3 .. y0+TH+2 and columns x0-4 .. x0+TW+3 of one
// image into `buf`, zeros outside it.
//  VEC (W % 4 == 0, 16-byte aligned planes, so each float4 lies wholly
//  inside or outside the image): warp w copies rows w, w+8, ...; lane l the
//  float4 of columns x0+4l .. x0+4l+3, lanes 0 and 1 also the left and
//  right halo float4 of the row.
//  Otherwise 4-byte copies, one element per thread and step.
template <bool VEC>
__device__ __forceinline__ void stage_tile(float* buf, const float* img, int H, int W, int x0,
                                           int y0) {
    if (VEC) {
        const int lane = threadIdx.x & 31;
        const int warp = threadIdx.x >> 5;
        const int gx = x0 + 4 * lane;
        const bool col_in = gx < W;
        const int hx = lane == 0 ? x0 - PAD : x0 + TW;  // this lane's halo column
        const bool halo = lane < 2;
        const bool halo_in = halo && hx >= 0 && hx < W;
        for (int r = warp; r < SH; r += THREADS / 32) {
            const int gy = y0 - RADIUS + r;
            const bool row_in = gy >= 0 && gy < H;
            const float* src = img + (size_t)(row_in ? gy : 0) * W;
            float* row = buf + r * SW;
            cp_async16(row + PAD + 4 * lane, row_in && col_in ? src + gx : img, row_in && col_in);
            if (halo) {
                cp_async16(row + (lane == 0 ? 0 : PAD + TW), row_in && halo_in ? src + hx : img,
                           row_in && halo_in);
            }
        }
    } else {
        for (int i = threadIdx.x; i < SH * SW; i += THREADS) {
            const int r = i / SW;
            const int q = i - r * SW;
            const int gy = y0 - RADIUS + r;
            const int gx = x0 - PAD + q;
            const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
            cp_async4(buf + i, inside ? img + (size_t)gy * W + gx : img, inside);
        }
    }
}

__device__ __forceinline__ float4 ld4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS, 4)
fast_score_kernel(const float* __restrict__ gray, float* __restrict__ out, int H, int W,
                  float thr, int tiles_y, int tiles_per_block) {
    extern __shared__ __align__(16) unsigned char smem[];
    float* in_buf = reinterpret_cast<float*>(smem);                      // 2 x [SH][SW]
    uint16_t* list = reinterpret_cast<uint16_t*>(in_buf + 2 * IN_FLOATS);  // [TH * TW]
    __shared__ int n_list;

    const size_t plane = (size_t)H * (size_t)W;
    const float* img = gray + (size_t)blockIdx.z * plane;
    const int x0 = blockIdx.x * TW;
    const int tile0 = blockIdx.y * tiles_per_block;
    const int n_tiles = min(tiles_per_block, tiles_y - tile0);
    const int lane = threadIdx.x & 31;
    const int gx = threadIdx.x % GROUPS;       // this thread's float4 group in phase 1
    const int ry = threadIdx.x / GROUPS;       // and its first row
    const int cols = W - x0;                   // columns of this strip inside the image
    if (threadIdx.x == 0) {
        n_list = 0;
    }
    if (n_tiles <= 0) {
        return;
    }

    stage_tile<VEC>(in_buf, img, H, W, x0, tile0 * TH);
    cp_async_commit();
    for (int t = 0; t < n_tiles; ++t) {
        const int y0 = (tile0 + t) * TH;
        const int rows = H - y0;               // rows of this tile inside the image
        float* dst = out + (size_t)blockIdx.z * plane + (size_t)y0 * W + x0;
        const float* tin = in_buf + (t & 1) * IN_FLOATS;
        if (t + 1 < n_tiles) {
            stage_tile<VEC>(in_buf + ((t + 1) & 1) * IN_FLOATS, img, H, W, x0, y0 + TH);
        }
        cp_async_commit();
        cp_async_wait_prev();  // this tile's copies have landed (the next may be in flight)
        __syncthreads();

        // Phase 1: the exact cardinal test for every pixel, 4 per thread;
        // every pixel's output is written 0 here (a corner's is overwritten
        // in phase 2, after the barrier).
        uint32_t cand = 0u;
#pragma unroll
        for (int j = 0; j < PASSES; ++j) {
            const int r = ry + j * ROWS_PER_PASS;
            const float* crow = tin + (r + RADIUS) * SW + 4 * gx;
            const float4 a = ld4(crow);
            const float4 b = ld4(crow + 4);
            const float4 c = ld4(crow + 8);
            const float4 up = ld4(crow - RADIUS * SW + PAD);
            const float4 dn = ld4(crow + RADIUS * SW + PAD);
            const float row[12] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, c.y, c.z, c.w};
            const float top[4] = {up.x, up.y, up.z, up.w};
            const float bot[4] = {dn.x, dn.y, dn.z, dn.w};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float v = row[PAD + i];
                const float hi = __fadd_rn(v, thr);
                const float lo = __fsub_rn(v, thr);
                const float s0 = top[i], s4 = row[PAD + i + 3], s8 = bot[i], s12 = row[PAD + i - 3];
                const bool bright = ((s0 > hi) | (s8 > hi)) & ((s4 > hi) | (s12 > hi));
                const bool dark = ((s0 < lo) | (s8 < lo)) & ((s4 < lo) | (s12 < lo));
                cand |= (uint32_t)(bright | dark) << (4 * j + i);
            }
            if (r < rows) {
                float* o = dst + (size_t)r * W + 4 * gx;
                if (VEC) {
                    if (4 * gx < cols) {
                        __stcs(reinterpret_cast<float4*>(o), make_float4(0.f, 0.f, 0.f, 0.f));
                    }
                } else {
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                        if (4 * gx + i < cols) {
                            __stcs(o + i, 0.0f);
                        }
                    }
                }
            }
        }
        // append this thread's candidates: one slot range per warp
        const int n = __popc(cand);
        int incl = n;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int v = __shfl_up_sync(0xFFFFFFFFu, incl, o);
            if (lane >= o) {
                incl += v;
            }
        }
        int base = 0;
        if (lane == 31) {
            base = atomicAdd(&n_list, incl);
        }
        int pos = __shfl_sync(0xFFFFFFFFu, base, 31) + incl - n;
        while (cand) {
            const int bit = __ffs(cand) - 1;
            cand &= cand - 1u;
            const int r = ry + (bit >> 2) * ROWS_PER_PASS;
            list[pos++] = (uint16_t)((r << 7) | (4 * gx + (bit & 3)));
        }
        __syncthreads();

        // Phase 2: the full test and score for each candidate, densely.
        const int count = n_list;
        for (int e = threadIdx.x; e < count; e += THREADS) {
            const int entry = list[e];
            const int r = entry >> 7;
            const int x = entry & (TW - 1);
            const float* p = tin + (r + RADIUS) * SW + x + PAD;
            const float v = p[0];
            const float hi = __fadd_rn(v, thr);
            const float lo = __fsub_rn(v, thr);
            uint32_t bright = 0u, dark = 0u;
            float score = 0.0f;
#pragma unroll
            for (int k = 0; k < 16; ++k) {
                const float s = p[ring_dy(k) * SW + ring_dx(k)];
                // the sign of hi - s is (s > hi), of s - lo is (s < lo), exactly
                bright = __funnelshift_l(__float_as_uint(__fsub_rn(hi, s)), bright, 1);
                dark = __funnelshift_l(__float_as_uint(__fsub_rn(s, lo)), dark, 1);
                score = __fadd_rn(score, fabsf(__fsub_rn(s, v)));
            }
            if ((has_run9(bright) | has_run9(dark)) && r < rows && x < cols) {
                dst[(size_t)r * W + x] = score;
            }
        }
        __syncthreads();
        if (threadIdx.x == 0) {
            n_list = 0;  // read by every thread above; the next append follows a barrier
        }
    }
}

template <bool VEC>
int launch(const float* gray, float* out, int B, int H, int W, float thr, cudaStream_t stream) {
    static cudaError_t configured = cudaFuncSetAttribute(
        fast_score_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
    if (configured != cudaSuccess) {
        return (int)configured;
    }
    const int tiles_y = (H + TH - 1) / TH;
    const int strips = (tiles_y + STRIP_TILES - 1) / STRIP_TILES;
    const int tiles_per_block = (tiles_y + strips - 1) / strips;
    const dim3 grid((W + TW - 1) / TW, (tiles_y + tiles_per_block - 1) / tiles_per_block, B);
    fast_score_kernel<VEC><<<grid, THREADS, SMEM_BYTES, stream>>>(gray, out, H, W, thr, tiles_y,
                                                                  tiles_per_block);
    return (int)cudaGetLastError();
}

}  // namespace

// Scores B images of H x W float32 (contiguous, B*H*W) into `out` (same
// layout) on `stream`. Returns the cudaError_t of the launch (0 on success).
extern "C" int fast_score(const float* gray, float* out, int B, int H, int W, float thr,
                          void* stream) {
    if (B <= 0 || H <= 0 || W <= 0) {
        return (int)cudaErrorInvalidValue;
    }
    const bool vec = W % 4 == 0 && (uintptr_t)gray % 16 == 0 && (uintptr_t)out % 16 == 0;
    return vec ? launch<true>(gray, out, B, H, W, thr, (cudaStream_t)stream)
               : launch<false>(gray, out, B, H, W, thr, (cudaStream_t)stream);
}
