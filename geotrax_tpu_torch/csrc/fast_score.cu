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
// Design. One thread block scores a TILE_H x TILE_W tile of one image:
// it stages the tile and a 3-pixel halo in shared memory (zeros outside the
// image), so each input pixel is read from device memory about once, and
// each thread then reads its 16 ring samples from shared memory. The two
// 16-bit masks (brighter, darker) are tested for a run of 9 on the doubled
// mask (b | b << 16), as the XLA twin does. The score adds fabsf(r - c) in
// CIRCLE order in float32 with no fused multiply-add, so it equals the
// twin's sequential sum bit for bit. The grid's z dimension covers the
// batch, so one launch scores every frame of a chunk.
//
// Bound. The function reads each input pixel once and writes each output
// pixel once: per 1080x1920 frame 8.3 MB in and 8.3 MB out, about 5 us at
// the H100's 3.35 TB/s, or 0.16 ms for a 32-frame chunk. Its ~80 float
// operations per pixel take less than that at 67 TFLOP/s, so it is bound by
// memory. The fused extract path launches it once per chunk, plus once for
// the reference frame on the first chunk.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_W = 32;
constexpr int TILE_H = 16;
constexpr int RADIUS = 3;
constexpr int SM_W = TILE_W + 2 * RADIUS;
constexpr int SM_H = TILE_H + 2 * RADIUS;

// (dx, dy) of the ring, clockwise from 12 o'clock (pallas_fast.CIRCLE)
__constant__ int8_t kCircle[16][2] = {
    {0, -3}, {1, -3}, {2, -2}, {3, -1}, {3, 0}, {3, 1}, {2, 2}, {1, 3},
    {0, 3}, {-1, 3}, {-2, 2}, {-3, 1}, {-3, 0}, {-3, -1}, {-2, -2}, {-1, -3},
};

__device__ __forceinline__ bool has_run9(uint32_t bits) {
    uint32_t dbl = bits | (bits << 16);
    uint32_t r = dbl & (dbl >> 1);
    r = r & (r >> 2);
    r = r & (r >> 4);
    r = r & (dbl >> 8);
    return (r & 0xFFFFu) != 0u;
}

__global__ void __launch_bounds__(TILE_W * TILE_H)
fast_score_kernel(const float* __restrict__ gray, float* __restrict__ out,
                  int H, int W, float thr) {
    __shared__ float tile[SM_H][SM_W];
    const size_t plane = (size_t)H * (size_t)W;
    const float* img = gray + (size_t)blockIdx.z * plane;
    float* dst = out + (size_t)blockIdx.z * plane;
    const int x0 = blockIdx.x * TILE_W;
    const int y0 = blockIdx.y * TILE_H;
    const int tid = threadIdx.y * TILE_W + threadIdx.x;

    for (int i = tid; i < SM_H * SM_W; i += TILE_W * TILE_H) {
        const int ty = i / SM_W;
        const int tx = i - ty * SM_W;
        const int gy = y0 + ty - RADIUS;
        const int gx = x0 + tx - RADIUS;
        float v = 0.0f;
        if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
            v = __ldg(img + (size_t)gy * W + gx);
        }
        tile[ty][tx] = v;
    }
    __syncthreads();

    const int x = x0 + threadIdx.x;
    const int y = y0 + threadIdx.y;
    if (x >= W || y >= H) {
        return;
    }
    const int cy = threadIdx.y + RADIUS;
    const int cx = threadIdx.x + RADIUS;
    const float c = tile[cy][cx];
    const float hi = __fadd_rn(c, thr);
    const float lo = __fsub_rn(c, thr);
    uint32_t bright = 0u, dark = 0u;
    float score = 0.0f;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
        const float r = tile[cy + kCircle[k][1]][cx + kCircle[k][0]];
        bright |= (uint32_t)(r > hi) << k;
        dark |= (uint32_t)(r < lo) << k;
        score = __fadd_rn(score, fabsf(__fsub_rn(r, c)));
    }
    const bool corner = has_run9(bright) || has_run9(dark);
    dst[(size_t)y * W + x] = corner ? score : 0.0f;
}

}  // namespace

// Scores B images of H x W float32 (contiguous, B*H*W) into `out` (same
// layout) on `stream`. Returns the cudaError_t of the launch (0 on success).
extern "C" int fast_score(const float* gray, float* out, int B, int H, int W,
                          float thr, void* stream) {
    if (B <= 0 || H <= 0 || W <= 0) {
        return (int)cudaErrorInvalidValue;
    }
    const dim3 block(TILE_W, TILE_H, 1);
    const dim3 grid((W + TILE_W - 1) / TILE_W, (H + TILE_H - 1) / TILE_H, B);
    fast_score_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(gray, out, H, W, thr);
    return (int)cudaGetLastError();
}
