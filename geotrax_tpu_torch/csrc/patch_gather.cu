// 32x32 patch gather from a batch of float32 planes (sm_90a).
//
// Replaces geotrax_tpu/ops/pallas_patches.py:_make_kernel (the Pallas TPU
// kernel behind extract_patches) and computes exactly
// geotrax_tpu/ops/features.py:patches32, the XLA block gather in CLIP mode
// that the JAX appearance embedding (device_pipeline.embed_boxes) runs:
// out[b, k, r, c] = planes[b, y0[b, k] + r, x0[b, k] + c], with each corner
// first clamped to [0, H-32] x [0, W-32]. Corners that are already clipped
// are therefore taken as they are, as the Pallas kernel takes them.
//
// Design. One thread block covers one plane and a group of GROUP
// keypoints; each of its warps takes every WARPS-th keypoint of the group.
// A warp copies one patch row of 32 floats per step, lane i taking column
// i, so each row is one 128-byte store to an aligned output row and one
// 128-byte (possibly unaligned) read. The source issues all 32 row loads
// of a patch before its stores, so that a warp can have many reads in flight.
// Stores go through L2 only (st.global.cg): the output is written once and
// never read back by the kernel. The TPU kernel's (40,256) aligned window
// and its two rolls exist only for Mosaic's (8,128) tiling and are not
// carried over.
//
// Bound. The kernel writes K*4 KB per plane and reads at most as much
// (less where patches overlap: the embedding's padded detections clip to
// the same corner). For the fused ReID path's (96 planes, 1000 keypoints)
// per 32-frame chunk that is 393 MB written, about 0.117 ms at the H100's
// 3.35 TB/s before any read; it does no arithmetic, so it is bound by
// memory. The fused path launches it once per chunk, on the chunk's
// (3*C, H/2, W/2) channel planes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PATCH = 32;
constexpr int GROUP = 128;  // keypoints per block
constexpr int WARPS = 8;    // warps per block

__global__ void __launch_bounds__(WARPS * 32)
patch_gather_kernel(const float* __restrict__ planes, const int* __restrict__ x0s,
                    const int* __restrict__ y0s, float* __restrict__ out,
                    int K, int H, int W) {
    const int b = blockIdx.y;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const float* img = planes + (size_t)b * (size_t)H * (size_t)W;
    const int k_end = min((int)(blockIdx.x + 1) * GROUP, K);
    for (int k = blockIdx.x * GROUP + warp; k < k_end; k += WARPS) {
        const size_t kk = (size_t)b * (size_t)K + (size_t)k;
        // CLIP: the corner moves so that the whole patch lies in the plane
        const int x0 = min(max(__ldg(x0s + kk), 0), W - PATCH);
        const int y0 = min(max(__ldg(y0s + kk), 0), H - PATCH);
        const float* src = img + (size_t)y0 * (size_t)W + (size_t)(x0 + lane);
        float* dst = out + kk * (PATCH * PATCH) + lane;
        float row[PATCH];
#pragma unroll
        for (int r = 0; r < PATCH; ++r) {
            row[r] = __ldg(src + (size_t)r * (size_t)W);
        }
#pragma unroll
        for (int r = 0; r < PATCH; ++r) {
            __stcg(dst + r * PATCH, row[r]);
        }
    }
}

}  // namespace

// Gathers K patches of 32x32 from each of B planes of H x W float32
// (contiguous, B*H*W) at the (B,K) int32 corners x0, y0 into `out`
// (contiguous, B*K*32*32) on `stream`. Needs H >= 32 and W >= 32. Returns
// the cudaError_t of the launch (0 on success).
extern "C" int patch_gather(const float* planes, const int* x0, const int* y0, float* out,
                            int B, int K, int H, int W, void* stream) {
    if (B <= 0 || K <= 0 || H < PATCH || W < PATCH || B > 65535) {
        return (int)cudaErrorInvalidValue;
    }
    const dim3 block(WARPS * 32, 1, 1);
    const dim3 grid((K + GROUP - 1) / GROUP, B, 1);
    patch_gather_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(planes, x0, y0, out, K, H, W);
    return (int)cudaGetLastError();
}
