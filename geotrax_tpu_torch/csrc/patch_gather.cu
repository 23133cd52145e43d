// 32x32 patch gathers for Hopper (sm_90a): two entry points in one source.
//
// patch_gather replaces geotrax_tpu/ops/pallas_patches.py:_make_kernel (the
// Pallas TPU kernel behind extract_patches) and computes exactly
// geotrax_tpu/ops/features.py:patches32, the XLA block gather in CLIP mode:
// out[b, k, r, c] = planes[b, y0[b, k] + r, x0[b, k] + c], with each corner
// first clamped to [0, H-32] x [0, W-32] (corners already clipped are taken
// as they are, as the Pallas kernel takes them). describe(method="patches")
// calls it on one (H,W) plane.
//
// patch_gather_hwc is what the JAX appearance embedding
// (geotrax_tpu/pipeline/device_pipeline.py:embed_boxes) computes around that
// gather, in one pass over the (C,H,W,3) uint8 image: the 2x2 average of the
// frames (pool2) or the shared half-resolution image as it is, the gather of
// each channel at the (C,M) corners, written as float32 (C,M,3,32,32)
// patches (the learned head's NCHW order) or, with mean4, as the (C,M,3,8,8)
// 4x4 means whose (C,M,192) view is the projection's input in the
// reference's channel-major order. Every value is exact: 2x2 sums of u8 are
// integers of at most 1020, times 0.25; a 4x4 mean is an integer sum of at
// most 16320 over 16 or 64. So the float32 results equal the reference's bit
// for bit, whatever order the reference adds them in.
//
// Bound. Both move bytes and do no arithmetic worth counting: each patch is
// written once (4 KB, 12 KB for the HWC patches, 768 B for the means), and
// the pixels the patches cover are read once. Per 32-frame 4K ReID chunk the
// HWC entry writes 393 MB of patches, or 24.6 MB of means, and reads at most
// 98 MB of u8, where the float32 route it replaces first wrote two 0.8 GB
// copies of the pooled image.
//
// Design. The Pallas kernel's (40,256) aligned window and its two rolls
// exist only for Mosaic's (8,128) tiling and are not carried over. A flat
// grid over all B*K (or C*M) patches, sized to the blocks the card holds at
// once, walks them in a strided loop, so that one plane or a hundred fill
// the card alike and no grid dimension caps the planes. Each patch is one
// TMA transaction: a 2-D tiled load from a tensor map over the (B*H, W)
// planes (or the (C*H, 3W) bytes of the images) into shared memory,
// completing on an mbarrier; thread 0 keeps a ring of STAGES boxes loading
// while the block's 128 threads write the current one as coalesced float32
// rows (de-interleaving, pooling and averaging the HWC boxes on the way).
// A TMA box must start 16 bytes aligned in its row (an unaligned start is
// an illegal instruction on the H100), so each box starts at the patch's
// column rounded down and is 16 bytes wider: {36 floats, 32 rows}, {112
// bytes, 32 rows} or {208 bytes, 64 rows}; columns past the edge arrive as
// zeros and are not read. No L2 promotion: the rows of a box lie a row
// pitch apart, so widening each row's fetch to 128 or 256 bytes only adds
// traffic (slower on the card at every shape tried); the stage counts were
// chosen on the card among 2 to 8. TMA also needs a base and a row pitch
// that are multiples of 16 bytes: other layouts (the tests' 37x53) take the
// register path, which copies each box into shared memory with plain loads
// and writes it the same way.
// The tensor map is encoded with the driver's cuTensorMapEncodeTiled,
// found at run time in libcuda.so.1 (if it cannot be found the entry fails
// and says so), and only when the buffer changes; the grid's size is asked
// of the card once per kernel, so that a launch costs the host little more
// than the launch itself.

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>
#include <string.h>

#include <atomic>

namespace {

constexpr int PATCH = 32;
constexpr int THREADS = 128;  // per block

// error codes beside cudaError_t (which are positive)
constexpr int ERR_NO_DRIVER_ENTRY = -1;   // cuTensorMapEncodeTiled not found
constexpr int ERR_ENCODE_BASE = -1000;    // minus the CUresult of a failed encode

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count)
                 : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    const uint32_t addr = smem_u32(bar);
    uint32_t done = 0;
    while (!done) {
        asm volatile("{\n"
                     ".reg .pred p;\n"
                     "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     "selp.u32 %0, 1, 0, p;\n"
                     "}\n" : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    }
}

// TMA 2-D tiled load of the box at (c0 innermost, c1) into dst
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
    asm volatile("cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
                 " [%0], [%1, {%3, %4}], [%2];\n"
                 :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
                    "r"(c0), "r"(c1) : "memory");
}

__device__ __forceinline__ int clampi(int v, int hi) { return min(max(v, 0), hi); }

// ---------------------------------------------------------------- the two gathers

// Each gather is a box of image elements per patch (Elem, BOX_COLS x
// BOX_ROWS, loaded at a column rounded down to ALIGN elements, 16 bytes, as
// TMA needs: the patch starts `d` elements into each box row) and a writer
// that turns a box in shared memory into the patch's float32 output.

// patches32: (B,H,W) float32 planes -> (B,K,32,32)
struct FloatPlanes {
    using Elem = float;
    static constexpr int ALIGN = 4;
    static constexpr int BOX_COLS = PATCH + ALIGN;   // 144 bytes
    static constexpr int BOX_ROWS = PATCH;
    static constexpr int STAGES = 4;                 // 18 KB per block
    static constexpr int OUT = PATCH * PATCH;        // floats per patch
    __host__ __device__ static long long row_elems(int W) { return W; }
    __device__ static void corner(const int* x0s, const int* y0s, long long p, int K, int H, int W,
                                  int* col, int* row) {
        *col = clampi(__ldg(x0s + p), W - PATCH);
        *row = (int)(p / K) * H + clampi(__ldg(y0s + p), H - PATCH);
    }
    __device__ static void write(const float* box, int d, float* out) {
        for (int e = threadIdx.x; e < OUT; e += THREADS) {
            __stcg(out + e, box[(e >> 5) * BOX_COLS + d + (e & 31)]);
        }
    }
};

// patches32_hwc: (C,H,W,3) uint8 -> (C,M,3,32,32), or its (C,M,3,8,8) 4x4
// means, of the image or of its 2x2 average (POOL2)
template <bool POOL2, bool MEAN4>
struct HwcImage {
    using Elem = uint8_t;
    static constexpr int F = POOL2 ? 2 : 1;          // image pixels per patch pixel, each way
    static constexpr int ALIGN = 16;
    static constexpr int BOX_COLS = 3 * PATCH * F + ALIGN;   // 112 or 208 bytes
    static constexpr int BOX_ROWS = PATCH * F;
    static constexpr int STAGES = POOL2 ? 2 : 8;     // 26 KB or 28 KB per block
    static constexpr int OUT = 3 * (MEAN4 ? 64 : PATCH * PATCH);
    __host__ __device__ static long long row_elems(int W) { return 3LL * W; }
    __device__ static void corner(const int* x0s, const int* y0s, long long p, int M, int H, int W,
                                  int* col, int* row) {
        *col = 3 * F * clampi(__ldg(x0s + p), W / F - PATCH);
        *row = (int)(p / M) * H + F * clampi(__ldg(y0s + p), H / F - PATCH);
    }
    // the patch pixel (ch, r, c) as an integer: the u8 itself, or the sum
    // of its 2x2 block (a quarter of it is the pooled value)
    __device__ static int value(const uint8_t* box, int ch, int r, int c) {
        if (POOL2) {
            const uint8_t* q = box + (2 * r) * BOX_COLS + 6 * c + ch;
            return (int)q[0] + (int)q[3] + (int)q[BOX_COLS] + (int)q[BOX_COLS + 3];
        }
        return (int)box[r * BOX_COLS + 3 * c + ch];
    }
    __device__ static void write(const uint8_t* box, int d, float* out) {
        box += d;
        if (MEAN4) {
            // exact sums of 16 (or 64) u8 over a power of two
            constexpr float SCALE = POOL2 ? 1.0f / 64.0f : 1.0f / 16.0f;
            for (int e = threadIdx.x; e < OUT; e += THREADS) {
                // the output (ch, i, j) at out[ch * 64 + i * 8 + j]. A pooled
                // box's rows i lie 8 * BOX_COLS bytes apart, a multiple of 128,
                // in one bank: its lanes take (j, ch) first, so that a warp's
                // loads fall in distinct banks
                const int i = POOL2 ? e / 24 : (e >> 3) & 7;
                const int j = POOL2 ? e % 24 / 3 : e & 7;
                const int ch = POOL2 ? e % 3 : e >> 6;
                int sum = 0;
#pragma unroll
                for (int rr = 0; rr < 4; ++rr) {
#pragma unroll
                    for (int cc = 0; cc < 4; ++cc) sum += value(box, ch, 4 * i + rr, 4 * j + cc);
                }
                __stcg(out + ch * 64 + i * 8 + j, (float)sum * SCALE);
            }
        } else {
            for (int e = threadIdx.x; e < OUT; e += THREADS) {
                const int v = value(box, e >> 10, (e >> 5) & 31, e & 31);
                __stcg(out + e, POOL2 ? 0.25f * (float)v : (float)v);
            }
        }
    }
};

// One block walks patches blockIdx.x, +gridDim.x, ... With TMA, thread 0
// keeps the block's next STAGES - 1 boxes loading (stage i % STAGES,
// completing on its mbarrier) while all threads write the current one;
// without, the threads copy each box into stage 0 with plain loads.
template <class G, bool TMA>
__global__ void __launch_bounds__(THREADS)
gather_kernel(const __grid_constant__ CUtensorMap map, const typename G::Elem* __restrict__ src,
              const int* __restrict__ x0s, const int* __restrict__ y0s, float* __restrict__ out,
              long long total, int K, int H, int W) {
    using Elem = typename G::Elem;
    constexpr int BOX = G::BOX_COLS * G::BOX_ROWS;
    __shared__ __align__(128) Elem tile[TMA ? G::STAGES : 1][BOX];
    __shared__ __align__(8) uint64_t full[G::STAGES];
    if ((long long)blockIdx.x >= total) return;
    const long long n = (total - 1 - blockIdx.x) / gridDim.x + 1;  // this block's patches
    const CUtensorMap* tmap = &map;
    auto box_of = [&](long long i, int* col, int* row) {  // aligned column, offset into the box
        int c;
        G::corner(x0s, y0s, blockIdx.x + i * (long long)gridDim.x, K, H, W, &c, row);
        *col = c - c % G::ALIGN;
        return c - *col;
    };
    auto issue = [&](long long i) {
        int col, row;
        box_of(i, &col, &row);
        const int s = (int)(i % G::STAGES);
        mbar_expect_tx(&full[s], BOX * sizeof(Elem));
        tma_load_2d(tile[s], tmap, &full[s], col, row);
    };
    if (TMA && threadIdx.x == 0) {
        for (int s = 0; s < G::STAGES; ++s) mbar_init(&full[s], 1);
        fence_barrier_init();
        for (long long i = 0; i < n && i < G::STAGES; ++i) issue(i);
    }
    __syncthreads();
    const long long width = G::row_elems(W);
    for (long long i = 0; i < n; ++i) {
        int col, row;
        const int d = box_of(i, &col, &row);
        const int s = TMA ? (int)(i % G::STAGES) : 0;
        if (TMA) {
            mbar_wait(&full[s], (uint32_t)((i / G::STAGES) & 1));
        } else {
            for (int e = threadIdx.x; e < BOX; e += THREADS) {
                const int r = e / G::BOX_COLS, c = col + (e - r * G::BOX_COLS);
                tile[0][e] = c < width ? __ldg(src + (row + r) * width + c) : Elem(0);
            }
            __syncthreads();
        }
        G::write(tile[s], d, out + (blockIdx.x + i * (long long)gridDim.x) * G::OUT);
        __syncthreads();  // every thread is done with stage s
        if (TMA && threadIdx.x == 0 && i + G::STAGES < n) issue(i + G::STAGES);
    }
}

// ---------------------------------------------------------------- host side

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
    static EncodeTiled fn = [] {
        void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
        return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
    }();
    return fn;
}

// A 2-D tensor map over `rows` x `cols` elements of `type` (row pitch
// `pitch_bytes`) with a `box_cols` x `box_rows` box; 0 or an error code.
int encode_2d(CUtensorMap* map, CUtensorMapDataType type, const void* base, uint64_t cols,
              uint64_t rows, uint64_t pitch_bytes, uint32_t box_cols, uint32_t box_rows) {
    EncodeTiled fn = encode_tiled();
    if (fn == nullptr) return ERR_NO_DRIVER_ENTRY;
    const cuuint64_t dims[2] = {cols, rows};
    const cuuint64_t strides[1] = {pitch_bytes};
    const cuuint32_t box[2] = {box_cols, box_rows};
    const cuuint32_t elem[2] = {1, 1};
    const CUresult rc = fn(map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
                           CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                           CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return rc == CUDA_SUCCESS ? 0 : ERR_ENCODE_BASE - (int)rc;
}

// The tensor map of gather G over `src` into `map`, encoded again only
// when the caller's base or shape changed since its thread's last call (the
// map holds nothing else, and callers mostly hand in the same buffer); kept
// as plain bytes so that the thread-local copy needs no 64-byte alignment.
// 0 or an error code.
template <class G>
int tensor_map(CUtensorMap* map, CUtensorMapDataType type, const void* src, int W,
               long long rows) {
    thread_local struct {
        const void* base = nullptr;
        int W = 0;
        long long rows = 0;
        unsigned char bytes[sizeof(CUtensorMap)];
    } last;
    if (last.base == src && last.W == W && last.rows == rows) {
        memcpy(map, last.bytes, sizeof(CUtensorMap));
        return 0;
    }
    const int rc = encode_2d(map, type, src, G::row_elems(W), rows,
                             G::row_elems(W) * sizeof(typename G::Elem), G::BOX_COLS, G::BOX_ROWS);
    if (rc != 0) return rc;
    memcpy(last.bytes, map, sizeof(CUtensorMap));
    last.base = src;
    last.W = W;
    last.rows = rows;
    return 0;
}

// Blocks for `work` items: at most as many as the card holds at once. The
// card's capacity for each kernel is asked once per device.
template <class G, bool TMA>
int grid_for(long long work) {
    constexpr int MAX_DEVICES = 64;
    static std::atomic<int> most[MAX_DEVICES];
    int dev = 0;
    cudaGetDevice(&dev);
    int cap = dev < MAX_DEVICES ? most[dev].load(std::memory_order_relaxed) : 0;
    if (cap == 0) {
        int sms = 0, per_sm = 0;
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gather_kernel<G, TMA>, THREADS, 0);
        cap = sms * (per_sm > 0 ? per_sm : 1);
        if (dev < MAX_DEVICES) most[dev].store(cap, std::memory_order_relaxed);
    }
    return (int)(work < cap ? work : cap);
}

// Launches gather G over `total` patches of the `rows` x row_elems(W)
// elements at `src`: TMA where the base and the row pitch are multiples of
// 16 bytes, else the plain-load copy.
template <class G>
int launch(const typename G::Elem* src, CUtensorMapDataType type, const int* x0, const int* y0,
           float* out, long long total, int K, int H, int W, long long rows,
           cudaStream_t stream) {
    const long long pitch = G::row_elems(W) * (long long)sizeof(typename G::Elem);
    if (reinterpret_cast<uintptr_t>(src) % 16 == 0 && pitch % 16 == 0 && rows < (1LL << 31)) {
        CUtensorMap map;
        const int rc = tensor_map<G>(&map, type, src, W, rows);
        if (rc != 0) return rc;
        gather_kernel<G, true><<<grid_for<G, true>(total), THREADS, 0, stream>>>(
            map, src, x0, y0, out, total, K, H, W);
    } else {
        gather_kernel<G, false><<<grid_for<G, false>(total), THREADS, 0, stream>>>(
            CUtensorMap{}, src, x0, y0, out, total, K, H, W);
    }
    return (int)cudaGetLastError();
}

}  // namespace

// Gathers K patches of 32x32 from each of B planes of H x W float32
// (contiguous, B*H*W) at the (B,K) int32 corners x0, y0 into `out`
// (contiguous, B*K*32*32) on `stream`; TMA where the planes' base and row
// pitch are multiples of 16 bytes, else plain loads. Needs H >= 32 and
// W >= 32. Returns 0, a cudaError_t, -1 when the driver has no
// cuTensorMapEncodeTiled, or -1000 - CUresult when encoding failed.
extern "C" int patch_gather(const float* planes, const int* x0, const int* y0, float* out,
                            int B, int K, int H, int W, void* stream) {
    if (B <= 0 || K <= 0 || H < PATCH || W < PATCH) return (int)cudaErrorInvalidValue;
    return launch<FloatPlanes>(planes, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, x0, y0, out, (long long)B * K,
                               K, H, W, (long long)B * H, (cudaStream_t)stream);
}

// Gathers M patches of each of C (H,W,3) uint8 images (contiguous) at the
// (C,M) int32 corners, of the 2x2-pooled image when `pool2` (H and W trimmed
// to even, corners in pooled pixels), into `out`: (C,M,3,32,32) float32, or
// (C,M,3,8,8) 4x4 means when `mean4`. TMA where the image's base and row
// pitch (3W bytes) are multiples of 16 bytes, else plain loads. Needs the
// (pooled) image to be at least 32 x 32. Returns as patch_gather does.
extern "C" int patch_gather_hwc(const uint8_t* image, const int* x0, const int* y0, float* out,
                                int C, int M, int H, int W, int pool2, int mean4, void* stream) {
    const int f = pool2 ? 2 : 1;
    if (C <= 0 || M <= 0 || H / f < PATCH || W / f < PATCH) return (int)cudaErrorInvalidValue;
    const auto u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
    const long long total = (long long)C * M, rows = (long long)C * H;
    cudaStream_t s = (cudaStream_t)stream;
    if (pool2) {
        return mean4 ? launch<HwcImage<true, true>>(image, u8, x0, y0, out, total, M, H, W, rows, s)
                     : launch<HwcImage<true, false>>(image, u8, x0, y0, out, total, M, H, W, rows, s);
    }
    return mean4 ? launch<HwcImage<false, true>>(image, u8, x0, y0, out, total, M, H, W, rows, s)
                 : launch<HwcImage<false, false>>(image, u8, x0, y0, out, total, M, H, W, rows, s);
}
