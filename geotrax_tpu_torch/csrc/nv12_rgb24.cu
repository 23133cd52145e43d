// NV12 -> packed RGB24: the YUV -> RGB step of decoding (sm_90a).
//
// Replaces no TPU kernel: it replaces the host's swscale call of the
// reference's decoder, geotrax_tpu/io/native/decode.cpp:169-172
// (sws_getContext(w, h, yuv420p, w, h, AV_PIX_FMT_RGB24, SWS_BILINEAR, ...)
// with no sws_setColorspaceDetails), so that a frame decoded to planes
// crosses PCIe at 1.5 bytes a pixel instead of 3 and is converted on the
// card, and so that a decoder that leaves its output on the card (NVDEC's
// NV12 surface) can hand frames to the chunk step without a host copy.
//
// Arithmetic. For same-size yuv420p -> rgb24 with even height swscale runs
// its unscaled special converter, one chroma sample per 2x2 pixels with no
// interpolation; on x86 with MMXEXT or SSSE3 that is its SIMD converter
// (libswscale 6.7: yuv420_rgb24, the same bytes with either), in 16-bit
// fixed point with BT.601 limited-range coefficients scaled by 2^13:
//   Y' = ((y << 3) - 128) * 9539 >> 16
//   Cb = (u << 3) - 1024, Cr = (v << 3) - 1024
//   R = clamp(Y' + (Cr * 13075 >> 16))
//   G = clamp(Y' + (Cb * -3209 >> 16) + (Cr * -6660 >> 16))
//   B = clamp(Y' + (Cb * 16525 >> 16))
// (">> 16" is pmulhw's floor of the product's high half; clamp to 0..255 is
// packuswb). geotrax_tpu_torch/ops/yuv.py:nv12_to_rgb24_torch is the plain
// version, equal to that converter on all 2^24 (y, u, v); the kernel does
// the same integer operations (no float), so the two agree bit for bit.
//
// Layout. The Y plane is h rows of w bytes and the UV plane h/2 rows of w
// bytes (U0 V0 U1 V1 ...), each row at its own pitch (NVDEC's surfaces and
// a torch tensor's rows alike); the output is a contiguous (h, w, 3)
// uint8 tensor. h and w are even (4:2:0).
//
// Bound. It reads each plane byte once and writes each output byte once:
// at 3840x2160, 12.44 MB in and 24.88 MB out, 37.3 MB or 11.1 us at the
// H100's 3.35 TB/s. Its ~12 integer operations a pixel (99.5 M at 4K) take
// 3.0 us at 33.5 T/s (int32 runs at half the 67 TFLOP/s float32 rate), so
// it is bound by memory. One thread converts a 2-row,
// 4-pixel tile (two chroma samples): one 4-byte load of UV and one of Y per
// row, and three 4-byte stores per row where the row's output is 4-byte
// aligned (every row when w % 4 == 0), byte loads and stores elsewhere
// (the ragged right edge of a width that is 2 mod 4, and the odd rows of
// such a width). Neighbouring threads take neighbouring tiles, so a warp's
// loads and stores cover contiguous bytes of a row.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int Y_COEFF = 9539;
constexpr int Y_OFFSET = 128;  // 16 << 3
constexpr int C_OFFSET = 1024;  // 128 << 3
constexpr int VR_COEFF = 13075;
constexpr int UG_COEFF = -3209;
constexpr int VG_COEFF = -6660;
constexpr int UB_COEFF = 16525;
constexpr int TILE_X = 64;  // tiles (4 pixels each) per block along a row
constexpr int TILE_Y = 4;   // row pairs per block

struct Chroma {
  int r, g, b;
};

// Right shifts of negative ints are arithmetic in nvcc, as pmulhw's floor.
__device__ __forceinline__ Chroma chroma(int u, int v) {
  const int cb = (u << 3) - C_OFFSET, cr = (v << 3) - C_OFFSET;
  return {(cr * VR_COEFF) >> 16, ((cb * UG_COEFF) >> 16) + ((cr * VG_COEFF) >> 16),
          (cb * UB_COEFF) >> 16};
}

__device__ __forceinline__ uint32_t clamp255(int v) {
  return static_cast<uint32_t>(min(max(v, 0), 255));
}

__device__ __forceinline__ void load4(const uint8_t* p, int n, uint32_t (&v)[4]) {
  if (n == 4 && (reinterpret_cast<uintptr_t>(p) & 3) == 0) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = (w >> (8 * k)) & 0xFF;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = k < n ? p[k] : 0;
  }
}

__global__ void nv12_rgb24_kernel(const uint8_t* __restrict__ y, long long y_pitch,
                                  const uint8_t* __restrict__ uv, long long uv_pitch,
                                  uint8_t* __restrict__ out, int h, int w) {
  const int x0 = (blockIdx.x * TILE_X + threadIdx.x) * 4;
  const int pair = blockIdx.y * TILE_Y + threadIdx.y;
  if (x0 >= w || 2 * pair >= h) return;
  const int n = min(4, w - x0);  // 4, or 2 at the right edge when w % 4 == 2
  uint32_t c[4];
  load4(uv + pair * uv_pitch + x0, n, c);
  const Chroma ch[2] = {chroma(c[0], c[1]), chroma(c[2], c[3])};
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
    const int row = 2 * pair + dy;
    uint32_t l[4];
    load4(y + row * y_pitch + x0, n, l);
    uint32_t px[12];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int yy = ((static_cast<int>(l[k]) << 3) - Y_OFFSET) * Y_COEFF >> 16;
      const Chroma& cc = ch[k >> 1];
      px[3 * k] = clamp255(yy + cc.r);
      px[3 * k + 1] = clamp255(yy + cc.g);
      px[3 * k + 2] = clamp255(yy + cc.b);
    }
    uint8_t* o = out + (static_cast<long long>(row) * w + x0) * 3;
    if (n == 4 && (reinterpret_cast<uintptr_t>(o) & 3) == 0) {
      uint32_t* o32 = reinterpret_cast<uint32_t*>(o);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        o32[k] = px[4 * k] | (px[4 * k + 1] << 8) | (px[4 * k + 2] << 16) | (px[4 * k + 3] << 24);
      }
    } else {
      for (int k = 0; k < 3 * n; ++k) o[k] = static_cast<uint8_t>(px[k]);
    }
  }
}

}  // namespace

// Convert the NV12 planes at y (h rows, pitch y_pitch bytes) and uv (h/2
// rows, pitch uv_pitch) into out ((h, w, 3) uint8, contiguous) on stream;
// returns the launch's CUDA error (0 when it was accepted).
extern "C" int gtx_nv12_rgb24(const uint8_t* y, long long y_pitch, const uint8_t* uv,
                              long long uv_pitch, uint8_t* out, int h, int w, void* stream) {
  if (h <= 0 || w <= 0 || h % 2 || w % 2 || y_pitch < w || uv_pitch < w) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 block(TILE_X, TILE_Y);
  const dim3 grid(((w + 3) / 4 + TILE_X - 1) / TILE_X, (h / 2 + TILE_Y - 1) / TILE_Y);
  nv12_rgb24_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(y, y_pitch, uv,
                                                                            uv_pitch, out, h, w);
  return static_cast<int>(cudaGetLastError());
}
