// Planar 8-bit 4:2:0 / 4:2:2 -> packed RGB24 as swscale's special
// converter does it (sm_90a).
//
// Replaces no TPU kernel: it replaces the host's swscale call of the
// reference's decoder, geotrax_tpu/io/native/decode.cpp:169-172
// (sws_getContext(w, h, <the first frame's format>, w, h, AV_PIX_FMT_RGB24,
// SWS_BILINEAR, ...) with no sws_setColorspaceDetails), for the frames where
// swscale takes its unscaled special converter: yuv420p, yuvj420p, yuv422p
// and yuvj422p with an even height, any width.
//
// Arithmetic. On x86 with SSSE3 that converter is libswscale 6.7's
// yuv420_rgb24_ssse3 (4:2:2 through the same loop with one chroma row a
// row): one chroma sample for each 2 pixels across (and each 2 rows down in
// 4:2:0), no interpolation, 16-bit fixed point with coefficients scaled by
// 2^13 (ff_yuv2rgb_c_init_tables; BT.601, limited or full range by the
// format's name):
//   Y' = ((y << 3) - y_offset) * y_coeff >> 16
//   Cb = (u << 3) - 1024, Cr = (v << 3) - 1024
//   R = clamp(Y' + (Cr * vr >> 16))
//   G = clamp(Y' + (Cb * ug >> 16) + (Cr * vg >> 16))
//   B = clamp(Y' + (Cb * ub >> 16))
// limited range: y_coeff 9539, y_offset 128, vr 13075, ug -3209, vg -6660,
// ub 16525 (csrc/nv12_rgb24.cu's); full range: 8192, 0, 11485, -2819, -5850,
// 14516. geotrax_tpu_torch/ops/yuv.py:yuv_unscaled_to_rgb24_torch is the
// plain version, equal to that converter on all 2^24 (y, u, v) of each
// format; the kernel does the same integer operations (no float), so the
// two agree bit for bit. (Where w > 16 and w % 16 is 1..7 swscale leaves
// the last w % 16 pixels of each row unwritten; both convert them.)
//
// Layout. Y is h rows of w bytes; U and V are h >> vshift rows (rounded
// up) of (w + 1) / 2 bytes; each plane's rows at their own pitch. The
// output is a contiguous (h, w, 3) uint8 tensor.
//
// Bound. Each plane byte read once, each output byte written once: at
// 3840x2160 4:2:0 12.44 MB in and 24.88 MB out (37.3 MB, 11.1 us at 3.35
// TB/s), 4:2:2 16.6 MB in (41.5 MB, 12.4 us). Its ~12 integer operations a
// pixel take 3.0 us at 33.5 T/s int32: bound by memory. One thread converts
// 4 pixels of a row (two chroma samples): a 4-byte load of Y where aligned,
// two bytes each of U and V, and three 4-byte stores where the output row
// is 4-byte aligned (every row when w % 4 == 0), byte stores elsewhere.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int C_OFFSET = 1024;  // 128 << 3
constexpr int TILE_X = 64;      // threads (4 pixels each) per block along a row
constexpr int TILE_Y = 4;       // rows per block

struct Coeffs {
  int y_coeff, y_offset, vr, ug, vg, ub;
};

__device__ __forceinline__ uint32_t clamp255(int v) {
  return static_cast<uint32_t>(min(max(v, 0), 255));
}

__global__ void yuv_rgb24_kernel(const uint8_t* __restrict__ y, long long y_pitch,
                                 const uint8_t* __restrict__ u, long long u_pitch,
                                 const uint8_t* __restrict__ v, long long v_pitch,
                                 uint8_t* __restrict__ out, int h, int w, int vshift,
                                 Coeffs k) {
  const int x0 = (blockIdx.x * TILE_X + threadIdx.x) * 4;
  const int row = blockIdx.y * TILE_Y + threadIdx.y;
  if (x0 >= w || row >= h) return;
  const int n = min(4, w - x0);
  const uint8_t* yr = y + row * y_pitch + x0;
  uint32_t l[4];
  if (n == 4 && (reinterpret_cast<uintptr_t>(yr) & 3) == 0) {
    const uint32_t word = *reinterpret_cast<const uint32_t*>(yr);
#pragma unroll
    for (int i = 0; i < 4; ++i) l[i] = (word >> (8 * i)) & 0xFF;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) l[i] = i < n ? yr[i] : 0;
  }
  const int crow = row >> vshift, cx = x0 >> 1;
  const int pairs = (n + 1) >> 1;  // chroma samples this tile covers
  int cr_[2], cg_[2], cb_[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int uu = c < pairs ? u[crow * u_pitch + cx + c] : 128;
    const int vv = c < pairs ? v[crow * v_pitch + cx + c] : 128;
    const int cb = (uu << 3) - C_OFFSET, cr = (vv << 3) - C_OFFSET;
    cr_[c] = (cr * k.vr) >> 16;  // arithmetic shifts in nvcc, pmulhw's floor
    cg_[c] = ((cb * k.ug) >> 16) + ((cr * k.vg) >> 16);
    cb_[c] = (cb * k.ub) >> 16;
  }
  uint32_t px[12];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int yy = ((static_cast<int>(l[i]) << 3) - k.y_offset) * k.y_coeff >> 16;
    px[3 * i] = clamp255(yy + cr_[i >> 1]);
    px[3 * i + 1] = clamp255(yy + cg_[i >> 1]);
    px[3 * i + 2] = clamp255(yy + cb_[i >> 1]);
  }
  uint8_t* o = out + (static_cast<long long>(row) * w + x0) * 3;
  if (n == 4 && (reinterpret_cast<uintptr_t>(o) & 3) == 0) {
    uint32_t* o32 = reinterpret_cast<uint32_t*>(o);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      o32[i] = px[4 * i] | (px[4 * i + 1] << 8) | (px[4 * i + 2] << 16) | (px[4 * i + 3] << 24);
    }
  } else {
    for (int i = 0; i < 3 * n; ++i) o[i] = static_cast<uint8_t>(px[i]);
  }
}

}  // namespace

// Convert the planes at y (h rows, pitch y_pitch bytes), u and v (h >>
// vshift rows rounded up, (w + 1) / 2 bytes a row) into out ((h, w, 3)
// uint8, contiguous) on stream; k holds y_coeff, y_offset, vr, ug, vg, ub.
// Returns the launch's CUDA error (0 when it was accepted).
extern "C" int gtx_yuv_rgb24(const uint8_t* y, long long y_pitch, const uint8_t* u,
                             long long u_pitch, const uint8_t* v, long long v_pitch,
                             uint8_t* out, int h, int w, int vshift, const int* k,
                             void* stream) {
  const int cw = (w + 1) / 2;
  if (h <= 0 || w <= 0 || (vshift != 0 && vshift != 1) || (vshift && h % 2) || y_pitch < w ||
      u_pitch < cw || v_pitch < cw) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Coeffs c{k[0], k[1], k[2], k[3], k[4], k[5]};
  const dim3 block(TILE_X, TILE_Y);
  const dim3 grid(((w + 3) / 4 + TILE_X - 1) / TILE_X, (h + TILE_Y - 1) / TILE_Y);
  yuv_rgb24_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      y, y_pitch, u, u_pitch, v, v_pitch, out, h, w, vshift, c);
  return static_cast<int>(cudaGetLastError());
}
