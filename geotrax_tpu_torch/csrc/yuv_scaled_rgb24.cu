// Planar YUV -> packed RGB24 as swscale's generic scaler does it at the
// same size (sm_90a): 10-bit 4:2:0 / 4:2:2 / 4:4:4, 8-bit 4:4:4, and
// 8-bit 4:2:0 / 4:2:2 with an odd height.
//
// Replaces no TPU kernel: it replaces the host's swscale call of the
// reference's decoder, geotrax_tpu/io/native/decode.cpp:169-172
// (sws_getContext(w, h, <the first frame's format>, w, h, AV_PIX_FMT_RGB24,
// SWS_BILINEAR, ...) with no sws_setColorspaceDetails), for the frames
// where swscale has no special converter and runs its scaler.
//
// Arithmetic, libswscale 6.7's, in its integers:
// (1) Horizontal scaler (hScale8To15 / hScale16To15): 15-bit samples, the
//     14-bit taps' sum >> shift (7 for 8-bit input, 9 for 10-bit), at most
//     32767. Luma and 4:4:4 chroma go through the identity (s << 14 >>
//     shift); the chroma of an odd width of 4:2:x is interpolated across by
//     a bilinear filter of two taps a column (hpos, hcoef), because swscale
//     then outputs one chroma value a pixel.
// (2) Vertical step of yuv2packed1 (the luma's filter is the identity):
//     each output row's chroma is the sum of two 15-bit rows (rows[r]):
//     its filter's row twice where the filter's second tap is below half,
//     else the two rows it spans (4:2:0's 3/4-1/4 rows are not weighted).
// (3) Output, one of two:
//     TABLE (yuv2rgb24_1; 4:2:x with an even width, one chroma value per 2
//     pixels): Y = (Y15 + 64) >> 7, U = min((Usum + 128) >> 8, 255) and V
//     alike, and each of R, G, B one entry of the C converter's 24-bit luma
//     table, table(i) = clamp(((base + i) * cy - k + 0x8000) >> 16), at i =
//     Y + the chroma's moves (c * inc >> 16) - (inc >> 9): R with V's t_vr,
//     G with U's t_ug and V's t_vg, B with U's t_ub.
//     FULL (yuv2rgb24_full_1; SWS_FULL_CHR_H_INT, which swscale forces for
//     4:4:4 and odd widths): Y = (Y15 * 4 - yo) * yc + 2^21, U = (Usum -
//     32768) * 2 and V alike, R = Y + V * vr, G = Y + V * vg + U * ug, B = Y
//     + U * ub in C's wrapping 32-bit unsigned arithmetic read back as int,
//     clipped to 0..2^30-1 (a sum that wrapped negative clips to 0), >> 22.
// geotrax_tpu_torch/ops/yuv.py:yuv_scaled_to_rgb24_torch is the plain
// version (its scaled_plan makes the filter tables that both read, from a
// port of swscale's initFilter), equal to swscale on every (y, u, v) of
// the 8-bit formats and on seeded 10-bit samples; the kernel does the same
// integer operations (no float), so the two agree bit for bit.
//
// Layout. Y is h rows of w samples, U and V ch rows of cw samples, each
// plane's rows at their own pitch (in samples); 8-bit samples are bytes,
// 10-bit ones libav's little-endian 16-bit words, read directly. The output
// is a contiguous (h, w, 3) uint8 tensor.
//
// Bound. Each plane sample read once, each output byte written once, the
// tables (12 bytes a chroma column where the filter interpolates, 8 a row)
// read once: at 3840x2160, 10-bit 4:2:0 24.9 MB in (49.8 MB, 14.9 us at
// 3.35 TB/s), 10-bit 4:4:4 49.8 MB in (74.6 MB, 22.3 us). Its ~30 integer
// operations a pixel take 7.4 us at 33.5 T/s int32: bound by memory. One
// thread converts 4 pixels of a row: one 4- or 8-byte load of Y where
// aligned, the chroma samples of its columns in two rows, and three 4-byte
// stores where the output row is 4-byte aligned, byte stores elsewhere.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TILE_X = 64;  // threads (4 pixels each) per block along a row
constexpr int TILE_Y = 4;   // rows per block

struct Params {
  int h, w, cw;   // output size; chroma source columns
  int shift;      // 7 (8-bit) or 9 (10-bit)
  int base, cy, k, t_vr, t_ug, t_vg, t_ub;  // TABLE
  int yo, yc, vr, ug, vg, ub;               // FULL
};

template <typename T>
__device__ __forceinline__ void load4(const T* p, int n, int (&s)[4]) {
  if constexpr (sizeof(T) == 1) {
    if (n == 4 && (reinterpret_cast<uintptr_t>(p) & 3) == 0) {
      const uint32_t word = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i] = (word >> (8 * i)) & 0xFF;
      return;
    }
  } else {
    if (n == 4 && (reinterpret_cast<uintptr_t>(p) & 7) == 0) {
      const uint2 word = *reinterpret_cast<const uint2*>(p);
      s[0] = word.x & 0xFFFF;
      s[1] = word.x >> 16;
      s[2] = word.y & 0xFFFF;
      s[3] = word.y >> 16;
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) s[i] = i < n ? static_cast<int>(p[i]) : 0;
}

// The 15-bit chroma of source row ``row`` at output column ``col``.
template <typename T>
__device__ __forceinline__ int chroma15(const T* __restrict__ plane, long long pitch, int row,
                                        int col, const int* __restrict__ hpos,
                                        const short2* __restrict__ hcoef, const Params& p) {
  const T* r = plane + row * pitch;
  if (hpos == nullptr) return (static_cast<int>(r[col]) << 14) >> p.shift;
  const int first = hpos[col];
  const short2 taps = hcoef[col];
  const int second = min(first + 1, p.cw - 1);
  const int sum = static_cast<int>(r[first]) * taps.x + static_cast<int>(r[second]) * taps.y;
  return min(sum >> p.shift, 32767);
}

__device__ __forceinline__ int table(int i, const Params& p) {
  return min(max(((p.base + i) * p.cy - p.k + 0x8000) >> 16, 0), 255);
}

__device__ __forceinline__ int move(int c, int inc) { return ((c * inc) >> 16) - (inc >> 9); }

__device__ __forceinline__ uint32_t clip30(unsigned int x) {
  const int s = static_cast<int>(x);  // C's conversion: the wrapped value
  return static_cast<uint32_t>(min(max(s, 0), (1 << 30) - 1)) >> 22;
}

template <typename T, bool FULL>
__global__ void yuv_scaled_rgb24_kernel(const T* __restrict__ y, long long y_pitch,
                                        const T* __restrict__ u, const T* __restrict__ v,
                                        long long c_pitch, const int* __restrict__ hpos,
                                        const short2* __restrict__ hcoef,
                                        const int2* __restrict__ rows,
                                        uint8_t* __restrict__ out, Params p) {
  const int x0 = (blockIdx.x * TILE_X + threadIdx.x) * 4;
  const int row = blockIdx.y * TILE_Y + threadIdx.y;
  if (x0 >= p.w || row >= p.h) return;
  const int n = min(4, p.w - x0);
  int s[4];
  load4(y + row * y_pitch + x0, n, s);
  const int2 cr = rows[row];
  uint32_t px[12];
  if constexpr (FULL) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int x = min(x0 + i, p.w - 1);
      const int us = chroma15(u, c_pitch, cr.x, x, hpos, hcoef, p) +
                     chroma15(u, c_pitch, cr.y, x, hpos, hcoef, p);
      const int vs = chroma15(v, c_pitch, cr.x, x, hpos, hcoef, p) +
                     chroma15(v, c_pitch, cr.y, x, hpos, hcoef, p);
      const unsigned int uf = static_cast<unsigned int>((us - 32768) * 2);
      const unsigned int vf = static_cast<unsigned int>((vs - 32768) * 2);
      const int y15 = (s[i] << 14) >> p.shift;
      const unsigned int yy =
          static_cast<unsigned int>((y15 * 4 - p.yo) * p.yc) + (1u << 21);
      px[3 * i] = clip30(yy + vf * static_cast<unsigned int>(p.vr));
      px[3 * i + 1] = clip30(yy + vf * static_cast<unsigned int>(p.vg) +
                             uf * static_cast<unsigned int>(p.ug));
      px[3 * i + 2] = clip30(yy + uf * static_cast<unsigned int>(p.ub));
    }
  } else {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int col = min((x0 >> 1) + c, p.cw - 1);
      const int us = chroma15(u, c_pitch, cr.x, col, hpos, hcoef, p) +
                     chroma15(u, c_pitch, cr.y, col, hpos, hcoef, p);
      const int vs = chroma15(v, c_pitch, cr.x, col, hpos, hcoef, p) +
                     chroma15(v, c_pitch, cr.y, col, hpos, hcoef, p);
      const int uc = min((us + 128) >> 8, 255), vc = min((vs + 128) >> 8, 255);
      const int mr = move(vc, p.t_vr), mg = move(uc, p.t_ug) + move(vc, p.t_vg),
                mb = move(uc, p.t_ub);
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        const int i = 2 * c + d;
        const int y8 = (((s[i] << 14) >> p.shift) + 64) >> 7;
        px[3 * i] = table(y8 + mr, p);
        px[3 * i + 1] = table(y8 + mg, p);
        px[3 * i + 2] = table(y8 + mb, p);
      }
    }
  }
  uint8_t* o = out + (static_cast<long long>(row) * p.w + x0) * 3;
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

template <typename T, bool FULL>
int launch(const void* y, long long y_pitch, const void* u, const void* v, long long c_pitch,
           const int* hpos, const short2* hcoef, const int2* rows, uint8_t* out,
           const Params& p, cudaStream_t stream) {
  const dim3 block(TILE_X, TILE_Y);
  const dim3 grid(((p.w + 3) / 4 + TILE_X - 1) / TILE_X, (p.h + TILE_Y - 1) / TILE_Y);
  yuv_scaled_rgb24_kernel<T, FULL><<<grid, block, 0, stream>>>(
      static_cast<const T*>(y), y_pitch, static_cast<const T*>(u), static_cast<const T*>(v),
      c_pitch, hpos, hcoef, rows, out, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Convert the planes at y (h rows of w samples, pitch y_pitch samples), u
// and v (ch rows of cw samples, pitch c_pitch) into out ((h, w, 3) uint8,
// contiguous) on stream. sample_bytes 1 or 2; full 1 for the full-chroma
// output; hpos (int, a column) and hcoef (two int16 taps a column) the
// horizontal chroma filter, both null for the identity; rows two int32 a
// row. prm: h, w, cw, ch, shift, then base, cy, k, t_vr, t_ug, t_vg, t_ub,
// then yo, yc, vr, ug, vg, ub. Returns the launch's CUDA error (0 when it
// was accepted).
extern "C" int gtx_yuv_scaled_rgb24(const void* y, long long y_pitch, const void* u,
                                    const void* v, long long c_pitch, int sample_bytes,
                                    int full, const int* hpos, const void* hcoef,
                                    const void* rows, uint8_t* out, const int* prm,
                                    void* stream) {
  const int h = prm[0], w = prm[1], cw = prm[2], ch = prm[3];
  if (h <= 0 || w <= 0 || cw <= 0 || ch <= 0 || y_pitch < w || c_pitch < cw || !rows ||
      (sample_bytes != 1 && sample_bytes != 2) || ((hpos == nullptr) != (hcoef == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p{h, w, cw, prm[4], prm[5], prm[6], prm[7], prm[8], prm[9], prm[10], prm[11],
                 prm[12], prm[13], prm[14], prm[15], prm[16], prm[17]};
  const auto* hc = static_cast<const short2*>(hcoef);
  const auto* rw = static_cast<const int2*>(rows);
  const auto s = static_cast<cudaStream_t>(stream);
  if (sample_bytes == 1) {
    return full ? launch<uint8_t, true>(y, y_pitch, u, v, c_pitch, hpos, hc, rw, out, p, s)
                : launch<uint8_t, false>(y, y_pitch, u, v, c_pitch, hpos, hc, rw, out, p, s);
  }
  return full ? launch<uint16_t, true>(y, y_pitch, u, v, c_pitch, hpos, hc, rw, out, p, s)
              : launch<uint16_t, false>(y, y_pitch, u, v, c_pitch, hpos, hc, rw, out, p, s);
}
