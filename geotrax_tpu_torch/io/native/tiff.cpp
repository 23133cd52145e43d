// TIFF strip and tile decompression of geotrax_tpu_torch: LZW (TIFF 6.0,
// compression 5) and PackBits (32773), for io/tiff.py. Built with g++ at
// first use and bound with ctypes; a 15000^2 orthophoto holds 675 MB of
// samples, which a Python loop over LZW codes would take minutes to decode.
//
// C ABI:
//   long gtx_lzw_decode(const uint8_t* src, long n, uint8_t* dst, long cap)
//   long gtx_packbits_decode(const uint8_t* src, long n, uint8_t* dst, long cap)
//     Both write at most cap bytes and return how many they wrote, or < 0
//     on a malformed stream (-1: a code that is not in the table, -2: the
//     old-style LZW of TIFF 5.0).

#include <cstdint>
#include <cstring>

namespace {

constexpr int kClear = 256;
constexpr int kEoi = 257;
constexpr int kFirst = 258;
constexpr int kTable = 4096;

}  // namespace

extern "C" {

long gtx_lzw_decode(const uint8_t* src, long n, uint8_t* dst, long cap) {
  // the old-style LZW of TIFF 5.0 writes its codes LSB-first: its first
  // byte is the clear code's low byte (0), its second has bit 0 set
  if (n >= 2 && src[0] == 0 && (src[1] & 1)) return -2;
  // Every string of the table has been written to dst already: entry c is
  // the length[c] bytes at dst + start[c] (a new entry is the previous
  // code's string and the first byte after it), so emitting a code is a
  // copy within dst.
  long start[kTable];
  uint16_t length[kTable];
  int next = kFirst, width = 9, old = -1;
  long out = 0, in = 0, old_at = 0;
  uint64_t bits = 0;  // codes are MSB-first: the next code in the top of bits
  int nbits = 0;
  while (out < cap) {
    while (nbits < width && in < n) {
      bits |= static_cast<uint64_t>(src[in++]) << (56 - nbits);
      nbits += 8;
    }
    if (nbits < width) break;
    const int code = static_cast<int>(bits >> (64 - width));
    bits <<= width;
    nbits -= width;
    if (code == kEoi) break;
    if (code == kClear) {
      next = kFirst;
      width = 9;
      old = -1;
      continue;
    }
    const long old_len = old < 0 ? 0 : (old < 256 ? 1 : length[old]);
    long len;
    if (code < 256) {
      len = 1;
    } else if (old >= 0 && code < next) {
      len = length[code];
    } else if (old >= 0 && code == next && next < kTable) {  // KwKwK
      len = old_len + 1;
    } else {
      return -1;
    }
    if (old >= 0 && next < kTable) {  // the previous string + this one's first byte
      start[next] = old_at;
      length[next] = static_cast<uint16_t>(old_len + 1);
      ++next;
    }
    const long n_copy = out + len <= cap ? len : cap - out;
    if (code < 256) {
      dst[out] = static_cast<uint8_t>(code);
    } else if (start[code] + n_copy <= out) {
      std::memcpy(dst + out, dst + start[code], n_copy);
    } else {  // KwKwK overlaps its own output: copy forward byte by byte
      for (long i = 0; i < n_copy; ++i) dst[out + i] = dst[start[code] + i];
    }
    old_at = out;
    out += n_copy;
    old = code;
    // early change: the width grows one code before the table fills it
    if (next + 1 >= (1 << width) && width < 12) ++width;
  }
  return out;
}

long gtx_packbits_decode(const uint8_t* src, long n, uint8_t* dst, long cap) {
  long i = 0, out = 0;
  while (i < n && out < cap) {
    const int c = src[i++];
    if (c < 128) {  // c + 1 literal bytes
      long run = c + 1;
      if (i + run > n) run = n - i;
      if (out + run > cap) run = cap - out;
      std::memcpy(dst + out, src + i, run);
      out += run;
      i += c + 1;
    } else if (c > 128) {  // the next byte 257 - c times
      if (i >= n) break;
      long run = 257 - c;
      if (out + run > cap) run = cap - out;
      std::memset(dst + out, src[i], run);
      out += run;
      ++i;
    }  // 128: no operation
  }
  return out;
}

}  // extern "C"
