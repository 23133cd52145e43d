// PNG scanline unfiltering for the port's PNG reader (io/png.py).
//
// Input: the inflated IDAT stream of a non-interlaced image, `height` rows
// of one filter-type byte followed by `stride` bytes. Output: the `height`
// x `stride` raw bytes. `bpp` is the number of bytes per complete pixel
// (at least 1), the distance the Sub, Average and Paeth filters look left.
// Returns 0, or -(row + 1) for a row whose filter type is not 0-4.

#include <cstdint>
#include <cstdlib>
#include <cstring>

static inline uint8_t paeth(int a, int b, int c) {
    int p = a + b - c;
    int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
    if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
    if (pb <= pc) return static_cast<uint8_t>(b);
    return static_cast<uint8_t>(c);
}

extern "C" long gtx_png_unfilter(const uint8_t* src, uint8_t* dst, long height, long stride,
                                 int bpp) {
    const uint8_t* prev = nullptr;  // the previous raw row (none above row 0)
    for (long y = 0; y < height; ++y) {
        const uint8_t* in = src + y * (stride + 1);
        uint8_t* out = dst + y * stride;
        const uint8_t type = in[0];
        ++in;
        switch (type) {
            case 0:
                std::memcpy(out, in, stride);
                break;
            case 1:
                for (long x = 0; x < stride; ++x)
                    out[x] = static_cast<uint8_t>(in[x] + (x >= bpp ? out[x - bpp] : 0));
                break;
            case 2:
                for (long x = 0; x < stride; ++x)
                    out[x] = static_cast<uint8_t>(in[x] + (prev ? prev[x] : 0));
                break;
            case 3:
                for (long x = 0; x < stride; ++x) {
                    int left = x >= bpp ? out[x - bpp] : 0;
                    int up = prev ? prev[x] : 0;
                    out[x] = static_cast<uint8_t>(in[x] + ((left + up) >> 1));
                }
                break;
            case 4:
                for (long x = 0; x < stride; ++x) {
                    int left = x >= bpp ? out[x - bpp] : 0;
                    int up = prev ? prev[x] : 0;
                    int upleft = (prev && x >= bpp) ? prev[x - bpp] : 0;
                    out[x] = static_cast<uint8_t>(in[x] + paeth(left, up, upleft));
                }
                break;
            default:
                return -(y + 1);
        }
        prev = out;
    }
    return 0;
}
