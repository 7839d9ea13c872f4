// Reverses the five PNG row filters (PNG specification, section 9) of a
// decompressed, non-interlaced image stream in one pass. Avg and Paeth
// depend on the byte just decoded to their left, so a row is sequential;
// this is io/png.py's "native" decoder, built with g++ at first use and
// called through ctypes.
#include <cstdint>
#include <cstdlib>
#include <cstring>

static inline uint8_t paeth(int a, int b, int c) {
    const int p = a + b - c;
    const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
    if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
    if (pb <= pc) return static_cast<uint8_t>(b);
    return static_cast<uint8_t>(c);
}

// src: height rows of (1 filter byte + row_bytes); dst: height * row_bytes.
// bpp: bytes per complete pixel (at least 1). Returns 0, or 1 + the index
// of the first row whose filter byte is not 0..4.
extern "C" int64_t png_unfilter(const uint8_t* src, uint8_t* dst, int64_t height,
                                int64_t row_bytes, int64_t bpp) {
    for (int64_t y = 0; y < height; ++y) {
        const uint8_t* in = src + y * (row_bytes + 1) + 1;
        const uint8_t filter = in[-1];
        uint8_t* out = dst + y * row_bytes;
        const uint8_t* up = y > 0 ? out - row_bytes : nullptr;
        switch (filter) {
            case 0:
                std::memcpy(out, in, row_bytes);
                break;
            case 1:
                for (int64_t x = 0; x < row_bytes; ++x)
                    out[x] = in[x] + (x >= bpp ? out[x - bpp] : 0);
                break;
            case 2:
                for (int64_t x = 0; x < row_bytes; ++x)
                    out[x] = in[x] + (up ? up[x] : 0);
                break;
            case 3:
                for (int64_t x = 0; x < row_bytes; ++x) {
                    const int left = x >= bpp ? out[x - bpp] : 0;
                    const int above = up ? up[x] : 0;
                    out[x] = in[x] + static_cast<uint8_t>((left + above) >> 1);
                }
                break;
            case 4:
                for (int64_t x = 0; x < row_bytes; ++x) {
                    const int left = x >= bpp ? out[x - bpp] : 0;
                    const int above = up ? up[x] : 0;
                    const int corner = (up && x >= bpp) ? up[x - bpp] : 0;
                    out[x] = in[x] + paeth(left, above, corner);
                }
                break;
            default:
                return y + 1;
        }
    }
    return 0;
}
