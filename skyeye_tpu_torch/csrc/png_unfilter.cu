// PNG scanline unfiltering: host code, no device code.
//
// A PNG's inflated image data is `height` rows of one filter-type byte and
// `stride` filtered bytes. Filters 3 (Average) and 4 (Paeth) predict each byte
// from the byte one pixel to the left, already unfiltered, so a row cannot be
// vectorised along its length; this loop is the port's decoder for them
// (`data/imageio.py`, whose `unfilter_plain` is the same arithmetic in numpy).
// Built by `ops/cuda_build.py` like the kernels, with a plain C interface.

#include <cstdint>
#include <cstdlib>

static inline int paeth(int a, int b, int c) {
    int p = a + b - c;
    int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
    if (pa <= pb && pa <= pc) return a;
    return pb <= pc ? b : c;
}

// src: height x (1 + stride) bytes; dst: height x stride bytes; bpp: bytes a
// complete pixel spans, at least 1. Returns 0, or 1 + the first row whose
// filter type is not 0-4 (dst is then undefined from that row on).
extern "C" int skyeye_png_unfilter(const uint8_t* src, uint8_t* dst, int height,
                                   int stride, int bpp) {
    for (int y = 0; y < height; ++y) {
        const uint8_t* in = src + (size_t)y * (stride + 1);
        const int type = in[0];
        ++in;
        uint8_t* out = dst + (size_t)y * stride;
        const uint8_t* up = y ? out - stride : nullptr;
        switch (type) {
            case 0:
                for (int x = 0; x < stride; ++x) out[x] = in[x];
                break;
            case 1:
                for (int x = 0; x < stride; ++x)
                    out[x] = (uint8_t)(in[x] + (x >= bpp ? out[x - bpp] : 0));
                break;
            case 2:
                for (int x = 0; x < stride; ++x) out[x] = (uint8_t)(in[x] + (up ? up[x] : 0));
                break;
            case 3:
                for (int x = 0; x < stride; ++x) {
                    int a = x >= bpp ? out[x - bpp] : 0, b = up ? up[x] : 0;
                    out[x] = (uint8_t)(in[x] + ((a + b) >> 1));
                }
                break;
            case 4:
                for (int x = 0; x < stride; ++x) {
                    int a = x >= bpp ? out[x - bpp] : 0, b = up ? up[x] : 0;
                    int c = (up && x >= bpp) ? up[x - bpp] : 0;
                    out[x] = (uint8_t)(in[x] + paeth(a, b, c));
                }
                break;
            default:
                return y + 1;
        }
    }
    return 0;
}
