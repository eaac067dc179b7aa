// JAX's native host prep (native/skyeye_prep.cc): decode, letterbox and 4x4
// pack a batch of frames on a thread pool. Host code, no device code.
//
// JAX's library decodes with libjpeg and libpng, which the card's machine is
// not known to have, so this file decodes with the port's own codecs: JPEG
// with csrc/jpeg.cu in its lenient mode (libjpeg's reading of damaged data,
// progressive files, gray repeated, no EXIF orientation), PNG from image data
// that Python has already inflated (zlib lets go of the GIL there), unfiltered
// with csrc/png_unfilter.cu pass by pass (Adam7 included) and expanded as
// libpng's expand, strip_16, strip_alpha and gray_to_rgb give it. Then JAX's
// letterbox geometry (skyeye_prep.cc letterbox_into) into one NHWC uint8 RGB
// batch at pad 114, or that frame packed 4x4 space-to-depth for the packed
// stem. JAX's library was built with FMA contraction, so the sample positions,
// both horizontal lerps and the vertical blend are fmaf here; this file is
// built with -ffp-contract=off so that nothing else is fused.
// `data/native.py` binds it (ctypes) and holds the same algorithm in numpy.

#include <atomic>
#include <cmath>
#include <thread>

#include "jpeg.cu"
#include "png_unfilter.cu"

// One frame, as `data/native.py::_Source` lays it out. Outside the anonymous
// namespace: nvcc makes an extern "C" function internal when a type it takes
// is, and the library would then not export it.
struct SkyeyePrepSource {
    const uint8_t* data;  // a JPEG file, or a PNG's inflated image data
    int64_t size;
    int32_t kind;
    int32_t width, height, depth, color_type, interlace;  // a PNG's header
    const uint8_t* palette;  // a PNG's PLTE entries, 3 bytes each
    int32_t palette_size;
};

namespace {

const unsigned char kLetterboxPad = 114;
enum Kind { kFailed = 0, kJpeg = 1, kPng = 2 };
using Source = SkyeyePrepSource;

struct Image {
    std::vector<uint8_t> rgb;  // h x w x 3
    int h = 0, w = 0;
};

bool decode_jpeg(const Source& src, Image* im) {
    Decoder dec;
    dec.d = src.data;
    dec.n = src.size;
    dec.lenient = true;
    if (decode_coefficients(dec)) return false;
    im->w = dec.width;
    im->h = dec.height;
    im->rgb.resize((size_t)im->w * im->h * 3);
    if (reconstruct(dec, im->rgb.data())) return false;
    for (size_t i = 0; i < im->rgb.size(); i += 3) std::swap(im->rgb[i], im->rgb[i + 2]);
    return true;
}

const int kAdam7[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8}, {2, 0, 4, 4},
                          {0, 2, 2, 4}, {1, 0, 2, 2}, {0, 1, 1, 2}};

bool decode_png(const Source& src, Image* im) {
    const int w = src.width, h = src.height, depth = src.depth, ct = src.color_type;
    const int channels = ct == 0 || ct == 3 ? 1 : ct == 4 ? 2 : ct == 2 ? 3 : 4;
    const int bits = channels * depth, bpp = std::max(1, bits / 8);
    // the palette as libpng keeps it: 256 entries, those past PLTE black
    uint8_t palette[256 * 3] = {0};
    std::memcpy(palette, src.palette, (size_t)std::min(src.palette_size, 256) * 3);
    im->w = w;
    im->h = h;
    im->rgb.resize((size_t)w * h * 3);
    std::vector<uint8_t> rows;
    int64_t at = 0;
    for (int pass = 0; pass < (src.interlace ? 7 : 1); ++pass) {
        int x0 = 0, y0 = 0, dx = 1, dy = 1;
        if (src.interlace) {
            x0 = kAdam7[pass][0];
            y0 = kAdam7[pass][1];
            dx = kAdam7[pass][2];
            dy = kAdam7[pass][3];
        }
        const int pw = (w - x0 + dx - 1) / dx, ph = (h - y0 + dy - 1) / dy;
        if (pw <= 0 || ph <= 0) continue;
        const int stride = (int)(((int64_t)pw * bits + 7) / 8);
        const int64_t need = (int64_t)ph * (stride + 1);
        if (at + need > src.size) return false;  // libpng: not enough image data
        rows.resize((size_t)ph * stride);
        if (skyeye_png_unfilter(src.data + at, rows.data(), ph, stride, bpp)) return false;
        at += need;
        for (int y = 0; y < ph; ++y) {
            const uint8_t* row = rows.data() + (size_t)y * stride;
            for (int x = 0; x < pw; ++x) {
                int s[4];  // the pixel's samples, 8 bits each
                for (int c = 0; c < channels; ++c) {
                    const int i = x * channels + c;
                    if (depth == 16) {
                        s[c] = row[2 * i];  // strip_16: the high byte
                    } else if (depth == 8) {
                        s[c] = row[i];
                    } else {
                        const int bit = i * depth;
                        s[c] = (row[bit >> 3] >> (8 - depth - (bit & 7))) & ((1 << depth) - 1);
                        if (ct == 0) s[c] *= 255 / ((1 << depth) - 1);
                    }
                }
                uint8_t* dst = im->rgb.data() + ((size_t)(y0 + y * dy) * w + x0 + x * dx) * 3;
                if (ct == 3) {
                    std::memcpy(dst, palette + 3 * s[0], 3);
                } else if (ct == 0 || ct == 4) {
                    dst[0] = dst[1] = dst[2] = (uint8_t)s[0];
                } else {
                    dst[0] = (uint8_t)s[0];
                    dst[1] = (uint8_t)s[1];
                    dst[2] = (uint8_t)s[2];
                }
            }
        }
    }
    return true;
}

bool decode(const Source& src, Image* im) {
    if (src.kind == kJpeg) return decode_jpeg(src, im);
    if (src.kind == kPng) return decode_png(src, im);
    return false;
}

// skyeye_prep.cc's letterbox_into: bilinear resize with half-pixel centres and
// a centred pad of 114 into out (out_h, out_w, 3); meta [gain, dw, dh].
void letterbox_into(const Image& im, uint8_t* out, int out_h, int out_w, float* meta) {
    const float r = std::min(static_cast<float>(out_h) / im.h, static_cast<float>(out_w) / im.w);
    const int new_w = static_cast<int>(std::lround(im.w * r));
    const int new_h = static_cast<int>(std::lround(im.h * r));
    const float dw = (out_w - new_w) / 2.0f;
    const float dh = (out_h - new_h) / 2.0f;
    const int x0 = static_cast<int>(std::lround(dw - 0.1f));
    const int y0 = static_cast<int>(std::lround(dh - 0.1f));

    std::memset(out, kLetterboxPad, (size_t)out_h * out_w * 3);

    const float sx = static_cast<float>(im.w) / new_w;
    const float sy = static_cast<float>(im.h) / new_h;
    std::vector<int> ix0(new_w), ix1(new_w);
    std::vector<float> wx(new_w);
    for (int x = 0; x < new_w; ++x) {
        const float fx = fmaf(x + 0.5f, sx, -0.5f);
        ix0[x] = std::max(0, std::min(im.w - 1, static_cast<int>(fx)));
        ix1[x] = std::min(im.w - 1, ix0[x] + 1);
        wx[x] = std::max(0.0f, std::min(1.0f, fx - ix0[x]));
    }
    for (int y = 0; y < new_h; ++y) {
        const float fy = fmaf(y + 0.5f, sy, -0.5f);
        const int iy0 = std::max(0, std::min(im.h - 1, static_cast<int>(fy)));
        const int iy1 = std::min(im.h - 1, iy0 + 1);
        const float wy = std::max(0.0f, std::min(1.0f, fy - iy0));
        uint8_t* dst = out + ((size_t)(y + y0) * out_w + x0) * 3;
        const uint8_t* row0 = im.rgb.data() + (size_t)iy0 * im.w * 3;
        const uint8_t* row1 = im.rgb.data() + (size_t)iy1 * im.w * 3;
        for (int x = 0; x < new_w; ++x) {
            const int a = ix0[x] * 3, b = ix1[x] * 3;
            for (int c = 0; c < 3; ++c) {
                const float top = fmaf(wx[x], (float)(row0[b + c] - row0[a + c]), row0[a + c]);
                const float bot = fmaf(wx[x], (float)(row1[b + c] - row1[a + c]), row1[a + c]);
                dst[x * 3 + c] = static_cast<uint8_t>(fmaf(wy, bot - top, top) + 0.5f);
            }
        }
    }
    if (meta) {
        meta[0] = r;
        meta[1] = dw;
        meta[2] = dh;
    }
}

// (S, S, 3) -> (S/4, S/4, 48), channel (dy * 4 + dx) * 3 + c
void s2d4_pack(const uint8_t* frame, uint8_t* out, int s) {
    const int q = s / 4;
    for (int oy = 0; oy < q; ++oy)
        for (int dy = 0; dy < 4; ++dy) {
            const uint8_t* src_row = frame + ((size_t)oy * 4 + dy) * s * 3;
            for (int ox = 0; ox < q; ++ox)
                std::memcpy(out + ((size_t)oy * q + ox) * 48 + dy * 12, src_row + (size_t)ox * 12,
                            12);
        }
}

}  // namespace

// n frames into out: n x out_h x out_w x 3 RGB bytes, or with s2d4 (out_h ==
// out_w, a multiple of 4) n x out_h/4 x out_w/4 x 48; meta: n x 3 floats, the
// caller's zeros. A frame that does not decode is zeroed and its meta[0] set to
// 0. Workers: max(1, min(n_threads or 8, n)), over an atomic index. Returns the
// number of frames decoded.
extern "C" int skyeye_prep_batch(const SkyeyePrepSource* src, int n, uint8_t* out, int out_h,
                                 int out_w, int n_threads, float* meta, int s2d4) {
    if (n <= 0 || (s2d4 && (out_h != out_w || out_h % 4))) return 0;
    const size_t frame = (size_t)out_h * out_w * 3;
    std::atomic<int> next(0), ok(0);
    const int workers = std::max(1, std::min(n_threads > 0 ? n_threads : 8, n));
    auto work = [&]() {
        std::vector<uint8_t> scratch(s2d4 ? frame : 0);
        for (;;) {
            const int i = next.fetch_add(1);
            if (i >= n) break;
            Image im;
            uint8_t* dst = out + frame * i;
            if (decode(src[i], &im) && im.w > 0 && im.h > 0) {
                uint8_t* target = s2d4 ? scratch.data() : dst;
                letterbox_into(im, target, out_h, out_w, meta ? meta + 3 * i : nullptr);
                if (s2d4) s2d4_pack(target, dst, out_h);
                ok.fetch_add(1);
            } else {
                std::memset(dst, 0, frame);
                if (meta) meta[3 * i] = 0.0f;
            }
        }
    };
    std::vector<std::thread> pool;
    pool.reserve(workers - 1);
    for (int t = 1; t < workers; ++t) pool.emplace_back(work);
    work();
    for (auto& t : pool) t.join();
    return ok.load();
}

// The decoded frame's size: 0 and *h, *w, or -1 where it does not decode.
extern "C" int skyeye_decode_shape(const SkyeyePrepSource* src, int* h, int* w) {
    Image im;
    if (!decode(*src, &im)) return -1;
    *h = im.h;
    *w = im.w;
    return 0;
}
