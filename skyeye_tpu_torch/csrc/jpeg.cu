// JPEG decode and encode as libjpeg-turbo does them for OpenCV: host code, no
// device code.
//
// `cv2.imread`/`cv2.imwrite` reach libjpeg-turbo, whose default paths are
// integer arithmetic: the ISLOW inverse and forward DCTs (jidctint.c,
// jfdctint.c), fancy upsampling (jdsample.c), the fixed-point colour tables
// (jdcolor.c, jccolor.c), the h2v2 downsample (jcsample.c) and the
// reciprocal quantisation (jcdctmgr.c). This file repeats them, so that the
// port reads the pixels and writes the bytes that OpenCV does, on a machine
// with no libjpeg. `data/jpeg.py` holds the same algorithm in numpy
// (`decode_plain`, `encode_plain`) and the rules it follows; the two agree
// bit for bit and byte for byte. Huffman decoding is sequential, so this is
// host code; it replaces no TPU kernel (JAX reads JPEG through cv2 on the
// host too). Built by `ops/cuda_build.py` like the kernels, with a plain C
// interface.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

enum Status { kOk = 0, kTruncated = 1, kCorrupt = 2, kUnsupported = 3 };

// the natural index of each zigzag position, and 16 entries of 63 past the end
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

const int CONST_BITS = 13, PASS1_BITS = 2, SCALEBITS = 16;
const int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
              FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
              FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
              FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + ((int64_t)1 << (n - 1))) >> n; }
inline int fix16(double x) { return (int)(x * (1 << SCALEBITS) + 0.5); }
inline int clamp255(int64_t v) { return v < 0 ? 0 : (v > 255 ? 255 : (int)v); }

// ---- decoding ----------------------------------------------------------------------

struct Huff {
    std::vector<uint16_t> lut;  // per 16-bit window: (length << 8) | symbol, 0: no code
};

struct Comp {
    int id = 0, h = 1, v = 1, tq = 0;
    int bw = 0, bh = 0;            // blocks allocated (MCU padding included)
    std::vector<int32_t> coef;     // bh * bw * 64, natural order
};

struct Decoder {
    const uint8_t* d;
    int64_t n;
    int width = 0, height = 0, hmax = 1, vmax = 1;
    bool have_frame = false, jfif = false;
    int adobe = -1;
    std::vector<Comp> comps;
    int64_t quant[4][64];
    bool quant_defined[4] = {false, false, false, false};
    Huff huff[2][4];
    int restart = 0;
};

// One marker segment at pos: the marker, its payload [*p, *p + *len), and the
// position after it; fill bytes before the marker skipped.
int segment(const Decoder& dec, int64_t pos, int* marker, int64_t* p, int64_t* len,
            int64_t* next) {
    if (pos >= dec.n) return kTruncated;
    if (dec.d[pos] != 0xFF) return kCorrupt;
    while (pos + 1 < dec.n && dec.d[pos + 1] == 0xFF) ++pos;
    if (pos + 1 >= dec.n) return kTruncated;
    int m = dec.d[pos + 1];
    *marker = m;
    if (m == 0x01 || m == 0xD8 || m == 0xD9 || (m >= 0xD0 && m <= 0xD7)) {
        *p = pos + 2;
        *len = 0;
        *next = pos + 2;
        return kOk;
    }
    if (pos + 4 > dec.n) return kTruncated;
    int length = (dec.d[pos + 2] << 8) | dec.d[pos + 3];
    if (length < 2 || pos + 2 + length > dec.n) return kTruncated;
    *p = pos + 4;
    *len = length - 2;
    *next = pos + 2 + length;
    return kOk;
}

int parse_sof(Decoder& dec, const uint8_t* s, int64_t len, int marker) {
    if (marker != 0xC0 && marker != 0xC1) return kUnsupported;
    if (len < 6) return kTruncated;
    if (s[0] != 8) return kUnsupported;
    dec.height = (s[1] << 8) | s[2];
    dec.width = (s[3] << 8) | s[4];
    int nc = s[5];
    if (dec.width == 0 || dec.height == 0 || (nc != 1 && nc != 3) || len < 6 + 3 * nc)
        return kCorrupt;
    dec.comps.assign(nc, Comp());
    for (int i = 0; i < nc; ++i) {
        Comp& c = dec.comps[i];
        c.id = s[6 + 3 * i];
        c.h = s[7 + 3 * i] >> 4;
        c.v = s[7 + 3 * i] & 15;
        c.tq = s[8 + 3 * i];
        if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) return kCorrupt;
        dec.hmax = std::max(dec.hmax, c.h);
        dec.vmax = std::max(dec.vmax, c.v);
    }
    int mcux = (dec.width + 8 * dec.hmax - 1) / (8 * dec.hmax);
    int mcuy = (dec.height + 8 * dec.vmax - 1) / (8 * dec.vmax);
    for (Comp& c : dec.comps) {
        if (dec.hmax % c.h || dec.vmax % c.v) return kCorrupt;
        c.bw = mcux * c.h;
        c.bh = mcuy * c.v;
        c.coef.assign((size_t)c.bw * c.bh * 64, 0);
    }
    dec.have_frame = true;
    return kOk;
}

int parse_dht(Decoder& dec, const uint8_t* s, int64_t len) {
    int64_t pos = 0;
    while (pos < len) {
        if (pos + 17 > len) return kCorrupt;
        int tc = s[pos] >> 4, th = s[pos] & 15;
        if (tc > 1 || th > 3) return kCorrupt;
        const uint8_t* counts = s + pos + 1;
        int total = 0;
        for (int i = 0; i < 16; ++i) total += counts[i];
        if (pos + 17 + total > len) return kCorrupt;
        const uint8_t* symbols = s + pos + 17;
        std::vector<uint16_t>& lut = dec.huff[tc][th].lut;
        lut.assign(1 << 16, 0);
        int code = 0, k = 0;
        for (int length = 1; length <= 16; ++length) {
            for (int i = 0; i < counts[length - 1]; ++i) {
                int64_t lo = (int64_t)code << (16 - length);
                int64_t hi = lo + ((int64_t)1 << (16 - length));
                if (hi > (1 << 16)) return kCorrupt;
                for (int64_t w = lo; w < hi; ++w) lut[w] = (uint16_t)((length << 8) | symbols[k]);
                ++code;
                ++k;
            }
            code <<= 1;
        }
        pos += 17 + total;
    }
    return kOk;
}

int parse_dqt(Decoder& dec, const uint8_t* s, int64_t len) {
    int64_t pos = 0;
    while (pos < len) {
        int pq = s[pos] >> 4, tq = s[pos] & 15;
        int size = pq ? 128 : 64;
        if (pq > 1 || tq > 3 || pos + 1 + size > len) return kCorrupt;
        for (int i = 0; i < 64; ++i) {
            int v = pq ? (s[pos + 1 + 2 * i] << 8) | s[pos + 2 + 2 * i] : s[pos + 1 + i];
            dec.quant[tq][kNatural[i]] = v;
        }
        dec.quant_defined[tq] = true;
        pos += 1 + size;
    }
    return kOk;
}

const int kPad = 512;  // zero bytes after a segment: more than one block can read

struct Bits {
    const uint8_t* s;
    int64_t p = 0;  // bit position
    inline uint32_t word(int64_t i) const {
        return ((uint32_t)s[i] << 24) | ((uint32_t)s[i + 1] << 16) | ((uint32_t)s[i + 2] << 8) |
               s[i + 3];
    }
    inline int peek16() const { return (word(p >> 3) >> (16 - (p & 7))) & 0xFFFF; }
    inline int get(int n) {
        int v = (word(p >> 3) >> (32 - n - (p & 7))) & ((1u << n) - 1);
        p += n;
        return v;
    }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

// The scan's entropy-coded data from pos, unstuffed, split at its restart
// markers (each piece followed by kPad zeros); *end: the marker ending the scan.
int entropy_segments(const Decoder& dec, int64_t pos, std::vector<uint8_t>* buf,
                     std::vector<int64_t>* starts, std::vector<int64_t>* lens, int64_t* end) {
    buf->clear();
    starts->assign(1, 0);
    lens->clear();
    const uint8_t* d = dec.d;
    auto close_piece = [&]() {
        lens->push_back((int64_t)buf->size() - starts->back());
        buf->insert(buf->end(), kPad, 0);
    };
    int64_t i = pos;
    while (true) {
        if (i >= dec.n) return kTruncated;
        uint8_t b = d[i];
        if (b != 0xFF) {
            buf->push_back(b);
            ++i;
            continue;
        }
        if (i + 1 >= dec.n) return kTruncated;
        uint8_t m = d[i + 1];
        if (m == 0x00) {
            buf->push_back(0xFF);
            i += 2;
        } else if (m == 0xFF) {
            ++i;  // a fill byte
        } else if (m >= 0xD0 && m <= 0xD7) {
            close_piece();
            starts->push_back((int64_t)buf->size());
            i += 2;
        } else {
            close_piece();
            *end = i;
            return kOk;
        }
    }
}

int decode_scan(Decoder& dec, const uint8_t* s, int64_t len, int64_t pos, int64_t* end) {
    if (!dec.have_frame || len < 1) return kCorrupt;
    int ns = s[0];
    if (ns < 1 || ns > 4 || len < 4 + 2 * ns) return kCorrupt;
    Comp* comp[4];
    const Huff* dc[4];
    const Huff* ac[4];
    for (int i = 0; i < ns; ++i) {
        int id = s[1 + 2 * i], tables = s[2 + 2 * i];
        comp[i] = nullptr;
        for (Comp& c : dec.comps)
            if (c.id == id) comp[i] = &c;
        if (!comp[i]) return kCorrupt;
        int td = tables >> 4, ta = tables & 15;
        if (td > 3 || ta > 3 || dec.huff[0][td].lut.empty() || dec.huff[1][ta].lut.empty())
            return kCorrupt;
        dc[i] = &dec.huff[0][td];
        ac[i] = &dec.huff[1][ta];
    }
    if (s[1 + 2 * ns] != 0 || s[2 + 2 * ns] != 63 || s[3 + 2 * ns] != 0) return kUnsupported;

    std::vector<uint8_t> buf;
    std::vector<int64_t> starts, lens;
    int rc = entropy_segments(dec, pos, &buf, &starts, &lens, end);
    if (rc) return rc;

    int mcux, mcuy;
    // (component in scan, block row, block column) of each block of an MCU
    std::vector<int> blk_k, blk_y, blk_x;
    if (ns == 1) {
        const Comp& c = *comp[0];
        int dw = (dec.width * c.h + dec.hmax - 1) / dec.hmax;
        int dh = (dec.height * c.v + dec.vmax - 1) / dec.vmax;
        mcux = (dw + 7) / 8;
        mcuy = (dh + 7) / 8;
        blk_k.push_back(0);
        blk_y.push_back(0);
        blk_x.push_back(0);
    } else {
        mcux = (dec.width + 8 * dec.hmax - 1) / (8 * dec.hmax);
        mcuy = (dec.height + 8 * dec.vmax - 1) / (8 * dec.vmax);
        for (int k = 0; k < ns; ++k)
            for (int y = 0; y < comp[k]->v; ++y)
                for (int x = 0; x < comp[k]->h; ++x) {
                    blk_k.push_back(k);
                    blk_y.push_back(y);
                    blk_x.push_back(x);
                }
    }
    int64_t n_mcu = (int64_t)mcux * mcuy;
    int64_t per = dec.restart ? dec.restart : n_mcu;
    if ((int64_t)starts.size() < (n_mcu + per - 1) / per) return kTruncated;
    for (int64_t m0 = 0; m0 < n_mcu; m0 += per) {
        int64_t seg = m0 / per;
        Bits bits{buf.data() + starts[seg]};
        const int64_t limit = 8 * (lens[seg] + 4);
        int pred[4] = {0, 0, 0, 0};
        for (int64_t m = m0; m < std::min(m0 + per, n_mcu); ++m) {
            int64_t my = m / mcux, mx = m % mcux;
            for (size_t b = 0; b < blk_k.size(); ++b) {
                int k = blk_k[b];
                Comp& c = *comp[k];
                int h = ns == 1 ? 1 : c.h, v = ns == 1 ? 1 : c.v;
                int32_t* out = c.coef.data() +
                               ((my * v + blk_y[b]) * c.bw + mx * h + blk_x[b]) * 64;
                int e = dc[k]->lut[bits.peek16()];
                if (!e) return kCorrupt;
                bits.p += e >> 8;
                int t = e & 255;
                pred[k] += t ? extend(bits.get(t), t) : 0;
                out[0] = pred[k];
                for (int j = 1; j < 64;) {
                    e = ac[k]->lut[bits.peek16()];
                    if (!e) return kCorrupt;
                    bits.p += e >> 8;
                    int r = (e & 255) >> 4;
                    t = e & 15;
                    if (t) {
                        j += r;
                        out[kNatural[j]] = extend(bits.get(t), t);
                        ++j;
                    } else if (r == 15) {
                        j += 16;
                    } else {
                        break;
                    }
                }
                if (bits.p > limit) return kCorrupt;  // the data ran out inside a block
            }
        }
    }
    return kOk;
}

void idct_1d(const int64_t s[8], int64_t out[8]) {
    int64_t z2 = s[2], z3 = s[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (s[0] + s[4]) * ((int64_t)1 << CONST_BITS);
    int64_t tmp1 = (s[0] - s[4]) * ((int64_t)1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

    int64_t t0 = s[7], t1 = s[5], t2 = s[3], t3 = s[1];
    z1 = t0 + t3;
    z2 = t1 + t2;
    z3 = t0 + t2;
    int64_t z4 = t1 + t3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    t0 *= FIX_0_298631336;
    t1 *= FIX_2_053119869;
    t2 *= FIX_3_072711026;
    t3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 = z3 * -FIX_1_961570560 + z5;
    z4 = z4 * -FIX_0_390180644 + z5;
    t0 += z1 + z3;
    t1 += z2 + z4;
    t2 += z2 + z3;
    t3 += z1 + z4;
    out[0] = tmp10 + t3;
    out[7] = tmp10 - t3;
    out[1] = tmp11 + t2;
    out[6] = tmp11 - t2;
    out[2] = tmp12 + t1;
    out[5] = tmp12 - t1;
    out[3] = tmp13 + t0;
    out[4] = tmp13 - t0;
}

// jpeg_idct_islow: one block of quantised coefficients -> 8x8 samples at dst
void idct_islow(const int32_t* coef, const int64_t* q, uint8_t* dst, int stride) {
    int64_t ws[64], in[8], out[8];
    for (int col = 0; col < 8; ++col) {  // pass 1: down each column
        for (int k = 0; k < 8; ++k) in[k] = (int64_t)coef[8 * k + col] * q[8 * k + col];
        idct_1d(in, out);
        for (int k = 0; k < 8; ++k) ws[8 * k + col] = (int)descale(out[k], CONST_BITS - PASS1_BITS);
    }
    for (int row = 0; row < 8; ++row) {  // pass 2: along each row
        idct_1d(ws + 8 * row, out);
        for (int k = 0; k < 8; ++k) {
            int64_t v = descale(out[k], CONST_BITS + PASS1_BITS + 3);
            v = ((v + 512) & 1023) - 512;  // the range-limit table's 10-bit wrap
            dst[row * stride + k] = (uint8_t)clamp255(v + 128);
        }
    }
}

// libjpeg-turbo's upsampler from a dw x dh plane to the w x h image grid
void upsample(const uint8_t* p, int dw, int dh, int sh, int sv, uint8_t* out, int w, int h) {
    auto at = [&](int y, int x) -> int {
        y = std::min(std::max(y, 0), dh - 1);
        x = std::min(std::max(x, 0), dw - 1);
        return p[(size_t)y * dw + x];
    };
    if (sh == 2 && sv == 2 && dw > 2) {
        std::vector<int> sums((size_t)2 * dw);
        for (int y = 0; y < h; ++y) {
            int i = y >> 1, other = (y & 1) ? i + 1 : i - 1;
            for (int x = 0; x < dw; ++x) sums[x] = 3 * at(i, x) + at(other, x);
            for (int x = 0; x < w; ++x) {
                int j = x >> 1;
                int cs = sums[j];
                int nb = sums[std::min(std::max((x & 1) ? j + 1 : j - 1, 0), dw - 1)];
                out[(size_t)y * w + x] = (uint8_t)((3 * cs + nb + ((x & 1) ? 7 : 8)) >> 4);
            }
        }
    } else if (sh == 2 && sv == 1 && dw > 2) {
        for (int y = 0; y < h; ++y)
            for (int x = 0; x < w; ++x) {
                int j = x >> 1;
                int nb = at(y, (x & 1) ? j + 1 : j - 1);
                out[(size_t)y * w + x] = (uint8_t)((3 * at(y, j) + nb + ((x & 1) ? 2 : 1)) >> 2);
            }
    } else if (sh == 1 && sv == 2) {
        for (int y = 0; y < h; ++y) {
            int i = y >> 1;
            for (int x = 0; x < w; ++x) {
                int nb = at((y & 1) ? i + 1 : i - 1, x);
                out[(size_t)y * w + x] = (uint8_t)((3 * at(i, x) + nb + ((y & 1) ? 2 : 1)) >> 2);
            }
        }
    } else {  // full size, or box replication
        for (int y = 0; y < h; ++y)
            for (int x = 0; x < w; ++x) out[(size_t)y * w + x] = (uint8_t)at(y / sv, x / sh);
    }
}

int reconstruct(const Decoder& dec, uint8_t* bgr) {
    const int w = dec.width, h = dec.height;
    std::vector<std::vector<uint8_t>> planes;
    for (const Comp& c : dec.comps) {
        if (!dec.quant_defined[c.tq]) return kCorrupt;
        int pw = c.bw * 8;
        std::vector<uint8_t> plane((size_t)c.bh * 8 * pw);
        for (int by = 0; by < c.bh; ++by)
            for (int bx = 0; bx < c.bw; ++bx)
                idct_islow(c.coef.data() + ((size_t)by * c.bw + bx) * 64, dec.quant[c.tq],
                           plane.data() + (size_t)by * 8 * pw + bx * 8, pw);
        int dw = (w * c.h + dec.hmax - 1) / dec.hmax, dh = (h * c.v + dec.vmax - 1) / dec.vmax;
        std::vector<uint8_t> cropped((size_t)dw * dh);
        for (int y = 0; y < dh; ++y)
            std::memcpy(cropped.data() + (size_t)y * dw, plane.data() + (size_t)y * pw, dw);
        std::vector<uint8_t> full((size_t)w * h);
        upsample(cropped.data(), dw, dh, dec.hmax / c.h, dec.vmax / c.v, full.data(), w, h);
        planes.push_back(std::move(full));
    }
    const size_t n = (size_t)w * h;
    if (planes.size() == 1) {
        for (size_t i = 0; i < n; ++i) bgr[3 * i] = bgr[3 * i + 1] = bgr[3 * i + 2] = planes[0][i];
        return kOk;
    }
    // jdapimin.c's guess: JFIF means YCbCr, else Adobe's transform flag, else the ids
    bool rgb = !dec.jfif && (dec.adobe == 0 || (dec.adobe < 0 && dec.comps[0].id == 82 &&
                                                 dec.comps[1].id == 71 && dec.comps[2].id == 66));
    if (rgb) {
        for (size_t i = 0; i < n; ++i) {
            bgr[3 * i] = planes[2][i];
            bgr[3 * i + 1] = planes[1][i];
            bgr[3 * i + 2] = planes[0][i];
        }
        return kOk;
    }
    const int64_t half = (int64_t)1 << (SCALEBITS - 1);
    const int64_t cr_r = fix16(1.40200), cb_b = fix16(1.77200);
    const int64_t cb_g = -fix16(0.34414), cr_g = -fix16(0.71414);
    for (size_t i = 0; i < n; ++i) {
        int64_t y = planes[0][i], xb = planes[1][i] - 128, xr = planes[2][i] - 128;
        bgr[3 * i + 2] = (uint8_t)clamp255(y + ((cr_r * xr + half) >> SCALEBITS));
        bgr[3 * i + 1] = (uint8_t)clamp255(y + ((cb_g * xb + half + cr_g * xr) >> SCALEBITS));
        bgr[3 * i] = (uint8_t)clamp255(y + ((cb_b * xb + half) >> SCALEBITS));
    }
    return kOk;
}

// ---- encoding ----------------------------------------------------------------------

const uint8_t kStdHuffman[4][16 + 162] = {  // DC luma, AC luma, DC chroma, AC chroma
    {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11},
    {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d,
     0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
     0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
     0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
     0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
     0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
     0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
     0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
     0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
     0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
     0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
     0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa},
    {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11},
    {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77,
     0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
     0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
     0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
     0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
     0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
     0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
     0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
     0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
     0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
     0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
     0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa}};

const int kStdQuant[2][64] = {
    {16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
     14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
     18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
     49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99},
    {17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
     24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
     99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
     99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99}};

int huff_count(const uint8_t* spec) {
    int n = 0;
    for (int i = 0; i < 16; ++i) n += spec[i];
    return n;
}

struct Writer {
    uint8_t* out;
    int64_t cap, n = 0;
    uint64_t acc = 0;  // pending bits, right-aligned
    int nbits = 0;
    bool overflow = false;
    void byte(uint8_t b) {
        if (n < cap) out[n] = b;
        else overflow = true;
        ++n;
    }
    void bytes(const uint8_t* b, int64_t k) {
        for (int64_t i = 0; i < k; ++i) byte(b[i]);
    }
    void put(uint32_t v, int k) {  // MSB first, 0xFF stuffed
        if (!k) return;
        acc = (acc << k) | (v & ((1u << k) - 1));
        nbits += k;
        while (nbits >= 8) {
            uint8_t b = (uint8_t)(acc >> (nbits - 8));
            byte(b);
            if (b == 0xFF) byte(0);
            nbits -= 8;
        }
    }
    void flush() {  // pad with 1s to a byte
        if (nbits) put(0x7F, 8 - nbits);
    }
};

struct Code {
    uint16_t code[256];
    uint8_t len[256];
};

void make_code(const uint8_t* spec, Code* c) {
    std::memset(c->len, 0, sizeof(c->len));
    int code = 0, k = 0;
    for (int length = 1; length <= 16; ++length) {
        for (int i = 0; i < spec[length - 1]; ++i) {
            int sym = spec[16 + k++];
            c->code[sym] = (uint16_t)code++;
            c->len[sym] = (uint8_t)length;
        }
        code <<= 1;
    }
}

void fdct_1d(int64_t* d, int step, bool final_pass) {
    int64_t d0 = d[0], d1 = d[step], d2 = d[2 * step], d3 = d[3 * step];
    int64_t d4 = d[4 * step], d5 = d[5 * step], d6 = d[6 * step], d7 = d[7 * step];
    int64_t tmp0 = d0 + d7, tmp7 = d0 - d7, tmp1 = d1 + d6, tmp6 = d1 - d6;
    int64_t tmp2 = d2 + d5, tmp5 = d2 - d5, tmp3 = d3 + d4, tmp4 = d3 - d4;
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    const int shift = final_pass ? CONST_BITS + PASS1_BITS : CONST_BITS - PASS1_BITS;
    if (final_pass) {
        d[0] = descale(tmp10 + tmp11, PASS1_BITS);
        d[4 * step] = descale(tmp10 - tmp11, PASS1_BITS);
    } else {
        d[0] = (tmp10 + tmp11) * (1 << PASS1_BITS);
        d[4 * step] = (tmp10 - tmp11) * (1 << PASS1_BITS);
    }
    int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    d[2 * step] = descale(z1 + tmp13 * FIX_0_765366865, shift);
    d[6 * step] = descale(z1 + tmp12 * -FIX_1_847759065, shift);
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 = z3 * -FIX_1_961570560 + z5;
    z4 = z4 * -FIX_0_390180644 + z5;
    d[7 * step] = descale(tmp4 + z1 + z3, shift);
    d[5 * step] = descale(tmp5 + z2 + z4, shift);
    d[3 * step] = descale(tmp6 + z2 + z3, shift);
    d[step] = descale(tmp7 + z1 + z4, shift);
}

// compute_reciprocal (jcdctmgr.c) for divisor = quant << 3
struct Recip {
    int64_t fq, c;
    int r;
};

Recip reciprocal(int divisor) {
    int b = 0;
    while ((2 << b) <= divisor) ++b;  // flss(divisor) - 1
    int r = 16 + b;
    int64_t fq = ((int64_t)1 << r) / divisor, fr = ((int64_t)1 << r) % divisor;
    int64_t c = divisor / 2;
    if (fr == 0) {
        fq >>= 1;
        --r;
    } else if (fr <= divisor / 2) {
        ++c;
    } else {
        ++fq;
    }
    return {fq, c, r};
}

struct Plane {
    int h, v, table;
    int rows, cols;          // blocks in the image
    int alloc_rows, alloc_cols;
    std::vector<int32_t> coef;  // alloc_rows * alloc_cols * 64, natural order
};

// samples (srows x scols, already edge-extended to whole blocks) -> quantised blocks
void plane_coefficients(const std::vector<int>& samples, int scols, const Recip* recip,
                        Plane* p) {
    p->coef.assign((size_t)p->alloc_rows * p->alloc_cols * 64, 0);
    int64_t blk[64];
    for (int by = 0; by < p->rows; ++by)
        for (int bx = 0; bx < p->cols; ++bx) {
            for (int y = 0; y < 8; ++y)
                for (int x = 0; x < 8; ++x)
                    blk[8 * y + x] = samples[(size_t)(by * 8 + y) * scols + bx * 8 + x] - 128;
            for (int y = 0; y < 8; ++y) fdct_1d(blk + 8 * y, 1, false);  // rows
            for (int x = 0; x < 8; ++x) fdct_1d(blk + x, 8, true);       // columns
            int32_t* out = p->coef.data() + ((size_t)by * p->alloc_cols + bx) * 64;
            for (int i = 0; i < 64; ++i) {
                int64_t t = blk[i];
                int64_t a = t < 0 ? -t : t;
                int64_t q = ((a + recip[i].c) * recip[i].fq) >> recip[i].r;
                out[i] = (int32_t)(t < 0 ? -q : q);
            }
        }
}

// jccoefct.c's dummy blocks of the MCU padding: right of the image a block takes
// its left neighbour's DC; below it, the last block of the MCU's row above.
void fill_dummy_dc(Plane* p, int mcux, int mcuy) {
    for (int my = 0; my < mcuy; ++my)
        for (int mx = 0; mx < mcux; ++mx)
            for (int y = 0; y < p->v; ++y) {
                int by = my * p->v + y;
                for (int x = 0; x < p->h; ++x) {
                    int bx = mx * p->h + x;
                    int32_t* dc = p->coef.data() + ((size_t)by * p->alloc_cols + bx) * 64;
                    if (by >= p->rows)
                        dc[0] = p->coef[((size_t)(by - 1) * p->alloc_cols + mx * p->h + p->h - 1) * 64];
                    else if (bx >= p->cols)
                        dc[0] = dc[-64];
                }
            }
}

void encode_block(Writer& w, const int32_t* blk, int* pred, const Code& dc, const Code& ac) {
    int diff = blk[0] - *pred;
    *pred = blk[0];
    int a = diff < 0 ? -diff : diff, s = 0;
    while (a >> s) ++s;
    w.put(dc.code[s], dc.len[s]);
    w.put(diff < 0 ? diff + (1 << s) - 1 : diff, s);
    int run = 0;
    for (int j = 1; j < 64; ++j) {
        int v = blk[kNatural[j]];
        if (!v) {
            ++run;
            continue;
        }
        while (run > 15) {
            w.put(ac.code[0xF0], ac.len[0xF0]);
            run -= 16;
        }
        a = v < 0 ? -v : v;
        s = 0;
        while (a >> s) ++s;
        int sym = (run << 4) | s;
        w.put(ac.code[sym], ac.len[sym]);
        w.put(v < 0 ? v + (1 << s) - 1 : v, s);
        run = 0;
    }
    if (run) w.put(ac.code[0], ac.len[0]);
}

void segment_header(Writer& w, int marker, int payload_len) {
    w.byte(0xFF);
    w.byte((uint8_t)marker);
    w.byte((uint8_t)((payload_len + 2) >> 8));
    w.byte((uint8_t)((payload_len + 2) & 255));
}

}  // namespace

// data: n bytes of a JPEG file; bgr: height x width x 3 bytes, which the caller
// read from the frame header. Returns 0, or 1 (truncated), 2 (corrupt), 3 (a kind
// this decoder does not read); the image is then undefined.
extern "C" int skyeye_jpeg_decode(const uint8_t* data, int64_t n, uint8_t* bgr, int width,
                                  int height) {
    Decoder dec;
    dec.d = data;
    dec.n = n;
    if (n < 2 || data[0] != 0xFF || data[1] != 0xD8) return kCorrupt;
    int64_t pos = 2;
    int scans = 0;
    while (true) {
        int marker;
        int64_t p, len, next;
        int rc = segment(dec, pos, &marker, &p, &len, &next);
        if (rc) return rc;
        const uint8_t* s = data + p;
        pos = next;
        if (marker >= 0xC0 && marker <= 0xCF && marker != 0xC4 && marker != 0xC8 &&
            marker != 0xCC) {
            if (dec.have_frame) continue;
            rc = parse_sof(dec, s, len, marker);
        } else if (marker == 0xCC) {
            rc = kUnsupported;
        } else if (marker == 0xC4) {
            rc = parse_dht(dec, s, len);
        } else if (marker == 0xDB) {
            rc = parse_dqt(dec, s, len);
        } else if (marker == 0xDD) {
            if (len < 2) return kCorrupt;
            dec.restart = (s[0] << 8) | s[1];
        } else if (marker == 0xE0 && len >= 5 && !std::memcmp(s, "JFIF\0", 5)) {
            dec.jfif = true;
        } else if (marker == 0xEE && len >= 12 && !std::memcmp(s, "Adobe", 5)) {
            dec.adobe = s[11];
        } else if (marker == 0xDA) {
            int64_t end;
            rc = decode_scan(dec, s, len, pos, &end);
            pos = end;
            ++scans;
        } else if (marker == 0xD9) {
            break;
        }
        if (rc) return rc;
    }
    if (!scans || !dec.have_frame) return kTruncated;
    if (dec.width != width || dec.height != height) return kCorrupt;
    return reconstruct(dec, bgr);
}

// img: height x width x channels (3: BGR, 1: gray) bytes. Writes the JPEG that
// cv2.imwrite writes at IMWRITE_JPEG_QUALITY quality (4:2:0 for colour, the
// standard Huffman tables) to out; returns its length, or -1 when cap is short.
extern "C" int64_t skyeye_jpeg_encode(const uint8_t* img, int height, int width, int channels,
                                      int quality, uint8_t* out, int64_t cap) {
    const bool gray = channels == 1;
    quality = std::min(std::max(quality, 1), 100);
    const int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
    int qtab[2][64];
    Recip recip[2][64];
    for (int t = 0; t < 2; ++t)
        for (int i = 0; i < 64; ++i) {
            int q = (int)(((int64_t)kStdQuant[t][i] * scale + 50) / 100);
            q = std::min(std::max(q, 1), 255);
            qtab[t][i] = q;
            recip[t][i] = reciprocal(q << 3);
        }

    const int hmax = gray ? 1 : 2, vmax = hmax;
    const int mcux = (width + 8 * hmax - 1) / (8 * hmax);
    const int mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    const size_t npix = (size_t)width * height;
    std::vector<Plane> planes;
    std::vector<int> full[3];
    for (int k = 0; k < (gray ? 1 : 3); ++k) full[k].resize(npix);
    if (gray) {
        for (size_t i = 0; i < npix; ++i) full[0][i] = img[i];
    } else {  // jccolor.c's rgb_ycc_convert
        const int64_t half = (int64_t)1 << (SCALEBITS - 1), offset = (int64_t)128 << SCALEBITS;
        for (size_t i = 0; i < npix; ++i) {
            int64_t b = img[3 * i], g = img[3 * i + 1], r = img[3 * i + 2];
            full[0][i] = (int)((fix16(0.29900) * r + fix16(0.58700) * g + fix16(0.11400) * b +
                                half) >> SCALEBITS);
            full[1][i] = (int)((-fix16(0.16874) * r - fix16(0.33126) * g + fix16(0.5) * b +
                                offset + half - 1) >> SCALEBITS);
            full[2][i] = (int)((fix16(0.5) * r - fix16(0.41869) * g - fix16(0.08131) * b +
                                offset + half - 1) >> SCALEBITS);
        }
    }
    for (int k = 0; k < (gray ? 1 : 3); ++k) {
        Plane p;
        p.h = p.v = (k == 0) ? hmax : 1;
        p.table = k == 0 ? 0 : 1;
        p.rows = (height * p.v + 8 * vmax - 1) / (8 * vmax);
        p.cols = (width * p.h + 8 * hmax - 1) / (8 * hmax);
        p.alloc_rows = gray ? p.rows : mcuy * p.v;
        p.alloc_cols = gray ? p.cols : mcux * p.h;
        const int srows = p.rows * 8, scols = p.cols * 8;
        std::vector<int> samples((size_t)srows * scols);
        if (p.h == hmax) {  // full size, edge-extended
            for (int y = 0; y < srows; ++y)
                for (int x = 0; x < scols; ++x)
                    samples[(size_t)y * scols + x] =
                        full[k][(size_t)std::min(y, height - 1) * width + std::min(x, width - 1)];
        } else {  // jcsample.c's h2v2_downsample over the edge-extended plane
            const int drows = (height + 1) / 2;
            for (int y = 0; y < srows; ++y) {
                int sy = std::min(y, drows - 1);
                int y0 = std::min(2 * sy, height - 1), y1 = std::min(2 * sy + 1, height - 1);
                for (int x = 0; x < scols; ++x) {
                    int x0 = std::min(2 * x, width - 1), x1 = std::min(2 * x + 1, width - 1);
                    int sum = full[k][(size_t)y0 * width + x0] + full[k][(size_t)y0 * width + x1] +
                              full[k][(size_t)y1 * width + x0] + full[k][(size_t)y1 * width + x1];
                    samples[(size_t)y * scols + x] = (sum + 1 + (x & 1)) >> 2;
                }
            }
        }
        plane_coefficients(samples, scols, recip[p.table], &p);
        if (!gray) fill_dummy_dc(&p, mcux, mcuy);
        planes.push_back(std::move(p));
    }

    Writer w{out, cap};
    static const uint8_t jfif[18] = {0xFF, 0xE0, 0x00, 0x10, 'J', 'F', 'I', 'F', 0,
                                     1,    1,    0,    0,    1,   0,   1,   0,   0};
    w.byte(0xFF);
    w.byte(0xD8);
    w.bytes(jfif, 18);
    const int ntables = gray ? 1 : 2;
    for (int t = 0; t < ntables; ++t) {
        segment_header(w, 0xDB, 65);
        w.byte((uint8_t)t);
        for (int i = 0; i < 64; ++i) w.byte((uint8_t)qtab[t][kNatural[i]]);
    }
    const int nc = (int)planes.size();
    segment_header(w, 0xC0, 6 + 3 * nc);
    w.byte(8);
    w.byte((uint8_t)(height >> 8));
    w.byte((uint8_t)(height & 255));
    w.byte((uint8_t)(width >> 8));
    w.byte((uint8_t)(width & 255));
    w.byte((uint8_t)nc);
    for (int k = 0; k < nc; ++k) {
        w.byte((uint8_t)(k + 1));
        w.byte((uint8_t)((planes[k].h << 4) | planes[k].v));
        w.byte((uint8_t)planes[k].table);
    }
    Code codes[4];
    for (int t = 0; t < ntables; ++t)
        for (int cls = 0; cls < 2; ++cls) {
            const uint8_t* spec = kStdHuffman[2 * t + cls];
            int count = huff_count(spec);
            segment_header(w, 0xC4, 17 + count);
            w.byte((uint8_t)((cls << 4) | t));
            w.bytes(spec, 16 + count);
            make_code(spec, &codes[2 * t + cls]);
        }
    segment_header(w, 0xDA, 4 + 2 * nc);
    w.byte((uint8_t)nc);
    for (int k = 0; k < nc; ++k) {
        w.byte((uint8_t)(k + 1));
        w.byte((uint8_t)(planes[k].table * 0x11));
    }
    w.byte(0);
    w.byte(63);
    w.byte(0);

    int pred[3] = {0, 0, 0};
    if (gray) {
        const Plane& p = planes[0];
        for (int by = 0; by < p.rows; ++by)
            for (int bx = 0; bx < p.cols; ++bx)
                encode_block(w, p.coef.data() + ((size_t)by * p.alloc_cols + bx) * 64, &pred[0],
                             codes[0], codes[1]);
    } else {
        for (int my = 0; my < mcuy; ++my)
            for (int mx = 0; mx < mcux; ++mx)
                for (int k = 0; k < nc; ++k) {
                    const Plane& p = planes[k];
                    for (int y = 0; y < p.v; ++y)
                        for (int x = 0; x < p.h; ++x) {
                            size_t b = (size_t)(my * p.v + y) * p.alloc_cols + mx * p.h + x;
                            encode_block(w, p.coef.data() + b * 64, &pred[k],
                                         codes[2 * p.table], codes[2 * p.table + 1]);
                        }
                }
    }
    w.flush();
    w.byte(0xFF);
    w.byte(0xD9);
    return w.overflow ? -1 : w.n;
}
