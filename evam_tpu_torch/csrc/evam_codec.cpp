// The port's own codecs, in evam_tpu_torch's host library: a baseline
// JPEG decoder and encoder, and the I_PCM H.264 reader's I420 -> BGR
// conversion.
//
// The reference decodes and encodes JPEG through cv2 (cv2.imdecode in
// its RTSP demux, cv2.imencode in its re-stream and its publisher),
// which is libjpeg-turbo underneath, and converts I420 with
// cv2.cvtColor. The card's machine has no cv2, so the port carries its
// own code, built into the same shared library as csrc/evam_media.cpp
// (evam_tpu_torch/native.py) and called through ctypes with the
// interpreter lock released.
//
// Decode: baseline and extended sequential DCT, 8-bit, Huffman coded;
// 1 or 3 components; sampling 4:4:4, 4:2:2 (h2v1), 4:4:0 (h1v2) and
// 4:2:0 (h2v2); any DQT and DHT; restart intervals; interleaved or
// component-per-scan. Output is BGR, as cv2.imdecode(..., IMREAD_COLOR)
// gives it: libjpeg's islow IDCT (jidctint.c), its fancy upsampling
// (jdsample.c h2v1/h1v2/h2v2_fancy_upsample, edge rows and columns
// replicated) and its fixed-point YCbCr->RGB tables (jdcolor.c).
// Progressive, arithmetic-coded, lossless, hierarchical and 12-bit
// streams are refused with an error naming their SOF.
//
// Encode: 4:2:0, the IJG quality scaling of the Annex K tables, the
// standard Huffman tables, a JFIF APP0, libjpeg's RGB->YCbCr tables
// (jccolor.c), h2v2_downsample's alternating rounding, the islow
// forward DCT (jfdctint.c) and libjpeg-turbo's reciprocal quantizer
// (jcdctmgr.c), with libjpeg's edge padding and dummy blocks: the
// bytes cv2.imencode writes at the same quality.
//
// Single-threaded on purpose: its callers (the demux's decode workers,
// the stream threads) are already one thread per frame.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <memory>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

// cv2.imdecode's CV_IO_MAX_IMAGE_PIXELS: a header of a few bytes
// cannot ask for more than this much memory
constexpr int64_t kMaxPixels = int64_t(1) << 30;

struct JpegError : std::runtime_error {
    using std::runtime_error::runtime_error;
};

// zigzag index -> natural (row-major) index, with 16 safety entries for
// corrupt runs past the end of a block (libjpeg's jpeg_natural_order)
const int kNatural[64 + 16] = {
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// ------------------------------------------------------------- IDCT

const int32_t FIX_0_298631336 = 2446;
const int32_t FIX_0_390180644 = 3196;
const int32_t FIX_0_541196100 = 4433;
const int32_t FIX_0_765366865 = 6270;
const int32_t FIX_0_899976223 = 7373;
const int32_t FIX_1_175875602 = 9633;
const int32_t FIX_1_501321110 = 12299;
const int32_t FIX_1_847759065 = 15137;
const int32_t FIX_1_961570560 = 16069;
const int32_t FIX_2_053119869 = 16819;
const int32_t FIX_2_562915447 = 20995;
const int32_t FIX_3_072711026 = 25172;
const int CONST_BITS = 13;
const int PASS1_BITS = 2;

inline int32_t descale(int64_t x, int n) {
    return (int32_t)((x + ((int64_t)1 << (n - 1))) >> n);
}

inline int32_t descale32(int32_t x, int n) {
    return (x + (1 << (n - 1))) >> n;
}

inline uint8_t clamp8(int v) {
    return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// jidctint.c jpeg_idct_islow: dequantize, 8x8 inverse DCT, +128, clamp.
// In 32-bit arithmetic, as libjpeg-turbo's SIMD code (the one cv2 runs)
// does it: the C code's 64-bit products differ only for coefficients no
// 8-bit image produces.
void idct_islow(const int16_t *in, const uint16_t *q, uint8_t *out,
                int stride) {
    int32_t ws[64];
    for (int c = 0; c < 8; ++c) {
        const int16_t *ip = in + c;
        const uint16_t *qp = q + c;
        int32_t *wp = ws + c;
        if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 &&
            ip[40] == 0 && ip[48] == 0 && ip[56] == 0) {
            int32_t dc = ((int32_t)ip[0] * qp[0]) * (1 << PASS1_BITS);
            for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
            continue;
        }
        int32_t z2 = (int32_t)ip[16] * qp[16];
        int32_t z3 = (int32_t)ip[48] * qp[48];
        int32_t z1 = (z2 + z3) * FIX_0_541196100;
        int32_t tmp2 = z1 + z3 * (-FIX_1_847759065);
        int32_t tmp3 = z1 + z2 * FIX_0_765366865;
        z2 = (int32_t)ip[0] * qp[0];
        z3 = (int32_t)ip[32] * qp[32];
        int32_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
        int32_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
        int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        tmp0 = (int32_t)ip[56] * qp[56];
        tmp1 = (int32_t)ip[40] * qp[40];
        tmp2 = (int32_t)ip[24] * qp[24];
        tmp3 = (int32_t)ip[8] * qp[8];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        int32_t z4 = tmp1 + tmp3;
        int32_t z5 = (z3 + z4) * FIX_1_175875602;
        tmp0 *= FIX_0_298631336;
        tmp1 *= FIX_2_053119869;
        tmp2 *= FIX_3_072711026;
        tmp3 *= FIX_1_501321110;
        z1 *= -FIX_0_899976223;
        z2 *= -FIX_2_562915447;
        z3 *= -FIX_1_961570560;
        z4 *= -FIX_0_390180644;
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        const int n = CONST_BITS - PASS1_BITS;
        wp[0] = descale32(tmp10 + tmp3, n);
        wp[56] = descale32(tmp10 - tmp3, n);
        wp[8] = descale32(tmp11 + tmp2, n);
        wp[48] = descale32(tmp11 - tmp2, n);
        wp[16] = descale32(tmp12 + tmp1, n);
        wp[40] = descale32(tmp12 - tmp1, n);
        wp[24] = descale32(tmp13 + tmp0, n);
        wp[32] = descale32(tmp13 - tmp0, n);
    }
    for (int r = 0; r < 8; ++r) {
        const int32_t *wp = ws + 8 * r;
        uint8_t *op = out + (size_t)r * stride;
        if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 &&
            wp[5] == 0 && wp[6] == 0 && wp[7] == 0) {
            uint8_t v = clamp8(descale32(wp[0], PASS1_BITS + 3) + 128);
            std::memset(op, v, 8);
            continue;
        }
        int32_t z2 = wp[2], z3 = wp[6];
        int32_t z1 = (z2 + z3) * FIX_0_541196100;
        int32_t tmp2 = z1 + z3 * (-FIX_1_847759065);
        int32_t tmp3 = z1 + z2 * FIX_0_765366865;
        int32_t tmp0 = ((int32_t)wp[0] + wp[4]) * (1 << CONST_BITS);
        int32_t tmp1 = ((int32_t)wp[0] - wp[4]) * (1 << CONST_BITS);
        int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        tmp0 = wp[7];
        tmp1 = wp[5];
        tmp2 = wp[3];
        tmp3 = wp[1];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        int32_t z4 = tmp1 + tmp3;
        int32_t z5 = (z3 + z4) * FIX_1_175875602;
        tmp0 *= FIX_0_298631336;
        tmp1 *= FIX_2_053119869;
        tmp2 *= FIX_3_072711026;
        tmp3 *= FIX_1_501321110;
        z1 *= -FIX_0_899976223;
        z2 *= -FIX_2_562915447;
        z3 *= -FIX_1_961570560;
        z4 *= -FIX_0_390180644;
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        const int n = CONST_BITS + PASS1_BITS + 3;
        op[0] = clamp8(descale32(tmp10 + tmp3, n) + 128);
        op[7] = clamp8(descale32(tmp10 - tmp3, n) + 128);
        op[1] = clamp8(descale32(tmp11 + tmp2, n) + 128);
        op[6] = clamp8(descale32(tmp11 - tmp2, n) + 128);
        op[2] = clamp8(descale32(tmp12 + tmp1, n) + 128);
        op[5] = clamp8(descale32(tmp12 - tmp1, n) + 128);
        op[3] = clamp8(descale32(tmp13 + tmp0, n) + 128);
        op[4] = clamp8(descale32(tmp13 - tmp0, n) + 128);
    }
}

// ---------------------------------------------------- Huffman decode

struct HuffDecode {
    bool present = false;
    uint8_t vals[256] = {0};
    int32_t maxcode[18] = {0};
    int32_t valoffset[18] = {0};
    uint16_t look[512] = {0};  // 9-bit lookahead: (length << 8) | value

    void build(const uint8_t bits[17], const uint8_t *v, int count) {
        std::memcpy(vals, v, count);
        uint8_t size[257];
        uint32_t code_of[257];
        int p = 0;
        for (int l = 1; l <= 16; ++l)
            for (int i = 0; i < bits[l]; ++i) size[p++] = (uint8_t)l;
        size[p] = 0;
        uint32_t code = 0;
        int si = size[0];
        p = 0;
        while (size[p]) {
            while (size[p] == si) code_of[p++] = code++;
            if (code >= (1u << si)) throw JpegError("jpeg: bad Huffman table");
            code <<= 1;
            ++si;
        }
        p = 0;
        for (int l = 1; l <= 16; ++l) {
            if (bits[l]) {
                valoffset[l] = p - (int32_t)code_of[p];
                p += bits[l];
                maxcode[l] = (int32_t)code_of[p - 1];
            } else {
                maxcode[l] = -1;
            }
        }
        valoffset[17] = 0;
        maxcode[17] = 0xFFFFF;
        std::memset(look, 0, sizeof(look));
        p = 0;
        for (int l = 1; l <= 9; ++l) {
            for (int i = 0; i < bits[l]; ++i, ++p) {
                int lookbits = (int)(code_of[p] << (9 - l));
                for (int k = 0; k < (1 << (9 - l)); ++k)
                    look[lookbits + k] = (uint16_t)((l << 8) | vals[p]);
            }
        }
        present = true;
    }
};

struct BitReader {
    const uint8_t *d = nullptr;
    size_t n = 0;
    size_t pos = 0;
    uint64_t acc = 0;  // MSB-aligned
    int nbits = 0;
    bool hit_marker = false;
    size_t marker_pos = 0;  // the 0xFF before the marker code

    void fill() {
        while (nbits <= 56) {
            uint32_t b = 0;
            if (!hit_marker) {
                if (pos < n) {
                    uint8_t c = d[pos];
                    if (c != 0xFF) {
                        b = c;
                        ++pos;
                    } else {
                        size_t q = pos + 1;
                        while (q < n && d[q] == 0xFF) ++q;
                        if (q < n && d[q] == 0x00) {
                            b = 0xFF;  // FF 00: a stuffed data byte
                            pos = q + 1;
                        } else {
                            hit_marker = true;
                            marker_pos = q - 1;
                        }
                    }
                } else {
                    hit_marker = true;
                    marker_pos = n;
                }
            }
            // past a marker libjpeg feeds zeros
            acc |= (uint64_t)b << (56 - nbits);
            nbits += 8;
        }
    }
    inline uint32_t peek(int k) { return (uint32_t)(acc >> (64 - k)); }
    inline void skip(int k) {
        acc <<= k;
        nbits -= k;
    }
    inline int receive(int s) {
        if (nbits < s) fill();
        int v = (int)peek(s);
        skip(s);
        return v;
    }
    inline int decode(const HuffDecode &t) {
        if (nbits < 16) fill();
        int e = t.look[peek(9)];
        if (e >> 8) {
            skip(e >> 8);
            return e & 0xFF;
        }
        int l = 10;
        int32_t code = (int32_t)peek(l);
        while (l <= 16 && code > t.maxcode[l]) {
            ++l;
            code = (int32_t)peek(l);
        }
        if (l > 16) return 0;  // corrupt: libjpeg warns and takes 0
        skip(l);
        return t.vals[(code + t.valoffset[l]) & 0xFF];
    }
};

inline int extend(int v, int s) {
    return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

// --------------------------------------------------------- decoder

// jdcolor.c's YCbCr -> RGB tables (SCALEBITS 16)
struct YccToRgb {
    int cr_r[256], cb_b[256];
    int32_t cr_g[256], cb_g[256];
    YccToRgb() {
        for (int i = 0; i < 256; ++i) {
            int32_t x = i - 128;
            cr_r[i] = (91881 * x + 32768) >> 16;   // FIX(1.40200)
            cb_b[i] = (116130 * x + 32768) >> 16;  // FIX(1.77200)
            cr_g[i] = -46802 * x;                  // FIX(0.71414)
            cb_g[i] = -22554 * x + 32768;          // FIX(0.34414), + 1/2
        }
    }
};

// jccolor.c rgb_ycc_convert's RGB -> YCbCr tables (SCALEBITS 16)
struct RgbToYcc {
    int32_t tab[8 * 256];
    RgbToYcc() {
        const int32_t half = 1 << 15, cbcr = 128 << 16;
        for (int i = 0; i < 256; ++i) {
            tab[i] = 19595 * i;                           // 0.29900
            tab[i + 256] = 38470 * i;                     // 0.58700
            tab[i + 512] = 7471 * i + half;               // 0.11400
            tab[i + 768] = -11059 * i;                    // 0.16874
            tab[i + 1024] = -21709 * i;                   // 0.33126
            tab[i + 1280] = 32768 * i + cbcr + half - 1;  // 0.50000
            tab[i + 1536] = -27439 * i;                   // 0.41869
            tab[i + 1792] = -5329 * i;                    // 0.08131
        }
    }
};

struct Component {
    int id = 0, h = 1, v = 1, tq = 0;
    int td = 0, ta = 0;           // table selectors of the current scan
    int width = 0, height = 0;    // downsampled size in samples
    int bw = 0, bh = 0;           // allocated blocks (MCU-padded)
    int wblocks = 0, hblocks = 0; // blocks holding samples
    bool latched = false;
    uint16_t q[64] = {0};         // natural order
    std::vector<int16_t> coef;
    std::vector<uint8_t> has_ac;  // per block: any nonzero AC coefficient
    int dc_pred = 0;
};

struct Decoder {
    const uint8_t *d;
    size_t n;
    size_t pos = 0;
    int width = 0, height = 0, ncomp = 0;
    int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
    bool frame = false, jfif = false, adobe = false;
    int adobe_transform = -1;
    int restart_interval = 0;
    uint16_t qt[4][64];
    bool qt_present[4] = {false, false, false, false};
    HuffDecode dc[4], ac[4];
    Component comp[3];

    Decoder(const uint8_t *data, size_t len) : d(data), n(len) {}

    int u8() {
        if (pos >= n) throw JpegError("jpeg: truncated stream");
        return d[pos++];
    }
    int u16() {
        int hi = u8();
        return (hi << 8) | u8();
    }

    // the next marker code at or after pos (skipping fill and garbage),
    // or -1 at the end of the data
    int next_marker() {
        for (;;) {
            while (pos < n && d[pos] != 0xFF) ++pos;
            while (pos < n && d[pos] == 0xFF) ++pos;
            if (pos >= n) return -1;
            int m = d[pos++];
            if (m != 0) return m;
        }
    }

    static std::string sof_name(int m) {
        char buf[64];
        std::snprintf(buf, sizeof(buf), "SOF%d", m - 0xC0);
        return buf;
    }

    void read_sof(int m) {
        if (frame) throw JpegError("jpeg: more than one frame header");
        if (m == 0xC2 || m == 0xC6)
            throw JpegError("jpeg: progressive DCT (" + sof_name(m) +
                            ") is not supported; baseline only");
        if (m == 0xC3 || m == 0xC7)
            throw JpegError("jpeg: lossless (" + sof_name(m) +
                            ") is not supported; baseline only");
        if (m == 0xC5)
            throw JpegError("jpeg: hierarchical (" + sof_name(m) +
                            ") is not supported; baseline only");
        if (m >= 0xC9)
            throw JpegError("jpeg: arithmetic coding (" + sof_name(m) +
                            ") is not supported; baseline only");
        int len = u16();
        size_t end = pos + len - 2;
        int precision = u8();
        if (precision != 8) {
            char buf[96];
            std::snprintf(buf, sizeof(buf),
                          "jpeg: %d-bit samples (%s) are not supported; "
                          "8-bit only", precision, sof_name(m).c_str());
            throw JpegError(buf);
        }
        height = u16();
        width = u16();
        ncomp = u8();
        if (height == 0 || width == 0)
            throw JpegError("jpeg: empty image (DNL heights are not read)");
        if ((int64_t)width * height > kMaxPixels) {
            char buf[96];
            std::snprintf(buf, sizeof(buf),
                          "jpeg: %dx%d is more than 2^30 pixels, cv2's "
                          "limit", width, height);
            throw JpegError(buf);
        }
        if (ncomp != 1 && ncomp != 3) {
            char buf[80];
            std::snprintf(buf, sizeof(buf),
                          "jpeg: %d components; only 1 or 3 are decoded",
                          ncomp);
            throw JpegError(buf);
        }
        for (int i = 0; i < ncomp; ++i) {
            Component &c = comp[i];
            c.id = u8();
            int hv = u8();
            c.h = hv >> 4;
            c.v = hv & 15;
            c.tq = u8() & 3;
            if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4)
                throw JpegError("jpeg: bad sampling factors");
            hmax = std::max(hmax, c.h);
            vmax = std::max(vmax, c.v);
        }
        if (ncomp == 1) {
            // a single component is one block an MCU whatever it declares
            comp[0].h = comp[0].v = hmax = vmax = 1;
        }
        mcux = (width + 8 * hmax - 1) / (8 * hmax);
        mcuy = (height + 8 * vmax - 1) / (8 * vmax);
        for (int i = 0; i < ncomp; ++i) {
            Component &c = comp[i];
            int fh = hmax / c.h, fv = vmax / c.v;
            if (hmax % c.h || vmax % c.v || fh > 2 || fv > 2)
                throw JpegError(
                    "jpeg: sampling not supported (4:4:4, 4:2:2, 4:4:0 "
                    "and 4:2:0 only)");
            c.width = (int)(((int64_t)width * c.h + hmax - 1) / hmax);
            c.height = (int)(((int64_t)height * c.v + vmax - 1) / vmax);
            c.bw = mcux * c.h;
            c.bh = mcuy * c.v;
            c.wblocks = (c.width + 7) / 8;
            c.hblocks = (c.height + 7) / 8;
            c.coef.assign((size_t)c.bw * c.bh * 64, 0);
            c.has_ac.assign((size_t)c.bw * c.bh, 0);
        }
        pos = end;
        frame = true;
    }

    void read_dqt() {
        int len = u16();
        size_t end = pos + len - 2;
        while (pos < end) {
            int pq = u8();
            int tq = pq & 15;
            if (tq > 3) throw JpegError("jpeg: bad DQT table id");
            for (int i = 0; i < 64; ++i)
                qt[tq][kNatural[i]] = (uint16_t)((pq >> 4) ? u16() : u8());
            qt_present[tq] = true;
        }
        pos = end;
    }

    void read_dht() {
        int len = u16();
        size_t end = pos + len - 2;
        while (pos < end) {
            int tc = u8();
            int cls = tc >> 4, id = tc & 15;
            if (cls > 1 || id > 3) throw JpegError("jpeg: bad DHT table id");
            uint8_t bits[17];
            bits[0] = 0;
            int count = 0;
            for (int i = 1; i <= 16; ++i) {
                bits[i] = (uint8_t)u8();
                count += bits[i];
            }
            if (count > 256 || pos + count > n)
                throw JpegError("jpeg: bad DHT table");
            (cls ? ac[id] : dc[id]).build(bits, d + pos, count);
            pos += count;
        }
        pos = end;
    }

    void decode_block(BitReader &br, Component &c, size_t index) {
        int16_t *blk = &c.coef[index * 64];
        bool any_ac = false;
        const HuffDecode &dt = dc[c.td];
        const HuffDecode &at = ac[c.ta];
        int s = br.decode(dt);
        if (s) {
            if (s > 16) s = 16;
            c.dc_pred += extend(br.receive(s), s);
        }
        blk[0] = (int16_t)c.dc_pred;
        for (int k = 1; k < 64; ++k) {
            int rs = br.decode(at);
            int r = rs >> 4;
            s = rs & 15;
            if (s) {
                k += r;
                int v = extend(br.receive(s), s);
                blk[kNatural[k]] = (int16_t)v;
                any_ac = true;
            } else {
                if (r != 15) break;
                k += 15;
            }
        }
        c.has_ac[index] = any_ac;
    }

    // restart marker handling between restart intervals
    void restart(BitReader &br, Component **sc, int ns) {
        size_t p = br.hit_marker ? br.marker_pos : br.pos;
        br.acc = 0;
        br.nbits = 0;
        br.hit_marker = false;
        pos = p;
        size_t save = pos;
        int m = next_marker();
        if (m >= 0xD0 && m <= 0xD7) {
            br.pos = pos;  // past the RSTn
        } else {
            br.pos = save;  // not a restart marker: leave it for the parser
        }
        for (int i = 0; i < ns; ++i) sc[i]->dc_pred = 0;
    }

    void read_sos() {
        if (!frame) throw JpegError("jpeg: scan before the frame header");
        int len = u16();
        size_t end = pos + len - 2;
        int ns = u8();
        if (ns < 1 || ns > ncomp) throw JpegError("jpeg: bad scan header");
        Component *sc[3];
        for (int i = 0; i < ns; ++i) {
            int cid = u8();
            int t = u8();
            Component *c = nullptr;
            for (int k = 0; k < ncomp; ++k)
                if (comp[k].id == cid) c = &comp[k];
            if (c == nullptr) throw JpegError("jpeg: scan names no component");
            c->td = t >> 4;
            c->ta = t & 15;
            if (c->td > 3 || c->ta > 3 || !dc[c->td].present ||
                !ac[c->ta].present)
                throw JpegError("jpeg: scan uses an undefined Huffman table");
            if (!c->latched) {
                if (!qt_present[c->tq])
                    throw JpegError("jpeg: component uses an undefined "
                                    "quantization table");
                std::memcpy(c->q, qt[c->tq], sizeof(c->q));
                c->latched = true;
            }
            c->dc_pred = 0;
            sc[i] = c;
        }
        int ss = u8(), se = u8(), ahal = u8();
        if (ss != 0 || se != 63 || ahal != 0)
            throw JpegError("jpeg: spectral selection or successive "
                            "approximation in a sequential scan");
        pos = end;

        BitReader br;
        br.d = d;
        br.n = n;
        br.pos = pos;
        int todo = restart_interval;
        if (ns == 1) {
            Component &c = *sc[0];
            for (int by = 0; by < c.hblocks; ++by) {
                for (int bx = 0; bx < c.wblocks; ++bx) {
                    if (restart_interval) {
                        if (todo == 0) {
                            restart(br, sc, ns);
                            todo = restart_interval;
                        }
                        --todo;
                    }
                    decode_block(br, c, (size_t)by * c.bw + bx);
                }
            }
        } else {
            for (int my = 0; my < mcuy; ++my) {
                for (int mx = 0; mx < mcux; ++mx) {
                    if (restart_interval) {
                        if (todo == 0) {
                            restart(br, sc, ns);
                            todo = restart_interval;
                        }
                        --todo;
                    }
                    for (int i = 0; i < ns; ++i) {
                        Component &c = *sc[i];
                        for (int y = 0; y < c.v; ++y)
                            for (int x = 0; x < c.h; ++x) {
                                size_t bx = (size_t)mx * c.h + x;
                                size_t by = (size_t)my * c.v + y;
                                decode_block(br, c, by * c.bw + bx);
                            }
                    }
                }
            }
        }
        pos = br.hit_marker ? br.marker_pos : br.pos;
    }

    void parse(bool header_only) {
        if (n < 2 || d[0] != 0xFF || d[1] != 0xD8)
            throw JpegError("jpeg: not a JPEG (no SOI)");
        pos = 2;
        bool scanned = false;
        for (;;) {
            int m = next_marker();
            if (m == -1) {
                // a stream cut after its scan decodes as libjpeg's does
                // (it warns); one cut before it is an error
                if (scanned) break;
                throw JpegError("jpeg: truncated stream");
            }
            if (m == 0xD9) break;  // EOI
            if (m >= 0xD0 && m <= 0xD7) continue;  // stray RSTn
            if (m == 0x01) continue;               // TEM
            switch (m) {
            case 0xC4: read_dht(); break;
            case 0xDB: read_dqt(); break;
            case 0xDD: {
                u16();
                restart_interval = u16();
                break;
            }
            case 0xDA:
                if (header_only) return;
                read_sos();
                scanned = true;
                break;
            case 0xCC:
                throw JpegError("jpeg: arithmetic coding (DAC) is not "
                                "supported; baseline only");
            case 0xE0: case 0xEE: {
                int len = u16();
                size_t end = pos + len - 2;
                if (m == 0xE0 && len >= 7 && end <= n &&
                    std::memcmp(d + pos, "JFIF\0", 5) == 0)
                    jfif = true;
                if (m == 0xEE && len >= 12 && end <= n &&
                    std::memcmp(d + pos, "Adobe", 5) == 0) {
                    adobe = true;
                    adobe_transform = d[pos + 11];
                }
                pos = end;
                break;
            }
            default:
                if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 &&
                    m != 0xCC) {
                    read_sof(m);
                    if (header_only) return;
                } else {
                    int len = u16();  // APPn, COM, DNL, ...: skipped
                    pos += len - 2;
                }
            }
        }
        if (!frame) throw JpegError("jpeg: no frame header (SOF)");
        if (!scanned && !header_only) throw JpegError("jpeg: no scan (SOS)");
    }

    bool rgb_colorspace() const {
        if (ncomp != 3) return false;
        if (jfif) return false;
        if (adobe) return adobe_transform == 0;
        return comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B';
    }

    void render(uint8_t *out) {
        // IDCT every block that holds samples into its component plane
        // every sample of a plane is written by its block's IDCT
        std::vector<std::unique_ptr<uint8_t[]>> planes;
        for (int i = 0; i < ncomp; ++i) {
            Component &c = comp[i];
            if (!c.latched)
                throw JpegError("jpeg: a component has no scan");
            int stride = c.wblocks * 8;
            planes.emplace_back(new uint8_t[(size_t)stride * c.hblocks * 8]);
            for (int by = 0; by < c.hblocks; ++by)
                for (int bx = 0; bx < c.wblocks; ++bx) {
                    size_t b = (size_t)by * c.bw + bx;
                    uint8_t *dst = &planes[i][(size_t)by * 8 * stride + bx * 8];
                    if (c.has_ac[b]) {
                        idct_islow(&c.coef[b * 64], c.q, dst, stride);
                        continue;
                    }
                    // DC only: both passes of the IDCT take their
                    // all-zero shortcut, one value for the block
                    int32_t dc = ((int32_t)c.coef[b * 64] * c.q[0])
                                 * (1 << PASS1_BITS);
                    uint8_t v = clamp8(descale32(dc, PASS1_BITS + 3) + 128);
                    for (int r = 0; r < 8; ++r)
                        std::memset(dst + (size_t)r * stride, v, 8);
                }
        }
        int rowlen = width + 16;
        std::vector<uint8_t> up[3];
        for (int i = 0; i < ncomp; ++i) up[i].assign(2 * rowlen, 0);
        std::vector<int> colsum(rowlen + 2);
        static const YccToRgb tab;  // built once, thread-safe
        const int *cr_r = tab.cr_r, *cb_b = tab.cb_b;
        const int32_t *cr_g = tab.cr_g, *cb_g = tab.cb_g;
        bool rgb = rgb_colorspace();
        for (int y = 0; y < height; ++y) {
            const uint8_t *row[3];
            for (int i = 0; i < ncomp; ++i) {
                Component &c = comp[i];
                int fh = hmax / c.h, fv = vmax / c.v;
                int stride = c.wblocks * 8;
                const uint8_t *pl = planes[i].get();
                int cw = c.width;
                if (fh == 1 && fv == 1) {
                    row[i] = pl + (size_t)y * stride;
                    continue;
                }
                uint8_t *o = up[i].data();
                int iy = fv == 2 ? y >> 1 : y;
                const uint8_t *in0 = pl + (size_t)iy * stride;
                if (fv == 2) {
                    // the nearer neighbour row: above for even rows, below
                    // for odd ones; edge rows replicated (jdmainct.c)
                    int ny = (y & 1) ? std::min(iy + 1, c.height - 1)
                                     : std::max(iy - 1, 0);
                    const uint8_t *in1 = pl + (size_t)ny * stride;
                    if (fh == 1) {
                        int bias = (y & 1) ? 2 : 1;
                        for (int x = 0; x < cw; ++x)
                            o[x] = (uint8_t)((in0[x] * 3 + in1[x] + bias) >> 2);
                    } else if (cw > 2) {
                        for (int x = 0; x < cw; ++x)
                            colsum[x + 1] = in0[x] * 3 + in1[x];
                        colsum[0] = colsum[1];
                        colsum[cw + 1] = colsum[cw];
                        for (int x = 0; x < cw; ++x) {
                            int t = colsum[x + 1] * 3;
                            o[2 * x] = (uint8_t)((t + colsum[x] + 8) >> 4);
                            o[2 * x + 1] = (uint8_t)((t + colsum[x + 2] + 7) >> 4);
                        }
                    } else {
                        for (int x = 0; x < cw; ++x) o[2 * x] = o[2 * x + 1] = in0[x];
                    }
                } else {  // h2v1
                    if (cw > 2) {
                        for (int x = 0; x < cw; ++x) {
                            int t = in0[x] * 3;
                            int l = in0[x > 0 ? x - 1 : 0];
                            int r = in0[x < cw - 1 ? x + 1 : cw - 1];
                            o[2 * x] = (uint8_t)((t + l + 1) >> 2);
                            o[2 * x + 1] = (uint8_t)((t + r + 2) >> 2);
                        }
                    } else {
                        for (int x = 0; x < cw; ++x) o[2 * x] = o[2 * x + 1] = in0[x];
                    }
                }
                row[i] = o;
            }
            uint8_t *op = out + (size_t)y * width * 3;
            if (ncomp == 1) {
                const uint8_t *g = row[0];
                for (int x = 0; x < width; ++x)
                    op[3 * x] = op[3 * x + 1] = op[3 * x + 2] = g[x];
            } else if (rgb) {
                for (int x = 0; x < width; ++x) {
                    op[3 * x] = row[2][x];
                    op[3 * x + 1] = row[1][x];
                    op[3 * x + 2] = row[0][x];
                }
            } else {
                const uint8_t *yy = row[0], *cb = row[1], *cr = row[2];
                for (int x = 0; x < width; ++x) {
                    int Y = yy[x], B = cb[x], R = cr[x];
                    op[3 * x + 2] = clamp8(Y + cr_r[R]);
                    op[3 * x + 1] = clamp8(Y + ((cb_g[B] + cr_g[R]) >> 16));
                    op[3 * x] = clamp8(Y + cb_b[B]);
                }
            }
        }
    }
};

void put_error(char *err, int errlen, const char *msg) {
    if (err == nullptr || errlen <= 0) return;
    std::snprintf(err, (size_t)errlen, "%s", msg);
}

// --------------------------------------------------------- encoder

const uint8_t kStdLuma[64] = {
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kStdChroma[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// ITU-T T.81 Annex K.3 (jstdhuff.c)
const uint8_t kDcLumBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChmBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D};
const uint8_t kAcLumVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
    0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3,
    0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
    0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9,
    0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
    0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA};
const uint8_t kAcChmBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChmVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1,
    0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
    0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A,
    0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
    0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7,
    0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
    0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA};

struct HuffEncode {
    uint16_t code[256] = {0};
    uint8_t size[256] = {0};
    void build(const uint8_t bits[17], const uint8_t *vals) {
        uint8_t sz[257];
        int p = 0;
        for (int l = 1; l <= 16; ++l)
            for (int i = 0; i < bits[l]; ++i) sz[p++] = (uint8_t)l;
        sz[p] = 0;
        int count = p;
        uint32_t c = 0;
        int si = sz[0];
        p = 0;
        uint32_t codes[257];
        while (sz[p]) {
            while (sz[p] == si) codes[p++] = c++;
            c <<= 1;
            ++si;
        }
        for (int i = 0; i < count; ++i) {
            code[vals[i]] = (uint16_t)codes[i];
            size[vals[i]] = sz[i];
        }
    }
};

struct BitWriter {
    uint8_t *out;
    size_t cap;
    size_t len = 0;
    uint64_t buf = 0;
    int bits = 0;
    void byte(uint8_t b) {
        if (len >= cap) throw JpegError("jpeg: encode buffer too small");
        out[len++] = b;
    }
    void bytes(const uint8_t *p, size_t k) {
        for (size_t i = 0; i < k; ++i) byte(p[i]);
    }
    void u16(int v) {
        byte((uint8_t)(v >> 8));
        byte((uint8_t)v);
    }
    inline void put(uint32_t code, int size) {
        buf = (buf << size) | (code & ((1u << size) - 1));
        bits += size;
        while (bits >= 8) {
            uint8_t b = (uint8_t)(buf >> (bits - 8));
            byte(b);
            if (b == 0xFF) byte(0);
            bits -= 8;
        }
    }
    void flush() {
        put(0x7F, 7);  // pad the last byte with ones
        buf = 0;
        bits = 0;
    }
};

// jfdctint.c jpeg_fdct_islow (in place, on samples less 128)
void fdct_islow(int32_t *data) {
    int32_t *p = data;
    for (int r = 0; r < 8; ++r, p += 8) {
        int64_t tmp0 = p[0] + p[7], tmp7 = p[0] - p[7];
        int64_t tmp1 = p[1] + p[6], tmp6 = p[1] - p[6];
        int64_t tmp2 = p[2] + p[5], tmp5 = p[2] - p[5];
        int64_t tmp3 = p[3] + p[4], tmp4 = p[3] - p[4];
        int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        p[0] = (int32_t)((tmp10 + tmp11) * (1 << PASS1_BITS));
        p[4] = (int32_t)((tmp10 - tmp11) * (1 << PASS1_BITS));
        int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
        const int n = CONST_BITS - PASS1_BITS;
        p[2] = descale(z1 + tmp13 * FIX_0_765366865, n);
        p[6] = descale(z1 + tmp12 * (-FIX_1_847759065), n);
        z1 = tmp4 + tmp7;
        int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
        int64_t z5 = (z3 + z4) * FIX_1_175875602;
        tmp4 *= FIX_0_298631336;
        tmp5 *= FIX_2_053119869;
        tmp6 *= FIX_3_072711026;
        tmp7 *= FIX_1_501321110;
        z1 *= -FIX_0_899976223;
        z2 *= -FIX_2_562915447;
        z3 *= -FIX_1_961570560;
        z4 *= -FIX_0_390180644;
        z3 += z5;
        z4 += z5;
        p[7] = descale(tmp4 + z1 + z3, n);
        p[5] = descale(tmp5 + z2 + z4, n);
        p[3] = descale(tmp6 + z2 + z3, n);
        p[1] = descale(tmp7 + z1 + z4, n);
    }
    p = data;
    for (int c = 0; c < 8; ++c, ++p) {
        int64_t tmp0 = p[0] + p[56], tmp7 = p[0] - p[56];
        int64_t tmp1 = p[8] + p[48], tmp6 = p[8] - p[48];
        int64_t tmp2 = p[16] + p[40], tmp5 = p[16] - p[40];
        int64_t tmp3 = p[24] + p[32], tmp4 = p[24] - p[32];
        int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        p[0] = descale(tmp10 + tmp11, PASS1_BITS);
        p[32] = descale(tmp10 - tmp11, PASS1_BITS);
        int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
        const int n = CONST_BITS + PASS1_BITS;
        p[16] = descale(z1 + tmp13 * FIX_0_765366865, n);
        p[48] = descale(z1 + tmp12 * (-FIX_1_847759065), n);
        z1 = tmp4 + tmp7;
        int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
        int64_t z5 = (z3 + z4) * FIX_1_175875602;
        tmp4 *= FIX_0_298631336;
        tmp5 *= FIX_2_053119869;
        tmp6 *= FIX_3_072711026;
        tmp7 *= FIX_1_501321110;
        z1 *= -FIX_0_899976223;
        z2 *= -FIX_2_562915447;
        z3 *= -FIX_1_961570560;
        z4 *= -FIX_0_390180644;
        z3 += z5;
        z4 += z5;
        p[56] = descale(tmp4 + z1 + z3, n);
        p[40] = descale(tmp5 + z2 + z4, n);
        p[24] = descale(tmp6 + z2 + z3, n);
        p[8] = descale(tmp7 + z1 + z4, n);
    }
}

// libjpeg-turbo's quantizer: a reciprocal, a correction and a shift per
// coefficient in 16-bit arithmetic (jcdctmgr.c compute_reciprocal)
struct Divisor {
    uint32_t recip, corr;
    int shift;
};

Divisor reciprocal(uint32_t divisor) {
    int b = 0;
    while ((1u << (b + 1)) <= divisor) ++b;  // floor(log2)
    int r = 16 + b;
    uint32_t fq = (1u << r) / divisor;
    uint32_t fr = (1u << r) % divisor;
    uint32_t c = divisor / 2;
    if (fr == 0) {
        fq >>= 1;
        --r;
    } else if (fr <= divisor / 2u) {
        ++c;
    } else {
        ++fq;
    }
    return Divisor{fq & 0xFFFF, c & 0xFFFF, r};
}

void quality_table(const uint8_t *base, int quality, uint16_t *out) {
    if (quality <= 0) quality = 1;
    if (quality > 100) quality = 100;
    int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
    for (int i = 0; i < 64; ++i) {
        long t = ((long)base[i] * scale + 50L) / 100L;
        if (t <= 0) t = 1;
        if (t > 255) t = 255;  // force_baseline
        out[i] = (uint16_t)t;
    }
}

struct Encoder {
    int w, h;
    uint16_t q[2][64];
    Divisor div[2][64];
    HuffEncode dc[2], ac[2];

    void fdct_quant(const uint8_t *plane, int stride, int x0, int y0,
                    int t, int16_t *out) {
        int32_t ws[64];
        for (int r = 0; r < 8; ++r) {
            const uint8_t *p = plane + (size_t)(y0 + r) * stride + x0;
            for (int c = 0; c < 8; ++c) ws[8 * r + c] = (int32_t)p[c] - 128;
        }
        fdct_islow(ws);
        for (int i = 0; i < 64; ++i) {
            int32_t v = ws[i];
            const Divisor &dv = div[t][i];
            bool neg = v < 0;
            uint32_t a = (uint32_t)(neg ? -v : v);
            uint32_t prod = (a + dv.corr) * dv.recip;
            int32_t qv = (int32_t)(prod >> dv.shift);
            out[i] = (int16_t)(neg ? -qv : qv);
        }
    }

    void huff_block(BitWriter &bw, const int16_t *blk, int &pred, int t) {
        int diff = blk[0] - pred;
        pred = blk[0];
        int a = diff < 0 ? -diff : diff;
        int v = diff < 0 ? diff - 1 : diff;
        int nb = 0;
        while (a) {
            ++nb;
            a >>= 1;
        }
        bw.put(dc[t].code[nb], dc[t].size[nb]);
        if (nb) bw.put((uint32_t)v, nb);
        int run = 0;
        for (int k = 1; k < 64; ++k) {
            int c = blk[kNatural[k]];
            if (c == 0) {
                ++run;
                continue;
            }
            while (run > 15) {
                bw.put(ac[t].code[0xF0], ac[t].size[0xF0]);
                run -= 16;
            }
            a = c < 0 ? -c : c;
            v = c < 0 ? c - 1 : c;
            nb = 0;
            while (a) {
                ++nb;
                a >>= 1;
            }
            int sym = (run << 4) + nb;
            bw.put(ac[t].code[sym], ac[t].size[sym]);
            bw.put((uint32_t)v, nb);
            run = 0;
        }
        if (run > 0) bw.put(ac[t].code[0], ac[t].size[0]);
    }

    void marker_dqt(BitWriter &bw, int t) {
        bw.byte(0xFF);
        bw.byte(0xDB);
        bw.u16(67);
        bw.byte((uint8_t)t);
        for (int i = 0; i < 64; ++i) bw.byte((uint8_t)q[t][kNatural[i]]);
    }

    void marker_dht(BitWriter &bw, int index, const uint8_t *bits,
                    const uint8_t *vals) {
        int count = 0;
        for (int i = 1; i <= 16; ++i) count += bits[i];
        bw.byte(0xFF);
        bw.byte(0xC4);
        bw.u16(count + 2 + 1 + 16);
        bw.byte((uint8_t)index);
        bw.bytes(bits + 1, 16);
        bw.bytes(vals, count);
    }

    size_t run(const uint8_t *bgr, int quality, uint8_t *out, size_t cap) {
        quality_table(kStdLuma, quality, q[0]);
        quality_table(kStdChroma, quality, q[1]);
        for (int t = 0; t < 2; ++t)
            for (int i = 0; i < 64; ++i) div[t][i] = reciprocal(q[t][i] << 3);
        dc[0].build(kDcLumBits, kDcVals);
        dc[1].build(kDcChmBits, kDcVals);
        ac[0].build(kAcLumBits, kAcLumVals);
        ac[1].build(kAcChmBits, kAcChmVals);

        static const RgbToYcc ycc;  // built once, thread-safe
        const int32_t *tab = ycc.tab;
        const int mcux = (w + 15) / 16, mcuy = (h + 15) / 16;
        const int ywb = (w + 7) / 8, yhb = (h + 7) / 8;  // Y blocks with samples
        const int ys = ywb * 8, yh = mcuy * 16;          // padded Y plane
        const int cfw = mcux * 16;                       // chroma before 2x2
        const int cw = mcux * 8, ch = mcuy * 8;          // padded chroma planes
        const int ch_real = (h + 1) / 2;
        std::vector<uint8_t> Y((size_t)ys * yh), Cb((size_t)cw * ch),
            Cr((size_t)cw * ch);
        std::vector<uint8_t> cb0(cfw), cr0(cfw), cb1(cfw), cr1(cfw);
        auto convert_row = [&](int y, uint8_t *yrow, uint8_t *cbrow,
                               uint8_t *crrow) {
            const uint8_t *s = bgr + (size_t)y * w * 3;
            for (int x = 0; x < w; ++x) {
                int b = s[3 * x], g = s[3 * x + 1], r = s[3 * x + 2];
                if (yrow) yrow[x] = (uint8_t)((tab[r] + tab[g + 256] + tab[b + 512]) >> 16);
                cbrow[x] = (uint8_t)((tab[r + 768] + tab[g + 1024] + tab[b + 1280]) >> 16);
                crrow[x] = (uint8_t)((tab[r + 1280] + tab[g + 1536] + tab[b + 1792]) >> 16);
            }
            // expand_right_edge
            if (yrow)
                for (int x = w; x < ys; ++x) yrow[x] = yrow[w - 1];
            for (int x = w; x < cfw; ++x) {
                cbrow[x] = cbrow[w - 1];
                crrow[x] = crrow[w - 1];
            }
        };
        for (int cy = 0; cy < ch_real; ++cy) {
            int y0 = 2 * cy, y1 = std::min(2 * cy + 1, h - 1);
            convert_row(y0, &Y[(size_t)y0 * ys], cb0.data(), cr0.data());
            if (y1 != y0)
                convert_row(y1, &Y[(size_t)y1 * ys], cb1.data(), cr1.data());
            else {
                cb1 = cb0;  // odd height: the last row pairs with itself
                cr1 = cr0;
            }
            uint8_t *ob = &Cb[(size_t)cy * cw], *orr = &Cr[(size_t)cy * cw];
            int bias = 1;
            for (int x = 0; x < cw; ++x) {
                ob[x] = (uint8_t)((cb0[2 * x] + cb0[2 * x + 1] + cb1[2 * x] +
                                   cb1[2 * x + 1] + bias) >> 2);
                orr[x] = (uint8_t)((cr0[2 * x] + cr0[2 * x + 1] + cr1[2 * x] +
                                    cr1[2 * x + 1] + bias) >> 2);
                bias ^= 3;
            }
        }
        // expand_bottom_edge
        for (int y = h; y < yh; ++y)
            std::memcpy(&Y[(size_t)y * ys], &Y[(size_t)(h - 1) * ys], ys);
        for (int y = ch_real; y < ch; ++y) {
            std::memcpy(&Cb[(size_t)y * cw], &Cb[(size_t)(ch_real - 1) * cw], cw);
            std::memcpy(&Cr[(size_t)y * cw], &Cr[(size_t)(ch_real - 1) * cw], cw);
        }

        BitWriter bw{out, cap};
        static const uint8_t jfif[18] = {0xFF, 0xD8, 0xFF, 0xE0, 0, 16, 'J', 'F',
                                         'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1};
        bw.bytes(jfif, sizeof(jfif));
        bw.byte(0);
        bw.byte(0);
        marker_dqt(bw, 0);
        marker_dqt(bw, 1);
        const uint8_t sof[] = {0xFF, 0xC0, 0, 17, 8,
                               (uint8_t)(h >> 8), (uint8_t)h,
                               (uint8_t)(w >> 8), (uint8_t)w, 3,
                               1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1};
        bw.bytes(sof, sizeof(sof));
        marker_dht(bw, 0x00, kDcLumBits, kDcVals);
        marker_dht(bw, 0x10, kAcLumBits, kAcLumVals);
        marker_dht(bw, 0x01, kDcChmBits, kDcVals);
        marker_dht(bw, 0x11, kAcChmBits, kAcChmVals);
        const uint8_t sos[] = {0xFF, 0xDA, 0, 12, 3, 1, 0x00, 2, 0x11,
                               3, 0x11, 0, 63, 0};
        bw.bytes(sos, sizeof(sos));

        int pred[3] = {0, 0, 0};
        int16_t blk[6][64];
        for (int my = 0; my < mcuy; ++my) {
            for (int mx = 0; mx < mcux; ++mx) {
                for (int j = 0; j < 2; ++j) {
                    int by = 2 * my + j;
                    for (int i = 0; i < 2; ++i) {
                        int bx = 2 * mx + i, k = 2 * j + i;
                        if (by < yhb && bx < ywb) {
                            fdct_quant(Y.data(), ys, bx * 8, by * 8, 0, blk[k]);
                        } else {
                            // libjpeg's dummy blocks: zero AC, the DC of the
                            // block before it in the MCU (jccoefct.c)
                            std::memset(blk[k], 0, sizeof(blk[k]));
                            blk[k][0] = by < yhb ? blk[k - 1][0]
                                                 : blk[2 * j - 1][0];
                        }
                    }
                }
                fdct_quant(Cb.data(), cw, mx * 8, my * 8, 1, blk[4]);
                fdct_quant(Cr.data(), cw, mx * 8, my * 8, 1, blk[5]);
                for (int k = 0; k < 4; ++k) huff_block(bw, blk[k], pred[0], 0);
                huff_block(bw, blk[4], pred[1], 1);
                huff_block(bw, blk[5], pred[2], 1);
            }
        }
        bw.flush();
        bw.byte(0xFF);
        bw.byte(0xD9);
        return bw.len;
    }
};

}  // namespace

extern "C" {

int evam_codec_version() { return 1; }

// I420 planes (y: h x w, u and v: h/2 x w/2) -> BGR (h x w x 3), the
// pixels of cv2.cvtColor(planar, COLOR_YUV2BGR_I420): BT.601 studio
// swing in 20-bit fixed point, each chroma sample over its 2x2 block.
void evam_i420_to_bgr(const uint8_t *y, const uint8_t *u, const uint8_t *v,
                      uint8_t *out, int h, int w) {
    const int shift = 20, half = 1 << 19;
    const int cy = 1220542, cub = 2116026, cug = -409993, cvg = -852492,
              cvr = 1673527;
    const int cw = w / 2;
    for (int r = 0; r < h; ++r) {
        const uint8_t *yr = y + (size_t)r * w;
        const uint8_t *ur = u + (size_t)(r / 2) * cw;
        const uint8_t *vr = v + (size_t)(r / 2) * cw;
        uint8_t *o = out + (size_t)r * w * 3;
        for (int c = 0; c < cw; ++c) {
            int uu = ur[c] - 128, vv = vr[c] - 128;
            int bt = half + cub * uu, gt = half + cvg * vv + cug * uu,
                rt = half + cvr * vv;
            for (int k = 0; k < 2; ++k) {
                int yy = std::max(0, yr[2 * c + k] - 16) * cy;
                uint8_t *p = o + 3 * (2 * c + k);
                p[0] = clamp8((yy + bt) >> shift);
                p[1] = clamp8((yy + gt) >> shift);
                p[2] = clamp8((yy + rt) >> shift);
            }
        }
    }
}

// Reads the frame header: 0 and the image size, or -1 and a message.
int evam_jpeg_info(const uint8_t *data, long len, int *width, int *height,
                   char *err, int errlen) {
    try {
        Decoder dec(data, (size_t)len);
        dec.parse(true);
        if (!dec.frame) throw JpegError("jpeg: no frame header (SOF)");
        *width = dec.width;
        *height = dec.height;
        return 0;
    } catch (const std::exception &e) {
        put_error(err, errlen, e.what());
        return -1;
    }
}

// Decodes into out (height x width x 3 BGR, the size evam_jpeg_info
// read): 0, or -1 and a message.
int evam_jpeg_decode(const uint8_t *data, long len, uint8_t *out,
                     int width, int height, char *err, int errlen) {
    try {
        Decoder dec(data, (size_t)len);
        dec.parse(false);
        if (dec.width != width || dec.height != height)
            throw JpegError("jpeg: the output buffer has another size");
        dec.render(out);
        return 0;
    } catch (const std::bad_alloc &) {
        put_error(err, errlen, "jpeg: out of memory");
        return -1;
    } catch (const std::exception &e) {
        put_error(err, errlen, e.what());
        return -1;
    }
}

// Encodes a BGR frame (height x width x 3, rows contiguous) at quality
// 0-100 (0 acts as 1, as in libjpeg): the byte count, or -1 and a
// message.
long evam_jpeg_encode(const uint8_t *bgr, int height, int width,
                      int quality, uint8_t *out, long cap, char *err,
                      int errlen) {
    try {
        if (width < 1 || height < 1 || width > 65535 || height > 65535)
            throw JpegError("jpeg: image size outside 1..65535");
        Encoder enc;
        enc.w = width;
        enc.h = height;
        return (long)enc.run(bgr, quality, out, (size_t)cap);
    } catch (const std::bad_alloc &) {
        put_error(err, errlen, "jpeg: out of memory");
        return -1;
    } catch (const std::exception &e) {
        put_error(err, errlen, e.what());
        return -1;
    }
}

}  // extern "C"
