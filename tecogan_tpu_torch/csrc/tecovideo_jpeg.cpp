// Baseline JPEG (Motion JPEG frames) for libtecovideo.
//
// Decoder: 8-bit sequential Huffman (SOF0, SOF1); 4:2:0, 4:2:2, 4:4:4 and
// gray; DRI and RSTn; the Annex K tables where a frame has no DHT (AVI
// MJPEG from cameras often carries none). DC accumulates dequantised from
// 1024, as FFmpeg's mjpegdec does, and blocks go through the simple IDCT.
// Progressive, lossless and arithmetic-coded frames raise Unsupported.
//
// Encoder: 4:2:0, the Annex K tables scaled to one quality as libjpeg
// scales them, DQT and DHT in every frame.
#include <algorithm>
#include <cmath>

#include "tecovideo.h"

namespace tv {
namespace {

// Annex K.3 Huffman tables: counts per code length 1..16, then the symbols.
const uint8_t kDcLumBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumVals[162] = {
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
    0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromVals[162] = {
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
    0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// Annex K.1 quantisation tables (raster order) for quality 50.
const uint8_t kLumQuant[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kChromQuant[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99, 24, 26, 56, 99, 99, 99,
    99, 99, 47, 66, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// A Huffman table as counts + symbols, with a canonical decoder.
struct Huffman {
    uint8_t bits[16] = {};
    uint8_t vals[256] = {};
    int count = 0;
    bool defined = false;
    // Decoding: lookup over 16 bits is built lazily.
    std::vector<uint16_t> lut;  // (len << 8) | symbol, len 0 = invalid
    // Encoding: code and length per symbol.
    uint16_t code[256] = {};
    uint8_t len[256] = {};

    void set(const uint8_t* b, const uint8_t* v) {
        std::copy(b, b + 16, bits);
        count = 0;
        for (int i = 0; i < 16; i++) count += bits[i];
        if (count > 256) throw DecodeError("JPEG: a Huffman table with over 256 symbols");
        std::copy(v, v + count, vals);
        defined = true;
        lut.clear();
        uint32_t c = 0;
        int k = 0;
        std::fill(len, len + 256, 0);
        for (int l = 1; l <= 16; l++) {
            for (int i = 0; i < bits[l - 1]; i++, k++) {
                code[vals[k]] = uint16_t(c);
                len[vals[k]] = uint8_t(l);
                c++;
            }
            c <<= 1;
        }
    }
    void build_lut() {
        lut.assign(65536, 0);
        uint32_t c = 0;
        int k = 0;
        for (int l = 1; l <= 16; l++) {
            for (int i = 0; i < bits[l - 1]; i++, k++) {
                if (c >= (1u << l)) throw DecodeError("JPEG: an over-subscribed Huffman table");
                uint32_t first = c << (16 - l), n = 1u << (16 - l);
                for (uint32_t j = 0; j < n; j++) lut[first + j] = uint16_t((l << 8) | vals[k]);
                c++;
            }
            c <<= 1;
        }
    }
    int decode(BitReader& br) {
        if (lut.empty()) build_lut();
        uint16_t e = lut[br.show(16)];
        if (!(e >> 8)) throw DecodeError("JPEG: an invalid Huffman code");
        br.skip(e >> 8);
        return e & 0xFF;
    }
};

struct Component {
    int id = 0, h = 1, v = 1, tq = 0;
    int td = 0, ta = 0;
    int bw = 0, bh = 0;  // blocks across and down the plane (whole MCUs)
};

inline int read16(const uint8_t* p) { return (p[0] << 8) | p[1]; }

}  // namespace

struct JpegDecoder::Impl {
    Impl() {
        dc_[0].set(kDcLumBits, kDcVals);
        dc_[1].set(kDcChromBits, kDcVals);
        ac_[0].set(kAcLumBits, kAcLumVals);
        ac_[1].set(kAcChromBits, kAcChromVals);
    }

    void decode(const uint8_t* d, size_t n, Picture& pic) {
        if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) throw DecodeError("JPEG: no SOI marker");
        size_t p = 2;
        bool have_frame = false, have_scan = false;
        restart_ = 0;  // DRI holds for one frame
        while (p < n) {
            if (d[p] != 0xFF) {  // garbage between segments: skip to the next marker
                p++;
                continue;
            }
            while (p < n && d[p] == 0xFF) p++;
            if (p >= n) break;
            int m = d[p++];
            if (m == 0xD9) break;  // EOI
            if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
            if (p + 2 > n) throw DecodeError("JPEG: truncated segment");
            int len = read16(d + p);
            if (len < 2 || p + len > n) throw DecodeError("JPEG: truncated segment");
            const uint8_t* s = d + p + 2;
            int sl = len - 2;
            if (m == 0xDB) {
                parse_dqt(s, sl);
            } else if (m == 0xC4) {
                parse_dht(s, sl);
            } else if (m == 0xC0 || m == 0xC1) {
                parse_sof(s, sl, pic);
                have_frame = true;
            } else if (m == 0xC2 || m == 0xC6 || m == 0xCA || m == 0xCE) {
                throw Unsupported("JPEG: progressive coding");
            } else if (m == 0xC3 || m == 0xC7 || m == 0xCB || m == 0xCF) {
                throw Unsupported("JPEG: lossless coding");
            } else if (m == 0xC5 || m == 0xC9 || m == 0xCD || m == 0xCC) {
                throw Unsupported("JPEG: arithmetic coding");
            } else if (m == 0xDD) {
                if (sl < 2) throw DecodeError("JPEG: short DRI");
                restart_ = read16(s);
            } else if (m == 0xDA) {
                if (!have_frame) throw DecodeError("JPEG: SOS before SOF");
                p = decode_scan(s, sl, d + p + len, d + n, pic) - d;
                have_scan = true;
                continue;
            }
            p += len;
        }
        if (!have_scan) throw DecodeError("JPEG: no scan");
    }

    void parse_dqt(const uint8_t* s, int n) {
        int i = 0;
        while (i < n) {
            int pq = s[i] >> 4, tq = s[i] & 15;
            i++;
            if (tq > 3) throw DecodeError("JPEG: bad DQT table id");
            int sz = pq ? 128 : 64;
            if (i + sz > n) throw DecodeError("JPEG: short DQT");
            for (int k = 0; k < 64; k++)
                quant_[tq][kZigzag[k]] = uint16_t(pq ? read16(s + i + 2 * k) : s[i + k]);
            i += sz;
        }
    }
    void parse_dht(const uint8_t* s, int n) {
        int i = 0;
        while (i < n) {
            if (i + 17 > n) throw DecodeError("JPEG: short DHT");
            int tc = s[i] >> 4, th = s[i] & 15;
            if (tc > 1 || th > 3) throw DecodeError("JPEG: bad DHT table id");
            const uint8_t* bits = s + i + 1;
            int count = 0;
            for (int k = 0; k < 16; k++) count += bits[k];
            if (i + 17 + count > n) throw DecodeError("JPEG: short DHT");
            Huffman& t = tc ? ac_[th] : dc_[th];
            // Frames repeat the same tables: keep the lookup when they match.
            bool same = t.defined && std::equal(bits, bits + 16, t.bits) && count == t.count &&
                        std::equal(s + i + 17, s + i + 17 + count, t.vals);
            if (!same) t.set(bits, s + i + 17);
            i += 17 + count;
        }
    }
    void parse_sof(const uint8_t* s, int n, Picture& pic) {
        if (n < 6) throw DecodeError("JPEG: short SOF");
        if (s[0] != 8) throw Unsupported("JPEG: sample precision other than 8 bits");
        height_ = read16(s + 1);
        width_ = read16(s + 3);
        int nc = s[5];
        if (!width_ || !height_) throw DecodeError("JPEG: zero size");
        if ((nc != 1 && nc != 3) || n < 6 + 3 * nc)
            throw Unsupported("JPEG: component count other than 1 or 3");
        ncomp_ = nc;
        hmax_ = vmax_ = 1;
        for (int c = 0; c < nc; c++) {
            comp_[c].id = s[6 + 3 * c];
            comp_[c].h = s[7 + 3 * c] >> 4;
            comp_[c].v = s[7 + 3 * c] & 15;
            comp_[c].tq = s[8 + 3 * c] & 3;
            if (comp_[c].h < 1 || comp_[c].h > 2 || comp_[c].v < 1 || comp_[c].v > 2)
                throw Unsupported("JPEG: sampling factors outside 1-2");
            hmax_ = std::max(hmax_, comp_[c].h);
            vmax_ = std::max(vmax_, comp_[c].v);
        }
        int sx = 0, sy = 0;
        if (nc == 3) {
            if (comp_[1].h != comp_[2].h || comp_[1].v != comp_[2].v || comp_[0].h != hmax_ ||
                comp_[0].v != vmax_ || comp_[1].h != 1 || comp_[1].v != 1)
                throw Unsupported("JPEG: chroma subsampling other than 4:2:0, 4:2:2, 4:4:4");
            sx = hmax_ - 1;
            sy = vmax_ - 1;
            if (sx == 0 && sy == 1) throw Unsupported("JPEG: 4:4:0 subsampling");
        } else {
            hmax_ = vmax_ = comp_[0].h = comp_[0].v = 1;  // one component: no MCU grouping
        }
        pic.alloc(width_, height_, sx, sy, 8 * hmax_, 8 * vmax_);
        pic.gray = nc == 1;
        pic.full_range = true;
        mcux_ = (width_ + 8 * hmax_ - 1) / (8 * hmax_);
        mcuy_ = (height_ + 8 * vmax_ - 1) / (8 * vmax_);
        for (int c = 0; c < nc; c++) {
            comp_[c].bw = mcux_ * comp_[c].h;
            comp_[c].bh = mcuy_ * comp_[c].v;
        }
    }

    // Entropy-coded data from `p` up to the next marker that is not RSTn,
    // unstuffed, split at RST markers. Returns where the next marker starts.
    const uint8_t* collect(const uint8_t* p, const uint8_t* end,
                           std::vector<std::vector<uint8_t>>& segs) {
        segs.assign(1, {});
        while (p < end) {
            uint8_t b = *p;
            if (b != 0xFF) {
                segs.back().push_back(b);
                p++;
                continue;
            }
            if (p + 1 >= end) return end;
            uint8_t m = p[1];
            if (m == 0x00) {
                segs.back().push_back(0xFF);
                p += 2;
            } else if (m == 0xFF) {
                p++;  // fill byte
            } else if (m >= 0xD0 && m <= 0xD7) {
                segs.emplace_back();
                p += 2;
            } else {
                return p;
            }
        }
        return end;
    }

    const uint8_t* decode_scan(const uint8_t* s, int n, const uint8_t* data, const uint8_t* end,
                               Picture& pic) {
        if (n < 1) throw DecodeError("JPEG: short SOS");
        int ns = s[0];
        if (ns < 1 || ns > ncomp_ || n < 1 + 2 * ns + 3) throw DecodeError("JPEG: bad SOS");
        int idx[3];
        for (int i = 0; i < ns; i++) {
            int cid = s[1 + 2 * i], c = -1;
            for (int k = 0; k < ncomp_; k++)
                if (comp_[k].id == cid) c = k;
            if (c < 0) throw DecodeError("JPEG: SOS names an unknown component");
            comp_[c].td = s[2 + 2 * i] >> 4;
            comp_[c].ta = s[2 + 2 * i] & 15;
            if (comp_[c].td > 3 || comp_[c].ta > 3) throw DecodeError("JPEG: bad table id");
            idx[i] = c;
        }
        int ss = s[1 + 2 * ns], se = s[2 + 2 * ns], ahl = s[3 + 2 * ns];
        if (ss != 0 || se != 63 || ahl != 0) throw Unsupported("JPEG: progressive scan");
        std::vector<std::vector<uint8_t>> segs;
        const uint8_t* next = collect(data, end, segs);
        for (auto& seg : segs) seg.resize(seg.size() + 8, 0);

        // A scan of one component codes that component's blocks one by one,
        // over its own size (not whole MCUs).
        bool single = ns == 1;
        int units_x, units_y;
        if (single) {
            const Component& c = comp_[idx[0]];
            int cw = (width_ * c.h + hmax_ - 1) / hmax_, ch = (height_ * c.v + vmax_ - 1) / vmax_;
            units_x = (cw + 7) / 8;
            units_y = (ch + 7) / 8;
        } else {
            units_x = mcux_;
            units_y = mcuy_;
        }
        int last_dc[3] = {1024, 1024, 1024};
        size_t seg = 0;
        BitReader br(segs[0].data(), segs[0].size());
        int16_t block[64];
        const int total = units_x * units_y;
        for (int u = 0; u < total; u++) {
            if (restart_ && u && u % restart_ == 0) {
                if (seg + 1 < segs.size()) {
                    seg++;
                    br = BitReader(segs[seg].data(), segs[seg].size());
                }
                last_dc[0] = last_dc[1] = last_dc[2] = 1024;
            }
            int ux = u % units_x, uy = u / units_x;
            for (int i = 0; i < ns; i++) {
                int ci = idx[i];
                Component& c = comp_[ci];
                int nh = single ? 1 : c.h, nv = single ? 1 : c.v;
                for (int by = 0; by < nv; by++)
                    for (int bx = 0; bx < nh; bx++) {
                        decode_block(br, c, last_dc[i], block);
                        int px = (single ? ux : ux * c.h + bx) * 8;
                        int py = (single ? uy : uy * c.v + by) * 8;
                        int pl = ci;
                        if (py + 8 > pic.rows[pl] || px + 8 > pic.stride[pl]) continue;
                        idct_put(block, pic.plane[pl].data() + size_t(py) * pic.stride[pl] + px,
                                 pic.stride[pl]);
                    }
            }
        }
        return next;
    }

    void decode_block(BitReader& br, Component& c, int& last_dc, int16_t* block) {
        std::fill(block, block + 64, 0);
        const uint16_t* q = quant_[c.tq];
        int t = dc_[c.td].decode(br);
        if (t > 11) throw DecodeError("JPEG: bad DC magnitude");
        int dc = br.get_xbits(t) * q[0] + last_dc;
        last_dc = dc;
        block[0] = int16_t(std::clamp(dc, -32768, 32767));
        Huffman& ac = ac_[c.ta];
        for (int k = 1; k < 64;) {
            int rs = ac.decode(br);
            int r = rs >> 4, sz = rs & 15;
            if (!sz) {
                if (r != 15) break;
                k += 16;
                continue;
            }
            k += r;
            if (k > 63) throw DecodeError("JPEG: AC run past the block");
            int z = kZigzag[k];
            block[z] = int16_t(br.get_xbits(sz) * q[z]);
            k++;
        }
        if (br.overrun()) throw DecodeError("JPEG: truncated scan");
    }

    Huffman dc_[4], ac_[4];
    uint16_t quant_[4][64] = {};
    Component comp_[3];
    int ncomp_ = 0, width_ = 0, height_ = 0, hmax_ = 1, vmax_ = 1, mcux_ = 0, mcuy_ = 0;
    int restart_ = 0;
};

JpegDecoder::JpegDecoder() : impl_(new Impl) {}
JpegDecoder::~JpegDecoder() { delete impl_; }
void JpegDecoder::decode(const uint8_t* data, size_t size, Picture& pic) {
    impl_->decode(data, size, pic);
}

namespace {

void put16(std::vector<uint8_t>& o, int v) {
    o.push_back(uint8_t(v >> 8));
    o.push_back(uint8_t(v));
}

void scale_quant(const uint8_t* base, int quality, uint8_t* out) {
    quality = std::clamp(quality, 1, 100);
    int scale = quality < 50 ? 5000 / quality : 200 - 2 * quality;
    for (int i = 0; i < 64; i++) out[i] = uint8_t(std::clamp((base[i] * scale + 50) / 100, 1, 255));
}

void put_dht(std::vector<uint8_t>& o, int tc_th, const uint8_t* bits, const uint8_t* vals) {
    int count = 0;
    for (int i = 0; i < 16; i++) count += bits[i];
    o.push_back(uint8_t(tc_th));
    o.insert(o.end(), bits, bits + 16);
    o.insert(o.end(), vals, vals + count);
}

void encode_block(BitWriter& bw, const int* coef, const uint8_t* q, int& last_dc,
                  const Huffman& dc, const Huffman& ac) {
    int qc[64];
    for (int i = 0; i < 64; i++) {
        double v = double(coef[i]) / q[i];
        qc[i] = int(std::lround(v));
    }
    auto put_value = [&](const Huffman& h, int sym, int value, int size) {
        bw.put(h.code[sym], h.len[sym]);
        if (size) bw.put(uint32_t(value < 0 ? value + (1 << size) - 1 : value), size);
    };
    auto magnitude = [](int v) {
        int a = v < 0 ? -v : v, s = 0;
        while (a) {
            s++;
            a >>= 1;
        }
        return s;
    };
    int diff = qc[0] - last_dc;
    last_dc = qc[0];
    int s = magnitude(diff);
    put_value(dc, s, diff, s);
    int run = 0;
    for (int k = 1; k < 64; k++) {
        int v = qc[kZigzag[k]];
        if (!v) {
            run++;
            continue;
        }
        while (run > 15) {
            bw.put(ac.code[0xF0], ac.len[0xF0]);
            run -= 16;
        }
        v = std::clamp(v, -1023, 1023);
        int sz = magnitude(v);
        put_value(ac, (run << 4) | sz, v, sz);
        run = 0;
    }
    if (run) bw.put(ac.code[0x00], ac.len[0x00]);
}

}  // namespace

std::vector<uint8_t> jpeg_encode(const uint8_t* rgb, int width, int height, int quality) {
    if (width > 65535 || height > 65535) throw DecodeError("JPEG: frame larger than 65535");
    Picture pic;
    rgb_to_yuv420(rgb, width, height, true, pic, 16);
    uint8_t ql[64], qc[64];
    scale_quant(kLumQuant, quality, ql);
    scale_quant(kChromQuant, quality, qc);
    Huffman dcl, dcc, acl, acc;
    dcl.set(kDcLumBits, kDcVals);
    dcc.set(kDcChromBits, kDcVals);
    acl.set(kAcLumBits, kAcLumVals);
    acc.set(kAcChromBits, kAcChromVals);

    std::vector<uint8_t> o = {0xFF, 0xD8};
    o.insert(o.end(), {0xFF, 0xDB});
    put16(o, 2 + 2 * 65);
    o.push_back(0x00);
    for (int k = 0; k < 64; k++) o.push_back(ql[kZigzag[k]]);
    o.push_back(0x01);
    for (int k = 0; k < 64; k++) o.push_back(qc[kZigzag[k]]);
    o.insert(o.end(), {0xFF, 0xC0});
    put16(o, 17);
    o.push_back(8);
    put16(o, height);
    put16(o, width);
    o.insert(o.end(), {3, 1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1});
    std::vector<uint8_t> dht;
    put_dht(dht, 0x00, kDcLumBits, kDcVals);
    put_dht(dht, 0x10, kAcLumBits, kAcLumVals);
    put_dht(dht, 0x01, kDcChromBits, kDcVals);
    put_dht(dht, 0x11, kAcChromBits, kAcChromVals);
    o.insert(o.end(), {0xFF, 0xC4});
    put16(o, 2 + int(dht.size()));
    o.insert(o.end(), dht.begin(), dht.end());
    o.insert(o.end(), {0xFF, 0xDA});
    put16(o, 12);
    o.insert(o.end(), {3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0});

    BitWriter bw;
    bw.set_jpeg_stuffing(true);
    int dc[3] = {0, 0, 0};
    int coef[64];
    const int mx = (width + 15) / 16, my = (height + 15) / 16;
    for (int y = 0; y < my; y++)
        for (int x = 0; x < mx; x++) {
            for (int b = 0; b < 4; b++) {
                const uint8_t* src = pic.plane[0].data() +
                                     size_t(16 * y + 8 * (b >> 1)) * pic.stride[0] + 16 * x +
                                     8 * (b & 1);
                fdct(src, pic.stride[0], 128, coef);
                encode_block(bw, coef, ql, dc[0], dcl, acl);
            }
            for (int c = 1; c < 3; c++) {
                fdct(pic.plane[c].data() + size_t(8 * y) * pic.stride[c] + 8 * x, pic.stride[c],
                     128, coef);
                encode_block(bw, coef, qc, dc[c], dcc, acc);
            }
        }
    bw.pad_ones();
    o.insert(o.end(), bw.bytes().begin(), bw.bytes().end());
    o.insert(o.end(), {0xFF, 0xD9});
    return o;
}

}  // namespace tv
