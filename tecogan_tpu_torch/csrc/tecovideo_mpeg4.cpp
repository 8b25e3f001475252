// MPEG-4 Part 2 (ISO/IEC 14496-2) for libtecovideo.
//
// Decoder: what lavc's encoder writes for the mp4v and XVID fourccs. The
// VOS/VO/VOL headers from the extradata or in-band; I- and P-VOPs and
// vop_coded = 0; H.263 and MPEG quantisation; intra DC VLC and DC/AC
// prediction; 1MV and 4MV with median prediction; half-pel motion
// compensation with vop_rounding_type; unrestricted MVs (reads clamp to the
// picture's edge); not-coded macroblocks; sizes that are not a multiple of
// 16. Reconstruction follows FFmpeg's mpeg4videodec/h263dec (prediction
// rules, escape coding, dequantisation, the simple IDCT), so the planes
// match what cv2.VideoCapture decodes. B-VOPs, quarter-pel, GMC/sprites,
// interlace, data partitioning/RVLC and resync markers raise Unsupported.
//
// Encoder: Simple Profile, I-VOPs only, H.263 quantisation at one fixed
// quantiser, intra DC prediction, AC prediction off.
#include <algorithm>
#include <cmath>
#include <cstdlib>

#include "tecovideo.h"

namespace tv {
namespace {

// ---------------------------------------------------------------- tables
// MCBPC for I-VOPs: index = dquant * 4 + chroma cbp; 8 = stuffing.
const uint16_t kIntraMcbpcCode[9] = {1, 1, 2, 3, 1, 1, 2, 3, 1};
const uint8_t kIntraMcbpcLen[9] = {1, 3, 3, 3, 4, 6, 6, 6, 9};
// MCBPC for P-VOPs: index = 4mv * 16 + dquant * 8 + intra * 4 + chroma cbp;
// 20 = stuffing; 21-23 unused.
const uint16_t kInterMcbpcCode[28] = {1, 3, 2, 5, 3, 4, 3, 3, 3, 7, 6, 5, 4, 4,
                                      3, 2, 2, 5, 4, 5, 1, 0, 0, 0, 2, 12, 14, 15};
const uint8_t kInterMcbpcLen[28] = {1, 4, 4, 6, 5, 8, 8, 7, 3, 7, 7, 9, 6, 9,
                                    9, 9, 3, 7, 7, 8, 9, 0, 0, 0, 11, 13, 13, 13};
// CBPY (intra form; inter macroblocks invert the four bits).
const uint16_t kCbpyCode[16] = {3, 5, 4, 9, 3, 7, 2, 11, 2, 3, 5, 10, 4, 8, 6, 3};
const uint8_t kCbpyLen[16] = {4, 5, 5, 4, 5, 4, 6, 4, 5, 6, 4, 4, 4, 4, 4, 2};
// Motion vector differences, magnitude 0..32 (a sign bit follows if > 0).
const uint16_t kMvCode[33] = {1,  1,  1,  1,  3,  5,  4,  3,  11, 10, 9, 17, 16, 15, 14, 13, 12,
                              11, 10, 9, 8,  7,  6,  5,  4,  7,  6,  5, 4,  3,  2,  3,  2};
const uint8_t kMvLen[33] = {1,  2,  3,  4,  6,  7,  7,  7,  9,  9,  9,  10, 10, 10, 10, 10, 10,
                            10, 10, 10, 10, 10, 10, 10, 10, 11, 11, 11, 11, 11, 11, 12, 12};
// Intra DC size, luminance and chrominance.
const uint16_t kDcLumCode[13] = {3, 3, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1};
const uint8_t kDcLumLen[13] = {3, 2, 2, 3, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint16_t kDcChromCode[13] = {3, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1};
const uint8_t kDcChromLen[13] = {2, 2, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12};

// TCOEF tables: 102 (last, run, level) events and the escape (index 102).
struct RunLevel {
    uint16_t code[103];
    uint8_t len[103];
    int8_t run[102];
    int8_t level[102];
    int last;  // first index with last = 1
};

const RunLevel kInterRl = {
    {0x2,  0xf,  0x15, 0x17, 0x1f, 0x25, 0x24, 0x21, 0x20, 0x7,  0x6,  0x20, 0x6,  0x14, 0x1e,
     0xf,  0x21, 0x50, 0xe,  0x1d, 0xe,  0x51, 0xd,  0x23, 0xd,  0xc,  0x22, 0x52, 0xb,  0xc,
     0x53, 0x13, 0xb,  0x54, 0x12, 0xa,  0x11, 0x9,  0x10, 0x8,  0x16, 0x55, 0x15, 0x14, 0x1c,
     0x1b, 0x21, 0x20, 0x1f, 0x1e, 0x1d, 0x1c, 0x1b, 0x1a, 0x22, 0x23, 0x56, 0x57, 0x7,  0x19,
     0x5,  0xf,  0x4,  0xe,  0xd,  0xc,  0x13, 0x12, 0x11, 0x10, 0x1a, 0x19, 0x18, 0x17, 0x16,
     0x15, 0x14, 0x13, 0x18, 0x17, 0x16, 0x15, 0x14, 0x13, 0x12, 0x11, 0x7,  0x6,  0x5,  0x4,
     0x24, 0x25, 0x26, 0x27, 0x58, 0x59, 0x5a, 0x5b, 0x5c, 0x5d, 0x5e, 0x5f, 0x3},
    {2,  4,  6,  7,  8,  9,  9,  10, 10, 11, 11, 11, 3,  6,  8,  10, 11, 12, 4,  8,  10,
     12, 5,  9,  10, 5,  9,  12, 5,  10, 12, 6,  10, 12, 6,  10, 6,  10, 6,  10, 7,  12,
     7,  7,  8,  8,  9,  9,  9,  9,  9,  9,  9,  9,  11, 11, 12, 12, 4,  9,  11, 6,  11,
     6,  6,  6,  7,  7,  7,  7,  8,  8,  8,  8,  8,  8,  8,  8,  9,  9,  9,  9,  9,  9,
     9,  9,  10, 10, 10, 10, 11, 11, 11, 11, 12, 12, 12, 12, 12, 12, 12, 12, 7},
    {0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  1,  1,  1,  1,  1,  1,  2,  2,  2,
     2,  3,  3,  3,  4,  4,  4,  5,  5,  5,  6,  6,  6,  7,  7,  8,  8,  9,  9,  10, 10,
     11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 0,  0,  0,  1,  1,
     2,  3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22,
     23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40},
    {1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 1, 2, 3, 4, 5, 6, 1, 2, 3, 4, 1, 2, 3, 1,
     2, 3, 1, 2, 3, 1, 2, 3, 1, 2,  1,  2,  1, 2, 1, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
     1, 1, 1, 1, 1, 1, 1, 2, 3, 1,  2,  1,  1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
     1, 1, 1, 1, 1, 1, 1, 1, 1, 1,  1,  1,  1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1},
    58};

const RunLevel kIntraRl = {
    {0x2,  0x6,  0xf,  0xd,  0xc,  0x15, 0x13, 0x12, 0x17, 0x1f, 0x1e, 0x1d, 0x25, 0x24, 0x23,
     0x21, 0x21, 0x20, 0xf,  0xe,  0x7,  0x6,  0x20, 0x21, 0x50, 0x51, 0x52, 0xe,  0x14, 0x16,
     0x1c, 0x20, 0x1f, 0xd,  0x22, 0x53, 0x55, 0xb,  0x15, 0x1e, 0xc,  0x56, 0x11, 0x1b, 0x1d,
     0xb,  0x10, 0x22, 0xa,  0xd,  0x1c, 0x8,  0x12, 0x1b, 0x54, 0x14, 0x1a, 0x57, 0x19, 0x9,
     0x18, 0x23, 0x17, 0x19, 0x18, 0x7,  0x58, 0x7,  0xc,  0x16, 0x17, 0x6,  0x5,  0x4,  0x59,
     0xf,  0x16, 0x5,  0xe,  0x4,  0x11, 0x24, 0x10, 0x25, 0x13, 0x5a, 0x15, 0x5b, 0x14, 0x13,
     0x1a, 0x15, 0x14, 0x13, 0x12, 0x11, 0x26, 0x27, 0x5c, 0x5d, 0x5e, 0x5f, 0x3},
    {2,  3,  4,  5,  5,  6,  6,  6,  7,  8,  8,  8,  9,  9,  9,  9,  10, 10, 10, 10, 11,
     11, 11, 11, 12, 12, 12, 4,  6,  7,  8,  9,  9,  10, 11, 12, 12, 5,  7,  9,  10, 12,
     6,  8,  9,  10, 6,  9,  10, 6,  9,  10, 7,  9,  12, 7,  9,  12, 8,  10, 8,  11, 8,
     9,  9,  10, 12, 4,  6,  8,  9,  10, 11, 11, 12, 6,  9,  10, 6,  10, 7,  11, 7,  11,
     7,  12, 8,  12, 8,  8,  8,  9,  9,  9,  9,  9,  11, 11, 12, 12, 12, 12, 7},
    {0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,  0,  0,  0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
     0, 1, 1, 1, 1, 1, 1, 1,  1,  1,  1,  2,  2,  2,  2, 2, 3, 3, 3, 3, 4, 4, 4, 5, 5, 5,
     6, 6, 6, 7, 7, 7, 8, 8,  9,  9,  10, 11, 12, 13, 14, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1,
     2, 2, 3, 3, 4, 4, 5, 5,  6,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20},
    {1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26,
     27, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 1, 2, 3, 4, 5, 1, 2, 3, 4, 1, 2, 3, 1, 2, 3,
     1, 2, 3, 1, 2, 3, 1, 2, 1, 2, 1, 1, 1, 1, 1, 1, 2, 3, 4, 5, 6, 7, 8, 1, 2, 3,
     1, 2, 1, 2, 1, 2, 1, 2, 1, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1},
    67};

// Derived per table: max level per (last, run), max run per (last, level),
// and the event index per (last, run, level) for the encoder.
struct RlInfo {
    const RunLevel* t;
    Vlc vlc;
    int max_level[2][64];
    int max_run[2][65];
    int index[2][64][28];  // -1: not in the table
    explicit RlInfo(const RunLevel& tab) : t(&tab), vlc(tab.code, tab.len, 103) {
        std::fill(&max_level[0][0], &max_level[0][0] + 2 * 64, 0);
        std::fill(&max_run[0][0], &max_run[0][0] + 2 * 65, 0);
        std::fill(&index[0][0][0], &index[0][0][0] + 2 * 64 * 28, -1);
        for (int i = 0; i < 102; i++) {
            int last = i >= tab.last, run = tab.run[i], level = tab.level[i];
            max_level[last][run] = std::max(max_level[last][run], level);
            max_run[last][level] = std::max(max_run[last][level], run);
            index[last][run][level] = i;
        }
    }
};

const uint8_t kAltHorizontalScan[64] = {
    0,  1,  2,  3,  8,  9,  16, 17, 10, 11, 4,  5,  6,  7,  15, 14, 13, 12, 19, 18, 24, 25,
    32, 33, 26, 27, 20, 21, 22, 23, 28, 29, 30, 31, 34, 35, 40, 41, 48, 49, 42, 43, 36, 37,
    38, 39, 44, 45, 46, 47, 50, 51, 56, 57, 58, 59, 52, 53, 54, 55, 60, 61, 62, 63};

struct Scans {
    uint8_t vertical[64];
    Scans() {  // the alternate vertical scan is the horizontal one transposed
        for (int i = 0; i < 64; i++) {
            int p = kAltHorizontalScan[i];
            vertical[i] = uint8_t((p & 7) * 8 + (p >> 3));
        }
    }
};

const uint8_t kDefaultIntraMatrix[64] = {
    8,  17, 18, 19, 21, 23, 25, 27, 17, 18, 19, 21, 23, 25, 27, 28, 20, 21, 22, 23, 24, 26,
    28, 30, 21, 22, 23, 24, 26, 28, 30, 32, 22, 23, 24, 26, 28, 30, 32, 35, 23, 24, 26, 28,
    30, 32, 35, 38, 25, 26, 28, 30, 32, 35, 38, 41, 27, 28, 30, 32, 35, 38, 41, 45};
const uint8_t kDefaultInterMatrix[64] = {
    16, 17, 18, 19, 20, 21, 22, 23, 17, 18, 19, 20, 21, 22, 23, 24, 18, 19, 20, 21, 22, 23,
    24, 25, 19, 20, 21, 22, 23, 24, 26, 27, 20, 21, 22, 23, 25, 26, 27, 28, 21, 22, 23, 24,
    26, 27, 28, 30, 22, 23, 24, 26, 27, 28, 30, 31, 23, 24, 25, 27, 28, 30, 31, 33};

const int kDcThreshold[8] = {99, 13, 15, 17, 19, 21, 23, 0};
const int kQuantDelta[4] = {-1, -2, 1, 2};

struct Tables {
    Vlc intra_mcbpc{kIntraMcbpcCode, kIntraMcbpcLen, 9};
    Vlc inter_mcbpc{kInterMcbpcCode, kInterMcbpcLen, 28};
    Vlc cbpy{kCbpyCode, kCbpyLen, 16};
    Vlc mv{kMvCode, kMvLen, 33};
    Vlc dc_lum{kDcLumCode, kDcLumLen, 13};
    Vlc dc_chrom{kDcChromCode, kDcChromLen, 13};
    RlInfo intra{kIntraRl};
    RlInfo inter{kInterRl};
    Scans scans;
};

const Tables& tables() {
    static const Tables t;
    return t;
}

int y_dc_scale(int q) { return q < 5 ? 8 : q < 9 ? 2 * q : q < 25 ? q + 8 : 2 * q - 16; }
int c_dc_scale(int q) { return q < 5 ? 8 : q < 25 ? (q + 13) / 2 : q - 6; }

inline int mid_pred(int a, int b, int c) {
    return std::max(std::min(a, b), std::min(std::max(a, b), c));
}
inline int rounded_div(int a, int b) { return (a >= 0 ? a + (b >> 1) : a - (b >> 1)) / b; }

int log2_floor(unsigned v) {
    int n = 0;
    while (v >>= 1) n++;
    return n;
}

// Finds the next start code prefix 00 00 01 at or after `p`; returns the
// offset of its first byte, or `n`.
size_t find_start(const uint8_t* d, size_t n, size_t p) {
    for (; p + 3 <= n; p++)
        if (d[p] == 0 && d[p + 1] == 0 && d[p + 2] == 1) return p;
    return n;
}

}  // namespace

// ---------------------------------------------------------------- decoder
struct Mpeg4Decoder::Impl {
    // VOL
    bool have_vol = false;
    int width = 0, height = 0, time_bits = 1, quant_bits = 5;
    bool mpeg_quant = false;
    int intra_matrix[64], inter_matrix[64];
    // VOP
    int qscale = 1, fcode = 1, rounding = 0, dc_thr = 99;
    bool pframe = false;
    // pictures
    Picture cur, ref;
    bool have_ref = false;
    int mbw = 0, mbh = 0;
    // per-block state: DC predictors, the first row/column of quantised
    // AC levels, per-MB qscale, and MVs per 8x8 luma block.
    std::vector<int> dcv[3];
    std::vector<int16_t> acv[3];
    std::vector<int> mbq;
    std::vector<int> mvs;  // (2*mbh) x (2*mbw) x 2
    int16_t block[6][64];
    int last_index[6];
    bool ac_pred = false;

    Impl() {
        std::copy(kDefaultIntraMatrix, kDefaultIntraMatrix + 64, intra_matrix);
        std::copy(kDefaultInterMatrix, kDefaultInterMatrix + 64, inter_matrix);
    }

    void parse_headers(const uint8_t* d, size_t n, Picture* out, bool* shown) {
        size_t p = find_start(d, n, 0);
        while (p < n) {
            size_t next = find_start(d, n, p + 3);
            uint8_t code = d[p + 3 < n ? p + 3 : p];
            if (p + 4 > n) break;
            const uint8_t* body = d + p + 4;
            size_t len = n - (p + 4);  // a VOP runs to the end of the packet
            if (code >= 0x20 && code <= 0x2F) {
                parse_vol(body, next - (p + 4));
            } else if (code == 0xB6) {
                if (!out) return;
                *shown = decode_vop(body, len, *out);
                return;  // one VOP per packet
            }
            p = next;
        }
    }

    void load_matrix(BitReader& br, int* m) {
        int last = 0, i = 0;
        for (; i < 64; i++) {
            int v = int(br.get(8));
            if (!v) break;
            last = v;
            m[kZigzag[i]] = v;
        }
        for (; i < 64; i++) m[kZigzag[i]] = last;
    }

    void parse_vol(const uint8_t* d, size_t n) {
        BitReader br(d, n);
        br.skip(1);  // random_accessible_vol
        br.skip(8);  // video_object_type_indication
        int verid = 1;
        if (br.bit()) {
            verid = int(br.get(4));
            br.skip(3);
        }
        if (br.get(4) == 15) br.skip(16);  // extended pixel aspect ratio
        if (br.bit()) {                     // vol_control_parameters
            if (br.get(2) != 1) throw Unsupported("MPEG-4: chroma format other than 4:2:0");
            br.skip(1);     // low_delay
            if (br.bit()) br.skip(79);  // vbv parameters
        }
        int shape = int(br.get(2));
        if (shape != 0) throw Unsupported("MPEG-4: non-rectangular shape");
        br.skip(1);
        int res = int(br.get(16));
        if (!res) throw DecodeError("MPEG-4: zero vop_time_increment_resolution");
        br.skip(1);
        time_bits = std::max(1, log2_floor(unsigned(res - 1)) + 1);
        if (br.bit()) br.skip(time_bits);  // fixed_vop_rate
        br.skip(1);
        int w = int(br.get(13));
        br.skip(1);
        int h = int(br.get(13));
        br.skip(1);
        if (br.bit()) throw Unsupported("MPEG-4: interlace");
        br.skip(1);  // obmc_disable
        int sprite = int(br.get(verid == 1 ? 1 : 2));
        if (sprite) throw Unsupported("MPEG-4: GMC/sprites");
        if (br.bit()) throw Unsupported("MPEG-4: a bit depth other than 8 (not_8_bit)");
        mpeg_quant = br.bit();
        quant_bits = 5;
        std::copy(kDefaultIntraMatrix, kDefaultIntraMatrix + 64, intra_matrix);
        std::copy(kDefaultInterMatrix, kDefaultInterMatrix + 64, inter_matrix);
        if (mpeg_quant) {
            if (br.bit()) load_matrix(br, intra_matrix);
            if (br.bit()) load_matrix(br, inter_matrix);
        }
        if (verid != 1 && br.bit()) throw Unsupported("MPEG-4: quarter-pel motion");
        if (!br.bit()) throw Unsupported("MPEG-4: complexity estimation headers");
        if (!br.bit()) throw Unsupported("MPEG-4: resync markers");
        if (br.bit()) throw Unsupported("MPEG-4: data partitioning and RVLC");
        if (verid != 1) {
            if (br.bit()) throw Unsupported("MPEG-4: newpred");
            if (br.bit()) throw Unsupported("MPEG-4: reduced resolution VOPs");
        }
        if (br.bit()) throw Unsupported("MPEG-4: scalability");
        if (br.overrun()) throw DecodeError("MPEG-4: truncated VOL header");
        if (w <= 0 || h <= 0) throw DecodeError("MPEG-4: zero frame size");
        if (w != width || h != height) have_ref = false;
        width = w;
        height = h;
        mbw = (w + 15) / 16;
        mbh = (h + 15) / 16;
        have_vol = true;
    }

    // DC predictor storage: luma per 8x8 block, chroma per macroblock;
    // out-of-picture neighbours read as 1024 (and 0 AC levels).
    int& dc_at(int c, int x, int y) {
        int w = c ? mbw : 2 * mbw;
        return dcv[c][size_t(y) * w + x];
    }
    int dc_get(int c, int x, int y) {
        int w = c ? mbw : 2 * mbw, h = c ? mbh : 2 * mbh;
        if (x < 0 || y < 0 || x >= w || y >= h) return 1024;
        return dcv[c][size_t(y) * w + x];
    }
    int16_t* ac_at(int c, int x, int y) {
        int w = c ? mbw : 2 * mbw;
        return acv[c].data() + (size_t(y) * w + x) * 16;
    }
    bool in_plane(int c, int x, int y) {
        int w = c ? mbw : 2 * mbw, h = c ? mbh : 2 * mbh;
        return x >= 0 && y >= 0 && x < w && y < h;
    }
    static void block_pos(int n, int mx, int my, int& c, int& x, int& y) {
        if (n < 4) {
            c = 0;
            x = 2 * mx + (n & 1);
            y = 2 * my + (n >> 1);
        } else {
            c = n - 3;
            x = mx;
            y = my;
        }
    }

    void alloc_state() {
        for (int c = 0; c < 3; c++) {
            size_t nb = c ? size_t(mbw) * mbh : size_t(4) * mbw * mbh;
            dcv[c].assign(nb, 1024);
            acv[c].assign(nb * 16, 0);
        }
        mbq.assign(size_t(mbw) * mbh, 1);
        mvs.assign(size_t(4) * mbw * mbh * 2, 0);
    }

    // ff_mpeg4_pred_dc: returns the predicted quantised DC, sets dir
    // (0 = from the left, 1 = from above).
    int pred_dc(int n, int mx, int my, int& dir) {
        int c, x, y;
        block_pos(n, mx, my, c, x, y);
        int a = dc_get(c, x - 1, y), b = dc_get(c, x - 1, y - 1), cc = dc_get(c, x, y - 1);
        int scale = n < 4 ? y_dc_scale(qscale) : c_dc_scale(qscale);
        int pred;
        if (std::abs(a - b) < std::abs(b - cc)) {
            pred = cc;
            dir = 1;
        } else {
            pred = a;
            dir = 0;
        }
        return (pred + (scale >> 1)) / scale;
    }
    void store_dc(int n, int mx, int my, int level) {
        int c, x, y;
        block_pos(n, mx, my, c, x, y);
        int scale = n < 4 ? y_dc_scale(qscale) : c_dc_scale(qscale);
        int v = level * scale;
        if (v & ~2047) v = v < 0 ? 0 : 2047;
        dc_at(c, x, y) = v;
    }

    // ff_mpeg4_pred_ac on quantised levels in raster order.
    void pred_ac(int16_t* blk, int n, int mx, int my, int dir) {
        int c, x, y;
        block_pos(n, mx, my, c, x, y);
        int16_t* self = ac_at(c, x, y);
        if (ac_pred) {
            if (dir == 0) {
                int nq = mx > 0 ? mbq[size_t(my) * mbw + mx - 1] : qscale;
                if (in_plane(c, x - 1, y)) {
                    const int16_t* left = ac_at(c, x - 1, y);
                    bool same = mx == 0 || qscale == nq || n == 1 || n == 3;
                    for (int i = 1; i < 8; i++)
                        blk[i * 8] += same ? left[i] : rounded_div(left[i] * nq, qscale);
                }
            } else {
                int nq = my > 0 ? mbq[size_t(my - 1) * mbw + mx] : qscale;
                if (in_plane(c, x, y - 1)) {
                    const int16_t* top = ac_at(c, x, y - 1);
                    bool same = my == 0 || qscale == nq || n == 2 || n == 3;
                    for (int i = 1; i < 8; i++)
                        blk[i] += same ? top[i + 8] : rounded_div(top[i + 8] * nq, qscale);
                }
            }
        }
        for (int i = 1; i < 8; i++) self[i] = blk[i * 8];
        for (int i = 1; i < 8; i++) self[8 + i] = blk[i];
    }

    void clean_intra(int mx, int my) {
        for (int n = 0; n < 6; n++) {
            int c, x, y;
            block_pos(n, mx, my, c, x, y);
            dc_at(c, x, y) = 1024;
            std::fill(ac_at(c, x, y), ac_at(c, x, y) + 16, int16_t(0));
        }
    }

    int read_dc(BitReader& br, int n) {
        const Tables& t = tables();
        int size = (n < 4 ? t.dc_lum : t.dc_chrom).read(br);
        if (size < 0 || size > 9) throw DecodeError("MPEG-4: illegal DC VLC");
        if (!size) return 0;
        int level = br.get_xbits(size);
        if (size > 8) br.skip(1);  // marker
        return level;
    }

    // mpeg4_decode_block: levels into blk (raster order). Intra levels stay
    // quantised (DC included); inter levels are dequantised here under
    // H.263 quantisation, as FFmpeg's rl_vlc tables do.
    void decode_block(BitReader& br, int16_t* blk, int n, int mx, int my, bool coded,
                      bool intra, bool dc_vlc) {
        const Tables& t = tables();
        int i, dir = 0;
        const uint8_t* scan = kZigzag;
        const RlInfo* rl;
        int qmul, qadd;
        if (intra) {
            if (dc_vlc) {
                int level = read_dc(br, n) + pred_dc(n, mx, my, dir);
                store_dc(n, mx, my, level);
                blk[0] = int16_t(level);
                i = 0;
            } else {
                pred_dc(n, mx, my, dir);
                i = -1;
            }
            if (ac_pred) scan = dir == 0 ? t.scans.vertical : kAltHorizontalScan;
            rl = &t.intra;
            qmul = 1;
            qadd = 0;
        } else {
            i = -1;
            if (!coded) {
                last_index[n] = -1;
                return;
            }
            rl = &t.inter;
            if (mpeg_quant) {
                qmul = 1;
                qadd = 0;
            } else {
                qmul = qscale << 1;
                qadd = (qscale - 1) | 1;
            }
        }
        if (coded) {
            const RunLevel& tab = *rl->t;
            for (;;) {
                int code = rl->vlc.read(br);
                if (code < 0) throw DecodeError("MPEG-4: invalid TCOEF code");
                int last, run, level;
                if (code == 102) {  // escape
                    if (!br.bit()) {  // type 1: level offset
                        code = rl->vlc.read(br);
                        if (code < 0 || code == 102) throw DecodeError("MPEG-4: bad escape");
                        last = code >= tab.last;
                        run = tab.run[code];
                        level = tab.level[code] + rl->max_level[last][run];
                        level = level * qmul + qadd;
                        if (br.bit()) level = -level;
                    } else if (!br.bit()) {  // type 2: run offset
                        code = rl->vlc.read(br);
                        if (code < 0 || code == 102) throw DecodeError("MPEG-4: bad escape");
                        last = code >= tab.last;
                        int l = tab.level[code];
                        run = tab.run[code] + rl->max_run[last][l] + 1;
                        level = l * qmul + qadd;
                        if (br.bit()) level = -level;
                    } else {  // type 3: fixed length
                        last = br.bit();
                        run = int(br.get(6));
                        br.skip(1);
                        level = br.get_signed(12);
                        br.skip(1);
                        level = level > 0 ? level * qmul + qadd : level * qmul - qadd;
                        level = std::clamp(level, -2048, 2047);
                    }
                } else {
                    last = code >= tab.last;
                    run = tab.run[code];
                    level = tab.level[code] * qmul + qadd;
                    if (br.bit()) level = -level;
                }
                i += run + 1;
                if (i > 63) throw DecodeError("MPEG-4: AC coefficients past the block");
                blk[scan[i]] = int16_t(level);
                if (last) break;
                if (br.overrun()) throw DecodeError("MPEG-4: truncated VOP");
            }
        }
        if (intra) {
            if (!dc_vlc) {
                int level = blk[0] + pred_dc(n, mx, my, dir);
                store_dc(n, mx, my, level);
                blk[0] = int16_t(level);
                if (i < 0) i = 0;
            }
            pred_ac(blk, n, mx, my, dir);
            if (ac_pred) i = 63;
        }
        last_index[n] = i;
    }

    // Dequantisation of an intra block (FFmpeg's h263 / mpeg2 intra unquantize).
    void unquantize_intra(int16_t* blk, int n) {
        int scale = n < 4 ? y_dc_scale(qscale) : c_dc_scale(qscale);
        blk[0] = int16_t(blk[0] * scale);
        if (mpeg_quant) {
            for (int i = 1; i < 64; i++) {
                int l = blk[i];
                if (!l) continue;
                int a = (std::abs(l) * qscale * intra_matrix[i]) >> 3;
                blk[i] = int16_t(l < 0 ? -a : a);
            }
        } else {
            int qmul = qscale << 1, qadd = (qscale - 1) | 1;
            for (int i = 1; i < 64; i++) {
                int l = blk[i];
                if (l) blk[i] = int16_t(l < 0 ? l * qmul - qadd : l * qmul + qadd);
            }
        }
    }
    // MPEG-2 style mismatch control: the last coefficient's LSB toggles when
    // the sum of the dequantised levels is even (FFmpeg counts from -1).
    void unquantize_inter_mpeg(int16_t* blk) {
        int sum = -1;
        for (int i = 0; i < 64; i++) {
            int l = blk[i];
            if (!l) continue;
            int a = (((std::abs(l) << 1) + 1) * qscale * inter_matrix[i]) >> 4;
            blk[i] = int16_t(l < 0 ? -a : a);
            sum += blk[i];
        }
        blk[63] ^= int16_t(sum & 1);
    }

    int read_mv(BitReader& br, int pred) {
        int code = tables().mv.read(br);
        if (code < 0) throw DecodeError("MPEG-4: invalid MV code");
        if (!code) return pred;
        int sign = br.bit();
        int shift = fcode - 1, val = code;
        if (shift) {
            val = (val - 1) << shift;
            val |= int(br.get(shift));
            val++;
        }
        if (sign) val = -val;
        val += pred;
        int bits = 5 + fcode;
        return int(unsigned(val) << (32 - bits)) >> (32 - bits);
    }

    int* mv_at(int bx, int by) { return &mvs[(size_t(by) * 2 * mbw + bx) * 2]; }
    void mv_get(int bx, int by, int& x, int& y) {
        if (bx < 0 || by < 0 || bx >= 2 * mbw || by >= 2 * mbh) {
            x = y = 0;
            return;
        }
        int* m = mv_at(bx, by);
        x = m[0];
        y = m[1];
    }
    // ff_h263_pred_motion without resync markers (the slice is the picture).
    void pred_mv(int blk, int mx, int my, int& px, int& py) {
        static const int off[4] = {2, 1, 1, -1};
        int bx = 2 * mx + (blk & 1), by = 2 * my + (blk >> 1);
        int ax, ay, bxv, byv, cx, cy;
        mv_get(bx - 1, by, ax, ay);
        if (my == 0 && blk < 2) {
            if (blk == 0 && mx == 0) {
                px = py = 0;
            } else {
                px = ax;
                py = ay;
            }
            return;
        }
        mv_get(bx, by - 1, bxv, byv);
        mv_get(bx + off[blk], by - 1, cx, cy);
        px = mid_pred(ax, bxv, cx);
        py = mid_pred(ay, byv, cy);
    }

    // Half-pel prediction of a bw x bh block at integer (x0, y0) + half
    // flags from plane `c` of the reference, reads clamped to the edge.
    void mc(int c, int x0, int y0, int hx, int hy, int bw, int bh, uint8_t* dst, int ds) {
        const int ew = c ? 8 * mbw : 16 * mbw, eh = c ? 8 * mbh : 16 * mbh;
        const uint8_t* src = ref.plane[c].data();
        const int ss = ref.stride[c];
        uint8_t buf[17 * 17];
        for (int y = 0; y <= bh; y++) {
            int sy = std::clamp(y0 + y, 0, eh - 1);
            for (int x = 0; x <= bw; x++) {
                int sx = std::clamp(x0 + x, 0, ew - 1);
                buf[y * 17 + x] = src[size_t(sy) * ss + sx];
            }
        }
        const int r = rounding;
        for (int y = 0; y < bh; y++)
            for (int x = 0; x < bw; x++) {
                const uint8_t* b = buf + y * 17 + x;
                int v;
                if (!hx && !hy)
                    v = b[0];
                else if (hx && !hy)
                    v = (b[0] + b[1] + 1 - r) >> 1;
                else if (!hx && hy)
                    v = (b[0] + b[17] + 1 - r) >> 1;
                else
                    v = (b[0] + b[1] + b[17] + b[18] + 2 - r) >> 2;
                dst[y * ds + x] = uint8_t(v);
            }
    }

    void motion(int mx, int my, bool four) {
        uint8_t* dy = cur.plane[0].data() + size_t(16 * my) * cur.stride[0] + 16 * mx;
        uint8_t* du = cur.plane[1].data() + size_t(8 * my) * cur.stride[1] + 8 * mx;
        uint8_t* dv = cur.plane[2].data() + size_t(8 * my) * cur.stride[2] + 8 * mx;
        int cmx, cmy, chx, chy;
        if (!four) {
            int* m = mv_at(2 * mx, 2 * my);
            int vx = m[0], vy = m[1];
            mc(0, 16 * mx + (vx >> 1), 16 * my + (vy >> 1), vx & 1, vy & 1, 16, 16, dy,
               cur.stride[0]);
            chx = (vx & 1) | ((vx & 2) >> 1);
            chy = (vy & 1) | ((vy & 2) >> 1);
            cmx = (16 * mx + (vx >> 1)) >> 1;
            cmy = (16 * my + (vy >> 1)) >> 1;
        } else {
            // FFmpeg's hpel_motion and chroma_4mv_motion clip each block's
            // position to [-16, width] ([-8, width / 2] in chroma) of the
            // displayed size, dropping the half-pel step at that edge, before
            // their edge emulation at the macroblock-aligned size.
            int sx = 0, sy = 0;
            for (int i = 0; i < 4; i++) {
                int* m = mv_at(2 * mx + (i & 1), 2 * my + (i >> 1));
                int vx = m[0], vy = m[1];
                int bx = std::clamp(16 * mx + 8 * (i & 1) + (vx >> 1), -16, width);
                int by = std::clamp(16 * my + 8 * (i >> 1) + (vy >> 1), -16, height);
                mc(0, bx, by, bx != width ? vx & 1 : 0, by != height ? vy & 1 : 0, 8, 8,
                   dy + 8 * (i >> 1) * cur.stride[0] + 8 * (i & 1), cur.stride[0]);
                sx += vx;
                sy += vy;
            }
            static const int roundtab[16] = {0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2};
            int ux = roundtab[sx & 15] + ((sx >> 3) & ~1);
            int uy = roundtab[sy & 15] + ((sy >> 3) & ~1);
            cmx = std::clamp(8 * mx + (ux >> 1), -8, width >> 1);
            cmy = std::clamp(8 * my + (uy >> 1), -8, height >> 1);
            chx = cmx != (width >> 1) ? ux & 1 : 0;
            chy = cmy != (height >> 1) ? uy & 1 : 0;
        }
        mc(1, cmx, cmy, chx, chy, 8, 8, du, cur.stride[1]);
        mc(2, cmx, cmy, chx, chy, 8, 8, dv, cur.stride[2]);
    }

    uint8_t* block_dst(int n, int mx, int my, int& stride) {
        if (n < 4) {
            stride = cur.stride[0];
            return cur.plane[0].data() + size_t(16 * my + 8 * (n >> 1)) * stride + 16 * mx +
                   8 * (n & 1);
        }
        stride = cur.stride[n - 3];
        return cur.plane[n - 3].data() + size_t(8 * my) * stride + 8 * mx;
    }

    void set_qscale(int q) { qscale = std::clamp(q, 1, 31); }

    void decode_intra_mb(BitReader& br, int mx, int my, int cbpc, bool dquant) {
        const Tables& t = tables();
        ac_pred = br.bit();
        int cbpy = t.cbpy.read(br);
        if (cbpy < 0) throw DecodeError("MPEG-4: invalid CBPY");
        int cbp = (cbpc & 3) | (cbpy << 2);
        bool dc_vlc = qscale < dc_thr;
        if (dquant) set_qscale(qscale + kQuantDelta[br.get(2)]);
        mbq[size_t(my) * mbw + mx] = qscale;
        for (int n = 0; n < 6; n++) {
            std::fill(block[n], block[n] + 64, int16_t(0));
            decode_block(br, block[n], n, mx, my, cbp & 32, true, dc_vlc);
            cbp += cbp;
        }
        for (int n = 0; n < 6; n++) {
            unquantize_intra(block[n], n);
            int stride;
            uint8_t* dst = block_dst(n, mx, my, stride);
            idct_put(block[n], dst, stride);
        }
        for (int i = 0; i < 4; i++) {
            int* m = mv_at(2 * mx + (i & 1), 2 * my + (i >> 1));
            m[0] = m[1] = 0;
        }
    }

    void decode_p_mb(BitReader& br, int mx, int my) {
        const Tables& t = tables();
        int cbpc;
        for (;;) {
            if (br.bit()) {  // not coded: MV 0, no residual
                mbq[size_t(my) * mbw + mx] = qscale;
                for (int i = 0; i < 4; i++) {
                    int* m = mv_at(2 * mx + (i & 1), 2 * my + (i >> 1));
                    m[0] = m[1] = 0;
                }
                clean_intra(mx, my);
                motion(mx, my, false);
                return;
            }
            cbpc = t.inter_mcbpc.read(br);
            if (cbpc < 0) throw DecodeError("MPEG-4: invalid P MCBPC");
            if (cbpc != 20) break;
            if (br.overrun()) throw DecodeError("MPEG-4: truncated VOP");
        }
        bool dquant = cbpc & 8;
        if (cbpc & 4) {
            decode_intra_mb(br, mx, my, cbpc, dquant);
            return;
        }
        int cbpy = t.cbpy.read(br);
        if (cbpy < 0) throw DecodeError("MPEG-4: invalid CBPY");
        int cbp = (cbpc & 3) | ((cbpy ^ 0xF) << 2);
        if (dquant) set_qscale(qscale + kQuantDelta[br.get(2)]);
        mbq[size_t(my) * mbw + mx] = qscale;
        bool four = cbpc & 16;
        if (!four) {
            int px, py;
            pred_mv(0, mx, my, px, py);
            int vx = read_mv(br, px), vy = read_mv(br, py);
            for (int i = 0; i < 4; i++) {
                int* m = mv_at(2 * mx + (i & 1), 2 * my + (i >> 1));
                m[0] = vx;
                m[1] = vy;
            }
        } else {
            for (int i = 0; i < 4; i++) {
                int px, py;
                pred_mv(i, mx, my, px, py);
                int vx = read_mv(br, px), vy = read_mv(br, py);
                int* m = mv_at(2 * mx + (i & 1), 2 * my + (i >> 1));
                m[0] = vx;
                m[1] = vy;
            }
        }
        for (int n = 0; n < 6; n++) {
            std::fill(block[n], block[n] + 64, int16_t(0));
            decode_block(br, block[n], n, mx, my, cbp & 32, false, false);
            cbp += cbp;
        }
        clean_intra(mx, my);
        motion(mx, my, four);
        for (int n = 0; n < 6; n++) {
            if (last_index[n] < 0) continue;
            if (mpeg_quant) unquantize_inter_mpeg(block[n]);
            int stride;
            uint8_t* dst = block_dst(n, mx, my, stride);
            idct_add(block[n], dst, stride);
        }
    }

    bool decode_vop(const uint8_t* d, size_t n, Picture& out) {
        if (!have_vol) throw DecodeError("MPEG-4: a VOP before any VOL header");
        BitReader br(d, n);
        int type = int(br.get(2));
        if (type == 2) throw Unsupported("MPEG-4: B-VOPs");
        if (type == 3) throw Unsupported("MPEG-4: GMC/sprites (S-VOP)");
        while (br.bit()) {
            if (br.overrun()) throw DecodeError("MPEG-4: truncated VOP header");
        }
        br.skip(1);  // marker
        br.skip(time_bits);
        br.skip(1);  // marker
        if (!br.bit()) return false;  // vop_coded = 0: nothing shown
        pframe = type == 1;
        rounding = pframe ? br.bit() : 0;
        dc_thr = kDcThreshold[br.get(3)];
        qscale = int(br.get(quant_bits));
        if (!qscale) throw DecodeError("MPEG-4: zero vop_quant");
        fcode = 1;
        if (pframe) {
            fcode = int(br.get(3));
            if (!fcode) throw DecodeError("MPEG-4: zero vop_fcode_forward");
            if (!have_ref) throw DecodeError("MPEG-4: a P-VOP with no reference picture");
        }
        if (cur.width != width || cur.height != height || dcv[0].empty()) {
            alloc_state();
        }
        cur.alloc(width, height, 1, 1, 16, 16);
        cur.full_range = false;
        for (int my = 0; my < mbh; my++)
            for (int mx = 0; mx < mbw; mx++) {
                if (pframe) {
                    decode_p_mb(br, mx, my);
                } else {
                    int cbpc;
                    do {
                        cbpc = tables().intra_mcbpc.read(br);
                        if (cbpc < 0) throw DecodeError("MPEG-4: invalid I MCBPC");
                        if (br.overrun()) throw DecodeError("MPEG-4: truncated VOP");
                    } while (cbpc == 8);
                    decode_intra_mb(br, mx, my, cbpc, cbpc & 4);
                }
                if (br.overrun()) throw DecodeError("MPEG-4: truncated VOP");
            }
        std::swap(cur, ref);
        have_ref = true;
        out = ref;
        return true;
    }
};

Mpeg4Decoder::Mpeg4Decoder() : impl_(new Impl) {}
Mpeg4Decoder::~Mpeg4Decoder() { delete impl_; }
void Mpeg4Decoder::set_extradata(const uint8_t* data, size_t size) {
    impl_->parse_headers(data, size, nullptr, nullptr);
}
bool Mpeg4Decoder::decode(const uint8_t* data, size_t size, Picture& out) {
    bool shown = false;
    impl_->parse_headers(data, size, &out, &shown);
    return shown;
}
void Mpeg4Decoder::reset_references() { impl_->have_ref = false; }

bool mpeg4_is_key(const uint8_t* data, size_t size) {
    size_t p = find_start(data, size, 0);
    while (p + 4 < size) {
        if (data[p + 3] == 0xB6) return (data[p + 4] >> 6) == 0;
        p = find_start(data, size, p + 3);
    }
    return false;
}

// ---------------------------------------------------------------- encoder
namespace {

void put_start(BitWriter& bw, uint8_t code) {
    bw.put(0x000001, 24);
    bw.put(code, 8);
}

}  // namespace

Mpeg4Encoder::Mpeg4Encoder(int width, int height, int fps_num, int fps_den, int qscale,
                           int options)
    : width_(width), height_(height), num_(fps_num), den_(fps_den),
      q_(std::clamp(qscale, 1, 31)), options_(options) {
    if (width <= 0 || height <= 0 || width >= 8192 || height >= 8192)
        throw DecodeError("MPEG-4: frame size outside 1-8191");
    if (fps_num <= 0 || fps_num > 65535 || fps_den <= 0)
        throw DecodeError("MPEG-4: frame rate numerator outside 1-65535");
    time_bits_ = std::max(1, log2_floor(unsigned(num_ - 1)) + 1);
    BitWriter bw;
    put_start(bw, 0xB0);  // visual_object_sequence: Simple Profile @ Level 1
    bw.put(0x01, 8);
    put_start(bw, 0xB5);  // visual_object: video, verid 1, priority 1
    bw.put(1, 1);
    bw.put(1, 4);
    bw.put(1, 3);
    bw.put(1, 4);
    bw.put(0, 1);  // no video_signal_type
    bw.mpeg4_stuffing();
    put_start(bw, 0x00);  // video_object 0
    put_start(bw, 0x20);  // video_object_layer 0
    bw.put(0, 1);         // random_accessible_vol
    bw.put(1, 8);         // simple object type
    bw.put(0, 1);         // no object layer identifier
    bw.put(1, 4);         // square pixels
    bw.put(0, 1);         // no vol_control_parameters
    bw.put(0, 2);         // rectangular
    bw.put(1, 1);
    bw.put(uint32_t(num_), 16);  // vop_time_increment_resolution
    bw.put(1, 1);
    bw.put(0, 1);  // fixed_vop_rate
    bw.put(1, 1);
    bw.put(uint32_t(width), 13);
    bw.put(1, 1);
    bw.put(uint32_t(height), 13);
    bw.put(1, 1);
    bw.put(0, 1);  // interlaced
    bw.put(1, 1);  // obmc_disable
    bw.put(0, 1);  // sprite_enable
    bw.put(0, 1);  // not_8_bit
    // H.263 quantisation, or MPEG's with the default matrices (not loaded).
    bw.put(options_ & kMpeg4MpegQuant ? 0b100 : 0, options_ & kMpeg4MpegQuant ? 3 : 1);
    bw.put(1, 1);  // complexity_estimation_disable
    bw.put(1, 1);  // resync_marker_disable
    bw.put(0, 1);  // data_partitioned
    bw.put(0, 1);  // scalability
    bw.mpeg4_stuffing();
    headers_ = bw.bytes();
}

std::vector<uint8_t> Mpeg4Encoder::encode(const uint8_t* rgb, int64_t index) const {
    const Tables& t = tables();
    Picture pic;
    rgb_to_yuv420(rgb, width_, height_, false, pic, 16);
    BitWriter bw;
    if (index == 0)
        for (uint8_t b : headers_) bw.put(b, 8);
    // Time stamps in 1/num s: frame i is at i * den.
    int64_t now = index * den_, prev = index ? (index - 1) * den_ : 0;
    int64_t seconds = now / num_ - (index ? prev / num_ : 0);
    put_start(bw, 0xB6);
    bw.put(0, 2);  // I-VOP
    for (int64_t s = 0; s < seconds; s++) bw.put(1, 1);
    bw.put(0, 1);
    bw.put(1, 1);
    bw.put(uint32_t(now % num_), time_bits_);
    bw.put(1, 1);
    bw.put(1, 1);  // vop_coded
    // intra_dc_vlc_thr 0: the DC VLC at every quantiser; 7: never (the DC
    // differential is the first TCOEF event).
    const bool dc_vlc = !(options_ & kMpeg4DcInTcoef);
    bw.put(dc_vlc ? 0 : 7, 3);
    bw.put(uint32_t(q_), 5);

    const int mbw = (width_ + 15) / 16, mbh = (height_ + 15) / 16;
    const int ys = y_dc_scale(q_), cs = c_dc_scale(q_);
    const bool mpeg_quant = options_ & kMpeg4MpegQuant;
    // Reconstructed DC per block (level * scale), as the decoder predicts.
    std::vector<int> dcs[3] = {std::vector<int>(size_t(4) * mbw * mbh),
                               std::vector<int>(size_t(mbw) * mbh),
                               std::vector<int>(size_t(mbw) * mbh)};
    auto dc_get = [&](int c, int x, int y) {
        int w = c ? mbw : 2 * mbw, h = c ? mbh : 2 * mbh;
        if (x < 0 || y < 0 || x >= w || y >= h) return 1024;
        return dcs[c][size_t(y) * w + x];
    };
    const int qmul = 2 * q_, qadd = (q_ - 1) | 1;
    int coef[64];
    for (int my = 0; my < mbh; my++)
        for (int mx = 0; mx < mbw; mx++) {
            // Per block, the values in zigzag order: [0] the DC differential,
            // then the AC levels.
            int zz[6][64];
            int cbp = 0;
            for (int n = 0; n < 6; n++) {
                const int c = n < 4 ? 0 : n - 3;
                const int x = n < 4 ? 2 * mx + (n & 1) : mx, y = n < 4 ? 2 * my + (n >> 1) : my;
                const int stride = pic.stride[c];
                fdct(pic.plane[c].data() + size_t(8 * y) * stride + 8 * x, stride, 0, coef);
                const int scale = n < 4 ? ys : cs;
                const int level = std::clamp((coef[0] + (scale >> 1)) / scale, 1, 2047 / scale);
                int a = dc_get(c, x - 1, y), b = dc_get(c, x - 1, y - 1), cc = dc_get(c, x, y - 1);
                int pred = std::abs(a - b) < std::abs(b - cc) ? cc : a;
                zz[n][0] = level - (pred + (scale >> 1)) / scale;
                dcs[c][size_t(y) * (c ? mbw : 2 * mbw) + x] = level * scale;
                bool coded = !dc_vlc && zz[n][0];
                for (int i = 1; i < 64; i++) {
                    // The level whose reconstruction lies nearest the
                    // coefficient: q(2|l| + 1) - (q even) under H.263
                    // quantisation, |l| q W / 8 under MPEG's.
                    int z = kZigzag[i], m = std::abs(coef[z]), l;
                    if (mpeg_quant) {
                        int step = q_ * kDefaultIntraMatrix[z];
                        l = (8 * m + step / 2) / step;
                    } else {
                        l = m <= qadd ? 0 : (m - qadd + q_) / qmul;
                    }
                    l = std::min(l, 2047);
                    zz[n][i] = coef[z] < 0 ? -l : l;
                    coded |= l != 0;
                }
                if (coded) cbp |= 32 >> n;
            }
            int cbpc = cbp & 3, cbpy = cbp >> 2;
            bw.put(kIntraMcbpcCode[cbpc], kIntraMcbpcLen[cbpc]);
            bw.put(0, 1);  // ac_pred_flag
            bw.put(kCbpyCode[cbpy], kCbpyLen[cbpy]);
            for (int n = 0; n < 6; n++) {
                if (dc_vlc) {
                    int diff = zz[n][0], size = 0;
                    while (std::abs(diff) >> size) size++;
                    if (n < 4)
                        bw.put(kDcLumCode[size], kDcLumLen[size]);
                    else
                        bw.put(kDcChromCode[size], kDcChromLen[size]);
                    if (size) {
                        bw.put(uint32_t(diff < 0 ? diff + (1 << size) - 1 : diff), size);
                        if (size > 8) bw.put(1, 1);
                    }
                }
                if (!(cbp & (32 >> n))) continue;
                // TCOEF events from position 1 (0 with the DC among them).
                const int first = dc_vlc ? 1 : 0;
                int lastpos = first;
                for (int i = first; i < 64; i++)
                    if (zz[n][i]) lastpos = i;
                int run = 0;
                for (int i = first; i <= lastpos; i++) {
                    int l = zz[n][i];
                    if (!l) {
                        run++;
                        continue;
                    }
                    int last = i == lastpos, al = std::abs(l), sign = l < 0;
                    const RlInfo& rl = t.intra;
                    int idx = al < 28 ? rl.index[last][run][al] : -1;
                    if (idx >= 0) {
                        bw.put(rl.t->code[idx], rl.t->len[idx]);
                        bw.put(uint32_t(sign), 1);
                    } else {
                        int l1 = al - rl.max_level[last][run];
                        int idx1 = l1 > 0 && l1 < 28 ? rl.index[last][run][l1] : -1;
                        int r2 = al <= 64 ? run - rl.max_run[last][al] - 1 : -1;
                        int idx2 = r2 >= 0 && al < 28 ? rl.index[last][r2][al] : -1;
                        bw.put(rl.t->code[102], rl.t->len[102]);
                        if (idx1 >= 0) {
                            bw.put(0, 1);
                            bw.put(rl.t->code[idx1], rl.t->len[idx1]);
                            bw.put(uint32_t(sign), 1);
                        } else if (idx2 >= 0) {
                            bw.put(2, 2);
                            bw.put(rl.t->code[idx2], rl.t->len[idx2]);
                            bw.put(uint32_t(sign), 1);
                        } else {
                            bw.put(3, 2);
                            bw.put(uint32_t(last), 1);
                            bw.put(uint32_t(run), 6);
                            bw.put(1, 1);
                            bw.put(uint32_t(l) & 0xFFF, 12);
                            bw.put(1, 1);
                        }
                    }
                    run = 0;
                }
            }
        }
    bw.mpeg4_stuffing();
    return std::move(bw.bytes());
}

}  // namespace tv
