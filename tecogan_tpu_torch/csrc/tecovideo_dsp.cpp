// DSP pieces of libtecovideo: FFmpeg's simple IDCT, a forward DCT for the
// encoders, and the colour conversions.
#include <algorithm>
#include <cmath>

#include "tecovideo.h"

namespace tv {

const uint8_t kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33, 40, 48,
    41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23,
    30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

namespace {

constexpr int W1 = 22725, W2 = 21407, W3 = 19266, W4 = 16383, W5 = 12873, W6 = 8867,
              W7 = 4520;
constexpr int ROW_SHIFT = 11, COL_SHIFT = 20;

inline uint8_t clip_u8(int v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); }

void idct_row(int16_t* row) {
    if (!(row[1] | row[2] | row[3] | row[4] | row[5] | row[6] | row[7])) {
        int16_t v = int16_t(uint16_t(row[0] * 8));  // FFmpeg keeps the low 16 bits
        for (int i = 0; i < 8; i++) row[i] = v;
        return;
    }
    unsigned a0 = unsigned(W4 * row[0]) + (1u << (ROW_SHIFT - 1));
    unsigned a1 = a0, a2 = a0, a3 = a0;
    a0 += unsigned(W2 * row[2]);
    a1 += unsigned(W6 * row[2]);
    a2 -= unsigned(W6 * row[2]);
    a3 -= unsigned(W2 * row[2]);
    unsigned b0 = unsigned(W1 * row[1]) + unsigned(W3 * row[3]);
    unsigned b1 = unsigned(W3 * row[1]) + unsigned(-W7 * row[3]);
    unsigned b2 = unsigned(W5 * row[1]) + unsigned(-W1 * row[3]);
    unsigned b3 = unsigned(W7 * row[1]) + unsigned(-W5 * row[3]);
    if (row[4] | row[5] | row[6] | row[7]) {
        a0 += unsigned(W4 * row[4]) + unsigned(W6 * row[6]);
        a1 += unsigned(-W4 * row[4]) - unsigned(W2 * row[6]);
        a2 += unsigned(-W4 * row[4]) + unsigned(W2 * row[6]);
        a3 += unsigned(W4 * row[4]) - unsigned(W6 * row[6]);
        b0 += unsigned(W5 * row[5]) + unsigned(W7 * row[7]);
        b1 += unsigned(-W1 * row[5]) + unsigned(-W5 * row[7]);
        b2 += unsigned(W7 * row[5]) + unsigned(W3 * row[7]);
        b3 += unsigned(W3 * row[5]) + unsigned(-W1 * row[7]);
    }
    row[0] = int16_t(int(a0 + b0) >> ROW_SHIFT);
    row[7] = int16_t(int(a0 - b0) >> ROW_SHIFT);
    row[1] = int16_t(int(a1 + b1) >> ROW_SHIFT);
    row[6] = int16_t(int(a1 - b1) >> ROW_SHIFT);
    row[2] = int16_t(int(a2 + b2) >> ROW_SHIFT);
    row[5] = int16_t(int(a2 - b2) >> ROW_SHIFT);
    row[3] = int16_t(int(a3 + b3) >> ROW_SHIFT);
    row[4] = int16_t(int(a3 - b3) >> ROW_SHIFT);
}

// One column -> its 8 outputs (before clamping), in order top to bottom.
void idct_col(const int16_t* col, int out[8]) {
    unsigned a0 = unsigned(W4 * (col[0] + ((1 << (COL_SHIFT - 1)) / W4)));
    unsigned a1 = a0, a2 = a0, a3 = a0;
    a0 += unsigned(W2 * col[16]);
    a1 += unsigned(W6 * col[16]);
    a2 += unsigned(-W6 * col[16]);
    a3 += unsigned(-W2 * col[16]);
    unsigned b0 = unsigned(W1 * col[8]), b1 = unsigned(W3 * col[8]);
    unsigned b2 = unsigned(W5 * col[8]), b3 = unsigned(W7 * col[8]);
    b0 += unsigned(W3 * col[24]);
    b1 += unsigned(-W7 * col[24]);
    b2 += unsigned(-W1 * col[24]);
    b3 += unsigned(-W5 * col[24]);
    if (col[32]) {
        a0 += unsigned(W4 * col[32]);
        a1 += unsigned(-W4 * col[32]);
        a2 += unsigned(-W4 * col[32]);
        a3 += unsigned(W4 * col[32]);
    }
    if (col[40]) {
        b0 += unsigned(W5 * col[40]);
        b1 += unsigned(-W1 * col[40]);
        b2 += unsigned(W7 * col[40]);
        b3 += unsigned(W3 * col[40]);
    }
    if (col[48]) {
        a0 += unsigned(W6 * col[48]);
        a1 += unsigned(-W2 * col[48]);
        a2 += unsigned(W2 * col[48]);
        a3 += unsigned(-W6 * col[48]);
    }
    if (col[56]) {
        b0 += unsigned(W7 * col[56]);
        b1 += unsigned(-W5 * col[56]);
        b2 += unsigned(W3 * col[56]);
        b3 += unsigned(-W1 * col[56]);
    }
    out[0] = int(a0 + b0) >> COL_SHIFT;
    out[1] = int(a1 + b1) >> COL_SHIFT;
    out[2] = int(a2 + b2) >> COL_SHIFT;
    out[3] = int(a3 + b3) >> COL_SHIFT;
    out[4] = int(a3 - b3) >> COL_SHIFT;
    out[5] = int(a2 - b2) >> COL_SHIFT;
    out[6] = int(a1 - b1) >> COL_SHIFT;
    out[7] = int(a0 - b0) >> COL_SHIFT;
}

}  // namespace

void idct_put(int16_t* block, uint8_t* dst, int stride) {
    for (int i = 0; i < 8; i++) idct_row(block + 8 * i);
    int out[8];
    for (int x = 0; x < 8; x++) {
        idct_col(block + x, out);
        for (int y = 0; y < 8; y++) dst[y * stride + x] = clip_u8(out[y]);
    }
}

void idct_add(int16_t* block, uint8_t* dst, int stride) {
    for (int i = 0; i < 8; i++) idct_row(block + 8 * i);
    int out[8];
    for (int x = 0; x < 8; x++) {
        idct_col(block + x, out);
        for (int y = 0; y < 8; y++) dst[y * stride + x] = clip_u8(dst[y * stride + x] + out[y]);
    }
}

void fdct(const uint8_t* src, int stride, int bias, int* out) {
    struct Basis {  // orthonormal DCT-II: DC = 8 x the mean in 2-D
        float c[8][8];
        Basis() {
            for (int u = 0; u < 8; u++)
                for (int x = 0; x < 8; x++)
                    c[u][x] = float((u ? std::sqrt(0.25) : std::sqrt(0.125)) *
                                    std::cos((2 * x + 1) * u * M_PI / 16.0));
        }
    };
    static const Basis b;  // initialised once, thread-safe
    float in[8][8], tmp[8][8];
    for (int y = 0; y < 8; y++)
        for (int x = 0; x < 8; x++) in[y][x] = float(src[y * stride + x] - bias);
    for (int y = 0; y < 8; y++)
        for (int u = 0; u < 8; u++) {
            float acc = 0;
            for (int x = 0; x < 8; x++) acc += b.c[u][x] * in[y][x];
            tmp[y][u] = acc;
        }
    for (int v = 0; v < 8; v++)
        for (int u = 0; u < 8; u++) {
            float acc = 0;
            for (int y = 0; y < 8; y++) acc += b.c[v][y] * tmp[y][u];
            out[v * 8 + u] = int(std::lrint(acc));
        }
}

// ---------------------------------------------------------------- colour
// YUV -> RGB as cv2's FFmpeg backend gets it from swscale's unscaled
// yuv2rgb path (libswscale/x86/yuv_2_rgb.asm): each chroma sample serves
// the luma samples it covers (nearest), and every product is a pmulhw
// (the high 16 bits, floored) of the sample shifted left by 3 with BT.601
// coefficients in 1/8192: limited range for MPEG-4, full range (yuvj)
// for JPEG. This reproduces cv2's frames exactly on both codecs.
namespace {
struct Yuv2Rgb {
    int y_coeff, y_offset, v2r, u2b, u2g, v2g;
};
// ff_yuv2rgb_coeffs[ITU601] = {104597, 132201, 25675, 53279} / 65536 (the
// limited-range chroma gains), scaled by 224/255 for full range, /8 and
// rounded as roundToInt16 does; the luma gain 255/219 and offset 16 apply
// to limited range only.
constexpr Yuv2Rgb kLimited = {9539, 128, 13075, 16525, -3209, -6660};
constexpr Yuv2Rgb kFull = {8192, 0, 11485, 14516, -2819, -5850};
inline int mulhi(int a, int b) { return (a * b) >> 16; }
}  // namespace

void picture_to_rgb(const Picture& pic, uint8_t* rgb) {
    const int w = pic.width, h = pic.height;
    if (pic.gray) {
        for (int y = 0; y < h; y++) {
            const uint8_t* ys = pic.plane[0].data() + size_t(y) * pic.stride[0];
            uint8_t* o = rgb + size_t(y) * w * 3;
            for (int x = 0; x < w; x++) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = ys[x];
        }
        return;
    }
    const Yuv2Rgb& k = pic.full_range ? kFull : kLimited;
    for (int y = 0; y < h; y++) {
        const uint8_t* ys = pic.plane[0].data() + size_t(y) * pic.stride[0];
        const uint8_t* us = pic.plane[1].data() + size_t(y >> pic.sy) * pic.stride[1];
        const uint8_t* vs = pic.plane[2].data() + size_t(y >> pic.sy) * pic.stride[2];
        uint8_t* o = rgb + size_t(y) * w * 3;
        for (int x = 0; x < w; x++) {
            int u = (us[x >> pic.sx] << 3) - 1024, v = (vs[x >> pic.sx] << 3) - 1024;
            int yy = mulhi((ys[x] << 3) - k.y_offset, k.y_coeff);
            o[3 * x + 0] = clip_u8(yy + mulhi(v, k.v2r));
            o[3 * x + 1] = clip_u8(yy + mulhi(u, k.u2g) + mulhi(v, k.v2g));
            o[3 * x + 2] = clip_u8(yy + mulhi(u, k.u2b));
        }
    }
}

// BT.601 in 16.16 fixed point: full range (JFIF) or limited (16-235,
// 16-240); chroma from the mean of each 2x2 block. Edges replicate.
void rgb_to_yuv420(const uint8_t* rgb, int width, int height, bool full_range, Picture& pic,
                   int align) {
    pic.alloc(width, height, 1, 1, align, align);
    pic.full_range = full_range;
    struct Coef {
        int yr, yg, yb, ur, ug, ub, vr, vg, vb, yoff;
    };
    static constexpr Coef kFullCoef = {19595, 38470, 7471, -11058, -21710, 32768,
                                       32768, -27439, -5329, 0};
    static constexpr Coef kLimitedCoef = {16829, 33039, 6416, -9714, -19070, 28784,
                                          28784, -24103, -4681, 16};
    const Coef& k = full_range ? kFullCoef : kLimitedCoef;
    const int aw = pic.stride[0], ah = pic.rows[0], cw = pic.stride[1];
    for (int y = 0; y < ah; y += 2) {
        const uint8_t* rows[2] = {rgb + size_t(std::min(y, height - 1)) * width * 3,
                                  rgb + size_t(std::min(y + 1, height - 1)) * width * 3};
        uint8_t* yo[2] = {pic.plane[0].data() + size_t(y) * aw,
                          pic.plane[0].data() + size_t(y + 1) * aw};
        uint8_t* uo = pic.plane[1].data() + size_t(y / 2) * cw;
        uint8_t* vo = pic.plane[2].data() + size_t(y / 2) * cw;
        for (int x = 0; x < aw; x += 2) {
            int su = 0, sv = 0;
            for (int r = 0; r < 2; r++)
                for (int c = 0; c < 2; c++) {
                    const uint8_t* p = rows[r] + std::min(x + c, width - 1) * 3;
                    int R = p[0], G = p[1], B = p[2];
                    yo[r][x + c] = clip_u8(((k.yr * R + k.yg * G + k.yb * B + 32768) >> 16) +
                                           k.yoff);
                    su += k.ur * R + k.ug * G + k.ub * B;
                    sv += k.vr * R + k.vg * G + k.vb * B;
                }
            uo[x / 2] = clip_u8(128 + ((su + (1 << 17)) >> 18));
            vo[x / 2] = clip_u8(128 + ((sv + (1 << 17)) >> 18));
        }
    }
}

}  // namespace tv
