// Shared pieces of libtecovideo: bit readers and writers, VLC tables,
// planar YUV pictures, the IDCT and forward DCT, and the codec entry points
// that tecovideo.cpp (containers and the C ABI) calls.
//
// The decoders reproduce FFmpeg's reconstruction, and picture_to_rgb
// swscale's conversion, so that frames decoded here equal
// cv2.VideoCapture's (bit for bit on every stream OpenCV's writers make).
#pragma once

#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace tv {

// A failure the caller should see as ValueError (corrupt or truncated data).
struct DecodeError : std::runtime_error {
    using std::runtime_error::runtime_error;
};
// A stream feature this library refuses (Python raises NotImplementedError).
struct Unsupported : std::runtime_error {
    using std::runtime_error::runtime_error;
};

// ---------------------------------------------------------------- bit I/O
// MSB-first reader over a buffer; reads past the end return zero bits.
class BitReader {
  public:
    BitReader() = default;
    BitReader(const uint8_t* data, size_t size) : d_(data), n_(size) {}
    uint32_t show(int bits) const {  // bits <= 32
        if (bits == 0) return 0;
        uint64_t v = 0;
        size_t byte = pos_ >> 3;
        for (int i = 0; i < 8; i++) {
            v <<= 8;
            if (byte + i < n_) v |= d_[byte + i];
        }
        v <<= (pos_ & 7);
        return uint32_t(v >> (64 - bits));
    }
    uint32_t get(int bits) {
        uint32_t v = show(bits);
        pos_ += bits;
        return v;
    }
    int bit() { return int(get(1)); }
    void skip(int bits) { pos_ += bits; }
    int32_t get_signed(int bits) {  // two's complement
        uint32_t v = get(bits);
        return int32_t(v << (32 - bits)) >> (32 - bits);
    }
    // JPEG / MPEG-4 DC style: n bits, a leading 0 means a negative value.
    int get_xbits(int n) {
        if (n == 0) return 0;
        int v = int(get(n));
        return (v >> (n - 1)) ? v : v - (1 << n) + 1;
    }
    bool overrun() const { return pos_ > n_ * 8; }

  private:
    const uint8_t* d_ = nullptr;
    size_t n_ = 0;
    size_t pos_ = 0;
};

class BitWriter {
  public:
    void put(uint32_t value, int bits) {  // bits <= 32
        if (!bits) return;
        acc_ = (acc_ << bits) | (value & (0xFFFFFFFFu >> (32 - bits)));
        nacc_ += bits;
        while (nacc_ >= 8) {
            nacc_ -= 8;
            emit(uint8_t(acc_ >> nacc_));
        }
    }
    // MPEG-4 next_start_code() stuffing: a 0 and then 1s up to the byte.
    void mpeg4_stuffing() {
        put(0, 1);
        if (nacc_) put(0xFF, 8 - nacc_);
    }
    // JPEG end of scan: pad with 1 bits.
    void pad_ones() {
        if (nacc_) put(0xFF, 8 - nacc_);
    }
    void set_jpeg_stuffing(bool on) { jpeg_ = on; }
    std::vector<uint8_t>& bytes() { return out_; }

  private:
    void emit(uint8_t b) {
        out_.push_back(b);
        if (jpeg_ && b == 0xFF) out_.push_back(0x00);
    }
    std::vector<uint8_t> out_;
    uint64_t acc_ = 0;
    int nacc_ = 0;
    bool jpeg_ = false;
};

// ---------------------------------------------------------------- VLCs
// Direct lookup over the longest code: entry = symbol, length (0: invalid).
class Vlc {
  public:
    Vlc() = default;
    // codes[i], lens[i] for symbol i; a length of 0 leaves the symbol out.
    Vlc(const uint16_t* codes, const uint8_t* lens, int n) { build(codes, lens, n); }
    void build(const uint16_t* codes, const uint8_t* lens, int n) {
        bits_ = 0;
        for (int i = 0; i < n; i++) bits_ = lens[i] > bits_ ? lens[i] : bits_;
        sym_.assign(size_t(1) << bits_, -1);
        len_.assign(size_t(1) << bits_, 0);
        for (int i = 0; i < n; i++) {
            if (!lens[i]) continue;
            int shift = bits_ - lens[i];
            uint32_t first = uint32_t(codes[i]) << shift;
            for (uint32_t j = 0; j < (1u << shift); j++) {
                if (len_[first + j]) throw std::logic_error("VLC table is not prefix-free");
                sym_[first + j] = int16_t(i);
                len_[first + j] = lens[i];
            }
        }
    }
    // The symbol, or -1 for a code not in the table.
    int read(BitReader& br) const {
        uint32_t idx = br.show(bits_);
        int len = len_[idx];
        if (!len) return -1;
        br.skip(len);
        return sym_[idx];
    }

  private:
    int bits_ = 0;
    std::vector<int16_t> sym_;
    std::vector<uint8_t> len_;
};

// ---------------------------------------------------------------- pictures
// Planar YUV. Planes are allocated to whole macroblocks (or MCUs); width and
// height are the displayed size.
struct Picture {
    int width = 0, height = 0;
    int sx = 1, sy = 1;          // chroma subsampling shifts (420: 1, 1)
    bool gray = false;
    bool full_range = false;     // yuvj (JPEG) against limited-range BT.601
    int stride[3] = {0, 0, 0};
    int rows[3] = {0, 0, 0};
    std::vector<uint8_t> plane[3];

    void alloc(int w, int h, int shift_x, int shift_y, int align_w, int align_h) {
        width = w;
        height = h;
        sx = shift_x;
        sy = shift_y;
        int aw = (w + align_w - 1) / align_w * align_w;
        int ah = (h + align_h - 1) / align_h * align_h;
        stride[0] = aw;
        rows[0] = ah;
        stride[1] = stride[2] = aw >> sx;
        rows[1] = rows[2] = ah >> sy;
        for (int c = 0; c < 3; c++) plane[c].assign(size_t(stride[c]) * rows[c], 128);
    }
};

// Picture -> packed RGB24 (h, w, 3), as cv2's FFmpeg backend delivers it.
void picture_to_rgb(const Picture& pic, uint8_t* rgb);

// ---------------------------------------------------------------- DCT
// FFmpeg's simple IDCT (simple_idct_template.c, 8-bit): in place on a
// row-major 8x8 block, then put (clamped) or add (clamped) into dst.
void idct_put(int16_t* block, uint8_t* dst, int stride);
void idct_add(int16_t* block, uint8_t* dst, int stride);
// Forward DCT of an 8x8 block of samples minus `bias`, scaled as FFmpeg's
// encoders scale it (DC = 8 x the mean), rounded to integers.
void fdct(const uint8_t* src, int stride, int bias, int* out);

extern const uint8_t kZigzag[64];

// ---------------------------------------------------------------- codecs
// MJPEG (baseline JPEG). Huffman and quantisation tables carry over from
// frame to frame, as in FFmpeg's decoder; a stream starts with Annex K's.
class JpegDecoder {
  public:
    JpegDecoder();
    ~JpegDecoder();
    // Decodes one frame; throws DecodeError or Unsupported.
    void decode(const uint8_t* data, size_t size, Picture& pic);

  private:
    struct Impl;
    Impl* impl_;
};
// Encodes packed RGB24 as a baseline 4:2:0 JFIF-range JPEG with DQT and DHT.
std::vector<uint8_t> jpeg_encode(const uint8_t* rgb, int width, int height, int quality);

// MPEG-4 Part 2 decoder state across packets.
class Mpeg4Decoder {
  public:
    Mpeg4Decoder();
    ~Mpeg4Decoder();
    void set_extradata(const uint8_t* data, size_t size);
    // Decodes one packet. Returns true and fills `out` when a frame is shown;
    // false for a packet without a picture (headers only, vop_coded = 0).
    bool decode(const uint8_t* data, size_t size, Picture& out);
    // Forgets the reference pictures (before decoding from a key packet).
    void reset_references();

  private:
    struct Impl;
    Impl* impl_;
};
// True when the packet's first VOP is an I-VOP (a key packet).
bool mpeg4_is_key(const uint8_t* data, size_t size);

// MPEG-4 Part 2 Simple Profile I-VOP encoder. Options (bits): MPEG
// quantisation with the default matrices in place of H.263's, and the DC
// differential coded among the TCOEF events (intra_dc_vlc_thr 7) in place
// of the DC VLC; the writers use neither, the tests drive the decoder's
// paths through them.
constexpr int kMpeg4MpegQuant = 1, kMpeg4DcInTcoef = 2;
class Mpeg4Encoder {
  public:
    Mpeg4Encoder(int width, int height, int fps_num, int fps_den, int qscale, int options = 0);
    // The VOS, VO and VOL headers (the container's extradata).
    const std::vector<uint8_t>& headers() const { return headers_; }
    // Frame `index` of the stream, packed RGB24, as one I-VOP packet; the
    // first frame's carries the headers too. Safe to call from several
    // threads at once (the frames are independent).
    std::vector<uint8_t> encode(const uint8_t* rgb, int64_t index) const;

  private:
    int width_, height_, num_, den_, q_, options_;
    int time_bits_;
    std::vector<uint8_t> headers_;
};

// RGB24 -> planar 4:2:0 YUV (full range for JPEG, limited for MPEG-4).
void rgb_to_yuv420(const uint8_t* rgb, int width, int height, bool full_range, Picture& pic,
                   int align);

}  // namespace tv
