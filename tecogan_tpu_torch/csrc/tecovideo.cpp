// libtecovideo: video-file I/O for tecogan_tpu_torch without OpenCV or FFmpeg.
//
// Containers: RIFF AVI, ISO BMFF (.mp4/.m4v) and Matroska, read (a demuxer
// per container, giving each packet's file offset, size and key flag) and
// written (AVI with MJPEG; MP4 and MKV with MPEG-4 Part 2, MKV also MJPEG).
// Codecs: tecovideo_jpeg.cpp and tecovideo_mpeg4.cpp. Codecs the library
// cannot decode are named by the demuxer and refused at decode; of those,
// H.264 and VP9 packets go to the card's NVDEC (data/video_nvdec.py), H.264
// rewritten to Annex B by tv_annexb_packet.
//
// Build: g++ -O3 -fPIC -std=c++17 -shared -pthread tecovideo*.cpp (no other
// library). The C ABI below is bound by data/video_native.py; each call
// returns < 0 on failure and leaves the message in tv_last_error(), with
// tv_last_error_kind(): 1 corrupt or truncated data, 2 unsupported feature,
// 3 the operating system (open, read, write).
#include <algorithm>
#include <cctype>
#include <cerrno>
#include <cmath>
#include <cstdio>
#include <functional>
#include <cstring>
#include <memory>
#include <string>
#include <thread>
#include <vector>

#include "tecovideo.h"

namespace tv {
namespace {

thread_local std::string g_error;
thread_local int g_error_kind = 0;

struct IoError : std::runtime_error {
    using std::runtime_error::runtime_error;
};

int fail(int kind, const std::string& msg) {
    g_error = msg;
    g_error_kind = kind;
    return -kind;
}

template <class F>
int guarded(F&& f) {
    try {
        return f();
    } catch (const Unsupported& e) {
        return fail(2, e.what());
    } catch (const IoError& e) {
        return fail(3, e.what());
    } catch (const std::bad_alloc&) {
        return fail(1, "out of memory");
    } catch (const std::exception& e) {
        return fail(1, e.what());
    }
}

// FFmpeg's av_reduce: the best rational num/den with both <= max.
void av_reduce(int64_t num, int64_t den, int64_t max, int64_t& out_num, int64_t& out_den) {
    auto gcd = [](int64_t a, int64_t b) {
        while (b) {
            int64_t t = a % b;
            a = b;
            b = t;
        }
        return a;
    };
    int64_t a0n = 0, a0d = 1, a1n = 1, a1d = 0;
    int64_t g = gcd(std::llabs(num), std::llabs(den));
    if (g) {
        num = std::llabs(num) / g;
        den = std::llabs(den) / g;
    }
    if (num <= max && den <= max) {
        a1n = num;
        a1d = den;
        den = 0;
    }
    while (den) {
        uint64_t x = uint64_t(num / den);
        int64_t next_den = num - den * int64_t(x);
        int64_t a2n = int64_t(x) * a1n + a0n, a2d = int64_t(x) * a1d + a0d;
        if (a2n > max || a2d > max) {
            if (a1n) x = uint64_t((max - a0n) / a1n);
            if (a1d) x = std::min<uint64_t>(x, uint64_t((max - a0d) / a1d));
            if (den * (2 * int64_t(x) * a1d + a0d) > num * a1d) {
                a1n = int64_t(x) * a1n + a0n;
                a1d = int64_t(x) * a1d + a0d;
            }
            break;
        }
        a0n = a1n;
        a0d = a1d;
        a1n = a2n;
        a1d = a2d;
        num = den;
        den = next_den;
    }
    out_num = a1n;
    out_den = a1d;
}

double reduced_rate(int64_t num, int64_t den, int64_t max) {
    if (num <= 0 || den <= 0) return 0.0;
    int64_t n, d;
    av_reduce(num, den, max, n, d);
    return d ? double(n) / double(d) : 0.0;
}

constexpr int64_t kIntMax = 2147483647;

// ---------------------------------------------------------------- files
class File {
  public:
    explicit File(const std::string& path) {
        f_ = std::fopen(path.c_str(), "rb");
        if (!f_) throw IoError("cannot open " + path + ": " + std::strerror(errno));
        std::fseek(f_, 0, SEEK_END);
        size_ = std::ftell(f_);
    }
    ~File() {
        if (f_) std::fclose(f_);
    }
    int64_t size() const { return size_; }
    void read(int64_t off, void* dst, size_t n) {
        if (off < 0 || off + int64_t(n) > size_) throw DecodeError("read past the end of the file");
        if (std::fseek(f_, long(off), SEEK_SET) || std::fread(dst, 1, n, f_) != n)
            throw IoError(std::string("read failed: ") + std::strerror(errno));
    }
    std::vector<uint8_t> bytes(int64_t off, size_t n) {
        std::vector<uint8_t> v(n);
        if (n) read(off, v.data(), n);
        return v;
    }

  private:
    FILE* f_ = nullptr;
    int64_t size_ = 0;
};

inline uint32_t le32(const uint8_t* p) { return p[0] | (p[1] << 8) | (p[2] << 16) | (uint32_t(p[3]) << 24); }
inline uint16_t le16(const uint8_t* p) { return uint16_t(p[0] | (p[1] << 8)); }
inline uint32_t be32(const uint8_t* p) {
    return (uint32_t(p[0]) << 24) | (p[1] << 16) | (p[2] << 8) | p[3];
}
inline uint16_t be16(const uint8_t* p) { return uint16_t((p[0] << 8) | p[1]); }
inline uint64_t be64(const uint8_t* p) { return (uint64_t(be32(p)) << 32) | be32(p + 4); }
std::string fourcc(const uint8_t* p) { return std::string(reinterpret_cast<const char*>(p), 4); }

struct Packet {
    int64_t offset;
    uint32_t size;
    bool key;
    int64_t pts = 0;  // presentation time in the track's units (AVI: the index)
};

struct Track {
    std::string container;
    std::string codec;  // "mjpeg", "mpeg4", or the name of a codec not decoded here
    int width = 0, height = 0;
    double fps = 0.0;
    std::vector<uint8_t> extradata;
    std::vector<Packet> packets;
};

std::string codec_from_fourcc(const std::string& cc) {
    std::string u = cc;
    for (char& c : u) c = char(std::toupper(static_cast<unsigned char>(c)));
    if (u == "MJPG" || u == "AVRN" || u == "LJPG" || u == "JPGL" || u == "DMB1" || u == "JPEG")
        return "mjpeg";
    if (u == "XVID" || u == "DIVX" || u == "DX50" || u == "FMP4" || u == "MP4V" || u == "M4S2" ||
        u == "XVIX" || u == "MP4S")
        return "mpeg4";
    if (u == "H264" || u == "X264" || u == "AVC1" || u == "DAVC") return "h264";
    if (u == "HEVC" || u == "H265" || u == "HVC1" || u == "HEV1") return "hevc";
    if (u == "AV01") return "av1";
    if (u == "VP90") return "vp9";
    std::string printable;
    for (char c : cc) printable += (c >= 32 && c < 127) ? c : '?';
    return "fourcc " + printable;
}

// ---------------------------------------------------------------- AVI
Track demux_avi(File& f) {
    Track t;
    t.container = "avi";
    uint8_t hdr[12];
    f.read(0, hdr, 12);
    if (fourcc(hdr) != "RIFF" || fourcc(hdr + 8) != "AVI ") throw DecodeError("not an AVI file");
    const int64_t riff_end = std::min<int64_t>(f.size(), 8 + int64_t(le32(hdr + 4)));
    int stream = -1, nstreams = 0;
    int64_t scale = 0, rate = 0;
    std::string handler, compression;
    int64_t movi = -1, movi_end = -1;
    std::vector<uint8_t> idx1;

    // hdrl: the first 'vids' stream.
    std::function<void(int64_t, int64_t, int)> walk = [&](int64_t p, int64_t end, int depth) {
        std::string strh_type;
        while (p + 8 <= end) {
            uint8_t ck[12];
            f.read(p, ck, 8);
            std::string id = fourcc(ck);
            int64_t size = le32(ck + 4);
            int64_t data = p + 8;
            if (data + size > f.size()) size = f.size() - data;
            if (id == "LIST") {
                if (size < 4) throw DecodeError("AVI: short LIST");
                f.read(data, ck + 8, 4);
                std::string type = fourcc(ck + 8);
                if (type == "movi") {
                    if (movi < 0) {
                        movi = data;
                        movi_end = data + size;
                    }
                } else if (type == "strl") {
                    walk(data + 4, data + size, depth + 1);
                    nstreams++;
                } else if (type == "hdrl") {
                    walk(data + 4, data + size, depth + 1);
                }
            } else if (id == "strh" && size >= 28) {
                auto b = f.bytes(data, size_t(size));
                strh_type = fourcc(b.data());
                if (strh_type == "vids" && stream < 0) {
                    stream = nstreams;
                    handler = fourcc(b.data() + 4);
                    scale = le32(b.data() + 20);
                    rate = le32(b.data() + 24);
                }
            } else if (id == "strf" && strh_type == "vids" && stream == nstreams && size >= 40) {
                auto b = f.bytes(data, size_t(size));
                t.width = int(std::abs(int32_t(le32(b.data() + 4))));
                t.height = int(std::abs(int32_t(le32(b.data() + 8))));
                compression = fourcc(b.data() + 16);
                t.extradata.assign(b.begin() + 40, b.end());
            } else if (id == "indx" && depth > 0) {
                throw Unsupported("AVI: an OpenDML (indx) index; files over 1 GiB are not read");
            } else if (id == "idx1" && depth == 0) {
                idx1 = f.bytes(data, size_t(size));
            }
            p = data + size + (size & 1);
        }
    };
    walk(12, riff_end, 0);
    if (stream < 0) throw DecodeError("AVI: no video stream");
    if (movi < 0) throw DecodeError("AVI: no movi list");
    std::string cc = compression;
    if (cc.empty() || cc == std::string(4, '\0')) cc = handler;
    t.codec = codec_from_fourcc(cc);
    if (t.codec.rfind("fourcc", 0) == 0) {
        std::string h = codec_from_fourcc(handler);
        if (h.rfind("fourcc", 0) != 0) t.codec = h;
    }
    t.fps = reduced_rate(rate, scale, kIntMax);

    char id_dc[5], id_db[5];
    std::snprintf(id_dc, sizeof id_dc, "%02ddc", stream);
    std::snprintf(id_db, sizeof id_db, "%02ddb", stream);
    auto ours = [&](const uint8_t* p) {
        return std::memcmp(p, id_dc, 4) == 0 || std::memcmp(p, id_db, 4) == 0;
    };
    bool have_keys = false;
    if (idx1.size() >= 16) {
        // Offsets are from the 'movi' fourcc, or absolute in some writers.
        int64_t base = -1;
        for (size_t i = 0; i + 16 <= idx1.size(); i += 16) {
            const uint8_t* e = idx1.data() + i;
            if (!ours(e)) continue;
            int64_t off = le32(e + 8);
            uint8_t probe[4];
            if (base < 0) {
                base = movi;
                if (base + off + 8 > f.size()) {
                    base = 0;
                } else {
                    f.read(base + off, probe, 4);
                    if (!ours(probe)) base = 0;
                }
            }
            uint32_t size = le32(e + 12);
            if (!size) continue;
            int64_t data = base + off + 8;
            if (data + size > f.size()) throw DecodeError("AVI: idx1 points past the end of the file");
            t.packets.push_back({data, size, (le32(e + 4) & 0x10) != 0,
                                 int64_t(t.packets.size())});
        }
        have_keys = true;
    }
    if (t.packets.empty()) {  // no usable idx1: scan movi
        have_keys = false;
        std::function<void(int64_t, int64_t)> scan = [&](int64_t p, int64_t end) {
            while (p + 8 <= end) {
                uint8_t ck[12];
                f.read(p, ck, 8);
                int64_t size = le32(ck + 4);
                if (fourcc(ck) == "LIST") {
                    f.read(p + 8, ck + 8, 4);
                    if (fourcc(ck + 8) == "rec ") scan(p + 12, std::min(end, p + 8 + size));
                } else if (ours(ck) && size > 0) {
                    if (p + 8 + size > f.size()) throw DecodeError("AVI: truncated chunk");
                    t.packets.push_back({p + 8, uint32_t(size), true,
                                         int64_t(t.packets.size())});
                }
                p += 8 + size + (size & 1);
            }
        };
        scan(movi + 4, movi_end);
    }
    if (!have_keys && t.codec == "mpeg4")
        for (Packet& pk : t.packets) {
            auto b = f.bytes(pk.offset, std::min<size_t>(pk.size, 4096));
            pk.key = mpeg4_is_key(b.data(), b.size());
        }
    return t;
}

// ---------------------------------------------------------------- MP4
struct Box {
    std::string type;
    int64_t data, end;  // payload range
};

std::vector<Box> children(File& f, int64_t p, int64_t end) {
    std::vector<Box> out;
    while (p + 8 <= end) {
        uint8_t h[16];
        f.read(p, h, 8);
        int64_t size = be32(h), hdr = 8;
        if (size == 1) {
            f.read(p + 8, h + 8, 8);
            size = int64_t(be64(h + 8));
            hdr = 16;
        } else if (size == 0) {
            size = end - p;
        }
        if (size < hdr || p + size > end) throw DecodeError("MP4: a box runs past its parent");
        out.push_back({fourcc(h + 4), p + hdr, p + size});
        p += size;
    }
    return out;
}

const Box* find(const std::vector<Box>& boxes, const char* type) {
    for (const Box& b : boxes)
        if (b.type == type) return &b;
    return nullptr;
}

// MPEG-4 descriptor: tag, then a length of up to four 7-bit groups.
bool read_descriptor(const std::vector<uint8_t>& b, size_t& p, int& tag, size_t& len) {
    if (p + 2 > b.size()) return false;
    tag = b[p++];
    len = 0;
    for (int i = 0; i < 4 && p < b.size(); i++) {
        uint8_t c = b[p++];
        len = (len << 7) | (c & 0x7F);
        if (!(c & 0x80)) break;
    }
    return p + len <= b.size();
}

// The payload of the sample entry's child box `type` (esds, avcC, vpcC): the
// children follow the visual sample entry's 78 bytes. Empty if absent.
std::vector<uint8_t> entry_child(const std::vector<uint8_t>& stsd, size_t esz, const char* type) {
    size_t p = 16 + 78, end = 8 + esz;
    while (p + 8 <= end) {
        size_t bs = be32(stsd.data() + p);
        if (bs < 8 || p + bs > end) break;
        if (fourcc(stsd.data() + p + 4) == type)
            return {stsd.begin() + long(p + 8), stsd.begin() + long(p + bs)};
        p += bs;
    }
    return {};
}

Track demux_mp4(File& f) {
    Track t;
    t.container = "mp4";
    auto top = children(f, 0, f.size());
    const Box* moov = find(top, "moov");
    if (!moov) throw DecodeError("MP4: no moov box");
    for (const Box& trak : children(f, moov->data, moov->end)) {
        if (trak.type != "trak") continue;
        auto tk = children(f, trak.data, trak.end);
        const Box* mdia = find(tk, "mdia");
        if (!mdia) continue;
        auto md = children(f, mdia->data, mdia->end);
        const Box* hdlr = find(md, "hdlr");
        const Box* mdhd = find(md, "mdhd");
        const Box* minf = find(md, "minf");
        if (!hdlr || !mdhd || !minf) continue;
        auto hb = f.bytes(hdlr->data, size_t(hdlr->end - hdlr->data));
        if (hb.size() < 12 || fourcc(hb.data() + 8) != "vide") continue;
        auto mh = f.bytes(mdhd->data, size_t(mdhd->end - mdhd->data));
        if (mh.size() < 24) throw DecodeError("MP4: short mdhd");
        int64_t timescale = mh[0] == 1 ? be32(mh.data() + 20) : be32(mh.data() + 12);
        const Box* stbl = nullptr;
        auto mi = children(f, minf->data, minf->end);
        if (const Box* s = find(mi, "stbl")) stbl = s;
        if (!stbl) throw DecodeError("MP4: no stbl box");
        auto st = children(f, stbl->data, stbl->end);
        auto payload = [&](const char* type) -> std::vector<uint8_t> {
            const Box* b = find(st, type);
            if (!b) return {};
            return f.bytes(b->data, size_t(b->end - b->data));
        };
        // Sample description: the codec, size and extradata.
        auto stsd = payload("stsd");
        if (stsd.size() < 16) throw DecodeError("MP4: no sample description");
        size_t esz = be32(stsd.data() + 8);
        std::string entry = fourcc(stsd.data() + 12);
        if (esz < 86 || 8 + esz > stsd.size()) throw DecodeError("MP4: short sample entry");
        const uint8_t* e = stsd.data() + 16;  // the entry's payload
        t.width = be16(e + 24);
        t.height = be16(e + 26);
        if (entry == "mp4v") {
            t.codec = "mpeg4";
            std::vector<uint8_t> es = entry_child(stsd, esz, "esds");
            // The full box's version and flags, then the descriptors.
            es.erase(es.begin(), es.begin() + long(std::min<size_t>(4, es.size())));
            size_t q = 0;
            int tag;
            size_t len;
            while (read_descriptor(es, q, tag, len)) {
                if (tag == 3) {  // ES_Descriptor
                    if (q + 3 > es.size()) break;
                    uint8_t flags = es[q + 2];
                    q += 3;
                    if (flags & 0x80) q += 2;
                    if ((flags & 0x40) && q < es.size()) q += 1 + es[q];
                    if (flags & 0x20) q += 2;
                } else if (tag == 4) {  // DecoderConfigDescriptor
                    if (q + 13 > es.size()) break;
                    uint8_t oti = es[q];
                    if (oti == 0x6C || oti == 0x6D) t.codec = "mjpeg";
                    else if (oti == 0x21) t.codec = "h264";
                    else if (oti != 0x20) {
                        char name[32];
                        std::snprintf(name, sizeof name, "object type 0x%02x", oti);
                        t.codec = name;
                    }
                    q += 13;
                } else if (tag == 5) {  // DecoderSpecificInfo
                    t.extradata.assign(es.begin() + long(q), es.begin() + long(q + len));
                    q += len;
                } else {
                    q += len;
                }
            }
        } else if (entry == "jpeg" || entry == "mjpa" || entry == "mjpb") {
            t.codec = "mjpeg";
        } else if (entry == "avc1" || entry == "avc3") {
            t.codec = "h264";
            t.extradata = entry_child(stsd, esz, "avcC");
        } else if (entry == "vp09") {
            t.codec = "vp9";
            t.extradata = entry_child(stsd, esz, "vpcC");
        } else if (entry == "hvc1" || entry == "hev1") {
            t.codec = "hevc";
        } else if (entry == "av01") {
            t.codec = "av1";
        } else {
            t.codec = codec_from_fourcc(entry);
        }
        // Sample table.
        auto stsz = payload("stsz"), stsc = payload("stsc"), stts = payload("stts");
        auto stco = payload("stco"), co64 = payload("co64"), stss = payload("stss");
        if (stsz.size() < 12 || stsc.size() < 8) throw DecodeError("MP4: no sample table");
        uint32_t fixed = be32(stsz.data() + 4), count = be32(stsz.data() + 8);
        if (!fixed && stsz.size() < 12 + size_t(count) * 4) throw DecodeError("MP4: short stsz");
        std::vector<int64_t> chunks;
        if (!stco.empty()) {
            uint32_t n = be32(stco.data() + 4);
            if (stco.size() < 8 + size_t(n) * 4) throw DecodeError("MP4: short stco");
            for (uint32_t i = 0; i < n; i++) chunks.push_back(be32(stco.data() + 8 + 4 * i));
        } else if (!co64.empty()) {
            uint32_t n = be32(co64.data() + 4);
            if (co64.size() < 8 + size_t(n) * 8) throw DecodeError("MP4: short co64");
            for (uint32_t i = 0; i < n; i++) chunks.push_back(int64_t(be64(co64.data() + 8 + 8 * i)));
        } else {
            throw DecodeError("MP4: no chunk offsets");
        }
        uint32_t nsc = be32(stsc.data() + 4);
        if (stsc.size() < 8 + size_t(nsc) * 12) throw DecodeError("MP4: short stsc");
        uint32_t sample = 0;
        for (size_t c = 0; c < chunks.size() && sample < count; c++) {
            uint32_t per = 0;
            for (uint32_t i = 0; i < nsc; i++) {
                const uint8_t* r = stsc.data() + 8 + 12 * i;
                if (be32(r) <= c + 1) per = be32(r + 4);
            }
            int64_t off = chunks[c];
            for (uint32_t k = 0; k < per && sample < count; k++, sample++) {
                uint32_t size = fixed ? fixed : be32(stsz.data() + 12 + 4 * sample);
                if (off + size > f.size()) throw DecodeError("MP4: a sample runs past the file");
                t.packets.push_back({off, size, stss.empty()});
                off += size;
            }
        }
        if (!stss.empty()) {
            uint32_t n = be32(stss.data() + 4);
            for (uint32_t i = 0; i < n && 8 + 4 * i + 4 <= stss.size(); i++) {
                uint32_t s = be32(stss.data() + 8 + 4 * i);
                if (s >= 1 && s <= t.packets.size()) t.packets[s - 1].key = true;
            }
        }
        int64_t duration = 0, frames = 0;
        if (stts.size() >= 8) {  // decode times; presentation = decode + ctts
            uint32_t n = be32(stts.data() + 4);
            size_t s = 0;
            for (uint32_t i = 0; i < n && 8 + 8 * i + 8 <= stts.size(); i++) {
                uint32_t run = be32(stts.data() + 8 + 8 * i);
                uint32_t delta = be32(stts.data() + 12 + 8 * i);
                for (uint32_t k = 0; k < run && s < t.packets.size(); k++, s++)
                    t.packets[s].pts = duration + int64_t(k) * delta;
                frames += run;
                duration += int64_t(run) * delta;
            }
        }
        auto ctts = payload("ctts");
        if (ctts.size() >= 8) {
            bool signed_offsets = ctts[0] == 1;
            uint32_t n = be32(ctts.data() + 4);
            size_t s = 0;
            for (uint32_t i = 0; i < n && 8 + 8 * i + 8 <= ctts.size(); i++) {
                uint32_t run = be32(ctts.data() + 8 + 8 * i), off = be32(ctts.data() + 12 + 8 * i);
                for (uint32_t k = 0; k < run && s < t.packets.size(); k++, s++)
                    t.packets[s].pts += signed_offsets ? int64_t(int32_t(off)) : int64_t(off);
            }
        }
        if (duration > 0 && frames > 0) t.fps = reduced_rate(timescale * frames, duration, kIntMax);
        return t;
    }
    throw DecodeError("MP4: no video track");
}

// ---------------------------------------------------------------- Matroska
class Ebml {
  public:
    Ebml(File& f, int64_t p, int64_t end) : f_(f), p_(p), end_(end) {}
    // Reads an element header; size -1 = unknown.
    bool next(uint32_t& id, int64_t& size, int64_t& data) {
        if (p_ >= end_) return false;
        uint8_t b[12];
        int n = int(std::min<int64_t>(12, end_ - p_));
        f_.read(p_, b, size_t(n));
        int len = vint_len(b[0]);
        if (len > 4 || len > n) throw DecodeError("MKV: bad element id");
        id = 0;
        for (int i = 0; i < len; i++) id = (id << 8) | b[i];
        int sl = vint_len(b[len]);
        if (sl > 8 || len + sl > n) throw DecodeError("MKV: bad element size");
        uint64_t v = b[len] & (0xFF >> sl);
        bool all_ones = v == uint64_t(0xFF >> sl);
        for (int i = 1; i < sl; i++) {
            v = (v << 8) | b[len + i];
            all_ones = all_ones && b[len + i] == 0xFF;
        }
        data = p_ + len + sl;
        size = all_ones ? -1 : int64_t(v);
        return true;
    }
    void seek(int64_t p) { p_ = p; }
    int64_t end() const { return end_; }

    static int vint_len(uint8_t first) {
        for (int i = 0; i < 8; i++)
            if (first & (0x80 >> i)) return i + 1;
        return 9;
    }

  private:
    File& f_;
    int64_t p_, end_;
};

uint64_t ebml_uint(File& f, int64_t p, int64_t size) {
    if (size > 8) throw DecodeError("MKV: integer longer than 8 bytes");
    auto b = f.bytes(p, size_t(size));
    uint64_t v = 0;
    for (uint8_t c : b) v = (v << 8) | c;
    return v;
}

bool is_top_level(uint32_t id) {
    return id == 0x1F43B675 || id == 0x1C53BB6B || id == 0x1254C367 || id == 0x1043A770 ||
           id == 0x1941A469 || id == 0x114D9B74 || id == 0x1549A966 || id == 0x1654AE6B ||
           id == 0x18538067 || id == 0x1A45DFA3;
}

Track demux_mkv(File& f) {
    Track t;
    t.container = "mkv";
    struct Block {
        uint64_t track;
        int64_t off;
        uint32_t size;
        bool key;
        int64_t time;
    };
    std::vector<Block> blocks;
    struct Entry {
        uint64_t number = 0, type = 0, duration = 0, w = 0, h = 0;
        std::string codec;
        std::vector<uint8_t> priv;
        bool encoded = false;
    };
    std::vector<Entry> entries;
    uint64_t timescale = 1000000;

    auto parse_block = [&](int64_t data, int64_t size, bool simple, bool key, int64_t cluster_tc) {
        if (size < 4) throw DecodeError("MKV: short block");
        auto b = f.bytes(data, size_t(std::min<int64_t>(size, 12)));
        int tl = Ebml::vint_len(b[0]);
        if (tl > 8 || tl + 3 > int(b.size())) throw DecodeError("MKV: bad block track number");
        uint64_t track = b[0] & (0xFF >> tl);
        for (int i = 1; i < tl; i++) track = (track << 8) | b[i];
        int16_t rel = int16_t((b[tl] << 8) | b[tl + 1]);
        uint8_t flags = b[tl + 2];
        if ((flags >> 1) & 3) throw Unsupported("MKV: laced blocks");
        int64_t off = data + tl + 3;
        blocks.push_back({track, off, uint32_t(size - tl - 3), simple ? (flags & 0x80) != 0 : key,
                          cluster_tc + rel});
    };

    Ebml top(f, 0, f.size());
    uint32_t id;
    int64_t size, data;
    bool have_ebml = false;
    while (top.next(id, size, data)) {
        int64_t end = size < 0 ? f.size() : std::min(f.size(), data + size);
        if (id == 0x1A45DFA3) {
            have_ebml = true;
            Ebml h(f, data, end);
            uint32_t cid;
            int64_t cs, cd;
            while (h.next(cid, cs, cd)) {
                if (cid == 0x4282) {  // DocType
                    auto b = f.bytes(cd, size_t(cs));
                    std::string dt(b.begin(), b.end());
                    dt = dt.c_str();
                    if (dt != "matroska" && dt != "webm") throw DecodeError("MKV: DocType " + dt);
                }
                h.seek(cd + cs);
            }
        } else if (id == 0x18538067) {
            if (!have_ebml) throw DecodeError("not a Matroska file");
            Ebml seg(f, data, end);
            uint32_t sid;
            int64_t ss, sd;
            while (seg.next(sid, ss, sd)) {
                int64_t send = ss < 0 ? end : std::min(end, sd + ss);
                if (sid == 0x1549A966) {  // Info
                    Ebml in(f, sd, send);
                    uint32_t iid;
                    int64_t is, idd;
                    while (in.next(iid, is, idd)) {
                        if (iid == 0x2AD7B1) timescale = ebml_uint(f, idd, is);
                        in.seek(idd + is);
                    }
                } else if (sid == 0x1654AE6B) {  // Tracks
                    Ebml tr(f, sd, send);
                    uint32_t tid;
                    int64_t ts, td;
                    while (tr.next(tid, ts, td)) {
                        if (tid == 0xAE) {
                            Entry en;
                            Ebml te(f, td, td + ts);
                            uint32_t eid;
                            int64_t es, ed;
                            while (te.next(eid, es, ed)) {
                                if (eid == 0xD7) en.number = ebml_uint(f, ed, es);
                                else if (eid == 0x83) en.type = ebml_uint(f, ed, es);
                                else if (eid == 0x86) {
                                    auto b = f.bytes(ed, size_t(es));
                                    en.codec.assign(b.begin(), b.end());
                                    en.codec = en.codec.c_str();
                                } else if (eid == 0x63A2) en.priv = f.bytes(ed, size_t(es));
                                else if (eid == 0x23E383) en.duration = ebml_uint(f, ed, es);
                                else if (eid == 0x6D80) en.encoded = true;
                                else if (eid == 0xE0) {
                                    Ebml v(f, ed, ed + es);
                                    uint32_t vid;
                                    int64_t vs, vd;
                                    while (v.next(vid, vs, vd)) {
                                        if (vid == 0xB0) en.w = ebml_uint(f, vd, vs);
                                        else if (vid == 0xBA) en.h = ebml_uint(f, vd, vs);
                                        v.seek(vd + vs);
                                    }
                                }
                                te.seek(ed + es);
                            }
                            entries.push_back(en);
                        }
                        tr.seek(td + ts);
                    }
                } else if (sid == 0x1F43B675) {  // Cluster (size may be unknown)
                    Ebml cl(f, sd, send);
                    int64_t tc = 0;
                    uint32_t cid;
                    int64_t cs, cd;
                    int64_t last = sd;
                    while (cl.next(cid, cs, cd)) {
                        if (ss < 0 && is_top_level(cid)) break;
                        if (cs < 0) throw DecodeError("MKV: unknown-size element inside a cluster");
                        if (cid == 0xE7) tc = int64_t(ebml_uint(f, cd, cs));
                        else if (cid == 0xA3) parse_block(cd, cs, true, true, tc);
                        else if (cid == 0xA0) {
                            Ebml bg(f, cd, cd + cs);
                            uint32_t gid;
                            int64_t gs, gd, bdata = -1, bsize = 0;
                            bool ref = false;
                            while (bg.next(gid, gs, gd)) {
                                if (gid == 0xA1) {
                                    bdata = gd;
                                    bsize = gs;
                                } else if (gid == 0xFB) {
                                    ref = true;
                                }
                                bg.seek(gd + gs);
                            }
                            if (bdata >= 0) parse_block(bdata, bsize, false, !ref, tc);
                        }
                        last = cd + cs;
                        cl.seek(cd + cs);
                    }
                    if (ss < 0) {
                        seg.seek(last);
                        continue;
                    }
                }
                if (ss < 0) break;  // an unknown-size element other than a cluster
                seg.seek(sd + ss);
            }
        }
        if (size < 0) break;
        top.seek(data + size);
    }
    if (!have_ebml) throw DecodeError("not a Matroska file");
    const Entry* video = nullptr;
    for (const Entry& e : entries)
        if (e.type == 1) {
            video = &e;
            break;
        }
    if (!video) throw DecodeError("MKV: no video track");
    if (video->encoded) throw Unsupported("MKV: content encoding (compressed or encrypted track)");
    t.width = int(video->w);
    t.height = int(video->h);
    const std::string& c = video->codec;
    if (c == "V_MJPEG") t.codec = "mjpeg";
    else if (c.rfind("V_MPEG4/ISO/", 0) == 0 && c != "V_MPEG4/ISO/AVC") t.codec = "mpeg4";
    else if (c == "V_MPEG4/ISO/AVC") t.codec = "h264";
    else if (c == "V_MPEGH/ISO/HEVC") t.codec = "hevc";
    else if (c == "V_AV1") t.codec = "av1";
    else if (c == "V_VP9") t.codec = "vp9";
    else if (c == "V_MS/VFW/FOURCC" && video->priv.size() >= 40) {
        t.codec = codec_from_fourcc(fourcc(video->priv.data() + 16));
        t.extradata.assign(video->priv.begin() + 40, video->priv.end());
    } else t.codec = c.empty() ? "unknown" : c;
    if (t.extradata.empty() && c != "V_MS/VFW/FOURCC") t.extradata = video->priv;
    for (const Block& b : blocks)
        if (b.track == video->number) t.packets.push_back({b.off, b.size, b.key, b.time});
    if (video->duration) {
        t.fps = reduced_rate(1000000000, int64_t(video->duration), 30000);
    } else if (blocks.size() > 1) {
        int64_t first = -1, lastt = -1;
        int64_t n = 0;
        for (const Block& b : blocks)
            if (b.track == video->number) {
                if (first < 0) first = b.time;
                lastt = b.time;
                n++;
            }
        if (lastt > first)
            t.fps = double(n - 1) * 1e9 / (double(lastt - first) * double(timescale));
    }
    return t;
}

Track demux(File& f) {
    uint8_t h[12] = {};
    f.read(0, h, size_t(std::min<int64_t>(12, f.size())));
    if (f.size() >= 12 && fourcc(h) == "RIFF" && fourcc(h + 8) == "AVI ") return demux_avi(f);
    if (f.size() >= 4 && be32(h) == 0x1A45DFA3) return demux_mkv(f);
    if (f.size() >= 8) {
        std::string b = fourcc(h + 4);
        if (b == "ftyp" || b == "moov" || b == "mdat" || b == "free" || b == "wide" || b == "skip")
            return demux_mp4(f);
    }
    throw DecodeError("not an AVI, MP4 or Matroska file");
}

// ---------------------------------------------------------------- reader
struct Reader {
    std::unique_ptr<File> file;
    Track track;
    Mpeg4Decoder mpeg4;
    JpegDecoder jpeg;
    size_t next = 0;       // next packet to decode
    size_t emit_from = 0;  // frames before this packet index are not returned
    std::vector<uint8_t> buf;
    Picture pic;

    // Decodes packets until one frame is shown; false at the end.
    bool decode_one(uint8_t* rgb) {
        while (next < track.packets.size()) {
            const Packet& p = track.packets[next];
            buf.resize(p.size + 16);
            file->read(p.offset, buf.data(), p.size);
            std::fill(buf.begin() + p.size, buf.end(), 0);
            size_t index = next++;
            bool shown;
            if (track.codec == "mjpeg") {
                if (index < emit_from) continue;  // every frame is a key frame
                jpeg.decode(buf.data(), p.size, pic);
                shown = true;
            } else {
                shown = mpeg4.decode(buf.data(), p.size, pic);
            }
            if (!shown || index < emit_from) continue;
            if (pic.width != track.width || pic.height != track.height)
                throw DecodeError("frame size " + std::to_string(pic.width) + "x" +
                                  std::to_string(pic.height) + " differs from the container's " +
                                  std::to_string(track.width) + "x" + std::to_string(track.height));
            picture_to_rgb(pic, rgb);
            return true;
        }
        return false;
    }
    void seek(size_t frame) {
        size_t k = std::min(frame, track.packets.size());
        if (track.codec == "mpeg4") {
            while (k > 0 && (k >= track.packets.size() || !track.packets[k].key)) k--;
            mpeg4.reset_references();
        }
        next = k;
        emit_from = frame;
    }
};

// ---------------------------------------------------------------- writers
class Out {
  public:
    explicit Out(const std::string& path) : path_(path) {
        f_ = std::fopen(path.c_str(), "wb");
        if (!f_) throw IoError("cannot create " + path + ": " + std::strerror(errno));
    }
    ~Out() {
        if (f_) std::fclose(f_);
    }
    void write(const void* p, size_t n) {
        if (n && std::fwrite(p, 1, n, f_) != n)
            throw IoError("write to " + path_ + " failed: " + std::strerror(errno));
        pos_ += int64_t(n);
    }
    void write(const std::vector<uint8_t>& v) { write(v.data(), v.size()); }
    void patch(int64_t at, const std::vector<uint8_t>& v) {
        std::fflush(f_);
        std::fseek(f_, long(at), SEEK_SET);
        if (std::fwrite(v.data(), 1, v.size(), f_) != v.size())
            throw IoError("write to " + path_ + " failed");
        std::fseek(f_, 0, SEEK_END);
    }
    int64_t pos() const { return pos_; }
    void close() {
        if (f_ && std::fclose(f_)) {
            f_ = nullptr;
            throw IoError("closing " + path_ + " failed");
        }
        f_ = nullptr;
    }

  private:
    std::string path_;
    FILE* f_ = nullptr;
    int64_t pos_ = 0;
};

struct Bytes {
    std::vector<uint8_t> v;
    void u8(uint32_t x) { v.push_back(uint8_t(x)); }
    void le16(uint32_t x) { u8(x); u8(x >> 8); }
    void le32(uint32_t x) { le16(x & 0xFFFF); le16(x >> 16); }
    void be16(uint32_t x) { u8(x >> 8); u8(x); }
    void be32(uint32_t x) { be16(x >> 16); be16(x & 0xFFFF); }
    void be64(uint64_t x) { be32(uint32_t(x >> 32)); be32(uint32_t(x)); }
    void cc(const char* s) { v.insert(v.end(), s, s + 4); }
    void raw(const std::vector<uint8_t>& b) { v.insert(v.end(), b.begin(), b.end()); }
    void zeros(size_t n) { v.insert(v.end(), n, 0); }
};

enum Kind { kAviMjpeg = 0, kMp4Mpeg4 = 1, kMkvMpeg4 = 2, kMkvMjpeg = 3 };

struct Writer {
    Kind kind;
    int width, height, num, den, quality;
    std::unique_ptr<Out> out;
    std::unique_ptr<Mpeg4Encoder> mpeg4;
    std::vector<uint32_t> sizes;
    std::vector<int64_t> offsets;
    // AVI
    int64_t movi_pos = 0;
    // MP4
    int64_t mdat_pos = 0;
    // MKV
    int64_t segment_pos = 0, duration_pos = 0;
    Bytes cluster;
    int64_t cluster_ms = -1;
    int64_t frames = 0;
    static constexpr int64_t kAviLimit = int64_t(1) << 30;

    Writer(const std::string& path, Kind k, int w, int h, int n, int d, int q, int options)
        : kind(k), width(w), height(h), num(n), den(d), quality(q) {
        if (w <= 0 || h <= 0) throw DecodeError("frame size must be positive");
        if (n <= 0 || d <= 0) throw DecodeError("frame rate must be positive");
        if (k == kMp4Mpeg4 || k == kMkvMpeg4) mpeg4.reset(new Mpeg4Encoder(w, h, n, d, q, options));
        out.reset(new Out(path));
        if (k == kAviMjpeg) avi_begin();
        else if (k == kMp4Mpeg4) mp4_begin();
        else mkv_begin();
    }

    // Encodes n frames of packed RGB24 on up to one thread per core (every
    // frame is a key frame, so they are independent) and muxes them in order.
    void encode_and_add(const uint8_t* rgb, int n) {
        const size_t frame = size_t(width) * height * 3;
        std::vector<std::vector<uint8_t>> packets(size_t(std::max(n, 0)));
        std::vector<std::string> errors(packets.size());
        auto work = [&](int first, int step) {
            for (int i = first; i < n; i += step) {
                try {
                    const uint8_t* src = rgb + frame * size_t(i);
                    packets[size_t(i)] = mpeg4 ? mpeg4->encode(src, frames + i)
                                               : jpeg_encode(src, width, height, quality);
                } catch (const std::exception& e) {
                    errors[size_t(i)] = e.what();
                }
            }
        };
        int threads = std::min<int>(n, std::max(1u, std::thread::hardware_concurrency()));
        std::vector<std::thread> pool;
        for (int t = 1; t < threads; t++) pool.emplace_back(work, t, threads);
        work(0, threads);
        for (std::thread& th : pool) th.join();
        for (int i = 0; i < n; i++) {
            if (!errors[size_t(i)].empty()) throw DecodeError(errors[size_t(i)]);
            add(packets[size_t(i)], true);
        }
    }

    void add(const std::vector<uint8_t>& pkt, bool key) {
        if (kind == kAviMjpeg) {
            int64_t need = out->pos() + 8 + int64_t(pkt.size()) + 1 + 16 * int64_t(sizes.size() + 1) + 8;
            if (need > kAviLimit)
                throw Unsupported("AVI: the file would pass 1 GiB (no OpenDML index is written); "
                                  "write .mkv or .mp4 instead");
            Bytes b;
            b.cc("00dc");
            b.le32(uint32_t(pkt.size()));
            offsets.push_back(out->pos() - movi_pos);
            out->write(b.v);
            out->write(pkt);
            if (pkt.size() & 1) out->write("\0", 1);
        } else if (kind == kMp4Mpeg4) {
            offsets.push_back(out->pos());
            out->write(pkt);
        } else {
            mkv_block(pkt, key);
        }
        sizes.push_back(uint32_t(pkt.size()));
        frames++;
    }

    // AVI ------------------------------------------------------------
    void avi_begin() {
        Bytes b;
        b.cc("RIFF");
        b.le32(0);
        b.cc("AVI ");
        b.cc("LIST");
        b.le32(4 + 64 + 12 + 64 + 48);
        b.cc("hdrl");
        b.cc("avih");
        b.le32(56);
        b.le32(uint32_t(std::llround(1e6 * den / num)));
        b.le32(0);
        b.le32(0);
        b.le32(0x10);  // AVIF_HASINDEX
        b.le32(0);     // total frames (patched)
        b.le32(0);
        b.le32(1);
        b.le32(0);
        b.le32(uint32_t(width));
        b.le32(uint32_t(height));
        b.zeros(16);
        b.cc("LIST");
        b.le32(4 + 64 + 48);
        b.cc("strl");
        b.cc("strh");
        b.le32(56);
        b.cc("vids");
        b.cc("MJPG");
        b.le32(0);
        b.le32(0);
        b.le32(0);
        b.le32(uint32_t(den));
        b.le32(uint32_t(num));
        b.le32(0);
        b.le32(0);  // length (patched)
        b.le32(0);
        b.le32(0xFFFFFFFF);
        b.le32(0);
        b.le16(0);
        b.le16(0);
        b.le16(uint32_t(width));
        b.le16(uint32_t(height));
        b.cc("strf");
        b.le32(40);
        b.le32(40);
        b.le32(uint32_t(width));
        b.le32(uint32_t(height));
        b.le16(1);
        b.le16(24);
        b.cc("MJPG");
        b.le32(uint32_t(width * height * 3));
        b.zeros(16);
        b.cc("LIST");
        b.le32(0);  // movi size (patched)
        movi_pos = int64_t(b.v.size());
        b.cc("movi");
        out->write(b.v);
    }
    void avi_end() {
        int64_t movi_end = out->pos();
        Bytes b;
        b.cc("idx1");
        b.le32(uint32_t(16 * sizes.size()));
        for (size_t i = 0; i < sizes.size(); i++) {
            b.cc("00dc");
            b.le32(0x10);
            b.le32(uint32_t(offsets[i]));
            b.le32(sizes[i]);
        }
        out->write(b.v);
        auto le = [](uint32_t x) {
            return std::vector<uint8_t>{uint8_t(x), uint8_t(x >> 8), uint8_t(x >> 16), uint8_t(x >> 24)};
        };
        out->patch(4, le(uint32_t(out->pos() - 8)));
        out->patch(movi_pos - 4, le(uint32_t(movi_end - movi_pos)));
        out->patch(12 + 12 + 8 + 16, le(uint32_t(frames)));
        out->patch(12 + 12 + 64 + 12 + 8 + 32, le(uint32_t(frames)));
    }

    // MP4 ------------------------------------------------------------
    void mp4_begin() {
        Bytes b;
        b.be32(28);
        b.cc("ftyp");
        b.cc("isom");
        b.be32(0x200);
        b.cc("isom");
        b.cc("iso2");
        b.cc("mp41");
        b.be32(1);
        b.cc("mdat");
        b.be64(0);  // largesize (patched)
        mdat_pos = 28;
        out->write(b.v);
    }
    static void box(Bytes& parent, const char* type, const Bytes& body) {
        parent.be32(uint32_t(8 + body.v.size()));
        parent.cc(type);
        parent.raw(body.v);
    }
    static void descriptor(Bytes& b, int tag, const Bytes& body) {
        b.u8(uint32_t(tag));
        size_t n = body.v.size();
        b.u8(0x80 | ((n >> 21) & 0x7F));
        b.u8(0x80 | ((n >> 14) & 0x7F));
        b.u8(0x80 | ((n >> 7) & 0x7F));
        b.u8(n & 0x7F);
        b.raw(body.v);
    }
    void mp4_end() {
        uint64_t mdat_size = uint64_t(out->pos() - mdat_pos);
        Bytes sz;
        sz.be64(mdat_size);
        out->patch(mdat_pos + 8, sz.v);
        // Track timescale as FFmpeg's mov muxer picks it: the rate's
        // numerator doubled up to at least 10000.
        int64_t timescale = num;
        while (timescale < 10000) timescale *= 2;
        int64_t delta = timescale * den / num;
        int64_t media_dur = delta * frames;
        int64_t movie_dur = media_dur * 1000 / timescale;
        static const uint32_t matrix[9] = {0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000};
        Bytes mvhd, tkhd, mdhd, hdlr, vmhd, dref, dinf, stsd, esds, stts, stss, stsz, stsc, stco;
        mvhd.be32(0);
        mvhd.be32(0);
        mvhd.be32(0);
        mvhd.be32(1000);
        mvhd.be32(uint32_t(movie_dur));
        mvhd.be32(0x10000);
        mvhd.be16(0x100);
        mvhd.zeros(10);
        for (uint32_t m : matrix) mvhd.be32(m);
        mvhd.zeros(24);
        mvhd.be32(2);
        tkhd.be32(3);  // enabled, in movie
        tkhd.be32(0);
        tkhd.be32(0);
        tkhd.be32(1);
        tkhd.be32(0);
        tkhd.be32(uint32_t(movie_dur));
        tkhd.zeros(8);
        tkhd.be16(0);
        tkhd.be16(0);
        tkhd.be16(0);
        tkhd.be16(0);
        for (uint32_t m : matrix) tkhd.be32(m);
        tkhd.be32(uint32_t(width) << 16);
        tkhd.be32(uint32_t(height) << 16);
        mdhd.be32(0);
        mdhd.be32(0);
        mdhd.be32(0);
        mdhd.be32(uint32_t(timescale));
        mdhd.be32(uint32_t(media_dur));
        mdhd.be16(0x55C4);  // 'und'
        mdhd.be16(0);
        hdlr.be32(0);
        hdlr.be32(0);
        hdlr.cc("vide");
        hdlr.zeros(12);
        const char name[] = "VideoHandler";
        hdlr.v.insert(hdlr.v.end(), name, name + sizeof name);
        vmhd.be32(1);
        vmhd.zeros(8);
        {
            Bytes url;
            url.be32(1);
            dref.be32(0);
            dref.be32(1);
            box(dref, "url ", url);
        }
        box(dinf, "dref", dref);
        {
            Bytes es, dc, dsi, sl;
            dsi.raw(mpeg4->headers());
            uint32_t maxsize = 0;
            uint64_t total = 0;
            for (uint32_t s : sizes) {
                maxsize = std::max(maxsize, s);
                total += s;
            }
            uint32_t avg = frames ? uint32_t(double(total) * 8 * num / den / double(frames)) : 0;
            dc.u8(0x20);  // MPEG-4 Visual
            dc.u8(0x11);  // visual stream
            dc.u8(maxsize >> 16);
            dc.be16(maxsize & 0xFFFF);
            dc.be32(avg);
            dc.be32(avg);
            descriptor(dc, 5, dsi);
            es.be16(1);
            es.u8(0);
            descriptor(es, 4, dc);
            sl.u8(2);
            descriptor(es, 6, sl);
            esds.be32(0);
            descriptor(esds, 3, es);
        }
        {
            Bytes entry;
            entry.zeros(6);
            entry.be16(1);
            entry.zeros(16);
            entry.be16(uint32_t(width));
            entry.be16(uint32_t(height));
            entry.be32(0x480000);
            entry.be32(0x480000);
            entry.be32(0);
            entry.be16(1);
            entry.zeros(32);
            entry.be16(0x18);
            entry.be16(0xFFFF);
            box(entry, "esds", esds);
            stsd.be32(0);
            stsd.be32(1);
            box(stsd, "mp4v", entry);
        }
        stts.be32(0);
        stts.be32(1);
        stts.be32(uint32_t(frames));
        stts.be32(uint32_t(delta));
        stss.be32(0);
        stss.be32(uint32_t(frames));
        for (int64_t i = 0; i < frames; i++) stss.be32(uint32_t(i + 1));
        stsz.be32(0);
        stsz.be32(0);
        stsz.be32(uint32_t(frames));
        for (uint32_t s : sizes) stsz.be32(s);
        stsc.be32(0);
        stsc.be32(1);
        stsc.be32(1);
        stsc.be32(1);
        stsc.be32(1);
        bool wide = !offsets.empty() && offsets.back() > 0xFFFFFFFFll;
        stco.be32(0);
        stco.be32(uint32_t(frames));
        for (int64_t o : offsets) {
            if (wide) stco.be64(uint64_t(o));
            else stco.be32(uint32_t(o));
        }
        Bytes stbl, minf, mdia, trak, moov;
        box(stbl, "stsd", stsd);
        box(stbl, "stts", stts);
        box(stbl, "stss", stss);
        box(stbl, "stsz", stsz);
        box(stbl, "stsc", stsc);
        box(stbl, wide ? "co64" : "stco", stco);
        box(minf, "vmhd", vmhd);
        box(minf, "dinf", dinf);
        box(minf, "stbl", stbl);
        box(mdia, "mdhd", mdhd);
        box(mdia, "hdlr", hdlr);
        box(mdia, "minf", minf);
        box(trak, "tkhd", tkhd);
        box(trak, "mdia", mdia);
        box(moov, "mvhd", mvhd);
        box(moov, "trak", trak);
        Bytes file;
        box(file, "moov", moov);
        out->write(file.v);
    }

    // MKV ------------------------------------------------------------
    static void ebml_id(Bytes& b, uint32_t id) {
        if (id > 0xFFFFFF) b.u8(id >> 24);
        if (id > 0xFFFF) b.u8(id >> 16);
        if (id > 0xFF) b.u8(id >> 8);
        b.u8(id);
    }
    static void ebml_size(Bytes& b, uint64_t n) {
        int len = 1;
        while (len < 8 && n >= (uint64_t(1) << (7 * len)) - 1) len++;
        for (int i = len - 1; i >= 0; i--) {
            uint8_t c = uint8_t(n >> (8 * i));
            if (i == len - 1) c |= uint8_t(0x80 >> (len - 1));
            b.u8(c);
        }
    }
    static void el(Bytes& b, uint32_t id, const Bytes& body) {
        ebml_id(b, id);
        ebml_size(b, body.v.size());
        b.raw(body.v);
    }
    static void el_uint(Bytes& b, uint32_t id, uint64_t v) {
        Bytes body;
        int n = 1;
        while (n < 8 && (v >> (8 * n))) n++;
        for (int i = n - 1; i >= 0; i--) body.u8(uint32_t(v >> (8 * i)));
        el(b, id, body);
    }
    static void el_str(Bytes& b, uint32_t id, const std::string& s) {
        Bytes body;
        body.v.assign(s.begin(), s.end());
        el(b, id, body);
    }
    void mkv_begin() {
        Bytes head, h;
        el_uint(h, 0x4286, 1);
        el_uint(h, 0x42F7, 1);
        el_uint(h, 0x42F2, 4);
        el_uint(h, 0x42F3, 8);
        el_str(h, 0x4282, "matroska");
        el_uint(h, 0x4287, 4);
        el_uint(h, 0x4285, 2);
        el(head, 0x1A45DFA3, h);
        ebml_id(head, 0x18538067);
        segment_pos = int64_t(head.v.size());
        head.u8(0x01);  // 8-byte size, patched at the end
        head.zeros(7);
        Bytes info, tracks, entry, video;
        el_uint(info, 0x2AD7B1, 1000000);
        el_str(info, 0x4D80, "tecovideo");
        el_str(info, 0x5741, "tecovideo");
        ebml_id(info, 0x4489);  // Duration, a float64 patched at the end
        info.u8(0x88);
        info.zeros(8);
        el_uint(entry, 0xD7, 1);
        el_uint(entry, 0x73C5, 1);
        el_uint(entry, 0x83, 1);
        el_uint(entry, 0x9C, 0);
        el_str(entry, 0x86, kind == kMkvMjpeg ? "V_MJPEG" : "V_MPEG4/ISO/SP");
        if (kind == kMkvMpeg4) {
            Bytes priv;
            priv.raw(mpeg4->headers());
            el(entry, 0x63A2, priv);
        }
        el_uint(entry, 0x23E383, uint64_t(std::llround(1e9 * den / num)));
        el_uint(video, 0xB0, uint64_t(width));
        el_uint(video, 0xBA, uint64_t(height));
        el(entry, 0xE0, video);
        el(tracks, 0xAE, entry);
        Bytes seg;
        // Info with a fixed 8-byte size so duration_pos is known.
        ebml_id(seg, 0x1549A966);
        seg.u8(0x01);
        for (int i = 6; i >= 0; i--) seg.u8(uint32_t(info.v.size() >> (8 * i)));
        size_t info_start = seg.v.size();
        seg.raw(info.v);
        duration_pos = int64_t(head.v.size()) + int64_t(info_start) + int64_t(info.v.size()) - 8;
        el(seg, 0x1654AE6B, tracks);
        out->write(head.v);
        out->write(seg.v);
    }
    int64_t frame_ms(int64_t i) const { return (i * den * 1000 + num / 2) / num; }
    void mkv_flush() {
        if (cluster_ms < 0) return;
        Bytes body, c;
        el_uint(body, 0xE7, uint64_t(cluster_ms));
        body.raw(cluster.v);
        el(c, 0x1F43B675, body);
        out->write(c.v);
        cluster.v.clear();
        cluster_ms = -1;
    }
    void mkv_block(const std::vector<uint8_t>& pkt, bool key) {
        int64_t ms = frame_ms(frames);
        if (cluster_ms >= 0 && (ms - cluster_ms > 30000 || cluster.v.size() > (8u << 20)))
            mkv_flush();
        if (cluster_ms < 0) cluster_ms = ms;
        Bytes body;
        body.u8(0x81);  // track 1
        body.be16(uint32_t(ms - cluster_ms));
        body.u8(key ? 0x80 : 0x00);
        body.raw(pkt);
        el(cluster, 0xA3, body);
    }
    void mkv_end() {
        mkv_flush();
        int64_t end = out->pos();
        Bytes sz;
        sz.u8(0x01);
        for (int i = 6; i >= 0; i--) sz.u8(uint32_t(uint64_t(end - segment_pos - 8) >> (8 * i)));
        out->patch(segment_pos, sz.v);
        double dur = double(frame_ms(frames));
        uint64_t bits;
        std::memcpy(&bits, &dur, 8);
        Bytes d;
        d.be64(bits);
        out->patch(duration_pos, d.v);
    }

    void finish() {
        if (kind == kAviMjpeg) avi_end();
        else if (kind == kMp4Mpeg4) mp4_end();
        else mkv_end();
        out->close();
    }
};

}  // namespace
}  // namespace tv

using namespace tv;

extern "C" {

const char* tv_last_error() { return g_error.c_str(); }
int tv_last_error_kind() { return g_error_kind; }

void* tv_open(const char* path) {
    Reader* r = nullptr;
    int rc = guarded([&] {
        std::unique_ptr<Reader> rd(new Reader);
        rd->file.reset(new File(path));
        rd->track = demux(*rd->file);
        if (rd->track.codec == "mpeg4" && !rd->track.extradata.empty())
            rd->mpeg4.set_extradata(rd->track.extradata.data(), rd->track.extradata.size());
        r = rd.release();
        return 0;
    });
    return rc < 0 ? nullptr : r;
}

void tv_close(void* h) { delete static_cast<Reader*>(h); }

int tv_info(void* h, char* codec, int codec_len, char* container, int container_len, int* w,
            int* hgt, double* fps, int64_t* packets, int* extradata_size) {
    Reader* r = static_cast<Reader*>(h);
    std::snprintf(codec, size_t(codec_len), "%s", r->track.codec.c_str());
    std::snprintf(container, size_t(container_len), "%s", r->track.container.c_str());
    *w = r->track.width;
    *hgt = r->track.height;
    *fps = r->track.fps;
    *packets = int64_t(r->track.packets.size());
    *extradata_size = int(r->track.extradata.size());
    return 0;
}

int tv_extradata(void* h, uint8_t* buf, int cap) {
    Reader* r = static_cast<Reader*>(h);
    int n = std::min<int>(cap, int(r->track.extradata.size()));
    std::memcpy(buf, r->track.extradata.data(), size_t(n));
    return n;
}

int tv_packet(void* h, int64_t i, int64_t* offset, int* size, int* key) {
    Reader* r = static_cast<Reader*>(h);
    if (i < 0 || i >= int64_t(r->track.packets.size())) return fail(1, "packet index out of range");
    const Packet& p = r->track.packets[size_t(i)];
    *offset = p.offset;
    *size = int(p.size);
    *key = p.key;
    return 0;
}

// Presentation times of the n first packets, in decode order, in the
// track's units (MP4: decode time + ctts; MKV: block timecodes; AVI: index).
int tv_packet_pts(void* h, int64_t* pts, int64_t n) {
    Reader* r = static_cast<Reader*>(h);
    n = std::min<int64_t>(n, int64_t(r->track.packets.size()));
    for (int64_t i = 0; i < n; i++) pts[i] = r->track.packets[size_t(i)].pts;
    return int(n);
}

// H.264 packet i in Annex B, the form NVDEC's parser takes. With an avcC
// extradata (MP4 avc1/avc3, MKV V_MPEG4/ISO/AVC) each NAL unit's length
// prefix (lengthSizeMinusOne + 1 bytes) becomes a start code, and
// with_headers puts the avcC's SPS and PPS first (before the first packet
// and after every seek); a stream stored in Annex B (AVI) is copied as it
// is, after the same headers if any. Returns the size written.
int tv_annexb_packet(void* h, int64_t i, int with_headers, uint8_t* buf, int cap) {
    return guarded([&] {
        Reader* r = static_cast<Reader*>(h);
        if (i < 0 || i >= int64_t(r->track.packets.size()))
            return fail(1, "packet index out of range");
        const Packet& p = r->track.packets[size_t(i)];
        const std::vector<uint8_t>& ex = r->track.extradata;
        std::vector<uint8_t> in = r->file->bytes(p.offset, p.size), out;
        static const uint8_t kStart[4] = {0, 0, 0, 1};
        auto put = [&](const uint8_t* nal, size_t n) {
            out.insert(out.end(), kStart, kStart + 4);
            out.insert(out.end(), nal, nal + n);
        };
        const bool avcc = ex.size() >= 7 && ex[0] == 1;
        if (avcc && with_headers) {  // numSPS x (u16 size, SPS), numPPS x (u16 size, PPS)
            size_t q = 5;
            for (int list = 0; list < 2; list++) {
                if (q >= ex.size()) throw DecodeError("H.264: short avcC");
                int count = list == 0 ? (ex[q] & 0x1F) : ex[q];
                q++;
                for (int k = 0; k < count; k++) {
                    if (q + 2 > ex.size()) throw DecodeError("H.264: short avcC");
                    size_t n = be16(ex.data() + q);
                    if (q + 2 + n > ex.size()) throw DecodeError("H.264: short avcC");
                    put(ex.data() + q + 2, n);
                    q += 2 + n;
                }
            }
        }
        if (avcc) {
            const int len_size = (ex[4] & 3) + 1;
            size_t q = 0;
            while (q < in.size()) {
                if (q + size_t(len_size) > in.size())
                    throw DecodeError("H.264: truncated NAL length");
                size_t n = 0;
                for (int k = 0; k < len_size; k++) n = (n << 8) | in[q + size_t(k)];
                q += size_t(len_size);
                if (q + n > in.size()) throw DecodeError("H.264: a NAL unit runs past its packet");
                put(in.data() + q, n);
                q += n;
            }
        } else {
            out.insert(out.end(), in.begin(), in.end());
        }
        if (out.size() > size_t(cap)) return fail(1, "packet buffer too small");
        std::memcpy(buf, out.data(), out.size());
        return int(out.size());
    });
}

int tv_read_packet(void* h, int64_t i, uint8_t* buf, int cap) {
    return guarded([&] {
        Reader* r = static_cast<Reader*>(h);
        if (i < 0 || i >= int64_t(r->track.packets.size()))
            return fail(1, "packet index out of range");
        const Packet& p = r->track.packets[size_t(i)];
        if (int64_t(p.size) > cap) return fail(1, "packet buffer too small");
        r->file->read(p.offset, buf, p.size);
        return int(p.size);
    });
}

// Decodes up to n frames into rgb (n x h x w x 3); returns the count
// (0 at the end of the stream).
int tv_decode(void* h, int n, uint8_t* rgb) {
    return guarded([&] {
        Reader* r = static_cast<Reader*>(h);
        if (r->track.codec != "mjpeg" && r->track.codec != "mpeg4")
            throw Unsupported("codec " + r->track.codec);
        size_t frame = size_t(r->track.width) * r->track.height * 3;
        int got = 0;
        while (got < n && r->decode_one(rgb + frame * size_t(got))) got++;
        return got;
    });
}

int tv_seek(void* h, int64_t frame) {
    return guarded([&] {
        static_cast<Reader*>(h)->seek(size_t(std::max<int64_t>(0, frame)));
        return 0;
    });
}

// quality: the JPEG quality (1-100) or the MPEG-4 quantiser (1-31);
// options: the MPEG-4 encoder's (kMpeg4MpegQuant, kMpeg4DcInTcoef).
void* tv_writer_open(const char* path, int kind, int w, int h, int fps_num, int fps_den,
                     int quality, int options) {
    Writer* wr = nullptr;
    int rc = guarded([&] {
        if (kind < 0 || kind > 3) throw DecodeError("unknown writer kind");
        wr = new Writer(path, Kind(kind), w, h, fps_num, fps_den, quality, options);
        return 0;
    });
    return rc < 0 ? nullptr : wr;
}

int tv_writer_write(void* h, const uint8_t* rgb, int n) {
    return guarded([&] {
        Writer* w = static_cast<Writer*>(h);
        w->encode_and_add(rgb, n);
        return n;
    });
}

// Muxes an already-encoded packet (of the writer's codec).
int tv_writer_write_packet(void* h, const uint8_t* data, int size, int key) {
    return guarded([&] {
        static_cast<Writer*>(h)->add(std::vector<uint8_t>(data, data + size), key != 0);
        return 0;
    });
}

// Finishes the file (index, sizes) and frees the writer.
int tv_writer_close(void* h) {
    std::unique_ptr<Writer> w(static_cast<Writer*>(h));
    return guarded([&] {
        w->finish();
        return 0;
    });
}

// Frees a writer without finishing its file (after a failed write).
void tv_writer_abort(void* h) { delete static_cast<Writer*>(h); }

}  // extern "C"
