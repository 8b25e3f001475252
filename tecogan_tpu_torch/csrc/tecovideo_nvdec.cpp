// libtecovideo_nvdec: H.264 and VP9 decoding on the card's NVDEC for
// tecogan_tpu_torch (bound by data/video_nvdec.py).
//
// It opens the NVIDIA driver's libnvcuvid.so.1 and libcuda.so.1 with
// dlopen, so it builds with the host C++ compiler alone (no CUDA headers):
//   g++ -O2 -fPIC -std=c++17 -shared tecovideo_nvdec.cpp -ldl
// It works in the primary context of the chosen device, the one PyTorch
// uses (cuDevicePrimaryCtxRetain), pushed and popped around every call, with
// one cuvidCtxLock per reader.
//
// The SDK's parser (cuvidCreateVideoParser) reads the packets and calls back:
// - sequence: checks what the decoder and tecogan_tpu_torch's NV12 kernel
//   take (8-bit 4:2:0, progressive; refused otherwise, naming the feature)
//   and creates the decoder at the coded size, NV12 output, with the
//   parser's min_num_decode_surfaces;
// - decode: cuvidDecodePicture on the parser's own CUVIDPICPARAMS, which
//   this file never looks inside;
// - display: queues the picture in display order.
// tvn_map maps the next queued picture (cuvidMapVideoFrame64, its copy
// queued on the caller's stream) for the NV12 kernel; tvn_unmap
// synchronises that stream and unmaps it.
//
// Each call returns < 0 on failure and leaves the message in
// tvn_last_error(), with tvn_last_error_kind(): 1 corrupt data or a decode
// error, 2 a feature not decoded, 3 a library that does not load, 4 a
// failed driver or NVDEC call, 5 NVDEC refusing to report its capabilities
// (cuvidGetDecoderCaps returning CUDA_ERROR_OUT_OF_MEMORY, as it does in a
// container that withholds NVIDIA's `video` capability).
#include <dlfcn.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstddef>
#include <deque>
#include <memory>
#include <mutex>
#include <stdexcept>
#include <string>

namespace {

// ---------------------------------------------------------------- types
// The CUDA toolkit ships no NVDEC headers, so the few types this file reads
// or fills are declared here, with the layout of the NVIDIA Video Codec
// SDK's headers (12.x; the fields used sit where they sat since 9.x). A
// wrong layout shows as an error or as wrong frames, which the test
// streams catch.

// cuda.h
typedef int CUresult;
typedef int CUdevice;
typedef struct CUctx_st* CUcontext;
typedef struct CUstream_st* CUstream;
typedef unsigned long long CUdeviceptr;

// cuviddec.h
typedef void* CUvideodecoder;
typedef struct _CUcontextlock_st* CUvideoctxlock;
struct CUVIDPICPARAMS;  // passed from the parser to the decoder untouched

enum cudaVideoCodec { kCodecH264 = 4, kCodecHEVC = 8, kCodecVP9 = 10, kCodecAV1 = 11 };
enum cudaVideoChromaFormat { kMonochrome = 0, k420 = 1, k422 = 2, k444 = 3 };
constexpr int kSurfaceNV12 = 0;           // cudaVideoSurfaceFormat_NV12
constexpr int kDeinterlaceWeave = 0;      // cudaVideoDeinterlaceMode_Weave
constexpr unsigned long kPreferCuvid = 4; // cudaVideoCreate_PreferCUVID
constexpr CUresult kOutOfMemory = 2;      // CUDA_ERROR_OUT_OF_MEMORY

// cuviddec.h: _CUVIDDECODECAPS
struct CUVIDDECODECAPS {
    int eCodecType;
    int eChromaFormat;
    unsigned int nBitDepthMinus8;
    unsigned int reserved1[3];
    unsigned char bIsSupported;
    unsigned char nNumNVDECs;
    unsigned short nOutputFormatMask;
    unsigned int nMaxWidth;
    unsigned int nMaxHeight;
    unsigned int nMaxMBCount;
    unsigned short nMinWidth;
    unsigned short nMinHeight;
    unsigned char bIsHistogramSupported;
    unsigned char nCounterBitDepth;
    unsigned short nMaxHistogramBins;
    unsigned int reserved3[10];
};

// cuviddec.h: _CUVIDDECODECREATEINFO
struct CUVIDDECODECREATEINFO {
    unsigned long ulWidth;
    unsigned long ulHeight;
    unsigned long ulNumDecodeSurfaces;
    int CodecType;
    int ChromaFormat;
    unsigned long ulCreationFlags;
    unsigned long bitDepthMinus8;
    unsigned long ulIntraDecodeOnly;
    unsigned long ulMaxWidth;
    unsigned long ulMaxHeight;
    unsigned long Reserved1;
    struct {
        short left, top, right, bottom;
    } display_area;
    int OutputFormat;
    int DeinterlaceMode;
    unsigned long ulTargetWidth;
    unsigned long ulTargetHeight;
    unsigned long ulNumOutputSurfaces;
    CUvideoctxlock vidLock;
    struct {
        short left, top, right, bottom;
    } target_rect;
    unsigned long enableHistogram;
    unsigned long Reserved2[4];
};

// cuviddec.h: _CUVIDPROCPARAMS
struct CUVIDPROCPARAMS {
    int progressive_frame;
    int second_field;
    int top_field_first;
    int unpaired_field;
    unsigned int reserved_flags;
    unsigned int reserved_zero;
    unsigned long long raw_input_dptr;
    unsigned int raw_input_pitch;
    unsigned int raw_input_format;
    unsigned long long raw_output_dptr;
    unsigned int raw_output_pitch;
    unsigned int Reserved1;
    CUstream output_stream;
    unsigned int Reserved[46];
    unsigned long long* histogram_dptr;
    void* Reserved2[1];
};

// cuviddec.h: _CUVIDGETDECODESTATUS
struct CUVIDGETDECODESTATUS {
    int decodeStatus;
    unsigned int reserved[31];
    void* pReserved[8];
};

// nvcuvid.h
typedef void* CUvideoparser;
typedef long long CUvideotimestamp;
constexpr unsigned long kPktEndOfStream = 0x01, kPktTimestamp = 0x02, kPktDiscontinuity = 0x04;

// nvcuvid.h: CUVIDEOFORMAT
struct CUVIDEOFORMAT {
    int codec;
    struct {
        unsigned int numerator, denominator;
    } frame_rate;
    unsigned char progressive_sequence;
    unsigned char bit_depth_luma_minus8;
    unsigned char bit_depth_chroma_minus8;
    unsigned char min_num_decode_surfaces;
    unsigned int coded_width;
    unsigned int coded_height;
    struct {
        int left, top, right, bottom;
    } display_area;
    int chroma_format;
    unsigned int bitrate;
    struct {
        int x, y;
    } display_aspect_ratio;
    struct {
        unsigned char video_format : 3;
        unsigned char video_full_range_flag : 1;
        unsigned char reserved_zero_bits : 4;
        unsigned char color_primaries;
        unsigned char transfer_characteristics;
        unsigned char matrix_coefficients;
    } video_signal_description;
    unsigned int seqhdr_data_length;
};

// nvcuvid.h: _CUVIDSOURCEDATAPACKET
struct CUVIDSOURCEDATAPACKET {
    unsigned long flags;
    unsigned long payload_size;
    const unsigned char* payload;
    CUvideotimestamp timestamp;
};

// nvcuvid.h: _CUVIDPARSERDISPINFO
struct CUVIDPARSERDISPINFO {
    int picture_index;
    int progressive_frame;
    int top_field_first;
    int repeat_first_field;
    CUvideotimestamp timestamp;
};

typedef int (*SequenceCallback)(void*, CUVIDEOFORMAT*);
typedef int (*DecodeCallback)(void*, CUVIDPICPARAMS*);
typedef int (*DisplayCallback)(void*, CUVIDPARSERDISPINFO*);

// nvcuvid.h: _CUVIDPARSERPARAMS
struct CUVIDPARSERPARAMS {
    int CodecType;
    unsigned int ulMaxNumDecodeSurfaces;
    unsigned int ulClockRate;
    unsigned int ulErrorThreshold;
    unsigned int ulMaxDisplayDelay;
    unsigned int bAnnexb : 1;
    unsigned int uReserved : 31;
    unsigned int uReserved1[4];
    void* pUserData;
    SequenceCallback pfnSequenceCallback;
    DecodeCallback pfnDecodePicture;
    DisplayCallback pfnDisplayPicture;
    void* pfnGetOperatingPoint;
    void* pfnGetSEIMsg;
    void* pvReserved2[5];
    void* pExtVideoInfo;
};

static_assert(sizeof(CUVIDEOFORMAT) == 64, "CUVIDEOFORMAT layout");
static_assert(sizeof(CUVIDPARSERPARAMS) == 136, "CUVIDPARSERPARAMS layout");
static_assert(sizeof(CUVIDDECODECREATEINFO) == 176, "CUVIDDECODECREATEINFO layout");
static_assert(offsetof(CUVIDPROCPARAMS, output_stream) == 56, "CUVIDPROCPARAMS layout");
static_assert(sizeof(CUVIDSOURCEDATAPACKET) == 32, "CUVIDSOURCEDATAPACKET layout");
static_assert(sizeof(CUVIDPARSERDISPINFO) == 24, "CUVIDPARSERDISPINFO layout");

// ---------------------------------------------------------------- errors
thread_local std::string g_error;
thread_local int g_error_kind = 0;

struct Failure : std::runtime_error {
    Failure(int kind, const std::string& msg) : std::runtime_error(msg), kind(kind) {}
    int kind;
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
    } catch (const Failure& e) {
        return fail(e.kind, e.what());
    } catch (const std::bad_alloc&) {
        return fail(4, "out of memory");
    } catch (const std::exception& e) {
        return fail(4, e.what());
    }
}

// ---------------------------------------------------------------- libraries
struct Api {
    CUresult (*cuInit)(unsigned int);
    CUresult (*cuDriverGetVersion)(int*);
    CUresult (*cuDeviceGet)(CUdevice*, int);
    CUresult (*cuDevicePrimaryCtxRetain)(CUcontext*, CUdevice);
    CUresult (*cuDevicePrimaryCtxRelease)(CUdevice);
    CUresult (*cuCtxPushCurrent)(CUcontext);
    CUresult (*cuCtxPopCurrent)(CUcontext*);
    CUresult (*cuStreamSynchronize)(CUstream);
    CUresult (*cuGetErrorString)(CUresult, const char**);
    CUresult (*cuvidGetDecoderCaps)(CUVIDDECODECAPS*);
    CUresult (*cuvidCreateDecoder)(CUvideodecoder*, CUVIDDECODECREATEINFO*);
    CUresult (*cuvidDestroyDecoder)(CUvideodecoder);
    CUresult (*cuvidDecodePicture)(CUvideodecoder, CUVIDPICPARAMS*);
    CUresult (*cuvidGetDecodeStatus)(CUvideodecoder, int, CUVIDGETDECODESTATUS*);
    CUresult (*cuvidMapVideoFrame64)(CUvideodecoder, int, unsigned long long*, unsigned int*,
                                     CUVIDPROCPARAMS*);
    CUresult (*cuvidUnmapVideoFrame64)(CUvideodecoder, unsigned long long);
    CUresult (*cuvidCtxLockCreate)(CUvideoctxlock*, CUcontext);
    CUresult (*cuvidCtxLockDestroy)(CUvideoctxlock);
    CUresult (*cuvidCreateVideoParser)(CUvideoparser*, CUVIDPARSERPARAMS*);
    CUresult (*cuvidParseVideoData)(CUvideoparser, CUVIDSOURCEDATAPACKET*);
    CUresult (*cuvidDestroyVideoParser)(CUvideoparser);
};

Api g_api;
std::once_flag g_once;
std::string g_load_error;

void* open_first(const char* const* names, std::string& err) {
    for (const char* const* n = names; *n; n++) {
        if (void* h = dlopen(*n, RTLD_NOW | RTLD_LOCAL)) return h;
        const char* e = dlerror();
        err += std::string(err.empty() ? "" : "; ") + (e ? e : *n);
    }
    return nullptr;
}

template <class T>
bool bind(void* lib, T& fn, const char* name, const char* fallback, std::string& err) {
    void* p = dlsym(lib, name);
    if (!p && fallback) p = dlsym(lib, fallback);
    if (!p) err += std::string(err.empty() ? "" : "; ") + "no symbol " + name;
    fn = reinterpret_cast<T>(p);
    return p != nullptr;
}

void load_libraries() {
    static const char* const cuda_names[] = {"libcuda.so.1", "libcuda.so", nullptr};
    static const char* const cuvid_names[] = {"libnvcuvid.so.1", "libnvcuvid.so", nullptr};
    std::string err;
    void* cuda = open_first(cuda_names, err);
    if (!cuda) {
        g_load_error = "libcuda.so.1 (the CUDA driver) could not be loaded: " + err;
        return;
    }
    void* cuvid = open_first(cuvid_names, err);
    if (!cuvid) {
        g_load_error = "libnvcuvid.so.1 (NVDEC, part of the NVIDIA driver) could not be "
                       "loaded: " + err;
        return;
    }
    Api& a = g_api;
    bool ok = bind(cuda, a.cuInit, "cuInit", nullptr, err) &
              bind(cuda, a.cuDriverGetVersion, "cuDriverGetVersion", nullptr, err) &
              bind(cuda, a.cuDeviceGet, "cuDeviceGet", nullptr, err) &
              bind(cuda, a.cuDevicePrimaryCtxRetain, "cuDevicePrimaryCtxRetain", nullptr, err) &
              bind(cuda, a.cuDevicePrimaryCtxRelease, "cuDevicePrimaryCtxRelease_v2",
                   "cuDevicePrimaryCtxRelease", err) &
              bind(cuda, a.cuCtxPushCurrent, "cuCtxPushCurrent_v2", "cuCtxPushCurrent", err) &
              bind(cuda, a.cuCtxPopCurrent, "cuCtxPopCurrent_v2", "cuCtxPopCurrent", err) &
              bind(cuda, a.cuStreamSynchronize, "cuStreamSynchronize", nullptr, err) &
              bind(cuda, a.cuGetErrorString, "cuGetErrorString", nullptr, err) &
              bind(cuvid, a.cuvidGetDecoderCaps, "cuvidGetDecoderCaps", nullptr, err) &
              bind(cuvid, a.cuvidCreateDecoder, "cuvidCreateDecoder", nullptr, err) &
              bind(cuvid, a.cuvidDestroyDecoder, "cuvidDestroyDecoder", nullptr, err) &
              bind(cuvid, a.cuvidDecodePicture, "cuvidDecodePicture", nullptr, err) &
              bind(cuvid, a.cuvidGetDecodeStatus, "cuvidGetDecodeStatus", nullptr, err) &
              bind(cuvid, a.cuvidMapVideoFrame64, "cuvidMapVideoFrame64", nullptr, err) &
              bind(cuvid, a.cuvidUnmapVideoFrame64, "cuvidUnmapVideoFrame64", nullptr, err) &
              bind(cuvid, a.cuvidCtxLockCreate, "cuvidCtxLockCreate", nullptr, err) &
              bind(cuvid, a.cuvidCtxLockDestroy, "cuvidCtxLockDestroy", nullptr, err) &
              bind(cuvid, a.cuvidCreateVideoParser, "cuvidCreateVideoParser", nullptr, err) &
              bind(cuvid, a.cuvidParseVideoData, "cuvidParseVideoData", nullptr, err) &
              bind(cuvid, a.cuvidDestroyVideoParser, "cuvidDestroyVideoParser", nullptr, err);
    if (!ok) {
        g_load_error = "the CUDA driver or libnvcuvid lacks an entry point: " + err;
        return;
    }
    if (CUresult rc = a.cuInit(0))
        g_load_error = "cuInit failed with CUresult " + std::to_string(rc);
}

const Api& api() {
    std::call_once(g_once, load_libraries);
    if (!g_load_error.empty()) throw Failure(3, g_load_error);
    return g_api;
}

void check(CUresult rc, const char* what) {
    if (!rc) return;
    const char* s = nullptr;
    if (g_api.cuGetErrorString) g_api.cuGetErrorString(rc, &s);
    throw Failure(4, std::string(what) + " failed: CUresult " + std::to_string(rc) + " (" +
                         (s ? s : "unknown") + ")");
}

// Makes `ctx` current for a scope.
class Pushed {
  public:
    explicit Pushed(CUcontext ctx) { check(api().cuCtxPushCurrent(ctx), "cuCtxPushCurrent"); }
    ~Pushed() {
        CUcontext popped;
        g_api.cuCtxPopCurrent(&popped);
    }
};

const char* chroma_name(int c) {
    return c == kMonochrome ? "4:0:0 (monochrome)"
           : c == k422      ? "4:2:2"
           : c == k444      ? "4:4:4"
                            : "4:2:0";
}

const char* codec_name(int c) {
    return c == kCodecH264 ? "H.264" : c == kCodecVP9 ? "VP9" : "codec";
}

// cuvidGetDecoderCaps for `codec` at 8-bit 4:2:0 in the current context;
// CUDA_ERROR_OUT_OF_MEMORY, NVDEC refusing to answer, fails with kind 5.
CUVIDDECODECAPS decoder_caps(int codec) {
    CUVIDDECODECAPS caps{};
    caps.eCodecType = codec;
    caps.eChromaFormat = k420;
    CUresult rc = api().cuvidGetDecoderCaps(&caps);
    if (rc == kOutOfMemory)
        throw Failure(5, "cuvidGetDecoderCaps failed: CUresult 2 (CUDA_ERROR_OUT_OF_MEMORY): "
                         "NVDEC creates no decoder on this device");
    check(rc, "cuvidGetDecoderCaps");
    return caps;
}

// ---------------------------------------------------------------- reader
struct Nvdec {
    int codec = 0;
    CUdevice device = 0;
    CUcontext ctx = nullptr;
    CUvideoctxlock lock = nullptr;
    CUvideoparser parser = nullptr;
    CUvideodecoder decoder = nullptr;
    CUVIDEOFORMAT format{};
    bool have_format = false;  // a sequence header was parsed
    unsigned surfaces = 0;
    std::deque<CUVIDPARSERDISPINFO> shown;  // display order
    unsigned long long mapped = 0;
    std::string error;  // from a callback, raised after the parse returns
    int error_kind = 0;

    int sequence(CUVIDEOFORMAT* f) {
        const char* what = codec_name(codec);
        if (f->chroma_format != k420)
            throw Failure(2, std::string(what) + " in " + chroma_name(f->chroma_format) +
                                 " is not decoded (NVDEC and the NV12 kernel take 4:2:0)");
        if (f->bit_depth_luma_minus8 || f->bit_depth_chroma_minus8)
            throw Failure(2, std::string(what) + " at " +
                                 std::to_string(8 + f->bit_depth_luma_minus8) +
                                 " bits is not decoded (the NV12 kernel takes 8-bit samples)");
        if (!f->progressive_sequence)
            throw Failure(2, std::string(what) + " with field or MBAFF (interlaced) coding "
                                                 "is not decoded");
        if (decoder) {
            if (f->coded_width != format.coded_width || f->coded_height != format.coded_height)
                throw Failure(2, std::string(what) + ": a change of the coded size within a "
                                                     "stream is not decoded");
            format = *f;
            return int(surfaces);
        }
        // Kept before NVDEC is asked, so that tvn_format reports the parsed
        // sequence header even where no decoder can be created.
        format = *f;
        have_format = true;
        CUVIDDECODECAPS caps = decoder_caps(codec);
        if (!caps.bIsSupported)
            throw Failure(2, std::string(what) + " 8-bit 4:2:0 is not supported by this card's "
                                                 "NVDEC");
        if (f->coded_width > caps.nMaxWidth || f->coded_height > caps.nMaxHeight ||
            f->coded_width < caps.nMinWidth || f->coded_height < caps.nMinHeight)
            throw Failure(2, std::string(what) + " at " + std::to_string(f->coded_width) + "x" +
                                 std::to_string(f->coded_height) + " is outside NVDEC's " +
                                 std::to_string(caps.nMinWidth) + "x" +
                                 std::to_string(caps.nMinHeight) + " to " +
                                 std::to_string(caps.nMaxWidth) + "x" +
                                 std::to_string(caps.nMaxHeight));
        surfaces = f->min_num_decode_surfaces ? f->min_num_decode_surfaces : 8;
        CUVIDDECODECREATEINFO ci{};
        ci.ulWidth = ci.ulMaxWidth = ci.ulTargetWidth = f->coded_width;
        ci.ulHeight = ci.ulMaxHeight = ci.ulTargetHeight = f->coded_height;
        ci.ulNumDecodeSurfaces = surfaces;
        ci.CodecType = codec;
        ci.ChromaFormat = k420;
        ci.ulCreationFlags = kPreferCuvid;
        ci.display_area = {0, 0, short(f->coded_width), short(f->coded_height)};
        ci.OutputFormat = kSurfaceNV12;
        ci.DeinterlaceMode = kDeinterlaceWeave;
        ci.ulNumOutputSurfaces = 1;
        ci.vidLock = lock;
        check(api().cuvidCreateDecoder(&decoder, &ci), "cuvidCreateDecoder");
        return int(surfaces);
    }

    void create_parser() {
        CUVIDPARSERPARAMS p{};
        p.CodecType = codec;
        p.ulMaxNumDecodeSurfaces = 1;  // the sequence callback returns the count
        p.ulMaxDisplayDelay = 0;
        p.pUserData = this;
        p.pfnSequenceCallback = [](void* u, CUVIDEOFORMAT* f) {
            Nvdec* d = static_cast<Nvdec*>(u);
            return d->callback([&] { return d->sequence(f); });
        };
        p.pfnDecodePicture = [](void* u, CUVIDPICPARAMS* pic) {
            Nvdec* d = static_cast<Nvdec*>(u);
            return d->callback([&] {
                if (!d->decoder) throw Failure(1, "a picture before the sequence header");
                check(api().cuvidDecodePicture(d->decoder, pic), "cuvidDecodePicture");
                return 1;
            });
        };
        p.pfnDisplayPicture = [](void* u, CUVIDPARSERDISPINFO* info) {
            if (info) static_cast<Nvdec*>(u)->shown.push_back(*info);
            return 1;
        };
        check(api().cuvidCreateVideoParser(&parser, &p), "cuvidCreateVideoParser");
    }

    // A callback's failure stops the parse (0) and is raised after it.
    template <class F>
    int callback(F&& f) {
        if (error_kind) return 0;
        try {
            return f();
        } catch (const Failure& e) {
            error = e.what();
            error_kind = e.kind;
        } catch (const std::exception& e) {
            error = e.what();
            error_kind = 4;
        }
        return 0;
    }

    void raise_deferred() {
        if (error_kind) throw Failure(error_kind, error);
    }

    void unmap() {
        if (mapped) {
            unsigned long long p = mapped;
            mapped = 0;
            check(api().cuvidUnmapVideoFrame64(decoder, p), "cuvidUnmapVideoFrame64");
        }
    }

    ~Nvdec() {
        if (!ctx) return;
        g_api.cuCtxPushCurrent(ctx);
        if (mapped) g_api.cuvidUnmapVideoFrame64(decoder, mapped);
        if (parser) g_api.cuvidDestroyVideoParser(parser);
        if (decoder) g_api.cuvidDestroyDecoder(decoder);
        if (lock) g_api.cuvidCtxLockDestroy(lock);
        CUcontext popped;
        g_api.cuCtxPopCurrent(&popped);
        g_api.cuDevicePrimaryCtxRelease(device);
    }
};

}  // namespace

extern "C" {

const char* tvn_last_error() { return g_error.c_str(); }
int tvn_last_error_kind() { return g_error_kind; }

// Loads the NVIDIA driver's libraries; 0, or < 0 with the error (kind 3).
int tvn_load() {
    return guarded([] {
        api();
        return 0;
    });
}

int tvn_driver_version() {
    int v = 0;
    if (tvn_load() < 0) return -3;
    g_api.cuDriverGetVersion(&v);
    return v;
}

// NVDEC's capabilities for `codec` (cudaVideoCodec) at 8-bit 4:2:0 on
// device `ordinal`: supported, NVDEC count, min and max coded size, max
// macroblocks.
int tvn_caps(int codec, int ordinal, int* out) {
    return guarded([&] {
        const Api& a = api();
        CUdevice dev;
        check(a.cuDeviceGet(&dev, ordinal), "cuDeviceGet");
        CUcontext ctx;
        check(a.cuDevicePrimaryCtxRetain(&ctx, dev), "cuDevicePrimaryCtxRetain");
        struct Released {  // the primary context, after the query or its failure
            const Api& a;
            CUdevice dev;
            ~Released() { a.cuDevicePrimaryCtxRelease(dev); }
        } released{a, dev};
        CUVIDDECODECAPS caps;
        {
            Pushed p(ctx);
            caps = decoder_caps(codec);
        }
        int v[7] = {caps.bIsSupported, caps.nNumNVDECs, caps.nMinWidth, caps.nMinHeight,
                    int(caps.nMaxWidth), int(caps.nMaxHeight), int(caps.nMaxMBCount)};
        std::memcpy(out, v, sizeof v);
        return 0;
    });
}

// A reader of `codec` (cudaVideoCodec: 4 H.264, 10 VP9) on device `ordinal`.
void* tvn_open(int codec, int ordinal) {
    Nvdec* d = nullptr;
    int rc = guarded([&] {
        if (codec != kCodecH264 && codec != kCodecVP9)
            throw Failure(2, "NVDEC route for codec " + std::to_string(codec));
        const Api& a = api();
        std::unique_ptr<Nvdec> n(new Nvdec);
        n->codec = codec;
        check(a.cuDeviceGet(&n->device, ordinal), "cuDeviceGet");
        CUcontext ctx;
        check(a.cuDevicePrimaryCtxRetain(&ctx, n->device), "cuDevicePrimaryCtxRetain");
        n->ctx = ctx;
        Pushed p(n->ctx);
        check(a.cuvidCtxLockCreate(&n->lock, n->ctx), "cuvidCtxLockCreate");
        n->create_parser();
        d = n.release();
        return 0;
    });
    return rc < 0 ? nullptr : d;
}

void tvn_close(void* h) { delete static_cast<Nvdec*>(h); }

// Parses one packet (flags: 1 end of stream, 2 a discontinuity after a
// seek) with `timestamp` carried to its picture; returns the count of
// pictures waiting in display order.
int tvn_feed(void* h, const uint8_t* data, int size, int64_t timestamp, int flags) {
    return guarded([&] {
        Nvdec* d = static_cast<Nvdec*>(h);
        d->raise_deferred();
        CUVIDSOURCEDATAPACKET pkt{};
        pkt.payload = data;
        pkt.payload_size = (unsigned long)(size);
        pkt.timestamp = timestamp;
        pkt.flags = kPktTimestamp | ((flags & 1) ? kPktEndOfStream : 0) |
                    ((flags & 2) ? kPktDiscontinuity : 0);
        Pushed p(d->ctx);
        check(api().cuvidParseVideoData(d->parser, &pkt), "cuvidParseVideoData");
        d->raise_deferred();
        return int(d->shown.size());
    });
}

// The stream's format once the sequence header is parsed (else 0 is
// returned and nothing is written), also where the decoder was then
// refused: coded width and height, the display area's left, top, right and
// bottom, and the parser's video_full_range_flag and matrix_coefficients.
int tvn_format(void* h, int* out) {
    Nvdec* d = static_cast<Nvdec*>(h);
    if (!d->have_format) return 0;
    const CUVIDEOFORMAT& f = d->format;
    int v[8] = {int(f.coded_width), int(f.coded_height), f.display_area.left,
                f.display_area.top, f.display_area.right, f.display_area.bottom,
                f.video_signal_description.video_full_range_flag,
                f.video_signal_description.matrix_coefficients};
    std::memcpy(out, v, sizeof v);
    return 1;
}

// Maps the next picture in display order for a kernel on `stream` (the
// NV12 copy is queued there): its device pointer, pitch, timestamp and
// decode status (cuvidGetDecodeStatus: 1 in progress, 2 success, 8 an
// error, 9 an error concealed; a failed query fails the call). Returns 1,
// or 0 when no picture waits.
int tvn_map(void* h, void* stream, uint64_t* ptr, unsigned* pitch, int64_t* timestamp,
            int* status) {
    return guarded([&] {
        Nvdec* d = static_cast<Nvdec*>(h);
        if (d->mapped) throw Failure(4, "a picture is mapped already");
        if (d->shown.empty()) return 0;
        CUVIDPARSERDISPINFO info = d->shown.front();
        d->shown.pop_front();
        Pushed p(d->ctx);
        CUVIDGETDECODESTATUS st{};
        check(api().cuvidGetDecodeStatus(d->decoder, info.picture_index, &st),
              "cuvidGetDecodeStatus");
        *status = st.decodeStatus;
        CUVIDPROCPARAMS vpp{};
        vpp.progressive_frame = info.progressive_frame;
        vpp.top_field_first = info.top_field_first;
        vpp.unpaired_field = info.repeat_first_field < 0;
        vpp.output_stream = static_cast<CUstream>(stream);
        unsigned long long dptr = 0;
        unsigned int p_ = 0;
        check(api().cuvidMapVideoFrame64(d->decoder, info.picture_index, &dptr, &p_, &vpp),
              "cuvidMapVideoFrame64");
        d->mapped = dptr;
        *ptr = dptr;
        *pitch = p_;
        *timestamp = info.timestamp;
        return 1;
    });
}

// Waits for `stream` (the kernel that read the mapped picture) and unmaps it.
int tvn_unmap(void* h, void* stream) {
    return guarded([&] {
        Nvdec* d = static_cast<Nvdec*>(h);
        if (!d->mapped) return 0;
        Pushed p(d->ctx);
        CUresult rc = api().cuStreamSynchronize(static_cast<CUstream>(stream));
        d->unmap();
        check(rc, "cuStreamSynchronize");
        return 0;
    });
}

// Forgets the parser's state (before decoding from a key packet after a
// seek): a new parser; the pictures waiting are dropped, the decoder stays.
int tvn_reset(void* h) {
    return guarded([&] {
        Nvdec* d = static_cast<Nvdec*>(h);
        Pushed p(d->ctx);
        d->unmap();
        d->shown.clear();
        d->error.clear();
        d->error_kind = 0;
        if (d->parser) {
            CUvideoparser old = d->parser;
            d->parser = nullptr;
            check(api().cuvidDestroyVideoParser(old), "cuvidDestroyVideoParser");
        }
        d->create_parser();
        return 0;
    });
}

}  // extern "C"
