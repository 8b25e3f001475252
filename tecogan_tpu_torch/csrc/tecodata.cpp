// tecodata — native data-loader core for tecogan_tpu_torch.
//
// The port's copy of the JAX package's tecodata.cpp: the same C ABI, thread
// pool, frame cache, batch assembly and whole-sequence decode/encode, kept
// verbatim where it can be. Only the PNG codec differs. The original calls
// libpng; the GPU machine has no libpng (neither its headers nor the
// library), so this copy decodes and encodes PNG itself on zlib: it walks
// the chunks, inflates IDAT, undoes the five row filters (Adam7 interlacing
// included) and normalises every variant to 8-bit RGB as the original's
// libpng transforms do: 16-bit samples keep their high byte
// (png_set_strip_16), 1/2/4-bit gray is scaled to 8 bits, palettes expand
// to RGB, gray is spread to three channels and alpha dropped. The encoder
// writes 8-bit RGB with the original's settings: Sub rows, deflate level 1,
// Z_RLE.
//
// The reference's input pipeline runs on TensorFlow's C++ queue-runner
// threads (reference lib/dataloader.py:163-165,268-270 — PNG decode, crop
// and batch assembly all native under the TF graph). This library is the
// equivalent native substrate: GIL-free threaded PNG decode + crop/flip +
// float conversion, assembling training batches directly into a
// caller-provided buffer.
//
// It also serves streaming inference (reference main.py:253-270 reads and
// writes one PNG per frame on the python thread): td_decode_frames /
// td_encode_frames run whole frame sequences through the thread pool so
// host PNG I/O overlaps device compute instead of serializing after it.
//
// Augmentation *decisions* (window choice, movingFirstFrame offsets, flip)
// stay in Python so the RNG stream is identical to the pure-Python loader;
// this library executes the plan. C ABI for ctypes.
//
// Build: g++ -O3 -fPIC -std=c++17 -shared -o libtecodata.so tecodata.cpp -lz -pthread

#include <zlib.h>

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <list>
#include <memory>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <unordered_map>
#include <utility>
#include <vector>

namespace {

// ------------------------------------------------------------ PNG format
const uint8_t kSignature[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};

uint32_t be32(const uint8_t* p) {
  return (static_cast<uint32_t>(p[0]) << 24) |
         (static_cast<uint32_t>(p[1]) << 16) |
         (static_cast<uint32_t>(p[2]) << 8) | p[3];
}

void put_be32(uint8_t* p, uint32_t v) {
  p[0] = static_cast<uint8_t>(v >> 24);
  p[1] = static_cast<uint8_t>(v >> 16);
  p[2] = static_cast<uint8_t>(v >> 8);
  p[3] = static_cast<uint8_t>(v);
}

struct Header {
  uint32_t w = 0, h = 0;
  int depth = 0, color = 0, interlace = 0;
  int channels() const {  // samples per pixel in the file
    switch (color) {
      case 0: return 1;  // gray
      case 2: return 3;  // RGB
      case 3: return 1;  // palette index
      case 4: return 2;  // gray + alpha
      case 6: return 4;  // RGBA
    }
    return 0;
  }
  // Bytes of one filtered row of `pixels` pixels, filter byte excluded.
  size_t row_bytes(uint32_t pixels) const {
    return (static_cast<size_t>(pixels) * channels() * depth + 7) / 8;
  }
  // The filters' byte distance to "the pixel to the left" (at least 1).
  int filter_bpp() const {
    const int bits = channels() * depth;
    return bits >= 8 ? bits / 8 : 1;
  }
};

// Signature + IHDR (the first 33 bytes of the file); false unless it is a
// PNG of a colour type and bit depth the format allows.
bool parse_header(const uint8_t* d, size_t n, Header* hd) {
  if (n < 33 || std::memcmp(d, kSignature, 8) != 0 || be32(d + 8) != 13 ||
      std::memcmp(d + 12, "IHDR", 4) != 0)
    return false;
  if (be32(d + 29) != static_cast<uint32_t>(crc32(crc32(0L, Z_NULL, 0), d + 12, 17)))
    return false;
  hd->w = be32(d + 16);
  hd->h = be32(d + 20);
  hd->depth = d[24];
  hd->color = d[25];
  hd->interlace = d[28];
  if (hd->w == 0 || hd->h == 0 || hd->w > (1u << 24) || hd->h > (1u << 24) ||
      d[26] != 0 || d[27] != 0 || hd->interlace > 1)
    return false;
  switch (hd->color) {
    case 0: return hd->depth == 1 || hd->depth == 2 || hd->depth == 4 ||
                   hd->depth == 8 || hd->depth == 16;
    case 3: return hd->depth == 1 || hd->depth == 2 || hd->depth == 4 ||
                   hd->depth == 8;
    case 2: case 4: case 6: return hd->depth == 8 || hd->depth == 16;
  }
  return false;
}

bool read_file(const char* path, std::vector<uint8_t>* data) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return false;
  bool ok = fseek(fp, 0, SEEK_END) == 0;
  const long size = ok ? ftell(fp) : -1;
  ok = ok && size >= 0 && fseek(fp, 0, SEEK_SET) == 0;
  if (ok) {
    data->resize(static_cast<size_t>(size));
    ok = fread(data->data(), 1, data->size(), fp) == data->size();
  }
  fclose(fp);
  return ok;
}

// Adam7's passes: first column, first row, column step, row step.
const int kAdam7[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8}, {2, 0, 4, 4},
                          {0, 2, 2, 4}, {1, 0, 2, 2}, {0, 1, 1, 2}};

struct Pass {
  uint32_t x0, y0, dx, dy, w, h;
};

std::vector<Pass> passes(const Header& hd) {
  if (!hd.interlace) return {{0, 0, 1, 1, hd.w, hd.h}};
  std::vector<Pass> out;
  for (const auto& p : kAdam7) {
    const uint32_t x0 = p[0], y0 = p[1], dx = p[2], dy = p[3];
    const uint32_t w = hd.w > x0 ? (hd.w - x0 + dx - 1) / dx : 0;
    const uint32_t h = hd.h > y0 ? (hd.h - y0 + dy - 1) / dy : 0;
    if (w && h) out.push_back({x0, y0, dx, dy, w, h});  // empty passes hold no rows
  }
  return out;
}

// Undo one row's filter in place; `prev` is the reconstructed row above
// (zeros for a pass's first row). False on an unknown filter type.
bool unfilter(int kind, uint8_t* cur, const uint8_t* prev, size_t n, int bpp) {
  switch (kind) {
    case 0:
      return true;
    case 1:  // Sub
      for (size_t i = bpp; i < n; ++i) cur[i] = static_cast<uint8_t>(cur[i] + cur[i - bpp]);
      return true;
    case 2:  // Up
      for (size_t i = 0; i < n; ++i) cur[i] = static_cast<uint8_t>(cur[i] + prev[i]);
      return true;
    case 3:  // Average
      for (size_t i = 0; i < n; ++i) {
        const int left = i >= static_cast<size_t>(bpp) ? cur[i - bpp] : 0;
        cur[i] = static_cast<uint8_t>(cur[i] + ((left + prev[i]) >> 1));
      }
      return true;
    case 4:  // Paeth
      for (size_t i = 0; i < n; ++i) {
        const bool has_left = i >= static_cast<size_t>(bpp);
        const int a = has_left ? cur[i - bpp] : 0, b = prev[i];
        const int c = has_left ? prev[i - bpp] : 0;
        const int p = a + b - c;
        const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
        const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
        cur[i] = static_cast<uint8_t>(cur[i] + pred);
      }
      return true;
  }
  return false;
}

// Sample `i` of a reconstructed row as 8 bits: 16-bit samples keep their
// high byte; 1/2/4-bit samples are read big-endian within the byte (gray
// is scaled to 0..255 by the caller, palette indices are not).
inline int sample(const uint8_t* row, size_t i, int depth) {
  if (depth == 8) return row[i];
  if (depth == 16) return row[2 * i];
  const size_t bit = i * depth;
  const int shift = 8 - depth - static_cast<int>(bit & 7);
  return (row[bit >> 3] >> shift) & ((1 << depth) - 1);
}

// ----------------------------------------------------------------- decode
// Decode an 8-bit PNG to RGB; returns empty on failure.
struct Image {
  int h = 0, w = 0;
  std::vector<uint8_t> rgb;  // h*w*3
  bool ok() const { return h > 0; }
};

Image decode_png_rgb(const char* path) {
  std::vector<uint8_t> file;
  Header hd;
  if (!read_file(path, &file) || !parse_header(file.data(), file.size(), &hd)) return Image{};
  const std::vector<Pass> ps = passes(hd);
  size_t raw_size = 0;
  for (const Pass& p : ps) raw_size += static_cast<size_t>(p.h) * (1 + hd.row_bytes(p.w));
  std::vector<uint8_t> raw(raw_size);
  uint8_t palette[256 * 3] = {};  // indices past the palette read black

  // Walk the chunks after IHDR, inflating every IDAT into `raw`; a critical
  // chunk (upper-case first letter) must carry a correct CRC.
  z_stream zs{};
  if (inflateInit(&zs) != Z_OK) return Image{};
  zs.next_out = raw.data();
  zs.avail_out = static_cast<uInt>(raw.size());
  bool ok = true, ended = false, stream_end = false;
  size_t pos = 33;
  while (ok && !ended) {
    if (pos + 12 > file.size()) { ok = false; break; }
    const uint32_t len = be32(&file[pos]);
    const uint8_t* type = &file[pos + 4];
    if (len > file.size() - pos - 12) { ok = false; break; }
    const uint8_t* body = type + 4;
    if (!(type[0] & 0x20) &&
        be32(body + len) != static_cast<uint32_t>(crc32(crc32(0L, Z_NULL, 0), type, 4 + len))) {
      ok = false;
      break;
    }
    if (std::memcmp(type, "IDAT", 4) == 0) {
      if (!stream_end && zs.avail_out > 0 && len > 0) {
        zs.next_in = const_cast<Bytef*>(body);
        zs.avail_in = len;
        const int rc = inflate(&zs, Z_NO_FLUSH);  // Z_BUF_ERROR: no progress, not fatal
        if (rc == Z_STREAM_END) stream_end = true;
        else if (rc != Z_OK && rc != Z_BUF_ERROR) ok = false;
      }
    } else if (std::memcmp(type, "PLTE", 4) == 0) {
      if (len % 3 != 0 || len > sizeof(palette)) ok = false;
      else std::memcpy(palette, body, len);
    } else if (std::memcmp(type, "IEND", 4) == 0) {
      ended = true;
    }
    pos += 12 + static_cast<size_t>(len);
  }
  inflateEnd(&zs);
  if (!ok || zs.avail_out != 0) return Image{};  // too little image data

  Image img;
  img.h = static_cast<int>(hd.h);
  img.w = static_cast<int>(hd.w);
  img.rgb.resize(static_cast<size_t>(hd.h) * hd.w * 3);
  const int bpp = hd.filter_bpp();
  const int gray_scale = hd.depth < 8 ? 255 / ((1 << hd.depth) - 1) : 1;
  uint8_t* line = raw.data();
  for (const Pass& p : ps) {
    const size_t n = hd.row_bytes(p.w);
    std::vector<uint8_t> zeros(n, 0);
    const uint8_t* prev = zeros.data();
    for (uint32_t r = 0; r < p.h; ++r, line += n + 1) {
      uint8_t* cur = line + 1;
      if (!unfilter(line[0], cur, prev, n, bpp)) return Image{};
      prev = cur;
      uint8_t* dst = img.rgb.data() + (static_cast<size_t>(p.y0 + r * p.dy) * hd.w + p.x0) * 3;
      const size_t step = static_cast<size_t>(p.dx) * 3;
      if (hd.color == 2 && hd.depth == 8 && p.dx == 1) {  // the common case
        std::memcpy(dst, cur, n);
        continue;
      }
      const int c = hd.channels();
      for (uint32_t x = 0; x < p.w; ++x, dst += step) {
        const size_t s = static_cast<size_t>(x) * c;
        if (hd.color == 3) {
          const uint8_t* rgb = palette + 3 * sample(cur, s, hd.depth);
          dst[0] = rgb[0];
          dst[1] = rgb[1];
          dst[2] = rgb[2];
        } else if (hd.color == 0 || hd.color == 4) {  // gray (+ alpha, dropped)
          dst[0] = dst[1] = dst[2] = static_cast<uint8_t>(sample(cur, s, hd.depth) * gray_scale);
        } else {  // RGB, RGBA (alpha dropped)
          dst[0] = static_cast<uint8_t>(sample(cur, s, hd.depth));
          dst[1] = static_cast<uint8_t>(sample(cur, s + 1, hd.depth));
          dst[2] = static_cast<uint8_t>(sample(cur, s + 2, hd.depth));
        }
      }
    }
  }
  return img;
}

// ----------------------------------------------------------------- encode
// Write 8-bit RGB as a PNG. Settings swept on 576x720 video-like content
// (single core) for the JAX package's libpng encoder: level 1 + SUB filter
// + Z_RLE = 66 fps vs 23 fps for the libpng defaults, at SMALLER output
// (584 vs 659 KB). PNG is lossless at every setting, so pixel parity with
// the reference's cv2.imwrite holds.
bool write_chunk(FILE* fp, const char* type, const uint8_t* body, uint32_t len) {
  uint8_t head[8];
  put_be32(head, len);
  std::memcpy(head + 4, type, 4);
  uLong crc = crc32(crc32(0L, Z_NULL, 0), head + 4, 4);
  if (len) crc = crc32(crc, body, len);
  uint8_t tail[4];
  put_be32(tail, static_cast<uint32_t>(crc));
  return fwrite(head, 1, 8, fp) == 8 && (len == 0 || fwrite(body, 1, len, fp) == len) &&
         fwrite(tail, 1, 4, fp) == 4;
}

bool encode_png_rgb(const char* path, const uint8_t* rgb, int h, int w) {
  if (h <= 0 || w <= 0) return false;
  const size_t stride = static_cast<size_t>(w) * 3;
  std::vector<uint8_t> raw(static_cast<size_t>(h) * (stride + 1));
  for (int y = 0; y < h; ++y) {  // every row Sub-filtered
    const uint8_t* src = rgb + static_cast<size_t>(y) * stride;
    uint8_t* dst = raw.data() + static_cast<size_t>(y) * (stride + 1);
    dst[0] = 1;
    for (size_t i = 0; i < stride; ++i)
      dst[1 + i] = static_cast<uint8_t>(src[i] - (i >= 3 ? src[i - 3] : 0));
  }
  z_stream zs{};
  if (deflateInit2(&zs, 1, Z_DEFLATED, 15, 8, Z_RLE) != Z_OK) return false;
  std::vector<uint8_t> idat(deflateBound(&zs, raw.size()));
  zs.next_in = raw.data();
  zs.avail_in = static_cast<uInt>(raw.size());
  zs.next_out = idat.data();
  zs.avail_out = static_cast<uInt>(idat.size());
  const bool deflated = deflate(&zs, Z_FINISH) == Z_STREAM_END;
  const size_t idat_len = zs.total_out;
  deflateEnd(&zs);
  if (!deflated) return false;

  uint8_t ihdr[13];
  put_be32(ihdr, static_cast<uint32_t>(w));
  put_be32(ihdr + 4, static_cast<uint32_t>(h));
  ihdr[8] = 8;   // bit depth
  ihdr[9] = 2;   // RGB
  ihdr[10] = ihdr[11] = ihdr[12] = 0;  // deflate, adaptive filtering, no interlace
  FILE* fp = fopen(path, "wb");
  if (!fp) return false;
  bool ok = fwrite(kSignature, 1, 8, fp) == 8 && write_chunk(fp, "IHDR", ihdr, 13);
  for (size_t off = 0; ok && off < idat_len; off += 1u << 30)  // chunks under 2^31 bytes
    ok = write_chunk(fp, "IDAT", idat.data() + off,
                     static_cast<uint32_t>(std::min<size_t>(idat_len - off, 1u << 30)));
  ok = ok && write_chunk(fp, "IEND", nullptr, 0);
  return fclose(fp) == 0 && ok;
}

// ------------------------------------------------------------------- pool
class ThreadPool {
 public:
  explicit ThreadPool(int n) {
    for (int i = 0; i < n; ++i)
      workers_.emplace_back([this] { loop(); });
  }
  ~ThreadPool() {
    {
      std::unique_lock<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : workers_) t.join();
  }
  void submit(std::function<void()> fn) {
    {
      std::unique_lock<std::mutex> lk(mu_);
      q_.push(std::move(fn));
    }
    cv_.notify_one();
  }

 private:
  void loop() {
    for (;;) {
      std::function<void()> fn;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return stop_ || !q_.empty(); });
        if (stop_ && q_.empty()) return;
        fn = std::move(q_.front());
        q_.pop();
      }
      fn();
    }
  }
  std::mutex mu_;
  std::condition_variable cv_;
  std::queue<std::function<void()>> q_;
  std::vector<std::thread> workers_;
  bool stop_ = false;
};

// ------------------------------------------------------------- frame cache
// LRU cache of decoded frames, shared across the pool. Plays the role of
// the reference's loadHR_batch strategy (dataloader.py:53-167: decode a
// whole scene per queue element so overlapping RNN windows share decodes)
// — redesigned as a byte-budgeted cache instead of scene-granular queue
// elements: overlapping windows across the whole epoch share decodes, not
// just windows of one queue element. Decoded images are immutable and
// handed out as shared_ptr, so readers run lock-free after lookup.
class FrameCache {
 public:
  explicit FrameCache(size_t budget_bytes) : budget_(budget_bytes) {}

  bool enabled() const { return budget_ > 0; }

  std::shared_ptr<const Image> get_or_decode(const std::string& path) {
    if (!enabled()) {
      return std::make_shared<const Image>(decode_png_rgb(path.c_str()));
    }
    {
      std::lock_guard<std::mutex> lk(mu_);
      auto it = map_.find(path);
      if (it != map_.end()) {
        lru_.splice(lru_.begin(), lru_, it->second.second);
        return it->second.first;
      }
    }
    // Decode outside the lock (two threads may race on the same path; the
    // duplicate decode is rare and harmless — last insert wins).
    auto img = std::make_shared<const Image>(decode_png_rgb(path.c_str()));
    if (!img->ok()) return img;  // never cache failures
    const size_t bytes = img->rgb.size() + path.size() + 128;
    std::lock_guard<std::mutex> lk(mu_);
    auto it = map_.find(path);
    if (it != map_.end()) {  // raced: keep the existing entry
      lru_.splice(lru_.begin(), lru_, it->second.second);
      return it->second.first;
    }
    lru_.push_front(path);
    map_.emplace(path, std::make_pair(img, lru_.begin()));
    used_ += bytes;
    while (used_ > budget_ && !lru_.empty()) {
      const std::string& victim = lru_.back();
      auto vit = map_.find(victim);
      used_ -= vit->second.first->rgb.size() + victim.size() + 128;
      map_.erase(vit);
      lru_.pop_back();
    }
    return img;
  }

 private:
  size_t budget_, used_ = 0;
  std::mutex mu_;
  std::list<std::string> lru_;  // front = most recent
  std::unordered_map<
      std::string,
      std::pair<std::shared_ptr<const Image>, std::list<std::string>::iterator>>
      map_;
};

// One sequence task: decode rnn_n frames (path-deduped), crop tar x tar at
// per-frame offsets, optional horizontal flip, write normalized float32 RGB.
struct SeqTask {
  const char* const* paths;  // rnn_n entries
  const int32_t* oy;         // rnn_n offsets
  const int32_t* ox;
  int rnn_n, tar, flip;
  float* out = nullptr;      // rnn_n * tar * tar * 3 float [0,1], or
  uint8_t* out_u8 = nullptr;  // ... raw uint8 (cheap-upload training path)
  std::atomic<int>* err;
};

void run_sequence(const SeqTask& t, FrameCache& fc) {
  std::shared_ptr<const Image> cache;
  std::string cache_path;
  for (int f = 0; f < t.rnn_n; ++f) {
    if (cache_path != t.paths[f]) {  // local dedupe (movingFirstFrame repeats)
      cache = fc.get_or_decode(t.paths[f]);
      cache_path = t.paths[f];
    }
    if (!cache->ok() || t.oy[f] < 0 || t.ox[f] < 0 ||
        t.oy[f] + t.tar > cache->h || t.ox[f] + t.tar > cache->w) {
      t.err->fetch_add(1);
      return;
    }
    const size_t plane = static_cast<size_t>(f) * t.tar * t.tar * 3;
    for (int y = 0; y < t.tar; ++y) {
      const uint8_t* src =
          cache->rgb.data() +
          (static_cast<size_t>(t.oy[f] + y) * cache->w + t.ox[f]) * 3;
      const size_t roff = plane + static_cast<size_t>(y) * t.tar * 3;
      if (t.out_u8 != nullptr) {  // raw uint8 crops (device-side /255)
        uint8_t* row = t.out_u8 + roff;
        if (!t.flip) {
          std::memcpy(row, src, static_cast<size_t>(t.tar) * 3);
        } else {  // mirror columns (reference lib/ops.py:230-235)
          for (int x = 0; x < t.tar; ++x) {
            const uint8_t* px = src + (t.tar - 1 - x) * 3;
            row[x * 3 + 0] = px[0];
            row[x * 3 + 1] = px[1];
            row[x * 3 + 2] = px[2];
          }
        }
        continue;
      }
      float* row = t.out + roff;
      if (!t.flip) {
        for (int x = 0; x < t.tar * 3; ++x) row[x] = src[x] / 255.0f;
      } else {
        for (int x = 0; x < t.tar; ++x) {
          const uint8_t* px = src + (t.tar - 1 - x) * 3;
          row[x * 3 + 0] = px[0] / 255.0f;
          row[x * 3 + 1] = px[1] / 255.0f;
          row[x * 3 + 2] = px[2] / 255.0f;
        }
      }
    }
  }
}

struct Loader {
  Loader(int threads, size_t cache_bytes)
      : pool(threads), cache(cache_bytes) {}
  ThreadPool pool;
  FrameCache cache;
};

// Completion barrier for fanned-out pool work. notify_one runs while the
// mutex is held: the waiter can only observe the final count after
// acquiring the mutex — i.e. after the last worker's notify has already
// returned — so the stack-allocated WaitGroup can never be destroyed with
// a notify still pending (the unlocked-notify pattern had that race).
class WaitGroup {
 public:
  void done() {
    std::lock_guard<std::mutex> lk(mu_);
    ++done_;
    cv_.notify_one();
  }
  void wait(int n) {
    std::unique_lock<std::mutex> lk(mu_);
    cv_.wait(lk, [&] { return done_ == n; });
  }

 private:
  std::mutex mu_;
  std::condition_variable cv_;
  int done_ = 0;
};

}  // namespace

extern "C" {

void* td_open(int num_threads) { return new Loader(num_threads, 0); }

// Like td_open, with an LRU decoded-frame cache of ``cache_mb`` MB shared
// by the pool (0 = off) — the loadHR_batch decode-amortization analog.
void* td_open_cached(int num_threads, int cache_mb) {
  if (cache_mb < 0) cache_mb = 0;  // negative would wrap to ~2^64: unbounded
  return new Loader(num_threads, static_cast<size_t>(cache_mb) << 20);
}

void td_close(void* handle) { delete static_cast<Loader*>(handle); }

// Read only the PNG header; returns 0 on success with *h/*w filled. Lets
// callers allocate exactly h*w*3 before td_decode instead of a worst-case
// buffer.
int td_png_dims(const char* path, int* h, int* w) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return 1;
  uint8_t head[33];
  const size_t n = fread(head, 1, sizeof(head), fp);
  fclose(fp);
  Header hd;
  if (!parse_header(head, n, &hd)) return 1;
  *h = static_cast<int>(hd.h);
  *w = static_cast<int>(hd.w);
  return 0;
}

// Decode one PNG into caller buffer (float32 RGB [0,1]); returns h<<16|w
// via out params. Returns 0 on success.
int td_decode(const char* path, float* out, int* h, int* w, int cap) {
  Image img = decode_png_rgb(path);
  if (!img.ok()) return 1;
  if (img.h * img.w * 3 > cap) return 2;
  *h = img.h;
  *w = img.w;
  const size_t n = static_cast<size_t>(img.h) * img.w * 3;
  for (size_t i = 0; i < n; ++i) out[i] = img.rgb[i] / 255.0f;
  return 0;
}

// Load a full batch of sequences in parallel.
//   paths: n_seq * rnn_n C strings (frame files; repeats allowed)
//   oy/ox: n_seq * rnn_n crop offsets; flip: n_seq flags
//   out:   n_seq * rnn_n * tar * tar * 3 float32
// Returns number of failed sequences (0 = success).
static int load_batch_impl(void* handle, const char* const* paths,
                           const int32_t* oy, const int32_t* ox,
                           const int32_t* flip, int n_seq, int rnn_n,
                           int tar, float* out, uint8_t* out_u8) {
  Loader* loader = static_cast<Loader*>(handle);
  std::atomic<int> err{0};
  WaitGroup wg;
  for (int s = 0; s < n_seq; ++s) {
    SeqTask t;
    t.paths = paths + static_cast<size_t>(s) * rnn_n;
    t.oy = oy + static_cast<size_t>(s) * rnn_n;
    t.ox = ox + static_cast<size_t>(s) * rnn_n;
    t.rnn_n = rnn_n;
    t.tar = tar;
    t.flip = flip[s];
    const size_t off = static_cast<size_t>(s) * rnn_n * tar * tar * 3;
    t.out = out ? out + off : nullptr;
    t.out_u8 = out_u8 ? out_u8 + off : nullptr;
    t.err = &err;
    loader->pool.submit([t, loader, &wg] {
      run_sequence(t, loader->cache);
      wg.done();
    });
  }
  wg.wait(n_seq);
  return err.load();
}

int td_load_batch(void* handle, const char* const* paths, const int32_t* oy,
                  const int32_t* ox, const int32_t* flip, int n_seq,
                  int rnn_n, int tar, float* out) {
  return load_batch_impl(handle, paths, oy, ox, flip, n_seq, rnn_n, tar, out,
                         nullptr);
}

// As td_load_batch but emits raw uint8 crops — the cheap-upload training
// path (4x less host->device traffic; /255 happens on device,
// train/trainer.py:prepare_batch).
int td_load_batch_u8(void* handle, const char* const* paths,
                     const int32_t* oy, const int32_t* ox,
                     const int32_t* flip, int n_seq, int rnn_n, int tar,
                     uint8_t* out) {
  return load_batch_impl(handle, paths, oy, ox, flip, n_seq, rnn_n, tar,
                         nullptr, out);
}

// Shared fanout for td_decode_frames / td_decode_frames_u8 (exactly one
// of out / out_u8 is non-null).
static int decode_frames_impl(void* handle, const char* const* paths, int n,
                              int* h, int* w, float* out, uint8_t* out_u8,
                              int64_t cap) {
  if (n <= 0) return 0;
  if (td_png_dims(paths[0], h, w) != 0) return -1;
  const int64_t per = static_cast<int64_t>(*h) * *w * 3;
  if (per * n > cap) return -1;
  Loader* loader = static_cast<Loader*>(handle);
  std::atomic<int> err{0};
  WaitGroup wg;
  const int hh = *h, ww = *w;
  for (int i = 0; i < n; ++i) {
    const char* path = paths[i];
    float* dst = out ? out + per * i : nullptr;
    uint8_t* dst_u8 = out_u8 ? out_u8 + per * i : nullptr;
    loader->pool.submit([path, dst, dst_u8, hh, ww, &err, &wg] {
      Image img = decode_png_rgb(path);
      if (!img.ok() || img.h != hh || img.w != ww) {
        err.fetch_add(1);
      } else if (dst_u8 != nullptr) {
        std::memcpy(dst_u8, img.rgb.data(),
                    static_cast<size_t>(hh) * ww * 3);
      } else {
        const size_t m = static_cast<size_t>(hh) * ww * 3;
        for (size_t j = 0; j < m; ++j) dst[j] = img.rgb[j] / 255.0f;
      }
      wg.done();
    });
  }
  wg.wait(n);
  return err.load();
}

// Decode n same-geometry PNG frames in parallel into a contiguous
// (n, h, w, 3) float32 [0, 1] buffer (streaming-inference input,
// reference dataloader.py:11-50). h/w are taken from the first frame's
// header; frames with different geometry count as errors. ``cap`` is the
// caller buffer's float capacity. Returns the number of failed frames,
// or -1 when the header read / capacity check fails.
int td_decode_frames(void* handle, const char* const* paths, int n, int* h,
                     int* w, float* out, int64_t cap) {
  return decode_frames_impl(handle, paths, n, h, w, out, nullptr, cap);
}

// Same as td_decode_frames but writes raw uint8 RGB — the cheap-upload
// path (device-side /255) needs no float conversion, and the uint8 buffer
// is 4x smaller.
int td_decode_frames_u8(void* handle, const char* const* paths, int n, int* h,
                        int* w, uint8_t* out, int64_t cap) {
  return decode_frames_impl(handle, paths, n, h, w, nullptr, out, cap);
}

// Encode n uint8 RGB frames ((n, h, w, 3) contiguous) to PNG files in
// parallel (the reference's per-frame save loop, main.py:262-269).
// Returns the number of failed frames.
int td_encode_frames(void* handle, const char* const* paths,
                     const uint8_t* rgb, int n, int h, int w) {
  Loader* loader = static_cast<Loader*>(handle);
  std::atomic<int> err{0};
  WaitGroup wg;
  const size_t per = static_cast<size_t>(h) * w * 3;
  for (int i = 0; i < n; ++i) {
    const char* path = paths[i];
    const uint8_t* src = rgb + per * i;
    loader->pool.submit([path, src, h, w, &err, &wg] {
      if (!encode_png_rgb(path, src, h, w)) err.fetch_add(1);
      wg.done();
    });
  }
  wg.wait(n);
  return err.load();
}

}  // extern "C"
