// tecozstd — a Zstandard decoder (RFC 8878) for tecogan_tpu_torch.
//
// The JAX package's orbax checkpoints store every B-tree node of their
// OCDBT key-value store, and every zarr chunk, as zstd frames. The GPU
// machine has no zstd library, no tensorstore and no numcodecs, and
// Python 3.12's standard library has no zstd, so the port decodes the
// format itself (train/orbax_io.py reads the store through it).
//
// What it decodes: frames with or without the single-segment flag, a
// window descriptor, a frame content size of 0/1/2/4/8 bytes, the optional
// XXH64 content checksum (checked); Raw, RLE and Compressed blocks;
// literals Raw, RLE, Compressed and Treeless with 1 or 4 Huffman streams;
// sequences with Predefined, RLE, FSE-compressed and Repeat tables; the
// three repeat offsets; concatenated and skippable frames. A dictionary
// id other than 0 is refused. Every error is a message, never a crash:
// the decoder checks each read against its buffer.
//
// C ABI for ctypes (utils/zstd.py):
//   int tz_decompress(src, n, &out, &out_len)  0 on success, else -1 and
//                                              tz_last_error() says why;
//                                              free `out` with tz_free.
//
// Build: g++ -O3 -fPIC -std=c++17 -shared -o libtecozstd.so tecozstd.cpp

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Corrupt : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& what) { throw Corrupt(what); }

inline int highbit(uint32_t v) {  // index of the highest set bit, v > 0
  return 31 - __builtin_clz(v);
}

uint32_t le32(const uint8_t* p) {
  return uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16 | uint32_t(p[3]) << 24;
}

uint64_t le64(const uint8_t* p) { return uint64_t(le32(p)) | uint64_t(le32(p + 4)) << 32; }

// ------------------------------------------------------------------ XXH64
constexpr uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL,
                   P3 = 1609587929392839161ULL, P4 = 9650029242287828579ULL,
                   P5 = 2870177450012600261ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t round64(uint64_t acc, uint64_t v) { return rotl(acc + v * P2, 31) * P1; }
inline uint64_t merge64(uint64_t acc, uint64_t v) { return (acc ^ round64(0, v)) * P1 + P4; }

uint64_t xxh64(const uint8_t* p, size_t n) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    for (; p + 32 <= end; p += 32) {
      v1 = round64(v1, le64(p));
      v2 = round64(v2, le64(p + 8));
      v3 = round64(v3, le64(p + 16));
      v4 = round64(v4, le64(p + 24));
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = merge64(merge64(merge64(merge64(h, v1), v2), v3), v4);
  } else {
    h = P5;
  }
  h += n;
  for (; p + 8 <= end; p += 8) h = rotl(h ^ round64(0, le64(p)), 27) * P1 + P4;
  if (p + 4 <= end) {
    h = rotl(h ^ (uint64_t(le32(p)) * P1), 23) * P2 + P3;
    p += 4;
  }
  for (; p < end; ++p) h = rotl(h ^ (*p * P5), 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ------------------------------------------------------------ bit readers
// Forward little-endian bits (FSE table descriptions).
struct ForwardBits {
  const uint8_t* p;
  size_t n;
  size_t pos = 0;  // in bits
  ForwardBits(const uint8_t* p_, size_t n_) : p(p_), n(n_) {}
  uint32_t peek(int bits) const {
    uint64_t v = 0;
    size_t byte = pos >> 3;
    for (int i = 0; i < 5 && byte + i < n; ++i) v |= uint64_t(p[byte + i]) << (8 * i);
    return uint32_t((v >> (pos & 7)) & ((1ULL << bits) - 1));
  }
  void skip(int bits) {
    pos += bits;
    if (pos > 8 * n) fail("FSE table description runs past its block");
  }
  uint32_t read(int bits) {
    uint32_t v = peek(bits);
    skip(bits);
    return v;
  }
  size_t bytes_used() const { return (pos + 7) >> 3; }
};

// Backward bits: a stream ends in a byte whose highest set bit marks its
// end; reading goes from there toward the first byte. Bits read from
// before the first byte are zeros and drive `offset` below 0, which the
// callers use to detect the stream's end.
struct BackwardBits {
  const uint8_t* p;
  int64_t offset;  // bits not read yet
  BackwardBits(const uint8_t* p_, size_t n) : p(p_) {
    if (n == 0) fail("empty bitstream");
    uint8_t last = p[n - 1];
    if (last == 0) fail("bitstream's last byte has no end marker");
    offset = int64_t(8 * (n - 1)) + highbit(last);
  }
  uint64_t read(int bits) {
    if (bits == 0) return 0;
    offset -= bits;
    int64_t off = offset;
    int actual = bits;
    if (off < 0) {
      actual += int(off);
      off = 0;
      if (actual <= 0) return 0;
    }
    size_t byte = size_t(off) >> 3;
    int shift = int(off & 7);
    uint64_t v = 0;
    int need = (shift + actual + 7) >> 3;  // at most 8 bytes for <= 57 bits
    for (int i = 0; i < need; ++i) v |= uint64_t(p[byte + i]) << (8 * i);
    v = (v >> shift) & ((actual == 64) ? ~0ULL : ((1ULL << actual) - 1));
    if (offset < 0) v <<= -offset;
    return v;
  }
};

// -------------------------------------------------------------------- FSE
struct FseEntry {
  uint8_t symbol;
  uint8_t bits;
  uint16_t base;
};

struct FseTable {
  std::vector<FseEntry> t;
  int log = 0;
  bool ready = false;
};

void build_fse(FseTable& table, const int16_t* norm, int nsym, int log) {
  const uint32_t size = 1u << log;
  table.t.assign(size, FseEntry{0, 0, 0});
  table.log = log;
  std::vector<uint16_t> next(nsym);
  uint32_t high = size - 1;
  for (int s = 0; s < nsym; ++s) {
    if (norm[s] == -1) {
      table.t[high--].symbol = uint8_t(s);
      next[s] = 1;
    } else {
      next[s] = uint16_t(norm[s] > 0 ? norm[s] : 0);
    }
  }
  const uint32_t step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  uint32_t pos = 0;
  for (int s = 0; s < nsym; ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      table.t[pos].symbol = uint8_t(s);
      do pos = (pos + step) & mask;
      while (pos > high);
    }
  }
  if (pos != 0) fail("FSE distribution does not fill its table");
  for (uint32_t u = 0; u < size; ++u) {
    uint8_t s = table.t[u].symbol;
    uint32_t state = next[s]++;
    int bits = log - highbit(state);
    table.t[u].bits = uint8_t(bits);
    table.t[u].base = uint16_t((state << bits) - size);
  }
  table.ready = true;
}

// Reads an FSE table description; returns the bytes it took.
size_t read_fse_description(FseTable& table, const uint8_t* p, size_t n, int max_log,
                            int max_symbols) {
  ForwardBits in(p, n);
  if (n == 0) fail("missing FSE table description");
  int log = int(in.read(4)) + 5;
  if (log > max_log) fail("FSE accuracy log " + std::to_string(log) + " above its maximum");
  int32_t remaining = 1 << log;
  std::vector<int16_t> norm;
  while (remaining > 0) {
    if (int(norm.size()) >= max_symbols) fail("FSE table description has too many symbols");
    int bits = highbit(uint32_t(remaining + 1)) + 1;
    uint32_t val = in.peek(bits);
    uint32_t lower = (1u << (bits - 1)) - 1;
    uint32_t threshold = (1u << bits) - 1 - uint32_t(remaining + 1);
    if ((val & lower) < threshold) {
      in.skip(bits - 1);
      val &= lower;
    } else {
      in.skip(bits);
      if (val > lower) val -= threshold;
    }
    int proba = int(val) - 1;
    remaining -= proba < 0 ? -proba : proba;
    norm.push_back(int16_t(proba));
    if (proba == 0) {
      uint32_t repeat = in.read(2);
      for (;;) {
        for (uint32_t i = 0; i < repeat; ++i) {
          if (int(norm.size()) >= max_symbols) fail("FSE zero run past the last symbol");
          norm.push_back(0);
        }
        if (repeat != 3) break;
        repeat = in.read(2);
      }
    }
  }
  if (remaining != 0) fail("FSE probabilities do not sum to the table size");
  build_fse(table, norm.data(), int(norm.size()), log);
  return in.bytes_used();
}

void build_rle(FseTable& table, uint8_t symbol) {
  table.t.assign(1, FseEntry{symbol, 0, 0});
  table.log = 0;
  table.ready = true;
}

struct FseState {
  const FseTable* table;
  uint32_t state;
  void init(const FseTable& t, BackwardBits& in) {
    table = &t;
    state = uint32_t(in.read(t.log));
  }
  uint8_t symbol() const { return table->t[state].symbol; }
  void update(BackwardBits& in) {
    const FseEntry& e = table->t[state];
    state = e.base + uint32_t(in.read(e.bits));
  }
};

// ---------------------------------------------------------------- Huffman
struct HufTable {
  std::vector<uint8_t> symbol, bits;
  int max_bits = 0;
  bool ready = false;
};

// Weights of the symbols but the last, whose weight is implied.
void build_huffman(HufTable& table, std::vector<uint8_t> weights) {
  if (weights.empty() || weights.size() > 255) fail("Huffman weight count out of range");
  uint32_t total = 0;
  for (uint8_t w : weights) {
    if (w > 11) fail("Huffman weight above 11");
    if (w) total += 1u << (w - 1);
  }
  if (total == 0) fail("Huffman weights are all zero");
  int max_bits = highbit(total) + 1;
  if (max_bits > 11) fail("Huffman code longer than 11 bits");
  uint32_t left = (1u << max_bits) - total;
  if (left & (left - 1)) fail("Huffman weights do not complete a power of two");
  weights.push_back(uint8_t(highbit(left) + 1));
  const int nsym = int(weights.size());
  const uint32_t size = 1u << max_bits;
  table.symbol.assign(size, 0);
  table.bits.assign(size, 0);
  table.max_bits = max_bits;
  std::vector<uint32_t> count(max_bits + 2, 0), start(max_bits + 2, 0);
  for (int s = 0; s < nsym; ++s)
    if (weights[s]) ++count[max_bits + 1 - weights[s]];
  // Longest codes take the lowest table positions.
  uint32_t idx = 0;
  for (int b = max_bits; b >= 1; --b) {
    start[b] = idx;
    idx += count[b] << (max_bits - b);
  }
  if (idx != size) fail("Huffman codes do not fill their table");
  for (int s = 0; s < nsym; ++s) {
    if (!weights[s]) continue;
    int b = max_bits + 1 - weights[s];
    uint32_t len = 1u << (max_bits - b);
    std::memset(&table.symbol[start[b]], s, len);
    std::memset(&table.bits[start[b]], b, len);
    start[b] += len;
  }
  table.ready = true;
}

// Reads a Huffman tree description; returns the bytes it took.
size_t read_huffman_description(HufTable& table, const uint8_t* p, size_t n) {
  if (n == 0) fail("missing Huffman tree description");
  uint8_t header = p[0];
  std::vector<uint8_t> weights;
  size_t used;
  if (header >= 128) {
    size_t count = header - 127;
    used = 1 + (count + 1) / 2;
    if (used > n) fail("Huffman weights run past the literals section");
    for (size_t i = 0; i < count; ++i) {
      uint8_t b = p[1 + i / 2];
      weights.push_back(i % 2 == 0 ? b >> 4 : b & 15);
    }
  } else {
    used = 1 + size_t(header);
    if (used > n) fail("Huffman weights run past the literals section");
    FseTable fse;
    size_t desc = read_fse_description(fse, p + 1, header, 6, 256);
    if (desc >= header) fail("Huffman weight stream is empty");
    BackwardBits in(p + 1 + desc, header - desc);
    FseState s1, s2;
    s1.init(fse, in);
    s2.init(fse, in);
    for (;;) {
      if (weights.size() >= 255) fail("too many Huffman weights");
      weights.push_back(s1.symbol());
      s1.update(in);
      if (in.offset < 0) {
        weights.push_back(s2.symbol());
        break;
      }
      if (weights.size() >= 255) fail("too many Huffman weights");
      weights.push_back(s2.symbol());
      s2.update(in);
      if (in.offset < 0) {
        weights.push_back(s1.symbol());
        break;
      }
    }
  }
  build_huffman(table, std::move(weights));
  return used;
}

void decode_huffman_stream(const HufTable& table, const uint8_t* p, size_t n, uint8_t* out,
                           size_t count) {
  BackwardBits in(p, n);
  const int max_bits = table.max_bits;
  const uint32_t mask = (1u << max_bits) - 1;
  uint32_t state = uint32_t(in.read(max_bits));
  for (size_t i = 0; i < count; ++i) {
    out[i] = table.symbol[state];
    int b = table.bits[state];
    state = ((state << b) | uint32_t(in.read(b))) & mask;
  }
  if (in.offset != -max_bits) fail("Huffman stream not consumed exactly");
}

// -------------------------------------------------------------- sequences
const uint32_t kLLBase[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
                              12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  1,  1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {3,   4,   5,    6,    7,    8,    9,    10,    11,    12,   13,
                              14,  15,  16,   17,   18,   19,   20,   21,    22,    23,   24,
                              25,  26,  27,   28,   29,   30,   31,   32,    33,    34,   35,
                              37,  39,  41,   43,   47,   51,   59,   67,    83,    99,   131,
                              259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1,  1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1,  1,  2,  2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1,  1,  1,  1,  1,  1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,  1,  1,  1,  1,  1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1,  1,  1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

// State a frame carries from block to block.
struct FrameState {
  HufTable huffman;
  FseTable ll, of, ml;
  uint64_t rep[3] = {1, 4, 8};
};

// Reads one table per its mode; returns the bytes it took.
size_t read_table(FseTable& table, int mode, const uint8_t* p, size_t n, const int16_t* defaults,
                  int default_count, int default_log, int max_log, int max_symbol,
                  const char* name) {
  switch (mode) {
    case 0:
      build_fse(table, defaults, default_count, default_log);
      return 0;
    case 1:
      if (n < 1) fail(std::string(name) + " RLE symbol missing");
      if (p[0] > max_symbol) fail(std::string(name) + " RLE symbol out of range");
      build_rle(table, p[0]);
      return 1;
    case 2:
      return read_fse_description(table, p, n, max_log, max_symbol + 1);
    default:
      if (!table.ready) fail(std::string(name) + " repeat mode with no previous table");
      return 0;
  }
}

void decode_block(FrameState& fs, const uint8_t* p, size_t n, std::vector<uint8_t>& out,
                  size_t frame_start, size_t max_block) {
  // ---- literals section
  if (n < 1) fail("empty compressed block");
  const int ltype = p[0] & 3, sf = (p[0] >> 2) & 3;
  size_t regen = 0, comp = 0, hdr = 0;
  int streams = 1;
  if (ltype <= 1) {
    if (sf == 0 || sf == 2) {
      hdr = 1;
      regen = p[0] >> 3;
    } else if (sf == 1) {
      hdr = 2;
      if (n < 2) fail("truncated literals header");
      regen = (p[0] >> 4) + (size_t(p[1]) << 4);
    } else {
      hdr = 3;
      if (n < 3) fail("truncated literals header");
      regen = (p[0] >> 4) + (size_t(p[1]) << 4) + (size_t(p[2]) << 12);
    }
  } else {
    streams = sf == 0 ? 1 : 4;
    hdr = sf <= 1 ? 3 : sf == 2 ? 4 : 5;
    if (n < hdr) fail("truncated literals header");
    uint64_t h = 0;
    for (size_t i = 0; i < hdr; ++i) h |= uint64_t(p[i]) << (8 * i);
    int field = sf <= 1 ? 10 : sf == 2 ? 14 : 18;
    regen = (h >> 4) & ((1ULL << field) - 1);
    comp = (h >> (4 + field)) & ((1ULL << field) - 1);
  }
  if (regen > max_block) fail("literals larger than a block");
  std::vector<uint8_t> lit(regen);
  size_t pos = hdr;
  if (ltype == 0) {
    if (pos + regen > n) fail("raw literals run past the block");
    if (regen) std::memcpy(lit.data(), p + pos, regen);
    pos += regen;
  } else if (ltype == 1) {
    if (pos + 1 > n) fail("RLE literal missing");
    std::memset(lit.data(), p[pos], regen);
    pos += 1;
  } else {
    if (pos + comp > n) fail("compressed literals run past the block");
    const uint8_t* q = p + pos;
    size_t qn = comp;
    if (ltype == 2) {
      size_t used = read_huffman_description(fs.huffman, q, qn);
      q += used;
      qn -= used;
    } else if (!fs.huffman.ready) {
      fail("treeless literals with no previous Huffman table");
    }
    if (streams == 1) {
      decode_huffman_stream(fs.huffman, q, qn, lit.data(), regen);
    } else {
      if (qn < 6) fail("truncated Huffman jump table");
      size_t s1 = q[0] | q[1] << 8, s2 = q[2] | q[3] << 8, s3 = q[4] | q[5] << 8;
      if (6 + s1 + s2 + s3 > qn) fail("Huffman jump table points past the literals");
      size_t s4 = qn - 6 - s1 - s2 - s3;
      size_t seg = (regen + 3) / 4;
      if (3 * seg > regen) fail("too few literals for four streams");
      const uint8_t* sp = q + 6;
      size_t sizes[4] = {s1, s2, s3, s4};
      for (int i = 0; i < 4; ++i) {
        size_t count = i < 3 ? seg : regen - 3 * seg;
        decode_huffman_stream(fs.huffman, sp, sizes[i], lit.data() + i * seg, count);
        sp += sizes[i];
      }
    }
    pos += comp;
  }

  // ---- sequences section
  if (pos >= n) fail("sequences section missing");
  size_t nseq = p[pos];
  if (nseq < 128) {
    pos += 1;
  } else if (nseq < 255) {
    if (pos + 2 > n) fail("truncated sequence count");
    nseq = ((nseq - 128) << 8) + p[pos + 1];
    pos += 2;
  } else {
    if (pos + 3 > n) fail("truncated sequence count");
    nseq = p[pos + 1] + (size_t(p[pos + 2]) << 8) + 0x7F00;
    pos += 3;
  }
  size_t lit_pos = 0;
  if (nseq > 0) {
    if (pos >= n) fail("symbol compression modes missing");
    uint8_t modes = p[pos++];
    if (modes & 3) fail("reserved bits of the compression modes are set");
    pos += read_table(fs.ll, modes >> 6, p + pos, n - pos, kLLDefault, 36, 6, 9, 35,
                      "literals-length");
    pos += read_table(fs.of, (modes >> 4) & 3, p + pos, n - pos, kOFDefault, 29, 5, 8, 31,
                      "offset");
    pos += read_table(fs.ml, (modes >> 2) & 3, p + pos, n - pos, kMLDefault, 53, 6, 9, 52,
                      "match-length");
    if (pos >= n) fail("sequence bitstream missing");
    BackwardBits in(p + pos, n - pos);
    FseState ll, of, ml;
    ll.init(fs.ll, in);
    of.init(fs.of, in);
    ml.init(fs.ml, in);
    for (size_t i = 0; i < nseq; ++i) {
      uint8_t oc = of.symbol(), lc = ll.symbol(), mc = ml.symbol();
      if (oc > 31) fail("offset code above 31");
      if (lc > 35 || mc > 52) fail("length code out of range");
      uint64_t offv = (1ULL << oc) + in.read(oc);
      uint64_t mlen = kMLBase[mc] + in.read(kMLBits[mc]);
      uint64_t llen = kLLBase[lc] + in.read(kLLBits[lc]);
      uint64_t offset;
      if (offv > 3) {
        offset = offv - 3;
        fs.rep[2] = fs.rep[1];
        fs.rep[1] = fs.rep[0];
        fs.rep[0] = offset;
      } else {
        uint64_t idx = offv - 1 + (llen == 0 ? 1 : 0);
        if (idx == 0) {
          offset = fs.rep[0];
        } else {
          offset = idx < 3 ? fs.rep[idx] : fs.rep[0] - 1;
          if (idx > 1) fs.rep[2] = fs.rep[1];
          fs.rep[1] = fs.rep[0];
          fs.rep[0] = offset;
        }
      }
      if (i + 1 < nseq) {
        ll.update(in);
        ml.update(in);
        of.update(in);
      }
      // execute
      if (llen > regen - lit_pos) fail("sequence takes more literals than decoded");
      out.insert(out.end(), lit.begin() + lit_pos, lit.begin() + lit_pos + llen);
      lit_pos += llen;
      size_t have = out.size() - frame_start;
      if (offset == 0 || offset > have) fail("match offset reaches before the frame");
      if (mlen > max_block) fail("match longer than a block");
      size_t from = out.size() - offset;
      size_t at = out.size();
      out.resize(at + mlen);
      uint8_t* d = out.data();
      if (offset >= mlen) {
        std::memcpy(d + at, d + from, mlen);
      } else {
        for (size_t k = 0; k < mlen; ++k) d[at + k] = d[from + k];
      }
    }
    if (in.offset != 0) fail("sequence bitstream not consumed exactly");
  } else if (pos != n) {
    fail("bytes after an empty sequences section");
  }
  out.insert(out.end(), lit.begin() + lit_pos, lit.end());
}

// Decodes the frame at p; returns the bytes it took.
size_t decode_frame(const uint8_t* p, size_t n, std::vector<uint8_t>& out) {
  if (n < 4) fail("truncated frame magic");
  uint32_t magic = le32(p);
  if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {  // skippable frame
    if (n < 8) fail("truncated skippable frame");
    uint64_t size = le32(p + 4);
    if (8 + size > n) fail("skippable frame runs past the input");
    return size_t(8 + size);
  }
  if (magic != 0xFD2FB528u) fail("not a zstd frame (bad magic)");
  size_t pos = 4;
  if (pos >= n) fail("truncated frame header");
  uint8_t desc = p[pos++];
  int fcs_flag = desc >> 6, single = (desc >> 5) & 1, checksum = (desc >> 2) & 1,
      dict_flag = desc & 3;
  if (desc & 8) fail("reserved bit of the frame header is set");
  uint64_t window = 0;
  if (!single) {
    if (pos >= n) fail("truncated window descriptor");
    uint8_t w = p[pos++];
    int wlog = 10 + (w >> 3);
    if (wlog > 41) fail("window too large");
    uint64_t base = 1ULL << wlog;
    window = base + (base / 8) * (w & 7);
  }
  static const int kDictBytes[4] = {0, 1, 2, 4};
  int db = kDictBytes[dict_flag];
  if (pos + db > n) fail("truncated dictionary id");
  uint32_t dict = 0;
  for (int i = 0; i < db; ++i) dict |= uint32_t(p[pos + i]) << (8 * i);
  pos += db;
  if (dict != 0) fail("frame needs dictionary " + std::to_string(dict) + "; none is supported");
  int fb = fcs_flag == 0 ? (single ? 1 : 0) : fcs_flag == 1 ? 2 : fcs_flag == 2 ? 4 : 8;
  if (pos + fb > n) fail("truncated frame content size");
  bool has_size = fb > 0;
  uint64_t content = 0;
  for (int i = 0; i < fb; ++i) content |= uint64_t(p[pos + i]) << (8 * i);
  if (fb == 2) content += 256;
  pos += fb;
  if (single) window = content;
  const size_t max_block = size_t(window < (128u << 10) ? window : (128u << 10));

  const size_t start = out.size();
  if (has_size && content < (size_t(1) << 31)) out.reserve(start + size_t(content));
  FrameState fs;
  for (;;) {
    if (pos + 3 > n) fail("truncated block header");
    uint32_t bh = p[pos] | p[pos + 1] << 8 | p[pos + 2] << 16;
    pos += 3;
    int last = bh & 1, type = (bh >> 1) & 3;
    size_t size = bh >> 3;
    if (type == 3) fail("reserved block type");
    if (type == 1) {
      if (pos + 1 > n) fail("truncated RLE block");
      if (size > max_block) fail("block larger than the window allows");
      out.insert(out.end(), size, p[pos]);
      pos += 1;
    } else {
      if (pos + size > n) fail("block runs past the input");
      if (size > max_block) fail("block larger than the window allows");
      if (type == 0)
        out.insert(out.end(), p + pos, p + pos + size);
      else
        decode_block(fs, p + pos, size, out, start, max_block);
      pos += size;
    }
    if (has_size && out.size() - start > content)
      fail("frame decodes to more than its content size " + std::to_string(content));
    if (last) break;
  }
  if (has_size && out.size() - start != content)
    fail("frame decodes to " + std::to_string(out.size() - start) +
         " bytes, not its content size " + std::to_string(content));
  if (checksum) {
    if (pos + 4 > n) fail("truncated content checksum");
    uint32_t want = le32(p + pos);
    uint32_t got = uint32_t(xxh64(out.data() + start, out.size() - start));
    if (want != got) fail("content checksum mismatch");
    pos += 4;
  }
  return pos;
}

thread_local std::string g_error;

}  // namespace

extern "C" {

const char* tz_last_error() { return g_error.c_str(); }

int tz_decompress(const uint8_t* src, size_t n, uint8_t** out, size_t* out_len) {
  *out = nullptr;
  *out_len = 0;
  try {
    std::vector<uint8_t> buf;
    size_t pos = 0;
    if (n == 0) fail("empty input");
    while (pos < n) pos += decode_frame(src + pos, n - pos, buf);
    uint8_t* mem = static_cast<uint8_t*>(std::malloc(buf.size() ? buf.size() : 1));
    if (!mem) fail("out of memory");
    if (!buf.empty()) std::memcpy(mem, buf.data(), buf.size());
    *out = mem;
    *out_len = buf.size();
    return 0;
  } catch (const std::exception& e) {
    g_error = e.what();
    return -1;
  }
}

void tz_free(uint8_t* p) { std::free(p); }

}  // extern "C"
