// wast3d_tpu_torch native Zstandard (RFC 8878) decoding, for TIFF strips and
// tiles of Compression 50000 (libtiff's tif_zstd.c: one frame each).
//
//   w3d_zstd_decode(in, size, out, out_size, msg, msg_len): the first frame,
//     as libzstd's streaming decoder fills libtiff's buffer of `out_size`
//     bytes (a skippable frame first gives nothing): it stops after that
//     frame, or after the block that fills the buffer (the blocks after it
//     are never read). Frame header (Single_Segment,
//     Frame_Content_Size, Window_Descriptor; a nonzero Dictionary_ID is an
//     error), raw / RLE / compressed blocks of at most min(window, 128 KiB),
//     the XXH64 content checksum when its flag is set and the content fits.
//     A compressed block: literals raw, RLE, Huffman in 1 or 4 streams
//     (weights direct or through FSE with two interleaved states, the last
//     weight implied) or treeless (the frame's last table), each stream
//     ended as libzstd 1.5.7 ends it (its single- or double-symbol decoder
//     as HUF_selectDecoder picks, its four-stream fast loop); sequences with
//     predefined, RLE, FSE-described or repeated LL / OF / ML tables, repeat
//     offsets with the literal-length-0 shift, every backward bitstream
//     ending exactly where its last symbol does.
//     Returns the bytes written (at most out_size), or -1 with a reason in
//     msg.
//
// `utils/zstd.py` is the plain version the tests hold this to, step for
// step; its docstring lists libzstd's checks kept here.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <exception>
#include <string>
#include <vector>

namespace {

struct ZstdError {
  std::string msg;
};

[[noreturn]] void bad(const std::string& why) { throw ZstdError{"bad ZSTD data (" + why + ")"}; }

constexpr int64_t kBlockMax = 128 * 1024;
constexpr uint64_t kWindowMax = (uint64_t{1} << 27) + 1;  // libzstd's default decoding limit

const uint32_t kLLBase[36] = {0,  1,  2,   3,   4,   5,   6,    7,    8,    9,     10,    11,
                              12, 13, 14,  15,  16,  18,  20,   22,   24,   28,    32,    40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  1,  1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {3,  4,  5,  6,  7,  8,  9,  10, 11,  12,  13,  14,   15,   16,
                              17, 18, 19, 20, 21, 22, 23, 24, 25,  26,  27,  28,   29,   30,
                              31, 32, 33, 34, 35, 37, 39, 41, 43,  47,  51,  59,   67,   83,
                              99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1,  1,  1,  1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

// ---- XXH64 ------------------------------------------------------------------

constexpr uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL,
                   P3 = 1609587929392839161ULL, P4 = 9650029242287828579ULL,
                   P5 = 2870177450012600261ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t load64(const uint8_t* p) {
  uint64_t v;
  memcpy(&v, p, 8);
  return v;
}
inline uint32_t load32(const uint8_t* p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
}
inline uint64_t xround(uint64_t acc, uint64_t lane) { return rotl(acc + lane * P2, 31) * P1; }

uint64_t xxh64(const uint8_t* p, size_t n) {
  size_t i = 0;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    for (; i + 32 <= n; i += 32) {
      v1 = xround(v1, load64(p + i));
      v2 = xround(v2, load64(p + i + 8));
      v3 = xround(v3, load64(p + i + 16));
      v4 = xround(v4, load64(p + i + 24));
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    for (uint64_t v : {v1, v2, v3, v4}) h = (h ^ xround(0, v)) * P1 + P4;
  } else {
    h = P5;
  }
  h += n;
  for (; i + 8 <= n; i += 8) h = rotl(h ^ xround(0, load64(p + i)), 27) * P1 + P4;
  if (i + 4 <= n) {
    h = rotl(h ^ (uint64_t{load32(p + i)} * P1), 23) * P2 + P3;
    i += 4;
  }
  for (; i < n; ++i) h = rotl(h ^ (p[i] * P5), 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  return h ^ (h >> 32);
}

// ---- bitstreams -------------------------------------------------------------

// A backward bitstream: read from the end, the highest set bit of the last
// byte a marker (`unmarked`: a last byte of zero is all data). pos = bits
// left. Past the start it reads as libzstd's BIT_DStream does once its
// container holds the stream's first 8 bytes: zeros below them, then (the
// consumed count past 64 taken mod 64) those bytes again.
struct Backward {
  const uint8_t* p;
  int64_t size, pos;
  uint64_t container = 0;
  Backward(const uint8_t* data, int64_t n, bool unmarked = false) : p(data), size(n) {
    if (n < 1 || (data[n - 1] == 0 && !unmarked)) bad("a bitstream without its end marker");
    memcpy(&container, data, static_cast<size_t>(n < 8 ? n : 8));
    if (data[n - 1] == 0) {
      pos = 8 * n;
    } else {
      int top = 7;
      while (!(data[n - 1] >> top)) --top;
      pos = 8 * (n - 1) + top;
    }
  }
  // Bits [at, at + n) of the little-endian stream, n <= 32, at >= 0.
  uint32_t bits_at(int64_t at, int n) const {
    const int64_t byte = at >> 3;
    uint64_t w = 0;
    if (byte + 8 <= size) {
      w = load64(p + byte);
    } else {
      memcpy(&w, p + byte, static_cast<size_t>(size - byte));
    }
    return static_cast<uint32_t>((w >> (at & 7)) & ((uint64_t{1} << n) - 1));
  }
  uint32_t peek(int n) const {
    if (n == 0) return 0;
    if (pos >= n) return bits_at(pos - n, n);
    return static_cast<uint32_t>((container << ((64 - pos) & 63)) >> (64 - n));
  }
  uint32_t read(int n) {
    const uint32_t v = peek(n);
    pos -= n;
    return v;
  }
};

// ---- FSE --------------------------------------------------------------------

struct FseEntry {
  uint16_t symbol;
  uint8_t bits;
  uint16_t base;
};

struct FseTable {
  std::vector<FseEntry> t;
  int log = 0;
  bool set = false;
};

// FSE_readNCount over data[pos, end): normalized counts; returns the position
// after the description.
int64_t read_ncount(const uint8_t* data, int64_t pos, int64_t end, int max_symbol, int max_log,
                    std::vector<int16_t>& counts, int& log) {
  int64_t bits = 0;
  auto take = [&](int n) -> uint32_t {
    const int64_t byte = pos + (bits >> 3);
    uint32_t w = 0;
    for (int k = 0; k < 4; ++k)
      if (byte + k < end) w |= uint32_t{data[byte + k]} << (8 * k);
    return (w >> (bits & 7)) & ((uint32_t{1} << n) - 1);
  };
  if (pos >= end) bad("an FSE table description past the end of the block");
  log = static_cast<int>(take(4)) + 5;
  bits = 4;
  if (log > max_log) bad("an FSE accuracy log past its largest");
  int remaining = (1 << log) + 1, threshold = 1 << log, nb = log + 1;
  bool previous0 = false;
  counts.clear();
  while (remaining > 1 && static_cast<int>(counts.size()) <= max_symbol) {
    if (previous0) {
      int n0 = static_cast<int>(counts.size());
      for (;;) {
        const int r = static_cast<int>(take(2));
        bits += 2;
        n0 += r;
        if (r != 3) break;
      }
      if (n0 > max_symbol) bad("an FSE table past its largest symbol");
      counts.resize(n0, 0);
    }
    const int big = (2 * threshold - 1) - remaining;
    const int low = static_cast<int>(take(nb - 1));
    int count;
    if (low < big) {
      count = low;
      bits += nb - 1;
    } else {
      count = static_cast<int>(take(nb));
      if (count >= threshold) count -= big;
      bits += nb;
    }
    --count;
    remaining -= count < 0 ? -count : count;
    counts.push_back(static_cast<int16_t>(count));
    previous0 = count == 0;
    if (remaining < threshold) {
      if (remaining <= 1) break;
      nb = 0;
      while ((remaining >> nb) > 0) ++nb;
      threshold = 1 << (nb - 1);
    }
  }
  if (remaining != 1 || static_cast<int>(counts.size()) > max_symbol + 1)
    bad("an FSE table description whose counts do not add up");
  if (pos + ((bits + 7) >> 3) > end) bad("an FSE table description past the end of the block");
  return pos + ((bits + 7) >> 3);
}

void fse_build(const int16_t* counts, int n, int log, FseTable& out) {
  const int size = 1 << log;
  std::vector<uint16_t> symbol(size, 0), next(n, 0);
  int high = size - 1;
  for (int s = 0; s < n; ++s) {
    if (counts[s] == -1) {
      symbol[high--] = static_cast<uint16_t>(s);
      next[s] = 1;
    } else {
      next[s] = static_cast<uint16_t>(counts[s] > 0 ? counts[s] : 0);
    }
  }
  const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  int p = 0;
  for (int s = 0; s < n; ++s) {
    for (int i = 0; i < counts[s]; ++i) {
      symbol[p] = static_cast<uint16_t>(s);
      p = (p + step) & mask;
      while (p > high) p = (p + step) & mask;
    }
  }
  if (p != 0) bad("an FSE table that does not spread");
  out.t.assign(size, FseEntry{});
  for (int u = 0; u < size; ++u) {
    const uint16_t s = symbol[u];
    const int state = next[s]++;
    int hb = 0;
    while ((state >> (hb + 1)) > 0) ++hb;
    const int nbits = log - hb;
    out.t[u] = FseEntry{s, static_cast<uint8_t>(nbits),
                        static_cast<uint16_t>((state << nbits) - size)};
  }
  out.log = log;
  out.set = true;
}

// ---- Huffman ----------------------------------------------------------------

struct Huffman {
  std::vector<uint16_t> t;  // (symbol << 8) | code length, indexed by the next `bits` bits
  int bits = 0;
  bool set = false;
  bool x2 = false;  // built for libzstd's double-symbol decoder
};

// libzstd 1.5.7's HUF_selectDecoder: whether four streams of `size` literals
// from `csize` bytes go to its double-symbol decoder.
bool double_symbol(int64_t size, int64_t csize) {
  static const uint32_t kTime[16][4] = {
      {0, 0, 1, 1},         {0, 0, 1, 1},         {150, 216, 381, 119}, {170, 205, 514, 112},
      {177, 199, 539, 110}, {197, 194, 644, 107}, {221, 192, 735, 107}, {256, 189, 881, 106},
      {359, 188, 1167, 109}, {582, 187, 1570, 114}, {688, 187, 1712, 122},
      {825, 186, 1965, 136}, {976, 185, 2131, 150}, {1180, 186, 2070, 175},
      {1377, 185, 1731, 202}, {1412, 185, 1695, 202}};
  const int q = csize >= size ? 15 : static_cast<int>(csize * 16 / size);
  const uint64_t d256 = static_cast<uint64_t>(size) >> 8;
  const uint64_t t0 = kTime[q][0] + kTime[q][1] * d256;
  uint64_t t1 = kTime[q][2] + kTime[q][3] * d256;
  t1 += t1 >> 5;
  return t1 < t0;
}

void huffman_build(std::vector<uint8_t>& weights, Huffman& h) {
  uint32_t total = 0;
  for (uint8_t w : weights) {
    if (w > 12) bad("a Huffman weight above 12");
    total += (uint32_t{1} << w) >> 1;
  }
  if (total == 0) bad("Huffman weights that are all zero");
  int bits = 0;
  while ((total >> bits) > 0) ++bits;
  if (bits > 12) bad("a Huffman table of more than 12 bits");
  const uint32_t rest = (uint32_t{1} << bits) - total;
  if (rest & (rest - 1)) bad("Huffman weights that do not complete a power of two");
  int last = 0;
  while ((rest >> last) > 0) ++last;
  weights.push_back(static_cast<uint8_t>(last));
  int ones = 0;
  for (uint8_t w : weights) ones += w == 1;
  if (ones < 2 || (ones & 1)) bad("Huffman weights with an odd number of weight-1 symbols");
  std::vector<uint32_t> start(bits + 2, 0);
  uint32_t acc = 0;
  for (int w = 1; w <= bits; ++w) {
    start[w] = acc;
    for (uint8_t x : weights) acc += (x == w) ? (uint32_t{1} << (w - 1)) : 0;
  }
  h.t.assign(size_t{1} << bits, 0);
  for (size_t s = 0; s < weights.size(); ++s) {
    const int w = weights[s];
    if (!w) continue;
    const uint32_t n = (uint32_t{1} << w) >> 1;
    const uint16_t e = static_cast<uint16_t>((s << 8) | (bits + 1 - w));
    for (uint32_t i = 0; i < n; ++i) h.t[start[w] + i] = e;
    start[w] += n;
  }
  h.bits = bits;
  h.set = true;
}

// A Huffman tree description at data[pos, end) -> the table; returns the
// position after it.
int64_t huffman_read(const uint8_t* data, int64_t pos, int64_t end, Huffman& h) {
  if (pos >= end) bad("a Huffman tree description past the end of the literals");
  const int head = data[pos++];
  std::vector<uint8_t> weights;
  if (head >= 128) {
    const int n = head - 127;
    if (pos + (n + 1) / 2 > end) bad("a Huffman tree description past the end of the literals");
    for (int i = 0; i < n; ++i) weights.push_back((data[pos + i / 2] >> ((i & 1) ? 0 : 4)) & 15);
    huffman_build(weights, h);
    return pos + (n + 1) / 2;
  }
  if (pos + head > end) bad("a Huffman tree description past the end of the literals");
  std::vector<int16_t> counts;
  int log = 0;
  const int64_t at = read_ncount(data, pos, pos + head, 255, 6, counts, log);
  FseTable t;
  fse_build(counts.data(), static_cast<int>(counts.size()), log, t);
  Backward bs(data + at, pos + head - at);
  uint32_t states[2] = {bs.read(log), bs.read(log)};
  for (;;) {
    for (int a = 0; a < 2; ++a) {
      const FseEntry& e = t.t[states[a]];
      weights.push_back(static_cast<uint8_t>(e.symbol));
      states[a] = e.base + bs.read(e.bits);
      if (bs.pos < 0) {
        weights.push_back(static_cast<uint8_t>(t.t[states[1 - a]].symbol));
        if (weights.size() > 255) bad("more than 255 Huffman weights");
        huffman_build(weights, h);
        return pos + head;
      }
      if (weights.size() >= 255) bad("more than 255 Huffman weights");
    }
  }
}

// One table lookup: 1 symbol, or 2 when the double-symbol decoder's 11-bit
// (12 for a 12-bit code) window holds both codes.
int lookup(const Backward& bs, const Huffman& h, bool x2, uint8_t* sym, int* len) {
  const uint16_t e = h.t[bs.peek(h.bits)];
  sym[0] = static_cast<uint8_t>(e >> 8);
  len[0] = e & 255;
  if (!x2) return 1;
  const int window = h.bits <= 11 ? 11 : 12;
  const uint32_t rest = (bs.peek(window) << len[0]) & ((1u << window) - 1);
  const uint16_t e2 = h.t[rest >> (window - h.bits)];
  if ((e2 & 255) > window - len[0]) return 1;
  sym[1] = static_cast<uint8_t>(e2 >> 8);
  len[1] = e2 & 255;
  return 2;
}

// HUF_decodeStreamX1 / X2 up to `n` symbols (k of them already out): a last
// symbol left alone whose lookup would take two consumes the rest.
void finish(Backward& bs, const Huffman& h, int64_t n, bool x2, uint8_t* out, int64_t& k) {
  uint8_t sym[2];
  int len[2];
  while (k < n - (x2 ? 1 : 0)) {
    const int m = lookup(bs, h, x2, sym, len);
    for (int i = 0; i < m; ++i) {
      out[k++] = sym[i];
      bs.pos -= len[i];
    }
  }
  if (k < n) {
    const int m = lookup(bs, h, true, sym, len);
    out[k++] = sym[0];
    if (m == 1) {
      bs.pos -= len[0];
    } else if (bs.pos > 0) {  // HUF_decodeLastSymbolX2 clamps to the stream's end
      bs.pos -= len[0] + len[1];
      if (bs.pos < 0) bs.pos = 0;
    }
  }
}

void huffman_stream(const uint8_t* data, int64_t n, const Huffman& h, uint8_t* out,
                    int64_t count) {
  Backward bs(data, n);
  int64_t k = 0;
  finish(bs, h, count, h.x2, out, k);
  if (bs.pos != 0) bad("a Huffman stream that does not end where its symbols do");
}

inline int64_t ceil8(int64_t x) { return x >= 0 ? (x + 7) / 8 : -((-x) / 8); }

// Four streams through libzstd's fast loop, `data` from the jump table on
// (see utils/zstd._fast_four).
void fast_four(const uint8_t* data, const int64_t* sizes, const int64_t* counts,
               const Huffman& h, uint8_t* out) {
  int64_t starts[4], ends[4], ip[4], got[4] = {0, 0, 0, 0};
  uint8_t* o[4];
  int64_t acc = 6, at = 0;
  for (int k = 0; k < 4; ++k) {
    starts[k] = acc;
    acc += sizes[k];
    ends[k] = acc;
    ip[k] = ends[k] - 8;
    o[k] = out + at;
    at += counts[k];
  }
  std::vector<Backward> bs;
  for (int k = 0; k < 4; ++k) bs.emplace_back(data, ends[k], true);
  uint8_t sym[2];
  int len[2];
  for (;;) {
    int64_t iters = ip[0] / 7;
    if (h.x2) {
      for (int k = 0; k < 4; ++k) iters = std::min(iters, (counts[k] - got[k]) / 10);
    } else {
      iters = std::min(iters, (counts[3] - got[3]) / 5);
    }
    const int64_t limit = got[3] + 5 * iters;
    if (got[3] == limit || ip[1] < ip[0] || ip[2] < ip[1] || ip[3] < ip[2]) break;
    do {
      for (int k = 0; k < 4; ++k) {
        for (int r = 0; r < 5; ++r) {
          const int m = lookup(bs[k], h, h.x2, sym, len);
          for (int i = 0; i < m; ++i) {
            o[k][got[k]++] = sym[i];
            bs[k].pos -= len[i];
          }
        }
        ip[k] = ceil8(bs[k].pos) - 8;
      }
    } while (got[3] < limit);
  }
  for (int k = 0; k < 4; ++k) {
    if (ip[k] < starts[k] - 8) bad("a Huffman stream read past the one before it");
    finish(bs[k], h, counts[k], h.x2, o[k], got[k]);
  }
}

// ---- blocks -----------------------------------------------------------------

struct Frame {
  int64_t block_max;
  Huffman huffman;
  FseTable ll, of, ml;
  uint64_t rep[3] = {1, 4, 8};
  std::vector<uint8_t> lits;
};

int64_t literals(const uint8_t* data, int64_t pos, int64_t end, Frame& f) {
  const int b0 = data[pos];
  const int kind = b0 & 3, fmt = (b0 >> 2) & 3;
  if (kind < 2) {
    int64_t size;
    if (fmt == 0 || fmt == 2) {
      size = b0 >> 3;
      pos += 1;
    } else if (fmt == 1) {
      if (pos + 2 > end) bad("a literals header past the block");
      size = (b0 >> 4) + (int64_t{data[pos + 1]} << 4);
      pos += 2;
    } else {
      if (pos + 3 > end) bad("a literals header past the block");
      size = (b0 >> 4) + (int64_t{data[pos + 1]} << 4) + (int64_t{data[pos + 2]} << 12);
      pos += 3;
    }
    if (pos > end || size > f.block_max) bad("a literals header past the block");
    if (kind == 0) {
      if (pos + size > end) bad("raw literals past the end of the block");
      f.lits.assign(data + pos, data + pos + size);
      return pos + size;
    }
    if (pos >= end) bad("RLE literals past the end of the block");
    f.lits.assign(static_cast<size_t>(size), data[pos]);
    return pos + 1;
  }
  const int head = fmt < 2 ? 3 : fmt + 2;
  if (pos + head > end) bad("a literals header past the block");
  uint64_t hv = 0;
  for (int i = 0; i < head; ++i) hv |= uint64_t{data[pos + i]} << (8 * i);
  const int field = fmt == 0 || fmt == 1 ? 10 : fmt == 2 ? 14 : 18;
  const int64_t size = static_cast<int64_t>((hv >> 4) & ((uint64_t{1} << field) - 1));
  const int64_t csize = static_cast<int64_t>((hv >> (4 + field)) & ((uint64_t{1} << field) - 1));
  pos += head;
  if (size > f.block_max || pos + csize > end) bad("Huffman literals past the end of the block");
  const int64_t stop = pos + csize;
  if (kind == 2) {  // a new table, for libzstd's single- or double-symbol decoder
    pos = huffman_read(data, pos, stop, f.huffman);
    f.huffman.x2 = fmt != 0 && double_symbol(size, csize);
  } else if (!f.huffman.set) {
    bad("treeless literals before any Huffman table");
  }
  f.lits.resize(static_cast<size_t>(size));
  if (fmt == 0) {
    huffman_stream(data + pos, stop - pos, f.huffman, f.lits.data(), size);
    return stop;
  }
  if (stop - pos < 10 || size < 6) bad("four Huffman streams in too little room");
  const int64_t jump = pos;
  int64_t sizes[4];
  for (int i = 0; i < 3; ++i) sizes[i] = data[pos + 2 * i] | (data[pos + 2 * i + 1] << 8);
  pos += 6;
  sizes[3] = stop - pos - sizes[0] - sizes[1] - sizes[2];
  if (sizes[3] < 0) bad("Huffman stream sizes past the literals");
  const int64_t seg = (size + 3) / 4;
  const int64_t counts[4] = {seg, seg, seg, size - 3 * seg};
  if (counts[3] < 0) bad("too few literals for four Huffman streams");
  if (f.huffman.bits <= 11 && counts[3] > 0 && std::min({sizes[0], sizes[1], sizes[2], sizes[3]}) >= 8) {
    fast_four(data + jump, sizes, counts, f.huffman, f.lits.data());  // libzstd's fast loop
    return stop;
  }
  uint8_t* o = f.lits.data();
  for (int i = 0; i < 4; ++i) {
    huffman_stream(data + pos, sizes[i], f.huffman, o, counts[i]);
    pos += sizes[i];
    o += counts[i];
  }
  return stop;
}

int64_t seq_table(const uint8_t* data, int64_t pos, int64_t end, int mode, FseTable& t,
                  const int16_t* def, int def_n, int def_log, int max_symbol, int max_log) {
  if (mode == 0) {
    fse_build(def, def_n, def_log, t);
  } else if (mode == 1) {
    if (pos >= end) bad("an RLE sequence table past the end of the block");
    if (data[pos] > max_symbol) bad("an RLE sequence symbol past its largest");
    t.t.assign(1, FseEntry{data[pos], 0, 0});
    t.log = 0;
    t.set = true;
    ++pos;
  } else if (mode == 2) {
    std::vector<int16_t> counts;
    int log = 0;
    pos = read_ncount(data, pos, end, max_symbol, max_log, counts, log);
    fse_build(counts.data(), static_cast<int>(counts.size()), log, t);
  } else if (!t.set) {
    bad("a repeated sequence table before any");
  }
  return pos;
}

void block(const uint8_t* data, int64_t pos, int64_t end, std::vector<uint8_t>& out, Frame& f) {
  if (end - pos < 1) bad("an empty compressed block");
  pos = literals(data, pos, end, f);
  if (pos >= end) bad("a block without its sequences section");
  const int b0 = data[pos];
  int64_t nseq;
  if (b0 < 128) {
    nseq = b0;
    pos += 1;
  } else if (b0 < 255) {
    if (pos + 2 > end) bad("a sequences header past the block");
    nseq = ((b0 - 128) << 8) + data[pos + 1];
    pos += 2;
  } else {
    if (pos + 3 > end) bad("a sequences header past the block");
    nseq = data[pos + 1] + (data[pos + 2] << 8) + 0x7F00;
    pos += 3;
  }
  const int64_t start = static_cast<int64_t>(out.size());
  const std::vector<uint8_t>& lits = f.lits;
  if (nseq == 0) {
    if (pos != end) bad("bytes after a block's last sequence");
    out.insert(out.end(), lits.begin(), lits.end());
    return;
  }
  if (pos >= end) bad("a sequences header past the block");
  const int modes = data[pos++];
  if (modes & 3) bad("reserved bits set in the sequence modes");
  pos = seq_table(data, pos, end, modes >> 6, f.ll, kLLDefault, 36, 6, 35, 9);
  pos = seq_table(data, pos, end, (modes >> 4) & 3, f.of, kOFDefault, 29, 5, 31, 8);
  pos = seq_table(data, pos, end, (modes >> 2) & 3, f.ml, kMLDefault, 53, 6, 52, 9);
  if (pos >= end) bad("a sequences bitstream that is empty");
  Backward bs(data + pos, end - pos);
  uint32_t ll_s = bs.read(f.ll.log), of_s = bs.read(f.of.log), ml_s = bs.read(f.ml.log);
  uint64_t* rep = f.rep;
  size_t lit = 0;
  for (int64_t i = 0; i < nseq; ++i) {
    const int of_code = f.of.t[of_s].symbol, ll_code = f.ll.t[ll_s].symbol,
              ml_code = f.ml.t[ml_s].symbol;
    if (of_code > 31) bad("an offset code past 31");
    uint64_t offset = (uint64_t{1} << of_code) + bs.read(of_code);
    const uint64_t ml = kMLBase[ml_code] + bs.read(kMLBits[ml_code]);
    const uint64_t ll = kLLBase[ll_code] + bs.read(kLLBits[ll_code]);
    if (offset > 3) {
      offset -= 3;
      rep[2] = rep[1];
      rep[1] = rep[0];
      rep[0] = offset;
    } else {
      const int k = static_cast<int>(offset) - 1 + (ll == 0);
      if (k == 0) {
        offset = rep[0];
      } else if (k == 3) {
        offset = rep[0] - 1;
        if (offset == 0) bad("a repeat offset of 0");
        rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = offset;
      } else {
        offset = rep[k];
        if (k == 2) rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = offset;
      }
    }
    if (i < nseq - 1) {
      const FseEntry& a = f.ll.t[ll_s];
      ll_s = a.base + bs.read(a.bits);
      const FseEntry& b = f.ml.t[ml_s];
      ml_s = b.base + bs.read(b.bits);
      const FseEntry& c = f.of.t[of_s];
      of_s = c.base + bs.read(c.bits);
    }
    if (lit + ll > lits.size()) bad("a sequence past the block's literals");
    out.insert(out.end(), lits.begin() + lit, lits.begin() + lit + ll);
    lit += ll;
    if (offset > out.size()) bad("an offset past the start of the output");
    if (static_cast<int64_t>(out.size()) - start + static_cast<int64_t>(ml) > f.block_max)
      bad("a block that decodes past its largest size");
    const size_t n = out.size();
    out.resize(n + ml);
    uint8_t* dst = out.data() + n;
    const uint8_t* src = dst - offset;
    if (offset >= ml) {
      memcpy(dst, src, ml);
    } else {
      for (uint64_t j = 0; j < ml; ++j) dst[j] = src[j];
    }
  }
  if (bs.pos != 0) bad("a sequences bitstream that does not end with its last sequence");
  out.insert(out.end(), lits.begin() + lit, lits.end());
  if (static_cast<int64_t>(out.size()) - start > f.block_max)
    bad("a block that decodes past its largest size");
}

// One frame from data[pos] (after its magic number); returns the position
// after what was read.
int64_t frame(const uint8_t* data, int64_t size, int64_t pos, std::vector<uint8_t>& out,
              int64_t out_size) {
  if (pos >= size) bad("a frame header cut short");
  const int fhd = data[pos++];
  const int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1,
            dict_flag = fhd & 3;
  if (fhd & 8) bad("the reserved bit of the frame header set");
  const int nd = dict_flag == 3 ? 4 : dict_flag;
  const int nf = fcs_flag == 0 ? single : fcs_flag == 1 ? 2 : fcs_flag == 2 ? 4 : 8;
  if (pos + (single ? 0 : 1) + nd + nf > size) bad("a frame header cut short");
  uint64_t window = 0;
  if (!single) {
    const int wd = data[pos++];
    const int log = 10 + (wd >> 3);
    if (log > 31) bad("a window past what libzstd decodes");
    window = (uint64_t{1} << log) + ((uint64_t{1} << log) >> 3) * (wd & 7);
  }
  uint64_t dict = 0;
  for (int i = 0; i < nd; ++i) dict |= uint64_t{data[pos + i]} << (8 * i);
  if (dict) bad("a dictionary, which this frame needs and TIFF does not carry");
  pos += nd;
  uint64_t fcs = 0;
  for (int i = 0; i < nf; ++i) fcs |= uint64_t{data[pos + i]} << (8 * i);
  if (nf == 2) fcs += 256;
  pos += nf;
  if (single) window = fcs;
  if (window > kWindowMax) bad("a window past what libzstd decodes");
  Frame f;
  f.block_max = static_cast<int64_t>(window < uint64_t(kBlockMax) ? window : kBlockMax);
  const int64_t start = static_cast<int64_t>(out.size());
  for (;;) {
    if (pos + 3 > size) bad("a block header cut short");
    const uint32_t bh = data[pos] | (data[pos + 1] << 8) | (data[pos + 2] << 16);
    pos += 3;
    const int last = bh & 1, kind = (bh >> 1) & 3;
    const int64_t bsize = bh >> 3;
    if (kind == 3) bad("a reserved block type");
    if (bsize > f.block_max) bad("a block past the frame's largest block size");
    if (kind == 0) {
      if (pos + bsize > size) bad("a raw block cut short");
      out.insert(out.end(), data + pos, data + pos + bsize);
      pos += bsize;
    } else if (kind == 1) {
      if (pos + 1 > size) bad("an RLE block cut short");
      out.insert(out.end(), static_cast<size_t>(bsize), data[pos]);
      pos += 1;
    } else {
      if (pos + bsize > size) bad("a compressed block cut short");
      block(data, pos, pos + bsize, out, f);
      pos += bsize;
    }
    const int64_t got = static_cast<int64_t>(out.size()) - start;
    if (nf && static_cast<uint64_t>(got) > fcs) bad("a frame longer than its content size");
    if (last) break;
    if (static_cast<int64_t>(out.size()) >= out_size) return pos;
  }
  const int64_t got = static_cast<int64_t>(out.size()) - start;
  if (nf && static_cast<uint64_t>(got) != fcs) bad("a frame shorter than its content size");
  if (checksum && static_cast<int64_t>(out.size()) <= out_size && pos + 4 <= size) {
    const uint64_t h = xxh64(out.data() + start, static_cast<size_t>(got));
    if ((h & 0xFFFFFFFFu) != load32(data + pos)) bad("a content checksum that does not match");
    pos += 4;
  }
  return pos;
}

int64_t zstd_decode(const uint8_t* data, int64_t size, uint8_t* dst, int64_t out_size) {
  std::vector<uint8_t> out;
  if (out_size > 0) {
    out.reserve(static_cast<size_t>(out_size) + kBlockMax);
    if (size < 4) bad("a frame cut short before its magic number");
    const uint32_t magic = load32(data);
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {  // skippable: libzstd returns 0, libtiff stops
      if (size < 8 || 8 + int64_t{load32(data + 4)} > size) bad("a skippable frame cut short");
    } else if (magic != 0xFD2FB528u) {
      char buf[64];
      snprintf(buf, sizeof buf, "magic number 0x%08x", magic);
      bad(buf);
    } else {
      frame(data, size, 4, out, out_size);
    }
  }
  const int64_t n = static_cast<int64_t>(out.size()) < out_size
                        ? static_cast<int64_t>(out.size()) : out_size;
  if (n) memcpy(dst, out.data(), static_cast<size_t>(n));
  return n;
}

}  // namespace

extern "C" {

int64_t w3d_zstd_decode(const uint8_t* in, int64_t size, uint8_t* out, int64_t out_size,
                        char* msg, int32_t msg_len) {
  try {
    return zstd_decode(in, size, out, out_size);
  } catch (const ZstdError& e) {
    if (msg && msg_len > 0) snprintf(msg, static_cast<size_t>(msg_len), "%s", e.msg.c_str());
  } catch (const std::exception& e) {
    if (msg && msg_len > 0) snprintf(msg, static_cast<size_t>(msg_len), "%s", e.what());
  }
  return -1;
}

}  // extern "C"
