// wast3d_tpu_torch native byte loops of the ICO / CUR, DDS, PSD, SGI, PCX
// and Sun raster readers (`utils/image_formats.py`), each as Pillow's C
// decoder reads the bytes; `utils/image_formats.py` holds the plain version
// of each that the tests hold it to.
//
//   w3d_bcn_decode(in, size, n, sign, width, height, out, msg, msg_len):
//     Pillow's BcnDecode.c: 4 x 4 blocks row by row (8 bytes for BC1 / BC4,
//     16 for the rest) -> out [height, width, bands] (RGBA for BC1-3 and
//     BC7, L for BC4, RGB for BC5 and BC6H), edge blocks cropped. BC1's
//     three-colour mode when c0 <= c1 (BC2 / BC3 always four colours), the
//     integer interpolations of BC1 / BC3-alpha, BC5 signed (+128, blue 128),
//     BC6H's fourteen modes with Pillow's quirks (no rounding in the
//     interpolation, signed deltas wrapped to the endpoint width and read
//     back as 16-bit, a half float to a byte as (uint8)(f * 255), NaN as 0,
//     reserved modes black), BC7's eight modes with partitions, anchors,
//     p-bits, rotation and index selection.
//   w3d_packbits_rows(in, size, row_bytes, rows, out, ...): Pillow's
//     PackBitsDecode, a row at a time (a run or literal past the row's end
//     cut there; 0x80 a no-op).
//   w3d_sgi_rle(file, size, width, height, bands, bpc, out, ...): Pillow's
//     SgiRleDecode on the whole file: the start and length tables after the
//     512-byte header, one run-length row per channel (a count byte, or a
//     16-bit count word at 2 bytes a sample), rows bottom-up in the file,
//     written top-down to out [height, width * bands * bpc]; its bounds
//     checks (the file's end; a row's length only bounds its steps, as a
//     signed int), a row buffer kept from row to row, and its early end (a
//     packet of nonzero count in a row's last step ends the image there).
//   w3d_pcx_rle(in, size, row_bytes, width, bits, rows, out, ...): Pillow's
//     PcxDecode (C0 | n, v runs, other bytes literal; a run past its row is
//     an error), each row's planes moved together as it moves them (bit
//     planes of (width + 7) / 8 bytes at 2 or 4 bits a pixel, else planes of
//     `width` bytes).
//   w3d_sun_rle(in, size, row_bytes, rows, out, ...): Pillow's SunRleDecode
//     (80 n v: n + 1 copies, 80 00: one 80; runs go on across rows).
//
// Each returns 0 (w3d_packbits_rows / w3d_sun_rle / w3d_pcx_rle: the bytes
// read) or -1 with a NUL-terminated reason in msg; data that ends before the
// last row is "image file is truncated", as Pillow reports it.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <exception>
#include <string>
#include <vector>

namespace {

struct RasterError {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw RasterError{msg}; }

void set_message(char* msg, int32_t len, const std::string& s) {
  if (msg && len > 0) snprintf(msg, static_cast<size_t>(len), "%s", s.c_str());
}

// ---- BC1-BC5 ------------------------------------------------------------------

struct Rgba {
  uint8_t r, g, b, a;
};

Rgba decode_565(uint16_t x) {
  int r = (x & 0xf800) >> 8, g = (x & 0x7e0) >> 3, b = (x & 0x1f) << 3;
  return Rgba{static_cast<uint8_t>(r | r >> 5), static_cast<uint8_t>(g | g >> 6),
              static_cast<uint8_t>(b | b >> 5), 255};
}

void bc1_colors(Rgba* dst, const uint8_t* src, bool separate_alpha) {
  const uint16_t c0 = src[0] | src[1] << 8, c1 = src[2] | src[3] << 8;
  const uint32_t lut = src[4] | src[5] << 8 | src[6] << 16 | static_cast<uint32_t>(src[7]) << 24;
  Rgba p[4];
  p[0] = decode_565(c0);
  p[1] = decode_565(c1);
  const int r0 = p[0].r, g0 = p[0].g, b0 = p[0].b, r1 = p[1].r, g1 = p[1].g, b1 = p[1].b;
  if (c0 > c1 || separate_alpha) {
    p[2] = Rgba{static_cast<uint8_t>((2 * r0 + r1) / 3), static_cast<uint8_t>((2 * g0 + g1) / 3),
                static_cast<uint8_t>((2 * b0 + b1) / 3), 255};
    p[3] = Rgba{static_cast<uint8_t>((r0 + 2 * r1) / 3), static_cast<uint8_t>((g0 + 2 * g1) / 3),
                static_cast<uint8_t>((b0 + 2 * b1) / 3), 255};
  } else {
    p[2] = Rgba{static_cast<uint8_t>((r0 + r1) / 2), static_cast<uint8_t>((g0 + g1) / 2),
                static_cast<uint8_t>((b0 + b1) / 2), 255};
    p[3] = Rgba{0, 0, 0, 0};
  }
  for (int i = 0; i < 16; ++i) dst[i] = p[(lut >> (2 * i)) & 3];
}

// An alpha-style block (BC3's alpha, BC4, BC5's channels) into byte `o` of
// each of 16 pixels `stride` bytes apart.
void bc3_alpha(uint8_t* dst, int stride, int o, const uint8_t* src, bool sign) {
  int a0 = src[0], a1 = src[1];
  if (sign) {
    a0 = static_cast<int8_t>(src[0]) + 128;
    a1 = static_cast<int8_t>(src[1]) + 128;
  }
  uint64_t lut = 0;
  for (int i = 0; i < 6; ++i) lut |= static_cast<uint64_t>(src[2 + i]) << (8 * i);
  int a[8] = {a0, a1, 0, 0, 0, 0, 0, 0};
  if (a0 > a1) {
    for (int i = 1; i < 7; ++i) a[1 + i] = ((7 - i) * a0 + i * a1) / 7;
  } else {
    for (int i = 1; i < 5; ++i) a[1 + i] = ((5 - i) * a0 + i * a1) / 5;
    a[6] = 0;
    a[7] = 255;
  }
  for (int i = 0; i < 16; ++i) dst[stride * i + o] = static_cast<uint8_t>(a[(lut >> (3 * i)) & 7]);
}

// ---- BC7 ------------------------------------------------------------------------

struct Bc7Mode {
  uint8_t ns, pb, rb, isb, cb, ab, epb, spb, ib, ib2;
};
const Bc7Mode kBc7Modes[8] = {{3, 4, 0, 0, 4, 0, 1, 0, 3, 0}, {2, 6, 0, 0, 6, 0, 0, 1, 3, 0},
                              {3, 6, 0, 0, 5, 0, 0, 0, 2, 0}, {2, 6, 0, 0, 7, 0, 1, 0, 2, 0},
                              {1, 0, 2, 1, 5, 6, 0, 0, 2, 3}, {1, 0, 2, 0, 7, 8, 0, 0, 2, 2},
                              {1, 0, 0, 0, 7, 7, 1, 0, 4, 0}, {2, 6, 0, 0, 5, 5, 1, 0, 2, 0}};
const uint16_t kP2[64] = {
    0xcccc, 0x8888, 0xeeee, 0xecc8, 0xc880, 0xfeec, 0xfec8, 0xec80, 0xc800, 0xffec, 0xfe80,
    0xe800, 0xffe8, 0xff00, 0xfff0, 0xf000, 0xf710, 0x008e, 0x7100, 0x08ce, 0x008c, 0x7310,
    0x3100, 0x8cce, 0x088c, 0x3110, 0x6666, 0x366c, 0x17e8, 0x0ff0, 0x718e, 0x399c, 0xaaaa,
    0xf0f0, 0x5a5a, 0x33cc, 0x3c3c, 0x55aa, 0x9696, 0xa55a, 0x73ce, 0x13c8, 0x324c, 0x3bdc,
    0x6996, 0xc33c, 0x9966, 0x0660, 0x0272, 0x04e4, 0x4e40, 0x2720, 0xc936, 0x936c, 0x39c6,
    0x639c, 0x9336, 0x9cc6, 0x817e, 0xe718, 0xccf0, 0x0fcc, 0x7744, 0xee22};
const uint32_t kP3[64] = {
    0xaa685050, 0x6a5a5040, 0x5a5a4200, 0x5450a0a8, 0xa5a50000, 0xa0a05050, 0x5555a0a0,
    0x5a5a5050, 0xaa550000, 0xaa555500, 0xaaaa5500, 0x90909090, 0x94949494, 0xa4a4a4a4,
    0xa9a59450, 0x2a0a4250, 0xa5945040, 0x0a425054, 0xa5a5a500, 0x55a0a0a0, 0xa8a85454,
    0x6a6a4040, 0xa4a45000, 0x1a1a0500, 0x0050a4a4, 0xaaa59090, 0x14696914, 0x69691400,
    0xa08585a0, 0xaa821414, 0x50a4a450, 0x6a5a0200, 0xa9a58000, 0x5090a0a8, 0xa8a09050,
    0x24242424, 0x00aa5500, 0x24924924, 0x24499224, 0x50a50a50, 0x500aa550, 0xaaaa4444,
    0x66660000, 0xa5a0a5a0, 0x50a050a0, 0x69286928, 0x44aaaa44, 0x66666600, 0xaa444444,
    0x54a854a8, 0x95809580, 0x96969600, 0xa85454a8, 0x80959580, 0xaa141414, 0x96960000,
    0xaaaa1414, 0xa05050a0, 0xa0a5a5a0, 0x96000000, 0x40804080, 0xa9a8a9a8, 0xaaaaaa44,
    0x2a4a5254};
const uint8_t kA2[64] = {15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
                         15, 2,  8,  2,  2,  8,  8,  15, 2,  8,  2,  2,  8,  8,  2,  2,
                         15, 15, 6,  8,  2,  8,  15, 15, 2,  8,  2,  2,  2,  15, 15, 6,
                         6,  2,  6,  8,  15, 15, 2,  2,  15, 15, 15, 15, 15, 2,  2,  15};
const uint8_t kA3a[64] = {3,  3,  15, 15, 8,  3,  15, 15, 8,  8,  6,  6,  6,  5,  3,  3,
                          3,  3,  8,  15, 3,  3,  6,  10, 5,  8,  8,  6,  8,  5,  15, 15,
                          8,  15, 3,  5,  6,  10, 8,  15, 15, 3,  15, 5,  15, 15, 15, 15,
                          3,  15, 5,  5,  5,  8,  5,  10, 5,  10, 8,  13, 15, 12, 3,  3};
const uint8_t kA3b[64] = {15, 8,  8,  3,  15, 15, 3,  8,  15, 15, 15, 15, 15, 15, 15, 8,
                          15, 8,  15, 3,  15, 8,  15, 8,  3,  15, 6,  10, 15, 15, 10, 8,
                          15, 3,  15, 10, 10, 8,  9,  10, 6,  15, 8,  15, 3,  6,  6,  8,
                          15, 3,  15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 3,  15, 15, 8};
const uint8_t kW2[4] = {0, 21, 43, 64};
const uint8_t kW3[8] = {0, 9, 18, 27, 37, 46, 55, 64};
const uint8_t kW4[16] = {0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64};

const uint8_t* weights(int n) { return n == 2 ? kW2 : n == 3 ? kW3 : kW4; }

// Bits [at, at + n) of a 16-byte little-endian block, n <= 16.
inline uint32_t block_bits(const uint8_t* b, int at, int n) {
  uint32_t v = 0;
  for (int i = 0; i < n; ++i) v |= static_cast<uint32_t>((b[(at + i) >> 3] >> ((at + i) & 7)) & 1) << i;
  return v;
}

void bc7_block(Rgba* col, const uint8_t* src) {
  if (src[0] == 0) {
    for (int i = 0; i < 16; ++i) col[i] = Rgba{0, 0, 0, 255};
    return;
  }
  int mode = 0;
  while (!(src[0] & (1 << mode))) ++mode;
  const Bc7Mode& m = kBc7Modes[mode];
  int bit = mode + 1;
  auto take = [&](int n) {
    const uint32_t v = block_bits(src, bit, n);
    bit += n;
    return static_cast<int>(v);
  };
  const int partition = take(m.pb), rotation = take(m.rb), index_sel = take(m.isb);
  const int numep = 2 * m.ns;
  int ep[6][4];
  for (int c = 0; c < 3; ++c)
    for (int i = 0; i < numep; ++i) ep[i][c] = take(m.cb);
  for (int i = 0; i < numep; ++i) ep[i][3] = m.ab ? take(m.ab) : 255;
  const int bands = m.ab ? 4 : 3;
  int cb = m.cb, ab = m.ab;
  if (m.epb || m.spb) {
    ++cb;
    if (ab) ++ab;
  }
  if (m.epb) {
    for (int i = 0; i < numep; ++i) {
      const int p = take(1);
      for (int c = 0; c < bands; ++c) ep[i][c] = ep[i][c] << 1 | p;
    }
  }
  if (m.spb) {
    for (int i = 0; i < numep; i += 2) {
      const int p = take(1);
      for (int j = 0; j < 2; ++j)
        for (int c = 0; c < bands; ++c) ep[i + j][c] = ep[i + j][c] << 1 | p;
    }
  }
  for (int i = 0; i < numep; ++i) {
    for (int c = 0; c < bands; ++c) {
      const int b = c < 3 ? cb : ab;
      const int x = (ep[i][c] << (8 - b)) & 255;
      ep[i][c] = x | x >> b;
    }
  }
  const uint8_t* cw = weights(m.ib);
  const uint8_t* aw = weights(m.ab && m.ib2 ? m.ib2 : m.ib);
  int cbit = bit, abit = bit + 16 * m.ib - m.ns;
  for (int i = 0; i < 16; ++i) {
    const int s = m.ns == 2 ? (kP2[partition] >> i) & 1
                  : m.ns == 3 ? (kP3[partition] >> (2 * i)) & 3 : 0;
    const bool anchor = i == 0 || (m.ns == 2 && i == kA2[partition]) ||
                        (m.ns == 3 && (i == kA3a[partition] || i == kA3b[partition]));
    const int n0 = m.ib - anchor;
    const int i0 = static_cast<int>(block_bits(src, cbit, n0));
    cbit += n0;
    int s0 = cw[i0], s1 = cw[i0];
    if (m.ib2) {
      const int n1 = m.ib2 - (i == 0);
      const int i1 = static_cast<int>(block_bits(src, abit, n1));
      abit += n1;
      if (index_sel) {
        s0 = aw[i1];
        s1 = cw[i0];
      } else {
        s0 = cw[i0];
        s1 = aw[i1];
      }
    }
    const int* e0 = ep[2 * s];
    const int* e1 = ep[2 * s + 1];
    uint8_t px[4];
    for (int c = 0; c < 3; ++c) px[c] = static_cast<uint8_t>(((64 - s0) * e0[c] + s0 * e1[c] + 32) >> 6);
    px[3] = static_cast<uint8_t>(((64 - s1) * e0[3] + s1 * e1[3] + 32) >> 6);
    if (rotation) {
      const uint8_t t = px[rotation - 1];
      px[rotation - 1] = px[3];
      px[3] = t;
    }
    col[i] = Rgba{px[0], px[1], px[2], px[3]};
  }
}

// ---- BC6H -----------------------------------------------------------------------

// Per mode: its value, mode bits, transformed, endpoint bits, delta bits of
// r, g, b, then the header's fields in stream order, one byte each:
// endpoint << 6 | channel << 4 | bit (from utils/image_formats.BC6_MODES).
struct Bc6Mode {
  uint8_t mode, mode_bits, transformed, bits, delta[3], nfields;
  uint8_t fields[77];
};
const Bc6Mode kBc6Modes[14] = {
    {0x00, 2, 1, 10, {5, 5, 5}, 75,
     {148, 164, 228, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32,
      33, 34, 35, 36, 37, 38, 39, 40, 41, 64, 65, 66, 67, 68, 212, 144, 145, 146, 147, 80, 81,
      82, 83, 84, 224, 208, 209, 210, 211, 96, 97, 98, 99, 100, 225, 160, 161, 162, 163, 128,
      129, 130, 131, 132, 226, 192, 193, 194, 195, 196, 227}},
    {0x01, 2, 1, 7, {6, 6, 6}, 75,
     {149, 212, 213, 0, 1, 2, 3, 4, 5, 6, 224, 225, 164, 16, 17, 18, 19, 20, 21, 22, 165, 226,
      148, 32, 33, 34, 35, 36, 37, 38, 227, 229, 228, 64, 65, 66, 67, 68, 69, 144, 145, 146,
      147, 80, 81, 82, 83, 84, 85, 208, 209, 210, 211, 96, 97, 98, 99, 100, 101, 160, 161,
      162, 163, 128, 129, 130, 131, 132, 133, 192, 193, 194, 195, 196, 197}},
    {0x02, 5, 1, 11, {5, 4, 4}, 72,
     {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35,
      36, 37, 38, 39, 40, 41, 64, 65, 66, 67, 68, 10, 144, 145, 146, 147, 80, 81, 82, 83, 26,
      224, 208, 209, 210, 211, 96, 97, 98, 99, 42, 225, 160, 161, 162, 163, 128, 129, 130,
      131, 132, 226, 192, 193, 194, 195, 196, 227}},
    {0x06, 5, 1, 11, {4, 5, 4}, 72,
     {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35,
      36, 37, 38, 39, 40, 41, 64, 65, 66, 67, 10, 212, 144, 145, 146, 147, 80, 81, 82, 83, 84,
      26, 208, 209, 210, 211, 96, 97, 98, 99, 42, 225, 160, 161, 162, 163, 128, 129, 130, 131,
      224, 226, 192, 193, 194, 195, 148, 227}},
    {0x0a, 5, 1, 11, {4, 4, 5}, 72,
     {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35,
      36, 37, 38, 39, 40, 41, 64, 65, 66, 67, 10, 164, 144, 145, 146, 147, 80, 81, 82, 83, 26,
      224, 208, 209, 210, 211, 96, 97, 98, 99, 100, 42, 160, 161, 162, 163, 128, 129, 130,
      131, 225, 226, 192, 193, 194, 195, 228, 227}},
    {0x0e, 5, 1, 9, {5, 5, 5}, 72,
     {0, 1, 2, 3, 4, 5, 6, 7, 8, 164, 16, 17, 18, 19, 20, 21, 22, 23, 24, 148, 32, 33, 34, 35,
      36, 37, 38, 39, 40, 228, 64, 65, 66, 67, 68, 212, 144, 145, 146, 147, 80, 81, 82, 83,
      84, 224, 208, 209, 210, 211, 96, 97, 98, 99, 100, 225, 160, 161, 162, 163, 128, 129,
      130, 131, 132, 226, 192, 193, 194, 195, 196, 227}},
    {0x12, 5, 1, 8, {6, 5, 5}, 72,
     {0, 1, 2, 3, 4, 5, 6, 7, 212, 164, 16, 17, 18, 19, 20, 21, 22, 23, 226, 148, 32, 33, 34,
      35, 36, 37, 38, 39, 227, 228, 64, 65, 66, 67, 68, 69, 144, 145, 146, 147, 80, 81, 82,
      83, 84, 224, 208, 209, 210, 211, 96, 97, 98, 99, 100, 225, 160, 161, 162, 163, 128, 129,
      130, 131, 132, 133, 192, 193, 194, 195, 196, 197}},
    {0x16, 5, 1, 8, {5, 6, 5}, 72,
     {0, 1, 2, 3, 4, 5, 6, 7, 224, 164, 16, 17, 18, 19, 20, 21, 22, 23, 149, 148, 32, 33, 34,
      35, 36, 37, 38, 39, 213, 228, 64, 65, 66, 67, 68, 212, 144, 145, 146, 147, 80, 81, 82,
      83, 84, 85, 208, 209, 210, 211, 96, 97, 98, 99, 100, 225, 160, 161, 162, 163, 128, 129,
      130, 131, 132, 226, 192, 193, 194, 195, 196, 227}},
    {0x1a, 5, 1, 8, {5, 5, 6}, 72,
     {0, 1, 2, 3, 4, 5, 6, 7, 225, 164, 16, 17, 18, 19, 20, 21, 22, 23, 165, 148, 32, 33, 34,
      35, 36, 37, 38, 39, 229, 228, 64, 65, 66, 67, 68, 212, 144, 145, 146, 147, 80, 81, 82,
      83, 84, 224, 208, 209, 210, 211, 96, 97, 98, 99, 100, 101, 160, 161, 162, 163, 128, 129,
      130, 131, 132, 226, 192, 193, 194, 195, 196, 227}},
    {0x1e, 5, 0, 6, {6, 6, 6}, 72,
     {0, 1, 2, 3, 4, 5, 212, 224, 225, 164, 16, 17, 18, 19, 20, 21, 149, 165, 226, 148, 32,
      33, 34, 35, 36, 37, 213, 227, 229, 228, 64, 65, 66, 67, 68, 69, 144, 145, 146, 147, 80,
      81, 82, 83, 84, 85, 208, 209, 210, 211, 96, 97, 98, 99, 100, 101, 160, 161, 162, 163,
      128, 129, 130, 131, 132, 133, 192, 193, 194, 195, 196, 197}},
    {0x03, 5, 0, 10, {10, 10, 10}, 60,
     {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35,
      36, 37, 38, 39, 40, 41, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 80, 81, 82, 83, 84, 85,
      86, 87, 88, 89, 96, 97, 98, 99, 100, 101, 102, 103, 104, 105}},
    {0x07, 5, 1, 11, {9, 9, 9}, 60,
     {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35,
      36, 37, 38, 39, 40, 41, 64, 65, 66, 67, 68, 69, 70, 71, 72, 10, 80, 81, 82, 83, 84, 85,
      86, 87, 88, 26, 96, 97, 98, 99, 100, 101, 102, 103, 104, 42}},
    {0x0b, 5, 1, 12, {8, 8, 8}, 60,
     {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35,
      36, 37, 38, 39, 40, 41, 64, 65, 66, 67, 68, 69, 70, 71, 11, 10, 80, 81, 82, 83, 84, 85,
      86, 87, 27, 26, 96, 97, 98, 99, 100, 101, 102, 103, 43, 42}},
    {0x0f, 5, 1, 16, {4, 4, 4}, 60,
     {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 32, 33, 34, 35,
      36, 37, 38, 39, 40, 41, 64, 65, 66, 67, 15, 14, 13, 12, 11, 10, 80, 81, 82, 83, 31, 30,
      29, 28, 27, 26, 96, 97, 98, 99, 47, 46, 45, 44, 43, 42}},
};


int sext(int x, int bits) {
  x &= (1 << bits) - 1;
  return (x >> (bits - 1)) ? x - (1 << bits) : x;
}

int bc6_unquantize(int x, int bits, bool sign) {
  if (!sign) {
    if (bits >= 15 || x == 0) return x;
    if (x == (1 << bits) - 1) return 0xFFFF;
    return ((x << 15) + 0x4000) >> (bits - 1);
  }
  x = static_cast<int16_t>(static_cast<uint16_t>(x));  // kept as UINT16, read back as INT16
  if (bits >= 16) return x;
  int a = x < 0 ? -x : x;
  if (a) a = a >= (1 << (bits - 1)) - 1 ? 0x7FFF : ((a << 15) + 0x4000) >> (bits - 1);
  return x < 0 ? -a : a;
}

float half_to_float(uint16_t h) {
  const uint32_t sign = static_cast<uint32_t>(h & 0x8000) << 16;
  const uint32_t exp = (h >> 10) & 31, man = h & 1023;
  float f;
  if (exp == 0) {
    f = std::ldexp(static_cast<float>(man), -24);
    return sign ? -f : f;
  }
  uint32_t u = sign | (exp == 31 ? (0xFFu << 23) | (man << 13) : ((exp + 112) << 23) | (man << 13));
  memcpy(&f, &u, 4);
  return f;
}

uint8_t bc6_byte(int v, bool sign) {
  int h;
  if (sign) {
    h = v < 0 ? (0x8000 | ((-v * 31) >> 5)) : (v * 31) >> 5;
  } else {
    h = (v * 31) >> 6;
  }
  const float f = half_to_float(static_cast<uint16_t>(h & 0xFFFF));
  if (std::isnan(f) || f < 0.0f) return 0;
  if (f > 1.0f) return 255;
  return static_cast<uint8_t>(f * 255.0f);
}

void bc6_block(Rgba* col, const uint8_t* src, bool sign) {
  int mode = src[0] & 3;
  if (mode >= 2) mode = src[0] & 31;
  const Bc6Mode* m = nullptr;
  for (const Bc6Mode& x : kBc6Modes)
    if (x.mode == mode) m = &x;
  if (!m) {
    for (int i = 0; i < 16; ++i) col[i] = Rgba{0, 0, 0, 0};
    return;
  }
  const int ns = (mode == 0x03 || mode == 0x07 || mode == 0x0b || mode == 0x0f) ? 1 : 2;
  int ep[4][3] = {};
  int bit = m->mode_bits;
  for (int k = 0; k < m->nfields; ++k, ++bit) {
    const uint8_t f = m->fields[k];
    ep[f >> 6][(f >> 4) & 3] |= static_cast<int>(block_bits(src, bit, 1)) << (f & 15);
  }
  int partition = 0;
  if (ns == 2) {
    partition = static_cast<int>(block_bits(src, bit, 5));
    bit += 5;
  }
  const int bits = m->bits;
  if (sign)
    for (int c = 0; c < 3; ++c) ep[0][c] = sext(ep[0][c], bits);
  for (int e = 1; e < 2 * ns; ++e) {
    for (int c = 0; c < 3; ++c) {
      if (m->transformed) {
        ep[e][c] = (ep[0][c] + sext(ep[e][c], m->delta[c])) & ((1 << bits) - 1);
      } else if (sign) {
        ep[e][c] = sext(ep[e][c], bits);
      }
    }
  }
  int ue[4][3];
  for (int e = 0; e < 2 * ns; ++e)
    for (int c = 0; c < 3; ++c) ue[e][c] = bc6_unquantize(ep[e][c], bits, sign);
  const uint8_t* w = ns == 2 ? kW3 : kW4;
  for (int i = 0; i < 16; ++i) {
    const int s = ns == 2 ? (kP2[partition] >> i) & 1 : 0;
    const int n = (ns == 2 ? 3 : 4) - (i == 0 || (ns == 2 && i == kA2[partition]));
    const int wt = w[block_bits(src, bit, n)];
    bit += n;
    uint8_t px[3];
    for (int c = 0; c < 3; ++c)
      px[c] = bc6_byte((ue[2 * s][c] * (64 - wt) + ue[2 * s + 1][c] * wt) >> 6, sign);
    col[i] = Rgba{px[0], px[1], px[2], 0};
  }
}

void bcn_decode(const uint8_t* in, int64_t size, int n, bool sign, int64_t width, int64_t height,
                uint8_t* out) {
  static const int kBands[8] = {0, 4, 4, 4, 1, 3, 3, 4};
  if (n < 1 || n > 7 || width < 1 || height < 1) fail("bad BCn layout");
  const int bsize = (n == 1 || n == 4) ? 8 : 16, bands = kBands[n];
  const int64_t bw = (width + 3) / 4, bh = (height + 3) / 4;
  if (size < bw * bh * bsize) {
    char buf[128];
    snprintf(buf, sizeof buf, "image file is truncated (%lld of %lld bytes of blocks)",
             static_cast<long long>(size), static_cast<long long>(bw * bh * bsize));
    fail(buf);
  }
  Rgba col[16];
  for (int64_t k = 0; k < bw * bh; ++k) {
    const uint8_t* blk = in + k * bsize;
    memset(col, 0, sizeof col);
    switch (n) {
      case 1: bc1_colors(col, blk, false); break;
      case 2:
        bc1_colors(col, blk + 8, true);
        for (int i = 0; i < 16; ++i) {
          const int a = (blk[i >> 1] >> (4 * (i & 1))) & 15;
          col[i].a = static_cast<uint8_t>(a << 4 | a);
        }
        break;
      case 3:
        bc1_colors(col, blk + 8, true);
        bc3_alpha(&col[0].r, 4, 3, blk, false);
        break;
      case 4: bc3_alpha(&col[0].r, 4, 0, blk, false); break;
      case 5:
        bc3_alpha(&col[0].r, 4, 0, blk, sign);
        bc3_alpha(&col[0].r, 4, 1, blk + 8, sign);
        if (sign)
          for (int i = 0; i < 16; ++i) col[i].b = 128;
        break;
      case 6: bc6_block(col, blk, sign); break;
      default: bc7_block(col, blk); break;
    }
    const int64_t y0 = (k / bw) * 4, x0 = (k % bw) * 4;
    for (int i = 0; i < 16; ++i) {
      const int64_t y = y0 + i / 4, x = x0 + i % 4;
      if (y >= height || x >= width) continue;
      const uint8_t px[4] = {col[i].r, col[i].g, col[i].b, col[i].a};
      memcpy(out + (y * width + x) * bands, px, static_cast<size_t>(bands));
    }
  }
}

// ---- run lengths ------------------------------------------------------------------

[[noreturn]] void truncated(const char* what) {
  fail(std::string("image file is truncated (") + what + ")");
}

int64_t packbits_rows(const uint8_t* in, int64_t size, int64_t row_bytes, int64_t rows,
                      uint8_t* out) {
  int64_t p = 0;
  for (int64_t y = 0; y < rows; ++y) {
    uint8_t* row = out + y * row_bytes;
    int64_t x = 0;
    while (x < row_bytes) {
      if (p >= size) truncated("PackBits rows");
      const int c = in[p];
      if (c & 0x80) {
        if (c == 0x80) {
          ++p;
          continue;
        }
        if (p + 2 > size) truncated("PackBits rows");
        int64_t n = 257 - c;
        if (n > row_bytes - x) n = row_bytes - x;
        memset(row + x, in[p + 1], static_cast<size_t>(n));
        x += n;
        p += 2;
      } else {
        if (p + c + 2 > size) truncated("PackBits rows");
        int64_t n = c + 1;
        if (n > row_bytes - x) n = row_bytes - x;
        memcpy(row + x, in + p + 1, static_cast<size_t>(n));
        x += n;
        p += c + 2;
      }
    }
  }
  return p;
}

void sgi_rle(const uint8_t* file, int64_t size, int64_t width, int64_t height, int bands,
             int bpc, uint8_t* out) {
  const int64_t bufsize = size - 512, tab = bands * height;
  const int64_t row_bytes = width * bands * bpc;
  if (bufsize < 8 * tab) fail("buffer overrun when reading image file (SGI tables)");
  const uint8_t* buf = file + 512;
  auto be32 = [&](int64_t at) {
    return static_cast<uint32_t>(buf[at] << 24 | buf[at + 1] << 16 | buf[at + 2] << 8 |
                                 buf[at + 3]);
  };
  const int64_t last = bufsize - 1;
  std::vector<uint8_t> row(static_cast<size_t>(row_bytes), 0);
  memset(out, 0, static_cast<size_t>(row_bytes * height));
  for (int64_t r = 0; r < height; ++r) {
    for (int c = 0; c < bands; ++c) {
      const int64_t start = be32(4 * (r + c * height));
      // Pillow holds the length, which only bounds the steps, in an int.
      const int64_t n = static_cast<int32_t>(be32(4 * tab + 4 * (r + c * height)));
      if (start < 512) fail("buffer overrun when reading image file (SGI row)");
      int64_t src = start - 512, x = 0, dst = c * bpc;
      for (int64_t k = n; k > 0; --k) {
        if (src + bpc - 1 > last) fail("buffer overrun when reading image file (SGI row)");
        const int pixel = buf[src + bpc - 1];
        src += bpc;
        if (k == 1 && pixel != 0) return;  // Pillow's early end: the image stops here
        const int count = pixel & 0x7F;
        if (!count) break;
        if (x + count > width) fail("buffer overrun when reading image file (SGI row)");
        x += count;
        if (pixel & 0x80) {
          if (src + bpc * count > last) fail("buffer overrun when reading image file (SGI row)");
          for (int j = 0; j < count; ++j, src += bpc, dst += bands * bpc)
            memcpy(&row[static_cast<size_t>(dst)], buf + src, static_cast<size_t>(bpc));
        } else {
          if (src + 2 * (bpc - 1) > last)
            fail("buffer overrun when reading image file (SGI row)");
          for (int j = 0; j < count; ++j, dst += bands * bpc)
            memcpy(&row[static_cast<size_t>(dst)], buf + src, static_cast<size_t>(bpc));
          src += bpc;
        }
      }
    }
    memcpy(out + (height - 1 - r) * row_bytes, row.data(), static_cast<size_t>(row_bytes));
  }
}

int64_t pcx_rle(const uint8_t* in, int64_t size, int64_t row_bytes, int64_t width, int bits,
                int64_t rows, uint8_t* out) {
  int64_t p = 0;
  std::vector<uint8_t> buf(static_cast<size_t>(row_bytes), 0);
  for (int64_t y = 0; y < rows; ++y) {
    int64_t x = 0;
    while (x < row_bytes) {
      if (p >= size) truncated("PCX rows");
      const int c = in[p];
      if ((c & 0xC0) == 0xC0) {
        if (p + 2 > size) truncated("PCX rows");
        const int n = c & 0x3F;
        if (x + n > row_bytes) fail("buffer overrun when reading image file (a PCX run past its row)");
        memset(&buf[static_cast<size_t>(x)], in[p + 1], static_cast<size_t>(n));
        x += n;
        p += 2;
      } else {
        buf[static_cast<size_t>(x++)] = static_cast<uint8_t>(c);
        ++p;
      }
    }
    // PcxDecode moves the planes together: bit planes at 2 or 4 bits a
    // pixel, else planes of a row's width.
    int64_t plane = width, bands = row_bytes / width, stride = bands ? row_bytes / bands : 0;
    if (bits == 2 || bits == 4) {
      plane = (width + 7) / 8;
      bands = bits;
      stride = row_bytes / bands;
    }
    if (stride > plane)
      for (int64_t i = 1; i < bands; ++i)
        memmove(&buf[static_cast<size_t>(i * plane)], &buf[static_cast<size_t>(i * stride)],
                static_cast<size_t>(plane));
    memcpy(out + y * row_bytes, buf.data(), static_cast<size_t>(row_bytes));
  }
  return p;
}

int64_t sun_rle(const uint8_t* in, int64_t size, int64_t row_bytes, int64_t rows, uint8_t* out) {
  const int64_t total = row_bytes * rows;
  int64_t p = 0, o = 0;
  while (o < total) {
    if (p >= size) truncated("Sun raster runs");
    if (in[p] == 0x80) {
      if (p + 2 > size) truncated("Sun raster runs");
      if (in[p + 1] == 0) {
        out[o++] = 0x80;
        p += 2;
        continue;
      }
      if (p + 3 > size) truncated("Sun raster runs");
      int64_t n = in[p + 1] + 1;
      if (n > total - o) n = total - o;
      memset(out + o, in[p + 2], static_cast<size_t>(n));
      o += n;
      p += 3;
    } else {
      out[o++] = in[p++];
    }
  }
  return p;
}

}  // namespace

#define W3D_RASTER_GUARD(body)                 \
  try {                                        \
    body;                                      \
  } catch (const RasterError& e) {             \
    set_message(msg, msg_len, e.msg);          \
  } catch (const std::exception& e) {          \
    set_message(msg, msg_len, e.what());       \
  }                                            \
  return -1;

extern "C" {

int w3d_bcn_decode(const uint8_t* in, int64_t size, int32_t n, int32_t sign, int32_t width,
                   int32_t height, uint8_t* out, char* msg, int32_t msg_len) {
  W3D_RASTER_GUARD(bcn_decode(in, size, n, sign != 0, width, height, out); return 0)
}

int64_t w3d_packbits_rows(const uint8_t* in, int64_t size, int64_t row_bytes, int64_t rows,
                          uint8_t* out, char* msg, int32_t msg_len) {
  W3D_RASTER_GUARD(return packbits_rows(in, size, row_bytes, rows, out))
}

int w3d_sgi_rle(const uint8_t* file, int64_t size, int64_t width, int64_t height, int32_t bands,
                int32_t bpc, uint8_t* out, char* msg, int32_t msg_len) {
  W3D_RASTER_GUARD(sgi_rle(file, size, width, height, bands, bpc, out); return 0)
}

int64_t w3d_pcx_rle(const uint8_t* in, int64_t size, int64_t row_bytes, int64_t width,
                    int32_t bits, int64_t rows, uint8_t* out, char* msg, int32_t msg_len) {
  W3D_RASTER_GUARD(return pcx_rle(in, size, row_bytes, width, bits, rows, out))
}

int64_t w3d_sun_rle(const uint8_t* in, int64_t size, int64_t row_bytes, int64_t rows,
                    uint8_t* out, char* msg, int32_t msg_len) {
  W3D_RASTER_GUARD(return sun_rle(in, size, row_bytes, rows, out))
}

}  // extern "C"
