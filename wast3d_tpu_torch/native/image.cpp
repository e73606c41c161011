// wast3d_tpu_torch native image code: the byte loops of the image readers
// (PNG unfiltering and de-interlacing, sub-byte unpacking, BMP run lengths,
// TIFF LZW, PackBits and CCITT, TIFF YCbCr -> RGB, TGA run lengths, QOI) and PIL's bicubic resize of
// 8-bit images.
//
// Datasets ship PNG, JPEG, BMP and TIFF images and the card's machine has no
// PIL. `utils/png.py` and `utils/image_io.py` parse the headers, inflate
// zlib data and turn samples into PIL's arrays with numpy; every loop that
// walks the bytes one at a time is here. Average and Paeth rows depend on
// the pixel just decoded, so numpy walks them a pixel at a time, and a
// Blender view (libpng's adaptive filters) took seconds a megapixel that way.
// Each routine has a plain numpy / Python version beside its caller that the
// tests hold it to.
//
//   w3d_png_unfilter: the five row filters of the PNG specification (None,
//     Sub, Up, Average, Paeth) over bytes per pixel = max(1, bits x channels
//     / 8), bit depths 1, 2, 4, 8 and 16; with `interlaced` the seven Adam7
//     passes, each its own sub-image with its own filter bytes (an empty
//     pass has no bytes), scattered into place. Out: 1-, 2- and 4-bit samples
//     one byte each (their values), 8- and 16-bit samples as stored (16-bit
//     big-endian).
//   w3d_unpack_bits: rows of 1-, 2- or 4-bit samples packed from the most
//     significant bit, one byte per sample out.
//   w3d_bmp_rle: BMP RLE8 / RLE4 as Pillow's BmpRleDecoder reads them
//     (rows in file order, a run clipped to its row, absolute runs padded
//     to an even file offset, deltas and ends of line filled with zeros).
//   w3d_lzw_decode: TIFF LZW as libtiff's LZWDecode reads it (codes from the
//     most significant bit, 9 to 12 bits, widened one code early; Clear 256
//     first, EOI 257; a code past the table, or a table that runs past 5119
//     entries, is an error); stops once `out_size` bytes are out.
//   w3d_packbits_decode: TIFF PackBits.
//   w3d_tga_rle: TGA run-length packets as Pillow's TgaRleDecode reads them,
//     rows of `row_bytes` in file order.
//   w3d_qoi_decode: a QOI file's ops as Pillow's QoiDecoder reads them, RGB or
//     RGBA by `channels`.
//   w3d_ccitt_decode: one strip or tile of TIFF CCITT data -> rows of
//     packed bits (from the most significant bit, a row padded to a byte; 1
//     for a "black" run, the codec's second colour). `mode` is the TIFF
//     Compression: 2 (Modified Huffman: one-dimensional rows, each starting
//     on a byte, no EOL), 3 (T.4: an EOL before each row, found as libtiff's
//     SYNC_EOL finds it; with `options` bit 0 a tag bit after it chooses a
//     one- or two-dimensional row) or 4 (T.6: two-dimensional rows against
//     the previous row, the first against a white row, no EOL). Bits are
//     taken as libtiff's accumulator takes them, zero-padded at the end of
//     the data (see FaxBits). A one-dimensional row alternates white and
//     black runs (make-up codes, then a terminating code each) until it
//     fills the row, and is cut back or padded as libtiff's CLEANUP_RUNS
//     does when a code is bad or an EOL comes early; a two-dimensional row
//     codes each change against the reference row (pass, horizontal,
//     vertical -3..+3), and a bad code there, an extension, a run past the
//     row or data that ends before the last row is an error.
//   w3d_ycbcr_to_rgb: libtiff's RGBA reader on 8-bit chunky YCbCr
//     (tif_getimage.c's putcontig8bitYCbCr*tile): data units of sh x sv luma
//     samples, then Cb and Cr; each pixel of a width x rows segment takes
//     its luma sample and its unit's chroma through TIFFYCbCrtoRGB with the
//     int32 [5, 256] tables given (Y_tab, Cr_r_tab, Cb_b_tab, Cr_g_tab,
//     Cb_g_tab of TIFFYCbCrToRGBInit). sh = sv = 1 is also the
//     separate-planes case, one unit a pixel.
//   w3d_resize_u8: Pillow's ImagingResample for 8-bit images with its
//     default filter (bicubic, a = -0.5; src/libImaging/Resample.c):
//     weights computed in double as precompute_coeffs does, normalised,
//     turned into 22-bit fixed point rounding half away from zero; the
//     horizontal pass first, rounded and clipped to uint8, then the vertical
//     pass; an axis whose size does not change is skipped. Premultiplying
//     images with alpha stays in Python (`utils/png._premultiplied`).
//
// C ABI (ctypes); each returns 0 (w3d_bmp_rle, w3d_lzw_decode,
// w3d_packbits_decode: the bytes written; w3d_tga_rle: the bytes read) on
// success and -1 on failure, with
// a NUL-terminated reason in msg:
//   w3d_png_unfilter(raw, raw_size, height, width, channels, bits, interlaced,
//                    out, msg, msg_len)
//   w3d_unpack_bits(in, rows, row_bytes, width, bits, out, msg, msg_len)
//   w3d_bmp_rle(file, size, start, width, height, rle4, out, msg, msg_len)
//   w3d_lzw_decode(in, size, out, out_size, msg, msg_len)
//   w3d_packbits_decode(in, size, out, out_size, msg, msg_len)
//   w3d_tga_rle(in, size, depth, row_bytes, rows, out, msg, msg_len)
//   w3d_qoi_decode(in, size, pixels, channels, out, msg, msg_len)
//   w3d_resize_u8(in, height, width, channels, out, out_height, out_width,
//                 msg, msg_len)                    out: out_height x out_width x channels
//   w3d_ccitt_decode(in, size, mode, options, width, rows, out, msg, msg_len)
//   w3d_ycbcr_to_rgb(units, size, sh, sv, width, rows, tables, out, msg, msg_len)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <exception>
#include <string>
#include <vector>

namespace {

struct ImageError {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw ImageError{msg}; }

void set_message(char* msg, int32_t len, const std::string& s) {
  if (!msg || len <= 0) return;
  snprintf(msg, static_cast<size_t>(len), "%s", s.c_str());
}

// ---- PNG ------------------------------------------------------------------

inline int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

// Sample x of a row of `bits`-bit samples packed from the high bit.
inline uint8_t packed(const uint8_t* row, int64_t x, int bits) {
  const int64_t bit = x * bits;
  return static_cast<uint8_t>((row[bit >> 3] >> (8 - bits - (bit & 7))) & ((1 << bits) - 1));
}

// Unfilter `h` scanlines of `stride` bytes (`bpp` bytes a pixel for the
// filters) from `in`, each row a filter byte and then its bytes, into `rows`
// (h x stride). Returns the bytes read.
size_t unfilter(const uint8_t* in, size_t avail, int64_t h, int64_t stride, int bpp,
                uint8_t* rows) {
  const size_t need = static_cast<size_t>(h) * static_cast<size_t>(1 + stride);
  if (need > avail) fail("PNG image data too short");
  std::vector<uint8_t> zero(static_cast<size_t>(stride), 0);
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* row = in + static_cast<size_t>(y) * (1 + stride);
    const int f = row[0];
    const uint8_t* s = row + 1;
    uint8_t* c = rows + y * stride;
    const uint8_t* u = y ? c - stride : zero.data();
    switch (f) {
      case 0:
        memcpy(c, s, static_cast<size_t>(stride));
        break;
      case 1:
        for (int64_t i = 0; i < stride; ++i) c[i] = static_cast<uint8_t>(s[i] + (i >= bpp ? c[i - bpp] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < stride; ++i) c[i] = static_cast<uint8_t>(s[i] + u[i]);
        break;
      case 3:
        for (int64_t i = 0; i < stride; ++i) {
          int left = i >= bpp ? c[i - bpp] : 0;
          c[i] = static_cast<uint8_t>(s[i] + ((left + u[i]) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < stride; ++i) {
          int left = i >= bpp ? c[i - bpp] : 0;
          int upleft = i >= bpp ? u[i - bpp] : 0;
          c[i] = static_cast<uint8_t>(s[i] + paeth(left, u[i], upleft));
        }
        break;
      default:
        fail("bad PNG filter type " + std::to_string(f));
    }
  }
  return need;
}

// One (sub-)image of h x w pixels into `out` at row stride `out_stride`
// and pixel step `out_step` (bytes); `pix` bytes a pixel out.
size_t png_image(const uint8_t* in, size_t avail, int64_t h, int64_t w, int c, int bits,
                 uint8_t* out, int64_t out_stride, int64_t out_step) {
  const int64_t stride = (w * c * bits + 7) / 8;
  const int bpp = std::max(1, c * bits / 8);
  const int64_t pix = bits < 8 ? 1 : c * bits / 8;
  std::vector<uint8_t> rows(static_cast<size_t>(h * stride));
  const size_t used = unfilter(in, avail, h, stride, bpp, rows.data());
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* r = rows.data() + y * stride;
    uint8_t* o = out + y * out_stride;
    if (bits < 8) {
      for (int64_t x = 0; x < w; ++x) o[x * out_step] = packed(r, x, bits);
    } else if (out_step == pix) {
      memcpy(o, r, static_cast<size_t>(stride));
    } else {
      for (int64_t x = 0; x < w; ++x) memcpy(o + x * out_step, r + x * pix, static_cast<size_t>(pix));
    }
  }
  return used;
}

void png_unfilter(const uint8_t* raw, size_t size, int64_t h, int64_t w, int c, int bits,
                  bool interlaced, uint8_t* out) {
  if (h < 1 || w < 1 || c < 1 || c > 4) fail("bad PNG size or channel count");
  if (!(bits == 1 || bits == 2 || bits == 4 || bits == 8 || bits == 16) || (bits < 8 && c != 1)) {
    fail("bad PNG bit depth " + std::to_string(bits) + " for " + std::to_string(c) + " channels");
  }
  const int64_t pix = bits < 8 ? 1 : c * bits / 8;
  const int64_t row = w * pix;
  if (!interlaced) {
    size_t used = png_image(raw, size, h, w, c, bits, out, row, pix);
    if (used != size) fail("PNG image data has trailing bytes");
    return;
  }
  static const int kPass[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8}, {2, 0, 4, 4},
                                  {0, 2, 2, 4}, {1, 0, 2, 2}, {0, 1, 1, 2}};
  size_t pos = 0;
  for (const auto& p : kPass) {
    const int x0 = p[0], y0 = p[1], dx = p[2], dy = p[3];
    const int64_t ph = h > y0 ? (h - y0 + dy - 1) / dy : 0;
    const int64_t pw = w > x0 ? (w - x0 + dx - 1) / dx : 0;
    if (ph == 0 || pw == 0) continue;
    pos += png_image(raw + pos, size - pos, ph, pw, c, bits, out + y0 * row + x0 * pix, dy * row,
                     dx * pix);
  }
  if (pos != size) fail("PNG image data has trailing bytes");
}

void unpack_bits(const uint8_t* in, int64_t rows, int64_t row_bytes, int64_t w, int bits,
                 uint8_t* out) {
  if (!(bits == 1 || bits == 2 || bits == 4)) fail("bad packed sample size " + std::to_string(bits));
  if ((w * bits + 7) / 8 > row_bytes) fail("packed rows shorter than their width");
  for (int64_t y = 0; y < rows; ++y) {
    for (int64_t x = 0; x < w; ++x) out[y * w + x] = packed(in + y * row_bytes, x, bits);
  }
}

// ---- BMP run lengths: Pillow's BmpRleDecoder ---------------------------------

// `in` is the whole file and the pixels start at `start`: absolute runs are
// padded to an even offset in the file, as Pillow pads them.
int64_t bmp_rle(const uint8_t* in, size_t size, size_t start, int64_t w, int64_t h, bool rle4,
                uint8_t* out) {
  if (w < 1 || h < 1) fail("bad BMP size");
  const int64_t total = w * h;
  int64_t n = 0, x = 0;
  size_t pos = start;
  auto put = [&](uint8_t v) {  // Pillow appends past the image and then cuts
    if (n < total) out[n] = v;
    ++n;
  };
  while (n < total) {
    if (pos + 2 > size) break;
    int count = in[pos], byte = in[pos + 1];
    pos += 2;
    if (count) {
      if (x + count > w) count = static_cast<int>(std::max<int64_t>(0, w - x));
      for (int i = 0; i < count; ++i) put(rle4 ? (i % 2 ? byte & 15 : byte >> 4) : byte);
      x += count;
    } else if (byte == 0) {  // end of line
      while (n % w) put(0);
      x = 0;
    } else if (byte == 1) {  // end of bitmap
      break;
    } else if (byte == 2) {  // delta: Pillow reads two bytes, then two more
      if (pos + 2 > size) break;
      pos += 2;
      if (pos + 2 > size) break;
      const int64_t right = in[pos], up = in[pos + 1];
      pos += 2;
      for (int64_t i = 0; i < right + up * w; ++i) put(0);
      x = n % w;
    } else {  // absolute run, padded to a 16-bit word
      const size_t want = rle4 ? byte / 2 : byte;
      const size_t got = std::min(want, size - pos);
      for (size_t i = 0; i < got; ++i) {
        const uint8_t v = in[pos + i];
        if (rle4) {
          put(v >> 4);
          put(v & 15);
        } else {
          put(v);
        }
      }
      pos += got;
      if (got < want) break;
      x += byte;
      if (pos % 2) ++pos;
    }
  }
  return std::min(n, total);
}

// ---- TIFF LZW and PackBits ---------------------------------------------------

int64_t lzw_decode(const uint8_t* in, size_t size, uint8_t* out, int64_t out_size) {
  if (size >= 2 && in[0] == 0 && (in[1] & 1)) fail("old-style (LSB-first) TIFF LZW is not supported");
  // libtiff's table: 12-bit codes, entries counted on to 5119 (unreachable
  // past 4095), after which the next code that adds one is an error.
  const int kEnd = 4096 + 1023;
  std::vector<int32_t> prefix(kEnd);
  std::vector<uint8_t> suffix(kEnd), first(kEnd);
  std::vector<int32_t> length(kEnd, 0);
  for (int i = 0; i < 256; ++i) {
    prefix[i] = -1;
    suffix[i] = first[i] = static_cast<uint8_t>(i);
    length[i] = 1;
  }
  std::vector<uint8_t> stack(4096);
  int64_t n = 0;
  int next = 258, width = 9, old = -2;  // -2: no Clear yet, -1: just cleared
  uint64_t buf = 0;
  int have = 0;
  size_t pos = 0;
  while (n < out_size) {
    while (have < width && pos < size) {
      buf = (buf << 8) | in[pos++];
      have += 8;
    }
    if (have < width) break;  // data ends without EOI, as libtiff allows
    const int code = static_cast<int>((buf >> (have - width)) & ((1u << width) - 1));
    have -= width;
    if (code == 257) break;
    if (code == 256) {
      std::fill(length.begin() + 258, length.end(), 0);
      next = 258;
      width = 9;
      old = -1;
      continue;
    }
    if (old == -2) fail("corrupt LZW data (a strip must start with a Clear code)");
    int cur = code;
    if (old == -1) {
      if (code > 256) fail("corrupt LZW data (code " + std::to_string(code) + " after Clear)");
    } else {
      if (next >= kEnd) fail("corrupt LZW data (the table overflows without a Clear code)");
      prefix[next] = old;
      first[next] = first[old];
      length[next] = length[old] + 1;
      suffix[next] = code < next ? first[code] : first[old];
      ++next;
      if (length[code] == 0) {
        fail("corrupt LZW data (code " + std::to_string(code) + " not yet in the table)");
      }
      if (next > (1 << width) - 2 && width < 12) ++width;  // early change
    }
    int k = length[cur];
    for (int c = cur, i = k - 1; i >= 0; --i, c = prefix[c]) stack[i] = suffix[c];
    for (int i = 0; i < k && n < out_size; ++i) out[n++] = stack[i];
    old = cur;
  }
  return n;
}

int64_t packbits_decode(const uint8_t* in, size_t size, uint8_t* out, int64_t out_size) {
  int64_t n = 0;
  size_t pos = 0;
  while (pos < size && n < out_size) {
    const int c = static_cast<int8_t>(in[pos++]);
    if (c >= 0) {
      for (int i = 0; i <= c && pos < size && n < out_size; ++i) out[n++] = in[pos++];
    } else if (c != -128) {
      if (pos >= size) break;
      const uint8_t v = in[pos++];
      for (int i = 0; i < 1 - c && n < out_size; ++i) out[n++] = v;
    }
  }
  return n;
}

// ---- resize -----------------------------------------------------------------

constexpr int kPrecisionBits = 22;

double bicubic(double x) {
  const double a = -0.5;
  if (x < 0.0) x = -x;
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1;
  if (x < 2.0) return (((x - 5) * x + 8) * x - 4) * a;
  return 0.0;
}

struct Coeffs {
  int ksize = 0;
  std::vector<int> xmin, count;
  std::vector<int32_t> k;  // n_out x ksize
};

Coeffs coeffs(int n_in, int n_out) {
  Coeffs r;
  const double scale = static_cast<double>(n_in) / n_out;
  const double fs = scale < 1.0 ? 1.0 : scale;
  const double support = 2.0 * fs;
  const double ss = 1.0 / fs;
  r.ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  r.xmin.resize(n_out);
  r.count.resize(n_out);
  r.k.assign(static_cast<size_t>(n_out) * r.ksize, 0);
  std::vector<double> w(r.ksize);
  for (int xx = 0; xx < n_out; ++xx) {
    const double center = (xx + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > n_in) xmax = n_in;
    xmax -= xmin;
    double ww = 0.0;
    for (int x = 0; x < xmax; ++x) {
      w[x] = bicubic((x + xmin - center + 0.5) * ss);
      ww += w[x];
    }
    int32_t* k = r.k.data() + static_cast<size_t>(xx) * r.ksize;
    for (int x = 0; x < xmax; ++x) {
      const double v = ww != 0.0 ? w[x] / ww : w[x];
      k[x] = static_cast<int32_t>(v < 0 ? -0.5 + v * (1 << kPrecisionBits)
                                        : 0.5 + v * (1 << kPrecisionBits));
    }
    r.xmin[xx] = xmin;
    r.count[xx] = xmax;
  }
  return r;
}

inline uint8_t clip8(int64_t s) {
  s >>= kPrecisionBits;
  return static_cast<uint8_t>(s < 0 ? 0 : s > 255 ? 255 : s);
}

// Horizontal pass over `rows` rows starting at row `y0` of `in` (w x c).
void horizontal(const uint8_t* in, int w, int c, int y0, int rows, const Coeffs& k, int out_w,
                uint8_t* out) {
  for (int y = 0; y < rows; ++y) {
    const uint8_t* src = in + static_cast<size_t>(y0 + y) * w * c;
    uint8_t* dst = out + static_cast<size_t>(y) * out_w * c;
    for (int xx = 0; xx < out_w; ++xx) {
      const int32_t* kk = k.k.data() + static_cast<size_t>(xx) * k.ksize;
      const uint8_t* s = src + static_cast<size_t>(k.xmin[xx]) * c;
      for (int ch = 0; ch < c; ++ch) {
        int64_t acc = int64_t(1) << (kPrecisionBits - 1);
        for (int x = 0; x < k.count[xx]; ++x) acc += static_cast<int64_t>(s[x * c + ch]) * kk[x];
        dst[xx * c + ch] = clip8(acc);
      }
    }
  }
}

void vertical(const uint8_t* in, int w, int c, int y_offset, const Coeffs& k, int out_h,
              uint8_t* out) {
  const size_t row = static_cast<size_t>(w) * c;
  std::vector<int64_t> acc(row);
  for (int yy = 0; yy < out_h; ++yy) {
    const int32_t* kk = k.k.data() + static_cast<size_t>(yy) * k.ksize;
    std::fill(acc.begin(), acc.end(), int64_t(1) << (kPrecisionBits - 1));
    for (int y = 0; y < k.count[yy]; ++y) {
      const uint8_t* s = in + static_cast<size_t>(k.xmin[yy] - y_offset + y) * row;
      const int64_t wt = kk[y];
      for (size_t i = 0; i < row; ++i) acc[i] += s[i] * wt;
    }
    uint8_t* dst = out + static_cast<size_t>(yy) * row;
    for (size_t i = 0; i < row; ++i) dst[i] = clip8(acc[i]);
  }
}

void resize_u8(const uint8_t* in, int h, int w, int c, uint8_t* out, int oh, int ow) {
  if (h < 1 || w < 1 || oh < 1 || ow < 1 || c < 1 || c > 4) fail("bad resize size or channels");
  const bool need_h = ow != w, need_v = oh != h;
  if (!need_h && !need_v) {
    memcpy(out, in, static_cast<size_t>(h) * w * c);
    return;
  }
  if (!need_v) {
    horizontal(in, w, c, 0, h, coeffs(w, ow), ow, out);
    return;
  }
  Coeffs kv = coeffs(h, oh);
  if (!need_h) {
    vertical(in, w, c, 0, kv, oh, out);
    return;
  }
  // Only the rows the vertical pass reads go through the horizontal one.
  const int first = kv.xmin[0];
  const int last = kv.xmin[oh - 1] + kv.count[oh - 1];
  std::vector<uint8_t> tmp(static_cast<size_t>(last - first) * ow * c);
  horizontal(in, w, c, first, last - first, coeffs(w, ow), ow, tmp.data());
  vertical(tmp.data(), ow, c, first, kv, oh, out);
}

// ---- TGA run lengths and QOI ------------------------------------------------

// Pillow's TgaRleDecode.c: a header byte, then one pixel repeated (high bit
// set) or that many pixels as stored, 1 to 128 pixels of `depth` bytes. A
// literal may run on into the next row; a repeat past the end of its row is
// Pillow's overrun. Returns the bytes of data read.
int64_t tga_rle(const uint8_t* in, int64_t size, int depth, int64_t row_bytes, int64_t rows,
                uint8_t* out) {
  if (depth < 1 || row_bytes < 1 || rows < 1 || row_bytes % depth) fail("bad TGA run-length shape");
  const int64_t total = row_bytes * rows;
  int64_t pos = 0, done = 0;
  while (done < total && pos < size) {
    const int head = in[pos];
    const int64_t n = static_cast<int64_t>(depth) * ((head & 0x7F) + 1);
    if (head & 0x80) {
      if (pos + 1 + depth > size) break;
      if (done % row_bytes + n > row_bytes) {
        fail("a TGA run passes the end of its row (PIL: buffer overrun)");
      }
      for (int64_t i = 0; i < n; i += depth) memcpy(out + done + i, in + pos + 1, depth);
      pos += 1 + depth;
      done += n;
    } else {
      if (pos + 1 + n > size) break;
      const int64_t m = std::min(n, total - done);
      memcpy(out + done, in + pos + 1, static_cast<size_t>(m));
      pos += 1 + n;
      done += m;
    }
  }
  if (done < total) {
    fail("TGA run-length data truncated (" + std::to_string(done) + " of " +
         std::to_string(total) + " bytes)");
  }
  return pos;
}

// Pillow's QoiDecoder: the index starts at zeros (an unseen slot reads as 0,
// 0, 0, 0), every op but a run stores its pixel there, the previous pixel
// starts at 0, 0, 0, 255, a run may pass the last pixel (the rest is
// dropped), and the end marker is not read.
void qoi_decode(const uint8_t* in, int64_t size, int64_t pixels, int channels, uint8_t* out) {
  if (channels != 3 && channels != 4) fail("QOI output must have 3 or 4 channels");
  uint8_t index[64][4] = {};
  uint8_t prev[4] = {0, 0, 0, 255};
  int64_t pos = 0, done = 0;
  auto need = [&](int64_t n) {
    if (pos + n > size) {
      fail("QOI data truncated (" + std::to_string(done) + " of " + std::to_string(pixels) +
           " pixels)");
    }
  };
  while (done < pixels) {
    need(1);
    const int b = in[pos++];
    uint8_t px[4];
    if (b == 0xFE || b == 0xFF) {  // RGB keeps the previous alpha
      const int n = b == 0xFE ? 3 : 4;
      need(n);
      px[3] = prev[3];
      memcpy(px, in + pos, n);
      pos += n;
    } else if ((b >> 6) == 0) {
      memcpy(px, index[b], 4);
    } else if ((b >> 6) == 1) {
      px[0] = static_cast<uint8_t>(prev[0] + ((b >> 4) & 3) - 2);
      px[1] = static_cast<uint8_t>(prev[1] + ((b >> 2) & 3) - 2);
      px[2] = static_cast<uint8_t>(prev[2] + (b & 3) - 2);
      px[3] = prev[3];
    } else if ((b >> 6) == 2) {
      need(1);
      const int b2 = in[pos++];
      const int dg = (b & 0x3F) - 32;
      px[0] = static_cast<uint8_t>(prev[0] + dg + ((b2 >> 4) & 15) - 8);
      px[1] = static_cast<uint8_t>(prev[1] + dg);
      px[2] = static_cast<uint8_t>(prev[2] + dg + (b2 & 15) - 8);
      px[3] = prev[3];
    } else {
      for (int r = (b & 0x3F) + 1; r > 0 && done < pixels; --r, ++done) {
        memcpy(out + done * channels, prev, static_cast<size_t>(channels));
      }
      continue;
    }
    memcpy(prev, px, 4);
    memcpy(index[(px[0] * 3 + px[1] * 5 + px[2] * 7 + px[3] * 11) % 64], px, 4);
    memcpy(out + done * channels, px, static_cast<size_t>(channels));
    ++done;
  }
}

// ---- TIFF: CCITT bilevel (libtiff tif_fax3.c) and YCbCr -> RGB (tif_getimage.c) --
// T.4's run-length codes: (length, code bits, run). Runs 0-63 terminate a
// run; 64-1728 are each colour's make-up codes; 1792-2560 are shared.
struct Code {
  int len, bits, run;
};

const Code kWhite[] = {
    {8, 0x35, 0}, {6, 0x7, 1}, {4, 0x7, 2}, {4, 0x8, 3}, {4, 0xB, 4}, {4, 0xC, 5}, {4, 0xE, 6},
    {4, 0xF, 7}, {5, 0x13, 8}, {5, 0x14, 9}, {5, 0x7, 10}, {5, 0x8, 11}, {6, 0x8, 12},
    {6, 0x3, 13}, {6, 0x34, 14}, {6, 0x35, 15}, {6, 0x2A, 16}, {6, 0x2B, 17}, {7, 0x27, 18},
    {7, 0xC, 19}, {7, 0x8, 20}, {7, 0x17, 21}, {7, 0x3, 22}, {7, 0x4, 23}, {7, 0x28, 24},
    {7, 0x2B, 25}, {7, 0x13, 26}, {7, 0x24, 27}, {7, 0x18, 28}, {8, 0x2, 29}, {8, 0x3, 30},
    {8, 0x1A, 31}, {8, 0x1B, 32}, {8, 0x12, 33}, {8, 0x13, 34}, {8, 0x14, 35}, {8, 0x15, 36},
    {8, 0x16, 37}, {8, 0x17, 38}, {8, 0x28, 39}, {8, 0x29, 40}, {8, 0x2A, 41}, {8, 0x2B, 42},
    {8, 0x2C, 43}, {8, 0x2D, 44}, {8, 0x4, 45}, {8, 0x5, 46}, {8, 0xA, 47}, {8, 0xB, 48},
    {8, 0x52, 49}, {8, 0x53, 50}, {8, 0x54, 51}, {8, 0x55, 52}, {8, 0x24, 53}, {8, 0x25, 54},
    {8, 0x58, 55}, {8, 0x59, 56}, {8, 0x5A, 57}, {8, 0x5B, 58}, {8, 0x4A, 59}, {8, 0x4B, 60},
    {8, 0x32, 61}, {8, 0x33, 62}, {8, 0x34, 63}, {5, 0x1B, 64}, {5, 0x12, 128},
    {6, 0x17, 192}, {7, 0x37, 256}, {8, 0x36, 320}, {8, 0x37, 384}, {8, 0x64, 448},
    {8, 0x65, 512}, {8, 0x68, 576}, {8, 0x67, 640}, {9, 0xCC, 704}, {9, 0xCD, 768},
    {9, 0xD2, 832}, {9, 0xD3, 896}, {9, 0xD4, 960}, {9, 0xD5, 1024}, {9, 0xD6, 1088},
    {9, 0xD7, 1152}, {9, 0xD8, 1216}, {9, 0xD9, 1280}, {9, 0xDA, 1344}, {9, 0xDB, 1408},
    {9, 0x98, 1472}, {9, 0x99, 1536}, {9, 0x9A, 1600}, {6, 0x18, 1664}, {9, 0x9B, 1728}};
const Code kBlack[] = {
    {10, 0x37, 0}, {3, 0x2, 1}, {2, 0x3, 2}, {2, 0x2, 3}, {3, 0x3, 4}, {4, 0x3, 5},
    {4, 0x2, 6}, {5, 0x3, 7}, {6, 0x5, 8}, {6, 0x4, 9}, {7, 0x4, 10}, {7, 0x5, 11},
    {7, 0x7, 12}, {8, 0x4, 13}, {8, 0x7, 14}, {9, 0x18, 15}, {10, 0x17, 16}, {10, 0x18, 17},
    {10, 0x8, 18}, {11, 0x67, 19}, {11, 0x68, 20}, {11, 0x6C, 21}, {11, 0x37, 22},
    {11, 0x28, 23}, {11, 0x17, 24}, {11, 0x18, 25}, {12, 0xCA, 26}, {12, 0xCB, 27},
    {12, 0xCC, 28}, {12, 0xCD, 29}, {12, 0x68, 30}, {12, 0x69, 31}, {12, 0x6A, 32},
    {12, 0x6B, 33}, {12, 0xD2, 34}, {12, 0xD3, 35}, {12, 0xD4, 36}, {12, 0xD5, 37},
    {12, 0xD6, 38}, {12, 0xD7, 39}, {12, 0x6C, 40}, {12, 0x6D, 41}, {12, 0xDA, 42},
    {12, 0xDB, 43}, {12, 0x54, 44}, {12, 0x55, 45}, {12, 0x56, 46}, {12, 0x57, 47},
    {12, 0x64, 48}, {12, 0x65, 49}, {12, 0x52, 50}, {12, 0x53, 51}, {12, 0x24, 52},
    {12, 0x37, 53}, {12, 0x38, 54}, {12, 0x27, 55}, {12, 0x28, 56}, {12, 0x58, 57},
    {12, 0x59, 58}, {12, 0x2B, 59}, {12, 0x2C, 60}, {12, 0x5A, 61}, {12, 0x66, 62},
    {12, 0x67, 63}, {10, 0xF, 64}, {12, 0xC8, 128}, {12, 0xC9, 192}, {12, 0x5B, 256},
    {12, 0x33, 320}, {12, 0x34, 384}, {12, 0x35, 448}, {13, 0x6C, 512}, {13, 0x6D, 576},
    {13, 0x4A, 640}, {13, 0x4B, 704}, {13, 0x4C, 768}, {13, 0x4D, 832}, {13, 0x72, 896},
    {13, 0x73, 960}, {13, 0x74, 1024}, {13, 0x75, 1088}, {13, 0x76, 1152}, {13, 0x77, 1216},
    {13, 0x52, 1280}, {13, 0x53, 1344}, {13, 0x54, 1408}, {13, 0x55, 1472}, {13, 0x5A, 1536},
    {13, 0x5B, 1600}, {13, 0x64, 1664}, {13, 0x65, 1728}};
const Code kShared[] = {
    {11, 0x8, 1792}, {11, 0xC, 1856}, {11, 0xD, 1920}, {12, 0x12, 1984}, {12, 0x13, 2048},
    {12, 0x14, 2112}, {12, 0x15, 2176}, {12, 0x16, 2240}, {12, 0x17, 2304}, {12, 0x1C, 2368},
    {12, 0x1D, 2432}, {12, 0x1E, 2496}, {12, 0x1F, 2560}};

// table[colour][len][code] = run + 1, 0 for no code (lengths up to 13).
struct RunTables {
  std::vector<int16_t> t[2][14];
  RunTables() {
    for (int c = 0; c < 2; ++c) {
      for (int l = 0; l < 14; ++l) t[c][l].assign(size_t(1) << l, 0);
      const Code* codes = c ? kBlack : kWhite;
      const size_t n = c ? sizeof kBlack / sizeof *kBlack : sizeof kWhite / sizeof *kWhite;
      for (size_t i = 0; i < n; ++i) t[c][codes[i].len][codes[i].bits] = int16_t(codes[i].run + 1);
      for (const Code& s : kShared) t[c][s.len][s.bits] = int16_t(s.run + 1);
    }
  }
};

const RunTables& run_tables() {
  static const RunTables tables;
  return tables;
}

// The bit accumulator of libtiff's tif_fax3.h: NeedBits8 / NeedBits16 load
// whole bytes as a lookup needs them and, at the end of the data, pad the
// accumulator with zero bits up to the lookup's width; those bits count as
// loaded, so a Modified Huffman row that ends in padding throws the byte
// alignment of the next row off, as libtiff does. pos is the next bit of
// the stream (the data, then zeros), avail the bits held from pos.
class FaxBits {
 public:
  FaxBits(const uint8_t* data, int64_t size) : data_(data), bytes_(size) {}
  void need(int n, bool two_bytes) {
    if (avail_ >= n) return;
    if (cp_ >= bytes_) {
      if (avail_ == 0) fail("CCITT data ends before the last row");
      avail_ = n;
      return;
    }
    ++cp_;
    avail_ += 8;
    if (avail_ < n && two_bytes) {
      if (cp_ >= bytes_) {
        avail_ = n;
      } else {
        ++cp_;
        avail_ += 8;
      }
    }
  }
  int get(int n) const {  // the next n bits, zeros past the data
    int v = 0;
    for (int i = 0; i < n; ++i) {
      const int64_t p = pos_ + i;
      v = (v << 1) | (p < bytes_ * 8 ? (data_[p >> 3] >> (7 - (p & 7))) & 1 : 0);
    }
    return v;
  }
  void clear(int n) {
    pos_ += n;
    avail_ -= n;
  }
  int avail() const { return avail_; }

 private:
  const uint8_t* data_;
  int64_t bytes_, pos_ = 0, cp_ = 0;
  int avail_ = 0;
};

// LOOKUP16(12 / 13) on a colour's run table: the code's run, or -1 for an
// EOL, or -2 for no code (libtiff's "unexpected" code, which takes no bits).
int lookup_run(FaxBits& b, int colour) {
  const RunTables& rt = run_tables();
  const int width = colour ? 13 : 12;
  b.need(width, true);
  const int bits = b.get(width);
  if ((bits >> (width - 12)) == 1) {
    b.clear(12);
    return -1;
  }
  for (int len = 2; len <= width; ++len) {
    const int got = rt.t[colour][len][bits >> (width - len)];
    if (got) {
      b.clear(len);
      return got - 1;
    }
  }
  return -2;
}

// A one-dimensional row as EXPAND1D and CLEANUP_RUNS make it: runs of white
// and black in turn (make-up codes add up, a terminating code ends a run)
// until they reach the row's end; a bad code or an EOL ends the row early.
// Then a row that overshoots is cut back to whole runs and a short one
// padded with white. Returns the runs' changes; `eol` is set by an EOL.
void row_1d(FaxBits& b, int width, std::vector<int>& changes, bool& eol) {
  std::vector<int> runs;
  int a0 = 0, pending = 0;
  auto setvalue = [&](int x) {
    runs.push_back(pending + x);
    a0 += x;
    pending = 0;
  };
  bool done = false;
  while (!done) {
    for (int colour = 0; colour < 2 && !done; ++colour) {
      for (;;) {
        const int r = lookup_run(b, colour);
        if (r < 0) {
          eol = r == -1;
          done = true;
          break;
        }
        if (r < 64) {
          setvalue(r);
          break;
        }
        a0 += r;
        pending += r;
      }
      if (!done && a0 >= width) done = true;
    }
    if (!done && runs.size() >= 2 && runs[runs.size() - 1] == 0 && runs[runs.size() - 2] == 0) {
      runs.resize(runs.size() - 2);
    }
  }
  if (pending) setvalue(0);
  if (a0 != width) {
    while (a0 > width && !runs.empty()) {
      a0 -= runs.back();
      runs.pop_back();
    }
    if (a0 < width) {
      if (a0 < 0) a0 = 0;
      if (runs.size() & 1) setvalue(0);
      setvalue(width - a0);
    } else if (a0 > width) {
      setvalue(width);
      setvalue(0);
    }
  }
  changes.clear();
  int x = 0;
  for (size_t k = 0; k + 1 < runs.size(); ++k) {
    x += runs[k];
    changes.push_back(std::min(x, width));
  }
}

// One run of `colour` (0 white, 1 black) in a horizontal mode code: make-up
// codes, then a terminating code.
int run(FaxBits& b, int colour) {
  int total = 0;
  for (;;) {
    const int r = lookup_run(b, colour);
    if (r < 0) fail(std::string("bad CCITT ") + (colour ? "black" : "white") + " run code");
    total += r;
    if (r < 64) return total;
  }
}

// libtiff's SYNC_EOL: unless an EOL just ended the row, 11 zero bits
// anywhere; then zero bytes, then up to the next 1 bit.
void sync_eol(FaxBits& b, bool eol) {
  if (!eol) {
    for (;;) {
      b.need(11, true);
      if (b.get(11) == 0) break;
      b.clear(1);
    }
  }
  for (;;) {
    b.need(8, false);
    if (b.get(8)) break;
    b.clear(8);
  }
  while (b.get(1) == 0) b.clear(1);
  b.clear(1);
}

// LOOKUP8(7) on the two-dimensional modes: 0 V0, +-1..3 VR / VL (as
// 10 + d), 1 horizontal, 2 pass.
int mode_code(FaxBits& b) {
  b.need(7, false);
  const int v = b.get(7);
  static const struct {
    int len, bits, mode;
  } kModes[] = {{1, 1, 10}, {3, 3, 11}, {3, 2, 9}, {3, 1, 1}, {4, 1, 2},
                {6, 3, 12}, {6, 2, 8}, {7, 3, 13}, {7, 2, 7}};
  for (const auto& m : kModes) {
    if ((v >> (7 - m.len)) == m.bits) {
      b.clear(m.len);
      return m.mode;
    }
  }
  fail("bad CCITT mode code (an extension or an EOL inside a row)");
}

// Two dimensions, against `ref` (the reference row's changes).
void row_2d(FaxBits& b, int width, const std::vector<int>& ref, std::vector<int>& changes) {
  changes.clear();
  int a0 = -1, colour = 0;
  // b1: the first reference change right of a0 to the colour opposite a0's
  // (changes at even places turn black); b2 the one after it.
  auto b1_of = [&](int& b1, int& b2) {
    size_t j = std::upper_bound(ref.begin(), ref.end(), a0) - ref.begin();
    if (j < ref.size() && (j & 1) != static_cast<size_t>(colour)) ++j;
    b1 = j < ref.size() ? ref[j] : width;
    b2 = j + 1 < ref.size() ? ref[j + 1] : width;
  };
  while (a0 < width) {
    const int mode = mode_code(b);
    int b1, b2;
    if (mode == 1) {  // horizontal
      const int a1 = (a0 < 0 ? 0 : a0) + run(b, colour);
      const int a2 = a1 + run(b, colour ^ 1);
      if (a2 > width) fail("a CCITT run past the end of its row");
      if (a1 < width) changes.push_back(a1);
      if (a2 < width) changes.push_back(a2);
      a0 = a2;
      continue;
    }
    b1_of(b1, b2);
    if (mode == 2) {  // pass
      a0 = b2;
      continue;
    }
    const int a1 = b1 + mode - 10;
    if (a1 > width || a1 < (a0 < 0 ? 0 : a0)) fail("a CCITT vertical code past its row");
    a0 = a1;
    if (a0 < width) changes.push_back(a0);
    colour ^= 1;
  }
}

void pack(const std::vector<int>& changes, int width, uint8_t* out) {
  const int bytes = (width + 7) / 8;
  memset(out, 0, static_cast<size_t>(bytes));
  for (size_t k = 0; k < changes.size(); k += 2) {  // black from changes[k] to changes[k+1]
    const int x0 = changes[k], x1 = k + 1 < changes.size() ? changes[k + 1] : width;
    for (int x = x0; x < x1; ++x) out[x >> 3] |= static_cast<uint8_t>(0x80 >> (x & 7));
  }
}

}  // namespace

#define W3D_GUARD(body)                    \
  try {                                      \
    body;                                    \
  } catch (const ImageError& e) {            \
    set_message(msg, msg_len, e.msg);        \
  } catch (const std::exception& e) {        \
    set_message(msg, msg_len, e.what());     \
  }                                          \
  return -1;

extern "C" {

int w3d_png_unfilter(const uint8_t* raw, int64_t raw_size, int64_t height, int64_t width,
                     int32_t channels, int32_t bits, int32_t interlaced, uint8_t* out,
                     char* msg, int32_t msg_len) {
  W3D_GUARD(png_unfilter(raw, static_cast<size_t>(raw_size), height, width, channels, bits,
                         interlaced != 0, out);
            return 0)
}

int w3d_unpack_bits(const uint8_t* in, int64_t rows, int64_t row_bytes, int64_t width,
                    int32_t bits, uint8_t* out, char* msg, int32_t msg_len) {
  W3D_GUARD(unpack_bits(in, rows, row_bytes, width, bits, out); return 0)
}

int64_t w3d_bmp_rle(const uint8_t* in, int64_t size, int64_t start, int64_t width,
                    int64_t height, int32_t rle4, uint8_t* out, char* msg, int32_t msg_len) {
  W3D_GUARD(return bmp_rle(in, static_cast<size_t>(size), static_cast<size_t>(start), width,
                           height, rle4 != 0, out))
}

int64_t w3d_lzw_decode(const uint8_t* in, int64_t size, uint8_t* out, int64_t out_size,
                       char* msg, int32_t msg_len) {
  W3D_GUARD(return lzw_decode(in, static_cast<size_t>(size), out, out_size))
}

int64_t w3d_packbits_decode(const uint8_t* in, int64_t size, uint8_t* out, int64_t out_size,
                            char* msg, int32_t msg_len) {
  W3D_GUARD(return packbits_decode(in, static_cast<size_t>(size), out, out_size))
}

int w3d_resize_u8(const uint8_t* in, int32_t height, int32_t width, int32_t channels,
                  uint8_t* out, int32_t out_height, int32_t out_width, char* msg,
                  int32_t msg_len) {
  W3D_GUARD(resize_u8(in, height, width, channels, out, out_height, out_width); return 0)
}

int64_t w3d_tga_rle(const uint8_t* in, int64_t size, int32_t depth, int64_t row_bytes,
                    int64_t rows, uint8_t* out, char* msg, int32_t msg_len) {
  W3D_GUARD(return tga_rle(in, size, depth, row_bytes, rows, out))
}

int w3d_qoi_decode(const uint8_t* in, int64_t size, int64_t pixels, int32_t channels,
                   uint8_t* out, char* msg, int32_t msg_len) {
  W3D_GUARD(qoi_decode(in, size, pixels, channels, out); return 0)
}

int w3d_ccitt_decode(const uint8_t* data, int64_t size, int32_t mode, int32_t options,
                     int32_t width, int32_t rows, uint8_t* out, char* msg, int32_t msg_len) {
  try {
    if (width < 1 || rows < 0 || (mode < 2 || mode > 4)) fail("bad CCITT layout");
    FaxBits b(data, size);
    std::vector<int> ref, cur;
    const int64_t bytes = (width + 7) / 8;
    bool eol = false;
    for (int y = 0; y < rows; ++y) {
      bool two_d = mode == 4;
      if (mode == 3) {
        sync_eol(b, eol);
        if (options & 1) {  // the tag bit: 1 for a one-dimensional row
          b.need(1, false);
          two_d = b.get(1) == 0;
          b.clear(1);
        }
      }
      eol = false;
      if (two_d) row_2d(b, width, ref, cur);
      else row_1d(b, width, cur, eol);
      if (mode == 2) b.clear(b.avail() % 8);  // FAXMODE_BYTEALIGN
      pack(cur, width, out + y * bytes);
      ref.swap(cur);
    }
    return 0;
  } catch (const ImageError& e) {
    set_message(msg, msg_len, e.msg);
  }
  return -1;
}

int w3d_ycbcr_to_rgb(const uint8_t* units, int64_t size, int32_t sh, int32_t sv, int32_t width,
                     int32_t rows, const int32_t* tables, uint8_t* out, char* msg,
                     int32_t msg_len) {
  const int32_t* y_tab = tables;
  const int32_t* cr_r = tables + 256;
  const int32_t* cb_b = tables + 512;
  const int32_t* cr_g = tables + 768;
  const int32_t* cb_g = tables + 1024;
  const int64_t across = (width + sh - 1) / sh, unit = sh * sv + 2;
  const int64_t need = ((rows + sv - 1) / sv) * across * unit;
  if (sh < 1 || sv < 1 || width < 1 || rows < 0 || size < need) {
    set_message(msg, msg_len, "YCbCr data units shorter than the segment");
    return -1;
  }
  auto clamp = [](int32_t v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); };
  for (int32_t y = 0; y < rows; ++y) {
    const uint8_t* row = units + (y / sv) * across * unit;
    uint8_t* o = out + static_cast<int64_t>(y) * width * 3;
    for (int32_t x = 0; x < width; ++x, o += 3) {
      const uint8_t* u = row + (x / sh) * unit;
      const int lum = u[(y % sv) * sh + x % sh], cb = u[sh * sv], cr = u[sh * sv + 1];
      o[0] = clamp(y_tab[lum] + cr_r[cr]);
      o[1] = clamp(y_tab[lum] + static_cast<int32_t>((static_cast<int64_t>(cb_g[cb]) + cr_g[cr]) >> 16));
      o[2] = clamp(y_tab[lum] + cb_b[cb]);
    }
  }
  return 0;
}

}  // extern "C"
