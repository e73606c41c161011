// wast3d_tpu_torch native image code: PNG unfiltering and de-interlacing,
// and PIL's bicubic resize of 8-bit images.
//
// Datasets ship PNG and JPEG images and the card's machine has no PIL.
// `utils/png.py` inflates a PNG's image data with zlib and hands the
// filtered scanlines here; Average and Paeth rows depend on the pixel just
// decoded, so numpy walks them a pixel at a time, and a Blender view
// (libpng's adaptive filters) took seconds a megapixel that way.
//
//   w3d_png_unfilter: the five row filters of the PNG specification
//     (None, Sub, Up, Average, Paeth), 8-bit samples, 1-4 channels; with
//     `interlaced` the seven Adam7 passes, each its own sub-image with its
//     own filter bytes (an empty pass has no bytes), scattered into place.
//   w3d_resize_u8: Pillow's ImagingResample for 8-bit images with its
//     default filter (bicubic, a = -0.5; src/libImaging/Resample.c):
//     weights computed in double as precompute_coeffs does, normalised,
//     turned into 22-bit fixed point rounding half away from zero; the
//     horizontal pass first, rounded and clipped to uint8, then the vertical
//     pass; an axis whose size does not change is skipped. Premultiplying
//     images with alpha stays in Python (`utils/png._premultiplied`).
//
// C ABI (ctypes); both return 0 on success and -1 on failure, with a
// NUL-terminated reason in msg:
//   w3d_png_unfilter(raw, raw_size, height, width, channels, interlaced, out,
//                    msg, msg_len)                 out: height x width x channels
//   w3d_resize_u8(in, height, width, channels, out, out_height, out_width,
//                 msg, msg_len)                    out: out_height x out_width x channels

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

// Unfilter `h` scanlines of `w` pixels of `bpp` bytes from `in` (each row a
// filter byte, then w * bpp bytes) into `out` (h rows of w * bpp bytes, row
// stride `out_stride`, pixel step `out_step` bytes). Returns the bytes read.
size_t unfilter(const uint8_t* in, size_t avail, int64_t h, int64_t w, int bpp, uint8_t* out,
                int64_t out_stride, int64_t out_step) {
  const int64_t stride = w * bpp;
  const size_t need = static_cast<size_t>(h) * static_cast<size_t>(1 + stride);
  if (need > avail) fail("PNG image data too short");
  std::vector<uint8_t> prior(static_cast<size_t>(stride), 0), cur(static_cast<size_t>(stride));
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* row = in + static_cast<size_t>(y) * (1 + stride);
    const int f = row[0];
    const uint8_t* s = row + 1;
    uint8_t* c = cur.data();
    const uint8_t* u = prior.data();
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
    uint8_t* o = out + y * out_stride;
    if (out_step == bpp) {
      memcpy(o, c, static_cast<size_t>(stride));
    } else {
      for (int64_t x = 0; x < w; ++x) memcpy(o + x * out_step, c + x * bpp, static_cast<size_t>(bpp));
    }
    prior.swap(cur);
  }
  return need;
}

void png_unfilter(const uint8_t* raw, size_t size, int64_t h, int64_t w, int c, bool interlaced,
                  uint8_t* out) {
  if (h < 1 || w < 1 || c < 1 || c > 4) fail("bad PNG size or channel count");
  const int64_t row = w * c;
  if (!interlaced) {
    size_t used = unfilter(raw, size, h, w, c, out, row, c);
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
    pos += unfilter(raw + pos, size - pos, ph, pw, c, out + y0 * row + x0 * c, dy * row,
                    static_cast<int64_t>(dx) * c);
  }
  if (pos != size) fail("PNG image data has trailing bytes");
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

}  // namespace

extern "C" {

int w3d_png_unfilter(const uint8_t* raw, int64_t raw_size, int64_t height, int64_t width,
                     int32_t channels, int32_t interlaced, uint8_t* out, char* msg,
                     int32_t msg_len) {
  try {
    png_unfilter(raw, static_cast<size_t>(raw_size), height, width, channels, interlaced != 0,
                 out);
    return 0;
  } catch (const ImageError& e) {
    set_message(msg, msg_len, e.msg);
  } catch (const std::exception& e) {
    set_message(msg, msg_len, e.what());
  }
  return -1;
}

int w3d_resize_u8(const uint8_t* in, int32_t height, int32_t width, int32_t channels,
                  uint8_t* out, int32_t out_height, int32_t out_width, char* msg,
                  int32_t msg_len) {
  try {
    resize_u8(in, height, width, channels, out, out_height, out_width);
    return 0;
  } catch (const ImageError& e) {
    set_message(msg, msg_len, e.msg);
  } catch (const std::exception& e) {
    set_message(msg, msg_len, e.what());
  }
  return -1;
}

}  // extern "C"
