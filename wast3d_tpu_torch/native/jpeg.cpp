// wast3d_tpu_torch native JPEG decoder: baseline sequential Huffman JPEG.
//
// COLMAP datasets ship JPEG images, and the card's machine has no PIL. This
// decodes what cameras and COLMAP's undistorter write: SOF0 / SOF1, 8-bit
// samples, 1 or 3 components, sampling 4:4:4, 4:2:2 (2x1) or 4:2:0 (2x2),
// any size, restart markers. Every other kind of file (progressive,
// arithmetic, lossless, hierarchical, 12-bit, CMYK, other samplings) is
// refused with a message that names its marker.
//
// The arithmetic is libjpeg's, so the output matches PIL's (libjpeg-turbo)
// decode: the "islow" integer inverse DCT (jidctint.c, 13-bit constants, two
// passes, the post-IDCT range limit), "fancy" triangle upsampling of the
// chroma (jdsample.c h2v1 / h2v2, edge rows and columns replicated, plain
// replication for planes at most 2 samples wide), and the fixed-point
// YCbCr -> RGB tables of jdcolor.c. EXIF orientation is not applied.
//
// C ABI (ctypes):
//   w3d_jpeg_info(data, size, &width, &height, &channels, msg, msg_len)
//   w3d_jpeg_decode(data, size, out, out_size, msg, msg_len)
// Both return 0 on success and -1 on failure, with a NUL-terminated reason
// in msg. out receives height x width x channels bytes, row-major.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <exception>
#include <string>
#include <vector>

namespace {

// Natural (row-major) index of the k-th coefficient in zigzag order; the
// extra entries send a corrupt run past 63 to 63, as libjpeg's table does.
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct DecodeError {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw DecodeError{msg}; }

std::string marker_name(int m) {
  char buf[32];
  if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {
    snprintf(buf, sizeof buf, "SOF%d (0xFF%02X)", m - 0xC0, m);
  } else {
    snprintf(buf, sizeof buf, "marker 0xFF%02X", m);
  }
  return buf;
}

struct Huffman {
  bool defined = false;
  int32_t maxcode[18];    // largest code of each length, -1 if none
  int32_t valoffset[18];  // symbol index of a code of each length, minus the code
  uint8_t vals[256];
  uint8_t look_len[512];  // 9-bit lookahead: code length (0: longer code)
  uint8_t look_sym[512];
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0, td = 0, ta = 0;
  int dc_pred = 0;
  int width = 0, height = 0;  // downsampled size
  int bw = 0, bh = 0;         // blocks across and down in the plane
  int stride = 0;
  std::vector<uint8_t> plane;  // bh * 8 rows of stride samples
};

class Decoder {
 public:
  Decoder(const uint8_t* data, size_t size) : data_(data), size_(size) {}

  void header() {
    if (size_ < 4 || data_[0] != 0xFF || data_[1] != 0xD8) fail("not a JPEG file (no SOI)");
    pos_ = 2;
    for (;;) {
      int m = next_marker();
      if (m == 0xD9) fail("no frame before EOI");
      if (m == 0xC0 || m == 0xC1) {
        frame(m);
        return;
      }
      if (m >= 0xC2 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) unsupported_frame(m);
      segment(m);
    }
  }

  void decode(uint8_t* out) {
    for (;;) {
      if (pos_ >= size_ && scans_ > 0) break;  // a missing EOI, as libjpeg allows
      int m = next_marker();
      if (m == 0xD9) break;
      if (m == 0xDA) {
        scan();
        ++scans_;
      } else if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xCC) {
        fail("a second frame (" + marker_name(m) + ") is not supported");
      } else {
        segment(m);
      }
    }
    if (scans_ == 0) fail("no scan (SOS) before EOI");
    output(out);
  }

  int width() const { return width_; }
  int height() const { return height_; }
  int channels() const { return ncomp_ == 1 ? 1 : 3; }

 private:
  // ---- markers and segments ------------------------------------------
  int byte() {
    if (pos_ >= size_) fail("unexpected end of data");
    return data_[pos_++];
  }

  int u16() {
    int hi = byte();
    return (hi << 8) | byte();
  }

  int next_marker() {
    // Skip anything up to 0xFF, then fill bytes, as libjpeg's next_marker.
    for (;;) {
      while (byte() != 0xFF) {
      }
      int m;
      do {
        m = byte();
      } while (m == 0xFF);
      if (m != 0 && !(m >= 0xD0 && m <= 0xD7)) return m;
    }
  }

  void unsupported_frame(int m) {
    const char* what = "unsupported";
    if (m == 0xC2) what = "progressive";
    else if (m == 0xC3) what = "lossless";
    else if (m >= 0xC5 && m <= 0xC7) what = "hierarchical (differential)";
    else if (m >= 0xC9 && m <= 0xCB) what = "arithmetic-coded";
    else if (m >= 0xCD) what = "arithmetic-coded hierarchical";
    fail(std::string(what) + " JPEG (" + marker_name(m) + ") is not supported; "
         "only baseline sequential Huffman files (SOF0 / SOF1) are");
  }

  void segment(int m) {
    size_t len = static_cast<size_t>(u16());
    if (len < 2 || pos_ + len - 2 > size_) fail("truncated " + marker_name(m) + " segment");
    size_t end = pos_ + len - 2;
    if (m == 0xDB) {
      dqt(end);
    } else if (m == 0xC4) {
      dht(end);
    } else if (m == 0xDD) {
      if (len != 4) fail("bad DRI segment");
      restart_interval_ = u16();
    } else if (m == 0xCC) {
      fail("arithmetic-coded JPEG (DAC, 0xFFCC) is not supported");
    } else if (m == 0xE0 && len >= 7 && memcmp(data_ + pos_, "JFIF\0", 5) == 0) {
      saw_jfif_ = true;
    } else if (m == 0xEE && len >= 14 && memcmp(data_ + pos_, "Adobe", 5) == 0) {
      saw_adobe_ = true;
      adobe_transform_ = data_[pos_ + 11];
    }
    pos_ = end;  // APPn, COM and the rest are skipped
  }

  void dqt(size_t end) {
    while (pos_ < end) {
      int pq_tq = byte();
      int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3) fail("bad DQT table index");
      for (int k = 0; k < 64; ++k) qt_[tq][kNatural[k]] = static_cast<uint16_t>(pq ? u16() : byte());
      qt_defined_[tq] = true;
    }
  }

  void dht(size_t end) {
    while (pos_ < end) {
      int tc_th = byte();
      int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) fail("bad DHT table index");
      Huffman& t = tc ? ac_[th] : dc_[th];
      int counts[17] = {0};
      int total = 0;
      for (int l = 1; l <= 16; ++l) total += counts[l] = byte();
      if (total > 256) fail("bad DHT table");
      for (int i = 0; i < total; ++i) t.vals[i] = static_cast<uint8_t>(byte());
      // Canonical codes (JPEG Annex C), then the 9-bit lookahead table.
      memset(t.look_len, 0, sizeof t.look_len);
      int32_t code = 0;
      int k = 0;
      for (int l = 1; l <= 16; ++l) {
        t.valoffset[l] = k - code;
        if (counts[l]) {
          for (int i = 0; i < counts[l]; ++i, ++k, ++code) {
            if (code >= (1 << l)) fail("bad DHT table (codes overflow)");
            if (l <= 9) {
              int lo = code << (9 - l), n = 1 << (9 - l);
              for (int j = 0; j < n; ++j) {
                t.look_len[lo + j] = static_cast<uint8_t>(l);
                t.look_sym[lo + j] = t.vals[k];
              }
            }
          }
          t.maxcode[l] = code - 1;
        } else {
          t.maxcode[l] = -1;
        }
        code <<= 1;
      }
      t.maxcode[17] = 0x7FFFFFFF;  // sentinel: a longer code is corrupt
      t.defined = true;
    }
  }

  void frame(int m) {
    size_t len = static_cast<size_t>(u16());
    size_t end = pos_ + len - 2;
    int precision = byte();
    height_ = u16();
    width_ = u16();
    ncomp_ = byte();
    if (precision != 8) {
      fail(std::to_string(precision) + "-bit JPEG (" + marker_name(m) + ", precision " +
           std::to_string(precision) + ") is not supported; only 8-bit samples are");
    }
    if (ncomp_ == 4) fail("4-component (CMYK / YCCK) JPEG (" + marker_name(m) + ") is not supported");
    if (ncomp_ != 1 && ncomp_ != 3) {
      fail(std::to_string(ncomp_) + "-component JPEG (" + marker_name(m) + ") is not supported");
    }
    if (width_ <= 0 || height_ <= 0) fail("JPEG with a zero size (" + marker_name(m) + ", DNL) is not supported");
    if (len != 8u + 3u * ncomp_) fail("bad " + marker_name(m) + " segment");
    for (int c = 0; c < ncomp_; ++c) {
      Component& cp = comp_[c];
      cp.id = byte();
      int hv = byte();
      cp.h = hv >> 4;
      cp.v = hv & 15;
      cp.tq = byte();
      if (cp.h < 1 || cp.h > 2 || cp.v < 1 || cp.v > 2 || cp.tq > 3) {
        fail("sampling " + std::to_string(cp.h) + "x" + std::to_string(cp.v) + " of component " +
             std::to_string(c) + " (" + marker_name(m) + ") is not supported");
      }
      hmax_ = std::max(hmax_, cp.h);
      vmax_ = std::max(vmax_, cp.v);
    }
    for (int c = 0; c < ncomp_; ++c) {
      Component& cp = comp_[c];
      int rh = hmax_ / cp.h, rv = vmax_ / cp.v;
      bool ok = (rh == 1 && rv == 1) || (rh == 2 && rv == 1) || (rh == 2 && rv == 2);
      if (!ok || hmax_ % cp.h || vmax_ % cp.v) {
        fail("chroma sampling " + std::to_string(rh) + "x" + std::to_string(rv) + " (" +
             marker_name(m) + ") is not supported; 4:4:4, 4:2:2 and 4:2:0 are");
      }
    }
    mcux_ = (width_ + 8 * hmax_ - 1) / (8 * hmax_);
    mcuy_ = (height_ + 8 * vmax_ - 1) / (8 * vmax_);
    for (int c = 0; c < ncomp_; ++c) {
      Component& cp = comp_[c];
      cp.width = static_cast<int>((static_cast<int64_t>(width_) * cp.h + hmax_ - 1) / hmax_);
      cp.height = static_cast<int>((static_cast<int64_t>(height_) * cp.v + vmax_ - 1) / vmax_);
      cp.bw = mcux_ * cp.h;
      cp.bh = mcuy_ * cp.v;
      cp.stride = cp.bw * 8;
    }
    pos_ = end;
  }

  // ---- entropy-coded data --------------------------------------------
  void reset_bits() {
    bitbuf_ = 0;
    bitcnt_ = 0;
    hit_marker_ = false;
  }

  void fill() {
    while (bitcnt_ <= 24) {
      int b = 0;
      if (!hit_marker_) {
        if (pos_ >= size_) {
          hit_marker_ = true;
        } else if (data_[pos_] == 0xFF) {
          size_t q = pos_ + 1;
          while (q < size_ && data_[q] == 0xFF) ++q;  // fill bytes
          if (q < size_ && data_[q] == 0x00) {
            b = 0xFF;
            pos_ = q + 1;
          } else {
            hit_marker_ = true;  // a marker: stop here, feed zeros (libjpeg)
          }
        } else {
          b = data_[pos_++];
        }
      }
      bitbuf_ |= static_cast<uint32_t>(b) << (24 - bitcnt_);
      bitcnt_ += 8;
    }
  }

  int bits(int n) {
    if (n == 0) return 0;
    if (bitcnt_ < n) fill();
    int v = static_cast<int>(bitbuf_ >> (32 - n));
    bitbuf_ <<= n;
    bitcnt_ -= n;
    return v;
  }

  int huff(const Huffman& t) {
    if (bitcnt_ < 16) fill();
    int look = static_cast<int>(bitbuf_ >> 23);
    int l = t.look_len[look];
    if (l) {
      bitbuf_ <<= l;
      bitcnt_ -= l;
      return t.look_sym[look];
    }
    int32_t code = static_cast<int32_t>(bitbuf_ >> 22);  // 10 bits
    for (l = 10; l <= 16; ++l) {
      if (code <= t.maxcode[l]) {
        bitbuf_ <<= l;
        bitcnt_ -= l;
        return t.vals[(t.valoffset[l] + code) & 0xFF];
      }
      code = static_cast<int32_t>(bitbuf_ >> (31 - l));
    }
    fail("corrupt Huffman code in the scan");
  }

  static int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

  void block(Component& cp, int bx, int by) {
    const Huffman& dc = dc_[cp.td];
    const Huffman& ac = ac_[cp.ta];
    int16_t coef[64] = {0};
    int s = huff(dc);
    if (s > 16) fail("corrupt DC coefficient");
    cp.dc_pred += s ? extend(bits(s), s) : 0;
    coef[0] = static_cast<int16_t>(cp.dc_pred);
    for (int k = 1; k < 64; ++k) {
      int rs = huff(ac);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        coef[kNatural[k]] = static_cast<int16_t>(extend(bits(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
    idct_islow(coef, qt_[cp.tq], cp.plane.data() + (static_cast<size_t>(by) * 8) * cp.stride + bx * 8,
               cp.stride);
  }

  void restart() {
    // Discard the byte-aligned remainder, then expect RSTn.
    reset_bits();
    for (;;) {
      int b = byte();
      if (b != 0xFF) continue;
      int m;
      do {
        m = byte();
      } while (m == 0xFF);
      if (m >= 0xD0 && m <= 0xD7) break;
      if (m != 0) fail("missing restart marker (found " + marker_name(m) + ")");
    }
    for (int c = 0; c < ncomp_; ++c) comp_[c].dc_pred = 0;
  }

  void scan() {
    size_t len = static_cast<size_t>(u16());
    size_t end = pos_ + len - 2;
    int ns = byte();
    if (ns < 1 || ns > ncomp_ || len != 6u + 2u * ns) fail("bad SOS segment");
    Component* sc[3];
    for (int i = 0; i < ns; ++i) {
      int id = byte();
      int tdta = byte();
      Component* found = nullptr;
      for (int c = 0; c < ncomp_; ++c) {
        if (comp_[c].id == id) found = &comp_[c];
      }
      if (!found) fail("SOS names an unknown component");
      found->td = tdta >> 4;
      found->ta = tdta & 15;
      if (found->td > 3 || found->ta > 3 || !dc_[found->td].defined || !ac_[found->ta].defined) {
        fail("SOS uses an undefined Huffman table");
      }
      if (!qt_defined_[found->tq]) fail("SOS component uses an undefined quantisation table");
      sc[i] = found;
    }
    int ss = byte(), se = byte(), ahal = byte();
    if (ss != 0 || se != 63 || ahal != 0) fail("spectral selection in a sequential scan is not supported");
    pos_ = end;
    for (int i = 0; i < ns; ++i) {
      if (sc[i]->plane.empty()) sc[i]->plane.assign(static_cast<size_t>(sc[i]->stride) * sc[i]->bh * 8, 0);
      sc[i]->dc_pred = 0;
    }
    reset_bits();
    int todo = restart_interval_;
    if (ns == 1) {
      // Non-interleaved: the component's own blocks, in raster order.
      Component& cp = *sc[0];
      int bw = (cp.width + 7) / 8, bh = (cp.height + 7) / 8;
      for (int by = 0; by < bh; ++by) {
        for (int bx = 0; bx < bw; ++bx) {
          if (restart_interval_ && todo == 0) {
            restart();
            todo = restart_interval_;
          }
          block(cp, bx, by);
          --todo;
        }
      }
    } else {
      for (int my = 0; my < mcuy_; ++my) {
        for (int mx = 0; mx < mcux_; ++mx) {
          if (restart_interval_ && todo == 0) {
            restart();
            todo = restart_interval_;
          }
          for (int i = 0; i < ns; ++i) {
            Component& cp = *sc[i];
            for (int v = 0; v < cp.v; ++v) {
              for (int h = 0; h < cp.h; ++h) block(cp, mx * cp.h + h, my * cp.v + v);
            }
          }
          --todo;
        }
      }
    }
    reset_bits();
  }

  // ---- inverse DCT: libjpeg's jpeg_idct_islow ---------------------------
  static uint8_t range_limit(int64_t x) {
    // The post-IDCT table indexed with & RANGE_MASK (1023): x wraps to
    // [-512, 511], then x + 128 is clamped to [0, 255].
    int v = static_cast<int>(((x + 512) & 1023) - 512) + 128;
    return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v);
  }

  static void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out, int stride) {
    const int kConstBits = 13, kPass1Bits = 2;
    const int64_t F0_298 = 2446, F0_390 = 3196, F0_541 = 4433, F0_765 = 6270, F0_899 = 7373,
                  F1_175 = 9633, F1_501 = 12299, F1_847 = 15137, F1_961 = 16069,
                  F2_053 = 16819, F2_562 = 20995, F3_072 = 25172;
    auto descale = [](int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; };
    int ws[64];
    for (int c = 0; c < 8; ++c) {  // pass 1: columns
      auto in = [&](int r) { return static_cast<int64_t>(coef[8 * r + c]) * q[8 * r + c]; };
      int64_t z2 = in(2), z3 = in(6);
      int64_t z1 = (z2 + z3) * F0_541;
      int64_t tmp2 = z1 + z3 * -F1_847;
      int64_t tmp3 = z1 + z2 * F0_765;
      z2 = in(0);
      z3 = in(4);
      int64_t tmp0 = (z2 + z3) * (int64_t(1) << kConstBits);
      int64_t tmp1 = (z2 - z3) * (int64_t(1) << kConstBits);
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = in(7);
      tmp1 = in(5);
      tmp2 = in(3);
      tmp3 = in(1);
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      int64_t z5 = (z3 + z4) * F1_175;
      tmp0 *= F0_298;
      tmp1 *= F2_053;
      tmp2 *= F3_072;
      tmp3 *= F1_501;
      z1 *= -F0_899;
      z2 *= -F2_562;
      z3 *= -F1_961;
      z4 *= -F0_390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      const int n = kConstBits - kPass1Bits;
      ws[8 * 0 + c] = static_cast<int>(descale(tmp10 + tmp3, n));
      ws[8 * 7 + c] = static_cast<int>(descale(tmp10 - tmp3, n));
      ws[8 * 1 + c] = static_cast<int>(descale(tmp11 + tmp2, n));
      ws[8 * 6 + c] = static_cast<int>(descale(tmp11 - tmp2, n));
      ws[8 * 2 + c] = static_cast<int>(descale(tmp12 + tmp1, n));
      ws[8 * 5 + c] = static_cast<int>(descale(tmp12 - tmp1, n));
      ws[8 * 3 + c] = static_cast<int>(descale(tmp13 + tmp0, n));
      ws[8 * 4 + c] = static_cast<int>(descale(tmp13 - tmp0, n));
    }
    for (int r = 0; r < 8; ++r) {  // pass 2: rows
      const int* w = ws + 8 * r;
      uint8_t* o = out + static_cast<size_t>(r) * stride;
      int64_t z2 = w[2], z3 = w[6];
      int64_t z1 = (z2 + z3) * F0_541;
      int64_t tmp2 = z1 + z3 * -F1_847;
      int64_t tmp3 = z1 + z2 * F0_765;
      int64_t tmp0 = (static_cast<int64_t>(w[0]) + w[4]) * (int64_t(1) << kConstBits);
      int64_t tmp1 = (static_cast<int64_t>(w[0]) - w[4]) * (int64_t(1) << kConstBits);
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = w[7];
      tmp1 = w[5];
      tmp2 = w[3];
      tmp3 = w[1];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      int64_t z5 = (z3 + z4) * F1_175;
      tmp0 *= F0_298;
      tmp1 *= F2_053;
      tmp2 *= F3_072;
      tmp3 *= F1_501;
      z1 *= -F0_899;
      z2 *= -F2_562;
      z3 *= -F1_961;
      z4 *= -F0_390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      const int n = kConstBits + kPass1Bits + 3;
      o[0] = range_limit(descale(tmp10 + tmp3, n));
      o[7] = range_limit(descale(tmp10 - tmp3, n));
      o[1] = range_limit(descale(tmp11 + tmp2, n));
      o[6] = range_limit(descale(tmp11 - tmp2, n));
      o[2] = range_limit(descale(tmp12 + tmp1, n));
      o[5] = range_limit(descale(tmp12 - tmp1, n));
      o[3] = range_limit(descale(tmp13 + tmp0, n));
      o[4] = range_limit(descale(tmp13 - tmp0, n));
    }
  }

  // ---- upsampling and colour: jdsample.c, jdcolor.c -------------------
  // One output row (width 2 * cp.width) of an h2 component from its
  // downsampled row `in0` and, for h2v2, the vertical neighbour `in1`.
  static void h2v1_fancy(const uint8_t* in, int n, uint8_t* out) {
    int v = in[0];
    *out++ = static_cast<uint8_t>(v);
    *out++ = static_cast<uint8_t>((v * 3 + in[1] + 2) >> 2);
    for (int i = 1; i < n - 1; ++i) {
      v = in[i] * 3;
      *out++ = static_cast<uint8_t>((v + in[i - 1] + 1) >> 2);
      *out++ = static_cast<uint8_t>((v + in[i + 1] + 2) >> 2);
    }
    v = in[n - 1];
    *out++ = static_cast<uint8_t>((v * 3 + in[n - 2] + 1) >> 2);
    *out++ = static_cast<uint8_t>(v);
  }

  static void h2v2_fancy(const uint8_t* in0, const uint8_t* in1, int n, uint8_t* out) {
    int this_sum = in0[0] * 3 + in1[0];
    int next_sum = in0[1] * 3 + in1[1];
    *out++ = static_cast<uint8_t>((this_sum * 4 + 8) >> 4);
    *out++ = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
    int last_sum = this_sum;
    this_sum = next_sum;
    for (int i = 2; i < n; ++i) {
      next_sum = in0[i] * 3 + in1[i];
      *out++ = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
      *out++ = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
      last_sum = this_sum;
      this_sum = next_sum;
    }
    *out++ = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
    *out++ = static_cast<uint8_t>((this_sum * 4 + 7) >> 4);
  }

  // Row y of component c at full resolution into `row` (>= width_ + 2).
  void upsampled_row(const Component& cp, int y, uint8_t* row) const {
    int rh = hmax_ / cp.h, rv = vmax_ / cp.v;
    const uint8_t* p = cp.plane.data();
    if (rh == 1 && rv == 1) {
      memcpy(row, p + static_cast<size_t>(y) * cp.stride, width_);
      return;
    }
    int iy = y / rv;
    const uint8_t* in0 = p + static_cast<size_t>(iy) * cp.stride;
    bool fancy = cp.width > 2;
    if (!fancy) {  // replicate each sample (h2v1_upsample / h2v2_upsample)
      for (int x = 0; x < width_; ++x) row[x] = in0[x / 2];
      return;
    }
    if (rv == 1) {
      h2v1_fancy(in0, cp.width, row);
      return;
    }
    // h2v2: the nearer row with weight 3, the one above (even output rows)
    // or below (odd) with weight 1; the edge rows are replicated.
    int ny = (y % 2 == 0) ? iy - 1 : iy + 1;
    if (ny < 0) ny = 0;
    if (ny > cp.height - 1) ny = cp.height - 1;
    h2v2_fancy(in0, p + static_cast<size_t>(ny) * cp.stride, cp.width, row);
  }

  void output(uint8_t* out) const {
    for (int c = 0; c < ncomp_; ++c) {
      if (comp_[c].plane.empty()) fail("component " + std::to_string(c) + " has no scan");
    }
    if (ncomp_ == 1) {
      for (int y = 0; y < height_; ++y) {
        memcpy(out + static_cast<size_t>(y) * width_,
               comp_[0].plane.data() + static_cast<size_t>(y) * comp_[0].stride, width_);
      }
      return;
    }
    // libjpeg's default colour space: JFIF means YCbCr; else an Adobe
    // marker's transform flag; else component ids 'R', 'G', 'B' mean RGB.
    bool rgb = false;
    if (!saw_jfif_) {
      if (saw_adobe_) {
        rgb = adobe_transform_ == 0;
      } else {
        rgb = comp_[0].id == 'R' && comp_[1].id == 'G' && comp_[2].id == 'B';
      }
    }
    // jdcolor.c build_ycc_rgb_table: SCALEBITS 16.
    const int64_t kOneHalf = int64_t(1) << 15;
    auto fix = [](double x) { return static_cast<int64_t>(x * 65536.0 + 0.5); };
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + kOneHalf) >> 16);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + kOneHalf) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + kOneHalf;
    }
    auto clamp = [](int v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); };
    std::vector<uint8_t> rows(3 * static_cast<size_t>(width_ + 2));
    uint8_t* r0 = rows.data();
    uint8_t* r1 = r0 + width_ + 2;
    uint8_t* r2 = r1 + width_ + 2;
    for (int y = 0; y < height_; ++y) {
      upsampled_row(comp_[0], y, r0);
      upsampled_row(comp_[1], y, r1);
      upsampled_row(comp_[2], y, r2);
      uint8_t* o = out + static_cast<size_t>(y) * width_ * 3;
      for (int x = 0; x < width_; ++x) {
        if (rgb) {
          o[3 * x] = r0[x];
          o[3 * x + 1] = r1[x];
          o[3 * x + 2] = r2[x];
          continue;
        }
        int yy = r0[x], cb = r1[x], cr = r2[x];
        o[3 * x] = clamp(yy + cr_r[cr]);
        o[3 * x + 1] = clamp(yy + static_cast<int>((cb_g[cb] + cr_g[cr]) >> 16));
        o[3 * x + 2] = clamp(yy + cb_b[cb]);
      }
    }
  }

  const uint8_t* data_;
  size_t size_;
  size_t pos_ = 0;
  uint16_t qt_[4][64] = {};
  bool qt_defined_[4] = {false, false, false, false};
  Huffman dc_[4], ac_[4];
  int width_ = 0, height_ = 0, ncomp_ = 0, hmax_ = 1, vmax_ = 1, mcux_ = 0, mcuy_ = 0;
  Component comp_[3];
  int restart_interval_ = 0;
  int scans_ = 0;
  bool saw_jfif_ = false, saw_adobe_ = false;
  int adobe_transform_ = -1;
  uint32_t bitbuf_ = 0;
  int bitcnt_ = 0;
  bool hit_marker_ = false;
};

void set_message(char* msg, int32_t len, const std::string& s) {
  if (!msg || len <= 0) return;
  snprintf(msg, static_cast<size_t>(len), "%s", s.c_str());
}

}  // namespace

extern "C" {

int w3d_jpeg_info(const uint8_t* data, int64_t size, int32_t* width, int32_t* height,
                  int32_t* channels, char* msg, int32_t msg_len) {
  try {
    Decoder d(data, static_cast<size_t>(size));
    d.header();
    *width = d.width();
    *height = d.height();
    *channels = d.channels();
    return 0;
  } catch (const DecodeError& e) {
    set_message(msg, msg_len, e.msg);
  } catch (const std::exception& e) {
    set_message(msg, msg_len, e.what());
  }
  return -1;
}

int w3d_jpeg_decode(const uint8_t* data, int64_t size, uint8_t* out, int64_t out_size, char* msg,
                    int32_t msg_len) {
  try {
    Decoder d(data, static_cast<size_t>(size));
    d.header();
    int64_t need = static_cast<int64_t>(d.width()) * d.height() * d.channels();
    if (out_size < need) {
      set_message(msg, msg_len, "output buffer too small");
      return -1;
    }
    d.decode(out);
    return 0;
  } catch (const DecodeError& e) {
    set_message(msg, msg_len, e.msg);
  } catch (const std::exception& e) {
    set_message(msg, msg_len, e.what());
  }
  return -1;
}

}  // extern "C"
