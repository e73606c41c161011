// wast3d_tpu_torch native byte loops of the readers in
// `utils/image_plugins.py`, each as Pillow 12's decoder reads the bytes;
// `utils/image_plugins.py` holds the plain version of each that the tests
// hold it to.
//
//   w3d_fli_decode(frame, size, width, height, out, msg, msg_len): Pillow's
//     FliDecode.c on one frame chunk (0xF1FA) into out [height, width],
//     which holds the image before the frame (zeros for the first): COLOR64
//     / COLOR256 (4, 11) and PSTAMP (18) skipped, SS2 (7) word deltas, LC
//     (12) byte deltas, BLACK (13), BRUN (15) runs and COPY (16); a chunk or
//     line that runs past the frame's bytes is an overrun, an unknown chunk
//     or a zero advance an error, as Pillow reports them.
//   w3d_msp_rows(data, size, rowmap, rows, out, cap, msg, msg_len): Pillow's
//     MspDecoder (version 2): each row's bytes after the row map, read in
//     turn (a row of length 0 is a blank 0xFF line), as runs (0, count,
//     value) and literals (n, then n bytes); the bytes made, of which the
//     first `cap` are written to out. A row cut short, or a run cut short
//     inside its row, is an error naming the row.
//   w3d_pcd_decode(data, size, tables, out, msg, msg_len): Pillow's
//     PcdDecode.c on the 768 x 512 base image (pairs of luma rows, then the
//     pair's two 384-sample chroma rows) and its "YCC;P" unpacker
//     (UnpackYCC.c: R = L[y] + CR[c2], G = L[y] + GR[c2] + GB[c1], B = L[y]
//     + CB[c1], clamped to 0-255), with tables = int16 [5, 256] (L, CR, CB,
//     GR, GB) -> out [512, 768, 3]; data that ends before the last pair is
//     "image file is truncated".
//   w3d_xbm_decode(data, size, width, height, out, msg, msg_len): Pillow's
//     XbmDecode.c: from each 'x' the next two characters as hex digits
//     (anything else counts 0), three characters a byte -> out [height,
//     (width + 7) / 8] rows of bytes.
//   w3d_xpm_lookup(data, ends, lines, bpp, keys, key_ends, nkeys, pixels,
//     out, cap, msg, msg_len): XpmDecoder's lines (each line's characters
//     between its first and last quote, `ends` the running end of each in
//     data) cut into keys of bpp characters (a line's last key may be
//     shorter), each looked up among `keys` (the palette's, in its order)
//     -> out its index; lines are taken until `pixels` keys are made. The
//     keys made, of which the first `cap` are written; a key not in the
//     palette is an error.
//   w3d_bit_decode(data, size, bits, pad, fill, sign, width, height, ystep,
//     out, msg, msg_len): Pillow's BitDecode.c (IM's "L*n" samples of 2-31
//     bits) into float32 out [height, width], rows bottom-up when ystep < 0.
//
// Each returns 0 (w3d_msp_rows, w3d_xpm_lookup: the count made) or -1 with a
// NUL-terminated reason in msg.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <exception>
#include <string>
#include <unordered_map>

namespace {

struct PluginError {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw PluginError{msg}; }

void set_message(char* msg, int32_t len, const std::string& s) {
  if (msg && len > 0) snprintf(msg, static_cast<size_t>(len), "%s", s.c_str());
}

int i16(const uint8_t* p) { return p[0] | p[1] << 8; }

int32_t i32(const uint8_t* p) {
  return static_cast<int32_t>(static_cast<uint32_t>(p[0]) | static_cast<uint32_t>(p[1]) << 8 |
                              static_cast<uint32_t>(p[2]) << 16 |
                              static_cast<uint32_t>(p[3]) << 24);
}

// ---- FLI / FLC: FliDecode.c ----------------------------------------------------------

void fli_decode(const uint8_t* buf, int64_t bytes, int width, int height, uint8_t* im) {
  auto overrun = []() { fail("FLI frame overrun (Pillow: buffer overrun)"); };
  if (bytes < 8) overrun();
  if (i16(buf + 4) != 0xF1FA) fail("not an FLI frame chunk (Pillow: unknown chunk)");
  const int chunks = i16(buf + 6);
  const uint8_t* ptr = buf + 16;
  bytes -= 16;
  for (int c = 0; c < chunks; ++c) {
    if (bytes < 10) overrun();
    const uint8_t* data = ptr + 6;
    auto oob = [&](int64_t offset) {
      if (data + offset > ptr + bytes) overrun();
    };
    const int type = i16(ptr + 4);
    if (type == 4 || type == 11 || type == 18) {
      // colour maps (read when the file is opened) and the postage stamp
    } else if (type == 7) {  // SS2: word deltas
      const int lines = i16(data);
      data += 2;
      int l = 0, y = 0;
      for (; l < lines && y < height; ++l, ++y) {
        uint8_t* row = im + static_cast<int64_t>(y) * width;
        oob(2);
        int packets = i16(data);
        data += 2;
        while (packets & 0x8000) {
          if (packets & 0x4000) {
            y += 65536 - packets;
            if (y >= height) overrun();
            row = im + static_cast<int64_t>(y) * width;
          } else {
            row[width - 1] = static_cast<uint8_t>(packets);
          }
          oob(2);
          packets = i16(data);
          data += 2;
        }
        int p = 0, x = 0;
        for (; p < packets; ++p) {
          oob(2);
          x += data[0];
          if (data[1] >= 128) {
            oob(4);
            const int n = 256 - data[1];
            if (x + n + n > width) break;
            for (int j = 0; j < n; ++j) {
              row[x++] = data[2];
              row[x++] = data[3];
            }
            data += 4;
          } else {
            const int n = 2 * data[1];
            if (x + n > width) break;
            oob(2 + n);
            memcpy(row + x, data + 2, static_cast<size_t>(n));
            data += 2 + n;
            x += n;
          }
        }
        if (p < packets) break;
      }
      if (l < lines) overrun();
    } else if (type == 12) {  // LC: byte deltas
      int y = i16(data);
      const int ymax = y + i16(data + 2);
      data += 4;
      for (; y < ymax && y < height; ++y) {
        uint8_t* row = im + static_cast<int64_t>(y) * width;
        oob(1);
        const int packets = *data++;
        int p = 0, x = 0, n = 0;
        for (; p < packets; ++p, x += n) {
          oob(2);
          x += data[0];
          if (data[1] & 0x80) {
            n = 256 - data[1];
            if (x + n > width) break;
            oob(3);
            memset(row + x, data[2], static_cast<size_t>(n));
            data += 3;
          } else {
            n = data[1];
            if (x + n > width) break;
            oob(2 + n);
            memcpy(row + x, data + 2, static_cast<size_t>(n));
            data += n + 2;
          }
        }
        if (p < packets) break;
      }
      if (y < ymax) overrun();
    } else if (type == 13) {  // BLACK
      memset(im, 0, static_cast<size_t>(width) * height);
    } else if (type == 15) {  // BRUN: runs, each line whole
      for (int y = 0; y < height; ++y) {
        uint8_t* row = im + static_cast<int64_t>(y) * width;
        data += 1;  // the packet count, ignored
        int x = 0, n = 0;
        for (; x < width; x += n) {
          oob(2);
          if (data[0] & 0x80) {
            n = 256 - data[0];
            if (x + n > width) break;
            oob(n + 1);
            memcpy(row + x, data + 1, static_cast<size_t>(n));
            data += n + 1;
          } else {
            n = data[0];
            if (x + n > width) break;
            memset(row + x, data[1], static_cast<size_t>(n));
            data += 2;
          }
        }
        if (x != width) overrun();
      }
    } else if (type == 16) {  // COPY
      if (data + static_cast<int64_t>(width) * height > ptr + bytes) {
        fail("image file is truncated (an FLI COPY chunk without its pixels)");
      }
      memcpy(im, data, static_cast<size_t>(width) * height);
    } else {
      fail("unknown FLI chunk type " + std::to_string(type));
    }
    const int32_t advance = i32(ptr);
    if (advance == 0) fail("FLI chunk of size 0 (Pillow: broken data stream)");
    if (advance < 0 || advance > bytes) overrun();
    ptr += advance;
    bytes -= advance;
  }
}

// ---- MSP version 2: MspDecoder --------------------------------------------------------

int64_t msp_rows(const uint8_t* data, int64_t size, const uint16_t* rowmap, int64_t rows,
                 uint8_t* out, int64_t cap, int64_t width) {
  int64_t made = 0, pos = 0;
  auto put = [&](const uint8_t* src, int64_t n, int fill) {
    for (int64_t i = 0; i < n; ++i, ++made) {
      if (made < cap) out[made] = src ? src[i] : static_cast<uint8_t>(fill);
    }
  };
  for (int64_t x = 0; x < rows; ++x) {
    const int64_t len = rowmap[x];
    if (len == 0) {
      put(nullptr, (width + 7) / 8, 0xFF);
      continue;
    }
    if (pos + len > size) {
      fail("Truncated MSP file, expected " + std::to_string(len) + " bytes on row " +
           std::to_string(x));
    }
    const uint8_t* row = data + pos;
    pos += len;
    int64_t idx = 0;
    while (idx < len) {
      const int type = row[idx++];
      if (type == 0) {
        if (idx + 2 > len) fail("Corrupted MSP file in row " + std::to_string(x));
        put(nullptr, row[idx], row[idx + 1]);
        idx += 2;
      } else {
        put(row + idx, std::min<int64_t>(type, len - idx), 0);
        idx += type;
      }
    }
  }
  return made;
}

// ---- PhotoCD base image: PcdDecode.c + UnpackYCC.c ------------------------------------

void pcd_decode(const uint8_t* data, int64_t size, const int16_t* t, uint8_t* out) {
  const int w = 768, h = 512, chunk = 3 * w;
  const int16_t *L = t, *CR = t + 256, *CB = t + 512, *GR = t + 768, *GB = t + 1024;
  auto clamp = [](int v) { return static_cast<uint8_t>(v <= 0 ? 0 : v >= 255 ? 255 : v); };
  for (int y = 0; y < h; y += 2) {
    const int64_t at = static_cast<int64_t>(y / 2) * chunk;
    if (at + chunk > size) fail("image file is truncated (PhotoCD base image)");
    const uint8_t* p = data + at;
    for (int k = 0; k < 2; ++k) {
      uint8_t* o = out + static_cast<int64_t>(y + k) * w * 3;
      for (int x = 0; x < w; ++x, o += 3) {
        const int l = L[p[x + k * w]], c1 = p[(x + 4 * w) / 2], c2 = p[(x + 5 * w) / 2];
        o[0] = clamp(l + CR[c2]);
        o[1] = clamp(l + GR[c2] + GB[c1]);
        o[2] = clamp(l + CB[c1]);
      }
    }
  }
}

// ---- XBM: XbmDecode.c -----------------------------------------------------------------

int hex_digit(uint8_t v) {
  return v >= '0' && v <= '9' ? v - '0' : v >= 'a' && v <= 'f' ? v - 'a' + 10
                                        : v >= 'A' && v <= 'F' ? v - 'A' + 10 : 0;
}

void xbm_decode(const uint8_t* data, int64_t size, int64_t width, int64_t height, uint8_t* out) {
  const int64_t total = (width + 7) / 8 * height;
  int64_t p = 0;
  for (int64_t o = 0; o < total; ++o) {
    while (p < size && data[p] != 'x') ++p;
    if (size - p < 3) fail("image file is truncated (XBM data ends early)");
    out[o] = static_cast<uint8_t>((hex_digit(data[p + 1]) << 4) + hex_digit(data[p + 2]));
    p += 3;
  }
}

// ---- XPM: XpmDecoder's palette lookup -------------------------------------------------

int64_t xpm_lookup(const uint8_t* data, const int64_t* ends, int64_t lines, int64_t bpp,
                   const uint8_t* keys, const int64_t* key_ends, int64_t nkeys, int64_t pixels,
                   int32_t* out, int64_t cap) {
  std::unordered_map<std::string, int32_t> index;
  for (int64_t k = 0, start = 0; k < nkeys; start = key_ends[k++]) {
    index.emplace(std::string(reinterpret_cast<const char*>(keys + start),
                              static_cast<size_t>(key_ends[k] - start)),
                  static_cast<int32_t>(k));
  }
  int64_t made = 0;
  for (int64_t l = 0, start = 0; l < lines && made < pixels; start = ends[l++]) {
    for (int64_t i = start; i < ends[l]; i += bpp) {
      const int64_t n = std::min(bpp, ends[l] - i);
      const auto it = index.find(std::string(reinterpret_cast<const char*>(data + i),
                                             static_cast<size_t>(n)));
      if (it == index.end()) {
        fail("XPM pixel key '" + std::string(reinterpret_cast<const char*>(data + i),
                                             static_cast<size_t>(n)) +
             "' is not in the palette");
      }
      if (made < cap) out[made] = it->second;
      ++made;
    }
  }
  return made;
}

// ---- IM's n-bit samples: BitDecode.c --------------------------------------------------

void bit_decode(const uint8_t* data, int64_t size, int bits, int pad, int fill, int sign,
                int64_t width, int64_t height, int ystep, float* out) {
  if (bits < 1 || bits >= 32) fail("bit decoder of " + std::to_string(bits) + " bits");
  const unsigned long mask = (1UL << bits) - 1;
  const unsigned long signmask = sign ? 1UL << (bits - 1) : 0;
  unsigned long bitbuffer = 0;
  int bitcount = 0;
  int64_t y = ystep < 0 ? height - 1 : 0, x = 0;
  const int64_t dy = ystep < 0 ? -1 : 1;
  for (int64_t i = 0; i < size; ++i) {
    const uint8_t byte = data[i];
    if (fill & 1) {
      bitbuffer |= static_cast<unsigned long>(byte) << bitcount;
    } else {
      bitbuffer = (bitbuffer << 8) | byte;
    }
    bitcount += 8;
    while (bitcount >= bits) {
      unsigned long v;
      if (fill & 2) {
        v = bitbuffer & mask;
        if (bitcount > 32) {
          bitbuffer = byte >> (8 - (bitcount - bits));
        } else {
          bitbuffer >>= bits;
        }
      } else {
        v = (bitbuffer >> (bitcount - bits)) & mask;
      }
      bitcount -= bits;
      float pixel;
      if (sign && (v & signmask)) {
        pixel = static_cast<float>(static_cast<int32_t>(v | ~mask));
      } else {
        pixel = static_cast<float>(v);
      }
      out[y * width + x] = pixel;
      if (++x >= width) {
        y += dy;
        if (y < 0 || y >= height) return;
        x = 0;
        if (pad > 0) bitcount = 0;
      }
    }
  }
  fail("image file is truncated (IM samples end early)");
}

}  // namespace

#define W3D_PLUGIN_GUARD(body)                 \
  try {                                        \
    body;                                      \
  } catch (const PluginError& e) {             \
    set_message(msg, msg_len, e.msg);          \
  } catch (const std::exception& e) {          \
    set_message(msg, msg_len, e.what());       \
  }                                            \
  return -1;

extern "C" {

int w3d_fli_decode(const uint8_t* frame, int64_t size, int32_t width, int32_t height,
                   uint8_t* out, char* msg, int32_t msg_len) {
  W3D_PLUGIN_GUARD(fli_decode(frame, size, width, height, out); return 0)
}

int64_t w3d_msp_rows(const uint8_t* data, int64_t size, const uint16_t* rowmap, int64_t rows,
                     int64_t width, uint8_t* out, int64_t cap, char* msg, int32_t msg_len) {
  W3D_PLUGIN_GUARD(return msp_rows(data, size, rowmap, rows, out, cap, width))
}

int w3d_pcd_decode(const uint8_t* data, int64_t size, const int16_t* tables, uint8_t* out,
                   char* msg, int32_t msg_len) {
  W3D_PLUGIN_GUARD(pcd_decode(data, size, tables, out); return 0)
}

int w3d_xbm_decode(const uint8_t* data, int64_t size, int64_t width, int64_t height,
                   uint8_t* out, char* msg, int32_t msg_len) {
  W3D_PLUGIN_GUARD(xbm_decode(data, size, width, height, out); return 0)
}

int64_t w3d_xpm_lookup(const uint8_t* data, const int64_t* ends, int64_t lines, int64_t bpp,
                       const uint8_t* keys, const int64_t* key_ends, int64_t nkeys,
                       int64_t pixels, int32_t* out, int64_t cap, char* msg, int32_t msg_len) {
  W3D_PLUGIN_GUARD(return xpm_lookup(data, ends, lines, bpp, keys, key_ends, nkeys, pixels, out,
                                     cap))
}

int w3d_bit_decode(const uint8_t* data, int64_t size, int32_t bits, int32_t pad, int32_t fill,
                   int32_t sign, int64_t width, int64_t height, int32_t ystep, float* out,
                   char* msg, int32_t msg_len) {
  W3D_PLUGIN_GUARD(bit_decode(data, size, bits, pad, fill, sign, width, height, ystep, out);
                   return 0)
}

}  // extern "C"
