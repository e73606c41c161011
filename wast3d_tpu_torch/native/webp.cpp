// wast3d_tpu_torch native WebP and GIF decoding: the byte loops of
// `utils/image_io.decode_webp` and `decode_gif`.
//
// The JAX package reads every image through PIL, which reads WebP through
// libwebp (its WebPAnimDecoder, so frame 0 of an animation too) and GIF
// through its own LZW decoder; the card's machine has no PIL. The RIFF and
// GIF block structure is parsed in Python; every loop over the coded bits is
// here, each following the decoder PIL uses so that the pixels are the same
// bytes:
//
//   w3d_vp8l_decode: WebP lossless (RFC 9649): the predictor (14 modes),
//     cross-colour, subtract-green and colour-indexing transforms (pixel
//     bundling at 1, 2 and 4 bits), simple and normal prefix codes with the
//     code-length code and repeats 16 / 17 / 18, meta prefix codes (the
//     entropy image), LZ77 references with the 120-entry distance map and the
//     colour cache. Out: RGBA. (An ALPH chunk's stream, without the header,
//     goes through the same decoder into its green channel.)
//   w3d_vp8_decode: WebP lossy, a VP8 key frame (RFC 6386): segmentation,
//     1-8 token partitions, the quantiser indices with libwebp's clamps,
//     coefficient probability updates, intra 16x16 / 4x4 / chroma prediction
//     with the 127 / 129 edges, token decoding, dequantisation, the inverse WHT
//     and DCT (20091 / 35468), the simple and normal loop filters; then the
//     Y, U and V planes cropped to the frame and turned to RGBA as libwebp's
//     default output does it (`yuv_to_rgba`).
//   w3d_yuv_to_rgba: libwebp's fancy upsampling of U and V (each output
//     chroma sample from the nearest 2x2 samples with weights 9, 3, 3, 1,
//     rounded in two steps as src/dsp/upsampling.c does) and its integer
//     YUV -> RGB (src/dsp/yuv.h, 14-bit constants, 6 fractional bits).
//   w3d_vp8_idct: the inverse WHT of a 16-coefficient block, or the inverse
//     DCT of one 4x4 block added to a prediction.
//   w3d_alpha_decode: an ALPH chunk: raw or lossless, then libwebp's
//     unfiltering (none, horizontal, vertical, gradient).
//   w3d_gif_lzw: GIF's LZW (codes from the least significant bit, up to 12
//     bits, deferred clear) as Pillow's GifDecode.c reads it.
//
// Every read is bounds-checked: bad or truncated data fails with a reason,
// never reads past its buffer, and every loop is bounded by the pixels it
// fills.
//
// C ABI (ctypes); each returns 0 (w3d_gif_lzw: the bytes written) on success
// and -1 on failure, with a NUL-terminated reason in msg:
//   w3d_vp8l_decode(data, size, width, height, out, msg, msg_len)  out: height x width x 4
//   w3d_vp8_decode(data, size, width, height, out, msg, msg_len)  out: height x width x 4
//   w3d_yuv_to_rgba(y, y_stride, u, v, uv_stride, width, height, out, msg, msg_len)
//   w3d_vp8_idct(coeffs, wht, out, msg, msg_len)     coeffs: int16 x 16; out: int16
//                   x 16 (wht) or uint8 4 x 4 (prediction in, reconstruction out)
//   w3d_alpha_decode(data, size, width, height, out, msg, msg_len)  out: height x width
//   w3d_gif_lzw(data, size, min_code_size, out, out_size, msg, msg_len)

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct WebpError {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw WebpError{msg}; }

void set_message(char* msg, int32_t len, const std::string& s) {
  if (!msg || len <= 0) return;
  snprintf(msg, static_cast<size_t>(len), "%s", s.c_str());
}

constexpr int64_t kMaxPixels = int64_t(1) << 28;  // 16384 x 16384

// Tables of RFC 6386 (quantiser steps, default and update coefficient
// probabilities, 4x4 mode probabilities in libwebp's mode order) and RFC 9649
// (the distance map: (dy << 4) | (8 - dx)).
const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};

const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};

const uint8_t kCoeffsProba0[4][8][3][11] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128, 106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128, 181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128, 1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128, 77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128, 170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128, 1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128, 102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128, 177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128, 1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62, 131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128, 1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128, 81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128, 99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128, 1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128, 44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128, 94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128, 1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128, 35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128, 121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128, 1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128, 137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128, 175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128, 1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128, 155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128, 201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128, 1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128, 141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128, 190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128, 240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128, 213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255, 126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128, 1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128, 39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128, 124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128, 1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128, 28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128, 123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128, 1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128, 47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128, 141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128, 1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};

const uint8_t kCoeffsUpdateProba[4][8][3][11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255, 249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255, 234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255, 250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255, 249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255, 250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255, 234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255, 255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255, 255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255, 252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255, 248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255, 253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255, 252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};

const uint8_t kBModesProba[10][10][9] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112, 152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103, 56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173, 121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26, 170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226, 81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148, 72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128, 41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157, 65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7, 87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194, 66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205, 43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171, 56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64, 34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31, 68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124, 62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111, 60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114, 40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154, 61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71, 142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221, 51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229, 67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154, 40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183, 46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37, 65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223, 87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226, 64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213, 30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255, 31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51, 88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192, 55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82, 95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1, 57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85, 41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6, 101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43, 117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192, 69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171, 62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1, 63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16, 86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128, 58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218, 51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128, 22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197, 56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28, 85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246, 35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45, 85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85, 56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138, 101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20, 138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163, 112, 19, 12, 61, 195, 128, 48, 4, 24,
};

const uint8_t kCodeToPlane[120] = {
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42,
    56, 5, 55, 57, 21, 27, 54, 58, 37, 43, 72, 4,
    71, 73, 20, 28, 53, 59, 70, 74, 36, 44, 88, 69,
    75, 52, 60, 3, 87, 89, 19, 29, 86, 90, 35, 45,
    68, 76, 85, 91, 51, 61, 104, 2, 103, 105, 18, 30,
    102, 106, 34, 46, 84, 92, 67, 77, 101, 107, 50, 62,
    120, 1, 119, 121, 83, 93, 17, 31, 100, 108, 66, 78,
    118, 122, 33, 47, 117, 123, 49, 63, 99, 109, 82, 94,
    0, 116, 124, 65, 79, 16, 32, 98, 110, 48, 115, 125,
    81, 95, 64, 114, 126, 97, 111, 80, 113, 127, 96, 112,
};

// ---- WebP lossless (VP8L) ---------------------------------------------------

// Bits from the least significant bit of each byte; reading past the end
// gives zeros and marks the stream as overrun, which the callers turn into an
// error as libwebp does (VP8LIsEndOfStream).
class LsbReader {
 public:
  LsbReader(const uint8_t* data, size_t size) : data_(data), size_(size) {}
  uint32_t peek(int n) const {  // n <= 32
    const size_t byte = pos_ >> 3;
    uint64_t v = 0;
    if (byte + 8 <= size_) {
      memcpy(&v, data_ + byte, 8);
    } else {
      for (size_t i = 0; i < 8 && byte + i < size_; ++i) v |= uint64_t(data_[byte + i]) << (8 * i);
    }
    return static_cast<uint32_t>((v >> (pos_ & 7)) & ((uint64_t(1) << n) - 1));
  }
  void skip(int n) { pos_ += n; }
  uint32_t read(int n) {
    const uint32_t v = peek(n);
    skip(n);
    return v;
  }
  bool overrun() const { return pos_ > 8 * size_; }

 private:
  const uint8_t* data_;
  size_t size_;
  size_t pos_ = 0;
};

struct HCode {
  uint8_t bits;    // code length, or root bits + subtable bits for a link
  uint16_t value;  // symbol, or the offset of a subtable from its root entry
};

constexpr int kRootBits = 8;
constexpr int kMaxCodeLength = 15;

int next_key(int key, int len) {  // bit-reversed increment of a len-bit key
  int step = 1 << (len - 1);
  while (key & step) step >>= 1;
  return step ? (key & (step - 1)) + step : key;
}

void replicate(HCode* table, int step, int end, HCode code) {
  do {
    end -= step;
    table[end] = code;
  } while (end > 0);
}

int next_table_bits(const int* count, int len, int root_bits) {
  int left = 1 << (len - root_bits);
  while (len < kMaxCodeLength) {
    left -= count[len];
    if (left <= 0) break;
    ++len;
    left <<= 1;
  }
  return len - root_bits;
}

// libwebp's BuildHuffmanTable: a root table of `root_bits` bits and
// second-level tables, appended to `pool`; returns the root's offset. A code
// that is not complete (other than a single symbol, which reads no bits)
// fails, as it does there.
size_t build_table(std::vector<HCode>& pool, int root_bits, const uint8_t* lengths, int n) {
  int count[kMaxCodeLength + 1] = {0};
  for (int s = 0; s < n; ++s) {
    if (lengths[s] > kMaxCodeLength) fail("prefix code length over 15");
    ++count[lengths[s]];
  }
  if (count[0] == n) fail("prefix code with no symbol");
  int offset[kMaxCodeLength + 1];
  offset[1] = 0;
  for (int len = 1; len < kMaxCodeLength; ++len) {
    if (count[len] > (1 << len)) fail("over-subscribed prefix code");
    offset[len + 1] = offset[len] + count[len];
  }
  std::vector<int> sorted(n);
  int total = 0;
  for (int s = 0; s < n; ++s) {
    if (lengths[s]) {
      sorted[offset[lengths[s]]++] = s;
      ++total;
    }
  }
  const size_t root = pool.size();
  const int root_size = 1 << root_bits;
  pool.resize(root + root_size);
  if (total == 1) {
    replicate(&pool[root], 1, root_size, HCode{0, static_cast<uint16_t>(sorted[0])});
    return root;
  }
  int key = 0, num_nodes = 1, num_open = 1, symbol = 0;
  for (int len = 1, step = 2; len <= root_bits; ++len, step <<= 1) {
    num_open <<= 1;
    num_nodes += num_open;
    num_open -= count[len];
    if (num_open < 0) fail("over-subscribed prefix code");
    for (; count[len] > 0; --count[len]) {
      replicate(&pool[root + key], step, root_size,
                HCode{static_cast<uint8_t>(len), static_cast<uint16_t>(sorted[symbol++])});
      key = next_key(key, len);
    }
  }
  const int mask = root_size - 1;
  int low = -1;
  size_t table = root;  // the current subtable (the root at first)
  int table_size = root_size;
  for (int len = root_bits + 1, step = 2; len <= kMaxCodeLength; ++len, step <<= 1) {
    num_open <<= 1;
    num_nodes += num_open;
    num_open -= count[len];
    if (num_open < 0) fail("over-subscribed prefix code");
    for (; count[len] > 0; --count[len]) {
      if ((key & mask) != low) {
        table += table_size;
        const int table_bits = next_table_bits(count, len, root_bits);
        table_size = 1 << table_bits;
        pool.resize(table + table_size);
        low = key & mask;
        pool[root + low] = HCode{static_cast<uint8_t>(table_bits + root_bits),
                                 static_cast<uint16_t>(table - root - low)};
      }
      replicate(&pool[table + (key >> root_bits)], step, table_size,
                HCode{static_cast<uint8_t>(len - root_bits), static_cast<uint16_t>(sorted[symbol++])});
      key = next_key(key, len);
    }
  }
  if (num_nodes != 2 * total - 1) fail("incomplete prefix code");
  return root;
}

inline int read_symbol(const HCode* table, LsbReader& br) {
  const uint32_t val = br.peek(kMaxCodeLength);
  const HCode* e = table + (val & ((1 << kRootBits) - 1));
  if (e->bits > kRootBits) {
    br.skip(kRootBits);
    const int nbits = e->bits - kRootBits;
    e += e->value + ((val >> kRootBits) & ((1u << nbits) - 1));
  }
  br.skip(e->bits);
  return e->value;
}

constexpr int kNumLiteralCodes = 256;
constexpr int kNumLengthCodes = 24;
constexpr int kNumDistanceCodes = 40;
constexpr int kCodeLengthCodes = 19;
const uint8_t kCodeLengthCodeOrder[kCodeLengthCodes] = {17, 18, 0, 1,  2,  3,  4,  5,  16, 6,
                                                        7,  8,  9, 10, 11, 12, 13, 14, 15};

struct HGroup {
  size_t table[5];  // green (+ lengths + cache), red, blue, alpha, distance
};

class VP8LDecoder {
 public:
  VP8LDecoder(const uint8_t* data, size_t size) : br_(data, size) {}

  // The main image (or an alpha stream): ARGB, width x height.
  std::vector<uint32_t> decode(int width, int height) {
    if (int64_t(width) * height > kMaxPixels) fail("lossless image too large");
    return decode_stream(width, height, true);
  }

 private:
  LsbReader br_;
  struct Transform {
    int type, bits, xsize, ysize;
    std::vector<uint32_t> data;
  };
  std::vector<Transform> transforms_;
  unsigned seen_ = 0;
  std::vector<HCode> pool_;

  static int subsample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

  void check() const {
    if (br_.overrun()) fail("truncated lossless stream");
  }

  std::vector<uint32_t> decode_stream(int xsize, int ysize, bool level0) {
    if (level0) {
      while (br_.read(1)) read_transform(&xsize, ysize);
    }
    int cache_bits = 0;
    if (br_.read(1)) {
      cache_bits = br_.read(4);
      if (cache_bits < 1 || cache_bits > 11) fail("bad colour cache size");
    }
    // Prefix codes, with the entropy image when level0.
    int huff_bits = 0, huff_xsize = 0;
    std::vector<uint32_t> huff_image;
    int num_groups = 1;
    if (level0 && br_.read(1)) {
      huff_bits = br_.read(3) + 2;
      huff_xsize = subsample(xsize, huff_bits);
      huff_image = decode_stream(huff_xsize, subsample(ysize, huff_bits), false);
      for (uint32_t& v : huff_image) {
        v = (v >> 8) & 0xffff;
        num_groups = std::max<int>(num_groups, static_cast<int>(v) + 1);
      }
    }
    check();
    // Every group is read; only those the entropy image uses are kept.
    std::vector<int> mapping;
    int kept = num_groups;
    if (!huff_image.empty() && num_groups > static_cast<int>(huff_image.size())) {
      mapping.assign(num_groups, -1);
      kept = 0;
      for (uint32_t& v : huff_image) {
        if (mapping[v] < 0) mapping[v] = kept++;
        v = mapping[v];
      }
    }
    std::vector<HGroup> groups(kept);
    const int cache_size = cache_bits ? 1 << cache_bits : 0;
    const int sizes[5] = {kNumLiteralCodes + kNumLengthCodes + cache_size, kNumLiteralCodes,
                          kNumLiteralCodes, kNumLiteralCodes, kNumDistanceCodes};
    for (int g = 0; g < num_groups; ++g) {
      const bool keep = mapping.empty() || mapping[g] >= 0;
      const size_t mark = pool_.size();
      HGroup group;
      for (int j = 0; j < 5; ++j) group.table[j] = read_code(sizes[j]);
      if (keep) {
        groups[mapping.empty() ? g : mapping[g]] = group;
      } else {
        pool_.resize(mark);
      }
    }
    check();
    std::vector<uint32_t> data(size_t(xsize) * ysize);
    decode_pixels(data.data(), xsize, ysize, groups, huff_image, huff_bits, huff_xsize, cache_bits);
    if (level0) {
      for (int i = static_cast<int>(transforms_.size()) - 1; i >= 0; --i) {
        data = inverse_transform(transforms_[i], data);
      }
    }
    return data;
  }

  void read_transform(int* xsize, int ysize) {
    const int type = br_.read(2);
    if (seen_ & (1u << type)) fail("lossless transform repeated");
    seen_ |= 1u << type;
    Transform t{type, 0, *xsize, ysize, {}};
    if (type == 0 || type == 1) {  // predictor, cross-colour
      t.bits = br_.read(3) + 2;
      t.data = decode_stream(subsample(t.xsize, t.bits), subsample(ysize, t.bits), false);
    } else if (type == 3) {  // colour indexing
      const int num_colors = br_.read(8) + 1;
      t.bits = num_colors > 16 ? 0 : num_colors > 4 ? 1 : num_colors > 2 ? 2 : 3;
      *xsize = subsample(t.xsize, t.bits);
      std::vector<uint32_t> pal = decode_stream(num_colors, 1, false);
      t.data.assign(size_t(1) << (8 >> t.bits), 0);
      const uint8_t* src = reinterpret_cast<const uint8_t*>(pal.data());
      uint8_t* dst = reinterpret_cast<uint8_t*>(t.data.data());
      for (int i = 0; i < 4; ++i) dst[i] = src[i];
      for (int i = 4; i < 4 * num_colors; ++i) dst[i] = static_cast<uint8_t>(src[i] + dst[i - 4]);
    }
    check();
    transforms_.push_back(std::move(t));
  }

  size_t read_code(int alphabet) {
    std::vector<uint8_t> lengths(std::max(alphabet, 256), 0);
    if (br_.read(1)) {  // simple: 1 or 2 symbols
      const int num = br_.read(1) + 1;
      const int first_bits = br_.read(1) ? 8 : 1;
      lengths[br_.read(first_bits)] = 1;
      if (num == 2) lengths[br_.read(8)] = 1;
    } else {
      uint8_t cl_lengths[kCodeLengthCodes] = {0};
      const int num = br_.read(4) + 4;
      for (int i = 0; i < num; ++i) cl_lengths[kCodeLengthCodeOrder[i]] = br_.read(3);
      read_code_lengths(cl_lengths, alphabet, lengths.data());
    }
    check();
    return build_table(pool_, kRootBits, lengths.data(), alphabet);
  }

  void read_code_lengths(const uint8_t* cl_lengths, int num_symbols, uint8_t* lengths) {
    std::vector<HCode> table;
    build_table(table, 7, cl_lengths, kCodeLengthCodes);
    int max_symbol = num_symbols;
    if (br_.read(1)) {
      const int nbits = 2 + 2 * br_.read(3);
      max_symbol = 2 + br_.read(nbits);
      if (max_symbol > num_symbols) fail("prefix code lengths past the alphabet");
    }
    int prev = 8, symbol = 0;
    while (symbol < num_symbols) {
      if (max_symbol-- == 0) break;
      const HCode& e = table[br_.peek(7)];
      br_.skip(e.bits);
      const int len = e.value;
      if (len < 16) {
        lengths[symbol++] = static_cast<uint8_t>(len);
        if (len) prev = len;
      } else {
        static const int kExtra[3] = {2, 3, 7}, kOffset[3] = {3, 3, 11};
        int repeat = br_.read(kExtra[len - 16]) + kOffset[len - 16];
        if (symbol + repeat > num_symbols) fail("prefix code length repeat past the alphabet");
        const int v = len == 16 ? prev : 0;
        while (repeat-- > 0) lengths[symbol++] = static_cast<uint8_t>(v);
      }
      if (br_.overrun()) break;
    }
    check();
  }

  static int prefix_value(int symbol, LsbReader& br) {  // lengths and distances
    if (symbol < 4) return symbol + 1;
    const int extra = (symbol - 2) >> 1;
    const int offset = (2 + (symbol & 1)) << extra;
    return offset + br.read(extra) + 1;
  }

  void decode_pixels(uint32_t* data, int width, int height, const std::vector<HGroup>& groups,
                     const std::vector<uint32_t>& huff_image, int huff_bits, int huff_xsize,
                     int cache_bits) {
    const size_t total = size_t(width) * height;
    std::vector<uint32_t> cache(cache_bits ? size_t(1) << cache_bits : 0);
    const int cache_shift = 32 - cache_bits;
    const HCode* pool = pool_.data();
    auto insert = [&](uint32_t argb) {
      if (cache_bits) cache[(0x1e35a7bdu * argb) >> cache_shift] = argb;
    };
    size_t pos = 0;
    int x = 0, y = 0;
    const HGroup* g = &groups[0];
    while (pos < total) {
      if (!huff_image.empty() && (x & ((1 << huff_bits) - 1)) == 0) {
        g = &groups[huff_image[size_t(y >> huff_bits) * huff_xsize + (x >> huff_bits)]];
      }
      const int code = read_symbol(pool + g->table[0], br_);
      if (br_.overrun()) break;
      if (code < kNumLiteralCodes) {
        const uint32_t red = read_symbol(pool + g->table[1], br_);
        const uint32_t blue = read_symbol(pool + g->table[2], br_);
        const uint32_t alpha = read_symbol(pool + g->table[3], br_);
        const uint32_t argb = (alpha << 24) | (red << 16) | (uint32_t(code) << 8) | blue;
        data[pos++] = argb;
        insert(argb);
        if (++x >= width) {
          x = 0;
          ++y;
        }
      } else if (code < kNumLiteralCodes + kNumLengthCodes) {
        const int length = prefix_value(code - kNumLiteralCodes, br_);
        const int dist_symbol = read_symbol(pool + g->table[4], br_);
        const int dist_code = prefix_value(dist_symbol, br_);
        int64_t dist;
        if (dist_code > 120) {
          dist = dist_code - 120;
        } else {
          const int v = kCodeToPlane[dist_code - 1];
          dist = int64_t(v >> 4) * width + (8 - (v & 0xf));
          if (dist < 1) dist = 1;
        }
        if (br_.overrun()) break;
        if (int64_t(pos) < dist || int64_t(total - pos) < length) fail("lossless backward reference out of the image");
        for (int i = 0; i < length; ++i, ++pos) {
          data[pos] = data[pos - dist];
          insert(data[pos]);
        }
        x += length;
        while (x >= width) {
          x -= width;
          ++y;
        }
        if (!huff_image.empty()) {
          g = &groups[huff_image[size_t(y >> huff_bits) * huff_xsize + (x >> huff_bits)]];
        }
      } else {
        const int key = code - (kNumLiteralCodes + kNumLengthCodes);
        if (key >= static_cast<int>(cache.size())) fail("lossless colour cache code out of range");
        const uint32_t argb = cache[key];
        data[pos++] = argb;
        insert(argb);
        if (++x >= width) {
          x = 0;
          ++y;
        }
      }
    }
    check();
  }

  static uint32_t add_pixels(uint32_t a, uint32_t b) {
    const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
    const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
    return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
  }
  static uint32_t average2(uint32_t a, uint32_t b) { return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b); }
  static int clip255(int a) { return a < 0 ? 0 : a > 255 ? 255 : a; }
  static uint32_t select(uint32_t a, uint32_t b, uint32_t c) {  // a = top, b = left
    int pa_minus_pb = 0;
    for (int s = 0; s < 32; s += 8) {
      const int ac = int((a >> s) & 0xff), bc = int((b >> s) & 0xff), cc = int((c >> s) & 0xff);
      pa_minus_pb += std::abs(bc - cc) - std::abs(ac - cc);
    }
    return pa_minus_pb <= 0 ? a : b;
  }
  static uint32_t add_subtract_full(uint32_t a, uint32_t b, uint32_t c) {
    uint32_t out = 0;
    for (int s = 0; s < 32; s += 8) {
      const int v = int((a >> s) & 0xff) + int((b >> s) & 0xff) - int((c >> s) & 0xff);
      out |= uint32_t(clip255(v)) << s;
    }
    return out;
  }
  static uint32_t add_subtract_half(uint32_t a, uint32_t b, uint32_t c) {
    const uint32_t ave = average2(a, b);
    uint32_t out = 0;
    for (int s = 0; s < 32; s += 8) {
      const int x = int((ave >> s) & 0xff), y = int((c >> s) & 0xff);
      out |= uint32_t(clip255(x + (x - y) / 2)) << s;
    }
    return out;
  }
  static uint32_t predict(int mode, const uint32_t* cur, const uint32_t* top) {
    const uint32_t L = cur[-1];
    switch (mode) {
      case 1: return L;
      case 2: return top[0];
      case 3: return top[1];
      case 4: return top[-1];
      case 5: return average2(average2(L, top[1]), top[0]);
      case 6: return average2(L, top[-1]);
      case 7: return average2(L, top[0]);
      case 8: return average2(top[-1], top[0]);
      case 9: return average2(top[0], top[1]);
      case 10: return average2(average2(L, top[-1]), average2(top[0], top[1]));
      case 11: return select(top[0], L, top[-1]);
      case 12: return add_subtract_full(L, top[0], top[-1]);
      case 13: return add_subtract_half(L, top[0], top[-1]);
      default: return 0xff000000u;  // 0, and 14 / 15 as libwebp pads them
    }
  }

  static std::vector<uint32_t> inverse_transform(const Transform& t, std::vector<uint32_t>& in) {
    const int w = t.xsize, h = t.ysize;
    if (t.type == 2) {  // subtract green
      for (uint32_t& p : in) {
        const uint32_t g = (p >> 8) & 0xff;
        const uint32_t rb = ((p & 0x00ff00ffu) + ((g << 16) | g)) & 0x00ff00ffu;
        p = (p & 0xff00ff00u) | rb;
      }
      return std::move(in);
    }
    if (t.type == 0) {  // predictor
      uint32_t* d = in.data();
      const int tiles = subsample(w, t.bits);
      d[0] = add_pixels(d[0], 0xff000000u);
      for (int x = 1; x < w; ++x) d[x] = add_pixels(d[x], d[x - 1]);
      for (int y = 1; y < h; ++y) {
        uint32_t* row = d + size_t(y) * w;
        const uint32_t* modes = t.data.data() + size_t(y >> t.bits) * tiles;
        row[0] = add_pixels(row[0], row[-w]);
        for (int x = 1; x < w; ++x) {
          const int mode = (modes[x >> t.bits] >> 8) & 0xf;
          row[x] = add_pixels(row[x], predict(mode, row + x, row + x - w));
        }
      }
      return std::move(in);
    }
    if (t.type == 1) {  // cross colour
      const int tiles = subsample(w, t.bits);
      for (int y = 0; y < h; ++y) {
        uint32_t* row = in.data() + size_t(y) * w;
        const uint32_t* codes = t.data.data() + size_t(y >> t.bits) * tiles;
        for (int x = 0; x < w; ++x) {
          const uint32_t m = codes[x >> t.bits];
          const int8_t g2r = int8_t(m & 0xff), g2b = int8_t((m >> 8) & 0xff), r2b = int8_t((m >> 16) & 0xff);
          const uint32_t argb = row[x];
          const int8_t green = int8_t((argb >> 8) & 0xff);
          int r = int((argb >> 16) & 0xff), b = int(argb & 0xff);
          r = (r + ((int(g2r) * green) >> 5)) & 0xff;
          b += (int(g2b) * green) >> 5;
          b += (int(r2b) * int8_t(r)) >> 5;
          b &= 0xff;
          row[x] = (argb & 0xff00ff00u) | (uint32_t(r) << 16) | uint32_t(b);
        }
      }
      return std::move(in);
    }
    // colour indexing: `in` is (w >> bits) wide, bundled indices in green
    const int bits_per_pixel = 8 >> t.bits;
    const int per_byte_mask = (1 << t.bits) - 1;
    const uint32_t index_mask = (1u << bits_per_pixel) - 1;
    const int in_w = subsample(w, t.bits);
    std::vector<uint32_t> out(size_t(w) * h);
    for (int y = 0; y < h; ++y) {
      const uint32_t* src = in.data() + size_t(y) * in_w;
      uint32_t* dst = out.data() + size_t(y) * w;
      uint32_t packed = 0;
      for (int x = 0; x < w; ++x) {
        if ((x & per_byte_mask) == 0) packed = (*src++ >> 8) & 0xff;
        dst[x] = t.data[packed & index_mask];
        packed >>= bits_per_pixel;
      }
    }
    return out;
  }
};

void vp8l_decode(const uint8_t* data, size_t size, int width, int height, bool headerless,
                 uint8_t* out, int channels) {
  size_t start = 0;
  if (!headerless) {
    if (size < 5 || data[0] != 0x2f) fail("not a lossless (VP8L) stream");
    const uint32_t bits = uint32_t(data[1]) | (uint32_t(data[2]) << 8) | (uint32_t(data[3]) << 16) |
                          (uint32_t(data[4]) << 24);
    if (int((bits & 0x3fff) + 1) != width || int(((bits >> 14) & 0x3fff) + 1) != height) {
      fail("lossless stream size differs from its frame");
    }
    if ((bits >> 29) != 0) fail("unknown lossless version");
    start = 5;
  }
  VP8LDecoder dec(data + start, size - start);
  const std::vector<uint32_t> argb = dec.decode(width, height);
  const size_t n = size_t(width) * height;
  if (channels == 1) {
    for (size_t i = 0; i < n; ++i) out[i] = static_cast<uint8_t>(argb[i] >> 8);
  } else {
    for (size_t i = 0; i < n; ++i) {
      const uint32_t p = argb[i];
      out[4 * i] = uint8_t(p >> 16);
      out[4 * i + 1] = uint8_t(p >> 8);
      out[4 * i + 2] = uint8_t(p);
      out[4 * i + 3] = uint8_t(p >> 24);
    }
  }
}

// ---- WebP lossy (VP8 key frame) ------------------------------------------------

// libwebp's boolean decoder, a byte at a time (range kept minus one); the end
// of the data reads one zero byte and marks the partition as ended.
class BoolReader {
 public:
  BoolReader() = default;
  BoolReader(const uint8_t* p, size_t n) : buf_(p), end_(p + n) { load(); }
  int bit(int prob) {
    uint32_t range = range_;
    if (bits_ < 0) load();
    const int pos = bits_;
    const uint32_t split = (range * uint32_t(prob)) >> 8;
    const uint32_t value = static_cast<uint32_t>(value_ >> pos);
    int bit;
    if (value > split) {
      range -= split;
      value_ -= uint64_t(split + 1) << pos;
      bit = 1;
    } else {
      range = split + 1;
      bit = 0;
    }
    int shift = 0;
    while ((range << shift) < 128) ++shift;
    range <<= shift;
    bits_ -= shift;
    range_ = range - 1;
    return bit;
  }
  uint32_t value(int nbits) {
    uint32_t v = 0;
    while (nbits-- > 0) v |= uint32_t(bit(0x80)) << nbits;
    return v;
  }
  int signed_value(int nbits) {
    const int v = static_cast<int>(value(nbits));
    return bit(0x80) ? -v : v;
  }
  bool eof() const { return eof_; }

 private:
  void load() {
    if (buf_ < end_) {
      bits_ += 8;
      value_ = (value_ << 8) | *buf_++;
    } else if (!eof_) {
      value_ <<= 8;
      bits_ += 8;
      eof_ = true;
    } else {
      bits_ = 0;
    }
  }
  const uint8_t* buf_ = nullptr;
  const uint8_t* end_ = nullptr;
  uint64_t value_ = 0;
  uint32_t range_ = 255 - 1;
  int bits_ = -8;
  bool eof_ = false;
};

enum { B_DC_PRED = 0, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_RD_PRED, B_VR_PRED, B_LD_PRED,
       B_VL_PRED, B_HD_PRED, B_HU_PRED,
       DC_PRED = B_DC_PRED, V_PRED = B_VE_PRED, H_PRED = B_HE_PRED, TM_PRED = B_TM_PRED,
       B_DC_PRED_NOTOP = 10, B_DC_PRED_NOLEFT, B_DC_PRED_NOTOPLEFT };

const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

constexpr int BPS = 32;  // the work buffer's stride, as libwebp's
constexpr int kYOff = BPS * 1 + 8;
constexpr int kUOff = kYOff + BPS * 16 + BPS;
constexpr int kVOff = kUOff + 16;
constexpr int kWorkSize = BPS * 17 + BPS * 9;

inline uint8_t clip8(int v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); }

// ---- inverse transforms (src/dsp/dec.c) ----

// The products wrap at 32 bits, as libwebp's C does on x86; they only can for
// coefficients near the int16 limits, which no encoder writes.
inline int wrap_mul(int a, uint32_t k) { return static_cast<int32_t>(static_cast<uint32_t>(a) * k); }
inline int mul1(int a) { return (wrap_mul(a, 20091) >> 16) + a; }
inline int mul2(int a) { return wrap_mul(a, 35468) >> 16; }

void transform_one(const int16_t* in, uint8_t* dst, int stride) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {  // vertical pass
    const int a = in[i] + in[8 + i];
    const int b = in[i] - in[8 + i];
    const int c = mul2(in[4 + i]) - mul1(in[12 + i]);
    const int d = mul1(in[4 + i]) + mul2(in[12 + i]);
    tmp[4 * i + 0] = a + d;
    tmp[4 * i + 1] = b + c;
    tmp[4 * i + 2] = b - c;
    tmp[4 * i + 3] = a - d;
  }
  for (int i = 0; i < 4; ++i) {  // horizontal pass
    const int dc = tmp[i] + 4;
    const int a = dc + tmp[8 + i];
    const int b = dc - tmp[8 + i];
    const int c = mul2(tmp[4 + i]) - mul1(tmp[12 + i]);
    const int d = mul1(tmp[4 + i]) + mul2(tmp[12 + i]);
    uint8_t* row = dst + i * stride;
    row[0] = clip8(row[0] + ((a + d) >> 3));
    row[1] = clip8(row[1] + ((b + c) >> 3));
    row[2] = clip8(row[2] + ((b - c) >> 3));
    row[3] = clip8(row[3] + ((a - d) >> 3));
  }
}

void transform_wht(const int16_t* in, int16_t* out) {  // out[16 * k]: block k's DC
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = static_cast<int16_t>((a0 + a1) >> 3);
    out[16] = static_cast<int16_t>((a3 + a2) >> 3);
    out[32] = static_cast<int16_t>((a0 - a1) >> 3);
    out[48] = static_cast<int16_t>((a3 - a2) >> 3);
    out += 64;
  }
}

// ---- intra prediction (src/dsp/dec.c), in the BPS work buffer ----

#define DST(x, y) dst[(x) + (y) * BPS]
inline uint8_t avg3(int a, int b, int c) { return static_cast<uint8_t>((a + 2 * b + c + 2) >> 2); }
inline uint8_t avg2(int a, int b) { return static_cast<uint8_t>((a + b + 1) >> 1); }

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  const int tl = top[-1];
  for (int y = 0; y < size; ++y) {
    const int left = dst[-1];
    for (int x = 0; x < size; ++x) dst[x] = clip8(top[x] + left - tl);
    dst += BPS;
  }
}

void fill(uint8_t* dst, int v, int size) {
  for (int j = 0; j < size; ++j) memset(dst + j * BPS, v, size);
}

void predict_block(uint8_t* dst, int mode, int size) {  // 16x16 luma or 8x8 chroma
  const int shift = size == 16 ? 4 : 3;
  int dc;
  switch (mode) {
    case DC_PRED:
      dc = size;
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS] + dst[j - BPS];
      fill(dst, dc >> (shift + 1), size);
      break;
    case B_DC_PRED_NOTOP:
      dc = size >> 1;
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS];
      fill(dst, dc >> shift, size);
      break;
    case B_DC_PRED_NOLEFT:
      dc = size >> 1;
      for (int j = 0; j < size; ++j) dc += dst[j - BPS];
      fill(dst, dc >> shift, size);
      break;
    case B_DC_PRED_NOTOPLEFT:
      fill(dst, 0x80, size);
      break;
    case TM_PRED:
      true_motion(dst, size);
      break;
    case V_PRED:
      for (int j = 0; j < size; ++j) memcpy(dst + j * BPS, dst - BPS, size);
      break;
    case H_PRED:
      for (int j = 0; j < size; ++j) memset(dst + j * BPS, dst[j * BPS - 1], size);
      break;
    default:
      fail("bad intra mode");
  }
}

void predict4(uint8_t* dst, int mode) {
  const uint8_t* top = dst - BPS;
  const int X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3];
  const int E = top[4], F = top[5], G = top[6], H = top[7];
  const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
  switch (mode) {
    case B_DC_PRED: {
      int dc = 4;
      for (int i = 0; i < 4; ++i) dc += top[i] + dst[-1 + i * BPS];
      for (int i = 0; i < 4; ++i) memset(dst + i * BPS, dc >> 3, 4);
      break;
    }
    case B_TM_PRED:
      true_motion(dst, 4);
      break;
    case B_VE_PRED: {
      const uint8_t vals[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D), avg3(C, D, E)};
      for (int i = 0; i < 4; ++i) memcpy(dst + i * BPS, vals, 4);
      break;
    }
    case B_HE_PRED:
      memset(dst, avg3(X, I, J), 4);
      memset(dst + BPS, avg3(I, J, K), 4);
      memset(dst + 2 * BPS, avg3(J, K, L), 4);
      memset(dst + 3 * BPS, avg3(K, L, L), 4);
      break;
    case B_RD_PRED:
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    case B_LD_PRED:
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    case B_VR_PRED:
      DST(0, 0) = DST(1, 2) = avg2(X, A);
      DST(1, 0) = DST(2, 2) = avg2(A, B);
      DST(2, 0) = DST(3, 2) = avg2(B, C);
      DST(3, 0) = avg2(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    case B_VL_PRED:
      DST(0, 0) = avg2(A, B);
      DST(1, 0) = DST(0, 2) = avg2(B, C);
      DST(2, 0) = DST(1, 2) = avg2(C, D);
      DST(3, 0) = DST(2, 2) = avg2(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    case B_HD_PRED:
      DST(0, 0) = DST(2, 1) = avg2(I, X);
      DST(0, 1) = DST(2, 2) = avg2(J, I);
      DST(0, 2) = DST(2, 3) = avg2(K, J);
      DST(0, 3) = avg2(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = avg3(K, J, I);
      DST(1, 3) = avg3(L, K, J);
      break;
    case B_HU_PRED:
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = static_cast<uint8_t>(L);
      break;
    default:
      fail("bad intra 4x4 mode");
  }
}
#undef DST

// ---- loop filters (src/dsp/dec.c) ----

inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

inline void do_filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}

inline void do_filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}

inline void do_filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}

inline bool hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
}

inline bool needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * std::abs(p0 - q0) + std::abs(p1 - q1) <= t;
}

inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0];
  const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it && std::abs(p1 - p0) <= it &&
         std::abs(q3 - q2) <= it && std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

void simple_filter(uint8_t* p, int hstride, int vstride, int size, int thresh) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < size; ++i, p += vstride) {
    if (needs_filter(p, hstride, t2)) do_filter2(p, hstride);
  }
}

void filter_loop(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh,
                 int hev_thresh, bool edge) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < size; ++i, p += vstride) {
    if (!needs_filter2(p, hstride, t2, ithresh)) continue;
    if (hev(p, hstride, hev_thresh)) {
      do_filter2(p, hstride);
    } else if (edge) {
      do_filter6(p, hstride);
    } else {
      do_filter4(p, hstride);
    }
  }
}

// ---- the frame ----

struct FInfo {
  int limit = 0, ilevel = 0, hev_thresh = 0;
  bool inner = false;
};

struct MBData {
  int16_t coeffs[384];
  uint8_t imodes[16];
  uint8_t uvmode;
  bool is_i4x4, skip;
  int segment;
  uint32_t non_zero_y, non_zero_uv;
};

class VP8Decoder {
 public:
  VP8Decoder(const uint8_t* data, size_t size) : data_(data), size_(size) {}

  // Decodes the key frame; Y, U and V (macroblock-aligned) are then in y_,
  // u_, v_ with strides y_stride_ / uv_stride_.
  void decode(int expect_w, int expect_h) {
    parse_headers(expect_w, expect_h);
    y_stride_ = 16 * mb_w_;
    uv_stride_ = 8 * mb_w_;
    y_.assign(size_t(y_stride_) * 16 * mb_h_, 0);
    u_.assign(size_t(uv_stride_) * 8 * mb_h_, 0);
    v_.assign(size_t(uv_stride_) * 8 * mb_h_, 0);
    finfo_.assign(size_t(mb_w_) * mb_h_, FInfo());
    intra_t_.assign(4 * size_t(mb_w_), B_DC_PRED);
    top_nz_.assign(size_t(mb_w_), 0);
    top_nz_dc_.assign(size_t(mb_w_), 0);
    top_y_.assign(16 * size_t(mb_w_), 0);
    top_u_.assign(8 * size_t(mb_w_), 0);
    top_v_.assign(8 * size_t(mb_w_), 0);
    std::vector<MBData> row(mb_w_);
    for (int mb_y = 0; mb_y < mb_h_; ++mb_y) {
      BoolReader& tokens = parts_[mb_y & (num_parts_ - 1)];
      uint8_t intra_l[4];
      memset(intra_l, B_DC_PRED, 4);
      for (int mb_x = 0; mb_x < mb_w_; ++mb_x) parse_intra_mode(row[mb_x], mb_x, intra_l);
      if (br_.eof()) fail("truncated lossy frame (first partition)");
      left_nz_ = 0;
      left_nz_dc_ = 0;
      for (int mb_x = 0; mb_x < mb_w_; ++mb_x) {
        decode_mb(row[mb_x], mb_x, mb_y, tokens);
        if (tokens.eof()) fail("truncated lossy frame (token partition)");
      }
      reconstruct_row(row, mb_y);
    }
    if (filter_type_ > 0) {
      for (int mb_y = 0; mb_y < mb_h_; ++mb_y) {
        for (int mb_x = 0; mb_x < mb_w_; ++mb_x) filter_mb(mb_x, mb_y);
      }
    }
  }

  int width_ = 0, height_ = 0, mb_w_ = 0, mb_h_ = 0, y_stride_ = 0, uv_stride_ = 0;
  std::vector<uint8_t> y_, u_, v_;

 private:
  const uint8_t* data_;
  size_t size_;
  BoolReader br_;
  BoolReader parts_[8];
  int num_parts_ = 1;
  // segment header
  bool use_segment_ = false, update_map_ = false, absolute_delta_ = true;
  int8_t quantizer_[4] = {0}, filter_strength_[4] = {0};
  uint8_t segment_proba_[3] = {255, 255, 255};
  // filter header
  bool simple_ = false, use_lf_delta_ = false;
  int level_ = 0, sharpness_ = 0, filter_type_ = 0;
  int ref_lf_delta_[4] = {0}, mode_lf_delta_[4] = {0};
  FInfo fstrengths_[4][2];
  // quantisers: y1 [dc, ac], y2, uv
  int y1_mat_[4][2], y2_mat_[4][2], uv_mat_[4][2];
  uint8_t proba_[4][8][3][11];
  bool use_skip_proba_ = false;
  int skip_p_ = 0;
  std::vector<FInfo> finfo_;
  std::vector<uint8_t> intra_t_;
  std::vector<uint8_t> top_nz_, top_nz_dc_;  // per mb_x: 4 y bits, 2 u bits, 2 v bits
  uint8_t left_nz_ = 0, left_nz_dc_ = 0;
  std::vector<uint8_t> top_y_, top_u_, top_v_;  // unfiltered bottom rows of the row above
  uint8_t work_[kWorkSize];

  void parse_headers(int expect_w, int expect_h) {
    if (size_ < 10) fail("truncated lossy frame header");
    const uint32_t bits = data_[0] | (data_[1] << 8) | (data_[2] << 16);
    const bool key_frame = !(bits & 1);
    const int profile = (bits >> 1) & 7;
    const bool show = (bits >> 4) & 1;
    const uint32_t part0 = bits >> 5;
    if (!key_frame) fail("lossy frame is not a key frame");
    if (profile > 3) fail("bad lossy frame profile");
    if (!show) fail("lossy frame is not shown");
    if (data_[3] != 0x9d || data_[4] != 0x01 || data_[5] != 0x2a) fail("bad lossy frame start code");
    width_ = ((data_[7] << 8) | data_[6]) & 0x3fff;
    height_ = ((data_[9] << 8) | data_[8]) & 0x3fff;
    if (width_ == 0 || height_ == 0) fail("lossy frame of size 0");
    if (width_ != expect_w || height_ != expect_h) fail("lossy frame size differs from its container");
    mb_w_ = (width_ + 15) >> 4;
    mb_h_ = (height_ + 15) >> 4;
    const uint8_t* buf = data_ + 10;
    size_t left = size_ - 10;
    if (part0 >= size_ || part0 > left) fail("bad lossy partition length");
    br_ = BoolReader(buf, part0);
    buf += part0;
    left -= part0;
    br_.value(1);  // colour space
    br_.value(1);  // clamping type
    // segments
    use_segment_ = br_.value(1);
    if (use_segment_) {
      update_map_ = br_.value(1);
      if (br_.value(1)) {  // update data
        absolute_delta_ = br_.value(1);
        for (int s = 0; s < 4; ++s) quantizer_[s] = br_.value(1) ? br_.signed_value(7) : 0;
        for (int s = 0; s < 4; ++s) filter_strength_[s] = br_.value(1) ? br_.signed_value(6) : 0;
      }
      if (update_map_) {
        for (int s = 0; s < 3; ++s) segment_proba_[s] = br_.value(1) ? br_.value(8) : 255;
      }
    } else {
      update_map_ = false;
    }
    if (br_.eof()) fail("cannot parse the lossy segment header");
    // loop filter
    simple_ = br_.value(1);
    level_ = br_.value(6);
    sharpness_ = br_.value(3);
    use_lf_delta_ = br_.value(1);
    if (use_lf_delta_ && br_.value(1)) {
      for (int i = 0; i < 4; ++i) {
        if (br_.value(1)) ref_lf_delta_[i] = br_.signed_value(6);
      }
      for (int i = 0; i < 4; ++i) {
        if (br_.value(1)) mode_lf_delta_[i] = br_.signed_value(6);
      }
    }
    filter_type_ = level_ == 0 ? 0 : simple_ ? 1 : 2;
    if (br_.eof()) fail("cannot parse the lossy filter header");
    // token partitions
    const int last = (1 << br_.value(2)) - 1;
    num_parts_ = last + 1;
    if (left < size_t(3 * last)) fail("cannot read the lossy partition sizes");
    const uint8_t* sz = buf;
    const uint8_t* start = buf + 3 * last;
    size_t size_left = left - 3 * last;
    for (int p = 0; p < last; ++p) {
      size_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
      if (psize > size_left) psize = size_left;
      parts_[p] = BoolReader(start, psize);
      start += psize;
      size_left -= psize;
      sz += 3;
    }
    if (size_left == 0) fail("truncated lossy frame (no last partition)");
    parts_[last] = BoolReader(start, size_left);
    parse_quant();
    br_.value(1);  // refresh entropy probabilities: ignored for a key frame
    for (int t = 0; t < 4; ++t)
      for (int b = 0; b < 8; ++b)
        for (int c = 0; c < 3; ++c)
          for (int p = 0; p < 11; ++p)
            proba_[t][b][c][p] = br_.bit(kCoeffsUpdateProba[t][b][c][p]) ? br_.value(8)
                                                                          : kCoeffsProba0[t][b][c][p];
    use_skip_proba_ = br_.value(1);
    if (use_skip_proba_) skip_p_ = br_.value(8);
    precompute_filter_strengths();
  }

  void parse_quant() {
    const int base_q0 = br_.value(7);
    const int dqy1_dc = br_.value(1) ? br_.signed_value(4) : 0;
    const int dqy2_dc = br_.value(1) ? br_.signed_value(4) : 0;
    const int dqy2_ac = br_.value(1) ? br_.signed_value(4) : 0;
    const int dquv_dc = br_.value(1) ? br_.signed_value(4) : 0;
    const int dquv_ac = br_.value(1) ? br_.signed_value(4) : 0;
    auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
    for (int i = 0; i < 4; ++i) {
      int q;
      if (use_segment_) {
        q = quantizer_[i];
        if (!absolute_delta_) q += base_q0;
      } else {
        if (i > 0) {
          memcpy(y1_mat_[i], y1_mat_[0], sizeof(y1_mat_[0]));
          memcpy(y2_mat_[i], y2_mat_[0], sizeof(y2_mat_[0]));
          memcpy(uv_mat_[i], uv_mat_[0], sizeof(uv_mat_[0]));
          continue;
        }
        q = base_q0;
      }
      y1_mat_[i][0] = kDcTable[clip(q + dqy1_dc, 127)];
      y1_mat_[i][1] = kAcTable[clip(q, 127)];
      y2_mat_[i][0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
      y2_mat_[i][1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;  // x 155 / 100
      if (y2_mat_[i][1] < 8) y2_mat_[i][1] = 8;
      uv_mat_[i][0] = kDcTable[clip(q + dquv_dc, 117)];
      uv_mat_[i][1] = kAcTable[clip(q + dquv_ac, 127)];
    }
  }

  void precompute_filter_strengths() {
    if (filter_type_ == 0) return;
    for (int s = 0; s < 4; ++s) {
      int base = level_;
      if (use_segment_) {
        base = filter_strength_[s];
        if (!absolute_delta_) base += level_;
      }
      for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
        FInfo& info = fstrengths_[s][i4x4];
        int level = base;
        if (use_lf_delta_) {
          level += ref_lf_delta_[0];
          if (i4x4) level += mode_lf_delta_[0];
        }
        level = level < 0 ? 0 : level > 63 ? 63 : level;
        if (level > 0) {
          int ilevel = level;
          if (sharpness_ > 0) {
            ilevel >>= sharpness_ > 4 ? 2 : 1;
            if (ilevel > 9 - sharpness_) ilevel = 9 - sharpness_;
          }
          if (ilevel < 1) ilevel = 1;
          info.ilevel = ilevel;
          info.limit = 2 * level + ilevel;
          info.hev_thresh = level >= 40 ? 2 : level >= 15 ? 1 : 0;
        } else {
          info.limit = 0;
        }
        info.inner = i4x4;
      }
    }
  }

  void parse_intra_mode(MBData& mb, int mb_x, uint8_t* left) {
    uint8_t* top = &intra_t_[4 * mb_x];
    if (update_map_) {
      mb.segment = !br_.bit(segment_proba_[0]) ? br_.bit(segment_proba_[1])
                                                : br_.bit(segment_proba_[2]) + 2;
    } else {
      mb.segment = 0;
    }
    mb.skip = use_skip_proba_ ? br_.bit(skip_p_) : false;
    mb.is_i4x4 = !br_.bit(145);
    if (!mb.is_i4x4) {
      const int ymode = br_.bit(156) ? (br_.bit(128) ? TM_PRED : H_PRED)
                                     : (br_.bit(163) ? V_PRED : DC_PRED);
      mb.imodes[0] = static_cast<uint8_t>(ymode);
      memset(top, ymode, 4);
      memset(left, ymode, 4);
    } else {
      uint8_t* modes = mb.imodes;
      for (int y = 0; y < 4; ++y) {
        int ymode = left[y];
        for (int x = 0; x < 4; ++x) {
          const uint8_t* prob = kBModesProba[top[x]][ymode];
          ymode = !br_.bit(prob[0]) ? B_DC_PRED
                  : !br_.bit(prob[1]) ? B_TM_PRED
                  : !br_.bit(prob[2]) ? B_VE_PRED
                  : !br_.bit(prob[3])
                      ? (!br_.bit(prob[4]) ? B_HE_PRED : (!br_.bit(prob[5]) ? B_RD_PRED : B_VR_PRED))
                      : (!br_.bit(prob[6]) ? B_LD_PRED
                         : (!br_.bit(prob[7]) ? B_VL_PRED : (!br_.bit(prob[8]) ? B_HD_PRED : B_HU_PRED)));
          top[x] = static_cast<uint8_t>(ymode);
        }
        memcpy(modes, top, 4);
        modes += 4;
        left[y] = static_cast<uint8_t>(ymode);
      }
    }
    mb.uvmode = !br_.bit(142) ? DC_PRED : !br_.bit(114) ? V_PRED : br_.bit(183) ? TM_PRED : H_PRED;
  }

  // The coefficients of one block from position n; returns libwebp's "last
  // non-zero position + 1" (16 after a run of zeros to the end).
  int get_coeffs(BoolReader& br, int type, int ctx, const int* dq, int n, int16_t* out) {
    const uint8_t* p = proba_[type][kBands[n]][ctx];
    for (; n < 16; ++n) {
      if (!br.bit(p[0])) return n;
      while (!br.bit(p[1])) {
        if (++n == 16) return 16;
        p = proba_[type][kBands[n]][0];
      }
      int v;
      const int band = kBands[n + 1];
      if (!br.bit(p[2])) {
        v = 1;
        p = proba_[type][band][1];
      } else {
        if (!br.bit(p[3])) {
          v = !br.bit(p[4]) ? 2 : 3 + br.bit(p[5]);
        } else if (!br.bit(p[6])) {
          v = !br.bit(p[7]) ? 5 + br.bit(159) : 7 + 2 * br.bit(165) + br.bit(145);
        } else {
          const int bit1 = br.bit(p[8]);
          const int bit0 = br.bit(p[9 + bit1]);
          const int cat = 2 * bit1 + bit0;
          v = 0;
          for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br.bit(*tab);
          v += 3 + (8 << cat);
        }
        p = proba_[type][band][2];
      }
      const int sign = br.bit(0x80);
      out[kZigzag[n]] = static_cast<int16_t>((sign ? -v : v) * dq[n > 0]);
    }
    return 16;
  }

  static uint32_t nz_code(uint32_t nz_coeffs, int nz, bool dc_nz) {
    return (nz_coeffs << 2) | (nz > 3 ? 3 : nz > 1 ? 2 : dc_nz ? 1 : 0);
  }

  void decode_mb(MBData& mb, int mb_x, int mb_y, BoolReader& br) {
    bool skip = use_skip_proba_ ? mb.skip : false;
    uint8_t& tnz = top_nz_[mb_x];
    uint8_t& tnz_dc = top_nz_dc_[mb_x];
    if (!skip) {
      skip = parse_residuals(mb, br, tnz, tnz_dc);
    } else {
      tnz = left_nz_ = 0;
      if (!mb.is_i4x4) tnz_dc = left_nz_dc_ = 0;
      mb.non_zero_y = mb.non_zero_uv = 0;
    }
    if (filter_type_ > 0) {
      FInfo f = fstrengths_[mb.segment][mb.is_i4x4];
      f.inner = f.inner || !skip;
      finfo_[size_t(mb_y) * mb_w_ + mb_x] = f;
    }
  }

  bool parse_residuals(MBData& mb, BoolReader& br, uint8_t& top_nz, uint8_t& top_nz_dc) {
    int16_t* dst = mb.coeffs;
    memset(dst, 0, sizeof(mb.coeffs));
    const int seg = mb.segment;
    int first, ac_type;
    if (!mb.is_i4x4) {
      int16_t dc[16] = {0};
      const int ctx = top_nz_dc + left_nz_dc_;
      const int nz = get_coeffs(br, 1, ctx, y2_mat_[seg], 0, dc);
      top_nz_dc = left_nz_dc_ = nz > 0;
      if (nz > 1) {
        transform_wht(dc, dst);
      } else {
        const int dc0 = (dc[0] + 3) >> 3;
        for (int i = 0; i < 256; i += 16) dst[i] = static_cast<int16_t>(dc0);
      }
      first = 1;
      ac_type = 0;
    } else {
      first = 0;
      ac_type = 3;
    }
    uint32_t non_zero_y = 0, non_zero_uv = 0;
    uint8_t tnz = top_nz & 0x0f, lnz = left_nz_ & 0x0f;
    for (int y = 0; y < 4; ++y) {
      int l = lnz & 1;
      uint32_t nz_coeffs = 0;
      for (int x = 0; x < 4; ++x) {
        const int ctx = l + (tnz & 1);
        const int nz = get_coeffs(br, ac_type, ctx, y1_mat_[seg], first, dst);
        l = nz > first;
        tnz = static_cast<uint8_t>((tnz >> 1) | (l << 7));
        nz_coeffs = nz_code(nz_coeffs, nz, dst[0] != 0);
        dst += 16;
      }
      tnz >>= 4;
      lnz = static_cast<uint8_t>((lnz >> 1) | (l << 7));
      non_zero_y = (non_zero_y << 8) | nz_coeffs;
    }
    uint32_t out_t_nz = tnz, out_l_nz = lnz >> 4;
    for (int ch = 0; ch < 4; ch += 2) {
      uint32_t nz_coeffs = 0;
      tnz = static_cast<uint8_t>(top_nz >> (4 + ch));
      lnz = static_cast<uint8_t>(left_nz_ >> (4 + ch));
      for (int y = 0; y < 2; ++y) {
        int l = lnz & 1;
        for (int x = 0; x < 2; ++x) {
          const int ctx = l + (tnz & 1);
          const int nz = get_coeffs(br, 2, ctx, uv_mat_[seg], 0, dst);
          l = nz > 0;
          tnz = static_cast<uint8_t>((tnz >> 1) | (l << 3));
          nz_coeffs = nz_code(nz_coeffs, nz, dst[0] != 0);
          dst += 16;
        }
        tnz >>= 2;
        lnz = static_cast<uint8_t>((lnz >> 1) | (l << 5));
      }
      non_zero_uv |= nz_coeffs << (4 * ch);
      out_t_nz |= uint32_t(tnz << 4) << ch;
      out_l_nz |= uint32_t(lnz & 0xf0) << ch;
    }
    top_nz = static_cast<uint8_t>(out_t_nz);
    left_nz_ = static_cast<uint8_t>(out_l_nz);
    mb.non_zero_y = non_zero_y;
    mb.non_zero_uv = non_zero_uv;
    return !(non_zero_y | non_zero_uv);
  }

  static int check_mode(int mb_x, int mb_y, int mode) {
    if (mode == B_DC_PRED) {
      if (mb_x == 0) return mb_y == 0 ? B_DC_PRED_NOTOPLEFT : B_DC_PRED_NOLEFT;
      return mb_y == 0 ? B_DC_PRED_NOTOP : B_DC_PRED;
    }
    return mode;
  }

  static void add_residual(uint32_t bits, const int16_t* coeffs, uint8_t* dst) {
    if (bits >> 30) transform_one(coeffs, dst, BPS);
  }

  void reconstruct_row(std::vector<MBData>& row, int mb_y) {
    uint8_t* y_dst = work_ + kYOff;
    uint8_t* u_dst = work_ + kUOff;
    uint8_t* v_dst = work_ + kVOff;
    for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = 129;
    for (int j = 0; j < 8; ++j) u_dst[j * BPS - 1] = v_dst[j * BPS - 1] = 129;
    if (mb_y > 0) {
      y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
    } else {
      memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
      memset(u_dst - BPS - 1, 127, 8 + 1);
      memset(v_dst - BPS - 1, 127, 8 + 1);
    }
    for (int mb_x = 0; mb_x < mb_w_; ++mb_x) {
      const MBData& mb = row[mb_x];
      if (mb_x > 0) {  // rotate in the left samples
        for (int j = -1; j < 16; ++j) memcpy(&y_dst[j * BPS - 4], &y_dst[j * BPS + 12], 4);
        for (int j = -1; j < 8; ++j) {
          memcpy(&u_dst[j * BPS - 4], &u_dst[j * BPS + 4], 4);
          memcpy(&v_dst[j * BPS - 4], &v_dst[j * BPS + 4], 4);
        }
      }
      if (mb_y > 0) {
        memcpy(y_dst - BPS, &top_y_[16 * mb_x], 16);
        memcpy(u_dst - BPS, &top_u_[8 * mb_x], 8);
        memcpy(v_dst - BPS, &top_v_[8 * mb_x], 8);
      }
      uint32_t bits = mb.non_zero_y;
      if (mb.is_i4x4) {
        uint8_t* top_right = y_dst - BPS + 16;
        if (mb_y > 0) {
          if (mb_x >= mb_w_ - 1) {
            memset(top_right, top_y_[16 * mb_x + 15], 4);
          } else {
            memcpy(top_right, &top_y_[16 * (mb_x + 1)], 4);
          }
        }
        for (int r = 1; r <= 3; ++r) memcpy(top_right + 4 * r * BPS, top_right, 4);
        for (int n = 0; n < 16; ++n, bits <<= 2) {
          uint8_t* dst = y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS;
          predict4(dst, mb.imodes[n]);
          add_residual(bits, mb.coeffs + n * 16, dst);
        }
      } else {
        predict_block(y_dst, check_mode(mb_x, mb_y, mb.imodes[0]), 16);
        for (int n = 0; bits != 0 && n < 16; ++n, bits <<= 2) {
          add_residual(bits, mb.coeffs + n * 16, y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS);
        }
      }
      const int uv_mode = check_mode(mb_x, mb_y, mb.uvmode);
      predict_block(u_dst, uv_mode, 8);
      predict_block(v_dst, uv_mode, 8);
      for (int n = 0; n < 4; ++n) {  // a block with no coefficient adds nothing
        const int off = (n & 1) * 4 + (n >> 1) * 4 * BPS;
        if (mb.non_zero_uv & 0xff) transform_one(mb.coeffs + 256 + 16 * n, u_dst + off, BPS);
        if (mb.non_zero_uv & 0xff00) transform_one(mb.coeffs + 320 + 16 * n, v_dst + off, BPS);
      }
      if (mb_y < mb_h_ - 1) {
        memcpy(&top_y_[16 * mb_x], y_dst + 15 * BPS, 16);
        memcpy(&top_u_[8 * mb_x], u_dst + 7 * BPS, 8);
        memcpy(&top_v_[8 * mb_x], v_dst + 7 * BPS, 8);
      }
      for (int j = 0; j < 16; ++j) {
        memcpy(&y_[size_t(16 * mb_y + j) * y_stride_ + 16 * mb_x], y_dst + j * BPS, 16);
      }
      for (int j = 0; j < 8; ++j) {
        memcpy(&u_[size_t(8 * mb_y + j) * uv_stride_ + 8 * mb_x], u_dst + j * BPS, 8);
        memcpy(&v_[size_t(8 * mb_y + j) * uv_stride_ + 8 * mb_x], v_dst + j * BPS, 8);
      }
    }
  }

  void filter_mb(int mb_x, int mb_y) {
    const FInfo& f = finfo_[size_t(mb_y) * mb_w_ + mb_x];
    const int limit = f.limit;
    if (limit == 0) return;
    const int ys = y_stride_, uvs = uv_stride_;
    uint8_t* y = &y_[size_t(16 * mb_y) * ys + 16 * mb_x];
    if (filter_type_ == 1) {
      if (mb_x > 0) simple_filter(y, 1, ys, 16, limit + 4);
      if (f.inner) {
        for (int k = 1; k <= 3; ++k) simple_filter(y + 4 * k, 1, ys, 16, limit);
      }
      if (mb_y > 0) simple_filter(y, ys, 1, 16, limit + 4);
      if (f.inner) {
        for (int k = 1; k <= 3; ++k) simple_filter(y + 4 * k * ys, ys, 1, 16, limit);
      }
      return;
    }
    uint8_t* u = &u_[size_t(8 * mb_y) * uvs + 8 * mb_x];
    uint8_t* v = &v_[size_t(8 * mb_y) * uvs + 8 * mb_x];
    const int il = f.ilevel, hev_t = f.hev_thresh;
    if (mb_x > 0) {
      filter_loop(y, 1, ys, 16, limit + 4, il, hev_t, true);
      filter_loop(u, 1, uvs, 8, limit + 4, il, hev_t, true);
      filter_loop(v, 1, uvs, 8, limit + 4, il, hev_t, true);
    }
    if (f.inner) {
      for (int k = 1; k <= 3; ++k) filter_loop(y + 4 * k, 1, ys, 16, limit, il, hev_t, false);
      filter_loop(u + 4, 1, uvs, 8, limit, il, hev_t, false);
      filter_loop(v + 4, 1, uvs, 8, limit, il, hev_t, false);
    }
    if (mb_y > 0) {
      filter_loop(y, ys, 1, 16, limit + 4, il, hev_t, true);
      filter_loop(u, uvs, 1, 8, limit + 4, il, hev_t, true);
      filter_loop(v, uvs, 1, 8, limit + 4, il, hev_t, true);
    }
    if (f.inner) {
      for (int k = 1; k <= 3; ++k) filter_loop(y + 4 * k * ys, ys, 1, 16, limit, il, hev_t, false);
      filter_loop(u + 4 * uvs, uvs, 1, 8, limit, il, hev_t, false);
      filter_loop(v + 4 * uvs, uvs, 1, 8, limit, il, hev_t, false);
    }
  }
};

// ---- YUV -> RGB (src/dsp/yuv.h) with fancy upsampling (src/dsp/upsampling.c) ----

inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline uint8_t yuv_clip8(int v) { return static_cast<uint8_t>((v & ~16383) == 0 ? v >> 6 : v < 0 ? 0 : 255); }

inline void yuv_to_rgb(int y, int u, int v, uint8_t* rgb) {
  const int yy = mult_hi(y, 19077);
  rgb[0] = yuv_clip8(yy + mult_hi(v, 26149) - 14234);
  rgb[1] = yuv_clip8(yy - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
  rgb[2] = yuv_clip8(yy + mult_hi(u, 33050) - 17685);
}

// One output row from its luma row and the nearest (near) and next-nearest
// (far) chroma rows, as UPSAMPLE_FUNC computes its top or bottom row.
void upsample_row(const uint8_t* y, const uint8_t* near_u, const uint8_t* near_v,
                  const uint8_t* far_u, const uint8_t* far_v, int len, uint8_t* out) {
  auto edge = [](int a, int c) { return (3 * a + c + 2) >> 2; };
  auto mid = [](int a, int b, int c, int d) {  // a: nearest; b, c: the diagonal pair; d: far
    const int diag = (a + b + c + d + 8 + 2 * (b + c)) >> 3;
    return (diag + a) >> 1;
  };
  yuv_to_rgb(y[0], edge(near_u[0], far_u[0]), edge(near_v[0], far_v[0]), out);
  const int last_pair = (len - 1) >> 1;
  for (int x = 1; x <= last_pair; ++x) {
    yuv_to_rgb(y[2 * x - 1], mid(near_u[x - 1], near_u[x], far_u[x - 1], far_u[x]),
               mid(near_v[x - 1], near_v[x], far_v[x - 1], far_v[x]), out + 4 * (2 * x - 1));
    yuv_to_rgb(y[2 * x], mid(near_u[x], near_u[x - 1], far_u[x], far_u[x - 1]),
               mid(near_v[x], near_v[x - 1], far_v[x], far_v[x - 1]), out + 4 * (2 * x));
  }
  if (!(len & 1)) {
    yuv_to_rgb(y[len - 1], edge(near_u[last_pair], far_u[last_pair]),
               edge(near_v[last_pair], far_v[last_pair]), out + 4 * (len - 1));
  }
}

// Planes -> RGBA (alpha 255), width x height; U and V are ((w + 1) / 2) x
// ((h + 1) / 2) at least.
void yuv_to_rgba(const uint8_t* y, int64_t y_stride, const uint8_t* u, const uint8_t* v,
                 int64_t uv_stride, int w, int h, uint8_t* out) {
  const int uv_h = (h + 1) / 2;
  for (int row = 0; row < h; ++row) {
    const int near = row >> 1;
    const int far = (row & 1) ? std::min(near + 1, uv_h - 1) : std::max(near - 1, 0);
    uint8_t* o = out + size_t(row) * w * 4;
    upsample_row(y + row * y_stride, u + near * uv_stride, v + near * uv_stride,
                 u + far * uv_stride, v + far * uv_stride, w, o);
    for (int x = 0; x < w; ++x) o[4 * x + 3] = 255;
  }
}

void vp8_decode(const uint8_t* data, size_t size, int width, int height, uint8_t* out) {
  if (int64_t(width) * height > kMaxPixels) fail("lossy image too large");
  VP8Decoder dec(data, size);
  dec.decode(width, height);
  yuv_to_rgba(dec.y_.data(), dec.y_stride_, dec.u_.data(), dec.v_.data(), dec.uv_stride_, width,
              height, out);
}

// ---- ALPH ----

void alpha_decode(const uint8_t* data, size_t size, int w, int h, uint8_t* out) {
  if (size < 1) fail("empty alpha chunk");
  const int method = data[0] & 3, filter = (data[0] >> 2) & 3, pre = (data[0] >> 4) & 3;
  if (method > 1 || pre > 1 || (data[0] >> 6) != 0) fail("bad alpha chunk header");
  const size_t n = size_t(w) * h;
  if (method == 0) {
    if (size - 1 < n) fail("truncated alpha chunk");
    memcpy(out, data + 1, n);
  } else {
    vp8l_decode(data + 1, size - 1, w, h, true, out, 1);
  }
  if (filter == 0) return;
  for (int y = 0; y < h; ++y) {
    uint8_t* row = out + size_t(y) * w;
    const uint8_t* prev = y > 0 ? row - w : nullptr;
    if (filter == 1 || prev == nullptr) {  // horizontal (and every first row)
      uint8_t pred = prev ? prev[0] : 0;
      for (int x = 0; x < w; ++x) pred = row[x] = static_cast<uint8_t>(pred + row[x]);
    } else if (filter == 2) {  // vertical
      for (int x = 0; x < w; ++x) row[x] = static_cast<uint8_t>(prev[x] + row[x]);
    } else {  // gradient
      uint8_t top = prev[0], top_left = top, left = top;
      for (int x = 0; x < w; ++x) {
        top = prev[x];
        const int g = left + top - top_left;
        left = static_cast<uint8_t>(row[x] + ((g & ~0xff) == 0 ? g : g < 0 ? 0 : 255));
        top_left = top;
        row[x] = left;
      }
    }
  }
}

// ---- GIF LZW (Pillow's GifDecode.c) ----

int64_t gif_lzw(const uint8_t* in, size_t size, int bits, uint8_t* out, int64_t out_size) {
  if (bits < 0 || bits > 12) fail("bad LZW minimum code size (" + std::to_string(bits) + ")");
  constexpr int kTable = 4096;
  std::vector<uint8_t> suffix(kTable), stack(kTable + 1);
  std::vector<int> link(kTable);
  const int clear = 1 << bits, end = clear + 1;
  int next = clear + 2, codesize = bits + 1;
  int lastcode = 0;
  uint8_t lastdata = 0;
  bool fresh = true;  // the next code is the first after a clear
  uint32_t buf = 0;
  int have = 0;
  size_t pos = 0;
  int64_t n = 0;
  while (n < out_size) {
    while (have < codesize && pos < size) {
      buf |= uint32_t(in[pos++]) << have;
      have += 8;
    }
    if (have < codesize) break;  // the data ends before the image
    const int c = static_cast<int>(buf & ((1u << codesize) - 1));
    buf >>= codesize;
    have -= codesize;
    if (c == clear) {
      next = clear + 2;
      codesize = bits + 1;
      fresh = true;
      continue;
    }
    if (c == end) break;
    if (fresh) {
      if (c > clear) fail("corrupt LZW data (first code " + std::to_string(c) + ")");
      lastdata = static_cast<uint8_t>(c);
      lastcode = c;
      fresh = false;
      out[n++] = lastdata;
      continue;
    }
    if (c > next) fail("corrupt LZW data (code " + std::to_string(c) + " past the table)");
    int k = kTable + 1, code = c;
    if (c == next) {
      stack[--k] = lastdata;
      code = lastcode;
    }
    while (code >= clear) {
      if (k <= 0 || code >= kTable) fail("corrupt LZW data (string too long)");
      stack[--k] = suffix[code];
      code = link[code];
    }
    lastdata = static_cast<uint8_t>(code);
    if (k <= 0) fail("corrupt LZW data (string too long)");
    stack[--k] = lastdata;
    if (next < kTable) {
      suffix[next] = lastdata;
      link[next] = lastcode;
      if (next == (1 << codesize) - 1 && codesize < 12) ++codesize;
      ++next;
    }
    lastcode = c;
    for (; k <= kTable && n < out_size; ++k) out[n++] = stack[k];
  }
  return n;
}

template <typename F>
int guarded(char* msg, int32_t msg_len, F fn) {
  try {
    fn();
    return 0;
  } catch (const WebpError& e) {
    set_message(msg, msg_len, e.msg);
  } catch (const std::bad_alloc&) {
    set_message(msg, msg_len, "out of memory");
  }
  return -1;
}

}  // namespace

extern "C" {

int w3d_vp8l_decode(const uint8_t* data, int64_t size, int32_t width, int32_t height,
                    uint8_t* out, char* msg, int32_t msg_len) {
  return guarded(msg, msg_len, [&] {
    if (width < 1 || height < 1) fail("bad lossless image size");
    vp8l_decode(data, size_t(size), width, height, false, out, 4);
  });
}

int w3d_vp8_decode(const uint8_t* data, int64_t size, int32_t width, int32_t height, uint8_t* out,
                   char* msg, int32_t msg_len) {
  return guarded(msg, msg_len, [&] { vp8_decode(data, size_t(size), width, height, out); });
}

int w3d_yuv_to_rgba(const uint8_t* y, int64_t y_stride, const uint8_t* u, const uint8_t* v,
                    int64_t uv_stride, int32_t width, int32_t height, uint8_t* out, char* msg,
                    int32_t msg_len) {
  return guarded(msg, msg_len, [&] {
    if (width < 1 || height < 1) fail("bad plane size");
    yuv_to_rgba(y, y_stride, u, v, uv_stride, width, height, out);
  });
}

int w3d_vp8_idct(const int16_t* coeffs, int32_t wht, void* out, char* msg, int32_t msg_len) {
  return guarded(msg, msg_len, [&] {
    if (wht) {
      int16_t full[256] = {0};
      transform_wht(coeffs, full);
      for (int k = 0; k < 16; ++k) static_cast<int16_t*>(out)[k] = full[16 * k];
    } else {
      transform_one(coeffs, static_cast<uint8_t*>(out), 4);
    }
  });
}

int w3d_alpha_decode(const uint8_t* data, int64_t size, int32_t width, int32_t height,
                     uint8_t* out, char* msg, int32_t msg_len) {
  return guarded(msg, msg_len, [&] {
    if (width < 1 || height < 1 || int64_t(width) * height > kMaxPixels) fail("bad alpha size");
    alpha_decode(data, size_t(size), width, height, out);
  });
}

int64_t w3d_gif_lzw(const uint8_t* data, int64_t size, int32_t min_code_size, uint8_t* out,
                    int64_t out_size, char* msg, int32_t msg_len) {
  int64_t n = -1;
  if (guarded(msg, msg_len, [&] { n = gif_lzw(data, size_t(size), min_code_size, out, out_size); }) != 0) {
    return -1;
  }
  return n;
}

}  // extern "C"
