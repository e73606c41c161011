// wast3d_tpu_torch native JPEG decoder: every mode libjpeg-turbo 3.1.3
// decodes behind PIL, as it decodes it.
//
// COLMAP datasets ship JPEG images, and the card's machine has no PIL. This
// decodes what cameras, COLMAP's undistorter, jpegtran, archives and
// scientific capture write: Huffman-coded sequential (SOF0 / SOF1) and
// progressive (SOF2), arithmetic-coded sequential (SOF9) and progressive
// (SOF10), and lossless (SOF3, predictors 1-7, a point transform); 8-bit
// samples, 1, 3 or 4 components, sampling factors 1-4 in integral ratios
// (4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1, ...), any size, restart markers. Every
// other kind of file (arithmetic-coded lossless SOF11, hierarchical SOF5-7
// and SOF13-15, 12-bit, 2 components, fractional sampling ratios, more than
// 10 blocks in an MCU, a lossless file whose colour space would need a
// conversion) is refused with a message that names its marker, its factors
// or the rule.
//
// Arithmetic-coded scans are jdarith.c's: the QM decoder of T.81 Annex D
// with jaricom.c's Table D.2 (kAritab), DC statistics of 64 bins a table
// conditioned by DAC's L and U (defaults 0 and 1, reset at SOI), AC
// statistics of 256 bins with Kx (default 5), the fixed 0.5 bin for signs and
// refinement bits; a restart resets the statistics, the DC contexts and the
// coder; a magnitude or a run past the band sets the coder's error state and
// leaves the MCUs up to the next restart as they are; a marker in the data
// feeds zeros. Progressive scans fill the coefficient buffer the Huffman
// path fills, so block smoothing and the IDCT apply unchanged. PIL hands
// libjpeg a file 64 KiB at a time and the arithmetic decoder cannot suspend:
// a scan whose data runs past the blocks read when it starts is an error.
//
// Lossless scans are libjpeg-turbo 3's jdlhuff.c (SSSS 0-16, 16 meaning
// 32768 with no extra bits; no standard table stands in for a missing
// DHT), jddiffct.c (an iMCU row decoded, then undifferenced; a restart
// interval a whole number of MCU rows) and jdlossls.c (w3d_jpeg_undifference:
// the first row of a scan or restart interval from 2^(P - Pt - 1) and Ra,
// sums kept to 16 bits, the point transform undone into 8 bits). Data
// running into a marker leaves the later rows at the centre value. There is
// no IDCT; components are upsampled by replication (no context rows, so no
// fancy filter), and never colour-converted: jdcolor.c refuses, so a
// three-component file with a JFIF marker or an Adobe transform other than
// 0 (YCbCr) and a four-component YCCK file raise, and any other three
// components are RGB.
//
// Damaged files read as PIL reads them, which is libjpeg-turbo's way plus
// PIL's own handling of a source that runs dry:
// - the markers are read as jdmarker.c reads them (garbage before a marker
//   skipped, APPn / COM / DNL skipped by their length, DHT / DQT / DRI / SOF /
//   SOS / DAC checked as libjpeg checks them, an unknown marker refused);
// - the Huffman tables a scan uses are checked as jpeg_make_d_derived_tbl
//   checks them (a DC symbol over 15, a code past its length, the all-ones
//   code), and a table a sequential scan names but no DHT defined is Annex
//   K's standard table 0 or 1, as jdhuff.c substitutes it (jdphuff.c does
//   not);
// - the entropy decoder is jdhuff.c's and jdphuff.c's: its 64-bit bit
//   buffer, filled to 57 bits at a time; a marker in the data feeds zero bits
//   and, once an MCU has needed them, leaves the rest of the segment's MCUs
//   untouched (grey in a sequential file); a bad Huffman code is 17 bits of
//   symbol 0; a wrong or missing restart marker is resynced as
//   jpeg_resync_to_restart does; DC and coefficient sums wrap as JCOEF does;
// - the data running out where libjpeg would wait for more (no marker) is an
//   error before the last MCU row of a one-scan file (PIL: "image file is
//   truncated"), and before EOI in a file of several scans; after a one-scan
//   file's last MCU only a marker error counts, as in jpeg_finish_decompress.
//
// A progressive file's scans are decoded into a coefficient buffer per
// component (DC first and refine, interleaved or not; AC first with
// end-of-band runs; AC refine with its correction bits; a restart resets the
// run and the DC predictors; Huffman tables may change between scans). At
// EOI, when the scans leave any of a component's first ten zigzag
// coefficients unsent or unrefined, the blocks are smoothed as jdcoefct.c's
// decompress_smooth_data does (libjpeg-turbo 2.1 and later: a 5 x 5
// neighbourhood of DC values; DC itself interpolated while no AC coefficient
// has been sent), then every block goes through the IDCT, upsampling and
// colour code.
//
// The arithmetic is that of PIL's libjpeg-turbo on x86-64: the SIMD "islow"
// integer inverse DCT (jidctint-sse2 / -avx2: 16-bit dequantisation and
// sums, saturating packs between the passes and at the end, the DC-only
// shortcut when rows 1-7 of a block are zero), jdsample.c's upsampling
// (w3d_jpeg_upsample: "fancy" triangle filters for ratios h2v1, h2v2 and
// h1v2, edge rows and columns replicated, plain replication for h2 planes at
// most 2 samples wide; int_upsample's replication for every other integral
// ratio), and the fixed-point YCbCr -> RGB tables of jdcolor.c. A 4-component
// file is CMYK, or YCCK under an Adobe marker whose transform is not 0
// (jdcolor.c's ycck_cmyk_convert: YCC -> RGB, inverted, K kept); PIL reads
// either as "CMYK;I", so every sample comes out inverted. EXIF orientation
// is not applied. PIL's own walk over the markers before libjpeg runs
// (JpegImagePlugin's _open) is `utils/image_io._jpeg_walk`.
//
// C ABI (ctypes):
//   w3d_jpeg_info(data, size, &width, &height, &channels, msg, msg_len)
//   w3d_jpeg_decode(data, size, out, out_size, msg, msg_len)
//   w3d_jpeg_decode_as(data, size, colour, out, out_size, msg, msg_len): the
//     colour space given, as a TIFF gives it (0: the file's own markers, 1:
//     YCbCr -> RGB, 2: the components as coded, 3: each component's plane
//     in whole MCUs as the IDCT leaves it, for libtiff's old-style JPEG
//     codec); 1-3 read the data as libtiff's JPEG source does, a fake EOI
//     where it ends
//   w3d_jpeg_decode_raw(data, size, out, out_size, &failed_row, msg, msg_len):
//     colour 3 as libtiff's old-style JPEG codec runs libjpeg: where the data
//     runs out (libjpeg asks its source for more: "Premature end of JPEG
//     data") or a restart marker is not the one expected (its resync is an
//     error), decoding stops and failed_row is that iMCU row (else -1)
//   w3d_jpeg_frame(data, size, info, msg, msg_len): a TIFF's stream's
//     width, height, components, then 16 h + v of each component's sampling
//     factors
//   w3d_jpeg_upsample(plane, stride, width, height, rh, rv, out, out_width,
//                     out_height, msg, msg_len)
//   w3d_jpeg_idct(coef, qt, n, out): n blocks of 64 int16 coefficients
//     (natural order) dequantised with the 64 uint16 of qt -> n x 64 samples
//   w3d_jpeg_undifference(diff, rows, width, predictor, point_transform,
//                         initial, reset_every, out, msg, msg_len): rows x
//     width int32 differences of one lossless component -> uint8 samples,
//     row 0 and every reset_every-th row (0: none) a first row
// Each returns 0 on success and -1 on failure, with a NUL-terminated reason
// in msg. out receives height x width x channels bytes, row-major; the
// upsampler turns a width x height plane (row stride `stride`) into
// out_height x out_width samples, as jdsample.c does for a component
// sampled rh x rv times less than the image.

#include <algorithm>
#include <climits>
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

// The data ended where libjpeg's suspending source (PIL's) would wait for
// more bytes.
struct Suspend {};
// libtiff's old-style JPEG source (colour 3) fails where libjpeg would read
// past its data or resync a restart marker.
struct RawFailure {};

[[noreturn]] void fail(const std::string& msg) { throw DecodeError{msg}; }

// Annex K.3's tables, which libjpeg-turbo uses for tables 0 and 1 when a
// scan names a table no DHT defined (jstdhuff.c): code counts by length
// (index 1-16), then the symbols.
struct StdTable {
  uint8_t bits[17];
  uint8_t vals[162];
};
const StdTable kStdTables[4] = {  // DC 0, AC 0, DC 1, AC 1
    {{0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},
     {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11}},
    {{0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125},
     {1, 2, 3, 0, 4, 17, 5, 18, 33, 49, 65, 6, 19, 81, 97, 7, 34, 113, 20, 50, 129, 145, 161,
      8, 35, 66, 177, 193, 21, 82, 209, 240, 36, 51, 98, 114, 130, 9, 10, 22, 23, 24, 25, 26,
      37, 38, 39, 40, 41, 42, 52, 53, 54, 55, 56, 57, 58, 67, 68, 69, 70, 71, 72, 73, 74, 83,
      84, 85, 86, 87, 88, 89, 90, 99, 100, 101, 102, 103, 104, 105, 106, 115, 116, 117, 118,
      119, 120, 121, 122, 131, 132, 133, 134, 135, 136, 137, 138, 146, 147, 148, 149, 150,
      151, 152, 153, 154, 162, 163, 164, 165, 166, 167, 168, 169, 170, 178, 179, 180, 181,
      182, 183, 184, 185, 186, 194, 195, 196, 197, 198, 199, 200, 201, 202, 210, 211, 212,
      213, 214, 215, 216, 217, 218, 225, 226, 227, 228, 229, 230, 231, 232, 233, 234, 241,
      242, 243, 244, 245, 246, 247, 248, 249, 250}},
    {{0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0},
     {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11}},
    {{0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119},
     {0, 1, 2, 3, 17, 4, 5, 33, 49, 6, 18, 65, 81, 7, 97, 113, 19, 34, 50, 129, 8, 20, 66,
      145, 161, 177, 193, 9, 35, 51, 82, 240, 21, 98, 114, 209, 10, 22, 36, 52, 225, 37, 241,
      23, 24, 25, 26, 38, 39, 40, 41, 42, 53, 54, 55, 56, 57, 58, 67, 68, 69, 70, 71, 72, 73,
      74, 83, 84, 85, 86, 87, 88, 89, 90, 99, 100, 101, 102, 103, 104, 105, 106, 115, 116,
      117, 118, 119, 120, 121, 122, 130, 131, 132, 133, 134, 135, 136, 137, 138, 146, 147,
      148, 149, 150, 151, 152, 153, 154, 162, 163, 164, 165, 166, 167, 168, 169, 170, 178,
      179, 180, 181, 182, 183, 184, 185, 186, 194, 195, 196, 197, 198, 199, 200, 201, 202,
      210, 211, 212, 213, 214, 215, 216, 217, 218, 226, 227, 228, 229, 230, 231, 232, 233,
      234, 242, 243, 244, 245, 246, 247, 248, 249, 250}}};

// ---- upsampling: jdsample.c ---------------------------------------------------
// One output row of an h2 component from its downsampled row `in` (n
// samples): 2 n samples.
void h2v1_fancy(const uint8_t* in, int n, uint8_t* out) {
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

// h2v2: `in0` the nearer row (weight 3), `in1` the other (weight 1).
void h2v2_fancy(const uint8_t* in0, const uint8_t* in1, int n, uint8_t* out) {
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

// Row y, at full resolution, of a plane of w x h samples (row stride
// `stride`) sampled rh x rv times less than the image, into `row` (out_w
// samples; room for 2 w for an h2 plane). The rows above the first
// and below the last are the edge rows again (jdmainct.c's context rows).
// `fancy` false is libjpeg's choice for a lossless file (no context rows):
// every ratio replicates.
void upsample_row(const uint8_t* p, int64_t stride, int w, int h, int rh, int rv, int y,
                  int out_w, uint8_t* row, bool fancy = true) {
  const int iy = y / rv;
  const uint8_t* in0 = p + static_cast<int64_t>(iy) * stride;
  if (rh == 1 && rv == 1) {
    memcpy(row, in0, static_cast<size_t>(out_w));
    return;
  }
  if (!fancy) {
    for (int x = 0; x < out_w; ++x) row[x] = in0[x / rh];
    return;
  }
  const bool even = y % 2 == 0;
  const int ny = std::min(std::max(even ? iy - 1 : iy + 1, 0), h - 1);
  const uint8_t* in1 = p + static_cast<int64_t>(ny) * stride;
  if (rh == 1 && rv == 2) {  // h1v2_fancy_upsample: no narrow case
    const int bias = even ? 1 : 2;
    for (int x = 0; x < out_w; ++x) row[x] = static_cast<uint8_t>((in0[x] * 3 + in1[x] + bias) >> 2);
    return;
  }
  if (rh == 2 && (rv == 1 || rv == 2) && w > 2) {
    if (rv == 1) h2v1_fancy(in0, w, row);
    else h2v2_fancy(in0, in1, w, row);
    return;
  }
  // h2v1_upsample / h2v2_upsample / int_upsample: replication.
  for (int x = 0; x < out_w; ++x) row[x] = in0[x / rh];
}

// ---- arithmetic decoding: jaricom.c's Table D.2 ------------------------------
// Each state: Qe << 16 | next state after an MPS << 8 | MPS switch on an LPS
// << 7 | next state after an LPS. State 113 is the fixed estimate of 0.5
// (T.851) for signs and refinement bits.
#define V(qe, nlps, nmps, sw) ((int64_t(qe) << 16) | ((nmps) << 8) | ((sw) << 7) | (nlps))
const int64_t kAritab[114] = {
    V(0x5a1d, 1, 1, 1),     V(0x2586, 14, 2, 0),    V(0x1114, 16, 3, 0),    V(0x080b, 18, 4, 0),
    V(0x03d8, 20, 5, 0),    V(0x01da, 23, 6, 0),    V(0x00e5, 25, 7, 0),    V(0x006f, 28, 8, 0),
    V(0x0036, 30, 9, 0),    V(0x001a, 33, 10, 0),   V(0x000d, 35, 11, 0),   V(0x0006, 9, 12, 0),
    V(0x0003, 10, 13, 0),   V(0x0001, 12, 13, 0),   V(0x5a7f, 15, 15, 1),   V(0x3f25, 36, 16, 0),
    V(0x2cf2, 38, 17, 0),   V(0x207c, 39, 18, 0),   V(0x17b9, 40, 19, 0),   V(0x1182, 42, 20, 0),
    V(0x0cef, 43, 21, 0),   V(0x09a1, 45, 22, 0),   V(0x072f, 46, 23, 0),   V(0x055c, 48, 24, 0),
    V(0x0406, 49, 25, 0),   V(0x0303, 51, 26, 0),   V(0x0240, 52, 27, 0),   V(0x01b1, 54, 28, 0),
    V(0x0144, 56, 29, 0),   V(0x00f5, 57, 30, 0),   V(0x00b7, 59, 31, 0),   V(0x008a, 60, 32, 0),
    V(0x0068, 62, 33, 0),   V(0x004e, 63, 34, 0),   V(0x003b, 32, 35, 0),   V(0x002c, 33, 9, 0),
    V(0x5ae1, 37, 37, 1),   V(0x484c, 64, 38, 0),   V(0x3a0d, 65, 39, 0),   V(0x2ef1, 67, 40, 0),
    V(0x261f, 68, 41, 0),   V(0x1f33, 69, 42, 0),   V(0x19a8, 70, 43, 0),   V(0x1518, 72, 44, 0),
    V(0x1177, 73, 45, 0),   V(0x0e74, 74, 46, 0),   V(0x0bfb, 75, 47, 0),   V(0x09f8, 77, 48, 0),
    V(0x0861, 78, 49, 0),   V(0x0706, 79, 50, 0),   V(0x05cd, 48, 51, 0),   V(0x04de, 50, 52, 0),
    V(0x040f, 50, 53, 0),   V(0x0363, 51, 54, 0),   V(0x02d4, 52, 55, 0),   V(0x025c, 53, 56, 0),
    V(0x01f8, 54, 57, 0),   V(0x01a4, 55, 58, 0),   V(0x0160, 56, 59, 0),   V(0x0125, 57, 60, 0),
    V(0x00f6, 58, 61, 0),   V(0x00cb, 59, 62, 0),   V(0x00ab, 61, 63, 0),   V(0x008f, 61, 32, 0),
    V(0x5b12, 65, 65, 1),   V(0x4d04, 80, 66, 0),   V(0x412c, 81, 67, 0),   V(0x37d8, 82, 68, 0),
    V(0x2fe8, 83, 69, 0),   V(0x293c, 84, 70, 0),   V(0x2379, 86, 71, 0),   V(0x1edf, 87, 72, 0),
    V(0x1aa9, 87, 73, 0),   V(0x174e, 72, 74, 0),   V(0x1424, 72, 75, 0),   V(0x119c, 74, 76, 0),
    V(0x0f6b, 74, 77, 0),   V(0x0d51, 75, 78, 0),   V(0x0bb6, 77, 79, 0),   V(0x0a40, 77, 48, 0),
    V(0x5832, 80, 81, 1),   V(0x4d1c, 88, 82, 0),   V(0x438e, 89, 83, 0),   V(0x3bdd, 90, 84, 0),
    V(0x34ee, 91, 85, 0),   V(0x2eae, 92, 86, 0),   V(0x299a, 93, 87, 0),   V(0x2516, 86, 71, 0),
    V(0x5570, 88, 89, 1),   V(0x4ca9, 95, 90, 0),   V(0x44d9, 96, 91, 0),   V(0x3e22, 97, 92, 0),
    V(0x3824, 99, 93, 0),   V(0x32b4, 99, 94, 0),   V(0x2e17, 93, 86, 0),   V(0x56a8, 95, 96, 1),
    V(0x4f46, 101, 97, 0),  V(0x47e5, 102, 98, 0),  V(0x41cf, 103, 99, 0),  V(0x3c3d, 104, 100, 0),
    V(0x375e, 99, 93, 0),   V(0x5231, 105, 102, 0), V(0x4c0f, 106, 103, 0), V(0x4639, 107, 104, 0),
    V(0x415e, 103, 99, 0),  V(0x5627, 105, 106, 1), V(0x50e7, 108, 107, 0), V(0x4b85, 109, 103, 0),
    V(0x5597, 110, 109, 0), V(0x504f, 111, 107, 0), V(0x5a10, 110, 111, 1), V(0x5522, 112, 109, 0),
    V(0x59eb, 112, 111, 1), V(0x5a1d, 113, 113, 0)};
#undef V

// ---- lossless undifferencing: jdlossls.c -------------------------------------
// One row of a component: out[x] = (diff[x] + prediction) & 0xFFFF. Predictor
// 0 is the first row of a scan or of a restart interval (`initial` =
// 2^(P - Pt - 1) for its first sample, Ra after); 1-7 are H.1.2.1's, the row's
// first sample predicted by Rb (the sample above).
void undifference_row(const int32_t* diff, const int32_t* prev, int32_t* out, int width,
                      int predictor, int initial) {
  if (predictor == 0) {
    int ra = (diff[0] + initial) & 0xFFFF;
    out[0] = ra;
    for (int x = 1; x < width; ++x) out[x] = ra = (diff[x] + ra) & 0xFFFF;
    return;
  }
  int rb = prev[0], ra = (diff[0] + rb) & 0xFFFF, rc;
  out[0] = ra;
  for (int x = 1; x < width; ++x) {
    rc = rb;
    rb = prev[x];
    int p;
    switch (predictor) {
      case 1: p = ra; break;
      case 2: p = rb; break;
      case 3: p = rc; break;
      case 4: p = ra + rb - rc; break;
      case 5: p = ra + ((rb - rc) >> 1); break;
      case 6: p = rb + ((ra - rc) >> 1); break;
      default: p = (ra + rb) >> 1; break;
    }
    out[x] = ra = (diff[x] + p) & 0xFFFF;
  }
}

// The point transform undone: an 8-bit sample keeps the low bits of v << Pt.
void scale_row(const int32_t* in, uint8_t* out, int width, int pt) {
  for (int x = 0; x < width; ++x) out[x] = static_cast<uint8_t>(in[x] << pt);
}

std::string marker_name(int m) {
  char buf[32];
  if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {
    snprintf(buf, sizeof buf, "SOF%d (0xFF%02X)", m - 0xC0, m);
  } else {
    snprintf(buf, sizeof buf, "marker 0xFF%02X", m);
  }
  return buf;
}

// ---- inverse DCT: libjpeg-turbo's SIMD jsimd_idct_islow (SSE2 / AVX2) --------
// The C jidctint.c in 16-bit lanes: coefficient x quantiser and the sums
// in0 +- in4, in7 + in3, in5 + in1 wrap at 16 bits; products and the other
// sums are exact in 32 bits; each pass's results saturate to 16 bits
// (packssdw) and the outputs to [-128, 127] before the +128 (packsswb).
inline int32_t wrap16(int32_t x) { return static_cast<int16_t>(static_cast<uint16_t>(x)); }
inline int32_t sat16(int64_t x) { return static_cast<int32_t>(std::min<int64_t>(32767, std::max<int64_t>(-32768, x))); }

// One 1-D pass over in[0], in[s], ..., in[7 s] -> out[0..7], before descaling.
inline void idct_pass(const int32_t* in, int s, int64_t* out) {
  const int64_t z2 = in[2 * s], z3 = in[6 * s];
  const int64_t tmp3 = z2 * 10703 + z3 * 4433;  // F(0.541 + 0.765), F(0.541)
  const int64_t tmp2 = z2 * 4433 - z3 * 10704;  // F(0.541), F(0.541 - 1.848)
  const int64_t tmp0 = static_cast<int64_t>(wrap16(in[0] + in[4 * s])) * 8192;
  const int64_t tmp1 = static_cast<int64_t>(wrap16(in[0] - in[4 * s])) * 8192;
  const int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3, t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
  const int64_t i7 = in[7 * s], i5 = in[5 * s], i3 = in[3 * s], i1 = in[s];
  const int64_t z3o = wrap16(static_cast<int32_t>(i7 + i3)), z4o = wrap16(static_cast<int32_t>(i5 + i1));
  const int64_t z3p = z3o * -6436 + z4o * 9633;  // F(1.176 - 1.962), F(1.176)
  const int64_t z4p = z3o * 9633 + z4o * 6437;   // F(1.176), F(1.176 - 0.390)
  const int64_t o0 = i7 * -4927 + i1 * -7373 + z3p;   // F(0.299 - 0.900), -F(0.900)
  const int64_t o3 = i7 * -7373 + i1 * 4926 + z4p;    // -F(0.900), F(1.501 - 0.900)
  const int64_t o1 = i5 * -4176 + i3 * -20995 + z4p;  // F(2.053 - 2.563), -F(2.563)
  const int64_t o2 = i5 * -20995 + i3 * 4177 + z3p;   // -F(2.563), F(3.073 - 2.563)
  out[0] = t10 + o3;
  out[7] = t10 - o3;
  out[1] = t11 + o2;
  out[6] = t11 - o2;
  out[2] = t12 + o1;
  out[5] = t12 - o1;
  out[3] = t13 + o0;
  out[4] = t13 - o0;
}

void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out, int64_t stride) {
  int32_t ws[64];
  bool ac = false;  // any coefficient in rows 1-7
  for (int i = 8; i < 64 && !ac; ++i) ac = coef[i] != 0;
  if (!ac) {  // pmullw, psllw PASS1_BITS: 16 bits throughout
    for (int c = 0; c < 8; ++c) {
      const int32_t dc = wrap16(wrap16(coef[c] * q[c]) * 4);
      for (int r = 0; r < 8; ++r) ws[8 * r + c] = dc;
    }
  } else {
    int32_t in[64];
    for (int i = 0; i < 64; ++i) in[i] = wrap16(coef[i] * q[i]);
    for (int c = 0; c < 8; ++c) {  // pass 1: columns
      int64_t o[8];
      idct_pass(in + c, 8, o);
      for (int r = 0; r < 8; ++r) ws[8 * r + c] = sat16((o[r] + 1024) >> 11);
    }
  }
  for (int r = 0; r < 8; ++r) {  // pass 2: rows
    int64_t o[8];
    idct_pass(ws + 8 * r, 1, o);
    uint8_t* row = out + r * stride;
    for (int c = 0; c < 8; ++c) {
      const int32_t v = sat16((o[c] + (1 << 17)) >> 18);
      row[c] = static_cast<uint8_t>(std::min(127, std::max(-128, v)) + 128);
    }
  }
}

// ---- Huffman tables: jdmarker.c's get_dht, jdhuff.c's derived tables --------
struct HuffSpec {  // a table as a DHT defines it
  bool defined = false;
  uint8_t bits[17] = {0};
  uint8_t vals[256] = {0};
};

struct Huffman {  // jpeg_make_d_derived_tbl
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  uint8_t look_nb[256];  // HUFF_LOOKAHEAD = 8 bits: code length, 9 if longer
  uint8_t look_sym[256];
};

void derive(const HuffSpec& spec, bool dc, Huffman& t, int dc_max = 15) {
  uint8_t size[257];
  int32_t code_of[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l) {
    const int n = spec.bits[l];
    if (p + n > 256) fail("bad Huffman table (more than 256 codes)");
    for (int i = 0; i < n; ++i) size[p++] = static_cast<uint8_t>(l);
  }
  size[p] = 0;
  const int count = p;
  int32_t code = 0;
  int si = size[0];
  p = 0;
  while (size[p]) {
    while (size[p] == si) {
      code_of[p++] = code;
      ++code;
    }
    if (code >= (int32_t(1) << si)) fail("bad Huffman table (code lengths overflow)");
    code <<= 1;
    ++si;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (spec.bits[l]) {
      t.valoffset[l] = p - code_of[p];
      p += spec.bits[l];
      t.maxcode[l] = code_of[p - 1];
    } else {
      t.maxcode[l] = -1;
    }
  }
  t.valoffset[17] = 0;
  t.maxcode[17] = 0xFFFFF;  // ends the slow decode at 17 bits
  std::copy(spec.vals, spec.vals + 256, t.vals);
  std::fill(t.look_nb, t.look_nb + 256, static_cast<uint8_t>(9));
  p = 0;
  for (int l = 1; l <= 8; ++l) {
    for (int i = 0; i < spec.bits[l]; ++i, ++p) {
      const int lo = code_of[p] << (8 - l);
      for (int j = 0; j < (1 << (8 - l)); ++j) {
        t.look_nb[lo + j] = static_cast<uint8_t>(l);
        t.look_sym[lo + j] = spec.vals[p];
      }
    }
  }
  if (dc) {
    for (int i = 0; i < count; ++i) {
      if (spec.vals[i] > dc_max) {
        fail("bad Huffman table (a DC symbol over " + std::to_string(dc_max) + ")");
      }
    }
  }
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0, td = 0, ta = 0;
  int width = 0, height = 0;  // downsampled size
  int wb = 0, hb = 0;         // blocks across and down that hold samples
  int bw = 0, bh = 0;         // blocks across and down in whole MCUs
  int stride = 0;
  std::vector<uint8_t> plane;  // bh * 8 rows of stride samples
  std::vector<int16_t> coef;   // bw * bh blocks of 64, natural order
  // Progressive files: the last Al each zigzag coefficient was coded with
  // (-1: never), and the same before the component's latest scan.
  int coef_bits[64];
  int prev_bits[64];
  uint16_t qt[64];  // latched at the component's first scan; zeros if never
  bool latched = false;
  // Lossless files: one iMCU row of differences (v rows of bw), its v rows
  // undifferenced (the last the next row's Rb), and the row's predictor
  // (0: the scan's or a restart interval's first row).
  std::vector<int32_t> diff, undiff;
  int predictor = 0;
};

class Decoder {
 public:
  Decoder(const uint8_t* data, size_t size)
      : data_(data), size_(size), limit_(std::min(size, kBlock)) {}

  // jpeg_read_header: the markers up to the first SOS.
  void header() {
    try {
      for (;;) {
        const int r = read_markers();
        if (r == kReachedSos) break;
        // EOI before any scan: PIL asks for the header again, and libjpeg
        // then wants SOI at once (tables are kept).
        saw_soi_ = saw_sof_ = false;
      }
    } catch (const Suspend&) {
      fail("truncated JPEG (the data ends in its header)");
    }
    initial_setup();
  }

  void decode(uint8_t* out) {
    try {
      start_scan();
      if (!multiple_) {
        scanning_ = true;
        try {
          scan();
        } catch (const RawFailure&) {
          failed_row_ = current_row_;
        }
        scanning_ = false;
        // jpeg_finish_decompress: markers up to EOI; running out is fine.
        // (libtiff's old-style JPEG codec, colour 3, never calls it.)
        if (colour_ != 3) try {
          for (;;) {
            const int r = read_markers();
            if (r == kReachedEoi) break;
            fail("a second scan in a one-scan JPEG (libjpeg: EOI expected)");
          }
        } catch (const Suspend&) {
        }
      } else {
        for (;;) {
          scan();
          if (read_markers() == kReachedEoi) break;
          start_scan();
        }
      }
    } catch (const Suspend&) {
      fail(multiple_ ? "truncated JPEG (no EOI after its scans)" : "truncated JPEG (image data ends early)");
    }
    planes();
    output(out);
  }

  // A TIFF's strip or tile (colour 1 or 2): libtiff's JPEG source feeds a
  // fake EOI where the data ends, where PIL's would wait for more.
  void set_colour(int colour) {
    colour_ = colour;
    fake_eoi_ = colour != 0;
    limit_ = fake_eoi_ ? size_ : std::min(size_, kBlock);
  }
  int sampling(int c) const { return comp_[c].h * 16 + comp_[c].v; }
  int width() const { return width_; }
  int height() const { return height_; }
  int channels() const { return ncomp_; }
  // Colour 3: the iMCU row in which libtiff's source failed, or -1.
  int failed_row() const { return failed_row_; }
  // Colour 3 (raw data): each component's whole plane as the IDCT left it (whole
  // MCUs, no upsampling, no colour), one after the other: what libjpeg's
  // raw_data_out hands libtiff's old-style JPEG codec.
  int64_t raw_size() const {
    if (lossless_) fail("raw data out of a lossless JPEG (libjpeg refuses it)");
    int64_t n = 0;
    for (int c = 0; c < ncomp_; ++c) n += static_cast<int64_t>(comp_[c].stride) * comp_[c].bh * 8;
    return n;
  }

 private:
  static constexpr int kReachedSos = 1, kReachedEoi = 2;
  static constexpr size_t kBlock = 65536;

  // ---- markers: jdmarker.c ----------------------------------------------
  // PIL hands libjpeg the file 64 KiB at a time (ImageFile.load's
  // decodermaxblock), one block more each time libjpeg suspends. An
  // arithmetic-coded scan cannot suspend (jdarith.c's get_byte): its data
  // must lie in the blocks already read when the scan starts.
  int byte() {
    while (pos_ >= limit_ && limit_ < size_) {
      if (no_suspend_) {
        fail("arithmetic-coded data runs past the " + std::to_string(limit_ / 1024) +
             " KiB PIL has read (it reads 64 KiB at a time, and libjpeg's arithmetic decoder "
             "cannot wait for more)");
      }
      limit_ = std::min(size_, limit_ + kBlock);
    }
    if (pos_ < size_) return data_[pos_++];
    if (!fake_eoi_) throw Suspend{};
    if (colour_ == 3 && scanning_) throw RawFailure{};  // "Premature end of JPEG data"
    return (fake_++ & 1) ? 0xD9 : 0xFF;  // libtiff's source: FF D9 for ever
  }

  int u16() {
    int hi = byte();
    return (hi << 8) | byte();
  }

  void next_marker() {  // garbage and FF/00 pairs skipped, fill bytes too
    int c;
    for (;;) {
      c = byte();
      while (c != 0xFF) c = byte();
      do {
        c = byte();
      } while (c == 0xFF);
      if (c != 0) break;
    }
    unread_marker_ = c;
  }

  int read_markers() {
    for (;;) {
      if (unread_marker_ == 0) {
        if (!saw_soi_) {
          const int c = byte(), c2 = byte();
          if (c != 0xFF || c2 != 0xD8) fail("not a JPEG file (no SOI)");
          unread_marker_ = 0xD8;
        } else {
          next_marker();
        }
      }
      const int m = unread_marker_;
      if (m == 0xD8) {
        if (saw_soi_) fail("a second SOI");
        restart_interval_ = 0;
        for (int i = 0; i < 16; ++i) {  // the conditioning DAC may change
          arith_dc_l_[i] = 0;
          arith_dc_u_[i] = 1;
          arith_ac_k_[i] = 5;
        }
        saw_jfif_ = saw_adobe_ = false;
        adobe_transform_ = 0;
        saw_soi_ = true;
      } else if (m == 0xC0 || m == 0xC1 || m == 0xC2 || m == 0xC3 || m == 0xC9 || m == 0xCA) {
        frame(m);
      } else if ((m >= 0xC3 && m <= 0xCF && m != 0xC4 && m != 0xCC)) {
        unsupported_frame(m);
      } else if (m == 0xDA) {
        sos();
        unread_marker_ = 0;
        return kReachedSos;
      } else if (m == 0xD9) {
        unread_marker_ = 0;
        return kReachedEoi;
      } else if (m == 0xCC) {
        dac();
      } else if (m == 0xC4) {
        dht();
      } else if (m == 0xDB) {
        dqt();
      } else if (m == 0xDD) {
        if (u16() != 4) fail("bad DRI segment length");
        restart_interval_ = u16();
      } else if (m == 0xE0 || m == 0xEE) {
        interesting_app(m);
      } else if ((m >= 0xE1 && m <= 0xEF) || m == 0xFE || m == 0xDC) {
        skip_variable();
      } else if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) {
        // RSTn and TEM carry no segment
      } else {
        fail("unknown JPEG " + marker_name(m));
      }
      unread_marker_ = 0;
    }
  }

  void skip_variable() {
    const long length = u16() - 2;
    if (length > 0) skip(static_cast<size_t>(length));
  }

  void skip(size_t n) {  // PIL's skip_input_data: past the end it waits
    if (n > size_ - pos_ && !fake_eoi_) throw Suspend{};
    pos_ += std::min(n, size_ - pos_);
  }

  void interesting_app(int m) {  // get_interesting_appn: JFIF and Adobe
    long length = u16() - 2;
    uint8_t b[14];
    const int n = length >= 14 ? 14 : length > 0 ? static_cast<int>(length) : 0;
    for (int i = 0; i < n; ++i) b[i] = static_cast<uint8_t>(byte());
    length -= n;
    if (m == 0xE0 && n >= 14 && memcmp(b, "JFIF\0", 5) == 0) saw_jfif_ = true;
    if (m == 0xEE && n >= 12 && memcmp(b, "Adobe", 5) == 0) {
      saw_adobe_ = true;
      adobe_transform_ = b[11];
    }
    if (length > 0) skip(static_cast<size_t>(length));
  }

  void unsupported_frame(int m) {  // jdmarker.c: JERR_SOF_UNSUPPORTED
    const char* what = "unsupported";
    if (m == 0xCB) what = "arithmetic-coded lossless";
    else if (m >= 0xC5 && m <= 0xC7) what = "hierarchical (differential)";
    else if (m >= 0xCD) what = "arithmetic-coded hierarchical";
    fail(std::string(what) + " JPEG (" + marker_name(m) + ") is not supported; libjpeg-turbo "
         "decodes SOF0-SOF3, SOF9 and SOF10");
  }

  void dac() {  // get_dac: the arithmetic coder's conditioning
    long length = u16() - 2;
    while (length > 0) {
      const int index = byte(), val = byte();
      length -= 2;
      if (index >= 32) fail("bad DAC table index");
      if (index >= 16) {
        arith_ac_k_[index - 16] = val;
      } else {
        arith_dc_l_[index] = val & 15;
        arith_dc_u_[index] = val >> 4;
        if ((val & 15) > (val >> 4)) fail("bad DAC value");
      }
    }
    if (length != 0) fail("bad DAC segment length");
  }

  void dqt() {
    long length = u16() - 2;
    while (length > 0) {
      const int n = byte();
      const int prec = n >> 4, tq = n & 15;
      if (tq >= 4) fail("bad DQT table index");
      for (int k = 0; k < 64; ++k) qt_[tq][kNatural[k]] = static_cast<uint16_t>(prec ? u16() : byte());
      qt_defined_[tq] = true;
      length -= 65;
      if (prec) length -= 64;
    }
    if (length != 0) fail("bad DQT segment length");
  }

  void dht() {
    long length = u16() - 2;
    while (length > 16) {
      int index = byte();
      HuffSpec spec;
      int count = 0;
      for (int l = 1; l <= 16; ++l) count += spec.bits[l] = static_cast<uint8_t>(byte());
      length -= 17;
      if (count > 256 || count > length) fail("bad DHT table (more codes than the segment holds)");
      for (int i = 0; i < count; ++i) spec.vals[i] = static_cast<uint8_t>(byte());
      length -= count;
      const bool ac = index & 0x10;
      if (ac) index -= 0x10;
      if (index >= 4) fail("bad DHT table index");
      spec.defined = true;
      (ac ? ac_spec_ : dc_spec_)[index] = spec;
    }
    if (length != 0) fail("bad DHT segment length");
  }

  void frame(int m) {
    if (saw_sof_) fail("a second frame (" + marker_name(m) + ")");
    const int length = u16();
    precision_ = byte();
    height_ = u16();
    width_ = u16();
    ncomp_ = byte();
    if (height_ <= 0 || width_ <= 0 || ncomp_ <= 0) {
      fail("JPEG with a zero size or no components (" + marker_name(m) + ")");
    }
    if (length - 8 != ncomp_ * 3) fail("bad " + marker_name(m) + " segment length");
    if (ncomp_ > 4) fail(std::to_string(ncomp_) + "-component JPEG (" + marker_name(m) + ") is not supported");
    for (int c = 0; c < ncomp_; ++c) {
      Component& cp = comp_[c];
      cp = Component();
      cp.id = byte();
      const int hv = byte();
      cp.h = hv >> 4;
      cp.v = hv & 15;
      cp.tq = byte();
    }
    progressive_ = m == 0xC2 || m == 0xCA;
    arith_ = m == 0xC9 || m == 0xCA;
    lossless_ = m == 0xC3;
    frame_marker_ = m;
    saw_sof_ = true;
  }

  void sos() {
    if (!saw_sof_) fail("SOS before any frame");
    const int length = u16();
    const int n = byte();
    if (length != n * 2 + 6 || n < 1 || n > 4) fail("bad SOS segment");
    ns_ = n;
    for (int i = 0; i < 4; ++i) sc_[i] = nullptr;
    for (int i = 0; i < n; ++i) {
      const int cc = byte(), c = byte();
      int found = -1;
      for (int ci = 0; ci < ncomp_ && ci < 4; ++ci) {
        if (cc == comp_[ci].id && !sc_[ci]) {
          found = ci;
          break;
        }
      }
      if (found < 0) fail("SOS names an unknown component (id " + std::to_string(cc) + ")");
      Component* cp = &comp_[found];
      sc_[i] = cp;
      cp->td = (c >> 4) & 15;
      cp->ta = c & 15;
      for (int pi = 0; pi < i; ++pi) {
        if (sc_[pi] == cp) fail("SOS names a component twice (id " + std::to_string(cc) + ")");
      }
    }
    ss_ = byte();
    se_ = byte();
    const int a = byte();
    ah_ = a >> 4;
    al_ = a & 15;
    next_restart_ = 0;
    ++scan_number_;
  }

  // jdinput.c initial_setup, jdmaster.c / jdsample.c's checks.
  void initial_setup() {
    const int m = frame_marker_;
    if (width_ > 65500 || height_ > 65500) fail("JPEG larger than 65500 pixels a side");
    if (precision_ != 8) {
      fail(std::to_string(precision_) + "-bit JPEG (" + marker_name(m) + ", precision " +
           std::to_string(precision_) + ") is not supported; only 8-bit samples are");
    }
    for (int c = 0; c < ncomp_; ++c) {
      const Component& cp = comp_[c];
      if (cp.h < 1 || cp.h > 4 || cp.v < 1 || cp.v > 4) {
        fail("bad sampling factors " + std::to_string(cp.h) + "x" + std::to_string(cp.v) +
             " of component " + std::to_string(c) + " (" + marker_name(m) + ")");
      }
      hmax_ = std::max(hmax_, cp.h);
      vmax_ = std::max(vmax_, cp.v);
    }
    if (ncomp_ != 1 && ncomp_ != 3 && ncomp_ != 4) {
      fail(std::to_string(ncomp_) + "-component JPEG (" + marker_name(m) + ") is not supported");
    }
    for (int c = 0; c < ncomp_; ++c) {
      const Component& cp = comp_[c];
      if (hmax_ % cp.h || vmax_ % cp.v) {  // libjpeg's JERR_FRACT_SAMPLE_NOTIMPL
        fail("fractional sampling: component " + std::to_string(c) + " at " +
             std::to_string(cp.h) + "x" + std::to_string(cp.v) + " of " + std::to_string(hmax_) +
             "x" + std::to_string(vmax_) + " (" + marker_name(m) + ") is not supported");
      }
    }
    // A lossless file's data unit is one sample (jdinput.c: data_unit 1).
    const int unit = lossless_ ? 1 : 8;
    mcux_ = (width_ + unit * hmax_ - 1) / (unit * hmax_);
    mcuy_ = (height_ + unit * vmax_ - 1) / (unit * vmax_);
    for (int c = 0; c < ncomp_; ++c) {
      Component& cp = comp_[c];
      cp.width = static_cast<int>((static_cast<int64_t>(width_) * cp.h + hmax_ - 1) / hmax_);
      cp.height = static_cast<int>((static_cast<int64_t>(height_) * cp.v + vmax_ - 1) / vmax_);
      cp.wb = (cp.width + unit - 1) / unit;
      cp.hb = (cp.height + unit - 1) / unit;
      cp.bw = mcux_ * cp.h;
      cp.bh = mcuy_ * cp.v;
      cp.stride = cp.bw * unit;
      std::fill(cp.coef_bits, cp.coef_bits + 64, -1);
      std::fill(cp.prev_bits, cp.prev_bits + 64, -1);
      std::fill(cp.qt, cp.qt + 64, static_cast<uint16_t>(0));
    }
    multiple_ = ns_ < ncomp_ || progressive_;
  }

  // jdinput.c start_input_pass: per_scan_setup, latch_quant_tables, the
  // entropy decoder's start_pass.
  void start_scan() {
    if (ns_ > 1) {
      int blocks = 0;
      for (int i = 0; i < ns_; ++i) {
        blocks += sc_[i]->h * sc_[i]->v;
        if (blocks > 10) {  // libjpeg's D_MAX_BLOCKS_IN_MCU
          fail("sampling factors too large for an interleaved scan (more than 10 blocks in an "
               "MCU)");
        }
      }
    }
    if (lossless_) {
      start_lossless_scan();
      return;
    }
    for (int i = 0; i < ns_; ++i) {
      Component& cp = *sc_[i];
      if (cp.coef.empty()) cp.coef.assign(static_cast<size_t>(cp.bw) * cp.bh * 64, 0);
      if (cp.latched) continue;
      if (cp.tq >= 4 || !qt_defined_[cp.tq]) {
        fail("a scan's component uses an undefined quantisation table (" + std::to_string(cp.tq) + ")");
      }
      std::copy(qt_[cp.tq], qt_[cp.tq] + 64, cp.qt);
      cp.latched = true;
    }
    if (progressive_) {
      const bool dc = ss_ == 0;
      bool bad = dc ? se_ != 0 : (ss_ > se_ || se_ > 63 || ns_ != 1);
      if ((ah_ != 0 && al_ != ah_ - 1) || al_ > 13) bad = true;
      if (bad) {
        fail("bad progressive scan (Ss " + std::to_string(ss_) + ", Se " + std::to_string(se_) +
             ", Ah " + std::to_string(ah_) + ", Al " + std::to_string(al_) + ", " +
             std::to_string(ns_) + " components)");
      }
      for (int i = 0; i < ns_; ++i) {  // the warnings pass; the bits are noted
        Component& cp = *sc_[i];
        for (int k = std::min(ss_, 1); k <= std::max(se_, 9); ++k) {
          cp.prev_bits[k] = scan_number_ > 1 ? cp.coef_bits[k] : 0;
        }
        for (int k = ss_; k <= se_; ++k) cp.coef_bits[k] = al_;
      }
      for (int i = 0; i < ns_ && !arith_; ++i) {
        Component& cp = *sc_[i];
        if (dc) {
          if (ah_ == 0) make_table(true, cp.td, dc_tab_[cp.td]);
        } else {
          make_table(false, cp.ta, ac_tab_[cp.ta]);
        }
      }
    } else if (!arith_) {
      for (int i = 0; i < ns_; ++i) {
        make_table(true, sc_[i]->td, dc_tab_[sc_[i]->td]);
        make_table(false, sc_[i]->ta, ac_tab_[sc_[i]->ta]);
      }
    }
    for (int c = 0; c < 4; ++c) last_dc_[c] = 0;
    bits_left_ = 0;
    get_buffer_ = 0;
    insufficient_ = false;
    eobrun_ = 0;
    restarts_to_go_ = restart_interval_;
    if (arith_) arith_reset();
  }

  // jdlossls.c start_pass_lossless, jdlhuff.c start_pass_lhuff_decoder,
  // jddiffct.c start_input_pass.
  void start_lossless_scan() {
    if (ss_ < 1 || ss_ > 7 || se_ != 0 || ah_ != 0 || al_ >= precision_) {
      fail("bad lossless scan (predictor " + std::to_string(ss_) + ", Se " + std::to_string(se_) +
           ", Ah " + std::to_string(ah_) + ", point transform " + std::to_string(al_) + ")");
    }
    for (int i = 0; i < ns_; ++i) {  // jdlhuff.c substitutes no standard table
      const int t = sc_[i]->td;
      if (t >= 4 || !dc_spec_[t].defined) {
        fail("a lossless scan uses an undefined Huffman table (" + std::to_string(t) + ")");
      }
      derive(dc_spec_[t], true, dc_tab_[t], 16);
    }
    mcus_per_row_ = ns_ > 1 ? mcux_ : sc_[0]->wb;
    if (restart_interval_ % mcus_per_row_ != 0) {
      fail("a lossless restart interval (" + std::to_string(restart_interval_) +
           ") that is not a whole number of MCU rows (" + std::to_string(mcus_per_row_) + ")");
    }
    restart_rows_to_go_ = restart_interval_ / mcus_per_row_;
    for (int c = 0; c < ncomp_; ++c) comp_[c].predictor = 0;
    bits_left_ = 0;
    get_buffer_ = 0;
    insufficient_ = false;
  }

  void make_table(bool dc, int index, Huffman& t) {
    if (index >= 4) fail("a scan uses Huffman table " + std::to_string(index) + " (libjpeg has 0-3)");
    const HuffSpec& spec = (dc ? dc_spec_ : ac_spec_)[index];
    if (spec.defined) {
      derive(spec, dc, t);
      return;
    }
    if (index > 1 || progressive_) {  // jdphuff.c substitutes no table
      fail("a scan uses an undefined Huffman table (" + std::to_string(index) + ")");
    }
    const StdTable& s = kStdTables[2 * index + (dc ? 0 : 1)];
    HuffSpec std_spec;
    std_spec.defined = true;
    int count = 0;
    for (int l = 1; l <= 16; ++l) count += std_spec.bits[l] = s.bits[l];
    std::copy(s.vals, s.vals + count, std_spec.vals);
    derive(std_spec, dc, t);
  }

  // ---- the bit buffer: jdhuff.c's jpeg_fill_bit_buffer ----------------------
  void fill(int nbits) {
    if (unread_marker_ == 0) {
      while (bits_left_ < 57) {
        int c = byte();
        if (c == 0xFF) {
          do {
            c = byte();
          } while (c == 0xFF);
          if (c == 0) {
            c = 0xFF;
          } else {
            unread_marker_ = c;  // the marker ending the data: zeros from here
            break;
          }
        }
        get_buffer_ = (get_buffer_ << 8) | static_cast<uint64_t>(c);
        bits_left_ += 8;
      }
      if (unread_marker_ == 0) return;
    }
    if (nbits > bits_left_) {
      insufficient_ = true;
      get_buffer_ <<= 57 - bits_left_;
      bits_left_ = 57;
    }
  }

  int get_bits(int n) {  // CHECK_BIT_BUFFER + GET_BITS
    if (bits_left_ < n) fill(n);
    bits_left_ -= n;
    return static_cast<int>(get_buffer_ >> bits_left_) & ((1 << n) - 1);
  }

  int huff(const Huffman& t) {  // HUFF_DECODE and jpeg_huff_decode
    int nb = 1;
    if (bits_left_ < 8) fill(0);
    if (bits_left_ >= 8) {
      const int look = static_cast<int>(get_buffer_ >> (bits_left_ - 8)) & 0xFF;
      nb = t.look_nb[look];
      if (nb <= 8) {
        bits_left_ -= nb;
        return t.look_sym[look];
      }
    }
    int32_t code = get_bits(nb);
    while (code > t.maxcode[nb]) {
      code = (code << 1) | get_bits(1);
      ++nb;
    }
    if (nb > 16) return 0;  // JWRN_HUFF_BAD_CODE: a zero as the safest result
    return t.vals[(code + t.valoffset[nb]) & 0xFF];
  }

  static int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

  // ---- restarts: process_restart, read_restart_marker, jpeg_resync_to_restart
  void restart() {
    bits_left_ = 0;
    if (unread_marker_ == 0) next_marker();
    if (unread_marker_ == 0xD0 + next_restart_) {
      unread_marker_ = 0;
    } else {
      if (colour_ == 3) throw RawFailure{};  // libtiff's resync_to_restart: an error
      resync(next_restart_);
    }
    next_restart_ = (next_restart_ + 1) & 7;
    for (int c = 0; c < 4; ++c) last_dc_[c] = 0;
    eobrun_ = 0;
    restarts_to_go_ = restart_interval_;
    if (unread_marker_ == 0) insufficient_ = false;
  }

  void resync(int desired) {
    for (;;) {
      const int m = unread_marker_;
      int action;
      if (m < 0xC0) {
        action = 2;
      } else if (m < 0xD0 || m > 0xD7) {
        action = 3;
      } else if (m == 0xD0 + ((desired + 1) & 7) || m == 0xD0 + ((desired + 2) & 7)) {
        action = 3;
      } else if (m == 0xD0 + ((desired - 1) & 7) || m == 0xD0 + ((desired - 2) & 7)) {
        action = 2;
      } else {
        action = 1;
      }
      if (action == 1) {
        unread_marker_ = 0;
        return;
      }
      if (action == 3) return;  // the next segment is empty
      next_marker();
    }
  }

  // ---- scans: jdcoefct.c's consume_data / decompress_onepass -----------------
  int16_t* block_at(Component& cp, int bx, int by) {
    return cp.coef.data() + (static_cast<size_t>(by) * cp.bw + bx) * 64;
  }

  void scan() {
    if (lossless_) {
      lossless_scan();
      return;
    }
    no_suspend_ = arith_;
    scan_blocks();
    no_suspend_ = false;
  }

  void scan_blocks() {
    int16_t* blocks[10];
    if (ns_ == 1) {  // non-interleaved: the component's own blocks
      Component& cp = *sc_[0];
      for (int by = 0; by < cp.hb; ++by) {
        for (int bx = 0; bx < cp.wb; ++bx) {
          blocks[0] = block_at(cp, bx, by);
          mcu(blocks, 1, by / cp.v);
        }
      }
      return;
    }
    for (int my = 0; my < mcuy_; ++my) {
      for (int mx = 0; mx < mcux_; ++mx) {
        int n = 0;
        for (int i = 0; i < ns_; ++i) {
          Component& cp = *sc_[i];
          for (int v = 0; v < cp.v; ++v) {
            for (int h = 0; h < cp.h; ++h) blocks[n++] = block_at(cp, mx * cp.h + h, my * cp.v + v);
          }
        }
        mcu(blocks, n, my);
      }
    }
  }

  int component_of(int blkn) const {  // MCU_membership
    if (ns_ == 1) return 0;
    int n = 0;
    for (int i = 0; i < ns_; ++i) {
      n += sc_[i]->h * sc_[i]->v;
      if (blkn < n) return i;
    }
    return ns_ - 1;
  }

  void mcu(int16_t** blocks, int n, int imcu_row) {
    current_row_ = imcu_row;
    if (!multiple_) {  // decompress_onepass zeroes the MCU first
      for (int b = 0; b < n; ++b) std::fill(blocks[b], blocks[b] + 64, static_cast<int16_t>(0));
    }
    if (!insufficient_) last_good_row_ = imcu_row;
    if (arith_) {
      arith_mcu(blocks, n);
      return;
    }
    if (restart_interval_ && restarts_to_go_ == 0) restart();
    if (!progressive_) {
      if (!insufficient_) sequential_mcu(blocks, n);
    } else if (ss_ == 0) {
      if (ah_ == 0) {
        if (!insufficient_) dc_first(blocks, n);
      } else {
        dc_refine(blocks, n);
      }
    } else if (!insufficient_) {
      if (ah_ == 0) ac_first(blocks[0]);
      else ac_refine(blocks[0]);
    }
    if (restart_interval_) --restarts_to_go_;
  }

  // jdhuff.c decode_mcu_slow. A snapshot of the state is not needed: a
  // suspension here ends the decode.
  void sequential_mcu(int16_t** blocks, int n) {
    for (int b = 0; b < n; ++b) {
      const int ci = component_of(b);
      Component& cp = *sc_[ci];
      int16_t* blk = blocks[b];
      int s = huff(dc_tab_[cp.td]);
      if (s) s = extend(get_bits(s), s);
      last_dc_[ci] = static_cast<int>(static_cast<unsigned>(last_dc_[ci]) + static_cast<unsigned>(s));
      blk[0] = static_cast<int16_t>(last_dc_[ci]);
      const Huffman& ac = ac_tab_[cp.ta];
      for (int k = 1; k < 64; ++k) {
        const int rs = huff(ac);
        const int r = rs >> 4;
        s = rs & 15;
        if (s) {
          k += r;
          blk[kNatural[k]] = static_cast<int16_t>(extend(get_bits(s), s));
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
    }
  }

  // ---- progressive scans: jdphuff.c ------------------------------------------
  static int16_t shifted(int v, int al) {
    return static_cast<int16_t>(static_cast<int>(static_cast<unsigned>(v) << al));
  }

  void dc_first(int16_t** blocks, int n) {
    for (int b = 0; b < n; ++b) {
      const int ci = component_of(b);
      int s = huff(dc_tab_[sc_[ci]->td]);
      if (s) s = extend(get_bits(s), s);
      const int last = last_dc_[ci];
      if ((last >= 0 && s > INT_MAX - last) || (last < 0 && s < INT_MIN - last)) {
        fail("corrupt DC coefficient (overflow)");
      }
      last_dc_[ci] = last + s;
      blocks[b][0] = shifted(last_dc_[ci], al_);
    }
  }

  void dc_refine(int16_t** blocks, int n) {
    for (int b = 0; b < n; ++b) {
      if (get_bits(1)) blocks[b][0] = static_cast<int16_t>(blocks[b][0] | (1 << al_));
    }
  }

  void ac_first(int16_t* blk) {
    if (eobrun_ > 0) {
      --eobrun_;
      return;
    }
    const Huffman& t = ac_tab_[sc_[0]->ta];
    for (int k = ss_; k <= se_; ++k) {
      const int rs = huff(t);
      int r = rs >> 4;
      const int s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = shifted(extend(get_bits(s), s), al_);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun_ = 1u << r;
        if (r) eobrun_ += static_cast<unsigned>(get_bits(r));
        --eobrun_;
        break;
      }
    }
  }

  // A correction bit for an already nonzero coefficient: 1 adds p1 to its
  // magnitude unless that bit is set already.
  void correct(int16_t* c, int p1, int m1) {
    if (get_bits(1) && (*c & p1) == 0) *c = static_cast<int16_t>(*c + (*c >= 0 ? p1 : m1));
  }

  void ac_refine(int16_t* blk) {
    const int p1 = 1 << al_, m1 = -(1 << al_);
    const Huffman& t = ac_tab_[sc_[0]->ta];
    int k = ss_;
    if (eobrun_ == 0) {
      for (; k <= se_; ++k) {
        const int rs = huff(t);
        int r = rs >> 4, s = rs & 15;
        if (s) {  // a size other than 1 is only warned about (JWRN_HUFF_BAD_CODE)
          s = get_bits(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun_ = 1u << r;
          if (r) eobrun_ += static_cast<unsigned>(get_bits(r));
          break;  // the rest of the block goes through the end-of-band path
        }
        // Pass r zero coefficients (each nonzero one passed takes a
        // correction bit), then place the new one, if any.
        do {
          int16_t* c = blk + kNatural[k];
          if (*c != 0) {
            correct(c, p1, m1);
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= se_);
        if (s) blk[kNatural[k]] = static_cast<int16_t>(s);
      }
    }
    if (eobrun_ > 0) {
      for (; k <= se_; ++k) {
        int16_t* c = blk + kNatural[k];
        if (*c != 0) correct(c, p1, m1);
      }
      --eobrun_;
    }
  }

  // ---- arithmetic-coded scans: jdarith.c -------------------------------------
  // start_pass / process_restart: the scan's statistics, DC predictions and
  // contexts, and the coder (two bytes are read at its first decision).
  void arith_reset() {
    for (int i = 0; i < ns_; ++i) {
      const Component& cp = *sc_[i];
      if (!progressive_ || (ss_ == 0 && ah_ == 0)) {
        std::fill(dc_stats_[cp.td], dc_stats_[cp.td] + 64, static_cast<uint8_t>(0));
        last_dc_[i] = 0;
        dc_context_[i] = 0;
      }
      if (!progressive_ || ss_ != 0) {
        std::fill(ac_stats_[cp.ta], ac_stats_[cp.ta] + 256, static_cast<uint8_t>(0));
      }
    }
    arith_c_ = 0;
    arith_a_ = 0;
    arith_ct_ = -16;
  }

  void arith_restart() {  // read_restart_marker, which may not suspend here
    if (unread_marker_ == 0) next_marker();
    if (unread_marker_ == 0xD0 + next_restart_) {
      unread_marker_ = 0;
    } else {
      resync(next_restart_);
    }
    next_restart_ = (next_restart_ + 1) & 7;
    arith_reset();
    restarts_to_go_ = restart_interval_;
  }

  // arith_decode: T.81 D.2's decoder with jdarith.c's byte input (a stuffed
  // zero dropped; from a marker on, zeros).
  int arith_decode(uint8_t* st) {
    while (arith_a_ < 0x8000) {
      if (--arith_ct_ < 0) {
        int data = 0;
        if (unread_marker_ == 0) {
          data = byte();
          if (data == 0xFF) {
            do {
              data = byte();
            } while (data == 0xFF);
            if (data == 0) {
              data = 0xFF;
            } else {
              unread_marker_ = data;
              data = 0;
            }
          }
        }
        arith_c_ = (arith_c_ << 8) | data;
        if ((arith_ct_ += 8) < 0 && ++arith_ct_ == 0) arith_a_ = 0x8000;  // the first two bytes
      }
      arith_a_ <<= 1;
    }
    int sv = *st;
    int64_t qe = kAritab[sv & 0x7F];
    const int nl = static_cast<int>(qe & 0xFF);
    qe >>= 8;
    const int nm = static_cast<int>(qe & 0xFF);
    qe >>= 8;
    int64_t temp = arith_a_ - qe;
    arith_a_ = temp;
    temp <<= arith_ct_;
    if (arith_c_ >= temp) {
      arith_c_ -= temp;
      if (arith_a_ < qe) {  // conditional LPS exchange
        arith_a_ = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      } else {
        arith_a_ = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (arith_a_ < 0x8000) {  // conditional MPS exchange
      if (arith_a_ < qe) {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }

  // One MCU of the scan (decode_mcu, decode_mcu_DC_first / _DC_refine /
  // _AC_first / _AC_refine). A magnitude or a run past the band sets the
  // coder's error state (ct = -1): the MCUs up to the next restart are left
  // as they are, zero in a sequential file. A DC refinement ignores it.
  void arith_mcu(int16_t** blocks, int n) {
    if (restart_interval_) {
      if (restarts_to_go_ == 0) arith_restart();
      --restarts_to_go_;
    }
    if (progressive_ && ss_ == 0 && ah_ != 0) {
      for (int b = 0; b < n; ++b) {
        if (arith_decode(&fixed_bin_)) blocks[b][0] = static_cast<int16_t>(blocks[b][0] | (1 << al_));
      }
      return;
    }
    if (arith_ct_ == -1) return;
    if (!progressive_ || ss_ == 0) {
      for (int b = 0; b < n; ++b) {
        const int ci = component_of(b);
        if (!arith_dc(ci, blocks[b])) return;
        if (!progressive_ && !arith_ac(sc_[ci]->ta, blocks[b], 1, 63, 0)) return;
      }
    } else if (ah_ == 0) {
      arith_ac(sc_[0]->ta, blocks[0], ss_, se_, al_);
    } else {
      arith_ac_refine(blocks[0]);
    }
  }

  // F.1.4.4.1: a DC difference in the context of the last one (DAC's L, U).
  bool arith_dc(int ci, int16_t* blk) {
    const int tbl = sc_[ci]->td;
    uint8_t* st = dc_stats_[tbl] + dc_context_[ci];
    if (arith_decode(st) == 0) {
      dc_context_[ci] = 0;
    } else {
      const int sign = arith_decode(st + 1);
      st += 2 + sign;
      int m = arith_decode(st);
      if (m != 0) {
        st = dc_stats_[tbl] + 20;  // X1
        while (arith_decode(st)) {
          if ((m <<= 1) == 0x8000) {
            arith_ct_ = -1;
            return false;
          }
          ++st;
        }
      }
      if (m < ((1 << arith_dc_l_[tbl]) >> 1)) {
        dc_context_[ci] = 0;
      } else if (m > ((1 << arith_dc_u_[tbl]) >> 1)) {
        dc_context_[ci] = 12 + sign * 4;
      } else {
        dc_context_[ci] = 4 + sign * 4;
      }
      int v = m;
      st += 14;
      while (m >>= 1) {
        if (arith_decode(st)) v |= m;
      }
      v += 1;
      if (sign) v = -v;
      last_dc_[ci] = (last_dc_[ci] + v) & 0xFFFF;
    }
    blk[0] = shifted(last_dc_[ci], progressive_ ? al_ : 0);
    return true;
  }

  // F.1.4.4.2: the coefficients ss..se of a block (sequential: 1..63).
  bool arith_ac(int tbl, int16_t* blk, int ss, int se, int al) {
    for (int k = ss; k <= se; ++k) {
      uint8_t* st = ac_stats_[tbl] + 3 * (k - 1);
      if (arith_decode(st)) break;  // end of block
      while (arith_decode(st + 1) == 0) {
        st += 3;
        if (++k > se) {
          arith_ct_ = -1;
          return false;
        }
      }
      const int sign = arith_decode(&fixed_bin_);
      st += 2;
      int m = arith_decode(st);
      if (m != 0 && arith_decode(st)) {
        m <<= 1;
        st = ac_stats_[tbl] + (k <= arith_ac_k_[tbl] ? 189 : 217);
        while (arith_decode(st)) {
          if ((m <<= 1) == 0x8000) {
            arith_ct_ = -1;
            return false;
          }
          ++st;
        }
      }
      int v = m;
      st += 14;
      while (m >>= 1) {
        if (arith_decode(st)) v |= m;
      }
      v += 1;
      if (sign) v = -v;
      blk[kNatural[k]] = shifted(v, al);
    }
    return true;
  }

  // G.1.3.3: correction bits of the nonzero coefficients, new ones of +-1.
  void arith_ac_refine(int16_t* blk) {
    const int tbl = sc_[0]->ta;
    const int p1 = 1 << al_, m1 = -(1 << al_);
    int kex = se_;  // the previous stage's end of band
    for (; kex > 0; --kex) {
      if (blk[kNatural[kex]]) break;
    }
    for (int k = ss_; k <= se_; ++k) {
      uint8_t* st = ac_stats_[tbl] + 3 * (k - 1);
      if (k > kex && arith_decode(st)) break;
      for (;;) {
        int16_t* c = blk + kNatural[k];
        if (*c) {
          if (arith_decode(st + 2)) *c = static_cast<int16_t>(*c + (*c < 0 ? m1 : p1));
          break;
        }
        if (arith_decode(st + 1)) {
          *c = static_cast<int16_t>(arith_decode(&fixed_bin_) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > se_) {
          arith_ct_ = -1;
          return;
        }
      }
    }
  }

  // ---- lossless scans: jddiffct.c, jdlhuff.c, jdlossls.c ---------------------
  static int last_rows(const Component& cp) {
    const int r = cp.hb % cp.v;
    return r ? r : cp.v;
  }

  // decompress_data: an iMCU row's MCU rows decoded (a restart checked
  // before each), then each of its component rows undifferenced and scaled.
  // A restart that falls inside a non-interleaved scan's iMCU row resets
  // the predictors before any of its rows is undifferenced, as libjpeg does.
  void lossless_scan() {
    for (int i = 0; i < ns_; ++i) {
      Component& cp = *sc_[i];
      if (cp.plane.empty()) cp.plane.assign(static_cast<size_t>(cp.stride) * cp.bh, 0);
      cp.diff.assign(static_cast<size_t>(cp.v) * cp.bw, 0);
      cp.undiff.assign(static_cast<size_t>(cp.v) * cp.bw, 0);
    }
    const int initial = 1 << (precision_ - al_ - 1);
    for (int row = 0; row < mcuy_; ++row) {
      const bool last = row == mcuy_ - 1;
      const int mcu_rows = ns_ > 1 ? 1 : last ? last_rows(*sc_[0]) : sc_[0]->v;
      for (int y = 0; y < mcu_rows; ++y) {
        if (restart_interval_ && restart_rows_to_go_ == 0) {
          restart();
          for (int c = 0; c < ncomp_; ++c) comp_[c].predictor = 0;
          restart_rows_to_go_ = restart_interval_ / mcus_per_row_;
        }
        lossless_mcus(y);
        if (restart_interval_) --restart_rows_to_go_;
      }
      for (int i = 0; i < ns_; ++i) {
        Component& cp = *sc_[i];
        const int rows = last ? last_rows(cp) : cp.v;
        for (int r = 0, prev = cp.v - 1; r < rows; prev = r, ++r) {
          int32_t* out = cp.undiff.data() + static_cast<size_t>(r) * cp.bw;
          undifference_row(cp.diff.data() + static_cast<size_t>(r) * cp.bw,
                           cp.undiff.data() + static_cast<size_t>(prev) * cp.bw, out, cp.width,
                           cp.predictor, initial);
          cp.predictor = ss_;
          scale_row(out, cp.plane.data() + static_cast<size_t>(row * cp.v + r) * cp.stride,
                    cp.width, al_);
        }
      }
    }
  }

  // decode_mcus for MCU row y of the iMCU row: SSSS 16 is 32768 with no
  // extra bits. Once the data has run into a marker, every later row's
  // differences are zero and the predictors restart (CENTERJSAMPLE rows).
  void lossless_mcus(int y) {
    if (insufficient_) {
      for (int i = 0; i < ns_; ++i) {
        Component& cp = *sc_[i];
        const int rows = ns_ > 1 ? cp.v : 1;
        std::fill(cp.diff.begin() + static_cast<size_t>(y) * cp.bw,
                  cp.diff.begin() + static_cast<size_t>(y + rows) * cp.bw, 0);
      }
      for (int c = 0; c < ncomp_; ++c) comp_[c].predictor = 0;
      return;
    }
    if (ns_ == 1) {
      Component& cp = *sc_[0];
      int32_t* d = cp.diff.data() + static_cast<size_t>(y) * cp.bw;
      for (int x = 0; x < mcus_per_row_; ++x) d[x] = lossless_diff(dc_tab_[cp.td]);
      return;
    }
    for (int mx = 0; mx < mcus_per_row_; ++mx) {
      for (int i = 0; i < ns_; ++i) {
        Component& cp = *sc_[i];
        for (int v = 0; v < cp.v; ++v) {
          int32_t* d = cp.diff.data() + static_cast<size_t>(v) * cp.bw + mx * cp.h;
          for (int h = 0; h < cp.h; ++h) d[h] = lossless_diff(dc_tab_[cp.td]);
        }
      }
    }
  }

  int lossless_diff(const Huffman& t) {
    int s = huff(t);
    if (s == 16) return 32768;
    return s ? extend(get_bits(s), s) : 0;
  }

  // ---- coefficients to samples: jdcoefct.c -------------------------------
  // smoothing_ok: DC known for every component, the quantisers used nonzero,
  // and some AC coefficient among the first nine short of its last bit.
  bool smoothing_ok() const {
    if (!progressive_) return false;
    static const int kPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    bool useful = false;
    for (int c = 0; c < ncomp_; ++c) {
      const Component& cp = comp_[c];
      if (!cp.latched) return false;
      for (int i = 0; i < 10; ++i) {
        if (cp.qt[kPos[i]] == 0) return false;
      }
      if (cp.coef_bits[0] < 0) return false;
      for (int k = 1; k < 10; ++k) useful |= cp.coef_bits[k] != 0;
    }
    return useful;
  }

  void planes() {
    if (lossless_) {  // the scans wrote the samples
      for (int c = 0; c < ncomp_; ++c) {
        Component& cp = comp_[c];
        if (cp.plane.empty()) cp.plane.assign(static_cast<size_t>(cp.stride) * cp.bh, 0);
      }
      return;
    }
    const bool smooth = smoothing_ok();
    const int total_rows = mcuy_;  // iMCU rows
    for (int c = 0; c < ncomp_; ++c) {
      Component& cp = comp_[c];
      if (cp.coef.empty()) cp.coef.assign(static_cast<size_t>(cp.bw) * cp.bh * 64, 0);
      cp.plane.assign(static_cast<size_t>(cp.stride) * cp.bh * 8, 0);
      if (!smooth) {
        for (int by = 0; by < cp.bh; ++by) {
          for (int bx = 0; bx < cp.bw; ++bx) {
            idct_islow(block_at(cp, bx, by), cp.qt, pixel(cp, bx, by), cp.stride);
          }
        }
        continue;
      }
      for (int row = 0; row < total_rows; ++row) {
        int block_rows = cp.v;
        if (row == total_rows - 1) {
          block_rows = cp.hb % cp.v;
          if (block_rows == 0) block_rows = cp.v;
        }
        int bits[10];
        const int* latch = row > last_good_row_ ? cp.prev_bits : cp.coef_bits;
        for (int k = 0; k < 10; ++k) bits[k] = latch[k];
        if (row > last_good_row_ && scan_number_ <= 1) std::fill(bits + 1, bits + 10, -1);
        const int image_rows = block_rows * total_rows;
        for (int br = 0; br < block_rows; ++br) {
          const int image_row = row * block_rows + br;
          const int by = row * cp.v + br;
          const int prev = image_row > 0 ? by - 1 : by;
          const int prev2 = image_row > 1 ? by - 2 : prev;
          const int next = image_row < image_rows - 1 ? by + 1 : by;
          const int next2 = image_row < image_rows - 2 ? by + 2 : next;
          smooth_row(cp, by, prev2, prev, next, next2, bits);
        }
      }
    }
  }

  uint8_t* pixel(Component& cp, int bx, int by) {
    return cp.plane.data() + (static_cast<size_t>(by) * 8) * cp.stride + bx * 8;
  }

  // decompress_smooth_data on one row of blocks; rows[0..4] are the block
  // rows two above to two below (edges replicated).
  void smooth_row(Component& cp, int by, int r0, int r1, int r3, int r4, const int* bits) {
    const int rows[5] = {r0, r1, by, r3, r4};
    const int last = cp.wb - 1;
    auto dcv = [&](int r, int bx) { return static_cast<int>(block_at(cp, bx, rows[r])[0]); };
    int dc[5][5];  // [row][column], column 2 the current block
    for (int r = 0; r < 5; ++r) {
      for (int i = 0; i < 5; ++i) dc[r][i] = dcv(r, 0);
    }
    const bool change_dc = bits[1] == -1 && bits[2] == -1 && bits[3] == -1 && bits[4] == -1 &&
                           bits[5] == -1 && bits[6] == -1 && bits[7] == -1 && bits[8] == -1 &&
                           bits[9] == -1;
    const uint16_t* q = cp.qt;
    const int64_t q00 = q[0], q01 = q[1], q10 = q[8], q20 = q[16], q11 = q[9], q02 = q[2];
    const int64_t q03 = change_dc ? q[3] : 0, q12 = change_dc ? q[10] : 0,
                  q21 = change_dc ? q[17] : 0, q30 = change_dc ? q[24] : 0;
    for (int bx = 0; bx <= last; ++bx) {
      int16_t ws[64];
      std::copy(block_at(cp, bx, by), block_at(cp, bx, by) + 64, ws);
      if (bx == 0 && bx < last) {
        for (int r = 0; r < 5; ++r) dc[r][3] = dc[r][4] = dcv(r, 1);
      }
      if (bx + 1 < last) {
        for (int r = 0; r < 5; ++r) dc[r][4] = dcv(r, bx + 2);
      }
      // DC01..DC25 of libjpeg: DC(5 r + i + 1) = dc[r][i].
#define D(n) static_cast<int64_t>(dc[((n) - 1) / 5][((n) - 1) % 5])
      auto predict = [&](int al, int pos, int64_t qk, int64_t num) {
        if (al == 0 || ws[pos] != 0) return;
        int pred;
        if (num >= 0) {
          pred = static_cast<int>(((qk << 7) + num) / (qk << 8));
          if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
        } else {
          pred = static_cast<int>(((qk << 7) - num) / (qk << 8));
          if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
          pred = -pred;
        }
        ws[pos] = static_cast<int16_t>(pred);
      };
      predict(bits[1], 1, q01, q00 * (change_dc
          ? (-D(1) - D(2) + D(4) + D(5) - 3 * D(6) + 13 * D(7) - 13 * D(9) + 3 * D(10) -
             3 * D(11) + 38 * D(12) - 38 * D(14) + 3 * D(15) - 3 * D(16) + 13 * D(17) -
             13 * D(19) + 3 * D(20) - D(21) - D(22) + D(24) + D(25))
          : (-7 * D(11) + 50 * D(12) - 50 * D(14) + 7 * D(15))));
      predict(bits[2], 8, q10, q00 * (change_dc
          ? (-D(1) - 3 * D(2) - 3 * D(3) - 3 * D(4) - D(5) - D(6) + 13 * D(7) + 38 * D(8) +
             13 * D(9) - D(10) + D(16) - 13 * D(17) - 38 * D(18) - 13 * D(19) + D(20) + D(21) +
             3 * D(22) + 3 * D(23) + 3 * D(24) + D(25))
          : (-7 * D(3) + 50 * D(8) - 50 * D(18) + 7 * D(23))));
      predict(bits[3], 16, q20, q00 * (change_dc
          ? (D(3) + 2 * D(7) + 7 * D(8) + 2 * D(9) - 5 * D(12) - 14 * D(13) - 5 * D(14) +
             2 * D(17) + 7 * D(18) + 2 * D(19) + D(23))
          : (-D(3) + 13 * D(8) - 24 * D(13) + 13 * D(18) - D(23))));
      predict(bits[4], 9, q11, q00 * (change_dc
          ? (-D(1) + D(5) + 9 * D(7) - 9 * D(9) - 9 * D(17) + 9 * D(19) + D(21) - D(25))
          : (D(10) + D(16) - 10 * D(17) + 10 * D(19) - D(2) - D(20) + D(22) - D(24) + D(4) -
             D(6) + 10 * D(7) - 10 * D(9))));
      predict(bits[5], 2, q02, q00 * (change_dc
          ? (2 * D(7) - 5 * D(8) + 2 * D(9) + D(11) + 7 * D(12) - 14 * D(13) + 7 * D(14) +
             D(15) + 2 * D(17) - 5 * D(18) + 2 * D(19))
          : (-D(11) + 13 * D(12) - 24 * D(13) + 13 * D(14) - D(15))));
      if (change_dc) {
        predict(bits[6], 3, q03, q00 * (D(7) - D(9) + 2 * D(12) - 2 * D(14) + D(17) - D(19)));
        predict(bits[7], 10, q12, q00 * (D(7) - 3 * D(8) + D(9) - D(17) + 3 * D(18) - D(19)));
        predict(bits[8], 17, q21, q00 * (D(7) - D(9) - 3 * D(12) + 3 * D(14) + D(17) - D(19)));
        predict(bits[9], 24, q30, q00 * (D(7) + 2 * D(8) + D(9) - D(17) - 2 * D(18) - D(19)));
        const int64_t num = q00 * (
            -2 * D(1) - 6 * D(2) - 8 * D(3) - 6 * D(4) - 2 * D(5) - 6 * D(6) + 6 * D(7) +
            42 * D(8) + 6 * D(9) - 6 * D(10) - 8 * D(11) + 42 * D(12) + 152 * D(13) +
            42 * D(14) - 8 * D(15) - 6 * D(16) + 6 * D(17) + 42 * D(18) + 6 * D(19) -
            6 * D(20) - 2 * D(21) - 6 * D(22) - 8 * D(23) - 6 * D(24) - 2 * D(25));
        int pred = num >= 0 ? static_cast<int>(((q00 << 7) + num) / (q00 << 8))
                            : -static_cast<int>(((q00 << 7) - num) / (q00 << 8));
        ws[0] = static_cast<int16_t>(pred);
      }
#undef D
      idct_islow(ws, cp.qt, pixel(cp, bx, by), cp.stride);
      for (int r = 0; r < 5; ++r) {
        for (int i = 0; i < 4; ++i) dc[r][i] = dc[r][i + 1];
      }
    }
  }

  // ---- upsampling and colour: jdsample.c, jdcolor.c -------------------
  void upsampled_row(const Component& cp, int y, uint8_t* row) const {
    upsample_row(cp.plane.data(), cp.stride, cp.width, cp.height, hmax_ / cp.h, vmax_ / cp.v, y,
                 width_, row, !lossless_);
  }

  void output(uint8_t* out) const {
    if (colour_ == 3) {
      for (int c = 0; c < ncomp_; ++c) {
        const size_t n = comp_[c].plane.size();
        memcpy(out, comp_[c].plane.data(), n);
        out += n;
      }
      return;
    }
    if (ncomp_ == 1) {
      for (int y = 0; y < height_; ++y) {
        memcpy(out + static_cast<size_t>(y) * width_,
               comp_[0].plane.data() + static_cast<size_t>(y) * comp_[0].stride, width_);
      }
      return;
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
    // libjpeg's default colour space. Three components: JFIF means YCbCr;
    // else an Adobe marker's transform 0 means RGB; else component ids 'R',
    // 'G', 'B' mean RGB (any ids, in a lossless file). Four: an Adobe
    // transform other than 0 means YCCK, else CMYK. A lossless file is never
    // converted: jdcolor.c refuses.
    // A TIFF's strips and tiles name their colour space in the TIFF's tags
    // instead (libtiff's JPEGPreDecode): colour_ 1 is YCbCr -> RGB, 2 leaves
    // every component as coded (JCS_UNKNOWN, no inversion).
    const int nc = ncomp_;
    bool convert = true;
    if (colour_ != 0) {
      if (colour_ == 1 && nc != 3) fail("YCbCr -> RGB needs 3 components");
      convert = colour_ == 1;
    } else if (nc == 3 && !saw_jfif_) {
      convert = saw_adobe_ ? adobe_transform_ != 0
                           : !lossless_ && !(comp_[0].id == 'R' && comp_[1].id == 'G' &&
                                             comp_[2].id == 'B');
    } else if (nc == 4) {
      convert = saw_adobe_ && adobe_transform_ != 0;
    }
    if (lossless_ && convert) {
      fail(std::string("lossless JPEG (SOF3) whose ") +
           (nc == 4 ? "YCCK" : colour_ == 1 ? "TIFF's YCbCr" : saw_jfif_ ? "JFIF YCbCr" : "YCbCr") +
           " would need a colour conversion, which libjpeg refuses for lossless data");
    }
    const size_t room = static_cast<size_t>(width_) + 2;
    std::vector<uint8_t> rows(4 * room);
    uint8_t* r[4] = {rows.data(), rows.data() + room, rows.data() + 2 * room, rows.data() + 3 * room};
    for (int y = 0; y < height_; ++y) {
      for (int c = 0; c < nc; ++c) upsampled_row(comp_[c], y, r[c]);
      uint8_t* o = out + static_cast<size_t>(y) * width_ * nc;
      for (int x = 0; x < width_; ++x, o += nc) {
        if (!convert) {
          for (int c = 0; c < nc; ++c) o[c] = r[c][x];
        } else {
          int yy = r[0][x], cb = r[1][x], cr = r[2][x];
          o[0] = clamp(yy + cr_r[cr]);
          o[1] = clamp(yy + static_cast<int>((cb_g[cb] + cr_g[cr]) >> 16));
          o[2] = clamp(yy + cb_b[cb]);
          if (nc == 4) o[3] = r[3][x];
        }
        // YCCK -> CMYK inverts C, M and Y (ycck_cmyk_convert); PIL's
        // "CMYK;I" then inverts all four, so C, M and Y come out as RGB.
        if (nc == 4 && !convert && colour_ == 0) {
          for (int c = 0; c < 4; ++c) o[c] = static_cast<uint8_t>(255 - o[c]);
        } else if (nc == 4 && convert) {
          o[3] = static_cast<uint8_t>(255 - o[3]);
        }
      }
    }
  }

  const uint8_t* data_;
  size_t size_;
  size_t pos_ = 0;
  int unread_marker_ = 0;
  bool saw_soi_ = false, saw_sof_ = false;
  uint16_t qt_[4][64] = {};
  bool qt_defined_[4] = {false, false, false, false};
  HuffSpec dc_spec_[4], ac_spec_[4];
  Huffman dc_tab_[4], ac_tab_[4];
  int width_ = 0, height_ = 0, ncomp_ = 0, hmax_ = 1, vmax_ = 1, mcux_ = 0, mcuy_ = 0;
  int frame_marker_ = 0, precision_ = 8;
  Component comp_[4];
  Component* sc_[4] = {nullptr, nullptr, nullptr, nullptr};
  int ns_ = 0, ss_ = 0, se_ = 0, ah_ = 0, al_ = 0;
  int scan_number_ = 0, next_restart_ = 0;
  int restart_interval_ = 0, restarts_to_go_ = 0;
  bool progressive_ = false, multiple_ = false, arith_ = false, lossless_ = false;
  size_t limit_;  // the end of the 64 KiB blocks PIL has handed libjpeg
  bool no_suspend_ = false;
  // Arithmetic decoding: DAC's conditioning, the statistics of each table,
  // each scan component's DC context, and the coder's registers.
  int arith_dc_l_[16] = {0}, arith_dc_u_[16] = {0}, arith_ac_k_[16] = {0};
  uint8_t dc_stats_[16][64] = {}, ac_stats_[16][256] = {};
  uint8_t fixed_bin_ = 113;
  int dc_context_[4] = {0, 0, 0, 0};
  int64_t arith_c_ = 0, arith_a_ = 0;
  int arith_ct_ = 0;
  // Lossless decoding: MCUs per MCU row, MCU rows to the next restart.
  int mcus_per_row_ = 1, restart_rows_to_go_ = 0;
  int last_dc_[4] = {0, 0, 0, 0};
  unsigned eobrun_ = 0;
  int last_good_row_ = 0;
  bool saw_jfif_ = false, saw_adobe_ = false;
  int adobe_transform_ = 0;
  int colour_ = 0;
  bool scanning_ = false;
  int current_row_ = 0, failed_row_ = -1;
  uint64_t get_buffer_ = 0;
  int bits_left_ = 0;
  bool insufficient_ = false;
  bool fake_eoi_ = false;
  unsigned fake_ = 0;
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

int w3d_jpeg_frame(const uint8_t* data, int64_t size, int32_t* info, char* msg, int32_t msg_len) {
  try {
    Decoder d(data, static_cast<size_t>(size));
    d.set_colour(2);  // a TIFF's stream: libtiff's source
    d.header();
    info[0] = d.width();
    info[1] = d.height();
    info[2] = d.channels();
    for (int c = 0; c < d.channels(); ++c) info[3 + c] = d.sampling(c);
    return 0;
  } catch (const DecodeError& e) {
    set_message(msg, msg_len, e.msg);
  } catch (const std::exception& e) {
    set_message(msg, msg_len, e.what());
  }
  return -1;
}

int w3d_jpeg_decode_as(const uint8_t* data, int64_t size, int32_t colour, uint8_t* out,
                       int64_t out_size, char* msg, int32_t msg_len) {
  try {
    Decoder d(data, static_cast<size_t>(size));
    d.set_colour(colour);
    d.header();
    int64_t need = colour == 3 ? d.raw_size()
                               : static_cast<int64_t>(d.width()) * d.height() * d.channels();
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

int w3d_jpeg_decode_raw(const uint8_t* data, int64_t size, uint8_t* out, int64_t out_size,
                        int32_t* failed_row, char* msg, int32_t msg_len) {
  try {
    Decoder d(data, static_cast<size_t>(size));
    d.set_colour(3);
    d.header();
    if (out_size < d.raw_size()) {
      set_message(msg, msg_len, "output buffer too small");
      return -1;
    }
    d.decode(out);
    *failed_row = d.failed_row();
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
  return w3d_jpeg_decode_as(data, size, 0, out, out_size, msg, msg_len);
}

int w3d_jpeg_idct(const int16_t* coef, const uint16_t* qt, int64_t n, uint8_t* out) {
  for (int64_t b = 0; b < n; ++b) idct_islow(coef + 64 * b, qt, out + 64 * b, 8);
  return 0;
}

int w3d_jpeg_undifference(const int32_t* diff, int64_t rows, int32_t width, int32_t predictor,
                          int32_t point_transform, int32_t initial, int32_t reset_every,
                          uint8_t* out, char* msg, int32_t msg_len) {
  try {
    if (rows < 1 || width < 1 || predictor < 1 || predictor > 7 || point_transform < 0 ||
        point_transform > 15 || reset_every < 0) {
      fail("bad undifferencing arguments");
    }
    std::vector<int32_t> a(static_cast<size_t>(width)), b(static_cast<size_t>(width));
    for (int64_t r = 0; r < rows; ++r) {
      const bool first = r == 0 || (reset_every && r % reset_every == 0);
      undifference_row(diff + r * width, b.data(), a.data(), width, first ? 0 : predictor,
                       initial);
      scale_row(a.data(), out + r * width, width, point_transform);
      std::swap(a, b);
    }
    return 0;
  } catch (const DecodeError& e) {
    set_message(msg, msg_len, e.msg);
  } catch (const std::exception& e) {
    set_message(msg, msg_len, e.what());
  }
  return -1;
}

int w3d_jpeg_upsample(const uint8_t* plane, int64_t stride, int32_t width, int32_t height,
                      int32_t rh, int32_t rv, uint8_t* out, int32_t out_width,
                      int32_t out_height, char* msg, int32_t msg_len) {
  try {
    if (width < 1 || height < 1 || rh < 1 || rh > 4 || rv < 1 || rv > 4 ||
        out_width > static_cast<int64_t>(width) * rh || out_height > static_cast<int64_t>(height) * rv ||
        stride < width) {
      fail("bad upsampling shape");
    }
    std::vector<uint8_t> row(static_cast<size_t>(width) * rh + 2);
    for (int y = 0; y < out_height; ++y) {
      upsample_row(plane, stride, width, height, rh, rv, y, out_width, row.data());
      memcpy(out + static_cast<size_t>(y) * out_width, row.data(), static_cast<size_t>(out_width));
    }
    return 0;
  } catch (const DecodeError& e) {
    set_message(msg, msg_len, e.msg);
  } catch (const std::exception& e) {
    set_message(msg, msg_len, e.what());
  }
  return -1;
}

}  // extern "C"
