"""Image writers for the port's fixtures and chip checks, in numpy and the
standard library (no PIL): files of the kinds PIL reads but will not write.

    from tools.image_writers import jpeg_bytes, png_bytes, bmp_bytes, tiff_bytes, gif_bytes

- `jpeg_bytes`: a baseline or progressive JPEG encoder (forward DCT in
  float64, the standard quantisation tables of JPEG Annex K scaled by IJG's
  quality rule, Annex K's Huffman tables), 1, 3 or 4 components, any
  sampling factors 1-4 (box-filtered chroma), an optional Adobe APP14
  marker with transform 0, 1 or 2, restart intervals, and any progressive
  scan script, complete or cut short of its last scans; or arithmetic-coded
  (SOF9 / SOF10) as libjpeg's jcarith.c codes it (T.81 Annex D, DAC
  conditioning). PIL writes only 4:4:4, 4:2:2 and 4:2:0, never YCCK, no
  partly refined file and nothing arithmetic-coded or lossless.
- `jpeg_transcode`: a sequential Huffman JPEG (PIL's) rewritten coefficient
  for coefficient, arithmetic-coded or progressive (`jpegtran -arithmetic`'s
  rewrite), with `jpeg_coefficients`, a plain Huffman decoder for it.
- `jpeg_lossless_bytes`: lossless JPEG (SOF3): predictors 1-7, a point
  transform, restart intervals, any sampling, one interleaved scan or a
  scan a component, JFIF or Adobe markers.
- `png_bytes`: every colour type at every bit depth, PLTE / tRNS / other
  chunks, Adam7, one row filter throughout.
- `bmp_bytes`: 1-, 4-, 8-bit palette, 16-, 24- and 32-bit, BI_RGB or
  BI_BITFIELDS, RLE8 / RLE4, bottom-up or top-down.
- `tiff_bytes`: strips or tiles, chunky or separate planes, 1-32-bit
  integer or float samples (12-bit packed), compression none, PackBits,
  LZW, Deflate, LZMA, ZSTD (with the `zstandard` package) or JPEG
  (abbreviated streams with JPEGTables) or strips compressed elsewhere,
  predictor 1, 2 or 3, fill order 1 or 2, a colour map, YCbCr in
  subsampled data units in strips or tiles, either byte order, classic TIFF
  or BigTIFF.
- `tga_bytes`: colour-mapped, true-colour or grey TGA at any depth PIL
  reads, raw or run-length encoded (packets across rows or not), with an ID
  field, a colour map from a first entry index, and either origin.
- `pnm_bytes`: P1-P6 (ASCII and binary, any maxval, comments) and Pf.
- `qoi_bytes`: QOI with any subset of its ops.
- `gif_bytes`: one image of palette indices on a logical screen, at an
  offset, with a global or a local colour table (or none), interlaced, with
  a transparent index, and LZW of any minimum code size; PIL writes neither
  a local table nor a first image smaller than the screen.
- `icon_bytes` / `dib_bytes`: ICO and CUR files of DIB (with an AND mask)
  or PNG entries; PIL writes no CUR and no DIB entry.
- `sun_bytes`: Sun raster at 1, 4, 8, 24 and 32 bits, raw or byte-encoded,
  with a colour map.
- `psd_bytes`: Photoshop's merged image, raw or PackBits, in every colour
  mode PIL reads.
- `sgi_bytes`: SGI at 8 or 16 bits, verbatim or run-length (PIL writes only
  verbatim).
- `pcx_bytes`: run-length PCX in 1-bit planes, 8-bit and 24-bit.
- `dds_bytes`: a DDS header (legacy or DX10) around given BCn blocks or
  pixels.

The port never imports this module; the fixture tool, the tests and
`chip_smoke.py` do.
"""

from __future__ import annotations

import lzma
import re
import struct
import zlib
from typing import Optional, Sequence, Tuple

import numpy as np

# ---- JPEG -----------------------------------------------------------------------------

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34,
    27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44,
    51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13, 16, 24, 40, 57,
    69, 56, 14, 17, 22, 29, 51, 87, 80, 62, 18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64,
    81, 104, 113, 92, 49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
CHROMA_Q = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99, 24, 26, 56, 99, 99, 99,
    99, 99, 47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32)
# Annex K.3: (code counts by length 1-16, symbols) of the four tables.
DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12)))
AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282090a161718191a"
    "25262728292a3435363738393a434445464748494a535455565758595a636465666768696a73747576777879"
    "7a838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9"
    "cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"))
AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a162434e125f11718"
    "191a262728292a35363738393a434445464748494a535455565758595a636465666768696a73747576777879"
    "7a82838485868788898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8"
    "c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"))


def _huffman_codes(table):
    """Annex C: symbol -> (code, length)."""
    counts, symbols = table
    codes, code, k = {}, 0, 0
    for length, n in enumerate(counts, start=1):
        for _ in range(n):
            codes[symbols[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return codes


def _scaled_quant(base: np.ndarray, quality: int) -> np.ndarray:
    """IJG's jpeg_quality_scaling, baseline-limited to 1-255."""
    quality = min(max(quality, 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255)


def _dct_matrix() -> np.ndarray:
    k, n = np.mgrid[0:8, 0:8]
    c = np.cos((2 * n + 1) * k * np.pi / 16) * np.sqrt(2 / 8)
    c[0] /= np.sqrt(2)
    return c


def rgb_to_ycc(rgb: np.ndarray) -> np.ndarray:
    """JFIF's RGB -> YCbCr, rounded to uint8."""
    r, g, b = (rgb[..., i].astype(np.float64) for i in range(3))
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128
    return np.clip(np.round(np.stack([y, cb, cr], -1)), 0, 255).astype(np.uint8)


class _Bits:
    def __init__(self):
        self.codes, self.lengths = [], []

    def put(self, code: int, length: int):
        if length:
            self.codes.append(code)
            self.lengths.append(length)

    def packed(self, pad: int) -> bytes:
        """The codes from their high bits, the last byte filled with `pad`."""
        if not self.codes:
            return b""
        codes = np.array(self.codes, np.int64)
        lengths = np.array(self.lengths, np.int64)
        j = np.arange(16)
        bits = (codes[:, None] >> (lengths[:, None] - 1 - j)) & 1
        bits = bits[j[None, :] < lengths[:, None]]
        bits = np.concatenate([bits, np.full(-bits.size % 8, pad, np.int64)])
        return np.packbits(bits.astype(np.uint8)).tobytes()


def _magnitude(v: int) -> Tuple[int, int]:
    """(category, the bits that follow it) of a DC difference or AC value."""
    size = int(abs(v)).bit_length()
    return size, (v if v >= 0 else v + (1 << size) - 1)


# libjpeg's jpeg_simple_progression for three components (YCbCr) and for
# one: (components, Ss, Se, Ah, Al) of each scan.
PROGRESSIVE_3 = (((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1),
                 ((1,), 1, 63, 0, 1), ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
                 ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0), ((1,), 1, 63, 1, 0),
                 ((0,), 1, 63, 1, 0))
PROGRESSIVE_1 = (((0,), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((0,), 6, 63, 0, 2),
                 ((0,), 1, 63, 2, 1), ((0,), 0, 0, 1, 0), ((0,), 1, 63, 1, 0))


def _mcu_blocks(comps, sampling, mcux, mcuy, dims):
    """(component, block row, block column) in a scan's order: MCUs of every
    component's h x v blocks when interleaved, else the component's own
    blocks (`dims[c]` = blocks down and across that hold image samples)."""
    if len(comps) == 1:
        c = comps[0]
        return [[(c, by, bx)] for by in range(dims[c][0]) for bx in range(dims[c][1])]
    return [[(c, my * sampling[c][1] + by, mx * sampling[c][0] + bx) for c in comps
             for by in range(sampling[c][1]) for bx in range(sampling[c][0])]
            for my in range(mcuy) for mx in range(mcux)]


def _encode_scan(units, blocks, comps, ss, se, ah, al, tables, restart_interval):
    """One scan's entropy-coded segments (a list: one per restart interval)
    as libjpeg's jchuff.c / jcphuff.c code it, every end-of-band run 1."""
    segments, bits, pred = [], _Bits(), {c: 0 for c in comps}
    for n, unit in enumerate(units):
        if restart_interval and n and n % restart_interval == 0:
            segments.append(bits)
            bits, pred = _Bits(), {c: 0 for c in comps}
        for c, by, bx in unit:
            dc_codes, ac_codes = tables[min(c, 1)]
            blk = [int(v) for v in blocks[c][by, bx]]
            if ss == 0 and ah == 0:  # DC first (or the sequential DC)
                v = blk[0] >> al
                size, extra = _magnitude(v - pred[c])
                pred[c] = v
                bits.put(*dc_codes[size])
                bits.put(extra, size)
                if se == 0:
                    continue
            elif ss == 0:  # DC refinement: the next bit
                bits.put((blk[0] >> al) & 1, 1)
                continue
            lo = max(ss, 1)
            if ah == 0:  # AC first
                run = 0
                for k in range(lo, se + 1):
                    mag = abs(blk[k]) >> al
                    if mag == 0:
                        run += 1
                        continue
                    while run > 15:
                        bits.put(*ac_codes[0xF0])
                        run -= 16
                    size, extra = _magnitude(mag if blk[k] > 0 else -mag)
                    bits.put(*ac_codes[(run << 4) | size])
                    bits.put(extra, size)
                    run = 0
                if run:
                    bits.put(*ac_codes[0x00])
                continue
            mags = [abs(blk[k]) >> al for k in range(lo, se + 1)]
            eob = max([i for i, m in enumerate(mags) if m == 1], default=-1)
            run, pending = 0, []
            for i, m in enumerate(mags):
                if m == 0:
                    run += 1
                    continue
                while run > 15 and i <= eob:
                    bits.put(*ac_codes[0xF0])
                    run -= 16
                    for b in pending:
                        bits.put(b, 1)
                    pending = []
                if m > 1:  # already nonzero: a correction bit
                    pending.append(m & 1)
                    continue
                bits.put(*ac_codes[(run << 4) | 1])
                bits.put(int(blk[lo + i] > 0), 1)
                for b in pending:
                    bits.put(b, 1)
                pending, run = [], 0
            if run or pending:
                bits.put(*ac_codes[0x00])
                for b in pending:
                    bits.put(b, 1)
    segments.append(bits)
    return segments


# T.81 Table D.2 as libjpeg's jaricom.c holds it: (Qe, next state after an
# LPS, after an MPS, whether an LPS switches the MPS sense) of each state;
# state 113 is the fixed estimate of 0.5 (T.851) for signs and refinement bits.
ARITH_TABLE = (
    (0x5A1D, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0), (0x080B, 18, 4, 0),
    (0x03D8, 20, 5, 0), (0x01DA, 23, 6, 0), (0x00E5, 25, 7, 0), (0x006F, 28, 8, 0),
    (0x0036, 30, 9, 0), (0x001A, 33, 10, 0), (0x000D, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5A7F, 15, 15, 1), (0x3F25, 36, 16, 0),
    (0x2CF2, 38, 17, 0), (0x207C, 39, 18, 0), (0x17B9, 40, 19, 0), (0x1182, 42, 20, 0),
    (0x0CEF, 43, 21, 0), (0x09A1, 45, 22, 0), (0x072F, 46, 23, 0), (0x055C, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0), (0x01B1, 54, 28, 0),
    (0x0144, 56, 29, 0), (0x00F5, 57, 30, 0), (0x00B7, 59, 31, 0), (0x008A, 60, 32, 0),
    (0x0068, 62, 33, 0), (0x004E, 63, 34, 0), (0x003B, 32, 35, 0), (0x002C, 33, 9, 0),
    (0x5AE1, 37, 37, 1), (0x484C, 64, 38, 0), (0x3A0D, 65, 39, 0), (0x2EF1, 67, 40, 0),
    (0x261F, 68, 41, 0), (0x1F33, 69, 42, 0), (0x19A8, 70, 43, 0), (0x1518, 72, 44, 0),
    (0x1177, 73, 45, 0), (0x0E74, 74, 46, 0), (0x0BFB, 75, 47, 0), (0x09F8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05CD, 48, 51, 0), (0x04DE, 50, 52, 0),
    (0x040F, 50, 53, 0), (0x0363, 51, 54, 0), (0x02D4, 52, 55, 0), (0x025C, 53, 56, 0),
    (0x01F8, 54, 57, 0), (0x01A4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00F6, 58, 61, 0), (0x00CB, 59, 62, 0), (0x00AB, 61, 63, 0), (0x008F, 61, 32, 0),
    (0x5B12, 65, 65, 1), (0x4D04, 80, 66, 0), (0x412C, 81, 67, 0), (0x37D8, 82, 68, 0),
    (0x2FE8, 83, 69, 0), (0x293C, 84, 70, 0), (0x2379, 86, 71, 0), (0x1EDF, 87, 72, 0),
    (0x1AA9, 87, 73, 0), (0x174E, 72, 74, 0), (0x1424, 72, 75, 0), (0x119C, 74, 76, 0),
    (0x0F6B, 74, 77, 0), (0x0D51, 75, 78, 0), (0x0BB6, 77, 79, 0), (0x0A40, 77, 48, 0),
    (0x5832, 80, 81, 1), (0x4D1C, 88, 82, 0), (0x438E, 89, 83, 0), (0x3BDD, 90, 84, 0),
    (0x34EE, 91, 85, 0), (0x2EAE, 92, 86, 0), (0x299A, 93, 87, 0), (0x2516, 86, 71, 0),
    (0x5570, 88, 89, 1), (0x4CA9, 95, 90, 0), (0x44D9, 96, 91, 0), (0x3E22, 97, 92, 0),
    (0x3824, 99, 93, 0), (0x32B4, 99, 94, 0), (0x2E17, 93, 86, 0), (0x56A8, 95, 96, 1),
    (0x4F46, 101, 97, 0), (0x47E5, 102, 98, 0), (0x41CF, 103, 99, 0), (0x3C3D, 104, 100, 0),
    (0x375E, 99, 93, 0), (0x5231, 105, 102, 0), (0x4C0F, 106, 103, 0), (0x4639, 107, 104, 0),
    (0x415E, 103, 99, 0), (0x5627, 105, 106, 1), (0x50E7, 108, 107, 0), (0x4B85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504F, 111, 107, 0), (0x5A10, 110, 111, 1), (0x5522, 112, 109, 0),
    (0x59EB, 112, 111, 1), (0x5A1D, 113, 113, 0))
_QE = [q for q, _, _, _ in ARITH_TABLE]
_NEXT_LPS = [n | (s << 7) for _, n, _, s in ARITH_TABLE]
_NEXT_MPS = [n for _, _, n, _ in ARITH_TABLE]


class _ArithEncoder:
    """libjpeg's jcarith.c coder (T.81 Annex D): arith_encode and
    finish_pass, its output already byte-stuffed, trailing zero bytes
    dropped as libjpeg drops them. A statistics bin is one byte: the state
    index in bits 0-6, the MPS in bit 7."""

    def __init__(self):
        self.out = bytearray()
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = 0, 0x10000, 0, 0, 11, -1

    def _zeros(self):
        self.out += b"\x00" * self.zc
        self.zc = 0

    def _byte(self, v: int):
        self.out.append(v)
        if v == 0xFF:
            self.out.append(0)

    def _settle(self):
        """A byte below 0xFF is done: the buffered byte and any stacked 0xFF
        bytes can no longer carry."""
        if self.buffer == 0:
            self.zc += 1
        elif self.buffer >= 0:
            self._zeros()
            self._byte(self.buffer)
        if self.sc:
            self._zeros()
            self.out += b"\xff\x00" * self.sc
            self.sc = 0

    def _carry(self):
        if self.buffer >= 0:
            self._zeros()
            self._byte(self.buffer + 1)
        self.zc += self.sc
        self.sc = 0

    def encode(self, st: bytearray, i: int, val: int):
        sv = st[i]
        s = sv & 0x7F
        qe = _QE[s]
        self.a -= qe
        if val != sv >> 7:
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ _NEXT_LPS[s]
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ _NEXT_MPS[s]
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    self._carry()
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    self._settle()
                    self.buffer = temp
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                return

    def finish(self) -> bytes:
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            self._carry()
        else:
            self._settle()
        if self.c & 0x7FFF800:
            self._zeros()
            self._byte((self.c >> 19) & 0xFF)
            if self.c & 0x7F800:
                self._byte((self.c >> 11) & 0xFF)
        return bytes(self.out)


def _arith_scan(units, blocks, comps, ss, se, ah, al, restart_interval, dac) -> bytes:
    """One scan coded as libjpeg's jcarith.c codes it (sequential when
    `ss, se, ah, al` are 0, 63, 0, 0, else the progressive scan they name):
    its entropy-coded data with its RSTn markers. `dac`
    maps a DAC table index to its value (DC tables 0-15: L in the low
    nibble, U in the high one; AC tables 16-31: Kx); component 0 codes with
    tables 0, the others with tables 1."""
    lower, upper, kx = [0] * 16, [1] * 16, [5] * 16
    for index, val in (dac or {}).items():
        if index < 16:
            lower[index], upper[index] = val & 15, val >> 4
        else:
            kx[index - 16] = val
    fixed = bytearray([113])

    def fresh():
        return (_ArithEncoder(), {t: bytearray(64) for t in (0, 1)},
                {t: bytearray(256) for t in (0, 1)}, {c: 0 for c in comps}, {c: 0 for c in comps})

    enc, dc_stats, ac_stats, last, ctx = fresh()

    def magnitude(st, i, v, k_of_x1):  # Figures F.8 / F.9 from bin i; v >= 1
        m, v = 0, v - 1
        if v:
            enc.encode(st, i, 1)
            m = 1
            v2 = v >> 1
            if k_of_x1 is None:  # DC: X1 = 20
                i = 20
                while v2:
                    enc.encode(st, i, 1)
                    m <<= 1
                    i += 1
                    v2 >>= 1
            elif v2:
                enc.encode(st, i, 1)
                m <<= 1
                i = k_of_x1
                v2 >>= 1
                while v2:
                    enc.encode(st, i, 1)
                    m <<= 1
                    i += 1
                    v2 >>= 1
        enc.encode(st, i, 0)
        return m, v, i

    def dc(c, v):
        t = min(c, 1)
        st, i = dc_stats[t], ctx[c]
        d = v - last[c]
        if d == 0:
            enc.encode(st, i, 0)
            ctx[c] = 0
            return
        last[c] = v
        enc.encode(st, i, 1)
        if d > 0:
            enc.encode(st, i + 1, 0)
            i, ctx[c] = i + 2, 4
        else:
            d = -d
            enc.encode(st, i + 1, 1)
            i, ctx[c] = i + 3, 8
        m, d, i = magnitude(st, i, d, None)
        if m < (1 << lower[t]) >> 1:
            ctx[c] = 0
        elif m > (1 << upper[t]) >> 1:
            ctx[c] += 8
        i += 14
        m >>= 1
        while m:
            enc.encode(st, i, 1 if m & d else 0)
            m >>= 1

    def ac(c, blk):
        t = min(c, 1)
        st = ac_stats[t]
        lo = max(ss, 1)
        vals = [0] * 64
        for k in range(lo, se + 1):
            v = blk[k]
            vals[k] = (v >> al) if v >= 0 else -((-v) >> al)
        ke = 0
        for k in range(se, 0, -1):
            if vals[k]:
                ke = k
                break
        if ah:
            kex = 0
            for k in range(ke, 0, -1):
                if abs(blk[k]) >> ah:
                    kex = k
                    break
        k = lo
        while k <= ke:
            i = 3 * (k - 1)
            if not ah or k > kex:
                enc.encode(st, i, 0)
            while True:
                v = vals[k]
                if v and ah and abs(v) >> 1:  # previously nonzero: its next bit
                    enc.encode(st, i + 2, abs(v) & 1)
                    break
                if v:
                    enc.encode(st, i + 1, 1)
                    enc.encode(fixed, 0, 0 if v > 0 else 1)
                    break
                enc.encode(st, i + 1, 0)
                i += 3
                k += 1
            if not ah:
                m, v, i = magnitude(st, i + 2, abs(vals[k]), 189 if k <= kx[t] else 217)
                i += 14
                m >>= 1
                while m:
                    enc.encode(st, i, 1 if m & v else 0)
                    m >>= 1
            k += 1
        if k <= se:
            enc.encode(st, 3 * (k - 1), 1)

    out, restarts = b"", 0
    for n, unit in enumerate(units):
        if restart_interval and n and n % restart_interval == 0:
            out += enc.finish() + bytes([0xFF, 0xD0 + restarts % 8])
            restarts += 1
            enc, dc_stats, ac_stats, last, ctx = fresh()
        for c, by, bx in unit:
            blk = [int(v) for v in blocks[c][by, bx]]
            if ss == 0 and ah == 0:
                dc(c, blk[0] >> al)
            elif ss == 0:
                enc.encode(fixed, 0, (blk[0] >> al) & 1)
            if se > 0:
                ac(c, blk)
    return out + enc.finish()


def jpeg_bytes(samples: np.ndarray, sampling: Sequence[Tuple[int, int]], quality: int = 90,
               adobe_transform: Optional[int] = None, ids: Optional[Sequence[int]] = None,
               jfif: Optional[bool] = None, restart_interval: int = 0,
               scans: Optional[Sequence] = None, arithmetic: bool = False,
               dac: Optional[dict] = None) -> bytes:
    """uint8 [H, W] or [H, W, C] samples, already in the coded colour space
    (C = 1, 3 or 4) -> JPEG bytes with `sampling[c] = (h, v)` for component
    c. Components take ids 1..C unless `ids` says otherwise; component 0
    takes the luma tables, the others the chroma ones. A JFIF APP0 is
    written for 1 or 3 components without an Adobe marker, unless `jfif`
    says otherwise. `restart_interval` > 0 writes a DRI and an RSTn marker
    after every that many MCUs (or blocks, in a one-component scan).
    `scans` makes it progressive (SOF2): (components, Ss, Se, Ah, Al) of
    each scan, such as `PROGRESSIVE_3` or the first few of its scans (a
    file that leaves coefficients unsent or unrefined); else one baseline
    (SOF0) scan of every component. `arithmetic` codes the scans as
    libjpeg's jcarith.c does (SOF9, or SOF10 with `scans`; no DHT), with
    `dac` ({table index: value}, see `_arith_scan`) written as a DAC
    segment and used by the coder."""
    samples = np.asarray(samples, np.uint8)
    if samples.ndim == 2:
        samples = samples[:, :, None]
    height, width, nc = samples.shape
    assert nc in (1, 3, 4) and len(sampling) == nc
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    pad_h, pad_w = mcuy * 8 * vmax, mcux * 8 * hmax
    full = np.pad(samples, ((0, pad_h - height), (0, pad_w - width), (0, 0)), mode="edge")
    quant = [_scaled_quant(LUMA_Q, quality), _scaled_quant(CHROMA_Q, quality)]
    dct = _dct_matrix()
    blocks, dims = [], []  # per component: [bh, bw, 64] quantised coefficients in zigzag order
    for c, (h, v) in enumerate(sampling):
        fy, fx = vmax // v, hmax // h
        assert vmax % v == 0 and hmax % h == 0
        plane = full[:, :, c].astype(np.float64)
        plane = plane.reshape(pad_h // fy, fy, pad_w // fx, fx).mean(axis=(1, 3))
        bh, bw = plane.shape[0] // 8, plane.shape[1] // 8
        b = (plane - 128).reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
        coef = dct @ b @ dct.T
        q = quant[min(c, 1)].reshape(8, 8)
        blocks.append(np.round(coef / q).astype(np.int64).reshape(bh, bw, 64)[:, :, ZIGZAG])
    ids = list(ids) if ids is not None else list(range(1, nc + 1))
    head = b""
    if jfif if jfif is not None else (adobe_transform is None and nc in (1, 3)):
        head += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    if adobe_transform is not None:
        head += _segment(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0, adobe_transform))
    for t, q in enumerate(quant[:1 if nc == 1 else 2]):
        head += _segment(0xDB, bytes([t]) + bytes(q[ZIGZAG].astype(np.uint8)))
    comps = [(ids[c], h, v, min(c, 1)) for c, (h, v) in enumerate(sampling)]
    return _jpeg_stream(head, height, width, comps, blocks, restart_interval, scans, arithmetic,
                        dac)


def _segment(marker: int, payload: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(payload) + 2) + payload


def _jpeg_stream(head: bytes, height: int, width: int, comps, blocks, restart_interval: int,
                 scans, arithmetic: bool, dac) -> bytes:
    """SOI, `head` (APPn / DQT segments), the frame of `comps` = (id, h, v,
    quantisation table) and the scans of the quantised `blocks` (per
    component [blocks down, blocks across, 64] in zigzag order over whole
    MCUs), then EOI: Huffman-coded with Annex K's tables (component 0 the
    luma ones) or arithmetic-coded; one sequential scan of every component
    unless `scans` gives a progressive script."""
    nc = len(comps)
    sampling = [(h, v) for _, h, v, _ in comps]
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    dims = [(-(-(-(-height * v // vmax)) // 8), -(-(-(-width * h // hmax)) // 8))
            for h, v in sampling]
    tables = [(_huffman_codes(DC_LUMA), _huffman_codes(AC_LUMA)),
              (_huffman_codes(DC_CHROMA), _huffman_codes(AC_CHROMA))]
    script = [(tuple(range(nc)), 0, 63, 0, 0)] if scans is None else list(scans)
    sof = (0xC9 if scans is None else 0xCA) if arithmetic else (0xC0 if scans is None else 0xC2)
    out = b"\xff\xd8" + head + _segment(sof, struct.pack(">BHHB", 8, height, width, nc) + b"".join(
        bytes([cid, (h << 4) | v, tq]) for cid, h, v, tq in comps))
    if arithmetic:
        if dac:
            out += _segment(0xCC, b"".join(bytes([i, v]) for i, v in dac.items()))
    else:
        for t, (dc, ac) in enumerate([(DC_LUMA, AC_LUMA), (DC_CHROMA, AC_CHROMA)][:1 if nc == 1
                                                                                else 2]):
            out += _segment(0xC4, bytes([t]) + bytes(dc[0]) + bytes(dc[1]))
            out += _segment(0xC4, bytes([0x10 | t]) + bytes(ac[0]) + bytes(ac[1]))
    if restart_interval:
        out += _segment(0xDD, struct.pack(">H", restart_interval))
    for sc, ss, se, ah, al in script:
        out += _segment(0xDA, bytes([len(sc)]) + b"".join(
            bytes([comps[c][0], 0x11 * min(c, 1)]) for c in sc) + bytes([ss, se, (ah << 4) | al]))
        units = _mcu_blocks(sc, sampling, mcux, mcuy, dims)
        if arithmetic:
            out += _arith_scan(units, blocks, sc, ss, se, ah, al, restart_interval, dac)
            continue
        for n, bits in enumerate(_encode_scan(units, blocks, sc, ss, se, ah, al, tables,
                                              restart_interval)):
            if n:
                out += bytes([0xFF, 0xD0 + (n - 1) % 8])
            out += bits.packed(1).replace(b"\xff", b"\xff\x00")
    return out + b"\xff\xd9"


def jpeg_coefficients(blob: bytes):
    """A sequential Huffman JPEG (SOF0 / SOF1, one or more scans, restart
    intervals), such as PIL writes -> (its APPn, COM and DQT segments as
    they are, height, width, the frame's components (id, h, v, quantisation
    table), the quantised coefficients of each component: [blocks down,
    blocks across, 64] in zigzag order over whole MCUs). A plain Huffman
    decoder in Python, for transcoding; it reads no damaged file."""
    head, pos, huff, restart, comps, blocks = b"", 2, {}, 0, None, None
    height = width = mcux = mcuy = 0
    while True:
        marker = blob[pos + 1]
        if marker == 0xD9:
            return head, height, width, comps, blocks
        n = struct.unpack_from(">H", blob, pos + 2)[0]
        body = blob[pos + 4:pos + 2 + n]
        pos += 2 + n
        if marker in (0xC0, 0xC1):
            height, width = struct.unpack_from(">HH", body, 1)
            comps = [(body[6 + 3 * i], body[7 + 3 * i] >> 4, body[7 + 3 * i] & 15, body[8 + 3 * i])
                     for i in range(body[5])]
            hmax, vmax = max(c[1] for c in comps), max(c[2] for c in comps)
            mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
            blocks = [np.zeros((mcuy * v, mcux * h, 64), np.int64) for _, h, v, _ in comps]
        elif marker == 0xC4:
            while body:
                counts, k, codes = body[1:17], 17, {}
                code = 0
                for length, count in enumerate(counts, start=1):
                    for _ in range(count):
                        codes[(length, code)] = body[k]
                        code += 1
                        k += 1
                    code <<= 1
                huff[body[0]] = codes
                body = body[k:]
        elif marker == 0xDD:
            restart = struct.unpack(">H", body)[0]
        elif marker == 0xDA:
            sc = [next(i for i, c in enumerate(comps) if c[0] == body[1 + 2 * j])
                  for j in range(body[0])]
            sel = [body[2 + 2 * j] for j in range(body[0])]
            end = pos  # the data runs to the first marker other than FF 00 or RSTn
            while blob[end] != 0xFF or blob[end + 1] == 0 or 0xD0 <= blob[end + 1] <= 0xD7:
                end += 1
            data = blob[pos:end]
            pos = end
            _huffman_scan(data, sc, sel, comps, blocks, huff, restart, mcux, mcuy, height, width)
        else:
            head += blob[pos - 2 - n:pos]


def _huffman_scan(data, sc, sel, comps, blocks, huff, restart, mcux, mcuy, height, width):
    segments = [s.replace(b"\xff\x00", b"\xff") for s in
                re.split(b"\xff[\xd0-\xd7]", data)]
    hmax, vmax = max(c[1] for c in comps), max(c[2] for c in comps)
    if len(sc) == 1:
        _, h, v, _ = comps[sc[0]]
        down = -(-(-(-height * v // vmax)) // 8)
        across = -(-(-(-width * h // hmax)) // 8)
        units = [[(sc[0], by, bx)] for by in range(down) for bx in range(across)]
    else:
        units = [[(c, my * comps[c][2] + by, mx * comps[c][1] + bx) for c in sc
                  for by in range(comps[c][2]) for bx in range(comps[c][1])]
                 for my in range(mcuy) for mx in range(mcux)]
    seg, bits, at, pred = 0, None, 0, {}

    def bit():
        nonlocal at
        b = (bits[at >> 3] >> (7 - (at & 7))) & 1
        at += 1
        return b

    def symbol(codes):
        code = length = 0
        while (length, code) not in codes:
            code = (code << 1) | bit()
            length += 1
        return codes[(length, code)]

    def value(s):
        v = 0
        for _ in range(s):
            v = (v << 1) | bit()
        return v - (1 << s) + 1 if s and v < 1 << (s - 1) else v

    for n, unit in enumerate(units):
        if n == 0 or (restart and n % restart == 0):
            bits, at, pred = segments[seg], 0, {c: 0 for c in sc}
            seg += 1
        for c, by, bx in unit:
            td, ta = sel[sc.index(c)] >> 4, sel[sc.index(c)] & 15
            pred[c] += value(symbol(huff[td]))
            blk = blocks[c][by, bx]
            blk[0] = pred[c]
            k = 1
            while k < 64:
                rs = symbol(huff[0x10 | ta])
                if rs == 0:
                    break
                k += rs >> 4
                if rs & 15:
                    blk[k] = value(rs & 15)
                k += 1


def jpeg_transcode(blob: bytes, scans: Optional[Sequence] = None, restart_interval: int = 0,
                   dac: Optional[dict] = None) -> bytes:
    """A sequential Huffman JPEG (PIL's) rewritten coefficient for
    coefficient, as `jpegtran -arithmetic` rewrites it: its APPn / COM /
    DQT segments kept, its frame and coefficients arithmetic-coded by
    `_jpeg_stream` (progressive under `scans`; `restart_interval`, `dac`).
    Its decode equals the source's: the coefficients are the same."""
    head, height, width, comps, blocks = jpeg_coefficients(blob)
    return _jpeg_stream(head, height, width, comps, blocks, restart_interval, scans, True, dac)


# Lossless JPEG's difference table: Annex K's luminance DC code lengths for
# categories 0-11, then 12-16 at 12 bits (16: a difference of 32768).
LOSSLESS_TABLE = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 5, 0, 0, 0, 0], list(range(17)))


def _lossless_predict(rows: np.ndarray, predictor: int, initial: int) -> np.ndarray:
    """The predictions of lossless JPEG (H.1.2.1) for int rows [n, w] of one
    component, row 0 the first of a scan or restart interval: predictor 1-7
    from Ra (left), Rb (above) and Rc (above left); the first row takes Ra
    and its first sample `initial`; a later row's first sample takes Rb."""
    x = rows.astype(np.int64)
    p = np.zeros_like(x)
    for r in range(x.shape[0]):
        if r == 0:
            p[r, 0] = initial
            p[r, 1:] = x[r, :-1]
            continue
        ra, rb = x[r, :-1], x[r - 1, 1:]
        rc = x[r - 1, :-1]
        p[r, 0] = x[r - 1, 0]
        p[r, 1:] = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
                    6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[predictor]
    return p


def jpeg_lossless_bytes(samples: np.ndarray, predictor: int = 1, point_transform: int = 0,
                        sampling: Optional[Sequence[Tuple[int, int]]] = None,
                        restart_interval: int = 0, jfif: bool = False,
                        adobe_transform: Optional[int] = None, ids: Optional[Sequence[int]] = None,
                        separate: bool = False, precision: int = 8) -> bytes:
    """uint8 [H, W] or [H, W, C] samples -> a lossless JPEG (SOF3, Huffman):
    `predictor` 1-7 (Ss), `point_transform` Pt (Al: the samples shifted
    right by it), `sampling[c] = (h, v)` (a subsampled component is the
    rounded box mean of the samples), `restart_interval` in MCUs (a
    multiple of an MCU row's MCUs, as libjpeg wants), one interleaved scan
    or, with `separate`, a scan per component; no JFIF APP0 unless `jfif`
    (libjpeg-turbo then takes three components as YCbCr, which it will not
    convert), an Adobe APP14 under `adobe_transform`. Every component codes
    with DHT table 0, `LOSSLESS_TABLE`."""
    samples = np.asarray(samples, np.uint8)
    if samples.ndim == 2:
        samples = samples[:, :, None]
    height, width, nc = samples.shape
    sampling = list(sampling or [(1, 1)] * nc)
    ids = list(ids) if ids is not None else list(range(1, nc + 1))
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    mcux, mcuy = -(-width // hmax), -(-height // vmax)
    codes = _huffman_codes(LOSSLESS_TABLE)
    initial = 1 << (precision - point_transform - 1)
    diffs = []  # per component: [rows, cols] differences over whole MCUs
    for c, (h, v) in enumerate(sampling):
        fy, fx = vmax // v, hmax // h
        full = np.pad(samples[:, :, c].astype(np.float64),
                      ((0, -height % fy), (0, -width % fx)), mode="edge")
        plane = np.round(full.reshape(full.shape[0] // fy, fy, full.shape[1] // fx, fx)
                         .mean(axis=(1, 3))).astype(np.int64) >> point_transform
        rows_per = v if not separate else 1
        unit_rows = (restart_interval // (mcux if not separate else plane.shape[1])) * rows_per \
            if restart_interval else plane.shape[0]
        d = np.zeros((mcuy * v, mcux * h), np.int64)
        for r0 in range(0, plane.shape[0], unit_rows):
            part = plane[r0:r0 + unit_rows]
            d[r0:r0 + part.shape[0], :plane.shape[1]] = part - _lossless_predict(
                part, predictor, initial)
        diffs.append(d if not separate else d[:plane.shape[0], :plane.shape[1]])
    out = b"\xff\xd8"
    if jfif:
        out += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    if adobe_transform is not None:
        out += _segment(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0, adobe_transform))
    out += _segment(0xC3, struct.pack(">BHHB", precision, height, width, nc) + b"".join(
        bytes([ids[c], (h << 4) | v, 0]) for c, (h, v) in enumerate(sampling)))
    out += _segment(0xC4, bytes([0]) + bytes(LOSSLESS_TABLE[0]) + bytes(LOSSLESS_TABLE[1]))
    if restart_interval:
        out += _segment(0xDD, struct.pack(">H", restart_interval))
    for sc in ([[c] for c in range(nc)] if separate else [list(range(nc))]):
        out += _segment(0xDA, bytes([len(sc)]) + b"".join(bytes([ids[c], 0]) for c in sc)
                        + bytes([predictor, 0, point_transform]))
        if separate:
            values = diffs[sc[0]].reshape(-1)
        else:
            mcus = []
            for c in sc:
                h, v = sampling[c]
                d = diffs[c].reshape(mcuy, v, mcux, h).transpose(0, 2, 1, 3).reshape(
                    mcuy * mcux, v * h)
                mcus.append(d)
            values = np.concatenate(mcus, axis=1).reshape(-1)
        bits, n = _Bits(), 0
        samples_per_mcu = 1 if separate else sum(h * v for h, v in (sampling[c] for c in sc))
        for i, dv in enumerate(values.tolist()):
            if restart_interval and i and i % (restart_interval * samples_per_mcu) == 0:
                out += bits.packed(1).replace(b"\xff", b"\xff\x00")
                out += bytes([0xFF, 0xD0 + n % 8])
                n += 1
                bits = _Bits()
            size, extra = _magnitude(dv)
            bits.put(*codes[size])
            if size < 16:
                bits.put(extra, size)
        out += bits.packed(1).replace(b"\xff", b"\xff\x00")
    return out + b"\xff\xd9"


def _chunk(tag: bytes, data: bytes, crc: Optional[int] = None) -> bytes:
    crc = zlib.crc32(tag + data) & 0xFFFFFFFF if crc is None else crc
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", crc)


def _pack_rows(samples: np.ndarray, bits: int) -> np.ndarray:
    """[h, w, c] sample values -> [h, row bytes] packed as PNG stores them."""
    h, w, c = samples.shape
    if bits == 16:
        return np.ascontiguousarray(samples, ">u2").view(np.uint8).reshape(h, w * c * 2)
    if bits == 8:
        return samples.astype(np.uint8).reshape(h, w * c)
    vals = samples.reshape(h, w * c).astype(np.uint8)
    per = 8 // bits
    vals = np.pad(vals, ((0, 0), (0, -vals.shape[1] % per)))
    shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
    return np.bitwise_or.reduce(vals.reshape(h, -1, per) << shifts, axis=2).astype(np.uint8)


def _filtered(rows: np.ndarray, bpp: int, ftype: int) -> bytes:
    h, n = rows.shape
    x = rows.astype(np.int32)
    up = np.concatenate([np.zeros((1, n), np.int32), x[:-1]])
    left = np.concatenate([np.zeros((h, bpp), np.int32), x[:, :-bpp]], axis=1)[:, :n]
    upleft = np.concatenate([np.zeros((h, bpp), np.int32), up[:, :-bpp]], axis=1)[:, :n]
    pa, pb, pc = (np.abs(up - upleft), np.abs(left - upleft),
                  np.abs(left + up - 2 * upleft))
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    pred = {0: 0, 1: left, 2: up, 3: (left + up) // 2, 4: paeth}[ftype]
    out = np.empty((h, 1 + n), np.uint8)
    out[:, 0] = ftype
    out[:, 1:] = (x - pred) & 0xFF
    return out.tobytes()


ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


def png_bytes(samples: np.ndarray, bits: int, color_type: int, interlace: bool = False,
              filter_type: int = 0, palette: Optional[np.ndarray] = None,
              trns: Optional[bytes] = None, extra: Sequence[Tuple[bytes, bytes]] = (),
              bad_idat_crc: bool = False, idat_parts: int = 1) -> bytes:
    """[H, W] or [H, W, C] sample values (C by the colour type) -> PNG bytes
    at `bits` bits a sample. `palette`: [N, 3] uint8 for PLTE; `trns`: the
    tRNS payload; `extra`: more (tag, data) chunks before the image data;
    `bad_idat_crc` writes a wrong CRC after each IDAT; the image data is
    split over `idat_parts` IDAT chunks."""
    samples = np.asarray(samples)
    if samples.ndim == 2:
        samples = samples[:, :, None]
    h, w, c = samples.shape
    bpp = max(1, c * bits // 8)
    if interlace:
        raw = b"".join(_filtered(_pack_rows(samples[y0::dy, x0::dx], bits), bpp, filter_type)
                       for x0, y0, dx, dy in ADAM7 if samples[y0::dy, x0::dx].size)
    else:
        raw = _filtered(_pack_rows(samples, bits), bpp, filter_type)
    data = zlib.compress(raw, 9)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, bits, color_type, 0, 0, int(interlace)))
    for tag, payload in extra:
        out += _chunk(tag, payload)
    if palette is not None:
        out += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    step = -(-len(data) // idat_parts)
    for i in range(0, len(data), step):
        out += _chunk(b"IDAT", data[i:i + step], 0xDEADBEEF if bad_idat_crc else None)
    return out + _chunk(b"IEND", b"")


# ---- BMP ------------------------------------------------------------------------------

def _rle8(rows: np.ndarray) -> bytes:
    """Rows (file order) of 8-bit indices -> RLE8: runs of 3 or more encoded,
    the rest in absolute runs (padded to a word), an end of line each row."""
    out = bytearray()
    for row in rows:
        x, n = 0, len(row)
        while x < n:
            run = 1
            while x + run < n and run < 255 and row[x + run] == row[x]:
                run += 1
            if run >= 3 or n - x < 3:
                out += bytes([run, row[x]])
                x += run
                continue
            end = x
            while end < n and end - x < 255 and not (
                    end + 2 < n and row[end] == row[end + 1] == row[end + 2]):
                end += 1
            if end - x < 3:
                out += bytes([1, row[x]])
                x += 1
                continue
            out += bytes([0, end - x]) + bytes(row[x:end]) + (b"\x00" if (end - x) % 2 else b"")
            x = end
        out += b"\x00\x00"
    return bytes(out + b"\x00\x01")


def _rle4(rows: np.ndarray) -> bytes:
    """Rows of 4-bit indices -> RLE4: encoded runs of two alternating
    values, an end of line each row."""
    out = bytearray()
    for row in rows:
        x, n = 0, len(row)
        while x < n:
            a = row[x]
            b = row[x + 1] if x + 1 < n else 0
            run = 1
            while x + run < n and run < 255 and row[x + run] == (a if run % 2 == 0 else b):
                run += 1
            out += bytes([run, (a << 4) | b])
            x += run
        out += b"\x00\x00"
    return bytes(out + b"\x00\x01")


def bmp_bytes(pixels: np.ndarray, bits: int, palette: Optional[np.ndarray] = None,
              compression: int = 0, top_down: bool = False,
              masks: Optional[Sequence[int]] = None, header_size: int = 40) -> bytes:
    """A BMP of `pixels` (indices [H, W] at 1, 4 or 8 bits, [H, W, 3] RGB at
    16 or 24 bits, [H, W, 4] RGBA / RGBX at 32 bits). `compression` 0
    (BI_RGB), 1 (RLE8), 2 (RLE4) or 3 (BI_BITFIELDS, with `masks` r, g, b[,
    a]); 16-bit pixels are 5-5-5 under BI_RGB and follow the masks (5-6-5
    or 5-5-5) under BI_BITFIELDS."""
    pixels = np.asarray(pixels)
    h, w = pixels.shape[:2]
    rows = pixels[::-1] if not top_down else pixels
    if bits <= 8:
        idx = rows.astype(np.uint8)
        if compression == 1:
            data = _rle8(idx)
        elif compression == 2:
            data = _rle4(idx)
        else:
            per = 8 // bits
            vals = np.pad(idx, ((0, 0), (0, -w % per)))
            shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
            packed = np.bitwise_or.reduce(vals.reshape(h, -1, per) << shifts, axis=2)
            data = packed.astype(np.uint8)
    elif bits == 16:
        r, g, b = (rows[..., i].astype(np.uint16) for i in range(3))
        if masks is not None and masks[1] == 0x7E0:
            v = ((r >> 3) << 11) | ((g >> 2) << 5) | (b >> 3)
        else:
            v = ((r >> 3) << 10) | ((g >> 3) << 5) | (b >> 3)
        data = np.ascontiguousarray(v, "<u2").view(np.uint8).reshape(h, 2 * w)
    elif bits == 24:
        data = rows[..., ::-1].astype(np.uint8).reshape(h, 3 * w)
    else:  # 32: pixels RGBA, laid out by the masks (BGRA without them)
        masks = masks or (0xFF0000, 0xFF00, 0xFF, 0xFF000000)
        v = np.zeros((h, w), np.uint32)
        for ch, m in enumerate(masks):
            if m:
                shift = (m & -m).bit_length() - 1
                v |= rows[..., ch].astype(np.uint32) << np.uint32(shift)
        data = np.ascontiguousarray(v, "<u4").view(np.uint8).reshape(h, 4 * w)
    if compression in (1, 2):
        pixel_bytes = data
    else:
        stride = ((w * bits + 31) >> 3) & ~3
        pixel_bytes = np.pad(data, ((0, 0), (0, stride - data.shape[1]))).tobytes()
    pal = b""
    if palette is not None:
        pal = b"".join(bytes([b, g, r, 0]) for r, g, b in np.asarray(palette, np.uint8))
    mask_bytes = b""
    if compression == 3:
        ms = list(masks) + [0] * (4 - len(masks))
        if header_size == 40:
            mask_bytes = struct.pack("<III", *ms[:3])
    info = struct.pack("<iiHHIIiiII", w, -h if top_down else h, 1, bits, compression,
                       len(pixel_bytes), 2835, 2835, 0 if palette is None else len(palette), 0)
    if header_size > 40:
        ms = list(masks or (0, 0, 0, 0)) + [0] * 4
        info += struct.pack("<IIII", *ms[:4])
        info += b"\x00" * (header_size - 4 - len(info))
    header = struct.pack("<I", header_size) + info + mask_bytes
    offset = 14 + len(header) + len(pal)
    return (b"BM" + struct.pack("<IHHI", offset + len(pixel_bytes), 0, 0, offset) + header
            + pal + pixel_bytes)


# ---- TIFF -----------------------------------------------------------------------------

def lzw_encode(data: bytes) -> bytes:
    """TIFF LZW (libtiff's LZWEncode): Clear first, codes from the high bit,
    the code width widened once the next entry would not fit, Clear again
    when the table reaches 4094 entries, EOI last."""
    out = _Bits()
    table = {bytes([i]): i for i in range(256)}
    nxt, width = 258, 9
    out.put(256, width)
    w = b""
    for byte in data:
        wc = w + bytes([byte])
        if wc in table:
            w = wc
            continue
        out.put(table[w], width)
        table[wc] = nxt
        nxt += 1
        if nxt == 4094:
            out.put(256, width)
            table = {bytes([i]): i for i in range(256)}
            nxt, width = 258, 9
        elif nxt > (1 << width) - 1:
            width += 1
        w = bytes([byte])
    if w:
        out.put(table[w], width)
        nxt += 1
        if nxt > (1 << width) - 1 and width < 12:
            width += 1
    out.put(257, width)
    return out.packed(0)


def packbits_encode(data: bytes) -> bytes:
    """PackBits: runs of 3 or more as repeats, the rest as literals."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        run = 1
        while i + run < n and run < 128 and data[i + run] == data[i]:
            run += 1
        if run >= 3:
            out += bytes([257 - run, data[i]])
            i += run
            continue
        j = i
        while j < n and j - i < 128 and not (j + 2 < n and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def _difference(rows: np.ndarray, spp: int) -> np.ndarray:
    """Predictor 2 on [h, w * spp] samples: each sample minus the same
    channel's left neighbour, wrapping."""
    d = rows.copy()
    d[:, spp:] = rows[:, spp:] - rows[:, :-spp]
    return d


def _fp_difference(rows: np.ndarray, spp: int) -> np.ndarray:
    """Predictor 3 (libtiff's fpDiff) on [h, w * spp] samples: each row's
    bytes regrouped into planes, most significant byte first, then each
    byte minus the one `spp` bytes before it, wrapping. uint8 [h, row
    bytes]."""
    h, wc = rows.shape
    planes = rows.astype(rows.dtype.newbyteorder(">")).view(np.uint8).reshape(h, wc, -1)
    b = np.ascontiguousarray(planes.transpose(0, 2, 1)).reshape(h, -1)
    d = b.copy()
    d[:, spp:] = b[:, spp:] - b[:, :-spp]
    return d


_PREDICTED = (5, 8, 32946, 34925, 50000)  # the codecs libtiff runs a predictor under
_REVERSED = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def _split_jpeg(blob: bytes) -> Tuple[bytes, bytes]:
    """A whole JPEG -> (its DQT and DHT segments, the file without them)."""
    tables, rest, pos = b"", b"\xff\xd8", 2
    while blob[pos + 1] != 0xDA:
        n = 2 + struct.unpack_from(">H", blob, pos + 2)[0]
        if blob[pos + 1] in (0xDB, 0xC4):
            tables += blob[pos:pos + n]
        elif blob[pos + 1] != 0xE0:  # no JFIF marker inside a TIFF
            rest += blob[pos:pos + n]
        pos += n
    return tables, rest + blob[pos:]


def tiff_bytes(samples: np.ndarray, photometric: int, compression: int = 1,
               predictor: int = 1, byteorder: str = "<", extra_samples: Sequence[int] = (),
               rows_per_strip: Optional[int] = None, tags: Sequence[Tuple] = (),
               tile: Optional[Tuple[int, int]] = None, planar: int = 1, fill_order: int = 1,
               bits: Optional[int] = None, sample_format: Optional[int] = None,
               colormap: Optional[np.ndarray] = None, jpeg: Optional[dict] = None,
               ycbcr_subsampling: Optional[Tuple[int, int]] = None, bigtiff: bool = False,
               encoded: Optional[Sequence[bytes]] = None, zstd: Optional[dict] = None) -> bytes:
    """[H, W] or [H, W, C] samples -> a TIFF of one image.

    Samples are uint8 / uint16 / int16 / int32 / uint32 / float32, stored at
    their own width, or packed from the high bit at `bits` = 1, 2 or 4 (rows
    padded to a byte). Layout: strips of `rows_per_strip` rows, or `tile` =
    (width, length) tiles (edge tiles padded with zeros); `planar` 1
    (chunky) or 2 (each sample in a plane of its own, plane 0's strips or
    tiles first). `compression` 1 (none), 32773 (PackBits), 5 (LZW), 8 or
    32946 (Deflate), or 7 (JPEG: each strip or tile an abbreviated stream of
    `jpeg_bytes`, its tables in JPEGTables; `jpeg` = dict(sampling=...,
    quality=..., tables=False to keep the tables in every stream, subsampling=
    the YCbCrSubsampling tag to write or None, arithmetic=, dac=, scans=,
    restart_interval= as `jpeg_bytes` takes them, or lossless=`jpeg_lossless_bytes`'s
    keywords for a lossless stream)); JPEG samples are already in
    the coded colour space (YCbCr for photometric 6). `predictor` 2
    differences each row and 3 is libtiff's floating-point predictor (both
    applied only under LZW, Deflate, LZMA and ZSTD). `fill_order` 2 reverses the bits of
    every stored byte. `sample_format` writes SampleFormat (339), `colormap`
    ([3 * 2^bits] uint16 values) ColorMap (320); `tags` adds (tag, type,
    values) entries (type 7 takes bytes, type 5 (RATIONAL) numerator,
    denominator pairs flattened). `bits` = 12 packs two samples in three
    bytes. Compression 34925 is LZMA (an .xz stream, as libtiff writes it);
    50000 is ZSTD (one Zstandard frame a strip or tile, as libtiff writes
    it, with `zstd` = dict(level=..., window_log=..., ...) the compressor's
    parameters; it needs the `zstandard` package, which the card's machine
    lacks).
    `ycbcr_subsampling` = (h, v), for photometric 6 under any compression
    but JPEG, writes YCbCrSubsampling and stores the full-resolution YCbCr
    samples as the TIFF 6.0 layout wants them: chunky, data units of h x v
    luma samples then one Cb and one Cr (each the mean of its unit, the
    edge units' luma padded by repetition); separate, the chroma planes
    subsampled. `encoded` gives each strip's or tile's compressed bytes
    as they are (for codecs written elsewhere, such as CCITT). `bigtiff`
    writes BigTIFF (version 43, 8-byte offsets and counts, LONG8 offsets)."""
    samples = np.asarray(samples)
    if samples.ndim == 2:
        samples = samples[:, :, None]
    h, w, spp = samples.shape
    bits = bits or 8 * samples.itemsize
    dt = np.dtype(samples.dtype).newbyteorder(byteorder)
    tw, th = tile if tile else (w, rows_per_strip or h)
    planes = [samples[:, :, i:i + 1] for i in range(spp)] if planar == 2 else [samples]
    sub = ycbcr_subsampling if compression != 7 else None
    if sub and planar == 2:  # chroma planes subsampled (box means)
        planes = [planes[0]] + [_box_mean(p, *sub) for p in planes[1:]]
    jpeg = dict(jpeg or {})
    tables = None
    segments = []
    for plane in planes:
        n = plane.shape[2]
        ph = plane.shape[0]
        pth = th if plane is planes[0] or not (sub and planar == 2) else -(-th // sub[1])
        for y in range(0, ph, pth):
            for x in range(0, w, tw) if tile else (0,):
                block = plane[y:y + pth, x:x + tw]
                if tile:
                    block = np.pad(block, ((0, th - block.shape[0]), (0, tw - block.shape[1]),
                                           (0, 0)))
                if compression == 7:
                    sampling = jpeg.get("sampling", ((1, 1),) * n) if n == spp else ((1, 1),)
                    if jpeg.get("lossless") is not None:
                        whole = jpeg_lossless_bytes(block, sampling=sampling, **jpeg["lossless"])
                    else:
                        whole = jpeg_bytes(block, sampling, jpeg.get("quality", 90), jfif=False,
                                           arithmetic=jpeg.get("arithmetic", False),
                                           dac=jpeg.get("dac"), scans=jpeg.get("scans"),
                                           restart_interval=jpeg.get("restart_interval", 0))
                    tables, raw = _split_jpeg(whole)
                    segments.append(whole if jpeg.get("tables") is False else raw)
                    continue
                rows = block.reshape(block.shape[0], -1)
                if predictor == 2 and compression in _PREDICTED:  # the integer bits
                    ints = rows.view(np.dtype(f"u{rows.itemsize}"))
                    rows = _difference(ints, n).view(rows.dtype)
                if encoded is not None:
                    raw = encoded[len(segments)]
                elif predictor == 3 and compression in _PREDICTED:
                    raw = _fp_difference(rows, n).tobytes()
                elif sub and planar == 1:
                    raw = ycbcr_units(block, *sub).tobytes()
                elif bits == 12:
                    raw = _pack12(rows).tobytes()
                elif bits < 8:
                    raw = _pack_rows(rows[:, :, None], bits).tobytes()
                else:
                    raw = rows.astype(dt).tobytes()
                if encoded is not None:
                    pass
                elif compression == 5:
                    raw = lzw_encode(raw)
                elif compression in (8, 32946):
                    raw = zlib.compress(raw, 9)
                elif compression == 32773:
                    raw = packbits_encode(raw)
                elif compression == 34925:
                    raw = lzma.compress(raw)
                elif compression == 50000:  # needs the zstandard package
                    import zstandard

                    kw = dict(zstd or {})
                    params = zstandard.ZstdCompressionParameters.from_level(kw.pop("level", 3),
                                                                            **kw)
                    raw = zstandard.ZstdCompressor(compression_params=params).compress(raw)
                if fill_order == 2:
                    raw = _REVERSED[np.frombuffer(raw, np.uint8)].tobytes()
                segments.append(raw)
    entries = [(256, 4, [w]), (257, 4, [h]), (258, 3, [bits] * spp), (259, 3, [compression]),
               (262, 3, [photometric]), (277, 3, [spp]), (284, 3, [planar])]
    if tile:
        entries += [(322, 3, [tw]), (323, 3, [th]), (324, 4, None),
                    (325, 4, [len(s) for s in segments])]
    else:
        entries += [(273, 4, None), (278, 4, [th]), (279, 4, [len(s) for s in segments])]
    if fill_order != 1:
        entries.append((266, 3, [fill_order]))
    if predictor != 1:
        entries.append((317, 3, [predictor]))
    if colormap is not None:
        entries.append((320, 3, [int(v) for v in np.asarray(colormap).reshape(-1)]))
    if extra_samples:
        entries.append((338, 3, list(extra_samples)))
    if sample_format is not None:
        entries.append((339, 3, [sample_format] * spp))
    if compression == 7 and jpeg.get("tables") is not False:
        entries.append((347, 7, b"\xff\xd8" + tables + b"\xff\xd9"))
    if compression == 7 and jpeg.get("subsampling"):
        entries.append((530, 3, list(jpeg["subsampling"])))
    if sub:
        entries.append((530, 3, list(sub)))
    entries += list(tags)
    entries.sort(key=lambda e: e[0])
    if bigtiff:  # offsets and byte counts as LONG8
        entries = [(t, 16 if t in (273, 279, 324, 325) else typ, v) for t, typ, v in entries]
    fmt = {1: "B", 3: "H", 4: "I", 5: "I", 7: "B", 16: "Q"}
    word = 8 if bigtiff else 4  # the room for a value in an entry

    def packed(typ, vals):
        return bytes(vals) if typ == 7 else struct.pack(byteorder + fmt[typ] * len(vals), *vals)

    def count(typ, vals):
        return len(vals) // 2 if typ == 5 else len(vals)

    head_size = 16 if bigtiff else 8
    ifd_size = (8 + 20 * len(entries) + 8) if bigtiff else (2 + 12 * len(entries) + 4)
    pos = head_size + ifd_size
    blobs, values = [], {}
    for tag, typ, vals in entries:  # arrays too large for the entry go after the IFD
        if vals is not None and len(vals) * struct.calcsize(fmt[typ]) > word:
            values[tag] = pos
            blob = packed(typ, vals)
            blobs.append(blob + b"\x00" * (len(blob) % 2))
            pos += len(blobs[-1])
    offsets = []
    for s in segments:
        offsets.append(pos)
        pos += len(s)
    offset_tag = 324 if tile else 273
    offset_fmt = "Q" if bigtiff else "I"
    if len(offsets) * word > word:
        values[offset_tag] = pos
        blobs_tail = struct.pack(byteorder + offset_fmt * len(offsets), *offsets)
    else:
        blobs_tail = b""
    entry = "HHQQ" if bigtiff else "HHII"
    ifd = struct.pack(byteorder + ("Q" if bigtiff else "H"), len(entries))
    for tag, typ, vals in entries:
        vals = offsets if tag == offset_tag else vals
        if tag in values:
            ifd += struct.pack(byteorder + entry, tag, typ, count(typ, vals), values[tag])
        else:
            ifd += struct.pack(byteorder + entry[:3], tag, typ, count(typ, vals)) + packed(
                typ, vals).ljust(word, b"\x00")
    ifd += b"\x00" * word
    if bigtiff:
        head = (b"II+\x00" if byteorder == "<" else b"MM\x00+") + struct.pack(
            byteorder + "HHQ", 8, 0, 16)
    else:
        head = (b"II*\x00" if byteorder == "<" else b"MM\x00*") + struct.pack(byteorder + "I", 8)
    return head + ifd + b"".join(blobs) + b"".join(segments) + blobs_tail


def _box_mean(plane: np.ndarray, sh: int, sv: int) -> np.ndarray:
    """[H, W, 1] -> [ceil(H / sv), ceil(W / sh), 1] rounded means of sh x sv
    boxes (edge boxes padded by repetition)."""
    h, w = plane.shape[:2]
    p = np.pad(plane[..., 0].astype(np.float64), ((0, -h % sv), (0, -w % sh)), mode="edge")
    m = p.reshape(p.shape[0] // sv, sv, p.shape[1] // sh, sh).mean(axis=(1, 3))
    return np.round(m).astype(plane.dtype)[..., None]


def tiff_entries_bytes(entries: Sequence[Tuple], data: Sequence[bytes] = (),
                       byteorder: str = "<") -> bytes:
    """A classic TIFF of one directory with exactly `entries` = (tag, type,
    values) (type 3 SHORT, 4 LONG, 7 UNDEFINED bytes) and `data` blobs after
    it. A value given as ("data", k) or ("data", k, d) is the offset of blob
    k (plus d), filled in once the layout is known."""
    fmt = {3: "H", 4: "I", 7: "B"}
    entries = sorted(entries, key=lambda e: e[0])
    head = 8 + 2 + 12 * len(entries) + 4
    sizes = [len(v) * struct.calcsize(fmt[t]) for _, t, v in entries]
    values_size = sum(n + n % 2 for n in sizes if n > 4)
    starts, pos = [], head + values_size
    for blob in data:
        starts.append(pos)
        pos += len(blob)

    def resolve(v):
        return starts[v[1]] + (v[2] if len(v) > 2 else 0) if isinstance(v, tuple) else v

    ifd, values = struct.pack(byteorder + "H", len(entries)), b""
    for (tag, typ, vals), n in zip(entries, sizes):
        vals = [resolve(v) for v in vals]
        packed = bytes(vals) if typ == 7 else struct.pack(byteorder + fmt[typ] * len(vals), *vals)
        if n > 4:
            ifd += struct.pack(byteorder + "HHII", tag, typ, len(vals), head + len(values))
            values += packed + b"\x00" * (n % 2)
        else:
            ifd += struct.pack(byteorder + "HHI", tag, typ, len(vals)) + packed.ljust(4, b"\x00")
    top = (b"II*\x00" if byteorder == "<" else b"MM\x00*") + struct.pack(byteorder + "I", 8)
    return top + ifd + b"\x00" * 4 + values + b"".join(data)


def _jpeg_segments(blob: bytes):
    """A sequential JPEG -> ({DQT index: 64 bytes}, {(class, index): 16
    counts + values}, the entropy-coded data after SOS cut at its RST
    markers)."""
    qt, ht, pos = {}, {}, 2
    while blob[pos + 1] != 0xDA:
        n = struct.unpack_from(">H", blob, pos + 2)[0]
        seg = blob[pos + 4:pos + 2 + n]
        if blob[pos + 1] == 0xDB:
            while seg:
                qt[seg[0] & 15], seg = seg[1:65], seg[65:]
        elif blob[pos + 1] == 0xC4:
            while seg:
                count = 16 + sum(seg[1:17])
                ht[(seg[0] >> 4, seg[0] & 15)], seg = seg[1:1 + count], seg[1 + count:]
        pos += 2 + n
    pos += 2 + struct.unpack_from(">H", blob, pos + 2)[0]
    data = blob[pos:blob.rindex(b"\xff\xd9")]
    return qt, ht, re.split(b"\xff[\xd0-\xd7]", data)


def ojpeg_tiff_bytes(samples: np.ndarray, sampling: Sequence[Tuple[int, int]],
                     form: str = "interchange", photometric: int = 6, quality: int = 90,
                     rows_per_strip: Optional[int] = None,
                     subsampling: Optional[Tuple[int, int]] = None, strips: bool = False,
                     jpeg_proc: int = 1, restart: Optional[int] = None,
                     tags: Sequence[Tuple] = ()) -> bytes:
    """[H, W, 3] YCbCr (or [H, W] grey) samples -> an old-style JPEG TIFF
    (Compression 6) of one baseline stream of `jpeg_bytes` at `sampling`.

    `form` "interchange": JPEGInterchangeFormat / Length (513 / 514) point at
    the whole stream; `strips` also writes one strip holding it (as many
    writers did). `form` "tables": the stream's tables go into JPEGQTables,
    JPEGDCTables and JPEGACTables (519-521: one offset a component, component
    0 the luma tables), JPEGProc (512) = `jpeg_proc`, and the entropy-coded
    data into strips of `rows_per_strip` rows (whole MCU rows; the stream is
    coded with a restart interval of one strip, JPEGRestartInterval (515) =
    `restart` or that interval, and each strip is one interval without its
    RST marker). `subsampling` writes YCbCrSubsampling (530); `tags` adds
    (tag, type, values) entries (they replace the writer's own; values None
    leaves the tag out)."""
    samples = np.asarray(samples, np.uint8)
    h, w = samples.shape[:2]
    spp = 1 if samples.ndim == 2 else samples.shape[2]
    sv = max(v for _, v in sampling)
    hmax = max(f for f, _ in sampling)
    entries = {256: (4, [w]), 257: (4, [h]), 258: (3, [8] * spp), 259: (3, [6]),
               262: (3, [photometric]), 277: (3, [spp])}
    if subsampling:
        entries[530] = (3, list(subsampling))
    if form == "interchange":
        stream = jpeg_bytes(samples, sampling, quality)
        data = [stream]
        entries[513] = (4, [("data", 0)])
        entries[514] = (4, [len(stream)])
        if strips:
            entries.update({273: (4, [("data", 0)]), 278: (4, [h]), 279: (4, [len(stream)])})
    else:
        rows = rows_per_strip or h
        assert rows % (8 * sv) == 0 or rows >= h
        interval = -(-w // (8 * hmax)) * (-(-min(rows, h) // (8 * sv)))
        stream = jpeg_bytes(samples, sampling, quality, restart_interval=interval)
        qt, ht, parts = _jpeg_segments(stream)
        tables = [qt[0], qt.get(1, qt[0])]
        dc = [ht[(0, 0)], ht.get((0, 1), ht[(0, 0)])]
        ac = [ht[(1, 0)], ht.get((1, 1), ht[(1, 0)])]
        data = tables + dc + ac + parts
        n = len(parts)
        entries.update({
            512: (3, [jpeg_proc]), 515: (3, [interval if restart is None else restart]),
            519: (4, [("data", min(c, 1)) for c in range(spp)]),
            520: (4, [("data", 2 + min(c, 1)) for c in range(spp)]),
            521: (4, [("data", 4 + min(c, 1)) for c in range(spp)]),
            273: (4, [("data", 6 + i) for i in range(n)]), 278: (4, [rows]),
            279: (4, [len(p) for p in parts])})
    for tag, typ, vals in tags:
        entries[tag] = (typ, None if vals is None else list(vals))
    return tiff_entries_bytes([(t, typ, v) for t, (typ, v) in entries.items()
                               if v is not None], data)


def ycbcr_units(block: np.ndarray, sh: int, sv: int) -> np.ndarray:
    """[rows, W, 3] uint8 YCbCr -> the chunky data units of TIFF 6.0
    section 21: per unit the sh x sv luma samples by rows, then Cb and Cr."""
    rows, w = block.shape[:2]
    p = np.pad(block, ((0, -rows % sv), (0, -w % sh), (0, 0)), mode="edge")
    uy, ux = p.shape[0] // sv, p.shape[1] // sh
    luma = p[..., 0].reshape(uy, sv, ux, sh).transpose(0, 2, 1, 3).reshape(uy, ux, sv * sh)
    chroma = [_box_mean(p[..., c:c + 1], sh, sv)[..., 0] for c in (1, 2)]
    return np.concatenate([luma, chroma[0][..., None], chroma[1][..., None]], -1).astype(
        np.uint8)


def _pack12(rows: np.ndarray) -> np.ndarray:
    """[h, n] 12-bit values -> [h, ceil(1.5 n)] bytes, from the high bit."""
    v = rows.astype(np.uint16)
    if v.shape[1] % 2:
        v = np.pad(v, ((0, 0), (0, 1)))
    a, b = v[:, 0::2], v[:, 1::2]
    out = np.stack([a >> 4, ((a & 15) << 4) | (b >> 8), b & 255], -1).reshape(v.shape[0], -1)
    return out[:, :(rows.shape[1] * 3 + 1) // 2].astype(np.uint8)


# ---- TGA ------------------------------------------------------------------------------

def tga_rle(pixels: np.ndarray, max_packet: int = 128) -> bytes:
    """uint8 [n, bytes per pixel] -> TGA run-length packets: runs of two or
    more equal pixels as repeats, the rest as literals, at most `max_packet`
    pixels a packet."""
    n = len(pixels)
    out, i = bytearray(), 0
    same = np.all(pixels[1:] == pixels[:-1], axis=1) if n > 1 else np.zeros(0, bool)
    while i < n:
        run = 1
        while i + run < n and run < max_packet and same[i + run - 1]:
            run += 1
        if run >= 2:
            out += bytes([0x80 | (run - 1)]) + pixels[i].tobytes()
            i += run
            continue
        j = i + 1
        while j < n and j - i < max_packet and not (j + 1 < n and same[j]):
            j += 1
        out += bytes([j - i - 1]) + pixels[i:j].tobytes()
        i = j
    return bytes(out)


def tga_bytes(pixels: np.ndarray, image_type: int, depth: int,
              colormap: Optional[np.ndarray] = None, first_entry: int = 0, map_depth: int = 24,
              id_field: bytes = b"", top_down: bool = False, right_to_left: bool = False,
              rows_per_packet_run: Optional[int] = None, descriptor: int = 0,
              max_packet: int = 128) -> bytes:
    """Pixels as stored, uint8 [H, W, depth / 8] (display order, row 0 at the
    top; packed bits [H, row bytes] at depth 1) -> a TGA file of
    `image_type` 1/2/3 (9/10/11 run-length encoded). The colour map holds
    uint8 [n, map_depth / 8] entries after `first_entry`. Rows are stored
    bottom-up unless `top_down`, columns right to left when `right_to_left`.
    Run-length packets cross rows unless `rows_per_packet_run` = 1 (each row
    encoded alone); `descriptor` adds bits (alpha depth) to byte 17."""
    px = np.asarray(pixels, np.uint8)
    h = px.shape[0]
    w = px.shape[1] * (8 if depth == 1 else 1)
    if px.ndim == 2:
        px = px[:, :, None]
    if not top_down:
        px = px[::-1]
    if right_to_left:
        px = px[:, ::-1]
    cmap = np.zeros((0, map_depth // 8), np.uint8) if colormap is None else np.asarray(
        colormap, np.uint8)
    flags = descriptor | (0x20 if top_down else 0) | (0x10 if right_to_left else 0)
    head = struct.pack("<BBBHHBHHHHBB", len(id_field), int(colormap is not None), image_type,
                       first_entry, len(cmap), map_depth if colormap is not None else 0,
                       0, 0, w, h, depth, flags)
    if image_type & 8:
        if rows_per_packet_run == 1:
            data = b"".join(tga_rle(r, max_packet) for r in px)
        else:
            data = tga_rle(px.reshape(-1, px.shape[2]), max_packet)
    else:
        data = px.tobytes()
    return head + id_field + cmap.tobytes() + data


# ---- Netpbm and QOI -------------------------------------------------------------------

def pnm_bytes(values: np.ndarray, magic: bytes, maxval: Optional[int] = None,
              ascii_sep: bytes = b" ", header_sep: bytes = b"\n", comment: bytes = b"",
              scale: float = -1.0) -> bytes:
    """[H, W] or [H, W, 3] sample values -> a Netpbm file: P1 / P4 (bits, 1
    = black), P2 / P5 (grey), P3 / P6 (RGB) with `maxval` (binary samples
    one byte up to 255, else two, big-endian), or Pf (float32 grey, rows
    bottom-up, little-endian when `scale` < 0). `comment` goes after the
    magic as a `#` line."""
    v = np.asarray(values)
    h, w = v.shape[:2]
    head = magic + header_sep + (b"#" + comment + b"\n" if comment else b"")
    head += b"%d%s%d%s" % (w, header_sep, h, header_sep)
    if magic == b"Pf":
        head += repr(scale).encode() + b"\n"
        return head + np.ascontiguousarray(v[::-1], "<f4" if scale < 0 else ">f4").tobytes()
    if magic not in (b"P1", b"P4"):
        head += b"%d%s" % (maxval, header_sep)
    if magic in (b"P1", b"P2", b"P3"):
        return head + ascii_sep.join(b"%d" % x for x in v.reshape(-1)) + b"\n"
    if magic == b"P4":
        return head + np.packbits(v.astype(np.uint8), axis=1).tobytes()
    return head + v.astype(">u2" if maxval > 255 else np.uint8).tobytes()


def qoi_bytes(pixels: np.ndarray, channels: Optional[int] = None,
              ops: Sequence[str] = ("run", "index", "diff", "luma", "rgb", "rgba")) -> bytes:
    """uint8 [H, W, 3 or 4] -> a QOI file (header, the reference encoder's
    choice of ops among `ops`, the 8-byte end marker); `channels` is the
    header's count (the pixels' own by default)."""
    px = np.asarray(pixels, np.uint8)
    h, w, c = px.shape
    rgba = np.concatenate([px, np.full((h, w, 1), 255, np.uint8)], 2) if c == 3 else px
    out = bytearray(b"qoif" + struct.pack(">IIBB", w, h, channels or c, 0))
    index = [(0, 0, 0, 0)] * 64
    prev, run = (0, 0, 0, 255), 0
    flat = [tuple(int(x) for x in p) for p in rgba.reshape(-1, 4)]
    for i, p in enumerate(flat):
        if p == prev and "run" in ops:
            run += 1
            if run == 62 or i == len(flat) - 1:
                out.append(0xC0 | (run - 1))
                run = 0
            continue
        if run:
            out.append(0xC0 | (run - 1))
            run = 0
        slot = (p[0] * 3 + p[1] * 5 + p[2] * 7 + p[3] * 11) % 64
        if index[slot] == p and "index" in ops:
            out.append(slot)
        else:
            index[slot] = p
            dr, dg, db = ((p[k] - prev[k] + 128) % 256 - 128 for k in range(3))
            if p[3] == prev[3] and "diff" in ops and all(-2 <= d <= 1 for d in (dr, dg, db)):
                out.append(0x40 | (dr + 2) << 4 | (dg + 2) << 2 | (db + 2))
            elif (p[3] == prev[3] and "luma" in ops and -32 <= dg <= 31
                  and -8 <= dr - dg <= 7 and -8 <= db - dg <= 7):
                out += bytes([0x80 | (dg + 32), (dr - dg + 8) << 4 | (db - dg + 8)])
            elif p[3] == prev[3] and "rgb" in ops:
                out += bytes([0xFE, *p[:3]])
            else:
                out += bytes([0xFF, *p])
        prev = p
    return bytes(out) + b"\x00" * 7 + b"\x01"


# ---- GIF ------------------------------------------------------------------------------

def gif_lzw_encode(indices: bytes, min_code_size: int) -> bytes:
    """GIF LZW (codes from the least significant bit): a clear code first, the
    width grown as a decoder grows it, a clear code whenever the table fills,
    the end code last."""
    clear, end = 1 << min_code_size, (1 << min_code_size) + 1
    out, acc, have = bytearray(), 0, 0
    state = {}

    def emit(code):
        nonlocal acc, have
        acc |= code << have
        have += state["width"]
        while have >= 8:
            out.append(acc & 255)
            acc >>= 8
            have -= 8
        # the decoder's table after reading this code: an entry for each code
        # but the first after a clear, the width grown at 2**width - 1
        if code == clear:
            state.update(width=min_code_size + 1, dec_next=clear + 2, first=True)
        elif state["first"]:
            state["first"] = False
        elif state["dec_next"] < 4096:
            if state["dec_next"] == (1 << state["width"]) - 1 and state["width"] < 12:
                state["width"] += 1
            state["dec_next"] += 1

    state.update(width=min_code_size + 1)
    emit(clear)
    table, nxt, cur = {}, clear + 2, None
    for v in indices:
        if cur is None:
            cur = v
            continue
        if (cur, v) in table:
            cur = table[(cur, v)]
            continue
        emit(cur)
        table[(cur, v)] = nxt
        nxt += 1
        cur = v
        if nxt == 4096:
            emit(cur)
            emit(clear)
            table, nxt, cur = {}, clear + 2, None
    if cur is not None:
        emit(cur)
    emit(end)
    if have:
        out.append(acc & 255)
    return bytes(out)


def gif_bytes(indices: np.ndarray, palette: Optional[np.ndarray] = None,
              screen: Optional[Tuple[int, int]] = None, offset: Tuple[int, int] = (0, 0),
              local: bool = False, interlace: bool = False, transparency: Optional[int] = None,
              min_code_size: Optional[int] = None,
              screen_palette: Optional[np.ndarray] = None) -> bytes:
    """A GIF89a file of one image, uint8 [h, w] `indices`, at `offset` on a
    logical `screen` (width, height; the image's size by default).
    `palette` ([n, 3], n a power of two 2-256) goes in the global colour
    table, or in a local one when `local` (the global table then being
    `screen_palette`, or absent); no palette writes no table."""
    h, w = indices.shape
    sw, sh = screen or (offset[0] + w, offset[1] + h)

    def table(p):
        p = np.asarray(p, np.uint8).reshape(-1, 3)
        n = len(p)
        if n < 2 or n > 256 or n & (n - 1):
            raise ValueError(f"a GIF colour table holds 2-256 entries, a power of two; got {n}")
        return p.tobytes(), n.bit_length() - 2

    glob_table = screen_palette if local else palette
    out = bytearray(b"GIF89a" + struct.pack("<HH", sw, sh))
    if glob_table is not None:
        data, size = table(glob_table)
        out += bytes([0x80 | 0x70 | size, 0, 0]) + data
    else:
        out += bytes([0, 0, 0])
    if transparency is not None:
        out += b"\x21\xf9\x04" + bytes([1, 0, 0, transparency, 0])
    rows = np.asarray(indices, np.uint8)
    if interlace:
        rows = rows[np.concatenate([np.arange(s, h, d) for s, d in ((0, 8), (4, 8), (2, 4),
                                                                     (1, 2))])]
    flags = 0x40 if interlace else 0
    local_data = b""
    if local and palette is not None:
        local_data, size = table(palette)
        flags |= 0x80 | size
    out += b"\x2c" + struct.pack("<HHHH", offset[0], offset[1], w, h) + bytes([flags]) + local_data
    if min_code_size is None:
        min_code_size = max(2, int(rows.max()).bit_length())
    out.append(min_code_size)
    lzw = gif_lzw_encode(rows.tobytes(), min_code_size)
    for i in range(0, len(lzw), 255):
        out += bytes([len(lzw[i:i + 255])]) + lzw[i:i + 255]
    out += b"\x00\x3b"
    return bytes(out)


def zstd_frame(blocks: Sequence[Tuple], checksum: bool = False) -> bytes:
    """A Zstandard frame built by hand from `blocks`: ("raw", data), ("rle",
    byte, n), a compressed block of literals and no sequences,
    ("raw_literals", data) or ("rle_literals", byte, n), or one of raw
    literals and sequences through RLE tables, ("rle_sequences", literals,
    [(literal length < 16, offset value, match length 3-34), ...], all the
    offset values with one highest bit); a 128 KiB window, its
    content size in 4 bytes, the XXH64 checksum's low 32 bits when
    `checksum`."""
    def lit_header(kind: int, n: int) -> bytes:
        if n < 32:
            return bytes([kind | n << 3])
        if n < 4096:
            return bytes([kind | 1 << 2 | (n & 15) << 4, n >> 4])
        return bytes([kind | 3 << 2 | (n & 15) << 4, (n >> 4) & 255, n >> 12])

    content, body = bytearray(), bytearray()
    for i, blk in enumerate(blocks):
        last = int(i == len(blocks) - 1)
        if blk[0] == "raw":
            payload, size, kind = blk[1], len(blk[1]), 0
            content += blk[1]
        elif blk[0] == "rle":
            payload, size, kind = bytes([blk[1]]), blk[2], 1
            content += bytes([blk[1]]) * blk[2]
        elif blk[0] == "raw_literals":
            payload, kind = lit_header(0, len(blk[1])) + blk[1] + b"\x00", 2
            size = len(payload)
            content += blk[1]
        elif blk[0] == "rle_literals":
            payload, kind = lit_header(1, blk[2]) + bytes([blk[1], 0]), 2
            size = len(payload)
            content += bytes([blk[1]]) * blk[2]
        else:
            lits, seqs = blk[1], blk[2]
            of_code = seqs[0][1].bit_length() - 1
            value, nbits, lit = 1, 0, 0  # the bits in read order, under the end marker
            for ll, ofv, ml in seqs:
                value, nbits = value << of_code | (ofv - (1 << of_code)), nbits + of_code
                content += lits[lit:lit + ll]
                lit += ll
                for _ in range(ml):  # the match, byte by byte (it may overlap itself)
                    content.append(content[len(content) - (ofv - 3)])
            content += lits[lit:]
            stream = value.to_bytes((nbits + 8) // 8, "little")
            payload = (lit_header(0, len(lits)) + lits + bytes([len(seqs), 0x54, seqs[0][0],
                                                                  of_code, seqs[0][2] - 3]) + stream)
            size, kind = len(payload), 2
        body += (last | kind << 1 | size << 3).to_bytes(3, "little") + payload
    out = struct.pack("<IBB", 0xFD2FB528, 2 << 6 | int(checksum) << 2, (17 - 10) << 3)
    out += struct.pack("<I", len(content)) + body
    if checksum:
        from wast3d_tpu_torch.utils.zstd import xxh64

        out += struct.pack("<I", xxh64(bytes(content)) & 0xFFFFFFFF)
    return out


# ---- ICO / CUR -------------------------------------------------------------------------

def dib_bytes(pixels: np.ndarray, bits: int, and_mask: Optional[np.ndarray] = None,
              **bmp_kw) -> bytes:
    """An ICO or CUR entry's DIB: `bmp_bytes(pixels, bits, ...)` without its
    14-byte file header, its height doubled, the 1-bit AND mask after the
    pixels (`and_mask` [H, W] bool, True for a transparent pixel; rows
    bottom-up, padded to 32 bits; none given: all opaque)."""
    h, w = np.asarray(pixels).shape[:2]
    dib = bytearray(bmp_bytes(pixels, bits, **bmp_kw)[14:])
    if struct.unpack_from("<I", dib, 0)[0] == 12:
        struct.pack_into("<H", dib, 6, 2 * h)
    else:
        struct.pack_into("<i", dib, 8, -2 * h if bmp_kw.get("top_down") else 2 * h)
    mask = np.zeros((h, w), bool) if and_mask is None else np.asarray(and_mask, bool)
    packed = np.packbits(np.pad(mask[::-1], ((0, 0), (0, -w % 32))), axis=1)
    return bytes(dib) + packed.tobytes()


def icon_bytes(entries: Sequence[Tuple], cursor: bool = False) -> bytes:
    """An ICO (or, with `cursor`, a CUR) file of `entries`: (image bytes (a
    DIB of `dib_bytes` or a PNG), width, height, bits per pixel, colour
    count) each, for ICO; (image bytes, width, height, hotspot x, hotspot y)
    for CUR. A width or height of 256 is written as 0."""
    out = bytearray(struct.pack("<HHH", 0, 2 if cursor else 1, len(entries)))
    offset = 6 + 16 * len(entries)
    for blob, w, h, a, b in entries:
        if cursor:
            out += struct.pack("<BBBBHHII", w % 256, h % 256, 0, 0, a, b, len(blob), offset)
        else:
            out += struct.pack("<BBBBHHII", w % 256, h % 256, b % 256, 0, 1, a, len(blob), offset)
        offset += len(blob)
    return bytes(out) + b"".join(e[0] for e in entries)


# ---- Sun raster ------------------------------------------------------------------------

def sun_rle(data: bytes) -> bytes:
    """Sun's byte-encoded runs: 80 n v for n + 1 copies of v (2-256), 80 00
    for a lone 80, any other byte as itself."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        run = 1
        while i + run < n and run < 256 and data[i + run] == data[i]:
            run += 1
        if run >= 3 or (data[i] == 0x80 and run >= 2):
            out += bytes([0x80, run - 1, data[i]])
            i += run
        elif data[i] == 0x80:
            out += b"\x80\x00"
            i += 1
        else:
            out.append(data[i])
            i += 1
    return bytes(out)


def sun_bytes(pixels: np.ndarray, depth: int, file_type: int = 1,
              palette: Optional[np.ndarray] = None) -> bytes:
    """A Sun raster file: `pixels` [H, W] values at depth 1, 4 or 8 (a
    palette [n, 3] makes them colour-map indices), [H, W, 3] RGB at 24 or
    [H, W, 4] (the fourth byte written as is) at 32; `file_type` 1 (BGR
    order at 24 and 32 bits), 3 (RGB order) or 2 (byte-encoded: runs over
    the rows as PIL's decoder reads them, unpadded). Raw rows are padded to
    16 bits."""
    pixels = np.asarray(pixels, np.uint8)
    h, w = pixels.shape[:2]
    if depth < 8:
        rows = _pack_rows(pixels.reshape(h, w, 1), depth)
    elif depth == 8:
        rows = pixels.reshape(h, w)
    else:
        c = depth // 8
        px = pixels[..., :c]
        if file_type != 3:
            px = px[..., [2, 1, 0, 3][:c]]
        rows = px.reshape(h, w * c)
    if file_type == 2:
        data = sun_rle(np.ascontiguousarray(rows).tobytes())
    else:
        stride = ((w * depth + 15) // 16) * 2
        data = np.pad(rows, ((0, 0), (0, stride - rows.shape[1]))).tobytes()
    cmap = b""
    if palette is not None:
        p = np.asarray(palette, np.uint8).reshape(-1, 3)
        cmap = p[:, 0].tobytes() + p[:, 1].tobytes() + p[:, 2].tobytes()
    head = struct.pack(">8I", 0x59A66A95, w, h, depth, len(data), file_type, 1 if cmap else 0,
                       len(cmap))
    return head + cmap + data


# ---- PSD -------------------------------------------------------------------------------

PSD_MODES = {"1": 0, "L": 1, "P": 2, "RGB": 3, "CMYK": 4, "LAB": 9}


def psd_bytes(planes: np.ndarray, mode: str, compression: int = 1, bits: int = 8,
              palette: Optional[np.ndarray] = None, resources: bytes = b"") -> bytes:
    """A Photoshop file (version 1) of one merged image: `planes` [C, H, W]
    channels as stored (8-bit values, or 0 / 1 at `bits` 1, packed from the
    high bit; CMYK as Photoshop stores it, inverted), colour mode `mode`
    (a key of PSD_MODES or its number), raw (`compression` 0) or PackBits
    rows with their byte counts (1). `palette` [256, 3] fills the colour
    mode data of an indexed file; `resources` is the image resources
    section's content as given."""
    planes = np.asarray(planes, np.uint8)
    c, h, w = planes.shape
    if bits == 1:
        rows = np.packbits(planes.astype(bool), axis=2)
    else:
        rows = planes
    cmode = PSD_MODES.get(mode, mode)
    head = b"8BPS" + struct.pack(">H6xHIIHH", 1, c, h, w, bits, cmode)
    cdata = b"" if palette is None else np.asarray(palette, np.uint8).T.tobytes()
    out = bytearray(head + struct.pack(">I", len(cdata)) + cdata)
    out += struct.pack(">I", len(resources)) + resources + struct.pack(">I", 0)
    out += struct.pack(">H", compression)
    if compression == 0:
        out += rows.tobytes()
    else:
        coded = [packbits_encode(rows[i, y].tobytes()) for i in range(c) for y in range(h)]
        out += b"".join(struct.pack(">H", len(r)) for r in coded) + b"".join(coded)
    return bytes(out)


# ---- SGI -------------------------------------------------------------------------------

def _sgi_rle_row(values: np.ndarray) -> bytes:
    """One SGI row channel as runs (a count byte, or a 16-bit count word at 2
    bytes a sample: high bit set for a literal of count samples, else a
    repeat of the next sample), ending with a zero count."""
    wide = values.dtype.itemsize == 2
    vals = values.tolist()
    out, i, n = bytearray(), 0, len(vals)

    def sample(v):
        return struct.pack(">H", v) if wide else bytes([v])

    def count(k):
        return struct.pack(">H", k) if wide else bytes([k])

    while i < n:
        run = 1
        while i + run < n and run < 127 and vals[i + run] == vals[i]:
            run += 1
        if run >= 3:
            out += count(run) + sample(vals[i])
            i += run
            continue
        j = i
        while j < n and j - i < 127 and not (j + 2 < n and vals[j] == vals[j + 1] == vals[j + 2]):
            j += 1
        out += count(0x80 | (j - i)) + b"".join(sample(v) for v in vals[i:j])
        i = j
    return bytes(out + count(0))


def sgi_bytes(samples: np.ndarray, rle: bool = True) -> bytes:
    """An SGI image of uint8 (1 byte a sample) or uint16 (2) `samples` [H, W]
    or [H, W, C] (C 1, 3 or 4): verbatim planes, or (`rle`) one run-length
    row a channel with the start and length tables; rows bottom-up."""
    samples = np.asarray(samples)
    if samples.ndim == 2:
        samples = samples[..., None]
    h, w, c = samples.shape
    bpc = samples.dtype.itemsize
    dim = 2 if c == 1 else 3
    head = struct.pack(">HBBHHHHII4x80sII", 474, int(rle), bpc, dim, w, h, c, 0,
                       (1 << (8 * bpc)) - 1, b"", 0, 0).ljust(512, b"\x00")
    planes = samples[::-1].transpose(2, 0, 1).astype(f">u{bpc}")
    if not rle:
        return head + planes.tobytes()
    rows = [_sgi_rle_row(planes[ch, y].astype(samples.dtype)) for ch in range(c) for y in range(h)]
    starts, pos = [], 512 + 8 * h * c
    for r in rows:
        starts.append(pos)
        pos += len(r)
    return (head + struct.pack(f">{h * c}I", *starts)
            + struct.pack(f">{h * c}I", *[len(r) for r in rows]) + b"".join(rows))


# ---- PCX -------------------------------------------------------------------------------

def _pcx_rle(row: bytes) -> bytes:
    out, i, n = bytearray(), 0, len(row)
    while i < n:
        run = 1
        while i + run < n and run < 63 and row[i + run] == row[i]:
            run += 1
        if run > 1 or row[i] >= 0xC0:
            out += bytes([0xC0 | run, row[i]])
        else:
            out.append(row[i])
        i += run
    return bytes(out)


def pcx_bytes(pixels: np.ndarray, bits: int, planes: int, palette: Optional[np.ndarray] = None,
              version: int = 5, ega_palette: Optional[np.ndarray] = None,
              stride: Optional[int] = None) -> bytes:
    """A run-length PCX: `pixels` [H, W] values at `bits` 1 in 1, 2 or 4
    planes (a plane a bit) or 8 in 1 plane (an 8-bit `palette` [256, 3] goes
    after the data, behind 0C), or [H, W, 3] RGB at 8 bits in 3 planes; each
    plane's row padded to `stride` bytes (the even size by default) and each
    row's planes coded together, runs never crossing a row."""
    pixels = np.asarray(pixels, np.uint8)
    h, w = pixels.shape[:2]
    stride = stride or -(-((w * bits + 7) // 8) // 2) * 2
    if bits == 1:
        plane_rows = [np.packbits((pixels >> p) & 1, axis=1) for p in range(planes)]
    elif pixels.ndim == 3:
        plane_rows = [pixels[..., p] for p in range(planes)]
    else:
        plane_rows = [pixels]
    plane_rows = [np.pad(r, ((0, 0), (0, stride - r.shape[1]))) for r in plane_rows]
    data = b"".join(_pcx_rle(b"".join(r[y].tobytes() for r in plane_rows)) for y in range(h))
    ega = np.zeros(48, np.uint8) if ega_palette is None else np.asarray(ega_palette, np.uint8)
    head = (struct.pack("<BBBBHHHHHH", 10, version, 1, bits, 0, 0, w - 1, h - 1, 72, 72)
            + ega.reshape(-1)[:48].tobytes().ljust(48, b"\x00")
            + struct.pack("<BBHH", 0, planes, stride, 1)).ljust(128, b"\x00")
    tail = b"" if palette is None else b"\x0c" + np.asarray(palette, np.uint8).tobytes()
    return head + data + tail


# ---- DDS -------------------------------------------------------------------------------

DDS_FOURCC = {"DXT1", "DXT3", "DXT5", "BC4U", "ATI1", "BC5U", "ATI2", "BC5S", "DX10"}


def dds_bytes(width: int, height: int, payload: bytes, fourcc: Optional[str] = None,
              dxgi: Optional[int] = None, pf_flags: int = 0, bitcount: int = 0,
              masks: Sequence[int] = (0, 0, 0, 0), palette: Optional[bytes] = None) -> bytes:
    """A DirectDraw Surface around `payload` as given (BCn blocks, row by row
    of 4 x 4 blocks, or uncompressed pixels): a `fourcc` pixel format (with
    `dxgi`, the DX10 header and its DXGI format), or `pf_flags` (RGB 0x40,
    alpha pixels 0x1, luminance 0x20000, palette 0x20) with `bitcount` and
    `masks`; a palette file gets its 1024 `palette` bytes after the header."""
    if dxgi is not None:
        fourcc = "DX10"
    if fourcc is not None:
        pf_flags |= 4
    pf = struct.pack("<4I4I", 32, pf_flags, struct.unpack("<I", (fourcc or "\0\0\0\0").encode())[0],
                     bitcount, *(list(masks) + [0] * 4)[:4])
    head = struct.pack("<7I", 124, 0x1007, height, width, 0, 0, 0) + b"\x00" * 44 + pf
    head += struct.pack("<5I", 0x1000, 0, 0, 0, 0)
    dx10 = struct.pack("<5I", dxgi, 3, 0, 1, 0) if dxgi is not None else b""
    return b"DDS " + head + dx10 + (palette or b"") + payload


# ---- JPEG 2000 (through libopenjp2) ----------------------------------------------------

# Offsets into OpenJPEG 2.5's opj_cparameters_t (LP64), checked against the
# defaults opj_set_default_encoder_parameters writes (`_openjp2`).
_CP = {"tile_size_on": 0, "cp_tx0": 4, "cp_ty0": 8, "cp_tdx": 12, "cp_tdy": 16,
       "cp_disto_alloc": 20, "csty": 48, "prog_order": 52, "POC": 56, "numpocs": 4792,
       "tcp_numlayers": 4796, "tcp_rates": 4800, "numresolution": 5600, "cblockw_init": 5604,
       "cblockh_init": 5608, "mode": 5612, "irreversible": 5616, "roi_compno": 5620,
       "roi_shift": 5624, "res_spec": 5628, "prcw_init": 5632, "prch_init": 5764,
       "image_offset_x0": 18188, "image_offset_y0": 18192, "subsampling_dx": 18196,
       "decod_format": 18204, "cod_format": 18208, "tp_on": 18696, "tp_flag": 18697,
       "tcp_mct": 18698}
_POC_SIZE = 148  # opj_poc_t: resno0, compno0, layno1, resno1, compno1 at 0-16, prg1 at 32, tile at 48


def _openjp2():
    """PIL's bundled libopenjp2 (found without importing PIL), its
    functions' types declared and its parameter offsets checked."""
    import ctypes
    import glob
    import importlib.util
    import os

    spec = importlib.util.find_spec("PIL")
    site = os.path.dirname(os.path.dirname(spec.origin))
    found = sorted(glob.glob(os.path.join(site, "pillow.libs", "libopenjp2*.so*")))
    lib = ctypes.CDLL(found[0] if found else "libopenjp2.so.7")
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn, args, res in (("opj_set_default_encoder_parameters", [p], None),
                          ("opj_image_create", [ctypes.c_uint32, p, i], p),
                          ("opj_create_compress", [i], p), ("opj_setup_encoder", [p, p, p], i),
                          ("opj_stream_create_default_file_stream", [ctypes.c_char_p, i], p),
                          ("opj_start_compress", [p, p, p], i), ("opj_encode", [p, p], i),
                          ("opj_end_compress", [p, p], i), ("opj_stream_destroy", [p], None),
                          ("opj_destroy_codec", [p], None), ("opj_image_destroy", [p], None)):
        getattr(lib, fn).argtypes, getattr(lib, fn).restype = args, res
    params = (ctypes.c_uint8 * 20000)()
    lib.opj_set_default_encoder_parameters(params)
    got = np.frombuffer(bytes(params), np.int32)
    assert [got[_CP[k] // 4] for k in ("numresolution", "cblockw_init", "roi_compno",
                                      "subsampling_dx", "decod_format")] == [6, 64, -1, 1, -1]
    return lib


def j2k_bytes(components: Sequence[np.ndarray], prec: int = 8, signed: bool = False,
              sampling: Optional[Sequence[Tuple[int, int]]] = None, jp2: bool = False,
              colour: int = 1, irreversible: bool = False, mct: Optional[bool] = None,
              resolutions: int = 6, cblk: Tuple[int, int] = (64, 64), style: int = 0,
              sop: bool = False, eph: bool = False,
              precincts: Optional[Sequence[Tuple[int, int]]] = None,
              tile: Optional[Tuple[int, int]] = None, tile_offset: Tuple[int, int] = (0, 0),
              offset: Tuple[int, int] = (0, 0), rates: Sequence[float] = (0,),
              progression: int = 0, pocs: Sequence[Tuple[int, ...]] = (),
              roi: Optional[Tuple[int, int]] = None, tile_parts: Optional[str] = None,
              alpha: Optional[int] = None) -> bytes:
    """A J2K codestream (or, `jp2`, a JP2 file with `colour` 1 sRGB, 2 grey,
    3 sYCC) from libopenjp2's encoder, for what PIL's writer does not reach:
    int samples per component ([h_c, w_c], subsampled by `sampling`'s (dx,
    dy)), `prec` bits, signed, code-block `style` bits (1 lazy, 2 reset, 4
    terminate every pass, 8 vertically causal, 16 predictable termination,
    32 segmentation symbols), SOP / EPH, precincts (log2 per resolution,
    first the highest), tiles, image and tile offsets, quality layers by
    rate, a progression (0 LRCP ... 4 CPRL), POC entries (resno0, compno0,
    layno1, resno1, compno1, order), an ROI shift (component, shift),
    tile-parts split by 'R', 'L' or 'C', and the component flagged alpha."""
    import ctypes
    import os
    import tempfile

    lib = _openjp2()
    n = len(components)
    sampling = list(sampling or [(1, 1)] * n)
    full = next((c for c in range(n) if tuple(sampling[c]) == (1, 1)), 0)
    h0, w0 = components[full].shape
    x1, y1 = offset[0] + w0 * sampling[full][0], offset[1] + h0 * sampling[full][1]
    cmpt = (ctypes.c_uint32 * (9 * n))()
    for c, comp in enumerate(components):
        dx, dy = sampling[c]
        cmpt[9 * c:9 * c + 9] = [dx, dy, comp.shape[1], comp.shape[0], _ceil(offset[0], dx),
                                 _ceil(offset[1], dy), prec, prec, int(signed)]
    image = lib.opj_image_create(n, cmpt, colour)
    struct_head = (ctypes.c_uint32 * 5).from_address(image)
    struct_head[:4] = [offset[0], offset[1], x1, y1]
    comps = ctypes.c_void_p.from_address(image + 24).value
    for c, comp in enumerate(components):
        rec = comps + 64 * c
        data = ctypes.c_void_p.from_address(rec + 48).value
        arr = np.ascontiguousarray(comp, np.int32)
        ctypes.memmove(data, arr.ctypes.data, arr.nbytes)
        if c == alpha:
            ctypes.c_uint16.from_address(rec + 56).value = 1
    params = (ctypes.c_uint8 * 20000)()
    lib.opj_set_default_encoder_parameters(params)

    def put(key, value, fmt="i", at=0):
        struct.pack_into(fmt, params, _CP[key] + at, value)

    put("numresolution", resolutions)
    put("cblockw_init", cblk[0])
    put("cblockh_init", cblk[1])
    put("mode", style)
    put("irreversible", int(irreversible))
    put("prog_order", progression)
    put("tcp_mct", int(n >= 3 if mct is None else mct), "b")
    put("tcp_numlayers", len(rates))
    for k, r in enumerate(rates):
        put("tcp_rates", float(r), "f", 4 * k)
    put("cp_disto_alloc", 1)
    put("image_offset_x0", offset[0])
    put("image_offset_y0", offset[1])
    csty = (2 if sop else 0) | (4 if eph else 0)
    if precincts:
        csty |= 1
        put("res_spec", len(precincts))
        for k, (pw, ph) in enumerate(precincts):
            put("prcw_init", 1 << pw, "i", 4 * k)
            put("prch_init", 1 << ph, "i", 4 * k)
    put("csty", csty)
    if tile:
        put("tile_size_on", 1)
        put("cp_tdx", tile[0])
        put("cp_tdy", tile[1])
        put("cp_tx0", tile_offset[0])
        put("cp_ty0", tile_offset[1])
    for k, (r0, c0, l1, r1, c1, order) in enumerate(pocs):
        base = _POC_SIZE * k
        for at, v in ((0, r0), (4, c0), (8, l1), (12, r1), (16, c1), (32, order), (48, 1)):
            put("POC", v, "I", base + at)
    put("numpocs", len(pocs))
    if roi:
        put("roi_compno", roi[0])
        put("roi_shift", roi[1])
    if tile_parts:
        put("tp_on", 1, "b")
        put("tp_flag", ord(tile_parts), "b")
    codec = lib.opj_create_compress(2 if jp2 else 0)
    fd, path = tempfile.mkstemp(suffix=".jp2" if jp2 else ".j2k")
    os.close(fd)
    try:
        if not lib.opj_setup_encoder(codec, params, image):
            raise ValueError("opj_setup_encoder refused the parameters")
        stream = lib.opj_stream_create_default_file_stream(path.encode(), 0)
        ok = (lib.opj_start_compress(codec, image, stream) and lib.opj_encode(codec, stream)
              and lib.opj_end_compress(codec, stream))
        lib.opj_stream_destroy(stream)
        if not ok:
            raise ValueError("libopenjp2 failed to encode")
        with open(path, "rb") as f:
            return f.read()
    finally:
        os.unlink(path)
        lib.opj_destroy_codec(codec)
        lib.opj_image_destroy(image)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def jp2_box(tbox: bytes, content: bytes) -> bytes:
    return struct.pack(">I", 8 + len(content)) + tbox + content


def jp2_edit(blob: bytes, enumcs: Optional[int] = None, add: Sequence[bytes] = (),
             ihdr_bpc: Optional[int] = None) -> bytes:
    """A JP2 file from OpenJPEG with its `colr` enumeration replaced, its
    `ihdr` bit depth byte replaced, and boxes appended to its `jp2h` (its
    length fixed): CMYK, `pclr` / `cmap`, `cdef`, ICC and the like that no
    writer here emits."""
    pos = 0
    while pos < len(blob):
        length, tbox = struct.unpack_from(">I4s", blob, pos)
        if tbox == b"jp2h":
            body = bytearray(blob[pos + 8:pos + length])
            at = 0
            while at < len(body):
                sl, st = struct.unpack_from(">I4s", body, at)
                if st == b"colr" and enumcs is not None:
                    struct.pack_into(">I", body, at + 11, enumcs)
                if st == b"ihdr" and ihdr_bpc is not None:
                    body[at + 8 + 10] = ihdr_bpc
                at += sl
            body += b"".join(add)
            return blob[:pos] + jp2_box(b"jp2h", bytes(body)) + blob[pos + length:]
        pos += length
    raise ValueError("no jp2h box")


def j2k_packed_headers(blob: bytes, where: str = "PPT", max_segment: int = 65535,
                       straddle: bool = False) -> bytes:
    """A J2K codestream of one tile-part a tile rewritten with its packet
    headers packed into PPT segments (each tile-part header) or PPM
    segments (the main header, an Nppm length before each tile-part's
    headers, split over segments of at most `max_segment` bytes; an Nppm
    split over two segments, which OpenJPEG refuses, when `straddle`), the
    packets' bodies left in place. The headers are found by the port's
    tier-2 (`utils/jpeg2000`); PIL decodes the result to the same pixels."""
    from wast3d_tpu_torch.utils import jpeg2000 as j2

    cs = j2._Codestream(blob, 0)
    first_sot = 2  # the main header's segments, up to the first SOT
    while blob[first_sot:first_sot + 2] != b"\xff\x90":
        first_sot += 2 + struct.unpack_from(">H", blob, first_sot + 2)[0]
    pos, parts = first_sot, []
    while blob[pos:pos + 2] == b"\xff\x90":
        tile, psot = struct.unpack_from(">HI", blob, pos + 4)
        sod = blob.index(b"\xff\x93", pos + 12)
        end = pos + psot if psot else len(blob) - 2
        parts.append((tile, blob[pos + 12:sod], blob[sod + 2:end]))
        pos = end
    out_parts, headers = [], []
    for tile, tile_header, data in parts:
        t = j2._Tile(cs, tile, cs.tiles[tile], [data])
        spans = []
        t.read_packets(spans=spans)
        heads = b"".join(data[a:b] for a, b in spans)
        body, at = [], 0
        for a, b in spans:
            body.append(data[at:a])
            at = b
        body.append(data[at:])
        headers.append(heads)
        out_parts.append((tile, tile_header, heads, b"".join(body)))

    def segments(marker: int, units) -> bytes:
        """Segments of at most `max_segment` bytes over the units' bytes; a
        unit (an Nppm and its headers) starts where its 4-byte length fits
        in the segment, unless `straddle`."""
        size, chunks, cur = max_segment - 3, [], b""
        for unit in units:
            if not straddle and marker == 0x60 and 0 < size - len(cur) < 4:
                chunks.append(cur)
                cur = b""
            cur += unit
            while len(cur) > size:
                chunks.append(cur[:size])
                cur = cur[size:]
        chunks.append(cur)
        return b"".join(struct.pack(">BBHB", 0xFF, marker, 3 + len(c), z) + c
                        for z, c in enumerate(chunks))

    main = blob[:first_sot]
    if where == "PPM":
        main += segments(0x60, [struct.pack(">I", len(h)) + h for h in headers])
    out = [main]
    for k, (tile, tile_header, heads, body) in enumerate(out_parts):
        head = tile_header + (segments(0x61, [heads]) if where == "PPT" else b"")
        psot = 12 + len(head) + 2 + len(body)
        out.append(struct.pack(">BBHHIBB", 0xFF, 0x90, 10, tile, psot, 0, 1) + head + b"\xff\x93"
                   + body)
    return b"".join(out) + b"\xff\xd9"



# ---- ICNS ------------------------------------------------------------------------------

def icns_rle(band: np.ndarray) -> bytes:
    """One band of an ICNS 24-bit entry in its packbits-like runs: 0x80 +
    (n - 3) then a byte for a run of 3-130, n - 1 then n literal bytes."""
    data, out, i = bytes(np.ascontiguousarray(band, np.uint8).reshape(-1)), bytearray(), 0
    while i < len(data):
        run = 1
        while i + run < len(data) and run < 130 and data[i + run] == data[i]:
            run += 1
        if run >= 3:
            out += bytes([0x80 + run - 3, data[i]])
            i += run
            continue
        j = i
        while j < len(data) and j - i < 128 and not (
                j + 2 < len(data) and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def icns_bytes(entries: Sequence[Tuple[bytes, bytes]]) -> bytes:
    """An ICNS file of (type, payload) entries in the order given: PNG or
    JPEG 2000 payloads, 24-bit RGB (`icns_rle` per band, or raw RGBRGB...),
    8-bit masks."""
    body = b"".join(t + struct.pack(">I", 8 + len(p)) + p for t, p in entries)
    return b"icns" + struct.pack(">I", 8 + len(body)) + body


# ---- the formats of utils/image_plugins.py that PIL does not write ------------------------

def fits_bytes(samples: np.ndarray, bitpix: int, cards: Sequence[str] = (),
               naxis: Optional[int] = None) -> bytes:
    """A FITS primary HDU: SIMPLE, BITPIX, NAXIS (2, or `naxis` with the
    array's own axes), NAXISn, `cards` ("KEY     = value" strings), END,
    then the samples big-endian as given (rows in the array's order), each
    part padded to 2880 bytes."""
    samples = np.asarray(samples)
    dt = {8: ">u1", 16: ">i2", 32: ">i4", -32: ">f4", -64: ">f8"}[bitpix]
    axes = samples.shape[::-1]
    n = len(axes) if naxis is None else naxis
    head = [f"SIMPLE  = {'T':>20}", f"BITPIX  = {bitpix:>20}", f"NAXIS   = {n:>20}"]
    head += [f"NAXIS{i + 1:<3}= {a:>20}" for i, a in enumerate(axes[:n])]
    head += list(cards) + ["END"]
    text = "".join(c.ljust(80)[:80] for c in head).encode("ascii")
    data = samples.astype(dt).tobytes()
    return text.ljust(-(-len(text) // 2880) * 2880, b" ") + data.ljust(
        -(-len(data) // 2880) * 2880, b"\x00")


def fits_gzip_bytes(samples: np.ndarray, zbitpix: int) -> bytes:
    """A FITS of an empty primary HDU and a GZIP_1 tile-compressed BINTABLE
    extension (ZIMAGE) holding [H, W] samples, each stored as a big-endian
    32-bit word in one gzip heap after an 8-byte table row (what PIL's
    `fits_gzip` decoder reads: the last |ZBITPIX| / 8 bytes of each word)."""
    import gzip

    samples = np.asarray(samples)
    h, w = samples.shape

    def header(cards):
        text = "".join(c.ljust(80)[:80] for c in cards + ["END"]).encode("ascii")
        return text.ljust(-(-len(text) // 2880) * 2880, b" ")

    primary = header([f"SIMPLE  = {'T':>20}", f"BITPIX  = {8:>20}", f"NAXIS   = {0:>20}"])
    table = header(["XTENSION= 'BINTABLE'", f"BITPIX  = {8:>20}", f"NAXIS   = {2:>20}",
                    f"NAXIS1  = {8:>20}", f"NAXIS2  = {1:>20}", f"ZIMAGE  = {'T':>20}",
                    "ZCMPTYPE= 'GZIP_1  '", f"ZBITPIX = {zbitpix:>20}", f"ZNAXIS  = {2:>20}",
                    f"ZNAXIS1 = {w:>20}", f"ZNAXIS2 = {h:>20}"])
    return primary + table + bytes(8) + gzip.compress(samples.astype(">u4").tobytes(), mtime=0)


def fli_chunk(kind: int, payload: bytes) -> bytes:
    """A subchunk of a frame: size, type, payload (padded to even size)."""
    payload += b"\x00" * (len(payload) % 2)
    return struct.pack("<IH", 6 + len(payload), kind) + payload


def fli_brun(img: np.ndarray, run_min: int = 3) -> bytes:
    """BRUN (15) lines: runs of `run_min` or more equal bytes as (n, v),
    literals as (-n, bytes), each line's packet count byte first."""
    out = b""
    for row in np.asarray(img, np.uint8):
        packets, x, w = [], 0, len(row)
        while x < w:
            n = 1
            while x + n < w and n < 127 and row[x + n] == row[x]:
                n += 1
            if n >= run_min:
                packets.append(bytes([n, row[x]]))
                x += n
                continue
            n = 1
            while x + n < w and n < 127 and not (x + n + 2 < w and row[x + n] == row[x + n + 1]
                                                  == row[x + n + 2]):
                n += 1
            packets.append(bytes([256 - n]) + row[x:x + n].tobytes())
            x += n
        out += bytes([len(packets) & 255]) + b"".join(packets)
    return out


def fli_lc(img: np.ndarray, y0: int = 0, skip: int = 0, run: bool = True) -> bytes:
    """LC (12) byte deltas of rows `y0`... of `img`: per line one packet that
    skips `skip` pixels, then (when `run`) a run of the next 2 pixels' first
    value and a literal of the rest."""
    img = np.asarray(img, np.uint8)
    out = struct.pack("<HH", y0, img.shape[0] - y0)
    for row in img[y0:]:
        rest = row[skip:]
        if run and len(rest) > 2:
            out += bytes([2, skip, 256 - 2, rest[0], 0, len(rest) - 2]) + rest[2:].tobytes()
        else:
            out += bytes([1, skip, len(rest)]) + rest.tobytes()
    return out


def fli_ss2(img: np.ndarray, skip_lines: int = 0, odd_last: bool = False) -> bytes:
    """SS2 (7) word deltas: per line a packet of a word run (the first two
    pixels) and a literal of the other words, after a skip-lines word for
    the first line when `skip_lines`; `odd_last` sets each line's last byte
    with a 0x8000 word."""
    img = np.asarray(img, np.uint8)
    h, w = img.shape
    out = struct.pack("<H", h - skip_lines)
    for y in range(skip_lines, h):
        row = img[y]
        line = b""
        if y == skip_lines and skip_lines:
            line += struct.pack("<H", 65536 - skip_lines)
        if odd_last:
            line += struct.pack("<H", 0x8000 | int(row[-1]))
        words = row[:w // 2 * 2]
        line += struct.pack("<H", 2) + bytes([0, 256 - 1]) + words[:2].tobytes()
        line += bytes([0, len(words) // 2 - 1]) + words[2:].tobytes()
        out += line
    return out


def fli_color(palette: np.ndarray, skip: int = 0, six_bits: bool = False) -> bytes:
    """A COLOR256 (4) or COLOR64 (11) payload of one packet."""
    pal = np.asarray(palette, np.uint8)
    n = len(pal)
    return struct.pack("<H", 1) + bytes([skip, n & 255]) + (pal >> 2 if six_bits else pal).tobytes()


def fli_bytes(width: int, height: int, chunks: Sequence[Tuple[int, bytes]], flc: bool = True,
              frames: int = 1, prefix: bool = False) -> bytes:
    """An FLI (0xAF11) or FLC (0xAF12) file whose first frame holds `chunks`
    = (type, payload); `frames` > 1 repeats an empty frame; `prefix` puts a
    0xF100 prefix chunk first (PIL then reads it as the first frame)."""
    frame_body = b"".join(fli_chunk(k, p) for k, p in chunks)
    frame = struct.pack("<IHH8x", 16 + len(frame_body), 0xF1FA, len(chunks)) + frame_body
    rest = struct.pack("<IHH8x", 16, 0xF1FA, 0) * (frames - 1)
    head = bytearray(128)
    struct.pack_into("<IHHHHHHI", head, 0, 128 + len(frame) + len(rest),
                     0xAF12 if flc else 0xAF11, frames, width, height, 8, 3 if flc else 0, 5)
    pre = struct.pack("<IH10x", 16, 0xF100) if prefix else b""
    return bytes(head) + pre + frame + rest


def ftex_bytes(width: int, height: int, fmt: int, payload: bytes, version: int = 1) -> bytes:
    """An FTEX texture of one format (0 DXT1, 1 raw RGB) and one mipmap."""
    head = b"FTEX" + struct.pack("<i2i2i2i", version, width, height, 1, 1, fmt, 32)
    return head + struct.pack("<i", len(payload)) + payload


def gbr_bytes(pixels: np.ndarray, version: int = 2, comment: bytes = b"brush",
              spacing: int = 25) -> bytes:
    """A GIMP brush of [H, W] (depth 1) or [H, W, 4] (depth 4) pixels."""
    pixels = np.asarray(pixels, np.uint8)
    h, w = pixels.shape[:2]
    depth = 1 if pixels.ndim == 2 else 4
    extra = b"GIMP" + struct.pack(">I", spacing) if version == 2 else b""
    size = 20 + len(extra) + len(comment) + 1
    return (struct.pack(">5I", size, version, w, h, depth) + extra + comment + b"\x00"
            + pixels.tobytes())


def im_bytes(image_type: str, width: int, height: int, data: bytes,
             lut: Optional[np.ndarray] = None, lines: Sequence[str] = ()) -> bytes:
    """An IM file: "Image type: <image_type>" and size lines, `lines`, a
    "Lut" line when `lut` ([256, 3]) is given, the header padded to 511
    bytes with NULs and a 0x1A, the LUT planes, then `data` as given."""
    head = f"Image type: {image_type}\r\nImage size (x*y): {width}*{height}\r\n"
    head += "".join(f"{line}\r\n" for line in lines)
    if lut is not None:
        head += "Lut: 1\r\n"
    out = head.encode("latin-1")
    out += b"\x00" * (511 - len(out)) + b"\x1a"
    if lut is not None:
        out += np.asarray(lut, np.uint8).T.tobytes()
    return out + data


def imt_bytes(pixels: np.ndarray, comment: bytes = b"* made for the tests") -> bytes:
    """An IM Tools file of 8-bit grey pixels."""
    pixels = np.asarray(pixels, np.uint8)
    h, w = pixels.shape
    return (comment + b"\n" + b"width %d\nheight %d\npixel n8\n" % (w, h) + b"\x0c"
            + pixels.tobytes())


def iptc_record(record: int, dataset: int, data: bytes) -> bytes:
    if len(data) < 32768:
        return bytes([0x1C, record, dataset]) + struct.pack(">H", len(data)) + data
    return bytes([0x1C, record, dataset, 0x84]) + struct.pack(">I", len(data)) + data


def iptc_bytes(data: bytes, width: int, height: int, layers: int = 1, component: int = 0,
               band: Optional[int] = None, compression: int = 1, parts: int = 1) -> bytes:
    """An IPTC / NAA image: 3:60 (layers, component), 3:65 (band + 1), 3:20
    / 3:30 (size), 3:120 (compression) and the data in `parts` 8:10
    records."""
    out = iptc_record(3, 60, bytes([layers, component]))
    if band is not None:
        out += iptc_record(3, 65, bytes([band + 1]))
    out += iptc_record(3, 20, struct.pack(">I", width)) + iptc_record(3, 30, struct.pack(
        ">I", height)) + iptc_record(3, 120, bytes([compression]))
    step = -(-len(data) // parts)
    for i in range(0, len(data), step):
        out += iptc_record(8, 10, data[i:i + step])
    return out + iptc_record(9, 10, b"\x00")


def mcidas_bytes(samples: np.ndarray, prefix: int = 0, offset: int = 256) -> bytes:
    """A McIdas area of one band: [H, W] uint8, >u2 or >u4 samples, each
    line after `prefix` bytes, the data at `offset`."""
    samples = np.asarray(samples)
    h, w = samples.shape
    size = samples.dtype.itemsize
    words = [0] * 65
    words[2], words[9], words[10], words[11], words[14], words[15], words[34] = (
        4, h, w, size, 1, prefix, offset)
    head = struct.pack(">64i", *words[1:])
    rows = samples.astype(samples.dtype.newbyteorder(">")).reshape(h, -1).view(np.uint8)
    body = b"".join(bytes(prefix) + r.tobytes() for r in rows)
    return head + bytes(offset - 256) + body


def msp_bytes(bits: np.ndarray, version: int = 2, run_min: int = 3) -> bytes:
    """Windows Paint: [H, W] bool (True white). Version 1 raw rows, version
    2 a row map and rows of runs (0, count, value) and literals."""
    bits = np.asarray(bits, bool)
    h, w = bits.shape
    rows = np.packbits(bits, axis=1)
    words = [0] * 16
    words[0:2] = struct.unpack("<HH", b"DanM" if version == 1 else b"LinS")
    words[2], words[3] = w, h
    words[12] = 0
    for v in words[:12] + words[13:]:
        words[12] ^= v
    head = struct.pack("<16H", *words)
    if version == 1:
        return head + rows.tobytes()
    lines = []
    for row in rows:
        out, x = b"", 0
        while x < len(row):
            n = 1
            while x + n < len(row) and n < 255 and row[x + n] == row[x]:
                n += 1
            if n >= run_min:
                out += bytes([0, n, row[x]])
            else:
                n = min(n, 255)
                out += bytes([n]) + row[x:x + n].tobytes()
            x += n
        lines.append(out)
    return head + struct.pack(f"<{h}H", *map(len, lines)) + b"".join(lines)


def pcd_bytes(y: np.ndarray, c1: np.ndarray, c2: np.ndarray, orientation: int = 0) -> bytes:
    """A PhotoCD file's base image: luma [512, 768], chroma [256, 384] each,
    "PCD_" at 2048 and the orientation bits at 2048 + 1538, the pixels at
    96 * 2048 as pairs of luma rows and their chroma rows."""
    head = bytearray(96 * 2048)
    head[2048:2052] = b"PCD_"
    head[2048 + 1538] = orientation
    y, c1, c2 = (np.asarray(a, np.uint8) for a in (y, c1, c2))
    pairs = np.concatenate([y.reshape(256, 2 * 768), c1, c2], axis=1)
    return bytes(head) + pairs.tobytes()


def pixar_bytes(rgb: np.ndarray) -> bytes:
    """A PIXAR raster of RGB pixels (mode 14, 2) at offset 1024."""
    rgb = np.asarray(rgb, np.uint8)
    h, w = rgb.shape[:2]
    head = bytearray(1024)
    head[:4] = b"\x80\xe8\x00\x00"
    struct.pack_into("<HH", head, 416, h, w)
    struct.pack_into("<HH", head, 424, 14, 2)
    return bytes(head) + rgb.tobytes()


_XPM_CHARS = b".#abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789+@$%&*=-;:>,<1"


def xpm_bytes(indices: np.ndarray, palette: np.ndarray, bpp: int = 1,
              none: Optional[int] = None, pixels_comment: bool = True) -> bytes:
    """An XPM of palette indices ([H, W]) and `palette` ([n, 3]), keys of
    `bpp` characters; `none` makes that entry transparent ("c None")."""
    indices = np.asarray(indices)
    h, w = indices.shape
    n = len(palette)
    chars = [_XPM_CHARS[i:i + 1] for i in range(len(_XPM_CHARS))]
    keys = []
    for i in range(n):
        k, key = i, b""
        for _ in range(bpp):
            key += chars[k % len(chars)]
            k //= len(chars)
        keys.append(key)
    out = b"/* XPM */\nstatic char *image[] = {\n/* width height colors cpp */\n"
    out += b'"%d %d %d %d",\n' % (w, h, n, bpp)
    for i, (key, rgb) in enumerate(zip(keys, np.asarray(palette, np.uint8))):
        colour = b"None" if i == none else b"#%02X%02X%02X" % tuple(int(v) for v in rgb)
        out += b'"' + key + b" c " + colour + b'",\n'
    if pixels_comment:
        out += b"/* pixels */\n"
    for r, row in enumerate(indices):
        out += b'"' + b"".join(keys[int(i)] for i in row) + (b'",\n' if r < h - 1 else b'"\n')
    return out + b"};\n"


def xvthumb_bytes(indices: np.ndarray, comments: Sequence[bytes] = (b"#made for the tests",)
                  ) -> bytes:
    """An XV thumbnail ("P7 332") of 8-bit 3-3-2 indices."""
    indices = np.asarray(indices, np.uint8)
    h, w = indices.shape
    return (b"P7 332\n" + b"".join(c + b"\n" for c in comments) + b"#END_OF_COMMENTS\n"
            + b"%d %d 255\n" % (w, h) + indices.tobytes())


def dcx_bytes(pages: Sequence[bytes]) -> bytes:
    """A DCX of PCX `pages`."""
    at = 4 + 4 * (len(pages) + 1)
    offsets = []
    for p in pages:
        offsets.append(at)
        at += len(p)
    return (struct.pack("<I", 0x3ADE68B1) + struct.pack(f"<{len(pages) + 1}I", *offsets, 0)
            + b"".join(pages))


def blp_bytes(version: int, width: int, height: int, payload: bytes,
              palette: Optional[np.ndarray] = None, compression: int = 1, encoding: int = 1,
              alpha: int = 0, alpha_encoding: int = 0, jpeg_header: Optional[bytes] = None,
              gap: int = 0) -> bytes:
    """A BLP1 or BLP2 file with one mipmap: `payload` (palette indices, DXT
    blocks or a JPEG's rest) and, for BLP1 JPEG (compression 0), the shared
    `jpeg_header`; `palette` [256, 4] BGRA for the palette kinds; `gap`
    bytes between the header and the mipmap's offset."""
    pal = (np.zeros((256, 4), np.uint8) if palette is None
           else np.asarray(palette, np.uint8)).tobytes()
    if version == 1:
        head = b"BLP1" + struct.pack("<iIIIiI", compression, alpha, width, height, encoding, 0)
        start = 28 + 128
        if compression == 0:
            body = struct.pack("<I", len(jpeg_header)) + jpeg_header + bytes(gap)
        else:
            body = pal
        offset = start + len(body)
        return (head + struct.pack("<16I", offset, *[0] * 15)
                + struct.pack("<16I", len(payload), *[0] * 15) + body + payload)
    head = b"BLP2" + struct.pack("<ibbbbII", compression, encoding, alpha, alpha_encoding, 0,
                                 width, height)
    offset = 20 + 128 + 1024 + gap
    return (head + struct.pack("<16I", offset, *[0] * 15)
            + struct.pack("<16I", len(payload), *[0] * 15) + pal + bytes(gap) + payload)
