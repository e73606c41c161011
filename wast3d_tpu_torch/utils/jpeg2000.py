"""JPEG 2000 (ISO/IEC 15444-1), J2K codestreams and JP2 files, read as
`np.asarray(PIL.Image.open(f))` reads them (Jpeg2KImagePlugin over
OpenJPEG 2.5.4), without PIL.

`decode_jpeg2000(blob, name)`:

- PIL's own parse first (`_pil_header`): the mode and size from the SIZ
  segment of a J2K codestream, or from the JP2 header box (`ihdr`, a `colr`
  of CMYK, a `pclr` of at most 8-bit entries making "P" / "PA"), with its
  box reader's refusals;
- OpenJPEG's JP2 boxes (`jP  `, `ftyp`, `jp2h` with `ihdr`, `colr`, `bpcc`,
  `pclr`, `cmap`, `cdef`; others read past), which give the colour space;
- the codestream (`_Codestream`): SIZ (image and tile origins, XRsiz /
  YRsiz, 1-31 bits, signed), COD / COC (five progression orders, layers,
  0-32 decomposition levels, code-block sizes and styles, precincts, SOP /
  EPH), QCD / QCC (none, scalar derived, scalar expounded, guard bits), RGN,
  POC, PPM / PPT, and PLT / PLM / TLM / CRG / COM read past, tile-parts in
  any order OpenJPEG accepts; Part 2 markers and HTJ2K raise;
- tier-2 in Python (`_Tile`): OpenJPEG's packet iterator with POC, packet
  headers (tag trees, zero bit-planes, pass counts, Lblock) from the
  stream or from PPM / PPT, code-block segments by style;
- tier-1, the wavelets, the colour transform and the DC shift natively
  (`native/j2k.cpp`: `native.j2k_t1`, `j2k_idwt`, `j2k_mct`, `j2k_level`);
- the tile buffers OpenJPEG hands PIL, turned into PIL's array as
  Pillow's Jpeg2KDecode.c unpackers turn them (precision shifts, signed
  offsets, sYCC through PIL's YCbCr -> RGB tables).

A file PIL refuses (a truncated or damaged codestream, a mode without an
unpacker, ...) raises `ValueError` naming the file and the marker or box.
The plain versions the tests hold the native loops to are here:
`t1_reference`, `idwt53_reference`, `idwt97_reference`, `mct_reference`.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

J2K_SIGNATURE = b"\xff\x4f\xff\x51"
JP2_SIGNATURE = b"\x00\x00\x00\x0cjP  \r\n\x87\n"

# OpenJPEG's colour spaces (opj_image_t.color_space).
UNKNOWN, UNSPECIFIED, SRGB, GRAY, SYCC, EYCC, CMYK = -1, 0, 1, 2, 3, 4, 5
_ENUMCS = {16: SRGB, 17: GRAY, 18: SYCC, 24: EYCC, 12: CMYK}

# Pillow's j2k_unpackers: (mode, colour space, components, subsampling
# allowed, unpacker).
_UNPACKERS = (("L", GRAY, 1, False, "gray_l"), ("P", SRGB, 1, False, "gray_l"),
              ("PA", SRGB, 2, False, "graya_la"), ("I;16", GRAY, 1, False, "gray_i"),
              ("I;16B", GRAY, 1, False, "gray_i"), ("LA", GRAY, 2, False, "graya_la"),
              ("RGB", GRAY, 1, False, "gray_rgb"), ("RGB", GRAY, 2, False, "gray_rgb"),
              ("RGB", SRGB, 3, True, "srgb_rgb"), ("RGB", SYCC, 3, True, "sycc_rgb"),
              ("RGB", SRGB, 4, True, "srgb_rgb"), ("RGB", SYCC, 4, True, "sycc_rgb"),
              ("RGBA", GRAY, 1, False, "gray_rgb"), ("RGBA", GRAY, 2, False, "graya_la"),
              ("RGBA", SRGB, 3, True, "srgb_rgb"), ("RGBA", SYCC, 3, True, "sycc_rgb"),
              ("RGBA", SRGB, 4, True, "srgba_rgba"), ("RGBA", SYCC, 4, True, "sycca_rgba"),
              ("RGBA", GRAY, 4, True, "srgba_rgba"),
              ("CMYK", CMYK, 4, True, "srgba_rgba"))

# Markers (the second byte after 0xFF).
SOC, SOT, SOD, EOC, SIZ = 0x4F, 0x90, 0x93, 0xD9, 0x51
COD, COC, RGN, QCD, QCC, POC = 0x52, 0x53, 0x5E, 0x5C, 0x5D, 0x5F
TLM, PLM, PLT, PPM, PPT, CRG, COM, CAP, CPF = 0x55, 0x57, 0x58, 0x60, 0x61, 0x63, 0x64, 0x50, 0x59
SOP, EPH = 0x91, 0x92
_PART2 = {0x74: "MCT", 0x75: "MCC", 0x77: "MCO", 0x78: "CBD", 0x5A: "NLT"}
_MAIN_ONLY = {TLM, PLM, PPM, CRG, CAP, CPF}
_TILE_ONLY = {PLT, PPT}
_BOTH = {COD, COC, RGN, QCD, QCC, POC, COM}
_KNOWN = {SOC, SOT, SOD, EOC, SIZ, SOP, EPH} | _MAIN_ONLY | _TILE_ONLY | _BOTH | set(_PART2)

LRCP, RLCP, RPCL, PCRL, CPRL = range(5)
STY_LAZY, STY_RESET, STY_TERMALL, STY_VSC, STY_SEGSYM, STY_HT = 1, 2, 4, 8, 32, 64


class J2kError(ValueError):
    pass


def _ceildiv(a: int, b: int) -> int:
    return -(-a // b)


# ---- PIL's parse (Jpeg2KImagePlugin) ---------------------------------------------------

class _BoxReader:
    """Jpeg2KImagePlugin.BoxReader over `data[start:end]` (`length` None at
    the top level, where PIL knows no length)."""

    def __init__(self, data: bytes, start: int, length: Optional[int]):
        self.data, self.pos, self.start, self.length = data, start, start, length
        self.remaining = -1

    def _can_read(self, n: int) -> bool:
        if self.length is not None and self.pos - self.start + n > self.length:
            return False
        return n <= self.remaining if self.remaining >= 0 else True

    def read(self, n: int) -> bytes:
        if not self._can_read(n):
            raise J2kError("Not enough data in header")
        out = self.data[self.pos:self.pos + n]
        if len(out) < n:
            raise J2kError(f"Expected to read {n} bytes but only got {len(out)}")
        self.pos += n
        if self.remaining > 0:
            self.remaining -= n
        return out

    def fields(self, fmt: str) -> tuple:
        return struct.unpack(fmt, self.read(struct.calcsize(fmt)))

    def has_next(self) -> bool:
        return True if self.length is None else self.pos - self.start + self.remaining < self.length

    def next_type(self) -> bytes:
        if self.remaining > 0:
            self.pos += self.remaining
        self.remaining = -1
        lbox, tbox = self.fields(">I4s")
        hlen = 8
        if lbox == 1:
            lbox, hlen = self.fields(">Q")[0], 16
        if lbox < hlen or not self._can_read(lbox - hlen):
            raise J2kError("Invalid header length")
        self.remaining = lbox - hlen
        return tbox

    def sub(self) -> "_BoxReader":
        size = self.remaining
        start = self.pos
        self.read(size)
        return _BoxReader(self.data[start:start + size], 0, size)


def _pil_comment(blob: bytes, pos: int) -> None:
    """Jpeg2KImageFile._parse_comment's walk from `pos` (its struct and index
    errors make PIL refuse the file)."""
    while True:
        marker = blob[pos:pos + 2]
        pos += 2
        if not marker:
            return
        if len(marker) < 2:
            raise J2kError("a marker cut short in the main header")
        if marker[1] in (0x90, 0xD9):
            return
        hdr = blob[pos:pos + 2]
        pos += 2
        if len(hdr) < 2:
            raise J2kError("a marker segment without its length")
        length = hdr[0] << 8 | hdr[1]
        if marker[1] == 0x64:
            return
        pos += length - 2


def _pil_codestream(blob: bytes, pos: int) -> Tuple[Tuple[int, int], str]:
    """Jpeg2KImagePlugin._parse_codestream from the SIZ length at `pos`."""
    hdr = blob[pos:pos + 2]
    if len(hdr) < 2:
        raise J2kError("SIZ cut short")
    lsiz = hdr[0] << 8 | hdr[1]
    siz = hdr + blob[pos + 2:pos + lsiz]
    if len(siz) < 38:
        raise J2kError("SIZ cut short")
    _, _, xsiz, ysiz, xosiz, yosiz, _, _, _, _, csiz = struct.unpack_from(">HHIIIIIIIIH", siz)
    size = (xsiz - xosiz, ysiz - yosiz)
    if csiz == 1:
        if len(siz) < 39:
            raise J2kError("SIZ cut short")
        mode = "I;16" if (siz[38] & 0x7F) + 1 > 8 else "L"
    elif csiz in (2, 3, 4):
        mode = {2: "LA", 3: "RGB", 4: "RGBA"}[csiz]
    else:
        raise J2kError(f"{csiz} components in SIZ: PIL has no mode for them")
    return size, mode


def _pil_header(blob: bytes) -> Tuple[Tuple[int, int], str]:
    """The (size, mode) PIL opens the file with, or J2kError where it
    refuses to."""
    if blob[:4] == J2K_SIGNATURE:
        size, mode = _pil_codestream(blob, 4)
        lsiz = blob[4] << 8 | blob[5]
        _pil_comment(blob, 4 + lsiz)
        return size, mode
    reader = _BoxReader(blob, 12, None)
    header = None
    while reader.has_next():
        tbox = reader.next_type()
        if tbox == b"jp2h":
            header = reader.sub()
            break
        if tbox == b"ftyp":
            reader.fields(">4s")
    if header is None:
        raise J2kError("no jp2h box")
    size = mode = nc = None
    palette = False
    while header.has_next():
        tbox = header.next_type()
        if tbox == b"ihdr":
            height, width, nc, bpc = header.fields(">IIHB")
            size = (width, height)
            if nc == 1 and (bpc & 0x7F) > 8:
                mode = "I;16"
            elif nc in (1, 2, 3, 4):
                mode = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}[nc]
        elif tbox == b"colr" and nc == 4:
            meth, _, _, enumcs = header.fields(">BBBI")
            if meth == 1 and enumcs == 12:
                mode = "CMYK"
        elif tbox == b"pclr" and mode in ("L", "LA") and not palette:
            ne, npc = header.fields(">HB")
            depths = header.fields(">" + "B" * npc)
            if max(depths, default=0) <= 8:
                colours = {header.fields(">" + "B" * npc) for _ in range(ne)}
                if len(colours) > 256:
                    raise J2kError("a pclr box of more than 256 colours")
                palette = True
                mode = "P" if mode == "L" else "PA"
        elif tbox == b"res ":
            res = header.sub()
            while res.has_next():
                if res.next_type() == b"resc":
                    res.fields(">HHHHBB")
                    break
    if size is None or mode is None:
        raise J2kError("Malformed JP2 header")
    end = reader.pos
    if blob[end:end + 12].endswith(b"jp2c\xff\x4f\xff\x51"):
        pos = end + 12
        hdr = blob[pos:pos + 2]
        if len(hdr) < 2:
            raise J2kError("SIZ cut short")
        _pil_comment(blob, pos + (hdr[0] << 8 | hdr[1]))
    return size, mode


# ---- OpenJPEG's JP2 boxes ---------------------------------------------------------------

def _jp2_boxes(blob: bytes) -> Tuple[int, int]:
    """OpenJPEG's opj_jp2_read_header over a JP2 file: (the offset of the
    codestream, the colour space the `colr` box gives)."""
    pos, state, enumcs, has_jp2h = 0, 0, None, False
    while True:
        if pos + 8 > len(blob):
            raise J2kError("no jp2c box (the file ends first)")
        length, tbox = struct.unpack_from(">I4s", blob, pos)
        hlen = 8
        if length == 1:
            if pos + 16 > len(blob):
                raise J2kError("box header cut short")
            length, hlen = struct.unpack_from(">Q", blob, pos + 8)[0], 16
        elif length == 0 and tbox != b"jp2c":
            raise J2kError(f"box {tbox!r} of undefined size")
        if tbox == b"jp2c":
            if not has_jp2h:
                raise J2kError("jp2c box before the jp2h box")
            break
        if length < hlen:
            raise J2kError(f"box {tbox!r} of invalid size {length}")
        body = blob[pos + hlen:pos + length]
        if tbox in (b"jP  ", b"ftyp", b"jp2h"):
            if pos + length > len(blob):
                raise J2kError(f"box {tbox!r} past the end of the file")
            if tbox == b"jP  ":
                if state != 0:
                    raise J2kError("jP box not first")
                if len(body) != 4 or body != b"\r\n\x87\n":
                    raise J2kError("bad jP box")
                state = 1
            elif tbox == b"ftyp":
                if state != 1:
                    raise J2kError("ftyp box not second")
                if len(body) < 8 or (len(body) - 8) % 4:
                    raise J2kError("bad ftyp box")
                state = 2
            else:
                if state < 2:
                    raise J2kError("jp2h box before jP / ftyp")
                enumcs = _jp2h(body)
                has_jp2h = True
        else:
            if state < 2:
                raise J2kError(f"box {tbox!r} before the jP / ftyp boxes")
            if pos + length > len(blob):
                raise J2kError(f"box {tbox!r} past the end of the file")
        pos += length
    space = UNKNOWN if enumcs is None else _ENUMCS.get(enumcs, UNKNOWN)
    return pos + hlen, space


def _jp2h(body: bytes) -> Optional[int]:
    """opj_jp2_read_jp2h: the `colr` enumeration (None for none, or an ICC
    profile), after each sub-box's checks."""
    pos, enumcs, has_colr, has_ihdr, pclr, cmap, cdef, ncomp = 0, None, False, False, None, False, False, 0
    while pos < len(body):
        if len(body) - pos < 8:
            raise J2kError("jp2h: a box header cut short")
        length, tbox = struct.unpack_from(">I4s", body, pos)
        hlen = 8
        if length == 1:
            if len(body) - pos < 16:
                raise J2kError("jp2h: a box header cut short")
            length, hlen = struct.unpack_from(">Q", body, pos + 8)[0], 16
        if length == 0 or length < hlen or length > len(body) - pos:
            raise J2kError(f"jp2h: box {tbox!r} of inconsistent length")
        c = body[pos + hlen:pos + length]
        if tbox == b"ihdr":
            if len(c) != 14:
                raise J2kError("ihdr box of a bad size")
            ncomp = struct.unpack_from(">H", c, 8)[0]
            if not 1 <= ncomp <= 16384:
                raise J2kError("ihdr box: invalid number of components")
            has_ihdr = True
        elif tbox == b"colr":
            if len(c) < 3:
                raise J2kError("colr box of a bad size")
            if not has_colr:
                if c[0] == 1:
                    if len(c) < 7:
                        raise J2kError("colr box of a bad size")
                    enumcs = struct.unpack_from(">I", c, 3)[0]
                    has_colr = True
                elif c[0] == 2:
                    enumcs, has_colr = None, True
        elif tbox == b"bpcc":
            if len(c) != ncomp:
                raise J2kError("bpcc box of a bad size")
        elif tbox == b"pclr":
            if pclr is not None or len(c) < 3:
                raise J2kError("bad pclr box")
            entries, channels = struct.unpack_from(">HB", c, 0)
            if not 1 <= entries <= 1024 or channels == 0 or len(c) < 3 + channels:
                raise J2kError("bad pclr box")
            need = 3 + channels + entries * sum(((d & 0x7F) + 8) >> 3 for d in c[3:3 + channels])
            if need > len(c):
                raise J2kError("pclr box cut short")
            pclr = channels
        elif tbox == b"cmap":
            if pclr is None:
                raise J2kError("cmap box before its pclr box")
            if cmap or len(c) < 4 * pclr:
                raise J2kError("bad cmap box")
            cmap = True
        elif tbox == b"cdef":
            if cdef or len(c) < 2:
                raise J2kError("bad cdef box")
            n = struct.unpack_from(">H", c, 0)[0]
            if n == 0 or len(c) < 2 + 6 * n:
                raise J2kError("bad cdef box")
            cdef = True
        pos += length
    if not has_ihdr:
        raise J2kError("jp2h box without an ihdr box")
    return enumcs if has_colr else 0


# ---- the codestream ---------------------------------------------------------------------

class _Coding:
    """A component's COD / COC values."""
    __slots__ = ("prt", "numres", "cblkw", "cblkh", "sty", "qmfbid", "prc")

    def copy(self) -> "_Coding":
        c = _Coding()
        for k in self.__slots__:
            setattr(c, k, getattr(self, k))
        return c


class _Quant:
    """A component's QCD / QCC values: style, guard bits, (expn, mant) per
    band."""
    __slots__ = ("style", "guard", "steps", "roishift")

    def copy(self) -> "_Quant":
        q = _Quant()
        q.style, q.guard, q.steps, q.roishift = self.style, self.guard, list(self.steps), self.roishift
        return q


class _TileParams:
    """A tile's coding parameters (OpenJPEG's opj_tcp_t)."""

    def __init__(self, ncomp: int):
        self.csty = 0
        self.prg = LRCP
        self.layers = 1
        self.mct = 0
        self.cod = False
        self.coding: List[Optional[_Coding]] = [None] * ncomp
        self.quant: List[Optional[_Quant]] = [None] * ncomp
        self.pocs: List[Tuple[int, int, int, int, int, int]] = []

    def copy(self) -> "_TileParams":
        t = _TileParams(len(self.coding))
        t.csty, t.prg, t.layers, t.mct = self.csty, self.prg, self.layers, self.mct
        t.coding = [c.copy() if c else None for c in self.coding]
        t.quant = [q.copy() if q else None for q in self.quant]
        t.pocs = list(self.pocs)
        return t


class _Codestream:
    """The main header and tile-parts of a codestream starting at `pos`,
    with OpenJPEG's checks."""

    def __init__(self, blob: bytes, pos: int):
        self.blob = blob
        if blob[pos:pos + 2] != b"\xff\x4f":
            raise J2kError("expected a SOC marker")
        pos += 2
        marker, pos = self._marker(pos)
        if marker != SIZ:
            raise J2kError(f"marker 0xFF{marker:02X} where SIZ must come")
        seg, pos = self._segment(pos, "SIZ")
        self._siz(seg)
        self.default = _TileParams(self.ncomp)
        ppm: Dict[int, bytes] = {}
        has_cod = has_qcd = False
        while True:
            marker, pos = self._marker(pos)
            if marker == SOT:
                break
            if marker not in _KNOWN:
                pos = self._unknown(pos)
                continue
            if marker in _PART2:
                raise J2kError(f"Part 2 marker {_PART2[marker]} (0xFF{marker:02X})")
            if marker == PPM:
                seg, pos = self._segment(pos, "PPM")
                self._packed_segment(ppm, seg, "PPM")
                continue
            if marker in (CAP, CPF):
                raise J2kError(f"HTJ2K marker 0xFF{marker:02X} (Part 15) is not read")
            if marker not in _MAIN_ONLY | _BOTH:
                raise J2kError(f"marker 0xFF{marker:02X} out of place in the main header")
            seg, pos = self._segment(pos, f"0xFF{marker:02X}")
            has_cod |= marker == COD
            has_qcd |= marker == QCD
            self._header_marker(marker, seg, self.default)
        if not has_cod or not has_qcd:
            raise J2kError("main header without " + ("COD" if not has_cod else "QCD"))
        self.ppm = _Packed(self._merge_ppm(ppm)) if ppm else None
        self.tiles: Dict[int, _TileParams] = {}
        self.tile_data: Dict[int, List[bytes]] = {}
        self.ppt: Dict[int, Dict[int, bytes]] = {}
        self._tile_parts(pos - 2)

    @staticmethod
    def _packed_segment(store: Dict[int, bytes], seg: bytes, what: str) -> None:
        if len(seg) < 1:
            raise J2kError(f"{what} cut short")
        if seg[0] in store:
            raise J2kError(f"{what} index {seg[0]} read twice")
        store[seg[0]] = seg[1:]

    @staticmethod
    def _merge_ppm(ppm: Dict[int, bytes]) -> bytes:
        """opj_j2k_merge_ppm: the PPM segments in index order, their Nppm
        lengths taken out (a tile-part's headers may run over into the next
        segment, an Nppm may not)."""
        out, remaining = [], 0
        for k in sorted(ppm):
            data, pos = ppm[k], 0
            while pos < len(data):
                take = min(remaining, len(data) - pos)
                out.append(data[pos:pos + take])
                pos, remaining = pos + take, remaining - take
                if pos == len(data):
                    break
                if len(data) - pos < 4:
                    raise J2kError("PPM: not enough bytes in a segment to read Nppm")
                remaining = struct.unpack_from(">I", data, pos)[0]
                pos += 4
        if remaining:
            raise J2kError("corrupted PPM markers (Nppm past their data)")
        return b"".join(out)

    def _marker(self, pos: int) -> Tuple[int, int]:
        b = self.blob[pos:pos + 2]
        if len(b) < 2:
            raise J2kError("codestream cut short (a marker expected)")
        if b[0] != 0xFF:
            raise J2kError(f"a marker expected at {pos}, found {b.hex()}")
        return b[1], pos + 2

    def _segment(self, pos: int, what: str) -> Tuple[bytes, int]:
        b = self.blob[pos:pos + 2]
        if len(b) < 2:
            raise J2kError(f"codestream cut short in {what}")
        n = b[0] << 8 | b[1]
        if n < 2:
            raise J2kError(f"{what}: invalid marker size {n}")
        if pos + n > len(self.blob):
            raise J2kError(f"codestream cut short in {what}")
        return self.blob[pos + 2:pos + n], pos + n

    def _unknown(self, pos: int) -> int:
        """opj_j2k_read_unk: two bytes at a time up to a known marker."""
        while True:
            b = self.blob[pos:pos + 2]
            if len(b) < 2:
                raise J2kError("codestream cut short after an unknown marker")
            if b[0] == 0xFF and b[1] in _KNOWN:
                return pos
            pos += 2

    def _siz(self, s: bytes) -> None:
        if len(s) < 36:
            raise J2kError("SIZ cut short")
        (_, self.x1, self.y1, self.x0, self.y0, self.tdx, self.tdy, self.tx0, self.ty0,
         n) = struct.unpack_from(">HIIIIIIIIH", s)
        if n == 0 or len(s) - 36 != 3 * n:
            raise J2kError("SIZ: component count and segment length disagree")
        if self.x0 >= self.x1 or self.y0 >= self.y1:
            raise J2kError("SIZ: negative or zero image size")
        if self.tdx == 0 or self.tdy == 0:
            raise J2kError("SIZ: invalid tile size")
        if (self.tx0 > self.x0 or self.ty0 > self.y0 or self.tx0 + self.tdx <= self.x0
                or self.ty0 + self.tdy <= self.y0):
            raise J2kError("SIZ: illegal tile offset")
        self.ncomp = n
        self.prec, self.sgnd, self.dx, self.dy = [], [], [], []
        for c in range(n):
            ssiz, dx, dy = s[36 + 3 * c:39 + 3 * c]
            if (ssiz & 0x7F) + 1 > 31:
                raise J2kError(f"SIZ: {(ssiz & 0x7F) + 1}-bit samples (OpenJPEG reads up to 31)")
            if dx == 0 or dy == 0:
                raise J2kError("SIZ: a component subsampling of 0")
            self.prec.append((ssiz & 0x7F) + 1)
            self.sgnd.append(ssiz >> 7)
            self.dx.append(dx)
            self.dy.append(dy)
        self.tw = _ceildiv(self.x1 - self.tx0, self.tdx)
        self.th = _ceildiv(self.y1 - self.ty0, self.tdy)
        if self.tw * self.th > 65535:
            raise J2kError("SIZ: more than 65535 tiles")
        self.comp_bytes = 1 if n <= 256 else 2

    # -- COD / COC / QCD / QCC / RGN / POC
    def _spcod(self, s: bytes, prt: int, what: str) -> _Coding:
        if len(s) < 5:
            raise J2kError(f"{what} cut short")
        c = _Coding()
        c.prt = prt & 1
        c.numres = s[0] + 1
        if c.numres > 33:
            raise J2kError(f"{what}: {s[0]} decomposition levels (at most 32)")
        c.cblkw, c.cblkh, c.sty, c.qmfbid = s[1] + 2, s[2] + 2, s[3], s[4]
        if c.cblkw > 10 or c.cblkh > 10 or c.cblkw + c.cblkh > 12:
            raise J2kError(f"{what}: invalid code-block size")
        if c.sty & STY_HT:
            raise J2kError(f"{what}: HTJ2K code-blocks (Part 15) are not read")
        if c.qmfbid > 1:
            raise J2kError(f"{what}: invalid wavelet {c.qmfbid}")
        if c.prt:
            if len(s) != 5 + c.numres:
                raise J2kError(f"{what}: precinct sizes and segment length disagree")
            c.prc = []
            for i, b in enumerate(s[5:5 + c.numres]):
                if i and (b & 15 == 0 or b >> 4 == 0):
                    raise J2kError(f"{what}: invalid precinct size")
                c.prc.append((b & 15, b >> 4))
        else:
            if len(s) != 5:
                raise J2kError(f"{what}: segment length")
            c.prc = [(15, 15)] * c.numres
        return c

    def _sqcd(self, s: bytes, what: str, old: Optional[_Quant]) -> _Quant:
        if len(s) < 1:
            raise J2kError(f"{what} cut short")
        q = _Quant()
        q.style, q.guard = s[0] & 0x1F, s[0] >> 5
        q.roishift = old.roishift if old else 0
        steps = list(old.steps) if old else [(0, 0)] * 97
        rest = s[1:]
        if q.style == 0:
            for i, b in enumerate(rest[:97]):
                steps[i] = (b >> 3, 0)
            used = len(rest)
        else:  # 1 scalar derived; 2 expounded, and OpenJPEG reads any other style so
            n = 1 if q.style == 1 else len(rest) // 2
            if len(rest) < 2 * n:
                raise J2kError(f"{what} cut short")
            for i in range(min(n, 97)):
                v = rest[2 * i] << 8 | rest[2 * i + 1]
                steps[i] = (v >> 11, v & 0x7FF)
            used = 2 * n
            if q.style == 1:
                e0, m0 = steps[0]
                for b in range(1, 97):
                    steps[b] = (max(e0 - (b - 1) // 3, 0), m0)
        if used != len(rest):
            raise J2kError(f"{what}: segment length")
        q.steps = steps
        return q

    def _header_marker(self, marker: int, s: bytes, t: _TileParams) -> None:
        n = self.ncomp
        if marker == COD:
            if t.cod:
                raise J2kError("a second COD marker in one header")
            t.cod = True
            if len(s) < 5:
                raise J2kError("COD cut short")
            t.csty, t.prg, t.layers, t.mct = s[0], s[1], s[2] << 8 | s[3], s[4]
            if t.csty & ~7:
                raise J2kError(f"COD: unknown Scod {t.csty:#x}")
            if t.prg > CPRL:
                raise J2kError(f"COD: unknown progression order {t.prg}")
            if t.layers < 1:
                raise J2kError("COD: invalid number of layers")
            if t.mct > 1:
                raise J2kError(f"COD: invalid multiple component transformation {t.mct}")
            c = self._spcod(s[5:], t.csty, "COD")
            t.coding = [c.copy() for _ in range(n)]
        elif marker == COC:
            k = self.comp_bytes
            if len(s) < k + 1:
                raise J2kError("COC cut short")
            comp = int.from_bytes(s[:k], "big")
            if comp >= n:
                raise J2kError(f"COC for component {comp} of {n}")
            t.coding[comp] = self._spcod(s[k + 1:], s[k], "COC")
        elif marker == QCD:
            q = self._sqcd(s, "QCD", t.quant[0])
            t.quant = [self._with_roi(q, t.quant[c]) for c in range(n)]
        elif marker == QCC:
            k = self.comp_bytes
            comp = int.from_bytes(s[:k], "big") if len(s) >= k else n
            if comp >= n:
                raise J2kError(f"QCC for component {comp} of {n}")
            t.quant[comp] = self._sqcd(s[k:], "QCC", t.quant[comp])
        elif marker == RGN:
            k = self.comp_bytes
            if len(s) != 2 + k:
                raise J2kError("RGN of a bad length")
            comp = int.from_bytes(s[:k], "big")
            if comp >= n:
                raise J2kError(f"RGN for component {comp} of {n}")
            if t.quant[comp] is None:
                t.quant[comp] = _Quant()
                t.quant[comp].style, t.quant[comp].guard, t.quant[comp].steps = 0, 0, [(0, 0)] * 97
            t.quant[comp].roishift = s[k + 1]
        elif marker == POC:
            k = self.comp_bytes
            size = 5 + 2 * k
            count = len(s) // size
            if count == 0 or len(s) % size:
                raise J2kError("POC of a bad length")
            if len(t.pocs) + count >= 32:
                raise J2kError("more than 32 POC entries")
            for i in range(count):
                e = s[i * size:(i + 1) * size]
                rs, cs = e[0], int.from_bytes(e[1:1 + k], "big")
                lye = e[1 + k] << 8 | e[2 + k]
                re, ce, prg = e[3 + k], int.from_bytes(e[4 + k:4 + 2 * k], "big"), e[4 + 2 * k]
                t.pocs.append((rs, cs, lye, re, min(ce, n), prg))
        # COM, TLM, PLM, PLT, CRG: read past

    @staticmethod
    def _with_roi(q: _Quant, old: Optional[_Quant]) -> _Quant:
        q = q.copy()
        q.roishift = old.roishift if old else 0
        return q

    def _tile_parts(self, pos: int) -> None:
        """SOT ... SOD data, up to EOC, as opj_j2k_read_tile_header and
        opj_j2k_read_sod take them (strict: a stream cut short raises)."""
        blob = self.blob
        ntiles = self.tw * self.th
        parts_seen: Dict[int, int] = {}
        parts_total: Dict[int, int] = {}
        while True:
            marker, pos = self._marker(pos)
            if marker == EOC:
                return
            if marker != SOT:
                raise J2kError(f"marker 0xFF{marker:02X} where SOT or EOC must come")
            if pos == len(blob):  # OpenJPEG's "no EOC": the tiles so far
                return self._cut_short(parts_seen, parts_total)
            sot_pos = pos - 2
            seg, pos = self._segment(pos, "SOT")
            if len(seg) != 8:
                raise J2kError("SOT of a bad length")
            tile, psot, tpsot, tnsot = struct.unpack(">HIBB", seg)
            if tile >= ntiles:
                raise J2kError(f"SOT for tile {tile} of {ntiles}")
            if psot and psot < 14:
                if psot != 12:
                    raise J2kError(f"SOT: Psot {psot}")
            expected = parts_seen.get(tile, 0)
            if tpsot != expected:
                raise J2kError(f"SOT: tile-part {tpsot} of tile {tile} where {expected} must come")
            if tile in parts_total and parts_total[tile] and tpsot >= parts_total[tile]:
                raise J2kError(f"SOT: tile-part {tpsot} of tile {tile} of {parts_total[tile]}")
            if tnsot:
                if parts_total.get(tile) and parts_total[tile] != tnsot:
                    raise J2kError(f"SOT: TNsot {tnsot} for tile {tile} after {parts_total[tile]}")
                parts_total[tile] = tnsot
            parts_seen[tile] = expected + 1
            end = sot_pos + psot if psot else len(blob) - 2
            if end > len(blob):
                raise J2kError("codestream cut short (a tile-part past the end)")
            if tile not in self.tiles:
                self.tiles[tile] = self.default.copy()
                self.tiles[tile].cod = False
            t = self.tiles[tile]
            while True:
                marker, pos = self._marker(pos)
                if marker == SOD:
                    break
                if pos == len(blob):
                    return self._cut_short(parts_seen, parts_total)
                if marker == PPT and self.ppm is not None:
                    raise J2kError("a PPT marker after PPM markers")
                if marker in _PART2:
                    raise J2kError(f"Part 2 marker {_PART2[marker]} (0xFF{marker:02X})")
                if marker not in _TILE_ONLY | _BOTH:
                    raise J2kError(f"marker 0xFF{marker:02X} out of place in a tile-part header")
                seg, pos = self._segment(pos, f"0xFF{marker:02X}")
                if pos > end:
                    raise J2kError("a tile-part header longer than its Psot")
                if marker == PPT:
                    self._packed_segment(self.ppt.setdefault(tile, {}), seg, "PPT")
                else:
                    self._header_marker(marker, seg, t)
            if pos > end:
                raise J2kError("a tile-part header longer than its Psot")
            self.tile_data.setdefault(tile, []).append(blob[pos:end])
            pos = end

    def _cut_short(self, seen: Dict[int, int], total: Dict[int, int]) -> None:
        """A codestream that ends just after a marker: OpenJPEG decodes the
        tiles read so far (the rest stay 0), unless one of them lacks
        tile-parts its TNsot promised."""
        for tile in self.tile_data:
            if total.get(tile) and seen[tile] < total[tile]:
                raise J2kError(f"codestream cut short inside tile {tile}'s tile-parts")


# ---- tier-2 -----------------------------------------------------------------------------

class _Packed:
    """Packed packet headers (PPM for the codestream, PPT for a tile) and how
    far the packets have read them."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 0


class _Bits:
    """opj_bio: packet-header bits, MSB first, a 0 stuffed after 0xFF, zeros
    past the end."""
    __slots__ = ("data", "pos", "end", "buf", "ct")

    def __init__(self, data: bytes, pos: int, end: int):
        self.data, self.pos, self.end, self.buf, self.ct = data, pos, end, 0, 0

    def _byte_in(self) -> bool:
        self.buf = (self.buf << 8) & 0xFFFF
        self.ct = 7 if self.buf == 0xFF00 else 8
        if self.pos >= self.end:
            return False
        self.buf |= self.data[self.pos]
        self.pos += 1
        return True

    def bit(self) -> int:
        if self.ct == 0:
            self._byte_in()
        self.ct -= 1
        return (self.buf >> self.ct) & 1

    def read(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = v << 1 | self.bit()
        return v

    def align(self) -> bool:
        if (self.buf & 0xFF) == 0xFF and not self._byte_in():
            return False
        self.ct = 0
        return True


class _TagTree:
    """opj_tgt over w x h leaves (the parent links shared between trees of
    one size)."""
    _parents: Dict[Tuple[int, int], List[int]] = {}

    def __init__(self, w: int, h: int):
        parents = self._parents.get((w, h))
        if parents is None:
            parents = self._parents[(w, h)] = self._links(w, h)
        self.parent = parents
        self.value = [999] * len(parents)
        self.low = [0] * len(parents)

    @staticmethod
    def _links(w: int, h: int) -> List[int]:
        parents: List[int] = []
        sizes = []
        while True:
            sizes.append((w, h))
            if w * h <= 1:
                break
            w, h = (w + 1) // 2, (h + 1) // 2
        base = 0
        for lvl, (lw, lh) in enumerate(sizes):
            nxt = base + lw * lh
            for j in range(lh):
                for i in range(lw):
                    if lvl + 1 < len(sizes):
                        parents.append(nxt + (j // 2) * sizes[lvl + 1][0] + i // 2)
                    else:
                        parents.append(-1)
            base = nxt
        return parents

    def decode(self, bits: _Bits, leaf: int, threshold: int) -> bool:
        stack = []
        node = leaf
        while self.parent[node] >= 0:
            stack.append(node)
            node = self.parent[node]
        low = 0
        value, lows = self.value, self.low
        while True:
            if low > lows[node]:
                lows[node] = low
            else:
                low = lows[node]
            while low < threshold and low < value[node]:
                if bits.bit():
                    value[node] = low
                else:
                    low += 1
            lows[node] = low
            if not stack:
                break
            node = stack.pop()
        return value[node] < threshold


class _Cblk:
    __slots__ = ("x0", "y0", "x1", "y1", "numbps", "lenbits", "segs", "chunks")

    def __init__(self, x0, y0, x1, y1):
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        self.numbps = 0
        self.lenbits = 3
        self.segs: List[List[int]] = []  # [maxpasses, passes, length]
        self.chunks: List[Tuple[int, int, int]] = []  # (part, start, length)


class _Band:
    __slots__ = ("bandno", "x0", "y0", "x1", "y1", "numbps", "step", "precincts", "cbw", "cbh",
                 "pw", "cbgx", "cbgy", "cbgw", "cbgh")


class _Res:
    __slots__ = ("x0", "y0", "x1", "y1", "pdx", "pdy", "pw", "ph", "bands")


def _seg_maxpasses(sty: int, prev: Optional[int]) -> int:
    """opj_t2_init_seg."""
    if sty & STY_TERMALL:
        return 1
    if sty & STY_LAZY:
        if prev is None:
            return 10
        return 2 if prev in (1, 10) else 1
    return 109


class _Tile:
    """One tile: its geometry as opj_tcd_init_tile lays it out, its packets
    and the code-blocks they fill."""

    def __init__(self, cs: _Codestream, index: int, params: _TileParams, parts: List[bytes]):
        self.cs, self.t, self.parts = cs, params, parts
        p, q = index % cs.tw, index // cs.tw
        self.x0 = max(cs.tx0 + p * cs.tdx, cs.x0)
        self.y0 = max(cs.ty0 + q * cs.tdy, cs.y0)
        self.x1 = min(cs.tx0 + (p + 1) * cs.tdx, cs.x1)
        self.y1 = min(cs.ty0 + (q + 1) * cs.tdy, cs.y1)
        self.comps = []
        for c in range(cs.ncomp):
            cod, quant = params.coding[c], params.quant[c]
            if cod is None or quant is None:
                raise J2kError(f"no COD / QCD for component {c}")
            tcx0, tcy0 = _ceildiv(self.x0, cs.dx[c]), _ceildiv(self.y0, cs.dy[c])
            tcx1, tcy1 = _ceildiv(self.x1, cs.dx[c]), _ceildiv(self.y1, cs.dy[c])
            self.comps.append(((tcx0, tcy0, tcx1, tcy1), self._resolutions(c, tcx0, tcy0, tcx1,
                                                                            tcy1, cod, quant)))

    def _resolutions(self, c, tcx0, tcy0, tcx1, tcy1, cod: _Coding, quant: _Quant) -> List[_Res]:
        out = []
        prec = self.cs.prec[c]
        nres = cod.numres
        for r in range(nres):
            lvl = nres - 1 - r
            res = _Res()
            res.x0, res.y0 = -(-tcx0 >> lvl), -(-tcy0 >> lvl)
            res.x1, res.y1 = -(-tcx1 >> lvl), -(-tcy1 >> lvl)
            res.pdx, res.pdy = cod.prc[r]
            px0 = (res.x0 >> res.pdx) << res.pdx
            py0 = (res.y0 >> res.pdy) << res.pdy
            px1 = (-(-res.x1 >> res.pdx)) << res.pdx
            py1 = (-(-res.y1 >> res.pdy)) << res.pdy
            res.pw = 0 if res.x0 == res.x1 else (px1 - px0) >> res.pdx
            res.ph = 0 if res.y0 == res.y1 else (py1 - py0) >> res.pdy
            if r == 0:
                cbgx, cbgy, cbgw, cbgh = px0, py0, res.pdx, res.pdy
            else:
                cbgx, cbgy, cbgw, cbgh = -(-px0 >> 1), -(-py0 >> 1), res.pdx - 1, res.pdy - 1
            cbw, cbh = min(cod.cblkw, cbgw), min(cod.cblkh, cbgh)
            res.bands = []
            for b in ((0,) if r == 0 else (1, 2, 3)):
                band = _Band()
                band.bandno = b
                if r == 0:
                    band.x0, band.y0, band.x1, band.y1 = res.x0, res.y0, res.x1, res.y1
                else:
                    xb, yb = b & 1, b >> 1
                    band.x0 = -(-(tcx0 - (xb << lvl)) >> (lvl + 1))
                    band.y0 = -(-(tcy0 - (yb << lvl)) >> (lvl + 1))
                    band.x1 = -(-(tcx1 - (xb << lvl)) >> (lvl + 1))
                    band.y1 = -(-(tcy1 - (yb << lvl)) >> (lvl + 1))
                step_index = 0 if r == 0 else 3 * (r - 1) + b
                expn, mant = quant.steps[step_index]
                gain = 0 if cod.qmfbid == 0 or b == 0 else (2 if b == 3 else 1)
                band.step = np.float32((1.0 + mant / 2048.0) * 2.0 ** (prec + gain - expn))
                band.numbps = expn + quant.guard - 1
                band.cbw, band.cbh = cbw, cbh
                band.pw, band.cbgx, band.cbgy, band.cbgw, band.cbgh = res.pw, cbgx, cbgy, cbgw, cbgh
                band.precincts = {}
                res.bands.append(band)
            out.append(res)
        return out

    @staticmethod
    def _precinct(band: _Band, precno: int):
        """The precinct's code-blocks and tag trees, made on first use."""
        prc = band.precincts.get(precno)
        if prc is None:
            gx = band.cbgx + (precno % band.pw) * (1 << band.cbgw)
            gy = band.cbgy + (precno // band.pw) * (1 << band.cbgh)
            x0, y0 = max(gx, band.x0), max(gy, band.y0)
            x1, y1 = min(gx + (1 << band.cbgw), band.x1), min(gy + (1 << band.cbgh), band.y1)
            w, h = band.cbw, band.cbh
            bx0, by0 = (x0 >> w) << w, (y0 >> h) << h
            cw = max(((-(-x1 >> w)) << w) - bx0, 0) >> w if x1 > x0 else 0
            ch = max(((-(-y1 >> h)) << h) - by0, 0) >> h if y1 > y0 else 0
            cblks = []
            for j in range(ch):
                for i in range(cw):
                    cx, cy = bx0 + (i << w), by0 + (j << h)
                    cblks.append(_Cblk(max(cx, x0), max(cy, y0), min(cx + (1 << w), x1),
                                       min(cy + (1 << h), y1)))
            prc = [cblks, _TagTree(cw, ch), _TagTree(cw, ch)]
            band.precincts[precno] = prc
        return prc

    # -- packet iteration (OpenJPEG's pi.c)
    def packets(self):
        cs, t = self.cs, self.t
        ncomp = cs.ncomp
        nres_max = max(len(r) for _, r in self.comps)
        if t.pocs:
            entries = [(rs, cs_, min(lye, t.layers), re, ce, prg)
                       for rs, cs_, lye, re, ce, prg in t.pocs]
        else:
            entries = [(0, 0, t.layers, nres_max, ncomp, t.prg)]
        seen = set()
        for rs, c0, ly1, re, c1, prg in entries:
            if c0 >= ncomp or c1 > ncomp:
                raise J2kError("POC: component range outside the image")
            if prg > CPRL:
                continue
            for key in self._order(prg, rs, re, c0, c1, ly1):
                if key not in seen:
                    seen.add(key)
                    yield key

    def _res(self, c: int, r: int) -> _Res:
        return self.comps[c][1][r]

    def _order(self, prg, r0, r1, c0, c1, l1):
        comps = self.comps
        if prg in (LRCP, RLCP):
            outer = ((l, r) for l in range(l1) for r in range(r0, r1)) if prg == LRCP else \
                ((l, r) for r in range(r0, r1) for l in range(l1))
            for l, r in outer:
                for c in range(c0, c1):
                    if r >= len(comps[c][1]):
                        continue
                    res = comps[c][1][r]
                    for p in range(res.pw * res.ph):
                        yield (l, r, c, p)
            return
        if prg == CPRL:
            for c in range(c0, c1):
                steps = self._steps([c])
                if steps is None:
                    return
                for y, x in self._positions(*steps):
                    for r in range(r0, min(r1, len(comps[c][1]))):
                        p = self._precno(c, r, x, y)
                        if p is not None:
                            for l in range(l1):
                                yield (l, r, c, p)
            return
        steps = self._steps(range(len(comps)))
        if steps is None:
            return
        if prg == RPCL:
            for r in range(r0, r1):
                for y, x in self._positions(*steps):
                    for c in range(c0, c1):
                        if r >= len(comps[c][1]):
                            continue
                        p = self._precno(c, r, x, y)
                        if p is not None:
                            for l in range(l1):
                                yield (l, r, c, p)
        else:  # PCRL
            for y, x in self._positions(*steps):
                for c in range(c0, c1):
                    for r in range(r0, min(r1, len(comps[c][1]))):
                        p = self._precno(c, r, x, y)
                        if p is not None:
                            for l in range(l1):
                                yield (l, r, c, p)

    def _steps(self, comps):
        dx = dy = 0
        for c in comps:
            res = self.comps[c][1]
            n = len(res)
            for r, rr in enumerate(res):
                ex, ey = rr.pdx + n - 1 - r, rr.pdy + n - 1 - r
                if ex < 32:
                    v = self.cs.dx[c] << ex
                    dx = v if not dx else min(dx, v)
                if ey < 32:
                    v = self.cs.dy[c] << ey
                    dy = v if not dy else min(dy, v)
        return None if not dx or not dy else (dx, dy)

    def _positions(self, dx, dy):
        y = self.y0
        while y < self.y1:
            x = self.x0
            while x < self.x1:
                yield y, x
                x += dx - x % dx
            y += dy - y % dy

    def _precno(self, c, r, x, y) -> Optional[int]:
        res_list = self.comps[c][1]
        res = res_list[r]
        lvl = len(res_list) - 1 - r
        cdx, cdy = self.cs.dx[c], self.cs.dy[c]
        trx0, try0 = _ceildiv(self.x0, cdx << lvl), _ceildiv(self.y0, cdy << lvl)
        trx1, try1 = _ceildiv(self.x1, cdx << lvl), _ceildiv(self.y1, cdy << lvl)
        rpx, rpy = res.pdx + lvl, res.pdy + lvl
        if not (y % (cdy << rpy) == 0 or (y == self.y0 and (try0 << lvl) % (1 << rpy))):
            return None
        if not (x % (cdx << rpx) == 0 or (x == self.x0 and (trx0 << lvl) % (1 << rpx))):
            return None
        if res.pw == 0 or res.ph == 0 or trx0 == trx1 or try0 == try1:
            return None
        prci = (_ceildiv(x, cdx << lvl) >> res.pdx) - (trx0 >> res.pdx)
        prcj = (_ceildiv(y, cdy << lvl) >> res.pdy) - (try0 >> res.pdy)
        return prci + prcj * res.pw

    # -- packets
    def read_packets(self, packed: Optional["_Packed"] = None, spans: Optional[list] = None) -> None:
        """Every packet in the tile's order: its header from the tile's data,
        or from `packed` (PPT / PPM) headers, its body from the tile's data.
        `spans` collects each in-stream header's (start, end)."""
        data = b"".join(self.parts)
        self.data = data
        pos, end = 0, len(data)
        sop, eph = self.t.csty & 2, self.t.csty & 4
        for l, r, c, p in self.packets():
            res = self._res(c, r)
            sty = self.t.coding[c].sty
            if sop and end - pos >= 6 and data[pos] == 0xFF and data[pos + 1] == 0x91:
                pos += 6
            bands = [b for b in res.bands if b.x1 > b.x0 and b.y1 > b.y0]
            precs = [self._precinct(b, p) for b in bands]
            if l == 0:
                for prc in precs:
                    prc[1].value = [999] * len(prc[1].value)
                    prc[1].low = [0] * len(prc[1].low)
                    prc[2].value = [999] * len(prc[2].value)
                    prc[2].low = [0] * len(prc[2].low)
                    for cb in prc[0]:
                        cb.segs = []
                        cb.chunks = []
            hdata, hpos = (packed.data, packed.pos) if packed else (data, pos)
            bits = _Bits(hdata, hpos, len(hdata) if packed else end)
            news = []
            if bits.bit():
                for band, prc in zip(bands, precs):
                    self._header_cblks(bits, band, prc, l, sty, news)
                if not bits.align():
                    raise J2kError("packet header ends on 0xFF at the end of its data")
            else:
                bits.align()
            hend = self._eph(hdata, bits.pos) if eph else bits.pos
            if packed:
                packed.pos = hend
            else:
                if spans is not None:
                    spans.append((pos, hend))
                pos = hend
            for cb, contrib in news:
                for segno, k, length in contrib:
                    if pos + length > end:
                        raise J2kError("a code-block segment runs past its tile's data")
                    cb.chunks.append((pos, length))
                    cb.segs[segno][1] += k
                    cb.segs[segno][2] += length
                    pos += length

    def _header_cblks(self, bits: _Bits, band: _Band, prc, l: int, sty: int, news: list) -> None:
        """One band's code-blocks in a packet header (opj_t2_read_packet_header)."""
        for i, cb in enumerate(prc[0]):
            if not cb.segs:
                included = prc[1].decode(bits, i, l + 1)
            else:
                included = bits.bit()
            if not included:
                continue
            if not cb.segs:
                zbp = 0
                while not prc[2].decode(bits, i, zbp):
                    zbp += 1
                cb.numbps = band.numbps + 1 - zbp
                cb.lenbits = 3
            n = self._numpasses(bits)
            while bits.bit():
                cb.lenbits += 1
            if not cb.segs:
                cb.segs.append([_seg_maxpasses(sty, None), 0, 0])
                segno = 0
            else:
                segno = len(cb.segs) - 1
                if cb.segs[segno][1] == cb.segs[segno][0]:
                    cb.segs.append([_seg_maxpasses(sty, cb.segs[segno][0]), 0, 0])
                    segno += 1
            contrib = []
            while True:
                seg = cb.segs[segno]
                k = min(seg[0] - seg[1], n)
                nbits = cb.lenbits + (k.bit_length() - 1 if k > 0 else 0)
                if nbits > 32:
                    raise J2kError("packet header: a code-block length of over 32 bits")
                contrib.append((segno, k, bits.read(nbits)))
                n -= k
                if n <= 0:
                    break
                cb.segs.append([_seg_maxpasses(sty, seg[0]), 0, 0])
                segno += 1
            news.append((cb, contrib))

    @staticmethod
    def _eph(data: bytes, pos: int) -> int:
        if data[pos:pos + 2] != b"\xff\x92":
            raise J2kError("a packet header without its EPH marker")
        return pos + 2

    @staticmethod
    def _numpasses(bits: _Bits) -> int:
        if not bits.bit():
            return 1
        if not bits.bit():
            return 2
        n = bits.read(2)
        if n != 3:
            return 3 + n
        n = bits.read(5)
        if n != 31:
            return 6 + n
        return 37 + bits.read(7)

    # -- tier-1 onwards
    def component(self, c: int) -> np.ndarray:
        """The tile-component after tier-1 and the inverse wavelet: int32
        (5/3) or float32 (9/7), [height, width]."""
        from wast3d_tpu_torch import native

        (tcx0, tcy0, tcx1, tcy1), res_list = self.comps[c]
        cod, quant = self.t.coding[c], self.t.quant[c]
        reversible = cod.qmfbid == 1
        w, h = tcx1 - tcx0, tcy1 - tcy0
        out = np.zeros((h, w), np.int32 if reversible else np.float32)
        cblks, segs, steps, pieces = [], [], [], []
        offset = 0
        for r, res in enumerate(res_list):
            for band in res.bands:
                for prc in band.precincts.values():
                    for cb in prc[0]:
                        if not cb.segs:
                            continue
                        x = cb.x0 - band.x0
                        y = cb.y0 - band.y0
                        if band.bandno & 1:
                            x += res_list[r - 1].x1 - res_list[r - 1].x0
                        if band.bandno & 2:
                            y += res_list[r - 1].y1 - res_list[r - 1].y0
                        first = len(segs) // 3
                        chunk = b"".join(self.data[s:s + n] for s, n in cb.chunks)
                        pieces.append(chunk)
                        o = offset
                        for _, passes, length in cb.segs:
                            segs += (o, length, passes)
                            o += length
                        offset += len(chunk)
                        cblks += (x, y, cb.x1 - cb.x0, cb.y1 - cb.y0, band.bandno, cod.sty,
                                  cb.numbps + quant.roishift, quant.roishift, first,
                                  len(cb.segs))
                        steps.append(np.float32(0.5) * band.step)
        if cblks:
            try:
                native.j2k_t1(b"".join(pieces), np.array(cblks, np.int32),
                              np.array(segs, np.int32), np.array(steps, np.float32), out,
                              reversible, "tier-1")
            except ValueError as e:
                raise J2kError(str(e)) from None
        rects = np.array([(r.x0, r.y0, r.x1, r.y1) for r in res_list], np.int32)
        native.j2k_idwt(out, rects, reversible)
        return out


def _decode_tiles(cs: _Codestream) -> Dict[int, List[np.ndarray]]:
    """Each tile with data: its components as int32 after the colour
    transform, the DC shift and the clamp (OpenJPEG's decoded tile)."""
    from wast3d_tpu_torch import native

    out = {}
    for index in cs.tile_data:
        tile = _Tile(cs, index, cs.tiles[index], cs.tile_data[index])
        ppt = cs.ppt.get(index)
        tile.read_packets(_Packed(b"".join(ppt[k] for k in sorted(ppt))) if ppt else cs.ppm)
        comps = [tile.component(c) for c in range(cs.ncomp)]
        if tile.t.mct:
            if cs.ncomp < 3:
                raise J2kError(f"a colour transform over {cs.ncomp} components")
            if not (comps[0].shape == comps[1].shape == comps[2].shape):
                raise J2kError("a colour transform over components of different sizes")
            native.j2k_mct(comps[0], comps[1], comps[2], tile.t.coding[0].qmfbid == 1)
        done = []
        for c, comp in enumerate(comps):
            prec, sgnd = cs.prec[c], cs.sgnd[c]
            lo, hi = (-(1 << (prec - 1)), (1 << (prec - 1)) - 1) if sgnd else (0, (1 << prec) - 1)
            done.append(native.j2k_level(comp, tile.t.coding[c].qmfbid == 1,
                                         0 if sgnd else 1 << (prec - 1), lo, hi))
        out[index] = (tile, done)
    return out


# ---- Pillow's unpackers -----------------------------------------------------------------

def _ycbcr_tables():
    """Pillow's Convert.c tables for YCbCr -> RGB: (int)(k * 64 * (i - 128)
    + 0.5), C's truncation."""
    i = np.arange(256, dtype=np.float64) - 128
    return tuple(np.trunc(k * 64 * i + 0.5).astype(np.int32)
                 for k in (1.40200, -0.34414, -0.71414, 1.77200))


def ycbcr_to_rgb(ycc: np.ndarray) -> np.ndarray:
    """Pillow's ImagingConvertYCbCr2RGB on uint8 [..., 3]."""
    r_cr, g_cb, g_cr, b_cb = _ycbcr_tables()
    y = ycc[..., 0].astype(np.int32)
    cb, cr = ycc[..., 1], ycc[..., 2]
    rgb = np.stack([y + (r_cr[cr] >> 6), y + ((g_cb[cb] + g_cr[cr]) >> 6), y + (b_cb[cb] >> 6)], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _csiz(prec: int) -> int:
    n = (prec + 7) >> 3
    return 4 if n == 3 else n


def _tile_buffer(cs: _Codestream, tile: _Tile, comps: List[np.ndarray]) -> np.ndarray:
    """The bytes opj_decode_tile_data writes for a tile (each component's
    samples in its size, one after the other), zero-padded to Pillow's
    buffer."""
    parts = []
    for c, comp in enumerate(comps):
        size = _csiz(cs.prec[c])
        dtype = {1: np.uint8, 2: "<u2", 4: "<u4"}[size]
        parts.append(comp.astype(np.int64).astype(np.uint32).astype(dtype).tobytes())
    raw = b"".join(parts)
    w, h = tile.x1 - tile.x0, tile.y1 - tile.y0
    total = sum(_csiz(p) for p in cs.prec) * w * h
    return np.frombuffer(raw + bytes(max(total - len(raw), 0)), np.uint8)


def _words(buf: np.ndarray, start: int, size: int, index: np.ndarray) -> np.ndarray:
    """Little-endian `size`-byte words at byte `start` + `index` * size."""
    at = start + index * size
    v = buf[at].astype(np.uint32)
    for k in range(1, size):
        v |= buf[at + k].astype(np.uint32) << (8 * k)
    return v


def _shift(word: np.ndarray, prec: int, sgnd: int, bits: int) -> np.ndarray:
    """j2ku_shift(offset + word, shift) as Pillow computes it, cut to
    `bits`."""
    shift = bits - prec
    offset = (1 << (prec - 1)) if sgnd else 0
    if shift < 0:
        offset += 1 << (-shift - 1)
    v = (word.astype(np.uint64) + offset) & 0xFFFFFFFF
    v = v >> -shift if shift < 0 else (v << shift) & 0xFFFFFFFF
    return (v & ((1 << bits) - 1)).astype(np.uint16 if bits == 16 else np.uint8)


def _unpack(kind: str, cs: _Codestream, tile: _Tile, comps: List[np.ndarray]) -> np.ndarray:
    """Pillow's unpacker `kind` on one tile -> its pixels as PIL stores them
    (4 bytes a pixel, [h, w, 4] uint8, or [h, w] uint16 for I;16)."""
    w, h = tile.x1 - tile.x0, tile.y1 - tile.y0
    if (kind in ("srgb_rgb", "srgba_rgba") and set(cs.prec) == {8} and not any(cs.sgnd)
            and set(cs.dx) | set(cs.dy) == {1}):  # 8-bit unsigned samples: Pillow copies them
        out = np.full((h, w, 4), 255, np.uint8)
        n = 4 if kind == "srgba_rgba" else 3
        out[..., :n] = np.stack(comps[:n], -1)
        return out
    buf = _tile_buffer(cs, tile, comps)
    yy, xx = np.mgrid[0:h, 0:w]
    if kind == "gray_i":
        return _shift(_words(buf, 0, _csiz(cs.prec[0]), yy * w + xx), cs.prec[0], cs.sgnd[0], 16)
    out = np.zeros((h, w, 4), np.uint8)
    if kind in ("gray_l", "gray_rgb"):
        v = _shift(_words(buf, 0, _csiz(cs.prec[0]), yy * w + xx), cs.prec[0], cs.sgnd[0], 8)
        out[..., 0] = out[..., 1] = out[..., 2] = v
        out[..., 3] = 255 if kind == "gray_rgb" else 0
        return out
    if kind == "graya_la":
        s0, s1 = _csiz(cs.prec[0]), _csiz(cs.prec[1])
        v = _shift(_words(buf, 0, s0, yy * w + xx), cs.prec[0], cs.sgnd[0], 8)
        a = _shift(_words(buf, s0 * w * h, s1, yy * w + xx), cs.prec[1], cs.sgnd[1], 8)
        out[..., 0] = out[..., 1] = out[..., 2] = v
        out[..., 3] = a
        return out
    n = 4 if kind in ("srgba_rgba", "sycca_rgba") else 3
    start = 0
    for c in range(n):
        size, dx, dy = _csiz(cs.prec[c]), cs.dx[c], cs.dy[c]
        index = (yy // dy) * (w // dx) + xx // dx
        out[..., c] = _shift(_words(buf, start, size, index), cs.prec[c], cs.sgnd[c], 8)
        start += size * (w // dx) * (h // dy)
    if n == 3:
        out[..., 3] = 255
    if kind.startswith("sycc"):
        out[..., :3] = ycbcr_to_rgb(out[..., :3])
    return out


_BANDS = {"L": [0], "P": [0], "I;16": None, "I;16B": None, "LA": [0, 3], "PA": [0, 3],
          "RGB": [0, 1, 2], "RGBA": [0, 1, 2, 3], "CMYK": [0, 1, 2, 3]}


def pil_mode(blob: bytes, name: str = "<bytes>") -> str:
    """The mode PIL opens a J2K / JP2 file in."""
    try:
        return _pil_header(blob)[1]
    except J2kError as e:
        raise ValueError(f"{name}: {e} (PIL's JPEG 2000 reader refuses it)") from None


def decode_jpeg2000(blob: bytes, name: str = "<bytes>") -> np.ndarray:
    """`np.asarray(PIL.Image.open(f))` of a J2K codestream or JP2 file."""
    from wast3d_tpu_torch.utils.image_io import _check_pixels

    try:
        (width, height), mode = _pil_header(blob)
        _check_pixels(width, height, name)
        if blob[:4] == J2K_SIGNATURE:
            start, space = 0, UNSPECIFIED
        else:
            start, space = _jp2_boxes(blob)
        cs = _Codestream(blob, start)
        if (width, height) != (cs.x1 - cs.x0, cs.y1 - cs.y0):
            raise J2kError(f"the JP2 header's {width}x{height} is not the codestream's "
                           f"{cs.x1 - cs.x0}x{cs.y1 - cs.y0}")
        if not 1 <= cs.ncomp <= 4:
            raise J2kError(f"{cs.ncomp} components: PIL has no unpacker")
        sub = next((c for c in range(cs.ncomp) if cs.dx[c] != 1 or cs.dy[c] != 1), -1)
        if space in (UNSPECIFIED, UNKNOWN):
            space = GRAY if cs.ncomp <= 2 else SYCC if sub in (1, 2) else SRGB
        kind = next((k for m, s, n, subs, k in _UNPACKERS
                     if s == space and n == cs.ncomp and (sub == -1 or subs) and m == mode), None)
        if kind is None:
            raise J2kError(f"no Pillow unpacker for mode {mode}, {cs.ncomp} components, "
                           f"colour space {space}")
        tiles = _decode_tiles(cs)
        img = np.zeros((height, width) if mode.startswith("I;16") else (height, width, 4),
                       np.uint16 if mode.startswith("I;16") else np.uint8)
        for tile, comps in tiles.values():
            x0, y0 = tile.x0 - cs.x0, tile.y0 - cs.y0
            if (tile.x0 >= tile.x1 or tile.y0 >= tile.y1 or x0 < 0 or y0 < 0
                    or tile.x1 - cs.x0 > width or tile.y1 - cs.y0 > height):
                raise J2kError("a tile outside the image PIL opened")
            img[y0:y0 + tile.y1 - tile.y0, x0:x0 + tile.x1 - tile.x0] = _unpack(kind, cs, tile,
                                                                                 comps)
    except J2kError as e:
        raise ValueError(f"{name}: {e} (PIL's JPEG 2000 reader refuses it)") from None
    bands = _BANDS[mode]
    if bands is None:
        return img.astype("<u2")
    return img[..., bands[0]] if len(bands) == 1 else np.ascontiguousarray(img[..., bands])


# ---- plain versions of the native loops ------------------------------------------------

_QE = (0x5601, 0x3401, 0x1801, 0x0AC1, 0x0521, 0x0221, 0x5601, 0x5401, 0x4801, 0x3801, 0x3001,
       0x2401, 0x1C01, 0x1601, 0x5601, 0x5401, 0x5101, 0x4801, 0x3801, 0x3401, 0x3001, 0x2801,
       0x2401, 0x2201, 0x1C01, 0x1801, 0x1601, 0x1401, 0x1201, 0x1101, 0x0AC1, 0x09C1, 0x08A1,
       0x0521, 0x0441, 0x02A1, 0x0221, 0x0141, 0x0111, 0x0085, 0x0049, 0x0025, 0x0015, 0x0009,
       0x0005, 0x0001, 0x5601)
_NMPS = (1, 2, 3, 4, 5, 38, 7, 8, 9, 10, 11, 12, 13, 29, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24,
         25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 45, 46)
_NLPS = (1, 6, 9, 12, 29, 33, 6, 14, 14, 14, 17, 18, 20, 21, 14, 14, 15, 16, 17, 18, 19, 19, 20,
         21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42,
         43, 46)
_SWITCH = {0, 6, 14}


class _Mq:
    """The MQ decoder (ISO/IEC 15444-1 Annex C) and the bypass bit reader,
    over a segment followed by two 0xFF bytes."""

    def __init__(self, seg: bytes, raw: bool):
        self.buf, self.bp = seg + b"\xff\xff", 0
        if raw:
            self.c = self.ct = 0
            return
        self.c = self.buf[0] << 16
        self._byte_in()
        self.c = (self.c << 7) & 0xFFFFFFFF
        self.ct -= 7
        self.a = 0x8000

    def _byte_in(self):
        if self.buf[self.bp] == 0xFF:
            if self.buf[self.bp + 1] > 0x8F:
                self.c += 0xFF00
                self.ct = 8
            else:
                self.bp += 1
                self.c += self.buf[self.bp] << 9
                self.ct = 7
        else:
            self.bp += 1
            self.c += self.buf[self.bp] << 8
            self.ct = 8

    def _renorm(self):
        while True:
            if self.ct == 0:
                self._byte_in()
            self.a = (self.a << 1) & 0xFFFFFFFF
            self.c = (self.c << 1) & 0xFFFFFFFF
            self.ct -= 1
            if self.a & 0x8000:
                return

    def decode(self, ctx: List[int], cx: int) -> int:
        state, mps = ctx[2 * cx], ctx[2 * cx + 1]
        qe = _QE[state]
        self.a -= qe
        if (self.c >> 16) < qe:
            if self.a < qe:
                d, ctx[2 * cx] = mps, _NMPS[state]
            else:
                d, ctx[2 * cx] = 1 - mps, _NLPS[state]
                if state in _SWITCH:
                    ctx[2 * cx + 1] = 1 - mps
            self.a = qe
            self._renorm()
            return d
        self.c -= qe << 16
        if self.a & 0x8000:
            return mps
        if self.a < qe:
            d, ctx[2 * cx] = 1 - mps, _NLPS[state]
            if state in _SWITCH:
                ctx[2 * cx + 1] = 1 - mps
        else:
            d, ctx[2 * cx] = mps, _NMPS[state]
        self._renorm()
        return d

    def raw(self) -> int:
        if self.ct == 0:
            if self.c == 0xFF and self.buf[self.bp] > 0x8F:
                self.ct = 8
            else:
                self.ct = 7 if self.c == 0xFF else 8
                self.c = self.buf[self.bp]
                self.bp += 1
        self.ct -= 1
        return (self.c >> self.ct) & 1


def _fresh_contexts() -> List[int]:
    ctx = [0, 0] * 19
    ctx[2 * 18], ctx[2 * 17], ctx[0] = 46, 3, 4
    return ctx


def t1_reference(data: bytes, segments, width: int, height: int, band: int, style: int,
                 bpno_plus_one: int, roishift: int, step: Optional[float]) -> np.ndarray:
    """Tier-1 of one code-block, as `native.j2k_t1` decodes it: `segments`
    (length, passes) over `data`; int32 [height, width] (`step` None: the
    reversible path) or float32 (the sample times `step`)."""
    w, h = width, height
    val = [[0] * w for _ in range(h)]
    sig = [[0] * (w + 2) for _ in range(h + 2)]  # 0, or +1 / -1 by sign
    visit = [[False] * w for _ in range(h)]
    refined = [[False] * w for _ in range(h)]
    vsc = bool(style & STY_VSC)

    def south(y):
        return not (vsc and y % 4 == 3)

    def s(x, y):  # significance, 0 or 1, with a border
        return 1 if sig[y + 1][x + 1] else 0

    def zc(x, y):
        so = south(y)
        hh = s(x - 1, y) + s(x + 1, y)
        vv = s(x, y - 1) + (s(x, y + 1) if so else 0)
        dd = s(x - 1, y - 1) + s(x + 1, y - 1) + ((s(x - 1, y + 1) + s(x + 1, y + 1)) if so else 0)
        if band == 1:
            hh, vv = vv, hh
        if band == 3:
            hv = hh + vv
            if dd >= 3:
                return 8
            if dd == 2:
                return 7 if hv >= 1 else 6
            if dd == 1:
                return 5 if hv >= 2 else 4 if hv == 1 else 3
            return 2 if hv >= 2 else hv
        if hh == 2:
            return 8
        if hh == 1:
            return 7 if vv >= 1 else 6 if dd >= 1 else 5
        if vv:
            return 2 + vv
        return 2 if dd >= 2 else dd

    def neighbours(x, y):
        so = south(y)
        return any((s(x - 1, y - 1), s(x, y - 1), s(x + 1, y - 1), s(x - 1, y), s(x + 1, y))) or \
            (so and any((s(x - 1, y + 1), s(x, y + 1), s(x + 1, y + 1))))

    def sign(mq, ctx, x, y, oph):
        hc = max(-1, min(1, sig[y + 1][x] + sig[y + 1][x + 2]))
        vc = max(-1, min(1, sig[y][x + 1] + (sig[y + 2][x + 1] if south(y) else 0)))
        xor = 0
        if hc < 0 or (hc == 0 and vc < 0):
            hc, vc, xor = -hc, -vc, 1
        neg = mq.decode(ctx, 9 + (3 + vc if hc else vc)) ^ xor
        val[y][x] = -oph if neg else oph
        sig[y + 1][x + 1] = -1 if neg else 1

    def stripes():
        for k in range(0, h, 4):
            for x in range(w):
                for y in range(k, min(k + 4, h)):
                    yield x, y

    if bpno_plus_one >= 31:
        raise ValueError("a code-block of 31 or more bit-planes")
    numbps = bpno_plus_one - roishift
    passtype, offset, ctx = 2, 0, _fresh_contexts()
    for length, passes in segments:
        raw = bpno_plus_one <= numbps - 4 and passtype < 2 and bool(style & STY_LAZY)
        mq = _Mq(bytes(data[offset:offset + length]), raw)
        offset += length
        for _ in range(passes):
            if bpno_plus_one < 1:
                break
            one = 1 << bpno_plus_one
            oph, half = one | one >> 1, one >> 1
            if passtype == 0:
                for x, y in stripes():
                    if sig[y + 1][x + 1] or visit[y][x] or not neighbours(x, y):
                        continue
                    if raw:
                        if mq.raw():
                            neg = mq.raw()
                            val[y][x] = -oph if neg else oph
                            sig[y + 1][x + 1] = -1 if neg else 1
                    elif mq.decode(ctx, zc(x, y)):
                        sign(mq, ctx, x, y, oph)
                    visit[y][x] = True
            elif passtype == 1:
                for x, y in stripes():
                    if not sig[y + 1][x + 1] or visit[y][x]:
                        continue
                    if raw:
                        v = mq.raw()
                    else:
                        v = mq.decode(ctx, 16 if refined[y][x] else 15 if neighbours(x, y) else 14)
                    val[y][x] += half if v ^ (val[y][x] < 0) else -half
                    refined[y][x] = True
            else:
                for k in range(0, h, 4):
                    for x in range(w):
                        y, end = k, min(k + 4, h)
                        if k + 3 < h and all(not sig[j + 1][x + 1] and not visit[j][x]
                                             and not neighbours(x, j) for j in range(k, k + 4)):
                            if not mq.decode(ctx, 17):
                                continue
                            r = mq.decode(ctx, 18) << 1
                            r |= mq.decode(ctx, 18)
                            y = k + r
                            sign(mq, ctx, x, y, oph)
                            y += 1
                        for y in range(y, end):
                            if not sig[y + 1][x + 1] and not visit[y][x] and mq.decode(ctx, zc(x, y)):
                                sign(mq, ctx, x, y, oph)
                visit = [[False] * w for _ in range(h)]
                if style & STY_SEGSYM:
                    for _ in range(4):
                        mq.decode(ctx, 18)
            if style & STY_RESET and not raw:
                ctx = _fresh_contexts()
            passtype += 1
            if passtype == 3:
                passtype, bpno_plus_one = 0, bpno_plus_one - 1
    out = np.array(val, np.int64).reshape(h, w)
    if roishift:
        mag = np.abs(out)
        out = np.where(mag >= (1 << roishift), np.sign(out) * (mag >> roishift), out) \
            if roishift < 31 else np.zeros_like(out)
    if step is None:
        return (np.sign(out) * (np.abs(out) // 2)).astype(np.int32)
    return out.astype(np.float32) * np.float32(step)


def _interleave(a: np.ndarray, sn: int, cas: int) -> np.ndarray:
    """Rows of `a` (sn low-pass samples, then high-pass) in coordinate
    order for a first coordinate of parity `cas`."""
    x = np.empty_like(a)
    x[:, cas::2] = a[:, :sn]
    x[:, 1 - cas::2] = a[:, sn:]
    return x


def _idwt_2d(buf: np.ndarray, rects: np.ndarray, line) -> np.ndarray:
    out = np.array(buf)
    for r in range(1, len(rects)):
        lx0, ly0, lx1, ly1 = rects[r - 1]
        x0, y0, x1, y1 = rects[r]
        rw, rh = x1 - x0, y1 - y0
        if rw <= 0 or rh <= 0:
            continue
        block = out[:rh, :rw]
        block = line(block, lx1 - lx0, x0 & 1)
        out[:rh, :rw] = line(block.T, ly1 - ly0, y0 & 1).T
    return out


def _line53(a: np.ndarray, sn: int, cas: int) -> np.ndarray:
    n = a.shape[1]
    if n == 1:
        return a if not cas else (np.sign(a) * (np.abs(a) // 2)).astype(a.dtype)
    x = _interleave(a, sn, cas).astype(np.int64)
    ext = np.r_[1, np.arange(n), n - 2]  # symmetric extension: x[-1] = x[1], x[n] = x[n-2]
    for start, fn in ((cas, lambda l, r: -((l + r + 2) >> 2)), (1 - cas, lambda l, r: (l + r) >> 1)):
        k = np.arange(start, n, 2)
        x[:, k] += fn(x[:, ext[k]], x[:, ext[k + 2]])
    return x.astype(np.int32)


def idwt53_reference(buf: np.ndarray, rects: np.ndarray) -> np.ndarray:
    """The inverse 5/3 of `native.j2k_idwt` on int32 [h, w] over the
    resolutions' (x0, y0, x1, y1), in numpy."""
    return _idwt_2d(np.asarray(buf, np.int32), np.asarray(rects), _line53)


_K = np.float32(1.230174105)
_TWO_INV_K = np.float32(1.625732422)
_LIFTS = (np.float32(-0.443506852), np.float32(-0.882911075), np.float32(0.052980118),
          np.float32(1.586134342))


def _line97(a: np.ndarray, sn: int, cas: int) -> np.ndarray:
    n = a.shape[1]
    dn = n - sn
    if (cas == 0 and not (dn > 0 or sn > 1)) or (cas == 1 and not (sn > 0 or dn > 1)):
        return a
    x = _interleave(a, sn, cas).astype(np.float32)
    lo, hi = cas, 1 - cas
    x[:, lo::2] = x[:, lo::2] * _K
    x[:, hi::2] = x[:, hi::2] * _TWO_INV_K
    for first, count, c in ((lo, sn, _LIFTS[0]), (hi, dn, _LIFTS[1]), (lo, sn, _LIFTS[2]),
                            (hi, dn, _LIFTS[3])):
        m = min(sn, dn - lo) if first == lo else min(dn, sn - hi)
        for i in range(m):  # in order: each target reads neighbours already lifted
            t = first + 2 * i
            left = x[:, 1] if t == 0 else x[:, t - 1]
            x[:, t] = x[:, t] + ((left + x[:, t + 1]) * c)
        if m < count:
            t = first + 2 * m
            x[:, t] = x[:, t] + (x[:, t - 1] * (c + c))
    return x


def idwt97_reference(buf: np.ndarray, rects: np.ndarray) -> np.ndarray:
    """The inverse 9/7 of `native.j2k_idwt` on float32 [h, w], in numpy with
    the same float32 operations in the same order."""
    return _idwt_2d(np.asarray(buf, np.float32), np.asarray(rects), _line97)


def mct_reference(c0: np.ndarray, c1: np.ndarray, c2: np.ndarray, reversible: bool):
    """The inverse RCT (int32) or ICT (float32) of `native.j2k_mct`."""
    if reversible:
        y, u, v = (np.asarray(c, np.int32) for c in (c0, c1, c2))
        g = y - ((u + v) >> 2)
        return v + g, g, u + g
    y, u, v = (np.asarray(c, np.float32) for c in (c0, c1, c2))
    return (y + v * np.float32(1.402), (y - u * np.float32(0.34413)) - v * np.float32(0.71414),
            y + u * np.float32(1.772))
