"""Old-style JPEG in TIFF (Compression 6), read as PIL 12.1.0 reads it through
libtiff 4.7.1's OJPEG codec (`utils/image_io._tiff_ojpeg`), on the CPU
against `np.asarray(PIL.Image.open(f))` in dtype, shape and bytes.

What the probes of PIL found (each case below holds one of them):
- libjpeg hands libtiff the components raw: no fancy upsampling and no
  colour conversion; libtiff's RGBA reader turns the data units into RGB
  with TIFFYCbCrToRGB (`native.ycbcr_to_rgb`), for PhotometricInterpretation
  2 as for 6. The stream's own luma sampling wins over YCbCrSubsampling
  (530) in the interchange form; in the table form libtiff builds the SOF
  from the tag (default 2x2), so a wrong tag decodes as the tag says.
- Sampling libtiff would have libjpeg upsample itself (chroma not 1x1, or
  3x1) fails: PIL's "decoder error -2".
- The table form is one stream: libtiff's DQT / DHT from JPEGQTables /
  DCTables / ACTables (component c takes table c; an offset of 0, or the
  component before's, takes the table before; up to 3 offsets), the
  strips' data between RST markers. JPEGProc (512) changes nothing: 14
  (lossless) decodes as baseline. A table tag missing raises.
- libtiff's restart interval: one strip's MCUs when there are strips
  (JPEGRestartInterval (515) then changes nothing), else 515's value (none
  without it); a stream's own DRI wins. Strips of other than whole MCU
  rows raise; fewer offsets than strips are strips without data.
- libtiff walks the interchange stream's markers itself and rewrites its
  SOS: a byte other than 0xFF where a marker should start ends the header
  (refused after an SOF; before it the header comes from the table tags),
  SOS must be of one component a sample, and its Ss / Se / Ah / Al are
  skipped (read past the end of the data too).
- Damaged directories: libtiff reads integers of any width and sign (not
  bytes in a tag Pillow reads itself), one value a strip of StripOffsets /
  StripByteCounts however long the array says it is, and passes over a
  PhotometricInterpretation, JPEGProc or JPEGRestartInterval it cannot
  read; Pillow fails on a RowsPerStrip it cannot read, on 0 or one past
  its RGBA buffer, on a table-form file without StripByteCounts, and on an
  XMP (700) that is not bytes (any TIFF). A height past 65535 wraps in the
  table form's SOF: libtiff's buffer then repeats the last iMCU row.
- A strip without data (offset 0 or past the end of the file) fails with
  every later one: a grey file raises, a YCbCr file's rows from there are
  zeroed data units (RGB 0, 135, 0). An interchange stream that lacks its
  EOI (cut short) gives the whole image so; one cut before its SOS
  segment raises.
- One component and one sample with PhotometricInterpretation 1 is grey
  ("L"), the plane as coded.
"""

import io
import struct
import warnings
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from tools import image_writers as iw
from wast3d_tpu_torch import native
from wast3d_tpu_torch.utils import image_io

FORMATS = Path(__file__).resolve().parent / "format_fixtures"
S420, S422, S444 = ((2, 2), (1, 1), (1, 1)), ((2, 1), (1, 1), (1, 1)), ((1, 1),) * 3


def _ycc(h, w, seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 90 * np.sin(x / 5 + seed), 128 + 60 * np.cos(y / 4),
                     128 + 50 * np.sin((x - y) / 6)], -1)
    return np.clip(base + rng.normal(0, 20, base.shape), 0, 255).astype(np.uint8)


def _pil(blob):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            return np.asarray(Image.open(io.BytesIO(blob)))
        except Exception:
            return None


def _same_as_pil(blob, name="o.tif"):
    want = _pil(blob)
    if want is None:
        with pytest.raises(ValueError, match=rf"^{name}: "):
            image_io.decode_image(blob, name)
        return False
    got = image_io.decode_image(blob, name)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    return True


CASES = {
    "interchange_420": dict(sampling=S420),
    "interchange_422_tag22": dict(sampling=S422, subsampling=(2, 2)),
    "interchange_420_tag11": dict(sampling=S420, subsampling=(1, 1)),
    "interchange_444_strip": dict(sampling=S444, strips=True),
    "interchange_41": dict(sampling=((4, 1), (1, 1), (1, 1))),
    "interchange_42": dict(sampling=((4, 2), (1, 1), (1, 1))),
    "interchange_12": dict(sampling=((1, 2), (1, 1), (1, 1))),
    "interchange_photo2": dict(sampling=S420, photometric=2),
    "interchange_refbw": dict(sampling=S420, tags=[(532, 4, None)]),
    "tables_420": dict(form="tables", sampling=S420, rows_per_strip=16, subsampling=(2, 2)),
    "tables_420_default_tag": dict(form="tables", sampling=S420, rows_per_strip=16),
    "tables_420_one_strip": dict(form="tables", sampling=S420, subsampling=(2, 2)),
    "tables_422": dict(form="tables", sampling=S422, rows_per_strip=8, subsampling=(2, 1)),
    "tables_444": dict(form="tables", sampling=S444, rows_per_strip=8, subsampling=(1, 1)),
    "tables_photo2": dict(form="tables", sampling=S420, rows_per_strip=16, photometric=2,
                          subsampling=(2, 2)),
    "tables_proc14": dict(form="tables", sampling=S420, rows_per_strip=16, subsampling=(2, 2),
                          jpeg_proc=14),
    "tables_restart_wrong": dict(form="tables", sampling=S420, rows_per_strip=16,
                                 subsampling=(2, 2), restart=3),
    "tables_no_restart_tag": dict(form="tables", sampling=S420, rows_per_strip=16,
                                  subsampling=(2, 2), tags=[(515, 3, None)]),
}
REFUSED = {
    "interchange_2211": dict(sampling=((2, 2), (2, 1), (1, 1))),
    "interchange_31": dict(sampling=((3, 1), (1, 1), (1, 1))),
    "interchange_photo1_rgb": dict(sampling=S444, photometric=1),
    "interchange_photo5": dict(sampling=S444, photometric=5),
    "tables_no_dc": dict(form="tables", sampling=S420, rows_per_strip=16, tags=[(520, 4, None)]),
    "tables_no_ac": dict(form="tables", sampling=S420, rows_per_strip=16, tags=[(521, 4, None)]),
    "tables_no_q": dict(form="tables", sampling=S420, rows_per_strip=16, tags=[(519, 4, None)]),
}


@pytest.mark.parametrize("size", [(40, 48), (21, 29), (9, 17), (1, 1), (48, 33)],
                         ids=lambda s: f"{s[1]}x{s[0]}")
@pytest.mark.parametrize("case", sorted(CASES))
def test_old_style_jpeg_tiff_is_pils_array(case, size):
    kw = dict(CASES[case])
    if kw.get("tags") == [(532, 4, None)]:  # ReferenceBlackWhite, as RATIONAL pairs
        kw["tags"] = []
        blob = iw.ojpeg_tiff_bytes(_ycc(*size, 1), **kw)
        blob = _with_refbw(blob)
    else:
        blob = iw.ojpeg_tiff_bytes(_ycc(*size, 1), **kw)
    assert _same_as_pil(blob)


def _with_refbw(blob):
    """The file with ReferenceBlackWhite (532) = 16/1 235/1 128/1 240/1 128/1
    240/1 and YCbCrCoefficients (529) = 0.2126, 0.7152, 0.0722, as RATIONAL
    entries appended to its directory."""
    (ifd,) = struct.unpack_from("<I", blob, 4)
    (n,) = struct.unpack_from("<H", blob, ifd)
    entries = [blob[ifd + 2 + 12 * i:ifd + 14 + 12 * i] for i in range(n)]
    tail = len(blob)
    refbw = struct.pack("<12I", 16, 1, 235, 1, 128, 1, 240, 1, 128, 1, 240, 1)
    coef = struct.pack("<6I", 2126, 10000, 7152, 10000, 722, 10000)
    new = entries + [struct.pack("<HHII", 529, 5, 3, tail), struct.pack("<HHII", 532, 5, 6,
                                                                        tail + len(coef))]
    new.sort(key=lambda e: struct.unpack_from("<H", e)[0])
    ifd2 = tail + len(coef) + len(refbw)
    directory = struct.pack("<H", len(new)) + b"".join(new) + b"\x00" * 4
    return blob[:4] + struct.pack("<I", ifd2) + blob[8:] + coef + refbw + directory


@pytest.mark.parametrize("size", [(40, 48), (9, 17)], ids=lambda s: f"{s[1]}x{s[0]}")
@pytest.mark.parametrize("rows", [16, None], ids=["strips", "one_strip"])
def test_table_form_decodes_as_its_tag_says(size, rows):
    """A 4:2:0 stream under YCbCrSubsampling 2x1: libtiff's SOF says 2x1 and
    the data decodes as such. In strips each restarts a strip's MCUs of the
    tag; in one strip the restart interval is JPEGRestartInterval's (the
    stream's, a third of the MCUs the tag makes), so the data meets EOI
    where libjpeg wants RST0 and the strip's read fails (zeroed units)."""
    blob = iw.ojpeg_tiff_bytes(_ycc(*size, 1), S420, form="tables", rows_per_strip=rows,
                               subsampling=(2, 1))
    assert _same_as_pil(blob)


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_old_style_jpeg_pil_refuses_raise(case):
    assert not _same_as_pil(iw.ojpeg_tiff_bytes(_ycc(24, 32, 2), **REFUSED[case]))


def test_grey_old_style_jpeg_is_the_plane():
    grey = _ycc(24, 40, 3)[..., 0]
    for kw in (dict(), dict(form="tables", rows_per_strip=8)):
        blob = iw.ojpeg_tiff_bytes(grey, ((1, 1),), photometric=1, **kw)
        assert _same_as_pil(blob)
    assert not _same_as_pil(iw.ojpeg_tiff_bytes(grey, ((1, 1),), photometric=6))


def test_strips_without_data_and_streams_cut_short_as_pil():
    """A strip past the end of the file (and every later one) fails in
    libtiff; an interchange stream without EOI gives zeroed units."""
    ycc = _ycc(48, 40, 4)
    for spp, img, samp, photo in ((3, ycc, S420, 6), (1, ycc[..., 0], ((1, 1),), 1)):
        blob = iw.ojpeg_tiff_bytes(img, samp, form="tables", rows_per_strip=16,
                                   subsampling=(2, 2) if spp == 3 else None, photometric=photo)
        tags = image_io._tiff_tags(blob, "x")[1]
        offs, counts = list(tags[273]), list(tags[279])
        at = struct.unpack_from("<I", blob, blob.index(struct.pack("<HHI", 273, 4, 3)) + 8)[0]
        for edit in ([offs[0], offs[1], len(blob) + 5], [offs[0], offs[1], 0]):
            moved = bytearray(blob)
            struct.pack_into("<3I", moved, at, *edit)
            assert _same_as_pil(bytes(moved)) == (spp == 3)
        assert _same_as_pil(blob[:offs[2] + 5])  # the last strip cut short: zero-filled
        assert _same_as_pil(blob[:offs[2]]) == (spp == 3)
        cat = struct.unpack_from("<I", blob, blob.index(struct.pack("<HHI", 279, 4, 3)) + 8)[0]
        whole = bytearray(blob)
        struct.pack_into("<3I", whole, cat, counts[0], 0, counts[2])  # count 0: to the end
        assert _same_as_pil(bytes(whole))
    inter = iw.ojpeg_tiff_bytes(ycc, S420)
    sos = inter.index(b"\xff\xda")
    for cut in (len(inter) - 1, len(inter) - 2, len(inter) - 60, sos + 14):
        assert _same_as_pil(inter[:cut])
    assert not _same_as_pil(inter[:sos + 2])


def test_raw_planes_are_the_idcts_output():
    """`native.jpeg_raw_planes` (colour 3, what libjpeg's raw data output
    gives libtiff) against the decoder's own planes: at 4:4:4 each plane is
    the as-coded component; at 4:2:0 the luma plane is, and the chroma
    planes are those of a 4:4:4 file of the same coefficients... held here
    through PIL's decode of the whole old-style file."""
    ycc = _ycc(24, 32, 5)
    blob = iw.jpeg_bytes(ycc, S444, 90)
    planes = native.jpeg_raw_planes(blob)[0]
    coded = native.decode_jpeg(blob, colour=2)
    assert [p.shape for p in planes] == [(24, 32)] * 3
    for c in range(3):
        assert np.array_equal(planes[c], coded[..., c])
    blob = iw.jpeg_bytes(ycc[:21, :29], S420, 90)
    planes = native.jpeg_raw_planes(blob)[0]
    assert [p.shape for p in planes] == [(32, 32), (16, 16), (16, 16)]
    assert np.array_equal(planes[0][:21, :29], native.decode_jpeg(blob, colour=2)[..., 0])
    with pytest.raises(ValueError, match="lossless"):
        native.jpeg_raw_planes(iw.jpeg_lossless_bytes(ycc, predictor=1))


def test_pixel_limit_and_refusals_name_the_tag():
    one = iw.ojpeg_tiff_bytes(_ycc(8, 8, 6), S444, form="tables", rows_per_strip=8,
                              tags=[(519, 4, [("data", 0)])])
    assert _same_as_pil(one, "t.tif")  # one offset: every component takes that table
    blob = iw.ojpeg_tiff_bytes(_ycc(8, 8, 6), S444, form="tables", rows_per_strip=8,
                               tags=[(519, 4, [0])])
    with pytest.raises(ValueError, match=r"^t\.tif: TIFF JPEGQTables \(tag 519\)"):
        image_io.decode_image(blob, "t.tif")
    assert _pil(blob) is None
    blob = iw.ojpeg_tiff_bytes(_ycc(8, 8, 6), S444, tags=[(258, 3, [12, 12, 12])])
    with pytest.raises(ValueError, match=r"^t\.tif: TIFF BitsPerSample \(tag 258\)"):
        image_io.decode_image(blob, "t.tif")
    assert _pil(blob) is None


def _patched(blob, tag, typ=None, value=None, count=None):
    """The file with one directory entry's type, value field or count set."""
    out = bytearray(blob)
    (ifd,) = struct.unpack_from("<I", out, 4)
    for i in range(struct.unpack_from("<H", out, ifd)[0]):
        at = ifd + 2 + 12 * i
        if struct.unpack_from("<H", out, at)[0] == tag:
            if typ is not None:
                struct.pack_into("<H", out, at + 2, typ)
            if count is not None:
                struct.pack_into("<I", out, at + 4, count)
            if value is not None:
                struct.pack_into("<I", out, at + 8, value)
            return bytes(out)
    raise KeyError(tag)


def _with_stream(stream, **kw):
    """A table-form file (48 x 64, 4:2:0, strips of 16) whose
    JPEGInterchangeFormat points at `stream`, appended."""
    tags = lambda at: [(513, 4, [at]), (514, 4, [len(stream)])]  # noqa: E731
    first = iw.ojpeg_tiff_bytes(_ycc(48, 64, 1), S420, form="tables", tags=tags(0), **kw)
    return iw.ojpeg_tiff_bytes(_ycc(48, 64, 1), S420, form="tables", tags=tags(len(first)),
                               **kw) + stream


def test_header_walk_ends_where_a_marker_should_start():
    """libtiff reads the interchange stream's markers itself: a byte other
    than 0xFF where one should start ends its walk. Before an SOF the header
    comes from the table tags (none here: refused; with them, the data
    starts at that byte), after it the file is refused (decoder error -2).
    A table-form file may also point JPEGInterchangeFormat at a whole
    stream: with a DRI, or without one and without EOI, it reads; a stream
    without DRI ending in EOI is refused."""
    blob = iw.ojpeg_tiff_bytes(_ycc(48, 64, 1), S420)
    at, marks = blob.index(b"\xff\xd8\xff") + 2, []
    while blob[at + 1] != 0xDA:
        marks.append(at)
        at += 2 + struct.unpack_from(">H", blob, at + 2)[0]
    for at in marks + [at]:
        broken = bytearray(blob)
        broken[at] = 0x12
        assert not _same_as_pil(bytes(broken))
    whole = iw.jpeg_bytes(_ycc(48, 64, 1), S420, 90, restart_interval=4)
    plain = iw.jpeg_bytes(_ycc(48, 64, 1), S420, 90)
    head = whole[:whole.index(b"\xff\xda") + 14]
    assert [_same_as_pil(_with_stream(s, rows_per_strip=16)) for s in (
        whole, whole[:-2], plain[:-2], head, plain[:plain.index(b"\xff\xda") + 14], plain,
        b"\xff\xd8\x12\x34", whole[:2] + b"\x12" + whole[3:])] == [True] * 5 + [False, True, False]


def test_sos_is_read_as_libtiff_reads_it():
    """libtiff checks SOS's length and component count, reads each table
    selector and skips Ss, Se and Ah / Al (writing 0, 63, 0 itself), even
    past the end of the data."""
    blob = iw.ojpeg_tiff_bytes(_ycc(48, 64, 1), S420)
    sos = blob.index(b"\xff\xda")
    assert [_same_as_pil(blob[:sos + n]) for n in range(4, 15)] == [False] * 7 + [True] * 4
    for at, value, pil_reads in ((3, 0x0E, False), (4, 2, False), (5, 9, False), (11, 0x20, True),
                                 (12, 0x11, True), (13, 0x11, True), (6, 0x11, True)):
        changed = bytearray(blob)
        changed[sos + at] = value
        assert _same_as_pil(bytes(changed)) == pil_reads


def test_strips_as_libtiff_counts_them():
    """libtiff's strips are RowsPerStrip's: a strip height not of whole MCUs
    is refused, fewer offsets or counts than strips are padded with 0 (a
    strip without data), a RowsPerStrip libtiff or Pillow cannot take is
    refused (0; past Pillow's RGBA buffer, 2**31 // 4 // width rows; grey
    from 2**31), 2**32 - 1 is one strip, and a stream without DRI restarts
    at each strip all the same. A table-form file without StripByteCounts
    is refused; an interchange stream reads without them."""
    ycc = _ycc(48, 64, 1)
    cases = [iw.ojpeg_tiff_bytes(ycc, S420, strips=True, tags=[(278, 4, [r])])
             for r in (8, 16, 24, 32, 48)]
    cases += [iw.ojpeg_tiff_bytes(ycc, S420, form="tables", rows_per_strip=48,
                                  tags=[(278, 4, [r])])
              for r in (0, 2 ** 31 // 4 // 64, 2 ** 31 // 4 // 64 - 1, 2 ** 32 - 2, 2 ** 32 - 1)]
    grey = _ycc(24, 40, 3)[..., 0]
    cases += [iw.ojpeg_tiff_bytes(grey, ((1, 1),), photometric=1, form="tables",
                                  rows_per_strip=24, tags=[(278, 4, [r])]) for r in (4, 12)]
    cases += [iw.ojpeg_tiff_bytes(grey, ((1, 1),), photometric=1, form="tables",
                                  rows_per_strip=24, tags=[(278, 4, [r])])
              for r in (2 ** 31 - 1, 2 ** 31)]
    cases += [iw.ojpeg_tiff_bytes(ycc, S420, tags=[(279, 4, None)], **kw)
              for kw in (dict(form="tables", rows_per_strip=16), dict(strips=True))]
    assert [_same_as_pil(b) for b in cases] == [False, False, False, True, True, False, False,
                                                True, False, True, False, False, True, False,
                                                False, True]


def test_damaged_strip_arrays_and_tags_as_libtiff_reads_them():
    """libtiff reads one value a strip of StripOffsets and StripByteCounts, so
    a count that runs the array past the end of the file still reads (a
    grey file's offsets Pillow needs whole); a RowsPerStrip it cannot read
    fails; an integer entry of another width or sign reads (Pillow's own
    tags not as bytes; not past 32 bits); a PhotometricInterpretation,
    JPEGProc or JPEGRestartInterval of any other type is passed over. Every
    tag of three fixtures is tried at nine types."""
    tables = FORMATS / "ojpeg_tables_420.tif"
    grey = FORMATS / "ojpeg_grey.tif"
    for path in (tables, grey, FORMATS / "ojpeg_interchange_420.tif"):
        blob = path.read_bytes()
        for tag in sorted(image_io._tiff_tags(blob, "x")[1]):
            for typ in (1, 5, 6, 8, 9, 12, 13, 16, 17):
                _same_as_pil(_patched(blob, tag, typ=typ))
    assert [_same_as_pil(_patched(path.read_bytes(), tag, count=2051)) for path in (tables, grey)
            for tag in (273, 278, 279)] == [True, False, True, False, False, True]


def test_table_offsets_of_zero_or_repeated_take_the_table_before():
    """An offset of 0, or the component before's, in JPEGQTables / DCTables
    / ACTables gives the component the table before; an earlier one is
    refused, and so is a first of 0."""
    ycc = _ycc(24, 32, 6)
    blob = iw.ojpeg_tiff_bytes(ycc, S420, form="tables", rows_per_strip=16)
    tags = image_io._tiff_tags(blob, "x")[1]
    for tag in (519, 520, 521):
        o = tags[tag]
        where = struct.unpack_from("<I", blob, blob.index(struct.pack("<HHI", tag, 4, 3)) + 8)[0]
        outcomes = []
        for edit in ((o[0], 0, o[2]), (o[0], o[0], o[0]), (o[0], o[1], 0), (o[0], o[1], o[0]),
                     (0, o[1], o[2])):
            moved = bytearray(blob)
            struct.pack_into("<3I", moved, where, *edit)
            outcomes.append(_same_as_pil(bytes(moved)))
        assert outcomes == [True, True, True, False, False]


@pytest.mark.parametrize("kind", ["tables_420_16", "tables_420_8_wraps", "grey_8", "grey_16",
                                  "tables_422_8", "interchange"])
def test_heights_past_65535_wrap_as_libtiff_writes_them(kind):
    """A table-form SOF holds the height's low 16 bits: libjpeg gives no
    rows past them, and libtiff's buffer keeps the last iMCU row (with the
    row before's data in the blocks past the frame) for every later strip;
    a grey file read strip by strip keeps the strip before's rows. An
    interchange stream shorter than the TIFF is refused."""
    img, samp, kw, h = {
        "tables_420_16": (_ycc(40, 24, 1), S420, dict(rows_per_strip=16), 40),
        "tables_420_8_wraps": (_ycc(48, 24, 1), S420, dict(rows_per_strip=16), 48),
        "grey_8": (_ycc(21, 24, 2)[..., 0], ((1, 1),), dict(rows_per_strip=8, photometric=1), 21),
        "grey_16": (_ycc(21, 24, 2)[..., 0], ((1, 1),), dict(rows_per_strip=16, photometric=1),
                    21),
        "tables_422_8": (_ycc(21, 24, 2), S422, dict(rows_per_strip=8, subsampling=(2, 1)), 21),
        "interchange": (_ycc(40, 24, 1), S420, dict(form="interchange"), 40)}[kind]
    kw.setdefault("form", "tables")
    blob = iw.ojpeg_tiff_bytes(img, samp, tags=[(257, 4, [65536 + h])], **kw)
    assert _same_as_pil(blob) == (kind != "interchange")



def test_xmp_of_another_type_fails_as_in_pil():
    """Pillow reads XMP (tag 700) as bytes, and fails on any TIFF whose XMP
    is of another type."""
    buf = io.BytesIO()
    Image.fromarray(_ycc(8, 8, 7)).save(buf, "TIFF")
    for blob in (buf.getvalue(), iw.ojpeg_tiff_bytes(_ycc(8, 8, 7), S444)):
        (ifd,) = struct.unpack_from("<I", blob, 4)
        last = ifd + 2 + 12 * (struct.unpack_from("<H", blob, ifd)[0] - 1)
        for typ, reads in ((1, True), (2, False), (3, False), (4, False), (7, True)):
            changed = bytearray(blob)
            struct.pack_into("<HHII", changed, last, 700, typ, 1, 5)
            assert _same_as_pil(bytes(changed)) == reads
