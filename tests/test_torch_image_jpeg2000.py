"""JPEG 2000 (J2K codestreams and JP2 files) and ICNS, which the port's
reader refused before: on the CPU, each file against
`np.asarray(PIL.Image.open(f))` (PIL over OpenJPEG 2.5.4) in dtype, shape
and bytes, the 9/7 path included; the native tier-1, wavelets and colour
transforms (`native/j2k.cpp`) against their plain versions in
`utils/jpeg2000.py` on the code-blocks and tiles of seeded files, odd
origins included; truncated and damaged files decoding or raising as PIL
does; the dispatch; and datasets and metrics reading JPEG 2000 as the JAX
package does. Files stay small (at most 64 x 48 but for the COLMAP views),
so the plain tier-1 is quick.
"""

import io
import shutil
import struct
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from tools import image_writers as iw
from wast3d_tpu_torch import native
from wast3d_tpu_torch.scene import colmap as cm
from wast3d_tpu_torch.scene import datasets as tds
from wast3d_tpu_torch.utils import image_formats, image_io
from wast3d_tpu_torch.utils import jpeg2000 as j2

ROOT = Path(__file__).resolve().parent.parent
FORMATS = ROOT / "tests" / "format_fixtures"
FIXTURES = ROOT / "tests" / "torch_fixtures"
COMMITTED = sorted(p for p in FORMATS.rglob("*") if p.is_file() and p.suffix != ".npy"
                   and ("jpeg2000" in str(p.relative_to(FORMATS)) or p.name.startswith("icns")))


def _image(h, w, c=3, seed=0):
    """Smooth colour (gradients and waves), uint8."""
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(x / 7 + seed), 128 + 90 * np.cos(y / 5),
                     128 + 60 * np.sin((x + y) / 9), 128 + 127 * np.cos(x / 11)], -1)[..., :c]
    img = np.clip(base, 0, 255).astype(np.uint8)
    return img[..., 0] if c == 1 else img


def _planes(h=40, w=56, seed=0):
    img = _image(h, w, 3, seed)
    return [img[..., c].astype(np.int32) for c in range(3)]


def _pil(blob):
    try:
        return np.asarray(Image.open(io.BytesIO(blob)))
    except Exception:
        return None


def _same_as_pil(blob, name="case.jp2"):
    """The port's array equals PIL's, or both refuse (the port naming the
    file). Returns whether PIL decoded it."""
    want = _pil(blob)
    if want is None:
        with pytest.raises(ValueError, match=rf"^{name}: "):
            image_io.decode_image(blob, name)
        return False
    got = image_io.decode_image(blob, name)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    return True


def _save(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG2000", **kw)
    return buf.getvalue()


# ---- committed fixtures -------------------------------------------------------------

def _npy(path: Path) -> Path:
    npy = path.with_suffix(".npy")
    if npy.exists():
        return npy
    return path.parent.parent / "pil" / f"{path.parent.name}_{path.stem}.npy"


@pytest.mark.parametrize("path", COMMITTED, ids=lambda p: str(p.relative_to(FORMATS)))
def test_committed_jpeg2000_and_icns_fixture_is_pils_array(path):
    want = np.asarray(Image.open(path))
    card = np.load(_npy(path))
    assert card.dtype == want.dtype and card.tobytes() == want.tobytes()
    got = image_io.read_image(str(path))
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def test_committed_fixtures_meet_every_feature():
    names = {p.name for p in COMMITTED}
    for part in ("97_layers", "style_lazy", "style_reset", "style_termall", "style_causal",
                 "style_pterm", "style_segsym", "sop_eph", "poc", "roi", "tileparts",
                 "sub420", "rgb12", "sycc", "pclr", "cmyk", "cdef", "ppt", "ppm", "i16",
                 "rlcp", "rpcl", "pcrl", "cprl", "tile_offsets", "signed", "icns_rle",
                 "icns_png", "icns_jp2", "icns_j2k"):
        assert any(part in n for n in names), part
    assert sum(p.stat().st_size + _npy(p).stat().st_size for p in COMMITTED) < 3 << 20


# ---- more of OpenJPEG's options, written here -----------------------------------------

WRITER_CASES = {
    "layers_lrcp": dict(rates=(60, 20, 5, 0)),
    "layers_rlcp_97": dict(rates=(40, 10, 0), progression=1, irreversible=True),
    "rpcl_precincts": dict(progression=2, precincts=[(4, 4)] * 6, rates=(30, 0)),
    "pcrl_precincts_97": dict(progression=3, precincts=[(5, 5), (4, 4)], irreversible=True),
    "cprl_tiles": dict(progression=4, tile=(24, 16), resolutions=3),
    "lazy_reset_97": dict(style=3, irreversible=True, rates=(20, 0)),
    "termall_segsym": dict(style=36, rates=(30, 10, 0)),
    "causal_pterm_97": dict(style=24, irreversible=True, cblk=(8, 32)),
    "all_styles_tiles": dict(style=63, tile=(20, 20), tile_offset=(3, 5), offset=(4, 6),
                             resolutions=3),
    "poc_three": dict(pocs=[(0, 0, 1, 2, 3, 4), (2, 0, 2, 6, 2, 2), (0, 0, 3, 6, 3, 1)],
                      rates=(50, 20, 0)),
    "roi_shift_20": dict(roi=(2, 20), rates=(30, 0)),
    "sop_eph_tileparts": dict(sop=True, eph=True, tile=(32, 32), tile_parts="R"),
    "cblk_1024x4": dict(cblk=(1024, 4)),
    "offset_97_odd": dict(offset=(7, 3), irreversible=True, resolutions=5),
}


@pytest.mark.parametrize("case", sorted(WRITER_CASES))
def test_libopenjp2_options_equal_pil(case):
    assert _same_as_pil(iw.j2k_bytes(_planes(), **WRITER_CASES[case]), "case.j2k")


def test_sop_before_packets_of_empty_resolutions_equals_pil():
    """libopenjp2 writes tile-parts by layer with a packet (and its SOP)
    for a resolution of no width, which its decoder never reads: a missing
    SOP is only a warning there."""
    img = _image(24, 62)
    blob = iw.j2k_bytes([img[..., c].astype(np.int32) for c in range(3)], style=8, sop=True,
                        resolutions=4, cblk=(4, 4), offset=(2, 1), tile=(14, 24),
                        tile_offset=(2, 1), tile_parts="L")
    assert _same_as_pil(blob, "case.j2k")


@pytest.mark.parametrize("levels", [0, 1, 7, 8])
def test_decomposition_levels_equal_pil(levels):
    size = max(8, 1 << levels)
    img = _image(size, size + 3, 3, seed=levels)
    assert _same_as_pil(_save(img, num_resolutions=levels + 1, no_jp2=True), "case.j2k")
    assert _same_as_pil(_save(img, num_resolutions=levels + 1, irreversible=True), "case.jp2")


@pytest.mark.parametrize("where", ["PPT", "PPM"])
def test_packed_packet_headers_equal_pil(where):
    blob = iw.j2k_bytes(_planes(), tile=(32, 16), rates=(40, 10, 0), sop=True, eph=True,
                        resolutions=4)
    for seg in (65535, 40):
        packed = iw.j2k_packed_headers(blob, where, max_segment=seg)
        assert packed.count(b"\xff\x60" if where == "PPM" else b"\xff\x61") >= 1 + (seg < 1000)
        assert _same_as_pil(packed, "case.j2k")
        assert np.array_equal(_pil(packed), _pil(blob))
    if where == "PPM":  # an Nppm split over two segments: OpenJPEG refuses
        straddled = [iw.j2k_packed_headers(blob, where, max_segment=n, straddle=True)
                     for n in range(30, 60)]
        assert sum(not _same_as_pil(b, "case.j2k") for b in straddled) > 5


def test_modes_and_boxes_equal_pil():
    """PIL's modes through hand-edited JP2 boxes: P and PA from pclr (a pclr
    of 16-bit entries or after cmap refused), CMYK, sYCC with alpha, a mode
    PIL has no unpacker for, ICC and unknown colour specifications, and an
    ihdr that disagrees with the codestream."""
    planes = _planes()
    idx = planes[0] // 8
    pal = np.random.default_rng(5).integers(0, 256, (32, 3)).astype(np.uint8)
    pclr = iw.jp2_box(b"pclr", struct.pack(">HB", 32, 3) + bytes([7, 7, 7]) + pal.tobytes())
    pclr16 = iw.jp2_box(b"pclr", struct.pack(">HB", 32, 3) + bytes([15] * 3)
                        + pal.astype(">u2").tobytes())
    cmap = iw.jp2_box(b"cmap", b"".join(struct.pack(">HBB", 0, 1, c) for c in range(3)))
    grey_srgb = iw.j2k_bytes([idx], jp2=True, colour=1)
    four = iw.j2k_bytes(planes + [planes[0] ^ 255], jp2=True, mct=False)
    rgb = iw.j2k_bytes(planes, jp2=True)
    decoded = [_same_as_pil(b) for b in (
        iw.jp2_edit(grey_srgb, add=[pclr, cmap]), iw.jp2_edit(grey_srgb, add=[pclr16, cmap]),
        iw.jp2_edit(grey_srgb, add=[cmap, pclr]),
        iw.jp2_edit(iw.j2k_bytes([idx], jp2=True, colour=2), add=[pclr]),
        iw.jp2_edit(four, enumcs=12), iw.jp2_edit(four, enumcs=18), iw.jp2_edit(four, enumcs=24),
        iw.jp2_edit(four, enumcs=17), iw.jp2_edit(rgb, enumcs=17),
        iw.jp2_edit(four, enumcs=99), iw.jp2_edit(rgb, ihdr_bpc=11),
        iw.jp2_edit(iw.j2k_bytes([planes[1]], jp2=True, colour=2), ihdr_bpc=11),
        iw.jp2_edit(rgb, add=[iw.jp2_box(b"bpcc", bytes([7, 7]))]),
        rgb.replace(b"ihdr\x00\x00\x00\x28\x00\x00\x00\x38", b"ihdr\x00\x00\x00\x29\x00\x00\x00\x38"))]
    assert decoded == [True, False, False, False, True, True, False, True, False, True, True,
                       True, False, False]


def test_subsampled_and_signed_components_equal_pil():
    p = _planes(41, 57)
    cases = [([p[0], p[1][::2, ::2], p[2][::2, ::2]], [(1, 1), (2, 2), (2, 2)], {}),
             ([p[0][::2, ::2], p[1], p[2]], [(2, 2), (1, 1), (1, 1)], {}),
             ([p[0], p[1], p[2], p[0][::3, ::2]], [(1, 1)] * 3 + [(2, 3)], {}),
             ([p[0], p[1][::3, ::1], p[2][::1, ::3]], [(1, 1), (1, 3), (3, 1)],
              dict(irreversible=True)),
             ([p[0], p[1][::2]], [(1, 1), (1, 2)], {})]
    for comps, sampling, kw in cases:
        _same_as_pil(iw.j2k_bytes(comps, sampling=sampling, mct=False, **kw), "case.j2k")
        _same_as_pil(iw.j2k_bytes(comps, sampling=sampling, mct=False, jp2=True, colour=3,
                                  **kw))
    for prec in (2, 7, 10, 15):
        lo = 1 << (prec - 1)
        comps = [(c * ((1 << prec) - 1) // 255) - lo for c in p]
        assert _same_as_pil(iw.j2k_bytes(comps, prec=prec, signed=True), "case.j2k")
        assert _same_as_pil(iw.j2k_bytes(comps[:1], prec=prec, signed=True, jp2=True, colour=2))


def test_errors_name_the_file_and_the_marker():
    blob = iw.j2k_bytes(_planes())
    cod = blob.index(b"\xff\x52")
    ht = bytearray(blob)
    ht[cod + 12] |= 0x40  # SPcod's code-block style: HTJ2K
    mct = blob[:cod] + b"\xff\x74\x00\x04\x00\x00" + blob[cod:]
    cap = blob[:cod] + b"\xff\x50\x00\x08\x00\x02\x00\x00\x00\x00" + blob[cod:]
    for damaged, what in ((bytes(ht), "HTJ2K"), (mct, "MCT"), (cap, "0xFF50")):
        with pytest.raises(ValueError, match=rf"^odd\.j2k: .*{what}"):
            image_io.decode_image(damaged, "odd.j2k")
    with pytest.raises(ValueError, match=r"^big\.j2k: .*more pixels than PIL opens"):
        siz = bytearray(blob)
        struct.pack_into(">II", siz, 8, 60000, 60000)
        image_io.decode_image(bytes(siz), "big.j2k")


# ---- native loops against their plain versions -----------------------------------------

def _recorded(blob):
    """The arguments `decode_image` hands the native tier-1, wavelet and
    colour-transform loops for `blob`."""
    calls = {"t1": [], "idwt": [], "mct": []}
    real = native.j2k_t1, native.j2k_idwt, native.j2k_mct

    def t1(data, cblks, segs, steps, out, rev, name="t1"):
        calls["t1"].append((data, cblks.copy(), segs.copy(), steps.copy(), rev))
        real[0](data, cblks, segs, steps, out, rev, name)

    def idwt(buf, rects, rev):
        calls["idwt"].append((buf.copy(), rects.copy(), rev))
        real[1](buf, rects, rev)

    def mct(a, b, c, rev):
        calls["mct"].append((a.copy(), b.copy(), c.copy(), rev))
        real[2](a, b, c, rev)

    native.j2k_t1, native.j2k_idwt, native.j2k_mct = t1, idwt, mct
    try:
        image_io.decode_image(blob)
    finally:
        native.j2k_t1, native.j2k_idwt, native.j2k_mct = real
    return calls


NATIVE_CASES = {
    "styles_layers": dict(style=63, rates=(30, 0), cblk=(16, 16)),
    "lazy_causal_97_odd": dict(style=9, irreversible=True, cblk=(32, 8), offset=(3, 1)),
    "roi": dict(roi=(0, 7), cblk=(16, 16)),
    "lazy_97_tiles_odd": dict(style=1, irreversible=True, rates=(20, 5, 0), cblk=(16, 16),
                              offset=(1, 2), tile=(19, 23), tile_offset=(1, 1), resolutions=4),
    "pterm_termall_reset": dict(style=22, cblk=(8, 16), rates=(25, 0)),
}


@pytest.mark.parametrize("case", sorted(NATIVE_CASES))
def test_native_tier1_equals_its_plain_version(case):
    calls = _recorded(iw.j2k_bytes(_planes(seed=3), **NATIVE_CASES[case]))
    blocks = nonzero = 0
    for data, cblks, segs, steps, rev in calls["t1"]:
        segs = segs.reshape(-1, 3)
        for i, cb in enumerate(cblks.reshape(-1, 10)):
            x, y, w, h, band, sty, bp, roi, first, n = cb
            sg = segs[first:first + n].copy()
            base = sg[0, 0] if n else 0
            sg[:, 0] -= base
            chunk = data[base:base + int(sg[:, 1].sum())]
            one = cb.copy()
            one[[0, 1, 8]] = 0
            out = np.zeros((h, w), np.int32 if rev else np.float32)
            native.j2k_t1(chunk, one, sg, steps[i:i + 1], out, rev)
            ref = j2.t1_reference(chunk, [(length, p) for _, length, p in sg], w, h, band, sty,
                                  bp, roi, None if rev else steps[i])
            assert ref.dtype == out.dtype and ref.tobytes() == out.tobytes()
            blocks += 1
            nonzero += bool(out.any())
    assert blocks >= 40 and nonzero >= blocks // 2


@pytest.mark.parametrize("case", sorted(NATIVE_CASES))
def test_native_wavelets_and_colour_transforms_equal_their_plain_versions(case):
    calls = _recorded(iw.j2k_bytes(_planes(seed=4), **NATIVE_CASES[case]))
    assert calls["idwt"] and calls["mct"]
    for buf, rects, rev in calls["idwt"]:
        got = buf.copy()
        native.j2k_idwt(got, rects, rev)
        ref = (j2.idwt53_reference if rev else j2.idwt97_reference)(buf, rects)
        assert ref.dtype == got.dtype and ref.tobytes() == got.tobytes()
    for a, b, c, rev in calls["mct"]:
        got = [a.copy(), b.copy(), c.copy()]
        native.j2k_mct(*got, rev)
        for x, y in zip(j2.mct_reference(a, b, c, rev), got):
            assert x.tobytes() == y.tobytes()


@pytest.mark.parametrize("reversible", [True, False], ids=["53", "97"])
@pytest.mark.parametrize("origin", [(0, 0), (1, 0), (0, 1), (1, 1)])
def test_native_wavelets_equal_their_plain_versions_on_seeded_tiles(origin, reversible):
    """Seeded coefficients over tile-components of odd and even origins and
    sizes down to one sample, 0-6 levels."""
    rng = np.random.default_rng(sum(origin) * 2 + reversible)
    for levels in range(7):
        x0, y0 = origin[0] + 2 * int(rng.integers(0, 5)), origin[1] + 2 * int(rng.integers(0, 5))
        w, h = int(rng.integers(1, 40)), int(rng.integers(1, 40))
        rects = np.array([[-(-x0 >> k), -(-y0 >> k), -(-(x0 + w) >> k), -(-(y0 + h) >> k)]
                          for k in range(levels, -1, -1)], np.int32)
        if reversible:
            buf = rng.integers(-2000, 2000, (h, w)).astype(np.int32)
        else:
            buf = (rng.normal(0, 300, (h, w))).astype(np.float32)
        got = buf.copy()
        native.j2k_idwt(got, rects, reversible)
        ref = (j2.idwt53_reference if reversible else j2.idwt97_reference)(buf, rects)
        assert ref.tobytes() == got.tobytes(), levels


# ---- truncated and damaged files -------------------------------------------------------

def _cuts(blob):
    """Seeded cut points: inside a packet, between tile-parts, before EOC,
    right after a SOT marker, and inside jp2h (JP2)."""
    rng = np.random.default_rng(len(blob))
    sots = [i for i in range(len(blob) - 1) if blob[i:i + 4] == b"\xff\x90\x00\x0a"]
    sod = blob.index(b"\xff\x93")
    cuts = {"packet": int(rng.integers(sod + 4, len(blob) - 4)), "before_eoc": len(blob) - 2,
            "last_byte": len(blob) - 1}
    for k, s in enumerate(sots):
        cuts[f"between_parts_{k}"] = s
        cuts[f"after_sot_{k}"] = s + 2
    if b"jp2h" in blob:
        at = blob.index(b"jp2h")
        cuts["jp2h"] = int(rng.integers(at + 4, at + 40))
    return cuts


@pytest.mark.parametrize("kind", ["jp2", "j2k_tiles", "jp2_tileparts"])
def test_truncations_decode_or_raise_as_pil(kind):
    img = _image(40, 56)
    blob = {"jp2": _save(img, irreversible=True, quality_mode="rates", quality_layers=[20, 4]),
            "j2k_tiles": _save(img, no_jp2=True, tile_size=(32, 16)),
            "jp2_tileparts": iw.j2k_bytes(_planes(), tile=(32, 32), tile_parts="R",
                                          jp2=True)}[kind]
    decoded = {name: _same_as_pil(blob[:cut]) for name, cut in _cuts(blob).items()}
    # OpenJPEG keeps the tiles before a cut just after a SOT marker that
    # starts a tile (the tiles before it whole); any other cut is refused.
    starts = [blob[s + 10] == 0 for s in range(len(blob) - 1)
              if blob[s:s + 4] == b"\xff\x90\x00\x0a"]
    assert decoded == {k: k.startswith("after_sot") and starts[int(k.split("_")[-1])]
                       for k in decoded}


def test_bit_flips_decode_or_raise_as_pil():
    """`tools/j2k_flip_census.py` in small: one flipped bit at seeded places."""
    from tools import j2k_flip_census

    rng = np.random.default_rng(7)
    same = 0
    for _, blob in j2k_flip_census.probes()[:4]:
        for _ in range(12):
            damaged = bytearray(blob)
            damaged[int(rng.integers(0, len(blob)))] ^= 1 << int(rng.integers(0, 8))
            same += _same_as_pil(bytes(damaged), "flip.jp2")
    assert same > 12


# ---- ICNS ----------------------------------------------------------------------------

def test_icns_entries_equal_pil():
    def png(img):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "PNG")
        return buf.getvalue()

    def runs(img):
        return b"".join(iw.icns_rle(img[..., c]) for c in range(3))

    rgb = _image(128, 128)
    mask = _image(128, 128, 1, seed=2)
    buf = io.BytesIO()
    Image.fromarray(rgb[:64, :64]).save(buf, "ICNS")
    cases = [buf.getvalue(),
             iw.icns_bytes([(b"it32", b"\x00" * 4 + runs(rgb)), (b"t8mk", mask.tobytes())]),
             iw.icns_bytes([(b"ic07", png(rgb)), (b"it32", b"\x00" * 4 + runs(rgb))]),
             iw.icns_bytes([(b"icp6", _save(rgb[:64, :64, 0]))]),
             iw.icns_bytes([(b"icp6", _save(rgb[:64, :64], irreversible=True))]),
             iw.icns_bytes([(b"icp5", png(rgb[:32, :32, 0]))]),
             iw.icns_bytes([(b"s8mk", mask[:16, :16].tobytes())]),
             iw.icns_bytes([(b"is32", runs(rgb[:16, :16])[:-4])]),
             iw.icns_bytes([(b"it32", b"\x01" * 4 + runs(rgb))]),
             iw.icns_bytes([])]
    assert [_same_as_pil(b, "case.icns") for b in cases] == [True] * 5 + [False] * 5


# ---- dispatch, datasets and metrics ---------------------------------------------------

def test_dispatch_sends_jpeg2000_and_icns_to_their_readers(monkeypatch):
    seen = []
    real_j2k, real_icns = j2.decode_jpeg2000, image_formats.decode_icns
    monkeypatch.setattr(j2, "decode_jpeg2000", lambda b, n: seen.append("j2k") or real_j2k(b, n))
    monkeypatch.setattr(image_formats, "decode_icns",
                        lambda b, n: seen.append("icns") or real_icns(b, n))
    for name in ("jpeg2000_rgb_lossless.jp2", "jpeg2000_l_97.j2k", "icns_rle_mask_16.icns",
                 "icns_jp2_rgb_32.icns", "bmp_pal8.bmp", "png_grey16.png"):
        image_io.read_image(str(FORMATS / name))
    assert seen == ["j2k", "j2k", "icns", "icns", "j2k"]


def test_colmap_scene_of_jpeg2000_views_equals_jaxs(tmp_path):
    """The six COLMAP views as JPEG 2000 of each kind: both packages' scenes
    and cameras alike, each view the card's copy of PIL's decode."""
    from wast3d_tpu.scene import datasets as jds

    src = tmp_path / "colmap"
    shutil.copytree(FIXTURES / "colmap_jpeg", src)
    views = FORMATS / "colmap_jpeg2000"
    shutil.copytree(views, src / "images_jpeg2000", ignore=shutil.ignore_patterns("*.npy"))
    names = {p.stem: p.name for p in views.iterdir() if p.suffix != ".npy"}
    path = str(src / "sparse" / "0" / "images.bin")
    cm.write_images_binary({k: v._replace(name=names[Path(v.name).stem])
                            for k, v in cm.read_images_binary(path).items()}, path)
    t = tds.read_colmap_scene(str(src), "images_jpeg2000", eval_split=True)
    j = jds.read_colmap_scene(str(src), "images_jpeg2000", eval_split=True)
    cams_t, cams_j = t.train_cameras + t.test_cameras, j.train_cameras + j.test_cameras
    assert len(cams_t) == len(cams_j) == 6
    for a, b in zip(cams_t, cams_j):
        assert (a.image_name, a.width, a.height) == (b.image_name, b.width, b.height)
        assert a.image.dtype == b.image.dtype and a.image.tobytes() == b.image.tobytes()
        want = np.load(views / f"{a.image_name}.npy")
        assert a.image.tobytes() == (want.astype(np.float32) / 255.0).tobytes()


def test_metrics_read_a_jpeg2000_method_directory_as_jax_does():
    from wast3d_tpu.eval import metrics as jmetrics
    from wast3d_tpu_torch.eval import metrics as tmetrics

    method = FORMATS / "metrics_jpeg2000"
    a = tmetrics._read_images(str(method / "renders"), str(method / "gt"))
    b = jmetrics._read_images(str(method / "renders"), str(method / "gt"))
    assert a[2] == b[2] == ["00000.jp2", "00001.j2k"]
    for x, y in zip(a[0] + a[1], b[0] + b[1]):
        assert x.dtype == y.dtype == np.float32 and x.tobytes() == y.tobytes()
