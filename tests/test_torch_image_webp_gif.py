"""WebP and GIF read by the port without PIL (`utils/image_io.py`,
`native/webp.cpp`), against PIL: lossy (VP8), lossless (VP8L), lossy with an
ALPH chunk, an animation's first frame, and GIF's first image.

Every comparison is exact: `read_image` against `np.asarray(Image.open(f))`
in dtype, shape and bytes; the port's `scene/datasets._load_image` against
JAX's bit for bit; each native stage that stands alone (GIF's LZW, VP8's
inverse WHT and DCT, the fancy-upsampled YUV -> RGB) against its plain numpy
version. The metrics on a WebP method directory are held to JAX's with
`tests/test_torch_eval.py`'s tolerances. The committed fixtures come from
`tools/make_torch_fixtures.py --formats`; the files PIL's writer cannot ask
for come from `tools/webp_encoder.py` (libwebp through ctypes) and
`tools/image_writers.gif_bytes`. Truncated and byte-flipped files are decoded
in a child process, so that a crash fails one test and not a worker.
"""

import io
import json
import shutil
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from tests.test_torch_image_formats import _assert_pils, _assert_same, _image, _same_reads
from tools import webp_encoder as we
from tools.image_writers import gif_bytes, gif_lzw_encode
from tools.make_torch_fixtures import rgba_800
from wast3d_tpu.eval import metrics as jmetrics
from wast3d_tpu.scene import datasets as jds
from wast3d_tpu_torch import native
from wast3d_tpu_torch.eval import metrics as tmetrics
from wast3d_tpu_torch.scene import colmap as cm
from wast3d_tpu_torch.scene import datasets as tds
from wast3d_tpu_torch.utils import image_io, png

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "torch_fixtures"
FORMATS = ROOT / "tests" / "format_fixtures"
NEW = sorted(p for p in FORMATS.iterdir() if p.suffix in (".webp", ".gif"))


def _pil(img, fmt, **kw):
    if isinstance(img, np.ndarray):
        img = Image.fromarray(img)
    buf = io.BytesIO()
    img.save(buf, fmt, **kw)
    return buf.getvalue()


# ---- committed fixtures ---------------------------------------------------------------

def _vp8_options(payload: bytes) -> dict:
    """The frame header fields of a VP8 key frame that the fixtures must
    cover, read with a plain boolean decoder (RFC 6386 section 7)."""
    data, pos = payload[10:], 0
    value, count, rng = (data[0] << 8) | data[1], 0, 255
    pos = 2

    def bit(prob=128):
        nonlocal value, count, rng, pos
        split = 1 + (((rng - 1) * prob) >> 8)
        big = split << 8
        if value >= big:
            out, rng, value = 1, rng - split, value - big
        else:
            out, rng = 0, split
        while rng < 128:
            value, rng, count = value << 1, rng << 1, count + 1
            if count == 8:
                count, value = 0, value | (data[pos] if pos < len(data) else 0)
                pos += 1
        return out

    def val(n):
        return sum(bit() << i for i in reversed(range(n)))

    bit(), bit()  # colour space, clamping
    segments = bit()
    if segments:
        update_map, update_data = bit(), bit()
        if update_data:
            bit()
            for _ in range(4):
                if bit():
                    val(7), bit()
            for _ in range(4):
                if bit():
                    val(6), bit()
        if update_map:
            for _ in range(3):
                if bit():
                    val(8)
    simple, level, sharpness = bit(), val(6), val(3)
    if bit() and bit():  # loop filter deltas
        for _ in range(8):
            if bit():
                val(6), bit()
    return dict(segments=segments, filter=("none" if level == 0 else
                                           "simple" if simple else "normal"),
                sharpness=sharpness, partitions=1 << val(2))


def test_webp_gif_fixtures_cover_every_kind():
    names = [p.stem for p in NEW]
    for prefix in ("webp_lossy_q5", "webp_lossy_1x1", "webp_lossy_1x37", "webp_lossy_29x1",
                   "webp_lossy_17x13", "webp_lossy_q90_m0", "webp_lossy_q100_m6",
                   "webp_alpha_raw", "webp_alpha_lossless", "webp_lossless_e0",
                   "webp_lossless_e100", "webp_lossless_exact", "webp_anim2", "webp_anim3",
                   "webp_anim_offset", "gif_p", "gif_l", "gif_1bit", "gif_interlaced",
                   "gif_transparency", "gif_local_table", "gif_partial"):
        assert any(n.startswith(prefix) for n in names), prefix
    options, alph, colours = [], set(), set()
    for p in NEW:
        if p.suffix != ".webp":
            continue
        chunks = dict(we.chunks(p.read_bytes()))
        if b"VP8 " in chunks and b"ANMF" not in chunks:
            options.append(_vp8_options(chunks[b"VP8 "]))
        if b"ALPH" in chunks:
            alph.add((chunks[b"ALPH"][0] & 3, (chunks[b"ALPH"][0] >> 2) & 3))
        if p.stem.startswith("webp_lossless_") and p.stem.endswith("colours"):
            colours.add(len(np.unique(np.load(p.with_suffix(".npy")).reshape(-1, 3), axis=0)))
    assert {o["filter"] for o in options} == {"none", "simple", "normal"}
    assert {o["sharpness"] for o in options if o["filter"] != "none"} >= set(range(8))
    assert {o["segments"] for o in options} == {0, 1}
    assert {o["partitions"] for o in options} == {1, 2, 4, 8}
    assert alph == {(c, f) for c in (0, 1) for f in range(4)}  # every compression and filter
    assert min(colours) <= 2 and max(colours) > 16  # bundling 3 .. 0
    assert any(4 < c <= 16 for c in colours) and any(2 < c <= 4 for c in colours)
    offset = dict(we.chunks((FORMATS / "webp_anim_offset.webp").read_bytes()))[b"ANMF"]
    assert int.from_bytes(offset[:3], "little") > 0 and int.from_bytes(offset[6:9], "little") < 63


@pytest.mark.parametrize("sub", ["colmap_webp", "metrics_webp"])
def test_committed_subdirectories_are_pils_arrays(sub):
    files = sorted(p for p in (FORMATS / sub).rglob("*.webp"))
    assert files
    for p in files:
        npy = p.with_suffix(".npy")
        if not npy.exists():
            npy = p.parent.parent / "pil" / f"{p.parent.name}_{p.stem}.npy"
        want = np.asarray(Image.open(p))
        _assert_same(np.load(npy), want)
        _assert_same(image_io.read_image(str(p)), want)


def test_dataset_size_webps():
    """The 1296x832 lossy view decodes to PIL's committed PNG, the 800x800
    lossless RGBA one to its source, rebuilt from the committed JPEG."""
    lossy = FIXTURES / "webp" / "scene_1296x832_q90.webp"
    want = png.read_png(str(FIXTURES / "pil_decode" / "scene_1296x832_q90_webp.png"))
    _assert_same(np.asarray(Image.open(lossy)), want)
    _assert_same(image_io.read_image(str(lossy)), want)
    src = native.read_jpeg(str(FIXTURES / "jpeg" / "scene_1296x832_420.jpg"))
    lossless = image_io.read_image(str(FIXTURES / "webp" / "rgba_800_lossless.webp"))
    _assert_same(lossless, rgba_800(src))


# ---- WebP from PIL's writer and from libwebp's encoder ---------------------------------

SIZES = [(1, 1), (1, 23), (19, 1), (13, 17), (16, 16), (33, 47), (70, 91)]


@pytest.mark.parametrize("h,w", SIZES, ids=lambda v: str(v))
def test_webp_lossy_equals_pil(h, w, tmp_path):
    for i, kw in enumerate((dict(quality=1), dict(quality=40, method=0), dict(quality=75),
                            dict(quality=97, method=6), dict(quality=100))):
        for c in (1, 3, 4):
            img = _image(h, w, c, seed=h * 7 + w + i)
            _assert_pils(_pil(img, "WEBP", **kw), tmp_path, ".webp")


@pytest.mark.parametrize("h,w", SIZES, ids=lambda v: str(v))
def test_webp_lossless_equals_pil(h, w, tmp_path):
    for i, kw in enumerate((dict(quality=0, method=0), dict(quality=50), dict(quality=100,
                                                                                method=6),
                            dict(exact=True))):
        for c in (1, 3, 4):
            img = _image(h, w, c, seed=h + 3 * w + i)
            _assert_pils(_pil(img, "WEBP", lossless=True, **kw), tmp_path, ".webp")
    rng = np.random.default_rng(h * w)
    for n in (1, 2, 3, 4, 5, 16, 17, 255):  # colour indexing at every bundling width
        pal = rng.integers(0, 256, (n, 4)).astype(np.uint8)
        img = pal[rng.integers(0, n, (h, w))]
        _assert_pils(_pil(img, "WEBP", lossless=True), tmp_path, ".webp")
        _assert_pils(_pil(np.ascontiguousarray(img[..., :3]), "WEBP", lossless=True), tmp_path,
                     ".webp")


ENCODER_OPTIONS = (
    [dict(filter_type=0, filter_strength=s, filter_sharpness=k) for s, k in
     ((0, 0), (30, 0), (100, 2), (100, 7))]
    + [dict(filter_type=1, filter_strength=s, filter_sharpness=k) for s, k in
       ((20, 1), (60, 3), (100, 5), (100, 7))]
    + [dict(segments=n, sns_strength=100, quality=q) for n, q in ((1, 50), (2, 30), (3, 90))]
    + [dict(partitions=p, quality=q, method=m) for p, q, m in ((1, 95, 0), (2, 60, 1),
                                                               (3, 20, 2))]
    + [dict(method=m, quality=q, use_sharp_yuv=1) for m, q in ((0, 10), (6, 99))]
    + [dict(lossless=1, near_lossless=n) for n in (0, 40, 80)])


@pytest.mark.parametrize("options", ENCODER_OPTIONS, ids=lambda d: "-".join(
    f"{k}{v}" for k, v in d.items()))
def test_webp_encoder_options_equal_pil(options, tmp_path):
    for h, w in ((8, 9), (31, 45), (130, 40)):
        _assert_pils(we.encode(_image(h, w, 3, seed=h + w), **options), tmp_path, ".webp")


@pytest.mark.parametrize("compression", [0, 1], ids=["raw", "lossless"])
def test_webp_alpha_every_filter_equals_pil(compression, tmp_path):
    rng = np.random.default_rng(compression)
    for h, w in ((1, 1), (1, 17), (12, 1), (23, 35)):
        rgb = _image(h, w, 3, seed=w)
        lossy = we.encode(rgb, quality=70)
        for alpha in (rng.integers(0, 256, (h, w)), _image(h, w, 4, seed=h)[..., 3],
                      np.full((h, w), 255)):
            for filtering in range(4):
                for pre in (0, 1):
                    blob = we.with_alpha(lossy, we.alpha_chunk(alpha.astype(np.uint8),
                                                               compression, filtering, pre))
                    _assert_pils(blob, tmp_path, ".webp")
        for kw in (dict(alpha_compression=compression, alpha_filtering=f, alpha_quality=q)
                   for f in range(3) for q in (100, 30)):
            _assert_pils(we.encode(_image(h, w, 4, seed=3), **kw), tmp_path, ".webp")


def test_webp_mode_is_webpgetfeatures_alpha(tmp_path):
    """RGB or RGBA as WebPGetFeatures finds alpha: a still lossless image by
    its header's bit whatever the VP8X flag says; a still lossy one by the
    flag or an ALPH chunk (which the demuxer drops without the flag: alpha
    255); an animation by the flag alone."""
    rgb, rgba = _image(20, 30, 3, seed=5), _image(20, 30, 4, seed=6)
    lossy = we.encode(rgb, quality=80)
    alph = we.alpha_chunk(rgba[..., 3], 1, 3)
    vp8 = dict(we.chunks(lossy))[b"VP8 "]
    with_bit = dict(we.chunks(we.encode(rgba, lossless=1)))[b"VP8L"]
    without_bit = dict(we.chunks(we.encode(rgb, lossless=1)))[b"VP8L"]
    for flags, parts in ((0x00, [alph, (b"VP8 ", vp8)]), (0x10, [(b"VP8 ", vp8)]),
                         (0x30, [(b"ICCP", b"\x00" * 7), (b"XYZW", b"abc"), alph,
                                 (b"VP8 ", vp8), (b"EXIF", b"\x01" * 5)]),
                         (0x00, [(b"VP8L", with_bit)]), (0x10, [(b"VP8L", without_bit)])):
        _assert_pils(we.riff([we.vp8x(30, 20, flags)] + parts), tmp_path, ".webp")
    _assert_pils(we.riff([(b"VP8 ", vp8), alph]), tmp_path, ".webp")
    for alpha in (False, True):
        for frame in (we.with_alpha(lossy, alph), we.encode(rgba, lossless=1)):
            _assert_pils(we.animation((30, 20), [dict(file=frame, x=0, y=0)], alpha=alpha),
                         tmp_path, ".webp")


def test_webp_animations_equal_pil(tmp_path):
    frames = [_image(30, 40, 4, seed=s) for s in range(3)]
    for kw in (dict(quality=60), dict(lossless=True), dict(quality=90, minimize_size=True)):
        for mode in ("RGB", "RGBA"):
            ims = [Image.fromarray(f).convert(mode) for f in frames]
            blob = _pil(ims[0], "WEBP", save_all=True, append_images=ims[1:], duration=30, **kw)
            _assert_pils(blob, tmp_path, ".webp")
    small = we.encode(frames[0][:10, :14, :3], quality=80)
    small_rgba = we.encode(frames[1][:9, :15], lossless=1)
    whole = we.encode(frames[2], quality=70)
    for canvas, first, x, y, alpha in (((40, 30), small, 6, 4, False),
                                       ((40, 30), small_rgba, 24, 20, True),
                                       ((40, 30), small_rgba, 0, 0, False),
                                       ((14, 10), small, 0, 0, False)):
        blob = we.animation(canvas, [dict(file=first, x=x, y=y),
                                     dict(file=whole if canvas == (40, 30) else small, x=0,
                                          y=0)], alpha=alpha)
        _assert_pils(blob, tmp_path, ".webp")


def test_webp_containers_pil_refuses_raise():
    """A RIFF size past the file, a frame off its canvas, a lossless frame
    after an ALPH chunk, a second VP8X: PIL refuses each, and so does the
    port, with a ValueError naming the file."""
    lossy = we.encode(_image(10, 12, 3, seed=1), quality=70)
    vp8 = dict(we.chunks(lossy))[b"VP8 "]
    vp8l = dict(we.chunks(we.encode(_image(10, 12, 3, seed=1), lossless=1)))[b"VP8L"]
    cases = [lossy[:4] + struct.pack("<I", len(lossy)) + lossy[8:],
             we.riff([we.vp8x(11, 10, 0), (b"VP8 ", vp8)]),
             we.riff([we.vp8x(12, 10, 0x10), (b"ALPH", b"\x00" * 121), (b"VP8L", vp8l)]),
             we.riff([we.vp8x(12, 10, 0), we.vp8x(12, 10, 0), (b"VP8 ", vp8)]),
             we.riff([we.vp8x(12, 10, 0x01), (b"VP8 ", vp8)]),
             we.animation((12, 10), [dict(file=lossy, x=2, y=0)])]
    for blob in cases:
        with pytest.raises(Exception):
            np.asarray(Image.open(io.BytesIO(blob)))
        with pytest.raises(ValueError, match=r"^case\.webp: "):
            image_io.decode_image(blob, "case.webp")


# ---- GIF ------------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["P", "L", "1", "RGB"])
def test_gif_from_pils_writer_equals_pil(mode, tmp_path):
    for h, w in ((1, 1), (1, 29), (17, 1), (33, 47)):
        img = Image.fromarray(_image(h, w, 3, seed=h + w))
        img = img.quantize(37) if mode == "P" else img.convert(mode) if mode != "RGB" else img
        for kw in ({}, dict(interlace=True), dict(transparency=2), dict(optimize=False)):
            _assert_pils(_pil(img, "GIF", **kw), tmp_path, ".gif")


def test_gif_tables_offsets_and_code_sizes_equal_pil(tmp_path):
    rng = np.random.default_rng(11)
    pal = rng.integers(0, 256, (256, 3))
    ramp = np.repeat(np.arange(256)[:, None], 3, axis=1)
    for h, w in ((1, 1), (1, 40), (40, 1), (37, 53), (90, 250)):
        for bits in (1, 2, 5, 8):
            idx = rng.integers(0, 1 << bits, (h, w)).astype(np.uint8)
            idx[:h // 2] = (np.arange(w) // 5 % (1 << bits))[None]  # long runs: full tables
            p = pal[:max(2, 1 << bits)]
            for kw in (dict(palette=p), dict(palette=p, local=True),
                       dict(palette=p, local=True, screen_palette=pal[:4]),
                       dict(palette=p, interlace=True), dict(palette=p, transparency=1),
                       dict(palette=p, screen=(w + 9, h + 5), offset=(4, 3)),
                       dict(palette=p, screen=(w + 9, h + 5), offset=(4, 3), transparency=0,
                            interlace=True),
                       dict(palette=p, screen=(max(1, w - 3), max(1, h - 2)), offset=(3, 2)),
                       dict(palette=p, min_code_size=min(12, bits + 3)),
                       dict(palette=ramp[:max(2, 1 << bits)]),
                       dict(palette=ramp[:max(2, 1 << bits)], local=True, screen_palette=p),
                       dict(palette=None)):
                _assert_pils(gif_bytes(idx, **kw), tmp_path, ".gif")


def test_gif_extensions_before_the_image_equal_pil(tmp_path):
    idx = np.random.default_rng(2).integers(0, 4, (9, 13)).astype(np.uint8)
    base = gif_bytes(idx, np.arange(12).reshape(4, 3) * 20)
    head, rest = base[:13 + 12], base[13 + 12:]
    comment = b"\x21\xfe\x05hello\x03abc\x00"
    netscape = b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x05\x00\x00"
    other = b"\x21\x01\x0c" + b"x" * 12 + b"\x02ab\x00"
    gce = b"\x21\xf9\x04\x05\x0a\x00\x03\x00"
    for extra in (comment, netscape, other, gce, comment + gce + netscape, b"\x07\x07" + gce):
        _assert_pils(head + extra + rest, tmp_path, ".gif")


# ---- native stages against their plain versions ---------------------------------------

def test_native_gif_lzw_equals_its_plain_version():
    rng = np.random.default_rng(4)
    for bits in range(0, 13):
        data = rng.integers(0, 256, 3000).astype(np.uint8).tobytes()
        for n in (1, 100, 5000, 40000):
            def outcome(fn):
                try:
                    return fn().tobytes()
                except ValueError as e:
                    return str(e).removeprefix("<bytes>: ")
            assert (outcome(lambda: native.gif_lzw(data, bits, n))
                    == outcome(lambda: image_io.gif_lzw_reference(data, bits, n)))
    for bits in (2, 4, 8):  # real streams, through table resets
        idx = rng.integers(0, 1 << bits, 30000).astype(np.uint8)
        idx[:15000] = np.arange(15000) // 9 % (1 << bits)
        lzw = gif_lzw_encode(idx.tobytes(), bits)
        got = native.gif_lzw(lzw, bits, idx.size)
        assert got.tobytes() == idx.tobytes()
        assert image_io.gif_lzw_reference(lzw, bits, idx.size).tobytes() == idx.tobytes()
    with pytest.raises(ValueError, match="minimum code size"):
        native.gif_lzw(b"\x00", 13, 4)


def test_native_vp8_transforms_equal_their_plain_versions():
    rng = np.random.default_rng(5)
    for i in range(3000):
        limit = (2048, 16384, 32768)[i % 3]
        coeffs = rng.integers(-limit, limit, 16).astype(np.int16)
        coeffs[rng.random(16) < (i % 5) / 5] = 0
        pred = rng.integers(0, 256, (4, 4)).astype(np.uint8)
        _assert_same(native.vp8_idct(coeffs, pred), image_io.vp8_idct_reference(coeffs, pred))
        _assert_same(native.vp8_idct(coeffs), image_io.vp8_idct_reference(coeffs))


def test_native_yuv_to_rgb_equals_its_plain_version_and_pils_pixels():
    rng = np.random.default_rng(6)
    for h, w in ((1, 1), (1, 2), (2, 1), (2, 2), (3, 5), (4, 7), (17, 13), (64, 33), (100, 101)):
        y = rng.integers(0, 256, (h, w)).astype(np.uint8)
        u, v = rng.integers(0, 256, (2, (h + 1) // 2, (w + 1) // 2)).astype(np.uint8)
        _assert_same(native.yuv_to_rgba(y, u, v), image_io.yuv_to_rgba_reference(y, u, v))
    for h, w in ((1, 1), (2, 3), (17, 13), (48, 64), (33, 65)):  # libwebp's own planes
        blob = _pil(_image(h, w, 3, seed=h), "WEBP", quality=60)
        planes = we.decode_yuv(blob)
        want = np.asarray(Image.open(io.BytesIO(blob)))
        _assert_same(image_io.yuv_to_rgba_reference(*planes)[..., :3], want)
        _assert_same(native.yuv_to_rgba(*planes)[..., :3], want)


# ---- datasets and metrics -------------------------------------------------------------

def test_colmap_scene_of_webp_views_equals_jaxs(tmp_path):
    src = tmp_path / "colmap_webp"
    shutil.copytree(FIXTURES / "colmap_jpeg", src)
    shutil.copytree(FORMATS / "colmap_webp", src / "images_webp",
                    ignore=shutil.ignore_patterns("*.npy"))
    sparse = src / "sparse" / "0"
    imgs = cm.read_images_binary(str(sparse / "images.bin"))
    cm.write_images_binary({k: v._replace(name=v.name.replace(".jpg", ".webp"))
                            for k, v in imgs.items()}, str(sparse / "images.bin"))
    t = tds.read_colmap_scene(str(src), "images_webp", eval_split=True)
    j = jds.read_colmap_scene(str(src), "images_webp", eval_split=True)
    cams = t.train_cameras + t.test_cameras
    assert len(cams) == 6
    for x, y in zip(cams, j.train_cameras + j.test_cameras):
        assert (x.image_name, x.width, x.height) == (y.image_name, y.width, y.height)
        assert x.image.tobytes() == y.image.tobytes()
        want = np.load(FORMATS / "colmap_webp" / f"{x.image_name}.npy")
        assert x.image.tobytes() == (want.astype(np.float32) / 255.0).tobytes()
    for (_, tg), (_, jg) in zip(tds.build_cameras(t.train_cameras, 2, device="cpu"),
                                jds.build_cameras(j.train_cameras, 2)):
        assert tg.tobytes() == np.asarray(jg).tobytes()


def test_metrics_on_a_webp_method_directory_equal_jaxs(tmp_path):
    d = FORMATS / "metrics_webp"
    renders, gts, names = _same_reads(d / "renders", d / "gt")
    assert names == ["00000.webp", "00001.webp"]
    for r, g, n in zip(renders, gts, names):
        for got, kind in ((r, "renders"), (g, "gt")):
            want = np.load(d / "pil" / f"{kind}_{n[:-5]}.npy")
            assert got.tobytes() == (want.astype(np.float32)[..., :3] / 255.0).tobytes()
    method = tmp_path / "test" / "ours_7"
    for sub in ("renders", "gt"):
        shutil.copytree(d / sub, method / sub)
    t = tmetrics.evaluate_dir(str(method), device="cpu")
    j = jmetrics.evaluate_dir(str(method))
    tol = {"PSNR": 1e-4, "SSIM": 1e-5, "LPIPS_PROXY": 1e-5}
    for key, limit in tol.items():
        assert abs(t["mean"][key] - j["mean"][key]) <= limit, key
        for view, v in j["per_view"][key].items():
            assert abs(t["per_view"][key][view] - v) <= limit, (key, view)


# ---- limits, truncation and corruption ------------------------------------------------

def test_images_past_pils_pixel_limit_raise_before_decoding():
    gif = bytearray(gif_bytes(np.zeros((2, 2), np.uint8), np.zeros((2, 3))))
    gif[6:10] = struct.pack("<HH", 40000, 40000)
    with pytest.raises(Image.DecompressionBombError):
        Image.open(io.BytesIO(bytes(gif)))
    with pytest.raises(ValueError, match="more pixels than PIL opens"):
        image_io.decode_image(bytes(gif), "big.gif")
    small = we.encode(_image(4, 4, 3), quality=50)
    big = we.animation((16384, 16384), [dict(file=small, x=0, y=0)])
    with pytest.raises(ValueError, match=r"^big\.webp: .*more pixels than PIL opens"):
        image_io.decode_image(big, "big.webp")


_FUZZ = r"""
import io, json, sys
import numpy as np
from PIL import Image
sys.path.insert(0, sys.argv[1])
from wast3d_tpu_torch.utils import image_io

def pil(blob):
    try:
        return np.asarray(Image.open(io.BytesIO(blob)))
    except Exception:
        return None

files = [open(p, "rb").read() for p in sys.argv[2:]]
cases = [f[:n] for f in files for n in range(len(f))]
rng = np.random.default_rng(12)
for i in range(500):
    f = bytearray(files[i % len(files)])
    for _ in range(1 + i % 3):
        f[int(rng.integers(0, len(f)))] ^= 1 << int(rng.integers(0, 8))
    cases.append(bytes(f))
out = {"cases": len(cases), "raised": 0, "decoded": 0, "differ": [], "bad": []}
for k, blob in enumerate(cases):
    try:
        got = image_io.decode_image(blob, "fuzz.img")
    except ValueError as e:
        out["raised"] += 1
        if not str(e).startswith("fuzz.img: "):
            out["bad"].append(str(e))
        continue
    except Exception as e:
        out["bad"].append(repr(e))
        continue
    out["decoded"] += 1
    want = pil(blob)
    if want is None or want.shape != got.shape or want.tobytes() != got.tobytes():
        out["differ"].append(k)
print(json.dumps(out))
"""


def test_truncated_and_flipped_files_raise_or_decode_as_pil():
    """Every prefix of three small files (lossy with lossless alpha,
    lossless, interlaced GIF) and 500 seeded flips of one to three bits in
    them and in an animation: each raises a ValueError naming the file or
    decodes to PIL's array, in a child process with a time limit."""
    files = [FORMATS / n for n in ("webp_alpha_lossless_gradient.webp",
                                   "webp_lossless_e100.webp", "gif_interlaced.gif",
                                   "webp_anim_offset_rgba.webp")]
    out = subprocess.run([sys.executable, "-c", _FUZZ, str(ROOT), *map(str, files[:3])],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["bad"] == [] and got["differ"] == [], got
    assert got["raised"] > 0.9 * sum(len(f.read_bytes()) for f in files[:3])
    out = subprocess.run([sys.executable, "-c", _FUZZ, str(ROOT), str(files[3])],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["bad"] == [] and got["differ"] == [], got

